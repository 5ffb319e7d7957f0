"""Parallel modes of the port (counterpart of cxxnet_tpu/parallel): the
world of processes (``multihost``), the mesh of ranks and its groups
(``mesh``), the placement rules (``sharding``), tensor and expert
parallelism (``tensor``), the collectives over a process group or over
virtual ranks (``collectives``), sequence parallelism, ring and Ulysses
attention (``ring``), and a rank's GPipe schedule over a pipe axis
(``pipeline``)."""
