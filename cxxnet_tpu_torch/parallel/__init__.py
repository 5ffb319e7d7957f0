"""Parallel modes of the port (counterpart of cxxnet_tpu/parallel): so far
sequence parallelism, ring and Ulysses attention (``ring``) over the
collectives ``ring_shift`` and ``all_to_all`` (``collectives``)."""
