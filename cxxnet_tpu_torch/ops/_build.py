"""Build the port's CUDA kernels from ``cxxnet_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into its own shared library, ``build/cxxnet_tpu_torch/lib<name>-<hash>.so``
at the repository root, where ``<hash>`` is taken from the source text, the
headers of ``csrc/`` (``*.cuh``) and the flags, so an edited source or
header builds anew and an unchanged one is reused.
``launch`` loads a library with ctypes at first use and calls its entry
point ``cxxnet_<name>`` (or another one it names), raising if the launch
failed. ``nvcc``'s output, with ``-Xptxas -v`` (registers, shared memory
and spills per kernel), is kept beside each library as
``lib<name>-<hash>.log``.

The first use of a library in a process (its build when not built yet, and
its load) is what stands in for a compile in the port: it is recorded
through ``telemetry.record_compile`` as ``kernel:<name>``, cause
``first_use``, so a serving request that sat through it carries it in its
flight record's ``recompiles`` and ``compile_stall_s``.

Nothing here runs at import: the CPU tests import every module and have no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional, Sequence

from ..utils import health, telemetry

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "cxxnet_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def kernel_names():
    """Names of every kernel source in csrc/ (``lrn_fwd`` for lrn_fwd.cu)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def library_path(name: str) -> str:
    """Where the shared library of csrc/<name>.cu lives once built: its
    hash covers the source, every header in csrc/ and the flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name,
                                                    digest.hexdigest()[:12]))


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build the named kernels (all of csrc/ by default) that are not built
    yet, one ``nvcc`` per source, all started together. Returns
    {name: library path}; raises RuntimeError with the compiler's output if
    any build fails."""
    names = list(kernel_names() if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not os.path.isfile(paths[n])]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = "%s.%d.tmp" % (paths[n], os.getpid())
        log = open(paths[n][:-3] + ".log", "w")
        procs[n] = (tmp, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, n + ".cu")],
            stdout=log, stderr=subprocess.STDOUT))
    failed = []
    for n, (tmp, log, proc) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, paths[n])
        else:
            with open(log.name) as f:
                failed.append("%s (nvcc exit %d):\n%s" % (n, rc, f.read()))
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


_libs: Dict[str, ctypes.CDLL] = {}


def _entry(name: str, entry: str, argtypes: Sequence):
    """The entry point ``entry`` of the ctypes library of csrc/<name>.cu,
    built and loaded at first use, with its argument types declared."""
    if name not in _libs:
        # a build at first use is legitimately step-silent: disarm the
        # training step's watchdog channel (the next beat re-arms it)
        health.pause("train.step")
        t0 = time.perf_counter()
        lib = ctypes.CDLL(build_kernels([name])[name])
        lib.cxxnet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cxxnet_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        telemetry.record_compile("kernel:" + name, "first_use",
                                 time.perf_counter() - t0)
    fn = getattr(_libs[name], entry)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def launch(name: str, argtypes: Sequence, *args,
           entry: Optional[str] = None) -> None:
    """Call ``cxxnet_<name>(*args)`` of csrc/<name>.cu, or its other entry
    point ``entry``, which launches on the stream it is given and returns a
    cudaError_t; raises if that is not 0."""
    entry = entry or "cxxnet_" + name
    err = _entry(name, entry, argtypes)(*args)
    if err != 0:
        raise RuntimeError("%s kernel launch failed: cudaError %d (%s)"
                           % (entry, err, _libs[name]
                              .cxxnet_cuda_error_string(err).decode()))
