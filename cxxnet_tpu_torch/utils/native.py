"""The port's host library: how it is built and loaded, and the calls the
input pipeline makes into it.

``cxxnet_tpu_torch/csrc/host/*.cc`` (a plain C interface in ``cxn_host.h``)
compiles with ``g++`` (or ``$CXX``) into one shared library,
``build/cxxnet_tpu_torch/host/libcxn_host-<hash>.so`` at the repository
root, at first use; ``<hash>`` covers the sources, the header and the
flags, so an edited source builds anew. The build goes to a temporary file
that is renamed into place under a file lock, so processes that start
together build it once. A failed build raises with the compiler's output:
nothing falls back to another decoder. The library needs no CUDA, so the
same code runs in the CPU tests and on the card's host.

Every call runs in C++ with the GIL released (ctypes), so a thread pool of
decodes runs in parallel:

* ``decode_jpeg_chw`` — the port's own JPEG decoder (csrc/host/
  jpeg_decode.cc), bit for bit libjpeg-turbo's pixels;
* ``decode_pnm_chw`` — binary PPM/PGM with maxval 255;
* ``warp_affine`` — the geometric augmenter's bicubic warp;
* ``NativePageReader`` — BinaryPage read-ahead on a C++ thread.

The same module builds the port's C ABI (``csrc/wrapper/
cxxnet_wrapper.cc``, declared in its ``cxxnet_wrapper.h``, the twin of
wrapper/): ``wrapper_library()`` compiles it with ``g++`` and the flags of
``python3-config --includes`` / ``--ldflags --embed`` into
``build/cxxnet_tpu_torch/wrapper/libcxxnetwrapper-<hash>.so`` and returns
the path, under the same file lock and tmp + rename.

Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shlex
import subprocess
import sys
import sysconfig
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRC = os.path.join(PKG_DIR, "csrc", "host")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "cxxnet_tpu_torch", "host")
WRAPPER_SRC = os.path.join(PKG_DIR, "csrc", "wrapper")
WRAPPER_BUILD_DIR = os.path.join(os.path.dirname(BUILD_DIR), "wrapper")
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off")

# status codes of csrc/host/cxn_host.h
OK, CORRUPT = 0, 1
REFUSED = {2: "arithmetic coding", 3: "a sample precision other than 8 bits",
           4: "lossless or hierarchical coding",
           5: "four components (CMYK/YCCK)",
           6: "a sampling layout other than 4:4:4, 4:2:2, 4:2:0, 4:4:0 and "
              "4:1:1", 7: "a component count other than 1 or 3",
           8: "a progressive scan script cut before its last refinement",
           9: "a maxval other than 255"}

_lib = None
_lib_lock = threading.Lock()
# seconds this process's build took (None where it was built already)
build_seconds: Optional[float] = None


class NativeError(ValueError):
    """A decoder of the host library refused or failed a record: ``code``
    is its status, ``what`` its message."""

    def __init__(self, code: int, what: str):
        super().__init__(what)
        self.code = code
        self.what = what

    @property
    def refused(self) -> bool:
        return self.code in REFUSED


def _sources() -> List[str]:
    return sorted(os.path.join(HOST_SRC, f) for f in os.listdir(HOST_SRC)
                  if f.endswith(".cc"))


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> str:
    """Where the host library lives once built."""
    digest = hashlib.sha1(" ".join((_compiler(),) + CXX_FLAGS).encode())
    for f in _sources() + [os.path.join(HOST_SRC, "cxn_host.h")]:
        with open(f, "rb") as fh:
            digest.update(os.path.basename(f).encode())
            digest.update(fh.read())
    return os.path.join(BUILD_DIR,
                        "libcxn_host-%s.so" % digest.hexdigest()[:12])


def _build_locked(path: str, cmd: List[str], what: str) -> bool:
    """Compile ``cmd`` (its output file given as ``{tmp}``) into ``path``
    unless it exists: under a file lock in the build directory, to a
    temporary name renamed into place, the compiler's output kept beside
    it in ``<name>.log``. Returns whether this call built it; raises
    RuntimeError with the compiler's output if the build fails."""
    if os.path.isfile(path):
        return False
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.isfile(path):     # another process built it
                return False
            tmp = "%s.%d.tmp" % (path, os.getpid())
            cmd = [tmp if a == "{tmp}" else a for a in cmd]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError("%s build failed: cannot run %s (%s); "
                                   "set CXX to a C++17 compiler"
                                   % (what, cmd[0], e)) from None
            with open(path[:-3] + ".log", "w") as log:
                log.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(
                    "%s build failed (%s exit %d):\n%s%s"
                    % (what, cmd[0], proc.returncode, proc.stdout,
                       proc.stderr))
            os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return True


def build() -> str:
    """Build the host library if it is not built; returns its path.
    Raises RuntimeError with the compiler's output if the build fails."""
    global build_seconds
    path = library_path()
    t0 = time.perf_counter()
    cmd = [_compiler(), *CXX_FLAGS, "-I", HOST_SRC, "-o", "{tmp}",
           *_sources()]
    if _build_locked(path, cmd, "host library"):
        build_seconds = time.perf_counter() - t0
    return path


def _python_config(*args: str) -> List[str]:
    """The flags ``python3-config`` prints for ``args``, from the config
    script of the interpreter running this code where it has one; without
    one, the same flags from ``sysconfig``."""
    names = [os.path.join(sysconfig.get_config_var("BINDIR") or "",
                          "python%s-config"
                          % sysconfig.get_config_var("VERSION")),
             "python3-config"]
    for name in names:
        try:
            out = subprocess.run([name, *args], capture_output=True,
                                 text=True, check=True).stdout
        except (OSError, subprocess.CalledProcessError):
            continue
        return shlex.split(out)
    if args == ("--includes",):
        return ["-I" + sysconfig.get_paths()["include"]]
    return ["-L" + (sysconfig.get_config_var("LIBDIR") or ""),
            "-lpython" + sysconfig.get_config_var("LDVERSION")] + \
        shlex.split(sysconfig.get_config_var("LIBS") or "")


def embed_ldflags() -> List[str]:
    """What a C program that embeds the interpreter links with
    (``python3-config --ldflags --embed``, and the library directory as
    its run path)."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    return _python_config("--ldflags", "--embed") + (
        ["-Wl,-rpath," + libdir] if libdir else [])


def wrapper_library() -> str:
    """The port's C ABI (csrc/wrapper/cxxnet_wrapper.cc) as a shared
    library, built at first use; returns its path. A C program compiles
    against ``csrc/wrapper/cxxnet_wrapper.h`` and links this file and
    ``embed_ldflags()``. The embedded interpreter is this one
    (``CXN_PYTHON``) and the checkout this one (``CXN_ROOT``, overridden by
    ``CXXNET_TPU_ROOT``). Where this interpreter links libpython as a
    shared library the C ABI links it too; where libpython is built into
    the executable the C ABI leaves its symbols to the process that loads
    it, so that ``ctypes`` never loads a second interpreter."""
    src = os.path.join(WRAPPER_SRC, "cxxnet_wrapper.cc")
    flags = ["-std=c++17", "-O2", "-shared", "-fPIC",
             '-DCXN_PYTHON="%s"' % sys.executable,
             '-DCXN_ROOT="%s"' % os.path.dirname(PKG_DIR),
             *_python_config("--includes"), "-I", WRAPPER_SRC]
    libs = embed_ldflags() if sysconfig.get_config_var("Py_ENABLE_SHARED") \
        else []
    digest = hashlib.sha1(" ".join([_compiler()] + flags + libs).encode())
    for f in (src, os.path.join(WRAPPER_SRC, "cxxnet_wrapper.h")):
        with open(f, "rb") as fh:
            digest.update(fh.read())
    path = os.path.join(WRAPPER_BUILD_DIR, "libcxxnetwrapper-%s.so"
                        % digest.hexdigest()[:12])
    _build_locked(path, [_compiler(), *flags, "-o", "{tmp}", src, *libs],
                  "C ABI")
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    fptr, cptr = ctypes.POINTER(ctypes.c_float), ctypes.c_char_p
    for name in ("cxn_jpeg_dims", "cxn_pnm_dims"):
        fn = getattr(lib, name)
        fn.argtypes = [cptr, i64, p64, p64, cptr, i64]
        fn.restype = ctypes.c_int
    for name in ("cxn_jpeg_decode_f32", "cxn_pnm_decode_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [cptr, i64, fptr, i64, i64, cptr, i64]
        fn.restype = ctypes.c_int
    lib.cxn_warp_affine_u8.argtypes = [
        ctypes.c_void_p, i64, i64, i64, fptr, ctypes.c_void_p, i64, i64,
        ctypes.c_int]
    lib.cxn_warp_affine_u8.restype = None
    lib.cxn_page_reader_create.restype = ctypes.c_void_p
    lib.cxn_page_reader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                           i64, i64, i64]
    lib.cxn_page_reader_before_first.argtypes = [ctypes.c_void_p]
    lib.cxn_page_reader_next.restype = i64
    lib.cxn_page_reader_next.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_void_p)]
    lib.cxn_page_reader_free.argtypes = [ctypes.c_void_p]
    return lib


def load() -> ctypes.CDLL:
    """The host library, built and loaded at first use."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(build()))
    return _lib


def _decode(dims, decode, buf: bytes) -> np.ndarray:
    lib = load()
    h, w = ctypes.c_int64(), ctypes.c_int64()
    msg = ctypes.create_string_buffer(256)
    n = len(buf)
    rc = getattr(lib, dims)(buf, n, ctypes.byref(h), ctypes.byref(w), msg,
                            256)
    if rc == OK:
        out = np.empty((3, h.value, w.value), np.float32)
        rc = getattr(lib, decode)(
            buf, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            h.value, w.value, msg, 256)
        if rc == OK:
            return out
    raise NativeError(rc, msg.value.decode("utf-8", "replace"))


def decode_jpeg_chw(buf: bytes) -> np.ndarray:
    """A JPEG record as float32 (3, h, w) RGB in [0, 255], with the port's
    decoder; raises NativeError (``refused`` for a form it does not
    implement)."""
    return _decode("cxn_jpeg_dims", "cxn_jpeg_decode_f32", bytes(buf))


def decode_pnm_chw(buf: bytes) -> np.ndarray:
    """A binary PPM/PGM record with maxval 255 as float32 (3, h, w) RGB;
    raises NativeError (``refused`` for another maxval)."""
    return _decode("cxn_pnm_dims", "cxn_pnm_decode_f32", bytes(buf))


def warp_affine(src: np.ndarray, inv: np.ndarray, out_hw: Tuple[int, int],
                fill: int) -> np.ndarray:
    """The bicubic warp of an (h, w, c) uint8 image to (out_h, out_w, c)
    under the float32 inverse map ``inv`` (2 x 3), a tap outside the image
    taking ``fill`` (csrc/host/warp_affine.cc; io/warp.py holds its plain
    version)."""
    src = np.ascontiguousarray(src, np.uint8)
    inv = np.ascontiguousarray(inv, np.float32).reshape(6)
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    h, w, c = src.shape
    dst = np.empty((out_h, out_w, c), np.uint8)
    load().cxn_warp_affine_u8(
        src.ctypes.data, h, w, c,
        inv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dst.ctypes.data,
        out_h, out_w, int(fill))
    return dst


class NativePageReader:
    """Objects of a chain of BinaryPage .bin files, read ahead by a C++
    thread ``lookahead`` pages deep."""

    def __init__(self, paths: List[str], page_ints: int, lookahead: int = 4):
        self._lib = load()
        arr = (ctypes.c_char_p * len(paths))(
            *[os.fsencode(p) for p in paths])
        self._h = self._lib.cxn_page_reader_create(arr, len(paths),
                                                   page_ints, lookahead)
        if not self._h:
            raise IOError("cannot open bin files: %s" % paths)

    def before_first(self) -> None:
        self._lib.cxn_page_reader_before_first(self._h)

    def next_obj(self) -> Optional[bytes]:
        """The next object's bytes; None at the end of the chain. Raises
        IOError on a read or page-layout error."""
        out = ctypes.c_void_p()
        sz = self._lib.cxn_page_reader_next(self._h, ctypes.byref(out))
        if sz == -1:
            return None
        if sz < 0:
            raise IOError("page reader: read or page-layout error")
        return ctypes.string_at(out, sz)

    def close(self) -> None:
        if self._h:
            self._lib.cxn_page_reader_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
