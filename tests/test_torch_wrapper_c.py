"""The port's C ABI (cxxnet_tpu_torch/csrc/wrapper/cxxnet_wrapper.cc, the
twin of wrapper/cxxnet_wrapper.cc) on the CPU: built by
``native.wrapper_library()``, the unchanged wrapper/test_wrapper.c compiled
against the twin's header and library runs all its legs (batch, second
thread, generate, and the iterator leg on synthetic MNIST); the library
loaded with ctypes into a running interpreter drives a net and never
imports jax; ``CXNNetCreate("gpu", ...)`` on a machine without a card
returns NULL with the error naming the card; the twin's header declares
exactly what wrapper/cxxnet_wrapper.h declares.
"""

import os
import re
import subprocess
import sys

import pytest

from cxxnet_tpu_torch.utils import native

from .synth_mnist import make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN_H = os.path.join(REPO, "cxxnet_tpu_torch", "csrc", "wrapper",
                      "cxxnet_wrapper.h")


@pytest.fixture(scope="module")
def wrapper_lib():
    return native.wrapper_library()


@pytest.fixture(scope="module")
def wrapper_bin(wrapper_lib, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("wrapper") / "test_wrapper_c")
    subprocess.run([os.environ.get("CC") or "gcc", "-O2", "-Wall",
                    "-pthread", "-I", os.path.dirname(TWIN_H), "-o", out,
                    os.path.join(REPO, "wrapper", "test_wrapper.c"),
                    wrapper_lib,
                    "-Wl,-rpath," + os.path.dirname(wrapper_lib),
                    *native.embed_ldflags()],
                   check=True, capture_output=True, timeout=120)
    return out


def test_c_program_runs_every_leg_on_the_port(wrapper_bin, tmp_path):
    make_dataset(str(tmp_path), n_train=200, n_test=50)
    env = dict(os.environ)
    env.pop("CXXNET_TPU_ROOT", None)     # the library knows its checkout
    r = subprocess.run([wrapper_bin, str(tmp_path)], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    for leg in ("SMOKE TEST", "THREAD LEG", "GENERATE LEG",
                "ITERATOR LEG"):
        assert "C WRAPPER %s PASSED" % leg in r.stderr, r.stderr


CTYPES_DRIVER = r"""
import ctypes, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
lib.CXNNetCreate.restype = ctypes.c_void_p
lib.CXNNetCreate.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
lib.CXNGetLastError.restype = ctypes.c_char_p
lib.CXNNetInitModel.argtypes = [ctypes.c_void_p]
lib.CXNNetFree.argtypes = [ctypes.c_void_p]
F = ctypes.POINTER(ctypes.c_float)
U = ctypes.POINTER(ctypes.c_uint32)
lib.CXNNetUpdateBatch.argtypes = [ctypes.c_void_p, F, U, F, U]
lib.CXNNetPredictBatch.restype = F
lib.CXNNetPredictBatch.argtypes = [ctypes.c_void_p, F, U, U]
cfg = (b"netconfig = start\nlayer[+1:fc1] = fullc:fc1\n  nhidden = 8\n"
       b"layer[+0] = softmax\nnetconfig = end\ninput_shape = 1,1,6\n"
       b"batch_size = 4\neta = 0.1\n")
if sys.argv[2] == "gpu":
    h = lib.CXNNetCreate(b"gpu", cfg)
    print("handle", h)
    print("error", lib.CXNGetLastError().decode())
else:
    h = lib.CXNNetCreate(b"cpu", cfg)
    assert h and lib.CXNNetInitModel(h) == 0
    x = np.random.RandomState(0).rand(4, 1, 1, 6).astype(np.float32)
    y = np.arange(4, dtype=np.float32).reshape(4, 1)
    ds = (ctypes.c_uint32 * 4)(4, 1, 1, 6)
    ls = (ctypes.c_uint32 * 2)(4, 1)
    assert lib.CXNNetUpdateBatch(h, x.ctypes.data_as(F), ds,
                                 y.ctypes.data_as(F), ls) == 0
    n = ctypes.c_uint32()
    p = lib.CXNNetPredictBatch(h, x.ctypes.data_as(F), ds, ctypes.byref(n))
    print("predicted", n.value, [p[i] for i in range(n.value)])
    lib.CXNNetFree(h)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "cxxnet_tpu" or m.startswith("cxxnet_tpu."))
print("jax modules", bad, "port", "cxxnet_tpu_torch.api" in sys.modules)
"""


def _ctypes_run(lib, dev):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", CTYPES_DRIVER, lib, dev],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_ctypes_in_process_drives_the_port_without_jax(wrapper_lib):
    out = _ctypes_run(wrapper_lib, "cpu")
    m = re.search(r"predicted 4 \[([^\]]*)\]", out)
    assert m, out
    assert all(0 <= float(v) < 8 for v in m.group(1).split(","))
    assert "jax modules [] port True" in out


def test_gpu_without_a_card_returns_null_naming_the_card(wrapper_lib):
    out = _ctypes_run(wrapper_lib, "gpu")
    assert "handle None" in out
    err = re.search(r"error (.*)", out).group(1)
    assert err.startswith("CXNNetCreate: ")
    assert "no CUDA device" in err and "dev=gpu" in err
    assert "jax modules [] port True" in out


def _declarations(path):
    """The header's declarations from its include guard on, comments
    dropped and whitespace collapsed."""
    text = open(path).read()
    text = text[text.index("#ifndef CXXNET_WRAPPER_H_"):]
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return re.sub(r"\s+", " ", text).strip()


def test_twin_header_declares_what_the_jax_header_declares():
    want = _declarations(os.path.join(REPO, "wrapper", "cxxnet_wrapper.h"))
    got = _declarations(TWIN_H)
    assert got == want
    assert got.count("CXN") == 24           # the 24 entry points
