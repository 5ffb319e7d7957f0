"""The port stands alone: importing it (every module, chip_smoke.py and
bin/cxxnet_torch) loads neither jax nor any module of the JAX package, no
file of it imports them, and a GPU device spec without a card raises
instead of running on the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "cxxnet_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "bin", "cxxnet_torch")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _module_names():
    names = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        if not rel.endswith(".py") or rel == "chip_smoke.py":
            continue
        mod = rel[:-3].replace(os.sep, ".")
        names.append(mod[:-len(".__init__")] if mod.endswith(".__init__")
                     else mod)
    return names


def test_import_loads_no_jax():
    code = ("import importlib, sys\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "import runpy\n"
            "runpy.run_path('bin/cxxnet_torch', run_name='cxxnet_torch')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'cxxnet_tpu' or "
            "m.startswith('cxxnet_tpu.'))\n"
            "print(bad)\n" % (_module_names(),))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_file_imports_jax_or_the_jax_package(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "cxxnet_tpu"), \
                "%s imports %s" % (path, m)


def test_gpu_without_card_raises(monkeypatch):
    from cxxnet_tpu_torch import api, device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device("gpu")
    net = api.Net(cfg="netconfig=start\nlayer[0->1] = fullc\n  nhidden = 2\n"
                      "netconfig=end\ninput_shape = 1,1,4\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net.init_model()
    assert net.net_.params is None


@pytest.mark.parametrize("spec, want", [("cpu", "cpu"), ("gpu", "gpu"),
                                        ("gpu:1", "gpu"), ("cuda", "cuda"),
                                        ("gpu:0-3", "gpu")])
def test_device_spec_parse(spec, want):
    from cxxnet_tpu_torch import device
    assert device.parse_device_spec(spec)[0] == want
    if want == "cpu":
        assert device.resolve_device(spec) == torch.device("cpu")


@pytest.mark.parametrize("spec, n_cards, want", [
    ("tpu", 1, "cuda:0"), ("tpu:0-3", 1, "cuda:0"), ("gpu:1", 1, "cuda:0"),
    ("gpu:0,2", 1, "cuda:0"), ("cuda", 1, "cuda:0"), ("gpu", 1, "cuda:0"),
    ("gpu:1", 4, "cuda:1"), ("tpu", 0, None)])
def test_card_specs_follow_the_jax_rule(monkeypatch, spec, n_cards, want):
    # every kind but cpu is the card; an id the machine lacks is card 0
    # (cxxnet_tpu/nnet/trainer.py:252-255, cxxnet_tpu/parallel/mesh.py:80-86)
    from cxxnet_tpu_torch import device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n_cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    if want is None:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device.resolve_device(spec)
    else:
        assert device.resolve_device(spec) == torch.device(want)


def test_fp32_means_fp32_on_the_card():
    import cxxnet_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


# the serving frontend, the fleet router and their helpers: standard
# library and each other only
SERVING_MODULES = ("servd", "routerd", "lockrank", "telemetry", "health",
                   "statusd", "autopsy", "checkpoint", "kvblocks", "perf")
# imports a serving module may make inside a function, never at its top:
# the performance ledger's card spec, memory probe and profiler capture
# need torch and the package's device module, on a card only
LAZY_IMPORTS = {"perf": ("torch", "device")}


def test_serving_frontend_loads_no_jax():
    code = ("import sys\n"
            "import cxxnet_tpu_torch.utils.servd\n"
            "import cxxnet_tpu_torch.utils.routerd\n"
            "import cxxnet_tpu_torch.learn_task\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'cxxnet_tpu' or "
            "m.startswith('cxxnet_tpu.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name", SERVING_MODULES)
def test_serving_modules_are_standard_library_only(name):
    path = os.path.join(PORT, "utils", name + ".py")
    tree = ast.parse(open(path).read(), filename=path)
    top = {id(n) for n in tree.body}
    lazy = LAZY_IMPORTS.get(name, ())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name.split(".")[0] for a in node.names]
            if id(node) not in top:
                mods = [m for m in mods if m not in lazy]
        elif isinstance(node, ast.ImportFrom):
            if id(node) not in top and node.level == 2 and not node.module \
                    and all(a.name in lazy for a in node.names):
                continue
            if node.level:
                assert (node.module or "") == "" or \
                    node.module in SERVING_MODULES, (path, node.module)
                assert all(a.name in SERVING_MODULES for a in node.names
                           if not node.module), (path, node.names)
                continue
            mods = [(node.module or "").split(".")[0]]
        else:
            continue
        for m in mods:
            if m == "cxxnet_tpu_torch":
                continue             # the package's own copy of a module
            assert m in sys.stdlib_module_names, "%s imports %s" % (path, m)


def test_perf_ledger_loads_no_jax():
    """The performance ledger and the work account import neither jax nor
    the JAX package (their JAX counterparts' analyses are XLA's)."""
    code = ("import sys\n"
            "import cxxnet_tpu_torch.utils.perf\n"
            "import cxxnet_tpu_torch.nnet.cost\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'cxxnet_tpu' or "
            "m.startswith('cxxnet_tpu.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# the offline tools' twins, the kernel ops and the artifact frame: each
# loads no jax and nothing of the JAX package; the op library loads none of
# the port's net, layer, CLI or API modules (a loaded program needs torch
# and the ops it holds, nothing else)
STANDALONE = ("cxxnet_tpu_torch.tools.telemetry_report",
              "cxxnet_tpu_torch.tools.summarize_trace",
              "cxxnet_tpu_torch.tools.roofline",
              "cxxnet_tpu_torch.tools.ckpt_fsck",
              "cxxnet_tpu_torch.ops.library",
              "cxxnet_tpu_torch.utils.artifact")


@pytest.mark.parametrize("module", STANDALONE)
def test_tools_ops_and_artifact_load_no_jax(module):
    code = ("import sys\n"
            "import %s\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'cxxnet_tpu' or "
            "m.startswith('cxxnet_tpu.')))\n"
            "print(sorted(m for m in sys.modules if m.startswith("
            "('cxxnet_tpu_torch.nnet', 'cxxnet_tpu_torch.layer', "
            "'cxxnet_tpu_torch.learn_task', 'cxxnet_tpu_torch.api'))))\n"
            % module)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    bad, port = out.stdout.strip().splitlines()
    assert bad == "[]"
    if module.endswith((".library", ".artifact", ".summarize_trace")):
        assert port == "[]", port


@pytest.mark.parametrize("module", ["cxxnet_tpu_torch.io",
                                    "cxxnet_tpu_torch.utils.native"])
def test_input_path_loads_no_jax_and_nothing_of_lib(module):
    """The image input path and the host library's loader import neither
    jax nor the JAX package, and decoding a JPEG, a PPM and warping load
    the port's own library (build/cxxnet_tpu_torch/host), nothing under
    lib/ (the JAX package's native core)."""
    code = ("import sys, numpy as np\n"
            "import %s\n"
            "from cxxnet_tpu_torch.io import iter_image, synth\n"
            "from cxxnet_tpu_torch.utils import native\n"
            "img = np.full((8, 8, 3), 50, np.uint8)\n"
            "iter_image.decode_image(synth.jpeg_bytes(img))\n"
            "iter_image.decode_image(synth.ppm_bytes(img))\n"
            "native.warp_affine(img, np.eye(2, 3, dtype=np.float32), "
            "(4, 4), 0)\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'cxxnet_tpu' or "
            "m.startswith('cxxnet_tpu.')))\n"
            "maps = open('/proc/self/maps').read()\n"
            "print('/lib/libcxxnet' in maps, 'libcxn_host-' in maps)\n"
            % module)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    bad, libs = out.stdout.strip().splitlines()
    assert bad == "[]"
    assert libs == "False True"
