"""The port stands alone: importing it loads neither jax nor any module of
the JAX package, no file of it imports them, and a GPU device spec without
a card raises instead of running on the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "cxxnet_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _module_names():
    names = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        if rel == "chip_smoke.py":
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
