"""The port's corpus tools (cxxnet_tpu_torch/tools/im2bin.py and
imgbin_partition_maker.py) against the JAX package's tools/im2bin.py and
tools/imgbin_partition_maker.py, on the CPU: the same list of the JPEG
fixtures of tests/data/jpeg, packed with small pages so that records cross
page boundaries, gives byte-identical bins; the same pack split into
shards gives byte-identical lists and bins; both run as programs with the
same arguments, and the port's pack reads back through the port's
imgbin iterator.
"""

import glob
import hashlib
import os
import subprocess
import sys

import pytest

from cxxnet_tpu_torch.tools import im2bin, imgbin_partition_maker
from cxxnet_tpu_torch.utils.binary_page import BinaryPage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEGS = sorted(glob.glob(os.path.join(REPO, "tests", "data", "jpeg",
                                      "*.jpg")))
# pages of 8 KiB: the fixtures (1-6 KiB each) share pages and spill over
PAGE_INTS = 1 << 11


def _jax_tool(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def image_list(tmp_path):
    assert len(JPEGS) >= 6
    lst = tmp_path / "images.lst"
    with open(lst, "w") as f:
        for i, p in enumerate(JPEGS * 2):       # repeats: more pages
            f.write("%d\t%d\t%s\n" % (i, i % 5, os.path.basename(p)))
    return str(lst), os.path.dirname(JPEGS[0])


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_im2bin_bytes_equal_the_jax_tool(image_list, tmp_path):
    lst, root = image_list
    ours, theirs = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    n = im2bin.im2bin(lst, root, ours, PAGE_INTS)
    assert n == _jax_tool("im2bin").im2bin(lst, root, theirs, PAGE_INTS)
    assert n == 2 * len(JPEGS)
    assert os.path.getsize(ours) >= 3 * PAGE_INTS * 4
    assert _sha(ours) == _sha(theirs)
    # every record reads back whole, in list order
    recs = []
    with open(ours, "rb") as f:
        while True:
            page = BinaryPage.load(f, PAGE_INTS)
            if page is None:
                break
            recs.extend(page[i] for i in range(page.size()))
    assert recs == [open(p, "rb").read() for p in JPEGS * 2]


@pytest.mark.parametrize("npart", [1, 3, 4])
def test_partitions_equal_the_jax_tool(image_list, tmp_path, npart):
    lst, root = image_list
    binp = str(tmp_path / "all.bin")
    im2bin.im2bin(lst, root, binp, PAGE_INTS)
    for side, mod in (("port", imgbin_partition_maker),
                      ("jax", _jax_tool("imgbin_partition_maker"))):
        d = tmp_path / side
        d.mkdir()
        assert mod.partition(lst, binp, npart, str(d / "part%d"),
                             PAGE_INTS) == 2 * len(JPEGS)
    names = sorted(os.listdir(str(tmp_path / "jax")))
    assert names == sorted(os.listdir(str(tmp_path / "port")))
    assert len(names) == 2 * npart
    for nm in names:
        assert _sha(str(tmp_path / "port" / nm)) == \
            _sha(str(tmp_path / "jax" / nm)), nm


def test_tools_run_as_programs_like_the_jax_tools(image_list, tmp_path):
    lst, root = image_list
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = {}
    for side, argv0 in (("port", ["-m", "cxxnet_tpu_torch.tools.im2bin"]),
                        ("jax", [os.path.join(REPO, "tools",
                                              "im2bin.py")])):
        out = str(tmp_path / (side + ".bin"))
        r = subprocess.run([sys.executable, *argv0, lst, root, out,
                            str(PAGE_INTS)], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        outs[side] = (r.stdout.replace(out, "OUT"), _sha(out))
        d = tmp_path / (side + "_parts")
        d.mkdir()
        mod = ["-m", "cxxnet_tpu_torch.tools.imgbin_partition_maker"] \
            if side == "port" else [os.path.join(
                REPO, "tools", "imgbin_partition_maker.py")]
        r = subprocess.run([sys.executable, *mod, lst, out, "2",
                            str(d / "shard"), str(PAGE_INTS)], cwd=REPO,
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr
        outs[side + "_parts"] = (
            r.stdout.replace(str(d), "DIR"),
            [_sha(str(d / nm)) for nm in sorted(os.listdir(str(d)))])
    assert outs["port"] == outs["jax"]
    assert outs["port_parts"] == outs["jax_parts"]
    assert outs["port"][0].startswith("packed %d images" % (2 * len(JPEGS)))


def test_the_port_reads_its_pack(image_list, tmp_path):
    from cxxnet_tpu_torch import api
    lst, root = image_list
    binp = str(tmp_path / "p.bin")
    im2bin.im2bin(lst, root, binp, PAGE_INTS)
    it = api.DataIter("iter = imgbin\n  image_list = %s\n  image_bin = %s\n"
                      "  page_size = %d\n  silent = 1\niter = end\n"
                      "input_shape = 3,16,16\nbatch_size = 4\n"
                      "round_batch = 1\n" % (lst, binp, PAGE_INTS))
    it.before_first()
    n = 0
    while it.next():
        n += 1
    it.close()
    assert n == (2 * len(JPEGS) + 3) // 4
