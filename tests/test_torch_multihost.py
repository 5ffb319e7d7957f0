"""The port's world of processes: ``multihost`` (``init_distributed``,
``worker_shard_params``, ``fetch_global``), the autograd collectives of
``parallel/collectives.py`` and the dense helpers of ``parallel/tensor.py``
over real ``gloo`` groups of 2 and 4 spawned processes, held to the JAX
package's ``psum`` / ``all_gather`` / ``psum_scatter`` and
``column_parallel_dense`` / ``row_parallel_dense`` / ``expert_parallel_ffn``
on a mesh of as many virtual CPU devices, forward and backward; the local
launcher's count of ranks; and the command line over two processes:
example/MNIST/multichip.conf (``update_on_server = 1``, ``test_on_server =
1``) through ``coordinator`` / ``num_worker`` / ``worker_rank``, and through
``dev = cpu:0-1`` alone, each model file within tolerance of the one-process
run's, written by rank 0 alone.

Children meet at a ``file://`` rendezvous under tmp_path and import only
torch, numpy and the port; a group that outlives TIME_LIMIT seconds is
killed and fails. Tolerances: the collectives move and sum values, held
to 1e-6 of the largest magnitude (a sum over ranks in another order); the
dense helpers to 1e-5 (float32 matmuls, CPU BLAS against XLA); model files
to tests/test_torch_dist_train.py's SELF_RTOL (2e-6 of each weight's
largest magnitude, beside ATOL 2e-7).
"""

import contextlib
import io
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from cxxnet_tpu_torch import api as tapi
from cxxnet_tpu_torch import learn_task as tlt
from cxxnet_tpu_torch.parallel import multihost
from tests.synth_mnist import make_dataset
from tests.test_torch_dist_train import ATOL, SELF_RTOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIME_LIMIT = 240
COLL_TOL = 1e-6
DENSE_TOL = 1e-5


def _inputs(n):
    rs = np.random.RandomState(10 + n)
    f = np.float32
    return {"red": rs.randn(n, 6, 5).astype(f),
            "red_w": rs.randn(n, 6, 5).astype(f),
            "gat": rs.randn(n, 3, 4).astype(f),
            "gat_w": rs.randn(n, 3 * n, 4).astype(f),
            "rs": rs.randn(n, 4 * n, 3).astype(f),
            "rs_w": rs.randn(n, 4, 3).astype(f),
            "x": rs.randn(8, 6).astype(f), "w": rs.randn(4 * n, 6).astype(f),
            "b": rs.randn(4 * n).astype(f),
            "y_w": rs.randn(8, 4 * n).astype(f),
            "xr": rs.randn(8, 2 * n).astype(f),
            "wr": rs.randn(5, 2 * n).astype(f), "br": rs.randn(5).astype(f),
            "yr_w": rs.randn(8, 5).astype(f),
            "probs": rs.rand(8, 2 * n).astype(f),
            "experts": rs.randn(2 * n, 6, 5).astype(f),
            "ye_w": rs.randn(8, 5).astype(f)}


def _worker(rank, n, init_file, inputs_file, out_dir):
    import torch.distributed as dist
    from cxxnet_tpu_torch.parallel import collectives, tensor
    from cxxnet_tpu_torch.parallel.mesh import Mesh
    multihost.init_distributed("file://" + init_file, n, rank, dev="cpu")
    try:
        d = {k: torch.from_numpy(v) for k, v in np.load(inputs_file).items()}
        res = {"shard": np.array(multihost.worker_shard_params())}
        world = Mesh({"data": n}, rank, groups=True)
        g = world.group("data")

        def grad_of(fn, x, w):
            x = x.clone().requires_grad_()
            y = fn(x)
            gx, = torch.autograd.grad((y * w).sum(), x)
            return y.detach().numpy(), gx.numpy()

        # the plain collectives feed a consumer that is the same on every
        # rank (one weight for all); the sum_grad ones a consumer of each
        # rank's own (a weight per rank)
        for name, sg in (("ar", False), ("ar_sum", True)):
            res[name], res[name + "_g"] = grad_of(
                lambda a, sg=sg: collectives.all_reduce(a, g, sum_grad=sg),
                d["red"][rank], d["red_w"][rank if sg else 0])
        for name, sg in (("ag", False), ("ag_sum", True)):
            res[name], res[name + "_g"] = grad_of(
                lambda a, sg=sg: collectives.all_gather(a, g, dim=0,
                                                        sum_grad=sg),
                d["gat"][rank], d["gat_w"][rank if sg else 0])
        res["rs"], res["rs_g"] = grad_of(
            lambda a: collectives.reduce_scatter(a, g, dim=0),
            d["rs"][rank], d["rs_w"][rank])
        # a joint split (model major) on a (data, model) mesh
        if n == 4:
            m = Mesh({"data": 2, "model": 2}, rank, groups=True)
            j = m.group(("model", "data"))
            res["joint"] = collectives.all_gather(
                d["gat"][j.index], j, dim=0).numpy()
            res["fetch"] = multihost.fetch_global(
                d["gat"][j.index], m, (("model", "data"), None))
        mm = Mesh({"data": 1, "model": n}, rank, groups=True)
        gm = mm.group("model")
        k = 4
        wl, bl = d["w"][rank * k:(rank + 1) * k], d["b"][rank * k:(rank + 1)
                                                         * k]
        res["col"], res["col_g"] = grad_of(
            lambda a: collectives.all_gather(
                tensor.column_parallel_dense(a, wl, bl, gm), gm, dim=1),
            d["x"], d["y_w"])
        c = 2
        res["row"], res["row_g"] = grad_of(
            lambda a: tensor.row_parallel_dense(
                a, d["wr"][:, rank * c:(rank + 1) * c], d["br"], gm),
            d["xr"][:, rank * c:(rank + 1) * c], d["yr_w"])
        me = Mesh({"data": 1, "ep": n}, rank, groups=True)
        ge = me.group("ep")
        el = d["experts"][rank * 2:(rank + 1) * 2].clone().requires_grad_()
        x = d["x"].clone().requires_grad_()
        p = d["probs"].clone().requires_grad_()
        y = tensor.expert_parallel_ffn(x, el, p, ge)
        gx, gp, ge_ = torch.autograd.grad((y * d["ye_w"]).sum(), [x, p, el])
        res.update(ep=y.detach().numpy(), ep_gx=gx.numpy(), ep_gp=gp.numpy(),
                   ep_ge=ge_.numpy())
        try:
            tensor.expert_parallel_ffn(x, el, p[:, :3], ge)
            res["ep_refusal"] = np.array("")
        except ValueError as e:
            res["ep_refusal"] = np.array(str(e))
        np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **res)
    finally:
        dist.destroy_process_group()


def _run_group(n, tmp_path):
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, **_inputs(n))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, n, str(tmp_path / "rendezvous"), inputs,
                               str(tmp_path)))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIME_LIMIT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, "%d of %d ranks still running after %d s: killed" % (
        len(hung), n, TIME_LIMIT)
    assert [p.exitcode for p in procs] == [0] * n, \
        "rank exit codes %s" % [p.exitcode for p in procs]
    return [dict(np.load(str(tmp_path / ("rank%d.npz" % r))))
            for r in range(n)]


def _jax_expected(n):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from cxxnet_tpu.parallel import collectives as jcoll
    from cxxnet_tpu.parallel import tensor as jtensor
    from cxxnet_tpu.parallel._compat import shard_map
    d = _inputs(n)
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    exp = {}

    def run(name, body, x, w, out_spec):
        fn = shard_map(body, mesh=mesh, in_specs=P("data"),
                       out_specs=out_spec)
        exp[name] = np.asarray(fn(x))
        exp[name + "_g"] = np.asarray(jax.grad(
            lambda a: jnp.sum(fn(a) * w))(x))

    # each rank's block is one leading row of the (n, ...) arrays; an out
    # spec P() is one output for every device (a replicated consumer), P
    # ("data") one each (the sum_grad forms)
    red = lambda a: jcoll.psum(a, "data")                    # noqa: E731
    gat = lambda a: jcoll.all_gather(a[0], "data")[None]     # noqa: E731
    run("ar", red, d["red"], d["red_w"][:1], P())
    run("ar_sum", red, d["red"], d["red_w"], P("data"))
    run("ag", gat, d["gat"], d["gat_w"][:1], P())
    run("ag_sum", gat, d["gat"], d["gat_w"], P("data"))
    run("rs", lambda a: jcoll.reduce_scatter(a[0], "data")[None],
        d["rs"], d["rs_w"], P("data"))
    mm = Mesh(np.array(jax.devices()[:n]), ("model",))
    me = Mesh(np.array(jax.devices()[:n]), ("ep",))

    def col(x):
        return jtensor.column_parallel_dense(x, d["w"], d["b"], mm)
    exp["col"] = np.asarray(col(d["x"]))
    exp["col_g"] = np.asarray(jax.grad(
        lambda x: jnp.sum(col(x) * d["y_w"]))(d["x"]))

    def row(x):
        return jtensor.row_parallel_dense(x, d["wr"], d["br"], mm,
                                          axis="model")
    exp["row"] = np.asarray(row(d["xr"]))
    exp["row_g"] = np.asarray(jax.grad(
        lambda x: jnp.sum(row(x) * d["yr_w"]))(d["xr"]))

    def ep(x, p, e):
        return jtensor.expert_parallel_ffn(x, e, p, me)
    exp["ep"] = np.asarray(ep(d["x"], d["probs"], d["experts"]))
    gx, gp, ge = jax.grad(lambda *a: jnp.sum(ep(*a) * d["ye_w"]),
                          argnums=(0, 1, 2))(d["x"], d["probs"],
                                             d["experts"])
    exp.update(ep_gx=np.asarray(gx), ep_gp=np.asarray(gp),
               ep_ge=np.asarray(ge))
    return d, exp


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_and_dense_helpers_across_processes(tmp_path, n):
    results = _run_group(n, tmp_path)
    d, exp = _jax_expected(n)
    for r, res in enumerate(results):
        assert tuple(res["shard"]) == (n, r)
        for name in ("ar", "ar_sum", "ag", "ag_sum", "rs"):
            one = exp[name].shape[0] == 1    # out spec P(): one output
            _close(res[name], exp[name][0 if one else r], COLL_TOL,
                   "%s rank %d" % (name, r))
            _close(res[name + "_g"], exp[name + "_g"][r], COLL_TOL,
                   "%s_g rank %d" % (name, r))
        assert "n_experts 3 not divisible by mesh axis 'ep' size %d" % n \
            in str(res["ep_refusal"])
        if n == 4:
            want = np.concatenate([d["gat"][j] for j in range(4)], 0)
            np.testing.assert_array_equal(res["joint"], want)
            np.testing.assert_array_equal(res["fetch"], want)
        for key in ("col", "col_g", "row", "ep", "ep_gx", "ep_gp"):
            _close(res[key], exp[key], DENSE_TOL, "%s rank %d" % (key, r))
        _close(res["row_g"], exp["row_g"][:, r * 2:(r + 1) * 2], DENSE_TOL,
               "row_g rank %d" % r)
        _close(res["ep_ge"], exp["ep_ge"][r * 2:(r + 1) * 2], DENSE_TOL,
               "ep_ge rank %d" % r)


def test_init_distributed_is_a_no_op_alone_and_reads_the_environment(
        monkeypatch):
    monkeypatch.delenv("CXXNET_NUM_WORKER", raising=False)
    monkeypatch.delenv("CXXNET_WORKER_RANK", raising=False)
    monkeypatch.delenv("PS_RANK", raising=False)
    multihost.init_distributed()
    multihost.init_distributed(num_processes=1, process_id=0)
    assert multihost.worker_shard_params() == (1, 0)
    assert not torch.distributed.is_initialized()
    # a world of several without a coordinator cannot meet
    monkeypatch.setenv("CXXNET_NUM_WORKER", "2")
    monkeypatch.setenv("PS_RANK", "1")
    with pytest.raises(ValueError, match="coordinator must be set"):
        multihost.init_distributed()
    monkeypatch.setenv("CXXNET_DIST_BACKEND", "gloo")
    assert multihost.backend_for("gpu") == "gloo"
    monkeypatch.delenv("CXXNET_DIST_BACKEND")
    assert multihost.backend_for("gpu") == "nccl"
    assert multihost.backend_for("cpu") == "gloo"
    x = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(multihost.fetch_global(x), x.numpy())


@pytest.mark.parametrize("dev, cards, n, local, want", [
    ("gpu:2-3", 4, 2, False, [2, 3]), ("gpu:2-3", 4, 2, True, [2, 3]),
    ("gpu:1-3", 4, 3, False, [1, 2, 3]), ("gpu:0-3", 1, 4, False,
                                          [0, 0, 0, 0]),
    ("gpu", 2, 2, False, [0, 1])])
def test_init_distributed_takes_the_card_that_holds_the_ranks_tensors(
        monkeypatch, dev, cards, n, local, want):
    """One rule maps a rank to its card: the card init_distributed makes
    current is the one device.resolve_device puts the rank's tensors on,
    once the world is up (the card count and the world mocked)."""
    from cxxnet_tpu_torch import device
    dist = torch.distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    current, joined = [], []
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: joined.append(kw))
    for r in range(n):
        if local:
            monkeypatch.setenv("LOCAL_RANK", str(r))
        multihost.init_distributed("file:///unused", n, r, dev=dev)
    assert [c.index for c in current] == want
    assert [kw["rank"] for kw in joined] == list(range(n))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: n)
    for r in range(n):
        if local:
            monkeypatch.setenv("LOCAL_RANK", str(r))
        monkeypatch.setattr(dist, "get_rank", lambda group=None, r=r: r)
        assert device.resolve_device(dev) == current[r]


def test_the_local_launch_stops_every_rank_when_one_fails(monkeypatch):
    """A rank that exits non-zero ends the launch with its code at once:
    the ranks still running (here asleep, as ranks waiting in a collective
    for the dead one would be) are killed."""
    real = subprocess.Popen
    started = []

    def fake(cmd, **kw):
        rank = int([a for a in cmd if a.startswith("worker_rank=")][0][12:])
        code = "import sys; sys.exit(3)" if rank == 1 else \
            "import time; time.sleep(600)"
        started.append(real([sys.executable, "-c", code], **kw))
        return started[-1]

    monkeypatch.setattr(subprocess, "Popen", fake)
    t = time.monotonic()
    assert tlt.LearnTask()._local_launch(["unused.conf"], 3) == 3
    assert time.monotonic() - t < 60
    assert len(started) == 3
    assert all(p.poll() is not None for p in started)


@pytest.mark.parametrize("dev, cards, extra, want", [
    ("cpu:0-3", 0, [], 4), ("cpu", 0, [], 1), ("cpu:0-1", 0,
                                               ["num_worker=2"], 1),
    ("gpu:0-3", 1, [], 1), ("gpu:0-3", 4, [], 4), ("gpu:0,2", 2, [], 1),
    ("gpu:0-3", 0, [], 1), ("cpu:0-3", 0, ["coordinator=h:1"], 1)])
def test_the_local_launch_starts_a_rank_per_listed_device(
        monkeypatch, dev, cards, extra, want):
    monkeypatch.delenv("CXXNET_NUM_WORKER", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    lt = tlt.LearnTask()
    lt.set_param("dev", dev)
    for kv in extra:
        lt.set_param(*kv.split("="))
    assert lt._local_ranks() == want


# ----------------------------------------------------------------------
# the command line over two processes
def _conf(tmp):
    text = open(os.path.join(REPO, "example/MNIST/multichip.conf")).read()
    conf = tmp / "multichip.conf"
    conf.write_text(text)
    return str(conf)


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("mh")
    make_dataset(str(root / "data"), n_train=400, n_test=100)
    return root


ARGS = ["num_round=2", "max_round=2", "save_model=1", "silent=1"]


def _cli_procs(root, argvs):
    """bin/cxxnet_torch with each argv in a process of its own in root;
    each one's (returncode, output)."""
    entry = os.path.join(REPO, "bin", "cxxnet_torch")
    env = dict(os.environ)
    env.pop("CXXNET_NUM_WORKER", None)
    procs = [subprocess.Popen([sys.executable, entry] + a, cwd=str(root),
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    out = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=TIME_LIMIT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        out.append((p.returncode, o))
    return out


def _model(path, conf):
    net = tapi.Net(dev="cpu", cfg=open(conf).read())
    net.load_model(path)
    return net.net_.canonical_params(), net.net_.opt_state


@pytest.fixture(scope="module")
def one_process(mnist_dir):
    conf = _conf(mnist_dir)
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(str(mnist_dir))
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert tlt.LearnTask().run([conf, "dev=cpu", "model_dir=m1"]
                                       + ARGS) == 0
    finally:
        os.chdir(old)
    return conf, _model(str(mnist_dir / "m1" / "0002.model"), conf)


def _same_model(got, want):
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        for k in b:
            np.testing.assert_allclose(
                a[k], b[k], rtol=0,
                atol=SELF_RTOL * float(np.abs(b[k]).max()) + ATOL,
                err_msg="layer %d %s" % (i, k))
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        for k in b:
            for sk in b[k]:
                np.testing.assert_allclose(
                    a[k][sk].numpy(), b[k][sk].numpy(), rtol=0,
                    atol=SELF_RTOL * float(b[k][sk].abs().max()) + ATOL)


def test_two_processes_through_coordinator_num_worker_worker_rank(
        mnist_dir, one_process):
    conf, want = one_process
    rdv = "file://" + str(mnist_dir / "rdv")
    runs = _cli_procs(mnist_dir, [
        [conf, "dev=cpu:0-1", "coordinator=" + rdv, "num_worker=2",
         "worker_rank=%d" % r, "model_dir=%s" % ("m2" if r == 0 else
                                                 "m2_rank1")] + ARGS
        for r in range(2)])
    for rc, out in runs:
        assert rc == 0, out
    # rank 0 alone writes: rank 1's model_dir never appears
    assert sorted(os.listdir(str(mnist_dir / "m2"))) == [
        "0000.model", "0001.model", "0002.model"]
    assert not (mnist_dir / "m2_rank1").exists()
    _same_model(_model(str(mnist_dir / "m2" / "0002.model"), conf), want)


def test_a_cpu_device_list_starts_its_ranks_itself(mnist_dir, one_process):
    conf, want = one_process
    (rc, out), = _cli_procs(mnist_dir, [[conf, "dev=cpu:0-1",
                                         "model_dir=m3"] + ARGS])
    assert rc == 0, out
    assert sorted(os.listdir(str(mnist_dir / "m3"))) == [
        "0000.model", "0001.model", "0002.model"]
    _same_model(_model(str(mnist_dir / "m3" / "0002.model"), conf), want)


# ----------------------------------------------------------------------
# the command line over two processes on a multi-part image pack: every
# rank reads the whole stream (as in the JAX package) and trains on its
# rows of each batch, and the prediction is gathered whole
IMG_PAGE = 1 << 14
IMG_CONF = """
data = train
iter = imgbin
  image_conf_prefix = "../part%%d"
  image_conf_ids = 0-1
  image_mean = "mean.bin"
  page_size = %(page)d
  shuffle = 1
  rand_crop = 1
  rand_mirror = 1
iter = threadbuffer
iter = end
pred = pred.txt
iter = imgbin
  image_conf_prefix = "../part%%d"
  image_conf_ids = 0-1
  image_mean = "mean.bin"
  page_size = %(page)d
iter = threadbuffer
iter = end
netconfig=start
layer[0->1] = conv:c1
  kernel_size = 5
  stride = 2
  nchannel = 8
layer[1->2] = relu
layer[2->3] = max_pooling
  kernel_size = 3
  stride = 2
layer[3->4] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[4->5] = flatten
layer[5->6] = fullc:fc
  nhidden = 10
layer[6->6] = softmax
netconfig=end
input_shape = 3,32,32
batch_size = 8
momentum = 0.9
eta = 0.001
random_type = xavier
silent = 1
""" % {"page": IMG_PAGE}


@pytest.fixture(scope="module")
def image_runs(tmp_path_factory):
    """The image config trained two rounds and then predicting, once in
    this process and once on two ranks started by ``dev = cpu:0-1``; the
    two working directories."""
    from cxxnet_tpu_torch.io import synth
    root = tmp_path_factory.mktemp("img_parts")
    for part in range(2):
        synth.make_ppm_pack(str(root), "part%d" % part, 16, 36, 10,
                            seed=part, page_ints=IMG_PAGE)
    dirs = {}
    for side in ("one", "two"):
        wd = root / side
        wd.mkdir()
        (wd / "task.conf").write_text(IMG_CONF)
        dirs[side] = wd
    train = ["num_round=2", "max_round=2", "model_dir=m"]
    pred = ["task=pred", "model_in=m/0002.model"]
    old = os.getcwd()
    os.chdir(str(dirs["one"]))
    try:
        for args in (train, pred):
            with contextlib.redirect_stdout(io.StringIO()):
                assert tlt.LearnTask().run(["task.conf", "dev=cpu"]
                                           + args) == 0
    finally:
        os.chdir(old)
    for args in (train, pred):
        (rc, out), = _cli_procs(dirs["two"], [["task.conf", "dev=cpu:0-1"]
                                              + args])
        assert rc == 0, out
    return dirs


def test_two_ranks_on_an_image_conf_prefix_pack_match_one_process(
        image_runs):
    conf = str(image_runs["one"] / "task.conf")
    want = _model(str(image_runs["one"] / "m" / "0002.model"), conf)
    got = _model(str(image_runs["two"] / "m" / "0002.model"), conf)
    _same_model(got, want)
    # the prediction of every image of both parts, in the stream's order
    one = (image_runs["one"] / "pred.txt").read_text().split()
    two = (image_runs["two"] / "pred.txt").read_text().split()
    assert len(one) == 32
    assert two == one
    # rank 0 alone wrote the mean image, the same bytes as one process's
    assert (image_runs["two"] / "mean.bin").read_bytes() == \
        (image_runs["one"] / "mean.bin").read_bytes()


# ----------------------------------------------------------------------
# the mean image in a world: every rank takes rank 0's finding, so no rank
# skips the mean's augmented pass (and its draws) that another makes
MEAN_CHAIN = """iter = imgbin
  image_list = "%(root)s/p.lst"
  image_bin = "%(root)s/p.bin"
  image_mean = "%(root)s/mean.bin"
  rand_crop = 1
  rand_mirror = 1
input_shape = 3,32,32
batch_size = 8
"""


def _mean_worker(rank, n, init_file, root):
    import os as os_
    from cxxnet_tpu_torch import io as tio
    from cxxnet_tpu_torch.utils.config import parse_config_string
    import torch.distributed as dist
    multihost.init_distributed("file://" + init_file, n, rank, dev="cpu")
    try:
        mean = os_.path.join(root, "mean.bin")
        if rank == 0:
            # rank 0 finds no mean image; the others find the one there
            real = os_.path.exists
            os_.path.exists = lambda p: False if p == mean else real(p)
        it = tio.create_iterator(parse_config_string(MEAN_CHAIN
                                                     % {"root": root}))
        it.init()
        it.before_first()
        assert it.next()
        np.save(os_.path.join(root, "batch%d.npy" % rank),
                np.asarray(it.value().data))
    finally:
        dist.destroy_process_group()


def test_every_rank_takes_rank_0s_finding_of_the_mean_image(tmp_path):
    """Rank 0 makes the mean image (an augmented pass over the pack) where
    another rank would find rank 0's file already written: every rank
    follows rank 0, so their draws, and so their batches, stay equal."""
    from cxxnet_tpu_torch import io as tio
    from cxxnet_tpu_torch.io import synth
    from cxxnet_tpu_torch.utils.config import parse_config_string
    synth.make_ppm_pack(str(tmp_path), "p", 16, 36, 10, seed=3)
    one = tio.create_iterator(parse_config_string(
        MEAN_CHAIN % {"root": str(tmp_path)}))
    one.init()
    one.before_first()
    assert one.next() and (tmp_path / "mean.bin").exists()
    want = np.asarray(one.value().data)
    n = 2
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mean_worker,
                         args=(r, n, str(tmp_path / "rdv"), str(tmp_path)))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIME_LIMIT)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung and [p.exitcode for p in procs] == [0] * n
    for r in range(n):
        np.testing.assert_array_equal(np.load(str(tmp_path /
                                                  ("batch%d.npy" % r))),
                                      want, err_msg="rank %d" % r)
