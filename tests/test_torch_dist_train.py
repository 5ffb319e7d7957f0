"""The port's modes over ranks against the JAX ``Trainer`` on a mesh of as
many virtual CPU devices: data parallelism, ``update_on_server`` (ZeRO-1),
``fsdp`` (ZeRO-3, with ``update_period`` and composed with
``model_parallel``), ``model_parallel`` (tensor parallelism, on fullc and
on grouped convolutions before an LRN, as ImageNet.conf has them) and
``expert_parallel``, on the nets of the JAX package's tests/test_fsdp.py,
tests/test_compose.py and tests/test_moe.py, at groups of 2 and 4 ranks.

The parent runs the JAX trainers and hands their initial weights and the
batches over as numpy; the children (``torch.multiprocessing``, spawned)
import only torch, numpy and the port, join one ``gloo`` world through
``multihost.init_distributed`` at a ``file://`` rendezvous under the test's
tmp_path, start every case from the JAX weights (``Trainer.load_params``)
and run all the cases of one group size in one spawn. A group is joined
within TIME_LIMIT seconds and killed on expiry, so that a hung collective
cannot hang the suite.

Beside JAX, the cases hold: a net with batch-norm (moving average) and
dropout at dp 2 to the port's single rank (the statistics over the whole
batch, each rank's rows of the whole batch's mask); ``clip_global_norm``
and the health vector under dp x TP; every rank's parameter and optimizer
bytes under ZeRO-1 and fsdp; and a model file written at 4 ranks, loaded
at 1, written again and loaded at 2, with the same predictions.

Tolerance. The JAX tests hold their meshes to the single device at 2e-6
relative (tests/test_fsdp.py:59). The port against JAX on one device
already differs by float32 rounding of the matmuls (CPU BLAS against
XLA's), which three momentum steps carry into the weights: PARAM_RTOL 2e-5
of each weight's largest magnitude holds both packages' n-rank runs to
each other (the bar of the port's single-device tests, 1e-5, doubled for
the sums over ranks taken in another order). The port's n ranks against
its own single rank: SELF_RTOL 2e-6, the JAX tests' own bar. Both beside
the JAX tests' absolute 2e-7 (ATOL), which a tensor of rounding noise needs:
a conv bias before a batch-norm has a zero gradient in exact arithmetic.
Predictions (argmax) are equal.
"""

import os
import time

import numpy as np
import pytest
import torch.multiprocessing as mp

TIME_LIMIT = 240
PARAM_RTOL = 2e-5
SELF_RTOL = 2e-6
ATOL = 2e-7

MLP = """
netconfig = start
layer[+1:fc1] = fullc:fc1
  nhidden = 64
  init_sigma = 0.05
layer[+1] = relu
layer[+1:fc2] = fullc:fc2
  nhidden = 32
  init_sigma = 0.05
layer[+1] = relu
layer[+1:fc3] = fullc:fc3
  nhidden = 8
  init_sigma = 0.1
layer[+0] = softmax
netconfig = end
input_shape = 1,1,48
batch_size = 16
eta = 0.1
momentum = 0.9
"""

ATT = """
netconfig = start
layer[+1:att] = attention:att
  nhead = 4
  causal = 1
  init_sigma = 0.1
layer[+1] = flatten
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[+1] = relu
layer[+1:fc2] = fullc:fc2
  nhidden = 5
  init_sigma = 0.1
layer[+0] = softmax
netconfig = end
input_shape = 8,1,4
batch_size = 16
eta = 0.1
momentum = 0.9
"""

MOE = """
netconfig = start
layer[+1:fc1] = fullc:fc1
  nhidden = 12
  init_sigma = 0.1
layer[+1] = relu
layer[+1:moe1] = moe:moe1
  nexpert = 8
  nhidden = 10
  init_sigma = 0.1
layer[+1:fc2] = fullc:fc2
  nhidden = 5
  init_sigma = 0.1
layer[+0] = softmax
netconfig = end
input_shape = 1,1,9
batch_size = 16
eta = 0.1
momentum = 0.9
"""

CONV_BN = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 8
  random_type = xavier
layer[1->2] = batch_norm:b1
  moving_average = 1
layer[2->3] = relu
layer[3->4] = flatten
layer[4->5] = fullc:fc
  nhidden = 8
  init_sigma = 0.1
layer[5->5] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 16
eta = 0.1
"""

# ImageNet.conf's pieces: grouped convolutions and LRN
CONV_TP = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 8
  random_type = xavier
layer[1->2] = relu
layer[2->3] = lrn
  local_size = 3
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[3->4] = conv:c2
  kernel_size = 3
  ngroup = 2
  nchannel = 8
  pad = 1
  random_type = xavier
layer[4->5] = relu
layer[5->6] = flatten
layer[6->7] = fullc:fc
  nhidden = 6
  init_sigma = 0.1
layer[7->7] = softmax
netconfig = end
input_shape = 4,8,8
batch_size = 16
eta = 0.1
momentum = 0.9
"""

# the port's single rank is the reference here: dropout's bits are not
# JAX's
BN_DROPOUT = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 8
  ngroup = 1
  random_type = xavier
layer[1->2] = batch_norm:b1
  moving_average = 1
layer[2->3] = relu
layer[3->4] = flatten
layer[4->5] = fullc:fc1
  nhidden = 32
  init_sigma = 0.1
layer[5->6] = batch_norm:b2
layer[6->7] = relu
layer[7->7] = dropout
  threshold = 0.5
layer[7->8] = fullc:fc2
  nhidden = 8
  init_sigma = 0.1
layer[8->8] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 16
eta = 0.1
momentum = 0.9
metric = error
"""

# name -> (net, keys, group sizes, batch rows, steps); the mode keys ride
# both packages
CASES = {
    "dp": (MLP, "", (2, 4), 16, 3),
    "zero": (MLP, "update_on_server = 1\n", (2, 4), 16, 3),
    "fsdp": (MLP, "fsdp = 1\n", (2, 4), 16, 3),
    "fsdp_accum": (MLP, "fsdp = 1\nupdate_period = 2\nbatch_size = 8\n",
                   (2, 4), 8, 4),
    "fsdp_tp": (MLP, "fsdp = 1\nmodel_parallel = 2\n", (4,), 16, 3),
    "zero_tp": (MLP, "update_on_server = 1\nmodel_parallel = 2\n", (4,),
                16, 3),
    "dp_tp_att": (ATT, "model_parallel = 2\n", (2, 4), 16, 3),
    "dp_ep": (MOE, "expert_parallel = 2\n", (2, 4), 16, 3),
    "fsdp_conv_bn": (CONV_BN, "fsdp = 1\n", (2, 4), 16, 2),
    "dp_tp_conv": (CONV_TP, "model_parallel = 2\n", (2, 4), 16, 2),
    "clip_health_tp": (MLP, "model_parallel = 2\nclip_global_norm = 0.05\n"
                       "health_monitor = 1\n", (4,), 16, 3),
}
# dims of each case's input rows; labels in [0, NCLASS)
SHAPES = {MLP: (1, 1, 48), ATT: (8, 1, 4), MOE: (1, 1, 9),
          CONV_BN: (3, 8, 8), BN_DROPOUT: (3, 8, 8), CONV_TP: (4, 8, 8)}
NCLASS = {MLP: 8, ATT: 5, MOE: 5, CONV_BN: 8, BN_DROPOUT: 8, CONV_TP: 6}


def _batches(case, n_steps, rows, seed=7):
    net = CASES[case][0] if case in CASES else BN_DROPOUT
    rs = np.random.RandomState(seed)
    out = {}
    for s in range(n_steps):
        out["x%d" % s] = rs.rand(rows, *SHAPES[net]).astype(np.float32)
        out["y%d" % s] = rs.randint(0, NCLASS[net], (rows, 1)).astype(
            np.float32)
    out["xp"] = rs.rand(16, *SHAPES[net]).astype(np.float32)
    return out


def cases_for(n):
    return [c for c, v in CASES.items() if n in v[2]]


def _jax_run(cfg, n, data, steps):
    """The JAX trainer on n virtual devices: its initial weights, weights
    after ``steps`` updates, predictions, and last health vector."""
    from cxxnet_tpu.io.data import DataBatch
    from cxxnet_tpu.nnet.trainer import Trainer
    from cxxnet_tpu.utils.config import parse_config_string
    tr = Trainer()
    dev = "cpu" if n == 1 else "cpu:0-%d" % (n - 1)
    for k, v in parse_config_string(cfg + "dev = %s\n" % dev):
        tr.set_param(k, v)
    tr.init_model()
    init = [{k: np.array(v) for k, v in p.items()}
            for p in tr.canonical_params()]
    for s in range(steps):
        b = DataBatch()
        b.data, b.label = data["x%d" % s], data["y%d" % s]
        b.batch_size = b.data.shape[0]
        tr.update(b)
    health = None if tr.last_health is None else np.asarray(tr.last_health)
    return {"init": init,
            "params": [{k: np.array(v) for k, v in p.items()}
                       for p in tr.canonical_params()],
            "pred": np.asarray(tr.predict(data["xp"])), "health": health}


def _flat_params(prefix, params):
    out = {"%s/%d/%s" % (prefix, i, k): v for i, p in enumerate(params)
           for k, v in p.items()}
    out[prefix + "/n"] = np.int64(len(params))
    return out


def _unflat(d, prefix):
    if prefix + "/n" not in d:
        return []
    out = [{} for _ in range(int(d[prefix + "/n"]))]
    for key, v in d.items():
        if key.startswith(prefix + "/") and key != prefix + "/n":
            i, k = key[len(prefix) + 1:].split("/", 1)
            out[int(i)][k] = v
    return out


def run_case_on_rank(tapi, case, cfg, n, data, steps):
    """One case on this rank; its results (rank 0's are compared)."""
    from cxxnet_tpu_torch.parallel import multihost
    net = tapi.Net(dev="cpu:0-%d" % (n - 1) if n > 1 else "cpu", cfg=cfg)
    net.init_model()
    tr = net.net_
    init = _unflat(data, "init/" + case)
    if init:
        tr.load_params(init)
    res = {"param_bytes": np.int64(tr.param_bytes()),
           "opt_bytes": np.int64(tr.opt_bytes())}
    for s in range(steps):
        net.update(data["%s/x%d" % (case, s)], data["%s/y%d" % (case, s)])
    res.update(_flat_params("params", tr.canonical_params()))
    res["pred"] = net.predict(data["%s/xp" % case])
    res["eval"] = np.array(net.evaluate(None, "train"))
    if tr.last_health is not None:
        res["health"] = np.asarray(tr.last_health.tolist()
                                   if hasattr(tr.last_health, "tolist")
                                   else tr.last_health, np.float32)
    res["ranks"] = np.int64(multihost.worker_shard_params()[0])
    return net, res


def _worker(rank, n, init_file, inputs_file, out_dir, jobs):
    """One rank: every job of the spawn; results to out_dir."""
    from cxxnet_tpu_torch import api as tapi
    from cxxnet_tpu_torch.parallel import multihost
    import torch.distributed as dist
    multihost.init_distributed("file://" + init_file, n, rank, dev="cpu")
    try:
        data = dict(np.load(inputs_file))
        for job in jobs:
            kind, case = job[0], job[1]
            if kind == "case":
                cfg, steps, save = job[2], job[3], job[4]
                net, res = run_case_on_rank(tapi, case, cfg, n, data, steps)
                if save:
                    net.save_model(os.path.join(out_dir, save))
            else:   # ("load", name, cfg, file, case of the batch)
                net = tapi.Net(dev="cpu:0-%d" % (n - 1), cfg=job[2])
                net.load_model(job[3])
                res = {"pred": net.predict(data["%s/xp" % job[4]])}
                res.update(_flat_params("params",
                                        net.net_.canonical_params()))
                res["opt_bytes"] = np.int64(net.net_.opt_bytes())
            np.savez(os.path.join(out_dir, "%s.rank%d.npz" % (case, rank)),
                     **res)
    finally:
        dist.destroy_process_group()


def run_group(n, tmp_path, inputs, jobs, tag="g"):
    """Spawn n ranks over ``inputs`` (a dict of arrays) running ``jobs``;
    {case: [rank results]}, or a failure when a rank fails or the group
    outlives TIME_LIMIT."""
    d = tmp_path / ("%s%d" % (tag, n))
    d.mkdir()
    inputs_file = str(d / "inputs.npz")
    np.savez(inputs_file, **inputs)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, n, str(d / "rendezvous"), inputs_file,
                               str(d), jobs))
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
    return {job[1]: [dict(np.load(str(d / ("%s.rank%d.npz" % (job[1], r)))))
                     for r in range(n)] for job in jobs}


def _close(got, want, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    atol = ATOL if rtol else 0.0
    assert err <= rtol * scale + atol, "%s: max |diff| %g > %g x %g + %g" \
        % (what, err, rtol, scale, atol)


def _params_close(got, want, rtol, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert sorted(a) == sorted(b), (what, i)
        for k in b:
            _close(a[k], b[k], rtol, "%s layer %d %s" % (what, i, k))


def port_single(cfg, data, case, steps):
    """The port's single rank on the same weights and batches."""
    from cxxnet_tpu_torch import api as tapi
    _, res = run_case_on_rank(tapi, case, cfg, 1, data, steps)
    return res


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every case at 2 and 4 ranks, JAX's and the port's, and the model
    file's round trip 4 -> 1 -> 2; one spawn per group size."""
    tmp = tmp_path_factory.mktemp("dist")
    out = {"jax": {}, "port": {}, "single": {}}
    for n in (4, 2):
        inputs, jobs = {}, []
        for case in cases_for(n):
            net, keys, _, rows, steps = CASES[case]
            data = _batches(case, steps, rows)
            jr = _jax_run(net + keys, n, data, steps)
            out["jax"][(case, n)] = jr
            inputs.update({"%s/%s" % (case, k): v for k, v in data.items()})
            inputs.update(_flat_params("init/" + case, jr["init"]))
            save = "fsdp4.model" if (case, n) == ("fsdp", 4) else ""
            jobs.append(("case", case, net + keys, steps, save))
            if n == 2:
                out["single"][case] = port_single(
                    net + keys.replace("model_parallel = 2\n", "")
                    .replace("expert_parallel = 2\n", ""),
                    {"%s/%s" % (case, k): v for k, v in data.items()}
                    | _flat_params("init/" + case, jr["init"]), case, steps)
        if n == 2:
            data = _batches("bn_dropout", 3, 16, seed=11)
            inputs.update({"bn_dropout/%s" % k: v for k, v in data.items()})
            jobs.append(("case", "bn_dropout", BN_DROPOUT, 3, ""))
            out["single"]["bn_dropout"] = port_single(
                BN_DROPOUT, {"bn_dropout/%s" % k: v for k, v in data.items()},
                "bn_dropout", 3)
            jobs.append(("load", "fsdp_from_1", MLP + "fsdp = 1\n",
                         out["file1"], "fsdp"))
        out["port"][n] = run_group(n, tmp, inputs, jobs)
        if n == 4:
            # the 4-rank file at one rank, and written again there
            from cxxnet_tpu_torch import api as tapi
            one = tapi.Net(dev="cpu", cfg=MLP)
            one.load_model(str(tmp / "g4" / "fsdp4.model"))
            out["file_params4"] = one.net_.canonical_params()
            out["pred_at_1"] = one.predict(
                _batches("fsdp", 3, 16)["xp"])
            out["file1"] = str(tmp / "fsdp1.model")
            one.save_model(out["file1"])
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_each_mode_matches_the_jax_trainer_on_a_mesh_of_as_many(groups, n):
    for case in cases_for(n):
        jr = groups["jax"][(case, n)]
        ranks = groups["port"][n][case]
        assert all(int(r["ranks"]) == n for r in ranks)
        got = [_unflat(r, "params") for r in ranks]
        # every rank gathers the same whole model
        for g in got[1:]:
            _params_close(g, got[0], 0.0, "%s: rank vs rank 0" % case)
        _params_close(got[0], jr["params"], PARAM_RTOL,
                      "%s at %d ranks vs JAX" % (case, n))
        for r in ranks:
            np.testing.assert_array_equal(r["pred"], jr["pred"],
                                          err_msg=case)


def test_two_ranks_match_the_ports_single_rank(groups):
    for case in cases_for(2):
        single = groups["single"][case]
        got = _unflat(groups["port"][2][case][0], "params")
        _params_close(got, _unflat(single, "params"), SELF_RTOL,
                      "%s at 2 ranks vs 1" % case)


def test_batch_norm_and_dropout_at_dp2_match_the_single_rank(groups):
    """BN over the whole batch (running statistics equal on every rank)
    and each rank's rows of the whole batch's dropout mask: the 2-rank
    step is the 1-rank step, and the train metric covers every row."""
    single = groups["single"]["bn_dropout"]
    ranks = groups["port"][2]["bn_dropout"]
    for r in ranks:
        _params_close(_unflat(r, "params"), _unflat(single, "params"),
                      SELF_RTOL, "bn_dropout at 2 ranks vs 1")
        np.testing.assert_array_equal(r["pred"], single["pred"])
        assert str(r["eval"]) == str(single["eval"]), (r["eval"],
                                                       single["eval"])


def test_clip_global_norm_and_health_vector_under_dp_x_tp(groups):
    jr = groups["jax"][("clip_health_tp", 4)]
    for r in groups["port"][4]["clip_health_tp"]:
        # loss, grad_norm_sq, nan_grad_elems, ok: the same on every rank
        np.testing.assert_allclose(r["health"], jr["health"], rtol=2e-5)
        assert r["health"][3] == 1.0


def test_zero1_and_fsdp_shard_bytes(groups):
    """ZeRO-1: each rank's optimizer state ~1/n of the single rank's, the
    weights whole; fsdp: both ~1/n (the 1-D biases stay whole)."""
    single = groups["single"]
    for n in (2, 4):
        for case, params_frac, opt_frac in (("zero", 1.0, 1.0 / n),
                                            ("fsdp", 1.0 / n, 1.0 / n)):
            for r in groups["port"][n][case]:
                pb = int(r["param_bytes"]) / int(single[case]["param_bytes"])
                ob = int(r["opt_bytes"]) / int(single[case]["opt_bytes"])
                # fsdp leaves the 1-D biases whole: 2% of the MLP's bytes
                assert params_frac * 0.9 <= pb <= params_frac * 1.1, \
                    (case, n, pb)
                assert ob <= opt_frac * 1.05, (case, n, ob)


def test_checkpoint_round_trip_across_degrees(groups):
    """Written at 4 ranks under fsdp: the canonical file, which one rank
    loads with the 4-rank run's weights and predictions; written again at
    one rank, two ranks load it to the same."""
    four = groups["port"][4]["fsdp"][0]
    _params_close(groups["file_params4"], _unflat(four, "params"), 0.0,
                  "4-rank file at 1 rank")
    np.testing.assert_array_equal(groups["pred_at_1"], four["pred"])
    for r in groups["port"][2]["fsdp_from_1"]:
        _params_close(_unflat(r, "params"), groups["file_params4"], 0.0,
                      "1-rank file at 2 ranks")
        np.testing.assert_array_equal(r["pred"], four["pred"])
        assert int(r["opt_bytes"]) < int(groups["single"]["fsdp"]
                                         ["opt_bytes"])
