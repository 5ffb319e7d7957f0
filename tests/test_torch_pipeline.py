"""The port's pipeline parallelism and its ``seq_parallel`` over a real
``sp`` axis against the JAX ``Trainer`` on a mesh of as many virtual CPU
devices: GPipe at 2 and 4 stages, composed with data parallelism (with
batch-norm, whose statistics are per microbatch and data shard), ZeRO-1
of a stage (``fsdp = 1``), tensor parallelism (``lm_pipeline.conf`` at 4
devices), sequence parallelism inside a stage and expert parallelism,
``pipeline_micro``, ``update_period``, ``clip_global_norm`` with the
health vector; and sequence parallelism over an sp axis outside the
pipeline (dp x sp and sp x tp, ring and Ulysses).

The spawns are tests/test_torch_dist_train.py's (its worker: one ``gloo``
world per group size at a ``file://`` rendezvous under tmp_path, every
case of the size in turn, TIME_LIMIT to join; here the JAX trainers step
while the ranks run), on the same bars:
PARAM_RTOL of each weight's largest magnitude plus ATOL against JAX,
SELF_RTOL against the port's single rank for the case with dropout (its
bits are the port's: a microbatch keeps its rows of the whole batch's
draw, where JAX folds the microbatch into its key), and equal
predictions. One case needs a bar of its own: on ``lm_pipeline.conf``
the JAX pipeline is itself off the JAX single device by more than
PARAM_RTOL (0.0368 of the position table's largest magnitude after two
Adam steps, 1.16e-3 with momentum SGD; its tensor parallelism alone
4e-7 with SGD), where the port's pipeline stays within float32 rounding
of the port's single rank but for Adam's amplification of near-zero
gradients. There each tensor is held to JAX's pipeline within twice
JAX's own pipeline-vs-single-device difference plus the bar
(``JAX_OWN_GAP``), as the bf16 tests hold the port to twice JAX's own
bf16-vs-f32 error. Beside them: each pipe rank holds its own stage's weights
and, under ZeRO-1, half of their optimizer state; a model file written at
2 stages is canonical and loads at 1 rank and at 4 stages; and the
pipeline's hop and the sp split / gather pair on their own.
"""

import os
import time

import numpy as np
import pytest
import torch.multiprocessing as mp

from tests.test_torch_dist_train import (ATOL, ATT, CONV_BN, MLP, MOE,
                                         PARAM_RTOL, SELF_RTOL, TIME_LIMIT,
                                         _flat_params, _jax_run,
                                         _params_close, _unflat, _worker,
                                         port_single)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = open(os.path.join(REPO, "example", "transformer",
                       "lm_pipeline.conf")).read().replace(
                           "dev = tpu:0-7\n", "")
ATT_ULYSSES = ATT.replace("  causal = 1\n", "  causal = 1\n"
                          "  sp_mode = ulysses\n")
MLP_DROP = MLP.replace("layer[+1:fc2]", "layer[+0] = dropout\n"
                       "  threshold = 0.5\nlayer[+1:fc2]") + "metric = error\n"

PP2 = "pipeline_parallel = 2\n"
# name -> (net, keys, ranks, batch rows, steps, input row shape, classes)
CASES = {
    "pp2": (MLP, PP2, 2, 16, 2, (1, 1, 48), 8),
    "pp4": (MLP, "pipeline_parallel = 4\n", 4, 16, 2, (1, 1, 48), 8),
    "pp2_dp2_bn": (CONV_BN, PP2, 4, 16, 2, (3, 8, 8), 8),
    "pp2_tp2_lm": (LM, "", 4, 16, 2, None, 28),
    "pp2_sp2": (ATT, PP2 + "seq_parallel = 2\n", 4, 16, 2, (8, 1, 4), 5),
    "pp2_ep2": (MOE, PP2 + "expert_parallel = 2\n", 4, 16, 2, (1, 1, 9),
                5),
    "pp2_dp2_zero1": (MLP, PP2 + "fsdp = 1\n", 4, 16, 2, (1, 1, 48), 8),
    "pp2_dp2_micro4": (MLP, PP2 + "pipeline_micro = 4\n", 4, 16, 2,
                       (1, 1, 48), 8),
    "pp2_dp2_accum": (MLP, PP2 + "update_period = 2\nbatch_size = 8\n", 4,
                      8, 2, (1, 1, 48), 8),
    "pp2_dp2_clip_health": (MLP, PP2 + "clip_global_norm = 0.05\n"
                            "health_monitor = 1\n", 4, 16, 2, (1, 1, 48),
                            8),
    "dp2_sp2_ring": (ATT, "seq_parallel = 2\n", 4, 16, 2, (8, 1, 4), 5),
    "dp2_sp2_ulysses": (ATT_ULYSSES, "seq_parallel = 2\n", 4, 16, 2,
                        (8, 1, 4), 5),
    "sp2_tp2_ring": (ATT, "seq_parallel = 2\nmodel_parallel = 2\n", 4, 16,
                     2, (8, 1, 4), 5),
    "sp2_tp2_ulysses": (ATT_ULYSSES, "seq_parallel = 2\nmodel_parallel = "
                        "2\n", 4, 16, 2, (8, 1, 4), 5),
    # against the port's single rank: dropout's bits are the port's
    "pp2_dropout": (MLP_DROP, PP2, 2, 16, 2, (1, 1, 48), 8),
}
JAX_CASES = [c for c in CASES if c != "pp2_dropout"]
# cases held to JAX's pipeline within twice its own distance from the JAX
# single device (module docstring), with the keys that make the single
# device's config
JAX_OWN_GAP = {"pp2_tp2_lm": ("pipeline_parallel = 2\nmodel_parallel = 2\n"
                              "fsdp = 1\n", "")}


def _batches(case, seed=7):
    net, _, _, rows, steps, shape, ncls = CASES[case]
    rs = np.random.RandomState(seed)
    out = {}
    for s in range(steps):
        if shape is None:     # the LM: token ids, a label per position
            out["x%d" % s] = rs.randint(0, ncls, (rows, 1, 1, 64)).astype(
                np.float32)
            out["y%d" % s] = rs.randint(0, ncls, (rows, 64)).astype(
                np.float32)
        else:
            out["x%d" % s] = rs.rand(rows, *shape).astype(np.float32)
            out["y%d" % s] = rs.randint(0, ncls, (rows, 1)).astype(
                np.float32)
    out["xp"] = out["x0"] if rows == 16 else np.concatenate(
        [out["x0"], out["x1"]])
    return out


def _jax_trainer(cfg, n):
    """The JAX trainer of ``cfg`` on n virtual devices and its initial
    weights (tests/test_torch_dist_train.py's ``_jax_run``, cut in two so
    that the port's ranks run while JAX steps)."""
    from cxxnet_tpu.nnet.trainer import Trainer
    from cxxnet_tpu.utils.config import parse_config_string
    tr = Trainer()
    dev = "cpu" if n == 1 else "cpu:0-%d" % (n - 1)
    for k, v in parse_config_string(cfg + "dev = %s\n" % dev):
        tr.set_param(k, v)
    tr.init_model()
    return tr, [{k: np.array(v) for k, v in p.items()}
                for p in tr.canonical_params()]


def _jax_steps(tr, init, data, steps):
    from cxxnet_tpu.io.data import DataBatch
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


def _spawn(n, d, inputs, jobs):
    """tests/test_torch_dist_train.py's ``run_group`` started: n ranks of
    its worker over ``inputs`` running ``jobs`` in directory d."""
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
    return procs


def _join(procs, d, jobs):
    deadline = time.monotonic() + TIME_LIMIT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    n = len(procs)
    assert not hung, "%d of %d ranks still running after %d s: killed" % (
        len(hung), n, TIME_LIMIT)
    assert [p.exitcode for p in procs] == [0] * n, \
        "rank exit codes %s" % [p.exitcode for p in procs]
    return {job[1]: [dict(np.load(str(d / ("%s.rank%d.npz" % (job[1], r)))))
                     for r in range(n)] for job in jobs}


def _case_inputs(case, jr):
    data = _batches(case)
    inputs = {"%s/%s" % (case, k): v for k, v in data.items()}
    if jr is not None:
        inputs.update(_flat_params("init/" + case, jr["init"]))
    return inputs


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every case at its rank count in one spawn per count (2, then 4),
    the JAX runs on as many devices, the port's single rank where the
    case is held to it, and the model file 2 stages -> 1 rank -> 4."""
    tmp = tmp_path_factory.mktemp("pipe")
    out = {"jax": {}, "port": {}, "single": {}}
    for n in (2, 4):
        inputs, jobs, jax_todo = {}, [], []
        for case, (net, keys, ranks, _, steps, _, _) in CASES.items():
            if ranks != n:
                continue
            init = None
            if case in JAX_CASES:
                tr, init = _jax_trainer(net + keys, n)
                jax_todo.append((case, tr, init, steps))
            inputs.update(_case_inputs(case, {"init": init} if init
                                       else None))
            jobs.append(("case", case, net + keys, steps,
                         "pp2.model" if case == "pp2" else ""))
        if n == 4:
            jobs.append(("load", "pp4_from_file", MLP + "pipeline_parallel "
                         "= 4\n", str(tmp / "g2" / "pp2.model"), "pp2"))
            inputs.update(_case_inputs("pp2", out["jax"]["pp2"]))
        # the port's ranks run while JAX steps and the single ranks run
        procs = _spawn(n, tmp / ("g%d" % n), inputs, jobs)
        try:
            for case, tr, init, steps in jax_todo:
                out["jax"][case] = _jax_steps(tr, init, _batches(case),
                                              steps)
                if case in JAX_OWN_GAP:
                    net = CASES[case][0]
                    one = net.replace(*JAX_OWN_GAP[case])
                    assert one != net
                    out["jax"][case + "/1"] = _jax_run(
                        one, 1, _batches(case), steps)
            if n == 2:
                out["single"]["pp2_dropout"] = port_single(
                    MLP_DROP, _case_inputs("pp2_dropout", None),
                    "pp2_dropout", CASES["pp2_dropout"][4])
                out["single"]["pp2"] = port_single(
                    MLP, _case_inputs("pp2", out["jax"]["pp2"]), "pp2",
                    CASES["pp2"][4])
        finally:
            out["port"][n] = _join(procs, tmp / ("g%d" % n), jobs)
        if n == 2:
            from cxxnet_tpu_torch import api as tapi
            one = tapi.Net(dev="cpu", cfg=MLP)
            one.load_model(str(tmp / "g2" / "pp2.model"))
            out["file_at_1"] = (one.net_.canonical_params(),
                                one.predict(_batches("pp2")["xp"]))
    return out


@pytest.mark.parametrize("case", JAX_CASES)
def test_each_case_matches_the_jax_trainer_on_a_mesh_of_as_many(groups,
                                                                case):
    n = CASES[case][2]
    jr = groups["jax"][case]
    ranks = groups["port"][n][case]
    assert all(int(r["ranks"]) == n for r in ranks)
    got = [_unflat(r, "params") for r in ranks]
    # every rank gathers the same whole model, every stage's weights
    for g in got[1:]:
        _params_close(g, got[0], 0.0, "%s: rank vs rank 0" % case)
    if case in JAX_OWN_GAP:
        one = groups["jax"][case + "/1"]["params"]
        for i, (a, b, c) in enumerate(zip(got[0], jr["params"], one)):
            for k in b:
                gap = float(np.abs(b[k] - c[k]).max())
                err = float(np.abs(a[k] - b[k]).max())
                bar = 2 * gap + PARAM_RTOL * float(np.abs(b[k]).max()) \
                    + ATOL
                assert err <= bar, "%s layer %d %s: %g > %g (JAX's own " \
                    "gap %g)" % (case, i, k, err, bar, gap)
    else:
        _params_close(got[0], jr["params"], PARAM_RTOL,
                      "%s at %d ranks vs JAX" % (case, n))
    for r in ranks:
        np.testing.assert_array_equal(r["pred"], jr["pred"], err_msg=case)


def test_dropout_in_a_stage_draws_the_single_ranks_rows(groups):
    """Each microbatch keeps its rows of the whole batch's dropout draw,
    and the backward's recompute replays it: two stages train what one
    rank does, and count the same train metric."""
    single = groups["single"]["pp2_dropout"]
    for r in groups["port"][2]["pp2_dropout"]:
        _params_close(_unflat(r, "params"), _unflat(single, "params"),
                      SELF_RTOL, "pp2 with dropout vs one rank")
        np.testing.assert_array_equal(r["pred"], single["pred"])
        # the train metric: the last stage's sums, on every rank
        assert "train-error" in str(r["eval"])
        assert str(r["eval"]) == str(single["eval"]), (r["eval"],
                                                       single["eval"])


def test_each_pipe_rank_holds_its_own_stage(groups):
    """A pipe rank's weights are its stage's (the stages' bytes add up to
    one rank's); its optimizer state those weights' (momentum: the same
    bytes), and under ZeRO-1 over 2 data ranks half of them (the flat
    stage cut in 2, padded by at most a float)."""
    whole = int(groups["single"]["pp2"]["param_bytes"])
    pp2 = groups["port"][2]["pp2"]
    assert sum(int(r["param_bytes"]) for r in pp2) == whole
    assert all(0 < int(r["param_bytes"]) < whole for r in pp2)
    for r in pp2:
        assert int(r["opt_bytes"]) == int(r["param_bytes"])
    pp4 = groups["port"][4]["pp4"]
    assert sum(int(r["param_bytes"]) for r in pp4) == whole
    zero = groups["port"][4]["pp2_dp2_zero1"]
    plain = groups["port"][4]["pp2_dp2_micro4"]
    for z, p in zip(zero, plain):
        assert int(z["param_bytes"]) == int(p["param_bytes"])
        assert abs(int(z["opt_bytes"]) - int(p["opt_bytes"]) / 2) <= 4


def test_clip_global_norm_and_health_vector_under_the_pipeline(groups):
    jr = groups["jax"]["pp2_dp2_clip_health"]
    for r in groups["port"][4]["pp2_dp2_clip_health"]:
        # loss, grad_norm_sq, nan_grad_elems, ok: the same on every rank
        np.testing.assert_allclose(r["health"], jr["health"], rtol=2e-5)
        assert r["health"][3] == 1.0


def test_a_model_file_written_at_two_stages_loads_at_one_and_at_four(
        groups):
    two = groups["port"][2]["pp2"][0]
    params1, pred1 = groups["file_at_1"]
    _params_close(params1, _unflat(two, "params"), 0.0,
                  "2-stage file at 1 rank")
    np.testing.assert_array_equal(pred1, two["pred"])
    for r in groups["port"][4]["pp4_from_file"]:
        _params_close(_unflat(r, "params"), params1, 0.0,
                      "2-stage file at 4 stages")
        np.testing.assert_array_equal(r["pred"], two["pred"])


# ----------------------------------------------------------------------
# the hop and the sp pair on their own, at 4 ranks
def _hop_worker(rank, n, init_file, out_dir):
    import torch
    import torch.distributed as dist
    from cxxnet_tpu_torch.parallel import collectives
    from cxxnet_tpu_torch.parallel.mesh import Mesh
    from cxxnet_tpu_torch.parallel import multihost
    multihost.init_distributed("file://" + init_file, n, rank, dev="cpu")
    try:
        res = {}
        mesh = Mesh({"data": 1, "pipe": n}, rank, groups=True)
        g = mesh.group("pipe")
        # forward: stage s sends two tensors to s + 1; backward: s + 1
        # sends a gradient back to s (no wraparound either way)
        x = torch.full((3,), float(rank + 1))
        sends = []
        if rank < n - 1:
            sends += collectives.hop_send([x, x.to(torch.float64) * 2], g,
                                          rank + 1)
        got = collectives.hop_recv([((3,), torch.float32),
                                    ((3,), torch.float64)], g, rank - 1,
                                   "cpu") if rank > 0 else []
        if rank > 0:
            sends += collectives.hop_send([got[0] * 10], g, rank - 1)
        back = collectives.hop_recv([((3,), torch.float32)], g, rank + 1,
                                    "cpu") if rank < n - 1 else []
        collectives.hop_wait(sends)
        res["hop"] = got[0].numpy() if got else np.zeros(3, np.float32)
        res["hop2"] = got[1].numpy() if got else np.zeros(3)
        res["back"] = back[0].numpy() if back else np.zeros(3, np.float32)
        res["hops"] = np.array([collectives.hops, collectives.hop_bytes])
        sp = Mesh({"data": 2, "sp": 2}, rank, groups=True)
        gs = sp.group("sp")
        w = torch.arange(8, dtype=torch.float32, requires_grad=True)
        part = collectives.split(w * 1.0, gs, dim=0)
        back = collectives.all_gather(part * (gs.index + 2), gs, dim=0)
        (back * torch.arange(8.0)).sum().backward()
        res["split"] = part.detach().numpy()
        res["split_grad"] = w.grad.numpy()
        np.savez(os.path.join(out_dir, "hop.rank%d.npz" % rank), **res)
    finally:
        dist.destroy_process_group()


def test_the_hop_and_the_sp_split_gather_pair_over_four_ranks(tmp_path):
    """The hop: stage s's tensors at s + 1 in the order sent, in their
    own dtypes, and a gradient from s + 1 back at s, no wraparound, each
    send counted with its bytes. The sp pair: split keeps this rank's block and all-gathers the gradients;
    all_gather's backward keeps this rank's block of a gradient that is
    the same on every rank (no sum), so every rank holds the whole
    gradient."""
    n = 4
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_hop_worker,
                         args=(r, n, str(tmp_path / "rdv"), str(tmp_path)))
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
    assert not hung and [p.exitcode for p in procs] == [0] * n
    for r in range(n):
        d = np.load(str(tmp_path / ("hop.rank%d.npz" % r)))
        np.testing.assert_array_equal(d["hop"], np.full(3, float(r)))
        np.testing.assert_array_equal(d["hop2"], np.full(3, 2.0 * r))
        want = 10.0 * (r + 1) if r < n - 1 else 0.0
        np.testing.assert_array_equal(d["back"], np.full(3, want))
        sent = (r < n - 1) * 2 + (r > 0)
        assert list(d["hops"]) == [sent, (r < n - 1) * (12 + 24)
                                   + (r > 0) * 12]
        j = r % 2                       # the rank's place on sp
        np.testing.assert_array_equal(d["split"],
                                      np.arange(8.0)[j * 4:(j + 1) * 4])
        # d loss / d w: position i weighed i by the rank holding block
        # i // 4 (its factor i // 4 + 2), on every sp rank
        pos = np.arange(8.0)
        np.testing.assert_array_equal(d["split_grad"],
                                      pos * (pos // 4 + 2))


# ----------------------------------------------------------------------
# the command line: lm_pipeline.conf's composition (pipe 2 x model 2) on
# four processes that dev = cpu:0-3 starts, on multichip.conf's MNIST net
def test_the_command_line_trains_pipe_by_model_on_four_ranks(tmp_path):
    import contextlib
    import io
    from cxxnet_tpu_torch import learn_task as tlt
    from tests.synth_mnist import make_dataset
    from tests.test_torch_multihost import (ARGS, _cli_procs, _conf, _model,
                                            _same_model)
    make_dataset(str(tmp_path / "data"), n_train=200, n_test=100)
    conf = _conf(tmp_path)
    old = os.getcwd()
    os.chdir(str(tmp_path))
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            assert tlt.LearnTask().run([conf, "dev=cpu", "model_dir=m1"]
                                       + ARGS) == 0
    finally:
        os.chdir(old)
    (rc, out), = _cli_procs(tmp_path, [[conf, "dev=cpu:0-3",
                                        "pipeline_parallel=2",
                                        "model_parallel=2", "model_dir=m4"]
                                       + ARGS])
    assert rc == 0, out
    assert sorted(os.listdir(str(tmp_path / "m4"))) == [
        "0000.model", "0001.model", "0002.model"]
    _same_model(_model(str(tmp_path / "m4" / "0002.model"), conf),
                _model(str(tmp_path / "m1" / "0002.model"), conf))
