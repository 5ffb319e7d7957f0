"""The port's sequence-parallel collectives and attention across processes:
``ring_shift``, ``all_to_all``, ``ring_attention`` (the kernel ring, whose
steps run their plain versions on the CPU, and the dense ring) and
``ulysses_attention`` over a real ``gloo`` process group of 2 and 4
processes, forward and backward through the autograd collectives, held to
the JAX package's results on a mesh of as many virtual CPU devices.

The parent computes the JAX results and hands the inputs over as numpy; the
children (``torch.multiprocessing``, spawned) import only torch, numpy and
the port, meet through a ``file://`` rendezvous under the test's tmp_path
(no port to collide with under pytest-xdist) and run every case of one
group size in one spawn. Each test joins its processes within TIME_LIMIT
seconds, kills them on expiry and fails, so that a hung collective cannot
hang the suite.

Tolerances: the collectives move values unchanged, so they are held
exactly; attention to 2e-4 of the largest magnitude, the JAX package's own
bar for its ring (tests/test_ring_flash.py) and Ulysses
(tests/test_parallel.py).
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cxxnet_tpu_torch.parallel import collectives, ring

TIME_LIMIT = 240
ATTN_TOL = 2e-4
# (name, function, per-rank L, h, nkv, d, causal, window): the per-rank
# shard of 128 rows takes the ring-step kernels' path, that of 16 the
# dense ring
ATTN_CASES = [
    ("ring_kernel_gqa_window", "ring", 128, 4, 2, 16, True, 100),
    ("ring_kernel_noncausal", "ring", 128, 2, 1, 16, False, 0),
    ("ring_dense_causal", "ring", 16, 4, 2, 8, True, 0),
    ("ulysses_causal", "ulysses", 32, 4, 4, 8, True, 0),
]


def _inputs(n):
    """Global arrays of every case for a group of n, from one seed."""
    rs = np.random.RandomState(n)
    data = {"shift_x": rs.randn(3 * n, 5).astype(np.float32),
            "shift_w": rs.randn(3 * n, 5).astype(np.float32),
            "a2a_x": rs.randn(2 * n, 2 * n, 6).astype(np.float32),
            "a2a_w": rs.randn(2 * n, 2, 6 * n).astype(np.float32)}
    for name, _, s, h, nkv, d, _, _ in ATTN_CASES:
        L = s * n
        for t, heads in (("q", h), ("k", nkv), ("v", nkv), ("w", h)):
            data["%s_%s" % (name, t)] = rs.randn(1, heads, L, d).astype(
                np.float32)
    return data


def _worker(rank, n, init_file, inputs_file, out_dir):
    """One rank: every case on its own shards; results to out_dir."""
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            world_size=n, rank=rank)
    try:
        data = dict(np.load(inputs_file))
        group = dist.group.WORLD
        res = {}

        def rows(a, size):  # this rank's shard along axis 0
            return torch.from_numpy(a[rank * size:(rank + 1) * size])

        for shift in (1, -1, 2):
            x = rows(data["shift_x"], 3).requires_grad_()
            y = collectives.ring_shift(x, group, shift)
            g, = torch.autograd.grad((y * rows(data["shift_w"], 3)).sum(),
                                     x)
            res["shift%d" % shift], res["shift%d_grad" % shift] = \
                y.detach().numpy(), g.numpy()
        x = rows(data["a2a_x"], 2).requires_grad_()
        y = collectives.all_to_all(x, group, split_axis=1, concat_axis=2)
        g, = torch.autograd.grad((y * rows(data["a2a_w"], 2)).sum(), x)
        res["a2a"], res["a2a_grad"] = y.detach().numpy(), g.numpy()
        for name, fn, s, _, _, _, causal, window in ATTN_CASES:
            leaves = [torch.from_numpy(np.ascontiguousarray(
                data["%s_%s" % (name, t)][:, :, rank * s:(rank + 1) * s]))
                .requires_grad_() for t in "qkv"]
            w = torch.from_numpy(np.ascontiguousarray(
                data["%s_w" % name][:, :, rank * s:(rank + 1) * s]))
            attend = ring.ring_attention if fn == "ring" \
                else ring.ulysses_attention
            out = attend(*leaves, group=group, causal=causal, window=window)
            grads = torch.autograd.grad((out * w).sum(), leaves)
            res[name] = out.detach().numpy()
            for t, g in zip("qkv", grads):
                res["%s_d%s" % (name, t)] = g.numpy()
        np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **res)
    finally:
        dist.destroy_process_group()


def _run_group(n, tmp_path):
    """Spawn n ranks over the inputs of _inputs(n); their results, or a
    failure when a rank fails or the group outlives TIME_LIMIT."""
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
    """The JAX package's results for the same global inputs on a mesh of n
    virtual CPU devices, its ring on its Pallas step kernels (interpreted)
    where the shard takes them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from cxxnet_tpu import ops as jops
    from cxxnet_tpu.parallel import collectives as jcoll
    from cxxnet_tpu.parallel import ring as jring
    from cxxnet_tpu.parallel._compat import shard_map

    data = _inputs(n)
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    exp = {}

    def with_grad(fn, x, w):
        return (np.asarray(fn(x)),
                np.asarray(jax.grad(lambda a: jnp.sum(fn(a) * w))(x)))

    for shift in (1, -1, 2):
        fn = shard_map(lambda a, s=shift: jcoll.ring_shift(a, "sp", s),
                       mesh=mesh, in_specs=P("sp"), out_specs=P("sp"))
        exp["shift%d" % shift], exp["shift%d_grad" % shift] = with_grad(
            fn, data["shift_x"], data["shift_w"])
    fn = shard_map(lambda a: jcoll.all_to_all(a, "sp", split_axis=1,
                                              concat_axis=2),
                   mesh=mesh, in_specs=P("sp"), out_specs=P("sp"))
    exp["a2a"], exp["a2a_grad"] = with_grad(fn, data["a2a_x"],
                                            data["a2a_w"])
    os.environ["CXXNET_RING"] = "flash"
    jops.set_use_pallas(True)
    try:
        for name, kind, _, _, _, _, causal, window in ATTN_CASES:
            q, k, v, w = (data["%s_%s" % (name, t)] for t in "qkvw")
            attend = jring.ring_attention if kind == "ring" \
                else jring.ulysses_attention

            def fn(q_, k_, v_):
                return attend(q_, k_, v_, mesh, causal=causal, window=window)
            exp[name] = np.asarray(fn(q, k, v))
            grads = jax.grad(lambda *a: jnp.sum(fn(*a) * w),
                             argnums=(0, 1, 2))(q, k, v)
            for t, g in zip("qkv", grads):
                exp["%s_d%s" % (name, t)] = np.asarray(g)
    finally:
        jops.set_use_pallas(None)
        os.environ.pop("CXXNET_RING", None)
    return exp


def _gathered(results, key, axis):
    return np.concatenate([r[key] for r in results], axis)


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_and_attention_across_processes(tmp_path, n):
    assert dist.is_gloo_available()
    results = _run_group(n, tmp_path)
    exp = _jax_expected(n)
    for shift in (1, -1, 2):
        for key in ("shift%d" % shift, "shift%d_grad" % shift):
            np.testing.assert_array_equal(_gathered(results, key, 0),
                                          exp[key], err_msg=key)
    for key in ("a2a", "a2a_grad"):
        np.testing.assert_array_equal(_gathered(results, key, 0), exp[key],
                                      err_msg=key)
    for name, *_ in ATTN_CASES:
        for key in (name, name + "_dq", name + "_dk", name + "_dv"):
            got, want = _gathered(results, key, 2), exp[key]
            np.testing.assert_allclose(
                got, want, rtol=ATTN_TOL,
                atol=ATTN_TOL * float(np.abs(want).max()),
                err_msg="%s, %d processes" % (key, n))
