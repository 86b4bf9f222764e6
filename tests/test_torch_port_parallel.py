"""``torcheval_tpu_torch.parallel`` against ``torcheval_tpu.parallel``.

The same numpy inputs go through the JAX functions under ``shard_map`` on
the conftest's 8 virtual CPU devices and through the port over
``ThreadWorld`` ranks (one thread a rank, tensors handed over by
reference), with the JAX tests' tolerances: ring attention 2e-5, MoE
1e-5, pipeline 1e-6. Also: the dense oracles against each other, the
composed dp x sp / dp x pp / dp x ep steps, the collective census of the
composed step (the port's analogue of
``tests/parallel/test_composed_mesh.py``'s HLO count), ``_axis`` itself,
and one spawned gloo world of 4 driving ``_axis`` over
``torch.distributed``. The ``*_grads_flow`` cases are in
``test_torch_port_parallel_grads.py``.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import lax

try:
    from jax import shard_map
except ImportError:  # pre-0.4.38 jax keeps it under experimental
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import chip_smoke
import torcheval_tpu.parallel as jpar
import torcheval_tpu_torch.parallel as tpar
from torcheval_tpu.metrics.functional.classification.accuracy import (
    _multiclass_accuracy_update as jax_accuracy_update,
)
from torcheval_tpu.metrics.functional.text.perplexity import (
    _perplexity_update_jit as jax_perplexity_update,
)
from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
    _multiclass_accuracy_update,
)
from torcheval_tpu_torch.metrics.functional.text.perplexity import _perplexity_update_jit
from torcheval_tpu_torch.parallel import _axis
from torcheval_tpu_torch.utils.test_utils import ThreadWorld

RNG = np.random.default_rng(1715)
B, S, H, D = 2, 32, 4, 8
RING_TOL = 2e-5
MOE_TOL = 1e-5
PIPE_TOL = 1e-6
# the port against the JAX package through a pipeline: the two CPU
# backends reassociate float32 dot products, and up to 8 stages compound it
PIPE_CROSS_TOL = 1e-5


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices("cpu")[:n]).reshape(shape), names)


def _t(a):
    return torch.from_numpy(np.array(a))


def _run(world, fn):
    return ThreadWorld(world, timeout=60).run(fn)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def test_exports_match_the_jax_package():
    assert tpar.__all__ == jpar.__all__


# ------------------------------------------------------------ ring attention


def _qkv(b=B):
    return tuple(RNG.normal(size=(b, S, H, D)).astype(np.float32) for _ in range(3))


def _ring_blocks(q, k, v, g, causal, rows=slice(None)):
    blk = S // g.world_size
    cut = slice(g.rank * blk, (g.rank + 1) * blk)
    return tpar.ring_attention(
        _t(q[rows, cut]), _t(k[rows, cut]), _t(v[rows, cut]), group=g, causal=causal
    )


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax_ring_and_dense(n_shards, causal):
    q, k, v = _qkv()
    spec = P(None, "sp", None, None)
    jax_ring = jax.jit(shard_map(
        partial(jpar.ring_attention, axis_name="sp", causal=causal),
        mesh=_mesh((n_shards,), ("sp",)), in_specs=(spec,) * 3, out_specs=spec,
    ))(q, k, v)
    jax_dense = jpar.dense_reference_attention(q, k, v, causal=causal)

    blocks = _run(n_shards, lambda g: _ring_blocks(q, k, v, g, causal))
    port_ring = torch.cat(blocks, dim=1)
    port_dense = tpar.dense_reference_attention(_t(q), _t(k), _t(v), causal=causal)
    _close(port_ring, jax_ring, RING_TOL)
    _close(port_ring, jax_dense, RING_TOL)
    _close(port_dense, jax_dense, RING_TOL)


def test_ring_at_world_one_is_dense():
    """One rank: every hop is a permute to itself, a copy."""
    q, k, v = _qkv()
    out = _run(1, lambda g: _ring_blocks(q, k, v, g, True))[0]
    _close(out, jpar.dense_reference_attention(q, k, v), RING_TOL)


def test_sequence_sharded_perplexity_counters():
    """Counters of sequence-sharded logits, ``psum``-ed over the axis,
    equal the unsharded update: the JAX package's in-program form."""
    vocab, sp = 11, 8
    logits = RNG.normal(size=(B, S, vocab)).astype(np.float32)
    targets = RNG.integers(0, vocab, (B, S))
    blk = S // sp

    def rank(g):
        cut = slice(g.rank * blk, (g.rank + 1) * blk)
        nll, count = _perplexity_update_jit(_t(logits[:, cut]), _t(targets[:, cut]), None)
        return _axis.psum(torch.stack([nll, count.to(torch.float32)]), g)

    sharded = _run(sp, rank)
    nll, count = jax_perplexity_update(jnp.asarray(logits), jnp.asarray(targets), None)
    for got in sharded:
        np.testing.assert_allclose(float(got[0]), float(nll), rtol=1e-5)
        assert float(got[1]) == float(count)


# ----------------------------------------------------------------------- MoE

DIM, HID = 8, 32


def _moe_params(n_experts):
    return (
        RNG.normal(size=(DIM, n_experts)).astype(np.float32),
        (RNG.normal(size=(n_experts, DIM, HID)) * 0.3).astype(np.float32),
        (RNG.normal(size=(n_experts, HID, DIM)) * 0.3).astype(np.float32),
    )


def _jax_moe(x, wg, w1, w2, n_experts, capacity, dp=1):
    names = ("dp", "ep") if dp > 1 else ("ep",)
    tok = P(("dp", "ep")) if dp > 1 else P("ep")
    mesh = _mesh((dp, n_experts) if dp > 1 else (n_experts,), names)
    return np.asarray(jax.jit(shard_map(
        lambda x, wg, w1, w2: jpar.moe_apply(x, wg, w1[0], w2[0], axis_name="ep", capacity=capacity),
        mesh=mesh, in_specs=(tok, P(), P("ep"), P("ep")), out_specs=tok,
    ))(x, wg, w1, w2))


def _port_moe(x, wg, w1, w2, n_experts, capacity, dp=1):
    per = x.shape[0] // (dp * n_experts)

    def rank(g):
        ep = g.new_subgroup([g.rank // n_experts * n_experts + e for e in range(n_experts)])
        e = ep.rank
        return tpar.moe_apply(_t(x[g.rank * per:(g.rank + 1) * per]), _t(wg), _t(w1[e]),
                              _t(w2[e]), group=ep, capacity=capacity)

    return torch.cat(_run(dp * n_experts, rank)).numpy()


@pytest.mark.parametrize("n_experts", [2, 4, 8])
def test_moe_matches_jax(n_experts):
    per = 16
    wg, w1, w2 = _moe_params(n_experts)
    x = RNG.normal(size=(n_experts * per, DIM)).astype(np.float32)
    # capacity >= shard size: nothing drops, the oracle is pure routing
    got = _port_moe(x, wg, w1, w2, n_experts, per)
    _close(got, _jax_moe(x, wg, w1, w2, n_experts, per), MOE_TOL)
    jax_ref = jpar.moe_reference(x, wg, w1, w2, num_shards=n_experts, capacity=per)
    port_ref = tpar.moe_reference(_t(x), _t(wg), _t(w1), _t(w2), num_shards=n_experts, capacity=per)
    _close(port_ref, jax_ref, MOE_TOL)
    _close(got, port_ref, MOE_TOL)


@pytest.mark.parametrize("n_experts", [2, 4, 8])
def test_moe_capacity_drops_overflow(n_experts):
    """Overflow tokens (later arrivals at the same expert from the same
    shard) give exactly zero output in both packages and both paths, and
    kept tokens match."""
    per, capacity = 16, 2
    wg, w1, w2 = _moe_params(n_experts)
    x = RNG.normal(size=(n_experts * per, DIM)).astype(np.float32)
    got = _port_moe(x, wg, w1, w2, n_experts, capacity)
    want = _jax_moe(x, wg, w1, w2, n_experts, capacity)
    ref = tpar.moe_reference(_t(x), _t(wg), _t(w1), _t(w2), num_shards=n_experts,
                             capacity=capacity).numpy()
    _close(got, want, MOE_TOL)
    _close(ref, want, MOE_TOL)
    dropped = np.all(want == 0.0, axis=-1)
    assert dropped.any()
    np.testing.assert_array_equal(np.all(got == 0.0, axis=-1), dropped)
    np.testing.assert_array_equal(np.all(ref == 0.0, axis=-1), dropped)


def test_moe_route_ties_take_the_first_expert():
    """``argmax`` takes the first maximum, and positions count arrivals
    in source order, as ``jnp.argmax`` and the int32 cumsum do."""
    x = np.zeros((6, DIM), np.float32)  # every gate logit 0: all experts tie
    wg = RNG.normal(size=(DIM, 4)).astype(np.float32)
    from torcheval_tpu.parallel.moe import _route as jax_route
    from torcheval_tpu_torch.parallel.moe import _route

    for got, want in zip(_route(_t(x), _t(wg)), jax_route(jnp.asarray(x), jnp.asarray(wg))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _route(_t(x), _t(wg))[0].tolist() == [0] * 6


# ------------------------------------------------------------------ pipeline

MB, PDIM = 4, 16


def _stage_torch(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _stage_jax(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _stacked(n_stages, dim=PDIM):
    return {
        "w": (RNG.normal(size=(n_stages, dim, dim)) * 0.5).astype(np.float32),
        "b": (RNG.normal(size=(n_stages, dim)) * 0.1).astype(np.float32),
    }


def _jax_pipeline(params, x, n_stages, dp=1):
    mesh = _mesh((dp, n_stages), ("dp", "pp")) if dp > 1 else _mesh((n_stages,), ("pp",))
    xspec = P(None, "dp") if dp > 1 else P()

    def run(stacked, x):
        local = jax.tree_util.tree_map(lambda a: a[0], stacked)
        return jpar.pipeline_apply(_stage_jax, local, x, axis_name="pp")

    return np.asarray(jax.jit(shard_map(
        run, mesh=mesh, in_specs=(P("pp"), xspec), out_specs=xspec))(params, x))


def _port_pipeline(params, x, n_stages, dp=1):
    rows = x.shape[1] // dp

    def rank(g):
        row = g.rank // n_stages
        pp = g.new_subgroup([row * n_stages + s for s in range(n_stages)])
        local = {k: _t(v[pp.rank]) for k, v in params.items()}
        return tpar.pipeline_apply(_stage_torch, local, _t(x[:, row * rows:(row + 1) * rows]),
                                   group=pp)

    outs = _run(dp * n_stages, rank)
    for r, out in enumerate(outs):  # every stage of a row returns the row's output
        torch.testing.assert_close(out, outs[r // n_stages * n_stages], rtol=0, atol=0)
    return torch.cat(outs[::n_stages], dim=1).numpy()


@pytest.mark.parametrize("n_stages", [2, 4, 8])
@pytest.mark.parametrize("n_micro", [1, 3, 8])
def test_pipeline_matches_jax(n_stages, n_micro):
    params = _stacked(n_stages)
    x = RNG.normal(size=(n_micro, MB, PDIM)).astype(np.float32)
    got = _port_pipeline(params, x, n_stages)
    ref = tpar.pipeline_reference(_stage_torch, {k: _t(v) for k, v in params.items()}, _t(x))
    _close(got, ref, PIPE_TOL)
    _close(got, _jax_pipeline(params, x, n_stages), PIPE_CROSS_TOL)
    _close(ref, jpar.pipeline_reference(_stage_jax, params, x), PIPE_CROSS_TOL)


def test_pipeline_with_metric_counters():
    """Accuracy counters on the pipeline's output equal the JAX package's
    on its oracle output, on every stage."""
    n_stages, n_micro = 4, 4
    params = _stacked(n_stages)
    x = RNG.normal(size=(n_micro, MB, PDIM)).astype(np.float32)
    targets = RNG.integers(0, PDIM, (n_micro, MB))

    def rank(g):
        local = {k: _t(v[g.rank]) for k, v in params.items()}
        logits = tpar.pipeline_apply(_stage_torch, local, _t(x), group=g)
        nc, nt = _multiclass_accuracy_update(
            logits.reshape(-1, PDIM), _t(targets).reshape(-1), "micro", None, 1)
        return float(nc), float(nt)

    oracle = jpar.pipeline_reference(_stage_jax, params, x)
    nc, nt = jax_accuracy_update(oracle.reshape(-1, PDIM), jnp.asarray(targets).reshape(-1),
                                 "micro", None, 1)
    assert _run(n_stages, rank) == [(float(nc), float(nt))] * n_stages
    assert float(nt) == n_micro * MB


# ----------------------------------------------------------- composed steps


def _dp_sp_step(g, q, k, v, dp, sp):
    """Rank ``g.rank`` of a dp x sp world: its batch rows, its sequence
    block, the ring on the sp row, counters summed over the world."""
    row = g.rank // sp
    sp_group = g.new_subgroup([row * sp + j for j in range(sp)])
    rows = slice(row * (q.shape[0] // dp), (row + 1) * (q.shape[0] // dp))
    out = _ring_blocks(q, k, v, sp_group, True, rows)
    num_pos = _axis.psum(torch.sum(out > 0.0).to(torch.float32), g)
    num_total = _axis.psum(torch.tensor(float(out.numel())), g)
    return out, num_pos, num_total


def test_ring_attention_composes_with_dp_and_in_step_metric():
    dp, sp = 2, 4
    q, k, v = _qkv(b=4)
    spec = P("dp", "sp", None, None)
    mesh = _mesh((dp, sp), ("dp", "sp"))

    def step(q, k, v):
        out = jpar.ring_attention(q, k, v, axis_name="sp", causal=True)
        pos = lax.psum(jnp.sum(out > 0.0).astype(jnp.float32), ("dp", "sp"))
        return out, pos, lax.psum(jnp.float32(out.size), ("dp", "sp"))

    jout, jpos, jtotal = jax.jit(shard_map(
        step, mesh=mesh, in_specs=(spec,) * 3, out_specs=(spec, P(), P())))(
        *(jax.device_put(a, NamedSharding(mesh, spec)) for a in (q, k, v)))
    res = _run(dp * sp, lambda g: _dp_sp_step(g, q, k, v, dp, sp))
    out = torch.cat([torch.cat([r[0] for r in res[i * sp:(i + 1) * sp]], dim=1)
                     for i in range(dp)], dim=0)
    _close(out, jout, RING_TOL)
    assert all(float(r[2]) == float(jtotal) == q.size for r in res)
    assert all(float(r[1]) == float(res[0][1]) for r in res)
    np.testing.assert_allclose(float(res[0][1]), float(jpos), atol=1.0)


def test_pipeline_composes_with_dp():
    dp, n_stages = 2, 4
    params = _stacked(n_stages, dim=8)
    x = RNG.normal(size=(4, 6, 8)).astype(np.float32)
    got = _port_pipeline(params, x, n_stages, dp=dp)
    ref = tpar.pipeline_reference(_stage_torch, {k: _t(v) for k, v in params.items()}, _t(x))
    _close(got, ref, PIPE_TOL)
    _close(got, _jax_pipeline(params, x, n_stages, dp=dp), PIPE_CROSS_TOL)


def test_moe_composes_with_dp():
    """The all_to_all stays within each dp replica: each replica equals
    the oracle on its own token block."""
    dp, n_experts, cap = 2, 4, 16
    wg, w1, w2 = _moe_params(n_experts)
    x = RNG.normal(size=(dp * n_experts * cap, DIM)).astype(np.float32)
    got = _port_moe(x, wg, w1, w2, n_experts, cap, dp=dp)
    _close(got, _jax_moe(x, wg, w1, w2, n_experts, cap, dp=dp), MOE_TOL)
    half = n_experts * cap
    for r in range(dp):
        want = jpar.moe_reference(x[r * half:(r + 1) * half], wg, w1, w2,
                                  num_shards=n_experts, capacity=cap)
        _close(got[r * half:(r + 1) * half], want, MOE_TOL)


def test_composed_step_adds_no_collectives_beyond_ring_and_sync():
    """The census of the composed dp x sp step: a rank issues the ring's
    P ``ppermute`` calls an attention call (P = 4 here; like the JAX scan
    it also permutes after the last step, one wasted hop, each call moving
    k, v and the kv index together) and, with the metric, the counters'
    psums -- the dp axis adds nothing: the counts equal those of the same
    step on the sp axis alone."""
    q, k, v = _qkv(b=4)

    def counted(dp, sp, metric):
        def rank(g):
            with _axis.census() as c:
                if metric:
                    _dp_sp_step(g, q, k, v, dp, sp)
                else:
                    row = g.rank // sp
                    sub = g.new_subgroup([row * sp + j for j in range(sp)])
                    _ring_blocks(q, k, v, sub, True, slice(row * 4 // dp, (row + 1) * 4 // dp))
            return dict(c)
        return _run(dp * sp, rank)

    base = counted(2, 4, False)
    metric = counted(2, 4, True)
    assert base == [{"ppermute": 4}] * 8
    assert metric == [{"ppermute": 4, "psum": 2}] * 8
    assert counted(1, 4, True) == [{"ppermute": 4, "psum": 2}] * 4


# ------------------------------------------------------------------- _axis


def test_axis_primitives_over_threads():
    def rank(g):
        me = g.rank
        x = torch.full((2, 3), float(me))
        ring = _axis.ppermute(x, g, [(i, (i + 1) % 4) for i in range(4)])
        partial_perm = _axis.ppermute(x, g, [(0, 2), (1, 1)])
        blocks = torch.arange(8.0).reshape(4, 2) + 10 * me
        swapped = _axis.all_to_all(blocks, g)
        total = _axis.psum(x, g)
        return me, ring, partial_perm, swapped, total, partial_perm is x

    for me, ring, partial_perm, swapped, total, aliased in _run(4, rank):
        assert torch.equal(ring, torch.full((2, 3), float((me - 1) % 4)))
        want = {0: 0.0, 1: 1.0, 2: 0.0, 3: 0.0}[me]  # 2 gets 0's block, 1 its own copy
        assert torch.equal(partial_perm, torch.full((2, 3), want)) and not aliased
        assert torch.equal(swapped, torch.tensor([[2.0 * me, 2.0 * me + 1] for _ in range(4)])
                           + 10 * torch.arange(4.0)[:, None])
        assert torch.equal(total, torch.full((2, 3), 6.0))


def test_axis_rejects_bad_calls():
    def rank(g):
        with pytest.raises(ValueError, match="unique"):
            _axis.ppermute(torch.zeros(1), g, [(0, 1), (1, 1)])
        with pytest.raises(ValueError, match="divisible"):
            _axis.all_to_all(torch.zeros(3), g)
        return True

    assert _run(2, rank) == [True, True]
    with pytest.raises(TypeError, match="not a group"):
        _axis.axis_size("sp")


def _gloo_rank(rank, world, out_dir):
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        g = dist.group.WORLD
        x = torch.full((2, 3), float(rank))
        q, k, v = (torch.from_numpy(np.random.default_rng(i).normal(size=(1, 16, 2, 4))
                                    .astype(np.float32)) for i in range(3))
        cut = slice(rank * 4, (rank + 1) * 4)
        with _axis.census() as c:
            res = {
                "size_index": (_axis.axis_size(g), _axis.axis_index(g)),
                "ring": _axis.ppermute((x, x + 100), g, [(i, (i + 1) % world) for i in range(world)]),
                "self": _axis.ppermute(x, g, [(i, i) for i in range(world)]),
                "partial": _axis.ppermute(x, g, [(1, 2)]),
                "a2a": _axis.all_to_all(torch.arange(8.0).reshape(4, 2) + 10 * rank, g),
                "psum": _axis.psum(x, g),
                "attn": tpar.ring_attention(q[:, cut], k[:, cut], v[:, cut], group=g),
                "dense": tpar.dense_reference_attention(q, k, v)[:, cut],
            }
        res["census"] = dict(c)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_axis_over_a_spawned_gloo_world_of_four(tmp_path):
    """``_axis`` over ``torch.distributed``: ``batch_isend_irecv`` rings
    (a tuple moved as one hop), permutes to oneself as copies, a rank no
    pair targets receiving zeros, ``all_to_all_single`` and ``all_reduce``,
    and ring attention over the same group against its dense oracle."""
    world = 4
    chip_smoke._spawn_ranks(_gloo_rank, world, (str(tmp_path),), 180)
    for rank in range(world):
        res = torch.load(tmp_path / f"rank{rank}.pt")
        src = (rank - 1) % world
        assert res["size_index"] == (world, rank)
        assert torch.equal(res["ring"][0], torch.full((2, 3), float(src)))
        assert torch.equal(res["ring"][1], torch.full((2, 3), src + 100.0))
        assert torch.equal(res["self"], torch.full((2, 3), float(rank)))
        assert torch.equal(res["partial"], torch.full((2, 3), 1.0 if rank == 2 else 0.0))
        assert torch.equal(res["a2a"], torch.tensor([[2.0 * rank, 2.0 * rank + 1]] * 4)
                           + 10 * torch.arange(4.0)[:, None])
        assert torch.equal(res["psum"], torch.full((2, 3), 6.0))
        _close(res["attn"], res["dense"], RING_TOL)
        assert res["census"] == {"ppermute": 3 + world, "all_to_all": 1, "psum": 1}
