"""Gradients through ``torcheval_tpu_torch.parallel``: each collective's
backward against the inverse collective, and the JAX package's three
gradient tests (``tests/parallel/test_ring_attention.py``,
``test_moe.py``, ``test_pipeline.py``, ``*_grads_flow``) at their sizes and
tolerances.

The port's gradients are held against ``jax.grad`` of the JAX functions
under ``shard_map`` on the conftest's 8 virtual CPU devices (the same numpy
inputs) and against ``torch.autograd`` of the port's dense oracles. Every
rank thread calls ``parallel.backward`` on its own loss. The convention
(``parallel/_axis.py``): the loss is the sum of every rank's loss, so a
sharded output's loss is taken as is on every rank, a replicated output's
(GPipe's) is divided by the axis size on every rank, and the gradient of
an input every rank holds whole (MoE's ``wg``, GPipe's ``x``) is summed
over the ranks before it is compared.
"""

from __future__ import annotations

import gc
import os
import weakref
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

try:
    from jax import shard_map
except ImportError:  # pre-0.4.38 jax keeps it under experimental
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import chip_smoke
import torcheval_tpu.parallel as jpar
import torcheval_tpu_torch.parallel as tpar
from torcheval_tpu_torch.models import init_long_context_lm, long_context_lm
from torcheval_tpu_torch.parallel import _axis
from torcheval_tpu_torch.utils.test_utils import ThreadWorld

RNG = np.random.default_rng(1716)
RING_TOL = 2e-4  # tests/parallel/test_ring_attention.py::test_ring_attention_grads_flow
MOE_TOL = 1e-4  # tests/parallel/test_moe.py::test_moe_grads_flow
PIPE_TOL = 1e-5  # tests/parallel/test_pipeline.py::test_pipeline_grads_flow
LONG_TOL = 2e-4


def _run(world, fn):
    return ThreadWorld(world, timeout=60).run(fn)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _mesh(n, name):
    return Mesh(np.array(jax.devices("cpu")[:n]), (name,))


# ------------------------------------------- each backward, by hand


def _weights(rank, shape):
    """A rank's loss weights: the cotangent of what it holds."""
    return torch.full(shape, float(rank + 1)) + torch.arange(float(np.prod(shape))).reshape(shape)


PERMS = {
    "ring": [(i, (i + 1) % 4) for i in range(4)],
    "partial": [(0, 2), (1, 1), (3, 0)],  # rank 1 to itself; rank 2 sends nowhere; 1 and 3 get zeros
    "swap": [(0, 1), (1, 0), (2, 3), (3, 2)],
}


def _permute_case(g, perm):
    """``ppermute`` of a float pair and an int item; loss sum(w * out)."""
    me = _axis.axis_index(g)
    x = torch.full((2, 3), float(me), requires_grad=True)
    y = torch.full((3,), 10.0 + me, requires_grad=True)
    idx = torch.tensor(me)
    with _axis.census() as calls:
        ox, oy, oi = _axis.ppermute((x, y * 2, idx), g, perm)
        assert not oi.requires_grad and oi.dtype == torch.int64
        loss = (_weights(me, (2, 3)) * ox).sum() + (_weights(me, (3,)) * oy).sum()
        _axis.backward(loss)
    return x.grad, y.grad, dict(calls)


def _expected_permute(rank, perm):
    """The gradient of rank ``rank``'s inputs: the weights of the rank it
    sent to, or zeros with no destination."""
    dst = dict(perm).get(rank)
    if dst is None:
        return torch.zeros(2, 3), torch.zeros(3)
    return _weights(dst, (2, 3)), 2 * _weights(dst, (3,))


@pytest.mark.parametrize("name", sorted(PERMS))
def test_ppermute_backward_is_the_reversed_permute(name):
    perm = PERMS[name]
    res = _run(4, lambda g: _permute_case(g, perm))
    for rank, (gx, gy, calls) in enumerate(res):
        ex, ey = _expected_permute(rank, perm)
        assert torch.equal(gx if gx is not None else torch.zeros(2, 3), ex)
        assert torch.equal(gy if gy is not None else torch.zeros(3), ey)
        assert calls == {"ppermute": 1, "backward_plan": 1, "ppermute_bwd": 1}


def _a2a_psum_case(g):
    me = _axis.axis_index(g)
    x = (torch.arange(8.0).reshape(4, 2) + 10 * me).requires_grad_(True)
    z = torch.full((2,), float(me), requires_grad=True)
    with _axis.census() as calls:
        out = _axis.all_to_all(x, g)
        total = _axis.psum(z, g)
        loss = (_weights(me, (4, 2)) * out).sum() + (_weights(me, (2,)) * total).sum()
        _axis.backward(loss)
    return x.grad, z.grad, dict(calls)


def test_all_to_all_and_psum_backward_are_themselves():
    res = _run(4, _a2a_psum_case)
    for rank, (gx, gz, calls) in enumerate(res):
        # block j of x went to rank j, landing as its block `rank`
        want = torch.cat([_weights(j, (4, 2))[rank:rank + 1] for j in range(4)])
        assert torch.equal(gx, want)
        assert torch.equal(gz, sum(_weights(r, (2,)) for r in range(4)))
        assert calls == {"all_to_all": 1, "psum": 1, "backward_plan": 1, "all_to_all_bwd": 1,
                         "psum_bwd": 1}


def test_no_grad_needed_records_nothing_and_hands_tensors_over():
    """Inputs that need no gradient, or ``torch.no_grad``: no tape, plain
    tensors out, bitwise the forward of before."""
    def rank(g):
        x = torch.full((3,), float(g.rank))
        out = _axis.ppermute(x, g, PERMS["ring"])
        with torch.no_grad():
            w = torch.ones(3, requires_grad=True)
            s = _axis.psum(w * g.rank, g)
        return out, s, len(_axis._tape().entries)

    for r, (out, s, entries) in enumerate(_run(4, rank)):
        assert not out.requires_grad and torch.equal(out, torch.full((3,), float((r - 1) % 4)))
        assert not s.requires_grad and torch.equal(s, torch.full((3,), 6.0))
        assert entries == 0


def test_one_rank_needing_a_gradient_records_on_every_rank():
    def rank(g):
        x = torch.full((2,), float(g.rank), requires_grad=g.rank == 2)
        out = _axis.psum(x, g)
        _axis.backward((out * (g.rank + 1)).sum())
        return x.grad, out.requires_grad

    res = _run(4, rank)
    assert all(req for _, req in res)
    assert torch.equal(res[2][0], torch.full((2,), 10.0))
    assert all(gx is None for r, (gx, _) in enumerate(res) if r != 2)


def _stale_then_step(g):
    """A forward under grad mode that no backward follows (an evaluation
    pass that forgot ``torch.no_grad()``), then a training step."""
    me, size = _axis.axis_index(g), _axis.axis_size(g)
    w = torch.full((3,), 2.0, requires_grad=True)
    x = torch.full((3,), float(me))
    with _axis.census() as calls:
        sent = x * w
        held = weakref.ref(sent)
        seen = _axis.ppermute(sent, g, [(i, (i + 1) % size) for i in range(size)]).sum().item()
        del sent
        kept = held() is not None and len(_axis._tape().entries) == 1
        out = _axis.psum(x * w, g)
        _axis.backward((out * (me + 1)).sum())
    gc.collect()
    return w.grad, seen, kept, held() is None, len(_axis._tape().entries), dict(calls)


def _check_stale_then_step(rank, size, res):
    """The step's backward drops the evaluation's entry, graph and all,
    and moves nothing for it: the gradient is the step's alone."""
    grad, seen, kept, freed, entries, calls = res
    assert seen == 6.0 * ((rank - 1) % size)
    assert kept and freed and entries == 0
    assert torch.equal(grad, torch.full((3,), rank * size * (size + 1) / 2))
    assert calls == {"ppermute": 1, "psum": 1, "backward_plan": 1, "psum_bwd": 1}


def test_a_forward_no_backward_follows_is_dropped_at_the_next_backward():
    for rank, res in enumerate(_run(4, _stale_then_step)):
        _check_stale_then_step(rank, 4, res)


def test_a_value_relayed_unread_keeps_both_hops():
    """Rank 1 passes on what rank 0 sent without reading it, and only rank
    2's loss reads it: the first hop runs back because the second does."""
    def rank(g):
        x = torch.full((2,), float(g.rank + 1), requires_grad=True)
        with _axis.census() as calls:
            relayed = _axis.ppermute(_axis.ppermute(x, g, [(0, 1)]), g, [(1, 2)])
            _axis.backward((relayed * 3.0).sum())
        return x.grad, dict(calls)

    res = _run(3, rank)
    assert torch.equal(res[0][0], torch.full((2,), 3.0))
    assert res[1][0] is None and res[2][0] is None
    assert all(c == {"ppermute": 2, "backward_plan": 1, "ppermute_bwd": 2} for _, c in res)


def test_loss_backward_through_a_collective_raises():
    def rank(g):
        x = torch.ones(3, requires_grad=True)
        out = _axis.psum(x, g)
        with pytest.raises(RuntimeError, match="parallel.backward"):
            out.sum().backward()
        _axis.backward(out.sum())  # the lockstep backward still runs
        return x.grad

    assert all(torch.equal(gx, torch.full((3,), 2.0)) for gx in _run(2, rank))


def _mismatch_case(g):
    """On a ``torch.distributed`` group a rank records a call when one of
    its own float items requires grad: ranks that differ there recorded
    different calls, and ``backward`` raises on every one of them."""
    x = torch.ones(2, requires_grad=_axis.axis_index(g) == 0)
    y = torch.ones(2, requires_grad=True)
    total = _axis.psum(x, g) + _axis.psum(y, g)
    try:
        _axis.backward(total.sum())
    except RuntimeError as e:
        return str(e), len(_axis._tape().entries)
    return None, len(_axis._tape().entries)


def _gloo_grad_rank(rank, world, out_dir):
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        g = dist.group.WORLD
        res = {name: _permute_case(g, perm) for name, perm in PERMS.items()}
        res["a2a_psum"] = _a2a_psum_case(g)
        res["stale"] = _stale_then_step(g)
        res["mismatch"] = _mismatch_case(g)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_backward_over_a_spawned_gloo_world_of_four(tmp_path):
    """The same cases over ``torch.distributed`` (``batch_isend_irecv``
    with pairs reversed, ``all_to_all_single``, ``all_reduce``), and ranks
    that recorded different calls."""
    world = 4
    chip_smoke._spawn_ranks(_gloo_grad_rank, world, (str(tmp_path),), 180)
    for rank in range(world):
        res = torch.load(tmp_path / f"rank{rank}.pt")
        for name, perm in PERMS.items():
            gx, gy, calls = res[name]
            ex, ey = _expected_permute(rank, perm)
            assert torch.equal(gx if gx is not None else torch.zeros(2, 3), ex)
            assert torch.equal(gy if gy is not None else torch.zeros(3), ey)
            assert calls == {"ppermute": 1, "backward_plan": 1, "ppermute_bwd": 1}
        gx, gz, calls = res["a2a_psum"]
        assert torch.equal(gx, torch.cat([_weights(j, (4, 2))[rank:rank + 1] for j in range(4)]))
        assert torch.equal(gz, sum(_weights(r, (2,)) for r in range(4)))
        _check_stale_then_step(rank, world, res["stale"])
        message, entries = res["mismatch"]
        assert "recorded different calls" in message and entries == 0


# ------------------------------------- the JAX package's gradient tests


RB, RS, RH, RD = 2, 32, 4, 8  # test_ring_attention.py's B, S, H, D


def test_ring_attention_grads_match_jax_and_dense():
    """``test_ring_attention_grads_flow`` at its size over 4 shards, with
    ``argnums=(0, 1, 2)``: dk and dv come back through the reversed
    permutes."""
    q, k, v = (RNG.normal(size=(RB, RS, RH, RD)).astype(np.float32) for _ in range(3))
    spec = P(None, "sp", None, None)
    ring = shard_map(partial(jpar.ring_attention, axis_name="sp", causal=True),
                     mesh=_mesh(4, "sp"), in_specs=(spec,) * 3, out_specs=spec)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) ** 2), argnums=(0, 1, 2)))(
        q, k, v)
    blk = RS // 4

    def rank(g):
        cut = slice(g.rank * blk, (g.rank + 1) * blk)
        leaves = [_leaf(a[:, cut]) for a in (q, k, v)]
        with _axis.census() as calls:
            out = tpar.ring_attention(*leaves, group=g, causal=True)
            tpar.backward(torch.sum(out ** 2))
        return [t.grad for t in leaves], dict(calls)

    res = _run(4, rank)
    dense = [_leaf(a) for a in (q, k, v)]
    torch.sum(tpar.dense_reference_attention(*dense) ** 2).backward()
    for i in range(3):
        got = torch.cat([grads[i] for grads, _ in res], dim=1)
        assert np.isfinite(got.numpy()).all()
        _close(got, want[i], RING_TOL)
        _close(got, dense[i].grad, RING_TOL)
    # the fourth hop is wasted: nothing reads what it brings, so it moves nothing back
    assert all(calls == {"ppermute": 4, "backward_plan": 1, "ppermute_bwd": 3} for _, calls in res)


MOE_DIM, MOE_HID = 8, 32  # test_moe.py's DIM, HID


@pytest.mark.parametrize("capacity_frac", [1.0, 0.25])
def test_moe_grads_match_jax_and_dense(capacity_frac):
    """``test_moe_grads_flow`` at its size: at 0.25 every dropped token
    collides at the spill slot and must get exactly zero cotangent."""
    n_experts, tokens = 4, 8
    capacity = max(1, int(tokens * capacity_frac))
    wg = RNG.normal(size=(MOE_DIM, n_experts)).astype(np.float32)
    w1 = (RNG.normal(size=(n_experts, MOE_DIM, MOE_HID)) * 0.3).astype(np.float32)
    w2 = (RNG.normal(size=(n_experts, MOE_HID, MOE_DIM)) * 0.3).astype(np.float32)
    x = RNG.normal(size=(n_experts * tokens, MOE_DIM)).astype(np.float32)
    run = shard_map(
        lambda x, wg, w1, w2: jpar.moe_apply(x, wg, w1[0], w2[0], axis_name="ep",
                                             capacity=capacity),
        mesh=_mesh(n_experts, "ep"), in_specs=(P("ep"), P(), P("ep"), P("ep")),
        out_specs=P("ep"))
    want = jax.jit(jax.grad(lambda *a: jnp.sum(run(*a) ** 2), argnums=(0, 1, 2, 3)))(
        x, wg, w1, w2)

    def rank(g):
        mine = [_leaf(x[g.rank * tokens:(g.rank + 1) * tokens]), _leaf(wg), _leaf(w1[g.rank]),
                _leaf(w2[g.rank])]
        y = tpar.moe_apply(*mine, group=g, capacity=capacity)
        tpar.backward(torch.sum(y ** 2))
        return [t.grad for t in mine]

    res = _run(n_experts, rank)
    got = [torch.cat([r[0] for r in res]), sum(r[1] for r in res),
           torch.stack([r[2] for r in res]), torch.stack([r[3] for r in res])]
    dense = [_leaf(a) for a in (x, wg, w1, w2)]
    torch.sum(tpar.moe_reference(*dense, num_shards=n_experts, capacity=capacity) ** 2).backward()
    for i in range(4):
        _close(got[i], want[i], MOE_TOL)
        _close(got[i], dense[i].grad, MOE_TOL)
    keep = torch.cat([chip_smoke._moe_route(torch.from_numpy(s), torch.from_numpy(wg))[2]
                      < capacity for s in np.split(x, n_experts)])
    if capacity_frac < 1:
        assert (~keep).any()
    assert torch.equal(got[0][~keep], torch.zeros_like(got[0][~keep]))


PIPE_MB, PIPE_DIM = 4, 16  # test_pipeline.py's MB, DIM


def test_pipeline_grads_match_jax_and_dense():
    """``test_pipeline_grads_flow`` at its size (4 stages, 6
    microbatches). The output is replicated, so each rank's loss is
    divided by the axis size; ``x``'s gradient is summed over the ranks."""
    n_stages, n_micro = 4, 6
    params = {"w": (RNG.normal(size=(n_stages, PIPE_DIM, PIPE_DIM)) * 0.5).astype(np.float32),
              "b": (RNG.normal(size=(n_stages, PIPE_DIM)) * 0.1).astype(np.float32)}
    x = RNG.normal(size=(n_micro, PIPE_MB, PIPE_DIM)).astype(np.float32)

    def jax_stage(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    run = shard_map(
        lambda stacked, x: jpar.pipeline_apply(
            jax_stage, jax.tree_util.tree_map(lambda a: a[0], stacked), x, axis_name="pp"),
        mesh=_mesh(n_stages, "pp"), in_specs=(P("pp"), P()), out_specs=P())
    want_p, want_x = jax.jit(jax.grad(lambda p, x: jnp.sum(run(p, x) ** 2), argnums=(0, 1)))(
        params, x)

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def rank(g):
        mine = {k: _leaf(v[g.rank]) for k, v in params.items()}
        xs = _leaf(x)
        with _axis.census() as calls:
            y = tpar.pipeline_apply(stage, mine, xs, group=g)
            tpar.backward(torch.sum(y ** 2) / n_stages)
        return {k: t.grad for k, t in mine.items()}, xs.grad, dict(calls)

    res = _run(n_stages, rank)
    dense = {k: _leaf(v) for k, v in params.items()}
    dense_x = _leaf(x)
    torch.sum(tpar.pipeline_reference(stage, dense, dense_x) ** 2).backward()
    for k in params:
        got = torch.stack([r[0][k] for r in res])
        _close(got, want_p[k], PIPE_TOL)
        _close(got, dense[k].grad, PIPE_TOL)
    got_x = sum(r[1] for r in res if r[1] is not None)
    _close(got_x, want_x, PIPE_TOL)
    _close(got_x, dense_x.grad, PIPE_TOL)
    ticks = n_micro + n_stages - 1
    # nothing reads the last tick's hop
    assert all(c == {"ppermute": ticks, "psum": 1, "backward_plan": 1,
                     "ppermute_bwd": ticks - 1, "psum_bwd": 1} for _, _, c in res)


def test_long_context_lm_gradient_matches_the_dense_model():
    """``long_context_lm`` over sp 4 ring ranks, each rank's loss on its
    own logits block: every parameter's gradient summed over the ranks
    equals the dense model's gradient of the whole window's loss."""
    sp, seq, vocab = 4, 32, 64
    gen = torch.Generator().manual_seed(3)
    params = init_long_context_lm(gen, vocab_size=vocab, d_model=32, n_heads=4, n_layers=2,
                                  d_ff=64, max_len=seq, device="cpu")
    tokens = torch.randint(0, vocab, (2, seq), generator=gen)
    weights = torch.randn((2, seq, vocab), generator=gen)
    blk = seq // sp
    flat, spec = torch.utils._pytree.tree_flatten(params)

    def leaves():
        return [t.detach().clone().requires_grad_(True) for t in flat]

    def rank(g):
        mine = leaves()
        cut = slice(g.rank * blk, (g.rank + 1) * blk)
        logits = long_context_lm(torch.utils._pytree.tree_unflatten(mine, spec), tokens[:, cut],
                                 group=g)
        tpar.backward(torch.sum(logits * weights[:, cut]))
        return [t.grad for t in mine]

    res = _run(sp, rank)
    dense = leaves()
    torch.sum(long_context_lm(torch.utils._pytree.tree_unflatten(dense, spec), tokens)
              * weights).backward()
    for i, want in enumerate(dense):
        _close(sum(r[i] for r in res), want.grad, LONG_TOL)
