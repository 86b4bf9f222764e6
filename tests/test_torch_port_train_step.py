"""``torcheval_tpu_torch.examples.train_step`` against the JAX package's
dp x tp training step (``__graft_entry__.dryrun_multichip``'s training and
sync legs).

The JAX ``train_step`` -- ``_loss_and_metrics`` under ``value_and_grad``,
``optax.adam(1e-3)`` -- runs unsharded on one CPU device from
``init_params``; the port loads the same weights through
``models.transformer.from_flax_variables`` and takes the same step on the
same numpy batch, first with ordinary tensors, then as the DTensor step
over a spawned gloo world of 4 (dp 2 x tp 2, ``n_heads = max(4, tp)``,
d_model 64, 2 layers, vocabulary 128, sequence 16). ``num_correct`` and
``num_total`` must be exact; the loss and ``sum_log_probs`` within
``LOSS_RTOL`` (two backends' float32 log-softmax); every parameter after
one Adam step within ``PARAM_ATOL`` (Adam's first step moves a weight by
lr * g / (|g| + eps), so a gradient component whose two float32 sums
differ near zero can move its weight differently: the bound is 1% of the
step)."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from __graft_entry__ import _loss_and_metrics
from torcheval_tpu.models import TransformerLM as JaxLM
from torcheval_tpu.models import init_params as jax_init_params
from torcheval_tpu.models import param_specs as jax_param_specs
from torcheval_tpu_torch.examples import train_step as ts
from torcheval_tpu_torch.models import TransformerLM, param_specs
from torcheval_tpu_torch.models.transformer import from_flax_variables

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5  # 1% of Adam's first step (lr 1e-3)
DP, TP = 2, 2


def _jax_step(dp, tp, seed=5):
    """The dry run's model and one step of its ``train_step`` on a seeded
    batch of ``2 dp`` sequences, unsharded on one CPU device."""
    model = JaxLM(vocab_size=ts.VOCAB, d_model=ts.D_MODEL, n_heads=max(4, tp),
                  n_layers=ts.N_LAYERS)
    params = jax_init_params(model, batch=dp, seq=ts.SEQ)
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, ts.VOCAB, size=(2 * dp, ts.SEQ + 1)).astype(np.int32)
    tokens, targets = seqs[:, :-1], seqs[:, 1:]
    opt = optax.adam(ts.LR)

    @jax.jit
    def train_step(params, opt_state, tokens, targets):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: _loss_and_metrics(model, p, tokens, targets), has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), loss, metrics

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        new, loss, metrics = train_step(params, opt.init(params), jnp.asarray(tokens),
                                        jnp.asarray(targets))
    return {
        "state": from_flax_variables(jax.tree.map(np.asarray, params)),
        "new": from_flax_variables(jax.tree.map(np.asarray, new)),
        "loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
        "tokens": torch.from_numpy(tokens.astype(np.int64)),
        "targets": torch.from_numpy(targets.astype(np.int64)),
        "specs": jax_param_specs(params),
    }


@pytest.fixture(scope="module")
def jax_step():
    return _jax_step(DP, TP)


def _check_against_jax(ref, loss, counters, params):
    assert abs(loss - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    assert counters["num_correct"] == ref["metrics"]["num_correct"]
    assert counters["num_total"] == ref["metrics"]["num_total"] == ref["tokens"].numel()
    assert abs(counters["sum_log_probs"] - ref["metrics"]["sum_log_probs"]) <= (
        LOSS_RTOL * abs(ref["metrics"]["sum_log_probs"]))
    assert set(params) == set(ref["new"])
    for fqn, want in ref["new"].items():
        moved = (want - ref["state"][fqn]).abs().max()
        err = (params[fqn] - want).abs().max()
        assert err <= PARAM_ATOL, f"{fqn}: {err} (moved {moved})"


def test_unsharded_step_matches_the_jax_train_step(jax_step):
    model = TransformerLM(**ts.widths_for(TP), device="cpu")
    model.load_state_dict(jax_step["state"])
    opt = torch.optim.Adam(model.parameters(), lr=ts.LR)
    loss, counters = ts.train_step(model, opt, jax_step["tokens"], jax_step["targets"])
    _check_against_jax(jax_step, float(loss), {k: float(v) for k, v in counters.items()},
                       model.state_dict())
    # the step did move the weights: by about lr each, not by nothing
    moved = (model.Block_0.Dense_0.kernel.detach() - jax_step["state"]["Block_0.Dense_0.kernel"]).abs()
    assert 0.5 * ts.LR < float(moved.max()) <= 1.01 * ts.LR


def test_placements_follow_param_specs():
    """Every parameter's tp placement is ``Shard`` of the axis ``"tp"``
    marks in ``param_specs`` (the JAX package's, head_dim for the query,
    key and value kernels, heads for the out kernel), else replicated;
    every dp placement is replicated."""
    from torch.distributed.tensor import Replicate, Shard

    model = TransformerLM(**ts.widths_for(TP), device="meta")
    specs = param_specs(model)
    assert specs["Block_0.SelfAttention_0.query.kernel"] == (None, None, "tp")
    assert specs["Block_0.SelfAttention_0.out.kernel"] == ("tp", None)
    for fqn, spec in specs.items():
        want = (Replicate(), Shard(spec.index("tp")) if "tp" in spec else Replicate())
        assert ts.placements(spec) == want


def _dtensor_rank(rank, world, out_dir, state, tokens, targets):
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        torch.save(ts.run_rank(DP, TP, "cpu", state, tokens, targets),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_dtensor_step_over_gloo_dp2_tp2_matches_the_jax_train_step(jax_step, tmp_path):
    """The DTensor step over a spawned gloo world of 4: every rank's loss,
    counters and whole updated parameters match the JAX step, the
    placements read back are ``param_specs``'s, and the sync leg is exact."""
    world = DP * TP
    chip_smoke._spawn_ranks(_dtensor_rank, world, (str(tmp_path), jax_step["state"],
                                                   jax_step["tokens"], jax_step["targets"]), 240)
    model = TransformerLM(**ts.widths_for(TP), device="meta")
    specs = param_specs(model)
    for rank in range(world):
        res = torch.load(tmp_path / f"rank{rank}.pt")
        _check_against_jax(jax_step, res["losses"][0], res["counters"][0], res["params"])
        for fqn, spec in specs.items():
            assert res["placements"][fqn] == tuple(str(p) for p in ts.placements(spec))
        assert res["synced"] == {"num_total": float(DP), "num_correct": DP * (DP - 1) / 2}


def test_specs_are_the_jax_packages(jax_step):
    """``param_specs`` on the port's model names the same leaves with the
    same per-axis tuples as the JAX package's on the Flax tree."""
    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield ".".join(prefix + (k,)), tuple(v)

    jax_specs = dict(flat(jax_step["specs"]["params"]))
    model = TransformerLM(**ts.widths_for(TP), device="meta")
    assert param_specs(model) == jax_specs


def test_main_runs_two_steps_over_gloo(capsys):
    out = ts.main(["--device", "cpu", "--dp", "2", "--tp", "2", "--steps", "2"])
    printed = capsys.readouterr().out
    assert "train step done" in printed
    first = out["results"][0]
    assert first["losses"][1] < first["losses"][0]
    assert first["counters"][0]["num_total"] == 2 * DP * ts.SEQ
    assert all(r["losses"] == first["losses"] for r in out["results"])


def test_main_on_the_card_refuses_a_wider_mesh(capsys):
    """One card holds a 1 x 1 mesh: ``--dp``/``--tp`` other than 1 are
    refused before anything touches the card."""
    with pytest.raises(SystemExit):
        ts.main(["--device", "cuda", "--dp", "2"])
    assert "--dp and --tp must be 1" in capsys.readouterr().err
