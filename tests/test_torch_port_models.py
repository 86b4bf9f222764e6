"""``torcheval_tpu_torch.models`` (the transformer LM and the long-context
LM) against ``torcheval_tpu.models``.

``TransformerLM``: the Flax variables loaded through
``from_flax_variables`` give Flax's logits within 1e-5 in float32 (torch's
two-pass ``layer_norm`` against Flax's E[x^2] - E[x]^2 and the backends'
own dot orders) and within 0.1 in bfloat16 (logits of magnitude ~4,
several bf16 ulps); the FQNs equal the Flax paths and ``param_specs``
pins the JAX package's per-leaf specs, the out kernel's heads axis
included. The long-context LM: the JAX parameters through
``from_jax_params``; the port's ring forward over ``ThreadWorld`` ranks
against the JAX ``shard_map`` forward and both dense forwards within 2e-4,
the dp x sp counters against ``Perplexity`` within 1e-4 relative with the
count exact (``tests/parallel/test_long_context.py``'s tolerances).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from jax import shard_map
except ImportError:  # pre-0.4.38 jax keeps it under experimental
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torcheval_tpu.models as jmodels
import torcheval_tpu_torch.models as tmodels
from torcheval_tpu.metrics import Perplexity as JaxPerplexity
from torcheval_tpu_torch.metrics import Perplexity
from torcheval_tpu_torch.models.long_context import from_jax_params
from torcheval_tpu_torch.models.transformer import from_flax_variables
from torcheval_tpu_torch.parallel import _axis
from torcheval_tpu_torch.utils.test_utils import ThreadWorld

RNG = np.random.default_rng(1531)
CPU = "cpu"
LM_TOL = 1e-5
LM_BF16_TOL = 0.1
LONG_TOL = 2e-4
VOCAB, D_MODEL, HEADS, LAYERS, D_FF = 64, 32, 4, 2, 64


def test_exports_match_the_jax_package():
    """The JAX package's names, in its order; the port's models keep the
    InceptionV3 names and its own MLA + MoE LM's after them."""
    assert tmodels.__all__[: len(jmodels.__all__)] == jmodels.__all__
    assert set(tmodels.__all__[len(jmodels.__all__):]) == {
        "FEATURE_DIM", "InceptionV3", "from_flax_variables", "init_inception_params",
        "load_torchvision_inception_params", "MLAMoEConfig", "MLAMoELM",
    }


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.TransformerLM()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.init_long_context_lm(torch.Generator(), vocab_size=8, d_model=4, n_heads=2,
                                     n_layers=1, d_ff=8, max_len=8)


# ------------------------------------------------------------ TransformerLM


def _flax_lm():
    model = jmodels.TransformerLM()
    return model, jmodels.init_params(model)


def _numpy_tree(variables):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), variables)


def test_fqns_are_the_flax_paths():
    _, variables = _flax_lm()
    model = tmodels.TransformerLM(device=CPU)
    want = set(from_flax_variables(_numpy_tree(variables)))
    assert set(model.state_dict()) == want
    for fqn, t in model.state_dict().items():
        node = variables["params"]
        for key in fqn.split("."):
            node = node[key]
        assert tuple(t.shape) == node.shape, fqn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_matches_flax_apply(dtype):
    flax_model, variables = _flax_lm()
    tokens = RNG.integers(0, 256, (2, 16))
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    want = flax_model.apply(jax.tree.map(lambda a: a.astype(jdtype), variables),
                            jnp.asarray(tokens))
    model = tmodels.TransformerLM(device=CPU, dtype=tdtype)
    model.load_state_dict({k: v.to(tdtype) for k, v in from_flax_variables(
        _numpy_tree(variables)).items()})
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == tdtype
    tol = LM_TOL if dtype == "float32" else LM_BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_param_specs_pin_the_jax_package():
    """The same per-axis tuple as the JAX ``PartitionSpec`` for every
    leaf; query/key/value shard head_dim (axis 2) while the out kernel
    shards heads (axis 0) -- a reference-side inconsistency, pinned."""
    _, variables = _flax_lm()
    jax_specs = jmodels.param_specs(variables)["params"]
    got = tmodels.param_specs(tmodels.TransformerLM(device=CPU))
    assert set(got) == set(from_flax_variables(_numpy_tree(variables)))
    for fqn, spec in got.items():
        node = jax_specs
        for key in fqn.split("."):
            node = node[key]
        assert spec == tuple(node), fqn
    assert got["Block_0.SelfAttention_0.query.kernel"] == (None, None, "tp")
    assert got["Block_0.SelfAttention_0.out.kernel"] == ("tp", None)
    assert tmodels.param_specs(tmodels.TransformerLM(device=CPU).state_dict()) == got


def test_init_params_follows_the_flax_laws():
    """Shapes as Flax's; stds within 3 % of Flax's laws (and of the JAX
    package's draw) at a width where the sample std is that tight; kernels
    cut at two standard deviations of the underlying normal."""
    model = tmodels.TransformerLM(vocab_size=512, d_model=256, n_heads=4, n_layers=1,
                                  d_ff=512, max_len=256, device=CPU)
    state = tmodels.init_params(model, torch.Generator().manual_seed(0))
    flax_model = jmodels.TransformerLM(vocab_size=512, d_model=256, n_heads=4, n_layers=1,
                                       d_ff=512, max_len=256)
    jax_state = from_flax_variables(_numpy_tree(jmodels.init_params(flax_model)))
    laws = {"Embed_0.embedding": 256, "Embed_1.embedding": 256,
            "Block_0.SelfAttention_0.query.kernel": 256, "Block_0.SelfAttention_0.out.kernel": 256,
            "Block_0.Dense_0.kernel": 256, "Block_0.Dense_1.kernel": 512, "Dense_0.kernel": 256}
    for fqn, fan in laws.items():
        std = float(state[fqn].std())
        assert abs(std / fan ** -0.5 - 1) < 0.03, fqn
        assert abs(std / float(jax_state[fqn].std()) - 1) < 0.03, fqn
        if "kernel" in fqn:
            assert float(state[fqn].abs().max()) <= 2 * fan ** -0.5 / 0.87962566103423978 + 1e-6
    assert torch.equal(state["LayerNorm_0.scale"], torch.ones(256))
    again = tmodels.init_params(model, torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], state[k]) for k in state)


# --------------------------------------------------------- long-context LM


def _long_params(max_len):
    return jmodels.init_long_context_lm(
        jax.random.PRNGKey(0), vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
        n_layers=LAYERS, d_ff=D_FF, max_len=max_len)


def _port_params(jax_params):
    return from_jax_params(jax.tree.map(np.asarray, jax_params), device=CPU)


def _ring_forward(params, tokens, sp, dp=1):
    """Each rank of a dp x sp ``ThreadWorld``: its rows, its sequence
    block, the ring on its sp row. Returns the logits laid out as the
    full (B, L, V)."""
    seq, rows = tokens.shape[1] // sp, tokens.shape[0] // dp

    def rank(g):
        row = g.rank // sp
        sub = g.new_subgroup([row * sp + j for j in range(sp)])
        block = tokens[row * rows:(row + 1) * rows, sub.rank * seq:(sub.rank + 1) * seq]
        return tmodels.long_context_lm(params, torch.from_numpy(block), group=sub)

    outs = ThreadWorld(dp * sp, timeout=60).run(rank)
    return torch.cat([torch.cat(outs[r * sp:(r + 1) * sp], dim=1) for r in range(dp)])


@pytest.mark.parametrize("sp", [2, 8])
def test_sequence_sharded_forward_matches_jax(sp):
    seq = 8 * sp
    jparams = _long_params(seq)
    tokens = RNG.integers(0, VOCAB, size=(2, seq))
    jax_sharded = jax.jit(shard_map(
        partial(jmodels.long_context_lm, axis_name="sp"),
        mesh=Mesh(np.array(jax.devices("cpu")[:sp]), ("sp",)),
        in_specs=(P(), P(None, "sp")), out_specs=P(None, "sp", None),
    ))(jparams, jnp.asarray(tokens))
    jax_dense = jmodels.long_context_lm(jparams, jnp.asarray(tokens))
    params = _port_params(jparams)
    got = _ring_forward(params, tokens, sp)
    dense = tmodels.long_context_lm(params, torch.from_numpy(tokens))
    for a, b in ((got, jax_sharded), (got, jax_dense), (dense, jax_dense), (got, dense)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=LONG_TOL, rtol=LONG_TOL)


def test_dp_sp_eval_step_counters_match_perplexity():
    """The composed eval step -- batch over dp, sequence over sp, the
    counters psum-ed over the world -- reproduces ``Perplexity`` on the
    dense logits (the port's and the JAX package's), the count exactly."""
    dp, sp = 2, 4
    seq = 8 * sp
    jparams = _long_params(seq)
    params = _port_params(jparams)
    tokens = RNG.integers(0, VOCAB, size=(2 * dp, seq))
    targets = RNG.integers(0, VOCAB, size=(2 * dp, seq))
    rows, blk = 2, seq // sp

    def rank(g):
        row, col = g.rank // sp, g.rank % sp
        sub = g.new_subgroup([row * sp + j for j in range(sp)])
        cut = (slice(row * rows, (row + 1) * rows), slice(col * blk, (col + 1) * blk))
        logits = tmodels.long_context_lm(params, torch.from_numpy(tokens[cut]), group=sub)
        counters = tmodels.perplexity_counters(logits, torch.from_numpy(targets[cut]))
        return {k: _axis.psum(c, g) for k, c in counters.items()}

    counters = ThreadWorld(dp * sp, timeout=60).run(rank)
    dense = tmodels.long_context_lm(params, torch.from_numpy(tokens))
    metric = Perplexity(device=CPU)
    metric.update(dense, torch.from_numpy(targets))
    jax_metric = JaxPerplexity()
    jax_metric.update(jmodels.long_context_lm(jparams, jnp.asarray(tokens)), jnp.asarray(targets))
    for c in counters:
        got = float(torch.exp(c["sum_log_probs"] / c["num_total"]))
        assert got == pytest.approx(float(metric.compute()), rel=1e-4)
        assert got == pytest.approx(float(jax_metric.compute()), rel=1e-4)
        assert float(c["num_total"]) == targets.size


def test_positions_are_global_under_sharding():
    """Block 1 of 2 must see positions 8..15, not 0..7: position
    embeddings scaled up so an offset error would dwarf the rest."""
    seq, sp = 16, 2
    jparams = _long_params(seq)
    jparams["pos_embed"] = jparams["pos_embed"] * 100.0
    tokens = RNG.integers(0, VOCAB, size=(1, seq))
    got = _ring_forward(_port_params(jparams), tokens, sp)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jmodels.long_context_lm(jparams, jnp.asarray(tokens))),
        atol=2e-3, rtol=2e-3)


def test_init_long_context_lm_shapes_and_scales():
    """The JAX package's shapes (``wqkv`` as ``(d, 3, H, hd)``) and its
    He/embedding scales; the same generator seed gives the same draw."""
    kw = dict(vocab_size=512, d_model=128, n_heads=4, n_layers=2, d_ff=256, max_len=64)
    params = tmodels.init_long_context_lm(torch.Generator().manual_seed(1), device=CPU, **kw)
    jparams = jmodels.init_long_context_lm(jax.random.PRNGKey(1), **kw)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert jax.tree.map(lambda a: tuple(a.shape), params,
                        is_leaf=lambda a: isinstance(a, torch.Tensor)) == shapes
    for key, fan in (("tok_embed", 128 ** 0.5), ("head", 128)):
        assert abs(float(params[key].std()) * fan ** 0.5 - 1) < 0.05
    assert abs(float(params["layers"][0]["w_down"].std()) * 256 ** 0.5 - 1) < 0.05
    again = tmodels.init_long_context_lm(torch.Generator().manual_seed(1), device=CPU, **kw)
    assert torch.equal(again["head"], params["head"])
