"""``torcheval_tpu_torch.tools`` against ``torcheval_tpu.tools``.

The ten cases of ``tests/tools/test_tools.py`` on torch modules (an MLP of
two ``nn.Linear``, a conv net), with their bounds. Beside them, on the
2-layer ``TransformerLM`` of both packages with the same weights: the
port's count is the analytic matmul count 5,505,024, which sits 3.5 %
under XLA's 5,706,944 (XLA also counts elementwise work), so the port is
held to JAX within 4 % below at the root and exactly on every matmul-only
module; the summary trees agree key for key (names, types, parameter
counts, activation sizes). Every count runs on fake tensors.
"""

from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import torcheval_tpu.models as jmodels
import torcheval_tpu.tools as jtools
import torcheval_tpu_torch.tools as ttools
from torcheval_tpu_torch.models import TransformerLM
from torcheval_tpu_torch.models.transformer import from_flax_variables
from torcheval_tpu_torch.tools import (
    FlopCounter,
    ModuleSummary,
    count_flops,
    count_flops_backward,
    get_module_summary,
    get_summary_table,
    prune_module_summary,
)

LM_MATMUL_FLOPS = 5_505_024  # (2, 16) tokens through the 2-layer default model
JAX_VS_PORT_TOL = 0.04  # XLA's count adds elementwise work: 3.5 % here


class MLP(nn.Module):
    def __init__(self, hidden=32, out=4):
        super().__init__()
        self.fc1 = nn.Linear(IN, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class Conv(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)

    def forward(self, x):
        return self.conv(x).mean(dim=(2, 3))


BATCH, IN = 16, 8
torch.manual_seed(0)
MODULE = MLP()
X = torch.from_numpy(np.random.default_rng(0).normal(size=(BATCH, IN)).astype(np.float32))


def test_exports_match_the_jax_package():
    assert ttools.__all__ == jtools.__all__


def test_signatures_drop_the_variables_argument():
    """A torch module holds its own parameters: the port's tools take no
    ``variables``, as the reference torcheval's do; the rest matches."""
    assert list(inspect.signature(jtools.FlopCounter).parameters) == ["module", "variables"]
    assert list(inspect.signature(FlopCounter).parameters) == ["module"]
    jax_params = list(inspect.signature(jtools.get_module_summary).parameters)
    assert jax_params.pop(1) == "variables"
    assert list(inspect.signature(get_module_summary).parameters) == jax_params


def test_count_flops_matmul_exact():
    # (M, K) @ (K, N): 2*M*K*N FLOPs, the JAX doctest's 524,288
    flops = count_flops(lambda a, b: a @ b, torch.empty(128, 64, device="meta"),
                        torch.empty(64, 32, device="meta"))
    assert flops == 2 * 128 * 64 * 32 == 524_288


def test_count_flops_backward_is_twice_the_forward():
    """Two matmul gradients the size of the forward one; JAX reads a
    positive count of its own."""
    bwd = count_flops_backward(lambda a, b: a @ b, torch.empty(128, 64, device="meta"),
                               torch.empty(64, 32, device="meta"))
    assert bwd == 2 * 524_288
    assert jtools.count_flops_backward(
        lambda a, b: a @ b, jax.ShapeDtypeStruct((128, 64), jnp.float32),
        jax.ShapeDtypeStruct((64, 32), jnp.float32)) > 0
    assert count_flops_backward(lambda n: n * 2, torch.empty(3, dtype=torch.int64)) == 0.0


def test_counts_allocate_nothing():
    """A 2^40-element product counts in an instant: nothing is allocated
    or run, real tensors only lend their shapes."""
    big = count_flops(lambda a, b: a @ b, torch.empty(1 << 20, 1 << 10, device="meta"),
                      torch.empty(1 << 10, 1 << 10, device="meta"))
    assert big == 2.0 * (1 << 40)
    real = torch.ones(4, 5)
    assert count_flops(lambda b: real @ b, torch.ones(5, 6)) == 2 * 4 * 5 * 6


def test_flop_counter_per_module():
    fc = FlopCounter(MODULE)
    out = fc.run(X, backward=True)
    assert out.shape == (BATCH, 4)
    fc1, fc2 = fc.flop_counts["fc1"], fc.flop_counts["fc2"]
    assert 2 * BATCH * IN * 32 <= fc1 <= 2 * BATCH * IN * 32 + BATCH * 32 + 64
    assert fc2 >= 2 * BATCH * 32 * 4
    assert fc.flop_counts[""] >= fc1 + fc2 - 1
    assert fc.flop_counts_backward["fc1"] > 0
    fc.reset()
    assert fc.flop_counts == {} and fc.flop_counts_backward == {}


def test_a_call_that_cannot_be_counted_alone_reads_minus_one():
    class HostRead(nn.Module):
        def forward(self, x):
            return x * float(x.sum())  # reads a value: no fake tensor has one

    class Root(nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 4)
            self.host = HostRead()

        def forward(self, x):
            return self.host(self.lin(x))

    fc = FlopCounter(Root())
    fc.run(torch.ones(2, 4))
    assert fc.flop_counts["lin"] == 2 * 2 * 4 * 4
    assert fc.flop_counts["host"] == -1.0 and fc.flop_counts[""] == -1.0


def test_module_summary_params_and_tree():
    summary = get_module_summary(MODULE, module_args=(X,), time_forward=False)
    assert isinstance(summary, ModuleSummary)
    assert summary.module_type == "MLP"
    n_expected = (IN * 32 + 32) + (32 * 4 + 4)
    assert summary.num_parameters == n_expected
    assert summary.num_trainable_parameters == n_expected
    assert summary.size_bytes == n_expected * 4
    assert set(summary.submodule_summaries) == {"fc1", "fc2"}
    fc1 = summary.submodule_summaries["fc1"]
    assert fc1.module_type == "Linear"
    assert fc1.num_parameters == IN * 32 + 32
    assert fc1.in_size == [(BATCH, IN)]
    assert fc1.out_size == [(BATCH, 32)]
    assert fc1.flops_forward >= 2 * BATCH * IN * 32
    assert fc1.flops_backward > 0
    assert summary.flops_forward >= fc1.flops_forward
    assert not summary.has_uninitialized_param


def test_module_summary_timing():
    summary = get_module_summary(MODULE, module_args=(X,), compute_flops=False,
                                 time_forward=True, num_timing_iters=2)
    assert summary.forward_elapsed_time_ms >= 0
    assert summary.submodule_summaries["fc1"].forward_elapsed_time_ms >= 0


def test_module_summary_conv():
    summary = get_module_summary(Conv(), module_args=(torch.zeros(2, 3, 8, 8),),
                                 time_forward=False)
    conv = summary.submodule_summaries["conv"]
    assert conv.num_parameters == 3 * 3 * 3 * 8 + 8
    # the JAX test's bounds: interior windows only .. full windows
    assert 2 * 2 * 6 * 6 * 3 * 3 * 3 * 8 <= conv.flops_forward <= 2 * 2 * 8 * 8 * 3 * 3 * 3 * 8


def test_prune_module_summary():
    summary = get_module_summary(MODULE, module_args=(X,), compute_flops=False,
                                 time_forward=False)
    prune_module_summary(summary, max_depth=1)
    assert summary.submodule_summaries == {}


def test_summary_table_renders():
    summary = get_module_summary(MODULE, module_args=(X,), compute_flops=False,
                                 time_forward=False)
    table = get_summary_table(summary)
    assert "MLP" in table and "fc1" in table and "Linear" in table
    assert "# Parameters" in table
    assert "MLP" in repr(summary)


def test_summary_without_inputs():
    summary = get_module_summary(MODULE)
    assert summary.num_parameters > 0
    assert summary.flops_forward == -1.0
    assert summary.in_size is None


def test_summary_links_modules_reached_via_named_methods():
    """A submodule reached only through a method other than ``forward``
    still appears in the tree, with its synthesized ancestors linked."""

    class Inner(nn.Module):
        def __init__(self):
            super().__init__()
            self.d = nn.Linear(8, 4)

        def forward(self, x):
            return self.d(x)

    class Sub(nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = Inner()

        def encode(self, x):
            return self.inner(x)

        def forward(self, x):
            return self.encode(x)

    class Root(nn.Module):
        def __init__(self):
            super().__init__()
            self.sub = Sub()

        def forward(self, x):
            return self.sub.encode(x)  # bypasses Sub.forward

    summary = get_module_summary(Root(), module_args=(torch.zeros(2, 8),), time_forward=False)

    def walk(s, acc):
        for k, sub in s.submodule_summaries.items():
            acc.append(k)
            walk(sub, acc)
        return acc

    assert {"sub", "sub.inner", "sub.inner.d"} <= set(walk(summary, []))


# ------------------------------------------------ the LM in both packages


@pytest.fixture(scope="module")
def both_lms():
    flax_model = jmodels.TransformerLM()
    variables = jmodels.init_params(flax_model)
    model = TransformerLM(device="cpu")
    model.load_state_dict(from_flax_variables(jax.tree.map(np.asarray, variables)))
    return flax_model, variables, model


def test_flop_counter_on_the_lm_is_the_analytic_matmul_count(both_lms):
    flax_model, variables, model = both_lms
    tokens = np.zeros((2, 16), np.int32)
    jfc = jtools.FlopCounter(flax_model, variables)
    jfc.run(jnp.asarray(tokens))
    fc = FlopCounter(model)
    fc.run(torch.from_numpy(tokens).long())
    assert fc.flop_counts[""] == LM_MATMUL_FLOPS
    assert set(fc.flop_counts) == set(jfc.flop_counts)
    jroot = jfc.flop_counts[""]
    assert 0 < (jroot - fc.flop_counts[""]) / jroot <= JAX_VS_PORT_TOL
    for name, count in fc.flop_counts.items():
        if name.split(".")[-1] in ("query", "key", "value", "out", "Dense_0", "Dense_1"):
            assert count == jfc.flop_counts[name], name
    assert fc.flop_counts["Block_0"] == fc.flop_counts["Block_1"]


def test_summary_trees_agree_key_for_key(both_lms):
    flax_model, variables, model = both_lms
    tokens = np.zeros((2, 16), np.int32)
    jsum = jtools.get_module_summary(flax_model, variables, module_args=(jnp.asarray(tokens),),
                                     time_forward=False)
    tsum = get_module_summary(model, module_args=(torch.from_numpy(tokens).long(),),
                              time_forward=False)

    def walk(s, acc):
        acc[s.module_name] = (s.module_type, s.num_parameters, s.num_trainable_parameters,
                              s.size_bytes, s.in_size, s.out_size)
        for sub in s.submodule_summaries.values():
            walk(sub, acc)
        return acc

    assert walk(tsum, {}) == walk(jsum, {})
    assert tsum.flops_forward == LM_MATMUL_FLOPS
    assert tsum.flops_backward == 2 * LM_MATMUL_FLOPS
    dense = tsum.submodule_summaries["Dense_0"]
    assert dense.flops_forward == jsum.submodule_summaries["Dense_0"].flops_forward
