"""The causal attention kernel (``torcheval_tpu_torch/ops/causal_attention.py``,
``csrc/causal_attention.cu``) and its call site, ``SelfAttention.forward``.

On the CPU (here): ``takes`` in exactly the cases the dispatch names, that
a bf16 forward at head width 64 on fake CUDA tensors is one kernel op a
layer and ``FlopCounter`` counts the kernel's causal products there and
the dense op sequence elsewhere, that a forward autograd records keeps
the op sequence, that the wrapper refuses what the kernel does not take,
the launch struct's layout, and that ``chip_smoke.py``'s check of the
kernel passes the op sequence and catches a wrong answer.

On the card (``card`` marker; each test skips without CUDA): the kernel
against the op sequence it replaces and against float32 attention at the
benchmark's shape and at edge shapes -- its largest and rms errors no
larger than the op sequence's -- one launch a call, strided inputs, a
GPT-2-XL-width forward's logits against the op sequence's, a launch a
layer where the fused path is taken and none where autograd records, and
no host synchronisation. Run them on a card with ``python -m pytest
tests/test_torch_port_causal_attention.py -m card``. This file imports no
JAX.
"""

from __future__ import annotations

import contextlib

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from torcheval_tpu_torch.models import TransformerLM, init_params
from torcheval_tpu_torch.models import transformer
from torcheval_tpu_torch.ops import _kernels
from torcheval_tpu_torch.ops import causal_attention as ca

CUDA0 = torch.device("cuda", 0)
OP_NAME = "torcheval_tpu_torch.causal_attention.default"


def _fake_cuda(shape, dtype=torch.bfloat16, requires_grad=False):
    # a fake tensor on the card, made by factory (nothing is allocated)
    return torch.empty(shape, dtype=dtype, device="cuda", requires_grad=requires_grad)


class _Ops(TorchDispatchMode):
    """The names of the ops a block of code dispatches."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _small_lm(device, dtype, d_model=128, n_heads=2, n_layers=3):
    return TransformerLM(vocab_size=64, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
                         d_ff=64, max_len=32, device=device, dtype=dtype)


# ------------------------------------------------------------- the dispatch


def test_takes_cpu_tensors_never():
    q = torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16)
    assert not ca.takes(q, q, q)


@pytest.mark.parametrize(
    "shape,dtype,grad,want",
    [
        ((2, 16, 2, 64), torch.bfloat16, False, True),
        ((2, 16, 2, 64), torch.float16, False, True),
        ((2, 16, 2, 128), torch.bfloat16, False, True),
        ((2, 1, 1, 64), torch.bfloat16, False, True),
        ((2, 16, 2, 64), torch.float32, False, False),
        ((2, 16, 2, 16), torch.bfloat16, False, False),
        ((2, 16, 2, 96), torch.bfloat16, False, False),
        ((2, 16, 2, 64), torch.bfloat16, True, False),
    ],
    ids=["bf16-64", "f16-64", "bf16-128", "s1", "f32", "hd16", "hd96", "grad"],
)
def test_takes_on_fake_cuda_tensors(shape, dtype, grad, want):
    with FakeTensorMode():
        q = _fake_cuda(shape, dtype, requires_grad=grad)
        k, v = _fake_cuda(shape, dtype), _fake_cuda(shape, dtype)
        assert ca.takes(q, k, v) is want
        with torch.no_grad():  # nothing is recorded: only the grad case changes
            assert ca.takes(q, k, v) is (want or grad)


def test_takes_refuses_mixed_and_misaligned_inputs():
    with FakeTensorMode():
        q = _fake_cuda((2, 16, 2, 64))
        assert not ca.takes(q, _fake_cuda((2, 16, 2, 64), torch.float16), q)
        assert not ca.takes(q, _fake_cuda((2, 8, 2, 64)), q)
        # the first 64 of 66 columns: a row stride that is no whole 16-byte step
        odd = torch.empty_strided((2, 16, 2, 64), (2112, 132, 66, 1), dtype=torch.bfloat16,
                                  device="cuda")
        assert not ca.takes(odd, q, q)
        assert not ca.takes(_fake_cuda((2, 16, 64, 2)).transpose(2, 3), q, q)  # hd strided
        # (B, H, S, hd) storage seen as (B, S, H, hd): strides in whole 16-byte steps
        heads_major = torch.empty_strided((2, 16, 2, 64), (2048, 64, 1024, 1),
                                          dtype=torch.bfloat16, device="cuda")
        assert ca.takes(heads_major, q, q)


def test_takes_refuses_a_dtensor(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    if dist.is_initialized():
        pytest.skip("a process group is already initialized in this process")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0])
        local = torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16)
        d = DTensor.from_local(local, mesh, [Replicate()], run_check=False)
        assert ca._is_dtensor(d) and not ca._is_dtensor(local)
        assert not ca.takes(d, d, d)
        with pytest.raises(ValueError, match="plain CUDA"):
            ca._check(d, d, d)
    finally:
        dist.destroy_process_group()


def test_one_kernel_op_a_layer_on_fake_cuda_tensors():
    with FakeTensorMode():
        model = _small_lm(CUDA0, torch.bfloat16)
        ids = torch.zeros((2, 16), dtype=torch.int64, device="cuda")
        with torch.no_grad(), _Ops() as ops:
            logits = model(ids)
    assert (tuple(logits.shape), logits.dtype) == ((2, 16, 64), torch.bfloat16)
    assert ops.names.count(OP_NAME) == 3
    # none of the op sequence's passes over the scores is left
    assert not {"aten.softmax.int", "aten._softmax.default", "aten.where.self"} & set(ops.names)


@pytest.mark.parametrize("dtype,d_model", [(torch.float32, 128), (torch.bfloat16, 32)],
                         ids=["f32", "hd16"])
def test_float32_and_narrow_heads_keep_the_op_sequence_on_fake_cuda(dtype, d_model):
    with FakeTensorMode():
        model = _small_lm(CUDA0, dtype, d_model=d_model)
        ids = torch.zeros((2, 16), dtype=torch.int64, device="cuda")
        with torch.no_grad(), _Ops() as ops:
            model(ids)
    assert OP_NAME not in ops.names
    assert any("softmax" in n for n in ops.names)


@contextlib.contextmanager
def _as_if_on_card(monkeypatch, calls):
    """``SelfAttention.forward``'s dispatch on CPU tensors as if they lay
    on the card: ``takes`` judges fake CUDA twins of the same shape,
    strides, dtype and ``requires_grad`` (under the grad mode of the call),
    and the kernel's call becomes a recorder that runs the op sequence."""
    takes = ca.takes

    def on_card(q, k, v):
        with FakeTensorMode():
            twins = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="cuda")
                     for t in (q, k, v)]
        for twin, t in zip(twins, (q, k, v)):
            twin.requires_grad_(t.requires_grad)
        return takes(*twins)

    def recorder(q, k, v):
        calls.append(tuple(q.shape))
        return ca.attention_ops(q, k, v)

    monkeypatch.setattr(ca, "takes", on_card)
    monkeypatch.setattr(ca, "causal_attention", recorder)
    yield


def test_a_forward_autograd_records_keeps_the_op_sequence(monkeypatch):
    model = _small_lm("cpu", torch.bfloat16)
    init_params(model, torch.Generator().manual_seed(0))
    ids = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(1))
    calls = []
    with _as_if_on_card(monkeypatch, calls):
        recorded = model(ids)
        assert recorded.requires_grad and calls == []
        with torch.no_grad():
            fused = model(ids)
    assert calls == [(2, 16, 2, 64)] * 3
    torch.testing.assert_close(fused, recorded.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_the_flop_count_follows_the_path(dtype):
    """On fake CUDA tensors ``FlopCounterMode`` counts the kernel's causal
    products (its registered formula) where the bf16 forward takes it, and
    the op sequence's dense S x S products in float32."""
    from torch.utils.flop_counter import FlopCounterMode

    seq, d, layers = 16, 128, 3
    matmul = 2 * 2 * seq * (layers * (4 * d * d + 2 * d * 64) + d * 64)
    with FakeTensorMode():
        model = _small_lm(CUDA0, dtype, d_model=d, n_layers=layers)
        ids = torch.zeros((2, seq), dtype=torch.int64, device="cuda")
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(ids)
    attention = (layers * ca.causal_flops(2, seq, 2, 64) if dtype == torch.bfloat16
                 else layers * 4 * 2 * seq * seq * d)
    assert counter.get_total_flops() == matmul + attention


def test_the_op_counts_the_causal_products():
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode():
        q = _fake_cuda((8, 1024, 25, 64))
        with FlopCounterMode(display=False) as counter:
            out = ca.causal_attention(q, q, q)
    assert (tuple(out.shape), out.dtype, out.device.type) == ((8, 1024, 25, 64), torch.bfloat16,
                                                               "cuda")
    assert out.is_contiguous()
    assert counter.get_total_flops() == ca.causal_flops(8, 1024, 25, 64) == 2 * 8 * 25 * 64 * 1024 * 1025


# ------------------------------------------------------------- the wrapper


def test_wrapper_refuses_cpu_tensors():
    q = torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="plain CUDA"):
        ca._attention_cuda(q, q, q)


@pytest.mark.parametrize("fault", ["float32", "mixed", "hd96", "shape", "unit_stride", "row_stride"])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    with FakeTensorMode():
        q = _fake_cuda((2, 16, 2, 64))
        args = {
            "float32": lambda: (_fake_cuda((2, 16, 2, 64), torch.float32),) * 3,
            "mixed": lambda: (q, _fake_cuda((2, 16, 2, 64), torch.float16), q),
            "hd96": lambda: (_fake_cuda((2, 16, 2, 96)),) * 3,
            "shape": lambda: (q, _fake_cuda((2, 8, 2, 64)), q),
            "unit_stride": lambda: (_fake_cuda((2, 16, 64, 2)).transpose(2, 3), q, q),
            "row_stride": lambda: (torch.empty_strided((2, 16, 2, 64), (2112, 132, 66, 1),
                                                       dtype=torch.bfloat16, device="cuda"), q, q),
        }[fault]()
        with pytest.raises(ValueError, match="causal_attention kernel needs"):
            ca._attention_cuda(*args)


def test_op_has_no_cpu_kernel():
    q = torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        ca.OP(q, q, q)


def test_launch_struct_is_the_c_layout():
    # four pointers, twelve 64-bit and two 32-bit integers, no padding
    assert _kernels.CAUSAL_ATTENTION_LAUNCH.size == 4 * 8 + 12 * 8 + 2 * 4
    assert len(_kernels.CAUSAL_ATTENTION_LAUNCH_FIELDS) == 18
    assert "causal_attention" in _kernels.LAUNCHES


def test_op_sequence_is_the_model_s_materialised_path():
    """``attention_ops`` is what ``SelfAttention`` runs off the card: the
    forward of a CPU model through the module equals the op sequence on
    its projections, bit for bit."""
    model = _small_lm("cpu", torch.float32, n_layers=1)
    init_params(model, torch.Generator().manual_seed(2))
    attn = model.Block_0.SelfAttention_0
    x = torch.randn(2, 16, 128, generator=torch.Generator().manual_seed(3))
    q, k, v = attn.query(x), attn.key(x), attn.value(x)
    want = attn.out(ca.attention_ops(q, k, v))
    torch.testing.assert_close(attn(x), want, rtol=0, atol=0)
    assert transformer.causal_attention is ca


# ------------------------------------------- the smoke's check of the kernel


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_smoke_check_passes_the_op_sequence_on_cpu(dtype, monkeypatch):
    """``chip_smoke``'s check of the kernel, where both sides are the op
    sequence: the errors against float32 attention are equal."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "_fused_attention", ca.attention_ops)
    gen = torch.Generator().manual_seed(4)
    q, k, v = chip_smoke._attention_inputs(gen, (2, 40, 3, 64), dtype, "cpu")
    out = chip_smoke._causal_attention_check(q, k, v, "cpu")
    assert out["kernel_max_err"] == out["plain_max_err"] > 0
    assert out["kernel_rms_err"] == out["plain_rms_err"]


def test_smoke_check_catches_a_wrong_kernel(monkeypatch):
    import chip_smoke

    def off(q, k, v):
        return ca.attention_ops(q, k, v) + 2 ** -6

    monkeypatch.setattr(chip_smoke, "_fused_attention", off)
    gen = torch.Generator().manual_seed(5)
    q, k, v = chip_smoke._attention_inputs(gen, (2, 40, 3, 64), torch.bfloat16, "cpu")
    with pytest.raises(AssertionError):
        chip_smoke._causal_attention_check(q, k, v, "cpu")


# ---------------------------------------------------------------- the card


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the causal attention kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(shape, dtype, seed, dev):
    """q, k, v as the projections give them: views of one product's columns."""
    b, s, h, hd = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b * s, 3 * h * hd), generator=g, device=dev).to(dtype)
    return tuple(x[:, i * h * hd:(i + 1) * h * hd].reshape(b, s, h, hd) for i in range(3))


def _attention32(q, k, v):
    d = float(torch.tensor(q.shape[-1], dtype=torch.float32).sqrt().to(q.dtype))
    w = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d
    s = q.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(w.masked_fill(~causal, -torch.inf), -1),
                        v.float())


def _errors(x, want):
    e = (x.float() - want).abs()
    return float(e.max()), float(e.pow(2).mean().sqrt())


CARD_SHAPES = [(8, 1024, 25, 64), (2, 1, 25, 64), (2, 1000, 25, 64), (1, 2048, 16, 64),
               (4, 1024, 1, 64), (1, 1000, 16, 128)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_card_kernel_against_float32_and_the_op_sequence(shape, dtype):
    """Against float32 attention, the kernel's largest and rms errors are
    no larger than the op sequence's (it rounds the scores and the softmax
    to the input dtype; the kernel keeps both in float32)."""
    dev = _card()
    q, k, v = _inputs(shape, dtype, sum(shape), dev)
    before = _kernels.LAUNCHES["causal_attention"]
    got = ca.causal_attention(q, k, v)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["causal_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == dtype and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    want = _attention32(q, k, v)
    kernel_max, kernel_rms = _errors(got, want)
    plain_max, plain_rms = _errors(ca.attention_ops(q, k, v), want)
    assert kernel_max <= plain_max and kernel_rms <= plain_rms


@pytest.mark.card
def test_card_contiguous_and_strided_inputs_agree():
    dev = _card()
    q, k, v = _inputs((2, 300, 4, 64), torch.bfloat16, 1, dev)
    strided = ca.causal_attention(q, k, v)
    dense = ca.causal_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(strided, dense)
    # one head's slab of a wider tensor: a head stride past the heads kept
    wide = torch.randn((2, 300, 8, 64), device=dev).to(torch.bfloat16)
    part = wide[:, :, 2:6]
    assert torch.equal(ca.causal_attention(part, part, part),
                       ca.causal_attention(*(part.contiguous(),) * 3))


@pytest.mark.card
def test_card_gpt2_xl_width_forward_against_the_op_sequence(monkeypatch):
    """A whole GPT-2-XL-width forward (48 layers, 25 heads of 64) in bf16:
    48 launches, the logits within a third of ``gpt2xl_eval``'s
    ``logit_rms_rel`` limit (0.06) of the op sequence's forward."""
    dev = _card()
    model = TransformerLM(vocab_size=50_257, d_model=1600, n_heads=25, d_ff=6400, max_len=1024,
                          n_layers=48, device=dev, dtype=torch.bfloat16)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    ids = torch.randint(0, 50_257, (2, 1024), device=dev)
    with torch.no_grad():
        before = _kernels.LAUNCHES["causal_attention"]
        fused = model(ids)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["causal_attention"] == before + 48
        monkeypatch.setattr(ca, "takes", lambda q, k, v: False)
        plain = model(ids)
    rel = (fused.float() - plain.float()).pow(2).mean().sqrt() / plain.float().pow(2).mean().sqrt()
    assert float(rel) < 0.02


@pytest.mark.card
def test_card_no_launch_where_autograd_records():
    dev = _card()
    model = _small_lm(dev, torch.bfloat16)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    ids = torch.randint(0, 64, (2, 16), device=dev)
    before = _kernels.LAUNCHES["causal_attention"]
    model(ids).float().sum().backward()
    assert _kernels.LAUNCHES["causal_attention"] == before
    with torch.no_grad():
        model(ids)
    assert _kernels.LAUNCHES["causal_attention"] == before + 3


@pytest.mark.card
def test_card_no_host_sync():
    dev = _card()
    q, k, v = _inputs((2, 512, 4, 64), torch.bfloat16, 3, dev)
    ca.causal_attention(q, k, v)  # built, loaded, set up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ca.causal_attention(q, k, v)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
