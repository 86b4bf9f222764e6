"""The causal attention kernel: softmax attention under a causal mask in
one pass over the keys of each query tile (``csrc/causal_attention.cu``),
for ``models.transformer.SelfAttention``.

``causal_attention(q, k, v)`` takes q, k and v of shape (B, S, H, hd), as
the query, key and value projections give them (read in place, no
permute), and returns the attention output as (B, S, H, hd) contiguous:

    out[b, i, h] = sum_{j <= i} softmax_j(q_i . k_j / d) v_j

with ``d = sqrt(hd)`` rounded to the input dtype, the divisor the op
sequence uses. Scores and the softmax run in float32 on the card; the
probabilities are rounded to the input dtype once before the product with
V, the output once. The op sequence (``attention_ops``) rounds the scaled
query, the scores and the probabilities to the input dtype and the
masked scores to its lowest value, so the two agree to that rounding, not
bitwise; the kernel is the nearer to float32 attention.

The kernel is a dispatcher op (``OP``) with a fake kernel and a FLOP
formula, so a program traced on fake tensors sees one op and
``FlopCounter`` counts the causal products it performs: ``2 S (S + 1) hd``
FLOPs a (batch, head). It has no autograd formula: ``takes`` sends it
nothing that autograd records.

``takes(q, k, v)`` says whether the inputs go to the kernel: CUDA tensors
(not DTensors) of one shape (B, S, H, hd) and one dtype, bfloat16 or
float16, hd 64 or 128, unit stride along hd and the other strides and
offsets whole 16-byte steps, and nothing autograd would record. Everything
else, the CPU included, keeps the op sequence, so a CPU tensor never
reaches the wrapper. A launch counts one in
``_kernels.LAUNCHES["causal_attention"]``, runs on the current stream and
never synchronizes; the library builds on the first launch
(``_kernels.load``), as K1's does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from torcheval_tpu_torch.ops import _kernels

HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: 1, torch.float16: 2}
_ALIGN = 8  # elements in 16 bytes


def _is_dtensor(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _layout_fits(t: torch.Tensor) -> bool:
    """Unit stride along hd; every other stride and the offset whole
    16-byte steps (a size-1 dim's stride is never used)."""
    if t.stride(-1) != 1 or t.storage_offset() % _ALIGN:
        return False
    return all(t.stride(d) % _ALIGN == 0 for d in range(3) if t.shape[d] > 1)


def _refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Optional[str]:
    """What the kernel needs that ``(q, k, v)`` lack, or None when it
    takes them (autograd aside)."""
    ts = (q, k, v)
    if any(_is_dtensor(t) or not t.is_cuda for t in ts):
        return f"plain CUDA tensors, got {[type(t).__name__ + ' on ' + str(t.device) for t in ts]}"
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        return f"q, k and v all bfloat16 or all float16, got {q.dtype}, {k.dtype}, {v.dtype}"
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or q.shape[-1] not in HEAD_DIMS:
        return (f"q, k and v of one shape (B, S, H, hd) with hd in {HEAD_DIMS}, got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in zip("qkv", ts):
        if not _layout_fits(t):
            return (f"{name} with unit stride along hd and strides and offset in multiples of "
                    f"{_ALIGN} elements, got strides {t.stride()} and offset {t.storage_offset()}")
    return None


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether ``(q, k, v)`` go to the kernel (see the module)."""
    if _refusal(q, k, v) is not None:
        return False
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)))


def attention_ops(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The op sequence of ``nn.SelfAttention`` under a causal mask, as
    ``SelfAttention`` runs it off the kernel: the query divided by
    ``sqrt(hd)`` rounded to the dtype, the (B, H, S, S) scores, the mask
    at the dtype's lowest value, a softmax in the dtype, the product with
    V; (B, S, H, hd)."""
    # jnp.sqrt(depth).astype(dtype): the divisor rounded to the dtype
    # (a CPU scalar tensor, passed to a CUDA kernel by value)
    depth = torch.tensor(q.shape[-1], dtype=torch.float32).sqrt().to(q.dtype)
    weights = torch.einsum("bqhd,bkhd->bhqk", q / depth, k)
    seq = q.shape[1]
    causal = torch.ones((seq, seq), dtype=torch.bool, device=q.device).tril()
    weights = torch.where(causal, weights, torch.finfo(weights.dtype).min)
    probs = torch.softmax(weights, dim=-1)
    del weights
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ----------------------------------------------------------------- launch

_INITIALIZED: Dict[int, bool] = {}


def _init(lib, device: int) -> None:
    """The variants' shared-memory limits, once per device."""
    if device not in _INITIALIZED:
        _kernels.check(lib, lib.tev_causal_attention_init(), "causal_attention init")
        _INITIALIZED[device] = True


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    refusal = _refusal(q, k, v)
    if refusal is not None:
        raise ValueError(f"causal_attention kernel needs {refusal}")


def _attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    _check(q, k, v)
    batch, seq, heads, head_dim = q.shape
    out = torch.empty((batch, seq, heads, head_dim), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    for name, t in zip("qkv", (q, k, v)):
        if t.data_ptr() % 16:
            raise ValueError(f"causal_attention kernel needs {name} 16-byte aligned")
    device = q.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _attention_cuda(q, k, v)
    lib = _kernels.load("causal_attention")
    _init(lib, device)
    args = _kernels.CAUSAL_ATTENTION_LAUNCH.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        batch, seq, heads,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        head_dim, _DTYPES[q.dtype],
    )
    code = lib.tev_causal_attention(args, torch._C._cuda_getCurrentRawStream(device))
    if code:
        _kernels.check(lib, code, "causal_attention launch")
    _kernels.count_launch("causal_attention")
    return out


# ----------------------------------------------------------------- the op

# Registering the schema builds nothing: the library builds on the first
# launch. The fake kernel gives the output's shape and dtype.
_LIB = torch.library.Library("torcheval_tpu_torch", "FRAGMENT")
_LIB.define("causal_attention(Tensor q, Tensor k, Tensor v) -> Tensor")


def _attention_fake(q, k, v):
    return q.new_empty(q.shape)


def causal_flops(batch: int, seq: int, heads: int, head_dim: int) -> int:
    """FLOPs of the causal products: QK^T and PV over the S (S + 1) / 2
    pairs (j <= i) of each (batch, head), 2 FLOPs a multiply-add."""
    return 2 * batch * heads * head_dim * seq * (seq + 1)


def _flop_formula(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    return causal_flops(q_shape[0], q_shape[1], q_shape[2], q_shape[3])


_LIB.impl("causal_attention", _attention_cuda, "CUDA")
torch.library.register_fake("torcheval_tpu_torch::causal_attention", _attention_fake, lib=_LIB)
OP = torch.ops.torcheval_tpu_torch.causal_attention.default


def _register_flop_formula() -> None:
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    packet = torch.ops.torcheval_tpu_torch.causal_attention
    if packet not in flop_registry:
        register_flop_formula(packet)(_flop_formula)


_register_flop_formula()


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention of (B, S, H, hd) ``q``, ``k``, ``v``: one
    kernel launch (``OP``) for inputs ``takes`` accepts."""
    return OP(q, k, v)
