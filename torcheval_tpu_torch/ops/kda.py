"""The chunked gated delta rule of Kimi Delta Attention (KDA): the scan of
``models.kimi_linear.KimiDeltaAttention`` (``csrc/kda.cu`` on the card).

Per (batch, head), with a state S of (d_k, d_v) that starts at zero::

    S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T (scale q_t)

``g_t`` (d_k,) is the per-channel log decay (at most 0), ``beta_t`` a
scalar. ``kda_chunked(q, k, v, g, beta, scale)`` takes q, k of (B, T, H,
d_k), v of (B, T, H, d_v), g of (B, T, H, d_k) and beta of (B, T, H), and
returns o as (B, T, H, d_v) in v's dtype.

**The chunked form** (chunks of ``CHUNK`` tokens; within a chunk G_t is
the running sum of g from its first token, Gamma_t = exp(G_t), S_0 the
state at its start). With u_t = beta_t (v_t - (Diag(exp g_t) S_{t-1})^T
k_t), S_t = Diag(exp g_t) S_{t-1} + k_t u_t^T, and unrolling gives

- ``A[t, s] = beta_t sum_c k_t[c] k_s[c] exp(G_t[c] - G_s[c])`` (s < t),
  ``(I + A) [W_k | W_v] = [beta K Gamma | beta V]`` (one unit lower
  triangular solve, independent of the state), then
  ``U = W_v - W_k S_0``;
- ``M[t, s] = scale sum_c q_t[c] k_s[c] exp(G_t[c] - G_s[c])`` (s <= t),
  ``O = (scale Q Gamma) S_0 + M U``;
- ``S_C = Diag(Gamma_C) S_0 + (K exp(G_C - G))^T U``.

Every exponent is a difference whose sign is known, never exp(-G) alone,
so no decay can overflow: the pairs of two sub-blocks of ``SUB`` tokens
meet at a reference point r between them (the last token before the
later sub-block), ``exp(G_t - G_r) exp(G_r - G_s)`` with both exponents at
most 0; the pairs inside one sub-block take ``exp(G_t - G_s)`` directly.
A decay too strong for float32 underflows to 0, as the product it stands
for does.

``kda_ops`` is that algebra as a plain op sequence in float32, a Python
loop over the chunks (the state pass), each chunk's state-independent part
computed in it too: the CPU, float32, the tests and anything ``takes``
refuses run it. On the card,
bfloat16 q, k, v with float32 g and beta at d_k = d_v = 128 go to the
kernel (``OP``, a dispatcher op with a fake kernel and a FLOP formula): two
launches, the intra-chunk pass over every chunk at once and then the state
pass, each counted in ``_kernels.LAUNCHES["kda"]``; on the current stream,
no synchronisation, the library built at the first launch
(``_kernels.load``).

``conv_qkv(x, weight, heads)`` is the layer's other piece: the causal
depthwise convolutions of the q, k and v projections, SiLU, and the L2
norm of each q and k head, as one kernel on the card (``kda_conv``) and
the op sequence ``conv_qkv_ops`` elsewhere.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from torcheval_tpu_torch.ops import _kernels

CHUNK = 64
SUB = 16
HEAD_DIM = 128


# ---------------------------------------------------------------- op sequence

def _intra(q: torch.Tensor, k: torch.Tensor, G: torch.Tensor, sub: int):
    """A chunk's ``(sum_c k_t k_s e, sum_c q_t k_s e)`` with ``e =
    exp(G_t - G_s)``: (..., C, C) each, zero above the diagonal (the first
    zero on it too). q, k, G are (..., C, d_k) float32."""
    c = k.shape[-2]
    nb = c // sub
    A = k.new_zeros(k.shape[:-2] + (c, c))
    M = torch.zeros_like(A)
    for i in range(1, nb):
        lo = i * sub
        ref = G[..., lo - 1:lo, :]
        left = torch.exp(G[..., lo:lo + sub, :] - ref)
        right = (k[..., :lo, :] * torch.exp(ref - G[..., :lo, :])).transpose(-1, -2)
        A[..., lo:lo + sub, :lo] = (k[..., lo:lo + sub, :] * left) @ right
        M[..., lo:lo + sub, :lo] = (q[..., lo:lo + sub, :] * left) @ right
    Gb = G.unflatten(-2, (nb, sub))
    kb, qb = k.unflatten(-2, (nb, sub)), q.unflatten(-2, (nb, sub))
    diff = Gb[..., :, None, :] - Gb[..., None, :, :]  # (..., nb, t, s, d_k)
    lower = torch.ones(sub, sub, dtype=torch.bool, device=k.device).tril()
    e = torch.exp(torch.where(lower[:, :, None], diff, float("-inf")))
    ke = e * kb[..., None, :, :]
    a_diag = (kb[..., :, None, :] * ke).sum(-1).tril(-1)
    m_diag = (qb[..., :, None, :] * ke).sum(-1)
    for i in range(nb):
        s = slice(i * sub, (i + 1) * sub)
        A[..., s, s] = a_diag[..., i, :, :]
        M[..., s, s] = m_diag[..., i, :, :]
    return A, M


def kda_ops(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
            beta: torch.Tensor, scale: float, chunk: int = CHUNK) -> torch.Tensor:
    """The scan as a plain op sequence (module docstring), in float32."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    sub = min(SUB, chunk)
    if chunk % sub:
        raise ValueError(f"chunk {chunk} is not a multiple of {sub}")
    n = -(-t // chunk)
    pad = n * chunk - t

    def blocks(x):  # (B, T, H, D) -> (B, H, n, C, D), float32, zero-padded
        x = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(b, n, chunk, h, -1).permute(0, 3, 1, 2, 4)

    qc, kc, vc, gc = blocks(q) * scale, blocks(k), blocks(v), blocks(g)
    bc = blocks(beta[..., None])  # (B, H, n, C, 1)
    eye = torch.eye(chunk, device=q.device)
    S = q.new_zeros((b, h, dk, dv), dtype=torch.float32)
    out = []
    for i in range(n):
        qi, ki, vi, bi = qc[:, :, i], kc[:, :, i], vc[:, :, i], bc[:, :, i]
        G = gc[:, :, i].cumsum(-2)
        A, M = _intra(qi, ki, G, sub)
        rhs = torch.cat([ki * torch.exp(G), vi], -1) * bi
        W = torch.linalg.solve_triangular(eye + A * bi, rhs, upper=False, unitriangular=True)
        Wk, Wv = W.split([dk, dv], -1)
        U = Wv - Wk @ S
        out.append((qi * torch.exp(G)) @ S + M @ U)
        decay_to_end = ki * torch.exp(G[..., -1:, :] - G)
        S = torch.exp(G[..., -1, :])[..., None] * S + decay_to_end.transpose(-1, -2) @ U
    o = torch.stack(out, 2)  # (B, H, n, C, d_v)
    return o.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, dv)[:, :t].to(v.dtype)


# --------------------------------------------------------------------- kernel

def _refusal(q, k, v, g, beta) -> Optional[str]:
    """What the kernel needs that the inputs lack, or None."""
    if not all(x.is_cuda for x in (q, k, v, g, beta)):
        return "CUDA tensors"
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        return f"bfloat16 q, k and v, got {q.dtype}, {k.dtype}, {v.dtype}"
    if g.dtype != torch.float32 or beta.dtype != torch.float32:
        return f"float32 g and beta, got {g.dtype}, {beta.dtype}"
    if q.dim() != 4 or not (q.shape == k.shape == v.shape == g.shape) \
            or q.shape[-1] != HEAD_DIM or beta.shape != q.shape[:-1]:
        return (f"q, k, v, g of one shape (B, T, H, {HEAD_DIM}) and beta (B, T, H), got "
                f"{[tuple(x.shape) for x in (q, k, v, g, beta)]}")
    return None


def takes(q, k, v, g, beta) -> bool:
    """Whether the inputs go to the kernel (module docstring): plain CUDA
    tensors the kernel accepts, nothing that autograd records."""
    if _refusal(q, k, v, g, beta) is not None:
        return False
    from torch.distributed.tensor import DTensor

    if any(isinstance(x, DTensor) for x in (q, k, v, g, beta)):
        return False
    return not (torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, g, beta)))


_INITIALIZED: Dict[int, bool] = {}


def _kda_cuda(q, k, v, g, beta, scale: float) -> torch.Tensor:
    refusal = _refusal(q, k, v, g, beta)
    if refusal is not None:
        raise ValueError(f"kda kernel needs {refusal}")
    q, k, v, g, beta = (x.contiguous() for x in (q, k, v, g, beta))
    b, t, h, d = q.shape
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out
    device = q.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _kda_cuda(q, k, v, g, beta, scale)
    n = -(-t // CHUNK)
    # the intra-chunk pass's results, read by the state pass: W_k, W_v,
    # scale Q Gamma and K exp(G_C - G) (n x C x d each), M (C x C), Gamma_C
    rec = b * h * n
    mats = torch.empty((4, rec, CHUNK, d), dtype=torch.bfloat16, device=q.device)
    mm = torch.empty((rec, CHUNK, CHUNK), dtype=torch.bfloat16, device=q.device)
    gam = torch.empty((rec, d), dtype=torch.float32, device=q.device)
    lib = _kernels.load("kda")
    if device not in _INITIALIZED:
        _kernels.check(lib, lib.tev_kda_init(), "kda init")
        _INITIALIZED[device] = True
    args = _kernels.KDA_LAUNCH.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), beta.data_ptr(),
        out.data_ptr(), mats[0].data_ptr(), mats[1].data_ptr(), mats[2].data_ptr(),
        mats[3].data_ptr(), mm.data_ptr(), gam.data_ptr(), b, t, h, float(scale),
    )
    code = lib.tev_kda(args, torch._C._cuda_getCurrentRawStream(device))
    if code:
        _kernels.check(lib, code, "kda launch")
    _kernels.count_launch("kda")  # the intra-chunk pass
    _kernels.count_launch("kda")  # the state pass
    return out


# Registering the schema builds nothing: the library builds on the first
# launch. The fake kernel gives the output's shape and dtype.
_LIB = torch.library.Library("torcheval_tpu_torch", "FRAGMENT")
_LIB.define("kda(Tensor q, Tensor k, Tensor v, Tensor g, Tensor beta, float scale) -> Tensor")


def _kda_fake(q, k, v, g, beta, scale):
    return v.new_empty(v.shape)


def kda_flops(batch: int, seq: int, heads: int, dk: int = HEAD_DIM, dv: int = HEAD_DIM,
              chunk: int = CHUNK) -> int:
    """FLOPs of the chunked scan (2 a multiply-add) over whole chunks: A
    and M (C(C-1)/2 and C(C+1)/2 pairs of d_k), the solve (C(C-1)/2 pairs
    of d_k + d_v), U (C d_k d_v), O (C d_k d_v + C(C+1)/2 d_v) and the
    state update (C d_k d_v), each chunk of each (batch, head)."""
    c = chunk
    tri, tri_in = c * (c - 1) // 2, c * (c + 1) // 2
    macs = tri * dk + tri_in * dk + tri * (dk + dv) + 3 * c * dk * dv + tri_in * dv
    return 2 * batch * heads * (-(-seq // c)) * macs


def _flop_formula(q_shape, k_shape, v_shape, g_shape, beta_shape, *args, out_shape=None,
                  **kwargs) -> int:
    return kda_flops(q_shape[0], q_shape[1], q_shape[2], q_shape[3], v_shape[3])


_LIB.impl("kda", _kda_cuda, "CUDA")
torch.library.register_fake("torcheval_tpu_torch::kda", _kda_fake, lib=_LIB)
OP = torch.ops.torcheval_tpu_torch.kda.default


def _register_flop_formula() -> None:
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    packet = torch.ops.torcheval_tpu_torch.kda
    if packet not in flop_registry:
        register_flop_formula(packet)(_flop_formula)


_register_flop_formula()


# ------------------------------------------------------------- short conv

L2_EPS = 1e-6
CONV_TAPS = 4


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / sqrt(sum x^2 + 1e-6)`` over the last axis, in float32,
    returned in ``x``'s dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).sum(-1, keepdim=True) + L2_EPS)).to(x.dtype)


def conv_qkv_ops(x: torch.Tensor, weight: torch.Tensor, heads: int,
                 head_dim: int = HEAD_DIM):
    """A KDA layer's short convolutions as an op sequence: ``x`` (B, S, 3
    H d), the q, k and v projections side by side, through a causal
    depthwise convolution (``weight`` (3 H d, w); output t reads inputs t -
    w + 1 .. t, ``weight[:, -1]`` multiplying input t), SiLU, and the L2
    norm of each q and k head. Returns q, k, v of (B, S, H, d)."""
    b, s, _ = x.shape
    w = weight.shape[-1]
    y = F.conv1d(x.transpose(1, 2), weight[:, None, :], padding=w - 1, groups=weight.shape[0])
    qkv = F.silu(y[..., :s].transpose(1, 2)).reshape(b, s, 3, heads, head_dim)
    return l2_normalize(qkv[:, :, 0]), l2_normalize(qkv[:, :, 1]), qkv[:, :, 2]


def conv_qkv(x: torch.Tensor, weight: torch.Tensor, heads: int, head_dim: int = HEAD_DIM):
    """``conv_qkv_ops``, on the card one kernel (``csrc/kda.cu``'s
    ``kda_conv``: each input read once, q, k and v written once, counted in
    ``_kernels.LAUNCHES["kda_conv"]``) for bfloat16 CUDA input at d = 128
    and 4 taps outside autograd."""
    on_card = (x.is_cuda and x.dtype == weight.dtype == torch.bfloat16 and x.dim() == 3
               and head_dim == HEAD_DIM and weight.shape == (3 * heads * head_dim, CONV_TAPS)
               and x.shape[-1] == 3 * heads * head_dim
               and not (torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad)))
    if not on_card:
        return conv_qkv_ops(x, weight, heads, head_dim)
    return tuple(CONV_OP(x, weight, heads))


def _conv_cuda(x: torch.Tensor, weight: torch.Tensor, heads: int):
    x, weight = x.contiguous(), weight.contiguous()
    b, s, _ = x.shape
    q, k, v = (torch.empty((b, s, heads, HEAD_DIM), dtype=x.dtype, device=x.device)
               for _ in range(3))
    if q.numel() == 0:
        return [q, k, v]
    device = x.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _conv_cuda(x, weight, heads)
    lib = _kernels.load("kda")
    args = _kernels.KDA_CONV_LAUNCH.pack(x.data_ptr(), weight.data_ptr(), q.data_ptr(),
                                         k.data_ptr(), v.data_ptr(), b, s, heads)
    code = lib.tev_kda_conv(args, torch._C._cuda_getCurrentRawStream(device))
    if code:
        _kernels.check(lib, code, "kda_conv launch")
    _kernels.count_launch("kda_conv")
    return [q, k, v]


def _conv_fake(x, weight, heads):
    b, s, _ = x.shape
    return [x.new_empty((b, s, heads, HEAD_DIM)) for _ in range(3)]


_LIB.define("kda_conv(Tensor x, Tensor weight, int heads) -> Tensor[]")
_LIB.impl("kda_conv", _conv_cuda, "CUDA")
torch.library.register_fake("torcheval_tpu_torch::kda_conv", _conv_fake, lib=_LIB)
CONV_OP = torch.ops.torcheval_tpu_torch.kda_conv.default


def kda_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                beta: torch.Tensor, scale: float) -> torch.Tensor:
    """The KDA scan (module docstring): the kernel for inputs ``takes``
    accepts, else ``kda_ops``."""
    if takes(q, k, v, g, beta):
        return OP(q, k, v, g, beta, float(scale))
    return kda_ops(q, k, v, g, beta, scale)
