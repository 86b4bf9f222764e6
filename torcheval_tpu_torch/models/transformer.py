"""A transformer LM used by examples, the card smoke and the tools.

Counterpart of ``torcheval_tpu/models/transformer.py`` (a Flax module).
The modules carry Flax's names and parameter layouts, so a module's FQN
is its Flax path joined by ``.`` (``Block_0.SelfAttention_0.query``), its
parameters are Flax's leaves (``kernel`` as ``(in, out)``, ``(d, H, hd)``
for query/key/value and ``(H, hd, d)`` for out, ``embedding``,
``scale``/``bias``), and ``from_flax_variables`` is a renaming-free copy.
The arithmetic is Flax's where it matters for parity:

- ``nn.SelfAttention`` divides the query by ``sqrt(head_dim)`` (rounded
  to the activation dtype) before the product, masks with
  ``finfo(dtype).min`` and runs its softmax in the activation dtype;
- ``nn.LayerNorm`` has eps ``1e-6`` (torch's ``layer_norm`` computes the
  variance in two passes where Flax takes E[x^2] - E[x]^2, so the two
  agree to rounding, not bitwise);
- ``nn.gelu`` is the tanh approximation.

``param_specs`` returns, for each FQN, the per-axis tuple of the JAX
package's ``PartitionSpec`` for the same leaf.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from torcheval_tpu_torch.utils.convert import DeviceLike, canonicalize_device

# jax.nn.initializers.truncated_normal's stddev of the standard normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def _replicated_like(t: torch.Tensor, ref: Any) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``ref``'s mesh when ``ref`` is a
    DTensor (the sharded training step), else ``t``: DTensor refuses to
    mix the two in one op."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _local_rows(*ts: torch.Tensor):
    """DTensors as this rank's rows, plain tensors, and the way back: the
    batch (dim 0) stays sharded where it was, every other mesh dim is
    replicated first, and the result returns as a DTensor of the same
    placements, whose backward redistributes the gradient to them. The
    attention core runs so on every rank of the sharded step (DTensor
    would merge a head-sharded batch dim in the einsums' backward, which
    it refuses). Plain tensors pass through."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(ts[0], DTensor):
        return ts, lambda t: t
    mesh = ts[0].device_mesh
    placements = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                       for p in ts[0].placements)
    local = tuple(t.redistribute(placements=placements).to_local() for t in ts)
    return local, lambda t: DTensor.from_local(t, mesh, placements, run_check=False)


def _mergeable(kernel: torch.Tensor, firsts: Sequence[int]) -> torch.Tensor:
    """``kernel`` ready for a reshape that merges the runs of dims starting
    at ``firsts``: a DTensor sharded on a dim that is not the first of its
    run is replicated on that mesh dim first (DTensor merges dims only
    when the sharded one is outermost; ``param_specs`` shards the query,
    key and value kernels ``(d, H, hd)`` on head_dim)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(kernel, DTensor):
        return kernel
    placements = tuple(Replicate() if isinstance(p, Shard) and p.dim not in firsts else p
                       for p in kernel.placements)
    if placements == tuple(kernel.placements):
        return kernel
    return kernel.redistribute(placements=placements)


class Dense(nn.Module):
    """``nn.Dense``/``nn.DenseGeneral`` without bias: contracts the last
    ``len(in_shape)`` axes of the input with ``kernel`` of shape
    ``(*in_shape, *out_shape)``."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int], *, device, dtype) -> None:
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = nn.Parameter(
            torch.empty((*self.in_shape, *self.out_shape), device=device, dtype=dtype)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[: x.dim() - len(self.in_shape)]
        flat = x.reshape(*lead, math.prod(self.in_shape))
        kernel = _mergeable(self.kernel, (0, len(self.in_shape)))
        y = flat @ kernel.reshape(math.prod(self.in_shape), math.prod(self.out_shape))
        return y.reshape(*lead, *self.out_shape)


class DenseGeneral(Dense):
    """``nn.DenseGeneral``: the attention projections (its own type name,
    as in the Flax module tree)."""


class Embed(nn.Module):
    def __init__(self, num_embeddings: int, features: int, *, device, dtype) -> None:
        super().__init__()
        self.embedding = nn.Parameter(
            torch.empty((num_embeddings, features), device=device, dtype=dtype)
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # the same row gather as indexing; a DTensor table shards it
        # forward and backward, where it cannot shard indexing's backward
        return F.embedding(ids, self.embedding)


class LayerNorm(nn.Module):
    def __init__(self, features: int, *, device, dtype) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones((features,), device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros((features,), device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.scale.shape, self.scale, self.bias, eps=1e-6)


class SelfAttention(nn.Module):
    """``nn.SelfAttention(num_heads, qkv_features=d_model, use_bias=False)``
    under a causal mask."""

    def __init__(self, d_model: int, n_heads: int, *, device, dtype) -> None:
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by n_heads {n_heads}")
        heads = (n_heads, d_model // n_heads)
        kw = dict(device=device, dtype=dtype)
        self.query = DenseGeneral((d_model,), heads, **kw)
        self.key = DenseGeneral((d_model,), heads, **kw)
        self.value = DenseGeneral((d_model,), heads, **kw)
        self.out = DenseGeneral(heads, (d_model,), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)  # (B, S, H, hd)
        (q, k, v), back = _local_rows(q, k, v)
        # jnp.sqrt(depth).astype(dtype): the divisor rounded to the dtype
        # (a CPU scalar tensor, passed to a CUDA kernel by value)
        depth = torch.tensor(q.shape[-1], dtype=torch.float32).sqrt().to(q.dtype)
        weights = torch.einsum("bqhd,bkhd->bhqk", q / depth, k)
        seq = x.shape[1]
        causal = torch.ones((seq, seq), dtype=torch.bool, device=x.device).tril()
        weights = torch.where(causal, weights, torch.finfo(weights.dtype).min)
        probs = torch.softmax(weights, dim=-1)
        del weights
        return self.out(back(torch.einsum("bhqk,bkhd->bqhd", probs, v)))


class Block(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, *, device=None, dtype=torch.float32) -> None:
        super().__init__()
        device = canonicalize_device(device)
        kw = dict(device=device, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(d_model, **kw)
        self.SelfAttention_0 = SelfAttention(d_model, n_heads, **kw)
        self.LayerNorm_1 = LayerNorm(d_model, **kw)
        self.Dense_0 = Dense((d_model,), (d_ff,), **kw)
        self.Dense_1 = Dense((d_ff,), (d_model,), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.SelfAttention_0(self.LayerNorm_0(x))
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(h)


class TransformerLM(nn.Module):
    """Token and learned position embeddings, ``n_layers`` pre-norm
    blocks, a final LayerNorm and an untied head. Parameters are left
    uninitialized (LayerNorm aside): fill them with :func:`init_params` or
    ``load_state_dict``. ``device=None`` means CUDA."""

    def __init__(
        self,
        vocab_size: int = 256,
        d_model: int = 64,
        n_heads: int = 4,
        n_layers: int = 2,
        d_ff: int = 128,
        max_len: int = 128,
        *,
        device: DeviceLike = None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        device = canonicalize_device(device)
        self.vocab_size, self.d_model, self.n_heads = vocab_size, d_model, n_heads
        self.n_layers, self.d_ff, self.max_len = n_layers, d_ff, max_len
        kw = dict(device=device, dtype=dtype)
        self.Embed_0 = Embed(vocab_size, d_model, **kw)
        self.Embed_1 = Embed(max_len, d_model, **kw)
        for i in range(n_layers):
            self.add_module(f"Block_{i}", Block(d_model, n_heads, d_ff, **kw))
        self.LayerNorm_0 = LayerNorm(d_model, **kw)
        self.Dense_0 = Dense((d_model,), (vocab_size,), **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        pos = _replicated_like(torch.arange(tokens.shape[-1], device=tokens.device), tokens)
        x = self.Embed_0(tokens) + self.Embed_1(pos)
        for i in range(self.n_layers):
            x = getattr(self, f"Block_{i}")(x)
        return self.Dense_0(self.LayerNorm_0(x))


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fill ``model``'s parameters in place by Flax's default init laws,
    drawn from ``generator`` (on the parameters' device): ``Embed``
    N(0, 1/features); ``Dense``/``DenseGeneral`` kernels lecun-normal
    (a normal cut at two standard deviations, scaled to variance
    1/fan_in, fan_in the product of the contracted axes); LayerNorm scale
    1, bias 0. Draws in float32 and rounds to the parameter dtype. Returns
    the state dict."""
    for module in model.modules():
        if isinstance(module, Embed):
            draw = torch.empty(module.embedding.shape, device=module.embedding.device)
            nn.init.normal_(draw, std=module.embedding.shape[1] ** -0.5, generator=generator)
            module.embedding.copy_(draw)
        elif isinstance(module, Dense):
            draw = torch.empty(module.kernel.shape, device=module.kernel.device)
            nn.init.trunc_normal_(draw, std=1.0, a=-2.0, b=2.0, generator=generator)
            draw.mul_(math.prod(module.in_shape) ** -0.5 / _TRUNC_STD)
            module.kernel.copy_(draw)
        elif isinstance(module, LayerNorm):
            module.scale.fill_(1.0)
            module.bias.zero_()
    return model.state_dict()


def _spec_for(fqn: str, ndim: int) -> Tuple[Any, ...]:
    """The JAX package's ``param_specs`` rule for one leaf, by its path."""
    if ndim < 2:
        return ()
    joined = fqn.replace(".", "/")
    if "Embed" in joined:
        return (None, "tp")
    if "out" in joined or "Dense_1" in joined:
        # attention out-proj and MLP down-proj: contract over the sharded dim
        return ("tp", None)
    return (None,) * (ndim - 1) + ("tp",)


def param_specs(params: Any) -> Dict[str, Tuple[Any, ...]]:
    """Per-axis tensor-parallel placements over a ``tp`` axis, for each
    FQN of a model (or of its state dict): the tuple the JAX package's
    ``PartitionSpec`` holds for the same leaf (``()`` replicated). As
    there, query/key/value kernels ``(d, H, hd)`` shard their LAST axis
    (head_dim) while the out kernel ``(H, hd, d)`` shards its FIRST
    (heads): the pin of a reference-side inconsistency, kept as is."""
    items = params.state_dict() if isinstance(params, nn.Module) else params
    return {fqn: _spec_for(fqn, t.dim()) for fqn, t in items.items()}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_flax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``TransformerLM`` variables (``{"params": ...}``,
    leaves as numpy arrays or anything ``np.asarray`` reads) as this
    module's state dict: each Flax path joined by ``.``, each leaf as is
    (the layouts are Flax's). Load it with ``load_state_dict``, which
    rejects an unknown name or a wrong shape."""
    return {
        ".".join(path): torch.from_numpy(np.array(value))
        for path, value in _flatten(variables["params"])
    }
