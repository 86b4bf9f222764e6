"""A dp x tp training step with in-step metric counters and an in-step sync.

The torch counterpart of the JAX package's multi-chip dry run: one
training step of ``TransformerLM`` -- forward, backward, an Adam update --
whose parameters are DTensors on a ``("dp", "tp")`` ``DeviceMesh``, each
placed as ``models.param_specs`` says (``"tp"`` is ``Shard(axis)`` on the
tp dimension, anything else ``Replicate()``, and every parameter is
replicated over dp), with the batch ``Shard(0)`` over dp. Beside the mean
next-token NLL the step counts ``num_correct``, ``num_total`` and
``sum_log_probs`` (the accuracy and perplexity sufficient statistics),
summed over dp. A second leg merges per-replica counters with
``metrics.sharded.sync_states_in_jit`` over the dp group. The same step
runs on a model with ordinary tensors, which is what the sharded step is
held against. Run:

    python -m torcheval_tpu_torch.examples.train_step --dp 2 --tp 2 --device cpu

which spawns ``dp * tp`` gloo processes (a ``FileStore`` in a temporary
directory; dp and tp default to 2 there). ``--device cuda`` (the default)
runs one process on the card over NCCL, at dp 1 x tp 1, and refuses any
other ``--dp`` or ``--tp``.

The layout is applied as ``param_specs`` gives it, the query, key and
value kernels ``(d, H, hd)`` sharded on head_dim and the out kernel
``(H, hd, d)`` on heads. DTensor propagates the rest of the step; where
it cannot, the model or the step redistributes explicitly: a
head_dim-sharded kernel is replicated before ``Dense`` merges its dims
(DTensor merges dims only when the sharded one is outermost); the
attention core runs on each rank's rows with heads replicated (DTensor
would merge a head-sharded dim with the batch in the einsums' backward);
the position ids are a replicated DTensor; the lookups are
``F.embedding``; the logits, sharded on the vocabulary, come to each rank
whole before the log-softmax and the gather, which run on its rows. Each
rank's loss is its rows' NLL sum over the global token count, so the
ranks' gradients add up to the mean's. After the backward each gradient
is redistributed to its parameter's placements (the dp all-reduce), so
Adam updates every shard as the unsharded step would.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
    _multiclass_accuracy_update,
)
from torcheval_tpu_torch.metrics.sharded import sync_states_in_jit
from torcheval_tpu_torch.models import TransformerLM, init_params, param_specs

VOCAB, D_MODEL, N_LAYERS, SEQ = 128, 64, 2, 16
LR = 1e-3  # optax.adam(1e-3)
COUNTERS = ("num_correct", "num_total", "sum_log_probs")


def placements(spec: Sequence[Any]):
    """The (dp, tp) placements of a parameter with per-axis spec ``spec``:
    replicated over dp; over tp sharded on the axis marked ``"tp"``, or
    replicated."""
    from torch.distributed.tensor import Replicate, Shard

    tp = Shard(list(spec).index("tp")) if "tp" in spec else Replicate()
    return (Replicate(), tp)


def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Replace every parameter of ``model`` in place by a DTensor on
    ``mesh`` placed by ``param_specs``; returns ``model``."""
    from torch.distributed.tensor import distribute_tensor

    specs = param_specs(model)
    for fqn, param in list(model.named_parameters()):
        owner, _, name = fqn.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        sharded = distribute_tensor(param.detach(), mesh, placements(specs[fqn]))
        setattr(module, name, torch.nn.Parameter(sharded, requires_grad=param.requires_grad))
    return model


def shard_batch(t: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch as a DTensor: ``Shard(0)`` over dp, replicated over tp."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    return distribute_tensor(t, mesh, (Shard(0), Replicate()))


def loss_and_metrics(
    model: torch.nn.Module, tokens: torch.Tensor, targets: torch.Tensor,
    dp_group: Optional[Any] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """This rank's share of the mean next-token NLL (``log_softmax`` and a
    clipped gather over its rows, summed, over the global token count:
    the loss is the sum of the ranks' shares, so their gradients add up to
    the mean's) and the step's counters, summed over ``dp_group`` when the
    batch is sharded: ``num_correct`` and ``num_total`` from the accuracy
    update, ``sum_log_probs`` the NLL sum."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    logits = model(tokens)
    count = targets.numel()
    if isinstance(logits, DTensor):
        # the vocabulary is sharded over tp: softmax and gather run on this
        # rank's rows with the vocabulary whole
        logits = logits.redistribute(placements=(Shard(0), Replicate())).to_local()
        targets = targets.to_local()
    vocab = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, targets.clamp(0, vocab - 1)[..., None], dim=-1).squeeze(-1)
    loss = nll.sum() / count
    num_correct, num_total = _multiclass_accuracy_update(
        logits.detach().reshape(-1, vocab), targets.reshape(-1), "micro", None, 1)
    counters = torch.stack([num_correct.to(torch.float32), num_total.to(torch.float32),
                            nll.detach().sum()])
    if dp_group is not None:
        dist.all_reduce(counters, group=dp_group)
    return loss, dict(zip(COUNTERS, counters.unbind()))


def train_step(
    model: torch.nn.Module, opt: torch.optim.Optimizer, tokens: torch.Tensor,
    targets: torch.Tensor, dp_group: Optional[Any] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward, backward and one optimizer step; returns the mean NLL (the
    ranks' shares summed) and the counters."""
    opt.zero_grad(set_to_none=True)
    loss, counters = loss_and_metrics(model, tokens, targets, dp_group)
    backward(model, loss)
    opt.step()
    return global_loss(loss, dp_group), counters


def global_loss(loss: torch.Tensor, dp_group: Optional[Any] = None) -> torch.Tensor:
    """The ranks' loss shares summed over ``dp_group``."""
    loss = loss.detach().clone()
    if dp_group is not None:
        dist.all_reduce(loss, group=dp_group)
    return loss


def backward(model: torch.nn.Module, loss: torch.Tensor) -> None:
    """``loss.backward()``, then each DTensor gradient redistributed to its
    parameter's placements (a gradient of a dp-replicated parameter comes
    back partial over dp: this is the all-reduce)."""
    from torch.distributed.tensor import DTensor

    loss.backward()
    for p in model.parameters():
        if isinstance(p.grad, DTensor) and p.grad.placements != p.placements:
            p.grad = p.grad.redistribute(placements=p.placements)


def sync_leg(dp_group: Any, dp_rank: int, device) -> Dict[str, torch.Tensor]:
    """Per-replica counters (``num_correct`` = the dp rank, ``num_total``
    1) merged by ``sync_states_in_jit`` over ``dp_group``: ``num_total``
    comes to dp and ``num_correct`` to dp (dp - 1) / 2."""
    states = {
        "num_correct": torch.tensor(float(dp_rank), device=device),
        "num_total": torch.tensor(1.0, device=device),
    }
    return sync_states_in_jit(states, dp_group)


def widths_for(tp: int) -> Dict[str, int]:
    """The dry run's model: vocabulary 128, d_model 64, 2 layers,
    ``n_heads = max(4, tp)``."""
    return dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=max(4, tp), n_layers=N_LAYERS)


def seeded_step_inputs(seed: int, dp: int, tp: int, device):
    """Seeded weights (a state dict) and a seeded (tokens, targets) batch
    of ``2 dp`` sequences of ``SEQ`` next-token pairs."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = TransformerLM(**widths_for(tp), device=device)
    state = init_params(model, gen)
    tokens = torch.randint(0, VOCAB, (2 * dp, SEQ + 1), generator=gen, device=device)
    return state, tokens[:, :-1].contiguous(), tokens[:, 1:].contiguous()


def run_rank(dp: int, tp: int, device, state: Dict[str, torch.Tensor], tokens: torch.Tensor,
             targets: torch.Tensor, steps: int = 1) -> Dict[str, Any]:
    """One rank of the dp x tp step inside an initialized process group of
    ``dp * tp`` ranks: the model loads ``state`` (whole tensors, the same
    on every rank) and takes ``steps`` steps on the global batch
    (``tokens``, ``targets``). Returns the losses, the counters, the sync
    leg's result, the placements and the updated parameters, whole."""
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    mesh = init_device_mesh(device.type, (dp, tp), mesh_dim_names=("dp", "tp"))
    model = TransformerLM(**widths_for(tp), device=device)
    model.load_state_dict(state)
    shard_model(model, mesh)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    dp_group = mesh.get_group("dp")
    tokens, targets = shard_batch(tokens.to(device), mesh), shard_batch(targets.to(device), mesh)
    losses, counters = [], []
    for _ in range(steps):
        loss, c = train_step(model, opt, tokens, targets, dp_group)
        losses.append(float(loss))
        counters.append({k: float(v) for k, v in c.items()})
    synced = sync_leg(dp_group, mesh.get_local_rank("dp"), device)
    return {
        "losses": losses, "counters": counters,
        "synced": {k: float(v) for k, v in synced.items()},
        "placements": {k: tuple(str(p) for p in v.placements)
                       for k, v in model.state_dict().items()},
        "params": {k: v.full_tensor().cpu() for k, v in model.state_dict().items()},
    }


def _worker(rank, world, dp, tp, store_path, steps, out_path):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        state, tokens, targets = seeded_step_inputs(0, dp, tp, "cpu")
        torch.save(run_rank(dp, tp, "cpu", state, tokens, targets, steps), f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--dp", type=int, help="data-parallel ranks (2 on the CPU, 1 on the card)")
    parser.add_argument("--tp", type=int, help="tensor-parallel ranks (2 on the CPU, 1 on the card)")
    parser.add_argument("--steps", type=int, default=2)
    args = parser.parse_args(argv)
    if args.device == "cuda":
        from torcheval_tpu_torch import launcher

        # one card: NCCL takes one rank a device, so the mesh is 1 x 1
        if (args.dp or 1, args.tp or 1) != (1, 1):
            parser.error("--device cuda runs on one card: --dp and --tp must be 1")
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{launcher.free_port()}",
                                rank=0, world_size=1)
        try:
            device = torch.device("cuda", 0)
            results = [run_rank(1, 1, device, *seeded_step_inputs(0, 1, 1, device), args.steps)]
        finally:
            dist.destroy_process_group()
    else:
        dp, tp = args.dp or 2, args.tp or 2
        world = dp * tp
        with tempfile.TemporaryDirectory() as tmp:
            out_path = os.path.join(tmp, "rank")
            mp.spawn(_worker, args=(world, dp, tp, os.path.join(tmp, "store"),
                                    args.steps, out_path), nprocs=world, join=True)
            results = [torch.load(f"{out_path}.{r}") for r in range(world)]
    first = results[0]
    for step, (loss, c) in enumerate(zip(first["losses"], first["counters"])):
        print(f"step {step}: loss={loss:.4f} acc={c['num_correct'] / c['num_total']:.4f} "
              f"tokens={c['num_total']:.0f}")
    print(f"sync leg: num_total={first['synced']['num_total']:.0f} "
          f"num_correct={first['synced']['num_correct']:.0f}")
    print("train step done")
    return {"results": results}


if __name__ == "__main__":
    main()
