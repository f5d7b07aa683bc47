"""Train step builder, port of ``repro.train.step``.

``make_train_step`` returns a function
    (params, opt_state, batch) -> (params, opt_state, metrics)
with gradient-accumulation microbatching, global-norm clipping and the
chosen optimizer.  ``params`` is the model's own parameters by name
(``dict(model.named_parameters())``): the loss runs the model, autograd
gives the gradients, and the optimizer updates those tensors in place and
returns them, decaying the leaves the reference decays
(:func:`~repro_torch.train.optimizer.reference_decay`).

Data parallelism follows the model's ``RuntimeConfig.act_sharding``: where
its rules split the batch over a mesh axis of more than one rank, each rank
computes on its rows of the global batch (a batch of DTensors is taken as
its local pieces), and the gradients are summed over that axis before the
clip.  Each rank's loss is weighted by its share of the global batch's
labelled tokens, so the loss, the gradient norm and the update equal the
one-process step on the global batch (under microbatches, microbatch ``i``
is the union of every rank's ``i``-th slice).  Several batch axes are
flattened into one group.  On one rank the step is the plain one.

Sharded params (DTensors from :func:`repro_torch.train.sharding.shard_model`)
take a batch of DTensors, and the step runs on the global view: the loss is
the global batch's, each gradient comes back in its parameter's placements
(partial sums reduced, FSDP shards reduce-scattered) and the optimizer
updates the shards in place, so the mesh's placements do the data-parallel
reduction and no group is summed by hand.  Plain tensors made inside the
model (RoPE angles, masks) count as replicated
(``torch.distributed.tensor.experimental.implicit_replication``); the loss
and the gradient norm come back as plain scalars.  ``make_serve_steps`` is
the serving engine's business here.

The returned step carries its ``value_and_grad(params, batch)``: the loss
and the gradients it would update with, before any reduction over a group
(sharded params: under ``implicit_replication``, gradients in their
parameters' placements).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..kernels._local import is_dtensor
from .optimizer import (OptimizerConfig, clip_by_norm, make_optimizer,
                        reference_decay)

__all__ = ["TrainConfig", "make_train_step", "make_loss_fn",
           "data_parallel_group"]


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    microbatches: int = 1


def make_loss_fn(model):
    def loss_fn(batch):
        loss, aux = model.loss(batch)
        return loss, aux

    return loss_fn


def data_parallel_group(rt) -> Optional[dist.ProcessGroup]:
    """The process group the batch is split over (its axis of the
    ``act_sharding`` rules' mesh), or None on one rank."""
    if rt.act_sharding is None:
        return None
    rules = rt.act_sharding.rules
    axes = [a for a in rules.batch_axes if rules.size(a) > 1]
    if not axes:
        return None
    if len(axes) == 1:
        return rules.mesh.get_group(axes[0])
    # The batch axes as one mesh dim (DeviceMesh keeps the flattened mesh and
    # its group).
    return rules.mesh[tuple(axes)]._flatten().get_group()


def _local(batch: Dict) -> Dict[str, torch.Tensor]:
    from torch.distributed.tensor import DTensor
    return {k: (v.to_local() if isinstance(v, DTensor) else v) for k, v in batch.items()}


def _microbatch(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Rows ``i`` of ``n`` equal slices of each rank's piece of ``x``."""
    if not is_dtensor(x):
        return x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    rows = local.shape[0] // n
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    return DTensor.from_local(local[i * rows:(i + 1) * rows], x.device_mesh,
                              x.placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _plain(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if is_dtensor(x) else x


def make_train_step(model, train_cfg: TrainConfig) -> Callable:
    opt = make_optimizer(train_cfg.optimizer, period=len(model.pattern))
    loss_fn = make_loss_fn(model)
    n_micro = train_cfg.microbatches
    sharded = is_dtensor(next(model.parameters()))
    group = None if sharded else data_parallel_group(model.rt)

    def value_and_grad(params: Dict[str, torch.Tensor], batch):
        """(loss, grads) of this rank's batch; with data parallelism the
        loss is weighted by the batch's share of the global labelled tokens
        (the sum of the weighted losses over the ranks is the global loss)."""
        with torch.enable_grad():
            loss, aux = loss_fn(batch)
            if group is not None:
                n = (batch["labels"] >= 0).sum().float()
                total = n.clone()
                dist.all_reduce(total, group=group)
                loss = loss * (n / torch.clamp(total, min=1.0))
            grads = torch.autograd.grad(loss, list(params.values()))
        if sharded:
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, params.values())]
        return loss.detach(), dict(zip(params, grads))

    def train_step(params: Dict[str, torch.Tensor], opt_state, batch):
        if not sharded:
            return _train_step(params, opt_state, batch)
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            params, opt_state, metrics = _train_step(params, opt_state, batch)
            metrics = {k: _plain(v) for k, v in metrics.items()}
        return params, opt_state, metrics

    def _train_step(params: Dict[str, torch.Tensor], opt_state, batch):
        if not sharded:
            batch = _local(batch)
        if n_micro == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            grads = {k: torch.zeros_like(p, dtype=torch.float32) if sharded else
                     torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(n_micro):
                mb = {k: _microbatch(x, i, n_micro) for k, x in batch.items()}
                l, g = value_and_grad(params, mb)
                for k, acc in grads.items():
                    acc += g[k].float()
                loss = loss + l
                del g
            grads = {k: g / n_micro for k, g in grads.items()}
            loss = loss / n_micro
        if group is not None:
            for g in grads.values():
                dist.all_reduce(g, group=group)
            dist.all_reduce(loss, group=group)

        grads, gnorm = clip_by_norm(grads, train_cfg.optimizer.grad_clip)
        decay = reference_decay(params, len(model.pattern))
        params, opt_state = opt.update(grads, opt_state, params, decay=decay)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": opt_state["step"]}
        return params, opt_state, metrics

    train_step.value_and_grad = value_and_grad
    return train_step
