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
is the union of every rank's ``i``-th slice).  On one rank the step is
the plain one.  ``make_serve_steps`` is the serving engine's business here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

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
    if len(axes) > 1:
        raise NotImplementedError(
            f"data parallelism over more than one mesh axis {tuple(axes)} waits "
            "for the dry-run slice (launch/dryrun.py)")
    return rules.mesh.get_group(axes[0])


def _local(batch: Dict) -> Dict[str, torch.Tensor]:
    from torch.distributed.tensor import DTensor
    return {k: (v.to_local() if isinstance(v, DTensor) else v) for k, v in batch.items()}


def make_train_step(model, train_cfg: TrainConfig) -> Callable:
    opt = make_optimizer(train_cfg.optimizer, period=len(model.pattern))
    loss_fn = make_loss_fn(model)
    n_micro = train_cfg.microbatches
    group = data_parallel_group(model.rt)

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
        return loss.detach(), dict(zip(params, grads))

    def train_step(params: Dict[str, torch.Tensor], opt_state, batch):
        batch = _local(batch)
        if n_micro == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(n_micro):
                mb = {k: x[i * (x.shape[0] // n_micro):(i + 1) * (x.shape[0] // n_micro)]
                      for k, x in batch.items()}
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

    return train_step
