"""Train step builder, port of ``repro.train.step``.

``make_train_step`` returns a function
    (params, opt_state, batch) -> (params, opt_state, metrics)
with gradient-accumulation microbatching, global-norm clipping and the
chosen optimizer.  ``params`` is the model's own parameters by name
(``dict(model.named_parameters())``): the loss runs the model, autograd
gives the gradients, and the optimizer updates those tensors in place and
returns them, decaying the leaves the reference decays
(:func:`~repro_torch.train.optimizer.reference_decay`).  The reference's
activation-sharding hooks have no job on one device; ``make_serve_steps``
is the serving engine's business here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from .optimizer import (OptimizerConfig, clip_by_norm, make_optimizer,
                        reference_decay)

__all__ = ["TrainConfig", "make_train_step", "make_loss_fn"]


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    microbatches: int = 1


def make_loss_fn(model):
    def loss_fn(batch):
        loss, aux = model.loss(batch)
        return loss, aux

    return loss_fn


def make_train_step(model, train_cfg: TrainConfig) -> Callable:
    opt = make_optimizer(train_cfg.optimizer)
    loss_fn = make_loss_fn(model)
    n_micro = train_cfg.microbatches

    def value_and_grad(params: Dict[str, torch.Tensor], batch):
        with torch.enable_grad():
            loss, aux = loss_fn(batch)
            grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def train_step(params: Dict[str, torch.Tensor], opt_state, batch):
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

        grads, gnorm = clip_by_norm(grads, train_cfg.optimizer.grad_clip)
        decay = reference_decay(params, len(model.pattern))
        params, opt_state = opt.update(grads, opt_state, params, decay=decay)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": opt_state["step"]}
        return params, opt_state, metrics

    return train_step
