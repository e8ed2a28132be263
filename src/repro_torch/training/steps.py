"""Train / eval steps — the port of ``repro/training/steps.py``.

The step is eager PyTorch: ``model.forward`` under ``torch.autograd`` (on
the card every fused kernel of the dense path runs in both passes: the
backward of an AG+GEMM is a GEMM+RS and the other way round,
``core/compiler``), the kv-copy sync, then :func:`apply_update` with the
model's weight-decay mask.  The optimizer sees the model's trainable tree
(``model.trainable``: no copy of a tied head), and the returned parameters
carry a refreshed copy (``model.with_tied``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.training.optimizer import AdamWConfig, apply_update, tree_leaves, tree_unflatten

__all__ = ["softmax_xent", "loss_and_grads", "make_train_step", "make_eval_step"]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean cross-entropy. logits [B, S, V] (any dtype), labels [B, S] integer."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


def _on(device: torch.device, batch: dict) -> dict:
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device) for k, v in batch.items()}


def loss_and_grads(model, cfg, pc, params, batch, *, remat_policy: str = "none", aux_weight: float = 0.01):
    """One forward and backward: (loss, ce, aux, gradients over
    ``model.trainable(params, cfg)``), before the kv-copy sync.  Raises if a
    parameter gets no gradient."""
    batch = _on(pc.device, batch)
    tree = model.trainable(params, cfg)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    logits, aux = model.forward(tree_unflatten(tree, leaves), cfg, pc, batch["inputs"], remat_policy=remat_policy)
    ce = softmax_xent(logits, batch["labels"], batch.get("mask"))
    loss = ce + aux_weight * aux
    grads = tree_unflatten(tree, list(torch.autograd.grad(loss, leaves)))
    return loss.detach(), ce.detach(), aux.detach(), grads


def make_train_step(
    model,
    cfg,
    pc,
    opt_cfg: AdamWConfig,
    *,
    remat_policy: str = "none",
    grad_masks=None,
    aux_weight: float = 0.01,
    sync_kv: bool = True,
) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``opt_state`` is over ``model.trainable(params, cfg)``
    (``init_opt_state`` of it).  batch: {"inputs": [B, S], "labels": [B, S],
    optional "mask"} (numpy or tensors).  Metrics: loss, ce, aux, grad_norm,
    lr (tensors).  Raises for a model whose training path is not ported
    (``model.check_trainable``), and if a parameter gets no gradient."""
    model.check_trainable(cfg, pc)

    def train_step(params, opt_state, batch):
        tree = model.trainable(params, cfg)
        loss, ce, aux, grads = loss_and_grads(
            model, cfg, pc, params, batch, remat_policy=remat_policy, aux_weight=aux_weight
        )
        if sync_kv:
            grads = model.sync_grads(grads, cfg, pc)
        new, new_opt, om = apply_update(
            tree, grads, opt_state, opt_cfg, grad_masks=grad_masks, decay=model.decay_mask(tree, cfg)
        )
        metrics = {"loss": loss, "ce": ce, "aux": aux, **om}
        return model.with_tied(new, cfg), new_opt, metrics

    return train_step


def make_eval_step(model, cfg, pc) -> Callable:
    """Returns ``eval_step(params, batch) -> mean cross-entropy`` (no grad)."""

    def eval_step(params, batch):
        batch = _on(pc.device, batch)
        with torch.no_grad():
            logits, _ = model.forward(params, cfg, pc, batch["inputs"])
            return softmax_xent(logits, batch["labels"], batch.get("mask"))

    return eval_step
