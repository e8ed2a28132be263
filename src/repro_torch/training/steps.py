"""Train / eval steps — the port of ``repro/training/steps.py``.

The step is eager PyTorch: ``model.forward`` (``models/lm`` or
``models/encdec``, with the batch's ``embeds`` when it has them) under
``torch.autograd`` (on the card every fused kernel of the dense path runs
in both passes: the backward of an AG+GEMM is a GEMM+RS and the other way round,
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


XENT_ROWS = 1024  # rows of one float32 block of the cross-entropy (its only float32 copy of the logits)


class _Nll(torch.autograd.Function):
    """Per-row negative log-likelihood of logits [N, V] (any dtype) at labels
    [N]: lse - logit[label] in float32, as ``logsumexp`` over
    ``logits.float()`` less the gathered logit, but formed over blocks of
    ``XENT_ROWS`` rows: it saves the logits in their own dtype and each
    row's log-sum-exp, not a float32 copy of all of them (4.3 GB at 4096 x
    262144).  The backward is autograd's, block by block: g exp(x - lse),
    then -g added at the label, cast to the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse = torch.cat([torch.logsumexp(blk.float(), dim=-1) for blk in logits.split(XENT_ROWS)])
        ctx.save_for_backward(logits, labels, lse)
        return lse - torch.gather(logits, -1, labels[:, None])[:, 0].float()

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        grad = torch.empty_like(logits)
        for r0 in range(0, logits.shape[0], XENT_ROWS):
            rows = slice(r0, r0 + XENT_ROWS)
            p = g[rows, None] * torch.exp(logits[rows].float() - lse[rows, None])
            grad[rows] = p.scatter_add_(-1, labels[rows, None], -g[rows, None]).to(grad.dtype)
        return grad, None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean cross-entropy. logits [B, S, V] (any dtype), labels [B, S] integer;
    float32 math over row blocks (:class:`_Nll`)."""
    nll = _Nll.apply(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long()).reshape(labels.shape)
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
    logits, aux = model.forward(
        tree_unflatten(tree, leaves), cfg, pc, batch["inputs"], embeds=batch.get("embeds"), remat_policy=remat_policy
    )
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
    donate: bool = False,
) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``opt_state`` is over ``model.trainable(params, cfg)``
    (``init_opt_state`` of it).  batch: {"inputs": [B, S], "labels": [B, S0
    + S], optional "embeds" [B, S0, D] (a stub frontend's prefix, or an
    encoder-decoder's frames: then labels [B, S]), optional "mask"} (numpy
    or tensors).  Metrics: loss, ce, aux, grad_norm,
    lr (tensors).  ``donate`` (the reference's keyword; there ``True``):
    the step updates ``params`` and ``opt_state`` in place, so the caller
    must not use them after it (one copy of the parameters and moments in
    memory instead of two).  Raises for a model whose training path is not
    ported (``model.check_trainable``), and if a parameter gets no
    gradient."""
    model.check_trainable(cfg, pc)

    def train_step(params, opt_state, batch):
        tree = model.trainable(params, cfg)
        loss, ce, aux, grads = loss_and_grads(
            model, cfg, pc, params, batch, remat_policy=remat_policy, aux_weight=aux_weight
        )
        if sync_kv:
            grads = model.sync_grads(grads, cfg, pc)
        new, new_opt, om = apply_update(
            tree, grads, opt_state, opt_cfg, grad_masks=grad_masks, decay=model.decay_mask(tree, cfg), donate=donate
        )
        metrics = {"loss": loss, "ce": ce, "aux": aux, **om}
        return model.with_tied(new, cfg), new_opt, metrics

    return train_step


def make_eval_step(model, cfg, pc) -> Callable:
    """Returns ``eval_step(params, batch) -> mean cross-entropy`` (no grad)."""

    def eval_step(params, batch):
        batch = _on(pc.device, batch)
        with torch.no_grad():
            logits, _ = model.forward(params, cfg, pc, batch["inputs"], embeds=batch.get("embeds"))
            return softmax_xent(logits, batch["labels"], batch.get("mask"))

    return eval_step
