"""Train / eval steps — the port of ``repro/training/steps.py``.

The step is eager PyTorch: ``model.forward`` (``models/lm`` or
``models/encdec``, with the batch's ``embeds`` when it has them) under
``torch.autograd`` (on the card every fused kernel of the dense path runs
in both passes: the backward of an AG+GEMM is a GEMM+RS and the other way round,
``core/compiler``), the kv-copy sync, then :func:`apply_update` with the
model's weight-decay mask.  The optimizer sees the model's trainable tree
(``model.trainable``: no copy of a tied head), and the returned parameters
carry a refreshed copy (``model.with_tied``).

With ``pc.data`` (the data axes' :class:`~repro_torch.backend.mesh.
DistWorld`, one replica a process) the step is data-parallel, ZeRO-3: the
parameters in and out are this replica's blocks (:func:`data_blocks`, by
the parameter specs ``model.specs``) and the forward gathers each layer's
leaves whole at their use (``ParallelContext.use_gather``, inside the
remat'd body, so a recomputing backward gathers them again), whose
backward reduce-scatters the gradients onto the blocks.  Each replica
runs the forward and backward on its share of the global batch, its loss
scaled so that the gradients are those of the global mean (a masked mean
divides by the global mask count, all-reduced); the TP kv-copy sync and
the 0/1 masks act on the blocks (neither mixes the data dim); the
gradients of the leaves the data axes do not split are all-reduced over
``data``, once a step per dtype, and every gradient is divided by the
replica count; the clip takes the global norm (the blocks' squared norms
all-reduced); and AdamW updates the blocks against moments that hold only
those blocks (``init_opt_state`` of :func:`data_blocks`, the JAX package's
placement of ``opt`` by the parameter specs).  No replica holds a whole
copy of a split leaf between steps; :func:`gather_blocks` joins the
replicas' blocks for a checkpoint.  The embedding and a shared mixer are
read more than once a pass and gathered once a pass (``models/lm``).

Over a TP world of processes (``pc.world.nprocs > 1``, one card each;
attention with a dense MLP or a MoE block, TP or EP,
``model.check_trainable``) every process runs the
forward and backward of its held ranks, the world's collectives carrying
their adjoints (``backend/mesh``) and the fused ops' backward on the peer
route (``core/compiler``), and computes the loss whole from the gathered
logits.  Then (:func:`tp_procs_grads`) the kv-copy sync gathers the kv
columns over the processes, the masks hold the held ranks, and the leaves
``model.proc_roles`` calls "summed" (a layer's norms and a MoE router,
read by each rank inside the rank-stacked region) are summed over the
processes, one
all-gather a dtype summed in process order, so every process holds the
same sum; the "whole" leaves (``embed``, the head, ``final_ln``) are not,
since their gradients are whole on every process already.  The global norm
is the held leaves' squares (a MoE block's experts and shared MLP among
them) summed over the processes plus the others' once, and AdamW updates
each process's leaves: its held ranks' slices, and
the replicated leaves alike on every process.  Metrics are equal on every
process.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.parallel.sharding import data_dim, map_specs, place_data
from repro_torch.training.optimizer import AdamWConfig, apply_masks, apply_update, tree_leaves, tree_unflatten

__all__ = ["softmax_xent", "loss_and_grads", "make_train_step", "make_eval_step", "data_blocks",
           "data_parallel_grads", "gather_blocks", "tp_procs_grads"]


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


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None, count=None) -> torch.Tensor:
    """Mean cross-entropy. logits [B, S, V] (any dtype), labels [B, S] integer;
    float32 math over row blocks (:class:`_Nll`).  With ``mask`` the mean
    over its ones, divided by ``count`` where given (a data-parallel step's
    share of the global count) instead of the mask's own sum."""
    nll = _Nll.apply(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long()).reshape(labels.shape)
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / (torch.clamp(m.sum(), min=1.0) if count is None else count)
    return nll.mean()


def _on(device: torch.device, batch: dict) -> dict:
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device) for k, v in batch.items()}


def loss_and_grads(model, cfg, pc, params, batch, *, remat_policy: str = "none", aux_weight: float = 0.01,
                   mask_count=None):  # fmt: skip
    """One forward and backward: (loss, ce, aux, gradients over
    ``model.trainable(params, cfg)``), before the kv-copy sync.  Raises if a
    parameter gets no gradient.  ``mask_count``: what a masked ce divides
    by (:func:`softmax_xent`'s ``count``)."""
    batch = _on(pc.device, batch)
    tree = model.trainable(params, cfg)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    logits, aux = model.forward(
        tree_unflatten(tree, leaves), cfg, pc, batch["inputs"], embeds=batch.get("embeds"), remat_policy=remat_policy
    )
    ce = softmax_xent(logits, batch["labels"], batch.get("mask"), count=mask_count)
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
    gradient.  With ``pc.data`` the step is data-parallel (module
    docstring): ``batch`` is this replica's share of the global batch (equal
    rows on every replica), ``params`` (in and out) and ``opt_state`` are
    over :func:`data_blocks`, and the metrics are the global ones.  Over a
    TP world of processes ``params`` and ``opt_state`` are this process's
    (its held ranks' slices; module docstring), and every process passes
    the same ``batch``."""
    model.check_trainable(cfg, pc)
    if pc.data is not None:
        return _data_parallel_step(model, cfg, pc, opt_cfg, remat_policy=remat_policy, grad_masks=grad_masks,
                                   aux_weight=aux_weight, sync_kv=sync_kv, donate=donate)  # fmt: skip
    if pc.world.nprocs > 1:
        return _tp_procs_step(model, cfg, pc, opt_cfg, remat_policy=remat_policy, grad_masks=grad_masks,
                              aux_weight=aux_weight, sync_kv=sync_kv, donate=donate)  # fmt: skip

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


def data_blocks(model, cfg, pc, tree):
    """This replica's blocks of a trainable tree (``model.trainable`` of the
    parameters, or of gradients) over ``pc.data``, by the parameter specs:
    what a data-parallel step's parameters and moments are shaped like
    (``model.with_tied`` of the parameters' blocks gives a tied head's
    block)."""
    return map_specs(lambda s, t: place_data(t, s, pc.data, pc.dp_axes), model.trainable(model.specs(cfg, pc), cfg),
                     tree)  # fmt: skip


def gather_blocks(model, cfg, pc, tree):
    """Inverse of :func:`data_blocks`: the whole trainable tree from every
    replica's blocks (one all-gather per dtype; a checkpoint's)."""
    with torch.no_grad():
        return pc.use_gather(tree, model.trainable(model.specs(cfg, pc), cfg))


def data_parallel_grads(model, cfg, pc, params, batch, *, remat_policy: str = "none", grad_masks=None,
                        aux_weight: float = 0.01, sync_kv: bool = True):  # fmt: skip
    """The data-parallel step's gradients (module docstring): this replica's
    forward and backward on its ``batch`` rows from the parameters' blocks
    ``params``, the kv-copy sync, the 0/1 ``grad_masks``, then the replicas'
    mean over ``pc.data``, this replica's block of each leaf the data axes
    split (reduce-scattered by the backward), all of any other.  Returns
    (loss, ce, aux, gradients, global gradient norm), the metrics the global
    batch's."""
    data, dp, axes = pc.data, pc.data.size, pc.dp_axes
    specs = model.trainable(model.specs(cfg, pc), cfg)
    count = None
    if batch.get("mask") is not None:  # a masked mean divides by the global count: dp x this share of it
        mask = batch["mask"] if torch.is_tensor(batch["mask"]) else torch.as_tensor(np.asarray(batch["mask"]))
        total = data.psum(mask.to(pc.device, torch.float32).sum().reshape(1), control=True)[0]
        count = torch.clamp(total, min=1.0) / dp
    loss, ce, aux, grads = loss_and_grads(model, cfg, pc, params, batch, remat_policy=remat_policy,
                                          aux_weight=aux_weight, mask_count=count)  # fmt: skip
    loss, ce, aux = (data.psum(torch.stack([loss, ce, aux]).float(), control=True) / dp).unbind(0)
    if sync_kv:
        grads = model.sync_grads(grads, cfg, pc)
    if grad_masks is not None:
        grads = apply_masks(grads, grad_masks)
    grads = _replica_mean(specs, grads, data, axes)
    split, whole = [], []  # squared norms: of blocks (summed over the replicas), of whole leaves (once)
    map_specs(lambda s, g: (whole if data_dim(s, axes) is None else split).append(g.float().square().sum()),
              specs, grads)  # fmt: skip
    sq = data.psum(torch.stack(split).sum().reshape(1), control=True)[0] if split else 0.0
    return loss, ce, aux, grads, torch.sqrt(sq + (torch.stack(whole).sum() if whole else 0.0))


def _data_parallel_step(model, cfg, pc, opt_cfg, *, remat_policy, grad_masks, aux_weight, sync_kv, donate) -> Callable:
    """The data-parallel train step (module docstring)."""

    def train_step(params, opt_state, batch):
        tree = model.trainable(params, cfg)
        loss, ce, aux, grads, gnorm = data_parallel_grads(
            model, cfg, pc, params, batch, remat_policy=remat_policy, grad_masks=grad_masks, aux_weight=aux_weight,
            sync_kv=sync_kv,
        )  # fmt: skip
        new, new_opt, om = apply_update(tree, grads, opt_state, opt_cfg, grad_masks=None,
                                        decay=model.decay_mask(tree, cfg), donate=donate, gnorm=gnorm)  # fmt: skip
        metrics = {"loss": loss, "ce": ce, "aux": aux, **om}
        return model.with_tied(new, cfg), new_opt, metrics

    return train_step


def tp_procs_grads(model, cfg, pc, params, batch, *, remat_policy: str = "none", grad_masks=None,
                   aux_weight: float = 0.01, sync_kv: bool = True):  # fmt: skip
    """The step's gradients over a TP world of processes (module
    docstring): this process's forward and backward, the kv-copy sync, the
    0/1 ``grad_masks`` (of this process's ranks), then the "summed" leaves
    summed over the processes.  Returns (loss, ce, aux, gradients, global
    gradient norm), every one but the held gradients equal on every
    process."""
    procs = pc.world.procs
    loss, ce, aux, grads = loss_and_grads(model, cfg, pc, params, batch, remat_policy=remat_policy,
                                          aux_weight=aux_weight)  # fmt: skip
    if sync_kv:
        grads = model.sync_grads(grads, cfg, pc)
    if grad_masks is not None:
        grads = apply_masks(grads, grad_masks)
    roles, leaves = tree_leaves(model.proc_roles(grads, cfg)), tree_leaves(grads)
    summed = {}
    for i, role in enumerate(roles):
        if role == "summed":
            summed.setdefault(leaves[i].dtype, []).append(i)
    for idx in summed.values():  # dtypes in order of first appearance: the same on every process
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        total = procs.all_gather(flat.reshape(1, -1), 0).float().sum(0).to(flat.dtype)  # process order
        for i, part in zip(idx, total.split([leaves[i].numel() for i in idx])):
            leaves[i] = part.reshape(leaves[i].shape)
    zero = torch.zeros((), dtype=torch.float32, device=pc.device)
    held = torch.stack([g.float().square().sum() for r, g in zip(roles, leaves) if r == "held"] or [zero]).sum()
    rest = torch.stack([g.float().square().sum() for r, g in zip(roles, leaves) if r != "held"] or [zero]).sum()
    gnorm = torch.sqrt(procs.all_gather(held.reshape(1), 0).sum() + rest)
    return loss, ce, aux, tree_unflatten(grads, leaves), gnorm


def _tp_procs_step(model, cfg, pc, opt_cfg, *, remat_policy, grad_masks, aux_weight, sync_kv, donate) -> Callable:
    """The train step over a TP world of processes (module docstring)."""

    def train_step(params, opt_state, batch):
        tree = model.trainable(params, cfg)
        loss, ce, aux, grads, gnorm = tp_procs_grads(
            model, cfg, pc, params, batch, remat_policy=remat_policy, grad_masks=grad_masks, aux_weight=aux_weight,
            sync_kv=sync_kv,
        )  # fmt: skip
        new, new_opt, om = apply_update(tree, grads, opt_state, opt_cfg, grad_masks=None,
                                        decay=model.decay_mask(tree, cfg), donate=donate, gnorm=gnorm)  # fmt: skip
        metrics = {"loss": loss, "ce": ce, "aux": aux, **om}
        return model.with_tied(new, cfg), new_opt, metrics

    return train_step


def _replica_mean(specs, grads, data, axes):
    """The replicas' mean of every gradient: a leaf the data axes split
    arrives as this replica's block of the replicas' sum (the backward's
    reduce-scatter), any other leaf whole and this replica's own, all-reduced
    here (one all-reduce per dtype over the concatenated leaves); each is
    divided by the replica count."""
    n = data.size
    leaves = []
    map_specs(lambda s, g: leaves.append((data_dim(s, axes), g)), specs, grads)
    whole = {}
    for i, (d, g) in enumerate(leaves):
        if d is None:
            whole.setdefault(g.dtype, []).append(i)
    out = [None if d is None else g / n for d, g in leaves]
    for idx in whole.values():  # dtypes in order of first appearance: the same on every replica
        mean = data.psum(torch.cat([leaves[i][1].reshape(-1) for i in idx])) / n
        for i, part in zip(idx, mean.split([leaves[i][1].numel() for i in idx])):
            out[i] = part.reshape(leaves[i][1].shape)
    it = iter(out)
    return map_specs(lambda s, g: next(it), specs, grads)


def make_eval_step(model, cfg, pc) -> Callable:
    """Returns ``eval_step(params, batch) -> mean cross-entropy`` (no grad);
    under ``pc.data`` on this replica's blocks, each layer gathered at its
    use, the mean over this replica's ``batch``."""

    def eval_step(params, batch):
        batch = _on(pc.device, batch)
        with torch.no_grad():
            logits, _ = model.forward(params, cfg, pc, batch["inputs"], embeds=batch.get("embeds"))
            return softmax_xent(logits, batch["labels"], batch.get("mask"))

    return eval_step
