"""AdamW with warmup + cosine schedule, global-norm clipping and grad masks:
the port of ``repro/training/optimizer.py`` over the port's parameter trees
(nested dicts and lists of tensors).

Moments are float32; each parameter is updated in float32 and stored back
in its own dtype, as the reference does.  ``donate=True`` (the reference's
``make_train_step(donate=)``: JAX reuses the buffers of the state it was
given) updates the moments and the parameters in place, so a step holds
one copy of each, not two; the values are the same either way.  The
reference decays a leaf iff it has two or more dims in its own layout
(every scanned layer's leaves carry a layer axis there); the port's
rank-stacked leaves have other ranks, so
:func:`apply_update` takes an explicit per-leaf ``decay`` tree
(``models/lm.decay_mask``).  Scalars (the step, the schedule's factors) are
float32 CPU tensors, which CUDA ops take without a host sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

__all__ = ["AdamWConfig", "schedule", "init_opt_state", "global_norm", "apply_masks", "apply_update", "tree_map",
           "tree_leaves", "tree_unflatten"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts and lists; any other value,
    None included, is a leaf), with the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves: list):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _prefix_map(fn: Callable, tree, prefix):
    """``fn(leaf, value)`` where ``prefix`` is a prefix of ``tree``: a value
    at a node (None, a tensor, a bool) applies to every leaf below it; a
    dict key ``prefix`` lacks maps to None."""
    if isinstance(prefix, dict) and isinstance(tree, dict):
        return {k: _prefix_map(fn, v, prefix.get(k)) for k, v in tree.items()}
    if isinstance(prefix, (list, tuple)) and isinstance(tree, (list, tuple)):
        return [_prefix_map(fn, v, p) for v, p in zip(tree, prefix)]
    return tree_map(lambda leaf: fn(leaf, prefix), tree)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``: the learning
    rate at ``step`` (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params) -> dict:
    """Zero float32 moments shaped like ``params``, and step 0."""
    return {
        "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)))


def apply_masks(grads, grad_masks):
    """The gradients times a prefix tree of 0/1 masks (None: no mask)."""
    return _prefix_map(lambda g, m: g if m is None else g * m.to(g.dtype), grads, grad_masks)


def apply_update(params, grads, state: dict, cfg: AdamWConfig, grad_masks: Optional[Any], decay, donate: bool = False,
                 gnorm: Optional[torch.Tensor] = None):  # fmt: skip
    """One AdamW step.  Returns (params, state, metrics {grad_norm, lr}).

    ``grad_masks``: a prefix tree of 0/1 masks (None: no mask) multiplied
    into the gradients before the norm.  ``decay``: a prefix tree of bools,
    which leaves take weight decay.  ``donate``: update ``params`` and the
    moments of ``state`` in place (the returned trees hold them).
    ``gnorm``: the gradients' global norm, where the caller holds only a
    share of them (a data-parallel replica's blocks, a TP process's held
    ranks: ``training/steps``); by default
    :func:`global_norm` of ``grads``."""
    if grad_masks is not None:
        grads = apply_masks(grads, grad_masks)
    gnorm = global_norm(grads) if gnorm is None else gnorm
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, mu, nu, dec):
        # in place on fresh float32 buffers, at most two a leaf besides the
        # moments: the same elementwise operations, in the same order, as
        # mu' = b1 mu + (1 - b1) g, nu' = b2 nu + (1 - b2) g^2,
        # p' = p - lr ((mu' / b1c) / (sqrt(nu' / b2c) + eps) [+ wd p])
        if not donate:
            mu, nu = mu.clone(), nu.clone()
        g32 = g.to(torch.float32, copy=True).mul_(clip)
        mu.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        nu.mul_(cfg.b2).add_(g32.square_().mul_(1 - cfg.b2))
        den = torch.div(nu, b2c, out=g32).sqrt_().add_(cfg.eps)
        delta = torch.div(mu, b1c).div_(den)
        del den, g32
        if dec:  # decoupled weight decay
            delta.add_(p.to(torch.float32, copy=True).mul_(cfg.weight_decay))
        new = p.to(torch.float32, copy=True).sub_(delta.mul_(lr)).to(p.dtype)
        if donate:
            return p.copy_(new), mu, nu
        return new, mu, nu

    flat = zip(*(tree_leaves(t) for t in (params, grads, state["mu"], state["nu"])))
    dec = tree_leaves(_prefix_map(lambda _, d: d, params, decay))
    new = [upd(p, g, mu, nu, d) for (p, g, mu, nu), d in zip(flat, dec)]
    new_p, new_mu, new_nu = (tree_unflatten(params, [n[i] for n in new]) for i in range(3))
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, {"grad_norm": gnorm, "lr": lr}
