"""Abstract inputs, parameters and caches per (arch x shape) — the port of
``repro/launch/specs.py``, no device memory.

The JAX package builds ``ShapeDtypeStruct`` trees with ``jax.eval_shape``;
the port has no ``eval_shape``, so its abstract trees are ``meta`` tensors
(a shape and a dtype, no storage), built by shape: the models' ``init`` on
the ``meta`` device with no generator, so nothing is drawn.  Each tree comes
with its spec tree (``parallel/sharding.Spec``: the models' ``specs`` /
``cache_specs``), so ``launch/dryrun`` can size every leaf per device of any
mesh.  Global shapes, as in the JAX package; the dry run runs one data
replica's share (``batch_pspec``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.backend.mesh import World
from repro_torch.configs.base import ArchConfig, Shape
from repro_torch.models import encdec, frontends, lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.parallel.sharding import Spec, map_specs, only_axes
from repro_torch.training.optimizer import tree_map

__all__ = ["model_module", "cell_is_applicable", "abstract_params", "abstract_opt_state", "batch_pspec",
           "input_specs", "on_meta"]  # fmt: skip

META = torch.device("meta")


def model_module(cfg: ArchConfig):
    return encdec if cfg.encoder_layers else lm


def cell_is_applicable(cfg: ArchConfig, shape: Shape) -> Tuple[bool, str]:
    """The JAX package's rule: long_500k only for sub-quadratic archs (the same reason string)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skip: pure full-attention arch — long_500k requires "
                       "sub-quadratic attention (DESIGN.md §Arch-applicability)")  # fmt: skip
    return True, ""


def on_meta(pc: ParallelContext) -> ParallelContext:
    """``pc`` with its world on the ``meta`` device (same size, mesh and options)."""
    if pc.device.type == "meta":
        return pc
    return dataclasses.replace(pc, world=World(pc.tp, META), backend="eager")


def abstract_params(cfg: ArchConfig, pc: ParallelContext, dtype=torch.bfloat16):
    """(the port's parameter tree as meta tensors, its specs), no allocation."""
    mod = model_module(cfg)
    params = mod.init(cfg, World(pc.tp, META), None, dtype, device=META)
    return params, mod.specs(cfg, pc)


def abstract_opt_state(param_shapes, param_specs):
    """(the AdamW state of ``param_shapes`` as meta tensors, its specs): the
    float32 moments sharded as their parameters (ZeRO), the step replicated."""
    zeros = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32, device=META), param_shapes)
    opt = {"mu": zeros, "nu": tree_map(lambda p: torch.empty_like(p), zeros),
           "step": torch.empty((), dtype=torch.int32, device=META)}  # fmt: skip
    return opt, {"mu": param_specs, "nu": map_specs(lambda s: s, param_specs), "step": Spec()}


def batch_pspec(batch: int, pc: ParallelContext) -> Any:
    """The batch dim's spec entry: the data axes when the batch divides over
    them (long_500k's batch of 1 does not), else None (replicated)."""
    dp = pc.dp_spec()
    n = pc.dp
    return dp if (dp is not None and batch % n == 0 and batch >= n) else None


def input_specs(cfg: ArchConfig, shape: Shape, pc: ParallelContext, dtype=torch.bfloat16):
    """(inputs as meta tensors, their specs) for the cell's step:

    train:   {"inputs", "labels"[, "embeds"]}
    prefill: {"tokens"[, "embeds"]}
    decode:  {"tokens", "caches", "cache_len"}
    """
    b, s = shape.global_batch, shape.seq_len
    bspec = batch_pspec(b, pc)
    i32 = torch.int32

    if shape.kind in ("train", "prefill"):
        tree: Dict[str, Any] = {}
        specs: Dict[str, Any] = {}
        n_text = s
        if cfg.frontend == "vision":
            n_img = frontends.vision_prefix_len(s)
            n_text = s - n_img
            tree["embeds"] = torch.empty((b, n_img, cfg.d_model), dtype=dtype, device=META)
            specs["embeds"] = Spec(bspec, None, None)
        elif cfg.frontend == "audio":
            n_enc = min(cfg.enc_len, frontends.audio_frames_len(s) * 8)
            tree["embeds"] = torch.empty((b, n_enc, cfg.d_model), dtype=dtype, device=META)
            specs["embeds"] = Spec(bspec, None, None)
        key = "inputs" if shape.kind == "train" else "tokens"
        tree[key] = torch.empty((b, n_text), dtype=i32, device=META)
        specs[key] = Spec(bspec, None)
        if shape.kind == "train":
            tree["labels"] = torch.empty((b, s), dtype=i32, device=META)
            specs["labels"] = Spec(bspec, None)
        return tree, specs

    # decode: one new token and caches of length seq_len
    mod = model_module(cfg)
    caches = mod.init_caches(cfg, on_meta(pc), b, s, dtype)
    cspecs = mod.cache_specs(cfg, pc)
    if bspec is None:  # the caches' batch dim does not shard when b < dp: drop the data axes
        cspecs = map_specs(lambda sp: only_axes(sp, ("model",)), cspecs)
    tree = {"tokens": torch.empty((b, 1), dtype=i32, device=META), "caches": caches,
            "cache_len": torch.empty((), dtype=i32, device=META)}  # fmt: skip
    specs = {"tokens": Spec(bspec, None), "caches": cspecs, "cache_len": Spec()}
    return tree, specs
