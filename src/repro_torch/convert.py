"""Carry parameters across: global (JAX-layout) weights -> the port's
rank-stacked parameters.

``from_jax_params`` takes the pytree of the JAX package's ``lm.init`` as
numpy arrays (global, unsharded) and returns the port's parameters; the
port's own ``lm.init`` builds global tensors on the card and goes through
the same :func:`shard_params`, so both follow one layout.  Sharding follows
the JAX package's partition specs:

  * ``wq`` / ``wkv`` / ``w_gu`` by columns (``P(dp, "model")``);
  * ``wo`` / ``w_down`` by rows (``P("model", dp)``);
  * ``embed`` by vocab rows (``P("model", dp)``).

The GQA zero pads and the per-shard gate|up interleave are kept exactly as
stored; each rank's ``wq`` and ``wkv`` columns are joined into one ``wqkv``
shard (the JAX package concatenates them at every call).  With tied
embeddings the LM head is a contiguous copy of the embedding, transposed.
``params["scan"]`` (a leading layer axis per pattern position) is unstacked
into the layer list.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.backend.mesh import World

__all__ = ["from_jax_params", "shard_params", "shard_cols", "shard_rows"]


def shard_cols(w: torch.Tensor, world: World) -> torch.Tensor:
    """[D, n] -> [W, D, n/W]: contiguous column blocks per rank."""
    d, n = w.shape
    if n % world.size:
        raise ValueError(f"{n} columns do not divide over {world.size} ranks")
    return w.reshape(d, world.size, n // world.size).permute(1, 0, 2).contiguous()


def shard_rows(w: torch.Tensor, world: World) -> torch.Tensor:
    """[n, D] -> [W, n/W, D]: contiguous row blocks per rank."""
    n = w.shape[0]
    if n % world.size:
        raise ValueError(f"{n} rows do not divide over {world.size} ranks")
    return w.reshape((world.size, n // world.size) + tuple(w.shape[1:])).contiguous()


def shard_params(glob: Dict[str, Any], cfg, world: World) -> Dict[str, Any]:
    """Global parameters {embed, final_ln, [lm_head], layers: [...]} -> rank-stacked."""
    embed = glob["embed"]
    head = glob["lm_head"] if "lm_head" in glob else embed.t()
    out = {
        "embed": shard_rows(embed, world),
        "head": head.contiguous(),
        "final_ln": glob["final_ln"],
        "layers": [],
    }
    for layer in glob["layers"]:
        mixer = layer["mixer"]
        wq, wkv = shard_cols(mixer["wq"], world), shard_cols(mixer["wkv"], world)
        new = {
            "mixer": {
                "ln": mixer["ln"],
                "wqkv": torch.cat([wq, wkv], dim=-1).contiguous(),
                "wo": shard_rows(mixer["wo"], world),
            }
        }
        if "ffn" in layer:
            f = layer["ffn"]
            new["ffn"] = {
                "ln": f["ln"],
                "w_gu": shard_cols(f["w_gu"], world),
                "w_down": shard_rows(f["w_down"], world),
            }
        out["layers"].append(new)
    return out


def _tensors(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tensors(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree, dtype=np.float32, copy=True))
    return t.to(device=device, dtype=dtype)


def from_jax_params(np_params: Dict[str, Any], cfg, world: World, dtype: Optional[torch.dtype] = None):
    """The JAX package's ``lm.init`` pytree (numpy leaves) -> port parameters.

    ``dtype`` defaults to float32; leaves are moved to ``world.device``.
    """
    from repro_torch.models.lm import layer_plan

    dtype = dtype or torch.float32
    tree = _tensors(np_params, world.device, dtype)
    layers = list(tree.get("prefix", []))
    scan = tree.get("scan")
    if scan:
        n_units = next(iter(scan[0]["mixer"].values())).shape[0]
        for u in range(n_units):
            for unit_layer in scan:
                layers.append({blk: {k: a[u] for k, a in sub.items()} for blk, sub in unit_layer.items()})
    layers += list(tree.get("suffix", []))
    if len(layers) != len(layer_plan(cfg)):
        raise ValueError(f"got {len(layers)} layers for a {cfg.n_layers}-layer config")
    glob = {"embed": tree["embed"], "final_ln": tree["final_ln"], "layers": layers}
    if "lm_head" in tree:
        glob["lm_head"] = tree["lm_head"]
    return shard_params(glob, cfg, world)
