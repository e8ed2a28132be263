"""Carry parameters across: global (JAX-layout) weights -> the port's
rank-stacked parameters.

``from_jax_params`` takes the pytree of the JAX package's ``lm.init`` as
numpy arrays (global, unsharded) and returns the port's parameters; the
port's own ``lm.init`` builds global tensors on the card and goes through
the same :func:`shard_params`, so both follow one layout.  Sharding follows
the JAX package's partition specs:

  * ``wq`` / ``wkv`` / ``w_gu`` by columns (``P(dp, "model")``), the
    biases ``bq`` / ``bkv`` alike (``P("model")``);
  * ``wo`` / ``w_down`` by rows (``P("model", dp)``);
  * ``embed`` by vocab rows (``P("model", dp)``);
  * MoE blocks by experts: ``w_gu`` / ``w_down`` rows of dim 0
    (``P("model", ...)``); the ``router`` is replicated and stays float32
    whatever ``dtype`` the other leaves take; a ``shared`` expert MLP is
    sharded like a dense FFN;
  * Mamba mixers (``nn/mamba.specs``): ``w_xz`` / ``w_dt`` / ``conv`` by
    columns, ``w_out`` by rows, ``dt_bias`` / ``a_log`` / ``d_skip`` by heads
    (float32 always), ``w_bc`` and ``ln`` replicated.

The GQA zero pads and the per-shard gate|up interleave are kept exactly as
stored; each rank's ``wq`` and ``wkv`` columns are joined into one ``wqkv``
shard (the JAX package concatenates them at every call), as are ``bq``
and ``bkv`` into one ``bqkv`` shard, and so are a
Mamba mixer's ``w_xz`` and ``w_dt`` columns into one ``w_in`` shard; each
shard's x | z halves stay as stored, and each shard is padded with zero
columns to a multiple of 8 (``IN_ALIGN``: the bf16 AG+GEMM kernel reads its
weight through TMA, which needs 16-byte row strides; mamba2-2.7b's 2580
columns per rank become 2584, and ``nn/mamba`` drops the pad).  The LM head
(with tied embeddings a contiguous copy of the embedding, transposed) is
padded once, the same way, for the bf16 tile-GEMM kernel: granite's 49156
padded-vocab columns become 49160, and ``lm.logits`` keeps the first
``vocab_size``.
``params["scan"]`` (a leading layer axis per pattern position) is unstacked
into the layer list.  A shared attention mixer (``shared_attn``, zamba2) is
sharded like any attention mixer; its layers hold only their MLP.

An encoder-decoder tree (``cfg.encoder_layers``; the JAX package's
``models/encdec.init``: ``embed``, ``enc_scan``, ``enc_ln``, ``dec_scan``,
``final_ln``, an untied ``lm_head``) becomes ``embed``, ``head``,
``enc_ln``, ``final_ln``, ``enc_layers`` [{attn, ffn}] and ``dec_layers``
[{attn, cross, ffn}], the stacked ``*_scan`` leaves unstacked into the
layer lists.  A decoder layer's self-attention is sharded as above; its
cross mixer (:func:`shard_cross`) keeps ``wq`` and ``wkv`` as two per-rank
shards, each padded with zero columns to a multiple of ``IN_ALIGN``: its
queries and its keys / values project different streams, and a column
slice of one joined shard would not be contiguous (the bf16 AG+GEMM
kernel reads its weight by TMA).

A weight the JAX package packed for weight-only dequant-GEMM (its
``core/quant.PackedWeight``: codes ``[k, n]``, per-column ``scale`` /
``zero`` ``[n]``) becomes the port's rank-stacked packing through
:func:`shard_packed`: by columns the codes and the scales split alike
(``[W, k, n/W]``, ``[W, n/W]``); by rows (a row-parallel ``w_down`` / ``wo``
packed globally) the codes split by rows and the one scale per column is
replicated over the ranks (``[W, k/W, n]``, ``[W, n]``).

``unshard_params`` is the inverse of ``shard_params``: rank-stacked ->
global (the layout ``shard_params`` takes, the JAX package's with the
layers as a list).  It takes any tree of the parameters' structure
(optimizer moments too; a tree without ``head`` gives no ``lm_head``, and
a tied head is never stored: it is the embedding), so a checkpoint holds
logical arrays and restores onto another world size.  Over processes
:func:`gather_held` first joins every process's held slices into the
one-process tree (and :func:`held_like` shapes the target a restore
fills), so a checkpoint saved at any P restores at any P.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.backend.mesh import World
from repro_torch.core.quant import PackedWeight

__all__ = [
    "from_jax_params", "shard_params", "shard_layer", "unshard_params", "shard_cols", "shard_rows", "shard_attention",
    "shard_mlp",
    "shard_mamba", "shard_cross", "shard_packed", "tied_head", "check_procs", "gather_held", "held_like",
    "F32_LEAVES", "IN_ALIGN", "HELD_LEAVES",
]  # fmt: skip

# leaves kept in float32 whatever dtype the model takes (as the JAX init makes them)
F32_LEAVES = ("router", "dt_bias", "a_log", "d_skip")
# a Mamba ``w_in`` shard's width and the LM head's are padded to a multiple
# of this (16-byte bf16 rows, as TMA needs)
IN_ALIGN = 8


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


def shard_packed(packed, world: World, by: str) -> PackedWeight:
    """A global packed weight (the JAX package's ``PackedWeight`` or the
    port's, ``q [k, n]``, ``scale`` / ``zero`` ``[n]``; numpy or torch) ->
    the port's rank-stacked :class:`~repro_torch.core.quant.PackedWeight` on
    ``world``'s device, split ``by`` "cols" or "rows" (module docstring)."""
    if by not in ("cols", "rows"):
        raise ValueError(f"shard_packed: by must be 'cols' or 'rows', got {by!r}")

    def t(a, dtype):
        return torch.as_tensor(np.array(a)).to(dtype=dtype, device=world.device)

    q = t(packed.q, torch.int8)
    if by == "cols":
        n = q.shape[-1] // world.size

        def vec(a):
            return None if a is None else t(a, torch.float32).reshape(world.size, n).contiguous()

        return PackedWeight(shard_cols(q, world), vec(packed.scale), vec(packed.zero), packed.dtype)

    def rep(a):
        return None if a is None else t(a, torch.float32).unsqueeze(0).expand(world.size, -1).contiguous()

    return PackedWeight(shard_rows(q, world), rep(packed.scale), rep(packed.zero), packed.dtype)


def _pad_head(head: torch.Tensor) -> torch.Tensor:
    """[D, V] -> [D, V padded to a multiple of IN_ALIGN] (zero columns), contiguous."""
    return torch.cat([head, head.new_zeros((head.shape[0], -head.shape[1] % IN_ALIGN))], dim=1)


def tied_head(embed: torch.Tensor) -> torch.Tensor:
    """The LM head of a tied embedding: the rank-stacked ``embed`` [W, V/W,
    D] transposed to [D, V] and padded as ``shard_params`` stores it (a
    differentiable copy: the training forward takes the head from it)."""
    return _pad_head(embed.reshape(-1, embed.shape[-1]).t())


# the per-rank operands of a layer (an MoE block's expert stacks ``w_gu`` / ``w_down`` [W, E_loc, ...] and its
# shared experts' MLP ``ffn.shared``, a nested dense MLP, alike): what a world over processes keeps of its held ranks
HELD_LEAVES = {"mixer": ("wqkv", "bqkv", "wo"), "ffn": ("w_gu", "w_down")}


def shard_params(glob: Dict[str, Any], cfg, world: World) -> Dict[str, Any]:
    """Global parameters {embed, final_ln, [lm_head], layers: [...]} (an
    encoder-decoder's: module docstring) -> rank-stacked.

    On a world over processes (``world.nprocs > 1``) every process passes the
    same global tensors and keeps its held ranks' slices of each layer's
    per-rank operands (``HELD_LEAVES``: attention's, a dense MLP's, a MoE
    block's expert stacks and its shared experts' MLP), layer by layer, so
    a process never holds every rank's copy of the model; ``embed`` stays
    whole (the lookup reads every vocab row) and the head, the norms and a
    MoE router are replicated.  Attention with a dense MLP or a MoE block is
    ported there: another layer kind raises ``NotImplementedError``
    (:func:`check_procs`).  ``glob["layers"]`` is read once, in order, so it
    may be an iterator that makes each layer as it is read."""
    if world.nprocs > 1:
        check_procs(cfg, world)
        one = World(world.size, world.device)
        lo, hi = world.rank0, world.rank0 + world.held
        out = shard_params({**glob, "layers": []}, cfg, one)
        # a copy of the held rows: a slice would keep every rank's storage alive
        out["layers"] = [_map_layer(shard_layer(layer, one), lambda v: v[lo:hi].clone()) for layer in glob["layers"]]
        return out
    if cfg.encoder_layers:
        return _shard_encdec(glob, world)
    embed = glob["embed"]
    head = glob["lm_head"] if "lm_head" in glob else embed.t()
    out = {
        "embed": shard_rows(embed, world),
        "head": _pad_head(head),
        "final_ln": glob["final_ln"],
    }
    if "shared_attn" in glob:
        out["shared_attn"] = shard_attention(glob["shared_attn"], world)
    out["layers"] = [shard_layer(layer, world) for layer in glob["layers"]]
    return out


def shard_layer(layer: Dict[str, Any], world: World) -> Dict[str, Any]:
    """One global layer {mixer?, ffn?} -> rank-stacked (:func:`shard_params`)."""
    mixer = layer.get("mixer")
    if mixer is None:  # a shared_attn layer: its mixer is the shared one
        new = {}
    elif "w_xz" in mixer:
        new = {"mixer": shard_mamba(mixer, world)}
    else:
        new = {"mixer": shard_attention(mixer, world)}
    if "ffn" in layer and "router" in layer["ffn"]:
        f = layer["ffn"]
        new["ffn"] = {
            "ln": f["ln"],
            "router": f["router"],
            "w_gu": shard_rows(f["w_gu"], world),
            "w_down": shard_rows(f["w_down"], world),
        }
        if "shared" in f:
            new["ffn"]["shared"] = shard_mlp(f["shared"], world)
    elif "ffn" in layer:
        new["ffn"] = shard_mlp(layer["ffn"], world)
    return new


def check_procs(cfg, world: World, what: Optional[str] = None):
    """Raise ``NotImplementedError`` for ``what`` (default the config's name)
    unless every layer of ``cfg`` is attention with a dense MLP or a MoE
    block (with or without shared experts): the layers ported over a TP
    world of processes.  Mamba, the shared attention block and the
    encoder-decoder are refused."""
    from repro_torch.models.lm import layer_plan

    ported = {(k, f, False) for k in ("attn", "attn_local", "attn_dense") for f in ("mlp", "moe")}
    kinds = {(d.kind, d.ffn_kind, d.shared) for d in layer_plan(cfg)} if not cfg.encoder_layers else {"encdec"}
    if kinds - ported:
        raise NotImplementedError(
            f"{what or cfg.name}: layers {sorted(map(str, kinds))} over a TP world of {world.nprocs} processes are "
            "not ported (attention with a dense MLP or a MoE block is); ROADMAP queue 1 item 1 (d)"
        )


def _map_layer(layer: Dict[str, Any], fn) -> Dict[str, Any]:
    """``layer`` with ``fn`` applied to its ``HELD_LEAVES``, a nested MLP's
    (a MoE block's ``shared``) included."""

    def part(sub, names):
        return {k: part(v, names) if isinstance(v, dict) else (fn(v) if k in names else v) for k, v in sub.items()}

    return {name: part(sub, HELD_LEAVES.get(name, ())) for name, sub in layer.items()}


def _map_held(params: Dict[str, Any], fn) -> Dict[str, Any]:
    """``params`` with ``fn`` applied to each layer's ``HELD_LEAVES``."""
    return {**params, "layers": [_map_layer(layer, fn) for layer in params["layers"]]}


def gather_held(params: Dict[str, Any], cfg, world: World) -> Dict[str, Any]:
    """Inverse of the held slicing (:func:`shard_params` over processes): a
    tree of this process's shape (parameters, gradients or moments) -> the
    rank-stacked tree of every rank, each layer's ``HELD_LEAVES`` gathered
    over the world's processes (one all-gather a leaf; every process must
    call it); the identity on a one-process world.  A checkpoint's: its
    result unshards with a one-process ``World(world.size)``."""
    if world.nprocs == 1:
        return params
    check_procs(cfg, world)
    return _map_held(params, world.gather_ranks)


def held_like(params: Dict[str, Any], cfg, world: World) -> Dict[str, Any]:
    """What :func:`gather_held` returns, shaped but not filled (each held
    leaf an empty ``[W, ...]`` tensor; no traffic): the target a checkpoint
    restores the global arrays into before slicing them back."""
    if world.nprocs == 1:
        return params
    return _map_held(params, lambda v: v.new_empty((world.size,) + tuple(v.shape[1:])))


def shard_attention(mixer: Dict[str, Any], world: World) -> Dict[str, Any]:
    """Global attention weights {ln, wq, wkv, wo[, bq, bkv]} -> {ln, wqkv,
    [bqkv,] wo}: each rank's wq and wkv columns joined into one ``wqkv``
    shard, and its bq and bkv entries into one ``bqkv`` [W, cols] shard."""
    wq, wkv = shard_cols(mixer["wq"], world), shard_cols(mixer["wkv"], world)
    out = {"ln": mixer["ln"], "wqkv": torch.cat([wq, wkv], dim=-1).contiguous()}
    if "bq" in mixer:
        bq, bkv = (shard_rows(mixer[n], world) for n in ("bq", "bkv"))
        out["bqkv"] = torch.cat([bq, bkv], dim=-1).contiguous()
    out["wo"] = shard_rows(mixer["wo"], world)
    return out


def _pad_cols(w: torch.Tensor) -> torch.Tensor:
    """[..., n] -> [..., n padded to a multiple of IN_ALIGN] (zero columns), contiguous."""
    pad = -w.shape[-1] % IN_ALIGN
    return torch.cat([w, w.new_zeros(w.shape[:-1] + (pad,))], dim=-1) if pad else w.contiguous()


def shard_cross(mixer: Dict[str, Any], world: World) -> Dict[str, Any]:
    """A cross-attention mixer {ln, wq, wkv, wo}: ``wq`` and ``wkv`` by
    columns into separate per-rank shards, each padded to a multiple of
    ``IN_ALIGN`` columns; ``wo`` by rows.  (No encoder-decoder config has a
    QKV bias: one is refused.)"""
    if "bq" in mixer:
        raise NotImplementedError("repro_torch: a cross-attention mixer with a QKV bias is not ported")
    return {"ln": mixer["ln"], "wq": _pad_cols(shard_cols(mixer["wq"], world)),
            "wkv": _pad_cols(shard_cols(mixer["wkv"], world)), "wo": shard_rows(mixer["wo"], world)}  # fmt: skip


def _shard_encdec(glob: Dict[str, Any], world: World) -> Dict[str, Any]:
    """The encoder-decoder's global tree -> rank-stacked (module docstring)."""

    def layer(lp):
        out = {"attn": shard_attention(lp["attn"], world)}
        if "cross" in lp:
            out["cross"] = shard_cross(lp["cross"], world)
        out["ffn"] = shard_mlp(lp["ffn"], world)
        return out

    return {
        "embed": shard_rows(glob["embed"], world),
        "head": _pad_head(glob["lm_head"]),
        "enc_ln": glob["enc_ln"],
        "final_ln": glob["final_ln"],
        "enc_layers": [layer(lp) for lp in glob["enc_layers"]],
        "dec_layers": [layer(lp) for lp in glob["dec_layers"]],
    }


def shard_mlp(f: Dict[str, Any], world: World) -> Dict[str, Any]:
    """A dense (gated) MLP: ``w_gu`` by columns, ``w_down`` by rows."""
    return {"ln": f["ln"], "w_gu": shard_cols(f["w_gu"], world), "w_down": shard_rows(f["w_down"], world)}


def shard_mamba(mixer: Dict[str, Any], world: World) -> Dict[str, Any]:
    """A Mamba mixer by the JAX partition specs; ``w_xz`` | ``w_dt`` join per
    rank, zero-padded to a multiple of ``IN_ALIGN`` columns."""
    w_xz, w_dt = shard_cols(mixer["w_xz"], world), shard_cols(mixer["w_dt"], world)
    width = w_xz.shape[-1] + w_dt.shape[-1]
    pad = w_xz.new_zeros(w_xz.shape[:-1] + (-width % IN_ALIGN,))
    return {
        "ln": mixer["ln"],
        "w_in": torch.cat([w_xz, w_dt.to(w_xz.dtype), pad], dim=-1).contiguous(),
        "w_bc": mixer["w_bc"],
        "conv": shard_cols(mixer["conv"], world),
        "w_out": shard_rows(mixer["w_out"], world),
        **{k: shard_rows(mixer[k].float(), world) for k in ("dt_bias", "a_log", "d_skip")},
    }


def unshard_cols(w: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`shard_cols`: [W, D, n/W] -> [D, n]."""
    return w.permute(1, 0, 2).reshape(w.shape[1], -1)


def unshard_rows(w: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`shard_rows`: [W, n/W, ...] -> [n, ...]."""
    return w.reshape((-1,) + tuple(w.shape[2:]))


def _unshard_mlp(f: Dict[str, Any]) -> Dict[str, Any]:
    return {"ln": f["ln"], "w_gu": unshard_cols(f["w_gu"]), "w_down": unshard_rows(f["w_down"])}


def _unshard_attention(mixer: Dict[str, Any], cfg, world: World) -> Dict[str, Any]:
    """Inverse of :func:`shard_attention`."""
    from repro_torch.nn.attention import layout

    nq = layout(cfg, world.size).h_loc * cfg.hd
    out = {
        "ln": mixer["ln"],
        "wq": unshard_cols(mixer["wqkv"][..., :nq]),
        "wkv": unshard_cols(mixer["wqkv"][..., nq:]),
        "wo": unshard_rows(mixer["wo"]),
    }
    if "bqkv" in mixer:
        out.update(bq=unshard_rows(mixer["bqkv"][:, :nq]), bkv=unshard_rows(mixer["bqkv"][:, nq:]))
    return out


def _unshard_cross(mixer: Dict[str, Any], cfg, world: World) -> Dict[str, Any]:
    """Inverse of :func:`shard_cross` (the pad columns dropped)."""
    from repro_torch.nn.attention import layout

    lay = layout(cfg, world.size)
    nq, nkv = lay.h_loc * cfg.hd, 2 * lay.kv_loc * cfg.hd
    return {"ln": mixer["ln"], "wq": unshard_cols(mixer["wq"][..., :nq]), "wkv": unshard_cols(mixer["wkv"][..., :nkv]),
            "wo": unshard_rows(mixer["wo"])}  # fmt: skip


def _unshard_encdec(params: Dict[str, Any], cfg, world: World) -> Dict[str, Any]:
    def layer(lp):
        out = {"attn": _unshard_attention(lp["attn"], cfg, world)}
        if "cross" in lp:
            out["cross"] = _unshard_cross(lp["cross"], cfg, world)
        out["ffn"] = _unshard_mlp(lp["ffn"])
        return out

    out = {"embed": unshard_rows(params["embed"])}
    if "head" in params:
        out["lm_head"] = params["head"][:, : params["embed"].shape[0] * params["embed"].shape[1]]
    out.update(enc_ln=params["enc_ln"], final_ln=params["final_ln"])
    out["enc_layers"] = [layer(lp) for lp in params["enc_layers"]]
    out["dec_layers"] = [layer(lp) for lp in params["dec_layers"]]
    return out


def unshard_params(params: Dict[str, Any], cfg, world: World) -> Dict[str, Any]:
    """Rank-stacked -> global: the inverse of :func:`shard_params` (module
    docstring).  Every leaf is a new tensor or a view of ``params``."""
    if cfg.encoder_layers:
        return _unshard_encdec(params, cfg, world)
    out = {"embed": unshard_rows(params["embed"]), "final_ln": params["final_ln"], "layers": []}
    if "head" in params and not cfg.tie_embeddings:
        out["lm_head"] = params["head"][:, : params["embed"].shape[0] * params["embed"].shape[1]]
    if "shared_attn" in params:
        out["shared_attn"] = _unshard_attention(params["shared_attn"], cfg, world)
    for layer in params["layers"]:
        mixer = layer.get("mixer")
        if mixer is None:
            new = {}
        elif "w_in" in mixer:
            di_loc, h_loc = mixer["conv"].shape[-1], mixer["dt_bias"].shape[-1]
            new = {"mixer": {
                "ln": mixer["ln"],
                "w_xz": unshard_cols(mixer["w_in"][..., : 2 * di_loc]),
                "w_dt": unshard_cols(mixer["w_in"][..., 2 * di_loc : 2 * di_loc + h_loc]),
                "w_bc": mixer["w_bc"],
                "conv": unshard_cols(mixer["conv"]),
                "w_out": unshard_rows(mixer["w_out"]),
                **{k: unshard_rows(mixer[k]) for k in ("dt_bias", "a_log", "d_skip")},
            }}  # fmt: skip
        else:
            new = {"mixer": _unshard_attention(mixer, cfg, world)}
        f = layer.get("ffn")
        if f is not None and "router" in f:
            new["ffn"] = {"ln": f["ln"], "router": f["router"], "w_gu": unshard_rows(f["w_gu"]),
                          "w_down": unshard_rows(f["w_down"])}  # fmt: skip
            if "shared" in f:
                new["ffn"]["shared"] = _unshard_mlp(f["shared"])
        elif f is not None:
            new["ffn"] = _unshard_mlp(f)
        out["layers"].append(new)
    return out


def _tensors(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tensors(v, device, torch.float32 if k in F32_LEAVES else dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree, dtype=np.float32, copy=True))
    return t.to(device=device, dtype=dtype)


def _unit(tree, u: int):
    """Unit ``u`` of a scanned layer (every leaf's leading axis indexed)."""
    if isinstance(tree, dict):
        return {k: _unit(v, u) for k, v in tree.items()}
    return tree[u]


def from_jax_params(np_params: Dict[str, Any], cfg, world: World, dtype: Optional[torch.dtype] = None):
    """The JAX package's ``lm.init`` pytree (``encdec.init``'s for an
    encoder-decoder config; numpy leaves) -> port parameters.

    ``dtype`` defaults to float32 (the leaves of ``F32_LEAVES`` are float32
    always); leaves are moved to ``world.device``.
    """
    from repro_torch.models.lm import layer_plan

    dtype = dtype or torch.float32
    tree = _tensors(np_params, world.device, dtype)
    if cfg.encoder_layers:
        glob = {k: tree[k] for k in ("embed", "lm_head", "enc_ln", "final_ln")}
        for part, n in (("enc", cfg.encoder_layers), ("dec", cfg.n_layers)):
            glob[f"{part}_layers"] = [_unit(tree[f"{part}_scan"], u) for u in range(n)]
        return shard_params(glob, cfg, world)
    layers = list(tree.get("prefix", []))
    scan = tree.get("scan")
    if scan:
        n_units = next(iter(next(iter(scan[0].values())).values())).shape[0]  # a leaf's layer axis
        for u in range(n_units):
            for unit_layer in scan:
                layers.append(_unit(unit_layer, u))
    layers += list(tree.get("suffix", []))
    if len(layers) != len(layer_plan(cfg)):
        raise ValueError(f"got {len(layers)} layers for a {cfg.n_layers}-layer config")
    glob = {"embed": tree["embed"], "final_ln": tree["final_ln"], "layers": layers}
    for name in ("lm_head", "shared_attn"):
        if name in tree:
            glob[name] = tree[name]
    return shard_params(glob, cfg, world)
