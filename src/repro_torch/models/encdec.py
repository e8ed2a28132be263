"""Encoder-decoder LM (the seamless-m4t backbone) — the port of
``repro/models/encdec.py``.

Encoder: non-causal self-attention + MLP over stub frame embeddings
(``models/frontends``), then a final norm.  Decoder: causal
self-attention, cross-attention to the encoder output, MLP.  Every
projection of both stacks runs through the AG+GEMM / GEMM+RS pair (the
fused kernels on the card), and so does the cross-attention's K / V gather
of the encoder stream (``nn/attention.apply_cross_seq``); attention is the
flash kernel on the fused backend (non-causal in the encoder and the
cross-attention, Sq != Sk in the latter).  A Python loop over the layer
lists replaces the JAX package's ``lax.scan`` over ``enc_scan`` /
``dec_scan``.  Parameters are rank-stacked (``convert.py``):

  embed      [W, V_pad/W, D]     head [D, V_pad] (untied)
  enc_ln, final_ln  [D]
  enc_layers [{"attn": {ln, wqkv, wo}, "ffn": {ln, w_gu, w_down}}, ...]
  dec_layers [{"attn": ..., "cross": {ln, wq, wkv, wo}, "ffn": ...}, ...]

Decoding: :func:`build_cross_caches` projects the encoder output once per
layer; :func:`decode_step` then advances the decoder with its self-attention
KV caches (``nn/attention.apply_decode``) and the fixed cross K / V
(``nn/attention.apply_cross_decode``).

Training differentiates :func:`forward` with ``torch.autograd`` as
``models/lm`` does; ``remat_policy`` other than ``"none"`` recomputes each
layer of both stacks in the backward.  :func:`grad_masks` is the
reference's (none), :func:`decay_mask` its rule (every leaf of the scanned
stacks and the matrices; not ``enc_ln`` / ``final_ln``), :func:`sync_grads`
its kv-copy averaging.  :func:`specs` / :func:`cache_specs` are the JAX
package's partition specs on the port's leaves (``parallel/sharding``).
With ``pc.data`` (ZeRO-3) each layer of both stacks, a decoder layer's
cross mixer in :func:`build_cross_caches`, the embedding and the head are
gathered at their use (``ParallelContext.use_gather``), as in
``models/lm``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.models.lm import REMAT_POLICIES, logits, padded_vocab, top_specs
from repro_torch.nn import attention, ffn
from repro_torch.nn.layers import emb_init, rms_norm
from repro_torch.parallel.context import ParallelContext
from repro_torch.parallel.sharding import Spec

__all__ = [
    "init", "specs", "cache_specs", "encode", "forward", "init_caches", "build_cross_caches", "decode_step", "trainable", "with_tied",
    "check_trainable", "grad_masks", "decay_mask", "sync_grads",
]  # fmt: skip


def init(cfg, world, generator: torch.Generator, dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Seeded random parameters at the config's size, built on ``device``
    (default: the world's) with the JAX package's init rules and layout."""
    from repro_torch.convert import shard_params

    device = torch.device(device) if device is not None else world.device
    tp = world.size

    def layer(cross: bool) -> dict:
        out = {"attn": attention.init(cfg, tp, generator, dtype, device)}
        if cross:
            out["cross"] = attention.init(cfg, tp, generator, dtype, device)
        out["ffn"] = ffn.init(cfg, generator, dtype, device)
        return out

    glob = {
        "embed": emb_init((padded_vocab(cfg, tp), cfg.d_model), generator, dtype, device),
        "enc_layers": [layer(False) for _ in range(cfg.encoder_layers)],
        "enc_ln": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "dec_layers": [layer(True) for _ in range(cfg.n_layers)],
        "final_ln": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "lm_head": emb_init((cfg.d_model, padded_vocab(cfg, tp)), generator, dtype, device),
    }
    return shard_params(glob, cfg, world)


def specs(cfg, pc: ParallelContext) -> dict:
    """The specs of :func:`init`'s tree (``repro/models/encdec.specs``):
    ``embed`` ``P("model", dp)``, ``head`` ``P(dp, "model")``, every layer's
    blocks (a decoder layer's cross mixer as two column shards)."""
    enc, dec = _layer_specs(cfg, pc)
    top = top_specs(pc)
    return {
        "embed": top["embed"], "head": top["head"], "enc_ln": Spec(None), "final_ln": top["final_ln"],
        "enc_layers": [dict(enc) for _ in range(cfg.encoder_layers)], "dec_layers": [dict(dec) for _ in range(cfg.n_layers)],
    }  # fmt: skip


def _layer_specs(cfg, pc: ParallelContext) -> tuple:
    """(an encoder layer's specs, a decoder layer's)."""
    dp = pc.dp_spec()
    enc = {"attn": attention.specs(cfg, pc.tp, dp), "ffn": ffn.specs(cfg, pc.tp, dp)}
    dec = {"attn": attention.specs(cfg, pc.tp, dp), "cross": attention.cross_specs(cfg, pc.tp, dp),
           "ffn": ffn.specs(cfg, pc.tp, dp)}  # fmt: skip
    return enc, dec


def _gathered(pc: ParallelContext, tree, spec_fn):
    """``tree`` gathered for one use over ``pc.data`` (``pc.use_gather``
    with the specs ``spec_fn()``); ``tree`` itself without it."""
    return tree if pc.data is None else pc.use_gather(tree, spec_fn())


def cache_specs(cfg, pc: ParallelContext) -> dict:
    """The specs of :func:`init_caches`' tree (``repro/models/encdec.cache_specs``)."""
    sp = attention.cache_specs(pc.dp_spec())
    return {"self": [sp] * cfg.n_layers, "cross": [sp] * cfg.n_layers}


def _check_seq(pc: ParallelContext, s: int, what: str):
    if s % pc.tp:
        raise ValueError(f"{what} length {s} must divide over the {pc.tp} ranks (sequence-parallel residual)")


def _run(fn, x, remat_policy: str):
    """``fn(x)``, recomputed in the backward unless ``remat_policy`` is "none"."""
    if remat_policy == "none":
        return fn(x)
    return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)


def _encode(params: dict, cfg, pc: ParallelContext, embeds: torch.Tensor, remat_policy: str) -> torch.Tensor:
    """embeds [B, S_enc, D] -> the normed encoder output, sequence-sharded
    [W, B, S_enc / W, D]."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r}; one of {REMAT_POLICIES}")
    _check_seq(pc, embeds.shape[1], "encoder")
    x = pc.world.shard(embeds.to(params["embed"].dtype), dim=1)
    for p in params["enc_layers"]:

        def body(h, p=p):
            p = _gathered(pc, p, lambda: _layer_specs(cfg, pc)[0])  # inside the remat: gathered again there
            h = attention.apply_seq(p["attn"], h, pc, cfg, causal=False)
            return ffn.apply_seq(p["ffn"], h, pc, cfg)

        x = _run(body, x, remat_policy)
    return rms_norm(x, params["enc_ln"], cfg.norm_eps)


def encode(params: dict, cfg, pc: ParallelContext, embeds: torch.Tensor, remat_policy: str = "none") -> torch.Tensor:
    """embeds: [B, S_enc, D] stub frame embeddings -> [B, S_enc, D] (global)."""
    return pc.world.unshard(_encode(params, cfg, pc, embeds, remat_policy), dim=1)


def _embed(params: dict, tokens: torch.Tensor, pc: ParallelContext) -> torch.Tensor:
    """Token embeddings [B, S, D] (no scale, as the reference's); ``embed``
    gathered at its use under ``pc.data``."""
    embed = _gathered(pc, params["embed"], lambda: top_specs(pc)["embed"])
    return torch.nn.functional.embedding(tokens, embed.reshape(-1, embed.shape[-1]))


def forward(
    params: dict, cfg, pc: ParallelContext, tokens: torch.Tensor, embeds: Optional[torch.Tensor] = None,
    remat_policy: str = "none",
):  # fmt: skip
    """tokens: decoder input ids [B, S_dec]; embeds: encoder frames [B,
    S_enc, D].  Returns (logits [B, S_dec, vocab], aux = 0)."""
    if embeds is None:
        raise ValueError("encdec.forward needs the encoder frames (embeds=)")
    enc = _encode(params, cfg, pc, embeds, remat_policy)
    _check_seq(pc, tokens.shape[1], "decoder")
    x = pc.world.shard(_embed(params, tokens, pc), dim=1)  # [W, B, s_loc, D]
    for p in params["dec_layers"]:

        def body(h, p=p):
            p = _gathered(pc, p, lambda: _layer_specs(cfg, pc)[1])
            h = attention.apply_seq(p["attn"], h, pc, cfg, causal=True)
            h = attention.apply_cross_seq(p["cross"], h, enc, pc, cfg)
            return ffn.apply_seq(p["ffn"], h, pc, cfg)

        x = _run(body, x, remat_policy)
    out = logits(params, cfg, pc, pc.world.unshard(x, dim=1))
    return out, torch.zeros((), dtype=torch.float32, device=out.device)


# ---- decode -----------------------------------------------------------------


def init_caches(cfg, pc: ParallelContext, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
    """{"self": one KV cache per decoder layer ``[W, B, kv_loc, max_len,
    hd]``, "cross": one zero cross K / V per layer ``[W, B, kv_loc,
    enc_len, hd]``} (:func:`build_cross_caches` gives the real ones)."""
    lay = attention.layout(cfg, pc.tp)
    shape = (pc.tp, batch, lay.kv_loc, cfg.enc_len, cfg.hd)
    return {
        "self": [attention.init_cache(cfg, pc.tp, batch, max_len, dtype, pc.device) for _ in range(cfg.n_layers)],
        "cross": [{n: torch.zeros(shape, dtype=dtype, device=pc.device) for n in ("k", "v")}
                  for _ in range(cfg.n_layers)],
    }  # fmt: skip


def build_cross_caches(params: dict, cfg, pc: ParallelContext, enc: torch.Tensor) -> list:
    """Each decoder layer's cross K / V from the encoder output enc [B,
    S_enc, D] (:func:`encode`), through the AG+GEMM of its ``wkv``."""
    enc = pc.world.shard(enc, dim=1)
    cross = lambda: _layer_specs(cfg, pc)[1]["cross"]  # noqa: E731
    return [attention.build_cross_cache(_gathered(pc, p["cross"], cross), enc, pc, cfg) for p in params["dec_layers"]]


def decode_step(params: dict, caches: dict, cfg, pc: ParallelContext, tokens: torch.Tensor, cache_len):
    """One decoder step with precomputed cross caches: tokens [B, C],
    ``cache_len`` the tokens already in each self cache (int or [B]).
    Returns (logits [B, C, vocab], caches), the self caches updated in
    place."""
    x = _embed(params, tokens, pc)
    for p, sc, cc in zip(params["dec_layers"], caches["self"], caches["cross"]):
        p = _gathered(pc, p, lambda: _layer_specs(cfg, pc)[1])
        x, _ = attention.apply_decode(p["attn"], x, sc, cache_len, pc, cfg)
        x = attention.apply_cross_decode(p["cross"], x, cc, pc, cfg)
        x = ffn.apply_decode(p["ffn"], x, pc, cfg)
    return logits(params, cfg, pc, x), caches


# ---------------------------------------------------------------------------
# training: the trainable tree, masks, weight decay, kv-copy sync
# ---------------------------------------------------------------------------


def trainable(params: dict, cfg) -> dict:
    """Every parameter (the head is untied)."""
    return params


def with_tied(tree: dict, cfg) -> dict:
    return tree


def check_trainable(cfg, pc: ParallelContext):
    """Raise for what the training path does not take: fused seams (the
    reference's encoder-decoder has none) and a TP world over processes."""
    pc.single_process(f"training the encoder-decoder {cfg.name}")
    if pc.fuse_seams:
        raise NotImplementedError(f"repro_torch: training {cfg.name} with fuse_seams is not ported")


def grad_masks(cfg, pc: ParallelContext):
    """None: the reference's ``encdec.grad_masks`` masks nothing."""
    return None


def decay_mask(tree: dict, cfg) -> dict:
    """The reference's rule (ndim >= 2 in its own layout): the scanned
    stacks' leaves all carry a layer axis, so every leaf of a layer is
    decayed, as are ``embed`` and the head; ``enc_ln`` and ``final_ln`` are
    not."""

    def leaves(node, value):
        if isinstance(node, dict):
            return {k: leaves(v, value) for k, v in node.items()}
        if isinstance(node, list):
            return [leaves(v, value) for v in node]
        return value

    return {k: leaves(v, k not in ("enc_ln", "final_ln")) for k, v in tree.items()}


def sync_grads(grads: dict, cfg, pc: ParallelContext) -> dict:
    """Average the kv copies' gradients (GQA with fewer kv heads than
    ranks) in every self- and cross-attention block of both stacks
    (``repro/models/encdec.sync_grads``); unchanged when ``rep == 1``."""
    if not cfg.n_heads or attention.layout(cfg, pc.tp).rep == 1:
        return grads
    out = dict(grads)
    for part in ("enc_layers", "dec_layers"):
        out[part] = [{k: attention.sync_grads(v, cfg, pc.tp) if k in ("attn", "cross") else v for k, v in g.items()}
                     for g in grads[part]]  # fmt: skip
    return out
