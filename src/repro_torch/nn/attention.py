"""GQA attention block — TP over heads, sequence-parallel residual stream.

The port of ``repro/nn/attention.py`` for the dense serve path.

Prefill (``apply_seq``): the AG+GEMM producer gathers the sequence-sharded
residual stream while projecting to each rank's heads, attention runs per
rank on its head shard, and the output projection is the GEMM+RS consumer.
With ``pc.backend == "fused"`` attention is the flash kernel (the JAX
package runs its XLA twin ``chunked_attention`` here); with ``"eager"`` it
is ``chunked_attention``, the kernel's plain version.

Sequence-parallel prefill (``apply_seq_ring``, paper Fig. 6 layer form):
only the query projection goes through the AG+GEMM producer; K/V project
locally on each rank's sequence shard and rotate through
``pc.ring_attention`` (flash attention consuming each arrived tile on the
fused backend); the output projection is the same GEMM+RS consumer.

Seam fusion (``pc.fuse_seams``, driven by ``models/lm``): ``seam_proj``
gives the (glue, fused ``wqkv``) pair an upstream RS fuses into this
layer's qkv AG, ``apply_seq(qkv=)`` takes that projection, and
``next_proj=`` on either form fuses the output-projection RS into the next
consumer's AG (``pc.matmul_rs_ag``).

Decode (``apply_decode``): activations are replicated over the ranks, the
projections are local per-rank matmuls with a ``psum`` epilogue, and the KV
cache ``[W, B, kv_loc, S_max, hd]`` is sharded over heads.  The chunk's k/v
are written into the cache in place, after the attention reads it.

Cross-attention (the encoder-decoder, ``models/encdec``): a cross mixer
keeps ``wq`` [W, D, h_loc * hd] and ``wkv`` [W, D, 2 kv_loc * hd] as two
per-rank shards (each zero-padded to a multiple of 8 columns where needed,
``convert.IN_ALIGN``), because its queries and its keys / values project
different streams.  ``apply_cross_seq`` gathers the decoder stream into
the queries and the encoder stream into K / V, each through the AG+GEMM
producer (the latter the paper's cross-attention KV gather), runs
non-causal attention with no RoPE (flash on the fused backend, Sq != Sk)
and the GEMM+RS output projection; ``build_cross_cache`` keeps the
encoder's K / V for decoding, and ``apply_cross_decode`` attends to them
with per-rank products and a ``psum`` epilogue.

A config with ``qkv_bias`` (Qwen2) adds a per-rank ``bqkv`` [W, (h_loc + 2
kv_loc) * hd] — the reference's ``bq`` and ``bkv`` shards joined like
``wqkv``'s columns (each rank's KV part packed [K heads || V heads]) — to
every qkv projection after its GEMM: after the AG+GEMM in ``apply_seq``, on
the gathered queries and the local K/V in ``apply_seq_ring``, in decode.
A projection handed over by an upstream fused seam is pre-bias, so the
consumer adds it there too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import chunked_attention, flash_attention, route
from repro_torch.nn.layers import GQALayout, gqa_layout, he_init, rms_norm, rope, sync_kv_grad
from repro_torch.parallel.sharding import Spec

__all__ = [
    "init",
    "specs",
    "cross_specs",
    "cache_specs",
    "apply_seq",
    "apply_seq_ring",
    "apply_decode",
    "apply_cross_seq",
    "build_cross_cache",
    "apply_cross_decode",
    "init_cache",
    "chunked_attention",
    "layout",
    "seam_proj",
    "grad_masks",
    "sync_grads",
]

NEG_INF = -1e30


def layout(cfg, tp: int) -> GQALayout:
    return gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp)


def init(cfg, tp: int, generator: torch.Generator, dtype: torch.dtype, device) -> dict:
    """Global (unsharded) parameters in the JAX package's layout: padded heads
    are zero, and kv heads are stored expanded with ``rep`` copies."""
    lay = layout(cfg, tp)
    d, hd = cfg.d_model, cfg.hd
    f32 = torch.float32
    wq = he_init((d, lay.h_pad, hd), generator, f32, device, fan_in=d)
    wkv = he_init((d, lay.kv_pad, 2 * hd), generator, f32, device, fan_in=d)
    wo = he_init((lay.h_pad, hd, d), generator, f32, device, fan_in=lay.h_pad * hd)
    head_active = (torch.arange(lay.h_pad, device=device) < cfg.n_heads).to(f32)
    kv_active = (torch.arange(lay.kv_pad, device=device) < cfg.n_kv_heads).to(f32)
    wq = wq * head_active[None, :, None]
    wkv = (wkv * kv_active[None, :, None]).repeat_interleave(lay.rep, dim=1)
    wo = wo * head_active[:, None, None]
    return {
        "ln": torch.zeros((d,), dtype=dtype, device=device),
        "wq": wq.reshape(d, lay.h_pad * hd).to(dtype),
        "wkv": wkv.reshape(d, lay.kv_store * 2 * hd).to(dtype),
        "wo": wo.reshape(lay.h_pad * hd, d).to(dtype),
        **({"bq": torch.zeros((lay.h_pad * hd,), dtype=dtype, device=device),
            "bkv": torch.zeros((lay.kv_store * 2 * hd,), dtype=dtype, device=device)} if cfg.qkv_bias else {}),
    }  # fmt: skip


def specs(cfg, tp: int, dp) -> dict:
    """The specs of the port's attention leaves (``repro/nn/attention.specs``
    on the rank-stacked layout): ``wqkv`` [W, D, cols] joins ``wq`` / ``wkv``
    (``P(dp, "model")``: D over the data axes ``dp``), ``wo`` [W, rows, D]
    (``P("model", dp)``), ``bqkv`` [W, cols] (``P("model")``), ``ln``
    replicated."""
    s = {"ln": Spec(None), "wqkv": Spec("model", dp, None), "wo": Spec("model", None, dp)}
    if cfg.qkv_bias:
        s["bqkv"] = Spec("model", None)
    return s


def cross_specs(cfg, tp: int, dp) -> dict:
    """A cross mixer's specs: ``wq`` / ``wkv`` as two column shards (each
    ``P(dp, "model")`` in the JAX package), ``wo`` by rows."""
    return {"ln": Spec(None), "wq": Spec("model", dp, None), "wkv": Spec("model", dp, None),
            "wo": Spec("model", None, dp)}  # fmt: skip


def cache_specs(dp) -> dict:
    """The KV cache [W, B, kv_loc, L, hd]: heads over the ranks, the batch over
    the data axes (``repro/nn/attention.cache_specs``)."""
    return {"k": Spec("model", dp, None, None, None), "v": Spec("model", dp, None, None, None)}


def grad_masks(cfg, tp: int, device=None):
    """0/1 float32 masks keeping padded heads at zero on the port's layout
    (``repro/nn/attention.grad_masks``): ``wqkv`` [W, 1, cols] (each rank's
    q columns, then its kv columns), ``wo`` [W, h_loc * hd, 1] and, with
    ``qkv_bias``, ``bqkv`` [W, cols]; None when no head is padded."""
    lay = layout(cfg, tp)
    hd = cfg.hd
    if lay.h_pad == cfg.n_heads and lay.kv_pad == cfg.n_kv_heads:
        return None
    qm = (torch.arange(lay.h_pad, device=device) < cfg.n_heads).float().repeat_interleave(hd)
    kvm = (torch.arange(lay.kv_store, device=device) // lay.rep < cfg.n_kv_heads).float().repeat_interleave(2 * hd)
    qm, kvm = qm.view(tp, 1, -1), kvm.view(tp, 1, -1)
    masks = {"ln": None, "wqkv": torch.cat([qm, kvm], dim=-1), "wo": qm.transpose(1, 2)}
    if cfg.qkv_bias:
        masks["bqkv"] = masks["wqkv"][:, 0]
    return masks


def sync_grads(grads: dict, cfg, tp: int, world=None) -> dict:
    """Average the kv copies' gradients in one attention block's ``wqkv``
    (and ``bqkv``) gradient (:func:`~repro_torch.nn.layers.sync_kv_grad` on
    its kv columns), or in a cross mixer's ``wkv``; the block unchanged
    when ``rep == 1``.  ``world`` over processes: the gradients hold its
    ranks, and the kv columns of every rank are gathered over the processes
    (one all-gather a leaf), averaged as on one process and sliced back."""
    lay = layout(cfg, tp)
    if lay.rep == 1:
        return grads
    nq = lay.h_loc * cfg.hd

    def synced(kv):
        if world is None or world.nprocs == 1:
            return sync_kv_grad(kv, lay)
        return sync_kv_grad(world.gather_ranks(kv), lay)[world.rank0 : world.rank0 + world.held]

    out = dict(grads)
    for name in ("wqkv", "bqkv"):
        if name in grads:
            g = grads[name]
            out[name] = torch.cat([g[..., :nq], synced(g[..., nq:])], dim=-1)
    if "wkv" in grads:
        out["wkv"] = synced(grads["wkv"])
    return out


def _add_bias(params: dict, qkv: torch.Tensor, cols: slice = slice(None)) -> torch.Tensor:
    """``qkv`` [W, ..., n] plus the columns ``cols`` of the per-rank
    ``bqkv`` [W, n] (unchanged without a bias)."""
    if "bqkv" not in params:
        return qkv
    b = params["bqkv"][:, cols]
    return qkv + b.reshape((b.shape[0],) + (1,) * (qkv.dim() - 2) + (b.shape[-1],))


def _split_qkv(qkv: torch.Tensor, lay: GQALayout, hd: int):
    """[..., (h_loc + 2 kv_loc) * hd] -> q [..., h_loc, hd], k/v [..., kv_loc, hd]."""
    qkv = qkv.reshape(qkv.shape[:-1] + (lay.h_loc + 2 * lay.kv_loc, hd))
    q = qkv[..., : lay.h_loc, :]
    k = qkv[..., lay.h_loc : lay.h_loc + lay.kv_loc, :]
    v = qkv[..., lay.h_loc + lay.kv_loc :, :]
    return q, k, v


def seam_proj(params: dict, cfg):
    """(glue, w) for fusing an upstream RS into this layer's qkv AG:
    ``glue`` is the pre-attention rms_norm, ``w`` the fused ``wqkv``; the
    bias stays with the consumer (``apply_seq`` adds it to the handed-over
    projection)."""
    return (lambda y: rms_norm(y, params["ln"], cfg.norm_eps)), params["wqkv"]


def _no_ep(ep, what: str):
    if ep:
        raise ValueError(
            f"attention.{what} has no expert-parallel form; ep= selects the dispatch/combine a2a in moe.apply_seq only"
        )


def _with_quant(pc, quant):
    """``pc`` with ``quant`` pinned (``ParallelContext.quant``), or as it is for None."""
    return pc if quant is None or pc.quant == quant else dataclasses.replace(pc, quant=quant)


def _with_tune(pc, tune: bool):
    """``pc`` with ``tune=True`` when asked (``ParallelContext.tune``), else as it is."""
    return dataclasses.replace(pc, tune=True) if tune and not pc.tune else pc


def _out_proj(o, params, x, pc, next_proj):
    """The output projection's GEMM+RS plus the residual, or with
    ``next_proj=(glue, w)`` the seam ``(y, next_out)``."""
    if next_proj is None:
        return x + pc.matmul_rs(o, params["wo"])  # GEMM + RS -> [W, B, s_loc, D]
    glue, w_next = next_proj
    return pc.matmul_rs_ag(o, params["wo"], w_next, residual=x, glue=glue)


def apply_seq(
    params: dict,
    x: torch.Tensor,
    pc,
    cfg,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    rope_theta: Optional[float] = None,
    attn_chunk: int = 1024,
    return_kv: bool = False,
    qkv: Optional[torch.Tensor] = None,
    next_proj=None,
    ep=None,
    quant=None,
    tune: bool = False,
):
    """x: [W, B, s_loc, D] sequence-sharded -> [W, B, s_loc, D] (+ residual);
    with ``return_kv`` also the per-rank KV ``[W, B, kv_loc, S, hd]``.

    ``qkv``: this layer's gathered projection from an upstream fused seam
    (skips the norm and the AG here; pre-bias, so the bias is added here).  ``next_proj=(glue, w)``: fuse the
    output-projection RS with the next consumer's AG; the return value is
    then ``(y, next_out)`` (``(y, next_out, kv)`` with ``return_kv``).
    ``ep`` must be falsy.
    ``quant`` pins a :class:`~repro_torch.core.quant.QuantSpec` wire encoding
    on this block's collectives (``ParallelContext.quant``); the weights may
    be :class:`~repro_torch.core.quant.PackedWeight` (``pack_weight``).
    ``tune=True`` has this block's collectives resolve tuned channels per
    shape (``ParallelContext.tune``).
    """
    _no_ep(ep, "apply_seq")
    pc = _with_tune(_with_quant(pc, quant), tune)
    lay = layout(cfg, pc.tp)
    hd = cfg.hd
    world, b = x.shape[0], x.shape[1]
    if qkv is None:
        h = rms_norm(x, params["ln"], cfg.norm_eps)
        qkv = pc.ag_matmul(h, params["wqkv"])  # [W, B, S, (h_loc + 2 kv_loc) * hd]
    qkv = _add_bias(params, qkv)
    s_glob = qkv.shape[2]
    q, k, v = _split_qkv(qkv, lay, hd)
    positions = torch.arange(s_glob, device=x.device)
    q, k = rope(q, k, positions, rope_theta if rope_theta is not None else cfg.rope_theta)
    # [W, B, S, n, hd] -> [W, B, n, S, hd]; contiguous, so the kernel's [W B n, S, hd] is too (at W B = 1 a
    # reshape of the permuted view would be a strided view)
    q = q.permute(0, 1, 3, 2, 4).contiguous()
    k = k.permute(0, 1, 3, 2, 4).contiguous()
    v = v.permute(0, 1, 3, 2, 4).contiguous()
    if pc.fused:
        if pc.attn_p_bf16 and route(q.dtype, hd) != "wgmma":
            raise NotImplementedError(
                f"attn_p_bf16 on the fused backend needs the wgmma route (bf16 at head dims 64 / 80 / 128 / 256, "
                f"which takes P in bf16); {q.dtype} at head dim {hd} runs the float32 FMA kernel, which keeps P "
                "in float32"
            )
        # rank and batch fold into the head dimension of the kernel
        o = flash_attention(
            q.reshape(world * b * lay.h_loc, s_glob, hd),
            k.reshape(world * b * lay.kv_loc, s_glob, hd),
            v.reshape(world * b * lay.kv_loc, s_glob, hd),
            causal=causal,
            window=window,
        )
    else:
        o = chunked_attention(
            q.reshape(world * b, lay.h_loc, s_glob, hd),
            k.reshape(world * b, lay.kv_loc, s_glob, hd),
            v.reshape(world * b, lay.kv_loc, s_glob, hd),
            causal=causal,
            window=window,
            chunk=min(attn_chunk, s_glob),
            p_bf16=pc.attn_p_bf16,
        )
    o = o.reshape(world, b, lay.h_loc, s_glob, hd).permute(0, 1, 3, 2, 4).reshape(world, b, s_glob, lay.h_loc * hd)
    y = _out_proj(o, params, x, pc, next_proj)
    if return_kv:
        return (*y, {"k": k, "v": v}) if next_proj is not None else (y, {"k": k, "v": v})
    return y


def apply_seq_ring(
    params: dict,
    x: torch.Tensor,
    pc,
    cfg,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    rope_theta: Optional[float] = None,
    next_proj=None,
    ep=None,
    quant=None,
    tune: bool = False,
):
    """AG-Q + ring-KV attention block: x [W, B, s_loc, D] -> [W, B, s_loc, D]
    (residual added), equal to :func:`apply_seq` up to summation order;
    ``next_proj`` and ``ep`` as in :func:`apply_seq`.

    The query columns of each rank's ``wqkv`` go through ``pc.ag_matmul``
    (copied contiguous: the bf16 AG+GEMM kernel reads its weight by TMA);
    K/V project locally on the sequence shard (a plain product, outside any
    kernel, as in the JAX package).  MQA (``kv_pad == 1``) rings the one
    shared head; GQA gathers every rank's KV columns (each packs [K heads ||
    V heads]), drops the layout's replicated copies and projects every
    distinct KV head, so the tiles carry all groups and
    ``pc.ring_attention(kv_select=True)`` has each rank consume its own.
    RoPE takes global positions: ``0..S-1`` for the gathered queries,
    ``rank * s_loc + j`` for the local keys.  ``quant`` pins a QuantSpec wire
    encoding on the block's collectives (the ring's KV tiles included);
    ``tune=True`` as in :func:`apply_seq` (the ring's channel too).
    """
    _no_ep(ep, "apply_seq_ring")
    pc = _with_tune(_with_quant(pc, quant), tune)
    lay = layout(cfg, pc.tp)
    hd = cfg.hd
    world, b, s_loc, d = x.shape
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    nq = lay.h_loc * hd
    q = pc.ag_matmul(h, params["wqkv"][..., :nq].contiguous())  # [W, B, S, h_loc * hd] gathered
    q = _add_bias(params, q, slice(None, nq))
    wkv = params["wqkv"][..., nq:]  # [W, D, 2 kv_loc hd]: per rank [K heads || V heads]
    if lay.kv_pad == 1:
        kv = _add_bias(params, torch.matmul(h, wkv[:, None]), slice(nq, None))
        kv = kv.reshape(world, b, s_loc, 2 * lay.kv_loc, hd)
        k, v = kv[..., : lay.kv_loc, :], kv[..., lay.kv_loc :, :]
    else:
        # rank-major gather of the kv columns: reshape, split K / V, then the
        # (rank, local head) axes flatten into the layout's expanded head order
        wkv = pc.all_gather_seq(wkv, 1).reshape(world, d, pc.tp, 2, lay.kv_loc, hd)
        wk = wkv[:, :, :, 0].reshape(world, d, lay.kv_store, hd)[:, :, :: lay.rep]
        wv = wkv[:, :, :, 1].reshape(world, d, lay.kv_store, hd)[:, :, :: lay.rep]
        k = torch.einsum("wbsd,wdhe->wbshe", h, wk)  # [W, B, s_loc, kv_pad, hd]
        v = torch.einsum("wbsd,wdhe->wbshe", h, wv)
        if "bqkv" in params:  # the kv bias gathered and de-duplicated the same way
            bkv = pc.all_gather_seq(params["bqkv"][:, nq:], 0).reshape(world, pc.tp, 2, lay.kv_loc, hd)
            bk = bkv[:, :, 0].reshape(world, lay.kv_store, hd)[:, :: lay.rep]
            bv = bkv[:, :, 1].reshape(world, lay.kv_store, hd)[:, :: lay.rep]
            k, v = k + bk[:, None, None], v + bv[:, None, None]
    s_glob = q.shape[2]
    q = q.reshape(world, b, s_glob, lay.h_loc, hd)
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    q, _ = rope(q, q, torch.arange(s_glob, device=x.device), theta)
    ranks = torch.arange(pc.rank0, pc.rank0 + world, device=x.device)  # the held ranks' global ids
    k_pos = ranks[:, None, None] * s_loc + torch.arange(s_loc, device=x.device)
    _, k = rope(k, k, k_pos, theta)  # positions [W, 1, s_loc]: global per rank
    q, k, v = (t.permute(0, 1, 3, 2, 4).contiguous() for t in (q, k, v))  # [W, B, heads, S, hd]
    o = pc.ring_attention(q, k, v, causal=causal, window=window, kv_select=lay.kv_pad > 1)
    o = o.permute(0, 1, 3, 2, 4).reshape(world, b, s_glob, nq)
    return _out_proj(o, params, x, pc, next_proj)


def _cross_kv(params: dict, enc: torch.Tensor, pc, lay: GQALayout, hd: int):
    """K / V of the encoder stream enc [W, B, se_loc, D]: each [W, B,
    kv_loc, Se, hd] (contiguous), from one AG+GEMM of ``wkv`` (per rank [K
    heads || V heads])."""
    world, b = enc.shape[:2]
    kv = pc.ag_matmul(enc, params["wkv"])[..., : 2 * lay.kv_loc * hd]  # the shard's zero pad columns dropped
    kv = kv.reshape(world, b, kv.shape[2], 2 * lay.kv_loc, hd)
    k = kv[..., : lay.kv_loc, :].permute(0, 1, 3, 2, 4).contiguous()
    v = kv[..., lay.kv_loc :, :].permute(0, 1, 3, 2, 4).contiguous()
    return k, v


def apply_cross_seq(params: dict, x: torch.Tensor, enc: torch.Tensor, pc, cfg) -> torch.Tensor:
    """Cross-attention (``repro/nn/attention.apply_cross_seq``): queries from
    the decoder stream x [W, B, sd_loc, D], keys / values from the encoder
    stream enc [W, B, se_loc, D] (both sequence-sharded; enc already
    normed) -> [W, B, sd_loc, D] (+ residual).  No RoPE, no mask: flash
    attention with ``causal=False`` and Sq != Sk on the fused backend,
    ``chunked_attention`` on the eager one; the output projection is the
    GEMM+RS consumer."""
    lay = layout(cfg, pc.tp)
    hd = cfg.hd
    world, b = x.shape[:2]
    nq = lay.h_loc * hd
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    q = pc.ag_matmul(h, params["wq"])[..., :nq]  # [W, B, Sd, h_loc * hd]
    k, v = _cross_kv(params, enc, pc, lay, hd)  # [W, B, kv_loc, Se, hd]
    sd, se = q.shape[2], k.shape[3]
    q = q.reshape(world, b, sd, lay.h_loc, hd).permute(0, 1, 3, 2, 4)
    if pc.fused:
        o = flash_attention(
            q.reshape(world * b * lay.h_loc, sd, hd),
            k.reshape(world * b * lay.kv_loc, se, hd),
            v.reshape(world * b * lay.kv_loc, se, hd),
            causal=False,
        )
    else:
        o = chunked_attention(
            q.reshape(world * b, lay.h_loc, sd, hd),
            k.reshape(world * b, lay.kv_loc, se, hd),
            v.reshape(world * b, lay.kv_loc, se, hd),
            causal=False,
            chunk=min(1024, se),
        )
    o = o.reshape(world, b, lay.h_loc, sd, hd).permute(0, 1, 3, 2, 4).reshape(world, b, sd, nq)
    return x + pc.matmul_rs(o, params["wo"])


def build_cross_cache(params: dict, enc: torch.Tensor, pc, cfg) -> dict:
    """The decode path's cross-attention K / V from the encoder output enc
    [W, B, se_loc, D] (sequence-sharded): {"k", "v"} [W, B, kv_loc, Se,
    hd], through the same AG+GEMM as :func:`apply_cross_seq`."""
    k, v = _cross_kv(params, enc, pc, layout(cfg, pc.tp), cfg.hd)
    return {"k": k, "v": v}


def apply_cross_decode(params: dict, x: torch.Tensor, cross: dict, pc, cfg) -> torch.Tensor:
    """Decode-time cross-attention (``repro/nn/attention.apply_cross_decode``):
    x [B, C, D] replicated, ``cross`` from :func:`build_cross_cache`.
    Per-rank products in float32, softmax over all encoder keys, then the
    output projection's ``psum``."""
    lay = layout(cfg, pc.tp)
    hd = cfg.hd
    b, c, _ = x.shape
    nq = lay.h_loc * hd
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    q = torch.einsum("bsd,wdn->wbsn", h, params["wq"])[..., :nq]
    qh = q.reshape(pc.held, b, c, lay.h_loc, hd).permute(0, 1, 3, 2, 4)  # [W, B, h_loc, C, hd]
    rep = lay.h_loc // lay.kv_loc
    kk = cross["k"].repeat_interleave(rep, dim=2) if rep > 1 else cross["k"]
    vv = cross["v"].repeat_interleave(rep, dim=2) if rep > 1 else cross["v"]
    s = torch.einsum("wbhqd,wbhkd->wbhqk", (qh * hd**-0.5).float(), kk.float())
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("wbhqk,wbhkd->wbhqd", p, vv.float()).to(x.dtype)
    o = o.permute(0, 1, 3, 2, 4).reshape(pc.held, b, c, nq)
    return x + pc.psum(torch.einsum("wbsn,wnd->wbsd", o, params["wo"]))


def init_cache(cfg, tp: int, batch: int, max_len: int, dtype, device, window: Optional[int] = None,
               held: Optional[int] = None) -> dict:  # fmt: skip
    """Per-rank KV cache ``[W, B, kv_loc, L, hd]`` (``held`` ranks of a TP
    degree ``tp`` spanning processes: ``[held, ...]``); sliding-window
    layers hold a ring of ``window`` slots (slot ``p % window`` holds
    position ``p``)."""
    lay = layout(cfg, tp)
    length = min(max_len, window) if window is not None else max_len
    shape = (tp if held is None else held, batch, lay.kv_loc, length, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def apply_decode(
    params: dict,
    x: torch.Tensor,
    cache: dict,
    cache_len,
    pc,
    cfg,
    *,
    window: Optional[int] = None,
    rope_theta: Optional[float] = None,
    q_valid=None,
):
    """Chunked decode body.

    x: [B, C, D] replicated (C == 1 is plain decode; C > 1 a prefill chunk);
    ``cache_len`` is the number of tokens already in each slot (an int or a
    [B] tensor); ``q_valid`` ([B], optional) is how many of the C rows are
    real per slot — rows past it write nothing to the cache.  The chunk
    attends in two parts, the pre-existing cache rows and then the causal
    in-chunk keys.  Returns (x_out, cache), the cache updated in place.
    """
    lay = layout(cfg, pc.tp)
    hd = cfg.hd
    b, c, _ = x.shape
    dev = x.device
    lens = torch.as_tensor(cache_len, dtype=torch.int64, device=dev).expand(b)
    nv = None if q_valid is None else torch.as_tensor(q_valid, dtype=torch.int64, device=dev).expand(b)
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    qkv = _add_bias(params, torch.einsum("bsd,wdn->wbsn", h, params["wqkv"]))
    q, k, v = _split_qkv(qkv, lay, hd)  # [W, B, C, n, hd]

    qi = torch.arange(c, device=dev)
    pos = lens[:, None] + qi[None, :]  # [B, C] global positions
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    q, k = rope(q, k, pos, theta)

    cache_size = cache["k"].shape[3]
    ring = window is not None and cache_size <= window
    if ring and c > cache_size:
        raise ValueError(
            f"decode chunk C={c} exceeds ring cache size {cache_size}; "
            "chunked prefill must keep chunks within the sliding window"
        )

    rep = lay.h_loc // lay.kv_loc
    qf = (q.permute(0, 1, 3, 2, 4) * hd**-0.5).float()  # [W, B, h_loc, C, hd]
    kk = cache["k"].repeat_interleave(rep, dim=2) if rep > 1 else cache["k"]
    vv = cache["v"].repeat_interleave(rep, dim=2) if rep > 1 else cache["v"]
    kc = k.repeat_interleave(rep, dim=3) if rep > 1 else k  # [W, B, C, h_loc, hd]
    vc = v.repeat_interleave(rep, dim=3) if rep > 1 else v
    # part 1: the pre-existing cache rows (the chunk is not in them yet)
    s1 = torch.einsum("wbhqd,wbhkd->wbhqk", qf, kk.float())
    j = torch.arange(cache_size, device=dev)
    if ring:
        last = lens - 1  # slot j last held position p_j = last - ((last - j) mod size)
        p_j = last[:, None] - torch.remainder(last[:, None] - j[None, :], cache_size)  # [B, L]
        m1 = (p_j >= 0)[:, None, :] & ((pos[:, :, None] - p_j[:, None, :]) < window)
    else:
        m1 = (j[None, :] < lens[:, None])[:, None, :].expand(b, c, cache_size)
        if window is not None:
            m1 = m1 & ((pos[:, :, None] - j[None, None, :]) < window)
    s1 = torch.where(m1[None, :, None], s1, torch.full_like(s1, NEG_INF))
    # part 2: causal in-chunk keys (row i attends rows <= i, valid rows only)
    s2 = torch.einsum("wbhqd,wbkhd->wbhqk", qf, kc.float())
    m2 = (qi[None, :, None] >= qi[None, None, :]).expand(b, c, c)
    if nv is not None:
        m2 = m2 & (qi[None, None, :] < nv[:, None, None])
    if window is not None:
        m2 = m2 & ((qi[None, :, None] - qi[None, None, :]) < window)
    s2 = torch.where(m2[None, :, None], s2, torch.full_like(s2, NEG_INF))

    p = torch.softmax(torch.cat([s1, s2], dim=-1), dim=-1)
    o = torch.einsum("wbhqk,wbhkd->wbhqd", p[..., :cache_size], vv.float())
    o = o + torch.einsum("wbhqk,wbkhd->wbhqd", p[..., cache_size:], vc.float())
    o = o.to(x.dtype).permute(0, 1, 3, 2, 4).reshape(pc.held, b, c, lay.h_loc * hd)
    out = pc.psum(torch.einsum("wbsn,wnd->wbsd", o, params["wo"]))

    # write the chunk's k/v (after the reads above, so a ring slot the
    # attention still needed is not overwritten first)
    slots = torch.remainder(pos, cache_size) if ring else pos
    kt, vt = k.permute(1, 2, 0, 3, 4), v.permute(1, 2, 0, 3, 4)  # [B, C, W, kv_loc, hd]
    bi = torch.arange(b, device=dev)[:, None].expand(b, c)
    if nv is None:
        cache["k"][:, bi, :, slots] = kt.to(cache["k"].dtype)
        cache["v"][:, bi, :, slots] = vt.to(cache["v"].dtype)
    else:
        # a fixed-shape write with no host sync (a CUDA graph can capture
        # it): rows past q_valid write back what their slot holds.  Slots
        # taken mod the cache size stay in bounds, and the C rows of one
        # slot land on C distinct cache rows (C <= cache size), so a masked
        # row never shares a cache row with a real one.
        if c > cache_size:
            raise ValueError(f"decode chunk C={c} exceeds the cache size {cache_size}")
        slots = torch.remainder(pos, cache_size)
        keep = (qi[None, :] < nv[:, None])[:, :, None, None, None]  # [B, C, 1, 1, 1]
        for name, new in (("k", kt), ("v", vt)):
            old = cache[name][:, bi, :, slots]
            cache[name][:, bi, :, slots] = torch.where(keep, new.to(old.dtype), old)
    return x + out, cache
