"""GQA attention block — TP over heads, sequence-parallel residual stream.

The port of ``repro/nn/attention.py`` for the dense serve path.

Prefill (``apply_seq``): the AG+GEMM producer gathers the sequence-sharded
residual stream while projecting to each rank's heads, attention runs per
rank on its head shard, and the output projection is the GEMM+RS consumer.
With ``pc.backend == "fused"`` attention is the flash kernel (the JAX
package runs its XLA twin ``chunked_attention`` here); with ``"eager"`` it
is ``chunked_attention``, the kernel's plain version.

Decode (``apply_decode``): activations are replicated over the ranks, the
projections are local per-rank matmuls with a ``psum`` epilogue, and the KV
cache ``[W, B, kv_loc, S_max, hd]`` is sharded over heads.  The chunk's k/v
are written into the cache in place, after the attention reads it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import chunked_attention, flash_attention
from repro_torch.nn.layers import GQALayout, gqa_layout, he_init, rms_norm, rope

__all__ = ["init", "apply_seq", "apply_decode", "init_cache", "chunked_attention", "layout"]

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
    }


def _split_qkv(qkv: torch.Tensor, lay: GQALayout, hd: int):
    """[..., (h_loc + 2 kv_loc) * hd] -> q [..., h_loc, hd], k/v [..., kv_loc, hd]."""
    qkv = qkv.reshape(qkv.shape[:-1] + (lay.h_loc + 2 * lay.kv_loc, hd))
    q = qkv[..., : lay.h_loc, :]
    k = qkv[..., lay.h_loc : lay.h_loc + lay.kv_loc, :]
    v = qkv[..., lay.h_loc + lay.kv_loc :, :]
    return q, k, v


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
):
    """x: [W, B, s_loc, D] sequence-sharded -> [W, B, s_loc, D] (+ residual);
    with ``return_kv`` also the per-rank KV ``[W, B, kv_loc, S, hd]``."""
    lay = layout(cfg, pc.tp)
    hd = cfg.hd
    world, b = x.shape[0], x.shape[1]
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    qkv = pc.ag_matmul(h, params["wqkv"])  # [W, B, S, (h_loc + 2 kv_loc) * hd]
    s_glob = qkv.shape[2]
    q, k, v = _split_qkv(qkv, lay, hd)
    positions = torch.arange(s_glob, device=x.device)
    q, k = rope(q, k, positions, rope_theta if rope_theta is not None else cfg.rope_theta)
    # [W, B, S, n, hd] -> [W, B, n, S, hd]
    q = q.permute(0, 1, 3, 2, 4)
    k = k.permute(0, 1, 3, 2, 4).contiguous()
    v = v.permute(0, 1, 3, 2, 4).contiguous()
    if pc.fused:
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
        )
    o = o.reshape(world, b, lay.h_loc, s_glob, hd).permute(0, 1, 3, 2, 4).reshape(world, b, s_glob, lay.h_loc * hd)
    y = x + pc.matmul_rs(o, params["wo"])  # GEMM + RS -> [W, B, s_loc, D]
    if return_kv:
        return y, {"k": k, "v": v}
    return y


def init_cache(cfg, tp: int, batch: int, max_len: int, dtype, device, window: Optional[int] = None) -> dict:
    """Per-rank KV cache ``[W, B, kv_loc, L, hd]``; sliding-window layers hold a
    ring of ``window`` slots (slot ``p % window`` holds position ``p``)."""
    lay = layout(cfg, tp)
    length = min(max_len, window) if window is not None else max_len
    shape = (tp, batch, lay.kv_loc, length, cfg.hd)
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
    qkv = torch.einsum("bsd,wdn->wbsn", h, params["wqkv"])
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
    o = o.to(x.dtype).permute(0, 1, 3, 2, 4).reshape(pc.tp, b, c, lay.h_loc * hd)
    out = pc.psum(torch.einsum("wbsn,wnd->wbsd", o, params["wo"]))

    # write the chunk's k/v (after the reads above, so a ring slot the
    # attention still needed is not overwritten first)
    slots = torch.remainder(pos, cache_size) if ring else pos
    kt, vt = k.permute(1, 2, 0, 3, 4), v.permute(1, 2, 0, 3, 4)  # [B, C, W, kv_loc, hd]
    if nv is None:
        bi = torch.arange(b, device=dev)[:, None].expand(b, c)
        cache["k"][:, bi, :, slots] = kt.to(cache["k"].dtype)
        cache["v"][:, bi, :, slots] = vt.to(cache["v"].dtype)
    else:
        bi, ii = torch.nonzero(qi[None, :] < nv[:, None], as_tuple=True)
        cache["k"][:, bi, :, slots[bi, ii]] = kt[bi, ii].to(cache["k"].dtype)
        cache["v"][:, bi, :, slots[bi, ii]] = vt[bi, ii].to(cache["v"].dtype)
    return x + out, cache
