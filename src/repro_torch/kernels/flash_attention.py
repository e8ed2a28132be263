"""Flash-attention kernels: online softmax, GQA, causal and sliding-window
masks.  Two routes, chosen before the launch by dtype and head dim
(:data:`ROUTES`, :func:`route`), never by a fallback:

  * ``"wgmma"`` (bfloat16 at head dims 64 and 128, the serve dtype):
    ``csrc/flash_attention_wgmma.cu``, TMA-staged Q / K / V, both products on
    wgmma, P rounded to bf16 before P V.  :func:`flash_attention_tiled`
    replays its schedule.
  * ``"fma"`` (float32 at every head dim, bfloat16 at 16 and 32):
    ``csrc/flash_attention.cu``, f32 FMA; float32 products stay exact.

``flash_attention.last_launch`` says which route the last launch took, its
grid (CTAs) and the KV tiles it visits.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (``_fa_kernel``).
On the model path it takes the place of ``chunked_attention`` in
``nn/attention.apply_seq``: the port folds the emulated rank and the batch
into the head dimension, ``[W*B*h_loc, S, hd]`` against
``[W*B*kv_loc, S, hd]`` (head ``(w*B + b)*h_loc + h`` reads KV head
``(w*B + b)*kv_loc + h // rep`` because ``h_loc = rep * kv_loc``).  The
bound and the design are noted in the CUDA source.

:func:`chunked_attention` — a copy of ``repro/nn/attention.py``'s
memory-efficient online-softmax attention — is the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.comp_tiles import largest_divisor
from repro_torch.kernels import build

__all__ = [
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_tiled",
    "chunked_attention",
    "kv_tiles",
    "route",
    "ROUTES",
    "HEAD_DIMS",
    "TILE",
]

HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernels are instantiated for
# (dtype, head dim) -> route; any other pair takes "fma"
ROUTES = {(torch.bfloat16, 64): "wgmma", (torch.bfloat16, 128): "wgmma"}
TILE = 64  # query rows and keys per tile of both kernels
NEG_INF = -1e30


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA launch of this dtype and head dim takes."""
    return ROUTES.get((dtype, d), "fma")


def kv_tiles(q0: int, sq: int, sk: int, causal: bool, window: Optional[int]):
    """The KV tiles the query tile at row ``q0`` visits: ``(first key, count)``
    of 64-key tiles holding a key visible to some query of the tile (both
    kernels' block skip; queries right-aligned to keys)."""
    off = sk - sq
    hi = min(sk, q0 + TILE + off) if causal else sk
    lo = max(0, q0 + off - window + 1) if window else 0
    lo = lo // TILE * TILE
    return lo, (-(-(hi - lo) // TILE) if hi > lo else 0)


def flash_attention_tiled(q, k, v, *, causal=False, window=None, scale=None, p_bf16=True):
    """The wgmma route's schedule in PyTorch: q [BH, Sq, D], k/v [BHkv, Sk,
    D] -> [BH, Sq, D] in q's dtype.

    64-row query tiles; for each, the 64-key tiles of :func:`kv_tiles` in
    order; S = Q K^T in f32, scaled in the log2 domain; the mask only on
    tiles that straddle the causal diagonal, the window's edge or the end of
    the keys (masked -1e30, keys past Sk p = 0); exp2 online softmax with
    f32 m / l / O; P rounded to bf16 before P V when ``p_bf16``.
    """
    bh, sq, d = q.shape
    bhkv, sk, _ = k.shape
    rep = bh // bhkv
    scale_log2 = float(scale if scale is not None else d**-0.5) * 1.4426950408889634
    off = sk - sq
    kpad = -(-sk // TILE) * TILE
    kf = F.pad(k.float(), (0, 0, 0, kpad - sk)).repeat_interleave(rep, 0)
    vf = F.pad(v.float(), (0, 0, 0, kpad - sk)).repeat_interleave(rep, 0)
    out = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    rows = torch.arange(TILE, device=q.device)
    for q0 in range(0, sq, TILE):
        qt = q[:, q0 : q0 + TILE].float()
        lo, n = kv_tiles(q0, sq, sk, causal, window)
        m = torch.full((bh, qt.shape[1], 1), NEG_INF, device=q.device)
        lsum = torch.zeros_like(m)
        o = torch.zeros((bh, qt.shape[1], d), device=q.device)
        qpos = (q0 + rows[: qt.shape[1]] + off)[:, None]
        for k0 in range(lo, lo + n * TILE, TILE):
            s = torch.matmul(qt, kf[:, k0 : k0 + TILE].transpose(1, 2)) * scale_log2
            edge = (
                k0 + TILE > sk
                or (causal and k0 + TILE - 1 > q0 + off)
                or (bool(window) and q0 + TILE - 1 + off - k0 >= window)
            )
            if edge:
                kpos = (k0 + rows)[None, :]
                ok = torch.ones((qt.shape[1], TILE), dtype=torch.bool, device=q.device)
                if causal:
                    ok = qpos >= kpos
                if window:
                    ok = ok & (qpos - kpos < window)
                s = torch.where(ok, s, NEG_INF)
                s = torch.where(kpos < sk, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            lsum = lsum * alpha + p.sum(-1, keepdim=True)
            if p_bf16:
                p = p.bfloat16().float()
            o = o * alpha + torch.matmul(p, vf[:, k0 : k0 + TILE])
            m = m_new
        out[:, q0 : q0 + TILE] = o / torch.clamp(lsum, min=1e-30)
    return out.to(q.dtype)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 1024,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: [B, H, Sq, hd]; k/v: [B, Hkv, Sk, hd] with H % Hkv == 0; query i sits
    at position ``q_offset + i``.  Fully masked chunks are skipped.
    """
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else hd**-0.5
    chunk = min(chunk, sk)
    if sk % chunk:
        raise ValueError(f"chunked_attention: chunk {chunk} does not divide {sk} keys")
    q32 = (q * scale).float()
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m_i = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l_i = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    o_i = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for ci in range(sk // chunk):
        k_lo, k_hi = ci * chunk, (ci + 1) * chunk - 1
        if causal and k_lo > q_offset + sq - 1:
            continue  # chunk entirely in the future
        if window is not None and (q_offset - k_hi) >= window:
            continue  # chunk entirely outside the window
        kj = k[:, :, k_lo : k_hi + 1].float()
        vj = v[:, :, k_lo : k_hi + 1].float()
        if rep > 1:
            kj = kj.repeat_interleave(rep, dim=1)
            vj = vj.repeat_interleave(rep, dim=1)
        s = torch.matmul(q32, kj.transpose(-1, -2))
        k_pos = k_lo + torch.arange(chunk, device=q.device)
        mask = None
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            wm = (q_pos[:, None] - k_pos[None, :]) < window
            mask = wm if mask is None else mask & wm
        if mask is not None:
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_i, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_i - m_new)
        l_i = l_i * alpha + p.sum(-1, keepdim=True)
        o_i = o_i * alpha + torch.matmul(p, vj)
        m_i = m_new
    return (o_i / torch.clamp(l_i, min=1e-30)).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal=False, window=None, scale=None):
    """Plain version on the kernel's layout: q [BH, Sq, D], k/v [BHkv, Sk, D]."""
    sk = k.shape[1]
    return chunked_attention(
        q[None], k[None], v[None], causal=causal, window=window,
        chunk=largest_divisor(sk, 1024), q_offset=sk - q.shape[1], scale=scale,
    )[0]  # fmt: skip


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: [BH, Sq, D], k/v: [BHkv, Sk, D] -> [BH, Sq, D]; queries right-aligned
    to keys.  A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel of its (dtype, head dim) route (or raises)."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    bh, sq, d = q.shape
    bhkv, sk, _ = k.shape
    if bh % bhkv:
        raise ValueError(f"flash_attention: {bh} heads do not group over {bhkv} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    scale = float(scale if scale is not None else d**-0.5)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    build.check_cuda_operands("flash_attention", q, k, v)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, got {d}")
    kind = route(q.dtype, d)
    if kind == "wgmma":
        build.check_tma_operands("flash_attention", q, k, v)
    o = torch.empty_like(q)
    lib = build.library()
    if kind == "wgmma":
        info = (ctypes.c_int * 1)()
        rc = lib.tl_flash_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, bhkv, sq, sk, d, scale, int(causal),
            int(window or 0), ctypes.addressof(info), build.stream(q),
        )  # fmt: skip
        grid = info[0]
    else:
        rc = lib.tl_flash_attention(
            build.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            bh, bhkv, sq, sk, d, scale, int(causal), int(window or 0), build.stream(q),
        )  # fmt: skip
        grid = -(-sq // TILE) * bh
    build.check(rc, "flash_attention")
    items = bh * sum(kv_tiles(q0, sq, sk, causal, window)[1] for q0 in range(0, sq, TILE))
    flash_attention.last_launch = {"route": kind, "grid": grid, "items": items}
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
flash_attention.last_launch = None
