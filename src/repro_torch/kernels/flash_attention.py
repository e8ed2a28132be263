"""Flash-attention kernel (``csrc/flash_attention.cu``): online softmax, GQA,
causal and sliding-window masks.

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

from typing import Optional

import torch

from repro_torch.core.comp_tiles import largest_divisor
from repro_torch.kernels import build

__all__ = ["flash_attention", "flash_attention_plain", "chunked_attention", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernel is instantiated for
NEG_INF = -1e30


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
    kernel (or raises)."""
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
    o = torch.empty_like(q)
    lib = build.library()
    rc = lib.tl_flash_attention(
        build.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        bh, bhkv, sq, sk, d, scale, int(causal), int(window or 0), build.stream(q),
    )  # fmt: skip
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
