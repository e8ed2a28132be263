"""Flash-attention kernels: online softmax, GQA, causal and sliding-window
masks.  Two routes, chosen before the launch by dtype and head dim
(:data:`ROUTES`, :func:`route`), never by a fallback:

  * ``"wgmma"`` (bfloat16 at head dims 64, 80, 128 and 256, the serve
    dtype): ``csrc/flash_attention_wgmma.cu``, TMA-staged Q / K / V, both
    products on wgmma, P rounded to bf16 before P V; head dim 80 (zamba2)
    runs the 128-wide pipeline on the 80 columns in memory, TMA filling the
    rest with zeros; head dim 256 (paligemma) a 256-wide pipeline.  :func:`flash_attention_tiled` replays its schedule.
  * ``"fma"`` (float32 at every head dim, bfloat16 at 16 and 32):
    ``csrc/flash_attention.cu``, f32 FMA; float32 products stay exact.

``flash_attention.last_launch`` says which route the last launch took, its
grid (CTAs) and the KV tiles it visits.

:func:`flash_attention_ranked` launches the same kernels on one step of the
sequence-parallel ring (``core/overlap.ring_attention``, paper Fig. 6): W
emulated ranks folded into the head dimension, query row i of rank r at
position ``q_off[r] + i`` and key j of its held KV tile at ``k_off[r] + j``
(a small per-rank table, no copy), head h of rank r reading KV head
``kv_start[r] + h // rep`` of the tile (the per-KV-group GQA ring), and the
float32 online-softmax state (m, l, o) carried from one launch to the next
(:class:`FlashState`); the last launch of a ring normalises and writes q's
dtype.  The default launch (queries right-aligned to the keys, no state) is
one rank with offset ``Sk - Sq``: the same schedule as before.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (``_fa_kernel``).
On the model path it takes the place of ``chunked_attention`` in
``nn/attention.apply_seq``: the port folds the emulated rank and the batch
into the head dimension, ``[W*B*h_loc, S, hd]`` against
``[W*B*kv_loc, S, hd]`` (head ``(w*B + b)*h_loc + h`` reads KV head
``(w*B + b)*kv_loc + h // rep`` because ``h_loc = rep * kv_loc``).  The
bound and the design are noted in the CUDA source.

:func:`chunked_attention` — a copy of ``repro/nn/attention.py``'s
memory-efficient online-softmax attention — is the plain version.

Under autograd (grad mode on and an input that requires grad)
:func:`flash_attention` runs its forward as one launch that stores the
softmax state the kernel carries (:func:`flash_attention_lse`: o and the
row log-sum-exp), and its backward is :func:`flash_attention_backward`,
the standard attention gradient in PyTorch ops recomputing P from that
log-sum-exp.  The JAX package has no backward kernel (its training path
differentiates ``chunked_attention`` through XLA).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.comp_tiles import largest_divisor
from repro_torch.kernels import build

__all__ = [
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_lse",
    "flash_attention_backward",
    "flash_attention_ranked",
    "flash_attention_ranked_plain",
    "flash_attention_tiled",
    "FlashState",
    "chunked_attention",
    "kv_tiles",
    "route",
    "ROUTES",
    "HEAD_DIMS",
    "TILE",
]

HEAD_DIMS = (16, 32, 64, 80, 128, 256)  # head dims the kernels are instantiated for (bf16 at 80: wgmma only)
# (dtype, head dim) -> route; any other pair takes "fma"
ROUTES = {(torch.bfloat16, d): "wgmma" for d in (64, 80, 128, 256)}
TILE = 64  # query rows and keys per tile of both kernels
NEG_INF = -1e30
LN2 = 0.6931471805599453
BWD_ROWS = 1024  # query rows per block of the backward (its float32 P is [BH, BWD_ROWS, Sk])
MAX_RANKS = 32  # ranks of one launch (the kernels' per-rank table)


class FlashState(NamedTuple):
    """The float32 online-softmax state of a ring in flight: the row max
    ``m`` and row sum ``l`` [W, B, H, Sq] and the unnormalised output ``o``
    [W, B, H, Sq, D].  Its units are the route's own (the wgmma route keeps
    m in the log2 domain), so a state goes back only to the route it came
    from."""

    m: torch.Tensor
    l: torch.Tensor  # noqa: E741
    o: torch.Tensor


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA launch of this dtype and head dim takes."""
    return ROUTES.get((dtype, d), "fma")


def kv_tiles(q0: int, sq: int, sk: int, causal: bool, window: Optional[int], off: Optional[int] = None):
    """The KV tiles the query tile at row ``q0`` visits: ``(first key, count)``
    of 64-key tiles holding a key visible to some query of the tile (both
    kernels' block skip).  ``off`` is the position of query row 0 less that
    of key 0 (default ``sk - sq``: queries right-aligned to keys)."""
    off = sk - sq if off is None else off
    hi = min(sk, q0 + TILE + off) if causal else sk
    lo = max(0, q0 + off - window + 1) if window else 0
    lo = lo // TILE * TILE
    return lo, (-(-(hi - lo) // TILE) if hi > lo else 0)


def flash_attention_tiled(
    q, k, v, *, causal=False, window=None, scale=None, p_bf16=True, off=None, state=None, final=True
):
    """The wgmma route's schedule in PyTorch: q [BH, Sq, D], k/v [BHkv, Sk,
    D] -> [BH, Sq, D] in q's dtype.

    64-row query tiles; for each, the 64-key tiles of :func:`kv_tiles` in
    order; S = Q K^T in f32, scaled in the log2 domain; the mask only on
    tiles that straddle the causal diagonal, the window's edge or the end of
    the keys (masked -1e30, keys past Sk p = 0); exp2 online softmax with
    f32 m / l / O; P rounded to bf16 before P V when ``p_bf16``.

    ``off`` places query row 0 at key position ``off`` (default ``Sk - Sq``).
    ``state`` (m, l [BH, Sq], o [BH, Sq, D], float32, m in the log2 domain)
    is the carried state of earlier launches; with ``final=False`` the new
    state is returned instead of the normalised output.  A row that has met
    no visible key keeps m = -1e30 and is wiped (alpha = 0) by its first one.
    """
    bh, sq, d = q.shape
    bhkv, sk, _ = k.shape
    rep = bh // bhkv
    scale_log2 = float(scale if scale is not None else d**-0.5) * 1.4426950408889634
    off = sk - sq if off is None else off
    kpad = -(-sk // TILE) * TILE
    kf = F.pad(k.float(), (0, 0, 0, kpad - sk)).repeat_interleave(rep, 0)
    vf = F.pad(v.float(), (0, 0, 0, kpad - sk)).repeat_interleave(rep, 0)
    out = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    if not final:
        m_out, l_out = torch.empty((bh, sq), device=q.device), torch.empty((bh, sq), device=q.device)
    rows = torch.arange(TILE, device=q.device)
    for q0 in range(0, sq, TILE):
        qt = q[:, q0 : q0 + TILE].float()
        lo, n = kv_tiles(q0, sq, sk, causal, window, off)
        if state is None:
            m = torch.full((bh, qt.shape[1], 1), NEG_INF, device=q.device)
            lsum = torch.zeros_like(m)
            o = torch.zeros((bh, qt.shape[1], d), device=q.device)
        else:
            m, lsum = state.m[:, q0 : q0 + TILE, None], state.l[:, q0 : q0 + TILE, None]
            o = state.o[:, q0 : q0 + TILE]
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
        if final:
            out[:, q0 : q0 + TILE] = o / torch.clamp(lsum, min=1e-30)
        else:
            m_out[:, q0 : q0 + TILE], l_out[:, q0 : q0 + TILE], out[:, q0 : q0 + TILE] = m[..., 0], lsum[..., 0], o
    return out.to(q.dtype) if final else FlashState(m_out, l_out, out)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 1024,
    q_offset: int = 0,
    k_offset: int = 0,
    scale: Optional[float] = None,
    state: Optional[FlashState] = None,
    final: bool = True,
    p_bf16: bool = False,
):
    """Online-softmax attention over KV chunks.

    q: [B, H, Sq, hd]; k/v: [B, Hkv, Sk, hd] with H % Hkv == 0; query i sits
    at position ``q_offset + i``, key j at ``k_offset + j``.  Fully masked
    chunks are skipped.  ``state`` (m, l [B, H, Sq], o [B, H, Sq, hd],
    float32) carries the online softmax in from earlier key ranges; with
    ``final=False`` the new state is returned instead of the output.
    ``p_bf16`` rounds P and the values to bf16 before P V, the product
    accumulated in float32 (the JAX package's ``p_bf16``).
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
    if state is None:
        m_i = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l_i = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
        o_i = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    else:
        m_i, l_i, o_i = state.m[..., None], state.l[..., None], state.o
    for ci in range(sk // chunk):
        k_lo, k_hi = k_offset + ci * chunk, k_offset + (ci + 1) * chunk - 1
        if causal and k_lo > q_offset + sq - 1:
            continue  # chunk entirely in the future
        if window is not None and (q_offset - k_hi) >= window:
            continue  # chunk entirely outside the window
        kj = k[:, :, ci * chunk : (ci + 1) * chunk].float()
        vj = v[:, :, ci * chunk : (ci + 1) * chunk].float()
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
        if p_bf16:  # bf16 operands, exact products, float32 sums
            p, vj = p.bfloat16().float(), vj.bfloat16().float()
        o_i = o_i * alpha + torch.matmul(p, vj)
        m_i = m_new
    if not final:
        return FlashState(m_i[..., 0], l_i[..., 0], o_i)
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
    _check_window(window)
    scale = float(scale if scale is not None else d**-0.5)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    # one rank of one group: every head reads KV head h // rep, queries right-aligned
    o = torch.empty_like(q)
    _launch(q, k, v, o, None, _single_map(bh, bhkv, sq, sk), causal, window, scale, load=False, store=False)
    return o


def _single_map(bh: int, bhkv: int, sq: int, sk: int) -> "_FlashMap":
    return _FlashMap(hq=bh, hk=bhkv, rep=bh // bhkv, gpr=1, delta=(sk - sq,), hoff=(0,))


def flash_attention_lse(q, k, v, *, causal=False, window=None, scale=None):
    """The forward of :func:`flash_attention` that keeps the softmax
    statistics: (o [BH, Sq, D] in q's dtype, lse [BH, Sq] float32, the
    natural-log log-sum-exp of each row's scaled scores).  A CUDA tensor
    runs one launch of the kernel of its route with the state stored
    (``_launch(store=True)``: the row max m and sum l the kernel carries);
    a CPU tensor the plain version's state (:func:`chunked_attention`,
    ``final=False``)."""
    bh, sq, d = q.shape
    bhkv, sk, _ = k.shape
    scale = float(scale if scale is not None else d**-0.5)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        st = chunked_attention(
            q[None], k[None], v[None], causal=causal, window=window, chunk=largest_divisor(sk, 1024),
            q_offset=sk - sq, scale=scale, final=False,
        )  # fmt: skip
        st = FlashState(st.m[0], st.l[0], st.o[0])
        log2_units = False
    else:
        st = FlashState(
            torch.empty((bh, sq), dtype=torch.float32, device=q.device),
            torch.empty((bh, sq), dtype=torch.float32, device=q.device),
            torch.empty((bh, sq, d), dtype=torch.float32, device=q.device),
        )  # the kernel writes every row
        _launch(q, k, v, None, st, _single_map(bh, bhkv, sq, sk), causal, window, scale, load=False, store=True)
        log2_units = route(q.dtype, d) == "wgmma"
    l_safe = torch.clamp(st.l, min=1e-30)
    o = (st.o / l_safe[..., None]).to(q.dtype)
    if log2_units:  # the wgmma route's m is in log2 units: lse = (m + log2 l) ln 2
        return o, (st.m + torch.log2(l_safe)) * LN2
    return o, st.m + torch.log(l_safe)


def flash_attention_backward(q, k, v, o, lse, do, *, causal=False, window=None, scale=None):
    """The attention gradient (dq, dk, dv) in PyTorch ops from the forward's
    saved statistics: P recomputed as exp(scale q k^T - lse) over query
    blocks of ``BWD_ROWS`` rows, dV = P^T dO, dS = P (dO V^T - rowsum(dO o)),
    dQ = scale dS K, dK = scale dS^T Q, summed over each KV head's query
    heads.  Float32 math; each gradient in its input's dtype."""
    bh, sq, d = q.shape
    bhkv, sk, _ = k.shape
    rep = bh // bhkv
    scale = float(scale if scale is not None else d**-0.5)
    qf, dof = q.float(), do.float()
    kf, vf = k.float().repeat_interleave(rep, 0), v.float().repeat_interleave(rep, 0)
    delta = (dof * o.float()).sum(-1)  # [BH, Sq]
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    k_pos = torch.arange(sk, device=q.device)
    for q0 in range(0, sq, BWD_ROWS):
        q1 = min(sq, q0 + BWD_ROWS)
        q_pos = (q0 + (sk - sq) + torch.arange(q1 - q0, device=q.device))[:, None]
        ok = torch.ones((q1 - q0, sk), dtype=torch.bool, device=q.device)
        if causal:
            ok = q_pos >= k_pos
        if window is not None:
            ok = ok & (q_pos - k_pos < window)
        s = torch.matmul(qf[:, q0:q1], kf.transpose(1, 2)) * scale
        p = torch.where(ok, torch.exp(s - lse[:, q0:q1, None]), 0.0)
        dv += torch.matmul(p.transpose(1, 2), dof[:, q0:q1])
        ds = p * (torch.matmul(dof[:, q0:q1], vf.transpose(1, 2)) - delta[:, q0:q1, None])
        dq[:, q0:q1] = torch.matmul(ds, kf) * scale
        dk += torch.matmul(ds.transpose(1, 2), qf[:, q0:q1]) * scale
    dk, dv = (t.view(bhkv, rep, sk, d).sum(1) for t in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Flash attention under autograd: the forward is one kernel launch that
    keeps (o, lse) (:func:`flash_attention_lse`), the backward
    :func:`flash_attention_backward` (no forward rerun)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, o, lse, do, **ctx.opts), None, None, None)


def flash_attention_ranked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_off: Sequence[int],
    k_off: Sequence[int],
    kv_start: Optional[Sequence[int]] = None,
    kv_need: Optional[int] = None,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    state: Optional[FlashState] = None,
    final: bool = True,
):
    """One launch over W rank-stacked ranks: q [W, B, H, Sq, D], k/v [W, B,
    Hk, Sk, D].

    Query row i of rank r sits at position ``q_off[r] + i``, key j of rank
    r's KV at ``k_off[r] + j``.  Head h of rank r reads KV head
    ``kv_start[r] + h // (H / kv_need)`` (default: every rank reads all Hk
    heads from 0, ``h // (H / Hk)``).  ``state`` carries the online softmax
    of earlier launches (:class:`FlashState`); ``final=False`` returns the
    new state, ``final=True`` the normalised output [W, B, H, Sq, D] in q's
    dtype.  A CPU tensor runs :func:`flash_attention_ranked_plain`; a CUDA
    tensor launches the kernel of its route (or raises).
    """
    if q.dim() != 5 or k.shape != v.shape or k.dim() != 5 or k.shape[:2] != q.shape[:2] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"flash_attention_ranked: bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    world, b, h, sq, d = q.shape
    hk, sk = k.shape[2], k.shape[3]
    kv_need = hk if kv_need is None else int(kv_need)
    kv_start = tuple(kv_start) if kv_start is not None else (0,) * world
    if len(q_off) != world or len(k_off) != world or len(kv_start) != world:
        raise ValueError(f"flash_attention_ranked: q_off, k_off and kv_start need one entry per rank ({world})")
    if kv_need < 1 or h % kv_need or any(s < 0 or s + kv_need > hk for s in kv_start):
        raise ValueError(f"flash_attention_ranked: {h} heads over KV heads {kv_start} + {kv_need} of {hk}")
    _check_window(window)
    scale = float(scale if scale is not None else d**-0.5)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ranked_plain(
            q, k, v, q_off=q_off, k_off=k_off, kv_start=kv_start, kv_need=kv_need, causal=causal, window=window,
            scale=scale, state=state, final=final,
        )  # fmt: skip
    if world > MAX_RANKS:
        raise ValueError(f"flash_attention_ranked: the kernels take at most {MAX_RANKS} ranks, got {world}")
    fmap = _FlashMap(
        hq=h, hk=hk, rep=h // kv_need, gpr=b, delta=tuple(int(a) - int(c) for a, c in zip(q_off, k_off)),
        hoff=kv_start,
    )  # fmt: skip
    if state is None and not final:
        st = FlashState(
            torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device),
            torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device),
            torch.empty(q.shape, dtype=torch.float32, device=q.device),
        )  # the kernel writes every row (its initial state where no key is visible)
    else:
        st = state
    o = torch.empty_like(q) if final else None
    _launch(q, k, v, o, st, fmap, causal, window, scale, load=state is not None, store=not final)
    return o if final else st


class _FlashMap(NamedTuple):
    """Where a launch's heads sit: rank r owns ``gpr`` groups of ``hq`` query
    heads (and of ``hk`` KV heads); head h of a group reads KV head
    ``hoff[r] + h // rep`` of its group; its query row 0 sits ``delta[r]``
    positions after its key 0."""

    hq: int
    hk: int
    rep: int
    gpr: int
    delta: tuple
    hoff: tuple

    def table(self, sq: int, sk: int, causal: bool, window: Optional[int]):
        """(int32 host table for the kernels, visible KV tiles per rank)."""
        work = [sum(kv_tiles(q0, sq, sk, causal, window, dl)[1] for q0 in range(0, sq, TILE)) for dl in self.delta]
        order = sorted(range(len(self.delta)), key=lambda r: -work[r])  # the longest ranges first
        vals = (self.hq, self.hk, self.rep, self.gpr, *self.delta, *self.hoff, *order)
        return (ctypes.c_int * len(vals))(*vals), work


def _check_window(window):
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")


def _launch(q, k, v, o, st: Optional[FlashState], fmap: _FlashMap, causal, window, scale, *, load, store):
    """Launch the kernel of q's route on flat operands; ``st`` is read when
    ``load`` and written (in place) when ``store``, else ``o`` is written."""
    build.check_cuda_operands("flash_attention", q, k, v)
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, got {d}")
    sq, sk = q.shape[-2], k.shape[-2]
    bh, bhkv = q.numel() // (sq * d), k.numel() // (sk * d)
    kind = route(q.dtype, d)
    if kind == "wgmma":
        build.check_tma_operands("flash_attention", q, k, v)
    if st is not None:
        build.check_cuda_operands("flash_attention state", st.m, st.l, st.o)
        if st.o.shape != q.shape or st.m.shape != q.shape[:-1] or st.l.shape != q.shape[:-1]:
            raise ValueError(f"flash_attention: state {tuple(st.o.shape)} does not match q {tuple(q.shape)}")
    table, work = fmap.table(sq, sk, causal, window)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), 0 if o is None else o.data_ptr())
    sptrs = (0, 0, 0) if st is None else (st.m.data_ptr(), st.l.data_ptr(), st.o.data_ptr())
    common = (bh, bhkv, sq, sk, d, scale, int(causal), int(window or 0), len(fmap.delta), ctypes.addressof(table))
    lib = build.library()
    if kind == "wgmma":
        info = (ctypes.c_int * 1)()
        rc = lib.tl_flash_attention_wgmma(
            *ptrs, *sptrs, *common, int(load), int(store), ctypes.addressof(info), build.stream(q)
        )
        grid = info[0]
    else:
        rc = lib.tl_flash_attention(
            build.dtype_code(q.dtype), *ptrs, *sptrs, *common, int(load), int(store), build.stream(q)
        )
        grid = -(-sq // TILE) * bh
    build.check(rc, "flash_attention")
    items = fmap.hq * fmap.gpr * sum(work)
    flash_attention.last_launch = {"route": kind, "grid": grid, "items": items}
    flash_attention.launches += 1


def flash_attention_ranked_plain(
    q, k, v, *, q_off, k_off, kv_start=None, kv_need=None, causal=False, window=None, scale=None, state=None,
    final=True, tiled=False,
):  # fmt: skip
    """Plain version of :func:`flash_attention_ranked`, rank by rank:
    :func:`chunked_attention` (natural-log state), or with ``tiled`` the
    wgmma route's schedule :func:`flash_attention_tiled` (log2 state)."""
    world, b, h, sq, d = q.shape
    hk, sk = k.shape[2], k.shape[3]
    kv_need = hk if kv_need is None else kv_need
    kv_start = kv_start if kv_start is not None else (0,) * world
    scale = float(scale if scale is not None else d**-0.5)
    outs = []
    for r in range(world):
        ks = slice(kv_start[r], kv_start[r] + kv_need)
        kr, vr = k[r][:, ks], v[r][:, ks]
        st = None if state is None else FlashState(state.m[r], state.l[r], state.o[r])
        if tiled:
            if st is not None:
                st = FlashState(st.m.reshape(b * h, sq), st.l.reshape(b * h, sq), st.o.reshape(b * h, sq, d))
            res = flash_attention_tiled(
                q[r].reshape(b * h, sq, d), kr.reshape(b * kv_need, sk, d), vr.reshape(b * kv_need, sk, d),
                causal=causal, window=window, scale=scale, off=q_off[r] - k_off[r], state=st, final=final,
            )  # fmt: skip
            res = res.reshape(b, h, sq, d) if final else FlashState(*(t.reshape((b, h) + t.shape[1:]) for t in res))
        else:
            res = chunked_attention(
                q[r], kr, vr, causal=causal, window=window, chunk=largest_divisor(sk, 1024), q_offset=q_off[r],
                k_offset=k_off[r], scale=scale, state=st, final=final,
            )  # fmt: skip
        outs.append(res)
    if final:
        return torch.stack(outs)
    return FlashState(*(torch.stack([o_[i] for o_ in outs]) for i in range(3)))


flash_attention.launches = 0
flash_attention.last_launch = None
