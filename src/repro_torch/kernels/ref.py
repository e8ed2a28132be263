"""Plain float32 oracles for every kernel of the port — the port's copy of
``repro/kernels/ref.py``.

Each function is the mathematical specification of a kernel, computed in
float32 torch ops with no tile, slot, flag or schedule of any kernel: the
kernels' plain versions (``<wrapper>_plain``) replay the kernels'
schedules, so a fault that a kernel and its replay share shows only
against these.  The tests hold them against ``repro.kernels.ref`` and every
plain version against them; ``chip_smoke.py`` holds every kernel case
whose function they compute against them on the card.

They follow the reference's conventions: flash attention's masks are
right-aligned (query i at position ``i + Sk - Sq``), the window keeps keys
with ``qp + (Sk - Sq) - kp < window``, GQA repeats each KV head over its
``BH / BHkv`` query heads, and a fully masked row gives zeros; ``ssd_ref``
is the sequential recurrence, with B / C groups and an initial state.
``grouped_matmul_ref`` gives a tile whose expert lies outside [0, E) zero
rows, as the kernel does.  ``ag_gemm_ref`` / ``gemm_rs_ref`` also take the
port's leading batch dims (``[R, *lead, rows, K]``, the world-stacked
layout of ``kernels/ag_gemm`` and ``kernels/gemm_rs``); at ``[R, rows, K]``
they are the reference's.
Where the reference rounds ``q * scale`` in q's dtype before its float32
scores, the port scales in float32 (the same numbers in float32).

Three oracles have no function in the reference's module (so they stay out
of ``__all__``, which names the reference's), because the reference's
kernels compute them only inside a larger function; they hold
the kernel cases the functions above do not cover:
``flash_attention_union_ref`` (one ring step with the state of the steps
before it: attention over the union of the KV tiles every step visited, at
the ring's rank offsets), ``ssd_intra_chunk_ref`` (the SSD intra-chunk term
alone) and ``gemm_rs_wire_ref`` (GEMM+RS with the partial rounded to the
wire dtype after every hop, in the hop order of the plan's tables).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "matmul_ref",
    "flash_attention_ref",
    "grouped_matmul_ref",
    "ag_gemm_ref",
    "gemm_rs_ref",
    "ssd_ref",
]


def matmul_ref(x: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [M, K] @ w [K, N] in float32, cast to ``out_dtype`` (default x's)."""
    return (x.float() @ w.float()).to(out_dtype or x.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = False, window: Optional[int] = None, scale: Optional[float] = None):
    """softmax(q kᵀ scale + mask) v.  q [BH, Sq, D], k / v [BHkv, Sk, D] with
    BH % BHkv == 0 (GQA: query head h reads KV head h // (BH / BHkv))."""
    bh, sq, d = q.shape
    bhkv, sk, _ = k.shape
    rep = bh // bhkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=0)
        v = v.repeat_interleave(rep, dim=0)
    scale = scale if scale is not None else d**-0.5
    s = torch.einsum("bqd,bkd->bqk", q.float() * scale, k.float())
    qp = torch.arange(sq, device=q.device)[:, None] + (sk - sq)  # right-aligned query positions
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = None
    if causal:
        mask = qp >= kp
    if window is not None:
        wmask = qp - kp < window
        mask = wmask if mask is None else mask & wmask
    if mask is not None:
        s = s.masked_fill(~mask[None], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # a fully masked row: p = 0, o = 0
    p = torch.exp(s - m)
    o = torch.einsum("bqk,bkd->bqd", p, v.float())
    return (o / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def grouped_matmul_ref(x, w, tile_expert, tile_m: int, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [M, K] expert-sorted rows, w [E, K, N], tile_expert [M // tile_m]:
    row i times ``w[tile_expert[i // tile_m]]`` -> [M, N] (the paper's
    dynamic mapping f_R, tile-aligned groups), one float32 product per
    expert over the rows of its tiles.  A tile whose entry lies outside
    [0, E) is empty: zero rows (the reference's tables have none)."""
    m, k = x.shape
    e, t = w.shape[0], m // tile_m
    te = tile_expert.long()
    xt = x.float().reshape(t, tile_m, k)
    out = torch.zeros((t, tile_m, w.shape[-1]), dtype=torch.float32, device=x.device)
    for ex in te[(te >= 0) & (te < e)].unique().tolist():
        tiles = (te == ex).nonzero()[:, 0]
        out[tiles] = xt[tiles] @ w[ex].float()
    return out.reshape(m, -1).to(out_dtype or x.dtype)


def ag_gemm_ref(x_shards: torch.Tensor, w_shards: torch.Tensor) -> torch.Tensor:
    """x_shards [R, *lead, m_loc, K], w_shards [R, K, n_loc] -> [R, *lead,
    R*m_loc, n_loc]: every rank holds all_gather(x) @ its w, rows in rank
    order (per leading index)."""
    r, m_loc, k = x_shards.shape[0], x_shards.shape[-2], x_shards.shape[-1]
    lead = x_shards.shape[1:-2]
    xg = x_shards.float().movedim(0, -3).reshape(*lead, r * m_loc, k)
    out = torch.stack([xg @ w.float() for w in w_shards])
    return out.to(x_shards.dtype)


def gemm_rs_ref(x_shards: torch.Tensor, w_shards: torch.Tensor) -> torch.Tensor:
    """x_shards [R, *lead, M, k_loc] (k-sharded input), w_shards [R, k_loc, N]
    -> [R, *lead, M // R, N]: rank r's row segment of sum_r x_r @ w_r."""
    r, m = x_shards.shape[0], x_shards.shape[-2]
    full = sum(x_shards[i].float() @ w_shards[i].float() for i in range(r))  # [*lead, M, N]
    segs = full.reshape(*full.shape[:-2], r, m // r, full.shape[-1])
    return segs.movedim(-3, 0).to(x_shards.dtype)


def ssd_ref(x, dt, a_log, b, c, *, chunk: int = 64, d_init=None) -> torch.Tensor:
    """Mamba-2 SSD (state-space duality) — the sequential scan.

    x [B, L, H, P] inputs per head, dt [B, L, H] step sizes (positive),
    a_log [H] (A = -exp(a_log)), b / c [B, L, G, N] (G groups of H / G
    heads), d_init [B, H, N, P] the state before step 0 (zeros if None).
    h_t = h_{t-1} exp(dt_t A) + dt_t B_t ⊗ x_t, y_t = C_t · h_t ->
    y [B, L, H, P] in x's dtype.  ``chunk`` is the chunked forms' and is
    not used here (the reference's signature)."""
    bsz, length, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    a = -torch.exp(a_log.float())  # [H]
    bx = b.float().repeat_interleave(rep, dim=2)  # [B, L, H, N]
    cx = c.float().repeat_interleave(rep, dim=2)
    xf, dtf = x.float(), dt.float()
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device) if d_init is None else d_init.float()
    ys = []
    for t in range(length):
        decay = torch.exp(dtf[:, t] * a)  # [B, H]
        state = state * decay[..., None, None] + torch.einsum("bhn,bhp->bhnp", bx[:, t] * dtf[:, t, :, None], xf[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", cx[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype)


def flash_attention_union_ref(q, ks, vs, *, q_off, k_offs, causal: bool = False, scale: Optional[float] = None):
    """The attention a ring computes over several steps: q [W, B, H, Sq, D]
    at positions ``q_off[r] + i``; ``ks`` / ``vs`` one [W, B, Hk, Sk, D] KV
    tile per step, tile t of rank r at positions ``k_offs[t][r] + j``.  Per
    rank, :func:`flash_attention_ref` over the tiles some query sees.
    Without ``causal`` that is every tile.  Under ``causal`` a tile that ends
    before the query block is wholly visible and goes first; the tiles that
    overlap the block must be contiguous and end with it, and go last, so
    that the right-aligned causal mask is the causal mask of absolute
    positions; a tile after the block is wholly masked and left out.
    -> [W, B, H, Sq, D] in q's dtype."""
    world, b, h, sq, d = q.shape
    sk = ks[0].shape[3]
    outs = []
    for r in range(world):
        offs = sorted((k_offs[t][r], t) for t in range(len(ks)))
        if causal:
            end = q_off[r] + sq
            before = [(o, t) for o, t in offs if o + sk <= q_off[r]]
            overlap = [(o, t) for o, t in offs if o + sk > q_off[r] and o < end]
            if [o for o, _ in overlap] != list(range(end - sk * len(overlap), end, sk)):
                raise ValueError(f"rank {r}: the tiles at {[o for o, _ in overlap]} that overlap the query block are "
                                 f"not contiguous up to its end {end}")  # fmt: skip
            offs = before + overlap
        k = torch.cat([ks[t][r] for _, t in offs], dim=2)  # [B, Hk, Sk x tiles, D]
        v = torch.cat([vs[t][r] for _, t in offs], dim=2)
        o = flash_attention_ref(q[r].reshape(b * h, sq, d), k.reshape(-1, k.shape[2], d), v.reshape(-1, v.shape[2], d),
                                causal=causal, scale=scale)  # fmt: skip
        outs.append(o.reshape(b, h, sq, d))
    return torch.stack(outs)


def ssd_intra_chunk_ref(cum: torch.Tensor, cb: torch.Tensor, xdt: torch.Tensor) -> torch.Tensor:
    """The SSD intra-chunk term of each tile t: y = (CB ∘ exp(cum_i − cum_j)
    ∘ [i ≥ j]) @ xdt as one float32 einsum.  cum [T, Q], cb [T, Q, Q], xdt
    [T, Q, P] -> [T, Q, P] in xdt's dtype."""
    c = cum.float()
    q = c.shape[1]
    causal = torch.ones((q, q), dtype=torch.bool, device=c.device).tril()
    decay = torch.exp((c[:, :, None] - c[:, None, :]).masked_fill(~causal, float("-inf")))
    return torch.einsum("tij,tij,tjp->tip", cb.float(), decay, xdt.float()).to(xdt.dtype)


def gemm_rs_wire_ref(x_shards: torch.Tensor, w_shards: torch.Tensor, seg_tables, wire: torch.dtype) -> torch.Tensor:
    """GEMM+RS whose partial crosses a ``wire``-dtype link after every hop:
    x_shards [R, *lead, M, k_loc], w_shards [R, k_loc, N] -> [R, *lead,
    M // R, N].  ``seg_tables[c][s][r]`` is the row segment rank r reduces
    at step s on channel c (``TilePlan.rs_seg_tables``; channel c owns
    columns c N/C .. (c+1) N/C).  Each segment's chain adds its ranks'
    float32 products in step order and rounds the sum to ``wire`` after
    every step but the last; the rank that reduces segment g at the last
    step must be g."""
    world, m, n = x_shards.shape[0], x_shards.shape[-2], w_shards.shape[-1]
    nch, m_loc = len(seg_tables), m // world
    n_sub = n // nch
    lead = x_shards.shape[1:-2]
    out = torch.zeros((world,) + tuple(lead) + (m_loc, n), dtype=torch.float32, device=x_shards.device)
    for c, table in enumerate(seg_tables):
        cols = slice(c * n_sub, (c + 1) * n_sub)
        for g in range(world):
            acc = None
            for s, row in enumerate(table):
                r = row.index(g)
                part = x_shards[r, ..., g * m_loc : (g + 1) * m_loc, :].float() @ w_shards[r, :, cols].float()
                acc = part if acc is None else part + acc
                if s < world - 1:
                    acc = acc.to(wire).float()
            if r != g:
                raise ValueError(f"channel {c}: segment {g} ends at rank {r}, not its owner")
            out[g, ..., cols] = acc
    return out.to(x_shards.dtype)
