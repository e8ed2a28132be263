"""Analytic cost model — the ranker where timing is no signal or impossible.

The port's counterpart of ``repro/tune/cost.py``: per schedule step, bytes
on the wire over the link bandwidth against the step's compute, composed
into a pipelined makespan,

    t_step  = max(t_comm, t_comp)
    total   = (steps - 1) * t_step + (t_comm + t_comp) / C + alpha * C * steps

with the JAX package's comm half unchanged: a bidirectional ring with C >= 2
splits the bytes over both directions; all2all pays the mean ring distance
of its real peer tables (``_order_hops``); with no tuned wire the accum
dtype prices the travelling partials (rs, ag_rs) and tiles travel at 2
bytes; a tuned wire prices every payload at its itemsize plus a scale
overhead for the quantized wires.  Hardware numbers come from the Hopper
``launch/roofline.HW`` (a peer store of ``World``'s emulated ranks is an
HBM store).

The compute half follows what runs on the :class:`~.candidates.Target`:

  * the fused GEMM kernels' bf16 wgmma route: 128 x 128 output tiles over
    the whole contraction, at the bf16 tensor-core peak, whatever the
    candidate's tile;
  * their float32 FMA route: 64 x tn tiles (the candidate's tn, as
    ``comp_tiles.fma_n_tile`` leaves it) at the float32 peak;
  * the eager executor (and no target): the candidate's realized blocking
    (``realized_tile``) as a per-tile roofline — operand and accumulator
    bytes per block, an efficiency penalty for blocks narrower than a
    64-wide wgmma edge, and ``BETA_TILE_S`` per tile — at the float32 peak
    (the eager products are formed in float32), bf16 with no target;
  * attention and MoE as in the JAX package (score tiles with a softmax
    term; grouped expert GEMMs with tile occupancy).

``ALPHA_S`` / ``BETA_TILE_S`` read ``REPRO_TUNE_ALPHA`` / ``REPRO_TUNE_BETA``
(seconds), as in the JAX package.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import torch

from repro_torch.core import schedules
from repro_torch.core.comp_tiles import DEFAULT_TILE, largest_divisor, resolve_tile
from repro_torch.core.quant import wire_itemsize
from repro_torch.launch.roofline import HW
from repro_torch.tune.candidates import GEMM_TILE_KINDS, Candidate, Target, _tile_dims, a2a_sigs, seq_sigs

__all__ = [
    "ALPHA_S",
    "BETA_TILE_S",
    "step_terms",
    "realized_tile",
    "comp_step_time",
    "predict_cost",
    "seam_saving",
    "predict_seq_cost",
    "a2a_saving",
    "predict_a2a_cost",
]

ALPHA_S = float(os.environ.get("REPRO_TUNE_ALPHA", 1e-6))  # per-transfer launch / flag latency (s)
BETA_TILE_S = float(os.environ.get("REPRO_TUNE_BETA", 2e-7))  # per-compute-tile issue cost (s)

_TILE_BYTES = 2  # bytes per element of a flowing activation tile
_SCORE_BYTES = 4  # attention scores and softmax statistics stay float32
_SOFTMAX_OPS = 8.0  # elementwise ops per attention score
_VPU_FRACTION = 1.0 / 16.0  # the elementwise rate against the matrix peak
_ROUTE_BYTES = 8  # a (token, slot) routing entry: int32 id + float32 weight
_SCALE_OVERHEAD_BYTES = 64  # per payload of a quantized wire
_EDGE = 64  # a wgmma's M per warpgroup: blocks narrower than this leave the tensor cores part idle
_WGMMA_TILE = (128, 128)  # the bf16 route's output tile (kernels/build.WGMMA_TILE)
_FMA_BM = 64  # the float32 route's row tile


def _flow_bytes(accum_dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, accum_dtype)).element_size()


@functools.lru_cache(maxsize=None)
def _order_hops(order: str, world: int) -> float:
    """Mean ring distance per payload of one step for ``order``, from the
    real peer tables (``schedules.all2all_peer``); ring orders take one hop."""
    if order != "all2all" or world <= 1:
        return 1.0
    total = 0
    for s in range(1, world):
        for r in range(world):
            p = schedules.all2all_peer(r, s, world)
            total += min((p - r) % world, (r - p) % world)
    return max(1.0, total / float((world - 1) * world))


def _moe_rows(sig: Tuple[int, ...], world: int) -> float:
    """Grouped-GEMM token rows per step: m_loc * top_k, scaled by the
    imbalance axis, capped by the capacity axis."""
    m_loc, _d_model, top_k, e_loc, _d_exp = sig[:5]
    rows = float(m_loc * max(1, top_k))
    if len(sig) > 5:
        rows *= max(1.0, sig[5] / 4.0)
    if len(sig) > 6:
        rows = min(rows, float(max(1, e_loc * world) * sig[6]))
    return rows


def step_terms(kind: str, sig: Tuple[int, ...], world: int, accum_dtype: str, wire_dtype: str = None):
    """(wire_bytes, flops) per schedule step per rank (the JAX package's terms)."""
    if wire_dtype is None:
        fb = _flow_bytes(accum_dtype)
        tb, extra = _TILE_BYTES, 0.0
    else:
        fb = tb = wire_itemsize(wire_dtype)
        extra = float(_SCALE_OVERHEAD_BYTES) if wire_dtype not in ("float32", "bfloat16", "float16") else 0.0
    if kind == "ag_matmul":
        lead, m_loc, k, n_loc = sig
        lead = abs(lead)
        wire = lead * m_loc * k * tb + extra
        flops = 2.0 * lead * m_loc * k * n_loc
    elif kind == "matmul_rs":
        lead, m_glob, k_loc, n = sig
        lead = abs(lead)
        m_loc = max(1, m_glob // world)
        wire = lead * m_loc * n * fb + extra
        flops = 2.0 * lead * m_loc * k_loc * n
    elif kind == "ag_attention":
        b, h, hkv, s_loc, d = sig
        wire = 2.0 * b * hkv * s_loc * d * tb + extra
        flops = 4.0 * b * h * s_loc * s_loc * d
    elif kind == "ag_moe":
        m_loc, d_model, _top_k, _e_loc, d_exp = sig[:5]
        wire = m_loc * d_model * (tb + fb) + extra
        flops = 6.0 * _moe_rows(sig, world) * d_model * d_exp
    elif kind == "a2a_dispatch":
        m_loc, d_model, top_k, _e_loc, d_exp = sig[:5]
        wire = m_loc * d_model * tb + m_loc * max(1, top_k) * _ROUTE_BYTES
        flops = 6.0 * _moe_rows(sig, world) * d_model * d_exp
    elif kind == "combine_rs":
        m_loc, d_model = sig[0], sig[1]
        wire = m_loc * d_model * fb
        flops = 2.0 * m_loc * d_model
    else:
        raise ValueError(f"no cost model for kind {kind!r}")
    return float(wire), float(flops)


def _route(kind: str, target: Optional[Target]) -> str:
    """"wgmma" / "fma" for the fused GEMM kernels on the card, else "blocked"."""
    if target is not None and target.backend == "fused" and kind in GEMM_TILE_KINDS and target.cuda:
        return target.gemm_route()
    return "blocked"


def _peak(target: Optional[Target]) -> float:
    """The tensor-core bf16 peak for 16-bit operands on the fused kernels (and
    with no target); else the float32 rate (the FMA route, the eager products)."""
    if target is None or (target.backend == "fused" and target.dtype in (torch.bfloat16, torch.float16)):
        return HW["peak_flops"]
    return HW["peak_flops_f32"]


def realized_tile(kind: str, sig: Tuple[int, ...], world: int, cand: Candidate, target: Optional[Target] = None):
    """The blocking a candidate runs as: the default tile realizes as what an
    untuned op runs (the GEMM kinds: whole rows and contraction, 128-wide
    columns; attention and MoE: one whole-chunk block); on the fused GEMM
    routes the kernels' own tile (wgmma 128 x 128, FMA 64 x tn)."""
    m, n, k = _tile_dims(kind, tuple(sig), world, max(1, cand.num_channels))
    route = _route(kind, target)
    if route == "wgmma":
        return min(m, _WGMMA_TILE[0]), min(n, _WGMMA_TILE[1]), k
    if route == "fma":
        return min(m, _FMA_BM), largest_divisor(n, cand.comp_tile[1]), k
    if tuple(cand.comp_tile) == DEFAULT_TILE:
        if kind in GEMM_TILE_KINDS:
            return m, largest_divisor(n, 128), k
        return m, n, k
    return resolve_tile(tuple(cand.comp_tile), m, n, k)


def comp_step_time(kind: str, sig: Tuple[int, ...], world: int, cand: Candidate, target: Optional[Target] = None):
    """Per-step compute time of one candidate, its realized blocking included."""
    _, flops = step_terms(kind, sig, world, cand.accum_dtype)
    sig = tuple(sig)
    nch = max(1, cand.num_channels)
    dims = _tile_dims(kind, sig, world, nch)
    peak = _peak(target)
    if dims is None:
        return flops / peak
    m, n, k = dims
    tm, tn, tk = realized_tile(kind, sig, world, cand, target)

    if kind in GEMM_TILE_KINDS:
        eff = (min(tm, _EDGE) / _EDGE) * (min(tn, _EDGE) / _EDGE)
        lead = max(1, abs(int(sig[0])))
        blocks_mn = -(-m // tm) * -(-n // tn) * nch * lead
        n_tiles = blocks_mn * -(-k // tk)
        bytes_touched = (n_tiles * (tm * tk + tk * tn) + blocks_mn * tm * tn) * _TILE_BYTES
        return max(flops / (peak * eff), bytes_touched / HW["hbm_bw"]) + BETA_TILE_S * n_tiles

    if kind == "ag_attention":
        b, h, _hkv, _s_loc, _d = sig
        blocks = b * h * (m // tm) * (k // tk) * nch
        n_tiles = blocks * max(1, n // tn)
        eff = (min(tm, _EDGE) / _EDGE) * (min(tk, _EDGE) / _EDGE)
        scores = float(b) * h * m * k * nch
        t_soft = _SOFTMAX_OPS * scores / (peak * _VPU_FRACTION)
        bytes_touched = blocks * (2.0 * tm * n + 2.0 * tk * n) * _TILE_BYTES
        return max(flops / (peak * eff) + t_soft, bytes_touched / HW["hbm_bw"]) + BETA_TILE_S * n_tiles

    # ag_moe / a2a_dispatch: grouped expert GEMMs over capacity-sized groups
    m_loc, _d_model, top_k, e_loc, _d_exp = sig[:5]
    e_total = max(1, e_loc * world)
    m_sub = max(1, m_loc // nch)
    rows = max(8, ((m_sub * max(1, top_k) + e_total - 1) // e_total + 7) // 8 * 8)
    if len(sig) > 6:
        rows = min(rows, int(sig[6]))
    tm_e = min(tm, rows)
    row_tiles = -(-rows // tm_e)
    occupancy = rows / float(row_tiles * tm_e)
    blocks = e_loc * nch * row_tiles * max(1, n // tn)
    n_tiles = blocks * max(1, k // tk) * 2  # gate|up and down
    eff = (min(tm_e, _EDGE) / _EDGE) * (min(tn, _EDGE) / _EDGE) * occupancy
    bytes_touched = (n_tiles * (tm_e * tk + tk * tn) + blocks * tm_e * tn) * _TILE_BYTES
    return max(flops / (peak * eff), bytes_touched / HW["hbm_bw"]) + BETA_TILE_S * n_tiles


def _comm_time(kind: str, sig, world: int, cand: Candidate) -> float:
    wire, _ = step_terms(kind, sig, world, cand.accum_dtype, cand.flow)
    dirs = 2.0 if (cand.order == "bidir_ring" and cand.num_channels >= 2) else 1.0
    return wire * _order_hops(cand.order, world) / (HW["link_bw"] * dirs)


def predict_cost(kind: str, sig: Tuple[int, ...], world: int, cand: Candidate, target: Optional[Target] = None):
    """Predicted makespan (seconds) of one candidate; lower is better."""
    t_comm = _comm_time(kind, sig, world, cand)
    t_comp = comp_step_time(kind, sig, world, cand, target)
    steady = (world - 1) * max(t_comm, t_comp)
    fill = (t_comm + t_comp) / cand.num_channels
    return steady + fill + ALPHA_S * cand.num_channels * world


def _fill_drain_time(kind: str, sig, world: int, cand: Candidate, target=None) -> float:
    """The pipeline fill / drain term of one op's makespan."""
    return (_comm_time(kind, sig, world, cand) + comp_step_time(kind, sig, world, cand, target)) / cand.num_channels


def seam_saving(sig: Tuple[int, ...], world: int, cand: Candidate, target=None) -> float:
    """What a fused seam removes against the unfused pair: the shorter of
    the RS drain and the AG fill hides inside the longer."""
    sig_rs, sig_ag = seq_sigs(tuple(sig), world)
    return min(
        _fill_drain_time("matmul_rs", sig_rs, world, cand, target),
        _fill_drain_time("ag_matmul", sig_ag, world, cand, target),
    )


def predict_seq_cost(sig: Tuple[int, ...], world: int, cand: Candidate, *, fused: bool = True, target=None) -> float:
    """The RS -> AG seam's makespan under one shared candidate."""
    sig_rs, sig_ag = seq_sigs(tuple(sig), world)
    total = predict_cost("matmul_rs", sig_rs, world, cand, target) + predict_cost(
        "ag_matmul", sig_ag, world, cand, target
    )
    return total - seam_saving(sig, world, cand, target) if fused else total


def a2a_saving(sig: Tuple[int, ...], world: int, cand: Candidate, target=None) -> float:
    """What the overlapped dispatch / combine removes against the halves back to back."""
    d_sig, c_sig = a2a_sigs(tuple(sig), world)
    return min(
        _fill_drain_time("a2a_dispatch", d_sig, world, cand, target),
        _fill_drain_time("combine_rs", c_sig, world, cand, target),
    )


def predict_a2a_cost(sig: Tuple[int, ...], world: int, cand: Candidate, *, fused: bool = True, target=None) -> float:
    """The dispatch -> combine pair's makespan under one shared candidate."""
    d_sig, c_sig = a2a_sigs(tuple(sig), world)
    total = predict_cost("a2a_dispatch", d_sig, world, cand, target) + predict_cost(
        "combine_rs", c_sig, world, cand, target
    )
    return total - a2a_saving(sig, world, cand, target) if fused else total
