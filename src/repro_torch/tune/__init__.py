"""Design-space autotuner over the port's ``compile_overlap``.

The port's counterpart of ``repro/tune``.  The paper's §3.1 tunes the
communication half (tile order, channel count f_C, accum dtype, wire dtype)
and the compute half (the consumer tile) independently, per shape and per
mesh.  This package searches that space:

    result = autotune("ag_matmul", signature=(1, 64, 32, 32), world=world, backend="fused",
                      dtype=torch.bfloat16)
    fn = compile_overlap("ag_matmul", result.channel, world=world, backend="fused")

or transparently:

    compile_overlap("ag_matmul", "auto", world=world)            # comm half, per call shape
    compile_overlap("ag_matmul", "auto", world=world, comp="auto")   # and the compute half
    ParallelContext(world=world, tune=True)                      # every op, per shape
    nn.ffn.apply_seq(params, x, pc, cfg, tune=True)               # one block

``DEFAULT_SPACE`` sweeps the comm half; ``JOINT_SPACE`` adds the tile
lattice; ``QUANT_SPACE`` the wire axis.  What a candidate may vary depends
on where it runs (``candidates.Target``: backend, device, dtype): the
enumerator offers no tile that the kernel of that route ignores and no wire
that the backend refuses.

Rankers
-------
``ranker="measure"``  times candidates through ``compile_overlap`` on the
                      world (``tune/measure.py``: CUDA events on the card),
                      pruned by the successive-halving sweep
                      (``tune/sweep.py``, ``REPRO_TUNE_SWEEP*``);
``ranker="model"``    ranks with the analytic cost model (``tune/cost.py``);
``ranker="auto"``     (default) measures when the world lives on a CUDA
                      device and models otherwise (a CPU wall time says
                      nothing about the card).  ``REPRO_TUNE_RANKER``
                      overrides.

While a CUDA graph is being captured nothing may be timed (a launch there
is recorded, not run): resolution then uses the cache or the model and
launches nothing.  Results persist per fingerprint (``tune/cache.py``:
world, axis, backend, GPU, SM count, torch and CUDA versions) under
``~/.cache/repro-torch-tune`` (``REPRO_TUNE_CACHE`` overrides); a hit never
re-ranks, except that an explicit ``ranker="measure"`` upgrades a
model-ranked record in place.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.channels import BlockChannel
from repro_torch.core.quant import dtype_name
from repro_torch.tune import cache as _cache
from repro_torch.tune import cost as _cost
from repro_torch.tune import measure as _measure
from repro_torch.tune import sweep as _sweep
from repro_torch.tune.candidates import (
    A2A_SEQ_KIND,
    COMP_TILE_LATTICE,
    DEFAULT_SPACE,
    GEMM_TILE_KINDS,
    JOINT_SPACE,
    MOE_SIG_KINDS,
    QUANT_SPACE,
    QUANT_WIRE_KINDS,
    SEQ_KIND,
    TUNABLE_KINDS,
    Candidate,
    Space,
    Target,
    a2a_sigs,
    chunk_extent,
    comp_tile_candidates,
    enumerate_a2a_candidates,
    enumerate_candidates,
    enumerate_seq_candidates,
    seq_sigs,
    signature,
    wire_candidates,
)

__all__ = [
    "autotune",
    "resolve_channel",
    "resolve_seq",
    "resolve_a2a",
    "TuneResult",
    "Space",
    "Candidate",
    "Target",
    "DEFAULT_SPACE",
    "JOINT_SPACE",
    "QUANT_SPACE",
    "COMP_TILE_LATTICE",
    "GEMM_TILE_KINDS",
    "QUANT_WIRE_KINDS",
    "TUNABLE_KINDS",
    "SEQ_KIND",
    "A2A_SEQ_KIND",
    "MOE_SIG_KINDS",
    "RANKERS",
    "CACHE_SCHEMA",
    "signature",
    "enumerate_candidates",
    "enumerate_seq_candidates",
    "enumerate_a2a_candidates",
    "seq_sigs",
    "a2a_sigs",
    "comp_tile_candidates",
    "wire_candidates",
    "chunk_extent",
    "capturing",
]

RANKERS = ("auto", "measure", "model")
_ENV_RANKER = "REPRO_TUNE_RANKER"

# record format; the JAX package's schema 4 fields.  An older, malformed or
# foreign record re-tunes (never crashes, never half-applies)
CACHE_SCHEMA = 4


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """The winner of one search (or one cache hit)."""

    kind: str
    signature: Tuple[int, ...]
    candidate: Candidate
    channel: BlockChannel
    ranker: str  # the ranker that produced the record
    score: float  # predicted seconds, or measured median us
    cache_hit: bool
    fingerprint: Dict[str, Any]
    considered: int  # candidates enumerated (0 on a hit)
    score_iqr: float = 0.0
    sweep: Optional[Dict[str, Any]] = None


def _entry_key(kind: str, axis: str, world: int, dtype: torch.dtype, sig: Sequence[int], space: Space) -> str:
    shape = ",".join(str(int(s)) for s in sig)
    return f"{kind}|axis={axis}|world={int(world)}|dtype={dtype_name(dtype)}|sig={shape}|space={space.digest()}"


def capturing() -> bool:
    """Whether a CUDA graph is being captured on the current stream (nothing
    can be timed then: a launch is recorded, not run)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _wants_measure_upgrade(rec: Dict[str, Any], ranker: Optional[str]) -> bool:
    """An explicit ``ranker="measure"`` (argument or environment) landing on
    a model-ranked record re-ranks and overwrites it, outside a capture."""
    requested = ranker or os.environ.get(_ENV_RANKER)
    return requested == "measure" and rec.get("ranker") == "model" and not capturing()


def _parse_record(rec: Any) -> Optional[Dict[str, Any]]:
    """A validated view of a cache record, or None (re-tune) for an older
    schema or anything malformed.  Nothing here raises."""
    try:
        if int(rec.get("schema", 1)) != CACHE_SCHEMA:
            return None
        flow = rec.get("flow")
        cand = Candidate(
            order=rec["order"],
            num_channels=int(rec["num_channels"]),
            accum_dtype=rec["accum_dtype"],
            comp_tile=tuple(int(t) for t in rec["comp_tile"]),
            flow=None if flow is None else str(flow),
        )
        cand.channel("_probe")  # the specs validate order, dtypes and tile
        sweep = rec.get("sweep")
        return {
            "candidate": cand,
            "ranker": str(rec["ranker"]),
            "score": float(rec["score"]),
            "score_iqr": float(rec.get("score_iqr_us", 0.0)),
            "sweep": dict(sweep) if isinstance(sweep, dict) else None,
        }
    except (AttributeError, KeyError, TypeError, ValueError):
        return None


def _resolve_ranker(ranker: Optional[str], world) -> str:
    choice = ranker or os.environ.get(_ENV_RANKER) or "auto"
    if choice not in RANKERS:
        raise ValueError(f"unknown ranker {choice!r}; one of {RANKERS}")
    if choice == "auto":
        choice = "measure" if world.device.type == "cuda" else "model"
    if choice == "measure" and capturing():
        warnings.warn(
            "repro_torch.tune: a CUDA graph is being captured, so nothing can be timed; ranking with the cost "
            "model (resolve the shape before the capture to use a measured winner)",
            stacklevel=3,
        )
        choice = "model"
    return choice


def autotune(
    kind: str,
    *,
    signature: Sequence[int],
    world,
    axis: str = "model",
    backend: str = "eager",
    dtype: torch.dtype = torch.float32,
    base: Optional[BlockChannel] = None,
    ranker: Optional[str] = None,
    space: Space = DEFAULT_SPACE,
    cache_dir: Optional[str] = None,
    force: bool = False,
    repeats: int = 10,
    warmup: int = 2,
) -> TuneResult:
    """Find (or recall) the best design point for ``(kind, signature)`` on
    ``world`` (a :class:`~repro_torch.backend.mesh.World`), ``backend`` and
    operand ``dtype``.  ``signature`` is per rank (:func:`signature`);
    ``force=True`` re-ranks on a hit and overwrites the entry."""
    sig = tuple(int(s) for s in signature)
    size = world.size
    target = Target(backend=backend, device=world.device, dtype=dtype)
    fp = _cache.fingerprint(world, axis=axis, backend=backend)
    key = _entry_key(kind, axis, size, dtype, sig, space)

    if not force:
        rec = _cache.load_entry(fp, key, directory=cache_dir)
        if rec is not None:
            rec = _parse_record(rec)
        if rec is not None and _wants_measure_upgrade(rec, ranker):
            rec = None
        if rec is not None:
            cand = rec["candidate"]
            return TuneResult(
                kind=kind, signature=sig, candidate=cand, channel=cand.channel(axis, base), ranker=rec["ranker"],
                score=rec["score"], cache_hit=True, fingerprint=fp, considered=0, score_iqr=rec["score_iqr"],
                sweep=rec["sweep"],
            )  # fmt: skip

    use = _resolve_ranker(ranker, world)
    cands = enumerate_candidates(kind, extent=chunk_extent(kind, sig), space=space, sig=sig, world=size, target=target)
    best_iqr, sweep_stats = 0.0, None
    if use == "measure":
        case = _measure.CaseTimer(kind, world, sig, backend=backend, dtype=dtype)

        def timer(cand, *, repeats=repeats, warmup=warmup):
            return case.time(cand.channel(axis, base), repeats=repeats, warmup=warmup)

        sw = _sweep.measured_sweep(kind, sig, size, cands, timer, repeats=repeats, warmup=warmup, target=target)
        best, best_score, best_iqr, sweep_stats = sw.winner, sw.median_us, sw.iqr_us, sw.stats
    else:
        best, best_score = None, float("inf")
        for cand in cands:
            score = _cost.predict_cost(kind, sig, size, cand, target)
            if score < best_score:  # strict: ties keep enumeration order
                best, best_score = cand, score

    record = {
        "schema": CACHE_SCHEMA,
        "kind": kind,
        "signature": list(sig),
        "world": size,
        "dtype": dtype_name(dtype),
        "order": best.order,
        "num_channels": best.num_channels,
        "accum_dtype": best.accum_dtype,
        "comp_tile": list(best.comp_tile),
        "flow": best.flow,
        "ranker": use,
        "score": best_score,
        "score_unit": "us_measured" if use == "measure" else "s_predicted",
        "considered": len(cands),
    }
    if use == "measure":
        record["score_iqr_us"] = best_iqr
        record["sweep"] = sweep_stats
    _cache.store_entry(fp, key, record, directory=cache_dir)
    return TuneResult(
        kind=kind, signature=sig, candidate=best, channel=best.channel(axis, base), ranker=use, score=best_score,
        cache_hit=False, fingerprint=fp, considered=len(cands), score_iqr=best_iqr, sweep=sweep_stats,
    )  # fmt: skip


def resolve_seq(
    *,
    shapes: Optional[Sequence[Tuple[int, ...]]] = None,
    sig: Optional[Sequence[int]] = None,
    world,
    axis: str = "model",
    dtype: torch.dtype = torch.float32,
    base: Optional[BlockChannel] = None,
    ranker: Optional[str] = None,
    space: Space = DEFAULT_SPACE,
) -> Tuple[bool, BlockChannel, BlockChannel]:
    """Seam-aware resolution for ``compile_overlap([...], "auto")``:
    ``(fused, ch_rs, ch_ag)``.  The fused seam is priced over the
    shared-channel candidates with the seam saving credited; the unfused
    pair takes each half's own tuned winner, priced on the same model.  The
    seam runs on the eager executor (the only backend with a seam), so the
    halves tune for "eager"."""
    if sig is None:
        if shapes is None:
            raise ValueError("resolve_seq needs shapes or a signature")
        sig = signature(SEQ_KIND, [tuple(s) for s in shapes])
    sig = tuple(int(s) for s in sig)
    size = world.size
    target = Target(backend="eager", device=world.device, dtype=dtype)

    best_f, best_f_score = None, float("inf")
    for cand in enumerate_seq_candidates(sig=sig, world=size, space=space, target=target):
        score = _cost.predict_seq_cost(sig, size, cand, fused=True, target=target)
        if score < best_f_score:
            best_f, best_f_score = cand, score

    sig_rs, sig_ag = seq_sigs(sig, size)
    tune_kw = dict(world=world, axis=axis, backend="eager", dtype=dtype, base=base, ranker=ranker, space=space)
    res_rs = autotune("matmul_rs", signature=sig_rs, **tune_kw)
    res_ag = autotune("ag_matmul", signature=sig_ag, **tune_kw)
    unfused = _cost.predict_cost("matmul_rs", sig_rs, size, res_rs.candidate, target) + _cost.predict_cost(
        "ag_matmul", sig_ag, size, res_ag.candidate, target
    )
    if best_f is not None and best_f_score <= unfused:
        ch = best_f.channel(axis, base)
        return True, ch, ch
    return False, res_rs.channel, res_ag.channel


def resolve_a2a(
    *,
    shapes: Optional[Sequence[Tuple[int, ...]]] = None,
    sig: Optional[Sequence[int]] = None,
    world,
    axis: str = "model",
    backend: str = "eager",
    dtype: torch.dtype = torch.float32,
    base: Optional[BlockChannel] = None,
    ranker: Optional[str] = None,
    space: Space = DEFAULT_SPACE,
    capacity_factor: Optional[float] = None,
    imbalance: Optional[float] = None,
) -> Tuple[bool, BlockChannel, BlockChannel]:
    """Joint resolution for ``compile_overlap(["a2a_dispatch", "combine_rs"],
    "auto")``: ``(fused, ch_dispatch, ch_combine)``, priced by the model over
    the shared-channel candidates with the pipeline overlap credited; the
    unfused baseline only when no shared candidate builds.  As in the JAX
    package this is model-ranked (``ranker`` is accepted and unused): the
    pair has no single-op measured path."""
    del ranker
    size = world.size
    if sig is None:
        if shapes is None:
            raise ValueError("resolve_a2a needs shapes or a signature")
        shapes = [tuple(s) for s in shapes]
        cap_rows = None
        if capacity_factor is not None:
            from repro_torch.core.moe_overlap import _capacity

            m_loc, top_k, e_loc = shapes[0][-2], shapes[1][-1], shapes[3][0]
            cap_rows = _capacity(int(m_loc), int(top_k), max(1, int(e_loc) * size), float(capacity_factor))
        sig = signature(A2A_SEQ_KIND, shapes, imbalance=imbalance, capacity=cap_rows)
    sig = tuple(int(s) for s in sig)
    target = Target(backend=backend, device=world.device, dtype=dtype)

    best, best_score = None, float("inf")
    for cand in enumerate_a2a_candidates(sig=sig, world=size, space=space, target=target):
        score = _cost.predict_a2a_cost(sig, size, cand, fused=True, target=target)
        if score < best_score:
            best, best_score = cand, score
    if best is None:
        ch = (base or BlockChannel(axis=axis)).with_(axis=axis)
        return False, ch, ch
    ch = best.channel(axis, base)
    return True, ch, ch


def resolve_channel(
    kind: str,
    *,
    shapes: Optional[Sequence[Tuple[int, ...]]] = None,
    sig: Optional[Sequence[int]] = None,
    world,
    axis: str = "model",
    backend: str = "eager",
    dtype: torch.dtype = torch.float32,
    base: Optional[BlockChannel] = None,
    ranker: Optional[str] = None,
    space: Space = DEFAULT_SPACE,
) -> BlockChannel:
    """The tuned ``BlockChannel`` for an op call (per-rank ``shapes`` or a
    signature); non-tuned fields come from ``base``."""
    if sig is None:
        if shapes is None:
            raise ValueError("resolve_channel needs shapes or a signature")
        sig = signature(kind, [tuple(s) for s in shapes])
    res = autotune(
        kind, signature=sig, world=world, axis=axis, backend=backend, dtype=dtype, base=base, ranker=ranker,
        space=space,
    )  # fmt: skip
    return res.channel
