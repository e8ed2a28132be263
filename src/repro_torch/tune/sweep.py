"""Successive-halving measured sweep with cost-model screening and an early exit.

The port's copy of ``repro/tune/sweep.py``, unchanged in meaning:

  1. **rank** — the candidates are ordered by the cost model (``tune/cost.py``);
  2. **screen** — only a cost-ordered prefix (``screen_fraction`` of the
     space, at least ``min_screen`` points) is timed at all, one repeat
     each; the rest is pruned unmeasured;
  3. **promote** — the best ``keep_fraction`` of the screen, re-ordered by
     screen time, gets full-repeat ``(median, iqr)`` timing; the loop stops
     once the next screen time exceeds the incumbent's median plus its iqr.

The timer is a callable, so tests substitute a deterministic one.

Environment knobs:

  ``REPRO_TUNE_SWEEP``         "0" disables pruning (every candidate timed
                               at full repeats, the exhaustive sweep);
  ``REPRO_TUNE_SWEEP_SCREEN``  the screened fraction (default 0.4);
  ``REPRO_TUNE_SWEEP_KEEP``    the promoted fraction of the screen (default 0.25).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from repro_torch.tune import cost as _cost
from repro_torch.tune.candidates import Candidate

__all__ = ["SweepConfig", "SweepResult", "sweep_config_from_env", "measured_sweep"]

_ENV_ENABLE = "REPRO_TUNE_SWEEP"
_ENV_SCREEN = "REPRO_TUNE_SWEEP_SCREEN"
_ENV_KEEP = "REPRO_TUNE_SWEEP_KEEP"

Timer = Callable[..., Tuple[float, float]]  # (candidate, repeats=, warmup=) -> (median_us, iqr_us)


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Knobs of the pruned sweep (:func:`sweep_config_from_env` applies the environment)."""

    enabled: bool = True
    screen_fraction: float = 0.4
    keep_fraction: float = 0.25
    min_screen: int = 4
    min_keep: int = 2

    def __post_init__(self):
        if not (0.0 < self.screen_fraction <= 1.0 and 0.0 < self.keep_fraction <= 1.0):
            raise ValueError(
                f"sweep fractions must be in (0, 1]: screen={self.screen_fraction}, keep={self.keep_fraction}"
            )


def sweep_config_from_env() -> SweepConfig:
    """The config with the ``REPRO_TUNE_SWEEP*`` overrides applied."""
    kw: Dict[str, Any] = {}
    flag = os.environ.get(_ENV_ENABLE)
    if flag is not None:
        kw["enabled"] = flag.strip().lower() not in ("0", "false", "off", "no")
    screen = os.environ.get(_ENV_SCREEN)
    if screen:
        kw["screen_fraction"] = float(screen)
    keep = os.environ.get(_ENV_KEEP)
    if keep:
        kw["keep_fraction"] = float(keep)
    return SweepConfig(**kw)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """The winner of one measured sweep and the pruning ledger."""

    winner: Candidate
    median_us: float
    iqr_us: float
    stats: Dict[str, Any]  # total / screened / timed / pruned / early_exit


def _exhaustive(cands, timer, repeats, warmup) -> SweepResult:
    best, best_med, best_iqr = None, float("inf"), 0.0
    for cand in cands:
        med, iqr = timer(cand, repeats=repeats, warmup=warmup)
        if med < best_med:  # strict: ties keep enumeration order
            best, best_med, best_iqr = cand, med, iqr
    stats = {"total": len(cands), "screened": len(cands), "timed": len(cands), "pruned": 0, "early_exit": False}
    return SweepResult(winner=best, median_us=best_med, iqr_us=best_iqr, stats=stats)


def measured_sweep(
    kind: str,
    sig: Sequence[int],
    world: int,
    cands: Sequence[Candidate],
    timer: Timer,
    *,
    repeats: int = 3,
    warmup: int = 1,
    config: Optional[SweepConfig] = None,
    target=None,
) -> SweepResult:
    """Pruned measured search over ``cands`` (module docstring); a disabled
    or degenerate config runs the exhaustive full-repeat sweep."""
    if not cands:
        raise ValueError("measured_sweep needs at least one candidate")
    cfg = config or sweep_config_from_env()
    n = len(cands)
    n_screen = min(n, max(cfg.min_screen, math.ceil(cfg.screen_fraction * n)))
    if not cfg.enabled or n_screen >= n:
        return _exhaustive(cands, timer, repeats, warmup)

    sig = tuple(int(s) for s in sig)
    order = sorted(range(n), key=lambda i: _cost.predict_cost(kind, sig, world, cands[i], target))
    screened = []
    for i in order[:n_screen]:
        med, _ = timer(cands[i], repeats=1, warmup=warmup)
        screened.append((i, med))
    screened.sort(key=lambda t: t[1])  # stable: model-order ties keep the cheaper predicted point
    n_keep = min(len(screened), max(cfg.min_keep, math.ceil(cfg.keep_fraction * len(screened))))

    best, best_med, best_iqr, timed, early = None, float("inf"), 0.0, 0, False
    for i, screen_us in screened[:n_keep]:
        if best is not None and screen_us > best_med + best_iqr:
            early = True  # the incumbent beats every remaining screen by more than its noise band
            break
        med, iqr = timer(cands[i], repeats=repeats, warmup=warmup)
        timed += 1
        if med < best_med:
            best, best_med, best_iqr = cands[i], med, iqr
    stats = {"total": n, "screened": n_screen, "timed": timed, "pruned": n - n_screen, "early_exit": early}
    return SweepResult(winner=best, median_us=best_med, iqr_us=best_iqr, stats=stats)
