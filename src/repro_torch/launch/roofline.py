"""Roofline terms on one NVIDIA H100 — the Hopper half of ``repro/launch/roofline.py``.

  compute term    = FLOPs / peak FLOP/s (bf16 on the tensor cores, or the
                    float32 FMA rate)
  memory term     = bytes / HBM bandwidth
  collective term = collective bytes / link bandwidth

``HW`` holds the card's published peaks (NVIDIA's H100 SXM data sheet, dense,
at the full 700 W power limit), the same numbers ``PERF.md`` states its
bounds with.  The link bandwidth is the one a peer store of the port's
``World`` sees: its W ranks are emulated on one card in one allocation, so
a store into another rank's slice is an HBM store and moves at the HBM rate.
Real NVLink peers (900 GB/s of NVLink 4 per card, both directions summed)
come with a multi-GPU transport, which is not ported yet.

The JAX package's ``parse_collective_bytes`` reads XLA's optimized HLO text;
the port compiles no HLO, so it has no counterpart here.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["HW", "roofline_terms", "model_flops", "dominant"]

HW = {
    "peak_flops": 989e12,  # bf16 / fp16 FLOP/s on the tensor cores
    "peak_flops_f32": 67e12,  # float32 FLOP/s outside the tensor cores (the FMA route)
    "hbm_bw": 3.35e12,  # B/s of HBM3
    # B/s of a peer store between World's emulated ranks: an HBM store on the one card
    "link_bw": 3.35e12,
}


def roofline_terms(cost: dict, collective_bytes: float, *, peak_flops: float = None) -> Dict[str, float]:
    """Three roofline terms (seconds) from a cost record with ``"flops"`` and
    ``"bytes accessed"`` (the JAX package's ``cost_analysis()`` keys) and the
    collective bytes; ``peak_flops`` defaults to the bf16 peak."""
    flops = float(cost.get("flops", 0.0) or 0.0)
    byts = float(cost.get("bytes accessed", 0.0) or 0.0)
    return {
        "compute_s": flops / (peak_flops or HW["peak_flops"]),
        "memory_s": byts / HW["hbm_bw"],
        "collective_s": collective_bytes / HW["link_bw"],
        "flops": flops,
        "bytes": byts,
        "collective_bytes": collective_bytes,
    }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); D = tokens processed.

    ``shape`` has ``kind`` ("train" | "prefill" | "decode"), ``global_batch``
    and ``seq_len``.  train counts forward and backward (6ND); prefill 2ND;
    decode 2ND for one generated token per sequence."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def dominant(terms: Dict[str, float]) -> str:
    """The largest of the three roofline terms' keys."""
    return max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
