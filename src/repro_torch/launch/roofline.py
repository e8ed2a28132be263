"""Roofline terms on NVIDIA H100s — the port of ``repro/launch/roofline.py``.

  compute term    = FLOPs / peak FLOP/s (bf16 on the tensor cores, or the
                    float32 FMA rate)
  memory term     = bytes / HBM bandwidth
  collective term = sum over the mesh's axes of that axis's collective
                    bytes / its link bandwidth

``HW`` holds data-sheet figures of the H100 SXM at its full 700 W power
limit (NVIDIA's data sheet, dense), not measurements: the peaks and HBM3
rate ``PERF.md`` states its bounds with, and per-axis link rates for the
production mesh (``launch/mesh``), each per direction: ``"model"`` NVLink 4
within one HGX node (900 GB/s per GPU both directions summed, so 450 GB/s
each way), ``"data"`` / ``"pod"`` one 400 Gb/s NDR InfiniBand port per GPU
(50 GB/s).  ``link_bw`` is the rate a peer store of the port's emulated
``World`` sees, the dev mesh's model axis: its W ranks share one card's
allocation, so a store into another rank's slice is an HBM store.

:func:`collective_bytes` is the counterpart of the JAX package's
``parse_collective_bytes``: that one reads XLA's optimized HLO text, this
one reads the port's own transport (``World.counting``'s
:class:`~repro_torch.backend.mesh.CommCounter`) and weights each kind as it
does: an all-gather by (g-1)/g of its gathered payload, a reduce-scatter by
g-1 of its scattered one, an all-reduce by 2(g-1)/g, and the permutes by
their busiest link direction.  :func:`data_axis_bytes` counts the traffic
of the data axes, which the emulated world does not run, from the
parameter specs (ZeRO-3: an all-gather of each data-sharded leaf per use,
again where the backward recomputes it, and a reduce-scatter of its
gradient; an all-reduce of every other gradient).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Sequence, Tuple, Union

__all__ = ["HW", "HLO_KINDS", "collective_bytes", "data_axis_bytes", "roofline_terms", "model_flops", "dominant"]

HW = {
    "peak_flops": 989e12,  # bf16 / fp16 FLOP/s on the tensor cores
    "peak_flops_f32": 67e12,  # float32 FLOP/s outside the tensor cores (the FMA route)
    "hbm_bw": 3.35e12,  # B/s of HBM3
    # B/s of a peer store between World's emulated ranks: an HBM store on the one card
    "link_bw": 3.35e12,
    # B/s per direction of each production-mesh axis: NVLink 4 in a node; one NDR port per GPU across nodes
    "axis_bw": {"model": 450e9, "data": 50e9, "pod": 50e9},
}

# the transport's kinds under the names the JAX package's HLO parser reports
HLO_KINDS = {"permute": "collective-permute", "psum": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter"}  # fmt: skip


def _weight(kind: str, g: int) -> float:
    """The ring traffic factor of a collective over g ranks (``parse_collective_bytes``'s)."""
    if g <= 1:
        return 0.0
    if kind == "all_gather":
        return (g - 1) / g
    if kind == "reduce_scatter":
        return float(g - 1)  # the payload is the scattered (1/g) block
    if kind == "psum":
        return 2 * (g - 1) / g
    raise ValueError(f"no ring weight for {kind!r}")


def collective_bytes(counter) -> Tuple[float, Dict[str, float]]:
    """Per-device link bytes of what a world's transport moved
    (a :class:`~repro_torch.backend.mesh.CommCounter`): (total, per kind,
    keyed as :data:`HLO_KINDS`).  The permutes' total is their busiest
    direction (full-duplex links); their per-kind entry sums both."""
    kinds: Dict[str, float] = {}
    for kind, by_group in counter.payload.items():
        if not by_group:
            continue
        if kind == "permute":
            kinds[HLO_KINDS[kind]] = float(sum(by_group.values()))
        else:
            kinds[HLO_KINDS[kind]] = float(sum(b * _weight(kind, g) for g, b in by_group.items()))
    permute_link = max(counter.permute_dirs.values()) if counter.permute_dirs else 0.0
    rest = sum(v for k, v in kinds.items() if k != HLO_KINDS["permute"])
    return rest + permute_link, kinds


def data_axis_bytes(leaves: Iterable[tuple], mesh_axes: Mapping[str, int], dp_axes: Sequence[str], *, train: bool,
                    recompute: bool) -> Tuple[float, Dict[str, float]]:  # fmt: skip
    """Per-device link bytes of the data axes for one step, from the specs.

    ``leaves``: (shape, dtype, spec, uses, trainable[, regathered]) of
    every parameter leaf; ``uses`` is how many times the forward gathers it,
    ``regathered`` (default True) whether a recomputing backward runs those
    gathers again (False for a leaf outside every remat'd body).  A leaf that the
    data axes split is all-gathered over them before each use (its payload
    the gathered block, weight (g-1)/g), again before each use the backward
    recomputes (``recompute``), and its gradient reduce-scattered back
    (weight g-1 on its stored block); a trainable leaf they do not split
    has its gradient all-reduced over all of them (2(g-1)/g).  Returns
    (total, per kind keyed as :data:`HLO_KINDS`)."""
    from repro_torch.parallel.sharding import axes_of, per_device_bytes

    g_all = math.prod(mesh_axes.get(a, 1) for a in dp_axes)
    kinds = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    for shape, dtype, spec, uses, trainable, *rest in leaves:
        regathered = rest[0] if rest else True
        stored = per_device_bytes(shape, dtype, spec, mesh_axes)
        g = math.prod(mesh_axes.get(a, 1) for a in axes_of(spec) if a in dp_axes)
        if g > 1:
            gathers = uses * (2 if (train and recompute and regathered) else 1)
            kinds["all-gather"] += gathers * stored * g * _weight("all_gather", g)
            if train and trainable:
                kinds["reduce-scatter"] += stored * _weight("reduce_scatter", g)
        elif train and trainable and g_all > 1:
            kinds["all-reduce"] += stored * _weight("psum", g_all)
    kinds = {k: v for k, v in kinds.items() if v}
    return sum(kinds.values()), kinds


def roofline_terms(
    cost: dict, collective_bytes: Union[float, Mapping[str, float]], *, peak_flops: float = None,
    link_bw: Mapping[str, float] = None,
) -> Dict[str, float]:  # fmt: skip
    """Three roofline terms (seconds) from a cost record with ``"flops"`` and
    ``"bytes accessed"`` (the JAX package's ``cost_analysis()`` keys) and the
    collective bytes: one number at ``HW["link_bw"]``, or bytes per mesh
    axis, each over its own rate (``link_bw``, default ``HW["axis_bw"]``);
    ``peak_flops`` defaults to the bf16 peak."""
    flops = float(cost.get("flops", 0.0) or 0.0)
    byts = float(cost.get("bytes accessed", 0.0) or 0.0)
    if isinstance(collective_bytes, Mapping):
        rates = HW["axis_bw"] if link_bw is None else link_bw
        coll_s = sum(b / rates[a] for a, b in collective_bytes.items() if b)
        coll = float(sum(collective_bytes.values()))
    else:
        coll_s, coll = collective_bytes / HW["link_bw"], float(collective_bytes)
    return {
        "compute_s": flops / (peak_flops or HW["peak_flops"]),
        "memory_s": byts / HW["hbm_bw"],
        "collective_s": coll_s,
        "flops": flops,
        "bytes": byts,
        "collective_bytes": coll,
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
