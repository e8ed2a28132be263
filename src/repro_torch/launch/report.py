"""Aggregate the port's dry-run JSONs into the roofline table — the port of
``repro/launch/report.py`` (the same columns, ``fmt_t`` and ``fmt_b``).

The collective column is the port's per-axis term (each mesh axis's bytes
at its own link rate, ``launch/roofline``), not the reference's flat
50 GB/s over all kinds; mem/dev is the temporaries plus the arguments per
device (both per device in the port's results).

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--dir results/dryrun_torch]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT

__all__ = ["SHAPE_ORDER", "fmt_t", "fmt_b", "load", "table", "main"]

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def fmt_t(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def fmt_b(x):
    if x is None:
        return "-"
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x / div:.1f}{unit}"
    return f"{x:.0f}B"


def load(dirname):
    cells = {}
    for f in glob.glob(os.path.join(dirname, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        cells[(r["arch"], r["shape"], "mp" if r["multi_pod"] else "sp", r.get("mode", "overlap"))] = r
    return cells


def _cells(results) -> dict:
    return {(r["arch"], r["shape"], "mp" if r["multi_pod"] else "sp", r.get("mode", "overlap")): r for r in results}


def table(cells, mode: str = "overlap") -> str:
    """The markdown table of ``cells`` (``load``'s mapping, or a list of
    ``run_cell`` results)."""
    if isinstance(cells, list):
        cells = _cells(cells)
    archs = sorted({k[0] for k in cells})
    lines = ["| arch | shape | compute | memory | collective | dominant | useful-FLOPs | mem/dev | mp-512 |",
             "|---|---|---|---|---|---|---|---|---|"]  # fmt: skip
    n_ok = n_skip = 0
    for arch in archs:
        for shape in SHAPE_ORDER:
            sp = cells.get((arch, shape, "sp", mode))
            mp = cells.get((arch, shape, "mp", mode))
            if sp is None:
                continue
            if sp["status"] == "skipped":
                n_skip += 1
                lines.append(f"| {arch} | {shape} | — | — | — | skipped ({sp['reason'][:40]}…) | — | — | "
                             f"{'skip' if mp and mp['status'] == 'skipped' else '?'} |")  # fmt: skip
                continue
            if sp["status"] != "ok":
                lines.append(f"| {arch} | {shape} | — | — | — | {sp['status']} | — | — | — |")
                continue
            n_ok += 1
            r = sp["roofline"]
            mem = sp.get("memory") or {}
            per_dev = None
            if mem.get("temp_size_in_bytes") is not None:
                per_dev = mem["temp_size_in_bytes"] + (mem.get("argument_size_in_bytes") or 0)
            mp_s = "-"
            if mp is not None:
                mp_s = "ok" if mp["status"] == "ok" else mp["status"]
            lines.append(f"| {arch} | {shape} | {fmt_t(r['compute_s'])} | {fmt_t(r['memory_s'])} | "
                         f"{fmt_t(r['collective_s'])} | {sp['dominant'].replace('_s', '')} | "
                         f"{sp['useful_flops_ratio']:.2f} | {fmt_b(per_dev)} | {mp_s} |")  # fmt: skip
    lines.append(f"\n{n_ok} baselined cells, {n_skip} skipped (long_500k on pure full-attention archs).")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DEFAULT_OUT)
    ap.add_argument("--mode", default="overlap")
    args = ap.parse_args(argv)
    print(table(load(args.dir), args.mode))


if __name__ == "__main__":
    main()
