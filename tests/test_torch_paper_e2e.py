"""The port's Fig. 11 benchmark (``benchmarks/paper_e2e.py``) on the CPU, and
the donated train step it runs.

``run_row`` on all six families at a tiny size (reduced configs, 2 layers
— gemma3-27b 6, one 5:1 period, its window 16 below the 32-token sequence;
granite-moe-3b-a800m 2 MoE layers, deepseek-moe-16b its dense first layer
and a MoE layer —, W = 4, float32): the baseline and overlap modes'
first-step losses on the same weights within the logits' bound (2e-3 +
2e-3 |loss|), every step's loss finite, no kernel launched (the CPU runs
the plain versions), no time reported off the card; the depth cuts and the
launches a step expected on the card.  The donated step (``donate=True``,
the reference's keyword) against the copying one: bitwise the same
parameters and moments over three steps, the given state updated in place.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.backend.mesh import World
from repro_torch.benchmarks import paper_e2e
from repro_torch.configs import get_config, reduce_config
from repro_torch.data import SyntheticLM
from repro_torch.models import lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.optimizer import tree_leaves, tree_map
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

TINY = dict(dtype=torch.float32, batch=1, seq=32, warmup=1, pairs=1)


def _tiny(arch):
    cfg = reduce_config(get_config(arch), vocab=128)
    if cfg.local_window:
        return dataclasses.replace(cfg, local_window=16, n_layers=len(cfg.pattern))
    return dataclasses.replace(cfg, n_layers=2)


@pytest.mark.parametrize("arch", paper_e2e.MODELS)
def test_row_on_the_cpu_baseline_equals_overlap(arch):
    row = paper_e2e.run_row(_tiny(arch), World(4, "cpu"), **TINY)
    first = row["first_loss"]
    assert abs(first["baseline"] - first["overlap"]) <= 2e-3 + 2e-3 * abs(first["overlap"])
    assert all(math.isfinite(v) for m in paper_e2e.MODES for v in row["step_loss"][m])
    assert all(len(row["step_loss"][m]) == TINY["warmup"] + TINY["pairs"] for m in paper_e2e.MODES)
    assert all(not any(c.values()) for m in paper_e2e.MODES for c in row["launches"][m])  # plain versions only
    assert row["peak_bytes"] is None and "median_ms" not in row and row["step_ms"] == {"baseline": [], "overlap": []}


def test_cells_and_expected_launches():
    assert set(paper_e2e.DEPTH) == set(paper_e2e.MODELS)
    layers = {a: paper_e2e.e2e_config(a).n_layers for a in paper_e2e.MODELS}
    assert layers == {"smollm-360m": 32, "qwen2-72b": 2, "starcoder2-7b": 8, "gemma3-27b": 6,
                      "granite-moe-3b-a800m": 32, "deepseek-moe-16b": 9}  # fmt: skip
    gemma = paper_e2e.e2e_config("gemma3-27b")
    assert [d.window for d in lm.layer_plan(gemma)] == [1024] * 5 + [None]  # one 5:1 period
    for arch in paper_e2e.MODELS:  # published widths
        cut, full = paper_e2e.e2e_config(arch), get_config(arch)
        assert dataclasses.replace(cut, n_layers=full.n_layers) == full
    cfg = paper_e2e.e2e_config("qwen2-72b")
    assert paper_e2e.expected_launches(cfg, "overlap") == {
        "matmul": 1, "ag_gemm": 8, "gemm_rs": 8, "flash_attention": 2, "grouped_matmul": 0, "ssd_intra_chunk": 0}
    assert paper_e2e.expected_launches(cfg, "baseline") == {
        "matmul": 1, "ag_gemm": 0, "gemm_rs": 0, "flash_attention": 2, "grouped_matmul": 0, "ssd_intra_chunk": 0}
    # MoE layers: 2 grouped GEMMs at each of the W = 4 ring steps, forward and dx; attention's pair both passes
    granite = paper_e2e.e2e_config("granite-moe-3b-a800m")
    assert paper_e2e.expected_launches(granite, "overlap") == {
        "matmul": 1, "ag_gemm": 64, "gemm_rs": 64, "flash_attention": 32, "grouped_matmul": 512, "ssd_intra_chunk": 0}
    # deepseek: the dense first layer's MLP and 8 MoE layers' shared MLPs as dense layers
    deepseek = paper_e2e.e2e_config("deepseek-moe-16b")
    assert [d.kind for d in lm.layer_plan(deepseek)] == ["attn_dense"] + ["attn"] * 8
    assert paper_e2e.expected_launches(deepseek, "overlap") == {
        "matmul": 1, "ag_gemm": 36, "gemm_rs": 36, "flash_attention": 9, "grouped_matmul": 128, "ssd_intra_chunk": 0}
    for moe_cfg in (granite, deepseek):
        assert paper_e2e.expected_launches(moe_cfg, "baseline") == {
            "matmul": 1, "ag_gemm": 0, "gemm_rs": 0, "flash_attention": moe_cfg.n_layers, "grouped_matmul": 0,
            "ssd_intra_chunk": 0}  # fmt: skip
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            paper_e2e.main([])


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-72b"])
def test_donated_step_equals_the_copying_step(arch):
    """Three steps with ``donate=True`` against ``donate=False`` from equal
    states: bitwise equal parameters, moments and losses; the donated run
    updated the state it was given in place, the copying run did not."""
    cfg = dataclasses.replace(reduce_config(get_config(arch), vocab=128), n_layers=2)
    world = World(4, "cpu")
    pc = ParallelContext(world=world, backend="fused")
    params = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    if cfg.qkv_bias:  # a non-zero bias, so it moves like a weight
        params["layers"][0]["mixer"]["bqkv"] = torch.randn(params["layers"][0]["mixer"]["bqkv"].shape)
    runs = {}
    for donate in (False, True):
        p = tree_map(torch.clone, params)
        o = init_opt_state(lm.trainable(p, cfg))
        p0, o0 = p, o
        step = make_train_step(lm, cfg, pc, AdamWConfig(lr=1e-2, total_steps=10, warmup_steps=1),
                               grad_masks=lm.grad_masks(cfg, pc), donate=donate)  # fmt: skip
        pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=3)
        losses = []
        for _ in range(3):
            p, o, m = step(p, o, pipe.host_batch())
            losses.append(m["loss"])
        moved = not torch.equal(p0["layers"][0]["mixer"]["wqkv"], params["layers"][0]["mixer"]["wqkv"])
        assert moved == donate and (o0["mu"]["embed"].abs().sum().item() > 0) == donate
        runs[donate] = (p, o, losses)
    for a, b in zip(tree_leaves(runs[False]), tree_leaves(runs[True])):
        assert torch.equal(a, b)
    assert np.isfinite([x.item() for x in runs[True][2]]).all()
