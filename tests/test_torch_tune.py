"""The port's tuner (``repro_torch.tune``, the Hopper ``launch/roofline``)
held against the JAX package's ``repro.tune`` on the CPU.

The comm half enumerates as the reference's (order, C, accum dtype, by
name, in order, the seam's and the a2a pair's too); signatures, their
splits and chunk extents are equal; the successive-halving sweep keeps the
reference's winner and pruning ledger under one deterministic timer; with
the reference's hardware numbers injected the cost model's comm terms are
the reference's.  The compute and wire halves enumerate what the port's
code honours (no tile a kernel's route ignores, no wire a backend refuses),
and every eager candidate compiles and runs.  ``compile_overlap("auto")``
(single, seam and a2a forms) equals the same call with the resolved
channels pinned, bitwise in f32, and the reference's ``compile_overlap``
with those channels within 1e-5; a reduced smollm prefill under
``ParallelContext(tune=True)`` holds the reference's logits to 2e-3; the
engine resolves its four decode entries in ``__init__``.  Every cache lives
under ``tmp_path``.
"""

from __future__ import annotations

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import tune as jtune
from repro.compat import make_mesh, shard_map
from repro.configs import get_config as j_get_config
from repro.configs.base import _REGISTRY as J_REGISTRY
from repro.configs.base import SHAPES as J_SHAPES
from repro.core import BlockChannel as JChannel
from repro.core import CommSpec as JComm
from repro.core import CompSpec as JComp
from repro.core import compile_overlap as j_compile
from repro.core import quant as jq
from repro.launch import roofline as j_roofline
from repro.models import lm as jlm
from repro.parallel.sharding import place
from repro.tune import cost as j_cost
from repro.tune import sweep as j_sweep
from repro_torch import tune
from repro_torch.backend.hw import HopperInfo
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import _REGISTRY
from repro_torch.convert import from_jax_params, shard_cols, shard_rows
from repro_torch.core import BlockChannel, compile_overlap
from repro_torch.core import compiler as t_compiler
from repro_torch.core.comp_tiles import DEFAULT_TILE, fma_n_tile, resolve_tile
from repro_torch.launch import roofline
from repro_torch.models import lm
from repro_torch.nn import ffn
from repro_torch.parallel.context import ParallelContext
from repro_torch.serving import ServeEngine
from repro_torch.tune import cache as t_cache
from repro_torch.tune import candidates as t_cand
from repro_torch.tune import cost as t_cost
from repro_torch.tune import measure as t_measure
from repro_torch.tune import sweep as t_sweep
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from test_torch_training import j_jit
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

R = 4
ORDERS = ("ring", "bidir_ring", "all2all")
CPU_EAGER = tune.Target("eager", torch.device("cpu"), torch.float32)
# (kind, per-rank signatures): clamping extents (6 rows over C = 4), decode leads, MoE workload axes
SIGS = {
    "ag_matmul": [(1, 64, 32, 48), (2, 6, 16, 8), (-4, 1, 64, 32)],
    "matmul_rs": [(1, 64, 32, 48), (2, 32, 8, 6), (-8, 1, 16, 24)],
    "ag_attention": [(1, 4, 2, 16, 8), (2, 2, 1, 6, 8)],
    "ag_moe": [(16, 32, 2, 2, 8), (6, 16, 2, 1, 8, 5, 16)],
}
SEQ_SIGS = [(1, 32, 16, 16, 32), (2, 24, 8, 6, 16), (1, 16, 8, 8, 8)]
A2A_SIGS = [(16, 32, 2, 2, 8), (6, 16, 2, 1, 8, 6, 16)]


@pytest.fixture(autouse=True)
def tune_cache(tmp_path, monkeypatch):
    """Both packages' tuning caches under this test's tmp_path, never the home directory."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune"))
    monkeypatch.delenv("REPRO_TUNE_RANKER", raising=False)
    t_cache.clear_memo()
    jtune.cache.clear_memo()
    yield tmp_path / "tune"
    t_cache.clear_memo()
    jtune.cache.clear_memo()


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh((R,), ("model",))


@pytest.fixture(scope="module")
def world():
    return World(R, "cpu")


def _names(cands):
    return [(c.order, c.num_channels, c.accum_dtype, tuple(c.comp_tile), c.flow) for c in cands]


def _jchan(ch: BlockChannel) -> JChannel:
    """The reference's channel for a port channel (order, C, accum, tile, wire)."""
    return JChannel(
        axis=ch.axis,
        num_channels=ch.num_channels,
        comm=JComm(order=ch.comm.order),
        comp=JComp(tile=tuple(ch.comp.tile), accum_dtype=str(ch.comp.accum_dtype).removeprefix("torch.")),
        quant=jq.QuantSpec(wire_dtype=ch.quant.wire_dtype),
    )


# ---- enumeration, signatures, the sweep and the cost model against the reference ----------


def _targets(kind):
    """(target, reference filter): the comm half alone; the CPU's eager
    target on bf16 operands (every accum dtype as wide as the operands;
    ``ag_matmul``'s axis collapses to float32) and on float32 operands
    (float32 accumulation only: bf16 partials would be a lossy wire)."""
    bf16 = tune.Target("eager", torch.device("cpu"), torch.bfloat16)
    return [
        (None, lambda c: True),
        (bf16, lambda c: kind != "ag_matmul" or c.accum_dtype == "float32"),
        (CPU_EAGER, lambda c: c.accum_dtype == "float32"),
    ]


@pytest.mark.parametrize("kind", tune.TUNABLE_KINDS)
def test_comm_enumeration_matches_reference(kind):
    """Under DEFAULT_SPACE the port's comm half is the reference's, by name
    and in order, at every signature and world (with a target, less the
    accum dtypes the target's rule drops, and nothing else)."""
    for sig in SIGS[kind]:
        for w in (2, 3, 4, 8):
            kw = dict(extent=jtune.chunk_extent(kind, sig), sig=sig, world=w)
            ref = jtune.enumerate_candidates(kind, **kw)
            for target, keep in _targets(kind):
                got = tune.enumerate_candidates(kind, target=target, **kw)
                assert _names(got) == _names([c for c in ref if keep(c)]), (sig, w, target)
            assert _names(tune.enumerate_candidates(kind, extent=kw["extent"])) == _names(
                jtune.enumerate_candidates(kind, extent=kw["extent"])
            )


def test_seq_and_a2a_enumeration_match_reference():
    for w in (2, 4, 8):
        for target, keep in _targets("matmul_rs"):
            for sig in SEQ_SIGS:
                want = _names([c for c in jtune.enumerate_seq_candidates(sig=sig, world=w) if keep(c)])
                assert _names(tune.enumerate_seq_candidates(sig=sig, world=w, target=target)) == want, (sig, w)
            for sig in A2A_SIGS:
                want = _names([c for c in jtune.enumerate_a2a_candidates(sig=sig, world=w) if keep(c)])
                assert _names(tune.enumerate_a2a_candidates(sig=sig, world=w, target=target)) == want, (sig, w)
    assert tune.enumerate_seq_candidates(sig=(1, 30, 8, 8, 8), world=4) == ()  # rows do not divide
    # the wire axis opened: bf16 partials of float32 operands are offered again
    assert {c.accum_dtype for c in tune.enumerate_candidates(
        "matmul_rs", extent=48, sig=(1, 64, 32, 48), world=R, space=tune.QUANT_SPACE, target=CPU_EAGER)} == {
        "float32", "bfloat16"}  # fmt: skip


SHAPES = {
    "ag_matmul": [((3, 2, 16, 32), (32, 24)), ((16, 32), (32, 8))],
    "matmul_rs": [((2, 32, 8), (8, 16)), ((4, 1, 24), (24, 40))],
    "ag_attention": [((2, 4, 32, 8), (2, 2, 8, 8), (2, 2, 8, 8))],
    "ag_moe": [((2, 16, 32), (2, 16, 2), (2, 16, 2), (3, 32, 16), (3, 8, 32))],
}


@pytest.mark.parametrize("kind", tune.TUNABLE_KINDS)
def test_signatures_match_reference(kind):
    """``signature`` (``decode=True`` for the GEMM kinds, the MoE workload
    axes), ``chunk_extent``, ``seq_sigs`` and ``a2a_sigs`` are the reference's;
    both refuse the same misuse."""
    for shapes in SHAPES[kind]:
        sig = tune.signature(kind, shapes)
        assert sig == jtune.signature(kind, shapes)
        assert tune.chunk_extent(kind, sig) == jtune.chunk_extent(kind, sig)
        if kind in tune.GEMM_TILE_KINDS:
            assert tune.signature(kind, shapes, decode=True) == jtune.signature(kind, shapes, decode=True)
        else:
            for mod in (tune, jtune):
                with pytest.raises(ValueError, match="decode"):
                    mod.signature(kind, shapes, decode=True)
        if kind == "ag_moe":
            for imb, cap in ((1.3, None), (None, 13), (2.0, 40)):
                got = tune.signature(kind, shapes, imbalance=imb, capacity=cap)
                assert got == jtune.signature(kind, shapes, imbalance=imb, capacity=cap)
        else:
            with pytest.raises(ValueError, match="imbalance"):
                tune.signature(kind, shapes, capacity=8)
    seam = ((2, 32, 8), (8, 16), (16, 12))
    assert tune.signature(tune.SEQ_KIND, seam) == jtune.signature(jtune.SEQ_KIND, seam)
    for w in (2, 4):
        sig = tune.signature(tune.SEQ_KIND, seam)
        assert tune.seq_sigs(sig, w) == jtune.seq_sigs(sig, w)
        assert tune.a2a_sigs(A2A_SIGS[1], w) == jtune.a2a_sigs(A2A_SIGS[1], w)
    moe = SHAPES["ag_moe"][0]
    assert tune.signature(tune.A2A_SEQ_KIND, moe, capacity=9) == jtune.signature(jtune.A2A_SEQ_KIND, moe, capacity=9)


def _fake_time(label: str) -> float:
    """A deterministic timing oracle: a fixed number per candidate label."""
    return float(sum((i + 1) * ord(ch) for i, ch in enumerate(label)) % 97 + 10)


@pytest.mark.parametrize("screen,keep,enabled", [(0.4, 0.25, True), (0.3, 0.5, True), (1.0, 0.25, True), (0.4, 0.25, False)])
def test_measured_sweep_matches_reference(monkeypatch, screen, keep, enabled):
    """One deterministic timer, the candidates ordered by the reference's
    cost model on both sides: the winner, its score and the pruning ledger
    are the reference's; the environment knobs parse alike."""
    kind, sig, w = "matmul_rs", (2, 64, 32, 48), 4
    jc = jtune.enumerate_candidates(kind, extent=48, sig=sig, world=w)
    tc = tune.enumerate_candidates(kind, extent=48, sig=sig, world=w)
    assert _names(tc) == _names(jc)
    by_label = {c.label(): c for c in jc}
    monkeypatch.setattr(t_sweep._cost, "predict_cost", lambda k, s, wd, c, t=None: j_cost.predict_cost(k, s, wd, by_label[c.label()]))

    def timer(c, *, repeats=3, warmup=1):
        return _fake_time(c.label()) + (0.5 if repeats == 1 else 0.0), 0.25

    cfg_t = t_sweep.SweepConfig(enabled=enabled, screen_fraction=screen, keep_fraction=keep)
    cfg_j = j_sweep.SweepConfig(enabled=enabled, screen_fraction=screen, keep_fraction=keep)
    got = t_sweep.measured_sweep(kind, sig, w, tc, timer, config=cfg_t)
    want = j_sweep.measured_sweep(kind, sig, w, jc, timer, config=cfg_j)
    assert (got.winner.label(), got.median_us, got.iqr_us, got.stats) == (
        want.winner.label(), want.median_us, want.iqr_us, want.stats
    )  # fmt: skip
    monkeypatch.setenv("REPRO_TUNE_SWEEP", "0")
    monkeypatch.setenv("REPRO_TUNE_SWEEP_SCREEN", "0.5")
    monkeypatch.setenv("REPRO_TUNE_SWEEP_KEEP", "0.75")
    assert dataclasses.asdict(t_sweep.sweep_config_from_env()) == dataclasses.asdict(j_sweep.sweep_config_from_env())


def test_comm_terms_match_reference(monkeypatch):
    """With the reference's HW, ALPHA_S and BETA_TILE_S injected, the mean
    hop count, the step's wire bytes and flops and the comm time are the
    reference's for every kind, wire and accum dtype."""
    monkeypatch.setattr(t_cost, "HW", dict(j_roofline.HW))
    monkeypatch.setattr(t_cost, "ALPHA_S", j_cost.ALPHA_S)
    monkeypatch.setattr(t_cost, "BETA_TILE_S", j_cost.BETA_TILE_S)
    for order in ORDERS:
        for w in range(1, 9):
            assert t_cost._order_hops(order, w) == j_cost._order_hops(order, w)
    sigs = dict(SIGS, a2a_dispatch=A2A_SIGS, combine_rs=A2A_SIGS)
    for kind, kind_sigs in sigs.items():
        for sig in kind_sigs:
            for w in (2, 4, 8):
                for accum in ("float32", "bfloat16"):
                    for wire in (None, "int8", "float8_e4m3fn", "bfloat16", "float32"):
                        got = t_cost.step_terms(kind, sig, w, accum, wire)
                        assert got == j_cost.step_terms(kind, sig, w, accum, wire), (kind, sig, w, accum, wire)
                        for order in ORDERS:
                            for nch in (1, 2):
                                cand = tune.Candidate(order, nch, accum, flow=wire)
                                dirs = 2.0 if (order == "bidir_ring" and nch >= 2) else 1.0
                                want = got[0] * j_cost._order_hops(order, w) / (j_roofline.HW["link_bw"] * dirs)
                                assert t_cost._comm_time(kind, sig, w, cand) == want


def test_roofline_and_model_flops_match_reference():
    """The Hopper numbers; ``roofline_terms`` / ``dominant`` on them; the
    config's parameter counts and ``model_flops`` equal the reference's for
    every registered config and shape."""
    assert roofline.HW == {"peak_flops": 989e12, "peak_flops_f32": 67e12, "hbm_bw": 3.35e12, "link_bw": 3.35e12,
                           "axis_bw": {"model": 450e9, "data": 50e9, "pod": 50e9}}  # fmt: skip
    terms = roofline.roofline_terms({"flops": 989e9, "bytes accessed": 6.7e9}, 3.35e8)
    assert terms["compute_s"] == pytest.approx(1e-3) and terms["memory_s"] == pytest.approx(2e-3)
    assert terms["collective_s"] == pytest.approx(1e-4) and roofline.dominant(terms) == "memory_s"
    f32 = roofline.roofline_terms({"flops": 67e9}, 0.0, peak_flops=roofline.HW["peak_flops_f32"])
    assert f32["compute_s"] == pytest.approx(1e-3) and roofline.dominant(f32) == "compute_s"
    assert set(_REGISTRY) == set(J_REGISTRY)
    for name in _REGISTRY:
        tc, jc = get_config(name), j_get_config(name)
        assert (tc.param_count(), tc.active_param_count()) == (jc.param_count(), jc.active_param_count()), name
        for shape in J_SHAPES.values():
            assert roofline.model_flops(tc, shape) == j_roofline.model_flops(jc, shape)


# ---- what the compute and wire halves offer ------------------------------------------


def test_no_tile_a_route_ignores_and_no_wire_a_backend_refuses(monkeypatch):
    """Fused: the bf16 wgmma route, the CPU's plain replay, flash attention
    and the grouped GEMM take the default tile only; the float32 FMA route
    offers one tile per distinct ``fma_n_tile``; no quantized wire, ``gemm_rs``
    its float wires; a bf16 ``gemm_rs`` C with N / C odd is dropped.  Eager:
    every tile blocks differently and none is the whole problem.  An
    ``ag_matmul`` on bf16 operands has one accum dtype."""
    fake = HopperInfo(name="NVIDIA H100 80GB HBM3", sm_count=132, smem_per_block_optin=232448, capability=(9, 0))
    monkeypatch.setattr(t_cand, "_hopper", lambda device: fake)
    space = dataclasses.replace(tune.QUANT_SPACE, flows=(None, "int8", "float8_e4m3fn", "bfloat16"))
    big = {"ag_matmul": (1, 512, 1024, 1536), "matmul_rs": (2, 2048, 512, 1536)}
    for kind, sig in big.items():
        for device, dtype in (("cpu", torch.float32), ("cpu", torch.bfloat16), ("cuda", torch.bfloat16)):
            target = tune.Target("fused", torch.device(device), dtype)
            cands = tune.enumerate_candidates(kind, extent=tune.chunk_extent(kind, sig), space=space, sig=sig,
                                              world=R, target=target)  # fmt: skip
            assert {c.comp_tile for c in cands} == {DEFAULT_TILE}, (kind, device, dtype)
            wires = {c.flow for c in cands}
            assert wires == ({None, "bfloat16"} if kind == "matmul_rs" else {None}), (kind, wires)
            if kind == "ag_matmul" and dtype == torch.bfloat16:
                assert {c.accum_dtype for c in cands} == {"float32"}
        fma = tune.Target("fused", torch.device("cuda"), torch.float32)
        cands = tune.enumerate_candidates(kind, extent=tune.chunk_extent(kind, sig), space=space, sig=sig, world=R,
                                          target=fma)  # fmt: skip
        for c0 in {(c.order, c.num_channels, c.accum_dtype, c.flow) for c in cands}:
            tiles = [c.comp_tile for c in cands if (c.order, c.num_channels, c.accum_dtype, c.flow) == c0]
            n = sig[3] if kind == "ag_matmul" else sig[3] // c0[1]
            launched = [fma_n_tile(n, t[1], c0[1] * R, 132) for t in tiles]
            assert tiles[0] == DEFAULT_TILE and len(tiles) > 1 and len(set(launched)) == len(tiles), (kind, c0, tiles)
            assert all(t[0] == t[2] == 128 for t in tiles)
    odd = tune.enumerate_candidates("matmul_rs", extent=6, sig=(1, 64, 32, 6), world=R,
                                    target=tune.Target("fused", torch.device("cpu"), torch.bfloat16))  # fmt: skip
    assert {c.num_channels for c in odd} == {1, 3}  # C = 2 leaves 3 columns; C = 4 clamps to 3, which leaves 2
    for kind in ("ag_attention", "ag_moe"):
        sig = SIGS[kind][0]
        for device in ("cpu", "cuda"):
            target = tune.Target("fused", torch.device(device), torch.bfloat16)
            cands = tune.enumerate_candidates(kind, extent=tune.chunk_extent(kind, sig), space=space, sig=sig,
                                              world=R, target=target)  # fmt: skip
            assert {(c.comp_tile, c.flow) for c in cands} == {(DEFAULT_TILE, None)}
    for kind, sig in {**big, "ag_attention": (1, 2, 2, 512, 64)}.items():
        for device in ("cpu", "cuda"):
            target = tune.Target("eager", torch.device(device), torch.float32)
            for nch in (1, 2):
                tiles = tune.comp_tile_candidates(kind, sig, world=R, nch=nch, space=tune.JOINT_SPACE, target=target)
                m, n, k = t_cand._tile_dims(kind, sig, R, nch)
                blocked = [t if kind != "ag_attention" else (t[0], n, t[2]) for t in tiles[1:]]
                assert tiles[0] == DEFAULT_TILE and len(tiles) > 2, (kind, device, nch)
                assert len(set(blocked)) == len(blocked) and (m, n, k) not in blocked and DEFAULT_TILE not in blocked
                assert all(resolve_tile(t, m, n, k) == t for t in blocked)
                if device == "cuda":
                    assert all(t_cand._footprint(t, 4) <= fake.smem_per_block_optin for t in blocked)
    wide = tune.comp_tile_candidates("ag_matmul", big["ag_matmul"], world=R, space=tune.JOINT_SPACE, target=CPU_EAGER)
    narrow = tune.comp_tile_candidates("ag_matmul", big["ag_matmul"], world=R, space=tune.JOINT_SPACE,
                                       target=tune.Target("eager", torch.device("cuda")))  # fmt: skip
    assert set(narrow) < set(wide)  # the shared-memory prune on the card


# small cases whose JOINT lattice has real tiles (extents of 128 and more)
EAGER_CASES = {
    "ag_matmul": (1, 128, 256, 128),
    "matmul_rs": (1, 256, 256, 128),
    "ag_attention": (1, 1, 1, 128, 8),
    "ag_moe": (128, 64, 1, 1, 64),
}


@pytest.mark.parametrize("kind", tune.TUNABLE_KINDS)
def test_every_eager_candidate_runs(world, kind):
    """Every candidate the port enumerates for the eager backend under
    QUANT_SPACE compiles and runs: the identity f32 ones equal the default
    channel's output to summation order, the others are finite and near it."""
    sig = EAGER_CASES[kind]
    cands = tune.enumerate_candidates(kind, extent=tune.chunk_extent(kind, sig), space=tune.QUANT_SPACE, sig=sig,
                                      world=R, target=CPU_EAGER)  # fmt: skip
    assert any(c.comp_tile != DEFAULT_TILE for c in cands) and (kind == "ag_moe" or any(c.flow for c in cands))
    case = t_measure.CaseTimer(kind, world, sig)
    ref = case.run(BlockChannel(axis="model")).float()
    scale = ref.abs().max().item()
    for cand in cands:
        got = case.run(cand.channel("model")).float()
        assert got.shape == ref.shape and torch.isfinite(got).all(), cand.label()
        exact = cand.accum_dtype == "float32" and cand.flow is None
        tol = 1e-5 * scale if exact else 0.1 * scale
        assert (got - ref).abs().max().item() <= tol, (cand.label(), (got - ref).abs().max().item(), tol)


# ---- the tuner: cache, rankers, capture ---------------------------------------------------


def test_cache_round_trip_and_retune(world, tune_cache):
    """A model-ranked record persists and hits after the memo is dropped; an
    old schema, a corrupt file, a foreign fingerprint inside the file and a
    new fingerprint (backend, world) all re-tune without raising; an
    explicit ``ranker="measure"`` upgrades a model record in place."""
    sig, kw = (1, 32, 16, 24), dict(world=world, space=tune.JOINT_SPACE)
    first = tune.autotune("ag_matmul", signature=sig, **kw)
    assert not first.cache_hit and first.ranker == "model" and first.considered > 0
    t_cache.clear_memo()
    hit = tune.autotune("ag_matmul", signature=sig, **kw)
    assert hit.cache_hit and hit.candidate == first.candidate and hit.considered == 0
    path = tune_cache / f"{t_cache.fingerprint_digest(first.fingerprint)}.json"
    data = json.loads(path.read_text())
    (key,) = data["entries"]
    assert data["fingerprint"] == {"world": R, "axis": "model", "backend": "eager", "gpu": "cpu", "sm_count": 0,
                                   "torch": torch.__version__, "cuda": torch.version.cuda}  # fmt: skip
    for damage in ("old", "corrupt", "foreign"):
        if damage == "old":
            data["entries"][key]["schema"] = 3
            path.write_text(json.dumps(data))
        elif damage == "corrupt":
            path.write_text("{not json")
        else:
            path.write_text(json.dumps(dict(data, fingerprint=dict(data["fingerprint"], gpu="another"))))
        t_cache.clear_memo()
        again = tune.autotune("ag_matmul", signature=sig, **kw)
        assert not again.cache_hit and again.candidate == first.candidate, damage
        data = json.loads(path.read_text())
    other = tune.autotune("ag_matmul", signature=sig, world=world, backend="fused", space=tune.JOINT_SPACE)
    assert not other.cache_hit and other.fingerprint != first.fingerprint
    assert not tune.autotune("ag_matmul", signature=sig, world=World(2, "cpu")).cache_hit
    measured = tune.autotune("ag_matmul", signature=sig, ranker="measure", repeats=1, warmup=1, **kw)
    assert measured.ranker == "measure" and not measured.cache_hit and measured.sweep["total"] == first.considered
    assert tune.autotune("ag_matmul", signature=sig, ranker="measure", **kw).cache_hit  # measured records stay


def test_capture_resolves_without_launching(world, monkeypatch):
    """Inside a CUDA graph capture nothing is timed: an explicit measure
    request warns and ranks with the model, a cache hit builds no case."""
    monkeypatch.setattr(tune, "capturing", lambda: True)
    built = []
    monkeypatch.setattr(t_measure, "CaseTimer", lambda *a, **k: built.append(a))
    with pytest.warns(UserWarning, match="captured"):
        res = tune.autotune("matmul_rs", signature=(1, 32, 8, 16), world=world, ranker="measure")
    assert res.ranker == "model" and not built
    again = tune.autotune("matmul_rs", signature=(1, 32, 8, 16), world=world, ranker="measure")
    assert again.cache_hit and not built
    with pytest.raises(ValueError, match="warmup"):
        t_measure.time_fn(lambda: None, warmup=0)


# ---- compile_overlap("auto") against the pinned call and the reference -----------------


def _jax_op(mesh, kind, ch, x, w):
    lead = (None,) * (x.ndim - 2)
    if kind == "ag_matmul":
        specs = (P(*lead, "model", None), P(None, "model")), P(*lead, None, "model")
    else:
        specs = (P(*lead, None, "model"), P("model", None)), P(*lead, "model", None)
    sm = shard_map(j_compile(kind, ch), mesh, in_specs=specs[0], out_specs=specs[1])
    return np.asarray(j_jit(sm)(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("kind", ["ag_matmul", "matmul_rs"])
@pytest.mark.parametrize("mode", ["channel", "joint", "quant"])
def test_auto_equals_pinned_and_reference(mesh4, world, kind, mode):
    """``compile_overlap(kind, "auto", ...)`` (comm half; with comp="auto";
    with quant="auto" on an explicit channel) equals the call pinned to the
    resolved channel bitwise, and the reference's ``compile_overlap`` with
    that channel within 1e-5 of max."""
    rng = np.random.default_rng(7)
    if kind == "ag_matmul":
        x, w = rng.standard_normal((2, R * 64, 256)).astype(np.float32), rng.standard_normal((256, R * 64)).astype(np.float32)
        xs, ws = world.shard(torch.from_numpy(x), 1), shard_cols(torch.from_numpy(w), world)
    else:
        x, w = rng.standard_normal((2, R * 64, R * 32)).astype(np.float32), rng.standard_normal((R * 32, 256)).astype(np.float32)
        xs, ws = world.shard(torch.from_numpy(x), 2), shard_rows(torch.from_numpy(w), world)
    if mode == "channel":
        fn, space = compile_overlap(kind, "auto", world=world, tune_ranker="model"), tune.DEFAULT_SPACE
    elif mode == "joint":
        fn, space = compile_overlap(kind, "auto", world=world, comp="auto", tune_ranker="model"), tune.JOINT_SPACE
    else:
        base = BlockChannel(axis="model", num_channels=2)
        fn = compile_overlap(kind, base, world=world, quant="auto", tune_ranker="model")
        space = t_compiler._pinned_space(base, flows=(None, "int8"))
    got = fn(xs, ws)
    base = base if mode == "quant" else None
    ch = tune.resolve_channel(kind, shapes=[tuple(xs.shape[1:]), tuple(ws.shape[1:])], world=world, base=base,
                              space=space)  # fmt: skip
    assert torch.equal(got, compile_overlap(kind, ch, world=world)(xs, ws))
    want = _jax_op(mesh4, kind, _jchan(ch), x, w)
    full = world.unshard(got, 2 if kind == "ag_matmul" else 1).numpy()
    np.testing.assert_allclose(full, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_seq_auto_equals_pinned_and_reference(mesh4, world):
    """The seam's ``"auto"`` (and ``quant=True`` on explicit channels) runs
    the resolved verdict: equal to the pinned pair bitwise, and to the
    reference's list form with those channels within 1e-5 of max."""
    from repro_torch.tune import resolve_seq

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, R * 16, R * 8)).astype(np.float32)
    w1, w2 = rng.standard_normal((R * 8, 32)).astype(np.float32), rng.standard_normal((32, R * 8)).astype(np.float32)
    res = rng.standard_normal((2, R * 16, 32)).astype(np.float32)
    xs, w1s, w2s, rs = world.shard(torch.from_numpy(x), 2), world.shard(torch.from_numpy(w1), 0), world.shard(
        torch.from_numpy(w2), 1), world.shard(torch.from_numpy(res), 1)  # fmt: skip
    glue = torch.tanh
    seam = ["matmul_rs", "ag_matmul"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # an unfused verdict warns nothing
        y, g = compile_overlap(seam, "auto", world=world)(xs, w1s, w2s, residual=rs, glue=glue)
        ch = BlockChannel(axis="model", num_channels=2)
        yq, gq = compile_overlap(seam, ch, world=world, quant=True)(xs, w1s, w2s, residual=rs, glue=glue)
    shapes = [tuple(t.shape[1:]) for t in (xs, w1s, w2s)]
    fused, ch_rs, ch_ag = resolve_seq(shapes=shapes, world=world)
    pinned = compile_overlap([("matmul_rs", ch_rs), ("ag_matmul", ch_ag)], world=world)
    y2, g2 = pinned(xs, w1s, w2s, residual=rs, glue=glue)
    assert torch.equal(y, y2) and torch.equal(g, g2)
    fq, q_rs, q_ag = resolve_seq(shapes=shapes, world=world, base=ch, space=t_compiler._pinned_space(ch, flows=(None, "int8")))
    yq2, gq2 = compile_overlap([("matmul_rs", q_rs), ("ag_matmul", q_ag)], world=world)(xs, w1s, w2s, residual=rs, glue=glue)
    assert torch.equal(yq, yq2) and torch.equal(gq, gq2)
    fn = j_compile([("matmul_rs", _jchan(ch_rs)), ("ag_matmul", _jchan(ch_ag))])
    sm = shard_map(lambda a, b, c, r: fn(a, b, c, residual=r, glue=jnp.tanh), mesh4,
                   in_specs=(P(None, None, "model"), P("model", None), P(None, "model"), P(None, "model", None)),
                   out_specs=(P(None, "model", None), P(None, None, "model")))  # fmt: skip
    jy, jg = j_jit(sm)(x, w1, w2, res)
    for got, want, dim in ((y, jy, 1), (g, jg, 2)):
        want = np.asarray(want)
        np.testing.assert_allclose(world.unshard(got, dim).numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_a2a_auto_equals_pinned_and_reference(mesh4, world):
    """The a2a pair's ``"auto"`` runs ``resolve_a2a``'s verdict: equal to the
    pinned pair bitwise (``quant=True`` changes nothing: the MoE kinds have
    no wire axis) and to the reference's pair with that channel within 1e-5."""
    from repro_torch.core import moe_overlap
    from repro_torch.tune import resolve_a2a

    rng = np.random.default_rng(4)
    m, d, f, e, k = 16, 16, 8, 2 * R, 2
    x = rng.standard_normal((R * m, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    w_gu = (rng.standard_normal((e, d, 2 * f)) * 0.3).astype(np.float32)
    w_down = (rng.standard_normal((e, f, d)) * 0.3).astype(np.float32)
    xs = world.shard(torch.from_numpy(x), 0)
    ids, wts, _ = moe_overlap.moe_router(xs, torch.from_numpy(router), num_experts=e, top_k=k)
    gus, downs = world.shard(torch.from_numpy(w_gu), 0), world.shard(torch.from_numpy(w_down), 0)
    a2a = ["a2a_dispatch", "combine_rs"]
    got = compile_overlap(a2a, "auto", world=world)(xs, ids, wts, gus, downs, capacity_factor=2.0)
    quant = compile_overlap(a2a, "auto", world=world, quant=True)(xs, ids, wts, gus, downs, capacity_factor=2.0)
    fused, ch_d, ch_c = resolve_a2a(shapes=[tuple(t.shape[1:]) for t in (xs, ids, wts, gus, downs)], world=world,
                                    capacity_factor=2.0)  # fmt: skip
    assert fused
    pinned = compile_overlap([("a2a_dispatch", ch_d), ("combine_rs", ch_c)], world=world)
    assert torch.equal(got, pinned(xs, ids, wts, gus, downs, capacity_factor=2.0)) and torch.equal(got, quant)
    jfn = j_compile([("a2a_dispatch", _jchan(ch_d)), ("combine_rs", _jchan(ch_c))])

    def jbody(xl, idl, wl, gl, dl):
        return jfn(xl, idl, wl, gl, dl, capacity_factor=2.0)

    spec = P("model", None)
    sm = shard_map(jbody, mesh4, in_specs=(spec, spec, spec, P("model", None, None), P("model", None, None)),
                   out_specs=spec)  # fmt: skip
    want = np.asarray(j_jit(sm)(x, world.unshard(ids, 0).numpy().astype(np.int32), world.unshard(wts, 0).numpy(),
                                w_gu, w_down))  # fmt: skip
    np.testing.assert_allclose(world.unshard(got, 0).numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


# ---- ParallelContext(tune=True), the nn keywords, the engine ------------------------------


def test_context_tune_smollm_prefill_matches_reference(pc8, mesh8, monkeypatch):
    """A reduced smollm-360m prefill under ``ParallelContext(tune=True)``
    (eager and fused backends, every op resolved per shape) holds the
    reference's logits to 2e-3; the tuner was asked for each GEMM shape."""
    jcfg = dataclasses.replace(j_reduce_config(j_get_config("smollm-360m")), vocab_size=256)
    cfg = dataclasses.replace(reduce_config(get_config("smollm-360m")), vocab_size=256)
    jparams = place(jlm.init(jax.random.PRNGKey(3), jcfg, pc8, jnp.float32), mesh8, jlm.specs(jcfg, pc8))
    world = World(R, "cpu")
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, world)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    jl, _ = j_jit(lambda p, t: jlm.prefill(p, jcfg, pc8, t, max_len=16))(jparams, jnp.asarray(toks))
    asked = []
    resolve = tune.resolve_channel
    monkeypatch.setattr(tune, "resolve_channel", lambda kind, **kw: asked.append((kind, kw["backend"])) or resolve(kind, **kw))
    for backend in ("eager", "fused"):
        pc = ParallelContext(world=world, backend=backend, tune=True)
        tl, _ = lm.prefill(params, cfg, pc, torch.from_numpy(toks).long(), max_len=16)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3, rtol=2e-3)
        assert {k for k, b in asked if b == backend} == {"ag_matmul", "matmul_rs"}


def test_nn_tune_keywords(world, monkeypatch):
    """``ffn.apply_seq(tune=True)`` on an untuned context resolves its two
    GEMMs and gives the tuned context's output."""
    cfg = reduce_config(get_config("smollm-360m"))
    gen = torch.Generator().manual_seed(0)
    d, f = cfg.d_model, cfg.d_ff // R
    params = {"ln": torch.ones(d), "w_gu": torch.randn(R, d, 2 * f, generator=gen) * d**-0.5,
              "w_down": torch.randn(R, f, d, generator=gen) * f**-0.5}  # fmt: skip
    x = torch.randn(R, 2, 8, d, generator=gen)
    asked = []
    resolve = tune.resolve_channel
    monkeypatch.setattr(tune, "resolve_channel", lambda kind, **kw: asked.append(kind) or resolve(kind, **kw))
    pc = ParallelContext(world=world)
    got = ffn.apply_seq(params, x, pc, cfg, tune=True)
    assert asked == ["ag_matmul", "matmul_rs"] and not pc.tune
    assert torch.equal(got, ffn.apply_seq(params, x, dataclasses.replace(pc, tune=True), cfg))


def test_engine_resolves_decode_channels_in_init(monkeypatch):
    """``ServeEngine`` with ``pc.tune`` resolves the decode-shape winners of
    its four TP GEMMs in ``__init__`` (before the card's capture would
    run), keyed by decode signatures; its tokens are the untuned engine's."""
    cfg = dataclasses.replace(reduce_config(get_config("smollm-360m")), vocab_size=128)
    world = World(R, "cpu")
    params = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    asked = []
    resolve = tune.resolve_channel
    monkeypatch.setattr(tune, "resolve_channel", lambda kind, **kw: asked.append((kind, kw["sig"])) or resolve(kind, **kw))
    kw = dict(max_len=32, n_slots=4, prefill_chunk=4, decode_block=4)
    eng = ServeEngine(cfg, ParallelContext(world=world, tune=True), params, **kw)
    assert set(eng.decode_channels) == {"qkv", "attn_out", "ffn_gu", "ffn_down"} and len(asked) == 4
    assert all(sig[0] == -4 for _, sig in asked) and eng.stats["steps"] == 0
    assert all(isinstance(ch, BlockChannel) for ch in eng.decode_channels.values())
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(3, 6))
    plain = ServeEngine(cfg, ParallelContext(world=world), params, **kw)
    np.testing.assert_array_equal(eng.generate(prompts, 5), plain.generate(prompts, 5))
