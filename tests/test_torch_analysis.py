"""The port's static verifier (``repro_torch.analysis``) against the JAX package's.

* the schedule pass gives the JAX package's verdict and ``checks`` count on
  every (kind, order, world, C) plan, every seam and a2a pair and a
  quantized plan, and each of the JAX package's table mutations
  (``tests/test_analysis.py``) raises the same check at the same
  coordinates in both;
* the flag-protocol pass names each seeded mutation of the fused kernels'
  work items (a set dropped, a wait moved to a later setter, a slot tile
  written twice, a read before its write) at G in {1, 3, 7, 132} on
  smollm-360m's serve shapes, and ``verify_launch`` accepts the real launches;
* ``build_plan`` / ``build_seq_plan`` verify every miss (``REPRO_VERIFY=0``
  skips), a poked table is refused with its coordinates, the table
  derivations raise the structured error;
* the CLI proves as many plans as the JAX package's; the tuner's candidate
  lists are the ones the plan-building probe gave; the lint finds the
  port's tree clean and flags a probe of each rule.
"""

import dataclasses
import itertools

import pytest
import torch

from repro.analysis import ir as jir
from repro.analysis import schedule as jschedule
from repro.analysis import verify as jverify
from repro.core import plan as jplan
from repro.core.channels import BlockChannel as JChannel
from repro.core.channels import CommSpec as JComm
from repro.core.quant import QuantSpec as JQuant
from repro_torch import analysis
from repro_torch.analysis import lint, protocol, schedule, verify
from repro_torch.analysis.errors import PlanVerificationError
from repro_torch.analysis.ir import PlanTables
from repro_torch.core import plan as tplan
from repro_torch.core.channels import BlockChannel, CommSpec, QuantSpec
from repro_torch.kernels.ag_gemm import work_items as ag_work_items
from repro_torch.kernels.gemm_rs import work_items as rs_work_items
from repro_torch.tune import candidates
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

KINDS = sorted(tplan.FLOW_OF_KIND)
ORDERS = ("ring", "bidir_ring", "all2all")
WORLDS = (2, 3, 4, 8)
CHANNELS = (1, 2, 4)
GRIDS = (1, 3, 7, 132)
R = 4
# smollm-360m's serve shapes at W = 4, 4 x 256 tokens: AG (B, m_loc, K, n_loc) qkv, RS (B, M, k_loc, N) o-proj
AG_SERVE = (4, 64, 960, 480)
RS_SERVE = (4, 256, 240, 960)


def _tch(order, nch, quant=None):
    return BlockChannel(axis="model", comm=CommSpec(order=order), num_channels=nch, quant=quant or QuantSpec())


def _jch(order, nch, quant=None):
    return JChannel(axis="model", comm=JComm(order=order), num_channels=nch, quant=quant or JQuant())


def _pair(kind, order, world, nch, tq=None, jq=None):
    """(JAX tables, port tables) of one plan point, built without the
    verifiers (the passes under test run on the snapshots)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_VERIFY", "0")
        jp = jplan.build_plan(kind, _jch(order, nch, jq), world, nch)
        tp = tplan.build_plan(kind, _tch(order, nch, tq), world, nch)
    return jir.PlanTables.from_plan(jp), PlanTables.from_plan(tp)


def _where(e):
    return (e.check, e.kind, e.order, e.world, e.channel, e.step, e.rank)


# ---- the schedule pass agrees with the JAX package's -----------------------


@pytest.mark.parametrize("kind,order,world", list(itertools.product(KINDS, ORDERS, WORLDS)))
def test_schedule_pass_matches_reference(kind, order, world):
    for nch in CHANNELS:
        jt, tt = _pair(kind, order, world, nch)
        assert dataclasses.astuple(jt)[:11] == dataclasses.astuple(tt)[:11]
        assert schedule.check_schedule(tt) == jschedule.check_schedule(jt) > 0
        assert verify.check_quant(tt) == jverify.check_quant(jt)
        report = verify.verify_tables(tt)
        assert report.passes == (("schedule", "protocol") if kind in protocol.PROTOCOL_KINDS else ("schedule",))
        assert report.effective_channels == nch and report.checks > 0


@pytest.mark.parametrize("order,world", list(itertools.product(ORDERS, WORLDS)))
def test_seam_and_a2a_pairs_match_reference(order, world):
    for nch in CHANNELS:
        (jp, tp), (jc, tc) = _pair("matmul_rs", order, world, nch), _pair("ag_matmul", order, world, nch)
        assert schedule.check_seam(tp, tc) == jschedule.check_seam(jp, jc)
        (jd, td), (jk, tk) = _pair("a2a_dispatch", order, world, nch), _pair("combine_rs", order, world, nch)
        assert schedule.check_a2a_seam(td, tk) == jschedule.check_a2a_seam(jd, jk)
        seq = verify.verify_seq_tables([tp, tc])
        assert seq.passes == ("schedule", "seam", "protocol") and seq.events > 0
        assert verify.verify_seq_tables([td, tk]).passes == ("schedule", "seam")
        for bad in ((tc, tp), (tk, td)):  # the chain reversed is no seam in either package
            with pytest.raises(PlanVerificationError) as e:
                verify.verify_seq_tables(list(bad))
            assert e.value.check in ("seam_composition", "a2a_seam_composition")


@pytest.mark.parametrize(
    "wire,gran", [("int8", "per_tile"), ("float8_e4m3fn", "per_channel"), ("bfloat16", "per_tile")]
)
@pytest.mark.parametrize("kind", ["ag_matmul", "matmul_rs", "ag_moe"])
def test_quantized_plan_matches_reference(kind, wire, gran):
    jt, tt = _pair(kind, "ring", 4, 2, QuantSpec(wire_dtype=wire, granularity=gran), JQuant(wire_dtype=wire,
                                                                                           granularity=gran))
    assert (tt.wire_dtype, tt.granularity, tt.scale_slots) == (jt.wire_dtype, jt.granularity, jt.scale_slots)
    assert verify.check_quant(tt) == jverify.check_quant(jt) == 3
    for field, value in (("scale_slots", tt.scale_slots + 1), ("granularity", "per_row")):
        with pytest.raises(PlanVerificationError) as te:
            verify.check_quant(dataclasses.replace(tt, **{field: value}))
        with pytest.raises(ValueError) as je:
            jverify.check_quant(dataclasses.replace(jt, **{field: value}))
        assert _where(te.value) == _where(je.value)


# the JAX package's seeded table mutations (tests/test_analysis.py), applied alike to both snapshots
def _rotated(t):
    return dataclasses.replace(t, src=tuple(ch[1:] + ch[:1] for ch in t.src))


def _swapped_pair(t, channel=0, step=1):
    """Ranks 0 and 1 of one ``flow_dst`` row swapped (either package's tables)."""
    row = t.flow_dst[channel][step]
    return t.poke("flow_dst", channel, step, 0, row[1]).poke("flow_dst", channel, step, 1, row[0])


MUTATIONS = {
    "off_by_one_step": ("ag_matmul", _rotated),
    "swapped_perm_pair": ("ag_matmul", _swapped_pair),
    "nonpermutation_src_row": ("ag_matmul", lambda t: t.poke("src", 0, 1, 0, t.src[0][1][1])),
    "rs_segment_poked": ("matmul_rs", lambda t: t.poke("rs_seg", 0, 1, 0, (t.rs_seg[0][1][0] + 1) % t.world)),
    "align_poked": ("ag_moe", lambda t: t.poke_align(0, 0, (t.align[0][0] + 1) % t.world)),
}


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", list(MUTATIONS))
def test_table_mutation_flagged_as_reference(name, order):
    kind, mutate = MUTATIONS[name]
    jt, tt = _pair(kind, order, 4, 2)
    with pytest.raises(ValueError) as je:
        jverify.verify_tables(mutate(jt), protocol=False)
    with pytest.raises(PlanVerificationError) as te:
        verify.verify_tables(mutate(tt))
    assert _where(te.value) == _where(je.value)
    assert te.value.check in {"seed_identity", "per_step_permutation", "flow_composition", "rs_time_reversal",
                              "rs_home", "align_home"}  # fmt: skip


def test_channel_partition_matches_reference():
    assert schedule.check_channel_partition(8, 2) == jschedule.check_channel_partition(8, 2)
    with pytest.raises(PlanVerificationError) as e:
        schedule.check_channel_partition(6, 4)
    assert e.value.check == "channel_partition"


# ---- the flag protocol of the fused kernels ---------------------------------


def _items(kernel, order="ring", nch=2):
    if kernel == "ag_gemm":
        plan = tplan.build_plan("ag_matmul", _tch(order, nch), R, nch)
        return ag_work_items(plan, AG_SERVE)
    plan = tplan.build_plan("matmul_rs", _tch(order, nch), R, nch)
    return rs_work_items(plan, RS_SERVE)


def _drop_set(items):
    """A pushing item forgets to set its peer's flag."""
    i = next(it.index for it in items if it.sets and it.s == 1)
    return [it._replace(sets=()) if it.index == i else it for it in items]


def _later_wait(items):
    """An item waits on a flag that only a later-numbered item sets."""
    it = next(it for it in items if it.wait is not None and it.s == 1)
    late = next(x for x in items if x.sets and x.index > it.index)
    return [x._replace(wait=late.sets[0]) if x.index == it.index else x for x in items]


def _write_twice(items):
    """A second item also writes a slot tile another item writes."""
    first = next(it for it in items if it.writes and it.s == 1)
    j = next(it.index for it in items if it.index > first.index and not it.writes)
    return [it._replace(writes=first.writes[-1:]) if it.index == j else it for it in items]


def _read_early(items):
    """An early item reads a slot tile that a later item writes."""
    late = next(it for it in reversed(items) if it.writes)
    return [it._replace(reads=it.reads + late.writes[-1:]) if it.index == 0 else it for it in items]


PROTO_MUTATIONS = {
    "set_dropped": (_drop_set, {"flag_count", "deadlock"}),
    "wait_on_later_setter": (_later_wait, {"item_order"}),
    "slot_written_twice": (_write_twice, {"double_write"}),
    "read_before_write": (_read_early, {"read_before_flag"}),
}


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", list(PROTO_MUTATIONS))
@pytest.mark.parametrize("kernel", ["ag_gemm", "gemm_rs"])
def test_protocol_mutation_named(kernel, name, grid):
    items = _items(kernel)
    assert protocol.check_launch(items, grid)[0] > 0  # the unmutated launch passes
    mutate, names = PROTO_MUTATIONS[name]
    with pytest.raises(PlanVerificationError) as e:
        protocol.check_launch(mutate(items), grid, packed=kernel == "ag_gemm")
    assert e.value.check in names, e.value
    assert e.value.kind == ("ag_matmul" if kernel == "ag_gemm" else "matmul_rs")
    assert e.value.rank is not None and e.value.step is not None and e.value.channel is not None


def test_deadlock_reported_with_block_item_and_flag():
    """A wait on a later setter, past the static checks, hangs one block."""
    items = _items("ag_gemm", nch=1)
    ln = protocol.wgmma_launch(_later_wait(items), 1)
    with pytest.raises(PlanVerificationError) as e:
        protocol._simulate([ln], (None,), {})
    assert e.value.check == "deadlock" and "block 0" in str(e.value) and "waiting on flag ('ready'" in str(e.value)


@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2, 4))))
def test_protocol_pass_covers_both_routes(order, nch):
    for kind in ("ag_matmul", "matmul_rs"):
        _, tt = _pair(kind, order, R, nch)
        checks, events = protocol.check_protocol(tt)
        assert checks > 0 and events > 0
        fma = protocol.plan_launches(tt, 1, fma=True)
        assert not fma.persistent and fma.grid == 2 * tt.num_channels * R  # CANON_TILES[1] n-tiles x C x W
        assert all(len(b) == R for b in fma.blocks)  # every block walks the W stages
    # a flow_dst pair swapped breaks the float32 route's slot protocol too (past the schedule pass)
    _, tt = _pair("ag_matmul", order, R, nch)
    with pytest.raises(PlanVerificationError) as e:
        protocol.check_launches([protocol.plan_launches(_swapped_pair(tt, 0, 0), 1, fma=True)])
    assert e.value.check in ("read_before_flag", "double_write")


def test_seam_protocol_reads_the_home_segments():
    (_, tp), (_, tc) = _pair("matmul_rs", "ring", R, 2), _pair("ag_matmul", "ring", R, 2)
    assert protocol.check_seam_protocol(tp, tc)[1] > 0
    with pytest.raises(PlanVerificationError) as e:
        protocol.check_seam_protocol(tp.poke("rs_seg", 1, R - 1, 2, 0), tc)
    assert e.value.check == "read_before_flag" and e.value.rank == 2 and "home" in str(e.value)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("order", ORDERS)
def test_verify_launch_on_cpu_operands(order, dtype):
    ch = _tch(order, 2)
    x, w = torch.empty((R,) + AG_SERVE[:3], dtype=dtype), torch.empty((R, AG_SERVE[2], AG_SERVE[3]), dtype=dtype)
    xr, wr = torch.empty((R,) + RS_SERVE[:3], dtype=dtype), torch.empty((R, RS_SERVE[2], RS_SERVE[3]), dtype=dtype)
    grids = (1, 132) if dtype == torch.bfloat16 else (2 * R, 4 * 2 * R)
    for g in grids:
        for kind, a, b in (("ag_gemm", x, w), ("gemm_rs", xr, wr)):
            rep = analysis.verify_launch(kind, a, b, ch, g)
            assert rep.events > 0 and rep.passes[0].startswith("launch[")
    if dtype == torch.float32:
        with pytest.raises(PlanVerificationError) as e:
            analysis.verify_launch("ag_gemm", x, w, ch, 2 * R + 1)
        assert e.value.check == "grid"


# ---- build_plan, the tuner and the CLI -------------------------------------


def test_build_plan_verifies_every_miss(monkeypatch):
    before = tplan.verify_stats()
    ch = BlockChannel(axis="verify_miss", comm=CommSpec(order="bidir_ring"), num_channels=2)
    tplan.build_plan("ag_matmul", ch, 4, 2)
    tplan.build_plan("ag_matmul", ch, 4, 2)  # a hit: not verified again
    tplan.build_seq_plan(("matmul_rs", "ag_matmul"), (ch, ch), 4, 2)
    after = tplan.verify_stats()
    assert after["plan_misses"] - before["plan_misses"] == after["plans_verified"] - before["plans_verified"] == 2
    assert after["seq_misses"] - before["seq_misses"] == after["seqs_verified"] - before["seqs_verified"] == 1
    monkeypatch.setenv("REPRO_VERIFY", "0")
    tplan.build_plan("ag_matmul", ch, 8, 2)
    skipped = tplan.verify_stats()
    assert skipped["plan_misses"] == after["plan_misses"] + 1 and skipped["plans_verified"] == after["plans_verified"]


def test_poked_plan_refused_with_coordinates(monkeypatch):
    orig = tplan.TilePlan.flow_dst_tables

    def poked(self):  # one flow_dst pair swapped: channel 1, step 2, ranks 0 and 3
        rows = [[list(r) for r in ch] for ch in orig(self)]
        rows[1][2][0], rows[1][2][3] = rows[1][2][3], rows[1][2][0]
        return tuple(tuple(tuple(r) for r in ch) for ch in rows)

    monkeypatch.setattr(tplan.TilePlan, "flow_dst_tables", poked)
    ch = BlockChannel(axis="poked", comm=CommSpec(order="ring"), num_channels=2)
    before = tplan.verify_stats()
    with pytest.raises(PlanVerificationError) as e:
        tplan.build_plan("ag_matmul", ch, 4, 2)
    assert (e.value.check, e.value.kind, e.value.channel, e.value.step) == ("flow_composition", "ag_matmul", 1, 2)
    assert e.value.rank in (0, 3)
    after = tplan.verify_stats()
    assert after["plans_refused"] == before["plans_refused"] + 1 and after["plans_verified"] == before["plans_verified"]


def test_table_derivation_raises_structured(monkeypatch):
    from repro_torch.core import schedules

    monkeypatch.setitem(schedules.SCHEDULES, "ring", lambda r, s, w: 0 if s == 1 else (r - s) % w)
    plan = tplan.TilePlan(
        kind="matmul_rs", axis="model", world=4, flow="rs", num_channels=2, accum_dtype=torch.float32,
        channels=tuple(tplan.ChannelSchedule("ring", 4, -1) for _ in range(2)),
    )  # fmt: skip
    with pytest.raises(tplan.PlanError) as e:
        plan.flow_dst_tables()
    assert isinstance(e.value, ValueError) and tplan.PlanError is PlanVerificationError
    assert (e.value.check, e.value.kind, e.value.order, e.value.world, e.value.channel, e.value.step, e.value.rank) == (
        "per_step_permutation", "matmul_rs", "ring", 4, 0, 1, 2,
    )  # fmt: skip


def test_candidate_probes():
    assert analysis.check_candidate("ag_matmul", "all2all", 3, 2) is None
    assert analysis.check_seq_candidate("ring", 8, 4) is None
    assert analysis.check_a2a_candidate("bidir_ring", 3, 1) is None


def _old_legal(kinds, order, world, nch):
    """The tuner's legality test before the probes: the plan builds."""
    ch = BlockChannel(axis="model", comm=CommSpec(order=order), num_channels=nch)
    try:
        if len(kinds) == 1:
            tplan.build_plan(kinds[0], ch, world, nch)
        else:
            tplan.build_seq_plan(kinds, (ch, ch), world, nch)
    except tplan.PlanError:
        return False
    return True


def _enumerations():
    targets = (
        None, candidates.Target("fused", "cuda", torch.bfloat16), candidates.Target("eager", "cpu", torch.float32),
    )  # fmt: skip
    out = []
    for world, target in itertools.product((2, 3, 4, 8), targets):
        for kind in candidates.TUNABLE_KINDS:
            sig = (4, 48, 96, 48) if kind in candidates.GEMM_TILE_KINDS else None
            for space in (candidates.DEFAULT_SPACE, candidates.JOINT_SPACE):
                out.append(
                    candidates.enumerate_candidates(kind, extent=48, space=space, sig=sig, world=world, target=target)
                )
        out.append(candidates.enumerate_seq_candidates(sig=(2, 8 * world, 64, 48, 32), world=world, target=target))
        out.append(candidates.enumerate_a2a_candidates(sig=(48, 64, 2, 8, 32), world=world, target=target))
    return out


def test_tuner_candidates_unchanged(monkeypatch):
    now = _enumerations()
    monkeypatch.setattr(candidates, "_legal", _old_legal)
    assert now == _enumerations() and sum(map(len, now)) > 0


def test_cli_all_counts_the_reference_space(capsys):
    assert verify.main(["--all", "--quiet"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    # the JAX package's --all space: every kind x order x world x C and both pairs
    ref = sum(1 for _ in jverify.verify_space(protocol=False)) + sum(
        1 for k in jverify.SEQ_OPS.values() for _ in jverify.verify_seq_space(kinds=k, protocol=False)
    )
    assert out == f"verified: {ref} plan(s) ok, 0 failure(s)" and ref == 324


def test_cli_narrow_and_refusal(capsys):
    assert verify.main(["--kind", "seq_rs_ag", "--order", "ring", "--world", "4", "--channels", "2"]) == 0
    out = capsys.readouterr().out
    assert "passes=schedule+seam+protocol" in out and "verified: 1 plan(s) ok" in out
    with pytest.raises(SystemExit):
        verify.main([])


# ---- the lint ----------------------------------------------------------------


def test_lint_port_tree_clean():
    assert lint.lint_tree() == []
    assert lint.main([]) == 0


@pytest.mark.parametrize(
    "relpath,source,rule",
    [
        ("nn/ffn.py", "def f(world, x, pairs):\n    return world.permute(x, pairs)\n", "permute-site"),
        ("models/lm.py", "def f(ctx, x, p):\n    return ctx.world.permute(x, p)\n", "permute-site"),
        ("kernels/csrc/matmul.cu", "__device__ void f(int* p) { producer_tile_notify(p, 1); }\n", "flag-site"),
        ("kernels/csrc/ag_gemm.cu", 'asm volatile("ld.acquire.gpu.global.s32 %0, [%1];");\n', "flag-site"),
        ("kernels/csrc/gemm_rs.cu", "if (threadIdx.x == 0) tl_st_release(flag, 1);\n", "flag-site"),
        ("kernels/csrc/flash_attention.cu", 'asm volatile("ld.acquire.gpu.global.s32 %0, [%1];");\n', "flag-site"),
        ("core/compiler.py", "import ctypes\nlib = ctypes.CDLL('x.so')\n", "raw-library"),
        ("nn/attention.py", "from repro_torch.kernels import build\nlib = build.library()\n", "raw-library"),
    ],
)
def test_lint_flags_probe(relpath, source, rule):
    found = lint.lint_source(source, relpath)
    assert [v.rule for v in found] == [rule] and found[0].line >= 1


def test_lint_allows_the_owners():
    assert lint.lint_source("def f(world, x, p):\n    return world.permute(x, p)\n", "core/overlap.py") == []
    assert lint.lint_source("def f(world, x, p):\n    return world.permute(x, p)\n", "benchmarks/paper_mlp.py") == []
    assert lint.lint_source("y = x.permute(0, 2, 1)\n", "nn/mamba.py") == []  # a tensor's permute
    assert lint.lint_source("peer_tile_wait_synced(f, sync);\n", "kernels/csrc/gemm_rs.cu") == []
    assert lint.lint_source("while (tl_ld_acquire(f) == 0) {}\n", "kernels/csrc/tile_sync.cuh") == []
    assert lint.lint_source("lib = build.library()\n", "kernels/matmul.py") == []
