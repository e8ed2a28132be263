"""The port's plan layer against the JAX package's.

Every port plan's schedule tables equal the JAX ``build_plan`` tables, and
every port plan passes the JAX package's static verifier (schedule legality
and the semaphore-protocol model check) through the duck-typed
``PlanTables.from_plan``.  The test imports ``repro.analysis``; the port
does not.
"""

import itertools
import warnings

import pytest
import torch

from repro.analysis import PlanTables, verify_tables
from repro.core import plan as jplan
from repro.core.channels import BlockChannel as JChannel
from repro.core.channels import CommSpec as JComm
from repro.core.mapping import effective_channels as j_effective_channels
from repro.core.comp_tiles import largest_divisor as j_largest_divisor
from repro_torch.core import channels as tch
from repro_torch.core import plan as tplan
from repro_torch.core.comp_tiles import largest_divisor, resolve_tile
from repro_torch.core.mapping import effective_channels

KINDS = ("ag_matmul", "matmul_rs")
ORDERS = ("ring", "bidir_ring", "all2all")
WORLDS = (2, 3, 4, 8)
CHANNELS = (1, 2, 4)
GRID = list(itertools.product(KINDS, ORDERS, WORLDS, CHANNELS))
TABLES = ("src_tables", "flow_dst_tables", "rs_seg_tables", "rs_dst_tables")


def _plans(kind, order, world, nch):
    jp = jplan.build_plan(kind, JChannel(axis="model", comm=JComm(order=order)), world, nch)
    tp = tplan.build_plan(kind, tch.BlockChannel(axis="model", comm=tch.CommSpec(order=order)), world, nch)
    return jp, tp


@pytest.mark.parametrize("kind,order,world,nch", GRID)
def test_tables_equal_reference(kind, order, world, nch):
    jp, tp = _plans(kind, order, world, nch)
    for name in TABLES:
        assert getattr(tp, name)() == getattr(jp, name)(), name
    assert tp.flow == jp.flow and tp.steps == jp.steps and tp.num_channels == jp.num_channels
    assert [c.direction for c in tp.channels] == [c.direction for c in jp.channels]
    for s in range(world - 1):
        for cj, ct in zip(jp.channels, tp.channels):
            assert ct.flow_perm(s) == cj.flow_perm(s)
            assert ct.rs_perm(s) == cj.rs_perm(s)


@pytest.mark.parametrize("kind,order,world,nch", GRID)
def test_port_plan_passes_reference_verifier(kind, order, world, nch):
    _, tp = _plans(kind, order, world, nch)
    tables = PlanTables.from_plan(tp)
    assert tables.wire_dtype == "float32" and tables.scale_slots == 0
    report = verify_tables(tables, protocol=True)
    assert report.checks > 0 and "protocol" in report.passes


def test_verifier_rejects_a_poked_port_table():
    _, tp = _plans("matmul_rs", "ring", 4, 2)
    tables = PlanTables.from_plan(tp)
    tables = tables.poke("rs_seg", 0, 1, 2, (tables.rs_seg[0][1][2] + 1) % 4)
    with pytest.raises(ValueError) as err:
        verify_tables(tables, protocol=True)
    assert err.value.check in {"rs_time_reversal", "rs_home", "per_step_permutation", "rs_composition"}


def test_plan_cache_and_accum_dtype():
    ch = tch.BlockChannel(axis="model", comp=tch.CompSpec(accum_dtype="bfloat16"))
    a = tplan.build_plan("ag_matmul", ch, 4, 2)
    b = tplan.build_plan("ag_matmul", ch, 4, 2)
    assert a is b and tplan.plan_cache_info().hits >= 1
    assert a.accum_dtype is torch.bfloat16 and a.flow_dtype == "bfloat16"
    with pytest.raises(ValueError):
        tplan.build_plan("ag_moe", ch, 4, 1)


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.CommSpec(order="spiral"),
        lambda m: m.CommSpec(resource="nic"),
        lambda m: m.CommSpec(mode="poll"),
        lambda m: m.CommSpec(tile=0),
        lambda m: m.CompSpec(tile=(128, 0, 128)),
        lambda m: m.CompSpec(tile=(128, 128)),
        lambda m: m.BlockChannel(axis=""),
        lambda m: m.BlockChannel(axis="model", num_channels=0),
    ],
)
def test_channel_validation_matches_reference(make):
    """The port's specs refuse what the JAX package's specs refuse."""
    from repro.core import channels as jch

    with pytest.raises(ValueError):
        make(jch)
    with pytest.raises(ValueError):
        make(tch)


def test_accum_dtype_and_quant():
    assert tch.CompSpec(accum_dtype="float32").accum_dtype is torch.float32
    assert tch.CompSpec(accum_dtype=torch.bfloat16).accum_dtype is torch.bfloat16
    with pytest.raises(ValueError):
        tch.CompSpec(accum_dtype=torch.int32)
    with pytest.raises(ValueError):
        tch.CompSpec(accum_dtype="int8")
    with pytest.raises(NotImplementedError):
        tch.QuantSpec(wire_dtype="int8")
    with pytest.raises(NotImplementedError):
        tch.QuantSpec(weight_dtype="int4")
    with pytest.raises(TypeError):
        tch.BlockChannel(axis="model", comm="ring")


@pytest.mark.parametrize("extent,cap", [(960, 128), (1280, 128), (640, 128), (97, 8), (1, 4), (64, 1), (12, 5)])
def test_divisor_rules_match_reference(extent, cap):
    assert largest_divisor(extent, cap) == j_largest_divisor(extent, cap)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert effective_channels(extent, cap, kind="t") == j_effective_channels(extent, cap, kind="t")
    assert resolve_tile((128, 128, 128), extent, 960, 640) == (
        j_largest_divisor(extent, 128), 120, 128)  # fmt: skip


def test_effective_channels_warns_once():
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert effective_channels(6, 4, kind="probe-warn-once") == 3
        assert effective_channels(6, 4, kind="probe-warn-once") == 3
    assert len([w for w in rec if "largest divisor 3" in str(w.message)]) == 1
