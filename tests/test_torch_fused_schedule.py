"""The bf16 fused kernels' persistent schedules, checked on the CPU.

``ag_gemm_wgmma_kernel`` / ``gemm_rs_wgmma_kernel`` run the work items of
``kernels/ag_gemm.work_items`` / ``kernels/gemm_rs.work_items`` on G
co-resident blocks, block b taking items b, b+G, ... in order and spinning
on flags other items set.  Here, for every tile order, C in {1, 2}, the
shapes of the three serve paths (W = 4 ranks, 4 requests x 256 tokens) and
the card tests' ragged ones:

  * the flag-protocol model of ``repro_torch.analysis.protocol``
    (``simulate``): G persistent blocks (G in {1, 3, 7, 132}), each walking
    its items in order and blocking on unset flags, never deadlock, in round
    robin and in a seeded random interleaving;
  * (``check_order``) every flag an item waits on is set by an item with a
    smaller number (the seed item of an AG m-tile fills the slot it reads
    itself); every gather / recv slot tile is written exactly once per
    pass, before any read; every flag is set exactly once;
  * the item index decodes to (s, r, c, mt, nt) as the kernels decode it;
  * the plain versions, which replay these items, equal the JAX package's
    oracles (``repro.kernels.ref.ag_gemm_ref`` / ``gemm_rs_ref``) in float32.
"""

import itertools

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.analysis.protocol import check_order, simulate
from repro_torch.core import BlockChannel, CommSpec
from repro_torch.core.mapping import effective_channels
from repro_torch.core.plan import build_plan
from repro_torch.kernels import ag_gemm, ag_gemm_plain, gemm_rs, gemm_rs_plain
from repro_torch.kernels.ag_gemm import work_items as ag_work_items
from repro_torch.kernels.gemm_rs import tiles as rs_tiles
from repro_torch.kernels.gemm_rs import work_items as rs_work_items
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

R = 4
ORDERS = ("ring", "bidir_ring", "all2all")
SWEEP = list(itertools.product(ORDERS, (1, 2)))
GRIDS = (1, 3, 7, 132)
F32 = dict(atol=1e-4, rtol=1e-4)

# (B, m_loc, K, n_loc): smollm qkv, smollm gate/up, granite qkv, mamba2
# in-projection (n_loc padded to 2584), then the card tests' bf16 shapes
AG_SHAPES = {
    "smollm_qkv": (4, 64, 960, 512),
    "smollm_gate_up": (4, 64, 960, 1280),
    "granite_qkv": (4, 64, 1536, 640),
    "mamba2_in": (4, 64, 2560, 2584),
    "card_ragged": (3, 10, 40, 72),
    "card_lead": (4, 24, 64, 136),
    "card_loop": (4, 64, 256, 1024),
}
# (B, M, k_loc, N): smollm o-proj, smollm down, granite o-proj, mamba2
# out-projection, then the card tests' bf16 shapes
RS_SHAPES = {
    "smollm_o": (4, 256, 256, 960),
    "smollm_down": (4, 256, 640, 960),
    "granite_o": (4, 256, 384, 1536),
    "mamba2_out": (4, 256, 1280, 2560),
    "card_ragged": (2, 12, 24, 56),
    "card_lead": (3, 20, 136, 200),
    "card_loop": (4, 256, 256, 1024),
}
# small shapes for the plain-vs-oracle checks: several m-tiles, n-tiles,
# row blocks (m_loc > 64) and channel leads
AG_SMALL = [((4, 3, 10, 40), (4, 40, 72)), ((4, 3, 96, 16), (4, 16, 136)), ((4, 2, 2, 24, 64), (4, 64, 136))]
RS_SMALL = [((4, 2, 12, 24), (4, 24, 56)), ((4, 3, 288, 16), (4, 16, 264)), ((4, 3, 20, 136), (4, 136, 200))]


def _channel(order, nch):
    return BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))


def _ag_items(order, nch, shape):
    ch = _channel(order, nch)
    plan = build_plan("ag_matmul", ch, R, effective_channels(shape[1], nch, kind="ag_matmul"))
    return plan, ag_work_items(plan, shape)


def _rs_items(order, nch, shape):
    ch = _channel(order, nch)
    plan = build_plan("matmul_rs", ch, R, effective_channels(shape[3], nch, kind="matmul_rs"))
    return plan, rs_work_items(plan, shape)


def _decode(i, world, nch, mt, nt):
    """The kernels' decode of an item index (``wg_item``: mt fastest, s
    slowest) as (s, r, c, mt, nt)."""
    return i // (nt * mt * nch * world), i // (nt * mt * nch) % world, i // (nt * mt) % nch, i % mt, i // mt % nt


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("shape", list(AG_SHAPES), ids=str)
@pytest.mark.parametrize("order,nch", SWEEP)
def test_ag_gemm_schedule_never_deadlocks(order, nch, shape, grid):
    _, items = _ag_items(order, nch, AG_SHAPES[shape])
    for seed in (None, 7):
        ran = simulate(items, grid, seed)
        assert sorted(ran) == list(range(len(items)))


@pytest.mark.parametrize("shape", list(AG_SHAPES), ids=str)
@pytest.mark.parametrize("order,nch", SWEEP)
def test_ag_gemm_schedule_flags_and_slots(order, nch, shape):
    b, m_loc, _, n_loc = AG_SHAPES[shape]
    plan, items = _ag_items(order, nch, AG_SHAPES[shape])
    c_eff = plan.num_channels
    m_tiles, n_tiles = -(-b * (m_loc // c_eff) // 128), -(-n_loc // 128)
    assert len(items) == R * R * c_eff * m_tiles * n_tiles
    setter, writer = check_order(items)
    for pos, it in enumerate(items):
        assert it.index == pos
        assert _decode(it.index, R, c_eff, m_tiles, n_tiles) == (it.s, it.r, it.c, it.mt, it.nt)
        assert it.reads == ((it.r, it.origin, it.c, it.mt),)
        assert (it.copy is not None) == (it.nt == 0 and (it.s == 0 or it.s < R - 1))
        if it.copy == "seed":  # the seed item fills the slot it reads and waits on nothing
            assert it.wait is None and it.origin == it.r and it.reads[0] in it.writes
    # every rank's gather slot (origin, channel, m-tile) is written exactly once
    assert set(writer) == set(itertools.product(range(R), range(R), range(c_eff), range(m_tiles)))
    assert len(setter) == R * R * c_eff * m_tiles  # one ready flag per (rank, step, channel, m-tile)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("shape", list(RS_SHAPES), ids=str)
@pytest.mark.parametrize("order,nch", SWEEP)
def test_gemm_rs_schedule_never_deadlocks(order, nch, shape, grid):
    _, items = _rs_items(order, nch, RS_SHAPES[shape])
    for seed in (None, 7):
        ran = simulate(items, grid, seed)
        assert sorted(ran) == list(range(len(items)))


@pytest.mark.parametrize("shape", list(RS_SHAPES), ids=str)
@pytest.mark.parametrize("order,nch", SWEEP)
def test_gemm_rs_schedule_flags_and_slots(order, nch, shape):
    plan, items = _rs_items(order, nch, RS_SHAPES[shape])
    c_eff = plan.num_channels
    _, m_tiles, n_tiles = rs_tiles(RS_SHAPES[shape], c_eff, R)
    assert len(items) == R * R * c_eff * m_tiles * n_tiles
    setter, writer = check_order(items)
    for pos, it in enumerate(items):
        assert it.index == pos
        assert _decode(it.index, R, c_eff, m_tiles, n_tiles) == (it.s, it.r, it.c, it.mt, it.nt)
        assert (it.wait is None) == (it.s == 0) and (not it.writes) == (it.s == R - 1)
    # the last stage of every rank reduces its home segment
    assert {it.seg for it in items if it.s == R - 1 and it.r == 0} == {0}
    slots = {(r, s, c, m, n) for r in range(R) for s in range(R - 1) for c in range(c_eff)
             for m in range(m_tiles) for n in range(n_tiles)}  # fmt: skip
    assert set(writer) == slots and set(setter) == {("part",) + t for t in slots}


def _per_batch(fn, x, w):
    """Apply a 2-D-shard oracle [R, m, k] x [R, k, n] to every batch row."""
    lead = x.shape[1:-2]
    xb = x.reshape((R, -1) + x.shape[-2:])
    outs = [np.asarray(fn(xb[:, i], w)) for i in range(xb.shape[1])]
    out = np.stack(outs, axis=1)
    return out.reshape((R,) + tuple(lead) + out.shape[2:])


@pytest.mark.parametrize("xs,ws", AG_SMALL, ids=str)
@pytest.mark.parametrize("order,nch", SWEEP)
def test_ag_gemm_plain_matches_jax_oracle(order, nch, xs, ws):
    rng = np.random.default_rng(3)
    x, w = rng.standard_normal(xs).astype(np.float32), rng.standard_normal(ws).astype(np.float32)
    ch = _channel(order, nch)
    out = ag_gemm_plain(torch.from_numpy(x), torch.from_numpy(w), channel=ch)
    np.testing.assert_allclose(out.numpy(), _per_batch(jref.ag_gemm_ref, x, w), **F32)
    cpu = ag_gemm(torch.from_numpy(x), torch.from_numpy(w), channel=ch)  # the wrapper on CPU tensors: the same
    assert torch.equal(cpu, out)


@pytest.mark.parametrize("xs,ws", RS_SMALL, ids=str)
@pytest.mark.parametrize("order,nch", SWEEP)
def test_gemm_rs_plain_matches_jax_oracle(order, nch, xs, ws):
    rng = np.random.default_rng(4)
    x, w = rng.standard_normal(xs).astype(np.float32), rng.standard_normal(ws).astype(np.float32)
    ch = _channel(order, nch)
    out = gemm_rs_plain(torch.from_numpy(x), torch.from_numpy(w), channel=ch)
    np.testing.assert_allclose(out.numpy(), _per_batch(jref.gemm_rs_ref, x, w), **F32)
    cpu = gemm_rs(torch.from_numpy(x), torch.from_numpy(w), channel=ch)
    assert torch.equal(cpu, out)
