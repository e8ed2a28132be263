"""The port's AG+MoE path against the JAX package's, at W = 4 on the CPU.

Port side: ``repro_torch.core.moe_overlap`` on a 4-rank ``World`` (the eager
executor, and the fused backend whose grouped-GEMM wrapper runs its plain
version on CPU tensors).  JAX side: the ``"xla"`` executor in ``shard_map`` on
a 4-device CPU mesh, as ``tests/test_a2a_moe.py`` runs it, the Pallas
``grouped_matmul`` in interpret mode and its oracle ``ref.grouped_matmul_ref``.
Inputs come from a numpy seed.

Tolerances: float32 ops 1e-5 (summation order); the MoE layer 1e-5 at
unit-scale outputs; bfloat16 2e-2 of max |ref| against the float32 oracle on
the same bf16-rounded inputs.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import kernels as jk
from repro.analysis import PlanTables, verify_tables
from repro.compat import make_mesh, shard_map
from repro.configs import get_config as j_get_config
from repro.core import BlockChannel as JChannel
from repro.core import CommSpec as JComm
from repro.core import compile_overlap as j_compile
from repro.core import moe_overlap as jmoe
from repro.core import plan as jplan
from repro.kernels import ref as jref
from repro.nn import moe as j_nn_moe
from repro.parallel.context import ParallelContext as JContext
from repro_torch import kernels
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import shard_rows
from repro_torch.core import BlockChannel, CommSpec, compile_overlap
from repro_torch.core import channels as tch
from repro_torch.core import moe_overlap as tmoe
from repro_torch.core import plan as tplan
from repro_torch.kernels.grouped_matmul import group_tile_table
from repro_torch.nn import moe as t_nn_moe
from repro_torch.parallel.context import ParallelContext
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

R = 4
ORDERS = ("ring", "bidir_ring", "all2all")
F32 = dict(atol=1e-5, rtol=1e-5)
TABLES = ("src_tables", "flow_dst_tables", "rs_seg_tables", "rs_dst_tables")
PLAN_GRID = list(itertools.product(ORDERS, (2, 3, 4, 8), (1, 2, 4)))


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh((R,), ("model",))


@pytest.fixture(scope="module")
def world():
    return World(R, "cpu")


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---- the plan: ag_moe tables and the reference verifier ---------------------


def _plans(order, world, nch):
    jp = jplan.build_plan("ag_moe", JChannel(axis="model", comm=JComm(order=order)), world, nch)
    tp = tplan.build_plan("ag_moe", tch.BlockChannel(axis="model", comm=tch.CommSpec(order=order)), world, nch)
    return jp, tp


@pytest.mark.parametrize("order,world,nch", PLAN_GRID)
def test_ag_moe_tables_equal_reference(order, world, nch):
    jp, tp = _plans(order, world, nch)
    assert tp.flow == jp.flow == "ag_rs" and tp.num_channels == jp.num_channels
    for name in TABLES:
        assert getattr(tp, name)() == getattr(jp, name)(), name
    for cj, ct in zip(jp.channels, tp.channels):
        assert ct.align_perm() == cj.align_perm()
        assert [ct.flow_perm(s) for s in range(world - 1)] == [cj.flow_perm(s) for s in range(world - 1)]


@pytest.mark.parametrize("order,world,nch", PLAN_GRID)
def test_ag_moe_plan_passes_reference_verifier(order, world, nch):
    _, tp = _plans(order, world, nch)
    report = verify_tables(PlanTables.from_plan(tp), protocol=True)
    assert report.checks > 0


# ---- router -----------------------------------------------------------------


@pytest.mark.parametrize("e,valid,k", [(8, None, 2), (8, 6, 2), (40, None, 8)])
def test_moe_router_matches_reference(e, valid, k):
    rng = np.random.default_rng(e + k)
    x, wr = _rand(rng, 3, 24, 32), _rand(rng, 32, e)
    ids, wts, aux = tmoe.moe_router(
        torch.from_numpy(x), torch.from_numpy(wr), num_experts=e, top_k=k, valid_experts=valid
    )
    assert ids.shape == wts.shape == (3, 24, k) and aux.shape == (3,)
    for b in range(3):  # the JAX router sees one batch row at a time (vmap)
        jid, jw, ja = jmoe.moe_router(jnp.asarray(x[b]), jnp.asarray(wr), num_experts=e, top_k=k, valid_experts=valid)
        np.testing.assert_array_equal(ids[b].numpy(), np.asarray(jid))
        np.testing.assert_allclose(wts[b].numpy(), np.asarray(jw), **F32)
        np.testing.assert_allclose(aux[b].item(), float(ja), rtol=1e-5)
    if valid is not None:
        assert int(ids.max()) < valid


# ---- the grouped GEMM's plain version ----------------------------------------


@pytest.mark.parametrize(
    "table,bm,dtype",
    [([0, 2, 2, 5], 16, "float32"), ([3, 0, 5, 1, 1, 4], 8, "float32"), ([0, 2, 2, 5], 16, "bfloat16")],
)
def test_grouped_matmul_plain_matches_reference(table, bm, dtype):
    rng = np.random.default_rng(len(table))
    e, k, n = 6, 48, 40
    m = len(table) * bm
    x, w = _rand(rng, m, k), _rand(rng, e, k, n, scale=k**-0.5)
    te = np.asarray(table, np.int32)
    jdt = jnp.dtype(dtype)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    want = np.asarray(jref.grouped_matmul_ref(jx, jw, jnp.asarray(te), bm, out_dtype=jnp.float32))
    interp = jk.grouped_matmul(jx, jw, jnp.asarray(te), tile=(bm, 128, 128), interpret=True)
    interp = np.asarray(interp.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    got = kernels.grouped_matmul(tx, tw, torch.from_numpy(te), out_dtype=torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_allclose(interp, want, atol=1e-4, rtol=1e-4)
    else:  # bf16 inputs, f32 out: only the summation order differs from the oracle
        np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max())
        low = kernels.grouped_matmul(tx, tw, torch.from_numpy(te)).float().numpy()  # stored in bf16
        np.testing.assert_allclose(low, want, atol=2e-2 * np.abs(want).max())


def test_grouped_matmul_empty_tiles_and_tables():
    rng = np.random.default_rng(7)
    x, w = torch.from_numpy(_rand(rng, 24, 8)), torch.from_numpy(_rand(rng, 3, 8, 5))
    out = kernels.grouped_matmul(x, w, torch.tensor([1, -1, 3], dtype=torch.int32))
    assert torch.equal(out[8:], torch.zeros(16, 5))  # out-of-range entries mark empty tiles
    np.testing.assert_allclose(out[:8].numpy(), (x[:8] @ w[1]).numpy(), **F32)
    with pytest.raises(ValueError):
        kernels.grouped_matmul(x, w, torch.zeros(5, dtype=torch.int32))  # 24 rows, 5 tiles
    # groups of 96 rows -> one 96-row tile each (ROW_TILE = 128, the bf16
    # kernel's m-tile); groups of 24 -> one 24-row tile each
    t = group_tile_table(3, 96, torch.device("cpu"))
    assert t.dtype == torch.int32 and t.tolist() == [0, 1, 2]
    assert group_tile_table(2, 384, torch.device("cpu")).tolist() == [0, 0, 0, 1, 1, 1]  # 128-row tiles
    assert group_tile_table(2, 24, torch.device("cpu")).tolist() == [0, 1]


# ---- local_expert_ffn / ag_moe / ag_moe_baseline against JAX -----------------


def _bf16_round(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _moe_operands(seed, m_loc, d=16, f=16, e=8, k=2, hot=False, lead=(), bf16=False):
    """Tokens [R, *lead, m_loc, d] with JAX-routed ids/weights, and expert
    weights; ``bf16`` rounds tokens and weights to bfloat16 values."""
    rng = np.random.default_rng(seed)
    x = _rand(rng, *((R,) + lead + (m_loc, d)), scale=0.5)
    wr = _rand(rng, d, e)
    if hot:  # experts 0 / 1 hot, so a tight capacity really drops tokens
        wr[:, :2] += 10.0
    wgu, wdn = _rand(rng, e, d, 2 * f, scale=0.1), _rand(rng, e, f, d, scale=0.1)
    if bf16:
        x, wgu, wdn = _bf16_round(x), _bf16_round(wgu), _bf16_round(wdn)
    ids, wts, _ = jmoe.moe_router(jnp.asarray(x.reshape(-1, d)), jnp.asarray(wr), num_experts=e, top_k=k)
    ids, wts = (np.array(a).reshape(x.shape[:-1] + (k,)) for a in (ids, wts))
    return x, ids, wts, wgu, wdn


@functools.lru_cache(maxsize=None)
def _jax_ag_moe(order, nch, cf, overlapped, seed, m_loc, hot, lead, bf16=False):
    """The JAX ag_moe (float32) on the 4-device mesh; one call per leading index."""
    mesh = make_mesh((R,), ("model",))
    x, ids, wts, wgu, wdn = _moe_operands(seed, m_loc, hot=hot, lead=lead, bf16=bf16)
    ch = JChannel(axis="model", num_channels=nch, comm=JComm(order=order))
    fn = j_compile("ag_moe", ch, overlapped=overlapped, capacity_factor=cf)
    row, w3 = P("model", None), P("model", None, None)
    sm = jax.jit(shard_map(fn, mesh, in_specs=(row, row, row, w3, w3), out_specs=row))
    xb, ib, wb = (a.reshape((R, -1) + a.shape[-2:]) for a in (x, ids, wts))
    outs = [
        np.asarray(sm(*(jnp.asarray(a[:, i].reshape(-1, a.shape[-1])) for a in (xb, ib, wb)), wgu, wdn))
        for i in range(xb.shape[1])
    ]
    return np.stack([o.reshape(R, m_loc, -1) for o in outs], axis=1).reshape(x.shape)


def _port_moe_operands(seed, m_loc, hot=False, lead=(), dtype=torch.float32):
    x, ids, wts, wgu, wdn = _moe_operands(seed, m_loc, hot=hot, lead=lead, bf16=dtype == torch.bfloat16)
    world = World(R, "cpu")
    return (
        torch.from_numpy(x).to(dtype),
        torch.from_numpy(ids).long(),
        torch.from_numpy(wts),
        shard_rows(torch.from_numpy(wgu), world).to(dtype),
        shard_rows(torch.from_numpy(wdn), world).to(dtype),
    )


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("cap,tile", [(16, None), (8, None), (8, (8, 8, 8))])
def test_local_expert_ffn_matches_reference(grouped, cap, tile):
    x, ids, wts, wgu, wdn = _moe_operands(3, 32, hot=True)
    got = tmoe.local_expert_ffn(
        *_port_moe_operands(3, 32, hot=True), cap=cap, tile=tile, grouped=grouped
    ).numpy()
    e_loc = wgu.shape[0] // R
    for r in range(R):
        sl = slice(r * e_loc, (r + 1) * e_loc)
        want = jmoe.local_expert_ffn(
            jnp.asarray(x[r]), jnp.asarray(ids[r]), jnp.asarray(wts[r]), jnp.asarray(wgu[sl]), jnp.asarray(wdn[sl]),
            e_lo=r * e_loc, cap=cap, tile=tile,
        )  # fmt: skip
        np.testing.assert_allclose(got[r], np.asarray(want), **F32)


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("order,nch,cf", list(itertools.product(ORDERS, (1, 2), (1.25, 0.25))))
def test_ag_moe_matches_reference(world, backend, order, nch, cf):
    """Under capacity_factor 0.25 with two hot experts both sides drop
    tokens; the outputs agree to summation order, so the kept/dropped sets
    are the same (a different set would show as an O(1) error)."""
    want = _jax_ag_moe(order, nch, cf, True, 11, 32, True, (2,))
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    fn = compile_overlap("ag_moe", ch, world=world, backend=backend, capacity_factor=cf)
    got = fn(*_port_moe_operands(11, 32, hot=True, lead=(2,))).numpy()
    np.testing.assert_allclose(got, want, **F32)
    if cf < 1.0:  # the tight capacity really dropped tokens
        assert not np.allclose(want, _jax_ag_moe(order, nch, 8.0, True, 11, 32, True, (2,)), atol=1e-3)


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_ag_moe_baseline_matches_reference(world, cf):
    want = _jax_ag_moe("ring", 1, cf, False, 12, 32, True, (2,))
    fn = compile_overlap("ag_moe", BlockChannel(axis="model"), world=world, overlapped=False, capacity_factor=cf)
    got = fn(*_port_moe_operands(12, 32, hot=True, lead=(2,))).numpy()
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_ag_moe_bf16_against_f32_oracle(world, backend):
    """bf16 operands, held to the float32 JAX ag_moe on the same bf16-rounded
    inputs (the routing is given, so no expert choice can flip)."""
    want = _jax_ag_moe("ring", 1, 1.25, True, 13, 32, False, (2,), bf16=True)
    kernels.reset_launch_counts()
    fn = compile_overlap("ag_moe", BlockChannel(axis="model"), world=world, backend=backend)
    got = fn(*_port_moe_operands(13, 32, lead=(2,), dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16 and kernels.launch_counts()["grouped_matmul"] == 0  # CPU: plain version
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2 * np.abs(want).max())


# ---- nn/moe: apply_seq with aux (incl. padded experts), apply_decode ---------


def _nn_setup(num_experts, seed=0):
    jcfg = j_reduce_config(j_get_config("granite-moe-3b-a800m"))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, num_experts=num_experts))
    cfg = reduce_config(get_config("granite-moe-3b-a800m"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=num_experts))
    jp = j_nn_moe.init(jax.random.PRNGKey(seed), jcfg, R, jnp.float32)
    jp = dict(jp, ln=jax.random.normal(jax.random.PRNGKey(seed + 1), jp["ln"].shape) * 0.1)
    world = World(R, "cpu")
    tp = {
        "ln": torch.from_numpy(np.array(jp["ln"])),
        "router": torch.from_numpy(np.array(jp["router"])),
        "w_gu": shard_rows(torch.from_numpy(np.array(jp["w_gu"])), world),
        "w_down": shard_rows(torch.from_numpy(np.array(jp["w_down"])), world),
    }
    return jcfg, cfg, jp, tp, world


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("num_experts", [8, 6])
def test_nn_moe_apply_seq_matches_reference(mesh4, backend, num_experts):
    """num_experts 6 pads to 8 on 4 ranks: the padding experts are never
    chosen and the aux loss sees the valid experts only."""
    jcfg, cfg, jp, tp, world = _nn_setup(num_experts)
    assert t_nn_moe.padded_experts(cfg, R) == 8 and tp["w_gu"].shape[:2] == (R, 2)
    x = _rand(np.random.default_rng(4), 2, R * 8, cfg.d_model)
    jpc = JContext(mesh=mesh4)
    specs = j_nn_moe.specs(jcfg, R, None)
    in_specs = (jax.tree_util.tree_map(jpc.manual, specs, is_leaf=lambda v: isinstance(v, P)), P(None, "model", None))
    sm = jpc.smap(lambda p, xx: j_nn_moe.apply_seq(p, xx, jpc, jcfg), in_specs, (P(None, "model", None), P()))
    jy, jaux = jax.jit(sm)(jp, jnp.asarray(x))
    pc = ParallelContext(world=world, backend=backend)
    y, aux = t_nn_moe.apply_seq(tp, world.shard(torch.from_numpy(x), dim=1), pc, cfg)
    np.testing.assert_allclose(world.unshard(y, dim=1).numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("num_experts", [8, 6])
def test_nn_moe_apply_decode_matches_reference(mesh4, num_experts):
    jcfg, cfg, jp, tp, world = _nn_setup(num_experts, seed=2)
    x = _rand(np.random.default_rng(5), 3, 2, cfg.d_model)
    jpc = JContext(mesh=mesh4)
    specs = j_nn_moe.specs(jcfg, R, None)
    in_specs = (jax.tree_util.tree_map(jpc.manual, specs, is_leaf=lambda v: isinstance(v, P)), P(None, None, None))
    sm = jpc.smap(lambda p, xx: j_nn_moe.apply_decode(p, xx, jpc, jcfg), in_specs, P(None, None, None))
    want = np.asarray(jax.jit(sm)(jp, jnp.asarray(x)))
    got = t_nn_moe.apply_decode(tp, torch.from_numpy(x), ParallelContext(world=world), cfg).numpy()
    np.testing.assert_allclose(got, want, **F32)
