"""The port's kernel oracles (``repro_torch.kernels.ref``) against the JAX
package's (``repro.kernels.ref``), and every kernel's plain version against
the port's oracle, on the CPU.

Inputs are drawn from numpy seeds and handed to both packages as float32.
Cases: matmul (with an output dtype); flash attention causal, windowed,
GQA, Sq != Sk (queries right-aligned, the causal rows before the first key
fully masked), non-causal and an explicit scale; the grouped GEMM on
tile-aligned expert tables; AG+GEMM and GEMM+RS per rank (and with the
port's leading batch dims); the SSD recurrence with groups > 1 and an
initial state.  The kernel cases the reference's oracles do not cover are
held against the port's own: one ring step with the state of the step
before it against ``flash_attention_union_ref`` (both steps' KV tiles at
the ring's rank offsets), the SSD intra-chunk term against the float32
einsum of its formula, and GEMM+RS on a bf16 wire against
``gemm_rs_wire_ref`` (one bf16 rounding of the partial per hop, in the
plan's hop order).

Tolerances: the port's oracle against the reference's 1e-5 of max |ref|
(float32, summation order only); a plain version against the port's
oracle 1e-5 of max |oracle| (+1e-6 where outputs can be zero), as the
plain versions replay the kernels' tiles, slots and flags in float32;
``ssd_chunked`` (both intra-chunk forms) against ``ssd_ref`` 1e-4 of max,
the chunked form's exponentials of cumulative sums against the sequential
products.  The bf16 wire: bitwise on integer data (every float32 product
and sum exact, so only the wire rounds, at the same places on both
sides); on random data 2e-2 of max, one bf16 rounding (the float32
products of the two sides differ by summation order, which may move a
partial across a bf16 rounding boundary).  A bf16 SSD tile: 1e-2 of max
(both round y to bf16 once).
"""

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import kernels as K
from repro_torch.core import BlockChannel, CommSpec, QuantSpec
from repro_torch.core.plan import build_plan
from repro_torch.kernels.flash_attention import flash_attention_ranked, flash_attention_ranked_plain
from repro_torch.kernels.gemm_rs import launch_plan
from repro_torch.kernels import ref
from repro_torch.kernels.grouped_matmul import group_tile_table
from repro_torch.kernels.mamba_ssd import ssd_chunked
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

RTOL = 1e-5
ORDERS = ("ring", "bidir_ring", "all2all")


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= atol + rtol * max(np.abs(want).max(), 1e-30), err


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- the port's oracles against the reference's ------------------------------------------------


@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_matmul_ref(out_dtype):
    x, w = _rand(0, 37, 24), _rand(1, 24, 19)
    got = ref.matmul_ref(_t(x), _t(w), getattr(torch, out_dtype) if out_dtype else None)
    want = jref.matmul_ref(x, w, out_dtype)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    _close(got.float(), np.asarray(want, np.float32))


FLASH = {  # (bh, bhkv, sq, sk, d, causal, window, scale)
    "causal": (4, 4, 48, 48, 16, True, None, None),
    "window": (4, 4, 48, 48, 16, True, 8, None),
    "gqa": (8, 2, 32, 32, 16, True, None, None),
    "sq_lt_sk": (4, 2, 16, 40, 16, True, 12, None),
    "sq_gt_sk": (4, 4, 40, 16, 8, True, None, None),  # the first 24 query rows see no key: zeros
    "non_causal": (6, 3, 24, 56, 32, False, None, 0.3),
    "window_only": (4, 4, 32, 32, 16, False, 5, None),
}


@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_attention_ref(case):
    bh, bhkv, sq, sk, d, causal, window, scale = FLASH[case]
    q, k, v = _rand(2, bh, sq, d), _rand(3, bhkv, sk, d), _rand(4, bhkv, sk, d)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window, scale=scale)
    want = jref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    _close(got, want)
    if case == "sq_gt_sk":
        assert got[:, : sq - sk].abs().max().item() == 0.0


@pytest.mark.parametrize("seed", range(3))
def test_grouped_matmul_ref(seed):
    rng = np.random.default_rng(seed)
    e, tile_m, k, n = 5, 8, 24, 20
    table = rng.integers(0, e, size=7).astype(np.int32)  # non-monotone, repeats, an expert unused
    x, w = _rand(seed, 7 * tile_m, k), _rand(seed + 10, e, k, n)
    got = ref.grouped_matmul_ref(_t(x), _t(w), _t(table), tile_m)
    _close(got, jref.grouped_matmul_ref(x, w, table, tile_m))


def test_ag_gemm_ref():
    x, w = _rand(5, 4, 6, 24), _rand(6, 4, 24, 10)
    _close(ref.ag_gemm_ref(_t(x), _t(w)), jref.ag_gemm_ref(x, w))


def test_gemm_rs_ref():
    x, w = _rand(7, 4, 16, 12), _rand(8, 4, 12, 20)
    _close(ref.gemm_rs_ref(_t(x), _t(w)), jref.gemm_rs_ref(x, w))


def test_collective_refs_take_leading_dims():
    """[R, *lead, rows, K]: per leading index, the reference's [R, rows, K] form."""
    x, w = _rand(9, 4, 3, 6, 24), _rand(10, 4, 24, 10)
    got = ref.ag_gemm_ref(_t(x), _t(w))
    for b in range(3):
        _close(got[:, b], jref.ag_gemm_ref(x[:, b], w))
    x, w = _rand(11, 4, 2, 16, 12), _rand(12, 4, 12, 20)
    got = ref.gemm_rs_ref(_t(x), _t(w))
    for b in range(2):
        _close(got[:, b], jref.gemm_rs_ref(x[:, b], w))


@pytest.mark.parametrize("groups,with_init", [(1, False), (2, True), (4, True)])
def test_ssd_ref(groups, with_init):
    bsz, length, h, p, n = 2, 40, 4, 8, 6
    x = _rand(13, bsz, length, h, p)
    dt = np.log1p(np.exp(_rand(14, bsz, length, h))).astype(np.float32)  # softplus: positive
    a_log = _rand(15, h, scale=0.5)
    b, c = _rand(16, bsz, length, groups, n), _rand(17, bsz, length, groups, n)
    d_init = _rand(18, bsz, h, n, p) if with_init else None
    got = ref.ssd_ref(_t(x), _t(dt), _t(a_log), _t(b), _t(c), d_init=None if d_init is None else _t(d_init))
    _close(got, jref.ssd_ref(x, dt, a_log, b, c, d_init=d_init))


# --- every plain version against the port's oracle ---------------------------------------------


def test_matmul_plain_vs_ref():
    x, w = _t(_rand(20, 33, 40)), _t(_rand(21, 40, 52))
    _close(K.matmul_plain(x, w), ref.matmul_ref(x, w))


@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_plain_vs_ref(case):
    """Every row that sees a key against the oracle.  A causal row before the
    first key (Sq > Sk) sees none: the oracle gives it zeros, while the
    kernels of both packages give it the mean of the masked values in the
    key tiles they visit (masked scores are -1e30, not -inf), so those rows
    are held against the reference's Pallas kernel in interpret mode."""
    from repro import kernels as jkernels

    bh, bhkv, sq, sk, d, causal, window, scale = FLASH[case]
    qn, kn, vn = _rand(22, bh, sq, d), _rand(23, bhkv, sk, d), _rand(24, bhkv, sk, d)
    q, k, v = _t(qn), _t(kn), _t(vn)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    blind = sq - sk if causal and sq > sk else 0  # rows 0 .. blind-1 see no key
    for got in (K.flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale),
                K.flash_attention(q, k, v, causal=causal, window=window, scale=scale)):  # fmt: skip
        _close(got[:, blind:], want[:, blind:], atol=1e-6)
        if blind:
            kernel = jkernels.flash_attention(qn, kn, vn, causal=causal, window=window, scale=scale, interpret=True)
            _close(got[:, :blind], np.asarray(kernel)[:, :blind], atol=1e-6)
            assert want[:, :blind].abs().max().item() == 0.0


@pytest.mark.parametrize("kind", ["groups", "random"])
def test_grouped_matmul_plain_vs_ref(kind):
    e, k, n = 6, 24, 32
    if kind == "groups":  # the MoE path's table: e groups of 16 rows, 8-row tiles
        table = group_tile_table(e, 16, torch.device("cpu")).repeat_interleave(2)
    else:  # a random, non-monotone table with empty tiles (-1 and E)
        table = torch.from_numpy(np.random.default_rng(25).integers(-1, e + 1, size=12).astype(np.int32))
    x, w = _t(_rand(26, 8 * table.numel(), k)), _t(_rand(27, e, k, n))
    want = ref.grouped_matmul_ref(x, w, table, 8)
    _close(K.grouped_matmul_plain(x, w, table), want, atol=1e-6)
    _close(K.grouped_matmul(x, w, table), want, atol=1e-6)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("nch", [1, 2])
def test_fused_collectives_plain_vs_ref(order, nch):
    """The fused kernels' plain versions replay their schedules; the oracle has none."""
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    x, w = _t(_rand(28, 4, 3, 8, 24)), _t(_rand(29, 4, 24, 40))
    _close(K.ag_gemm_plain(x, w, channel=ch), ref.ag_gemm_ref(x, w))
    x, w = _t(_rand(30, 4, 3, 16, 20)), _t(_rand(31, 4, 20, 48))
    _close(K.gemm_rs_plain(x, w, channel=ch), ref.gemm_rs_ref(x, w))


@pytest.mark.parametrize("intra", ["einsum", "kernel"])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_vs_ref(intra, groups):
    bsz, length, h, p, n = 2, 50, 4, 8, 6  # a ragged last chunk of 18
    x = _t(_rand(32, bsz, length, h, p))
    dt = torch.nn.functional.softplus(_t(_rand(33, bsz, length, h)))
    a_log = _t(_rand(34, h, scale=0.5))
    b, c = _t(_rand(35, bsz, length, groups, n)), _t(_rand(36, bsz, length, groups, n))
    h0 = _t(_rand(37, bsz, h, n, p))
    got = ssd_chunked(x, dt, a_log, b, c, chunk=16, h_init=h0, intra=intra)
    _close(got, ref.ssd_ref(x, dt, a_log, b, c, chunk=16, d_init=h0), rtol=1e-4)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("tiled", [False, True])
def test_ring_step_plain_vs_union_ref(order, tiled):
    """Both ring steps of the ``ag_attention`` plan in turn, the state of
    step 0 carried into step 1 (``flash_attention_ranked``, the plain
    version on the CPU, both state units), against attention over the union
    of the two steps' KV tiles at the ring's rank offsets."""
    world, b, h, s_loc, d = 4, 2, 3, 16, 8
    q, k, v = (_t(_rand(40 + i, world, b, h, s_loc, d)) for i in range(3))
    plan = build_plan("ag_attention", BlockChannel(axis="model", comm=CommSpec(order=order)), world, 1)
    src = [plan.channels[0].source_table(t) for t in (0, 1)]
    kt, vt = [k[torch.tensor(t)] for t in src], [v[torch.tensor(t)] for t in src]
    q_off = tuple(r * s_loc for r in range(world))
    k_off = [tuple(x * s_loc for x in t) for t in src]
    kw = dict(q_off=q_off, causal=True, tiled=tiled)
    st = flash_attention_ranked_plain(q, kt[0], vt[0], k_off=k_off[0], final=False, **kw)
    got = flash_attention_ranked_plain(q, kt[1], vt[1], k_off=k_off[1], state=st, **kw)
    want = ref.flash_attention_union_ref(q, kt, vt, q_off=q_off, k_offs=k_off, causal=True)
    # the tiled replay rounds P to bf16 before P V, as the wgmma route does
    _close(got, want, rtol=1e-2 if tiled else RTOL, atol=1e-6)
    if not tiled:  # the wrapper on CPU tensors is the plain version
        st = flash_attention_ranked(q, kt[0], vt[0], k_off=k_off[0], q_off=q_off, causal=True, final=False)
        out = flash_attention_ranked(q, kt[1], vt[1], k_off=k_off[1], q_off=q_off, causal=True, state=st)
        _close(out, want, atol=1e-6)


def test_union_ref_refuses_a_gap():
    q = torch.zeros(1, 1, 1, 4, 2)
    kv = [torch.zeros(1, 1, 1, 4, 2)] * 2
    with pytest.raises(ValueError, match="not contiguous"):
        ref.flash_attention_union_ref(q, kv, kv, q_off=(8,), k_offs=[(8,), (6,)], causal=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,q,p", [(6, 16, 8), (3, 64, 64)])
def test_ssd_intra_chunk_plain_vs_ref(dtype, t, q, p):
    """The intra-chunk term (the wrapper on CPU tensors: its plain version)
    against the einsum of ``(CB ∘ exp(cum_i − cum_j) ∘ [i ≥ j]) @ xdt``."""
    dt = getattr(torch, dtype)
    cum = _t(-np.cumsum(np.abs(_rand(50, t, q)) * 0.7, axis=1)).to(dt)
    cb, xdt = _t(_rand(51, t, q, q, scale=0.3)).to(dt), _t(_rand(52, t, q, p, scale=0.5)).to(dt)
    want = ref.ssd_intra_chunk_ref(cum, cb, xdt)
    rtol = RTOL if dtype == "float32" else 1e-2
    for got in (K.ssd_intra_chunk_plain(cum, cb, xdt), K.ssd_intra_chunk(cum, cb, xdt)):
        assert got.dtype == dt
        _close(got.float(), want.float(), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_rs_bf16_wire_plain_vs_ref(order, nch, dtype):
    """GEMM+RS with bf16 partials under float32 accumulation: the plain
    version against the oracle that rounds each segment's partial once per
    hop, in the hop order of the plan's tables."""
    dt = getattr(torch, dtype)
    wire = QuantSpec(wire_dtype="bfloat16")
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order), quant=wire)
    plan, _ = launch_plan(torch.empty(4, 1, 16, 20), torch.empty(4, 20, 48), ch)
    assert plan.flow_dtype == "bfloat16"
    rng = np.random.default_rng(53)
    # integers: every float32 product and sum is exact, so the two sides round at the same places
    x, w = (_t(rng.integers(-8, 9, size=sh).astype(np.float32)).to(dt) for sh in ((4, 3, 16, 20), (4, 20, 48)))
    want = ref.gemm_rs_wire_ref(x, w, plan.rs_seg_tables(), torch.bfloat16)
    got = K.gemm_rs_plain(x, w, channel=ch)
    assert torch.equal(got, want)
    assert not torch.equal(want, ref.gemm_rs_ref(x, w))  # the wire rounds: the exact sum differs
    x, w = _t(_rand(54, 4, 3, 16, 20)).to(dt), _t(_rand(55, 4, 20, 48)).to(dt)
    want = ref.gemm_rs_wire_ref(x, w, plan.rs_seg_tables(), torch.bfloat16)
    _close(K.gemm_rs_plain(x, w, channel=ch).float(), want.float(), rtol=2e-2)


def test_ops_names():
    """``kernels.ops`` gives the reference's public kernel names (the
    collective ones as the port's world-stacked wrappers)."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops

    port = {"ag_gemm_shard": "ag_gemm", "gemm_rs_shard": "gemm_rs"}
    for name in jops.__all__:
        if name == "auto_interpret":  # the device chooses: no counterpart
            assert not hasattr(ops, name)
            continue
        assert getattr(ops, port.get(name, name)) is getattr(K, port.get(name, name))
    assert set(ref.__all__) == set(jref.__all__)
