"""The port's sequence-parallel attention (the ``ag_attention`` kind) against
the JAX package's, on the CPU.

Port side: ``core/overlap.ring_attention`` (eager: the reference's math; and
the fused backend, whose flash wrapper runs its plain version with per-rank
offsets and the carried state on CPU tensors) and ``ag_attention_baseline``,
on rank-stacked operands; ``nn/attention.apply_seq_ring`` on parameters
converted by ``convert.from_jax_params``.  JAX side: ``repro.core.overlap``
and ``repro.nn.attention`` under ``shard_map`` on a 4-device ``model`` mesh.
Inputs come from a numpy seed; each rank gets its own queries and KV.

Tolerances: float32 atol / rtol 1e-4 (summation order); bfloat16 against the
float32 oracle on the same bf16-rounded inputs atol 8e-2 / rtol 3e-2; the
layer forms 2e-4 / 2e-3 (the bound of ``tests/test_tune.py``'s
``apply_seq_ring`` == ``apply_seq``).
"""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh, shard_map
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import BlockChannel as JChannel
from repro.core import CommSpec as JComm
from repro.core import CompSpec as JComp
from repro.core import overlap as jov
from repro.nn import attention as jattn
from repro.parallel.context import ParallelContext as JParallelContext
from repro_torch.backend.mesh import World
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_jax_params
from repro_torch.core import BlockChannel, CommSpec, CompSpec, compile_overlap, unsupported_error
from repro_torch.nn import attention
from repro_torch.parallel.context import ParallelContext
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

fa = importlib.import_module("repro_torch.kernels.flash_attention")  # the module; the package exports the function

R = 4
B, H, D = 2, 8, 16
F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=8e-2, rtol=3e-2)
LAYER = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh((R,), ("model",))


@pytest.fixture(scope="module")
def world():
    return World(R, "cpu")


def _inputs(seed, form, s_loc, hkv):
    """Rank-stacked q [W, B, H, Sq, D], k / v [W, B, Hkv, s_loc, D]."""
    rng = np.random.default_rng(seed)
    sq = s_loc if form == "shard" else R * s_loc
    q = rng.standard_normal((R, B, H, sq, D)).astype(np.float32)
    k = rng.standard_normal((R, B, hkv, s_loc, D)).astype(np.float32)
    v = rng.standard_normal((R, B, hkv, s_loc, D)).astype(np.float32)
    return q, k, v


def _chans(order="ring", nch=1, tile=None):
    comp = {} if tile is None else dict(tile=tile)
    j = JChannel(axis="model", num_channels=nch, comm=JComm(order=order), comp=JComp(**comp))
    t = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order), comp=CompSpec(**comp))
    return j, t


def _jax_pair(mesh, jch, q, k, v, **kw):
    """JAX ring_attention and ag_attention_baseline on the rank-stacked inputs."""

    def f(qs, ks, vs):
        qs, ks, vs = qs[0], ks[0], vs[0]
        ring = jov.ring_attention(qs, ks, vs, axis="model", channel=jch, **kw)
        base = jov.ag_attention_baseline(qs, ks, vs, axis="model", **kw)
        return ring[None], base[None]

    spec = P("model", None, None, None, None)
    fn = jax.jit(shard_map(f, mesh, in_specs=(spec,) * 3, out_specs=(spec, spec)))
    ring, base = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(ring), np.asarray(base)


def _port_all(world, tch, q, k, v, **kw):
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    eager = compile_overlap("ag_attention", tch, world=world)(qt, kt, vt, **kw)
    fused = compile_overlap("ag_attention", tch, world=world, backend="fused")(qt, kt, vt, **kw)
    base = compile_overlap("ag_attention", tch, world=world, overlapped=False)(qt, kt, vt, **kw)
    return eager.numpy(), fused.numpy(), base.numpy()


def _check(mesh4, world, order, nch, form, s_loc, hkv, causal, window, kv_select, tile=None, seed=0):
    q, k, v = _inputs(seed, form, s_loc, hkv)
    jch, tch = _chans(order, nch, tile)
    kw = dict(causal=causal, window=window, kv_select=kv_select)
    j_ring, j_base = _jax_pair(mesh4, jch, q, k, v, **kw)
    eager, fused, base = _port_all(world, tch, q, k, v, **kw)
    np.testing.assert_allclose(eager, j_ring, **F32)
    np.testing.assert_allclose(base, j_base, **F32)
    np.testing.assert_allclose(fused, eager, **F32)


@pytest.mark.parametrize("order,nch", list(itertools.product(("ring", "bidir_ring", "all2all"), (1, 2))))
def test_orders_and_channels_match_reference(mesh4, world, order, nch):
    _check(mesh4, world, order, nch, "shard", 80, 2, True, 48, False)


@pytest.mark.parametrize(
    "causal,window,form,s_loc",
    [(c, w, f, s) for c, w, f, s in itertools.product((False, True), (None, 48), ("shard", "gather"), (16, 80))
     if (w is None or s == 80)],
)  # fmt: skip
def test_masks_and_query_forms_match_reference(mesh4, world, causal, window, form, s_loc):
    _check(mesh4, world, "bidir_ring", 2 if s_loc % 2 == 0 else 1, form, s_loc, 4, causal, window, False)


@pytest.mark.parametrize("hkv,form", list(itertools.product((1, 2, 4, 8), ("shard", "gather"))))
def test_kv_select_matches_reference(mesh4, world, hkv, form):
    _check(mesh4, world, "ring", 2, form, 16, hkv, True, None, True)


def test_comp_tile_blocks_the_consumer(mesh4, world):
    """A non-default CompSpec tile blocks the eager update as (block_q, block_kv)."""
    _check(mesh4, world, "ring", 1, "gather", 80, 2, True, 48, False, tile=(160, 128, 40))


def test_bf16_against_f32_oracle(world):
    q, k, v = _inputs(3, "shard", 80, 2)
    _, tch = _chans("bidir_ring", 2)
    bq, bk, bv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    oracle = compile_overlap("ag_attention", tch, world=world)(bq.float(), bk.float(), bv.float(), causal=True)
    for backend in ("eager", "fused"):
        out = compile_overlap("ag_attention", tch, world=world, backend=backend)(bq, bk, bv, causal=True)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), oracle.numpy(), **BF16)


def test_fused_ring_runs_the_flash_wrapper_once_per_step_and_channel(world, monkeypatch):
    """The fused ring calls the flash wrapper steps x channels times, with the
    plan's key offsets, the state carried, and only the last call final."""
    calls = []
    real = fa.flash_attention_ranked

    def spy(q, k, v, **kw):
        calls.append((kw["k_off"], kw["state"] is not None, kw["final"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention_ranked", spy)
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, "shard", 16, 2))
    _, tch = _chans("ring", 2)
    compile_overlap("ag_attention", tch, world=world, backend="fused")(q, k, v, causal=True)
    assert len(calls) == R * 2
    assert [c[2] for c in calls] == [False] * (R * 2 - 1) + [True]
    assert [c[1] for c in calls] == [False] + [True] * (R * 2 - 1)
    assert calls[0][0] == tuple(r * 16 for r in range(R)) and calls[1][0] == tuple(r * 16 + 8 for r in range(R))


def test_tiled_twin_offsets_and_carry_match_chunked():
    """flash_attention_tiled with an offset and a carried state (the keys in
    two launches) equals chunked_attention on the same positions, on every
    row with a visible key; the default offset equals today's right-aligned
    call bitwise."""
    rng = np.random.default_rng(5)
    for sq, sk, q_off, causal, window in itertools.product((80, 130), (80, 160), (0, 80, 200), (False, True), (None, 48)):
        q = torch.from_numpy(rng.standard_normal((6, sq, D)).astype(np.float32))
        k, v = (torch.from_numpy(rng.standard_normal((3, sk, D)).astype(np.float32)) for _ in range(2))
        half = sk // 2
        kw = dict(causal=causal, window=window, p_bf16=False)
        st = fa.flash_attention_tiled(q, k[:, :half], v[:, :half], off=q_off, final=False, **kw)
        out = fa.flash_attention_tiled(q, k[:, half:], v[:, half:], off=q_off - half, state=st, **kw)
        ref = fa.chunked_attention(q[None], k[None], v[None], causal=causal, window=window, chunk=sk, q_offset=q_off)[0]
        qp, kp = q_off + torch.arange(sq)[:, None], torch.arange(sk)[None]
        vis = torch.ones(sq, sk, dtype=torch.bool)
        if causal:
            vis &= qp >= kp
        if window:
            vis &= qp - kp < window
        rows = vis.any(1)
        np.testing.assert_allclose(out[:, rows].numpy(), ref[:, rows].numpy(), **F32)
    q = torch.from_numpy(rng.standard_normal((6, 200, D)).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((3, 256, D)).astype(np.float32)).bfloat16() for _ in range(2))
    today = fa.flash_attention_tiled(q, k, v, causal=True, window=100)
    assert torch.equal(fa.flash_attention_tiled(q, k, v, causal=True, window=100, off=56), today)
    one_rank = fa.flash_attention_ranked_plain(
        q.reshape(1, 1, 6, 200, D), k.reshape(1, 1, 3, 256, D), v.reshape(1, 1, 3, 256, D), q_off=(56,), k_off=(0,),
        causal=True, window=100, tiled=True,
    )  # fmt: skip
    assert torch.equal(one_rank.reshape(6, 200, D), today)


def test_ranked_wrapper_on_cpu_is_chunked_per_rank():
    """On CPU tensors the ranked wrapper is its plain version: chunked
    attention per rank at the rank's offsets and KV group, state carried."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, "shard", 16, 8))
    kw = dict(q_off=(0, 16, 32, 48), kv_start=(0, 2, 4, 6), kv_need=2, causal=True)
    st = fa.flash_attention_ranked(q, k, v, k_off=(0, 0, 16, 32), final=False, **kw)
    out = fa.flash_attention_ranked(q, k, v, k_off=(0, 16, 32, 48), state=st, **kw)
    assert isinstance(st, fa.FlashState) and st.o.shape == q.shape and st.m.shape == q.shape[:-1]
    r = 2  # rank 2 read its group (heads 4, 5) of the tile at keys 16..31, then at 32..47
    ref = fa.chunked_attention(
        q[r], torch.cat([k[r, :, 4:6], k[r, :, 4:6]], 2), torch.cat([v[r, :, 4:6], v[r, :, 4:6]], 2),
        causal=True, q_offset=32, k_offset=16, chunk=16,
    )  # fmt: skip
    np.testing.assert_allclose(out[r].numpy(), ref.numpy(), **F32)


def test_structured_errors(world):
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, "shard", 16, 2))
    ch = BlockChannel(axis="model")
    with pytest.raises(ValueError, match="must equal the KV shard rows 16 or the gathered extent 64"):
        compile_overlap("ag_attention", ch, world=world)(q[..., :12, :], k, v)
    with pytest.raises(ValueError, match="must equal the KV shard rows 16 or the gathered extent 64"):
        compile_overlap("ag_attention", ch, world=world, backend="fused")(q[..., :12, :], k, v)
    with pytest.raises(NotImplementedError) as err:
        compile_overlap("ag_attention", ch, world=world, backend="fused", overlapped=False)
    assert str(err.value) == str(unsupported_error("ag_attention", "fused", False))
    with pytest.raises(ValueError):
        fa.flash_attention_ranked(q, k, v, q_off=(0,) * 3, k_off=(0,) * R)
    with pytest.raises(ValueError):
        fa.flash_attention_ranked(q, k, v, q_off=(0,) * R, k_off=(0,) * R, kv_start=(1,) * R, kv_need=2)


# ---- the layer form: apply_seq_ring ------------------------------------------------------


def _tiny(n_kv):
    kw = dict(name="tiny", family="dense", n_layers=1, d_model=32, n_heads=8, n_kv_heads=n_kv, d_ff=64, vocab_size=64)
    return JArchConfig(**kw), ArchConfig(**kw)


@pytest.mark.parametrize("n_kv", [1, 2, 4, 8])
def test_apply_seq_ring_matches_reference(mesh4, world, n_kv):
    """Port apply_seq_ring (eager and fused) against the JAX package's at TP
    4, on parameters carried across by from_jax_params; and against the
    port's apply_seq."""
    jcfg, cfg = _tiny(n_kv)
    pc = JParallelContext(mesh=mesh4, axis="model", dp_axes=())
    jp = jattn.init(jax.random.PRNGKey(n_kv), jcfg, pc.tp, dtype=jnp.float32)
    x = np.random.default_rng(n_kv).standard_normal((2, R * 16, 32)).astype(np.float32) * 0.5
    sp = {k: pc.manual(v) for k, v in jattn.specs(jcfg, pc.tp, pc.dp_spec()).items()}
    sm = pc.smap(lambda p, xs: jattn.apply_seq_ring(p, xs, pc, jcfg), (sp, P(None, "model", None)), P(None, "model", None))
    ref = np.asarray(jax.jit(sm)(jp, jnp.asarray(x)))
    tree = {"embed": np.zeros((64, 32), np.float32), "final_ln": np.zeros((32,), np.float32),
            "prefix": [{"mixer": jax.tree_util.tree_map(np.asarray, jp)}]}  # fmt: skip
    params = from_jax_params(tree, cfg, world)["layers"][0]["mixer"]
    xt = torch.from_numpy(x).reshape(2, R, 16, 32).permute(1, 0, 2, 3).contiguous()

    def glob(y):
        return y.permute(1, 0, 2, 3).reshape(2, R * 16, 32).numpy()

    seq = attention.apply_seq(params, xt, ParallelContext(world=world), cfg)
    for backend in ("eager", "fused"):
        out = attention.apply_seq_ring(params, xt, ParallelContext(world=world, backend=backend), cfg)
        np.testing.assert_allclose(glob(out), ref, **LAYER)
        np.testing.assert_allclose(out.numpy(), seq.numpy(), **LAYER)
