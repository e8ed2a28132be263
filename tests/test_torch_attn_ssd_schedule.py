"""The schedules of the Hopper flash-attention (wgmma route) and SSD
intra-chunk kernels, on the CPU.

Flash attention: ``flash_attention_tiled`` replays the wgmma route's
schedule (64-row query tiles, the KV tiles of ``kv_tiles`` in order, masks
on edge tiles only, exp2 online softmax, P rounded to bf16 before P V) and
is held to the JAX package's oracle ``ref.flash_attention_ref`` and to its
Pallas ``flash_attention`` in interpret mode, on numpy-seeded inputs.

SSD intra-chunk: ``mamba_ssd.block_tiles`` / ``thread_pairs`` model which
tiles a persistent block takes and which (i, j) pairs a thread computes; the
tests hold that every pair of the lower triangle is computed exactly once,
none above it, with equal work per thread, and replay the model's pairs
against the Pallas kernel in interpret mode.

Tolerances: float32 P 1e-5 (one product per tile, summation order); bf16 P
2e-2 of max |oracle| (P rounds to 8 mantissa bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jk
from repro.kernels import ref
from repro_torch.kernels import mamba_ssd
from repro_torch.kernels.flash_attention import TILE, flash_attention_tiled, kv_tiles
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

F32 = dict(atol=1e-5, rtol=1e-5)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# (bh, bhkv, sq, sk, d, causal, window): GQA rep 1, 2, 3; causal, window and
# non-causal; Sq < Sk down to 1; S not a multiple of 64
FLASH_CASES = [
    (4, 4, 100, 100, 16, True, None), (4, 2, 64, 64, 64, True, None), (6, 2, 130, 130, 16, True, 40),
    (3, 1, 37, 130, 32, False, None), (6, 2, 1, 200, 16, True, None), (3, 1, 1, 77, 16, False, 30),
    (4, 4, 65, 65, 64, False, 33), (6, 3, 256, 256, 16, True, None),
]  # fmt: skip


def _flash_inputs(seed, bh, bhkv, sq, sk, d):
    return _rand(seed, bh, sq, d), _rand(seed + 1, bhkv, sk, d), _rand(seed + 2, bhkv, sk, d)


@pytest.mark.parametrize("bh,bhkv,sq,sk,d,causal,window", FLASH_CASES)
def test_flash_tiled_f32_p_matches_oracle(bh, bhkv, sq, sk, d, causal, window):
    q, k, v = _flash_inputs(sq + sk, bh, bhkv, sq, sk, d)
    got = flash_attention_tiled(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window, p_bf16=False)
    want = ref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("bh,bhkv,sq,sk,d,causal,window", FLASH_CASES)
def test_flash_tiled_bf16_p_against_f32_oracle(bh, bhkv, sq, sk, d, causal, window):
    """bf16 inputs and a bf16 P against the f32 oracle on the same inputs."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _flash_inputs(7 * sq + sk, bh, bhkv, sq, sk, d))
    got = flash_attention_tiled(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    args = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    want = np.asarray(ref.flash_attention_ref(*args, causal=causal, window=window))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("causal,window,rep,s", [(True, None, 2, 128), (True, 40, 1, 128), (False, None, 3, 64)])
def test_flash_tiled_matches_pallas_interpret(causal, window, rep, s):
    q, k, v = _flash_inputs(11 + s, 2 * rep, 2, s, s, 16)
    got = flash_attention_tiled(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window, p_bf16=False)
    want = jk.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, window=window, bq=32, bk=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize(
    "sq,sk,causal,window",
    [(256, 256, True, None), (100, 100, True, 40), (1, 200, True, None), (37, 130, False, None),
     (65, 65, False, 33), (130, 130, True, 1)],
)  # fmt: skip
def test_kv_tiles_visit_exactly_the_tiles_with_a_visible_key(sq, sk, causal, window):
    """Every visible (query, key) pair lies in a visited tile, and every
    visited tile holds a visible key for some query of the query tile."""
    qpos = np.arange(sq)[:, None] + sk - sq
    kpos = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), dtype=bool)
    if causal:
        vis &= qpos >= kpos
    if window:
        vis &= qpos - kpos < window
    for q0 in range(0, sq, TILE):
        lo, n = kv_tiles(q0, sq, sk, causal, window)
        assert lo % TILE == 0 and n >= 0
        rows = vis[q0 : q0 + TILE]
        visited = np.zeros(sk, dtype=bool)
        visited[lo : lo + n * TILE] = True
        assert not (rows.any(0) & ~visited).any()
        for k0 in range(lo, lo + n * TILE, TILE):
            assert rows[:, k0 : k0 + TILE].any()


# ---- SSD intra-chunk: the persistent grid and the triangle split ------------


@pytest.mark.parametrize("grid", [1, 3, 132])
@pytest.mark.parametrize("t", [1, 37, 1280])
def test_ssd_blocks_cover_every_tile_once(t, grid):
    g = min(t, grid)  # the kernel's G = min(T, resident blocks)
    taken = [tile for tiles in mamba_ssd.block_tiles(t, g) for tile in tiles]
    assert sorted(taken) == list(range(t))
    sizes = [len(tiles) for tiles in mamba_ssd.block_tiles(t, g)]
    assert max(sizes) - min(sizes) <= 1


def test_ssd_threads_compute_the_triangle_once_with_equal_work():
    q = mamba_ssd.MAX_Q
    cover = np.zeros((q, q, mamba_ssd.MAX_P), dtype=np.int32)
    counts = []
    for tid in range(mamba_ssd.THREADS):
        pairs, cols = mamba_ssd.thread_pairs(tid)
        counts.append(len(pairs))
        for i, j in pairs:
            assert j <= i
            cover[i, j, cols] += 1
    assert (cover == np.tril(np.ones((q, q), dtype=np.int32))[:, :, None]).all()
    # every thread the same count (within one row group's worth: 64 pairs)
    row_threads = mamba_ssd.THREADS // 8
    assert max(counts) - min(counts) <= q and set(counts) == {q * (q + 1) // 2 // row_threads}


@pytest.mark.parametrize(
    "q,p,dtype,bulk",
    [(64, 64, torch.float32, True), (64, 64, torch.bfloat16, True), (16, 16, torch.float32, True),
     (16, 16, torch.bfloat16, True), (37, 23, torch.float32, False), (37, 23, torch.bfloat16, False),
     (4, 3, torch.float32, False), (8, 3, torch.bfloat16, False), (5, 64, torch.float32, False),
     (12, 8, torch.bfloat16, False), (8, 8, torch.bfloat16, True), (4, 12, torch.float32, True)],
)  # fmt: skip
def test_ssd_staging_path_by_shape(q, p, dtype, bulk):
    assert mamba_ssd.bulk_staged(q, p, dtype) is bulk


def _replay(cum, cb, xdt, grid):
    """y from the model's schedule: each block's tiles, each thread's pairs
    on the tile padded to 64 x 64 (G = 0 at or past Q, rows and columns past
    Q and P dropped)."""
    t, q = cum.shape
    p = xdt.shape[2]
    mq, mp = mamba_ssd.MAX_Q, mamba_ssd.MAX_P
    y = np.zeros((t, q, p), dtype=np.float32)
    per_thread = [mamba_ssd.thread_pairs(tid) for tid in range(mamba_ssd.THREADS)]
    for tiles in mamba_ssd.block_tiles(t, grid):
        for tile in tiles:
            x = np.zeros((mq, mp), dtype=np.float32)
            x[:q, :p] = xdt[tile]
            acc = np.zeros((mq, mp), dtype=np.float32)
            for pairs, cols in per_thread:
                for i, j in pairs:
                    g = cb[tile, i, j] * np.exp(cum[tile, i] - cum[tile, j]) if i < q else 0.0
                    acc[i, cols] += g * x[j, cols]
            y[tile] = acc[:q, :p]
    return y


@pytest.mark.parametrize("t,q,p,grid", [(3, 64, 64, 2), (4, 37, 23, 3)])
def test_ssd_schedule_replay_matches_pallas_interpret(t, q, p, grid):
    rng = np.random.default_rng(t * q + p)
    cum = -np.cumsum(np.abs(rng.standard_normal((t, q))) * 0.7, axis=1).astype(np.float32)
    cb = (rng.standard_normal((t, q, q)) * 0.3).astype(np.float32)
    xdt = (rng.standard_normal((t, q, p)) * 0.5).astype(np.float32)
    want = np.asarray(jk.ssd_intra_chunk(jnp.asarray(cum), jnp.asarray(cb), jnp.asarray(xdt), interpret=True))
    np.testing.assert_allclose(_replay(cum, cb, xdt, grid), want, **F32)
