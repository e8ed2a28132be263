"""The port's tile mappings (``repro_torch.core.mapping``) against the JAX
package's (``repro.core.mapping``), on the CPU.

``StaticTileMapping``: every host-int property and mapping, and the tensor
forms (``*_t``) over a range of tile ids, equal to the reference's over a
grid of (extent, tile, ranks, channels); ``validate()``'s three errors
with the reference's messages.  ``build_moe_dynamic_mapping``: the four
int32 tables equal to the reference's over a hypothesis sweep of
tile-aligned group offsets (some experts empty, some full), on an
explicit device; ``from_group_sizes`` raises as the reference does.
Exact equality throughout (integer arithmetic).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import mapping as jmap
from repro_torch.core import DynamicTileMapping, StaticTileMapping, build_moe_dynamic_mapping
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

GRID = [  # (dim, tile, world, channels)
    (256, 32, 4, 2),
    (1024, 64, 8, 1),
    (96, 8, 4, 3),
    (100, 10, 4, 1),  # per-rank extent 25: ragged against the tile
    (64, 64, 4, 1),  # fewer tiles than ranks
    (48, 4, 3, 4),
]
PROPS = ("per_rank", "per_channel", "tiles_per_rank", "tiles_per_channel", "num_tiles")


def _pair(dim, tile, world, channels):
    return StaticTileMapping(dim, tile, world, channels), jmap.StaticTileMapping(dim, tile, world, channels)


@pytest.mark.parametrize("dim,tile,world,channels", GRID)
def test_static_host_forms(dim, tile, world, channels):
    m, j = _pair(dim, tile, world, channels)
    assert [getattr(m, p) for p in PROPS] == [getattr(j, p) for p in PROPS]
    for t in range(m.num_tiles + 2):
        assert m.shape_range(t) == j.shape_range(t)
        assert (m.rank(t), m.channel(t), m.channel_in_rank(t)) == (j.rank(t), j.channel(t), j.channel_in_rank(t))
    for r in range(world):
        assert m.tiles_of_rank(r) == j.tiles_of_rank(r)


@pytest.mark.parametrize("dim,tile,world,channels", GRID)
def test_static_tensor_forms(dim, tile, world, channels):
    m, j = _pair(dim, tile, world, channels)
    ids = np.arange(m.num_tiles + 2, dtype=np.int32)
    t_ids, j_ids = torch.from_numpy(ids), jnp.asarray(ids)
    for got, want in zip(m.shape_range_t(t_ids), j.shape_range_t(j_ids)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(m.rank_t(t_ids).numpy(), np.asarray(j.rank_t(j_ids)))
    np.testing.assert_array_equal(m.channel_t(t_ids).numpy(), np.asarray(j.channel_t(j_ids)))


@pytest.mark.parametrize("dims", [(256, 32, 4, 2), (100, 7, 4, 1), (96, 8, 4, 5), (100, 5, 4, 1)])
def test_static_validate(dims):
    """validate(): the tile must divide the extent, then each rank's extent;
    the channels must divide a rank's tiles — the reference's errors."""
    m, j = _pair(*dims)
    try:
        j.validate()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            m.validate()
        assert str(got.value) == str(e)
    else:
        m.validate()


@st.composite
def _moe_tables(draw):
    e = draw(st.integers(1, 8))
    tile = draw(st.sampled_from([1, 4, 8, 16]))
    tiles_per_expert = draw(st.integers(1, 4))
    sizes = [tile * draw(st.integers(0, tiles_per_expert)) for _ in range(e)]  # tile-aligned, up to capacity
    experts_per_rank = draw(st.sampled_from([d for d in range(1, e + 1) if e % d == 0]))
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32), tiles_per_expert, tile, experts_per_rank


@settings(max_examples=60, deadline=None)
@given(_moe_tables())
def test_moe_dynamic_mapping_matches_reference(case):
    offsets, tiles_per_expert, tile, experts_per_rank = case
    got = build_moe_dynamic_mapping(torch.from_numpy(offsets), tiles_per_expert, tile, experts_per_rank,
                                    device=torch.device("cpu"))  # fmt: skip
    want = jmap.build_moe_dynamic_mapping(jnp.asarray(offsets), tiles_per_expert, tile, experts_per_rank)
    assert got.num_tiles == want.num_tiles == (len(offsets) - 1) * tiles_per_expert
    for name in ("f_S_low", "f_S_high", "f_R", "f_C"):
        a = getattr(got, name)
        assert a.dtype == torch.int32 and a.device == torch.device("cpu")
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want, name)), err_msg=name)
    for t in range(got.num_tiles):  # the tensor-indexed access
        lo, hi = got.shape_range_t(t)
        jlo, jhi = want.shape_range_t(t)
        assert (int(lo), int(hi), int(got.rank_t(t)), int(got.channel_t(t))) == (
            int(jlo), int(jhi), int(want.rank_t(t)), int(want.channel_t(t)))  # fmt: skip


def test_moe_dynamic_mapping_takes_a_list():
    m = build_moe_dynamic_mapping([0, 64, 64, 192], 2, 64, 2)
    assert m.f_S_low.tolist() == [0, 64, 64, 64, 64, 128] and m.f_S_high.tolist() == [64, 64, 64, 64, 128, 192]
    assert m.f_R.tolist() == [0, 0, 0, 0, 1, 1] and m.f_C.tolist() == [0, 0, 1, 1, 2, 2]


def test_from_group_sizes_refused_as_in_the_reference():
    for cls, arr in ((DynamicTileMapping, torch.tensor([2, 2])), (jmap.DynamicTileMapping, jnp.asarray([2, 2]))):
        with pytest.raises(NotImplementedError, match="build_moe_dynamic_mapping"):
            cls.from_group_sizes(arr, 2, 1)


def test_core_exports_the_mappings():
    import repro.core as jcore
    import repro_torch.core as core

    for name in ("StaticTileMapping", "DynamicTileMapping", "build_moe_dynamic_mapping", "effective_channels"):
        assert name in jcore.__all__ and name in core.__all__ and hasattr(core, name)


def test_static_mapping_covers_the_extent():
    """The mappings partition the extent: every row in exactly one tile, of
    the rank and channel the affine formulas give."""
    for dim, tile, world, channels in itertools.product([128, 192], [16, 32], [2, 4], [1, 2]):
        m = StaticTileMapping(dim, tile, world, channels)
        if dim % tile or m.per_rank % tile or m.tiles_per_rank % channels:
            continue
        m.validate()
        rows = [r for t in range(m.num_tiles) for r in range(*m.shape_range(t))]
        assert rows == list(range(dim))
        assert [m.rank(t) for t in range(m.num_tiles)] == [t // m.tiles_per_rank for t in range(m.num_tiles)]
