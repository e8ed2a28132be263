"""The paper's tile-centric primitives in the port: the host half
(``repro_torch.core.primitives`` over a flag board, which the fused
kernels' plain versions call) and the device half's sources
(``kernels/csrc/tile_sync.cuh``, the only flag code of ``ag_gemm.cu`` and
``gemm_rs.cu``), on the CPU.

The reference's names (``repro.core.primitives``) are the port's; a wait on
a flag no earlier step set raises, so a plain replay whose work items come
out of order fails instead of reading a stale slot; the plain replays'
outputs are unchanged (``tests/test_torch_fused_schedule.py`` holds them
against the JAX oracle, ``tests/test_torch_ref.py`` against
``kernels/ref``).
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import primitives as jprim
from repro_torch import kernels as K
from repro_torch.core import BlockChannel, CommSpec
from repro_torch.core import primitives as prim
from repro_torch.kernels import ref
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
ORDERS = ("ring", "bidir_ring", "all2all")
PAPER = ("producer_tile_notify", "consumer_tile_wait", "peer_tile_notify", "peer_tile_wait", "tile_push_data")


def test_the_reference_names():
    """Every primitive of the reference but its DMA handle constructor is the port's."""
    assert set(jprim.__all__) - {"make_tile_push"} <= set(prim.__all__)
    assert prim.peer_tile_notify is prim.producer_tile_notify and prim.peer_tile_wait is prim.consumer_tile_wait


def test_notify_then_wait():
    board = prim.FlagBoard()
    prim.producer_tile_notify(board, ("ready", 0, 1))
    prim.consumer_tile_wait(board, ("ready", 0, 1))
    prim.peer_tile_notify(board, ("part", 2), value=3)
    prim.peer_tile_wait(board, ("part", 2), target=3)
    assert ("ready", 0, 1) in board and len(board) == 2 and board.value(("part", 2)) == 3


@pytest.mark.parametrize("key,target", [(("ready", 1, 0), 1), (("part", 2), 4)])
def test_wait_on_an_unset_flag_raises(key, target):
    board = prim.FlagBoard()
    prim.producer_tile_notify(board, ("part", 2), value=3)
    with pytest.raises(prim.ProtocolError, match="no earlier step set it"):
        prim.consumer_tile_wait(board, key, target=target)


def test_tile_push_data_copies_into_the_slot():
    slots = torch.zeros(2, 3, 4, dtype=torch.bfloat16)
    tile = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    prim.tile_push_data(slots, (1, slice(0, 2)), tile)
    assert torch.equal(slots[1, :2].float(), tile) and slots[0].abs().sum() == 0


@pytest.mark.parametrize("kernel", ["ag_gemm", "gemm_rs"])
@pytest.mark.parametrize("order", ORDERS)
def test_plain_replay_out_of_order_raises(kernel, order, monkeypatch):
    """Reversed work items put a wait before the set it needs: the replay
    itself raises (the plan is built, and verified, before the items are
    reversed)."""
    mod = sys.modules[f"repro_torch.kernels.{kernel}"]
    ch = BlockChannel(axis="model", num_channels=2, comm=CommSpec(order=order))
    rng = np.random.default_rng(0)
    if kernel == "ag_gemm":
        x, w = torch.from_numpy(rng.standard_normal((4, 2, 8, 16), dtype=np.float32)), torch.randn(4, 16, 24)
    else:
        x, w = torch.from_numpy(rng.standard_normal((4, 2, 16, 12), dtype=np.float32)), torch.randn(4, 12, 32)
    mod.launch_plan(x, w, ch)  # built and verified in order, then cached
    items = mod.work_items
    monkeypatch.setattr(mod, "work_items", lambda *a, **kw: items(*a, **kw)[::-1])
    with pytest.raises(prim.ProtocolError):
        getattr(K, f"{kernel}_plain")(x, w, channel=ch)


@pytest.mark.parametrize("kernel", ["ag_gemm", "gemm_rs"])
@pytest.mark.parametrize("nch", [1, 2])
def test_plain_replay_in_order_sets_every_flag(kernel, nch, monkeypatch):
    """In order, every wait finds its flag; the board ends with every set flag."""
    boards = []

    class Board(prim.FlagBoard):
        def __init__(self):
            super().__init__()
            boards.append(self)

    mod = sys.modules[f"repro_torch.kernels.{kernel}"]
    monkeypatch.setattr(mod, "FlagBoard", Board)
    ch = BlockChannel(axis="model", num_channels=nch)
    if kernel == "ag_gemm":
        x, w = torch.randn(4, 2, 8, 16), torch.randn(4, 16, 24)
        out = K.ag_gemm_plain(x, w, channel=ch)
        torch.testing.assert_close(out, ref.ag_gemm_ref(x, w), rtol=1e-5, atol=1e-5)
    else:
        x, w = torch.randn(4, 2, 16, 12), torch.randn(4, 12, 32)
        out = K.gemm_rs_plain(x, w, channel=ch)
        torch.testing.assert_close(out, ref.gemm_rs_ref(x, w), rtol=1e-5, atol=1e-5)
    plan, _ = mod.launch_plan(x, w, ch)
    shape = (2, x.shape[-2], x.shape[-1], w.shape[-1])
    sets = {f for it in mod.work_items(plan, shape) for f in it.sets}
    assert len(boards) == 1 and len(boards[0]) == len(sets)


# --- the device half's sources ----------------------------------------------------------------


def _source(name):
    return (CSRC / name).read_text()


def test_the_header_defines_every_primitive_and_its_forms():
    src = _source("tile_sync.cuh")
    for name in PAPER + ("consumer_tile_wait_thread", "consumer_tile_wait_synced", "producer_tile_notify_synced",
                         "peer_tile_wait_thread", "peer_tile_wait_synced", "peer_tile_notify_synced"):  # fmt: skip
        assert re.search(rf"\b{name}\(", src), name
    for old in ("tl_notify", "tl_wait_flag", "tl_push_rows"):
        assert not re.search(rf"\b{old}\b", src), old


@pytest.mark.parametrize("name", ["ag_gemm.cu", "gemm_rs.cu"])
def test_the_fused_kernels_flag_sites_call_the_primitives(name):
    """No raw acquire / release or spin in the fused kernels: every wait and
    notify is a primitive (the header's forms), on both routes."""
    src = _source(name)
    assert not re.search(r"ld\.acquire|st\.release|tl_ld_acquire|tl_st_release|__nanosleep", src)
    used = set(re.findall(r"\b((?:producer|consumer|peer)_tile_(?:notify|wait)(?:_thread|_synced)?)\(", src))
    assert {n for n in used if n.endswith("_synced")}, used  # the bf16 route's consumer warpgroups
    assert {n for n in used if not n.endswith(("_synced", "_thread"))}, used  # the float32 route's blocks
    if name == "ag_gemm.cu":
        assert "consumer_tile_wait_thread" in used  # the bf16 route's TMA producer warp
        # the generic-to-async-proxy fence after the producer's acquired flag, before the TMA reads, stays
        assert re.search(r"consumer_tile_wait_thread\(flag, e, t\.sys\);\s*\n\s*wg_fence_proxy_async\(\);", src)
