"""torch's intra-op thread count for the port's test modules under xdist.

Every xdist worker imports torch with an intra-op pool of one thread per
core, so W workers running port tests at once ask for W times the cores.
Each ``tests/test_torch_*.py`` module opts into :func:`torch_threads`
(``pytestmark = pytest.mark.usefixtures("torch_threads")``), which pins the
count to this worker's share of the cores for the module and restores the
previous count afterwards, so a JAX-package module that the same worker
runs next keeps torch's default.

The share is ``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT`` (at least 1);
without xdist (the variable unset) it is every core, torch's own default.
"""

from __future__ import annotations

import contextlib
import os

import pytest
import torch


def thread_share(cpus=None, workers=None) -> int:
    """One worker's share of the cores: ``cpus // workers``, at least 1."""
    if cpus is None:
        cpus = os.cpu_count() or 1
    if workers is None:
        workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    return max(1, int(cpus) // max(1, int(workers)))


@contextlib.contextmanager
def pinned_threads(n: int):
    """torch's intra-op thread count set to ``n`` inside, the previous count after."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield torch.get_num_threads()
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def torch_threads():
    """Pin torch's intra-op threads to :func:`thread_share` for one module."""
    with pinned_threads(thread_share()) as n:
        yield n


pytestmark = pytest.mark.usefixtures("torch_threads")


@pytest.mark.parametrize("cpus, workers, share", [(8, 6, 1), (8, 4, 2), (8, 1, 8), (32, 6, 5), (4, 8, 1), (1, 1, 1)])
def test_thread_share(cpus, workers, share):
    assert thread_share(cpus, workers) == share


def test_thread_share_reads_xdist(monkeypatch):
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "4")
    assert thread_share(8) == 2
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT")
    assert thread_share(8) == 8


def test_fixture_holds_the_share(torch_threads):
    assert torch.get_num_threads() == torch_threads == thread_share()


def test_pinned_threads_sets_and_restores():
    outer = torch.get_num_threads()
    other = 2 if outer == 1 else outer - 1
    with pinned_threads(other) as n:
        assert n == other == torch.get_num_threads()
    assert torch.get_num_threads() == outer
    with pytest.raises(RuntimeError):  # restored on an exception too
        with pinned_threads(other):
            raise RuntimeError("inside")
    assert torch.get_num_threads() == outer
