"""ZeRO-3 use-time gathering (``parallel/sharding.use_gather``,
``ParallelContext.use_gather``) over the in-process World of the data axes,
in one process; the models under it run in ``tests/test_torch_dist.py``'s
replica processes.

Held:
  * the gathered leaves equal ``gather_data`` of the blocks on every
    replica, and a leaf whose spec names no data axis passes through as the
    same object; without a data transport the tree itself comes back;
  * the backward equals autograd through a plain gather (each replica's
    concatenation of the blocks) in float64: the reduce-scatter of the
    replicas' whole gradients onto the blocks;
  * one all-gather per dtype per use in the forward and one reduce-scatter
    per dtype in the backward (the calls counted on the World, the payload
    by ``CommCounter`` against the leaves' bytes);
  * a tree whose keys differ from its specs' raises;
  * the helpers that act on a data-parallel step's gradients and parameters
    act on each replica's blocks as on the whole leaves, sliced to the
    block: the kv-copy sync (``lm.sync_grads`` mixes dims 0 and 2 of
    ``wqkv``, the data axes split dim 1), the padded-head masks ([W, 1,
    cols] broadcasts over the data dim), the weight-decay mask (by name),
    and ``with_tied`` (``embed`` split on D, dim 2, ``head`` on D, dim 0:
    the tied head of an embedding block is the head's block);
  * ``data_axis_bytes``'s optional per-leaf flag: a leaf outside every
    remat'd body is gathered once even under ``recompute``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import lm
from repro_torch.nn import attention
from repro_torch.parallel.context import ParallelContext
from repro_torch.parallel.sharding import Spec, data_dim, gather_data, map_specs, place_data, use_gather
from repro_torch.training import optimizer as topt
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

D, TP = 2, 4
AXES = ("pod", "data")
SPECS = {"a": Spec("model", AXES, None), "b": Spec(AXES, None), "c": Spec(None, AXES), "n": Spec(None),
         "e": {"w": Spec("model", None, AXES), "v": Spec("model", None)}}  # fmt: skip
SHAPES = {"a": (4, 6, 5), "b": (8, 3), "c": (3, 4), "n": (5,), "e": {"w": (4, 3, 6), "v": (4, 2)}}
DTYPES = {"a": torch.float64, "b": torch.float64, "c": torch.float32, "n": torch.float64,
          "e": {"w": torch.float32, "v": torch.float64}}  # fmt: skip


class _Calls(World):
    """An in-process World that counts its all-gather and reduce-scatter calls."""

    def __init__(self, size):
        super().__init__(size, "cpu")
        self.calls = {"all_gather": [], "reduce_scatter": []}

    def all_gather(self, xs, dim):
        self.calls["all_gather"].append(xs.dtype)
        return super().all_gather(xs, dim)

    def reduce_scatter(self, xs, dim):
        self.calls["reduce_scatter"].append(xs.dtype)
        return super().reduce_scatter(xs, dim)


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return map_specs(lambda s, shape, dt: torch.from_numpy(rng.standard_normal(shape)).to(dt), SPECS, SHAPES, DTYPES)


def _blocks(data, leaves):
    return map_specs(lambda s, t: place_data(t, s, data, AXES).requires_grad_(True), SPECS, leaves)


def _pairs(tree):
    """(spec, leaf) of a tree of SPECS' structure."""
    out = []
    map_specs(lambda s, t: out.append((s, t)), SPECS, tree)
    return out


def test_use_gather_forward_is_gather_data_one_all_gather_per_dtype():
    data = _Calls(D)
    leaves = _leaves()
    blocks = _blocks(data, leaves)
    with data.counting() as counter:
        out = use_gather(blocks, SPECS, data, AXES)
    assert list(out) == list(blocks) and list(out["e"]) == list(blocks["e"])  # the tree's own order
    for (spec, got), (_, b), (_, whole) in zip(_pairs(out), _pairs(blocks), _pairs(leaves)):
        if data_dim(spec, AXES) is None:
            assert got is b  # untouched
            continue
        assert got.shape == (D,) + whole.shape and got.is_contiguous()
        for r in range(D):
            assert torch.equal(got[r], gather_data(b.detach(), spec, data, AXES))
            assert torch.equal(got[r], whole)
    assert data.calls == {"all_gather": [torch.float64, torch.float32], "reduce_scatter": []}
    split = sum(t.numel() * t.element_size() for s, t in _pairs(leaves) if data_dim(s, AXES) is not None)
    assert dict(counter.payload["all_gather"]) == {D: split}  # each replica receives the whole leaves
    assert use_gather(blocks, SPECS, None, AXES) is blocks
    assert ParallelContext(world=World(TP, "cpu")).use_gather(blocks, SPECS) is blocks


def test_use_gather_backward_is_the_plain_gathers_transpose():
    data = _Calls(D)
    blocks = _blocks(data, _leaves())
    plain = map_specs(lambda s, b: b.detach().clone().requires_grad_(True), SPECS, blocks)
    rng = np.random.default_rng(1)
    out = use_gather(blocks, SPECS, data, AXES)
    cot = [torch.from_numpy(rng.standard_normal(t.shape)).to(t.dtype) for _, t in _pairs(out)]

    def gathered(spec, b):  # each replica's concatenation of the blocks, through autograd's own ops
        d = data_dim(spec, AXES)
        if d is None:
            return b
        whole = torch.cat(list(b.unbind(0)), dim=d)
        return whole.unsqueeze(0).expand((D,) + tuple(whole.shape))

    ref = [gathered(s, b) for s, b in _pairs(plain)]
    loss = sum((t * c).sum() for (_, t), c in zip(_pairs(out), cot))
    with data.counting() as counter:
        got = torch.autograd.grad(loss, [b for _, b in _pairs(blocks)])
    want = torch.autograd.grad(sum((t * c).sum() for t, c in zip(ref, cot)), [b for _, b in _pairs(plain)])
    for (spec, b), g, w in zip(_pairs(blocks), got, want):
        assert g.shape == b.shape and g.dtype == b.dtype
        assert torch.allclose(g, w, rtol=1e-12 if g.dtype == torch.float64 else 1e-6, atol=0), spec
    assert data.calls["reduce_scatter"] == [torch.float64, torch.float32]
    split = sum(b.numel() // D * b.element_size() for s, b in _pairs(blocks) if data_dim(s, AXES) is not None)
    assert dict(counter.payload["reduce_scatter"]) == {D: split}  # each replica's blocks


def test_use_gather_refuses_a_tree_unlike_its_specs():
    data = World(D, "cpu")
    blocks = _blocks(data, _leaves())
    with pytest.raises(ValueError, match="keys"):
        use_gather({**blocks, "x": blocks["n"]}, SPECS, data, AXES)
    with pytest.raises(ValueError, match="subtrees"):
        use_gather([blocks["a"]], [SPECS["a"], SPECS["b"]], data, AXES)


def _smollm(tie=True, **kw):
    cfg = dataclasses.replace(reduce_config(get_config("smollm-360m")), vocab_size=256, tie_embeddings=tie, **kw)
    world = World(TP, "cpu")
    params = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    pc = ParallelContext(world=world, backend="eager", mesh_axes=make_dev_mesh(TP, D).axes, data=World(D, "cpu"))
    return cfg, pc, params


def _replica(pc, spec, whole, r):
    """Replica r's block of a whole leaf (the leaf where the data axes do not split it)."""
    return whole if data_dim(spec, pc.dp_axes) is None else place_data(whole, spec, pc.data, pc.dp_axes)[r]


@pytest.mark.parametrize("helper", ["sync_grads", "grad_masks", "decay_mask", "with_tied"])
def test_step_helpers_act_on_blocks_as_on_whole_leaves(helper):
    """Each helper on replica r's blocks equals replica r's block of it on
    the whole leaves (reduced smollm at TP 4 with 6 heads, 2 kv heads: the
    kv copies synced and the padded heads masked)."""
    cfg, pc, params = _smollm(n_heads=6, n_kv_heads=2)
    specs = lm.trainable(lm.specs(cfg, pc), cfg)
    rng = np.random.default_rng(2)
    grads = topt.tree_map(lambda t: torch.from_numpy(rng.standard_normal(t.shape)).to(t.dtype), lm.trainable(params, cfg))
    fns = {
        "sync_grads": lambda t: lm.sync_grads(t, cfg, pc),
        "grad_masks": lambda t: topt.apply_masks(t, lm.grad_masks(cfg, pc)),
        "decay_mask": lambda t: lm.decay_mask(t, cfg),
    }  # fmt: skip
    assert lm.grad_masks(cfg, pc)["layers"][0] is not None  # padded heads: the masks act
    assert attention.layout(cfg, pc.tp).rep > 1  # kv copies: the sync acts
    for r in range(D):
        blocks = map_specs(lambda s, t: _replica(pc, s, t, r), specs, grads)
        if helper == "with_tied":
            got = lm.with_tied(map_specs(lambda s, t: _replica(pc, s, t, r), specs, lm.trainable(params, cfg)), cfg)
            head = lm.with_tied(lm.trainable(params, cfg), cfg)["head"]
            assert torch.equal(got["head"], _replica(pc, lm.specs(cfg, pc)["head"], head, r))
            continue
        got, whole = fns[helper](blocks), fns[helper](grads)
        want = whole if helper == "decay_mask" else map_specs(lambda s, t: _replica(pc, s, t, r), specs, whole)
        for a, b in zip(topt.tree_leaves(got), topt.tree_leaves(want)):
            assert (a == b) if isinstance(a, bool) else torch.equal(a, b)
        if helper != "decay_mask":
            assert any(not torch.equal(a, b) for a, b in zip(topt.tree_leaves(got), topt.tree_leaves(blocks)))


def test_data_axis_bytes_leaves_outside_the_remat_gather_once():
    """A leaf flagged as outside every remat'd body is gathered once under
    ``recompute``; a 5-tuple leaf is regathered, as before."""
    mesh = {"data": 2, "model": 1}
    leaf = ((64, 32), torch.float32, Spec(("pod", "data"), None), 1, True)
    stored = 32 * 32 * 4
    _, inside = R.data_axis_bytes([leaf], mesh, AXES, train=True, recompute=True)
    _, flagged = R.data_axis_bytes([leaf + (True,)], mesh, AXES, train=True, recompute=True)
    _, outside = R.data_axis_bytes([leaf + (False,)], mesh, AXES, train=True, recompute=True)
    assert inside == flagged == {"all-gather": 2 * stored * 2 * 0.5, "reduce-scatter": stored * 1.0}
    assert outside == {"all-gather": stored * 2 * 0.5, "reduce-scatter": stored * 1.0}
