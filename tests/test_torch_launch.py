"""The port's dry-run path (``repro_torch.launch.{mesh,specs,dryrun,report}``,
``launch/roofline``, the ``World``'s transport counter) and ``attn_p_bf16``,
against the JAX package on the CPU.

* Collective bytes: ``ag_matmul`` / ``matmul_rs`` at W = 4 over the orders
  ring and bidir_ring at C in {1, 2}, float32: the reference's shard_map on
  ``mesh8`` is compiled (never executed: XLA's CPU collectives may deadlock,
  ROADMAP queue 3, F1) and its HLO parsed by
  ``repro.launch.roofline.parse_collective_bytes``; the port's counter over
  one eager run gives the same total and per-kind bytes, exactly.
* ``attn_p_bf16``: the port's and the reference's chunked attention with
  the flag agree within 2e-2 of max|ref| on the same seeded inputs; the
  port's attention layer with the flag differs from the layer without it;
  the fused backend's float32 route refuses the flag.
* The dry run on ``meta``: a train and a decode cell return status ``ok``
  with every key of the reference's result; a ``long_500k`` cell of a
  full-attention arch is skipped with the reference's reason; the
  temporaries' peak of 3 units equals the extrapolation from 1 and 2.
* FLOPs: the counted GEMM FLOPs of one dense layer are 2 M N K summed over
  its GEMMs, exactly, by ``FlopCounterMode`` and by the planner's meter; a reduced smollm train cell's FLOPs per device are
  printed against the reference's ``cost_analysis()["flops"]`` on
  ``mesh8`` and held within ``FLOPS_RATIO`` (measured: module constant).
"""

from __future__ import annotations

import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch.utils.flop_counter import FlopCounterMode

from repro.compat import shard_map
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs.base import Shape as JShape
from repro.core import BlockChannel as JChannel
from repro.core import CommSpec as JComm
from repro.core import CompSpec as JComp
from repro.core import compile_overlap as j_compile
from repro.launch import roofline as j_roofline
from repro.launch import specs as JS
from repro.launch.train import reduce_config as j_reduce_config
from repro.nn import attention as j_attention
from repro.parallel.context import ParallelContext as JPC
from repro.training.optimizer import AdamWConfig as JAdamW
from repro.training.optimizer import apply_update as j_apply_update
from repro.training.steps import softmax_xent as j_softmax_xent
from repro_torch.backend.mesh import CommCounter, World, permute_direction
from repro_torch.configs import Shape, get_config, reduce_config
from repro_torch.core import BlockChannel, CommSpec, CompSpec, compile_overlap
from repro_torch.kernels.flash_attention import chunked_attention
from repro_torch.launch import dryrun, report
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import Mesh, make_dev_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.nn import attention
from repro_torch.parallel.context import ParallelContext
from repro_torch.parallel.sharding import (Spec, data_dim, gather_data, map_specs, per_device_bytes, place, place_data,
                                           shardings_of, stacked)  # fmt: skip
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from test_torch_training import J_COMPILE

pytestmark = pytest.mark.usefixtures("torch_threads")

R_ = 4
# the port's per-device FLOPs of the reduced smollm train cell over the reference's cost_analysis: the
# port counts matmul FLOPs only (FlopCounterMode), XLA every elementwise op too, so the port's is lower;
# measured 0.7803 on this CPU build (jax 0.9.0, torch 2.13); the bound takes +-0.08 around it
FLOPS_RATIO = (0.70, 0.86)
# the reference's result keys (repro/launch/dryrun.py, the single-pod pass)
J_KEYS = {"arch", "shape", "multi_pod", "mode", "variant", "status", "n_chips", "lower_s", "compile_s", "memory",
          "cost", "collective_bytes", "collective_kinds", "roofline", "dominant", "model_flops",
          "useful_flops_ratio"}  # fmt: skip
J_MEMORY = {"temp_size_in_bytes", "argument_size_in_bytes", "output_size_in_bytes"}


# ---- the transport's counter against the reference's HLO --------------------------


def _reference_hlo(mesh, kind, order, nch):
    ch = JChannel(axis="model", num_channels=nch, comm=JComm(order=order), comp=JComp(accum_dtype="float32"))
    fn = j_compile(kind, ch)
    if kind == "ag_matmul":
        x, w = jnp.zeros((2, R_ * 8, 16)), jnp.zeros((16, R_ * 12))
        sm = shard_map(fn, mesh, in_specs=(P(None, "model", None), P(None, "model")), out_specs=P(None, None, "model"))
    else:
        x, w = jnp.zeros((2, R_ * 8, R_ * 8)), jnp.zeros((R_ * 8, 16))
        sm = shard_map(fn, mesh, in_specs=(P(None, None, "model"), P("model", None)), out_specs=P(None, "model", None))
    return jax.jit(sm).lower(x, w).compile(compiler_options=J_COMPILE).as_text()


@pytest.mark.parametrize("kind,order,nch", list(itertools.product(("ag_matmul", "matmul_rs"), ("ring", "bidir_ring"),
                                                                  (1, 2))))  # fmt: skip
def test_collective_bytes_match_parsed_hlo(mesh8, kind, order, nch):
    total, kinds = j_roofline.parse_collective_bytes(_reference_hlo(mesh8, kind, order, nch))
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order), comp=CompSpec(accum_dtype="float32"))
    world = World(R_, "cpu")
    if kind == "ag_matmul":
        x, w = torch.zeros(R_, 2, 8, 16), torch.zeros(R_, 16, 12)
    else:
        x, w = torch.zeros(R_, 2, R_ * 8, 8), torch.zeros(R_, 8, 16)
    with world.counting() as counter:
        compile_overlap(kind, ch, world=world, backend="eager")(x, w)
    got_total, got_kinds = R.collective_bytes(counter)
    assert got_total > 0 and (got_total, got_kinds) == (total, kinds)
    assert world.counter is None  # off again after the block


def test_counter_kinds_and_weights():
    """Each kind's payload and ring weight (parse_collective_bytes's), the
    permute direction vote, nothing recorded with the counter off."""
    world = World(4, "meta")
    xs = torch.empty((4, 8, 16), dtype=torch.bfloat16, device="meta")  # 256 B a rank
    world.permute(xs, [(i, (i + 1) % 4) for i in range(4)])
    assert world.counter is None
    with world.counting() as c:
        world.permute(xs, [(i, (i + 1) % 4) for i in range(4)])
        world.permute(xs, [(i, (i - 1) % 4) for i in range(4)])
        world.psum(xs)
        world.all_gather(xs, dim=0)
        world.reduce_scatter(xs, dim=0)
    assert {k: dict(v) for k, v in c.payload.items()} == {"permute": {4: 512}, "psum": {4: 256},
                                                          "all_gather": {4: 1024}, "reduce_scatter": {4: 64}}
    total, kinds = R.collective_bytes(c)
    assert kinds == {"collective-permute": 512.0, "all-reduce": 256 * 1.5, "all-gather": 1024 * 0.75,
                     "reduce-scatter": 64 * 3.0}  # fmt: skip
    assert total == 256 + 384 + 768 + 192
    assert permute_direction([(0, 1), (1, 2), (2, 3), (3, 0)]) == 1 == permute_direction([])
    assert permute_direction([(1, 0), (2, 1), (3, 2), (0, 3)]) == -1
    c.reset()
    assert R.collective_bytes(c) == (0.0, {}) and isinstance(c, CommCounter)


def test_data_axis_bytes_from_specs():
    """ZeRO-3 on a data axis of 4: a D-sharded leaf gathered per use (twice
    under remat) and its gradient reduce-scattered; a replicated one
    all-reduced; inference gathers only."""
    mesh = {"data": 4, "model": 2}
    bf16 = torch.bfloat16
    leaves = [((2, 64, 32), bf16, Spec("model", "data", None), 1, True), ((64,), bf16, Spec(None), 1, True)]
    stored = 16 * 32 * 2  # [64 / 4, 32] bf16 of one rank's [64, 32]
    total, kinds = R.data_axis_bytes(leaves, mesh, ("pod", "data"), train=True, recompute=True)
    assert kinds == {"all-gather": 2 * stored * 4 * 0.75, "reduce-scatter": stored * 3.0, "all-reduce": 128 * 1.5}
    assert total == sum(kinds.values())
    _, infer = R.data_axis_bytes(leaves, mesh, ("data",), train=False, recompute=True)
    assert infer == {"all-gather": stored * 4 * 0.75}
    assert R.data_axis_bytes(leaves, {"model": 2}, ("data",), train=True, recompute=False) == (0, {})


def test_roofline_terms_per_axis():
    terms = R.roofline_terms({"flops": 989e9, "bytes accessed": 3.35e9}, {"model": 450e6, "data": 50e6})
    assert terms["compute_s"] == pytest.approx(1e-3) and terms["memory_s"] == pytest.approx(1e-3)
    assert terms["collective_s"] == pytest.approx(2e-3) and terms["collective_bytes"] == 500e6
    dev = make_dev_mesh(4)
    terms = R.roofline_terms({"flops": 0.0}, {"model": 3.35e9}, link_bw=dict(dev.link_bw))
    assert terms["collective_s"] == pytest.approx(1e-3) and R.dominant(terms) == "collective_s"


# ---- meshes, contexts and specs -----------------------------------------------------


def test_meshes_and_the_data_axis_of_the_context():
    sp, mp = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert sp.shape == {"data": 32, "model": 8} and sp.size == 256
    assert mp.shape == {"pod": 2, "data": 32, "model": 8} and mp.size == 512
    assert dict(sp.link_bw) == {"data": 50e9, "model": 450e9}
    pc = sp.context("meta")
    assert (pc.tp, pc.dp, pc.dp_spec(), pc.backend) == (8, 32, "data", "eager")
    pcm = mp.context("meta")
    assert (pcm.dp, pcm.dp_spec()) == (64, ("pod", "data"))
    dev = make_dev_mesh(4)
    card = dev.context("cpu")
    assert (card.tp, card.dp, card.mesh_shape) == (4, 1, {"pod": 1, "data": 1, "model": 4})
    plain = ParallelContext(world=World(4, "cpu"))
    assert (plain.mesh_shape, plain.dp, plain.dp_spec(), plain.attn_p_bf16) == ({"model": 4}, 1, None, False)
    with pytest.raises(ValueError, match="model"):
        ParallelContext(world=World(4, "cpu"), mesh_axes={"data": 2, "model": 8})
    # the data axis: as many replicas as processes (the contexts that run them: test_torch_dist.py)
    assert make_dev_mesh(4, n_data=2).shape == {"pod": 1, "data": 2, "model": 4}
    with pytest.raises(ValueError, match="n_data"):
        make_dev_mesh(4, n_data=0)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-2.7b", "granite-moe-3b-a800m"])
def test_data_placement_round_trips_every_leaf(arch):
    """``place_data`` / ``gather_data`` over the data axes of a (1, 2, 4)
    mesh, the data transport an in-process World of the 2 replicas (its
    blocks stacked on dim 0): every leaf of the reduced tree goes to its
    replicas' blocks along the dim its spec names for the data axes, and
    back, bitwise; a leaf whose spec names no data axis stays whole."""
    cfg = reduce_config(get_config(arch))
    data = World(2, "cpu")
    pc = ParallelContext(world=World(4, "cpu"), mesh_axes=make_dev_mesh(4, 2).axes)
    assert pc.dp == 2 and pc.dp_spec() == ("pod", "data")
    params = lm.init(cfg, pc.world, torch.Generator().manual_seed(0), torch.float32)
    split = []

    def trip(spec, x):
        d = data_dim(spec, pc.dp_axes)
        blocks = place_data(x, spec, data, pc.dp_axes)
        if d is None:
            assert blocks is x
        else:
            split.append(spec)
            assert blocks.shape == (2,) + x.shape[:d] + (x.shape[d] // 2,) + x.shape[d + 1 :]
            assert torch.equal(blocks[1], x.narrow(d, x.shape[d] // 2, x.shape[d] // 2))
        assert torch.equal(gather_data(blocks, spec, data, pc.dp_axes), x)

    map_specs(trip, lm.specs(cfg, pc), params)
    whole = []
    map_specs(lambda s: whole.append(s) if data_dim(s, pc.dp_axes) is None else None, lm.specs(cfg, pc))
    assert split and whole  # the norms (and the router) stay whole


def test_data_placement_refuses_what_does_not_divide():
    data = World(2, "cpu")
    with pytest.raises(ValueError, match="does not divide"):
        place_data(torch.zeros(4, 5), Spec(None, ("pod", "data")), data)
    with pytest.raises(ValueError, match="more than one dim"):
        data_dim(Spec("data", "pod"))
    assert place_data(torch.zeros(4, 5), Spec("model", None), data).shape == (4, 5)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 16, 32])
def test_dev_mesh_and_elastic_build_give_the_reference_plan(n, tmp_path):
    """``ElasticMesh.build`` lays the reference's ``plan`` out as a (pod, data,
    model) mesh, the model factor's world; ``make_dev_mesh(model, data)`` is
    the card's; a context with a data transport of another size than the
    mesh's data factors raises."""
    from repro.runtime import ElasticMesh as JElasticMesh
    from repro_torch.runtime import ElasticMesh

    for target in (2, 4, 16):
        ref = JElasticMesh(target_model=target).plan(n)
        b = ElasticMesh(target_model=target).build(n, "cpu")
        assert b.mesh.shape == ref and b.usable == ref["pod"] * ref["data"] * ref["model"]
        assert b.world.size == ref["model"] and b.context is None
        assert make_dev_mesh(ref["model"], ref["pod"] * ref["data"]).shape == {
            "pod": 1, "data": ref["pod"] * ref["data"], "model": ref["model"]}  # fmt: skip
    with pytest.raises(ValueError, match="data transport has 2"):
        ParallelContext(world=World(4, "cpu"), mesh_axes=make_dev_mesh(4, 4).axes, data=World(2, "cpu"))
    ctx = ParallelContext(world=World(4, "cpu"), data=World(2, "cpu"))
    assert (ctx.dp, ctx.mesh_shape) == (2, {"data": 2, "model": 4})
    b = ElasticMesh(target_model=4).build(8, "cpu", data=World(2, "cpu"))  # plan (2, 1, 4): pod x data = 2 replicas
    assert (b.context.dp, b.context.mesh_shape, b.context.tp) == (2, {"pod": 2, "data": 1, "model": 4}, 4)


def test_place_and_per_device_bytes():
    world = World(4, "cpu")
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    cols = place(x, Spec(("pod", "data"), "model"), world)
    assert torch.equal(cols, x.reshape(8, 4, 3).permute(1, 0, 2))
    assert stacked(Spec(("pod", "data"), "model")) == Spec("model", ("pod", "data"), None)
    rows = place(x, Spec("model", None), world)
    assert torch.equal(rows, x.reshape(4, 2, 12)) and stacked(Spec("model", "data")) == Spec("model", None, "data")
    assert place(x, Spec(None, None), world) is x
    mesh = {"pod": 1, "data": 2, "model": 4}
    assert per_device_bytes((4, 8, 12), torch.bfloat16, Spec("model", ("pod", "data"), None), mesh) == 4 * 12 * 2
    assert per_device_bytes((5,), torch.float32, Spec("data"), mesh) == 3 * 4  # rounded up
    sh = shardings_of(mesh, {"w": Spec("model", None), "b": [Spec(None)]})
    assert sh["w"].shard_shape((8, 12)) == (2, 12) and sh["b"][0].nbytes((6,), torch.bfloat16) == 12


def test_meta_device_only_by_name():
    assert World(2, "meta").device.type == "meta"
    with pytest.raises(ValueError):
        World(2, "xpu")


# ---- attn_p_bf16 ------------------------------------------------------------------------


def test_attn_p_bf16_matches_reference_and_is_not_a_noop():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((2, 4, 128, 32), (2, 2, 128, 32), (2, 2, 128, 32)))
    ref = np.asarray(j_attention.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                                   chunk=64, p_bf16=True))  # fmt: skip
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = chunked_attention(tq, tk, tv, causal=True, chunk=64, p_bf16=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2 * np.abs(ref).max())
    assert not np.array_equal(got, chunked_attention(tq, tk, tv, causal=True, chunk=64).numpy())

    # the layer: the flag reaches the eager route's attention
    cfg = reduce_config(get_config("smollm-360m"))
    world = World(4, "cpu")
    params = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)["layers"][0]["mixer"]
    x = torch.from_numpy(rng.standard_normal((4, 2, 16, cfg.d_model)).astype(np.float32))
    outs = [attention.apply_seq(params, x, ParallelContext(world=world, attn_p_bf16=f), cfg) for f in (False, True)]
    assert not torch.equal(*outs) and torch.allclose(*outs, atol=2e-2 * outs[0].abs().max().item())
    # the fused backend: the float32 FMA route keeps P in float32 and refuses the flag
    with pytest.raises(NotImplementedError, match="FMA"):
        attention.apply_seq(params, x, ParallelContext(world=world, backend="fused", attn_p_bf16=True), cfg)


# ---- the dry run ----------------------------------------------------------------------------


def test_run_cell_train_decode_and_skip(capsys):
    res = dryrun.run_cell("smollm-360m", "train_4k")
    assert res["status"] == "ok" and J_KEYS <= set(res) and J_MEMORY <= set(res["memory"])
    assert res["n_chips"] == 256 and res["collective_axes"]["model"] > 0 and res["collective_axes"]["data"] > 0
    assert res["cost"]["n_units"] == 32 and res["fits"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["status"] == "ok"
    dec = dryrun.run_cell("mamba2-2.7b", "decode_32k", verbose=False)
    assert dec["status"] == "ok" and J_KEYS <= set(dec)
    skip = dryrun.run_cell("qwen2-72b", "long_500k", verbose=False)
    assert skip == {"arch": "qwen2-72b", "shape": "long_500k", "multi_pod": False, "mode": "overlap",
                    "status": "skipped",
                    "reason": JS.cell_is_applicable(j_get_config("qwen2-72b"), J_SHAPES["long_500k"])[1]}  # fmt: skip
    mp = dryrun.run_cell("smollm-360m", "train_4k", multi_pod=True, extrapolate=False, verbose=False)
    assert mp["status"] == "ok" and mp["extrapolated"] is False and mp["n_chips"] == 512 and "cost" not in mp
    table = report.table([res, dec, skip, mp])
    assert "| smollm-360m | train_4k |" in table and "| qwen2-72b | long_500k | — |" in table
    assert table.splitlines()[-1].startswith("2 baselined cells, 1 skipped")


def test_temporaries_extrapolate_linearly():
    """The peak of live bytes at 3 units equals c1 + 2 (c2 - c1) (train
    with remat, and a prefill), so extrapolating it is exact."""
    cfg = reduce_config(get_config("smollm-360m"))
    mesh = make_dev_mesh(4)
    pc = mesh.context("meta", backend="eager")
    for shape, remat in ((Shape("t", 64, 4, "train"), "dots"), (Shape("p", 64, 2, "prefill"), "none")):
        c = [dryrun._measure(dataclasses.replace(cfg, n_layers=u), shape, pc, remat, count_cost=False)["temp"]
             for u in (1, 2, 3)]  # fmt: skip
        assert c[2] == c[0] + 2 * (c[1] - c[0]) and c[1] > c[0], (shape, c)


def _gemm_flops(cfg, w, b, s):
    """2 M N K over one dense layer's GEMMs (the eager path, W ranks):
    qkv, Q K^T and P V (one causal chunk), the output projection, gate|up
    and down."""
    lay = attention.layout(cfg, w)
    hd, d, f = cfg.hd, cfg.d_model, cfg.d_ff
    m = b * s
    qkv = 2 * m * d * (lay.h_loc + 2 * lay.kv_loc) * hd * w
    attn = 2 * (2 * b * lay.h_loc * s * s * hd) * w
    out = 2 * m * lay.h_loc * hd * d * w
    mlp = 2 * m * d * 2 * (f // w) * w + 2 * m * (f // w) * d * w
    return qkv + attn + out + mlp


def test_layer_gemm_flops_exact():
    cfg = reduce_config(get_config("smollm-360m"))
    world = World(4, "meta")
    pc = ParallelContext(world=world)
    params = lm.init(cfg, world, None, torch.bfloat16)
    b, s = 2, 64
    x = torch.empty((4, b, s // 4, cfg.d_model), dtype=torch.bfloat16, device="meta")
    meter = dryrun.StepMeter()
    with FlopCounterMode(display=False) as fc, meter:
        lm.layer_plan(cfg)[0].apply_seq(params["layers"][0], x, pc, cfg)
    assert fc.get_total_flops() == meter.flops == _gemm_flops(cfg, 4, b, s)


def test_train_flops_against_reference_cost_analysis(mesh8):
    """A reduced smollm train cell (4 x 64 tokens, remat "none") on mesh8's
    shape (pod 1, data 2, model 4): per-device FLOPs, the port's
    FlopCounterMode count against the reference's compiled cost_analysis."""
    shape = Shape("train_small", 64, 4, "train")
    jcfg = j_reduce_config(j_get_config("smollm-360m"))
    jpc = JPC(mesh=mesh8)
    params, pspecs = JS.abstract_params(jcfg, jpc)
    inputs, ispecs = JS.input_specs(jcfg, JShape("train_small", 64, 4, "train"), jpc)
    opt, ospecs = JS.abstract_opt_state(params, pspecs)
    from repro.models import lm as jlm

    def train_step(p, o, batch):
        def loss_fn(pp):
            logits, aux = jlm.forward(pp, jcfg, jpc, batch["inputs"], remat_policy="none", unroll=True)
            return j_softmax_xent(logits, batch["labels"]) + 0.01 * aux

        loss, grads = jax.value_and_grad(loss_fn)(p)
        p2, o2, _ = j_apply_update(p, grads, o, JAdamW())
        return p2, o2, loss

    def sh(tree):
        return jax.tree_util.tree_map(lambda s: NamedSharding(mesh8, s), tree, is_leaf=lambda v: isinstance(v, P))

    jitted = jax.jit(train_step, in_shardings=(sh(pspecs), sh(ospecs), sh(ispecs)))
    cost = jitted.lower(params, opt, inputs).compile(compiler_options=J_COMPILE).cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    j_flops = float(cost["flops"])
    mesh = Mesh((("pod", 1), ("data", 2), ("model", 4)), (("pod", 50e9), ("data", 50e9), ("model", 450e9)))
    res = dryrun.run_cell(reduce_config(get_config("smollm-360m")), shape, remat="none", mesh=mesh, verbose=False)
    ratio = res["cost"]["flops"] / j_flops
    print(f"reduced smollm train 4 x 64 on (1, 2, 4): port {res['cost']['flops']:.6g} FLOPs per device, "
          f"reference cost_analysis {j_flops:.6g}, ratio {ratio:.4f}")  # fmt: skip
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1]


def test_cli_one_cell(capsys, tmp_path):
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["status"] == "ok" and line["arch"] == "smollm-360m"
    (tmp_path / "a.json").write_text(json.dumps(line))
    report.main(["--dir", str(tmp_path)])
    assert "| smollm-360m | decode_32k |" in capsys.readouterr().out
