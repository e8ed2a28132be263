"""The data axes over ``torch.distributed``: ``backend/mesh.DistWorld``, the
data-parallel train step and ``psum_compressed``, on the CPU with gloo.

Each multi-process test spawns two replica processes through
``launch/train.run_replicas`` (the ``spawn`` start method, a file store
under the test's temporary directory, torch at one thread a process); the
workers below are module-level functions so the processes can import them,
and the module imports JAX only inside the tests that hold the port
against the reference, so a replica process does not.

Held:
  * ``DistWorld``'s ``psum`` / ``pmax`` / ``all_gather`` / ``reduce_scatter``
    / ``permute`` / ``shard`` / ``unshard`` and their ``CommCounter`` payloads
    against the in-process ``World`` on the same seeded numpy data
    (bitwise: a sum of two float32 values has one rounding either way);
  * ``psum_compressed`` over the data group against the reference's under
    ``shard_map`` over ``"data"`` of the (1, 2, 4) mesh, compiled with
    ``J_COMPILE`` (1e-6 of max: the same float32 operations);
  * the ZeRO-3 step (each replica stores its blocks, ``use_gather`` at
    every layer's use): reduced smollm-360m at D = 2 x W = 4, float32, three
    AdamW steps, against the reference's ``make_train_step`` on that mesh
    (``pc8``) and against the port's D = 1 step, under
    ``test_torch_training``'s bounds (parameters and moments 1e-5 + 1e-4
    |ref|, loss / ce / grad_norm 1e-5 relative, lr 1e-7), on an unmasked
    and a masked batch (the masked mean divides by the global count);
  * reduced mamba2-2.7b and reduced granite-moe-3b-a800m (capacity and
    routing per row, as ``jax.vmap(route)`` in the reference: a replica's
    rows route as they do in the whole batch), smollm with fused seams,
    smollm under remat "dots" and a reduced seamless-m4t-medium (encoder
    frames in the batch) at D = 2 against D = 1, one step, the same bounds;
  * the parameters and moments each replica holds after its steps: every
    leaf ``place_data``'s block; the prefill logits and the eval ce from the
    blocks bitwise equal to D = 1's;
  * the data transport's payload of a step against
    ``launch/roofline.data_axis_bytes`` of the leaves the step gathers
    (``launch/dryrun.data_leaves``: each once a pass, again under remat),
    every kind exactly, on the (pod 1, data 2, model 1) mesh: one replica
    process holds its whole model group, so it moves what one device of
    that mesh does;
  * the train CLI at ``--data 2``: checkpoints resumed at D = 2 and at D = 1,
    each resumed loss bitwise equal to the uninterrupted run's at the same
    D, and across D within the steps' bound (summation order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.backend.mesh import CommCounter, DistWorld, World
from repro_torch.configs import get_config, reduce_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as R
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import encdec, lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.parallel.sharding import data_dim, gather_data, map_specs, place_data
from repro_torch.training import AdamWConfig, init_opt_state, make_eval_step, make_train_step
from repro_torch.training.compression import psum_compressed
from repro_torch.training import optimizer as topt
from repro_torch.training.steps import data_blocks, gather_blocks
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

D, TP = 2, 4
B, S, VOCAB = 4, 32, 256
STEP_OPT = dict(lr=1e-2, warmup_steps=2, total_steps=5, eps=1e-4, weight_decay=1.0)  # test_torch_training's
TOL = dict(atol=1e-5, rtol=1e-4)


def _rng_data(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# ---- the collectives ----------------------------------------------------------------------


def _collectives_worker(data: DistWorld, shapes: dict):
    """Every collective on this rank's share of seeded global data, counted."""
    r = data.rank
    x = _rng_data(0, (D,) + shapes["x"])[r]  # this rank's value of a rank-stacked [D, ...] tensor
    g = _rng_data(1, (D,) + shapes["g"])[r]
    err = _rng_data(2, (D,) + shapes["g"])[r] * 1e-3
    with data.counting() as c:
        out = {
            "psum": data.psum(x), "pmax": data.pmax(x),
            "all_gather": data.all_gather(x, 1), "reduce_scatter": data.reduce_scatter(x, 1),
            "permute": data.permute(x, [(0, 1), (1, 0)]), "permute_half": data.permute(x, [(0, 1)]),
            "psum_int": data.psum((x * 100).to(torch.int32)),
            "shard": data.shard(_rng_data(3, shapes["x"]), 1),
        }  # fmt: skip
    out["unshard"] = data.unshard(out["shard"], 1)
    out["payload"] = {k: dict(v) for k, v in c.payload.items()}
    out["dirs"] = dict(c.permute_dirs)
    out["compressed"] = psum_compressed(g, err, data)
    return out


def _inprocess_collectives(shapes):
    """The same on the in-process World of D ranks (rank-stacked)."""
    w = World(D, "cpu")
    xs = _rng_data(0, (D,) + shapes["x"])
    with w.counting() as c:
        out = {
            "psum": w.psum(xs), "all_gather": w.all_gather(xs, 1), "reduce_scatter": w.reduce_scatter(xs, 1),
            "permute": w.permute(xs, [(0, 1), (1, 0)]), "psum_int": w.psum((xs * 100).to(torch.int32)),
        }  # fmt: skip
    return out, c, xs


def test_dist_world_collectives_and_psum_compressed_match(mesh8):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import backend as jbackend
    from repro.training.compression import psum_compressed as j_psum_compressed
    from test_torch_training import J_COMPILE

    shapes = {"x": (3, 8, 5), "g": (6, 7)}
    got = train_cli.run_replicas(_collectives_worker, D, device="cpu", args=(shapes,))
    ref, counter, xs = _inprocess_collectives(shapes)
    for r, out in enumerate(got):
        assert torch.equal(out["psum"], ref["psum"]) and torch.equal(out["psum_int"], ref["psum_int"])
        assert torch.equal(out["pmax"], xs.max(0).values)
        assert torch.equal(out["all_gather"], ref["all_gather"][r])
        assert torch.equal(out["reduce_scatter"], ref["reduce_scatter"][r])
        assert torch.equal(out["permute"], ref["permute"][r])
        assert torch.equal(out["permute_half"], xs[0] if r == 1 else torch.zeros_like(xs[0]))  # no source: zeros
        assert torch.equal(out["shard"], World(D, "cpu").shard(_rng_data(3, shapes["x"]), 1)[r])
        assert torch.equal(out["unshard"], _rng_data(3, shapes["x"]))
        # payload bytes per rank by kind and group: the in-process World's on the same collectives, plus the
        # pmax (an all-reduce) and the one-pair permute
        want = {k: dict(v) for k, v in counter.payload.items()}
        nbytes = xs[0].numel() * 4
        want["psum"][D] += nbytes
        want["permute"][D] += nbytes
        assert out["payload"] == want
        assert out["dirs"] == {1: 2 * nbytes}  # both permutes' votes tie or lean +1
    # psum_compressed: the reference's under shard_map over "data" of the (1, 2, 4) mesh
    g = np.stack([_rng_data(1, (D,) + shapes["g"])[r].numpy() for r in range(D)])
    err = np.stack([(_rng_data(2, (D,) + shapes["g"])[r] * 1e-3).numpy() for r in range(D)])
    fn = jbackend.shard_map(lambda a, b: tuple(t[None] for t in j_psum_compressed(a[0], b[0], "data")), mesh8,
                            in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")))  # fmt: skip
    mean, new_err = jax.jit(fn).lower(jnp.asarray(g), jnp.asarray(err)).compile(compiler_options=J_COMPILE)(
        jnp.asarray(g), jnp.asarray(err)
    )
    for r, out in enumerate(got):
        m, e = out["compressed"]
        np.testing.assert_allclose(m.numpy(), np.asarray(mean)[r], rtol=0, atol=1e-6 * np.abs(np.asarray(mean)).max())
        np.testing.assert_allclose(e.numpy(), np.asarray(new_err)[r], rtol=0, atol=1e-6 * np.abs(g).max())
    np.testing.assert_array_equal(got[0]["compressed"][0].numpy(), got[1]["compressed"][0].numpy())  # replicated


def test_dist_world_refuses_what_it_cannot_run(tmp_path):
    """An unknown backend, and host staging where no CUDA tensor crosses gloo,
    raise before any group is joined; so does a staging table missing a kind."""
    kw = dict(init_file=str(tmp_path / "store"), device="cpu")
    with pytest.raises(ValueError, match="gloo' or 'nccl"):
        DistWorld(1, 0, backend="mpi", **kw)
    with pytest.raises(ValueError, match="host staging"):
        DistWorld(1, 0, backend="gloo", staging="host", **kw)
    with pytest.raises(ValueError, match="staging must give"):
        DistWorld(1, 0, backend="gloo", staging={"psum": "direct"}, **kw)
    with pytest.raises(ValueError, match="outside"):
        DistWorld(2, 2, backend="gloo", **kw)
    assert train_cli.staging_for("gloo", "cpu") is None and train_cli.staging_for("nccl", "cpu") is None


# ---- the data-parallel train step ---------------------------------------------------------


def _context(cfg, data, fuse_seams=False):
    return ParallelContext(world=World(TP, "cpu"), backend="eager", mesh_axes=make_dev_mesh(TP, D).axes, data=data,
                           fuse_seams=fuse_seams)  # fmt: skip


def _mod(job):
    """A job's model module (named, so the job pickles into the replica processes)."""
    return {"lm": lm, "encdec": encdec}[job.get("mod", "lm")]


def _local(batch, rank):
    """This replica's rows of a global batch."""
    rows = batch["inputs"].shape[0] // D
    return {k: v[rank * rows : (rank + 1) * rows] for k, v in batch.items()}


def _step_worker(data: DistWorld, jobs: dict):
    """Each job's steps at D = 2 (ZeRO-3: this replica's blocks of the
    parameters and moments) on this replica's rows of each global batch:
    metrics, the parameters after them gathered whole (rank 0's), this
    replica's moment blocks, the shapes of every leaf it holds after the
    steps, the data transport's payload of the first step, and for a job
    with ``prefill`` the prefill logits and eval ce from the blocks before
    the steps."""
    out = {}
    for name, job in jobs.items():
        cfg, mod, remat = job["cfg"], _mod(job), job.get("remat", "none")
        pc = _context(cfg, data, job.get("fuse_seams", False))
        step = make_train_step(mod, cfg, pc, AdamWConfig(**STEP_OPT), remat_policy=remat,
                               grad_masks=mod.grad_masks(cfg, pc))  # fmt: skip
        opt = init_opt_state(data_blocks(mod, cfg, pc, mod.trainable(job["params"], cfg)))
        params = mod.with_tied(data_blocks(mod, cfg, pc, mod.trainable(job["params"], cfg)), cfg)
        res = {}
        if job.get("prefill"):
            local = _local(job["batches"][0], data.rank)
            with torch.no_grad():
                res["prefill"] = lm.prefill(params, cfg, pc, torch.as_tensor(local["inputs"]).long(), max_len=S)[0]
            res["eval"] = float(make_eval_step(lm, cfg, pc)(params, local))
        metrics, payload = [], None
        for batch in job["batches"]:
            counter = CommCounter()
            with data.counting(counter):
                params, opt, m = step(params, opt, _local(batch, data.rank))
            payload = payload or {k: float(sum(v.values())) for k, v in counter.payload.items() if v}
            metrics.append({k: float(v) for k, v in m.items()})
        res["shapes"] = {"params": [tuple(t.shape) for t in topt.tree_leaves(params)],
                         **{k: [tuple(t.shape) for t in topt.tree_leaves(opt[k])] for k in ("mu", "nu")}}  # fmt: skip
        whole = mod.with_tied(gather_blocks(mod, cfg, pc, mod.trainable(params, cfg)), cfg)
        out[name] = {**res, "metrics": metrics, "params": whole if data.rank == 0 else None, "opt": opt,
                     "payload": payload}  # fmt: skip
    return out


def _jobs(jpc):
    """The models' inputs: reduced configs, seeded weights (smollm's from
    the JAX package's init on ``jpc``, with drawn norm gains), global
    batches; smollm's also with fused seams and under remat "dots"."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.models import lm as jlm
    from repro_torch.convert import from_jax_params
    from test_torch_training import _np, _with_gains
    from utils import reduce_config as j_reduce_config

    base = dict(n_layers=2, vocab_size=VOCAB, n_kv_heads=4)
    jcfg = dataclasses.replace(j_reduce_config(j_get_config("smollm-360m")), **base)
    cfg = dataclasses.replace(reduce_config(get_config("smollm-360m")), **base)
    np_params = _with_gains(_np(jlm.init(jax.random.PRNGKey(0), jcfg, jpc, jnp.float32)))
    pipe = SyntheticLM(vocab_size=VOCAB, seq_len=S, global_batch=B, seed=1)
    batches = [pipe.host_batch() for _ in range(3)]
    mask = (np.random.default_rng(7).random((B, S)) < 0.6).astype(np.float32)
    mask[0] = 0.0  # one row all masked: the replicas' counts differ
    jobs = {"smollm": {"cfg": cfg, "params": from_jax_params(np_params, cfg, World(TP, "cpu")), "batches": batches,
                       "prefill": True},
            "smollm_mask": {"cfg": cfg, "params": from_jax_params(np_params, cfg, World(TP, "cpu")),
                            "batches": [{**batches[0], "mask": mask}]},
            "smollm_seams": {"cfg": cfg, "params": from_jax_params(np_params, cfg, World(TP, "cpu")),
                             "batches": batches[:1], "fuse_seams": True},
            "smollm_dots": {"cfg": cfg, "params": from_jax_params(np_params, cfg, World(TP, "cpu")),
                            "batches": batches[:1], "remat": "dots"}}  # fmt: skip
    for name, arch in (("mamba", "mamba2-2.7b"), ("moe", "granite-moe-3b-a800m")):
        c = dataclasses.replace(reduce_config(get_config(arch)), vocab_size=VOCAB)
        p = lm.init(c, World(TP, "cpu"), torch.Generator().manual_seed(0), torch.float32)
        jobs[name] = {"cfg": c, "params": p, "batches": batches[:1]}
    c = dataclasses.replace(reduce_config(get_config("seamless-m4t-medium")), vocab_size=VOCAB)
    frames = (np.random.default_rng(3).standard_normal((B, 2 * S, c.d_model)) * 0.5).astype(np.float32)
    jobs["seamless"] = {"cfg": c, "mod": "encdec", "batches": [{**batches[0], "embeds": frames}],
                        "params": encdec.init(c, World(TP, "cpu"), torch.Generator().manual_seed(0), torch.float32)}
    return {"jobs": jobs, "jcfg": jcfg, "np_params": np_params}


@pytest.fixture(scope="module")
def d2(pc8):
    """The jobs, and what the two replica processes made of them (one spawn for the module)."""
    setup = _jobs(pc8)
    jobs = {k: {**v, "params": topt.tree_map(torch.clone, v["params"])} for k, v in setup["jobs"].items()}
    return {**setup, "got": train_cli.run_replicas(_step_worker, D, device="cpu", args=(jobs,))}


def _d1(job):
    """The port's D = 1 steps of a job: (metrics, parameters, moments)."""
    cfg, mod = job["cfg"], _mod(job)
    pc = ParallelContext(world=World(TP, "cpu"), backend="eager", fuse_seams=job.get("fuse_seams", False))
    step = make_train_step(mod, cfg, pc, AdamWConfig(**STEP_OPT), remat_policy=job.get("remat", "none"),
                           grad_masks=mod.grad_masks(cfg, pc))  # fmt: skip
    p, o = topt.tree_map(torch.clone, job["params"]), init_opt_state(mod.trainable(job["params"], cfg))
    ms = []
    for batch in job["batches"]:
        p, o, m = step(p, o, batch)
        ms.append({k: float(v) for k, v in m.items()})
    return ms, p, o


def _gathered(cfg, blocks, mod=lm):
    """The replicas' moment blocks joined along each leaf's data dim (the in-process World's unshard)."""
    pc = _context(cfg, World(D, "cpu"))

    def join(spec, *bs):
        if data_dim(spec, pc.dp_axes) is None:  # replicated: every replica holds the same moments
            assert all(torch.equal(b, bs[0]) for b in bs)
            return bs[0]
        return gather_data(torch.stack(bs), spec, pc.data, pc.dp_axes)

    return map_specs(join, mod.trainable(mod.specs(cfg, pc), cfg), *blocks)


def _close_trees(a, b, what):
    la, lb = topt.tree_leaves(a), topt.tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape, (what, i)
        err = (x.float() - y.float()).abs().max().item()
        assert err <= TOL["atol"] + TOL["rtol"] * y.float().abs().max().item(), (what, i, tuple(x.shape), err)


def _close_metrics(got, want, what):
    for g, w in zip(got, want, strict=True):
        for k in ("loss", "ce", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (what, k, g[k], w[k])
        assert abs(g["lr"] - w["lr"]) <= 1e-7 * w["lr"], what


JOBS = ["smollm", "smollm_mask", "mamba", "moe", "smollm_seams", "smollm_dots", "seamless"]


@pytest.mark.parametrize("name", JOBS)
def test_d2_step_matches_d1(d2, name):
    """The D = 2 step against the port's D = 1 step on the same global batch."""
    job = d2["jobs"][name]
    got, mod = d2["got"], _mod(job)
    ms, p, o = _d1(job)
    _close_metrics(got[0][name]["metrics"], ms, name)
    assert got[0][name]["metrics"] == got[1][name]["metrics"]  # every replica reports the global metrics
    _close_trees(mod.trainable(got[0][name]["params"], job["cfg"]), mod.trainable(p, job["cfg"]), name + " params")
    for k in ("mu", "nu"):
        _close_trees(_gathered(job["cfg"], [r[name]["opt"][k] for r in got], mod), o[k], f"{name} {k}")


@pytest.mark.parametrize("name", JOBS)
def test_d2_step_leaves_each_replica_its_blocks(d2, name):
    """After its steps every replica holds only its blocks: each parameter
    (the tied head's copy included) and moment leaf has ``place_data``'s
    shape of the whole leaf."""
    job = d2["jobs"][name]
    cfg, mod = job["cfg"], _mod(job)
    pc = _context(cfg, World(D, "cpu"))
    specs = mod.trainable(mod.specs(cfg, pc), cfg)
    blocks = map_specs(lambda s, t: place_data(t, s, pc.data, pc.dp_axes)[0] if data_dim(s, pc.dp_axes) is not None
                       else t, specs, mod.trainable(job["params"], cfg))  # fmt: skip
    want = [tuple(t.shape) for t in topt.tree_leaves(blocks)]
    for r in d2["got"]:
        assert r[name]["shapes"]["mu"] == r[name]["shapes"]["nu"] == want
        assert r[name]["shapes"]["params"] == [tuple(t.shape) for t in topt.tree_leaves(mod.with_tied(blocks, cfg))]
    assert any(a != tuple(t.shape) for a, t in zip(want, topt.tree_leaves(mod.trainable(job["params"], cfg))))


def test_d2_prefill_and_eval_match_d1(d2):
    """Prefill logits and the eval ce from each replica's blocks (each layer
    gathered at its use) bitwise equal to D = 1's on the same rows."""
    job = d2["jobs"]["smollm"]
    cfg = job["cfg"]
    pc = ParallelContext(world=World(TP, "cpu"), backend="eager")
    for r, out in enumerate(d2["got"]):
        local = _local(job["batches"][0], r)
        with torch.no_grad():
            want = lm.prefill(job["params"], cfg, pc, torch.as_tensor(local["inputs"]).long(), max_len=S)[0]
        assert torch.equal(out["smollm"]["prefill"], want)
        assert out["smollm"]["eval"] == float(make_eval_step(lm, cfg, pc)(job["params"], local))


def test_d2_step_matches_reference(d2, pc8, mesh8):
    """The D = 2 x W = 4 steps against the reference's ``make_train_step`` on
    the (1, 2, 4) mesh (whose data axis splits the batch over two replicas)."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jlm
    from repro.parallel.sharding import place
    from repro.training import optimizer as jopt
    from repro.training import steps as jsteps
    from test_torch_training import _np, _port_tree, j_compiled

    jcfg, cfg = d2["jcfg"], d2["jobs"]["smollm"]["cfg"]
    jp = place(jax.tree_util.tree_map(jnp.asarray, d2["np_params"]), mesh8, jlm.specs(jcfg, pc8))
    jstep = j_compiled(jsteps.make_train_step(jlm, jcfg, pc8, jopt.AdamWConfig(**STEP_OPT),
                                              grad_masks=jlm.grad_masks(jcfg, pc8), donate=False))  # fmt: skip
    jo, jms = jopt.init_opt_state(jp), []
    for batch in d2["jobs"]["smollm"]["batches"]:
        jp, jo, m = jstep(jp, jo, batch)
        jms.append({k: float(v) for k, v in m.items()})
    got = d2["got"]
    world = World(TP, "cpu")
    _close_metrics(got[0]["smollm"]["metrics"], jms, "reference")
    _close_trees(lm.trainable(got[0]["smollm"]["params"], cfg), _port_tree(_np(jp), cfg, world), "params")
    for k in ("mu", "nu"):
        _close_trees(_gathered(cfg, [r["smollm"]["opt"][k] for r in got]), _port_tree(_np(jo[k]), cfg, world), k)
    assert int(got[0]["smollm"]["opt"]["step"]) == int(jo["step"]) == 3


@pytest.mark.parametrize("name", ["smollm", "mamba", "moe", "smollm_seams", "smollm_dots", "seamless"])
def test_d2_step_moves_the_modelled_data_bytes(d2, name):
    """A step's payload on the data transport against ``data_axis_bytes`` of
    the leaves the step gathers, at the uses it makes (once a pass; again
    under remat) (mesh (pod 1, data 2, model 1): the process's own stored
    leaves)."""
    job = d2["jobs"][name]
    cfg, mod, remat = job["cfg"], _mod(job), job.get("remat", "none")
    mesh = {"pod": 1, "data": D, "model": 1}
    pc = _context(cfg, World(D, "cpu"))
    leaves = dryrun.data_leaves(cfg, job["params"], mod.specs(cfg, pc), train=True, remat=remat,
                                fuse_seams=job.get("fuse_seams", False))  # fmt: skip
    _, want = R.data_axis_bytes(leaves, mesh, pc.dp_axes, train=True, recompute=remat != "none")
    for r in d2["got"]:
        counter = CommCounter()
        for kind, nbytes in r[name]["payload"].items():
            counter.add(kind, nbytes, D)
        _, got = R.collective_bytes(counter)
        assert got == want, (name, got, want)
        assert set(got) == {"all-gather", "reduce-scatter", "all-reduce"}


# ---- the train CLI ----------------------------------------------------------------------------


def test_train_cli_data_parallel_resumes_at_either_d(tmp_path, capfd):
    """``--data 2 --device cpu --reduce``: 3 steps with a checkpoint at step
    2; that checkpoint resumed at D = 2 and at D = 1, and a D = 1 run's
    resumed at D = 2: each resumed step's loss bitwise the uninterrupted
    run's at its own D, within 1e-5 of the other D's (the replicas print to the
    file descriptors: capfd); ``data_ms`` only under ``--time-data``."""
    import shutil

    args = ["--arch", "smollm-360m", "--reduce", "--device", "cpu", "--batch", "4", "--seq", "16", "--ckpt-every",
            "2", "--log-every", "1", "--steps", "3"]  # fmt: skip
    runs = {}
    for d in (2, 1):
        timed = ["--time-data"] if d == 2 else []
        runs[d] = train_cli.main(args + ["--data", str(d), "--ckpt-dir", str(tmp_path / f"whole{d}")] + timed)
        assert [r["step"] for r in runs[d]["history"]] == [0, 1, 2]
    assert "data axis: 2 replica processes over torch.distributed gloo, staging direct" in capfd.readouterr().out
    rec = runs[2]["history"][0]
    assert set(rec["data_bytes"]) == {"psum", "all_gather", "reduce_scatter"} and rec["data_ms"] > 0
    assert rec["launches"] == runs[1]["history"][0]["launches"]  # each replica launches what one does
    assert len(runs[2]["replicas"]) == 2
    for a, b in zip(runs[2]["history"], runs[1]["history"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
    for src in (2, 1):  # resume the step-2 checkpoint of a run at D = src, at both D
        for d in (2, 1):
            cut = tmp_path / f"cut{src}{d}"
            cut.mkdir()
            shutil.copytree(tmp_path / f"whole{src}" / "step_00000002", cut / "step_00000002")
            again = train_cli.main(args + ["--data", str(d), "--ckpt-dir", str(cut)])
            assert "resumed from step 2" in capfd.readouterr().out
            (resumed,) = again["history"]
            if d == 2:
                assert resumed["data_ms"] is None and resumed["data_bytes"] == rec["data_bytes"]  # untimed
            if src == d:
                assert resumed["loss"] == runs[d]["history"][2]["loss"], (src, d)
            assert abs(resumed["loss"] - runs[d]["history"][2]["loss"]) <= 1e-5 * abs(resumed["loss"]), (src, d)
