"""Dry run: every (arch x shape) on the production meshes, planned without a
device — the port of ``repro/launch/dryrun.py``.

The JAX package lowers and compiles each cell's step for 256 / 512
placeholder devices and reads XLA's memory and cost analyses.  The port
compiles nothing: it runs the cell's step on the eager backend on the
``meta`` device (shapes and dtypes, no storage, no launch), one data
replica's share of the batch, the model axis's W ranks emulated as the
world, and measures that run:

  * memory per device: the arguments (parameters, optimizer state, inputs,
    caches) exactly from their specs (``launch/specs``,
    ``parallel/sharding.per_device_bytes``); the temporaries as the peak of
    live ``meta`` bytes during the step (a ``TorchDispatchMode`` that weakly
    references every storage an op creates; autograd's saved tensors keep
    theirs live), divided by W since the W ranks are stacked in one tree;
  * cost per device: FLOPs by ``torch.utils.flop_counter``'s formulas (those
    ``FlopCounterMode`` applies, counted in the same dispatch mode), bytes
    as every op's inputs plus outputs (an unfused upper bound: XLA's
    "bytes accessed" is counted after fusion, so the memory term here is
    larger than the reference's for the same work), both over W;
  * collective bytes: the model axis's from the world's transport
    (``World.counting``, ``launch/roofline.collective_bytes``), the data
    axes' from the specs (``launch/roofline.data_axis_bytes``), each axis at
    its own link rate (``launch/mesh``).

As in the JAX package, costs are extrapolated from two reduced-depth runs
(1 and 2 scan units: ``c1 + (n_units - 1) * (c2 - c1)``), so a cell costs
two short abstract runs; the temporaries' peak is extrapolated the same
way (a step's live set grows by the same bytes per unit: the saved
activations of a train step, the caches a prefill fills).  The multi-pod
pass (``extrapolate=False``) reports memory only, as in the reference.

Where an op of the path has a data-dependent size, the eager path already
gives it a static one (the MoE capacity, the flash tables), as the jitted
reference necessarily does, so every op runs on ``meta``; nothing is
skipped.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 8] [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.report [--dir results/dryrun_torch]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import json
import os
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["run_cell", "run_grid", "StepMeter", "main", "DEFAULT_OUT", "data_leaves"]

DEFAULT_OUT = "results/dryrun_torch"
META = torch.device("meta")


def _flat_tensors(values):
    """The tensors among ``values`` and one level of lists inside them (an op's arguments)."""
    for v in values:
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, (list, tuple)):
            yield from (t for t in v if isinstance(t, torch.Tensor))


class StepMeter(TorchDispatchMode):
    """Live and peak bytes of the storages ops create, the bytes every op
    reads and writes (its tensor inputs plus outputs; view ops move
    nothing) and, with ``count_flops``, the FLOPs of every op by
    ``torch.utils.flop_counter``'s formulas (the ones ``FlopCounterMode``
    applies; one mode instead of two stacked).  Storages registered with
    :meth:`hold` (the step's arguments) are not temporaries."""

    def __init__(self, count_flops: bool = True):
        super().__init__()
        self.live = self.peak = 0
        self.bytes = self.flops = 0
        self.count_flops = count_flops
        self._refs = {}

    def hold(self, tensors):
        for t in tensors:
            self._track(t, count=False)

    def _free(self, key, n, _ref):
        self._refs.pop(key, None)
        self.live -= n

    def _track(self, t: torch.Tensor, count: bool = True):
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes() if count else 0
        self._refs[key] = weakref.ref(st, functools.partial(self._free, key, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [out] if isinstance(out, torch.Tensor) else [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = list(_flat_tensors(args)) + list(_flat_tensors(kwargs.values()))
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if self.count_flops:
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
        for t in outs:
            self._track(t)
        return out


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _new_storage_bytes(tensors, held) -> int:
    """Bytes of the distinct storages of ``tensors`` that are not among ``held``'s."""
    old = {id(t.untyped_storage()) for t in held}
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        if id(st) not in old:
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _local(x: torch.Tensor, spec, pc) -> torch.Tensor:
    """A meta input at one data replica's share: the batch dim divided by
    the data axes when its spec shards it."""
    if len(spec) and spec[0] is not None and pc.dp > 1:
        return torch.empty((x.shape[0] // pc.dp,) + tuple(x.shape[1:]), dtype=x.dtype, device=META)
    return x


def _reduced_cfg(cfg, u: int):
    """The config with ``u`` scan units (prefix and suffix kept), as the JAX package's ``reduced_cfg``."""
    from repro_torch.models import lm

    if cfg.encoder_layers:
        return dataclasses.replace(cfg, encoder_layers=u, n_layers=u)
    k0, period, _, n_suffix = lm.scan_units(cfg)
    return dataclasses.replace(cfg, n_layers=k0 + u * period + n_suffix)


def _n_units(cfg) -> int:
    from repro_torch.models import lm

    return cfg.n_layers if cfg.encoder_layers else lm.scan_units(cfg)[2]


def _measure(cfg, shape, pc, remat: str, count_cost: bool) -> dict:
    """One abstract step of ``cfg`` at one data replica's batch on ``pc``
    (its world on meta): temporaries' peak, the outputs that are not its
    arguments (the updated parameters, moments and caches are), FLOPs,
    bytes and the model axis's collectives, each for the whole world (all
    W ranks)."""
    from repro_torch.launch import roofline as R
    from repro_torch.launch import specs as S
    from repro_torch.parallel.sharding import map_specs
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

    mod = S.model_module(cfg)
    params, _ = S.abstract_params(cfg, pc)
    inputs, ispecs = S.input_specs(cfg, shape, pc)
    if shape.kind == "decode":  # the caches at the replica's batch, built on meta
        b_loc = _local(inputs["tokens"], ispecs["tokens"], pc).shape[0]
        inputs = {"tokens": torch.empty((b_loc, 1), dtype=torch.int32, device=META),
                  "caches": mod.init_caches(cfg, pc, b_loc, shape.seq_len, torch.bfloat16),
                  "cache_len": torch.empty((), dtype=torch.int32, device=META)}  # fmt: skip
    else:
        inputs = map_specs(lambda s, x: _local(x, s, pc), ispecs, inputs)
    opt = None
    if shape.kind == "train":
        opt = init_opt_state(mod.trainable(params, cfg))
        step = make_train_step(mod, cfg, pc, AdamWConfig(), remat_policy=remat, grad_masks=mod.grad_masks(cfg, pc),
                               donate=True)  # fmt: skip

        def run():
            return step(params, opt, inputs)

    elif shape.kind == "prefill":

        def run():
            with torch.no_grad():
                if cfg.encoder_layers:
                    return mod.forward(params, cfg, pc, inputs["tokens"], embeds=inputs.get("embeds"))
                return mod.prefill(params, cfg, pc, inputs["tokens"], embeds=inputs.get("embeds"),
                                   max_len=shape.seq_len)  # fmt: skip

    else:

        def run():
            with torch.no_grad():
                return mod.decode_step(params, inputs["caches"], cfg, pc, inputs["tokens"], inputs["cache_len"])

    meter = StepMeter(count_flops=count_cost)
    args = _tensors((params, opt, inputs))
    meter.hold(args)
    with pc.world.counting() as counter, meter:
        out = run()
    coll, kinds = R.collective_bytes(counter)
    return {"temp": meter.peak, "out": _new_storage_bytes(_tensors(out), args), "flops": meter.flops,
            "bytes": meter.bytes, "coll": coll, "kinds": kinds}  # fmt: skip


def _arguments(cfg, shape, pc) -> dict:
    """Per-device argument bytes from the specs (params, optimizer state,
    inputs), and the bytes the emulated world holds of each on one card
    (every leaf divided by the data axes only: the W ranks of one replica
    share the card, a replicated leaf stored once)."""
    from repro_torch.launch import specs as S
    from repro_torch.parallel.sharding import only_axes, tree_bytes, map_specs

    mod = S.model_module(cfg)
    params, pspecs = S.abstract_params(cfg, pc)
    inputs, ispecs = S.input_specs(cfg, shape, pc)
    parts = {"params": (params, pspecs), "inputs": (inputs, ispecs)}
    if shape.kind == "train":
        parts["opt_state"] = S.abstract_opt_state(mod.trainable(params, cfg), mod.trainable(pspecs, cfg))
    mesh = pc.mesh_shape
    dev = {k: tree_bytes(t, s, mesh) for k, (t, s) in parts.items()}
    world = {k: tree_bytes(t, map_specs(lambda sp: only_axes(sp, pc.dp_axes), s), mesh)
             for k, (t, s) in parts.items()}  # fmt: skip
    return {"per_device": dev, "world": world, "params": params, "pspecs": pspecs}


def data_leaves(cfg, params, pspecs, *, train: bool, remat: str = "none", fuse_seams: bool = False) -> list:
    """(shape, dtype, spec, uses, trainable, regathered) of every parameter
    leaf as the port's step gathers it over the data axes
    (``ParallelContext.use_gather``): each once a forward, at its layer's use
    (the embedding and a shared mixer once a pass, for all their reads; a
    train step's forward reads only the trainable tree, a tied head from the
    gathered embedding), and again in the backward where ``remat`` other
    than "none" recomputes its layer (every layer; with ``fuse_seams`` the
    scanned units' only, as ``models/lm.forward`` checkpoints them); the
    leaves outside the layers are not recomputed."""
    from repro_torch.launch import specs as S
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import map_specs

    mod = S.model_module(cfg)
    trainable = mod.trainable(params, cfg)
    tree = trainable if train else params
    redo = set()  # the (stack, index) of every layer the backward recomputes
    if remat != "none" and cfg.encoder_layers:
        redo = {("enc_layers", i) for i in range(cfg.encoder_layers)} | {("dec_layers", i) for i in range(cfg.n_layers)}
    elif remat != "none":
        k0, period, n_units, _ = lm.scan_units(cfg)
        redo = {("layers", i) for i in (range(k0, k0 + n_units * period) if fuse_seams else range(cfg.n_layers))}
    out = []
    for key in tree:
        stack = isinstance(tree[key], list)
        for i, (s, t) in enumerate(zip(pspecs[key], tree[key])) if stack else [(None, (pspecs[key], tree[key]))]:
            map_specs(lambda sp, x, a=(key, i) in redo, k=key: out.append(
                (tuple(x.shape), x.dtype, sp, 1, k in trainable, a)), s, t)  # fmt: skip
    return out


def run_cell(arch: str, shape_name, *, multi_pod: bool = False, mode: str = "overlap", remat: str = "dots",
             verbose: bool = True, extrapolate: bool = True, flow_dtype: str = "float32", order: str = "ring",
             channels: int = 1, attn_bf16: bool = False, moe_stream: bool = False, mesh=None):  # fmt: skip
    """Plan one cell: ``arch`` (a registered name, or an ``ArchConfig``) at
    ``shape_name`` (a key of ``SHAPES`` or a
    :class:`~repro_torch.configs.base.Shape`) on the production mesh (or
    ``mesh``, a ``launch/mesh.Mesh``).  Returns the JAX package's result
    keys (memory per device: ``argument_size_in_bytes`` and
    ``temp_size_in_bytes`` both per device here), plus the port's
    ``collective_axes`` (bytes per mesh axis), ``memory["world"]`` (what
    the emulated world of one replica holds on one card) and ``fits`` (the
    per-device total within one H100's 80 GB)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.channels import BlockChannel, CommSpec, CompSpec
    from repro_torch.launch import roofline as R
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, why = S.cell_is_applicable(cfg, shape)
    result = {"arch": cfg.name, "shape": shape.name, "multi_pod": multi_pod, "mode": mode}
    if not ok:
        result.update(status="skipped", reason=why)
        if verbose:
            print(json.dumps(result))
        return result

    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
    channel = BlockChannel(axis="model", num_channels=channels, comm=CommSpec(order=order),
                           comp=CompSpec(accum_dtype=flow_dtype))  # fmt: skip
    pc = mesh.context(META, mode=mode, attn_p_bf16=attn_bf16, moe_decode_stream=moe_stream, channel=channel,
                      backend="eager")  # fmt: skip
    result["variant"] = {"flow_dtype": flow_dtype, "order": order, "channels": channels, "attn_bf16": attn_bf16,
                         "remat": remat, "moe_stream": moe_stream}  # fmt: skip
    w = pc.tp

    t0 = time.time()
    args = _arguments(cfg, shape, pc)
    t_lower = time.time() - t0
    t0 = time.time()
    n_units = _n_units(cfg)
    c1 = _measure(_reduced_cfg(cfg, 1), shape, pc, remat, count_cost=extrapolate)
    c2 = _measure(_reduced_cfg(cfg, 2), shape, pc, remat, count_cost=extrapolate)
    t_compile = time.time() - t0

    def extrap(a, b):
        return a + (n_units - 1) * (b - a)

    temp_world = extrap(c1["temp"], c2["temp"])
    arg_dev = sum(args["per_device"].values())
    # the step's outputs: the new ones (logits, metrics) and the arguments it returns updated in place
    returned = {"train": ("params", "opt_state"), "decode": ("inputs",)}.get(shape.kind, ())
    memory = {
        "temp_size_in_bytes": temp_world / w,
        "argument_size_in_bytes": arg_dev,
        "output_size_in_bytes": extrap(c1["out"], c2["out"]) / w + sum(args["per_device"][k] for k in returned),
        "arguments": args["per_device"],
        "world": {"arguments": args["world"], "temp_size_in_bytes": temp_world},
    }
    total = memory["temp_size_in_bytes"] + arg_dev
    result.update(status="ok", n_chips=mesh.size, lower_s=round(t_lower, 2), compile_s=round(t_compile, 2),
                  memory=memory, fits=total <= 80e9)  # fmt: skip
    if not extrapolate:
        result["extrapolated"] = False
        if verbose:
            print(json.dumps(result, default=str))
        return result

    flops = extrap(c1["flops"], c2["flops"]) / w
    byts = extrap(c1["bytes"], c2["bytes"]) / w
    model_coll = extrap(c1["coll"], c2["coll"])
    kinds = {k: extrap(c1["kinds"].get(k, 0.0), c2["kinds"].get(k, 0.0)) for k in set(c1["kinds"]) | set(c2["kinds"])}
    train = shape.kind == "train"
    data_coll, data_kinds = R.data_axis_bytes(
        data_leaves(cfg, args["params"], args["pspecs"], train=train, remat=remat, fuse_seams=pc.fuse_seams),
        pc.mesh_shape, pc.dp_axes, train=train, recompute=remat != "none",
    )  # fmt: skip
    for k, v in data_kinds.items():
        kinds[k] = kinds.get(k, 0.0) + v
    rates = dict(mesh.link_bw)
    dp_present = [a for a in pc.dp_axes if a in rates]
    axes = {"model": model_coll, "data": data_coll}
    link = {"model": rates["model"], "data": min((rates[a] for a in dp_present), default=rates["model"])}
    terms = R.roofline_terms({"flops": flops, "bytes accessed": byts}, axes, link_bw=link)
    mf = R.model_flops(cfg, shape)
    result.update(
        cost={"flops": flops, "bytes_accessed": byts, "per_unit_flops": (c2["flops"] - c1["flops"]) / w,
              "n_units": n_units},
        collective_bytes=model_coll + data_coll,
        collective_kinds=kinds,
        collective_axes=axes,
        roofline={k: terms[k] for k in ("compute_s", "memory_s", "collective_s")},
        dominant=R.dominant(terms),
        model_flops=mf,
        useful_flops_ratio=round(mf / max(flops * mesh.size, 1.0), 4),
    )  # fmt: skip
    if verbose:
        print(json.dumps(result, default=str))
    return result


def _cell(job):
    arch, shape, mp, kw = job
    try:
        return run_cell(arch, shape, multi_pod=mp, extrapolate=not mp, verbose=False, **kw)
    except Exception as e:  # recorded per cell, as the reference's subprocess records a failed one
        return {"arch": arch, "shape": shape, "multi_pod": mp, "mode": kw.get("mode", "overlap"), "status": "error",
                "error": f"{type(e).__name__}: {e}"}  # fmt: skip


def run_grid(jobs: int = 1, archs=None, shapes=None, pods=(False, True), **kw) -> list:
    """Every (arch x shape x single / multi-pod) cell, the multi-pod pass
    memory only; in ``jobs`` processes (spawned) when above 1, shape-major
    so the costly train and prefill cells start first."""
    from repro_torch.configs import ARCH_NAMES, SHAPES

    cells = [(a, s, mp, kw) for s, mp, a in itertools.product(shapes or list(SHAPES), pods, archs or ARCH_NAMES)]
    if jobs <= 1:
        return [_cell(c) for c in cells]
    import multiprocessing as mp_

    with mp_.get_context("spawn").Pool(jobs, initializer=torch.set_num_threads, initargs=(1,)) as pool:
        return pool.map(_cell, cells, chunksize=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description="plan every (arch x shape) cell on the production meshes, on meta")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="overlap", choices=["overlap", "baseline"])
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--flow-dtype", default="float32")
    ap.add_argument("--order", default="ring")
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--attn-bf16", action="store_true")
    ap.add_argument("--moe-stream", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1, help="processes for --all")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    kw = dict(mode=args.mode, remat=args.remat, flow_dtype=args.flow_dtype, order=args.order,
              channels=args.channels, attn_bf16=args.attn_bf16, moe_stream=args.moe_stream)  # fmt: skip

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        res = run_cell(args.arch, args.shape, multi_pod=args.multi_pod, extrapolate=not args.multi_pod, **kw)
        return 0 if res["status"] in ("ok", "skipped") else 1

    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    failures = []
    for res in run_grid(jobs=args.jobs, **kw):
        tag = f"{res['arch']}__{res['shape']}__{'mp' if res['multi_pod'] else 'sp'}__{args.mode}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1, default=str)
        print(f"{tag}: {res['status']}")
        if res["status"] == "error":
            failures.append(tag)
    print(f"{time.time() - t0:.1f} s")
    if failures:
        print("FAILURES:", failures)
        return 1
    print("all cells ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())

