"""The port's sharding specs and dry-run cells against the JAX package's.

For every registered config at its published width, on two meshes — A, the
8-device ``mesh8`` of ``tests/conftest.py`` (pod 1, data 2, model 4), and B,
the production shape (data 32, model 8) as a ``jax.sharding.AbstractMesh``
(neither side allocates) — the reference's parameter tree comes from
``jax.eval_shape`` with its ``specs``, the port's from
``repro_torch.launch.specs.abstract_params`` on ``meta`` with its own.  Each
reference leaf is mapped to the port's through ``convert``'s leaf
correspondence (a scan unit to its layers; ``wq`` | ``wkv`` to ``wqkv``,
``bq`` | ``bkv`` to ``bqkv``, ``w_xz`` | ``w_dt`` to ``w_in``; ``lm_head``
to ``head``), and the axes that split it and its bytes per device must be
the reference's (``NamedSharding.shard_shape``), with these stated
exceptions, each held exactly:

  * leaves ``convert`` pads with zero columns for the wgmma route — the LM
    head, a cross mixer's ``wq`` / ``wkv``, Mamba's ``w_in`` — hold the
    reference's bytes of the padded global shape under the reference's spec;
  * Mamba's ``w_in`` is one leaf with one spec, ``w_xz``'s, so the dt
    columns take the data axes on D as well (the reference leaves ``w_dt``'s
    D unsplit);
  * a tied model's ``head`` is the stored copy of the embedding that the
    kernel reads, which the reference does not keep (its bytes: the padded
    [D, V] under ``P(dp, "model")``).

The same for ``cache_specs`` and ``abstract_opt_state``; ``SHAPES``,
``cell_is_applicable``, ``batch_pspec`` and ``input_specs`` equal the
reference's for every (arch x shape), in shapes, dtypes and split axes.
Beyond the axes and bytes, each port spec is the reference's moved onto the
rank-stacked layout (``parallel/sharding.stacked``), so every axis splits
the dim the reference's spec names for it.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_NAMES as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import specs as JS
from repro.parallel.context import ParallelContext as JPC
from repro_torch.backend.mesh import World
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.convert import IN_ALIGN
from repro_torch.launch import specs as TS
from repro_torch.parallel.context import ParallelContext
from repro_torch.parallel.sharding import Spec, axes_of, map_specs, per_device_bytes, stacked
from repro_torch.training.optimizer import tree_leaves
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

MESH_B = (("data", 32), ("model", 8))
MESHES = ("A", "B")
JOINED = {("wq", "wkv"): "wqkv", ("bq", "bkv"): "bqkv", ("w_xz", "w_dt"): "w_in"}
CACHE_BATCH, CACHE_LEN = 64, 256  # the cache trees' batch (divides mesh B's 32 replicas) and length
_JMESH = {}


@pytest.fixture(scope="module", autouse=True)
def _meshes(mesh8):
    _JMESH["A"] = mesh8
    _JMESH["B"] = AbstractMesh(tuple(n for _, n in MESH_B), tuple(a for a, _ in MESH_B))
    yield
    _JMESH.clear()


def _mesh_axes(which):
    return dict(_JMESH[which].shape) if which == "A" else dict(MESH_B)


def _jpc(which):
    return JPC(mesh=_JMESH[which])


def _tpc(which):
    axes = _mesh_axes(which)
    return ParallelContext(world=World(axes["model"], "meta"), mesh_axes=axes)


def _jbytes(which, shape, dtype, spec) -> int:
    """The reference's bytes per device: its NamedSharding's shard shape."""
    blk = NamedSharding(_JMESH[which], P(*spec)).shard_shape(tuple(shape))
    return math.prod(blk) * np.dtype(dtype).itemsize


def _jaxes(spec) -> set:
    return {a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))}


@functools.lru_cache(maxsize=None)
def _jparams(arch, which):
    cfg, pc = j_get_config(arch), _jpc(which)
    return JS.abstract_params(cfg, pc)


@functools.lru_cache(maxsize=None)
def _tparams(arch, which):
    return TS.abstract_params(get_config(arch), _tpc(which))


# ---- the leaf correspondence ---------------------------------------------------


class Group:
    """Reference leaves [(shape, dtype, spec)] and the port's [(shape, dtype,
    spec)] that hold the same parameters, and how their bytes relate."""

    def __init__(self, name, jl, tl, kind="equal", scanned=False):
        self.name, self.jl, self.tl, self.kind, self.scanned = name, jl, tl, kind, scanned


def _jleaf(a, spec):
    return (tuple(a.shape), a.dtype, tuple(spec))


def _tleaf(t, spec):
    return (tuple(t.shape), t.dtype, spec)


def _block_groups(name, jblock, jspec, tblocks, tspecs, scanned=False):
    """Groups of one block (a dict of leaves, maybe with nested blocks) of
    the reference against its port blocks (one per scan unit of a
    ``scanned`` block, whose leaves carry the unit axis first)."""
    out = []
    done = set()
    for (a, b), joined in JOINED.items():
        if a in jblock and joined in tblocks[0]:
            kind = "w_in" if joined == "w_in" else "equal"
            out.append(Group(f"{name}.{joined}", [_jleaf(jblock[a], jspec[a]), _jleaf(jblock[b], jspec[b])],
                             [_tleaf(t[joined], s[joined]) for t, s in zip(tblocks, tspecs)], kind, scanned))  # fmt: skip
            done |= {a, b}
    for key, val in jblock.items():
        if key in done:
            continue
        if isinstance(val, dict):
            out += _block_groups(f"{name}.{key}", val, jspec[key], [t[key] for t in tblocks], [s[key] for s in tspecs],
                                 scanned)  # fmt: skip
            continue
        kind = "pad_cols" if (name.endswith("cross") and key in ("wq", "wkv")) else "equal"
        out.append(Group(f"{name}.{key}", [_jleaf(val, jspec[key])],
                         [_tleaf(t[key], s[key]) for t, s in zip(tblocks, tspecs)], kind, scanned))  # fmt: skip
    return out


def _lm_groups(cfg, jtree, jspecs, ttree, tspecs, opt=False):
    """Every group of an LM (or encoder-decoder) tree: ``opt`` for the AdamW
    moments (the trainable trees: no tied head on either side)."""
    groups = [Group("embed", [_jleaf(jtree["embed"], jspecs["embed"])], [_tleaf(ttree["embed"], tspecs["embed"])])]
    if "lm_head" in jtree:
        groups.append(Group("head", [_jleaf(jtree["lm_head"], jspecs["lm_head"])],
                            [_tleaf(ttree["head"], tspecs["head"])], "pad_head"))  # fmt: skip
    elif "head" in ttree:
        assert cfg.tie_embeddings and not opt
        groups.append(Group("head", [], [_tleaf(ttree["head"], tspecs["head"])], "tied_head"))
    for key in ("final_ln", "enc_ln"):
        if key in jtree:
            groups.append(Group(key, [_jleaf(jtree[key], jspecs[key])], [_tleaf(ttree[key], tspecs[key])]))
    if "shared_attn" in jtree:
        groups += _block_groups("shared_attn", jtree["shared_attn"], jspecs["shared_attn"], [ttree["shared_attn"]],
                                [tspecs["shared_attn"]])  # fmt: skip
    if cfg.encoder_layers:
        for part in ("enc", "dec"):
            tl, ts = ttree[f"{part}_layers"], tspecs[f"{part}_layers"]
            groups += _block_groups(f"{part}_scan", jtree[f"{part}_scan"], jspecs[f"{part}_scan"], tl, ts, True)
        return groups
    from repro_torch.models.lm import scan_units

    k0, period, n_units, n_suffix = scan_units(cfg)
    tl, ts = ttree["layers"], tspecs["layers"]
    for i, (jl, js) in enumerate(zip(jtree.get("prefix", []), jspecs["prefix"])):
        groups += _block_groups(f"prefix{i}", jl, js, [tl[i]], [ts[i]])
    for j, (jl, js) in enumerate(zip(jtree.get("scan", []), jspecs.get("scan", []))):
        idx = [k0 + u * period + j for u in range(n_units)]
        groups += _block_groups(f"scan{j}", jl, js, [tl[i] for i in idx], [ts[i] for i in idx], True)
    for i, (jl, js) in enumerate(zip(jtree.get("suffix", []), jspecs["suffix"])):
        at = k0 + n_units * period + i
        groups += _block_groups(f"suffix{i}", jl, js, [tl[at]], [ts[at]])
    return groups


def _flat_global(tl, scanned: bool):
    """The global shape the port's rank-stacked leaves [W, D, c] stand for
    ([D, W c], with a leading unit axis when scanned)."""
    w, d, c = tl[0][0]
    return ((len(tl),) if scanned else ()) + (d, w * c)


def _full(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def _check_groups(which, groups, tree, specs):
    """Every port leaf has a spec and lies in exactly one group; each
    group's split axes, their dims and its bytes per device as the module
    docstring states."""
    axes_sizes = _mesh_axes(which)
    n_specs = []
    map_specs(lambda s, t: n_specs.append(len(s) <= t.dim()), specs, tree)
    assert all(n_specs) and len(n_specs) == len(tree_leaves(tree))
    assert sum(len(g.tl) for g in groups) == len(n_specs)
    for g in groups:
        tbytes = sum(per_device_bytes(s, dt, sp, axes_sizes) for s, dt, sp in g.tl)
        taxes = {frozenset(axes_of(sp)) for _, _, sp in g.tl}
        assert len(taxes) == 1, (g.name, taxes)
        taxes = set(next(iter(taxes)))
        if g.kind == "tied_head":
            (shape, dt, _), = g.tl
            assert tbytes == _jbytes(which, shape, jnp.bfloat16, (_jpc(which).dp_spec(), "model")), g.name
            assert taxes == _jaxes((_jpc(which).dp_spec(), "model")), g.name
            continue
        jaxes = _jaxes(g.jl[0][2])
        assert taxes == jaxes, (g.name, taxes, jaxes)
        # each axis on the dim the reference's spec names, moved onto the rank-stacked layout
        js = Spec(*(g.jl[0][2][1:] if g.scanned else g.jl[0][2]))
        for shape, _, sp in g.tl:
            want = stacked(js) if len(shape) == len(g.jl[0][0]) - g.scanned + 1 else js
            assert _full(sp, len(shape)) == _full(want, len(shape)), (g.name, sp, want)
        jbytes = sum(_jbytes(which, *leaf) for leaf in g.jl)
        if g.kind == "equal":
            assert tbytes == jbytes, (g.name, tbytes, jbytes)
        elif g.kind == "pad_head":
            (shape, dt, _), = g.tl
            (jshape, jdt, jspec), = g.jl
            assert shape == (jshape[0], -(-jshape[1] // IN_ALIGN) * IN_ALIGN), g.name
            assert tbytes == _jbytes(which, shape, jdt, jspec), g.name
        elif g.kind == "pad_cols":
            (jshape, jdt, jspec), = g.jl
            glob = _flat_global(g.tl, g.scanned)
            assert glob[-1] >= jshape[-1] and g.tl[0][0][2] % IN_ALIGN == 0, g.name
            assert tbytes == _jbytes(which, glob, jdt, jspec), g.name
        elif g.kind == "w_in":
            (xz_shape, jdt, xz_spec), (dt_shape, _, _) = g.jl
            glob = _flat_global(g.tl, g.scanned)
            w = g.tl[0][0][0]
            xz_loc = xz_shape[-1] // w
            assert g.tl[0][0][2] % IN_ALIGN == 0 and g.tl[0][0][2] - xz_loc >= dt_shape[-1] // w, g.name
            rest = glob[:-1] + (w * (g.tl[0][0][2] - xz_loc),)
            # w_xz's bytes as the reference's, plus the dt and pad columns under w_xz's spec
            assert tbytes == _jbytes(which, xz_shape, jdt, xz_spec) + _jbytes(which, rest, jdt, xz_spec), g.name


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(arch, which):
    cfg = get_config(arch)
    jtree, jspecs = _jparams(arch, which)
    ttree, tspecs = _tparams(arch, which)
    assert all(t.device.type == "meta" for t in tree_leaves(ttree))
    _check_groups(which, _lm_groups(cfg, jtree, jspecs, ttree, tspecs), ttree, tspecs)


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_opt_state_specs_match_reference(arch, which):
    cfg = get_config(arch)
    jtree, jspecs = _jparams(arch, which)
    jopt, jos = JS.abstract_opt_state(jtree, jspecs)
    ttree, tspecs = _tparams(arch, which)
    from repro_torch.models import encdec, lm

    mod = encdec if cfg.encoder_layers else lm
    topt, tos = TS.abstract_opt_state(mod.trainable(ttree, cfg), mod.trainable(tspecs, cfg))
    assert tuple(jos["step"]) == tuple(tos["step"]) == () and topt["step"].dtype == torch.int32
    for moment in ("mu", "nu"):
        assert {t.dtype for t in tree_leaves(topt[moment])} == {torch.float32}
        groups = _lm_groups(cfg, jopt[moment], jos[moment], topt[moment], tos[moment], opt=True)
        _check_groups(which, groups, topt[moment], tos[moment])


def _cache_groups(cfg, jc, js, tc, ts):
    if cfg.encoder_layers:
        return [g for part in ("self", "cross") for g in _block_groups(part, jc[part], js[part], tc[part], ts[part],
                                                                        True)]  # fmt: skip
    from repro_torch.models.lm import scan_units

    k0, period, n_units, _ = scan_units(cfg)
    groups = []
    for i, (jl, jsp) in enumerate(zip(jc["prefix"], js["prefix"])):
        groups += _block_groups(f"prefix{i}", jl, jsp, [tc[i]], [ts[i]])
    for j, (jl, jsp) in enumerate(zip(jc.get("scan", []), js.get("scan", []))):
        idx = [k0 + u * period + j for u in range(n_units)]
        groups += _block_groups(f"scan{j}", jl, jsp, [tc[i] for i in idx], [ts[i] for i in idx], True)
    for i, (jl, jsp) in enumerate(zip(jc["suffix"], js["suffix"])):
        at = k0 + n_units * period + i
        groups += _block_groups(f"suffix{i}", jl, jsp, [tc[at]], [ts[at]])
    return groups


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_match_reference(arch, which):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jpc, tpc = _jpc(which), _tpc(which)
    jmod = JS.model_module(jcfg)
    jc = jax.eval_shape(lambda: jmod.init_caches(jcfg, jpc, CACHE_BATCH, CACHE_LEN, jnp.bfloat16))
    js = jmod.cache_specs(jcfg, jpc)
    tmod = TS.model_module(cfg)
    tc = tmod.init_caches(cfg, tpc, CACHE_BATCH, CACHE_LEN, torch.bfloat16)
    ts = tmod.cache_specs(cfg, tpc)
    _check_groups(which, _cache_groups(cfg, jc, js, tc, ts), tc, ts)


# ---- the cells ----------------------------------------------------------------------


def test_shapes_and_archs_equal_reference():
    assert list(SHAPES) == list(J_SHAPES) and ARCH_NAMES == J_ARCHS
    for name, s in SHAPES.items():
        j = J_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (j.name, j.seq_len, j.global_batch, j.kind)


_DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.float32): torch.float32}  # fmt: skip


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cells_match_reference(arch, which):
    """cell_is_applicable (verdict and reason), batch_pspec and input_specs
    (shapes, dtypes, specs; the decode caches through the cache groups) for
    every shape."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jpc, tpc = _jpc(which), _tpc(which)
    for name in SHAPES:
        jshape, shape = J_SHAPES[name], SHAPES[name]
        assert TS.cell_is_applicable(cfg, shape) == JS.cell_is_applicable(jcfg, jshape)
        assert TS.batch_pspec(shape.global_batch, tpc) == JS.batch_pspec(jshape.global_batch, jpc)
        jt, js = JS.input_specs(jcfg, jshape, jpc)
        tt, ts = TS.input_specs(cfg, shape, tpc)
        assert set(tt) == set(jt), name
        for key in tt:
            if key == "caches":
                _check_groups(which, _cache_groups(cfg, jt[key], js[key], tt[key], ts[key]), tt[key], ts[key])
                continue
            assert tuple(tt[key].shape) == tuple(jt[key].shape), (name, key)
            assert tt[key].dtype == _DTYPES[jnp.dtype(jt[key].dtype)], (name, key)
            assert tuple(ts[key]) == tuple(js[key]), (name, key, ts[key], js[key])
