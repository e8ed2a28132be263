"""Mamba-2 (SSD) block — the port of ``repro/nn/mamba.py``; heads sharded
over the ranks.

The attention-free mixer: the paper's AG+GEMM / GEMM+RS pattern covers the
in/out projections, which carry the block's FLOPs, and the SSD scan runs on
each rank's head shard over the full (gathered) sequence.

Per rank (``convert.shard_params``): ``w_in`` [W, D, 2 di_loc + h_loc +
pad] joins the rank's x | z columns of ``w_xz`` and its ``w_dt`` columns (the
JAX package concatenates them at every call), zero-padded to a multiple of
8 columns (16-byte rows for the bf16 kernel's TMA; :func:`_split` drops the
pad); ``conv`` [W, K, di_loc];
``w_out`` [W, di_loc, D]; ``dt_bias`` / ``a_log`` / ``d_skip`` [W, h_loc]
in float32; ``w_bc`` [D, 2 G N] and ``ln`` [D] replicated.  The x | z split
is per shard: the first half of a rank's x | z columns is its x, the second
its z.

Prefill (``apply_seq``): AG+GEMM in-projection, the replicated B/C
projection computed once on the gathered sequence, the causal depthwise
conv, ``ssd_chunked`` with the ranks folded into the head dimension, the
D skip and z gate, and the GEMM+RS out-projection.  With
``pc.backend == "fused"`` the SSD intra-chunk term runs on the Hopper
kernel (the JAX package runs its einsum form here); with ``"eager"`` on the
einsum form.

Decode (``apply_decode`` / ``apply_decode_chunk``): the per-token
recurrence with local per-rank einsums and a ``psum``; the SSM state cache
[W, B, h_loc, N, P] is float32, the conv tail [W, B, K-1, di_loc] (the last
pre-conv x inputs) has the model dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_ssd import ssd_chunked
from repro_torch.nn.layers import he_init, rms_norm
from repro_torch.parallel.sharding import Spec

__all__ = ["init", "specs", "apply_seq", "apply_decode", "apply_decode_chunk", "init_cache", "cache_specs"]


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.headdim


def init(cfg, tp: int, generator: torch.Generator, dtype: torch.dtype, device) -> dict:
    """Global (unsharded) parameters in the JAX package's layout; ``dt_bias``,
    ``a_log`` and ``d_skip`` are float32 whatever ``dtype``."""
    d, s = cfg.d_model, cfg.ssm
    d_inner, n_heads = _dims(cfg)
    if d_inner % tp or n_heads % tp:
        raise ValueError(f"d_inner {d_inner} and {n_heads} heads must divide over {tp} ranks")
    f32 = torch.float32
    return {
        "ln": torch.zeros((d,), dtype=dtype, device=device),
        "w_xz": he_init((d, 2 * d_inner), generator, dtype, device, fan_in=d),
        "w_dt": he_init((d, n_heads), generator, dtype, device, fan_in=d),
        "dt_bias": torch.zeros((n_heads,), dtype=f32, device=device),
        "w_bc": he_init((d, 2 * s.n_groups * s.d_state), generator, dtype, device, fan_in=d),
        "a_log": torch.zeros((n_heads,), dtype=f32, device=device),
        "d_skip": torch.ones((n_heads,), dtype=f32, device=device),
        "conv": he_init((s.d_conv, d_inner), generator, dtype, device, fan_in=s.d_conv),
        "w_out": he_init((d_inner, d), generator, dtype, device, fan_in=d_inner),
    }


def specs(cfg, tp: int, dp) -> dict:
    """``repro/nn/mamba.specs`` on the port's leaves: ``w_in`` [W, D, cols]
    joins ``w_xz`` (``P(dp, "model")``) and ``w_dt`` (``P(None, "model")``)
    and takes ``w_xz``'s spec, D over the data axes ``dp`` for the dt
    columns too; ``conv`` [W, K, di_loc], ``w_out`` [W, di_loc, D] (``P("model",
    dp)``), the per-head vectors [W, h_loc]; ``w_bc`` ``P(dp, None)``."""
    return {
        "ln": Spec(None), "w_in": Spec("model", dp, None), "w_bc": Spec(dp, None), "conv": Spec("model", None, None),
        "w_out": Spec("model", None, dp), "dt_bias": Spec("model", None), "a_log": Spec("model", None),
        "d_skip": Spec("model", None),
    }  # fmt: skip


def cache_specs(dp) -> dict:
    """The decode state: SSM state [W, B, h_loc, N, P] and conv tail [W, B,
    K-1, di_loc], the batch over the data axes (``repro/nn/mamba.cache_specs``)."""
    return {"ssm": Spec("model", dp, None, None, None), "conv": Spec("model", dp, None, None)}


def _conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv per rank. x: [W, B, S, C], w: [W, K, C]."""
    k, s = w.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, :, i : i + s, :] * w[:, i][:, None, None, :] for i in range(k))


def _split(xzdt: torch.Tensor, di_loc: int, h_loc: int):
    """[..., 2 di_loc + h_loc + pad] -> x, z, raw dt (the per-shard column
    layout); the pad columns are dropped."""
    return xzdt[..., :di_loc], xzdt[..., di_loc : 2 * di_loc], xzdt[..., 2 * di_loc : 2 * di_loc + h_loc]


def _bc(h: torch.Tensor, params: dict, cfg):
    """The replicated B/C projection: h [..., D] -> B, C [..., G, N]."""
    s = cfg.ssm
    bc = torch.matmul(h, params["w_bc"])
    gn = s.n_groups * s.d_state
    shape = tuple(h.shape[:-1]) + (s.n_groups, s.d_state)
    return bc[..., :gn].reshape(shape), bc[..., gn:].reshape(shape)


def apply_seq(params: dict, x: torch.Tensor, pc, cfg, return_state: bool = False):
    """x: [W, B, s_loc, D] sequence-sharded -> [W, B, s_loc, D] (+ residual).

    ``return_state`` also returns the decode cache (the final SSM state and
    the conv tail) for prefill-into-cache."""
    s_cfg = cfg.ssm
    world, b = x.shape[0], x.shape[1]
    d_inner, n_heads = _dims(cfg)
    di_loc, h_loc = d_inner // world, n_heads // world
    hd = s_cfg.headdim
    h = rms_norm(x, params["ln"], cfg.norm_eps)

    # AG + GEMM: gather the sequence, project to the local channels (x | z | dt | pad)
    xzdt = pc.ag_matmul(h, params["w_in"])  # [W, B, S, 2 di_loc + h_loc + pad]
    s_glob = xzdt.shape[2]
    xin, z, dt_raw = _split(xzdt, di_loc, h_loc)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][:, None, None, :])  # [W, B, S, h_loc]

    # B/C: the replicated projection, computed once on the gathered sequence
    b_mat, c_mat = _bc(pc.all_gather_seq(h, 1)[0], params, cfg)  # [B, S, G, N]

    # causal depthwise conv on the local channels (full sequence, no halo)
    xh = F.silu(_conv1d(xin, params["conv"])).reshape(world, b, s_glob, h_loc, hd)

    # the ranks fold into the head dimension; each rank's heads read the B/C
    # groups as its own shard does (the groups tiled once per rank)
    y = ssd_chunked(
        xh.permute(1, 2, 0, 3, 4).reshape(b, s_glob, world * h_loc, hd),
        dt.permute(1, 2, 0, 3).reshape(b, s_glob, world * h_loc),
        params["a_log"].reshape(-1),
        b_mat.repeat(1, 1, world, 1),
        c_mat.repeat(1, 1, world, 1),
        chunk=s_cfg.chunk,
        return_state=return_state,
        intra="kernel" if pc.fused else "einsum",
    )
    if return_state:
        y, h_last = y
    y = y.reshape(b, s_glob, world, h_loc, hd).permute(2, 0, 1, 3, 4)  # [W, B, S, h_loc, P]
    y = y + xh * params["d_skip"][:, None, None, :, None]  # float32 from here
    y = y.reshape(world, b, s_glob, di_loc) * F.silu(z)

    # GEMM + RS back to the sequence-sharded residual stream
    res = x + pc.matmul_rs(y.to(x.dtype).contiguous(), params["w_out"])
    if return_state:
        ssm = h_last.reshape(b, world, h_loc, s_cfg.d_state, hd).transpose(0, 1).contiguous()
        # conv tail: the last (d_conv - 1) pre-conv inputs of the local channels
        tail = xzdt[:, :, -(s_cfg.d_conv - 1) :, :di_loc]
        return res, {"ssm": ssm, "conv": tail.to(x.dtype).contiguous()}
    return res


def init_cache(cfg, tp: int, batch: int, dtype: torch.dtype, device) -> dict:
    """Decode state: SSM state [W, B, h_loc, N, P] (float32) and the conv
    tail [W, B, d_conv - 1, di_loc] (``dtype``)."""
    s = cfg.ssm
    d_inner, n_heads = _dims(cfg)
    return {
        "ssm": torch.zeros((tp, batch, n_heads // tp, s.d_state, s.headdim), dtype=torch.float32, device=device),
        "conv": torch.zeros((tp, batch, s.d_conv - 1, d_inner // tp), dtype=dtype, device=device),
    }


def apply_decode(params: dict, x: torch.Tensor, cache: dict, pc, cfg):
    """Single-token recurrent step. x: [B, 1, D] replicated over the ranks.

    Returns (x_out [B, 1, D], new cache); ``cache`` is not modified."""
    s_cfg = cfg.ssm
    world, b = pc.tp, x.shape[0]
    d_inner, n_heads = _dims(cfg)
    di_loc, h_loc = d_inner // world, n_heads // world
    hd = s_cfg.headdim
    h = rms_norm(x, params["ln"], cfg.norm_eps)[:, 0]  # [B, D]

    xin, z, dt_raw = _split(torch.einsum("bd,wdn->wbn", h, params["w_in"]), di_loc, h_loc)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][:, None, :])  # [W, B, h_loc]
    b_mat, c_mat = _bc(h, params, cfg)  # [B, G, N]

    # conv step: the cache holds the last (d_conv - 1) x inputs (local channels)
    xcat = torch.cat([cache["conv"], xin[:, :, None, :]], dim=2)  # [W, B, K, di_loc]
    xc = F.silu((xcat * params["conv"][:, None].to(xcat.dtype)).sum(dim=2))

    # recurrence: h_t = h_{t-1} exp(dt A) + dt B x;  y = C . h + D x
    a = -torch.exp(params["a_log"])  # [W, h_loc]
    xh = xc.reshape(world, b, h_loc, hd).float()
    g = s_cfg.n_groups
    rep = h_loc // g if g <= h_loc else 1
    bh = b_mat.repeat_interleave(rep, dim=1)[:, :h_loc].float()  # [B, h_loc, N]
    ch = c_mat.repeat_interleave(rep, dim=1)[:, :h_loc].float()
    decay = torch.exp(dt * a[:, None, :])  # [W, B, h_loc]
    upd = torch.einsum("wbh,bhn,wbhp->wbhnp", dt, bh, xh)
    new_ssm = cache["ssm"] * decay[..., None, None] + upd
    y = torch.einsum("bhn,wbhnp->wbhp", ch, new_ssm)
    y = y + xh * params["d_skip"][:, None, :, None]
    y = (y.reshape(world, b, di_loc) * F.silu(z)).to(x.dtype)

    out = pc.psum(torch.einsum("wbn,wnd->wbd", y, params["w_out"]))
    return x + out[:, None, :], {"ssm": new_ssm, "conv": xcat[:, :, 1:]}


def apply_decode_chunk(params: dict, x: torch.Tensor, cache: dict, pc, cfg, q_valid=None):
    """Chunked decode: the single-token recurrence over the C rows of x.

    x: [B, C, D] replicated over the ranks.  ``q_valid`` ([B], optional) is
    how many of the C rows are real per slot: a masked step leaves that
    slot's SSM and conv state as they were (a stale recurrent state would
    poison every later token).  Returns (x_out [B, C, D], cache), the cache
    tensors updated in place (copied into, so a CUDA graph that captured
    them sees the new state).
    """
    b, c, _ = x.shape
    nv = None if q_valid is None else torch.as_tensor(q_valid, dtype=torch.int64, device=x.device).expand(b)
    state = {"ssm": cache["ssm"], "conv": cache["conv"]}
    ys = []
    for i in range(c):
        y, new = apply_decode(params, x[:, i : i + 1], state, pc, cfg)
        if nv is not None:
            ok = nv > i  # [B]
            new = {k: torch.where(ok.view((1, b) + (1,) * (v.dim() - 2)), v, state[k]) for k, v in new.items()}
        state = new
        ys.append(y)
    cache["ssm"].copy_(state["ssm"])
    cache["conv"].copy_(state["conv"])
    return torch.cat(ys, dim=1), cache
