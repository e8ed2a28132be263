"""Decoder-only LM — the port of ``repro/models/lm.py`` for ``"attn"``
layers with a dense MLP or an MoE FFN (with or without shared experts),
``"attn_dense"`` layers (the leading dense-MLP layers of an MoE model,
``moe.first_k_dense``, at ``moe.dense_d_ff``), ``"mamba"`` layers (a
Mamba-2 mixer, no FFN) and ``"shared_attn"`` layers (zamba2: one attention
parameter set, ``params["shared_attn"]``, used by every occurrence, each
with its own dense MLP and its own KV cache).

A Python loop over a list of layers replaces the JAX package's ``lax.scan``
over stacked parameters.  Parameters are rank-stacked (``convert.py``):

  embed     [W, V_pad/W, D]   vocab rows sharded over the ranks
  head      [D, V_pad]        the LM head (the embedding transposed when tied)
  final_ln  [D]
  shared_attn  {ln, wqkv, wo}   the shared mixer (a model with "shared_attn" layers)
  layers    [{"mixer": {ln, wqkv [W, D, (h_loc+2 kv_loc)*hd], wo [W, h_loc*hd, D]},
              "ffn":   {ln, w_gu [W, D, 2 f_loc], w_down [W, f_loc, D]}  (mlp)
                       {ln, router [D, E_pad] f32, w_gu [W, E_loc, D, 2 f],
                        w_down [W, E_loc, f, D], [shared: an mlp FFN]}  (moe)}
             {"mixer": {ln, w_in [W, D, 2 di_loc + h_loc + pad to 8], w_bc, conv, w_out,
                        dt_bias / a_log / d_skip [W, h_loc] f32}}  (mamba),
             {"ffn": {ln, w_gu, w_down}}  (shared_attn: the mixer is ``shared_attn``), ...]

``forward`` and ``prefill`` take a stub frontend's prefix (``embeds``
[B, S0, D], paligemma's image patches; ``models/frontends``) before the
token embeddings, scaled with them where the config sets ``embed_scale``.

``prefill`` runs every layer's TP forward (the fused kernels on the card)
and fills the decode caches (KV caches; SSM state and conv tail for Mamba
layers); ``decode_step`` then advances every slot by up to C tokens;
``forward`` returns the logits and the summed MoE aux loss.  The LM head
runs on the tile-GEMM kernel when ``pc.backend == "fused"``.

With ``pc.fuse_seams`` ``forward`` chains consecutive attention + dense-MLP
layers (:meth:`LayerDef.seam_eligible`) through fused RS -> AG seams
(:func:`_seam_chain`): each attention output projection's RS feeds the
MLP's gate/up AG, and an MLP's down-projection RS feeds the next eligible
layer's qkv AG.  Chains stay within the JAX package's layer segments (the
``first_k_dense`` prefix, each ``cfg.pattern`` period, the suffix), so each
model fuses the same seams as the reference.  ``prefill`` takes no seams,
as in the JAX package; with ``pc.ep_axis`` its MoE layers run the
expert-parallel path (``nn/moe.apply_seq``).

Training (``training/steps.py``) differentiates ``forward`` with
``torch.autograd``: every fused kernel on the dense path has an autograd
Function (``core/compiler``, ``kernels/flash_attention``,
``kernels/matmul``; the SSD intra-chunk term's ``kernels/mamba_ssd``),
``remat_policy`` other than ``"none"`` recomputes each layer in the
backward (``torch.utils.checkpoint``).  With ``pc.fuse_seams`` the seamed
forward differentiates too: a seam is ``core/overlap.matmul_rs_ag`` over
torch ops (``_RankDot``), and a chain's ends are the ``_AgMatmul`` /
``_MatmulRs`` Functions, whose backwards run the other fused kernel; under
remat each scan unit's seam chain is recomputed whole, as the JAX package
checkpoints its ``unit_body`` (the prefix and the suffix are not).  The
shared mixer's gradient is the sum over its occurrences (autograd's).  The trainable
tree (:func:`trainable`) leaves out the tied head's copy: :func:`logits`
then takes the head from ``embed`` (``convert.tied_head``), so the one
parameter gets the lookup's and the head's gradient, and
:func:`with_tied` refreshes the copy after an update.  :func:`grad_masks`,
:func:`decay_mask` and :func:`sync_grads` are the reference's padded-head
masks, its weight-decay rule and its kv-copy averaging, on this layout.

With ``pc.data`` (ZeRO-3) the parameters are this replica's blocks of
every leaf the specs split over the data axes, and each use gathers them
whole (``ParallelContext.use_gather``), as the JAX package's ``use_gather``
calls do: each layer in ``apply_seq`` / ``apply_prefill`` /
``apply_decode`` (inside the remat'd body, so a recomputing backward
gathers again) or in :func:`_seam_chain`, the head in :func:`logits`; the
embedding (the lookup and a tied head) and the shared mixer (every
``shared_attn`` layer) once a pass.  Without it every path is unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.convert import tied_head
from repro_torch.kernels.matmul import matmul, matmul_plain
from repro_torch.nn import attention, ffn, mamba, moe
from repro_torch.nn.layers import emb_init, rms_norm
from repro_torch.parallel.context import ParallelContext
from repro_torch.parallel.sharding import Spec

__all__ = [
    "LayerDef",
    "layer_plan",
    "scan_units",
    "specs",
    "top_specs",
    "cache_specs",
    "segments",
    "init",
    "padded_vocab",
    "embed_tokens",
    "logits",
    "forward",
    "prefill",
    "init_caches",
    "decode_step",
    "trainable",
    "with_tied",
    "check_trainable",
    "grad_masks",
    "decay_mask",
    "sync_grads",
    "proc_roles",
    "REMAT_POLICIES",
]

# "dots" and "full" (the JAX package's two checkpoint policies) both recompute each layer (with fused seams:
# each scan unit) whole in the backward
REMAT_POLICIES = ("none", "dots", "full")
# leaves that are one-dimensional in the JAX layout outside the layer scan
_VECTORS = ("ln", "final_ln", "bqkv", "dt_bias", "a_log", "d_skip")


@dataclasses.dataclass(frozen=True)
class LayerDef:
    kind: str  # attn | attn_local | attn_dense (attention + a dense MLP at moe.dense_d_ff) | mamba | shared_attn
    ffn_kind: Optional[str]  # mlp | moe | None
    window: Optional[int]
    theta: float
    shared: bool = False  # the mixer is the model's one ``shared_attn`` parameter set (zamba2)

    def mixer(self, params, shared):
        """This layer's mixer parameters: its own, or the shared set."""
        return shared if self.shared else params["mixer"]

    def gathered(self, params, pc, cfg):
        """This layer's stored parameters for one use: with ``pc.data`` every
        leaf the data axes split gathered whole (``pc.use_gather``, one
        all-gather per dtype, reduce-scattered back in the backward); without
        it ``params`` itself.  A shared layer's mixer is the model's, which
        :func:`forward` gathers once a pass."""
        if pc.data is None:
            return params
        return pc.use_gather(params, self.specs(cfg, pc, pc.dp_spec()))

    def _ffn_seq(self, params, x, pc, cfg):
        """The FFN half of a layer: (x, aux loss)."""
        if self.ffn_kind == "mlp":
            return ffn.apply_seq(params["ffn"], x, pc, cfg), _zero(x)
        if self.ffn_kind == "moe":
            return moe.apply_seq(params["ffn"], x, pc, cfg)
        return x, _zero(x)

    def apply_seq(self, params, x, pc, cfg, shared=None):
        """x: [W, B, s_loc, D] -> (x, aux loss); ``params`` stored (gathered here)."""
        params = self.gathered(params, pc, cfg)
        if self.kind == "mamba":
            return mamba.apply_seq(params["mixer"], x, pc, cfg), _zero(x)
        mixer = self.mixer(params, shared)
        x = attention.apply_seq(mixer, x, pc, cfg, causal=True, window=self.window, rope_theta=self.theta)
        return self._ffn_seq(params, x, pc, cfg)

    def seam_eligible(self) -> bool:
        """Whether the layer joins a fused seam chain: attention with a dense
        MLP (Mamba has no RS feeding an AG; MoE's gather is its own flow)."""
        return self.kind != "mamba" and self.ffn_kind == "mlp"

    def apply_seq_fused(self, params, x, pc, cfg, qkv=None, next_mixer=None, shared=None):
        """The seam-fused layer: the attention output projection's RS feeds
        the MLP's gate/up AG (the intra-layer seam); with ``next_mixer`` (the
        next layer's attention params) the down projection's RS produces
        that layer's qkv too (the inter-layer seam).  ``qkv`` is this
        layer's projection from the previous layer's seam.  ``params``,
        ``next_mixer`` and ``shared`` are gathered for their use already
        (:func:`_seam_chain` gathers a chain's leaves).  Returns (x, aux loss,
        next layer's qkv or None)."""
        y, gu = attention.apply_seq(
            self.mixer(params, shared), x, pc, cfg, causal=True, window=self.window, rope_theta=self.theta, qkv=qkv,
            next_proj=ffn.seam_proj(params["ffn"], cfg),
        )  # fmt: skip
        if next_mixer is None:
            return ffn.apply_seq(params["ffn"], y, pc, cfg, gu=gu), _zero(x), None
        x, nqkv = ffn.apply_seq(params["ffn"], y, pc, cfg, gu=gu, next_proj=attention.seam_proj(next_mixer, cfg))
        return x, _zero(x), nqkv

    def apply_prefill(self, params, x, pc, cfg, max_len: int, shared=None):
        """Like apply_seq, but returns (x, this layer's decode cache) with the
        cache's sequence dimension padded to ``max_len`` (a ring for window
        layers; a Mamba layer's cache is its SSM state and conv tail); the
        aux loss is dropped, as in the JAX package."""
        params = self.gathered(params, pc, cfg)
        if self.kind == "mamba":
            return mamba.apply_seq(params["mixer"], x, pc, cfg, return_state=True)
        x, kv = attention.apply_seq(
            self.mixer(params, shared), x, pc, cfg, causal=True, window=self.window, rope_theta=self.theta,
            return_kv=True,
        )  # fmt: skip
        s_len = kv["k"].shape[3]
        if self.window is not None and self.window < max_len:
            w = self.window
            if s_len >= w:
                kv = {n: torch.roll(a[:, :, :, s_len - w :], s_len % w, dims=3) for n, a in kv.items()}
            else:
                kv = {n: _pad_seq(a, w) for n, a in kv.items()}
        else:
            kv = {n: _pad_seq(a, max_len) for n, a in kv.items()}
        x, _ = self._ffn_seq(params, x, pc, cfg)
        return x, kv

    def specs(self, cfg, pc, dp):
        """This layer's parameter specs (its mixer's, unless shared, and its FFN's)."""
        s = {}
        if self.kind == "mamba":
            s["mixer"] = mamba.specs(cfg, pc.tp, dp)
        elif not self.shared:
            s["mixer"] = attention.specs(cfg, pc.tp, dp)
        if self.ffn_kind == "mlp":
            s["ffn"] = ffn.specs(cfg, pc.tp, dp)
        elif self.ffn_kind == "moe":
            s["ffn"] = moe.specs(cfg, pc.tp, dp)
        return s

    def cache_specs(self, dp):
        return mamba.cache_specs(dp) if self.kind == "mamba" else attention.cache_specs(dp)

    def init_cache(self, cfg, pc, batch, max_len, dtype):
        if self.kind == "mamba":
            return mamba.init_cache(cfg, pc.tp, batch, dtype, pc.device)
        return attention.init_cache(cfg, pc.tp, batch, max_len, dtype, pc.device, window=self.window, held=pc.held)

    def apply_decode(self, params, x, cache, cache_len, pc, cfg, q_valid=None, shared=None):
        params = self.gathered(params, pc, cfg)
        if self.kind == "mamba":
            return mamba.apply_decode_chunk(params["mixer"], x, cache, pc, cfg, q_valid=q_valid)
        x, cache = attention.apply_decode(
            self.mixer(params, shared), x, cache, cache_len, pc, cfg, window=self.window, rope_theta=self.theta,
            q_valid=q_valid,
        )  # fmt: skip
        if self.ffn_kind == "mlp":
            x = ffn.apply_decode(params["ffn"], x, pc, cfg)
        elif self.ffn_kind == "moe":
            x = moe.apply_decode(params["ffn"], x, pc, cfg)
        return x, cache


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _pad_seq(a: torch.Tensor, length: int) -> torch.Tensor:
    out = torch.zeros(a.shape[:3] + (length,) + a.shape[4:], dtype=a.dtype, device=a.device)
    out[:, :, :, : a.shape[3]] = a
    return out


def _layer_def(cfg, kind: str) -> LayerDef:
    if kind == "mamba":
        return LayerDef("mamba", None, None, 0.0)
    if kind == "attn_dense":
        return LayerDef("attn_dense", "mlp", None, cfg.rope_theta)
    if kind == "shared_attn":
        return LayerDef("shared_attn", "mlp", None, cfg.rope_theta, shared=True)
    if kind not in ("attn", "attn_local"):
        raise NotImplementedError(
            f"repro_torch: layer kind {kind!r} is not ported (attn, attn_local, attn_dense, mamba and shared_attn only)"
        )
    window = cfg.local_window if kind == "attn_local" else None
    theta = cfg.rope_theta_local if kind == "attn_local" else cfg.rope_theta
    ffn_kind = "moe" if cfg.moe is not None else ("mlp" if cfg.d_ff else None)
    return LayerDef(kind, ffn_kind, window, theta)


def layer_plan(cfg) -> List[LayerDef]:
    """One LayerDef per layer, in depth order."""
    return [_layer_def(cfg, cfg.layer_kind(i)) for i in range(cfg.n_layers)]


def scan_units(cfg) -> tuple:
    """(prefix layers, layers per unit, units, suffix layers): the JAX
    package's ``layer_plan`` split of the depth (the ``first_k_dense``
    prefix, then whole ``cfg.pattern`` periods under its ``lax.scan``, then
    the remainder)."""
    k0 = cfg.moe.first_k_dense if cfg.moe else 0
    period = len(cfg.pattern)
    n_units = (cfg.n_layers - k0) // period
    return k0, period, n_units, cfg.n_layers - k0 - n_units * period


def segments(cfg) -> List[range]:
    """The JAX package's layer segments over the flat layer list: the
    ``first_k_dense`` prefix, one per ``cfg.pattern`` period, the suffix
    (``repro/models/lm.layer_plan``).  Seam chains do not cross them."""
    k0, period, n_units, _ = scan_units(cfg)
    bounds = [0, k0] + [k0 + (u + 1) * period for u in range(n_units)] + [cfg.n_layers]
    return [range(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]


def _seam_chain(defs, plist, x, pc, cfg, aux_total, shared=None):
    """Run one segment's layers, fusing the RS -> AG seams between
    consecutive eligible layers; an ineligible layer (Mamba, MoE) breaks the
    chain and runs unfused.  With ``pc.data`` an eligible layer's FFN and
    the next eligible layer's mixer (which its seam reads first) are
    gathered in one use, and the next layer takes that mixer as gathered:
    each leaf is gathered once a pass (``shared`` is, by :func:`forward`).
    Returns (x, aux_total plus the layers' aux)."""
    qkv = mixer = None
    asp, fsp = attention.specs(cfg, pc.tp, pc.dp_spec()), ffn.specs(cfg, pc.tp, pc.dp_spec())
    for i, (d, p) in enumerate(zip(defs, plist)):
        if not d.seam_eligible():
            x, aux = d.apply_seq(p, x, pc, cfg, shared)
            mixer = None
        else:
            nd = defs[i + 1] if i + 1 < len(defs) and defs[i + 1].seam_eligible() else None
            tree, spec = {"ffn": p["ffn"]}, {"ffn": fsp}
            if mixer is None and not d.shared:
                tree["mixer"], spec["mixer"] = p["mixer"], asp
            if nd is not None and not nd.shared:
                tree["next"], spec["next"] = plist[i + 1]["mixer"], asp
            g = pc.use_gather(tree, spec)
            own = {"mixer": g.get("mixer", mixer), "ffn": g["ffn"]}
            nxt = None if nd is None else (shared if nd.shared else g["next"])
            x, aux, qkv = d.apply_seq_fused(own, x, pc, cfg, qkv=qkv, next_mixer=nxt, shared=shared)
            mixer = None if nd is None or nd.shared else nxt
        aux_total = aux_total + aux
    return x, aux_total


def _uses_shared(cfg) -> bool:
    """Whether the model has ``shared_attn`` layers (one shared mixer)."""
    return "shared_attn" in cfg.pattern


def padded_vocab(cfg, tp: int) -> int:
    """Vocab rows padded to the TP degree."""
    return -(-cfg.vocab_size // tp) * tp


def init(cfg, world, generator: torch.Generator, dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Seeded random parameters at the config's size, built on ``device``
    (default: the world's) with the JAX package's init rules and layout.
    Each layer is made as ``convert.shard_params`` reads it, so the global
    copy of one layer at a time is alive beside the sharded tree (over
    processes, beside this process's held slices)."""
    from repro_torch.convert import shard_params

    device = torch.device(device) if device is not None else world.device
    tp = world.size
    glob = {
        "embed": emb_init((padded_vocab(cfg, tp), cfg.d_model), generator, dtype, device),
        "final_ln": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        glob["lm_head"] = emb_init((cfg.d_model, padded_vocab(cfg, tp)), generator, dtype, device)
    if _uses_shared(cfg):
        glob["shared_attn"] = attention.init(cfg, tp, generator, dtype, device)

    def make(d: LayerDef) -> dict:
        if d.kind == "mamba":
            return {"mixer": mamba.init(cfg, tp, generator, dtype, device)}
        layer = {} if d.shared else {"mixer": attention.init(cfg, tp, generator, dtype, device)}
        if d.ffn_kind == "mlp":
            d_ff = cfg.moe.dense_d_ff if d.kind == "attn_dense" else cfg.d_ff
            layer["ffn"] = ffn.init(cfg, generator, dtype, device, d_ff=d_ff)
        elif d.ffn_kind == "moe":
            layer["ffn"] = moe.init(cfg, tp, generator, dtype, device)
        return layer

    glob["layers"] = (make(d) for d in layer_plan(cfg))  # drawn in layer order, as shard_params reads them
    return shard_params(glob, cfg, world)


def specs(cfg, pc: ParallelContext) -> dict:
    """The parameter specs of :func:`init`'s tree (``repro/models/lm.specs``
    on the port's layout): ``embed`` [W, V/W, D] (``P("model", dp)``),
    ``head`` [D, V] (``P(dp, "model")``: the LM head, a stored copy of the
    embedding when tied), each layer's and the shared mixer's blocks; the
    data axes are ``pc.dp_spec()``."""
    dp = pc.dp_spec()
    s = top_specs(pc)
    if _uses_shared(cfg):
        s["shared_attn"] = attention.specs(cfg, pc.tp, dp)
    s["layers"] = [d.specs(cfg, pc, dp) for d in layer_plan(cfg)]
    return s


def top_specs(pc: ParallelContext) -> dict:
    """The specs of the leaves outside the layers: ``embed`` [W, V/W, D]
    (``P("model", dp)``), ``head`` [D, V] (``P(dp, "model")``), ``final_ln``."""
    dp = pc.dp_spec()
    return {"embed": Spec("model", None, dp), "head": Spec(dp, "model"), "final_ln": Spec(None)}


def _gathered_top(params: dict, cfg, pc: ParallelContext) -> dict:
    """``params`` with ``embed`` and the shared mixer gathered for one pass
    (``pc.use_gather``, one use): the lookup and a tied head read the one
    gathered ``embed``, every shared layer the one gathered mixer, so each
    is gathered once a pass and its gradient reduce-scattered once.
    ``params`` itself without ``pc.data``."""
    if pc.data is None:
        return params
    spec = {"embed": top_specs(pc)["embed"]}
    if "shared_attn" in params:
        spec["shared_attn"] = attention.specs(cfg, pc.tp, pc.dp_spec())
    return {**params, **pc.use_gather({k: params[k] for k in spec}, spec)}


def cache_specs(cfg, pc: ParallelContext) -> list:
    """The specs of :func:`init_caches`' list, one per layer."""
    return [d.cache_specs(pc.dp_spec()) for d in layer_plan(cfg)]


def embed_tokens(params: dict, cfg, tokens: Optional[torch.Tensor], embeds: Optional[torch.Tensor] = None):
    """tokens [B, S] (or None) and ``embeds`` [B, S0, D] (a stub frontend's
    prefix, or None) -> [B, S0 + S, D] (global): the prefix cast to the
    embedding's dtype, then the token embeddings, the whole of it times
    sqrt(d_model) in that dtype where the config sets ``embed_scale`` (the
    reference scales the image prefix too).  ``F.embedding``, whose
    backward sums each row's gradients in a fixed order (an indexing
    backward accumulates in any order on the CPU)."""
    parts = []
    if embeds is not None:
        parts.append(embeds.to(params["embed"].dtype))
    if tokens is not None:
        parts.append(torch.nn.functional.embedding(tokens, params["embed"].reshape(-1, params["embed"].shape[-1])))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    if cfg.embed_scale:
        # the factor rounded to x's dtype on the host (a Python scalar: no
        # device copy, so a captured decode step may take it)
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype).item()
    return x


def logits(params: dict, cfg, pc: ParallelContext, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head: x [B, S, D] (global) -> [B, S, vocab].  A tree
    without ``head`` (the trainable tree of a tied model) takes it from
    ``embed`` (gathered by the caller under ``pc.data``); a stored ``head``
    is gathered here, at its use (``pc.use_gather``)."""
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    gemm = matmul if pc.fused else matmul_plain
    head = pc.use_gather(params["head"], top_specs(pc)["head"]) if "head" in params else tied_head(params["embed"])
    out = gemm(x.reshape(-1, x.shape[-1]).contiguous(), head)
    return out.reshape(x.shape[:-1] + (out.shape[-1],))[..., : cfg.vocab_size]


def _check_seq(pc: ParallelContext, s: int):
    if s % pc.tp:
        raise ValueError(f"sequence length {s} must divide over the {pc.tp} ranks (sequence-parallel residual)")


def forward(
    params: dict, cfg, pc: ParallelContext, tokens: torch.Tensor, embeds: Optional[torch.Tensor] = None,
    remat_policy: str = "none",
):  # fmt: skip
    """Teacher-forced (logits [B, S0 + S, vocab], aux loss summed over the
    layers); ``embeds`` [B, S0, D] is a stub frontend's prefix
    (:func:`embed_tokens`; attention over it stays causal, as in the JAX
    package);
    with ``pc.fuse_seams`` the layers run through :func:`_seam_chain`, one
    chain per segment (:func:`segments`).  ``remat_policy`` other than
    ``"none"`` recomputes in the backward each layer, or with fused seams
    each scan unit's chain (the JAX package checkpoints its ``unit_body``:
    not the prefix or the suffix); the JAX package's ``"dots"`` keeps the
    GEMM outputs, here the unit is recomputed whole, with the same results."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r}; one of {REMAT_POLICIES}")
    params = _gathered_top(params, cfg, pc)
    x = embed_tokens(params, cfg, tokens, embeds)
    _check_seq(pc, x.shape[1])
    x = pc.world.shard(x, dim=1)  # [W, B, s_loc, D]
    aux_total = _zero(x)
    defs = layer_plan(cfg)
    shared = params.get("shared_attn")
    if pc.fuse_seams:
        units = _scanned(cfg)
        for seg in segments(cfg):

            def chain(x_, aux_, seg_=seg):
                layers = params["layers"][seg_.start : seg_.stop]
                return _seam_chain(defs[seg_.start : seg_.stop], layers, x_, pc, cfg, aux_, shared)

            if remat_policy != "none" and seg.start in units:
                x, aux_total = torch.utils.checkpoint.checkpoint(chain, x, aux_total, use_reentrant=False)
            else:
                x, aux_total = chain(x, aux_total)
    else:
        for d, p in zip(defs, params["layers"]):
            if remat_policy == "none":
                x, aux = d.apply_seq(p, x, pc, cfg, shared)
            else:
                x, aux = torch.utils.checkpoint.checkpoint(
                    lambda x_, d_=d, p_=p: d_.apply_seq(p_, x_, pc, cfg, shared), x, use_reentrant=False
                )
            aux_total = aux_total + aux
    return logits(params, cfg, pc, pc.world.unshard(x, dim=1)), aux_total


def prefill(
    params: dict, cfg, pc: ParallelContext, tokens: torch.Tensor, embeds: Optional[torch.Tensor] = None, *,
    max_len: int,
):  # fmt: skip
    """Forward pass that also fills the decode caches; ``embeds`` as in
    :func:`forward`.

    Returns (logits [B, S0 + S, vocab], caches) — decode continues at
    position S0 + S.
    """
    params = _gathered_top(params, cfg, pc)
    x = embed_tokens(params, cfg, tokens, embeds)
    _check_seq(pc, x.shape[1])
    x = pc.world.shard(x, dim=1)
    caches = []
    shared = params.get("shared_attn")
    for d, p in zip(layer_plan(cfg), params["layers"]):
        x, c = d.apply_prefill(p, x, pc, cfg, max_len, shared)
        caches.append(c)
    return logits(params, cfg, pc, pc.world.unshard(x, dim=1)), caches


def init_caches(cfg, pc: ParallelContext, batch: int, max_len: int, dtype=torch.bfloat16) -> list:
    return [d.init_cache(cfg, pc, batch, max_len, dtype) for d in layer_plan(cfg)]


def decode_step(params: dict, caches: list, cfg, pc: ParallelContext, tokens: torch.Tensor, cache_len, q_valid=None):
    """One decode step advancing every slot by up to C tokens.

    tokens: [B, C]; ``cache_len``: int or [B]; ``q_valid`` (optional [B]):
    real rows per slot.  Returns (logits [B, C, vocab], caches), the caches
    updated in place.
    """
    params = _gathered_top(params, cfg, pc)
    x = embed_tokens(params, cfg, tokens)
    shared = params.get("shared_attn")
    for d, p, c in zip(layer_plan(cfg), params["layers"], caches):
        x, _ = d.apply_decode(p, x, c, cache_len, pc, cfg, q_valid=q_valid, shared=shared)
    return logits(params, cfg, pc, x), caches


# ---------------------------------------------------------------------------
# training: the trainable tree, padded-head masks, weight decay, kv-copy sync
# ---------------------------------------------------------------------------


def trainable(params: dict, cfg) -> dict:
    """The parameters an optimizer updates: all of them but the tied head's
    copy (with ``cfg.tie_embeddings`` :func:`logits` takes it from ``embed``)."""
    return {k: v for k, v in params.items() if not (cfg.tie_embeddings and k == "head")}


def with_tied(tree: dict, cfg) -> dict:
    """The full parameters from a trainable tree: the tied head's copy
    refreshed from ``embed`` (no grad)."""
    if not cfg.tie_embeddings:
        return tree
    with torch.no_grad():
        return {**tree, "head": tied_head(tree["embed"])}


def check_trainable(cfg, pc: ParallelContext):
    """Raise unless the model's training path is ported: every layer kind
    (attention with a dense MLP or an MoE block, TP or EP; Mamba; the shared
    attention block) trains, with or without fused seams, on one process;
    over a TP world of processes attention with a dense MLP or a MoE block
    (TP or EP) does, without seams (``NotImplementedError`` naming the
    rest)."""
    layer_plan(cfg)  # an unported layer kind raises here
    if pc.world.nprocs > 1:
        from repro_torch.convert import check_procs

        check_procs(cfg, pc.world, f"training {cfg.name}")
        if pc.fuse_seams:
            pc.single_process(f"training {cfg.name} with the fused RS -> AG seam")


def proc_roles(tree: dict, cfg) -> dict:
    """What a TP world over processes holds of each leaf of a trainable tree
    (``training/steps``): "held" (each layer's per-rank operands,
    ``convert.HELD_LEAVES``: this process's ranks' slices; a MoE block's
    expert stacks and its shared experts' MLP among them), "summed" (a
    layer's replicated leaves, the norms, a MoE block's ``ln`` and float32
    ``router``: each rank reads them inside the rank-stacked region (the
    router on its own tokens, whose aux loss ``pc.pmean`` gathers with a
    slicing adjoint), so a process's gradient is its held ranks' part and
    the step sums it over the processes) or "whole" (``embed``, the head,
    ``final_ln``: read on values every process computes whole, so every
    process's gradient is already the whole one)."""
    from repro_torch.convert import HELD_LEAVES
    from repro_torch.training.optimizer import tree_map

    def part(sub, names):
        return {k: part(v, names) if isinstance(v, dict) else tree_map(lambda _, k=k: "held" if k in names
                                                                       else "summed", v)
                for k, v in sub.items()}  # fmt: skip

    out = {k: tree_map(lambda _: "whole", v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{name: part(sub, HELD_LEAVES.get(name, ())) for name, sub in layer.items()}
                     for layer in tree["layers"]]  # fmt: skip
    return out


def grad_masks(cfg, pc: ParallelContext) -> dict:
    """0/1 masks (or None) over the trainable tree that keep padded heads at
    zero (``repro/models/lm.grad_masks``): each attention mixer's, the
    shared mixer's (a model with ``shared_attn`` layers); a None subtree
    (a Mamba mixer, an MLP) masks nothing.  Over processes each mask holds
    this process's ranks."""
    layers = []
    for d in layer_plan(cfg):
        am = attention.grad_masks(cfg, pc.tp, pc.device) if d.kind != "mamba" and not d.shared else None
        if am is not None and pc.world.nprocs > 1:
            am = {k: None if m is None else m[pc.rank0 : pc.rank0 + pc.held] for k, m in am.items()}
        layers.append(None if am is None else {"mixer": am})
    out = {"layers": layers}
    if _uses_shared(cfg):
        out["shared_attn"] = attention.grad_masks(cfg, pc.tp, pc.device)
    return out


def _scanned(cfg) -> range:
    """The layers the JAX package stacks under its ``lax.scan`` (whole
    ``cfg.pattern`` periods after the ``first_k_dense`` prefix)."""
    k0, period, n_units, _ = scan_units(cfg)
    return range(k0, k0 + n_units * period)


def decay_mask(tree: dict, cfg) -> dict:
    """Which leaves of ``tree`` (a trainable tree) take weight decay: the
    reference decays a leaf iff it has two or more dims in its own layout
    (``repro/training/optimizer.py``), where every scanned layer's leaves
    carry a layer axis.  So a scanned layer's norms are decayed, and the
    one-dimensional leaves (``_VECTORS``) of an unscanned layer, the shared
    mixer (outside the scan) and ``final_ln`` are not; every matrix is."""
    scanned = _scanned(cfg)

    def leaves(node, stacked, name=None):
        if isinstance(node, dict):
            return {k: leaves(v, stacked, k) for k, v in node.items()}
        return stacked or name not in _VECTORS

    out = {k: leaves(v, False, k) for k, v in tree.items() if k != "layers"}
    out["layers"] = [leaves(p, i in scanned) for i, p in enumerate(tree["layers"])]
    return out


def sync_grads(grads: dict, cfg, pc: ParallelContext) -> dict:
    """Average the gradients of the kv copies (GQA with fewer kv heads than
    ranks) in every attention block, the shared mixer's included
    (``repro/models/lm.sync_grads``); the tree unchanged when ``rep == 1``.
    Over processes the copies of a head may sit on different processes:
    the kv columns are gathered over them first (``attention.sync_grads``)."""
    if not cfg.n_heads or attention.layout(cfg, pc.tp).rep == 1:
        return grads
    layers = []
    for d, g in zip(layer_plan(cfg), grads["layers"]):
        if d.kind != "mamba" and not d.shared:
            g = {**g, "mixer": attention.sync_grads(g["mixer"], cfg, pc.tp, world=pc.world)}
        layers.append(g)
    out = {**grads, "layers": layers}
    if "shared_attn" in grads:
        out["shared_attn"] = attention.sync_grads(grads["shared_attn"], cfg, pc.tp, world=pc.world)
    return out
