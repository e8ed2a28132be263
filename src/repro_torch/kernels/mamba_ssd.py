"""Mamba-2 SSD (state-space duality), chunked-parallel form, and the
intra-chunk kernel (``csrc/ssd_intra_chunk.cu``).

``ssd_chunked`` is the port of ``repro/kernels/mamba_ssd.py::ssd_chunked``:
the O(L·Q) chunked algorithm (Dao & Gu 2024) — quadratic attention-like
intra-chunk products plus a scan over chunk states (a Python loop over the
chunks here, ``lax.scan`` there).  Its intra-chunk term is the einsum form
of the JAX package (``intra="einsum"``) or the Hopper kernel
(``intra="kernel"``), which replaces ``ssd_intra_chunk``
(``_ssd_intra_kernel``) of the same file; the bound and the design are
noted in the CUDA source.

Under autograd the intra-chunk term is :class:`_SsdIntraChunk`: the
kernel's forward and a float32 backward in PyTorch ops
(:func:`ssd_intra_chunk_backward`); the rest of ``ssd_chunked`` (the C.B
einsum, the cumsum, the loop over chunk states) differentiates as torch
ops.

:func:`ssd_intra_chunk_plain` is the kernel's plain PyTorch version;
:func:`block_tiles`, :func:`thread_pairs` and :func:`bulk_staged` model the
kernel's schedule (which tiles a persistent block takes, which (i, j) pairs
a thread computes, which staging path a shape takes) for the CPU tests.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

__all__ = [
    "ssd_chunked",
    "ssd_intra_chunk",
    "ssd_intra_chunk_plain",
    "ssd_intra_chunk_backward",
    "block_tiles",
    "thread_pairs",
    "bulk_staged",
    "MAX_Q",
    "MAX_P",
    "THREADS",
    "INTRA_FORMS",
]

MAX_Q = 64  # largest chunk length the kernel takes
MAX_P = 64  # largest head dim the kernel takes
THREADS = 128  # threads of a kernel block: 16 row groups x 8 column groups
INTRA_FORMS = ("einsum", "kernel")


# ---- the kernel's schedule (csrc/ssd_intra_chunk.cu), modelled for the CPU tests


def block_tiles(t: int, grid: int) -> List[List[int]]:
    """The tiles each block of the persistent grid takes: block b walks b,
    b + G, b + 2G, ... below T."""
    return [list(range(b, t, grid)) for b in range(grid)]


def thread_pairs(tid: int) -> Tuple[List[Tuple[int, int]], List[int]]:
    """The (i, j) pairs of the 64 x 64 tile thread ``tid`` computes, in its
    order, and its columns.  Thread (a, c) = (tid // 8, tid % 8) owns rows a,
    31 - a, 32 + a, 63 - a and the column quads 4c and 32 + 4c; its j loop
    runs in four segments with 4, 3, 2, then 1 live rows, so it computes
    j <= i only."""
    a, c = divmod(tid, 8)
    rows = (a, 31 - a, 32 + a, MAX_Q - 1 - a)
    pairs, j0 = [], 0
    for first in range(4):
        for j in range(j0, rows[first] + 1):
            pairs.extend((rows[r], j) for r in range(first, 4))
        j0 = rows[first] + 1
    cols = [4 * c + k for k in range(4)] + [32 + 4 * c + k for k in range(4)]
    return pairs, cols


def bulk_staged(q: int, p: int, dtype: torch.dtype) -> bool:
    """Whether the kernel stages tiles with 1-D bulk copies (cum and every x
    row a 16-byte multiple; the bases are 16-byte aligned) or through
    registers."""
    isz = torch.tensor([], dtype=dtype).element_size()
    return (q * isz) % 16 == 0 and (p * isz) % 16 == 0


def _check(cum: torch.Tensor, cb: torch.Tensor, xdt: torch.Tensor):
    if cum.dim() != 2 or cb.dim() != 3 or xdt.dim() != 3:
        raise ValueError(
            f"ssd_intra_chunk: expected cum [T, Q], cb [T, Q, Q], xdt [T, Q, P], got "
            f"{tuple(cum.shape)}, {tuple(cb.shape)}, {tuple(xdt.shape)}"
        )
    t, q = cum.shape
    if tuple(cb.shape) != (t, q, q) or tuple(xdt.shape[:2]) != (t, q):
        raise ValueError(
            f"ssd_intra_chunk: shapes disagree: cum {tuple(cum.shape)}, cb {tuple(cb.shape)}, xdt {tuple(xdt.shape)}"
        )


def _decay(cum: torch.Tensor) -> torch.Tensor:
    """exp(cum_i - cum_j) where i >= j, else 0: [T, Q] -> [T, Q, Q] float32."""
    q = cum.shape[1]
    c32 = cum.float()
    tril = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    return torch.where(tril, torch.exp(c32[:, :, None] - c32[:, None, :]), 0.0)


def ssd_intra_chunk_plain(cum: torch.Tensor, cb: torch.Tensor, xdt: torch.Tensor) -> torch.Tensor:
    """Plain version: ``where(tril, exp(cum_i - cum_j), 0) * cb`` then ``@ xdt``
    in float32, cast to xdt's dtype."""
    _check(cum, cb, xdt)
    return torch.matmul(_decay(cum) * cb.float(), xdt.float()).to(xdt.dtype)


def ssd_intra_chunk(cum: torch.Tensor, cb: torch.Tensor, xdt: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD term. cum: [T, Q] (T = batch x chunks x heads tiles),
    cb: [T, Q, Q], xdt: [T, Q, P] -> y: [T, Q, P] in xdt's dtype.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (or raises).  Under autograd (grad mode on and an input that requires
    grad) the same forward runs inside :class:`_SsdIntraChunk`."""
    _check(cum, cb, xdt)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (cum, cb, xdt)):
        return _SsdIntraChunk.apply(cum, cb, xdt)
    return _intra_forward(cum, cb, xdt)


def _intra_forward(cum: torch.Tensor, cb: torch.Tensor, xdt: torch.Tensor) -> torch.Tensor:
    """The plain version on CPU tensors, else one launch of the kernel."""
    if all(a.device.type == "cpu" for a in (cum, cb, xdt)):
        return ssd_intra_chunk_plain(cum, cb, xdt)
    build.check_cuda_operands("ssd_intra_chunk", cum, cb, xdt)
    t, q = cum.shape
    p = xdt.shape[2]
    if q > MAX_Q or p > MAX_P:
        raise ValueError(f"ssd_intra_chunk kernel takes Q <= {MAX_Q} and P <= {MAX_P}, got Q {q}, P {p}")
    y = torch.empty_like(xdt)
    info = (ctypes.c_int * 2)()
    lib = build.library()
    rc = lib.tl_ssd_intra_chunk(
        build.dtype_code(xdt.dtype), cum.data_ptr(), cb.data_ptr(), xdt.data_ptr(), y.data_ptr(), t, q, p,
        ctypes.addressof(info), build.stream(xdt),
    )  # fmt: skip
    build.check(rc, "ssd_intra_chunk")
    ssd_intra_chunk.last_launch = {"route": "bulk" if info[1] else "registers", "grid": info[0], "items": t}
    ssd_intra_chunk.launches += 1
    return y


ssd_intra_chunk.launches = 0
ssd_intra_chunk.last_launch = None


def ssd_intra_chunk_backward(cum, cb, xdt, dy):
    """The intra-chunk term's gradient (dcum, dcb, dxdt) in float32 PyTorch
    ops, with G = cb * exp(cum_i - cum_j) * [i >= j] recomputed: dxdt = G^T
    dy, dG = dy xdt^T, dcb = dG * decay, dcum = rowsum(dG * G) - colsum(dG *
    G) (G_ij moves with cum_i and against cum_j).  Each gradient in its
    input's dtype.  The JAX package has no backward kernel (its training
    path differentiates the einsum form through XLA)."""
    decay = _decay(cum)
    g = decay * cb.float()
    dy32 = dy.float()
    dxdt = torch.matmul(g.transpose(1, 2), dy32)
    dg = torch.matmul(dy32, xdt.float().transpose(1, 2))
    dcb = dg * decay
    dgg = dg.mul_(g)
    dcum = dgg.sum(2) - dgg.sum(1)
    return dcum.to(cum.dtype), dcb.to(cb.dtype), dxdt.to(xdt.dtype)


class _SsdIntraChunk(torch.autograd.Function):
    """The intra-chunk term under autograd: the forward is the kernel (the
    plain version on the CPU), the backward :func:`ssd_intra_chunk_backward`
    from the saved cum, cb and xdt (no kernel launch)."""

    @staticmethod
    def forward(ctx, cum, cb, xdt):
        ctx.save_for_backward(cum, cb, xdt)
        return _intra_forward(cum, cb, xdt)

    @staticmethod
    def backward(ctx, dy):
        return ssd_intra_chunk_backward(*ctx.saved_tensors, dy)


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    a_log: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    chunk: int = 64,
    h_init: Optional[torch.Tensor] = None,
    return_state: bool = False,
    intra: str = "einsum",
):
    """Chunked SSD. x [B, L, H, P], dt [B, L, H] (positive), a_log [H],
    b/c [B, L, G, N] -> y [B, L, H, P] in x's dtype (and, with
    ``return_state``, the final state [B, H, N, P] in float32).

    ``h_init`` [B, H, N, P] continues from an earlier state.  ``intra``
    picks the intra-chunk term: the einsum form or the kernel wrapper.
    """
    if intra not in INTRA_FORMS:
        raise ValueError(f"intra must be one of {INTRA_FORMS}, got {intra!r}")
    bsz, length, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    q = min(chunk, length)
    orig_len = length
    if length % q:
        # pad to a chunk multiple with dt = 0 steps (decay 1, zero input —
        # the identity on the state), slice the output back
        pad = q - length % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        length += pad
    nc = length // q

    a = -torch.exp(a_log.float())  # [H] negative
    dt32 = dt.float()
    da = dt32 * a  # [B, L, H] per-step log-decay
    xdt = x.float() * dt32[..., None]  # dt-weighted inputs

    def chunked(t):  # [B, L, ...] -> [B, NC, Q, ...]
        return t.reshape((bsz, nc, q) + tuple(t.shape[2:]))

    cum = torch.cumsum(chunked(da), dim=2)  # [B, NC, Q, H] within-chunk cumulative
    total = cum[:, :, -1]  # [B, NC, H] chunk log-decay
    x_c = chunked(xdt)
    b_c = chunked(b.repeat_interleave(rep, dim=2).float())
    c_c = chunked(c.repeat_interleave(rep, dim=2).float())

    # ---- intra-chunk (quadratic in Q, attention-like) ----
    if intra == "kernel":
        # C_q . B_k once per group, expanded over its heads; tiles (b, chunk, head)
        scores = torch.einsum("bcqgn,bckgn->bcgqk", chunked(c.float()), chunked(b.float()))
        cb = scores.repeat_interleave(rep, dim=2).reshape(-1, q, q)
        y_intra = ssd_intra_chunk(
            cum.permute(0, 1, 3, 2).reshape(-1, q).contiguous(),
            cb.contiguous(),
            x_c.permute(0, 1, 3, 2, 4).reshape(-1, q, p).contiguous(),
        )
        y_intra = y_intra.reshape(bsz, nc, h, q, p).permute(0, 1, 3, 2, 4)
    else:
        # L[qi, qj] = exp(cum_qi - cum_qj) for qj <= qi
        diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, NC, Q, Q, H]
        mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        decay = torch.where(mask[None, None, :, :, None], torch.exp(diff), 0.0)
        scores = torch.einsum("bcqhn,bckhn->bcqkh", c_c, b_c)  # C_q . B_k
        y_intra = torch.einsum("bcqkh,bcqkh,bckhp->bcqhp", scores, decay, x_c)

    # ---- chunk states and the scan over chunks ----
    # S_c = sum_k exp(total - cum_k) B_k (x) xdt_k   [B, NC, H, N, P]
    state_decay = torch.exp(total[:, :, None, :] - cum)  # [B, NC, Q, H]
    s_c = torch.einsum("bckhn,bckh,bckhp->bchnp", b_c, state_decay, x_c)
    state = (
        torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device) if h_init is None else h_init.float()
    )
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(state)
        state = state * torch.exp(total[:, ci])[..., None, None] + s_c[:, ci]
    h_prev = torch.stack(h_prevs, dim=1)  # [B, NC, H, N, P] state entering each chunk

    # ---- inter-chunk contribution ----
    y_inter = torch.einsum("bcqhn,bcqh,bchnp->bcqhp", c_c, torch.exp(cum), h_prev)

    y = (y_intra + y_inter).reshape(bsz, length, h, p)[:, :orig_len].to(x.dtype)
    if return_state:
        return y, state
    return y
