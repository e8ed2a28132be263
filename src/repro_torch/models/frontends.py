"""Stub modality frontends — the port of ``repro/models/frontends.py``.

The vision (paligemma) and audio (seamless-m4t) models take *precomputed*
patch / frame embeddings: no SigLIP or speech encoder runs, in the JAX
package or here.  These helpers make matching seeded embeddings and give
the prefix lengths of the JAX package's input-shape rule
(``repro/launch/specs.input_specs``): a vision prefix of
``min(256, S // 2)`` patches before ``S - prefix`` text tokens, and
``min(enc_len, audio_frames_len(S) * 8)`` encoder frames for ``S`` decoder
tokens (512 at S = 256).
"""

from __future__ import annotations

import torch

__all__ = [
    "VISION_PATCHES", "AUDIO_FRAME_STRIDE", "vision_prefix_len", "audio_frames_len", "encoder_frames",
    "stub_patch_embeddings", "stub_frame_embeddings",
]  # fmt: skip

VISION_PATCHES = 256  # SigLIP 16x16 grid stub
AUDIO_FRAME_STRIDE = 8  # speech frames per text token (stub ratio)


def vision_prefix_len(seq_len: int) -> int:
    """Image patches occupy a fixed prefix of the sequence."""
    return min(VISION_PATCHES, seq_len // 2)


def audio_frames_len(seq_len: int) -> int:
    return min(4096, max(64, seq_len // AUDIO_FRAME_STRIDE))


def encoder_frames(cfg, seq_len: int) -> int:
    """Encoder frames for ``seq_len`` decoder tokens (the JAX package's
    ``input_specs`` rule)."""
    return min(cfg.enc_len, audio_frames_len(seq_len) * AUDIO_FRAME_STRIDE)


def _normal(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (x * 0.02).to(dtype)


def stub_patch_embeddings(generator: torch.Generator, batch: int, seq_len: int, d_model: int,
                          dtype=torch.bfloat16, device=None) -> torch.Tensor:  # fmt: skip
    """Seeded patch embeddings [batch, vision_prefix_len(seq_len), d_model]."""
    return _normal((batch, vision_prefix_len(seq_len), d_model), generator, dtype, device or generator.device)


def stub_frame_embeddings(generator: torch.Generator, batch: int, enc_len: int, d_model: int,
                          dtype=torch.bfloat16, device=None) -> torch.Tensor:  # fmt: skip
    """Seeded frame embeddings [batch, enc_len, d_model]."""
    return _normal((batch, enc_len, d_model), generator, dtype, device or generator.device)
