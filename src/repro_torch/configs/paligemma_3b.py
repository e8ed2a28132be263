"""paligemma-3b [vlm] — 18L d=2048 8H of 256 (MQA kv=1), d_ff=16384 (GELU),
vocab 257216, tied embeddings scaled by sqrt(d_model) over the whole input
(image prefix included); the SigLIP frontend is a stub (precomputed patch
embeddings, ``models/frontends``).  [arXiv:2407.07726]"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        d_ff=16384,
        vocab_size=257216,
        head_dim=256,
        rope_theta=1e4,
        pattern=("attn",),
        frontend="vision",
        act="gelu",
        tie_embeddings=True,
        embed_scale=True,
    )
)
