"""gemma3-27b [dense] — 62L d=5376 32H (GQA kv=16) d_ff=21504 vocab 262144;
a 5:1 pattern of local (sliding window 1024, RoPE theta 1e4) and global
(theta 1e6) attention layers, tied embeddings scaled by sqrt(d_model), GELU
MLP [hf:google/gemma-3].  sub_quadratic: the local layers keep O(window) KV
in decode (a ring cache of 1024 slots)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_ff=21504,
        vocab_size=262144,
        head_dim=128,
        rope_theta=1e6,
        rope_theta_local=1e4,
        local_window=1024,
        pattern=("attn_local",) * 5 + ("attn",),
        act="gelu",
        tie_embeddings=True,
        sub_quadratic=True,
        embed_scale=True,
    )
)
