"""starcoder2-7b [dense] — 32L d=4608 36H (GQA kv=4) d_ff=18432 vocab 49152;
GQA + RoPE, GELU MLP [arXiv:2402.19173].  At a TP degree of 4 each rank
holds 9 query heads and 1 KV head of 128 (qkv shard 1408 columns)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="starcoder2-7b",
        family="dense",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        d_ff=18432,
        vocab_size=49152,
        head_dim=128,
        rope_theta=1e5,
        pattern=("attn",),
        act="gelu",
    )
)
