"""qwen2-72b [dense] — 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab 152064;
GQA with a QKV bias [arXiv:2407.10671].  (The paper's Table 4 MLP-6 shape.)
At a TP degree of 4 each rank holds 16 query and 2 KV heads of 128: a qkv
shard of 2560 columns with its 2560-wide bias, a gate|up shard of 14784."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen2-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1e6,
        pattern=("attn",),
        act="silu",
    )
)
