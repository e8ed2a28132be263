"""smollm-360m [dense] — 32L d=960 15H (GQA kv=5) d_ff=2560 vocab 49152,
tied embeddings; llama-architecture small model [hf:HuggingFaceTB].  The
awkward 15q/5kv GQA on a TP degree of 4 is realised by the GQALayout padding
(16 q / 8 kv heads, pads held at zero) of ``nn/layers.gqa_layout``."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="smollm-360m",
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        head_dim=64,
        rope_theta=1e4,
        pattern=("attn",),
        act="silu",
        tie_embeddings=True,
    )
)
