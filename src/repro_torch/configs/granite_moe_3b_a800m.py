"""granite-moe-3b-a800m [moe] — 32L d=1536 24H (GQA kv=8) expert d_ff=512,
vocab 49155, MoE 40 experts top-8, no shared experts [hf:ibm-granite].  Every
FFN is MoE (``d_ff=0``); on a TP degree of 4 each rank hosts 10 experts."""

from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=0,  # FFN is MoE-only
        vocab_size=49155,
        head_dim=64,
        rope_theta=1e4,
        pattern=("attn",),
        moe=MoEConfig(num_experts=40, top_k=8, d_expert=512),
        act="silu",
    )
)
