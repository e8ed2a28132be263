"""deepseek-moe-16b [moe] — 28L d=2048 16H (kv=16) head_dim 128, vocab 102400;
64 fine-grained routed experts top-6 (d_expert 1408) plus 2 shared experts,
the first layer a dense MLP (d_ff 10944) [arXiv:2401.06066].  On a TP degree
of 4 each rank hosts 16 routed experts and a quarter of the shared MLP."""

from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=0,  # the MoE layers' FFN; the dense first layer takes dense_d_ff
        vocab_size=102400,
        head_dim=128,
        rope_theta=1e4,
        pattern=("attn",),
        moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2, first_k_dense=1, dense_d_ff=10944),
        act="silu",
    )
)
