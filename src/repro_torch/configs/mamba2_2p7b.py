"""mamba2-2.7b [ssm] — 64L d=2560 attention-free, ssm_state=128, SSD
[arXiv:2405.21060].  No attention and no FFN: the paper's AG+GEMM / GEMM+RS
overlap covers the Mamba mixer's in/out projections."""

from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        pattern=("mamba",),
        ssm=SSMConfig(d_state=128, headdim=64, n_groups=1, d_conv=4, expand=2),
        act="silu",
        tie_embeddings=True,
        sub_quadratic=True,
    )
)
