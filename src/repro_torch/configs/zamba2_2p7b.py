"""zamba2-2.7b [hybrid] — 54L d=2560, Mamba2 mixers + shared attention blocks
(one shared-parameter attention block every 6 layers, each occurrence with
its own MLP), ssm_state=64.  [arXiv:2411.15242]"""

from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        head_dim=80,
        rope_theta=1e4,
        pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
        ssm=SSMConfig(d_state=64, headdim=64, n_groups=1, d_conv=4, expand=2),
        act="gelu",
        sub_quadratic=True,
    )
)
