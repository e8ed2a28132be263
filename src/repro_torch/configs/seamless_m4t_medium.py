"""seamless-m4t-medium [audio] — encoder-decoder, 12-layer encoder + 12-layer
decoder, d=1024 16H (kv=16) of 64, d_ff=4096 (ReLU), vocab 256206; the speech
frontend is a stub (precomputed frame embeddings, ``models/frontends``).
[arXiv:2308.11596]"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="seamless-m4t-medium",
        family="audio",
        n_layers=12,
        encoder_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        head_dim=64,
        rope_theta=1e4,
        pattern=("attn",),
        frontend="audio",
        act="relu",
        enc_len=4096,
    )
)
