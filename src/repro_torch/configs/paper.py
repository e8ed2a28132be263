"""Paper Table 4 benchmark shapes (MLP / MoE / self-attention).

The port's copy of ``repro/configs/paper.py`` (the port imports nothing of
the JAX package).  ``benchmarks/paper_mlp.py`` runs ``PAPER_MLP``.
"""

# (S, H, I, source)
PAPER_MLP = {
    "MLP-1": (8192, 4096, 11008, "LLaMA-7B"),
    "MLP-2": (8192, 4096, 14336, "LLaMA-3.1-8B"),
    "MLP-3": (8192, 3584, 14336, "Gemma-2-9B"),
    "MLP-4": (8192, 4608, 36864, "Gemma-2-27B"),
    "MLP-5": (8192, 8192, 28672, "LLaMA-3.1-70B"),
    "MLP-6": (8192, 8192, 29568, "Qwen-2-72B"),
}

# (S, H, I, E, topk)
PAPER_MOE = {
    "MoE-1": (8192, 2048, 1536, 8, 2),
    "MoE-2": (8192, 2048, 1536, 32, 2),
    "MoE-3": (8192, 2048, 1536, 32, 5),
    "MoE-4": (8192, 4096, 2048, 8, 2),
    "MoE-5": (8192, 4096, 2048, 32, 2),
    "MoE-6": (8192, 4096, 2048, 32, 5),
}

# (heads, head_dim, seq_lens)
PAPER_ATTN = {
    "Attn-1": (32, 128, (16384, 32768, 65536, 131072)),
    "Attn-2": (64, 128, (16384, 32768, 65536, 131072)),
}
