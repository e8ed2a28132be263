"""Runnable examples of the port — the counterparts of the JAX package's
``examples/``: ``quickstart`` (overlapped against non-overlapped AG+GEMM),
``moe_overlap_demo`` (the AG + MoE double ring against a dense oracle),
``serve_lm`` and ``train_lm`` (thin drivers of ``launch/serve`` and
``launch/train``).  Each runs on the card unless ``--device cpu`` is given::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
