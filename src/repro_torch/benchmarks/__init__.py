"""Benchmarks of the port on the card (``paper_mlp``: the paper's Fig. 8 and Tab. 2)."""
