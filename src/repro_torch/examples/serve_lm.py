"""Batched serving example: a thin driver of ``launch/serve`` (the
continuous-batching engine over prefill-into-cache and the decode step)
with the JAX package's example defaults: reduced smollm-360m, 4 requests
of 16 prompt tokens, 24 new tokens.  Later arguments override them.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu --dtype f32]
"""

from __future__ import annotations

from repro_torch.launch import serve

DEFAULTS = ["--arch", "smollm-360m", "--reduce", "--batch", "4", "--prompt-len", "16", "--new-tokens", "24"]


def main(argv=None):
    import sys

    return serve.main(DEFAULTS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
