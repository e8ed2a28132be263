"""End-to-end training example: a thin driver of ``launch/train`` with the
JAX package's example defaults: the reduced smollm-360m family trains 200
steps of 8 x 256 tokens on the synthetic bigram corpus, and its loss
falls; ``--full`` trains the real smollm-360m config.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--full] [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.launch.train import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="train smollm-360m (reduced unless --full) on synthetic bigrams")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full", action="store_true", help="train the real smollm-360m config")
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint directory (default: no checkpoints)")
    ap.add_argument("--device", default=None, help="default: cuda (raises when absent); 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    out = train("smollm-360m", steps=args.steps, batch=args.batch, seq=args.seq, reduce=not args.full,
                ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=20, device=args.device)  # fmt: skip
    losses = [r["loss"] for r in out["history"]]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")
    return out


if __name__ == "__main__":
    main()
