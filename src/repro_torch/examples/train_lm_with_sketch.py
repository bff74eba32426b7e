"""End-to-end driver: train a small LM for a few hundred steps with the
Space Saving token sketch integrated in every step.

The counterpart of ``examples/train_lm_with_sketch.py``: it wraps the
launcher (``launch/train.main``), so checkpointing, resume, sketch merges
and the final exact-oracle validation all engage, on the card unless
``--device cpu`` is given. Reduce ``--steps`` for a faster demo.

  PYTHONPATH=src python -m repro_torch.examples.train_lm_with_sketch [--steps 200]
"""
import sys

from repro_torch.launch.train import main as train_main

DEFAULTS = ["--arch", "mamba2-130m", "--smoke", "--steps", "200", "--batch", "8",
            "--seq", "256", "--ckpt-every", "50", "--merge-every", "25",
            "--log-every", "10", "--ckpt-dir", "checkpoints/example", "--device", "cuda"]


def main(argv=None):
    return train_main(DEFAULTS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
