"""Serve a small model with batched requests: prefill + decode loop, KV
cache management, and hot-token Space Saving telemetry, emitted as
structured obs events, with the metrics registry dumped on exit.

The counterpart of ``examples/serve_decode.py``: ``launch/serve.main``
with its defaults, on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]
"""
import sys

from repro_torch.launch.serve import main as serve_main

DEFAULTS = ["--arch", "qwen2.5-14b", "--smoke", "--batch", "4", "--prompt-len", "64",
            "--gen", "32", "--report-every", "16", "--metrics-dump", "--device", "cuda"]


def main(argv=None):
    return serve_main(DEFAULTS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
