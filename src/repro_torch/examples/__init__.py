"""The examples of ``examples/``, on the port: ``python -m
repro_torch.examples.<name> [--device cpu]``. Each takes the JAX script's
sizes and defaults and runs on the card unless ``--device cpu`` is given."""
import torch


def check_device(device: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass --device cpu")
    return device
