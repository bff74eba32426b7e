"""Device fingerprinting and plan-cache paths — the counterpart of
``repro.plan.fingerprint``.

A plan is only valid for the hardware it was measured on, so the cache is
keyed by a *device fingerprint*: the device type, the card's name and
compute capability (or the CPU's architecture) and torch's major.minor
version, for example ``cuda-nvidia-h100-80gb-hbm3-sm90-torch2.11`` or
``cpu-x86-64-torch2.13``. One torch process reaches two device types, so
every lookup names the device it is for; the fingerprint's first word is
that device type (:func:`device_type`).

The port keeps its own cache, apart from the JAX package's: a JAX plan
names impls (``pallas``, ``jnp``) the port does not have. Cache location:

  $REPRO_TORCH_PLAN_CACHE        explicit cache directory
  ~/.cache/repro_torch/plans     default
"""
from __future__ import annotations

import functools
import os
import platform
import re
from pathlib import Path

import torch


def _slug(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9.]+", "-", s.strip()).strip("-").lower()


@functools.cache
def _fingerprint(dev_type: str, index: int | None) -> str:
    version = ".".join(torch.__version__.split("+")[0].split(".")[:2])
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_fingerprint: no CUDA card is available")
        major, minor = torch.cuda.get_device_capability(index)
        parts = ("cuda", torch.cuda.get_device_name(index), f"sm{major}{minor}")
    elif dev_type == "cpu":
        parts = ("cpu", platform.machine() or "unknown")
    else:
        raise ValueError(f"device_fingerprint: no plans for device type {dev_type!r}")
    return "-".join(_slug(p) for p in (*parts, f"torch{version}"))


def device_fingerprint(device="cuda") -> str:
    """Stable id of (device type, card or CPU, torch major.minor).

    Computed once per device: resolution asks for it at every lookup.
    """
    dev = torch.device(device)
    return _fingerprint(dev.type, dev.index if dev.type == "cuda" else None)


def device_type(fingerprint: str) -> str:
    """The device type a fingerprint names (``'cuda'`` or ``'cpu'``)."""
    return fingerprint.split("-", 1)[0]


def cache_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_PLAN_CACHE")
    if env:
        return Path(env)
    return Path(os.path.expanduser("~")) / ".cache" / "repro_torch" / "plans"


def plan_path(fingerprint: str, directory: os.PathLike | str | None = None) -> Path:
    """Where the cached plan for ``fingerprint`` lives."""
    d = Path(directory) if directory is not None else cache_dir()
    return d / f"plan-{fingerprint}.json"
