"""The general generator of stream traffic: ids drawn on the device from a seed.

A mix file (``traffic/<name>.json``) gives the distribution and the sizes:

  skew          the exponent s of a truncated zipf(s) over ids 1..max_id
  max_id        the largest id
  pool_items    ids drawn at set-up into one device-resident pool
  epoch_items   ids a tumbling epoch takes from the pool
  block_items   ids handed to the system in one call
  offset_align  epochs start at multiples of this many ids

The pool is drawn by inverse CDF: uniform float64 draws of a
``torch.Generator`` on the device, seeded from ``--seed``, placed by
``searchsorted`` in the CDF of the truncated law. Epoch offsets come from a
numpy generator seeded from the same seed, so a seed gives the same pool and
the same sequence of epochs; every seed gives the same sizes.
"""
from __future__ import annotations

import numpy as np
import torch

#: ids drawn per generator call while the pool is filled (bounds the
#: float64 draws and int64 indices held at once to 1 GiB)
DRAW_CHUNK = 1 << 26
#: streams of the numpy generator, one per use of the seed
OFFSETS_STREAM, SAMPLE_STREAM = 1, 2

KEYS = ("name", "runner", "distribution", "skew", "max_id", "pool_items",
        "epoch_items", "block_items", "offset_align", "why")


def validate(mix: dict) -> dict:
    """Refuse a mix whose sizes cannot be cut into whole blocks."""
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic {mix.get('name')!r} lacks {missing}")
    if mix["distribution"] != "zipf":
        raise ValueError(f"traffic {mix['name']!r}: distribution "
                         f"{mix['distribution']!r} is not 'zipf'")
    pool, epoch, block = mix["pool_items"], mix["epoch_items"], mix["block_items"]
    if not (0 < block <= epoch <= pool) or epoch % block:
        raise ValueError(f"traffic {mix['name']!r}: need 0 < block <= epoch <= "
                         f"pool and block | epoch, got {block}, {epoch}, {pool}")
    if mix["max_id"] >= 2**31 or mix["max_id"] < 1 or mix["skew"] <= 0:
        raise ValueError(f"traffic {mix['name']!r}: bad max_id or skew")
    return mix


def seed_words(seed: int) -> int:
    """A seed of any size as the 64-bit word both generators take."""
    return int(seed) % (1 << 64)


def zipf_cdf(skew: float, max_id: int, device) -> torch.Tensor:
    """The CDF of the truncated zipf(skew) law over ids 1..max_id (float64)."""
    w = torch.arange(1, max_id + 1, dtype=torch.float64, device=device).pow(-skew)
    cdf = torch.cumsum(w, 0)
    return cdf / cdf[-1]


def make_pool(mix: dict, seed: int, device, *, items: int | None = None) -> torch.Tensor:
    """``items`` (default the mix's ``pool_items``) int32 ids on ``device``."""
    n = mix["pool_items"] if items is None else items
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_words(seed))
    cdf = zipf_cdf(mix["skew"], mix["max_id"], device)
    pool = torch.empty(n, dtype=torch.int32, device=device)
    for lo in range(0, n, DRAW_CHUNK):
        hi = min(n, lo + DRAW_CHUNK)
        u = torch.rand(hi - lo, dtype=torch.float64, device=device, generator=gen)
        idx = torch.searchsorted(cdf, u, right=True)
        pool[lo:hi] = idx.clamp_(max=mix["max_id"] - 1).add_(1).to(torch.int32)
        del u, idx
    return pool


def epoch_offsets(mix: dict, seed: int, count: int) -> np.ndarray:
    """The pool offsets of the first ``count`` epochs of this seed."""
    rng = np.random.default_rng([seed_words(seed), OFFSETS_STREAM])
    align = mix["offset_align"]
    slots = (mix["pool_items"] - mix["epoch_items"]) // align + 1
    return rng.integers(0, slots, size=count, dtype=np.int64) * align


def sample_epochs(seed: int, epochs: int, count: int) -> list[int]:
    """``count`` distinct epoch indices of ``range(epochs)`` drawn from the seed."""
    rng = np.random.default_rng([seed_words(seed), SAMPLE_STREAM])
    count = min(count, epochs)
    return sorted(int(i) for i in rng.choice(epochs, size=count, replace=False))
