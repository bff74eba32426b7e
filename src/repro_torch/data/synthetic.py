"""Synthetic data, numpy only: zipf streams (the paper's input
distribution) and LM token batches drawn from the same family.

A copy of ``repro.data.synthetic``: the same seed gives the same ids and
the same batches, so that both packages are fed one stream. The paper
evaluates on zipf(1.1)/zipf(1.8) streams (Table I); natural-language token
frequencies are zipfian too, which is why a Space Saving token sketch is a
sensible telemetry feature of the LM path. ``TokenStream`` carries an
explicit (seed, step) cursor, so the pipeline is checkpointable and
exactly resumable.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def fold_ids(ids: np.ndarray, max_id: int, mode: str = "mod") -> np.ndarray:
    """Map 1-based item ids above ``max_id`` back into [1, max_id].

    ``'mod'``  — ``(x-1) % max_id + 1``: spreads the tail mass across the
    whole id range, so head frequencies stay faithful to the zipf law.
    ``'clip'`` — ``min(x, max_id)``: piles all tail mass onto ``max_id``,
    kept only to reproduce the older streams bit for bit.
    """
    if mode == "mod":
        return (ids - 1) % max_id + 1
    if mode == "clip":
        return np.minimum(ids, max_id)
    raise ValueError(f"fold mode {mode!r} not in ('mod', 'clip')")


def zipf_stream(n: int, skew: float, seed: int = 0,
                max_id: int | None = None, fold: str = "mod") -> np.ndarray:
    """n zipf(skew) item ids (int32, ≥ 1), folded into [1, max_id]."""
    rng = np.random.default_rng(seed)
    out = rng.zipf(skew, size=n)
    # rng.zipf returns int64 and at low skew exceeds int32 with real
    # probability, so an uncapped stream still folds before the int32 cast.
    cap = max_id if max_id is not None else np.iinfo(np.int32).max
    return fold_ids(out, cap, fold).astype(np.int32)


@dataclasses.dataclass
class DataState:
    """Checkpointable pipeline cursor."""
    seed: int
    step: int

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class TokenStream:
    """Deterministic, resumable synthetic LM batches.

    Each step derives its own PRNG from (seed, step): resuming from a
    checkpoint at step k reproduces exactly the batches k, k+1, ... with no
    replay of the first k.
    """

    def __init__(self, vocab: int, batch: int, seq: int, skew: float = 1.1,
                 state: DataState | None = None):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.skew = skew
        self.state = state or DataState(seed=1234, step=0)

    def next(self) -> dict:
        rng = np.random.default_rng((self.state.seed, self.state.step))
        toks = rng.zipf(self.skew, size=(self.batch, self.seq + 1))
        # mod-fold (not clip) so the hot-token telemetry the serving path
        # sketches is not dominated by a fake heavy hitter at vocab-1
        toks = fold_ids(toks, self.vocab - 1, "mod").astype(np.int32)
        self.state = DataState(self.state.seed, self.state.step + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def extras(self, cfg) -> dict:
        """Stub modality inputs (whisper frames / vlm patches)."""
        rng = np.random.default_rng((self.state.seed, self.state.step, 7))
        out = {}
        if cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (self.batch, cfg.enc_dec.n_frames, cfg.d_model)).astype(
                np.float32) * 0.02
        if cfg.vlm is not None:
            out["vision_embeds"] = rng.standard_normal(
                (self.batch, cfg.vlm.n_patches, cfg.d_model)).astype(
                np.float32) * 0.02
            pos = np.broadcast_to(np.arange(self.seq)[None, None],
                                  (3, self.batch, self.seq))
            out["positions"] = pos.astype(np.int32)
        return out
