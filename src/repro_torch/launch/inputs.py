"""``meta``-tensor input stand-ins for every (arch × shape) cell.

The counterpart of ``repro.launch.inputs``: the JAX package's
``ShapeDtypeStruct`` stand-ins are tensors on the ``meta`` device here,
shapes and dtypes with nothing allocated. The modality frontends are stubs
as there: whisper gets precomputed frame embeddings, qwen2-vl precomputed
patch embeddings and M-RoPE position ids. :func:`materialize` turns the
stand-ins into real (random or zero) tensors for smoke runs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_shapes(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    cdt = getattr(torch, cfg.compute_dtype)
    batch = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = _meta((b, cfg.enc_dec.n_frames, cfg.d_model), cdt)
    if cfg.vlm is not None:
        batch["vision_embeds"] = _meta((b, cfg.vlm.n_patches, cfg.d_model), cdt)
        batch["positions"] = _meta((3, b, s), torch.int32)
    return batch


def prefill_batch_shapes(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    return train_batch_shapes(cfg, shape)


def decode_input_shapes(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The decode step's inputs: one token a row and the cache (the port's
    ``cache_shapes``)."""
    from repro_torch.models.model import cache_shapes
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _meta((b, 1), torch.int32), "cache": cache_shapes(cfg, b, s)}


def materialize(shapes, generator: torch.Generator | None = None,
                vocab: int | None = None):
    """Real tensors for a tree (dicts) of ``meta`` stand-ins, on the
    generator's device (default: a CPU generator seeded with 0): int32
    leaves uniform in [0, ``vocab`` or 1000), float leaves N(0, 1)·0.02
    drawn in f32 and cast."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    device = generator.device

    def one(s):
        if isinstance(s, dict):
            return {k: one(v) for k, v in s.items()}
        if s.dtype == torch.int32:
            return torch.randint(0, vocab or 1000, tuple(s.shape), generator=generator,
                                 dtype=torch.int32, device=device)
        draw = torch.randn(tuple(s.shape), generator=generator, dtype=torch.float32,
                           device=device)
        return draw.to(s.dtype) * 0.02

    return one(shapes)
