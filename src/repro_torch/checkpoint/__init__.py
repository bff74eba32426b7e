"""Checkpoints of states (SketchState included), readable by either package."""
from repro_torch.checkpoint.manager import (latest_step, reshard_token_sketch,
                                            restore, save)

__all__ = ["latest_step", "reshard_token_sketch", "restore", "save"]
