"""Accuracy-evaluation harness of the port (the paper's experimental section)."""
from repro_torch.eval.accuracy import (SKEWS, check_record, evaluate_cell,
                                       run_cell, run_sweep)

__all__ = ["SKEWS", "check_record", "evaluate_cell", "run_cell", "run_sweep"]
