"""Space Saving summaries, the COMBINE operator, the exact oracle, and the
paper's Algorithm 1 over ``torch.distributed`` (``core.parallel``)."""
from repro_torch.core.parallel import (allgather_combine, block_decompose,
                                       butterfly_combine, frequent_items,
                                       hierarchical_combine, local_summaries,
                                       parallel_spacesaving)

__all__ = [
    "allgather_combine", "block_decompose", "butterfly_combine",
    "frequent_items", "hierarchical_combine", "local_summaries",
    "parallel_spacesaving",
]
