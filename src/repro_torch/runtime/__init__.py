"""StreamRuntime — sharded two-level distributed ingestion (DESIGN.md §8)."""
from repro_torch.runtime.api import frequent_items, parallel_spacesaving
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.feed import (DeviceFeed, DeviceStager, coalesce_blocks,
                                      host_block_iter, host_blocks)
from repro_torch.runtime.runtime import StreamRuntime

__all__ = [
    "DeviceFeed", "DeviceStager", "RuntimeConfig", "StreamRuntime",
    "coalesce_blocks", "frequent_items", "host_block_iter", "host_blocks",
    "parallel_spacesaving",
]
