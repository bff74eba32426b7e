"""The read side: versioned QuerySnapshots and the QueryFrontend over them."""
from repro_torch.service.frontend import FrequentItemsReport, QueryFrontend
from repro_torch.service.snapshot import (LazyQuerySnapshot, QuerySnapshot,
                                          publish, publish_lazy)

__all__ = [
    "FrequentItemsReport", "LazyQuerySnapshot", "QueryFrontend",
    "QuerySnapshot", "publish", "publish_lazy",
]
