"""Space Saving kernels: plain versions (``ref``), the CUDA kernels' wrappers
(``ss_combine``, ``ss_query``, ``ss_match``, ``ss_ingest``; ``ss_match``
launches ``ss_combine``'s kernels), their build (``build``) and the dispatch
over impl names (``ops``)."""
