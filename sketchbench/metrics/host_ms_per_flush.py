"""Host time inside the harness's ingest spans over the flushes reckoned from
the shapes (items handed ÷ lanes · window), in the traced sub-window."""


def read(run):
    tr, cfg = run.trace, run.config
    if tr is None or not tr.span_count("ingest"):
        return None
    flushes = run.record["traced_items"] / (cfg["lanes"] * cfg["chunk"] * cfg["buffer_depth"])
    return tr.span_host_s("ingest") / flushes * 1e3
