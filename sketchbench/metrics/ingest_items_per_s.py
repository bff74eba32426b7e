"""Items handed to ``ingest`` in the window over the whole window (host clock).

The window closes once the last epoch's report is on the host."""


def read(run):
    r = run.record
    return r["items"] / r["window_s"] if r["window_s"] > 0 else None
