"""Host time of the two report calls (the k-majority report and the top-n
list, copied to the host), as a mean over the traced epochs."""


def read(run):
    tr = run.trace
    if tr is None or not tr.span_count("report"):
        return None
    return tr.span_host_s("report") / tr.span_count("report") * 1e3
