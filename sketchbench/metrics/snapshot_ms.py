"""Host time of the snapshot span, which starts on an idle device and is
closed by a device sync, as a mean over the traced epochs."""


def read(run):
    tr = run.trace
    if tr is None or not tr.span_count("snapshot"):
        return None
    return tr.span_host_s("snapshot") / tr.span_count("snapshot") * 1e3
