"""The share of the traced sub-window in which no device operation (kernel,
copy or set) runs, from the union of the profiler's device intervals."""


def read(run):
    tr = run.trace
    w = None if tr is None else tr.window_s()
    if not w or not tr.ops:
        return None
    return (1 - tr.busy_s() / w) * 100
