"""The process's set-up before the window (host clock): imports, the device's
context, the kernels' build or load, the pool and one warm-up epoch."""


def read(run):
    return run.record["setup_s"]
