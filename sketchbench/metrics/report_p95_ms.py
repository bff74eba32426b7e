"""The 95th percentile over every epoch of the window of the time from the
host handing over the epoch's last block to its report being on the host
(host clock; numpy's linear percentile)."""
import numpy as np


def read(run):
    lat = run.record["latencies_s"]
    return float(np.percentile(np.asarray(lat), 95)) * 1e3 if lat else None
