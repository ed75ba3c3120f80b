"""95th percentile over every write request of the window, from the host
clock before the call to its prior predictions and errors on the host."""
import numpy as np


def read(run):
    lat = run.write_latency_s
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
