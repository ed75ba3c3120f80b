"""95th percentile over every read request of the window, from the host
clock before the call to its predictions on the host."""
import numpy as np


def read(run):
    lat = run.read_latency_s
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
