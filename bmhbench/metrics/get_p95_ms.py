"""95th percentile of the latencies of all decompress requests in the
window, in ms (numpy's linear interpolation)."""

import numpy as np


def read(w):
    if w.direction != "decompress" or not w.latencies_s:
        return None
    return float(np.percentile(w.latencies_s, 95)) * 1e3
