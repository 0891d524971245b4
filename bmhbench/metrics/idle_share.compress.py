"""Share (%) of the profiled compress requests' wall time in which no operation
ran on the device: 1 - busy / window, busy the union of device spans."""


def read(w):
    p = w.profile
    if w.direction != "compress" or not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
