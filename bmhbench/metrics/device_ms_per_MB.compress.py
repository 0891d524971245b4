"""Device time (ms, every kernel, copy and fill summed over streams) per
MB of input bytes, over the traced run's profiled requests."""


def read(w):
    p = w.profile
    if w.direction != "compress" or not p or not p["device_s"]:
        return None
    return p["device_s"] * 1e3 / (p["raw_bytes"] / 1e6)
