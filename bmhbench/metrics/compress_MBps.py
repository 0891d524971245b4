"""Input bytes of every compress call completed in the window, in MB
(10^6 bytes), over the window's seconds (host clock)."""


def read(w):
    if w.direction != "compress" or not w.raw_bytes:
        return None
    return w.raw_bytes / 1e6 / w.window_s
