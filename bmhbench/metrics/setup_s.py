"""Seconds from the start of the run to its first timed call: imports,
kernel builds (a checkout's first run), inputs, warm-up and captures."""


def read(w):
    return w.setup_s
