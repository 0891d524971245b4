"""Share (%) of their roofline that the decode kernels K1-K4 reach over
the traced run's profiled requests: the least time of the work they had
(work.decode_work: the bytes of the containers' real sizes, each read and
written once, over the card's bandwidth), summed over the kernel groups
the trace shows, over the profiler's time of those groups' kernels."""

from bmhbench import work


def read(w):
    p = w.profile
    if w.direction != "decompress" or not p or "decode_work" not in p:
        return None
    spent: dict = {}
    for name, s in p["device_by_name"].items():
        g = work.kernel_of(name)
        if g is not None:
            spent[g] = spent.get(g, 0.0) + s
    least = work.least_seconds({g: p["decode_work"][g] for g in spent}, w.card)
    if not spent or least is None:
        return None
    return 100.0 * least / sum(spent.values())
