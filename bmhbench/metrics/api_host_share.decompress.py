"""Share (%) of the decompress requests' wall time spent outside the program's
backend (bmh_tpu_torch/models/pipeline.TorchBackend.decompress_blocks): the
API layer's own host work.  From the benchmark's span around each backend
call in the traced run's window."""


def read(w):
    if w.direction != "decompress" or not w.spans or "backend_s" not in w.spans:
        return None
    return 100.0 * (1.0 - w.spans["backend_s"] / sum(w.latencies_s))
