"""The host's waits for the device (event synchronizes plus torch
operations that read a device tensor) per compress batch (the program's
plain and compact uploads), over the traced window."""


def read(w):
    if w.direction != "compress" or not w.spans or "event_waits" not in w.spans:
        return None
    d = w.spans["delta"]
    batches = d.get("uploads.plain", 0) + d.get("uploads.compact", 0)
    if not batches:
        return None
    return (w.spans["event_waits"] + w.spans["torch_syncs"]) / batches
