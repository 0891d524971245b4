"""Bytes the program sent to the device for its compress batches
(bmh_tpu_torch/models/pipeline.UPLOADS["bytes"], its delta over the
traced window) per input byte compressed: about 1 on the plain upload,
less on the compact one, more where padding is sent."""


def read(w):
    if w.direction != "compress" or not w.spans or not w.raw_bytes:
        return None
    sent = w.spans["delta"].get("uploads.bytes")
    return None if not sent else sent / w.raw_bytes
