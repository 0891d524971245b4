"""Card time (ms) of the compress programs' `rle1` stage, the RLE1 of the
raw blocks (kernel K8), per MB of input bytes, over the traced window: the
delta of the program's counter programs.STATS["stage_ms.rle1"] (timing
events where the stage starts and ends in each replay).  None where the
program keeps no such counter, or runs RLE1 on the host."""


def read(w):
    if w.direction != "compress" or not w.spans or not w.raw_bytes:
        return None
    ms = w.spans["delta"].get("programs.stage_ms.rle1")
    return None if not ms else ms / (w.raw_bytes / 1e6)
