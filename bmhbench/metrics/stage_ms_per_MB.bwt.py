"""Card time (ms) of the compress programs' `bwt` stage, the BWT (doubling
rounds, handoff and sparse refinement, or the full rounds; the last column
and checkpoints), per MB of input bytes, over the traced window: the delta
of the program's counter programs.STATS["stage_ms.bwt"] (timing events where
the stage starts and ends in each replay, so idle gaps inside the stage
count). None where the program keeps no such counter."""


def read(w):
    if w.direction != "compress" or not w.spans or not w.raw_bytes:
        return None
    ms = w.spans["delta"].get("programs.stage_ms.bwt")
    return None if not ms else ms / (w.raw_bytes / 1e6)
