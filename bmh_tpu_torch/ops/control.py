"""Device control flow for the batch programs: bmh_tpu's lax.while_loop.

`while_loop(cond, body, state, max_trips)` runs `state = body(*state)`
while `cond(*state)`, a 0-dim bool tensor, holds; `state` is a tuple of
tensors whose shapes and types the body keeps, and `max_trips` bounds the
rounds any input can need (every loop of the programs doubles a gap that
stops at the block size).  Run as it is (on the CPU, or in a card's
warm-up run) it reads the predicate once a round and raises past the
bound.  While models/programs.py captures a program, its runner takes
over and turns the loop into graphs (see there).
"""

from __future__ import annotations

import threading

import torch

_local = threading.local()


def while_loop(cond, body, state: tuple, max_trips: int):
    runner = getattr(_local, "runner", None)
    if runner is not None:
        return runner.while_loop(cond, body, tuple(state), max_trips)
    state = tuple(state)
    trips = 0
    while bool(cond(*state)):
        if trips == max_trips:
            raise RuntimeError(f"while_loop: more than its bound of {max_trips} rounds")
        state = tuple(body(*state))
        trips += 1
    return state


def doublings(h, cap: int) -> int:
    """Rounds a gap h (an int, or a tensor taken as >= 1) doubles in before
    it reaches `cap`: the bound of a loop that runs while h < cap."""
    h = h if isinstance(h, int) else 1
    trips = 0
    while h < cap:
        h *= 2
        trips += 1
    return trips


def set_runner(runner) -> None:
    """Install (or, with None, remove) the capture runner of this thread."""
    _local.runner = runner


def scalar(v, device, dtype=torch.int64) -> torch.Tensor:
    """A 0-dim tensor on `device`: `v` itself if it is one, else a fill (a
    kernel, where torch.tensor would copy from the host, which a capture
    refuses)."""
    if torch.is_tensor(v):
        return v.to(dtype)
    return torch.full((), v, dtype=dtype, device=device)
