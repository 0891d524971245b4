"""The one traffic generator: a cell's pool of requests, from its
configuration's data parameters and its mix's request shape.

A mix (traffic/<name>.json) gives `direction` (compress or decompress),
`items_per_request`, `pool_requests` (distinct requests, cycled in order by
one closed-loop client), `check_blocks` (blocks the reference checks a
run) and `trace_requests` (requests under the profiler in a traced run).
The configuration's `data` names a generator (generators/<kind>.py) and
its parameters."""

from __future__ import annotations

from . import generators


def pool(config: dict, mix: dict, seed: int) -> list[list[bytes]]:
    """pool_requests requests of items_per_request items each, from the
    seed."""
    data = dict(config["data"])
    gen = generators.find(data.pop("generator"))
    per, n = int(mix["items_per_request"]), int(mix["pool_requests"])
    items = gen.make(seed, per * n, **data)
    return [items[i * per:(i + 1) * per] for i in range(n)]
