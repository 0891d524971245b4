"""Card microbenchmarks: competing formulations of the hot primitives.

The twin of bmh_tpu's tools/microbench.py and tools/microbench_r5.py.
Every formulation that the port (or bmh_tpu) chose was chosen on a TPU;
this times each one in PyTorch on the card, at the production shape
(32 blocks of 128 KiB; 64 blocks of 64 KiB for `ibwt`), so that a later
change of formulation rests on a number taken where the port runs.  It
changes nothing on the main path.

    python -m bmh_tpu_torch.tools.microbench [case ...] [--reps 10]
        [--warm 5] [--seed 0]

Cases (default all):
  bitpack  the port's bitpack (two scatter-adds), its 4M-from-257 table
           gather, and a cumsum without the length lookup
  sort     a doubling round's sort: two stable passes (3 arrays, 2 keys),
           one packed int64 key stable and unstable (the port's
           ops/bwt._stable_sort3), one packed array alone, and kernel K5
  lf       the LF map: a stable sort of the byte key with the index as
           payload, the port's packed int64 sort, and a packed int32 one
  prims    cumsum (int64 and int32), random gather and scatter, 4M each
  radix    one stable pass on a 9-bit digit (int16 digits, two gathers)
  compose  the decode's gap-map scan over 16K chunks: by gather, by
           compare-select
  place    the decode's literal placement: sort then scatter, or one
           ragged scatter
  hist     257-bin histograms: a mask reduction, sort + searchsorted, and
           the port's bincount
  ibwt     the inverse BWT (LF sort + walk, kernel K4) at 64 KiB blocks,
           one row a step (BMH_LF2=0) against the composed walk
  sparse   the sparse refinement of a real text batch's tied positions
           under five two-tier shapes
  code_lengths  the code lengths of 32 histograms with every symbol
           present (256 merges a row): kernel K6 against its plain version
  mtf_forward  the MTF forward of BWT last columns of the seeded text at
           the main path's three shapes (32 x 128 KiB, 32 x 1 MiB, and a
           puts batch: 32 blocks of about 4000 bytes in 128 KiB rows):
           kernel K7 against its plain version and its bound (n bytes in
           and n out a row over 3.35 TB/s)

bmh_tpu read book1 of the Calgary corpus for `ibwt` and `sparse`; that file
is not in the repository, so both read the seeded text of utils/synth.py
("input": "synth").  Random inputs come from a seeded generator on the card.

Timing: CUDA events around each call, `--warm` untimed calls then `--reps`
timed ones, the median, less the median of a null launch (one tiny kernel
and a synchronise) taken the same way: the counterpart of bmh_tpu's
null_dispatch.  Prints ONE JSON line: per case the milliseconds of each
formulation, the one the port uses on its main path (`port_uses`), the one
bmh_tpu uses, and `equal`, the checks that formulations meant to agree do.
Runs on a card only; without one it raises.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics

import numpy as np
import torch

B, NMAX = 32, 1 << 17
CASES = ("bitpack", "sort", "lf", "prims", "radix", "compose", "place", "hist",
         "ibwt", "sparse", "code_lengths", "mtf_forward")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


class Timer:
    """Median ms of a call on the card, less the null launch's."""

    def __init__(self, reps: int, warm: int):
        self.reps, self.warm = reps, warm
        x = torch.zeros(8, dtype=torch.int32, device="cuda")
        self.base = self.raw(lambda: x.add_(1))

    def raw(self, fn) -> float:
        for _ in range(self.warm):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def __call__(self, fn) -> float:
        return max(self.raw(fn) - self.base, 0.0)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def _rand(g, hi: int, shape, dtype=torch.int64) -> torch.Tensor:
    return torch.randint(0, hi, shape, generator=g, device="cuda", dtype=dtype)


def _pos(n: int, rows: int = B) -> torch.Tensor:
    return torch.arange(n, device="cuda").expand(rows, n).contiguous()


def bench_bitpack(t: Timer, seed: int) -> dict:
    from ..ops import huffman

    g = _gen(seed)
    syms = _rand(g, 257, (B, NMAX))
    ns = torch.full((B,), NMAX - 7, device="cuda")
    lens = huffman.code_lengths_device(1 + _rand(g, 999, (B, 257)))
    codes = huffman.canonical_codes_device(lens)
    pos = _pos(NMAX)
    return {"ms": {
        "bitpack_segment_sum": t(lambda: huffman.encode_bitpack(syms, ns, lens, codes)),
        "table_gather_4M": t(lambda: torch.gather(lens, 1, syms)),
        "lenlookup_free_cumsum": t(lambda: torch.cumsum(
            torch.where(pos < ns[:, None], 1 + (syms & 15), 0), dim=1))},
        "port_uses": "bitpack_segment_sum (ops/huffman.encode_bitpack: each "
                     "code scatter-added into at most two words)",
        "bmh_tpu_uses": "bitpack_segment_sum"}


def bench_sort(t: Timer, seed: int) -> dict:
    from ..ops import bwt, sort_kernel
    from ..utils import config

    if config.DEFAULT.pallas_sort:
        raise RuntimeError("the sort case times ops/bwt._stable_sort3 with "
                           "BMH_PALLAS_SORT off; unset it")
    g = _gen(seed)
    k1, k2 = _rand(g, NMAX, (B, NMAX)), _rand(g, NMAX, (B, NMAX))
    pos = _pos(NMAX)
    k1i, k2i, posi = (x.to(torch.int32).contiguous() for x in (k1, k2, pos))

    def two_passes():  # stable by k2, then stable by k1: 3 arrays, 2 keys
        o = torch.sort(k2, dim=1, stable=True).indices
        o2 = torch.sort(torch.gather(k1, 1, o), dim=1, stable=True).indices
        return torch.gather(pos.gather(1, o), 1, o2)

    out = {"sort3_2key_stable": two_passes(),
           "sort2_1key_stable": bwt._stable_sort3(k1, k2, pos, True)[2],
           "sort3_k5": sort_kernel.sort3(k1i, k2i, posi)[2].to(torch.int64)}
    unstable = bwt._stable_sort3(k1, k2, pos, False)
    stable_keys = torch.sort((k1 << 32) + k2, dim=1).values
    return {"ms": {
        "sort3_2key_stable": t(two_passes),
        "sort2_1key_stable": t(lambda: bwt._stable_sort3(k1, k2, pos, True)),
        "sort2_1key_unstable": t(lambda: bwt._stable_sort3(k1, k2, pos, False)),
        "sort1_packed": t(lambda: torch.sort((k1 << 32) | pos, dim=1).values & 0xFFFFFFFF),
        "sort3_k5": t(lambda: sort_kernel.sort3(k1i, k2i, posi))},
        "equal": {"stable orders (two passes, packed, K5)": all(
            torch.equal(out["sort2_1key_stable"], v) for v in out.values()),
            "unstable keys": torch.equal((unstable[0] << 32) + unstable[1], stable_keys)},
        "port_uses": {"doubling rounds": "sort2_1key_unstable",
                      "finish, LF": "sort2_1key_stable",
                      "BMH_PALLAS_SORT=1, rows in 2^10..2^18": "sort3_k5"},
        "bmh_tpu_uses": "3-array 2-key lax.sort (unstable in rounds, stable at "
                        "the finish); its Pallas sort3 off by default"}


def bench_lf(t: Timer, seed: int) -> dict:
    from ..ops import bwt

    g = _gen(seed)
    last = _rand(g, 256, (B, NMAX), torch.uint8)
    n = torch.full((B,), NMAX, device="cuda")
    posi = _pos(NMAX).to(torch.int32)
    forms = {
        "lf_sort3": lambda: torch.sort(last, dim=1, stable=True).indices,
        "lf_packed": lambda: bwt._lf_map(last, n),
        "lf_packed_int32": lambda: torch.sort(
            (last.to(torch.int32) << 23) | posi, dim=1).values & ((1 << 23) - 1)}
    outs = [f().to(torch.int64) for f in forms.values()]
    return {"ms": {k: t(f) for k, f in forms.items()},
            "equal": {"LF maps": all(torch.equal(outs[0], o) for o in outs)},
            "port_uses": "lf_packed (ops/bwt._lf_map_packed: int64 keys)",
            "bmh_tpu_uses": "lf_packed (uint32 keys)"}


def bench_prims(t: Timer, seed: int) -> dict:
    g = _gen(seed)
    big = _rand(g, 1 << 30, (B, NMAX))
    big32 = big.to(torch.int32)
    idx = _rand(g, NMAX, (B, NMAX))
    return {"ms": {
        "cumsum_4M": t(lambda: torch.cumsum(big, dim=1)),
        "cumsum_4M_int32": t(lambda: torch.cumsum(big32, dim=1, dtype=torch.int32)),
        "gather_4M_random": t(lambda: torch.gather(big, 1, idx)),
        "scatter_4M_random": t(lambda: torch.zeros_like(big).scatter_(1, idx, big))},
        "port_uses": "int64 scans, gathers and scatters (ops/huffman, ops/bwt)",
        "bmh_tpu_uses": "uint32 / int32"}


def bench_radix(t: Timer, seed: int) -> dict:
    g = _gen(seed)
    keys = _rand(g, 1 << 30, (B, NMAX))
    vals = _rand(g, NMAX, (B, NMAX))

    def radix9():
        order = torch.sort((keys & 511).to(torch.int16), dim=1, stable=True).indices
        return torch.gather(keys, 1, order), torch.gather(vals, 1, order)

    return {"ms": {"radix9_one_pass": t(radix9)},
            "port_uses": None, "bmh_tpu_uses": None}


def bench_compose(t: Timer, seed: int) -> dict:
    from ..ops import huffman

    g = _gen(seed)
    nc = 16384
    maps = _rand(g, 32, (nc, 32))
    flags = torch.rand(nc, generator=g, device="cuda") < 0.002
    g_iota = torch.arange(32, device="cuda")

    def select(ea, lb):
        return torch.where(ea[:, :, None] == g_iota, lb[:, None, :], 0).sum(-1)

    forms = {"compose_16K_gather": lambda: huffman._seg_scan(
                 maps, flags, lambda ea, lb: torch.gather(lb, 1, ea)),
             "compose_16K_select": lambda: huffman._seg_scan(maps, flags, select)}
    outs = [f() for f in forms.values()]
    return {"ms": {k: t(f) for k, f in forms.items()},
            "equal": {"composed maps": torch.equal(*outs)},
            "port_uses": "compose_16K_gather (ops/huffman._decode_phases)",
            "bmh_tpu_uses": "compose_16K_select"}


def bench_place(t: Timer, seed: int) -> dict:
    g = _gen(seed)
    cap = B * NMAX
    steps = 8718336 // 4  # literal lanes of a corpus pass, as bmh_tpu's
    tgt = torch.randperm(cap, generator=g, device="cuda")[:steps].sort().values
    lanes = torch.cat([(tgt << 9) | 7,
                       torch.full((2 * steps,), 0xFFFFFFFF, device="cuda")])
    lanes = lanes[torch.randperm(lanes.numel(), generator=g, device="cuda")]

    def place_sort():
        srt = torch.sort(lanes).values[:cap]
        out = torch.zeros(cap + 1, dtype=torch.uint8, device="cuda")
        out[(srt >> 9).clamp(max=cap)] = (srt & 511).to(torch.uint8)
        return out[:cap]

    def place_scatter():
        out = torch.zeros(cap + 1, dtype=torch.uint8, device="cuda")
        out[torch.where(lanes == 0xFFFFFFFF, cap, lanes >> 9)] = (lanes & 511).to(torch.uint8)
        return out[:cap]

    return {"ms": {"place_sort_sorted_scatter": t(place_sort),
                   "place_ragged_scatter": t(place_scatter)},
            "equal": {"placed bytes": torch.equal(place_sort(), place_scatter())},
            "port_uses": "place_ragged_scatter (ops/huffman.gap_decode_rle0_flat; "
                         "BMH_DECODE_PLACE is accepted, not read)",
            "bmh_tpu_uses": "place_sort_sorted_scatter (BMH_DECODE_PLACE=sort)"}


def bench_hist(t: Timer, seed: int) -> dict:
    from ..ops import huffman, rle

    g = _gen(seed)
    a = rle.RLE_ALPHABET
    syms = _rand(g, a, (B, NMAX))
    ns = torch.full((B,), NMAX - 9, device="cuda")
    pos = _pos(NMAX)
    bins = torch.arange(a, device="cuda")

    def masked():
        return torch.where(pos < ns[:, None], syms, a)

    def hist_sort():
        srt = torch.sort(masked(), dim=1).values
        edges = torch.searchsorted(
            srt, torch.arange(a + 1, device="cuda").repeat(B, 1))
        return torch.diff(edges, dim=1)

    forms = {"hist_mask": lambda: (masked()[:, None, :] == bins[None, :, None]).sum(-1),
             "hist_sort": hist_sort,
             "hist_bincount": lambda: huffman.histogram(syms, ns, a)}
    outs = [f() for f in forms.values()]
    return {"ms": {k: t(f) for k, f in forms.items()},
            "equal": {"histograms": all(torch.equal(outs[0], o) for o in outs)},
            "port_uses": "hist_bincount (ops/huffman.histogram)",
            "bmh_tpu_uses": "hist_sort"}


def bench_ibwt(t: Timer, seed: int) -> dict:
    from ..ops import bwt
    from ..utils import config, synth

    b, nmax = 64, 1 << 16
    text = np.frombuffer(synth.smoke_input(seed, text_bytes=b * nmax, random_bytes=0),
                         np.uint8).reshape(b, nmax)
    data = torch.from_numpy(text.copy()).cuda()
    n = torch.full((b,), nmax, device="cuda")
    stride = config.DEFAULT.cursor_stride
    last, shift, cps, aper = bwt.bwt_forward_cp(data, n, stride)
    if not bool(aper.all()):
        raise RuntimeError("the synthetic text batch has a periodic block")
    ms, equal, old = {}, {}, config.DEFAULT.lf2
    try:
        for name, flag in (("ibwt_lf1", False), ("ibwt_lf2", True)):
            config.DEFAULT.lf2 = flag
            equal[f"{name} gives the blocks back"] = torch.equal(
                bwt.bwt_inverse_cursors(last, shift, cps, n, stride), data)
            ms[name] = t(lambda: bwt.bwt_inverse_cursors(last, shift, cps, n, stride))
    finally:
        config.DEFAULT.lf2 = old
    return {"ms": ms, "equal": equal, "shape": [b, nmax],
            "port_uses": "ibwt_lf2 (BMH_LF2=1: kernel K4 over 16-step row links)",
            "bmh_tpu_uses": "ibwt_lf2 (BMH_LF2=1: two-step LF2 entries at 64 KiB)"}


def bench_sparse(t: Timer, seed: int) -> dict:
    from .. import api
    from ..models import pipeline
    from ..ops import bwt
    from ..utils import config, synth

    cfg = config.DEFAULT
    text = np.frombuffer(synth.smoke_input(seed, text_bytes=B * NMAX,
                                           random_bytes=0), np.uint8)
    raw = [text[i:i + NMAX] for i in range(0, text.size, NMAX)]
    blocks = [x for x in api._rle1_blocks(raw)[0]
              if not pipeline._looks_pathological(x)][:B]
    batch = np.zeros((B, NMAX), np.uint8)
    for i, x in enumerate(blocks):
        batch[i, : x.size] = x
    data = torch.from_numpy(batch).cuda()
    n = torch.tensor([x.size for x in blocks], device="cuda")
    h0 = 1 << (cfg.full_rounds + 1)
    rank, tied, _, _ = bwt.bwt_rounds(data, n, h0)
    m_true, m_cap = int(tied.sum()), pipeline._sparse_cap(B, NMAX)
    if m_true > m_cap:
        raise RuntimeError(f"{m_true} tied positions exceed the compact set {m_cap}")
    ms, ranks, old = {}, [], (cfg.tier1_rounds, cfg.tier2_div)
    try:
        for t1, t2d in ((2, 4), (1, 4), (2, 8), (1, 2), (3, 8)):
            cfg.tier1_rounds, cfg.tier2_div = t1, t2d
            ranks.append(pipeline._sparse_refine_compact(rank, tied, n, m_cap, h0))
            ms[f"sparse_t1={t1}_t2d={t2d}"] = t(
                lambda: pipeline._sparse_refine_compact(rank, tied, n, m_cap, h0))
    finally:
        cfg.tier1_rounds, cfg.tier2_div = old
    return {"ms": ms, "sparse_tied": m_true, "sparse_cap": m_cap,
            "equal": {"refined ranks": all(torch.equal(ranks[0], r) for r in ranks)},
            "port_uses": f"sparse_t1={old[0]}_t2d={old[1]} (BMH_TIER1_ROUNDS, BMH_TIER2_DIV)",
            "bmh_tpu_uses": "sparse_t1=2_t2d=4"}


def bench_code_lengths(t: Timer, seed: int) -> dict:
    from ..ops import huffman

    freqs = 1 + _rand(_gen(seed), 999, (B, 257))
    forms = {"code_lengths_k6": lambda: huffman.code_lengths_device(freqs),
             "code_lengths_plain": lambda: huffman.code_lengths_plain(freqs)}
    outs = [f() for f in forms.values()]
    return {"ms": {k: t(f) for k, f in forms.items()},
            "equal": {"code lengths (K6, plain)": torch.equal(*outs)},
            "port_uses": "code_lengths_k6 (ops/huffman.code_lengths_device on a card)",
            "bmh_tpu_uses": "a lax.scan of 256 merge steps (no Pallas kernel)"}


def mtf_inputs(seed: int) -> dict:
    """The MTF forward's inputs on the main path's three shapes, by label:
    (last, n), the BWT last columns (ops/bwt.bwt_forward_cp) of rows of the
    seeded text of utils/synth.py.  The puts rows hold 3997-4000 bytes of
    it each, zero past n, as the compact upload's inflate leaves them."""
    from ..ops import bwt
    from ..utils import config, synth

    out = {}
    for label, nmax, short in (("32x128k", NMAX, False), ("32x1m", 1 << 20, False),
                               ("puts_32x128k", NMAX, True)):
        text = synth.smoke_input(seed, text_bytes=B * nmax, random_bytes=0)
        batch = np.frombuffer(text[: B * nmax], np.uint8).reshape(B, nmax).copy()
        n = np.full(B, nmax, dtype=np.int64)
        if short:
            n = 3997 + np.random.default_rng(seed).integers(0, 4, B)
            batch[np.arange(nmax)[None, :] >= n[:, None]] = 0
        nt = torch.from_numpy(n).cuda()
        last = bwt.bwt_forward_cp(torch.from_numpy(batch).cuda(), nt,
                                  config.DEFAULT.cursor_stride)[0]
        out[label] = (last, nt)
    return out


def bench_mtf_forward(t: Timer, seed: int) -> dict:
    from ..ops import mtf
    from ..utils import config

    chunk = config.DEFAULT.mtf_chunk
    ms, bound, equal = {}, {}, {}
    for label, (last, n) in mtf_inputs(seed).items():
        forms = {"k7": functools.partial(mtf.mtf_forward, last, n, chunk),
                 "plain": functools.partial(mtf.mtf_forward_plain, last, n, chunk)}
        equal[f"codes {label} (K7, plain)"] = torch.equal(*(f() for f in forms.values()))
        for form, f in forms.items():
            ms[f"mtf_forward_{form}_{label}"] = t(f)
        bound[label] = 2 * int(n.sum()) / PEAK_BYTES_PER_S * 1e3
    return {"ms": ms, "bound_ms": bound, "equal": equal,
            "port_uses": "mtf_forward_k7 (ops/mtf.mtf_forward on a card)",
            "bmh_tpu_uses": "jnp ops: a windowed compare over each 128-byte chunk "
                            "extended by its incoming list (no Pallas kernel)"}


BENCHES = {name: globals()[f"bench_{name}"] for name in CASES}


def run(cases=CASES, reps: int = 10, warm: int = 5, seed: int = 0) -> dict:
    """Time the given cases on the card; returns the JSON record."""
    unknown = set(cases) - set(CASES)
    if unknown:
        raise ValueError(f"unknown cases {sorted(unknown)}; known: {CASES}")
    if not torch.cuda.is_available():
        raise RuntimeError("the microbenchmarks time the card: no CUDA device")
    from ..bench import card_line

    torch.cuda.set_device(0)
    t = Timer(reps, warm)
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": card_line(),
           "input": "synth", "seed": seed, "shape": [B, NMAX], "reps": reps,
           "warm": warm, "timing": "CUDA events, median of reps less null_launch_ms",
           "null_launch_ms": t.base, "cases": {}}
    for name in cases:
        res["cases"][name] = BENCHES[name](t, seed)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*", metavar="case",
                    help=f"any of {' '.join(CASES)} (default all)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.cases or CASES, args.reps, args.warm, args.seed)))


if __name__ == "__main__":
    main()
