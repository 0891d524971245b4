"""RLE1 of the raw blocks and RLE0 of the MTF stream.

RLE1 (`rle1_encode`): the pre-BWT run collapse of csrc/bmh_io.cpp's
bmh_rle1_encode (utils/nativeio.py), on a compress batch: kernel K8
(csrc/rle1_encode.cu) on a card, the plain version for a CPU tensor.  A row
takes its encoding only where that is strictly shorter than the row.

RLE0, port of bmh_tpu/ops/rle.py.  Maximal runs of MTF code 0 become their
length in bijective base 2 over RUNA=0 / RUNB=1 (digits LSB-first); every
non-zero code c becomes symbol c+1, so the Huffman alphabet is 257.  The
main decode path fuses the inverse into the gap decode (ops/huffman.py);
`rle0_decode` / `rle0_decoded_len` serve the periodic and single-symbol
routes.

Batched: (B, Nmax) rows with per-row true lengths.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

RLE_ALPHABET = 257
MAX_LOG = 26  # run digits past this cannot occur below the 2^21 block cap
RLE1_GROUP = 255  # input bytes an RLE1 group "v v v v (take - 4)" stands for at most
_K8_SRC = "rle1_encode.cu"
_K8_LANE = 1024  # bytes a K8 lane scans


def rle1_encode(data: torch.Tensor, n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """RLE1 of each row: data (B, Nmax) uint8, first n[b] bytes real ->
    ((B, Nmax) uint8 rows, (B,) int64 lengths).  A row whose encoding is
    strictly shorter than n becomes the encoding, zero past it, and its
    length the encoding's; any other row stays itself, zero past n, at
    length n.  Kernel K8 for a CUDA tensor (one call, no host read), the
    plain version for a CPU tensor."""
    if not _build.on_card(data, "rle1_encode"):
        return rle1_encode_plain(data, n)
    if (data.dim() != 2 or data.dtype != torch.uint8 or not data.is_contiguous()
            or n.shape != data.shape[:1] or n.device != data.device
            or n.dtype != torch.int64 or not n.is_contiguous()):
        raise ValueError(f"rle1_encode: needs contiguous uint8 (B, Nmax) data and "
                         f"contiguous (B,) int64 lengths on its card, got {data.dtype} "
                         f"{tuple(data.shape)} strides {data.stride()}, n {n.dtype} "
                         f"{tuple(n.shape)} on {n.device}")
    b, nmax = data.shape
    rows = torch.empty((b, nmax), dtype=torch.uint8, device=data.device)
    n_out = torch.empty((b,), dtype=torch.int64, device=data.device)
    if b == 0 or nmax == 0:
        return rows, n_out.copy_(n)
    lanes = -(-nmax // _K8_LANE)
    scratch = torch.empty((b * lanes, 4), dtype=torch.int32, device=data.device)
    fn = _build.lib(_K8_SRC).bmh_rle1_encode_rows
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.count_launch("rle1_encode")
    with _build.on_device(data) as stream:
        _build.check(fn(data.data_ptr(), n.data_ptr(), scratch.data_ptr(), rows.data_ptr(),
                        n_out.data_ptr(), b, nmax, lanes, stream), "rle1_encode")
    return rows, n_out


def rle1_encode_plain(data: torch.Tensor, n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """rle1_encode in tensor operations, on any device.

    Every byte emits by its offset w = (i - run start) % 255 alone: one
    byte (itself) at w < 3, two at w = 3 (itself and the group's count),
    none at w >= 4, so the output offsets are a running sum.  The group's
    count, take - 4, is known at its last byte (the run's last, or w = 254)
    and lands where the w = 3 byte's pair ends."""
    b, nmax = data.shape
    dev = data.device
    pos = torch.arange(nmax, device=dev).expand(b, nmax)
    nn = n.clamp(0, nmax)
    valid = pos < nn[:, None]
    x = data.to(torch.int64)
    edge = torch.nn.functional.pad(x[:, :-1], (1, 0), value=-1) != x
    start = torch.cummax(torch.where(edge, pos, 0), dim=1).values
    w = (pos - start) % RLE1_GROUP
    emit = torch.where(valid, (w < 3).to(torch.int64) + 2 * (w == 3), 0)
    off = torch.cumsum(emit, 1) - emit
    m = emit.sum(1)
    nxt = torch.nn.functional.pad(x[:, 1:], (0, 1), value=-1)
    last = valid & ((pos + 1 >= nn[:, None]) | (nxt != x) | (w == RLE1_GROUP - 1)) & (w >= 3)
    # every write lands below m <= 5/4 n + 1; the column past 2 * nmax takes
    # the writes that are not made
    drop = 2 * nmax + 1
    enc = torch.zeros((b, drop + 1), dtype=torch.int64, device=dev)
    enc.scatter_(1, torch.where(emit > 0, off, drop), x)
    enc.scatter_(1, torch.where(last, torch.where(w == 3, off + 1, off - 1), drop), w - 3)
    shrink = m < nn
    rows = torch.where(shrink[:, None], enc[:, :nmax].to(torch.uint8),
                       torch.where(valid, data, 0).to(torch.uint8))
    return rows, torch.where(shrink, m, n)


def _floor_log2_p1(r: torch.Tensor) -> torch.Tensor:
    """floor(log2(r+1)) for 0 <= r < 2^24-1, elementwise: the float32
    exponent of r+1, exact because every value below 2^24 is representable."""
    rp = r + 1
    exp = (rp.to(torch.float32).view(torch.int32) >> 23) - 127
    return torch.where(rp > 0, exp.to(r.dtype), torch.zeros_like(r))


def rle0_encode(codes: torch.Tensor, n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """MTF codes -> RLE0 symbols.

    codes: (B, Nmax) uint8, first n[b] valid in row b.  Returns (syms
    (B, Nmax) int64 in [0, 256], zero past m; m (B,) int64 symbol counts).
    """
    b, nmax = codes.shape
    dev = codes.device
    pos = torch.arange(nmax, device=dev).expand(b, nmax)
    valid = pos < n[:, None]
    c = codes.to(torch.int64)
    z = (c == 0) & valid
    z_prev = torch.nn.functional.pad(z[:, :-1], (1, 0))
    run_start = z & ~z_prev
    start_pos = torch.cummax(torch.where(run_start, pos, -1), dim=1).values
    # next non-zero-or-invalid position at/after i (runs end at n too)
    nz_pos = torch.where(~z, pos, nmax)
    nxt = torch.flip(torch.cummin(torch.flip(nz_pos, [1]), dim=1).values, [1])

    r = nxt - start_pos            # run length, valid on zero positions
    j = pos - start_pos            # index within the run
    d = _floor_log2_p1(r)          # digit count
    bits = r + 1 - (1 << d)
    digit = (bits >> j.clamp(min=0, max=62)) & 1

    emit = valid & torch.where(z, j < d, torch.ones_like(z))
    sym = torch.where(z, digit, c + 1)
    out_idx = torch.cumsum(emit.to(torch.int64), dim=1) - emit.to(torch.int64)
    m = emit.sum(dim=1)
    out = torch.zeros(b, nmax + 1, dtype=torch.int64, device=dev)
    out.scatter_(1, torch.where(emit, out_idx, nmax), sym * emit)
    return out[:, :nmax], m


def _contributions(syms: torch.Tensor, m: torch.Tensor):
    """Per symbol, the decoded bytes it stands for: 1 for a literal,
    (1 + digit) << j for the j-th digit of a zero run.  Returns
    (contributions (B, N) int64, literal mask, symbols int64)."""
    b, nmax = syms.shape
    pos = torch.arange(nmax, device=syms.device).expand(b, nmax)
    valid = pos < m[:, None]
    s = syms.to(torch.int64)
    isrun = (s <= 1) & valid
    grp_start = isrun & ~torch.nn.functional.pad(isrun[:, :-1], (1, 0))
    start_pos = torch.cummax(torch.where(grp_start, pos, -1), dim=1).values
    j = (pos - start_pos).clamp(0, MAX_LOG)
    contrib = torch.where(isrun, (1 + s) << j, valid.to(torch.int64))
    return contrib, valid & ~isrun, s


def rle0_decoded_len(syms: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Exact decoded length of each row's RLE0 stream (its first m[b]
    symbols), (B,) int64.

    The integrity check of the routes that decode RLE0 apart from the gap
    decode: a container whose rle_len or payload lies decodes to a total
    != the block length, and the caller fails closed.  bmh_tpu sums in
    int32 and poisons a wrapped sum; here every contribution is at most
    2 << MAX_LOG and a row has at most 2^21 symbols, so the int64 sum is
    exact and the total itself is the signal."""
    return _contributions(syms, m)[0].sum(dim=1)


def rle0_decode(syms: torch.Tensor, m: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """RLE0 symbols -> MTF codes.

    syms (B, Nmax) in [0, 256], first m[b] valid; n (B,) decoded lengths.
    Returns (B, Nmax) uint8: literals placed at their decoded positions,
    runs left as the zero fill."""
    b, nmax = syms.shape
    contrib, lit, s = _contributions(syms, m)
    out_pos = torch.cumsum(contrib, dim=1) - contrib  # exclusive
    target = torch.where(lit & (out_pos < n[:, None]), out_pos, nmax)
    out = torch.zeros(b, nmax + 1, dtype=torch.int64, device=syms.device)
    out.scatter_(1, target, torch.where(lit, s - 1, 0))
    return out[:, :nmax].to(torch.uint8)
