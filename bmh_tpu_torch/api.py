"""compress/decompress API, with bmh_tpu/api.py's signatures plus `device`.

`device` defaults to "cuda", where the hand-written kernels run: every
visible card; "cuda:N" pins card N.  Without a card "cuda" raises
RuntimeError instead of carrying on on the CPU.  `device="cpu"` runs the
same pipeline with the kernels' plain PyTorch versions (the tests'
setting).  A list of devices (["cpu"] * 4) fans the batches out over its
entries.  Of several devices the backend keeps the first BMH_DEVICES (0 =
all, as in bmh_tpu).  `backend` is "torch" (the batched codec of
models/pipeline.py) or "oracle" (the sequential NumPy judge of
models/oracle.py, to which `device` does not apply).
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import container, nativeio
from .utils.config import DEFAULT as CONFIG
from .utils.tracing import annotate

DEFAULT_BLOCK_SIZE = CONFIG.block_size
MAX_BLOCK_SIZE = 1 << 21  # CodecConfig.validate's bound (code lengths <= 31)


def _validate_block_size(block_size: int) -> None:
    """Fail fast: the device primitives assume blocks <= 2 MiB (23-bit
    packed positions, exact float32 log2 below 2^24, 5-bit code lengths)."""
    if not 1 <= block_size <= MAX_BLOCK_SIZE:
        raise ValueError(
            f"block_size {block_size} out of range [1, {MAX_BLOCK_SIZE}]")


def _resolve_devices(device) -> list[torch.device]:
    """The devices a backend fans out over: a bare "cuda" is every visible
    card (TorchBackend keeps the first BMH_DEVICES); "cuda:N" is card N;
    "cpu" is one CPU device; a list or tuple, each of its entries in
    turn."""
    if isinstance(device, (list, tuple)):
        return [d for entry in device for d in _resolve_devices(entry)]
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu":
        return [dev]
    count = torch.cuda.device_count()
    if dev.index is not None:
        if dev.index >= count:
            raise ValueError(f"no card {dev}: {count} visible")
        return [dev]
    return [torch.device("cuda", i) for i in range(count)]


class OracleBackend:
    """Sequential NumPy backend: the correctness judge, not a hot path."""

    name = "oracle"

    def compress_blocks(self, blocks: list[np.ndarray], stride: int) -> list[dict]:
        """The blocks are raw: each takes RLE1 on the host where that
        strictly shrinks it (unless BMH_RLE1=0), as the torch backend's do
        on the card."""
        from .models import oracle

        if CONFIG.rle1:
            blocks = [nativeio.rle1_encode(b) for b in blocks]
        results = [oracle.compress_block(b, stride) for b in blocks]
        for r in results:
            r["present"] = r["freqs"] > 0
        return results

    def decompress_blocks(self, blocks: list[dict]) -> list[np.ndarray]:
        from .models import oracle

        out = []
        for b in blocks:
            present = np.asarray(b["present"])
            single = int(np.nonzero(present)[0][0]) if int(present.sum()) == 1 else None
            out.append(oracle.decompress_block(b["payload"], b["lens"], b["shift"],
                                               b["orig_len"], b["rle_len"],
                                               single_symbol=single))
        return out


def get_backend(name: str, device="cuda"):
    """"torch" on `device`, or "oracle" (which takes no device)."""
    if name == "oracle":
        return OracleBackend()
    if name != "torch":
        raise ValueError(f"unknown backend {name!r}")
    from .models.pipeline import TorchBackend

    return TorchBackend(_resolve_devices(device))


def _as_array(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


def _rle1_restore(part: np.ndarray, raw_len: int) -> np.ndarray:
    if part.size == raw_len:
        return part
    return nativeio.rle1_decode(part, raw_len)


def _pack_block(r: dict, raw_len: int) -> bytes:
    """One backend result as a container block."""
    return container.pack_block(raw_len, r["shift"], r["lens"], r["present"],
                                r["payload"], cps=r["cps"], rle_len=r["rle_len"],
                                pre_len=r["orig_len"])


def _pack(results, raw_lens, block_size: int, total: int, stride: int) -> bytes:
    packed = [_pack_block(r, raw_len) for r, raw_len in zip(results, raw_lens)]
    return container.pack_file(packed, block_size, total, stride=stride)


def compress_bytes(data, block_size: int = DEFAULT_BLOCK_SIZE,
                   backend: str = "torch", device="cuda") -> bytes:
    return compress_many([data], block_size, backend, device=device)[0]


def compress_many(datas: list, block_size: int = DEFAULT_BLOCK_SIZE,
                  backend: str = "torch", uniform: bool = False,
                  device="cuda") -> list[bytes]:
    """Compress several independent streams in one batched backend call;
    uniform=True pads every block of the torch backend to the block_size
    bucket."""
    with annotate("api.compress", "api"):
        _validate_block_size(block_size)
        be = get_backend(backend, device)
        stride = CONFIG.cursor_stride
        arrs = [_as_array(d) for d in datas]
        with annotate("api.split", "api"):
            split = [container.split_blocks(arr, block_size) for arr in arrs]
        flat_blocks: list[np.ndarray] = []
        spans = []
        for raw_blocks in split:
            spans.append((len(flat_blocks), len(raw_blocks)))
            flat_blocks.extend(raw_blocks)
        flat_raw = [b.size for b in flat_blocks]
        if uniform and be.name == "torch":
            from .models.pipeline import _bucket

            results = be.compress_blocks(flat_blocks, stride, bucket=_bucket(block_size))
        else:
            results = be.compress_blocks(flat_blocks, stride)
        with annotate("api.pack", "api"):
            return [_pack(results[s:s + c], flat_raw[s:s + c], block_size, arr.size,
                          stride)
                    for arr, (s, c) in zip(arrs, spans)]


def _validate_block_info(orig_len: int, pre_len: int, rle_len: int,
                         cps, lens: np.ndarray, present: np.ndarray,
                         payload: bytes, block_size: int, stride: int,
                         shift: int = 0) -> None:
    """Cross-field consistency checks on an unpacked block (bmh_tpu's,
    unchanged): the CRC proves only that the bytes are the writer's; a
    hostile writer can stamp a fresh CRC over inconsistent fields.  A
    payload that decodes to the wrong total is caught later by the decoded
    totals the device returns."""
    if orig_len == 0:
        return
    if orig_len > block_size:
        raise ValueError(f"corrupt block: orig_len {orig_len} exceeds "
                         f"block_size {block_size}")
    if not 1 <= pre_len <= orig_len:
        raise ValueError(f"corrupt block: pre_len {pre_len} outside "
                         f"[1, {orig_len}]")
    if not 1 <= rle_len <= pre_len:
        raise ValueError(f"corrupt block: rle_len {rle_len} outside "
                         f"[1, {pre_len}]")
    npres = int(present.sum())
    if npres == 0:
        raise ValueError("corrupt block: no symbols present")
    if not 0 <= shift < pre_len:
        raise ValueError(f"corrupt block: bwt shift {shift} outside "
                         f"[0, {pre_len})")
    if cps is not None:
        want = max(-(-pre_len // stride) - 1, 0)
        if len(cps) != want:
            raise ValueError(f"corrupt block: {len(cps)} checkpoints, "
                             f"expected {want}")
        cc = np.asarray(cps)
        if cc.size and (int(cc.min()) < 0 or int(cc.max()) >= pre_len):
            raise ValueError("corrupt block: checkpoint out of range")
    plens = lens[present]
    if npres == 1:
        if int(plens[0]) != 0 or payload:
            raise ValueError("corrupt block: single-symbol block must have "
                             "length 0 and empty payload")
        s = int(np.nonzero(present)[0][0])
        want = (1 + s) * ((1 << min(rle_len, 40)) - 1) if s <= 1 else rle_len
        if want != pre_len:
            raise ValueError(
                f"corrupt block: single-symbol stream of {rle_len} x "
                f"symbol {s} decodes to {want} bytes, expected {pre_len}")
        return
    if (plens == 0).any():
        raise ValueError("corrupt block: present symbol with code length 0")
    if int(np.sum(1 << (31 - plens.astype(np.int64)))) != (1 << 31):
        raise ValueError("corrupt block: code lengths violate Kraft equality")
    if len(payload) * 8 < rle_len * int(plens.min()):
        raise ValueError("corrupt block: payload shorter than rle_len "
                         "symbols can occupy")


def _unpack(buf: bytes) -> tuple:
    """Container -> (block_size, total size, cursor stride, each block's
    fields as container.unpack_block gives them), read but not checked."""
    block_size, total, raw_blocks = container.unpack_file(buf)
    stride = container.file_stride(buf)
    return block_size, total, stride, [container.unpack_block(raw) for raw in raw_blocks]


def _validate(unpacked: tuple):
    """_unpack's result, validated -> (block infos, raw lengths, total
    size, block_size)."""
    block_size, total, stride, blocks = unpacked
    # the decode side applies the codec envelope too: a hostile header
    # claiming a multi-GB block_size must not reach device allocation
    _validate_block_size(block_size)
    infos, raw_lens = [], []
    for orig_len, shift, lens, present, cps, rle_len, payload, pre_len in blocks:
        _validate_block_info(orig_len, pre_len, rle_len, cps, lens, present,
                             payload, block_size, stride, shift)
        raw_lens.append(orig_len)
        infos.append({"orig_len": pre_len, "shift": shift, "lens": lens,
                      "present": present, "cps": cps, "rle_len": rle_len,
                      "payload": payload, "stride": stride})
    return infos, raw_lens, total, block_size


def _parse(buf: bytes):
    """Container -> (block infos, raw lengths, total size, block_size),
    validated."""
    return _validate(_unpack(buf))


def decompress_bytes(buf: bytes, backend: str = "torch", device="cuda") -> bytes:
    return decompress_many([buf], backend, device=device)[0]


def decompress_many(bufs: list[bytes], backend: str = "torch",
                    uniform: bool = False, device="cuda") -> list[bytes]:
    """Decompress several .bzt containers in one batched backend call."""
    with annotate("api.decompress", "api"):
        be = get_backend(backend, device)
        with annotate("api.parse", "api"):
            unpacked = [_unpack(buf) for buf in bufs]
        infos: list[dict] = []
        raw_lens: list[int] = []
        spans = []
        max_block = 0
        with annotate("api.validate", "api"):
            for u in unpacked:
                inf, rl, total, bs = _validate(u)
                max_block = max(max_block, bs)
                spans.append((len(infos), len(inf), total))
                infos.extend(inf)
                raw_lens.extend(rl)
        if not infos:
            parts = []
        elif uniform and be.name == "torch":
            from .models.pipeline import _bucket

            parts = be.decompress_blocks(infos, bucket=_bucket(max_block))
        else:
            parts = be.decompress_blocks(infos)
        with annotate("api.restore", "api"):
            restored = [_rle1_restore(p, rl) for p, rl in zip(parts, raw_lens)]
        with annotate("api.join", "api"):
            out = []
            for start, cnt, total in spans:
                data = b"".join(r.tobytes() for r in restored[start:start + cnt])
                if len(data) != total:
                    raise ValueError(f"decoded {len(data)} bytes, expected {total}")
                out.append(data)
            return out


def compress_file(in_path: str, out_path: str, block_size: int = DEFAULT_BLOCK_SIZE,
                  backend: str = "torch", device="cuda") -> dict:
    with open(in_path, "rb") as f:
        data = f.read()
    blob = compress_bytes(data, block_size=block_size, backend=backend,
                          device=device)
    with open(out_path, "wb") as f:
        f.write(blob)
    return {"initial_data_size": len(data), "encoded_file_size": len(blob),
            "header_size": container.header_bytes(blob)}


def decompress_file(in_path: str, out_path: str, backend: str = "torch",
                    device="cuda") -> dict:
    with open(in_path, "rb") as f:
        blob = f.read()
    data = decompress_bytes(blob, backend=backend, device=device)
    with open(out_path, "wb") as f:
        f.write(data)
    return {"encoded_file_size": len(blob), "decoded_size": len(data)}


def full_pipeline(in_path: str, enc_path: str, dec_path: str,
                  block_size: int = DEFAULT_BLOCK_SIZE, backend: str = "torch",
                  device="cuda") -> bool:
    """Compress then decompress through the files on disk; returns whether
    the decoded file equals the input bit for bit."""
    compress_file(in_path, enc_path, block_size=block_size, backend=backend,
                  device=device)
    decompress_file(enc_path, dec_path, backend=backend, device=device)
    with open(in_path, "rb") as f1, open(dec_path, "rb") as f2:
        return f1.read() == f2.read()
