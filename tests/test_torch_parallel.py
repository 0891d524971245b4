"""The port's dispatch layer on the CPU, held against bmh_tpu: the bounded
in-flight window (BMH_INFLIGHT) and the fan-out over several devices with
LAST_DISPATCH (tests/test_torch_distributed.py has the process layer).

Containers of the port and of bmh_tpu are compared byte for byte on
inputs made from a seed with numpy.  The backend dispatches every batch
on the calling thread."""

import sys
import threading

import numpy as np
import pytest
import torch

import bmh_tpu
import bmh_tpu_torch as bt
from bmh_tpu_torch import api as tapi
from bmh_tpu_torch.models import pipeline as tpipe
from bmh_tpu_torch.ops import _build
from bmh_tpu_torch.parallel import distributed as tdist
from bmh_tpu_torch.utils import config as tconfig
from bmh_tpu_torch.utils import container as tcont

BS = 8192


def _text(rng, n):
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9))) for _ in range(300)]
    return b" ".join(words[i] for i in rng.integers(0, 300, n // 3))[:n]


def _mixed_stream():
    """Six 8 KiB text blocks (flat route), one block of a tiled 64-byte
    motif (periodic route, pathological batch) and a last block of three
    zero bytes (single-symbol route)."""
    rng = np.random.default_rng(606)
    motif = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    return _text(rng, 6 * BS) + motif * (BS // 64) + b"\x00" * 3


MIXED = _mixed_stream()


@pytest.fixture(scope="module")
def mixed_ref():
    ref = bmh_tpu.compress_bytes(MIXED, block_size=BS)
    routes = [tcont.unpack_block(r) for r in tcont.unpack_file(ref)[2]]
    assert sum(r[4] is None and r[0] > 4096 for r in routes) == 1  # periodic
    assert int(np.asarray(routes[-1][3]).sum()) == 1  # single-symbol
    return ref


@pytest.fixture
def knobs(monkeypatch):
    """Set config.DEFAULT fields for one test."""
    def set_(**kw):
        for k, v in kw.items():
            monkeypatch.setattr(tconfig.DEFAULT, k, v)
    return set_


# --- the window --------------------------------------------------------------

@pytest.mark.parametrize("inflight", [1, 2, 4])
def test_window_containers_equal_bmh_tpu(mixed_ref, knobs, inflight):
    """One block a dispatch: 8 compress and 7 decompress batches, more than
    the window holds at every depth."""
    knobs(max_dispatch=1, inflight=inflight)
    got = bt.compress_bytes(MIXED, block_size=BS, device="cpu")
    assert got == mixed_ref
    assert tpipe.LAST_DISPATCH["compress_ndev"] == 1
    assert bt.decompress_bytes(got, device="cpu") == MIXED
    assert bt.decompress_many([got, mixed_ref], uniform=True,
                              device="cpu") == [MIXED, MIXED]


def test_window_over_several_devices(mixed_ref, knobs):
    """Several devices in the window: each batch's parts dispatched on the
    calling thread, drains in order; the containers equal bmh_tpu's."""
    knobs(max_dispatch=1, inflight=3)
    assert bt.compress_bytes(MIXED, block_size=BS, device=["cpu"] * 3) == mixed_ref
    assert bt.decompress_bytes(mixed_ref, device=["cpu"] * 3) == MIXED
    knobs(max_dispatch=8)
    assert bt.compress_bytes(MIXED, block_size=BS, device=["cpu"] * 4) == mixed_ref
    assert tpipe.LAST_DISPATCH["compress_ndev"] == 2


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_run_window_order_and_depth(depth):
    """Drains run in submission order on the calling thread, and no more
    than `depth` batches wait between dispatch and drain."""
    waiting, seen = [], []
    caller = threading.current_thread()

    def dispatch(k):
        def fn(dev):
            assert threading.current_thread() is caller
            return tpipe._HostCopy(torch.full((3,), k)), k
        return fn

    def batches():
        for k in range(9):
            waiting.append(k)
            assert len(waiting) <= depth + 1
            yield k, [(torch.device("cpu"), f"b{k}", dispatch(k))]

    def drain(key, parts):
        assert threading.current_thread() is caller
        assert waiting.pop(0) == key and parts[0][1] == key
        assert parts[0][0].wait().tolist() == [key] * 3
        seen.append(key)

    tpipe._run_window(batches(), drain, depth)
    assert seen == list(range(9)) and not waiting


class _WatchedCopy(tpipe._HostCopy):
    """A host copy that records the copies the window waited for."""
    waited: list = []

    def wait(self):
        _WatchedCopy.waited.append(int(self.host[0]))
        return super().wait()


@pytest.mark.parametrize("where", ["dispatch", "drain"])
def test_run_window_error_stops_every_worker(where):
    """An error in a dispatch or in a drain propagates after every copy
    started has been waited for; later batches are neither dispatched nor
    drained."""
    started, drained = [], []
    _WatchedCopy.waited = []

    def dispatch(k):
        def fn(dev):
            started.append(k)
            if where == "dispatch" and k == 5:
                raise ValueError("dispatch 5 failed")
            return _WatchedCopy(torch.full((2,), k)), k
        return fn

    def drain(key, parts):
        parts[0][0].wait()
        if where == "drain" and key == 3:
            raise ValueError("drain 3 failed")
        drained.append(key)

    batches = ((k, [(torch.device("cpu"), "b", dispatch(k)),
                    (torch.device("cpu"), "b", dispatch(k))])
               for k in range(40))
    with pytest.raises(ValueError, match=f"{where} (3|5) failed"):
        tpipe._run_window(batches, drain, 2)
    if where == "dispatch":
        # batches 0-2 drained, 3 and 4 in flight, 5's first part started
        assert drained == [0, 1, 2] and started == [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5]
        assert set(_WatchedCopy.waited) == {0, 1, 2, 3, 4}
    else:
        # 3's drain failed with 4 and 5 dispatched
        assert drained == [0, 1, 2] and max(started) == 5
        assert set(_WatchedCopy.waited) == {0, 1, 2, 3, 4, 5}


def _lying_rle_len(blob: bytes, idx: int) -> bytes:
    """Re-pack block idx with rle_len - 3 and a fresh CRC."""
    bs, total, raws = tcont.unpack_file(blob)
    (orig_len, shift, lens, present, cps, rle_len, payload,
     pre_len) = tcont.unpack_block(raws[idx])
    raws[idx] = tcont.pack_block(orig_len, shift, lens, present, payload,
                                 cps=cps, rle_len=rle_len - 3, pre_len=pre_len)
    return tcont.pack_file(raws, bs, total, stride=tcont.file_stride(blob))


@pytest.mark.parametrize("idx", [2, 6], ids=["flat", "periodic"])
def test_hostile_container_same_error_at_every_depth(mixed_ref, knobs, idx):
    """A lying rle_len raises the same ValueError at inflight 1 and 4, over
    two devices, and through decompress_stream; at inflight 4 the later
    batches are in flight when it does."""
    bad = _lying_rle_len(mixed_ref, idx)
    errors = []
    for inflight in (1, 4):
        knobs(max_dispatch=4, inflight=inflight)
        with pytest.raises(ValueError, match="corrupt") as e:
            bt.decompress_bytes(bad, device="cpu")
        errors.append(str(e.value))
    with pytest.raises(ValueError, match="corrupt") as e:
        bt.decompress_bytes(bad, device=["cpu"] * 2)
    errors.append(str(e.value))
    with pytest.raises(ValueError, match="corrupt") as e:
        tdist.decompress_stream(bad, bt.get_backend("torch", "cpu"))
    errors.append(str(e.value))
    assert len(set(errors)) == 1 and f"block {idx}'s" in errors[0]


# --- the fan-out ---------------------------------------------------------------

@pytest.mark.parametrize("b_pad,n_devices,cap,want", [
    (32, 4, 0, 4), (2, 4, 0, 2), (4, 3, 0, 2), (8, 8, 2, 2), (8, 4, 1, 1),
    (1, 4, 0, 1), (16, 1, 0, 1)])
def test_ndev_for(knobs, b_pad, n_devices, cap, want):
    """The largest power of two <= min(devices the backend keeps under the
    BMH_DEVICES cap, b_pad)."""
    knobs(devices=cap)
    be = tpipe.TorchBackend([torch.device("cpu")] * n_devices)
    assert tpipe._ndev_for(b_pad, len(be.devices)) == want


def test_fanout_over_four_cpu_devices(knobs):
    """Compress dispatches split their rows over 4 devices (2 for a batch
    of b_pad 2); decompress goes round-robin over them; the containers
    equal bmh_tpu's."""
    cpu4 = [torch.device("cpu")] * 4
    text = MIXED[: 4 * BS]
    knobs(max_dispatch=4)
    ref = bmh_tpu.compress_bytes(text, block_size=BS)
    assert bt.compress_bytes(text, block_size=BS, device=cpu4) == ref
    assert tpipe.LAST_DISPATCH["compress_ndev"] == 4
    assert bt.compress_bytes(text[: 2 * BS], block_size=BS, device=cpu4) == \
        bmh_tpu.compress_bytes(text[: 2 * BS], block_size=BS)
    assert tpipe.LAST_DISPATCH["compress_ndev"] == 2
    knobs(max_dispatch=1)
    assert bt.decompress_bytes(ref, device=["cpu"] * 4) == text
    assert tpipe.LAST_DISPATCH["decompress_ndev"] == 4
    knobs(devices=2)
    assert bt.decompress_bytes(ref, device=cpu4) == text
    assert tpipe.LAST_DISPATCH["decompress_ndev"] == 2


def test_fanout_every_route(mixed_ref, knobs):
    """Every route through the fan-out: 6 text blocks split 2 rows a
    device, the pathological and the single-symbol batch (b_pad 2) over 2
    devices, one of which has only padding and gets no work."""
    knobs(max_dispatch=8)
    got = bt.compress_bytes(MIXED, block_size=BS, device=["cpu"] * 4)
    assert got == mixed_ref
    assert bt.decompress_bytes(got, device=["cpu"] * 3) == MIXED


def test_device_strings(knobs):
    cpu = torch.device("cpu")
    assert tapi._resolve_devices("cpu") == [cpu]
    assert tapi._resolve_devices(["cpu", cpu]) == [cpu, cpu]
    assert bt.get_backend("torch", ("cpu",) * 3).devices == [cpu] * 3
    with pytest.raises(ValueError):
        tapi._resolve_devices("meta")
    with pytest.raises(ValueError):
        tpipe.TorchBackend([])


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in ("cuda", "cuda:1", ["cpu", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapi._resolve_devices(dev)


def test_cuda_strings_map_to_cards(knobs, monkeypatch):
    """A bare "cuda" is every visible card capped by BMH_DEVICES; "cuda:N"
    pins one (the card count is faked: nothing is launched)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert tapi._resolve_devices("cuda") == cards
    knobs(devices=2)
    assert bt.get_backend("torch", "cuda").devices == cards[:2]
    assert bt.get_backend("torch", "cuda:3").devices == [cards[3]]
    with pytest.raises(ValueError, match="no card"):
        tapi._resolve_devices("cuda:4")


def test_launch_counter_under_threads():
    """count_launch loses no update with 32 threads and a short switch
    interval."""
    before = _build.LAUNCHES["imtf_chunks"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [_build.count_launch("imtf_chunks")
                                               for _ in range(2000)])
              for _ in range(32)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert _build.LAUNCHES["imtf_chunks"] - before == 64000
    _build.LAUNCHES["imtf_chunks"] = before
