"""The program layer (models/programs.py) and the sync-free programs it
runs, against bmh_tpu on the CPU.

(a) the cache key: every knob a program reads changes it, the same shape
    and knobs hit the cache;
(b) code_lengths_device's fixed 256-step loop equals bmh_tpu's on seeded
    histograms, down to a 25-bit code;
(c) sparse_ranks with the handoff's tie total and the resume choice on the
    device writes bmh_tpu's containers at three BMH_SPARSE_CAP_DIVs;
(d) the bucketed staging and the static row compaction decode bmh_tpu's
    containers, ragged rows and a padded batch included;
(e) the periodic and single-symbol programs decode bmh_tpu's containers,
    padded as on a card, and the padding changes no real row;
(f) the sharded stage and step of one maker hit their keys on a second
    call, on a one-process gloo group.
The programs also run under a torch-function mode that fails on any read
of a tensor's value by the host other than a while_loop's predicate, so
nothing in them would wait for a card.  Integers compare exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import bmh_tpu
from bmh_tpu.models import pipeline as jpipe
from bmh_tpu.ops import huffman as jhuf
import bmh_tpu_torch as bt
from bmh_tpu_torch.models import pipeline as tpipe
from bmh_tpu_torch.models import programs
from bmh_tpu_torch.ops import bwt as tbwt
from bmh_tpu_torch.ops import control
from bmh_tpu_torch.ops import huffman as thuf
from bmh_tpu_torch.utils import config as tconfig
from bmh_tpu_torch.utils import synth

BLOCK = 4096


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the padded decode below runs the plain K1 and
    K2 over 1024 chunks, whose many small parallel ops crawl where several
    test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def knobs(monkeypatch):
    def set_(**kw):
        for k, v in kw.items():
            monkeypatch.setattr(tconfig.DEFAULT, k, v)
    return set_


# --- (a) the key ------------------------------------------------------------

FLIPS = {"mtf_chunk": 64, "imtf_chunk": 512, "full_rounds": 3,
         "sparse_cap_div": 8, "tier1_rounds": 1, "tier2_div": 2,
         "pallas_sort": True, "pallas_decode": False, "pallas_imtf": False,
         "lf2": False, "decode_place": "scatter", "min_bucket": 512,
         "debug_sparse": True}


def test_flips_cover_every_knob():
    assert set(FLIPS) == set(programs.KNOBS)


@pytest.mark.parametrize("knob", sorted(FLIPS))
def test_every_knob_changes_the_key(knobs, knob):
    shape = dict(b_pad=4, nmax=BLOCK, nc=1024, chunk_bits=512, maxl=16, stride=4096)
    before = programs.key("decode_flat", **shape)
    assert programs.key("decode_flat", **shape) == before
    assert getattr(tconfig.DEFAULT, knob) != FLIPS[knob]
    knobs(**{knob: FLIPS[knob]})
    assert programs.key("decode_flat", **shape) != before


def test_same_shape_and_knobs_hit_the_cache():
    """Two compresses and two decodes of one shape: the second of each hits;
    another block size misses."""
    data = bytes(synth.smoke_input(3, text_bytes=3 * BLOCK, random_bytes=0))
    programs.clear()
    programs.reset_stats()
    blob = bt.compress_bytes(data, block_size=BLOCK, device="cpu")
    assert bt.compress_bytes(data, block_size=BLOCK, device="cpu") == blob
    assert bt.decompress_bytes(blob, device="cpu") == data
    assert bt.decompress_bytes(blob, device="cpu") == data
    assert programs.STATS["runs"] == 4 and programs.STATS["hits"] == 2
    bt.compress_bytes(data[: 2 * BLOCK], block_size=2 * BLOCK, device="cpu")
    assert programs.STATS["runs"] == 5 and programs.STATS["hits"] == 2


# --- (b) the fixed-trip code lengths ----------------------------------------

@pytest.mark.parametrize("case", ["one", "two", "all_257", "fibonacci"])
def test_fixed_trip_code_lengths_match_bmh_tpu(case):
    f = synth.code_length_cases()[case][0]
    got = thuf.code_lengths_device(torch.from_numpy(f)[None])[0].numpy()
    want = np.asarray(jax.jit(jhuf.code_lengths_device)(jnp.asarray(f, jnp.int32)))
    np.testing.assert_array_equal(got, want)
    if case == "fibonacci":
        assert got.max() == 25


# --- no host reads inside a program ---------------------------------------

_READS = {"__bool__", "item", "tolist", "nonzero", "__int__", "__float__",
          "__index__", "numpy", "cpu", "unique", "masked_select", "bincount",
          "repeat_interleave", "argwhere"}


class _NoHostReads(TorchFunctionMode):
    """Fails on a tensor value read by the host (a wait for the card): the
    names above, a one-argument where and a boolean-mask index.  A
    while_loop's predicate, read by _FlagRunner, is let through."""

    flags = 0
    allow = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        idx = args[1] if name in ("__getitem__", "__setitem__") else ()
        mask = any(torch.is_tensor(i) and i.dtype == torch.bool
                   for i in (idx if isinstance(idx, tuple) else (idx,)))
        if not self.allow and (name in _READS or mask
                               or (func is torch.where and len(args) == 1)):
            raise AssertionError(f"a host read inside a program: {name}")
        return func(*args, **(kwargs or {}))


class _FlagRunner:
    def __init__(self, mode):
        self.mode = mode

    def while_loop(self, cond, body, state, max_trips):
        for _ in range(max_trips + 1):
            self.mode.allow = True
            go = bool(cond(*state))
            self.mode.allow = False
            self.mode.flags += 1
            if not go:
                return state
            state = tuple(body(*state))
        raise AssertionError(f"a loop outran its bound of {max_trips} rounds")


def _no_host_reads(fn, *args):
    mode = _NoHostReads()
    control.set_runner(_FlagRunner(mode))
    try:
        with mode:
            out = fn(*args)
    finally:
        control.set_runner(None)
    return out, mode.flags


# --- (c) the sync-free sparse program ---------------------------------------

def _inputs(kind: str) -> bytes:
    rng = np.random.default_rng(7)
    if kind == "text":
        return bytes(synth.smoke_input(7, text_bytes=3 * BLOCK - 300, random_bytes=0))
    if kind == "runs":
        return b"".join(bytes([int(rng.integers(256))]) * int(rng.integers(1, 90))
                        for _ in range(400))[: 3 * BLOCK - 300]
    motif = bytes(rng.integers(0, 256, 24, dtype=np.uint8))
    return (motif * 600)[: 3 * BLOCK - 300]


@pytest.fixture(scope="module")
def jax_containers():
    return {k: bmh_tpu.compress_bytes(_inputs(k), block_size=BLOCK)
            for k in ("text", "runs", "periodic")}


@pytest.mark.parametrize("div", [16, 1, 1 << 20])
@pytest.mark.parametrize("kind", ["text", "runs", "periodic"])
def test_sparse_program_writes_bmh_tpu_containers(jax_containers, knobs,
                                                  monkeypatch, kind, div):
    """Three blocks (a batch of 4) by the sparse/adaptive program; at
    BMH_SPARSE_CAP_DIV 16 the periodic batch's ties exceed the compact set
    and the handoff loop runs (at 1 the set holds the whole batch)."""
    knobs(sparse_cap_div=div)
    rounds = []
    step = tbwt.round_step
    monkeypatch.setattr(tbwt, "round_step", lambda *a: rounds.append(1) or step(*a))
    blob = bt.compress_bytes(_inputs(kind), block_size=BLOCK, device="cpu")
    assert blob == jax_containers[kind]
    assert bool(rounds) == (kind == "periodic" and div != 1)


@pytest.mark.parametrize("hard", [False, True], ids=["sparse", "full_rounds"])
def test_padded_compress_program_reads_only_loop_flags(hard):
    """Three blocks as a card stages them (a fourth, dummy row of n = 1)
    write what the three rows alone write, and the program reads nothing
    on the host but its loop flags."""
    data = np.frombuffer(_inputs("periodic"), np.uint8)
    batch = np.zeros((4, BLOCK), np.uint8)
    ns = np.ones(4, np.int64)
    for r in range(3):
        part = data[r * BLOCK:(r + 1) * BLOCK]
        batch[r, : part.size] = part
        ns[r] = part.size
    out, flags = _no_host_reads(tpipe.compress_program, torch.from_numpy(batch),
                                torch.from_numpy(ns), 4096, hard, 4)
    assert out.dtype == torch.int32 and flags > 0
    alone = tpipe.compress_program(torch.from_numpy(batch[:3]), torch.from_numpy(ns[:3]),
                                   4096, hard, 4)
    cols = tpipe._meta_cols(BLOCK, 4096)
    meta4, meta3 = out[: 4 * cols].reshape(4, cols), alone[: 3 * cols].reshape(3, cols)
    assert torch.equal(meta4[:3], meta3)
    words = int(meta3[:, 1].sum())
    assert torch.equal(out[4 * cols: 4 * cols + words], alone[3 * cols: 3 * cols + words])


# --- (d) bucketed staging and static compaction ------------------------------

def _jax_blocks(lengths):
    rng = np.random.default_rng(5)
    text = bytes(synth.smoke_input(5, text_bytes=sum(lengths), random_bytes=0))
    raw, off = [], 0
    for n in lengths:
        raw.append(np.frombuffer(text[off:off + n], np.uint8))
        off += n
    raw[-1] = rng.integers(0, 256, lengths[-1]).astype(np.uint8)
    blocks = jpipe.JaxBackend().compress_blocks(raw, bucket=BLOCK)
    for b in blocks:
        b["stride"] = 4096
    return raw, blocks


@pytest.mark.parametrize("lengths", [(1, BLOCK), (BLOCK, 1000, 3000)],
                         ids=["ragged_1_and_nmax", "three_padded_to_four"])
def test_bucketed_staging_and_compaction_decode_bmh_tpu_blocks(lengths):
    raw, blocks = _jax_blocks(lengths)
    idxs = list(range(len(blocks)))
    want = jpipe._stage_flat_np(blocks, idxs)
    got = tpipe._stage_flat_np(blocks, idxs, 512)
    # bmh_tpu's bucket: b_pad rows (+ the pad chunks' row), nc chunks
    b_pad, nc = want[-1], want[-3]
    assert got[7].shape == (b_pad,) and got[4].shape == (nc,)
    for g, w in zip(got[:8], want[:8]):
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype))
    assert got[8] == want[-2]
    out = tpipe.TorchBackend("cpu").decompress_blocks(blocks, bucket=BLOCK)
    assert all(np.array_equal(o, r) for o, r in zip(out, raw))
    # the program's static output: sum(ns) bytes, then a total a row
    (words, lens_all, ss, ssi, sid, ms, ns, shifts, maxl) = got
    ncopy = np.zeros(b_pad, np.int64)
    ncopy[: len(raw)] = ns[: len(raw)]
    cps = np.zeros((b_pad, 1), np.int64)
    args = [torch.from_numpy(x) for x in (words.view(np.int32), lens_all, ss, ssi,
                                           sid, ms, ns, shifts, cps, ncopy)]
    flat, flags = _no_host_reads(tpipe.decode_flat_program, *args, BLOCK, 512,
                                 maxl, 4096)
    assert flags == 0 and flat.shape == (b_pad * BLOCK + 8 * b_pad,)
    # rows back to back, then the totals; a single-symbol block (the 1-byte
    # one) takes another route and is not the flat program's to decode
    total = sum(lengths)
    totals = flat[total:total + 8 * len(raw)].numpy().view("<i8")
    off = 0
    for r, blk, t in zip(raw, blocks, totals):
        if np.asarray(blk["present"]).sum() > 1:
            assert bytes(flat[off:off + r.size].numpy()) == r.tobytes()
            assert t == r.size
        off += r.size


def test_upload_length_and_mesh_change_the_key():
    """The compact stream's length keys only the inflate program; a sharded
    program's maker token, group size and rank key it."""
    k = programs.key("inflate", b_pad=4, nmax=BLOCK, s=1 << 19)
    assert programs.key("inflate", b_pad=4, nmax=BLOCK, s=1 << 20) != k
    assert programs.key("inflate", b_pad=4, nmax=BLOCK, s=1 << 19) == k
    m = programs.key("roundtrip_step", b_pad=4, nmax=BLOCK, mesh=(0, 1, 0))
    assert programs.key("roundtrip_step", b_pad=4, nmax=BLOCK, mesh=(1, 1, 0)) != m


# --- (e) the periodic and single-symbol programs ---------------------------

PBLOCK = 2 * BLOCK  # a periodic block longer than the 4096 stride


@pytest.fixture(scope="module")
def route_containers():
    """bmh_tpu's containers of three periodic 8 KiB blocks (a 64-byte
    motif, so every block is a power of it) and of three single-symbol
    streams (b"\\x00" * 3, b"q", b"\\x00" * 2: one RLE0 symbol each)."""
    rng = np.random.default_rng(13)
    motif = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    periodic = motif * (3 * PBLOCK // 64)
    singles = [b"\x00" * 3, b"q", b"\x00" * 2]
    return {"periodic": (periodic, bmh_tpu.compress_bytes(periodic, block_size=PBLOCK)),
            "single": (singles, [bmh_tpu.compress_bytes(s, block_size=2048)
                                 for s in singles])}


def test_periodic_program_decodes_bmh_tpu_blocks(route_containers):
    """The periodic route, padded to four rows as on a card, reads nothing
    on the host (no loop flags either) and gives back every block; the
    backend takes it through its key."""
    data, blob = route_containers["periodic"]
    infos = bt.api._parse(blob)[0]
    assert all(b["cps"] is None and b["orig_len"] > 4096 for b in infos)
    idxs = list(range(len(infos)))
    (words, lens_all, ss, ssi, sid, ms, ns, shifts,
     maxl) = tpipe._stage_flat_np(infos, idxs, 512)
    b_pad = shifts.size
    ncopy = np.zeros(b_pad, np.int64)
    ncopy[:3] = ns[:3]
    args = [torch.from_numpy(x) for x in (words.view(np.int32), lens_all, ss, ssi,
                                           sid, ms, ns, shifts, ncopy)]
    flat, flags = _no_host_reads(tpipe.decode_periodic_program, *args, PBLOCK, 512,
                                 maxl)
    assert flags == 0 and b_pad == 4
    assert bytes(flat[: len(data)].numpy()) == data
    totals = flat[len(data): len(data) + 24].numpy().view("<i8")
    assert list(totals) == [PBLOCK] * 3
    programs.clear()
    assert bt.decompress_bytes(blob, device="cpu") == data
    assert [k[0] for k in programs._cpu_keys] == ["decode_periodic"]


def test_single_program_pads_without_touching_real_rows(route_containers):
    """Three single-symbol blocks padded to four rows by bmh_tpu's dummy
    row read nothing on the host, and their rows and totals equal the
    unpadded batch's; decompress_many(uniform=True) decodes bmh_tpu's
    containers through the program."""
    singles, blobs = route_containers["single"]
    infos = [bt.api._parse(b)[0][0] for b in blobs]
    assert all(np.asarray(b["present"]).sum() == 1 for b in infos)
    idxs = [0, 1, 2]
    padded = tpipe._stage_single_np(infos, idxs, pad=True)
    alone = tpipe._stage_single_np(infos, idxs, pad=False)
    assert padded[3].size == 4 and list(padded[3][3:]) == [1]
    assert list(padded[1][3:]) == [1] and list(padded[2][3:]) == [0]
    out, flags = _no_host_reads(tpipe.decode_single_program,
                                *(torch.from_numpy(x) for x in padded), 2048)
    ref = tpipe.decode_single_program(*(torch.from_numpy(x) for x in alone), 2048)
    n = sum(len(s) for s in singles)
    assert flags == 0
    assert torch.equal(out[: n + 24], ref[: n + 24])
    assert bytes(out[:n].numpy()) == b"".join(singles)
    assert list(out[n: n + 24].numpy().view("<i8")) == [3, 1, 2]
    programs.clear()
    assert bt.decompress_many(blobs, uniform=True, device="cpu") == singles
    assert [k[0] for k in programs._cpu_keys] == ["decode_single"]


# --- (f) the sharded programs ------------------------------------------------

def test_sharded_programs_hit_the_cache_on_a_second_call(tmp_path):
    """On a one-process gloo group the step and stage 1 of one maker run
    through one key each: the second call hits it; a new maker misses."""
    import torch.distributed as dist

    from bmh_tpu_torch.parallel import dataparallel as tdp
    from bmh_tpu_torch.parallel import mesh as tmesh

    rng = np.random.default_rng(2)
    batch = rng.integers(0, 256, (2, 512)).astype(np.uint8)
    ns = np.array([512, 400])
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            world_size=1, rank=0)
    try:
        mesh = tmesh.make_mesh(device="cpu")
        stage1 = tdp.make_sharded_stage1(mesh, 512)
        programs.clear()
        programs.reset_stats()
        freqs = stage1(batch, ns)[2].numpy()
        assert torch.equal(stage1(batch, ns)[2], torch.from_numpy(freqs))
        assert programs.STATS["runs"] == 2 and programs.STATS["hits"] == 1
        tbl = tdp.host_tables(freqs)
        args = (batch, ns, *(tbl[k] for k in ("enc_len", "enc_code", "count", "sym")))
        step = tdp.make_roundtrip_step(mesh, 512)
        first = step(*args)
        assert int(first[1]) == int(ns.sum())
        second = step(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        assert programs.STATS["runs"] == 4 and programs.STATS["hits"] == 2
        tdp.make_roundtrip_step(mesh, 512)(*args)
        assert programs.STATS["runs"] == 5 and programs.STATS["hits"] == 2
        keys = list(programs._cpu_keys)
        assert [k[0] for k in keys] == ["sharded_stage1", "roundtrip_step",
                                        "roundtrip_step"]
        assert keys[1][8][1:] == (1, 0) and keys[1][8] != keys[2][8]
    finally:
        dist.destroy_process_group()
