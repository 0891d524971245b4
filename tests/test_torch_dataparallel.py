"""The port's block-parallel layer on torch.distributed (gloo on the CPU),
held against bmh_tpu's shard_map step on a 4-device CPU mesh: host tables,
the sharded stage functions, the round-trip step in one process and in
four, the forward entry and the dry run without a corpus."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from bmh_tpu.parallel import dataparallel as jdp
from bmh_tpu.parallel import mesh as jmesh

from bmh_tpu_torch.models import pipeline
from bmh_tpu_torch.parallel import dataparallel as tdp
from bmh_tpu_torch.parallel import mesh as tmesh

ROOT = Path(__file__).resolve().parents[1]
NMAX = 512
TABLES = ("enc_len", "enc_code", "count", "sym")


def _batch():
    """Two blocks a device on four devices: text-like, random and run-heavy
    rows, with a ragged tail."""
    rng = np.random.default_rng(6060)
    b = 8
    batch = rng.integers(0, 200, (b, NMAX)).astype(np.uint8)
    batch[::3] = rng.integers(97, 101, (3, NMAX))
    batch[1, 100:400] = 0
    ns = np.full(b, NMAX, np.int32)
    ns[-1] = NMAX - 100
    return batch, ns


@pytest.fixture(scope="module")
def ref():
    """bmh_tpu's stage 1, tables and round-trip step on a 4-device mesh."""
    batch, ns = _batch()
    mesh = jmesh.make_mesh(4)
    stage1 = [np.asarray(x) for x in jdp.make_sharded_stage1(mesh, NMAX)(
        jnp.asarray(batch), jnp.asarray(ns))]
    tbl = jdp.host_tables(stage1[2])
    out, total_ok, all_bits = jdp.make_roundtrip_step(mesh, NMAX)(
        jnp.asarray(batch), jnp.asarray(ns), *(jnp.asarray(tbl[k]) for k in TABLES))
    return {"batch": batch, "ns": ns, "stage1": stage1, "tables": tbl,
            "decoded": np.asarray(out), "total_ok": int(total_ok),
            "all_bits": np.asarray(all_bits)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def group(tmp_path):
    """A one-process gloo group over a FileStore, destroyed afterwards."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            world_size=1, rank=0)
    try:
        yield tmesh.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_host_tables_equal_bmh_tpus(ref):
    freqs = np.concatenate([ref["stage1"][2], np.zeros((1, 257), np.int64),
                            np.eye(257, dtype=np.int64)[[5]] * 9])
    want, got = jdp.host_tables(freqs), tdp.host_tables(freqs)
    assert want.keys() == got.keys()
    for k in TABLES:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["maxl"] == want["maxl"]


def test_sharded_stages_equal_bmh_tpus(ref, group):
    batch, ns = ref["batch"], ref["ns"]
    got = tdp.make_sharded_stage1(group, NMAX)(batch, ns)
    syms, ms = got[0].numpy(), got[1].numpy()
    assert np.array_equal(ms, ref["stage1"][1])
    for row, m in enumerate(ms):
        assert np.array_equal(syms[row, :m], ref["stage1"][0][row, :m])
    for want, have in zip(ref["stage1"][2:], got[2:]):
        assert np.array_equal(want, have.numpy())
    tbl = ref["tables"]
    words, bits = tdp.make_sharded_encode(group, NMAX)(got[0], got[1], tbl["enc_len"],
                                                        tbl["enc_code"])
    assert np.array_equal(bits.numpy(), ref["all_bits"])
    (decoded,) = tdp.make_sharded_decode2(group, NMAX)(got[0], got[1], got[3], ns)
    pos = np.arange(NMAX)[None, :]
    assert np.array_equal(np.where(pos < ns[:, None], decoded.numpy(), 0),
                          np.where(pos < ns[:, None], batch, 0))


def test_roundtrip_step_equals_bmh_tpus(ref, group):
    step = tdp.make_roundtrip_step(group, NMAX)
    out, total_ok, all_bits = step(ref["batch"], ref["ns"],
                                   *(ref["tables"][k] for k in TABLES))
    assert np.array_equal(out.numpy(), ref["decoded"])
    assert int(total_ok) == ref["total_ok"] == int(ref["ns"].sum())
    assert np.array_equal(all_bits.numpy(), ref["all_bits"])
    # the encode's bit counts are the tables' lengths over each histogram
    freqs = ref["stage1"][2]
    assert np.array_equal(all_bits.numpy(), (freqs * ref["tables"]["enc_len"]).sum(1))


def test_block_sharding_stripes(group):
    stripe = tmesh.block_sharding(group)
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(stripe(x), x)
    assert group.mesh_dim_names == (tmesh.BLOCK_AXIS,)
    with pytest.raises(ValueError, match="needs 2 processes"):
        tmesh.make_mesh(2, device="cpu")


_WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, {root!r})
    import numpy as np
    import torch.distributed as dist
    from bmh_tpu_torch.parallel import dataparallel as tdp, mesh as tmesh

    rank = int(sys.argv[1])
    dist.init_process_group("gloo", init_method="tcp://localhost:{port}",
                            world_size=4, rank=rank)
    ref = np.load({npz!r})
    mesh = tmesh.make_mesh(4, device="cpu")
    assert tmesh.block_sharding(mesh)(np.arange(8)).tolist() == [2 * rank, 2 * rank + 1]
    out, total_ok, all_bits = tdp.make_roundtrip_step(mesh, {nmax})(
        ref["batch"], ref["ns"], *(ref[k] for k in {tables!r}))
    local = tmesh.make_mesh(local=True, device="cpu")
    assert local.size() == 2 and local.get_local_rank(tmesh.BLOCK_AXIS) == rank % 2
    print("STEP", json.dumps({{"rank": rank, "total_ok": int(total_ok),
                              "all_bits": all_bits.tolist(),
                              "decoded_ok": bool((out.numpy() == ref["decoded"]).all())}}))
    dist.destroy_process_group()
""")


def test_four_process_gloo_step(ref, tmp_path):
    """Four processes, one a device, two blocks each: every rank's
    all_reduce'd total and gathered bits and rows equal bmh_tpu's step."""
    np.savez(tmp_path / "ref.npz", batch=ref["batch"], ns=ref["ns"],
             decoded=ref["decoded"], **{k: ref["tables"][k] for k in TABLES})
    script = _WORKER.format(root=str(ROOT), port=_free_port(), npz=str(tmp_path / "ref.npz"),
                            nmax=NMAX, tables=TABLES)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", LOCAL_WORLD_SIZE="2")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        rec = json.loads(next(ln for ln in out.splitlines() if ln.startswith("STEP "))[5:])
        assert rec["rank"] == r and rec["decoded_ok"]
        assert rec["total_ok"] == ref["total_ok"]
        assert rec["all_bits"] == ref["all_bits"].tolist()


def test_entry_runs_stage1():
    fn, (data, n) = tdp.entry(device="cpu")
    syms, m, freqs, shift, cps, aper = fn(data, n)
    assert data.shape == (1, 65536) and int(n) == 65536 - 137
    assert int(freqs.sum()) == int(m) and bool(aper[0])


def test_dryrun_without_a_corpus(monkeypatch, tmp_path):
    """bmh_tpu's dry run raises TypeError where the corpus is absent; the
    port's takes the seeded stream instead, at the 128 KiB block."""
    monkeypatch.setenv("BMH_CORPUS_DIR", str(tmp_path / "absent"))
    monkeypatch.delenv("BMH_DRYRUN_BLOCK", raising=False)
    assert not dist.is_initialized()
    tdp.dryrun_multichip(1, device="cpu")
    assert not dist.is_initialized()
    assert pipeline.LAST_DISPATCH["compress_ndev"] == 1
    with pytest.raises(RuntimeError, match="needs 2 processes"):
        tdp.dryrun_multichip(2, device="cpu")


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdp.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdp.dryrun_multichip(1)
    assert not dist.is_initialized()
