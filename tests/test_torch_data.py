"""The port's input pipeline (``apex_tpu_torch.data``) and native host
runtime (``apex_tpu_torch._native``) against the JAX package's, on the
same record files written from a seed with numpy.

``ShardedRecordIterator`` gives JAX's batches, record ids and
``state_dict()`` bit for bit (several epochs over small shuffle windows,
data-parallel slot ranges, a corrupt record quarantined at the same
index, resumed from a JAX state); the shard faults recover as JAX's do;
``NativeRecordLoader`` and ``pack_host``/``unpack_host`` give their plain
versions' bytes; the C++ sources are JAX's, byte for byte, built into
``apex_tpu_torch/_build/``, and a failed build raises.
"""

import filecmp
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from apex_tpu import data as jdata
from apex_tpu.data import records as jrecords
from apex_tpu.resilience import chaos as jchaos
from apex_tpu_torch import _native
from apex_tpu_torch import data as tdata
from apex_tpu_torch.data import records as trecords
from apex_tpu_torch.resilience import chaos as tchaos
from apex_tpu_torch.telemetry import MemorySink, TelemetryBus, validate_event

REPO = Path(__file__).resolve().parent.parent
PAYLOAD = 12


@pytest.fixture(autouse=True)
def _clear_read_hooks():
    yield
    jrecords.set_read_hook(None)
    trecords.set_read_hook(None)


@pytest.fixture()
def shards(tmp_path):
    """Three checksummed shards (11 + 7 + 5 records of 12 payload bytes)
    and their raw twins."""
    rng = np.random.RandomState(0)
    out = {"crc": [], "raw": []}
    for k, n in enumerate((11, 7, 5)):
        rows = rng.randint(0, 256, (n, PAYLOAD)).astype(np.uint8)
        p = str(tmp_path / f"c{k}.bin")
        out["rb"] = tdata.write_checksummed_records(p, rows)
        out["crc"].append(p)
        q = str(tmp_path / f"r{k}.bin")
        tdata.write_records(q, rows)
        out["raw"].append(q)
    return out


def _pair(paths, rb, batch, **kw):
    ids = {"jax": [], "port": []}
    j = jdata.ShardedRecordIterator(
        paths, rb, batch, on_ids=lambda i, x: ids["jax"].append(x), **kw)
    t = tdata.ShardedRecordIterator(
        paths, rb, batch, on_ids=lambda i, x: ids["port"].append(x), **kw)
    return j, t, ids


def test_writers_write_jax_s_bytes(shards, tmp_path):
    rows = np.random.RandomState(1).randint(0, 256, (4, 9)).astype(np.uint8)
    jrecords.write_checksummed_records(str(tmp_path / "j.bin"), rows)
    trecords.write_checksummed_records(str(tmp_path / "t.bin"), rows)
    assert filecmp.cmp(tmp_path / "j.bin", tmp_path / "t.bin", shallow=False)
    rec = (tmp_path / "t.bin").read_bytes()[:13]
    assert trecords.check_record_crc(rec) == jrecords.check_record_crc(rec)
    assert trecords.check_record_crc(rec)


@pytest.mark.parametrize("window,dp", [(4, 1), (4096, 1), (5, 2), (3, 4)],
                         ids=["window4", "one_window", "window5_dp2",
                              "window3_dp4"])
def test_batches_ids_and_state_are_jax_s(shards, window, dp):
    for rank in range(dp):
        j, t, ids = _pair(shards["crc"], shards["rb"], 4, checksummed=True,
                          shuffle_window=window, seed=7, dp_rank=rank,
                          dp_size=dp)
        for _ in range(15):    # 60 records: past two epochs of 23
            assert next(j).tobytes() == next(t).tobytes()
            assert j.state_dict() == t.state_dict()
        assert ids["jax"] == ids["port"]
        assert t.record_at(100) == j.record_at(100)


def test_resume_from_a_jax_state(shards):
    j, t, _ = _pair(shards["raw"], PAYLOAD, 6, seed=3, shuffle_window=5)
    for _ in range(5):
        next(j)
    t.load_state_dict(j.state_dict())
    for _ in range(6):
        assert next(j).tobytes() == next(t).tobytes()
    assert t.state_dict() == j.state_dict()
    # a state from another dataset or batch size is refused, as in JAX
    other = tdata.ShardedRecordIterator(shards["raw"], PAYLOAD, 3, seed=3)
    with pytest.raises(ValueError, match="batch_size"):
        other.load_state_dict(j.state_dict())
    reseeded = tdata.ShardedRecordIterator(shards["raw"], PAYLOAD, 6, seed=4,
                                           shuffle_window=5)
    with pytest.raises(ValueError, match="fingerprint"):
        reseeded.load_state_dict(j.state_dict())


def test_merge_data_states_is_jax_s(shards):
    states = []
    for rank in range(2):
        j = jdata.ShardedRecordIterator(shards["raw"], PAYLOAD, 4, seed=1,
                                        dp_rank=rank, dp_size=2)
        next(j)
        states.append(j.state_dict())
    assert tdata.merge_data_states(states) == jdata.merge_data_states(states)


def test_corrupt_record_is_quarantined_at_jax_s_index(shards):
    tchaos.corrupt_record(shards["crc"][1], 2, shards["rb"])
    events = {}
    its = {}
    for name, mod in (("jax", jdata), ("port", tdata)):
        sink = MemorySink()
        bus = TelemetryBus(run_id=name, sinks=[sink])
        its[name] = mod.ShardedRecordIterator(
            shards["crc"], shards["rb"], 4, checksummed=True, seed=2,
            shuffle_window=6, telemetry=bus,
            quarantine=mod.QuarantinePolicy(max_rate=0.5))
        events[name] = sink.events
    for _ in range(8):
        assert next(its["jax"]).tobytes() == next(its["port"]).tobytes()
    assert its["port"].state_dict() == its["jax"].state_dict()
    assert its["port"].quarantined == its["jax"].quarantined >= 1
    q = [e for e in events["port"] if e["type"] == "data_quarantine"]
    assert [e["record_id"] for e in q] == [
        e["record_id"] for e in events["jax"]
        if e["type"] == "data_quarantine"] == [11 + 2] * len(q)
    for e in q:
        validate_event(e)


def test_quarantine_overflow_hard_fails(shards):
    for k in range(4):
        tchaos.corrupt_record(shards["crc"][0], k, shards["rb"])
    it = tdata.ShardedRecordIterator(
        shards["crc"], shards["rb"], 4, checksummed=True,
        quarantine=tdata.QuarantinePolicy(max_rate=0.01, min_count=2))
    with pytest.raises(tdata.QuarantineOverflowError):
        for _ in range(10):
            next(it)


@pytest.mark.parametrize("after", [False, True],
                         ids=["recovers", "dead_shard"])
def test_dropped_shard_reassigns_or_fails_as_in_jax(shards, after):
    outcomes = []
    for mod, chaos in ((jdata, jchaos), (tdata, tchaos)):
        it = mod.ShardedRecordIterator(
            shards["raw"], PAYLOAD, 4, seed=5,
            retry=mod.records.RetryPolicy(max_attempts=2, base_delay=0.0))
        with chaos.DropShard(shards["raw"][0],
                             fail_after_reassign=after) as fault:
            try:
                got = [next(it).tobytes() for _ in range(3)]
                outcomes.append(("ok", got, fault.reassigned,
                                 it.files.reassigns))
            except mod.DataShardError:
                outcomes.append(("dead", None, fault.reassigned,
                                 it.files.reassigns))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0] == ("dead" if after else "ok")


def test_slow_shard_read_emits_data_stall(shards):
    sink = MemorySink()
    bus = TelemetryBus(run_id="slow", sinks=[sink])
    it = tdata.ShardedRecordIterator(shards["raw"], PAYLOAD, 4, seed=0,
                                     telemetry=bus, slow_read_threshold=0.01)
    with tchaos.SlowShardRead(shards["raw"][0], delay=0.05, times=1):
        for _ in range(3):
            next(it)
    stalls = [e for e in sink.events if e["type"] == "data_stall"]
    assert stalls and stalls[0]["cause"] == "slow_read"
    validate_event(stalls[0])


# -- the prefetcher ----------------------------------------------------------


def test_prefetcher_state_is_the_consumed_batch_s(shards):
    def split(m):       # (tokens, labels), as pretrain_gpt decodes
        return m[:, :6], m[:, 6:]

    src = tdata.ShardedRecordIterator(shards["raw"], PAYLOAD, 4, seed=9,
                                      decode=split)
    ref = tdata.ShardedRecordIterator(shards["raw"], PAYLOAD, 4, seed=9,
                                      decode=split)
    with tdata.AsyncPrefetcher(src, depth=3,
                               transfer=tdata.to_device("cpu")) as pf:
        first = next(pf)
        want = next(ref)
        assert [type(x) for x in first] == [torch.Tensor] * 2
        assert [x.numpy().tobytes() for x in first] == [
            np.ascontiguousarray(x).tobytes() for x in want]
        # in-flight batches are not consumed: the state is the first's
        assert pf.state_dict() == ref.state_dict()
        for _ in range(2):
            next(pf)
            next(ref)
        pf.load_state_dict(pf.state_dict())
        assert next(pf)[1].numpy().tobytes() == np.ascontiguousarray(
            next(ref)[1]).tobytes()


def test_loader_death_is_loud():
    def dying():
        yield np.zeros(2)
        raise OSError("disk gone")

    with tdata.AsyncPrefetcher(dying()) as pf:
        next(pf)
        with pytest.raises(tdata.DataLoaderError) as e:
            next(pf)
    assert isinstance(e.value.__cause__, OSError)


# -- the native runtime ------------------------------------------------------


def test_native_sources_are_jax_s_byte_for_byte():
    for src in ("flatten.cpp", "dataloader.cpp"):
        assert filecmp.cmp(REPO / "apex_tpu" / "_native" / src,
                           REPO / "apex_tpu_torch" / "_native" / src,
                           shallow=False), src


def test_native_builds_into_the_port_s_build_dir():
    _native.get_lib()
    path = Path(_native.library_path())
    assert path.parent == REPO / "apex_tpu_torch" / "_build"
    assert path.is_file()
    assert not list((REPO / "apex_tpu_torch" / "_native").glob("*.so"))
    assert tdata.native_available()


def test_failed_native_build_raises_with_the_compiler_s_message(
        monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "library_path",
                        lambda: str(tmp_path / "native_x.so"))
    monkeypatch.setattr(
        _native.subprocess, "run",
        lambda *a, **kw: subprocess.CompletedProcess(
            a[0], 1, "", "dataloader.cpp:1: error: planted"))
    with pytest.raises(_native.NativeBuildError, match="planted"):
        _native.get_lib()
    assert not tdata.native_available()
    with pytest.raises(_native.NativeBuildError):
        tdata.NativeRecordLoader([str(tmp_path / "x.bin")], 4, 1)
    monkeypatch.setattr(_native.subprocess, "run", _raise_oserror)
    with pytest.raises(_native.NativeBuildError, match="cannot run g"):
        _native.get_lib()


def _raise_oserror(*a, **kw):
    raise FileNotFoundError("g++")


@pytest.mark.parametrize("n", [1, 5, 17])
def test_pack_and_unpack_give_the_plain_versions_bytes(n):
    rng = np.random.RandomState(n)
    arrays = [rng.randn(*rng.randint(1, 9, size=rng.randint(1, 3))).astype(
        rng.choice([np.float32, np.float16, np.int32])) for _ in range(n)]
    offsets, off = [], 0
    for a in arrays:
        offsets.append(off)
        off += -(-a.nbytes // 64) * 64
    native = _native.pack_host(arrays, offsets, off, threads=3)
    plain = _native.pack_host_plain(arrays, offsets, off)
    assert native.tobytes() == plain.tobytes()
    back = [np.zeros_like(a) for a in arrays]
    back_plain = [np.zeros_like(a) for a in arrays]
    _native.unpack_host(native, back, offsets, threads=3)
    _native.unpack_host_plain(plain, back_plain, offsets)
    for a, b, c in zip(arrays, back, back_plain):
        assert a.tobytes() == b.tobytes() == c.tobytes()


@pytest.mark.parametrize("shuffle", [False, True])
def test_native_loader_gives_the_plain_version_s_and_jax_s_batches(
        shards, shuffle):
    rows = np.concatenate([np.fromfile(p, np.uint8).reshape(-1, PAYLOAD)
                           for p in shards["raw"]])
    kw = dict(shuffle=shuffle, seed=4, num_threads=2)
    with tdata.NativeRecordLoader(shards["raw"], PAYLOAD, 4, **kw) as t, \
            jdata.NativeRecordLoader(shards["raw"], PAYLOAD, 4, **kw) as j:
        got = [next(t) for _ in range(2 * t.batches_per_epoch)]
        assert [g.tobytes() for g in got] == [
            next(j).tobytes() for _ in range(2 * t.batches_per_epoch)]
        assert t.error_count == 0
    n = t.batches_per_epoch * 4
    first = np.concatenate(got[: t.batches_per_epoch])
    if shuffle:   # an epoch draws distinct records
        assert len({bytes(r) for r in first}) == n
        assert {bytes(r) for r in first} <= {bytes(r) for r in rows}
    else:         # the plain version: the records in file order
        assert first.tobytes() == rows[:n].tobytes()
