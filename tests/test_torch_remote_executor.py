"""The port's remote data plane against the JAX package's on the CPU.

Each case of ``tests/test_remote_executor.py`` runs on the port: the lease
table under a fake clock, the heartbeat and the frame transport (these
pure-Python ones on both packages), the empty corpus, a worker SIGKILLed
mid-epoch, every worker dead, a worker's failure ending the run at once,
reassignment after a TCP EOF and after a stale heartbeat, and a prompt
``stop``. Then the same seeded shards through both packages' remote
executors: records, ``fit_vocab``'s vocabulary, token arrays, batches and
the warm cache's full hits exactly equal, under ``loops`` and under
``device`` on the CPU. A worker under a host backend never imports torch,
a remote run on the CPU leaves the launch counters at zero, and the caller
adds each accepted result's launches once, never a dropped duplicate's.
Two workers, a few shards of a few dozen rows; every executor is stopped
in a ``finally`` and uses short leases, so nothing waits out a default
timeout."""

import os
import signal
import socket
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import repro.distributed.coordinator as JCO
import repro.distributed.transport as JTR
import repro.runtime.fault_tolerance as JFT
from repro.core import executor as JX
from repro.core import expr as JE
from repro.core import ingest as jing
from repro.core import plan as JP
from repro.core.dataset import Dataset as JDataset
from repro.data import batching as JBT
from repro.data.tokenizer import WordTokenizer as JWordTokenizer
import repro_torch.distributed.coordinator as PCO
import repro_torch.distributed.transport as PTR
import repro_torch.distributed.worker as PWK
import repro_torch.runtime.fault_tolerance as PFT
from repro_torch.core import executor as PX
from repro_torch.core import expr as PE
from repro_torch.core import ingest as ping
from repro_torch.core import plan as PP
from repro_torch.core.dataset import Dataset
from repro_torch.data import batching as PBT
from repro_torch.data.tokenizer import WordTokenizer
from repro_torch.kernels.text_clean import ops as pscan_ops
from test_executor_equivalence import FIELDS, fuzz_records, write_shards

ENV = ("REPRO_BYTES_BACKEND", "REPRO_EXECUTOR", "REPRO_CACHE", "REPRO_CACHE_DIR",
       "REPRO_WORKERS")
# Fast liveness, as the reference's tests set it (tests/test_executor_equivalence.py:623-626).
FAST = {"lease_s": 5.0, "heartbeat_timeout": 3.0, "heartbeat_interval_s": 0.1}
SPECS = (("abstract", 16), ("title", 8))
PACKAGES = {
    "port": SimpleNamespace(X=PX, P=PP, D=Dataset, E=PE, BT=PBT, ing=ping, CO=PCO, TR=PTR,
                            Heartbeat=PFT.Heartbeat),
    "ref": SimpleNamespace(X=JX, P=JP, D=JDataset, E=JE, BT=JBT, ing=jing, CO=JCO, TR=JTR,
                           Heartbeat=JFT.Heartbeat),
}
BACKENDS = ["loops", "device"]


@pytest.fixture(autouse=True)
def no_engine_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def chain(k, d, backend="loops"):
    """The cleaning chain without dedup (every executor can run it): the
    port's on the CPU under ``backend``, the reference's under ``loops``."""
    keep = k.E.col("title").not_empty() & k.E.col("abstract").not_empty()
    ds = (k.D.from_json_dirs([d], FIELDS).where(keep)
          .transform(abstract=k.E.abstract_expr(), title=k.E.title_expr()).where(keep))
    if k is PACKAGES["port"]:
        return ds.backend(backend).device("cpu")
    return ds.backend("loops")


def program_of(k, ds, *, tok=None, backend="loops"):
    """The records program of ``ds``, or its token program against ``tok``."""
    frame_nodes, _ = k.P.split_plan(ds.plan)
    kw = {"backend": backend}
    if k is PACKAGES["port"]:
        kw["device"] = "cpu"
    if tok is None:
        return k.X.compile_shard_program(k.P.optimize_plan(frame_nodes, ds.schema), **kw)
    cols = tuple(dict.fromkeys(c for c, _ in SPECS))
    plan = k.X.TokenPlan(tuple(k.BT.TokenSpec(c, n) for c, n in SPECS), dict(tok.stoi),
                         tok.fingerprint)
    return k.X.compile_shard_program(k.P.optimize_plan(frame_nodes, cols),
                                     output_columns=cols, tokens=plan, **kw)


def remote(k, shards, program, **kw):
    kw.setdefault("remote", dict(FAST))
    return k.CO.RemoteShardExecutor(shards, program, workers=kw.pop("workers", 2), **kw)


def drained(executor) -> list:
    """Every result of ``executor`` in shard order; it is stopped whatever
    happens."""
    try:
        return sorted(executor, key=lambda r: r.shard_index)
    finally:
        executor.stop()


def records_of(results) -> list:
    return [r.frame.to_records() for r in results]


def tokens_of(results) -> list:
    return [{k: (v.dtype, v.shape, v.tobytes()) for k, v in r.tokens.items()}
            for r in results]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_shards(tmp_path_factory.mktemp("remote_corpus"), fuzz_records(41, 120),
                        n_files=4)


@pytest.fixture(scope="module")
def tokenizers(corpus):
    """The reference's vocabulary of the chain's records, and the port's."""
    mp = pytest.MonkeyPatch()
    for name in ENV:
        mp.delenv(name, raising=False)
    try:
        records = chain(PACKAGES["ref"], corpus).to_records()
    finally:
        mp.undo()
    words = [r[f] for r in records for f in FIELDS]
    return {"ref": JWordTokenizer.fit(words, vocab_size=200),
            "port": WordTokenizer.fit(words, vocab_size=200)}


# ---------------------------------------------------------------------------
# lease table: pure bookkeeping under a fake clock, on both packages
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_lease_acquire_complete_roundtrip(pkg):
    lt = pkg.CO.LeaseTable(3, lease_s=10.0, clock=FakeClock())
    got = [lt.acquire("w1", timeout=0.01) for _ in range(3)]
    assert sorted(got) == [0, 1, 2]
    assert lt.acquire("w1", timeout=0.01) is None  # nothing pending
    assert not lt.all_done()
    for i in got:
        assert lt.complete(i, "w1")
    assert lt.all_done() and lt.remaining() == 0


def test_lease_expiry_requeues_for_survivor(pkg):
    clock = FakeClock()
    lt = pkg.CO.LeaseTable(2, lease_s=10.0, clock=clock)
    assert lt.acquire("dead", timeout=0.01) == 0
    clock.now = 5.0
    assert lt.reap_expired() == []
    clock.now = 10.0
    assert lt.reap_expired() == [0]
    got = [lt.acquire("live", timeout=0.01), lt.acquire("live", timeout=0.01)]
    assert sorted(got) == [0, 1]


def test_lease_duplicate_result_dropped(pkg):
    clock = FakeClock()
    lt = pkg.CO.LeaseTable(1, lease_s=1.0, clock=clock)
    assert lt.acquire("slow", timeout=0.01) == 0
    clock.now = 2.0
    assert lt.reap_expired() == [0]
    assert lt.acquire("fast", timeout=0.01) == 0
    assert lt.complete(0, "fast")
    assert not lt.complete(0, "slow")
    assert lt.all_done()


def test_lease_release_on_worker_death(pkg):
    lt = pkg.CO.LeaseTable(3, lease_s=100.0, clock=FakeClock())
    assert lt.acquire("w1", timeout=0.01) == 0
    assert lt.acquire("w2", timeout=0.01) == 1
    assert sorted(lt.release("w1")) == [0]
    assert lt.leased_to("w2") == [1]
    got = [lt.acquire("w2", timeout=0.01), lt.acquire("w2", timeout=0.01)]
    assert sorted(got) == [0, 2]


def test_lease_close_wakes_waiters(pkg):
    lt = pkg.CO.LeaseTable(1, lease_s=1.0)
    assert lt.acquire("w", timeout=0.01) == 0
    out = []
    t = threading.Thread(target=lambda: out.append(lt.acquire("w", timeout=30.0)))
    t.start()
    time.sleep(0.05)
    lt.close()
    t.join(timeout=5.0)
    assert not t.is_alive() and out == [None]


# ---------------------------------------------------------------------------
# heartbeat and transport, on both packages
# ---------------------------------------------------------------------------


def test_heartbeat_beat_is_atomic(pkg, tmp_path):
    path = tmp_path / "w.beat"
    hb = pkg.Heartbeat(path, interval_s=0.0)
    hb.beat(7, force=True)
    assert pkg.Heartbeat.is_alive(path, timeout_s=60.0)
    assert [p.name for p in tmp_path.iterdir()] == ["w.beat"]


def test_heartbeat_tolerates_missing_and_garbage(pkg, tmp_path):
    assert pkg.Heartbeat.last_beat(tmp_path / "never.beat") is None
    garbage = tmp_path / "torn.beat"
    garbage.write_text("12 not-a-float")
    assert pkg.Heartbeat.last_beat(garbage) is None
    assert not pkg.Heartbeat.is_alive(garbage, timeout_s=60.0)
    garbage.write_text("")
    assert pkg.Heartbeat.last_beat(garbage) is None


def test_heartbeat_interval_gate_and_force(pkg, tmp_path):
    hb = pkg.Heartbeat(tmp_path / "w.beat", interval_s=3600.0)
    hb.beat(1, force=True)
    first = pkg.Heartbeat.last_beat(hb.path)
    hb.beat(2)
    assert pkg.Heartbeat.last_beat(hb.path) == first
    hb.beat(3, force=True)
    assert pkg.Heartbeat.last_beat(hb.path) >= first


def test_transport_frame_roundtrip_and_wire_bytes():
    """A round trip through the port's frames, and the same bytes on the
    wire as the reference's for the same frame."""
    payload = os.urandom(70_001)
    wires = []
    for k in (PACKAGES["port"], PACKAGES["ref"]):
        a, b = socket.socketpair()
        try:
            k.TR.send_frame(a, "task", {"shard_index": 3, "digest": "abc"}, payload)
            k.TR.send_frame(a, "shutdown")
            a.close()
            wire = b""
            while chunk := b.recv(1 << 16):
                wire += chunk
            wires.append(wire)
        finally:
            b.close()
    assert wires[0] == wires[1]
    a, b = socket.socketpair()
    try:
        PTR.send_frame(a, "task", {"shard_index": 3, "digest": "abc"}, payload)
        PTR.send_frame(a, "shutdown")
        kind, meta, view = PTR.recv_frame(b)
        assert kind == "task" and meta["shard_index"] == 3
        assert bytes(view) == payload
        kind, meta, view = PTR.recv_frame(b)
        assert kind == "shutdown" and meta == {} and len(view) == 0
        a.close()
        assert PTR.recv_frame(b) is None  # clean EOF between frames
    finally:
        for s in (a, b):
            s.close()
    c, d = socket.socketpair()
    try:
        c.sendall(b"XXXX" + bytes(16))
        with pytest.raises(PTR.TransportError, match="bad frame magic"):
            PTR.recv_frame(d)
    finally:
        c.close()
        d.close()


# ---------------------------------------------------------------------------
# differential: the port's remote executor against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_records_equal_the_reference_remote_and_the_port_threads(corpus, backend):
    port, ref = PACKAGES["port"], PACKAGES["ref"]
    shards = ping.list_shards([corpus])
    program = program_of(port, chain(port, corpus, backend), backend=backend)
    got = records_of(drained(remote(port, shards, program)))
    want = records_of(drained(remote(ref, jing.list_shards([corpus]),
                                     program_of(ref, chain(ref, corpus)))))
    assert got == want
    assert got == records_of(drained(PX.ThreadShardExecutor(shards, program, workers=2)))
    assert sum(len(r) for r in got) > 20


@pytest.mark.parametrize("backend", BACKENDS)
def test_tokens_and_warm_cache_full_hits_equal_the_reference(corpus, tokenizers, tmp_path,
                                                             backend):
    """Cold then warm through each package's shard cache: the same token
    arrays every run, the warm run all token-cache hits."""
    runs = {}
    for name, k in PACKAGES.items():
        shards = k.ing.list_shards([corpus])
        program = program_of(k, chain(k, corpus, backend), tok=tokenizers[name],
                             backend=backend if name == "port" else "loops")
        cache = tmp_path / name
        cold = remote(k, shards, program, cache_dir=cache)
        cold_tokens = tokens_of(drained(cold))
        warm = remote(k, shards, program, cache_dir=cache)
        warm_tokens = tokens_of(drained(warm))
        assert warm_tokens == cold_tokens
        counters = [(ex.token_cache_hits, ex.token_cache_misses, ex.cache_hits,
                     ex.cache_misses) for ex in (cold, warm)]
        runs[name] = (cold_tokens, counters)
    assert runs["port"] == runs["ref"]
    n = 4 * len(SPECS)  # one entry a shard and token spec
    assert runs["port"][1] == [(0, n, 0, n), (n, 0, 0, 0)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_vocab_and_batches_equal_the_reference(corpus, backend):
    """``.workers(2, remote=...)``: the fitted vocabulary (``stoi`` and
    ``itos``) and the whole batch stream equal the reference's remote
    run's, and the port's thread executor's."""
    port, ref = PACKAGES["port"], PACKAGES["ref"]
    stats = {}
    tok = chain(port, corpus, backend).workers(2, remote=dict(FAST)).fit_vocab(
        vocab_size=150, stats=stats)
    assert stats["executor"] == "remote"
    jtok = chain(ref, corpus).workers(2, remote=dict(FAST)).fit_vocab(vocab_size=150)
    assert tok.itos == jtok.itos and tok.stoi == jtok.stoi

    def batches(k, ds, t, **kw):
        stream = (ds.tokenize(t, k.BT.seq2seq_specs(16, 8))
                  .batched(8, shuffle=False, bucket_by=("encoder_tokens", "decoder_tokens"))
                  .prefetch(2).workers(2, **kw))
        stats = {}
        out = [{c: v.copy() for c, v in b.items()} for b in stream.iter_batches(stats=stats)]
        assert stats["executor"] == kw.get("executor", "remote")
        return out

    got = batches(port, chain(port, corpus, backend), tok, remote=dict(FAST))
    want = batches(ref, chain(ref, corpus), jtok, remote=dict(FAST))
    threads = batches(port, chain(port, corpus, backend), tok, executor="thread")
    assert len(got) == len(want) == len(threads) > 0
    for a, b, c in zip(got, want, threads):
        assert a.keys() == b.keys() == c.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(a[key], c[key])


def test_make_executor_selection_equals_the_reference(corpus, monkeypatch):
    """``executor="remote"`` and ``REPRO_EXECUTOR=remote`` select the remote
    executor in both packages; a dedup program and an unpicklable one
    (a lambda word predicate) fall back to threads in both."""
    def compile_both(fn):
        out = {}
        for name, k in PACKAGES.items():
            ds = fn(k)
            frame_nodes, _ = k.P.split_plan(ds.plan)
            out[name] = k.X.compile_shard_program(
                k.P.optimize_plan(frame_nodes, ds.schema), backend="loops")
        return out

    plain = compile_both(lambda k: chain(k, corpus))
    dedup = compile_both(lambda k: chain(k, corpus).drop_duplicates())
    lam = compile_both(lambda k: k.D.from_json_dirs([corpus], FIELDS).with_column(
        "abstract", k.E.col("abstract").remove_words(lambda w: len(w) < 3)))
    cases = [(plain, "remote", None, "remote"), (plain, None, "remote", "remote"),
             (dedup, "remote", None, "thread"), (dedup, None, "remote", "thread"),
             (lam, "remote", None, "thread")]
    for programs, executor, env, want in cases:
        if env is None:
            monkeypatch.delenv("REPRO_EXECUTOR", raising=False)
        else:
            monkeypatch.setenv("REPRO_EXECUTOR", env)
        for name, k in PACKAGES.items():
            ex = k.X.make_executor(k.ing.list_shards([corpus]), programs[name], workers=2,
                                   executor=executor, remote={**FAST, "spawn": False})
            try:
                assert ex.name == want, (name, executor, env)
            finally:
                ex.stop()
    with pytest.raises(PX.UnsupportedPlanError):
        PCO.RemoteShardExecutor(ping.list_shards([corpus]), dedup["port"], workers=2)


def test_empty_corpus(tmp_path):
    d = write_shards(tmp_path, [], n_files=2)
    port = PACKAGES["port"]
    assert records_of(drained(remote(port, ping.list_shards([d]),
                                     program_of(port, chain(port, d))))) == [[], []]


# ---------------------------------------------------------------------------
# workers: no torch under a host backend, no card on the CPU, launch sums
# ---------------------------------------------------------------------------


def test_host_backend_workers_import_no_torch(corpus, tmp_path, monkeypatch):
    """The workers' path puts a ``torch`` that raises on import first: a
    ``loops`` and a ``fused`` run complete, so no worker imported torch;
    a ``device`` run fails at once with that worker's ``ImportError``,
    which shows the trap works and that the failure reaches the caller."""
    trap = tmp_path / "trap" / "torch"
    trap.mkdir(parents=True)
    (trap / "__init__.py").write_text("raise ImportError('torch imported in a shard worker')\n")
    monkeypatch.setenv("PYTHONPATH", str(trap.parent))
    port = PACKAGES["port"]
    shards = ping.list_shards([corpus])
    want = records_of(drained(PX.ThreadShardExecutor(
        shards, program_of(port, chain(port, corpus)), workers=2)))
    for backend in ("loops", "fused"):
        program = program_of(port, chain(port, corpus, backend), backend=backend)
        assert records_of(drained(remote(port, shards, program))) == want
    ex = remote(port, shards, program_of(port, chain(port, corpus, "device"),
                                         backend="device"))
    with pytest.raises(RuntimeError, match="torch imported in a shard worker") as err:
        drained(ex)
    assert "remote worker" in str(err.value)
    assert all(p.poll() is not None for p in ex.workers)


def test_a_worker_without_the_programs_card_raises(corpus, monkeypatch):
    """The program's scans run on ``cuda:0`` and the workers see no card:
    the run fails with the worker's own traceback, and no scan falls back
    to the host."""
    monkeypatch.setattr(PX, "_build_kernels_for", lambda program: None)
    frame_nodes, _ = PP.split_plan(chain(PACKAGES["port"], corpus, "device").plan)
    program = PX.compile_shard_program(PP.optimize_plan(frame_nodes, FIELDS),
                                       backend="device", device="cuda:0")
    ex = remote(PACKAGES["port"], ping.list_shards([corpus]), program)
    with pytest.raises(RuntimeError, match="sees no CUDA device") as err:
        drained(ex)
    assert "Traceback" in str(err.value)


def test_a_remote_run_on_the_cpu_leaves_the_launch_counters_at_zero(corpus):
    port = PACKAGES["port"]
    before = dict(pscan_ops.LAUNCHES)
    program = program_of(port, chain(port, corpus, "device"), backend="device")
    assert len(drained(remote(port, ping.list_shards([corpus]), program))) == 4
    assert pscan_ops.LAUNCHES == before


def dial(address, worker_id):
    s = socket.create_connection(address, timeout=5.0)
    PTR.send_frame(s, "hello", {"worker_id": worker_id})
    kind, meta, payload = PTR.recv_frame(s)
    assert kind == "program"
    return s, meta


def test_accepted_results_add_their_launches_once(corpus):
    """Two hand-driven workers through the executor's coordinator: "slow"
    takes a shard and its lease expires; "fast" delivers its own shard with
    3 launches, then the expired one with 2; slow's late duplicate, with 5,
    is dropped (slow is then told to shut down). The caller adds 3 + 2."""
    port = PACKAGES["port"]
    shards = ping.list_shards([corpus])[:2]
    program = program_of(port, chain(port, corpus))
    ex = remote(port, shards, program, remote={**FAST, "lease_s": 0.3, "spawn": False})
    before = dict(pscan_ops.LAUNCHES)
    ctx = PX.ProgramContext(program, None)

    def deliver(sock, task, launches):
        _, meta, payload = task
        res = ctx.run(bytes(payload), None, meta["digest"], None)
        body, out = PX.pack_shard_result(res, token_space=ctx.token_space)
        body.update(shard_index=meta["shard_index"], program_fp=program_fp, launches=launches)
        PTR.send_frame(sock, "result", body, out)

    slow, hello = dial(ex.address, "slow")
    fast, _ = dial(ex.address, "fast")
    program_fp = hello["program_fp"]
    try:
        first, second = PTR.recv_frame(slow), PTR.recv_frame(fast)
        assert {first[1]["shard_index"], second[1]["shard_index"]} == {0, 1}
        deliver(fast, second, {"text_scan": 3})
        reassigned = PTR.recv_frame(fast)  # slow's shard, once its lease expired
        assert reassigned[0] == "task"
        assert reassigned[1]["shard_index"] == first[1]["shard_index"]
        deliver(fast, reassigned, {"text_scan": 2})
        assert PTR.recv_frame(fast)[0] == "shutdown"
        deliver(slow, first, {"text_scan": 5})
        assert PTR.recv_frame(slow)[0] == "shutdown"  # the duplicate was handled
        assert sorted(r.shard_index for r in ex) == [0, 1]
        assert ex._coord.results.empty()
        assert pscan_ops.LAUNCHES["text_scan"] - before["text_scan"] == 5
    finally:
        slow.close()
        fast.close()
        ex.stop()
        pscan_ops.LAUNCHES.update(before)


# ---------------------------------------------------------------------------
# fault injection: a death costs time, never a result
# ---------------------------------------------------------------------------


def test_kill_one_worker_mid_epoch_gives_the_thread_executors_tokens(corpus, tokenizers):
    """SIGKILL one of two workers after the first result: the epoch
    completes, and every shard's token arrays equal the thread executor's."""
    port = PACKAGES["port"]
    shards = ping.list_shards([corpus])
    program = program_of(port, chain(port, corpus), tok=tokenizers["port"])
    want = tokens_of(drained(PX.ThreadShardExecutor(shards, program, workers=2)))
    ex = remote(port, shards, program)
    try:
        assert len(ex.workers) == 2
        it = iter(ex)
        got = [next(it)]
        os.kill(ex.workers[0].pid, signal.SIGKILL)
        got += list(it)
    finally:
        ex.stop()
    assert tokens_of(sorted(got, key=lambda r: r.shard_index)) == want
    assert ex.workers[0].poll() == -signal.SIGKILL


def test_all_workers_dead_raises(corpus):
    port = PACKAGES["port"]
    ex = remote(port, ping.list_shards([corpus]), program_of(port, chain(port, corpus)))
    for p in ex.workers:
        os.kill(p.pid, signal.SIGKILL)
    with pytest.raises(RuntimeError, match="remote shard workers exited"):
        drained(ex)


def test_worker_exception_fails_fast(tmp_path):
    d = write_shards(tmp_path, fuzz_records(14, 12), n_files=2)
    port = PACKAGES["port"]
    shards = [Path(s) for s in ping.list_shards([d])]
    program = program_of(port, chain(port, d))
    shards[1].unlink()  # a vanished shard: the coordinator's read raises
    ex = remote(port, shards, program, workers=1)
    with pytest.raises(RuntimeError, match="cannot read shard"):
        drained(ex)


def test_coordinator_reassigns_after_tcp_eof(corpus):
    """A hand-driven worker takes a task and drops the connection; the next
    one is offered the same shard."""
    port = PACKAGES["port"]
    coord = PCO.Coordinator(ping.list_shards([corpus])[:1],
                            program_of(port, chain(port, corpus)), lease_s=60.0)
    try:
        flaky, _ = dial(coord.address, "flaky")
        kind, meta, _ = PTR.recv_frame(flaky)
        assert kind == "task" and meta["shard_index"] == 0
        flaky.close()
        steady, _ = dial(coord.address, "steady")
        kind, meta, _ = PTR.recv_frame(steady)
        assert kind == "task" and meta["shard_index"] == 0
        steady.close()
    finally:
        coord.stop()


def test_stale_heartbeat_triggers_reassignment(corpus, tmp_path):
    """A connected worker that beats once and then stops has its socket
    closed by the monitor, and its shard is pending again."""
    port = PACKAGES["port"]
    hb_dir = tmp_path / "beats"
    hb_dir.mkdir()
    coord = PCO.Coordinator(ping.list_shards([corpus])[:1],
                            program_of(port, chain(port, corpus)), lease_s=60.0,
                            heartbeat_dir=hb_dir, heartbeat_timeout=0.3)
    try:
        wedged, _ = dial(coord.address, "wedged")
        PFT.Heartbeat(PWK.heartbeat_path(hb_dir, "wedged"), interval_s=0.0).beat(0, force=True)
        PTR.recv_frame(wedged)  # take the task, then never beat again
        deadline = time.time() + 10.0
        while coord.worker_count() and time.time() < deadline:
            time.sleep(0.05)
        assert coord.worker_count() == 0
        assert coord.leases.acquire("fresh", timeout=1.0) == 0
        wedged.close()
    finally:
        coord.stop()


def test_stop_terminates_workers_promptly(corpus):
    port = PACKAGES["port"]
    ex = remote(port, ping.list_shards([corpus]), program_of(port, chain(port, corpus)))
    try:
        next(iter(ex))  # abandon mid-epoch
    finally:
        t0 = time.monotonic()
        ex.stop()
    assert time.monotonic() - t0 < 10.0
    assert all(p.poll() is not None for p in ex.workers)
    ex.stop()  # idempotent
