"""The port's process shard executor against its thread executor and the
JAX package's process executor on the same shards: records, token arrays,
word counts and batch streams identical under ``loops``, ``fused`` and
``device`` on the CPU; the two-pass ``fit_vocab`` of a partial-subset dedup;
the shard cache's counters; ``make_executor``'s selection held as a table
against the reference's on a spawn-only platform; no shared-memory
segment left after a clean, an abandoned or a SIGKILLed run; workers that
never import torch under a host backend, and that raise where the
program's card is missing. Two workers, four shards, a few hundred rows:
each test spawns its workers anew (about half a second each, two more
when a worker imports torch)."""

import os
import queue
import signal
import subprocess
import sys
import textwrap
import threading
import time
from multiprocessing import shared_memory
from pathlib import Path

import numpy as np
import pytest

from repro.core import executor as JX
from repro.core import expr as JE
from repro.core import ingest as jing
from repro.core import plan as JP
from repro.core.dataset import Dataset as JDataset
from repro.data.batching import TokenSpec as JTokenSpec
from repro.data.tokenizer import WordTokenizer as JWordTokenizer
from repro_torch.core import executor as PX
from repro_torch.core import expr as PE
from repro_torch.core import ingest as ping
from repro_torch.core import plan as PP
from repro_torch.core.dataset import Dataset
from repro_torch.data import batching as PBT
from repro_torch.data.tokenizer import WordTokenizer
from repro_torch.kernels.text_clean import ops as pscan_ops
from test_executor_equivalence import EDGE_RECORDS, FIELDS, fuzz_records, write_shards

ROOT = Path(__file__).resolve().parents[1]
SHM_DIR = Path("/dev/shm")
ENV = ("REPRO_BYTES_BACKEND", "REPRO_EXECUTOR", "REPRO_CACHE", "REPRO_CACHE_DIR",
       "REPRO_WORKERS")
SPECS = (("abstract", 24), ("title", 8))
BACKENDS = ["loops", "fused", "device"]


@pytest.fixture(autouse=True)
def no_engine_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("process_corpus")
    return write_shards(root, EDGE_RECORDS * 4 + fuzz_records(31, 160), n_files=4)


def chain(D, E, d):
    keep = E.col("title").not_empty() & E.col("abstract").not_empty()
    return (D.from_json_dirs([d], FIELDS).where(keep)
            .transform(abstract=E.abstract_expr(), title=E.title_expr()).where(keep))


def port_chain(d, backend="loops"):
    return chain(Dataset, PE, d).backend(backend).device("cpu")


def programs(X, P, ds, tok, specs, **kw):
    """The records, token and word-count programs of one chain."""
    frame_nodes, _ = P.split_plan(ds.plan)
    opt = P.optimize_plan(frame_nodes, ds.schema)
    cols = tuple(dict.fromkeys(s.column for s in specs))
    plan = X.TokenPlan(tuple(specs), dict(tok.stoi), tok.fingerprint)
    return {
        "records": X.compile_shard_program(opt, **kw),
        "tokens": X.compile_shard_program(P.optimize_plan(frame_nodes, cols),
                                          output_columns=cols, tokens=plan, **kw),
        "counts": X.compile_shard_program(opt, output_columns=FIELDS, count_words=FIELDS,
                                          **kw),
    }


def outputs(executor, kind):
    """Each shard's product in shard order: its records, token bytes or
    word counts (a token-space program ships no text columns back)."""
    try:
        results = sorted(executor, key=lambda r: r.shard_index)
    finally:
        executor.stop()
    if kind == "records":
        return [r.frame.to_records() for r in results]
    if kind == "tokens":
        return [{k: (v.dtype, v.shape, v.tobytes()) for k, v in r.tokens.items()}
                for r in results]
    return [r.word_counts for r in results]


@pytest.fixture(scope="module")
def tokenizers(corpus):
    mp = pytest.MonkeyPatch()
    for name in ENV:
        mp.delenv(name, raising=False)
    try:
        records = chain(JDataset, JE, corpus).backend("loops").to_records()
    finally:
        mp.undo()
    words = [r[f] for r in records for f in FIELDS]
    return JWordTokenizer.fit(words, vocab_size=200), WordTokenizer.fit(words, vocab_size=200)


@pytest.fixture(scope="module")
def reference(corpus, tokenizers):
    """The JAX package's process executor on the same shards (``loops``)."""
    jtok, _ = tokenizers
    mp = pytest.MonkeyPatch()
    for name in ENV:
        mp.delenv(name, raising=False)
    try:
        ds = chain(JDataset, JE, corpus).backend("loops")
        shards = jing.list_shards([corpus])
        progs = programs(JX, JP, ds, jtok, [JTokenSpec(c, n) for c, n in SPECS],
                         backend="loops")
        return {k: outputs(JX.ProcessShardExecutor(shards, p, workers=2), k)
                for k, p in progs.items()}
    finally:
        mp.undo()


@pytest.mark.parametrize("backend", BACKENDS)
def test_records_tokens_and_counts_equal_thread_and_reference(corpus, tokenizers, reference,
                                                              backend):
    _, tok = tokenizers
    shards = ping.list_shards([corpus])
    progs = programs(PX, PP, port_chain(corpus, backend), tok,
                     [PBT.TokenSpec(c, n) for c, n in SPECS], backend=backend, device="cpu")
    for kind, program in progs.items():
        proc = PX.ProcessShardExecutor(shards, program, workers=2)
        got = outputs(proc, kind)
        assert got == outputs(PX.ThreadShardExecutor(shards, program, workers=2), kind), kind
        assert got == reference[kind], kind
        assert proc.timings.cleaning > 0 and proc.timings.ingestion > 0
    assert sum(len(r) for r in reference["records"]) > 50


def batch_chain(ds, tok):
    return (ds.tokenize(tok, PBT.seq2seq_specs(24, 8))
            .batched(8, shuffle=False, bucket_by=("encoder_tokens", "decoder_tokens"))
            .prefetch(2))


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_streams_equal_across_executors(corpus, tokenizers, backend):
    """The stream, reassembled in shard order, is the thread executor's
    batch for batch, and the JAX package's process stream (``loops``)."""
    jtok, tok = tokenizers
    runs = {}
    for executor in ("thread", "process"):
        stats = {}
        runs[executor] = list(batch_chain(port_chain(corpus, backend), tok)
                              .workers(2, executor=executor).iter_batches(stats=stats))
        assert stats["executor"] == executor
    assert_batches_equal(runs["process"], runs["thread"])
    want = list(batch_chain(chain(JDataset, JE, corpus).backend("loops"), jtok)
                .workers(2, executor="process").iter_batches())
    assert_batches_equal(runs["process"], want)


def test_two_pass_fit_vocab_under_process_equals_whole_frame(corpus):
    """A partial-subset dedup streams through the election pass and the
    ``dedup_take`` pass on processes, and fits the whole frame's
    vocabulary; its batches equal the thread executor's."""
    def pipe():
        return (Dataset.from_json_dirs([corpus], FIELDS).dropna(FIELDS)
                .drop_duplicates(["title"])
                .transform(abstract=PE.abstract_expr(), title=PE.title_expr())
                .backend("loops").device("cpu"))

    whole = pipe()
    whole.collect()
    want = whole.fit_vocab(vocab_size=64)
    stats = {}
    got = pipe().fit_vocab(vocab_size=64, workers=2, executor="process", stats=stats)
    assert stats["executor"] == "process" and stats["two_pass"] is True
    assert got.itos == want.itos
    jtok = (JDataset.from_json_dirs([corpus], FIELDS).dropna(FIELDS).drop_duplicates(["title"])
            .transform(abstract=JE.abstract_expr(), title=JE.title_expr()).backend("loops")
            .fit_vocab(vocab_size=64, workers=2, executor="process"))
    assert got.itos == jtok.itos
    streams = {ex: list(batch_chain(pipe(), got).workers(2, executor=ex).iter_batches())
               for ex in ("thread", "process")}
    assert_batches_equal(streams["process"], streams["thread"])


def cache_counters(stats):
    return {k: stats.get(k, 0) for k in ("cache_hits", "cache_misses", "token_cache_hits",
                                         "token_cache_misses")}


def test_cache_counters_equal_the_thread_executor(corpus, tokenizers, tmp_path):
    """Fit, cold and warm epochs through the shard cache: the process
    executor's hit and miss counters are the thread executor's, the warm
    epoch reads token arrays only, and every epoch gives the same batches."""
    _, tok = tokenizers
    runs = {}
    for executor in ("thread", "process"):
        ds = port_chain(corpus).workers(2, executor=executor).cache(tmp_path / executor)
        fit, cold, warm = {}, {}, {}
        vocab = ds.fit_vocab(vocab_size=200, stats=fit)
        stream = batch_chain(ds, tok)
        batches = [list(stream.iter_batches(stats=cold)), list(stream.iter_batches(stats=warm))]
        assert fit["executor"] == cold["executor"] == warm["executor"] == executor
        assert_batches_equal(batches[1], batches[0])
        runs[executor] = (vocab.itos, [cache_counters(s) for s in (fit, cold, warm)], batches[0])
    assert runs["process"][:2] == runs["thread"][:2]
    assert_batches_equal(runs["process"][2], runs["thread"][2])
    assert runs["process"][1][2] == {"cache_hits": 0, "cache_misses": 0,
                                     "token_cache_hits": 4 * 2, "token_cache_misses": 0}


class _Stub:
    def __init__(self, name):
        self.name = name

    def __call__(self, *args, **kwargs):
        return self


def test_make_executor_selection_equals_the_reference_on_a_spawn_only_platform(
        corpus, monkeypatch):
    """The selection rules as a table: the port picks processes exactly
    where the reference would on a platform without ``fork``, whose
    workers receive the program pickled."""
    shards = ping.list_shards([corpus])
    jshards = jing.list_shards([corpus])
    for X in (PX, JX):
        monkeypatch.setattr(X, "ProcessShardExecutor", _Stub("process"))
        monkeypatch.setattr(X, "ThreadShardExecutor", _Stub("thread"))
    monkeypatch.setattr(JX.mp, "get_all_start_methods", lambda: ["spawn"])

    def compile_both(fn):
        out = []
        for X, P, D, E in ((PX, PP, Dataset, PE), (JX, JP, JDataset, JE)):
            ds = fn(D, E)
            frame_nodes, _ = P.split_plan(ds.plan)
            out.append(X.compile_shard_program(P.optimize_plan(frame_nodes, ds.schema),
                                               backend="loops"))
        return out

    plain = compile_both(lambda D, E: chain(D, E, corpus))
    dedup = compile_both(lambda D, E: chain(D, E, corpus).drop_duplicates())
    lam = compile_both(lambda D, E: D.from_json_dirs([corpus], FIELDS).with_column(
        "abstract", E.col("abstract").remove_words(lambda w: len(w) < 3)))
    cases = [  # (program pair, workers, executor, REPRO_EXECUTOR, cores, shm, expected)
        (plain, 1, None, None, 4, True, "thread"),
        (plain, 4, None, None, 4, True, "process"),
        (plain, 2, None, None, 4, True, "process"),
        (plain, 4, "thread", None, 4, True, "thread"),
        (plain, 4, "process", None, 4, True, "process"),
        (plain, 1, "process", None, 4, True, "thread"),
        (plain, 4, None, "thread", 4, True, "thread"),
        (plain, 4, None, "process", 4, True, "process"),
        (plain, 1, None, "process", 4, True, "thread"),
        (plain, 4, None, None, 1, True, "thread"),
        (plain, 4, "process", None, 1, True, "process"),
        (plain, 4, None, "process", 1, True, "process"),
        (plain, 4, None, None, None, True, "process"),
        (plain, 4, "process", None, 4, False, "thread"),
        (dedup, 4, None, None, 4, True, "thread"),
        (dedup, 4, "process", None, 4, True, "thread"),
        (lam, 4, None, None, 4, True, "thread"),
        (lam, 4, "process", None, 4, True, "thread"),
    ]
    for i, (pair, workers, executor, env, cores, shm, want) in enumerate(cases):
        if env is None:
            monkeypatch.delenv("REPRO_EXECUTOR", raising=False)
        else:
            monkeypatch.setenv("REPRO_EXECUTOR", env)
        got = []
        for X, program, sh in ((PX, pair[0], shards), (JX, pair[1], jshards)):
            monkeypatch.setattr(X.os, "cpu_count", lambda c=cores: c)
            monkeypatch.setattr(X, "shared_memory_available", lambda s=shm: s)
            got.append(X.make_executor(sh, program, workers=workers, executor=executor).name)
        assert got == [want, want], (i, got)
    monkeypatch.setenv("REPRO_EXECUTOR", "bogus")
    for X, program, sh in ((PX, plain[0], shards), (JX, plain[1], jshards)):
        with pytest.raises(ValueError, match="unknown executor"):
            X.make_executor(sh, program, workers=2)
    monkeypatch.undo()
    with pytest.raises(PX.UnsupportedPlanError):
        PX.ProcessShardExecutor(shards, dedup[0], workers=2)


def run_segments(run_id: str) -> list[str]:
    return sorted(p.name for p in SHM_DIR.glob(f"repro_torch_{run_id}_*"))


def process_executor(corpus, **kw):
    program = PX.compile_shard_program(
        PP.optimize_plan(PP.split_plan(port_chain(corpus).plan)[0], FIELDS), backend="loops")
    return PX.ProcessShardExecutor(ping.list_shards([corpus]), program, workers=2, **kw)


def test_no_segment_outlives_a_clean_an_abandoned_or_a_killed_run(corpus):
    clean = process_executor(corpus)
    assert len(list(clean)) == 4
    clean.stop()
    abandoned = process_executor(corpus)
    next(iter(abandoned))
    abandoned.stop()
    killed = process_executor(corpus, max_inflight=4)
    it = iter(killed)
    next(it)
    for p in killed._procs:
        os.kill(p.pid, signal.SIGKILL)
    try:
        for _ in it:
            pass
    except RuntimeError as e:
        assert "exit code -9" in str(e) or "exited before" in str(e)
    killed.stop()
    for ex in (clean, abandoned, killed):
        deadline = time.monotonic() + 5.0
        while run_segments(ex.run_id) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert run_segments(ex.run_id) == []
        assert not any(p.is_alive() for p in ex._procs)
    assert PX._out_seg_name("abc", 7) == "repro_torch_abc_7"


def test_host_backend_workers_import_no_torch_and_leak_nothing(corpus, tmp_path):
    """In a fresh interpreter whose workers cannot import torch (a
    ``torch`` that raises on import comes first on the path they receive):
    a ``loops`` and a ``fused`` run on processes complete, so no worker
    imported torch, and so does a ``device`` run served whole from the
    shard cache (a worker binds the card only before it runs a shard's
    steps); an abandoned and a SIGKILLed run sweep their segments;
    the resource tracker reports no leaked segment at exit. A ``device``
    run (on the CPU) fails in its workers, which shows the trap works."""
    trap = tmp_path / "trap" / "torch"
    trap.mkdir(parents=True)
    (trap / "__init__.py").write_text("raise ImportError('torch imported in a shard worker')\n")
    code = textwrap.dedent(f"""
        import os, signal, sys
        from pathlib import Path
        from repro_torch.core import executor as PX, ingest, plan as P
        from repro_torch.core.dataset import Dataset
        from repro_torch.core.expr import abstract_expr, col, title_expr
        from repro_torch.data.batching import TokenSpec
        from repro_torch.data.tokenizer import WordTokenizer

        d = Path({str(corpus)!r})
        keep = col("title").not_empty() & col("abstract").not_empty()
        ds = (Dataset.from_json_dirs([d], {FIELDS!r}).where(keep)
              .transform(abstract=abstract_expr(), title=title_expr()).where(keep))
        nodes = P.optimize_plan(P.split_plan(ds.plan)[0], {FIELDS!r})
        shards = ingest.list_shards([d])
        programs = {{b: PX.compile_shard_program(nodes, backend=b, device="cpu")
                    for b in ("loops", "fused", "device")}}
        tok = WordTokenizer.fit(["deep learning for scholarly data"], vocab_size=20)
        programs["cached"] = PX.compile_shard_program(
            nodes, output_columns=("abstract",), backend="device", device="cpu",
            tokens=PX.TokenPlan((TokenSpec("abstract", 8),), dict(tok.stoi), tok.fingerprint))
        cache = Path({str(tmp_path / "cache")!r})
        list(PX.ThreadShardExecutor(shards, programs["cached"], cache_dir=cache))
        sys.path.insert(0, {str(trap.parent)!r})  # the workers' path; torch is loaded here

        def run(backend, stop_after=None, kill=False, **kw):
            ex = PX.ProcessShardExecutor(shards, programs[backend], workers=2, **kw)
            print("run_id", ex.run_id)
            n = 0
            try:
                for res in ex:
                    n += 1
                    if kill:
                        for p in ex._procs:
                            os.kill(p.pid, signal.SIGKILL)
                    if n == stop_after:
                        break
            except RuntimeError as e:
                print("failed:", str(e).splitlines()[-1])
            finally:
                ex.stop()
            return n

        assert run("loops") == 4 and run("fused") == 4
        assert run("cached", cache_dir=cache) == 4  # from the cache: no device bound
        run("loops", stop_after=1)
        run("loops", kill=True)
        run("device")
        print("done")
        """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "done"
    assert "failed: ImportError: torch imported in a shard worker" in proc.stdout
    assert "leaked shared_memory" not in proc.stderr, proc.stderr
    run_ids = [line.split()[1] for line in proc.stdout.splitlines() if line.startswith("run_id ")]
    assert len(run_ids) == 6
    for run_id in run_ids:
        assert run_segments(run_id) == [], run_id


def test_the_sweep_unlinks_an_empty_segment_a_killed_worker_left(corpus):
    """A worker SIGKILLed between ``shm_open`` and ``ftruncate`` leaves a
    0-byte segment under its output name, which cannot be mapped: the sweep
    unlinks it by name and raises nothing, and unlinking a name that is
    gone is a no-op."""
    import _posixshmem

    ex = process_executor(corpus)
    ex.stop()
    name = PX._out_seg_name(ex.run_id, 0)
    os.close(_posixshmem.shm_open("/" + name, os.O_CREAT | os.O_EXCL | os.O_RDWR, mode=0o600))
    assert (SHM_DIR / name).stat().st_size == 0
    with pytest.raises(ValueError, match="empty file"):
        shared_memory.SharedMemory(name=name)
    ex._consumed.discard(0)
    ex._sweep_segments()
    assert run_segments(ex.run_id) == []
    PX._unlink_segment(name)


def test_a_worker_without_the_programs_card_raises(corpus, monkeypatch):
    """The program's scans run on ``cuda:0`` and the workers see no card:
    the run fails with the worker's own traceback, and no scan falls back
    to the host."""
    monkeypatch.setattr(PX, "_build_kernels_for", lambda program: None)
    program = PX.compile_shard_program(
        PP.optimize_plan(PP.split_plan(port_chain(corpus).plan)[0], FIELDS),
        backend="device", device="cuda:0")
    ex = PX.ProcessShardExecutor(ping.list_shards([corpus]), program, workers=2)
    try:
        with pytest.raises(RuntimeError, match="sees no CUDA device") as err:
            list(ex)
        assert "shard worker failed" in str(err.value)
        assert "Traceback" in str(err.value)
    finally:
        ex.stop()
    assert not any(p.is_alive() for p in ex._procs)


def test_a_worker_reports_its_launches_and_the_caller_adds_them(corpus, monkeypatch):
    """The worker loop, driven in this process: each result carries the
    growth of the text kernels' counters during its shard (here a counting
    stand-in for the kernel on the CPU), and ``add_launches`` adds such a
    report to this process's counters."""
    def counting_scan(buf, offsets, **flags):
        pscan_ops._count("text_scan")
        return pscan_ops.text_scan_ref(buf, offsets, **flags)

    monkeypatch.setattr(pscan_ops, "text_scan_op", counting_scan)
    program = PX.compile_shard_program(
        PP.optimize_plan(PP.split_plan(port_chain(corpus).plan)[0], FIELDS),
        backend="device", device="cpu")
    tasks, results = queue.Queue(), queue.Queue()
    segs = []
    for i, path in enumerate(ping.list_shards([corpus])):
        data, digest = ping.read_shard_bytes(path)
        seg = shared_memory.SharedMemory(create=True, size=len(data))
        seg.buf[: len(data)] = data
        segs.append(seg)
        tasks.put((i, seg.name, len(data), digest, None))
    tasks.put(None)
    before = dict(pscan_ops.LAUNCHES)
    worker = threading.Thread(target=PX._worker_main,
                              args=(tasks, results, program, None, "inproc"))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    reports = []
    while not results.empty():
        status, task_id, body = results.get_nowait()
        assert status == "ok", body
        PX._unlink_segment(body["shm"])
        reports.append(body["launches"])
    for seg in segs:
        seg.close()
        seg.unlink()
    assert len(reports) == 4
    assert reports == [{"text_scan": 2}] * 4  # one scan a column and shard
    assert pscan_ops.LAUNCHES["text_scan"] - before["text_scan"] == 8
    pscan_ops.add_launches({"text_scan": 3})
    assert pscan_ops.LAUNCHES["text_scan"] - before["text_scan"] == 11
    pscan_ops.LAUNCHES.update(before)


def test_workers_stop_when_their_caller_dies(corpus):
    """A caller killed before it consumes anything leaves no worker behind:
    each worker's wait for a task is bounded and checks its parent."""
    code = textwrap.dedent(f"""
        import os
        from pathlib import Path
        from repro_torch.core import executor as PX, ingest, plan as P
        from repro_torch.core.dataset import Dataset

        d = Path({str(corpus)!r})
        nodes = P.split_plan(Dataset.from_json_dirs([d], {FIELDS!r}).plan)[0]
        program = PX.compile_shard_program(nodes, backend="loops")
        ex = PX.ProcessShardExecutor(ingest.list_shards([d]), program, workers=2,
                                     max_inflight=1)
        print(" ".join(str(p.pid) for p in ex._procs), flush=True)
        os.kill(os.getpid(), 9)
        """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    pids = [int(p) for p in proc.stdout.split()]
    assert proc.returncode == -signal.SIGKILL and len(pids) == 2

    def alive(pid):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        return True

    deadline = time.monotonic() + 30.0
    while any(alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(alive(p) for p in pids)
