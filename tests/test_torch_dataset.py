"""The port's ``Dataset`` against the JAX package's on a seeded corpus of 4
shards that both packages read: records, token arrays, fitted vocabularies
and batches, whole-frame and streamed at 1 and 2 workers, equal to the
reference's bit for bit (the port under ``loops``, ``fused`` and
``device`` on the CPU, the reference under ``loops``); the count of scans
that reach the kernel equal to the reference's; the process executor
where the reference picks it, and the remote one where it is asked for;
and nothing put on the CPU unless the caller names it."""

from collections import Counter

import numpy as np
import pytest
import torch

import repro.kernels.text_clean.ops as jscan_ops
from repro.core import p3sapp as JP
from repro.core.dataset import Dataset as JDataset
from repro.core import expr as JE
from repro.data import batching as JBT
from repro.data.synthetic import write_corpus
from repro_torch.core import executor as PX
from repro_torch.core import expr as PE
from repro_torch.core import p3sapp as PP
from repro_torch.core.async_loader import AsyncLoader
from repro_torch.core.dataset import Dataset
from repro_torch.core.device_pipeline import DeviceBatch, DeviceFeed
from repro_torch.data import batching as PBT
from repro_torch.kernels.text_clean import ops as pscan_ops
from repro_torch.runtime.train_loop import make_input_pipeline

N_SHARDS = 4
ENV = ("REPRO_BYTES_BACKEND", "REPRO_EXECUTOR", "REPRO_CACHE", "REPRO_CACHE_DIR",
       "REPRO_WORKERS")


@pytest.fixture(autouse=True)
def no_engine_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("dataset_corpus")
    write_corpus(d, total_bytes=300_000, n_files=N_SHARDS, seed=11)
    return d


def clean_chain(D, E, corpus, dedup=True):
    """The reference example's chain (``examples/train_summarizer.py:50-56``)."""
    keep = E.col("title").not_empty() & E.col("abstract").not_empty()
    ds = D.from_json_dirs([corpus]).where(keep)
    if dedup:
        ds = ds.drop_duplicates()
    return ds.transform(abstract=E.abstract_expr(), title=E.title_expr()).where(keep)


def ref_chain(corpus, dedup=True):
    return clean_chain(JDataset, JE, corpus, dedup).backend("loops")


def port_chain(corpus, dedup=True, backend="device"):
    return clean_chain(Dataset, PE, corpus, dedup).backend(backend).device("cpu")


def batch_chain(ds, tok, specs_mod, shuffle=True):
    return (ds.tokenize(tok, specs_mod.seq2seq_specs(32, 8))
            .batched(16, shuffle=shuffle, bucket_by=("encoder_tokens", "decoder_tokens"))
            .prefetch(2))


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def rows_of(batches):
    """The multiset of (encoder, decoder) rows, PAD-trimmed."""
    out = Counter()
    for b in batches:
        for enc, dec in zip(b["encoder_tokens"], b["decoder_tokens"]):
            out[(tuple(np.trim_zeros(enc, "b")), tuple(np.trim_zeros(dec, "b")))] += 1
    return out


@pytest.fixture(scope="module")
def reference(corpus):
    """The JAX package's records, vocabulary, arrays and batches (loops)."""
    mp = pytest.MonkeyPatch()
    for name in ENV:
        mp.delenv(name, raising=False)
    try:
        records, _ = ref_chain(corpus).execute(optimize=True)
        tok = ref_chain(corpus).workers(1).fit_vocab(vocab_size=400)
        specs = JBT.seq2seq_specs(32, 8)
        arrays = ref_chain(corpus).tokenize(tok, specs).arrays()
        streamed = {d: list(batch_chain(ref_chain(corpus, d), tok, JBT).workers(1)
                            .iter_batches()) for d in (True, False)}
    finally:
        mp.undo()
    assert len(records) > 100
    return {"records": records, "stoi": tok.stoi, "arrays": arrays, "streamed": streamed}


@pytest.mark.parametrize("backend", ["loops", "fused", "device"])
@pytest.mark.parametrize("optimize", [False, True])
def test_whole_frame_records_equal_the_reference(corpus, reference, backend, optimize):
    ds = port_chain(corpus, backend=backend)
    records, t = ds.execute(optimize=optimize)
    assert records == reference["records"]
    assert t.ingestion > 0 and t.cleaning > 0 and t.tokenize == 0
    assert ds.to_records(optimize=optimize) == records
    assert ds.collect(optimize=optimize).to_records() == records


def test_fit_vocab_streamed_and_memoized_equal_the_reference(corpus, reference):
    stats = {}
    streamed = port_chain(corpus).workers(2).fit_vocab(vocab_size=400, stats=stats)
    assert stats["executor"] == "thread" and streamed.stoi == reference["stoi"]
    ds = port_chain(corpus, backend="fused")
    ds.execute()
    stats = {}
    assert ds.fit_vocab(vocab_size=400, stats=stats).stoi == reference["stoi"]
    assert stats["executor"] == "whole-frame"


@pytest.mark.parametrize("backend", ["loops", "device"])
def test_arrays_equal_the_reference(corpus, reference, backend):
    tok = port_chain(corpus).fit_vocab(vocab_size=400)
    got = port_chain(corpus, backend=backend).tokenize(tok, PBT.seq2seq_specs(32, 8)).arrays()
    assert got.keys() == reference["arrays"].keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, reference["arrays"][k])


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_streamed_batches_equal_the_reference(corpus, reference, dedup, workers):
    """Bit for bit at every worker count, the cross-shard dedup included:
    the port's threads take their dedup turns in shard order, so their
    stream is the reference's one-thread stream. Without the dedup, more
    than one worker runs on processes, as in the reference."""
    tok = port_chain(corpus).fit_vocab(vocab_size=400)
    stats = {}
    got = list(batch_chain(port_chain(corpus, dedup), tok, PBT).workers(workers)
               .iter_batches(stats=stats))
    assert stats["executor"] == ("process" if workers > 1 and not dedup else "thread")
    assert_batches_equal(got, reference["streamed"][dedup])


def test_cross_shard_duplicates_survive_where_whole_frame_keeps_them(tmp_path):
    """Shard 1 repeats shard 0's rows and is the smaller file, so its thread
    reaches the dedup step first; the first copy still survives in shard
    0, as whole-frame ``drop_duplicates`` keeps it."""
    rows = [f'{{"title": "t{i}", "abstract": "a{i} x"}}\n' for i in range(400)]
    (tmp_path / "s0.jsonl").write_text("".join(rows))
    (tmp_path / "s1.jsonl").write_text("".join(rows[:5]) + '{"title": "n", "abstract": "b"}\n')
    ds = (Dataset.from_json_dirs([tmp_path]).drop_duplicates()
          .with_column("abstract", PE.col("abstract").lower()).device("cpu"))
    tok = ds.fit_vocab(vocab_size=500)
    whole = ds.tokenize(tok, col="title", max_len=2).batch(7, shuffle=False,
                                                            drop_remainder=False)
    want = list(whole.iter_batches())
    for _ in range(5):
        got = list(Dataset.from_json_dirs([tmp_path]).drop_duplicates()
                   .with_column("abstract", PE.col("abstract").lower()).device("cpu")
                   .workers(2).tokenize(tok, col="title", max_len=2)
                   .batch(7, shuffle=False, drop_remainder=False).prefetch(2).iter_batches())
        assert_batches_equal(got, want)


def test_whole_frame_batches_equal_the_reference(corpus, reference):
    tok = port_chain(corpus).fit_vocab(vocab_size=400)
    jtok = ref_chain(corpus).workers(1).fit_vocab(vocab_size=400)
    for shuffle in (False, True):
        got = list(port_chain(corpus).tokenize(tok, PBT.seq2seq_specs(32, 8))
                   .batched(16, shuffle=shuffle, bucket_by="encoder_tokens")
                   .iter_batches(epochs=2))
        want = list(ref_chain(corpus).tokenize(jtok, JBT.seq2seq_specs(32, 8))
                    .batched(16, shuffle=shuffle, bucket_by="encoder_tokens")
                    .iter_batches(epochs=2))
        assert_batches_equal(got, want)


@pytest.fixture
def scan_counts(monkeypatch):
    """Calls that reach ``scan_flat`` in each package: the port's run its
    plain version on the CPU; the reference's decline, so its ``pallas``
    backend takes the host scan (the same bytes) and the count is of the
    calls alone."""
    counts = {"port": 0, "ref": 0}
    plain = pscan_ops.scan_flat

    def port_scan(buf, **kw):
        counts["port"] += 1
        return plain(buf, **kw)

    def ref_scan(buf, **kw):
        counts["ref"] += 1

    monkeypatch.setattr(pscan_ops, "scan_flat", port_scan)
    monkeypatch.setattr(jscan_ops, "scan_flat", ref_scan)
    return counts


@pytest.mark.parametrize("optimize,kernel_scans", [(False, 4), (True, 2)])
def test_run_p3sapp_equals_the_reference_and_counts_its_scans(corpus, scan_counts, optimize,
                                                              kernel_scans):
    with pytest.warns(DeprecationWarning):
        want, _ = JP.p3sapp_dataset([corpus]).backend("pallas").execute(optimize=optimize)
    assert scan_counts["ref"] == kernel_scans
    with pytest.warns(DeprecationWarning):
        got, t = PP.run_p3sapp([corpus], optimize=optimize, device="cpu")
    assert scan_counts["port"] == kernel_scans
    assert got == want and t.tokenize == 0
    with pytest.warns(DeprecationWarning):
        assert JP.run_p3sapp([corpus], optimize=optimize)[0] == want


def test_stage_and_expression_spellings_give_the_same_records(corpus):
    with pytest.warns(DeprecationWarning):
        stages = PP.p3sapp_dataset([corpus]).device("cpu")
    fields = ["title", "abstract"]
    exprs = (Dataset.from_json_dirs([corpus]).dropna(fields).drop_duplicates(fields)
             .transform(abstract=PE.abstract_expr(), title=PE.title_expr())
             .dropna(fields).device("cpu"))
    for optimize in (False, True):
        assert stages.to_records(optimize=optimize) == exprs.to_records(optimize=optimize)


def test_streamed_scan_counts_equal_the_reference(corpus, scan_counts):
    """fit_vocab and an epoch of the dedup chain: one kernel scan per
    shard and column, in each package, on the main thread's count."""
    jtok = ref_chain(corpus).backend("pallas").workers(1).fit_vocab(vocab_size=400)
    tok = port_chain(corpus).workers(1).fit_vocab(vocab_size=400)
    assert scan_counts == {"port": 2 * N_SHARDS, "ref": 2 * N_SHARDS}
    list(batch_chain(ref_chain(corpus).backend("pallas"), jtok, JBT).workers(1).iter_batches())
    list(batch_chain(port_chain(corpus), tok, PBT).workers(1).iter_batches())
    assert scan_counts == {"port": 4 * N_SHARDS, "ref": 4 * N_SHARDS}


def test_the_remote_and_process_executors_give_the_thread_executors_result(corpus,
                                                                          monkeypatch):
    """``remote``, as a name, a ``remote=`` option or ``REPRO_EXECUTOR``,
    and ``process``, explicit or from ``REPRO_EXECUTOR``, run and give the
    thread executor's batches and vocabulary; an unknown name raises; the
    dedup chain falls back to threads on either, as the reference's does."""
    fast = {"lease_s": 5.0, "heartbeat_timeout": 3.0, "heartbeat_interval_s": 0.1}
    ds = port_chain(corpus, dedup=False)
    tok = ds.fit_vocab(vocab_size=400)
    with pytest.raises(ValueError, match="unknown executor"):
        ds.workers(2, executor="fiber")
    shards = sorted(corpus.glob("*.jsonl"))
    program = PX.compile_shard_program([ds.plan[0]], backend="loops")
    for remote in (fast, {"spawn": False}):
        ex = PX.make_executor(shards, program, executor="remote", remote=remote)
        try:
            assert ex.name == "remote"
        finally:
            ex.stop()
    threads = list(batch_chain(ds, tok, PBT).workers(2, executor="thread").iter_batches())
    for kw in ({"executor": "process"}, {"executor": "remote"}, {"remote": fast}):
        stats = {}
        assert_batches_equal(list(batch_chain(ds, tok, PBT).workers(2, **kw)
                                  .iter_batches(stats=stats)), threads)
        assert stats["executor"] == kw.get("executor", "remote")
    for executor in ("process", "remote"):
        stats = {}
        assert len(list(batch_chain(port_chain(corpus), tok, PBT).workers(2, executor=executor)
                        .iter_batches(stats=stats))) > 0
        assert stats["executor"] == "thread"
    for executor in ("process", "remote"):
        monkeypatch.setenv("REPRO_EXECUTOR", executor)
        stats = {}
        assert ds.workers(2).fit_vocab(vocab_size=400, stats=stats).stoi == tok.stoi
        assert stats["executor"] == executor
    stats = {}
    assert len(list(batch_chain(port_chain(corpus), tok, PBT).iter_batches(stats=stats))) > 0
    assert stats["executor"] == "thread"
    monkeypatch.setenv("REPRO_EXECUTOR", "thread")
    stats = {}
    assert len(list(batch_chain(port_chain(corpus), tok, PBT).workers(3)
                    .iter_batches(stats=stats))) > 0
    assert stats["executor"] == "thread"


def test_without_a_card_nothing_runs_unless_the_cpu_is_named(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = clean_chain(Dataset, PE, corpus)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ds.execute()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ds.fit_vocab(vocab_size=50)
    assert ds.execute(device="cpu")[0] == ds.device("cpu").execute()[0]
    assert ds.backend("fused").execute()[0] == ds.execute(device="cpu")[0]
    tok = ds.device("cpu").fit_vocab(vocab_size=50)
    streamed = batch_chain(clean_chain(Dataset, PE, corpus), tok, PBT)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        streamed.iter_batches()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        streamed.device_batches()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_input_pipeline(streamed.backend("loops"))
    # a sharded feed on a one-rank mesh: DTensors with every row on the rank
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import destroy_process_group, make_host_mesh

    mesh = make_host_mesh(1, device="cpu")
    try:
        sharded = list(streamed.device_batches(device="cpu",
                                               sharding=NamedSharding(mesh, P("data"))))
    finally:
        destroy_process_group()
    whole = list(streamed.device_batches(device="cpu"))
    assert len(sharded) == len(whole) > 0
    for got, want in zip(sharded, whole):
        assert got.keys() == want.keys()
        for k in want:
            assert isinstance(got[k], DTensor)
            # one rank holds every row: its mesh dimensions replicate
            assert got[k].placements == (Replicate(), Replicate())
            assert torch.equal(got[k].to_local(), want[k])


def test_device_batches_copy_the_host_batches(corpus):
    tok = port_chain(corpus).fit_vocab(vocab_size=400)
    chain = batch_chain(port_chain(corpus, dedup=False), tok, PBT).workers(2)
    host = list(chain.iter_batches())
    loader = chain.device_batches()
    assert isinstance(loader, AsyncLoader)
    got = list(loader)
    assert len(got) == len(host)
    for a, b in zip(got, host):
        for k in b:
            assert a[k].device == torch.device("cpu")
            np.testing.assert_array_equal(a[k].numpy(), b[k])


@pytest.mark.parametrize("via", ["device_batches", "make_input_pipeline"])
def test_the_feed_puts_every_batch_on_the_grid(corpus, via):
    tok = port_chain(corpus).fit_vocab(vocab_size=400)
    # no cross-shard dedup: at 2 workers its survivors' shards would vary
    chain = batch_chain(port_chain(corpus, dedup=False), tok, PBT, shuffle=False)
    grid = chain.bucket_grid_spec()
    assert grid.widths == {"encoder_tokens": PBT.derive_buckets(32),
                           "decoder_tokens": PBT.derive_buckets(8)}
    stats = {}
    feed = (chain.device_batches(overlap=True) if via == "device_batches"
            else make_input_pipeline(chain, epochs=1, overlap=True, stats=stats))
    assert isinstance(feed, DeviceFeed)
    host = list(chain.iter_batches())
    n = 0
    for batch, want in zip(feed, host):
        assert isinstance(batch, DeviceBatch)
        with feed.step(batch):
            for k, widths in grid.widths.items():
                assert batch[k].shape[0] == 16 and batch[k].shape[1] in widths
                w = want[k]
                np.testing.assert_array_equal(batch[k].numpy()[: len(w), : w.shape[1]], w)
        n += 1
    feed.close()
    assert n == len(host) > 0
    if via == "make_input_pipeline":
        assert stats["executor"] == "process"  # two workers by default, no dedup


def test_counts_and_dedup_turns_hold_under_thread_stress(corpus, reference):
    """More threads than cores with a short switch interval: the launch
    counter loses no update, and a dedup stream on 16 threads is still the
    reference's one-thread stream."""
    import sys
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = pscan_ops.LAUNCHES["text_scan"]
        threads = [threading.Thread(target=lambda: [pscan_ops._count("text_scan")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert pscan_ops.LAUNCHES["text_scan"] - before == 16 * 2000
        pscan_ops.LAUNCHES["text_scan"] = before
        tok = port_chain(corpus).fit_vocab(vocab_size=400)
        got = list(batch_chain(port_chain(corpus), tok, PBT).workers(16).iter_batches())
    finally:
        sys.setswitchinterval(old)
    assert_batches_equal(got, reference["streamed"][True])
