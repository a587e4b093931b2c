"""The port's preprocessing slice against the JAX package's: corpus writing,
ingestion and pre-cleaning, ``DeviceCleaner`` (character pass on the
``text_clean`` kernel's plain version, ``col()`` word tail on the host),
the ``BucketGrid``/``DeviceFeed`` overlap engine and the ``AsyncLoader`` /
``ShardPool`` host pipeline. Inputs are made from seeds; the JAX Pallas
kernel runs in interpret mode."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import device_pipeline as JDP
from repro.core import ingest as JI
from repro.core.async_loader import AsyncLoader as JaxAsyncLoader
from repro.core.frame import ColumnarFrame as JaxFrame
from repro.data.synthetic import write_corpus as jax_write_corpus
from repro_torch.core import bytesops as PB
from repro_torch.core import device_pipeline as PDP
from repro_torch.core import expr as PE
from repro_torch.core import ingest as PI
from repro_torch.core.async_loader import AsyncLoader, ShardPool
from repro_torch.core.frame import ColumnarFrame
from repro_torch.data.synthetic import write_corpus
from repro_torch.data.tokenizer import PAD
from repro_torch.kernels.text_clean import ops as clean_ops

FIELDS = ("title", "abstract")
# tests/test_system.py:126's records
SYSTEM_RECORDS = [{"t": "Hello <b>World</b> 42 the a!"}, {"t": "MiXeD (x) CaSe"}]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("device_pipeline_corpus")
    jax_write_corpus(d, total_bytes=250_000, n_files=4, seed=21)
    return d


def columns(frame) -> dict[str, list]:
    return {k: list(v) for k, v in frame.columns.items()}


# ---------------------------------------------------------------------------
# Corpus, ingestion, pre-cleaning
# ---------------------------------------------------------------------------


def test_write_corpus_gives_the_jax_records(tmp_path):
    jax_paths = jax_write_corpus(tmp_path / "jax", total_bytes=60_000, n_files=3, seed=5)
    paths = write_corpus(tmp_path / "port", total_bytes=60_000, n_files=3, seed=5)
    assert [p.name for p in paths] == [p.name for p in jax_paths]
    for p, jp in zip(paths, jax_paths):
        records = [json.loads(line) for line in p.read_bytes().splitlines()]
        assert records == [json.loads(line) for line in jp.read_bytes().splitlines()]
        assert len(records) > 3


@pytest.mark.parametrize("workers", [1, 2])
def test_ingest_and_pre_clean_match_jax(corpus, workers):
    """The port's pool of 1 or 2 spawned workers against the JAX ingest in
    one process (its pool forks, which a process running JAX threads
    should not do)."""
    frame = PI.ingest([corpus], FIELDS, workers=workers)
    jax_frame = JI.ingest([corpus], FIELDS, workers=1)
    assert len(frame) == len(jax_frame) > 100
    assert columns(frame) == columns(jax_frame)
    assert any(v is None for v in frame["abstract"])  # nulls survive ingestion
    clean = PI.pre_clean(frame, list(FIELDS))
    jax_clean = JI.pre_clean(jax_frame, list(FIELDS))
    assert len(clean) < len(frame)
    assert columns(clean) == columns(jax_clean)
    assert PI.list_shards([corpus]) == JI.list_shards([corpus])
    shard = PI.list_shards([corpus])[0]
    assert columns(PI.parse_shard(shard, FIELDS)) == columns(JI.parse_shard(shard, FIELDS))


def test_ingest_normalizes_nul_and_handles_empty(tmp_path):
    (tmp_path / "a.jsonl").write_text(
        json.dumps({"title": "a\x00b", "abstract": None}) + "\n\n"
        + json.dumps({"title": "x", "abstract": "y"}) + "\n")
    frame = PI.ingest([tmp_path], FIELDS)
    assert columns(frame) == columns(JI.ingest([tmp_path], FIELDS))
    assert list(frame["title"]) == ["a b", "x"]
    assert len(PI.ingest([tmp_path / "none"], FIELDS)) == 0


def test_frame_operations_match_jax():
    records = [{"a": "x", "b": "1"}, {"a": None, "b": "2"}, {"a": "x", "b": "1"},
               {"a": "", "b": "3"}, {"a": "y", "b": None}]
    frame, jax_frame = (cls.from_records(records, ["a", "b"]) for cls in (ColumnarFrame, JaxFrame))
    for op in (lambda f: f.dropna(), lambda f: f.drop_duplicates(["a"]),
               lambda f: f.dropna(["a"]).drop_duplicates(), lambda f: f.union(f),
               lambda f: f.select(["b"]).ensure_column("c"), lambda f: f.take([0, 2])):
        assert columns(op(frame)) == columns(op(jax_frame))
    assert frame.to_records() == jax_frame.to_records()
    assert frame.tokens("b") == jax_frame.tokens("b")
    assert frame.flat("a").tobytes() == jax_frame.flat("a").tobytes()


# ---------------------------------------------------------------------------
# DeviceCleaner
# ---------------------------------------------------------------------------


def test_device_case_study_cleaner_matches_jax_on_the_corpus(corpus):
    frame = PI.pre_clean(PI.ingest([corpus], FIELDS), list(FIELDS))
    records = frame.to_records() + [{"title": r["t"], "abstract": r["t"]} for r in SYSTEM_RECORDS]
    frame = ColumnarFrame.from_records(records, FIELDS)
    cleaner = PDP.device_case_study_cleaner(device="cpu")
    before = clean_ops.LAUNCHES["text_clean"]
    got = cleaner.transform(frame, list(FIELDS))
    assert clean_ops.LAUNCHES["text_clean"] == before
    want = JDP.device_case_study_cleaner().transform(JaxFrame.from_records(records, FIELDS),
                                                     list(FIELDS))
    assert columns(got) == columns(want)
    assert list(got["title"][-2:]) == ["hello world", "mixed case"]
    assert cleaner.seconds["device_clean"] > 0 and cleaner.seconds["word_tail"] > 0


WORD_EXPRS = {
    "none": None,
    "stopwords": lambda e: e.remove_stopwords(),
    "custom_stopwords_short": lambda e: e.remove_stopwords(["hello", "case"]).min_word_len(4),
    "replace_collapse": lambda e: e.replace([("hello", "hi  there"), ("x", " ")]).collapse_spaces(),
    "full_chain_again": lambda e: e.lower().strip_html().strip_parens().expand_contractions()
    .keep_letters().collapse_spaces(),
}


@pytest.mark.parametrize("name", sorted(WORD_EXPRS))
def test_device_cleaner_word_chains_match_jax(name):
    rows = [r["t"] for r in SYSTEM_RECORDS] + [
        "It's <i>the</i> (best) WON'T of times", "", "a  b   c", "x<y>x z>", "Case CASE case"]
    records = [{"t": r} for r in rows] + [{"t": None}]
    expr = WORD_EXPRS[name]
    got = PDP.DeviceCleaner(expr, device="cpu").transform(
        ColumnarFrame.from_records(records, ["t"]), ["t"])
    want = JDP.DeviceCleaner(expr).transform(JaxFrame.from_records(records, ["t"]), ["t"])
    assert list(got["t"]) == list(want["t"])


def test_non_chain_word_expr_raises_in_both():
    with pytest.raises(ValueError, match="pure per-column chain"):
        PDP.DeviceCleaner(lambda e: PE.col("title").lower(), device="cpu")
    from repro.core import expr as JE

    with pytest.raises(ValueError, match="pure per-column chain"):
        JDP.DeviceCleaner(lambda e: JE.col("title").lower())
    for cleaner in (lambda f: PDP.DeviceCleaner(f, device="cpu"), JDP.DeviceCleaner):
        with pytest.raises(TypeError, match="cannot compile"):
            cleaner(lambda e: "not an expression")


def test_expr_chain_compiles_to_the_jax_ops():
    """Every verb of the port's chain runs the same bytes as the JAX verb."""
    from repro.core import bytesops as JB
    from repro.core import expr as JE

    def chain(mod):
        return (mod.col("c").lower().strip_html().strip_parens().expand_contractions()
                .keep_letters().collapse_spaces().replace([("ab", "b a")]).remove_stopwords()
                .min_word_len(2))

    kind, source, ops = PE.compile_expr(chain(PE))
    jkind, jsource, jops = JE.compile_expr(chain(JE))
    assert (kind, source, len(ops)) == (jkind, jsource, len(jops)) == ("chain", "c", 9)
    assert chain(PE).describe().split(".")[:6] == chain(JE).describe().split(".")[:6]
    rows = ["Don't <b>STOP</b> (me) now, the ab cab", "", "x\x00y", "a (b <c) d> e f"]
    buf = PB.flatten(rows)
    for i in range(1, len(ops) + 1):
        assert PB.apply_ops(buf, ops[:i]).tobytes() == JB.apply_ops(buf, list(jops[:i])).tobytes()
    with pytest.raises(ValueError, match="NUL"):
        PE.col("c").replace([("\x00", "")])


# ---------------------------------------------------------------------------
# BucketGrid and DeviceFeed, host side, against the JAX feed
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


def _batch(i, rows=4, width=8):
    return {"x": np.full((rows, width), i + 1, dtype=np.int32)}


FEED_CLASSES = {"jax": JDP.DeviceFeed, "torch": PDP.DeviceFeed}


def run_fake_clock_feed(feed_cls, host_s, device_s, n=4):
    clock = FakeClock()

    def src():
        for i in range(n):
            clock.advance(host_s)
            yield _batch(i)

    feed = feed_cls(src(), prefetch=0, device_put=lambda x: x, clock=clock)
    for batch in feed:
        with feed.step(batch):
            clock.advance(device_s)
    return feed.report()


@pytest.mark.parametrize("host_s,device_s", [(2.0, 6.0), (0.0, 3.0), (5.0, 1.0)])
def test_idle_fraction_under_fake_clock_equals_jax(host_s, device_s):
    r = run_fake_clock_feed(PDP.DeviceFeed, host_s, device_s)
    assert r.as_dict() == run_fake_clock_feed(JDP.DeviceFeed, host_s, device_s).as_dict()
    assert r.steps == 4
    assert r.startup_s == pytest.approx(host_s)
    assert r.host_wait_s == pytest.approx(3 * host_s)
    assert r.device_idle_fraction == pytest.approx(3 * host_s / (3 * host_s + 4 * device_s))


SNAP_CASES = {
    "rows_and_width": (4, {"x": (8, 16)}, {"x": np.ones((2, 5), np.int32), "y": np.arange(2)}),
    "on_grid": (2, {"x": (4,)}, {"x": np.full((2, 4), 7, np.int32)}),
    "two_columns": (3, {"a": (2, 6), "b": (5,)}, {"a": np.arange(9, dtype=np.int32).reshape(3, 3),
                                                  "b": np.ones((1, 5), np.int64)}),
    "3d_width": (2, {"x": (4, 8)}, {"x": np.ones((1, 5, 2), np.float32)}),
}


@pytest.mark.parametrize("name", sorted(SNAP_CASES))
def test_grid_snap_equals_jax(name):
    batch_size, widths, batch = SNAP_CASES[name]
    grid, jax_grid = PDP.BucketGrid(batch_size, widths), JDP.BucketGrid(batch_size, widths)
    got, want = grid.snap(batch), jax_grid.snap(batch)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert grid.n_cells == jax_grid.n_cells
    assert grid.cell_key(got) == jax_grid.cell_key(want)


def test_grid_refuses_off_grid_widths_and_bad_ladders():
    for mod in (PDP, JDP):
        with pytest.raises(ValueError, match="beyond the top bucket"):
            mod.BucketGrid(4, {"x": (8, 16)}).snap({"x": np.ones((4, 32), np.int32)})
        with pytest.raises(ValueError, match="batch_size"):
            mod.BucketGrid(0, {"x": (8,)})
        with pytest.raises(ValueError, match="empty bucket ladder"):
            mod.BucketGrid(2, {"x": ()})


@pytest.mark.parametrize("pkg", sorted(FEED_CLASSES))
def test_reuse_after_consume_raises(pkg):
    feed = FEED_CLASSES[pkg](iter([_batch(0), _batch(1)]), prefetch=0, device_put=lambda x: x)
    seen = []
    for batch in feed:
        _ = batch["x"]
        with feed.step(batch):
            seen.append(int(batch["x"].sum()))
        with pytest.raises(RuntimeError, match="reuse after donate"):
            batch["x"]
        with pytest.raises(RuntimeError, match="reuse after donate"):
            batch.arrays
    assert seen == [32, 64]


@pytest.mark.parametrize("pkg", sorted(FEED_CLASSES))
def test_donate_false_allows_rereads(pkg):
    feed = FEED_CLASSES[pkg](iter([_batch(0)]), prefetch=0, device_put=lambda x: x, donate=False)
    [batch] = list(feed)
    with feed.step(batch):
        pass
    assert batch["x"].shape == (4, 8)


def transfer_events(feed_cls):
    events = []

    def fake_put(x):
        events.append(("put", int(x[0, 0]) - 1))
        return x

    feed = feed_cls(iter([_batch(i) for i in range(4)]), prefetch=2, device_put=fake_put)
    for b in feed:
        events.append(("yield", int(np.asarray(b["x"])[0, 0]) - 1))
    return events


def test_transfer_of_next_batch_precedes_yield_as_in_jax():
    events = transfer_events(PDP.DeviceFeed)
    assert events == transfer_events(JDP.DeviceFeed)
    for k in range(3):
        assert events.index(("put", k + 1)) < events.index(("yield", k))


@pytest.mark.parametrize("pkg", sorted(FEED_CLASSES))
def test_close_joins_the_loader(pkg):
    def endless():
        i = 0
        while True:
            yield _batch(i)
            i += 1

    feed = FEED_CLASSES[pkg](endless(), prefetch=2, device_put=lambda x: x)
    it = iter(feed)
    next(it)
    feed.close()
    assert not feed._loader.running


def test_snapped_batches_copied_to_the_cpu_device():
    """The default transfer (no ``device_put``) copies each snapped array to
    the feed's device; on the CPU there is no copy stream and no event."""
    grid = PDP.BucketGrid(3, {"x": (4,)})
    src = [{"x": np.array([[7, 8]], np.int32)}, {"x": np.full((3, 3), 5, np.int32)}]
    feed = PDP.DeviceFeed(iter(src), grid=grid, prefetch=1, device="cpu")
    got = []
    for batch in feed:
        assert isinstance(batch["x"], torch.Tensor) and batch["x"].device.type == "cpu"
        with feed.step(batch):
            got.append(batch["x"].clone())
    jax_feed = JDP.DeviceFeed(iter(src), grid=JDP.BucketGrid(3, {"x": (4,)}), prefetch=0,
                              device_put=lambda x: x)
    for g, want in zip(got, jax_feed):
        np.testing.assert_array_equal(g.numpy(), want["x"])
    assert got[0][0].tolist() == [7, 8, PAD, PAD]
    assert feed.report().steps == 2 and feed.report().transfer_s > 0


def test_feed_and_loader_refuse_sharding_and_default_to_the_card():
    with pytest.raises(NotImplementedError, match="sharding"):
        PDP.DeviceFeed(iter([]), sharding="data", device="cpu")
    with pytest.raises(NotImplementedError, match="sharding"):
        AsyncLoader(iter([]), sharding="data", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            PDP.DeviceFeed(iter([]))
        with pytest.raises(RuntimeError, match="no CUDA card"):
            AsyncLoader(iter([]))
        with pytest.raises(RuntimeError, match="no CUDA card"):
            PDP.device_case_study_cleaner()


# ---------------------------------------------------------------------------
# AsyncLoader and ShardPool (host side; the port's versions of
# tests/test_async_loader.py's cases)
# ---------------------------------------------------------------------------


def _wait_until(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.002)
    return False


def test_loader_prefetch_bound_respected():
    produced = []

    def src():
        for i in range(100):
            produced.append(i)
            yield _batch(i)

    loader = AsyncLoader(src(), prefetch=3, device_put=lambda b: b)
    try:
        assert _wait_until(lambda: len(produced) >= 4)
        time.sleep(0.05)
        assert len(produced) <= 4  # 3 queued + 1 in the blocked put
        assert loader.stats.max_depth <= 3
    finally:
        loader.close()


def test_loader_close_mid_epoch_joins_fill_thread():
    source_closed = []

    class Endless:
        def __iter__(self):
            i = 0
            while True:
                yield _batch(i)
                i += 1

        def close(self):
            source_closed.append(True)

    loader = AsyncLoader(Endless(), prefetch=2, device_put=lambda b: b)
    it = iter(loader)
    for _ in range(3):
        next(it)
    loader.close()
    assert not loader.running
    assert source_closed == [True]


def test_loader_errors_propagate_after_the_good_batches():
    def late():
        for i in range(4):
            yield _batch(i)
        raise ValueError("late failure")

    got = []
    with pytest.raises(ValueError, match="late failure"):
        for b in AsyncLoader(late(), prefetch=8, device_put=lambda b: b):
            got.append(int(b["x"][0, 0]))
    assert got == [1, 2, 3, 4]

    def early():
        raise OSError("no data")
        yield  # pragma: no cover - makes early a generator

    with pytest.raises(OSError, match="no data"):
        list(AsyncLoader(early(), prefetch=1, device_put=lambda b: b))


def loader_events(loader_cls):
    events = []

    def fake_device_put(batch):
        events.append(("put", int(batch["x"][0, 0])))
        return batch

    for b in loader_cls((_batch(i) for i in range(5)), prefetch=2, device_put=fake_device_put):
        events.append(("yield", int(b["x"][0, 0])))
    return events


def test_loader_double_buffering_matches_jax():
    events = loader_events(AsyncLoader)
    assert events == loader_events(JaxAsyncLoader)
    assert [i for kind, i in events if kind == "put"] == [1, 2, 3, 4, 5]
    for k in range(1, 5):
        assert events.index(("put", k + 1)) < events.index(("yield", k))


def test_loader_starvation_counter_and_fake_clock_wait():
    class LockedClock(FakeClock):
        def __init__(self):
            super().__init__()
            self._lock = threading.Lock()

        def advance(self, dt):
            with self._lock:
                self.t += dt

        def __call__(self):
            with self._lock:
                return self.t

    clock = LockedClock()
    gate = threading.Event()

    def src():
        yield _batch(0)
        yield _batch(1)
        gate.wait(timeout=5.0)
        clock.advance(7.0)
        yield _batch(2)

    loader = AsyncLoader(src(), prefetch=2, device_put=lambda b: b, clock=clock)
    it = iter(loader)
    assert _wait_until(lambda: loader.stats.produced >= 2)
    assert int(next(it)["x"][0, 0]) == 1
    assert loader.stats.starvation == 0
    consumed = []
    t = threading.Thread(target=lambda: consumed.extend(it), daemon=True)
    t.start()
    assert _wait_until(lambda: loader.stats.starvation == 1)
    gate.set()
    t.join(timeout=5.0)
    assert len(consumed) == 2
    assert loader.stats.starvation == 1
    assert loader.stats.wait_s == pytest.approx(7.0)
    assert loader.stats.consumed == 3


def test_loader_queue_depth_gauges():
    loader = AsyncLoader((_batch(i) for i in range(10)), prefetch=4, device_put=lambda b: b)
    assert _wait_until(lambda: loader.stats.max_depth >= 4)
    assert len(list(loader)) == 10
    s = loader.stats.as_dict()
    assert (s["prefetch"], s["produced"], s["consumed"]) == (4, 10, 10)
    assert 1 <= s["max_depth"] <= 4


def test_loader_default_copy_to_the_cpu_device():
    """Without a stub, every leaf of nested dicts, lists and tuples comes
    back as a tensor on the loader's device (the reference's
    ``jax.device_put`` default)."""
    batch = {"x": _batch(3)["x"], "pair": (np.arange(3), [np.ones(2, np.float32)])}
    [out] = list(AsyncLoader(iter([batch]), prefetch=1, device="cpu"))
    assert isinstance(out["x"], torch.Tensor) and isinstance(out["pair"], tuple)
    np.testing.assert_array_equal(out["x"].numpy(), batch["x"])
    np.testing.assert_array_equal(out["pair"][0].numpy(), np.arange(3))
    assert out["pair"][1][0].dtype == torch.float32
    assert out["x"].data_ptr() != batch["x"].ctypes.data  # a copy, not a view


def test_shard_pool_processes_every_shard_and_propagates_errors(corpus):
    shards = PI.list_shards([corpus])
    assert sorted(ShardPool(shards, lambda p: p.name, n_readers=3)) == sorted(
        p.name for p in shards)

    def bad(path):
        raise ValueError("bad shard")

    with pytest.raises(ValueError, match="bad shard"):
        list(ShardPool(shards, bad, n_readers=2))
    pool = ShardPool(list(range(50)), lambda i: i, n_readers=2, max_queue=2)
    next(iter(pool))
    pool.stop()  # abandons the rest and joins the readers
    assert not any(t.is_alive() for t in pool._threads)
