"""The port's shard cache against the JAX package's, on a seeded corpus of 4
shards, both at ``workers=1`` on threads: the hit and miss counters of
``fit_vocab``, a cold epoch and a warm epoch equal the reference's, with
the cross-shard ``drop_duplicates`` (nothing cached, all four counters 0)
and without it; any change of a plan parameter misses as the reference's
does; no fingerprint or key of the port coincides with the reference's,
even in one cache directory; and a torn or corrupt entry is never read."""

import os

import numpy as np
import pytest

from repro.core import executor as JX
from repro.core import expr as JE
from repro.core import plan as JPL
from repro.core.dataset import Dataset as JDataset
from repro.data import batching as JBT
from repro.data.synthetic import write_corpus
from repro_torch.core import bytesops as PB
from repro_torch.core import executor as PX
from repro_torch.core import expr as PE
from repro_torch.core import plan as PPL
from repro_torch.core.dataset import Dataset
from repro_torch.data import batching as PBT

N_SHARDS = 4
COUNTERS = ("cache_hits", "cache_misses", "token_cache_hits", "token_cache_misses")


@pytest.fixture(autouse=True)
def no_engine_env(monkeypatch):
    for name in ("REPRO_BYTES_BACKEND", "REPRO_EXECUTOR", "REPRO_CACHE", "REPRO_CACHE_DIR",
                 "REPRO_WORKERS"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cache_corpus")
    write_corpus(d, total_bytes=250_000, n_files=N_SHARDS, seed=5)
    return d


def chain(D, E, corpus, dedup=False, threshold=1, needle=None):
    keep = E.col("title").not_empty() & E.col("abstract").not_empty()
    ds = D.from_json_dirs([corpus]).where(keep)
    if dedup:
        ds = ds.drop_duplicates()
    if needle is not None:
        ds = ds.where(~E.col("abstract").contains(needle))
    return ds.transform(abstract=E.abstract_expr(), title=E.title_expr(threshold=threshold)) \
        .where(keep)


def ref(corpus, cache_dir, **kw):
    return chain(JDataset, JE, corpus, **kw).backend("loops").workers(1).cache(cache_dir)


def port(corpus, cache_dir, **kw):
    return chain(Dataset, PE, corpus, **kw).device("cpu").workers(1).cache(cache_dir)


def run(ds, batching, vocab=300, max_len=32):
    """fit_vocab, then two epochs: the counters of each and the batches."""
    fit = {}
    tok = ds.fit_vocab(vocab_size=vocab, stats=fit)
    counts, batches = [{k: fit.get(k, 0) for k in COUNTERS}], []
    stream = (ds.tokenize(tok, batching.seq2seq_specs(max_len, 8))
              .batched(16, shuffle=True, bucket_by=("encoder_tokens", "decoder_tokens"))
              .prefetch(2))
    for _ in range(2):
        stats = {}
        batches.append(list(stream.iter_batches(stats=stats)))
        assert stats["executor"] == "thread"
        counts.append({k: stats[k] for k in COUNTERS})
    return counts, batches


def same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_the_counters_equal_the_reference_without_dedup(corpus, tmp_path):
    got, (cold, warm) = run(port(corpus, tmp_path / "port"), PBT)
    want, (jcold, _) = run(ref(corpus, tmp_path / "ref"), JBT)
    assert got == want
    fit, c, w = got
    assert fit == {"cache_hits": 0, "cache_misses": 0, "token_cache_hits": 0,
                   "token_cache_misses": N_SHARDS}
    assert c == {"cache_hits": 2 * N_SHARDS, "cache_misses": 0, "token_cache_hits": 0,
                 "token_cache_misses": 2 * N_SHARDS}
    assert w == {"cache_hits": 0, "cache_misses": 0, "token_cache_hits": 2 * N_SHARDS,
                 "token_cache_misses": 0}
    same_batches(warm, cold)
    same_batches(cold, jcold)


def test_the_dedup_chain_never_touches_the_cache(corpus, tmp_path):
    got, (cold, warm) = run(port(corpus, tmp_path / "port", dedup=True), PBT)
    want, _ = run(ref(corpus, tmp_path / "ref", dedup=True), JBT)
    assert got == want == [dict.fromkeys(COUNTERS, 0)] * 3
    assert not any((tmp_path / "port").iterdir())
    same_batches(warm, cold)


VARIANTS = {
    "title threshold": dict(threshold=2),
    "a new filter": dict(needle="model"),
    "a wider encoder": dict(max_len=48),
    "another vocabulary": dict(vocab=200),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_a_changed_parameter_misses_as_the_reference(corpus, tmp_path, variant):
    kw = dict(VARIANTS[variant])
    run_kw = {k: kw.pop(k) for k in ("max_len", "vocab") if k in kw}
    counts = {}
    for name, build, batching in (("port", port, PBT), ("ref", ref, JBT)):
        run(build(corpus, tmp_path / name), batching)  # warm the cache
        counts[name], _ = run(build(corpus, tmp_path / name, **kw), batching, **run_kw)
    assert counts["port"] == counts["ref"]
    fit, cold, _ = counts["port"]
    assert fit["token_cache_misses"] + cold["cache_misses"] + cold["token_cache_misses"] > 0


def program(ns_dataset, ns_plan, ns_exec, E, corpus, tok, batching):
    ds = chain(ns_dataset, E, corpus)
    frame, _ = ns_plan.split_plan(ds.plan)
    frame = ns_plan.optimize_plan(frame, ("abstract", "title"))
    tokens = ns_exec.TokenPlan(tuple(batching.seq2seq_specs(32, 8)), dict(tok.stoi),
                               tok.fingerprint)
    return ns_exec.compile_shard_program(frame, tokens=tokens, count_words=("abstract",),
                                         backend="loops")


def test_no_fingerprint_or_key_coincides_with_the_reference(corpus, tmp_path):
    jtok = chain(JDataset, JE, corpus).backend("loops").workers(1).fit_vocab(vocab_size=300)
    tok = chain(Dataset, PE, corpus).device("cpu").fit_vocab(vocab_size=300)
    assert jtok.fingerprint == tok.fingerprint
    jp = program(JDataset, JPL, JX, JE, corpus, jtok, JBT)
    pp = program(Dataset, PPL, PX, PE, corpus, tok, PBT)

    def fps(X, p):
        out = {fp for step in X.step_column_fingerprints(p).values() for fp in step.values()}
        out |= set(X.column_fingerprints(p).values()) | set(X.token_fingerprints(p).values())
        return out | {X.count_fingerprint(p), X.program_fingerprint(p)}

    assert not fps(JX, jp) & fps(PX, pp)
    assert len(fps(PX, pp)) > 5
    assert JX.ShardCache(tmp_path / "j").key("d", "c", "f") != \
        PX.ShardCache(tmp_path / "p").key("d", "c", "f")
    assert PX.default_cache_dir().name == "repro_torch_shard_cache"
    # one directory for both: the port's first run is cold after the reference's
    shared = tmp_path / "shared"
    run(ref(corpus, shared), JBT)
    ref_files = set(os.listdir(shared))
    got, _ = run(port(corpus, shared), PBT)
    cold, _ = run(port(corpus, tmp_path / "fresh"), PBT)
    assert got == cold
    assert not ref_files & (set(os.listdir(shared)) - ref_files) and \
        len(os.listdir(shared)) > len(ref_files)


def test_a_torn_or_corrupt_entry_is_never_read(tmp_path, monkeypatch):
    cache = PX.ShardCache(tmp_path)
    good = np.arange(40, dtype=np.uint8)
    key = cache.key("digest", "abstract", "fp")
    cache.store(key, good)
    np.testing.assert_array_equal(cache.load(key), good)
    assert [p.name for p in tmp_path.iterdir()] == [f"{key}.npy"]
    # a torn file where the entry should be: a miss, and the file goes
    raw = (tmp_path / f"{key}.npy").read_bytes()
    (tmp_path / f"{key}.npy").write_bytes(raw[: len(raw) // 2])
    assert cache.load(key) is None and not (tmp_path / f"{key}.npy").exists()
    # a write that dies half way leaves no entry and no temp file
    real_save = np.save

    def dying_save(fh, arr, allow_pickle=False):
        fh.write(b"\x93NUMPY partial")
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", dying_save)
    cache.store(key, good)
    assert not any(tmp_path.iterdir()) and cache.load(key) is None
    # the entry appears only whole: at the rename the temp file loads
    seen = []
    real_replace = os.replace

    def checked_replace(src, dst):
        seen.append(np.load(src, allow_pickle=False).tobytes())
        return real_replace(src, dst)

    monkeypatch.setattr(np, "save", real_save)
    monkeypatch.setattr(os, "replace", checked_replace)
    tokens = np.arange(24, dtype=np.int32).reshape(3, 8)
    cache.store(key, tokens)
    assert seen == [tokens.tobytes()]
    assert cache.load(key) is None  # a token array is no text entry: a miss
    cache.store(key, tokens)
    np.testing.assert_array_equal(cache.load_tokens(key, 8), tokens)
    assert cache.load_tokens(key, 9) is None
    cache.store_counts(key, {"a": 2})
    assert cache.load_counts(key) == {"a": 2}
    assert PB.PORT_TAG.startswith(b"repro_torch")


def test_a_corrupt_token_entry_recomputes_its_shard(corpus, tmp_path):
    root = tmp_path / "cache"
    _, (cold, _) = run(port(corpus, root), PBT)
    for path in sorted(root.iterdir())[:3]:
        path.write_bytes(b"garbage")
    counts, (again, _) = run(port(corpus, root), PBT)
    same_batches(again, cold)
    assert sum(c["cache_misses"] + c["token_cache_misses"] for c in counts) > 0
