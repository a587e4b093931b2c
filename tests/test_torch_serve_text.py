"""Text serving in the port: ``serve_text`` over ``Dataset.row_program()``
against the JAX package's ``serve_text`` on the SMOKE StableLM-3B with the
JAX ``init``'s parameters (``init_scale=1``, so the layers steer the greedy
tokens) carried by the bridge: token lists exactly equal and every
``ServeStats`` counter equal, over two waves that share one ring cache and
shed load on arrival. The admission queue and the ring cache alone, the
slot loop's refill, filtering and caching on a deterministic echo model,
the serve hot path's import contract (the reference's rule R005) and the
example ``examples/serve_summarizer_torch.py`` on the CPU. Mirrors
``tests/test_serve_loop.py``."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.core.dataset import Dataset as JDataset
from repro.core import expr as JE
from repro.data.batching import TokenSpec as JTokenSpec
from repro.models.lm import LM as JaxLM
from repro.runtime import serve_loop as JS
from repro_torch.configs import get_smoke
from repro_torch.core import expr as PE
from repro_torch.core.dataset import Dataset
from repro_torch.data.batching import TokenSpec
from repro_torch.models.lm import LM
from repro_torch.runtime.serve_loop import (AdmissionQueue, RingCache, ServeStats, TextRequest,
                                            serve_text)

ROOT = Path(__file__).resolve().parents[1]
ENV = ("REPRO_BYTES_BACKEND", "REPRO_EXECUTOR", "REPRO_CACHE", "REPRO_CACHE_DIR",
       "REPRO_WORKERS")
CORPUS = [
    {"abstract": "deep learning methods for scholarly metadata extraction"},
    {"abstract": "spark pipelines accelerate large corpus preprocessing work"},
    {"abstract": "attention models summarize scientific abstracts neatly"},
    {"abstract": "tokenization vocabulary coverage affects downstream quality"},
    {"abstract": "distributed executors shard the cleaning workload evenly"},
    {"abstract": "ring buffers bound the decode cache memory footprint"},
]
COUNTERS = ("admitted", "rejected", "filtered", "served", "cache_hits", "cache_misses")


@pytest.fixture(scope="module")
def row_programs(tmp_path_factory):
    """The port's row program (``device`` on the CPU) and the reference's
    (``loops``) over one corpus, with equal vocabularies."""
    d = tmp_path_factory.mktemp("serve_text_corpus")
    with open(d / "shard-0.jsonl", "w", encoding="utf-8") as f:
        for r in CORPUS:
            f.write(json.dumps(r) + "\n")
    mp = pytest.MonkeyPatch()
    for name in ENV:
        mp.delenv(name, raising=False)
    try:
        out = []
        for D, E, T in ((Dataset, PE, TokenSpec), (JDataset, JE, JTokenSpec)):
            ds = (D.from_json_dirs([d], fields=("abstract",))
                  .where(E.col("abstract").not_empty()).transform(abstract=E.abstract_expr()))
            ds = ds.device("cpu") if D is Dataset else ds.backend("loops")
            tok = ds.fit_vocab(vocab_size=200)
            out.append((ds.tokenize(tok, [T("abstract", 16)]).batched(2).prefetch(2)
                        .row_program(), tok))
    finally:
        mp.undo()
    (rp, tok), (jrp, jtok) = out
    assert tok.stoi == jtok.stoi and rp.device == "cpu"
    return rp, jrp, tok


class _EchoModel:
    """argmax(one_hot(t)) == t: prefill emits the prompt's last token and
    decode repeats it, making every serve run deterministic and instant."""

    device = torch.device("cpu")

    def init_decode_state(self, b, max_seq):
        return torch.zeros(b, dtype=torch.int32)

    def decode_step(self, tokens, state, pos):
        return torch.nn.functional.one_hot(tokens.long(), 512).float(), state


def test_admission_queue_sheds_on_arrival():
    q = AdmissionQueue(maxsize=2)
    assert q.offer("a") and q.offer("b")
    assert not q.offer("c")
    assert (q.admitted, q.rejected, len(q)) == (2, 1, 2)
    assert q.pop() == "a"
    assert q.offer("d")
    assert q.pop() == "b" and q.pop() == "d" and q.pop() is None
    with pytest.raises(ValueError):
        AdmissionQueue(maxsize=0)


def test_ring_cache_fifo_eviction_and_accounting():
    c = RingCache(slots=2)
    assert c.get("k1") is None
    c.put("k1", [1, 2])
    c.put("k2", [3])
    assert c.get("k1") == [1, 2]
    c.put("k3", [4])  # evicts k1, the oldest inserted
    assert len(c) == 2 and c.get("k1") is None and c.get("k3") == [4]
    assert (c.hits, c.misses, c.evictions) == (2, 2, 1)
    c.put("k2", [5, 6])  # an update neither grows nor evicts
    assert (len(c), c.evictions) == (2, 1) and c.get("k2") == [5, 6]
    c.get("k2").append(99)  # returned lists are copies
    assert c.get("k2") == [5, 6]
    with pytest.raises(ValueError):
        RingCache(slots=0)


def test_echo_serving_sheds_refills_filters_and_caches(row_programs):
    rp, _, _ = row_programs
    stats = ServeStats()
    reqs = [TextRequest(i, CORPUS[i]["abstract"], max_new=3) for i in range(6)]
    out = serve_text(_EchoModel(), rp, reqs, slots=2, max_seq=32, queue_size=2, stats=stats)
    assert (stats.admitted, stats.rejected, stats.served) == (2, 4, 2)
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    assert sorted(stats.latency_s) == [0, 1] and stats.preprocess_s > 0.0
    out = serve_text(_EchoModel(), rp, reqs, slots=2, max_seq=32)
    assert sorted(out) == list(range(6))  # 2 slots serve all 6
    stats = ServeStats()
    out = serve_text(_EchoModel(), rp, [TextRequest(0, CORPUS[0]["abstract"], max_new=2),
                                        TextRequest(1, ""), TextRequest(2, "a i x !")],
                     slots=2, max_seq=32, stats=stats)
    assert out[1] == [] and out[2] == [] and len(out[0]) == 2
    assert (stats.filtered, stats.served) == (2, 1)
    cache, stats = RingCache(slots=8), ServeStats()
    first = serve_text(_EchoModel(), rp, reqs[:2], slots=2, max_seq=32, cache=cache,
                       stats=stats)
    again = serve_text(_EchoModel(), rp, [TextRequest(7, CORPUS[0]["abstract"])], slots=2,
                       max_seq=32, cache=cache, stats=stats)
    assert again[7] == first[0] and (stats.cache_hits, stats.cache_misses) == (1, 2)
    other = dataclasses.replace(rp, fingerprint="other")  # the key binds the program
    serve_text(_EchoModel(), other, [TextRequest(9, CORPUS[0]["abstract"])], slots=2,
               max_seq=32, cache=cache, stats=stats)
    assert stats.cache_misses == 3


@pytest.fixture(scope="module")
def models(row_programs):
    _, _, tok = row_programs
    cfg = dataclasses.replace(get_smoke("stablelm_3b"), vocab_size=len(tok.itos),
                              init_scale=1.0)
    jcfg = dataclasses.replace(jax_get_smoke("stablelm_3b"), vocab_size=len(tok.itos),
                               init_scale=1.0)
    jmodel = JaxLM(jcfg, remat=False, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    model = LM(cfg, "cpu")
    model.load_jax_params(params)
    return model, jmodel, params


def waves():
    """Two waves: every abstract, a filtered one and one that cleans to
    nothing; then the first three again (cache hits), a repeat of a
    filtered text and four new texts for a queue of two (three shed)."""
    texts = [r["abstract"] for r in CORPUS]
    first = [TextRequest(i, t, max_new=6) for i, t in enumerate(texts + ["", "a i x !"])]
    extra = ["Spark ML cleans (noisy) <b>HTML</b> abstracts", "deep attention for metadata",
             "vocabulary quality of ring buffers", "executors summarize the corpus"]
    second = [TextRequest(10 + i, t, max_new=6) for i, t in enumerate(texts[:3] + [""] + extra)]
    return [(first, 8), (second, 2)]


def test_serve_text_equals_the_jax_loop(row_programs, models):
    rp, jrp, _ = row_programs
    model, jmodel, params = models
    cache, jcache = RingCache(slots=16), JS.RingCache(slots=16)
    stats, jstats = ServeStats(), JS.ServeStats()
    got, want = {}, {}
    for reqs, queue_size in waves():
        kw = dict(slots=2, max_seq=32, queue_size=queue_size)
        got.update(serve_text(model, rp, reqs, cache=cache, stats=stats, **kw))
        want.update(JS.serve_text(jmodel, params, jrp,
                                  [JS.TextRequest(r.uid, r.text, r.max_new) for r in reqs],
                                  cache=jcache, stats=jstats, **kw))
    assert got == want
    assert {k: getattr(stats, k) for k in COUNTERS} == {k: getattr(jstats, k) for k in COUNTERS}
    assert (stats.cache_hits, stats.rejected, stats.filtered) == (3, 3, 3)
    assert sorted(stats.latency_s) == sorted(jstats.latency_s)
    assert sum(len(t) for t in got.values()) > 20 and stats.decode_s > 0


def test_serve_text_is_deterministic(row_programs, models):
    rp, _, _ = row_programs
    model, _, _ = models
    reqs = waves()[0][0]
    assert serve_text(model, rp, reqs, slots=2, max_seq=32) == \
        serve_text(model, rp, reqs, slots=3, max_seq=32)


def imports_of(path: Path) -> set[str]:
    """Every module a source file imports, relative imports resolved
    against the package ``repro_torch.runtime``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                pkg = ["repro_torch", "runtime"][: 2 - (node.level - 1)]
                base = ".".join(pkg + ([base] if base else []))
            names.add(base)
            names.update(f"{base}.{a.name}" for a in node.names)
    return names


def test_the_serve_hot_path_imports_no_shard_machinery():
    """The reference's rule R005: the serve loop and the row program import
    neither the shard executors, the loader pool nor ``multiprocessing``;
    the row program arrives as an argument."""
    banned = ("repro_torch.core.executor", "repro_torch.core.async_loader", "multiprocessing")
    for name in ("serve_loop.py", "row_program.py"):
        names = imports_of(ROOT / "src" / "repro_torch" / "runtime" / name)
        hits = sorted(n for n in names if any(n == b or n.startswith(b + ".") for b in banned))
        assert not hits, (name, hits)
    code = ("import sys, repro_torch.runtime.serve_loop, repro_torch.runtime.row_program\n"
            "bad = [m for m in ('repro_torch.core.executor', 'repro_torch.core.async_loader')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr


def test_the_example_runs_to_its_assertions():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_summarizer_torch.py"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr
    assert "cache hit" in proc.stdout and "request 7" in proc.stdout
