"""The slice as a whole: raw abstracts in, titles out, through the port
(``repro_torch.launch.serve.serve_abstracts`` on the CPU) and through the
JAX package (the ``Dataset`` chain of ``examples/train_summarizer.py``,
minus ``drop_duplicates``, then ``fit_vocab``, ``tokenize``,
``Seq2Seq.generate`` and ``tok.decode``), on shared SMOKE parameters. The
vocabularies must be equal and the titles equal string for string."""

import json

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.p3sapp_summarizer import SMOKE as JAX_SMOKE
from repro.core.dataset import Dataset
from repro.core.expr import abstract_expr, col, title_expr
from repro.data.batching import seq2seq_specs
from repro.data.synthetic import write_corpus
from repro.models.seq2seq import Seq2Seq as JaxSeq2Seq
from repro_torch.configs.p3sapp_summarizer import SMOKE
from repro_torch.core.clean import clean_abstracts, clean_titles
from repro_torch.data.tokenizer import WordTokenizer
from repro_torch.launch.serve import serve_abstracts
from repro_torch.models.seq2seq import Seq2Seq

BATCH = 16


def raw_records(corpus):
    """Every record of the corpus in the order the JAX source reads them."""
    out = []
    for path in sorted(corpus.rglob("*.jsonl")):
        for line in path.read_text(encoding="utf-8").splitlines():
            if line.strip():
                out.append(json.loads(line))
    return out


def test_served_titles_match_jax_chain(tmp_path):
    corpus = tmp_path / "corpus"
    write_corpus(corpus, total_bytes=90_000, n_files=3, seed=5)

    # JAX: the training example's chain (serving does not dedupe)
    keep = col("title").not_empty() & col("abstract").not_empty()
    clean = (
        Dataset.from_json_dirs([corpus])
        .where(keep)
        .transform(abstract=abstract_expr(), title=title_expr())
        .where(keep)
    )
    records, _ = clean.execute()
    jtok = clean.fit_vocab(vocab_size=JAX_SMOKE.vocab_size)
    enc = clean.tokenize(
        jtok, seq2seq_specs(JAX_SMOKE.max_abstract_len, JAX_SMOKE.max_title_len)
    ).arrays()["encoder_tokens"]
    params = jax.tree_util.tree_map(
        np.asarray, JaxSeq2Seq(JAX_SMOKE).init(jax.random.PRNGKey(4)))
    jmodel = JaxSeq2Seq(JAX_SMOKE)
    want_titles = []
    for i in range(0, len(enc), BATCH):
        gen = np.asarray(jmodel.generate(params, jnp.asarray(enc[i : i + BATCH])))
        want_titles += [jtok.decode(row) for row in gen]

    # Port: the raw records the JAX chain kept, cleaned by the port
    raw = [r for r in raw_records(corpus) if r["abstract"] and r["title"]]
    abstracts = clean_abstracts([r["abstract"] for r in raw], "cpu")
    titles = clean_titles([r["title"] for r in raw], "cpu")
    kept = [i for i, (a, t) in enumerate(zip(abstracts, titles)) if a and t]
    assert len(kept) > 2 * BATCH
    assert [{"title": titles[i], "abstract": abstracts[i]} for i in kept] == [
        {"title": r["title"], "abstract": r["abstract"]} for r in records
    ]
    tok = WordTokenizer.fit([abstracts[i] for i in kept] + [titles[i] for i in kept],
                            vocab_size=SMOKE.vocab_size)
    assert tok.itos == jtok.itos

    model = Seq2Seq(SMOKE, "cpu")
    model.load_jax_params(params)
    got_titles = serve_abstracts(model, tok, [raw[i]["abstract"] for i in kept],
                                 batch_size=BATCH)
    assert got_titles == want_titles
    assert any(got_titles)
