"""The port's column expressions against the JAX package's: every string
expression and predicate gives the reference's bytes and masks over rows
made from a numpy seed (the port under ``loops``, ``fused`` and ``device``
on the CPU, the reference under ``loops``), renders as the reference's
(``describe()``, which ``explain()`` prints, and a predicate's ``repr``
over bare columns; a string op's ``repr`` is its dataclass's, which shows
the op descriptors' fields and addresses), compiles to the reference's program shape, and
signs stably across builds and processes while every parameter changes
the signature.
Bytes and masks are held exactly equal."""

import os
import pickle
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest

from repro.core import bytesops as JB
from repro.core import expr as JE
from repro_torch.core import bytesops as PB
from repro_torch.core import expr as PE
from repro_torch.core.dataset import Dataset

ROOT = Path(__file__).resolve().parents[1]
PIECES = ["<b>", "</b>", "(", ")", "<", ">", "won't", "it's", "The", "a", "of", "AND",
          "Deep", "learning", "models", "x", "ab", "42", "café", "retracted", " ", "  ",
          ",", ".", "-", "data", "Data"]


def random_rows(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(PIECES, size=rng.integers(0, 14))) for _ in range(n)]


COLUMNS = {"title": random_rows(1, 40) + ["", "  "], "abstract": random_rows(2, 42)}
N = len(COLUMNS["title"])

# name -> constructor over an expression module (JE or PE)
EXPRS = {
    "lower": lambda E: E.col("title").lower(),
    "strip_html": lambda E: E.col("title").strip_html(),
    "strip_parens": lambda E: E.col("abstract").strip_parens(),
    "contractions": lambda E: E.col("abstract").lower().expand_contractions(),
    "keep_letters": lambda E: E.col("title").keep_letters(),
    "collapse": lambda E: E.col("abstract").collapse_spaces(),
    "replace": lambda E: E.col("title").replace([("ab", "b a"), ("Data", "")]),
    "regex": lambda E: E.col("abstract").regex_replace(r"[0-9]+", "#"),
    "stopwords": lambda E: E.col("abstract").lower().remove_stopwords(),
    "custom_stopwords": lambda E: E.col("abstract").remove_stopwords(["data", "ab", "data"]),
    "min_word_len": lambda E: E.col("title").min_word_len(3),
    "clean_text": lambda E: E.clean_text(E.col("abstract")),
    "abstract_expr": lambda E: E.abstract_expr(),
    "title_expr": lambda E: E.title_expr(threshold=2),
    "concat": lambda E: E.concat(E.col("title"), E.col("abstract"), sep=" | "),
    "concat_lit": lambda E: E.concat("doc:", E.col("title").lower(), E.lit("end")),
    "ops_over_concat": lambda E: E.concat(E.col("title"), E.col("abstract")).lower()
    .strip_html().collapse_spaces().min_word_len(2),
}

PREDS = {
    "not_empty": lambda E: E.col("title").not_empty(),
    "contains": lambda E: E.col("abstract").contains("Deep"),
    "word_count_ge": lambda E: E.col("abstract").word_count() >= 4,
    "word_count_lt": lambda E: E.clean_text(E.col("title")).word_count() < 2,
    "word_count_eq": lambda E: E.col("title").word_count() == 0,
    "word_count_ne": lambda E: E.col("title").word_count() != 3,
    "word_count_gt": lambda E: E.col("title").lower().word_count() > 1,
    "word_count_le": lambda E: E.col("abstract").word_count() <= 5,
    "and": lambda E: E.col("title").not_empty() & E.col("abstract").contains("a"),
    "or": lambda E: E.col("title").contains("x") | (E.col("abstract").word_count() > 6),
    "not": lambda E: ~E.col("abstract").contains("retracted"),
    "nested": lambda E: ~(E.col("title").not_empty() & E.abstract_expr().not_empty())
    | E.concat(E.col("title"), E.col("abstract")).contains("of"),
}

PORT_BACKENDS = ("loops", "fused", "device")


def lookup(E, B):
    bufs = {c: B.flatten(rows) for c, rows in COLUMNS.items()}
    return lambda c: bufs[c]


def ref_str(e):
    return JE.eval_str(JE.fuse_compiled(JE.compile_expr(e)), lookup(JE, JB), N, "loops")


@pytest.fixture(autouse=True)
def no_engine_env(monkeypatch):
    for name in ("REPRO_BYTES_BACKEND", "REPRO_EXECUTOR", "REPRO_CACHE", "REPRO_CACHE_DIR",
                 "REPRO_WORKERS"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_string_expression_bytes_and_rendering(name):
    ref, port = EXPRS[name](JE), EXPRS[name](PE)
    assert port.describe() == ref.describe()
    assert port.inputs() == ref.inputs()
    want = ref_str(ref)
    comp = PE.compile_expr(port)
    for optimize in (False, True):
        c = PE.fuse_compiled(comp) if optimize else comp
        for backend in PORT_BACKENDS:
            got = PE.eval_str(c, lookup(PE, PB), N, backend, "cpu")
            assert got.tobytes() == want.tobytes(), (optimize, backend)


@pytest.mark.parametrize("name", sorted(PREDS))
def test_predicate_masks_and_repr(name):
    ref, port = PREDS[name](JE), PREDS[name](PE)
    assert port.describe() == ref.describe()
    if "Op(" not in repr(ref):  # no string op inside: the dataclass reprs agree
        assert repr(port) == repr(ref)
    assert port.inputs() == ref.inputs()
    want = JE.eval_mask(JE.fuse_compiled(JE.compile_pred(ref)), lookup(JE, JB), N, "loops")
    for optimize in (False, True):
        comp = PE.compile_pred(port)
        comp = PE.fuse_compiled(comp) if optimize else comp
        for backend in PORT_BACKENDS:
            got = PE.eval_mask(comp, lookup(PE, PB), N, backend, "cpu")
            assert got.dtype == bool
            np.testing.assert_array_equal(got, want)


def shape(comp):
    """A compiled program with every op replaced by its kind."""
    if isinstance(comp, tuple):
        return tuple(shape(c) for c in comp)
    if isinstance(comp, (JB.Op, PB.Op)):
        return comp.kind
    return comp


@pytest.mark.parametrize("name", sorted(EXPRS) + sorted(PREDS))
def test_compiled_programs_have_the_reference_shape(name):
    build = EXPRS.get(name) or PREDS[name]
    ref, port = build(JE), build(PE)
    jcomp, pcomp = ((JE.compile_expr(ref), PE.compile_expr(port)) if name in EXPRS
                    else (JE.compile_pred(ref), PE.compile_pred(port)))
    assert shape(pcomp) == shape(jcomp)
    assert shape(PE.fuse_compiled(pcomp)) == shape(JE.fuse_compiled(jcomp))
    assert PE.compiled_inputs(pcomp) == JE.compiled_inputs(jcomp)
    assert pickle.loads(pickle.dumps(pcomp)) is not None


def test_compile_project_merges_and_fuses_as_the_reference():
    def entries(E):
        return (("t", E.col("t").lower()), ("t", E.col("t").strip_html()),
                ("u", E.col("t").min_word_len(2)), ("t", E.col("t").collapse_spaces()))

    for optimize in (False, True):
        want = JE.compile_project(entries(JE), optimize)
        got = PE.compile_project(entries(PE), optimize)
        assert [(c, shape(p)) for c, p in got] == [(c, shape(p)) for c, p in want]


def word_free(name):
    """Expressions without a word predicate: their op signatures are the
    reference's bytes (a word predicate signs with its module's name)."""
    return name in ("lower", "strip_html", "strip_parens", "contractions", "keep_letters",
                    "collapse", "replace", "regex", "clean_text", "concat", "concat_lit")


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_signatures_stable_and_equal_to_the_reference_without_word_predicates(name):
    a, b = EXPRS[name](PE), EXPRS[name](PE)
    assert a.signature() == b.signature() and a.fingerprint() == b.fingerprint()
    if word_free(name):
        assert a.signature() == EXPRS[name](JE).signature()
    assert PE.compiled_signature(PE.compile_expr(a)) == \
        PE.compiled_signature(PE.compile_expr(b))


SENSITIVE = [
    (lambda: PE.col("t").min_word_len(2), lambda: PE.col("t").min_word_len(3)),
    (lambda: PE.col("t").remove_stopwords(["a", "b"]),
     lambda: PE.col("t").remove_stopwords(["a", "c"])),
    (lambda: PE.col("t").remove_stopwords(), lambda: PE.col("t").remove_stopwords(["the"])),
    (lambda: PE.col("t").replace([("a", "b")]), lambda: PE.col("t").replace([("a", "c")])),
    (lambda: PE.col("t").regex_replace("a+", ""), lambda: PE.col("t").regex_replace("a+", "x")),
    (lambda: PE.col("t").lower(), lambda: PE.col("u").lower()),
    (lambda: PE.col("t").lower().strip_html(), lambda: PE.col("t").strip_html().lower()),
    (lambda: PE.concat(PE.col("t"), PE.col("u")),
     lambda: PE.concat(PE.col("t"), PE.col("u"), sep="-")),
    (lambda: PE.col("t").contains("x"), lambda: PE.col("t").contains("y")),
    (lambda: PE.col("t").word_count() >= 3, lambda: PE.col("t").word_count() >= 4),
    (lambda: PE.col("t").word_count() >= 3, lambda: PE.col("t").word_count() > 3),
    (lambda: PE.col("t").not_empty() & PE.col("u").not_empty(),
     lambda: PE.col("t").not_empty() | PE.col("u").not_empty()),
    (lambda: PE.abstract_expr(threshold=1), lambda: PE.abstract_expr(threshold=2)),
]


@pytest.mark.parametrize("case", range(len(SENSITIVE)))
def test_signatures_change_with_every_parameter(case):
    a, b = SENSITIVE[case]
    assert a().signature() != b().signature()
    assert a().fingerprint() != b().fingerprint()


def test_stop_word_signatures_are_the_same_in_another_process():
    """Sets sign as their sorted members, so hash randomization between
    processes cannot change a cache key."""
    code = ("from repro_torch.core.expr import abstract_expr, col\n"
            "print(abstract_expr().fingerprint(), "
            "col('t').remove_stopwords(['x', 'y', 'z']).fingerprint())\n")
    outs = set()
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED=seed)
        proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs.add(proc.stdout)
    here = f"{PE.abstract_expr().fingerprint()} " \
        f"{PE.col('t').remove_stopwords(['x', 'y', 'z']).fingerprint()}\n"
    assert outs == {here}


def drop_x(word: bytes) -> bool:
    return word == b"x"


def test_word_predicates_sign_by_their_module_function_and_parameters():
    sig = PB.op_signature(PB.wordpred_op(partial(PB.pred_short, threshold=2)))
    assert b"repro_torch.core.bytesops.pred_short" in sig and b"threshold=int:2" in sig
    assert PB.op_signature(PB.wordpred_op(drop_x)) == PB.op_signature(PB.wordpred_op(drop_x))
    with pytest.raises(PB.UnfingerprintableOpError):
        PB.op_signature(PB.wordpred_op(lambda w: w == b"x"))
    e = PE.col("t").remove_words(lambda w: w == b"x")
    assert PE.resolved_signature(e, {}) is None
    with pytest.raises(PB.UnfingerprintableOpError):
        e.signature()


def test_a_lambda_predicate_warns_and_still_runs(tmp_path):
    (tmp_path / "s.jsonl").write_text('{"title": "x keep", "abstract": "a"}\n')
    ds = Dataset.from_json_dirs([tmp_path]).with_column(
        "title", PE.col("title").remove_words(lambda w: w == b"x"))
    assert [(d.code, d.severity) for d in ds.validate()] == [("E004", "warning")]
    assert ds.backend("loops").to_records() == [{"title": "keep", "abstract": "a"}]


def test_construction_errors_match_the_reference():
    for E in (JE, PE):
        with pytest.raises(ValueError, match="NUL"):
            E.lit("a\x00b")
        with pytest.raises(ValueError, match="NUL"):
            E.col("t").replace([("\x00", "")])
        with pytest.raises(ValueError, match="NUL"):
            E.col("t").contains("\x00")
        with pytest.raises(ValueError, match="can match NUL"):
            E.col("t").regex_replace("[^a-z]", " ")
        with pytest.raises(ValueError, match="literals only"):
            E.concat("a", "b")
        with pytest.raises(TypeError, match="int"):
            E.col("t").word_count() >= 2.5
    buf = PB.flatten(["a.b", "c"])
    with pytest.raises(ValueError, match="row separator"):
        PB.regex_sub(buf, rb"\x00", b"")


def test_row_reductions_equal_the_reference():
    rows = COLUMNS["abstract"] + ["", "one", " lead trail "]
    jbuf, pbuf = JB.flatten(rows), PB.flatten(rows)
    assert PB.n_rows(pbuf) == JB.n_rows(jbuf) == len(rows)
    np.testing.assert_array_equal(PB.row_lengths(pbuf), JB.row_lengths(jbuf))
    np.testing.assert_array_equal(PB.row_nonempty(pbuf), JB.row_nonempty(jbuf))
    np.testing.assert_array_equal(PB.row_word_counts(pbuf), JB.row_word_counts(jbuf))
    for needle in (b"", b"a", b"Deep", b"of "):
        np.testing.assert_array_equal(PB.rows_containing(pbuf, needle),
                                      JB.rows_containing(jbuf, needle))
    two = [PB.flatten(COLUMNS["title"]), PB.flatten(COLUMNS["abstract"])]
    assert PB.concat_rows(two, b"::").tobytes() == JB.concat_rows(
        [JB.flatten(COLUMNS["title"]), JB.flatten(COLUMNS["abstract"])], b"::").tobytes()
    for word in ("", "a", "abcdefgh", "abcdefghijklmnop"):
        assert PB.pack_word(word) == JB.pack_word(word)


def test_plan_rewriting_helpers_equal_the_reference():
    p = PREDS["nested"](PE) & PREDS["and"](PE)
    q = PREDS["nested"](JE) & PREDS["and"](JE)
    assert [c.describe() for c in PE.split_conjuncts(p)] == \
        [c.describe() for c in JE.split_conjuncts(q)]
    assert PE.and_all(PE.split_conjuncts(p)).describe() == \
        JE.and_all(JE.split_conjuncts(q)).describe()
    assert [e.describe() for e in PE.pred_exprs(p)] == [e.describe() for e in JE.pred_exprs(q)]
    mapped = PE.map_pred_exprs(p, lambda e: e.lower())
    assert mapped.describe() == JE.map_pred_exprs(q, lambda e: e.lower()).describe()
    e = EXPRS["ops_over_concat"]
    assert [n.describe() for n in PE.walk_exprs(e(PE))] == \
        [n.describe() for n in JE.walk_exprs(e(JE))]
    versions = {"title": b"v1", "abstract": None}
    assert PE.resolved_signature(PE.col("title").lower(), versions) == \
        JE.resolved_signature(JE.col("title").lower(), versions)
    assert PE.resolved_signature(PE.col("abstract").lower(), versions) is None
