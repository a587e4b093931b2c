"""The port's plan analyzer against the JAX package's: every invalid plan of
the reference's corpus (``tests/test_plan_diagnostics.py``), rebuilt
through the port, gives the reference's diagnostics (codes, severities,
messages and provenance) and raises before any executor thread or plan
runner starts; the rewrite verifier catches the reference's tampered
rewrites with the reference's codes."""

from types import SimpleNamespace

import pytest

import repro.analysis.rewrites as JRW
import repro.core.bytesops as JB
import repro.core.dataset as JD
import repro.core.expr as JE
import repro.core.plan as JPL
import repro.data.batching as JBT
import repro.data.tokenizer as JT
import repro_torch.analysis.rewrites as PRW
import repro_torch.core.bytesops as PB
import repro_torch.core.dataset as PD
import repro_torch.core.executor as PX
import repro_torch.core.expr as PE
import repro_torch.core.plan as PPL
import repro_torch.data.batching as PBT
import repro_torch.data.tokenizer as PT
from repro_torch.analysis import PlanValidationError

FIELDS = ("title", "abstract")
JAX = SimpleNamespace(D=JD.Dataset, E=JE, B=JB, P=JPL, TokenSpec=JBT.TokenSpec,
                      WordTokenizer=JT.WordTokenizer, RW=JRW,
                      lam=lambda: JB.Op(kind="wordpred", pred=lambda _v, ln: ln > 2))
PORT = SimpleNamespace(D=PD.Dataset, E=PE, B=PB, P=PPL, TokenSpec=PBT.TokenSpec,
                       WordTokenizer=PT.WordTokenizer, RW=PRW,
                       lam=lambda: PB.Op(kind="wordpred", pred=lambda w: len(w) > 2))


def tok(ns):
    return ns.WordTokenizer(["w"])


def spec(ns, column="title", max_len=8, out=None):
    return ns.TokenSpec(column, max_len, out=out)


# name -> (constructor over a package, code, terminal, validate kwargs)
CORPUS = {
    "p001_non_json_source": (
        lambda ns: ns.D.from_records([{"title": "a", "abstract": "b"}], FIELDS),
        "P001", "stream", {"streaming": True}),
    "p002_split_in_stream": (
        lambda ns: ns.D.from_json_dirs(["/x"], FIELDS).split(0.5)[0],
        "P002", "stream", {"streaming": True}),
    "p003_missing_tokenize": (
        lambda ns: ns.D.from_json_dirs(["/x"], FIELDS).prefetch(2), "P003", "iter", {}),
    "p004_missing_batch": (
        lambda ns: ns.D.from_json_dirs(["/x"], FIELDS).tokenize(tok(ns), (spec(ns),))
        .prefetch(2), "P004", "iter", {}),
    "p005_stacked_partial_dedup": (
        lambda ns: ns.D.from_json_dirs(["/x"], FIELDS).drop_duplicates(["title"])
        .drop_duplicates(["abstract"]).tokenize(tok(ns), (spec(ns),)).batched(4).prefetch(2),
        "P005", "iter", {}),
    "p006_select_unknown_column": (
        lambda ns: ns.D([ns.P.SourceJsonDirs(("/x",), FIELDS), ns.P.Select(("nope",))],
                        ("nope",)), "P006", "collect", {}),
    "p007_frame_after_array": (
        lambda ns: ns.D([ns.P.SourceJsonDirs(("/x",), FIELDS),
                         ns.P.Tokenize(tok(ns), (spec(ns),)), ns.P.DropNA(("title",))],
                        FIELDS), "P007", "iter", {}),
    "p008_batch_without_tokenize": (
        lambda ns: ns.D([ns.P.SourceJsonDirs(("/x",), FIELDS), ns.P.Batch(4)], FIELDS),
        "P008", "iter", {}),
    "p009_off_grid_buckets": (
        lambda ns: ns.D([ns.P.SourceJsonDirs(("/x",), FIELDS),
                         ns.P.Tokenize(tok(ns), (spec(ns, out="title_tokens"),)),
                         ns.P.Batch(4, bucket_by="title_tokens", buckets=(8, 4))], FIELDS),
        "P009", "iter", {}),
    "p014_no_source": (
        lambda ns: ns.D([ns.P.Select(("title",))], ("title",)), "P014", "collect", {}),
    "e001_predicate_in_transform_position": (
        lambda ns: ns.D([ns.P.SourceJsonDirs(("/x",), FIELDS),
                         ns.P.Project((("flag", ns.E.col("title").not_empty()),))], FIELDS),
        "E001", "collect", {}),
    "e002_expression_in_predicate_position": (
        lambda ns: ns.D([ns.P.SourceJsonDirs(("/x",), FIELDS),
                         ns.P.Filter(ns.E.col("title").lower())], FIELDS),
        "E002", "collect", {}),
    "e003_regex_does_not_compile": (
        lambda ns: ns.D([ns.P.SourceJsonDirs(("/x",), FIELDS),
                         ns.P.Project((("title", ns.E.StrOp(
                             ns.E.col("title"),
                             ns.B.Op(kind="regex", regex=(b"(unclosed", b"x")), "bad_rx")),))],
                        FIELDS), "E003", "collect", {}),
    "e005_expr_reads_unknown_column": (
        lambda ns: ns.D([ns.P.SourceJsonDirs(("/x",), FIELDS),
                         ns.P.Project((("x", ns.E.col("nope").lower()),))], FIELDS),
        "E005", "collect", {}),
    # more shapes: a wordcount in predicate position, a bad batch size and
    # prefetch depth, a second Tokenize, a bucket column that is no token
    "e002_wordcount_predicate": (
        lambda ns: ns.D([ns.P.SourceJsonDirs(("/x",), FIELDS),
                         ns.P.Filter(ns.E.col("title").word_count())], FIELDS),
        "E002", "collect", {}),
    "p008_bad_sizes": (
        lambda ns: ns.D([ns.P.SourceJsonDirs(("/x",), FIELDS),
                         ns.P.Tokenize(tok(ns), (spec(ns, max_len=0),)),
                         ns.P.Tokenize(tok(ns), (spec(ns),)),
                         ns.P.Batch(0, bucket_by="nope"), ns.P.Prefetch(0)], FIELDS),
        "P008", "iter", {}),
    "p009_top_width_below_max_len": (
        lambda ns: ns.D([ns.P.SourceJsonDirs(("/x",), FIELDS),
                         ns.P.Tokenize(tok(ns), (spec(ns, max_len=16, out="t"),)),
                         ns.P.Batch(4, bucket_by="t", buckets=(4, 8))], FIELDS),
        "P009", "iter", {}),
}


def render(diags):
    return [(d.code, d.severity, d.render()) for d in diags]


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_the_port_gives_the_reference_diagnostics(name):
    build, code, _terminal, kwargs = CORPUS[name]
    port, ref = build(PORT).validate(**kwargs), build(JAX).validate(**kwargs)
    assert any(d.code == code and d.provenance for d in port)
    assert render(port) == render(ref)


@pytest.fixture
def spawns(monkeypatch):
    """Counts (and vetoes) every way execution can start."""
    count = {"n": 0}

    def bump(*_a, **_k):
        count["n"] += 1
        raise AssertionError("an executor or plan runner started for an invalid plan")

    monkeypatch.setattr(PX, "make_executor", bump)
    monkeypatch.setattr(PX.ThreadShardExecutor, "__init__", bump)
    monkeypatch.setattr(PPL, "execute_frame_plan", bump)
    monkeypatch.setattr(PPL, "continue_frame_plan", bump)
    return count


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_invalid_plans_fail_before_anything_starts(name, spawns):
    build, code, terminal, _kwargs = CORPUS[name]
    ds = build(PORT)
    with pytest.raises(PlanValidationError) as excinfo:
        if terminal == "iter":
            ds.iter_batches(device="cpu")
        elif terminal == "collect":
            ds.collect(device="cpu")
        else:
            next(PPL.stream_batches(ds.plan, final_schema=ds.schema))
    assert any(d.code == code for d in excinfo.value.diagnostics)
    assert isinstance(excinfo.value, ValueError)
    assert spawns["n"] == 0


def test_fit_vocab_validates_the_frame_prefix(spawns):
    with pytest.raises(PlanValidationError) as excinfo:
        CORPUS["p006_select_unknown_column"][0](PORT).fit_vocab(vocab_size=10, device="cpu")
    assert [d.code for d in excinfo.value.diagnostics] == ["P006"]
    assert spawns["n"] == 0


def test_the_error_renders_codes_and_provenance():
    with pytest.raises(PlanValidationError) as excinfo:
        CORPUS["p005_stacked_partial_dedup"][0](PORT).iter_batches(device="cpu")
    text = str(excinfo.value)
    assert "P005 error" in text and "at node 1: DropDuplicates(['title'])" in text
    (diag,) = excinfo.value.diagnostics
    assert len(diag.provenance) == 2


def test_a_warning_does_not_block():
    for ns in (PORT, JAX):
        lam = ns.E.StrOp(ns.E.col("title"), ns.lam(), "lambda_pred")
        ds = ns.D([ns.P.SourceJsonDirs(("/x",), FIELDS), ns.P.Project((("title", lam),))],
                  FIELDS)
        assert [(d.code, d.severity) for d in ds.validate()] == [("E004", "warning")]
        ds._require_valid()


def test_valid_plans_are_clean():
    for ns in (PORT, JAX):
        ds = (ns.D.from_json_dirs(["/x"], FIELDS).dropna().where(ns.E.col("title").not_empty())
              .with_column("title", ns.E.col("title").lower()).tokenize(tok(ns), (spec(ns),))
              .batched(4).prefetch(2))
        assert ds.validate() == []
        cse = (ns.D.from_json_dirs(["/x"], FIELDS)
               .where(ns.E.clean_text(ns.E.col("abstract")).word_count() >= 5)
               .with_column("abstract", ns.E.clean_text(ns.E.col("abstract"))))
        assert [d for d in cse.validate() if d.severity == "error"] == []


# tampered rewrites: code -> (logical plan, tampered plan, final schema)
def _dropped_filter(ns):
    ds = ns.D.from_json_dirs(["/x"], FIELDS).where(ns.E.col("title").not_empty())
    logical = ns.P.split_plan(ds.plan)[0]
    return logical, [n for n in logical if not isinstance(n, ns.P.Filter)], ds.schema


def _lost_column(ns):
    logical = ns.P.split_plan(ns.D.from_json_dirs(["/x"], FIELDS).plan)[0]
    return logical, list(logical) + [ns.P.Select(("title",))], FIELDS


def _changed_lineage(ns):
    ds = ns.D.from_json_dirs(["/x"], FIELDS).with_column("title", ns.E.col("title").lower())
    logical = ns.P.split_plan(ds.plan)[0]
    tampered = [logical[0], ns.P.Project((("title", ns.E.col("title").collapse_spaces()),))]
    return logical, tampered, FIELDS


def _dropped_dedup(ns):
    logical = ns.P.split_plan(
        ns.D.from_json_dirs(["/x"], FIELDS).drop_duplicates(["title"]).plan)[0]
    return logical, [n for n in logical if not isinstance(n, ns.P.DropDuplicates)], FIELDS


def _broken_scoping(ns):
    logical = ns.P.split_plan(ns.D.from_json_dirs(["/x"], FIELDS).plan)[0]
    return logical, list(logical) + [ns.P.Filter(ns.E.col("nope").not_empty())], FIELDS


TAMPERED = {"P012": _dropped_filter, "P011": _lost_column, "P013": _changed_lineage,
            "P015": _dropped_dedup, "P010": _broken_scoping}


@pytest.mark.parametrize("code", sorted(TAMPERED))
def test_the_rewrite_verifier_catches_tampered_rewrites(code):
    got = PORT.RW.verify_rewrite_pair(*TAMPERED[code](PORT))
    want = JAX.RW.verify_rewrite_pair(*TAMPERED[code](JAX))
    assert any(d.code == code for d in got)
    assert render(got) == render(want)
