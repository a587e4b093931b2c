"""The port's planner against the JAX package's: every chain pinned under
``tests/golden_plans/`` is rebuilt through the port, and the logical and
optimized sections of its ``explain()`` equal the committed text (read
only, never rewritten here); the optimizer's rewrites give the reference's
plans node for node, on those chains and on more; fingerprints are stable,
parameter-sensitive and port-tagged."""

from pathlib import Path
from types import SimpleNamespace

import pytest

import repro.core.dataset as JD
import repro.core.expr as JE
import repro.core.p3sapp as JP
import repro.core.plan as JPL
import repro.core.stages as JS
import repro.data.batching as JBT
import repro.data.tokenizer as JT
import repro_torch.core.dataset as PD
import repro_torch.core.expr as PE
import repro_torch.core.p3sapp as PP
import repro_torch.core.plan as PPL
import repro_torch.core.stages as PS
import repro_torch.data.batching as PBT
import repro_torch.data.tokenizer as PT

GOLDEN_DIR = Path(__file__).parent / "golden_plans"

JAX = SimpleNamespace(D=JD.Dataset, E=JE, S=JS, TokenSpec=JBT.TokenSpec,
                      WordTokenizer=JT.WordTokenizer, case_study_stages=JP.case_study_stages,
                      P=JPL)
PORT = SimpleNamespace(D=PD.Dataset, E=PE, S=PS, TokenSpec=PBT.TokenSpec,
                       WordTokenizer=PT.WordTokenizer, case_study_stages=PP.case_study_stages,
                       P=PPL)


# The chains of tests/test_golden_plans.py, over either package.
def project_and_filter_merge(ns):
    return (ns.D.from_json_dirs(["/x"]).apply(ns.S.ConvertToLower("title"))
            .apply(ns.S.RemoveShortWords("title", threshold=2))
            .dropna(["title"]).dropna(["abstract"]))


def dropna_pullback(ns):
    return ns.D.from_json_dirs(["/x"]).apply(ns.S.ConvertToLower("abstract")).dropna(["title"])


def source_projection(ns):
    tok = ns.WordTokenizer(["w"])
    return (ns.D.from_json_dirs(["/x"], ("title", "abstract", "venue")).dropna(["abstract"])
            .apply(ns.S.ConvertToLower("abstract"))
            .tokenize(tok, (ns.TokenSpec("abstract", 16),)))


def canonical_p3sapp_chain(ns):
    return (ns.D.from_json_dirs(["/x"]).dropna().drop_duplicates()
            .apply(*ns.case_study_stages()).dropna())


def filter_pushed_below_project(ns):
    E, tok = ns.E, ns.WordTokenizer(["w"])
    return (ns.D.from_json_dirs(["/x"]).with_column("abstract", E.abstract_expr())
            .with_column("title_clean", E.title_expr())
            .where(E.col("title").not_empty() & E.col("title").contains("a"))
            .tokenize(tok, (ns.TokenSpec("abstract", 16),)))


def filter_on_derived_column_stays_put(ns):
    E = ns.E
    return (ns.D.from_json_dirs(["/x"]).with_column("abstract", E.abstract_expr())
            .where(E.col("abstract").word_count() >= 4))


def conjunct_split_mixed_filter(ns):
    E = ns.E
    return (ns.D.from_json_dirs(["/x"]).with_column("abstract", E.abstract_expr())
            .where((E.col("abstract").word_count() >= 4) & E.col("title").not_empty()))


def dropna_split_at_project(ns):
    return (ns.D.from_json_dirs(["/x"]).apply(ns.S.ConvertToLower("title"))
            .dropna(["title", "abstract"]))


def cse_filter_project_shared_chain(ns):
    E = ns.E
    return (ns.D.from_json_dirs(["/x"]).where(E.clean_text(E.col("abstract")).word_count() >= 5)
            .with_column("abstract", E.clean_text(E.col("abstract"))))


def cse_shared_prefix_transform(ns):
    E = ns.E
    return ns.D.from_json_dirs(["/x"]).transform(
        abstract=E.clean_text(E.col("abstract")).remove_stopwords(),
        abstract_long=E.clean_text(E.col("abstract")).min_word_len(5))


def cse_concat_shared(ns):
    E = ns.E
    both = E.concat(E.col("title"), E.col("abstract")).lower().collapse_spaces()
    return ns.D.from_json_dirs(["/x"]).with_column("both", both).where(both.word_count() >= 3)


GOLDEN = [project_and_filter_merge, dropna_pullback, source_projection,
          canonical_p3sapp_chain, filter_pushed_below_project,
          filter_on_derived_column_stays_put, conjunct_split_mixed_filter,
          dropna_split_at_project, cse_filter_project_shared_chain,
          cse_shared_prefix_transform, cse_concat_shared]


# More chains whose optimized plans must be the reference's.
def cse_across_filters(ns):
    E = ns.E
    shared = E.clean_text(E.col("title"))
    return (ns.D.from_json_dirs(["/x"]).where(shared.word_count() >= 2)
            .where(shared.contains("a")).with_column("t2", shared.min_word_len(3)))


def column_versions_do_not_alias(ns):
    E = ns.E
    return (ns.D.from_json_dirs(["/x"]).with_column("abstract", E.col("abstract").lower())
            .with_column("a2", E.col("abstract").lower())
            .with_column("a3", E.col("abstract").lower()))


def select_scopes_cse(ns):
    E = ns.E
    shared = E.col("title").lower().strip_html()
    return (ns.D.from_json_dirs(["/x"]).with_column("t1", shared).select(["title", "t1"])
            .with_column("t2", shared))


def dropna_and_filters_merge(ns):
    E = ns.E
    return (ns.D.from_json_dirs(["/x"]).dropna(["title"]).dropna(["abstract", "title"])
            .where(E.col("title").contains("x")).where(~E.col("abstract").not_empty())
            .transform(title=E.title_expr()).where(E.col("title").word_count() > 1))


def reference_example_chain(ns):
    E = ns.E
    keep = E.col("title").not_empty() & E.col("abstract").not_empty()
    tok = ns.WordTokenizer(["w"])
    return (ns.D.from_json_dirs(["/x"]).where(keep).drop_duplicates()
            .transform(abstract=E.abstract_expr(), title=E.title_expr()).where(keep)
            .tokenize(tok, (ns.TokenSpec("abstract", 64, out="encoder_tokens"),
                            ns.TokenSpec("title", 12, out="decoder_tokens",
                                         add_start_end=True)))
            .batched(8, bucket_by=("encoder_tokens", "decoder_tokens")).prefetch(2))


def split_and_or(ns):
    E = ns.E
    return (ns.D.from_json_dirs(["/x"]).transform(title=E.col("title").lower())
            .where(E.col("abstract").not_empty() | E.col("title").not_empty())
            .split(0.2, seed=3)[1])


MORE = [cse_across_filters, column_versions_do_not_alias, select_scopes_cse,
        dropna_and_filters_merge, reference_example_chain, split_and_or]


def sections(text: str) -> str:
    """The logical and optimized sections of an ``explain()``."""
    return text.split("== physical ==")[0]


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("build", GOLDEN, ids=lambda f: f.__name__)
def test_explain_equals_the_golden_plan(build):
    ds = build(PORT)
    assert not [d for d in ds.validate() if d.severity == "error"]
    got = ds.explain() + "\n"
    want = (GOLDEN_DIR / f"{build.__name__}.txt").read_text()
    assert sections(got) == sections(want)
    assert got.endswith("== physical ==\n  bytes backend: device\n")
    assert ds.backend("loops").explain().endswith("bytes backend: loops")


def describe_all(nodes):
    return [n.describe() for n in nodes]


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("build", GOLDEN + MORE, ids=lambda f: f.__name__)
def test_optimizer_gives_the_reference_plan(build):
    port, ref = build(PORT), build(JAX)
    assert describe_all(port.plan) == describe_all(ref.plan)
    assert describe_all(port.optimized_plan()) == describe_all(ref.optimized_plan())
    assert sections(port.explain()) == sections(ref.explain())
    frame, _ = PPL.split_plan(port.plan)
    jframe, _ = JPL.split_plan(ref.plan)
    for schema in ((), tuple(port.schema)):
        assert describe_all(PPL.optimize_plan(frame, schema)) == \
            describe_all(JPL.optimize_plan(jframe, schema))
    # exact rewrites are idempotent
    once = PPL.optimize_plan(frame, port._needed_columns())
    assert describe_all(PPL.optimize_plan(once, port._needed_columns())) == describe_all(once)


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_plan_fingerprint_stable_parameter_sensitive_and_port_tagged():
    def build(ns, threshold=1, dirs=("/x",), needle="x"):
        return (ns.D.from_json_dirs(list(dirs)).dropna()
                .apply(ns.S.RemoveShortWords("title", threshold=threshold))
                .where(ns.E.col("abstract").contains(needle)))

    def fp(ns, **kw):
        ds = build(ns, **kw)
        return ns.P.plan_fingerprint(ds.plan, ds.schema)

    a = fp(PORT)
    assert a == fp(PORT)
    for kw in ({"threshold": 2}, {"dirs": ("/y",)}, {"needle": "y"}):
        assert fp(PORT, **kw) != a
    assert a != fp(JAX)
    ds = build(PORT)
    assert PPL.plan_fingerprint(ds.plan, ds.schema, optimize=False) != a


def test_stage_timings_live_in_the_planner():
    assert PP.StageTimings is PPL.StageTimings
    t = PPL.StageTimings(1.0, 0.5, 2.0, 0.25, 0.125)
    assert t.as_dict() == JPL.StageTimings(1.0, 0.5, 2.0, 0.25, 0.125).as_dict()


def test_frame_verbs_after_array_verbs_are_refused():
    tok = PT.WordTokenizer(["w"])
    ds = PD.Dataset.from_json_dirs(["/x"]).tokenize(tok, col="title", max_len=4)
    with pytest.raises(ValueError, match="frame-level"):
        ds.dropna()
    with pytest.raises(ValueError, match="bucket_by"):
        ds.batch(4, buckets=[2, 4])
    with pytest.raises(KeyError):
        ds.batch(4, bucket_by="nope")
    assert ds.batched(4, bucket_by="title_tokens", buckets=[2]).plan[-1].describe() == \
        JD.Dataset.from_json_dirs(["/x"]).tokenize(JT.WordTokenizer(["w"]), col="title",
                                                   max_len=4) \
        .batched(4, bucket_by="title_tokens", buckets=[2]).plan[-1].describe()
