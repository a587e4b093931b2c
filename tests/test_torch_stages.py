"""The port's ``Stage`` classes against the JAX package's.

Every stage, row by row (``transform_row``, the conventional approach's
path) and over a flat buffer (``transform_flat``, the P3SAPP path), gives
the reference's strings and bytes: on the row examples of
``tests/test_stages.py`` (copied here) and on 200 rows made from a numpy
seed with unbalanced ``<``/``(``, contractions, digits and UTF-8."""

import numpy as np
import pytest

from repro.core import bytesops as JB
from repro.core import stages as JS
from repro_torch.core import bytesops as PB
from repro_torch.core import stages as PS

# tests/test_stages.py's EXAMPLES
EXAMPLES = [
    [],
    [""],
    ["", "", ""],
    ["Hello World"],
    ["a <b>bold</b> move", "no tags here"],
    ["nested (paren (not)) ok", "x (y) z"],
    ["It's CAN'T won't they've", "she'd we're he's"],
    ["UPPER lower MiXeD 123 !!!", "digits 42 and, punct; here."],
    ["  leading and trailing  ", "multi   spaces    inside"],
    ["a ab abc abcd abcde", "i of the and an it"],
    ["the quick brown fox is over a lazy dog", "will not be removed maybe"],
    ["<p>tag at start</p> mid <i>x</i> end", "(paren at start) mid (y) end"],
    ["word", " ", "  ", "x"],
]

PIECES = ["<", ">", "(", ")", "<b>", "</b>", "<<", "))", "won't", "can't", "shan't", "it's",
          "they've", "we'll", "I'm", "she'd", "'", "n't", "'re", "42", "3.14", "1999",
          "café", "naïve", "漢字", "🙂", "Ω", "The", "a", "of", "AND", "Deep", "learning",
          "networks", " ", "  ", ",", ".", "!", ";", "-", "x", "ab", "\t", "\n"]


def random_rows(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(PIECES, size=rng.integers(0, 30))) for _ in range(n)]


RANDOM = random_rows(11, 200)

# (name, constructor arguments); each stage class is built in both packages
STAGES = [
    ("ConvertToLower", {}),
    ("RemoveHTMLTags", {}),
    ("RemoveUnwantedCharacters", {}),
    ("RemoveShortWords", {"threshold": 1}),
    ("RemoveShortWords", {"threshold": 3}),
    ("Tokenizer", {}),
    ("StopWordsRemover", {}),
    ("StopWordsRemover", {"stopwords": ("deep", "learning", "a", "ab")}),
]


def both(name, kwargs, col="c"):
    with pytest.warns(DeprecationWarning):
        ref = getattr(JS, name)(col, **kwargs)
    with pytest.warns(DeprecationWarning):
        port = getattr(PS, name)(col, **kwargs)
    return ref, port


@pytest.mark.parametrize("name,kwargs", STAGES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(STAGES)])
@pytest.mark.parametrize("rows", EXAMPLES + [RANDOM], ids=[*map(str, range(len(EXAMPLES))), "random"])
def test_stage_equals_the_reference(name, kwargs, rows):
    ref, port = both(name, kwargs)
    assert [port.transform_row(r) for r in rows] == [ref.transform_row(r) for r in rows]
    buf = JB.flatten(rows)
    assert port.transform_flat(buf.copy()).tobytes() == ref.transform_flat(buf.copy()).tobytes()


@pytest.mark.parametrize("rows", EXAMPLES, ids=range(len(EXAMPLES)))
def test_flat_path_equals_the_row_path_on_balanced_rows(rows):
    for name, kwargs in STAGES:
        _, port = both(name, kwargs)
        assert PB.unflatten(port.transform_flat(PB.flatten(rows))) == \
            [port.transform_row(r) for r in rows]


def test_stage_construction_warns_deprecation():
    with pytest.warns(DeprecationWarning, match="col\\(\\) expressions"):
        st_ = PS.ConvertToLower("c")
    assert st_.fit(None) is st_
    assert (st_.input_col, st_.output_col) == ("c", "c")
    with pytest.warns(DeprecationWarning):
        assert PS.RemoveHTMLTags("a", "b").output_col == "b"


def op_key(op):
    """What an op is, comparable across packages (predicates by name and
    parameters)."""
    if op.kind == "lut":
        return ("lut", op.lut.tobytes())
    if op.kind == "span":
        return ("span", op.span)
    if op.kind == "replace":
        return ("replace", op.patterns)
    if op.kind == "wordpred":
        params = dict(op.pred.keywords)
        if "words" in params:
            words = params["words"]
            params["words"] = len(words) if isinstance(words, frozenset) else words.k1.size
        return ("wordpred", op.pred.func.__name__, tuple(sorted(params.items())))
    return (op.kind,)


@pytest.mark.parametrize("which", ["abstract_stages", "title_stages"])
def test_workflow_ops_equal_the_reference(which):
    with pytest.warns(DeprecationWarning):
        ref, port = getattr(JS, which)(), getattr(PS, which)()
    assert [type(s).__name__ for s in port] == [type(s).__name__ for s in ref]
    assert [(s.input_col, s.output_col) for s in port] == \
        [(s.input_col, s.output_col) for s in ref]
    for r, p in zip(ref, port):
        assert [op_key(op) for op in p.flat_ops()] == [op_key(op) for op in r.flat_ops()]


def test_stopwords_remover_holds_byte_words():
    with pytest.warns(DeprecationWarning):
        st_ = PS.StopWordsRemover("c", stopwords=("the", "a"))
    (op,) = st_.flat_ops()
    assert op.pred.keywords["words"] == frozenset({b"the", b"a"})
    rows = ["the them a ab", "The a"]
    assert PB.unflatten(st_.transform_flat(PB.flatten(rows))) == ["them ab", "The"]
