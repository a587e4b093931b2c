"""The port's megapass and backend table against the JAX package's.

``compile_megapass`` gives the same pass program (kinds, composed LUTs,
span detectors, the kernel's flags) as ``repro.core.bytesops``, and
``execute_ops`` the same bytes under ``loops``, ``fused`` and ``device``
(on the CPU: the ``text_scan`` kernel's plain version) as the reference
under ``loops``, ``fused`` and ``pallas`` (its Pallas kernel in interpret
mode). Rows are made from a numpy seed: unbalanced spans, contractions,
digits and UTF-8."""

from functools import partial

import numpy as np
import pytest

from repro.core import bytesops as JB
from repro.core import stages as JS
from repro_torch.core import bytesops as PB
from repro_torch.core import stages as PS
from repro_torch.core.expr import ENGLISH_STOPWORDS
from repro_torch.core.frame import ColumnarFrame
from repro_torch.core.pipeline import compile_column_plans, run_column_plans
from repro_torch.kernels.text_clean import ops as clean_ops

PIECES = ["<", ">", "(", ")", "<b>", "</b>", "<p class='x'>", "(see 2)", "won't", "can't",
          "it's", "they've", "I'd", "'", "n't", "42", "3.14", "café", "naïve", "漢字", "🙂",
          "The", "a", "of", "AND", "Deep", "learning", "model", " ", "  ", ",", ".", "!",
          "-", "x", "ab", "\t", "[", "]", "{q}"]


def random_rows(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(PIECES, size=rng.integers(0, 24)) + " ") for _ in range(n)]


ROWS = random_rows(3, 60) + ["", "  ", "Hello <b>World</b> 42!", "(a(b<c)d>e stray ) closer"]

# A LUT that maps '[' and ']' onto the HTML delimiters: the span's
# detector then has two raw bytes ('<' and '['), not one.
BRACKETS = np.arange(256, dtype=np.uint8)
BRACKETS[ord("[")], BRACKETS[ord("]")] = ord("<"), ord(">")
# A LUT that maps 'x' onto the row separator: not separator-safe.
SEP_X = np.arange(256, dtype=np.uint8)
SEP_X[ord("x")] = 0
STOP = ("the", "a", "of", "and", "deep")


def build(pkg, spec):
    """The op list of ``spec`` in ``pkg`` (``JB`` or ``PB``)."""
    ops = []
    for kind, *args in spec:
        if kind == "lut":
            ops.append(pkg.lut_op(args[0]))
        elif kind == "span":
            ops.append(pkg.span_op(*args))
        elif kind == "replace":
            ops.append(pkg.replace_op(args[0]))
        elif kind == "collapse":
            ops.append(pkg.collapse_op())
        elif kind == "stop" and pkg is JB:
            ops.append(JB.wordpred_op(partial(JB.pred_stopword, words=JB.WordSet(STOP)), True))
        elif kind == "stop":
            words = frozenset(w.encode() for w in STOP)
            ops.append(PB.wordpred_op(partial(PB.pred_stopword, words=words)))
        elif kind == "short" and pkg is JB:
            ops.append(JB.wordpred_op(partial(JB.pred_short, threshold=args[0]), False))
        elif kind == "short":
            ops.append(PB.wordpred_op(partial(PB.pred_short, threshold=args[0])))
        else:
            raise AssertionError(kind)
    return ops


CHAINS = {
    "pure_lut": [("lut", JB.LOWER_LUT), ("lut", JB.UNWANTED_LUT)],
    "span_only": [("span", "<", ">")],
    "lower_parens": [("lut", JB.LOWER_LUT), ("span", "(", ")")],
    "span_then_lower": [("span", "<", ">"), ("lut", JB.LOWER_LUT), ("span", "(", ")")],
    "parens_before_html": [("span", "(", ")"), ("span", "<", ">")],
    "non_unique_preimage": [("lut", BRACKETS), ("span", "<", ">")],
    "custom_span": [("lut", JB.LOWER_LUT), ("span", "[", "]")],
    "not_sep_safe": [("lut", SEP_X), ("span", "<", ">")],
    "replace_in_the_middle": [("lut", JB.LOWER_LUT), ("replace", JB.CONTRACTIONS),
                              ("span", "<", ">"), ("collapse",)],
    "word_only": [("stop",), ("short", 2)],
    "collapse_only": [("collapse",)],
    "lut_into_words": [("lut", JB.UNWANTED_LUT), ("collapse",), ("short", 1), ("stop",)],
    "empty": [],
}


def chain_ops(name):
    """(reference ops, port ops) of a chain of ``CHAINS`` or of the case
    study's columns (each stage's ops, in order)."""
    if name in CHAINS:
        return build(JB, CHAINS[name]), build(PB, CHAINS[name])
    col, which = name.split("_")[0], name.split("_")[1] == "fused"
    pairs = []
    for mod in (JS, PS):
        with pytest.warns(DeprecationWarning):
            stages = mod.abstract_stages() if col == "abstract" else mod.title_stages()
        ops = [op for s in stages for op in s.flat_ops()]
        pairs.append((JB if mod is JS else PB).fuse_ops(ops) if which else ops)
    return tuple(pairs)


NAMES = list(CHAINS) + ["abstract_plain", "abstract_fused", "title_plain", "title_fused"]


def same_detector(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name", NAMES)
def test_compile_megapass_gives_the_reference_program(name):
    ref_ops, ops = chain_ops(name)
    want, got = JB.compile_megapass(ref_ops), PB.compile_megapass(ops)
    if want is None:
        assert got is None
        return
    assert [k for k, _ in got] == [k for k, _ in want]
    for (kind, p), (_, q) in zip(got, want):
        if kind == "scan":
            assert np.array_equal(p.lut, q.lut) and p.pairs == q.pairs
            assert len(p.spans) == len(q.spans)
            for dp, dq in zip(p.spans, q.spans):
                assert same_detector(dp[0], dq[0]) and same_detector(dp[1], dq[1])
            assert PB._kernel_scan_args(p) == JB._pallas_scan_args(q)
        elif kind == "word":
            assert (p.lut is None) == (q.lut is None)
            assert p.lut is None or np.array_equal(p.lut, q.lut)
            assert len(p.preds) == len(q.preds)
        else:
            assert p.kind == q.kind


def test_case_study_columns_compile_to_one_kernel_scan_each():
    for name in ("abstract_plain", "abstract_fused", "title_plain", "title_fused"):
        _, ops = chain_ops(name)
        prog = PB.compile_megapass(ops)
        assert [k for k, _ in prog] == ["scan", "op", "word"]
        assert PB._kernel_scan_args(prog[0][1]) == {
            "lower": True, "strip_html": True, "strip_parens": True}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("backend,ref_backend",
                         [("loops", "loops"), ("fused", "fused"), ("device", "pallas")])
def test_execute_ops_equals_the_reference(name, backend, ref_backend, monkeypatch):
    # The reference's Pallas kernel in interpret mode, as its own suite runs
    # it without a TPU (tests/test_executor_equivalence.py:590-594).
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("REPRO_BYTES_BACKEND", raising=False)
    ref_ops, ops = chain_ops(name)
    buf = JB.flatten(ROWS)
    want = JB.execute_ops(buf.copy(), ref_ops, ref_backend)
    got = PB.execute_ops(buf.copy(), ops, backend, device="cpu")
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == JB.apply_ops(buf.copy(), ref_ops).tobytes()


def test_word_pass_on_an_unterminated_buffer_and_empty_rows():
    for raw in (b"ab  c", b"\x00\x00 a \x00", b" the a  of deep x\x00y", b"", b"   "):
        buf = np.frombuffer(raw, dtype=np.uint8).copy()
        for spec in (CHAINS["word_only"], CHAINS["collapse_only"], CHAINS["lut_into_words"]):
            want = JB.execute_ops(buf.copy(), build(JB, spec), "fused")
            got = PB.execute_ops(buf.copy(), build(PB, spec), "fused")
            assert got.tobytes() == want.tobytes(), (raw, spec)


@pytest.mark.parametrize("name", NAMES)
def test_device_backend_calls_scan_flat_once_per_kernel_scan(name, monkeypatch):
    calls = []
    real = clean_ops.scan_flat

    def recording(buf, **kw):
        calls.append(kw)
        return real(buf, **kw)

    monkeypatch.setattr(clean_ops, "scan_flat", recording)
    _, ops = chain_ops(name)
    prog = PB.compile_megapass(ops) or []
    kernel_scans = [p for k, p in prog
                    if k == "scan" and p.spans and PB._kernel_scan_args(p) is not None]
    PB.execute_ops(PB.flatten(ROWS), ops, "device", device="cpu")
    assert len(calls) == len(kernel_scans)
    for kw, p in zip(calls, kernel_scans):
        assert kw == {**PB._kernel_scan_args(p), "device": "cpu"}


def test_device_backend_raises_what_the_kernel_raises(monkeypatch):
    def broken(buf, **kw):
        raise RuntimeError("text_scan: launch failed")

    monkeypatch.setattr(clean_ops, "scan_flat", broken)
    _, ops = chain_ops("abstract_fused")
    with pytest.raises(RuntimeError, match="launch failed"):
        PB.execute_ops(PB.flatten(ROWS), ops, "device", device="cpu")


def test_default_backend_is_the_card(monkeypatch):
    monkeypatch.delenv("REPRO_BYTES_BACKEND", raising=False)
    assert PB.resolve_backend() == "device"
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    _, ops = chain_ops("abstract_plain")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PB.execute_ops(PB.flatten(ROWS), ops)


@pytest.mark.parametrize("name", ["pallas", "nope", "LOOPS"])
def test_unknown_backend_raises(name, monkeypatch):
    monkeypatch.delenv("REPRO_BYTES_BACKEND", raising=False)
    with pytest.raises(ValueError, match="unknown bytes backend"):
        PB.execute_ops(PB.flatten(ROWS), build(PB, CHAINS["span_only"]), name)
    monkeypatch.setenv("REPRO_BYTES_BACKEND", name)
    with pytest.raises(ValueError, match="unknown bytes backend"):
        PB.resolve_backend()


def test_device_backend_refuses_workers(monkeypatch):
    monkeypatch.delenv("REPRO_BYTES_BACKEND", raising=False)
    frame = ColumnarFrame({"abstract": np.array(ROWS, dtype=object)})
    with pytest.warns(DeprecationWarning):
        plans = compile_column_plans(PS.abstract_stages(), optimize=True)
    for backend in ("device", None):
        with pytest.raises(ValueError, match="workers=2"):
            run_column_plans(frame, plans, workers=2, backend=backend, device="cpu")
