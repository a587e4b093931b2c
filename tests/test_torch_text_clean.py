"""The port's cleaning scan pass and cleaning chains against the JAX
package's, byte for byte: the scan kernel's plain version against the
Pallas kernel in interpret mode and its jnp oracle, ``scan_flat`` against
the loops backend's sequential ``span_strip`` passes, and the abstract and
title chains against ``apply_ops`` of the compiled ``abstract_expr`` /
``title_expr`` over the executor suite's adversarial corpus."""

import itertools

import numpy as np
import pytest
import torch

from repro.core import bytesops as JB
from repro.core.expr import abstract_expr, compile_expr, title_expr
from repro.data.synthetic import CorpusGenerator as JaxCorpusGenerator
from repro.kernels.text_clean.ops import text_scan_op as jax_text_scan_op
from repro.kernels.text_clean.ref import text_scan_ref as jax_text_scan_ref
from repro_torch.core import bytesops as PB
from repro_torch.core.clean import clean_abstracts, clean_titles
from repro_torch.data.synthetic import CorpusGenerator, abstracts_and_titles
from repro_torch.kernels.text_clean import ops
from repro_torch.kernels.text_clean.ref import text_scan_ref
from test_executor_equivalence import BACKEND_CORPUS, GIANT_RECORDS
from test_kernels import SCAN_ROWS

ROWS = SCAN_ROWS + ["naïve café 漢字 🙂 (ñé) <Ω>", "tab\there", "nested ((deep (er))) out"]
FLAGS = [dict(lower=lo, strip_html=sh, strip_parens=sp)
         for lo, sh, sp in itertools.product([False, True], repeat=3)]
FLAG_IDS = ["lower%d-html%d-parens%d" % tuple(f.values()) for f in FLAGS]


def scan_matrix(mat: np.ndarray, **flags) -> np.ndarray:
    """The port's scan over a (rows, width) matrix: rows at fixed offsets."""
    n, width = mat.shape
    offsets = torch.arange(n + 1, dtype=torch.int64) * width
    flat = torch.from_numpy(mat.reshape(-1).copy())
    before = ops.LAUNCHES["text_scan"]
    out = ops.text_scan_op(flat, offsets, **flags)
    assert ops.LAUNCHES["text_scan"] == before, "a CPU tensor launched the kernel"
    assert out.dtype == torch.uint8
    assert torch.equal(out, text_scan_ref(flat, offsets, **flags))
    return out.numpy().reshape(n, width)


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_scan_matches_jax_kernel_and_oracle(flags):
    mats = [ops.pack_rows(ROWS)]
    # random bytes rich in delimiters, NULs included (rows come from offsets)
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"<>()aZ \x00\xff", dtype=np.uint8)
    mats.append(alphabet[rng.integers(0, alphabet.size, size=(16, 200))])
    for mat in mats:
        got = scan_matrix(mat, **flags)
        np.testing.assert_array_equal(got, np.asarray(jax_text_scan_ref(mat, **flags)))
        np.testing.assert_array_equal(
            got, np.asarray(jax_text_scan_op(mat, blk_rows=8, interpret=True, **flags)))


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_scan_flat_matches_loops_ops(flags):
    rows = ROWS + [r["title"] for r in GIANT_RECORDS]
    buf = JB.flatten(rows)
    jops = ([JB.lut_op(JB.LOWER_LUT)] if flags["lower"] else []) \
        + ([JB.span_op("<", ">")] if flags["strip_html"] else []) \
        + ([JB.span_op("(", ")")] if flags["strip_parens"] else [])
    got = ops.scan_flat(buf, device="cpu", **flags)
    np.testing.assert_array_equal(got, JB.apply_ops(buf, jops))


def test_scan_flat_input_contract():
    with pytest.raises(ValueError, match="terminated"):
        ops.scan_flat(np.frombuffer(b"no separator", dtype=np.uint8), device="cpu")
    empty = np.zeros(0, dtype=np.uint8)
    assert ops.scan_flat(empty, device="cpu").size == 0
    with pytest.raises(TypeError, match="offsets"):
        ops.text_scan_op(torch.zeros(4, dtype=torch.uint8), torch.zeros(2, dtype=torch.int32))


def reference_chain(rows, expr):
    """The JAX package's cleaning: ingestion NUL normalisation, then the
    loops backend over the compiled expression."""
    _, _, jops = compile_expr(expr)
    buf = JB.flatten([r.replace("\x00", " ") for r in rows])
    return JB.unflatten(JB.apply_ops(buf, jops))


@pytest.mark.parametrize("column", ["abstract", "title"])
def test_cleaning_chains_match_reference(column):
    rows = [r[column] for r in BACKEND_CORPUS + GIANT_RECORDS if r[column] is not None]
    abstracts, titles = abstracts_and_titles(40, seed=3)
    rows += abstracts if column == "abstract" else titles
    assert any("\x00" in r for r in rows) and "" in rows
    if column == "abstract":
        got, want = clean_abstracts(rows, "cpu"), reference_chain(rows, abstract_expr())
    else:
        got, want = clean_titles(rows, "cpu"), reference_chain(rows, title_expr())
    assert got == want


def test_cleaning_chain_of_no_rows():
    assert clean_abstracts([], "cpu") == [] and clean_titles([], "cpu") == []


def test_synthetic_records_match_reference_generator():
    ours, theirs = CorpusGenerator(11).records(), JaxCorpusGenerator(11).records()
    assert list(itertools.islice(ours, 50)) == list(itertools.islice(theirs, 50))


def test_host_byte_ops_match_reference():
    buf = JB.flatten(["  two  spaces ", "", "a b cc the dd", "x"])
    np.testing.assert_array_equal(PB.collapse_spaces(buf), JB.collapse_spaces(buf))
    np.testing.assert_array_equal(PB.UNWANTED_LUT, JB.UNWANTED_LUT)
    assert PB.CONTRACTIONS == JB.CONTRACTIONS
    np.testing.assert_array_equal(PB.remove_short_words(buf, 1), JB.remove_short_words(buf, 1))
    assert PB.unflatten(PB.flatten(["a", "", "ü"])) == JB.unflatten(JB.flatten(["a", "", "ü"]))
