"""The port's character cleaning kernel against the JAX package's, byte for
byte: ``text_clean_op`` on CPU tensors (the plain version) against the
Pallas ``_clean_kernel`` in interpret mode and its jnp oracle, and
``clean_rows`` against the JAX ``clean_rows``, over adversarial rows
(stray ``>``, NUL, non-ASCII, rows of several 1024-byte kernel tiles) and
seeded random byte matrices, with and without ``strip_html``."""

import numpy as np
import pytest
import torch

from repro.kernels.text_clean.ops import clean_rows as jax_clean_rows
from repro.kernels.text_clean.ops import text_clean_op as jax_text_clean_op
from repro.kernels.text_clean.ref import text_clean_ref as jax_text_clean_ref
from repro_torch.core import bytesops as PB
from repro_torch.kernels.text_clean import ops
from repro_torch.kernels.text_clean.ref import text_clean_flat_ref, text_clean_ref

# the JAX suite's rows (tests/test_kernels.py:178-183)
SUITE_ROWS = [
    "Hello <b>World</b> 42!",
    "plain text only",
    "UPPER and (kept by kernel) 123",
    "",
] * 7
# a '<' in the first 1024-byte tile and its '>' in the fourth, then text
LONG = "Lead <" + "InSide " * 500 + "> TAIL words " + "abc " * 300
ADVERSARIAL = [
    "x > yy zz <b>q",  # a stray '>': depth -1 hides "yy zz"; "<b>" brings it to 0
    "A\x00B c",  # NUL inside a row
    "café Naïve 漢字 🙂",  # bytes above 127
    ">> <<< >>> <", "<<unclosed", "MiXeD <P>CaSe</P> tail>", "\x00\x00<\x00>",
    LONG, LONG[::-1], "",
]
SANDBOX_CASES = {
    "x > yy zz <b>q": "x b",
    "A\x00B c": "a b c",
    "café Naïve": "caf na ve",
}


def _random_matrix(seed: int, n: int, width: int) -> np.ndarray:
    """Bytes rich in '<', '>', NUL, uppercase and bytes above 127."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"<<>>\x00AZaz \xc3\xa9\xff.", dtype=np.uint8)
    mat = rng.integers(0, 256, size=(n, width), dtype=np.uint8)
    mask = rng.random((n, width)) < 0.7
    mat[mask] = alphabet[rng.integers(0, alphabet.size, size=int(mask.sum()))]
    return mat


MATRICES = {
    "suite": ops.pack_rows(SUITE_ROWS),
    "adversarial": ops.pack_rows(ADVERSARIAL),
    "random_narrow": _random_matrix(1, 16, 37),
    "random_wide": _random_matrix(2, 6, 3100),
    "random_width1": _random_matrix(3, 9, 1),
}


def port_clean(mat: np.ndarray, strip_html: bool) -> np.ndarray:
    t = torch.from_numpy(mat.copy())
    before = ops.LAUNCHES["text_clean"]
    out = ops.text_clean_op(t, strip_html=strip_html)
    assert ops.LAUNCHES["text_clean"] == before, "a CPU tensor launched the kernel"
    assert out.dtype == torch.uint8 and out.shape == t.shape
    assert torch.equal(out, text_clean_ref(t, strip_html=strip_html))
    return out.numpy()


@pytest.mark.parametrize("strip_html", [True, False], ids=["html", "nohtml"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_text_clean_op_matches_jax_kernel_and_oracle(name, strip_html):
    mat = MATRICES[name]
    got = port_clean(mat, strip_html)
    np.testing.assert_array_equal(got, np.asarray(jax_text_clean_ref(mat, strip_html=strip_html)))
    np.testing.assert_array_equal(got, np.asarray(
        jax_text_clean_op(mat, strip_html=strip_html, blk_rows=8, interpret=True)))


@pytest.mark.parametrize("strip_html", [True, False], ids=["html", "nohtml"])
def test_flat_plain_version_matches_the_matrix_one_on_ragged_rows(strip_html):
    """Rows of any length by offsets give the rows of the padded matrix,
    less the padding."""
    enc = [r.encode() for r in ADVERSARIAL + SUITE_ROWS]
    lens = np.array([len(e) for e in enc])
    buf = torch.frombuffer(bytearray(b"".join(enc)), dtype=torch.uint8)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]))
    flat = ops.text_clean_flat(buf, offsets, strip_html=strip_html)
    assert torch.equal(flat, text_clean_flat_ref(buf, offsets, strip_html=strip_html))
    mat = port_clean(ops.pack_rows(ADVERSARIAL + SUITE_ROWS), strip_html)
    for i, (start, n) in enumerate(zip(offsets[:-1].tolist(), lens)):
        np.testing.assert_array_equal(flat[start : start + n].numpy(), mat[i, :n])


@pytest.mark.parametrize("strip_html", [True, False], ids=["html", "nohtml"])
def test_clean_rows_matches_jax_clean_rows(strip_html):
    rng = np.random.default_rng(11)
    noise = [bytes(r).decode("latin-1") for r in _random_matrix(4, 12, 300)]
    rows = ADVERSARIAL + SUITE_ROWS + noise + [s[: rng.integers(1, 40)] for s in noise]
    got = ops.clean_rows(rows, strip_html=strip_html, device="cpu")
    assert got == jax_clean_rows(rows, strip_html=strip_html, interpret=True)
    assert PB.unflatten(ops.clean_flat(rows, strip_html=strip_html, device="cpu")) == got
    assert ops.clean_flat(rows, strip_html=strip_html, device="cpu").tobytes() == \
        PB.flatten(got).tobytes()


def test_sandbox_cases_and_the_empty_column_choice():
    """The documented cases, and the one deliberate difference: a column
    of empty rows. The reference's ``pack_rows`` makes a matrix of width 0
    and its Pallas grid divides by it; the port returns the empty rows."""
    assert jax_clean_rows(list(SANDBOX_CASES), interpret=True) == list(SANDBOX_CASES.values())
    assert ops.clean_rows(list(SANDBOX_CASES), device="cpu") == list(SANDBOX_CASES.values())
    with pytest.raises(ZeroDivisionError):
        jax_clean_rows(["", ""], interpret=True)
    assert ops.clean_rows(["", ""], device="cpu") == ["", ""]
    assert ops.clean_rows([], device="cpu") == [] == jax_clean_rows([], interpret=True)


def test_unpack_rows_matches_jax():
    from repro.kernels.text_clean.ops import unpack_rows as jax_unpack_rows

    mat = port_clean(MATRICES["adversarial"], True)
    assert ops.unpack_rows(mat) == jax_unpack_rows(mat)


def test_input_contract_and_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        ops.text_clean_op(torch.zeros(2, 3, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.text_clean_flat(torch.zeros(4, dtype=torch.uint8, device="meta"),
                            torch.zeros(2, dtype=torch.int64, device="meta"))
    with pytest.raises(TypeError, match="2-D uint8"):
        ops.text_clean_op(torch.zeros(6, dtype=torch.uint8))
    with pytest.raises(TypeError, match="2-D uint8"):
        ops.text_clean_op(torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(TypeError, match="offsets"):
        ops.text_clean_flat(torch.zeros(4, dtype=torch.uint8), torch.zeros(2, dtype=torch.int32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ops.clean_rows(["x"])
