"""Train/serve skew in the port: ``Dataset.row_program()`` gives, row for
row, the int32 token arrays of the port's shard executor over the same
plan, and the JAX package's ``RowProgram``'s (``loops``), under ``loops``,
``fused`` and ``device`` on the CPU, for the projected (``encode_flat``)
and the raw-column (``encode_rows``) paths; cross-row plans raise ``P016``;
the fingerprint follows the plan and the vocabulary, and not the device.
Mirrors ``tests/test_row_program.py`` on its adversarial rows."""

import dataclasses

import numpy as np
import pytest

from repro.core.dataset import Dataset as JDataset
from repro.core import expr as JE
from repro.data.batching import TokenSpec as JTokenSpec, seq2seq_specs as jseq2seq_specs
from repro_torch.analysis import PlanValidationError
from repro_torch.core import executor as PX
from repro_torch.core import expr as PE
from repro_torch.core import plan as PP
from repro_torch.core.dataset import Dataset
from repro_torch.data.batching import TokenSpec, seq2seq_specs
from repro_torch.kernels.text_clean import ops as pscan_ops
from repro_torch.runtime.row_program import RowProgram, RowProgramError
from test_row_program import EDGE_RECORDS, fuzz_records, write_shards

BACKENDS = ["loops", "fused", "device"]
ENV = ("REPRO_BYTES_BACKEND", "REPRO_EXECUTOR", "REPRO_CACHE", "REPRO_CACHE_DIR",
       "REPRO_WORKERS")


@pytest.fixture(autouse=True)
def no_engine_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def canonical_chain(D, E, d):
    keep = E.col("title").not_empty() & E.col("abstract").not_empty()
    return (D.from_json_dirs([d]).where(keep)
            .transform(abstract=E.abstract_expr(), title=E.title_expr()).where(keep))


def executor_outputs(chain, shards):
    """The training path: the port's compiled program on its thread shard
    executor, results in shard order."""
    tok_node = next(n for n in chain.plan if isinstance(n, PP.Tokenize))
    frame_nodes, _ = PP.split_plan(chain.plan)
    frame_nodes = PP.optimize_plan(frame_nodes, chain._needed_columns())
    cols = tuple(dict.fromkeys(s.column for s in tok_node.specs))
    program = PX.compile_shard_program(
        frame_nodes, output_columns=cols,
        tokens=PX.TokenPlan(tuple(tok_node.specs), dict(tok_node.tokenizer.stoi),
                            tok_node.tokenizer.fingerprint),
        backend=chain.engine_config().resolve_backend(), device="cpu")
    results = sorted(PX.make_executor(shards, program, workers=2, executor="thread"),
                     key=lambda r: r.shard_index)
    return {s.name: np.concatenate([r.tokens[s.name] for r in results])
            for s in tok_node.specs}


def assert_rows_equal(rp, jrp, records, ref):
    outs, keep = rp.encode_batch(records)
    jouts, jkeep = jrp.encode_batch(records)
    np.testing.assert_array_equal(keep, jkeep)
    assert int(keep.sum()) == len(next(iter(ref.values())))
    for name, arr in ref.items():
        assert outs[name].dtype == np.int32
        np.testing.assert_array_equal(outs[name], arr, err_msg=name)
        np.testing.assert_array_equal(outs[name], jouts[name], err_msg=name)
    kept = 0
    for rec, k in zip(records, keep):
        got, want = rp(rec), jrp(rec)
        if not k:
            assert got is None and want is None
            continue
        for name, arr in ref.items():
            np.testing.assert_array_equal(got[name][0], arr[kept])
            np.testing.assert_array_equal(got[name], want[name])
        kept += 1


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("records", [EDGE_RECORDS, fuzz_records(7, 40), fuzz_records(11, 40)],
                         ids=["edges", "fuzz7", "fuzz11"])
def test_row_program_matches_shard_executor_and_reference(tmp_path, backend, records):
    shards = write_shards(tmp_path / "corpus", records)
    base = canonical_chain(Dataset, PE, tmp_path / "corpus").device("cpu")
    tok = base.fit_vocab(vocab_size=300, workers=1)
    chain = base.tokenize(tok, seq2seq_specs(32, 12)).batched(4).prefetch(2).backend(backend)
    rp = chain.row_program()
    assert (rp.backend, rp.device) == (backend, "cpu" if backend == "device" else None)
    jbase = canonical_chain(JDataset, JE, tmp_path / "corpus").backend("loops")
    jtok = jbase.fit_vocab(vocab_size=300, workers=1)
    assert jtok.stoi == tok.stoi
    jrp = jbase.tokenize(jtok, jseq2seq_specs(32, 12)).batched(4).prefetch(2).row_program()
    assert_rows_equal(rp, jrp, records, executor_outputs(chain, shards))


@pytest.mark.parametrize("backend", BACKENDS)
def test_row_program_raw_column_path_matches(tmp_path, backend):
    """A plan that tokenizes an unprojected column: the ``encode_rows`` path."""
    records = EDGE_RECORDS + fuzz_records(3, 20)
    shards = write_shards(tmp_path / "corpus", records)
    ds = Dataset.from_json_dirs([tmp_path / "corpus"]).where(PE.col("abstract").not_empty())
    tok = ds.device("cpu").fit_vocab(vocab_size=200, workers=1)
    chain = (ds.tokenize(tok, [TokenSpec("abstract", 24), TokenSpec("title", 16)])
             .batched(4).prefetch(2).backend(backend).device("cpu"))
    jds = JDataset.from_json_dirs([tmp_path / "corpus"]).where(JE.col("abstract").not_empty())
    jtok = jds.fit_vocab(vocab_size=200, workers=1)
    jrp = (jds.tokenize(jtok, [JTokenSpec("abstract", 24), JTokenSpec("title", 16)])
           .batched(4).prefetch(2).backend("loops").row_program())
    assert_rows_equal(chain.row_program(), jrp, records, executor_outputs(chain, shards))


def test_row_program_single_field_accepts_bare_strings(tmp_path):
    write_shards(tmp_path / "corpus", [{"abstract": "Deep LEARNING for (scholarly) data!"}],
                 n_files=1)
    ds = (Dataset.from_json_dirs([tmp_path / "corpus"], fields=("abstract",))
          .transform(abstract=PE.abstract_expr()).device("cpu"))
    tok = ds.fit_vocab(vocab_size=100)
    rp = ds.tokenize(tok, [TokenSpec("abstract", 16)]).batched(2).prefetch(2).row_program()
    out = rp("Deep LEARNING for (scholarly) data!")
    assert out is not None and out["abstract_tokens"].shape == (1, 16)
    out2 = rp({"abstract": "Deep LEARNING for (scholarly) data!"})
    np.testing.assert_array_equal(out["abstract_tokens"], out2["abstract_tokens"])
    with pytest.raises(RowProgramError, match="unsupported request row"):
        rp(3.5)


def test_cross_row_plans_and_untokenized_plans_raise_p016(tmp_path):
    write_shards(tmp_path / "corpus", [{"title": "t", "abstract": "a"}], n_files=1)
    base = canonical_chain(Dataset, PE, tmp_path / "corpus").device("cpu")
    ds = base.drop_duplicates()
    tok = ds.fit_vocab(vocab_size=50)
    for plan in (ds.tokenize(tok, seq2seq_specs(16, 8)).batched(2).prefetch(2), base):
        with pytest.raises(PlanValidationError) as err:
            plan.row_program()
        assert any(d.code == "P016" for d in err.value.diagnostics)
    with pytest.raises(RowProgramError, match="cross-row"):
        RowProgram(fields=("a",), steps=(("dedup", ("a",)),), specs=(TokenSpec("a", 8),),
                   stoi={}, vocab_fp="x")
    with pytest.raises(RowProgramError, match="token plan"):
        RowProgram(fields=("a",), steps=(), specs=(), stoi={}, vocab_fp="x")


def test_fingerprint_tracks_plan_and_vocab_not_the_device(tmp_path):
    rec = {"title": "alpha beta gamma delta",
           "abstract": "epsilon zeta eta theta iota kappa lambda nu omicron rho"}
    write_shards(tmp_path / "corpus", [rec] * 3, n_files=1)
    base = canonical_chain(Dataset, PE, tmp_path / "corpus").device("cpu")
    tok = base.fit_vocab(vocab_size=100)

    def rp(t, chain=base, **kw):
        return chain.tokenize(t, seq2seq_specs(16, 8)).batched(2).prefetch(2).row_program(**kw)

    first = rp(tok)
    assert first.fingerprint == rp(tok).fingerprint
    assert rp(base.fit_vocab(vocab_size=6)).fingerprint != first.fingerprint
    other_plan = base.where(PE.col("abstract").word_count() >= 3)
    assert rp(tok, other_plan).fingerprint != first.fingerprint
    # where the scans run is no part of the key; the terminal's device wins
    moved = rp(tok, canonical_chain(Dataset, PE, tmp_path / "corpus").device("meta"),
               device="cpu")
    assert moved.device == "cpu" and moved.fingerprint == first.fingerprint
    assert dataclasses.replace(first, device="meta").fingerprint == first.fingerprint


def test_the_device_backend_scans_through_the_kernel_wrapper(tmp_path, monkeypatch):
    """Under ``device`` each call's projection goes through ``text_scan_op``
    on the program's device: one scan a column for the fused chain."""
    calls = []

    def counting(buf, offsets, **flags):
        calls.append(buf.device.type)
        return pscan_ops.text_scan_ref(buf, offsets, **flags)

    monkeypatch.setattr(pscan_ops, "text_scan_op", counting)
    write_shards(tmp_path / "corpus", EDGE_RECORDS, n_files=1)
    base = canonical_chain(Dataset, PE, tmp_path / "corpus").device("cpu")
    tok = base.fit_vocab(vocab_size=100)
    rp = base.tokenize(tok, seq2seq_specs(16, 8)).batched(2).prefetch(2).row_program()
    calls.clear()
    assert rp(EDGE_RECORDS[-1]) is not None
    assert calls == ["cpu", "cpu"]
    loops = dataclasses.replace(rp, backend="loops")
    calls.clear()
    np.testing.assert_array_equal(loops(EDGE_RECORDS[-1])["encoder_tokens"],
                                  rp(EDGE_RECORDS[-1])["encoder_tokens"])
    assert calls == ["cpu", "cpu"]
