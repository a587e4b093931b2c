"""The port's int8 gradient compression (``repro_torch.optim.grad_compression``)
against the JAX package: the quantization bit for bit on seeded inputs,
the error bound and the error feedback of ``tests/test_optim.py:54,61``,
and ``psum_compressed`` over the data axis of a 4-rank ``gloo`` world held
to the reference's ``psum_compressed`` under ``shard_map`` over 4 host
devices (one subprocess with ``--xla_force_host_platform_device_count=4``),
the sums and the carried errors bit for bit."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.optim import grad_compression as RG
from repro_torch.optim import grad_compression as G

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


def _start(cmd: list[str], env: dict) -> subprocess.Popen:
    return subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _finish(proc: subprocess.Popen, timeout: float) -> str:
    """Wait for ``proc``; kill its whole session on a timeout, so a hung
    collective fails the test and leaves nothing."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"timed out after {timeout} s:\n{out[-6000:]}")
    assert proc.returncode == 0, out[-6000:]
    return out


def run_both(jax_script: str, rank_script: str, out: Path, timeout: float = 180):
    """The JAX side, one process over ``WORLD`` host devices that writes
    ``OUT/jax.npz``, and the port's side, a world of ``WORLD`` local ranks
    (``torch.distributed.run`` on a free port, one thread each) each of
    which writes ``OUT/rank<r>.npz``, run at the same time; both read only
    what the test wrote into ``OUT`` first."""
    src = str(ROOT / "src")
    jax_env = dict(os.environ, PYTHONPATH=src, OUT=str(out), JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    rank_env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1", OUT=str(out))
    procs = [_start([sys.executable, "-c", jax_script], jax_env),
             _start([sys.executable, "-m", "torch.distributed.run", "--standalone",
                     f"--nproc-per-node={WORLD}", "--no-python", sys.executable, "-c",
                     rank_script], rank_env)]
    try:
        for proc in procs:
            _finish(proc, timeout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    return (dict(np.load(out / "jax.npz")),
            [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)])


def grads(seed: int) -> dict[str, np.ndarray]:
    """Each rank's gradients: rank r's rows of seeded (WORLD, ...) arrays."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((WORLD, 16, 8)) * 0.01).astype(np.float32),
            "b": (rng.standard_normal((WORLD, 33)) * 3.0).astype(np.float32)}


JAX_SCRIPT = r"""
import os
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_host_mesh, shard_map
from repro.optim.grad_compression import psum_compressed

rng = np.random.default_rng(0)
g = {"w": (rng.standard_normal((4, 16, 8)) * 0.01).astype(np.float32),
     "b": (rng.standard_normal((4, 33)) * 3.0).astype(np.float32)}
mesh = make_host_mesh(model_parallel=1)
spec = {"w": P("data", None, None), "b": P("data", None)}

@partial(shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec), check_vma=False)
def step(g, err):
    g = jax.tree.map(lambda x: x[0], g)
    err = jax.tree.map(lambda x: x[0], err)
    total, new_err = psum_compressed(g, ("data",), err)
    return (jax.tree.map(lambda x: x[None], total), jax.tree.map(lambda x: x[None], new_err))

err = jax.tree.map(jnp.zeros_like, g)
out = {}
for i in range(2):  # two steps: the second carries the first's error
    total, err = step(g, err)
    for k in g:
        out[f"sum{i}_{k}"] = np.asarray(total[k])
        out[f"err{i}_{k}"] = np.asarray(err[k])
np.savez(os.path.join(os.environ["OUT"], "jax.npz"), **out)
"""

RANK_SCRIPT = r"""
import os
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.launch.mesh import destroy_process_group, make_host_mesh
from repro_torch.optim.grad_compression import psum_compressed

mesh = make_host_mesh(1, device="cpu")  # (4, 1): the data axis spans the world
rank = torch.distributed.get_rank()
rng = np.random.default_rng(0)
g = {"w": (rng.standard_normal((4, 16, 8)) * 0.01).astype(np.float32),
     "b": (rng.standard_normal((4, 33)) * 3.0).astype(np.float32)}
mine = {k: torch.from_numpy(v[rank]) for k, v in g.items()}
err, out = None, {}
for i in range(2):
    total, err = psum_compressed(mine, (mesh, ("data",)), err)
    for k in mine:
        out[f"sum{i}_{k}"] = total[k].numpy()
        out[f"err{i}_{k}"] = err[k].numpy()
np.savez(os.path.join(os.environ["OUT"], f"rank{rank}.npz"), **out)
destroy_process_group()
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_both(JAX_SCRIPT, RANK_SCRIPT, tmp_path_factory.mktemp("psum"))


def test_psum_compressed_is_the_references_bit_for_bit(worlds):
    ref, ranks = worlds
    for r, got in enumerate(ranks):
        for key, want in ref.items():
            np.testing.assert_array_equal(got[key], want[r], err_msg=f"rank {r} {key}")


def test_psum_compressed_sums_over_the_ranks(worlds):
    _, ranks = worlds
    g = grads(0)
    for key in g:
        # every rank holds the same sum, within one shared-scale step per rank of the true sum
        for got in ranks[1:]:
            np.testing.assert_array_equal(got[f"sum0_{key}"], ranks[0][f"sum0_{key}"])
        scale = np.abs(g[key]).max() / 127.0
        assert np.abs(ranks[0][f"sum0_{key}"] - g[key].sum(0)).max() <= WORLD * scale * 0.5 + 1e-6


@pytest.mark.parametrize("seed", range(4))
def test_quantize_and_trees_are_the_references_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    tree = {"a": (rng.standard_normal((7, 5)) * 10 ** rng.uniform(-4, 2)).astype(np.float32),
            "b": rng.uniform(-1, 1, 64).astype(np.float32),
            "half": np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, -127.0], np.float32)}
    for k, x in tree.items():
        q, s = G.quantize_int8(torch.from_numpy(x))
        jq, js = RG.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq), err_msg=k)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert s.item() == float(js)
        np.testing.assert_array_equal(G.dequantize_int8(q, s).numpy(),
                                      np.asarray(RG.dequantize_int8(jq, js)))
    err = jerr = None
    for _ in range(3):  # carried error three times
        q, s, err = G.compress_tree({k: torch.from_numpy(v) for k, v in tree.items()}, err)
        jq, js, jerr = RG.compress_tree({k: jnp.asarray(v) for k, v in tree.items()}, jerr)
        for k in tree:
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_array_equal(err[k].numpy(), np.asarray(jerr[k]))
            np.testing.assert_array_equal(G.decompress_tree(q, s)[k].numpy(),
                                          np.asarray(RG.decompress_tree(jq, js)[k]))


@settings(max_examples=30, deadline=None)
@given(st.lists(st.floats(-1e3, 1e3, allow_nan=False), min_size=1, max_size=40))
def test_int8_quantization_error_bound(vals):
    x = torch.tensor(vals, dtype=torch.float32)
    q, s = G.quantize_int8(x)
    err = (G.dequantize_int8(q, s) - x).abs()
    assert err.max().item() <= s.item() * 0.5 + 1e-6  # half a step of the int8 grid


def test_error_feedback_reduces_bias():
    """With error feedback the accumulated quantized sum stays within one
    quantization step of the true sum (``tests/test_optim.py:61``)."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)) * 0.01
    true_sum = torch.zeros(64, dtype=torch.float64)
    ef_sum = torch.zeros(64, dtype=torch.float64)
    err = None
    for _ in range(50):
        true_sum += g.double()
        q, s, err = G.compress_tree({"g": g}, err)
        ef_sum += G.decompress_tree(q, s)["g"].double()
    assert (ef_sum - true_sum).abs().max().item() <= s["g"].item() + 1e-6
