"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into an object file, all
sources at once in parallel, and the objects link into one shared library
with a plain C interface, ``build/repro_torch/libkernels.so`` at the root
of the checkout. The library is loaded with ``ctypes``; every pointer and
the stream are passed as ``c_void_p``.

The build happens at the first launch and is cached by a hash of the
sources (and flags): a later process reuses the library while the hash
matches. A failed build raises with nvcc's stderr; nothing falls back.
Importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIBRARY = BUILD_DIR / "libkernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points and their argument types; each returns cudaGetLastError().
SIGNATURES = {
    "lstm_cell_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "lstm_cell_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # x, h, c, wx, wh, b, h_out, c_out, gates_out; B, d_in, H; stream
    "lstm_cell_train_f32": (_P,) * 9 + (_I,) * 3 + (_P,),
    # dh (or null), dc (or null), gates, c, c_new, dz, dc_prev; B, H; stream
    "lstm_cell_bwd_f32": (_P,) * 7 + (_I,) * 2 + (_P,),
    # dhs, dh_last, dc_last (each or null), gates, cs, wh, dz, dh0, dc0; T, B,
    # H; stream
    "lstm_layer_bwd_f32": (_P,) * 9 + (_I,) * 3 + (_P,),
    "text_scan": (_P, _P, _P, _I, _I, _I, _I, _P),
    # in, out, offsets (or null); n_rows, width (rows of null offsets); strip_html; stream
    "text_clean": (_P, _P, _P, _I, _L, _I, _P),
    # q, k, v, out; b, sq, skv, nq, nkv, hd; (batch, seq, head) strides of
    # q, k and v in elements; causal, window, q_offset, kv_len; rows a block,
    # blocks of a cluster; scale; stream
    "flash_attention_f32": (_P,) * 4 + (_I,) * 6 + (_L,) * 9 + (_I,) * 6 + (_F, _P),
    "flash_attention_bf16": (_P,) * 4 + (_I,) * 6 + (_L,) * 9 + (_I,) * 6 + (_F, _P),
    # q, k, v, out, lse; b, sq, skv, nq, nkv, hd; causal, window; scale; stream
    "flash_attention_train_f32": (_P,) * 5 + (_I,) * 8 + (_F, _P),
    # q, k, v, out, dout, lse, delta, dq_part, dkv_part (each or null), dq,
    # dk, dv; b, sq, skv, nq, nkv, hd; causal, window; the tiles dq_part
    # holds; the head split; scale; stream
    "flash_attention_bwd_f32": (_P,) * 12 + (_I,) * 10 + (_F, _P),
    # the same for bf16 q, k, v, out (lse fp32)
    "flash_attention_train_bf16": (_P,) * 5 + (_I,) * 8 + (_F, _P),
    # q, k, v, dout (bf16), lse, rows (fp32 scratch: lse and D for the
    # key-tile kernel), dkv_part (or null), dq, dk, dv; b, sq, skv, nq, nkv,
    # hd; causal, window; the head split; scale; stream
    "flash_attention_bwd_bf16": (_P,) * 10 + (_I,) * 9 + (_F, _P),
    # a, b, h0 (or null), out, h_last; dtype (0 fp32, 1 bf16), batch, seq, d; stream
    "rg_lru": (_P,) * 5 + (_I,) * 4 + (_P,),
    # a, h, h0, dh, dlast (each of the last three or null), da, db, dh0 (or
    # null); batch, seq, d; stream
    "rg_lru_bwd_f32": (_P,) * 8 + (_I,) * 3 + (_P,),
    # q, k, v, i, f, C (in place), n_in, m_in, n_out, m_out, out; b, s, H, dh; stream
    "mlstm_chunk_f32": (_P,) * 11 + (_I,) * 4 + (_P,),
    # q, k, v, i, f, C_in, n_in, m_in, C_out, n_out, m_out, out, the chunks'
    # input C, n and m; workspace; b, s, H, dh; stream
    "mlstm_chunk_train_f32": (_P,) * 16 + (_I,) * 4 + (_P,),
    # q, k, v, i, f, the chunks' input C, n, m, h, dh, dC, dn, dm (each of
    # the last three or null); dq, dk, dv, di, df, dC0, dn0, dm0; workspace;
    # b, s, H, dh; stream
    "mlstm_chunk_bwd_f32": (_P,) * 22 + (_I,) * 4 + (_P,),
}
# entry points that return a size, not an error code
SIZES = {"mlstm_chunk_bwd_workspace": (_I,) * 4, "mlstm_chunk_train_workspace": (_I,) * 4,
         "lstm_layer_bwd_max_hidden": (), "flash_attention_bwd_bf16_kernels": ()}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build, if it built
# per source, when this process built: nvcc's seconds and ptxas's resource
# lines (registers, spills, static shared memory) of each kernel
build_report: dict[str, dict] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (neither on PATH nor under /usr/local/cuda/bin)")


def _run_all(cmds: list[list[str]]) -> list[tuple[float, str]]:
    """Run the commands in parallel -> (seconds, stderr) of each; raise
    with the output if any fails."""
    def run(cmd):
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True)
        return p, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        done = list(pool.map(run, cmds))
    failures = [f"$ {' '.join(cmd)}\n{p.stdout}{p.stderr}"
                for cmd, (p, _) in zip(cmds, done) if p.returncode != 0]
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return [(seconds, p.stderr) for p, seconds in done]


def _resources(ptxas_log: str) -> dict[str, str]:
    """ptxas's ``-v`` lines by mangled kernel name: registers, barriers,
    static shared memory and spills."""
    out: dict[str, str] = {}
    name = None
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("Used" in line or "spill" in line):
            part = line.split(":", 1)[-1].strip()
            out[name] = f"{out[name]}; {part}" if name in out else part
    return out


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``LIBRARY`` unless the cached build matches."""
    global build_seconds
    digest = source_hash()
    stamp = LIBRARY.with_suffix(".so.sha256")
    if LIBRARY.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIBRARY
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tool = nvcc()
    tag = str(os.getpid())  # private names: concurrent builds never share files
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    compiled = _run_all([[tool, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                         for src, obj in zip(sources(), objs)])
    for src, (seconds, log) in zip(sources(), compiled):
        build_report[src.name] = {"seconds": seconds, "kernels": _resources(log)}
    tmp = BUILD_DIR / f"libkernels.{tag}.so"
    _run_all([[tool, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, LIBRARY)
    stamp.write_text(digest)
    build_seconds = time.perf_counter() - t0
    return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, argtypes in SIZES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_longlong
            lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def current_stream(device) -> int:
    """PyTorch's current stream on ``device`` as a raw handle. The library
    launches on the calling thread's current CUDA device, so ``device`` must
    be that device."""
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {device}, but the current CUDA device is "
                         f"cuda:{torch.cuda.current_device()}; use torch.cuda.device()")
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
