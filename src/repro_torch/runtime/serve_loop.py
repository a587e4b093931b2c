"""Serving: continuous batching over pre-tokenized prompts or raw text.

Counterpart of ``repro/runtime/serve_loop.py``. Layers, bottom up:

* ``make_serve_step`` (:47): one greedy decode step on the model's device.
* ``_continuous_decode`` (:170): the slot driver. Fixed decode slots of
  batch 1, each with its own KV cache in the model's dtype (fp32 for the
  served models, as the JAX loop's default); a finished slot refills at
  once from a ``next_item`` callback with a block prefill of the next
  prompt. Greedy tokens come from ``torch.argmax``, which takes the first
  maximum as ``jnp.argmax`` does.
* ``serve_requests`` (:232): the pre-tokenized entry point (:class:`Request`
  carries an int32 prompt), used by ``launch/serve.py``.
* ``serve_text`` (:280): raw text in, token lists out, with an
  :class:`AdmissionQueue` that sheds load on arrival, per-request
  preprocessing through a :class:`~repro_torch.runtime.row_program.RowProgram`
  when a slot picks the request up, a :class:`RingCache` fronting repeated
  prompts and a :class:`ServeStats` ledger.

Contract (the reference's linter rule R005): this module is the serve hot
path and never imports the shard/shm/pool machinery (``core.executor``,
``core.async_loader``, ``multiprocessing``). The row program arrives as an
argument; anything it needs it carries.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

PAD_ID = 0


def make_serve_step(model):
    """``serve_step(tokens (b, 1), state, pos) -> (next_tokens (b, 1) int32,
    logits, state)``: one greedy decode step on the model's device."""

    def serve_step(tokens, state, pos):
        logits, state = model.decode_step(tokens, state, pos)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, logits, state

    return serve_step


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new: int = 16


@dataclass
class TextRequest:
    """A raw serving request: abstract text (or a field dict for multi-field
    plans), encoded through the row program at admission time. Copy of
    ``repro/runtime/serve_loop.py:70``."""

    uid: int
    text: str | Mapping[str, Any]
    max_new: int = 16


class AdmissionQueue:
    """Bounded FIFO admission queue: load is shed on *arrival* (``offer``
    returns False and counts a rejection when full), so an overloaded
    server degrades by refusing new work deterministically instead of
    queueing unboundedly. Thread-safe: producers may offer from request
    threads while the decode loop pops. Copy of
    ``repro/runtime/serve_loop.py:79``."""

    def __init__(self, maxsize: int = 16):
        if maxsize < 1:
            raise ValueError(f"queue size must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self.admitted = 0
        self.rejected = 0
        self._items: deque = deque()
        self._lock = threading.Lock()

    def offer(self, item: Any) -> bool:
        with self._lock:
            if len(self._items) >= self.maxsize:
                self.rejected += 1
                return False
            self._items.append(item)
            self.admitted += 1
            return True

    def pop(self) -> Any | None:
        with self._lock:
            return self._items.popleft() if self._items else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class RingCache:
    """Fixed-slot FIFO response cache fronting repeated prompts: a fixed
    number of slots, overwrite-oldest on overflow, so a repeated prompt
    skips preprocessing *and* decoding entirely. Keys should bind the
    row-program fingerprint (see :func:`serve_text`), making a stale hit
    across plan or vocab changes structurally impossible. Copy of
    ``repro/runtime/serve_loop.py:113``."""

    def __init__(self, slots: int = 64):
        if slots < 1:
            raise ValueError(f"cache slots must be >= 1, got {slots}")
        self.slots = slots
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._data: OrderedDict = OrderedDict()

    def get(self, key: Any) -> list[int] | None:
        hit = self._data.get(key)
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        return list(hit)

    def put(self, key: Any, value: Sequence[int]) -> None:
        if key in self._data:
            self._data[key] = list(value)
            return
        if len(self._data) >= self.slots:
            self._data.popitem(last=False)  # FIFO: overwrite-oldest
            self.evictions += 1
        self._data[key] = list(value)

    def __len__(self) -> int:
        return len(self._data)


@dataclass
class ServeStats:
    """One serve run's ledger: admission/shed/filter counters, ring-cache
    accounting, the preprocess-vs-decode wall-time split, and per-request
    end-to-end latency (admission offer -> final token). Copy of
    ``repro/runtime/serve_loop.py:154``."""

    admitted: int = 0
    rejected: int = 0
    filtered: int = 0
    served: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    preprocess_s: float = 0.0
    decode_s: float = 0.0
    latency_s: dict[int, float] = field(default_factory=dict)


def _continuous_decode(
    model,
    next_item: Callable[[], tuple[int, np.ndarray, int] | None],
    on_done: Callable[[int, list[int]], None],
    *,
    slots: int = 4,
    max_seq: int = 128,
    eos_id: int = 2,
) -> None:
    """The slot loop: ``next_item`` returns ``(uid, prompt, max_new)`` or
    None when drained, and ``on_done`` receives each request's generated
    tokens. A slot is done at ``eos_id``, at ``max_new`` tokens, or when the
    next position would reach ``max_seq``, and then refills at once."""
    step = make_serve_step(model)
    device = model.device
    states: list = [None] * slots
    active: list[dict | None] = [None] * slots
    last_tok = [0] * slots

    def fill(slot: int) -> None:
        item = next_item()
        if item is None:
            active[slot] = None
            return
        uid, prompt, max_new = item
        states[slot] = model.init_decode_state(1, max_seq)
        tokens = torch.from_numpy(np.asarray(prompt, dtype=np.int32)[None]).to(device)
        logits, states[slot] = model.decode_step(tokens, states[slot], 0)
        nxt = int(torch.argmax(logits[0, -1]))
        active[slot] = {"uid": uid, "max_new": max_new, "pos": len(prompt), "out": [nxt]}
        last_tok[slot] = nxt

    for s in range(slots):
        fill(s)

    while any(a is not None for a in active):
        for s in range(slots):
            a = active[s]
            if a is None:
                continue
            done = (
                last_tok[s] == eos_id
                or len(a["out"]) >= a["max_new"]
                or a["pos"] + 1 >= max_seq
            )
            if done:
                on_done(a["uid"], a["out"])
                fill(s)
                continue
            toks = torch.full((1, 1), last_tok[s], dtype=torch.int32, device=device)
            nxt, _, states[s] = step(toks, states[s], a["pos"])
            last_tok[s] = int(nxt[0, 0])
            a["out"].append(last_tok[s])
            a["pos"] += 1


def serve_requests(
    model,
    requests: Sequence[Request],
    *,
    slots: int = 4,
    max_seq: int = 128,
    eos_id: int = 2,
) -> dict[int, list[int]]:
    """Generated tokens by request uid, through ``slots`` decode slots."""
    queue = deque(requests)
    results: dict[int, list[int]] = {}

    def next_item():
        if not queue:
            return None
        req = queue.popleft()
        return req.uid, req.prompt, req.max_new

    def on_done(uid: int, out: list[int]) -> None:
        results[uid] = out

    _continuous_decode(model, next_item, on_done, slots=slots, max_seq=max_seq,
                       eos_id=eos_id)
    return results


def _cache_key(row_program, text: str | Mapping[str, Any]) -> tuple:
    """Bind the response cache to this exact plan + vocabulary: any change
    to the compiled steps or the fitted tokenizer changes the fingerprint,
    so a redeploy can never serve stale cached completions. Copy of
    ``repro/runtime/serve_loop.py:269``."""
    if isinstance(text, Mapping):
        text_key: Any = tuple(sorted((str(k), str(v)) for k, v in text.items()))
    else:
        text_key = text
    return (row_program.fingerprint, text_key)


def serve_text(
    model,
    row_program,
    requests: Sequence[TextRequest],
    *,
    slots: int = 4,
    max_seq: int = 128,
    queue_size: int = 16,
    eos_id: int = 2,
    prompt_output: str | None = None,
    cache: RingCache | None = None,
    stats: ServeStats | None = None,
) -> dict[int, list[int]]:
    """End-to-end serving: raw text in, generated token lists out.

    Each request is checked against the ring cache at admission (key =
    row-program fingerprint + text; a hit completes immediately), then
    offered to the bounded admission queue — a full queue sheds the
    request on arrival (no entry in the result dict; counted in
    ``stats.rejected``). Admitted requests are preprocessed through the
    row program when a decode slot picks them up: the prompt is
    ``prompt_output``'s non-pad prefix (default: the program's first token
    output), clamped to ``max_seq - 1``. A request whose row the plan
    filters out — or that encodes to an empty prompt — is answered with
    ``[]`` and counted in ``stats.filtered``; it never occupies a slot.

    ``stats`` (a :class:`ServeStats`) receives counters, the
    preprocess-vs-decode time split, and per-uid end-to-end latency.
    Copy of ``repro/runtime/serve_loop.py:280``, without its ``params``
    (the port's model holds its weights) and ``cache_dtype`` (the KV cache
    holds the model's dtype).
    """
    st = stats if stats is not None else ServeStats()
    out_name = prompt_output or row_program.output_names[0]
    queue = AdmissionQueue(queue_size)
    results: dict[int, list[int]] = {}
    offered_at: dict[int, float] = {}
    keys: dict[int, tuple] = {}
    t_start = time.perf_counter()

    for req in requests:
        key = _cache_key(row_program, req.text)
        now = time.perf_counter()
        if cache is not None:
            hit = cache.get(key)
            if hit is not None:
                results[req.uid] = hit
                st.cache_hits += 1
                st.served += 1
                st.latency_s[req.uid] = time.perf_counter() - now
                continue
            st.cache_misses += 1
        if queue.offer(req):
            offered_at[req.uid] = now
            keys[req.uid] = key
        else:
            st.rejected += 1
    st.admitted += queue.admitted  # += so one ledger can span serve waves

    def next_item():
        while True:
            req = queue.pop()
            if req is None:
                return None
            t0 = time.perf_counter()
            encoded = row_program(req.text)
            st.preprocess_s += time.perf_counter() - t0
            prompt = None if encoded is None else encoded[out_name][0]
            if prompt is not None:
                prompt = prompt[prompt != PAD_ID][: max_seq - 1]
            if prompt is None or prompt.size == 0:
                # Filtered by the plan (or cleaned to nothing): answer
                # empty immediately, don't burn a decode slot.
                results[req.uid] = []
                st.filtered += 1
                st.latency_s[req.uid] = time.perf_counter() - offered_at[req.uid]
                continue
            return req.uid, np.asarray(prompt, dtype=np.int32), req.max_new

    def on_done(uid: int, out: list[int]) -> None:
        results[uid] = out
        st.served += 1
        st.latency_s[uid] = time.perf_counter() - offered_at[uid]
        if cache is not None:
            cache.put(keys[uid], out)

    _continuous_decode(model, next_item, on_done, slots=slots, max_seq=max_seq,
                       eos_id=eos_id)
    st.decode_s += (time.perf_counter() - t_start) - st.preprocess_s
    return results
