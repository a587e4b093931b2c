"""Serving an LM: continuous batching over pre-tokenized prompts.

Counterpart of the pre-tokenized half of ``repro/runtime/serve_loop.py``:
``make_serve_step`` (:47), ``Request`` (:63), ``_continuous_decode``
(:170) and ``serve_requests`` (:232). Fixed decode slots of batch 1, each
with its own KV cache in the model's dtype (fp32 for the served models,
as the JAX loop's default); a finished slot refills at once with a block
prefill of the next prompt. Greedy tokens come from ``torch.argmax``,
which takes the first maximum as ``jnp.argmax`` does. The text entry
point (``serve_text`` with its admission queue, ring cache and stats)
waits for the row-program port (ROADMAP.md Queue 1: the rest of the LM
family).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


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


def _continuous_decode(
    model,
    requests: Sequence[Request],
    *,
    slots: int = 4,
    max_seq: int = 128,
    eos_id: int = 2,
) -> dict[int, list[int]]:
    """The slot loop: each request's generated tokens by uid. A slot is done
    at ``eos_id``, at ``max_new`` tokens, or when the next position would
    reach ``max_seq``, and then takes the next request in order."""
    step = make_serve_step(model)
    device = model.device
    queue = deque(requests)
    results: dict[int, list[int]] = {}
    states: list = [None] * slots
    active: list[dict | None] = [None] * slots
    last_tok = [0] * slots

    def fill(slot: int) -> None:
        if not queue:
            active[slot] = None
            return
        req = queue.popleft()
        states[slot] = model.init_decode_state(1, max_seq)
        tokens = torch.from_numpy(np.asarray(req.prompt, dtype=np.int32)[None]).to(device)
        logits, states[slot] = model.decode_step(tokens, states[slot], 0)
        nxt = int(torch.argmax(logits[0, -1]))
        active[slot] = {"uid": req.uid, "max_new": req.max_new, "pos": len(req.prompt),
                        "out": [nxt]}
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
                results[a["uid"]] = a["out"]
                fill(s)
                continue
            toks = torch.full((1, 1), last_tok[s], dtype=torch.int32, device=device)
            nxt, _, states[s] = step(toks, states[s], a["pos"])
            last_tok[s] = int(nxt[0, 0])
            a["out"].append(last_tok[s])
            a["pos"] += 1
    return results


def serve_requests(
    model,
    requests: Sequence[Request],
    *,
    slots: int = 4,
    max_seq: int = 128,
    eos_id: int = 2,
) -> dict[int, list[int]]:
    """Generated tokens by request uid, through ``slots`` decode slots."""
    return _continuous_decode(model, requests, slots=slots, max_seq=max_seq, eos_id=eos_id)
