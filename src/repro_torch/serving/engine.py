"""Serving engine: slot-based continuous batching over prefill and decode
(port of ``repro/serving/engine.py``).

One resident batched KV cache (max_batch × max_len); requests are admitted
into free slots (per-request prefill scattered into the slot), every engine
step runs ONE batched decode over all slots with per-slot positions, and
finished slots are recycled without draining the batch. The cache is
updated in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.model import CausalLM


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (T,) int32
    max_new_tokens: int = 16
    eos_id: int = -1                 # -1: never stops early
    out: list = dataclasses.field(default_factory=list)


class Engine:
    def __init__(self, model: CausalLM, max_batch: int, max_len: int,
                 cache_dtype=torch.float32):
        self.model = model
        self.b, self.s = max_batch, max_len
        self.cache_dtype = cache_dtype
        self.cache = model.empty_cache(max_batch, max_len, dtype=cache_dtype)
        self.pos = np.zeros(max_batch, np.int32)         # next write position
        self.budget = np.zeros(max_batch, np.int32)
        self.eos = np.full(max_batch, -1, np.int32)
        self.slot_req: list = [None] * max_batch
        self.next_tok = np.zeros(max_batch, np.int32)
        self.steps_run = 0

    # ------------------------------------------------------------------
    def free_slots(self) -> list:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def admit(self, req: Request):
        """Prefill into a free slot. Returns the request if it already
        finished (max_new_tokens == 1 or EOS: the prefill emits the only
        token)."""
        slot = self.free_slots()[0]
        t = len(req.prompt)
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                 device=self.model.device)[None]
        logits, cache1 = self.model.prefill(tokens, max_len=self.s,
                                            cache_dtype=self.cache_dtype)
        self.model.insert_cache(self.cache, cache1, slot)   # scatter into the slot
        first = int(torch.argmax(logits[0]))
        req.out.append(first)
        if req.max_new_tokens <= 1 or first == req.eos_id:
            return req
        self.slot_req[slot] = req
        self.pos[slot] = t
        self.budget[slot] = req.max_new_tokens - 1  # prefill emitted one
        self.eos[slot] = req.eos_id
        self.next_tok[slot] = first
        return None

    def active(self) -> np.ndarray:
        return np.array([r is not None for r in self.slot_req])

    def step(self) -> list:
        """One batched decode step. Returns finished Requests."""
        if not self.active().any():
            return []
        dev = self.model.device
        tok = torch.as_tensor(self.next_tok, dtype=torch.int64, device=dev)[:, None]
        pos = torch.as_tensor(self.pos, dtype=torch.int64, device=dev)
        logits, _ = self.model.decode_step(tok, self.cache, pos)
        nxt = logits.argmax(dim=-1).cpu().numpy().astype(np.int32)
        self.steps_run += 1
        finished = []
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.pos[i] += 1
            self.budget[i] -= 1
            req.out.append(int(nxt[i]))
            self.next_tok[i] = nxt[i]
            if self.budget[i] <= 0 or nxt[i] == self.eos[i] or self.pos[i] >= self.s - 1:
                finished.append(req)
                self.slot_req[i] = None
        return finished
