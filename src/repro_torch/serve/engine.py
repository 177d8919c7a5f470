"""Batched serving engine: prefill + decode with continuous batching (the
reference's ``serve/engine.py``).

The hot path is the bundle's ``decode`` over a fixed-capacity batch of
slots; the engine admits and evicts requests between steps (continuous
batching), so a finished sequence's slot is refilled at once.  Each
admitted request is prefilled alone (batch 1) and its cache spliced into
its slot.

The reference jits the decode with the cache donated; the port decodes
eagerly and writes the cache in place, under ``torch.inference_mode()``.
The host reads the sampled tokens (``argmax``) once per step, outside
any captured code.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) integer token ids
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _leaves(tree):
    """The tensors of a (nested) cache dict, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


class ServeEngine:
    def __init__(self, bundle, *, slots: int, capacity: int,
                 greedy: bool = True, cache_dtype=torch.float32):
        self.bundle = bundle
        self.device = bundle.device
        self.slots = slots
        self.capacity = capacity
        self.greedy = greedy
        self.params = None
        self.cache_dtype = cache_dtype
        with torch.inference_mode():
            self.cache = bundle.init_cache(slots, capacity, cache_dtype)
            self.lengths = torch.zeros((slots,), dtype=torch.long,
                                       device=self.device)
        self.active: dict[int, Request] = {}
        self.free = list(range(slots))
        # 1 where the slot decodes this step — the lengths increment is a
        # vector add with this mask, not a per-step Python comprehension
        self._active_mask = np.zeros((slots,), np.int64)
        self.queue: deque[Request] = deque()
        self.steps = 0

    def load(self, params):
        self.params = params

    def submit(self, req: Request):
        """Queue ``req``; it must fit a slot: its prompt and every token it
        generates need a cache position (the reference would drop the
        writes past the capacity and decode against a stale cache)."""
        if len(req.prompt) + req.max_new > self.capacity:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new} tokens exceed the slot capacity "
                f"{self.capacity}")
        self.queue.append(req)

    # ------------------------------------------------------------ admit
    @torch.inference_mode()
    def _admit(self):
        while self.queue and self.free:
            req = self.queue.popleft()
            slot = self.free.pop(0)
            # per-slot prefill (batch=1 path reuses the bundle prefill);
            # same dtype as the batched cache — _splice's copy must not
            # round through another dtype
            cache1 = self.bundle.init_cache(1, self.capacity,
                                            self.cache_dtype)
            tokens = torch.as_tensor(np.asarray(req.prompt)[None, :],
                                     device=self.device).long()
            logits, cache1 = self.bundle.prefill(
                self.params, {"tokens": tokens}, cache1)
            tok = int(torch.argmax(logits[0, -1]))
            req.out.append(tok)
            # splice the slot into the batch cache
            for big, one in zip(_leaves(self.cache), _leaves(cache1)):
                _splice(big, one, slot)
            self.lengths[slot] = len(req.prompt)
            self.active[slot] = req
            self._active_mask[slot] = 1

    # ------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self):
        self._admit()
        if not self.active:
            return
        toks = np.zeros((self.slots, 1), np.int64)
        for slot, req in self.active.items():
            toks[slot, 0] = req.out[-1]
        logits, self.cache = self.bundle.decode(
            self.params, torch.as_tensor(toks, device=self.device),
            self.cache, self.lengths)
        nxt = torch.argmax(logits[:, 0], dim=-1)
        self.lengths += torch.as_tensor(self._active_mask,
                                        device=self.device)
        nxt = nxt.cpu().numpy()
        for slot, req in list(self.active.items()):
            req.out.append(int(nxt[slot]))
            if len(req.out) >= req.max_new:
                req.done = True
                del self.active[slot]
                self._active_mask[slot] = 0
                self.free.append(slot)
        self.steps += 1

    def run_until_done(self, max_steps: int = 10000):
        while (self.queue or self.active) and max_steps:
            self.step()
            max_steps -= 1


def _splice(big, one, slot):
    """Copy a batch-1 cache leaf into slot ``slot`` of the batched cache,
    in place (cache leaves carry the batch on axis 1, layer-leading)."""
    big[:, slot:slot + 1] = one
    return big
