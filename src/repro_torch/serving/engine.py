"""Batched serving engine: continuous-batching style prefill + decode (port
of ``repro.serving.engine``).

Requests join a fixed-size slot table; each engine step decodes one token
for every active slot; finished slots (EOS or max-len) free up and are
refilled from the queue.  Prefill for a new request seeds its slot's KV
cache token by token.

The reference's scheduling is kept as it is, so that both engines emit the
same tokens; its known faults are listed in ROADMAP queue 3, not fixed
here:

* prefill runs every prompt token through ``_step_one``, which decodes
  *every* slot at that position and so overwrites the other active slots'
  cache rows there, and, for a recurrent state (Mamba, mLSTM, sLSTM),
  advances every other slot's state by this slot's prompt, so concurrent
  requests change each other's tokens;
* ``step`` decodes all slots at the first active slot's position;
* the prompt is cut to ``max_seq - max_new`` tokens.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.models.common import ArchConfig

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 32
    out: Optional[List[int]] = None
    #: set when admission rejects the request (malformed prompt) — the
    #: serving-layer 400; the engine tick keeps going for everyone else
    error: Optional[str] = None


class ServingEngine:
    """``params`` is the model, moved to ``device``: the card unless the
    CPU is asked for.  The decode state is the family's KV cache, or for
    ``ssm`` its recurrent states (``init_state``)."""

    def __init__(self, cfg: ArchConfig, params, max_batch: int = 8,
                 max_seq: int = 512, eos_id: int = 2,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        if cfg.family == "encdec":
            raise NotImplementedError(
                "enc-dec serving uses repro_torch.models.encdec.prefill / "
                "decode_step directly (prefill, then greedy decode steps)")
        mod = api.module_for(cfg)
        self.params = params.to(self.device)
        if cfg.family == "ssm":
            self.cache = mod.init_state(cfg, max_batch, device=self.device)
        else:
            self.cache = mod.init_cache(cfg, max_batch, max_seq,
                                        device=self.device)
        self._decode = api.make_decode_step(cfg)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.pos = np.zeros(max_batch, np.int32)
        self.remaining = np.zeros(max_batch, np.int32)
        self.last_token = np.zeros(max_batch, np.int32)
        self.queue: List[Request] = []

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)

    def _validate(self, req: Request) -> Optional[str]:
        """The request's rejection reason, or None when it is admissible."""
        try:
            toks = [int(t) for t in req.prompt]
        except (TypeError, ValueError):
            return "prompt is not a sequence of token ids"
        if not toks:
            return "empty prompt"
        vocab = getattr(self.cfg, "vocab", None)
        if vocab is not None and any(t < 0 or t >= vocab for t in toks):
            return f"prompt token out of vocabulary range [0, {vocab})"
        if req.max_new <= 0:
            return f"max_new must be positive, got {req.max_new}"
        if req.max_new >= self.max_seq:
            return (f"max_new={req.max_new} leaves no room for the prompt "
                    f"(max_seq={self.max_seq})")
        return None

    def _admit(self):
        for i in range(self.max_batch):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                reason = self._validate(req)
                if reason is not None:
                    # reject this request alone: a malformed prompt must not
                    # stop the tick loop (a failure inside prefill or decode
                    # still propagates; that is not a per-request problem)
                    req.error = reason
                    req.out = req.out if req.out is not None else []
                    warnings.warn(
                        f"request {req.rid} rejected: {reason}",
                        RuntimeWarning)
                    continue
                toks = req.prompt[: self.max_seq - req.max_new]
                for t, tok in enumerate(toks):
                    logits, self.cache = self._step_one(i, int(tok), t)
                self.slots[i] = req
                self.pos[i] = len(toks)
                self.last_token[i] = int(torch.argmax(logits[i]))
                self.remaining[i] = req.max_new

    def _step_one(self, slot: int, token: int, position: int):
        tok_vec = self.last_token.copy()
        tok_vec[slot] = token
        return self._decode(self.params, self.cache,
                            torch.from_numpy(tok_vec).to(self.device),
                            position)

    # -- one engine tick: decode one token for all active slots --------------
    def step(self) -> Dict[int, int]:
        self._admit()
        active = [i for i in range(self.max_batch) if self.slots[i] is not None]
        if not active:
            return {}
        pos = int(self.pos[active[0]])  # static-shape simplification: common pos
        logits, self.cache = self._decode(
            self.params, self.cache,
            torch.from_numpy(self.last_token).to(self.device), pos)
        new_tokens = torch.argmax(logits, -1).cpu().numpy()
        emitted = {}
        for i in active:
            tok = int(new_tokens[i])
            req = self.slots[i]
            req.out.append(tok)
            emitted[req.rid] = tok
            self.pos[i] += 1
            self.remaining[i] -= 1
            self.last_token[i] = tok
            if tok == self.eos_id or self.remaining[i] <= 0 or self.pos[i] >= self.max_seq - 1:
                self.slots[i] = None
        return emitted

    def run_until_drained(self, max_ticks: int = 1000) -> List[Request]:
        done: List[Request] = []
        seen = set()
        for _ in range(max_ticks):
            if not self.queue and all(s is None for s in self.slots):
                break
            # snapshot queued requests too: step() admits before decoding, so
            # a request can be admitted and finish within the same tick
            before = {s.rid: s for s in self.slots if s}
            for req in self.queue:
                before.setdefault(req.rid, req)
            self.step()
            after = {s.rid for s in self.slots if s}
            after |= {r.rid for r in self.queue}
            # requests that left the engine this tick are finished
            for req_id, req in before.items():
                if req_id not in after and req_id not in seen:
                    seen.add(req_id)
                    done.append(req)
        return done
