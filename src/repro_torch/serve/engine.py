"""Batched serving engine: continuous batching over prefill/decode steps
(a port of ``repro.serve.engine``).

Slots hold active sequences; each engine tick decodes one token for every
active slot, admits new requests into free slots via ``prefill``, and
retires finished sequences.  The KV cache is the operator state of the
paper's mapping — the DR scheduler (``repro_torch.serve.scheduler``)
decides which *replica* owns which session key.

The engine runs on the card unless the caller passes ``device="cpu"``;
without a card it raises.  Its parameters must lie on that device.
Greedy decoding takes the argmax over the first ``vocab_size`` logits (the
first of equal maxima), as the reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model
from repro_torch.models.modules import Policy

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # int32[prompt_len]
    max_new_tokens: int
    session_key: int = 0        # partitioning key for the DR scheduler
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Single-replica engine with a fixed slot count (= max batch)."""

    def __init__(self, cfg: ArchConfig, params, pol: Policy, *, slots: int = 4,
                 max_len: int = 256, eos_id: int | None = None, device=None):
        self.device = resolve_device(device)
        where = params["embed"]["tok"].device
        if where.type != self.device.type:
            raise ValueError(f"parameters lie on {where}, the engine runs on {self.device}")
        self.cfg, self.params, self.pol = cfg, params, pol
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.active: list[Request | None] = [None] * slots
        self._caches: list = [None] * slots
        self.steps = 0
        self.tokens_out = 0

    def _greedy(self, logits: torch.Tensor) -> int:
        return int(torch.argmax(logits[0, -1, : self.cfg.vocab_size]))

    # -- admission --------------------------------------------------------
    def admit(self, req: Request) -> bool:
        for i in range(self.slots):
            if self.active[i] is None:
                toks = torch.as_tensor(np.asarray(req.prompt)[None, :].astype(np.int64),
                                       device=self.device)
                logits, cache = model.prefill(self.params, {"tokens": toks}, self.cfg,
                                              self.pol, max_len=self.max_len)
                nxt = self._greedy(logits)
                req.out_tokens.append(nxt)
                self.active[i] = req
                self._caches[i] = (cache, nxt)
                return True
        return False

    # -- one decode tick over all active slots ---------------------------
    def tick(self) -> int:
        produced = 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            cache, last = self._caches[i]
            tok = torch.full((1, 1), last, dtype=torch.int64, device=self.device)
            logits, cache = model.decode_step(self.params, cache, tok, self.cfg, self.pol)
            nxt = self._greedy(logits)
            req.out_tokens.append(nxt)
            self._caches[i] = (cache, nxt)
            produced += 1
            self.tokens_out += 1
            if len(req.out_tokens) >= req.max_new_tokens or (
                self.eos_id is not None and nxt == self.eos_id
            ):
                req.done = True
                self.active[i] = None
                self._caches[i] = None
        self.steps += 1
        return produced

    @property
    def free_slots(self) -> int:
        return sum(1 for a in self.active if a is None)

    def run(self, requests: list[Request], max_ticks: int = 1000) -> list[Request]:
        pending = list(requests)
        for _ in range(max_ticks):
            while pending and self.free_slots:
                self.admit(pending.pop(0))
            if not pending and all(a is None for a in self.active):
                break
            self.tick()
        return requests
