"""Host-side continuous-batching scheduler — PyTorch-port copy of
``repro.serving.scheduler`` (plain Python, with the admission-time
``prefill_target`` freeze).

Pure-Python request/slot bookkeeping, no tensors, so the policy layer is
unit-testable without a model.  The runtime owns the device work; this
module decides *which* requests occupy *which* of the fixed decode slots
when.

Model: a fixed array of ``n_slots`` decode slots (the compiled decode
step's batch dimension).  Requests queue FIFO; a finishing request frees
its slot, which the next queued request takes WITHOUT stopping the
decode loop (vLLM-style continuous batching).  Newly admitted requests
are prefilled in batched groups bucketed by prompt length so
mixed-length prompts share one compiled prefill call.

Eviction (paged-KV pool pressure): the *latest-admitted* active slot is
preempted — its blocks are freed and its request goes back to the FRONT
of the queue carrying the tokens generated so far (recompute-style
preemption: re-prefill of prompt+generated).  Latest-victim + front
requeue preserves FIFO fairness: the earliest-arrived requests are never
starved by later arrivals.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["Request", "Slot", "Scheduler", "bucket_pow2"]


def bucket_pow2(plen: int, floor: int = 8) -> int:
    """Smallest power of two >= plen (>= floor) — the prefill bucket."""
    b = floor
    while b < plen:
        b *= 2
    return b


@dataclasses.dataclass
class Request:
    """One generation request plus its runtime bookkeeping."""

    rid: int
    prompt: np.ndarray                  # (plen,) int32 token ids
    max_new: int
    eos_id: Optional[int] = None
    arrival: float = 0.0
    # filled by the runtime
    generated: List[int] = dataclasses.field(default_factory=list)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    prefills: int = 0                   # >1 means it was evicted+resumed

    def prefill_tokens(self) -> np.ndarray:
        """Tokens to teacher-force at (re-)admission: the prompt plus any
        tokens already generated before an eviction.  The prefill's
        last-position logits then predict the next new token."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new:
            return True
        return bool(self.generated) and self.eos_id is not None \
            and self.generated[-1] == self.eos_id


@dataclasses.dataclass
class Slot:
    """State of one decode slot."""

    request: Optional[Request] = None
    pos: int = 0                        # tokens currently in the cache
    last_token: int = 0                 # next token to feed the decode step
    admit_seq: int = -1                 # admission order (eviction picks max)
    prefilled: int = 0                  # prefill tokens already in the cache
    #   (< prefill_target means mid-chunked-prefill: the slot is occupied
    #    but must NOT decode yet; a prefix-cache hit starts it above zero
    #    — the aliased positions never run a forward pass)
    prefill_target: int = 0             # len(prefill_tokens()) AT ADMISSION
    #   (frozen: prefill_tokens() itself grows as the slot decodes, so
    #    comparing against it live would keep the slot prefill-pending
    #    forever and push every generated token through a 1-token
    #    prefill chunk instead of the decode step)

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def prefill_done(self) -> bool:
        return self.request is not None and \
            self.prefilled >= self.prefill_target


class Scheduler:
    """FIFO continuous batching over a fixed slot array.

    ``bucket``: ``"pow2"`` groups prefills by next-power-of-two prompt
    length (attention-cache families — shorter prompts right-pad inside
    the shared compiled call); ``"exact"`` groups by exact length (state
    families — SSM/LRU states integrate every fed token, so prompts in a
    shared call must be the same length); or any ``len -> bucket``
    callable.
    """

    def __init__(self, n_slots: int,
                 bucket: Union[str, Callable[[int], int]] = "pow2"):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.slots = [Slot() for _ in range(n_slots)]
        self.queue: deque[Request] = deque()
        self._rid = itertools.count()
        self._admit_seq = itertools.count()
        self.finished: List[Request] = []
        self.evictions = 0
        if callable(bucket):
            self.bucket_fn = bucket
        elif bucket == "pow2":
            self.bucket_fn = bucket_pow2
        elif bucket == "exact":
            self.bucket_fn = lambda plen: plen
        else:
            raise ValueError(f"unknown bucket policy {bucket!r}")

    # -- submission / admission ------------------------------------------

    def submit(self, prompt: Sequence[int], max_new: int,
               eos_id: Optional[int] = None, arrival: float = 0.0,
               ) -> Request:
        req = Request(next(self._rid),
                      np.asarray(prompt, np.int32).reshape(-1),
                      int(max_new), eos_id, arrival)
        if len(req.prompt) < 1:
            raise ValueError("empty prompt")
        if req.max_new < 1:
            raise ValueError("max_new must be >= 1")
        self.queue.append(req)
        return req

    def admit(self) -> List[Tuple[int, Request]]:
        """Fill free slots from the queue head; returns the new
        (slot_index, request) pairs, still needing prefill."""
        admissions = []
        for i, slot in enumerate(self.slots):
            if not self.queue:
                break
            if slot.free:
                req = self.queue.popleft()
                req.prefills += 1
                self.slots[i] = Slot(request=req, pos=0,
                                     admit_seq=next(self._admit_seq),
                                     prefill_target=len(
                                         req.prefill_tokens()))
                admissions.append((i, req))
        self._check()
        return admissions

    def prefill_groups(self, admissions: List[Tuple[int, Request]]
                       ) -> List[Tuple[int, List[Tuple[int, Request]]]]:
        """Group admissions by prefill bucket: [(bucket_len, pairs)].
        Every pair in a group shares one compiled prefill call."""
        groups: Dict[int, List[Tuple[int, Request]]] = {}
        for slot_idx, req in admissions:
            b = self.bucket_fn(len(req.prefill_tokens()))
            groups.setdefault(b, []).append((slot_idx, req))
        return sorted(groups.items())

    # -- chunked prefill -------------------------------------------------

    def pending_prefill(self) -> List[Tuple[int, "Request"]]:
        """Occupied slots whose prefill is not complete (newly admitted,
        or mid-chunk), in slot order — each takes ONE chunk per round."""
        return [(i, s.request) for i, s in enumerate(self.slots)
                if s.request is not None and not s.prefill_done]

    def chunk_groups(self, plans: List[Tuple[int, Request, int]]
                     ) -> List[Tuple[int, List[Tuple[int, Request, int]]]]:
        """Group (slot, request, chunk_len) plans by the bucket of the
        CHUNK length: [(bucket_len, plans)] — every plan in a group
        shares one compiled call (right-aligned inside the bucket)."""
        groups: Dict[int, List[Tuple[int, Request, int]]] = {}
        for slot_idx, req, clen in plans:
            groups.setdefault(self.bucket_fn(clen), []).append(
                (slot_idx, req, clen))
        return sorted(groups.items())

    def on_chunk(self, slot_idx: int, n: int):
        """A non-final prefill chunk fed ``n`` more tokens into the
        slot's cache (no token produced; the slot stays non-decoding)."""
        slot = self.slots[slot_idx]
        assert slot.request is not None, f"slot {slot_idx} is free"
        slot.prefilled += int(n)
        assert slot.prefilled < slot.prefill_target, \
            "final chunk must go through on_prefilled"
        self._check()

    # -- decode progress -------------------------------------------------

    def on_prefilled(self, slot_idx: int, first_token: int,
                     now: float = 0.0) -> bool:
        """Record the prefill result: cache holds the prefilled tokens,
        ``first_token`` is the first new generation (not yet in cache).
        Returns True when that token already finished the request."""
        slot = self.slots[slot_idx]
        assert slot.request is not None, f"slot {slot_idx} is free"
        slot.pos = slot.prefill_target
        slot.prefilled = slot.pos
        return self._accept_token(slot_idx, first_token, now)

    def on_token(self, slot_idx: int, token: int, now: float = 0.0) -> bool:
        """One decode step produced ``token`` for this slot (the PREVIOUS
        last_token is now in the cache).  Returns True when the request
        finished (slot released)."""
        slot = self.slots[slot_idx]
        assert slot.request is not None, f"slot {slot_idx} is free"
        slot.pos += 1
        return self._accept_token(slot_idx, token, now)

    def _accept_token(self, slot_idx: int, token: int, now: float) -> bool:
        slot = self.slots[slot_idx]
        req = slot.request
        if req.first_token_at is None:
            req.first_token_at = now
        req.generated.append(int(token))
        slot.last_token = int(token)
        if req.done:
            req.finished_at = now
            self.finished.append(req)
            self.slots[slot_idx] = Slot()
            self._check()
            return True
        return False

    # -- eviction --------------------------------------------------------

    def pick_victim(self, protect: Optional[int] = None) -> Optional[int]:
        """Latest-admitted active slot (FIFO-fair preemption), optionally
        protecting one slot index; None when no evictable slot exists."""
        best, best_seq = None, -1
        for i, slot in enumerate(self.slots):
            if slot.free or i == protect:
                continue
            if slot.admit_seq > best_seq:
                best, best_seq = i, slot.admit_seq
        return best

    def evict(self, slot_idx: int) -> Request:
        """Preempt a slot: its request returns to the FRONT of the queue
        carrying its generated tokens (re-prefill resumes it)."""
        slot = self.slots[slot_idx]
        assert slot.request is not None, f"slot {slot_idx} is free"
        req = slot.request
        self.slots[slot_idx] = Slot()
        self.queue.appendleft(req)
        self.evictions += 1
        self._check()
        return req

    # -- inspection ------------------------------------------------------

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.free]

    def decode_slots(self) -> List[int]:
        """Slots eligible for a decode step: occupied AND fully prefilled
        (mid-chunk slots are excluded until their final chunk lands)."""
        return [i for i, s in enumerate(self.slots) if s.prefill_done]

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def all_done(self) -> bool:
        return not self.queue and not self.active_slots()

    def _check(self):
        """Slot-leak invariant: every slot is free xor owns exactly one
        live request, and no request is both queued and slotted."""
        owned = [s.request.rid for s in self.slots if s.request is not None]
        assert len(owned) == len(set(owned)), f"request in two slots: {owned}"
        queued = {r.rid for r in self.queue}
        assert not (queued & set(owned)), "request both queued and slotted"
        assert len(owned) + sum(s.free for s in self.slots) == \
            len(self.slots), "slot leak"
        for i, s in enumerate(self.slots):
            limit = 0 if s.free else len(s.request.prefill_tokens())
            assert 0 <= s.prefilled <= limit, \
                f"slot {i} prefilled {s.prefilled} outside [0, {limit}]"
