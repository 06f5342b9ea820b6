"""Continuous-batching serving engine over a paged KV cache.

Port of `accelerate_tpu/serving.py` (paged layout only). A fixed number of
request slots share one pool of fixed-size KV pages per layer:

  - **admission** reserves a request's whole worst-case footprint,
    ``ceil((prompt + max_new [+ draft window]) / page_size)`` pages, minus the
    pages its prompt prefix shares with earlier requests through the
    page-granular prefix cache (`paging.PagePool`), so an admitted request
    always runs to completion;
  - **insert** prefills only the unmatched suffix of the prompt into the
    slot's own pages (a shared prefix page is never rewritten) and samples
    the first token;
  - **the decode chunk** steps every slot `chunk_size` times, with EOS,
    budget and active masking, attending through the paged-decode kernel;
  - **the speculative chunk** (``speculative=True``, greedy only) replaces
    each step by an n-gram draft plus one (draft_tokens + 1)-position verify
    through the block-verify kernel, accepting the longest greedily confirmed
    draft prefix plus one bonus token.

The host reads back once per chunk, not once per token: the chunk's tokens,
emission masks and the slots' new state come back in one copy. Stale K/V of a
slot's earlier occupant is never visible, because each query attends only
``cols <= its own position``. Failures are isolated per request: an insert
that raises errors only its request; a chunk that raises errors every
in-flight request and rebuilds the pools, and the engine keeps serving.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike, make_generator, resolve_device
from .generation import CausalPrograms, GenerationConfig, _sample
from .ops.attention import SLOT_ATTENTION_IMPLS
from .paging import SCRATCH_PAGE, PagePool, chain_hashes, pages_for
from .speculative import (
    DEFAULT_DRAFT_NGRAM,
    DEFAULT_DRAFT_TOKENS,
    greedy_accept_length,
    propose_ngram_drafts,
)

logger = logging.getLogger(__name__)


class QueueFull(RuntimeError):
    """Bounded-queue backpressure: the engine's wait queue is at `max_queue`."""


class EngineClosed(RuntimeError):
    """The engine was `close()`d (or is mid-`drain()`) and takes no new work."""


#: Every value `RequestResult.finish_reason` can take.
FINISH_REASONS = ("eos", "length", "timeout", "error", "cancelled")


@dataclass
class Request:
    """One serving request. `eos_token_id`, `max_new_tokens` and
    `temperature` are per request; `do_sample`/`top_k`/`top_p` are engine
    level. `deadline_s` is a wall-clock budget from `submit()`, enforced at
    step boundaries (``finish_reason="timeout"``, partial tokens kept)."""

    request_id: int
    input_ids: Any  # [prompt_len] int sequence
    max_new_tokens: int = 32
    temperature: float = 1.0
    eos_token_id: Optional[int] = None
    arrival_time: float = 0.0  # caller-defined clock, echoed into the result
    deadline_s: Optional[float] = None


@dataclass
class RequestResult:
    request_id: int
    tokens: List[int] = field(default_factory=list)
    arrival_time: float = 0.0
    first_token_time: Optional[float] = None  # host perf_counter at insert return
    finish_time: Optional[float] = None
    finished: bool = False
    finish_reason: Optional[str] = None  # one of FINISH_REASONS
    error: Optional[str] = None  # repr of the exception when finish_reason == "error"


class ContinuousBatcher:
    """Slot-based in-flight batching over a paged KV cache.

    Typical driving loop::

        engine = ContinuousBatcher(model, num_slots=8, chunk_size=16)
        for r in requests:
            engine.submit(r)
        while engine.pending:
            for request_id, new_tokens in engine.step():
                stream(request_id, new_tokens)

    The engine runs on the model's device, which must be the resolved
    `device` (``cuda`` unless ``device="cpu"``)."""

    def __init__(
        self,
        model,
        num_slots: int = 4,
        max_length: Optional[int] = None,
        chunk_size: int = 8,
        do_sample: bool = False,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        max_queue: Optional[int] = None,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        prefix_cache: bool = True,
        speculative: bool = False,
        draft_tokens: int = DEFAULT_DRAFT_TOKENS,
        draft_ngram: int = DEFAULT_DRAFT_NGRAM,
        attention_impl: str = "paged_kernel",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        weight = model.embed_tokens.weight
        if weight.device.type != self.device.type:
            raise ValueError(f"the model lives on {weight.device}, the engine on {self.device}")
        cfg = model.config
        self.config = cfg
        self.num_slots = int(num_slots)
        self.max_length = int(max_length or cfg.max_position_embeddings)
        self.chunk_size = int(chunk_size)
        if self.num_slots < 1 or self.chunk_size < 1:
            raise ValueError("num_slots and chunk_size must be >= 1")
        self.speculative = bool(speculative)
        self.draft_tokens = int(draft_tokens)
        self.draft_ngram = int(draft_ngram)
        if self.speculative:
            if self.draft_tokens < 1 or self.draft_ngram < 1:
                raise ValueError("speculative decode needs draft_tokens >= 1 and draft_ngram >= 1")
            if do_sample:
                raise ValueError(
                    "speculative decode is greedy-only: draft verification accepts "
                    "argmax matches, which is not distribution-preserving under sampling"
                )
        if attention_impl not in SLOT_ATTENTION_IMPLS:
            raise ValueError(
                f"unknown attention_impl {attention_impl!r}; expected one of {SLOT_ATTENTION_IMPLS}"
            )
        self.attention_impl = attention_impl
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.pages_per_slot = -(-self.max_length // self.page_size)
        # Default pool: every slot at max_length, plus the scratch page.
        self.num_pages = (
            int(num_pages) if num_pages is not None else self.num_slots * self.pages_per_slot + 1
        )
        self.use_prefix_cache = bool(prefix_cache)
        self.dtype = weight.dtype
        self.programs = CausalPrograms(model, attention_impl)
        self._sample_config = GenerationConfig(do_sample=do_sample, top_k=top_k, top_p=top_p)
        self._generator = make_generator(seed, self.device)
        self._pools = self._init_pools()
        self.pool = PagePool(self.num_pages, self.page_size)

        S = self.num_slots
        # Host mirror of the per-slot state, pushed once per chunk.
        self._token = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._active = np.zeros(S, bool)
        self._rem = np.zeros(S, np.int64)
        self._eos = np.full(S, -1, np.int64)
        self._temp = np.ones(S, np.float32)
        # All-zero rows point at the scratch page: a free slot's discarded
        # writes never land in a live request's pages.
        self._page_table = np.zeros((S, self.pages_per_slot), np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(S)]
        # Speculative engines: each slot's observed context (prompt +
        # generated), the drafter's input; the device copy is updated inside
        # the chunk and the host rebuilds the same content from the stream.
        self._history = np.zeros((S, self.max_length if self.speculative else 1), np.int64)

        self._slot_request: List[Optional[RequestResult]] = [None] * S
        self._queue: deque = deque()
        self.results: Dict[int, RequestResult] = {}
        self.max_queue = None if max_queue is None else int(max_queue)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        self._deadlines: Dict[int, float] = {}
        self._closed = False
        self._draining = False
        self._counts: Dict[str, int] = dict.fromkeys(
            (
                "inserts", "chunks", "decode_steps", "prefix_hits", "prefix_misses",
                "prefill_tokens_saved", "verify_steps", "drafted", "accepted", "rejected",
            ),
            0,
        )
        self._finish_counts: Dict[str, int] = dict.fromkeys(FINISH_REASONS, 0)

    def _init_pools(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """One zeroed (k_pool, v_pool) pair per layer, [num_pages, page_size,
        Hkv, D] in the model's dtype."""
        cfg = self.config
        shape = (self.num_pages, self.page_size, cfg.num_key_value_heads, cfg.head_dim)
        return [
            (
                torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device),
            )
            for _ in range(cfg.num_hidden_layers)
        ]

    # ---------------------------------------------------------------- host plane

    @property
    def pending(self) -> bool:
        """Anything queued or in flight."""
        return bool(self._queue) or any(r is not None for r in self._slot_request)

    @property
    def free_slots(self) -> int:
        return sum(r is None for r in self._slot_request)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def stats(self) -> Dict[str, Any]:
        c = self._counts
        view: Dict[str, Any] = {
            "attention_impl": self.attention_impl,
            "inserts": c["inserts"],
            "chunks": c["chunks"],
            "decode_steps": c["decode_steps"],
            "finish_reasons": dict(self._finish_counts),
            "pages_total": self.pool.pages_total,
            "pages_in_use": self.pool.pages_in_use,
            "prefix_cache": {
                "enabled": self.use_prefix_cache,
                "hits": c["prefix_hits"],
                "misses": c["prefix_misses"],
                "evictions": self.pool.evictions,
                "prefill_tokens_saved": c["prefill_tokens_saved"],
                "entries": self.pool.prefix_entries,
                "cached_pages": self.pool.pages_cached,
            },
        }
        if self.speculative:
            steps = c["verify_steps"]
            view["speculative"] = {
                "draft_tokens": self.draft_tokens,
                "draft_ngram": self.draft_ngram,
                "verify_steps": steps,
                "drafted": c["drafted"],
                "accepted": c["accepted"],
                "rejected": c["rejected"],
                # Mean tokens emitted per (verify step, active slot): 1.0 means
                # speculation never helped, draft_tokens + 1 is the ceiling.
                "accepted_tokens_per_step": (steps + c["accepted"]) / steps if steps else None,
            }
        return view

    def submit(self, request: Request) -> int:
        """Validate and enqueue. Raises `ValueError` for a malformed request,
        `QueueFull` for backpressure and `EngineClosed` after `close()` or
        during `drain()`."""
        if self._closed:
            raise EngineClosed("engine is closed")
        if self._draining:
            raise EngineClosed("engine is draining; resubmit after drain() returns")
        ids = np.asarray(request.input_ids, np.int64).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if ids.size + request.max_new_tokens > self.max_length:
            raise ValueError(
                f"prompt ({ids.size}) + max_new_tokens ({request.max_new_tokens}) "
                f"exceeds the {self.max_length}-token slot capacity"
            )
        if ids.min() < 0 or ids.max() >= self.config.vocab_size:
            raise ValueError(f"prompt token ids must lie in [0, {self.config.vocab_size})")
        need = self._pages_needed(int(ids.size), request.max_new_tokens)
        if need > self.pool.pages_total:
            raise ValueError(
                f"request needs {need} KV pages at page_size {self.page_size} but the "
                f"pool holds {self.pool.pages_total}"
            )
        if request.request_id in self.results:
            raise ValueError(f"duplicate request_id {request.request_id}")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise QueueFull(f"wait queue is at max_queue={self.max_queue}; shed load or retry later")
        self.results[request.request_id] = RequestResult(
            request.request_id, arrival_time=request.arrival_time
        )
        if request.deadline_s is not None:
            self._deadlines[request.request_id] = time.perf_counter() + float(request.deadline_s)
        self._queue.append(dataclasses.replace(request, input_ids=ids))
        return request.request_id

    def _pages_needed(self, prompt_tokens: int, max_new: int) -> int:
        """A request's page reservation: its worst-case token footprint plus,
        for speculative engines, the draft window whose rejected verify
        writes land through the slot's own page table."""
        window = self.draft_tokens if self.speculative else 0
        return min(pages_for(prompt_tokens + max_new + window, self.page_size), self.pages_per_slot)

    # ------------------------------------------------------------- fault isolation
    def _abort_in_flight(self, exc: Exception):
        """A failed chunk takes the shared pools with it: every in-flight
        request errors (partial tokens kept), the pools are rebuilt from
        zeros, and every page and prefix registration is dropped."""
        now = time.perf_counter()
        for slot, result in enumerate(self._slot_request):
            if result is not None:
                self._finish(result, "error", now=now, slot=slot, error=repr(exc))
        self._active[:] = False
        self._pools = self._init_pools()
        self._history[:] = 0
        self.pool.reset()
        self._page_table[:] = SCRATCH_PAGE
        self._slot_pages = [[] for _ in range(self.num_slots)]

    def _slot_of(self, request_id: int) -> Optional[int]:
        for slot, result in enumerate(self._slot_request):
            if result is not None and result.request_id == request_id:
                return slot
        return None

    def _finish(self, result: RequestResult, reason: str, now: Optional[float] = None,
                slot: Optional[int] = None, error: Optional[str] = None):
        """The single exit path of a request: stamp the result, drop its
        deadline, and free its slot and page references."""
        result.finished = True
        result.finish_time = time.perf_counter() if now is None else now
        result.finish_reason = reason
        if error is not None:
            result.error = error
        self._finish_counts[reason] += 1
        self._deadlines.pop(result.request_id, None)
        if slot is not None:
            self._slot_request[slot] = None
            self._active[slot] = False
            if self._slot_pages[slot]:
                self.pool.release(self._slot_pages[slot])
                self._slot_pages[slot] = []
            self._page_table[slot] = SCRATCH_PAGE

    def _drop_queued(self, request_id: int) -> bool:
        before = len(self._queue)
        self._queue = deque(r for r in self._queue if r.request_id != request_id)
        return len(self._queue) != before

    def _expire_deadlines(self):
        if not self._deadlines:
            return
        now = time.perf_counter()
        for request_id in [rid for rid, t in self._deadlines.items() if now >= t]:
            result = self.results[request_id]
            self._drop_queued(request_id)
            self._finish(result, "timeout", now=now, slot=self._slot_of(request_id))

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued or in-flight request (partial tokens kept). Returns
        False if it already finished; raises KeyError for an unknown id."""
        result = self.results[request_id]
        if result.finished:
            return False
        self._drop_queued(request_id)
        self._finish(result, "cancelled", slot=self._slot_of(request_id))
        return True

    def _insert(self, ids: np.ndarray, matched_len: int, page_row: np.ndarray, temperature: float) -> int:
        """Prefill the unmatched suffix ``ids[matched_len:]`` at its absolute
        positions into the slot's pages and sample the first token. The
        suffix starts on a page boundary, so its writes never touch a shared
        prefix page."""
        dev = self.device
        p = int(ids.size)
        suffix = torch.as_tensor(ids[matched_len:], device=dev)[None]
        positions = torch.arange(matched_len, p, device=dev)[None]
        row = torch.as_tensor(page_row[: pages_for(p, self.page_size)], device=dev)[None]
        logits = self.programs.prefill(suffix, positions, self._pools, row)
        token = _sample(logits[:, -1, :], self._sample_config, self._generator, temperature)
        return int(token[0])

    def _admit(self) -> List[Tuple[int, List[int]]]:
        """Fill free slots from the queue (FIFO), one insert per admission.
        When the pool (plus evictable cached prefix pages) cannot cover the
        next request it goes back to the front of the queue until in-flight
        requests release pages."""
        events: List[Tuple[int, List[int]]] = []
        while self._queue and self.free_slots:
            req = self._queue.popleft()
            slot = self._slot_request.index(None)
            ids = req.input_ids
            p = int(ids.size)
            result = self.results[req.request_id]
            total_pages = self._pages_needed(p, req.max_new_tokens)
            hashes: List[str] = []
            shared: List[int] = []
            if self.use_prefix_cache:
                hashes = chain_hashes(ids, self.page_size)
                # Cap below the whole prompt: the last token always reruns so
                # the insert has first-token logits to sample.
                shared = self.pool.match_prefix(hashes, min(len(hashes), (p - 1) // self.page_size))
            matched_pages = len(shared)
            matched_len = matched_pages * self.page_size
            private = self.pool.reserve(total_pages - matched_pages)
            if private is None:
                if shared:
                    self.pool.release(shared)
                self._queue.appendleft(req)
                break
            pages = shared + private
            if self.use_prefix_cache:
                self._counts["prefix_hits"] += matched_pages
                self._counts["prefix_misses"] += max(p // self.page_size - matched_pages, 0)
                self._counts["prefill_tokens_saved"] += matched_len
            page_row = np.zeros((self.pages_per_slot,), np.int32)
            page_row[: len(pages)] = pages
            try:
                token = self._insert(ids, matched_len, page_row, req.temperature)
            except Exception as exc:  # noqa: BLE001 — isolate, report, keep serving
                self.pool.release(pages)
                logger.warning("insert failed for request %s (isolated): %r", req.request_id, exc)
                self._finish(result, "error", error=repr(exc))
                continue
            if self.use_prefix_cache:
                # Decode writes land at pos >= prompt_len, past every full
                # prompt page, so registered content stays frozen.
                self.pool.register_prefix(hashes[: p // self.page_size], pages, start=matched_pages)
            now = time.perf_counter()
            self._counts["inserts"] += 1
            result.tokens.append(token)
            result.first_token_time = now
            events.append((req.request_id, [token]))

            eos = -1 if req.eos_token_id is None else int(req.eos_token_id)
            rem = req.max_new_tokens - 1
            if rem > 0 and token != eos:
                self._slot_request[slot] = result
                self._token[slot] = token
                self._pos[slot] = p  # the first generated token's write position
                self._active[slot] = True
                self._rem[slot] = rem
                self._eos[slot] = eos
                self._temp[slot] = req.temperature
                if self.speculative:
                    self._history[slot, :p] = ids
                    self._history[slot, p] = token
                    self._history[slot, p + 1:] = 0
                self._slot_pages[slot] = pages
                self._page_table[slot] = page_row
            else:
                # One-token request: its pages release at once; a prefix it
                # just registered stays cached for the next hit.
                self.pool.release(pages)
                self._finish(result, "eos" if token == eos else "length", now=now)
        return events

    def release(self, request_id: int) -> RequestResult:
        """Drop a finished request's result and free its id for reuse."""
        result = self.results[request_id]
        if not result.finished:
            raise ValueError(f"request {request_id} is still in flight")
        del self.results[request_id]
        return result

    # --------------------------------------------------------------- the chunks

    def _decode_chunk(self, token, pos, active, rem, eos, temp, table):
        """`chunk_size` decode steps over every slot. Returns the [chunk, S]
        token and emission matrices and the slots' new state."""
        toks, emits = [], []
        for _ in range(self.chunk_size):
            logits = self.programs.step(token, pos, self._pools, table)
            nxt = _sample(logits, self._sample_config, self._generator, temp)
            nxt = torch.where(active, nxt, torch.zeros_like(nxt))
            toks.append(nxt)
            emits.append(active)
            new_rem = torch.where(active, rem - 1, rem)
            hit_eos = (eos >= 0) & (nxt == eos)
            pos = torch.where(active, pos + 1, pos)
            active = active & ~hit_eos & (new_rem > 0)
            token, rem = nxt, new_rem
        return torch.stack(toks), torch.stack(emits), token, pos, active, rem

    def _spec_chunk(self, token, pos, active, rem, eos, table, history):
        """`chunk_size` draft-then-verify steps over every slot. Rejected
        draft K/V needs no rollback: the slot's position does not advance past
        the accepted prefix, the ``cols <= pos`` mask hides the stale rows and
        the next block overwrites them. An EOS inside the block ends the
        request there (the EOS is kept, the tail discarded)."""
        k = self.draft_tokens
        H = self.max_length
        js = torch.arange(k + 1, device=self.device)
        out_toks, out_emit, n_emits, proposed = [], [], [], []
        for _ in range(self.chunk_size):
            drafts, valid_len = propose_ngram_drafts(history, pos + 1, k, self.draft_ngram)
            block = torch.cat([token[:, None], drafts], dim=1)  # [S, k+1]
            logits = self.programs.verify(block, pos[:, None] + js[None, :], self._pools, table)
            greedy = torch.argmax(logits, dim=-1)  # [S, k+1]
            accept = greedy_accept_length(drafts, greedy[:, :k], valid_len)
            accept = torch.minimum(accept.clamp(min=0), rem - 1)  # emit at most rem tokens
            emit = active[:, None] & (js[None, :] <= accept[:, None])
            eos_hit = emit & (eos[:, None] >= 0) & (greedy == eos[:, None])
            first_eos = torch.where(eos_hit, js[None, :], torch.full_like(greedy, k + 1)).amin(dim=1)
            emit &= js[None, :] <= first_eos[:, None]
            n_emit = emit.sum(dim=1)
            last = torch.gather(greedy, 1, (n_emit - 1).clamp(0, k)[:, None])[:, 0]
            # Append the emitted tokens to the history: emitted j lands at
            # history[pos + 1 + j]; masked positions write back their own value.
            idx = (pos[:, None] + 1 + js[None, :]).clamp(0, H - 1)
            history = history.scatter(1, idx, torch.where(emit, greedy, torch.gather(history, 1, idx)))
            out_toks.append(torch.where(emit, greedy, torch.full_like(greedy, -1)))
            out_emit.append(emit)
            n_emits.append(n_emit)
            proposed.append(torch.where(active, valid_len, torch.zeros_like(valid_len)))
            token = torch.where(active, last, token)
            pos = pos + n_emit
            rem = rem - n_emit
            active = active & ~(first_eos <= accept) & (rem > 0)
        return (
            torch.stack(out_toks), torch.stack(out_emit), token, pos, active, rem,
            torch.stack(n_emits), torch.stack(proposed),
        )

    def step(self) -> List[Tuple[int, List[int]]]:
        """One serving cycle: expire deadlines, admit, run one chunk, drain it.
        Returns ``(request_id, new_tokens)`` events in stream order
        (admissions' first tokens included)."""
        if self._closed:
            return []
        self._expire_deadlines()
        events = self._admit()
        if not self._active.any():
            return events
        S, dev = self.num_slots, self.device
        pos_before = self._pos.copy()
        try:
            with torch.no_grad():
                state = torch.as_tensor(
                    np.stack([self._token, self._pos, self._active, self._rem, self._eos]), device=dev
                )
                token, pos, rem, eos = state[0], state[1], state[3], state[4]
                active = state[2].bool()
                table = torch.as_tensor(self._page_table, device=dev)
                if self.speculative:
                    history = torch.as_tensor(self._history, device=dev)
                    toks, emit, token, pos, active, rem, n_emit, proposed = self._spec_chunk(
                        token, pos, active, rem, eos, table, history
                    )
                    extra = [n_emit.flatten(), proposed.flatten()]
                else:
                    temp = torch.as_tensor(self._temp, device=dev)[:, None]
                    toks, emit, token, pos, active, rem = self._decode_chunk(
                        token, pos, active, rem, eos, temp, table
                    )
                    extra = []
                # The one readback of the chunk.
                flat = torch.cat(
                    [toks.flatten(), emit.flatten().long(), token, pos, active.long(), rem, *extra]
                ).cpu().numpy()
        except Exception as exc:  # noqa: BLE001 — the chunk's blast radius, keep serving
            in_flight = sum(r is not None for r in self._slot_request)
            logger.warning("decode chunk failed; erroring %d in-flight request(s): %r", in_flight, exc)
            self._abort_in_flight(exc)
            return events
        n = toks.numel()
        toks_h, emit_h = flat[:n], flat[n : 2 * n].astype(bool)
        state_h = flat[2 * n : 2 * n + 4 * S].reshape(4, S)
        slots_h = np.broadcast_to(
            np.arange(S)[None, :, None] if self.speculative else np.arange(S)[None, :],
            toks.shape,
        ).reshape(-1)
        self._counts["chunks"] += 1
        self._counts["decode_steps"] += self.chunk_size
        if self.speculative:
            cs = self.chunk_size * S
            n_emit_h = flat[2 * n + 4 * S : 2 * n + 4 * S + cs]
            proposed_total = int(flat[2 * n + 4 * S + cs :].sum())
            steps = int((n_emit_h > 0).sum())
            accepted = int(n_emit_h.sum()) - steps  # each step emits accepted + 1
            self._counts["verify_steps"] += steps
            self._counts["drafted"] += proposed_total
            self._counts["accepted"] += accepted
            self._counts["rejected"] += proposed_total - accepted

        # Stream order: time-major over (step, slot[, block index]).
        per_slot: Dict[int, List[int]] = {}
        for slot, tok in zip(slots_h[emit_h], toks_h[emit_h]):
            per_slot.setdefault(int(slot), []).append(int(tok))
        now = time.perf_counter()
        for slot, toks_list in per_slot.items():
            result = self._slot_request[slot]
            if result is None:
                continue
            result.tokens.extend(toks_list)
            if self.speculative:
                start = int(pos_before[slot]) + 1
                self._history[slot, start : start + len(toks_list)] = toks_list
            events.append((result.request_id, toks_list))

        was_active = self._active
        self._token, self._pos, self._rem = state_h[0].copy(), state_h[1].copy(), state_h[3].copy()
        self._active = state_h[2].astype(bool)
        for slot in np.nonzero(was_active & ~self._active)[0]:
            result = self._slot_request[slot]
            if result is not None:
                reason = "eos" if result.tokens and result.tokens[-1] == self._eos[slot] else "length"
                self._finish(result, reason, now=now, slot=slot)
        return events

    def run(self, requests: Optional[List[Request]] = None) -> Dict[int, np.ndarray]:
        """Submit `requests` (if given), step until everything drains, return
        {request_id: generated tokens}."""
        for req in requests or ():
            self.submit(req)
        while self.pending:
            self.step()
        return {rid: np.asarray(r.tokens, np.int64) for rid, r in self.results.items()}

    # ------------------------------------------------------------------ lifecycle
    def drain(self) -> Dict[int, RequestResult]:
        """Refuse new submissions while finishing everything queued and in
        flight, then reopen."""
        self._draining = True
        try:
            while self.pending:
                self.step()
        finally:
            self._draining = False
        return self.results

    def close(self) -> Dict[int, RequestResult]:
        """Terminal shutdown: everything queued or in flight finishes
        ``cancelled`` (partial tokens kept); `submit` then raises and `step`
        does nothing. Idempotent."""
        if self._closed:
            return self.results
        now = time.perf_counter()
        self._queue.clear()
        for slot, result in enumerate(self._slot_request):
            if result is not None:
                self._finish(result, "cancelled", now=now, slot=slot)
        for result in self.results.values():
            if not result.finished:
                self._finish(result, "cancelled", now=now)
        self._active[:] = False
        self._closed = True
        return self.results
