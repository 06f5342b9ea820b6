"""Continuous-batching serving engine over a paged or a contiguous KV cache.

Port of `accelerate_tpu/serving.py`. In the paged layout (the default) a
fixed number of request slots share one pool of fixed-size KV pages per
layer:

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

The contiguous layout (``paged=False``) gives each slot its own
``[max_length, Hkv, D]`` row per layer instead: the insert prefills straight
into the slot's row, decode and verify write each row at its own position
and attend it plainly, and admission reserves nothing. With
``use_repetition_penalty`` each slot carries a ``[V]`` presence row on the
device, seeded at insert from the whole prompt and the first token, and a
request's `repetition_penalty` applies to every token it samples.

Quantized serving (`ops/quantization.py`): ``weight_dtype="int8"`` serves
from the engine's own int8 copy of the model's linear layers, made once at
construction; ``kv_cache_dtype="int8" | "fp8_e4m3"`` stores the pages in one
byte per value with ``[num_pages, Hkv]`` f32 scales per layer, which the
decode and verify kernels read through their fused-dequant mode.

The host reads back once per chunk, not once per token: the chunk's tokens,
emission masks and the slots' new state come back in one copy. That copy,
the chunk's state uploads and the insert's pushes and first-token read are
the engine's sanctioned syncs (`analysis.allow_sync`): an armed `TraceGuard`
(``trace_guard=``) flags any other.

Telemetry is JAX's: every health counter lives in a `MetricsRegistry`
(``registry=``, shareable and exportable), under JAX's instrument names, and
`stats` is a read-only view over it; a `Tracer` (``tracer=``, the
process-wide default otherwise) records one ``serve.request`` span per
request (``submitted``, ``admitted``, ``first_token`` events, its
``finish_reason`` and ``tokens``), one ``serve.insert`` child span per
admission and one ``serve.decode_chunk`` span per chunk. The port has no
`trace_counts`: eager torch traces nothing, and the kernels' launch counters
play that part. Stale K/V of a
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

from .analysis.trace_guard import allow_sync
from .device import DeviceLike, make_generator, resolve_device
from .generation import CausalPrograms, GenerationConfig, _apply_repetition_penalty, _presence, _sample
from .ops.attention import SLOT_ATTENTION_IMPLS
from .ops.quantization import KV_CACHE_DTYPES, WEIGHT_DTYPES, kv_quant_spec, quantize_model_int8
from .paging import SCRATCH_PAGE, PagePool, chain_hashes, pages_for
from .speculative import (
    DEFAULT_DRAFT_NGRAM,
    DEFAULT_DRAFT_TOKENS,
    greedy_accept_length,
    propose_ngram_drafts,
)
from .telemetry.metrics import MetricsRegistry
from .telemetry.tracing import default_tracer

logger = logging.getLogger(__name__)


class QueueFull(RuntimeError):
    """Bounded-queue backpressure: the engine's wait queue is at `max_queue`."""


class EngineClosed(RuntimeError):
    """The engine was `close()`d (or is mid-`drain()`) and takes no new work."""


#: Every value `RequestResult.finish_reason` can take.
FINISH_REASONS = ("eos", "length", "timeout", "error", "cancelled")


@dataclass
class Request:
    """One serving request. `eos_token_id`, `max_new_tokens`, `temperature`
    and `repetition_penalty` (read by an engine built with
    ``use_repetition_penalty=True``) are per request; `do_sample`/`top_k`/
    `top_p` are engine level. `deadline_s` is a wall-clock budget from
    `submit()`, enforced at step boundaries (``finish_reason="timeout"``,
    partial tokens kept)."""

    request_id: int
    input_ids: Any  # [prompt_len] int sequence
    max_new_tokens: int = 32
    temperature: float = 1.0
    repetition_penalty: float = 1.0
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
    """Slot-based in-flight batching over a paged (or, with ``paged=False``,
    contiguous) KV cache.

    Typical driving loop::

        engine = ContinuousBatcher(model, num_slots=8, chunk_size=16)
        for r in requests:
            engine.submit(r)
        while engine.pending:
            for request_id, new_tokens in engine.step():
                stream(request_id, new_tokens)

    The engine runs on the model's device, which must be the resolved
    `device` (``cuda`` unless ``device="cpu"``). `attention_impl` defaults
    to ``"paged_kernel"`` for a paged engine and to the plain read
    (``"gather"``) for a contiguous one."""

    def __init__(
        self,
        model,
        num_slots: int = 4,
        max_length: Optional[int] = None,
        chunk_size: int = 8,
        do_sample: bool = False,
        top_k: int = 0,
        top_p: float = 1.0,
        use_repetition_penalty: bool = False,
        seed: int = 0,
        max_queue: Optional[int] = None,
        trace_guard=None,
        registry: Optional[MetricsRegistry] = None,
        tracer=None,
        paged: bool = True,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        prefix_cache: bool = True,
        speculative: bool = False,
        draft_tokens: int = DEFAULT_DRAFT_TOKENS,
        draft_ngram: int = DEFAULT_DRAFT_NGRAM,
        attention_impl: Optional[str] = None,
        weight_dtype: str = "bf16",
        kv_cache_dtype: str = "bf16",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if not getattr(model, "slot_serving", False):
            raise ValueError(
                f"{type(model).__name__} has no slot cache: this model family doesn't support "
                "slot-batched serving yet (generate() runs it)"
            )
        weight = model.get_input_embeddings().weight
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
            if use_repetition_penalty:
                raise ValueError(
                    "speculative decode does not compose with use_repetition_penalty "
                    "(the presence update is order-dependent across a verified "
                    "block); disable one of the two"
                )
        self.paged = bool(paged)
        if attention_impl is None:
            attention_impl = "paged_kernel" if self.paged else "gather"
        if attention_impl not in SLOT_ATTENTION_IMPLS:
            raise ValueError(
                f"unknown attention_impl {attention_impl!r}; expected one of {SLOT_ATTENTION_IMPLS}"
            )
        if attention_impl == "paged_kernel" and not self.paged:
            raise ValueError(
                "attention_impl='paged_kernel' requires the paged KV cache "
                "(paged=True); the contiguous layout has no page table to walk"
            )
        self.attention_impl = attention_impl
        self.use_repetition_penalty = bool(use_repetition_penalty)
        self.weight_dtype = str(weight_dtype)
        if self.weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(f"unknown weight_dtype {weight_dtype!r}; expected one of {WEIGHT_DTYPES}")
        self.kv_cache_dtype = str(kv_cache_dtype)
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                f"unknown kv_cache_dtype {kv_cache_dtype!r}; expected one of {KV_CACHE_DTYPES}"
            )
        if self.kv_cache_dtype != "bf16" and not self.paged:
            raise ValueError(
                "a quantized KV cache requires the paged layout (paged=True): "
                "the per-page-per-head scale pools have no contiguous twin"
            )
        if self.weight_dtype == "int8":
            model = quantize_model_int8(model)  # the engine's own copy; the caller's is untouched
        self.page_size = int(page_size)
        if self.paged:
            if self.page_size < 1:
                raise ValueError("page_size must be >= 1")
            self.pages_per_slot = -(-self.max_length // self.page_size)
            # Default pool: every slot at max_length, plus the scratch page.
            self.num_pages = (
                int(num_pages) if num_pages is not None else self.num_slots * self.pages_per_slot + 1
            )
        else:
            self.pages_per_slot = self.num_pages = 0
        # The prefix cache's suffix-only insert never sees the whole prompt,
        # which seeding the presence row needs: a penalty engine runs without it.
        self.use_prefix_cache = bool(prefix_cache) and self.paged and not self.use_repetition_penalty
        if prefix_cache and self.paged and self.use_repetition_penalty:
            logger.info(
                "prefix cache disabled: use_repetition_penalty needs whole-prompt "
                "presence seeding, which shared-prefix inserts cannot provide"
            )
        self.dtype = weight.dtype
        self.programs = CausalPrograms(model, attention_impl)
        self._sample_config = GenerationConfig(do_sample=do_sample, top_k=top_k, top_p=top_p)
        self._generator = make_generator(seed, self.device)
        self._pools = self._init_pools()
        self._presence = self._init_presence()

        S = self.num_slots
        # Host mirror of the per-slot state, pushed once per chunk.
        self._token = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._active = np.zeros(S, bool)
        self._rem = np.zeros(S, np.int64)
        self._eos = np.full(S, -1, np.int64)
        self._temp = np.ones(S, np.float32)
        self._pen = np.ones(S, np.float32)
        # All-zero rows point at the scratch page: a free slot's discarded
        # writes never land in a live request's pages (paged only).
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
        # An analysis.TraceGuard (assignable after construction too): the
        # fault isolation swallows per-step exceptions, so guarded syncs are
        # observe()d before they are isolated.
        self.trace_guard = trace_guard
        self._init_telemetry(registry, tracer)

    def _init_telemetry(self, registry, tracer):
        """JAX's instruments under JAX's names (`stats` reads them back), the
        page pool, whose eviction count one of them follows, and the tracer. Every
        update is host-scalar arithmetic."""
        m = self.metrics = registry if registry is not None else MetricsRegistry()
        self._m_submitted = m.counter("serving_requests_submitted_total", help="requests accepted by submit()")
        self._m_inserts = m.counter("serving_inserts_total", help="successful insert (prefill+admit) dispatches")
        self._m_chunks = m.counter("serving_chunks_total", help="decode-chunk dispatches")
        self._m_decode_steps = m.counter(
            "serving_decode_steps_total", help="decode loop iterations (chunks * chunk_size)"
        )
        self._m_finish = {
            reason: m.counter(
                "serving_requests_finished_total", help="finished requests by finish_reason",
                labels={"reason": reason},
            )
            for reason in FINISH_REASONS
        }
        self._m_queue_depth = m.gauge("serving_queue_depth", help="requests waiting for a slot")
        self._m_queue_peak = m.gauge(
            "serving_queue_peak", help="queue-depth high-water mark (sized against max_queue)"
        )
        self._m_slots_in_use = m.gauge("serving_slots_in_use", help="slots occupied by in-flight requests")
        self._m_slot_utilization = m.gauge("serving_slot_utilization", help="slots_in_use / num_slots")
        self._m_ttft = m.histogram("serving_ttft_seconds", help="submit() -> first token (host wall clock)")
        self._m_inter_token = m.histogram(
            "serving_inter_token_seconds", help="per-token gap between stream drains for an in-flight slot"
        )
        self._m_chunk_latency = m.histogram("serving_chunk_seconds", help="decode-chunk dispatch+drain wall clock")
        self._submit_times: Dict[int, float] = {}  # request_id -> submit() perf_counter
        self._slot_last_event = np.zeros(self.num_slots, np.float64)  # last drain time per slot
        self.tracer = tracer if tracer is not None else default_tracer()
        self._request_spans: Dict[int, Any] = {}
        self.pool = None
        if self.paged:
            self._m_pages_total = m.gauge(
                "serving_pages_total", help="usable KV pool pages (excludes the scratch page)"
            )
            self._m_pages_in_use = m.gauge("serving_pages_in_use", help="pool pages referenced by in-flight requests")
            self._m_prefix_hits = m.counter(
                "serving_prefix_cache_hits_total", help="prompt pages served from the shared-prefix cache"
            )
            self._m_prefix_misses = m.counter(
                "serving_prefix_cache_misses_total",
                help="full prompt pages that had to be prefilled (no cached prefix)",
            )
            self._m_prefix_evictions = m.counter(
                "serving_prefix_cache_evictions_total",
                help="unreferenced cached prefix pages reclaimed by the allocator",
            )
            self._m_prefill_saved = m.counter(
                "prefill_tokens_saved_total", help="prompt tokens whose prefill FLOPs the prefix cache skipped"
            )
            self.pool = PagePool(self.num_pages, self.page_size)
            self._evictions_counted = 0  # the pool's count the counter has caught up with
            self._m_pages_total.set(self.pool.pages_total)
        if self.speculative:
            self._m_spec_steps = m.counter(
                "serving_spec_verify_steps_total",
                help="verify-block loop iterations with an active slot (each emits >= 1 token)",
            )
            self._m_spec_drafted = m.counter(
                "serving_spec_draft_tokens_total",
                help="draft tokens proposed by the n-gram drafter (valid proposals only)",
            )
            self._m_spec_accepted = m.counter(
                "serving_spec_accepted_draft_tokens_total", help="draft tokens confirmed by verification and emitted"
            )
            self._m_spec_rejected = m.counter(
                "serving_spec_rejected_draft_tokens_total", help="draft tokens the verify step discarded"
            )
            self._m_spec_hist = m.histogram(
                "serving_spec_accepted_tokens",
                help="tokens emitted per verify step (accepted drafts + 1 bonus)",
                buckets=[float(i) for i in range(1, self.draft_tokens + 2)],
            )

    def _init_pools(self) -> List[Tuple[torch.Tensor, ...]]:
        """One zeroed (k_pool, v_pool) pair per layer, [num_pages, page_size,
        Hkv, D] in the model's dtype; for a quantized cache the pools are in
        the storage dtype and each pair is followed by its zeroed [num_pages,
        Hkv] f32 (k_scale, v_scale). Contiguous: one [num_slots, max_length,
        Hkv, D] pair per layer."""
        cfg = self.config
        if self.paged:
            shape = (self.num_pages, self.page_size, cfg.num_key_value_heads, cfg.head_dim)
        else:
            shape = (self.num_slots, self.max_length, cfg.num_key_value_heads, cfg.head_dim)
        spec = kv_quant_spec(self.kv_cache_dtype)
        dtype = self.dtype if spec is None else spec[0]
        pools = []
        for _ in range(cfg.num_hidden_layers):
            layer = tuple(torch.zeros(shape, dtype=dtype, device=self.device) for _ in range(2))
            if spec is not None:
                layer += tuple(
                    torch.zeros((self.num_pages, cfg.num_key_value_heads), device=self.device) for _ in range(2)
                )
            pools.append(layer)
        return pools

    def _init_presence(self) -> Optional[torch.Tensor]:
        """The penalty engine's [num_slots, vocab] bool seen-token rows."""
        if not self.use_repetition_penalty:
            return None
        return torch.zeros((self.num_slots, self.config.vocab_size), dtype=torch.bool, device=self.device)

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
    def kv_pool_itemsize(self) -> int:
        """Stored bytes per cached K/V value (1 for an int8 or fp8 pool)."""
        return self._pools[0][0].element_size()

    @property
    def kv_cache_nbytes(self) -> int:
        """Stored bytes of the whole slot cache: pools and scale pools, or
        the contiguous layout's rows."""
        return sum(t.numel() * t.element_size() for layer in self._pools for t in layer)

    @property
    def stats(self) -> Dict[str, Any]:
        """Health view, read from the metrics registry and rebuilt per
        access."""
        view: Dict[str, Any] = {
            "attention_impl": self.attention_impl,
            "weight_dtype": self.weight_dtype,
            "kv_cache_dtype": self.kv_cache_dtype,
            "inserts": int(self._m_inserts.value),
            "chunks": int(self._m_chunks.value),
            "decode_steps": int(self._m_decode_steps.value),
            "finish_reasons": {reason: int(counter.value) for reason, counter in self._m_finish.items()},
        }
        if self.paged:
            view["pages_total"] = self.pool.pages_total
            view["pages_in_use"] = self.pool.pages_in_use
            view["prefix_cache"] = {
                "enabled": self.use_prefix_cache,
                "hits": int(self._m_prefix_hits.value),
                "misses": int(self._m_prefix_misses.value),
                "evictions": self.pool.evictions,
                "prefill_tokens_saved": int(self._m_prefill_saved.value),
                "entries": self.pool.prefix_entries,
                "cached_pages": self.pool.pages_cached,
            }
        if self.speculative:
            steps = int(self._m_spec_steps.value)
            accepted = int(self._m_spec_accepted.value)
            view["speculative"] = {
                "draft_tokens": self.draft_tokens,
                "draft_ngram": self.draft_ngram,
                "verify_steps": steps,
                "drafted": int(self._m_spec_drafted.value),
                "accepted": accepted,
                "rejected": int(self._m_spec_rejected.value),
                # Mean tokens emitted per (verify step, active slot): 1.0 means
                # speculation never helped, draft_tokens + 1 is the ceiling.
                "accepted_tokens_per_step": (steps + accepted) / steps if steps else None,
            }
        return view

    def _update_occupancy_gauges(self):
        """Refresh the point-in-time gauges, wherever the queue or the slot
        map changes."""
        depth = len(self._queue)
        self._m_queue_depth.set(depth)
        self._m_queue_peak.set_max(depth)
        in_use = sum(r is not None for r in self._slot_request)
        self._m_slots_in_use.set(in_use)
        self._m_slot_utilization.set(in_use / self.num_slots)
        if self.paged:
            self._m_pages_in_use.set(self.pool.pages_in_use)
            # The pool counts its evictions; the counter follows it here.
            evicted = self.pool.evictions - self._evictions_counted
            if evicted:
                self._m_prefix_evictions.inc(evicted)
                self._evictions_counted = self.pool.evictions

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
        if self.paged:
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
        self._submit_times[request.request_id] = time.perf_counter()
        self._queue.append(dataclasses.replace(request, input_ids=ids))
        self._m_submitted.inc()
        span = self.tracer.start_span(
            "serve.request", category="serve",
            request_id=int(request.request_id), prompt_tokens=int(ids.size),
            max_new_tokens=int(request.max_new_tokens),
        )
        span.event("submitted", queue_depth=len(self._queue))
        self._request_spans[request.request_id] = span
        self._update_occupancy_gauges()
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
        self.tracer.event(
            "serve.blast_radius", category="serve",
            errored_requests=sum(r is not None for r in self._slot_request), error=repr(exc),
        )
        for slot, result in enumerate(self._slot_request):
            if result is not None:
                self._finish(result, "error", now=now, slot=slot, error=repr(exc))
        self._active[:] = False
        self._pools = self._init_pools()
        self._presence = self._init_presence()
        self._history[:] = 0
        if self.paged:
            self.pool.reset()
            self._m_pages_in_use.set(0)
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
        span = self._request_spans.pop(result.request_id, None)
        if span is not None:
            span.annotate(finish_reason=reason, tokens=len(result.tokens))
            if error is not None:
                span.annotate(error=error)
            span.end()
        self._m_finish[reason].inc()
        self._deadlines.pop(result.request_id, None)
        self._submit_times.pop(result.request_id, None)
        if slot is not None:
            self._slot_request[slot] = None
            self._active[slot] = False
            if self._slot_pages[slot]:
                self.pool.release(self._slot_pages[slot])
                self._slot_pages[slot] = []
            self._page_table[slot] = SCRATCH_PAGE
        self._update_occupancy_gauges()

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

    def _insert(self, slot: int, ids: np.ndarray, matched_len: int, page_row: Optional[np.ndarray],
                temperature: float, penalty: float) -> int:
        """Prefill the unmatched suffix ``ids[matched_len:]`` at its absolute
        positions and sample the first token. Paged: into the slot's pages;
        the suffix starts on a page boundary, so its writes never touch a
        shared prefix page. Contiguous: straight into the slot's rows (the
        whole prompt; there is no prefix cache). A penalty engine seeds the
        slot's presence row from the prompt (the whole prompt: its prefix
        cache is off) and the first token. The pushes of the suffix and the
        page row and the first token's read are the insert's sanctioned
        syncs (JAX's `jnp.asarray` operands and `int(token)`)."""
        dev = self.device
        p = int(ids.size)
        with allow_sync():
            suffix = torch.as_tensor(ids[matched_len:], device=dev)[None]
            row = torch.as_tensor(page_row[: pages_for(p, self.page_size)], device=dev)[None] if self.paged else None
        positions = torch.arange(matched_len, p, device=dev)[None]
        if self.paged:
            logits = self.programs.prefill(suffix, positions, self._pools, row, (matched_len, p))
        else:
            rows = [(k[slot : slot + 1, :p], v[slot : slot + 1, :p]) for k, v in self._pools]
            logits = self.programs.prefill_rows(suffix, positions, rows)
        last = logits[:, -1, :]
        if self._presence is not None:
            seen = _presence(suffix, torch.ones_like(suffix, dtype=torch.bool), self.config.vocab_size)
            last = _apply_repetition_penalty(last, seen, penalty)
        token = _sample(last, self._sample_config, self._generator, temperature)
        if self._presence is not None:
            seen[0, token[0]] = True
            self._presence[slot] = seen[0]
        with allow_sync():
            return int(token[0])

    def _reserve(self, req: Request):
        """A paged admission's pages: the prompt's prefix-cache hits, then
        private pages for the rest of its footprint. Returns (pages, matched
        pages, chain hashes), or None (nothing held) when the pool cannot
        cover the request yet."""
        ids = req.input_ids
        p = int(ids.size)
        hashes: List[str] = []
        shared: List[int] = []
        if self.use_prefix_cache:
            hashes = chain_hashes(ids, self.page_size)
            # Cap below the whole prompt: the last token always reruns so
            # the insert has first-token logits to sample.
            shared = self.pool.match_prefix(hashes, min(len(hashes), (p - 1) // self.page_size))
        matched_pages = len(shared)
        private = self.pool.reserve(self._pages_needed(p, req.max_new_tokens) - matched_pages)
        if private is None:
            if shared:
                self.pool.release(shared)
            return None
        if self.use_prefix_cache:
            self._m_prefix_hits.inc(matched_pages)
            self._m_prefix_misses.inc(max(p // self.page_size - matched_pages, 0))
            if matched_pages:
                self._m_prefill_saved.inc(matched_pages * self.page_size)
        return shared + private, matched_pages, hashes

    def _admit(self) -> List[Tuple[int, List[int]]]:
        """Fill free slots from the queue (FIFO), one insert per admission.
        When the pool (plus evictable cached prefix pages) cannot cover the
        next request it goes back to the front of the queue until in-flight
        requests release pages. A contiguous engine reserves nothing: every
        slot owns its rows."""
        events: List[Tuple[int, List[int]]] = []
        while self._queue and self.free_slots:
            req = self._queue.popleft()
            slot = self._slot_request.index(None)
            ids = req.input_ids
            p = int(ids.size)
            result = self.results[req.request_id]
            pages: List[int] = []
            matched_pages, hashes, page_row = 0, [], None
            if self.paged:
                reserved = self._reserve(req)
                if reserved is None:
                    self._queue.appendleft(req)
                    break
                pages, matched_pages, hashes = reserved
                page_row = np.zeros((self.pages_per_slot,), np.int32)
                page_row[: len(pages)] = pages
            # The port pads nothing: its insert "bucket" is the suffix itself.
            bucket = p - matched_pages * self.page_size
            rspan = self._request_spans.get(req.request_id)
            admit_t0 = time.perf_counter()
            if rspan is not None:
                submitted_at = self._submit_times.get(req.request_id)
                rspan.event(
                    "admitted", slot=slot, bucket=bucket,
                    queue_wait_s=round(admit_t0 - submitted_at, 6) if submitted_at is not None else None,
                    prefix_hit_pages=int(matched_pages), pages_reserved=len(pages),
                )
            ispan = self.tracer.start_span(
                "serve.insert", category="serve", parent=rspan,
                request_id=int(req.request_id), slot=slot, bucket=bucket,
                suffix_tokens=bucket, prefix_hit_pages=int(matched_pages),
            )
            try:
                token = self._insert(
                    slot, ids, matched_pages * self.page_size, page_row, req.temperature, req.repetition_penalty
                )
                ispan.end()
            except Exception as exc:  # noqa: BLE001 — isolate, report, keep serving
                ispan.annotate(error=repr(exc)).end()
                if pages:
                    self.pool.release(pages)
                if self.trace_guard is not None:
                    self.trace_guard.observe(exc)
                logger.warning("insert failed for request %s (isolated): %r", req.request_id, exc)
                self._finish(result, "error", error=repr(exc))
                continue
            if self.use_prefix_cache:
                # Decode writes land at pos >= prompt_len, past every full
                # prompt page, so registered content stays frozen.
                self.pool.register_prefix(hashes[: p // self.page_size], pages, start=matched_pages)
            now = time.perf_counter()
            self._m_inserts.inc()
            submitted_at = self._submit_times.get(req.request_id)
            if submitted_at is not None:
                self._m_ttft.observe(now - submitted_at)
            if rspan is not None:
                rspan.event("first_token")
            self._slot_last_event[slot] = now
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
                self._pen[slot] = req.repetition_penalty
                if self.speculative:
                    self._history[slot, :p] = ids
                    self._history[slot, p] = token
                    self._history[slot, p + 1:] = 0
                if self.paged:
                    self._slot_pages[slot] = pages
                    self._page_table[slot] = page_row
            else:
                # One-token request: its pages release at once; a prefix it
                # just registered stays cached for the next hit.
                if pages:
                    self.pool.release(pages)
                self._finish(result, "eos" if token == eos else "length", now=now)
        self._update_occupancy_gauges()
        return events

    def release(self, request_id: int) -> RequestResult:
        """Drop a finished request's result and free its id for reuse."""
        result = self.results[request_id]
        if not result.finished:
            raise ValueError(f"request {request_id} is still in flight")
        del self.results[request_id]
        return result

    # --------------------------------------------------------------- the chunks

    def _decode_chunk(self, token, pos, active, rem, eos, temp, pen, table):
        """`chunk_size` decode steps over every slot. Returns the [chunk, S]
        token and emission matrices and the slots' new state. A penalty
        engine penalises each slot's seen tokens by its request's `pen` and
        marks each active slot's new token seen."""
        toks, emits = [], []
        slots = torch.arange(self.num_slots, device=self.device)
        for _ in range(self.chunk_size):
            logits = self.programs.step(token, pos, self._pools, table)
            if self._presence is not None:
                logits = _apply_repetition_penalty(logits, self._presence, pen)
            nxt = _sample(logits, self._sample_config, self._generator, temp)
            nxt = torch.where(active, nxt, torch.zeros_like(nxt))
            if self._presence is not None:
                self._presence[slots, nxt] |= active
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
        chunk_t0 = time.perf_counter()
        # One batched span per chunk: every active request rides it, so the
        # flight recorder's ring grows with dispatches, not tokens.
        chunk_span = self.tracer.start_span(
            "serve.decode_chunk", category="serve",
            chunk_size=self.chunk_size,
            active_slots=int(self._active.sum()),
            slots=",".join(str(i) for i in np.nonzero(self._active)[0]),
            pages_in_use=self.pool.pages_in_use if self.paged else None,
        )
        pos_before = self._pos.copy()
        try:
            with torch.no_grad():
                # The step-boundary state uploads (JAX's `jnp.asarray`
                # operands): copies from pageable host memory, which
                # synchronize the stream.
                with allow_sync():
                    state = torch.as_tensor(
                        np.stack([self._token, self._pos, self._active, self._rem, self._eos]), device=dev
                    )
                    table = torch.as_tensor(self._page_table, device=dev) if self.paged else None
                    if self.speculative:
                        history = torch.as_tensor(self._history, device=dev)
                    else:
                        temps = torch.as_tensor(np.stack([self._temp, self._pen]), device=dev)
                token, pos, rem, eos = state[0], state[1], state[3], state[4]
                active = state[2].bool()
                if self.speculative:
                    toks, emit, token, pos, active, rem, n_emit, proposed = self._spec_chunk(
                        token, pos, active, rem, eos, table, history
                    )
                    extra = [n_emit.flatten(), proposed.flatten()]
                else:
                    temp, pen = temps[:, :, None]
                    toks, emit, token, pos, active, rem = self._decode_chunk(
                        token, pos, active, rem, eos, temp, pen, table
                    )
                    extra = []
                # The one readback of the chunk.
                packed = torch.cat([toks.flatten(), emit.flatten().long(), token, pos, active.long(), rem, *extra])
                with allow_sync():
                    flat = packed.cpu().numpy()
        except Exception as exc:  # noqa: BLE001 — the chunk's blast radius, keep serving
            if self.trace_guard is not None:
                self.trace_guard.observe(exc)
            in_flight = sum(r is not None for r in self._slot_request)
            logger.warning("decode chunk failed; erroring %d in-flight request(s): %r", in_flight, exc)
            chunk_span.annotate(error=repr(exc)).end()
            self._abort_in_flight(exc)
            return events
        n = toks.numel()
        toks_h, emit_h = flat[:n], flat[n : 2 * n].astype(bool)
        state_h = flat[2 * n : 2 * n + 4 * S].reshape(4, S)
        slots_h = np.broadcast_to(
            np.arange(S)[None, :, None] if self.speculative else np.arange(S)[None, :],
            toks.shape,
        ).reshape(-1)
        self._m_chunks.inc()
        self._m_decode_steps.inc(self.chunk_size)
        if self.speculative:
            cs = self.chunk_size * S
            n_emit_h = flat[2 * n + 4 * S : 2 * n + 4 * S + cs]
            proposed_total = int(flat[2 * n + 4 * S + cs :].sum())
            steps = int((n_emit_h > 0).sum())
            emitted_total = int(n_emit_h.sum())
            accepted = emitted_total - steps  # each step emits accepted + 1
            self._m_spec_steps.inc(steps)
            self._m_spec_drafted.inc(proposed_total)
            self._m_spec_accepted.inc(accepted)
            self._m_spec_rejected.inc(proposed_total - accepted)
            for v in n_emit_h[n_emit_h > 0]:
                self._m_spec_hist.observe(float(v))
            chunk_span.annotate(
                spec_verify_steps=steps,
                spec_tokens_emitted=emitted_total,
                spec_drafts_accepted=accepted,
                spec_drafts_proposed=proposed_total,
            )

        # Stream order: time-major over (step, slot[, block index]).
        per_slot: Dict[int, List[int]] = {}
        for slot, tok in zip(slots_h[emit_h], toks_h[emit_h]):
            per_slot.setdefault(int(slot), []).append(int(tok))
        now = time.perf_counter()
        # The chunk's wall clock, dispatch and readback: it covers the device
        # work, since the readback waited for it.
        self._m_chunk_latency.observe(max(now - chunk_t0, 0.0))
        chunk_span.annotate(tokens_streamed=int(emit_h.sum())).end()
        self.tracer.recorder.poll()  # serve the flight recorder's touch file
        for slot, toks_list in per_slot.items():
            result = self._slot_request[slot]
            if result is None:
                continue
            result.tokens.extend(toks_list)
            if self.speculative:
                start = int(pos_before[slot]) + 1
                self._history[slot, start : start + len(toks_list)] = toks_list
            events.append((result.request_id, toks_list))
            # Inter-token latency: the drain gap spread over the tokens it
            # delivered, one observation per token.
            last = self._slot_last_event[slot]
            if last > 0.0 and toks_list:
                gap = max(now - last, 0.0) / len(toks_list)
                for _ in toks_list:
                    self._m_inter_token.observe(gap)
            self._slot_last_event[slot] = now

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
        self._update_occupancy_gauges()
        return self.results
