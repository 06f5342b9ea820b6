"""KV-cached autoregressive generation: `generate`, the static `Generator`,
sampling, and the prefill / step / verify programs of causal-LM serving.

Port of `accelerate_tpu/generation.py` (causal LMs, and `Seq2SeqGenerator`
for the encoder-decoder T5; quantized bundles wait). The JAX package
compiles one prefill and one fused
decode loop (`lax.while_loop`); PyTorch runs eagerly, so here the loop is a
Python loop over device tensors that reads the device back only where it
must: the plain loop once every `FINISHED_CHECK_EVERY` steps (to stop when
every row has finished), the speculative loop once per verify dispatch (the
accepted length). The cache is the model's decode cache
(`ops.attention.DecodeCache`) with static capacity `max_length`. A
mixture-of-experts model (Mixtral) routes the tokens of each forward with
that forward's capacity, as JAX's programs do: the prefill's B x S tokens
(a left-padded prompt's pads among them), a step's B, a verify block's
B x (draft_tokens + 1).

The serving engine's programs are the plain methods of `CausalPrograms`:
a program is a forward call with the KV pools and a page table.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .device import DeviceLike, make_generator, resolve_device
from .paging import SCRATCH_PAGE
from .speculative import greedy_accept_length, propose_ngram_drafts
from .utils.operations import gather_pages, scatter_pages, zero_cache_tail

#: The plain decode loop reads "has every row finished?" back from the device
#: once every this many steps, not once per token. The steps it runs past the
#: last EOS emit pads, which `_trim_at_eos` cuts, so the tokens are the same.
FINISHED_CHECK_EVERY = 8


@dataclass
class GenerationConfig:
    """JAX's field set and defaults. The serving engine reads only the three
    sampling fields (`do_sample`, `top_k`, `top_p`); temperature, EOS, the
    penalty and the token budget are per request there (`serving.Request`)."""

    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0  # 0 = full vocab
    top_p: float = 1.0  # nucleus sampling; 1.0 = disabled (applied after top_k, HF order)
    repetition_penalty: float = 1.0  # HF CTRL-style: seen tokens' logits /p (if >0) else *p
    eos_token_id: Optional[int] = None
    pad_token_id: Optional[int] = None  # fill for finished rows; defaults to eos
    # Self-speculative decode: > 0 turns each loop iteration into an n-gram
    # draft plus one (draft_tokens + 1)-position verify dispatch; greedy only.
    draft_tokens: int = 0
    draft_ngram: int = 2


def _sample(logits, config: GenerationConfig, generator: Optional[torch.Generator], temperature):
    """[B, V] logits -> [B] int64 token ids.

    Greedy is `argmax`, whose first index wins ties (as `jnp.argmax`). With
    ``do_sample`` the logits are divided by `temperature` (a float or a [B, 1]
    tensor), cut to the top-k, then to the smallest descending-probability
    prefix whose exclusive cumulative mass stays under top_p (the top token
    always survives), and a token is drawn with the explicit `generator`."""
    if not config.do_sample:
        return torch.argmax(logits, dim=-1)
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.clamp(min=1e-6)
    else:
        temperature = max(float(temperature), 1e-6)
    logits = logits.float() / temperature
    if config.top_k:
        kth = torch.topk(logits, config.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30), logits)
    if config.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < config.top_p
        keep[..., 0] = True
        kth = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, float("inf")))
        kth = kth.amin(dim=-1, keepdim=True)
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _apply_repetition_penalty(logits, presence, penalty):
    """HF RepetitionPenaltyLogitsProcessor (CTRL) semantics: every token marked
    in `presence` [B, V] gets its logit divided by the penalty when positive,
    multiplied when negative. `penalty` is a float or a [B, 1] tensor; the
    result is f32."""
    scores = logits.float()
    if not isinstance(penalty, torch.Tensor):
        penalty = torch.tensor(penalty, dtype=torch.float32, device=scores.device)
    penalized = torch.where(scores > 0, scores / penalty, scores * penalty)
    return torch.where(presence, penalized, scores)


def _trim_at_eos(generated, eos_token_id, max_new: int):
    """Cut a fixed [B, max_new] token buffer after the step where every row
    had emitted EOS (HF generate's output contract)."""
    if eos_token_id is None:
        return generated
    toks = np.asarray(generated)
    all_finished = ((toks == eos_token_id).cumsum(axis=1) > 0).all(axis=0)
    idx = np.argmax(all_finished) if all_finished.any() else max_new - 1
    return generated[:, : idx + 1]


def _bucket_for(max_new: int) -> int:
    return 1 << (max_new - 1).bit_length()  # next power of two >= max_new


class CausalPrograms:
    """The three programs the serving engine runs over a causal LM and its
    paged KV pools (one (k_pool, v_pool) pair per layer).

    `prefill` is the cached prefill (JAX's `make_cached_prefill_program`
    driven by the paged insert): it runs a prompt, or the unmatched suffix
    after shared-prefix pages, through a dense view of one slot's pages and
    writes the pages back; its attention is the plain one, as the JAX
    package's prefill takes its XLA branch. `step` advances every slot one
    token and `verify` scores a [B, s] token block; both attend through
    `attention_impl`."""

    def __init__(self, model, attention_impl: str):
        self.model = model
        self.attention_impl = attention_impl

    @torch.no_grad()
    def prefill(self, input_ids, positions, kv_pools, page_row, span):
        """[1, S] ids at [1, S] consecutive absolute positions through
        `page_row` ([1, pages] int32, covering every position) -> [1, S, V]
        logits. `span` is ``(first position, last position + 1)`` as host
        ints, as JAX's insert takes the matched length and the length as
        operands: reading them back from `positions` would sync the host.

        As JAX's paged insert: the row's pages are gathered into a dense
        view (dequantized for a quantized pool), the tokens' K/V are written
        into that view at full precision and attended there, the rows past
        the last token are zeroed, and the view's pages are written back
        (quantized whole, at their own amax, for a quantized pool). The
        pages before the first position's page hold a shared prefix and are
        never rewritten: their entries are pointed at the scratch page. So a
        prompt never attends its own quantized K/V."""
        row = page_row.reshape(-1)
        page_size = kv_pools[0][0].shape[1]
        start, end = span
        dense = gather_pages(kv_pools, row, self.model.get_input_embeddings().weight.dtype)
        logits = self.model(input_ids, positions=positions, kv_cache=dense)
        zero_cache_tail(dense, end)
        write_row = row.clone()
        write_row[: start // page_size] = SCRATCH_PAGE
        scatter_pages(kv_pools, dense, write_row)
        return logits

    @torch.no_grad()
    def prefill_rows(self, input_ids, positions, rows):
        """The contiguous engine's insert: [1, S] ids at [1, S] positions
        written straight into the slot's own rows (`rows`, one ([1, L, Hkv,
        D], ...) view pair per layer) and attended there -> [1, S, V]
        logits. JAX prefills a batch-1 cache and scatters it into the slot
        row (`tree_scatter_rows`); writing through the row's view is the
        same write without the copy."""
        return self.model(input_ids, positions=positions, kv_cache=rows)

    @torch.no_grad()
    def step(self, token, position, kv_pools, page_table):
        """[B] tokens at [B] positions -> [B, V] logits (``page_table=None``
        for the contiguous layout)."""
        logits = self.model(
            token[:, None], positions=position[:, None], kv_pools=kv_pools, page_table=page_table,
            attention_impl=self.attention_impl,
        )
        return logits[:, -1, :]

    @torch.no_grad()
    def verify(self, tokens, positions, kv_pools, page_table):
        """[B, s] token block at [B, s] positions -> [B, s, V] logits; position
        j's logits see exactly the block prefix <= j."""
        return self.model(
            tokens, positions=positions, kv_pools=kv_pools, page_table=page_table,
            attention_impl=self.attention_impl,
        )


def _presence(ids, real, vocab: int):
    """[B, V] bool: token t of row b is marked where it stands at a real
    (unpadded) position of `ids` ([B, S]). Pad positions scatter into a
    spare column that is dropped, so a pad id is never marked as seen."""
    b = ids.shape[0]
    marked = torch.zeros((b, vocab + 1), dtype=torch.bool, device=ids.device)
    marked.scatter_(1, torch.where(real, ids, torch.full_like(ids, vocab)), True)
    return marked[:, :vocab]


def _pad_id(config: GenerationConfig) -> int:
    eos = config.eos_token_id
    return config.pad_token_id if config.pad_token_id is not None else (eos if eos is not None else 0)


class Generator:
    """Prefill plus a decode loop over the model's decode cache, for a causal
    LM (`LlamaForCausalLM`). Reusable across prompts and budgets; the cache
    holds `max_length` positions (the model's `max_position_embeddings` by
    default).

    The model must live on `device` (``cuda`` unless ``device="cpu"``)."""

    def __init__(self, model, max_new_tokens: int = 32, max_length: Optional[int] = None,
                 device: DeviceLike = None):
        if not hasattr(model, "config") or not hasattr(model, "make_decode_cache"):
            raise ValueError("generate() needs a model built from an in-tree module")
        self.device = resolve_device(device)
        weight = model.get_input_embeddings().weight
        if weight.device.type != self.device.type:
            raise ValueError(f"the model lives on {weight.device}, the generator on {self.device}")
        self.base_config = model.config
        self._model = model
        self.max_new_tokens = max_new_tokens
        self.max_length = max_length or self.base_config.max_position_embeddings

    @property
    def model(self):
        """The model; a Generator held by `generate`'s cache refers to it
        weakly, so the cache never keeps a model alive."""
        model = self._model() if isinstance(self._model, weakref.ref) else self._model
        if model is None:
            raise RuntimeError("this Generator's model has been collected")
        return model

    def _forward(self, cache, tokens, positions, attention_mask=None):
        return self.model(tokens, attention_mask, positions, decode_cache=cache)

    def _decode(self, cache, first_logits, next_positions, limit: int, config: GenerationConfig,
                rng, presence, forward=None):
        """The plain loop (JAX's `_decode_fn`): sample, mark the token seen
        under a repetition penalty, emit pads on rows past their EOS. Returns
        the [B, bucket] token buffer. Reads the device back at most once
        every `FINISHED_CHECK_EVERY` steps, and never without an EOS.
        `forward(cache, tokens, positions)` is a step's forward
        (`self._forward` unless given)."""
        forward = forward or self._forward
        b = first_logits.shape[0]
        eos, pad_id = config.eos_token_id, _pad_id(config)
        rows = torch.arange(b, device=first_logits.device)
        penalty = config.repetition_penalty

        def pick(logits):
            if presence is not None:
                logits = _apply_repetition_penalty(logits, presence, penalty)
            token = _sample(logits, config, rng, config.temperature)
            if presence is not None:
                presence[rows, token] = True
            return token

        token = pick(first_logits)
        tokens = torch.full((b, _bucket_for(limit)), pad_id, dtype=torch.long, device=token.device)
        tokens[:, 0] = token
        finished = torch.zeros((b,), dtype=torch.bool, device=token.device)
        for i in range(1, limit):
            if eos is not None:
                finished |= token == eos
                if i % FINISHED_CHECK_EVERY == 0 and bool(finished.all()):  # the loop's one read
                    break
            logits = forward(cache, token[:, None], (next_positions + i - 1)[:, None])[:, -1]
            token = pick(logits)
            if eos is not None:
                token = torch.where(finished, torch.full_like(token, pad_id), token)
            tokens[:, i] = token
        return tokens

    def _speculative_decode(self, cache, first_logits, next_positions, limit: int,
                            config: GenerationConfig, history, hist_base: int):
        """The draft-then-verify loop (JAX's `_speculative_decode_fn`): each
        iteration drafts `draft_tokens` continuations per row from the n-gram
        drafter over `history` ([B, max_length + k], the prompt buffer in
        physical order, then the generated tokens), scores the pending token
        and the drafts in one (k + 1)-position verify forward, and emits the
        longest greedily confirmed draft prefix plus one bonus token. Rows
        advance in lockstep (the cache index is shared): the accepted length
        is the minimum over unfinished rows, and the index is rewound past
        the k - a_min rejected rows. Reads the device back once per verify
        dispatch: the accepted length and whether every row has finished,
        which also keeps the cache index on the host."""
        eos, pad_id = config.eos_token_id, _pad_id(config)
        k, m = config.draft_tokens, config.draft_ngram
        b, dev = first_logits.shape[0], first_logits.device
        token = torch.argmax(first_logits, dim=-1)
        tokens = torch.full((b, _bucket_for(limit)), pad_id, dtype=torch.long, device=dev)
        tokens[:, 0] = token
        history[:, hist_base] = token
        finished = (token == eos) if eos is not None else torch.zeros((b,), dtype=torch.bool, device=dev)
        js = torch.arange(k + 1, device=dev)
        i = 1
        while i < limit:
            hist_len = hist_base + i
            drafts, valid_len = propose_ngram_drafts(history, hist_len, k, m)
            block = torch.cat([token[:, None], drafts], dim=1)
            positions = (next_positions + i - 1)[:, None] + js[None, :]
            greedy = torch.argmax(self._forward(cache, block, positions), dim=-1)  # [B, k+1]
            accept = greedy_accept_length(drafts, greedy[:, :k], valid_len)
            if eos is not None:
                # Finished rows emit pads whatever they accept: they must not
                # drag the lockstep minimum below the live rows'.
                accept = torch.where(finished, torch.full_like(accept, k), accept)
            a_min_dev = accept.amin().clamp(max=limit - i - 1)
            emit = js <= a_min_dev
            if eos is not None:
                cols, fin = [], finished
                for j in range(k + 1):
                    e = torch.where(fin, torch.full_like(greedy[:, j], pad_id), greedy[:, j])
                    cols.append(e)
                    fin = fin | ((e == eos) & emit[j])
                emitted, finished = torch.stack(cols, dim=1), fin
                a_min, all_finished = torch.stack([a_min_dev, finished.all().long()]).tolist()
            else:
                emitted = greedy
                a_min, all_finished = int(a_min_dev), False  # the loop's one read per dispatch
            tokens[:, i : i + a_min + 1] = emitted[:, : a_min + 1]
            history[:, hist_len : hist_len + a_min + 1] = emitted[:, : a_min + 1]
            token = emitted[:, a_min]
            cache.rewind(k - a_min)
            i += a_min + 1
            if all_finished:
                break
        return tokens

    @torch.no_grad()
    def __call__(self, input_ids, generation_config: Optional[GenerationConfig] = None,
                 rng: Optional[torch.Generator] = None, attention_mask=None, **kwargs):
        """[B, prompt_len] ids -> [B, prompt_len + n] ids on the generator's
        device, n <= max_new_tokens (cut after the step where every row has
        emitted EOS).

        `attention_mask` ([B, prompt_len] 1/0) enables ragged batch prompts
        through the HF LEFT-padding convention: pads at the START of each
        row. Rotary positions come from the mask's cumsum (first real token =
        position 0) and the pads stay masked for the whole decode through the
        cache's persistent pad mask. `rng` is the `torch.Generator` sampling
        draws from; by default a fresh one seeded 0 on the device, so a call
        gives the same tokens every time, as JAX's default key does."""
        config = generation_config or GenerationConfig(**kwargs)
        if config.draft_tokens and config.do_sample:
            raise ValueError(
                "speculative decoding is greedy-only: draft verification accepts "
                "argmax matches, which is not distribution-preserving under "
                "sampling — set do_sample=False or draft_tokens=0"
            )
        if config.draft_tokens and config.repetition_penalty != 1.0:
            raise ValueError(
                "speculative decoding does not compose with repetition_penalty "
                "(the presence update is order-dependent across a verified "
                "block); set repetition_penalty=1.0 or draft_tokens=0"
            )
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.cpu().numpy()
        ids_host = np.asarray(input_ids, np.int64)
        b, prompt_len = ids_host.shape
        max_new = min(config.max_new_tokens, self.max_length - prompt_len)
        if max_new <= 0:
            raise ValueError(
                f"Prompt length {prompt_len} leaves no room in the {self.max_length}-token cache"
            )
        dev = self.device
        ids = torch.as_tensor(ids_host, device=dev)
        am = None
        if attention_mask is not None:
            if isinstance(attention_mask, torch.Tensor):
                attention_mask = attention_mask.cpu().numpy()
            am_host = np.asarray(attention_mask)
            if am_host.ndim != 2 or am_host.shape != ids_host.shape:
                raise ValueError(
                    f"attention_mask must be [batch, prompt_len] matching input_ids "
                    f"{tuple(ids_host.shape)}, got {am_host.shape}"
                )
            if not (am_host[:, -1] == 1).all():
                raise ValueError(
                    "attention_mask looks right-padded (a row's last slot is 0); "
                    "Generator uses the HF LEFT-padding convention — put pads at "
                    "the START of each row"
                )
            am = torch.as_tensor(am_host.astype(np.int64), device=dev)
            positions = torch.as_tensor(np.clip(np.cumsum(am_host, axis=-1) - 1, 0, None), device=dev)
            # Each row continues at its own logical length; the cache's
            # physical slots stay shared.
            next_positions = torch.as_tensor(am_host.sum(-1).astype(np.int64), device=dev)
        else:
            positions = torch.arange(prompt_len, device=dev)[None, :].expand(b, prompt_len)
            next_positions = torch.full((b,), prompt_len, dtype=torch.long, device=dev)
        presence = None
        if config.repetition_penalty != 1.0:
            real = am.bool() if am is not None else torch.ones_like(ids, dtype=torch.bool)
            presence = _presence(ids, real, self.base_config.vocab_size)
        cache = self.model.make_decode_cache(b, self.max_length)
        logits = self._forward(cache, ids, positions, am)[:, -1]
        if config.draft_tokens:
            history = torch.zeros((b, self.max_length + config.draft_tokens), dtype=torch.long, device=dev)
            history[:, :prompt_len] = ids
            generated = self._speculative_decode(
                cache, logits, next_positions, max_new, config, history, prompt_len
            )
        else:
            if rng is None and config.do_sample:
                rng = make_generator(0, dev)
            generated = self._decode(cache, logits, next_positions, max_new, config, rng, presence)
        gen_host = generated[:, :max_new].cpu().numpy()
        gen_host = _trim_at_eos(gen_host, config.eos_token_id, max_new)
        return torch.as_tensor(np.concatenate([ids_host, gen_host], axis=1), device=dev)


class Seq2SeqGenerator(Generator):
    """Encode once, then the same decode loop as `Generator`, for an
    encoder-decoder (`T5ForConditionalGeneration`: `encode(input_ids,
    attention_mask)` and `decode(decoder_input_ids, encoder_hidden,
    positions, enc_mask, decode_cache)`).

    The decoder's cache holds ``max_new_tokens + 1`` positions: the start
    token at position 0, primed with the encoder's output before the loop,
    then one per new token. The cross-attention K/V are projected from the
    encoder's output on that prime call and read back at every step. The
    model must live on `device` (``cuda`` unless ``device="cpu"``)."""

    def __init__(self, model, max_new_tokens: int = 32, decoder_start_token_id: int = 0,
                 device: DeviceLike = None):
        if not hasattr(model, "encode") or not hasattr(model, "make_decode_cache"):
            raise ValueError("Seq2SeqGenerator needs an encoder-decoder model built from an in-tree module")
        super().__init__(model, max_new_tokens=max_new_tokens, max_length=max_new_tokens + 1, device=device)
        self.start_id = decoder_start_token_id

    @torch.no_grad()
    def __call__(self, input_ids, generation_config: Optional[GenerationConfig] = None,
                 rng: Optional[torch.Generator] = None, **kwargs):
        """[B, S] ids -> [B, n] decoder tokens on the generator's device
        (HF's seq2seq `generate` shape: the start token is not returned),
        n <= max_new_tokens, cut after the step where every row has emitted
        EOS. `attention_mask` ([B, S] 1/0, pads anywhere) rides in the
        keyword arguments beside the `GenerationConfig` fields; it keeps the
        pads out of the encoder and the cross-attention. A call that names
        no budget fills the generator's; one that asks for more raises."""
        attention_mask = kwargs.pop("attention_mask", None)  # before GenerationConfig(**kwargs)
        explicit_request = generation_config is not None or "max_new_tokens" in kwargs
        config = generation_config or GenerationConfig(**kwargs)
        if config.draft_tokens:
            raise ValueError(
                "speculative decoding (draft_tokens > 0) is causal-LM only; the "
                "encoder-decoder decode path has no verify-block seam"
            )
        max_new = config.max_new_tokens
        if not explicit_request:
            # A bare call: the dataclass default (32) is not a user request.
            max_new = min(max_new, self.max_new_tokens)
        elif max_new > self.max_new_tokens:
            raise ValueError(
                f"Requested {max_new} new tokens but this generator's decoder "
                f"cache was sized for {self.max_new_tokens}; rebuild with a larger max_new_tokens"
            )
        dev, model = self.device, self.model
        ids = torch.as_tensor(input_ids).to(device=dev, dtype=torch.long)
        b = ids.shape[0]
        am = None
        if attention_mask is not None:
            am = torch.as_tensor(attention_mask).to(device=dev, dtype=torch.long)
            enc_mask = am[:, None, None, :].bool()
        else:
            enc_mask = torch.ones((b, 1, 1, ids.shape[1]), dtype=torch.bool, device=dev)
        encoder_hidden = model.encode(ids, am)
        cache = model.make_decode_cache(b, self.max_length)
        start = torch.full((b,), self.start_id, dtype=torch.long, device=dev)
        first_logits = model.decode(start[:, None], encoder_hidden, torch.zeros((1,), dtype=torch.long, device=dev),
                                    enc_mask, decode_cache=cache)[:, -1]
        presence = None
        if config.repetition_penalty != 1.0:
            # The penalty covers the decoder's context (HF): the start token only.
            presence = torch.zeros((b, self.base_config.vocab_size), dtype=torch.bool, device=dev)
            presence[torch.arange(b, device=dev), start] = True
        if rng is None and config.do_sample:
            rng = make_generator(0, dev)

        def forward(cache, tokens, positions):
            return model.decode(tokens, encoder_hidden, positions[0], enc_mask, decode_cache=cache)

        next_positions = torch.ones((b,), dtype=torch.long, device=dev)  # the start token holds position 0
        generated = self._decode(cache, first_logits, next_positions, max_new, config, rng, presence, forward)
        gen_host = _trim_at_eos(generated[:, :max_new].cpu().numpy(), config.eos_token_id, max_new)
        return torch.as_tensor(gen_host, device=dev)


# One Generator per live model for `generate`, keyed weakly on the model's
# identity plus the Generator's keyword arguments: a collected model's entry
# goes (the cached Generator refers to its model weakly), and a reused id()
# never serves another model. LRU of 8; the lock covers only the bookkeeping.
_GENERATOR_CACHE: dict = {}
_GENERATOR_CACHE_MAX = 8
_GENERATOR_CACHE_LOCK = threading.Lock()


def _evict_dead_generator_entries(dead_ref):
    with _GENERATOR_CACHE_LOCK:
        for key in [k for k, (r, _) in _GENERATOR_CACHE.items() if r is dead_ref]:
            _GENERATOR_CACHE.pop(key, None)


def _cached_generator(model, max_new_tokens: int, **kwargs) -> Generator:
    key = (id(model), tuple(sorted(kwargs.items())))
    with _GENERATOR_CACHE_LOCK:
        hit = _GENERATOR_CACHE.get(key)
        if hit is not None:
            ref, generator = hit
            if ref() is model:
                _GENERATOR_CACHE[key] = _GENERATOR_CACHE.pop(key)  # LRU bump
                return generator
            _GENERATOR_CACHE.pop(key, None)  # a dead model's reused id()
    generator = Generator(model, max_new_tokens=max_new_tokens, **kwargs)
    ref = weakref.ref(model, _evict_dead_generator_entries)
    generator._model = ref
    with _GENERATOR_CACHE_LOCK:
        _GENERATOR_CACHE[key] = (ref, generator)
        while len(_GENERATOR_CACHE) > _GENERATOR_CACHE_MAX:
            del _GENERATOR_CACHE[next(iter(_GENERATOR_CACHE))]
    return generator


def generate(model, input_ids, max_new_tokens: int = 32, **kwargs):
    """One-shot convenience (HF `model.generate` shape): build, or reuse,
    the model's Generator and run it. Generator arguments (`max_length`,
    `device`) and `attention_mask` go through; the rest are
    `GenerationConfig` fields."""
    gen_kwargs = {
        k: kwargs.pop(k)
        for k in ("do_sample", "temperature", "top_k", "top_p", "repetition_penalty",
                  "eos_token_id", "pad_token_id", "draft_tokens", "draft_ngram")
        if k in kwargs
    }
    attention_mask = kwargs.pop("attention_mask", None)
    generator = _cached_generator(model, max_new_tokens, **kwargs)
    return generator(
        input_ids,
        GenerationConfig(max_new_tokens=max_new_tokens, **gen_kwargs),
        attention_mask=attention_mask,
    )
