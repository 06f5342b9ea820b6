"""Sampling and the prefill / step / verify programs of causal-LM serving.

Port of the pieces of `accelerate_tpu/generation.py` the serving engine runs:
`GenerationConfig` (its sampling fields), `_sample`, `_bucket_for`,
`_trim_at_eos`, and the program
seam of `make_causal_programs` / `make_cached_prefill_program` as the plain
methods of `CausalPrograms`. PyTorch runs eagerly, so nothing here is traced
or compiled: a program is a forward call with the KV pools and a page table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class GenerationConfig:
    """The engine-level sampling settings. Temperature, EOS and the token
    budget are per request (`serving.Request`)."""

    do_sample: bool = False
    top_k: int = 0  # 0 = full vocab
    top_p: float = 1.0  # nucleus sampling; 1.0 = disabled (applied after top_k, HF order)


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

    `prefill` writes a prompt (or the unmatched suffix after shared-prefix
    pages) into one slot's pages and returns its logits; it always attends
    through the gather path, as the JAX package's prefill takes its XLA
    branch. `step` advances every slot one token and `verify` scores a [B, s]
    token block; both attend through `attention_impl`."""

    def __init__(self, model, attention_impl: str):
        self.model = model
        self.attention_impl = attention_impl

    @torch.no_grad()
    def prefill(self, input_ids, positions, kv_pools, page_row):
        """[1, S] ids at [1, S] absolute positions through `page_row`
        ([1, pages] int32, covering every position) -> [1, S, V] logits."""
        return self.model(input_ids, positions, kv_pools, page_row, attention_impl="gather")

    @torch.no_grad()
    def step(self, token, position, kv_pools, page_table):
        """[B] tokens at [B] positions -> [B, V] logits."""
        logits = self.model(
            token[:, None], position[:, None], kv_pools, page_table, self.attention_impl
        )
        return logits[:, -1, :]

    @torch.no_grad()
    def verify(self, tokens, positions, kv_pools, page_table):
        """[B, s] token block at [B, s] positions -> [B, s, V] logits; position
        j's logits see exactly the block prefix <= j."""
        return self.model(tokens, positions, kv_pools, page_table, self.attention_impl)
