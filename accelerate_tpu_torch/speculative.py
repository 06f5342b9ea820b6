"""Self-speculation primitives: n-gram (prompt-lookup) drafting and greedy
draft verification, as batched tensor ops with no host sync.

Port of `accelerate_tpu/speculative.py`. The drafter proposes the tokens that
followed the most recent earlier occurrence of each row's trailing n-gram;
one multi-token verify dispatch scores them, and the longest prefix matching
the model's own greedy choices is accepted plus one bonus token. Greedy output
is token-identical to plain decode by construction. Degenerate inputs (no
match, short context) give ``valid_len == 0`` and degrade to one plain step.
"""

from __future__ import annotations

import torch

#: Default number of draft tokens proposed per verify step.
DEFAULT_DRAFT_TOKENS = 4
#: Default n-gram length the drafter matches on.
DEFAULT_DRAFT_NGRAM = 2


def propose_ngram_drafts(history, hist_len, draft_tokens: int, ngram: int = DEFAULT_DRAFT_NGRAM):
    """Prompt-lookup draft proposal.

    Args:
        history: [B, H] integer tokens (prompt + generated) packed at the start
            of each row; entries at index >= hist_len are ignored.
        hist_len: [B] (or scalar) observed length per row, including the
            pending token the next verify step will score.
        draft_tokens: k, proposals per row.
        ngram: match length m (>= 1).

    Returns (drafts [B, k], valid_len [B] in [0, k]); only
    ``drafts[:, :valid_len]`` are proposals, the rest are clipped-gather
    artifacts the verifier masks.
    """
    if draft_tokens < 1:
        raise ValueError("draft_tokens must be >= 1")
    if ngram < 1:
        raise ValueError("ngram must be >= 1")
    b, h = history.shape
    k, m = int(draft_tokens), int(ngram)
    dev = history.device
    hist_len = torch.as_tensor(hist_len, device=dev).long().expand(b)
    starts = torch.arange(h, device=dev)
    tail_idx = (hist_len[:, None] - m + torch.arange(m, device=dev)[None, :]).clamp(0, h - 1)
    tail = torch.gather(history, 1, tail_idx)  # [B, m]
    # match[b, i] iff history[b, i : i + m] equals the trailing n-gram.
    match = torch.ones((b, h), dtype=torch.bool, device=dev)
    for t in range(m):
        shifted = torch.roll(history, -t, dims=1)
        match &= (shifted == tail[:, t : t + 1]) & ((starts + t) < h)[None, :]
    # Exclude the trailing occurrence itself and starts not fully observed.
    match &= starts[None, :] < (hist_len[:, None] - m)
    j = torch.where(match, starts[None, :], torch.full_like(starts, -1)[None, :]).amax(dim=1)
    found = j >= 0
    cont = (j[:, None] + m + torch.arange(k, device=dev)[None, :]).clamp(0, h - 1)
    drafts = torch.gather(history, 1, cont)
    valid_len = torch.where(found, torch.clamp(hist_len - (j + m), max=k), torch.zeros_like(j))
    return drafts, valid_len


def greedy_accept_length(drafts, greedy_targets, valid_len):
    """Longest accepted draft prefix: draft i is accepted iff every earlier
    draft was, ``i < valid_len``, and it equals the model's argmax at verify
    position i. Returns [B] counts in [0, k]."""
    b, k = drafts.shape
    ok = (drafts == greedy_targets) & (
        torch.arange(k, device=drafts.device)[None, :] < valid_len[:, None]
    )
    return torch.cumprod(ok.long(), dim=1).sum(dim=1)
