"""Top-k mixture-of-experts routing and the MoE block: the one-device form of
`accelerate_tpu/parallel/expert.py`.

GShard's dense formulation, step for step as the JAX package computes it
(tokens T = B * S of one forward, experts E, capacity C, hidden H):

  dispatch [T, E, C] one-hot   token t goes to slot c of expert e
  combine  [T, E, C] f32       the same support, weighted by the gate
  expert_in  = einsum('tec,th->ech', dispatch, x)
  expert_out = the SwiGLU experts on [E, C, H]
  y          = einsum('tec,ech->th', combine, expert_out)

The capacity follows the forward's token count, so a decode step (T = B)
and a verify block (T = B * (draft + 1)) route with their own, smaller
capacities, as JAX's programs do; pad tokens of a left-padded batch take
slots like any other. Expert sharding over a mesh axis
(`EXPERT_SHARDING_RULES`) waits for the port's multi-device slice; an
index-based dispatch that skips the one-hot products is a later speed item.
The einsums and the expert GEMMs are products that JAX leaves to XLA, so
here they are `torch.einsum` and `torch.bmm`: no TPU kernel covers them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..models.decoder import Dense


#: JAX's expert rules (`accelerate_tpu/parallel/expert.py`): the experts'
#: [E, in, out] kernels over ("expert", ..., "model"). Mixtral's table ends
#: with them; the "expert" axis waits for ROADMAP A item 3, expert sharding.
EXPERT_SHARDING_RULES = [
    (r"experts/(w_gate|w_up)/kernel", ("expert", None, "model")),
    (r"experts/w_down/kernel", ("expert", "model", None)),
]


def expert_capacity(num_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots per expert: the even share times top_k times the slack (GShard's
    rule), at least 1."""
    return max(1, int(math.ceil(num_tokens * top_k / num_experts * capacity_factor)))


def top_k_routing(router_logits, top_k: int, capacity: int):
    """Dispatch and combine tensors of top-k routing, JAX's `top_k_routing`.

    `router_logits` [T, E] -> (dispatch [T, E, C] f32 one-hot, combine
    [T, E, C] f32, aux) with aux ``{"load_balance_loss", "router_z_loss"}``.

    - The top k of the f32 softmax are taken in descending order with the
      lower expert first on a tie (`jax.lax.top_k`'s order; `torch.topk`
      promises none, so this is a stable sort), and their gates are
      renormalised over the k.
    - Slots go in priority order: every token's j-th choice takes a slot
      only after all tokens' (j-1)-th choices, and within a choice in
      token order. A choice whose slot is at or past `capacity` is dropped
      (zero dispatch and combine: the residual carries the token).
    - The aux losses count every choice, dropped or not:
      ``E * sum(f * P) / top_k`` with f the share of choices and P the mean
      router probability per expert, and the mean of logsumexp squared."""
    t, e = router_logits.shape
    logits32 = router_logits.float()
    probs = torch.softmax(logits32, dim=-1)
    ordered, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = ordered[:, :top_k], order[:, :top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(expert_ids, e).float()  # [T, k, E]

    used = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    positions, keep = [], []
    for j in range(top_k):
        oh = onehot[:, j, :]
        pos_j = (torch.cumsum(oh, dim=0) - 1.0) + used[None, :]  # [T, E] slot index
        pos_tok = (pos_j * oh).sum(dim=-1)  # [T]
        positions.append(pos_tok.long())
        keep.append(pos_tok < capacity)
        used = used + oh.sum(dim=0)
    position_in_expert = torch.stack(positions, dim=1)  # [T, k]
    keep_f = torch.stack(keep, dim=1).float()[..., None]  # [T, k, 1]
    # A dropped choice's slot may lie past C; its keep of 0 zeroes it anyway.
    slot_onehot = F.one_hot(position_in_expert.clamp(max=capacity - 1), capacity).float()  # [T, k, C]
    dispatch = torch.einsum("tke,tkc->tec", onehot * keep_f, slot_onehot)
    combine = torch.einsum("tke,tkc->tec", onehot * keep_f * gate_vals[..., None], slot_onehot)

    f = onehot.sum(dim=1).mean(dim=0)  # [E]
    p = probs.mean(dim=0)  # [E]
    load_balance_loss = e * (f * p).sum() / top_k
    router_z_loss = torch.logsumexp(logits32, dim=-1).square().mean()
    return dispatch, combine, {"load_balance_loss": load_balance_loss, "router_z_loss": router_z_loss}


class ExpertMLP(nn.Module):
    """SwiGLU experts with the expert axis first on every weight: `w_gate`
    and `w_up` [E, H, F], `w_down` [E, F, H] (the flax params
    ``w_gate/kernel`` etc., [E, in, out], not transposed)."""

    def __init__(self, hidden_size: int, intermediate_size: int, num_experts: int):
        super().__init__()
        e, h, f = num_experts, hidden_size, intermediate_size
        self.w_gate = nn.Parameter(torch.empty(e, h, f))
        self.w_up = nn.Parameter(torch.empty(e, h, f))
        self.w_down = nn.Parameter(torch.empty(e, f, h))

    @torch.no_grad()
    def normal_(self, generator: torch.Generator):
        """Each weight normal with std 1/sqrt(its input width), as
        `decoder.random_init` fills a Linear."""
        for w in (self.w_gate, self.w_up, self.w_down):
            w.normal_(0.0, w.shape[1] ** -0.5, generator=generator)

    def forward(self, x):  # [E, C, H]
        gate = torch.bmm(x, self.w_gate)
        up = torch.bmm(x, self.w_up)
        return torch.bmm(F.silu(gate) * up, self.w_down)


class MoEBlock(nn.Module):
    """The router and the experts, in place of a decoder layer's MLP:
    ``[B, S, H] -> ([B, S, H], aux)``.

    The router is flax's ``nn.Dense(dtype=None)`` on the f32 input, so under
    a bf16 `PreparedModel` its bf16 weight is promoted to f32; the dispatch
    is cast to the hidden dtype before it gathers the tokens, the combine
    runs in f32 over the f32 expert outputs, and y comes back in the hidden
    dtype."""

    def __init__(self, hidden_size: int, intermediate_size: int, num_experts: int = 8, top_k: int = 2,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.num_experts, self.top_k, self.capacity_factor = num_experts, top_k, capacity_factor
        self.router = Dense(hidden_size, num_experts, bias=False)
        self.experts = ExpertMLP(hidden_size, intermediate_size, num_experts)

    def forward(self, hidden):
        b, s, h = hidden.shape
        x = hidden.reshape(b * s, h)
        router_logits = self.router(x.float())
        capacity = expert_capacity(b * s, self.num_experts, self.top_k, self.capacity_factor)
        dispatch, combine, aux = top_k_routing(router_logits, self.top_k, capacity)
        expert_in = torch.einsum("tec,th->ech", dispatch.to(hidden.dtype), x)
        expert_out = self.experts(expert_in)
        y = torch.einsum("tec,ech->th", combine, expert_out.float())
        return y.reshape(b, s, h).to(hidden.dtype), aux
