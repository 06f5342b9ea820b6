"""The port's top-k routing and MoE block (`accelerate_tpu_torch.parallel.expert`)
held against the JAX package's (`accelerate_tpu.parallel.expert`) on the same
numpy inputs, and the single-device cases of `tests/test_expert.py` run
against the port.

Tolerances: `dispatch` is a one-hot of the same slots, so exactly equal;
`combine` holds the renormalised gates, whose softmax the two frameworks
compute in another order (atol 1e-6); the aux losses rtol 1e-5. The f32
block and its input gradient atol 1e-5: the same f32 einsums and GEMMs
summed in another order. bf16 atol/rtol 1e-2, the port's bf16 tolerance
for JAX parity (`tests/test_torch_llama.py`): each of the block's bf16
products rounds its output once, in another order.

A test whose routing could flip on a near tie asserts first, in JAX, that
its inputs' smallest gap between the k-th and (k+1)-th router probability
exceeds 1e-4, so that a failure names its cause. Comparisons run on one
torch thread; the file takes about 20 s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.parallel import expert as jax_expert
from accelerate_tpu_torch.parallel import expert as port_expert

T, E, K, H, F = 16, 4, 2, 8, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def routing_gap(logits, k):
    """The smallest gap, over tokens, between the k-th and (k+1)-th router
    probability, from JAX's softmax."""
    probs = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1)), axis=-1)[:, ::-1]
    return float((probs[:, k - 1] - probs[:, k]).min())


def jax_block(x, capacity_factor=1.25, num_experts=E, top_k=K):
    block = jax_expert.MoEBlock(hidden_size=x.shape[-1], intermediate_size=F, num_experts=num_experts,
                                top_k=top_k, capacity_factor=capacity_factor)
    return block, block.init(jax.random.key(0), jnp.asarray(x))


def port_block(jparams, capacity_factor=1.25, num_experts=E, top_k=K, hidden=H, dtype=torch.float32):
    """The port's MoEBlock carrying JAX's weights: the router kernel [H, E]
    transposed to a Linear weight, the experts' [E, in, out] as they are."""
    block = port_expert.MoEBlock(hidden, F, num_experts, top_k, capacity_factor)
    p = jparams["params"]
    experts = p["experts"]
    block.load_state_dict({
        "router.weight": torch.from_numpy(np.array(p["router"]["kernel"])).T.contiguous(),
        "experts.w_gate": torch.from_numpy(np.array(experts["w_gate/kernel"])),
        "experts.w_up": torch.from_numpy(np.array(experts["w_up/kernel"])),
        "experts.w_down": torch.from_numpy(np.array(experts["w_down/kernel"])),
    })
    return block.to(dtype)


# ----------------------------------------------- the cases of tests/test_expert.py
def test_top_k_routing_matches_brute_force():
    """With ample capacity the dispatch/combine path equals each token run
    through its top-k experts, weighted by the renormalised gate (the port of
    `test_expert.py:29`, on JAX's initial weights)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, T, H)).astype(np.float32)
    _, params = jax_block(x, capacity_factor=8.0)
    block = port_block(params, capacity_factor=8.0)
    with torch.no_grad():
        out, aux = block(torch.from_numpy(x))

    p = params["params"]
    router_w = np.asarray(p["router"]["kernel"])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x[0] @ router_w), axis=-1))
    wg, wu, wd = (np.asarray(p["experts"][n]) for n in ("w_gate/kernel", "w_up/kernel", "w_down/kernel"))

    def expert_fwd(e, tok):
        gate = tok @ wg[e]
        return (gate / (1.0 + np.exp(-gate)) * (tok @ wu[e])) @ wd[e]

    expected = np.zeros((T, H), np.float32)
    for t in range(T):
        top = np.argsort(-probs[t])[:K]
        gates = probs[t][top] / probs[t][top].sum()
        for e, g in zip(top, gates):
            expected[t] += g * expert_fwd(e, x[0, t])
    np.testing.assert_allclose(out[0].numpy(), expected, rtol=2e-4, atol=2e-5)
    assert np.isfinite(float(aux["load_balance_loss"])) and np.isfinite(float(aux["router_z_loss"]))


def test_routing_capacity_drops_overflow():
    """Capacity 1 and every token preferring expert 0: one choice takes its
    slot, the others are dropped with zero combine weight (`test_expert.py:65`)."""
    logits = torch.as_tensor(np.tile([5.0, 0.0], (4, 1)).astype(np.float32))
    dispatch, combine, _ = port_expert.top_k_routing(logits, top_k=1, capacity=1)
    assert float(dispatch[:, 0, :].sum()) == 1.0
    assert float(dispatch[:, 1, :].sum()) == 0.0
    assert int((combine.sum(dim=(1, 2)) > 0).sum()) == 1
    assert float(dispatch[0, 0, 0]) == 1.0  # the first token in token order


@pytest.mark.parametrize("args,want", [((64, 8, 2, 1.0), 16), ((64, 8, 2, 1.25), 20), ((1, 8, 1, 1.0), 1),
                                       ((2048, 8, 2, 1.25), 640), ((8, 8, 2, 1.25), 3), ((40, 8, 2, 1.25), 13),
                                       ((4, 4, 2, 2.0), 4)])
def test_expert_capacity_rule(args, want):
    """GShard's rule at `test_expert.py:78`'s cases, and JAX's value at the
    token counts the port routes: a training forward (2048), a decode step
    (B = 8), a verify block (8 x 5), the dropless factor E / top_k."""
    assert port_expert.expert_capacity(*args) == jax_expert.expert_capacity(*args) == want


# ------------------------------------------------------- routing against JAX's
def _tied_logits():
    """Router logits with exact ties: rows whose two best experts share one
    value, rows equal in every expert, and repeated rows."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(24, E)).astype(np.float32)
    logits[0, 1] = logits[0, 2] = logits[0].max() + 1.0  # tie for the first choice
    logits[1, 3] = logits[1, 0] = logits[1].min() - 1.0  # tie for the last place
    logits[2, 0] = logits[2, 2]  # a tie somewhere in the order
    logits[3] = 0.0  # every expert equal
    logits[10:14] = logits[5]  # equal tokens, which take slots in token order
    logits[20, 1] = logits[20, 3] = np.sort(logits[20])[-2]  # tie between the 2nd and a 3rd place
    return logits


def _left_padded_logits():
    """Router logits of a left-padded batch: each row's pad positions hold
    the hidden state of one pad token, so they repeat across the batch."""
    rng = np.random.default_rng(5)
    hidden = rng.normal(size=(3, 8, H)).astype(np.float32)
    pad = rng.normal(size=(H,)).astype(np.float32)
    for row, n_pad in enumerate((3, 0, 6)):
        hidden[row, :n_pad] = pad
    router = rng.normal(size=(H, E)).astype(np.float32)
    return (hidden.reshape(-1, H) @ router).astype(np.float32)


CASES = {
    "random": lambda: np.random.default_rng(3).normal(size=(40, E)).astype(np.float32) * 2.0,
    "ties": _tied_logits,
    "left_padded": _left_padded_logits,
}


@pytest.mark.parametrize("capacity", [1, 3, 8, 40])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_top_k_routing_matches_jax(case, top_k, capacity):
    """`dispatch` equal to JAX's, `combine` within atol 1e-6 and both aux
    losses within rtol 1e-5, on random logits, on logits with exact ties
    (the lower expert first, as `jax.lax.top_k`; equal tokens in token
    order), and on a left-padded batch's, where the pads take slots; at
    capacities that drop most choices, some and none."""
    logits = CASES[case]()
    d_j, c_j, a_j = jax_expert.top_k_routing(jnp.asarray(logits), top_k, capacity)
    d_p, c_p, a_p = port_expert.top_k_routing(torch.from_numpy(logits), top_k, capacity)
    assert d_p.dtype == torch.float32 and d_p.shape == (logits.shape[0], E, capacity)
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c_j), atol=1e-6, rtol=0)
    for name in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(float(a_p[name]), float(a_j[name]), rtol=1e-5, err_msg=name)


def test_tied_choices_go_to_the_lower_expert():
    """On an exact tie the lower expert index wins the higher place."""
    logits = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]], np.float32)
    dispatch, _, _ = port_expert.top_k_routing(torch.from_numpy(logits), 1, 2)
    assert dispatch[0, 1].sum() == 1 and dispatch[0, 2].sum() == 0
    assert dispatch[1, 0].sum() == 1


# ------------------------------------------------------------ the block
def _block_inputs(seed, b=2, s=12):
    return np.random.default_rng(seed).normal(size=(b, s, H)).astype(np.float32)


@pytest.mark.parametrize("capacity_factor", [1.0, 1.25, 8.0])
def test_moe_block_and_input_gradient_match_jax_f32(capacity_factor):
    """The f32 block with carried weights: output and aux within atol 1e-5
    and rtol 1e-5 of JAX's, and the gradient of sum(y * w) + the aux losses
    with respect to the input within atol 1e-5 of `jax.grad`'s; at
    capacities that drop choices and at one that drops none."""
    x = _block_inputs(6)
    jblock, params = jax_block(x, capacity_factor)
    router = np.asarray(params["params"]["router"]["kernel"])
    assert routing_gap(x.reshape(-1, H) @ router, K) > 1e-4
    block = port_block(params, capacity_factor)
    w = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def jax_objective(xx):
        y, aux = jblock.apply(params, xx)
        return jnp.sum(y * w) + aux["load_balance_loss"] + aux["router_z_loss"], (y, aux)

    (_, (y_j, aux_j)), g_j = jax.value_and_grad(jax_objective, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_p, aux_p = block(xt)
    (torch.sum(y_p * torch.from_numpy(w)) + aux_p["load_balance_loss"] + aux_p["router_z_loss"]).backward()
    np.testing.assert_allclose(y_p.detach().numpy(), np.asarray(y_j), atol=1e-5, rtol=0)
    for name in aux_j:
        np.testing.assert_allclose(float(aux_p[name].detach()), float(aux_j[name]), rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), atol=1e-5, rtol=0)


def test_moe_block_bf16_matches_jax():
    """bf16 input and weights on both sides: the router in f32 (its bf16
    weight promoted, flax's ``Dense(dtype=None)``), the experts in bf16, the
    combine in f32, y back in bf16; within atol/rtol 1e-2 of JAX's."""
    x = _block_inputs(8)
    jblock, params = jax_block(x)
    bf16_params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    xb = jnp.asarray(x, jnp.bfloat16)
    router = np.asarray(bf16_params["params"]["router"]["kernel"].astype(jnp.float32))
    assert routing_gap(np.asarray(xb.astype(jnp.float32)).reshape(-1, H) @ router, K) > 1e-4
    y_j, aux_j = jblock.apply(bf16_params, xb)
    block = port_block(params, dtype=torch.bfloat16)
    with torch.no_grad():
        y_p, aux_p = block(torch.from_numpy(x).bfloat16())
    assert y_p.dtype == torch.bfloat16 and y_j.dtype == jnp.bfloat16
    np.testing.assert_allclose(y_p.float().numpy(), np.asarray(y_j.astype(jnp.float32)), atol=1e-2, rtol=1e-2)
    for name in aux_j:
        np.testing.assert_allclose(float(aux_p[name].detach()), float(aux_j[name]), rtol=1e-5, err_msg=name)
