"""The port's flash attention (`accelerate_tpu_torch.ops.flash_attention`) and
its dispatch gate, held against the JAX package on the same numpy inputs.

On the CPU the port runs the plain versions of K3 (forward), K4 (dK, dV) and
K5 (dQ); the JAX side runs its Pallas kernels in interpret mode. Tolerances
are the JAX package's own (`tests/test_flash_attention.py`): f32 2e-5 for
outputs and lse, 5e-4 for gradients; both sides sum the same fp32 products
in another order (JAX block by block, the port over the full score matrix).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.ops import attention as jax_attention
from accelerate_tpu.ops import flash_attention as jax_flash
from accelerate_tpu_torch.ops import attention as port_attention
from accelerate_tpu_torch.ops import flash_attention as port_flash


FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch's CPU kernels on one thread. With a second OpenMP thread,
    `torch.exp` was seen to come back about 1e-4 off in a few fresh processes
    out of many on a shared CPU host, more than the comparisons here allow;
    on one thread it never did."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize(
    "bh,s,sk,d,causal",
    [(4, 128, 128, 32, True), (2, 64, 192, 64, True), (3, 128, 128, 64, False),
     (2, 128, 128, 96, True), (1, 128, 128, 256, True), (2, 128, 128, 96, False),
     (2, 128, 128, 16, True), (2, 128, 256, 16, False)],
    ids=["causal", "causal-cross", "full", "causal-d96", "causal-d256", "full-d96", "causal-d16", "full-cross-d16"],
)
def test_plain_kernels_match_pallas_interpret(bh, s, sk, d, causal):
    """Block level: plain K3 against `_fwd_call` (o and lse[..., 0]), plain
    K4/K5 against `_bwd_call` from the same o and lse."""
    rng = np.random.default_rng(s + d)
    q, k, v, do = _normal(rng, bh, s, d), _normal(rng, bh, sk, d), _normal(rng, bh, sk, d), _normal(rng, bh, s, d)
    scale = 1.0 / np.sqrt(d)
    o, lse = jax_flash._fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal, 64, 64, True)
    po, plse = port_flash.flash_fwd(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal, scale=scale)
    assert plse.shape == (bh, s) and plse.dtype == torch.float32
    np.testing.assert_allclose(po.numpy(), np.asarray(o), **FWD)
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse)[..., 0], **FWD)
    grads = jax_flash._bwd_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse, jnp.asarray(do), scale, causal, 64, 64, True
    )
    port_grads = port_flash.flash_bwd(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(np.asarray(o)),
        torch.tensor(np.asarray(lse)[..., 0]), torch.tensor(do), causal=causal, scale=scale,
    )
    for name, ref, got in zip(("dq", "dk", "dv"), grads, port_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD, err_msg=name)


def _qkv(b, s, h, d, hkv=None, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    sk = sk or s
    return _normal(rng, b, s, h, d), _normal(rng, b, sk, hkv, d), _normal(rng, b, sk, hkv, d)


def _port_flash(q, k, v, **kw):
    return port_flash.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw)


@pytest.mark.parametrize(
    "shape,hkv,causal",
    [((2, 128, 2, 64), None, False), ((2, 128, 2, 64), None, True), ((1, 256, 4, 32), None, False),
     ((1, 256, 4, 32), None, True), ((2, 128, 4, 32), 2, True)],
    ids=["mha", "mha-causal", "long", "long-causal", "gqa-causal"],
)
def test_flash_forward_matches_jax(shape, hkv, causal):
    b, s, h, d = shape
    q, k, v = _qkv(b, s, h, d, hkv=hkv, seed=1)
    ref = jax_flash.flash_attention(q, k, v, causal=causal, block_q=64, block_k=64, interpret=True)
    out = _port_flash(q, k, v, causal=causal, block_q=64, block_k=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hkv", [2, 1], ids=["mha", "gqa"])
def test_flash_grads_match_jax(causal, hkv, d=32):
    """Autograd through `FlashAttentionFunction` (plain K3-K5 on the CPU)
    against `jax.grad` through JAX's custom VJP; with GQA the repeated K/V
    heads' gradients sum over each group."""
    q, k, v = _qkv(1, 128, 2, d, hkv=hkv, seed=2)

    def loss_jax(q_, k_, v_):
        out = jax_flash.flash_attention(q_, k_, v_, causal=causal, block_q=64, block_k=64, interpret=True)
        return jnp.sum(jnp.square(out))

    ref = jax.grad(loss_jax, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    port_flash.flash_attention(tq, tk, tv, causal=causal, block_q=64, block_k=64).square().sum().backward()
    for name, r, g in zip("qkv", ref, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [96, 256], ids=["d96", "d256"])
def test_flash_grads_match_jax_at_neox_and_gptj_head_dims(d, causal):
    """`test_flash_grads_match_jax` at GPT-NeoX-20B's head dim 96 and
    GPT-J-6B's 256 (Hq = Hkv, as both families)."""
    test_flash_grads_match_jax(causal, 2, d)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_jax_at_head_dim_16(causal):
    """`test_flash_grads_match_jax` at T5-tiny's head dim 16."""
    test_flash_grads_match_jax(causal, 2, 16)


def test_head_dim_16_is_admitted():
    """The kernels take head dim 16 (T5-tiny's d_kv), which JAX's Pallas
    kernels take too: `HEAD_DIMS` holds it, the wrapper's checks pass a
    D 16 tensor and still refuse D 48, and `use_flash` opens on the card
    for T5-tiny's unmasked 1024-token cross-attention."""
    assert 16 in port_flash.HEAD_DIMS
    q = torch.zeros(4, 128, 16)
    port_flash._check_cuda(q=q, k=q, v=q)
    with pytest.raises(ValueError, match="head_dim"):
        port_flash._check_cuda(q=torch.zeros(4, 128, 48), k=torch.zeros(4, 128, 48), v=torch.zeros(4, 128, 48))
    assert port_attention.use_flash(None, False, 1024, 1024, False, on_cuda=True)


def test_flash_causal_cross_length_matches_jax():
    """Causal with Sq < Skv is aligned bottom-right, forward and dq."""
    q, k, v = _qkv(1, 64, 2, 32, seed=3, sk=192)
    ref = jax_flash.flash_attention(q, k, v, causal=True, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_port_flash(q, k, v, causal=True, block_q=64, block_k=64).numpy(),
                               np.asarray(ref), **FWD)
    ref_dq = jax.grad(lambda q_: jnp.sum(jnp.square(
        jax_flash.flash_attention(q_, k, v, causal=True, block_q=64, block_k=64, interpret=True))))(q)
    tq = torch.tensor(q, requires_grad=True)
    port_flash.flash_attention(tq, torch.tensor(k), torch.tensor(v), causal=True, block_q=64,
                               block_k=64).square().sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(ref_dq), **GRAD)


def test_flash_rejects_what_jax_rejects():
    q, k, v = _qkv(1, 96, 2, 32)
    with pytest.raises(ValueError, match="divide"):
        _port_flash(q, k, v, block_q=64, block_k=64)
    q, k, v = _qkv(1, 128, 2, 32, sk=64)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        _port_flash(q, k, v, causal=True)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        bhsd = [torch.tensor(x[0]).transpose(0, 1).contiguous() for x in (q, k, v)]
        port_flash.flash_fwd(*bhsd, causal=True)


def test_flash_small_seq_shrinks_blocks():
    q, k, v = _qkv(2, 64, 2, 32, seed=3)
    ref = jax_attention.dot_product_attention(q, k, v, causal=True, implementation="xla")
    np.testing.assert_allclose(_port_flash(q, k, v, causal=True).numpy(), np.asarray(ref), **FWD)


# ------------------------------------------------------------ the dispatch gate
GATE_CASES = [
    # (sq, skv, masked, causal, implementation)
    (1024, 1024, False, True, None),
    (2048, 2048, False, True, None),
    (1024, 2048, False, True, None),
    (2048, 1024, False, True, None),   # causal Sq > Skv: plain path
    (2048, 1024, False, False, None),
    (1024, 1024, True, True, None),    # masked: plain path
    (896, 896, False, True, None),     # too short
    (1088, 1088, False, True, None),   # 1088 % 128 != 0
    (1024, 1000, False, False, None),  # Skv % 128 != 0
    (128, 128, False, True, "flash"),
    (2048, 2048, False, True, "xla"),
]


@pytest.mark.parametrize("sq,skv,masked,causal,impl", GATE_CASES)
def test_dispatch_gate_matches_jax(monkeypatch, sq, skv, masked, causal, impl):
    """`use_flash` on the card decides as JAX's `dot_product_attention` does
    on a TPU (`ops/attention.py:493-516`). JAX's side runs with its backend
    reported as "tpu" and its flash kernel stubbed, and records its choice in
    LAST_DISPATCH."""
    import accelerate_tpu.ops.flash_attention as jf_module

    monkeypatch.delenv("ACCELERATE_TPU_ATTENTION_IMPL", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jf_module, "flash_attention", lambda q, k, v, **kw: jnp.zeros(q.shape, q.dtype))
    q = jnp.zeros((1, sq, 1, 8), jnp.float32)
    kv = jnp.zeros((1, skv, 1, 8), jnp.float32)
    mask = jnp.ones((1, skv), bool) if masked else None
    jax_attention.dot_product_attention(q, kv, kv, mask=mask, causal=causal, implementation=impl)
    expect = jax_attention.LAST_DISPATCH == "flash"
    assert port_attention.use_flash(impl, masked, sq, skv, causal, on_cuda=True) == expect
    # JAX's gate opens only on a TPU, the port's only on the card.
    assert port_attention.use_flash(impl, masked, sq, skv, causal, on_cuda=False) == (impl == "flash")


def test_dot_product_attention_flash_path_on_cpu(monkeypatch):
    """`implementation="flash"` on CPU tensors takes the plain K3-K5 through
    autograd, equal to the plain einsum path; the environment override
    forces either; a mask with forced flash raises, as in JAX."""
    monkeypatch.delenv("ACCELERATE_TPU_ATTENTION_IMPL", raising=False)
    q, k, v = (torch.tensor(x) for x in _qkv(2, 128, 4, 32, hkv=2, seed=4))
    plain = port_attention.dot_product_attention(q, k, v, causal=True)
    assert port_attention.LAST_DISPATCH == "xla"  # CPU tensors: the gate stays shut
    flash = port_attention.dot_product_attention(q, k, v, causal=True, implementation="flash")
    assert port_attention.LAST_DISPATCH == "flash"
    torch.testing.assert_close(flash, plain, **FWD)
    monkeypatch.setenv("ACCELERATE_TPU_ATTENTION_IMPL", "flash")
    port_attention.dot_product_attention(q, k, v, causal=True)
    assert port_attention.LAST_DISPATCH == "flash"
    monkeypatch.setenv("ACCELERATE_TPU_ATTENTION_IMPL", "xla")
    port_attention.dot_product_attention(q, k, v, causal=True)
    assert port_attention.LAST_DISPATCH == "xla"
    with pytest.raises(ValueError, match="mask"):
        port_attention.dot_product_attention(q, k, v, mask=torch.ones(2, 128, dtype=torch.bool),
                                             implementation="flash")
