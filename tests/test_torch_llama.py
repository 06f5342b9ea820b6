"""The port's Llama (`accelerate_tpu_torch.models.llama`) held against the JAX
model on the same weights, carried across with `llama_state_dict_from_flax`.

Full-forward logits must match in f32 within atol 1e-4: both sides run the
same f32 operations, but the matmuls sum in another order (XLA's and
PyTorch's CPU GEMMs block differently), which moves ~1e-6 per product over
two layers and a 512-way vocabulary head. Prefill-then-decode through the
paged pool must reproduce the port's own full forward within the same
tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from accelerate_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from accelerate_tpu.models import llama as jax_llama
from accelerate_tpu_torch.generation import CausalPrograms
from accelerate_tpu_torch.models import MODEL_REGISTRY, create_named_model
from accelerate_tpu_torch.models import llama as port_llama


ATOL = 1e-4


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


def _pair(**overrides):
    """(JAX Model bundle, port model) on the same random weights."""
    jcfg = dataclasses.replace(jax_llama.llama_tiny(), **overrides)
    jmodel = jax_llama.create_llama_model(jcfg, seq_len=16)
    cfg = port_llama.LlamaConfig(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(port_llama.LlamaConfig)}
    )
    model = port_llama.create_llama_model(cfg, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    model.load_state_dict(port_llama.llama_state_dict_from_flax(params, cfg))
    return jmodel, model


def _ids(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize(
    "overrides",
    [{}, {"tie_word_embeddings": True}, {"scan_layers": True}],
    ids=["untied", "tied", "scan_layers"],
)
def test_full_forward_matches_jax_f32(overrides):
    jmodel, model = _pair(**overrides)
    ids = _ids(0, 2, 12)
    expect = np.asarray(jmodel.apply_fn(jmodel.params, ids))
    got = model(torch.as_tensor(ids).long()).detach().numpy()
    assert got.shape == (2, 12, 512)
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)


def test_rotary_and_rmsnorm_match_jax():
    """Split-halves RoPE in f32 and RMSNorm's f32 normalisation, bf16 in and
    out, against the JAX functions on the same inputs."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    for dtype, jdtype, tol in ((torch.float32, np.float32, 1e-5), (torch.bfloat16, jax.numpy.bfloat16, 1e-2)):
        expect = np.asarray(jax_llama.rotary_embedding(jax.numpy.asarray(x, jdtype), pos, 10000.0).astype(np.float32))
        got = port_llama.rotary_embedding(torch.as_tensor(x).to(dtype), torch.as_tensor(pos), 10000.0)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), expect, atol=tol, rtol=tol)
    h = rng.normal(size=(3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    expect = np.asarray(jax_llama.RMSNorm(1e-5).apply({"params": {"scale": scale}}, h))
    norm = port_llama.RMSNorm(16, 1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.as_tensor(scale))
    np.testing.assert_allclose(norm(torch.as_tensor(h)).detach().numpy(), expect, atol=1e-5, rtol=1e-5)


def test_flax_weights_are_transposed_and_checked():
    jmodel, model = _pair()
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    sd = port_llama.llama_state_dict_from_flax(params, model.config)
    wq = params["params"]["layer_0"]["attention"]["wq"]["kernel"]  # flax [in, out]
    np.testing.assert_array_equal(sd["layers.0.attention.wq.weight"].numpy(), wq.T)
    tied_cfg = dataclasses.replace(model.config, tie_word_embeddings=True)
    with pytest.raises(ValueError, match="distinct lm_head"):
        port_llama.llama_state_dict_from_flax(params, tied_cfg)
    with pytest.raises(ValueError, match="layers"):
        port_llama.llama_state_dict_from_flax(params, dataclasses.replace(model.config, num_hidden_layers=3))


def _pools(cfg, num_pages, page_size):
    shape = (num_pages, page_size, cfg.num_key_value_heads, cfg.head_dim)
    return [(torch.zeros(shape), torch.zeros(shape)) for _ in range(cfg.num_hidden_layers)]


@pytest.mark.parametrize("impl", ["gather", "paged_kernel"])
def test_prefill_then_decode_and_verify_match_full_forward(impl):
    """Prefill a prompt into shuffled pool pages, then decode token by token
    and score a verify block: the prefill's last-position logits (all it
    computes) and every later position's equal the full causal forward
    over the same sequence."""
    _, model = _pair()
    cfg = model.config
    ps, n_prompt, n_decode, s = 4, 9, 4, 3
    total = n_prompt + n_decode + s
    ids = torch.as_tensor(_ids(2, 1, total)).long()
    full = model(ids)[0]
    pools = _pools(cfg, 12, ps)
    row = torch.tensor([[7, 2, 9, 4, 11, 1]], dtype=torch.int32)  # pages 0..5 of the slot
    programs = CausalPrograms(model, impl)
    prefill = programs.prefill(ids[:, :n_prompt], torch.arange(n_prompt)[None], pools, row[:, :3], (0, n_prompt))
    torch.testing.assert_close(prefill[0], full[n_prompt - 1 : n_prompt], atol=ATOL, rtol=0)
    for t in range(n_prompt, n_prompt + n_decode):
        step = programs.step(ids[:, t], torch.tensor([t]), pools, row)
        torch.testing.assert_close(step[0], full[t], atol=ATOL, rtol=0)
    start = n_prompt + n_decode
    block = programs.verify(ids[:, start:], torch.arange(start, total)[None], pools, row)
    torch.testing.assert_close(block[0], full[start:], atol=ATOL, rtol=0)


def test_registry_configs_match_jax_and_widths():
    for name, factory in MODEL_REGISTRY.items():
        jcfg = JAX_REGISTRY[name][1]()
        cfg = factory()
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), (name, f.name)
    one_b = MODEL_REGISTRY["llama-1b"]()
    assert (one_b.num_hidden_layers, one_b.hidden_size, one_b.vocab_size, one_b.head_dim) == (16, 2048, 128256, 64)
    tiny = create_named_model("llama-tiny", seed=3, device="cpu")
    again = create_named_model("llama-tiny", seed=3, device="cpu")
    for (name, a), b in zip(tiny.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="unknown model"):
        create_named_model("llama-7000b", device="cpu")


def test_padded_batch_logits_match_jax_f32():
    """The training forward takes JAX's `attention_mask` ([B, S], 1 = a real
    token) as its second argument: pad keys are masked out of every row, right
    or left padding, and the logits equal JAX's in f32, pad rows included."""
    jmodel, model = _pair()
    ids = _ids(4, 2, 12)
    mask = np.ones((2, 12), np.int32)
    mask[0, 9:] = 0  # right padding
    mask[1, :4] = 0  # left padding
    expect = np.asarray(jmodel.apply_fn(jmodel.params, ids, mask))
    got = model(torch.as_tensor(ids).long(), torch.as_tensor(mask)).detach().numpy()
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)
    unmasked = model(torch.as_tensor(ids).long()).detach().numpy()
    assert np.abs(got[0, 9:] - unmasked[0, 9:]).max() > 1e-3  # the mask reached attention
    np.testing.assert_allclose(got[0, :9], unmasked[0, :9], atol=ATOL, rtol=0)  # causal: pads come after
