"""The port's BERT (`accelerate_tpu_torch/models/bert.py`) and the eager
`segment_ids` path of `dot_product_attention`, held against the JAX
package's on `bert_tiny` with the flax weights carried across by
`bert_state_dict_from_flax` and the same numpy inputs.

Tolerances:
  - f32 logits, port against JAX: atol 1e-5. The same f32 operations; the
    GEMMs and the LayerNorm sums run in another order.
  - bf16 under `PreparedModel` against the forward of JAX's
    `Accelerator(mixed_precision="bf16")` (`PreparedModel._mp_apply`):
    atol 1e-5 against it run op by op, as the port runs. Both compute the
    embedding sum in bf16 and every matmul after the first LayerNorm in f32
    on the bf16-rounded weights (flax's promotion). Against the jitted call
    atol 5e-3: XLA's fusions move JAX's own bf16 logits by up to 2.6e-3
    from its op-by-op ones (measured on `bert_tiny`, seeds 0-3). The same
    port with its matmuls run in bf16 misses the op-by-op logits by 5e-3 or
    more: the test checks that too, so a port that ran its GEMMs in bf16
    fails it.
  - The loss and one AdamW step, port against JAX, f32: rtol 1e-5 on the
    loss, atol 1e-6 + rtol 1e-4 on the gradients (sums of up to 256 terms of
    about 1e-3 in another order), atol 1e-5 (1% of one step) on the
    updated weights wherever JAX's gradient exceeds 1e-6. Adam's first step
    moves a weight by lr g / (|g| + eps), about lr (1e-3) whatever |g|, so
    a gradient that is rounding noise (the key bias's, zero in exact
    arithmetic: softmax ignores a shift shared by a row's scores) moves its
    weight by +-lr with a random sign on either side; there the step is
    only held to its bound, lr (1 + decay |w|).
  - Segment-id attention, f32: atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import accelerate_tpu_torch as port
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.models import bert as jax_bert
from accelerate_tpu.ops import attention as jax_attention
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch.modeling import Model, PreparedModel
from accelerate_tpu_torch.models import bert as port_bert
from accelerate_tpu_torch.ops import attention as port_attention
from accelerate_tpu_torch.state import AcceleratorState, GradientState

SEQ = 32
BATCH = 8
F32_LOGITS = dict(atol=1e-5, rtol=0)
BF16_LOGITS = dict(atol=1e-5, rtol=0)
BF16_LOGITS_JITTED = dict(atol=5e-3, rtol=0)
LR, WD = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: a second OpenMP thread was seen to move `torch.exp`
    by about 1e-4 now and then on a shared CPU host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_state():
    for cls in (AcceleratorState, GradientState, JaxAcceleratorState, JaxGradientState, JaxPartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, JaxAcceleratorState, JaxGradientState, JaxPartialState):
        cls._reset_state()


@pytest.fixture(scope="module")
def weights():
    """(JAX bert_tiny bundle, numpy params, port config), one init per module."""
    jcfg = jax_bert.bert_tiny()
    jmodel = jax_bert.create_bert_model(jcfg, seq_len=SEQ)
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    cfg = port_bert.BertConfig(**dataclasses.asdict(jcfg))
    return jmodel, params, cfg


def _port_model(weights):
    _, params, cfg = weights
    model = port_bert.create_bert_model(cfg, device="cpu")
    model.load_state_dict(port_bert.bert_state_dict_from_flax(params, cfg))
    return model


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (BATCH, SEQ)).astype(np.int32)
    lengths = rng.integers(SEQ // 2, SEQ + 1, BATCH)
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)
    types = (np.arange(SEQ)[None, :] >= SEQ // 2).astype(np.int32).repeat(BATCH, 0)
    labels = rng.integers(0, 2, BATCH).astype(np.int64)
    return ids, mask, types, labels


@pytest.mark.parametrize("case", ["padding_mask", "no_mask", "token_types"])
def test_f32_logits_match_jax(weights, case):
    """Logits on carried-across weights, with a [B, S] 0/1 padding mask,
    with None (as the example passes), and with token types."""
    jmodel, params, _ = weights
    ids, mask, types, _ = _inputs()
    mask = mask if case == "padding_mask" else None
    types = types if case == "token_types" else None
    expect = np.asarray(jax.jit(jmodel.apply_fn)(jmodel.params, ids, mask, types))
    model = _port_model(weights)
    as_t = (lambda x: None if x is None else torch.as_tensor(x))
    with torch.no_grad():
        got = model(torch.as_tensor(ids), as_t(mask), as_t(types)).numpy()
    assert got.shape == (BATCH, 2)
    np.testing.assert_allclose(got, expect, **F32_LOGITS)


def _bf16_port_logits(weights, ids, mask, types):
    model = _port_model(weights)
    prepared = PreparedModel(Model(model, model.loss_fn), torch.device("cpu"), compute_dtype=torch.bfloat16)
    with torch.no_grad():
        return prepared(torch.as_tensor(ids), torch.as_tensor(mask), torch.as_tensor(types))


def test_bf16_logits_match_jax_and_run_the_matmuls_in_f32(weights, monkeypatch):
    """bf16 mixed precision: the port's logits follow JAX's dtype flow (bf16
    embedding sum, f32 LayerNorms, f32 matmuls on bf16-rounded weights).
    The same model with its Dense layers run in bf16 breaks the tolerance."""
    jmodel, _, _ = weights
    ids, mask, types, _ = _inputs(1)
    accelerator = JaxAccelerator(mixed_precision="bf16")
    jprepared = accelerator.prepare(dataclasses.replace(jmodel))
    expect = np.asarray(jprepared._mp_apply(jprepared.params, ids, mask, types))
    jitted = np.asarray(jprepared(ids, mask, types))
    got = _bf16_port_logits(weights, ids, mask, types)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expect, **BF16_LOGITS)
    np.testing.assert_allclose(got.numpy(), jitted, **BF16_LOGITS_JITTED)

    def bf16_dense(self, x):
        return torch.nn.functional.linear(x.bfloat16(), self.weight.bfloat16(), self.bias.bfloat16())

    monkeypatch.setattr(port_bert.Dense, "forward", bf16_dense)
    wrong = _bf16_port_logits(weights, ids, mask, types).numpy()
    assert np.abs(wrong - expect).max() > 5e-3


def test_loss_and_one_adamw_step_match_jax(weights):
    """`sequence_classification_loss` through `Accelerator.backward`, then one
    AdamW step (decay 1e-4 on both sides): the same loss and weights."""
    jmodel, _, cfg = weights
    ids, mask, types, labels = _inputs(2)
    batch = {"input_ids": ids, "attention_mask": mask, "token_type_ids": types, "labels": labels}

    accelerator = JaxAccelerator()
    jprepared, jopt = accelerator.prepare(dataclasses.replace(jmodel), optax.adamw(LR, weight_decay=WD))
    jloss = float(accelerator.backward(jprepared.loss, {k: jnp.asarray(v) for k, v in batch.items()}))
    jgrads = port_bert.bert_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jopt.grads), cfg)
    jopt.step()
    jparams = port_bert.bert_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jprepared.params), cfg)

    model = _port_model(weights)
    acc = port.Accelerator(cpu=True)
    prepared, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD))
    loss = float(acc.backward(prepared.loss, {k: torch.as_tensor(v) for k, v in batch.items()}))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), jgrads[name].numpy(), atol=1e-6, rtol=1e-4, err_msg=name)
    before = {name: p.detach().clone() for name, p in model.named_parameters()}
    opt.step()
    for name, value in model.named_parameters():
        value, start = value.detach().numpy(), before[name].numpy()
        signal = np.abs(jgrads[name].numpy()) > 1e-6
        np.testing.assert_allclose(value[signal], jparams[name].numpy()[signal], atol=1e-5, rtol=0, err_msg=name)
        assert np.all(np.abs(value - start) <= LR * (1 + WD * np.abs(start)) + 1e-7), name


@pytest.mark.parametrize("causal,hq,hkv", [(False, 4, 4), (True, 4, 2)], ids=["bidirectional", "causal_gqa"])
def test_segment_ids_attention_matches_jax(causal, hq, hkv):
    """Packed sequences: attention stays within equal segment ids, as in
    JAX's eager path, alone and with a causal mask and grouped heads."""
    rng = np.random.default_rng(3)
    b, s, d = 2, 24, 16
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    seg = np.sort(rng.integers(0, 3, (b, s)), axis=1).astype(np.int32)
    expect = np.asarray(jax_attention.dot_product_attention(q, k, v, causal=causal, segment_ids=seg))
    got = port_attention.dot_product_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                               causal=causal, segment_ids=torch.as_tensor(seg))
    assert port_attention.LAST_DISPATCH == "xla"
    np.testing.assert_allclose(got.numpy(), expect, atol=1e-6, rtol=0)
    mask = np.asarray(jax_attention_segment_mask(seg))
    np.testing.assert_array_equal(port_attention.segment_mask(torch.as_tensor(seg), torch.as_tensor(seg)).numpy(),
                                  mask)
    with pytest.raises(ValueError, match="segment_ids requires Sq == Skv"):
        port_attention.dot_product_attention(torch.as_tensor(q[:, :8]), torch.as_tensor(k), torch.as_tensor(v),
                                             segment_ids=torch.as_tensor(seg))
    with pytest.raises(ValueError, match="cannot honor a segment_ids argument"):
        port_attention.dot_product_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                             segment_ids=torch.as_tensor(seg), implementation="flash")


def jax_attention_segment_mask(seg):
    from accelerate_tpu.parallel.ring_attention import segment_mask

    return segment_mask(seg, seg)


def test_segment_ids_keep_the_flash_gate_shut():
    """A call with segment_ids never takes the flash kernels, whatever its
    length (JAX's gate), like a masked call."""
    assert port_attention.use_flash(None, False, 2048, 2048, True, True)
    assert not port_attention.use_flash(None, True, 2048, 2048, True, True)


def test_registry_builds_bert_by_family():
    """`create_named_model` dispatches by family: the BERT names build the
    classifier at the published widths (BERT-base: 109,483,778 parameters),
    from one seed the same weights twice."""
    base = port.models.MODEL_REGISTRY["bert-base"]()
    with torch.device("meta"):
        n = sum(p.numel() for p in port_bert.BertForSequenceClassification(base).parameters())
    assert n == 109_483_778
    tiny = port.create_named_model("bert-tiny", seed=4, device="cpu")
    again = port.create_named_model("bert-tiny", seed=4, device="cpu")
    assert isinstance(tiny, port_bert.BertForSequenceClassification)
    for (name, a), b in zip(tiny.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name


def test_random_init_follows_flax_distributions():
    """Dense weights lecun-normal truncated at two standard deviations
    (variance 1 / fan_in), biases zero, embeddings std 1/sqrt(hidden),
    LayerNorms ones and zeros; the flax init's statistics agree."""
    cfg = port_bert.bert_tiny()
    model = port_bert.create_bert_model(cfg, seed=0, device="cpu")
    up = model.bert.layers[0].mlp_up.weight.detach()
    std = cfg.hidden_size ** -0.5
    assert abs(float(up.std()) - std) < 0.03 * std
    assert float(up.abs().max()) <= 2 * std / port_bert._TRUNCATED_STD + 1e-6
    assert not model.bert.layers[0].mlp_up.bias.detach().any()
    emb = model.bert.word_embeddings.weight.detach()
    assert abs(float(emb.std()) - std) < 0.03 * std
    assert torch.equal(model.bert.embeddings_ln.weight, torch.ones(cfg.hidden_size))
    jparams = jax_bert.create_bert_model(jax_bert.bert_tiny(), seq_len=SEQ).params["params"]["bert"]
    jup = np.asarray(jparams["layer_0"]["mlp_up"]["kernel"])
    assert abs(float(jup.std()) - float(up.std())) < 0.03 * std
    assert abs(float(np.abs(jup).max()) - float(up.abs().max())) < 0.05 * std
