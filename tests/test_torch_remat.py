"""Activation checkpointing of the port (`accelerate_tpu_torch/ops/remat.py`)
on `llama_tiny` and `bert_tiny`: the policies change the program (what is
saved for the backward, what runs again in it) and nothing of the function.

Tolerances:
  - Under any policy, port against the port without remat: rtol 1e-6 on
    the loss and every gradient. The recompute runs the same operations on
    the same inputs; what it saves it saved from the same forward.
  - The port's remat gradients against JAX's under `remat_scope` on
    carried-across weights, f32: atol 1e-5, the f32 parity of the port's
    Llama and BERT tests.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import accelerate_tpu_torch as port
from accelerate_tpu.models import bert as jax_bert
from accelerate_tpu.models import llama as jax_llama
from accelerate_tpu.ops import remat as jax_remat
from accelerate_tpu_torch.modeling import Model, PreparedModel
from accelerate_tpu_torch.models import bert as port_bert
from accelerate_tpu_torch.models import llama as port_llama
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops import remat
from accelerate_tpu_torch.state import AcceleratorState, GradientState

SEQ = 16
BATCH = 2
SAME = dict(rtol=1e-6, atol=0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: a second OpenMP thread was seen to move `torch.exp`
    by about 1e-4 now and then on a shared CPU host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_port_state():
    AcceleratorState._reset_state()
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state()
    GradientState._reset_state()


@pytest.fixture(scope="module")
def flax_weights():
    """family -> (JAX bundle, numpy params, port config), one init per module."""
    out = {}
    jm = jax_llama.create_llama_model(jax_llama.llama_tiny(), seq_len=SEQ)
    cfg = port_llama.LlamaConfig(**{f.name: getattr(jm.module.config, f.name)
                                    for f in dataclasses.fields(port_llama.LlamaConfig)})
    out["llama"] = (jm, jax.tree_util.tree_map(np.asarray, jm.params), cfg)
    jm = jax_bert.create_bert_model(jax_bert.bert_tiny(), seq_len=SEQ)
    out["bert"] = (jm, jax.tree_util.tree_map(np.asarray, jm.params),
                   port_bert.BertConfig(**dataclasses.asdict(jm.module.config)))
    return out


def _batch(family, seed=0):
    rng = np.random.default_rng(seed)
    if family == "llama":
        return {"input_ids": rng.integers(0, 512, (BATCH, SEQ)).astype(np.int64)}
    mask = np.ones((BATCH, SEQ), np.int64)
    mask[0, SEQ // 2:] = 0
    return {"input_ids": rng.integers(0, 1024, (BATCH, SEQ)).astype(np.int64), "attention_mask": mask,
            "token_type_ids": (np.arange(SEQ)[None] >= SEQ // 2).astype(np.int64).repeat(BATCH, 0),
            "labels": rng.integers(0, 2, BATCH).astype(np.int64)}


def _model(family, flax_weights=None):
    if flax_weights is None:
        if family == "llama":
            return port_llama.create_llama_model(port_llama.llama_tiny(), seed=1, device="cpu")
        return port_bert.create_bert_model(port_bert.bert_tiny(), seed=1, device="cpu")
    _, params, cfg = flax_weights[family]
    if family == "llama":
        model = port_llama.create_llama_model(cfg, device="cpu")
        model.load_state_dict(port_llama.llama_state_dict_from_flax(params, cfg))
    else:
        model = port_bert.create_bert_model(cfg, device="cpu")
        model.load_state_dict(port_bert.bert_state_dict_from_flax(params, cfg))
    return model


def _loss_and_grads(family, policy, compute_dtype=None, flax_weights=None):
    model = _model(family, flax_weights)
    prepared = PreparedModel(Model(model, model.loss_fn), torch.device("cpu"), compute_dtype=compute_dtype,
                             remat_policy=policy)
    loss = prepared.loss({k: torch.as_tensor(v) for k, v in _batch(family).items()})
    loss.backward()
    return float(loss.detach()), {name: p.grad for name, p in model.named_parameters()}


@pytest.mark.parametrize("policy", remat.POLICY_NAMES)
@pytest.mark.parametrize("family", ["llama", "bert"])
def test_policies_keep_the_loss_and_every_gradient(family, policy):
    """f32: each policy gives the loss and every gradient of the forward
    without remat."""
    base_loss, base = _loss_and_grads(family, None)
    loss, grads = _loss_and_grads(family, policy)
    np.testing.assert_allclose(loss, base_loss, **SAME)
    for name, g in grads.items():
        torch.testing.assert_close(g, base[name], **SAME, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("family", ["llama", "bert"])
def test_bf16_remat_takes_the_compute_copies_into_the_recompute(family):
    """Under bf16 `PreparedModel` runs the forward on bf16 copies and swaps
    the f32 masters back before the backward; the recompute still runs on
    the bf16 copies, so the gradients are the no-remat ones."""
    base_loss, base = _loss_and_grads(family, None, torch.bfloat16)
    for policy in ("full", "dots"):
        loss, grads = _loss_and_grads(family, policy, torch.bfloat16)
        assert loss == base_loss
        for name, g in grads.items():
            assert g.dtype == torch.float32
            torch.testing.assert_close(g, base[name], **SAME, msg=lambda m: f"{policy} {name}: {m}")


@pytest.mark.parametrize("family", ["llama", "bert"])
def test_remat_gradients_match_jax_remat_scope(flax_weights, family):
    """The port's gradients under `full` and `dots` against JAX's under its
    `remat_scope`, on the same weights and batch."""
    jm, _, cfg = flax_weights[family]
    batch = _batch(family)
    jbatch = {k: v.astype(np.int32) if k != "labels" else v for k, v in batch.items()}
    loss_fn = jax_llama.causal_lm_loss if family == "llama" else jax_bert.sequence_classification_loss
    convert = port_llama.llama_state_dict_from_flax if family == "llama" else port_bert.bert_state_dict_from_flax
    for policy in ("full", "dots"):
        with jax_remat.remat_scope(policy):
            jgrads = jax.jit(jax.grad(lambda p: loss_fn(p, jbatch, jm.apply_fn)))(jm.params)
        expect = convert(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
        _, grads = _loss_and_grads(family, policy, flax_weights=flax_weights)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), expect[name].numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"{policy} {name}")


def _saved_bytes(family, policy):
    model = _model(family)
    prepared = PreparedModel(Model(model, model.loss_fn), torch.device("cpu"), remat_policy=policy)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = prepared.loss({k: torch.as_tensor(v) for k, v in _batch(family).items()})
    loss.backward()
    return sum(saved)


@pytest.mark.parametrize("policy", remat.POLICY_NAMES)
def test_policies_save_fewer_bytes_for_the_backward(policy):
    """Bytes the forward hands autograd to keep (outside the checkpointed
    layers: the layers' own saves go to the checkpoint) are fewer under any
    policy than without remat, on both families. `full` and `dots` are not
    ordered here: selective checkpointing keeps its saved matmul outputs in
    its own storage, which these hooks do not see; on the card, peak memory
    orders them (`chip_smoke.py`'s remat phase)."""
    for family in ("llama", "bert"):
        assert _saved_bytes(family, policy) < _saved_bytes(family, None), family


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(policy):
    model = _model("bert")
    prepared = PreparedModel(Model(model, model.loss_fn), torch.device("cpu"), remat_policy=policy)
    loss = prepared.loss({k: torch.as_tensor(v) for k, v in _batch("bert").items()})
    counter = _OpCounter()
    with counter:
        loss.backward()
    return counter.counts


def test_policies_recompute_what_they_do_not_save():
    """Ops run during the backward, beyond those of the backward without
    remat: under `full` the forward's matmuls (addmm of each Dense, bmm of
    the scores) run again; under `dots` none does and only the elementwise
    chain (gelu, the softmax's exp) runs again; under
    `dots_with_no_batch_dims` the batched score products run again and the
    Dense matmuls do not (JAX's `test_fsdp_knobs.py` counterpart)."""
    base = _backward_ops(None)
    layers = port_bert.bert_tiny().num_hidden_layers
    extra = {policy: {k: n - base.get(k, 0) for k, n in _backward_ops(policy).items() if n != base.get(k, 0)}
             for policy in ("full", "dots", "dots_with_no_batch_dims")}
    assert "gelu" not in base
    assert extra["full"]["addmm"] == 4 * layers  # qkv, attn_out, mlp_up, mlp_down
    assert extra["full"]["bmm"] == 2 * layers  # q . k and p . v
    assert extra["full"]["gelu"] == layers
    assert not {"mm", "addmm", "bmm", "baddbmm"} & set(extra["dots"])
    assert extra["dots"]["gelu"] == layers and extra["dots"]["exp"] == layers
    assert "addmm" not in extra["dots_with_no_batch_dims"]
    assert extra["dots_with_no_batch_dims"]["bmm"] == 2 * layers


@pytest.mark.parametrize("policy", [None, "full", "dots"])
def test_flash_forward_runs_again_under_remat(monkeypatch, policy):
    """With the flash path forced (its plain versions on the CPU), a remat
    policy runs the forward once more per layer in the backward and the
    backward pieces once, on the recomputed o and lse; without remat the
    three run equally often. The card's launch counts are gated the same
    way in `chip_smoke.py`. Loss and gradients stay those without remat."""
    calls = {"fwd": 0, "dkv": 0, "dq": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(fa, "flash_fwd_reference", counted("fwd", fa.flash_fwd_reference))
    monkeypatch.setattr(fa, "flash_bwd_dkv_reference", counted("dkv", fa.flash_bwd_dkv_reference))
    monkeypatch.setattr(fa, "flash_bwd_dq_reference", counted("dq", fa.flash_bwd_dq_reference))
    monkeypatch.setenv("ACCELERATE_TPU_ATTENTION_IMPL", "flash")
    loss, grads = _loss_and_grads("llama", policy)
    layers = port_llama.llama_tiny().num_hidden_layers
    assert calls == {"fwd": layers * (1 if policy is None else 2), "dkv": layers, "dq": layers}
    monkeypatch.setenv("ACCELERATE_TPU_ATTENTION_IMPL", "xla")
    base_loss, base = _loss_and_grads("llama", None)
    np.testing.assert_allclose(loss, base_loss, rtol=1e-5)
    for name, g in grads.items():
        torch.testing.assert_close(g, base[name], rtol=1e-4, atol=1e-6, msg=lambda m: f"{name}: {m}")


def test_generate_under_a_scope_saves_nothing_and_keeps_its_tokens():
    """`generate` runs under no_grad: inside an active scope it checkpoints
    nothing, hands autograd nothing to keep, and gives the same tokens."""
    model = _model("llama")
    ids = torch.as_tensor(_batch("llama")["input_ids"][:, :8])
    expect = port.generate(model, ids, max_new_tokens=6, device="cpu")
    saved = []
    with remat.remat_scope("full"), torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        got = port.generate(model, ids, max_new_tokens=6, device="cpu")
    assert torch.equal(got, expect)
    assert saved == []


def test_unknown_policy_raises_as_jax_does():
    """An unknown name raises JAX's ValueError, from the scope, from
    `PreparedModel` and from `Accelerator.prepare`; None turns remat off."""
    with pytest.raises(ValueError) as jax_error:
        with jax_remat.remat_scope("everything"):
            pass
    with pytest.raises(ValueError) as error:
        with remat.remat_scope("everything"):
            pass
    assert str(error.value) == str(jax_error.value)
    assert remat.POLICY_NAMES == jax_remat.POLICY_NAMES
    model = _model("llama")
    with pytest.raises(ValueError, match="remat policy must be one of"):
        PreparedModel(Model(model, model.loss_fn), torch.device("cpu"), remat_policy="everything")
    accelerator = port.Accelerator(cpu=True, compilation_config=port.CompilationConfig(remat_policy="everything"))
    with pytest.raises(ValueError, match="remat policy must be one of"):
        accelerator.prepare(model)
    with remat.remat_scope(None):
        assert remat.active_remat_policy() is None
    with remat.remat_scope():
        assert remat.active_remat_policy() == "full"
    assert remat.active_remat_policy() is None


def _train(policy, steps=3):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    model = _model("llama")
    accelerator = port.Accelerator(cpu=True, compilation_config=port.CompilationConfig(remat_policy=policy))
    data = [{"input_ids": row} for row in np.random.default_rng(5).integers(0, 512, (4 * steps, SEQ))]
    prepared, _, loader = accelerator.prepare(
        model, torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4),
        port.SimpleDataLoader(data, port.BatchSampler(range(len(data)), 4)))
    assert prepared.remat_policy == policy
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    return [float(step_fn(batch)) for batch in loader], model


def test_compilation_config_checkpoints_the_fused_train_step():
    """`Accelerator(compilation_config=CompilationConfig(remat_policy=...))`
    reaches the prepared model; the fused step trains to the same losses
    and weights as without it."""
    base_losses, base = _train(None)
    for policy in ("full", "dots"):
        losses, model = _train(policy)
        np.testing.assert_allclose(losses, base_losses, **SAME)
        for (name, p), q in zip(model.named_parameters(), base.parameters()):
            torch.testing.assert_close(p, q, **SAME, msg=lambda m: f"{policy} {name}: {m}")
