"""The port's weight quantization (`accelerate_tpu_torch.utils.quantization`)
held to `accelerate_tpu/utils/quantization.py` on the same numpy weights
(about 60 s on two threads).

int8, int4 and nf4 codes and scales equal JAX's bit for bit: on seeded
normal weights at several scales and shapes (padded blocks included), on
planted values (exact codebook entries, the midpoints between them and
their neighbours, zeros, a block of one value), and on every weight of a
carried `llama_tiny`. Dequantized weights equal JAX's within 1e-6 (the
same f32 products; JAX's jit may fuse them). The quantized model's logits
equal JAX's quantized apply within atol 1e-4 (the port's f32 tolerance
against JAX, `tests/test_torch_llama.py`), and JAX's own bounds hold:
int8 within half a step of the dense weight, 4-bit within a mean relative
error of 0.2, int8 logits agreeing with the dense ones on more than 90% of
top-1 positions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import llama as jax_llama
from accelerate_tpu.utils import quantization as J
from accelerate_tpu_torch.models import llama
from accelerate_tpu_torch.utils import quantization as P

KINDS = ("int8", "int4", "nf4")


@pytest.fixture(autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _w(shape, seed=0, scale=0.02):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _quantize(kind, w, block_size=64):
    jfn, pfn = getattr(J, f"quantize_{kind}"), getattr(P, f"quantize_{kind}")
    if kind == "int8":
        return jfn(jnp.asarray(w)), pfn(torch.from_numpy(w))
    return jfn(jnp.asarray(w), block_size=block_size), pfn(torch.from_numpy(w), block_size=block_size)


def _assert_same(jq, pq):
    assert (pq.kind, pq.shape, pq.pad, pq.block_size) == (jq.kind, tuple(jq.shape), jq.pad, jq.block_size)
    np.testing.assert_array_equal(pq.q.numpy(), np.asarray(jq.q))
    assert pq.q.dtype == {"int8": torch.int8}.get(jq.kind, torch.uint8)
    np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(jq.scale))
    assert pq.nbytes_quantized == jq.nbytes_quantized


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,scale", [((64, 32), 0.02), ((48, 32), 1.0), ((5, 7), 0.02), ((3, 40, 24), 50.0),
                                         ((200, 130), 1e-3), ((128,), 1.0)])
def test_codes_and_scales_equal_jax(kind, shape, scale):
    jq, pq = _quantize(kind, _w(shape, seed=len(shape), scale=scale))
    _assert_same(jq, pq)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = P.dequantize_entry(pq, dtype).float().numpy()
        want = np.asarray(J.dequantize_entry(jq, jdtype).astype(jnp.float32))
        np.testing.assert_allclose(got, want, atol=1e-6 if dtype == torch.float32 else 0, rtol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_planted_values_and_block_sizes_equal_jax(kind):
    """Codebook entries, the midpoints between neighbours and the floats on
    either side of each, zeros and a constant block: the ties and edges
    where a nearest-entry search can differ."""
    code = J.NF4_CODE
    mids = ((code[:-1] + code[1:]) / 2).astype(np.float32)
    planted = np.concatenate([code, mids, np.nextafter(mids, np.float32(2)), np.nextafter(mids, np.float32(-2)),
                              -mids, np.zeros(5, np.float32), np.full(64, 0.37, np.float32)]).astype(np.float32)
    w = np.concatenate([[1.0], planted, _w((211,), seed=9)]).astype(np.float32).reshape(-1, 1)
    for block in (16, 64, 128):
        _assert_same(*_quantize(kind, w, block))


def test_round_trip_bounds_of_the_reference():
    w = _w((64, 32))
    q = P.quantize_int8(torch.from_numpy(w))
    err = np.abs(q.dequantize(torch.float32).numpy() - w)
    assert (err <= np.abs(w).max(axis=0) / 127.0 * 0.5001 + 1e-8).all()
    for kind in ("int4", "nf4"):
        w = _w((48, 32), seed=1)
        q = getattr(P, f"quantize_{kind}")(torch.from_numpy(w), block_size=64)
        deq = q.dequantize(torch.float32).numpy()
        assert np.abs(deq - w).mean() / np.abs(w).mean() < 0.2
        assert q.nbytes_quantized == w.size // 2 + (w.size // 64) * 4


def test_config_validation_and_skip_rules():
    with pytest.raises(ValueError):
        P.QuantizationConfig(load_in_8bit=True, load_in_4bit=True)
    with pytest.raises(ValueError):
        P.QuantizationConfig(load_in_4bit=True, quant_type="fp4")
    params = {"params/layer_0/kernel": _w((16, 16)), "params/lm_head/kernel": _w((16, 8)), "params/norm/scale": _w((16,))}
    cfg = P.QuantizationConfig(load_in_8bit=True, skip_modules=["lm_head"])
    jtree = {"params": {"layer_0": {"kernel": jnp.asarray(params["params/layer_0/kernel"])},
                        "lm_head": {"kernel": jnp.asarray(params["params/lm_head/kernel"])},
                        "norm": {"scale": jnp.asarray(params["params/norm/scale"])}}}
    jq = J.quantize_params(jtree, J.QuantizationConfig(load_in_8bit=True, skip_modules=["lm_head"]))
    pq = P.quantize_params({k: torch.from_numpy(v) for k, v in params.items()}, cfg)
    assert [P.is_quant_entry(pq[k]) for k in params] == [True, False, False]
    assert isinstance(jq["params"]["layer_0"]["kernel"], J.QuantTensor)
    assert P.quantized_nbytes(pq) == J.quantized_nbytes(jq)
    np.testing.assert_array_equal(P.dequantize_params(pq, torch.float32)["params/lm_head/kernel"].numpy(),
                                  params["params/lm_head/kernel"])
    assert not P.QuantizationConfig().enabled


@pytest.fixture(scope="module")
def llama_pair():
    jmodel = jax_llama.create_llama_model(jax_llama.llama_tiny(), seq_len=16)
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    cfg = llama.llama_tiny()

    def fresh():
        model = llama.LlamaForCausalLM(cfg)
        model.load_state_dict(llama.llama_state_dict_from_flax(params, cfg))
        return model.eval()

    return jmodel, fresh


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_quantized_llama_equals_jax(llama_pair, kind):
    """Every weight of a carried llama_tiny quantized in its flax layout:
    JAX's codes, scales and byte count; the quantized model's logits
    within atol 1e-4 of JAX's quantized apply (dequantized to f32)."""
    jmodel, fresh = llama_pair
    kw = {"int8": dict(load_in_8bit=True), "int4": dict(load_in_4bit=True, quant_type="int4"),
          "nf4": dict(load_in_4bit=True, quant_type="nf4")}[kind]
    jq = J.load_and_quantize_model(jmodel, J.QuantizationConfig(compute_dtype=jnp.float32, **kw))
    pq = P.load_and_quantize_model(fresh(), P.QuantizationConfig(compute_dtype=torch.float32, **kw))
    jflat = _flat(jq.params)
    assert sorted(pq.qparams) == sorted(jflat)
    for path, entry in pq.qparams.items():
        if P.is_quant_entry(entry):
            _assert_same(jflat[path], entry)
        else:
            np.testing.assert_array_equal(entry.numpy(), np.asarray(jflat[path]))
    assert P.quantized_nbytes(pq.qparams) == J.quantized_nbytes(jq.params)
    assert all(p.is_meta for n, p in pq.module.named_parameters() if p.dim() >= 2)
    ids = np.random.default_rng(0).integers(1, 500, (2, 16)).astype(np.int32)
    want = np.asarray(jq.apply_fn(jq.params, ids))
    with torch.no_grad():
        got = pq(torch.as_tensor(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if kind == "int8":
        dense = np.asarray(jmodel.apply_fn(jmodel.params, ids))
        assert (got.argmax(-1) == dense.argmax(-1)).mean() > 0.9


def test_bf16_compute_dtype_by_default(llama_pair):
    _, fresh = llama_pair
    pq = P.load_and_quantize_model(fresh(), P.QuantizationConfig(load_in_8bit=True))
    assert pq.compute_dtype == torch.bfloat16
    assert {t.dtype for t in pq.dequantized().values()} == {torch.bfloat16}
    with torch.no_grad():
        assert torch.isfinite(pq(torch.arange(8)[None]).float()).all()
    model = fresh()
    assert P.load_and_quantize_model(model, P.QuantizationConfig()) is model
