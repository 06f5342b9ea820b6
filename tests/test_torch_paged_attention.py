"""The port's paged-decode and block-verify attention (`accelerate_tpu_torch.ops`)
held against the JAX kernels they replace.

The JAX side runs `paged_decode_attention` / `paged_verify_attention` with
``interpret=None``, which interprets the Pallas kernels off-TPU, exactly as
`tests/test_paged_kernel.py` runs them. On CPU tensors the port's wrappers
run their plain PyTorch version, which is what these tests pin; the CUDA
kernel is held against that plain version on the card
(`tests/test_torch_cuda.py` and `chip_smoke.py`).

Tolerances are the JAX tests' own (`tests/test_paged_kernel.py`): f32 atol
2e-5 (the two sides sum the same fp32 products in another order), bf16
atol/rtol 3e-2 (bf16 operands carry ~8 bits of mantissa; accumulation is f32
on both sides).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accelerate_tpu.ops.paged_attention import (
    paged_decode_attention as jax_decode,
    paged_verify_attention as jax_verify,
)
from accelerate_tpu_torch.ops import paged_attention as port
from accelerate_tpu_torch.ops.attention import slot_cache_attention, write_slot_pool

torch.set_num_threads(2)

F32_ATOL = 2e-5
BF16_TOL = 3e-2


def _case(seed, B, s, Hq, Hkv, D, P, page_size, positions, shuffle=True, shared_prefix=0):
    """Pools, a page table and queries made with numpy from `seed`. Pages
    1..N-1 are handed out in a shuffled order (page 0 is the scratch page);
    the first `shared_prefix` table entries of every row are the same pages,
    the prefix cache's layout."""
    rng = np.random.default_rng(seed)
    n_private = B * (P - shared_prefix)
    N = 1 + shared_prefix + n_private
    pages = np.arange(1, N)
    if shuffle:
        pages = rng.permutation(pages)
    shared, private = pages[:shared_prefix], pages[shared_prefix:].reshape(B, P - shared_prefix)
    table = np.concatenate([np.broadcast_to(shared, (B, shared_prefix)), private], axis=1)
    k = rng.normal(size=(N, page_size, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(N, page_size, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(B, s, Hq, D)).astype(np.float32)
    pos = np.asarray(positions, np.int32).reshape(B, s)
    return q, k, v, table.astype(np.int32), pos


def _run_jax(q, k, v, table, pos, dtype=jnp.float32):
    fn = jax_decode if q.shape[1] == 1 else jax_verify
    out = fn(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        jnp.asarray(table), jnp.asarray(pos),
    )
    return np.asarray(out.astype(jnp.float32))


def _run_port(q, k, v, table, pos, dtype=torch.float32):
    fn = port.paged_decode_attention if q.shape[1] == 1 else port.paged_verify_attention
    out = fn(
        torch.as_tensor(q).to(dtype), torch.as_tensor(k).to(dtype), torch.as_tensor(v).to(dtype),
        torch.as_tensor(table), torch.as_tensor(pos),
    )
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("page_size", [4, 8, 16])
def test_decode_matches_jax_f32(page_size):
    """Ragged lengths (first cell, a page boundary, mid-window, full window),
    GQA (Hq 4 over Hkv 2) and a shuffled page table."""
    B, P = 4, 3
    L = P * page_size
    case = _case(10 + page_size, B, 1, 4, 2, 8, P, page_size, [0, page_size - 1, L // 2, L - 1])
    np.testing.assert_allclose(_run_port(*case), _run_jax(*case), atol=F32_ATOL)


def test_decode_matches_jax_bf16():
    case = _case(1, 3, 1, 4, 2, 8, 3, 4, [3, 7, 11])
    np.testing.assert_allclose(
        _run_port(*case, dtype=torch.bfloat16),
        _run_jax(*case, dtype=jnp.bfloat16),
        atol=BF16_TOL, rtol=BF16_TOL,
    )


@pytest.mark.parametrize("s", [2, 4, 5])
def test_verify_matches_jax_f32(s):
    """The [B, s] block: query j of row b attends cols <= pos[b] + j."""
    base = np.array([0, 5, 9], np.int32)
    pos = base[:, None] + np.arange(s, dtype=np.int32)[None, :]
    case = _case(20 + s, 3, s, 4, 2, 8, 4, 4, pos)
    np.testing.assert_allclose(_run_port(*case), _run_jax(*case), atol=F32_ATOL)


def test_verify_matches_jax_bf16():
    pos = np.array([3, 12], np.int32)[:, None] + np.arange(5, dtype=np.int32)[None, :]
    case = _case(2, 2, 5, 4, 2, 8, 3, 8, pos)
    np.testing.assert_allclose(
        _run_port(*case, dtype=torch.bfloat16),
        _run_jax(*case, dtype=jnp.bfloat16),
        atol=BF16_TOL, rtol=BF16_TOL,
    )


def test_mha_no_gqa_grouping():
    """Hq == Hkv (G = 1) walks the same code."""
    case = _case(3, 2, 1, 4, 4, 8, 2, 4, [2, 6])
    np.testing.assert_allclose(_run_port(*case), _run_jax(*case), atol=F32_ATOL)


def test_poisoned_scratch_page_contributes_nothing():
    """Table entries past a slot's reservation point at scratch page 0;
    poisoning it must not move a single output bit, and both sides agree."""
    q, k, v, _, _ = _case(4, 2, 1, 4, 2, 8, 4, 4, [0, 0])
    table = np.array([[1, 2, 0, 0], [3, 0, 0, 0]], np.int32)
    pos = np.array([[6], [2]], np.int32)
    clean = _run_port(q, k, v, table, pos)
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[0], v_bad[0] = 1e4, 1e4
    np.testing.assert_array_equal(clean, _run_port(q, k_bad, v_bad, table, pos))
    np.testing.assert_allclose(clean, _run_jax(q, k_bad, v_bad, table, pos), atol=F32_ATOL)


@pytest.mark.parametrize("s", [1, 5])
def test_shared_prefix_pages_read_identically(s):
    """Rows whose tables share their first two pages (a cached system
    prompt) read them as if private."""
    pos = np.array([10, 13], np.int32)[:, None] + np.arange(s, dtype=np.int32)[None, :]
    case = _case(5, 2, s, 4, 2, 8, 5, 4, pos, shared_prefix=2)
    assert (case[3][0, :2] == case[3][1, :2]).all()
    np.testing.assert_allclose(_run_port(*case), _run_jax(*case), atol=F32_ATOL)


def test_table_entries_clip_to_the_pool():
    """Out-of-range table entries clip to [0, num_pages - 1], as the JAX
    wrapper clips them."""
    q, k, v, table, pos = _case(6, 2, 1, 4, 2, 8, 3, 4, [9, 5])
    table = table.copy()
    table[0, 1] = 1000
    table[1, 0] = -7
    np.testing.assert_allclose(_run_port(q, k, v, table, pos), _run_jax(q, k, v, table, pos), atol=F32_ATOL)


@pytest.mark.parametrize("s", [1, 3])
def test_slot_cache_attention_gather_and_paged_kernel_agree(s):
    """The two read paths of `slot_cache_attention` share one write half and
    agree on every output, including a position past capacity (clipped)."""
    rng = np.random.default_rng(7 + s)
    B, Hq, Hkv, D, P, ps = 3, 4, 2, 8, 3, 4
    N = B * P + 1
    table = torch.as_tensor(rng.permutation(np.arange(1, N)).reshape(B, P).astype(np.int32))
    pos = torch.as_tensor(np.array([0, 5, P * ps - 2], np.int64)[:, None] + np.arange(s)[None, :])
    q = torch.as_tensor(rng.normal(size=(B, s, Hq, D)).astype(np.float32))
    k = torch.as_tensor(rng.normal(size=(B, s, Hkv, D)).astype(np.float32))
    v = torch.as_tensor(rng.normal(size=(B, s, Hkv, D)).astype(np.float32))
    base = torch.as_tensor(rng.normal(size=(N, ps, Hkv, D)).astype(np.float32))
    outs = {}
    for impl in ("gather", "paged_kernel"):
        k_pool, v_pool = base.clone(), base.clone() * 0.5
        outs[impl] = slot_cache_attention(q, k, v, k_pool, v_pool, pos, table, impl)
    torch.testing.assert_close(outs["gather"], outs["paged_kernel"], atol=F32_ATOL, rtol=0)
    assert port.LAUNCHES == dict.fromkeys(port.LAUNCHES, 0), "CPU tensors never reach the kernel"
    assert {"decode", "verify"} <= set(port.LAUNCHES)


def test_write_slot_pool_scatters_through_the_table():
    """K/V of row b, token j lands at pool[table[b, pos // ps], pos % ps]
    after clipping pos to [0, L - 1]."""
    B, s, Hkv, D, P, ps = 2, 2, 2, 4, 2, 4
    table = torch.tensor([[3, 1], [2, 4]], dtype=torch.int32)
    pos = torch.tensor([[1, 6], [7, 50]])
    k = torch.arange(B * s * Hkv * D, dtype=torch.float32).reshape(B, s, Hkv, D)
    k_pool, v_pool = torch.zeros(5, ps, Hkv, D), torch.zeros(5, ps, Hkv, D)
    clipped = write_slot_pool(k_pool, v_pool, k, -k, pos, table)
    assert clipped.dtype == torch.int32 and clipped.tolist() == [[1, 6], [7, 7]]
    torch.testing.assert_close(k_pool[3, 1], k[0, 0])
    torch.testing.assert_close(k_pool[1, 2], k[0, 1])
    torch.testing.assert_close(v_pool[4, 3], -k[1, 1])  # pos 50 clipped to 7


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, table, pos = (torch.as_tensor(x) for x in _case(8, 2, 1, 4, 2, 8, 2, 4, [1, 2]))
    with pytest.raises(ValueError, match=r"\[B, 1, Hq, D\]"):
        port.paged_decode_attention(q.expand(2, 2, 4, 8), k, v, table, pos)
    with pytest.raises(ValueError, match="GQA"):
        port.paged_decode_attention(q[:, :, :3], k, v, table, pos)
    # The CUDA launch path checks dtypes, contiguity and alignment before it
    # ever builds the library.
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port._launch("decode", q.half(), k.half(), v.half(), table, pos, 1.0)
    with pytest.raises(ValueError, match="int32"):
        port._launch("decode", q, k, v, table.long(), pos, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        port._launch("decode", q, k.transpose(0, 1), v, table, pos, 1.0)
