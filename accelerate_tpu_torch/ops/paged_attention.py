"""Paged-KV attention for serving: single-query decode and the speculative
block-verify, read straight off the page pool.

Port of `accelerate_tpu/ops/paged_attention.py`. On CUDA tensors each public
function launches the hand-written Hopper kernels in `csrc/paged_attention.cu`:
one thread block per (KV head, slot, split of the slot's pages) walks that
split's page-table entries and writes its rows' partial softmax state to a
workspace, and a merge kernel combines each slot's splits. On CPU tensors it
runs `paged_attention_reference`, the plain PyTorch version of the same
function that the tests and `chip_smoke.py` hold the kernel against. Nothing
falls back: a CUDA tensor the kernel does not take raises, and so does a
kernel that fails to build or launch.

The split length comes from the page size alone (`split_tokens`), never from
positions, so a launch reads nothing back to the host.
`paged_attention_split_emulation` repeats the kernels' arithmetic in plain
PyTorch (per-split partials, p rounded to bf16 for bf16 queries, the merge)
for the tests and `chip_smoke.py`; no entry point calls it.

Quantized pools (``k_scale``/``v_scale``, `ops/quantization.py`): int8 or
fp8-e4m3 pages with ``[num_pages, Hkv]`` f32 per-page-per-head scales. The
kernel's fused-dequant mode reads one byte per cached value and multiplies by
the page's scale inside the page walk; no dequantized copy of the pool is
made on the card. The plain version dequantizes the gathered pages, then
attends.

Contract (the JAX package's): query j of slot b attends ``cols <= positions[b, j]``
of its logical cache, whose page p is pool page ``page_table[b, p]`` (clipped
to ``[0, num_pages - 1]``); the pools already hold this dispatch's K/V writes;
query head ``h * G + g`` rides KV head ``h`` (G = Hq // Hkv, contiguous
groups). Rows of inactive slots point at scratch page 0 and come out finite.

`LAUNCHES` counts kernel launches, one per call that reached the kernel, by
kernel and pool storage type (``decode``, ``decode_int8``, ...).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from .flash_common import NEG_INF
from .quantization import E4M3, dequantize_kv_pages

#: Quantized pool storage dtypes the kernel takes: name and kernel code.
_KV_CODES = {torch.int8: ("int8", 0), E4M3: ("fp8_e4m3", 1)}

#: Kernel launches since the last reset, by kernel and quantized pool type.
LAUNCHES: Dict[str, int] = {
    key: 0
    for kind in ("decode", "verify")
    for key in (kind, *(f"{kind}_{name}" for name, _ in _KV_CODES.values()))
}

#: Shared memory a block may use on Hopper (232,448 bytes).
_MAX_SHARED_BYTES = 232448

#: Tokens of a kernel tile (whole pages, or one page when a page is larger)
#: and of a split (whole tiles): `csrc/paged_attention.cu`'s kTileTokens and
#: the split the wrapper passes it.
TILE_TOKENS = 64
SPLIT_TOKENS = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launch_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def tile_tokens(page_size: int) -> int:
    """Tokens of one tile: whole pages, at most TILE_TOKENS of them unless a
    single page is larger."""
    return page_size if page_size >= TILE_TOKENS else (TILE_TOKENS // page_size) * page_size


def split_tokens(page_size: int) -> int:
    """Tokens of one split: whole tiles, SPLIT_TOKENS or the nearest
    multiple of the tile below it (one tile at least)."""
    tile = tile_tokens(page_size)
    return tile * max(1, SPLIT_TOKENS // tile)


def num_splits(pages_per_slot: int, page_size: int, split: int) -> int:
    return -(-pages_per_slot // (split // page_size))


def _lib():
    from ._build import load

    lib = load("paged_attention")
    if lib.paged_decode_launch.argtypes is None:
        lib.paged_decode_launch.argtypes = [_P] * 7 + [_I] * 8 + [_F, _I, _P]
        lib.paged_decode_launch.restype = ctypes.c_int
        lib.paged_verify_launch.argtypes = [_P] * 7 + [_I] * 9 + [_F, _I, _P]
        lib.paged_verify_launch.restype = ctypes.c_int
        lib.paged_decode_quant_launch.argtypes = [_P] * 9 + [_I] * 8 + [_F, _I, _I, _P]
        lib.paged_decode_quant_launch.restype = ctypes.c_int
        lib.paged_verify_quant_launch.argtypes = [_P] * 9 + [_I] * 9 + [_F, _I, _I, _P]
        lib.paged_verify_quant_launch.restype = ctypes.c_int
        lib.paged_attention_shared_bytes.argtypes = [_I] * 8
        lib.paged_attention_shared_bytes.restype = ctypes.c_ulonglong
        lib.paged_attention_error_string.argtypes = [_I]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def paged_attention_reference(q, k_pool, v_pool, page_table, positions, scale=None,
                              k_scale=None, v_scale=None):
    """The plain version of both kernels: gather every slot's pages into a
    logical [B, L, Hkv, D] buffer (dequantized to f32 with their page scales
    for a quantized pool), mask ``cols <= positions[b, j]`` with NEG_INF, f32
    softmax, output in q's dtype."""
    b, s, hq, d = q.shape
    n, ps, hkv, _ = k_pool.shape
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    table = page_table.long().clamp(0, n - 1)
    length = table.shape[1] * ps
    k, v = k_pool[table], v_pool[table]  # [B, P, ps, Hkv, D]
    if k_scale is not None:
        k = dequantize_kv_pages(k, k_scale[table], torch.float32)
        v = dequantize_kv_pages(v, v_scale[table], torch.float32)
    k = k.reshape(b, length, hkv, d).float()
    v = v.reshape(b, length, hkv, d).float()
    qg = q.float().reshape(b, s, hkv, g, d)
    scores = torch.einsum("bshgd,blhd->bhsgl", qg, k) * scale
    cols = torch.arange(length, device=q.device)
    visible = cols[None, None, :] <= positions.reshape(b, s, 1).long()  # [B, s, L]
    scores = scores.masked_fill(~visible[:, None, :, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhsgl,blhd->bshgd", probs, v)
    return out.reshape(b, s, hq, d).to(q.dtype)


def split_partials(q, k_pool, v_pool, page_table, positions, scale=None, k_scale=None,
                   v_scale=None, split=None, p_terms=2):
    """Per-split partials of the kernels' arithmetic in plain PyTorch (see
    `paged_attention_split_emulation`): (m, l, acc, ran) with m and l
    [B, Hkv, s, G, n_split], acc [B, Hkv, s, G, n_split, D], all f32, and
    ran [B, n_split], the splits a launch runs."""
    b, s, hq, d = q.shape
    n, ps, hkv, _ = k_pool.shape
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    split = split or split_tokens(ps)
    table = page_table.long().clamp(0, n - 1)
    pages = table.shape[1]
    n_split = num_splits(pages, ps, split)
    length, total = pages * ps, n_split * split
    k = k_pool[table].reshape(b, length, hkv, d).float()  # stored values: codes when quantized
    v = v_pool[table].reshape(b, length, hkv, d).float()
    ones = torch.ones(b, pages, hkv, device=q.device)
    ks, vs = (ones, ones) if k_scale is None else (k_scale[table], v_scale[table])
    ks = ks[:, :, None, :].expand(b, pages, ps, hkv).reshape(b, length, hkv)
    vs = vs[:, :, None, :].expand(b, pages, ps, hkv).reshape(b, length, hkv)
    pad = total - length
    if pad:
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        ks = torch.nn.functional.pad(ks, (0, 0, 0, pad))
        vs = torch.nn.functional.pad(vs, (0, 0, 0, pad))
    qg = q.float().reshape(b, s, hkv, g, d)
    scores = torch.einsum("bshgd,blhd->bhsgl", qg, k) * scale * ks.transpose(1, 2)[:, :, None, None, :]
    cols = torch.arange(total, device=q.device)
    visible = (cols[None, None, :] <= positions.reshape(b, s, 1).long()) & (cols < length)
    scores = scores.reshape(b, hkv, s, g, n_split, split)
    vis = visible.reshape(b, 1, s, 1, n_split, split)
    m = scores.masked_fill(~vis, NEG_INF).amax(-1)
    p = torch.where(vis, torch.exp(scores - m[..., None]), torch.zeros((), device=q.device))
    l = p.sum(-1)
    pv = p * vs.transpose(1, 2).reshape(b, hkv, 1, 1, n_split, split)
    if q.dtype == torch.bfloat16:  # hi + lo, each rounded to bf16 (one term: p rounded once)
        terms = [pv.bfloat16().float()]
        for _ in range(p_terms - 1):
            terms.append((pv - sum(terms)).bfloat16().float())
        pv = sum(terms)
    acc = torch.einsum("bhsgnt,bnthd->bhsgnd", pv, v.reshape(b, n_split, split, hkv, d))
    live = (positions.reshape(b, s).long().amax(1) + ps) // ps
    runs = -(-live.clamp(max=pages) // (split // ps))
    ran = torch.arange(n_split, device=q.device)[None, :] < runs[:, None]
    return m, l, acc, ran


def paged_attention_split_emulation(q, k_pool, v_pool, page_table, positions, scale=None,
                                    k_scale=None, v_scale=None, split=None, drop_split=None, p_terms=2):
    """The kernels' arithmetic in plain PyTorch, for the tests and
    `chip_smoke.py` (no entry point calls it). Each slot's columns are cut
    into splits of `split` tokens (default `split_tokens(page_size)`). Per
    split and query row, in f32 (`split_partials`): s = (q . k) * scale *
    k_scale (K's page scale on the score column); m = the largest visible s
    (NEG_INF where the split holds none); p = exp(s - m) on visible columns
    and 0 on the others; l = sum(p); acc = sum(p * v_scale * v). When q is
    bf16, p * v_scale enters the tensor cores as `p_terms` bf16 values whose
    sum approximates it: hi = bf16(x), lo = bf16(x - hi) (the kernel's two;
    one term rounds p once, which the tests show breaks the bf16 limit).
    Only the splits that start before the slot's max position + 1 run;
    `drop_split` = i leaves split i out wherever it ran, as a wrong kernel
    would. The merge weighs split i by exp(m_i - max_i m_i): out = sum w acc
    / max(sum w l, 1e-30), in q's dtype."""
    b, s, hq, d = q.shape
    m, l, acc, ran = split_partials(q, k_pool, v_pool, page_table, positions, scale, k_scale, v_scale,
                                    split, p_terms)
    if drop_split is not None:
        ran = ran.clone()
        ran[:, drop_split] = False
    ran = ran[:, None, None, None, :]
    top = m.masked_fill(~ran, NEG_INF).amax(-1, keepdim=True)
    w = torch.where(ran, torch.exp(m - top), torch.zeros((), device=q.device))
    out = (w[..., None] * acc).sum(-2) / (w * l).sum(-1).clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(b, s, hq, d).to(q.dtype)


def _check(q, k_pool, v_pool, page_table, positions, k_scale=None, v_scale=None):
    if q.ndim != 4 or k_pool.ndim != 4:
        raise ValueError(f"expected q [B, s, Hq, D] and pools [N, ps, Hkv, D], got {q.shape}, {k_pool.shape}")
    b, s, hq, d = q.shape
    n, ps, hkv, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or dk != d:
        raise ValueError(f"pool shapes {k_pool.shape}/{v_pool.shape} do not fit q {q.shape}")
    if hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq}, {hkv}")
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be [B, pages_per_slot], got {page_table.shape}")
    if positions.numel() != b * s:
        raise ValueError(f"positions must hold [B, s] = {(b, s)} values, got {positions.shape}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("quantized pools need BOTH k_scale and v_scale (or neither)")
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if sc is not None and tuple(sc.shape) != (n, hkv):
            raise ValueError(
                f"per-page-per-head {name} must be [num_pages, Hkv] = {(n, hkv)}, got {tuple(sc.shape)}"
            )


def _launch(kind, q, k_pool, v_pool, page_table, positions, scale, k_scale=None, v_scale=None):
    tensors = dict(q=q, k_pool=k_pool, v_pool=v_pool, page_table=page_table, positions=positions)
    quantized = k_scale is not None
    if quantized:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes float32 or bfloat16 q, got {q.dtype}")
    if quantized:
        if k_pool.dtype not in _KV_CODES or v_pool.dtype != k_pool.dtype:
            raise ValueError(
                f"quantized pools must both be int8 or both float8_e4m3fn, got {k_pool.dtype}/{v_pool.dtype}"
            )
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise ValueError(f"k_scale and v_scale must be float32, got {k_scale.dtype}/{v_scale.dtype}")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(
            f"the kernel takes float32 or bfloat16 q and pools of q's dtype, got "
            f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}"
            + ("; an int8 or fp8 pool needs k_scale and v_scale" if k_pool.dtype in _KV_CODES else "")
        )
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("page_table and positions must be int32")
    b, s, hq, d = q.shape
    n, ps, hkv, _ = k_pool.shape
    if d % 8:
        raise ValueError(f"the kernel needs head_dim % 8 == 0 for 16-byte loads, got {d}")
    if quantized and d % 16:
        raise ValueError(f"the kernel needs head_dim % 16 == 0 for 16-byte loads of 1-byte pools, got {d}")
    for name in ("q", "k_pool", "v_pool"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    p = page_table.shape[1]
    split = split_tokens(ps)
    kv_code = _KV_CODES[k_pool.dtype][1] if quantized else -1
    lib = _lib()
    smem = lib.paged_attention_shared_bytes(s, hq, hkv, d, ps, split, _DTYPE_CODES[q.dtype], kv_code)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(f"{smem} bytes of shared memory per block exceed the card's {_MAX_SHARED_BYTES}")
    out = torch.empty_like(q)
    # Each split's partial (acc[D], m, l) per query row, f32.
    ws = torch.empty(b * hkv * num_splits(p, ps, split) * s * (hq // hkv) * (d + 2),
                     dtype=torch.float32, device=q.device)
    table_ptrs = [t.data_ptr() for t in (page_table, positions, out, ws)]
    dims = ((b, hq, hkv, d, n, ps, p) if kind == "decode" else (b, s, hq, hkv, d, n, ps, p)) + (split,)
    # The launch goes to the current device on PyTorch's current stream of
    # q's device, behind this dispatch's pool writes.
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if quantized:
            name = _KV_CODES[k_pool.dtype][0]
            entry = lib.paged_decode_quant_launch if kind == "decode" else lib.paged_verify_quant_launch
            ptrs = [t.data_ptr() for t in (q, k_pool, v_pool, k_scale, v_scale)] + table_ptrs
            err = entry(*ptrs, *dims, float(scale), _DTYPE_CODES[q.dtype], kv_code, stream)
            key = f"{kind}_{name}"
        else:
            entry = lib.paged_decode_launch if kind == "decode" else lib.paged_verify_launch
            ptrs = [t.data_ptr() for t in (q, k_pool, v_pool)] + table_ptrs
            err = entry(*ptrs, *dims, float(scale), _DTYPE_CODES[q.dtype], stream)
            key = kind
    if err != 0:
        raise RuntimeError(
            f"paged {key} kernel launch failed: {lib.paged_attention_error_string(err).decode()}"
        )
    LAUNCHES[key] += 1
    return out


def _paged_call(kind, q, k_pool, v_pool, page_table, positions, scale, k_scale, v_scale):
    _check(q, k_pool, v_pool, page_table, positions, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _launch(kind, q, k_pool, v_pool, page_table, positions, scale, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, page_table, positions, scale, k_scale, v_scale)
    raise ValueError(f"no paged attention for tensors on {q.device}")


def paged_decode_attention(q, k_pool, v_pool, page_table, positions, *, scale: Optional[float] = None,
                           k_scale=None, v_scale=None):
    """Single-query paged decode attention over a pool-resident KV cache.

    Args:
        q: [B, 1, Hq, D] this step's queries (one per slot).
        k_pool / v_pool: [num_pages, page_size, Hkv, D] page pools, already
            holding this dispatch's K/V writes.
        page_table: [B, pages_per_slot] int32 pool-page ids; unused entries
            point at the scratch page.
        positions: [B, 1] (or [B]) int32; row i attends ``cols <= positions[i]``.
        scale: defaults to 1/sqrt(D).
        k_scale / v_scale: [num_pages, Hkv] f32 per-page-per-head scales of
            int8 or fp8-e4m3 pools (both or neither); the dequant fuses into
            the page walk.

    Returns [B, 1, Hq, D] in q's dtype.
    """
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention takes [B, 1, Hq, D] queries, got {tuple(q.shape)}")
    return _paged_call("decode", q, k_pool, v_pool, page_table, positions, scale, k_scale, v_scale)


def paged_verify_attention(q, k_pool, v_pool, page_table, positions, *, scale: Optional[float] = None,
                           k_scale=None, v_scale=None):
    """Block-verify paged attention, the [B, s] variant that speculative
    decoding's verify step runs (s = draft_tokens + 1).

    Args:
        q: [B, s, Hq, D] the block's queries.
        k_pool / v_pool / page_table: as `paged_decode_attention`.
        positions: [B, s] int32; query j of row i attends ``cols <= positions[i, j]``.
        k_scale / v_scale: as `paged_decode_attention` (quantized pools).

    Returns [B, s, Hq, D].
    """
    if q.ndim != 4:
        raise ValueError(f"paged_verify_attention takes [B, s, Hq, D] queries, got {tuple(q.shape)}")
    return _paged_call("verify", q, k_pool, v_pool, page_table, positions, scale, k_scale, v_scale)
