"""Drive the PyTorch/CUDA port (`accelerate_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA device

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. Card and build: the card's name and power limit (nvidia-smi), then every
   `accelerate_tpu_torch/csrc/*.cu` built with nvcc for sm_90a, all sources
   at once, with the build time and ptxas' register/shared-memory report.
2. Kernels: the paged-decode (K1) and block-verify (K2) kernels at
   Llama-1B's attention shapes (Hq 32, Hkv 8, D 64, page 16, 8 slots of 2048
   tokens, ragged lengths, shuffled page tables, a poisoned scratch page;
   verify block s = 5), each held against its plain PyTorch version in f32
   (atol 2e-5) and bf16 (atol 2e-3, rtol 1e-2), then timed with CUDA events
   (median of 60 launches, L2 flushed before each) beside the plain version,
   the least time the card could take (bytes at 3.35 TB/s or operations at
   the peak rate of the input type, whichever is larger) and, as a labelled
   yardstick the port never calls, `F.scaled_dot_product_attention` over an
   already-gathered dense K/V.
3. Engine: `create_named_model("llama-1b")` at full width and depth (random
   weights from a seed) served by `ContinuousBatcher(num_slots=8,
   page_size=16, max_length=2048)` over 16 requests of mixed lengths, half
   of them sharing a 256-token system prompt.
   (a) f32: greedy tokens of the "paged_kernel" engine equal the "gather"
       engine's, plain (K1's path) and speculative (K2's path).
   (b) bf16: the "paged_kernel" engine, plain and speculative, timed; every
       request finishes; each kernel's launch count, zeroed just before the
       run, equals layers x dispatches of that run and is > 0.
4. A `{"kernels": [...]}` line, the nvidia-smi line, and as the last line
   `{"ok": true, "device": {...}}`.

TF32 is off for matmuls and cuDNN (`allow_tf32 = False`), so f32 means f32.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 CUDA cores; bf16 tensor cores
F32_ATOL = 2e-5
# bf16: both sides widen the same bf16 inputs and compute in fp32, so they
# differ by the fp32 summation order plus at most one bf16 rounding of the
# output (a relative 2^-8). Long slots' outputs are small (about
# sqrt(e / L): 0.036 at L = 2048), so the absolute limit is kept well below
# them; the measured error is about 2e-4.
BF16_ATOL, BF16_RTOL = 2e-3, 1e-2
TIMED_LAUNCHES = 60

# Llama-1B attention at the engine's shapes.
KERNEL_SHAPE = dict(slots=8, hq=32, hkv=8, d=64, page_size=16, max_length=2048, verify_s=5)
REPLACES = {
    "decode": "accelerate_tpu/ops/paged_attention.py:67",
    "verify": "accelerate_tpu/ops/paged_attention.py:117",
}
SOURCE = "accelerate_tpu_torch/csrc/paged_attention.cu"


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def time_ms(fn, device, iters: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    """Median device time of `fn` over `iters` calls, each bracketed by CUDA
    events, with the 50 MB L2 flushed (a 256 MB write) before each call so
    every call reads its inputs from device memory, as a layer of the engine
    does."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(device)
    return float(np.median([s.elapsed_time(e) for s, e in events]))


# ----------------------------------------------------------------- kernels
def kernel_case(device, dtype, s, seed, slots, hq, hkv, d, page_size, max_length, **_):
    """Pools, a shuffled page table, ragged positions and queries for `slots`
    slots; the scratch page 0 is poisoned, and table entries past each
    slot's live pages point at it."""
    rng = np.random.default_rng(seed)
    P = max_length // page_size
    lengths = np.array([max_length, 1, 17, 512, 1000, 1501, max_length - 1, 300])[:slots]
    lengths = np.minimum(lengths, max_length - s + 1)  # room for the verify block
    N = slots * P + 1
    pages = rng.permutation(np.arange(1, N))
    table = np.zeros((slots, P), np.int32)
    for b in range(slots):
        live = -(-(int(lengths[b]) + s - 1) // page_size)
        table[b, :live] = pages[b * P : b * P + live]
    pos = (lengths[:, None] - 1 + np.arange(s)[None, :]).astype(np.int32)
    gen = torch.Generator(device=device).manual_seed(seed)
    k = torch.randn((N, page_size, hkv, d), generator=gen, device=device).to(dtype)
    v = torch.randn((N, page_size, hkv, d), generator=gen, device=device).to(dtype)
    k[0], v[0] = 1e4, 1e4
    q = torch.randn((slots, s, hq, d), generator=gen, device=device).to(dtype)
    return q, k, v, torch.as_tensor(table, device=device), torch.as_tensor(pos, device=device)


def kernel_bound(q, k, table, pos):
    """(least ms, "bytes" | "operations") for these inputs: each live K/V page
    read once, q, table entries and positions read once, the output written
    once; 4 * D operations per (query head, visible column)."""
    b, s, hq, d = q.shape
    ps, hkv = k.shape[1], k.shape[2]
    itemsize = q.element_size()
    length = pos.max(dim=1).values.long() + 1
    live_pages = (length + ps - 1) // ps
    kv_bytes = int(live_pages.sum()) * ps * hkv * d * 2 * itemsize
    n_bytes = kv_bytes + 2 * q.numel() * itemsize + int(live_pages.sum()) * 4 + pos.numel() * 4
    ops = int((pos.long() + 1).sum()) * hq * d * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_yardstick(q, k, v, table, pos):
    """One `F.scaled_dot_product_attention` call over the slots' K/V already
    gathered into dense [B, Hkv, L, D] (the gather is not timed): the same
    function on dense inputs. A yardstick only; the port never calls it."""
    b, s, hq, d = q.shape
    ps, hkv = k.shape[1], k.shape[2]
    L = table.shape[1] * ps
    tbl = table.long()
    kd = k[tbl].reshape(b, L, hkv, d).transpose(1, 2).contiguous()
    vd = v[tbl].reshape(b, L, hkv, d).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()
    mask = (torch.arange(L, device=q.device)[None, None, :] <= pos[:, :, None].long())[:, None]
    fn = torch.nn.functional.scaled_dot_product_attention
    return lambda: fn(qd, kd, vd, attn_mask=mask, enable_gqa=True)


def kernel_phase(device, shape=KERNEL_SHAPE, timed=True):
    from accelerate_tpu_torch.ops import paged_attention as pa

    results = {}
    for kind, s in (("decode", 1), ("verify", shape["verify_s"])):
        fn = pa.paged_decode_attention if s == 1 else pa.paged_verify_attention
        entry = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, table, pos = kernel_case(device, dtype, s, seed=11 + s, **shape)
            before = pa.LAUNCHES[kind]
            out = fn(q, k, v, table, pos)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                if pa.LAUNCHES[kind] != before + 1:
                    raise RuntimeError(f"{kind} call on {device} did not launch its kernel")
            ref = pa.paged_attention_reference(q, k, v, table, pos)
            if not torch.isfinite(out).all():
                raise RuntimeError(f"{kind} kernel ({dtype}) wrote non-finite values")
            err = float((out.float() - ref.float()).abs().max())
            tol = dict(atol=F32_ATOL, rtol=0.0) if dtype == torch.float32 else dict(atol=BF16_ATOL, rtol=BF16_RTOL)
            torch.testing.assert_close(out.float(), ref.float(), **tol, msg=lambda m: f"{kind} {dtype}: {m}")
            row = {"max_abs_err": err, "tolerance": tol}
            bound, bound_by = kernel_bound(q, k, table, pos)
            row.update(bound_ms=bound, bound_by=bound_by)
            if timed:
                row["ms"] = time_ms(lambda: fn(q, k, v, table, pos), device)
                row["plain_ms"] = time_ms(lambda: pa.paged_attention_reference(q, k, v, table, pos), device)
                row["library_ms"] = time_ms(sdpa_yardstick(q, k, v, table, pos), device)
            entry[str(dtype).replace("torch.", "")] = row
            log(f"[kernels] {kind} {dtype}: {json.dumps(row)}")
        results[kind] = entry
    return results


# ------------------------------------------------------------------ engine
def make_requests(vocab, seed=0, n=16, system_len=256):
    """16 requests: half share one `system_len`-token system prompt and add
    their own question; a quarter are repetitive (a motif repeated, as in
    code or templated text, where n-gram drafts get accepted); the rest are
    random prompts of mixed length."""
    from accelerate_tpu_torch import Request

    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, (system_len,))
    reqs = []
    for i in range(n):
        if i % 2 == 0:
            prompt = np.concatenate([system, rng.integers(0, vocab, (int(rng.integers(8, 200)),))])
        elif i % 4 == 1:
            motif = rng.integers(0, vocab, (int(rng.integers(6, 24)),))
            prompt = np.tile(motif, 40)[: int(rng.integers(64, 600))]
        else:
            prompt = rng.integers(0, vocab, (int(rng.integers(16, 700)),))
        reqs.append(Request(i, prompt.astype(np.int64), max_new_tokens=int(rng.integers(16, 49))))
    return reqs


def serve(model, requests, device, **engine_kw):
    """Run `requests` to completion; returns (engine, tokens, timing)."""
    import dataclasses

    from accelerate_tpu_torch import ContinuousBatcher

    engine = ContinuousBatcher(model, max_queue=len(requests), device=device, **engine_kw)
    admit_s = [0.0]
    admit = engine._admit

    def timed_admit():
        t0 = time.perf_counter()
        try:
            return admit()
        finally:
            admit_s[0] += time.perf_counter() - t0

    engine._admit = timed_admit
    submitted = {}
    t0 = time.perf_counter()
    for r in requests:
        submitted[r.request_id] = time.perf_counter()
        engine.submit(dataclasses.replace(r, arrival_time=submitted[r.request_id]))
    while engine.pending:
        engine.step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    tokens = {rid: list(res.tokens) for rid, res in engine.results.items()}
    for res in engine.results.values():
        if not res.finished or res.finish_reason not in ("eos", "length"):
            raise RuntimeError(f"request {res.request_id} ended {res.finish_reason}: {res.error}")
    for r in requests:
        got = tokens[r.request_id]
        if not 1 <= len(got) <= r.max_new_tokens or not all(0 <= t < model.config.vocab_size for t in got):
            raise RuntimeError(f"request {r.request_id}: malformed output {got[:8]}...")
    n_tokens = sum(len(t) for t in tokens.values())
    ttft = [engine.results[r].first_token_time - submitted[r] for r in submitted]
    timing = {
        "wall_s": wall,
        "output_tokens": n_tokens,
        "output_tokens_per_s": n_tokens / wall,
        # Tokens after each request's first, over the time not spent admitting.
        "decode_tokens_per_s": (n_tokens - len(requests)) / max(wall - admit_s[0], 1e-9),
        "admit_s": admit_s[0],
        "ttft_p50_s": float(np.median(ttft)),
    }
    return engine, tokens, timing


def engine_phase(device, model_name="llama-1b", engine_kw=None, n_requests=16, system_len=256,
                 profile=False):
    from accelerate_tpu_torch import create_named_model
    from accelerate_tpu_torch.ops import paged_attention as pa

    engine_kw = {**dict(num_slots=8, page_size=16, max_length=2048, chunk_size=8), **(engine_kw or {})}
    spec_kw = dict(speculative=True, draft_tokens=KERNEL_SHAPE["verify_s"] - 1)
    report = {"model": model_name, "engine": engine_kw, "draft_tokens": spec_kw["draft_tokens"]}

    t0 = time.perf_counter()
    model = create_named_model(model_name, seed=0, dtype=torch.float32, device=device)
    layers = model.config.num_hidden_layers
    requests = make_requests(model.config.vocab_size, n=n_requests, system_len=system_len)
    log(f"[engine] {model_name} f32 built in {time.perf_counter() - t0:.1f}s: {layers} layers, "
        f"hidden {model.config.hidden_size}, vocab {model.config.vocab_size}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")

    # (a) f32 parity: the kernel path against the gather path, plain and speculative.
    for label, extra in (("plain", {}), ("speculative", spec_kw)):
        runs = {}
        for impl in ("gather", "paged_kernel"):
            engine, tokens, timing = serve(model, requests, device, attention_impl=impl, **engine_kw, **extra)
            runs[impl] = tokens
            log(f"[engine] f32 {label} {impl}: {json.dumps(timing)}")
        if runs["gather"] != runs["paged_kernel"]:
            bad = [rid for rid in runs["gather"] if runs["gather"][rid] != runs["paged_kernel"][rid]]
            raise RuntimeError(f"f32 {label}: paged_kernel tokens differ from gather for requests {bad}")
        log(f"[engine] f32 {label}: paged_kernel tokens == gather tokens for all {len(requests)} requests")
        report[f"f32_{label}_identical"] = True

    # (b) bf16 timing on the kernel path; launch counts zeroed just before each run.
    model = model.to(torch.bfloat16)
    serve(model, requests[:2], device, **engine_kw)  # warm-up: bf16 GEMM handles, allocator
    serve(model, requests[:2], device, **engine_kw, **spec_kw)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for label, extra, kind in (("plain", {}, "decode"), ("speculative", spec_kw, "verify")):
        pa.reset_launch_counts()
        engine, _, timing = serve(model, requests, device, **engine_kw, **extra)
        launches = dict(pa.LAUNCHES)
        dispatches = engine.stats["decode_steps"]  # chunks x chunk_size, one kernel call per layer each
        timing.update(launches=launches, dispatches=dispatches, prefix_cache=engine.stats["prefix_cache"])
        if label == "speculative":
            timing["speculative"] = engine.stats["speculative"]
        log(f"[engine] bf16 {label} paged_kernel: {json.dumps(timing)}")
        if device.type == "cuda":
            other = "verify" if kind == "decode" else "decode"
            if launches[kind] != layers * dispatches or launches[kind] <= 0 or launches[other] != 0:
                raise RuntimeError(
                    f"bf16 {label}: launches {launches}, expected {kind} = {layers} layers x "
                    f"{dispatches} dispatches and no {other}"
                )
        report[f"bf16_{label}"] = timing
    if engine.stats["prefix_cache"]["hits"] <= 0:
        raise RuntimeError("the shared system prompt never hit the prefix cache")
    if device.type == "cuda":
        report["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    if profile:
        report["bf16_plain_profile"] = profile_phase(
            model, requests, device, engine_kw, report["bf16_plain"]["wall_s"]
        )
    return report


def profile_phase(model, requests, device, engine_kw, unprofiled_wall_s):
    """Device time by kernel over one more bf16 plain run under
    `torch.profiler` (CUPTI). Kernels run on one stream and do not overlap,
    so their summed time is the device's busy time; its share of the
    unprofiled run's wall clock is the busy share (the profiler slows the
    host, not the device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, timing = serve(model, requests, device, **engine_kw)
    kernels = [
        (row.self_device_time_total, row.key, row.count)
        for row in prof.key_averages()
        if row.device_type == DeviceType.CUDA and row.self_device_time_total > 0
    ]
    total_us = sum(us for us, _, _ in kernels)
    if total_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    groups = {"paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for us, name, _ in kernels:
        lowered = name.lower()
        if "paged_attention" in lowered:
            groups["paged_attention"] += us
        elif any(tag in lowered for tag in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
            groups["gemm"] += us
        else:
            groups["other"] += us
    kernels.sort(reverse=True)
    return {
        "profiled_wall_s": timing["wall_s"],
        "device_busy_s": total_us / 1e6,
        "busy_share_of_unprofiled_wall": total_us / 1e6 / unprofiled_wall_s,
        "share_by_group": {k: v / total_us for k, v in groups.items()},
        "top_kernels": [
            {"name": name[:140], "calls": calls, "ms": us / 1e3, "share": us / total_us}
            for us, name, calls in kernels[:15]
        ],
    }


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the build and the kernel phase (prints no result line)")
    parser.add_argument("--profile", action="store_true",
                        help="also profile one bf16 plain engine run: device time by kernel, busy share")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"device count {torch.cuda.device_count()}")

    from accelerate_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {sorted(built)} in {time.perf_counter() - t0:.2f}s (per source: {built})")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    kernels = kernel_phase(device)
    if args.kernels_only:
        log(card)
        return 0
    engine = engine_phase(device, profile=args.profile)
    log(f"[engine] summary: {json.dumps(engine)}")

    rows = []
    runs = {"decode": "bf16_plain", "verify": "bf16_speculative"}
    for kind in ("decode", "verify"):
        bf16, f32 = kernels[kind]["bfloat16"], kernels[kind]["float32"]
        rows.append({
            "name": f"paged_{kind}",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[kind],
            "launches": engine[runs[kind]]["launches"][kind],
            "max_abs_err": bf16["max_abs_err"],
            "tolerance": bf16["tolerance"],
            "ms": bf16["ms"],
            "kernel_ms": bf16["ms"],
            "plain_ms": bf16["plain_ms"],
            "bound_ms": bf16["bound_ms"],
            "bound_by": bf16["bound_by"],
            "library_ms": bf16["library_ms"],
            "library_call": "F.scaled_dot_product_attention over pre-gathered dense K/V (yardstick, never called by the port)",
            "dtype": "bfloat16",
            "shape": dict(KERNEL_SHAPE, s=1 if kind == "decode" else KERNEL_SHAPE["verify_s"]),
            "f32": f32,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
