"""Price the port's always-on telemetry against a tree without it.

Every `ContinuousBatcher` keeps a metrics registry and opens spans into the
default tracer, and `Accelerator.train_step()` wraps the fused step in
`_instrument_step` (a timeline phase, a ``train.step`` span, the polls);
neither can be turned off. `chip_smoke.py` phase 13 pairs the opt-in parts
(a streamed span file, the trace guard, the sampled block) against a run
that has the always-on parts too. This script prices the always-on parts:
it times both main paths as a user calls them, in this tree and in another
one (a checkout of a commit before the telemetry), each side in a process
of its own on the same card, in the order a b b a (a the other tree, b this
one), `--rounds` times over:

  - the Llama-1B paged engine, bf16, with `chip_smoke.py` phase 3's 16
    requests and engine arguments: decode tokens/s and TTFT p50 of each of
    `ENGINE_RUNS` runs after a warm-up;
  - Llama-1B bf16 training, batch 2 x 2048, AdamW: the wall time of each
    `accelerator.train_step()` call with its loss read back, after 2
    warm-up steps. Where that step is instrumented (it carries
    `__wrapped__`), the bare fused step under it is timed in the same
    process too, the two taking turns a b b a step by step on one model.

Each side records a digest of its tokens and its losses, so the sides are
seen to do the same work.

Run on the card from the root of this tree, with the other tree unpacked
into a directory that ``.gitignore`` lists:

    mkdir -p scratch/parent && git archive <commit> | tar -x -C scratch/parent
    python3 telemetry_cost.py --other scratch/parent

The kernels are built once, in this tree, and their libraries copied into
the other tree's build directory (a library's name hashes its sources and
flags, so the other tree loads them only if its sources are the same).
The result is a JSON file (``--out``). ``--side TREE --json FILE``
measures one tree in this process (what the pairing starts).
``--breakdown`` times the engine alone: this tree's with parts of its
telemetry turned off or the garbage collector paused (`engine_variant`),
beside the other tree's, to find where a cost goes.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# chip_smoke.py's engine and training cells (phase 3, phase 5 (b)).
ENGINE_KW = dict(num_slots=8, page_size=16, max_length=2048, chunk_size=8)
ENGINE_RUNS = 3
TRAIN = dict(batch=2, seq=2048, warmup=2, timed=16, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def make_requests(vocab, seed=0, n=16, system_len=256, max_prompt=None):
    """`chip_smoke.make_requests`: half share a system prompt, a quarter
    are repetitive, the rest random, 16-48 new tokens each. `max_prompt`
    cuts each prompt (for a rehearsal on a narrow model)."""
    import numpy as np

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
        reqs.append(Request(i, prompt[:max_prompt].astype(np.int64), max_new_tokens=int(rng.integers(16, 49))))
    return reqs


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_once(model, requests, device, engine_kw, stats=None):
    """One engine run of `requests` as a user makes it (the engine's own
    defaults); returns (tokens, decode tokens/s, TTFT p50 s). Decode
    tokens/s is chip_smoke's: the tokens after each request's first over
    the wall time not spent admitting. `stats`, a dict, receives the
    seconds of `step()` outside admission ("chunk_s") and the chunks run
    ("chunks", plain engines only)."""
    import dataclasses

    import numpy as np

    from accelerate_tpu_torch import ContinuousBatcher

    engine = ContinuousBatcher(model, max_queue=len(requests), device=device, **engine_kw)
    admit, admit_s = engine._admit, [0.0]

    def timed_admit():
        t0 = time.perf_counter()
        try:
            return admit()
        finally:
            admit_s[0] += time.perf_counter() - t0

    engine._admit = timed_admit
    decode, chunks = engine._decode_chunk, [0]

    def counted_chunk(*args, **kwargs):
        chunks[0] += 1
        return decode(*args, **kwargs)

    engine._decode_chunk = counted_chunk
    submitted = {}
    t0 = time.perf_counter()
    for r in requests:
        submitted[r.request_id] = time.perf_counter()
        engine.submit(dataclasses.replace(r, arrival_time=submitted[r.request_id]))
    step_s = 0.0
    while engine.pending:
        before, t1 = admit_s[0], time.perf_counter()
        engine.step()
        step_s += time.perf_counter() - t1 - (admit_s[0] - before)
    _sync(device)
    if stats is not None:
        stats.update(chunk_s=step_s, chunks=chunks[0])
    wall = time.perf_counter() - t0
    del engine._admit, engine._decode_chunk
    tokens = {rid: [int(t) for t in res.tokens] for rid, res in engine.results.items()}
    n_tokens = sum(len(t) for t in tokens.values())
    ttft = [engine.results[rid].first_token_time - t for rid, t in submitted.items()]
    return tokens, (n_tokens - len(requests)) / max(wall - admit_s[0], 1e-9), float(np.median(ttft))


def measure_engine(device, model_name="llama-1b", engine_kw=None, n_requests=16, system_len=256, max_prompt=None,
                   runs=ENGINE_RUNS):
    import torch

    from accelerate_tpu_torch import create_named_model

    engine_kw = {**ENGINE_KW, **(engine_kw or {})}
    # chip_smoke phase 3's model: f32 from seed 0, then cast.
    model = create_named_model(model_name, seed=0, dtype=torch.float32, device=device).to(torch.bfloat16)
    requests = make_requests(model.config.vocab_size, n=n_requests, system_len=system_len, max_prompt=max_prompt)
    serve_once(model, requests[:2], device, engine_kw)  # warm-up: kernels, GEMM handles, allocator
    out = {"decode_tokens_per_s": [], "ttft_p50_s": [], "tokens_sha256": set()}
    for _ in range(runs):
        tokens, rate, ttft = serve_once(model, requests, device, engine_kw)
        out["decode_tokens_per_s"].append(rate)
        out["ttft_p50_s"].append(ttft)
        out["tokens_sha256"].add(hashlib.sha256(json.dumps(tokens, sort_keys=True).encode()).hexdigest())
    out["tokens_sha256"] = sorted(out["tokens_sha256"])
    del model
    return out


def measure_training(device, model_name="llama-1b", batch=TRAIN["batch"], seq=TRAIN["seq"], warmup=TRAIN["warmup"],
                     timed=TRAIN["timed"]):
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator, BatchSampler, SimpleDataLoader
    from accelerate_tpu_torch.models import CREATE_BY_FAMILY, MODEL_REGISTRY
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    config = MODEL_REGISTRY[model_name]()
    model = CREATE_BY_FAMILY[type(config)](config, seed=0, device=device)
    accelerator = Accelerator(mixed_precision="bf16", cpu=device.type == "cpu")
    optimizer = torch.optim.AdamW(model.parameters(), lr=TRAIN["lr"], betas=TRAIN["betas"], eps=TRAIN["eps"],
                                  weight_decay=TRAIN["weight_decay"])
    rows = np.random.default_rng(0).integers(0, config.vocab_size, (batch, seq)).astype(np.int64)
    data = [{"input_ids": rows[i]} for i in range(batch)]
    loader = SimpleDataLoader(data, BatchSampler(range(batch), batch))
    _, optimizer, loader = accelerator.prepare(model, optimizer, loader)
    batch_on_device = next(iter(loader))
    user = accelerator.train_step(max_grad_norm=1.0)
    bare = getattr(user, "__wrapped__", None)  # the fused step under the instruments, where there are any
    modes = {"user": user} if bare is None else {"user": user, "bare": bare}
    order = ["user"] * warmup + [m for _ in range(timed // 4) for m in (("user", "bare", "bare", "user")
                                                                          if bare is not None else ("user",) * 4)]
    steps = {mode: [] for mode in modes}
    losses = []
    for i, mode in enumerate(order):
        _sync(device)
        t0 = time.perf_counter()
        loss = float(modes[mode](batch_on_device))  # the loss read back: the step is done
        seconds = time.perf_counter() - t0
        losses.append(loss)
        if i >= warmup:
            steps[mode].append(1e3 * seconds)
    instrumented = bare is not None
    del user, bare, modes, accelerator, optimizer, model
    return {"step_ms": steps, "losses": losses, "order": order, "instrumented": instrumented}


@contextlib.contextmanager
def engine_variant(name):
    """Engine arguments and process state for one `--breakdown` variant of
    this tree's engine: "default" (as a user gets it), "spans_off" (a
    disabled `Tracer`), "metrics_off" (every instrument update a no-op),
    "both_off", and "gc_off" (the default engine with the cyclic garbage
    collector paused for the run)."""
    import gc

    extra, patches = {}, []
    if name in ("spans_off", "both_off"):
        from accelerate_tpu_torch.telemetry import tracing

        extra["tracer"] = tracing.Tracer(enabled=False)
    if name in ("metrics_off", "both_off"):
        from accelerate_tpu_torch.telemetry import metrics

        patches = [(metrics.Counter, "inc"), (metrics.Gauge, "set"), (metrics.Gauge, "set_max"),
                   (metrics.Gauge, "inc"), (metrics.Histogram, "observe")]
    saved = [(cls, attr, getattr(cls, attr)) for cls, attr in patches]
    for cls, attr in patches:
        setattr(cls, attr, lambda self, *a, **k: None)
    if name == "gc_off":
        gc.disable()
    try:
        yield extra
    finally:
        for cls, attr, fn in saved:
            setattr(cls, attr, fn)
        gc.enable()


BREAKDOWN = ("default", "spans_off", "metrics_off", "both_off", "gc_off")


def measure_breakdown(device, variants=BREAKDOWN, rounds=2, model_name="llama-1b", engine_kw=None, n_requests=16,
                      system_len=256, max_prompt=None):
    """Where this tree's engine spends its always-on cost: each variant of
    `engine_variant` (only "default" and "gc_off" in a tree without
    telemetry) served once per pass, the passes in the order v1..vn, vn..v1,
    `rounds` times; decode tokens/s and the host seconds a chunk (step()
    wall time outside admission, over the chunks) of every run."""
    import gc
    import importlib.util

    import torch

    from accelerate_tpu_torch import create_named_model

    if importlib.util.find_spec("accelerate_tpu_torch.telemetry") is None:
        variants = [v for v in variants if v in ("default", "gc_off")]
    engine_kw = {**ENGINE_KW, **(engine_kw or {})}
    model = create_named_model(model_name, seed=0, dtype=torch.float32, device=device).to(torch.bfloat16)
    requests = make_requests(model.config.vocab_size, n=n_requests, system_len=system_len, max_prompt=max_prompt)
    serve_once(model, requests[:2], device, engine_kw)
    out = {v: {"decode_tokens_per_s": [], "chunk_ms": []} for v in variants}
    order = [v for _ in range(rounds) for v in (*variants, *reversed(variants))]
    for name in order:
        gc.collect()
        with engine_variant(name) as extra:
            stats = {}
            _, rate, _ = serve_once(model, requests, device, {**engine_kw, **extra}, stats=stats)
        out[name]["decode_tokens_per_s"].append(rate)
        out[name]["chunk_ms"].append(1e3 * stats["chunk_s"] / max(stats["chunks"], 1))
    del model
    return {"order": order, "variants": out}


def measure_side(device, **kw):
    """Both cells in this process, from the tree whose package is imported."""
    import gc

    import torch

    import accelerate_tpu_torch

    out = {"package": os.path.dirname(os.path.abspath(accelerate_tpu_torch.__file__))}
    t0 = time.perf_counter()
    out["engine"] = measure_engine(device, **kw.get("engine", {}))
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["training"] = measure_training(device, **kw.get("training", {}))
    out["seconds"] = time.perf_counter() - t0
    return out


def run_side(tree, json_path, breakdown=False):
    """One side, in this process: `tree`'s package first on the path."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("telemetry_cost.py measures on a CUDA card; none is available")
    if breakdown:
        import accelerate_tpu_torch

        result = measure_breakdown(torch.device("cuda", 0))
        result["package"] = os.path.dirname(os.path.abspath(accelerate_tpu_torch.__file__))
    else:
        result = measure_side(torch.device("cuda", 0))
    with open(json_path, "w") as f:
        json.dump(result, f)


def _median(xs):
    return statistics.median(xs) if xs else None


def _card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def build_and_share(other):
    """Build every kernel in this tree, then copy the libraries into
    `other`'s build directory."""
    code = "import sys; sys.path.insert(0, sys.argv[1]); from accelerate_tpu_torch.ops import _build; print(_build.build())"
    subprocess.run([sys.executable, "-c", code, str(HERE)], check=True)
    src, dst = HERE / "build" / "accelerate_tpu_torch", Path(other).resolve() / "build" / "accelerate_tpu_torch"
    dst.mkdir(parents=True, exist_ok=True)
    for lib in src.glob("*.so"):
        shutil.copy2(lib, dst / lib.name)


def summarize(sides):
    """{tree label: every reading, its median and its median per process},
    this tree's medians over the other's, and whether the sides made the
    same tokens and losses."""
    out = {}
    for label, results in sides.items():
        per_process = {
            "decode_tokens_per_s": [r["engine"]["decode_tokens_per_s"] for r in results],
            "ttft_p50_s": [r["engine"]["ttft_p50_s"] for r in results],
            "step_ms": [r["training"]["step_ms"]["user"] for r in results],
            "bare_step_ms": [r["training"]["step_ms"].get("bare", []) for r in results],
        }
        side = {}
        for key, runs in per_process.items():
            side[key] = [x for run in runs for x in run]
            side[key + "_median"] = _median(side[key])
            side[key + "_per_process"] = [_median(run) for run in runs]
        side["tokens_sha256"] = sorted({h for r in results for h in r["engine"]["tokens_sha256"]})
        side["losses"] = [r["training"]["losses"] for r in results]
        out[label] = side
    a, b = out["other"], out["this"]
    out["this_over_other"] = {key: b[key + "_median"] / a[key + "_median"]
                              for key in ("decode_tokens_per_s", "ttft_p50_s", "step_ms")}
    if b["bare_step_ms_median"]:
        out["this_instrumented_over_bare"] = b["step_ms_median"] / b["bare_step_ms_median"]
    out["tokens_equal_across_sides"] = len(set(a["tokens_sha256"]) | set(b["tokens_sha256"])) == 1
    ref = a["losses"][0]
    out["losses_bit_for_bit_across_processes"] = all(losses == ref for side in (a, b) for losses in side["losses"])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", help="root of the tree to hold this one against")
    parser.add_argument("--rounds", type=int, default=2, help="a b b a rounds (default 2)")
    parser.add_argument("--out", default="telemetry_cost.json", help="where the JSON result goes")
    parser.add_argument("--side", help="measure this tree in this process")
    parser.add_argument("--json", help="with --side: where to write its result")
    parser.add_argument("--breakdown", action="store_true",
                        help="the engine alone, this tree's variants with parts of its telemetry turned off")
    args = parser.parse_args(argv)
    if args.side:
        run_side(args.side, args.json, args.breakdown)
        return 0
    if not args.other:
        parser.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        print("telemetry_cost.py measures on a CUDA card; none is available", file=sys.stderr)
        return 1
    card = _card()
    print(card, flush=True)
    t0 = time.perf_counter()
    build_and_share(args.other)
    print(f"[cost] kernels built and shared in {time.perf_counter() - t0:.1f}s", flush=True)
    trees = {"other": str(Path(args.other).resolve()), "this": str(HERE)}
    sides = {"other": [], "this": []}
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    for i, label in enumerate(("other", "this", "this", "other") * args.rounds):
        side_json = out_path.with_suffix(f".side{i}.json")
        t1 = time.perf_counter()
        subprocess.run([sys.executable, str(HERE / "telemetry_cost.py"), "--side", trees[label], "--json",
                        str(side_json), *(["--breakdown"] if args.breakdown else [])], check=True)
        with open(side_json) as f:
            result = json.load(f)
        side_json.unlink()
        if result["package"] != os.path.join(trees[label], "accelerate_tpu_torch"):
            raise RuntimeError(f"side {label} imported {result['package']}, not {trees[label]}")
        sides[label].append(result)
        if args.breakdown:
            print(f"[cost] {i} {label}: {time.perf_counter() - t1:.1f}s, "
                  f"{json.dumps({v: {k: [round(x, 3) for x in xs] for k, xs in r.items()} for v, r in result['variants'].items()})}",
                  flush=True)
            continue
        print(f"[cost] {i} {label}: {time.perf_counter() - t1:.1f}s, decode tokens/s "
              f"{result['engine']['decode_tokens_per_s']}, TTFT p50 s {result['engine']['ttft_p50_s']}, step ms "
              f"{ {k: round(statistics.median(v), 3) for k, v in result['training']['step_ms'].items()} }",
              flush=True)
    if args.breakdown:
        summary = {label: {v: {k: _median([x for r in sides[label] for x in r["variants"][v][k]])
                               for k in ("decode_tokens_per_s", "chunk_ms")}
                           for v in sides[label][0]["variants"]} for label in sides}
        with open(out_path, "w") as f:
            json.dump({"card": card, "trees": trees, "summary": summary, "sides": sides}, f, indent=1)
        print(json.dumps(summary), flush=True)
        print(f"[cost] total {time.perf_counter() - t0:.1f}s", flush=True)
        return 0
    summary = summarize(sides)
    report = {"card": card, "trees": trees, "rounds": args.rounds, "engine_kw": ENGINE_KW, "train": TRAIN,
              "summary": summary, "sides": sides}
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k not in ("other", "this")}), flush=True)
    for label in ("other", "this"):
        print(json.dumps({label: {k: v for k, v in summary[label].items() if k.endswith(("_median", "_per_process"))}}),
              flush=True)
    print(f"[cost] total {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
