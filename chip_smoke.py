"""Drive the PyTorch/CUDA port (`accelerate_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA device

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. Card and build: the card's name and power limit (nvidia-smi), then every
   `accelerate_tpu_torch/csrc/*.cu` built with nvcc for sm_90a, one nvcc per
   source, all started together, with the build time and ptxas'
   register/shared-memory report.
2. Kernels: the paged-decode (K1) and block-verify (K2) kernels at
   Llama-1B's attention shapes (Hq 32, Hkv 8, D 64, page 16, 8 slots of 2048
   tokens, ragged lengths, shuffled page tables, a poisoned scratch page;
   verify block s = 5), each held against its plain PyTorch version in f32
   (atol 2e-5) and bf16 (atol 2e-3, rtol 1e-2), then timed with CUDA events
   (median of 20 launches, L2 flushed before each: `ms`, which a call's host
   work bounds where it outlasts the flush, and `device_ms`, the device
   spun 0.5 ms after the flush so that only its own time counts) beside the
   plain version,
   the least time the card could take (bytes at 3.35 TB/s or operations at
   the peak rate of the input type, whichever is larger) and, as a labelled
   yardstick the port never calls, `F.scaled_dot_product_attention` over an
   already-gathered dense K/V.
   Then K1 and K2's fused-dequant mode the same way, on the same pools
   quantized whole-page to int8 and to fp8 e4m3 (scratch page included) with
   per-page-per-head f32 scales, against the plain version on the same codes
   and scales; the bound counts 1 byte per cached value plus the scales, and
   the yardstick is SDPA over K/V already dequantized to q's dtype and
   gathered.
   Then the flash-attention kernels of training, forward (K3), dK/dV (K4)
   and dQ (K5), at Llama-1B's training shapes (batch 2, 32 heads after the
   GQA repeat, sequence 2048, head 64, causal), the same way: held against
   their plain versions in f32 (outputs atol 2e-5, gradients atol/rtol 1e-4),
   bf16 (atol 2e-3, rtol 1e-2, element by element, with the most that
   rounding P and dS to bf16 for the tensor cores can move each element
   added to the limit) and fp16 (atol 1e-3, rtol 5e-3, plus the same bound
   at fp16's unit 2^-11), then timed beside the plain
   version, the bound and, as the yardstick, SDPA (is_causal) and its
   autograd backward. Each `[flash]` line gives SDPA's error beside the
   kernel's. Then fp16 K4 and K5 on the range case: dO and V large, as
   under loss scaling, so that the plain version's dS passes fp16's 65504
   while dk, dv and dq fit; the kernels' outputs are finite and within
   the fp16 limit.
   Then the same at the families' shapes: K1 and K2 at GPT-NeoX-20B's
   (Hq = Hkv = 64, one K/V head per query head, D 96, which the scalar split
   kernel takes; bf16, int8 and fp8 pools) and K3-K5 at GPT-NeoX-20B's
   training attention (batch 1, 64 heads, sequence 2048, D 96) and
   GPT-J-6B's (16 heads of 256), in f32, bf16 and fp16 with fp16's range
   case. Then K3-K5 at T5's cross-attention shape (batch 2, 64 heads of 64,
   1024 queries over 2048 keys, non-causal, scale 1.0), f32 and bf16, with
   SDPA (is_causal=False, scale=1.0) as the yardstick. K3-K5 at Mixtral's
   attention (batch 1, 32 heads of 128, sequence 2048, causal) run with the
   families'. Then the repaired head dim 16 (phase 10 (a)): K3-K5 at
   batch 2, 4 heads of 16, sequence 1024, causal and non-causal (scale
   1.0), in f32, bf16 and fp16, and T5-tiny (d_kv 16) forward and backward
   at 1024 + 1024 tokens through them.
3. Engine: `create_named_model("llama-1b")` at full width and depth (random
   weights from a seed) served by `ContinuousBatcher(num_slots=8,
   page_size=16, max_length=2048)` over 16 requests of mixed lengths, half
   of them sharing a 256-token system prompt.
   (a) f32 at full width cut to 2 layers (`PARITY_LAYERS`; (b) and (e)
       hold the engine at full depth): greedy tokens of the "paged_kernel"
       engine equal the "gather" engine's, plain (K1's path) and
       speculative (K2's path).
   (b) bf16: the "paged_kernel" engine, plain and speculative, timed; every
       request finishes; each kernel's launch count, zeroed just before the
       run, equals layers x dispatches of that run and is > 0.
   (c) f32 (the 4-layer cut), KV cache quantized to int8 and to fp8 e4m3: greedy tokens of
       the "paged_kernel" engine equal the "gather" engine's, plain and
       speculative; both read the same quantized pool.
   (d) f32 (the 4-layer cut): with only the cache quantized, every request that does not
       share the system prompt has the unquantized engine's first token.
   (e) bf16 with int8 weights and an int8, then an fp8 e4m3 cache, plain
       and speculative, timed: decode tokens/s, TTFT p50, peak memory, the
       cache's bytes beside the bf16 engine's, and greedy agreement with the
       bf16 unquantized run (reported, not gated: random weights); the
       quantized kernel's launch count equals layers x dispatches and is
       > 0, and every other count is 0.
4. Generate: `create_named_model("llama-1b")` at full width and depth
   (random weights from seed 0) through `Generator(max_length=2048)`, the
   port's `generate`: prefill, then a decode loop over the model's decode
   cache (one shared write index, a persistent pad mask, the plain masked
   attention over the written prefix; JAX runs no Pallas kernel there
   either).
   (a) f32 at full width cut to 2 layers ((b) holds the path at full
       depth), greedy, gated: 4 prompts of 256 tokens, 32 new tokens each,
       give the "paged_kernel" engine's tokens (K1's path) row for row; the
       same with draft_tokens=4 gives the plain loop's; a left-padded batch
       of 64-256 tokens gives each prompt generated alone; a repetition
       penalty of 1.3 gives the paged engine's with use_repetition_penalty
       and that penalty per request; the contiguous engine (paged=False) on
       the engine phase's 16 requests gives the paged engine's tokens.
   (b) bf16, timed: the paged and the contiguous engine on the 16 requests
       (decode tokens/s, TTFT p50, the cache's bytes, peak memory); then
       `generate` at batch 1 on a 512-token prompt and at batch 8 left-padded
       128-512, 64 new tokens each (TTFT, the median of 3 one-token
       calls;
       decode tokens/s; peak memory), and with draft_tokens=4 at batch 1 on
       a prompt that repeats a 64-token passage (accepted tokens per verify
       step). Gates: every request finishes, every token id lies in the
       vocabulary, and no K1-K5 launch count moves over the generate runs
       and the contiguous engine.
   (c) with --profile, device time by kernel group of one more batch-1
       generate call, and the device's busy share of the unprofiled one.
5. Training, through `Accelerator.prepare(model, AdamW, loader, schedule)`
   and `train_step(max_grad_norm=1.0)`, sequence 2048, AdamW lr 1e-4,
   weight decay 1e-4, betas (0.9, 0.999), eps 1e-8:
   (a) f32 at Llama-1B's widths cut to 2 layers, batch 1, 3 steps, once
       through the flash kernels and once with
       ACCELERATE_TPU_ATTENTION_IMPL=xla (the plain attention), from the
       same weights and batch: the losses agree (rtol 1e-4), and the kernel
       run launched each flash kernel 2 layers x 3 steps times.
   (b) bf16 mixed precision, Llama-1B at full width and depth, batch 2: 2
       warm-up and 8 timed steps on one repeated batch; median step time,
       tokens/s, MFU (6 x non-embedding parameters x tokens/s over 989
       TFLOP/s), peak memory and the losses, which are finite and end below
       where they started; each flash kernel, counted from 0 just before the
       timed steps, launched 16 layers x 8 steps times.
   (c) with --profile, device time of one more bf16 step by group, and
       that of the grouped-query repeat (K/V copies forward, their sum over
       each group backward).
   (d) fp16 with dynamic loss scaling (default `GradScalerKwargs`: scale
       65536), Llama-1B at full width and depth, batch 2, 2 warm-up and 8
       timed steps: step time, tokens/s, MFU, the scale after each step and
       the steps skipped. Gates: finite losses; a timed step applied; layer
       0's query projection unchanged bit for bit across each skipped step
       (and changed by each applied one); the scales the scaler's rule gives
       for the skip pattern; the last loss below the first where two or more
       steps were applied; each fp16 flash kernel launched 16 layers x 8
       steps times, skipped steps included.
   (e) the checkpoint round trip of the 1-layer cut runs in phase 16 (b):
       the same `CheckpointManager` save after step 2 of 4
       over a `SeedableRandomSampler`, "latest" restored into fresh weights
       and the loader skipped to its position, the losses within rtol 1e-6
       of the uninterrupted run's, there across two launched processes.
   (f) activation checkpointing, `Accelerator(compilation_config=
       CompilationConfig(remat_policy=...))` under None, "full" and "dots":
       f32 at Llama-1B's widths cut to 2 layers, batch 1, 3 steps each,
       through the kernels: the losses under both policies equal those
       without remat (rtol 1e-6). Then bf16 at full width and depth, batch 2,
       2 warm-up and 4 timed steps each: step time, tokens/s, MFU, peak
       memory from the first timed step, the losses (their largest relative
       difference from the run without remat reported, not gated) and the
       flash launches. Gates: finite losses; under a policy K3 launched 2 x
       16 layers x 4 steps times (the forward, then the recompute in the
       backward) and K4, K5 16 x 4, without remat all three 16 x 4; peak
       memory under "full" below the run without remat. With --profile,
       device time by kernel group of one more step under each policy.
6. BERT: `create_named_model("bert-base")` (12 layers, hidden 768, 12
   heads, FFN 3072, vocab 30522; random weights from seed 0), f32, on one
   batch of 8 x 128 tokens with a padding mask and token types: the card's
   logits equal the same model's on the CPU within atol 1e-4. Then the
   port's twin of `examples/nlp_example.py`
   (`accelerate_tpu_torch.examples.nlp_example`) through its
   `training_function` with `--full` and its defaults (bf16, batch 32 x
   128, 512 training and 128 eval samples, 3 epochs): step time (the device
   synchronised at each `backward`), samples/s, MFU beside the GEMM dtype
   (f32 after each LayerNorm, the JAX package's dtype flow), peak memory,
   each epoch's loss and accuracy. Gates: finite losses, the last epoch's
   below the first's. Then the peak memory of one bf16 BERT-base step
   under remat None and "full", reported (with --profile, device time by
   kernel of one more step without remat). BERT runs no K1-K5: its
   attention is masked or short, as in the JAX package.
7. GPT-NeoX, GPT-J and OPT at their published widths (random weights from
   seed 0, made in their dtype on the card):
   (a) GPT-NeoX-20B through the paged engine: f32 at full width cut to 2
       layers, the kernel path's greedy tokens equal the gather path's,
       plain and speculative, unquantized and on int8 and fp8 caches, and
       `generate`'s equal the K1 engine's on 4 prompts of 256 tokens; then
       bf16 at 22 of its 44 layers (20.5 GB of weights, 8.9 GB of pools)
       over the
       first 8 of phase 3's requests, plain (K1) and
       speculative (K2), timed, launches
       gated as in phase 3; then int8 weights over an int8 and an fp8 cache
       at 4 layers (phase 3 holds int8 weights at full
       depth; the bf16 model the engine copies from and its int8 copy both
       on the card).
   (b) `generate` of GPT-NeoX-20B (at 22 of its 44 layers), GPT-J-6B and
       OPT-30B in bf16 at full depth, batch 1 on a 512-token prompt, 64 new
       tokens: TTFT, decode tokens/s, peak memory; no K1-K5 launch.
   (c) Training of each through `Accelerator.prepare` and `train_step`,
       sequence 2048, cut in depth (NeoX 2, GPT-J 4, OPT 2 layers): f32 at
       2 layers, batch 1, 3 steps, kernel losses against the plain
       attention's (rtol 1e-4); bf16 mixed precision with f32 masters, batch
       2, 2 warm-up and 4 timed steps (step time, tokens/s, MFU, peak
       memory; losses finite and falling; K3-K5 launched layers x 4 times at
       D 96, 256 and 128); 2 fp16 steps counting the fp16 kernels' launches.
8. T5 at T0pp-11B's published widths (vocab 32128, d_model 4096, 64 heads
   of 64, FFN 10240 gated-GELU, untied head; random weights from seed 0):
   (a) training through `Accelerator.prepare` and `train_step`, cut to 2
       encoder and 2 decoder layers, 2048 encoder and 1024 decoder tokens,
       no attention mask: f32, batch 1, 2 steps, the kernels' losses against
       the plain attention's (rtol 1e-4), and the first step's gradient of
       every parameter (relative norm 1e-4); bf16, batch 2, AdamW with weight
       decay, 2 warm-up and 4 timed steps (step time, tokens/s, MFU, peak
       memory; losses finite and falling). The cross-attention takes the
       flash gate (K3-K5 non-causal, Sq 1024 over Skv 2048, scale 1.0); every
       self-attention carries the relative bias and takes the plain path:
       each kernel launched 2 decoder layers x steps times.
   (b) `Seq2SeqGenerator`: f32 cut to 2 + 2 layers, its greedy tokens equal
       the uncached full-forward argmax loop's (one row right-padded under an
       attention mask); bf16 at the full 24 + 24 layers (22.3 GB), batch 8,
       prompts of 512 tokens (two right-padded under an attention mask), 128
       new greedy tokens: time to the first token (encode and prime), decode
       tokens/s, the decode step beside its weight-read bound, peak memory
       (with --profile, the device's busy share over one more call); no
       K1-K5 launch.
9. HF checkpoint interchange: Llama-1B bf16 written with
   `save_hf_checkpoint` into a temporary directory and loaded with
   `load_hf_checkpoint_in_model` into a model from another seed: the same
   tensors bit for bit, and the first 8 of phase 3's requests (phase 3
   serves all 16), plain (K1) and speculative (K2), give the original's
   tokens; the file's
   bytes, the save and load seconds and the directory's filesystem
   (`df -T`). Then T5 at T0pp-11B's widths cut to 2 + 2 layers round trips
   with bit-equal logits.
10. Mixtral-8x7B at its published widths (8 experts of FFN 14336, top 2,
   capacity factor 1.25; 32 heads of 128 over 8 KV heads; random weights
   from seed 0, made in their dtype on the card), cut in depth (93.4 GB in
   bf16 at 32 layers):
   (a) the head-dim-16 repair, run with the kernel phases (phase 2): the
       f32 T5-tiny loss through K3-K5 equals the plain attention's within
       2e-5 + 1e-4 |plain|, each kernel launched once per decoder layer,
       and the bf16 and fp16 runs' launches feed the `_d16` rows.
   (b) K3-K5 at Mixtral's attention, with the families' (phase 2); their
       launches are (d)'s.
   (c) `generate` through `Generator(max_length=1024)`: f32 at 2 layers
       and the dropless capacity factor 4.0, the cached greedy tokens equal
       the full-context greedy loop's for 8 new tokens; bf16 at 2 layers
       (6.2 GB), batch 1 on a 512-token prompt and a left-padded batch of 8
       (128-512 tokens), 128 new tokens each (TTFT, decode tokens/s, peak
       memory), no K1-K5 launch; the tokens the routers dropped at the
       prefill and at each decode step of the batch-8 call, counted by a
       forward hook on each router that routes its logits again; the
       device's busy share of a 16-token batch-1 call (`torch.profiler`).
   (d) training at 2 layers, `train_step`, batch 1 x 2048: f32 at narrow
       widths (hidden 1024, 8 heads of 128, FFN 3584), 3 steps, the kernel
       losses against the plain attention's (rtol 1e-4); bf16, 2 warm-up and
       8 timed steps (step time, tokens/s, peak memory, each step's ce and
       router losses, MFU over the work done, `mixtral_step_flops`; K3-K5
       launched 2 x 8 times); 2 fp16 steps.
   (e) with phase 9, a 1-layer bf16 cut saved with `save_hf_checkpoint`
       and loaded into a model from another seed: the same tensors bit for
       bit and the same greedy tokens.
11. fp8 mixed precision and ResNet, run after phase 5 (f):
   (a) the fp8 products at Llama-1B's eight linear shapes (wq, wk, wv, wo,
       w_gate, w_up, w_down, lm_head 2048 x 128256) at batch 2 x 2048
       tokens, in HYBRID through the port's autograd path
       (`ops.fp8.fp8_matmul`, `torch._scaled_mm` on the card): forward, dx
       (the gradient in e5m2) and dw, each held element by element to its
       plain version on the same fp8 operands and scales within a relative
       2^-7 (one bf16 rounding of each side) plus 2^-12 of the sum of the
       products' magnitudes (the tensor cores' accumulation, `FP8_ACC`);
       each timed (`_scaled_mm` on operands already laid out, CUDA events
       after an L2 flush, median of 20) beside a bf16 `torch.matmul` of the
       same shape, the plain version and the fp8 bound at 1979 TFLOP/s, with
       the quantize passes (amax, scale, cast of x, w and g) and the
       transposed fp8 copies `_scaled_mm`'s column-major operand needs, and
       their sum over one step's layers.
   (b) Llama-1B at full width and depth trained with
       `Accelerator(mixed_precision="fp8")` through `train_step`, as 5 (b)
       (batch 2, AdamW, 2 warm-up and 8 timed steps on one repeated batch):
       step time, tokens/s, MFU over 989 TFLOP/s and the same work over the
       fp8 peak, peak memory, the losses beside 5 (b)'s bf16 losses (same
       batch and seed) and the step time over bf16's. Gates: losses finite
       and falling; each bf16 K3-K5 launched 16 layers x 8 steps times and
       no other flash kernel; per step 16 x 7 + 1 fp8 forward products and
       as many dx and dw. With --profile, one more step's device time by
       part: `_scaled_mm`, the quantize passes, the layout copies, AdamW,
       K3-K5, the rest.
   (c) fp8 at Llama-1B's widths cut to 2 layers (f32 masters), batch 1, 3
       steps, without remat and under `remat_policy="full"`: equal losses
       (rtol 1e-6); the recompute, on the autograd engine's device thread,
       runs K3 and every layer's forward products again.
   (d) ResNet-50 (`resnet50()`, 25,557,032 parameters, random weights from
       seed 0) through `prepare` and `backward` with AdamW (lr 1e-3, decay
       1e-4), bf16, one repeated batch of 64 x 224 x 224 x 3 (numpy seed
       0): step time, images/s, peak memory. Gates: losses finite and
       falling; every BatchNorm buffer unchanged bit for bit.
12. A `{"kernels": [...]}` line (K1 and K2 unquantized and in both
   quantized modes at Llama-1B's and at GPT-NeoX-20B's shape, K3-K5 in
   bf16 and in fp16 at Llama-1B's head 64 and at heads 96, 256 and 128
   (Mixtral's, `*_d128`), in bf16 at T5's cross-attention shape,
   non-causal: `*_t5cross`, and in bf16 and fp16 at head 16, non-causal at
   scale 1.0, T5-tiny's path: `*_d16`; the bf16 K3-K5 rows count the
   launches of 5 (b) and 11 (b), whose attention is bf16), the nvidia-smi
   line, and as the last line `{"ok": true, "device": {...}}`.

13. Telemetry and the trace guard on the main paths, run after phase 11:
   (a) the Llama-1B paged engine of phase 3 (bf16, its 16 requests and
       engine arguments, full width cut to 2 layers: phase 3 holds the
       engine at full depth), plain and speculative, each
       after a warm-up, run without and with instrumentation (a b b a
       for plain, a b for speculative): instrumented is a fresh
       `MetricsRegistry`, a `Tracer` over a `FlightRecorder` streaming into
       a temporary directory (removed however the phase ends) and a
       record-mode `TraceGuard` ("log": each host sync recorded) armed around
       the steps. Gates: every run's tokens equal each other's; 16 submitted, 16 finished, 16 TTFTs;
       `serving_chunks_total` equals the engine's chunks; 16 `serve.request`
       and 16 `serve.insert` spans and one `serve.decode_chunk` span per
       chunk in the stream; the Perfetto JSON written and read back with the
       same spans; a scrape of `MetricsHTTPServer` (127.0.0.1) equal to the
       registry series by series; the guard saw 0 kernel builds and 0
       unsanctioned syncs; K1 (K2) launched layers x dispatches times.
       Reported: decode tokens/s and TTFT p50 of each run. Then a control:
       the plain engine once more with its sanctioned syncs unsanctioned
       (the engine's `allow_sync` a no-op) under a "log" guard, which must
       record syncs (by site: the chunk's uploads and readback, the
       insert's pushes and first-token read) and leave the tokens as they
       were: a guard that records none there sees nothing.
   (b) Llama-1B bf16 training at full width cut to 2 layers (5 (b) holds
       the step at full depth), 5 (b)'s batch and
       seed, 2 warm-up and 8 timed steps, through an `Accelerator` without
       and with `analyze=True` (a b b a; the analyzed one samples the
       "block" phase every 2nd step). Gates: losses equal within rtol 1e-6
       (bit for bit reported); `train_steps_total`, the
       `train_dispatch_seconds` count and `goodput()["steps"]` 10; the
       guard's 8 steady steps clean (0 builds, 0 syncs); K3-K5 each launched
       2 x 10 times. Reported: step times and the block share.
   (c) `Accelerator.profile()` around 2 more analyzed steps (the
       allocator's history recorded) and a `ProfilerManager` window around
       one engine step: the Chrome traces name `flash_fwd_wgmma_kernel`,
       `flash_bwd_dkv_wgmma_kernel`, `flash_bwd_dq_wgmma_kernel` and the
       paged split and merge kernels; `save_memory_profile` writes a
       non-empty snapshot.
   (d) a `.item()` planted in a step that `TraceGuard.wrap` guards: after
       the warm-up call the raising guard names its file:line in a
       `TraceGuardViolation`, a record-mode guard counts it once, and the
       sync debug mode is back to 0.

14. Data parallel and FSDP/ZeRO (`parallel/fsdp.py`), run after phase 13.
   With one card the strategies run through NCCL at world
   1 (``RANK=0``, ``WORLD_SIZE=1``, ``LOCAL_RANK=0``, at a store the
   script hosts on 127.0.0.1, set for the phase and put back, the process group torn
   down however it ends), where the group, the placed module, the
   collectives and the sharded optimizer state are all on the path; runs
   across processes are held to JAX on the CPU over gloo
   (`tests/test_torch_distributed*.py`).
   (a) Llama-1B bf16 with f32 masters at full width cut to 2 layers (5 (b)
       holds the fused step at full depth), 5 (b)'s
       batch (2 x 2048), seed and AdamW, 2 warm-up and 4 timed steps, each
       run through `Accelerator(...).prepare` and `train_step()`: the bare
       `Accelerator` (no group), then NO_SHARD, SHARD_GRAD_OP and
       FULL_SHARD, each paired with the bare run in one call (one pass
       since (d) runs the same strategies in fp8). Gates: the backend
       is "nccl"; NO_SHARD's losses equal the bare run's within rtol 1e-6
       (bit for bit reported); SHARD_GRAD_OP's and FULL_SHARD's within 1e-2
       relative at every step (the largest gap reported), finite, the last
       below the first; K3, K4 and K5 each launched 2 x 10 times per run;
       a `torch.profiler` window of one more FULL_SHARD step holds the
       collectives FSDP issues through NCCL (`nccl:*` ops). At one rank NCCL
       runs each as a device-to-device copy, so the window's NCCL kernels
       (none) and copies are reported, not gated. Reported per run: median step time, tokens/s, MFU (phase 5's
       accounting), peak memory, and each strategy's step time over the
       bare run's.
   (b) The trace guard on the steady step under NO_SHARD and FULL_SHARD
       (the 2-layer cut): 2 warm-up steps, then 4 under a record-mode `TraceGuard` ("log");
       reported: kernel builds and host syncs by site, the port's own frame
       and torch's innermost one. A sync in the port's code fails the phase.
   (c) A checkpoint across layouts: 1 layer of Llama-1B at full width under
       FULL_SHARD, `save_state` after step 3 (into a temporary directory,
       removed however the phase ends), a fresh FULL_SHARD `Accelerator`
       loads it and takes steps 4-6: losses within rtol 1e-6 of the run
       that was not cut. A bare `Accelerator` loads the same checkpoint:
       its weights equal the gathered FULL_SHARD ones bit for bit.
       Reported: save and load seconds, and bytes.
   (d) fp8 across the strategies: (a)'s setup with
       ``mixed_precision="fp8"`` and the default dynamic recipe, bare, then
       NO_SHARD, SHARD_GRAD_OP and FULL_SHARD, 2 warm-up and 4 timed steps
       each. Under a group every amax of an activation and a gradient is
       all-reduced (max) over it (`ops.fp8.AMAX_REDUCES`). Gates: NO_SHARD's
       losses equal the bare run's within rtol 1e-6 (bit for bit
       reported), the sharded ones within 1e-2 relative at every step,
       finite and falling; 15 fp8 products a step by role (7 a layer and
       the head's); the amax all-reduces exactly 2 x 15 a step under each
       strategy (each product's input and gradient) and 0 in the bare run;
       K3, K4 and K5 each launched 2 x 6 times per run (joining the Llama
       rows of the `kernels` line); no kernel built. Reported: each run's
       median step time beside the bare fp8 run's (at world 1 the gap is
       the cost of the amax collectives) and (a)'s bf16 step times.

15. The user's surface, run after phase 14: the rest of JAX's one-process
    `Accelerator`, driven as a user's script drives it, on Llama-1B at full
    width and depth (random weights from seed 0, bf16, batch 2 x 2048, AdamW
    with decay 1e-4).
   (a) ``Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2,
       step_scheduler_with_optimizer=True, dataloader_config=
       DataLoaderConfiguration(dispatch_batches=True), rng_types=[python,
       numpy, generator, torch], kwargs_handlers=[AutocastKwargs(),
       InitProcessGroupKwargs(timeout=5 min)])``, `prepare` of the model,
       the optimizer, a loader of 8 distinct batches and ``lr / (1 + step)``,
       then 4 optimizer steps of `accumulate` -> `backward` ->
       `clip_grad_value_(1.0)` -> `optimizer.step()` -> `scheduler.step()`.
       Gates: the `DataLoaderDispatcher` was prepared; after each optimizer
       step the scheduler's count and the optimizer's lr are the schedule's
       at JAX's count (one a step at one process); K3, K4 and K5 launched
       16 x 8 times each, in bf16; the same loop over the plain
       `DataLoaderShard` (``dispatch_batches=False``) gives the same losses
       bit for bit. Inside ``autocast(AutocastKwargs(enabled=False))`` one
       forward's logits equal bit for bit those of the same module prepared
       with ``mixed_precision="no"``, and both ran the f32 K3
       (`flash_fwd_kernel`), 16 launches each.
   (b) `save_model` of the trained masters at ``max_shard_size="2GB"`` into
       a temporary directory (removed however the phase ends): seconds,
       bytes and shards reported; the shards read back through the port's
       reader into a fresh model give the same logits bit for bit.
   (c) The memory twin's loop (`examples/by_feature/memory.py`) on
       Llama-1B bf16 from batch 64 x 2048: each attempt's batch size, the
       error `is_oom_exception` caught (a real CUDA out-of-memory error),
       `torch.cuda.memory_allocated()` before and after each
       `free_memory`, and the size found. Gates: the sizes halve from 64,
       every error caught is one, each `free_memory` brings the allocated
       bytes back within 64 MiB of the phase's start, and the size found
       trains a step to a finite loss.
   (d) The twins: `cv_example` in bf16 for 3 epochs (accuracy above 0.5, as
       JAX's script asserts), `early_stopping` with patience 1 (it stops,
       and its trigger is clear after), `tracking` with the JSON tracker
       (its records are the logged epochs).

16. Launch and the CLI, run after phase 15 and driven as a user drives them:
    ``python -m accelerate_tpu_torch.commands.accelerate_cli ...`` with the
    checkout on ``PYTHONPATH`` (the parent frees its card memory before each
    and logs `memory_allocated`); (b)'s in a fresh process, (a)'s ``launch``
    and (c)'s ``test`` with the dispatcher in this process (each fresh
    interpreter costs 10-17 s here), their children fresh processes. The user's script
    (`LAUNCH_SCRIPT`, written to a temporary directory) builds its
    `Accelerator` from the launcher's variables; the parent runs the same
    functions of the same file for each comparison.
   (a) ``config --default --config_file F`` (bf16), then ``launch
       --config_file F --gradient_accumulation_steps 2 --num_processes 1 S``:
       phase 15 (a)'s eager loop on Llama-1B at full width cut to 2 layers
       (phase 15 runs it at full depth; random weights from seed 0, batch
       2 x 2048, 4 micro-steps, 2
       optimizer steps) under ``Accelerator()``. Gates: the child reads
       bf16, accumulation 2, one process and ``cuda:0``; it built no kernel
       (its build listener heard nothing: the libraries the parent built are
       loaded from ``build/``); K3-K5 launched 2 x 4 times each in bf16; its
       4 losses equal, bit for bit, the same loop in this process under
       ``Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2)``.
   (b) ``launch --max_restarts 1 --trace_dir D --mixed_precision bf16 S`` on
       the 1-layer cut at full width (batch 2 x 2048, fused steps): the
       first attempt saves its state after step 2 and exits 1; the second
       finds the checkpoint, loads "latest", skips the 2 batches and takes
       steps 3 and 4. Gates: exactly 2 attempts; the losses of both attempts
       within rtol 1e-6 of the uninterrupted 4 steps run here; ``trace
       export D`` (the dispatcher's file commands run in this process: a fresh
       interpreter costs 10-15 s there) and the span files hold one trace id, 2
       ``supervisor.attempt`` spans with exit codes 1 and 0, attempt 1's
       ``checkpoint.save`` and 2 ``train.step`` spans under it and attempt 2's
       ``checkpoint.load`` and 2 steps under it; ``trace report D`` counts 2
       crash/exit boundaries; no child built a kernel.
   (c) ``test`` exits 0 (the bundled script at one process on ``cuda:0``) and
       ``env`` names the card.
    Reported: each command's wall time, each child's peak memory, save and
    load seconds. The children's K3-K5 launches, and the parent's loops',
    join the Llama rows of the `kernels` line.

17. Big-model inference and the offload tiers, run right after OPT-30B's
    generate phase (10 (b)), whose model it takes over (one model, made
    once), and driven as a user drives them. First bf16 K3 at OPT-30B's
    generation shape (batch 1, 56 heads of 128, S 2048, causal), held and
    timed as phase 2 holds and times it. Then OPT-30B at full width and
    depth (48 layers, 59.9 GB in bf16, random weights from seed 0), a
    1024-token prompt (batch 1), its first forward's logits and 8 new
    tokens through `DispatchedModel.generate` (the first forward at 1024
    tokens, the rest at the 2048 bucket: K3 at every layer of each):
   (a) `dispatch_model(model, {"": 0})`: the resident reference.
   (b) `infer_auto_device_map` with 48 GiB for the card (the reference's
       2 x 24 GB row) and the host's available RAM: 40 layers on the card,
       8 pinned in host RAM, streamed by `OPTLayeredApply`. A host without
       the cpu tier's bytes raises, naming them.
   (c) 40 GiB for the card, 13.6 GB of host RAM, the rest (4 layers, 4.9
       GB) in the disk store under a temporary directory.
   Gates for (b) and (c): the first forward's logits equal (a)'s bit for
   bit and the 4 tokens are (a)'s; K3 launched 48 x 5
   times; the bytes on
   the card after dispatch within the card's budget; the peak during
   `generate` at most the resident bytes plus two layers plus (a)'s
   activations (the slack reported); no copy from unpinned host memory.
   Reported: dispatch seconds and bytes per tier, TTFT and seconds per
   token, the bare host-to-device GB/s of one layer, the share of the copy
   hidden under compute (the streamed token against the resident one plus
   the bare copy), peak memory, host MemAvailable; for (c) the store's
   write seconds and its read GB/s (the page cache warm from the write).
   (d) Llama-1B bf16 written by `save_model` (1 GB shards, a temporary
       directory) and read by `load_checkpoint_and_dispatch` onto
       `init_empty_weights` with budgets that send blocks to host RAM and
       disk: logits equal the resident model's bit for bit. Then
       `cpu_offload_with_hook` on it and a 2-layer model chained after it:
       after the second runs, the first's weights are in host RAM; both
       outputs bit for bit.
   (e) `load_and_quantize_model` on Llama-1B bf16 in int8, int4 and nf4:
       the codes and scales made on the card equal the CPU's bit for bit
       (layer 0's weights and the head), the bytes held equal
       `quantized_nbytes`, the quantized logits finite.
   (f) ``estimate-memory opt_30b llama-1b`` through the dispatcher: its bf16
       totals equal the parameter bytes of (a)'s and (d)'s models.

18. Training past the card, run after the families' training phases: the
    offload tiers of the optimizer's state and the masters on GPT-J-6B
    (full width, random weights from seed 0), bf16 with f32 masters, batch
    1 x 2048 on one repeated batch, torch AdamW (lr 1e-4, decay 1e-4,
    `foreach=True`), clip 1.0, through `accelerator.train_step()`. First
    the host's MemTotal/MemAvailable and a bare copy of 1 GiB between a
    pinned arena and the card, each way.
   (a) Cut to 1 layer, 2 steps each: resident; the optimizer's state in
       pinned host RAM (`offload_optimizer_state=True`); it and the masters
       (`cpu_offload=True`); the state in the disk store under a temporary
       directory (`offload_optimizer_device="disk"`); `DeepSpeedPlugin`
       with ``offload_optimizer: {"device": "nvme"}``. Gates: each run's
       losses and its masters after the second update equal the resident
       run's bit for bit; K3-K5 launched 1 x 2 times. Reported per run:
       peak memory, step and update seconds, bytes moved a step; for the
       disk runs the store's write and (warm) read GB/s.
   (b) Full depth (28 layers, 6,050,882,784 parameters) through
       ``Accelerator(mixed_precision="bf16", deepspeed_plugin=DeepSpeedPlugin(
       hf_ds_config={"zero_optimization": {"stage": 2, "offload_optimizer":
       {"device": "cpu"}}}))``, the reference's ZeRO-Offload config: 1
       warm-up and 2 timed steps. Resident AdamW would need 18 bytes a
       parameter before activations (f32 masters, gradients and two
       moments, bf16 copies), past the card; with the moments in pinned
       host RAM, 10. Gates: losses finite and the last below the first;
       K3-K5 launched 28 x 3 times; the peak below the card's memory and
       the resident reckoning. Reported: the peak beside both reckonings
       (the port's size accounting), step time split into forward and
       backward and the update, the update beside its copy bound (the
       moments' bytes each way at the bare copy's rate), tokens/s, MFU.

19. Async and sharded checkpoints and preemption, run after phase 18, on
    Llama-1B at full width cut to 1 layer (586,160,128 parameters: 7.03 GB
    of f32 masters and AdamW moments), random weights from seed 0, bf16
    with f32 masters, batch 2 x 2048 on one repeated batch, AdamW (lr 1e-4,
    decay 1e-4), clip 1.0, through `accelerator.train_step()`; the
    checkpoints under a temporary directory (its filesystem reported),
    removed however the phase ends. One commit serves (a), (b) and (d).
   (a) ``Accelerator(mixed_precision="bf16", async_save=True,
       save_interval=4, project_config=ProjectConfiguration(
       automatic_checkpoint_naming=True, total_limit=2))``,
       `maybe_save_state(sharded=True)` after each step: the save after
       step 4 goes to the committer (the first save, which makes and pins
       the host buffers), and 16 more steps run while it commits,
       `poll_async_checkpoint()` after each. Gates: its masters and moments
       equal a host copy taken right after step 4 bit for bit ((d) gathers
       them), and every one differs from the state at the drain;
       `checkpoint_commits_in_flight` read 1 after the save and 0 after the
       drain; `checkpoint_async_commit_seconds` has one observation; the
       ledger's "checkpoint" charge is the save's blocking seconds while it
       commits, below the commit's. Reported: blocking and commit seconds,
       the host buffers' setup seconds and bytes, and the median step
       before, during and after the commit.
   (b) `register_preemption_checkpoint(D, exit_on_save=False)` (D the
       project's checkpoint base) and SIGTERM to this process while (a)'s
       commit is in flight; after the next step `check_preemption()` drains
       it, saves synchronously under D and returns True. Gates: the commit
       was in flight at the signal, both checkpoints verify ((c)'s and
       (d)'s loads verify them), (a)'s published first; the ledger then holds
       (a)'s blocking seconds and the synchronous save's. Reported: the
       drain's and the synchronous save's seconds. Then 4 more steps, and a
       warm async save (the buffers kept) whose blocking seconds are
       reported, aborted with `abort_async_checkpoint()`: it never
       publishes. Each save's blocking seconds beside the synchronous
       save's is what the committer buys on this filesystem.
   (c) A fresh accelerator (weights from seed 1) `load_state(D)`s its
       newest verified checkpoint (the preemption's) and takes those 4
       steps: losses within rtol 1e-6 of the first accelerator's (bit for
       bit reported).
   (d) A FULL_SHARD `Accelerator` at world 1 over NCCL (phase 14's
       strategy, torch's `fully_shard`) loads (a)'s sharded checkpoint
       (``host_0000/``, its ``SHARD_DONE``, the manifest's ``"sharded"``
       block, each checked): its gathered masters and moments equal the
       copy after step 4 bit for bit.
   Gates over the phase: K3-K5 launched 1 x 29 times each in bf16 (joining
   the Llama rows of the `kernels` line), and no kernel built.

20. The example twins and the quality gate, run last, in this process (a
    fresh interpreter costs 10-17 s here):
   (a) These twins of `accelerate_tpu_torch/examples/`, each at
       the arguments JAX's `tests/test_examples.py` gives its script:
       gradient_accumulation, automatic_gradient_accumulation,
       checkpointing (one epoch saved, then a resume to two),
       cross_validation, multi_process_metrics (35 eval rows),
       device_training_loop, profiler, fsdp (in a world-1 NCCL group, so
       torch's FSDP places BERT), schedule_free, complete_nlp_example (one
       epoch saved by epoch, then a resume to two with tracking),
       distributed_inference (in a world-1 NCCL group) and
       quantized_inference (8-bit, then 4-bit). Gates: the line JAX's test
       looks for is in the twin's output, every printed loss is finite,
       and every parameter of the models it built is on the card (a
       quantized one is codes on the card). The output directories are
       removed however the phase ends. Reported: each twin's seconds.
   (b) The quality gate (`test_utils/scripts/test_performance.py`) through
       its `main`: "dp" at JAX's full recipe (`text_pair`, 14 epochs,
       bf16): accuracy at least 0.82 and a gathered count of 128 (the
       script raises otherwise); "offload" (FULL_SHARD
       with the optimizer state in pinned host memory) in a world-1 NCCL
       group for one epoch, JAX's fast tier (phase 14 runs SHARD_GRAD_OP
       on Llama-1B): a final loss finite and below 1.0. Reported: each strategy's
       accuracy, final loss, peak memory and seconds.
21. Convert and tensor parallel, run after phase 20. Two ranks share card 0
    over gloo (NCCL takes one rank a device), so every collective is staged
    through the host: their times say nothing of NVLink.
   (a) Llama-1B's 2 layers and norms at full width, seed 0, bf16 (the
       embedding and head cut to 1024 rows: the whole 2-layer file's
       deflated write passed 40 s), written as HF safetensors
       (`save_hf_checkpoint`), `convert` to the native pytree file
       through the dispatcher's `main` in this process, loaded back, and
       `convert --direction to_hf`. Gates: the loaded parameters equal the
       original's bit for bit, the manifest's digest verifies, and the
       round trip's safetensors hold the same keys and tensors. Reported:
       each direction's seconds and MB.
       (a) runs in the parent while the ranks run (b)-(e).
   (b) Llama-1B at full width and depth from seed 0, bf16, served by
       `ContinuousBatcher(tp=2)` in a spawned world of 2 (16 query and 4 KV
       heads a rank, K1 and K2 at those heads) at phase 3's setting (8 of
       its requests): bf16 pools, int8 weights with int8 pools, and speculative (draft 3; the
       int8 and speculative runs decode at most 8 tokens a request); the
       tp=1 engine runs the same requests here first. Each rank holds the
       model on the host and each engine moves only the rank's split to
       the card. Gates: both ranks'
       tokens and prefill logits equal; each request's prefill logits
       within 0.05 of the largest |logit| of tp=1's; each first token
       tp=1's unless tp=1's top two logits lie within that limit; a rank's
       weight and pool bytes, and its `max_memory_allocated` over the run
       (the engine's build included), at most 1/1.6 of tp=1's; the ranks issue the
       same collectives; K1 (K2 for speculative) launched on each rank; no
       rank builds a kernel. Reported: the share of tokens equal to tp=1's,
       tp=1's top-two gap where a request's tokens first part, decode
       tokens/s and TTFT at tp=2 beside tp=1's. Before them, K1/K2 (bf16
       and int8 pools) and K3-K5 (bf16) are held and timed at a rank's
       heads (`TP_KERNEL_SHAPE`, `TP_FLASH_SHAPE`).
   (c) In the same world, Llama-1B cut to 2 layers through `prepare` and
       `train_step()` under `ParallelismConfig(model=2)`: bf16 with f32
       masters, 2 x 2048, AdamW lr 1e-4, decay 1e-4, clip 1.0, 1 warm-up
       and 2 timed steps, against the same run at tp=1 here. Gates: the
       ranks' losses and pre-clip norms equal; losses finite, falling, and
       within 1e-2 relative of tp=1's at every step; norms within 1e-3;
       K3-K5 launched 2 x 3 times on each rank. The ranks hand `prepare`
       the model on the host, which splits it there and moves the split.
       Reported: the median step time and the steps' peak card memory
       beside tp=1's.
   (d) In the same world, a planned engine: Llama-1B at full width and
       depth served by `ContinuousBatcher(tp=2, sharding_rules="auto",
       sharding_refine_top_k=2)` on the card's chip (`h100-sxm`), (b)'s 8
       requests (4 sharing the 256-token prompt) at 16 new tokens.
       Gates: both ranks hold the same rules (an all-gathered digest); the
       rules are one of the top 2 plans the parent computes before the
       spawn from a `meta` model with the same chip and pool, and each
       rank measured those candidates in that order; a rank's weight and
       pool bytes within 10% of the plan's predicted per-chip bytes (JAX's
       round-trip bound); `max_memory_allocated` at most 1/1.6 of tp=1's;
       prefill logits and first tokens against (b)'s tp=1 run as (b) gates
       them; K1 launched on each rank. Reported: each candidate's measured
       seconds (the slower rank's) beside its predicted step time, the
       embedding's split, decode tokens/s beside (b)'s hand-table run.
   (e) Planned training in (c)'s setting under `sharding_rules="auto"`:
       model=2 (1 warm-up and 2 timed steps) and data=2 (1 x 2048 a rank,
       the parameters whole, the moments split over "data" by the plan's
       ZeRO table; 1 warm-up and 1 timed step), against (c)'s tp=1
       losses. Gates: losses finite and within 1e-2 relative of tp=1's at
       every step, equal across the ranks; at data=2 a rank's live moment
       bytes at most 0.55 of tp=1's and within 1% of the plan's
       `per_chip_opt_bytes` (the step counts aside); K3-K5 launched on
       every rank. Reported: each mesh's median step time beside (c)'s.
       `--plan-only` runs the build and (d)-(e) alone, with the tp=1 runs
       they are held to.
   (f) In the same world, the other families trained over their tables
       (`TP_FAMILIES`): GPT-J-6B at 2 layers, 1 x 2048; OPT-30B at 2
       layers, 1 x 2048; T0pp-11B at 2 + 2 layers, 2048 encoder and 1024
       decoder tokens, no mask (the cross-attention takes the flash gate);
       BERT-base at full depth, 32 x 128; each at its published widths from
       `create_named_model`'s config, random weights from seed 0, through
       `prepare` and `train_step()` under `ParallelismConfig(model=2)`:
       bf16 with f32 masters, AdamW lr 1e-4, decay 1e-4, clip 1.0, 1 warm-up
       and 2 timed steps, each against the same run at tp=1 here (run while
       the ranks start). The ranks hand `prepare` the model on the host.
       Gates: the ranks' losses and pre-clip norms equal; losses finite and
       within 1e-2 relative of tp=1's at every step, norms within 1e-3
       (T0pp-11B's, 532 at the start, within 1e-2: `TP_FAMILY_NORM_RTOL`); a
       rank's live parameters at most 0.6 of tp=1's; K3-K5 launched layers
       x 3 times on each rank (T5's decoder layers; BERT none, as in JAX).
       Before the world, K3-K5 (bf16) are held and timed at each family's
       rank shape (`TP_FAMILY_FLASH`: GPT-J 8 heads of 256 causal, OPT-30B
       28 heads of 128 causal, T0pp's cross-attention 32 heads of 64, 1024
       over 2048 keys, non-causal, scale 1.0). Reported: each family's
       median step time and the steps' peak card memory beside tp=1's (the
       tp=2 times are two ranks time-sliced on one card over host-staged
       gloo, not NVLink). `--tp-families-only` runs the build and (f) alone.

`--fp8-only` runs the build and phase 11 alone, `--telemetry-only` the build
and phase 13 alone, `--dist-only` the build and phase 14 alone,
`--surface-only` the build and phase 15 alone, `--launch-only` the build and
phase 16 alone, `--bigmodel-only` the build and phase 17 alone,
`--offload-train-only` the build and phase 18 alone, `--checkpoint-only` the
build and phase 19 alone, `--examples-only` the build and phase 20 alone,
`--tp-only` the build and phase 21 alone, `--plan-only` the build and
phase 21 (d)-(e) alone, `--tp-families-only` the build and phase 21 (f)
alone, `--tp-precision-witness` the build and T0pp-11B at (f)'s cut in f32
at tp=2 against tp=1 and in bf16 against f32 at tp=1 (what parts its norms),
and `--kernels-only` stops after phase 2 (none prints a result line). Each phase prints its wall time on a `[time]` line, and the
whole script's before the `kernels` line.

TF32 is off for matmuls and cuDNN (`allow_tf32 = False`), so f32 means f32.

    python3 chip_smoke.py --compare TREE [TREE ...] [--head-dim D]

times the kernels of several source trees on the card instead, in turns.
Each TREE is a directory that holds `accelerate_tpu_torch/`: this checkout
(`.`), a `git archive` of another commit, or a copy with one constant
changed, unpacked under the git-ignored `scratch/`. Every tree runs in a
process of its own, which builds its kernels into TREE/build/, in the order
given and then in reverse (a b b a), so that drift on the card weighs on
both sides alike. Each run prints one `[compare]` JSON line: K1 and K2
with bf16 queries at the kernel phase's shape over bf16, int8 and fp8
pools, each with its largest error against the plain version, its and the
library call's times as above, the wall time per call of 1408 calls back
to back (one serving run's) and the host's time per call over the first
256, then ptxas' report of the tree's paged kernels; K3, K4 and K5 in bf16 at the training shape (head dimension
D if given), timed as above, each kernel's largest error against its plain
version, SDPA's forward time as a yardstick of the card, and ptxas' report
of the tree's wgmma kernels; and K3-K5 the same way at T5's cross-attention
shape (non-causal, scale 1.0). It prints no result line.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# f32 CUDA cores; bf16 and fp16 tensor cores (dense, the same rate for both)
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.float16: 989e12}
F32_ATOL = 2e-5
# bf16: both sides widen the same bf16 inputs and compute in fp32, so they
# differ by the fp32 summation order plus at most one bf16 rounding of the
# output (a relative 2^-8). Long slots' outputs are small (about
# sqrt(e / L): 0.036 at L = 2048), so the absolute limit is kept well below
# them; the measured error is about 2e-4.
BF16_ATOL, BF16_RTOL = 2e-3, 1e-2
TIMED_LAUNCHES = 20  # fewer calls for the script's 1200 s limit
# Device clock cycles `time_ms(spin=True)` spins before each timed call
# (0.5 ms at the H100's 1.98 GHz boost clock).
SPIN_CYCLES = 1_000_000
# Back-to-back calls `paged_compare` times for a wall time per call: the K1
# (and K2) calls of one serving run, 16 layers x 88 dispatches. The host
# time per call is read over the first HOST_CALLS of them, which a launch
# queue holds without making the host wait for the device.
SERVING_CALLS = 1408
HOST_CALLS = 256

# Llama-1B attention at the engine's shapes.
KERNEL_SHAPE = dict(slots=8, hq=32, hkv=8, d=64, page_size=16, max_length=2048, verify_s=5)
REPLACES = {
    "decode": "accelerate_tpu/ops/paged_attention.py:67",
    "verify": "accelerate_tpu/ops/paged_attention.py:117",
}
KV_DTYPES = ("int8", "fp8_e4m3")
SOURCE = "accelerate_tpu_torch/csrc/paged_attention.cu"
# GPT-NeoX-20B's attention at the engine's shapes: 64 query heads, each with
# its own K/V head (G = 1), head 96; slots, pages and lengths as Llama's.
NEOX_KERNEL_SHAPE = dict(KERNEL_SHAPE, hq=64, hkv=64, d=96)

# Llama-1B's training attention: batch 2 x 32 query heads (K/V repeated from
# 8), sequence 2048, head 64, causal.
FLASH_SHAPE = dict(b=2, hq=32, s=2048, d=64)
FLASH_DESIGN = {
    "flash_fwd": "bf16: wgmma m64n128k16 s = q.k^T (q, k from shared memory) and m64n64k16 o += p.v (p "
                 "from registers), TMA 3-D loads of 128-key K/V tiles through a 2-stage ring, one "
                 "warpgroup of 64 query rows per block; f32: scalar fp32 FMAs",
    "flash_bwd_dq": "bf16: wgmma m64n64k16 s = q.k^T and dp = do.v^T from shared memory, m64n64k16 "
                    "dq += ds.k (ds from registers), TMA 3-D loads of 64-key K/V tiles through a 2-stage "
                    "ring, one warpgroup of 64 query rows per block; f32: scalar fp32 FMAs",
    "flash_bwd_dkv": "bf16: wgmma m64n64k16 sT = k.q^T and dpT = v.do^T from shared memory, m64n64k16 "
                     "dv += pT.do and dk += dsT.q (pT, dsT from registers), K/V tiles loaded once and TMA "
                     "3-D loads of 64-row Q/dO tiles through a 2-stage ring, lse and delta staged in shared "
                     "memory, one warpgroup of 64 keys per block; f32: scalar fp32 FMAs",
}
FLASH_FP16_DESIGN = {
    "flash_fwd": "; fp16: the bf16 kernel's template with .f16 wgmma and FLOAT16 tensor maps, p narrowed as "
                 "p * 2^15 and o scaled back",
    "flash_bwd_dq": "; fp16: the bf16 kernel's template with .f16 wgmma and FLOAT16 tensor maps, ds narrowed as "
                    "ds * 2^(14 - e), e the exponent of the row's largest |ds| so far, the accumulator rescaled by "
                    "powers of two",
    "flash_bwd_dkv": "; fp16: the bf16 kernel's template with .f16 wgmma and FLOAT16 tensor maps, pT narrowed as "
                     "pT * 2^15, dsT as dsT * 2^(14 - e) per key row with the dk accumulator rescaled",
}
PAGED_DESIGN = ("bf16: grid (Hkv, slots, splits of 256 tokens x row groups) and a merge kernel launched as a "
                "programmatic dependent; whole-page tiles of 64 tokens through a 2-stage cp.async ring at the "
                "pool's own width; mma.sync m16n8k16 s = q.k^T and o += p.v (p as bf16 hi + lo) with query rows "
                "as M, int8/e4m3 widened to bf16 in registers, page scales on the score and p columns; f32: "
                "scalar fp32 FMAs in the same split and merge")
PAGED_SCALAR_DESIGN = ("bf16 and f32 q at D 96 (GPT-NeoX-20B, G = 1): paged_split_scalar_kernel, scalar fp32 FMAs "
                       "over the pool's own width in the same grid of 256-token splits and the same merge kernel; "
                       "the mma.sync route takes D 32, 64 and 128")
# The training attention of GPT-NeoX-20B (64 heads of 96), GPT-J-6B (16
# heads of 256) and Mixtral-8x7B (32 heads of 128 after the GQA repeat from
# 8, as Llama-3-8B's): batch 1, sequence 2048, causal. OPT-30B's 56 heads of
# 128 run the D 128 kernels too.
FAMILY_FLASH_SHAPES = {96: dict(b=1, hq=64, s=2048, d=96), 256: dict(b=1, hq=16, s=2048, d=256),
                       128: dict(b=1, hq=32, s=2048, d=128)}
# K3-K5 at head dim 16, T5-tiny's d_kv (4 heads): batch 2, sequence 1024.
D16_FLASH_SHAPE = dict(b=2, hq=4, s=1024, d=16)
# T5's cross-attention in training (T0pp-11B's heads: 64 of 64): a 1024-token
# decoder over a 2048-token encoder, batch 2, non-causal, scale 1.0 (T5 does
# not scale its scores): K3-K5's non-causal mode over Sq < Skv.
T5_CROSS_FLASH_SHAPE = dict(b=2, hq=64, s=1024, sk=2048, d=64)
T5_CROSS_DESIGN = ("; T5 cross-attention: non-causal, Sq 1024 over Skv 2048, scale 1.0, every key tile "
                   "visible to every query tile")
WIDE_FLASH_DESIGN = {
    96: "; D 96: three 32-column panels at the 64B swizzle, wgmma n64 + n32 for the D-wide products, 64-key tiles",
    256: "; D 256: four 64-column panels at the 128B swizzle, two wgmma n128 for the D-wide products, 64-key "
         "tiles; K4 over a third grid dimension of two column halves of dK and dV, each recomputing sT and dpT "
         "over the full D (1.5x K4's products, 255 registers a thread otherwise too few)",
    128: "; D 128 (Mixtral-8x7B): two 64-column panels at the 128B swizzle, wgmma n128 for the D-wide "
         "products, 64-key tiles in K3",
    16: "; D 16 (T5-tiny's cross-attention: non-causal, scale 1.0): one 16-column panel at the 32B swizzle, "
        "the score products one k16 step, wgmma n16 for the D-wide products, 128-key tiles in K3; f32: one "
        "thread a row",
}
FLASH_KERNELS = {
    # name: (TPU kernel it replaces, products of 2 * BH * pairs * D operations it needs)
    "flash_fwd": ("accelerate_tpu/ops/flash_attention.py:53", 2),       # s, p @ v
    "flash_bwd_dkv": ("accelerate_tpu/ops/flash_attention.py:126", 4),  # s, dp, dv, dk
    "flash_bwd_dq": ("accelerate_tpu/ops/flash_attention.py:174", 3),   # s, dp, dq
}
FLASH_SOURCE = "accelerate_tpu_torch/csrc/flash_attention.cu"
# f32: the kernels and the plain versions sum the same fp32 products in
# another order; a gradient sums up to 2048 of them. bf16: as for K1/K2, one
# bf16 rounding of the output (2^-8 relative) above that; and the kernels
# feed the tensor cores P and dS rounded to bf16, as FlashAttention-2/3 and
# SDPA do, which the fp32 plain versions do not. Round to nearest moves each
# p (ds) by at most BF16_UNIT of itself, so o moves by at most BF16_UNIT *
# (P @ |V|) (P the normalised probabilities), dq by at most BF16_UNIT *
# (|dS| @ |K|), dv by at most BF16_UNIT * (P^T @ |dO|) and dk by at most
# BF16_UNIT * (|dS|^T @ |Q|), element by element: in rows that see few keys
# (keys that few rows see) that exceeds atol 2e-3 where the output is small.
# Their limit is atol + rtol |ref| plus that bound (`flash_rounding_bound`),
# from the plain versions' own P and dS.
FLASH_F32_TOL = {"out": dict(atol=2e-5, rtol=0.0), "grad": dict(atol=1e-4, rtol=1e-4)}
# The f32 kernels' plain versions run on the same inputs widened to float64
# (the plain versions then compute in float64): at T5's scale 1.0 the scores
# are sqrt(D) times wider than at 1/sqrt(D), and an f32 GEMM's own rounding
# of them moves o by most of the 2e-5 limit (SDPA's f32 o against float64:
# 1.5e-5 at T5's cross shape on one H100), where the kernel's lane-split sums
# err less (8.5e-6).
F32_REFERENCE = torch.float64
BF16_UNIT = 2.0 ** -8  # round to nearest bf16: |fl(x) - x| <= 2^-8 |x|
FLASH_ROUNDED = {  # outputs whose bf16 limit adds the rounding bound: what it is
    ("flash_fwd", "o"): "2^-8 * (P @ |V|)",
    ("flash_bwd_dkv", "dk"): "2^-8 * (|dS|^T @ |Q|)",
    ("flash_bwd_dkv", "dv"): "2^-8 * (P^T @ |dO|)",
    ("flash_bwd_dq", "dq"): "2^-8 * (|dS| @ |K|)",
}
FLASH_LSE_TOL = dict(atol=2e-5, rtol=1e-5)
# fp16 (mixed_precision="fp16"): the same kernels with fp16 operands. fp16
# keeps 11 significant bits, so one rounding of the output is a relative
# 2^-11 and the rounding of P and dS for the tensor cores moves each element
# by at most FP16_UNIT of it: the bound above with that unit. The kernels
# scale P by 2^15 and dS by a power of two per row before narrowing them
# (csrc/flash_attention.cu), so that neither leaves fp16's normal range; an
# element far below its row's largest may still go subnormal, and moves by
# at most 2^-39 of that largest, which the atol covers.
FP16_ATOL, FP16_RTOL = 1e-3, 5e-3
FP16_UNIT = 2.0 ** -11  # round to nearest fp16 (normal range): |fl(x) - x| <= 2^-11 |x|
ROUNDING_UNIT = {torch.bfloat16: BF16_UNIT, torch.float16: FP16_UNIT}
UNIT_TEXT = {torch.bfloat16: "2^-8", torch.float16: "2^-11"}
FP16_MAX = 65504.0
# The fp16 range case: q and k small, so that each causal row spreads its
# probability evenly over the keys it sees; v and dO large, as dO is under
# loss scaling. The plain version's fp32 dS then tops out near 2^17, past
# fp16's 65504, while dK, dV and dQ still fit fp16 (the plain version on
# the CPU at sequence 2048, head 64: over 16 heads |dS| up to 1.76e5, dk
# 1.6e4, dq 1.2e4, dv 8.8e3). A kernel that rounded dS to fp16 as it is
# would write inf.
FLASH_RANGE_SCALES = dict(q=0.02, k=0.02, v=100.0, do=2000.0)
# In the range case dP = dO . V^T runs to about 2^21, where fp32 keeps a
# unit of 0.125: summed in the kernel's order and in the plain version's,
# dP - delta differs by such units even where P * (dP - delta) is 0 in exact
# arithmetic (a row that sees one key). Its dk and dq limits add the most a
# different fp32 order of D products can move them through dS,
# 2 D 2^-24 scale (P * (|dO| @ |V|^T)) @ |K| for dq and the transpose @ |Q|
# for dk (`dp_order_bound`).
FP32_UNIT = 2.0 ** -24

# The families of phase 7 at their published widths, and the depth their
# training runs are cut to: about 24, 19 and 26 GB of f32 masters,
# gradients and AdamW moments.
FAMILIES = ("gpt-neox-20b", "gptj-6b", "opt-30b")
FAMILY_TRAIN_LAYERS = {"gpt-neox-20b": 2, "gptj-6b": 4, "opt-30b": 2}
# NeoX-20B's int8-weight engine quantizes a copy of a bf16 model cut to this
# depth (phase 3 holds int8 weights at full depth on Llama-1B).
NEOX_W8_LAYERS = 4
NEOX_TIMED_LAYERS = 22  # phase 9 (b)'s and NeoX's generate depth: half of NeoX-20B's 44
FAMILY_TIMED_STEPS, FAMILY_WARMUP, FAMILY_FP16_STEPS = 4, 2, 2

# T5 (phase 8): T0pp-11B at its published widths. Training is cut to this
# many encoder and decoder layers (the full 24 + 24 needs about 200 GB with
# f32 AdamW state) on 2048 encoder and 1024 decoder tokens; generation runs
# the full depth in bf16 (22.3 GB).
T5_MODEL = "t0pp-11b"
T5_TRAIN_LAYERS = 2
T5_ENC_SEQ, T5_DEC_SEQ = 2048, 1024
T5_GENERATE = dict(batch=8, prompt=512, new=128, padded=((2, 384), (5, 200)), parity_layers=2, parity_batch=2,
                   parity_prompt=64, parity_new=16)
# T5's f32 parity (`t5_f32_parity`) holds the first T5_PARITY_STEPS steps'
# losses (TRAIN_F32_RTOL) and the first step's gradient of every parameter
# (T5_GRAD_RTOL, the norm of the difference over the plain one's) through
# the kernels to those through the plain attention. A third step is run and
# reported beside the same steps with every attention in float64: at flax's
# initial weights T5's unscaled scores spread over about +-8 sigma, and from
# the third step the losses of any two f32 attentions part, the plain one's
# from float64's as far as the kernels' do.
T5_PARITY_STEPS = 2
T5_GRAD_RTOL = 1e-4
# The repaired fault (phase 10 (a)): T5-tiny's d_kv 16 at 1024 encoder and
# decoder tokens, where the flash gate opens.
T5_TINY_SEQ = 1024

# Mixtral (phase 10): Mixtral-8x7B at its published widths (8 experts of FFN
# 14336, top 2, capacity factor 1.25; 32 heads of 128 over 8 KV heads; vocab
# 32000). Its 46.70e9 parameters are 93.4 GB in bf16, past the card's 80 GB,
# so each run is cut in depth: a layer is 1.4513e9 parameters (2.903 GB in
# bf16), the embedding and the head 0.524 GB together. Generation runs 2 of
# the 32 layers (6.2 GB, cut for the script's time) over
# a 1024-token cache (prompt 512 + 128 new); its f32 dropless check 2 layers.
MIXTRAL_MODEL = "mixtral-8x7b"
MIXTRAL_GENERATE = dict(layers=2, max_length=1024, prompt=512, new=128, batch=8, ragged=(128, 512),
                        parity_layers=2, parity_batch=2, parity_prompt=64, parity_new=8, profile_new=16)
# Training runs 2 layers (3.165e9 parameters: f32 masters and gradients,
# AdamW's two moments and the bf16 copies, about 57 GB) on batch 1 x 2048.
MIXTRAL_TRAIN_LAYERS = 2
MIXTRAL_TRAIN = dict(batch=1, seq=2048, warmup=2, timed_steps=8, fp16_steps=2, parity_steps=3)
# The f32 parity's narrow widths: Mixtral's head dim 128 and 4:1 GQA kept,
# the hidden width cut to 1024 (8 heads), the FFN to 3584; 8 experts, top 2.
MIXTRAL_NARROW = dict(hidden_size=1024, intermediate_size=3584, num_attention_heads=8, num_key_value_heads=2)

# Training (phase 5).
TRAIN_LR, TRAIN_BETAS, TRAIN_EPS, TRAIN_WD = 1e-4, (0.9, 0.999), 1e-8, 1e-4
TRAIN_SEQ = 2048
# f32 kernel vs plain attention: the same f32 arithmetic in another order,
# carried through 3 AdamW steps of a 2-layer model; losses are about 12.
TRAIN_F32_RTOL = 1e-4
BF16_PEAK_FLOPS = 989e12


def log(msg: str):
    print(msg, flush=True)


def _template_args(mangled: str):
    """A mangled template argument list, read left to right: `Li64E` is 64,
    `f` f32, `a` int8, `13__nv_bfloat16` bf16, `6__half` f16,
    `13__nv_fp8_e4m3` fp8, and a
    substitution (`S1_`) repeats the type before it."""
    import re

    names = {"__nv_bfloat16": "bf16", "__half": "f16", "__nv_fp8_e4m3": "fp8", "f": "f32", "a": "int8"}
    args, i = [], 0
    while i < len(mangled):
        m = re.match(r"Li(\d+)E|(\d+)|(S\d*_)|([fa])", mangled[i:])
        if not m:
            break
        i += m.end()
        if m.group(1):
            args.append(m.group(1))
        elif m.group(2):
            name = mangled[i:i + int(m.group(2))]
            i += len(name)
            args.append(names.get(name, name))
        elif m.group(3):
            args.append(args[-1])
        else:
            args.append(names[m.group(4)])
    return args


def ptxas_report(log_text: str):
    """One line per kernel from nvcc's `-Xptxas -v` output: the kernel's
    name and template arguments (`flash_fwd_wgmma_kernel<64,128,2>`), then
    its registers, stack, spills and static shared memory; warnings and
    performance notes (a wgmma serialised, say) as they are."""
    import re

    lines, kernel = [], None
    for raw in log_text.splitlines():
        line = raw.strip()
        if "Compiling entry function" in line:
            m = re.search(r"\d+([a-z_]+_kernel)I(.*?)EEv", line)
            if m:
                kernel = f"{m.group(1)}<{','.join(_template_args(m.group(2)))}>"
            else:
                kernel = line
        elif kernel and ("spill" in line or "Used" in line):
            lines.append(f"{kernel}: {line.replace('ptxas info    : ', '')}")
        elif "warning" in line.lower() or "Performance Loss" in line:
            lines.append(line)
    return lines


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def time_ms(fn, device, iters: int = TIMED_LAUNCHES, warmup: int = 3, spin: bool = False) -> float:
    """Median time of `fn` over `iters` calls, each bracketed by CUDA events,
    with the 50 MB L2 flushed (a 256 MB write) before each call so every call
    reads its inputs from device memory, as a layer of the engine does.

    Without `spin` (the `ms` of every row) a call whose host work outlasts the
    flush is timed at least at that host work's pace: the device reaches the
    start event and waits for the launches. With `spin` (`device_ms`) the
    device spins for SPIN_CYCLES (about 0.5 ms) after the flush, so the host
    has queued the whole call before the start event: the device's time
    alone."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    events = []
    for _ in range(iters):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(device)
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def paired_times(call, library, device):
    """A kernel's and its library call's times, each without and with the
    spin (`time_ms`): ms, device_ms, library_ms, library_device_ms."""
    return {"ms": time_ms(call, device), "device_ms": time_ms(call, device, spin=True),
            "library_ms": time_ms(library, device), "library_device_ms": time_ms(library, device, spin=True)}


def loop_times(call, device, n=SERVING_CALLS, host_calls=HOST_CALLS):
    """`n` calls back to back, neither flushed nor spun: (wall ms per call,
    synchronised at the end; host ms per call over the first `host_calls`,
    the host's own work, as the device cannot hold it back that early).
    Where the host's work per call outlasts the device's, the two meet."""
    for _ in range(3):
        call()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(n):
        call()
        if i == host_calls - 1:
            t1 = time.perf_counter()
    torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    return 1e3 * (t2 - t0) / n, 1e3 * (t1 - t0) / host_calls


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


def kernel_bound(q, k, table, pos, quantized=False):
    """(least ms, "bytes" | "operations") for these inputs: each live K/V page
    read once at the pool's own bytes per value (1 for int8 or fp8) and, for
    a quantized pool, its K and V f32 scales per KV head; q, table entries
    and positions read once, the output written once; 4 * D operations per
    (query head, visible column)."""
    b, s, hq, d = q.shape
    ps, hkv = k.shape[1], k.shape[2]
    length = pos.max(dim=1).values.long() + 1
    live_pages = int(((length + ps - 1) // ps).sum())
    kv_bytes = live_pages * ps * hkv * d * 2 * k.element_size()
    scale_bytes = live_pages * hkv * 2 * 4 if quantized else 0
    n_bytes = kv_bytes + scale_bytes + 2 * q.numel() * q.element_size() + live_pages * 4 + pos.numel() * 4
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


def kernel_phase(device, shape=KERNEL_SHAPE, timed=True, dtypes=(torch.float32, torch.bfloat16)):
    from accelerate_tpu_torch.ops import paged_attention as pa

    results = {}
    for kind, s in (("decode", 1), ("verify", shape["verify_s"])):
        fn = pa.paged_decode_attention if s == 1 else pa.paged_verify_attention
        entry = {}
        for dtype in dtypes:
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
                row.update(paired_times(lambda: fn(q, k, v, table, pos), sdpa_yardstick(q, k, v, table, pos),
                                        device))
                row["plain_ms"] = time_ms(lambda: pa.paged_attention_reference(q, k, v, table, pos), device)
            entry[str(dtype).replace("torch.", "")] = row
            log(f"[kernels] {kind} {dtype}: {json.dumps(row)}")
        results[kind] = entry
    return results


def quantized_kernel_phase(device, shape=KERNEL_SHAPE, timed=True, dtypes=(torch.float32, torch.bfloat16),
                           kv_dtypes=KV_DTYPES):
    """K1 and K2's fused-dequant mode at the engine's shapes: the pools of
    `kernel_case` (scratch page poisoned) quantized whole-page to int8 and to
    fp8 e4m3, f32 and bf16 queries, each kernel launch held against the plain
    version on the same codes and scales."""
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.ops import quantization as qz

    results = {}
    for kind, s in (("decode", 1), ("verify", shape["verify_s"])):
        fn = pa.paged_decode_attention if s == 1 else pa.paged_verify_attention
        for kv_dtype in kv_dtypes:
            key = f"{kind}_{kv_dtype}"
            spec = qz.kv_quant_spec(kv_dtype)
            entry = {}
            for dtype in dtypes:
                q, k, v, table, pos = kernel_case(device, torch.float32, s, seed=11 + s, **shape)
                (kq, ks), (vq, vs) = qz.quantize_kv_pages(k, spec), qz.quantize_kv_pages(v, spec)
                del k, v
                q = q.to(dtype)
                args = (q, kq, vq, table, pos)
                scales = dict(k_scale=ks, v_scale=vs)
                before = pa.LAUNCHES[key]
                out = fn(*args, **scales)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                    if pa.LAUNCHES[key] != before + 1:
                        raise RuntimeError(f"{key} call on {device} did not launch its kernel")
                ref = pa.paged_attention_reference(*args, **scales)
                if not torch.isfinite(out).all():
                    raise RuntimeError(f"{key} kernel ({dtype}) wrote non-finite values")
                err = float((out.float() - ref.float()).abs().max())
                tol = dict(atol=F32_ATOL, rtol=0.0) if dtype == torch.float32 else dict(atol=BF16_ATOL, rtol=BF16_RTOL)
                torch.testing.assert_close(out.float(), ref.float(), **tol, msg=lambda m: f"{key} {dtype}: {m}")
                row = {"max_abs_err": err, "tolerance": tol}
                bound, bound_by = kernel_bound(q, kq, table, pos, quantized=True)
                row.update(bound_ms=bound, bound_by=bound_by)
                if timed:
                    kd = qz.dequantize_kv(kq, ks[:, None, :, None], dtype)
                    vd = qz.dequantize_kv(vq, vs[:, None, :, None], dtype)
                    row.update(paired_times(lambda: fn(*args, **scales), sdpa_yardstick(q, kd, vd, table, pos),
                                            device))
                    row["plain_ms"] = time_ms(lambda: pa.paged_attention_reference(*args, **scales), device)
                    del kd, vd
                entry[str(dtype).replace("torch.", "")] = row
                log(f"[kernels] {key} {dtype}: {json.dumps(row)}")
            results[key] = entry
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


def serve(model, requests, device, guard=None, **engine_kw):
    """Run `requests` to completion; returns (engine, tokens, timing). With
    `guard` (a `TraceGuard`) the engine's steps run inside it."""
    import contextlib
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
    with guard if guard is not None else contextlib.nullcontext():
        while engine.pending:
            engine.step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    del engine._admit  # the wrapper referenced the engine: without this the engine outlives its run
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


def free_memory(device):
    """Drop unreachable engines and their pools, then restart the peak
    memory count, so a run's peak is its own."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.init()  # the allocator's statistics exist once CUDA is initialised
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def agreement(base, other):
    """Share of token positions, over every request, where `other`'s greedy
    token equals `base`'s (positions past the shorter stream not counted)."""
    pairs = [(x, y) for rid in base for x, y in zip(base[rid], other[rid])]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


ENGINE_KW = dict(num_slots=8, page_size=16, max_length=2048, chunk_size=8)
# The depth of the f32 identities of phases 3 and 4 (a): their bf16 runs hold
# the engine's and `generate`'s paths at full depth.
PARITY_LAYERS = 2


def parity_model(model_name, device, layers=PARITY_LAYERS):
    """The registered Llama at full width cut to `layers` layers, f32 from seed 0."""
    import dataclasses

    from accelerate_tpu_torch import create_llama_model
    from accelerate_tpu_torch.models import MODEL_REGISTRY

    full = MODEL_REGISTRY[model_name]()
    config = dataclasses.replace(full, num_hidden_layers=min(layers, full.num_hidden_layers))
    return create_llama_model(config, seed=0, dtype=torch.float32, device=device)
SPEC_KW = dict(speculative=True, draft_tokens=KERNEL_SHAPE["verify_s"] - 1)


def engine_phase(device, model_name="llama-1b", engine_kw=None, n_requests=16, system_len=256,
                 profile=False, tokens_out=None):
    """Phase 3; `tokens_out`, a dict, receives the bf16 runs' greedy tokens
    by label ("plain", "speculative"), which phase 13 gates at full depth."""
    from accelerate_tpu_torch import create_named_model

    engine_kw = {**ENGINE_KW, **(engine_kw or {})}
    report = {"model": model_name, "engine": engine_kw, "draft_tokens": SPEC_KW["draft_tokens"]}

    t0 = time.perf_counter()
    model = parity_model(model_name, device)
    requests = make_requests(model.config.vocab_size, n=n_requests, system_len=system_len)
    log_model(f"[engine] {model_name} f32", model, t0)
    report["parity_layers"] = model.config.num_hidden_layers
    engine_parity(model, requests, device, engine_kw, report)
    del model
    free_memory(device)
    model = create_named_model(model_name, seed=0, dtype=torch.float32, device=device).to(torch.bfloat16)
    bf16_tokens, bf16_cache_nbytes = engine_timed(model, requests, device, engine_kw, report)
    if tokens_out is not None:
        tokens_out.update(bf16_tokens)
    engine_quantized(model, requests, device, engine_kw, report, bf16_tokens, bf16_cache_nbytes)
    if profile:
        report["bf16_plain_profile"] = profile_run(
            lambda: serve(model, requests, device, **engine_kw)[2]["wall_s"], report["bf16_plain"]["wall_s"]
        )
        quant_kw = {**engine_kw, "weight_dtype": "int8", "kv_cache_dtype": "int8"}
        report["bf16_w8_int8_plain_profile"] = profile_run(
            lambda: serve(model, requests, device, **quant_kw)[2]["wall_s"],
            report["bf16_w8_int8_plain"]["wall_s"],
        )
    return report


def log_model(tag, model, t0):
    cfg = model.config
    log(f"{tag} built in {time.perf_counter() - t0:.1f}s: {cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads of {cfg.head_dim}, vocab {cfg.vocab_size}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")


def engine_parity(model, requests, device, engine_kw, report):
    """(a) f32: the kernel path's greedy tokens equal the gather path's,
    plain and speculative; (c) the same on int8 and fp8 caches; (d) with
    only the cache quantized, every prompt that shares no prefix has the
    unquantized engine's first token."""
    f32_plain = {}
    for kv_dtype in ("bf16", *KV_DTYPES):
        tag = "f32" if kv_dtype == "bf16" else f"f32 kv {kv_dtype}"
        for label, extra in (("plain", {}), ("speculative", SPEC_KW)):
            runs = {}
            for impl in ("gather", "paged_kernel"):
                engine, tokens, timing = serve(model, requests, device, attention_impl=impl,
                                               kv_cache_dtype=kv_dtype, **engine_kw, **extra)
                runs[impl] = tokens
                log(f"[engine] {tag} {label} {impl}: {json.dumps(timing)}")
            if runs["gather"] != runs["paged_kernel"]:
                bad = [rid for rid in runs["gather"] if runs["gather"][rid] != runs["paged_kernel"][rid]]
                raise RuntimeError(f"{tag} {label}: paged_kernel tokens differ from gather for requests {bad}")
            log(f"[engine] {tag} {label}: paged_kernel tokens == gather tokens for all {len(requests)} requests")
            report[tag.replace(" ", "_") + f"_{label}_identical"] = True
            if label == "plain":
                f32_plain[kv_dtype] = runs["paged_kernel"]

    fresh = [r.request_id for r in requests if r.request_id % 2 == 1]  # even ids share the system prompt
    for kv_dtype in KV_DTYPES:
        bad = [rid for rid in fresh if f32_plain[kv_dtype][rid][0] != f32_plain["bf16"][rid][0]]
        if bad:
            raise RuntimeError(f"f32 kv {kv_dtype}: first tokens of fresh prompts {bad} differ from unquantized")
        report[f"f32_kv_{kv_dtype}_fresh_first_tokens_exact"] = len(fresh)
        report[f"f32_kv_{kv_dtype}_agreement"] = agreement(f32_plain["bf16"], f32_plain[kv_dtype])
        log(f"[engine] f32 kv {kv_dtype}: first tokens of all {len(fresh)} fresh prompts equal the unquantized "
            f"engine's; greedy agreement {report[f'f32_kv_{kv_dtype}_agreement']:.4f}")
    return f32_plain


def engine_timed(model, requests, device, engine_kw, report):
    """(b) bf16 on the kernel path, plain (K1) and speculative (K2), timed
    after a warm-up of each; each kernel's launch count, zeroed just before
    its run, equals layers x dispatches of that run and is > 0. Returns the
    greedy tokens of both runs and the cache's bytes."""
    from accelerate_tpu_torch.ops import paged_attention as pa

    layers = model.config.num_hidden_layers
    serve(model, requests[:2], device, **engine_kw)  # warm-up: bf16 GEMM handles, allocator
    serve(model, requests[:2], device, **engine_kw, **SPEC_KW)
    free_memory(device)
    bf16_tokens, engine = {}, None
    for label, extra, kind in (("plain", {}, "decode"), ("speculative", SPEC_KW, "verify")):
        engine = None  # the last run's pools go before this run's are made
        gc.collect()
        pa.reset_launch_counts()
        engine, bf16_tokens[label], timing = serve(model, requests, device, **engine_kw, **extra)
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
    report["kv_cache_nbytes"] = engine.kv_cache_nbytes
    if device.type == "cuda":
        report["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    return bf16_tokens, engine.kv_cache_nbytes


def engine_quantized(model, requests, device, engine_kw, report, bf16_tokens, bf16_cache_nbytes):
    """(e) bf16 with int8 weights and an int8, then an fp8 cache, plain and
    speculative, timed: the cache's bytes beside `bf16_cache_nbytes` (the
    bf16 cache of a model of this depth), greedy agreement with
    `bf16_tokens` where given; the quantized kernel's launch count equals
    layers x dispatches and is > 0, and every other count is 0."""
    from accelerate_tpu_torch.ops import paged_attention as pa

    layers = model.config.num_hidden_layers
    free_memory(device)
    serve(model, requests[:2], device, weight_dtype="int8", kv_cache_dtype="int8", **engine_kw)  # warm-up
    for kv_dtype in KV_DTYPES:
        quant_kw = dict(weight_dtype="int8", kv_cache_dtype=kv_dtype)
        for label, extra, kind in (("plain", {}, "decode"), ("speculative", SPEC_KW, "verify")):
            key = f"{kind}_{kv_dtype}"
            pa.reset_launch_counts()
            engine = None
            free_memory(device)
            engine, tokens, timing = serve(model, requests, device, **engine_kw, **quant_kw, **extra)
            launches = dict(pa.LAUNCHES)
            dispatches = engine.stats["decode_steps"]
            timing.update(
                launches=launches, dispatches=dispatches, kv_cache_nbytes=engine.kv_cache_nbytes,
                bf16_kv_cache_nbytes=bf16_cache_nbytes, prefix_cache=engine.stats["prefix_cache"],
            )
            if bf16_tokens is not None:
                timing["agreement_with_bf16"] = agreement(bf16_tokens[label], tokens)
            if label == "speculative":
                timing["speculative"] = engine.stats["speculative"]
            if device.type == "cuda":
                timing["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
            log(f"[engine] bf16 w8 kv {kv_dtype} {label} paged_kernel ({layers} layers): {json.dumps(timing)}")
            if device.type == "cuda":
                others = {k: n for k, n in launches.items() if k != key and n}
                if launches[key] != layers * dispatches or launches[key] <= 0 or others:
                    raise RuntimeError(
                        f"bf16 w8 kv {kv_dtype} {label}: launches {launches}, expected {key} = {layers} "
                        f"layers x {dispatches} dispatches and no other"
                    )
            report[f"bf16_w8_{kv_dtype}_{label}"] = timing
    engine = None
    free_memory(device)


def profile_run(run, unprofiled_wall_s):
    """Device time by kernel over one more run (`run()` does it and returns
    its wall seconds) under `torch.profiler` (CUPTI). Kernels run on one
    stream and do not overlap, so their summed time is the device's busy
    time; its share of the unprofiled run's wall clock is the busy share
    (the profiler slows the host, not the device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_s = run()
    # A user annotation (an optimizer's `Optimizer.step#AdamW.step`) spans
    # kernels that are counted on their own: leave it out of the sums.
    kernels = [
        (row.self_device_time_total, row.key, row.count)
        for row in prof.key_averages()
        if row.device_type == DeviceType.CUDA and row.self_device_time_total > 0
        and not getattr(row, "is_user_annotation", False)
    ]
    total_us = sum(us for us, _, _ in kernels)
    if total_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    groups = {"paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for us, name, _ in kernels:
        lowered = name.lower()
        if "paged_" in lowered:  # csrc/paged_attention.cu: paged_split_*_kernel, paged_merge_kernel
            groups["paged_attention"] += us
        elif any(tag in lowered for tag in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
            groups["gemm"] += us
        else:
            groups["other"] += us
    kernels.sort(reverse=True)
    return {
        "profiled_wall_s": profiled_wall_s,
        "device_busy_s": total_us / 1e6,
        "busy_share_of_unprofiled_wall": total_us / 1e6 / unprofiled_wall_s,
        "share_by_group": {k: v / total_us for k, v in groups.items()},
        "top_kernels": [
            {"name": name[:140], "calls": calls, "ms": us / 1e3, "share": us / total_us}
            for us, name, calls in kernels[:15]
        ],
    }


# ---------------------------------------------------------------- generate
# `generate` and the contiguous engine (phase 4): Llama-1B, 2048-token cache.
GENERATE_SHAPE = dict(
    max_length=2048, prompt=256, new=32, batch=4, ragged=(64, 128, 192, 256), penalty=1.3,
    timed_prompt=512, timed_new=64, timed_batch=8, timed_ragged=(128, 512), passage=64, draft=4,
)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def left_pad(prompts):
    """Prompts of several lengths as one left-padded batch: (ids, mask)."""
    width = max(p.size for p in prompts)
    ids = np.zeros((len(prompts), width), np.int64)
    mask = np.zeros((len(prompts), width), np.int64)
    for row, p in enumerate(prompts):
        ids[row, width - p.size:] = p
        mask[row, width - p.size:] = 1
    return ids, mask


def launch_counts():
    """Every K1-K5 launch count, keyed by kernel."""
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import paged_attention as pa

    return {**{f"paged_{k}": n for k, n in pa.LAUNCHES.items()}, **fa.LAUNCHES}


def reset_launch_counts():
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import paged_attention as pa

    pa.reset_launch_counts()
    fa.reset_launch_counts()


def timed_generate(gen, ids, device, mask=None, repeats=3, **cfg):
    """One `Generator` call timed: TTFT is the median wall time of `repeats`
    calls for one new token (prefill, first sample, the host tail, a
    synchronise); then one call for `max_new_tokens`, whose tokens after
    the first over (its wall time - TTFT) give decode tokens/s, and whose
    peak device memory is read. Speculative calls also count their verify
    dispatches (forwards after the prefill). Returns (tokens, timing)."""
    from accelerate_tpu_torch import GenerationConfig

    n = cfg.pop("max_new_tokens")
    ttft = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        gen(ids, GenerationConfig(max_new_tokens=1, **cfg), attention_mask=mask)
        sync(device)
        ttft.append(time.perf_counter() - t0)
    forwards = []
    forward = gen._forward
    gen._forward = lambda *a: (forwards.append(1), forward(*a))[1]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        t0 = time.perf_counter()
        out = gen(ids, GenerationConfig(max_new_tokens=n, **cfg), attention_mask=mask)
        sync(device)
        wall = time.perf_counter() - t0
    finally:
        del gen._forward
    tokens = out[:, ids.shape[1]:].cpu().numpy()
    vocab = gen.base_config.vocab_size
    if tokens.shape != (ids.shape[0], n) or tokens.min() < 0 or tokens.max() >= vocab:
        raise RuntimeError(f"generate returned {tokens.shape} tokens in [{tokens.min()}, {tokens.max()}]")
    ttft_s = float(np.median(ttft))
    timing = {
        "batch": int(ids.shape[0]), "prompt_tokens": int(ids.shape[1] if mask is None else mask.sum()),
        "new_tokens": n, "ttft_s": ttft_s, "wall_s": wall,
        "decode_tokens_per_s": ids.shape[0] * (n - 1) / max(wall - ttft_s, 1e-9),
    }
    if cfg.get("draft_tokens"):
        verify_steps = len(forwards) - 1
        timing.update(verify_steps=verify_steps, accepted_tokens_per_verify_step=(n - 1) / max(verify_steps, 1))
    if device.type == "cuda":
        timing["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    return tokens, timing


def generate_phase(device, model_name="llama-1b", shape=GENERATE_SHAPE, n_requests=16, system_len=256,
                   profile=False):
    """(a) f32 greedy identities of `generate` against the paged-kernel
    engine and against itself; (b) bf16 readings of `generate` and of the
    contiguous engine beside the paged one. K1-K5 must not launch on the
    generate path or in the contiguous engine. With `profile`, device time
    by kernel group of one more batch-1 generate call."""
    from accelerate_tpu_torch import GenerationConfig, Generator, Request, create_named_model

    engine_kw = dict(num_slots=8, page_size=16, max_length=shape["max_length"], chunk_size=8)
    new, pen = shape["new"], shape["penalty"]
    report = {"model": model_name, "shape": shape}
    t0 = time.perf_counter()
    model = parity_model(model_name, device)
    report["parity_layers"] = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    gen = Generator(model, max_length=shape["max_length"], device=device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, (shape["prompt"],)) for _ in range(shape["batch"])]

    def engine_tokens(reqs, **kw):
        _, tokens, _ = serve(model, reqs, device, **engine_kw, **kw)
        return [tokens[r.request_id] for r in reqs]

    def same(what, got, expect):
        got, expect = [list(map(int, t)) for t in got], [list(map(int, t)) for t in expect]
        if got != expect:
            bad = [i for i, (g, e) in enumerate(zip(got, expect)) if g != e]
            raise RuntimeError(f"generate f32: {what} differ in rows {bad}")
        report[f"f32_{what.replace(' ', '_')}"] = True
        log(f"[generate] f32: {what} agree, {len(got)} rows")

    # (a) f32, greedy.
    ids = np.stack(prompts)
    plain = gen(ids, GenerationConfig(max_new_tokens=new)).cpu().numpy()[:, ids.shape[1]:]
    reqs = [Request(i, p, max_new_tokens=new) for i, p in enumerate(prompts)]
    same("generate and the paged_kernel engine tokens", plain, engine_tokens(reqs))
    spec = gen(ids, GenerationConfig(max_new_tokens=new, draft_tokens=shape["draft"])).cpu().numpy()
    same("speculative and plain generate tokens", spec[:, ids.shape[1]:], plain)
    ragged = [p[: n] for p, n in zip(prompts, shape["ragged"])]
    rids, mask = left_pad(ragged)
    batch = gen(rids, GenerationConfig(max_new_tokens=new), attention_mask=mask).cpu().numpy()
    alone = [gen(p[None], GenerationConfig(max_new_tokens=new)).cpu().numpy()[0, p.size:] for p in ragged]
    same("left-padded rows and each prompt alone", batch[:, rids.shape[1]:], alone)
    penalized = gen(ids, GenerationConfig(max_new_tokens=new, repetition_penalty=pen)).cpu().numpy()
    reqs = [Request(i, p, max_new_tokens=new, repetition_penalty=pen) for i, p in enumerate(prompts)]
    same("penalized generate and the penalized paged_kernel engine tokens", penalized[:, ids.shape[1]:],
         engine_tokens(reqs, use_repetition_penalty=True))
    requests = make_requests(vocab, n=n_requests, system_len=system_len)
    same("contiguous and paged_kernel engine tokens", engine_tokens(requests, paged=False),
         engine_tokens(requests))
    log(f"[time] generate (a) f32 {time.perf_counter() - t0:.1f}s")

    # (b) bf16, timed. The paged engine first, then everything the K1-K5
    # counts must stay 0 over.
    t0 = time.perf_counter()
    del model, gen
    free_memory(device)
    model = create_named_model(model_name, seed=0, dtype=torch.float32, device=device).to(torch.bfloat16)
    gen = Generator(model, max_length=shape["max_length"], device=device)
    serve(model, requests[:2], device, **engine_kw)  # warm-up
    serve(model, requests[:2], device, paged=False, **engine_kw)
    engines = {}
    for label, kw in (("paged_kernel", {}), ("contiguous", dict(paged=False))):
        if label == "contiguous":
            reset_launch_counts()
        free_memory(device)
        engine, _, timing = serve(model, requests, device, **engine_kw, **kw)
        timing.update(kv_cache_nbytes=engine.kv_cache_nbytes, attention_impl=engine.attention_impl)
        if device.type == "cuda":
            timing["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
        del engine
        engines[label] = timing
        log(f"[generate] bf16 engine {label}: {json.dumps(timing)}")
    report["bf16_engines"] = engines
    gen(prompts[0][None, :8], GenerationConfig(max_new_tokens=4))  # warm-up
    long = rng.integers(0, vocab, (shape["timed_prompt"],))
    _, report["bf16_batch1"] = timed_generate(gen, long[None], device, max_new_tokens=shape["timed_new"])
    lo, hi = shape["timed_ragged"]
    lengths = np.linspace(lo, hi, shape["timed_batch"]).astype(int)
    rids, mask = left_pad([rng.integers(0, vocab, (int(n),)) for n in lengths])
    _, report["bf16_batch_ragged"] = timed_generate(gen, rids, device, mask, max_new_tokens=shape["timed_new"])
    passage = rng.integers(0, vocab, (shape["passage"],))
    repeated = np.tile(passage, -(-shape["timed_prompt"] // shape["passage"]))[: shape["timed_prompt"]]
    _, report["bf16_speculative"] = timed_generate(
        gen, repeated[None], device, max_new_tokens=shape["timed_new"], draft_tokens=shape["draft"]
    )
    for key in ("bf16_batch1", "bf16_batch_ragged", "bf16_speculative"):
        log(f"[generate] {key}: {json.dumps(report[key])}")
    launches = launch_counts()
    report["launches_on_generate_and_contiguous"] = launches
    if any(launches.values()):
        raise RuntimeError(f"a K1-K5 kernel launched on the generate path or the contiguous engine: {launches}")
    log(f"[generate] K1-K5 launches over the bf16 generate runs and the contiguous engine: {launches}")
    log(f"[time] generate (b) bf16 {time.perf_counter() - t0:.1f}s")
    if profile:
        def run():
            t = time.perf_counter()
            gen(long[None], GenerationConfig(max_new_tokens=shape["timed_new"]))
            sync(device)
            return time.perf_counter() - t

        report["bf16_batch1_profile"] = profile_run(run, report["bf16_batch1"]["wall_s"])
        log(f"[generate] bf16 batch 1 profile: {json.dumps(report['bf16_batch1_profile'])}")
    return report


# ---------------------------------------------------------- flash kernels
def flash_case(device, dtype, b, hq, s, d, seed, scales=None, sk=None):
    """q and an output cotangent do, [B*H, S, D], and k and v, [B*H, Sk, D]
    (Sk = S unless given), standard normal times `scales[name]` where given."""
    gen = torch.Generator(device=device).manual_seed(seed)
    scales = scales or {}
    rows = {"q": s, "k": sk or s, "v": sk or s, "do": s}
    return [(torch.randn((b * hq, rows[name], d), generator=gen, device=device) * scales.get(name, 1.0)).to(dtype)
            for name in ("q", "k", "v", "do")]


def flash_bound(name, q, k, causal=True):
    """(least ms, "bytes" | "operations") for one call of kernel `name`:
    its products at 2 * BH * (visible pairs) * D operations each, at the
    input type's peak; each input read once and each output written once
    (fp32 lse and delta: 4 bytes a row)."""
    bh, s, d = q.shape
    sk = k.shape[1]
    rows = torch.arange(s, dtype=torch.float64)
    pairs = int((torch.clamp(rows + (sk - s), max=sk - 1) + 1).sum()) if causal else s * sk
    ops = FLASH_KERNELS[name][1] * 2 * bh * pairs * d
    q_bytes, kv_bytes, row_bytes = q.numel() * q.element_size(), k.numel() * k.element_size(), bh * s * 4
    n_bytes = {
        "flash_fwd": 2 * q_bytes + 2 * kv_bytes + row_bytes,          # q, k, v -> o, lse
        "flash_bwd_dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,  # q, k, v, do, lse, delta -> dk, dv
        "flash_bwd_dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,   # q, k, v, do, lse, delta -> dq
    }[name]
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_flash_yardsticks(q, k, v, do, b, hq, causal=True, scale=None):
    """`F.scaled_dot_product_attention(is_causal=causal, scale=scale)` on
    the same inputs viewed [B, H, S, D], and its autograd backward (dq, dk
    and dv in one call): yardsticks of time and error only, the port never
    calls them."""
    fn = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x.detach().view(b, hq, *x.shape[1:]).requires_grad_() for x in (q, k, v))
    out = fn(q4, k4, v4, is_causal=causal, scale=scale)
    do4 = do.view_as(out)
    forward = lambda: fn(q4, k4, v4, is_causal=causal, scale=scale)  # noqa: E731
    backward = lambda: torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)  # noqa: E731
    return forward, backward


def flash_rounding_bound(name, key, q, k, v, do, lse, delta, causal, scale):
    """The most, element by element, that rounding P or dS to q's type (bf16
    or fp16) before the second product can move output `key` of kernel
    `name`, with `unit` that type's ROUNDING_UNIT: K3's o by unit * (P @ |V|),
    P = exp(s - lse) the normalised probabilities; K4's dv by
    unit * (P^T @ |dO|) and dk by unit * (|dS|^T @ |Q|),
    dS = P * (dP - delta) * scale; K5's dq by unit * (|dS| @ |K|). From the
    plain versions' fp32 P and dS."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    if (name, key) not in FLASH_ROUNDED:
        raise ValueError(f"no rounding bound for {name}'s {key}")
    unit = ROUNDING_UNIT[q.dtype]
    p = torch.exp(fa._scores(q, k, causal, scale) - lse[..., None])
    if key == "o":
        return unit * torch.matmul(p, v.float().abs())
    if key == "dv":
        return unit * torch.matmul(p.transpose(-1, -2), do.float().abs())
    ds = (p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta[..., None]) * scale).abs()
    if key == "dk":
        return unit * torch.matmul(ds.transpose(-1, -2), q.float().abs())
    return unit * torch.matmul(ds, k.float().abs())


def dp_order_bound(key, q, k, v, do, lse, causal, scale):
    """The most that summing each dP = dO . V^T (D products) in another fp32
    order, on both sides, can move dk or dq through dS = P * (dP - delta) *
    scale: 2 D 2^-24 scale (P * (|dO| @ |V|^T)) @ |K| for dq, its
    transpose @ |Q| for dk."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    p = torch.exp(fa._scores(q, k, causal, scale) - lse[..., None])
    w = 2 * q.shape[-1] * FP32_UNIT * scale * p * torch.matmul(do.float().abs(), v.float().abs().transpose(-1, -2))
    if key == "dk":
        return torch.matmul(w.transpose(-1, -2), q.float().abs())
    return torch.matmul(w, k.float().abs())


def flash_tolerance(dtype, key):
    """The limit of output `key` in `dtype` before any rounding bound."""
    if key == "lse":
        return FLASH_LSE_TOL
    if dtype == torch.float32:
        return FLASH_F32_TOL["out" if key == "o" else "grad"]
    if dtype == torch.bfloat16:
        return dict(atol=BF16_ATOL, rtol=BF16_RTOL)
    return dict(atol=FP16_ATOL, rtol=FP16_RTOL)


def launch_key(name, dtype):
    """The `LAUNCHES` count of kernel `name` on `dtype` tensors."""
    return name + ("_f16" if dtype == torch.float16 else "")


def limit_report(got, ref, atol, rtol, bound=None):
    """`got` held to `ref` element by element within atol + rtol |ref|
    (+ `bound`): how many elements break that limit, the largest share of
    its limit an element takes (over 1 breaks it), and that element's index,
    value, reference, error and limit."""
    ref = ref.float()
    err = (got.float().reshape(ref.shape) - ref).abs()
    limit = atol + rtol * ref.abs() + (0.0 if bound is None else bound)
    share = (err / limit).flatten()
    i = int(share.argmax())
    return {"broken": int((share > 1).sum()), "share": float(share[i]), "worst": {
        "index": [int(x) for x in np.unravel_index(i, ref.shape)], "value": float(got.flatten()[i]),
        "ref": float(ref.flatten()[i]), "err": float(err.flatten()[i]), "limit": float(limit.flatten()[i]),
    }}


def flash_kernel_phase(device, shape=FLASH_SHAPE, timed=True, causal=True, scale=None,
                       dtypes=(torch.float32, torch.bfloat16, torch.float16), names=tuple(FLASH_KERNELS)):
    """K3, K4 and K5 against their plain versions in each of `dtypes`, at
    `shape` (``sk``, the key length, defaults to ``s``), `causal` or not, at
    `scale` (1/sqrt(D) by default); each kernel check is one launch. K4 and
    K5 get the lse and delta of the plain forward, so each is held alone.
    bf16 and fp16 K3's o, K4's dk and dv and K5's dq also report the element
    nearest to breaking the limit without the rounding bound, and SDPA's
    output under both limits. Then, with fp16 among `dtypes`, fp16 K4 and
    K5 on the range case (`flash_range_case`). `names` limits the kernels
    held (the backward's references are made only for K4 or K5)."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    scale = shape["d"] ** -0.5 if scale is None else scale
    results = {name: {} for name in FLASH_KERNELS}
    for dtype in dtypes:
        q, k, v, do = flash_case(device, dtype, seed=21, **shape)
        # f32 kernels are held to the plain versions on the same inputs
        # widened to float64 (F32_REFERENCE); the kernels take the f32 lse
        # and delta.
        wide = [x.to(F32_REFERENCE) for x in (q, k, v, do)] if dtype == torch.float32 else (q, k, v, do)
        ref_o, ref_lse = fa.flash_fwd_reference(*wide[:3], causal, scale)
        ref_delta = fa._delta(ref_o, wide[3])
        lse, delta = ref_lse.float(), ref_delta.float()
        backward = names != ("flash_fwd",)
        ref_dk, ref_dv = fa.flash_bwd_dkv_reference(*wide, ref_lse, ref_delta, causal, scale) if backward else (None,) * 2
        ref_dq = fa.flash_bwd_dq_reference(*wide, ref_lse, ref_delta, causal, scale) if backward else None
        lib_fwd, lib_bwd = sdpa_flash_yardsticks(q, k, v, do, shape["b"], shape["hq"], causal, scale)
        sdpa = dict(zip(("dq", "dk", "dv"), lib_bwd() if backward else ()), o=lib_fwd().detach())
        refs = {key: ref for key, ref in {"o": ref_o, "dq": ref_dq, "dk": ref_dk, "dv": ref_dv}.items()
                if ref is not None}
        sdpa_err = {key: float((sdpa[key].reshape(ref.shape).float() - ref.float()).abs().max())
                    for key, ref in refs.items()}
        calls = {
            "flash_fwd": lambda: fa.flash_fwd(q, k, v, causal=causal, scale=scale),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale),
        }
        plains = {
            "flash_fwd": lambda: fa.flash_fwd_reference(q, k, v, causal, scale),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale),
        }
        expect = {"flash_fwd": {"o": ref_o, "lse": ref_lse}, "flash_bwd_dkv": {"dk": ref_dk, "dv": ref_dv},
                  "flash_bwd_dq": {"dq": ref_dq}}
        for name, call in calls.items():
            if name not in names:
                continue
            got = launch_checked(device, name, dtype, call, expect[name])
            row = {"max_abs_err": 0.0, "errors": {}}
            for key, ref in expect[name].items():
                entry = row["errors"][key] = hold_flash_output(name, key, got[key], ref, q, k, v, do, lse, delta,
                                                               scale, sdpa=sdpa.get(key), causal=causal)
                if key != "lse":
                    entry["sdpa_max_abs_err"] = sdpa_err[key]
                    row["max_abs_err"] = max(row["max_abs_err"], entry["max_abs_err"])
            bound, bound_by = flash_bound(name, q, k, causal)
            row.update(bound_ms=bound, bound_by=bound_by)
            if timed:
                row.update(paired_times(call, lib_fwd if name == "flash_fwd" else lib_bwd, device))
                row["plain_ms"] = time_ms(plains[name], device, iters=20)
            results[name][str(dtype).replace("torch.", "")] = row
            log(f"[flash] {name} {dtype}: {json.dumps(row)}")
        del q, k, v, do, wide, ref_o, ref_lse, ref_delta, lse, delta, ref_dk, ref_dv, ref_dq, calls, plains, refs
        del sdpa, lib_fwd, lib_bwd
    if torch.float16 in dtypes:
        for name, row in flash_range_case(device, shape).items():
            results[name]["float16"]["range_case"] = row
    return results


def launch_checked(device, name, dtype, call, keys):
    """`call()` of kernel `name` on `dtype` tensors, which on the card must
    launch it exactly once; its outputs by the names in `keys`, each finite."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    counter = launch_key(name, dtype)
    before = fa.LAUNCHES[counter]
    out = call()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        if fa.LAUNCHES[counter] != before + 1:
            raise RuntimeError(f"{name} on {dtype} {device} did not launch its kernel")
    got = dict(zip(keys, out if isinstance(out, tuple) else (out,)))
    for key, x in got.items():
        if not torch.isfinite(x).all():
            raise RuntimeError(f"{name} ({dtype}) wrote non-finite {key}")
    return got


def hold_flash_output(name, key, got, ref, q, k, v, do, lse, delta, scale, sdpa=None, dp_order=False, causal=True):
    """Hold output `key` of kernel `name` to its plain version `ref` at the
    limit of q's type (`flash_tolerance`), plus, for bf16 and fp16 outputs of
    FLASH_ROUNDED, the rounding bound (and with `dp_order` for dk and dq,
    `dp_order_bound`); raises past it. Returns the error, the limit and,
    with the bound, how close the worst element came, with and without the
    bound (and SDPA's `sdpa` output under both)."""
    dtype = q.dtype
    tol = flash_tolerance(dtype, key)
    entry = {"max_abs_err": float((got.float() - ref.float()).abs().max()), "tolerance": tol}
    if dtype in ROUNDING_UNIT and (name, key) in FLASH_ROUNDED:
        bound = flash_rounding_bound(name, key, q, k, v, do, lse, delta, causal, scale)
        entry["tolerance"] = dict(tol, plus=FLASH_ROUNDED[(name, key)].replace("2^-8", UNIT_TEXT[dtype]))
        if dp_order and key in ("dk", "dq"):
            bound = bound + dp_order_bound(key, q, k, v, do, lse, causal, scale)
            entry["tolerance"]["plus"] += (" + 2 D 2^-24 scale (P * (|dO| @ |V|^T))"
                                           + ("^T @ |Q|" if key == "dk" else " @ |K|"))
        entry["limit"] = limit_report(got, ref, **tol, bound=bound)
        entry["limit_without_bound"] = limit_report(got, ref, **tol)
        if sdpa is not None:
            entry["sdpa_limit"] = limit_report(sdpa, ref, **tol, bound=bound)
            entry["sdpa_limit_without_bound"] = limit_report(sdpa, ref, **tol)
        del bound
        if entry["limit"]["broken"]:
            raise RuntimeError(f"{name} {dtype} {key}: {entry['limit']['broken']} elements past "
                               f"their limit, the worst {entry['limit']['worst']}")
    else:
        torch.testing.assert_close(got.float(), ref.float(), **tol, msg=lambda m: f"{name} {dtype} {key}: {m}")
    return entry


def flash_range_case(device, shape=FLASH_SHAPE):
    """fp16 K4 and K5 where dS outgrows fp16 (FLASH_RANGE_SCALES): the plain
    version's largest |dS| must pass 65504 while its dk, dv and dq fit fp16,
    or the case tests nothing; each kernel, launched once, writes finite
    values within the fp16 limit of its plain version, dk's and dq's with
    `dp_order_bound` added."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    scale = shape["d"] ** -0.5
    q, k, v, do = flash_case(device, torch.float16, seed=23, scales=FLASH_RANGE_SCALES, **shape)
    ref_o, lse = fa.flash_fwd_reference(q, k, v, True, scale)
    delta = fa._delta(ref_o, do)
    p = torch.exp(fa._scores(q, k, True, scale) - lse[..., None])
    ds_max = float((p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta[..., None])
                    * scale).abs().max())
    del p
    expect = {"flash_bwd_dkv": dict(zip(("dk", "dv"), fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, True,
                                                                                  scale))),
              "flash_bwd_dq": {"dq": fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, True, scale)}}
    refs_max = {key: float(ref.float().abs().max()) for out in expect.values() for key, ref in out.items()}
    if not ds_max > FP16_MAX or not all(x < FP16_MAX for x in refs_max.values()):
        raise RuntimeError(f"the range case does not test the range: plain |dS| max {ds_max}, outputs {refs_max}")
    calls = {
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, scale=scale),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=scale),
    }
    rows = {}
    for name, call in calls.items():
        got = launch_checked(device, name, torch.float16, call, expect[name])
        rows[name] = {"scales": FLASH_RANGE_SCALES, "plain_ds_abs_max": ds_max, "plain_abs_max": refs_max,
                      "errors": {key: hold_flash_output(name, key, got[key], ref, q, k, v, do, lse, delta, scale,
                                                        dp_order=True)
                                 for key, ref in expect[name].items()}}
        log(f"[flash] {name} float16 range case: {json.dumps(rows[name])}")
    return rows


def compare_worker(tree, head_dim=FLASH_SHAPE["d"]):
    """One `--compare` run of `tree`'s kernels, built into tree/build/: K1
    and K2 (`paged_compare`), then the flash kernels in bf16 at FLASH_SHAPE
    with head dimension `head_dim` (`flash_compare`)."""
    sys.path.insert(0, os.path.abspath(tree))
    from accelerate_tpu_torch.ops import _build

    _build.build(["flash_attention", "paged_attention"])
    device = torch.device("cuda", 0)
    report = {"tree": tree, "paged": paged_compare(device),
              "paged_ptxas": ptxas_report(_build.BUILD_LOG.get("paged_attention", ""))}
    report.update(flash_compare(device, head_dim))
    report["ptxas"] = [line for line in ptxas_report(_build.BUILD_LOG.get("flash_attention", "")) if "wgmma" in line]
    report["card"] = card_line()
    return report


def paged_compare(device, shape=KERNEL_SHAPE):
    """K1 and K2 with bf16 queries at `shape` over bf16, int8 and fp8 pools
    (the pools of `kernel_case`, quantized as in `quantized_kernel_phase`):
    each call's largest error against the plain version, its times and the
    library call's as the kernel phases take them (`paired_times`), and the
    wall time per call of SERVING_CALLS calls back to back and the host's
    time per call over the first HOST_CALLS (`loop_times`: `loop_ms`,
    `host_ms`); the host's work bounds `loop_ms` once it outlasts the
    device's."""
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.ops import quantization as qz

    rows = {}
    for kind, s in (("decode", 1), ("verify", shape["verify_s"])):
        fn = pa.paged_decode_attention if s == 1 else pa.paged_verify_attention
        q, k, v, table, pos = kernel_case(device, torch.float32, s, seed=11 + s, **shape)
        q = q.to(torch.bfloat16)
        for kv in ("bfloat16", *KV_DTYPES):
            if kv == "bfloat16":
                pools, scales = (k.to(torch.bfloat16), v.to(torch.bfloat16)), {}
                dense = pools
            else:
                spec = qz.kv_quant_spec(kv)
                (kq, ks), (vq, vs) = qz.quantize_kv_pages(k, spec), qz.quantize_kv_pages(v, spec)
                pools, scales = (kq, vq), dict(k_scale=ks, v_scale=vs)
                dense = (qz.dequantize_kv(kq, ks[:, None, :, None], torch.bfloat16),
                         qz.dequantize_kv(vq, vs[:, None, :, None], torch.bfloat16))
            args = (q, *pools, table, pos)
            err = float((fn(*args, **scales).float()
                         - pa.paged_attention_reference(*args, **scales).float()).abs().max())
            row = paired_times(lambda: fn(*args, **scales), sdpa_yardstick(q, *dense, table, pos), device)
            row["loop_ms"], row["host_ms"] = loop_times(lambda: fn(*args, **scales), device)
            row["max_abs_err"] = err
            rows[kind if kv == "bfloat16" else f"{kind}_{kv}"] = row
            del pools, scales, dense, args
    return rows


def flash_compare(device, head_dim):
    """K3, K4 and K5 in bf16 at FLASH_SHAPE with head dimension `head_dim`
    (causal), and under ``t5cross`` at T5_CROSS_FLASH_SHAPE (non-causal,
    scale 1.0): times, errors against the plain versions and SDPA's forward
    time."""
    out = flash_compare_case(device, dict(FLASH_SHAPE, d=head_dim), causal=True, scale=head_dim ** -0.5)
    out["t5cross"] = flash_compare_case(device, T5_CROSS_FLASH_SHAPE, causal=False, scale=1.0)
    return out


def flash_compare_case(device, shape, causal, scale):
    from accelerate_tpu_torch.ops import flash_attention as fa

    q, k, v, do = flash_case(device, torch.bfloat16, seed=21, **shape)
    o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale)
    delta = (do.float() * o.float()).sum(-1)
    ref_o, ref_lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    ref_dk, ref_dv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    ref_dq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    got = dict(zip(("dk", "dv"), fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale)),
               o=o, lse=lse, dq=fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale))
    refs = {"o": ref_o, "lse": ref_lse, "dq": ref_dq, "dk": ref_dk, "dv": ref_dv}
    errors = {key: float((got[key].float() - ref.float()).abs().max()) for key, ref in refs.items()}
    del got, refs, ref_o, ref_lse, ref_dk, ref_dv, ref_dq
    calls = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, causal=causal, scale=scale),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale),
    }
    ms = {name: time_ms(call, device) for name, call in calls.items()}
    ms["sdpa_fwd"] = time_ms(sdpa_flash_yardsticks(q, k, v, do, shape["b"], shape["hq"], causal, scale)[0], device)
    device_ms = {name: time_ms(call, device, spin=True) for name, call in calls.items()}
    return {"shape": dict(shape, causal=causal, scale=scale), "ms": ms, "device_ms": device_ms, "errors": errors}


def compare(trees, head_dim=FLASH_SHAPE["d"]) -> int:
    """Each tree in a process of its own, in the order given and then in
    reverse; non-zero if any run failed."""
    failed = 0
    for tree in list(trees) + list(trees)[::-1]:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--compare-worker", tree,
                              "--head-dim", str(head_dim)], timeout=600)
        failed += run.returncode != 0
    return 1 if failed else 0


# ----------------------------------------------------------------- training
def repeated_batch_loader(vocab, batch, steps, seq, seed=0):
    """A `SimpleDataLoader` over `batch` token rows from numpy `seed`,
    repeated so that it yields the same batch `steps` times."""
    from accelerate_tpu_torch import BatchSampler, SimpleDataLoader

    rows = np.random.default_rng(seed).integers(0, vocab, (batch, seq)).astype(np.int64)
    data = [{"input_ids": rows[i % batch]} for i in range(batch * steps)]
    return SimpleDataLoader(data, BatchSampler(range(len(data)), batch))


def train(device, config, mixed_precision, batch, steps, seq=TRAIN_SEQ, warmup=0, on_step=None,
          after_step=None, remat_policy=None, loader=None, aux_out=None, analyze=False, keep=None,
          accelerator_kw=None, on_host=False, sharding_rules=None):
    """Train a model of `config` (its family's, random weights from seed 0)
    through the user's entry points; returns (per-step losses, per-step seconds, the
    prepared model, the step function, the last batch). `on_step(i,
    step_fn)` runs before step i and `after_step(i, step_fn)` after it, both
    outside its timing. `remat_policy` goes to the accelerator's
    `CompilationConfig`. The data is `loader`, or one repeated batch of
    `batch` x `seq` tokens (`repeated_batch_loader`). A loss that returns
    ``(loss, aux)`` (Mixtral's) appends each step's aux, as floats, to
    `aux_out`. `analyze` and `accelerator_kw` go to the `Accelerator`;
    `keep`, a dict, receives it under "accelerator". `on_host` hands
    `prepare` the model on the host (made on the device, then moved).
    `sharding_rules` (a table or ``"auto"``) replaces the model's own."""
    from accelerate_tpu_torch import Accelerator, CompilationConfig
    from accelerate_tpu_torch.models import CREATE_BY_FAMILY
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    model = CREATE_BY_FAMILY[type(config)](config, seed=0, device=device)
    if sharding_rules is not None:
        model.sharding_rules = sharding_rules
    if on_host:
        model = model.cpu()
        free_memory(device)
    accelerator = Accelerator(mixed_precision=mixed_precision, cpu=device.type == "cpu",
                              compilation_config=CompilationConfig(remat_policy=remat_policy), analyze=analyze,
                              **(accelerator_kw or {}))
    if keep is not None:
        keep["accelerator"] = accelerator
    optimizer = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=TRAIN_BETAS, eps=TRAIN_EPS,
                                  weight_decay=TRAIN_WD)
    if loader is None:
        loader = repeated_batch_loader(config.vocab_size, batch, warmup + steps, seq)
    pmodel, optimizer, loader, schedule = accelerator.prepare(model, optimizer, loader, lambda step: TRAIN_LR)
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    losses, seconds = [], []
    for i, b in enumerate(loader):
        if on_step is not None:
            on_step(i, step_fn)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = step_fn(b)
        schedule.step()
        loss, aux = out if isinstance(out, tuple) else (out, None)
        losses.append(float(loss))  # reads the loss back: the step is done
        seconds.append(time.perf_counter() - t0)
        if aux is not None and aux_out is not None:
            aux_out.append({k: float(v) for k, v in aux.items()})
        if after_step is not None:
            after_step(i, step_fn)
    return losses, seconds, pmodel, step_fn, b


def expected_launches(n, dtype=None):
    """Flash launch counts of a run that launched each kernel `n` times on
    tensors of `dtype` (f32 and bf16 share a count, fp16 has its own) and
    none on others."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    mine = {launch_key(name, dtype) for name in FLASH_KERNELS} if dtype is not None else set()
    return {key: n if key in mine else 0 for key in fa.LAUNCHES}


def step_report(batch, seq, seconds, warmup, params, config, launches):
    """Median step time of the timed steps, tokens/s, MFU (6 x non-embedding
    parameters x tokens/s over 989 TFLOP/s, dense bf16 and fp16 alike)."""
    step_s = float(np.median(seconds[warmup:]))
    tokens_per_s = batch * seq / step_s
    non_embedding = params - config.vocab_size * config.hidden_size
    return {
        "batch": batch, "parameters": params, "warmup_steps": warmup, "timed_steps": len(seconds) - warmup,
        "step_ms_median": 1e3 * step_s, "step_ms": [1e3 * x for x in seconds],
        "tokens_per_s": tokens_per_s, "mfu": 6 * non_embedding * tokens_per_s / BF16_PEAK_FLOPS,
        "launches": launches,
    }


def f32_flash_parity(device, config, seq, steps=3):
    """f32 training of `config` (batch 1, `steps` steps) once through the
    flash kernels and once through the plain attention
    (ACCELERATE_TPU_ATTENTION_IMPL=xla), from the same weights and batch:
    the losses agree within TRAIN_F32_RTOL, and on the card the kernel run
    launched each flash kernel layers x steps times, the plain run none."""
    import os

    from accelerate_tpu_torch.ops import flash_attention as fa

    layers = config.num_hidden_layers
    runs = {}
    for impl in ("flash", "xla"):
        fa.reset_launch_counts()
        if impl == "xla":
            os.environ["ACCELERATE_TPU_ATTENTION_IMPL"] = "xla"
        try:
            runs[impl] = train(device, config, "no", batch=1, steps=steps, seq=seq)[0]
        finally:
            os.environ.pop("ACCELERATE_TPU_ATTENTION_IMPL", None)
        launches = dict(fa.LAUNCHES)
        log(f"[train] f32 {layers} layers (head {config.head_dim}), {impl} attention: losses {runs[impl]}, "
            f"launches {launches}")
        if device.type == "cuda":
            want = expected_launches(layers * steps, torch.float32 if impl == "flash" else None)
            if launches != want:
                raise RuntimeError(f"f32 {impl} run: flash launches {launches}, expected {want}")
            torch.cuda.empty_cache()
    diff = [abs(a - b) / abs(b) for a, b in zip(runs["flash"], runs["xla"])]
    if not all(np.isfinite(runs["flash"])) or max(diff) > TRAIN_F32_RTOL:
        raise RuntimeError(f"f32 kernel losses {runs['flash']} differ from plain {runs['xla']} (rtol {diff})")
    return {"layers": layers, "losses_kernels": runs["flash"], "losses_plain": runs["xla"], "max_rel_diff": max(diff),
            "rtol": TRAIN_F32_RTOL}


def training_phase(device, model_name="llama-1b", parity_layers=2, seq=TRAIN_SEQ, timed_steps=8,
                   warmup=2, batch=2, profile=False):
    import dataclasses

    from accelerate_tpu_torch.models import MODEL_REGISTRY
    from accelerate_tpu_torch.ops import flash_attention as fa

    config = MODEL_REGISTRY[model_name]()
    on_card = device.type == "cuda"
    report = {"model": model_name, "seq": seq}
    layers = config.num_hidden_layers

    # (a) f32 at full width, cut to `parity_layers` layers: kernels vs plain attention.
    report["f32_parity"] = f32_flash_parity(device, dataclasses.replace(config, num_hidden_layers=parity_layers), seq)

    # (b) bf16 at full width and depth, timed.
    def before_step(i, step_fn):
        if i == warmup:
            fa.reset_launch_counts()
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)

    losses, seconds, pmodel, step_fn, last_batch = train(
        device, config, "bf16", batch=batch, steps=timed_steps, seq=seq, warmup=warmup, on_step=before_step
    )
    launches = dict(fa.LAUNCHES)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"bf16 training losses are not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"bf16 training on a repeated batch did not fit it: {losses}")
    if on_card and launches != expected_launches(layers * timed_steps, torch.bfloat16):
        raise RuntimeError(f"bf16 timed steps: flash launches {launches}, expected {layers} x {timed_steps}")
    bf16 = step_report(batch, seq, seconds, warmup, pmodel.num_parameters, config, launches)
    bf16["losses"] = losses
    if on_card:
        bf16["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    log(f"[train] bf16 {model_name}: {json.dumps(bf16)}")
    report["bf16"] = bf16
    if profile:
        report["bf16_profile"] = profile_train_step(step_fn, last_batch, device, bf16["step_ms_median"] / 1e3)
    del pmodel, step_fn, last_batch
    free_memory(device)

    # (d) fp16 with dynamic loss scaling at full width and depth, timed.
    t0 = time.perf_counter()
    report["fp16"] = fp16_phase(device, config, batch, seq, timed_steps, warmup)
    log(f"[time] training (d) fp16 {time.perf_counter() - t0:.1f}s")
    free_memory(device)

    return report


def fp16_phase(device, config, batch, seq, timed_steps, warmup):
    """(d): `train_step` under `mixed_precision="fp16"` with the default
    `GradScalerKwargs` (scale 65536). Gates: finite losses; at least one
    timed step applied; one weight matrix unchanged bit for bit across every
    skipped step; the scale after each step as the scaler's rule gives it
    from the skip pattern; the last loss below the first where two or more
    steps were applied; each fp16 flash kernel launched layers x timed
    steps times, skipped steps included, and no other flash kernel."""
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.optimizer import GradScaler

    on_card = device.type == "cuda"
    watched = {}  # a copy of layer 0's query projection (f32 master) before each step

    def before_step(i, step_fn):
        if i == warmup:
            fa.reset_launch_counts()
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
        watched["weight"] = step_fn.model.module.layers[0].attention.wq.weight
        watched["before"] = watched["weight"].detach().clone()

    record = {"skipped": [], "scale": [], "unchanged": []}

    def after_step(i, step_fn):
        opt = step_fn.optimizer
        record["skipped"].append(opt.step_was_skipped)
        record["scale"].append(opt.scaler.scale)
        record["unchanged"].append(bool(torch.equal(watched["weight"], watched["before"])))

    losses, seconds, pmodel, step_fn, _ = train(device, config, "fp16", batch=batch, steps=timed_steps, seq=seq,
                                                warmup=warmup, on_step=before_step, after_step=after_step)
    launches = dict(fa.LAUNCHES)
    out = step_report(batch, seq, seconds, warmup, pmodel.num_parameters, config, launches)
    out.update(losses=losses, skipped=record["skipped"], scale_after_step=record["scale"],
               weight_unchanged=record["unchanged"])
    if on_card:
        out["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    del pmodel, step_fn, watched["weight"], watched["before"]
    log(f"[train] fp16 {json.dumps(out)}")
    rule = GradScaler()
    replay = []
    for skipped in record["skipped"]:
        rule.update(skipped)
        replay.append(rule.scale)
    applied = [i for i, skipped in enumerate(record["skipped"]) if not skipped]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"fp16 training losses are not finite: {losses}")
    if not any(i >= warmup for i in applied):
        raise RuntimeError(f"fp16: no timed step was applied (skipped {record['skipped']})")
    if any(skip and not same for skip, same in zip(record["skipped"], record["unchanged"])):
        raise RuntimeError(f"fp16: a skipped step changed the weights (skipped {record['skipped']}, "
                           f"unchanged {record['unchanged']})")
    if any(not skip and same for skip, same in zip(record["skipped"], record["unchanged"])):
        raise RuntimeError(f"fp16: an applied step left the weights as they were ({record['unchanged']})")
    if replay != record["scale"]:
        raise RuntimeError(f"fp16: scales {record['scale']} do not follow the scaler's rule {replay}")
    if len(applied) >= 2 and not losses[-1] < losses[0]:
        raise RuntimeError(f"fp16 training on a repeated batch did not fit it: {losses}")
    want = expected_launches(config.num_hidden_layers * timed_steps, torch.float16)
    if on_card and launches != want:
        raise RuntimeError(f"fp16 timed steps: flash launches {launches}, expected {want}")
    return out


# Activation checkpointing (phase 5 (f)) and BERT (phase 6).
REMAT_POLICIES = (None, "full", "dots")
# Under a remat policy the recompute runs the same kernels and GEMMs on the
# same inputs as the forward, and what the policy saves it saved from that
# forward: the f32 losses match those without remat to the last bits.
REMAT_F32_RTOL = 1e-6
# BERT-base f32 logits on the card against the same model on the CPU, TF32
# off: the same f32 operations in another summation order over 768-3072
# products, on logits of about 1.
BERT_LOGITS_ATOL = 1e-4


def remat_launches(n, policy, dtype):
    """Flash launch counts of `n` layer steps on `dtype` tensors under
    `policy`: a checkpointed layer launches the forward again in its
    backward, so K3 runs twice as often as K4 and K5."""
    want = expected_launches(n, dtype)
    if policy is not None:
        want[launch_key("flash_fwd", dtype)] *= 2
    return want


def remat_phase(device, model_name="llama-1b", parity_layers=2, seq=TRAIN_SEQ, timed_steps=4, warmup=2, batch=2,
                profile=False):
    """(f) Training under `CompilationConfig(remat_policy=...)`: None, `full`
    and `dots`. f32 at full width cut to `parity_layers` layers, 3 steps
    each: the losses under both policies equal those without remat within
    rtol 1e-6, through the kernels. Then bf16 at full width and depth,
    `warmup` + `timed_steps` steps each: step time, tokens/s, MFU, peak
    memory (counted from the first timed step), losses, flash launches.
    Gates: finite losses; K3 launched 2 x layers x steps times under a
    policy, once per layer step without, K4 and K5 once; peak memory under
    `full` below the run without remat. With `profile`, device time by
    kernel group of one more step under each policy."""
    import dataclasses

    from accelerate_tpu_torch.models import MODEL_REGISTRY
    from accelerate_tpu_torch.ops import flash_attention as fa

    config = MODEL_REGISTRY[model_name]()
    on_card = device.type == "cuda"
    report = {"model": model_name, "seq": seq}

    cut = dataclasses.replace(config, num_hidden_layers=parity_layers)
    f32 = {}
    for policy in REMAT_POLICIES:
        fa.reset_launch_counts()
        f32[str(policy)] = train(device, cut, "no", batch=1, steps=3, seq=seq, remat_policy=policy)[0]
        launches = dict(fa.LAUNCHES)
        log(f"[remat] f32 {parity_layers} layers, remat_policy={policy}: losses {f32[str(policy)]}, "
            f"launches {launches}")
        if on_card and launches != remat_launches(parity_layers * 3, policy, torch.float32):
            raise RuntimeError(f"f32 remat_policy={policy}: flash launches {launches}, expected "
                               f"{remat_launches(parity_layers * 3, policy, torch.float32)}")
        free_memory(device)
    base = f32["None"]
    diffs = {p: max(abs(a - b) / abs(b) for a, b in zip(f32[p], base)) for p in f32 if p != "None"}
    if not all(np.isfinite(x) for losses in f32.values() for x in losses) or max(diffs.values()) > REMAT_F32_RTOL:
        raise RuntimeError(f"f32 losses under remat {f32} differ from those without (rtol {diffs})")
    report["f32_parity"] = {"layers": parity_layers, "losses": f32, "max_rel_diff": diffs, "rtol": REMAT_F32_RTOL}

    runs = {}
    for policy in REMAT_POLICIES:
        def before_step(i, step_fn):
            if i == warmup:
                fa.reset_launch_counts()
                if on_card:
                    torch.cuda.reset_peak_memory_stats(device)

        losses, seconds, pmodel, step_fn, last_batch = train(device, config, "bf16", batch=batch, steps=timed_steps,
                                                             seq=seq, warmup=warmup, on_step=before_step,
                                                             remat_policy=policy)
        launches = dict(fa.LAUNCHES)
        want = remat_launches(config.num_hidden_layers * timed_steps, policy, torch.bfloat16)
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"bf16 remat_policy={policy}: losses are not finite: {losses}")
        if on_card and launches != want:
            raise RuntimeError(f"bf16 remat_policy={policy}: flash launches {launches}, expected {want}")
        run = step_report(batch, seq, seconds, warmup, pmodel.num_parameters, config, launches)
        run["losses"] = losses
        if on_card:
            run["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
        log(f"[remat] bf16 {model_name} remat_policy={policy}: {json.dumps(run)}")
        if profile:
            run["profile"] = profile_train_step(step_fn, last_batch, device, run["step_ms_median"] / 1e3)
        runs[str(policy)] = run
        del pmodel, step_fn, last_batch
        free_memory(device)
    if on_card and not runs["full"]["peak_memory_bytes"] < runs["None"]["peak_memory_bytes"]:
        raise RuntimeError(f"peak memory under full remat {runs['full']['peak_memory_bytes']} is not below "
                           f"{runs['None']['peak_memory_bytes']} without remat")
    report["bf16"] = runs
    # Reported, not gated: bf16 GEMMs may pick other algorithms across runs.
    report["bf16_max_rel_loss_diff"] = {
        p: max(abs(a - b) / abs(b) for a, b in zip(runs[p]["losses"], runs["None"]["losses"])) for p in ("full", "dots")
    }
    return report


def bert_batch(config, batch, seq, seed=0):
    """[B, S] token ids, a ragged 0/1 padding mask and token types (two
    halves) from numpy `seed`."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, config.vocab_size, (batch, seq))
    lengths = rng.integers(seq // 2, seq + 1, batch)
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int64)
    types = (np.arange(seq)[None, :] >= seq // 2).astype(np.int64).repeat(batch, 0)
    return torch.as_tensor(ids), torch.as_tensor(mask), torch.as_tensor(types)


def run_example(device, example_args):
    """The twin example's `training_function` with `example_args`, the
    wall time of each step (the device synchronised at each `backward`) and
    the metrics it logged; its output directory is removed afterwards."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.examples import nlp_example
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    stamps = []

    class TimedAccelerator(nlp_example.Accelerator):
        def backward(self, *args, **kwargs):
            sync(self.device)
            stamps.append(time.perf_counter())
            return super().backward(*args, **kwargs)

    output_dir = tempfile.mkdtemp()
    args = nlp_example.parse_args([*example_args, "--output_dir", output_dir,
                                   *(["--cpu"] if device.type == "cpu" else [])])
    AcceleratorState._reset_state()
    GradientState._reset_state()
    original, nlp_example.Accelerator = nlp_example.Accelerator, TimedAccelerator
    try:
        t0 = time.perf_counter()
        accuracy = nlp_example.training_function(args)
        sync(device)
        wall = time.perf_counter() - t0
        with open(os.path.join(output_dir, "nlp_example", "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
    finally:
        nlp_example.Accelerator = original
        shutil.rmtree(output_dir, ignore_errors=True)
    steps = -(-args.train_size // args.batch_size)
    # A step is the time from one backward to the next within an epoch.
    intervals = [b - a for e in range(args.epochs) for a, b in zip(stamps[e * steps:(e + 1) * steps - 1],
                                                                   stamps[e * steps + 1:(e + 1) * steps])]
    return args, accuracy, wall, metrics, intervals


def bert_phase(device, model_name="bert-base", example_args=("--full",), logits_batch=8, seq=128, profile=False):
    """6. BERT. An f32 forward of `model_name` on one batch on `device`
    against the same model on the CPU (logits within atol 1e-4); the twin
    of `examples/nlp_example.py` run through its `training_function` with
    `example_args` (BERT-base at the example's defaults: bf16, batch 32 x
    128, 512 training and 128 eval samples, 3 epochs): step time,
    samples/s, MFU beside the GEMM dtype, peak memory, per-epoch loss and
    accuracy; gates: finite losses, the last epoch's loss below the
    first's. Then the peak memory of one bf16 step under remat None and
    `full`, reported; with `profile`, device time by kernel of one more
    step without remat and the device's busy share of the example's step."""
    import copy

    from accelerate_tpu_torch import Accelerator, CompilationConfig, create_named_model
    from accelerate_tpu_torch.examples import nlp_example
    from accelerate_tpu_torch.models import MODEL_REGISTRY
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    config = MODEL_REGISTRY[model_name]()
    on_card = device.type == "cuda"
    report = {"model": model_name}

    cpu_model = create_named_model(model_name, seed=0, device="cpu")
    params = sum(p.numel() for p in cpu_model.parameters())
    model = copy.deepcopy(cpu_model).to(device)
    inputs = bert_batch(config, logits_batch, seq)
    with torch.no_grad():
        ref = cpu_model(*inputs)
        got = model(*(t.to(device) for t in inputs)).cpu()
    err = float((got - ref).abs().max())
    if not bool(torch.isfinite(got).all()) or err > BERT_LOGITS_ATOL:
        raise RuntimeError(f"{model_name} f32 logits on {device} differ from the CPU's by {err}")
    report["f32_logits_vs_cpu"] = {"batch": logits_batch, "seq": seq, "max_abs_err": err, "atol": BERT_LOGITS_ATOL}
    log(f"[bert] f32 {model_name} logits on {device} vs cpu: max_abs_err {err}")
    del model, cpu_model
    free_memory(device)

    args, accuracy, wall, metrics, intervals = run_example(device, example_args)
    losses = [m["loss"] for m in metrics]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"the nlp example's per-epoch losses {losses} are not finite and falling")
    step_s = float(np.median(intervals))
    tokens_per_s = args.batch_size * nlp_example.MAX_LEN / step_s
    example = {
        "args": {k: v for k, v in vars(args).items() if k != "output_dir"}, "parameters": params,
        "wall_s": wall, "step_ms_median": 1e3 * step_s, "steps_timed": len(intervals),
        "samples_per_s": args.batch_size / step_s, "tokens_per_s": tokens_per_s,
        "mfu": 6 * (params - config.vocab_size * config.hidden_size) * tokens_per_s / BF16_PEAK_FLOPS,
        "gemm_dtype": "float32 (flax's promotion after each f32 LayerNorm, as in the JAX package)",
        "losses": losses, "accuracies": [m["accuracy"] for m in metrics], "final_accuracy": accuracy,
    }
    if on_card:
        example["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    log(f"[bert] nlp example: {json.dumps(example)}")
    report["example"] = example
    free_memory(device)

    peaks = {}
    data = nlp_example.get_dataset(config.vocab_size - 1, n=args.batch_size)
    batch = {k: torch.as_tensor(np.stack([row[k] for row in data])).to(device) for k in data[0]}
    for policy in (None, "full"):
        AcceleratorState._reset_state()
        GradientState._reset_state()
        accelerator = Accelerator(mixed_precision="bf16", cpu=not on_card,
                                  compilation_config=CompilationConfig(remat_policy=policy))
        model = create_named_model(model_name, seed=0, device=device)
        prepared, optimizer = accelerator.prepare(
            model, torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=nlp_example.WEIGHT_DECAY))
        free_memory(device)
        loss = accelerator.backward(prepared.loss, batch)
        optimizer.step()
        optimizer.zero_grad()
        if not np.isfinite(float(loss)):
            raise RuntimeError(f"{model_name} bf16 step under remat_policy={policy}: loss {float(loss)}")
        peaks[str(policy)] = int(torch.cuda.max_memory_allocated(device)) if on_card else None
        if profile and policy is None:
            def step():
                t0 = time.perf_counter()
                accelerator.backward(prepared.loss, batch)
                accelerator.clip_grad_norm_(max_norm=1.0)
                optimizer.step()
                optimizer.zero_grad()
                sync(device)
                return time.perf_counter() - t0

            report["profile"] = profile_run(step, step_s)
            log(f"[bert] bf16 step profile: {json.dumps(report['profile'])}")
        del model, prepared, optimizer, accelerator
        free_memory(device)
    report["one_step_peak_memory_bytes"] = {"batch": args.batch_size, "seq": nlp_example.MAX_LEN, **peaks}
    log(f"[bert] one bf16 step, peak memory by remat policy: {json.dumps(report['one_step_peak_memory_bytes'])}")
    return report


def profile_train_step(step_fn, batch, device, unprofiled_step_s):
    """Device time by kernel group over one more bf16 training step under
    `torch.profiler`: the flash kernels (each by name), GEMMs and the rest,
    the grouped-query repeat, and the busy share of the unprofiled median
    step (the profiler slows the host, not the device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        out = step_fn(batch)
        float(out[0] if isinstance(out, tuple) else out)  # a (loss, aux) step: Mixtral's
    # A user annotation (the optimizer's `Optimizer.step#AdamW.step`) spans
    # kernels that are counted on their own: leave it out of the sums.
    kernels = [
        (row.self_device_time_total, row.key, row.count)
        for row in prof.key_averages()
        if row.device_type == DeviceType.CUDA and row.self_device_time_total > 0
        and not getattr(row, "is_user_annotation", False)
    ]
    total_us = sum(us for us, _, _ in kernels)
    if total_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    groups = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    flash = []
    for us, name, calls in kernels:
        lowered = name.lower()
        if "flash_" in lowered and "kernel" in lowered:
            groups["flash_attention"] += us
            flash.append({"name": name[:140], "calls": calls, "ms": us / 1e3, "share": us / total_us})
        elif any(tag in lowered for tag in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
            groups["gemm"] += us
        else:
            groups["other"] += us
    kernels.sort(reverse=True)
    out = {
        "device_busy_ms": total_us / 1e3,
        "busy_share_of_unprofiled_step": total_us / 1e6 / unprofiled_step_s,
        "share_by_group": {k: v / total_us for k, v in groups.items()},
        "gqa_repeat": gqa_repeat_time(prof),
        "flash_kernels": sorted(flash, key=lambda row: -row["ms"]),  # every one, by name
        "top_kernels": [
            {"name": name[:140], "calls": calls, "ms": us / 1e3, "share": us / total_us}
            for us, name, calls in kernels[:15]
        ],
    }
    log(f"[train] bf16 profile: {json.dumps(out)}")
    return out


def gqa_repeat_time(prof):
    """Device time (ms) and calls of `flash_attention`'s grouped-query
    repeat in a step profiled with `record_shapes`: `repeat_interleave` by
    an int (an expand and a copy of K or V to every query head) forward, and
    its backward, autograd's sum of the gradient over each group, the one
    `aten::sum` of a step over a 5-D [B, S, Hkv, group, D] tensor; each op's
    kernels counted under it."""
    out = {"forward_ms": 0.0, "forward_calls": 0, "backward_ms": 0.0, "backward_calls": 0}
    for row in prof.key_averages(group_by_input_shape=True):
        shapes = row.input_shapes or [[]]
        side = ("forward" if row.key == "aten::repeat_interleave" else
                "backward" if row.key == "aten::sum" and len(shapes[0]) == 5 else None)
        if side:
            out[f"{side}_ms"] += row.device_time_total / 1e3
            out[f"{side}_calls"] += row.count
    return out


# ----------------------------------------------------------------- families
def neox_engine_phase(device, model_name="gpt-neox-20b", parity_layers=2, w8_layers=NEOX_W8_LAYERS, n_requests=8,
                      system_len=256, new=32, n_prompts=4, profile=False, timed_layers=NEOX_TIMED_LAYERS):
    """GPT-NeoX through the paged engine (K1 and K2 at D 96, G = 1). (a) f32
    at full width cut to `parity_layers` layers: the kernel path's tokens
    equal the gather path's, unquantized and on int8 and fp8 caches
    (`engine_parity`), and `generate`'s greedy tokens equal the K1 engine's
    on `n_prompts` prompts; (b) bf16 at full width cut to `timed_layers`
    layers, timed, with the launch gates of `engine_timed`; (e) int8
    weights over an int8 and an
    fp8 cache at `w8_layers` layers (`engine_quantized`). With `profile`,
    device time by kernel group of one more bf16 plain run."""
    import dataclasses

    from accelerate_tpu_torch import GenerationConfig, Generator, Request
    from accelerate_tpu_torch.models import CREATE_BY_FAMILY, MODEL_REGISTRY

    config = MODEL_REGISTRY[model_name]()
    create = CREATE_BY_FAMILY[type(config)]
    engine_kw = dict(ENGINE_KW)
    report = {"model": model_name, "engine": engine_kw, "draft_tokens": SPEC_KW["draft_tokens"],
              "parity_layers": parity_layers, "w8_layers": w8_layers}
    requests = make_requests(config.vocab_size, n=n_requests, system_len=system_len)

    t0 = time.perf_counter()
    model = create(dataclasses.replace(config, num_hidden_layers=parity_layers), seed=0, dtype=torch.float32,
                   device=device)
    log_model(f"[neox] {model_name} f32 cut", model, t0)
    engine_parity(model, requests, device, engine_kw, report)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, config.vocab_size, (256,)) for _ in range(n_prompts)]
    gen = Generator(model, max_length=engine_kw["max_length"], device=device)
    got = gen(np.stack(prompts), GenerationConfig(max_new_tokens=new)).cpu().numpy()[:, 256:]
    _, tokens, _ = serve(model, [Request(i, p, max_new_tokens=new) for i, p in enumerate(prompts)], device,
                         **engine_kw)
    if [list(map(int, row)) for row in got] != [tokens[i] for i in range(n_prompts)]:
        raise RuntimeError("f32 NeoX cut: generate's greedy tokens differ from the paged_kernel engine's")
    report["f32_generate_equals_paged_kernel_engine"] = n_prompts
    log(f"[neox] f32 {parity_layers} layers: generate's tokens == the paged_kernel engine's for {n_prompts} prompts")
    del model, gen
    free_memory(device)
    log(f"[time] neox (a) f32 {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    timed = dataclasses.replace(config, num_hidden_layers=min(timed_layers, config.num_hidden_layers))
    model = create(timed, seed=0, dtype=torch.bfloat16, device=device)
    log_model(f"[neox] {model_name} bf16", model, t0)
    _, nbytes = engine_timed(model, requests, device, engine_kw, report)
    if profile:
        report["bf16_plain_profile"] = profile_run(
            lambda: serve(model, requests, device, **engine_kw)[2]["wall_s"], report["bf16_plain"]["wall_s"])
        log(f"[neox] bf16 plain profile: {json.dumps(report['bf16_plain_profile'])}")
    del model
    free_memory(device)
    log(f"[time] neox (b) bf16 {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    model = create(dataclasses.replace(config, num_hidden_layers=w8_layers), seed=0, dtype=torch.bfloat16,
                   device=device)
    # The bf16 cache of a model of this depth: the pools are per layer.
    engine_quantized(model, requests, device, engine_kw, report, None,
                     nbytes * w8_layers // timed.num_hidden_layers)
    del model
    free_memory(device)
    log(f"[time] neox (e) int8 weights {time.perf_counter() - t0:.1f}s")
    return report


#: The families' generate at a cut depth: {name: layers} (the others at full depth).
FAMILY_GENERATE_LAYERS = {"gpt-neox-20b": NEOX_TIMED_LAYERS}


def family_generate_phase(device, model_name, shape=GENERATE_SHAPE, profile=False, model=None):
    """`generate` of `model_name` in bf16 at full width and depth, or the
    depth `FAMILY_GENERATE_LAYERS` gives it (random weights from seed 0, or
    `model` when the caller made it): batch 1 on a
    `timed_prompt`-token prompt, `timed_new` new tokens (`timed_generate`:
    TTFT, decode tokens/s, peak memory), after a warm-up; every K1-K5 count
    stays 0 over it. With `profile`, device time by kernel group of one
    more such call."""
    from accelerate_tpu_torch import GenerationConfig, Generator, create_named_model

    t0 = time.perf_counter()
    if model is None and model_name in FAMILY_GENERATE_LAYERS:
        from accelerate_tpu_torch.models import CREATE_BY_FAMILY

        config = cut_config(model_name, FAMILY_GENERATE_LAYERS[model_name])
        model = CREATE_BY_FAMILY[type(config)](config, seed=0, dtype=torch.bfloat16, device=device)
    elif model is None:
        model = create_named_model(model_name, seed=0, dtype=torch.bfloat16, device=device)
    log_model(f"[family] {model_name} bf16", model, t0)
    report = {"model": model_name, "layers": model.config.num_hidden_layers,
              "parameters": sum(p.numel() for p in model.parameters()), "build_s": time.perf_counter() - t0}
    vocab = model.config.vocab_size
    gen = Generator(model, max_length=shape["max_length"], device=device)
    rng = np.random.default_rng(1)
    gen(rng.integers(0, vocab, (1, 8)), GenerationConfig(max_new_tokens=4))  # warm-up
    reset_launch_counts()
    prompt = rng.integers(0, vocab, (shape["timed_prompt"],))
    _, report["bf16_batch1"] = timed_generate(gen, prompt[None], device, max_new_tokens=shape["timed_new"])
    report["launches"] = launch_counts()
    if any(report["launches"].values()):
        raise RuntimeError(f"a K1-K5 kernel launched on {model_name}'s generate path: {report['launches']}")
    log(f"[family] {model_name} generate bf16 batch 1: {json.dumps(report['bf16_batch1'])}")
    if profile:
        def run():
            t = time.perf_counter()
            gen(prompt[None], GenerationConfig(max_new_tokens=shape["timed_new"]))
            sync(device)
            return time.perf_counter() - t

        report["bf16_batch1_profile"] = profile_run(run, report["bf16_batch1"]["wall_s"])
        log(f"[family] {model_name} generate profile: {json.dumps(report['bf16_batch1_profile'])}")
    del gen, model
    free_memory(device)
    return report


def family_training_phase(device, model_name, layers, seq=TRAIN_SEQ, timed_steps=FAMILY_TIMED_STEPS,
                          warmup=FAMILY_WARMUP, batch=2, fp16_steps=FAMILY_FP16_STEPS, parity_steps=3,
                          parity_layers=2, profile=False):
    """Training of `model_name` at full width cut to `layers` layers through
    `Accelerator.prepare` and the fused `train_step`: (a) f32 cut to
    `parity_layers` layers, batch 1, the flash kernels' losses against the
    plain attention's (`f32_flash_parity`); (b) bf16 mixed precision with f32 masters, batch x
    `seq` tokens, `warmup` + `timed_steps` steps on one repeated batch: step
    time, tokens/s, MFU, peak memory; losses finite and falling; each flash
    kernel launched layers x timed steps times at the family's head dim;
    (c) fp16 with loss scaling, `fp16_steps` steps: finite losses and each
    fp16 flash kernel launched layers x steps times. With `profile`, device
    time by kernel group of one more bf16 step."""
    import dataclasses

    from accelerate_tpu_torch.models import MODEL_REGISTRY
    from accelerate_tpu_torch.ops import flash_attention as fa

    config = dataclasses.replace(MODEL_REGISTRY[model_name](), num_hidden_layers=layers)
    on_card = device.type == "cuda"
    report = {"model": model_name, "layers": layers, "head_dim": config.head_dim, "seq": seq}
    t0 = time.perf_counter()
    report["f32_parity"] = f32_flash_parity(device, dataclasses.replace(config, num_hidden_layers=parity_layers), seq,
                                            steps=parity_steps)
    free_memory(device)
    log(f"[time] {model_name} training (a) f32 {time.perf_counter() - t0:.1f}s")

    def before_step(i, step_fn):
        if i == warmup:
            fa.reset_launch_counts()
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    losses, seconds, pmodel, step_fn, last_batch = train(device, config, "bf16", batch=batch, steps=timed_steps,
                                                         seq=seq, warmup=warmup, on_step=before_step)
    launches = dict(fa.LAUNCHES)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"{model_name} bf16 training on a repeated batch: losses {losses}")
    if on_card and launches != expected_launches(layers * timed_steps, torch.bfloat16):
        raise RuntimeError(f"{model_name} bf16 timed steps: flash launches {launches}, expected {layers} x "
                           f"{timed_steps}")
    bf16 = step_report(batch, seq, seconds, warmup, pmodel.num_parameters, config, launches)
    bf16["losses"] = losses
    if on_card:
        bf16["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    log(f"[family] {model_name} train bf16 {layers} layers: {json.dumps(bf16)}")
    report["bf16"] = bf16
    if profile:
        report["bf16_profile"] = profile_train_step(step_fn, last_batch, device, bf16["step_ms_median"] / 1e3)
    del pmodel, step_fn, last_batch
    free_memory(device)
    log(f"[time] {model_name} training (b) bf16 {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    fa.reset_launch_counts()
    losses, seconds, pmodel, step_fn, _ = train(device, config, "fp16", batch=batch, steps=fp16_steps, seq=seq)
    launches = dict(fa.LAUNCHES)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{model_name} fp16 training losses are not finite: {losses}")
    if on_card and launches != expected_launches(layers * fp16_steps, torch.float16):
        raise RuntimeError(f"{model_name} fp16 steps: flash launches {launches}, expected {layers} x {fp16_steps}")
    report["fp16"] = {"steps": fp16_steps, "losses": losses, "step_ms": [1e3 * x for x in seconds],
                      "launches": launches}
    log(f"[family] {model_name} train fp16 {layers} layers: {json.dumps(report['fp16'])}")
    del pmodel, step_fn
    free_memory(device)
    log(f"[time] {model_name} training (c) fp16 {time.perf_counter() - t0:.1f}s")
    return report


# ----------------------------------------------------------------------- T5
def t5_config(model_name, layers):
    """`model_name`'s T5 config cut to `layers` encoder and `layers` decoder layers."""
    import dataclasses

    from accelerate_tpu_torch.models import MODEL_REGISTRY

    return dataclasses.replace(MODEL_REGISTRY[model_name](), num_layers=layers, num_decoder_layers=layers)


def t5_batch_loader(vocab, batch, steps, enc_seq, dec_seq, seed=0):
    """A `SimpleDataLoader` over one seq2seq batch from numpy `seed`, repeated
    `steps` times: `batch` encoder rows of `enc_seq` tokens, labels of
    `dec_seq` tokens and the decoder inputs, the labels shifted right behind
    the start token 0. No attention mask, so the cross-attention takes the
    flash gate."""
    from accelerate_tpu_torch import BatchSampler, SimpleDataLoader

    rng = np.random.default_rng(seed)
    src = rng.integers(1, vocab, (batch, enc_seq)).astype(np.int64)
    labels = rng.integers(1, vocab, (batch, dec_seq)).astype(np.int64)
    dec = np.concatenate([np.zeros((batch, 1), np.int64), labels[:, :-1]], axis=1)
    data = [{"input_ids": src[i % batch], "decoder_input_ids": dec[i % batch], "labels": labels[i % batch]}
            for i in range(batch * steps)]
    return SimpleDataLoader(data, BatchSampler(range(len(data)), batch))


def t5_step_flops(model, batch, enc_seq, dec_seq):
    """A T5 training step's GEMM operations: 6 x (the encoder blocks'
    parameters x encoder tokens + (the decoder blocks' and the head's) x
    decoder tokens); attention's score products and the lookups are left out."""
    def n(module):
        return sum(p.numel() for p in module.parameters())

    head = model.shared if model.lm_head is None else model.lm_head
    return 6 * batch * (n(model.enc_blocks) * enc_seq + (n(model.dec_blocks) + n(head)) * dec_seq)


def attention_mode(name):
    """A context for T5's attention: ``"flash"`` (the gate as it is),
    ``"xla"`` (ACCELERATE_TPU_ATTENTION_IMPL=xla: the plain path) or
    ``"f64"`` (the plain path on float64 copies of its inputs, cast back: a
    reference of T5's f32 rounding, never a path of the port)."""
    import contextlib

    from accelerate_tpu_torch.models import t5

    @contextlib.contextmanager
    def scope():
        plain = t5.dot_product_attention

        def f64(q, k, v, mask=None, *, bias=None, causal=False, scale=None, **_):
            wide = [x.double() for x in (q, k, v)]
            return plain(*wide, mask, bias=None if bias is None else bias.double(), causal=causal, scale=scale,
                         implementation="xla").to(q.dtype)

        if name != "flash":
            os.environ["ACCELERATE_TPU_ATTENTION_IMPL"] = "xla"
        if name == "f64":
            t5.dot_product_attention = f64
        try:
            yield
        finally:
            os.environ.pop("ACCELERATE_TPU_ATTENTION_IMPL", None)
            t5.dot_product_attention = plain

    return scope()


def t5_f32_parity(device, config, make_loader, steps=T5_PARITY_STEPS + 1):
    """f32 T5 training (batch 1, `steps` steps of `make_loader(1, steps)`'s
    batch) through the kernels, the plain attention and the plain attention
    in float64 (`attention_mode`), from the same weights: the first
    T5_PARITY_STEPS losses through the kernels within TRAIN_F32_RTOL of the
    plain ones; the first step's gradient of every parameter within
    T5_GRAD_RTOL; the kernel runs launched each flash kernel once per
    decoder layer and pass, the others none. Every pair's differences are
    reported."""
    from accelerate_tpu_torch.models import create_t5_model
    from accelerate_tpu_torch.ops import flash_attention as fa

    modes = ("flash", "xla", "f64")
    layers = config.num_decoder_layers
    losses, grads = {}, {}
    batch = {k: torch.as_tensor(v, device=device) for k, v in next(iter(make_loader(1, 1))).items()}
    model = create_t5_model(config, seed=0, device=device)
    for name in modes:
        fa.reset_launch_counts()
        with attention_mode(name):
            losses[name] = train(device, config, "no", batch=1, steps=steps, loader=make_loader(1, steps))[0]
            model.zero_grad(set_to_none=True)
            model.loss_fn(batch, model).backward()
        grads[name] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        want = expected_launches(layers * (steps + 1), torch.float32 if name == "flash" else None)
        if device.type == "cuda" and dict(fa.LAUNCHES) != want:
            raise RuntimeError(f"T5 f32 {name} attention: flash launches {dict(fa.LAUNCHES)}, expected {want}")
        free_memory(device)
    report = {"layers": [config.num_layers, layers], "losses": losses, "gated_steps": T5_PARITY_STEPS,
              "rtol": TRAIN_F32_RTOL, "grad_rtol": T5_GRAD_RTOL, "rel_diff": {}, "grad_rel_norm_diff": {}}
    for a, b in (("flash", "xla"), ("flash", "f64"), ("xla", "f64")):
        report["rel_diff"][f"{a}_vs_{b}"] = [abs(x - y) / abs(y) for x, y in zip(losses[a], losses[b])]
        diff = {n: float((grads[a][n] - g).norm() / g.norm().clamp_min(1e-30)) for n, g in grads[b].items()}
        worst = max(diff, key=diff.get)
        report["grad_rel_norm_diff"][f"{a}_vs_{b}"] = {"worst": worst, "rel_norm_diff": diff[worst]}
    log(f"[t5] f32 parity: {json.dumps(report)}")
    gated = report["rel_diff"]["flash_vs_xla"][:T5_PARITY_STEPS]
    if not all(np.isfinite(losses["flash"])) or max(gated) > TRAIN_F32_RTOL:
        raise RuntimeError(f"T5 f32 kernel losses {losses['flash']} differ from plain {losses['xla']} (rtol {gated})")
    grad = report["grad_rel_norm_diff"]["flash_vs_xla"]
    if grad["rel_norm_diff"] > T5_GRAD_RTOL:
        raise RuntimeError(f"T5 f32 first-step gradient of {grad['worst']} through the kernels differs from the "
                           f"plain one by {grad['rel_norm_diff']} (relative norm)")
    del model, grads
    return report


def t5_training_phase(device, model_name=T5_MODEL, layers=T5_TRAIN_LAYERS, enc_seq=T5_ENC_SEQ, dec_seq=T5_DEC_SEQ,
                      batch=2, timed_steps=FAMILY_TIMED_STEPS, warmup=FAMILY_WARMUP, profile=False):
    """T5 at `model_name`'s widths cut to `layers` + `layers` layers, through
    `Accelerator.prepare` and `train_step`, on `enc_seq` encoder and
    `dec_seq` decoder tokens with no attention mask: (a) f32, batch 1, the
    kernels' losses and first-step gradients against the plain attention's
    (`t5_f32_parity`), each flash kernel launched once per decoder layer
    and pass (the cross-attention; every self-attention carries the
    relative bias and takes the plain path); (b) bf16 mixed precision, batch x tokens,
    `warmup` + `timed_steps` steps of AdamW with weight decay on one repeated
    batch: step time, tokens/s (encoder and decoder tokens), MFU
    (`t5_step_flops` over 989 TFLOP/s), peak memory; losses finite and
    falling; each bf16 flash kernel launched decoder layers x timed steps
    times. With `profile`, device time by kernel group of one more step."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    config = t5_config(model_name, layers)
    on_card = device.type == "cuda"
    report = {"model": model_name, "layers": [layers, layers], "enc_seq": enc_seq, "dec_seq": dec_seq}

    def make(b, steps):
        return t5_batch_loader(config.vocab_size, b, steps, enc_seq, dec_seq)

    t0 = time.perf_counter()
    report["f32_parity"] = t5_f32_parity(device, config, make)
    free_memory(device)
    log(f"[time] t5 training (a) f32 {time.perf_counter() - t0:.1f}s")

    def before_step(i, step_fn):
        if i == warmup:
            fa.reset_launch_counts()
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    losses, seconds, pmodel, step_fn, last_batch = train(device, config, "bf16", batch=batch, steps=timed_steps,
                                                         warmup=warmup, on_step=before_step,
                                                         loader=make(batch, warmup + timed_steps))
    launches = dict(fa.LAUNCHES)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"{model_name} bf16 training on a repeated batch: losses {losses}")
    if on_card and launches != expected_launches(layers * timed_steps, torch.bfloat16):
        raise RuntimeError(f"{model_name} bf16 timed steps: flash launches {launches}, expected {layers} decoder "
                           f"layers x {timed_steps}")
    step_s = float(np.median(seconds[warmup:]))
    flops = t5_step_flops(pmodel.module, batch, enc_seq, dec_seq)
    bf16 = {
        "batch": batch, "parameters": pmodel.num_parameters, "warmup_steps": warmup, "timed_steps": timed_steps,
        "step_ms_median": 1e3 * step_s, "step_ms": [1e3 * x for x in seconds],
        "tokens_per_s": batch * (enc_seq + dec_seq) / step_s, "decoder_tokens_per_s": batch * dec_seq / step_s,
        "flops_per_step": flops, "mfu": flops / step_s / BF16_PEAK_FLOPS, "launches": launches, "losses": losses,
    }
    if on_card:
        bf16["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    log(f"[t5] train bf16 {layers} + {layers} layers: {json.dumps(bf16)}")
    report["bf16"] = bf16
    if profile:
        report["bf16_profile"] = profile_train_step(step_fn, last_batch, device, step_s)
    del pmodel, step_fn, last_batch
    free_memory(device)
    log(f"[time] t5 training (b) bf16 {time.perf_counter() - t0:.1f}s")
    return report


def t5_full_context_greedy(model, ids, mask, n, device):
    """Greedy tokens by argmax over the uncached teacher-forced forward, the
    decoder context grown a token at a time from the start token 0."""
    ids_t, am = torch.as_tensor(ids, device=device), torch.as_tensor(mask, device=device)
    dec = torch.zeros((ids.shape[0], 1), dtype=torch.long, device=device)
    with torch.no_grad():
        for _ in range(n):
            dec = torch.cat([dec, model(ids_t, dec, am)[:, -1].argmax(-1)[:, None]], dim=1)
    return dec[:, 1:].cpu().numpy()


def t5_generate_phase(device, model_name=T5_MODEL, shape=T5_GENERATE, profile=False):
    """`Seq2SeqGenerator` over T5 at `model_name`'s widths: (a) f32 cut to
    ``parity_layers`` + ``parity_layers`` layers, a batch with one
    right-padded row and its attention mask: the generator's greedy tokens
    equal `t5_full_context_greedy`'s; (b) bf16 at full depth, `batch`
    prompts of `prompt` tokens, the rows in `padded` right-padded to their
    lengths with an attention mask, `new` greedy tokens: the time to the
    first token (encode and the start token's prime: the median of three
    one-token calls), decode tokens/s, the decode step beside its
    weight-read bound (the decoder and the head, bf16, at 3.35 TB/s) and
    peak memory; with `profile`, device time by kernel group and the
    device's busy share over one more call. No K1-K5 kernel launches: every
    attention is masked, biased or one query row long, as in JAX."""
    from accelerate_tpu_torch import Seq2SeqGenerator, create_named_model
    from accelerate_tpu_torch.models import create_t5_model

    report = {"model": model_name}
    rng = np.random.default_rng(2)
    cfg = t5_config(model_name, shape["parity_layers"])
    b, p, n = shape["parity_batch"], shape["parity_prompt"], shape["parity_new"]
    model = create_t5_model(cfg, seed=0, device=device)
    ids = rng.integers(1, cfg.vocab_size, (b, p))
    mask = np.ones((b, p), np.int64)
    mask[-1, p // 2:] = 0
    got = Seq2SeqGenerator(model, max_new_tokens=n, device=device)(ids, max_new_tokens=n, attention_mask=mask)
    got = got.cpu().numpy()
    expect = t5_full_context_greedy(model, ids, mask, n, device)
    if not np.array_equal(got, expect):
        raise RuntimeError(f"f32 Seq2SeqGenerator tokens {got.tolist()} differ from the uncached loop's "
                           f"{expect.tolist()}")
    report["f32_parity"] = {"layers": [cfg.num_layers, cfg.num_decoder_layers], "batch": b, "prompt": p,
                            "new_tokens": n, "tokens_equal_uncached_loop": True}
    log(f"[t5] f32 generate, {cfg.num_layers} + {cfg.num_decoder_layers} layers: tokens equal the uncached "
        f"full-forward loop's ({b} x {n})")
    del model
    free_memory(device)

    t0 = time.perf_counter()
    model = create_named_model(model_name, seed=0, dtype=torch.bfloat16, device=device)
    cfg = model.config
    report.update(layers=[cfg.num_layers, cfg.num_decoder_layers], build_s=time.perf_counter() - t0,
                  parameters=sum(x.numel() for x in model.parameters()))
    log(f"[t5] {model_name} bf16 built in {report['build_s']:.1f}s: {report['parameters']} parameters")
    new = shape["new"]
    gen = Seq2SeqGenerator(model, max_new_tokens=new, device=device)
    gen(rng.integers(1, cfg.vocab_size, (1, 16)), max_new_tokens=4)  # warm-up
    ids = rng.integers(1, cfg.vocab_size, (shape["batch"], shape["prompt"]))
    mask = np.ones_like(ids)
    for row, length in shape["padded"]:
        ids[row, length:], mask[row, length:] = 0, 0
    reset_launch_counts()
    ttft = []
    for _ in range(3):
        t0 = time.perf_counter()
        gen(ids, max_new_tokens=1, attention_mask=mask)
        sync(device)
        ttft.append(time.perf_counter() - t0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def run():
        t = time.perf_counter()
        out = gen(ids, max_new_tokens=new, attention_mask=mask)
        sync(device)
        return time.perf_counter() - t, out

    wall, out = run()
    tokens = out.cpu().numpy()
    if tokens.shape != (ids.shape[0], new) or tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        raise RuntimeError(f"Seq2SeqGenerator returned {tokens.shape} tokens in [{tokens.min()}, {tokens.max()}]")
    ttft_s = float(np.median(ttft))
    step_s = (wall - ttft_s) / (new - 1)
    weights = sum(x.numel() * x.element_size() for m in (model.dec_blocks, model.dec_final_norm, model.lm_head)
                  for x in m.parameters())
    timing = {"batch": int(ids.shape[0]), "prompt_tokens": int(mask.sum()), "padded_rows": shape["padded"],
              "new_tokens": new, "ttft_s": ttft_s, "ttft_runs_s": ttft, "wall_s": wall,
              "decode_tokens_per_s": ids.shape[0] * (new - 1) / max(wall - ttft_s, 1e-9),
              "decode_step_ms": 1e3 * step_s, "step_weight_bytes": weights,
              "step_bound_ms": 1e3 * weights / HBM_BYTES_PER_S}
    if device.type == "cuda":
        timing["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    report["launches"] = launch_counts()
    if any(report["launches"].values()):
        raise RuntimeError(f"a K1-K5 kernel launched on T5's generate path: {report['launches']}")
    if profile:
        timing["profile"] = profile_run(lambda: run()[0], wall)
    report["bf16"] = timing
    log(f"[t5] generate bf16 {model_name}: {json.dumps(timing)}")
    del gen, model, out
    free_memory(device)
    return report


# ------------------------------------------------------------ HF checkpoints
def filesystem(path):
    """`df -T path`'s row for `path`: the device, its type, its size and use."""
    out = subprocess.run(["df", "-T", path], capture_output=True, text=True, timeout=30).stdout.splitlines()
    return out[-1] if out else "unknown"


def hf_phase(device, model_name="llama-1b", t5_name=T5_MODEL, t5_layers=T5_TRAIN_LAYERS, engine_kw=None,
             n_requests=8, system_len=256, mixtral_name=MIXTRAL_MODEL, mixtral_layers=1):
    """HF checkpoint interchange on the card, through a temporary directory
    (removed however the phase ends): `model_name` in bf16 at full width and
    depth (random weights from seed 0) written with `save_hf_checkpoint`
    and loaded with `load_hf_checkpoint_in_model` into a model built from
    seed 1, which then holds the same tensors bit for bit, in bf16 on the
    card; the first `n_requests` of the paged engine's mix (phase 3
    serves all 16: the weights are already equal), plain (K1) and speculative
    (K2), gives the loaded model the original's tokens, with each kernel's
    launches layers x dispatches. Reports the file's bytes, the save and
    load seconds and the directory's filesystem. Then T5 at `t5_name`'s
    widths cut to `t5_layers` + `t5_layers` layers, bf16, round trips with
    bit-equal logits; then `mixtral_name` cut to `mixtral_layers` layers,
    bf16, round trips with equal greedy tokens (Mixtral (e))."""
    import shutil
    import tempfile

    from accelerate_tpu_torch import GenerationConfig, Generator, create_named_model
    from accelerate_tpu_torch.models import create_mixtral_model, create_t5_model
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.utils.hf_loading import load_hf_checkpoint_in_model, save_hf_checkpoint

    engine_kw = {**ENGINE_KW, **(engine_kw or {})}
    directory = tempfile.mkdtemp(prefix="hf_checkpoint_")
    report = {"model": model_name, "filesystem": filesystem(directory)}
    try:
        def round_trip(original, fresh, model_type, name):
            path = os.path.join(directory, f"{name}.safetensors")
            sync(device)
            t0 = time.perf_counter()
            save_hf_checkpoint(original, model_type, original.config, path)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            load_hf_checkpoint_in_model(fresh, path, model_type)
            sync(device)
            load_s = time.perf_counter() - t0
            want = original.state_dict()
            for key, t in fresh.state_dict().items():
                if t.dtype != torch.bfloat16 or t.device != want[key].device or not torch.equal(t, want[key]):
                    raise RuntimeError(f"{name}: {key} did not load as saved ({t.dtype}, {t.device})")
            out = {"file_bytes": os.path.getsize(path), "save_s": save_s, "load_s": load_s,
                   "tensors": len(want)}
            os.remove(path)
            return out

        original = create_named_model(model_name, seed=0, dtype=torch.bfloat16, device=device)
        fresh = create_named_model(model_name, seed=1, dtype=torch.bfloat16, device=device)
        report["llama"] = round_trip(original, fresh, "llama", model_name)
        log(f"[hf] {model_name} bf16 round trip in {report['filesystem']!r}: {json.dumps(report['llama'])}")
        layers = original.config.num_hidden_layers
        requests = make_requests(original.config.vocab_size, n=n_requests, system_len=system_len)
        for label, extra, kind in (("plain", {}, "decode"), ("speculative", SPEC_KW, "verify")):
            tokens = {}
            for which, model in (("original", original), ("loaded", fresh)):
                pa.reset_launch_counts()
                engine, tokens[which], timing = serve(model, requests, device, **engine_kw, **extra)
                launches, dispatches = dict(pa.LAUNCHES), engine.stats["decode_steps"]
                engine = None
                gc.collect()
                if device.type == "cuda" and (launches[kind] != layers * dispatches or launches[kind] <= 0):
                    raise RuntimeError(f"hf {label} {which}: launches {launches}, expected {kind} = {layers} "
                                       f"layers x {dispatches} dispatches")
                report[f"{label}_{which}"] = dict(timing, launches=launches, dispatches=dispatches)
            if tokens["original"] != tokens["loaded"]:
                bad = [rid for rid in tokens["original"] if tokens["original"][rid] != tokens["loaded"][rid]]
                raise RuntimeError(f"hf {label}: the loaded model's tokens differ for requests {bad}")
            report[f"{label}_tokens_equal"] = len(requests)
            log(f"[hf] {label} engine: the loaded model's tokens equal the original's for all {len(requests)} "
                f"requests; launches {report[f'{label}_loaded']['launches']}")
        del original, fresh
        free_memory(device)

        cfg = t5_config(t5_name, t5_layers)
        original = create_t5_model(cfg, seed=0, dtype=torch.bfloat16, device=device)
        fresh = create_t5_model(cfg, seed=1, dtype=torch.bfloat16, device=device)
        report["t5"] = round_trip(original, fresh, "t5", t5_name)
        rng = np.random.default_rng(4)
        ids = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 64)), device=device)
        dec = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 32)), device=device)
        with torch.no_grad():
            if not torch.equal(original(ids, dec), fresh(ids, dec)):
                raise RuntimeError("T5 logits differ after the HF round trip")
        report["t5"].update(layers=[t5_layers, t5_layers], logits_bit_equal=True)
        log(f"[hf] {t5_name} {t5_layers} + {t5_layers} layers bf16 round trip, logits bit-equal: "
            f"{json.dumps(report['t5'])}")
        del original, fresh
        free_memory(device)

        # (e) of the Mixtral slice: the experts' [E, in, out] weights split
        # into HF's per-expert w1/w3/w2 and stacked back.
        cfg = mixtral_config(mixtral_name, num_hidden_layers=mixtral_layers)
        original = create_mixtral_model(cfg, seed=0, dtype=torch.bfloat16, device=device)
        fresh = create_mixtral_model(cfg, seed=1, dtype=torch.bfloat16, device=device)
        report["mixtral"] = round_trip(original, fresh, "mixtral", mixtral_name)
        ids = np.random.default_rng(5).integers(1, cfg.vocab_size, (2, 64))
        tokens = [Generator(m, max_length=128, device=device)(ids, GenerationConfig(max_new_tokens=16)).cpu().numpy()
                  for m in (original, fresh)]
        if not np.array_equal(*tokens):
            raise RuntimeError("Mixtral's greedy tokens differ after the HF round trip")
        report["mixtral"].update(layers=mixtral_layers, greedy_tokens_equal=True, new_tokens=16)
        log(f"[hf] {mixtral_name} {mixtral_layers} layers bf16 round trip, greedy tokens equal: "
            f"{json.dumps(report['mixtral'])}")
        del original, fresh
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    free_memory(device)
    return report


# ------------------------------------------------------------ head dim 16
def t5_head_dim_16_case(device, model_name="t5-tiny", seq=T5_TINY_SEQ):
    """The repaired fault on a model: `model_name` (d_kv 16) forward and
    backward on `seq` encoder and `seq` decoder tokens, unmasked, through
    its loss. In f32 once through the kernels and once with
    ACCELERATE_TPU_ATTENTION_IMPL=xla: on the card the cross-attention
    takes the flash gate (non-causal, scale 1.0) and launches K3-K5 once per
    decoder layer, the plain run none, and the losses agree within
    F32_ATOL + TRAIN_F32_RTOL |plain|. Then the same in bf16 and in fp16
    (the weights cast): finite losses, and the launches the `_d16` rows
    carry."""
    from accelerate_tpu_torch import create_named_model
    from accelerate_tpu_torch.models.t5 import seq2seq_lm_loss
    from accelerate_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(16)
    report = {"model": model_name, "enc_seq": seq, "dec_seq": seq}
    model = None

    def run(dtype):
        nonlocal model
        model = create_named_model(model_name, seed=2, dtype=dtype, device=device)
        vocab = model.config.vocab_size
        batch = {key: torch.as_tensor(rng.integers(1, vocab, (1, seq)), device=device)
                 for key in ("input_ids", "decoder_input_ids", "labels")}
        fa.reset_launch_counts()
        loss = seq2seq_lm_loss(batch, model)
        loss.backward()
        sync(device)
        return float(loss.detach()), dict(fa.LAUNCHES)

    layers = None
    for impl in ("flash", "xla"):
        rng = np.random.default_rng(16)  # the same batch for both runs
        if impl == "xla":
            os.environ["ACCELERATE_TPU_ATTENTION_IMPL"] = "xla"
        try:
            loss, launches = run(torch.float32)
        finally:
            os.environ.pop("ACCELERATE_TPU_ATTENTION_IMPL", None)
        layers = model.config.num_decoder_layers
        report["head_dim"] = model.config.d_kv
        report[f"f32_{impl}"] = {"loss": loss, "launches": launches}
        want = expected_launches(layers if impl == "flash" else 0, torch.float32 if impl == "flash" else None)
        if device.type == "cuda" and launches != want:
            raise RuntimeError(f"{model_name} f32 {impl}: flash launches {launches}, expected {want}")
    flash, plain = report["f32_flash"]["loss"], report["f32_xla"]["loss"]
    limit = F32_ATOL + TRAIN_F32_RTOL * abs(plain)
    if not np.isfinite(flash) or abs(flash - plain) > limit:
        raise RuntimeError(f"{model_name} f32 loss through the kernels {flash} differs from the plain {plain}")
    report.update(f32_abs_diff=abs(flash - plain), f32_limit=limit)
    for dtype in (torch.bfloat16, torch.float16):
        rng = np.random.default_rng(16)
        loss, launches = run(dtype)
        key = str(dtype).replace("torch.", "")
        if not np.isfinite(loss):
            raise RuntimeError(f"{model_name} {key} loss is not finite: {loss}")
        if device.type == "cuda" and launches != expected_launches(layers, dtype):
            raise RuntimeError(f"{model_name} {key}: flash launches {launches}, expected {layers} of each")
        report[key] = {"loss": loss, "launches": launches}
    log(f"[d16] {model_name} forward and backward at {seq} + {seq} tokens: {json.dumps(report)}")
    model = None
    free_memory(device)
    return report


def head_dim_16_phase(device, shape=D16_FLASH_SHAPE, model_name="t5-tiny", seq=T5_TINY_SEQ, timed=True):
    """(a) of the Mixtral slice, the repair first: K3-K5 at head dim 16
    against their plain versions in f32, bf16 and fp16, causal and
    non-causal (scale 1.0, T5's), timed; then `t5_head_dim_16_case`."""
    report = {}
    log(f"[flash] head dim 16, causal: {json.dumps(shape)}")
    report["causal"] = flash_kernel_phase(device, shape, timed=timed)
    log(f"[flash] head dim 16, non-causal, scale 1.0: {json.dumps(shape)}")
    report["non_causal"] = flash_kernel_phase(device, shape, timed=timed, causal=False, scale=1.0)
    report["t5"] = t5_head_dim_16_case(device, model_name, seq)
    return report


# ------------------------------------------------------------------ Mixtral
def mixtral_config(model_name=MIXTRAL_MODEL, **changes):
    import dataclasses

    from accelerate_tpu_torch.models import MODEL_REGISTRY

    return dataclasses.replace(MODEL_REGISTRY[model_name](), **changes)


def router_drops(model, call):
    """Run `call()` with a forward hook on every layer's router that routes
    the router's logits again (`top_k_routing` at the forward's capacity)
    and counts what the capacity dropped. Returns per forward (the prefill,
    then each decode step) the tokens it routed, the token-choices dropped
    summed over the layers, and the tokens that lost every choice; the
    counts stay on the device until `call()` returns."""
    from accelerate_tpu_torch.parallel.expert import expert_capacity, top_k_routing

    forwards, handles = [], []
    for i, layer in enumerate(model.layers):
        def hook(router, args, logits, moe=layer.moe, first=i == 0):
            tokens = logits.shape[0]
            capacity = expert_capacity(tokens, moe.num_experts, moe.top_k, moe.capacity_factor)
            kept = top_k_routing(logits, moe.top_k, capacity)[0].sum(dim=(1, 2))  # choices kept per token
            if first:
                forwards.append({"tokens": tokens, "capacity": capacity, "counts": []})
            forwards[-1]["counts"].append(torch.stack([tokens * moe.top_k - kept.sum(), (kept == 0).sum()]))

        handles.append(layer.moe.router.register_forward_hook(hook))
    try:
        call()
    finally:
        for handle in handles:
            handle.remove()
    out = []
    for f in forwards:
        counts = torch.stack(f.pop("counts")).sum(dim=0).tolist()
        out.append(dict(f, dropped_choices=int(counts[0]), dropped_tokens=int(counts[1])))
    return out


def mixtral_generate_phase(device, model_name=MIXTRAL_MODEL, shape=MIXTRAL_GENERATE, profile=True):
    """(c) `generate` of `model_name` at full width:
    - f32 cut to `parity_layers` layers at the dropless capacity factor
      E / top_k: the cached greedy tokens of `Generator` equal the
      full-context greedy loop's (no cache) for `parity_new` tokens;
    - bf16 cut to `layers` layers (random weights from seed 0), the
      `Generator` over a `max_length` cache: batch 1 on a `prompt`-token
      prompt and a left-padded batch of `batch` (`ragged` tokens), `new`
      new tokens each (`timed_generate`: TTFT, decode tokens/s, peak
      memory); no K1-K5 launch over them;
    - the router's drops on the left-padded batch, at the prefill and at
      each decode step (`router_drops`);
    - on the card, the device's busy share of a batch-1 call of
      `profile_new` tokens (`profile_run`)."""
    from accelerate_tpu_torch import GenerationConfig, Generator
    from accelerate_tpu_torch.models import create_mixtral_model

    report = {"model": model_name, "shape": shape}
    t0 = time.perf_counter()
    base = mixtral_config(model_name)
    cfg = mixtral_config(model_name, num_hidden_layers=shape["parity_layers"],
                         capacity_factor=base.num_local_experts / base.num_experts_per_tok)
    model = create_mixtral_model(cfg, seed=0, device=device)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (shape["parity_batch"], shape["parity_prompt"]))
    n = shape["parity_new"]
    cached = Generator(model, max_length=shape["max_length"], device=device)(
        ids, GenerationConfig(max_new_tokens=n)).cpu().numpy()
    full = torch.as_tensor(ids, device=device)
    with torch.no_grad():
        for _ in range(n):
            full = torch.cat([full, model(full)[:, -1].argmax(-1)[:, None]], dim=1)
    if not np.array_equal(cached, full.cpu().numpy()):
        raise RuntimeError(f"{model_name} f32 dropless: cached greedy tokens differ from the full-context loop's")
    report["f32_dropless"] = {"layers": cfg.num_hidden_layers, "capacity_factor": cfg.capacity_factor,
                              "batch": int(ids.shape[0]), "prompt": int(ids.shape[1]), "new_tokens": n,
                              "cached_equals_full_context": True}
    log(f"[mixtral] f32 {cfg.num_hidden_layers} layers, capacity {cfg.capacity_factor}: cached greedy tokens "
        f"equal the full-context loop's ({n} new tokens, batch {ids.shape[0]})")
    del model
    free_memory(device)
    log(f"[time] mixtral generate (c) f32 {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    cfg = mixtral_config(model_name, num_hidden_layers=shape["layers"])
    model = create_mixtral_model(cfg, seed=0, dtype=torch.bfloat16, device=device)
    log_model(f"[mixtral] {model_name} bf16", model, t0)
    report.update(layers=cfg.num_hidden_layers, parameters=sum(p.numel() for p in model.parameters()),
                  weight_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
                  build_s=time.perf_counter() - t0)
    gen = Generator(model, max_length=shape["max_length"], device=device)
    gen(rng.integers(0, cfg.vocab_size, (1, 8)), GenerationConfig(max_new_tokens=4))  # warm-up
    reset_launch_counts()
    prompt = rng.integers(0, cfg.vocab_size, (shape["prompt"],))
    _, report["bf16_batch1"] = timed_generate(gen, prompt[None], device, max_new_tokens=shape["new"])
    log(f"[mixtral] generate bf16 batch 1: {json.dumps(report['bf16_batch1'])}")
    lo, hi = shape["ragged"]
    lengths = np.linspace(lo, hi, shape["batch"]).astype(int)
    rids, mask = left_pad([rng.integers(0, cfg.vocab_size, (int(k),)) for k in lengths])
    _, report["bf16_batch_ragged"] = timed_generate(gen, rids, device, mask, max_new_tokens=shape["new"])
    log(f"[mixtral] generate bf16 batch {shape['batch']} left-padded: {json.dumps(report['bf16_batch_ragged'])}")
    report["launches"] = launch_counts()
    if any(report["launches"].values()):
        raise RuntimeError(f"a K1-K5 kernel launched on {model_name}'s generate path: {report['launches']}")
    forwards = router_drops(model, lambda: gen(rids, GenerationConfig(max_new_tokens=shape["new"]),
                                               attention_mask=mask))
    steps = forwards[1:]
    report["router_drops"] = {
        "prefill": forwards[0],
        "decode_tokens_per_step": steps[0]["tokens"] if steps else 0,
        "decode_capacity": steps[0]["capacity"] if steps else 0,
        "decode_steps": len(steps),
        "decode_dropped_choices_per_step": [f["dropped_choices"] for f in steps],
        "decode_dropped_tokens_per_step": [f["dropped_tokens"] for f in steps],
        "choices_per_forward": cfg.num_hidden_layers * cfg.num_experts_per_tok,
    }
    log(f"[mixtral] router drops, batch {shape['batch']} left-padded, summed over {cfg.num_hidden_layers} layers: "
        f"{json.dumps(report['router_drops'])}")
    if profile and device.type == "cuda":
        def run():
            t = time.perf_counter()
            gen(prompt[None], GenerationConfig(max_new_tokens=shape["profile_new"]))
            sync(device)
            return time.perf_counter() - t

        report["bf16_batch1_profile"] = profile_run(run, run())
        report["bf16_batch1_profile"]["new_tokens"] = shape["profile_new"]
        log(f"[mixtral] generate bf16 batch 1 profile: {json.dumps(report['bf16_batch1_profile'])}")
    del gen, model
    free_memory(device)
    log(f"[time] mixtral generate (c) bf16 {time.perf_counter() - t0:.1f}s")
    return report


def mixtral_step_flops(config, batch, seq):
    """The work of one training step of a Mixtral `config` on `batch` x
    `seq` tokens, as done: 3 x the forward's, and the forward per layer the
    q, k, v and o projections (2 T H (2 Hq D + 2 Hkv D)), the causal
    attention (2 products of 2 B Hq D over S (S + 1) / 2 pairs), the router
    (2 T H E), the three expert GEMMs over all E x C capacity slots
    (6 E C H F), the dispatch and combine einsums (2 x 2 T E C H), and the
    head once (2 T H V); T = B S, C the expert capacity at T."""
    from accelerate_tpu_torch.parallel.expert import expert_capacity

    t, h, f = batch * seq, config.hidden_size, config.intermediate_size
    e, k, v = config.num_local_experts, config.num_experts_per_tok, config.vocab_size
    hq, hkv, d = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    c = expert_capacity(t, e, k, config.capacity_factor)
    layer = (2 * t * h * (2 * hq * d + 2 * hkv * d) + 2 * 2 * batch * hq * d * seq * (seq + 1) / 2
             + 2 * t * h * e + 6 * e * c * h * f + 4 * t * e * c * h)
    return 3 * (config.num_hidden_layers * layer + 2 * t * h * v)


MIXTRAL_FLOPS_FORMULA = ("3 x forward; forward = layers x (2 T H (2 Hq D + 2 Hkv D) + 4 B Hq D S (S + 1) / 2 "
                         "+ 2 T H E + 6 E C H F + 4 T E C H) + 2 T H V, T = B S, C = the expert capacity at T; "
                         "MFU = that / step time / 989 TFLOP/s (the combine einsum runs in f32)")


def mixtral_training_phase(device, model_name=MIXTRAL_MODEL, layers=MIXTRAL_TRAIN_LAYERS, shape=MIXTRAL_TRAIN,
                           narrow=MIXTRAL_NARROW, profile=False):
    """(d) Training of `model_name` at full width cut to `layers` layers,
    through `Accelerator.prepare` and the fused `train_step`, its loss the
    bundled `make_moe_causal_lm_loss` (ce + 0.02 load balance + 0.001 z):
    - f32 at the `narrow` widths (head dim 128 kept), 2 layers, batch 1,
      the flash kernels' losses against the plain attention's
      (`f32_flash_parity`);
    - bf16 mixed precision, batch x seq tokens, warm-up and timed steps on
      one repeated batch: step time, tokens/s, MFU counted as the work done
      (`mixtral_step_flops`), peak memory, each step's ce and router losses
      (finite), the losses falling; each flash kernel launched layers x
      timed steps times;
    - fp16 steps with loss scaling, counting the fp16 kernels' launches.
    With `profile`, device time by kernel group of one more bf16 step."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    config = mixtral_config(model_name, num_hidden_layers=layers)
    on_card = device.type == "cuda"
    batch, seq, warmup, timed_steps = shape["batch"], shape["seq"], shape["warmup"], shape["timed_steps"]
    report = {"model": model_name, "layers": layers, "head_dim": config.head_dim, "seq": seq}
    t0 = time.perf_counter()
    report["f32_parity"] = f32_flash_parity(device, mixtral_config(model_name, num_hidden_layers=2, **narrow), seq,
                                            steps=shape["parity_steps"])
    report["f32_parity"]["widths"] = narrow
    free_memory(device)
    log(f"[time] mixtral training (d) f32 {time.perf_counter() - t0:.1f}s")

    def before_step(i, step_fn):
        if i == warmup:
            fa.reset_launch_counts()
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    aux = []
    losses, seconds, pmodel, step_fn, last_batch = train(device, config, "bf16", batch=batch, steps=timed_steps,
                                                         seq=seq, warmup=warmup, on_step=before_step, aux_out=aux)
    launches = dict(fa.LAUNCHES)
    finite = all(np.isfinite(losses)) and all(np.isfinite(list(a.values())).all() for a in aux)
    if not finite or not losses[-1] < losses[0]:
        raise RuntimeError(f"{model_name} bf16 training on a repeated batch: losses {losses}, aux {aux}")
    if on_card and launches != expected_launches(layers * timed_steps, torch.bfloat16):
        raise RuntimeError(f"{model_name} bf16 timed steps: flash launches {launches}, expected {layers} x "
                           f"{timed_steps}")
    bf16 = step_report(batch, seq, seconds, warmup, pmodel.num_parameters, config, launches)
    flops = mixtral_step_flops(config, batch, seq)
    bf16.update(losses=losses, aux=aux, flops_per_step=flops, mfu=flops / (bf16["step_ms_median"] / 1e3) /
                BF16_PEAK_FLOPS, mfu_formula=MIXTRAL_FLOPS_FORMULA)
    if on_card:
        bf16["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    log(f"[mixtral] train bf16 {layers} layers: {json.dumps(bf16)}")
    report["bf16"] = bf16
    if profile:
        report["bf16_profile"] = profile_train_step(step_fn, last_batch, device, bf16["step_ms_median"] / 1e3)
    del pmodel, step_fn, last_batch
    free_memory(device)
    log(f"[time] mixtral training (d) bf16 {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    fa.reset_launch_counts()
    steps = shape["fp16_steps"]
    losses, seconds, pmodel, step_fn, _ = train(device, config, "fp16", batch=batch, steps=steps, seq=seq)
    launches = dict(fa.LAUNCHES)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{model_name} fp16 training losses are not finite: {losses}")
    if on_card and launches != expected_launches(layers * steps, torch.float16):
        raise RuntimeError(f"{model_name} fp16 steps: flash launches {launches}, expected {layers} x {steps}")
    report["fp16"] = {"steps": steps, "losses": losses, "step_ms": [1e3 * x for x in seconds], "launches": launches}
    log(f"[mixtral] train fp16 {layers} layers: {json.dumps(report['fp16'])}")
    del pmodel, step_fn
    free_memory(device)
    log(f"[time] mixtral training (d) fp16 {time.perf_counter() - t0:.1f}s")
    return report


# ------------------------------------------------------------ fp8 and ResNet
# fp8 (phase 11). The H100 SXM's dense fp8 tensor-core rate (NVIDIA's
# figure; 3958 TFLOP/s with sparsity), the fp8 products' bound.
FP8_PEAK_FLOPS = 1979e12
# An fp8 product against its plain version on the same fp8 operands and
# scales: one bf16 rounding of each output (two roundings of nearby values
# differ by at most a relative 2^-7), plus the order of the sum: the
# products of fp8 values are exact, and Hopper's fp8 MMA adds them with
# about 14 bits inside the tensor core before cuBLAS promotes each partial
# sum to f32 (fast accumulation off, `_scaled_mm`'s default), so the sum may
# move by 2^-12 of the sum of the products' magnitudes (the plain version's
# f32 order, 2^-24 a term, is far inside that).
FP8_RTOL = 2.0 ** -7
FP8_ACC = 2.0 ** -12
# CUDA-event timed calls of each product in phase 11 (a) (the plain version
# of the lm_head product, an f32 GEMM, takes about 35 ms).
FP8_TIMED = 20
# Phase 11 (c): fp8 under remat at Llama-1B's widths cut to this depth.
FP8_REMAT_LAYERS = 2
# Phase 11 (d): ResNet-50, bf16, one repeated batch of 64 images of 224 x 224.
RESNET = dict(batch=64, size=224, warmup=2, timed_steps=8, lr=1e-3, weight_decay=1e-4)


def llama_linear_shapes(config):
    """{name: (in, out)} of one Llama layer's linear layers, and the head's."""
    h, d = config.hidden_size, config.head_dim
    return {"wq": (h, config.num_attention_heads * d), "wk": (h, config.num_key_value_heads * d),
            "wv": (h, config.num_key_value_heads * d), "wo": (config.num_attention_heads * d, h),
            "w_gate": (h, config.intermediate_size), "w_up": (h, config.intermediate_size),
            "w_down": (config.intermediate_size, h), "lm_head": (h, config.vocab_size)}


def fp8_plain(a, sa, b, sb):
    """The plain version of an fp8 product: ``(a @ b) * (sa * sb)`` in f32,
    rounded to bf16."""
    return ((a.float() @ b.float()) * (sa * sb)).to(torch.bfloat16)


def fp8_product_case(device, tokens, n_in, n_out, seed=0, timed=True):
    """One linear layer at `tokens` x `n_in` -> `n_out` in HYBRID through the
    port's autograd path (`ops.fp8.fp8_matmul(x, weight.T)` forward, then
    its backward on a bf16 gradient), each product held to its plain
    version on the same fp8 operands and scales. With `timed`: each
    product's `_scaled_mm` on operands already laid out, the plain version
    and a bf16 `torch.matmul` of the same shape, the fp8 bound, and the
    quantize passes (amax, scale, cast of x, w and g) and the transposed fp8
    copies `_scaled_mm`'s column-major second operand needs."""
    from accelerate_tpu_torch.ops import fp8 as pfp8

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn(tokens, n_in, generator=gen, device=device).to(torch.bfloat16)
    weight = (torch.randn(n_out, n_in, generator=gen, device=device) * n_in ** -0.5).to(torch.bfloat16)
    g = (torch.randn(tokens, n_out, generator=gen, device=device) * 1e-3).to(torch.bfloat16)
    xs, ws = x.clone().requires_grad_(), weight.clone().requires_grad_()
    out = pfp8.fp8_matmul(xs, ws.T)
    out.backward(g)
    got = {"fwd": out.detach(), "dx": xs.grad, "dw": ws.grad}
    xq, sx = pfp8.quantize_fp8(x)
    wq, sw = pfp8.quantize_fp8(weight.T)  # [in, out], column-major
    gq, sg = pfp8.quantize_fp8(g, pfp8.E5M2)
    operands = {"fwd": (xq, sx, wq, sw), "dx": (gq, sg, wq.T, sw), "dw": (gq.T, sg, xq, sx)}
    bf16 = {"fwd": (x, weight.T), "dx": (g, weight), "dw": (g.T, x)}
    report = {"shape": {"tokens": tokens, "in": n_in, "out": n_out}}
    for role, (a, sa, b, sb) in operands.items():
        ref = fp8_plain(a, sa, b, sb)
        acc = (a.float().abs() @ b.float().abs()) * (sa * sb)  # the products' magnitudes, summed
        entry = {"dtypes": [str(a.dtype), str(b.dtype)], "max_abs_err": float((got[role].float() - ref.float()).abs().max()),
                 "limit": limit_report(got[role], ref, 0.0, FP8_RTOL, FP8_ACC * acc),
                 "limit_without_accumulation": limit_report(got[role], ref, 0.0, FP8_RTOL)}
        del ref, acc
        m, k, n = a.shape[0], a.shape[1], b.shape[1]
        entry["bound_ms"] = 1e3 * max(2 * m * k * n / FP8_PEAK_FLOPS, (m * k + k * n + 2 * m * n) / HBM_BYTES_PER_S)
        entry["bound_by"] = "operations" if 2 * m * k * n / FP8_PEAK_FLOPS > (m * k + k * n + 2 * m * n) / HBM_BYTES_PER_S else "bytes"
        if timed:
            a_laid, b_laid = a.contiguous(), b.t().contiguous().t()
            entry["ms"] = time_ms(lambda: torch._scaled_mm(a_laid, b_laid, scale_a=sa, scale_b=sb,
                                                           out_dtype=torch.bfloat16), device, iters=FP8_TIMED)
            entry["bf16_matmul_ms"] = time_ms(lambda: torch.matmul(*bf16[role]), device, iters=FP8_TIMED)
            entry["plain_ms"] = time_ms(lambda: fp8_plain(a, sa, b, sb), device, iters=FP8_TIMED, warmup=1)
            entry["bf16_bound_ms"] = 1e3 * max(2 * m * k * n / BF16_PEAK_FLOPS, 2 * (m * k + k * n + m * n) / HBM_BYTES_PER_S)
            del a_laid, b_laid
        report[role] = entry
        broken = entry["limit"]["broken"]
        if broken:
            raise RuntimeError(f"fp8 {role} product at {report['shape']}: {broken} elements past the limit "
                               f"({json.dumps(entry['limit'])})")
    if timed:
        report["quantize_ms"] = {
            name: time_ms(lambda t=t, f=f: pfp8.quantize_fp8(t, f), device, iters=FP8_TIMED)
            for name, t, f in (("x", x, pfp8.E4M3), ("w", weight.T, pfp8.E4M3), ("g", g, pfp8.E5M2))}
        # The backward's copies: w (column-major after its quantize) row-major
        # for dx's second operand, g transposed for dw's first and x for its second.
        report["layout_ms"] = {
            name: time_ms(lambda t=t: t.contiguous(), device, iters=FP8_TIMED)
            for name, t in (("w", wq), ("g_t", gq.t()), ("x_t", xq.t()))}
    return report


def fp8_products_phase(device, model_name="llama-1b", tokens=2 * TRAIN_SEQ, timed=True):
    """11 (a): the fp8 products of each of `model_name`'s linear shapes at
    `tokens` tokens, forward, dx and dw (`fp8_product_case`), and the time
    of one step's products and quantize passes summed over its layers."""
    from accelerate_tpu_torch.models import MODEL_REGISTRY
    from accelerate_tpu_torch.ops import fp8 as pfp8

    config = MODEL_REGISTRY[model_name]()
    shapes = llama_linear_shapes(config)
    report = {}
    for i, (name, (n_in, n_out)) in enumerate(shapes.items()):
        report[name] = fp8_product_case(device, tokens, n_in, n_out, seed=i, timed=timed)
        log(f"[fp8] {name}: {json.dumps(report[name])}")
        free_memory(device)
    pfp8.reset_product_counts()
    if timed:
        per_step = {"fp8_products_ms": 0.0, "bf16_matmuls_ms": 0.0, "quantize_ms": 0.0, "layout_ms": 0.0}
        for name, case in report.items():
            n = 1 if name == "lm_head" else config.num_hidden_layers
            per_step["fp8_products_ms"] += n * sum(case[r]["ms"] for r in ("fwd", "dx", "dw"))
            per_step["bf16_matmuls_ms"] += n * sum(case[r]["bf16_matmul_ms"] for r in ("fwd", "dx", "dw"))
            per_step["quantize_ms"] += n * sum(case["quantize_ms"].values())
            per_step["layout_ms"] += n * sum(case["layout_ms"].values())
        report["per_step"] = per_step
        log(f"[fp8] one {model_name} step's products, summed over its layers: {json.dumps(per_step)}")
    return report


def fp8_training_phase(device, model_name="llama-1b", seq=TRAIN_SEQ, timed_steps=8, warmup=2, batch=2, bf16=None,
                       profile=False):
    """11 (b): `model_name` at full width and depth trained in fp8 through
    `train_step` (AdamW as in 5 (b), one repeated batch), beside `bf16`, the
    bf16 run of 5 (b) on the same batch and seed (run here when None). Gates:
    finite losses, the last below the first; each bf16 flash kernel launched
    layers x timed steps times and no other; every linear layer's product in
    fp8: per step, (7 a layer + the head) forward products, as many dx and
    dw. Reports step time, tokens/s, MFU (over 989 TFLOP/s, and the same work
    over the fp8 peak), peak memory and the losses beside bf16's; with
    `profile`, one more step's device time by part."""
    from accelerate_tpu_torch.models import MODEL_REGISTRY
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fp8 as pfp8

    config = MODEL_REGISTRY[model_name]()
    on_card = device.type == "cuda"
    layers = config.num_hidden_layers
    runs = {}
    for mode in ("bf16", "fp8") if bf16 is None else ("fp8",):
        def before_step(i, step_fn):
            if i == warmup:
                fa.reset_launch_counts()
                pfp8.reset_product_counts()
                if on_card:
                    torch.cuda.reset_peak_memory_stats(device)

        losses, seconds, pmodel, step_fn, last_batch = train(device, config, mode, batch=batch, steps=timed_steps,
                                                             seq=seq, warmup=warmup, on_step=before_step)
        launches, products = dict(fa.LAUNCHES), dict(pfp8.PRODUCTS)
        run = step_report(batch, seq, seconds, warmup, pmodel.num_parameters, config, launches)
        run.update(losses=losses, fp8_products=products)
        if on_card:
            run["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
        log(f"[fp8] {mode} {model_name}: {json.dumps(run)}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"{mode} training on a repeated batch: losses {losses} (finite, falling)")
        if on_card and launches != expected_launches(layers * timed_steps, torch.bfloat16):
            raise RuntimeError(f"{mode} timed steps: flash launches {launches}, expected {layers} x {timed_steps}")
        if profile and mode == "fp8":
            run["profile"] = profile_fp8_step(step_fn, last_batch, device, run["step_ms_median"] / 1e3)
        runs[mode] = run
        del pmodel, step_fn, last_batch
        free_memory(device)
    fp8, bf16 = runs["fp8"], bf16 if bf16 is not None else runs["bf16"]
    per_step = (7 * layers + 1) * timed_steps
    if fp8["fp8_products"] != {"fwd": per_step, "dx": per_step, "dw": per_step}:
        raise RuntimeError(f"fp8 timed steps ran {fp8['fp8_products']} fp8 products, expected {per_step} each "
                           f"(7 x {layers} layers + the head, x {timed_steps} steps)")
    fp8["mfu_over_fp8_peak"] = fp8["mfu"] * BF16_PEAK_FLOPS / FP8_PEAK_FLOPS
    fp8["bf16"] = {key: bf16[key] for key in ("step_ms_median", "tokens_per_s", "mfu", "losses", "peak_memory_bytes")
                   if key in bf16}
    fp8["step_time_over_bf16"] = fp8["step_ms_median"] / bf16["step_ms_median"]
    fp8["max_abs_loss_diff_from_bf16"] = max(abs(a - b) for a, b in zip(fp8["losses"], bf16["losses"]))
    return fp8


def profile_fp8_step(step_fn, batch, device, unprofiled_step_s):
    """Device time of one more fp8 step under `torch.profiler`, by part:
    `_scaled_mm`, the quantize passes (``fp8_quantize``: amax, scale, cast),
    the operand copies for `_scaled_mm`'s layout (``fp8_layout``), AdamW
    (`Optimizer.step#AdamW.step`), K3-K5, and the rest; each part is the
    device time of the kernels launched inside its op or range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        float(step_fn(batch))
    rows = prof.key_averages()
    kernels = [(row.self_device_time_total, row.key) for row in rows
               if row.device_type == DeviceType.CUDA and row.self_device_time_total > 0
               and not getattr(row, "is_user_annotation", False)]
    total_us = sum(us for us, _ in kernels)
    if total_us <= 0:
        raise RuntimeError("the profiler recorded no device time")

    def inside(match):
        """Device time (us) of the kernels launched inside the host ops or ranges `match` picks."""
        return sum(row.device_time_total for row in rows if row.device_type == DeviceType.CPU and match(row.key))

    parts = {
        "scaled_mm": inside(lambda key: key == "aten::_scaled_mm"),
        "fp8_quantize": inside(lambda key: key == "fp8_quantize"),
        "fp8_layout": inside(lambda key: key == "fp8_layout"),
        "adamw": inside(lambda key: key.startswith("Optimizer.step#AdamW")),
        "flash_attention": sum(us for us, key in kernels if "flash_" in key.lower() and "kernel" in key.lower()),
    }
    parts["rest"] = total_us - sum(parts.values())
    kernels.sort(reverse=True)
    out = {
        "device_busy_ms": total_us / 1e3,
        "busy_share_of_unprofiled_step": total_us / 1e6 / unprofiled_step_s,
        "ms": {k: v / 1e3 for k, v in parts.items()},
        "share": {k: v / total_us for k, v in parts.items()},
        "top_kernels": [{"name": name[:140], "ms": us / 1e3, "share": us / total_us} for us, name in kernels[:15]],
    }
    log(f"[fp8] profile: {json.dumps(out)}")
    return out


def fp8_remat_phase(device, model_name="llama-1b", layers=FP8_REMAT_LAYERS, seq=TRAIN_SEQ, steps=3):
    """11 (c): fp8 (f32 masters, bf16 copies) at full width cut to `layers`
    layers, batch 1, `steps` steps, without remat and under
    `remat_policy="full"`: equal losses (rtol 1e-6). The recompute runs in
    the backward, on the autograd engine's device thread, under the recipe
    the forward captured: K3 and every forward product launched twice per
    layer step, K4, K5, dx and dw once."""
    import dataclasses

    from accelerate_tpu_torch.models import MODEL_REGISTRY
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fp8 as pfp8

    config = dataclasses.replace(MODEL_REGISTRY[model_name](), num_hidden_layers=layers)
    on_card = device.type == "cuda"
    runs = {}
    for policy in (None, "full"):
        fa.reset_launch_counts()
        pfp8.reset_product_counts()
        losses = train(device, config, "fp8", batch=1, steps=steps, seq=seq, remat_policy=policy)[0]
        launches, products = dict(fa.LAUNCHES), dict(pfp8.PRODUCTS)
        runs[str(policy)] = {"losses": losses, "launches": launches, "fp8_products": products}
        log(f"[fp8] remat_policy={policy}, {layers} layers: {json.dumps(runs[str(policy)])}")
        once = (7 * layers + 1) * steps
        want = {"fwd": once + (7 * layers * steps if policy else 0), "dx": once, "dw": once}
        if products != want:
            raise RuntimeError(f"fp8 remat_policy={policy}: fp8 products {products}, expected {want}")
        if on_card and launches != remat_launches(layers * steps, policy, torch.bfloat16):
            raise RuntimeError(f"fp8 remat_policy={policy}: flash launches {launches}, expected "
                               f"{remat_launches(layers * steps, policy, torch.bfloat16)}")
        free_memory(device)
    diff = max(abs(a - b) / abs(b) for a, b in zip(runs["full"]["losses"], runs["None"]["losses"]))
    if not all(np.isfinite(runs["None"]["losses"])) or diff > REMAT_F32_RTOL:
        raise RuntimeError(f"fp8 losses under remat {runs['full']['losses']} differ from those without "
                           f"{runs['None']['losses']} (rtol {diff})")
    return {"layers": layers, "runs": runs, "max_rel_diff": diff, "rtol": REMAT_F32_RTOL}


def resnet_phase(device, config=None, shape=RESNET):
    """11 (d): ResNet (ResNet-50 by default, random weights from seed 0)
    through `Accelerator.prepare` and `backward` with AdamW, bf16 mixed
    precision, one repeated batch of NHWC images (numpy seed 0, labels over
    the classes). Gates: losses finite and falling; every BatchNorm buffer
    unchanged bit for bit. Reports step time (loss read back each step),
    images/s and peak memory."""
    from accelerate_tpu_torch import Accelerator, BatchSampler, SimpleDataLoader
    from accelerate_tpu_torch.models.resnet import create_resnet_model, resnet50
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    config = config or resnet50()
    on_card = device.type == "cuda"
    AcceleratorState._reset_state()
    GradientState._reset_state()
    batch, size = shape["batch"], shape["size"]
    rng = np.random.default_rng(0)
    images = rng.normal(size=(batch, size, size, config.num_channels)).astype(np.float32)
    labels = rng.integers(0, config.num_classes, size=batch)
    data = [{"pixel_values": images[i], "labels": labels[i]} for i in range(batch)]
    model = create_resnet_model(config, seed=0, device=device)
    accelerator = Accelerator(mixed_precision="bf16", cpu=not on_card)
    optimizer = torch.optim.AdamW(model.parameters(), lr=shape["lr"], weight_decay=shape["weight_decay"])
    pmodel, optimizer, loader = accelerator.prepare(model, optimizer, SimpleDataLoader(data, BatchSampler(range(batch),
                                                                                                       batch)))
    b = next(iter(loader))
    buffers = {name: t.clone() for name, t in model.named_buffers()}
    losses, seconds = [], []
    for i in range(shape["warmup"] + shape["timed_steps"]):
        if i == shape["warmup"] and on_card:
            torch.cuda.reset_peak_memory_stats(device)
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        loss = accelerator.backward(pmodel.loss, b)
        optimizer.step()
        optimizer.zero_grad()
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
    step_s = float(np.median(seconds[shape["warmup"]:]))
    report = {"parameters": pmodel.num_parameters, "batch": batch, "image_size": size, "losses": losses,
              "step_ms_median": 1e3 * step_s, "step_ms": [1e3 * s for s in seconds], "images_per_s": batch / step_s}
    if on_card:
        report["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    changed = [name for name, t in model.named_buffers() if not torch.equal(t, buffers[name])]
    report["batchnorm_buffers"] = len(buffers)
    log(f"[resnet] {json.dumps(report)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"ResNet training on a repeated batch: losses {losses} (finite, falling)")
    if changed:
        raise RuntimeError(f"ResNet training moved BatchNorm buffers: {changed}")
    return report


def fp8_phase(device, bf16=None, profile=False):
    """Phase 11: (a) the fp8 products at Llama-1B's linear shapes, (b) Llama-1B
    trained in fp8 beside `bf16` (5 (b)'s run), (c) fp8 under remat, (d)
    ResNet-50 in bf16."""
    report = {}
    for key, run in (("products", lambda: fp8_products_phase(device)),
                     ("training", lambda: fp8_training_phase(device, bf16=bf16, profile=profile)),
                     ("remat", lambda: fp8_remat_phase(device)),
                     ("resnet", lambda: resnet_phase(device))):
        t0 = time.perf_counter()
        report[key] = run()
        log(f"[time] fp8 ({key}) {time.perf_counter() - t0:.1f}s")
        free_memory(device)
    return report


# ---------------------------------------------------------------- telemetry (phase 13)
TELEMETRY_BLOCK_EVERY = 2  # the analyzed step's sampled block: every 2nd step
TELEMETRY_LAYERS = 2  # phase 13's depth: phase 3 and 5 (b) hold its paths at full depth
PAGED_KERNEL_NAMES = ("paged_split_", "paged_merge_kernel")
FLASH_WGMMA_NAMES = ("flash_fwd_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel")


def abba(run, a, b, rounds=1):
    """`run(label)` in the order a b b a, `rounds` times over, so that drift
    on the card weighs on both alike; returns {label: [its results in
    order]}."""
    out = {a: [], b: []}
    for label in (a, b, b, a) * rounds:
        out[label].append(run(label))
    return out


def span_counts(records):
    """Completed spans by name among flight-recorder records."""
    counts = {}
    for record in records:
        if record.get("kind") == "span":
            counts[record["name"]] = counts.get(record["name"], 0) + 1
    return counts


def engine_telemetry_gates(registry, records, stats, n_requests):
    """Phase 13 (a)'s counts: every request submitted, finished and timed to
    its first token once; `serving_chunks_total` equal to the engine's chunk
    count; one ``serve.request`` and one ``serve.insert`` span per request
    and one ``serve.decode_chunk`` span per chunk. Raises on a miss; returns
    the counts."""
    from accelerate_tpu_torch.serving import FINISH_REASONS

    counts = {
        "submitted": registry.value("serving_requests_submitted_total"),
        "finished": sum(registry.value("serving_requests_finished_total", {"reason": r}) or 0 for r in FINISH_REASONS),
        "ttft_count": registry.get("serving_ttft_seconds").count,
        "chunks_total": registry.value("serving_chunks_total"),
        "chunks": stats["chunks"],
        "spans": span_counts(records),
    }
    spans = counts["spans"]
    bad = [key for key in ("submitted", "finished", "ttft_count") if counts[key] != n_requests]
    if counts["chunks_total"] != stats["chunks"]:
        bad.append("chunks_total")
    for name, want in (("serve.request", n_requests), ("serve.insert", n_requests),
                       ("serve.decode_chunk", stats["chunks"])):
        if spans.get(name, 0) != want:
            bad.append(f"{name} spans")
    if bad:
        raise RuntimeError(f"engine telemetry: {bad} off for {n_requests} requests: {counts}")
    return counts


def scrape_matches(registry, text):
    """A ``/metrics`` scrape, parsed: each counter and gauge equals the
    registry's value, each histogram's ``_count`` its count. Raises on a
    miss; returns the number of series compared."""
    from accelerate_tpu_torch.telemetry import Histogram, parse_prometheus_text

    parsed = parse_prometheus_text(text)
    bad, n = [], 0
    for inst in registry.instruments():
        name, want = (f"{inst.name}_count", inst.count) if isinstance(inst, Histogram) else (inst.name, inst.value)
        got = parsed.get(name, {}).get("samples", {}).get(inst.labels)
        n += 1
        if got != want:
            bad.append((name, inst.labels, got, want))
    if bad:
        raise RuntimeError(f"the /metrics scrape disagrees with the registry: {bad}")
    return n


def trace_kernel_names(log_dir):
    """Every event name in the Chrome traces `torch.profiler` wrote under
    `log_dir`."""
    names = set()
    for root, _, files in os.walk(log_dir):
        for name in files:
            if name.endswith(".json"):
                with open(os.path.join(root, name)) as f:
                    names.update(e.get("name", "") for e in json.load(f).get("traceEvents", []))
    return names


def require_names(names, wanted, where):
    missing = [w for w in wanted if not any(w in name for name in names)]
    if missing:
        raise RuntimeError(f"{where}: the profiler trace names no {missing}")


def instrumented_serve(model, requests, device, engine_kw, trace_dir):
    """One `serve` with a fresh registry, a tracer over a flight recorder
    streaming into `trace_dir` and a record-mode `TraceGuard` ("log": each
    sync is recorded, none raises) armed around the steps; the count gates,
    the Perfetto JSON read back, a ``/metrics`` scrape against the registry
    and the guard's 0 builds and 0 syncs. Returns (engine, tokens, timing)."""
    import urllib.request

    from accelerate_tpu_torch.analysis import TraceGuard
    from accelerate_tpu_torch.telemetry import FlightRecorder, MetricsHTTPServer, MetricsRegistry, Tracer
    from accelerate_tpu_torch.telemetry import collect_trace_dir

    registry = MetricsRegistry()
    recorder = FlightRecorder(log_dir=trace_dir)
    guard = TraceGuard(transfer_guard="log", on_violation="record", name="engine")
    engine, tokens, timing = serve(model, requests, device, guard=guard, registry=registry,
                                   tracer=Tracer(recorder=recorder, category="serve"), trace_guard=guard, **engine_kw)
    recorder.close()
    counts = engine_telemetry_gates(registry, collect_trace_dir(trace_dir), engine.stats, len(requests))
    with open(recorder.dump(os.path.join(trace_dir, "trace.json"))) as f:
        events = json.load(f)["traceEvents"]
    perfetto = {name: sum(e["ph"] == "X" and e["name"] == name for e in events)
                for name in ("serve.request", "serve.insert", "serve.decode_chunk")}
    if perfetto != {k: counts["spans"][k] for k in perfetto}:
        raise RuntimeError(f"the Perfetto JSON holds {perfetto}, the span stream {counts['spans']}")
    server = MetricsHTTPServer(registry, port=0)
    try:
        with urllib.request.urlopen(server.url, timeout=30) as resp:
            scraped = scrape_matches(registry, resp.read().decode())
    finally:
        server.close()
    report = guard.report()
    if report.total_recompiles or report.host_transfers:
        raise RuntimeError(f"the warm engine under the guard: {report.summary()}: {report.transfer_violations}")
    timing.update(counts=counts, perfetto_events=perfetto, scraped_series=scraped,
                  guard={"builds": report.total_recompiles, "syncs": report.host_transfers})
    return engine, tokens, timing


def telemetry_engine(device, model, requests, engine_kw, plain_tokens=None):
    """Phase 13 (a) and the engine half of (c)."""
    import shutil
    import tempfile

    from accelerate_tpu_torch import ContinuousBatcher
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.telemetry import ProfilerManager

    layers = model.config.num_hidden_layers
    report = {}
    for label, extra, kind in (("plain", {}, "decode"), ("speculative", SPEC_KW, "verify")):
        serve(model, requests[:2], device, **engine_kw, **extra)  # warm-up: GEMM handles, allocator

        def run(mode):
            gc.collect()
            pa.reset_launch_counts()
            trace_dir = tempfile.mkdtemp(prefix="telemetry-")
            try:
                if mode == "instrumented":
                    engine, tokens, timing = instrumented_serve(model, requests, device, {**engine_kw, **extra},
                                                                trace_dir)
                else:
                    engine, tokens, timing = serve(model, requests, device, **engine_kw, **extra)
            finally:
                shutil.rmtree(trace_dir, ignore_errors=True)
            launches = dict(pa.LAUNCHES)
            dispatches = engine.stats["decode_steps"]
            if device.type == "cuda" and (launches[kind] != layers * dispatches or launches[kind] <= 0):
                raise RuntimeError(f"{label} {mode}: launches {launches}, expected {kind} = {layers} x {dispatches}")
            timing.update(launches=launches, dispatches=dispatches)
            return tokens, timing

        # The speculative engine is paired a b; the plain one a b b a.
        runs = abba(run, "plain", "instrumented") if label == "plain" else {
            mode: [run(mode)] for mode in ("plain", "instrumented")}
        streams = [tokens for mode in runs for tokens, _ in runs[mode]]
        if plain_tokens is not None and label in plain_tokens:
            streams.append(plain_tokens[label])
        if any(s != streams[0] for s in streams):
            raise RuntimeError(f"{label}: the instrumented engine's tokens differ from the plain engine's")
        if label == "plain":
            plain_stream = streams[0]
        entry = {mode: [timing for _, timing in runs[mode]] for mode in runs}
        entry["tokens_equal_phase_3"] = plain_tokens is not None and label in plain_tokens
        for key in ("decode_tokens_per_s", "ttft_p50_s"):
            entry[key] = {mode: [t[key] for t in entry[mode]] for mode in ("plain", "instrumented")}
            entry[key + "_median"] = {mode: float(np.median(v)) for mode, v in entry[key].items()}
        log(f"[telemetry] (a) {label}: decode tokens/s {entry['decode_tokens_per_s']}, TTFT p50 s "
            f"{entry['ttft_p50_s']}; {json.dumps(entry['instrumented'][0]['counts'])}")
        report[label] = entry

    report["unsanctioned_control"] = sanction_control(model, requests, device, engine_kw, plain_stream)

    # (c) a ProfilerManager window around one engine step that runs a chunk.
    profile_dir = tempfile.mkdtemp(prefix="telemetry-profile-")
    try:
        manager = ProfilerManager(log_dir=profile_dir)
        engine = ContinuousBatcher(model, max_queue=len(requests), device=device, **engine_kw)
        for r in requests:
            engine.submit(r)
        engine.step()  # admits the first slots and runs a chunk
        with manager.trace(subdir="engine_step"):
            engine.step()
        while engine.pending:
            engine.step()
        names = trace_kernel_names(profile_dir)
        if device.type == "cuda":
            require_names(names, PAGED_KERNEL_NAMES, "the engine step's window")
        report["profile_kernels"] = sorted(n for n in names if any(k in n for k in PAGED_KERNEL_NAMES))[:8]
    finally:
        shutil.rmtree(profile_dir, ignore_errors=True)
    return report


def sanction_control(model, requests, device, engine_kw, plain_tokens):
    """The engine once more with its sanctioned syncs unsanctioned (the
    engine's `allow_sync` a no-op) under a "log" guard: the sites the guard
    then records, by count. A positive control for (a)'s 0: on the card the
    chunk's uploads and readback and the insert's pushes and first-token
    read are syncs, and a guard that records none sees nothing."""
    import contextlib

    from accelerate_tpu_torch import serving
    from accelerate_tpu_torch.analysis import TraceGuard

    guard = TraceGuard(transfer_guard="log", on_violation="record", name="control")
    saved = serving.allow_sync
    serving.allow_sync = contextlib.nullcontext
    try:
        engine, tokens, _ = serve(model, requests, device, guard=guard, trace_guard=guard, **engine_kw)
    finally:
        serving.allow_sync = saved
    sites = {}
    for entry in guard.transfer_violations:
        path, line = entry.split(": ")[0].rsplit(":", 1)
        site = f"{os.path.relpath(path)}:{line}"
        sites[site] = sites.get(site, 0) + 1
    if device.type == "cuda" and not sites:
        raise RuntimeError("with the engine's syncs unsanctioned the guard recorded none")
    if tokens != plain_tokens:
        raise RuntimeError("the control run's tokens differ from the plain engine's")
    report = {"sites": sites, "chunks": engine.stats["chunks"], "inserts": engine.stats["inserts"]}
    log(f"[telemetry] (a) unsanctioned control: {json.dumps(report)}")
    return report


def telemetry_training(device, config, seq, batch, warmup, timed_steps):
    """Phase 13 (b) and the training half of (c)."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.ops import flash_attention as fa

    layers, steps = config.num_hidden_layers, warmup + timed_steps
    keep, profiled = {}, []

    def run(mode):
        free_memory(device)
        fa.reset_launch_counts()
        keep.clear()

        def on_step(i, step_fn):
            if i == 0 and mode == "analyze":
                keep["accelerator"].timeline.sample_block_every = TELEMETRY_BLOCK_EVERY

        losses, seconds, pmodel, step_fn, last = train(device, config, "bf16", batch=batch, steps=timed_steps,
                                                       seq=seq, warmup=warmup, on_step=on_step,
                                                       analyze=mode == "analyze", keep=keep)
        launches = dict(fa.LAUNCHES)
        accelerator = keep["accelerator"]
        result = {"losses": losses, "step_ms_median": 1e3 * float(np.median(seconds[warmup:])),
                  "step_ms": [1e3 * s for s in seconds], "launches": launches}
        if device.type == "cuda" and launches != expected_launches(layers * steps, torch.bfloat16):
            raise RuntimeError(f"{mode}: flash launches {launches}, expected {layers} x {steps}")
        registry = accelerator.telemetry
        counts = {"train_steps_total": registry.value("train_steps_total"),
                  "train_dispatch_seconds_count": registry.get("train_dispatch_seconds").count,
                  "goodput_steps": accelerator.timeline.goodput()["steps"]}
        if set(counts.values()) != {steps}:
            raise RuntimeError(f"{mode}: step counts {counts}, expected {steps}")
        result["counts"] = counts
        if mode == "analyze":
            guard = accelerator.trace_guard
            if guard.steps != steps - 2 or guard.total_recompiles or guard.host_transfers:
                raise RuntimeError(f"analyze: the guard saw {guard.steps} steady steps: {guard.report().summary()}")
            goodput = accelerator.timeline.goodput()
            result["guard"] = {"steady_steps": guard.steps, "builds": guard.total_recompiles,
                               "syncs": guard.host_transfers}
            result["block_share"] = goodput["phase_s"].get("block", 0.0) / max(goodput["productive_s"], 1e-12)
            result["block_samples"] = registry.get("train_block_seconds").count
            if not profiled:  # (c), on the first analyzed run
                profiled.append(telemetry_profile_steps(device, accelerator, step_fn, last))
                result["profile"] = profiled[0]
        del pmodel, step_fn, last
        keep.clear()
        return result

    runs = abba(run, "plain", "analyze")
    base = runs["plain"][0]["losses"]
    worst = max(abs(a - b) / max(abs(b), 1e-30) for r in runs["plain"] + runs["analyze"]
                for a, b in zip(r["losses"], base))
    if worst > 1e-6:
        raise RuntimeError(f"analyze changed the losses: {[r['losses'] for r in runs['analyze']]} against {base}")
    report = {mode: runs[mode] for mode in runs}
    report["losses_max_rel_diff"] = worst
    report["losses_bit_for_bit"] = all(r["losses"] == base for r in runs["plain"] + runs["analyze"])
    report["step_ms_median"] = {mode: [r["step_ms_median"] for r in runs[mode]] for mode in runs}
    log(f"[telemetry] (b) step ms {report['step_ms_median']}, block share "
        f"{[r['block_share'] for r in runs['analyze']]}, losses bit for bit {report['losses_bit_for_bit']}")
    free_memory(device)
    return report


def telemetry_profile_steps(device, accelerator, step_fn, batch, steps=2):
    """(c): `Accelerator.profile()` around `steps` more steps, with the
    allocator's history recorded, then `save_memory_profile`."""
    import shutil
    import tempfile

    log_dir = tempfile.mkdtemp(prefix="telemetry-train-profile-")
    try:
        on_card = device.type == "cuda"
        if on_card:
            torch.cuda.memory._record_memory_history(max_entries=100_000)
        with accelerator.profile(log_dir=log_dir):
            for _ in range(steps):
                step_fn(batch)
        names = trace_kernel_names(log_dir)
        report = {"kernels": sorted(n for n in names if any(k in n for k in FLASH_WGMMA_NAMES))[:6]}
        if on_card:
            require_names(names, FLASH_WGMMA_NAMES, "the training steps' window")
            path = os.path.join(log_dir, "memory.pickle")
            accelerator.save_memory_profile(path)
            torch.cuda.memory._record_memory_history(enabled=None)
            report["memory_snapshot_bytes"] = os.path.getsize(path)
            if report["memory_snapshot_bytes"] <= 0:
                raise RuntimeError("save_memory_profile wrote an empty snapshot")
        return report
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)


def planted_sync_case(device):
    """(d): a `.item()` on a CUDA tensor inside a step that `wrap` guards,
    after its warm-up call: the raising guard names the line; a record-mode
    guard counts it once. On the CPU there is no sync to catch."""
    from accelerate_tpu_torch.analysis import TraceGuard, TraceGuardViolation

    if device.type != "cuda":
        return {"skipped": "no CUDA device: nothing syncs"}
    x = torch.randn(1024, device=device)

    def step(x):
        y = torch.tanh(x) * 2.0
        return y.sum().item()  # the planted sync

    site = f"{step.__code__.co_filename}:{step.__code__.co_firstlineno + 2}"
    raising = TraceGuard(name="planted")
    wrapped = raising.wrap(step, warmup=1)
    wrapped(x)
    try:
        wrapped(x)
    except TraceGuardViolation as exc:
        message = str(exc)
    else:
        raise RuntimeError("the planted .item() passed the guard")
    if site not in message:
        raise RuntimeError(f"the guard did not name {site}: {message}")
    recording = TraceGuard(name="planted-record", on_violation="record")
    wrapped = recording.wrap(step, warmup=1)
    wrapped(x)
    try:
        wrapped(x)
    except RuntimeError as exc:
        if isinstance(exc, TraceGuardViolation) or not TraceGuard.is_transfer_violation(exc):
            raise
    if recording.host_transfers != 1:
        raise RuntimeError(f"the record-mode guard counted {recording.host_transfers}: {recording.transfer_violations}")
    if torch.cuda.get_sync_debug_mode() != 0:
        raise RuntimeError("the guard left the sync debug mode set")
    return {"message": message, "recorded": recording.transfer_violations}


def telemetry_phase(device, model_name="llama-1b", engine_kw=None, n_requests=16, system_len=256,
                    seq=TRAIN_SEQ, batch=2, warmup=2, timed_steps=8, plain_tokens=None, layers=TELEMETRY_LAYERS):
    """Phase 13: telemetry and the trace guard on the main paths, at
    `layers` (phase 3 and 5 (b) hold those paths at full depth);
    `plain_tokens`, phase 3's, gate the engine's only at full depth."""
    import dataclasses

    from accelerate_tpu_torch import create_llama_model
    from accelerate_tpu_torch.models import MODEL_REGISTRY

    full = MODEL_REGISTRY[model_name]()
    config = dataclasses.replace(full, num_hidden_layers=min(layers, full.num_hidden_layers))
    if config.num_hidden_layers != full.num_hidden_layers:
        plain_tokens = None
    engine_kw = {**ENGINE_KW, **(engine_kw or {})}
    report = {"model": model_name, "layers": config.num_hidden_layers, "engine": engine_kw}
    t0 = time.perf_counter()
    # Phase 3's model: f32 from seed 0, then cast, so at full depth its tokens are phase 3's.
    model = create_llama_model(config, seed=0, dtype=torch.float32, device=device).to(torch.bfloat16)
    requests = make_requests(model.config.vocab_size, n=n_requests, system_len=system_len)
    report["engine_runs"] = telemetry_engine(device, model, requests, engine_kw, plain_tokens)
    del model
    free_memory(device)
    log(f"[time] telemetry (a) engine {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report["training"] = telemetry_training(device, config, seq, batch, warmup, timed_steps)
    log(f"[time] telemetry (b) training {time.perf_counter() - t0:.1f}s")
    report["planted_sync"] = planted_sync_case(device)
    log(f"[telemetry] (d) planted sync: {json.dumps(report['planted_sync'])}")
    return report


# Data parallel and FSDP/ZeRO (phase 14).
DIST_STRATEGIES = ("NO_SHARD", "SHARD_GRAD_OP", "FULL_SHARD")
# NO_SHARD at one process runs the bare step's arithmetic (the all-reduce of
# one process divides by 1): its losses equal the bare run's.
DIST_NO_SHARD_RTOL = 1e-6
# The sharded strategies cast through FSDP's mixed-precision policy or
# update through shard views: the same bf16 arithmetic in other kernels.
DIST_SHARDED_RTOL = 1e-2
DIST_CHECKPOINT_LAYERS = 1  # (c): its save and loads on 9p are most of the phase
DIST_TRAIN_LAYERS = 2  # (a) and (b): 5 (b) holds the fused step at full depth
DIST_GUARD_STEPS = 4
DIST_FP8_STEPS = (2, 4)  # (d): warm-up and timed steps of each fp8 run
# The launcher's variables phase 14 sets for its world-1 NCCL group, and
# puts back after.
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_USE_AGENT_STORE")


def reset_port_state(partial=False):
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    if partial:
        PartialState._reset_state()


class world_one_group:
    """A one-process group for the block: the launcher's variables set (a
    store this process hosts, `launchers.hosted_store`), `PartialState`
    built on them (NCCL on the card, gloo on the CPU), and on exit the
    group destroyed, the store dropped, the singletons reset and the
    variables as they were."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        from accelerate_tpu_torch.launchers import hosted_store
        from accelerate_tpu_torch.state import PartialState

        self.saved = {k: os.environ.get(k) for k in DIST_ENV}
        try:
            self.store, group = hosted_store()
            os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", **group)
            reset_port_state(partial=True)
            state = PartialState(cpu=self.device.type == "cpu")
            backend = torch.distributed.get_backend()
            if self.device.type == "cuda" and backend != "nccl":
                raise RuntimeError(f"the card's process group runs {backend!r}, not nccl")
        except BaseException:
            self.__exit__(None, None, None)
            raise
        self.backend = backend
        return state

    def __exit__(self, *exc):
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        self.store = None
        reset_port_state(partial=True)
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def dist_accelerator_kw(strategy):
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

    return {} if strategy == "bare" else {"fsdp_plugin": FullyShardedDataParallelPlugin(sharding_strategy=strategy)}


def dist_run(device, config, strategy, batch, seq, warmup, timed_steps, profile_step=False, mixed_precision="bf16"):
    """One run of phase 14 (a) or (d): `train` under `strategy` ("bare": no
    group), inside a one-process group otherwise; under fp8 it also
    reports the fp8 products and the amax all-reduces of the run."""
    import contextlib

    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fp8 as pfp8

    free_memory(device)
    fa.reset_launch_counts()
    pfp8.reset_product_counts()
    on_card = device.type == "cuda"

    def before_step(i, step_fn):
        if i == warmup and on_card:
            torch.cuda.reset_peak_memory_stats(device)

    group = contextlib.nullcontext() if strategy == "bare" else world_one_group(device)
    with group:
        backend = torch.distributed.get_backend() if strategy != "bare" else None
        losses, seconds, pmodel, step_fn, last = train(
            device, config, mixed_precision, batch=batch, steps=timed_steps, seq=seq, warmup=warmup,
            on_step=before_step, accelerator_kw=dist_accelerator_kw(strategy))
        launches = dict(fa.LAUNCHES)
        report = step_report(batch, seq, seconds, warmup, pmodel.num_parameters, config, launches)
        report.update(strategy=strategy, backend=backend, losses=losses)
        if mixed_precision == "fp8":
            report.update(fp8_products=dict(pfp8.PRODUCTS), amax_all_reduces=pfp8.AMAX_REDUCES["all_reduce"])
        if on_card:
            report["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
        if profile_step:
            report["profile"] = dist_profile_step(step_fn, last, device)
        del pmodel, step_fn, last
    free_memory(device)
    return report


def dist_profile_step(step_fn, batch, device):
    """One more step under `torch.profiler`: the collectives issued through
    NCCL (the host-side `nccl:*` ops, by name), the NCCL kernels and the
    device-to-device copies on the device, and the total device time. At one
    rank NCCL runs a collective as a device-to-device copy, not a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return {"skipped": "no CUDA device"}
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        float(step_fn(batch))
    events = prof.key_averages()
    rows = [(row.self_device_time_total, row.key, row.count) for row in events
            if row.device_type == DeviceType.CUDA and row.self_device_time_total > 0
            and not getattr(row, "is_user_annotation", False)]
    total = sum(us for us, _, _ in rows)
    pick = lambda test: [{"name": name[:120], "calls": calls, "ms": us / 1e3}  # noqa: E731
                         for us, name, calls in sorted(rows, reverse=True) if test(name)]
    nccl_ops = {row.key: row.count for row in events
                if row.device_type == DeviceType.CPU and row.key.lower().startswith("nccl:")}
    return {"device_busy_ms": total / 1e3, "nccl_ops": nccl_ops,
            "nccl_kernels": pick(lambda n: "nccl" in n.lower()),
            "device_copies": pick(lambda n: n.startswith("Memcpy DtoD")),
            "top_kernels": [{"name": name[:120], "calls": calls, "ms": us / 1e3}
                            for us, name, calls in sorted(rows, reverse=True)[:10]]}


def dist_training(device, config, batch, seq, warmup, timed_steps):
    """Phase 14 (a)."""
    layers, steps = config.num_hidden_layers, warmup + timed_steps
    order = ("bare", *DIST_STRATEGIES)
    runs = {}
    for i, strategy in enumerate(order):
        profile_step = strategy == "FULL_SHARD" and "FULL_SHARD" not in runs
        run = dist_run(device, config, strategy, batch, seq, warmup, timed_steps, profile_step=profile_step)
        log(f"[dist] (a) {strategy}: step ms {run['step_ms_median']:.2f}, losses {run['losses']}, "
            f"launches {run['launches']}, peak {run.get('peak_memory_bytes')}")
        if device.type == "cuda":
            if strategy != "bare" and run["backend"] != "nccl":
                raise RuntimeError(f"{strategy}: backend {run['backend']}, not nccl")
            if run["launches"] != expected_launches(layers * steps, torch.bfloat16):
                raise RuntimeError(f"{strategy}: flash launches {run['launches']}, expected {layers} x {steps}")
        runs.setdefault(strategy, []).append(run)
    base = runs["bare"][0]["losses"]
    report = {"order": order, "layers": layers, "batch": batch, "seq": seq, "strategies": {}}
    bare_ms = float(np.median([r["step_ms_median"] for r in runs["bare"]]))
    for strategy in ("bare", *DIST_STRATEGIES):
        rs = runs[strategy]
        worst = max(abs(a - b) / abs(b) for r in rs for a, b in zip(r["losses"], base))
        limit = DIST_NO_SHARD_RTOL if strategy in ("bare", "NO_SHARD") else DIST_SHARDED_RTOL
        for r in rs:
            if not all(np.isfinite(r["losses"])) or not r["losses"][-1] < r["losses"][0]:
                raise RuntimeError(f"{strategy}: losses {r['losses']} not finite or not falling")
        if worst > limit:
            raise RuntimeError(f"{strategy}: losses {[r['losses'] for r in rs]} part from the bare run's {base} "
                               f"by {worst} (rtol {limit})")
        step_ms = float(np.median([r["step_ms_median"] for r in rs]))
        report["strategies"][strategy] = {
            "losses_max_rel_diff": worst, "rtol": limit,
            "losses_bit_for_bit": all(r["losses"] == base for r in rs),
            "step_ms_median": [r["step_ms_median"] for r in rs], "tokens_per_s": [r["tokens_per_s"] for r in rs],
            "mfu": [r["mfu"] for r in rs], "peak_memory_bytes": [r.get("peak_memory_bytes") for r in rs],
            "step_time_over_bare": step_ms / bare_ms, "backend": rs[0]["backend"], "launches": rs[0]["launches"],
        }
    profile = runs["FULL_SHARD"][0].get("profile", {})
    report["full_shard_profile"] = profile
    log(f"[dist] (a) FULL_SHARD profile: {json.dumps(profile)}")
    if device.type == "cuda" and not profile.get("nccl_ops"):
        raise RuntimeError(f"no collective went through NCCL in the FULL_SHARD step: {profile}")
    return report


def fp8_amax_reduces(config, steps, strategy):
    """The amax all-reduces an fp8 run of `steps` steps issues: none
    without a group; under one, one for each forward product's input (7 a
    Llama layer and the head's) and one for each backward's gradient."""
    products = 7 * config.num_hidden_layers + 1
    return 0 if strategy == "bare" else 2 * products * steps


def dist_fp8(device, config, batch, seq, warmup=DIST_FP8_STEPS[0], timed_steps=DIST_FP8_STEPS[1], bf16=None):
    """Phase 14 (d): fp8 across the strategies at world 1."""
    from accelerate_tpu_torch.ops import _build

    layers, steps = config.num_hidden_layers, warmup + timed_steps
    products = 7 * layers + 1
    report = {"layers": layers, "batch": batch, "seq": seq, "warmup": warmup, "timed_steps": timed_steps,
              "strategies": {}}
    builds = []
    listener = _build.add_build_listener(lambda name, seconds: builds.append(name))
    try:
        runs = {strategy: dist_run(device, config, strategy, batch, seq, warmup, timed_steps, mixed_precision="fp8")
                for strategy in ("bare", *DIST_STRATEGIES)}
    finally:
        _build.remove_build_listener(listener)
    base = runs["bare"]
    for strategy, run in runs.items():
        log(f"[dist] (d) fp8 {strategy}: step ms {run['step_ms_median']:.2f}, losses {run['losses']}, launches "
            f"{run['launches']}, products {run['fp8_products']}, amax all-reduces {run['amax_all_reduces']}")
        if device.type == "cuda":
            if strategy != "bare" and run["backend"] != "nccl":
                raise RuntimeError(f"fp8 {strategy}: backend {run['backend']}, not nccl")
            if run["launches"] != expected_launches(layers * steps, torch.bfloat16):
                raise RuntimeError(f"fp8 {strategy}: flash launches {run['launches']}, expected {layers} x {steps}")
        if run["fp8_products"] != {"fwd": products * steps, "dx": products * steps, "dw": products * steps}:
            raise RuntimeError(f"fp8 {strategy}: products {run['fp8_products']}, expected {products} x {steps} each")
        expected = fp8_amax_reduces(config, steps, strategy)
        if run["amax_all_reduces"] != expected:
            raise RuntimeError(f"fp8 {strategy}: {run['amax_all_reduces']} amax all-reduces, expected {expected}")
        worst = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], base["losses"]))
        limit = DIST_NO_SHARD_RTOL if strategy in ("bare", "NO_SHARD") else DIST_SHARDED_RTOL
        if not all(np.isfinite(run["losses"])) or not run["losses"][-1] < run["losses"][0]:
            raise RuntimeError(f"fp8 {strategy}: losses {run['losses']} not finite or not falling")
        if worst > limit:
            raise RuntimeError(f"fp8 {strategy}: losses {run['losses']} part from the bare run's {base['losses']} "
                               f"by {worst} (rtol {limit})")
        report["strategies"][strategy] = {
            "losses": run["losses"], "losses_max_rel_diff": worst, "rtol": limit,
            "losses_bit_for_bit": run["losses"] == base["losses"], "step_ms_median": run["step_ms_median"],
            "step_time_over_bare_fp8": run["step_ms_median"] / base["step_ms_median"],
            "step_ms_over_bare_fp8": run["step_ms_median"] - base["step_ms_median"],
            "amax_all_reduces_per_step": run["amax_all_reduces"] / steps, "tokens_per_s": run["tokens_per_s"],
            "peak_memory_bytes": run.get("peak_memory_bytes"), "backend": run["backend"],
            "launches": run["launches"],
        }
    if builds:
        raise RuntimeError(f"phase 14 (d) built kernels after the first build: {builds}")
    if bf16 is not None:
        report["bf16_step_ms_median"] = {s: bf16["strategies"][s]["step_ms_median"] for s in ("bare", *DIST_STRATEGIES)}
    report["launches"] = {k: sum(r["launches"][k] for r in runs.values()) for k in base["launches"]}
    return report


def sync_sites(step_fn, batch, device):
    """Every host sync of one step (`torch.cuda.set_sync_debug_mode("warn")`,
    each warning's Python stack read where it is raised): `site`, the frame
    that made the synchronizing call, `in_torch` whether that frame is
    torch's own code, and `port`, the innermost frame of the port above it."""
    import traceback
    import warnings

    if device.type != "cuda":
        return []
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
    sites = []
    shown = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return shown(message, category, filename, lineno, file, line)
        frames = [f for f in traceback.extract_stack()[:-1] if not f.filename.endswith("warnings.py")]
        site = frames[-1]
        ours = [f for f in frames if os.sep + "accelerate_tpu_torch" + os.sep in f.filename]
        sites.append({"site": f"{site.filename}:{site.lineno}",
                      "in_torch": os.path.abspath(site.filename).startswith(torch_dir),
                      "port": f"{ours[-1].filename}:{ours[-1].lineno}" if ours else None})

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step_fn(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = shown
    return sites


def dist_guard(device, config, batch, seq, warmup=2, steps=DIST_GUARD_STEPS):
    """Phase 14 (b)."""
    from accelerate_tpu_torch import Accelerator, create_llama_model
    from accelerate_tpu_torch.analysis import TraceGuard

    report = {}
    for strategy in ("NO_SHARD", "FULL_SHARD"):
        free_memory(device)
        with world_one_group(device):
            model = create_llama_model(config, seed=0, device=device)
            accelerator = Accelerator(mixed_precision="bf16", cpu=device.type == "cpu",
                                      **dist_accelerator_kw(strategy))
            optimizer = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=TRAIN_BETAS, eps=TRAIN_EPS,
                                          weight_decay=TRAIN_WD)
            pmodel, optimizer, loader = accelerator.prepare(
                model, optimizer, repeated_batch_loader(config.vocab_size, batch, 1, seq))
            batch_on_device = next(iter(loader))
            guard = TraceGuard(transfer_guard="log", on_violation="record", name=f"dist-{strategy}")
            step_fn = guard.wrap(accelerator.train_step(max_grad_norm=1.0), warmup=warmup)
            losses = [float(step_fn(batch_on_device)) for _ in range(warmup + steps)]
            sites = sync_sites(step_fn.__wrapped__, batch_on_device, device)
            del model, pmodel, optimizer, loader, step_fn, batch_on_device, accelerator
        free_memory(device)
        report[strategy] = {"steady_steps": guard.steps, "builds": dict(guard.compiles),
                            "syncs": list(guard.transfer_violations), "sync_sites": sites, "losses": losses,
                            "syncs_in_torch": sum(s["in_torch"] for s in sites)}
        log(f"[dist] (b) {strategy}: {guard.steps} steady steps, builds {guard.compiles}, syncs "
            f"{guard.transfer_violations}, sites {sites}")
        if guard.total_recompiles:
            raise RuntimeError(f"{strategy}: a steady step built a kernel: {guard.compiles}")
        if not all(s["in_torch"] for s in sites):
            raise RuntimeError(f"{strategy}: host syncs in the port's own code: {sites}")
    return report


def dist_checkpoint(device, config, seq, batch=1, steps=6, save_after=3):
    """Phase 14 (c)."""
    import shutil
    import tempfile

    from accelerate_tpu_torch import Accelerator, create_llama_model

    rows = np.random.default_rng(9).integers(0, config.vocab_size, (steps, batch, seq)).astype(np.int64)
    batches = [{"input_ids": torch.as_tensor(r, device=device)} for r in rows]
    directory = tempfile.mkdtemp(prefix="chip_smoke_dist_checkpoint_")
    path = os.path.join(directory, "checkpoint")

    def prepared(strategy):
        reset_port_state()
        model = create_llama_model(config, seed=0, device=device)
        accelerator = Accelerator(mixed_precision="bf16", cpu=device.type == "cpu", **dist_accelerator_kw(strategy))
        optimizer = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=TRAIN_BETAS, eps=TRAIN_EPS,
                                      weight_decay=TRAIN_WD)
        pmodel, optimizer = accelerator.prepare(model, optimizer)
        return accelerator, pmodel, accelerator.train_step(max_grad_norm=1.0)

    report = {"layers": config.num_hidden_layers, "batch": batch, "seq": seq}
    try:
        with world_one_group(device):
            accelerator, pmodel, step = prepared("FULL_SHARD")
            uncut = [float(step(b)) for b in batches[:save_after]]
            sync(device)
            t0 = time.perf_counter()
            accelerator.save_state(path)
            report["save_s"] = time.perf_counter() - t0
            report["bytes"] = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
            gathered = pmodel.full_state_dict()
            uncut += [float(step(b)) for b in batches[save_after:]]
            del accelerator, pmodel, step
            free_memory(device)
            accelerator, pmodel, step = prepared("FULL_SHARD")
            t0 = time.perf_counter()
            accelerator.load_state(path)
            sync(device)
            report["load_s"] = time.perf_counter() - t0
            resumed = [float(step(b)) for b in batches[save_after:]]
            del accelerator, pmodel, step
        free_memory(device)
        accelerator, pmodel, _ = prepared("bare")
        t0 = time.perf_counter()
        accelerator.load_state(path)
        sync(device)
        report["bare_load_s"] = time.perf_counter() - t0
        loaded = pmodel.module.state_dict()
        mismatched = [name for name, value in gathered.items() if not torch.equal(loaded[name].cpu(), value)]
        del accelerator, pmodel
        reset_port_state()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    free_memory(device)
    diff = max(abs(a - b) / abs(b) for a, b in zip(resumed, uncut[save_after:]))
    report.update(losses=uncut, resumed_losses=resumed, max_rel_diff=diff, bare_weights_mismatched=mismatched)
    log(f"[dist] (c) checkpoint {json.dumps(report)}")
    if not all(np.isfinite(uncut + resumed)) or diff > 1e-6:
        raise RuntimeError(f"FULL_SHARD resume: losses {resumed} against {uncut[save_after:]} (rtol {diff}, limit 1e-6)")
    if mismatched:
        raise RuntimeError(f"the bare Accelerator loaded other weights than the gathered FULL_SHARD ones: {mismatched}")
    return report


def dist_phase(device, model_name="llama-1b", seq=TRAIN_SEQ, batch=2, warmup=2, timed_steps=4,
               checkpoint_layers=DIST_CHECKPOINT_LAYERS, guard_steps=DIST_GUARD_STEPS, layers=DIST_TRAIN_LAYERS,
               fp8_steps=DIST_FP8_STEPS):
    """Phase 14: data parallel and FSDP/ZeRO through NCCL at world 1."""
    import dataclasses

    from accelerate_tpu_torch.models import MODEL_REGISTRY

    full = MODEL_REGISTRY[model_name]()
    config = dataclasses.replace(full, num_hidden_layers=min(layers, full.num_hidden_layers))
    report = {"model": model_name}
    env_before = {k: os.environ.get(k) for k in DIST_ENV}
    t0 = time.perf_counter()
    report["training"] = dist_training(device, config, batch, seq, warmup, timed_steps)
    log(f"[time] dist (a) training {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report["guard"] = dist_guard(device, config, batch, seq, warmup=warmup, steps=guard_steps)
    log(f"[time] dist (b) guard {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report["checkpoint"] = dist_checkpoint(device, dataclasses.replace(full, num_hidden_layers=checkpoint_layers),
                                           seq)
    log(f"[time] dist (c) checkpoint {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report["fp8"] = dist_fp8(device, config, batch, seq, warmup=fp8_steps[0], timed_steps=fp8_steps[1],
                             bf16=report["training"])
    log(f"[dist] (d) fp8 {json.dumps(report['fp8'])}")
    log(f"[time] dist (d) fp8 {time.perf_counter() - t0:.1f}s")
    if {k: os.environ.get(k) for k in DIST_ENV} != env_before or torch.distributed.is_initialized():
        raise RuntimeError("phase 14 left a process group or the launcher's variables behind")
    return report


# ------------------------------------------------------------------ phase 15: the user's surface
SURFACE = dict(batch=2, accumulation=2, optimizer_steps=4, clip_value=1.0, shard_size="2GB", oom_start=64,
               memory_slack_bytes=64 * 2**20)
SURFACE_RNG_TYPES = ["python", "numpy", "generator", "torch"]


def surface_schedule(step):
    """Phase 15's learning rate: ``TRAIN_LR / (1 + step)``."""
    return TRAIN_LR / (1 + step)


def surface_loader(vocab, batch, micro_steps, seq, seed=15):
    """A `SimpleDataLoader` over `micro_steps` batches of `batch` distinct
    token rows from numpy `seed`."""
    from accelerate_tpu_torch import BatchSampler, SimpleDataLoader

    rows = np.random.default_rng(seed).integers(0, vocab, (batch * micro_steps, seq)).astype(np.int64)
    data = [{"input_ids": rows[i]} for i in range(len(rows))]
    return SimpleDataLoader(data, BatchSampler(range(len(data)), batch))


class flash_dtypes:
    """Records (kernel, dtype) of each flash kernel launch in the block, as
    `ops/flash_attention._run` makes it."""

    def __enter__(self):
        from accelerate_tpu_torch.ops import flash_attention as fa

        self.fa, self.real, self.seen = fa, fa._run, []

        def run(kind, *args):
            self.seen.append((kind, str(args[0].dtype).split(".")[-1]))
            return self.real(kind, *args)

        fa._run = run
        return self.seen

    def __exit__(self, *exc):
        self.fa._run = self.real
        return False


def surface_accelerator(device, dispatch, accumulation):
    """Phase 15's `Accelerator`, built as a user's script builds it."""
    from datetime import timedelta

    from accelerate_tpu_torch import (
        Accelerator,
        AutocastKwargs,
        DataLoaderConfiguration,
        InitProcessGroupKwargs,
    )

    reset_port_state()
    return Accelerator(mixed_precision="bf16", cpu=device.type == "cpu", gradient_accumulation_steps=accumulation,
                       step_scheduler_with_optimizer=True,
                       dataloader_config=DataLoaderConfiguration(dispatch_batches=dispatch),
                       rng_types=list(SURFACE_RNG_TYPES),
                       kwargs_handlers=[AutocastKwargs(), InitProcessGroupKwargs(timeout=timedelta(minutes=5))])


def surface_run(device, config, dispatch, seq, batch, accumulation, optimizer_steps, clip_value):
    """Phase 15 (a): `optimizer_steps` x `accumulation` micro-steps of
    `accumulate` -> `backward` -> `clip_grad_value_` -> `optimizer.step()`
    -> `scheduler.step()`. Returns (the accelerator, the prepared model,
    the first batch, the report)."""
    from accelerate_tpu_torch import create_llama_model
    from accelerate_tpu_torch.data_loader import DataLoaderDispatcher, DataLoaderShard

    free_memory(device)
    acc = surface_accelerator(device, dispatch, accumulation)
    model = create_llama_model(config, seed=0, device=device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=TRAIN_BETAS, eps=TRAIN_EPS,
                                  weight_decay=TRAIN_WD)
    pmodel, optimizer, loader, scheduler = acc.prepare(
        model, optimizer, surface_loader(config.vocab_size, batch, accumulation * optimizer_steps, seq),
        surface_schedule)
    kind = DataLoaderDispatcher if dispatch else DataLoaderShard
    if not isinstance(loader, kind):
        raise RuntimeError(f"dispatch_batches={dispatch} prepared a {type(loader).__name__}, not a {kind.__name__}")
    losses, steps, first = [], [], None
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    for b in loader:
        first = b if first is None else first
        with acc.accumulate(pmodel):
            loss = acc.backward(pmodel.loss, b)
            acc.clip_grad_value_(clip_value=clip_value)
            optimizer.step()
            scheduler.step()
            optimizer.zero_grad()
        losses.append(float(loss))
        if acc.sync_gradients:
            steps.append({"step_count": scheduler.step_count, "lr": scheduler.get_last_lr()[0],
                          "optimizer_lr": optimizer.learning_rate})
    report = {"loader": type(loader).__name__, "losses": losses, "steps": steps, "launches": launch_counts(),
              "seconds": time.perf_counter() - t0}
    return acc, pmodel, first, report


def surface_training(device, config, seq, batch, accumulation, optimizer_steps, clip_value, shard_size):
    """Phase 15 (a) and (b)."""
    import shutil
    import tempfile

    from accelerate_tpu_torch import Accelerator, AutocastKwargs, checkpointing, create_llama_model

    layers, micro = config.num_hidden_layers, accumulation * optimizer_steps
    report = {"layers": layers, "batch": batch, "seq": seq, "accumulation": accumulation,
              "optimizer_steps": optimizer_steps, "clip_value": clip_value}
    acc, pmodel, first, dispatched = surface_run(device, config, True, seq, batch, accumulation, optimizer_steps,
                                                  clip_value)
    want = [{"step_count": k, "lr": surface_schedule(k), "optimizer_lr": surface_schedule(k)}
            for k in range(1, optimizer_steps + 1)]
    report["dispatcher"] = dispatched
    report["lr_at_jax_count"] = dispatched["steps"] == want
    log(f"[surface] (a) dispatcher: {json.dumps(dispatched)}")
    if not report["lr_at_jax_count"]:
        raise RuntimeError(f"scheduler steps {dispatched['steps']}, JAX's rule gives {want}")
    if not all(np.isfinite(dispatched["losses"])):
        raise RuntimeError(f"non-finite losses {dispatched['losses']}")
    if device.type == "cuda" and dispatched["launches"] != {**{k: 0 for k in launch_counts()},
                                                           **expected_launches(layers * micro, torch.bfloat16)}:
        raise RuntimeError(f"launches {dispatched['launches']}, expected K3-K5 {layers} x {micro} each in bf16")
    ids = first["input_ids"][:1]

    # (b) save_model, then the shards read back into a fresh model.
    directory = tempfile.mkdtemp(prefix="chip_smoke_save_model_")
    try:
        sync(device)
        t0 = time.perf_counter()
        acc.save_model(pmodel, directory, max_shard_size=shard_size)
        save_s = time.perf_counter() - t0
        files = sorted(os.listdir(directory))
        nbytes = sum(os.path.getsize(os.path.join(directory, f)) for f in files)
        t0 = time.perf_counter()
        fresh = create_llama_model(config, seed=1, device=device)
        fresh.load_state_dict(checkpointing.load_model_safetensors(directory))
        sync(device)
        load_s = time.perf_counter() - t0
        with torch.no_grad():
            original, loaded = pmodel.module(ids), fresh(ids)
        round_trip = bool(torch.equal(original, loaded))
        del fresh, original, loaded
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    shards = [f for f in files if f.endswith(".safetensors")]
    report["save_model"] = {"max_shard_size": shard_size, "seconds": save_s, "load_seconds": load_s, "bytes": nbytes,
                            "shards": len(shards), "files": files, "round_trip_bit_for_bit": round_trip}
    log(f"[surface] (b) save_model {json.dumps(report['save_model'])}")
    if not round_trip or not shards:
        raise RuntimeError(f"save_model round trip failed: {report['save_model']}")

    # (a) autocast off: the f32 masters without the casts, as a "no" model computes.
    reset_launch_counts()
    with torch.no_grad(), flash_dtypes() as seen:
        with acc.autocast(AutocastKwargs(enabled=False)):
            off = pmodel(ids)
        restored = pmodel.autocast_enabled
        reset_port_state()
        plain = Accelerator(mixed_precision="no", cpu=device.type == "cpu").prepare(pmodel.module)(ids)
    off_launches = [kind for kind, dtype in seen if dtype == "float32"]
    report["autocast_off"] = {"logits_dtype": str(off.dtype), "bit_for_bit_with_no": bool(torch.equal(off, plain)),
                              "restored": restored, "f32_launches": {k: off_launches.count(k) for k in set(off_launches)},
                              "launch_dtypes": sorted(set(dtype for _, dtype in seen))}
    log(f"[surface] (a) autocast off {json.dumps(report['autocast_off'])}")
    if not report["autocast_off"]["bit_for_bit_with_no"] or not restored or off.dtype != torch.float32:
        raise RuntimeError(f"autocast off: {report['autocast_off']}")
    if device.type == "cuda" and off_launches != ["flash_fwd"] * (2 * layers):
        raise RuntimeError(f"autocast off: f32 flash launches {seen}, expected flash_fwd {layers} x 2 (off and 'no')")
    del acc, pmodel, first, off, plain, ids
    free_memory(device)

    _, _, _, sharded = surface_run(device, config, False, seq, batch, accumulation, optimizer_steps, clip_value)
    report["shard_loader"] = sharded
    report["losses_bit_for_bit"] = sharded["losses"] == dispatched["losses"]
    log(f"[surface] (a) shard loader: {json.dumps(sharded)}")
    if not report["losses_bit_for_bit"] or sharded["steps"] != dispatched["steps"]:
        raise RuntimeError(f"the dispatcher's losses {dispatched['losses']} are not the shard loader's "
                           f"{sharded['losses']}")
    free_memory(device)
    return report


def surface_oom(device, config, seq, start, slack, cpu_oom_above=None):
    """Phase 15 (c): the memory twin's loop on Llama-1B bf16 from batch
    `start` x `seq`. On the CPU (a rehearsal) nothing runs out of memory:
    `cpu_oom_above` makes the build raise `torch.cuda.OutOfMemoryError` for
    larger batches, as the caching allocator would."""
    from accelerate_tpu_torch import Accelerator, create_llama_model
    from accelerate_tpu_torch.examples.by_feature.memory import executable_batch_size_loop
    from accelerate_tpu_torch.utils import memory

    if cpu_oom_above is not None and device.type == "cuda":
        raise ValueError("cpu_oom_above stands in for the allocator on the CPU only")
    on_card = device.type == "cuda"
    allocated = (lambda: torch.cuda.memory_allocated(device)) if on_card else (lambda: None)
    reset_port_state()
    free_memory(device)
    acc = Accelerator(mixed_precision="bf16", cpu=not on_card)
    base = allocated()
    attempts, caught = [], []
    real_free, real_is_oom = acc.free_memory, memory.is_oom_exception

    def free_and_measure(*objects):
        before = allocated()
        out = real_free(*objects)
        attempts.append({"before_free_memory": before, "after_free_memory": allocated()})
        return out

    def is_oom(e):
        caught.append({"error": type(e).__name__, "message": str(e).splitlines()[0][:160], "oom": real_is_oom(e)})
        return caught[-1]["oom"]

    def build(batch_size):
        attempts[-1]["batch_size"] = batch_size
        if cpu_oom_above is not None and batch_size > cpu_oom_above:
            raise torch.cuda.OutOfMemoryError(f"CUDA out of memory. Tried to allocate a batch of {batch_size}")
        model = create_llama_model(config, seed=0, device=device)
        optimizer = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=TRAIN_BETAS, eps=TRAIN_EPS,
                                      weight_decay=TRAIN_WD)
        return model, optimizer, repeated_batch_loader(config.vocab_size, batch_size, 1, seq)

    acc.free_memory, memory.is_oom_exception = free_and_measure, is_oom
    t0 = time.perf_counter()
    try:
        found, loss = executable_batch_size_loop(acc, start, build, epochs=1)
    finally:
        acc.free_memory, memory.is_oom_exception = real_free, real_is_oom
    seconds = time.perf_counter() - t0
    acc.free_memory()
    report = {"start": start, "seq": seq, "base_allocated": base, "attempts": attempts, "caught": caught,
              "found": found, "loss": loss, "seconds": seconds, "slack_bytes": slack}
    log(f"[surface] (c) find_executable_batch_size {json.dumps(report)}")
    sizes = [a["batch_size"] for a in attempts]
    if sizes != [start >> i for i in range(len(sizes))] or found != sizes[-1] or len(caught) != len(sizes) - 1:
        raise RuntimeError(f"batch sizes tried {sizes}, found {found}, errors {caught}")
    if not caught or not all(c["oom"] and c["error"] == "OutOfMemoryError" for c in caught):
        raise RuntimeError(f"no out-of-memory error was caught, or one was not taken as one: {caught}")
    if not np.isfinite(loss):
        raise RuntimeError(f"batch {found} trained to a non-finite loss {loss}")
    if on_card and any(a["after_free_memory"] - base > slack for a in attempts):
        raise RuntimeError(f"free_memory left more than {slack} bytes over the phase's start {base}: {attempts}")
    free_memory(device)
    return report


def surface_twins(device, cv_args=(), early_args=(), tracking_args=()):
    """Phase 15 (d): the example twins."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.examples import cv_example
    from accelerate_tpu_torch.examples.by_feature import early_stopping, tracking

    cpu = ["--cpu"] if device.type == "cpu" else []
    report = {}
    reset_port_state()
    t0 = time.perf_counter()
    args = cv_example.parse_args([*cv_args, *cpu])
    accuracy = cv_example.training_function(args)
    report["cv_example"] = {"mixed_precision": args.mixed_precision, "epochs": args.epochs, "history": args.history,
                            "accuracy": accuracy, "seconds": time.perf_counter() - t0}
    reset_port_state()
    t0 = time.perf_counter()
    early = early_stopping.training_function(early_stopping.parse_args(["--patience", "1", *early_args, *cpu]))
    report["early_stopping"] = dict(early, seconds=time.perf_counter() - t0)
    reset_port_state()
    directory = tempfile.mkdtemp(prefix="chip_smoke_tracking_")
    try:
        t0 = time.perf_counter()
        logged = tracking.training_function(tracking.parse_args(["--log_with", "json", "--output_dir", directory,
                                                                 *tracking_args, *cpu]))
        with open(os.path.join(directory, "tracking_example", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    report["tracking"] = {"logged": logged, "records": len(records), "seconds": time.perf_counter() - t0}
    reset_port_state()
    log(f"[surface] (d) twins {json.dumps(report)}")
    if not accuracy > 0.5:
        raise RuntimeError(f"cv_example accuracy {accuracy} (JAX's script asserts > 0.5)")
    if early["stopped_at"] is None or early["trigger_after"] is not False:
        raise RuntimeError(f"early stopping did not stop and reset its trigger: {early}")
    if len(records) != len(logged) or [r["epoch"] for r in records] != [v["epoch"] for v in logged]:
        raise RuntimeError(f"the tracking twin logged {records}, not {logged}")
    return report


def surface_phase(device, model_name="llama-1b", seq=TRAIN_SEQ, shape=SURFACE, cpu_oom_above=None, cv_args=(),
                  early_args=(), tracking_args=()):
    """Phase 15: the user's surface."""
    from accelerate_tpu_torch.models import MODEL_REGISTRY

    config = MODEL_REGISTRY[model_name]()
    report = {"model": model_name}
    t0 = time.perf_counter()
    report["training"] = surface_training(device, config, seq, shape["batch"], shape["accumulation"],
                                          shape["optimizer_steps"], shape["clip_value"], shape["shard_size"])
    log(f"[time] surface (a, b) training and save_model {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report["oom"] = surface_oom(device, config, seq, shape["oom_start"], shape["memory_slack_bytes"],
                                cpu_oom_above=cpu_oom_above)
    log(f"[time] surface (c) find_executable_batch_size {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report["twins"] = surface_twins(device, cv_args, early_args, tracking_args)
    log(f"[time] surface (d) twins {time.perf_counter() - t0:.1f}s")
    return report


# ------------------------------------------------------------------ phase 16: launch and the CLI
# (a)'s eager loop runs at `eager_layers`: phase 15 holds that loop at full depth.
# (b)'s restart at 1 layer: its save and load are most of the phase, and the
# embedding and head most of their bytes.
LAUNCH = dict(batch=2, accumulation=2, optimizer_steps=2, eager_layers=2, restart_layers=1, restart_steps=4,
              save_after=2, restart_rows=16)
CLI = ("-m", "accelerate_tpu_torch.commands.accelerate_cli")
# The user's script the launched children run. The parent runs the same
# functions from the same file for the in-process side of each comparison.
LAUNCH_SCRIPT = '''"""A user's training script: Llama through `Accelerator()`, as launched."""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

LR, BETAS, EPS, WD = 1e-4, (0.9, 0.999), 1e-8, 1e-4


def llama_config(name, layers=None):
    from accelerate_tpu_torch.models import MODEL_REGISTRY

    config = MODEL_REGISTRY[name]()
    return config if layers is None else dataclasses.replace(config, num_hidden_layers=layers)


def rows_loader(vocab, batch, micro_steps, seq, seed=15, sampler_seed=None):
    """`micro_steps` batches of `batch` distinct rows from numpy `seed`, in
    order or shuffled by a `SeedableRandomSampler`."""
    from accelerate_tpu_torch import BatchSampler, SeedableRandomSampler, SimpleDataLoader

    rows = np.random.default_rng(seed).integers(0, vocab, (batch * micro_steps, seq)).astype(np.int64)
    data = [{"input_ids": rows[i]} for i in range(len(rows))]
    order = range(len(data)) if sampler_seed is None else SeedableRandomSampler(num_samples=len(data),
                                                                                seed=sampler_seed)
    return SimpleDataLoader(data, BatchSampler(order, batch))


def eager_loop(accelerator, config, batch, micro_steps, seq):
    """Phase 15 (a)'s loop: accumulate -> backward -> clip_grad_value_ ->
    optimizer.step() -> scheduler.step() over `micro_steps` batches."""
    from accelerate_tpu_torch import create_llama_model

    model = create_llama_model(config, seed=0, device=accelerator.device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    pmodel, optimizer, loader, scheduler = accelerator.prepare(
        model, optimizer, rows_loader(config.vocab_size, batch, micro_steps, seq), lambda step: LR / (1 + step))
    losses = []
    for b in loader:
        with accelerator.accumulate(pmodel):
            loss = accelerator.backward(pmodel.loss, b)
            accelerator.clip_grad_value_(clip_value=1.0)
            optimizer.step()
            scheduler.step()
            optimizer.zero_grad()
        losses.append(float(loss))
    return losses


def fused_steps(accelerator, config, batch, seq, steps, rows, seed, resume_after=None, save_after=None):
    """The fused step over a shuffled loader; with `resume_after`, load the
    latest checkpoint and skip that many batches first; with `save_after`,
    `save_state` after that many steps and stop."""
    from accelerate_tpu_torch import create_llama_model

    model = create_llama_model(config, seed=seed, device=accelerator.device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    _, _, loader, schedule = accelerator.prepare(
        model, optimizer, rows_loader(config.vocab_size, batch, rows // batch, seq, seed=5, sampler_seed=11),
        lambda step: LR)
    report = {}
    if resume_after is not None:
        t0 = time.perf_counter()
        report["loaded"] = os.path.basename(str(accelerator.load_state("latest")))
        report["load_s"] = time.perf_counter() - t0
        loader = accelerator.skip_first_batches(loader, resume_after)
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    losses = []
    for b in loader:
        losses.append(float(step_fn(b)))
        schedule.step()
        if len(losses) == save_after:
            t0 = time.perf_counter()
            report["saved"] = os.path.basename(str(accelerator.save_state()))
            report["save_s"] = time.perf_counter() - t0
            break
        if len(losses) == steps - (resume_after or 0):
            break
    report["losses"] = losses
    return report


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", choices=("eager", "restart"), required=True)
    parser.add_argument("--model", default="llama-1b")
    parser.add_argument("--layers", type=int, default=None)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seq", type=int, default=2048)
    parser.add_argument("--micro_steps", type=int, default=8)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--save_after", type=int, default=2)
    parser.add_argument("--rows", type=int, default=16)
    parser.add_argument("--project_dir", default=None)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.utils import ProjectConfiguration

    builds = []
    _build.add_build_listener(lambda name, seconds: builds.append(name))
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    config = llama_config(args.model, args.layers)
    if args.mode == "eager":
        accelerator = Accelerator()
        report = {"losses": eager_loop(accelerator, config, args.batch, args.micro_steps, args.seq)}
        exit_code = 0
    else:
        accelerator = Accelerator(project_config=ProjectConfiguration(project_dir=args.project_dir,
                                                                      automatic_checkpoint_naming=True))
        resume = os.path.isdir(os.path.join(args.project_dir, "checkpoints")) and bool(
            os.listdir(os.path.join(args.project_dir, "checkpoints")))
        report = fused_steps(accelerator, config, args.batch, args.seq, args.steps, args.rows, seed=1 if resume else 0,
                             resume_after=args.save_after if resume else None,
                             save_after=None if resume else args.save_after)
        exit_code = 0 if resume else 1  # the first attempt dies after its checkpoint
    device = accelerator.device
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    report.update(
        mixed_precision=accelerator.mixed_precision, gradient_accumulation_steps=accelerator.gradient_accumulation_steps,
        num_processes=accelerator.num_processes, device=str(device), launches=dict(fa.LAUNCHES),
        builds=builds, seconds=time.perf_counter() - t0, pid=os.getpid(),
        peak_bytes=torch.cuda.max_memory_allocated(accelerator.device) if cuda else None)
    out = args.out
    if args.mode == "restart":
        out = os.path.join(args.out, f"attempt{len(os.listdir(args.out)) + 1}.json")
    with open(out, "w") as f:
        json.dump(report, f)
    sys.exit(exit_code)


if __name__ == "__main__":
    main()
'''


def launch_env():
    """This environment with the checkout on ``PYTHONPATH`` and no launch
    variables of its own: what a user's shell gives the CLI."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("ACCELERATE_TPU_")}
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def cli(args, timeout, check=True):
    """``python -m accelerate_tpu_torch.commands.accelerate_cli ARGS`` as a
    user runs it; the parent frees its card memory first and logs what
    stays allocated."""
    held = 0
    if torch.cuda.is_available():
        free_memory(torch.device("cuda", 0))
        held = torch.cuda.memory_allocated()
    else:
        gc.collect()
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, *CLI, *args], env=launch_env(), capture_output=True, text=True,
                         timeout=timeout)
    log(f"[launch] {' '.join(args[:3])} ... exit {run.returncode} in {time.perf_counter() - t0:.1f}s "
        f"(parent memory_allocated {held} bytes)")
    if check and run.returncode != 0:
        raise RuntimeError(f"accelerate_cli {args} exited {run.returncode}:\n{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
    return run


def cli_dispatch(args):
    """``accelerate_cli ARGS`` as `cli` runs it, but with the dispatcher in
    this process (its children are fresh interpreters, as a user's are; a
    fresh one for the dispatcher costs 10-17 s here): the parent frees its
    card memory first, the command sees `launch_env()`, and what it and its
    children print on stdout is returned (the file descriptor's, the
    children's, and then `sys.stdout`'s, the dispatcher's own)."""
    import contextlib
    import io
    import tempfile

    from accelerate_tpu_torch.commands.accelerate_cli import get_command_parser

    if torch.cuda.is_available():
        free_memory(torch.device("cuda", 0))
    parsed = get_command_parser().parse_args(args)
    environ = dict(os.environ)
    code = 0
    own = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryFile(mode="w+") as captured:
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(captured.fileno(), 1)
        os.environ.clear()
        os.environ.update(launch_env())
        try:
            with contextlib.redirect_stdout(own):
                parsed.func(parsed)
        except SystemExit as e:
            code = e.code
        finally:
            os.dup2(saved, 1)
            os.close(saved)
            os.environ.clear()
            os.environ.update(environ)
        captured.seek(0)
        out = captured.read() + own.getvalue()
    log(f"[launch] {' '.join(args[:3])} ... (dispatcher in process) exit {code} in {time.perf_counter() - t0:.1f}s")
    if code not in (0, None):
        raise RuntimeError(f"accelerate_cli {args} exited {code}:\n{out[-4000:]}")
    return out


def cli_in_process(args):
    """The dispatcher's commands that read and write files or print only
    (``trace``, ``config --default``, ``env``, ``estimate-memory``), run
    here through the same parser (a fresh interpreter on the card machine
    costs 10-15 s of imports); returns what they printed."""
    import contextlib
    import io

    from accelerate_tpu_torch.commands.accelerate_cli import get_command_parser

    parsed = get_command_parser().parse_args(args)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        try:
            parsed.func(parsed)
        except SystemExit as e:
            if e.code not in (0, None):
                raise RuntimeError(f"accelerate_cli {args} exited {e.code}: {printed.getvalue()[-2000:]}") from e
    log(f"[launch] {' '.join(args[:2])} (in process): {printed.getvalue().strip()[:200]}")
    return printed.getvalue()


def load_launch_script(path):
    import runpy

    return runpy.run_path(str(path), run_name="launch_script")


def child_gates(report, device, layers, steps, what):
    """Every launched child ran on the card (or under --cpu the CPU), built
    no kernel, and launched K3-K5 `layers` x `steps` times each in bf16."""
    want_device = "cpu" if device.type == "cpu" else "cuda:0"
    if report["device"] != want_device or report["builds"]:
        raise RuntimeError(f"{what}: device {report['device']}, kernel builds {report['builds']} "
                           f"(expected {want_device}, none)")
    if device.type == "cuda" and report["launches"] != expected_launches(layers * steps, torch.bfloat16):
        raise RuntimeError(f"{what}: launches {report['launches']}, expected K3-K5 {layers} x {steps} each in bf16")
    if not all(np.isfinite(report["losses"])):
        raise RuntimeError(f"{what}: non-finite losses {report['losses']}")


def launched_training(device, model_name, seq, shape, tmp):
    """(a): ``config --default``, then ``launch --config_file F
    --gradient_accumulation_steps 2 --num_processes 1 S``, against the same
    loop in this process."""
    cpu = ["--cpu"] if device.type == "cpu" else []
    config_file = os.path.join(tmp, "default_config.yaml")
    cli_in_process(["config", "--default", "--config_file", config_file])
    from accelerate_tpu_torch.commands.config import load_config_file

    written = load_config_file(config_file)
    if written.get("mixed_precision") != "bf16":
        raise RuntimeError(f"config --default wrote {written}")
    script = os.path.join(tmp, "train.py")
    micro = shape["accumulation"] * shape["optimizer_steps"]
    out = os.path.join(tmp, "eager.json")
    t0 = time.perf_counter()
    printed = cli_dispatch(["launch", "--config_file", config_file, "--gradient_accumulation_steps",
                            str(shape["accumulation"]), "--num_processes", "1", *cpu, script, "--mode", "eager",
                            "--model", model_name, "--layers", str(shape["eager_layers"]), "--batch",
                            str(shape["batch"]), "--seq", str(seq), "--micro_steps", str(micro), "--out", out])
    with open(out) as f:
        child = json.load(f)
    layers = shape["eager_layers"]
    report = {"config_file": written, "child": child, "launcher_seconds": time.perf_counter() - t0}
    log(f"[launch] (a) child {json.dumps(child)}")
    if (child["mixed_precision"], child["gradient_accumulation_steps"], child["num_processes"]) != (
            "bf16", shape["accumulation"], 1):
        raise RuntimeError(f"(a) the launched child read mixed_precision {child['mixed_precision']}, accumulation "
                           f"{child['gradient_accumulation_steps']}, {child['num_processes']} processes, not bf16, "
                           f"{shape['accumulation']}, 1 (stdout {printed[-2000:]})")
    child_gates(child, device, layers, micro, "(a) launched child")

    # The same loop in this process, from the same script.
    from accelerate_tpu_torch import Accelerator

    reset_port_state()
    reset_launch_counts()
    loop = load_launch_script(script)
    accelerator = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=shape["accumulation"],
                              cpu=device.type == "cpu")
    losses = loop["eager_loop"](accelerator, loop["llama_config"](model_name, layers), shape["batch"], micro, seq)
    report["in_process"] = {"losses": losses, "launches": launch_counts()}
    del accelerator, loop
    reset_port_state()
    free_memory(device)
    report["losses_bit_for_bit"] = losses == child["losses"]
    log(f"[launch] (a) in-process losses {losses}; bit for bit: {report['losses_bit_for_bit']}")
    if not report["losses_bit_for_bit"]:
        raise RuntimeError(f"(a) the launched child's losses {child['losses']} are not the in-process loop's {losses}")
    return report


def trace_records(trace_dir):
    from accelerate_tpu_torch.telemetry import collect_trace_dir

    return collect_trace_dir(trace_dir)


def attempt_of(record, by_id, attempts):
    """The `supervisor.attempt` span a record sits under (its parent chain),
    or None."""
    seen, parent = set(), record.get("parent_id")
    while parent is not None and parent not in seen:
        if parent in attempts:
            return attempts[parent]
        seen.add(parent)
        parent = by_id.get(parent, {}).get("parent_id")
    return None


def stitched_trace(trace_dir):
    """The gates of (b)'s trace: one trace id; two attempt spans with exit
    codes 1 and 0; attempt 1 holds a ``checkpoint.save`` and its steps,
    attempt 2 a ``checkpoint.load`` and its steps."""
    records = trace_records(trace_dir)
    spans = [r for r in records if r.get("kind") == "span"]
    by_id = {r["span_id"]: r for r in records if r.get("span_id")}
    attempts = {r["span_id"]: r["attrs"]["attempt"] for r in spans if r["name"] == "supervisor.attempt"}
    per_attempt = {}
    for r in spans:
        if r["name"] in ("checkpoint.save", "checkpoint.load", "train.step"):
            per_attempt.setdefault(attempt_of(r, by_id, attempts), []).append(r["name"])
    out = {
        "trace_ids": sorted({r.get("trace_id") for r in records}),
        "attempts": [(r["attrs"]["attempt"], r["attrs"]["exit_code"]) for r in spans
                     if r["name"] == "supervisor.attempt"],
        "under_attempt": {str(k): {n: v.count(n) for n in sorted(set(v))} for k, v in per_attempt.items()},
        "records": len(records),
    }
    return out


def supervised_restart(device, model_name, seq, shape, tmp):
    """(b): ``launch --max_restarts 1 --trace_dir D`` of the 2-layer cut: the
    first attempt saves after step 2 and exits 1, the second resumes and
    takes steps 3-4; against the uninterrupted run in this process."""
    cpu = ["--cpu"] if device.type == "cpu" else []
    script = os.path.join(tmp, "train.py")
    trace_dir, project_dir, out = (os.path.join(tmp, d) for d in ("trace", "project", "attempts"))
    for d in (trace_dir, project_dir, out):
        os.makedirs(d)
    layers, steps, save_after = shape["restart_layers"], shape["restart_steps"], shape["save_after"]
    t0 = time.perf_counter()
    run = cli(["launch", "--max_restarts", "1", "--restart_backoff", "0", "--trace_dir", trace_dir,
               "--mixed_precision", "bf16", *cpu, script, "--mode", "restart", "--model", model_name, "--layers",
               str(layers), "--batch", str(shape["batch"]), "--seq", str(seq), "--steps", str(steps), "--save_after",
               str(save_after), "--rows", str(shape["restart_rows"]), "--project_dir", project_dir, "--out", out],
              timeout=900)
    launcher_s = time.perf_counter() - t0
    attempts = []
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name)) as f:
            attempts.append(json.load(f))
    log(f"[launch] (b) attempts {json.dumps(attempts)}")
    if len(attempts) != 2 or "saved" not in attempts[0] or "loaded" not in attempts[1]:
        raise RuntimeError(f"(b) expected 2 attempts, a save then a load: {attempts} (stderr {run.stderr[-2000:]})")
    for i, attempt in enumerate(attempts):
        child_gates(attempt, device, layers, save_after if i == 0 else steps - save_after, f"(b) attempt {i + 1}")

    from accelerate_tpu_torch import Accelerator

    reset_port_state()
    reset_launch_counts()
    loop = load_launch_script(script)
    accelerator = Accelerator(mixed_precision="bf16", cpu=device.type == "cpu")
    full = loop["fused_steps"](accelerator, loop["llama_config"](model_name, layers), shape["batch"], seq, steps,
                               shape["restart_rows"], seed=0)["losses"]
    in_process_launches = launch_counts()
    del accelerator, loop
    reset_port_state()
    free_memory(device)
    resumed = attempts[1]["losses"]
    diff = max(abs(a - b) / abs(b) for a, b in zip(attempts[0]["losses"] + resumed, full))
    export = cli_in_process(["trace", "export", trace_dir, "--out", os.path.join(trace_dir, "trace.json")])
    report_out = cli_in_process(["trace", "report", trace_dir])
    with open(os.path.join(trace_dir, "trace.json")) as f:
        exported = json.load(f)["traceEvents"]
    trace = stitched_trace(trace_dir)
    trace["exported_attempt_events"] = sum(1 for e in exported if e.get("name") == "supervisor.attempt")
    trace["report"] = report_out.strip().splitlines()
    report = {"layers": layers, "attempts": attempts, "uninterrupted_losses": full, "resumed_losses": resumed,
              "max_rel_diff": diff, "launcher_seconds": launcher_s, "trace": trace,
              "in_process": {"losses": full, "launches": in_process_launches}, "export": export.strip()}
    log(f"[launch] (b) {json.dumps({k: v for k, v in report.items() if k != 'attempts'})}")
    if diff > 1e-6 or len(resumed) != steps - save_after or len(full) != steps:
        raise RuntimeError(f"(b) resumed losses {resumed} (first attempt {attempts[0]['losses']}) against the "
                           f"uninterrupted {full}: rtol {diff}, limit 1e-6")
    want_under = {"1": {"checkpoint.save": 1, "train.step": save_after},
                  "2": {"checkpoint.load": 1, "train.step": steps - save_after}}
    if (len(trace["trace_ids"]) != 1 or trace["attempts"] != [(1, 1), (2, 0)]
            or trace["under_attempt"] != want_under or trace["exported_attempt_events"] != 2):
        raise RuntimeError(f"(b) the trace is not one stitched run of 2 attempts: {trace} (want {want_under})")
    if not any(line.strip().startswith("crash/exit boundaries: 2") for line in trace["report"]):
        raise RuntimeError(f"(b) trace report names no crash boundary: {trace['report']}")
    return report


def cli_checks(device):
    """(c): ``test`` runs the bundled script at one process on the card (or
    under --cpu the CPU) and exits 0; ``env`` names the card."""
    test = cli_dispatch(["test", *(["--cpu"] if device.type == "cpu" else [])])
    if "All checks passed." not in test or "Test is a success!" not in test:
        raise RuntimeError(f"(c) test: {test[-3000:]}")
    env = cli_in_process(["env"])
    name = torch.cuda.get_device_name(0) if device.type == "cuda" else "none"
    card_names = [line for line in env.splitlines() if line.startswith("- Card names:")]
    if not card_names or name not in card_names[0]:
        raise RuntimeError(f"(c) env does not name the card {name!r}: {env}")
    return {"test_checks": test.count(" ✓"), "env_card_names": card_names[0],
            "env_power": [line for line in env.splitlines() if "power limit" in line]}


def launch_phase(device, model_name="llama-1b", seq=TRAIN_SEQ, shape=LAUNCH):
    """Phase 16: launch and the CLI, driven as a user runs them."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    report = {"model": model_name}
    try:
        with open(os.path.join(tmp, "train.py"), "w") as f:
            f.write(LAUNCH_SCRIPT)
        t0 = time.perf_counter()
        report["launched"] = launched_training(device, model_name, seq, shape, tmp)
        log(f"[time] launch (a) launched training {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        report["restart"] = supervised_restart(device, model_name, seq, shape, tmp)
        log(f"[time] launch (b) supervised restart {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        report["cli"] = cli_checks(device)
        log(f"[time] launch (c) test and env {time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    children = [report["launched"]["child"], *report["restart"]["attempts"]]
    report["children_peak_bytes"] = [c["peak_bytes"] for c in children]
    report["launches"] = {k: sum(r["launches"].get(k, 0) for r in (
        *children, report["launched"]["in_process"], report["restart"]["in_process"])) for k in launch_counts()}
    return report


# ------------------------------------------------------------ big-model inference
BIGMODEL = dict(
    model="opt-30b", prompt=1024, new=4,
    # (b) mirrors the reference's 2 x 24 GB row: 48 GiB of card for the weights.
    budget_b={0: "48GiB"},
    # (c) about 4 layers (4.9 GB) on disk: the checkout's filesystem is slow.
    budget_c={0: "40GiB", "cpu": "13.6GB"},
    llama="llama-1b", llama_prompt=1024,
    # (d) Llama-1B bf16: 7 layers on the card beside the embedding, 4 in host RAM, the rest and the head on disk.
    budget_d={0: "2GB", "cpu": "0.6GB"},
    hook_layers=2,
)
OPT_FLASH_SHAPE = dict(b=1, hq=56, s=2048, d=128)
#: The weights (flax path prefixes) phase 17 (e) also quantizes on the CPU:
#: one layer's 7 (60.8M elements, every shape of a layer), whose codes must
#: equal the card's. Not the head (262M more): its CPU codes took 12 of the
#: sub-phase's 19 s.
QUANT_CPU_CHECKED = ("params/layer_0/",)
QUANT_MODES = {"int8": dict(load_in_8bit=True), "int4": dict(load_in_4bit=True, quant_type="int4"),
               "nf4": dict(load_in_4bit=True, quant_type="nf4")}


def tier_bytes(dm):
    """Bytes placed on each tier of a `DispatchedModel` (a tied tensor once)."""
    seen, out = set(), {}
    for name, leaf in dm._leaves.items():
        if id(leaf) in seen:
            continue
        seen.add(id(leaf))
        tier = str(dm.tier_of[name])
        n = 1
        for d in leaf.shape:
            n *= d
        out[tier] = out.get(tier, 0) + n * leaf.dtype.itemsize
    return out


def bigmodel_run(dm, ids, device, new, what, reference=None, activations=None, layer_bytes=0, budget=None, base=0):
    """One layout's run: the first forward's logits (timed: TTFT), then
    `generate` of `new` tokens (seconds per token after the first, peak
    memory, K3 launches), held to `reference` (the resident run's logits and
    tokens, bit for bit) and to the memory gates."""
    n_layers = dm.module.config.num_hidden_layers
    report = {"layout": what, "resident_bytes": int(torch.cuda.memory_allocated(device) - base)
              if device.type == "cuda" else None, "tiers": tier_bytes(dm)}
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    logits = dm(ids)
    sync(device)
    report["ttft_s"] = time.perf_counter() - t0
    logits = logits.cpu()
    if not torch.isfinite(logits.float()).all():
        raise RuntimeError(f"{what}: non-finite logits")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    copies = dict(dm.transfer_stats)
    t0 = time.perf_counter()
    out = dm.generate(ids, max_new_tokens=new)
    sync(device)
    report["generate_s"] = time.perf_counter() - t0
    report["s_per_token"] = (report["generate_s"] - report["ttft_s"]) / max(new - 1, 1)
    tokens = out[:, ids.shape[1]:].cpu()
    report["tokens"] = tokens.tolist()
    report["k3_launches"] = launch_counts()["flash_fwd"]
    report["copies"] = {k: dm.transfer_stats[k] - copies[k] for k in copies}
    forwards = 1 + new
    if device.type == "cuda":
        report["peak_bytes"] = int(torch.cuda.max_memory_allocated(device) - base)
        if report["k3_launches"] != n_layers * forwards:
            raise RuntimeError(f"{what}: K3 launched {report['k3_launches']} times, expected {n_layers} x {forwards}")
    if tokens.shape != (ids.shape[0], new):
        raise RuntimeError(f"{what}: generate returned {tuple(out.shape)}")
    if reference is not None:
        report["logits_bit_for_bit"] = bool(torch.equal(logits, reference["logits"]))
        report["tokens_equal"] = report["tokens"] == reference["tokens"]
        if not report["logits_bit_for_bit"]:
            diff = (logits.float() - reference["logits"].float()).abs().max().item()
            raise RuntimeError(f"{what}: the first forward's logits differ from the resident run's (max {diff})")
        if not report["tokens_equal"]:
            raise RuntimeError(f"{what}: tokens {report['tokens']} differ from the resident run's "
                               f"{reference['tokens']}")
    if device.type == "cuda" and budget is not None:
        report["budget_bytes"] = budget
        if report["resident_bytes"] > budget:
            raise RuntimeError(f"{what}: {report['resident_bytes']} bytes on the card after dispatch, budget {budget}")
        bound = report["resident_bytes"] + 2 * layer_bytes + activations
        report["peak_bound_bytes"], report["peak_slack_bytes"] = bound, bound - report["peak_bytes"]
        if report["peak_bytes"] > bound:
            raise RuntimeError(f"{what}: peak {report['peak_bytes']} past resident + two layers + activations {bound}")
        if report["copies"]["pageable"]:
            raise RuntimeError(f"{what}: {report['copies']['pageable']} copies from unpinned host memory")
    log(f"[bigmodel] {what}: {json.dumps({k: v for k, v in report.items() if k != 'tokens'})}")
    return report, {"logits": logits, "tokens": report["tokens"]}


def host_to_device_rate(dm, device, repeats=3):
    """GB/s of a bare copy of one offloaded layer from its pinned host
    tensors to the card (CUDA events, the median of `repeats`), and the
    layer's bytes."""
    name = next(n for n, t in dm.tier_of.items() if t == "cpu" and n.startswith("layers."))
    prefix = ".".join(name.split(".")[:2]) + "."
    host = [t for n, t in dm._leaves.items() if n.startswith(prefix)]
    dst = [torch.empty_like(t, device=device) for t in host]
    nbytes = sum(t.numel() * t.element_size() for t in host)
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for d, h in zip(dst, host):
            d.copy_(h, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    del dst
    return nbytes / float(np.median(times)) / 1e9, nbytes


def overlap_share(resident_s, streamed_s, copy_s):
    """Share of the bare copy time hidden under compute: 1 when the streamed
    forward takes the resident one's time, 0 when it takes that plus the
    whole copy."""
    return (resident_s + copy_s - streamed_s) / copy_s if copy_s > 0 else None


def bigmodel_layouts(device, model, shape=BIGMODEL, offload_dir=None):
    """(a) resident, (b) under the device budget with host RAM, (c) mixed
    with disk, on one model made once; returns the report."""
    from accelerate_tpu_torch.big_modeling import dispatch_model
    from accelerate_tpu_torch.models import layered_for_model
    from accelerate_tpu_torch.utils.environment import get_available_host_memory_bytes
    from accelerate_tpu_torch.utils.modeling import compute_module_sizes, get_max_memory, infer_auto_device_map

    # What else the card holds: the layouts' bytes are counted above it.
    base = torch.cuda.memory_allocated(device) - sum(
        p.numel() * p.element_size() for p in model.parameters() if p.is_cuda) if device.type == "cuda" else 0
    vocab = model.config.vocab_size
    ids = torch.from_numpy(np.random.default_rng(17).integers(0, vocab, (1, shape["prompt"]))).to(device)
    sizes = compute_module_sizes(model)
    layer_bytes = sizes["params/layer_0"]
    report = {"model": shape["model"], "parameter_bytes": sizes[""], "layer_bytes": layer_bytes,
              "prompt": shape["prompt"], "new_tokens": shape["new"],
              "host_mem_available_bytes": get_available_host_memory_bytes()}
    layered = layered_for_model(model)

    # (a) Every block on the card: the module's own forward.
    t0 = time.perf_counter()
    dm = dispatch_model(model, {"": 0}, device=device)
    sync(device)
    report["a"], reference = bigmodel_run(dm, ids, device, shape["new"], "(a) resident", base=base)
    report["a"]["dispatch_s"] = time.perf_counter() - t0 - report["a"]["generate_s"] - report["a"]["ttft_s"]
    activations = report["a"].get("peak_bytes", 0) - (report["a"]["resident_bytes"] or 0)
    report["activation_bytes"] = activations

    # (b) The device budget, the rest pinned in host RAM.
    unbounded = infer_auto_device_map(model, {**shape["budget_b"], "cpu": float("inf")})
    cpu_need = sum(sizes[b] for b, t in unbounded.items() if t == "cpu")
    report["b_cpu_tier_bytes"] = cpu_need
    if cpu_need > report["host_mem_available_bytes"]:
        raise RuntimeError(f"(b) the host tier needs {cpu_need} bytes; MemAvailable is "
                           f"{report['host_mem_available_bytes']}")
    budget = {**shape["budget_b"], "cpu": report["host_mem_available_bytes"]}
    device_map = infer_auto_device_map(model, budget)
    if "disk" in device_map.values():
        raise RuntimeError(f"(b) the map sends blocks to disk: {device_map}")
    del dm
    free_memory(device)
    t0 = time.perf_counter()
    dm = dispatch_model(model, device_map, layered=layered, device=device)
    sync(device)
    dispatch_s = time.perf_counter() - t0
    run, _ = bigmodel_run(dm, ids, device, shape["new"], "(b) cpu offload", reference, activations, layer_bytes,
                          get_max_memory(shape["budget_b"])[0], base)
    run["dispatch_s"] = dispatch_s
    run["layers_on"] = {t: sum(1 for b, v in device_map.items() if b.startswith("params/layer_") and v == t)
                        for t in set(device_map.values())}
    if device.type == "cuda":
        rate, nbytes = host_to_device_rate(dm, device)
        run["h2d_gb_per_s"] = rate
        offloaded = run["tiers"].get("cpu", 0)
        run["copy_s_per_forward"] = offloaded / rate / 1e9
        run["overlap_share"] = overlap_share(report["a"]["s_per_token"], run["s_per_token"],
                                             run["copy_s_per_forward"])
        run["streamed_gb_per_s"] = offloaded / run["s_per_token"] / 1e9
    report["b"] = run
    log(f"[bigmodel] (b) dispatch {dispatch_s:.2f}s, layers {run['layers_on']}, "
        f"h2d {run.get('h2d_gb_per_s')} GB/s, overlap share {run.get('overlap_share')}")

    # Back on the card whole, then (c): a smaller budget, a little host RAM, the rest on disk.
    model.load_state_dict(dm.materialize_params(), assign=True)
    del dm
    free_memory(device)
    device_map = infer_auto_device_map(model, {**shape["budget_c"], "disk": float("inf")})
    t0 = time.perf_counter()
    dm = dispatch_model(model, device_map, offload_folder=offload_dir, layered=layered, device=device)
    sync(device)
    dispatch_s = time.perf_counter() - t0
    store = dm._disk_store
    disk_names = [n for n, t in dm.tier_of.items() if t == "disk"]
    t0 = time.perf_counter()
    for name in disk_names:
        store.read(name)
    read_s = time.perf_counter() - t0
    run, _ = bigmodel_run(dm, ids, device, shape["new"], "(c) cpu and disk", reference, activations, layer_bytes,
                          get_max_memory(shape["budget_c"])[0], base)
    run.update(dispatch_s=dispatch_s, disk_write_s=store.write_seconds, disk_bytes=store.bytes_written,
               disk_read_gb_per_s=store.bytes_written / read_s / 1e9, disk_read_s=read_s,
               disk_filesystem=filesystem(offload_dir),
               layers_on={t: sum(1 for b, v in device_map.items() if b.startswith("params/layer_") and v == t)
                          for t in set(device_map.values())})
    if device.type == "cuda":
        run["copy_s_per_forward"] = (run["tiers"].get("cpu", 0) + run["tiers"].get("disk", 0)) / (
            report["b"]["h2d_gb_per_s"] * 1e9)
        run["overlap_share"] = overlap_share(report["a"]["s_per_token"], run["s_per_token"],
                                             run["copy_s_per_forward"])
    if "disk" not in device_map.values() or "cpu" not in device_map.values():
        raise RuntimeError(f"(c) the map is not mixed: {device_map}")
    report["c"] = run
    log(f"[bigmodel] (c) dispatch {dispatch_s:.2f}s (disk write {store.write_seconds:.2f}s for "
        f"{store.bytes_written} bytes), layers {run['layers_on']}, disk read {run['disk_read_gb_per_s']:.2f} GB/s "
        "(the page cache warm from the write)")
    store.close()
    del dm, store
    model.to("meta")  # spent: the caller's reference holds no memory
    free_memory(device)
    return report


def bigmodel_checkpoint(device, model_name, shape, tmp):
    """(d) `save_model` of Llama-1B bf16, loaded by
    `load_checkpoint_and_dispatch` onto an empty model with budgets that
    send blocks to host RAM and disk: logits bit for bit; then
    `cpu_offload_with_hook` on two chained models."""
    from accelerate_tpu_torch import Accelerator, create_named_model
    from accelerate_tpu_torch.big_modeling import init_empty_weights, load_checkpoint_and_dispatch
    from accelerate_tpu_torch.hooks import cpu_offload_with_hook
    from accelerate_tpu_torch.models import MODEL_REGISTRY, LlamaLayeredApply, create_llama_model

    config = MODEL_REGISTRY[model_name]()
    model = create_named_model(model_name, seed=0, dtype=torch.bfloat16, device=device)
    ids = torch.from_numpy(np.random.default_rng(18).integers(0, config.vocab_size, (1, shape["llama_prompt"])))
    ids = ids.to(device)
    with torch.no_grad():
        resident = model(ids).cpu()
    directory, offload = os.path.join(tmp, "llama"), os.path.join(tmp, "llama_offload")
    reset_port_state()
    t0 = time.perf_counter()
    Accelerator(cpu=device.type == "cpu").save_model(model, directory, max_shard_size="1GB")
    report = {"save_s": time.perf_counter() - t0, "files": sorted(os.listdir(directory))}
    reset_port_state()
    t0 = time.perf_counter()
    dm = load_checkpoint_and_dispatch(init_empty_weights(config, dtype=torch.bfloat16), checkpoint=directory,
                                      max_memory=shape["budget_d"], offload_folder=offload,
                                      layered=LlamaLayeredApply(config), device=device)
    sync(device)
    report["load_dispatch_s"] = time.perf_counter() - t0
    report["tiers"] = tier_bytes(dm)
    report["parameter_bytes"] = sum(report["tiers"].values())
    report["map"] = {str(t): sum(1 for v in dm.hf_device_map.values() if v == t) for t in set(dm.hf_device_map.values())}
    if not {"cpu", "disk"} <= set(report["tiers"]):
        raise RuntimeError(f"(d) the budgets {shape['budget_d']} gave tiers {report['tiers']}")
    loaded = dm(ids).cpu()
    report["logits_bit_for_bit"] = bool(torch.equal(loaded, resident))
    report["pageable_copies"] = dm.transfer_stats["pageable"]
    if not report["logits_bit_for_bit"] or dm.transfer_stats["pageable"]:
        raise RuntimeError(f"(d) the dispatched checkpoint's logits differ from the resident model's "
                           f"(max {(loaded.float() - resident.float()).abs().max().item()}) or it copied from "
                           f"pageable memory ({dm.transfer_stats})")
    dm._disk_store.close()
    del dm, loaded

    # Two models chained: running the second sends the first's weights home.
    import dataclasses

    second = create_llama_model(dataclasses.replace(config, num_hidden_layers=shape["hook_layers"]), seed=1,
                                dtype=torch.bfloat16, device=device)
    with torch.no_grad():
        second_plain = second(ids).cpu()
    first, first_hook = cpu_offload_with_hook(model, execution_device=device)
    second, _ = cpu_offload_with_hook(second, execution_device=device, prev_module_hook=first_hook)
    with torch.no_grad():
        first_out = first(ids).cpu()
        on_device_after_first = {p.device.type for p in first.parameters()}
        second_out = second(ids).cpu()
    after = {p.device.type for p in first.parameters()}
    report["hooks"] = {"first_on": sorted(on_device_after_first), "first_after_second": sorted(after),
                       "first_bit_for_bit": bool(torch.equal(first_out, resident)),
                       "second_bit_for_bit": bool(torch.equal(second_out, second_plain))}
    if after != {"cpu"} or not report["hooks"]["first_bit_for_bit"] or not report["hooks"]["second_bit_for_bit"]:
        raise RuntimeError(f"(d) hooks: {report['hooks']}")
    log(f"[bigmodel] (d) {json.dumps(report)}")
    del first, second, model
    free_memory(device)
    return report


def bigmodel_quantization(device, model_name):
    """(e) `load_and_quantize_model` on Llama-1B bf16 in int8, int4 and nf4:
    the codes and scales made on the card equal the CPU's bit for bit (for
    the weights of QUANT_CPU_CHECKED), and the bytes the quantized model
    holds (its codes' and scales' storage, its dense tensors) equal
    `quantized_nbytes`; the allocator's change is reported beside them."""
    from accelerate_tpu_torch import create_named_model
    from accelerate_tpu_torch.utils.modeling import flax_leaves
    from accelerate_tpu_torch.utils.quantization import (
        QuantizationConfig,
        is_quant_entry,
        load_and_quantize_model,
        quantize_params,
        quantized_nbytes,
    )

    report = {}
    host = None
    for mode, kw in QUANT_MODES.items():
        model = create_named_model(model_name, seed=0, dtype=torch.bfloat16, device=device)
        if host is None:  # the checked weights on the host, in JAX's layout
            host = {path: p.detach().permute(dims).contiguous().cpu() for path, _, p, dims in flax_leaves(model)
                    if path.startswith(QUANT_CPU_CHECKED)}
        config = QuantizationConfig(**kw)
        sync(device)
        before = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
        quantized_weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters() if p.dim() >= 2)
        t0 = time.perf_counter()
        qmodel = load_and_quantize_model(model, config)
        sync(device)
        row = {"seconds": time.perf_counter() - t0}
        t0 = time.perf_counter()
        on_cpu = quantize_params(host, config)
        row["cpu_seconds"] = time.perf_counter() - t0
        entries = [k for k, v in qmodel.qparams.items() if is_quant_entry(v)]
        checked = [k for k in on_cpu if is_quant_entry(on_cpu[k])]
        equal = bool(checked) and all(torch.equal(qmodel.qparams[k].q.cpu(), on_cpu[k].q)
                                      and torch.equal(qmodel.qparams[k].scale.cpu(), on_cpu[k].scale)
                                      for k in checked)
        dense = sum(v.numel() * v.element_size() for v in qmodel.qparams.values() if not is_quant_entry(v))
        held = dense + sum(t.untyped_storage().nbytes() for k in entries
                           for t in (qmodel.qparams[k].q, qmodel.qparams[k].scale))
        row.update(quantized=len(entries), cpu_checked=len(checked), codes_bit_for_bit=equal,
                   quantized_nbytes=quantized_nbytes(qmodel.qparams), held_bytes=held, dense_bytes=dense,
                   weight_bytes_before=quantized_weight_bytes)
        if device.type == "cuda":
            row["allocated_delta"] = torch.cuda.memory_allocated(device) - before
        with torch.no_grad():
            ids = torch.arange(64, device=device)[None] * 7 % model.config.vocab_size
            logits = qmodel(ids)
        row["logits_finite"] = bool(torch.isfinite(logits.float()).all())
        log(f"[bigmodel] (e) {mode}: {json.dumps(row)}")
        if not equal or not row["logits_finite"] or held != row["quantized_nbytes"]:
            raise RuntimeError(f"(e) {mode}: {row}")
        report[mode] = row
        del qmodel, model, on_cpu, logits
        free_memory(device)
    return report


def bigmodel_phase(device, shape=BIGMODEL, model=None, timed=True):
    """Phase 17: big-model inference and the offload tiers, as a user drives
    them: OPT-30B resident, under a 48 GiB budget with host RAM and over
    mixed tiers with disk; a checkpoint dispatched; hooks; quantization;
    the estimate. `model` is the OPT model when the caller made it."""
    import shutil
    import tempfile

    from accelerate_tpu_torch import create_named_model

    report = {}
    if device.type == "cuda":
        t0 = time.perf_counter()
        log(f"[flash] OPT-30B's generation shape: {json.dumps(OPT_FLASH_SHAPE)}")
        report["k3"] = flash_kernel_phase(device, OPT_FLASH_SHAPE, timed=timed, dtypes=(torch.bfloat16,),
                                          names=("flash_fwd",))
        log(f"[time] bigmodel K3 at OPT-30B's shape {time.perf_counter() - t0:.1f}s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bigmodel_")
    try:
        t0 = time.perf_counter()
        if model is None:
            model = create_named_model(shape["model"], seed=0, dtype=torch.bfloat16, device=device)
            log_model(f"[bigmodel] {shape['model']} bf16", model, t0)
        report["layouts"] = bigmodel_layouts(device, model, shape, offload_dir=os.path.join(tmp, "offload"))
        del model
        log(f"[time] bigmodel (a-c) layouts {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        report["checkpoint"] = bigmodel_checkpoint(device, shape["llama"], shape, tmp)
        log(f"[time] bigmodel (d) checkpoint and hooks {time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    report["quantization"] = bigmodel_quantization(device, shape["llama"])
    log(f"[time] bigmodel (e) quantization {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    printed = cli_in_process(["estimate-memory", shape["model"].replace("-", "_"), shape["llama"],
                              "--dtypes", "bf16"])
    from accelerate_tpu_torch.commands.estimate import gather_data

    class _Args:
        dtypes, trust_remote_code = ["bf16"], False

    totals = {name: gather_data(_Args(), name)[1][0]["total_size"] for name in (shape["model"], shape["llama"])}
    want = {shape["model"]: report["layouts"]["parameter_bytes"], shape["llama"]: report["checkpoint"]["parameter_bytes"]}
    report["estimate"] = {"bf16_totals": totals, "parameter_bytes": want, "printed": printed.splitlines()[:3]}
    if totals != want:
        raise RuntimeError(f"(f) estimate-memory's bf16 totals {totals} are not the models' bytes {want}")
    log(f"[time] bigmodel (f) estimate {time.perf_counter() - t0:.1f}s")
    return report


def bigmodel_k3_row(k3, launches):
    """The `kernels` line's row of bf16 K3 at OPT-30B's generation shape
    (batch 1, 56 heads of 128, the 2048 bucket, causal), launched by phase
    17's forwards."""
    replaces, _ = FLASH_KERNELS["flash_fwd"]
    bf16 = k3["flash_fwd"]["bfloat16"]
    return {
        "name": "flash_fwd_opt30b", "route": "cuda", "source": FLASH_SOURCE, "replaces": replaces,
        "launches": launches, "max_abs_err": bf16["max_abs_err"],
        "tolerance": bf16["errors"]["o"]["tolerance"], "errors": bf16["errors"],
        "ms": bf16["ms"], "kernel_ms": bf16["ms"], "device_ms": bf16["device_ms"],
        "library_device_ms": bf16["library_device_ms"], "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
        "library_call": "F.scaled_dot_product_attention(is_causal=True)", "dtype": "bfloat16",
        "shape": dict(OPT_FLASH_SHAPE, causal=True),
        "design": FLASH_DESIGN["flash_fwd"] + " At D 128 on OPT-30B's big-model generate (phase 17).",
    }


# ------------------------------------------------------------------ phase 18: training past the card
OFFLOAD_TRAIN = dict(model="gptj-6b", parity_layers=1, parity_steps=2, batch=1, warmup=1, timed_steps=2,
                     # None: the model's full depth (GPT-J-6B's 28 layers).
                     layers=None, copy_bytes=1 << 30)
#: Phase 18 (a)'s runs, each against the first.
OFFLOAD_RUNS = ("resident", "optimizer_state", "cpu_offload", "disk", "deepspeed_nvme")
#: Phase 18 (b): the reference's ZeRO-Offload config.
ZERO_OFFLOAD_CONFIG = {"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}}


def host_memory():
    """MemTotal and MemAvailable of the host (/proc/meminfo), in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(value.split()[0]) * 1024
    return out


def offload_accelerator_kw(run, directory):
    """The `Accelerator` arguments of phase 18 (a)'s `run`."""
    from accelerate_tpu_torch import DeepSpeedPlugin, FullyShardedDataParallelPlugin

    return {
        "resident": {},
        "optimizer_state": {"fsdp_plugin": FullyShardedDataParallelPlugin(offload_optimizer_state=True)},
        "cpu_offload": {"fsdp_plugin": FullyShardedDataParallelPlugin(cpu_offload=True)},
        "disk": {"fsdp_plugin": FullyShardedDataParallelPlugin(offload_optimizer_device="disk",
                                                               offload_dir=directory)},
        "deepspeed_nvme": {"deepspeed_plugin": DeepSpeedPlugin(hf_ds_config={
            "zero_optimization": {"stage": 2, "offload_optimizer": {"device": "nvme"}}})},
    }[run]


def copy_rates(device, nbytes):
    """GB/s of a bare copy of `nbytes` between host memory and the card,
    each way (CUDA events, the median of 3 after one unmeasured): from a
    tensor of torch's pinned host allocator (phase 17's measure, ``pinned_*``)
    and from a `HostArena` (the tiers' own registered memory, ``arena_*``)."""
    from accelerate_tpu_torch.utils.offload import HostArena

    on_card = device.type == "cuda"
    arena = HostArena([("x", (nbytes,), torch.uint8)], pin=on_card)  # registered while it lives
    hosts = {"pinned": torch.empty(nbytes, dtype=torch.uint8, pin_memory=on_card), "arena": arena.views["x"]}
    dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
    out = {}
    for (kind, host), (way, flip) in itertools.product(hosts.items(), (("h2d", False), ("d2h", True))):
        dst, src = (host, dev) if flip else (dev, host)
        times = []
        for _ in range(4):
            if device.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                dst.copy_(src, non_blocking=True)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                dst.copy_(src)
                times.append(time.perf_counter() - t0)
        out[f"{kind}_{way}_gb_s"] = nbytes / float(np.median(times[1:])) / 1e9
    if on_card:
        # Both ways at once, each on a stream of its own (the offloaded
        # update's pattern): the bytes of both over the wall time.
        back = HostArena([("x", (nbytes,), torch.uint8)], pin=True)
        dev2 = torch.empty_like(dev)
        streams = (torch.cuda.Stream(device), torch.cuda.Stream(device))
        times = []
        for _ in range(4):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            with torch.cuda.stream(streams[0]):
                dev.copy_(arena.views["x"], non_blocking=True)
            with torch.cuda.stream(streams[1]):
                back.views["x"].copy_(dev2, non_blocking=True)
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        out["arena_duplex_gb_s"] = 2 * nbytes / float(np.median(times[1:])) / 1e9
    return out


def store_read_rate(tier):
    """GB/s of reading every entry of a disk tier's store once into its
    pinned staging buffers, a group at a time (warm: the page cache holds
    what the steps wrote)."""
    t0, nbytes = time.perf_counter(), 0
    for k in range(len(tier.groups)):
        for (i, key), view in tier._views(k).items():
            tier.store.read(tier.name(i, key), out=view)
            nbytes += view.numel() * view.element_size()
    return nbytes / (time.perf_counter() - t0) / 1e9, nbytes


def offload_train(device, config, accelerator_kw, rows, steps, masters=False):
    """`steps` bf16 steps of `config` (random weights from seed 0, AdamW with
    `foreach=True`, clip 1.0) through `Accelerator(mixed_precision="bf16",
    **accelerator_kw).train_step()` on one repeated batch `rows`: per-step
    losses and seconds, each update's seconds (the device synchronised
    around it), the tier's bytes moved a step, peak memory, flash launches;
    with `masters`, the f32 masters after the last update on the host."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import CREATE_BY_FAMILY
    from accelerate_tpu_torch.ops import flash_attention as fa

    reset_port_state()
    free_memory(device)
    t0 = time.perf_counter()
    model = CREATE_BY_FAMILY[type(config)](config, seed=0, device=device)
    accelerator = Accelerator(mixed_precision="bf16", cpu=device.type == "cpu", **accelerator_kw)
    optimizer = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=TRAIN_BETAS, eps=TRAIN_EPS,
                                  weight_decay=TRAIN_WD, foreach=True)
    pmodel, popt = accelerator.prepare(model, optimizer)
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    sync(device)
    report = {"prepare_s": time.perf_counter() - t0, "tier": getattr(popt.offload, "tier", None),
              "offload_params": pmodel.offload_params, "parameters": pmodel.num_parameters,
              "groups": len(popt.offload.groups) if popt.offload is not None else None}
    update_s = []
    apply_update = popt._apply_update

    def timed_update():
        sync(device)
        t = time.perf_counter()
        apply_update()
        sync(device)
        update_s.append(time.perf_counter() - t)

    popt._apply_update = timed_update
    param_bytes = sum(p.numel() * p.element_size() for p in pmodel.parameters())
    batch = {"input_ids": rows}
    losses, seconds, moved = [], [], []
    fa.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(steps):
        before = dict(popt.offload.stats) if popt.offload is not None else None
        sync(device)
        t = time.perf_counter()
        loss = step_fn(batch)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t)
        tier_bytes = 0 if before is None else sum(popt.offload.stats[k] - before[k] for k in ("bytes_in", "bytes_out"))
        if before is not None and popt.offload.stats["pageable"] != before["pageable"]:
            raise RuntimeError(f"phase 18: {popt.offload.stats['pageable'] - before['pageable']} of the tier's copies "
                               "ran from pageable host memory")
        moved.append(tier_bytes + (2 * param_bytes if pmodel.offload_params else 0))
    report.update(losses=losses, step_s=seconds, update_s=update_s, bytes_moved_per_step=moved,
                  launches=dict(fa.LAUNCHES))
    if device.type == "cuda":
        report["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    if masters:
        report["masters"] = {k: v.detach().to("cpu", copy=True) for k, v in pmodel.full_state_dict().items()}
    if report["tier"] == "disk":
        tier = popt.offload
        store = tier.store
        report["store_write_gb_s"] = store.bytes_written / store.write_seconds / 1e9 if store.write_seconds else None
        report["store_read_gb_s"], report["store_bytes"] = store_read_rate(tier)
        report["store_dir"] = tier.directory
        tier.close()
    del pmodel, popt, step_fn, accelerator, model, optimizer
    reset_port_state()
    free_memory(device)
    return report


def offload_parity(device, config, shape, seq):
    """Phase 18 (a): every tier against the resident run, at full width
    cut to `shape["parity_layers"]` layers: the same 2 steps, the losses
    and the masters after the second update bit for bit."""
    import dataclasses
    import shutil
    import tempfile

    config = dataclasses.replace(config, num_hidden_layers=shape["parity_layers"])
    rows = torch.as_tensor(np.random.default_rng(18).integers(0, config.vocab_size, (shape["batch"], seq)),
                           device=device)
    directory = tempfile.mkdtemp(prefix="chip_smoke_offload_")
    runs, reference = {}, None
    try:
        for run in OFFLOAD_RUNS:
            report = offload_train(device, config, offload_accelerator_kw(run, os.path.join(directory, run)),
                                   rows, shape["parity_steps"], masters=True)
            masters = report.pop("masters")
            if reference is None:
                reference = (report["losses"], masters)
            else:
                report["losses_bit_for_bit"] = ([float.hex(x) for x in report["losses"]]
                                                == [float.hex(x) for x in reference[0]])
                report["masters_mismatched"] = sorted(k for k, v in masters.items()
                                                      if not torch.equal(v, reference[1][k]))
            del masters
            if device.type == "cuda" and report["launches"] != expected_launches(
                    config.num_hidden_layers * shape["parity_steps"], torch.bfloat16):
                raise RuntimeError(f"phase 18 (a) {run}: flash launches {report['launches']}")
            log(f"[offload] (a) {run} {json.dumps(report)}")
            runs[run] = report
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    for run, report in runs.items():
        if run == "resident":
            continue
        if not report["losses_bit_for_bit"] or report["masters_mismatched"]:
            raise RuntimeError(f"phase 18 (a) {run}: losses {report['losses']} against the resident "
                               f"{runs['resident']['losses']}, masters mismatched {report['masters_mismatched'][:5]}")
        if "store_dir" in report and os.path.exists(report["store_dir"]) and run == "deepspeed_nvme":
            raise RuntimeError(f"phase 18 (a) {run}: the tier left its store behind in {report['store_dir']}")
    if not all(np.isfinite(runs["resident"]["losses"])):
        raise RuntimeError(f"phase 18 (a): resident losses {runs['resident']['losses']}")
    return {"layers": config.num_hidden_layers, "batch": shape["batch"], "seq": seq, "runs": runs}


def past_the_card(device, config, shape, seq, copy):
    """Phase 18 (b): GPT-J-6B at full width and depth through the
    reference's ZeRO-Offload config (stage 2, the optimizer's state in
    pinned host RAM), at one process."""
    import dataclasses

    from accelerate_tpu_torch import DeepSpeedPlugin
    from accelerate_tpu_torch.utils.modeling import compute_module_sizes

    if shape["layers"] is not None:
        config = dataclasses.replace(config, num_hidden_layers=shape["layers"])
    from accelerate_tpu_torch.big_modeling import init_empty_weights

    skeleton = init_empty_weights(config)
    f32 = compute_module_sizes(skeleton)[""]
    bf16 = compute_module_sizes(skeleton, dtype=torch.bfloat16)[""]
    params = sum(p.numel() for p in skeleton.parameters())
    del skeleton
    reckoning = {"f32_masters": f32, "f32_grads": f32, "bf16_copies": bf16, "f32_moments": 2 * f32,
                 "resident_bytes": 4 * f32 + bf16, "offloaded_bytes": 2 * f32 + bf16}
    card = torch.cuda.get_device_properties(device).total_memory if device.type == "cuda" else None
    host = host_memory()
    log(f"[offload] (b) {config.num_hidden_layers} layers, {params:,} parameters; reckoning "
        f"{json.dumps(reckoning)}; card {card} bytes; host {json.dumps(host)}")
    if host["MemAvailable"] < 2 * f32 + (1 << 30):
        raise RuntimeError(f"phase 18 (b): the host has {host['MemAvailable']} bytes available, the moments "
                           f"need {2 * f32} pinned")
    rows = torch.as_tensor(np.random.default_rng(18).integers(0, config.vocab_size, (shape["batch"], seq)),
                           device=device)
    steps = shape["warmup"] + shape["timed_steps"]
    report = offload_train(device, config, {"deepspeed_plugin": DeepSpeedPlugin(hf_ds_config=ZERO_OFFLOAD_CONFIG)},
                           rows, steps)
    warm = shape["warmup"]
    step_s = float(np.median(report["step_s"][warm:]))
    update = float(np.median(report["update_s"][warm:]))
    report.update(reckoning=reckoning, card_bytes=card, host=host, steps=steps, warmup=warm,
                  step_s_median=step_s, update_s_median=update, forward_backward_s_median=step_s - update,
                  update_copy_bound_s=2 * reckoning["f32_moments"] / (copy["arena_h2d_gb_s"] * 1e9),
                  update_duplex_bound_s=(2 * reckoning["f32_moments"] / (copy["arena_duplex_gb_s"] * 1e9)
                                         if "arena_duplex_gb_s" in copy else None),
                  tokens_per_s=shape["batch"] * seq / step_s,
                  mfu=6 * (params - config.vocab_size * config.hidden_size) * shape["batch"] * seq / step_s
                  / BF16_PEAK_FLOPS)
    log(f"[offload] (b) {json.dumps(report)}")
    losses = report["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"phase 18 (b): losses {losses}")
    if report["tier"] != "pinned_host" or report["offload_params"]:
        raise RuntimeError(f"phase 18 (b): the ZeRO-Offload config lowered to {report['tier']}, "
                           f"offload_params {report['offload_params']}")
    if device.type == "cuda":
        if report["launches"] != expected_launches(config.num_hidden_layers * steps, torch.bfloat16):
            raise RuntimeError(f"phase 18 (b): flash launches {report['launches']}, expected "
                               f"{config.num_hidden_layers} x {steps}")
        peak = report["peak_memory_bytes"]
        if not peak < min(card, reckoning["resident_bytes"]):
            raise RuntimeError(f"phase 18 (b): peak {peak} bytes, the card {card}, the resident reckoning "
                               f"{reckoning['resident_bytes']}")
    return report


def offload_launches(report):
    """The flash launch counts of every run of phase 18 (GPT-J-6B's D 256)."""
    runs = list(report["tiers"]["runs"].values()) + ([report["past_card"]] if "past_card" in report else [])
    return [r["launches"] for r in runs]


def offload_summary(report):
    """Phase 18's report without the per-run detail its lines printed."""
    keep = ("losses", "peak_memory_bytes", "step_s", "update_s", "bytes_moved_per_step", "store_write_gb_s",
            "store_read_gb_s")
    out = {k: v for k, v in report.items() if k not in ("tiers", "past_card")}
    out["tiers"] = {run: {k: r[k] for k in keep if k in r} for run, r in report["tiers"]["runs"].items()}
    if "past_card" in report:
        b = report["past_card"]
        out["past_card"] = {k: b[k] for k in ("losses", "peak_memory_bytes", "step_s_median", "update_s_median",
                                              "forward_backward_s_median", "update_copy_bound_s", "update_duplex_bound_s",
                                              "tokens_per_s",
                                              "mfu", "launches") if k in b}
    return out


def offload_train_phase(device, model_name=OFFLOAD_TRAIN["model"], shape=OFFLOAD_TRAIN, seq=TRAIN_SEQ,
                        past_card=True):
    """Phase 18: training past the card (the optimizer's state in pinned
    host RAM and on disk, the masters in host RAM)."""
    from accelerate_tpu_torch.models import MODEL_REGISTRY

    config = MODEL_REGISTRY[model_name]()
    report = {"model": model_name, "host": host_memory()}
    log(f"[offload] host {json.dumps(report['host'])}")
    report["copy"] = copy_rates(device, shape["copy_bytes"])
    log(f"[offload] bare pinned copy {json.dumps(report['copy'])}")
    t0 = time.perf_counter()
    report["tiers"] = offload_parity(device, config, shape, seq)
    log(f"[time] offload (a) tiers {time.perf_counter() - t0:.1f}s")
    if past_card:
        t0 = time.perf_counter()
        report["past_card"] = past_the_card(device, config, shape, seq, report["copy"])
        log(f"[time] offload (b) past the card {time.perf_counter() - t0:.1f}s")
    return report


# ------------------------------------------------------------ async and sharded checkpoints
# At 1 layer: two saves and two loads of 7.03 GB on the checkout's 9p are
# most of the phase, and phase 3 and 5 (b) hold the layers at full depth.
CHECKPOINT = dict(layers=1, batch=2, save_interval=4, overlap_steps=16, resume_steps=4)


def checkpoint_steps(shape):
    """The fused steps phase 19 takes: (a)'s on its first accelerator, the
    one after the signal, (c)'s on both accelerators."""
    return shape["save_interval"] + shape["overlap_steps"] + 1 + 2 * shape["resume_steps"]


def host_state(pmodel, optimizer):
    """A host copy of the masters and of every tensor of the optimizer's
    state (whole: a sharded layout's are gathered)."""
    from accelerate_tpu_torch.checkpointing import tensor_leaves

    state = {f"model/{k}": v.detach().to("cpu", copy=True) for k, v in pmodel.full_state_dict().items()}
    state.update({f"optimizer/{k}": v.detach().to("cpu", copy=True)
                  for k, v in tensor_leaves(optimizer.state_dict()["state"])})
    return state


def checkpoint_accelerator(device, config, seed, **kwargs):
    """A fresh bf16 `Accelerator` with `kwargs`, over a Llama model of
    `config` (random weights from `seed`) and AdamW: (accelerator,
    prepared model, optimizer, fused step)."""
    from accelerate_tpu_torch import Accelerator, create_llama_model

    reset_port_state()
    model = create_llama_model(config, seed=seed, device=device)
    accelerator = Accelerator(mixed_precision="bf16", cpu=device.type == "cpu", **kwargs)
    optimizer = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=TRAIN_BETAS, eps=TRAIN_EPS,
                                  weight_decay=TRAIN_WD)
    pmodel, optimizer = accelerator.prepare(model, optimizer)
    return accelerator, pmodel, optimizer, accelerator.train_step(max_grad_norm=1.0)


class _CheckpointRun:
    """The first accelerator of phase 19 and what its steps and saves
    measured."""

    def __init__(self, device, accelerator, pmodel, optimizer, step_fn, batch):
        self.device, self.accelerator, self.pmodel, self.optimizer = device, accelerator, pmodel, optimizer
        self.step_fn, self.batch = step_fn, batch
        self.losses, self.step_s = [], []

    def step(self):
        sync(self.device)
        t0 = time.perf_counter()
        self.losses.append(float(self.step_fn(self.batch)))
        self.step_s.append(time.perf_counter() - t0)

    def charged(self):
        return self.accelerator.timeline.goodput()["lost_s"].get("checkpoint", 0.0)


def checkpoint_async(run, shape, report):
    """Phase 19 (a): `maybe_save_state(sharded=True)` after each step; the
    save after step `save_interval` goes to the committer, and the run steps
    on (polling) while it commits. Returns the host copy of the state it
    saved."""
    acc = run.accelerator
    path = None
    for i in range(shape["save_interval"]):
        run.step()
        if i + 1 == shape["save_interval"]:
            expected = host_state(run.pmodel, run.optimizer)  # right after the step, before the save
            charged_before = run.charged()
        path = acc.maybe_save_state(sharded=True) or path
    if path is None:
        raise RuntimeError(f"maybe_save_state() saved nothing in {shape['save_interval']} steps")
    report.update(path=path, checkpoint=os.path.basename(path), blocking_s=run.charged() - charged_before,
                  staging_setup_s=acc._host_staging.setup_s, staging_bytes=acc._host_staging.nbytes,
                  in_flight_gauge_during=acc.telemetry.value("checkpoint_commits_in_flight"))
    report["commit_in_flight"] = []
    for _ in range(shape["overlap_steps"]):
        run.step()
        acc.poll_async_checkpoint()
        report["commit_in_flight"].append(acc._async_committer.in_flight)
    # Still committing: the ledger holds the blocking seconds and nothing of the commit.
    report["charged_while_committing_s"] = run.charged() - charged_before
    report["charged_before"] = charged_before
    return expected


def checkpoint_preemption(run, base, report):
    """Phase 19 (b): SIGTERM while (a)'s commit is in flight; after the
    next step `check_preemption()` drains it and saves synchronously under
    `base`."""
    import signal

    acc = run.accelerator
    handler = acc.register_preemption_checkpoint(base, exit_on_save=False)
    if not handler.installed:
        raise RuntimeError("the SIGTERM latch could not be installed (not on the main thread)")
    try:
        report["commit_in_flight_at_signal"] = acc._async_committer.in_flight
        os.kill(os.getpid(), signal.SIGTERM)
        report["latched"] = acc.preemption_requested
        run.step()
        saved_before = acc._m_ckpt_seconds.sum
        t0 = time.perf_counter()
        report["returned"] = acc.check_preemption()
        report["check_preemption_s"] = time.perf_counter() - t0
        report["sync_save_s"] = acc._m_ckpt_seconds.sum - saved_before
        report["drain_s"] = report["check_preemption_s"] - report["sync_save_s"]
    finally:
        handler.uninstall()
    from accelerate_tpu_torch.checkpointing import CheckpointManager

    report["path"] = CheckpointManager(base).checkpoints()[-1][1]  # verified by (c)'s load
    report["preemption"] = os.path.basename(report["path"])
    report["bytes"] = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(report["path"]) for f in fs)


def checkpoint_warm_abort(run, report):
    """A later async save, the host buffers kept: its blocking seconds; then
    `abort_async_checkpoint()`, which stops the commit before it publishes."""
    acc = run.accelerator
    charged_before = run.charged()
    t0 = time.perf_counter()
    path = acc.save_state(sharded=True)  # (a)'s kind of save, into (a)'s buffers
    report["call_s"] = time.perf_counter() - t0
    report["blocking_s"] = run.charged() - charged_before
    report["staging_setup_s"] = acc._host_staging.setup_s
    t0 = time.perf_counter()
    error = acc.abort_async_checkpoint()
    report["abort_s"] = time.perf_counter() - t0
    report["abort_error"] = type(error).__name__ if error is not None else None
    report["published"] = os.path.isdir(path)
    report["in_flight_gauge_after"] = acc.telemetry.value("checkpoint_commits_in_flight")


def checkpoint_sharded_load(device, config, path, expected, report):
    """Phase 19 (d): a FULL_SHARD accelerator at world 1 loads (a)'s sharded
    checkpoint; returns its gathered masters and moments."""
    from accelerate_tpu_torch.checkpointing import SHARD_DONE_NAME, shard_host_dir

    host = os.path.join(path, shard_host_dir(0))
    with open(os.path.join(path, "MANIFEST.json")) as f:
        report["manifest_sharded"] = json.load(f).get("sharded")
    with open(os.path.join(host, SHARD_DONE_NAME)) as f:
        report["shard_done"] = json.load(f)
    report["host_files"] = sorted(os.listdir(host))
    with world_one_group(device):
        report["backend"] = torch.distributed.get_backend()
        accelerator, pmodel, optimizer, _ = checkpoint_accelerator(device, config, seed=2,
                                                                   **dist_accelerator_kw("FULL_SHARD"))
        report["fsdp"] = pmodel.layout is not None and pmodel.layout.uses_fsdp
        t0 = time.perf_counter()
        accelerator.load_state(path)  # verifies the directory against its digests
        sync(device)
        report["load_s"] = time.perf_counter() - t0
        gathered = host_state(pmodel, optimizer)
        del accelerator, pmodel, optimizer
    report["mismatched"] = sorted(k for k, v in expected.items() if not torch.equal(gathered.get(k, v.new_empty(0)), v))
    report["verified"] = True


def checkpoint_phase(device, model_name="llama-1b", shape=CHECKPOINT, seq=TRAIN_SEQ):
    """Phase 19: async and sharded checkpoints and preemption on Llama-1B
    at full width cut to `shape["layers"]` layers, bf16 with f32 masters."""
    import dataclasses
    import shutil
    import tempfile

    from accelerate_tpu_torch.checkpointing import SHARD_DONE_NAME, shard_host_dir
    from accelerate_tpu_torch.models import MODEL_REGISTRY
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.utils import ProjectConfiguration

    config = dataclasses.replace(MODEL_REGISTRY[model_name](), num_hidden_layers=shape["layers"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_checkpoint_")
    base = os.path.join(tmp, "checkpoints")
    rows = np.random.default_rng(0).integers(0, config.vocab_size, (shape["batch"], seq)).astype(np.int64)
    batch = {"input_ids": torch.as_tensor(rows, device=device)}
    report = {"model": model_name, "layers": shape["layers"], "batch": shape["batch"], "seq": seq,
              "filesystem": filesystem(tmp), "a": {}, "b": {}, "warm": {}, "c": {}, "d": {}}
    a, b, warm, c, d = (report[k] for k in ("a", "b", "warm", "c", "d"))
    built = []
    listener = _build.add_build_listener(lambda name, seconds: built.append(name))
    reset_launch_counts()
    try:
        t0 = time.perf_counter()
        # The checkpoints' base is the project's: the preemption's save lands beside (a)'s.
        run = _CheckpointRun(device, *checkpoint_accelerator(
            device, config, seed=0, async_save=True, save_interval=shape["save_interval"],
            project_config=ProjectConfiguration(project_dir=tmp, automatic_checkpoint_naming=True, total_limit=2)),
            batch)
        report["parameters"] = sum(p.numel() for p in run.pmodel.module.parameters())
        expected = checkpoint_async(run, shape, a)
        log(f"[time] checkpoint (a) async save and overlapped steps {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        checkpoint_preemption(run, base, b)
        live = host_state(run.pmodel, run.optimizer)  # the state at the drain
        a["equal_to_live_at_drain"] = sorted(k for k in expected if torch.equal(live[k], expected[k]))
        del live
        acc = run.accelerator
        a["in_flight_gauge_after"] = acc.telemetry.value("checkpoint_commits_in_flight")
        a["commit_s"], a["commits"] = acc._m_ckpt_commit_seconds.sum, acc._m_ckpt_commit_seconds.count
        a["charged_after_preemption_s"] = run.charged() - a.pop("charged_before")
        stamp = lambda p: os.stat(os.path.join(p, "MANIFEST.json")).st_mtime_ns  # noqa: E731
        b["inflight"] = a["checkpoint"]
        b["inflight_published_first"] = stamp(a["path"]) <= stamp(b["path"]) and a["path"] != b["path"]
        log(f"[checkpoint] (b) {json.dumps(b)}")
        log(f"[time] checkpoint (b) preemption {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        for _ in range(shape["resume_steps"]):
            run.step()
        c["uncut_losses"] = run.losses[-shape["resume_steps"]:]
        checkpoint_warm_abort(run, warm)
        log(f"[checkpoint] warm save, aborted {json.dumps(warm)}")
        n = shape["save_interval"]
        during = [s for s, open_ in zip(run.step_s[n:n + shape["overlap_steps"]], a["commit_in_flight"]) if open_]
        a.update(losses=run.losses, step_s=run.step_s, step_ms_before_median=1e3 * float(np.median(run.step_s[1:n])),
                 step_ms_during_commit_median=1e3 * float(np.median(during)) if during else None,
                 steps_during_commit=len(during),
                 step_ms_after_median=1e3 * float(np.median(run.step_s[-shape["resume_steps"]:])))
        log(f"[checkpoint] (a) {json.dumps({k: v for k, v in a.items() if k != 'path'})}")
        del run, acc
        free_memory(device)
        accelerator, pmodel, optimizer, step_fn = checkpoint_accelerator(device, config, seed=1)
        t1 = time.perf_counter()
        c["loaded"] = os.path.basename(str(accelerator.load_state(base)))  # its newest that verifies
        sync(device)
        c["load_s"] = time.perf_counter() - t1
        c["resumed_losses"] = [float(step_fn(batch)) for _ in range(shape["resume_steps"])]
        del accelerator, pmodel, optimizer, step_fn
        free_memory(device)
        c["max_rel_diff"] = max(abs(x - y) / abs(y) for x, y in zip(c["resumed_losses"], c["uncut_losses"]))
        c["bit_for_bit"] = c["resumed_losses"] == c["uncut_losses"]
        log(f"[checkpoint] (c) {json.dumps(c)}")
        log(f"[time] checkpoint (c) resume and the warm save {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        d["checkpoint"] = a["checkpoint"]
        checkpoint_sharded_load(device, config, a["path"], expected, d)
        del expected
        log(f"[checkpoint] (d) {json.dumps(d)}")
        log(f"[time] checkpoint (d) sharded load {time.perf_counter() - t0:.1f}s")
    finally:
        _build.remove_build_listener(listener)
        shutil.rmtree(tmp, ignore_errors=True)
        reset_port_state()
    free_memory(device)
    report["launches"] = launch_counts()
    report["builds"] = built
    report["a_blocking_over_b_sync_save"] = a["blocking_s"] / b["sync_save_s"]
    report["warm_blocking_over_b_sync_save"] = warm["blocking_s"] / b["sync_save_s"]
    gates = []
    # (a)
    if d["mismatched"]:
        gates.append(f"(a) the async checkpoint differs from the state after step {shape['save_interval']}: "
                     f"{d['mismatched'][:5]}")
    if a["equal_to_live_at_drain"]:
        gates.append(f"(a) tensors unchanged by the steps during the commit: {a['equal_to_live_at_drain'][:5]}")
    if (a["in_flight_gauge_during"], a["in_flight_gauge_after"]) != (1, 0):
        gates.append(f"(a) checkpoint_commits_in_flight read {a['in_flight_gauge_during']} during the commit and "
                     f"{a['in_flight_gauge_after']} after it (1 and 0 expected)")
    if a["commits"] != 1:
        gates.append(f"(a) checkpoint_async_commit_seconds has {a['commits']} observations, not 1")
    if (abs(a["charged_while_committing_s"] - a["blocking_s"]) > 1e-5 or not a["blocking_s"] < a["commit_s"]
            or abs(a["charged_after_preemption_s"] - a["blocking_s"] - b["sync_save_s"]) > 1e-3):
        gates.append(f"(a) the goodput ledger charged {a['charged_while_committing_s']} s while committing and "
                     f"{a['charged_after_preemption_s']} s after the preemption's save; the save blocked "
                     f"{a['blocking_s']} s, committed in {a['commit_s']} s, the sync save took {b['sync_save_s']} s")
    if not all(np.isfinite(a["losses"])):
        gates.append(f"(a) losses {a['losses']}")
    # (b): (d)'s load verified (a)'s checkpoint, (c)'s the preemption's
    if not (b["latched"] and b["returned"] is True and b["commit_in_flight_at_signal"]):
        gates.append(f"(b) SIGTERM latched {b['latched']} with a commit in flight {b['commit_in_flight_at_signal']}, "
                     f"check_preemption() returned {b['returned']!r}")
    if not b["inflight_published_first"]:
        gates.append(f"(b) {a['checkpoint']} did not publish before {b['preemption']}")
    if warm["published"] or warm["in_flight_gauge_after"] != 0:
        gates.append(f"the aborted save published ({warm['published']}) or left the gauge at "
                     f"{warm['in_flight_gauge_after']}")
    # (c)
    if c["loaded"] != b["preemption"]:
        gates.append(f"(c) load_state({base}) restored {c['loaded']}, not the preemption checkpoint {b['preemption']}")
    if not all(np.isfinite(c["uncut_losses"] + c["resumed_losses"])) or c["max_rel_diff"] > 1e-6:
        gates.append(f"(c) resumed losses {c['resumed_losses']} against {c['uncut_losses']} "
                     f"(rtol {c['max_rel_diff']}, limit 1e-6)")
    # (d)
    if d["manifest_sharded"] != {"num_hosts": 1, "hosts": [shard_host_dir(0)]}:
        gates.append(f"(d) the manifest's sharded block is {d['manifest_sharded']}")
    if d["shard_done"] != {"process_index": 0, "files": ["model.pt", "optimizer.pt"]} or SHARD_DONE_NAME not in d[
            "host_files"]:
        gates.append(f"(d) {shard_host_dir(0)} holds {d['host_files']}, SHARD_DONE {d['shard_done']}")
    if not d["fsdp"]:
        gates.append("(d) the FULL_SHARD accelerator did not place the model through fully_shard")
    want = (expected_launches(shape["layers"] * checkpoint_steps(shape), torch.bfloat16)
            if device.type == "cuda" else expected_launches(0))
    if any(report["launches"][k] != v for k, v in want.items()):
        gates.append(f"launches {report['launches']}, expected {want}")
    if built:
        gates.append(f"kernels built during the phase: {built}")
    if gates:
        raise RuntimeError("phase 19 failed: " + "; ".join(gates))
    return report


def checkpoint_summary(report):
    """Phase 19's report without the per-step lists its lines printed."""
    out = {k: v for k, v in report.items() if k != "a"}
    out["a"] = {k: v for k, v in report["a"].items() if k not in ("step_s", "losses", "commit_in_flight", "path")}
    out["b"] = {k: v for k, v in report["b"].items() if k != "path"}
    return out


# The example twins and the quality gate (phase 20).
#: Each twin with the arguments JAX's `tests/test_examples.py` gives its
#: script, the line it looks for, and whether it runs in a world-1 group.
EXAMPLE_TWINS = (
    ("by_feature.gradient_accumulation", ("--train_size", "64"), "accumulation", False),
    ("by_feature.automatic_gradient_accumulation", ("--train_size", "64", "--epochs", "1"), "effective", False),
    ("by_feature.checkpointing", ("--train_size", "64", "--epochs", "1"), "(state saved)", False),
    ("by_feature.checkpointing", ("--train_size", "64", "--epochs", "2", "--resume_from_checkpoint", "latest"),
     "resumed from", False),
    ("by_feature.cross_validation", ("--train_size", "96", "--epochs", "1", "--num_folds", "2"),
     "cross-validation mean accuracy", False),
    ("by_feature.multi_process_metrics", ("--train_size", "64", "--eval_size", "35", "--epochs", "1"), "exact count",
     False),
    ("by_feature.device_training_loop", ("--train_size", "64", "--epochs", "1"), "dispatches (steps_per_call=4)",
     False),
    ("by_feature.profiler", ("--train_size", "64"), "trace written", False),
    ("by_feature.fsdp", ("--train_size", "64"), "peak HBM", True),
    ("by_feature.schedule_free", ("--train_size", "64", "--eval_size", "32", "--epochs", "1"),
     "schedule-free eval params", False),
    ("complete_nlp_example", ("--train_size", "128", "--eval_size", "64", "--epochs", "1", "--checkpointing_steps",
                              "epoch"), "accuracy", False),
    ("complete_nlp_example", ("--train_size", "128", "--eval_size", "64", "--epochs", "2", "--checkpointing_steps",
                              "epoch", "--resume_from_checkpoint", "latest", "--with_tracking"), "resumed from", False),
    ("inference.distributed_inference", ("--num_prompts", "4", "--prompt_len", "16", "--max_new_tokens", "8"),
     "completions across", True),
    ("inference.quantized_inference", ("--bits", "8"), "at the quantized footprint", False),
    ("inference.quantized_inference", ("--bits", "4"), "at the quantized footprint", False),
)
#: The twins whose runs share an output directory (the second resumes the first).
EXAMPLE_OUTPUT_DIRS = ("by_feature.checkpointing", "by_feature.profiler", "complete_nlp_example")
#: Phase 20 (b): JAX's full recipe for "dp", its fast tier (one epoch) for "offload".
# Not "shard_grad_op" nor "full_shard", for the script's time:
# phase 14 runs both on Llama-1B in a world-1 NCCL group, a deeper run of the
# same paths, and "offload" (FULL_SHARD with the optimizer state in pinned
# host memory, in an NCCL group, which runs nowhere else) runs the gate's
# FULL_SHARD path with the tier on top.
GATE_RUNS = (("dp", ()), ("offload", ("--epochs", "1")))


class tee_stdout:
    """Copy what the block prints to stdout into `text`, and print it too."""

    def __init__(self):
        self.parts = []

    def write(self, data):
        self.parts.append(data)
        return self.stream.write(data)

    def flush(self):
        self.stream.flush()

    @property
    def text(self):
        return "".join(self.parts)

    def __enter__(self):
        self.stream, sys.stdout = sys.stdout, self
        return self

    def __exit__(self, *exc):
        sys.stdout = self.stream
        return False


def example_losses(text):
    """Every ``loss <number>`` the twin printed."""
    return [float(x) for x in re.findall(r"loss (-?[0-9.]+|nan|inf)", text)]


def run_twin(device, name, argv, output_dir=None):
    """One twin's entry point in this process on `device`: its printed text,
    seconds, result, and the devices of the models it built."""
    import importlib

    module = importlib.import_module(f"accelerate_tpu_torch.examples.{name}")
    built = []
    creator = "create_llama_model" if name.startswith("inference.") else "create_bert_model"
    create = getattr(module, creator)

    def recording(*args, **kwargs):
        model = create(*args, **kwargs)
        built.append(model)
        return model

    argv = [*argv, *(["--output_dir", output_dir] if output_dir else []), *(["--cpu"] if device.type == "cpu" else [])]
    reset_port_state()
    setattr(module, creator, recording)
    try:
        with tee_stdout() as out:
            t0 = time.perf_counter()
            args = module.parse_args(argv)
            result = module.main(args) if name.startswith("inference.") else module.training_function(args)
            sync(device)
            seconds = time.perf_counter() - t0
    finally:
        setattr(module, creator, create)
        reset_port_state()
    devices = sorted({p.device.type for m in built for p in m.parameters() if p.device.type != "meta"})
    return out.text, seconds, result, devices


def example_twins(device, twins=EXAMPLE_TWINS):
    """Phase 20 (a)."""
    import contextlib
    import shutil
    import tempfile

    directory = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    report = []
    try:
        for name, argv, marker, grouped in twins:
            output_dir = os.path.join(directory, name) if name in EXAMPLE_OUTPUT_DIRS else None
            group = world_one_group(device) if grouped else contextlib.nullcontext()
            with group:
                text, seconds, result, devices = run_twin(device, name, argv, output_dir)
            losses = example_losses(text)
            row = {"twin": name, "argv": list(argv), "marker": marker, "seconds": seconds, "losses": losses,
                   "devices": devices, "group": grouped}
            log(f"[examples] (a) {json.dumps(row)}")
            if marker not in text:
                raise RuntimeError(f"{name} {list(argv)}: {marker!r} not in its output: {text!r}")
            if not all(np.isfinite(losses)):
                raise RuntimeError(f"{name} {list(argv)}: losses {losses} not finite")
            if devices != [device.type]:
                raise RuntimeError(f"{name} {list(argv)}: its models' parameters are on {devices}, not {device.type}")
            if name.startswith("inference.") and not name.endswith("distributed_inference") \
                    and result.device.type != device.type:
                raise RuntimeError(f"{name}: generated ids on {result.device}")
            report.append(row)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    free_memory(device)
    return report


def quality_gate(device, runs=GATE_RUNS, floor=0.82):
    """Phase 20 (b)."""
    import contextlib

    from accelerate_tpu_torch.test_utils.scripts import test_performance

    report = {}
    for strategy, extra in runs:
        free_memory(device)
        full = strategy == "dp" and "--epochs" not in extra
        argv = ["--strategy", strategy, *extra, "--performance_lower_bound", str(floor) if full else "0.0",
                *(["--cpu"] if device.type == "cpu" else [])]
        backend = None
        with world_one_group(device) if strategy != "dp" else contextlib.nullcontext():
            if strategy != "dp":
                backend = torch.distributed.get_backend()
            reset_port_state()
            try:
                with tee_stdout() as out:
                    t0 = time.perf_counter()
                    result = test_performance.main(argv)
                    sync(device)
                    seconds = time.perf_counter() - t0
            finally:
                reset_port_state()
        row = dict(result, seconds=seconds, full_recipe=full, backend=backend)
        log(f"[examples] (b) {json.dumps(row)}")
        if "Performance gate passed" not in out.text:
            raise RuntimeError(f"{strategy}: the gate did not pass: {out.text!r}")
        if full and not result["accuracy"] >= floor:
            raise RuntimeError(f"{strategy}: accuracy {result['accuracy']} below {floor}")
        if not (np.isfinite(result["final_loss"]) and result["final_loss"] < 1.0):
            raise RuntimeError(f"{strategy}: final loss {result['final_loss']} not finite or not below 1.0")
        if device.type == "cuda" and strategy != "dp" and backend != "nccl":
            raise RuntimeError(f"{strategy}: backend {row['backend']}, not nccl")
        report[strategy] = row
    free_memory(device)
    return report


def examples_phase(device, twins=EXAMPLE_TWINS, gate_runs=GATE_RUNS):
    """Phase 20: the example twins and the quality gate."""
    env_before = {k: os.environ.get(k) for k in DIST_ENV}
    t0 = time.perf_counter()
    report = {"twins": example_twins(device, twins)}
    log(f"[time] examples (a) twins {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report["gate"] = quality_gate(device, gate_runs)
    log(f"[time] examples (b) gate {time.perf_counter() - t0:.1f}s")
    if {k: os.environ.get(k) for k in DIST_ENV} != env_before or torch.distributed.is_initialized():
        raise RuntimeError("phase 20 left a process group or the launcher's variables behind")
    return report


# ------------------------------------------------------------------ phase 21: convert and tensor parallel
# (b) and (c) run two ranks over gloo, both on card 0 (NCCL takes one rank a
# device): each collective is staged through the host, so the tp=2 times
# say nothing of NVLink.
# (a) converts the 2 layers and the norms at full width with the embedding
# and head cut to `convert_vocab` rows: the whole 1.29 GB file's deflated
# write passed the phase's 40 s (59.7 s at level 1, 146.8 s at zlib's 6).
# (b) serves 8 requests and (c) takes 1 warm-up and 3 timed steps: the
# script's time pays for (d) and (e) with them.
TP = dict(tp=2, convert_layers=2, convert_vocab=1024, train_layers=2, batch=2, warmup=1, timed_steps=2,
          n_requests=8, system_len=256, draft_tokens=3, timeout_s=600,
          plan_requests=8, plan_max_new=16, plan_refine_top_k=2, plan_model_steps=2, plan_data_steps=1)
#: Phase 21's parts: (a) convert, (b) serving and (c) training over the
#: family's table, (d) serving and (e) training under ``sharding_rules="auto"``,
#: (f) the other families trained over their tables.
TP_PARTS = ("a", "b", "c", "d", "e", "f")
#: Phase 21 (f): each family at its published widths ({name: its cut}; layers
#: None keeps the model's depth, T5's count is each stack's), bf16 with f32
#: masters, 1 warm-up and 2 timed steps.
TP_FAMILIES = {
    "gptj-6b": dict(layers=2, batch=1, seq=TRAIN_SEQ),
    "opt-30b": dict(layers=2, batch=1, seq=TRAIN_SEQ),
    "t0pp-11b": dict(layers=2, batch=1, seq=T5_ENC_SEQ, dec_seq=T5_DEC_SEQ),
    "bert-base": dict(layers=None, batch=32, seq=128),
}
TP_FAMILY_STEPS = dict(warmup=1, timed_steps=2)
TP_FAMILY_PARAMS = 0.6  # a rank's live parameters over tp=1's, at most
#: (f)'s norm limit where it is not `TP_NORM_RTOL`: T0pp-11B's pre-clip norm
#: starts at 532 (unscaled attention scores, clipped to 1.0). On an H100
#: (`--tp-precision-witness`) bf16 alone, at tp=1, moves that first norm by
#: 8.4e-3 of f32's, while in f32 the split's first loss and norm are tp=1's
#: within 2.6e-6; in bf16 tp=2's first norm parts from tp=1's by 2.6e-3, the
#: next two (after Adam's first steps, which part f32 runs too) by up to
#: 7.2e-3, its losses by 3.0e-3 (PERF.md). It is held to the loss limit.
TP_FAMILY_NORM_RTOL = {"t0pp-11b": 1e-2}
#: K3-K5 at (f)'s per-rank attention: {name: (shape, causal, scale, row suffix)}.
TP_FAMILY_FLASH = {
    "gptj-6b": (dict(b=1, hq=8, s=2048, d=256), True, None, "_tp2_gptj"),
    "opt-30b": (dict(b=1, hq=28, s=2048, d=128), True, None, "_tp2_opt"),
    "t0pp-11b": (dict(b=1, hq=32, s=1024, sk=2048, d=64), False, 1.0, "_tp2_t5cross"),
}
TP_PLAN_BYTES = 0.10  # JAX's round-trip bound: a rank's weight + pool bytes against the plan's prediction
TP_ZERO_SHARE = 0.55  # at data=2, a rank's moment bytes over tp=1's, at most
TP_ZERO_BYTES = 0.01  # ... and within 1% of the plan's per-chip optimizer bytes
TP_ENGINE_RUNS = {
    "bf16": {},
    "w8_int8": dict(weight_dtype="int8", kv_cache_dtype="int8"),
    "spec": dict(speculative=True),
}
# For the phase's time the int8 and speculative runs serve the first 4
# requests and decode at most 8 tokens a request (the bf16
# run all 8, 16-48 tokens): every request's prefill, first token and logits
# are still held to tp=1's.
TP_RUN_MAX_NEW = {"w8_int8": 8, "spec": 8}
TP_RUN_REQUESTS = {"w8_int8": 4, "spec": 4}
# The prefill logits of tp=2 against tp=1's, bf16 both: the largest
# difference over each request's last-position logits, relative to the
# largest |logit| of tp=1's (a row-parallel output is a sum of two bf16
# partial products, rounded where tp=1 rounds once, through every layer).
TP_LOGITS_RTOL = 0.05
TP_LOSS_RTOL = 1e-2
TP_NORM_RTOL = 1e-3
TP_FOOTPRINT = 1.6  # JAX's audit: tp=1's weight + pool bytes over a tp=2 rank's
TP_KERNEL_SHAPE = dict(KERNEL_SHAPE, hq=KERNEL_SHAPE["hq"] // 2, hkv=KERNEL_SHAPE["hkv"] // 2)
TP_FLASH_SHAPE = dict(FLASH_SHAPE, hq=FLASH_SHAPE["hq"] // 2)
TP_CONVERT_NAME = "llama-1b-convert-cut"


def cut_config(name, layers):
    """The registered config `name` cut to `layers` layers."""
    import dataclasses

    from accelerate_tpu_torch.models import MODEL_REGISTRY

    return dataclasses.replace(MODEL_REGISTRY[name](), num_hidden_layers=layers)


class prefill_logits:
    """Inside, every paged insert's last-position logits are kept, in
    admission order, as f32 CPU rows."""

    def __enter__(self):
        from accelerate_tpu_torch import generation

        self.rows, cls = [], generation.CausalPrograms
        self.original = original = cls.prefill

        def capture(programs, *args, **kwargs):
            logits = original(programs, *args, **kwargs)
            self.rows.append(logits[0, -1].float().cpu())
            return logits

        cls.prefill = capture
        return self.rows

    def __exit__(self, *exc):
        from accelerate_tpu_torch import generation

        generation.CausalPrograms.prefill = self.original
        return False


def tp_serve_runs(device, model, requests, engine_kw, **tp_kw):
    """The engine runs of phase 21 (b) on `model`: tokens, prefill logits,
    timing, K1/K2 launches, collectives and this rank's bytes, per run."""
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.parallel import tensor

    import dataclasses

    out = {}
    serve(model, requests[:2], device, **engine_kw, **tp_kw)  # warm-up: GEMM handles, allocator, the group's pairs
    for run, kw in TP_ENGINE_RUNS.items():
        cap = TP_RUN_MAX_NEW.get(run)
        reqs = [r if cap is None else dataclasses.replace(r, max_new_tokens=min(r.max_new_tokens, cap))
                for r in requests[:TP_RUN_REQUESTS.get(run, len(requests))]]
        free_memory(device)
        pa.reset_launch_counts()
        tensor.reset_collectives()
        with prefill_logits() as logits:
            engine, tokens, timing = serve(model, reqs, device, **engine_kw, **kw, **tp_kw)
        # What this process held on the card at most, the engine's build included.
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        out[run] = dict(tokens=tokens, logits=torch.stack(logits), timing=timing, launches=dict(pa.LAUNCHES),
                        collectives=dict(tensor.COLLECTIVES), weight_bytes=engine.per_device_weight_nbytes,
                        kv_bytes=engine.per_device_kv_cache_nbytes, peak_bytes=peak)
        del engine
    return out


def tp_train_run(device, config, shape, seq, accelerator_kw=None, on_host=False, sharding_rules=None, batch=None,
                 warmup=None, timed_steps=None, loader=None, mixed_precision="bf16"):
    """Phase 21 (c)'s, (e)'s and (f)'s run: `train` in bf16 with the pre-clip
    global norm of every step; returns the losses, step seconds, norms,
    K3-K5 launches, the steps' peak card memory, this rank's live optimizer
    moment bytes (step counts aside) and its dims of the moments sharded
    over the layout's ZeRO axis. `batch`, `warmup` and `timed_steps` default
    to `shape`'s; `loader` replaces the repeated token batch."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    free_memory(device)
    fa.reset_launch_counts()
    norms = []

    def record_norm(i, step_fn):
        if i == 0:
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)  # the steps' peak, after the model's placement
            clip = step_fn.optimizer.clip_grad_norm_

            def clipped(max_norm):
                norm = clip(max_norm)
                norms.append(norm.detach().float())
                return norm

            step_fn.optimizer.clip_grad_norm_ = clipped

    warmup = shape["warmup"] if warmup is None else warmup
    losses, seconds, pmodel, step_fn, _ = train(device, config, mixed_precision, batch=batch or shape["batch"],
                                                steps=shape["timed_steps"] if timed_steps is None else timed_steps,
                                                seq=seq, warmup=warmup, on_step=record_norm,
                                                accelerator_kw=accelerator_kw, on_host=on_host,
                                                sharding_rules=sharding_rules, loader=loader)
    state = step_fn.optimizer.optimizer.state
    layout = pmodel.layout
    report = dict(losses=losses, step_s=seconds, norms=[float(n) for n in norms], launches=dict(fa.LAUNCHES),
                  step_ms_median=1e3 * float(np.median(seconds[warmup:])),
                  peak_bytes=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
                  moment_bytes=sum(t.numel() * t.element_size() for entry in state.values()
                                   for t in entry.values() if torch.is_tensor(t) and t.dim() > 0),
                  param_numel=sum(p.numel() for p in pmodel.module.parameters()),
                  zero_dims={} if layout is None else {n: d for n, d in layout.opt_dims.items() if d is not None},
                  zero_axis=None if layout is None else layout.zero_axis,
                  rules=[[p, list(spec)] for p, spec in pmodel.sharding_rules or []],
                  opt_rules=[[p, list(spec)] for p, spec in pmodel.opt_sharding_rules or []])
    del pmodel, step_fn
    free_memory(device)
    return report


def family_config(name, layers):
    """`name`'s registered config cut to `layers` layers (each stack's for
    T5); None keeps its depth."""
    import dataclasses

    from accelerate_tpu_torch.models import MODEL_REGISTRY

    config = MODEL_REGISTRY[name]()
    if layers is None:
        return config
    if hasattr(config, "num_decoder_layers"):
        return t5_config(name, layers)
    return dataclasses.replace(config, num_hidden_layers=layers)


def bert_loader(config, batch, steps, seq, seed=0):
    """A `SimpleDataLoader` over one `bert_batch` of `batch` x `seq` with
    labels from numpy `seed`, repeated `steps` times."""
    from accelerate_tpu_torch import BatchSampler, SimpleDataLoader

    ids, mask, types = (t.numpy() for t in bert_batch(config, batch, seq, seed))
    labels = np.random.default_rng(seed + 1).integers(0, config.num_labels, batch)
    data = [{"input_ids": ids[i % batch], "attention_mask": mask[i % batch], "token_type_ids": types[i % batch],
             "labels": labels[i % batch]} for i in range(batch * steps)]
    return SimpleDataLoader(data, BatchSampler(range(len(data)), batch))


def flash_layers(config):
    """The layers of `config` whose attention takes K3-K5 in (f)'s setting:
    a causal decoder's every layer, T5's decoder (its cross-attention,
    unmasked), BERT's none (a padding mask at 128 tokens)."""
    if hasattr(config, "num_decoder_layers"):
        return config.num_decoder_layers
    if hasattr(config, "type_vocab_size"):
        return 0
    return config.num_hidden_layers


def family_tp_run(device, name, shape, accelerator_kw=None, on_host=False, steps=TP_FAMILY_STEPS):
    """Phase 21 (f)'s run of family `name` at `shape` (a `TP_FAMILIES`
    entry; bf16 unless it names another ``mixed_precision``): `tp_train_run`
    on its data, random weights from seed 0."""
    config = family_config(name, shape["layers"])
    n = steps["warmup"] + steps["timed_steps"]
    if hasattr(config, "num_decoder_layers"):
        loader = t5_batch_loader(config.vocab_size, shape["batch"], n, shape["seq"], shape["dec_seq"])
    elif hasattr(config, "type_vocab_size"):
        loader = bert_loader(config, shape["batch"], n, shape["seq"])
    else:
        loader = repeated_batch_loader(config.vocab_size, shape["batch"], n, shape["seq"])
    return tp_train_run(device, config, dict(shape, **steps), shape["seq"], accelerator_kw, on_host=on_host,
                        loader=loader, mixed_precision=shape.get("mixed_precision", "bf16"))


def family_tp_gates(device, shape, ranks, base, steps=TP_FAMILY_STEPS):
    """Phase 21 (f)'s gates for each family against its tp=1 run `base`:
    the ranks' losses and norms equal; losses finite and within
    `TP_LOSS_RTOL` of tp=1's at every step, norms within `TP_NORM_RTOL`
    (`TP_FAMILY_NORM_RTOL` where it names the family); a
    rank's live parameters at most `TP_FAMILY_PARAMS` of tp=1's; K3-K5
    launched `flash_layers` x steps times on each rank (on the card)."""
    out = {}
    for name, one in base.items():
        runs = [r["families"][name] for r in ranks]
        config = family_config(name, shape["families"][name]["layers"])
        want = expected_launches(flash_layers(config) * (steps["warmup"] + steps["timed_steps"]), torch.bfloat16)
        losses = [r["losses"] for r in runs]
        report = out[name] = {
            "tp1": {k: one[k] for k in ("losses", "norms", "step_ms_median", "peak_bytes", "param_numel")},
            "tp2": {k: runs[0][k] for k in ("losses", "norms", "step_ms_median", "peak_bytes", "param_numel")},
            "tp2_step_ms": [1e3 * x for x in runs[0]["step_s"]],
            "launches": [r["launches"] for r in runs],
            "loss_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(losses[0], one["losses"])),
            "norm_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(runs[0]["norms"], one["norms"])),
            "param_share": [r["param_numel"] / one["param_numel"] for r in runs],
        }
        log(f"[tp] (f) {name} {json.dumps(report)}")
        if any(l != losses[0] for l in losses[1:]) or any(r["norms"] != runs[0]["norms"] for r in runs[1:]):
            raise RuntimeError(f"(f) {name} at model=2: the ranks' losses or norms differ: {losses}")
        if not all(np.isfinite(losses[0])):
            raise RuntimeError(f"(f) {name} at model=2: losses {losses[0]} are not finite")
        if report["loss_rel_diff"] > TP_LOSS_RTOL or report["norm_rel_diff"] > TP_FAMILY_NORM_RTOL.get(name, TP_NORM_RTOL):
            raise RuntimeError(f"(f) {name} at model=2 against tp=1: {report}")
        if max(report["param_share"]) > TP_FAMILY_PARAMS:
            raise RuntimeError(f"(f) {name}: a rank holds more than {TP_FAMILY_PARAMS} of tp=1's parameters: {report}")
        if device.type == "cuda" and any(r["launches"] != want for r in runs):
            raise RuntimeError(f"(f) {name}: K3-K5 launches {report['launches']}, expected {want}")
    return out


def tp_precision_witness(device, name="t0pp-11b", families=TP_FAMILIES, shape=TP):
    """`--tp-precision-witness`: what parts `name`'s norms at model=2 from
    tp=1's in (f). The family at (f)'s cut in f32 at tp=2 (phase 21's world)
    against f32 at tp=1 (the split alone: summation order), and bf16 at
    tp=1 against f32 at tp=1 (bf16 rounding alone, no split); both
    reported as the largest relative difference of any step's loss and
    pre-clip norm."""
    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    f32 = dict(families[name], mixed_precision="no")
    split = tp_phase(device, shape=shape, timed=False, parts=("f",), families={name: f32})["family_training"][name]
    one = split["tp1"]
    bf16 = family_tp_run(device, name, families[name])
    report = {"model": name, "cut": families[name],
              "f32_tp2_vs_tp1": {k: split[k] for k in ("loss_rel_diff", "norm_rel_diff")},
              "bf16_vs_f32_tp1": {"loss_rel_diff": rel(bf16["losses"], one["losses"]),
                                  "norm_rel_diff": rel(bf16["norms"], one["norms"])},
              "f32_tp1": {k: one[k] for k in ("losses", "norms")},
              "f32_tp2": {k: split["tp2"][k] for k in ("losses", "norms")},
              "bf16_tp1": {k: bf16[k] for k in ("losses", "norms")}}
    log(f"[tp] precision witness {json.dumps(report)}")
    return report


def plan_requests(requests, shape):
    """(d)'s requests: the first of (b)'s (half of them share its system
    prompt), each decoding `plan_max_new` tokens."""
    import dataclasses

    return [dataclasses.replace(r, max_new_tokens=shape["plan_max_new"])
            for r in requests[:shape["plan_requests"]]]


def plan_serve_run(device, model, requests, engine_kw, shape):
    """Phase 21 (d) on one rank: the planned engine's run (tokens, prefill
    logits, timing, K1 launches, collectives, this rank's bytes and peak),
    its plan, each refine candidate as measured, and every rank's digest
    of the rules."""
    import hashlib

    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.parallel import tensor

    free_memory(device)
    pa.reset_launch_counts()
    tensor.reset_collectives()
    with prefill_logits() as logits:
        engine, tokens, timing = serve(model, requests, device, **engine_kw, tp=shape["tp"], sharding_rules="auto",
                                       sharding_refine_top_k=shape["plan_refine_top_k"])
    measured = [{"rules": [[p, list(spec)] for p, spec in plan.rules], "measured_s": seconds,
                 "predicted_step_s": plan.cost.step_time_s} for plan, seconds in engine.sharding_candidates or ()]
    plan = engine.sharding_plan
    rules = [[p, list(spec)] for p, spec in plan.rules]
    digest = hashlib.sha256(json.dumps(rules).encode()).hexdigest()
    digests = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(digests, digest)
    out = dict(tokens=tokens, logits=torch.stack(logits), timing=timing, launches=dict(pa.LAUNCHES),
               collectives=dict(tensor.COLLECTIVES), weight_bytes=engine.per_device_weight_nbytes,
               kv_bytes=engine.per_device_kv_cache_nbytes,
               peak_bytes=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
               rules=rules, digests=digests, candidates=measured,
               predicted_bytes=[plan.cost.per_chip_param_bytes, plan.cost.per_chip_kv_bytes],
               embedding={leaf.path: [list(leaf.spec), leaf.role] for leaf in plan.leaves
                          if leaf.path.endswith("embedding")})
    del engine
    free_memory(device)
    return out


def tp_worker(out_dir, model_name, shape, seq, engine_kw, cpu):
    """One rank of phase 21 (b) and (c): a gloo group of `shape["tp"]`
    processes that share the parent's card (or, `cpu`, the CPU). It starts
    while the parent runs tp=1, and begins its runs once the parent has
    written ``go`` into `out_dir`."""
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils import InitProcessGroupKwargs, ParallelismConfig
    from accelerate_tpu_torch import create_named_model

    builds = []
    _build.add_build_listener(lambda name, seconds: builds.append(name))
    state = PartialState(cpu=cpu, backend="gloo", share_device=True)
    device = state.device
    rank = torch.distributed.get_rank()
    go, deadline = os.path.join(out_dir, "go"), time.monotonic() + shape["timeout_s"]
    while not os.path.exists(go):
        if os.path.exists(os.path.join(out_dir, "abort")):
            raise RuntimeError("the parent's tp=1 runs failed")
        if time.monotonic() > deadline:
            raise TimeoutError("the parent never started phase 21's runs")
        time.sleep(0.05)
    # The weights tp=1 serves, made on the card from the seed, then held on
    # the host: each engine moves only this rank's split to the card.
    parts = shape.get("parts", TP_PARTS)
    report = {"rank": rank, "device": str(device), "backend": torch.distributed.get_backend()}
    accelerator_kw = dict(kwargs_handlers=[InitProcessGroupKwargs(backend="gloo")])
    if "b" in parts or "d" in parts:
        model = create_named_model(model_name, seed=0, dtype=torch.bfloat16, device=device).cpu()
        requests = make_requests(model.config.vocab_size, n=shape["n_requests"], system_len=shape["system_len"])
        if "b" in parts:
            t0 = time.perf_counter()
            report["serve"] = tp_serve_runs(device, model, requests, engine_kw, tp=shape["tp"])
            report["serve_s"] = time.perf_counter() - t0
        if "d" in parts:
            t0 = time.perf_counter()
            report["plan_serve"] = plan_serve_run(device, model, plan_requests(requests, shape), engine_kw, shape)
            report["plan_serve_s"] = time.perf_counter() - t0
        del model
    config = cut_config(model_name, shape["train_layers"])
    if "c" in parts:
        t0 = time.perf_counter()
        report["train"] = tp_train_run(device, config, shape, seq, dict(
            accelerator_kw, parallelism_config=ParallelismConfig(model=shape["tp"])), on_host=True)
        report["train_s"] = time.perf_counter() - t0
    if "f" in parts:
        t0 = time.perf_counter()
        report["families"] = {name: family_tp_run(device, name, cut, dict(
            accelerator_kw, parallelism_config=ParallelismConfig(model=shape["tp"])), on_host=True)
            for name, cut in shape["families"].items()}
        report["families_s"] = time.perf_counter() - t0
    if "e" in parts:
        t0 = time.perf_counter()
        report["plan_train"] = {
            "model": tp_train_run(device, config, shape, seq, dict(
                accelerator_kw, parallelism_config=ParallelismConfig(model=shape["tp"])), on_host=True,
                sharding_rules="auto", warmup=1, timed_steps=shape["plan_model_steps"]),
            "data": tp_train_run(device, config, shape, seq, dict(
                accelerator_kw, parallelism_config=ParallelismConfig(data=shape["tp"])), on_host=True,
                sharding_rules="auto", warmup=1, timed_steps=shape["plan_data_steps"]),
        }
        report["plan_train_s"] = time.perf_counter() - t0
    report["builds"] = builds
    reset_port_state()
    torch.save(report, os.path.join(out_dir, f"rank{rank}.pt"))


def tp_world(device, out_dir, model_name, shape, seq, engine_kw, while_starting, while_running=None):
    """`shape["tp"]` ranks of `tp_worker`, spawned once; their reports.
    `while_starting()` runs here while they start (their interpreters,
    imports and group; the launcher waits in a thread), then ``go`` lets
    them begin (``abort`` stops them if it raised); `while_running()`
    runs here while they run (its error raised once they are done)."""
    import threading

    from accelerate_tpu_torch.launchers import _launch_functions

    env = {"WORLD_SIZE": str(shape["tp"])}  # the launcher hosts the group's store
    if device.type == "cpu":
        env["ACCELERATE_TPU_USE_CPU"] = "1"
    failure = []

    def launch():
        try:
            _launch_functions(tp_worker, (out_dir, model_name, shape, seq, engine_kw, device.type == "cpu"),
                              shape["tp"], env, shape["timeout_s"], "phase 21's tensor-parallel world")
        except BaseException as e:
            failure.append(e)

    launcher = threading.Thread(target=launch, name="phase-21-launcher")
    launcher.start()
    try:
        while_starting()
    except BaseException:
        open(os.path.join(out_dir, "abort"), "w").close()
        launcher.join()
        raise
    open(os.path.join(out_dir, "go"), "w").close()
    try:
        if while_running is not None:
            while_running()
    finally:
        launcher.join()
    if failure:
        raise failure[0]
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(shape["tp"])]


def convert_run(device, model_name, layers, vocab, tmp):
    """Phase 21 (a): `model_name` cut to `layers` (and its embedding and
    head to `vocab` rows) from seed 0 in bf16 as HF safetensors
    (`save_hf_checkpoint`), `convert` to the native pytree file by the
    dispatcher's `main` in this process, loaded back, and `convert
    --direction to_hf`; each direction's seconds and MB."""
    from accelerate_tpu_torch import checkpointing, models
    from accelerate_tpu_torch.commands.accelerate_cli import main as cli_main
    from accelerate_tpu_torch.utils.hf_loading import save_hf_checkpoint
    from accelerate_tpu_torch.utils.modeling import load_safetensors_state_dict

    import dataclasses

    config = dataclasses.replace(cut_config(model_name, layers), vocab_size=vocab)
    models.MODEL_REGISTRY[TP_CONVERT_NAME] = lambda: config
    try:
        model = models.create_named_model(TP_CONVERT_NAME, seed=0, dtype=torch.bfloat16, device=device)
        state = {k: v.cpu() for k, v in model.state_dict().items()}
        del model
        hf, native, back = (os.path.join(tmp, name) for name in ("hf.safetensors", "native", "back.safetensors"))
        t0 = time.perf_counter()
        save_hf_checkpoint(state, "llama", config, hf)
        report = {"layers": layers, "vocab": vocab, "export_s": time.perf_counter() - t0,
                  "hf_mb": os.path.getsize(hf) / 1e6}
        args = ["--model_type", "llama", "--model", TP_CONVERT_NAME]
        t0 = time.perf_counter()
        cli_main(["convert", hf, native, *args])
        report["from_hf_s"] = time.perf_counter() - t0
        report["native_mb"] = os.path.getsize(native + ".npz") / 1e6
        with open(native + ".manifest.json") as f:
            manifest = json.load(f)
        report["digest_verifies"] = checkpointing.file_sha256(native + ".npz") == manifest["npz_sha256"]
        t0 = time.perf_counter()
        loaded = models.state_dict_from_flax(checkpointing.load_pytree(native), config)
        report["load_s"] = time.perf_counter() - t0
        report["mismatched"] = sorted(k for k in state if k not in loaded or not torch.equal(loaded[k], state[k]))
        t0 = time.perf_counter()
        cli_main(["convert", native, back, *args, "--direction", "to_hf"])
        report["to_hf_s"] = time.perf_counter() - t0
        report["to_hf_mb"] = os.path.getsize(back) / 1e6
        a, b = load_safetensors_state_dict(hf), load_safetensors_state_dict(back)
        report["round_trip_keys_equal"] = sorted(a) == sorted(b)
        report["round_trip_mismatched"] = sorted(k for k in a if k not in b or not torch.equal(a[k], b[k]))
    finally:
        models.MODEL_REGISTRY.pop(TP_CONVERT_NAME, None)
    return report


def first_divergences(model, requests, base, other, device):
    """For each request whose `other` tokens part from `base` (tp=1's), the
    step where they first part and tp=1's gap between its top two logits
    there (a full-context forward of tp=1's model over the prompt and
    tp=1's tokens before it); requests a run did not serve are skipped."""
    out = []
    for r in requests:
        if r.request_id not in base:
            continue
        a, b = base[r.request_id], other[r.request_id]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        ids = torch.as_tensor(np.concatenate([r.input_ids, np.asarray(a[:j], np.int64)]), device=device)[None]
        with torch.no_grad():
            top = model(ids)[0, -1].float().topk(2).values
        out.append({"request": r.request_id, "step": j, "top2_gap": float(top[0] - top[1])})
    return out


def tp_gates(name, base, ranks, tol):
    """Phase 21 (b)'s gates for one engine run; returns its report."""
    tokens = [r["serve"][name]["tokens"] for r in ranks]
    if any(t != tokens[0] for t in tokens[1:]):
        raise RuntimeError(f"tp=2 {name}: the ranks' tokens differ")
    logits = ranks[0]["serve"][name]["logits"]
    if any(not torch.equal(r["serve"][name]["logits"], logits) for r in ranks[1:]):
        raise RuntimeError(f"tp=2 {name}: the ranks' prefill logits differ")
    ref = base["logits"]
    diff = (logits - ref).abs()
    scale = float(ref.abs().max())
    limit = tol * scale
    report = {"logits_max_abs_diff": float(diff.max()), "logits_scale": scale, "logits_limit": limit,
              "logits_rms_diff_over_rms": float(diff.square().mean().sqrt() / ref.square().mean().sqrt())}
    if not torch.isfinite(logits).all() or report["logits_max_abs_diff"] > limit:
        raise RuntimeError(f"tp=2 {name}: prefill logits {report}")
    # The first token is the prefill's argmax (greedy): it must be tp=1's
    # unless tp=1's top two logits lie closer than the logits' limit.
    firsts = []
    for i, (row_ref, row) in enumerate(zip(ref, logits)):
        top = row_ref.topk(2)
        gap = float(top.values[0] - top.values[1])
        same = int(row.argmax()) == int(top.indices[0])
        firsts.append({"insert": i, "same": same, "top2_gap": gap})
        if not same and gap > limit:
            raise RuntimeError(f"tp=2 {name}: insert {i}'s first token differs from tp=1's with a top-two gap of "
                               f"{gap} > {limit}")
    report["first_tokens_equal"] = sum(f["same"] for f in firsts)
    report["first_tokens_near_tie"] = [f for f in firsts if not f["same"]]
    report["agreement"] = agreement(base["tokens"], tokens[0])
    return report


def meta_serving_plans(model_name, device, shape, engine_kw, dtype=torch.bfloat16):
    """Phase 21 (d)'s candidates as the parent plans them before the spawn:
    `plan_serving_sharding` over a `meta` model of `model_name` in the
    engine's dtype, with the engine's pool and `device`'s chip."""
    from accelerate_tpu_torch.models import MODEL_REGISTRY, MODULE_BY_CONFIG
    from accelerate_tpu_torch.parallel.planner import default_chip, plan_serving_sharding

    config = MODEL_REGISTRY[model_name]()
    with torch.device("meta"):
        model = MODULE_BY_CONFIG[type(config)](config).to(dtype)
    length = engine_kw.get("max_length") or config.max_position_embeddings
    page = engine_kw["page_size"]
    pages = -(-length // page)
    plans = plan_serving_sharding(
        model, {"model": shape["tp"]}, config, num_slots=engine_kw["num_slots"], padded_length=pages * page,
        paged=True, page_size=page, num_pages=engine_kw["num_slots"] * pages + 1, kv_cache_dtype="bf16",
        weight_dtype="bf16", chip=default_chip(device), top_k=shape["plan_refine_top_k"])
    return plans if isinstance(plans, list) else [plans]


def meta_train_plan(config, mesh, device):
    """The plan `prepare` makes under ``"auto"`` on `mesh` ({axis: size}),
    over a `meta` model of `config` in f32 (the masters): JAX's workload
    (batch 8, seq 512, f32 Adam moments) on `device`'s chip."""
    from accelerate_tpu_torch.models import MODULE_BY_CONFIG
    from accelerate_tpu_torch.parallel.planner import Workload, default_chip, plan_sharding

    with torch.device("meta"):
        model = MODULE_BY_CONFIG[type(config)](config)
    axes = tuple(a for a in ("data", "model") if mesh.get(a, 1) > 1) or ("model",)
    return plan_sharding(model, mesh, axes=axes, chip=default_chip(device),
                         workload=Workload(batch=8, seq=512, opt_bytes_per_param=8.0))


def plan_serve_gates(device, shape, ranks, base, hand, plans):
    """Phase 21 (d)'s gates against (b)'s tp=1 run `base` (its first inserts)
    and the parent's candidate `plans`; returns the report."""
    runs = [r["plan_serve"] for r in ranks]
    n = len(runs[0]["logits"])
    report = tp_gates("plan_serve", {"logits": base["logits"][:n], "tokens": base["tokens"]},
                      [{"serve": {"plan_serve": r}} for r in runs], TP_LOGITS_RTOL)
    report.pop("agreement")
    candidates = [[[p, list(spec)] for p, spec in plan.rules] for plan in plans]
    digests = runs[0]["digests"]
    report.update(
        rules_digests=digests, chosen=candidates.index(runs[0]["rules"]) if runs[0]["rules"] in candidates else None,
        candidates=[dict(c, predicted_step_s=plans[i].cost.step_time_s) for i, c in enumerate(runs[0]["candidates"])],
        embedding=runs[0]["embedding"], bytes=[[r["weight_bytes"], r["kv_bytes"]] for r in runs],
        predicted_bytes=runs[0]["predicted_bytes"], launches=[r["launches"] for r in runs],
        collectives=[r["collectives"] for r in runs],
        decode_tokens_per_s=runs[0]["timing"]["decode_tokens_per_s"],
        ttft_p50_s=runs[0]["timing"]["ttft_p50_s"])
    report["bytes_err"] = [abs(sum(b) - sum(report["predicted_bytes"])) / sum(b) for b in report["bytes"]]
    if hand is not None:
        report["hand_tp2_decode_tokens_per_s"] = hand["timing"]["decode_tokens_per_s"]
    if device.type == "cuda":
        report["peak_ratio"] = [base["peak_bytes"] / r["peak_bytes"] for r in runs]
    log(f"[tp] (d) planned engine {json.dumps(report)}")
    if len(set(digests)) != 1 or any(r["digests"] != digests for r in runs):
        raise RuntimeError(f"planned engine: the ranks hold different rules {digests}")
    if report["chosen"] is None or any([c["rules"] for c in r["candidates"]] != candidates for r in runs):
        raise RuntimeError(f"planned engine: the ranks' candidates or rules are not the parent's plans: {report}")
    if max(report["bytes_err"]) > TP_PLAN_BYTES:
        raise RuntimeError(f"planned engine: a rank's bytes part from the plan's by more than {TP_PLAN_BYTES}: {report}")
    if min(report.get("peak_ratio", [TP_FOOTPRINT])) < TP_FOOTPRINT:
        raise RuntimeError(f"planned engine: a rank holds more than 1/{TP_FOOTPRINT} of tp=1's peak: {report}")
    if any(c != report["collectives"][0] for c in report["collectives"]):
        raise RuntimeError(f"planned engine: the ranks issued different collectives {report['collectives']}")
    if device.type == "cuda" and any(n["decode"] < 1 for n in report["launches"]):
        raise RuntimeError(f"planned engine: a rank never launched K1: {report['launches']}")
    return report


def plan_train_gates(device, shape, ranks, base, plans):
    """Phase 21 (e)'s gates against (c)'s tp=1 run `base` and the parent's
    `plans` ({mesh name: plan}); returns the report."""
    report = {"tp1_step_ms_median": base["step_ms_median"]}
    for name, plan in plans.items():
        runs = [r["plan_train"][name] for r in ranks]
        losses = runs[0]["losses"]
        ref = base["losses"][:len(losses)]
        run = report[name] = {
            "losses": losses, "tp1_losses": ref, "step_ms_median": runs[0]["step_ms_median"],
            "loss_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(losses, ref)),
            "launches": [r["launches"] for r in runs], "rules": runs[0]["rules"], "opt_rules": runs[0]["opt_rules"],
            "zero_axis": runs[0]["zero_axis"], "zero_sharded": len(runs[0]["zero_dims"]),
            "moment_bytes": [r["moment_bytes"] for r in runs], "tp1_moment_bytes": base["moment_bytes"],
            "predicted_opt_bytes": plan.cost.per_chip_opt_bytes,
            "param_numel": [r["param_numel"] for r in runs], "tp1_param_numel": base["param_numel"],
        }
        run["moment_share"] = [b / base["moment_bytes"] for b in run["moment_bytes"]]
        run["moment_err"] = [abs(b - plan.cost.per_chip_opt_bytes) / b for b in run["moment_bytes"]]
        log(f"[tp] (e) planned training, {name}={shape['tp']} {json.dumps(run)}")
        if any(r["losses"] != losses for r in runs) or not all(np.isfinite(losses)):
            raise RuntimeError(f"planned training {name}: the ranks' losses differ or are not finite: {run}")
        if run["loss_rel_diff"] > TP_LOSS_RTOL:
            raise RuntimeError(f"planned training {name} against tp=1: {run}")
        if run["rules"] != [[p, list(spec)] for p, spec in plan.rules] or \
                run["opt_rules"] != [[p, list(spec)] for p, spec in plan.opt_rules]:
            raise RuntimeError(f"planned training {name}: prepare's tables are not the parent's plan: {run}")
        if name == "data":
            if run["zero_axis"] != "data" or not run["zero_sharded"] or run["param_numel"][0] != base["param_numel"]:
                raise RuntimeError(f"planned training data: the moments are not split over \"data\" alone: {run}")
            if max(run["moment_share"]) > TP_ZERO_SHARE or max(run["moment_err"]) > TP_ZERO_BYTES:
                raise RuntimeError(f"planned training data: the moment bytes part from the plan's: {run}")
        if device.type == "cuda" and any(min(n[k] for k in FLASH_KERNELS) < 1 for n in run["launches"]):
            raise RuntimeError(f"planned training {name}: a rank never launched one of K3-K5: {run['launches']}")
    return report


def tp_phase(device, model_name="llama-1b", shape=TP, seq=TRAIN_SEQ, engine_kw=None, timed=True, parts=TP_PARTS,
             families=TP_FAMILIES):
    """Phase 21: convert (a), then Llama over two tensor-parallel ranks
    sharing the card: serving (b) and training (c) over the family's table
    against tp=1, then the planner's (d) and (e), then the other families
    trained over their tables (f: `families`, {name: its cut}). `parts`
    picks which run; (d) and (e) without (b) and (c) run their tp=1
    references here."""
    import tempfile

    engine_kw = dict(ENGINE_KW if engine_kw is None else engine_kw, draft_tokens=shape["draft_tokens"])
    shape = dict(shape, parts=tuple(parts), families=dict(families) if "f" in parts else {})
    report = {"model": model_name, "tp": shape["tp"], "parts": list(parts)}
    env_before = {k: os.environ.get(k) for k in DIST_ENV}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        def convert_part():
            # (a) is host work (zlib), run here while the ranks run (b)-(e).
            t1 = time.perf_counter()
            report["convert"] = conv = convert_run(device, model_name, shape["convert_layers"],
                                                   shape["convert_vocab"], tmp)
            log(f"[tp] (a) convert {json.dumps(conv)}")
            log(f"[time] tp (a) convert, beside the world {time.perf_counter() - t1:.1f}s")
            if conv["mismatched"] or not conv["digest_verifies"] or not conv["round_trip_keys_equal"] \
                    or conv["round_trip_mismatched"]:
                raise RuntimeError(f"phase 21 (a): the converted checkpoint is not the original: {conv}")

        if timed and "b" in parts:
            t1 = time.perf_counter()
            report["kernels"] = kernel_phase(device, TP_KERNEL_SHAPE, dtypes=(torch.bfloat16,))
            report["kernels"].update(quantized_kernel_phase(device, TP_KERNEL_SHAPE, dtypes=(torch.bfloat16,),
                                                            kv_dtypes=("int8",)))
            report["flash"] = flash_kernel_phase(device, TP_FLASH_SHAPE, dtypes=(torch.bfloat16,))
            log(f"[time] tp (kernels at a rank's heads) {time.perf_counter() - t1:.1f}s")
        if timed and "f" in parts:
            t1 = time.perf_counter()
            report["family_flash"] = {}
            for name, (fshape, causal, scale, _) in TP_FAMILY_FLASH.items():
                log(f"[flash] (f) {name} at a rank's heads: {json.dumps(fshape)}, causal {causal}, scale {scale}")
                report["family_flash"][name] = flash_kernel_phase(device, fshape, causal=causal, scale=scale,
                                                                  dtypes=(torch.bfloat16,))
            log(f"[time] tp (f) kernels at the families' rank shapes {time.perf_counter() - t1:.1f}s")
        from accelerate_tpu_torch import create_named_model

        refs = {}
        train_config = cut_config(model_name, shape["train_layers"])
        if "d" in parts:
            plans = meta_serving_plans(model_name, device, shape, engine_kw)
            log(f"[tp] (d) the parent's plans: {json.dumps([plan.to_json()['rules'] for plan in plans])}")
        if "e" in parts:
            train_plans = {"model": meta_train_plan(train_config, {"data": 1, "fsdp": 1, "model": shape["tp"]}, device),
                           "data": meta_train_plan(train_config, {"data": shape["tp"], "fsdp": 1, "model": 1}, device)}

        def tp1_references():
            # tp=1 on the card while the ranks start (their runs wait for ``go``).
            t2 = time.perf_counter()
            refs["model"] = create_named_model(model_name, seed=0, dtype=torch.bfloat16, device=device)
            refs["requests"] = make_requests(refs["model"].config.vocab_size, n=shape["n_requests"],
                                             system_len=shape["system_len"])
            if "b" in parts:
                refs["serve"] = tp_serve_runs(device, refs["model"], refs["requests"], engine_kw)
            elif "d" in parts:  # the one run (d) is held to: tp=1 bf16 on (d)'s requests
                free_memory(device)
                with prefill_logits() as logits:
                    _, tokens, timing = serve(refs["model"], plan_requests(refs["requests"], shape), device,
                                              **engine_kw)
                refs["serve"] = {"bf16": dict(tokens=tokens, logits=torch.stack(logits), timing=timing,
                                              peak_bytes=torch.cuda.max_memory_allocated(device)
                                              if device.type == "cuda" else None)}
            if "c" in parts or "e" in parts:
                refs["train"] = tp_train_run(device, train_config, shape, seq)
            if "f" in parts:
                t3 = time.perf_counter()
                refs["families"] = {name: family_tp_run(device, name, cut) for name, cut in shape["families"].items()}
                log(f"[time] tp (f) tp=1 references {time.perf_counter() - t3:.1f}s")
            log(f"[time] tp (tp=1 references) {time.perf_counter() - t2:.1f}s")

        t1 = time.perf_counter()
        ranks = tp_world(device, tmp, model_name, shape, seq, engine_kw, tp1_references,
                         convert_part if "a" in parts else None)
        report["world_s"] = time.perf_counter() - t1
        log(f"[time] tp (b)-(e) tp=1, then the world of {shape['tp']} {report['world_s']:.1f}s "
            + " ".join(f"({key} {ranks[0][key]:.1f}s)" for key in ("serve_s", "train_s", "plan_serve_s", "plan_train_s",
                                                                  "families_s") if key in ranks[0]))
        model, requests, base = refs["model"], refs["requests"], refs.get("serve")

        # (b) serving
        if "b" in parts:
            serving = report["serving"] = {}
            for name in TP_ENGINE_RUNS:
                run = serving[name] = tp_gates(name, base[name], ranks, TP_LOGITS_RTOL)
                one, rank_runs = base[name], [r["serve"][name] for r in ranks]
                run["tp1_decode_tokens_per_s"] = one["timing"]["decode_tokens_per_s"]
                run["tp2_decode_tokens_per_s"] = rank_runs[0]["timing"]["decode_tokens_per_s"]
                run["tp1_ttft_p50_s"], run["tp2_ttft_p50_s"] = one["timing"]["ttft_p50_s"], rank_runs[0]["timing"]["ttft_p50_s"]
                run["footprint_ratio"] = [(one["weight_bytes"] + one["kv_bytes"]) / (r["weight_bytes"] + r["kv_bytes"])
                                          for r in rank_runs]
                run["bytes"] = {"tp1": [one["weight_bytes"], one["kv_bytes"]],
                                "tp2": [[r["weight_bytes"], r["kv_bytes"]] for r in rank_runs]}
                run["launches"] = [r["launches"] for r in rank_runs]
                run["collectives"] = [r["collectives"] for r in rank_runs]
                if device.type == "cuda":
                    run["peak_bytes"] = {"tp1": one["peak_bytes"], "tp2": [r["peak_bytes"] for r in rank_runs]}
                    run["peak_ratio"] = [one["peak_bytes"] / r["peak_bytes"] for r in rank_runs]
                if name != "w8_int8":
                    run["divergences"] = first_divergences(model, requests, one["tokens"], rank_runs[0]["tokens"],
                                                           device)
                log(f"[tp] (b) {name} {json.dumps(run)}")
                if min(run["footprint_ratio"]) < TP_FOOTPRINT or min(run.get("peak_ratio", [TP_FOOTPRINT])) < TP_FOOTPRINT:
                    raise RuntimeError(f"tp=2 {name}: a rank holds more than 1/{TP_FOOTPRINT} of tp=1's bytes: {run}")
                if any(c != run["collectives"][0] for c in run["collectives"]):
                    raise RuntimeError(f"tp=2 {name}: the ranks issued different collectives {run['collectives']}")
                key = {"bf16": "decode", "w8_int8": "decode_int8", "spec": "verify"}[name]
                if device.type == "cuda" and any(n[key] < 1 for n in run["launches"]):
                    raise RuntimeError(f"tp=2 {name}: a rank never launched its {key} kernel: {run['launches']}")
        # (d) the planned engine
        if "d" in parts:
            hand = ranks[0]["serve"]["bf16"] if "b" in parts else None
            report["plan_serving"] = plan_serve_gates(device, shape, ranks, base["bf16"], hand, plans)
        del model
        free_memory(device)
        base_train = refs.get("train")
        # (c) training
        if "c" in parts:
            losses = [r["train"]["losses"] for r in ranks]
            train_report = report["training"] = {
                "tp1": {k: base_train[k] for k in ("losses", "norms", "step_ms_median", "peak_bytes")},
                "tp2": {k: ranks[0]["train"][k] for k in ("losses", "norms", "step_ms_median", "peak_bytes")},
                "launches": [r["train"]["launches"] for r in ranks],
                "loss_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(losses[0], base_train["losses"])),
                "norm_rel_diff": max(abs(a - b) / abs(b)
                                     for a, b in zip(ranks[0]["train"]["norms"], base_train["norms"])),
            }
            log(f"[tp] (c) training {json.dumps(train_report)}")
            if any(l != losses[0] for l in losses[1:]) or any(r["train"]["norms"] != ranks[0]["train"]["norms"]
                                                               for r in ranks[1:]):
                raise RuntimeError(f"model=2 training: the ranks' losses or norms differ: {losses}")
            if not all(np.isfinite(losses[0])) or losses[0][-1] >= losses[0][0]:
                raise RuntimeError(f"model=2 training: losses {losses[0]} are not finite and falling")
            if train_report["loss_rel_diff"] > TP_LOSS_RTOL or train_report["norm_rel_diff"] > TP_NORM_RTOL:
                raise RuntimeError(f"model=2 training against tp=1: {train_report}")
            steps = shape["warmup"] + shape["timed_steps"]
            want = expected_launches(shape["train_layers"] * steps, torch.bfloat16)
            if device.type == "cuda" and any(r["train"]["launches"] != want for r in ranks):
                raise RuntimeError(f"model=2 training: K3-K5 launches {train_report['launches']}, expected {want}")
        # (e) planned training
        if "e" in parts:
            report["plan_training"] = plan_train_gates(device, shape, ranks, base_train, train_plans)
        # (f) the other families
        if "f" in parts:
            report["family_training"] = family_tp_gates(device, shape, ranks, refs["families"])
        builds = [r["builds"] for r in ranks]
        report["rank_builds"] = builds
        if any(builds):
            raise RuntimeError(f"phase 21's ranks built kernels: {builds}")
    if {k: os.environ.get(k) for k in DIST_ENV} != env_before or torch.distributed.is_initialized():
        raise RuntimeError("phase 21 left a process group or the launcher's variables behind")
    return report


def tp_summary(report):
    """Phase 21's numbers without the logits and tokens."""
    keep = dict(report)
    keep.pop("kernels", None), keep.pop("flash", None), keep.pop("family_flash", None)
    return keep


def tp_rows(report):
    """The `kernels` line's rows of K1/K2 (bf16 and int8 pools) and K3-K5 at
    a tensor-parallel rank's heads, launches summed over the ranks: K1's
    bf16 row counts (b)'s and (d)'s engines, K3-K5's (c)'s and (e)'s
    model=2 run (16 heads a rank; (e)'s data=2 run, at Llama-1B's 32, is
    counted in the training shape's rows, `tp_data_launches`)."""
    serving, training = report["serving"], report["training"]
    planned = report["plan_serving"]["launches"]
    rows = []
    for key, run in (("decode", "bf16"), ("verify", "spec"), ("decode_int8", "w8_int8"), ("verify_int8", "spec")):
        if key == "verify_int8":
            continue  # the int8 run is plain decode; no phase-21 run verifies over an int8 pool
        kind = key.partition("_")[0]
        bf16 = report["kernels"][key]["bfloat16"]
        rows.append({
            "name": f"paged_{key}_tp2", "route": "cuda", "source": SOURCE, "replaces": REPLACES[kind],
            "launches": sum(n[key] for n in serving[run]["launches"]) + sum(n[key] for n in planned),
            "max_abs_err": bf16["max_abs_err"], "tolerance": bf16["tolerance"], "ms": bf16["ms"],
            "device_ms": bf16["device_ms"], "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
            "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
            "library_call": "F.scaled_dot_product_attention over pre-gathered dense K/V (yardstick, never called by "
                            "the port)", "dtype": "bfloat16", "kv_dtype": "int8" if "int8" in key else "bfloat16",
            "shape": dict(TP_KERNEL_SHAPE, s=1 if kind == "decode" else TP_KERNEL_SHAPE["verify_s"]),
        })
    runs = training["launches"] + report["plan_training"]["model"]["launches"]
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    rows += flash_rows(report["flash"], launches, None, TP_FLASH_SHAPE, suffix="_tp2",
                       design=" (one tensor-parallel rank's 16 heads of Llama-1B's 32)")
    return rows + (tp_family_rows(report) if "family_flash" in report else [])


def tp_family_rows(report):
    """The `kernels` line's K3-K5 rows at (f)'s per-rank shapes, launches
    summed over both ranks' runs of that family."""
    rows = []
    for name, (shape, causal, scale, suffix) in TP_FAMILY_FLASH.items():
        runs = report["family_training"][name]["launches"]
        launches = {k: sum(r[k] for r in runs) for k in runs[0]}
        rows += flash_rows(report["family_flash"][name], launches, None, shape, suffix=suffix, causal=causal,
                           scale=scale, design=f" (one tensor-parallel rank's heads of {name}: {shape['hq']})")
    return rows


def tp_data_launches(report):
    """K3-K5 launches of phase 21 (e)'s data=2 run, summed over the ranks."""
    runs = report["plan_training"]["data"]["launches"]
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def paged_rows(kernels, engine, shape, design, suffix=""):
    """The `kernels` line's K1/K2 rows (unquantized and both quantized
    modes, bf16 queries) from a kernel phase at `shape` and the launches of
    the engine runs that drove them."""
    rows = []
    runs = {"decode": "plain", "verify": "speculative"}
    for key in ("decode", "verify", *(f"{kind}_{kv}" for kind in ("decode", "verify") for kv in KV_DTYPES)):
        kind, _, kv = key.partition("_")
        bf16, f32 = kernels[key]["bfloat16"], kernels[key]["float32"]
        run = f"bf16_w8_{kv}_{runs[kind]}" if kv else f"bf16_{runs[kind]}"
        rows.append({
            "name": f"paged_{key}{suffix}",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[kind],
            "launches": engine[run]["launches"][key],
            "max_abs_err": bf16["max_abs_err"],
            "tolerance": bf16["tolerance"],
            "ms": bf16["ms"],
            "kernel_ms": bf16["ms"],
            "device_ms": bf16["device_ms"],
            "library_device_ms": bf16["library_device_ms"],
            "plain_ms": bf16["plain_ms"],
            "bound_ms": bf16["bound_ms"],
            "bound_by": bf16["bound_by"],
            "library_ms": bf16["library_ms"],
            "library_call": "F.scaled_dot_product_attention over pre-gathered dense K/V (yardstick, never called by the port)"
                            + (f", dequantized from {kv} to bf16 beforehand" if kv else ""),
            "dtype": "bfloat16",
            "kv_dtype": kv or "bfloat16",
            "shape": dict(shape, s=1 if kind == "decode" else shape["verify_s"]),
            "design": design,
            "f32": f32,
        })
    return rows


def flash_rows(flash, bf16_launches, fp16_launches, shape, suffix="", design="", causal=True, scale=None):
    """The `kernels` line's K3-K5 rows in bf16 and, with `fp16_launches`, in
    fp16, from a flash phase at `shape` (`causal` or not, at `scale` if it
    is not 1/sqrt(D)) and the launches of the training runs that drove them."""
    sdpa = f"F.scaled_dot_product_attention(is_causal={causal}" + ("" if scale is None else f", scale={scale}") + ")"
    rows = []
    for name, (replaces, _) in FLASH_KERNELS.items():
        bf16, f32 = flash[name]["bfloat16"], flash[name].get("float32")
        rows.append({
            "name": name + suffix,
            "route": "cuda",
            "source": FLASH_SOURCE,
            "replaces": replaces,
            "launches": bf16_launches[name],
            "max_abs_err": bf16["max_abs_err"],
            "tolerance": bf16["errors"][next(iter(bf16["errors"]))]["tolerance"],
            "errors": bf16["errors"],
            "ms": bf16["ms"],
            "kernel_ms": bf16["ms"],
            "device_ms": bf16["device_ms"],
            "library_device_ms": bf16["library_device_ms"],
            "plain_ms": bf16["plain_ms"],
            "bound_ms": bf16["bound_ms"],
            "bound_by": bf16["bound_by"],
            "library_ms": bf16["library_ms"],
            "library_call": (sdpa if name == "flash_fwd" else
                             f"autograd backward of {sdpa}: dq, dk and dv in one call, the work of "
                             "flash_bwd_dkv and flash_bwd_dq together"),
            "dtype": "bfloat16",
            "shape": dict(shape, causal=causal, **({} if scale is None else {"scale": scale})),
            "design": FLASH_DESIGN[name] + design,
            "f32": f32,
        })
    if fp16_launches is None:
        return rows
    for name, (replaces, _) in FLASH_KERNELS.items():
        fp16 = flash[name]["float16"]
        rows.append({
            "name": launch_key(name, torch.float16) + suffix,
            "route": "cuda",
            "source": FLASH_SOURCE,
            "replaces": replaces,
            "launches": fp16_launches[launch_key(name, torch.float16)],
            "max_abs_err": fp16["max_abs_err"],
            "tolerance": fp16["errors"][next(iter(fp16["errors"]))]["tolerance"],
            "errors": fp16["errors"],
            "range_case": fp16.get("range_case"),
            "ms": fp16["ms"],
            "kernel_ms": fp16["ms"],
            "device_ms": fp16["device_ms"],
            "library_device_ms": fp16["library_device_ms"],
            "plain_ms": fp16["plain_ms"],
            "bound_ms": fp16["bound_ms"],
            "bound_by": fp16["bound_by"],
            "library_ms": fp16["library_ms"],
            "library_call": (f"{sdpa}, fp16" if name == "flash_fwd" else
                             f"autograd backward of {sdpa}, fp16: dq, dk and dv in one call, the work of "
                             "flash_bwd_dkv and flash_bwd_dq together"),
            "dtype": "float16",
            "shape": dict(shape, causal=causal, **({} if scale is None else {"scale": scale})),
            "design": FLASH_DESIGN[name] + FLASH_FP16_DESIGN[name] + design,
        })
    return rows


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the build and the kernel phase (prints no result line)")
    parser.add_argument("--profile", action="store_true",
                        help="also profile one bf16 plain engine run, one with int8 weights and cache, "
                             "one bf16 batch-1 generate call, one bf16 training step, one under each "
                             "remat policy, one BERT-base step, for the families one NeoX-20B engine "
                             "run, one generate call and one training step each, and one T5 training "
                             "step and one T5 generate call: device time by kernel, busy share")
    parser.add_argument("--fp8-only", action="store_true",
                        help="run only the build and phase 11 (fp8 and ResNet; prints no result line)")
    parser.add_argument("--telemetry-only", action="store_true",
                        help="run only the build and phase 13 (telemetry and the trace guard on the main paths; "
                             "prints no result line)")
    parser.add_argument("--dist-only", action="store_true",
                        help="run only the build and phase 14 (data parallel and FSDP/ZeRO through NCCL at "
                             "world 1; prints no result line)")
    parser.add_argument("--surface-only", action="store_true",
                        help="run only the build and phase 15 (the user's surface on Llama-1B and the example "
                             "twins; prints no result line)")
    parser.add_argument("--launch-only", action="store_true",
                        help="run only the build and phase 16 (launch, supervised restart and the CLI on Llama-1B; "
                             "prints no result line)")
    parser.add_argument("--bigmodel-only", action="store_true",
                        help="run only the build and phase 17 (big-model inference over the offload tiers on "
                             "OPT-30B, checkpoint, hooks, quantization, estimate; prints no result line)")
    parser.add_argument("--offload-train-only", action="store_true",
                        help="run only the build and phase 18 (training past the card: the offload tiers against "
                             "the resident run, GPT-J-6B under ZeRO-Offload; prints no result line)")
    parser.add_argument("--checkpoint-only", action="store_true",
                        help="run only the build and phase 19 (async and sharded checkpoints and preemption on "
                             "Llama-1B; prints no result line)")
    parser.add_argument("--examples-only", action="store_true",
                        help="run only the build and phase 20 (the example twins and the quality gate; prints no "
                             "result line)")
    parser.add_argument("--tp-only", action="store_true",
                        help="run only the build and phase 21 (convert, then Llama-1B over two tensor-parallel "
                             "ranks sharing the card: serving and training against tp=1; prints no result line)")
    parser.add_argument("--plan-only", action="store_true",
                        help="run only the build and phase 21 (d)-(e) (Llama-1B served and trained under the "
                             "planner's layout over two ranks sharing the card, with their tp=1 references; "
                             "prints no result line)")
    parser.add_argument("--tp-families-only", action="store_true",
                        help="run only the build and phase 21 (f) (GPT-J-6B, OPT-30B, T0pp-11B and BERT-base trained "
                             "over two tensor-parallel ranks sharing the card, against tp=1; prints no result line)")
    parser.add_argument("--tp-precision-witness", action="store_true",
                        help="run only the build and T0pp-11B at phase 21 (f)'s cut in f32 at tp=2 against tp=1, "
                             "and bf16 against f32 at tp=1 (prints no result line)")
    parser.add_argument("--compare", nargs="+", metavar="TREE",
                        help="time the flash kernels of each source tree instead, in turns (a b b a)")
    parser.add_argument("--head-dim", type=int, default=FLASH_SHAPE["d"], choices=(16, 32, 64, 96, 128, 256),
                        help="--compare's head dimension (default: the training shape's)")
    parser.add_argument("--compare-worker", metavar="TREE", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    script_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.compare:
        return compare(args.compare, args.head_dim)
    if args.compare_worker:
        log(f"[compare] {json.dumps(compare_worker(args.compare_worker, args.head_dim))}")
        return 0
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"device count {torch.cuda.device_count()}")

    from accelerate_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {sorted(built)} in {time.perf_counter() - t0:.2f}s (per source: {built})")
    for name, text in _build.BUILD_LOG.items():
        for line in ptxas_report(text):
            log(f"[build] {name}: {line}")

    if args.fp8_only:
        log(f"[fp8] summary: {json.dumps(fp8_phase(device, profile=args.profile))}")
        log(card)
        return 0
    if args.telemetry_only:
        t0 = time.perf_counter()
        log(f"[telemetry] summary: {json.dumps(telemetry_phase(device))}")
        log(f"[time] telemetry phase {time.perf_counter() - t0:.1f}s")
        log(card)
        return 0
    if args.dist_only:
        t0 = time.perf_counter()
        log(f"[dist] summary: {json.dumps(dist_phase(device))}")
        log(f"[time] dist phase {time.perf_counter() - t0:.1f}s")
        log(card)
        return 0
    if args.surface_only:
        t0 = time.perf_counter()
        log(f"[surface] summary: {json.dumps(surface_phase(device))}")
        log(f"[time] surface phase {time.perf_counter() - t0:.1f}s")
        log(card)
        return 0
    if args.launch_only:
        t0 = time.perf_counter()
        log(f"[launch] summary: {json.dumps(launch_phase(device))}")
        log(f"[time] launch phase {time.perf_counter() - t0:.1f}s")
        log(card)
        return 0
    if args.bigmodel_only:
        t0 = time.perf_counter()
        log(f"[bigmodel] summary: {json.dumps(bigmodel_phase(device))}")
        log(f"[time] bigmodel phase {time.perf_counter() - t0:.1f}s")
        log(card)
        return 0
    if args.offload_train_only:
        t0 = time.perf_counter()
        log(f"[offload] summary: {json.dumps(offload_summary(offload_train_phase(device)))}")
        log(f"[time] offload train phase {time.perf_counter() - t0:.1f}s")
        log(card)
        return 0
    if args.checkpoint_only:
        t0 = time.perf_counter()
        log(f"[checkpoint] summary: {json.dumps(checkpoint_summary(checkpoint_phase(device)))}")
        log(f"[time] checkpoint phase {time.perf_counter() - t0:.1f}s")
        log(card)
        return 0
    if args.examples_only:
        t0 = time.perf_counter()
        log(f"[examples] summary: {json.dumps(examples_phase(device))}")
        log(f"[time] examples phase {time.perf_counter() - t0:.1f}s")
        log(card)
        return 0
    if args.plan_only:
        t0 = time.perf_counter()
        tp = tp_phase(device, parts=("d", "e"))
        log(f"[tp] summary: {json.dumps(tp_summary(tp))}")
        log(f"[time] tp phase (d)-(e) {time.perf_counter() - t0:.1f}s")
        log(card)
        return 0
    if args.tp_families_only:
        t0 = time.perf_counter()
        tp = tp_phase(device, parts=("f",))
        log(f"[tp] summary: {json.dumps(tp_summary(tp))}")
        log(f"[tp] rows: {json.dumps(tp_family_rows(tp))}")
        log(f"[time] tp phase (f) {time.perf_counter() - t0:.1f}s")
        log(card)
        return 0
    if args.tp_precision_witness:
        t0 = time.perf_counter()
        tp_precision_witness(device)
        log(f"[time] tp precision witness {time.perf_counter() - t0:.1f}s")
        log(card)
        return 0
    if args.tp_only:
        t0 = time.perf_counter()
        tp = tp_phase(device)
        log(f"[tp] summary: {json.dumps(tp_summary(tp))}")
        log(f"[tp] rows: {json.dumps(tp_rows(tp))}")
        log(f"[time] tp phase {time.perf_counter() - t0:.1f}s")
        log(card)
        return 0
    t0 = time.perf_counter()
    kernels = kernel_phase(device)
    kernels.update(quantized_kernel_phase(device))
    flash = flash_kernel_phase(device)
    log(f"[time] kernel phases {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    log(f"[kernels] GPT-NeoX-20B's shape: {json.dumps(NEOX_KERNEL_SHAPE)}")
    neox_kernels = kernel_phase(device, NEOX_KERNEL_SHAPE)
    neox_kernels.update(quantized_kernel_phase(device, NEOX_KERNEL_SHAPE))
    wide_flash = {}
    for d, shape in FAMILY_FLASH_SHAPES.items():
        log(f"[flash] head dim {d}: {json.dumps(shape)}")
        wide_flash[d] = flash_kernel_phase(device, shape)
    log(f"[time] kernel phases at the families' shapes {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    log(f"[flash] T5 cross-attention, non-causal, scale 1.0: {json.dumps(T5_CROSS_FLASH_SHAPE)}")
    t5_flash = flash_kernel_phase(device, T5_CROSS_FLASH_SHAPE, causal=False, scale=1.0,
                                  dtypes=(torch.float32, torch.bfloat16))
    log(f"[time] kernel phases at T5's cross-attention shape {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    d16 = head_dim_16_phase(device)
    log(f"[time] mixtral (a) head dim 16 {time.perf_counter() - t0:.1f}s")
    if args.kernels_only:
        log(card)
        return 0
    t0 = time.perf_counter()
    engine = engine_phase(device, profile=args.profile)
    log(f"[engine] summary: {json.dumps(engine)}")
    log(f"[time] engine phase {time.perf_counter() - t0:.1f}s")
    free_memory(device)
    t0 = time.perf_counter()
    generated = generate_phase(device, profile=args.profile)
    log(f"[generate] summary: {json.dumps(generated)}")
    log(f"[time] generate phase {time.perf_counter() - t0:.1f}s")
    free_memory(device)  # the engines and their model are gone; training starts from a clean pool
    t0 = time.perf_counter()
    training = training_phase(device, profile=args.profile)
    log(f"[train] summary: {json.dumps(training)}")
    log(f"[time] training phase {time.perf_counter() - t0:.1f}s")
    free_memory(device)
    t0 = time.perf_counter()
    remat = remat_phase(device, profile=args.profile)
    log(f"[remat] summary: {json.dumps(remat)}")
    log(f"[time] training (f) remat {time.perf_counter() - t0:.1f}s")
    free_memory(device)
    fp8 = fp8_phase(device, training["bf16"], profile=args.profile)
    log(f"[fp8] summary: {json.dumps(fp8)}")
    t0 = time.perf_counter()
    telemetry = telemetry_phase(device)
    log(f"[telemetry] summary: {json.dumps(telemetry)}")
    log(f"[time] telemetry phase {time.perf_counter() - t0:.1f}s")
    free_memory(device)
    t0 = time.perf_counter()
    dist = dist_phase(device)
    log(f"[dist] summary: {json.dumps(dist)}")
    log(f"[time] dist phase {time.perf_counter() - t0:.1f}s")
    free_memory(device)
    t0 = time.perf_counter()
    surface = surface_phase(device)
    log(f"[surface] summary: {json.dumps(surface)}")
    log(f"[time] surface phase {time.perf_counter() - t0:.1f}s")
    free_memory(device)
    t0 = time.perf_counter()
    launched = launch_phase(device)
    log(f"[launch] summary: {json.dumps(launched)}")
    log(f"[time] launch phase {time.perf_counter() - t0:.1f}s")
    free_memory(device)
    t0 = time.perf_counter()
    bert = bert_phase(device, profile=args.profile)
    log(f"[bert] summary: {json.dumps(bert)}")
    log(f"[time] bert phase {time.perf_counter() - t0:.1f}s")
    free_memory(device)
    t0 = time.perf_counter()
    neox = neox_engine_phase(device, profile=args.profile)
    log(f"[neox] summary: {json.dumps(neox)}")
    log(f"[time] neox engine phase {time.perf_counter() - t0:.1f}s")
    family_generate, family_train = {}, {}
    for name in FAMILIES:
        t0 = time.perf_counter()
        # Phase 17 takes OPT-30B over from its generate phase: one model, made once.
        shared = None
        if name == BIGMODEL["model"]:
            from accelerate_tpu_torch import create_named_model

            shared = create_named_model(name, seed=0, dtype=torch.bfloat16, device=device)
        family_generate[name] = family_generate_phase(device, name, profile=args.profile, model=shared)
        log(f"[time] {name} generate phase {time.perf_counter() - t0:.1f}s")
        if shared is not None:
            t0 = time.perf_counter()
            bigmodel = bigmodel_phase(device, model=shared)
            del shared
            free_memory(device)
            log(f"[bigmodel] summary: {json.dumps(bigmodel)}")
            log(f"[time] bigmodel phase {time.perf_counter() - t0:.1f}s")
    for name in FAMILIES:
        t0 = time.perf_counter()
        family_train[name] = family_training_phase(device, name, FAMILY_TRAIN_LAYERS[name], profile=args.profile)
        log(f"[family] {name} training summary: {json.dumps(family_train[name])}")
        log(f"[time] {name} training phase {time.perf_counter() - t0:.1f}s")
    log(f"[family] generate summary: {json.dumps(family_generate)}")
    t0 = time.perf_counter()
    offload = offload_train_phase(device)
    log(f"[offload] summary: {json.dumps(offload_summary(offload))}")
    log(f"[time] offload train phase {time.perf_counter() - t0:.1f}s")
    free_memory(device)
    t0 = time.perf_counter()
    checkpoint = checkpoint_phase(device)
    log(f"[checkpoint] summary: {json.dumps(checkpoint_summary(checkpoint))}")
    log(f"[time] checkpoint phase {time.perf_counter() - t0:.1f}s")
    free_memory(device)
    t0 = time.perf_counter()
    t5_train = t5_training_phase(device, profile=args.profile)
    log(f"[t5] training summary: {json.dumps(t5_train)}")
    log(f"[time] t5 training phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    t5_generate = t5_generate_phase(device, profile=args.profile)
    log(f"[t5] generate summary: {json.dumps(t5_generate)}")
    log(f"[time] t5 generate phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    mixtral_generate = mixtral_generate_phase(device)
    log(f"[mixtral] generate summary: {json.dumps(mixtral_generate)}")
    log(f"[time] mixtral generate phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    mixtral_train = mixtral_training_phase(device, profile=args.profile)
    log(f"[mixtral] training summary: {json.dumps(mixtral_train)}")
    log(f"[time] mixtral training phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    hf = hf_phase(device)
    log(f"[hf] summary: {json.dumps(hf)}")
    log(f"[time] hf phase {time.perf_counter() - t0:.1f}s")
    free_memory(device)
    t0 = time.perf_counter()
    examples = examples_phase(device)
    log(f"[examples] summary: {json.dumps(examples)}")
    log(f"[time] examples phase {time.perf_counter() - t0:.1f}s")
    free_memory(device)
    t0 = time.perf_counter()
    tp = tp_phase(device)
    log(f"[tp] summary: {json.dumps(tp_summary(tp))}")
    log(f"[time] tp phase {time.perf_counter() - t0:.1f}s")

    # the families at each head dim
    wide_runs = {96: family_train["gpt-neox-20b"], 256: family_train["gptj-6b"], 128: mixtral_train}
    rows = paged_rows(kernels, engine, KERNEL_SHAPE, PAGED_DESIGN)
    # Llama-1B's bf16 K3-K5 run under bf16, under fp8 (whose attention is
    # bf16), in phase 14 (d)'s fp8 runs across the strategies, in phase 15's
    # eager loops (the dispatcher's and the shard loader's), in phase 16's
    # launched children and their in-process twins, and in phase 19's
    # checkpointed runs, and in phase 21 (e)'s data=2 run (1 x 2048 a rank).
    surface_runs = (surface["training"]["dispatcher"], surface["training"]["shard_loader"])
    bf16_launches = {k: v + fp8["training"]["launches"][k] + dist["fp8"]["launches"][k]
                     + sum(r["launches"][k] for r in surface_runs) + launched["launches"][k]
                     + checkpoint["launches"][k] + tp_data_launches(tp)[k]
                     for k, v in training["bf16"]["launches"].items()}
    rows += flash_rows(flash, bf16_launches, training["fp16"]["launches"], FLASH_SHAPE)
    rows += paged_rows(neox_kernels, neox, NEOX_KERNEL_SHAPE, PAGED_SCALAR_DESIGN, suffix="_neox")
    for d, shape in FAMILY_FLASH_SHAPES.items():
        run = wide_runs[d]
        bf16_runs = [run["bf16"]["launches"]] + (offload_launches(offload) if d == 256 else [])
        rows += flash_rows(wide_flash[d], {k: sum(r[k] for r in bf16_runs) for k in bf16_runs[0]},
                           run["fp16"]["launches"], shape, suffix=f"_d{d}", design=WIDE_FLASH_DESIGN[d])
    rows += flash_rows(t5_flash, t5_train["bf16"]["launches"], None, T5_CROSS_FLASH_SHAPE, suffix="_t5cross",
                       design=T5_CROSS_DESIGN, causal=False, scale=1.0)
    # At head dim 16 the path is T5-tiny's cross-attention: non-causal, scale 1.0.
    rows += flash_rows(d16["non_causal"], d16["t5"]["bfloat16"]["launches"], d16["t5"]["float16"]["launches"],
                       D16_FLASH_SHAPE, suffix="_d16", design=WIDE_FLASH_DESIGN[16], causal=False, scale=1.0)
    layouts = bigmodel["layouts"]
    rows.append(bigmodel_k3_row(bigmodel["k3"], sum(layouts[k]["k3_launches"] for k in ("a", "b", "c"))))
    rows += tp_rows(tp)
    log(f"[time] whole script {time.perf_counter() - script_t0:.1f}s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
