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
   (median of 60 launches, L2 flushed before each: `ms`, which a call's host
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
   (a) f32: greedy tokens of the "paged_kernel" engine equal the "gather"
       engine's, plain (K1's path) and speculative (K2's path).
   (b) bf16: the "paged_kernel" engine, plain and speculative, timed; every
       request finishes; each kernel's launch count, zeroed just before the
       run, equals layers x dispatches of that run and is > 0.
   (c) f32, KV cache quantized to int8 and to fp8 e4m3: greedy tokens of
       the "paged_kernel" engine equal the "gather" engine's, plain and
       speculative; both read the same quantized pool.
   (d) f32: with only the cache quantized, every request that does not
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
   (a) f32, greedy, gated: 4 prompts of 256 tokens, 32 new tokens each,
       give the "paged_kernel" engine's tokens (K1's path) row for row; the
       same with draft_tokens=4 gives the plain loop's; a left-padded batch
       of 64-256 tokens gives each prompt generated alone; a repetition
       penalty of 1.3 gives the paged engine's with use_repetition_penalty
       and that penalty per request; the contiguous engine (paged=False) on
       the engine phase's 16 requests gives the paged engine's tokens.
   (b) bf16, timed: the paged and the contiguous engine on the 16 requests
       (decode tokens/s, TTFT p50, the cache's bytes, peak memory); then
       `generate` at batch 1 on a 512-token prompt and at batch 8 left-padded
       128-512, 128 new tokens each (TTFT, the median of 3 one-token calls;
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
   (e) a checkpoint round trip, bf16, Llama-1B's widths cut to 2 layers,
       batch 1, over 8 distinct seeded rows shuffled by a
       `SeedableRandomSampler`: 4 steps with `save_state` after step 2 into
       a `CheckpointManager` directory under `tempfile.mkdtemp()`, then a
       fresh run (state reset, weights from another seed) that restores
       "latest" and takes steps 3 and 4 from the restored loader position:
       their losses equal the uninterrupted run's within rtol 1e-6. Reports
       the bytes written and the save and load seconds; the directory is
       removed however the phase ends.
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
       bf16 at 44 layers (41.1 GB of weights, 17.7 GB of pools) over the 16
       requests of phase 3, plain (K1) and speculative (K2), timed, launches
       gated as in phase 3; then int8 weights over an int8 and an fp8 cache
       at 22 layers (the bf16 model the engine copies from and its int8
       copy both on the card).
   (b) `generate` of GPT-NeoX-20B, GPT-J-6B and OPT-30B in bf16 at full
       depth, batch 1 on a 512-token prompt, 128 new tokens: TTFT, decode
       tokens/s, peak memory; no K1-K5 launch.
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
   tensors bit for bit, and the paged engine's 16 requests of phase 3,
   plain (K1) and speculative (K2), give the original's tokens; the file's
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
       the full-context greedy loop's for 8 new tokens; bf16 at 24 layers
       (70.2 GB), batch 1 on a 512-token prompt and a left-padded batch of 8
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
   (e) with phase 9, a 2-layer bf16 cut saved with `save_hf_checkpoint`
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
       engine arguments, full width and depth), plain and speculative, each
       after a warm-up, run without and with instrumentation (a b b a twice
       for plain, a b for speculative): instrumented is a fresh
       `MetricsRegistry`, a `Tracer` over a `FlightRecorder` streaming into
       a temporary directory (removed however the phase ends) and a
       record-mode `TraceGuard` ("log": each host sync recorded) armed around
       the steps. Gates: every run's tokens equal phase 3's (and each
       other's); 16 submitted, 16 finished, 16 TTFTs;
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
   (b) Llama-1B bf16 training at full width and depth, 5 (b)'s batch and
       seed, 2 warm-up and 8 timed steps, through an `Accelerator` without
       and with `analyze=True` (a b b a; the analyzed one samples the
       "block" phase every 2nd step). Gates: losses equal within rtol 1e-6
       (bit for bit reported); `train_steps_total`, the
       `train_dispatch_seconds` count and `goodput()["steps"]` 10; the
       guard's 8 steady steps clean (0 builds, 0 syncs); K3-K5 each launched
       16 x 10 times. Reported: step times and the block share.
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
   1 (``RANK=0``, ``WORLD_SIZE=1``, ``LOCAL_RANK=0``, a free ``MASTER_PORT``
   on 127.0.0.1, set for the phase and put back, the process group torn
   down however it ends), where the group, the placed module, the
   collectives and the sharded optimizer state are all on the path; runs
   across processes are held to JAX on the CPU over gloo
   (`tests/test_torch_distributed*.py`).
   (a) Llama-1B bf16 with f32 masters at full width and depth, 5 (b)'s
       batch (2 x 2048), seed and AdamW, 2 warm-up and 8 timed steps, each
       run through `Accelerator(...).prepare` and `train_step()`: the bare
       `Accelerator` (no group), then NO_SHARD, SHARD_GRAD_OP and
       FULL_SHARD, then the same in reverse (bare N S F F S N bare), so each
       strategy is paired with the bare run in one call. Gates: the backend
       is "nccl"; NO_SHARD's losses equal the bare run's within rtol 1e-6
       (bit for bit reported); SHARD_GRAD_OP's and FULL_SHARD's within 1e-2
       relative at every step (the largest gap reported), finite, the last
       below the first; K3, K4 and K5 each launched 16 x 10 times per run;
       a `torch.profiler` window of one more FULL_SHARD step holds the
       collectives FSDP issues through NCCL (`nccl:*` ops). At one rank NCCL
       runs each as a device-to-device copy, so the window's NCCL kernels
       (none) and copies are reported, not gated. Reported per run: median step time, tokens/s, MFU (phase 5's
       accounting), peak memory, and each strategy's step time over the
       bare run's.
   (b) The trace guard on the steady step under NO_SHARD and FULL_SHARD:
       2 warm-up steps, then 4 under a record-mode `TraceGuard` ("log");
       reported: kernel builds and host syncs by site, the port's own frame
       and torch's innermost one. A sync in the port's code fails the phase.
   (c) A checkpoint across layouts: 2 layers of Llama-1B at full width under
       FULL_SHARD, `save_state` after step 3 (into a temporary directory,
       removed however the phase ends), a fresh FULL_SHARD `Accelerator`
       loads it and takes steps 4-6: losses within rtol 1e-6 of the run
       that was not cut. A bare `Accelerator` loads the same checkpoint:
       its weights equal the gathered FULL_SHARD ones bit for bit.
       Reported: save and load seconds, and bytes.

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

`--fp8-only` runs the build and phase 11 alone, `--telemetry-only` the build
and phase 13 alone, `--dist-only` the build and phase 14 alone,
`--surface-only` the build and phase 15 alone (none prints a result line).

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
import json
import os
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
TIMED_LAUNCHES = 60
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
# depth (20.6 GB bf16, 10.1 GB int8, the int8 pools 4.4 GB).
NEOX_W8_LAYERS = 22
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
# bf16), the embedding and the head 0.524 GB together. Generation runs 24 of
# the 32 layers (70.2 GB) over a 1024-token cache (prompt 512 + 128 new);
# its f32 dropless check 2 layers.
MIXTRAL_MODEL = "mixtral-8x7b"
MIXTRAL_GENERATE = dict(layers=24, max_length=1024, prompt=512, new=128, batch=8, ragged=(128, 512),
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
                row.update(paired_times(lambda: fn(q, k, v, table, pos), sdpa_yardstick(q, k, v, table, pos),
                                        device))
                row["plain_ms"] = time_ms(lambda: pa.paged_attention_reference(q, k, v, table, pos), device)
            entry[str(dtype).replace("torch.", "")] = row
            log(f"[kernels] {kind} {dtype}: {json.dumps(row)}")
        results[kind] = entry
    return results


def quantized_kernel_phase(device, shape=KERNEL_SHAPE, timed=True):
    """K1 and K2's fused-dequant mode at the engine's shapes: the pools of
    `kernel_case` (scratch page poisoned) quantized whole-page to int8 and to
    fp8 e4m3, f32 and bf16 queries, each kernel launch held against the plain
    version on the same codes and scales."""
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.ops import quantization as qz

    results = {}
    for kind, s in (("decode", 1), ("verify", shape["verify_s"])):
        fn = pa.paged_decode_attention if s == 1 else pa.paged_verify_attention
        for kv_dtype in KV_DTYPES:
            key = f"{kind}_{kv_dtype}"
            spec = qz.kv_quant_spec(kv_dtype)
            entry = {}
            for dtype in (torch.float32, torch.bfloat16):
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
SPEC_KW = dict(speculative=True, draft_tokens=KERNEL_SHAPE["verify_s"] - 1)


def engine_phase(device, model_name="llama-1b", engine_kw=None, n_requests=16, system_len=256,
                 profile=False, tokens_out=None):
    """Phase 3; `tokens_out`, a dict, receives the bf16 runs' greedy tokens
    by label ("plain", "speculative")."""
    from accelerate_tpu_torch import create_named_model

    engine_kw = {**ENGINE_KW, **(engine_kw or {})}
    report = {"model": model_name, "engine": engine_kw, "draft_tokens": SPEC_KW["draft_tokens"]}

    t0 = time.perf_counter()
    model = create_named_model(model_name, seed=0, dtype=torch.float32, device=device)
    requests = make_requests(model.config.vocab_size, n=n_requests, system_len=system_len)
    log_model(f"[engine] {model_name} f32", model, t0)
    engine_parity(model, requests, device, engine_kw, report)
    model = model.to(torch.bfloat16)
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
    timed_prompt=512, timed_new=128, timed_batch=8, timed_ragged=(128, 512), passage=64, draft=4,
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
    model = create_named_model(model_name, seed=0, dtype=torch.float32, device=device)
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
    model = model.to(torch.bfloat16)
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
                       dtypes=(torch.float32, torch.bfloat16, torch.float16)):
    """K3, K4 and K5 against their plain versions in each of `dtypes`, at
    `shape` (``sk``, the key length, defaults to ``s``), `causal` or not, at
    `scale` (1/sqrt(D) by default); each kernel check is one launch. K4 and
    K5 get the lse and delta of the plain forward, so each is held alone.
    bf16 and fp16 K3's o, K4's dk and dv and K5's dq also report the element
    nearest to breaking the limit without the rounding bound, and SDPA's
    output under both limits. Then, with fp16 among `dtypes`, fp16 K4 and
    K5 on the range case (`flash_range_case`)."""
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
        ref_dk, ref_dv = fa.flash_bwd_dkv_reference(*wide, ref_lse, ref_delta, causal, scale)
        ref_dq = fa.flash_bwd_dq_reference(*wide, ref_lse, ref_delta, causal, scale)
        lib_fwd, lib_bwd = sdpa_flash_yardsticks(q, k, v, do, shape["b"], shape["hq"], causal, scale)
        sdpa = dict(zip(("dq", "dk", "dv"), lib_bwd()), o=lib_fwd().detach())
        refs = {"o": ref_o, "dq": ref_dq, "dk": ref_dk, "dv": ref_dv}
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
          accelerator_kw=None):
    """Train a model of `config` (its family's, random weights from seed 0)
    through the user's entry points; returns (per-step losses, per-step seconds, the
    prepared model, the step function, the last batch). `on_step(i,
    step_fn)` runs before step i and `after_step(i, step_fn)` after it, both
    outside its timing. `remat_policy` goes to the accelerator's
    `CompilationConfig`. The data is `loader`, or one repeated batch of
    `batch` x `seq` tokens (`repeated_batch_loader`). A loss that returns
    ``(loss, aux)`` (Mixtral's) appends each step's aux, as floats, to
    `aux_out`. `analyze` and `accelerator_kw` go to the `Accelerator`;
    `keep`, a dict, receives it under "accelerator"."""
    from accelerate_tpu_torch import Accelerator, CompilationConfig
    from accelerate_tpu_torch.models import CREATE_BY_FAMILY
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    model = CREATE_BY_FAMILY[type(config)](config, seed=0, device=device)
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
                   warmup=2, batch=2, profile=False, checkpoint_layers=2):
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

    # (e) a bf16 checkpoint round trip at full width, cut to `checkpoint_layers` layers.
    t0 = time.perf_counter()
    report["checkpoint"] = checkpoint_phase(device, dataclasses.replace(config, num_hidden_layers=checkpoint_layers),
                                            seq)
    log(f"[time] training (e) checkpoint {time.perf_counter() - t0:.1f}s")
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


def checkpoint_phase(device, config, seq, steps=4, save_after=2, n_batches=8):
    """(e): bf16 training of `config` (batch 1) over a `SimpleDataLoader` of
    `n_batches` distinct seeded rows shuffled by a `SeedableRandomSampler`;
    `save_state` after step `save_after` into a `CheckpointManager` under a
    fresh temporary directory, then a fresh run (state reset, weights from
    another seed) that restores "latest" and takes the remaining steps from
    the restored loader position. Its losses equal the uninterrupted run's
    within rtol 1e-6. The directory is removed however the phase ends."""
    import shutil
    import tempfile

    from accelerate_tpu_torch import Accelerator, BatchSampler, SimpleDataLoader, create_llama_model
    from accelerate_tpu_torch.data_loader import SeedableRandomSampler
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils import ProjectConfiguration

    rows = np.random.default_rng(5).integers(0, config.vocab_size, (n_batches, seq)).astype(np.int64)
    data = [{"input_ids": r} for r in rows]
    project_dir = tempfile.mkdtemp(prefix="chip_smoke_checkpoint_")

    def run(seed, resume):
        AcceleratorState._reset_state()
        GradientState._reset_state()
        model = create_llama_model(config, seed=seed, device=device)
        accelerator = Accelerator(mixed_precision="bf16", cpu=device.type == "cpu", project_config=ProjectConfiguration(
            project_dir=project_dir, automatic_checkpoint_naming=True))
        optimizer = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, betas=TRAIN_BETAS, eps=TRAIN_EPS,
                                      weight_decay=TRAIN_WD)
        loader = SimpleDataLoader(data, BatchSampler(SeedableRandomSampler(num_samples=n_batches, seed=11), 1))
        _, _, loader, schedule = accelerator.prepare(model, optimizer, loader, lambda step: TRAIN_LR)
        timing = {"parameters": sum(p.numel() for p in model.parameters())}
        if resume:
            t0 = time.perf_counter()
            path = accelerator.load_state("latest")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timing.update(load_s=time.perf_counter() - t0, loaded=os.path.basename(path))
            loader = accelerator.skip_first_batches(loader, save_after)
        step_fn = accelerator.train_step(max_grad_norm=1.0)
        losses = []
        for b in loader:
            losses.append(float(step_fn(b)))
            schedule.step()
            if not resume and len(losses) == save_after:
                t0 = time.perf_counter()
                path = accelerator.save_state()
                timing.update(save_s=time.perf_counter() - t0, saved=os.path.basename(path),
                              bytes_written=sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)),
                              files=sorted(os.listdir(path)))
            if len(losses) == (steps - save_after if resume else steps):
                break
        return losses, timing

    try:
        full, saved = run(seed=0, resume=False)
        free_memory(device)
        resumed, loaded = run(seed=1, resume=True)
    finally:
        shutil.rmtree(project_dir, ignore_errors=True)
    diff = max(abs(a - b) / abs(b) for a, b in zip(resumed, full[save_after:]))
    out = {"layers": config.num_hidden_layers, "losses": full, "resumed_losses": resumed, "max_rel_diff": diff,
           **saved, **loaded}
    log(f"[train] checkpoint {json.dumps(out)}")
    if not all(np.isfinite(full + resumed)) or len(resumed) != steps - save_after or diff > 1e-6:
        raise RuntimeError(f"checkpoint resume: losses {resumed} differ from the uninterrupted {full[save_after:]} "
                           f"(rtol {diff}, limit 1e-6)")
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
def neox_engine_phase(device, model_name="gpt-neox-20b", parity_layers=2, w8_layers=NEOX_W8_LAYERS, n_requests=16,
                      system_len=256, new=32, n_prompts=4, profile=False):
    """GPT-NeoX through the paged engine (K1 and K2 at D 96, G = 1). (a) f32
    at full width cut to `parity_layers` layers: the kernel path's tokens
    equal the gather path's, unquantized and on int8 and fp8 caches
    (`engine_parity`), and `generate`'s greedy tokens equal the K1 engine's
    on `n_prompts` prompts; (b) bf16 at full width and depth, timed, with
    the launch gates of `engine_timed`; (e) int8 weights over an int8 and an
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
    model = create(config, seed=0, dtype=torch.bfloat16, device=device)
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
                     nbytes * w8_layers // config.num_hidden_layers)
    del model
    free_memory(device)
    log(f"[time] neox (e) int8 weights {time.perf_counter() - t0:.1f}s")
    return report


def family_generate_phase(device, model_name, shape=GENERATE_SHAPE, profile=False):
    """`generate` of `model_name` in bf16 at full width and depth (random
    weights from seed 0): batch 1 on a `timed_prompt`-token prompt,
    `timed_new` new tokens (`timed_generate`: TTFT, decode tokens/s, peak
    memory), after a warm-up; every K1-K5 count stays 0 over it. With
    `profile`, device time by kernel group of one more such call."""
    from accelerate_tpu_torch import GenerationConfig, Generator, create_named_model

    t0 = time.perf_counter()
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
             n_requests=16, system_len=256, mixtral_name=MIXTRAL_MODEL, mixtral_layers=2):
    """HF checkpoint interchange on the card, through a temporary directory
    (removed however the phase ends): `model_name` in bf16 at full width and
    depth (random weights from seed 0) written with `save_hf_checkpoint`
    and loaded with `load_hf_checkpoint_in_model` into a model built from
    seed 1, which then holds the same tensors bit for bit, in bf16 on the
    card; the paged engine's 16-request mix, plain (K1) and speculative
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

        # The speculative engine is paired a b; the plain one a b b a twice.
        runs = abba(run, "plain", "instrumented", rounds=2) if label == "plain" else {
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
                    seq=TRAIN_SEQ, batch=2, warmup=2, timed_steps=8, plain_tokens=None):
    """Phase 13: telemetry and the trace guard on the main paths."""
    from accelerate_tpu_torch import create_named_model
    from accelerate_tpu_torch.models import MODEL_REGISTRY

    engine_kw = {**ENGINE_KW, **(engine_kw or {})}
    report = {"model": model_name, "engine": engine_kw}
    t0 = time.perf_counter()
    # Phase 3's model: f32 from seed 0, then cast, so its tokens are phase 3's.
    model = create_named_model(model_name, seed=0, dtype=torch.float32, device=device).to(torch.bfloat16)
    requests = make_requests(model.config.vocab_size, n=n_requests, system_len=system_len)
    report["engine_runs"] = telemetry_engine(device, model, requests, engine_kw, plain_tokens)
    del model
    free_memory(device)
    log(f"[time] telemetry (a) engine {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report["training"] = telemetry_training(device, MODEL_REGISTRY[model_name](), seq, batch, warmup, timed_steps)
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
DIST_CHECKPOINT_LAYERS = 2
DIST_GUARD_STEPS = 4
# The launcher's variables phase 14 sets for its world-1 NCCL group, and
# puts back after.
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def reset_port_state(partial=False):
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    if partial:
        PartialState._reset_state()


class world_one_group:
    """A one-process group for the block: the launcher's variables set (a
    free port on 127.0.0.1), `PartialState` built on them (NCCL on the card,
    gloo on the CPU), and on exit the group destroyed, the singletons reset
    and the variables as they were."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        from accelerate_tpu_torch.launchers import free_port
        from accelerate_tpu_torch.state import PartialState

        self.saved = {k: os.environ.get(k) for k in DIST_ENV}
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(free_port()))
        reset_port_state(partial=True)
        try:
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


def dist_run(device, config, strategy, batch, seq, warmup, timed_steps, profile_step=False):
    """One run of phase 14 (a): `train` under `strategy` ("bare": no
    group), inside a one-process group otherwise."""
    import contextlib

    from accelerate_tpu_torch.ops import flash_attention as fa

    free_memory(device)
    fa.reset_launch_counts()
    on_card = device.type == "cuda"

    def before_step(i, step_fn):
        if i == warmup and on_card:
            torch.cuda.reset_peak_memory_stats(device)

    group = contextlib.nullcontext() if strategy == "bare" else world_one_group(device)
    with group:
        backend = torch.distributed.get_backend() if strategy != "bare" else None
        losses, seconds, pmodel, step_fn, last = train(
            device, config, "bf16", batch=batch, steps=timed_steps, seq=seq, warmup=warmup, on_step=before_step,
            accelerator_kw=dist_accelerator_kw(strategy))
        launches = dict(fa.LAUNCHES)
        report = step_report(batch, seq, seconds, warmup, pmodel.num_parameters, config, launches)
        report.update(strategy=strategy, backend=backend, losses=losses)
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
    order = ("bare", *DIST_STRATEGIES, *reversed(DIST_STRATEGIES), "bare")
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


def dist_phase(device, model_name="llama-1b", seq=TRAIN_SEQ, batch=2, warmup=2, timed_steps=8,
               checkpoint_layers=DIST_CHECKPOINT_LAYERS, guard_steps=DIST_GUARD_STEPS):
    """Phase 14: data parallel and FSDP/ZeRO through NCCL at world 1."""
    import dataclasses

    from accelerate_tpu_torch.models import MODEL_REGISTRY

    config = MODEL_REGISTRY[model_name]()
    report = {"model": model_name}
    env_before = {k: os.environ.get(k) for k in DIST_ENV}
    t0 = time.perf_counter()
    report["training"] = dist_training(device, config, batch, seq, warmup, timed_steps)
    log(f"[time] dist (a) training {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report["guard"] = dist_guard(device, config, batch, seq, warmup=warmup, steps=guard_steps)
    log(f"[time] dist (b) guard {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report["checkpoint"] = dist_checkpoint(device, dataclasses.replace(config, num_hidden_layers=checkpoint_layers),
                                           seq)
    log(f"[time] dist (c) checkpoint {time.perf_counter() - t0:.1f}s")
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
        bf16, f32 = flash[name]["bfloat16"], flash[name]["float32"]
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
    parser.add_argument("--compare", nargs="+", metavar="TREE",
                        help="time the flash kernels of each source tree instead, in turns (a b b a)")
    parser.add_argument("--head-dim", type=int, default=FLASH_SHAPE["d"], choices=(16, 32, 64, 96, 128, 256),
                        help="--compare's head dimension (default: the training shape's)")
    parser.add_argument("--compare-worker", metavar="TREE", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
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
    phase3_tokens = {}
    engine = engine_phase(device, profile=args.profile, tokens_out=phase3_tokens)
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
    telemetry = telemetry_phase(device, plain_tokens=phase3_tokens)
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
        family_generate[name] = family_generate_phase(device, name, profile=args.profile)
        log(f"[time] {name} generate phase {time.perf_counter() - t0:.1f}s")
    for name in FAMILIES:
        t0 = time.perf_counter()
        family_train[name] = family_training_phase(device, name, FAMILY_TRAIN_LAYERS[name], profile=args.profile)
        log(f"[family] {name} training summary: {json.dumps(family_train[name])}")
        log(f"[time] {name} training phase {time.perf_counter() - t0:.1f}s")
    log(f"[family] generate summary: {json.dumps(family_generate)}")
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

    # the families at each head dim
    wide_runs = {96: family_train["gpt-neox-20b"], 256: family_train["gptj-6b"], 128: mixtral_train}
    rows = paged_rows(kernels, engine, KERNEL_SHAPE, PAGED_DESIGN)
    # Llama-1B's bf16 K3-K5 run under bf16, under fp8 (whose attention is
    # bf16) and in phase 15's eager loops (the dispatcher's and the shard
    # loader's).
    surface_runs = (surface["training"]["dispatcher"], surface["training"]["shard_loader"])
    bf16_launches = {k: v + fp8["training"]["launches"][k] + sum(r["launches"][k] for r in surface_runs)
                     for k, v in training["bf16"]["launches"].items()}
    rows += flash_rows(flash, bf16_launches, training["fp16"]["launches"], FLASH_SHAPE)
    rows += paged_rows(neox_kernels, neox, NEOX_KERNEL_SHAPE, PAGED_SCALAR_DESIGN, suffix="_neox")
    for d, shape in FAMILY_FLASH_SHAPES.items():
        run = wide_runs[d]
        rows += flash_rows(wide_flash[d], run["bf16"]["launches"], run["fp16"]["launches"], shape,
                           suffix=f"_d{d}", design=WIDE_FLASH_DESIGN[d])
    rows += flash_rows(t5_flash, t5_train["bf16"]["launches"], None, T5_CROSS_FLASH_SHAPE, suffix="_t5cross",
                       design=T5_CROSS_DESIGN, causal=False, scale=1.0)
    # At head dim 16 the path is T5-tiny's cross-attention: non-causal, scale 1.0.
    rows += flash_rows(d16["non_causal"], d16["t5"]["bfloat16"]["launches"], d16["t5"]["float16"]["launches"],
                       D16_FLASH_SHAPE, suffix="_d16", design=WIDE_FLASH_DESIGN[16], causal=False, scale=1.0)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
