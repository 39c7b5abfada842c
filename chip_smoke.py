#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), its torch name and
   the device count.
2. Build: the three hand-written kernel libraries from the checkout's
   sources, one nvcc per library, all started together; build seconds and
   the -Xptxas -v reports (registers, static shared memory and spill bytes
   of each kernel: the back-projector once per compiled tile and wire
   type, the ramp filter once per compiled pad).
3. Back-projection kernel vs plain version: the kernel against its plain
   torch version on the same encoded stream, for all five codecs, at the
   full 512^3 width on the first 32 RabbitCT projections, at
   default_geometry(64), and at the 2 x 2 mesh's call shapes (phase 20):
   each x-slab of 256 with P shifted as the mesh shifts it, and each of its
   four y-chunks, on every 8th projection of each data rank's half.
   Max |kernel - plain| / max |plain| <= 1e-5: both read identical wire
   bytes and scales; only nvcc's FMA contraction and the kernel's lerps
   separate them, and bilinear interpolation is continuous across pixel
   edges, so a flipped floor() costs round-off only.
4. Reconstruction path: ReconstructionPlan(geometry=RabbitCT,
   impl="kernel", precision=...).build()(proj) for fp32 and fp16 on
   projections from the port's forward_project. Per run: seconds, GUPS,
   peak device memory, kernel launches (> 0), interior RMSE vs the phantom
   (< 0.17); and fp16 within Precision("fp16").rmse_tol() of fp32. The
   share of (tile, projection) pairs whose footprint boxes exceeded the
   kernel's staging buffer and were gathered from global memory.
5. Back-projection kernel time at that path's shapes, f32 and fp16 (CUDA
   events over 10 launches after a warm-up), beside the bound, and at the
   delta shape ([kernel-delta] times it, with its own [bp-time] line); the
   same kernel with a staging budget of 0, so that every projection is
   gathered from global memory (the design without staged taps); the plain
   version's time, and the kernel's beside it, on the 32-projection subset.
   [filter] The ramp filter kernel on the RabbitCT projections, every
   window, against the torch.fft chain that filtered on the card before it
   (FILTER_REL of the max) and, on two projections, against the CPU's
   plain version; one projection alone, the first 32 and all 496
   bit-equal where they overlap; its time (CUDA events) beside its bytes
   bound, its torch twin's on the 32-projection subset, and the chain's.
6. [kernel-delta] The kernel against its plain version at the streaming
   session's call shape, the 512^3 volume from the last delta of 62
   projections, five codecs (same bound), with the direct-gather share,
   and its time there (CUDA events, fp32 and fp16); the delta filtered
   alone against the same rows of the whole scan's filter; and the fold
   witness: on the central 64 x-planes, 8 deltas folded acc + bp against
   one pass over all 496 projections, by the kernel and by its plain
   version (equal gaps: the session's distance from fused is the fold's
   reassociation).
7. [incremental] The streaming session, `plan.build_incremental(source=
   ProjectionSource(...))` with n_steps = 8, fp32 and fp16: a scanner
   thread appends the projections in 8 deltas of 62 to a
   StreamingProjectionWriter store in a temporary directory, and the
   session poll()s and folds them as they commit (fp32; the fp16 session
   polls the committed store). Gates: finalize() within 1e-5 of the max of
   the same plan's fused build(); interior RMSE < 0.17; fp16 within
   Precision("fp16").rmse_tol() of fp32; finalize(partial=True) after 4
   deltas (the scanner waits for it) runs and has 248 angles folded; 8
   kernel launches per session. Then the reference benchmark's tail,
   three times: 7 deltas folded, the 8th staged, update(staged,
   finalize=True) timed; t_last_delta beside fused_seconds / 8, and
   whether the JAX package's streaming claim (t_last_delta < batch_e2e /
   n_steps) holds here (printed, not gated).
8. [batched] build_batched(2) on the phantom's scan and a copy scaled by
   1.5, fp32 and fp16: each lane bit-equal to build() of its scan (N_p =
   496 is not a multiple of the filter's 32-projection batches); seconds
   per batch beside 2 x seconds per scan.
9. [io] ProjectionSource.write(..., codec="fp16") of the projections, then
   build(source=, sink=)() (fp32 plan): the loaded projections bit-equal
   to the codec's decode of its encode, the volume bit-equal to build() of
   them, VolumeSink.read() bit-equal to the volume; stage.read and
   stage.write seconds and GB/s of the bytes on disk.
10. [trace] The tracer on around one fp32 build() call: the fenced
   engine.reconstruct span at least the kernel's CUDA-event time, the
   exported Chrome JSON loads, the engine cache's cache.core.engine_cache.*
   counters are in the registry's snapshot.
11. [tiles] Every compiled tile of the back-projector (kernel.TILES) x
   five codecs against the plain version on the 32-projection subset,
   within 1e-5 of the max, with the direct-gather share per tile and the
   tuner's staging model (kernel.staging_stats) held to the kernel's
   direct count; each tile's time (CUDA events, 3 launches) at the full
   RabbitCT shape and at the delta shape (512, 512) x 62, fp32 and fp16.
12. [tune] Measured tuning (tune.autotune(measure=True), on the call's
   real matrices) at those two shapes and codecs: the winner and its time
   beside the default tile's, and the file cache's hit on a second call
   after clear_cache(). Then ReconstructionPlan(impl="kernel") at
   RabbitCT with the tuned launch: the RMSE gate, and within 1e-5 of the
   default launch's volume.
13. [traced] build_traced() at RabbitCT, fp32 and fp16, 3 runs each with
   the tracer on (they fill the calibration store): the volume within
   1e-5 of build()'s, the stages' seconds and their sum beside build()'s
   wall time; obs.attribution.compare against predict_plan under ABCI
   and H100, per stage; the traced incremental session (8 deltas) within
   1e-5 of fused; 3 traced factorized runs on 32 projections.
14. [machine-spec] The single-card terms of perf_model.H100 measured:
   the factorized path's GUPS on 32 projections, RabbitCT's projections
   over [traced]'s mean fp32 stage.filter span, a pinned host-to-device
   copy, [io]'s store read and write rates; beside the values the
   module holds.
15. [auto] The MachineCalibration fitted from those runs; then
   plan_from_spec(g, "auto") (stock and calibrated) and auto_plan(...,
   measure=True) at RabbitCT: the plan picked, predicted beside measured
   seconds, whether impl="kernel" was admitted, and the picked plan's
   reconstruction within the RMSE gate. Each phase from 11 on prints its
   seconds. The tuning and calibration files, the stores and the
   checkpoints live in a temporary directory for the run.
16. [service] ReconstructionService(device="cuda", max_batch=4) with
   spec="auto" (the calibration [traced] filled), two rounds of the same
   traffic: family A pins impl="kernel" and sends the phantom's scan and
   copies scaled by 1.5 and 0.5 (one bucket of 3 lanes); family
   B pins impl="kernel", precision="fp16" and sends the phantom's scan in
   memory and [io]'s fp16 ProjectionSource with a VolumeSink. Gates:
   every ticket DONE; each volume bit-equal to
   plan_cache.resolve(family).build()(scan); the sink's read() bit-equal
   to its ticket's volume; the phantom scan's interior RMSE < 0.17;
   5 lanes run per round (its engine spans' lanes); planner searches 2
   after both rounds; a service whose hbm_bytes is below one scan's
   footprint raises AdmissionError and counts it; max_queue=2 raises
   QueueFullError on the third submit. Printed: seconds per drain beside the warm single-scan
   build() seconds of the same scans, the footprint, the bucket capacity
   under the card's memory and the peak memory, the queue-wait, assembly
   and time-to-volume means, each bucket's assembly, engine and
   write-behind spans, the source load's seconds under an engine span
   (prefetch overlapping compute).
17. [serve-loop] serve(), 4 family-A submits with deadline_s = 4 x the
   measured per-scan seconds, wait(timeout=120), shutdown(): every ticket
   DONE and bit-equal as above, and the mean time-to-volume at least one
   scan's seconds (DONE waits for the card); SLO met/missed, scans/hour,
   loop passes and errors.
18. [resumable] ResumableReconstruction over 8 micro-batches of 62
   projections; each step folds its batch through the kernel with the
   streaming session's stage() and fold into a 512^3 f32 accumulator on
   the card. A CheckpointManager in the run's temporary directory,
   checkpoint_every=2, fail_at=5; a fresh instance resume()s. Gates: the
   cursor resumes at 4; the resumed result bit-equal to an uninterrupted
   run; after fdk_scale within 1e-5 of the max of the fused build()
   volume. Printed: seconds and GB/s of each save (512 MiB) and of the
   restore; the StragglerMonitor over the uninterrupted run's 8 steps.
19. Mesh 1 x 1 over NCCL: the mesh engine (`ReconstructionPlan(mesh=...)`,
   core/plan.py) on a (pod, data, model) = (1, 1, 1) mesh over a world of
   one, at RabbitCT, fp32 and fp16: fused/psum, pipelined (4 steps)/
   scatter, chunked (2 steps x 4 y-chunks)/psum and /scatter_bf16. Seconds
   and GUPS beside the mesh=None engine's in the same run, kernel
   launches, the bytes each collective moved. psum and scatter outputs
   bit-equal to mesh=None (gather and reduce are identities on one rank);
   scatter_bf16 within 4 * 2^-8 of the max of chunked/psum (one bf16
   rounding per rank). Then the incremental session (fp32, 8 deltas) under
   psum, scatter and scatter_bf16: psum and scatter bit-equal to the
   mesh=None session, scatter_bf16 within 4 * 2^-8 of psum's; and
   build_traced() and the traced session (fp32, psum) bit-equal to
   mesh=None's.
20. Mesh 2 x 2 on one card: first the references on one device, fp32:
   the mesh=None engine (the kernel), and the plain version over all 496
   projections, once for the whole volume and once slab by slab with P
   shifted as the 2-slab mesh shifts it. The kernel's volume within 1e-5
   of the plain whole volume; the plain shifted volume's distance from the
   plain whole one is the witness (what folding the slab offset into P
   costs in f32). Then four spawned ranks of this script on a (1, 2, 2)
   mesh, through gloo with CUDA tensors (NCCL refuses two ranks on one
   card; PERF.md), run fused/psum, pipelined (2 steps)/scatter and chunked
   (2 x 4)/scatter_bf16; a collective that raises fails the run. Per case:
   the kernel's call shape, launches and direct-gather share per rank;
   `assemble_volume` of the outputs within 1e-5 of the max of the plain
   shifted volume, and within the witness + 2e-5 of the mesh=None volume
   (the triangle through the two plain volumes); 4 * 2^-8 for
   scatter_bf16, both. The library is built before the ranks start.
   After fused/psum each rank saves its slab as a sharded checkpoint,
   save_checkpoint(dir, 1, {"vol": snapshot(part, mesh, spec)}) with the
   engine's spec (x over model, replicated over data), and loads it back
   with mesh=, its own part bit-equal; this process then loads it with
   mesh=None, bit-equal to the assembled volume. Printed: seconds, and the
   shard files each load opened.
21. backproject_mxu against the factorized oracle at default_geometry(32)
   on the card, within the reference's own bound (rtol 1e-4, atol 1e-6).
22. Attention kernel vs plain version at the serving shapes (4 requests x 12
   heads over 2 KV heads, S = 2048, D = 128, inputs from numpy): f32 causal
   and non-causal within rtol = atol = 2e-5 (the reference kernel's test
   bound), bf16 causal within a max abs difference of 0.02 (its bf16
   bound), and a ragged S = 2000 in both dtypes; Qwen2-MoE's group-1 shape
   (16 heads over 16) and the Jamba pattern's group-8 shape (64 heads over
   8) causal in both dtypes. Then f32 causal with q
   and k scaled by 3 (a peaked softmax), where the plain version's own f32
   sums sit ~3e-5 from the exact function: the kernel within rtol = atol
   = 2e-5 of the f64 evaluation, and no farther from it than the plain
   version. Also DeepSeek-Coder-33B's group 7 (4 x 56 heads
   over 8 at S = 2048, D = 128) in both dtypes, and its time beside the
   bound and SDPA's. Then [window-check], the sliding window: the kernel
   against its plain version at Mixtral's attention shape (32 heads over
   8, S = 8192, D = 128, window 4096) and with S = 5000 and a window of
   1500 (neither a multiple of the 64-key tile), both dtypes at the bounds
   above, and each against the f64 function: f32 within rtol = atol =
   2e-5, bf16 with its max error and relative RMSE within twice the
   plain version's (both round f32 sums once to bf16; 0.02 is about a
   typical output there, too loose for an edge tile); then its time at
   Mixtral's shape beside the operations bound, 4 D sum_i min(i + 1, W)
   per head, the plain version and SDPA with the window as a boolean
   mask.
23. Serving path: greedy_generate on full-width Qwen2-1.5B (28 layers,
   random weights from a seeded generator) for 4 requests x 2048-token
   prompts and 32 greedy steps, s_max = 2080. Prefill seconds, decode ms per
   step, tokens/s, peak device memory, attention-kernel launches (exactly
   28 per prefill); a traced run for where the time goes. Checks: the
   kernel path against the plain attention step on the card (bf16 and f32
   prefill logits), and decode_step's logits at position 2048 against a
   prefill over the prompt plus that token (see `serving`).
24. Attention kernel time at the serving shape (CUDA events over 20 launches
   after a warm-up) for bf16 and f32, beside the bound (for f32 the 3xTF32
   bound, three TF32 products per product at the dense TF32 rate, and the
   f32 cores' beside it), the plain version's time and torch's
   scaled_dot_product_attention on the same tensors with its max distance
   from the plain version (the library yardstick; the port never calls
   it).
25. [train-check] The attention kernel under autograd
   (`flash_attention_trainable`) at the serving shape, f32 and bf16, with
   dO from numpy: its forward within the phase-22 bounds of the plain
   version, dq, dk, dv bit-equal to autograd through
   `prefill_attention_plain`; the raw wrapper raises on operands that
   require grad. Then `loss_and_grads` (loss_fn, remat) at Qwen2-1.5B's
   full width with the depth cut to 4 layers, 2 x 2048 tokens, block
   weights at std 1 / sqrt(fan_in): kernel path against the plain
   attention step, in f32 the loss and each leaf's gradient within a
   relative RMSE of 1e-3, in bf16 the kernel path's distance from the f32
   plain path at most twice the bf16 plain path's, for each leaf's
   gradient and for the per-token cross entropies (relative RMSE; the
   mean loss is printed, not gated: a single mean of 4096 roundings lands
   anywhere inside their noise).
26. [train] make_train_step(microbatches=2, warmup=2, total_steps=16,
   remat=True) on full-width, full-depth Qwen2-1.5B (init_train_state,
   seed 0) with SyntheticTokens(batch=4, seq=2048): 6 steps on one fixed
   batch (loss and grad norm finite, the last loss below the first), a
   warm-up step on the stream under the profiler, 6 timed steps. Every
   step launches the attention kernel 28 x 2 (remat) x 2 micro-batches =
   112 times; opt.step counts the 13 steps; the params are finite and
   moved. Printed: median step seconds, tokens/s, 6 N tokens / step
   beside the bf16 peak, the AdamW update's seconds (CUDA events), peak
   device memory, the profile, and the kernel's time at the training
   shape (2 x 12 heads, S = 2048) beside its bound. Each of 25 and 26
   prints its seconds.
27. [launch] The dry run (`repro_torch.launch`) against the card. First
   the card's rates: a bf16 8192^3 torch.matmul and a 4 GiB device copy
   (CUDA events), beside the H100 SXM datasheet figures the roofline
   prices with. Then the [serve] prefill (4 x 2048) and one [train] step
   (4 x 2048 in 2 micro-batches, remat) of full Qwen2-1.5B, each dry-run
   on a fake world of one (fake tensors, no card) and run on the card,
   both counted by the dry run's TraceCounter. Gates: the FLOPs equal
   exactly (the same program), the attention operator reached as often
   as the card launches the kernel (28 a prefill, 112 a step), and the
   predicted peak memory within LAUNCH_MEM_BAND of the measured (both
   from the inputs' allocation on). Printed: each run's seconds as a
   fraction of its roofline bound. Two production cells, Qwen2-1.5B x
   train_4k and the paper's 4k reconstruction (the kernel's launch
   operator) on the 256-rank (32, 8) mesh, are dry-run in subprocesses
   on the host while phases 28-34 use the card; their rows and seconds
   are printed before phase 35. (Phase 26's weights and state are freed
   before this phase and each below, which prints the device memory
   still allocated on entry.)
28. [moe-serve] Qwen2-MoE-A2.7B at full width and depth (24 layers, d_model
   2048, 16/16 heads of 128, 60 experts top-4 of 1408, 4 shared, capacity
   factor 1.25, vocab 151 936; init_params(seed 0) with the draw's peak
   memory): the serving traffic of phase 23 through greedy_generate, 24
   kernel launches per prefill (gated); prefill seconds, decode ms per
   step, tokens/s, peak memory; the share of (token, choice) pairs the
   capacity dropped in the prefill, from the router's own outputs; a
   traced prefill and decode step; both kernels timed at the group-1
   shape. Then [moe-check] at full width and 2 layers, block weights at
   1 / sqrt(fan_in): the share of tokens whose top-4 set differs between
   the kernel path and the plain attention step (bf16, f32), then phase
   23's logit checks (kernel path vs plain step, f32 and bf16), and decode
   vs prefill on a copy at capacity factor E / k, where nothing drops
   (prefill with drops and decode without them are different
   computations), bound 2 x that copy's bf16 plain path from its f32 one.
29. [ssm-serve] Mamba-2-130M at full width and depth (24 layers, d_model
   768, SSD d_state 128, head_dim 64, chunk 256): the same traffic, 0
   kernel launches (attention-free); decode_step's f32 logits at position
   2048 against an f32 prefill over 2049 tokens within the reference's SSM
   tolerance (rtol 1e-4, atol 1e-5 x the max).
30. [hybrid] Jamba-1.5-Large's pattern: one repeat of its 8 sub-layers
   (attention at 4, MoE on odd indices), d_model 8192, 64/8 heads of 128,
   16 experts top-2, its SSD as published (256 heads of 64, d_state 128);
   cut to d_ff / d_ff_expert 4096, the only widths cut. The same traffic,
   1 launch per prefill (gated); then, on the same
   weights rescaled to 1 / sqrt(fan_in), phase 23's logit checks with the
   decode check on a no-drop copy as in [moe-check].
31. [mixtral] Mixtral-8x7B at every published width (d_model 4096, 32/8
   heads of 128, 8 experts top-2 of 14336, capacity factor 1.25, window
   4096, vocab 32 000) with its depth cut to 8 of 32 layers (47.49 GB of
   f32 weights; the phase prints the cut): greedy_generate over 4 x
   2048-token prompts (S <= window: the causal kernel) and 1 x 8192 tokens
   (S > window: the windowed kernel, and a decode ring of 4096 slots that
   the 32 steps wrap), each with 8 launches a prefill gated, windowed ones
   exactly for the long prompt; the drop share from the router's outputs;
   a traced long prefill. Then [mixtral-check] at full width and 2
   layers, block weights at 1 / sqrt(fan_in): phase 23's logit checks at
   both prompt lengths, all on a copy at capacity factor E / k, where
   nothing drops (with token-major capacity counting, a bf16 rounding
   that moves one early token's top-2 set could otherwise drop a choice
   of the last token, a different computation); the long prompt's decode
   step wraps the ring.
32. [musicgen] MusicGen-Large at full width and depth (48 layers, d_model
   2048, 32/32 heads of 64, 4 codebooks of 2048; 9.8 GB f32): 4 x 4 x
   2048-code prompts, 32 steps of (B, 4, 1) codes, 48 launches a prefill;
   a traced prefill; the kernel's DP = 64 instantiation at this shape
   against its plain version, and its time beside the bound and SDPA's,
   and the stressed f32 case of phase 22 (q, k x 3 against f64) at DP =
   64; then, after printing (not gating) at the stacked init the f32
   kernel and plain paths' distances from each other and from the f32
   model with its attention step in f64, phase 23's logit checks with
   decode at position 2048 on the weights rescaled to 1 / sqrt(fan_in),
   as [hybrid] runs them: 48 layers of near-one-hot softmax amplify f32
   summation order.
33. [vlm] InternVL2-26B at every published width (d_model 6144, 48/8
   heads, d_ff 16384, vocab 92 553, projector 3200 -> 6144) with its depth
   cut to 12 of 48 layers: 4 x (256 image + 1792 text)-position prompts,
   32 steps, 12 launches a prefill; a traced prefill; phase 23's logit
   checks on the served weights, with decode at position 256 + 1792,
   behind the image positions; then, as [musicgen] runs them, the same
   checks on the weights rescaled to 1 / sqrt(fan_in), where the bf16
   bounds are tight.
   Each of 31-33 prints the device memory still allocated on entry and
   its seconds.
34. [lm-mesh] The sharded LM substrate on a (data 2, model 2) mesh of
   four ranks sharing the card (gloo over CUDA tensors: NCCL refuses two
   ranks on one card; the script spawns itself with --lm-mesh-rank after
   the libraries are built). First the oracles, each the same model run
   unsharded in this process on the same weights (seed 0), with the
   kernel: Qwen2-1.5B whole and Qwen2-MoE-A2.7B at every published width
   with its depth cut from 24 to LM_MESH_MOE_LAYERS, each on the serving
   prompts (4 x 2048): the f32 copy's prefill logits, 8 decode steps
   teacher-forced on fixed tokens, the MoE's (token, choice) drops per
   layer, and in bf16 greedy_generate's ids, the kernel's and the plain
   step's prefill logits; the MoE through ShardingRules on a shape-only
   (data 1, model 2) mesh, whose constraints are identities on plain
   tensors and whose tp_size() 2 selects the grouped dispatch (2 groups
   of 1024 tokens, 86 slots an expert against 171 in one group). Then
   one f32 train step of Qwen2-1.5B at 4 of 28 layers, full width, on
   4 x 2048 tokens in 2 micro-batches. Each rank prints the device
   memory allocated when it enters and runs the same under
   ShardingRules(mesh, fsdp=False) for serving (weights over the model
   axis only: gloo moves ~0.3 GiB/s through the host here, and ZeRO-3
   would gather every layer's weights at each step) and the default
   rules (ZeRO-3) for the train step, with the attention kernel on its
   own heads. The train step runs twice, each time beside its gradients
   (`step_grads`, the step's micro-batches) on the same weights: at the
   stacked init (timed; each small leaf's gradient distance and its
   update's sign flips printed, not gated) and on the weights rescaled
   to 1 / sqrt(fan_in), from second moments of each leaf's mean square
   clipped gradient (`smooth_moments`), where the update is smooth in
   the gradient. Gates: f32 logits and decode steps within relative RMSE
   F32_LOGITS_REL of the oracle's; bf16 prefill logits on the fan-in
   weights within twice the plain step's distance from the f32 oracle
   (at the stacked init printed only); the MoE's drops per layer equal
   to the oracle's; per rank and prefill 28 (Qwen2) and 4 (MoE) kernel
   launches, 16 per train step; loss and gradient norm within
   F32_LOGITS_REL at both inits; on the fan-in weights every leaf's
   gradient and update within F32_LOGITS_REL relative RMSE, and two
   controls, an unchanged state and one leaf's gradient halved, past
   that bound. Prints times, the drop share and the grouped einsums'
   operations against the expert GEMMs'. Each rank is fed only its dp
   rows of every input (the prompts, the teacher-forced ids, the train
   batch: 2 of 4 rows, cut locally as the rules lay a batch out) and
   reports their local shapes, gated. Each rank measures its peak memory
   (`torch.cuda.max_memory_allocated()`) over its bf16 Qwen2-1.5B
   prefill and over each train step, as the peak above what it held
   before the call plus the call's inputs (its weight or state parts and
   its rows); meanwhile this process dry-runs the same two cells on a
   fake (2, 2) world (`launch.dryrun.run_cell`, ShardingRules as the
   ranks use them), and each rank's peaks are gated within
   LAUNCH_MEM_BAND of the dry run's prediction.
   [lm-ckpt], in the same ranks after the fan-in train step: every rank
   saves its share of the trained f32 TrainState (DTensor leaves) to one
   checkpoint, restores it onto the (2, 2) mesh (gated bit-equal, leaf
   by leaf) and onto a (1, 4) mesh of the same ranks (saved again as
   step 2), and takes one more train step from the restored state and
   one from the live state (gated bit-equal). This process then loads
   both steps whole (mesh=None): step 2 bit-equal to step 1, and step
   1's update (less the fan-in init) within F32_LOGITS_REL of the
   unsharded oracle's, leaf by leaf. Prints save and restore GB/s.
35. The `kernels` JSON line (each kernel with the PR of its design and
   its launches by path; the back-projector's launches sum every path
   that runs it: phases 4, 7-10, 12, 14-18, 19 and 20's ranks, the
   attention kernel's the serving prefills (phases 23, 27, 28-34, phase 34
   summed over its ranks) and the training steps (26, 27), the ramp
   filter's the same reconstruction paths as the back-projector's, both
   codecs together, gated at one launch a filter_fn call (a
   reconstruction's micro-batch, a delta, a lane, a rank's share); each
   counted from 0 just before the path; a path on
   another wire type's instantiation, such as the auto plan's, is printed
   beside it; the attention entries also carry the windowed kernel's,
   the DP = 64 instantiation's and group 7's times and bounds), the
   card's name and power limit, and last
   `{"ok": true, "device": {...}}`.

The RabbitCT geometry is the public back-projection benchmark's size (496
projections of 1248 x 960 pixels into 512^3; Rohkohl et al., Med. Phys.
36(9), 2009) with default_geometry's source and detector distances. It
exits non-zero, printing no result, without a CUDA device or outside a
checkout. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import dataclasses
import datetime
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

REL_TOL = 1e-5          # kernel vs plain version, relative to max |plain|
RMSE_BOUND = 0.17       # interior RMSE vs the phantom (JAX suite at 24^3)
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12   # H100 SXM f32, outside the tensor cores
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM bf16, dense tensor cores
PEAK_TF32_OPS_PER_S = 494.7e12  # H100 SXM TF32, dense tensor cores
TF32_SPLIT_PRODUCTS = 3  # 3xTF32: hi hi + hi lo + lo hi per f32 product
# f32 operations the back-projection needs (a multiply-add counts 2), for
# the operations bound. Per voxel column (i, j) and projection, the
# Theorem 2/3 invariants: x0, y0, z (4 each), 1/z, u = x0/z, w = s/z^2 (2),
# floor(u), its fraction and complement (3), and v(k) = a + b k's a = y0/z
# and b = p6/z (1 each): 21. Per mirrored pair (i, j, k < nz/2) whose
# gathers touch the detector: v(k) (2), the mirror v~ (1), two 4-tap
# gathers at 14 (floor(v), fraction, complement, 4 tap weights, 4 tap
# products, 3 sums) and two weighted accumulates (2 each): 35. The kernel
# itself recomputes the column terms in every thread; that is its cost,
# not the function's.
COLUMN_OPS = 21
PAIR_OPS = 35
# The change that made each kernel's design.
DESIGN = {"bp_dual_kernel<float>": "PR 30", "bp_dual_kernel<__half>": "PR 30",
          "fa_fwd_bf16_kernel": "PR 13", "fa_fwd_f32_kernel": "PR 16",
          "ramp_filter_kernel<11>": "PR 28"}
# The ramp filter kernel against the torch.fft chain: two f32 transforms
# of length 4096 agree to a few ulps of a row's largest output times
# log2(pad); 1e-5 of the max is the JAX package's bound between two f32
# FFTs.
FILTER_REL = 1e-5
FILTER_WINDOWS = ("ramlak", "shepp-logan", "hann", "hamming")
TIMED_LAUNCHES = 10
PLAIN_RUNS = 3
CODECS = ("fp32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")
MAIN_PATH_CODECS = ("fp32", "fp16")
WITNESS_SLAB = 64       # central x-planes of [kernel-delta]'s fold witness
SUBSET = 32             # RabbitCT projections in the kernel-vs-plain check
# The streaming phases: RabbitCT in 8 deltas of 62 projections.
N_STEPS = 8
TAIL_RUNS = 3           # sessions whose last-delta fold is timed
STREAM_DEADLINE_S = 300  # a streaming session, first poll to last fold
MESH_SESSION_REDUCES = ("psum", "scatter", "scatter_bf16")
# The launch-shape and planner phases.
TILE_RUNS = 3           # timed launches per (tile, shape, codec) in [tiles]
TRACED_RUNS = 3         # traced RabbitCT runs per codec: the calibration
                        # store's MIN_SAMPLES per constant
H2D_BYTES = 1 << 30     # [machine-spec]'s pinned host-to-device copy
H2D_RUNS = 5

# Serving: Qwen2-1.5B at full width, 4 requests x 2048-token prompts.
SEED = 0
BATCH, PROMPT, STEPS, S_MAX = 4, 2048, 32, 2080
RAGGED = 2000           # a prompt length that is not a multiple of a tile
ATTN_F32_TOL = 2e-5     # rtol = atol, the reference kernel's f32 test bound
ATTN_BF16_MAX_ABS = 0.02  # the reference kernel's bf16 test bound
# The stressed f32 case: q and k scaled by 3, a peaked softmax that
# amplifies score errors. There the plain version's own f32 sums sit ~3e-5
# from the exact function, so the kernel is held to the f64 evaluation.
ATTN_STRESS = 3.0
# f32 prefill, kernel path vs plain path: last-position logits' relative
# RMSE. Only the attention sums' order differs (~1e-7 relative per output);
# 28 layers of random weights amplify that, but not by 10^4.
F32_LOGITS_REL = 1e-3
ATTN_RUNS = 20
# Training: Qwen2-1.5B at full width, 4 x 2048 tokens a step in 2
# micro-batches, remat on; [train-check] cuts the depth to 4 layers.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES = 4, 2048, 2
TRAIN_WARMUP, TRAIN_TOTAL = 2, 16
FIXED_STEPS, TIMED_STEPS = 6, 6   # one fixed batch; then 1 warm-up + timed
TRAIN_CHECK_LAYERS = 4
# MoE, SSM and hybrid serving: the same traffic (BATCH, PROMPT, STEPS,
# S_MAX). [moe-check] cuts Qwen2-MoE's depth to 2 layers; [hybrid] runs
# one repeat of Jamba's 8-sub-layer pattern at its published d_model,
# heads and SSD, with d_ff and d_ff_expert cut from 24576 to HYBRID_D_FF:
# 43.68 GB of f32 weights, and the phase's f32 checks peak near 61 GB on
# an 80 GB card. Each 1024 more of both FFN widths adds 6.8 GB of weights
# and grows the no-drop expert buffers; keeping d_model (the SSD's heads
# and every projection) is the cut that leaves the mixers as published.
MOE_CHECK_LAYERS = 2
HYBRID_D_FF = 4096
SSM_RTOL, SSM_ATOL = 1e-4, 1e-5   # the reference's SSM test tolerance
# The last five configs. [window-check] holds the windowed kernel at
# Mixtral's attention shape (32 over 8 heads of 128, one request of
# WINDOW_SEQ tokens, its window 4096) and at an edge case where neither S
# nor the window is a multiple of the 64-key tile. [mixtral] serves
# Mixtral-8x7B at every published width with its depth cut to
# MIXTRAL_LAYERS of 32 (5.8 GB of f32 weights a layer), the serving
# traffic and one request of WINDOW_SEQ tokens (longer than the window:
# the windowed kernel, and a decode ring of 4096 slots that wraps); its
# checks cut the depth to MIXTRAL_CHECK_LAYERS. [musicgen] serves
# MusicGen-Large whole; [vlm] InternVL2-26B at every published width with
# its depth cut to VLM_LAYERS of 48, 256 image positions first.
WINDOW_SEQ = 8192
WINDOW_EDGE = (5000, 1500)        # (S, window), both ragged for the tile
MIXTRAL_LAYERS = 8
MIXTRAL_CHECK_LAYERS = 2
VLM_LAYERS = 12

# [lm-mesh]: the sharded LM on a (data, model) mesh of four gloo ranks
# sharing the card; 8 decode steps; Qwen2-MoE's depth and the train
# step's cut to 4 layers.
LM_MESH_SHAPE = (2, 2)
LM_MESH_STEPS = 8
LM_MESH_MOE_LAYERS = 4
LM_MESH_TRAIN_LAYERS = 4
LM_MESH_DEADLINE_S = 400
# The train step runs at the stacked init (timed; its small leaves'
# gradients and sign flips printed) and on the weights rescaled to
# 1 / sqrt(fan_in) (gated leaf by leaf). Leaves of at most
# LM_MESH_SMALL_LEAF elements (biases, norm scales) are the ones whose
# first AdamW step was seen to flip at the stacked init.
LM_MESH_TRAIN_INITS = ("stacked", "fan_in")
LM_MESH_SMALL_LEAF = 100_000

# [launch]: the card's bf16 GEMM and copy rates, then the dry run of the
# [serve] prefill and the [train] step on a fake world of one, held
# against the same runs on the card: FLOPs exactly, kernel calls, and the
# predicted peak memory within LAUNCH_MEM_BAND of the measured (fixed
# before the first card run). Two production cells are dry-run in
# subprocesses while later phases run.
LAUNCH_GEMM_N = 8192
LAUNCH_COPY_BYTES = 4 * 2**30
LAUNCH_RUNS = 10
LAUNCH_TIMED = 3
LAUNCH_MEM_BAND = 0.25
PRODUCTION_CELLS = (
    ("qwen2_1_5b x train_4k", ("--arch", "qwen2_1_5b", "--shape",
                               "train_4k")),
    ("ifdk-4k", ("--fdk", "--fdk-problem", "4k", "--bp-impl", "kernel")))
PRODUCTION_DEADLINE_S = 600

# Mesh phases: the (pod, data, model) engine of core/plan.py at RabbitCT.
MESH_AXES = ("pod", "data", "model")
# (schedule, its fields, reduce) on a world of one over NCCL, per codec;
# chunked + psum is the yardstick of chunked + scatter_bf16.
MESH_ONE_CASES = (("fused", {}, "psum"),
                  ("pipelined", {"n_steps": 4}, "scatter"),
                  ("chunked", {"n_steps": 2, "y_chunks": 4}, "psum"),
                  ("chunked", {"n_steps": 2, "y_chunks": 4}, "scatter_bf16"))
# Four ranks on the one card, fp32 codec, through gloo with CUDA tensors.
MESH_FOUR_SHAPE = (1, 2, 2)
MESH_FOUR_Y_CHUNKS = 4
MESH_FOUR_CASES = (("fused", {}, "psum"),
                   ("pipelined", {"n_steps": 2}, "scatter"),
                   ("chunked", {"n_steps": 2, "y_chunks": MESH_FOUR_Y_CHUNKS},
                    "scatter_bf16"))
# 2 x 2 vs the plain version's reconstruction with P shifted as the mesh
# shifts it: the kernel's round-off and the sums' order only.
MESH_REL_TOL = 1e-5
BF16_REDUCE_RTOL = 4 * 2.0 ** -8  # one bf16 rounding per rank (JAX suite)
PG_TIMEOUT = datetime.timedelta(seconds=300)
RANK_DEADLINE_S = 480   # a rank of the 2 x 2 phase, spawn to exit
# backproject_mxu vs the factorized oracle: the reference's own test bound
# (tests/test_kernels.py TestMXUVariant), at default_geometry(32).
MXU_RTOL, MXU_ATOL = 1e-4, 1e-6


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


class KernelCount:
    """A kernel counter of the default metrics registry, read as the count
    since `reset()`."""

    def __init__(self, name: str):
        self.name, self.base = name, 0

    def total(self) -> int:
        from repro_torch.obs.metrics import default_registry
        return default_registry().value(self.name, 0)

    def reset(self) -> None:
        self.base = self.total()

    @property
    def n(self) -> int:
        return self.total() - self.base


BP_LAUNCHES = KernelCount("kernels.backproject.launches")
FILTER_LAUNCHES = KernelCount("kernels.filter.launches")
ATTN_LAUNCHES = KernelCount("kernels.attention.launches")
ATTN_WINDOW_LAUNCHES = KernelCount("kernels.attention.window_launches")
# The filter kernel's launches by reconstruction path (the paths of the
# back-projector's `launches_by_path`), each counted from 0 just before it.
FILTER_BY_PATH: dict = {}


def reset_launches() -> None:
    """The back-projector's and the filter's counts to 0, before a path."""
    BP_LAUNCHES.reset()
    FILTER_LAUNCHES.reset()


def filter_calls(plan) -> int:
    """filter_fn calls of one scan (or one lane) through `plan`'s engine:
    one a micro-batch."""
    return 1 if plan.schedule == "fused" else plan.n_steps


def count_filter(path: str, calls: int) -> int:
    """The filter kernel's launches since `reset_launches()`, gated at one
    a filter_fn call (`calls` of them) and added to FILTER_BY_PATH[path]."""
    n = FILTER_LAUNCHES.n
    if n != calls:
        fail(f"{path}: {n} filter kernel launches, expected {calls} (one a "
             "filter_fn call)")
    FILTER_BY_PATH[path] = FILTER_BY_PATH.get(path, 0) + n
    return n


def direct_pairs(fn):
    """fn() in one fenced span of a fresh enabled tracer: its result, and
    the directly gathered and all (tile, projection) pairs of the
    back-projection launches it made, as the registry counts them at the
    fences that read the launches' counts."""
    from repro_torch.obs.trace import Tracer, set_tracer
    direct = KernelCount("kernels.backproject.direct_pairs")
    pairs = KernelCount("kernels.backproject.tile_pairs")
    direct.reset()
    pairs.reset()
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    try:
        with tracer.span("smoke.direct_pairs") as sp:
            out = sp.fence(fn())
    finally:
        set_tracer(prev)
    return out, direct.n, pairs.n


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip()


def rabbitct_geometry(CBCTGeometry):
    return CBCTGeometry(n_proj=496, n_u=1248, n_v=960,
                        d_u=4.8 / 1248, d_v=4.8 / 1248, d=4.0, dsd=8.0,
                        n_x=512, n_y=512, n_z=512,
                        d_x=2 / 512, d_y=2 / 512, d_z=2 / 512)


def interior_rmse(vol, ph) -> float:
    m = vol.shape[0] // 5
    it = (slice(m, vol.shape[0] - m),) * 3
    return float(((vol[it] - ph[it]) ** 2).mean().sqrt())


def detector_pairs(g, pmats, device) -> int:
    """Mirrored voxel pairs (i, j, k < nz/2) times projections whose
    gathers touch the detector: u in (-1, N_u) and v in (-1, N_v). Front
    and mirror gather touch it together, as v~ = (N_v - 1) - v lies in
    (-1, N_v) exactly when v does. Counted per column from v(k) = a + b k,
    in float64."""
    import torch

    i = torch.arange(g.n_x, dtype=torch.float64, device=device)[:, None]
    j = torch.arange(g.n_y, dtype=torch.float64, device=device)[None, :]
    nzh = g.n_z // 2
    total = torch.zeros((), dtype=torch.float64, device=device)
    for pm in pmats:
        p = pm.reshape(12).astype("float64").tolist()
        z = p[8] * i + p[9] * j + p[11]
        u = (p[0] * i + p[1] * j + p[3]) / z
        a = (p[4] * i + p[5] * j + p[7]) / z
        if p[6] == 0.0:
            n = torch.where((a > -1) & (a < g.n_v), float(nzh), 0.0)
        else:
            t1 = (-1 - a) * z / p[6]   # v(k) crosses -1 and N_v here
            t2 = (g.n_v - a) * z / p[6]
            k_lo = (torch.floor(torch.minimum(t1, t2)) + 1).clamp(min=0)
            k_hi = (torch.ceil(torch.maximum(t1, t2)) - 1).clamp(max=nzh - 1)
            n = (k_hi - k_lo + 1).clamp(min=0)
        total += torch.where((u > -1) & (u < g.n_u), n, 0.0).sum()
    return int(total)


def event_ms(fn, runs: int) -> float:
    """Mean ms of `fn` over `runs` calls after one warm-up, by CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def reconstruction(dev) -> tuple:
    """Phases 3-5 on the RabbitCT cell; returns the back-projection kernel's
    entries of the `kernels` line, the geometry, the projections and the
    phantom."""
    import torch

    from repro_torch.core.distributed import shift_pmats_i
    from repro_torch.core.filtering import make_filter
    from repro_torch.core.fdk import gups
    from repro_torch.core.geometry import (
        CBCTGeometry, default_geometry, projection_matrices)
    from repro_torch.core.phantom import forward_project, shepp_logan_volume
    from repro_torch.core.plan import ReconstructionPlan, shift_pmats_j
    from repro_torch.core.precision import CODECS as CODEC_TABLE, Precision
    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.kernels.backproject.ops import kernel_operands

    sync = torch.cuda.synchronize
    # Inputs shared by phases 3-5: the RabbitCT projections.
    g = rabbitct_geometry(CBCTGeometry)
    t0 = time.perf_counter()
    proj = forward_project(g, device=dev)
    phantom = shepp_logan_volume(g, device=dev)
    sync()
    print(f"[inputs] RabbitCT {g.proj_shape()} -> {g.volume_shape()}: "
          f"projections + phantom in {time.perf_counter() - t0:.2f} s")
    if not torch.isfinite(proj).all():
        fail("forward_project gave non-finite projections")

    def filtered(geom, raw):
        return make_filter(geom, "ramlak", out_dtype=torch.float32,
                           device=dev)(raw)

    def kernel_inputs(geom, raw, codec, pm=None, filt=None):
        """The (params13, Q^T) the reconstruction path hands the kernel;
        P defaults to the geometry's first raw.shape[0] matrices."""
        if filt is None:
            filt = filtered(geom, raw)
        data, scales = CODEC_TABLE[codec].encode(filt)
        if pm is None:
            pm = projection_matrices(geom)[:raw.shape[0]]
        return kernel_operands(pm, data, scales)

    # 3. Back-projection kernel vs plain version ---------------------------
    max_abs = {}
    g64 = default_geometry(64)
    pm_all = torch.as_tensor(projection_matrices(g), device=dev)
    cases = [("RabbitCT[:32]", g, filtered(g, proj[:SUBSET]),
              pm_all[:SUBSET], (g.n_x, g.n_y, g.n_z)),
             ("default_geometry(64)", g64,
              filtered(g64, forward_project(g64, device=dev)),
              projection_matrices(g64), (g64.n_x, g64.n_y, g64.n_z))]
    # The 2 x 2 mesh's call shapes: each x-slab with P shifted by
    # slab_pmats' shift_pmats_i, and each of its y-chunks shifted on by
    # shift_pmats_j, on every 8th projection of each data rank's half.
    r, half = MESH_FOUR_SHAPE[-1], g.n_proj // MESH_FOUR_SHAPE[1]
    nxs, ycs = g.n_x // r, g.n_y // MESH_FOUR_Y_CHUNKS
    for lo in range(0, g.n_proj, half):
        sub = slice(lo, lo + half, 8)
        filt = filtered(g, proj[sub])
        for m in range(r):
            pm = shift_pmats_i(pm_all[sub], float(m * nxs))
            where = f"RabbitCT[{lo}:{lo + half}:8] x-slab {m}"
            cases.append((where, g, filt, pm, (nxs, g.n_y, g.n_z)))
            cases += [(f"{where} y-chunk {c}", g, filt,
                       shift_pmats_j(pm, float(c * ycs)), (nxs, ycs, g.n_z))
                      for c in range(MESH_FOUR_Y_CHUNKS)]
    for label, geom, filt, pm, shape in cases:
        rels, shares = [], []
        for codec in CODECS:
            params, qt = kernel_inputs(geom, None, codec, pm=pm, filt=filt)
            got, direct, pairs = direct_pairs(
                lambda: bpk.backproject_dual(params, qt, *shape))
            shares.append(direct / pairs)
            want = bpk.backproject_dual_torch(params, qt, *shape)
            sync()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            rels.append(f"{codec} {rel:.3e}")
            if not (rel <= REL_TOL):
                fail(f"kernel disagrees with its plain version: {label} "
                     f"{shape} {codec} relative {rel:.3e} > {REL_TOL:.0e}")
            max_abs[codec] = max(max_abs.get(codec, 0.0), err)
            del got, want, params, qt
        print(f"[bp-check] {label} {shape}, {filt.shape[0]} projections: "
              f"max|kernel-plain| / max|plain| {', '.join(rels)} (bound "
              f"{REL_TOL:.0e}); direct-gather share "
              f"{', '.join(f'{x:.4%}' for x in shares)}")
    del cases, filt

    # 4. Reconstruction path ----------------------------------------------
    volumes, launches = {}, {}
    for codec in MAIN_PATH_CODECS:
        fn = ReconstructionPlan(geometry=g, impl="kernel",
                                precision=codec).build()
        fn(proj)  # warm-up
        sync()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        ATTN_LAUNCHES.reset()
        t0 = time.perf_counter()
        vol = fn(proj)
        sync()
        dt = time.perf_counter() - t0
        launches[codec] = BP_LAUNCHES.n
        count_filter("single-device", 1)
        _, direct, pairs = direct_pairs(lambda: fn(proj))
        peak = torch.cuda.max_memory_allocated()
        if tuple(vol.shape) != g.volume_shape() or not torch.isfinite(vol).all():
            fail(f"reconstruction {codec}: bad volume {tuple(vol.shape)}")
        rmse = interior_rmse(vol, phantom)
        print(f"[recon] {codec}: {dt:.4f} s, {gups(g, dt):.2f} GUPS, peak "
              f"{peak / 2**30:.2f} GiB, kernel launches {launches[codec]}, "
              f"interior RMSE vs phantom {rmse:.4f} (bound {RMSE_BOUND}); "
              f"direct-gather (tile, projection) pairs {direct} of "
              f"{pairs} ({direct / pairs:.4%})")
        if launches[codec] < 1:
            fail(f"reconstruction {codec} did not launch the kernel")
        if not rmse < RMSE_BOUND:
            fail(f"reconstruction {codec}: RMSE {rmse:.4f} >= {RMSE_BOUND}")
        volumes[codec] = vol
    ref = volumes["fp32"]
    fp16_rel = float(((volumes["fp16"] - ref) ** 2).mean().sqrt()
                     / ref.abs().max())
    tol = Precision("fp16").rmse_tol()
    print(f"[recon] fp16 vs fp32 relative RMSE {fp16_rel:.3e} "
          f"(bound {tol:.3e})")
    if not fp16_rel < tol:
        fail(f"fp16 reconstruction off fp32 by {fp16_rel:.3e} > {tol:.3e}")
    del volumes, ref

    # Where the path's time goes: one traced fp32 run.
    fn = ReconstructionPlan(geometry=g, impl="kernel",
                            precision="fp32").build()
    profile(lambda: fn(proj), "fp32 reconstruction", top=8)

    # 5. Back-projection kernel time at the path's shapes ------------------
    entries = []
    shape = (g.n_x, g.n_y, g.n_z)
    pairs = detector_pairs(g, projection_matrices(g), dev)
    all_pairs = g.n_x * g.n_y * (g.n_z // 2) * g.n_proj
    n_ops = PAIR_OPS * pairs + COLUMN_OPS * g.n_x * g.n_y * g.n_proj
    ops_ms = n_ops / PEAK_F32_OPS_PER_S * 1e3
    print(f"[bp-time] operations the back-projection needs: {pairs} of "
          f"{all_pairs} pair-projections touch the detector "
          f"({pairs / all_pairs:.2%}); {n_ops:.4e} operations, "
          f"{n_ops / (2 * all_pairs):.3f} per voxel update")
    for codec in MAIN_PATH_CODECS:
        name = "bp_dual_kernel<%s>" % {"fp32": "float", "fp16": "__half"}[codec]
        params, qt = kernel_inputs(g, proj, codec)
        ms = event_ms(lambda: bpk.backproject_dual(params, qt, *shape),
                      TIMED_LAUNCHES)
        sync()
        _, direct, pairs = direct_pairs(
            lambda: bpk.backproject_dual(params, qt, *shape))
        direct_share = direct / pairs
        unstaged_ms = event_ms(
            lambda: bpk.backproject_dual(params, qt, *shape, stage_bytes=0),
            TIMED_LAUNCHES)
        n_bytes = (params.numel() * 4 + qt.numel() * qt.element_size()
                   + g.n_x * g.n_y * g.n_z * 4)
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        del params, qt
        # The plain version runs only on the subset (one launch per
        # projection and ~40 elementwise passes each).
        params, qt = kernel_inputs(g, proj[:SUBSET], codec)
        sub_ms = event_ms(lambda: bpk.backproject_dual(params, qt, *shape),
                          TIMED_LAUNCHES)
        plain_ms = event_ms(
            lambda: bpk.backproject_dual_torch(params, qt, *shape),
            PLAIN_RUNS)
        del params, qt
        print(f"[bp-time] {codec}: kernel {ms:.3f} ms ({gups(g, ms / 1e3):.1f} "
              f"GUPS), bound {bound_ms:.3f} ms (bytes {bytes_ms:.3f} ms, "
              f"operations {ops_ms:.3f} ms), {bound_ms / ms:.1%} of bound, "
              f"{direct_share:.4%} of (tile, projection) pairs "
              f"gathered directly; staging budget 0 (every pair gathered "
              f"directly) {unstaged_ms:.3f} ms; on {SUBSET} projections: "
              f"kernel {sub_ms:.3f} ms, plain {plain_ms:.1f} ms; "
              "library_ms null: no single PyTorch call computes a weighted "
              "back-projection")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/backproject/csrc/backproject.cu",
            "replaces": "src/repro/kernels/backproject/kernel.py:72",
            "launches": launches[codec],
            "max_abs_err": max_abs[codec],
            "ms": ms,
            "plain_ms": plain_ms,
            "plain_n_proj": SUBSET,    # plain_ms is on the subset ...
            "ms_at_plain_n_proj": sub_ms,  # ... as is this kernel time
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "design": DESIGN[name],
        })

    return entries, g, proj, phantom


def filter_phase(g, proj) -> dict:
    """[filter] (see the module's docstring); returns the ramp filter
    kernel's entry of the `kernels` line."""
    import torch

    from repro_torch.core import filtering as F
    from repro_torch.kernels.filter import kernel as rf
    from repro_torch.obs import metrics

    dev = proj.device
    pad = F.fft_length(g.n_u)
    fcos = torch.as_tensor(F.cosine_weights(g), device=dev)

    def chain(window, p):
        """The torch.fft chain: `_filter_batch` on 32 projections at a
        time, as make_filter ran on the card before the kernel."""
        hf = torch.as_tensor(F.ramp_frequency_response(g, window, pad),
                             device=dev)
        out = torch.empty_like(p)
        for b in range(0, p.shape[0], F._FILTER_BATCH):
            out[b:b + F._FILTER_BATCH] = F._filter_batch(
                p[b:b + F._FILTER_BATCH], fcos, hf, pad, g.tau_u)
        return out

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    launches = metrics.counter(rf.LAUNCHES)
    rows = metrics.counter(rf.ROWS)
    worst = 0.0
    for window in FILTER_WINDOWS:
        n0, r0 = launches.value, rows.value
        got = F.make_filter(g, window, out_dtype=torch.float32,
                            device=dev)(proj)
        torch.cuda.synchronize()
        if (launches.value - n0, rows.value - r0) != (1, g.n_proj * g.n_v):
            fail(f"[filter] {window}: {launches.value - n0} launches, "
                 f"{rows.value - r0} rows; expected 1, {g.n_proj * g.n_v}")
        by_chain = rel(got, chain(window, proj))
        plain = F.make_filter(g, window, out_dtype=torch.float32,
                              device="cpu")(proj[:2].cpu())
        by_plain = rel(got[:2].cpu(), plain)
        worst = max(worst, by_chain, by_plain)
        print(f"[filter] {window}: kernel vs torch.fft chain {by_chain:.3e}, "
              f"vs the CPU's plain version (2 projections) {by_plain:.3e} "
              f"of the max (bound {FILTER_REL})")
        if not max(by_chain, by_plain) <= FILTER_REL:
            fail(f"[filter] {window}: kernel off by {by_chain:.3e} / "
                 f"{by_plain:.3e} > {FILTER_REL}")
    filt = F.make_filter(g, "ramlak", out_dtype=torch.float32, device=dev)
    whole, first, alone = filt(proj), filt(proj[:32]), filt(proj[5:6])
    if not (torch.equal(alone[0], whole[5]) and torch.equal(first,
                                                            whole[:32])):
        fail("[filter] a projection's rows depend on the batch it came in")
    del whole, first, alone
    tables = rf.filter_tables(F._response(g, "ramlak", pad), g.tau_u, dev)
    ms = event_ms(lambda: rf.filter_rows(proj, fcos, *tables),
                  TIMED_LAUNCHES)
    sub = proj[:SUBSET].contiguous()
    sub_ms = event_ms(lambda: rf.filter_rows(sub, fcos, *tables),
                      TIMED_LAUNCHES)
    plain_ms = event_ms(lambda: rf.filter_rows_torch(sub, fcos, *tables),
                        PLAIN_RUNS)
    library_ms = event_ms(lambda: chain("ramlak", proj), PLAIN_RUNS)
    n_bytes = 2 * proj.numel() * 4     # raw read once, filtered written once
    bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    print(f"[filter] time at {tuple(proj.shape)}, pad {pad}: kernel "
          f"{ms:.3f} ms, bound {bound_ms:.3f} ms (bytes, {n_bytes / 1e9:.3f} "
          f"GB), {bound_ms / ms:.1%} of bound; torch.fft chain {library_ms:.3f}"
          f" ms; on {SUBSET} projections: kernel {sub_ms:.3f} ms, torch twin "
          f"{plain_ms:.1f} ms")
    name = "ramp_filter_kernel<11>"
    return {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/filter/csrc/filter.cu",
        "replaces": None,
        "max_rel_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "plain_n_proj": SUBSET,
        "ms_at_plain_n_proj": sub_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "design": DESIGN[name],
    }


def last_delta(g) -> tuple:
    """The angle range of the last of the N_STEPS deltas: the one whose
    fold is the time from the last projection to the volume."""
    n_d = g.n_proj // N_STEPS
    return g.n_proj - n_d, g.n_proj


def delta_operands(g, proj, codec, lo, hi, pmats=None):
    """The kernel's operands for angles [lo, hi) as the incremental session
    hands them to it: the delta filtered and encoded alone, P of those
    angles (from `pmats`, default the geometry's)."""
    import torch

    from repro_torch.core.filtering import make_filter
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.core.precision import CODECS as CODEC_TABLE
    from repro_torch.kernels.backproject.ops import kernel_operands

    filt = make_filter(g, "ramlak", out_dtype=torch.float32,
                       device=proj.device)(proj[lo:hi])
    data, scales = CODEC_TABLE[codec].encode(filt)
    if pmats is None:
        pmats = projection_matrices(g)
    return kernel_operands(pmats[lo:hi], data, scales)


def kernel_delta(g, proj, entries) -> None:
    """Phase [kernel-delta]: the kernel against its plain version at the
    incremental session's call shape, (512, 512) columns from the last 62
    projections, five codecs, and its time there (fp32, fp16). Folds the
    comparison's error into each entry's max_abs_err and the time into its
    ms_at_delta_n_proj."""
    import torch

    from repro_torch.core.filtering import make_filter
    from repro_torch.kernels.backproject import kernel as bpk

    lo, hi = last_delta(g)
    shape = (g.n_x, g.n_y, g.n_z)
    rels, shares = [], []
    by_codec = dict(zip(MAIN_PATH_CODECS, entries))
    for codec in CODECS:
        params, qt = delta_operands(g, proj, codec, lo, hi)
        got, direct, pairs = direct_pairs(
            lambda: bpk.backproject_dual(params, qt, *shape))
        shares.append(direct / pairs)
        want = bpk.backproject_dual_torch(params, qt, *shape)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        rels.append(f"{codec} {rel:.3e}")
        if not (rel <= REL_TOL):
            fail(f"kernel disagrees with its plain version at the delta "
                 f"shape {shape} x {hi - lo} projections, {codec}: "
                 f"relative {rel:.3e} > {REL_TOL:.0e}")
        if codec in by_codec:
            entry = by_codec[codec]
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            ms = event_ms(lambda: bpk.backproject_dual(params, qt, *shape),
                          TIMED_LAUNCHES)
            entry["delta_n_proj"] = hi - lo
            entry["ms_at_delta_n_proj"] = ms
            rels[-1] += f" (kernel {ms:.3f} ms)"
            rate = g.n_x * g.n_y * g.n_z * (hi - lo) / (ms * 1e-3 * 2**30)
            print(f"[bp-time] {codec} at the delta shape {shape} x "
                  f"{hi - lo} projections: kernel {ms:.3f} ms ({rate:.1f} "
                  f"GUPS), {direct / pairs:.4%} of (tile, projection) "
                  "pairs gathered directly")
        del got, want, params, qt
    # What the session's per-delta filter costs: cuFFT on the delta's own
    # batches (32 + 30 projections) against the whole scan's (the last
    # batch there is 496 - 480 = 16 projections).
    filt = make_filter(g, "ramlak", out_dtype=torch.float32,
                       device=proj.device)
    alone, whole = filt(proj[lo:hi]), filt(proj)[lo:hi]
    filter_rel = rel_max(alone, whole)
    print(f"[kernel-delta] RabbitCT[{lo}:{hi}] {shape}, {hi - lo} "
          f"projections: max|kernel-plain| / max|plain| {', '.join(rels)} "
          f"(bound {REL_TOL:.0e}); direct-gather share "
          f"{', '.join(f'{x:.4%}' for x in shares)}; the delta filtered "
          f"alone vs the same rows of the whole scan's filter: "
          f"{filter_rel:.3e} of the max, bit-equal: "
          f"{torch.equal(alone, whole)}")
    del alone, whole
    fold_witness(g, proj)


def fold_witness(g, proj) -> None:
    """Part of phase [kernel-delta]: what folding the deltas does to the
    sums. On the central WITNESS_SLAB x-planes, over all the scan's
    projections (fp32): the kernel's N_STEPS delta launches folded as
    `acc + bp`, the session's fold, against its one launch over the scan
    (fused), and the same fold of the plain version against its one pass.
    Equal gaps say that the session's distance from fused is the fold's
    reassociation; a kernel gap far above the plain one would be a fault
    of the kernel at the delta shape."""
    import torch

    from repro_torch.core.distributed import shift_pmats_i
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.kernels.backproject import kernel as bpk

    n_d = g.n_proj // N_STEPS
    i0 = (g.n_x - WITNESS_SLAB) // 2
    pm = shift_pmats_i(torch.as_tensor(projection_matrices(g),
                                       device=proj.device), float(i0))
    shape = (WITNESS_SLAB, g.n_y, g.n_z)
    whole, gaps = {}, {}
    for name, bp in (("kernel", bpk.backproject_dual),
                     ("plain", bpk.backproject_dual_torch)):
        whole[name] = bp(*delta_operands(g, proj, "fp32", 0, g.n_proj, pm),
                         *shape)
        fold = torch.zeros_like(whole[name])
        for k in range(N_STEPS):
            fold = fold + bp(*delta_operands(g, proj, "fp32", k * n_d,
                                             (k + 1) * n_d, pm), *shape)
        torch.cuda.synchronize()
        gaps[name] = rel_max(fold, whole[name])
        del fold
    ratio = gaps["kernel"] / gaps["plain"] if gaps["plain"] else math.inf
    print(f"[kernel-delta] fold witness, x-planes [{i0}, {i0 + WITNESS_SLAB})"
          f" of all {g.n_proj} projections, fp32: {N_STEPS} deltas folded "
          f"acc + bp vs one pass, of the max: kernel {gaps['kernel']:.3e}, "
          f"plain {gaps['plain']:.3e} (ratio {ratio:.2f}); kernel vs plain "
          f"over the "
          f"whole scan {rel_max(whole['kernel'], whole['plain']):.3e}")


def poll_until(sess, done, deadline: float, what: str) -> None:
    """poll() the session until done(sess), failing past the deadline."""
    end = time.perf_counter() + deadline
    while not done(sess):
        if sess.poll() == 0:
            if time.perf_counter() > end:
                fail(f"{what}: {sess.n_folded} angles folded at the "
                     f"{deadline:.0f} s deadline")
            time.sleep(0.005)


def incremental(g, proj, phantom) -> dict:
    """Phase [incremental]: the streaming session at RabbitCT, n_steps = 8,
    fed by a scanner thread through a StreamingProjectionWriter store;
    then the time from the last projection to the volume. Returns the
    kernel's launches per codec."""
    import threading

    from repro_torch.core.precision import Precision
    from repro_torch.io.streams import StreamingProjectionWriter

    n_d = g.n_proj // N_STEPS
    launches, vols = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream")
        host = proj.cpu().numpy()       # what the scanner writes
        writer = StreamingProjectionWriter(path, host.shape)
        peeked, stop, errors = threading.Event(), threading.Event(), []

        def scanner():
            """Appends the 8 deltas; after the 4th it waits for the
            session's mid-scan peek. Stops early when told to."""
            try:
                for k in range(N_STEPS):
                    if k == N_STEPS // 2:
                        peeked.wait(timeout=STREAM_DEADLINE_S)
                    if stop.is_set():
                        return
                    writer.append(host[k * n_d:(k + 1) * n_d], k * n_d)
            except BaseException as e:   # reported on the main thread
                errors.append(e)

        thread = threading.Thread(target=scanner, daemon=True)
        try:
            streaming_sessions(g, proj, phantom, path, thread, peeked,
                               launches, vols)
        finally:
            # never leave the temporary directory under a running writer
            stop.set()
            peeked.set()
            if thread.ident is not None:
                thread.join(timeout=120)
        if errors or thread.is_alive():
            fail(f"the scanner thread failed: {errors}")
        del host
    d16 = float(((vols["fp16"] - vols["fp32"]) ** 2).mean().sqrt()
                / vols["fp32"].abs().max())
    tol = Precision("fp16").rmse_tol()
    print(f"[incremental] fp16 vs fp32 relative RMSE {d16:.3e} (bound "
          f"{tol:.3e})")
    if not d16 < tol:
        fail(f"incremental fp16 off fp32 by {d16:.3e} > {tol:.3e}")
    return launches


def streaming_sessions(g, proj, phantom, path, thread, peeked, launches,
                       vols) -> None:
    """The [incremental] sessions of both codecs and their tails; `thread`
    is the scanner, started here, that fills the store at `path`."""
    import torch

    from repro_torch.core.plan import ReconstructionPlan
    from repro_torch.io.streams import ProjectionSource
    from repro_torch.kernels.backproject import kernel as bpk

    sync = torch.cuda.synchronize
    n_d = g.n_proj // N_STEPS
    half = g.n_proj // 2
    for codec in MAIN_PATH_CODECS:
        fused = ReconstructionPlan(geometry=g, impl="kernel",
                                   precision=codec).build()
        ref = fused(proj)
        plan = ReconstructionPlan(geometry=g, impl="kernel",
                                  precision=codec, schedule="incremental",
                                  n_steps=N_STEPS)
        sess = plan.build_incremental(source=ProjectionSource(path))
        sync()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        peek = ""
        if codec == MAIN_PATH_CODECS[0]:
            thread.start()
            poll_until(sess, lambda s: s.n_folded >= half,
                       STREAM_DEADLINE_S, "incremental, first half")
            part = sess.finalize(partial=True)
            sync()
            folded = sess.n_folded
            peeked.set()
            peek = (f"; finalize(partial=True) after {folded} angles, "
                    f"finite: {bool(torch.isfinite(part).all())}")
            if folded != half or not torch.isfinite(part).all():
                fail(f"incremental peek: {folded} angles folded (want "
                     f"{half}), finite {bool(torch.isfinite(part).all())}")
            del part
        poll_until(sess, lambda s: s.is_complete, STREAM_DEADLINE_S,
                   f"incremental {codec}")
        vol = sess.finalize()
        sync()
        dt = time.perf_counter() - t0
        n_launch = BP_LAUNCHES.n
        count_filter("incremental", N_STEPS)
        peak = torch.cuda.max_memory_allocated()
        rel = rel_max(vol, ref)
        rmse = interior_rmse(vol, phantom)
        print(f"[incremental] {codec}: {N_STEPS} deltas of {n_d} "
              f"polled from a {'growing' if peek else 'committed'} "
              f"store and folded in {dt:.3f} s; kernel launches "
              f"{n_launch}; peak {peak / 2**30:.2f} GiB; finalize() vs "
              f"fused build() {rel:.3e} of the max (bound "
              f"{REL_TOL:.0e}); interior RMSE {rmse:.4f} (bound "
              f"{RMSE_BOUND}){peek}")
        if n_launch != N_STEPS:
            fail(f"incremental {codec}: {n_launch} kernel launches, "
                 f"not {N_STEPS}")
        if not rel <= REL_TOL:
            fail(f"incremental {codec} off the fused engine: {rel:.3e}")
        if not rmse < RMSE_BOUND:
            fail(f"incremental {codec}: RMSE {rmse:.4f}")
        vols[codec] = vol

        # The reference benchmark's tail: 7 deltas folded, the 8th
        # staged (its filter and gather ride along with acquisition),
        # then update(staged, finalize=True) timed.
        tails, fused_s = [], []
        reset_launches()
        for _ in range(TAIL_RUNS):
            s = plan.build_incremental()
            for k in range(N_STEPS - 1):
                s.update(proj[k * n_d:(k + 1) * n_d],
                         (k * n_d, (k + 1) * n_d))
            staged = s.stage(proj[-n_d:], last_delta(g))
            sync()
            t0 = time.perf_counter()
            out = s.update(staged, finalize=True)
            sync()
            tails.append(time.perf_counter() - t0)
            del s, staged
        n_tail = BP_LAUNCHES.n
        count_filter("incremental", TAIL_RUNS * N_STEPS)
        for _ in range(TAIL_RUNS):
            t0 = time.perf_counter()
            fused(proj)
            sync()
            fused_s.append(time.perf_counter() - t0)
        t_last, budget = min(tails), min(fused_s) / N_STEPS
        tail_rel = rel_max(out, ref)
        print(f"[incremental] {codec} tail: t_last_delta {t_last:.4f} s "
              f"(best of {TAIL_RUNS}: "
              f"{', '.join(f'{t:.4f}' for t in tails)}) beside "
              f"fused_seconds / {N_STEPS} = {budget:.4f} s (fused "
              f"{min(fused_s):.4f} s); the JAX package's streaming "
              f"claim t_last_delta < batch_e2e / n_steps "
              f"{'holds' if t_last < budget else 'does not hold'} on "
              f"this card; volume vs fused {tail_rel:.3e} of the max; "
              f"kernel launches {n_tail} ({TAIL_RUNS} sessions)")
        if not tail_rel <= REL_TOL:
            fail(f"incremental {codec} tail off the fused engine: "
                 f"{tail_rel:.3e}")
        launches[codec] = n_launch + n_tail
        del sess, vol, ref, out


def batched(g, proj) -> dict:
    """Phase [batched]: build_batched(2) on the phantom's scan and a copy
    scaled by 1.5; each lane bit-equal to build() of its scan. Returns the
    kernel's launches per codec."""
    import torch

    from repro_torch.core.plan import ReconstructionPlan
    from repro_torch.kernels.backproject import kernel as bpk

    sync = torch.cuda.synchronize
    scans = torch.stack([proj, proj * 1.5])
    launches = {}
    for codec in MAIN_PATH_CODECS:
        plan = ReconstructionPlan(geometry=g, impl="kernel", precision=codec)
        one, both = plan.build(), plan.build_batched(2)
        both(scans)     # warm-up
        sync()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = both(scans)
        sync()
        t_batch = time.perf_counter() - t0
        launches[codec] = BP_LAUNCHES.n
        count_filter("batched", 2)     # one a lane
        peak = torch.cuda.max_memory_allocated()
        t_scans, same = 0.0, []
        for b in range(2):
            t0 = time.perf_counter()
            lane = one(scans[b])
            sync()
            t_scans += time.perf_counter() - t0
            same.append(torch.equal(out[b], lane))
            del lane
        print(f"[batched] {codec}: build_batched(2) {t_batch:.4f} s per "
              f"batch beside 2 x build() {t_scans:.4f} s; kernel launches "
              f"{launches[codec]}; peak {peak / 2**30:.2f} GiB; lanes "
              f"bit-equal to build(): {same}")
        if launches[codec] != 2:
            fail(f"batched {codec}: {launches[codec]} kernel launches")
        if not all(same):
            fail(f"batched {codec}: a lane is not bit-equal to build()")
        del out
    return launches


def store_bytes(path: str) -> int:
    """Bytes of every shard file under a store (its sidecar included)."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files
               if f.endswith(".bin"))


def io_phase(dev, g, proj, work: str) -> tuple:
    """Phase [io]: an fp16-encoded projection store (WORK/io-proj, which
    [service] serves again), then build(source=, sink=)() and the volume
    read back. Returns the kernel's launches (fp32 plan) and the store's
    read and write rates in bytes/s."""
    import torch

    from repro_torch.core.plan import ReconstructionPlan
    from repro_torch.core.precision import CODECS as CODEC_TABLE
    from repro_torch.io.streams import ProjectionSource, VolumeSink
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.obs.trace import Tracer, set_tracer

    sync = torch.cuda.synchronize
    plan = ReconstructionPlan(geometry=g, impl="kernel", precision="fp32")
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        t0 = time.perf_counter()
        src = ProjectionSource.write(os.path.join(work, "io-proj"), proj,
                                     codec="fp16")
        t_put = time.perf_counter() - t0
        in_bytes = store_bytes(src.path)
        codec = CODEC_TABLE["fp16"]
        want_proj = codec.decode(*codec.encode(proj))
        loaded = src.load(device=dev)
        sync()
        same_proj = torch.equal(loaded, want_proj)
        del want_proj
        sink = VolumeSink(os.path.join(tmp, "vol"))
        fn = plan.build(source=src, sink=sink)
        tracer = Tracer(enabled=True)
        prev = set_tracer(tracer)
        reset_launches()
        try:
            vol = fn()
            sync()
        finally:
            set_tracer(prev)
        n_launch = BP_LAUNCHES.n
        count_filter("io", 1)
        want = plan.build()(loaded)
        same_vol = torch.equal(vol, want)
        back = sink.read()
        same_back = torch.equal(back, vol.cpu())
        out_bytes = sink.nbytes()
        totals = tracer.stage_totals()
        t_read, t_write = totals["stage.read"], totals["stage.write"]
    print(f"[io] ProjectionSource.write(codec='fp16') {in_bytes} bytes on "
          f"disk in {t_put:.3f} s; build(source=, sink=)(): stage.read "
          f"{t_read:.3f} s ({in_bytes / t_read / 1e9:.3f} GB/s), "
          f"stage.write {t_write:.3f} s ({out_bytes} bytes, "
          f"{out_bytes / t_write / 1e9:.3f} GB/s); kernel launches "
          f"{n_launch}; loaded projections bit-equal to the codec's "
          f"decode(encode()): {same_proj}; volume bit-equal to build() of "
          f"them: {same_vol}; VolumeSink.read() bit-equal to the volume: "
          f"{same_back}")
    if n_launch != 1:
        fail(f"io: {n_launch} kernel launches")
    if not (same_proj and same_vol and same_back):
        fail("io: a round trip is not bit-equal")
    return n_launch, in_bytes / t_read, out_bytes / t_write


def trace_phase(g, proj) -> int:
    """Phase [trace]: the tracer on around one build() call. Returns the
    kernel's launches (fp32)."""
    import torch

    from repro_torch.core.plan import ReconstructionPlan
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.obs import default_registry
    from repro_torch.obs.trace import Tracer, set_tracer

    fn = ReconstructionPlan(geometry=g, impl="kernel",
                            precision="fp32").build()
    params, qt = delta_operands(g, proj, "fp32", 0, g.n_proj)
    shape = (g.n_x, g.n_y, g.n_z)
    kernel_ms = event_ms(lambda: bpk.backproject_dual(params, qt, *shape), 3)
    del params, qt
    fn(proj)
    torch.cuda.synchronize()
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    reset_launches()
    try:
        fn(proj)
    finally:
        set_tracer(prev)
    n_launch = BP_LAUNCHES.n
    count_filter("trace", 1)
    (span,) = tracer.spans("engine.reconstruct")
    span_ms, dispatch_ms = span["dur"] / 1e3, span["args"]["dispatch_us"] / 1e3
    with tempfile.TemporaryDirectory() as tmp:
        with open(tracer.save(os.path.join(tmp, "trace.json"))) as f:
            events = json.load(f)["traceEvents"]
    snap = default_registry().snapshot()
    counters = {c: snap.get(f"cache.core.engine_cache.{c}")
                for c in ("hits", "misses", "evictions", "unhashable")}
    print(f"[trace] engine.reconstruct span {span_ms:.3f} ms (dispatch "
          f"{dispatch_ms:.3f} ms, args {span['args']}) vs the kernel's CUDA-"
          f"event time {kernel_ms:.3f} ms; kernel launches {n_launch}; "
          f"exported Chrome JSON loads, {len(events)} events; registry "
          f"cache.core.engine_cache.* {counters}")
    if not span_ms >= kernel_ms:
        fail(f"the fenced span ({span_ms:.3f} ms) is shorter than the "
             f"kernel ({kernel_ms:.3f} ms)")
    if n_launch != 1 or None in counters.values():
        fail(f"trace: launches {n_launch}, counters {counters}")
    return n_launch


def tiles_phase(g, proj) -> dict:
    """Phase [tiles]: every compiled tile x five codecs against the plain
    version on the 32-projection subset (with the direct-gather share, and
    the tuner's staging model held to the kernel's count); each tile's
    time at the full RabbitCT shape and at the delta shape, fp32 and fp16.
    Returns {(shape label, codec): {tile: ms}}."""
    import torch

    from repro_torch.kernels.backproject import kernel as bpk

    t0 = time.perf_counter()
    shape = (g.n_x, g.n_y, g.n_z)
    for codec in CODECS:
        params, qt = delta_operands(g, proj, codec, 0, SUBSET)
        want = bpk.backproject_dual_torch(params, qt, *shape)
        peak = float(want.abs().max())
        parts = []
        for t in bpk.TILES:
            got, direct, pairs = direct_pairs(
                lambda: bpk.backproject_dual(params, qt, *shape, tile=t))
            rel = float((got - want).abs().max()) / peak
            model = bpk.staging_stats(params, g.n_u, g.n_v, g.n_x, g.n_y,
                                      g.n_z // 2, t, None, qt.dtype)
            parts.append(f"{t} {rel:.3e}, direct "
                         f"{direct / pairs:.4%}")
            if not rel <= REL_TOL:
                fail(f"tile {t} {codec} disagrees with the plain version: "
                     f"{rel:.3e} > {REL_TOL:.0e}")
            if direct != model["direct"]:
                fail(f"tile {t} {codec}: the kernel gathered {direct} "
                     f"(tile, projection)s directly, the staging model "
                     f"counts {model['direct']}")
            del got
        print(f"[tiles] RabbitCT[:{SUBSET}] {codec}, per tile max|kernel-"
              f"plain| / max|plain| and direct-gather share: "
              f"{'; '.join(parts)} (bound {REL_TOL:.0e}; the staging "
              "model's direct count equal in each)")
        del want, params, qt
    times = {}
    lo, hi = last_delta(g)
    for label, (a, b) in (("RabbitCT", (0, g.n_proj)), ("delta", (lo, hi))):
        for codec in MAIN_PATH_CODECS:
            params, qt = delta_operands(g, proj, codec, a, b)
            ms = {t: event_ms(lambda: bpk.backproject_dual(
                      params, qt, *shape, tile=t), TILE_RUNS)
                  for t in bpk.TILES}
            times[label, codec] = ms
            print(f"[tiles] {label} {shape} x {b - a} projections {codec}, "
                  f"ms per launch (default staging, {TILE_RUNS} launches): "
                  + ", ".join(f"{t} {v:.3f}" for t, v in ms.items())
                  + f"; fastest {min(ms, key=ms.get)}")
            del params, qt
    print(f"[tiles] phase {time.perf_counter() - t0:.1f} s")
    return times


def tune_phase(g, proj, phantom, tile_ms) -> dict:
    """Phase [tune]: measured tuning at the RabbitCT and delta shapes,
    fp32 and fp16, the file cache's hit on a second call, then
    ReconstructionPlan(impl="kernel") at RabbitCT with the tuned launch:
    the RMSE gate, and within 1e-5 of the default launch's volume.
    Returns the kernel's launches per codec on that reconstruction."""
    import torch

    from repro_torch.core.geometry import projection_matrices
    from repro_torch.core.plan import ReconstructionPlan, clear_engine_cache
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.kernels.backproject import tune

    t0 = time.perf_counter()
    lo, hi = last_delta(g)
    pm = torch.as_tensor(projection_matrices(g), device=proj.device)
    dtypes = {"fp32": torch.float32, "fp16": torch.float16}
    for label, (a, b) in (("RabbitCT", (0, g.n_proj)), ("delta", (lo, hi))):
        for codec in MAIN_PATH_CODECS:
            # the plan's tuning key: its budget (None: the card's), no pins
            args = (g.n_x, g.n_y, g.n_z, pm[a:b], g.n_u, g.n_v)
            kw = dict(qt_dtype=dtypes[codec], strict=False)
            model = tune.autotune(*args, **kw)
            tune.clear_cache()
            best = tune.autotune(*args, measure=True, **kw)
            tune.clear_cache()
            hits = tune.file_cache_hits()
            again = tune.autotune(*args, **kw)
            served = tune.file_cache_hits() == hits + 1 and again == best
            dflt = tile_ms[label, codec][bpk.DEFAULT_TILE]
            print(f"[tune] {label} x {b - a} projections {codec}: measured "
                  f"winner tile {best.tile} staging {best.stage_bytes} "
                  f"bytes ({best.smem} bytes of shared memory per block) "
                  f"{best.elapsed * 1e3:.3f} ms; the default tile "
                  f"{bpk.DEFAULT_TILE} at the default staging "
                  f"{dflt:.3f} ms ([tiles]); model-ranked pick "
                  f"{model.as_tuple()}; served from the file cache after "
                  f"clear_cache(): {served}")
            if not served or best.tile not in bpk.TILES:
                fail(f"tune {label} {codec}: winner {best}, served {served}")
    launches = {}
    for codec in MAIN_PATH_CODECS:
        clear_engine_cache()   # engines built before the measured tuning
        plan = ReconstructionPlan(geometry=g, impl="kernel", precision=codec)
        fn = plan.build()
        fn(proj)
        torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        vol = fn(proj)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launches[codec] = BP_LAUNCHES.n
        count_filter("tuned", filter_calls(plan))
        dflt = ReconstructionPlan(
            geometry=g, impl="kernel", precision=codec,
            blocks=bpk.DEFAULT_TILE,
            vmem_budget=tune.default_config(dtypes[codec]).smem)
        if dflt.resolved_launch() != tune.default_config(
                dtypes[codec]).as_tuple():
            fail(f"the default-launch plan resolved to "
                 f"{dflt.resolved_launch()}")
        ref = dflt.build()(proj)
        rel = rel_max(vol, ref)
        rmse = interior_rmse(vol, phantom)
        print(f"[tune] ReconstructionPlan(impl='kernel', precision="
              f"'{codec}') with the tuned launch {plan.resolved_launch()}: "
              f"{dt:.4f} s, kernel launches {launches[codec]}, interior "
              f"RMSE {rmse:.4f} (bound {RMSE_BOUND}), vs the default "
              f"launch's volume {rel:.3e} of the max (bound {REL_TOL:.0e})")
        if launches[codec] != 1 or not rmse < RMSE_BOUND or \
                not rel <= REL_TOL:
            fail(f"tuned reconstruction {codec}: launches "
                 f"{launches[codec]}, RMSE {rmse:.4f}, {rel:.3e}")
        del vol, ref, fn
    clear_engine_cache()
    print(f"[tune] phase {time.perf_counter() - t0:.1f} s")
    return launches


def machine_spec_phase(g, proj, io_rates, t_filter) -> dict:
    """Phase [machine-spec]: the single-card terms of perf_model.H100,
    measured here: the factorized path's GUPS on the 32-projection subset,
    RabbitCT's projections over [traced]'s mean fp32 stage.filter span
    (`t_filter`), a pinned host-to-device copy, and [io]'s store read and
    write rates."""
    import torch

    from repro_torch.core.backprojection import backproject_factorized
    from repro_torch.core.filtering import make_filter
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.core.perf_model import H100

    t0 = time.perf_counter()
    pm = torch.as_tensor(projection_matrices(g)[:SUBSET], device=proj.device)
    q = make_filter(g, "ramlak", out_dtype=torch.float32,
                    device=proj.device)(proj[:SUBSET])
    shape = (g.n_x, g.n_y, g.n_z)
    backproject_factorized(pm, q, *shape)     # warm-up
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    backproject_factorized(pm, q, *shape)
    end.record()
    end.synchronize()
    t_fact = start.elapsed_time(end) / 1e3
    gups_bp = g.n_x * g.n_y * g.n_z * SUBSET / (t_fact * 2**30)
    del q
    torch.cuda.empty_cache()
    th_flt = g.n_proj / t_filter
    host = torch.empty(H2D_BYTES // 4, dtype=torch.float32).pin_memory()
    dev_buf = torch.empty_like(host, device=proj.device)
    dev_buf.copy_(host, non_blocking=True)
    start.record()
    for _ in range(H2D_RUNS):
        dev_buf.copy_(host, non_blocking=True)
    end.record()
    end.synchronize()
    bw_hd = H2D_BYTES * H2D_RUNS / (start.elapsed_time(end) / 1e3)
    del host, dev_buf
    measured = {"gups_bp": gups_bp, "th_flt": th_flt, "bw_hd": bw_hd,
                "bw_load": io_rates[0], "bw_store": io_rates[1]}
    print(f"[machine-spec] measured: gups_bp {gups_bp:.4f} (the factorized "
          f"path, {SUBSET} projections into {shape} in {t_fact:.4f} s), "
          f"th_flt {th_flt:.1f} projections/s ([traced]'s mean fp32 "
          f"stage.filter {t_filter:.6f} s), bw_hd {bw_hd:.4e} B/s "
          f"(pinned, {H2D_RUNS} x {H2D_BYTES} bytes), bw_load "
          f"{io_rates[0]:.4e} B/s and bw_store {io_rates[1]:.4e} B/s "
          f"([io], the machine's local disk); perf_model.H100 holds "
          + ", ".join(f"{k} {getattr(H100, k):.4g}" for k in measured)
          + f"; th_allgather {H100.th_allgather} and th_reduce "
          f"{H100.th_reduce:.3g} are ABCI's (not measured on one card)")
    print(f"[machine-spec] phase {time.perf_counter() - t0:.1f} s")
    return measured


def traced_phase(g, proj) -> tuple:
    """Phase [traced]: build_traced() at RabbitCT, fp32 and fp16, against
    build() (volume, per-stage seconds, their sum beside build()'s wall
    time), TRACED_RUNS runs each with the tracer on (the calibration
    store's samples); attribution.compare against predict_plan under ABCI
    and H100; the traced incremental session (8 deltas) against fused;
    and traced factorized runs on the 32-projection subset (the store's
    evidence for that impl). Returns the kernel's launches per codec and
    the mean fp32 stage.filter seconds."""
    import dataclasses

    import torch

    from repro_torch.core.perf_model import ABCI, H100
    from repro_torch.core.plan import ReconstructionPlan
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.obs import attribution
    from repro_torch.obs.trace import Tracer, set_tracer

    t0 = time.perf_counter()
    sync = torch.cuda.synchronize
    launches = {}
    for codec in MAIN_PATH_CODECS:
        plan = ReconstructionPlan(geometry=g, impl="kernel", precision=codec)
        engine, traced = plan.build(), plan.build_traced()
        want = engine(proj)
        traced(proj)
        sync()
        t1 = time.perf_counter()
        engine(proj)
        sync()
        t_build = time.perf_counter() - t1
        tracer = Tracer(enabled=True)
        prev = set_tracer(tracer)
        reset_launches()
        try:
            for _ in range(TRACED_RUNS):
                t1 = time.perf_counter()
                got = traced(proj)
                sync()
                t_traced = time.perf_counter() - t1
        finally:
            set_tracer(prev)
        launches[codec] = BP_LAUNCHES.n
        count_filter("traced", TRACED_RUNS * filter_calls(plan))
        rel = rel_max(got, want)
        totals = {k: v / TRACED_RUNS for k, v in
                  tracer.stage_totals().items()}
        if codec == "fp32":
            t_filter = totals["stage.filter"]
        print(f"[traced] RabbitCT {codec}: build_traced() vs build() "
              f"{rel:.3e} of the max (bound {REL_TOL:.0e}); per stage (mean "
              f"of {TRACED_RUNS}): "
              + ", ".join(f"{k} {v:.6f} s" for k, v in totals.items())
              + f"; sum {sum(totals.values()):.6f} s, the last traced run "
              f"{t_traced:.6f} s, build() {t_build:.6f} s; kernel launches "
              f"{launches[codec]}")
        if not rel <= REL_TOL or launches[codec] != TRACED_RUNS:
            fail(f"traced {codec}: {rel:.3e}, {launches[codec]} launches")
        one_run = [dict(ev, dur=ev["dur"] / TRACED_RUNS)
                   for ev in tracer.spans("stage.")]
        for system in (ABCI, H100):
            rows = attribution.compare(plan, one_run, system)
            print(f"[traced] attribution {codec} under {system.name}: "
                  + "; ".join(
                      f"{r.stage} predicted {r.predicted_s:.6f} s measured "
                      f"{r.measured_s:.6f} s error "
                      + ("-" if r.error is None else f"{r.error:+.4f}")
                      for r in rows)
                  + f"; aggregate {attribution.aggregate_error(rows):.4f}")
        del want, got
        # the traced streaming session, 8 deltas, against fused
        sess = dataclasses.replace(plan, schedule="incremental",
                                   n_steps=N_STEPS).build_traced()
        n_d = g.n_proj // N_STEPS
        reset_launches()
        for lo in range(0, g.n_proj, n_d):
            vol = sess.update(proj[lo:lo + n_d], (lo, lo + n_d),
                              finalize=lo + n_d == g.n_proj)
        sync()
        n_launch = BP_LAUNCHES.n
        count_filter("traced", N_STEPS)
        launches[codec] += n_launch
        rel = rel_max(vol, engine(proj))
        print(f"[traced] incremental {codec}, {N_STEPS} deltas: finalized "
              f"vs fused {rel:.3e} of the max (bound {REL_TOL:.0e}); stage "
              f"seconds {sess.stage_seconds()}; kernel launches {n_launch}")
        if not rel <= REL_TOL or n_launch != N_STEPS:
            fail(f"traced session {codec}: {rel:.3e}, {n_launch} launches")
        del vol, sess, engine, traced
    g32 = dataclasses.replace(g, n_proj=SUBSET)
    fact = ReconstructionPlan(geometry=g32, impl="factorized",
                              precision="fp32").build_traced()
    sub = proj[:SUBSET]     # timing only: the volume is not looked at
    prev = set_tracer(Tracer(enabled=True))
    try:
        for _ in range(TRACED_RUNS):
            vol = fact(sub)
    finally:
        tracer = set_tracer(prev)
    sync()
    print(f"[traced] factorized, {SUBSET} projections "
          f"(the store's evidence for that impl), per stage: "
          + ", ".join(f"{k} {v / TRACED_RUNS:.6f} s" for k, v in
                      tracer.stage_totals().items()))
    del vol
    print(f"[traced] phase {time.perf_counter() - t0:.1f} s")
    return launches, t_filter


def auto_phase(g, proj, phantom) -> dict:
    """Phase [auto]: the calibration fitted from the traced runs, then
    plan_from_spec(g, "auto") and auto_plan(..., measure=True) at
    RabbitCT: the plan picked, its predicted seconds (stock and
    calibrated) beside its measured seconds, whether impl="kernel" was
    admitted, and the picked plan's reconstruction within the RMSE gate.
    Returns the kernel's launches per codec of that reconstruction."""
    import torch

    from repro_torch.core.plan import plan_from_spec
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.planner import (
        admitted_impls, auto_plan, default_calibration, default_store,
        predict_plan, refine, search_plans)
    from repro_torch.planner.calibrate import MIN_SAMPLES

    t0 = time.perf_counter()
    store = default_store()
    cal = default_calibration()
    if cal is None:
        fail(f"no calibration fitted from {store.n_samples()} samples")
    print(f"[auto] calibration store {store.n_samples()} samples (MIN_SAMPLES"
          f" {MIN_SAMPLES} per constant): {cal.summary()}; kernel factor "
          f"fitted {cal.impl_gups_factor('kernel')}, factorized "
          f"{cal.impl_gups_factor('factorized')}; admitted impls stock "
          f"{admitted_impls(None, 'cuda')}, calibrated off the card "
          f"{admitted_impls(cal, 'cpu')}")
    stock = plan_from_spec(g, "auto", calibration=None)
    picked = plan_from_spec(g, "auto")
    for label, plan in (("stock", stock), ("calibrated", picked)):
        print(f"[auto] plan_from_spec(g, 'auto'), {label}: "
              f"{plan.describe()}; predicted stock "
              f"{predict_plan(plan).t_runtime:.4f} s, calibrated "
              f"{predict_plan(plan, calibration=cal).t_runtime:.4f} s")
    # auto_plan's own search: the impls it admits on the card
    head = refine(g, search_plans(g, None, top_k=8, calibration=cal,
                                  impls=admitted_impls(cal, "cuda")))
    for p in head[:3]:
        print(f"[auto] refine: {p.spec()} predicted stock "
              f"{predict_plan(p.plan).t_runtime:.4f} s, calibrated "
              f"{p.predicted:.4f} s, measured {p.measured:.4f} s")
    measured = auto_plan(g, measure=True, calibration=cal)
    if measured != head[0].plan:
        fail(f"auto_plan(measure=True) picked {measured}, refine "
             f"{head[0].plan}")
    launches = dict.fromkeys(MAIN_PATH_CODECS, 0)
    fn = measured.build()
    fn(proj)
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    vol = fn(proj)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    count_filter("auto", filter_calls(measured))
    codec = measured.resolved_precision().storage
    if codec in launches:
        launches[codec] = BP_LAUNCHES.n
    rmse = interior_rmse(vol, phantom)
    print(f"[auto] auto_plan(measure=True) picked {head[0].spec()} "
          f"(measured {head[0].measured:.4f} s in refine); its "
          f"reconstruction {dt:.4f} s, kernel launches {BP_LAUNCHES.n}, "
          f"interior RMSE {rmse:.4f} (bound {RMSE_BOUND})")
    if not rmse < RMSE_BOUND or vol.shape != g.volume_shape():
        fail(f"auto plan reconstruction: RMSE {rmse:.4f}")
    del vol, fn
    print(f"[auto] phase {time.perf_counter() - t0:.1f} s")
    return launches


def count_launches(svc, plans: dict, launches: dict) -> None:
    """Tally the back-projector's launches per codec of each bucket's plan
    while `svc` serves: the wrapper's count read at the bucket's ends. The
    wrapper's `filter_calls` adds up the filter_fn calls the buckets make,
    one a lane (a bucket's scans) and micro-batch, for `count_filter`."""
    serve_bucket = svc._serve_bucket

    def counted(bucket, *args):
        n0 = BP_LAUNCHES.n
        try:
            return serve_bucket(bucket, *args)
        finally:
            plan = plans[bucket.family]
            codec = plan.resolved_precision().storage
            launches[codec] = launches.get(codec, 0) + BP_LAUNCHES.n - n0
            counted.filter_calls += len(bucket.scans) * filter_calls(plan)

    counted.filter_calls = 0
    svc._serve_bucket = counted


def spans_s(spans: list) -> list:
    """The durations of trace events, in seconds."""
    return [round(s["dur"] / 1e6, 4) for s in spans]


def overlap_s(spans: list, others: list) -> float:
    """Seconds during which a span of `spans` and one of `others` both ran
    (trace events, µs)."""
    total = 0.0
    for a in spans:
        for b in others:
            lo = max(a["ts"], b["ts"])
            hi = min(a["ts"] + a["dur"], b["ts"] + b["dur"])
            total += max(0.0, hi - lo) / 1e6
    return total


def service_phase(g, proj, phantom, work: str) -> tuple:
    """Phase 16 [service]: ReconstructionService(device="cuda",
    max_batch=4) with spec="auto" serving two rounds of family A (impl=
    "kernel": 3 in-memory scans, one bucket of 3 lanes) and
    family B (impl="kernel", precision="fp16": an in-memory scan, and
    [io]'s fp16 ProjectionSource with a VolumeSink). Returns (the
    service, the kernel's launches per codec of the two drains, the family
    A plan's warm seconds per scan)."""
    import torch

    from repro_torch.io.streams import ProjectionSource, VolumeSink
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.obs.trace import Tracer, set_tracer
    from repro_torch.planner import plan_footprint, point_from_plan
    from repro_torch.service import (
        AdmissionError, QueueFullError, ReconstructionService, TicketState)

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    src = ProjectionSource(os.path.join(work, "io-proj"))
    scans_a = [proj, proj * 1.5, proj * 0.5]
    pins_a = {"impl": "kernel"}
    pins_b = {"impl": "kernel", "precision": "fp16"}
    svc = ReconstructionService(device="cuda", max_batch=4)
    total = torch.cuda.get_device_properties(0).total_memory
    if svc.hbm_bytes != total:
        fail(f"service budget {svc.hbm_bytes} is not the card's {total}")
    launches: dict = {}
    plans: dict = {}
    count_launches(svc, plans, launches)
    drains, seconds_a = [], None
    for rnd in (1, 2):
        sink = VolumeSink(os.path.join(work, f"service-vol-{rnd}"))
        tickets = [svc.submit(projections=p, geometry=g, **pins_a)
                   for p in scans_a]
        tickets.append(svc.submit(projections=proj, geometry=g, **pins_b))
        tickets.append(svc.submit(source=src, geometry=g, sink=sink,
                                  **pins_b))
        for t in tickets:
            plans.setdefault(t.family, svc.plan_cache.resolve(t.family))
        st0 = svc.stats()
        tracer = Tracer(enabled=True)
        prev = set_tracer(tracer)
        sync()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        svc._serve_bucket.filter_calls = 0
        t0 = time.perf_counter()
        try:
            svc.drain()
            sync()
        finally:
            set_tracer(prev)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n_launch = BP_LAUNCHES.n
        count_filter("service", svc._serve_bucket.filter_calls)
        st = svc.stats()
        bad = [t.scan_id for t in tickets if t.state is not TicketState.DONE]
        if bad:
            fail(f"service round {rnd}: tickets {bad} not DONE: "
                 f"{[repr(t.error) for t in tickets if t.error]}")
        # what the drain is compared with: each scan through its family
        # plan's warm build()
        loaded = src.load(device="cuda")
        inputs = scans_a + [proj, loaded]
        single, same = [], []
        for p, t in zip(inputs, tickets):
            fn = plans[t.family].build()
            fn(p)
            sync()
            t1 = time.perf_counter()
            vol = fn(p)
            sync()
            single.append(time.perf_counter() - t1)
            same.append(torch.equal(vol, t.result()))
            del vol
        same_sink = torch.equal(sink.read(), tickets[-1].result().cpu())
        rmse = interior_rmse(tickets[0].result(), phantom)
        loads = [s for s in tracer.spans("io.prefetch.load")
                 if s["dur"] > 1e3]
        engines = tracer.spans("engine.batched")
        lanes_run = sum(e["args"]["lanes"] for e in engines)
        assembly = tracer.spans("service.bucket.assemble")
        writes = tracer.spans("io.writeback.write")
        lat = st["latency"]
        print(f"[service] round {rnd}: drain {dt:.4f} s for 5 scans in "
              f"{st['buckets'] - st0['buckets']} buckets beside "
              f"{sum(single):.4f} s of warm single-scan build() "
              f"({', '.join(f'{s:.4f}' for s in single)}); kernel launches "
              f"{n_launch}; lanes {lanes_run}; "
              f"volumes bit-equal to plan_cache.resolve(family).build()"
              f"(scan): {same}; sink read() bit-equal: {same_sink}; "
              f"phantom scan interior RMSE {rmse:.4f} (bound {RMSE_BOUND}); "
              f"peak {peak / 2**30:.2f} GiB")
        print(f"[service] round {rnd}: means queue-wait "
              f"{lat['queue_wait']['mean']:.4f} s, bucket assembly "
              f"{lat['bucket_assembly']['mean']:.4f} s, time-to-volume "
              f"{lat['time_to_volume']['mean']:.4f} s (cumulative); per "
              f"bucket: assembly {spans_s(assembly)} s, engine "
              f"{spans_s(engines)} s; the sink's write-behind "
              f"{spans_s(writes)} s; the source load {spans_s(loads)} s on "
              f"the prefetch thread, {overlap_s(loads, engines):.4f} s of it "
              f"under an engine span (loads overlapped compute: "
              f"{overlap_s(loads, engines) > 0})")
        if not (all(same) and same_sink):
            fail(f"service round {rnd}: a volume is not bit-equal")
        if not rmse < RMSE_BOUND:
            fail(f"service round {rnd}: RMSE {rmse:.4f} >= {RMSE_BOUND}")
        if lanes_run != len(tickets):
            fail(f"service round {rnd}: {lanes_run} lanes run for "
                 f"{len(tickets)} scans")
        if n_launch < 1:
            fail(f"service round {rnd} did not launch the kernel")
        drains.append(dt)
        seconds_a = single[:3]
        del tickets, inputs, loaded
    del svc._serve_bucket   # the class's method again: counting ends
    st = svc.stats()
    if st["plan_cache"]["searches"] != 2:
        fail(f"service: {st['plan_cache']['searches']} planner searches "
             "for 2 families")
    fam_a = next(f for f in plans if dict(f.pins) == pins_a)
    plan_a = plans[fam_a]
    fp = plan_footprint(g, point_from_plan(plan_a)).total
    cap, _ = svc._bucket_capacity(fam_a, plan_a)
    print(f"[service] family A plan {plan_a.describe()}; family B plan "
          f"{plans[next(f for f in plans if f is not fam_a)].describe()}; "
          f"plan_cache {st['plan_cache']}; per-scan footprint "
          f"{fp / 2**30:.3f} GiB, bucket capacity {cap} under the card's "
          f"{total / 2**30:.2f} GiB (max_batch 4), capacity x footprint "
          f"{cap * fp / 2**30:.2f} GiB; kernel launches per codec "
          f"{launches}")
    # the two rejections
    low = ReconstructionService(device="cuda", hbm_bytes=fp - 1)
    try:
        low.submit(projections=proj, geometry=g, **pins_a)
        fail("service: a scan over the budget was admitted")
    except AdmissionError as e:
        rejected = low.stats()["rejected"]
        print(f"[service] hbm_bytes = footprint - 1: AdmissionError "
              f"({str(e)[:90]}...), rejected {rejected}")
        if rejected != 1:
            fail(f"service: {rejected} rejections counted, expected 1")
    finally:
        low.close()
    small = ReconstructionService(device="cuda", max_queue=2)
    try:
        for _ in range(2):
            small.submit(projections=proj, geometry=g, **pins_a)
        small.submit(projections=proj, geometry=g, **pins_a)
        fail("service: a third submit to max_queue=2 was queued")
    except QueueFullError:
        print(f"[service] max_queue=2: the third submit raised "
              f"QueueFullError, rejected {small.stats()['rejected']}, "
              f"queued {small.queued}")
    finally:
        small.close()
    print(f"[service] drains {[round(d, 4) for d in drains]} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return svc, launches, seconds_a


def serve_loop_phase(svc, g, proj, seconds_a: list) -> dict:
    """Phase 17 [serve-loop]: serve(), 4 family-A submits with deadline_s
    = 4 x the measured per-scan seconds, ticket.wait(timeout=120),
    shutdown(). Returns the kernel's launches per codec."""
    import torch

    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.service import TicketState

    t_phase = time.perf_counter()
    scans = [proj, proj * 1.5, proj * 0.5, proj]
    per_scan = sum(seconds_a) / len(seconds_a)
    deadline = 4 * per_scan
    st0 = svc.stats()
    reset_launches()
    t0 = time.perf_counter()
    svc.serve()
    tickets = [svc.submit(projections=p, geometry=g, impl="kernel",
                          deadline_s=deadline) for p in scans]
    waited = [t.wait(timeout=120) for t in tickets]
    wall = time.perf_counter() - t0
    svc.shutdown()
    n_launch = BP_LAUNCHES.n
    st = svc.stats()
    if not all(waited) or any(t.state is not TicketState.DONE
                              for t in tickets):
        fail(f"serve-loop: tickets {[t.state for t in tickets]}, waited "
             f"{waited}: {[repr(t.error) for t in tickets if t.error]}")
    plan = svc.plan_cache.resolve(tickets[0].family)
    count_filter("serve-loop", len(scans) * filter_calls(plan))
    fn = plan.build()
    same = [torch.equal(fn(p), t.result()) for p, t in zip(scans, tickets)]
    met = st["slo"]["met"] - st0["slo"]["met"]
    missed = st["slo"]["missed"] - st0["slo"]["missed"]
    ttv, ttv0 = st["latency"]["time_to_volume"], st0["latency"][
        "time_to_volume"]
    ttv_mean = (ttv["sum"] - ttv0["sum"]) / (ttv["count"] - ttv0["count"])
    print(f"[serve-loop] 4 submits, deadline_s {deadline:.4f} (4 x "
          f"{per_scan:.4f} s per scan): {wall:.4f} s from serve() to the "
          f"last wait(), {4 / wall * 3600:.0f} scans/hour; mean "
          f"time-to-volume {ttv_mean:.4f} s; SLO met {met}, "
          f"missed {missed}, attainment {met / (met + missed):.2f}; loop "
          f"passes {st['loop']['passes']}, errors {st['loop']['errors']}; "
          f"buckets {st['buckets'] - st0['buckets']}; kernel launches "
          f"{n_launch}; volumes bit-equal to build(): {same}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not all(same):
        fail("serve-loop: a volume is not bit-equal to build()")
    if not ttv_mean >= per_scan:
        fail(f"serve-loop: mean time-to-volume {ttv_mean:.4f} s is shorter "
             f"than one scan's {per_scan:.4f} s: DONE before the card "
             "finished")
    if n_launch < 1 or st["loop"]["errors"]:
        fail(f"serve-loop: {n_launch} launches, {st['loop']['errors']} "
             "loop errors")
    return {plan.resolved_precision().storage: n_launch}


def resumable_phase(g, proj, work: str) -> dict:
    """Phase 18 [resumable]: ResumableReconstruction over 8 micro-batches
    of 62 projections, each folded through the kernel by the streaming
    session's stage and fold into a 512^3 f32 accumulator on the card;
    checkpointed every 2 batches, failed at batch 5, resumed by a fresh
    instance. Returns the kernel's launches per codec (fp32)."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.fdk import fdk_scale
    from repro_torch.core.plan import ReconstructionPlan
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.runtime import ResumableReconstruction, StragglerMonitor

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    n = g.n_proj // N_STEPS
    sess = ReconstructionPlan(geometry=g, impl="kernel", precision="fp32",
                              schedule="incremental",
                              n_steps=N_STEPS).build_incremental()

    def step(acc, b):
        s = sess.stage(proj[b * n:(b + 1) * n], (b * n, (b + 1) * n))
        sess._acc = acc
        sess._fold(s.pm_col, s.q_col, s.sc_col)
        return sess._acc

    zeros = torch.zeros(g.volume_shape(), device="cuda")
    step(zeros, 0)    # warm-up
    mon = StragglerMonitor()
    want = ResumableReconstruction(lambda acc, b: mon.timed(step, acc, b)[0],
                                   zeros, N_STEPS).run()
    saves, nbytes = [], zeros.numel() * zeros.element_size()
    with tempfile.TemporaryDirectory(dir=work) as ckdir:
        mgr = CheckpointManager(ckdir)
        save = mgr.save

        def timed_save(*args, **kw):
            t0 = time.perf_counter()
            save(*args, **kw)
            saves.append(time.perf_counter() - t0)

        mgr.save = timed_save
        reset_launches()
        r1 = ResumableReconstruction(step, zeros, N_STEPS, mgr,
                                     checkpoint_every=2)
        try:
            r1.run(fail_at=5)
            fail("resumable: the injected failure did not raise")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        r2 = ResumableReconstruction(step, zeros, N_STEPS, mgr,
                                     checkpoint_every=2)
        t0 = time.perf_counter()
        r2.resume()
        sync()
        t_restore = time.perf_counter() - t0
        cursor = r2.state.cursor
        got = r2.run()
        sync()
        n_launch = BP_LAUNCHES.n
        count_filter("resumable", n_launch)    # a stage a fold
    same = torch.equal(got, want)
    fused = ReconstructionPlan(geometry=g, impl="kernel",
                               precision="fp32").build()(proj)
    rel = rel_max(got * fdk_scale(g), fused)
    hint = mon.rebalance_hint(N_STEPS, 1)
    print(f"[resumable] {N_STEPS} micro-batches of {n} projections, "
          f"checkpoint_every=2, fail_at=5: resumed at cursor {cursor}; "
          f"kernel launches {n_launch}; resumed result bit-equal to the "
          f"uninterrupted run: {same}; after fdk_scale vs fused build() "
          f"{rel:.3e} of the max (bound {REL_TOL:.0e})")
    print(f"[resumable] saves ({nbytes / 2**20:.0f} MiB + cursor) "
          f"{[round(s, 4) for s in saves]} s = "
          f"{[round(nbytes / s / 1e9, 3) for s in saves]} GB/s; restore "
          f"{t_restore:.4f} s = {nbytes / t_restore / 1e9:.3f} GB/s; step "
          f"seconds (StragglerMonitor, uninterrupted run) EMA "
          f"{mon.ema:.4f}, flagged {mon.flagged}, hint {hint}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if cursor != 4:
        fail(f"resumable: resumed at cursor {cursor}, expected 4")
    if not same:
        fail("resumable: the resumed result is not bit-equal")
    if not rel <= REL_TOL:
        fail(f"resumable: {rel:.3e} from fused > {REL_TOL:.0e}")
    return {"fp32": n_launch}


def mesh_one(dev, g, proj) -> dict:
    """Phase 19: the mesh engine on a world of one over NCCL; returns the
    kernel's launches per codec on the mesh path."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import assemble_volume
    from repro_torch.core.fdk import gups
    from repro_torch.core.plan import ReconstructionPlan
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.parallel.mesh import make_mesh

    sync = torch.cuda.synchronize

    def timed(fn):
        t0 = time.perf_counter()
        out = fn(proj)
        sync()
        return out, time.perf_counter() - t0

    launches = dict.fromkeys(MAIN_PATH_CODECS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1, timeout=PG_TIMEOUT)
        try:
            mesh = make_mesh((1, 1, 1), MESH_AXES, device_type="cuda")
            for codec in MAIN_PATH_CODECS:
                psum = {}
                for sched, kw, red in MESH_ONE_CASES:
                    base = ReconstructionPlan(
                        geometry=g, impl="kernel", precision=codec,
                        schedule=sched, **kw).build()
                    plan = ReconstructionPlan(
                        geometry=g, mesh=mesh, impl="kernel",
                        precision=codec, schedule=sched, reduce=red, **kw)
                    fn = plan.build()
                    base(proj)  # warm-ups
                    fn(proj)
                    sync()
                    want, t_none = timed(base)
                    before = dict(fn.collectives.bytes)
                    reset_launches()
                    got, t_mesh = timed(fn)
                    n_launch = BP_LAUNCHES.n
                    count_filter("mesh 1x1", filter_calls(plan))
                    moved = {k: v - before[k]
                             for k, v in fn.collectives.bytes.items()}
                    t_mesh = (t_mesh + timed(fn)[1]) / 2
                    t_none = (t_none + timed(base)[1]) / 2
                    launches[codec] += n_launch
                    vol = assemble_volume(got, mesh, red).reshape(
                        g.volume_shape())
                    label = f"{codec} {sched} {kw} {red}"
                    if red == "scatter_bf16":
                        ref = psum[sched]
                        rel = float((vol - ref).abs().max()
                                    / ref.abs().max())
                        check = (f"vs psum max abs / max {rel:.3e} (bound "
                                 f"{BF16_REDUCE_RTOL:.3e})")
                        ok = rel < BF16_REDUCE_RTOL
                    else:
                        ok = torch.equal(vol, want)
                        check = ("bit-equal to mesh=None" if ok else
                                 "NOT bit-equal to mesh=None: max abs "
                                 f"{float((vol - want).abs().max()):.3e}")
                        if red == "psum":
                            psum[sched] = vol
                    print(f"[mesh-1x1] {label}: mesh {t_mesh:.4f} s "
                          f"({gups(g, t_mesh):.2f} GUPS), mesh=None "
                          f"{t_none:.4f} s ({gups(g, t_none):.2f} GUPS); "
                          f"kernel launches {n_launch}; bytes per call "
                          f"{moved}; {check}")
                    if n_launch < 1:
                        fail(f"mesh 1x1 {label} did not launch the kernel")
                    if not ok:
                        fail(f"mesh 1x1 {label}: {check}")
                    del base, fn, want, got, vol
                del psum
            launches["fp32"] += mesh_sessions(g, proj, mesh)
            launches["fp32"] += mesh_traced(g, proj, mesh)
        finally:
            dist.destroy_process_group()
    return launches


def fold_session(plan, proj, n_steps: int, mesh=None, session=None):
    """Fold every delta of `proj` in order into `session` (default: a new
    session of `plan`; on a mesh, this rank's share of each) and
    finalize."""
    from repro_torch.core.distributed import local_projections

    sess = plan.build_incremental() if session is None else session
    n_d = proj.shape[0] // n_steps
    for lo in range(0, proj.shape[0], n_d):
        delta = proj[lo:lo + n_d]
        sess.update(delta if mesh is None else local_projections(delta, mesh),
                    (lo, lo + n_d))
    return sess.finalize()


def mesh_sessions(g, proj, mesh) -> int:
    """The [mesh-1x1] incremental sessions (fp32, 8 deltas) under each
    reduce, against the mesh=None session; returns the kernel launches."""
    import torch

    from repro_torch.core.distributed import assemble_volume
    from repro_torch.core.plan import ReconstructionPlan
    from repro_torch.kernels.backproject import kernel as bpk

    kw = dict(geometry=g, impl="kernel", precision="fp32",
              schedule="incremental", n_steps=N_STEPS)
    none = fold_session(ReconstructionPlan(**kw), proj, N_STEPS)
    launches, vols = 0, {}
    for red in MESH_SESSION_REDUCES:
        reset_launches()
        t0 = time.perf_counter()
        part = fold_session(ReconstructionPlan(mesh=mesh, reduce=red, **kw),
                            proj, N_STEPS, mesh)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_launch = BP_LAUNCHES.n
        count_filter("mesh 1x1", N_STEPS)
        launches += n_launch
        vol = assemble_volume(part, mesh, red).reshape(g.volume_shape())
        if red == "scatter_bf16":
            rel = rel_max(vol, vols["psum"])
            ok = rel < BF16_REDUCE_RTOL
            check = (f"vs the psum session {rel:.3e} of the max (bound "
                     f"{BF16_REDUCE_RTOL:.3e})")
        else:
            ok = torch.equal(vol, none)
            check = ("bit-equal to the mesh=None session" if ok else
                     "NOT bit-equal to the mesh=None session: max abs "
                     f"{float((vol - none).abs().max()):.3e}")
        vols[red] = vol
        print(f"[mesh-1x1] incremental fp32 {red}: {N_STEPS} deltas "
              f"folded and finalized in {dt:.4f} s; kernel launches "
              f"{n_launch}; {check}")
        if n_launch != N_STEPS:
            fail(f"mesh 1x1 incremental {red}: {n_launch} kernel launches")
        if not ok:
            fail(f"mesh 1x1 incremental {red}: {check}")
        del part
    return launches


def mesh_traced(g, proj, mesh) -> int:
    """Part of [mesh-1x1]: build_traced() and the traced session (fp32, 8
    deltas) on the world of one, against mesh=None's; returns the
    kernel's launches on the mesh."""
    import torch

    from repro_torch.core.distributed import assemble_volume
    from repro_torch.core.plan import ReconstructionPlan
    from repro_torch.kernels.backproject import kernel as bpk

    kw = dict(geometry=g, impl="kernel", precision="fp32")
    want = ReconstructionPlan(**kw).build_traced()(proj)
    reset_launches()
    got = assemble_volume(
        ReconstructionPlan(mesh=mesh, **kw).build_traced()(proj), mesh,
        "psum")
    torch.cuda.synchronize()
    n_launch = BP_LAUNCHES.n
    count_filter("mesh 1x1", 1)
    engine_ok = torch.equal(got, want)
    kw.update(schedule="incremental", n_steps=N_STEPS)
    none = ReconstructionPlan(**kw)
    want = fold_session(none, proj, N_STEPS, session=none.build_traced())
    plan = ReconstructionPlan(mesh=mesh, **kw)
    sess = plan.build_traced()
    reset_launches()
    got = assemble_volume(fold_session(plan, proj, N_STEPS, mesh, sess),
                          mesh, "psum")
    torch.cuda.synchronize()
    n_launch += BP_LAUNCHES.n
    count_filter("mesh 1x1", N_STEPS)
    session_ok = torch.equal(got, want)
    print(f"[mesh-1x1] build_traced() fp32 psum bit-equal to mesh=None's: "
          f"{engine_ok}; the traced session ({N_STEPS} deltas) bit-equal "
          f"to mesh=None's: {session_ok}, stage seconds "
          f"{sess.stage_seconds()}; kernel launches {n_launch}")
    if not (engine_ok and session_ok) or n_launch != 1 + N_STEPS:
        fail(f"mesh 1x1 traced: engine {engine_ok}, session {session_ok}, "
             f"{n_launch} launches")
    return n_launch


def spawn_ranks(world: int, work: str, deadline: float,
                flag: str = "--mesh-rank", meanwhile=None) -> list:
    """Run `world` copies of this script as ranks of a mesh phase (`flag
    RANK WORLD WORK`), and `meanwhile()` in this process while they run;
    returns (exit code, output tail, report or None) per rank. A rank
    past the deadline is killed."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r),
         str(world), work],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        if meanwhile is not None:
            meanwhile()
    except BaseException:
        for p in procs:
            p.kill()
        raise
    results = []
    end = time.perf_counter() + deadline
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=max(1.0, end - time.perf_counter()))[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0] + "\n[killed at the deadline]"
        path = os.path.join(work, f"rank{r}.json")
        report = None
        if os.path.exists(path):
            with open(path) as f:
                report = json.load(f)
        results.append((p.returncode, out[-4000:], report))
    return results


def mesh_rank(rank: int, world: int, work: str) -> None:
    """A rank of the 2 x 2 phase: gloo over CUDA tensors on the one card.
    Runs every case of MESH_FOUR_CASES; rank 0 holds each assembled volume
    against the references in WORK/refs.pt. A collective that raises ends
    the rank with its error."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, SRC)
    from repro_torch.core.distributed import (
        assemble_volume, local_projections)
    from repro_torch.core.geometry import CBCTGeometry
    from repro_torch.core.phantom import forward_project
    from repro_torch.core.plan import ReconstructionPlan
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/pg",
                            rank=rank, world_size=world, timeout=PG_TIMEOUT)
    report = {"rank": rank, "cases": []}
    try:
        mesh = make_mesh(MESH_FOUR_SHAPE, MESH_AXES, device_type="cuda")
        g = rabbitct_geometry(CBCTGeometry)
        local = local_projections(forward_project(g, device="cuda"),
                                  mesh).clone()
        refs = (torch.load(os.path.join(work, "refs.pt"), map_location="cuda")
                if rank == 0 else None)
        torch.cuda.empty_cache()
        report["local_shape"] = list(local.shape)
        for sched, kw, red in MESH_FOUR_CASES:
            plan = ReconstructionPlan(geometry=g, mesh=mesh, impl="kernel",
                                      precision="fp32", schedule=sched,
                                      reduce=red, **kw)
            fn = plan.build()
            case = {"bp_call_shape": list(plan.bp_call_shape())}
            dist.barrier()
            reset_launches()
            t0 = time.perf_counter()
            part = fn(local)
            torch.cuda.synchronize()
            case["seconds"] = time.perf_counter() - t0
            case["launches"] = BP_LAUNCHES.n
            case["filter_launches"] = FILTER_LAUNCHES.n
            _, direct, pairs = direct_pairs(lambda: fn(local))
            case["direct_share"] = direct / pairs
            case["out_shape"] = list(part.shape)
            case["bytes"] = dict(fn.collectives.bytes)
            vol = assemble_volume(part, mesh, red).reshape(g.volume_shape())
            if rank == 0:
                case["rel"] = {k: float((vol - ref).abs().max()
                                        / ref.abs().max())
                               for k, ref in refs.items()}
            if not report["cases"]:
                report["checkpoint"] = mesh_checkpoint(
                    rank, work, mesh, plan.output_spec(), part, vol)
            report["cases"].append(case)
            del fn, part, vol
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)


def mesh_checkpoint(rank: int, work: str, mesh, spec, part, vol) -> dict:
    """A rank's half of the 2 x 2 phase's checkpoint: save its part as
    step 1 of WORK/ckpt under `spec`, load it back on the mesh; rank 0
    also stores the assembled volume for the parent's whole load."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.io import shard_store

    out = {"spec": spec}
    snap = shard_store.snapshot(part, mesh, spec)
    dist.barrier()   # the ranks' save seconds from one start
    t0 = time.perf_counter()
    save_checkpoint(os.path.join(work, "ckpt"), 1, {"vol": snap})
    out["save_s"] = time.perf_counter() - t0
    shard_store.reset_open_count()
    t0 = time.perf_counter()
    back = load_checkpoint(os.path.join(work, "ckpt"), 1, {"vol": snap},
                           mesh=mesh, device="cuda")["vol"]
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["opened"] = shard_store.open_count()
    out["equal"] = bool(torch.equal(back, part))
    if rank == 0:
        torch.save(vol.cpu(), os.path.join(work, "assembled.pt"))
    return out


def plain_reference(g, proj, r: int):
    """The fp32 reconstruction on one device by the kernel's plain version,
    computed slab by slab with P shifted by `shift_pmats_i` as an R-slab
    mesh shifts it (R = 1: the whole volume, P unshifted)."""
    import torch

    from repro_torch.core.backprojection import from_dual_slab
    from repro_torch.core.distributed import shift_pmats_i
    from repro_torch.core.fdk import fdk_scale
    from repro_torch.core.filtering import make_filter
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.core.precision import CODECS as CODEC_TABLE
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.kernels.backproject.ops import kernel_operands

    filt = make_filter(g, "ramlak", out_dtype=torch.float32,
                       device=proj.device)
    data, scales = CODEC_TABLE["fp32"].encode(filt(proj))
    pm = torch.as_tensor(projection_matrices(g), device=proj.device)
    nx = g.n_x // r
    return torch.cat([
        from_dual_slab(bpk.backproject_dual_torch(
            *kernel_operands(shift_pmats_i(pm, float(m * nx)), data, scales),
            nx, g.n_y, g.n_z))
        for m in range(r)]) * fdk_scale(g)


def rel_max(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def mesh_four(g, proj) -> int:
    """Phase 20, the 2 x 2 phase: the references on one device, then four
    ranks on the one card; returns the kernel launches of all ranks on the
    mesh path."""
    import torch

    from repro_torch.core.plan import ReconstructionPlan

    t0 = time.perf_counter()
    none = ReconstructionPlan(geometry=g, impl="kernel",
                              precision="fp32").build()(proj)
    whole = plain_reference(g, proj, 1)
    shifted = plain_reference(g, proj, MESH_FOUR_SHAPE[-1])
    torch.cuda.synchronize()
    kernel_rel, witness = rel_max(none, whole), rel_max(shifted, whole)
    shift_bound = witness + 2 * MESH_REL_TOL
    print(f"[mesh-2x2] references, fp32, {g.n_proj} projections, "
          f"{time.perf_counter() - t0:.1f} s: mesh=None (kernel) vs plain "
          f"whole volume {kernel_rel:.3e} of the max (bound "
          f"{REL_TOL:.0e}); witness, plain with P shifted per slab vs plain "
          f"whole volume {witness:.3e}")
    if not kernel_rel <= REL_TOL:
        fail(f"mesh=None engine off the plain version by {kernel_rel:.3e}")
    with tempfile.TemporaryDirectory() as work:
        torch.save({"mesh=None": none, "plain shifted": shifted},
                   os.path.join(work, "refs.pt"))
        del none, whole, shifted
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        results = spawn_ranks(4, work, RANK_DEADLINE_S)
        for r, (rc, tail, rep) in enumerate(results):
            if rc != 0 or rep is None or len(rep["cases"]) != len(
                    MESH_FOUR_CASES):
                fail(f"mesh 2x2 rank {r} exited {rc}:\n{tail}")
        whole_checkpoint(g, work, [rep["checkpoint"] for _, _, rep in results])
    print(f"[mesh-2x2] 4 ranks (pod, data, model) = {MESH_FOUR_SHAPE}, "
          f"gloo over CUDA tensors, {time.perf_counter() - t0:.1f} s from "
          f"spawn to exit; local projections "
          f"{results[0][2]['local_shape']}")
    launches = 0
    for i, (sched, kw, red) in enumerate(MESH_FOUR_CASES):
        cases = [rep["cases"][i] for _, _, rep in results]
        label = f"fp32 {sched} {kw} {red}"
        launches += sum(c["launches"] for c in cases)
        filters = [c["filter_launches"] for c in cases]
        FILTER_BY_PATH["mesh 2x2, all ranks"] = (
            FILTER_BY_PATH.get("mesh 2x2, all ranks", 0) + sum(filters))
        rel = cases[0]["rel"]
        bounds = ({"plain shifted": BF16_REDUCE_RTOL,
                   "mesh=None": BF16_REDUCE_RTOL} if red == "scatter_bf16"
                  else {"plain shifted": MESH_REL_TOL,
                        "mesh=None": shift_bound})
        checks = "; ".join(f"vs {k} {rel[k]:.3e} (bound {b:.3e})"
                           for k, b in bounds.items())
        seconds = [round(c["seconds"], 3) for c in cases]
        shares = ", ".join(f"{c['direct_share']:.4%}" for c in cases)
        print(f"[mesh-2x2] {label}: kernel call (nx, ny, n_p) "
              f"{cases[0]['bp_call_shape']}, per-rank output "
              f"{cases[0]['out_shape']}; seconds (first call) {seconds}; "
              f"kernel launches per rank {[c['launches'] for c in cases]}, "
              f"filter kernel launches per rank {filters}; direct-gather share of each rank's last launch [{shares}]; "
              f"rank 0 bytes {cases[0]['bytes']}; assembled volume, max "
              f"abs / max: {checks}")
        if min(c["launches"] for c in cases) < 1:
            fail(f"mesh 2x2 {label}: a rank did not launch the kernel")
        if filters != [kw.get("n_steps", 1)] * len(cases):
            fail(f"mesh 2x2 {label}: filter kernel launches per rank "
                 f"{filters}, expected one a micro-batch")
        if not all(rel[k] <= b for k, b in bounds.items()):
            fail(f"mesh 2x2 {label}: {checks}")
    return launches


def whole_checkpoint(g, work: str, ranks: list) -> None:
    """The 2 x 2 phase's checkpoint in this process: the ranks' loads
    (each its own part, bit-equal), then a load with mesh=None, bit-equal
    to the assembled volume rank 0 stored."""
    import torch

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.io import shard_store

    shard_store.reset_open_count()
    t0 = time.perf_counter()
    whole = load_checkpoint(os.path.join(work, "ckpt"), 1, {
        "vol": torch.empty(g.volume_shape(), device="meta")},
        device="cuda")["vol"]
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    opened = shard_store.open_count()
    same = torch.equal(whole.cpu(), torch.load(
        os.path.join(work, "assembled.pt")))
    print(f"[mesh-2x2] checkpoint of fused/psum, spec {ranks[0]['spec']}: "
          f"save seconds per rank {[round(c['save_s'], 3) for c in ranks]}; "
          f"load with mesh= per rank {[round(c['load_s'], 3) for c in ranks]}"
          f" s, shard files opened {[c['opened'] for c in ranks]}, own part "
          f"bit-equal {[c['equal'] for c in ranks]}; load with mesh=None "
          f"{t_load:.3f} s, {opened} shard files, bit-equal to the "
          f"assembled volume: {same}")
    if not (same and all(c["equal"] for c in ranks)):
        fail("mesh 2x2 checkpoint: a load is not bit-equal")


def mxu_check(dev) -> None:
    """Phase 21: backproject_mxu against the factorized oracle at
    default_geometry(32) on the card."""
    import torch

    from repro_torch.core.backprojection import backproject_factorized
    from repro_torch.core.filtering import make_filter
    from repro_torch.core.geometry import default_geometry, projection_matrices
    from repro_torch.core.phantom import forward_project
    from repro_torch.kernels.backproject.ops import backproject_mxu

    g = default_geometry(32)
    q = make_filter(g, device=dev)(forward_project(g, device=dev))
    pm = torch.as_tensor(projection_matrices(g), device=dev)
    shape = (g.n_x, g.n_y, g.n_z)
    got = backproject_mxu(pm, q, *shape)
    want = backproject_factorized(pm, q, *shape)
    torch.cuda.synchronize()
    # assert_allclose's rule: |got - want| <= atol + rtol |want|
    excess = float(((got - want).abs() - MXU_RTOL * want.abs()).max())
    print(f"[mxu] backproject_mxu vs factorized at {shape}, {g.n_proj} "
          f"projections: max abs {float((got - want).abs().max()):.3e}, "
          f"max(|d| - rtol |want|) {excess:.3e} (rtol {MXU_RTOL:.0e}, atol "
          f"{MXU_ATOL:.0e})")
    if not excess <= MXU_ATOL:
        fail(f"backproject_mxu off the factorized oracle: {excess:.3e}")


def rel_rmse(got, want) -> float:
    """RMS(got - want) / RMS(want), in f32."""
    got, want = got.float(), want.float()
    return float(((got - want) ** 2).mean().sqrt() / (want ** 2).mean().sqrt())


def profile(fn, label: str, top: int) -> None:
    """One traced run of `fn`: wall time, the device's busy share and the
    device time of the `top` largest kernels by name."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({busy_us / wall_us:.1%}), by kernel:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
              f"x{e.count:<5d} {e.key[:110]}")
    host = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    print(f"[profile] {label}: host time by operator (self):")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:5]:
        print(f"[profile]   {e.self_cpu_time_total / 1e3:9.2f} ms "
              f"x{e.count:<5d} {e.key}")


def attention_operands(cfg, s: int, dtype, dev, seed: int, batch=None):
    """Folded (B*H, S, D) q and (B*K, S, D) k, v at the serving widths, from
    numpy's standard normal; B is `batch`, by default the serving BATCH."""
    import torch

    rng = np.random.default_rng(seed)
    d = cfg.resolved_head_dim
    b = BATCH if batch is None else batch
    return tuple(
        torch.from_numpy(rng.standard_normal((b * n, s, d),
                                             dtype=np.float32))
        .to(device=dev, dtype=dtype)
        for n in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))


def causal_attention_flops(batch: int, heads: int, s: int, d: int) -> float:
    """Query i meets keys 0..i, 2 D operations each for q.k and p.v."""
    return 4 * d * s * (s + 1) / 2 * batch * heads


def f32_excess(got, want) -> float:
    """assert_close's rule at rtol = atol = ATTN_F32_TOL passes when this
    is <= ATTN_F32_TOL: max of |got - want| - rtol |want|."""
    err = (got.double() - want.double()).abs()
    return float((err - ATTN_F32_TOL * want.double().abs()).max())


def attention_checks(cfg, dev, mha_cfg, gqa8_cfg, gqa7_cfg) -> dict:
    """Phase 22; returns the max |kernel - plain| per dtype, and the
    stressed f32 case's max distances from the f64 evaluation. `mha_cfg`
    gives the group-1 (MHA) cases their heads, `gqa8_cfg` the group-8
    ones, `gqa7_cfg` the group-7 ones (56 heads over 8)."""
    import torch

    max_abs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(cfg, torch.float32, True, PROMPT),
             (cfg, torch.float32, False, PROMPT),
             (cfg, torch.bfloat16, True, PROMPT),
             (cfg, torch.float32, True, RAGGED),
             (cfg, torch.bfloat16, True, RAGGED),
             (mha_cfg, torch.float32, True, PROMPT),
             (mha_cfg, torch.bfloat16, True, PROMPT),
             (gqa8_cfg, torch.float32, True, PROMPT),
             (gqa8_cfg, torch.bfloat16, True, PROMPT)]
    # The group-7 cases take seeds after the stressed case's, which keeps
    # the seeds of the cases above.
    group7 = [(gqa7_cfg, torch.float32, True, PROMPT),
              (gqa7_cfg, torch.bfloat16, True, PROMPT)]
    seeds = [SEED + i for i in range(len(cases))] + [
        SEED + len(cases) + 1 + i for i in range(len(group7))]
    for seed, (c, dtype, causal, s) in zip(seeds, cases + group7):
        q, k, v = attention_operands(c, s, dtype, dev, seed=seed)
        worst = kernel_vs_plain("[attn-check]", q, k, v, causal=causal)
        max_abs[dtype] = max(max_abs[dtype], worst)

    stressed = stressed_check("[attn-check]", cfg, dev, SEED + len(cases))
    return max_abs, stressed


def stressed_check(tag: str, cfg, dev, seed: int) -> dict:
    """The stressed f32 case at `cfg`'s serving shape: q and k x
    ATTN_STRESS, the kernel within rtol = atol = ATTN_F32_TOL of the f64
    evaluation and no farther from it than the plain version. Returns both
    max distances from f64."""
    import torch

    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.kernels.attention.ref import attention_f64

    q, k, v = attention_operands(cfg, PROMPT, torch.float32, dev, seed=seed)
    q, k = q * ATTN_STRESS, k * ATTN_STRESS
    got = fak.flash_attention_bhsd(q, k, v)
    want = fak.flash_attention_bhsd_torch(q, k, v)
    exact = attention_f64(q, k, v, causal=True)
    torch.cuda.synchronize()
    stressed = {name: float((x.double() - exact).abs().max())
                for name, x in (("kernel", got), ("plain", want))}
    label = (f"{tuple(q.shape)} q, {tuple(k.shape)} k/v, float32, causal, "
             f"q and k x {ATTN_STRESS:g}")
    print(f"{tag} {label}: max|kernel-f64| {stressed['kernel']:.3e}, "
          f"max|plain-f64| {stressed['plain']:.3e}, max|kernel-plain| "
          f"{float((got - want).abs().max()):.3e} (kernel vs f64: rtol = "
          f"atol = {ATTN_F32_TOL:.0e}, and no farther than plain)")
    if (f32_excess(got, exact) > ATTN_F32_TOL
            or stressed["kernel"] > stressed["plain"]):
        fail(f"attention kernel off the exact function: {label}: max abs "
             f"{stressed['kernel']:.3e} (plain {stressed['plain']:.3e})")
    return stressed


@contextlib.contextmanager
def f64_attention_step(layers):
    """The prefill's attention step evaluated in f64 (`attention_f64`),
    rounded once to the step's dtype: the exact attention function, for a
    witness of how far f32 summation order alone moves a model's logits."""
    from repro_torch.kernels.attention.ref import attention_f64

    def step(cfg, q, k, v, positions, check_positions=True):
        b, s, h, d = q.shape

        def fold(t):
            return t.permute(0, 2, 1, 3).reshape(-1, s, d)

        out = attention_f64(fold(q), fold(k), fold(v),
                            window=layers.kernel_window(cfg, s))
        return out.reshape(b, h, s, d).permute(0, 2, 1, 3).to(q.dtype)

    kernel_step = layers.prefill_attention
    layers.prefill_attention = step
    try:
        yield
    finally:
        layers.prefill_attention = kernel_step


@contextlib.contextmanager
def plain_attention_step(layers):
    """The plain (reference) attention step in prefill on the card, for a
    comparison; the port's own path always takes the kernel there."""
    kernel_step = layers.prefill_attention
    layers.prefill_attention = layers.prefill_attention_plain
    try:
        yield
    finally:
        layers.prefill_attention = kernel_step


def serving_prompts(cfg, dev):
    """The serving cell's BATCH x PROMPT token ids, from numpy."""
    import torch

    rng = np.random.default_rng(SEED)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))).to(dev)


def attention_layers(cfg) -> int:
    return cfg.repeats * sum(s.kind == "attn" for s in cfg.pattern)


def generate(tag: str, cfg, params, prompt, s_max=None) -> dict:
    """The serving traffic: greedy_generate over `prompt` (B x S tokens, B x
    K x S codes for audio, a vision prompt's images first) for STEPS steps
    up to `s_max` positions (default S_MAX) after a warm-up prefill, with
    the kernels' counts at 0 just before it; then a prefill alone, timed.
    Gates the ids,
    one kernel launch per attention layer of the prefill, and that those
    launches were windowed exactly when the prompt is longer than the
    config's window. Returns the launches (and the windowed ones), the
    timed prefill's logits and cache, prefill seconds, decode ms per step
    and the peak device memory of the greedy run."""
    import torch

    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import kernel_window
    from repro_torch.serving import greedy_generate, make_prefill

    sync = torch.cuda.synchronize
    s_max = S_MAX if s_max is None else s_max
    tokens = prompt["tokens"]
    b, s, n_pos = tokens.shape[0], tokens.shape[-1], T.prompt_len(cfg, prompt)
    prefill = make_prefill(cfg)
    prefill(params, prompt)   # warm-up: cuBLAS handles, the allocator
    sync()
    n_attn = attention_layers(cfg)
    n_window = n_attn if kernel_window(cfg, n_pos) else 0
    torch.cuda.reset_peak_memory_stats()
    BP_LAUNCHES.reset()
    ATTN_LAUNCHES.reset()
    ATTN_WINDOW_LAUNCHES.reset()
    t0 = time.perf_counter()
    ids = greedy_generate(cfg, params, prompt, steps=STEPS, s_max=s_max)
    sync()
    total_s = time.perf_counter() - t0
    launches, window_launches = ATTN_LAUNCHES.n, ATTN_WINDOW_LAUNCHES.n
    peak = torch.cuda.max_memory_allocated()
    if tuple(ids.shape) != (*tokens.shape[:-1], STEPS + 1) or not (
            0 <= int(ids.min()) and int(ids.max()) < cfg.vocab_size):
        fail(f"{tag} greedy_generate gave ids of shape {tuple(ids.shape)} "
             f"outside [0, {cfg.vocab_size})")
    if launches != n_attn:
        fail(f"{tag} one prefill launched the attention kernel {launches} "
             f"times, not {n_attn}")
    if window_launches != n_window:
        fail(f"{tag} {window_launches} windowed launches in a prefill of "
             f"{n_pos} positions, not {n_window}")
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt)
    sync()
    prefill_s = time.perf_counter() - t0
    decode_ms = (total_s - prefill_s) / STEPS * 1e3
    what = f"{s}-token prompts" if n_pos == s else (
        f"({n_pos - s} image + {s} text)-position prompts")
    if tokens.dim() == 3:
        what = f"{tokens.shape[1]} x {s}-code prompts"
    print(f"{tag} greedy_generate {b} x {what}, "
          f"{STEPS} steps, s_max {s_max}: {total_s:.4f} s, "
          f"{b * (STEPS + 1) / total_s:.1f} generated tokens/s; prefill "
          f"{prefill_s:.4f} s ({b * n_pos / prefill_s:.0f} prompt "
          f"tokens/s); decode {decode_ms:.3f} ms/step "
          f"({b * 1e3 / decode_ms:.1f} tokens/s); peak "
          f"{peak / 2**30:.2f} GiB; attention-kernel launches {launches} "
          f"(one prefill of {n_attn} attention layers"
          + (f", {window_launches} of them windowed" if n_window else "")
          + ")")
    print(f"{tag} first request's ids: {ids[0].flatten()[:12].tolist()} ...")
    if not torch.isfinite(logits.float()).all():
        fail(f"{tag} prefill gave non-finite logits")
    return {"launches": launches, "window_launches": window_launches,
            "logits": logits, "cache": cache, "prefill_s": prefill_s,
            "decode_ms": decode_ms, "peak": peak}


def serving(cfg, dev) -> dict:
    """Phase 23; returns the attention kernel's launches per dtype on the
    serving path (bf16: greedy_generate; f32: the f32 prefill)."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serving import greedy_generate, make_prefill

    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED)
    sync()
    n_params = T.param_count(params)
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, {n_params} parameters ({cfg.param_dtype}"
          f", {n_params * 4 / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    tokens = serving_prompts(cfg, dev)
    prompt = {"tokens": tokens}
    prefill = make_prefill(cfg)
    run = generate("[serve]", cfg, params, prompt)
    launches = {torch.bfloat16: run["launches"]}
    logits_k, cache = run["logits"], run["cache"]

    # Where the time goes: the prefill alone, then the whole path.
    profile(lambda: prefill(params, prompt), "bf16 prefill", top=10)
    profile(lambda: greedy_generate(cfg, params, prompt, steps=STEPS,
                                    s_max=S_MAX),
            f"bf16 greedy_generate ({STEPS} steps)", top=10)
    launches[torch.float32] = logit_checks(cfg, params, prompt, logits_k,
                                           cache)
    return launches


def logit_checks(cfg, params, prompt, logits_k, cache,
                 tag: str = "[serve-check]", decode_cfg=None) -> int:
    """The serving checks on the card, from the bf16 prefill's last-position
    logits and cache over `prompt`; returns the f32 prefill's kernel
    launches (windowed ones gated as in `generate`). With `decode_cfg` (a
    MoE model's copy whose capacity drops nothing) the decode check runs on
    that copy, from its own prefill, under a bound computed on it."""
    import torch

    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    sync = torch.cuda.synchronize
    tokens = prompt["tokens"]
    b, n_pos = tokens.shape[0], T.prompt_len(cfg, prompt)
    n_attn = attention_layers(cfg)
    n_window = n_attn if L.kernel_window(cfg, n_pos) else 0

    # The kernel path against the plain attention step, on the card. In
    # bf16 the plain step rounds the scores to bf16 and the kernel keeps
    # them in f32, so they differ by bf16 rounding: the bound is twice the
    # plain path's own distance from the f32 model (the triangle
    # inequality, if the kernel path is no further from f32 than the plain
    # one). In f32 only the summation order differs.
    cfg32 = cfg.scaled(dtype="float32")
    before = ATTN_LAUNCHES.n
    with plain_attention_step(L):
        logits_p, _ = T.prefill(params, cfg, prompt)
        logits_32p, _ = T.prefill(params, cfg32, prompt)
    sync()
    if ATTN_LAUNCHES.n != before:
        fail("the plain attention step launched the kernel")
    ATTN_LAUNCHES.reset()
    ATTN_WINDOW_LAUNCHES.reset()
    logits_32k, _ = T.prefill(params, cfg32, prompt)
    sync()
    f32_launches = ATTN_LAUNCHES.n
    if f32_launches != n_attn or ATTN_WINDOW_LAUNCHES.n != n_window:
        fail(f"{tag} the f32 prefill launched the kernel {f32_launches} "
             f"times ({ATTN_WINDOW_LAUNCHES.n} windowed), not {n_attn} "
             f"({n_window})")
    e_plain = rel_rmse(logits_p, logits_32p)
    bf16_bound = 2 * e_plain
    d_bf16 = rel_rmse(logits_k, logits_p)
    d_f32 = rel_rmse(logits_32k, logits_32p)
    print(f"{tag} last-position logits, relative RMSE: bf16 kernel "
          f"path vs bf16 plain path {d_bf16:.3e} (bound {bf16_bound:.3e} = "
          f"2 x bf16 plain vs f32 plain {e_plain:.3e}); bf16 kernel path vs "
          f"f32 plain {rel_rmse(logits_k, logits_32p):.3e}; f32 kernel path "
          f"vs f32 plain path {d_f32:.3e} (bound {F32_LOGITS_REL:.0e})")
    if not d_bf16 <= bf16_bound:
        fail(f"{tag} bf16 kernel path off the plain path by {d_bf16:.3e}")
    if not d_f32 <= F32_LOGITS_REL:
        fail(f"{tag} f32 kernel path off the plain path by {d_f32:.3e}")
    del logits_p, logits_32p, logits_32k

    # Decode self-consistency: decode_step at position n_pos (behind a
    # vision prompt's images) against a prefill over the prompt plus that
    # token (n_pos + 1 positions, a ragged tail for the kernel; with a
    # window shorter than the prompt the decode cache is a ring that this
    # step wraps). Decode runs the plain step on a bf16 cache, the prefill
    # the kernel: the same bf16 bound.
    if decode_cfg is not None:
        cfg = decode_cfg
        logits_k, cache = T.prefill(params, cfg, prompt)
    nxt = logits_k.argmax(-1)[..., None]
    longer = dict(prompt, tokens=torch.cat([tokens, nxt], dim=-1))
    if decode_cfg is not None:
        # Each bf16 path within e of f32 puts them within 2 e of each other.
        with plain_attention_step(L):
            plain_bf16 = T.prefill(params, cfg, longer)[0]
            plain_f32 = T.prefill(params, cfg.scaled(dtype="float32"),
                                  longer)[0]
            bf16_bound = 2 * rel_rmse(plain_bf16, plain_f32)
            del plain_bf16, plain_f32
    full = T.extend_cache(cfg, cache, n_pos + 1)
    dec, _ = T.decode_step(params, cfg, full, nxt, n_pos)
    ref, _ = T.prefill(params, cfg, longer)
    d_dec = rel_rmse(dec, ref)
    agree = dec.argmax(-1) == ref.argmax(-1)
    print(f"{tag} decode_step at {n_pos} vs prefill over "
          f"{n_pos + 1} positions: relative RMSE {d_dec:.3e} (bound "
          f"{bf16_bound:.3e}); argmax agrees for "
          f"{int(agree.sum())}/{agree.numel()}")
    if not d_dec <= bf16_bound:
        fail(f"{tag} decode_step off prefill by {d_dec:.3e}")
    return f32_launches


def attention_bounds(q, k, v, flops: float) -> tuple:
    """(bytes ms, operations ms, what the operations bound counts) of one
    attention forward: q, k, v read and the output written once; bf16 at
    the dense bf16 rate, f32 as three TF32 products per product at the
    dense TF32 rate (f32 accuracy is had two ways on this card, on the f32
    cores or as 3xTF32 on the tensor cores; the least time is the
    latter's)."""
    import torch

    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    if q.dtype == torch.bfloat16:
        return bytes_ms, flops / PEAK_BF16_OPS_PER_S * 1e3, "bf16 tensor cores"
    return (bytes_ms,
            TF32_SPLIT_PRODUCTS * flops / PEAK_TF32_OPS_PER_S * 1e3,
            f"3xTF32: {TF32_SPLIT_PRODUCTS} x operations at the dense TF32 "
            "rate")


def attention_timing(cfg, dev, launches: dict, max_abs: dict,
                     stressed: dict) -> list:
    """Phase 24; returns the attention kernel's entries of the `kernels`
    line."""
    import torch

    h, d, s = cfg.num_heads, cfg.resolved_head_dim, PROMPT
    flops = causal_attention_flops(BATCH, h, s, d)
    entries = []
    for dtype, name in ((torch.bfloat16, "fa_fwd_bf16_kernel"),
                        (torch.float32, "fa_fwd_f32_kernel")):
        q, k, v = attention_operands(cfg, s, dtype, dev, seed=SEED)
        t = variant_timing(f"[attn-time] {name}", q, k, v, BATCH, flops)
        entry = {
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/attention/csrc/attention.cu",
            "replaces": "src/repro/kernels/attention/kernel.py:33",
            "launches": launches[dtype],
            "launches_by_path": {"serving prefill": launches[dtype]},
            "max_abs_err": max_abs[dtype],
            **{key: t[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by")},
            "operations_bound_of": attention_bounds(q, k, v, flops)[2],
            "library_ms": t["library_ms"],
            "library_max_abs_err": t["library_max_abs_err"],
            "design": DESIGN[name],
        }
        if dtype == torch.float32:
            entry["stressed_max_abs_vs_f64"] = stressed
        entries.append(entry)
        del q, k, v
    return entries


def fan_in_scaled(params, cfg) -> None:
    """Each stacked block weight rescaled in place to the std its unstacked
    def draws, 1 / sqrt(fan_in). The stacked defs keep no fan_in, so
    init_params draws them at 1 / sqrt(repeats): at 4 layers a one-hot
    softmax whose gradients magnify any round-off. The CPU parity tests
    (tests/test_torch_training.py) rescale alike and say how much."""
    import torch

    from repro_torch.models import transformer as T

    def scale(tree, defs):
        for key, d in defs.items():
            if isinstance(d, dict):       # a MoE's shared experts
                scale(tree[key], d)
            else:
                tree[key].mul_(math.sqrt(cfg.repeats / (d.fan_in
                                                        or d.shape[0])))

    with torch.no_grad():
        for i, sub in enumerate(cfg.pattern):
            scale(params["blocks"][f"sub_{i}"], T._sublayer_defs(cfg, sub))


def train_check(cfg, dev) -> None:
    """Phase 25 [train-check]: the attention kernel under autograd against
    its plain version, then loss_fn's gradients through it at full width."""
    import torch

    from repro_torch.kernels.attention import flash_attention_trainable
    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.training import loss_and_grads

    t_phase = time.perf_counter()
    h, kh, d, s = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, PROMPT
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(BATCH, s)

    def plain(q, k, v):
        return L.prefill_attention_plain(cfg, q, k, v, pos)

    def unfold(t, n):
        return t.view(BATCH, n, s, d).transpose(1, 2)

    # The Function at the serving shape: forward against the kernel's plain
    # version, gradients against autograd through the plain step.
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        qf, kf, vf = attention_operands(cfg, s, dtype, dev, seed=SEED + 20 + i)
        d_out = torch.from_numpy(np.random.default_rng(SEED + 30 + i)
                                 .standard_normal((BATCH, s, h, d),
                                                  dtype=np.float32)
                                 ).to(dev, dtype)
        ops = [unfold(t, n).detach().requires_grad_()
               for t, n in ((qf, h), (kf, kh), (vf, kh))]
        out = flash_attention_trainable(*ops, causal=True, plain=plain)
        got = torch.autograd.grad(out, ops, d_out)
        ref = [t.detach().clone().requires_grad_() for t in ops]
        want = torch.autograd.grad(plain(*ref), ref, d_out)
        fwd = fak.flash_attention_bhsd_torch(qf, kf, vf)
        torch.cuda.synchronize()
        out = out.detach().transpose(1, 2).reshape(fwd.shape)
        worst = float((out.float() - fwd.float()).abs().max())
        if dtype == torch.float32:
            ok = f32_excess(out, fwd) <= ATTN_F32_TOL
            bound = f"rtol = atol = {ATTN_F32_TOL:.0e}"
        else:
            ok = worst < ATTN_BF16_MAX_ABS
            bound = f"max abs < {ATTN_BF16_MAX_ABS}"
        equal = [torch.equal(g, w) for g, w in zip(got, want)]
        print(f"[train-check] flash_attention_trainable {dtype}, q "
              f"{tuple(ops[0].shape)}, k/v {tuple(ops[1].shape)}: forward "
              f"max|kernel-plain| {worst:.3e} ({bound}); dq, dk, dv "
              f"bit-equal to autograd through prefill_attention_plain: "
              f"{equal} (max |dq| {float(got[0].abs().max()):.3e})")
        if not ok:
            fail(f"the trainable attention's forward is off its plain "
                 f"version by {worst:.3e} ({dtype})")
        if not all(equal):
            fail(f"the trainable attention's gradients differ from the "
                 f"plain step's ({dtype})")
        del qf, kf, vf, d_out, ops, out, got, ref, want, fwd

    # The raw wrapper refuses operands that require grad.
    qf, kf, vf = attention_operands(cfg, 256, torch.bfloat16, dev, seed=SEED)
    try:
        fak.flash_attention_bhsd(qf.requires_grad_(), kf, vf)
    except RuntimeError as e:
        print(f"[train-check] flash_attention_bhsd on operands that "
              f"require grad raises: {str(e)[:90]}...")
    else:
        fail("flash_attention_bhsd returned a result detached from autograd")

    # loss_fn and its gradients at full width, depth cut.
    cfg_cut = cfg.scaled(num_layers=TRAIN_CHECK_LAYERS)
    params = T.init_params(cfg_cut, seed=SEED, device=dev)
    fan_in_scaled(params, cfg_cut)
    rng = np.random.default_rng(SEED + 40)
    mb = TRAIN_BATCH // TRAIN_MICROBATCHES
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (mb, TRAIN_SEQ)).astype(np.int32)).to(dev)
        for k in ("labels", "tokens")}
    res, ce = {}, {}
    for dt in ("float32", "bfloat16"):
        c = cfg_cut.scaled(dtype=dt)
        ATTN_LAUNCHES.reset()
        res[dt, "kernel"] = loss_and_grads(params, c, batch)
        torch.cuda.synchronize()
        if ATTN_LAUNCHES.n != 2 * TRAIN_CHECK_LAYERS:
            fail(f"{dt} loss_fn launched the attention kernel "
                 f"{ATTN_LAUNCHES.n} times, not {2 * TRAIN_CHECK_LAYERS}")
        ce[dt, "kernel"] = token_ce(params, c, batch)
        launched = ATTN_LAUNCHES.n
        with plain_attention_step(L):
            res[dt, "plain"] = loss_and_grads(params, c, batch)
            ce[dt, "plain"] = token_ce(params, c, batch)
        torch.cuda.synchronize()
        if ATTN_LAUNCHES.n != launched:
            fail("the plain attention step launched the kernel")

    def dist(a, b):
        """(relative loss distance, [(leaf, gradient rel. RMSE)])."""
        (la, ga), (lb, gb) = res[a], res[b]
        return (abs(float(la) - float(lb)) / abs(float(lb)),
                [(k, rel_rmse(x, y)) for (k, x), (_, y)
                 in zip(flat_leaves(ga), flat_leaves(gb))])

    f32_loss, f32_grads = dist(("float32", "kernel"), ("float32", "plain"))
    bk_loss, bk_grads = dist(("bfloat16", "kernel"), ("float32", "plain"))
    bp_loss, bp_grads = dist(("bfloat16", "plain"), ("float32", "plain"))
    bk_ce = rel_rmse(ce["bfloat16", "kernel"], ce["float32", "plain"])
    bp_ce = rel_rmse(ce["bfloat16", "plain"], ce["float32", "plain"])
    worst32 = max(f32_grads, key=lambda kv: kv[1])
    ratio = max(((k, x / y) for (k, x), (_, y) in zip(bk_grads, bp_grads)),
                key=lambda kv: kv[1])
    print(f"[train-check] loss_fn at full width, depth cut to "
          f"{TRAIN_CHECK_LAYERS} of {cfg.num_layers} layers, {mb} x "
          f"{TRAIN_SEQ} tokens, block weights at std 1/sqrt(fan_in): "
          f"kernel launches {2 * TRAIN_CHECK_LAYERS} a pass (remat); loss "
          f"f32 kernel {float(res['float32', 'kernel'][0]):.6f} vs plain "
          f"{float(res['float32', 'plain'][0]):.6f}, bf16 kernel "
          f"{float(res['bfloat16', 'kernel'][0]):.6f} vs plain "
          f"{float(res['bfloat16', 'plain'][0]):.6f}")
    print(f"[train-check] f32 kernel path vs f32 plain path: loss relative "
          f"{f32_loss:.3e}, worst gradient relative RMSE {worst32[1]:.3e} "
          f"({worst32[0]}) (bound {F32_LOGITS_REL:.0e} each)")
    print(f"[train-check] bf16 vs f32 plain, relative: per-token CE RMSE "
          f"kernel path {bk_ce:.3e} (bound 2 x plain path's {bp_ce:.3e}); "
          f"gradients: worst ratio of kernel path to plain path "
          f"{ratio[1]:.3f} ({ratio[0]}; bound 2); the mean loss (not "
          f"gated: one mean of {mb * TRAIN_SEQ} roundings) kernel path "
          f"{bk_loss:.3e}, plain path {bp_loss:.3e}")
    for k, e in f32_grads:
        if not e <= F32_LOGITS_REL:
            fail(f"f32 kernel path's gradient {k} off the plain path by "
                 f"{e:.3e}")
    if not f32_loss <= F32_LOGITS_REL:
        fail(f"f32 kernel path's loss off the plain path by {f32_loss:.3e}")
    for (k, x), (_, y) in zip(bk_grads, bp_grads):
        if not x <= 2 * y:
            fail(f"bf16 kernel path's gradient {k}: {x:.3e} from f32, "
                 f"bound {2 * y:.3e}")
    if not bk_ce <= 2 * bp_ce:
        fail(f"bf16 kernel path's per-token CE {bk_ce:.3e} from f32, bound "
             f"{2 * bp_ce:.3e}")
    print(f"[train-check] {time.perf_counter() - t_phase:.1f} s")


def token_ce(params, cfg, batch):
    """Each token's cross entropy, the terms whose mean is loss_fn's loss,
    computed as loss_fn computes them (without grad: the attention step is
    the kernel's forward, or the plain step inside plain_attention_step)."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    with torch.no_grad():
        x = T.embed_inputs(params, cfg, batch)
        b, s = x.shape[:2]
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        x, _ = T._run_blocks(params, cfg, x, pos, None, remat=False)
        x = L.rmsnorm(params["final_norm"], x, cfg.rms_eps)
        logits = T._logits(params, cfg, x).to(torch.float32)
        labels = batch["labels"].to(torch.int64)[..., None]
        return (torch.logsumexp(logits, dim=-1)
                - torch.gather(logits, -1, labels)[..., 0])


def card_rates(dev) -> None:
    """[launch]'s rates: a bf16 LAUNCH_GEMM_N^3 torch.matmul and a
    LAUNCH_COPY_BYTES device-to-device copy (read and write), CUDA events
    over LAUNCH_RUNS calls, beside the datasheet figures the roofline
    (`launch/roofline.py`) prices with."""
    import torch

    from repro_torch.launch import roofline as R

    n = LAUNCH_GEMM_N
    a = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    b = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    gemm_ms = event_ms(lambda: torch.matmul(a, b), LAUNCH_RUNS)
    del a, b
    src = torch.empty(LAUNCH_COPY_BYTES // 4, device=dev)
    dst = torch.empty_like(src)
    copy_ms = event_ms(lambda: dst.copy_(src), LAUNCH_RUNS)
    del src, dst
    torch.cuda.empty_cache()
    flops = 2 * n ** 3 / (gemm_ms / 1e3)
    rate = 2 * LAUNCH_COPY_BYTES / (copy_ms / 1e3)
    print(f"[launch] bf16 {n}^3 matmul {gemm_ms:.3f} ms = "
          f"{flops / 1e12:.1f} TFLOP/s (datasheet dense bf16 "
          f"{R.PEAK_FLOPS / 1e12:.1f}: {flops / R.PEAK_FLOPS:.1%}); "
          f"{LAUNCH_COPY_BYTES / 2**30:.0f} GiB device copy {copy_ms:.3f} ms "
          f"= {rate / 1e9:.1f} GB/s read + write (datasheet HBM3 "
          f"{R.HBM_BW / 1e9:.0f}: {rate / R.HBM_BW:.1%}); "
          f"{nvidia_smi_line()}")


def start_production_cells(work: str) -> list:
    """Starts each PRODUCTION_CELLS dry run in a subprocess on the host
    (`python -m repro_torch.launch.dryrun ... --out`); returns them for
    `finish_production_cells`. Each is killed at exit if still running."""
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = []
    for i, (name, args) in enumerate(PRODUCTION_CELLS):
        out = os.path.join(work, f"production_{i}.jsonl")
        procs.append((name, out, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", out], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    # a phase that fails before they are joined must not leave them behind
    atexit.register(lambda: [p.kill() for *_, p in procs
                             if p.poll() is None])
    return procs


def finish_production_cells(procs: list) -> None:
    """Waits for the production dry runs (killing any past the deadline)
    and prints each row; a failed cell fails the run."""
    end = time.perf_counter() + PRODUCTION_DEADLINE_S
    for name, out, t0, p in procs:
        try:
            log = p.communicate(timeout=max(1.0, end - time.perf_counter()))[0]
        except subprocess.TimeoutExpired:
            p.kill()
            log = p.communicate()[0] + "\n[killed at the deadline]"
        if p.returncode != 0 or not os.path.exists(out):
            fail(f"[launch] production cell {name} exited {p.returncode}:\n"
                 f"{log[-3000:]}")
        with open(out) as f:
            row = json.loads(f.readlines()[-1])
        print(f"[launch] production cell {name} on {row['mesh']} "
              f"({row['chips']} ranks): dry run {row['trace_s']:.1f} s "
              f"traced, {time.perf_counter() - t0:.1f} s of process beside "
              f"phases 28-34; peak {row['peak_mem_bytes'] / 1e9:.2f} GB a "
              f"rank; flops {row['hlo_flops_per_dev']:.4e}, bytes "
              f"{row['hlo_bytes_per_dev']:.4e}, wire "
              f"{row['wire_bytes_per_dev']:.4e} B a rank "
              f"({row['collectives']['by_group']}); roofline compute "
              f"{row['t_compute_s']:.4f} s, memory {row['t_memory_s']:.4f} "
              f"s, collective {row['t_collective_s']:.4f} s, dominant "
              f"{row['dominant']}, useful ratio {row['useful_ratio']}")
        print(f"[launch] row {json.dumps(row)}")


def launch_phase(cfg, dev, work: str) -> tuple:
    """Phase 27 [launch]; returns (the production cells' processes, the
    attention kernel's launches)."""
    import torch

    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.launch import dryrun as D
    from repro_torch.models import transformer as T
    from repro_torch.training import init_train_state, make_train_step

    entering("[launch]")
    t_phase = time.perf_counter()
    procs = start_production_cells(work)
    card_rates(dev)
    sync = torch.cuda.synchronize
    launches = 0

    def counted(tag, dry, run, want_calls, base):
        """`run()` on the card under the dry run's counter; its peak
        memory above `base`, the memory allocated before its inputs; gated
        against the dry run's row."""
        nonlocal launches
        sync()
        torch.cuda.reset_peak_memory_stats()
        counter = D.TraceCounter()
        ATTN_LAUNCHES.reset()
        with counter:
            run()
        sync()
        peak = torch.cuda.max_memory_allocated() - base
        launches += ATTN_LAUNCHES.n
        calls = dry["kernel_calls"].get("flash_attention", 0)
        print(f"[launch] {tag}: dry run {dry['trace_s']:.1f} s on the host, "
              f"FLOPs {dry['traced_flops_per_dev']} (card "
              f"{counter.flops}), attention operator {calls} calls (card "
              f"{ATTN_LAUNCHES.n} launches, want {want_calls}); peak memory "
              f"predicted {dry['peak_mem_bytes'] / 1e9:.3f} GB, measured "
              f"{peak / 1e9:.3f} GB ({dry['peak_mem_bytes'] / peak - 1:+.1%},"
              f" band +-{LAUNCH_MEM_BAND:.0%}); predicted by kind "
              f"{dry['memory']}")
        if counter.flops != dry["traced_flops_per_dev"]:
            fail(f"[launch] {tag}: the dry run counts "
                 f"{dry['traced_flops_per_dev']} FLOPs, the card's run "
                 f"{counter.flops}")
        if not calls == ATTN_LAUNCHES.n == want_calls:
            fail(f"[launch] {tag}: {calls} operator calls dry, "
                 f"{ATTN_LAUNCHES.n} launches on the card, want {want_calls}")
        if abs(dry["peak_mem_bytes"] / peak - 1) > LAUNCH_MEM_BAND:
            fail(f"[launch] {tag}: predicted peak {dry['peak_mem_bytes']} "
                 f"B, measured {peak} B, past +-{LAUNCH_MEM_BAND:.0%}")

    def timed(tag, dry, run):
        seconds = []
        for _ in range(LAUNCH_TIMED):
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            seconds.append(time.perf_counter() - t0)
        s = min(seconds)
        print(f"[launch] {tag}: {[round(x, 4) for x in seconds]} s on the "
              f"card; roofline bound {dry['t_compute_s']:.4f} s compute, "
              f"{dry['t_memory_s']:.4f} s memory (analytic bytes), dominant "
              f"{dry['dominant']}: the best run takes "
              f"{max(dry['t_compute_s'], dry['t_memory_s']) / s:.1%} of it "
              f"at the bound")

    # the [serve] prefill
    info = dict(kind="prefill", seq=PROMPT, batch=BATCH)
    dry = D.run_cell("qwen2_1_5b", "prefill_32k", False, verbose=False,
                     cfg=cfg, shape_info=info, single=True)
    base = torch.cuda.memory_allocated()
    params = T.init_params(cfg, SEED, dev)
    batch = {"tokens": serving_prompts(cfg, dev)}

    def prefill():
        with torch.no_grad():
            T.prefill(params, cfg, batch)

    tag = f"prefill {BATCH} x {PROMPT}"
    counted(tag, dry, prefill, attention_layers(cfg), base)
    timed(tag, dry, prefill)
    del params, batch
    torch.cuda.empty_cache()

    # one [train] step
    info = dict(kind="train", seq=TRAIN_SEQ, batch=TRAIN_BATCH)
    dry = D.run_cell("qwen2_1_5b", "train_4k", False, verbose=False,
                     cfg=cfg, shape_info=info,
                     microbatches=TRAIN_MICROBATCHES, single=True)
    base = torch.cuda.memory_allocated()
    state = init_train_state(cfg, seed=SEED, device=dev)
    batch = SyntheticTokens(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED,
                            device=dev)(0)
    step = make_train_step(cfg, microbatches=TRAIN_MICROBATCHES,
                           warmup=TRAIN_WARMUP, total_steps=TRAIN_TOTAL,
                           remat=True)

    def train():
        nonlocal state
        state, _ = step(state, batch)

    tag = (f"train step {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICROBATCHES} "
           "micro-batches")
    counted(tag, dry, train, cfg.num_layers * 2 * TRAIN_MICROBATCHES, base)
    timed(tag, dry, train)
    del state, batch, step
    torch.cuda.empty_cache()
    print(f"[launch] {time.perf_counter() - t_phase:.1f} s (the production "
          f"cells go on in the background)")
    return procs, launches


@contextlib.contextmanager
def timed_updates(module, events: list):
    """`module.adamw_update` with CUDA events recorded around each call."""
    import torch

    inner = module.adamw_update

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    module.adamw_update = timed
    try:
        yield
    finally:
        module.adamw_update = inner


def training(cfg, dev) -> dict:
    """Phase 26 [train]: make_train_step on full-width, full-depth
    Qwen2-1.5B. Returns the attention kernel's launches and its time at
    the training shape."""
    import statistics

    import torch

    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.models import transformer as T
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training import train_step as ts

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, seed=SEED, device=dev)
    n_params = T.param_count(state.params)
    data = SyntheticTokens(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=dev)
    step = make_train_step(cfg, microbatches=TRAIN_MICROBATCHES,
                           warmup=TRAIN_WARMUP, total_steps=TRAIN_TOTAL,
                           remat=True)
    per_step = cfg.num_layers * 2 * TRAIN_MICROBATCHES
    tokens = TRAIN_BATCH * TRAIN_SEQ
    count = {"launches": 0, "steps": 0}

    def one(batch):
        nonlocal state
        ATTN_LAUNCHES.reset()
        state, metrics = step(state, batch)
        sync()
        if ATTN_LAUNCHES.n != per_step:
            fail(f"a train step launched the attention kernel "
                 f"{ATTN_LAUNCHES.n} times, not {per_step}")
        count["launches"] += ATTN_LAUNCHES.n
        count["steps"] += 1
        values = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()):
            fail(f"train step {count['steps']}: {values}")
        return values

    print(f"[train] {cfg.name}: {cfg.num_layers} layers, {n_params} "
          f"parameters (f32 weights {n_params * 4 / 1e9:.2f} GB, + 2 "
          f"moments {n_params * 12 / 1e9:.2f} GB); {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens a step in {TRAIN_MICROBATCHES} micro-batches, "
          f"remat, warmup {TRAIN_WARMUP} of {TRAIN_TOTAL}")
    fixed = data(0)
    losses = []
    for _ in range(FIXED_STEPS):
        losses.append(one(fixed)["loss"])
    print(f"[train] {FIXED_STEPS} steps on one batch: losses "
          f"{[round(x, 4) for x in losses]}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall on a fixed batch: {losses}")
    del fixed

    # Where the time goes: the warm-up step on the stream, traced.
    profile(lambda: one(data(FIXED_STEPS)), "bf16 train step", top=14)

    events, seconds, metrics = [], [], []
    with timed_updates(ts, events):
        for i in range(TIMED_STEPS):
            batch = data(FIXED_STEPS + 1 + i)
            sync()
            t0 = time.perf_counter()
            metrics.append(one(batch))
            seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    update_s = [a.elapsed_time(b) / 1e3 for a, b in events]
    step_s = statistics.median(seconds)
    flops = 6 * n_params * tokens
    print(f"[train] {TIMED_STEPS} timed steps on the stream: "
          f"{[round(x, 4) for x in seconds]} s; median {step_s:.4f} s, "
          f"{tokens / step_s:.0f} tokens/s; 6 N tokens / step "
          f"{flops / step_s / 1e12:.1f} TFLOP/s = "
          f"{flops / step_s / PEAK_BF16_OPS_PER_S:.1%} of the dense bf16 "
          f"peak (989 TFLOP/s; a share of peak, not a benchmark's MFU); "
          f"AdamW update alone (CUDA events) median "
          f"{statistics.median(update_s):.4f} s "
          f"({[round(x, 4) for x in update_s]}); peak device memory "
          f"{peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB) over every step")
    print(f"[train] stream losses {[round(m['loss'], 4) for m in metrics]}, "
          f"grad norms {[round(m['grad_norm'], 3) for m in metrics]}, "
          f"lr_scale {[round(m['lr_scale'], 4) for m in metrics]}")

    taken = count["steps"]
    if int(state.opt.step) != taken:
        fail(f"opt.step {int(state.opt.step)} after {taken} steps")
    init = T.init_params(cfg, seed=SEED, device=dev)
    for (key, p), (_, p0) in zip(flat_leaves(state.params),
                                 flat_leaves(init)):
        if not bool(torch.isfinite(p).all()) or torch.equal(p, p0):
            fail(f"after {taken} steps {key} is not finite or did not move")
    del init, state
    print(f"[train] {taken} steps, opt.step {taken}; params finite and "
          f"moved; attention-kernel launches {count['launches']} "
          f"({per_step} a step = {cfg.num_layers} layers x 2 (remat) x "
          f"{TRAIN_MICROBATCHES} micro-batches)")

    # The kernel at the training shape: one micro-batch's layer.
    torch.cuda.empty_cache()
    mb = TRAIN_BATCH // TRAIN_MICROBATCHES
    h, d = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = attention_operands(cfg, TRAIN_SEQ, torch.bfloat16, dev,
                                 seed=SEED, batch=mb)
    ms = event_ms(lambda: fak.flash_attention_bhsd(q, k, v), ATTN_RUNS)
    bound_ms = max(attention_bounds(
        q, k, v, causal_attention_flops(mb, h, TRAIN_SEQ, d))[:2])
    print(f"[train] fa_fwd_bf16_kernel at the training shape "
          f"{tuple(q.shape)} q, {tuple(k.shape)} k/v: {ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_ms / ms:.2%} of bound)")
    print(f"[train] {time.perf_counter() - t_phase:.1f} s")
    return {"launches": count["launches"], "train_shape_ms": ms,
            "train_shape_bound_ms": bound_ms}


@contextlib.contextmanager
def recorded_routing():
    """Each MoE layer's Routing (the router's own outputs) while the block
    runs, in call order; the routing itself is unchanged."""
    from repro_torch.models import moe as M

    inner, calls = M.route, []

    def route(params, cfg, x):
        r = inner(params, cfg, x)
        calls.append(r)
        return r

    M.route = route
    try:
        yield calls
    finally:
        M.route = inner


def entering(tag: str) -> None:
    """The previous phase's tensors are freed: say what is left."""
    import torch

    torch.cuda.empty_cache()
    print(f"{tag} device memory allocated on entry: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")


def init_on_card(tag: str, cfg, dev, what: str):
    """init_params(seed 0) with the peak device memory of the draw."""
    import torch

    from repro_torch.models import config as C
    from repro_torch.models import transformer as T

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n = T.param_count(params)
    if n != C.count_params(cfg):
        fail(f"{tag} {n} parameters, count_params says {C.count_params(cfg)}")
    print(f"{tag} {cfg.name} {what}: {n} parameters ({cfg.param_dtype}, "
          f"{n * 4 / 1e9:.2f} GB; active per token "
          f"{C.count_active_params(cfg)}), drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s, peak device memory during the "
          f"draw {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return params


def no_drop(cfg):
    """A copy whose capacity holds every token: c >= S for any S once the
    factor is at least E / k, since an expert takes at most one choice a
    token."""
    m = cfg.moe
    return cfg.scaled(moe=dataclasses.replace(
        m, capacity_factor=max(m.capacity_factor, m.num_experts / m.top_k)))


def moe_serve(cfg, dev) -> dict:
    """Phase 28 [moe-serve] and [moe-check]; returns the attention
    kernel's launches by path and dtype."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    entering("[moe-serve]")
    m = cfg.moe
    params = init_on_card(
        "[moe-serve]", cfg, dev,
        f"({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, {m.num_experts} experts top-{m.top_k} "
        f"of {m.d_ff_expert}, {m.num_shared_experts} shared, capacity "
        f"factor {m.capacity_factor:g}, vocab {cfg.vocab_size})")
    tokens = serving_prompts(cfg, dev)
    prompt = {"tokens": tokens}
    run = generate("[moe-serve]", cfg, params, prompt)
    with recorded_routing() as calls:
        T.prefill(params, cfg, prompt)
    kept = [float(r.keep.float().mean()) for r in calls]
    c = M.capacity(cfg, PROMPT)
    print(f"[moe-serve] capacity {c} slots per expert and row; (token, "
          f"choice) pairs dropped in the prefill, from the router's "
          f"outputs: {1 - sum(kept) / len(kept):.4%} over {len(kept)} MoE "
          f"layers (per layer {1 - max(kept):.4%} to {1 - min(kept):.4%})")
    del calls
    profile(lambda: T.prefill(params, cfg, prompt), "moe bf16 prefill",
            top=14)
    nxt = run["logits"].argmax(-1)[:, None]
    full = T.extend_cache(cfg, run["cache"], PROMPT + 1)
    profile(lambda: T.decode_step(params, cfg, full, nxt, PROMPT),
            "moe bf16 decode_step", top=8)
    mha_timing(cfg, dev)
    launches = run["launches"]
    del params, run, full
    print(f"[moe-serve] {time.perf_counter() - t_phase:.1f} s")

    # The kernel-vs-plain and decode-vs-prefill checks at full width and
    # MOE_CHECK_LAYERS layers, block weights at 1 / sqrt(fan_in).
    t_phase = time.perf_counter()
    entering("[moe-check]")
    cut = cfg.scaled(num_layers=MOE_CHECK_LAYERS)
    params = init_on_card("[moe-check]", cut, dev,
                          f"at full width, {MOE_CHECK_LAYERS} layers")
    fan_in_scaled(params, cut)
    for dt in ("bfloat16", "float32"):
        c = cut.scaled(dtype=dt)
        with recorded_routing() as kernel_path:
            T.prefill(params, c, prompt)
        with recorded_routing() as plain_path, plain_attention_step(L):
            T.prefill(params, c, prompt)
        differ = [float((k.gate_idx.sort(-1).values
                         != p.gate_idx.sort(-1).values).any(-1)
                        .float().mean())
                  for k, p in zip(kernel_path, plain_path)]
        print(f"[moe-check] {dt} routing, kernel path vs plain attention "
              f"step: share of tokens whose top-{m.top_k} set differs, "
              f"per MoE layer: {[f'{x:.4%}' for x in differ]}")
        del kernel_path, plain_path
    logits_k, cache = T.prefill(params, cut, prompt)
    nd = no_drop(cut)
    print(f"[moe-check] decode vs prefill on a copy at capacity factor "
          f"{nd.moe.capacity_factor:g} (>= E / k): capacity "
          f"{M.capacity(nd, PROMPT + 1)} slots >= {PROMPT + 1} tokens, so "
          f"nothing drops; at the published factor a prefill (which may "
          f"drop) and decode (capacity {M.capacity(cut, 1)} a step, never "
          f"dropping) are different computations")
    f32 = logit_checks(cut, params, prompt, logits_k, cache, "[moe-check]",
                       decode_cfg=nd)
    print(f"[moe-check] {time.perf_counter() - t_phase:.1f} s")
    return {"bf16": launches, "f32": f32}


def mha_timing(cfg, dev) -> None:
    """Both attention kernels at the MoE prefill's shape, group 1 (MHA),
    beside their bounds."""
    import torch

    from repro_torch.kernels.attention import kernel as fak

    h, d = cfg.num_heads, cfg.resolved_head_dim
    flops = causal_attention_flops(BATCH, h, PROMPT, d)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = attention_operands(cfg, PROMPT, dtype, dev, seed=SEED)
        ms = event_ms(lambda: fak.flash_attention_bhsd(q, k, v), ATTN_RUNS)
        bytes_ms, ops_ms, _ = attention_bounds(q, k, v, flops)
        bound_ms = max(bytes_ms, ops_ms)
        print(f"[moe-serve] attention kernel {dtype} at {tuple(q.shape)} q, "
              f"{tuple(k.shape)} k/v (group 1): {ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_ms / ms:.2%} of bound)")
        del q, k, v


def ssm_serve(cfg, dev) -> int:
    """Phase 29 [ssm-serve]: Mamba-2 at full width and depth."""
    import torch

    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    entering("[ssm-serve]")
    s = cfg.ssm
    params = init_on_card(
        "[ssm-serve]", cfg, dev,
        f"({cfg.num_layers} layers, d_model {cfg.d_model}, SSD d_state "
        f"{s.d_state}, head_dim {s.head_dim}, expand {s.expand}, chunk "
        f"{s.chunk}, vocab {cfg.vocab_size}, attention-free: "
        f"{cfg.attention_free})")
    tokens = serving_prompts(cfg, dev)
    prompt = {"tokens": tokens}
    run = generate("[ssm-serve]", cfg, params, prompt)
    profile(lambda: T.prefill(params, cfg, prompt), "ssm bf16 prefill",
            top=10)

    # Decode continues the prefill, in f32.
    c32 = cfg.scaled(dtype="float32")
    logits, cache = T.prefill(params, c32, prompt)
    nxt = logits.argmax(-1)[:, None]
    full = T.extend_cache(c32, cache, PROMPT + 1)
    dec, _ = T.decode_step(params, c32, full, nxt, PROMPT)
    ref, _ = T.prefill(params, c32, {"tokens": torch.cat([tokens, nxt], 1)})
    err = (dec - ref).abs()
    bound = SSM_RTOL * ref.abs() + SSM_ATOL * float(ref.abs().max())
    worst = float((err - bound).max())
    print(f"[ssm-serve] f32 decode_step at {PROMPT} vs prefill over "
          f"{PROMPT + 1} tokens: max |decode - prefill| {float(err.max()):.3e}"
          f" of max |logit| {float(ref.abs().max()):.3e}; bound rtol "
          f"{SSM_RTOL:g} + atol {SSM_ATOL:g} x max (the reference's SSM "
          f"tolerance): {'held' if worst <= 0 else 'exceeded'}; argmax "
          f"agrees for {int((dec.argmax(-1) == ref.argmax(-1)).sum())}/"
          f"{BATCH}")
    if worst > 0:
        fail("[ssm-serve] decode does not continue the prefill")
    print(f"[ssm-serve] {time.perf_counter() - t_phase:.1f} s")
    return run["launches"]


def hybrid_config(base):
    """Jamba-1.5-Large's pattern on one card: one repeat, d_ff and
    d_ff_expert cut to HYBRID_D_FF, every other width as published."""
    return base.scaled(num_layers=len(base.pattern), d_ff=HYBRID_D_FF,
                       moe=dataclasses.replace(base.moe,
                                               d_ff_expert=HYBRID_D_FF))


def hybrid(base, dev) -> dict:
    """Phase 30 [hybrid]: Jamba-1.5-Large's pattern at the listed cuts;
    returns the attention kernel's launches by dtype."""
    import torch

    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    entering("[hybrid]")
    cfg = hybrid_config(base)
    m, s = cfg.moe, cfg.ssm
    kinds = "".join("A" if x.kind == "attn" else "S" for x in cfg.pattern)
    ffns = "".join({"moe": "E", "mlp": "M", "none": "-"}[x.ffn]
                   for x in cfg.pattern)
    params = init_on_card(
        "[hybrid]", cfg, dev,
        f"kept as published: one repeat of the {len(cfg.pattern)}-sub-layer "
        f"pattern (mixers {kinds}, FFNs {ffns}), d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, {m.num_experts} experts top-{m.top_k}, "
        f"SSD d_state {s.d_state} head_dim {s.head_dim} expand {s.expand} "
        f"chunk {s.chunk}, vocab {cfg.vocab_size}; cut: {base.num_layers} "
        f"-> {cfg.num_layers} layers, d_ff {base.d_ff} -> {cfg.d_ff}, "
        f"d_ff_expert {base.moe.d_ff_expert} -> {m.d_ff_expert} (the "
        f"published FFN widths do not fit one card; no other width cut)")
    tokens = serving_prompts(cfg, dev)
    prompt = {"tokens": tokens}
    run = generate("[hybrid]", cfg, params, prompt)
    profile(lambda: T.prefill(params, cfg, prompt), "hybrid bf16 prefill",
            top=12)
    # The checks on the same weights at 1 / sqrt(fan_in): one repeat draws
    # every stacked block weight at std 1 (a one-hot softmax).
    del run["cache"]
    fan_in_scaled(params, cfg)
    print("[hybrid] checks below on the same weights rescaled to std "
          "1 / sqrt(fan_in)")
    torch.cuda.reset_peak_memory_stats()
    logits_k, cache = T.prefill(params, cfg, prompt)
    f32 = logit_checks(cfg, params, prompt, logits_k, cache, "[hybrid]",
                       decode_cfg=no_drop(cfg))
    print(f"[hybrid] peak device memory over the checks (f32 prefills at "
          f"the no-drop capacity): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"[hybrid] {time.perf_counter() - t_phase:.1f} s")
    return {"bf16": run["launches"], "f32": f32}


def windowed_flops(bh: int, s: int, d: int, window: int) -> float:
    """Query i meets keys max(0, i - W + 1)..i: 4 D min(i + 1, W) operations
    per row, over BH folded rows."""
    w = min(window, s)
    return 4.0 * d * (w * (w + 1) // 2 + (s - w) * w) * bh


def variant_timing(tag: str, q, k, v, batch: int, flops: float,
                   window=None) -> dict:
    """The attention kernel (CUDA events, ATTN_RUNS launches), its plain
    version and torch's scaled_dot_product_attention (the library
    yardstick: causal, or with the window as a boolean mask; KV heads
    repeated to the query heads outside the timed calls) on folded q
    (B*H, S, D), k, v (B*K, S, D), beside the bound (for f32 also the
    f32 cores' time for the same operations)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel as fak

    bh, s, d = q.shape
    h, kh = bh // batch, k.shape[0] // batch
    ms = event_ms(lambda: fak.flash_attention_bhsd(q, k, v, window=window),
                  ATTN_RUNS)
    plain = lambda: fak.flash_attention_bhsd_torch(q, k, v, window=window)
    plain_ms = event_ms(plain, PLAIN_RUNS)
    q4 = q.view(batch, h, s, d)
    k4 = k.view(batch, kh, s, d).repeat_interleave(h // kh, dim=1)
    v4 = v.view(batch, kh, s, d).repeat_interleave(h // kh, dim=1)
    if window is None:
        sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=True)
    else:
        i = torch.arange(s, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                      attn_mask=mask)
    lib_ms = event_ms(sdpa, ATTN_RUNS)
    lib_err = float((sdpa().reshape(q.shape).float() - plain().float())
                    .abs().max())
    bytes_ms, ops_ms, ops_of = attention_bounds(q, k, v, flops)
    bound_ms = max(bytes_ms, ops_ms)
    also = ("" if q.dtype == torch.bfloat16 else "; on the f32 cores "
            f"{flops / PEAK_F32_OPS_PER_S * 1e3:.4f} ms")
    label = (f"{tuple(q.shape)} q, {tuple(k.shape)} k/v, {q.dtype}"
             + (f", window {window}" if window else ", causal"))
    print(f"{tag} {label}: kernel {ms:.3f} ms ({flops / ms / 1e9:.2f} "
          f"TFLOP/s), bound {bound_ms:.4f} ms (operations {ops_ms:.4f} ms, "
          f"{ops_of}; bytes {bytes_ms:.4f} ms{also}), {bound_ms / ms:.2%} of "
          f"bound; plain {plain_ms:.3f} ms; scaled_dot_product_attention "
          f"{lib_ms:.3f} ms, max|sdpa-plain| {lib_err:.3e}")
    return {"shape": label, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms, "library_max_abs_err": lib_err}


def kernel_vs_plain(tag: str, q, k, v, causal: bool = True,
                    window=None) -> float:
    """The kernel against its plain version at the phase-22 bounds; returns
    max |kernel - plain|."""
    import torch

    from repro_torch.kernels.attention import kernel as fak

    got = fak.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    want = fak.flash_attention_bhsd_torch(q, k, v, causal=causal,
                                          window=window)
    torch.cuda.synchronize()
    worst = float((got.float() - want.float()).abs().max())
    if q.dtype == torch.float32:
        ok = f32_excess(got, want) <= ATTN_F32_TOL
        bound = f"rtol = atol = {ATTN_F32_TOL:.0e}"
    else:
        ok = worst < ATTN_BF16_MAX_ABS
        bound = f"max abs < {ATTN_BF16_MAX_ABS}"
    mask = (f"window {window}" if window else
            "causal" if causal else "non-causal")
    label = f"{tuple(q.shape)} q, {tuple(k.shape)} k/v, {q.dtype}, {mask}"
    print(f"{tag} {label}: max|kernel-plain| {worst:.3e} ({bound})")
    if not ok:
        fail(f"{tag} attention kernel disagrees with its plain version: "
             f"{label}: max abs {worst:.3e}")
    return worst


def group7_timing(cfg, dev) -> dict:
    """The kernel at DeepSeek-Coder-33B's group 7 (56 heads over 8), the
    serving batch and prompt, beside its bound (checked in phase 22)."""
    import torch

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = attention_operands(cfg, PROMPT, dtype, dev, seed=SEED)
        out[dtype] = variant_timing(
            "[attn-time] group 7", q, k, v, BATCH,
            causal_attention_flops(BATCH, cfg.num_heads, PROMPT,
                                   cfg.resolved_head_dim))
        del q, k, v
    return out


def window_vs_f64(q, k, v, window: int) -> None:
    """The windowed kernel and its plain version against the f64 function.
    f32: the kernel within rtol = atol = ATTN_F32_TOL. bf16:
    `within_plain_rounding`, the kernel's max error and relative RMSE
    within twice the plain version's. A key missed or let in at the
    window's lower edge moves the rows it touches far past that, where
    ATTN_BF16_MAX_ABS is about a typical output at Mixtral's window."""
    import torch

    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.kernels.attention.ref import (attention_f64,
                                                   f64_distances,
                                                   within_plain_rounding)

    got = fak.flash_attention_bhsd(q, k, v, window=window)
    plain = fak.flash_attention_bhsd_torch(q, k, v, window=window)
    exact = attention_f64(q, k, v, window=window)
    torch.cuda.synchronize()
    (d_k, r_k), (d_p, r_p) = (f64_distances(got, exact),
                              f64_distances(plain, exact))
    label = (f"{tuple(q.shape)} q, {tuple(k.shape)} k/v, {q.dtype}, "
             f"window {window}")
    if q.dtype == torch.float32:
        ok = f32_excess(got, exact) <= ATTN_F32_TOL
        bound = f"kernel: rtol = atol = {ATTN_F32_TOL:.0e}"
    else:
        ok = within_plain_rounding(got, plain, exact)
        bound = (f"kernel within 2 x plain in both: max {2 * d_p:.3e}, "
                 f"relative RMSE {2 * r_p:.3e}")
    print(f"[window-check] {label} against the f64 function: max|kernel-"
          f"f64| {d_k:.3e}, max|plain-f64| {d_p:.3e}; relative RMSE kernel "
          f"{r_k:.3e}, plain {r_p:.3e} ({bound}); outputs: RMS "
          f"{float(exact.pow(2).mean().sqrt()):.3e}, max "
          f"{float(exact.abs().max()):.3e}")
    if not ok:
        fail(f"[window-check] windowed kernel off the f64 function: {label}: "
             f"max abs {d_k:.3e} (plain {d_p:.3e}), relative RMSE {r_k:.3e} "
             f"(plain {r_p:.3e})")


def window_check(cfg, dev) -> tuple:
    """[window-check]: the windowed kernel against its plain version and
    the f64 function (`window_vs_f64`) at Mixtral's attention shape and at
    WINDOW_EDGE, both dtypes; then its times. Returns the max |kernel -
    plain| per dtype and the times per dtype."""
    import torch

    t_phase = time.perf_counter()
    entering("[window-check]")
    w = cfg.sliding_window
    max_abs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(WINDOW_SEQ, w, torch.float32), (WINDOW_SEQ, w, torch.bfloat16),
             (*WINDOW_EDGE, torch.float32), (*WINDOW_EDGE, torch.bfloat16)]
    for i, (s, win, dtype) in enumerate(cases):
        q, k, v = attention_operands(cfg, s, dtype, dev, seed=SEED + i,
                                     batch=1)
        worst = kernel_vs_plain("[window-check]", q, k, v, window=win)
        max_abs[dtype] = max(max_abs[dtype], worst)
        window_vs_f64(q, k, v, win)
        del q, k, v
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = attention_operands(cfg, WINDOW_SEQ, dtype, dev, seed=SEED,
                                     batch=1)
        times[dtype] = variant_timing(
            "[window-check]", q, k, v, 1,
            windowed_flops(q.shape[0], WINDOW_SEQ, q.shape[2], w), window=w)
        del q, k, v
    print(f"[window-check] {time.perf_counter() - t_phase:.1f} s")
    return max_abs, times


def token_prompt(cfg, dev, b: int, s: int) -> dict:
    """{tokens: (b, s) ids from numpy}."""
    import torch

    rng = np.random.default_rng(SEED)
    return {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s))).to(dev)}


def mixtral(base, dev) -> dict:
    """[mixtral] and [mixtral-check]: Mixtral-8x7B at every published width
    with its depth cut; returns the attention kernel's launches by path."""
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    entering("[mixtral]")
    cfg = base.scaled(num_layers=MIXTRAL_LAYERS)
    m, w = cfg.moe, cfg.sliding_window
    params = init_on_card(
        "[mixtral]", cfg, dev,
        f"kept as published: d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, "
        f"{m.num_experts} experts top-{m.top_k} of {m.d_ff_expert}, "
        f"capacity factor {m.capacity_factor:g}, window {w}, vocab "
        f"{cfg.vocab_size}; cut: {base.num_layers} -> {cfg.num_layers} "
        f"layers (the published depth is 186.8 GB of f32 weights)")
    prompts = {"causal": (BATCH, PROMPT), "windowed": (1, WINDOW_SEQ)}
    runs = {}
    for name, (b, s) in prompts.items():
        prompt = token_prompt(cfg, dev, b, s)
        s_alloc = T.cache_alloc_len(cfg, s + STEPS)
        print(f"[mixtral] {b} x {s} tokens: S {'>' if s > w else '<='} window "
              f"{w}, so the {'windowed' if s > w else 'causal'} kernel; a "
              f"decode cache of {s_alloc} slots"
              + (" (a ring that decode wraps)" if s_alloc < s + STEPS
                 else ""))
        run = generate("[mixtral]", cfg, params, prompt, s_max=s + STEPS)
        with recorded_routing() as calls:
            T.prefill(params, cfg, prompt)
        kept = [float(r.keep.float().mean()) for r in calls]
        print(f"[mixtral] {b} x {s}: (token, choice) pairs dropped in the "
              f"prefill, from the router's outputs: "
              f"{1 - sum(kept) / len(kept):.4%} over {len(kept)} MoE layers "
              f"(per layer {1 - max(kept):.4%} to {1 - min(kept):.4%})")
        del calls
        if s > w:
            profile(lambda: T.prefill(params, cfg, prompt),
                    f"mixtral bf16 prefill, {b} x {s} (windowed)", top=12)
        runs[name] = {k: run[k] for k in ("launches", "window_launches")}
        del run, prompt
    del params
    print(f"[mixtral] {time.perf_counter() - t_phase:.1f} s")

    # Kernel path vs plain step and decode vs prefill, at full width and
    # MIXTRAL_CHECK_LAYERS layers, block weights at 1 / sqrt(fan_in).
    t_phase = time.perf_counter()
    entering("[mixtral-check]")
    cut = base.scaled(num_layers=MIXTRAL_CHECK_LAYERS)
    params = init_on_card("[mixtral-check]", cut, dev,
                          f"at full width, {MIXTRAL_CHECK_LAYERS} layers")
    fan_in_scaled(params, cut)
    nd = no_drop(cut)
    f32 = {}
    for name, (b, s) in prompts.items():
        prompt = token_prompt(nd, dev, b, s)
        logits_k, cache = T.prefill(params, nd, prompt)
        print(f"[mixtral-check] {b} x {s} tokens, every check on a copy at "
              f"capacity factor {nd.moe.capacity_factor:g} (>= E / k, "
              f"nothing drops)")
        f32[name] = logit_checks(nd, params, prompt, logits_k, cache,
                                 "[mixtral-check]")
        del logits_k, cache, prompt
    del params
    print(f"[mixtral-check] {time.perf_counter() - t_phase:.1f} s")
    return {"bf16": runs, "f32": f32}


def fan_in_checks(tag: str, cfg, params, prompt, run: dict) -> int:
    """Phase 23's logit checks on the served weights rescaled in place to
    1 / sqrt(fan_in), as [hybrid] runs them: at the stacked init's
    1 / sqrt(repeats) every layer's softmax is near one-hot, and a deep
    stack of them turns f32 summation order into O(1) logit differences.
    Drops `run`'s logits and cache first. At the stacked init it prints
    (not gated) the f32 kernel path's and the f32 plain path's distances
    from each other and from the f32 model whose attention step is
    evaluated in f64 (`f64_attention_step`): the witness that either
    order of f32 sums lands that far from the exact step. Returns the f32
    launches."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    run.pop("logits")
    run.pop("cache")
    cfg32 = cfg.scaled(dtype="float32")
    kernel_32, _ = T.prefill(params, cfg32, prompt)
    with plain_attention_step(L):
        plain_32, _ = T.prefill(params, cfg32, prompt)
    with f64_attention_step(L):
        exact_32, _ = T.prefill(params, cfg32, prompt)
    print(f"{tag} at the stacked init (block weights at std 1 / sqrt("
          f"{cfg.repeats})), not gated, relative RMSE of the last-position "
          f"logits: f32 kernel path vs f32 plain path "
          f"{rel_rmse(kernel_32, plain_32):.3e}; vs the f32 model with its "
          f"attention step in f64: kernel path "
          f"{rel_rmse(kernel_32, exact_32):.3e}, plain path "
          f"{rel_rmse(plain_32, exact_32):.3e}")
    del kernel_32, plain_32, exact_32
    fan_in_scaled(params, cfg)
    print(f"{tag} checks below on the same weights rescaled to std "
          f"1 / sqrt(fan_in)")
    logits_k, cache = T.prefill(params, cfg, prompt)
    return logit_checks(cfg, params, prompt, logits_k, cache, tag)


def musicgen(cfg, dev) -> dict:
    """[musicgen]: MusicGen-Large at full width and depth; the kernel's
    DP = 64 instantiation at its shape. Returns the launches and times."""
    import torch

    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    entering("[musicgen]")
    n_cb = cfg.frontend.num_positions
    params = init_on_card(
        "[musicgen]", cfg, dev,
        f"at full width and depth: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, {cfg.mlp_type} d_ff {cfg.d_ff}, {n_cb} "
        f"codebooks of {cfg.vocab_size}")
    rng = np.random.default_rng(SEED)
    prompt = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (BATCH, n_cb, PROMPT))).to(dev)}
    run = generate("[musicgen]", cfg, params, prompt)
    profile(lambda: T.prefill(params, cfg, prompt), "musicgen bf16 prefill",
            top=10)
    dp64 = {}
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        q, k, v = attention_operands(cfg, PROMPT, dtype, dev, seed=SEED + i)
        worst = kernel_vs_plain("[musicgen] DP = 64:", q, k, v)
        dp64[dtype] = dict(variant_timing(
            "[musicgen] DP = 64:", q, k, v, BATCH,
            causal_attention_flops(BATCH, cfg.num_heads, PROMPT,
                                   cfg.resolved_head_dim)),
            max_abs_err=worst)
        del q, k, v
    dp64[torch.float32]["stressed_max_abs_vs_f64"] = stressed_check(
        "[musicgen] DP = 64:", cfg, dev, SEED + 2)
    launches = run["launches"]
    f32 = fan_in_checks("[musicgen]", cfg, params, prompt, run)
    del params
    print(f"[musicgen] {time.perf_counter() - t_phase:.1f} s")
    return {"bf16": launches, "f32": f32, "dp64": dp64}


def vlm(base, dev) -> dict:
    """[vlm]: InternVL2-26B at every published width with its depth cut,
    256 image positions before 1792 text tokens; decode vs a full prefill
    at position 256 + 1792. Returns the launches."""
    import torch

    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    entering("[vlm]")
    cfg = base.scaled(num_layers=VLM_LAYERS)
    fe = cfg.frontend
    params = init_on_card(
        "[vlm]", cfg, dev,
        f"kept as published: d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, projector {fe.d_frontend} -> "
        f"{cfg.d_model}, {fe.num_positions} image positions; cut: "
        f"{base.num_layers} -> {cfg.num_layers} layers")
    prompt = token_prompt(cfg, dev, BATCH, PROMPT - fe.num_positions)
    prompt["patch_embeds"] = torch.from_numpy(
        np.random.default_rng(SEED + 1).standard_normal(
            (BATCH, fe.num_positions, fe.d_frontend), dtype=np.float32)
    ).to(dev)
    run = generate("[vlm]", cfg, params, prompt)
    profile(lambda: T.prefill(params, cfg, prompt), "vlm bf16 prefill",
            top=8)
    launches = run["launches"]
    # On the served weights bf16 rounding alone moves the logits far (the
    # stacked init's near-one-hot softmax), which leaves the bf16 bounds
    # loose there: the checks run again on fan-in-rescaled weights.
    f32 = logit_checks(cfg, params, prompt, run["logits"], run["cache"],
                       "[vlm]")
    fan_in_checks("[vlm]", cfg, params, prompt, run)
    del params
    print(f"[vlm] {time.perf_counter() - t_phase:.1f} s")
    return {"bf16": launches, "f32": f32}


# ---------------------------------------------------------------------------
# 34. [lm-mesh]: the sharded LM substrate on four ranks sharing the card
# ---------------------------------------------------------------------------

def two_groups():
    """Sharding rules on a shape-only (data 1, model 2) mesh: tp_size() 2
    (the MoE's grouped dispatch), identity constraints on plain tensors."""
    from repro_torch.parallel.sharding import AbstractMesh, ShardingRules

    return ShardingRules(mesh=AbstractMesh((1, 2), ("data", "model")))


def lm_mesh_models(cfg, moe_cfg) -> tuple:
    """(name, config, oracle rules) of the phase's two served models."""
    return (("qwen2", cfg, None),
            ("moe", moe_cfg.scaled(num_layers=LM_MESH_MOE_LAYERS),
             two_groups()))


def train_batch(cfg, dev) -> dict:
    import torch

    rng = np.random.default_rng(SEED + 2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to(dev)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}


def dp_rows(t, rules):
    """This rank's dp rows of the whole batch entry `t`, cut locally and
    laid out as the rules lay a batch out (a DTensor)."""
    from repro_torch.parallel.sharding import shard_tensor

    return shard_tensor(t, rules.sharding_for_shape(
        t.shape, "dp", *(None,) * (t.ndim - 1)), t.device)


def local_bytes(tree) -> int:
    """The bytes of this rank's parts of every tensor leaf of `tree`."""
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


def serve_path(cfg, params, prompt, forced, rules, dev) -> dict:
    """The serving traffic of [lm-mesh], on one process or on each rank:
    the f32 copy's prefill (kernel launches, logits, the MoE's drops per
    layer) and its decode teacher-forced on `forced`; greedy_generate in
    bf16 (launches, ids, seconds) and a timed bf16 prefill, with its peak
    memory above what was allocated before it (`prefill_extra`, bytes).
    Every tensor returned is whole (gathered) and on the host."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import full
    from repro_torch.serving import greedy_generate

    sync = torch.cuda.synchronize
    f32 = cfg.scaled(dtype="float32")
    mesh = getattr(rules, "mesh", None)
    sharded = mesh is not None and hasattr(mesh, "get_group")
    barrier = dist.barrier if sharded else (lambda: None)
    out = {}
    barrier()
    ATTN_LAUNCHES.reset()
    t0 = time.perf_counter()
    with recorded_routing() as calls:
        logits, cache = T.prefill(params, f32, prompt, rules)
        sync()
    out["f32_prefill_s"] = time.perf_counter() - t0
    out["f32_launches"] = ATTN_LAUNCHES.n
    drops = torch.tensor([float((~r.keep).sum()) for r in calls],
                         device=dev)
    kept = torch.tensor([float(r.keep.numel()) for r in calls], device=dev)
    if sharded and calls:   # each rank routed its own token groups
        dist.all_reduce(drops)
        dist.all_reduce(kept)
    out["drops"] = drops.cpu()
    out["choices"] = kept.cpu()
    out["prefill32"] = full(logits).float().cpu()
    cache = T.extend_cache(f32, cache, PROMPT + LM_MESH_STEPS)
    steps = []
    for t in range(LM_MESH_STEPS):
        logits, cache = T.decode_step(params, f32, cache, forced[:, t:t + 1],
                                      PROMPT + t, rules)
        steps.append(full(logits).float().cpu())
    out["decode32"] = torch.stack(steps)
    del cache, logits
    torch.cuda.empty_cache()
    barrier()
    ATTN_LAUNCHES.reset()
    t0 = time.perf_counter()
    ids = greedy_generate(cfg, params, prompt, LM_MESH_STEPS,
                          PROMPT + LM_MESH_STEPS, rules)
    sync()
    out["greedy_s"] = time.perf_counter() - t0
    out["bf16_launches"] = ATTN_LAUNCHES.n
    out["ids"] = ids.cpu()
    barrier()
    sync()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, _ = T.prefill(params, cfg, prompt, rules)
    sync()
    out["bf16_prefill_s"] = time.perf_counter() - t0
    out["prefill_max"] = torch.cuda.max_memory_allocated()
    out["prefill_extra"] = out["prefill_max"] - before
    out["prefill16"] = full(logits).float().cpu()
    return out


def lm_mesh_oracles(cfg, moe_cfg, dev, out_dir: str) -> dict:
    """The unsharded oracles of [lm-mesh], saved under `out_dir` for the
    ranks: per model serve_path() plus the plain step's bf16 prefill
    logits, and the f32 train step's metrics and updated leaves."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import _leaves
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)

    prompt = {"tokens": serving_prompts(cfg, dev)}
    forced = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (BATCH, LM_MESH_STEPS))).to(dev)
    torch.save(forced.cpu(), os.path.join(out_dir, "forced.pt"))
    seconds = {}
    for name, mcfg, rules in lm_mesh_models(cfg, moe_cfg):
        t0 = time.perf_counter()
        params = T.init_params(mcfg, SEED, dev)
        oracle = serve_path(mcfg, params, prompt, forced, rules, dev)
        with plain_attention_step(L):
            oracle["plain16"] = T.prefill(params, mcfg, prompt,
                                          rules)[0].float().cpu()
        fan_in_scaled(params, mcfg)
        oracle["fan32"] = T.prefill(params, mcfg.scaled(dtype="float32"),
                                    prompt, rules)[0].float().cpu()
        oracle["fan16"] = T.prefill(params, mcfg, prompt,
                                    rules)[0].float().cpu()
        with plain_attention_step(L):
            oracle["fan_plain16"] = T.prefill(params, mcfg, prompt,
                                              rules)[0].float().cpu()
        torch.save(oracle, os.path.join(out_dir, f"{name}.pt"))
        seconds[name] = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
    tcfg = cfg.scaled(num_layers=LM_MESH_TRAIN_LAYERS, dtype="float32")
    batch = train_batch(tcfg, dev)
    for init in LM_MESH_TRAIN_INITS:
        t0 = time.perf_counter()
        state = init_train_state(tcfg, SEED, dev)
        if init == "fan_in":
            fan_in_scaled(state.params, tcfg)
        grads = step_grads(state.params, tcfg, batch, None)
        nu = smooth_moments(grads) if init == "fan_in" else None
        if nu is not None:
            for v, c2 in zip(_leaves(state.opt.nu), nu):
                v.fill_(c2)
        keep = [init == "fan_in" or p.numel() <= LM_MESH_SMALL_LEAF
                for p in _leaves(state.params)]
        old = [p.detach().clone() if k else None
               for p, k in zip(_leaves(state.params), keep)]
        step = make_train_step(tcfg, microbatches=TRAIN_MICROBATCHES,
                               warmup=TRAIN_WARMUP, total_steps=TRAIN_TOTAL)
        new, metrics = step(state, batch)
        torch.save({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "nu": nu,
            "grads": [g.cpu() if k else None for g, k in zip(grads, keep)],
            "update": [(p.detach() - o).cpu() if k else None
                       for p, o, k in zip(_leaves(new.params), old, keep)]},
            os.path.join(out_dir, f"train_{init}.pt"))
        seconds[f"train {init}"] = time.perf_counter() - t0
        del state, new, step, grads, old
        torch.cuda.empty_cache()
    return seconds


def step_grads(params, cfg, batch, rules) -> list:
    """The gradients a train step takes (make_train_step's, in
    `_leaves` order): loss_and_grads of each of the TRAIN_MICROBATCHES
    slices of the whole batch (gathered, as the step gathers a batch laid
    out over dp), laid out like its param (this rank's part under rules),
    summed in f32 and divided by their count."""
    import torch

    from repro_torch.optim.adamw import _leaves, local_part
    from repro_torch.parallel.sharding import full
    from repro_torch.training import loss_and_grads

    n, total = TRAIN_MICROBATCHES, None
    for m in range(n):
        mb = {k: full(v).reshape(n, v.shape[0] // n, *v.shape[1:])[m]
              for k, v in batch.items()}
        _, grads = loss_and_grads(params, cfg, mb, rules)
        grads = [local_part(g, p).float() for g, p in
                 zip(_leaves(grads), _leaves(params))]
        if total is None:
            total = grads
        else:
            torch._foreach_add_(total, grads)
        del grads
    torch._foreach_div_(total, float(n))
    return total


def smooth_moments(grads) -> list:
    """Per leaf, the second moment the gated train step starts from: the
    mean square of the leaf's clipped gradient (AdamW's clip at
    grad_clip 1). With zero first moments the step's update is then
    lr (g / sqrt(19 c + g^2) + weight decay x p) for the clipped g and
    this c: smooth in g, where from zero moments it is lr x the sign of g,
    which flips wherever g sits near AdamW's eps or its round-off."""
    import torch

    norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                for g in grads)))
    clip = min(1.0, 1.0 / (norm + 1e-9))
    return [float(torch.mean((g.double() * clip) ** 2)) for g in grads]


def leaf_sums(got, want, like) -> "torch.Tensor":
    """(2, leaves) float64: per leaf, the sum of (got - want)^2 and of
    want^2 over this rank's part. `got` holds local parts (None: skip),
    `want` whole tensors on the host, narrowed to the part of `like`'s
    DTensor layout; summed over the ranks, their ratio's root is the
    leaf's relative RMSE (a replicated part counts on each rank that
    holds it, in both sums alike)."""
    import torch

    from repro_torch.parallel.sharding import local_bounds

    sums = torch.zeros(2, len(like), dtype=torch.float64)
    for i, (g, w, p) in enumerate(zip(got, want, like)):
        if g is None or w is None:
            continue
        for dim, (off, n) in enumerate(local_bounds(
                p.shape, p.device_mesh, p.placements)):
            w = w.narrow(dim, off, n)
        w = w.double()
        sums[0, i] = ((g.detach().double().cpu() - w) ** 2).sum()
        sums[1, i] = (w ** 2).sum()
    return sums


def lm_mesh_rank(rank: int, world: int, work: str) -> None:
    """A rank of [lm-mesh]: gloo over CUDA tensors on the one card, the
    oracles in WORK/lm-mesh. Rank 0 holds every gathered output against
    the oracle's; every rank holds its own part of each updated leaf.
    Writes WORK/rank<R>.json; a collective that raises ends the rank."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.models import transformer as T
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import ShardingRules, full

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    out_dir = os.path.join(work, "lm-mesh")
    print(f"[lm-mesh] rank {rank} device memory allocated on entry: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    dist.init_process_group("gloo", init_method=f"file://{work}/pg-lm",
                            rank=rank, world_size=world, timeout=PG_TIMEOUT)
    report = {"rank": rank}
    try:
        mesh = make_mesh(LM_MESH_SHAPE, ("data", "model"),
                         device_type="cuda")
        serve = ShardingRules(mesh=mesh, fsdp=False)
        cfg, moe_cfg = (get_config("qwen2_1_5b"),
                        get_config("qwen2_moe_a2_7b"))
        # each rank is fed only its dp rows of the same inputs
        prompt = {"tokens": dp_rows(serving_prompts(cfg, dev), serve)}
        forced = dp_rows(torch.load(os.path.join(out_dir, "forced.pt"))
                         .to(dev), serve)
        report["rows"] = {"prompt": list(prompt["tokens"].to_local().shape),
                          "forced": list(forced.to_local().shape)}
        print(f"[lm-mesh] rank {rank} fed its dp rows: prompt ids "
              f"{report['rows']['prompt']}, teacher-forced ids "
              f"{report['rows']['forced']}", flush=True)
        for name, mcfg, _ in lm_mesh_models(cfg, moe_cfg):
            t0 = time.perf_counter()
            params = T.init_params(mcfg, SEED, dev, rules=serve)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            got = serve_path(mcfg, params, prompt, forced, serve, dev)
            got["init_s"] = init_s
            got["prefill_peak"] = got["prefill_extra"] + local_bytes(
                [params, prompt])
            print(f"[lm-mesh] rank {rank} {name} bf16 prefill: "
                  f"max_memory_allocated {got['prefill_max'] / 1e9:.3f} GB,"
                  f" {got['prefill_extra'] / 1e9:.3f} GB above its entry; "
                  f"with its inputs {got['prefill_peak'] / 1e9:.3f} GB",
                  flush=True)
            got["local_gib"] = local_bytes(params) / 2**30
            fan_in_scaled(params, mcfg)
            got["fan16"] = full(T.prefill(params, mcfg, prompt, serve)[0]
                                ).float().cpu()
            del params
            torch.cuda.empty_cache()
            rep = {k: v for k, v in got.items()
                   if not isinstance(v, torch.Tensor)}
            rep["drops"] = got["drops"].tolist()
            rep["choices"] = got["choices"].tolist()
            if rank == 0:
                want = torch.load(os.path.join(out_dir, f"{name}.pt"))
                rep["f32_prefill_rel"] = rel_rmse(got["prefill32"],
                                                  want["prefill32"])
                rep["f32_decode_rel"] = max(
                    rel_rmse(g, w) for g, w in zip(got["decode32"],
                                                   want["decode32"]))
                rep["bf16_rel"] = rel_rmse(got["prefill16"],
                                           want["prefill32"])
                rep["fan_bf16_rel"] = rel_rmse(got["fan16"], want["fan32"])
                rep["fan_bf16_vs_kernel"] = rel_rmse(got["fan16"],
                                                     want["fan16"])
                rep["fan_oracle_bf16_rel"] = rel_rmse(want["fan16"],
                                                      want["fan32"])
                rep["fan_plain_bf16_rel"] = rel_rmse(want["fan_plain16"],
                                                     want["fan32"])
                rep["plain_bf16_rel"] = rel_rmse(want["plain16"],
                                                 want["prefill32"])
                rep["oracle_bf16_rel"] = rel_rmse(want["prefill16"],
                                                  want["prefill32"])
                rep["ids_agree"] = float((got["ids"] == want["ids"])
                                         .float().mean())
                rep["oracle_drops"] = want["drops"].tolist()
            report[name] = rep
        # one f32 train step at LM_MESH_TRAIN_LAYERS, ZeRO-3 rules, at
        # each init of LM_MESH_TRAIN_INITS
        train = ShardingRules(mesh=mesh)
        tcfg = get_config("qwen2_1_5b").scaled(
            num_layers=LM_MESH_TRAIN_LAYERS, dtype="float32")
        batch = {k: dp_rows(v, train)
                 for k, v in train_batch(tcfg, dev).items()}
        report["rows"]["train"] = {k: list(v.to_local().shape)
                                   for k, v in batch.items()}
        for init in LM_MESH_TRAIN_INITS:
            report[f"train_{init}"] = lm_mesh_train_rank(
                tcfg, train, batch, init, out_dir, dev)
    finally:
        dist.destroy_process_group()
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)


def lm_mesh_train_rank(tcfg, rules, batch, init: str, out_dir: str,
                       dev) -> dict:
    """One rank's sharded train step at `init` ("stacked" or "fan_in"):
    the step's gradients (`step_grads`), then the step itself, timed with
    the kernel's launches counted from 0, each leaf's gradient and update
    (the trained part less the part it started from) held against the
    oracle's in WORK/lm-mesh/train_<init>.pt. At "fan_in" the step starts
    from the oracle's `smooth_moments`; the controls are the same sums for
    an update of zero (an unchanged state) and for the smallest leaf's
    gradient halved. At "stacked", per small leaf, the elements whose
    update's sign differs from the oracle's and those whose gradient is
    farther from the oracle's than the oracle's is from zero. Every sum
    is over the ranks; returns the report."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.optim.adamw import _leaves
    from repro_torch.parallel.sharding import local_bounds
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)

    want = torch.load(os.path.join(out_dir, f"train_{init}.pt"), mmap=True)
    state = init_train_state(tcfg, SEED, dev, rules=rules)
    if init == "fan_in":
        fan_in_scaled(state.params, tcfg)
    like = _leaves(state.params)
    grads = step_grads(state.params, tcfg, batch, rules)
    keep = [w is not None for w in want["update"]]
    if want["nu"] is not None:
        for v, c2 in zip(_leaves(state.opt.nu), want["nu"]):
            v.to_local().fill_(c2)
    old = [p.to_local().detach().clone() if k else None
           for p, k in zip(like, keep)]
    step = make_train_step(tcfg, rules=rules,
                           microbatches=TRAIN_MICROBATCHES,
                           warmup=TRAIN_WARMUP, total_steps=TRAIN_TOTAL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    inputs = local_bytes([state, batch])
    dist.barrier()
    ATTN_LAUNCHES.reset()
    t0 = time.perf_counter()
    new, metrics = step(state, batch)
    torch.cuda.synchronize()
    top = torch.cuda.max_memory_allocated()
    rep = {"step_s": time.perf_counter() - t0, "launches": ATTN_LAUNCHES.n,
           "peak_gib": top / 2**30, "peak": top - before + inputs,
           "metrics": {k: float(v) for k, v in metrics.items()}}
    print(f"[lm-mesh] rank {dist.get_rank()} train step at the {init} init: "
          f"max_memory_allocated {top / 1e9:.3f} GB, "
          f"{(top - before) / 1e9:.3f} GB above its entry; with its inputs "
          f"{rep['peak'] / 1e9:.3f} GB", flush=True)
    update = [p.to_local().detach() - o if k else None
              for p, o, k in zip(_leaves(new.params), old, keep)]
    sums = [leaf_sums([g if k else None for g, k in zip(grads, keep)],
                      want["grads"], like),
            leaf_sums(update, want["update"], like)]
    if init == "fan_in":   # the controls
        small = min(range(len(like)), key=lambda i: like[i].numel())
        halved = [g / 2 if i == small else g for i, g in enumerate(grads)]
        sums += [leaf_sums([torch.zeros_like(u) for u in update],
                           want["update"], like),
                 leaf_sums(halved, want["grads"], like)]
    else:                  # the small leaves' flips and their cause
        counts = torch.zeros(3, len(like), dtype=torch.float64)
        for i, (g, u, p) in enumerate(zip(grads, update, like)):
            if u is None:
                continue
            wg, wu = want["grads"][i], want["update"][i]
            for dim, (off, n) in enumerate(local_bounds(
                    p.shape, p.device_mesh, p.placements)):
                wg, wu = wg.narrow(dim, off, n), wu.narrow(dim, off, n)
            g, u = g.double().cpu(), u.double().cpu()
            counts[0, i] = float((torch.sign(u) != torch.sign(wu)).sum())
            counts[1, i] = float(((g - wg).abs() >= wg.abs()).sum())
            counts[2, i] = float(u.numel())
        sums.append(counts)
    total = torch.cat(sums)
    dist.all_reduce(total)

    def rel(i):   # the i-th pair of leaf_sums rows
        return (total[2 * i] / total[2 * i + 1]).sqrt().tolist()

    rep["grad_rel"], rep["update_rel"] = rel(0), rel(1)
    if init == "fan_in":
        rep["control_unchanged_rel"], rep["control_halved_rel"] = (
            rel(2), rel(3))
        rep["control_leaf"] = small
    else:
        rep["flips"], rep["err_over_grad"], rep["elements"] = (
            total[4].tolist(), total[5].tolist(), total[6].tolist())
    rep["loss_rel"] = abs(rep["metrics"]["loss"]
                          / want["metrics"]["loss"] - 1)
    rep["grad_norm_rel"] = abs(rep["metrics"]["grad_norm"]
                               / want["metrics"]["grad_norm"] - 1)
    del state, step, grads, old, update
    if init == "fan_in":
        rep["ckpt"] = lm_ckpt_rank(new, tcfg, rules, batch, out_dir, dev)
    del new
    torch.cuda.empty_cache()
    return rep


def lm_mesh_train_report(init: str, reps: list, names: list,
                         want_train: int) -> None:
    """Prints and gates one init's sharded train step (rank reports
    `reps`, leaf names `names`). Both inits: the kernel's launches per
    rank, the loss and the gradient norm within F32_LOGITS_REL of the
    oracle's. "fan_in": every leaf's gradient and update within
    F32_LOGITS_REL relative RMSE of the oracle's, and each control past
    that bound (else the gate could not fail). "stacked": printed, not
    gated: the small leaves' gradient distances, and their update sign
    flips beside the elements whose gradient error is at least the
    oracle's gradient."""
    tr = reps[0]
    print(f"[lm-mesh] train step at the {init.replace('_', '-')} init, "
          f"Qwen2-1.5B f32 at {LM_MESH_TRAIN_LAYERS} of 28 layers, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MICROBATCHES} "
          f"micro-batches, ZeRO-3 rules: {tr['step_s']:.3f} s, peak "
          f"{tr['peak_gib']:.2f} GiB on rank 0, {tr['launches']} kernel "
          f"launches per rank; loss {tr['metrics']['loss']:.6f} (relative "
          f"to the oracle {tr['loss_rel']:.2e}), grad norm "
          f"{tr['metrics']['grad_norm']:.6e} (relative "
          f"{tr['grad_norm_rel']:.2e})")
    if init == "stacked":
        print(f"[lm-mesh] stacked init, not gated, per leaf of at most "
              f"{LM_MESH_SMALL_LEAF} elements: gradient relative RMSE; "
              f"update relative RMSE; update signs unlike the oracle's; "
              f"elements whose |gradient - oracle's| >= |oracle's|, of all: "
              + "; ".join(
                  f"{names[i]} {tr['grad_rel'][i]:.3e}, "
                  f"{tr['update_rel'][i]:.3e}, {tr['flips'][i]:.0f}, "
                  f"{tr['err_over_grad'][i]:.0f} of {e:.0f}"
                  for i, e in enumerate(tr["elements"]) if e))
    else:
        def worst(key):
            return max(zip(tr[key], names),
                       key=lambda x: math.inf if math.isnan(x[0]) else x[0])

        (g_err, g_leaf), (u_err, u_leaf) = (worst("grad_rel"),
                                            worst("update_rel"))
        small = tr["control_leaf"]
        unchanged = min(tr["control_unchanged_rel"])
        halved = tr["control_halved_rel"][small]
        print(f"[lm-mesh] fan-in init, from second moments of each leaf's "
              f"mean square clipped gradient: worst leaf gradient relative "
              f"RMSE {g_err:.3e} ({g_leaf}), worst update {u_err:.3e} "
              f"({u_leaf}); bound {F32_LOGITS_REL} each; controls: an "
              f"unchanged state, the least leaf distance {unchanged:.3e}; "
              f"{names[small]}'s gradient halved {halved:.3e}")
    if any(rep["launches"] != want_train for rep in reps):
        fail(f"[lm-mesh] train step launches per rank "
             f"{[rep['launches'] for rep in reps]}, not {want_train} "
             f"(forward and remat, per micro-batch and layer)")
    if not (tr["loss_rel"] <= F32_LOGITS_REL
            and tr["grad_norm_rel"] <= F32_LOGITS_REL):
        fail(f"[lm-mesh] {init} train step off the oracle: loss "
             f"{tr['loss_rel']:.3e}, grad norm {tr['grad_norm_rel']:.3e}")
    if init == "stacked":
        return
    if not (g_err <= F32_LOGITS_REL and u_err <= F32_LOGITS_REL):
        fail(f"[lm-mesh] fan-in train step off the oracle: gradient "
             f"{g_err:.3e} ({g_leaf}), update {u_err:.3e} ({u_leaf})")
    if not (unchanged > F32_LOGITS_REL and halved > F32_LOGITS_REL):
        fail("[lm-mesh] a control passes the train step's gates")


def lm_ckpt_rank(new, tcfg, rules, batch, out_dir: str, dev) -> dict:
    """[lm-ckpt] in one rank, after the fan-in train step left `new`: the
    state saved (every rank its share), restored onto this (2, 2) mesh
    with `new` as `like` and compared leaf by leaf, restored onto a
    (1, 4) mesh of the same ranks and saved again as step 2 (for this
    process's whole loads), and one train step from the restored state
    beside one from the live state. Returns the timings, bytes and
    equalities."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.optim.adamw import _leaves
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import ShardingRules
    from repro_torch.training.train_step import (
        make_abstract_state, make_train_step, state_shardings)

    def leaves(s):
        return _leaves(s.params) + _leaves(s.opt.mu) + _leaves(s.opt.nu)

    def same(a, b):
        return all(torch.equal(x.to_local(), y.to_local())
                   for x, y in zip(leaves(a), leaves(b))) and \
            torch.equal(a.opt.step, b.opt.step)

    def local_bytes(s):
        return sum(x.to_local().numel() * x.element_size()
                   for x in leaves(s))

    ckpt = os.path.join(out_dir, "ckpt")
    rep = {}
    for tag, fn in (
            ("save", lambda: save_checkpoint(ckpt, 1, new)),
            ("load_2x2", lambda: load_checkpoint(ckpt, 1, new, device=dev))):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        back = fn()
        torch.cuda.synchronize()
        rep[f"{tag}_s"] = time.perf_counter() - t0
    rep["local_bytes"] = local_bytes(new)
    rep["bit_equal_2x2"] = same(back, new)
    mesh14 = make_mesh((1, 4), ("data", "model"), device_type=dev.type)
    sh = state_shardings(tcfg, ShardingRules(mesh=mesh14))
    sh = sh._replace(opt=sh.opt._replace(step=None))   # a plain step
    dist.barrier()
    t0 = time.perf_counter()
    moved = load_checkpoint(ckpt, 1, make_abstract_state(tcfg), device=dev,
                            shardings=sh)
    torch.cuda.synchronize()
    rep["load_1x4_s"] = time.perf_counter() - t0
    rep["local_bytes_1x4"] = local_bytes(moved)
    rep["placements_1x4"] = str(_leaves(moved.params)[0].placements)
    save_checkpoint(ckpt, 2, moved)
    del moved
    torch.cuda.empty_cache()
    step = make_train_step(tcfg, rules=rules,
                           microbatches=TRAIN_MICROBATCHES,
                           warmup=TRAIN_WARMUP, total_steps=TRAIN_TOTAL)
    resumed, m_resumed = step(back, batch)
    live, m_live = step(new, batch)
    rep["resumed_bit_equal"] = same(resumed, live) and all(
        torch.equal(m_resumed[k], m_live[k]) for k in m_live)
    rep["resumed_loss"] = float(m_resumed["loss"])
    del resumed, live, back
    torch.cuda.empty_cache()
    return rep


def lm_ckpt_report(tcfg, reps: list, out_dir: str, dev) -> None:
    """[lm-ckpt] in this process: the ranks' equalities (gated), then the
    checkpoint's steps 1 ((2, 2)) and 2 (written from the (1, 4) restore)
    loaded whole, bit-equal, and step 1's update against the unsharded
    oracle's leaf by leaf (the params less the fan-in init, relative
    RMSE within F32_LOGITS_REL); save and restore GB/s."""
    import torch

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.optim.adamw import _leaves
    from repro_torch.training.train_step import (
        init_train_state, make_abstract_state)

    ckpt = os.path.join(out_dir, "ckpt")
    like = make_abstract_state(tcfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = load_checkpoint(ckpt, 1, like, device=dev)
    torch.cuda.synchronize()
    t_whole = time.perf_counter() - t0
    whole14 = load_checkpoint(ckpt, 2, like, device=dev)
    leaves = (_leaves(whole.params) + _leaves(whole.opt.mu)
              + _leaves(whole.opt.nu))
    total = sum(x.numel() * x.element_size() for x in leaves)
    equal14 = all(torch.equal(a, b) for a, b in zip(
        leaves, _leaves(whole14.params) + _leaves(whole14.opt.mu)
        + _leaves(whole14.opt.nu))) and torch.equal(whole.opt.step,
                                                     whole14.opt.step)
    del whole14
    init = init_train_state(tcfg, SEED, dev)
    fan_in_scaled(init.params, tcfg)
    want = torch.load(os.path.join(out_dir, "train_fan_in.pt"), mmap=True)
    worst = 0.0
    for p, p0, w in zip(_leaves(whole.params), _leaves(init.params),
                        want["update"]):
        worst = max(worst, rel_rmse((p - p0.detach()).cpu(), w))
    step = int(whole.opt.step)
    del whole, init
    torch.cuda.empty_cache()

    def rate(nbytes, seconds):
        return f"{nbytes / seconds / 1e9:.3f} GB/s"

    save_s = max(r["save_s"] for r in reps)
    load22 = max(r["load_2x2_s"] for r in reps)
    load14 = max(r["load_1x4_s"] for r in reps)
    print(f"[lm-ckpt] {tcfg.name} at {tcfg.num_layers} layers, f32 "
          f"TrainState {total / 1e9:.3f} GB: saved by 4 ranks in "
          f"{save_s:.3f} s ({rate(total, save_s)}); restored onto (2, 2) in "
          f"{load22:.3f} s ({rate(sum(r['local_bytes'] for r in reps), load22)}"
          f" of local parts), onto (1, 4) (the first leaf "
          f"{reps[0]['placements_1x4']}) in {load14:.3f} s "
          f"({rate(sum(r['local_bytes_1x4'] for r in reps), load14)}); whole "
          f"in this process {t_whole:.3f} s ({rate(total, t_whole)}); "
          f"{nvidia_smi_line()}")
    print(f"[lm-ckpt] bit-equal on (2, 2) per rank "
          f"{[r['bit_equal_2x2'] for r in reps]}; the (1, 4) restore, "
          f"gathered, bit-equal to the saved state: {equal14}; a resumed "
          f"step bit-equal to the live one per rank "
          f"{[r['resumed_bit_equal'] for r in reps]} (loss "
          f"{reps[0]['resumed_loss']:.6f}); step {step}; the whole state's "
          f"update from the fan-in init vs the oracle's: worst leaf "
          f"relative RMSE {worst:.3e} (bound {F32_LOGITS_REL})")
    if not (all(r["bit_equal_2x2"] for r in reps) and equal14):
        fail("[lm-ckpt] a restore is not bit-equal to the saved state")
    if not all(r["resumed_bit_equal"] for r in reps):
        fail("[lm-ckpt] the step from the restored state differs from the "
             "step from the live state")
    if step != 1 or not worst <= F32_LOGITS_REL:
        fail(f"[lm-ckpt] the whole state: step {step}, update {worst:.3e} "
             f"from the oracle's")


def grouped_einsum_flops(cfg) -> tuple:
    """Per MoE layer at the serving shape with 2 groups: operations of
    the one-hot dispatch einsum (the combine's are the same) and of the
    three expert GEMMs together, over the capacity buffers."""
    from repro_torch.models import moe as M

    m = cfg.moe
    g = LM_MESH_SHAPE[1]
    sg = PROMPT // g
    c = M.capacity(cfg, sg)
    rows = BATCH * g * m.num_experts * c
    dispatch = 2.0 * BATCH * g * sg * m.top_k * m.num_experts * c \
        * cfg.d_model
    experts = 2.0 * 3 * rows * cfg.d_model * m.d_ff_expert
    return c, dispatch, experts


def lm_mesh_dry_runs(cfg) -> dict:
    """The dry run's rows for the cells the ranks of [lm-mesh] run, on a
    fake world of LM_MESH_SHAPE: the bf16 Qwen2-1.5B prefill of the
    serving prompts (f32 weights, serving rules: no fsdp) and the f32
    train step at LM_MESH_TRAIN_LAYERS (ZeRO-3 rules)."""
    from repro_torch.launch import dryrun as D

    data, model = LM_MESH_SHAPE
    kw = dict(verbose=False, nodes=data, gpus_per_node=model)
    return {
        "prefill": D.run_cell(
            "qwen2_1_5b", "prefill_32k", False, cfg=cfg,
            shape_info=dict(kind="prefill", seq=PROMPT, batch=BATCH), **kw),
        "train": D.run_cell(
            "qwen2_1_5b", "train_4k", False,
            cfg=cfg.scaled(num_layers=LM_MESH_TRAIN_LAYERS, dtype="float32"),
            shape_info=dict(kind="train", seq=TRAIN_SEQ, batch=TRAIN_BATCH),
            microbatches=TRAIN_MICROBATCHES, **kw)}


def lm_mesh_memory_report(dry: dict, reports: list) -> None:
    """Prints and gates each rank's rows and its measured peaks (the
    Qwen2-1.5B bf16 prefill, each train step) against the dry run's
    predictions for the same cells."""
    want = {"prompt": [BATCH // LM_MESH_SHAPE[0], PROMPT],
            "forced": [BATCH // LM_MESH_SHAPE[0], LM_MESH_STEPS],
            "train": {k: [TRAIN_BATCH // LM_MESH_SHAPE[0], TRAIN_SEQ]
                      for k in ("tokens", "labels")}}
    rows = [rep["rows"] for rep in reports]
    print(f"[lm-mesh] local rows each rank was fed (whole: {BATCH} x "
          f"{PROMPT} prompts, {TRAIN_BATCH} x {TRAIN_SEQ} train batch): "
          f"{rows}")
    if any(r != want for r in rows):
        fail(f"[lm-mesh] a rank was fed other than its dp rows {want}")
    measured = {"prefill": [rep["qwen2"]["prefill_peak"] for rep in reports],
                "train": [rep[f"train_{init}"]["peak"] for rep in reports
                          for init in LM_MESH_TRAIN_INITS]}
    for cell, peaks in measured.items():
        pred = dry[cell]["peak_mem_bytes"]
        worst = max(peaks, key=lambda m: abs(pred / m - 1))
        print(f"[lm-mesh] {cell} peak memory a rank: predicted "
              f"{pred / 1e9:.3f} GB by the dry run on a fake (2, 2) world "
              f"(trace {dry[cell]['trace_s']:.1f} s; by kind "
              f"{dry[cell]['memory']}), measured "
              f"{[round(m / 1e9, 3) for m in peaks]} GB (ranks"
              + (" x inits" if cell == "train" else "") + f"), worst "
              f"{pred / worst - 1:+.1%} (band +-{LAUNCH_MEM_BAND:.0%})")
        if abs(pred / worst - 1) > LAUNCH_MEM_BAND:
            fail(f"[lm-mesh] {cell}: predicted peak {pred} B, measured "
                 f"{worst} B on a rank, past +-{LAUNCH_MEM_BAND:.0%}")


def lm_mesh(cfg, moe_cfg, dev, work: str) -> dict:
    """Phase 34 [lm-mesh]; returns the attention kernel's launches summed
    over the ranks: {"f32": ..., "bf16": ...}."""
    import torch

    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    entering("[lm-mesh]")
    t_phase = time.perf_counter()
    out_dir = os.path.join(work, "lm-mesh")
    os.makedirs(out_dir)
    seconds = lm_mesh_oracles(cfg, moe_cfg, dev, out_dir)
    print(f"[lm-mesh] oracles, one process: {seconds} s; device memory "
          f"allocated before the ranks: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    world = math.prod(LM_MESH_SHAPE)
    for r in range(world):   # the 2 x 2 phase's reports
        path = os.path.join(work, f"rank{r}.json")
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    dry = {}
    ranks = spawn_ranks(world, work, LM_MESH_DEADLINE_S, "--lm-mesh-rank",
                        meanwhile=lambda: dry.update(lm_mesh_dry_runs(cfg)))
    ranks_s = time.perf_counter() - t0
    for r, (code, tail, report) in enumerate(ranks):
        for line in tail.splitlines():
            if line.startswith("[lm-mesh]"):
                print(line)
        if code != 0 or report is None or "train_fan_in" not in report:
            fail(f"[lm-mesh] rank {r} exited {code}:\n{tail}")
    reports = [rep for _, _, rep in ranks]
    lead = reports[0]
    n_attn = {"qwen2": attention_layers(cfg), "moe": LM_MESH_MOE_LAYERS}
    launches = {"f32": 0, "bf16": 0}
    for name, mcfg, _ in lm_mesh_models(cfg, moe_cfg):
        rep = lead[name]
        for r, other in enumerate(reports):
            o = other[name]
            if o["f32_launches"] != n_attn[name] or \
                    o["bf16_launches"] != n_attn[name]:
                fail(f"[lm-mesh] {name} rank {r}: {o['f32_launches']} f32 "
                     f"and {o['bf16_launches']} bf16 kernel launches a "
                     f"prefill, not {n_attn[name]}")
            launches["f32"] += o["f32_launches"]
            launches["bf16"] += o["bf16_launches"]
        print(f"[lm-mesh] {mcfg.name} ({mcfg.num_layers} layers), 4 ranks: "
              f"weights drawn and placed in {rep['init_s']:.2f} s, "
              f"{rep['local_gib']:.2f} GiB on rank 0; f32 prefill "
              f"{rep['f32_prefill_s']:.3f} s, relative RMSE vs the oracle "
              f"{rep['f32_prefill_rel']:.3e}, {LM_MESH_STEPS} teacher-forced "
              f"f32 decode steps max {rep['f32_decode_rel']:.3e}; bf16 "
              f"greedy_generate {BATCH} x {PROMPT} + {LM_MESH_STEPS} steps "
              f"{rep['greedy_s']:.3f} s (ids equal to the oracle's: "
              f"{rep['ids_agree']:.1%}), bf16 prefill "
              f"{rep['bf16_prefill_s']:.3f} s, distance from the f32 oracle "
              f"{rep['bf16_rel']:.3e} (unsharded: kernel "
              f"{rep['oracle_bf16_rel']:.3e}, plain "
              f"{rep['plain_bf16_rel']:.3e}; not gated: at the stacked "
              f"init bf16 sits as far from f32 as the logits are large); "
              f"kernel launches per rank and prefill {rep['f32_launches']}")
        print(f"[lm-mesh] {mcfg.name} on the weights rescaled to 1 / sqrt("
              f"fan_in): bf16 prefill relative RMSE from the unsharded f32 "
              f"kernel path {rep['fan_bf16_rel']:.3e} (bound 2 x the "
              f"unsharded bf16 plain path's {rep['fan_plain_bf16_rel']:.3e};"
              f" the unsharded bf16 kernel path's "
              f"{rep['fan_oracle_bf16_rel']:.3e}), from the unsharded bf16 "
              f"kernel path "
              f"{rep['fan_bf16_vs_kernel']:.3e}")
        if not (rep["f32_prefill_rel"] <= F32_LOGITS_REL
                and rep["f32_decode_rel"] <= F32_LOGITS_REL):
            fail(f"[lm-mesh] {name} f32 logits off the oracle: prefill "
                 f"{rep['f32_prefill_rel']:.3e}, decode "
                 f"{rep['f32_decode_rel']:.3e} > {F32_LOGITS_REL}")
        if not rep["fan_bf16_rel"] <= 2 * rep["fan_plain_bf16_rel"]:
            fail(f"[lm-mesh] {name} bf16 logits {rep['fan_bf16_rel']:.3e} "
                 f"from f32 on the fan-in weights, past twice the plain "
                 f"step's {rep['fan_plain_bf16_rel']:.3e}")
        if rep["drops"] != rep["oracle_drops"]:
            fail(f"[lm-mesh] {name} drops per layer {rep['drops']}, the "
                 f"oracle's {rep['oracle_drops']}")
        if rep["drops"]:
            c, dispatch, experts = grouped_einsum_flops(mcfg)
            print(f"[lm-mesh] {mcfg.name}: 2 groups of {PROMPT // 2} tokens,"
                  f" capacity {c} slots an expert (one group: "
                  f"{M.capacity(mcfg, PROMPT)}); (token, choice) pairs "
                  f"dropped in the f32 prefill {sum(rep['drops']):.0f} of "
                  f"{sum(rep['choices']):.0f} "
                  f"({sum(rep['drops']) / sum(rep['choices']):.4%}; per "
                  f"layer {rep['drops']}), equal to the oracle's; per layer "
                  f"the dispatch einsum {dispatch / 1e12:.3f} TFLOP and the "
                  f"combine's the same, the expert GEMMs "
                  f"{experts / 1e12:.3f} TFLOP together")
    names = [k for k, _ in flat_leaves(T.abstract_params(cfg.scaled(
        num_layers=LM_MESH_TRAIN_LAYERS)))]
    want_train = 2 * TRAIN_MICROBATCHES * LM_MESH_TRAIN_LAYERS
    for init in LM_MESH_TRAIN_INITS:
        lm_mesh_train_report(init, [rep[f"train_{init}"] for rep in reports],
                             names, want_train)
    lm_ckpt_report(cfg.scaled(num_layers=LM_MESH_TRAIN_LAYERS,
                              dtype="float32"),
                   [rep["train_fan_in"]["ckpt"] for rep in reports],
                   out_dir, dev)
    lm_mesh_memory_report(dry, reports)
    print(f"[lm-mesh] ranks {ranks_s:.1f} s (spawn to exit), phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    launches["train"] = sum(rep[f"train_{init}"]["launches"]
                            for rep in reports for init in LM_MESH_TRAIN_INITS)
    return launches



def flat_leaves(tree, prefix: str = "") -> list:
    """[(key, tensor)] of nested dicts in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flat_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from the root "
              "of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    # The tuning and calibration files, the stores and the checkpoints
    # live for this run only (the spawned mesh ranks inherit the files).
    work = tempfile.mkdtemp(prefix="chip-smoke-")
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(work, "tune.json")
    os.environ["REPRO_CALIB_CACHE"] = os.path.join(work, "calib.json")
    try:
        return run(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(work: str) -> int:
    """Phases 1-35 (see the module's docstring); stores and checkpoints
    go under `work`."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.kernels.filter import kernel as rfk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_run = time.perf_counter()

    # 1. Device ------------------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch: {kind}, count {count}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}")

    # 2. Build the libraries at once, one nvcc each ------------------------
    t0 = time.perf_counter()
    libs = (bpk.LIBRARY, fak.LIBRARY, rfk.LIBRARY)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.build) for lib in libs]:
            fut.result()
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.2f} s "
          "wall")
    for lib in libs:
        print(f"[build] {lib.path.name}: nvcc {lib.build_seconds} s (None = "
              "already built)")
        print("[build] " + lib.ptxas_report().replace("\n", "\n[build] "))

    # 3-5. Reconstruction ----------------------------------------------------
    entries, g, proj, phantom = reconstruction(dev)
    filter_entry = filter_phase(g, proj)
    torch.cuda.empty_cache()

    # 6-10. The streaming, batched and I/O paths, the tracer ------------------
    kernel_delta(g, proj, entries)
    # launches per path, for each codec of MAIN_PATH_CODECS
    paths = {"single-device": {c: e["launches"]
                               for c, e in zip(MAIN_PATH_CODECS, entries)}}
    paths["incremental"] = incremental(g, proj, phantom)
    torch.cuda.empty_cache()
    paths["batched"] = batched(g, proj)
    torch.cuda.empty_cache()
    n_launch, *io_rates = io_phase(dev, g, proj, work)
    paths["io"] = {"fp32": n_launch, "fp16": 0}
    paths["trace"] = {"fp32": trace_phase(g, proj), "fp16": 0}
    torch.cuda.empty_cache()

    # 11-15. Launch shapes, the perf model, traced engines, the planner ------
    tile_ms = tiles_phase(g, proj)
    paths["tuned"] = tune_phase(g, proj, phantom, tile_ms)
    torch.cuda.empty_cache()
    paths["traced"], t_filter = traced_phase(g, proj)
    torch.cuda.empty_cache()
    machine_spec_phase(g, proj, io_rates, t_filter)
    torch.cuda.empty_cache()
    paths["auto"] = auto_phase(g, proj, phantom)
    torch.cuda.empty_cache()

    # 16-18. The service, its serve loop, the resumable reconstruction -----
    svc, paths["service"], seconds_a = service_phase(g, proj, phantom, work)
    del phantom
    torch.cuda.empty_cache()
    paths["serve-loop"] = serve_loop_phase(svc, g, proj, seconds_a)
    svc.close()
    del svc
    torch.cuda.empty_cache()
    paths["resumable"] = resumable_phase(g, proj, work)
    torch.cuda.empty_cache()

    # 19-21. The mesh engine and backproject_mxu -----------------------------
    paths["mesh 1x1"] = mesh_one(dev, g, proj)
    torch.cuda.empty_cache()
    paths["mesh 2x2, all ranks"] = {"fp32": mesh_four(g, proj), "fp16": 0}
    del proj
    mxu_check(dev)
    for entry, codec in zip(entries, MAIN_PATH_CODECS):
        entry["launches_by_path"] = {name: p.get(codec, 0)
                                     for name, p in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        print(f"[kernels] {entry['name']} launches: {entry['launches']} = "
              + " + ".join(f"{p.get(codec, 0)} ({name})"
                           for name, p in paths.items()))
    filter_entry["launches_by_path"] = {name: FILTER_BY_PATH.get(name, 0)
                                        for name in paths}
    filter_entry["launches"] = sum(filter_entry["launches_by_path"].values())
    print(f"[kernels] {filter_entry['name']} launches, every codec: "
          f"{filter_entry['launches']} = " + " + ".join(
              f"{n} ({name})"
              for name, n in filter_entry["launches_by_path"].items()))
    other = {f"{name}, {c}": n for name, p in paths.items()
             for c, n in p.items() if c not in MAIN_PATH_CODECS and n}
    print(f"[kernels] back-projector launches on the other wire types' "
          f"instantiations (no entry of their own): {other}")

    # 22-24. Serving --------------------------------------------------------
    cfg = get_config("qwen2_1_5b")
    moe_cfg = get_config("qwen2_moe_a2_7b")
    hybrid_cfg = get_config("jamba_1_5_large")
    gqa7_cfg = get_config("deepseek_coder_33b")
    mixtral_cfg = get_config("mixtral_8x7b")
    max_abs, stressed = attention_checks(cfg, dev, moe_cfg,
                                         hybrid_config(hybrid_cfg), gqa7_cfg)
    group7 = group7_timing(gqa7_cfg, dev)
    window_max_abs, window_times = window_check(mixtral_cfg, dev)
    torch.cuda.empty_cache()
    launches = serving(cfg, dev)
    torch.cuda.empty_cache()
    attn = attention_timing(cfg, dev, launches, max_abs, stressed)
    torch.cuda.empty_cache()

    # 25-26. Training (the serving weights are freed) -----------------------
    train_check(cfg, dev)
    torch.cuda.empty_cache()
    trained = training(cfg, dev)
    for entry in attn:
        trains = entry["name"] == "fa_fwd_bf16_kernel"  # cfg.dtype bf16
        entry["launches_by_path"]["training"] = (
            trained["launches"] if trains else 0)
        if trains:
            entry["train_shape_ms"] = trained["train_shape_ms"]
            entry["train_shape_bound_ms"] = trained["train_shape_bound_ms"]
    del trained
    torch.cuda.empty_cache()

    # 27. The dry run against the card; two production cells dry-run on
    # the host meanwhile -------------------------------------------------
    production, launched = launch_phase(cfg, dev, work)
    for entry in attn:
        entry["launches_by_path"]["launch prefill and train step"] = (
            launched if entry["name"] == "fa_fwd_bf16_kernel" else 0)
    torch.cuda.empty_cache()

    # 28-30. MoE, SSM and hybrid serving (the training state is freed) ----
    moe = moe_serve(moe_cfg, dev)
    ssm = ssm_serve(get_config("mamba2_130m"), dev)
    hyb = hybrid(hybrid_cfg, dev)

    # 31-33. The last five configs' paths (Mixtral's window, the frontends)
    mix = mixtral(mixtral_cfg, dev)
    mus = musicgen(get_config("musicgen_large"), dev)
    vl = vlm(get_config("internvl2_26b"), dev)
    for entry in attn:
        dtype = (torch.bfloat16 if entry["name"] == "fa_fwd_bf16_kernel"
                 else torch.float32)
        if dtype == torch.bfloat16:
            entry["launches_by_path"].update({
                "moe serving prefill": moe["bf16"],
                "ssm serving prefill": ssm,
                "hybrid serving prefill": hyb["bf16"],
                "mixtral serving prefill, 4 x 2048":
                    mix["bf16"]["causal"]["launches"],
                "mixtral serving prefill, 1 x 8192 (windowed)":
                    mix["bf16"]["windowed"]["launches"],
                "musicgen serving prefill": mus["bf16"],
                "vlm serving prefill": vl["bf16"]})
            windowed = mix["bf16"]["windowed"]["window_launches"]
        else:
            entry["launches_by_path"].update({
                "moe f32 prefill": moe["f32"],
                "hybrid f32 prefill": hyb["f32"],
                "mixtral f32 prefill, 4 x 2048": mix["f32"]["causal"],
                "mixtral f32 prefill, 1 x 8192 (windowed)":
                    mix["f32"]["windowed"],
                "musicgen f32 prefill": mus["f32"],
                "vlm f32 prefill": vl["f32"]})
            windowed = mix["f32"]["windowed"]
        entry["launches"] = sum(entry["launches_by_path"].values())
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   window_max_abs[dtype],
                                   mus["dp64"][dtype]["max_abs_err"])
        entry["windowed"] = dict(window_times[dtype], launches=windowed,
                                 max_abs_err=window_max_abs[dtype])
        entry["dp64"] = mus["dp64"][dtype]
        entry["group7"] = group7[dtype]
        print(f"[kernels] {entry['name']} launches: {entry['launches']} = "
              f"{entry['launches_by_path']}")
    # 34. The sharded LM substrate on four ranks sharing the card --------
    meshed = lm_mesh(cfg, moe_cfg, dev, work)
    for entry in attn:
        if entry["name"] == "fa_fwd_bf16_kernel":
            entry["launches_by_path"]["lm-mesh bf16 serving prefills, 4 "
                                      "ranks"] = meshed["bf16"]
        else:
            entry["launches_by_path"]["lm-mesh f32 prefills and train "
                                      "steps, 4 ranks"] = (meshed["f32"]
                                                           + meshed["train"])
        entry["launches"] = sum(entry["launches_by_path"].values())
        print(f"[kernels] {entry['name']} launches with [lm-mesh]: "
              f"{entry['launches']}")
    entries += attn + [filter_entry]

    finish_production_cells(production)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "repro."))
                    or m == "repro")
    if leaked:
        fail(f"the port imported {leaked}")

    # 35. Result -----------------------------------------------------------
    print(f"[run] phases 1-34 in {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(f"[device] {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--mesh-rank":
        mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if len(sys.argv) == 5 and sys.argv[1] == "--lm-mesh-rank":
        lm_mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
