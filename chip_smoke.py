#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab DIR   # wta_counts and stoch_round: DIR's vs these

Phases, each fatal on failure (non-zero exit, no result line):

1. device: print ``nvidia-smi``'s name and power limit; no CUDA → exit 1.
2. build: compile every CUDA source of the port with nvcc (in parallel);
   print each kernel's registers, shared memory and spills as ptxas
   reports them.
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main paths give it: both attention kernels at
   stablelm-3b's full width (first, whether one slot's decode output is
   bit-identical at every window width W = 8, 16, 32 and at two slot
   indices, which decides how phase 4c gates its streams; then whether a
   speculative verify's 32 rows (k = 4 steps of B = 8 slots) are
   bit-identical to the draft rows that computed the same slot and
   position, launched with the draft batch's cluster split (required) and
   with their own (printed), and the verify shape at W = 32 against its
   plain version, timed beside its byte bound and SDPA; bf16 and int8
   pools; decode at B=8 over
   W=32, at B=1 over W=32 and at the serve profile's positions 100-130,
   each also at every cluster size; plus small GQA / local / soft-cap
   cases), ``stoch_round`` bit-identical at the int8 decode write,
   the int8 prefill chunk and the 2048² quantizer row (also one element
   into its storage, off the 16-byte grid), the fused int8 KV write
   bit-identical (trash page 0 aside) at the decode write and a 128-token
   prefill chunk, ``wta_counts`` within its agreement bound at the serving
   head's width and at (256, 128), and there exactly equal to the counts
   of every column drawn in full, with its launch shape and the head's
   device time at nine others, the premises of its pruning checked over
   every value the draw's uniforms can take, and the issue estimate of
   the plain Box-Muller path counted from the SASS of
   ``wta_draw_probe_kernel`` beside its SFU bound; with kernel times per call (CUDA events
   over back-to-back calls) and on the device (the same, with the host's
   time hidden behind a spin kernel), plain and library times, and each
   kernel's bound; ``crossbar_mac`` (prepass + tensor-core GEMM) at the
   three stablelm-3b training shapes and at odd, physical-noise and
   canary cases, its prepass's pieces, levels and column sums
   bit-identical and row sums within f32 summation error, its GEMM held
   to the read's gates and timed at every compiled tile width, and the
   comparator decisions that one bf16 or TF32 pass of x, or two bf16
   pieces, would keep; ``wta_sample`` (the threefry WTA sampler) at the
   serving head (8 x 50304 bf16 logits, 32 trials, per-slot keys and
   steps, the three reads of R = 3), the first-token sample (1 x 50304)
   and the 10-class head (64 x 10, 100 trials, one key), its counts and
   decisions exactly equal to the plain version's (any difference
   printed), its draw's bits, uniforms and normals bit-equal to
   ``repro_torch.random`` across the counter's high word, and its time
   beside the issue estimate of its own SASS (``wta_sample_issue``), and
   at the FCNN's head (1024 x 10, one trial, one key); ``sigmoid_sample``
   (the FCNN's stochastic Sigmoid neurons) at the hidden layers' shapes
   ((1024, 500), (1024, 300), (128, 500), (128, 300)), an odd shape and
   nonzero counter offsets, its bits, uniforms, p and decisions exactly
   equal to the plain version's (any difference printed with u and p),
   timed beside its byte bound and the issue estimate of its own SASS
   (``sigmoid_sample_issue``).  Then (:func:`head_shape_kernels`) both
   attention kernels at gemma2-2b's (8 / 4 heads of 256), deepseek-coder-
   33b's (56 / 8 of 128) and nemotron-4-340b's (96 / 8 of 192) head
   shapes: decode B = 8 over W = 32 and prefill S = 128 at q0 = 128 over
   bf16, int8 and f32 pools, and gemma2's local layer (window 300,
   soft-cap 50), each checked, timed beside its bound and SDPA, with its
   geometry (warps, ring stages, split, shared memory, CTAs an SM) and the
   new tile instantiations' ptxas registers and spills; the fused int8
   write at those kv heads; ``wta_sample`` at the 256000- and 32256-column
   heads.
4. serve: ``ServingEngine`` serves a 12-request shared-prefix trace at
   stablelm-3b full width (random seeded weights) four times, with a
   bf16 and an int8 KV pool, then with WTA sampling (``wta_head``,
   ``ServeConfig(seed=0)``) on the bf16 pool at one read and at three
   redundant reads a token, with prefix hits, chunked
   suffix prefill and copy-on-write, each through the compiled engine
   (the decode step captured as one CUDA graph per window width and
   replayed) and then eagerly (``graphs=False``): streams equal token for
   token (a divergence printed with both sides' tokens at it), launch
   counts equal; each run prints its captures, each capture's ms,
   ``compile_counts()`` (one ``serve_step`` per window width, fewer than
   decode steps), its widest graph's nodes by type, and the device
   memory its engine held, which must all be freed once it is dropped
   (under 32 MiB left).  The launch counts of the kernels each run goes
   through, reset just before and read just after (the counters add
   each graph's captured counts on every replay), must be > 0 (attention: one launch
   per layer and decode step; the int8 run: one fused write per
   attention launch; the WTA runs: R ``wta_sample`` launches per decode
   step, one per first token).  Each run ends in a profile of full-batch
   decode ticks (replays, for the compiled engine) with kernels per tick,
   the device busy share and the decode attention kernel's and the WTA
   sampler's shares of the device time, each trace checked against counts
   the profiler does not make (a replay's events = its graph's nodes, the
   attention and WTA kernels = their launch counters; retaken up to three
   times, then the phase fails).  Then the degraded serve
   (:func:`degraded_phase`): the WTA trace through the compiled engine on
   the ``sim_faulty`` backend with every knob at zero (the ``sim`` WTA
   stream token for token, analog counts = tokens computed x per-token
   counts exactly, = the ``sim`` run's), and again under the ladder
   (canary every tick, comparator offset 3 injected at tick 4 and taken
   back at tick 16, idle ticks until level 0): the ladder reaches level 2
   (R = 3 captured) and returns, its transitions printed, the canary's
   ``crossbar_mac`` launches equal its probes (reset just before, read
   just after), re-reads priced, every request ends with a typed reason,
   the tokens before tick 4 equal the zero-knob run's, the graph rebuilds
   and each recapture's ms printed, device memory after each rebuild
   within 32 MiB of before, under 32 MiB left once the engine is dropped;
   both print the Table I model's pJ per published token and TOPS/W (a
   model, not a measurement).  Then phase 4c (:func:`preempt_phase`),
   through the compiled engine with half the trace's reservations in the
   pool: (a) requests 0-7 at priority 1, 8-11 at priority 0 after 7 ticks,
   two forced preempts at tick 16, a spill budget of one record, greedy
   bf16: at least 3 preemptions, 1 restore and 1 dropped record, every
   stream phase 4's, each spill's bytes (the fixed-width record) and ms,
   each restore's ms, the preempting ticks' host ms beside the others';
   (b) the same with WTA sampling (phase 4's WTA streams); (c) on an int8
   pool (agreement printed, not gated); (d) chaos on bf16 and int8 pools:
   a prefill killed at tick 1, a NaN page at tick 5 (the victim's sanity
   code ``SANE_NAN`` through the decode kernel), a deadline storm at tick
   20; each run with typed done reasons, the allocator back to capacity,
   one signature per preemption entry point, the pool's addresses kept,
   no capture from a restore or a poison, its kernels launched, under 32
   MiB left.  Then host ms a full-batch tick in turns in
   one process: greedy and WTA, each compiled and eager, and WTA compiled
   on ``sim_faulty`` with the canary off and on every tick.  Then phase
   4d (:func:`spec_phase`), self-speculative decoding through the
   compiled engine (one captured round per (W, k)), the trace at 16 tokens
   a request: first a probe of one round's draft and verify logits
   (:func:`spec_probe`; bf16 and f32 weights, float and int8 pools:
   max|Δlogit| between each verify row and its draft row, rows not
   bit-equal, rows whose argmax or WTA decision differs); then (a) greedy
   k = 4, (b) WTA k = 3, (c) int8 greedy k = 4, (d) drafts reported wrong
   every other round (rollbacks; one ``spec_rollback`` signature), (e)
   forced preempts at ticks 1 and 3 under k = 3 (restores = preemptions);
   each with its acceptance, tokens a round, tok/s, decode step ms, TTFT,
   ``compile_counts()`` (one ``spec_round`` per width, fewer than rounds),
   captures and their ms, no capture inside a rollback, decode attention
   launches = 32·(k + 1) a round + 32 a plain tick, ``write_kv_int8`` and
   ``wta_sample`` launches exact, under 32 MiB left.  Where the probe
   finds the bf16 verify rows bit-equal to their drafts, (a), (b), (d),
   (e) are gated on phase 4's streams; otherwise the same runs on an f32
   copy of the weights are gated on its own plain serve, and the bf16
   agreement is printed (int8 never gated).  Then host ms of a replayed
   round against a replayed plain tick, in turns (:func:`spec_turns`).
   Then phase 4f (:func:`dense_phase`), the dense KV layout and the static
   engine on the trace (phase 4's ServeConfig, no ``prefill_chunk``): (a)
   the dense engine greedy (compiled = eager, streams and launches) and
   WTA, bf16, one capture (one batch width), profiled and beside phase 4's
   paged numbers, host ms a tick in turns against the paged engine; its
   streams against the paged engine's on an f32 copy (eager, each token's
   margin recorded: every parting a tie within 4·max|Δ top-1 logit|),
   bf16 agreement printed; (b) int8 dense against int8 paged: at full width
   printed, at the reference test's size (smoke model, its mixed trace)
   every parting a tie, the agreement printed beside its 0.95; (c)
   ``StaticServingEngine`` on the trace, greedy and WTA (occupancy, tok/s,
   one graph per wave width), and at f32 against the continuous engine on
   eight prompts padded to one bucket; (e) no attention kernel or int8
   write on the dense path, ``wta_sample`` = ticks + first tokens (dense
   WTA), = decode steps (static WTA).  Phase 7 also holds the dense
   layout's logits card against CPU.
   Then phase 4n (:func:`mesh_phase`), the serving mesh at 1 × 1: a
   one-rank NCCL group (no TCP port) and a ``cuda`` mesh; the trace
   served as phase 4 serves it (bf16 pool, int8 pool, WTA R = 1; graphs
   on) with ``ServeConfig(mesh=...)``: streams byte-identical to phase
   4's, each kernel's launches equal to phase 4's, and the replayed
   tick's graph the same nodes by type; the tick's host and device ms
   beside phase 4's, and host ms a tick in turns against an unsharded
   engine (:func:`mesh_turns`); a k = 4 speculative serve at 1 × 1 equal to 4d
   (a)'s streams and launches; ``bench_sharded_decode`` (the smoke
   model, 1 × 1, capacity ratio 1.0) through the section's check (phase
   4e (d) validates the whole report, this section in it); and
   ``serve.py --sharded`` for three requests in a subprocess.
4o. training on a mesh (:func:`train_mesh_phase`, right after 4m):
   stablelm-3b at full width cut to MESH_TRAIN_LAYERS layers,
   ``analog_stochastic``, 8 x 128, on a one-rank NCCL group and a 1 x 1
   ``cuda`` mesh, so that every step runs through DTensor and the
   crossbar reads launch on whole operands (``parallel.on_whole``).  (a)
   ``train.loop.run`` for MESH_TRAIN_STEPS steps unsharded and with
   ``mesh=``: losses bit-equal, ``crossbar_mac`` reads and prepasses
   CB_PER_LAYER x layers x 2 (remat) a step in each, each step's seconds
   beside the unsharded's (DTensor's host overhead).  (b) the unsharded
   loop's checkpoint loaded onto the mesh (``load_checkpoint(...,
   shardings=)``): the next step's loss bit-equal to the unsharded final
   state's next step.  (c) the dry run at 1 x 1: ``dryrun.count_step`` of the
   digital train step at 8 x 128 on a fake one-rank group against
   ``dryrun.measure_step`` on the NCCL mesh: args and temp within
   DRYRUN_MEM_RTOL of the allocator, FLOPs equal, nothing sent.  (d)
   ``train.py --smoke --sharded --steps 2`` in its own process, started
   with the phase and read at its end (the full 3B launcher would write
   three checkpoints of ~34 GB).  Checkpoints go
   to build/ckpts and are removed.  Prints its wall time.
4g. decoders (:func:`decoders_phase`, run after phase 6b): gemma2-2b at
   full width and depth (26 layers, local + global units, soft-caps,
   post-norms, tied 256000-column embeddings; seed 0) serves phase 4's
   trace with a bf16
   pool greedy, an int8 pool and WTA sampling, each through the compiled
   engine and eagerly (streams and launches equal, profiled ticks); then
   two prompts of 4500 and 5000 tokens decode at positions past its local
   window of 4096 (eager, ``max_len`` 6144), the first decode step's local
   and global attention outputs held against the plain versions on the
   same card tensors (:func:`long_context`); then deepseek-coder-33b cut to
   8 layers and nemotron-4-340b cut to 2, at full width: four requests
   each, compiled = eager, peak device memory printed (:func:`cut_serve`).
4h. hybrid (:func:`hybrid_phase`, run after 4g): recurrentgemma-2b at full
   width and depth (26 layers: 18 RG-LRU blocks and 8 MQA local-attention
   layers of H 10 / Hkv 1 / Dh 256, window 2048; tied 256000-column
   embeddings; seed 0, bf16, each block's output projection scaled by 8
   so that the streams read the recurrent state).  (a) Phase 4's trace and ``ServeConfig``
   with a bf16 pool greedy, an int8 pool, WTA sampling and WTA on the int8
   pool, each compiled = eager in streams and launches (decode attention
   8 launches a step), profiled ticks; the device ms a tick of the f32
   casts of every block's gate weights.  (d) Two prompts of 2300 and 2600
   tokens decode past the window (eager), the first step's two local
   layers held against the plain version on the same card tensors.  (e)
   Both attention kernels at its head over bf16, int8 and f32 pools (B = 8
   over W = 32, S = 128; and B = 8 over W = 160 past the window, bf16),
   checked, timed beside the byte bound and SDPA, geometry printed; the
   int8 write at Hkv 1 / Dh 256.  On an f32 copy of its first 13 layers:
   (b) the four shared-prefix prompts with and without prefix sharing,
   equal streams, a partial hit resuming at a chunk boundary from its
   stashed state snapshot (each read counted); (c) two forced preempts
   (spill bytes, pages plus state, spill and restore ms) and speculation
   at k = 3 with forced rejections (rollbacks of the recurrent state),
   each equal to its plain serve.  (f) One ``analog_stochastic`` training
   step at full width and depth: ``sigmoid_sample`` launched twice a
   recurrent layer (the RG-LRU gates), the first draw equal to the plain
   version's, ``crossbar_mac`` 7 reads an attention layer and 5 a
   recurrent one, each count twice over the step (the backward recomputes
   every unit, ``remat_policy`` "nothing"), the first read at each of its four (W shape, read
   kind) held against the plain version on the same x, W and key; step
   ms and peak memory.  Prints its wall time.
4i. ssm (:func:`ssm_phase`, run after 4h): mamba2-1.3b at full width and
   depth (48 Mamba-2 mixers, d 2048, d_inner 4096, 64 heads of 64, state
   128, SSD chunk 256, tied 50280-column embeddings; seed 0, bf16;
   attention-free, so its paged cache holds no K/V pool, only each slot's
   ``ssm_conv`` and ``ssm_state``).  (a) Phase 4's trace and
   ``ServeConfig`` greedy and WTA, each compiled = eager in streams and
   launches, profiled ticks, no attention kernel and no int8 write
   launched, ``wta_sample`` = ticks + first tokens; an int8 config
   (compiled) gives the greedy streams (it has no pool); whether zeroing
   ``ssm_state`` before a decode step moves the logits and the next
   token; the device ms a tick of the SSM state update beside its byte
   bound.  (b) One prompt of 2048 tokens prefilled in chunks of 128
   against one whole-bucket prefill: the final state and last logits
   within 1e-3 of their largest magnitude in f32 (gated) and in bf16
   (printed).  On an f32 copy of its first 12 layers, out_proj x 8 and
   the D skip 0 (so that the streams read the state): (c) the four
   shared-prefix prompts with and without sharing (a partial hit resumes
   at 128 from its snapshot, each read counted), two forced preempts
   (spill records of the state alone, their bytes, spill and restore ms)
   and speculation at k = 3 with forced rejections, each equal to its
   plain serve.  (d) One ``analog_stochastic`` training step at full
   width and depth: ``crossbar_mac`` 2 reads a layer, twice over the step
   (192 + 192 prepasses),
   no ``sigmoid_sample``, the first read at each of its two shapes held
   against the plain version; step ms and peak memory.  (e), in phase 7:
   the smoke config in f32, prefill and decode logits card against CPU
   within REF_ATOL and the engine's greedy streams equal.  Prints its
   wall time.
4j. moe (:func:`moe_phase`, run after 4i): granite-moe-3b-a800m at full
   width and depth (32 layers, d 1536, H 24 / Hkv 8 / Dh 64, 40 SwiGLU
   experts of d_ff 512, top-8, GShard capacity dispatch at factor 1.25,
   tied 49155-column embeddings; seed 0, bf16).  (a) Phase 4's trace and
   ``ServeConfig`` greedy, int8 and WTA, each compiled = eager in streams
   and launches, profiled ticks (decode attention 32 a step, prefill 32 a
   chunk, one int8 write an attention launch, ``wta_sample`` = ticks +
   first tokens); the device ms a tick of the MoE sublayers apart
   (router, dispatch, expert products, combine) beside the products'
   bound; the share of the trace's prefill assignments the capacity
   drops, counted from the dispatch's ``kept``.  (b) Both attention
   kernels at granite's head (G 3, Dh 64) and grok-1-314b's (H 48 / Hkv
   8 / Dh 128, G 6, soft-cap 30) over bf16, int8 and f32 pools, checked,
   timed beside the byte bound and SDPA (none where soft-capped), the
   int8 write at Hkv 8 / Dh 64 and 128.  On an f32 copy of granite's first 8
   layers at the drop-free capacity factor 5.0: (c) sharing on = off with
   partial hits, a 2048-token prompt prefilled in chunks of 128 against
   whole (the next token equal, logits within 1e-3 of their largest,
   nothing dropped; then at factor 1.25, printed), two forced preempts
   and speculation at k = 3 with forced rejections, each equal to its
   plain serve.  (d) One ``analog_stochastic`` training step at full
   width and depth: ``crossbar_mac`` 4 reads a layer, twice over the step
   (256 + 256 prepasses), the router's WTA race 64 ``wta_sample`` launches (its
   first draw equal to the plain version's), no ``sigmoid_sample``, the
   first read at each of its two shapes checked and timed; finite loss
   and aux, step ms, peak memory.  (e) grok-1-314b at full width cut to 4
   of 64 layers: compiled = eager, init time, peak memory, a profiled
   replayed tick against its byte bound.  (f), in phase 7: both smoke
   configs in f32, card against CPU (logits within REF_ATOL, streams
   equal).  Prints its wall time.
4k. encdec (:func:`encdec_phase`, run after 4j): whisper-small at full
   width and depth (12 + 12 layers, d 768, H 12 of 64, GELU d_ff 3072,
   tied 51865-column head; seed 0, bf16), served by the dense step alone,
   as the reference serves it.  ``wta_sample`` at its head, (4, 51865)
   and the first token's (1, 51865), counts and decisions equal to the
   plain version's.  (a) 8 requests of 1500 std-1 frame embeddings (30 s
   of audio) and a 4-token prompt, each prefilled alone (B = 1, max_len
   448), inserted into a slot of a 4-wide dense cache by
   ``make_cache_insert``, decoded to 64 new tokens through
   ``DenseGraphs`` in two waves; greedy and WTA, each compiled and eager
   with equal streams and launches (``wta_sample`` one a step and one a
   first token, no attention kernel); prefill and step ms, tokens/s, peak
   memory, a profiled replayed step against its byte bound, the f32 casts
   of ``ck`` / ``cv`` a step; whether zeroing them moves the logits and
   the next token.  (b) An f32 copy: prefill + 8 decode steps against
   ``decode_train``'s forward, logits within 1e-4 of their largest,
   greedy tokens equal.  (c) One ``analog_stochastic`` step at batch 8 x
   128: ``crossbar_mac`` 6 reads an encoder layer and 10 a decoder layer,
   twice over the step (each layer is checkpointed: 384 + 384 prepasses), no ``sigmoid_sample`` or ``wta_sample``, the
   first read at each of its three shapes checked and timed; finite
   loss, step ms, peak memory.  (d), in phase 7: the smoke config in f32,
   card against CPU.  Prints its wall time.
4l. vlm (:func:`vlm_phase`, run after 4k): llava-next-34b at full width
   (d 7168, H 56 / Hkv 8 / Dh 128, SwiGLU d_ff 20480, V 64000) cut to 8 of
   60 layers (seed 0, bf16).  (a) Served as a token LM, as the reference
   serves it (:func:`cut_serve`): compiled = eager, decode attention 8 a
   step and prefill 8 a chunk, init time, peak memory, a profiled tick
   against its byte bound.  (b) Two requests of 576 patch embeddings
   (x 0.02) and 448 prompt tokens through the dense prefill with
   ``patches`` (1024 positions) and 8 decode steps, against
   ``lm_forward(..., prefix_embeds)``: bf16 logits within 2^-5 of their
   largest; on an f32 copy of the first 2 layers within 1e-4, greedy
   tokens equal.  (c), in phase 7: the smoke config in f32, card against
   CPU (the patch prefix's logits, the paged engine's streams).  Prints
   its wall time.
4m. dry run (:func:`dryrun_phase`, run after 4l): (a) the meta counts of
   ``launch/dryrun.py`` against the card at three stablelm-3b cells that
   fit it: a digital train step at 8 x 128 (``remat_policy`` "nothing",
   one microbatch), the dense prefill at 4 x 2048, the dense decode step
   at 8 x 4096 (``dryrun.measure_step``): the inputs' bytes and the
   step's peak over the allocation before it each within 10% of the
   allocator's (``memory_allocated``, ``max_memory_allocated``; the step
   run once before), ``FlopCounterMode`` on the card equal to the meta
   count; the step's ms beside its roofline bound (printed).  (b)
   ``remat_policy`` on the card: one forward and backward of stablelm-3b
   at 8 x 128 under "full", "dots" and "nothing", ``analog_stochastic``:
   losses equal, every gradient within 1e-6 of its leaf's largest,
   ``crossbar_mac`` reads and prepasses exactly 224 ("full") and 448;
   digital: the peaks ordered "nothing" < "dots" < "full" (analog: every
   projection is a crossbar read, no product "dots" keeps, so "dots" and
   "nothing" below "full"); the peaks and ms printed.  (c) The seam:
   ``ops.stoch_round`` on the card bit-equal to ``stoch_round_reference``
   on the card at steps 1 and 0.25 over a (4, 1000, 300) and a 2048²
   input, its gradient the in-range mask, timed at 2048² beside its
   bound; ``ops.wta_counts`` against ``wta_counts_reference`` on the card
   in more than 0.9995 of counts.
4e. loop (:func:`loop_phase`): (a) ``examples/train_lm_torch.py``'s
   stablelm-100m at batch 8 x 256, full depth, 12 steps through
   ``train.loop.run`` with a checkpoint every 4, clean and again with a
   fault before step 9, digital and analog: exactly one restart, final
   parameters and moments within atol 1e-6, rtol 1e-5 of the clean run's
   (bit-equality printed), the analog runs' ``crossbar_mac`` launches
   56 a step; step ms, checkpoint bytes, each save's host-gather and
   write ms, the restart's init and load ms.  (b) 15 steps of
   stablelm-100m with int8 gradient compression against without: both
   fall, the last three within 0.25; the compression's device ms a step
   (profiler, its ``train/compress`` range).  (c) a params-only
   checkpoint of the smoke config served greedy by ``serve.py
   --ckpt-dir``: the streams of serving the parameters directly.  (d)
   ``repro_torch.benchmarks.run``'s six benches at the reference's
   protocol, gated on their relations (Fig. 4's calibrated rmse < 0.02
   and < detuned x4, Fig. 5's one winner a trial and argmax agreement at
   every T, Fig. 6's 64 votes >= 1 vote, Table I within 0.05 points of the
   paper; the serving bench's report through ``validate_report``'s checks,
   its speculative floor printed, :func:`check_serving_report`);
   ``bench_kernels``' shapes are timed as phase 3 times kernels beside
   their bounds, plain versions and SGEMM, right after phase 3 (late in
   the process the profiler dropped events from those traces).  (f)
   ``examples/quickstart_torch.py`` (E[comparator] against the
   range-quantized layer's sigmoid: mean error <= 0.1, max <= 0.156; WTA
   predictions agree) and ``examples/serve_stochastic_torch.py`` with a
   bf16 and an int8 pool.  Each path's kernel launches, reset just before
   it and read just after, must be > 0.  (e) runs in phase 6b.
5. entry points: ``ops.stoch_round_serving`` on the 2048² quantizer row
   and ``ops.wta_counts`` at the serving head's operating point (8 ×
   50304, 32 trials); each kernel's launches, reset just before and read
   just after, must be > 0.  Then through ``use_backend(FaultySimBackend)``
   (:func:`faulty_phase`): ``ops.crossbar_mac`` at the (1024, 2560) x
   (2560, 2560) training read with 0.1% stuck cells and drift at clock
   100 (the faulty weights equal the plain-torch transform on the card
   bit for bit, the CPU's within an ulp budget, the read within the
   linear gate of its plain version on them), and
   ``ops.wta_counts`` at the serving head with a comparator offset and
   read-noise inflation (within its agreement bound of the plain version
   at the shifted operating point).
6. train: RACA analog training (``--analog``) of stablelm-3b at full width
   and depth, batch 8 x 128, TRAIN_STEPS (2) steps through ``make_train_step``: finite
   losses, parameters changed, ``crossbar_mac`` launched 448 reads and
   448 prepasses per step (224 in the forward, again in the backward's
   recompute; reset just before, read just after); step
   time, tokens/s, peak memory and a profiled step's split.
6b. FCNN: fcnn-mnist [784, 500, 300, 10] trained at full width through
   ``make_train_step`` (300 steps of batch 128, lr 3e-3, f32 moments,
   seed 0), then Fig. 6's protocol on 1024 images: digital accuracy and
   RACA accuracy at 1 / 4 / 16 / 64 votes beside the reference's CPU
   numbers; ``sigmoid_sample`` and ``wta_sample`` launched exactly 2 and 1
   times a vote (reset just before, read just after); accuracy gates of
   ``tests/test_system.py``; phase 4e (e): Fig. 6's threshold and SNR
   sweeps at 16 votes (V_th0 = 0, calibrated; beta = 2), 96 and 48
   launches; a profiled training step and 64-vote prediction.
7. reference: smoke-size prefill and decode logits on the card (kernels)
   agree with the same model on the CPU (plain versions), for a float and
   an int8 pool (whose written codes must agree too); two smoke-size
   analog training steps agree card vs CPU (losses, comparator
   decisions); a smoke-size WTA serve (R = 1 and 3; eager on the card,
   so that its sampler calls can be recorded) gives the same streams on
   the card and on the CPU (a divergence is printed with both sides'
   votes at it, and fails); five smoke FCNN training steps and its
   predictions agree card vs CPU; 4i (e), 4j (f), 4k (d) and 4l (c).

The second-to-last line is the ``kernels`` JSON record; the last is
``{"ok": true, "device": {...}}``.  With ``--ab DIR`` only phases 1-2 run,
then :func:`ab_phase` holds DIR's wta_counts and stoch_round kernels
against this checkout's (outputs equal, device and per-call times in
turns).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import types
from typing import Optional
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor rate
# H100 SXM special-function rate: 16 results per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz maximum boost clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# Kernel vs plain version: both accumulate in f32 from the same bf16/int8
# inputs and differ only in summation order and exp rounding (~1e-6
# relative); 2e-3 absolute and relative leaves room for int8 scores.
ATOL = RTOL = 2e-3
# Smoke-size f32 model, card (kernels, cuBLAS) vs CPU (plain versions).
REF_ATOL = 1e-4
# The same with an int8 pool.  Codes are bit-exact for equal f32 inputs,
# but K/V rows differ between cuBLAS and the CPU at f32 rounding (~1e-7
# relative), so an element within that distance of its rounding draw takes
# the neighbouring code: ~1e-5 per element, ~0.1 flips expected in the
# ~11k live codes.  Gate: at least 99.95% of the pool's codes equal, none
# more than one level apart; logits within 2e-2, since one flipped live
# code moved logits by up to ~3e-3 in a CPU trial at this size.
REF_INT8_CODES = 0.9995
REF_INT8_ATOL = 2e-2
# wta_counts kernel vs plain version: Gaussians through logf/cosf on both
# sides, so a trial can flip only where two voltages race within an ulp.
# Gate: equal row sums, and sum|Δcounts| <= 2 x 1% of the B·T decisions.
WTA_FLIP_FRACTION = 0.01
WTA_VTH0, WTA_SIGMA = 1.702**2, 1.702   # the serving head's operating point
# wta_sample kernel vs plain version on the card: both draw with CUDA's
# log1pf and round every other step once, so the bits, uniforms, normals,
# counts and decisions must be equal, as they were in every run.  Card vs
# CPU smoke WTA serve: token streams equal.
# Issue estimate: one warp instruction per scheduler per clock, 132 SMs x
# 4 schedulers x 1.98 GHz; a warp instruction holds the 16-lane ALU or FMA
# heavy pipe 2 clocks and the 4-lane XU (MUFU, conversions) 8 clocks.
ISSUE_PER_S = 132 * 4 * 1.98e9
# H100 SXM f32 FMA rate on the CUDA cores: 132 SMs x 128 lanes x 2 x 1.98 GHz
F32_FLOPS_PER_S = 132 * 128 * 2 * 1.98e9
# crossbar_mac vs its plain version: the quantized weights and the noise are
# bit-identical, the f32 products are summed in another order (the plain
# version's is cuBLAS's).  Linear readout: |Δ| <= 2·sqrt(K)·2**-24 times
# Σ_k |x_k·Wq_k| per element (twice the random-walk size of an f32 sum's
# rounding), and, with the physical noise model (σ from ΣWq, summed in
# another order too), 1e-5 of |out| besides.  Comparator readout: at least
# 99.95% of the decisions equal (tests/test_kernels.py:57's agreement).
CB_AGREEMENT = 0.9995
# stablelm-3b analog training: 7 crossbar reads per layer and forward
# (wq wk wv wo w_down linear, w_up w_gate binarized), none in the backward
# but the forward's again where it recomputes the unit (remat_factor)
CB_PER_LAYER = 7
TRAIN_STEPS = 2
# Smoke-size analog training, card vs CPU: the comparator decisions may
# flip where z + noise sits within f32 rounding of 0 (gate: >= 99.9% of the
# binary activations equal); a flipped hidden unit moves one token's loss
# by ~1e-2 at this size, so the mean loss gets 1e-3.
REF_TRAIN_AGREEMENT = 0.999
REF_TRAIN_LOSS_ATOL = 1e-3
# The paper's FCNN (fcnn-mnist [784, 500, 300, 10]), examples/
# train_mnist_raca.py's protocol: 300 steps of batch 128, lr 3e-3, f32
# moments without stochastic rounding, seed 0; Fig. 6's test set of 1024
# images, RACA votes under PRNGKey(7).  The reference's numbers for that
# protocol, run through repro on a CPU (examples/train_mnist_raca.py's
# log): loss 2.5568 at step 0 and 0.1208 at step 280, digital 0.9512,
# RACA 0.7754 / 0.8828 / 0.9365 / 0.9424 at 1 / 4 / 16 / 64 votes.
FCNN_STEPS, FCNN_BATCH, FCNN_LR, FCNN_TEST = 300, 128, 3e-3, 1024
FCNN_VOTES = (1, 4, 16, 64)
FCNN_REFERENCE_CPU = {"loss": {0: 2.5568, 280: 0.1208}, "digital": 0.9512,
                      "raca": {1: 0.7754, 4: 0.8828, 16: 0.9365, 64: 0.9424}}
# Smoke-size FCNN, card vs CPU: expectation-mode training is f32 products
# in another order (losses within 1e-5); hard votes can flip where u sits
# within ulps of p, so predictions agree on at least 98%.
REF_FCNN_LOSS_ATOL = 1e-5
REF_FCNN_AGREEMENT = 0.98


# the process's start: each phase's header line carries the seconds since
T_START = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("== "):
        msg += f"  [{time.perf_counter() - T_START:.1f} s]"
    print(msg, flush=True)


# Timed calls rotate over this many independent input sets, so that the
# decode pools (42 MB each at full width) do not sit in the 50 MB L2 from
# one call to the next: the serving path meets each layer's pool cold.
ROTATE = 8


def cuda_ms(fns, iters: int = 24, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls
    cycling over ``fns`` (one closure per input set)."""
    for i in range(warmup):
        fns[i % len(fns)]()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fns, iters: int = 24) -> float:
    """Mean device time of one call with the host's time between launches
    left out, which :func:`cuda_ms` includes and which dominates a call
    whose kernel takes a few microseconds.  A spin kernel holds the stream
    while all ``iters`` calls (cycling over ``fns``) are queued behind it,
    so CUDA events around them time the calls' launches back to back.  The
    start event must still be pending once the last call is queued, or the
    spin ran out before the host was done; the spin then grows and the
    window is timed again."""
    fns[0]()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000                      # ~10 ms at the H100's 1.98 GHz
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fns[i % len(fns)]()
        end.record()
        hidden = not start.query()
        torch.cuda.synchronize()
        if hidden:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise AssertionError("the host did not queue the timed calls within the spin")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------


def make_pool(gen, n_pages, bs, hkv, dh, int8, dev):
    shape = (n_pages, bs, hkv, dh)
    if int8:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=gen, device=dev) + 0.1
        vs = torch.rand(shape[:3], generator=gen, device=dev) + 0.1
        return kp, vp, dict(k_scale=ks, v_scale=vs)
    kp = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    return kp, vp, {}


def decode_case(gen, dev, b, h, hkv, dh, bs, w, int8, pos_range=None):
    """Random positions in [0, W·bs) with slot 0 at W·bs - 1, or, given
    ``pos_range``, uniform in that closed range (the serve profile's)."""
    n_pages = b * w + 1
    kp, vp, sc = make_pool(gen, n_pages, bs, hkv, dh, int8, dev)
    q = torch.randn((b, h, dh), generator=gen, device=dev, dtype=torch.bfloat16)
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev)[: b * w] + 1)
    table = table.reshape(b, w).to(torch.int32)
    if pos_range is None:
        pos = torch.randint(0, w * bs, (b,), generator=gen, device=dev, dtype=torch.int32)
        pos[0] = w * bs - 1                   # one slot uses the whole table
    else:
        lo, hi = pos_range
        pos = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    nblk = (pos // bs + 1).clamp(max=w)
    cols = torch.arange(w, device=dev)[None]
    table = torch.where(cols < nblk[:, None], table, -1)  # unassigned ids past pos
    table[min(1, b - 1), 0] = -1              # a live id < 0 reads page 0
    return q, kp, vp, table.contiguous(), pos, sc


def prefill_case(gen, dev, s, q0, h, hkv, dh, bs, w, int8):
    n_pages = w + 2
    kp, vp, sc = make_pool(gen, n_pages, bs, hkv, dh, int8, dev)
    q = torch.randn((s, h, dh), generator=gen, device=dev, dtype=torch.bfloat16)
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:w] + 1).to(torch.int32)
    return q, kp, vp, table.contiguous(), q0, sc


def decode_bound(q, kp, table, pos, sc, local_window=0):
    """Bytes of the pages a slot's keys lie on (a local window's only from
    its first page), q, the output, table and pos; 4 flops a visible key,
    head and dimension."""
    b, h, dh = q.shape
    _, bs, hkv, _ = kp.shape
    nblk = (pos // bs + 1).clamp(max=table.shape[1])
    first = ((pos - local_window + 1).clamp(min=0) // bs) if local_window else 0
    live = int((nblk - first).sum()) * bs  # keys read
    page_bytes = live * hkv * dh * kp.element_size() * 2
    if sc:
        page_bytes += live * hkv * 4 * 2
    nbytes = page_bytes + q.numel() * q.element_size() + b * h * dh * 4 \
        + table.numel() * 4 + pos.numel() * 4
    keys = (pos + 1).clamp(max=table.shape[1] * bs)
    if local_window:
        keys = keys.clamp(max=local_window)
    flops = 4 * int(keys.sum()) * h * dh   # visible keys
    return bound_record(nbytes, flops)


def prefill_bound(q, kp, table, q0, sc):
    s, h, dh = q.shape
    _, bs, hkv, _ = kp.shape
    nblk = min(table.shape[0], (q0 + s - 1) // bs + 1)
    live = nblk * bs
    page_bytes = live * hkv * dh * kp.element_size() * 2
    if sc:
        page_bytes += live * hkv * 4 * 2
    nbytes = page_bytes + q.numel() * q.element_size() + s * h * dh * 4 + table.numel() * 4
    keys = sum(min(q0 + i + 1, live) for i in range(s))
    flops = 4 * keys * h * dh
    return bound_record(nbytes, flops)


def bound_record(nbytes, flops, ops_per_s=BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
        "flops": flops,
    }


def sdpa_decode(q, kp, vp, table, pos):
    """Library yardstick: SDPA over the pre-gathered window (bf16 pools)."""
    import torch.nn.functional as F

    b, h, dh = q.shape
    _, bs, hkv, _ = kp.shape
    ids = table.long().clamp_min(0)
    k = kp[ids].reshape(b, -1, hkv, dh).transpose(1, 2).contiguous()
    v = vp[ids].reshape(b, -1, hkv, dh).transpose(1, 2).contiguous()
    mask = torch.arange(k.shape[2], device=q.device)[None, :] <= pos[:, None].long()
    qq = q[:, :, None, :]
    m = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=m, enable_gqa=hkv != h)


def sdpa_prefill(q, kp, vp, table, q0):
    import torch.nn.functional as F

    s, h, dh = q.shape
    _, bs, hkv, _ = kp.shape
    ids = table.long().clamp_min(0)
    k = kp[ids].reshape(-1, hkv, dh).transpose(0, 1)[None].contiguous()
    v = vp[ids].reshape(-1, hkv, dh).transpose(0, 1)[None].contiguous()
    qpos = q0 + torch.arange(s, device=q.device)[:, None]
    mask = (torch.arange(k.shape[2], device=q.device)[None, :] <= qpos)[None, None]
    qq = q.transpose(0, 1)[None].contiguous()
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask, enable_gqa=hkv != h)


def time_kernel(rec, cases, kernel, plain, library, label) -> dict:
    """Kernel, plain and library times over rotating input sets; each case
    is ``(*args, kwargs)``; ``library`` (or None, where no one PyTorch call
    computes the function) takes the args and returns a closure."""
    def bind(fn, c):
        *args, sc = c
        return lambda: fn(*args, **sc)

    rec["ms"] = cuda_ms([bind(kernel, c) for c in cases])
    rec["device_ms"] = device_ms([bind(kernel, c) for c in cases])
    rec["plain_ms"] = cuda_ms([bind(plain, c) for c in cases])
    rec["library_ms"] = (
        cuda_ms([library(*c[:-1]) for c in cases]) if library is not None else None
    )
    log(f"  {label}: kernel {rec['ms']:.4f} ms per call ({rec['device_ms']:.4f} ms on the "
        f"device), plain {rec['plain_ms']:.4f} ms, library {rec['library_ms']} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, {rec['bytes']} bytes, {rec['flops']} ops)")
    return rec


CASE_KEYS = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "split_device_ms")


def split_sweep(cases, label) -> dict:
    """Device time of the decode kernel at every cluster size, to hold
    decode_geometry's pick against the others (the override is for this
    measurement only)."""
    from repro_torch.kernels import paged_attention as PA

    def bind(c, ns):
        *args, sc = c
        return lambda: PA.paged_attention_cuda(*args, **sc, n_split=ns)

    out = {ns: device_ms([bind(c, ns) for c in cases]) for ns in (1, 2, 4, 8)}
    log(f"  {label}: device ms by n_split " + ", ".join(f"{k}: {v:.4f}" for k, v in out.items()))
    return out


def check(name, got, want, errs):
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, atol=ATOL, rtol=RTOL)
    log(f"  {name}: max|err| {err:.3e} (atol=rtol={ATOL}) {'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    errs.append(err)


def decode_w_invariance(gen, dev) -> dict:
    """Whether one slot's decode attention output is bit-identical at
    every window width W its position allows (W = 8, 16, 32 at positions
    100-127; W = 16, 32 at 200-255) and at two slot indices of the B = 8
    batch (0 and 5): the windows and slots a preempted request meets that
    the unpreempted one did not.  ``decode_geometry`` picks the cluster
    split from W, and another split sums in another order."""
    from repro_torch.kernels import paged_attention as PA

    b, h, hkv, dh, bs = 8, 32, 32, 80, 16
    out = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        kp, vp, sc = make_pool(gen, b * 32 + 1, bs, hkv, dh, int8, dev)
        table = (torch.randperm(b * 32, generator=gen, device=dev) + 1).reshape(b, 32)
        table = table.to(torch.int32)
        q = torch.randn((b, h, dh), generator=gen, device=dev, dtype=torch.bfloat16)
        same, worst = True, 0.0
        for (lo, hi), widths in (((100, 127), (8, 16, 32)), ((200, 255), (16, 32))):
            pos = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
            first = None
            for w in widths:
                for slot in (0, 5):
                    perm = list(range(b))
                    perm[0], perm[slot] = perm[slot], perm[0]
                    o = PA.paged_attention_cuda(q[perm], kp, vp, table[perm, :w].contiguous(),
                                                pos[perm], **sc)[slot]
                    if first is None:
                        first = o
                    same &= torch.equal(o, first)
                    worst = max(worst, float((o - first).abs().max()))
        splits = {w: PA.decode_geometry(b, h, hkv, dh, bs, w, kp.dtype)["n_split"]
                  for w in (8, 16, 32)}
        out[tag] = {"identical": bool(same), "max_abs_diff": worst, "n_split": splits}
        log(f"  decode {tag}, one slot at W = 8/16/32 and slots 0/5: bit-identical {same} "
            f"(max|diff| {worst:.3e}); n_split by W {splits}")
    return out


def verify_case(gen, dev, b, k, w, int8, pos_range):
    """A speculative verify's decode attention: k·B rows, row (j, s) slot
    s's query at position pos_s + j over slot s's table row (the table
    tiled k times), every page of the window live.  Returns the case and
    the k draft calls' (q, table, pos) it re-reads."""
    bs, h, dh = 16, 32, 80
    n_pages = b * w + 1
    kp, vp, sc = make_pool(gen, n_pages, bs, 32, dh, int8, dev)
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).reshape(b, w)
    table = table.to(torch.int32).contiguous()
    lo, hi = pos_range
    pos = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    q = torch.randn((k * b, h, dh), generator=gen, device=dev, dtype=torch.bfloat16)
    vpos = (pos.repeat(k) + torch.arange(k, device=dev, dtype=torch.int32).repeat_interleave(b))
    drafts = [(q[j * b:(j + 1) * b], table, (pos + j).to(torch.int32)) for j in range(k)]
    return (q, kp, vp, table.repeat(k, 1).contiguous(), vpos.contiguous(), sc), drafts


def verify_bound(q, kp, table, pos, sc, b):
    """Bytes a verify must move: each slot's live pages once (its k rows
    share them), the k·B queries, outputs, table rows and positions; the
    operations of every row's unmasked keys."""
    kb, h, dh = q.shape
    _, bs, hkv, _ = kp.shape
    last = pos.reshape(-1, b).amax(dim=0)
    live = int((last // bs + 1).clamp(max=table.shape[1]).sum()) * bs
    nbytes = live * hkv * dh * kp.element_size() * 2 + (live * hkv * 4 * 2 if sc else 0)
    nbytes += q.numel() * q.element_size() + kb * h * dh * 4 + table.numel() * 4 + kb * 4
    keys = int((pos + 1).clamp(max=table.shape[1] * bs).sum())
    return bound_record(nbytes, 4 * keys * h * dh)


def verify_rows(gen, dev, errs, timing) -> dict:
    """The speculative verify's decode attention at the main path's shape
    (B = 8 slots, k = 4: 32 rows, bf16 and int8 pools): first whether each
    verify row is bit-equal to the draft row that computed the same
    (slot, position) at B = 8, at W = 8, 16 and 32, launched as the round
    launches it (``split_batch`` = 8: the draft batch's cluster split) and
    with the split the kernel would pick for 32 rows; then, at W = 32,
    against its plain version, timed beside its byte bound and SDPA."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref

    b, k = 8, 4
    out = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        res = {"split_identical": True, "own_identical": True, "own_max_abs_diff": 0.0,
               "n_split": {}}
        for w, pr in ((8, (100, 124)), (16, (200, 252)), (32, (300, 508))):
            (q, kp, vp, table, vpos, sc), drafts = verify_case(gen, dev, b, k, w, int8, pr)
            want = torch.cat([PA.paged_attention_cuda(dq, kp, vp, dt, dp, **sc)
                              for dq, dt, dp in drafts])
            got = PA.paged_attention_cuda(q, kp, vp, table, vpos, split_batch=b, **sc)
            own = PA.paged_attention_cuda(q, kp, vp, table, vpos, **sc)
            res["split_identical"] &= torch.equal(got, want)
            res["own_identical"] &= torch.equal(own, want)
            res["own_max_abs_diff"] = max(res["own_max_abs_diff"], float((own - want).abs().max()))
            res["n_split"][w] = (PA.decode_geometry(b, 32, 32, 80, 16, w, kp.dtype)["n_split"],
                                 PA.decode_geometry(k * b, 32, 32, 80, 16, w, kp.dtype)["n_split"])
        log(f"  verify {tag} (32 rows = 4 steps x 8 slots) against its draft rows at W = 8/16/32: "
            f"bit-identical with the draft's split {res['split_identical']}, with its own "
            f"{res['own_identical']} (max|diff| {res['own_max_abs_diff']:.3e}); n_split (draft "
            f"B = 8, own 32 rows) by W {res['n_split']}")
        if not res["split_identical"]:
            raise AssertionError(f"verify {tag}: rows launched with the draft's split differ "
                                 "from their draft rows")
        cases = []
        for _ in range(ROTATE):
            case, _ = verify_case(gen, dev, b, k, 32, int8, (300, 508))
            cases.append(case)
        q, kp, vp, table, vpos, sc = cases[0]
        args = (q, kp, vp, table, vpos)

        def kernel(*a, **kw):
            return PA.paged_attention_cuda(*a, split_batch=b, **kw)

        check(f"decode {tag} verify 32 rows W=32", kernel(*args, **sc),
              ref.paged_attention_ref(*args, **sc), errs)
        geo = PA.decode_geometry(b, 32, 32, 80, 16, 32, kp.dtype)
        timing[tag] = time_kernel(
            verify_bound(q, kp, table, vpos, sc, b), cases, kernel, ref.paged_attention_ref,
            None if int8 else sdpa_decode,
            f"decode {tag} verify 32 rows W=32 (n_split {geo['n_split']} of B = 8)")
        out[tag] = res
    return out


def kernel_phase(dev) -> dict:
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"decode": [], "prefill": []}
    timing = {}
    w_invariance = decode_w_invariance(gen, dev)
    verify_timing = {}
    verify = verify_rows(gen, dev, errs["decode"], verify_timing)
    # full width: stablelm-3b heads (H = Hkv = 32, Dh = 80), bs = 16
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        # B=8 over W=32 (random positions, one slot at the end: the main
        # record), one slot over the whole window (the old grid used 32 of
        # 132 SMs), and the serve profile's eight slots at positions
        # 100-130 (W=16); each also timed at every cluster size
        extra = []
        for label, b, w, pr in (("B=8 W=32", 8, 32, None), ("B=1 W=32", 1, 32, None),
                                ("B=8 W=16 pos 100-130", 8, 16, (100, 130))):
            cases = [decode_case(gen, dev, b, 32, 32, 80, 16, w, int8, pr) for _ in range(ROTATE)]
            q, kp, vp, table, pos, sc = cases[0]
            args = (q, kp, vp, table, pos)
            geo = PA.decode_geometry(b, 32, 32, 80, 16, w, kp.dtype)
            check(f"decode {tag} {label}", PA.paged_attention_cuda(*args, **sc),
                  ref.paged_attention_ref(*args, **sc), errs["decode"])
            rec = time_kernel(
                decode_bound(q, kp, table, pos, sc), cases,
                PA.paged_attention_cuda, ref.paged_attention_ref,
                None if int8 else sdpa_decode,
                f"decode {tag} {label} (n_split {geo['n_split']}, grid {geo['grid']})",
            )
            rec["split_device_ms"] = split_sweep(cases, f"decode {tag} {label}")
            if label == "B=8 W=32":
                timing[("decode", tag)] = rec
            else:
                extra.append({"case": f"{tag} {label}", **{k: rec[k] for k in CASE_KEYS}})
        rec = verify_timing[tag]
        extra.append({"case": f"{tag} verify 32 rows (k = 4 x B = 8) W=32, split of B = 8",
                      **{k: rec.get(k) for k in CASE_KEYS}})
        timing[("decode", tag)]["cases"] = extra
        for q0 in (0, 128):
            cases = [prefill_case(gen, dev, 128, q0, 32, 32, 80, 16, 16, int8)
                     for _ in range(ROTATE if q0 else 1)]
            q, kp, vp, table, _, sc = cases[0]
            args = (q, kp, vp, table, q0)
            check(f"prefill {tag} S=128 q0={q0}", PF.paged_prefill_attention_cuda(*args, **sc),
                  ref.prefill_attention_ref(*args, **sc), errs["prefill"])
        timing[("prefill", tag)] = time_kernel(
            prefill_bound(q, kp, table, 128, sc), cases,
            PF.paged_prefill_attention_cuda, ref.prefill_attention_ref,
            None if int8 else sdpa_prefill, f"prefill {tag} S=128 q0=128",
        )
    # small cases: GQA, local windows, soft-capping, f32 queries on int8
    for kind, lw, cap, hkv in (("global", 0, 30.0, 8), ("local", 37, 0.0, 4), ("local", 20, 50.0, 32)):
        kw = dict(kind=kind, local_window=lw, softcap=cap)
        for int8 in (False, True):
            tag = f"{kind} lw={lw} cap={cap} Hkv={hkv} {'int8' if int8 else 'bf16'}"
            q, kp, vp, table, pos, sc = decode_case(gen, dev, 3, 32, hkv, 80, 16, 8, int8)
            if int8:
                q = q.float()
            args = (q, kp, vp, table, pos)
            check(f"decode {tag}", PA.paged_attention_cuda(*args, **kw, **sc),
                  ref.paged_attention_ref(*args, **kw, **sc), errs["decode"])
            q, kp, vp, table, _, sc = prefill_case(gen, dev, 37, 45, 32, hkv, 80, 16, 6, int8)
            args = (q, kp, vp, table, 45)
            check(f"prefill {tag}", PF.paged_prefill_attention_cuda(*args, **kw, **sc),
                  ref.prefill_attention_ref(*args, **kw, **sc), errs["prefill"])
    torch.cuda.synchronize()
    timing["stoch_round"], errs["stoch_round"] = stoch_round_kernels(gen, dev)
    timing["wta_counts"], errs["wta_counts"] = wta_kernels(gen, dev)
    (timing["crossbar_mac"], timing["crossbar_prepass"], errs["crossbar_mac"],
     errs["crossbar_prepass"]) = crossbar_kernels(gen, dev)
    timing["write_kv_int8"], errs["write_kv_int8"] = write_kernels(gen, dev)
    timing["wta_sample"], errs["wta_sample"] = wta_sample_kernels(gen, dev)
    timing["sigmoid_sample"], errs["sigmoid_sample"] = sigmoid_sample_kernels(gen, dev)
    timing["head_shapes"] = head_shape_kernels(gen, dev, errs, HEAD_CASES)
    timing["head_shapes"]["wta_sample"] = wta_head_cases(gen, dev, errs)
    return {"errs": errs, "timing": timing, "w_invariance": w_invariance, "verify": verify}


# the decoder configs beside stablelm-3b: (arch, (H, Hkv, Dh), the local
# layers decoded on the bf16 pool beside the global one: (window, soft-cap,
# W pages, slots' positions or None))
HEAD_CASES = (("gemma2-2b", (8, 4, 256), [(300, 50.0, 32, None)]),
              ("deepseek-coder-33b", (56, 8, 128), []),
              ("nemotron-4-340b", (96, 8, 192), []))


def as_f32_case(c):
    """A decode or prefill case with its queries and pool in f32."""
    q, kp, vp, table, p, sc = c
    return q.float(), kp.float(), vp.float(), table, p, sc


def geometry_line(geo: dict) -> str:
    keys = ("route", "grid", "n_split", "warps", "stages", "smem_bytes", "ctas_per_sm")
    return ", ".join(f"{k} {geo[k]}" for k in keys if k in geo)


def head_shape_kernels(gen, dev, errs, heads) -> dict:
    """Both attention kernels at each head of ``heads`` ((arch, (H, Hkv,
    Dh), local layers[, the global layer's attention soft-cap]), as
    HEAD_CASES; bs = 16): decode of B = 8 slots over
    W = 32 pages and a 128-query prefill chunk at q0 = 128, over bf16 and
    int8 pools with bf16 queries and over an f32 pool with f32 queries,
    and each local layer's decode on the bf16 pool (its window and
    soft-cap, over its W pages, its slots past the window where positions
    are given); each against its plain version (within ATOL / RTOL),
    timed beside its bound and, on float pools, SDPA; each launch's
    geometry printed.  Then the fused int8 write at each head's kv heads
    (bit for bit).  Returns {"decode", "prefill", "write_kv_int8"}: lists
    of case records."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import ref

    log_ptxas(*(f"prefill_tc_kernel<{t},{d}>" for t in ("bf16", "int8")
                for d in sorted({head[1][2] for head in heads})))
    out = {"decode": [], "prefill": [], "write_kv_int8": []}

    def record(key, label, geo, rec):
        out[key].append({"case": label, "geometry": geo, **{k: rec.get(k) for k in CASE_KEYS}})

    for arch, (h, hkv, dh), local, *extra in heads:
        cap0 = extra[0] if extra else 0.0
        for pool in ("bf16", "int8", "f32"):
            int8 = pool == "int8"
            to = as_f32_case if pool == "f32" else (lambda c: c)
            layers = [("global", 0, cap0, 32, None)]
            if pool == "bf16":
                layers += [("local", *layer) for layer in local]
            for kind, lw, cap, w, pos_range in layers:
                kw = dict(kind=kind, local_window=lw, softcap=cap)
                cases = [to(decode_case(gen, dev, 8, h, hkv, dh, 16, w, int8, pos_range))
                         for _ in range(ROTATE)]
                q, kp, vp, table, pos, sc = cases[0]
                args = (q, kp, vp, table, pos)
                geo = PA.decode_geometry(8, h, hkv, dh, 16, w, kp.dtype)
                label = f"{arch} {pool} B=8 W={w}" + (f" {kind} {lw} cap {cap}" if lw else "") + (
                    f" soft-cap {cap}" if cap and not lw else "")
                if pos_range is not None:
                    label += f" at positions {pos_range[0]}-{pos_range[1]}"
                check(f"decode {label}", PA.paged_attention_cuda(*args, **kw, **sc),
                      ref.paged_attention_ref(*args, **kw, **sc), errs["decode"])
                rec = time_kernel(
                    decode_bound(q, kp, table, pos, sc, lw),
                    [(*c[:-1], {**c[-1], **kw}) for c in cases],
                    PA.paged_attention_cuda, ref.paged_attention_ref,
                    None if int8 or lw or cap else sdpa_decode,
                    f"decode {label} ({geometry_line(geo)})")
                record("decode", label, geo, rec)
            cases = [to(prefill_case(gen, dev, 128, 128, h, hkv, dh, 16, 16, int8))
                     for _ in range(ROTATE)]
            q, kp, vp, table, _, sc = cases[0]
            args = (q, kp, vp, table, 128)
            geo = PF.prefill_geometry(128, h, hkv, dh, 16, q.dtype, kp.dtype)
            label = f"{arch} {pool} S=128 q0=128" + (f" soft-cap {cap0}" if cap0 else "")
            kw = dict(softcap=cap0) if cap0 else {}
            check(f"prefill {label}", PF.paged_prefill_attention_cuda(*args, **kw, **sc),
                  ref.prefill_attention_ref(*args, **kw, **sc), errs["prefill"])
            rec = time_kernel(prefill_bound(q, kp, table, 128, sc),
                              [(*c[:-1], {**c[-1], **kw}) for c in cases],
                              PF.paged_prefill_attention_cuda, ref.prefill_attention_ref,
                              None if int8 or cap0 else sdpa_prefill,
                              f"prefill {label} ({geometry_line(geo)})")
            record("prefill", label, geo, rec)
        rec, werr = write_kernels(gen, dev, hkv, dh)
        errs["write_kv_int8"] += werr
        out["write_kv_int8"] += [{"case": f"decode write, 8 slots Hkv={hkv} Dh={dh}",
                                  **{k: rec.get(k) for k in CASE_KEYS}}] + rec["cases"]
    return out


def wta_head_cases(gen, dev, errs) -> list:
    """``wta_sample`` at the 256000- and 32256-column heads (counts and
    decisions equal); its case records."""
    out = []
    for c, arch in ((256000, "gemma2-2b, nemotron-4-340b"), (32256, "deepseek-coder-33b")):
        case = wta_sample_case(gen, dev, 8, c, torch.bfloat16, layout="per slot")
        check_wta_sample(f"(8, {c}) T=32 per-slot keys, step ({arch})", *case, 32,
                         errs["wta_sample"])
        out.append({"case": f"(8, {c}) T=32 bf16, checked", "columns": c})
    return out


def stoch_round_kernels(gen, dev):
    """stoch_round vs its plain version, bit for bit, at the int8 decode
    write's rows (8 slots x 32 kv heads of Dh=80), the int8 prefill
    chunk's (8 blocks of 16 x 32 rows, one seed each) and bench_kernels.py's
    2048² row on the 2/31 grid, the shape its entry point runs here; times
    at each.  Returns (2048² record, max|err| list)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import stoch_round as SR

    def kv_rows(rows):  # the quantizer's input: x / max|x| · 127 per row
        x = torch.randn((rows, 80), generator=gen, device=dev)
        return x / x.abs().amax(-1, keepdim=True).clamp_min(1e-6) * 127.0

    def seeds(n):
        return torch.randint(0, 2**32, (n,), generator=gen, device=dev, dtype=torch.int64)

    def offset_by_one(x):   # the same values one element into their storage
        flat = torch.empty(x.numel() + 1, device=dev)
        y = flat[1:].view(x.shape)
        y.copy_(x)
        return y

    log_ptxas("stoch_round_kernel")
    cases = [
        ("decode write (8*32, 80), 1 seed", kv_rows(8 * 32), seeds(1), 1.0, -127.0, 127.0),
        ("prefill chunk 8 x (16*32, 80), 8 seeds", kv_rows(8 * 16 * 32), seeds(8), 1.0, -127.0, 127.0),
        ("quantizer (2048, 2048) step 2/31", torch.randn((2048, 2048), generator=gen, device=dev),
         seeds(1), 2.0 / 31, -1.0, 1.0),
        ("quantizer (2048, 2048) at storage offset 1",
         offset_by_one(torch.randn((2048, 2048), generator=gen, device=dev)), seeds(2),
         2.0 / 31, -1.0, 1.0),
    ]
    recs, errs = [], []
    for label, x, sd, step, lo, hi in cases:
        kw = dict(step=step, lo=lo, hi=hi)
        geo = SR.stoch_round_geometry(*x.shape)
        log(f"  stoch_round {label}: {geo.blocks} CTAs of {geo.ty} rows x {geo.tx} threads")
        got, want = SR.stoch_round_cuda(x, sd, **kw), ref.stoch_round_ref(x, sd, **kw)
        same = torch.equal(got, want)
        errs.append(float((got - want).abs().max()))
        log(f"  stoch_round {label}: bit-identical {same}, max|err| {errs[-1]:.3e}")
        if not same:
            raise AssertionError(f"stoch_round {label}: kernel differs from its plain version")
        copy = offset_by_one if x.storage_offset() else torch.clone
        recs.append(time_kernel(
            bound_record(8 * x.numel(), 0), [(copy(x), sd, kw) for _ in range(ROTATE)],
            SR.stoch_round_cuda, ref.stoch_round_ref, None, f"stoch_round {label}",
        ))
    recs[2]["cases"] = [{"case": label, **{a: r[a] for a in CASE_KEYS if a in r}}
                        for (label, *_), r in zip(cases[:2] + cases[3:], recs[:2] + recs[3:])]
    return recs[2], errs


def write_kernels(gen, dev, hkv: int = 32, dh: int = 80):
    """The fused int8 KV write vs its plain version, bit for bit outside
    the trash page 0, at a model's kv heads (stablelm-3b's Hkv 32, Dh 80 by
    default; bs 16, bf16 rows): the decode write of 8 slots (one on the
    trash page, one past its table) and a 128-token prefill chunk of 8
    blocks; times at each.  Returns (decode record, max|err| list)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import stoch_round as SR

    bs, n_pages = 16, 8 * 32 + 1
    at = "" if (hkv, dh) == (32, 80) else f" Hkv={hkv} Dh={dh}"

    def pools():
        return [torch.randint(-127, 128, (n_pages, bs, hkv, dh), generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2)] + \
               [torch.rand((n_pages, bs, hkv), generator=gen, device=dev) + 0.5 for _ in range(2)]

    def rows(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 2).to(torch.bfloat16)

    def seeds(n):
        return torch.randint(0, 2**32, (n,), generator=gen, device=dev, dtype=torch.int64)

    table = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:8 * 32] + 1)
    table = table.reshape(8, 32).to(torch.int32)
    pos = torch.randint(0, 32 * 16, (8,), generator=gen, device=dev, dtype=torch.int32)
    pos[1], pos[2] = 40, 5000                       # the trash page; past the table
    table[1, 40 // bs] = -1
    row = table[0].contiguous()
    cases = [
        ("decode write, 8 slots" + at, (8, 1, hkv, dh), 1, dict(table=table, pos=pos)),
        ("prefill chunk, 128 tokens" + at, (1, 128, hkv, dh), 8, dict(table_row=row, b0=8)),
    ]
    recs, errs = [], []
    for label, shape, n_seeds, where in cases:
        k, v, sd = rows(shape), rows(shape), seeds(n_seeds)
        got = pools()
        want = [t.clone() for t in got]
        SR.write_kv_int8_cuda(k, v, *got, sd, **where)
        ref.write_kv_int8_ref(k, v, *want, sd, **where)
        same = all(torch.equal(g[1:], w_[1:]) for g, w_ in zip(got, want))
        errs.append(max(float((g[1:].float() - w_[1:].float()).abs().max())
                        for g, w_ in zip(got, want)))
        log(f"  write_kv_int8 {label}: codes and scales bit-identical outside page 0 {same}")
        if not same:
            raise AssertionError(f"write_kv_int8 {label}: kernel differs from its plain version")
        n_rows = k.numel() // dh if "table" in where else -(-shape[1] // bs) * bs * hkv
        # rows read (bf16) once, codes and scales written once, K and V
        nbytes = 2 * (k.numel() * 2 + n_rows * (dh + 4))
        sets = [(rows(shape), rows(shape), *pools(), sd, where) for _ in range(ROTATE)]
        recs.append(time_kernel(
            bound_record(nbytes, 0), sets, SR.write_kv_int8_cuda, ref.write_kv_int8_ref, None,
            f"write_kv_int8 {label}",
        ))
    recs[0]["cases"] = [{"case": cases[1][0], **{a: recs[1][a] for a in CASE_KEYS if a in recs[1]}}]
    return recs[0], errs


def wta_kernels(gen, dev):
    """wta_counts vs its plain version at the serving head's width (8 x
    50304, 32 trials) and at (256, 128) with 64 trials, and exactly equal
    there to the votes of a full draw (:func:`wta_counts.full_draw_counts`).
    Returns (head-shape record, max|err| list)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wta_counts as WTA

    log_ptxas("wta_cluster_kernel", "wta_warp_kernel")
    r_max, cos_max = WTA.draw_bounds(dev)
    log(f"  wta draw over every uniform: largest radius {r_max!r}, largest |cos| {cos_max!r} "
        f"(the kernel's bounds need <= 1)")
    if not cos_max <= 1.0:
        raise AssertionError("wta_counts: |cosf| exceeds 1, so the radius does not bound the noise")
    issue = wta_issue_estimate(gen, dev)
    recs, errs = [], []
    resident = WTA.resident_warps(dev)
    for b, c, n_trials in ((8, 50304, 32), (256, 128, 64)):
        geo = WTA.wta_geometry(c, b * n_trials, resident)
        log(f"  wta_counts ({b}, {c}) T={n_trials}: " + (
            f"clusters of {geo.n_cta} CTAs of {geo.warps} warps x {geo.cols_per_cta} columns, "
            f"{b * n_trials} clusters ({resident} resident warps)" if geo.n_cta else
            f"one warp per (row, trial), every column drawn, "
            f"{-(-b * n_trials // WTA.WARPS)} CTAs of {WTA.WARPS} warps"))
        kw = dict(n_trials=n_trials, vth0=WTA_VTH0, sigma_z=WTA_SIGMA)
        zs = [torch.randn((b, c), generator=gen, device=dev) * WTA_SIGMA for _ in range(ROTATE)]
        seed = torch.randint(0, 2**32, (1,), generator=gen, device=dev, dtype=torch.int64)
        got, want = WTA.wta_counts_cuda(zs[0], seed, **kw), ref.wta_counts_ref(zs[0], seed, **kw)
        delta = float((got - want).abs().sum())
        sums_equal = torch.equal(got.sum(-1), want.sum(-1))
        errs.append(float((got - want).abs().max()))
        log(f"  wta_counts ({b}, {c}) T={n_trials}: row sums equal {sums_equal}, "
            f"sum|Δcounts| {delta:.0f} (bound {2 * WTA_FLIP_FRACTION * b * n_trials:.1f}), "
            f"votes {int(got.sum())}")
        if not sums_equal or delta > 2 * WTA_FLIP_FRACTION * b * n_trials:
            raise AssertionError("wta_counts: kernel disagrees with its plain version")
        # the pruning is exact: the counts of every column drawn in full
        # (the probe, the kernel's own logf and cosf) are the kernel's
        full = WTA.full_draw_counts(zs[0], seed, **kw)
        log(f"  wta_counts ({b}, {c}) T={n_trials}: equal to the full draw's counts "
            f"{torch.equal(got, full)} (sum|Δ| {float((got - full).abs().sum()):.0f})")
        if not torch.equal(got, full):
            raise AssertionError("wta_counts: the pruned kernel differs from a full draw")
        # bound: z read and counts written once, or 3 transcendentals
        # (log, sqrt, cos) per trial and element on the SFUs
        recs.append(time_kernel(
            bound_record(8 * b * c, 3 * b * c * n_trials, SFU_OPS_PER_S),
            [(z, seed, kw) for z in zs], WTA.wta_counts_cuda, ref.wta_counts_ref, None,
            f"wta_counts ({b}, {c}) T={n_trials}",
        ))
        elements = b * c * n_trials
        recs[-1]["cluster"], recs[-1]["cta_warps"] = geo.n_cta, geo.warps
        recs[-1]["issue_ms"] = issue["clocks"][issue["pipe"]] * elements / 32 / ISSUE_PER_S * 1e3
        log(f"  wta_counts ({b}, {c}) T={n_trials}: issue estimate of the plain path "
            f"{recs[-1]['issue_ms']:.4f} ms ({issue['instructions']} instructions a "
            f"trial-element, bound by {issue['pipe']}) beside the SFU bound "
            f"{recs[-1]['bound_ms']:.4f} ms")
    recs[0]["issue_instructions"], recs[0]["issue_pipe"] = issue["instructions"], issue["pipe"]
    recs[0]["geometry_device_ms"] = wta_sweep(gen, dev)
    recs[0]["cases"] = [{"case": "(256, 128) T=64", **{a: recs[1][a] for a in
                                                       CASE_KEYS + ("issue_ms", "cluster",
                                                                    "cta_warps")
                                                       if a in recs[1]}}]
    return recs[0], errs


def wta_sweep(gen, dev) -> dict:
    """Device time of the serving head's call (8 x 50304, 32 trials) at
    other launch shapes (the override is for this measurement only), each
    held to the same counts as wta_geometry's pick."""
    from repro_torch.kernels import wta_counts as WTA

    kw = dict(n_trials=32, vth0=WTA_VTH0, sigma_z=WTA_SIGMA)
    zs = [torch.randn((8, 50304), generator=gen, device=dev) * WTA_SIGMA for _ in range(ROTATE)]
    seed = torch.randint(0, 2**32, (1,), generator=gen, device=dev, dtype=torch.int64)
    want = WTA.wta_counts_cuda(zs[0], seed, **kw)
    out = {}
    for n_cta, warps in ((8, 8), (8, 4), (8, 3), (4, 8), (4, 6), (4, 4), (2, 8), (2, 6), (1, 8)):
        geo = WTA.WtaGeometry(n_cta, warps, -(-50304 // n_cta // 4) * 4)
        if not torch.equal(WTA.wta_counts_cuda(zs[0], seed, **kw, geometry=geo), want):
            raise AssertionError(f"wta_counts: launch shape {geo} changes the counts")
        out[f"{n_cta}x{warps}"] = device_ms(
            [lambda z=z: WTA.wta_counts_cuda(z, seed, **kw, geometry=geo) for z in zs])
    log("  wta_counts (8, 50304) T=32: device ms by CTAs x warps a cluster, counts equal: "
        + ", ".join(f"{k}: {v:.4f}" for k, v in out.items()))
    return out


def sass_of(name: str) -> str:
    """``cuobjdump -sass`` of the built ``csrc/<name>.cu``."""
    import shutil

    from repro_torch.kernels import build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=120, check=True).stdout


def wta_issue_estimate(gen, dev) -> dict:
    """The plain per-element path (one full Box-Muller draw, the voltage,
    the comparator) as ``wta_draw_probe_kernel`` compiles it: its voltages
    held against the plain version's, and its common path counted from
    ``cuobjdump -sass`` (:func:`sass_common_path`, :func:`issue_estimate`)."""
    from repro_torch.kernels import prng
    from repro_torch.kernels import wta_counts as WTA

    n, seed = 1 << 20, 20241216
    z = torch.randn((1, n), generator=gen, device=dev) * WTA_SIGMA
    got = WTA.draw_probe(z, torch.tensor([seed], device=dev), n_trials=1, vth0=WTA_VTH0,
                         sigma_z=WTA_SIGMA).reshape(1, n)
    idx = torch.arange(n, device=dev, dtype=torch.int64)   # row 0, trial 0: counter = column
    v = z + prng.gaussian(idx, seed) * torch.tensor(WTA_SIGMA, device=dev)
    want = torch.where(v > WTA_VTH0, v, torch.full_like(v, -float("inf")))
    equal = float((got == want).float().mean())
    log(f"  wta draw probe ({n} elements): {equal:.6f} bit-equal to the plain version's voltages")
    if equal < 1 - WTA_FLIP_FRACTION:
        raise AssertionError("wta draw probe disagrees with the plain version")
    est = issue_estimate(sass_common_path(sass_of("wta_counts"),
                                          "_ZN4raca21wta_draw_probe_kernelEPKfPfijjjff"))
    log(f"  wta draw probe SASS: {est['instructions']} instructions on the common path, "
        f"clocks per warp {est['clocks']}, bound by {est['pipe']}")
    return est


def wta_sample_case(gen, dev, n, c, dtype, *, layout, read=0, steps=True):
    """Logits at the serving head's spread, per-slot keys fold_in(base,
    rid) (or one key for the batch), and the fold words the sampler
    passes: the step, after the read index for a redundant read."""
    from repro_torch import random as R

    z = (torch.randn((n, c), generator=gen, device=dev) * 2.5).to(dtype)
    base = R.PRNGKey(int(torch.randint(0, 2**31, (1,), generator=gen, device=dev)))
    if layout == "one key":
        return z, torch.tensor([base] * n, dtype=torch.int64, device=dev), None, (n * c, c)
    keys = torch.tensor([R.fold_in(base, i) for i in range(n)], dtype=torch.int64, device=dev)
    words = [torch.full((n,), read, dtype=torch.int64, device=dev)] if read else []
    if steps:
        words.append(torch.randint(0, 64, (n,), generator=gen, device=dev, dtype=torch.int64))
    folds = torch.stack(words, dim=1) if words else None
    return z, keys, folds, (c, 0)


def check_wta_sample(label, z, keys, folds, layout, n_trials, errs) -> None:
    """The kernel against its plain version: counts and decisions exactly
    equal.  Where they are not, the rows that differ are printed with
    both sides' decisions and votes at them, and the check fails."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wta_sample as WS

    kw = dict(n_trials=n_trials, vth0=WTA_VTH0, sigma_z=WTA_SIGMA, layout=layout)
    got, got_dec = WS.wta_sample_cuda(z, keys, folds, **kw)
    want, want_dec = ref.wta_trial_counts_ref(z, keys, folds, **kw)
    exact = torch.equal(got, want) and torch.equal(got_dec, want_dec)
    errs.append(float((got - want).abs().max()))
    log(f"  wta_sample {label}: counts and decisions equal {exact}, votes {int(got.sum())} of "
        f"{z.shape[0] * n_trials} trials")
    if not exact:
        rows = sorted({r for r, _ in (got != want).nonzero().tolist()}
                      | set((got_dec != want_dec).nonzero().flatten().tolist()))
        log(f"    rows that differ: {rows[:8]} of {len(rows)}; sum|Δcounts| "
            f"{float((got - want).abs().sum()):.0f}, decisions kernel "
            f"{got_dec[rows[:8]].tolist()} plain {want_dec[rows[:8]].tolist()}")
        for r in rows[:2]:
            cols = (got[r] != want[r]).nonzero().flatten()[:4].tolist()
            log(f"    row {r}, columns {cols}: kernel votes {got[r, cols].tolist()}, plain "
                f"{want[r, cols].tolist()}")
        raise AssertionError(f"wta_sample {label}: kernel and plain version disagree")


def wta_sample_kernels(gen, dev):
    """wta_sample vs its plain version at the serving head (8 x 50304, 32
    trials, bf16 logits, per-slot keys with steps, reads 0-2 of R = 3), the
    first-token sample (1 x 50304, step 0) and wta_trials on the paper's
    10-class head (64 x 10, 100 trials, one key); its draw bit-equal to
    repro_torch.random (a slice printed); its time at the head beside the
    plain version's and the issue estimate of its SASS.  Returns (head
    record, max|err| list)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wta_sample as WS

    log_ptxas("wta_sample_kernel<bf16>", "wta_sample_kernel<f32>", "wta_sample_probe_kernel")
    wta_sample_draw(gen, dev)
    errs = []
    for read in range(3):
        case = wta_sample_case(gen, dev, 8, 50304, torch.bfloat16, layout="per slot", read=read)
        check_wta_sample(f"(8, 50304) T=32 per-slot keys, step, read {read} of R=3", *case, 32,
                         errs)
    check_wta_sample("(1, 50304) T=32 first token, step 0",
                     *wta_sample_case(gen, dev, 1, 50304, torch.float32, layout="per slot"), 32,
                     errs)
    check_wta_sample("(64, 10) T=100 one key",
                     *wta_sample_case(gen, dev, 64, 10, torch.float32, layout="one key"), 100,
                     errs)
    n, c, t = 8, 50304, 32
    sets = []
    for _ in range(ROTATE):
        z, keys, folds, layout = wta_sample_case(gen, dev, n, c, torch.bfloat16, layout="per slot")
        sets.append((z, keys, folds, dict(n_trials=t, vth0=WTA_VTH0, sigma_z=WTA_SIGMA,
                                          layout=layout)))
    # bytes: bf16 z read, keys and step words read, counts and decisions
    # written; operations: the issue estimate of the timed kernel's SASS
    nbytes = n * c * 2 + n * 3 * 8 + n * c * 4 + n * 4
    issue = wta_sample_issue(sass_of("wta_sample"), "wta_sample_kernel<bf16>", n, c, t, n_folds=1)
    rec = bound_record(nbytes, 0)
    if issue["ms"] > rec["bound_ms"]:
        rec.update(bound_ms=issue["ms"], bound_by="operations")
    rec["flops"] = 32 * issue["instructions"]
    rec = time_kernel(rec, sets, WS.wta_sample_cuda, ref.wta_trial_counts_ref, None,
                      f"wta_sample ({n}, {c}) T={t} bf16")
    rec["issue_ms"], rec["issue_pipe"] = issue["ms"], issue["pipe"]
    rec["issue_instructions"] = issue["column"]
    log(f"  wta_sample ({n}, {c}) T={t}: issue estimate {issue['ms']:.4f} ms (bound by "
        f"{issue['pipe']}); kernel at {issue['ms'] / rec['device_ms']:.2f} of it")
    rec["fcnn_head"] = wta_sample_fcnn_head(gen, dev, errs)
    return rec, errs


def wta_sample_fcnn_head(gen, dev, errs) -> dict:
    """wta_sample at the FCNN's head as ``fcnn_predict_raca`` calls it a
    vote: (1024, 10) f32 drives, one trial, one key (the (N·C, C) layout);
    counts exactly equal to the plain version's, then timed beside its
    byte bound and its SASS issue estimate."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wta_sample as WS

    n, c = FCNN_TEST, 10
    check_wta_sample(f"({n}, {c}) T=1 one key (FCNN head)",
                     *wta_sample_case(gen, dev, n, c, torch.float32, layout="one key"), 1, errs)
    sets = []
    for _ in range(ROTATE):
        z, keys, folds, layout = wta_sample_case(gen, dev, n, c, torch.float32, layout="one key")
        sets.append((z, keys, folds, dict(n_trials=1, vth0=WTA_VTH0, sigma_z=WTA_SIGMA,
                                          layout=layout)))
    # bytes: f32 z and the keys read, counts and decisions written
    rec = bound_record(n * c * 4 + n * 16 + n * c * 4 + n * 4, 0)
    issue = wta_sample_issue(sass_of("wta_sample"), "wta_sample_kernel<f32>", n, c, 1, n_folds=0)
    if issue["ms"] > rec["bound_ms"]:
        rec.update(bound_ms=issue["ms"], bound_by="operations")
    rec["flops"] = 32 * issue["instructions"]
    rec = time_kernel(rec, sets, WS.wta_sample_cuda, ref.wta_trial_counts_ref, None,
                      f"wta_sample ({n}, {c}) T=1 one key (FCNN head)")
    rec["issue_ms"] = issue["ms"]
    return {k: rec[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "issue_ms")}


def sigmoid_sample_check(label, acc, bias, beta, key, offset, errs) -> None:
    """The kernel against its plain version: decisions exactly equal, and
    its draw (the probe: bits, uniforms, p) equal to repro_torch.random's
    and torch.sigmoid's.  Differences are printed with their u and p, and
    fail."""
    from repro_torch import random as R
    from repro_torch.kernels import ref
    from repro_torch.kernels import sigmoid_sample as SS

    m, n = acc.shape
    y = SS.sigmoid_sample_cuda(acc, bias, beta=beta, key=key, offset=offset)
    want = ref.sigmoid_sample_ref(acc, bias, beta=beta, key=key, offset=offset)
    bits, u, p, _ = SS.draw_probe(acc, bias, beta=beta, key=key, offset=offset)
    want_bits = R.random_bits(key, (m, n), acc.device, start=offset, count=m * n).reshape(m, n)
    want_u = R.uniform_from_bits(want_bits, 0.0, 1.0)
    want_p = torch.sigmoid(beta * (acc if bias is None else acc + bias))
    same = [torch.equal(bits, want_bits), torch.equal(u, want_u), torch.equal(p, want_p),
            torch.equal(y, want)]
    errs.append(float((y - want).abs().max()) if y.numel() else 0.0)
    log(f"  sigmoid_sample {label}: bits equal {same[0]}, uniforms {same[1]}, p {same[2]}, "
        f"decisions {same[3]}; {float(y.mean()) if y.numel() else 0:.4f} fire")
    if not all(same):
        for name, a, b in (("decision", y, want), ("p", p, want_p), ("u", u, want_u)):
            at = (a != b).nonzero()[:4].tolist()
            if at:
                log(f"    {name} differs at {at} of {int((a != b).sum())}: kernel "
                    f"{[float(a[i, j]) for i, j in at]}, plain {[float(b[i, j]) for i, j in at]}, "
                    f"u {[float(want_u[i, j]) for i, j in at]}, p {[float(want_p[i, j]) for i, j in at]}")
        raise AssertionError(f"sigmoid_sample {label}: kernel and plain version disagree")


def sigmoid_sample_kernels(gen, dev):
    """sigmoid_sample vs its plain version at the FCNN's hidden layers
    (Fig. 6's (1024, 500) and (1024, 300), the training batch's (128, 500)
    and (128, 300)), an odd (7, 33) and nonzero counter offsets (one across
    the high word), β = 1 and 0.7, with and without a bias; then its time
    at (1024, 500) and (1024, 300) beside its byte bound and the issue
    estimate of its own SASS.  Returns ((1024, 500) record, max|err| list)."""
    from repro_torch import random as R
    from repro_torch.kernels import ref
    from repro_torch.kernels import sigmoid_sample as SS

    log_ptxas("sigmoid_sample_kernel", "sigmoid_sample_probe_kernel")
    errs = []

    def case(m, n, seed):
        acc = torch.randn((m, n), generator=gen, device=dev) * 4
        return acc, torch.randn((n,), generator=gen, device=dev), R.fold_in(R.PRNGKey(seed), n)

    for m, n, offset in ((1024, 500, 0), (1024, 300, 0), (128, 500, 0), (128, 300, 0),
                         (7, 33, 0), (7, 33, 2**32 - 100), (300, 17, 12345)):
        acc, bias, key = case(m, n, m + offset)
        for beta, b in ((1.0, bias), (0.7, bias), (1.0, None)):
            sigmoid_sample_check(f"({m}, {n}) offset {offset} beta {beta}"
                                 f"{'' if b is not None else ' no bias'}",
                                 acc, b, beta, key, offset, errs)
    sass = sass_of("sigmoid_sample")
    recs = {}
    for m, n in ((FCNN_TEST, 500), (FCNN_TEST, 300)):
        sets = [(*case(m, n, i)[:2], dict(beta=1.0, key=R.fold_in(R.PRNGKey(5), i), offset=0))
                for i in range(ROTATE)]
        # bytes: acc read, the bias read, y written (f32)
        rec = bound_record(m * n * 4 + n * 4 + m * n * 4, 0)
        issue = sigmoid_sample_issue(sass, m, n)
        if issue["ms"] > rec["bound_ms"]:
            rec.update(bound_ms=issue["ms"], bound_by="operations")
        rec["flops"] = 32 * issue["instructions"]
        rec = time_kernel(rec, sets, SS.sigmoid_sample_cuda, ref.sigmoid_sample_ref, None,
                          f"sigmoid_sample ({m}, {n})")
        rec["issue_ms"], rec["issue_pipe"] = issue["ms"], issue["pipe"]
        rec["issue_instructions"] = issue["path"]
        rec["byte_bound_ms"] = (m * n * 8 + n * 4) / HBM_BYTES_PER_S * 1e3
        log(f"  sigmoid_sample ({m}, {n}): issue estimate {issue['ms']:.4f} ms ({issue['path']} "
            f"SASS instructions a warp, bound by {issue['pipe']}), bytes "
            f"{rec['byte_bound_ms']:.4f} ms; kernel at {rec['bound_ms'] / rec['device_ms']:.2f} "
            f"of its bound")
        recs[(m, n)] = rec
    rec = recs[(FCNN_TEST, 500)]
    other = recs[(FCNN_TEST, 300)]
    rec["cases"] = [{"case": f"({FCNN_TEST}, 300)", **{k: other[k] for k in (
        "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "issue_ms")}}]
    return rec, errs


def sigmoid_sample_issue(sass: str, m: int, n: int) -> dict:
    """Issue estimate of one ``sigmoid_sample_kernel`` launch from its own
    SASS: its common path (one element a thread: index, bias, sigmoid,
    hash, uniform, comparator, store) once per warp of the grid."""
    import re

    name = re.search(r"Function : (_ZN4raca21sigmoid_sample_kernel\S*)", sass).group(1)
    path = sass_common_path(sass, name)
    warps = -(-m * n // 256) * 8
    per_warp = issue_estimate(path)
    clocks = {k: warps * v for k, v in per_warp["clocks"].items()}
    pipe = max(clocks, key=clocks.get)
    log(f"  sigmoid_sample_kernel SASS: {len(path)} instructions on the common path "
        f"(clocks a warp {per_warp['clocks']}); ({m}, {n}): {warps} warps, bound by {pipe}")
    return {"path": len(path), "instructions": clocks["issue"], "clocks": clocks, "pipe": pipe,
            "ms": clocks[pipe] / ISSUE_PER_S * 1e3}


def wta_sample_issue(sass: str, kernel: str, n: int, c: int, n_trials: int, *,
                     n_folds: int) -> dict:
    """Issue estimate of one ``wta_sample_kernel`` call from its own SASS:
    per (row, trial) CTA, the scan loop's common path once per warp and
    column stride (one z load, hash, uniform, erf_inv, voltage,
    comparator, best update), each warp's path outside the loops (row
    and counter set-up, warp arg-max, exit), ``n_folds`` passes of the
    fold loop's body per warp, and warp 0's block arg-max and votes once.
    ``kernel`` is the short name ``wta_sample_kernel<bf16>`` or ``<f32>``."""
    from collections import Counter

    mangled = {"wta_sample_kernel<bf16>":
               "_ZN4raca17wta_sample_kernelI13__nv_bfloat16EEvPKT_PKlS6_iPfS7_iixxff",
               "wta_sample_kernel<f32>": "_ZN4raca17wta_sample_kernelIfEEvPKT_PKlS5_iPfS6_iixxff"}
    ins = sass_instructions(sass, mangled[kernel])
    loops = sass_loops(ins)
    has_ffma = [any(ins[k][2].startswith("FFMA") for k in range(h, e + 1)) for h, e in loops]
    scan = [lp for lp, f in zip(loops, has_ffma) if f]
    fold = [lp for lp, f in zip(loops, has_ffma) if not f]
    if len(scan) != 1 or len(fold) != 1:
        raise AssertionError(f"{kernel}: expected one scan loop and one fold loop, got "
                             f"{[(ins[h][0], ins[e][0]) for h, e in loops]}")

    def loads(path):
        return sum(op.startswith("LDG") for op in path)

    column = sass_walk(ins, scan[0][0], loop=scan[0])
    fold_body = sass_walk(ins, fold[0][0], loop=fold[0])
    if loads(column) != 1 or loads(fold_body) < 1:
        raise AssertionError(f"{kernel}: {loads(column)} loads a column stride, "
                             f"{loads(fold_body)} a fold pass")
    warp = sass_walk(ins, 0, first_exit=True)
    tail = sass_walk(ins, 0)[len(warp):]
    threads = min(-(-c // 32) * 32, 1024)
    strides = sum(max(0, -(-(c - 32 * w) // threads)) for w in range(threads // 32))
    per_cta = Counter()
    for path, k in ((column, strides), (warp, threads // 32),
                    (fold_body, threads // 32 * n_folds / loads(fold_body)), (tail, 1)):
        for op in path:
            per_cta[op] += k
    clocks = {p: n * n_trials * v for p, v in pipe_clocks(per_cta).items()}
    pipe = max(clocks, key=clocks.get)
    out = {"column": len(column), "warp": len(warp), "fold": len(fold_body) / loads(fold_body),
           "tail": len(tail), "instructions": clocks["issue"], "clocks": clocks, "pipe": pipe,
           "ms": clocks[pipe] / ISSUE_PER_S * 1e3}
    log(f"  {kernel} SASS: {out['column']} instructions a column stride "
        f"(clocks {pipe_clocks(Counter(column))}), {out['warp']} a warp outside the loops, "
        f"{out['fold']:.0f} a fold, {out['tail']} for warp 0's block arg-max; ({n}, {c}) "
        f"T={n_trials}, {n_folds} fold(s): {strides} column strides a CTA, bound by {pipe}, "
        f"{out['ms']:.4f} ms")
    return out


def wta_sample_draw(gen, dev) -> None:
    """The kernel's draw (``wta_sample_probe_kernel``) over 2**20 counters
    across the high word, against ``repro_torch.random`` on the card: bits,
    uniforms and normals bit-equal (a slice printed)."""
    from repro_torch import random as R
    from repro_torch.kernels import wta_sample as WS

    k, start, key = 1 << 20, 2**32 - (1 << 19), R.fold_in(R.PRNGKey(20241216), 7)
    z = torch.zeros(k, device=dev)
    bits, u, v = WS.draw_probe(z, key, start, vth0=-float("inf"), sigma_z=1.0)
    want_bits = R.random_bits(key, (2**33,), dev, start=start, count=k)
    want_u = R.uniform_from_bits(want_bits, R.NORMAL_LO, 1.0)
    want_n = R.erf_inv(want_u) * R.SQRT2_F32
    same = [torch.equal(bits, want_bits), torch.equal(u, want_u), torch.equal(v, want_n)]
    at = [0, 1, (1 << 19) - 1, 1 << 19]   # the last counter below 2**32, the first above
    log(f"  wta_sample draw over counters [{start}, {start + k}): bits equal {same[0]}, "
        f"uniforms equal {same[1]}, normals equal {same[2]} "
        f"({float((v == want_n).float().mean()):.7f} of them, max|Δ| "
        f"{float((v - want_n).abs().max()):.3e})")
    log(f"    at {at}: bits {bits[at].tolist()} / {want_bits[at].tolist()}, uniforms "
        f"{u[at].tolist()} / {want_u[at].tolist()}, normals {v[at].tolist()} / "
        f"{want_n[at].tolist()} (kernel / plain)")
    if not all(same):
        raise AssertionError("wta_sample draw disagrees with repro_torch.random")


def crossbar_case(gen, dev, m, k, n, *, binarize, binary_x=False, quantize=True,
                  physical=False, sigma=None):
    """Inputs as the analog training path hands them to the kernel: x (M, K)
    f32 (normed activations, or the binary product b_up·b_gate entering
    w_down), W (K, N) a bf16 N(0, 1/K) weight cast to f32 and divided by its
    range scale s (the physical path keeps W as it is), σ the calibrated
    read's 1.702 / s (comparator) or 0.01 (linear) on the card."""
    from repro_torch.core.physics import DeviceParams, calibrate_v_read
    from repro_torch.kernels import ops

    x = torch.randn((m, k), generator=gen, device=dev)
    if binary_x:
        x = (x > 0.5).float()
    w = (torch.randn((k, n), generator=gen, device=dev) * k**-0.5).to(torch.bfloat16).float()
    s = ops.range_scale(w)
    if physical:
        w = w / s * 1.2                 # a layer whose weights overrun the clip range
    else:
        w = w / s
    if sigma is None:
        sigma = (torch.tensor(1.702, device=dev) / s) if binarize else torch.full((), 0.01, device=dev)
    dp = calibrate_v_read(DeviceParams(), k)
    kw = dict(binarize=binarize, physical_noise=physical, noise_params=ops._noise_params(dp, k),
              quantize=quantize, qstep=ops._qstep(dp), w_min=dp.w_min, w_max=dp.w_max)
    seed = int(torch.randint(0, 2**32, (1,), generator=gen, device=dev, dtype=torch.int64))
    return x, w.contiguous(), seed, sigma.reshape(()).float(), kw, s


def check_crossbar(label, x, w, seed, sigma, kw, errs):
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.kernels import ref

    got = CB.crossbar_mac_cuda(x, w, seed, sigma, **kw)
    crossbar_gate(label, x, w, kw, got, ref.crossbar_mac_ref(x, w, seed, sigma, **kw), errs)


def crossbar_gate(label, x, w, kw, got, want, errs):
    """A read's output against its plain version's under the gates above;
    appends max|Δ| to ``errs``."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"crossbar_mac {label}: non-finite output")
    if kw["binarize"]:
        agree = float((got == want).float().mean())
        binary = bool(((got == 0) | (got == 1)).all())
        errs.append(float((got - want).abs().max()))
        log(f"  crossbar_mac {label}: {agree:.6f} of decisions equal (gate {CB_AGREEMENT})")
        if agree < CB_AGREEMENT or not binary:
            raise AssertionError(f"crossbar_mac {label}: kernel disagrees with its plain version")
        return
    worst = linear_err_over_tol(x, w, kw, got, want)
    err = (got - want).abs()
    errs.append(float(err.max()))
    log(f"  crossbar_mac {label}: max|err| {float(err.max()):.3e}, worst err/tol {worst:.3f}")
    if worst > 1.0:
        raise AssertionError(f"crossbar_mac {label}: kernel disagrees with its plain version")


def check_prepass(label, x, w, kw, errs):
    """The prepass against its plain version: x's pieces, the levels and
    (physical noise model) the integer column sums bit-identical; the f32
    row sums, summed in another order, within 2·sqrt(K)·2**-24·Σ|x|.
    Appends max|Δ| over all four outputs to ``errs``."""
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.kernels import ref

    q = (kw["qstep"], kw["w_min"], kw["w_max"])
    xs, rowsum, ct, colsum = CB.crossbar_prepass_cuda(x, w, *q, physical_noise=kw["physical_noise"])
    xs_p, rowsum_p, ct_p, colsum_p = ref.crossbar_prepass_ref(x, w, *q)
    torch.cuda.synchronize()
    exact = max(float((xs.float() - xs_p).abs().max()), float((ct.float() - ct_p).abs().max()))
    if kw["physical_noise"]:
        exact = max(exact, float((colsum - colsum_p).abs().max()))
    d_row = (rowsum - rowsum_p).abs()
    worst = float((d_row / (2 * x.shape[1] ** 0.5 * 2.0**-24 * x.abs().sum(1)).clamp_min(1e-30)).max())
    errs.append(max(exact, float(d_row.max())))
    log(f"  crossbar prepass {label}: pieces, levels{', column sums' if kw['physical_noise'] else ''} "
        f"max|err| {exact:.3e}; row sums max|err| {float(d_row.max()):.3e}, worst err/tol {worst:.3f}")
    if exact != 0.0 or worst > 1.0 or not torch.isfinite(rowsum).all():
        raise AssertionError(f"crossbar prepass {label}: prepass disagrees with its plain version")


def crossbar_bound(m, k, n):
    """The read's bound as the kernel now does it: three bf16 tensor-core
    passes (3·2·M·K·N over the dense bf16 rate) against its bytes (x and
    W read as f32, out written, once each); and the f32 bound of the same
    product on the CUDA cores, kept beside it."""
    nbytes = 4 * (m * k + k * n + m * n)
    rec = bound_record(nbytes, 3 * 2 * m * k * n)
    rec["f32_bound_ms"] = bound_record(nbytes, 2 * m * k * n, F32_FLOPS_PER_S)["bound_ms"]
    return rec


def one_pass_shares(x, w, seed, sigma_cmp, kw):
    """What fewer passes of x keep: the share of comparator decisions (the
    calibrated read's σ) that the level-domain read with x rounded once to
    bf16 or TF32, or split into two bf16 pieces, shares with the plain
    version; and, for a linear read, the worst error over the linear gate.
    The kernel's own three-piece split is modelled beside them (plain
    PyTorch, f32 sums)."""
    from repro_torch.kernels import ref

    cmp_kw = dict(kw, binarize=True)
    want = ref.crossbar_mac_ref(x, w, seed, sigma_cmp, **cmp_kw)
    out = {}
    for label, pieces, fmt in (("bf16 x1", 1, "bf16"), ("tf32 x1", 1, "tf32"),
                               ("bf16 x2", 2, "bf16"), ("bf16 x3", 3, "bf16")):
        got = ref.crossbar_level_read(x, w, seed, sigma_cmp, pieces=pieces, fmt=fmt, **cmp_kw)
        out[label] = {"decisions_kept": float((got == want).float().mean())}
        if not kw["binarize"]:
            sigma = torch.full((), 0.01, device=x.device)
            lin = ref.crossbar_level_read(x, w, seed, sigma, pieces=pieces, fmt=fmt, **kw)
            out[label]["linear_err_over_tol"] = linear_err_over_tol(
                x, w, kw, lin, ref.crossbar_mac_ref(x, w, seed, sigma, **kw))
        del got
    return out


def scaled_linear_err_over_tol(x, w, cfg, got, want):
    """Worst |got − want| of a calibrated linear read through
    ``ops.crossbar_mac`` over the linear gate scaled by the read's range
    scale s (its output is the normalized read times s, one more rounding
    on each side: + 2**-23·|out|).  x and W in f32, as the read takes
    them."""
    from repro_torch.kernels import ops, ref

    k = w.shape[0]
    x, w = x.reshape(-1, k).float(), w.float()
    got, want = got.reshape(-1, w.shape[1]), want.reshape(-1, w.shape[1])
    s = ops.range_scale(w)
    dp = cfg.device
    wq = ref.crossbar_quantize(w / s, ops._qstep(dp), dp.w_min, dp.w_max) if cfg.quantize else w / s
    tol = s * 2 * k**0.5 * 2.0**-24 * (x.abs() @ wq.abs()) + 2.0**-23 * want.abs()
    return float(((got - want).abs() / tol.clamp_min(1e-30)).max())


def linear_err_over_tol(x, w, kw, got, want):
    """Worst |got − want| over the linear gate 2·sqrt(K)·2**-24·Σ|x·Wq|
    (+ 1e-5·|out| with the physical noise model)."""
    from repro_torch.kernels import ref

    wq = ref.crossbar_quantize(w, kw["qstep"], kw["w_min"], kw["w_max"]) if kw["quantize"] else w
    tol = 2 * x.shape[1] ** 0.5 * 2.0**-24 * (x.abs() @ wq.abs())
    if kw["physical_noise"]:
        tol = tol + 1e-5 * want.abs()
    return float(((got - want).abs() / tol.clamp_min(1e-30)).max())


def crossbar_kernels(gen, dev):
    """crossbar_mac vs its plain version at stablelm-3b's training shapes
    (M = 8 x 128 tokens): the 2560² linear reads (wq wk wv wo), the
    2560→6912 comparator reads (w_up, w_gate) and the 6912→2560 linear
    read of the binary hidden layer (w_down); then the odd shape 257 x 513
    x 129 (valid K and the padded noise counter), the physical noise model
    and the serving canary's unquantized (1, 128) x (128, 8) read.  At the
    three training shapes: the prepass against its plain version, the
    GEMM at every compiled tile width held to the read's gates and timed,
    the read's time (prepass + GEMM) and the prepass's alone, and the
    decisions that fewer passes of x would keep.  Returns (2560² read
    record, prepass record, the read's max|err| list, the prepass's)."""
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.kernels import ref

    errs, prep_errs, recs, preps = [], [], {}, {}
    for label, (m, k, n), opts in (
        ("(1024, 2560) x (2560, 2560) linear", (1024, 2560, 2560), dict(binarize=False)),
        ("(1024, 2560) x (2560, 6912) comparator", (1024, 2560, 6912), dict(binarize=True)),
        ("(1024, 6912) x (6912, 2560) linear", (1024, 6912, 2560),
         dict(binarize=False, binary_x=True)),
    ):
        cases = [crossbar_case(gen, dev, m, k, n, **opts) for _ in range(ROTATE)]
        x, w, seed, sigma, kw, scale = cases[0]
        q = (kw["qstep"], kw["w_min"], kw["w_max"])
        gkw = {a: b for a, b in kw.items() if a != "quantize"}
        want = ref.crossbar_mac_ref(x, w, seed, sigma, **kw)
        crossbar_gate(label, x, w, kw, CB.crossbar_mac_cuda(x, w, seed, sigma, **kw), want, errs)
        check_prepass(label, x, w, kw, prep_errs)
        parts = CB.crossbar_prepass_cuda(x, w, *q)
        for tn in CB.TILE_NS:   # every width the sweep times, held to the gates first
            crossbar_gate(f"{label}, GEMM at tile_n {tn}", x, w, kw,
                          CB.crossbar_gemm_cuda(*parts, k, seed, sigma, **gkw, tile_n=tn),
                          want, errs)
        del parts, want
        rec = time_kernel(
            crossbar_bound(m, k, n), [c[:5] for c in cases],
            CB.crossbar_mac_cuda, ref.crossbar_mac_ref,
            lambda x, w, sd, sg: (lambda: x @ w), f"crossbar_mac {label} (library: product only)",
        )
        prep_args = [(c[0], c[1], *q, {}) for c in cases]
        nbytes = 4 * (m * k + k * n) + 2 * (3 * m + n) * (-(-k // 64) * 64) + 4 * m
        preps[(m, k, n)] = time_kernel(
            bound_record(nbytes, 0), prep_args, CB.crossbar_prepass_cuda,
            ref.crossbar_prepass_ref, None, f"crossbar prepass {label}",
        )
        pre = [CB.crossbar_prepass_cuda(c[0], c[1], *q) + (k, c[2], c[3]) for c in cases]

        def gemm_at(p, tn):
            return lambda: CB.crossbar_gemm_cuda(*p, **gkw, tile_n=tn)

        rec["tile_device_ms"] = {tn: device_ms([gemm_at(p, tn) for p in pre]) for tn in CB.TILE_NS}
        rec["tile_n"] = CB.TILE_N
        rec["gemm_device_ms"] = rec["tile_device_ms"][CB.TILE_N]
        log(f"  crossbar GEMM {label}: device ms {rec['gemm_device_ms']:.4f} at tile_n "
            f"{rec['tile_n']}; by tile_n " + ", ".join(
                f"{tn}: {t:.4f}" for tn, t in rec["tile_device_ms"].items())
            + f"; f32 bound {rec['f32_bound_ms']:.4f} ms")
        del pre
        sigma_cmp = torch.tensor(1.702, device=dev) / scale   # the calibrated comparator
        rec["one_pass"] = one_pass_shares(x, w, seed, sigma_cmp, kw)
        log(f"  crossbar one pass of x, {label}: " + "; ".join(
            f"{name} " + ", ".join(f"{a} {b:.6f}" for a, b in v.items())
            for name, v in rec["one_pass"].items()))
        recs[(m, k, n)] = rec
        del cases
    for b in (False, True):
        tag = "comparator" if b else "linear"
        check_crossbar(f"odd 257 x 513 x 129 {tag}",
                       *crossbar_case(gen, dev, 257, 513, 129, binarize=b)[:5], errs)
        phys = crossbar_case(gen, dev, 192, 640, 200, binarize=b, physical=True)
        check_crossbar(f"physical noise 192 x 640 x 200 {tag}", *phys[:5], errs)
        check_prepass(f"physical noise 192 x 640 x 200 {tag}", phys[0], phys[1], phys[4], prep_errs)
    check_crossbar("canary (1, 128) x (128, 8) unquantized linear",
                   *crossbar_case(gen, dev, 1, 128, 8, binarize=False, quantize=False)[:5], errs)
    rec = recs[(1024, 2560, 2560)]
    rec["cases"] = [
        {"case": f"{m}x{k}x{n}", **{a: r[a] for a in CROSSBAR_KEYS}}
        for (m, k, n), r in recs.items() if (m, k, n) != (1024, 2560, 2560)
    ]
    prep = preps[(1024, 2560, 2560)]
    prep["cases"] = [{"case": f"{m}x{k}x{n}", **{a: r[a] for a in CASE_KEYS if a in r}}
                     for (m, k, n), r in preps.items() if (m, k, n) != (1024, 2560, 2560)]
    return rec, prep, errs, prep_errs


CROSSBAR_KEYS = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "f32_bound_ms", "gemm_device_ms", "tile_n", "tile_device_ms", "one_pass")


# ---------------------------------------------------------------------------
# Phase 4: serve stablelm-3b at full width.
# ---------------------------------------------------------------------------


def attn_layers(cfg) -> int:
    """Attention sublayers over the model's depth: one decode attention
    launch each a step (a hybrid model's recurrent sublayers launch
    none)."""
    return cfg.n_units * sum(k in ("global", "local") for k in cfg.layer_pattern)


def serve_trace(vocab: int) -> list[list[int]]:
    """12 prompts of 16-300 tokens: four share a 128-token prefix (one cold,
    three partial hits), a 120-token prompt repeats at once (full hit that
    forks its unaligned boundary block copy-on-write), six are unrelated."""
    rng = np.random.default_rng(0)
    tok = lambda n: rng.integers(0, vocab, n).tolist()  # noqa: E731
    prefix, y = tok(128), tok(120)
    a = prefix + tok(72)
    prompts = [y, y, a, prefix + tok(72)]
    prompts += [tok(int(n)) for n in rng.integers(16, 301, 4)]
    prompts += [prefix + tok(72), a]
    prompts += [tok(int(n)) for n in rng.integers(16, 301, 2)]
    return prompts


def serve_phase(dev, w_invariant: bool) -> dict:
    """The 12-request trace at full width with a bf16 pool, then with an
    int8 pool, then with WTA sampling on the bf16 pool
    (``ServeConfig(seed=0)``) at one read and at three redundant reads a
    token, from the same weights; then the degraded serve and phase 4c
    (preemption and chaos; ``w_invariant``: phase 3's finding for the bf16
    decode kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm

    cfg = get_config("stablelm-3b")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  init stablelm-3b ({cfg.n_layers}L d{cfg.d_model} H{cfg.n_heads} Dh{cfg.head_dim} "
        f"ff{cfg.d_ff} V{cfg.vocab} {cfg.dtype}) in {time.perf_counter() - t0:.1f} s")
    prompts = serve_trace(cfg.vocab)
    serve_warm_up(params, cfg, prompts, dev)
    res = {}
    for kv in ("same", "int8"):
        res[kv] = serve_once(params, dataclasses.replace(cfg, kv_cache_dtype=kv), prompts, dev)
    res["wta"] = serve_once(params, dataclasses.replace(cfg, wta_head=True), prompts, dev)
    res["wta_r3"] = serve_once(params, dataclasses.replace(cfg, wta_head=True), prompts, dev,
                               reads=3)
    res["degraded"] = degraded_phase(params, dataclasses.replace(cfg, wta_head=True), prompts,
                                     dev, res["wta"])
    log("== 4c: preemption with KV spill to host, deadlines and chaos (stablelm-3b, compiled)")
    res["preempt"] = preempt_phase(params, cfg, prompts, dev, res, w_invariant)
    log("== 4d: self-speculative decoding (stablelm-3b, compiled: one graph per (W, k))")
    res["spec"] = spec_phase(params, cfg, prompts, dev, res)
    log("== 4f: the dense KV layout and the static engine (stablelm-3b, compiled: one graph "
        "per batch width)")
    res["dense"] = dense_phase(params, cfg, prompts, dev, res)
    log("== 4n: the serving mesh at 1 x 1 (a one-rank NCCL group; bf16, int8, WTA and k = 4 "
        "against phases 4 and 4d; the bench's sharded_decode; serve.py --sharded)")
    res["mesh"] = mesh_phase(params, cfg, prompts, dev, res)
    same, int8 = res["same"]["outs"], res["int8"]["outs"]
    agree = sum(a == b for r in same for a, b in zip(same[r], int8[r]))
    total = sum(len(o) for o in same.values())
    log(f"  int8 vs bf16 pool greedy agreement: {agree}/{total} = {agree / total:.4f} "
        f"(random weights; not gated)")
    res["turns"] = tick_turns(params, cfg, dev)
    wta = res["wta"]["outs"]
    agree = sum(a == b for r in same for a, b in zip(same[r], wta[r]))
    log(f"  WTA vs greedy tokens: {agree}/{total} equal (random weights, near-flat logits: "
        f"WTA samples, so few should match)")
    if agree == total:
        raise AssertionError("the WTA serve emitted the greedy tokens: the sampler did not draw")
    r3 = res["wta_r3"]["outs"]
    agree = sum(a == b for r in wta for a, b in zip(wta[r], r3[r]))
    log(f"  WTA R=3 vs R=1 tokens: {agree}/{total} equal (the majority of three reads, read 0 "
        f"being R=1's; not gated)")
    return res


def serve_warm_up(params, cfg, prompts, dev) -> None:
    """Two requests through a compiled and an eager engine, untimed: the
    process's first model run pays one-time costs (cuBLAS handles and
    heuristics, lazy module loads, the first capture) that would
    otherwise land on the first measured run, the compiled bf16 one."""
    from repro_torch.serving import ServeConfig, ServingEngine

    t0 = time.perf_counter()
    for graphs in (True, False):
        eng = ServingEngine(params, cfg, ServeConfig(max_batch=8, max_len=512, kv_block_size=16,
                                                     prefill_chunk=128, max_new_tokens=8),
                            device=dev, graphs=graphs)
        for p in prompts[:2]:
            eng.submit(p)
        eng.run()
        del eng
    torch.cuda.empty_cache()
    log(f"  warm-up (2 requests, compiled and eager) in {time.perf_counter() - t0:.2f} s")


def tick_turns(params, cfg, dev, n_ticks: int = 5, rounds: int = 10) -> dict:
    """Host ms per full-batch decode tick in turns within one process (no
    profiler): six engines on the same weights, greedy and WTA sampling,
    each with the compiled step (CUDA graphs) and eagerly, and WTA compiled
    on the zero-knob ``sim_faulty`` backend with the canary off and on
    every tick, taking turns in an order that rotates every round; 8 slots
    at positions ≈ 128-230, each tick ending in the engine's own sync.  Host time moves between calls
    and phases, so only turns compare them.  Then the sampler alone,
    ``specs.sample_tokens`` on the engine's (8, 50304) bf16 logits with
    per-slot keys and steps against its greedy argmax: ms per call over 200
    calls ending in one sync, in turns, and at three redundant reads."""
    from repro_torch.launch import specs as SP
    from repro_torch.serving import ServeConfig, ServingEngine

    rng = np.random.default_rng(2)
    engines = {}
    wcfg = dataclasses.replace(cfg, wta_head=True)
    faulty = dict(device_backend="sim_faulty")
    for name, c, graphs, extra in (
            ("greedy", cfg, True, {}), ("wta", wcfg, True, {}),
            ("greedy eager", cfg, False, {}), ("wta eager", wcfg, False, {}),
            ("wta faulty", wcfg, True, faulty),
            ("wta faulty canary", wcfg, True, dict(faulty, canary_interval=1))):
        eng = ServingEngine(params, c, ServeConfig(max_batch=8, max_len=512, kv_block_size=16,
                                                   prefill_chunk=128, seed=0, **extra),
                            device=dev, graphs=graphs)
        for _ in range(8):
            eng.submit(rng.integers(0, cfg.vocab, 100).tolist(),
                       max_new_tokens=2 * rounds * n_ticks + 4)
        while eng._job_fifo or eng.sched.queued():
            eng.tick()
        eng.tick()
        engines[name] = eng
    torch.cuda.synchronize()
    names = list(engines)
    ms = {k: [] for k in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[: r % len(names)]:
            eng = engines[name]
            t0 = time.perf_counter()
            for _ in range(n_ticks):
                eng.tick()
            ms[name].append((time.perf_counter() - t0) * 1e3 / n_ticks)
    out = {k: float(np.median(v)) for k, v in ms.items()}
    for name in names:
        log(f"  host ms per full-batch tick in turns ({rounds} x {n_ticks} ticks), {name}: "
            f"{[round(x, 2) for x in ms[name]]} (median {out[name]:.2f})")
    for name in ("greedy", "wta", "wta faulty", "wta faulty canary"):
        assert engines[name].compile_counts()["serve_step"] == 1, engines[name].compile_counts()
        assert engines[name]._rebuilds == 0
    probes = engines["wta faulty canary"].metrics()
    log(f"  canary every tick: {probes.canary_probes} probes, {probes.canary_failures} failed; "
        f"host ms a tick, medians: canary on {out['wta faulty canary']:.2f}, off "
        f"{out['wta faulty']:.2f} (sim_faulty, zero knobs), sim {out['wta']:.2f}")
    assert probes.canary_probes > 0 and probes.canary_failures == 0
    del engines
    torch.cuda.empty_cache()
    logits = (torch.randn((8, cfg.vocab), device=dev) * 2.5).to(torch.bfloat16)
    keys = torch.randint(0, 2**32, (8, 2), device=dev, dtype=torch.int64)
    steps = torch.arange(8, device=dev, dtype=torch.int64)
    calls = {"greedy": lambda: SP.sample_tokens(cfg, logits),
             "wta": lambda: SP.sample_tokens(wcfg, logits, keys, steps),
             "wta R=3": lambda: SP.sample_tokens(wcfg, logits, keys, steps, n_redundant=3)}
    per_call = {"greedy": [], "wta": [], "wta R=3": []}
    for name in ("greedy", "wta", "wta R=3", "wta R=3", "wta", "greedy"):
        calls[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            calls[name]()
        torch.cuda.synchronize()
        per_call[name].append((time.perf_counter() - t0) * 1e3 / 200)
    log(f"  sample_tokens (8, {cfg.vocab}) bf16, ms per call in turns (200 calls, one sync): "
        f"greedy {[round(x, 4) for x in per_call['greedy']]}, WTA "
        f"{[round(x, 4) for x in per_call['wta']]}, WTA R=3 "
        f"{[round(x, 4) for x in per_call['wta R=3']]}")
    return {"runs": ms, "median": out, "sample_tokens_ms": per_call}


def serve_once(params, cfg, prompts, dev, reads: int = 1) -> dict:
    """The trace through the compiled engine (CUDA graphs, the default on
    the card), its launch counts, captures and ``compile_counts()``, a
    profile of its decode ticks; then the same trace eagerly
    (``graphs=False``), whose streams and launch counts must be the
    same, and its profile."""
    kv = cfg.kv_cache_dtype
    log(f"  -- kv pool: {'int8 codes + f32 scales' if kv == 'int8' else cfg.dtype}, "
        f"{f'WTA (R={reads})' if cfg.wta_head else 'greedy'} sampling")
    runs = {mode: serve_run(params, cfg, prompts, dev, reads, graphs=mode == "graphs")
            for mode in ("graphs", "eager")}
    g, e = runs["graphs"], runs["eager"]
    diverged = [(r, next((i for i, (a, b) in enumerate(zip(g["outs"][r], e["outs"][r])) if a != b),
                         min(len(g["outs"][r]), len(e["outs"][r]))))
                for r in sorted(g["outs"]) if g["outs"][r] != e["outs"].get(r)]
    for r, i in diverged:
        log(f"  request {r}: graph and eager streams differ at token {i}: graphs "
            f"{g['outs'][r][max(i - 2, 0):i + 3]}, eager {e['outs'][r][max(i - 2, 0):i + 3]}")
    if diverged or sorted(g["outs"]) != sorted(e["outs"]):
        raise AssertionError(f"graph and eager streams differ in {len(diverged)} requests")
    if g["launches"] != e["launches"]:
        raise AssertionError(f"replay-aware launch counts {g['launches']} differ from eager "
                             f"mode's {e['launches']}")
    n_tok = sum(len(o) for o in g["outs"].values())
    log(f"  graphs = eager: {len(g['outs'])} streams, {n_tok} tokens equal, launch counts equal; "
        f"tok/s {g['metrics']['tokens_per_s']:.1f} vs {e['metrics']['tokens_per_s']:.1f}, "
        f"decode step ms {g['decode_step_ms']:.2f} vs {e['decode_step_ms']:.2f}, TTFT mean ms "
        f"{g['metrics']['ttft_mean'] * 1e3:.1f} vs {e['metrics']['ttft_mean'] * 1e3:.1f}; "
        f"profiled tick host ms {g['profile']['host_ms']:.2f} vs {e['profile']['host_ms']:.2f}, "
        f"kernels {g['profile']['kernels']:.0f} vs {e['profile']['kernels']:.0f}, device busy "
        f"{g['profile']['busy']:.1%} vs {e['profile']['busy']:.1%}")
    out = dict(g)
    out["eager"] = {k: e[k] for k in ("metrics", "wall_s", "decode_step_ms", "profile")}
    return out


def serve_run(params, cfg, prompts, dev, reads: int, graphs: bool, mesh=None) -> dict:
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import stoch_round as SR
    from repro_torch.kernels import wta_sample as WS
    from repro_torch.serving import ServeConfig, ServingEngine

    scfg = ServeConfig(
        max_batch=8, max_len=512, kv_block_size=16, prefill_chunk=128,
        max_new_tokens=32, prefill_buckets=(32, 64, 120, 128, 200, 256, 320), seed=0,
        n_redundant_reads=reads, mesh=mesh,
    )
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng = ServingEngine(params, cfg, scfg, device=dev, graphs=graphs)
    for p in prompts:
        eng.submit(p)
    # the counters count graph replays too (each entry adds what its
    # capture counted, ops.add_launches)
    PA.launches = PF.launches = SR.launches = SR.write_launches = WS.launches = 0
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode": PA.launches, "prefill": PF.launches, "stoch_round": SR.launches,
                "write_kv_int8": SR.write_launches, "wta_sample": WS.launches}
    m = eng.metrics()
    mode = "graphs" if graphs else "eager"
    log(f"  [{mode}] served {m.completed} requests, {m.total_tokens} tokens in {wall:.2f} s: "
        f"{m.tokens_per_s:.1f} tok/s, TTFT mean {m.ttft_mean * 1e3:.1f} ms p99 "
        f"{m.ttft_p99 * 1e3:.1f} ms, decode step {m.decode_step_ms:.2f} ms over "
        f"{m.decode_steps} steps, occupancy {m.occupancy_mean:.2f}")
    chunks = launches["prefill"] // max(attn_layers(cfg), 1)
    log(f"  [{mode}] prefix hits {m.prefix_hits}, partial hits {m.prefix_partial_hits}, cow forks "
        f"{m.cow_forks}, prefill tokens {m.prefill_tokens} (saved {m.prefill_tokens_saved}), "
        f"launches decode {launches['decode']} prefill {launches['prefill']} write_kv_int8 "
        f"{launches['write_kv_int8']} stoch_round {launches['stoch_round']} wta_sample "
        f"{launches['wta_sample']} (per decode step: attention "
        f"{launches['decode'] / max(m.decode_steps, 1):.1f}; {chunks} prefill chunks)")
    counts = eng.compile_counts()
    captures = eng._decode.captures()
    log(f"  [{mode}] compile_counts {counts}; captures {len(captures)}: "
        + ", ".join(f"(W={w}, R={r}) {ms:.1f} ms" for (w, r), ms in captures))
    assert sorted(outs) == list(range(len(prompts))), "requests lost"
    assert all(len(o) == 32 and all(0 <= t < cfg.vocab for t in o) for o in outs.values())
    assert m.evictions == {"length": len(prompts)}, m.evictions
    assert m.prefix_hits >= 1 and m.prefix_partial_hits >= 2 and m.cow_forks >= 1
    # an attention-free model (mamba2) launches neither attention kernel
    assert (launches["decode"] > 0 and launches["prefill"] > 0) == (attn_layers(cfg) > 0), \
        launches
    assert launches["stoch_round"] == 0, launches   # the fused write does the rounding
    if cfg.kv_cache_dtype == "int8" and not attn_layers(cfg):
        # no pool: an int8 config writes nothing and holds no quant_step
        assert sorted(eng._cache) == ["pos", "ssm_conv", "ssm_state"], sorted(eng._cache)
        assert launches["write_kv_int8"] == 0, launches
    elif cfg.kv_cache_dtype == "int8":
        assert eng._cache["k_pages"].dtype == torch.int8
        # one fused K/V write beside every attention launch
        assert launches["write_kv_int8"] == launches["decode"] + launches["prefill"] > 0, launches
    else:
        assert launches["write_kv_int8"] == 0, launches
    # WTA: one launch per read and decode step, one per request's first token
    want = reads * m.decode_steps + len(prompts) if cfg.wta_head else 0
    assert launches["wta_sample"] == want, (launches, want)
    assert launches["decode"] == attn_layers(cfg) * m.decode_steps, launches
    # one entry per (window width, R), captured on the card, none per tick
    assert len(captures) == (counts["serve_step"] if graphs else 0), (captures, counts)
    assert all(r == reads for _, r in eng._decode.entries)
    assert m.decode_steps > counts["serve_step"], counts
    prof = profile_decode(eng, cfg.vocab, mode)
    torch.cuda.synchronize()
    mem = {"serving_gib": (torch.cuda.memory_allocated() - mem0) / 2**30,
           "pool_gib": sum(t.numel() * t.element_size() for t in eng._cache.values()) / 2**30}
    del eng
    torch.cuda.empty_cache()
    mem["left_mib"] = (torch.cuda.memory_allocated() - mem0) / 2**20
    log(f"  [{mode}] device memory: {mem['serving_gib']:.3f} GiB held by the engine after the "
        f"run and profile (its KV pool {mem['pool_gib']:.3f} GiB), {mem['left_mib']:.1f} MiB "
        f"left once it is dropped")
    # a dropped engine leaves nothing behind (no reference cycle, no
    # per-capture stream whose cuBLAS workspace would outlive it)
    assert mem["left_mib"] < 32, mem
    return {"launches": launches, "metrics": dataclasses.asdict(m), "wall_s": wall, "outs": outs,
            "profile": prof, "decode_step_ms": m.decode_step_ms, "compile_counts": counts,
            "memory": mem,
            "captures": [[list(k), ms] for k, ms in captures]}


# ---------------------------------------------------------------------------
# Phase 4n: the serving mesh at 1 x 1.
# ---------------------------------------------------------------------------


def mesh_phase(params, cfg, prompts, dev, res: dict) -> dict:
    """Phase 4n; see the module's docstring.  Every gate raises."""
    import torch.distributed as dist

    from repro_torch.benchmarks import bench_serving as TBS
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as LM
    from repro_torch.models.transformer import init_lm

    t0 = time.perf_counter()
    out = {}
    with LM.process_group("cuda"):
        mesh = LM.make_host_mesh(model=1, data=1)
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        log(f"  mesh {LM.mesh_shape(mesh)} on {mesh.device_type}, backend {dist.get_backend()}")
        for key, c in (("same", cfg), ("int8", dataclasses.replace(cfg, kv_cache_dtype="int8")),
                       ("wta", dataclasses.replace(cfg, wta_head=True))):
            run = serve_run(params, c, prompts, dev, 1, graphs=True, mesh=mesh)
            base = res[key]
            bad = [r for r in sorted(base["outs"]) if run["outs"].get(r) != base["outs"][r]]
            if bad or sorted(run["outs"]) != sorted(base["outs"]):
                raise AssertionError(f"4n {key}: 1 x 1 streams differ from phase 4's in {bad}")
            if run["launches"] != base["launches"]:
                raise AssertionError(f"4n {key}: launches {run['launches']} against phase 4's "
                                     f"{base['launches']}")
            nodes, want = run["profile"]["graph_nodes"], base["profile"]["graph_nodes"]
            if (nodes["nodes"], nodes["by_type"]) != (want["nodes"], want["by_type"]):
                raise AssertionError(f"4n {key}: the replayed tick's graph has {nodes}, phase "
                                     f"4's {want}")
            if run["compile_counts"] != base["compile_counts"]:
                raise AssertionError(f"4n {key}: compile_counts {run['compile_counts']} against "
                                     f"{base['compile_counts']}")
            prof, bprof = run["profile"], base["profile"]
            log(f"  4n {key}: streams = phase 4's ({sum(map(len, run['outs'].values()))} tokens), "
                f"launches = phase 4's {run['launches']}, graph {nodes['nodes']} nodes = phase "
                f"4's; replayed tick host {prof['host_ms']:.3f} ms (phase 4 "
                f"{bprof['host_ms']:.3f}), device {prof['device_ms']:.3f} ms (phase 4 "
                f"{bprof['device_ms']:.3f}), {prof['kernels']:.0f} kernels a tick (phase 4 "
                f"{bprof['kernels']:.0f})")
            out[key] = {"launches": run["launches"], "graph_nodes": nodes,
                        "host_ms": prof["host_ms"], "device_ms": prof["device_ms"],
                        "base_host_ms": bprof["host_ms"], "base_device_ms": bprof["device_ms"],
                        "decode_step_ms": run["decode_step_ms"],
                        "base_decode_step_ms": base["decode_step_ms"]}
        spec = spec_run(params, cfg, prompts, dev, 4, "4n) 1 x 1 greedy k=4", mesh=mesh)
        want = res["spec"]["runs"]["a"]
        if spec["outs"] != want["outs"] or spec["launches"] != want["launches"]:
            raise AssertionError(f"4n spec: 1 x 1 streams or launches {spec['launches']} differ "
                                 f"from 4d (a)'s {want['launches']}")
        out["spec"] = {"launches": spec["launches"], "decode_step_ms":
                       spec["metrics"]["decode_step_ms"]}
        log(f"  4n spec: streams and launches = 4d (a)'s; decode step "
            f"{spec['metrics']['decode_step_ms']:.2f} ms (4d (a) "
            f"{want['metrics']['decode_step_ms']:.2f})")
        out["turns"] = mesh_turns(params, cfg, prompts, dev, mesh)
        small = get_smoke_config("stablelm-3b")
        shd = TBS.bench_sharded_decode(small, init_lm(small, seed=0, device=dev), n_req=8)
        TBS._check_sharded({"sharded_decode": shd})
        assert shd["mesh"] == {"data": 1, "model": 1} and shd["capacity_ratio"] == 1.0, shd
        out["bench"] = shd
        log(f"  4n bench sharded_decode: {shd}")
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "stablelm-3b", "--sharded",
         "--requests", "3", "--new-tokens", "8"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), capture_output=True,
        text=True, timeout=300)
    text = proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("serving mesh", "served"))]
    log(f"  4n serve.py --sharded (rc {proc.returncode}, {time.perf_counter() - t1:.1f} s): "
        + " | ".join(lines))
    if proc.returncode or "serving mesh: {'data': 1, 'model': 1}" not in text \
            or "served 3 requests" not in text:
        raise AssertionError(f"4n serve.py --sharded failed:\n{text[-4000:]}")
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 4n wall time {out['wall_s']:.1f} s")
    return out


def mesh_turns(params, cfg, prompts, dev, mesh, n_ticks: int = 5, rounds: int = 10) -> dict:
    """Host ms per full-batch replayed tick in turns (no profiler), the
    unsharded engine against the 1 x 1 mesh's: 8 slots decoding from the
    trace's prompts, each tick ending in the engine's own sync, the order
    swapped every round."""
    from repro_torch.serving import ServeConfig, ServingEngine

    engines = {}
    for name, m in (("mesh=None", None), ("1x1", mesh)):
        eng = ServingEngine(params, cfg, ServeConfig(max_batch=8, max_len=512, kv_block_size=16,
                                                     prefill_chunk=128, seed=0, mesh=m),
                            device=dev)
        for p in prompts[:8]:
            eng.submit(p[:100], max_new_tokens=2 * rounds * n_ticks + 4)
        while eng._job_fifo or eng.sched.queued():
            eng.tick()
        eng.tick()
        engines[name] = eng
    torch.cuda.synchronize()
    ms = {k: [] for k in engines}
    for r in range(rounds):
        for name in (list(engines) if r % 2 == 0 else list(engines)[::-1]):
            t0 = time.perf_counter()
            for _ in range(n_ticks):
                engines[name].tick()
            ms[name].append((time.perf_counter() - t0) * 1e3 / n_ticks)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"  4n host ms per full-batch tick in turns ({rounds} x {n_ticks} ticks): "
        + "; ".join(f"{k} {[round(x, 2) for x in v]} (median {med[k]:.2f})"
                    for k, v in ms.items()))
    del engines
    torch.cuda.empty_cache()
    return {"runs": ms, "median": med}


# The degraded serve's fault schedule: the comparator offset the canary
# must catch, injected at tick DEGRADE_TICK and taken back at RECOVER_TICK
DEGRADE_TICK, RECOVER_TICK, DEGRADE_OFFSET = 4, 16, 3.0


def degraded_phase(params, cfg, prompts, dev, sim_wta: dict) -> dict:
    """The trace with WTA sampling through the compiled engine on the
    ``sim_faulty`` backend, twice.  (a) Every knob at zero: the ``sim``
    WTA serve's stream token for token (``sim_wta``), and analog counts
    that equal ``tokens_computed × per-token counts`` (and the other
    per-event counts) exactly and equal the ``sim`` run's.  (b) The
    ladder: the canary every tick, ``DegradationPolicy(trip_after=2,
    recover_after=2)``, ``degrade_device(comparator_offset=3)`` at tick 4
    and ``recover_device`` at tick 16, then idle ticks until level 0: the
    ladder must reach level 2 (R = 3 captured) and come back, the canary's
    ``crossbar_mac`` launches must equal its probes, re-reads must be
    priced, every request must end with a typed reason, and the tokens
    published before tick 4 must be (a)'s.  Both print the Table I
    model's energy per published token."""
    from repro_torch.core import cost_model as CM

    res = {"zero": degraded_run(params, cfg, prompts, dev, ladder=False),
           "ladder": degraded_run(params, cfg, prompts, dev, ladder=True)}
    zero, ladder = res["zero"], res["ladder"]
    diverged = [r for r in sorted(sim_wta["outs"]) if zero["outs"].get(r) != sim_wta["outs"][r]]
    for r in diverged:
        i = next((i for i, (a, b) in enumerate(zip(zero["outs"][r], sim_wta["outs"][r]))
                  if a != b), 0)
        log(f"  request {r}: zero-knob sim_faulty and sim streams differ at token {i}: "
            f"{zero['outs'][r][max(i - 2, 0):i + 3]} vs {sim_wta['outs'][r][max(i - 2, 0):i + 3]}")
    if diverged or sorted(zero["outs"]) != sorted(sim_wta["outs"]):
        raise AssertionError(f"zero-knob sim_faulty stream differs from sim's in {len(diverged)} "
                             f"requests")
    a = zero["analog"]
    want = (CM.AnalogOpCounts.from_dict(a["per_token_counts"]).scaled(a["tokens_computed"]["total"])
            + CM.AnalogOpCounts.from_dict(a["per_sample_counts"]).scaled(a["sample_events"])
            + CM.AnalogOpCounts.from_dict(a["per_kv_token_counts"]).scaled(a["kv_written_tokens"])
            + CM.AnalogOpCounts.from_dict(a["per_redundant_counts"]).scaled(
                a["redundant_read_events"]))
    sim_a = sim_wta["metrics"]["analog"]
    log(f"  (a) zero knobs: stream = sim's ({sum(map(len, zero['outs'].values()))} tokens); "
        f"counts = tokens x per-event counts {want.as_dict() == a['counts']}, = sim's "
        f"{a['counts'] == sim_a['counts']}; tokens computed {a['tokens_computed']}")
    if want.as_dict() != a["counts"] or a["counts"] != sim_a["counts"] \
            or a["tokens_computed"] != sim_a["tokens_computed"]:
        raise AssertionError("zero-knob sim_faulty accounting differs from its shape counts or sim's")
    if zero["rebuilds"] != 0:
        raise AssertionError(f"zero knobs rebuilt {zero['rebuilds']} times")
    before = [e for tick in ladder["per_tick"][:DEGRADE_TICK] for e in tick]
    if before != [e for tick in zero["per_tick"][:DEGRADE_TICK] for e in tick]:
        raise AssertionError(f"the ladder run published other tokens than (a) before tick "
                             f"{DEGRADE_TICK}")
    log(f"  (b) the {len(before)} tokens published in ticks 0-{DEGRADE_TICK - 1} equal (a)'s")
    for name, r in res.items():
        for scheme, label in (("raca", "RACA"), ("adc1b", "1-bit ADC")):
            e = r["analog"][scheme]
            log(f"  ({name}) Table I model, not measured: {label} "
                f"{e['energy_pj_per_token']:.6e} pJ per published token "
                f"({e['energy_pj_gross']:.6e} pJ gross), {e['tops_per_w_effective']:.4f} TOPS/W")
    return res


def degraded_run(params, cfg, prompts, dev, *, ladder: bool) -> dict:
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.kernels import ops as KOPS
    from repro_torch.serving import DegradationPolicy, FaultInjector, ServeConfig, ServingEngine

    extra = {}
    if ladder:
        inj = (FaultInjector()
               .at(DEGRADE_TICK, "degrade_device", comparator_offset=DEGRADE_OFFSET)
               .at(RECOVER_TICK, "recover_device"))
        extra = dict(canary_interval=1, fault_injector=inj,
                     degradation=DegradationPolicy(trip_after=2, recover_after=2))
    scfg = ServeConfig(
        max_batch=8, max_len=512, kv_block_size=16, prefill_chunk=128, max_new_tokens=32,
        prefill_buckets=(32, 64, 120, 128, 200, 256, 320), seed=0, device_backend="sim_faulty",
        **extra,
    )
    tag = "(b) ladder" if ladder else "(a) zero knobs"
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng = ServingEngine(params, cfg, scfg, device=dev)
    for p in prompts:
        eng.submit(p)
    per_tick, rebuild_mem = [], []
    CB.launches = CB.prepass_launches = 0
    before = KOPS.launch_counts()
    t0 = time.perf_counter()
    while eng.sched.has_work() or (ladder and eng._degrade_level and len(per_tick) < 200):
        n = eng._rebuilds
        if n == 0:
            torch.cuda.synchronize()
            mem_before = torch.cuda.memory_allocated()
        per_tick.append(eng.tick())
        if eng._rebuilds != n:
            torch.cuda.synchronize()
            rebuild_mem.append((eng._ticks, (torch.cuda.memory_allocated() - mem_before) / 2**20))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = KOPS.launch_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    m = eng.metrics()
    outs = {r.rid: r.output for r in eng.sched.all_requests()}
    reasons = {r.rid: r.done_reason for r in eng.sched.all_requests()}
    log(f"  {tag}: {m.completed} requests, {m.total_tokens} tokens, {len(per_tick)} ticks in "
        f"{wall:.2f} s; decode steps {m.decode_steps}; evictions {m.evictions}; launches {launches}")
    log(f"  {tag}: canary {m.canary_failures}/{m.canary_probes} failed, redundant reads "
        f"{m.redundant_read_events}, degraded_mode {m.degraded_mode}, compile_counts "
        f"{eng.compile_counts()}")
    for t in m.degraded_transitions:
        log(f"  {tag}: transition at tick {t['tick']}: level {t['from']} -> {t['to']} ({t['why']})")
    captures = eng.capture_log()
    log(f"  {tag}: graph rebuilds {eng._rebuilds}; captures {len(captures)}: " + ", ".join(
        f"[gen {g}] (W={w}, R={r}) {ms:.1f} ms" for g, (w, r), ms in captures))
    log(f"  {tag}: device memory after each rebuild tick, over the tick before the first: "
        + (", ".join(f"tick {t}: {mib:+.1f} MiB" for t, mib in rebuild_mem) or "no rebuild"))
    assert sorted(outs) == list(range(len(prompts))), "requests lost"
    assert all(reasons[r] in ("length", "eos") for r in outs), reasons   # typed, no eviction
    assert all(len(o) == 32 and all(0 <= t < cfg.vocab for t in o) for o in outs.values())
    assert all(mib < 32 for _, mib in rebuild_mem), rebuild_mem
    if ladder:
        levels = [t["to"] for t in m.degraded_transitions]
        whys = {t["why"] for t in m.degraded_transitions}
        assert levels and max(levels) >= 2 and levels[-1] == 0 and m.degraded_mode == 0, levels
        assert whys == {"fault_pressure", "canary_recovered"}, whys
        assert any(r == 3 for _, (_, r), _ in captures), "the R = 3 step was never captured"
        assert eng._rebuilds == 2 and any(g >= 1 for g, _, _ in captures), captures
        # the canary is the serving path's only crossbar read: one launch a probe
        assert CB.launches == m.canary_probes > 0 and CB.prepass_launches == 0, \
            (CB.launches, m.canary_probes)
        assert 0 < m.canary_failures < m.canary_probes
        assert m.redundant_read_events > 0
    else:
        assert m.canary_probes == 0 and CB.launches == 0 and not m.degraded_transitions
    crossbar, rebuilds = CB.launches, eng._rebuilds
    del eng
    torch.cuda.empty_cache()
    left = (torch.cuda.memory_allocated() - mem0) / 2**20
    log(f"  {tag}: {left:.1f} MiB left once the engine is dropped")
    assert left < 32, left
    return {"outs": outs, "per_tick": per_tick, "analog": m.analog, "rebuilds": rebuilds,
            "crossbar_launches": crossbar}


# ---------------------------------------------------------------------------
# Phase 4c: preemption with KV spill to host, deadlines and chaos.
# ---------------------------------------------------------------------------

# Runs (a)-(c): requests 0-7 at priority 1, then 8-11 at priority 0 once
# PREEMPT_ARRIVE ticks have run, and two forced preempts at tick
# PREEMPT_FORCE_TICK.  Run (d): a prefill killed at tick 1, a NaN page at
# tick 5, a deadline storm at tick 20; the killed job's sharers get
# CHAOS_SHARER_TOKENS tokens, so that they finish before the storm.
PREEMPT_ARRIVE, PREEMPT_FORCE_TICK = 7, 16
CHAOS_KILL_TICK, CHAOS_NAN_TICK, CHAOS_STORM_TICK, CHAOS_SHARER_TOKENS = 1, 5, 20, 8


def preempt_serve_config(prompts, **kw):
    """Phase 4's ``ServeConfig`` with ``num_kv_blocks`` cut to half the
    trace's reservations (bucket + 32 tokens a request, no sharing), plus
    the trash page."""
    from repro_torch.serving import ServeConfig

    base = dict(max_batch=8, max_len=512, kv_block_size=16, prefill_chunk=128,
                max_new_tokens=32, prefill_buckets=(32, 64, 120, 128, 200, 256, 320), seed=0)
    scfg = ServeConfig(**base)
    total = sum(-(-(next(b for b in scfg.buckets() if b >= len(p)) + scfg.max_new_tokens)
                  // scfg.kv_block_size) for p in prompts)
    return ServeConfig(**dict(base, num_kv_blocks=total // 2 + 1, **kw)), total


def spill_state_bytes(cfg) -> int:
    """A spill record's per-slot state: ``pos``, a hybrid model's
    recurrent state (``rec_conv`` (3, W) in the model's dtype, ``rec_h``
    (W,) in f32, a recurrent sublayer) and an ssm model's (``ssm_conv``
    (3, C) in the model's dtype, ``ssm_state`` (H, P, N) in f32, a
    mixer)."""
    item = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    n_rec = cfg.n_units * cfg.layer_pattern.count("rec")
    n_ssm = cfg.n_units * cfg.layer_pattern.count("ssm")
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return (4 + n_rec * (cfg.lru_width or cfg.d_model) * (3 * item + 4)
            + n_ssm * ((cfg.ssm_conv - 1) * conv_ch * item
                       + cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4))


def spill_record_bytes(cfg, scfg) -> int:
    """One fixed-width spill record: both pool leaves at ``max_kv_blocks()``
    pages (an int8 pool's codes and f32 scale planes) and the slot's state
    (:func:`spill_state_bytes`)."""
    item = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    rows = attn_layers(cfg) * scfg.max_kv_blocks() * scfg.kv_block_size * cfg.n_kv_heads
    if cfg.kv_cache_dtype == "int8":
        return 2 * rows * (cfg.head_dim + 4) + spill_state_bytes(cfg)
    return 2 * rows * cfg.head_dim * item + spill_state_bytes(cfg)


class SpillTimer:
    """Wraps the engine class's spill, restore and poison for one run (and
    puts them back): each spill's bytes and ms (its gather and the
    device-to-host copies, which end in a sync), each restore's ms (synced
    on both sides: its host-to-device copies are asynchronous), and the
    captures each restore or poison added (must be none)."""

    NAMES = ("_preempt", "_store_spill", "_restore_one", "_poison_nan")

    def __init__(self):
        self.spills, self.restores, self.captures = [], [], []

    def __enter__(self):
        from repro_torch.serving import ServingEngine

        self.cls = ServingEngine
        self.orig = {n: getattr(ServingEngine, n) for n in self.NAMES}
        timer = self

        def timed(name, sync):
            def run(eng, *a):
                n_cap = len(eng.capture_log())
                if sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = timer.orig[name](eng, *a)
                if sync:
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                timer.captures.append((name, len(eng.capture_log()) - n_cap))
                if name == "_preempt":
                    timer.spills[-1]["ms"] = ms
                elif name == "_restore_one":
                    timer.restores.append({"rid": a[0].rid, "ms": ms})
                return out
            return run

        def store(eng, rid, rec):
            self.spills.append({"rid": rid, "bytes": eng._spill_nbytes(rec)})
            return self.orig["_store_spill"](eng, rid, rec)

        ServingEngine._preempt = timed("_preempt", sync=True)
        ServingEngine._restore_one = timed("_restore_one", sync=True)
        ServingEngine._poison_nan = timed("_poison_nan", sync=False)
        ServingEngine._store_spill = store
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.cls, n, f)


def preempt_run(params, cfg, prompts, dev, scfg, tag: str, *, arrivals, budgets=None,
                injector=None) -> dict:
    """One phase 4c serve: ``arrivals`` maps a tick to the (rid, priority)
    submitted before it (rids are prompt indices, submitted in order);
    ``budgets`` optional per-rid token budgets.  Returns streams, done
    reasons, per-tick host ms and whether the tick preempted, spills and
    restores, compile counts, launches (reset just before, read just
    after) and memory."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import stoch_round as SR
    from repro_torch.kernels import wta_sample as WS
    from repro_torch.serving import ServingEngine

    if injector is not None:
        scfg = dataclasses.replace(scfg, fault_injector=injector)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng = ServingEngine(params, cfg, scfg, device=dev)
    ptrs = {k: v.data_ptr() for k, v in eng._cache.items()}
    ticks, pending = [], dict(arrivals)
    PA.launches = PF.launches = SR.launches = SR.write_launches = WS.launches = 0
    with SpillTimer() as timer:
        t_run = time.perf_counter()
        while pending or eng.sched.has_work():
            for rid, prio in pending.pop(len(ticks), ()):
                got = eng.submit(prompts[rid], None if budgets is None else budgets.get(rid),
                                 priority=prio)
                assert got == rid, (got, rid)
            n_pre = eng._preemptions
            t0 = time.perf_counter()
            emitted = eng.tick()
            ticks.append({"ms": (time.perf_counter() - t0) * 1e3, "emitted": emitted,
                          "preempted": eng._preemptions - n_pre})
            assert len(ticks) < 2000, "phase 4c run did not drain"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
    launches = {"decode": PA.launches, "prefill": PF.launches, "write_kv_int8": SR.write_launches,
                "stoch_round": SR.launches, "wta_sample": WS.launches}
    m = eng.metrics()
    reqs = eng.sched.all_requests()
    out = {
        "outs": {r.rid: list(r.output) for r in reqs},
        "reasons": {r.rid: r.done_reason for r in reqs},
        "ticks": ticks, "spills": timer.spills, "restores": timer.restores,
        "restore_captures": sum(n for name, n in timer.captures if name != "_preempt"),
        "preemptions": m.preemptions, "restores_n": m.restores, "spill_drops": m.spill_drops,
        "evictions": m.evictions, "compile_counts": eng.compile_counts(),
        "capture_log": len(eng.capture_log()), "launches": launches, "wall_s": wall,
        "free_blocks": (eng.blocks.available, eng.blocks.capacity),
        "ptrs_kept": ptrs == {k: v.data_ptr() for k, v in eng._cache.items()},
        "spill_left": eng._spill_bytes, "applied": [] if injector is None else list(injector.applied),
    }
    del eng
    torch.cuda.empty_cache()
    out["left_mib"] = (torch.cuda.memory_allocated() - mem0) / 2**20
    pre = [t["ms"] for t in ticks if t["preempted"]]
    rest = [t["ms"] for t in ticks if not t["preempted"]]
    log(f"  ({tag}) {len(ticks)} ticks in {wall:.2f} s; preemptions {m.preemptions}, restores "
        f"{m.restores}, spill drops {m.spill_drops}; done reasons {m.evictions}; launches "
        f"{launches}; compile_counts {out['compile_counts']}; captures {out['capture_log']}")
    for s in timer.spills:
        log(f"  ({tag}) spill of request {s['rid']}: {s['bytes']} bytes "
            f"({s['bytes'] / 2**20:.2f} MiB) in {s['ms']:.2f} ms")
    for r in timer.restores:
        log(f"  ({tag}) restore of request {r['rid']}: {r['ms']:.2f} ms")
    if pre:
        log(f"  ({tag}) host ms a tick: {len(pre)} preempting ticks median "
            f"{float(np.median(pre)):.2f} (max {max(pre):.2f}), the other {len(rest)} median "
            f"{float(np.median(rest)):.2f}")
    log(f"  ({tag}) pool addresses kept {out['ptrs_kept']}; captures by restores or poison "
        f"{out['restore_captures']}; blocks {out['free_blocks'][0]}/{out['free_blocks'][1]} "
        f"free at the end; {out['left_mib']:.1f} MiB left once the engine is dropped")
    return out


def preempt_check(tag: str, run: dict, want: dict, gate: bool,
                  against: str = "phase 4's") -> int:
    """Stream agreement with ``want`` (phase 4's streams, or ``against``),
    token for token, each run's tokens a prefix of that stream; a
    divergence is printed with its rid, position and both tokens.  Raises
    when ``gate``.  Returns the tokens that agree."""
    agree = total = 0
    bad = []
    for r, got in sorted(run["outs"].items()):
        ref = want[r]
        n = sum(a == b for a, b in zip(got, ref))
        agree, total = agree + n, total + len(got)
        if n != len(got):
            i = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
            bad.append(r)
            log(f"  ({tag}) request {r} diverges at token {i}: {got[i]} against {against} "
                f"{ref[i]} ({against} {ref[max(i - 2, 0):i + 3]}, here "
                f"{got[max(i - 2, 0):i + 3]})")
    log(f"  ({tag}) {agree}/{total} tokens equal {against} streams"
        + ("" if gate else " (not gated)"))
    if gate and bad:
        raise AssertionError(f"({tag}) streams differ from phase 4's in requests {bad}")
    return agree


def preempt_invariants(tag: str, run: dict, reasons=("length",), attention: bool = True) -> None:
    """What every phase 4c run holds: typed done reasons, the allocator
    back to capacity, the spill store empty, one signature for each
    preemption entry point, the pool's addresses kept, no capture from a
    restore or a poison, the engine freed, and its attention kernels
    launched (none without ``attention``)."""
    cc = run["compile_counts"]
    assert all(r in reasons for r in run["reasons"].values()), (tag, run["reasons"])
    assert run["free_blocks"][0] == run["free_blocks"][1], (tag, run["free_blocks"])
    assert run["spill_left"] == 0, (tag, run["spill_left"])
    assert run["ptrs_kept"] and run["restore_captures"] == 0, tag
    assert run["left_mib"] < 32, (tag, run["left_mib"])
    assert (run["launches"]["decode"] > 0 and run["launches"]["prefill"] > 0) == attention, \
        (tag, run["launches"])
    if run["preemptions"]:
        assert cc["page_spill"] == cc["page_restore"] == cc["state_gather"] == 1, (tag, cc)


def preempt_phase(params, cfg, prompts, dev, res: dict, w_invariant: bool) -> dict:
    """Phase 4c at stablelm-3b's full width and depth through the compiled
    engine: (a) priority preemption with a one-record spill budget, greedy
    bf16; (b) the same with WTA sampling; (c) on an int8 pool; (d) chaos,
    bf16 and int8.  With W-invariant decode attention (phase 3) the bf16
    streams are gated against phase 4's; otherwise (a) and (b) are gated on
    an f32 copy of the weights against its own unpreempted serve, and the
    bf16 agreement is printed beside."""
    from repro_torch.serving import FaultInjector

    scfg, total = preempt_serve_config(prompts)
    log(f"  the trace reserves {total} blocks (bucket + 32 tokens each, no sharing); phase 4c's "
        f"pool: num_kv_blocks = {scfg.num_kv_blocks} ({scfg.pool_blocks() - 1} allocatable, "
        f"{scfg.pool_blocks('int8') - 1} with int8)")
    arrivals = {0: [(r, 1) for r in range(8)], PREEMPT_ARRIVE: [(r, 0) for r in range(8, 12)]}

    def force():
        return FaultInjector().at(PREEMPT_FORCE_TICK, "preempt").at(PREEMPT_FORCE_TICK, "preempt")

    out = {}
    wcfg = dataclasses.replace(cfg, wta_head=True)
    icfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    for key, c, want in (("a", cfg, "same"), ("b", wcfg, "wta"), ("c", icfg, "int8")):
        rec = spill_record_bytes(c, scfg)
        run = out[key] = preempt_run(
            params, c, prompts, dev, dataclasses.replace(scfg, spill_budget_bytes=rec),
            f"{key}) {want}", arrivals=arrivals, injector=force())
        preempt_invariants(key, run)
        assert run["preemptions"] >= 3 and run["restores_n"] >= 1 and run["spill_drops"] >= 1, \
            (key, run["preemptions"], run["restores_n"], run["spill_drops"])
        assert all(s["bytes"] == rec for s in run["spills"]), (key, rec, run["spills"])
        assert len(run["applied"]) == 2, run["applied"]
        if key == "b":
            assert run["launches"]["wta_sample"] > 0, run["launches"]
        if key == "c":
            assert run["launches"]["write_kv_int8"] > 0, run["launches"]
        run["agree"] = preempt_check(key, run, res[want]["outs"],
                                     gate=key != "c" and w_invariant)
    log("  (c) int8, not gated: decode writes draw their rounding from the engine-wide "
        "quant_step, so a restored request's later rows round otherwise than in phase 4")
    if not w_invariant:
        out["f32"] = preempt_f32(params, cfg, prompts, dev, scfg, arrivals, force)
    for kv, c in (("same", cfg), ("int8", icfg)):
        out[f"d_{kv}"] = chaos_run(params, c, prompts, dev, scfg, res[kv]["outs"],
                                   gate=kv == "same" and w_invariant)
    return out


def preempt_f32(params, cfg, prompts, dev, scfg, arrivals, force) -> dict:
    """(a) and (b) on an f32 copy of the weights: the unpreempted trace,
    then the preempted one, gated token for token."""
    p32 = tree_float(params)
    out = {}
    for key, c in (("a", cfg), ("b", dataclasses.replace(cfg, wta_head=True))):
        c = dataclasses.replace(c, dtype="float32")
        base = preempt_run(p32, c, prompts, dev, dataclasses.replace(scfg, num_kv_blocks=0),
                           f"{key} f32) unpreempted", arrivals={0: [(r, 1) for r in range(12)]})
        run = preempt_run(p32, c, prompts, dev,
                          dataclasses.replace(scfg, spill_budget_bytes=spill_record_bytes(c, scfg)),
                          f"{key} f32) preempted", arrivals=arrivals, injector=force())
        preempt_invariants(f"{key} f32", run)
        preempt_check(f"{key} f32", run, base["outs"], gate=True, against="the unpreempted f32")
        out[key] = {"preemptions": run["preemptions"], "restores": run["restores_n"],
                    "spill_drops": run["spill_drops"], "spills": run["spills"],
                    "restore_ms": run["restores"]}
    del p32
    torch.cuda.empty_cache()
    return out


def tree_float(tree):
    return {k: tree_float(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def chaos_run(params, cfg, prompts, dev, scfg, want: dict, gate: bool) -> dict:
    """Run (d): every request at once; ``kill_prefill`` at tick 1 (the job
    FIFO's head, mid-prefill), ``nan_logits`` at tick 5 (the first active
    request with a private page), ``deadline_storm`` at tick 20.  The
    killed job ends ``preempted``, the queued jobs that shared its pages
    (budget CHAOS_SHARER_TOKENS) end ``length``, the poisoned request
    ``nan`` (its sanity code ``SANE_NAN`` through the decode kernel), the
    rest ``deadline``; every published token is phase 4's at its index
    (gated on bf16)."""
    from repro_torch.serving import FaultInjector

    kv = cfg.kv_cache_dtype
    # the FIFO head at tick 1 is request 2 (a: the shared prefix and its
    # own suffix, mid-prefill after one chunk); 3, 8 and 9 map its pages
    sharers = {r for r in range(12) if r != 2 and prompts[r][:128] == prompts[2][:128]}
    inj = (FaultInjector().at(CHAOS_KILL_TICK, "kill_prefill").at(CHAOS_NAN_TICK, "nan_logits")
           .at(CHAOS_STORM_TICK, "deadline_storm"))
    run = preempt_run(params, cfg, prompts, dev, scfg, f"d) chaos {kv}",
                      arrivals={0: [(r, 1) for r in range(12)]},
                      budgets={r: CHAOS_SHARER_TOKENS for r in sharers}, injector=inj)
    applied = {k: rid for _, k, rid in run["applied"] if k != "deadline_storm"}
    log(f"  (d {kv}) applied {applied} and deadline_storm at tick {CHAOS_STORM_TICK}; done "
        f"reasons {run['reasons']}")
    killed, victim = applied.get("kill_prefill"), applied.get("nan_logits")
    assert killed is not None and victim is not None, run["applied"]
    assert run["reasons"][killed] == "preempted" and run["outs"][killed] == [], killed
    assert run["reasons"][victim] == "nan", (victim, run["reasons"][victim])
    assert sharers - {killed} and all(run["reasons"][r] == "length" for r in sharers - {killed}), \
        (sharers, run["reasons"])
    rest = set(range(12)) - sharers - {killed, victim}
    assert all(run["reasons"][r] == "deadline" for r in rest), run["reasons"]
    preempt_invariants(f"d {kv}", run, reasons=("length", "preempted", "nan", "deadline"))
    assert run["capture_log"] <= 3, run["capture_log"]   # one graph per window width
    if kv == "int8":
        assert run["launches"]["write_kv_int8"] > 0, run["launches"]
    run["agree"] = preempt_check(f"d {kv}", run, want, gate=gate)
    return run


# ---------------------------------------------------------------------------
# Phase 4d: self-speculative decoding.
# ---------------------------------------------------------------------------

# 4d serves phase 4's trace and ServeConfig with SPEC_NEW_TOKENS tokens a
# request (streams compare with phase 4's first SPEC_NEW_TOKENS); the
# forced preempts of run (e) fire at these ticks
SPEC_NEW_TOKENS = 16
SPEC_PREEMPT_TICKS = (1, 3)


def spec_serve_config(**kw):
    from repro_torch.serving import ServeConfig

    return ServeConfig(**dict(dict(
        max_batch=8, max_len=512, kv_block_size=16, prefill_chunk=128,
        max_new_tokens=SPEC_NEW_TOKENS, prefill_buckets=(32, 64, 120, 128, 200, 256, 320),
        seed=0), **kw))


def spec_probe(params, cfg, prompts, dev, k: int = 4) -> dict:
    """One speculative round's draft and verify logits, kept: eight slots
    decoding (the trace's first eight prompts, prefilled), one round of
    ``specs.make_paged_spec_round`` run eagerly with ``sample_tokens``
    recording the logits it is handed (k draft calls of B rows, then the
    verify's k·B).  Per verify row against the draft row that computed the
    same (slot, position): max|Δlogit|, rows not bit-equal, and rows whose
    greedy argmax or WTA decision (the slot's key, step + j) differs."""
    from repro_torch.kernels import ops as KOPS
    from repro_torch.launch import specs as SP
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(params, cfg, spec_serve_config(max_new_tokens=64), device=dev,
                        graphs=False)
    for p in prompts[:8]:
        eng.submit(p)
    while eng._job_fifo or eng.sched.queued():
        eng.tick()
    active = eng.sched.active()
    assert len(active) == 8, len(active)
    b = eng.cfg.max_batch
    eng._cow_pass(active, k)   # as the engine does before every round
    w = eng._window_blocks(active, k)
    pos = eng._host_pos.copy()
    seen = []
    real = SP.sample_tokens

    def keep(c, logits, *a, **kw):
        seen.append(logits)
        return real(c, logits, *a, **kw)

    attn = []   # (q, out) of every decode attention call, in call order
    real_attn = KOPS.paged_attention

    def keep_attn(q, *a, **kw):
        out = real_attn(q, *a, **kw)
        attn.append((q.clone(), out.clone()))
        return out

    keys = torch.as_tensor(eng._req_keys, device=dev)
    steps = torch.as_tensor(eng._steps, device=dev)
    SP.sample_tokens = keep
    KOPS.paged_attention = keep_attn
    try:
        SP.make_paged_spec_round(cfg, k)(
            eng.params, eng._cache,
            torch.as_tensor(np.ascontiguousarray(eng._table[:, :w]), device=dev),
            torch.as_tensor(eng._tokens, device=dev), keys, steps)
    finally:
        SP.sample_tokens = real
        KOPS.paged_attention = real_attn
    wcfg = dataclasses.replace(cfg, wta_head=True)
    draft, verify = torch.stack(seen[:k]), seen[k].reshape(k, b, -1)
    diff = (verify.float() - draft.float()).abs()
    out = {"w": w, "max_abs_diff": float(diff.max()),
           "rows_not_bit_equal": int((diff.amax(dim=-1) > 0).sum()), "rows": k * b,
           "argmax_differ": int((verify.argmax(-1) != draft.argmax(-1)).sum()),
           "wta_differ": sum(int((SP.sample_tokens(wcfg, verify[j], keys, steps + j)
                                  != SP.sample_tokens(wcfg, draft[j], keys, steps + j)).sum())
                             for j in range(k))}
    out["bit_equal"] = out["rows_not_bit_equal"] == 0
    out["differing_rows"] = [(int(s), int(j), int(pos[s]) + int(j)) for j, s in
                             (diff.amax(dim=-1) > 0).nonzero().tolist()]
    # where a differing row first parts from its draft: the first layer
    # whose attention query, then whose attention output, differs
    n = cfg.n_layers
    out["first_layer"] = {}
    for s_, j, _ in out["differing_rows"][:4]:
        pairs = [(attn[j * n + lay], attn[k * n + lay]) for lay in range(n)]
        q_at = next((lay for lay, (d, v) in enumerate(pairs)
                     if not torch.equal(d[0][s_], v[0][j * b + s_])), None)
        o_at = next((lay for lay, (d, v) in enumerate(pairs)
                     if not torch.equal(d[1][s_], v[1][j * b + s_])), None)
        out["first_layer"][(s_, j)] = {"q": q_at, "attention": o_at}
    log(f"  probe {cfg.dtype} weights, {'int8' if cfg.kv_cache_dtype == 'int8' else cfg.dtype} "
        f"pool, k = {k}, W = {w}: verify vs draft rows max|Δlogit| {out['max_abs_diff']:.3e}, "
        f"{out['rows_not_bit_equal']}/{out['rows']} rows not bit-equal, argmax differs in "
        f"{out['argmax_differ']}, WTA decision in {out['wta_differ']}"
        + (f"; (slot, j, position) of rows that differ {out['differing_rows'][:8]}; the "
           f"first layer whose attention query / output differs, by (slot, j) "
           f"{out['first_layer']}" if out["differing_rows"] else ""))
    del eng, seen, draft, verify, diff, attn
    torch.cuda.empty_cache()
    return out


def spec_run(params, cfg, prompts, dev, k: int, tag: str, *, tamper: bool = False,
             injector=None, mesh=None) -> dict:
    """One phase 4d serve through the compiled engine at ``speculate_k = k``
    (every request at once): streams, speculation metrics, launches (reset
    just before, read just after), ``compile_counts()``, round captures and
    their ms, captures made inside rollbacks (must be none), memory.  With
    ``tamper`` every other round reports its drafts at step 1 wrong, after
    the round, as the reference's forced-rejection test does."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import stoch_round as SR
    from repro_torch.kernels import wta_sample as WS
    from repro_torch.serving import ServingEngine

    from repro_torch import parallel as PX

    scfg = spec_serve_config(speculate_k=k, fault_injector=injector, mesh=mesh)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng = ServingEngine(params, cfg, scfg, device=dev)
    ptrs = {n: v.data_ptr() for n, v in PX.local(eng._cache).items()}
    rb_captures, calls = spec_instrument(eng, tamper)
    for p in prompts:
        eng.submit(p)
    PA.launches = PF.launches = SR.launches = SR.write_launches = WS.launches = 0
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode": PA.launches, "prefill": PF.launches, "stoch_round": SR.launches,
                "write_kv_int8": SR.write_launches, "wta_sample": WS.launches}
    m = eng.metrics()
    counts = eng.compile_counts()
    caps = [(key, ms) for _, key, ms in eng.capture_log()]
    spec_caps = [(key[1:], ms) for key, ms in caps if key[0] == "spec"]
    plain = m.decode_steps - m.spec_rounds
    n = attn_layers(cfg)
    reqs = eng.sched.all_requests()
    out = {"outs": outs, "reasons": {r.rid: r.done_reason for r in reqs},
           "metrics": {f: getattr(m, f) for f in (
               "spec_rounds", "spec_drafted", "spec_accepted", "spec_acceptance",
               "spec_tokens_per_round", "tokens_per_s", "decode_step_ms", "ttft_mean",
               "ttft_p99", "decode_steps", "total_tokens", "preemptions", "restores")},
           "launches": launches, "compile_counts": counts, "captures": caps, "wall_s": wall,
           "tampered_rounds": calls["n"] // 2, "rollbacks": len(rb_captures),
           "ptrs_kept": ptrs == {n_: v.data_ptr() for n_, v in PX.local(eng._cache).items()},
           "free_blocks": (eng.blocks.available, eng.blocks.capacity), "plain_ticks": plain}
    del eng
    torch.cuda.empty_cache()
    out["left_mib"] = (torch.cuda.memory_allocated() - mem0) / 2**20
    log(f"  ({tag}) {m.completed} requests, {m.total_tokens} tokens in {wall:.2f} s: "
        f"{m.tokens_per_s:.1f} tok/s, decode step {m.decode_step_ms:.2f} ms over "
        f"{m.decode_steps} steps ({m.spec_rounds} rounds, {plain} plain ticks), TTFT mean "
        f"{m.ttft_mean * 1e3:.1f} ms p99 {m.ttft_p99 * 1e3:.1f} ms; spec drafted "
        f"{m.spec_drafted}, accepted {m.spec_accepted} ({m.spec_acceptance:.4f}), "
        f"{m.spec_tokens_per_round:.2f} tokens a round over all slots; rollbacks "
        f"{len(rb_captures)}"
        + (f", tampered rounds {calls['n'] // 2}" if tamper else "")
        + (f"; preemptions {m.preemptions}, restores {m.restores}"
           if injector is not None else ""))
    log(f"  ({tag}) launches {launches} (decode attention per round "
        f"{(launches['decode'] - n * plain) / max(m.spec_rounds, 1):.1f}); compile_counts "
        f"{counts}; captures " + ", ".join(f"{key} {ms:.1f} ms" for key, ms in caps)
        + f"; {out['left_mib']:.1f} MiB left once the engine is dropped")
    assert sorted(outs) == list(range(len(prompts))), (tag, "requests lost")
    assert all(r == "length" for r in out["reasons"].values()), (tag, out["reasons"])
    assert all(len(o) == SPEC_NEW_TOKENS for o in outs.values()), tag
    assert m.spec_rounds > 0 and m.spec_drafted > 0, tag
    # one captured round per (W, k), never one per tick, none by a rollback
    assert counts["spec_round"] == len(spec_caps) == len({w for (w, _), _ in spec_caps}), tag
    assert all(kk == k for (_, kk), _ in spec_caps), (tag, spec_caps)
    assert m.spec_rounds > counts["spec_round"], (tag, counts)
    assert sum(rb_captures) == 0, (tag, rb_captures)
    assert counts["spec_rollback"] == (1 if rb_captures else 0), (tag, counts)
    # decode attention: one launch a layer for each of the k draft steps
    # and the verify, one a layer for a plain tick
    assert launches["decode"] == n * ((k + 1) * m.spec_rounds + plain), (tag, launches)
    assert (launches["prefill"] > 0) == (n > 0) and launches["stoch_round"] == 0, (tag, launches)
    if cfg.kv_cache_dtype == "int8":
        # one fused write beside every writing attention launch (the
        # verify writes nothing)
        assert launches["write_kv_int8"] == (launches["decode"] - n * m.spec_rounds
                                             + launches["prefill"]) > 0, (tag, launches)
    else:
        assert launches["write_kv_int8"] == 0, (tag, launches)
    # WTA: one launch a draft step, one a verify, one a plain tick, one a
    # request's first token
    want = (k + 1) * m.spec_rounds + plain + len(prompts) if cfg.wta_head else 0
    assert launches["wta_sample"] == want, (tag, launches, want)
    assert out["ptrs_kept"] and out["free_blocks"][0] == out["free_blocks"][1], tag
    assert out["left_mib"] < 32, (tag, out["left_mib"])
    return out


def spec_instrument(eng, tamper: bool) -> tuple[list, dict]:
    """Count the captures each rollback makes (must be none) and, with
    ``tamper``, report every other round's drafts at step 1 wrong.  The
    wrappers live on the engine alone, so dropping it frees its graphs."""
    rb_captures, calls = [], {"n": 0}
    rollback = eng._spec_rollback.fn
    graphs = [eng._spec_graphs, *eng._serve_steps.values()]   # no rebuild in 4d

    def counted_rollback(*a):
        n = sum(len(g.captures()) for g in graphs)
        out = rollback(*a)
        rb_captures.append(sum(len(g.captures()) for g in graphs) - n)
        return out

    eng._spec_rollback.fn = counted_rollback
    if tamper:
        orig = eng._spec_round

        def tampered(*a):
            d, dok, v, vok, vs = orig(*a)
            calls["n"] += 1
            if calls["n"] % 2 == 0:
                d = d.clone()
                d[:, 1] ^= 1
            return d, dok, v, vok, vs

        eng._spec_round = tampered
    return rb_captures, calls


def batch_width_probe(params, cfg, dev) -> dict:
    """Which of the decode step's operations give a row other bits at 32
    rows (a k = 4 verify of B = 8) than at 8 (its draft), bf16 and f32, at
    full width: the projections (cuBLAS picks its GEMM by M) and the RMS
    norm (PyTorch's reduction picks its launch by the rows)."""
    from repro_torch.models import layers as TL
    from repro_torch.models.transformer import unit_params

    gen = torch.Generator(device=dev).manual_seed(5)
    up = unit_params(params["units"], 0)["l0"]
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        x = torch.randn((32, 1, cfg.d_model), generator=gen, device=dev).to(dt)
        h = torch.randn((32, 1, cfg.d_ff), generator=gen, device=dev).to(dt)
        ops = {name: (x, lambda a, w=up["attn"][name]: a @ w.to(dt))
               for name in ("wq", "wk", "wv", "wo")}
        ops.update({name: (x, lambda a, w=up["ffn"][name]: a @ w.to(dt))
                    for name in ("w_up", "w_gate")})
        ops.update({"w_down": (h, lambda a: a @ up["ffn"]["w_down"].to(dt)),
               "logits": (x, lambda a: TL.logits_out(
                   {"embedding": params["embed"]["embedding"].to(dt)}, None, a, cfg)),
                    "rmsnorm": (x, lambda a: TL.rmsnorm(up["ln1"], a, cfg.norm_eps))})
        for name, (a, fn) in ops.items():
            full, part = fn(a)[:8], fn(a[:8])
            out[f"{tag} {name}"] = {"bit_equal": bool(torch.equal(full, part)),
                                    "max_abs_diff": float((full.float() - part.float()).abs().max())}
    log("  batch width 8 against 32 rows, per operation (bit-equal, max|diff|): "
        + ", ".join(f"{k} {v['bit_equal']} {v['max_abs_diff']:.3e}" for k, v in out.items()))
    torch.cuda.empty_cache()
    return out


def spec_turns(params, cfg, dev, n_ticks: int = 3, rounds: int = 6) -> dict:
    """Host ms of a replayed speculative round against a replayed plain
    tick, in turns in one process (no profiler): greedy plain, greedy at
    k = 4, WTA plain and WTA at k = 3, 8 slots at positions ≈ 128 on, each
    tick ending in the engine's own sync; tokens a tick beside."""
    from repro_torch.serving import ServingEngine

    rng = np.random.default_rng(2)
    wcfg = dataclasses.replace(cfg, wta_head=True)
    engines = {}
    for name, c, k in (("greedy", cfg, 0), ("greedy k=4", cfg, 4), ("wta", wcfg, 0),
                       ("wta k=3", wcfg, 3)):
        # default buckets: the 100-token prompts start at 128, and a budget
        # of 120 keeps every round and tick inside W = 16, with all 8 slots
        # decoding to the end of the turns (the first slot drafts during
        # the others' 7 prefill ticks)
        eng = ServingEngine(params, c, spec_serve_config(
            max_new_tokens=120, speculate_k=k, prefill_buckets=()), device=dev)
        for _ in range(8):
            eng.submit(rng.integers(0, cfg.vocab, 100).tolist())
        while eng._job_fifo or eng.sched.queued():
            eng.tick()
        eng.tick()
        engines[name] = eng
    torch.cuda.synchronize()
    names = list(engines)
    ms = {k: [] for k in names}
    toks = {k: 0 for k in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[: r % len(names)]:
            eng = engines[name]
            t0 = time.perf_counter()
            for _ in range(n_ticks):
                toks[name] += len(eng.tick())
            ms[name].append((time.perf_counter() - t0) * 1e3 / n_ticks)
    out = {"runs": ms, "median": {k: float(np.median(v)) for k, v in ms.items()},
           "tokens_per_tick": {k: toks[k] / (rounds * n_ticks) for k in names}}
    out["gap_ms"] = {k: out["median"][k] * 8 / max(out["tokens_per_tick"][k], 1e-9)
                     for k in names}
    assert all(len(e.sched.active()) == 8 for e in engines.values()), "a slot finished"
    for name in names:
        eng = engines[name]
        log(f"  host ms a replayed {'round' if 'k=' in name else 'tick'} in turns "
            f"({rounds} x {n_ticks}), {name}: {[round(x, 2) for x in ms[name]]} (median "
            f"{out['median'][name]:.2f}), {out['tokens_per_tick'][name]:.2f} tokens a tick over "
            f"8 slots: a slot's token gap {out['gap_ms'][name]:.3f} ms"
            + (f", acceptance {eng.metrics().spec_acceptance:.4f}" if eng.spec_k else "")
            + f"; compile_counts {eng.compile_counts()}")
    for name in ("greedy k=4", "wta k=3"):
        assert engines[name].compile_counts()["spec_round"] == 1, engines[name].compile_counts()
    del engines
    torch.cuda.empty_cache()
    return out


def spec_phase(params, cfg, prompts, dev, res: dict) -> dict:
    """Phase 4d at stablelm-3b's full width and depth through the compiled
    engine: the verify-vs-draft probe (bf16 and f32 weights, bf16/f32 and
    int8 pools), then (a) greedy k = 4, (b) WTA k = 3, (c) int8 greedy
    k = 4, (d) forced rejections, (e) forced preempts under k = 3; the
    host ms of a replayed round in turns.  Where the probe finds the bf16
    verify rows bit-equal to their drafts, (a), (b), (d), (e) are gated on
    phase 4's streams; otherwise on an f32 copy of the weights against its
    own plain serve, the bf16 agreement printed beside.  int8 is never
    gated on streams (its decode depends on W, ROADMAP C)."""
    from repro_torch.serving import FaultInjector

    p32 = tree_float(params)
    c32 = dataclasses.replace(cfg, dtype="float32")
    icfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    probe = {"bf16": spec_probe(params, cfg, prompts, dev),
             "bf16_int8": spec_probe(params, icfg, prompts, dev),
             "f32": spec_probe(p32, c32, prompts, dev),
             "f32_int8": spec_probe(p32, dataclasses.replace(c32, kv_cache_dtype="int8"),
                                    prompts, dev)}
    probe["ops"] = batch_width_probe(params, cfg, dev)
    # the bf16 model's rows must match in both pools: a row that differs in
    # one says the step is not batch-invariant, only mostly rounded alike
    gate_bf16 = probe["bf16"]["bit_equal"] and probe["bf16_int8"]["bit_equal"]
    log(f"  the bf16 verify rows are {'' if gate_bf16 else 'not all '}bit-equal to their drafts: "
        f"streams gated on {'phase 4' if gate_bf16 else 'an f32 copy against its own plain serve'}")

    def force():
        inj = FaultInjector()
        for t in SPEC_PREEMPT_TICKS:
            inj.at(t, "preempt")
        return inj

    wcfg = dataclasses.replace(cfg, wta_head=True)
    runs = {"a": spec_run(params, cfg, prompts, dev, 4, "a) bf16 greedy k=4"),
            "b": spec_run(params, wcfg, prompts, dev, 3, "b) bf16 WTA k=3"),
            "c": spec_run(params, icfg, prompts, dev, 4, "c) int8 greedy k=4"),
            "d": spec_run(params, cfg, prompts, dev, 4, "d) bf16 greedy k=4, forced rejections",
                          tamper=True),
            "e": spec_run(params, cfg, prompts, dev, 3, "e) bf16 greedy k=3, forced preempts",
                          injector=force())}
    assert runs["d"]["tampered_rounds"] >= 1 and runs["d"]["compile_counts"]["spec_rollback"] == 1
    assert runs["d"]["metrics"]["spec_accepted"] < runs["d"]["metrics"]["spec_drafted"]
    pre = runs["e"]["metrics"]
    assert pre["preemptions"] >= 1 and pre["restores"] == pre["preemptions"], pre
    want = {"a": res["same"]["outs"], "b": res["wta"]["outs"], "c": res["int8"]["outs"],
            "d": res["same"]["outs"], "e": res["same"]["outs"]}
    for key, run in runs.items():
        run["agree"] = preempt_check(f"4d {key}", run, want[key],
                                     gate=gate_bf16 and key != "c", against="phase 4's")
    # (d) and (e) against (a): the same rounds' verify tokens, realigned
    for key in ("d", "e"):
        runs[key]["agree_a"] = preempt_check(f"4d {key} vs a", runs[key], runs["a"]["outs"],
                                             gate=gate_bf16, against="run (a)'s")
    out = {"probe": probe, "gate_bf16": gate_bf16, "runs": runs}
    if not gate_bf16:
        out["f32"] = spec_f32(p32, c32, prompts, dev, force)
    del p32
    torch.cuda.empty_cache()
    out["turns"] = spec_turns(params, cfg, dev)
    return out


def spec_f32(p32, c32, prompts, dev, force) -> dict:
    """(a), (b), (d) and (e) on an f32 copy of the weights, each gated
    token for token against the f32 plain serve (``speculate_k = 0``)."""
    from repro_torch.serving import ServingEngine

    w32 = dataclasses.replace(c32, wta_head=True)
    base = {}
    for name, c in (("greedy", c32), ("wta", w32)):
        eng = ServingEngine(p32, c, spec_serve_config(), device=dev)
        for p in prompts:
            eng.submit(p)
        base[name] = eng.run()
        del eng
    runs = {"a": spec_run(p32, c32, prompts, dev, 4, "a f32) greedy k=4"),
            "b": spec_run(p32, w32, prompts, dev, 3, "b f32) WTA k=3"),
            "d": spec_run(p32, c32, prompts, dev, 4, "d f32) forced rejections", tamper=True),
            "e": spec_run(p32, c32, prompts, dev, 3, "e f32) forced preempts",
                          injector=force())}
    for key, run in runs.items():
        run["agree"] = preempt_check(f"4d {key} f32", run, base["wta" if key == "b" else "greedy"],
                                     gate=True, against="the f32 plain serve's")
    assert runs["d"]["compile_counts"]["spec_rollback"] == 1
    assert runs["e"]["metrics"]["restores"] == runs["e"]["metrics"]["preemptions"] >= 1
    torch.cuda.empty_cache()
    return runs


# CUgraphNodeType values (cuda.h) of the nodes a decode step captures
# ---------------------------------------------------------------------------
# Phase 4f: the dense KV layout and the static engine.
# ---------------------------------------------------------------------------

# tests/test_serving.py::test_int8_paged_matches_int8_dense's agreement
DENSE_INT8_AGREEMENT = 0.95


def dense_serve_config(**kw):
    """Phase 4's ServeConfig on the dense layout: the same buckets, slots,
    budget and seed, no ``prefill_chunk`` (the dense layout prefills a
    whole bucket at admission)."""
    from repro_torch.serving import ServeConfig

    base = dict(max_batch=8, max_len=512, max_new_tokens=32, seed=0, kv_layout="dense",
                prefill_buckets=(32, 64, 120, 128, 200, 256, 320))
    base.update(kw)
    return ServeConfig(**base)


def kernel_counters() -> dict:
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import stoch_round as SR
    from repro_torch.kernels import wta_sample as WS

    return {"decode": PA.launches, "prefill": PF.launches, "stoch_round": SR.launches,
            "write_kv_int8": SR.write_launches, "wta_sample": WS.launches}


def reset_kernel_counters() -> None:
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import stoch_round as SR
    from repro_torch.kernels import wta_sample as WS

    PA.launches = PF.launches = SR.launches = SR.write_launches = WS.launches = 0


def dense_run(params, cfg, prompts, dev, tag: str, *, graphs: bool = True,
              profile: bool = False) -> dict:
    """One serve of ``prompts`` through the dense engine: streams, metrics,
    captures (one per batch width: one), ``compile_counts()`` (the
    reference's keys), the kernels launched (reset just before, read just
    after: no decode or prefill attention kernel, no int8 write; under
    WTA one ``wta_sample`` a tick and one a first token), an optional
    profile of replayed full-batch ticks, and the memory left behind."""
    from repro_torch.serving import ServingEngine

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng = ServingEngine(params, cfg, dense_serve_config(), device=dev, graphs=graphs)
    for p in prompts:
        eng.submit(p)
    reset_kernel_counters()
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counters()
    m = eng.metrics()
    counts = eng.compile_counts()
    captures = eng._decode.captures()
    buckets = {eng._bucket(len(p)) for p in prompts}
    log(f"  (4f {tag}) served {m.completed} requests, {m.total_tokens} tokens in {wall:.2f} s: "
        f"{m.tokens_per_s:.1f} tok/s, TTFT mean {m.ttft_mean * 1e3:.1f} ms p99 "
        f"{m.ttft_p99 * 1e3:.1f} ms, decode step {m.decode_step_ms:.2f} ms over "
        f"{m.decode_steps} steps, occupancy {m.occupancy_mean:.2f}; compile_counts {counts}; "
        f"captures " + ", ".join(f"{k} {ms:.1f} ms" for k, ms in captures)
        + f"; launches {launches}")
    assert sorted(outs) == list(range(len(prompts))), "requests lost"
    assert all(len(o) == 32 and all(0 <= t < cfg.vocab for t in o) for o in outs.values())
    assert counts == {"serve_step": 1, "prefill": len(buckets), "insert": 1}, counts
    assert len(captures) == (1 if eng._decode.capture else 0), captures
    # the dense path reaches no attention kernel and no int8 write
    assert launches["decode"] == launches["prefill"] == 0, launches
    assert launches["write_kv_int8"] == launches["stoch_round"] == 0, launches
    want = m.decode_steps + len(prompts) if cfg.wta_head else 0
    assert launches["wta_sample"] == want, (launches, want)
    out = {"outs": outs, "metrics": dataclasses.asdict(m), "wall_s": wall, "launches": launches,
           "compile_counts": counts, "captures": [[list(k), ms] for k, ms in captures],
           "decode_step_ms": m.decode_step_ms}
    if profile:
        out["profile"] = profile_decode(eng, cfg.vocab, f"4f {tag}")
    del eng
    torch.cuda.empty_cache()
    left = (torch.cuda.memory_allocated() - mem0) / 2**20
    assert left < 32, f"the dense engine left {left:.1f} MiB behind"
    return out


@contextlib.contextmanager
def recording_margins(eng):
    """Record, for every token ``eng`` publishes, its step's top-1 logit and
    top-1/top-2 margin, keyed (rid, index): the latest ``sample_tokens``
    call's rows (a decode step's row of the slot, a first token's row 0),
    read as the scheduler records the token.  Eager engines only: a graph
    replay runs no Python."""
    from repro_torch.launch import specs as SP

    orig, last, rec = SP.sample_tokens, {}, {}

    def sample(cfg, logits, *args, **kw):
        last["top"] = torch.topk(logits.float(), 2, dim=-1).values.cpu().numpy()
        return orig(cfg, logits, *args, **kw)

    record = eng.sched.record_token

    def recording(req, t, *args, **kw):
        top = last["top"]
        row = top[0] if top.shape[0] == 1 else top[req.slot]
        rec[(req.rid, len(req.output))] = (float(row[0]), float(row[0] - row[1]))
        return record(req, t, *args, **kw)

    SP.sample_tokens, eng.sched.record_token = sample, recording
    try:
        yield rec
    finally:
        SP.sample_tokens = orig
        del eng.sched.record_token


def margin_serve(params, cfg, prompts, dev, scfg):
    """The trace through an eager engine, recording each token's margin."""
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(params, cfg, scfg, device=dev, graphs=False)
    for p in prompts:
        eng.submit(p)
    with recording_margins(eng) as rec:
        outs = eng.run()
    del eng
    torch.cuda.empty_cache()
    return outs, rec


def tie_gate(tag: str, got: dict, want: dict, want_rec: dict, got_rec: Optional[dict] = None,
             bound: Optional[float] = None) -> dict:
    """Streams ``got`` against ``want``, where a parting is allowed only at a
    tie.  Bound: the two runs compute the same logits in another order, so
    each logit may differ by up to some d between them, and an argmax can
    flip only where ``want``'s top-1/top-2 margin is below 2·d.  d is taken
    as the largest difference of the winning logit over every token the two
    streams agree on (the same token, so the same logit on both sides),
    doubled once more for the logits this sample did not see: bound =
    4·max|Δ top-1|.  Without ``got_rec`` (a side whose margins cannot be
    recorded) ``bound`` is given.  Every parting is printed with its
    margins."""
    deltas = []
    partings = []
    for r in sorted(want):
        a, b = got[r], want[r]
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        n_same = len(b) if i is None else i
        if got_rec is not None:
            deltas += [abs(got_rec[(r, j)][0] - want_rec[(r, j)][0]) for j in range(n_same)]
        if i is not None:
            partings.append((r, i, a[i], b[i], want_rec[(r, i)][1],
                             None if got_rec is None else got_rec[(r, i)][1]))
    d = max(deltas, default=0.0)
    if bound is None:
        bound = 4 * d
    total = sum(len(v) for v in want.values())
    agree = sum(x == y for r in want for x, y in zip(got[r], want[r]))
    log(f"  ({tag}) {agree}/{total} tokens equal; largest |Δ top-1 logit| over {len(deltas)} "
        f"agreeing tokens {d:.3e}; tie bound {bound:.3e}; {len(partings)} partings")
    bad = []
    for r, i, x, y, m_want, m_got in partings:
        tie = m_want <= bound
        log(f"    request {r} token {i}: {x} against {y}, margins {m_got} / {m_want:.3e} "
            f"({'a tie' if tie else 'NOT a tie'})")
        if not tie:
            bad.append((r, i))
    if bad:
        raise AssertionError(f"({tag}) streams part away from a tie at {bad}")
    return {"agree": agree, "total": total, "delta": d, "bound": bound,
            "partings": [list(p) for p in partings]}


def dense_turns(params, cfg, dev, n_ticks: int = 5, rounds: int = 6) -> dict:
    """Host ms a full-batch tick in turns (tick_turns' method): the paged and
    the dense engine, compiled, greedy and WTA, 8 slots at positions ≈
    128-190, each tick ending in the engine's own sync."""
    from repro_torch.serving import ServeConfig, ServingEngine

    rng = np.random.default_rng(2)
    wcfg = dataclasses.replace(cfg, wta_head=True)
    engines = {}
    for name, c, layout in (("paged", cfg, "paged"), ("dense", cfg, "dense"),
                            ("paged wta", wcfg, "paged"), ("dense wta", wcfg, "dense")):
        kw = dict(prefill_chunk=128) if layout == "paged" else {}
        eng = ServingEngine(params, c, ServeConfig(max_batch=8, max_len=512, kv_block_size=16,
                                                   seed=0, kv_layout=layout, **kw),
                            device=dev)
        for _ in range(8):
            eng.submit(rng.integers(0, cfg.vocab, 100).tolist(),
                       max_new_tokens=2 * rounds * n_ticks + 4)
        while getattr(eng, "_job_fifo", None) or eng.sched.queued():
            eng.tick()
        eng.tick()
        engines[name] = eng
    torch.cuda.synchronize()
    names = list(engines)
    ms = {k: [] for k in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[: r % len(names)]:
            eng = engines[name]
            t0 = time.perf_counter()
            for _ in range(n_ticks):
                eng.tick()
            ms[name].append((time.perf_counter() - t0) * 1e3 / n_ticks)
    out = {"runs": ms, "median": {k: float(np.median(v)) for k, v in ms.items()}}
    assert all(len(e.sched.active()) == 8 for e in engines.values()), "a slot finished"
    for name in names:
        log(f"  (4f) host ms a full-batch tick in turns ({rounds} x {n_ticks}), {name}: "
            f"{[round(x, 2) for x in ms[name]]} (median {out['median'][name]:.2f}); "
            f"compile_counts {engines[name].compile_counts()}")
        assert engines[name].compile_counts()["serve_step"] == 1
    del engines
    torch.cuda.empty_cache()
    return out


def static_run(params, cfg, prompts, dev, tag: str, scfg, *, graphs: bool = True) -> dict:
    """The prompts through ``StaticServingEngine`` (waves of 8): streams,
    occupancy, tok/s, its graphs (one per wave width), its launches (no
    attention kernel; under WTA one ``wta_sample`` a decode step: one key a
    step for the whole batch, the first token an argmax)."""
    from repro_torch.serving import StaticServingEngine

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng = StaticServingEngine(params, cfg, scfg, device=dev, graphs=graphs)
    for p in prompts:
        eng.submit(p)
    reset_kernel_counters()
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counters()
    m = eng.metrics()
    widths = {len(prompts[i:i + scfg.max_batch]) for i in range(0, len(prompts), scfg.max_batch)}
    log(f"  (4f {tag}) static: {m.completed} requests, {m.total_tokens} tokens in {wall:.2f} s: "
        f"{m.tokens_per_s:.1f} tok/s, TTFT mean {m.ttft_mean * 1e3:.1f} ms, decode step "
        f"{m.decode_step_ms:.2f} ms over {m.decode_steps} steps, occupancy "
        f"{m.occupancy_mean:.2f}; captures "
        + ", ".join(f"{k} {ms:.1f} ms" for k, ms in eng._decode.captures())
        + f"; launches {launches}")
    assert len(outs) == len(prompts)
    assert eng.compile_counts() == {"serve_step": len(widths)}, eng.compile_counts()
    assert launches["decode"] == launches["prefill"] == 0, launches
    want = m.decode_steps if cfg.wta_head else 0
    assert launches["wta_sample"] == want, (launches, want)
    out = {"outs": outs, "metrics": dataclasses.asdict(m), "wall_s": wall, "launches": launches,
           "captures": [[list(k), ms] for k, ms in eng._decode.captures()]}
    del eng
    torch.cuda.empty_cache()
    left = (torch.cuda.memory_allocated() - mem0) / 2**20
    assert left < 32, f"the static engine left {left:.1f} MiB behind"
    return out


def dense_phase(params, cfg, prompts, dev, res: dict) -> dict:
    """Phase 4f: (a) the dense engine on phase 4's trace, greedy (compiled,
    then eager: the same streams) and WTA, bf16, profiled, beside phase 4's
    paged numbers, host ms a tick in turns; its streams gated against the
    paged engine's on an f32 copy (partings only at ties), bf16 agreement
    printed.  (b) int8 dense against int8 paged: agreement printed at full
    width; at the reference test's size every parting gated to a tie, the
    agreement printed beside its 0.95.
    (c) the static engine on the trace (occupancy and tok/s beside the
    continuous engines'), WTA, and f32 byte identity with the continuous
    engine on 8 prompts padded to one bucket.  (e) no attention kernel on
    the dense path; ``wta_sample`` = ticks + first tokens (dense WTA),
    decode steps (static WTA).  (d) runs in phase 4e.  Ties: two runs that
    compute the same logits in another order (f32) or from other int8
    codes part only where a margin is within their logit difference
    (:func:`tie_gate`)."""
    from repro_torch.serving import ServeConfig

    out = {}
    wcfg = dataclasses.replace(cfg, wta_head=True)
    out["greedy"] = dense_run(params, cfg, prompts, dev, "a greedy", profile=True)
    eager = dense_run(params, cfg, prompts, dev, "a greedy eager", graphs=False)
    if eager["outs"] != out["greedy"]["outs"] or eager["launches"] != out["greedy"]["launches"]:
        raise AssertionError("(4f a) the dense engine's graph and eager serves differ")
    out["eager"] = {k: eager[k] for k in ("metrics", "wall_s", "decode_step_ms")}
    out["wta"] = dense_run(params, wcfg, prompts, dev, "a WTA", profile=True)
    for tag, dense, paged in (("greedy", out["greedy"], res["same"]),
                              ("WTA", out["wta"], res["wta"])):
        dm, pm = dense["metrics"], paged["metrics"]
        log(f"  (4f a) {tag}, dense against phase 4's paged (prefill_chunk 128): trace tok/s "
            f"{dm['tokens_per_s']:.1f} vs {pm['tokens_per_s']:.1f}, TTFT mean ms "
            f"{dm['ttft_mean'] * 1e3:.1f} vs {pm['ttft_mean'] * 1e3:.1f}, decode step ms "
            f"{dense['decode_step_ms']:.2f} vs {paged['decode_step_ms']:.2f}; profiled tick "
            f"host ms {dense['profile']['host_ms']:.2f} vs {paged['profile']['host_ms']:.2f}, "
            f"device ms {dense['profile']['device_ms']:.2f} vs "
            f"{paged['profile']['device_ms']:.2f}, kernels {dense['profile']['kernels']:.0f} vs "
            f"{paged['profile']['kernels']:.0f}")
    same = res["same"]["outs"]
    agree = sum(a == b for r in same for a, b in zip(out["greedy"]["outs"][r], same[r]))
    total = sum(len(v) for v in same.values())
    out["bf16_agreement"] = [agree, total]
    log(f"  (4f a) bf16 greedy, dense against phase 4's paged streams: {agree}/{total} tokens "
        f"equal (random weights, bf16: not gated)")
    out["turns"] = dense_turns(params, cfg, dev)
    # f32: the dense streams against the paged ones, partings only at ties
    p32 = tree_float(params)
    c32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    d_out, d_rec = margin_serve(p32, c32, prompts, dev, dense_serve_config())
    p_out, p_rec = margin_serve(p32, c32, prompts, dev, dense_serve_config(kv_layout="paged"))
    out["f32"] = tie_gate("4f a, f32: dense against paged", d_out, p_out, p_rec, d_rec)
    log(f"  (4f a) f32 serves (eager, dense and paged) in {time.perf_counter() - t0:.1f} s")
    # (c) static against continuous at f32, on prompts padded to one bucket
    pad = [p[:128] for p in prompts[:8]]
    assert max(len(p) for p in pad) == 128
    scfg = ServeConfig(max_batch=8, max_len=512, max_new_tokens=32, prefill_buckets=(128,))
    s32 = static_run(p32, c32, pad, dev, "c f32", scfg)
    c_out, c_rec = margin_serve(p32, c32, pad, dev, scfg)
    # the static side samples outside sample_tokens (an argmax first): (a)'s
    # bound, the same two orders of summation plus a batch-8 prefill
    out["static_f32"] = tie_gate("4f c, f32: static against continuous, one bucket",
                                 dict(enumerate(s32["outs"])), c_out, c_rec,
                                 bound=out["f32"]["bound"])
    del p32
    torch.cuda.empty_cache()
    # (b) int8 dense against int8 paged
    i8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    di8 = dense_run(params, i8, prompts, dev, "b int8")
    pi8 = res["int8"]["outs"]
    agree = sum(a == b for r in pi8 for a, b in zip(di8["outs"][r], pi8[r]))
    out["int8"] = {"launches": di8["launches"], "metrics": di8["metrics"],
                   "full_width_agreement": [agree, total]}
    log(f"  (4f b) int8 dense (nearest rounding) against phase 4's int8 paged (stochastic "
        f"rounding), full width: {agree}/{total} = {agree / total:.4f} tokens equal (random "
        f"weights: bf16 dense and paged already part at {out['bf16_agreement'][0]}/{total}; "
        f"not gated here)")
    out["int8"]["reference_size"] = int8_reference_size(dev)
    # (c) the static engine on the whole trace, greedy and WTA
    scfg = ServeConfig(max_batch=8, max_len=512, max_new_tokens=32, seed=0)
    out["static"] = static_run(params, cfg, prompts, dev, "c greedy", scfg)
    out["static_wta"] = static_run(params, wcfg, prompts, dev, "c WTA", scfg)
    sm, dm, pm = (out["static"]["metrics"], out["greedy"]["metrics"], res["same"]["metrics"])
    log(f"  (4f c) occupancy static {sm['occupancy_mean']:.3f} / dense continuous "
        f"{dm['occupancy_mean']:.3f} / paged continuous {pm['occupancy_mean']:.3f}; tok/s "
        f"{sm['tokens_per_s']:.1f} / {dm['tokens_per_s']:.1f} / {pm['tokens_per_s']:.1f}")
    return out


def int8_reference_size(dev) -> dict:
    """``tests/test_serving.py::test_int8_paged_matches_int8_dense`` on the
    card: a seeded smoke model (bf16), its mixed trace, int8 dense
    (nearest rounding) against int8 paged (stochastic rounding), eager so
    that each token's margin is recorded.  The two quantizers move a logit
    by up to d (the largest |Δ top-1 logit| over the tokens the streams
    agree on), so every parting must be a tie within 4·d (gated); the
    agreement is printed beside the reference test's 0.95 (42 tokens: one
    early parting at a tie costs up to 12 of them, so it is a statistic of
    the weights, not gated)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), kv_cache_dtype="int8")
    params = init_lm(cfg, seed=0, device=dev)
    prompts = [[5, 6, 7, 1, 2, 3, 4, 9], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2], [4] * 20,
               [11, 12], [7] * 13]
    budgets = [6, 9, 3, 12, 5, 7]
    outs, recs = {}, {}
    for layout in ("dense", "paged"):
        scfg = ServeConfig(max_batch=3, max_new_tokens=8, max_len=64, kv_block_size=8,
                           kv_layout=layout)
        eng = ServingEngine(params, cfg, scfg, device=dev, graphs=False)
        for p, b in zip(prompts, budgets):
            eng.submit(p, b)
        with recording_margins(eng) as rec:
            outs[layout] = eng.run()
        recs[layout] = rec
    gate = tie_gate("4f b, the reference test's size: int8 dense against int8 paged",
                    outs["dense"], outs["paged"], recs["paged"], recs["dense"])
    log(f"  (4f b) agreement {gate['agree']}/{gate['total']} = "
        f"{gate['agree'] / gate['total']:.4f} (the reference test gates >= "
        f"{DENSE_INT8_AGREEMENT} on its own weights; printed)")
    return gate


NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_nodes(eng, key) -> dict:
    """Nodes of the engine's compiled step by type, for its entry ``key``:
    the step captured once more into a graph that keeps its
    ``cudaGraph_t`` (a capture runs nothing, so the engine's state does
    not move; the launch counters the capture moved are put back),
    counted with ``cuGraphGetNodes`` and ``cuGraphNodeGetType`` of
    ``libcuda``."""
    import ctypes

    from repro_torch.kernels import ops as KOPS
    from repro_torch.launch import specs as SP

    entry = eng._decode.entries[key]
    before = KOPS.launch_counts()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=SP.capture_stream(eng._decode.device.index)):
        eng._decode._run(entry.inputs)
    after = KOPS.launch_counts()
    KOPS.add_launches({k: before[k] - after[k] for k in after})
    cu = ctypes.CDLL("libcuda.so.1")
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kinds: dict[str, int] = {}
    for node in nodes:
        t = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0
        kind = NODE_TYPES.get(t.value, f"type {t.value}")
        kinds[kind] = kinds.get(kind, 0) + 1
    del g
    log(f"  graph of {eng._decode._log_key(key)}: {n.value} nodes {kinds}")
    return {"key": list(key), "nodes": n.value, "by_type": kinds}


# the host idles this long on each side of a traced stretch of decode
# ticks, so that device events stamped a little off the host's clock still
# fall inside the profiler's window
TRACE_PAD_S = 0.05


def profile_decode(eng, vocab: int, mode: str, n_ticks: int = 5, tries: int = 3) -> dict:
    """Steady-state breakdown of full-batch decode ticks: host time per
    tick, device busy share, the kernels that take the device time, and
    the WTA sampler's share where it runs.  With the compiled step every
    profiled tick is a replay: its first tick at the profile's window
    width comes before the profiler starts.

    The ticks are traced in the profiler's active cycle, after a warm-up
    cycle of as many ticks, between markers on the device timeline (spin
    kernels, and a pinned copy at each edge, left out of every count): a
    spin on each side of every decode step, whose events lie between the
    two.  The trace is held against counts the profiler does not make
    (:func:`tick_trace_problems`), and a trace that fails is taken again,
    up to ``tries`` times, then raises.  ``kernels`` counts every device
    event (kernels, copies, memsets); ``graph_nodes`` is the replayed
    graph's node count by type.  The profiled requests are left
    unfinished: the caller drops the engine."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import ops as KOPS

    rng = np.random.default_rng(1)
    for _ in range(eng.cfg.max_batch):
        eng.submit(rng.integers(0, vocab, 100).tolist(),
                   max_new_tokens=2 * tries * n_ticks + 16)
    while getattr(eng, "_job_fifo", None) or eng.sched.queued():
        eng.tick()
    eng.tick()  # warm: every slot decoding
    torch.cuda.synchronize()
    dec = eng._decode
    captured = len(dec.captures())
    pinned = torch.zeros(1, pin_memory=True)
    landing = torch.empty(1, device="cuda")
    keys = []   # the entry each profiled step calls

    def spin():
        torch.cuda._sleep(1000)

    def marked(fn):
        def call(*args):
            spin()
            out = fn(*args)
            spin()
            return out
        return call

    def key(srcs, real=dec._key):
        keys.append(real(srcs))
        return keys[-1]

    graphs = {k: e.graph for k, e in dec.entries.items() if e.graph is not None}
    dec._key = key
    if dec.capture:
        for k, g in graphs.items():
            dec.entries[k].graph = types.SimpleNamespace(replay=marked(g.replay))
    else:
        dec._run = marked(dec._run)
    nodes, seen = {}, []
    cuda = torch.autograd.DeviceType.CUDA
    try:
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                for _ in range(2):
                    keys.clear()
                    before = KOPS.launch_counts()
                    time.sleep(TRACE_PAD_S)
                    landing.copy_(pinned, non_blocking=True)
                    spin()
                    t0 = time.perf_counter()
                    for _ in range(n_ticks):
                        eng.tick()
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                    spin()
                    landing.copy_(pinned, non_blocking=True)
                    torch.cuda.synchronize()
                    launched = {k: n - before[k] for k, n in KOPS.launch_counts().items()}
                    time.sleep(TRACE_PAD_S)
                    prof.step()
            assert len(dec.captures()) == captured, "a profiled tick captured a graph"
            if dec.capture:
                for k in set(keys) - set(nodes):
                    nodes[k] = graph_nodes(eng, k)
            events = sorted((e for e in prof.events() if e.device_type == cuda
                             and not e.name.startswith("ProfilerStep")),
                            key=lambda e: e.time_range.start)
            problems = tick_trace_problems(
                events, n_ticks, launched,
                [sum(nodes[k]["by_type"].get(t, 0) for t in ("kernel", "memcpy", "memset"))
                 for k in keys] if dec.capture else None)
            if not problems:
                break
            seen.append(problems)
            log(f"  [{mode}] profile: trace {len(seen)} of {tries} disagrees with the counts: "
                f"{problems}")
        else:
            raise AssertionError(f"[{mode}] {tries} traces of {n_ticks} decode ticks disagree "
                                 f"with the counts the profiler does not make: {seen}")
    finally:
        del dec._key
        if dec.capture:
            for k, g in graphs.items():
                dec.entries[k].graph = g
        else:
            del dec._run
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    ticks = [e for e in events[marks[0] + 1:marks[-1]] if "spin_kernel" not in e.name]
    busy_ms = sum(e.time_range.elapsed_us() for e in ticks) / 1e3
    by_name: dict[str, list] = {}
    for e in ticks:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    attn = by_name.get(next((n for n in by_name if "paged_decode_kernel" in n), ""), [])
    wta = by_name.get(next((n for n in by_name if "wta_sample_kernel" in n), ""), [])
    attn_ms, wta_ms = sum(attn), sum(wta)
    out = {"host_ms": wall_ms / n_ticks, "device_ms": busy_ms / n_ticks,
           "busy": busy_ms / wall_ms, "kernels": len(ticks) / n_ticks,
           "attention_ms": attn_ms / n_ticks, "wta_sample_ms": wta_ms / n_ticks,
           "wta_sample_launches": len(wta) / n_ticks, "retakes": len(seen)}
    if dec.capture:
        out["graph_nodes"] = nodes[keys[0]]
    log(f"  [{mode}] profile: {n_ticks} full-batch decode ticks, {wall_ms / n_ticks:.2f} ms/tick "
        f"host, device busy {busy_ms / n_ticks:.2f} ms/tick ({100 * busy_ms / wall_ms:.1f}% of "
        f"wall), {len(ticks) // n_ticks} kernels/tick (the counts checked, {len(seen)} traces "
        f"retaken); decode attention {attn_ms / n_ticks:.3f} ms/tick "
        f"({100 * attn_ms / max(busy_ms, 1e-9):.1f}% of device time, {len(attn) / n_ticks:.1f} "
        f"launches/tick); WTA sampler {out['wta_sample_ms']:.4f} ms/tick "
        f"({100 * wta_ms / max(busy_ms, 1e-9):.1f}% of device time, "
        f"{out['wta_sample_launches']:.1f} launches/tick)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]:
        log(f"    {sum(ms) / n_ticks:8.3f} ms/tick  {len(ms) // n_ticks:5d}x  {name[:90]}")
    return out


def tick_trace_problems(events, n_ticks: int, launched: dict, step_nodes) -> list[str]:
    """What in a trace of ``n_ticks`` decode ticks (:func:`profile_decode`;
    device events by start time) disagrees with counts the profiler does
    not make: 2·n + 2 spins; one pinned copy outside the first and the
    last; each step's events, between its two spins, as many as its
    graph's kernel, copy and memset nodes (``step_nodes``, one a step,
    compiled), and the same in every step; the same events outside every
    step (the input copies and the token read; the stretches before the
    first step and after the last are one tick's); and the decode
    attention and WTA kernels as many as their wrappers' launch counters
    moved (``launched``)."""
    spins = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    if len(spins) != 2 * n_ticks + 2:
        return [f"{len(spins)} spins, not {2 * n_ticks + 2}"]
    problems = []
    edges = events[:spins[0]] + events[spins[-1] + 1:]
    if len(edges) != 2 or not all("Memcpy HtoD" in e.name for e in edges):
        problems.append(f"edges {[e.name for e in edges]}, not one pinned copy each")
    segs = [len(events[a + 1:b]) for a, b in zip(spins, spins[1:])]
    steps, outside = segs[1::2], segs[0::2]
    if step_nodes is not None and steps != step_nodes:
        problems.append(f"steps' events {steps}, graphs' nodes {step_nodes}")
    if len(set(steps)) != 1:
        problems.append(f"steps' events {steps}")
    if len(set(outside[1:-1] + [outside[0] + outside[-1]])) != 1:
        problems.append(f"events outside the steps {outside}")
    for kernel, counter in (("paged_decode_kernel", "paged_attention"),
                            ("wta_sample_kernel", "wta_sample")):
        n = sum(kernel in e.name for e in events)
        if n != launched[counter]:
            problems.append(f"{kernel} {n} events, {launched[counter]} launches")
    return problems


# ---------------------------------------------------------------------------
# Phase 4g: the other decoder configs.
# ---------------------------------------------------------------------------


def decoders_phase(dev) -> dict:
    """gemma2-2b at full width and depth (seed 0) on phase 4's trace: a
    bf16 pool greedy, an int8 pool and WTA sampling at its 256000-wide
    head, each compiled = eager (:func:`serve_once`); then decode past
    position 4096 with its local layers' mask held (:func:`long_context`);
    then deepseek-coder-33b and nemotron-4-340b at full width and cut
    depth (:func:`cut_serve`)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm

    cfg = get_config("gemma2-2b")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  init gemma2-2b ({cfg.n_layers}L d{cfg.d_model} H{cfg.n_heads}/{cfg.n_kv_heads} "
        f"Dh{cfg.head_dim} ff{cfg.d_ff} V{cfg.vocab} {cfg.layer_pattern} window "
        f"{cfg.local_window} caps {cfg.attn_softcap}/{cfg.logit_softcap}) in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = serve_trace(cfg.vocab)
    serve_warm_up(params, cfg, prompts, dev)
    res = {"same": serve_once(params, cfg, prompts, dev)}
    res["int8"] = serve_once(params, dataclasses.replace(cfg, kv_cache_dtype="int8"), prompts, dev)
    res["wta"] = serve_once(params, dataclasses.replace(cfg, wta_head=True), prompts, dev)
    same, wta = res["same"]["outs"], res["wta"]["outs"]
    total = sum(len(o) for o in same.values())
    agree = sum(a == b for r in same for a, b in zip(same[r], wta[r]))
    log(f"  gemma2-2b WTA vs greedy tokens: {agree}/{total} equal")
    if agree == total:
        raise AssertionError("the WTA serve emitted the greedy tokens: the sampler did not draw")
    res["long"] = long_context(params, cfg, dev)
    del params
    torch.cuda.empty_cache()
    res["cuts"] = {arch: cut_serve(arch, n, dev)
                   for arch, n in (("deepseek-coder-33b", 8), ("nemotron-4-340b", 2))}
    return res


def long_context(params, cfg, dev, lengths=(4500, 5000), buckets=(4608, 5120),
                 max_len=6144, kinds=("local", "global")) -> dict:
    """Two prompts of 4500 and 5000 tokens (buckets 4608 and 5120) through
    an eager paged engine with ``max_len`` 6144, so that decode runs at
    positions past gemma2's local window of 4096.  The first attention
    launches of the first decode step in which both slots are live (unit
    0's ``kinds``: gemma2's local layer, then its global one) are each
    held, on the same card tensors, against the plain version (within
    ATOL / RTOL); a local layer's output is also set beside the plain
    version without the window, which must differ (the mask cuts keys
    there)."""
    from repro_torch.kernels import ops as KOPS
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import ref
    from repro_torch.serving import ServeConfig, ServingEngine

    rng = np.random.default_rng(5)
    scfg = ServeConfig(max_batch=2, max_len=max_len, kv_block_size=16, max_new_tokens=4,
                       prefill_buckets=buckets, seed=0)
    eng = ServingEngine(params, cfg, scfg, device=dev, graphs=False)
    for n in lengths:
        eng.submit(rng.integers(0, cfg.vocab, n).tolist())
    held, errs = [], []
    orig = KOPS.paged_attention

    def probe(q, k_pages, v_pages, table, pos, **kw):
        got = orig(q, k_pages, v_pages, table, pos, **kw)
        if len(held) < 2 and (held or bool((table[:, 0] > 0).all())):
            kw = {k: v for k, v in kw.items() if k != "split_batch"}
            want = ref.paged_attention_ref(q, k_pages, v_pages, table, pos, **kw)
            live = pos.tolist()
            check(f"long context, first step with both slots live, {kw['kind']} layer (window "
                  f"{kw['local_window']}, cap {kw['softcap']}) at positions {live}", got, want,
                  errs)
            rec = {"kind": kw["kind"], "pos": live, "err": errs[-1]}
            if kw["kind"] == "local":
                unmasked = ref.paged_attention_ref(q, k_pages, v_pages, table, pos,
                                                   **dict(kw, kind="global"))
                rec["window_effect"] = float((want - unmasked).abs().max())
                log(f"  max|local - unwindowed| at those positions {rec['window_effect']:.3e}")
                if rec["window_effect"] == 0.0:
                    raise AssertionError(f"the local window cut no key past position "
                                         f"{cfg.local_window}")
            held.append(rec)
        return got

    PA.launches = PF.launches = 0
    KOPS.paged_attention = probe
    try:
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        KOPS.paged_attention = orig
    m = eng.metrics()
    log(f"  long context: {len(outs)} requests, {m.total_tokens} tokens in {wall:.2f} s, "
        f"decode step {m.decode_step_ms:.2f} ms, TTFT mean {m.ttft_mean * 1e3:.1f} ms; "
        f"launches decode {PA.launches} prefill {PF.launches}")
    assert [r["kind"] for r in held] == list(kinds), held
    assert min(min(r["pos"]) for r in held) > cfg.local_window and len(held[0]["pos"]) == 2, held
    assert all(len(o) == 4 for o in outs.values()) and PA.launches > 0 and PF.launches > 0
    del eng
    torch.cuda.empty_cache()
    return {"held": held, "launches": {"decode": PA.launches, "prefill": PF.launches},
            "decode_step_ms": m.decode_step_ms, "wall_s": wall}


def cut_serve(arch: str, n_layers: int, dev, profile: bool = False) -> dict:
    """``arch`` at full width and ``n_layers`` layers (seed 0): four
    requests of 20-120 tokens, 8 new tokens each, greedy on a bf16 pool,
    through the compiled engine and eagerly (streams and launches equal);
    its init time, peak device memory and decode step ms.  With
    ``profile``, the compiled engine's full-batch ticks are profiled
    (:func:`profile_decode`) beside the tick's byte bound: every weight but
    the embedding table read once."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import tree_leaves
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    tick_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)) - (
        params["embed"]["embedding"].numel() * params["embed"]["embedding"].element_size()
        if "head" in params else 0)
    log(f"  init {arch} cut to {n_layers} layers ({n_params / 1e9:.2f} B parameters, d"
        f"{cfg.d_model} H{cfg.n_heads}/{cfg.n_kv_heads} Dh{cfg.head_dim} ff{cfg.d_ff} "
        f"V{cfg.vocab}" + (f" {cfg.n_experts} experts top-{cfg.moe_topk}" if cfg.n_experts
                           else "") + (f" soft-cap {cfg.attn_softcap}" if cfg.attn_softcap
                                       else "") + f") in {init_s:.1f} s")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist() for n in rng.integers(20, 121, 4)]
    runs = {}
    for graphs in (True, False):
        eng = ServingEngine(params, cfg, ServeConfig(max_batch=4, max_len=256, kv_block_size=16,
                                                     prefill_chunk=128, max_new_tokens=8),
                            device=dev, graphs=graphs)
        for p in prompts:
            eng.submit(p)
        PA.launches = PF.launches = 0
        outs = eng.run()
        torch.cuda.synchronize()
        m = eng.metrics()
        runs[graphs] = {"outs": outs, "launches": (PA.launches, PF.launches),
                        "decode_step_ms": m.decode_step_ms, "tokens_per_s": m.tokens_per_s}
        log(f"  [{'graphs' if graphs else 'eager'}] {arch}: {m.total_tokens} tokens, decode "
            f"step {m.decode_step_ms:.2f} ms, {m.tokens_per_s:.1f} tok/s, launches decode "
            f"{PA.launches} prefill {PF.launches}")
        if profile and graphs:
            runs["profile"] = profile_decode(eng, cfg.vocab, "graphs")
        del eng
    g, e = runs[True], runs[False]
    if g["outs"] != e["outs"] or g["launches"] != e["launches"]:
        raise AssertionError(f"{arch}: compiled and eager serves differ")
    assert all(len(o) == 8 for o in g["outs"].values()) and g["launches"][0] > 0
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {arch} ({n_layers} layers): graphs = eager on {len(prompts)} streams; peak device "
        f"memory {peak:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    out = {"n_layers": n_layers, "params_b": n_params / 1e9, "peak_gib": peak, "init_s": init_s,
           "launches": {"decode": g["launches"][0], "prefill": g["launches"][1]},
           "decode_step_ms": {"graphs": g["decode_step_ms"], "eager": e["decode_step_ms"]}}
    if profile:
        bound = tick_bytes / HBM_BYTES_PER_S * 1e3
        prof = runs["profile"]
        out.update(profile=prof, tick_bytes=tick_bytes, tick_bound_ms=bound)
        log(f"  {arch} ({n_layers} layers): a replayed tick {prof['device_ms']:.3f} ms on the "
            f"device, {prof['host_ms']:.3f} ms host, against a byte bound of {bound:.3f} ms "
            f"({tick_bytes / 1e9:.2f} GB: every weight but the embedding table, once)")
    return out


# ---------------------------------------------------------------------------
# Phase 4h: recurrentgemma-2b, the hybrid model (RG-LRU blocks + MQA local
# attention).
# ---------------------------------------------------------------------------

# every block's output projection (w_out, wo, w_down) scaled by this at
# init, as in the CPU tests: at a plain random init the tied, sqrt(d)-scaled
# embedding dominates the residual, every greedy stream repeats its
# prompt's last token and the WTA vote never moves it, whatever the
# recurrent state holds (PR 26 run 1)
HYBRID_GAIN = 8.0
# (b) and (c) run an f32 copy of the model's first unit (13 of its 26
# layers) at full width; (d) its two long prompts and their buckets
HYBRID_CUT_UNITS = 1
HYBRID_LONG = dict(lengths=(2300, 2600), buckets=(2304, 2608), max_len=2688)
# (c): forced preempts of decoding slots at these ticks
HYBRID_PREEMPT_TICKS = (14, 20)
# (f): the analog step's batch; crossbar reads a layer: q, k, v, o and the
# MLP's up, gate, down for attention, w_main, w_gate_br and the MLP's
# three for a recurrent block (its w_out takes no key)
HYBRID_TRAIN_BATCH = (8, 128)
HYBRID_CB_ATTN, HYBRID_CB_REC = 7, 5
# the (W shape, comparator) of those reads: q, o and the recurrent block's
# two branches (2560, 2560), k and v (2560, 256) and the MLP's down (7680,
# 2560) linear reads, the MLP's up and gate (2560, 7680) comparator reads
HYBRID_CB_SHAPES = (((2560, 256), False), ((2560, 2560), False), ((2560, 7680), True),
                    ((7680, 2560), False))


def first_units(params: dict, n: int, dtype) -> dict:
    """A copy in ``dtype`` of the model's first ``n`` units and of the rest
    of its parameters."""
    def copy(tree, cut: bool):
        return {k: copy(v, cut) if isinstance(v, dict) else (v[:n] if cut else v).to(dtype)
                for k, v in tree.items()}

    return {k: copy(v, k == "units") for k, v in params.items()}


def hybrid_phase(dev) -> dict:
    """Phase 4h: recurrentgemma-2b at full width and depth (seed 0, bf16,
    its blocks' output projections scaled by ``HYBRID_GAIN``):
    (a) phase 4's trace and ``ServeConfig`` four ways (bf16 greedy, int8
    pool, WTA, WTA on the int8 pool), each compiled = eager
    (:func:`serve_once`), and the device time of the decode step's
    per-tick f32 casts of the gate weights; (d) two prompts past the local
    window of 2048 (:func:`long_context`); (e) both attention kernels and
    the int8 write at its head (:func:`head_shape_kernels`); then on an f32
    copy of its first unit, (b) the four shared-prefix prompts with and
    without prefix sharing (:func:`hybrid_sharing`) and (c) preemption and
    speculative rollback against plain serves (:func:`hybrid_preempt_spec`);
    (f) one ``analog_stochastic`` training step (:func:`hybrid_train`)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm, scale_block_outputs
    from repro_torch.optim import tree_leaves

    t_phase = time.perf_counter()
    cfg = get_config("recurrentgemma-2b")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    scale_block_outputs(params, HYBRID_GAIN)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  init recurrentgemma-2b ({cfg.n_layers}L = {cfg.n_units} units of "
        f"{cfg.layer_pattern}, blocks' output projections x {HYBRID_GAIN}, d{cfg.d_model} "
        f"H{cfg.n_heads}/{cfg.n_kv_heads} Dh{cfg.head_dim} ff{cfg.d_ff} "
        f"lru {cfg.lru_width} V{cfg.vocab} window {cfg.local_window}; {n_params / 1e9:.3f} B "
        f"parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB) in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = serve_trace(cfg.vocab)
    serve_warm_up(params, cfg, prompts, dev)
    log("  (a) phase 4's trace: bf16 greedy, int8 pool, WTA, WTA on the int8 pool")
    wcfg = dataclasses.replace(cfg, wta_head=True)
    res = {"same": serve_once(params, cfg, prompts, dev),
           "int8": serve_once(params, dataclasses.replace(cfg, kv_cache_dtype="int8"), prompts,
                              dev),
           "wta": serve_once(params, wcfg, prompts, dev),
           "wta_int8": serve_once(params, dataclasses.replace(wcfg, kv_cache_dtype="int8"),
                                  prompts, dev)}
    same, wta = res["same"]["outs"], res["wta"]["outs"]
    total = sum(len(o) for o in same.values())
    agree = sum(a == b for r in same for a, b in zip(same[r], wta[r]))
    log(f"  recurrentgemma-2b WTA vs greedy tokens: {agree}/{total} equal")
    if agree == total:
        raise AssertionError("the WTA serve emitted the greedy tokens: the sampler did not draw")
    res["casts"] = gate_cast_ms(params, cfg, res["same"]["profile"]["device_ms"])
    log("  (d) decode past the local window of 2048 (eager)")
    res["long"] = long_context(params, cfg, dev, kinds=("local", "local"), **HYBRID_LONG)
    log("  (e) both attention kernels and the int8 write at recurrentgemma's MQA head")
    gen = torch.Generator(device=dev).manual_seed(26)
    errs = {"decode": [], "prefill": [], "write_kv_int8": []}
    res["heads"] = head_shape_kernels(
        gen, dev, errs, [("recurrentgemma-2b", (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
                          [(cfg.local_window, 0.0, 160, (2100, 160 * 16 - 1))])])
    res["head_errs"] = errs
    c32 = dataclasses.replace(cfg, n_layers=HYBRID_CUT_UNITS * len(cfg.layer_pattern),
                              dtype="float32")
    p32 = first_units(params, HYBRID_CUT_UNITS, torch.float32)
    del params
    torch.cuda.empty_cache()
    log(f"  (b) prefix sharing on the f32 copy of the first {c32.n_layers} layers")
    res["sharing"] = hybrid_sharing(p32, c32, prompts, dev)
    log("  (c) preemption and speculative rollback on the f32 copy")
    res.update(hybrid_preempt_spec(p32, c32, prompts, dev))
    del p32
    torch.cuda.empty_cache()
    log("  (f) one analog_stochastic training step")
    res["train"] = hybrid_train(dev)
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 4h wall time {res['wall_s']:.1f} s")
    return res


def gate_cast_ms(params, cfg, tick_device_ms: float) -> dict:
    """Device ms a decode tick spends casting every recurrent block's
    ``wa`` and ``wx`` to f32 (the reference's choice, which the port
    keeps: ``rglru._gate_logits``), timed alone beside the replayed
    tick's device ms, and the device memory an f32 copy of them would
    hold instead."""
    ws = [params["units"][f"l{i}"]["rec"][name][u]
          for u in range(cfg.n_units) for i, kind in enumerate(cfg.layer_pattern)
          if kind == "rec" for name in ("wa", "wx")]

    def casts():
        return [w.float() for w in ws]

    ms = device_ms([casts], iters=8)
    f32_gib = sum(w.numel() * 4 for w in ws) / 2**30
    log(f"  per-tick f32 casts of wa and wx: {len(ws)} casts of {tuple(ws[0].shape)}, "
        f"{ms:.4f} ms on the device a tick, against {tick_device_ms:.3f} ms of the replayed "
        f"bf16 tick; an f32 copy kept instead would hold {f32_gib:.2f} GiB")
    return {"casts": len(ws), "device_ms": ms, "tick_device_ms": tick_device_ms,
            "f32_copy_gib": f32_gib}


def hybrid_sharing(p32, c32, prompts, dev, tag: str = "4h b") -> dict:
    """The trace's four prompts on the shared 128-token prefix (two take a
    partial hit, one a full hit of its twin) through the compiled engine
    with prefix sharing and without: the partial hits resume at 128, a
    chunk boundary, from the state snapshot stashed there (each read
    counted, its leaves the model's state leaves and ``pos``; an
    attention-only model resumes at its matched block with ``pos``
    alone), and the streams are equal token for token."""
    from repro_torch.models.transformer import init_prefill_state
    from repro_torch.serving import ServeConfig, ServingEngine

    want_leaves = sorted(init_prefill_state(c32, dev))
    shared = [prompts[i] for i in (2, 3, 8, 9)]
    runs = {}
    for share in (True, False):
        eng = ServingEngine(p32, c32, ServeConfig(
            max_batch=8, max_len=512, kv_block_size=16, prefill_chunk=128, max_new_tokens=32,
            prefill_buckets=(32, 64, 120, 128, 200, 256, 320), seed=0,
            enable_prefix_sharing=share), device=dev)
        reads = []
        real = eng._resume_state

        def resume_state(plan, q0, real=real, reads=reads):
            state = real(plan, q0)
            if q0:
                reads.append((q0, sorted(state)))
            return state

        eng._resume_state = resume_state
        for p in shared:
            eng.submit(p)
        outs = eng.run()
        m = eng.metrics()
        runs[share] = {"outs": outs, "snapshot_reads": reads, "partial_hits": m.prefix_partial_hits,
                       "hits": m.prefix_hits, "saved": m.prefill_tokens_saved,
                       "compile_counts": eng.compile_counts()}
        log(f"  ({tag}) sharing {'on' if share else 'off'}: prefix hits {m.prefix_hits}, partial hits "
            f"{m.prefix_partial_hits}, prefill tokens saved {m.prefill_tokens_saved}; boundary "
            f"snapshots read (q0, leaves) {reads}; compile_counts {eng.compile_counts()}")
        del eng
    on, off = runs[True], runs[False]
    assert on["partial_hits"] >= 1 and on["snapshot_reads"], on
    if any(k in ("rec", "ssm") for k in c32.layer_pattern):
        # a recurrent family resumes on the chunk grid; an attention-only
        # one at any matched block, from a zero state
        assert all(q0 % 128 == 0 for q0, _ in on["snapshot_reads"]), on["snapshot_reads"]
    assert all(leaves == want_leaves for _, leaves in on["snapshot_reads"])
    assert off["partial_hits"] == off["hits"] == 0 and not off["snapshot_reads"], off
    on["agree"] = preempt_check(tag, {"outs": on["outs"]}, off["outs"], gate=True,
                                against="the unshared f32")
    torch.cuda.empty_cache()
    return runs


def hybrid_preempt_spec(p32, c32, prompts, dev, tag: str = "4h c") -> dict:
    """On the f32 copy, each against its own plain serve, token for token:
    the trace with two forced preempts of decoding slots (their pages,
    ``pos`` and the state leaves spilled and restored; an attention-free
    model's records hold no page), and speculation at k = 3 with every
    other round's drafts reported wrong (each rejection rolls ``pos`` and
    the state back)."""
    from repro_torch.serving import FaultInjector, ServingEngine

    scfg = dataclasses.replace(preempt_serve_config(prompts)[0], num_kv_blocks=0)
    arrivals = {0: [(r, 1) for r in range(len(prompts))]}
    base = preempt_run(p32, c32, prompts, dev, scfg, f"{tag} f32) unpreempted",
                       arrivals=arrivals)
    inj = FaultInjector()
    for t in HYBRID_PREEMPT_TICKS:
        inj.at(t, "preempt")
    run = preempt_run(p32, c32, prompts, dev, scfg, f"{tag} f32) preempted", arrivals=arrivals,
                      injector=inj)
    preempt_invariants(tag, run, attention=attn_layers(c32) > 0)
    assert run["preemptions"] >= 1 and run["restores_n"] == run["preemptions"], run
    rec, state = spill_record_bytes(c32, scfg), spill_state_bytes(c32)
    assert all(s["bytes"] == rec for s in run["spills"]), (rec, run["spills"])
    log(f"  ({tag}) a spill record: {rec} bytes, of which the state and pos {state} "
        f"({c32.n_units * sum(k in ('rec', 'ssm') for k in c32.layer_pattern)} blocks' conv "
        f"tail and state)")
    run["agree"] = preempt_check(tag, run, base["outs"], gate=True,
                                 against="the unpreempted f32")
    eng = ServingEngine(p32, c32, spec_serve_config(), device=dev)
    for p in prompts:
        eng.submit(p)
    plain = eng.run()
    del eng
    spec = spec_run(p32, c32, prompts, dev, 3, f"{tag} f32) k=3 forced rejections", tamper=True)
    assert spec["tampered_rounds"] >= 1 and spec["rollbacks"] >= 1, spec["rollbacks"]
    assert spec["metrics"]["spec_accepted"] < spec["metrics"]["spec_drafted"]
    spec["agree"] = preempt_check(f"{tag} spec", spec, plain, gate=True,
                                  against="the plain f32")
    torch.cuda.empty_cache()
    return {"preempt": {"preemptions": run["preemptions"], "restores": run["restores_n"],
                        "spills": run["spills"], "restore_ms": run["restores"],
                        "record_bytes": rec, "state_bytes": state,
                        "launches": run["launches"]},
            "spec": {k: spec[k] for k in ("metrics", "launches", "compile_counts", "rollbacks",
                                          "tampered_rounds", "agree")}}


def hybrid_train(dev) -> dict:
    """Phase 4h (f): one ``analog_stochastic`` step of recurrentgemma-2b:
    ``crossbar_mac`` 7 reads an attention layer and 5 a recurrent one,
    ``sigmoid_sample`` twice a recurrent layer (its two gates), the first
    read at each of HYBRID_CB_SHAPES checked (:func:`analog_step`)."""
    from repro_torch.configs import get_config

    cfg = get_config("recurrentgemma-2b")
    n_rec = cfg.n_units * cfg.layer_pattern.count("rec")
    return analog_step(dev, "recurrentgemma-2b", {
        "sigmoid_sample": 2 * n_rec,
        "crossbar_mac": HYBRID_CB_ATTN * attn_layers(cfg) + HYBRID_CB_REC * n_rec},
        HYBRID_CB_SHAPES, "4h f")


def analog_step(dev, arch: str, want: dict, shapes, tag: str, timed: bool = False) -> dict:
    """One ``analog_stochastic`` step of ``arch`` at full width and depth
    through ``make_train_step`` (batch HYBRID_TRAIN_BATCH): finite loss
    and gradient norm; ``crossbar_mac`` reads and prepasses each
    ``want["crossbar_mac"]`` and ``sigmoid_sample`` ``want["sigmoid_sample"]``
    in the forward, and ``wta_sample`` ``want["wta_sample"]`` where
    ``want`` names it (an MoE router's WTA race, one a layer), all times
    :func:`remat_factor` over the step (reset just before, read just
    after: the backward recomputes each unit); the step's first
    crossbar read at each of its (W shape, comparator) ``shapes`` held
    against the plain version on the same x, W and key
    (:func:`check_reads`; ``timed``: each also timed beside its bound), and
    its first gate draw and first router draw, where it draws them, bit
    for bit.  Step ms and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.kernels import ops as KOPS
    from repro_torch.kernels import ref
    from repro_torch.kernels import sigmoid_sample as SS
    from repro_torch.kernels import wta_sample as WS
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = analog_cfg(get_config(arch))
    want = {k: v * remat_factor(cfg) for k, v in want.items()}
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-4), total_steps=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(0, cfg, tcfg, device=dev)
    step_fn = make_train_step(cfg, tcfg)
    b, s = HYBRID_TRAIN_BATCH
    batch = lm_batch(cfg, batch=b, seq=s, step=0, device=dev)
    torch.cuda.synchronize()
    log(f"  init {arch} ({cfg.analog.mode}) and its AdamW state in "
        f"{time.perf_counter() - t0:.1f} s")
    first = {}
    real = KOPS.sigmoid_sample

    def recorded(acc, bias, beta, key, offset=0):
        y = real(acc, bias, beta, key, offset)
        if not first:
            first.update(acc=acc.clone(), bias=bias, beta=beta, key=key, offset=offset,
                         y=y.clone())
        return y

    draw = {}
    real_draw = KOPS.wta_trial_counts

    def drawn(z, keys, folds, n_trials, vth0, sigma_z, layout):
        out = real_draw(z, keys, folds, n_trials, vth0, sigma_z, layout)
        if not draw:
            draw.update(z=z.detach().clone(), keys=keys.clone(), folds=folds,
                        kw=dict(n_trials=n_trials, vth0=vth0, sigma_z=sigma_z, layout=layout),
                        out=tuple(t.clone() for t in out))
        return out

    KOPS.sigmoid_sample = recorded
    KOPS.wta_trial_counts = drawn
    reads = {}
    SS.launches = CB.launches = CB.prepass_launches = WS.launches = 0
    try:
        with recording_reads(reads):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
    finally:
        KOPS.sigmoid_sample = real
        KOPS.wta_trial_counts = real_draw
    launches = {"sigmoid_sample": SS.launches, "crossbar_mac": CB.launches,
                "crossbar_prepass": CB.prepass_launches}
    if "wta_sample" in want:
        launches["wta_sample"] = WS.launches
    aux = float(metrics["aux"]) if "aux" in metrics else None
    peak = torch.cuda.max_memory_allocated() / 2**30
    same, gate_err = True, 0.0
    if first:
        a = first["acc"].reshape(-1, first["acc"].shape[-1])
        want_y = ref.sigmoid_sample_ref(a.float().contiguous(), first["bias"],
                                        beta=first["beta"], key=first["key"],
                                        offset=first["offset"]).reshape(first["y"].shape)
        same = torch.equal(first["y"], want_y)
        gate_err = float((first["y"] - want_y).abs().max())
        log(f"  {tag}: the first gate draw {tuple(first['y'].shape)} equal to the plain "
            f"version's {same} ({float(first['y'].mean()):.4f} fire)")
    router_same = True
    if draw:
        want_c, want_d = ref.wta_trial_counts_ref(draw["z"], draw["keys"], draw["folds"],
                                                  **draw["kw"])
        router_same = torch.equal(draw["out"][0], want_c) and torch.equal(draw["out"][1], want_d)
        log(f"  {tag}: the first router draw {tuple(draw['z'].shape)} x {draw['kw']['n_trials']} "
            f"trials: counts and decisions equal to the plain version's {router_same} "
            f"({int(draw['out'][0].sum())} votes)")
    log(f"  {tag} analog step: loss {loss:.4f}" + ("" if aux is None else f" (aux {aux:.6f})")
        + f", grad norm {float(metrics['grad_norm']):.4f}, "
        f"{step_s * 1e3:.1f} ms (the first step: allocations included), peak memory "
        f"{peak:.2f} GiB; launches {launches}, expected {want}")
    if not (np.isfinite(loss) and np.isfinite(float(metrics["grad_norm"]))
            and (aux is None or np.isfinite(aux))):
        raise AssertionError(f"non-finite analog step: loss {loss}, aux {aux}")
    if not router_same:
        raise AssertionError("the router draw differs from wta_sample's plain version")
    if launches != dict(want, crossbar_prepass=want["crossbar_mac"]):
        raise AssertionError(f"{tag} analog step launched {launches}, expected {want}")
    if not same:
        raise AssertionError("the gate draw differs from sigmoid_sample's plain version")
    del state
    torch.cuda.empty_cache()
    got_shapes = {(ws, binarize) for _, ws, binarize in reads}
    if got_shapes != set(shapes):
        raise AssertionError(f"the analog step read at {sorted(got_shapes)}, expected "
                             f"{sorted(shapes)}")
    checked = check_reads(reads, tag, timed=timed)
    return {"launches": launches, "loss": loss, "step_ms": step_s * 1e3, "peak_gib": peak,
            "reads": checked, "gate_shape": list(first["y"].shape) if first else None,
            "gate_err": gate_err, "aux": aux,
            "router_shape": list(draw["z"].shape) if draw else None,
            "router_err": float((draw["out"][0] - want_c).abs().max()) if draw else None}


# ---------------------------------------------------------------------------
# Phase 4i: mamba2-1.3b, the attention-free model (Mamba-2 SSD mixers, no
# K/V pool).
# ---------------------------------------------------------------------------

# (b): one prompt prefilled whole (the dense layout's lm_prefill) and in
# chunks of SSM_PREFILL_CHUNK tokens (each padded to the SSD chunk of 256):
# the two sum in other orders, so they agree by tolerance, relative to the
# largest magnitude of the compared tensor (f32 gated, bf16 printed)
SSM_LONG_PROMPT, SSM_PREFILL_CHUNK = 2048, 128
SSM_CHUNK_RTOL = 1e-3
# (c) runs an f32 copy of the first SSM_CUT_LAYERS layers, every mixer's
# out_proj scaled by HYBRID_GAIN and its D skip zeroed: at the plain init
# the skip D·x outweighs the state's C·h, so a lost state barely moves a
# stream (tests/_block_gain.py; (a) measures it at full depth)
SSM_CUT_LAYERS = 12
# (d): crossbar reads a layer, in_proj (2048, 8512) and out_proj (4096,
# 2048), both linear (analog_stochastic projects linearly in a mixer)
SSM_CB_PER_LAYER = 2
SSM_CB_SHAPES = (((2048, 8512), False), ((4096, 2048), False))


def ssm_phase(dev) -> dict:
    """Phase 4i: mamba2-1.3b at full width and depth (seed 0, bf16): (a)
    phase 4's trace and ``ServeConfig`` greedy and WTA, each compiled =
    eager (:func:`serve_once`), no attention kernel or int8 write, and an
    int8 config (compiled) giving the greedy streams; whether the streams
    read the state (:func:`ssm_state_probe`); the device ms of a tick's
    SSM state update (:func:`ssm_update_ms`); (b) a prompt of 2048 tokens
    prefilled in chunks of 128 against one whole-bucket prefill
    (:func:`ssm_chunked_prefill`); on an f32 copy of its first 12 layers
    that reads its state (out_proj x 8, D skip 0), (c) sharing on = off
    with partial hits resuming from the stashed snapshot, two forced
    preempts (spill records of state alone) and speculation with forced
    rejections, each equal to its plain serve; (d) one
    ``analog_stochastic`` training step (:func:`ssm_train`).  (e) runs with
    phase 7 (:func:`reference_ssm`)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm, scale_block_outputs
    from repro_torch.optim import tree_leaves

    t_phase = time.perf_counter()
    # earlier phases leave reference cycles holding device memory (12 GiB
    # after phase 4h on the H100) that a collection mid-serve would free,
    # making this phase's memory readings negative and its host times noisy
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  init mamba2-1.3b ({cfg.n_layers} mixers, d{cfg.d_model} d_inner {cfg.d_inner} "
        f"{cfg.ssm_nheads} heads x {cfg.ssm_headdim} state {cfg.ssm_state} conv {cfg.ssm_conv} "
        f"SSD chunk {cfg.ssm_chunk} V{cfg.vocab} tied; {n_params / 1e9:.4f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB) in {time.perf_counter() - t0:.1f} s")
    prompts = serve_trace(cfg.vocab)
    serve_warm_up(params, cfg, prompts, dev)
    log("  (a) phase 4's trace: bf16 greedy and WTA (compiled = eager), an int8 config")
    wcfg = dataclasses.replace(cfg, wta_head=True)
    res = {"same": serve_once(params, cfg, prompts, dev),
           "wta": serve_once(params, wcfg, prompts, dev)}
    res["int8"] = serve_run(params, dataclasses.replace(cfg, kv_cache_dtype="int8"), prompts,
                            dev, 1, graphs=True)
    same, wta = res["same"]["outs"], res["wta"]["outs"]
    if res["int8"]["outs"] != same:
        raise AssertionError("the int8 config's streams differ from bf16's: it has no pool")
    total = sum(len(o) for o in same.values())
    agree = sum(a == b for r in same for a, b in zip(same[r], wta[r]))
    moving = sum(len(set(o)) > 1 for o in same.values())
    log(f"  mamba2 int8 config = bf16 on {total} tokens; WTA vs greedy tokens: {agree}/{total} "
        f"equal; {moving}/{len(same)} greedy streams move from token to token")
    if agree == total:
        raise AssertionError("the WTA serve emitted the greedy tokens: the sampler did not draw")
    if moving < len(same) - 1:
        raise AssertionError("the greedy streams repeat one token: they read no state")
    res["probe"] = ssm_state_probe(params, cfg, prompts, dev, "bf16 full depth")
    res["update"] = ssm_update_ms(cfg, res["same"]["profile"]["device_ms"], dev)
    log(f"  (b) a prompt of {SSM_LONG_PROMPT} tokens: chunks of {SSM_PREFILL_CHUNK} against "
        f"whole-bucket prefill")
    res["chunked"] = {"bf16": ssm_chunked_prefill(params, cfg, dev, gate=False)}
    p32 = first_units(params, cfg.n_units, torch.float32)
    res["chunked"]["f32"] = ssm_chunked_prefill(p32, dataclasses.replace(cfg, dtype="float32"),
                                                dev, gate=True)
    c32 = dataclasses.replace(cfg, n_layers=SSM_CUT_LAYERS, dtype="float32")
    p32 = first_units(params, SSM_CUT_LAYERS, torch.float32)
    del params
    torch.cuda.empty_cache()
    scale_block_outputs(p32, HYBRID_GAIN)
    p32["units"]["l0"]["mixer"]["d_skip"].zero_()
    res["probe_f32"] = ssm_state_probe(p32, c32, prompts, dev,
                                       f"f32, {SSM_CUT_LAYERS} layers, D 0, out_proj x 8")
    log(f"  (c) prefix sharing, preemption and speculative rollback on the f32 copy of the "
        f"first {SSM_CUT_LAYERS} layers")
    res["sharing"] = hybrid_sharing(p32, c32, prompts, dev, tag="4i c")
    res.update(hybrid_preempt_spec(p32, c32, prompts, dev, tag="4i c"))
    del p32
    torch.cuda.empty_cache()
    log("  (d) one analog_stochastic training step")
    res["train"] = ssm_train(dev)
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 4i wall time {res['wall_s']:.1f} s")
    return res


def ssm_state_probe(params, cfg, prompts, dev, label: str) -> dict:
    """Whether the streams read the SSM state: each trace prompt prefilled
    alone (``lm_prefill``), then one decode step of its greedy token with
    the state as the prefill left it and with ``ssm_state`` zeroed: the
    largest logit change, and how many prompts' next token moves."""
    from repro_torch.models import transformer as TF

    moved, deltas = 0, []
    with torch.no_grad():
        for p in prompts:
            toks = torch.tensor([p], dtype=torch.int32, device=dev)
            cache, lg = TF.lm_prefill(params, toks, cfg, len(p) + 1)
            tok = lg.argmax(-1).to(torch.int32)
            zeroed = {n: v.clone() for n, v in cache.items()}
            zeroed["ssm_state"].zero_()
            _, a = TF.lm_decode_step(params, cache, tok, cfg)
            _, b = TF.lm_decode_step(params, zeroed, tok, cfg)
            deltas.append(float((a.float() - b.float()).abs().max()))
            moved += int(a.argmax(-1) != b.argmax(-1))
    log(f"  state probe ({label}): zeroing ssm_state before one decode step moves the logits "
        f"by max|Δ| {max(deltas):.4f} (median {float(np.median(deltas)):.4f}) and the next "
        f"greedy token of {moved}/{len(prompts)} prompts")
    if max(deltas) == 0.0:
        raise AssertionError(f"({label}) the decode step does not read ssm_state")
    return {"max_delta": max(deltas), "median_delta": float(np.median(deltas)), "moved": moved,
            "prompts": len(prompts)}


def ssm_update_ms(cfg, tick_device_ms: float, dev) -> dict:
    """Device ms a full-batch decode tick (B = 8) spends in the mixers'
    SSM state update, as ``mamba2.mamba_decode_step`` and its caller do
    it: ``state·decay + x⊗B`` into a new tensor, its read-out ``C·state``,
    and the copy back into the cache leaf, over every layer's own state,
    timed alone beside the replayed tick; its byte bound (each layer's
    state read and written once, ``decay``, ``x``, ``B``, ``C`` and ``y``
    besides)."""
    b, h, p, n = 8, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    g = torch.Generator(device=dev).manual_seed(41)
    states = [torch.randn((b, h, p, n), generator=g, device=dev) for _ in range(cfg.n_layers)]
    decay = torch.rand((b, h), generator=g, device=dev)
    xdt = torch.randn((b, h, p), generator=g, device=dev)
    bmat, cmat = (torch.randn((b, n), generator=g, device=dev) for _ in range(2))

    def update():
        for st in states:
            new = st * decay[:, :, None, None] + xdt[..., None] * bmat[:, None, None, :]
            torch.einsum("bhpn,bn->bhp", new, cmat)
            st.copy_(new)

    ms = device_ms([update], iters=4)
    nbytes = cfg.n_layers * 4 * (2 * b * h * p * n + b * h + 2 * b * h * p + 2 * b * n)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  SSM state update a tick: {cfg.n_layers} layers of ({b}, {h}, {p}, {n}) f32 "
        f"({cfg.n_layers * b * h * p * n * 4 / 2**20:.1f} MiB), {ms:.4f} ms on the device "
        f"against {tick_device_ms:.3f} ms of the replayed bf16 tick; byte bound {bound:.4f} ms")
    return {"device_ms": ms, "bound_ms": bound, "tick_device_ms": tick_device_ms,
            "state_mib": cfg.n_layers * b * h * p * n * 4 / 2**20}


def ssm_chunked_prefill(params, cfg, dev, gate: bool) -> dict:
    """One prompt of SSM_LONG_PROMPT tokens (seeded) through the dense
    layout's whole-bucket ``lm_prefill`` and through ``lm_prefill_chunk``
    in chunks of SSM_PREFILL_CHUNK from a zero state: the final
    ``ssm_state`` and the last logits, each relative to its largest
    magnitude, within SSM_CHUNK_RTOL when ``gate``, and the same greedy
    token; the host ms of each (synced)."""
    from repro_torch.models import transformer as TF

    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, SSM_LONG_PROMPT)).astype(np.int32)).to(dev)
    row = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, whole = TF.lm_prefill(params, toks, cfg, SSM_LONG_PROMPT)
        torch.cuda.synchronize()
        whole_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        state = TF.init_prefill_state(cfg, dev)
        for lo in range(0, SSM_LONG_PROMPT, SSM_PREFILL_CHUNK):
            _, state, chunked = TF.lm_prefill_chunk(
                params, toks[:, lo:lo + SSM_PREFILL_CHUNK], cfg, {}, state, row, lo)
        torch.cuda.synchronize()
        chunked_ms = (time.perf_counter() - t0) * 1e3
    out = {"whole_ms": whole_ms, "chunked_ms": chunked_ms,
           "same_token": int(whole.argmax(-1)) == int(chunked.argmax(-1))}
    for name, a, b in (("ssm_state", cache["ssm_state"], state["ssm_state"]),
                       ("ssm_conv", cache["ssm_conv"], state["ssm_conv"]),
                       ("logits", whole, chunked)):
        err = float((a.float() - b.float()).abs().max())
        out[name] = {"max_abs_err": err, "rel": err / float(a.float().abs().max())}
    log(f"  ({cfg.dtype}) whole-bucket prefill {whole_ms:.1f} ms, {SSM_LONG_PROMPT // SSM_PREFILL_CHUNK} "
        f"chunks {chunked_ms:.1f} ms; chunked vs whole: "
        + ", ".join(f"{n} max|Δ| {out[n]['max_abs_err']:.3e} ({out[n]['rel']:.2e} of its max)"
                    for n in ("ssm_state", "ssm_conv", "logits"))
        + f"; the same greedy token {out['same_token']}"
        + (f" (gate {SSM_CHUNK_RTOL} relative)" if gate else " (not gated)"))
    if gate and (not out["same_token"] or any(
            out[n]["rel"] > SSM_CHUNK_RTOL for n in ("ssm_state", "ssm_conv", "logits"))):
        raise AssertionError(f"chunked prefill parts from the whole-bucket prefill ({cfg.dtype})")
    return out


def ssm_train(dev) -> dict:
    """Phase 4i (d): one ``analog_stochastic`` step of mamba2-1.3b:
    ``crossbar_mac`` 2 reads a layer (in_proj, out_proj, both linear), no
    ``sigmoid_sample``, the first read at each of SSM_CB_SHAPES checked and
    timed beside its bound (:func:`analog_step`)."""
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-1.3b")
    return analog_step(dev, "mamba2-1.3b", {
        "sigmoid_sample": 0, "crossbar_mac": SSM_CB_PER_LAYER * cfg.n_layers},
        SSM_CB_SHAPES, "4i d", timed=True)


# ---------------------------------------------------------------------------
# Phase 4j: the MoE family (granite-moe-3b-a800m at full depth, grok-1-314b
# cut in depth).
# ---------------------------------------------------------------------------

# (c): an f32 copy of granite's first MOE_CUT_LAYERS layers at the drop-free
# capacity factor E / k (an expert then holds every token of a group), so
# that chunked and whole prefill, sharing and preemption route alike
MOE_CUT_LAYERS = 8
MOE_DROP_FREE = 5.0
# (c): one prompt prefilled whole and in chunks of MOE_PREFILL_CHUNK tokens:
# the f32 logits within MOE_CHUNK_RTOL of their largest magnitude (gated at
# the drop-free factor, printed at the published one)
MOE_LONG_PROMPT, MOE_PREFILL_CHUNK = 2048, 128
MOE_CHUNK_RTOL = 1e-3
# (d): crossbar reads a layer: q, k, v and o; the experts are digital
# einsums in both packages and the router a WTA race (one wta_sample launch
# a layer); the reads' (W shape, comparator) kinds
MOE_CB_PER_LAYER = 4
MOE_CB_SHAPES = (((1536, 512), False), ((1536, 1536), False))
# (e): grok-1-314b's layers on one card
GROK_CUT_LAYERS = 4


def moe_phase(dev) -> dict:
    """Phase 4j: granite-moe-3b-a800m at full width and depth (seed 0,
    bf16): (a) phase 4's trace and ``ServeConfig`` greedy, int8 and WTA,
    each compiled = eager (:func:`serve_once`), the device ms of a tick's
    MoE sublayers apart (:func:`moe_sublayer_ms`) and the share of the
    trace's prefill assignments its capacity drops
    (:func:`moe_drop_share`); (b) both attention kernels and the int8
    write at granite's head (H 24 / Hkv 8 / Dh 64) and grok's (H 48 /
    Hkv 8 / Dh 128, soft-cap 30) (:func:`head_shape_kernels`); on an f32
    copy of granite's first MOE_CUT_LAYERS layers at the drop-free factor,
    (c) sharing on = off with partial hits, a 2048-token prompt prefilled
    in chunks of 128 = whole (:func:`moe_chunked_prefill`; then at the
    published factor, printed), two forced preempts and speculation with
    forced rejections, each equal to its plain serve; (d) one
    ``analog_stochastic`` training step (:func:`moe_train`); (e)
    grok-1-314b at full width cut to GROK_CUT_LAYERS layers, compiled =
    eager, profiled (:func:`cut_serve`).  (f) runs with phase 7
    (:func:`reference_moe`)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import tree_leaves

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("granite-moe-3b-a800m")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  init granite-moe-3b-a800m ({cfg.n_layers}L d{cfg.d_model} H{cfg.n_heads}/"
        f"{cfg.n_kv_heads} Dh{cfg.head_dim}, {cfg.n_experts} {cfg.mlp} experts of d_ff "
        f"{cfg.d_ff} top-{cfg.moe_topk}, capacity factor {cfg.capacity_factor}, V{cfg.vocab} "
        f"tied; {n_params / 1e9:.4f} B parameters, {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB) in {time.perf_counter() - t0:.1f} s")
    prompts = serve_trace(cfg.vocab)
    serve_warm_up(params, cfg, prompts, dev)
    log("  (a) phase 4's trace: bf16 greedy, int8 pool, WTA (compiled = eager)")
    res = {"same": serve_once(params, cfg, prompts, dev),
           "int8": serve_once(params, dataclasses.replace(cfg, kv_cache_dtype="int8"), prompts,
                              dev),
           "wta": serve_once(params, dataclasses.replace(cfg, wta_head=True), prompts, dev)}
    same, wta, int8 = res["same"]["outs"], res["wta"]["outs"], res["int8"]["outs"]
    total = sum(len(o) for o in same.values())
    agree = sum(a == b for r in same for a, b in zip(same[r], wta[r]))
    agree8 = sum(a == b for r in same for a, b in zip(same[r], int8[r]))
    moving = sum(len(set(o)) > 1 for o in same.values())
    log(f"  granite WTA vs greedy tokens: {agree}/{total} equal; int8 vs bf16 pool "
        f"{agree8}/{total} (not gated); {moving}/{len(same)} greedy streams move from token to "
        f"token")
    if agree == total:
        raise AssertionError("the WTA serve emitted the greedy tokens: the sampler did not draw")
    res["sublayers"] = moe_sublayer_ms(params, cfg, res["same"]["profile"]["device_ms"], dev)
    res["drops"] = moe_drop_share(params, cfg, prompts, dev)
    log("  (b) both attention kernels and the int8 write at granite's and grok's heads")
    grok = get_config("grok-1-314b")
    gen = torch.Generator(device=dev).manual_seed(28)
    errs = {"decode": [], "prefill": [], "write_kv_int8": []}
    res["heads"] = head_shape_kernels(gen, dev, errs, [
        ("granite-moe-3b-a800m", (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim), []),
        ("grok-1-314b", (grok.n_heads, grok.n_kv_heads, grok.head_dim), [], grok.attn_softcap)])
    res["head_errs"] = errs
    c32 = dataclasses.replace(cfg, n_layers=MOE_CUT_LAYERS, dtype="float32",
                              capacity_factor=MOE_DROP_FREE)
    p32 = first_units(params, MOE_CUT_LAYERS, torch.float32)
    del params
    torch.cuda.empty_cache()
    log(f"  (c) on an f32 copy of the first {MOE_CUT_LAYERS} layers at capacity factor "
        f"{MOE_DROP_FREE} (drop-free): sharing, chunked = whole prefill, preemption, "
        f"speculative rollback")
    res["sharing"] = hybrid_sharing(p32, c32, prompts, dev, tag="4j c")
    res["chunked"] = {
        "free": moe_chunked_prefill(p32, c32, dev, gate=True),
        "published": moe_chunked_prefill(
            p32, dataclasses.replace(c32, capacity_factor=cfg.capacity_factor), dev, gate=False)}
    res.update(hybrid_preempt_spec(p32, c32, prompts, dev, tag="4j c"))
    del p32
    torch.cuda.empty_cache()
    log("  (d) one analog_stochastic training step")
    res["train"] = moe_train(dev)
    log(f"  (e) grok-1-314b at full width, cut to {GROK_CUT_LAYERS} of {grok.n_layers} layers")
    res["grok"] = cut_serve("grok-1-314b", GROK_CUT_LAYERS, dev, profile=True)
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 4j wall time {res['wall_s']:.1f} s")
    return res


def moe_sublayer_ms(params, cfg, tick_device_ms: float, dev) -> dict:
    """Device ms a full-batch decode tick (B = 8, one token a slot) spends
    in each part of the MoE blocks over every layer: the router (f32
    logits, softmax, top-k), the dispatch (slots, gather of the padded
    (E, B, C, D) buffer), the expert products and the combine, each over
    all the layers' own weights, captured alone and timed as a replay
    (:func:`replay_ms`), as the tick runs them; the products' byte bound
    (every expert's weights read once: the padded dispatch computes every
    expert's C slots) and their FLOPs, of which the real rows' share."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.transformer import unit_params

    b = 8
    g = torch.Generator(device=dev).manual_seed(43)
    x = torch.randn((b, 1, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    cap = MOE._capacity(1, cfg)
    layers = [unit_params(params["units"], u)["l0"]["moe"] for u in range(cfg.n_units)]
    with torch.no_grad():
        routes = [MOE.route(p, x, cfg) for p in layers]
        disps = [MOE._dispatch_group(x, r[1], r[2], cap, cfg, with_frac=False) for r in routes]
        outs = [MOE._experts(p, d.xg, cfg) for p, d in zip(layers, disps)]
        stages = {
            "router": lambda: [MOE.route(p, x, cfg) for p in layers],
            "dispatch": lambda: [MOE._dispatch_group(x, r[1], r[2], cap, cfg, with_frac=False)
                                 for r in routes],
            "experts": lambda: [MOE._experts(p, d.xg, cfg) for p, d in zip(layers, disps)],
            "combine": lambda: [MOE._combine_group(o, d.gate_slot, r[2], d.pos, d.kept)
                                for o, d, r in zip(outs, disps, routes)],
        }
        ms = {k: replay_ms(fn, dev) for k, fn in stages.items()}
    n_w = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    nbytes = cfg.n_layers * n_w * cfg.n_experts * cfg.d_model * cfg.d_ff * 2
    rows = cfg.n_experts * b * cap
    flops = cfg.n_layers * 2 * rows * cfg.d_model * cfg.d_ff * n_w
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    used = len({int(e) for e in routes[0][2].flatten()})
    log(f"  MoE sublayers a tick ({cfg.n_layers} layers, B = {b}, capacity {cap}: "
        f"(E, B, C, D) = ({cfg.n_experts}, {b}, {cap}, {cfg.d_model}), {rows} rows of which "
        f"{b * cfg.moe_topk} real; the first layer's tokens use {used} of {cfg.n_experts} "
        f"experts), device ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
        + f"; together {sum(ms.values()):.3f} of the replayed tick's {tick_device_ms:.3f}; the "
        f"expert products' bound {bound:.4f} ms ({nbytes / 1e9:.2f} GB of expert weights, "
        f"{flops / 1e9:.0f} GFLOP)")
    return {"device_ms": ms, "tick_device_ms": tick_device_ms, "experts_bound_ms": bound,
            "experts_bytes": nbytes, "experts_gflop": flops / 1e9, "rows": rows,
            "real_rows": b * cfg.moe_topk}


def replay_ms(fn, dev, iters: int = 8) -> float:
    """Mean ms of one replay of ``fn``'s launches captured as a CUDA graph
    (warmed up and captured on the engine's side stream), by CUDA events
    over ``iters`` replays: the device time of a captured sequence of
    small kernels, without the host's time between its launches."""
    from repro_torch.launch.specs import capture_stream

    side = capture_stream(dev.index or 0)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    ms = cuda_ms([graph.replay], iters=iters, warmup=1)
    del graph
    return ms


@contextlib.contextmanager
def counting_drops(into: list):
    """Within the block, append (assignments, kept) of every MoE dispatch
    to ``into``, read from the dispatch's ``kept``."""
    from repro_torch.models import moe as MOE

    real = MOE._dispatch_group

    def dispatch(*a, **kw):
        out = real(*a, **kw)
        into.append((out.kept.numel(), int(out.kept.sum())))
        return out

    MOE._dispatch_group = dispatch
    try:
        yield
    finally:
        MOE._dispatch_group = real


def moe_drop_share(params, cfg, prompts, dev) -> dict:
    """The share of the trace's prefill assignments that the published
    capacity factor drops, each prompt prefilled as the engine prefills
    it (chunks of 128, each its own capacity group) and in one whole-prompt
    chunk, counted from the dispatch's ``kept``."""
    from repro_torch.models import transformer as TF

    out = {}
    with torch.no_grad():
        for tag, chunk in (("chunks of 128", 128), ("whole prompt", None)):
            seen: list = []
            with counting_drops(seen):
                for p in prompts:
                    n_pages = -(-len(p) // 16)
                    pool = TF.init_paged_decode_cache(cfg, 1, 1 + n_pages, 16, device=dev)
                    row = torch.arange(1, 1 + n_pages, dtype=torch.int32, device=dev)
                    toks = torch.tensor([p], dtype=torch.int32, device=dev)
                    state = TF.init_prefill_state(cfg, dev)
                    step = chunk or len(p)
                    for lo in range(0, len(p), step):
                        _, state, _ = TF.lm_prefill_chunk(params, toks[:, lo:lo + step], cfg,
                                                          pool, state, row, lo)
                    del pool
            n = sum(a for a, _ in seen)
            kept = sum(k for _, k in seen)
            out[tag] = {"assignments": n, "dropped": n - kept, "share": (n - kept) / n}
    torch.cuda.empty_cache()
    log(f"  prefill assignments dropped at capacity factor {cfg.capacity_factor} over the "
        f"trace's {len(prompts)} prompts: "
        + "; ".join(f"{k}: {v['dropped']} of {v['assignments']} ({v['share']:.4%})"
                    for k, v in out.items()))
    return out


def moe_chunked_prefill(params, cfg, dev, gate: bool) -> dict:
    """One prompt of MOE_LONG_PROMPT tokens (seeded) through
    ``lm_prefill_chunk`` whole (one chunk, one capacity group) and in
    chunks of MOE_PREFILL_CHUNK, each into its own pool: the last logits
    relative to their largest magnitude (within MOE_CHUNK_RTOL and the
    same greedy token when ``gate``), the share of assignments each
    drops, and each's host ms (synced)."""
    from repro_torch.models import transformer as TF

    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (1, MOE_LONG_PROMPT)).astype(np.int32)).to(dev)
    n_pages = MOE_LONG_PROMPT // 16
    row = torch.arange(1, 1 + n_pages, dtype=torch.int32, device=dev)
    out, logits = {}, {}
    with torch.no_grad():
        for tag, step in (("whole", MOE_LONG_PROMPT), ("chunked", MOE_PREFILL_CHUNK)):
            pool = TF.init_paged_decode_cache(cfg, 1, 1 + n_pages, 16, device=dev)
            state = TF.init_prefill_state(cfg, dev)
            seen: list = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with counting_drops(seen):
                for lo in range(0, MOE_LONG_PROMPT, step):
                    _, state, lg = TF.lm_prefill_chunk(params, toks[:, lo:lo + step], cfg,
                                                       pool, state, row, lo)
            torch.cuda.synchronize()
            n, kept = sum(a for a, _ in seen), sum(k for _, k in seen)
            out[tag] = {"ms": (time.perf_counter() - t0) * 1e3, "drop_share": (n - kept) / n}
            logits[tag] = lg.float()
            del pool
    err = float((logits["whole"] - logits["chunked"]).abs().max())
    out["rel"] = err / float(logits["whole"].abs().max())
    out["same_token"] = int(logits["whole"].argmax(-1)) == int(logits["chunked"].argmax(-1))
    log(f"  ({cfg.dtype}, {cfg.n_layers} layers, capacity factor {cfg.capacity_factor}) a "
        f"{MOE_LONG_PROMPT}-token prompt whole {out['whole']['ms']:.1f} ms, in "
        f"{MOE_LONG_PROMPT // MOE_PREFILL_CHUNK} chunks {out['chunked']['ms']:.1f} ms; assignments "
        f"dropped whole {out['whole']['drop_share']:.4%}, chunked "
        f"{out['chunked']['drop_share']:.4%}; last logits chunked vs whole max|Δ| {err:.3e} "
        f"({out['rel']:.2e} of its max); the same next token {out['same_token']}"
        + (f" (gate {MOE_CHUNK_RTOL} relative)" if gate else " (not gated)"))
    if gate and (not out["same_token"] or out["rel"] > MOE_CHUNK_RTOL
                 or out["whole"]["drop_share"] or out["chunked"]["drop_share"]):
        raise AssertionError("drop-free chunked prefill parts from the whole-bucket prefill")
    torch.cuda.empty_cache()
    return out


def moe_train(dev) -> dict:
    """Phase 4j (d): one ``analog_stochastic`` step of granite-moe-3b-a800m:
    ``crossbar_mac`` 4 reads a layer (q, k, v, o, all linear), the router's
    WTA race one ``wta_sample`` launch a layer (its first draw bit for bit
    against the plain version), no ``sigmoid_sample``, the first read at
    each of MOE_CB_SHAPES checked and timed beside its bound
    (:func:`analog_step`)."""
    from repro_torch.configs import get_config

    cfg = get_config("granite-moe-3b-a800m")
    return analog_step(dev, "granite-moe-3b-a800m", {
        "sigmoid_sample": 0, "crossbar_mac": MOE_CB_PER_LAYER * cfg.n_layers,
        "wta_sample": cfg.n_layers}, MOE_CB_SHAPES, "4j d", timed=True)


# ---------------------------------------------------------------------------
# Phase 4k: whisper-small, the encoder-decoder (served by the dense step
# alone, as in the reference).
# ---------------------------------------------------------------------------

# (a): 8 requests of 1500 std-1 frame embeddings (30 s of audio) and a
# 4-token decoder prompt, in two waves over a 4-slot dense cache of
# Whisper's decoder length, 64 new tokens each
ENCDEC_REQUESTS, ENCDEC_SLOTS = 8, 4
ENCDEC_PROMPT, ENCDEC_NEW = 4, 64
ENCDEC_MAX_LEN = 448
# (b): an f32 copy's prefill and decode steps against decode_train's
# forward over the same tokens, both on the card with TF32 off; the decode
# readout sums in another order than attend_full, so the logits agree
# within this fraction of their largest magnitude, and the greedy tokens
# exactly
ENCDEC_F32_STEPS = 8
ENCDEC_F32_RTOL = 1e-4
# (c): every projection reads the crossbar: 6 an encoder layer (q, k, v, o;
# w_up through the comparator, its output the activation; w_down), 10 a
# decoder layer (4 self-attention, 4 cross-attention, the MLP's 2); the
# tied head stays digital
ENCDEC_CB_ENC, ENCDEC_CB_DEC = 6, 10
ENCDEC_CB_SHAPES = (((768, 768), False), ((768, 3072), True), ((3072, 768), False))


def encdec_phase(dev) -> dict:
    """Phase 4k: whisper-small at full width and depth (12 + 12 layers, d
    768, H 12 of 64, GELU d_ff 3072, tied 51865-column head; seed 0,
    bf16): ``wta_sample`` at its head against the plain version; (a) the
    dense server greedy and WTA, each compiled and eager
    (:func:`encdec_serve`), a profiled replayed step against its byte
    bound, the f32 casts of the cross cache a step, and whether zeroing
    ``ck`` / ``cv`` moves the step (:func:`encdec_cross_probe`); (b) an
    f32 copy's prefill + decode against ``decode_train``
    (:func:`encdec_f32`); (c) one ``analog_stochastic`` training step
    (:func:`analog_step`).  (d) runs with phase 7 (:func:`reference_encdec`)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model_fns
    from repro_torch.optim import tree_leaves

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("whisper-small")
    t0 = time.perf_counter()
    params = get_model_fns(cfg).init(0, cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  init whisper-small ({cfg.enc_layers} + {cfg.dec_layers} layers d{cfg.d_model} "
        f"H{cfg.n_heads} Dh{cfg.head_dim} {cfg.mlp} ff{cfg.d_ff} V{cfg.vocab} tied; "
        f"{n_params / 1e9:.4f} B parameters) in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(29)
    errs = []
    cases = []
    for n, dt, what in ((ENCDEC_SLOTS, torch.bfloat16, "a decode step"),
                        (1, torch.bfloat16, "a first token")):
        case = wta_sample_case(gen, dev, n, cfg.vocab, dt, layout="per slot")
        check_wta_sample(f"({n}, {cfg.vocab}) T=32 per-slot keys, step (whisper-small, "
                         f"{what})", *case, 32, errs)
        cases.append({"case": f"({n}, {cfg.vocab}) T=32 bf16, checked", "columns": cfg.vocab})
    frames = torch.randn((ENCDEC_REQUESTS, cfg.enc_seq, cfg.d_model), generator=gen, device=dev)
    prompts = torch.randint(0, cfg.vocab, (ENCDEC_REQUESTS, ENCDEC_PROMPT), generator=gen,
                            device=dev, dtype=torch.int32)
    with torch.no_grad():   # first uses (cuBLAS handles, kernels' modules) before the timings
        cache, _ = get_model_fns(cfg).prefill(params, {"frames": frames[:1],
                                                       "tokens": prompts[:1]}, cfg, ENCDEC_MAX_LEN)
        get_model_fns(cfg).decode_step(params, cache, prompts[:1, 0], cfg)
        del cache
    res = {"wta_cases": cases, "wta_errs": errs}
    log(f"  (a) {ENCDEC_REQUESTS} requests of {cfg.enc_seq} std-1 frames and {ENCDEC_PROMPT} "
        f"prompt tokens, {ENCDEC_NEW} new tokens each, {ENCDEC_SLOTS} slots of "
        f"{ENCDEC_MAX_LEN}: greedy and WTA, compiled and eager")
    for mode, wta in (("greedy", False), ("wta", True)):
        runs = {g: encdec_serve(params, cfg, frames, prompts, dev, graphs=g, wta=wta)
                for g in (True, False)}
        g, e = runs[True], runs[False]
        if g["streams"] != e["streams"] or g["launches"] != e["launches"]:
            raise AssertionError(f"4k {mode}: compiled and eager serves differ "
                                 f"({g['launches']} against {e['launches']})")
        want_wta = ENCDEC_REQUESTS + ENCDEC_REQUESTS // ENCDEC_SLOTS * (ENCDEC_NEW - 1) if wta \
            else 0
        if g["launches"] != {"decode": 0, "prefill": 0, "stoch_round": 0, "write_kv_int8": 0,
                             "wta_sample": want_wta}:
            raise AssertionError(f"4k {mode}: launches {g['launches']}, expected wta_sample "
                                 f"{want_wta} and no attention kernel")
        moving = sum(len(set(s)) > 1 for s in g["streams"])
        log(f"  4k {mode}: compiled = eager on {len(g['streams'])} streams (launches "
            f"{g['launches']}); {moving} streams move from token to token")
        res[mode] = {"graphs": {k: v for k, v in g.items() if k != "streams"},
                     "eager": {k: v for k, v in e.items() if k != "streams"},
                     "launches": g["launches"], "streams": g["streams"]}
    agree = sum(a == b for s, t in zip(res["greedy"]["streams"], res["wta"]["streams"])
                for a, b in zip(s, t))
    log(f"  4k WTA vs greedy tokens: {agree}/{ENCDEC_REQUESTS * ENCDEC_NEW} equal")
    if agree == ENCDEC_REQUESTS * ENCDEC_NEW:
        raise AssertionError("the WTA serve emitted the greedy tokens: the sampler did not draw")
    res["probe"] = encdec_cross_probe(params, cfg, frames, prompts, dev)
    log(f"  (b) an f32 copy: prefill + {ENCDEC_F32_STEPS} decode steps against decode_train")
    res["f32"] = encdec_f32(params, cfg, frames, prompts, dev)
    del params
    torch.cuda.empty_cache()
    log("  (c) one analog_stochastic training step")
    res["train"] = analog_step(dev, "whisper-small", {
        "sigmoid_sample": 0, "wta_sample": 0,
        "crossbar_mac": ENCDEC_CB_ENC * cfg.enc_layers + ENCDEC_CB_DEC * cfg.dec_layers},
        ENCDEC_CB_SHAPES, "4k c", timed=True)
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 4k wall time {res['wall_s']:.1f} s")
    return res


def encdec_serve(params, cfg, frames, prompts, dev, *, graphs: bool, wta: bool) -> dict:
    """Phase 4k (a): the requests in waves of ENCDEC_SLOTS.  Each is
    prefilled alone (B = 1: encode, cross K/V, prompt) through
    ``get_model_fns(cfg).prefill``, its first token sampled by
    ``make_sample0`` (its own key, step 0), and inserted into its slot of
    one dense cache with ``make_cache_insert``; then ENCDEC_NEW - 1 decode
    steps through ``DenseGraphs`` (captured on its first call, replayed
    after; or eager on the same buffers).  The streams, the launches
    (reset just before, read just after), the median prefill and decode
    step ms, tokens/s over both waves and the peak memory; compiled, a
    profiled replayed step beside its byte bound, and the device ms of the
    step's f32 casts of ``ck`` / ``cv`` alone."""
    from repro_torch import random as R
    from repro_torch.launch import specs as SP
    from repro_torch.models import get_model_fns
    from repro_torch.optim import tree_leaves

    wcfg = dataclasses.replace(cfg, wta_head=wta)
    prefill = get_model_fns(wcfg).prefill
    sample0 = SP.make_sample0(wcfg)
    insert = SP.make_cache_insert(wcfg)
    b = ENCDEC_SLOTS
    torch.cuda.reset_peak_memory_stats()
    cache = SP.init_decode_cache(wcfg, b, ENCDEC_MAX_LEN, device=dev)
    dec = SP.DenseGraphs(wcfg, params, {b: cache}, capture=graphs)
    base = R.PRNGKey(29)
    streams, prefill_ms, step_ms = [], [], []
    reset_kernel_counters()
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    with torch.no_grad():
        for w0 in range(0, len(prompts), b):
            toks = np.zeros(b, np.int32)
            for slot in range(b):
                r = w0 + slot
                t0 = time.perf_counter()
                one, logits = prefill(params, {"frames": frames[r:r + 1],
                                               "tokens": prompts[r:r + 1]}, wcfg, ENCDEC_MAX_LEN)
                tok = sample0(logits, R.fold_in(base, r))
                insert(cache, one, slot)
                toks[slot] = int(tok[0])
                prefill_ms.append((time.perf_counter() - t0) * 1e3)
            keys = np.array([R.fold_in(base, w0 + s) for s in range(b)], np.int64)
            out = [toks]
            for t in range(1, ENCDEC_NEW):
                t0 = time.perf_counter()
                (tok,) = dec(out[-1], *((keys, np.full(b, t, np.int64)) if wta else ()))
                out.append(tok.cpu().numpy())
                step_ms.append((time.perf_counter() - t0) * 1e3)
            streams += np.stack(out, 1).tolist()
    wall = time.perf_counter() - t_all
    launches = kernel_counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    tag = f"[{'graphs' if graphs else 'eager'}] {'wta' if wta else 'greedy'}"
    rec = {"streams": streams, "launches": launches,
           "prefill_ms": float(np.median(prefill_ms)), "first_prefill_ms": prefill_ms[0],
           "decode_step_ms": float(np.median(step_ms)),
           "tokens_per_s": len(streams) * ENCDEC_NEW / wall, "peak_gib": peak}
    log(f"  4k {tag}: prefill {rec['prefill_ms']:.2f} ms a request (median; the first "
        f"{prefill_ms[0]:.1f}), decode step {rec['decode_step_ms']:.3f} ms (median, B = {b}), "
        f"{rec['tokens_per_s']:.1f} tok/s over both waves, peak memory {peak:.2f} GiB")
    if graphs:
        entry = dec.entries[(b,)]
        prof = profiled_call(entry.graph.replay, n=5)
        # the step reads every decoder weight but the cross-attention's wk /
        # wv (ck / cv hold their products since the prefill)
        dec = params["dec"]
        unread = [dec["cross_attn"]["wk"], dec["cross_attn"]["wv"]]
        dec_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(dec)) - sum(
            t.numel() * t.element_size() for t in unread)
        emb = params["embed"]["embedding"]
        cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
        nbytes = dec_bytes + emb.numel() * emb.element_size() + cache_bytes
        cast_ms = replay_ms(lambda: [cache["ck"].float(), cache["cv"].float()], dev)
        # a cast reads each element once in the model's dtype, writes it once in f32
        cast_bytes = sum(cache[n].numel() * (cache[n].element_size() + 4) for n in ("ck", "cv"))
        rec.update(profile=prof, step_bytes=nbytes, step_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   cross_cast_ms=cast_ms, cross_cast_bytes=cast_bytes,
                   cross_cast_bound_ms=cast_bytes / HBM_BYTES_PER_S * 1e3)
        log(f"  4k {tag}: a replayed step {prof['device_ms']:.3f} ms on the device "
            f"({prof['kernels']:.0f} kernels), against a byte bound of "
            f"{rec['step_bound_ms']:.3f} ms ({nbytes / 1e9:.3f} GB: the decoder's weights but "
            f"cross_attn wk / wv, the tied embedding and the cache, once); its kernels by "
            f"device time (that trace):")
        for name, ms, count in prof["top"]:
            log(f"    {ms:8.3f} ms/call  {count:6.1f}x  {name}")
        log(f"  4k {tag}: the f32 casts of ck / cv alone {cast_ms:.3f} ms a step (their "
            f"bytes' bound {rec['cross_cast_bound_ms']:.3f} ms: {cast_bytes / 1e9:.3f} GB, "
            f"read in bf16 and written in f32 once)")
    del dec, cache
    torch.cuda.empty_cache()
    return rec


def encdec_cross_probe(params, cfg, frames, prompts, dev) -> dict:
    """Whether the decode step reads the cross cache: each of the first
    ENCDEC_SLOTS requests prefilled alone, then one decode step of its
    greedy token with ``ck`` / ``cv`` as the prefill left them and zeroed:
    the largest logit change, and how many next tokens move."""
    from repro_torch.models import encdec as ED

    moved, deltas = 0, []
    with torch.no_grad():
        for r in range(ENCDEC_SLOTS):
            cache, lg = ED.encdec_prefill(params, frames[r:r + 1], prompts[r:r + 1], cfg,
                                          ENCDEC_MAX_LEN)
            tok = lg.argmax(-1).to(torch.int32)
            zeroed = {n: v.clone() for n, v in cache.items()}
            zeroed["ck"].zero_()
            zeroed["cv"].zero_()
            _, a = ED.encdec_decode_step(params, cache, tok, cfg)
            _, b = ED.encdec_decode_step(params, zeroed, tok, cfg)
            deltas.append(float((a.float() - b.float()).abs().max()))
            moved += int(a.argmax(-1) != b.argmax(-1))
    log(f"  4k probe: zeroing ck / cv before one decode step moves the logits by max|Δ| "
        f"{max(deltas):.4f} (median {float(np.median(deltas)):.4f}) and the next greedy token "
        f"of {moved}/{ENCDEC_SLOTS} requests")
    if max(deltas) == 0.0:
        raise AssertionError("4k: the decode step does not read the cross cache")
    return {"max_delta": max(deltas), "median_delta": float(np.median(deltas)), "moved": moved,
            "requests": ENCDEC_SLOTS}


def encdec_f32(params, cfg, frames, prompts, dev) -> dict:
    """Phase 4k (b): an f32 copy, two requests prefilled together and
    ENCDEC_F32_STEPS greedy decode steps, against ``decode_train``'s full
    forward over the prompts and the generated tokens (on ``encode`` of
    the same frames): logits within ENCDEC_F32_RTOL of their largest
    magnitude, greedy tokens equal."""
    from repro_torch.models import encdec as ED

    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_float(params)
    fr, pr = frames[:2], prompts[:2]
    with torch.no_grad():
        cache, lg = ED.encdec_prefill(p32, fr, pr, c32, ENCDEC_PROMPT + ENCDEC_F32_STEPS)
        logits, toks = [lg], [lg.argmax(-1).to(torch.int32)]
        for _ in range(ENCDEC_F32_STEPS):
            cache, lg = ED.encdec_decode_step(p32, cache, toks[-1], c32)
            logits.append(lg)
            toks.append(lg.argmax(-1).to(torch.int32))
        seq = torch.cat([pr, torch.stack(toks[:-1], 1)], dim=1)
        full = ED.decode_train(p32, seq, ED.encode(p32, fr, c32), c32)[:, ENCDEC_PROMPT - 1:]
    got = torch.stack(logits, 1)
    err, scale = float((got - full).abs().max()), float(full.abs().max())
    same = torch.equal(full.argmax(-1).to(torch.int32), torch.stack(toks, 1))
    log(f"  4k (b) f32: prefill + {ENCDEC_F32_STEPS} decode steps against decode_train: "
        f"max|Δ logit| {err:.3e} of max|logit| {scale:.3f} ({err / scale:.2e}, gate "
        f"{ENCDEC_F32_RTOL}); greedy tokens equal {same}")
    if err > ENCDEC_F32_RTOL * scale or not same:
        raise AssertionError("4k (b): the f32 prefill + decode disagrees with decode_train")
    del p32, cache
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "max_logit": scale, "tokens_equal": same}


# ---------------------------------------------------------------------------
# Phase 4l: llava-next-34b, the vision-language model (a decoder LM with a
# patch prefix), cut in depth.
# ---------------------------------------------------------------------------

VLM_CUT_LAYERS = 8
# (b): 576 patches (the base 336 px tile) and a 448-token prompt: 1024
# positions, one KV chunk of attend_full; 8 decode steps make 1032, which
# splits into one chunk of 1032
VLM_PROMPT, VLM_DECODE = 448, 8
# a bf16 prefill and decode against lm_forward: each layer's output
# rounds to bf16 after sums in other orders (the decode readout against
# attend_full, GEMMs of other M), so the logits agree within 8 bf16 ulps of
# their largest magnitude; the greedy tokens are gated on an f32 copy of
# the first VLM_F32_LAYERS layers, within VLM_F32_RTOL
VLM_BF16_RTOL = 2.0**-5
VLM_F32_LAYERS = 2
VLM_F32_RTOL = 1e-4


def vlm_phase(dev) -> dict:
    """Phase 4l: llava-next-34b at full width (d 7168, H 56 / Hkv 8 / Dh
    128, SwiGLU d_ff 20480, V 64000) cut to VLM_CUT_LAYERS of 60 layers
    (seed 0, bf16): (a) served as a token LM (:func:`cut_serve`: compiled =
    eager, decode attention 8 a step, prefill 8 a chunk, profiled); (b)
    the patch prefix through the dense prefill and decode steps against
    ``lm_forward`` with the prefix (:func:`vlm_prefix`), in bf16 and on an
    f32 copy of the first VLM_F32_LAYERS layers.  (c) runs with phase 7
    (:func:`reference_vlm`)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (a) served as a token LM, cut to {VLM_CUT_LAYERS} layers")
    res = {"cut": cut_serve("llava-next-34b", VLM_CUT_LAYERS, dev, profile=True)}
    dec, pre = res["cut"]["launches"]["decode"], res["cut"]["launches"]["prefill"]
    if dec % VLM_CUT_LAYERS or pre % VLM_CUT_LAYERS or not dec or not pre:
        raise AssertionError(f"4l: attention launches {dec} decode, {pre} prefill: not "
                             f"{VLM_CUT_LAYERS} a step and a chunk")
    log(f"  4l: decode attention {dec // VLM_CUT_LAYERS} steps x {VLM_CUT_LAYERS} layers, "
        f"prefill {pre // VLM_CUT_LAYERS} chunks x {VLM_CUT_LAYERS}")
    cfg = dataclasses.replace(get_config("llava-next-34b"), n_layers=VLM_CUT_LAYERS)
    params = init_lm(cfg, seed=0, device=dev)
    log(f"  (b) the patch prefix: {cfg.n_patches} patches and {VLM_PROMPT} prompt tokens, "
        f"{VLM_DECODE} decode steps")
    res["prefix"] = vlm_prefix(params, cfg, dev, VLM_BF16_RTOL, gate_tokens=False)
    c32 = dataclasses.replace(cfg, n_layers=VLM_F32_LAYERS, dtype="float32")
    p32 = first_units(params, VLM_F32_LAYERS, torch.float32)
    del params
    torch.cuda.empty_cache()
    res["prefix_f32"] = vlm_prefix(p32, c32, dev, VLM_F32_RTOL, gate_tokens=True)
    del p32
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 4l wall time {res['wall_s']:.1f} s")
    return res


def vlm_prefix(params, cfg, dev, rtol: float, gate_tokens: bool) -> dict:
    """Phase 4l (b): two requests of ``cfg.n_patches`` seeded patch
    embeddings (x 0.02, as ``lm_batch`` draws them) and VLM_PROMPT prompt
    tokens through ``get_model_fns(cfg).prefill`` with ``patches`` into a
    dense cache, then VLM_DECODE greedy decode steps, against
    ``lm_forward(..., prefix_embeds)`` over the prompts and the generated
    tokens: logits within ``rtol`` of their largest magnitude; the greedy
    tokens equal where ``gate_tokens`` (printed otherwise).  The attention
    kernels launch nowhere here (the dense path)."""
    from repro_torch.models import get_model_fns
    from repro_torch.models import transformer as TF

    gen = torch.Generator(device=dev).manual_seed(30)
    patches = torch.randn((2, cfg.n_patches, cfg.d_model), generator=gen, device=dev) * 0.02
    prompt = torch.randint(0, cfg.vocab, (2, VLM_PROMPT), generator=gen, device=dev,
                           dtype=torch.int32)
    s = cfg.n_patches + VLM_PROMPT
    fns = get_model_fns(cfg)
    reset_kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, lg = fns.prefill(params, {"tokens": prompt, "patches": patches}, cfg,
                                s + VLM_DECODE)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if cache["pos"].tolist() != [s, s]:
            raise AssertionError(f"4l: pos {cache['pos'].tolist()} after the prefill, not {s}")
        logits, toks = [lg], [lg.argmax(-1).to(torch.int32)]
        for _ in range(VLM_DECODE):
            cache, lg = fns.decode_step(params, cache, toks[-1], cfg)
            logits.append(lg)
            toks.append(lg.argmax(-1).to(torch.int32))
        seq = torch.cat([prompt, torch.stack(toks[:-1], 1)], dim=1)
        full, _ = TF.lm_forward(params, seq, cfg, None, patches)
        full = full[:, s - 1:]
    launches = kernel_counters()
    got = torch.stack(logits, 1).float()
    full = full.float()
    err, scale = float((got - full).abs().max()), float(full.abs().max())
    same = torch.equal(full.argmax(-1).to(torch.int32), torch.stack(toks, 1))
    peak = torch.cuda.max_memory_allocated() / 2**30
    label = f"{cfg.n_layers} layers {cfg.dtype}"
    log(f"  4l (b) {label}: prefill of {s} positions {prefill_ms:.1f} ms; prefill + "
        f"{VLM_DECODE} decode steps against lm_forward with the prefix: max|Δ logit| "
        f"{err:.3e} of max|logit| {scale:.3f} ({err / scale:.2e}, gate {rtol:.2e}); greedy "
        f"tokens equal {same}" + ("" if gate_tokens else " (not gated)")
        + f"; peak memory {peak:.2f} GiB; launches {launches}")
    if err > rtol * scale or (gate_tokens and not same):
        raise AssertionError(f"4l (b) {label}: the prefix prefill + decode disagrees with "
                             f"lm_forward")
    if any(launches.values()):
        raise AssertionError(f"4l (b): the dense path launched {launches}")
    return {"max_abs_err": err, "max_logit": scale, "tokens_equal": same,
            "prefill_ms": prefill_ms, "positions": s, "peak_gib": peak, "launches": launches}


# ---------------------------------------------------------------------------
# Phase 4m: the dry run's counts on the card, remat_policy, the seam.
# ---------------------------------------------------------------------------

# (a): each meta count within this fraction of the allocator's
DRYRUN_MEM_RTOL = 0.10
# (b): a gradient under "dots" or "nothing" against "full", relative to
# its leaf's largest |g|
REMAT_GRAD_RTOL = 1e-6
# (c): the seam's inputs and the WTA agreement (tests/test_kernels.py:57)
SEAM_SHAPES = ((4, 1000, 300), (2048, 2048))
SEAM_AGREEMENT = 0.9995


def dryrun_phase(dev) -> dict:
    """Phase 4m (a)-(c); see the module's docstring."""
    t_phase = time.perf_counter()
    res = {"calibrate": dryrun_calibrate(dev), "remat": remat_on_card(dev),
           "seam": seam_phase(dev)}
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 4m wall time {res['wall_s']:.1f} s")
    return res


def dryrun_calibrate(dev) -> dict:
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as RL
    from repro_torch.train import TrainConfig

    cfg = get_config("stablelm-3b")
    out = {}
    for shape in (ShapeSpec("train_8x128", 128, 8, "train"),
                  ShapeSpec("prefill_4x2048", 2048, 4, "prefill"),
                  ShapeSpec("decode_8x4096", 4096, 8, "decode")):
        t0 = time.perf_counter()
        # a train step's AdamW rounding takes seconds: one timed step
        r = D.measure_step(cfg, shape, TrainConfig(microbatches=1), dev,
                           iters=1 if shape.kind == "train" else 3)
        torch.cuda.empty_cache()
        meta, card = r["meta"], r["card"]
        err = {k: abs(meta[k] - card[k]) / card[k] for k in ("args_bytes", "temp_bytes")}
        bound = RL.roofline_terms({"cost": {"flops": meta["flops"],
                                            "bytes accessed": meta["bytes_accessed"]},
                                   "collectives": None, "model_flops_per_chip": 0.0})
        rec = {"meta": meta, "card": card, "rel_err": err, "ms": r["ms"],
               "compute_ms": bound["compute_s"] * 1e3, "memory_ms": bound["memory_s"] * 1e3}
        out[shape.name] = rec
        log(f"  (4m a) stablelm-3b {shape.name}: args {meta['args_bytes']} B meta against "
            f"{card['args_bytes']} allocated (err {err['args_bytes']:.4f}); temp "
            f"{meta['temp_bytes']} B meta against {card['temp_bytes']} peak (err "
            f"{err['temp_bytes']:.4f}); FLOPs {meta['flops']:.6e} meta, {card['flops']:.6e} on "
            f"the card; step {r['ms']:.3f} ms against the roofline's compute "
            f"{rec['compute_ms']:.3f} ms and unfused memory {rec['memory_ms']:.3f} ms (counted "
            f"bytes {meta['bytes_accessed']:.6e}); {time.perf_counter() - t0:.1f} s")
        if max(err.values()) > DRYRUN_MEM_RTOL:
            raise AssertionError(f"4m a {shape.name}: meta bytes off the allocator's by more "
                                 f"than {DRYRUN_MEM_RTOL}: {err}")
        if meta["flops"] != card["flops"]:
            raise AssertionError(f"4m a {shape.name}: FLOPs {meta['flops']} on meta, "
                                 f"{card['flops']} on the card")
    return out


def remat_on_card(dev) -> dict:
    """(4m b): one forward and backward of stablelm-3b at 8 x 128 under
    each ``remat_policy``, analog_stochastic and digital."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.models import get_model_fns
    from repro_torch.optim import tree_leaves

    base = get_config("stablelm-3b")
    fns = get_model_fns(base)
    params = fns.init(0, base, dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = lm_batch(base, batch=8, seq=128, step=0, device=dev)
    out = {}
    # the embedding's backward accumulates with atomics unless asked not to:
    # a run-to-run difference that is not the policy's
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode in ("analog_stochastic", "digital"):
            out[mode] = remat_runs(fns, params, leaves, batch, base, mode)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    del params, leaves
    torch.cuda.empty_cache()
    return out


def remat_runs(fns, params, leaves, batch, base, mode: str) -> dict:
    """(4m b) for one mode: the three policies, gated."""
    from repro_torch.kernels import crossbar_mac as CB

    cfg = analog_cfg(base) if mode != "digital" else base
    key = (0, 11) if mode != "digital" else None
    ref_grads, runs = None, {}
    for policy in ("full", "dots", "nothing"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        CB.launches = CB.prepass_launches = 0
        t0 = time.perf_counter()
        loss, _ = fns.loss(params, batch, c, key)
        held = torch.cuda.memory_allocated() - before
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - before
        rec = {"loss": float(loss.detach()), "peak_gib": peak / 2**30, "peak": peak,
               "held": held, "ms": ms,
               "crossbar_mac": CB.launches, "crossbar_prepass": CB.prepass_launches}
        if ref_grads is None:
            ref_grads = grads
        else:
            rec["grad_err"] = max(float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
                                  for g, r in zip(grads, ref_grads))
        del loss, grads
        runs[policy] = rec
        log(f"  (4m b) {mode} {policy}: loss {rec['loss']:.6f}, held for the backward "
            f"{held} B, peak over the parameters {peak} B ({rec['peak_gib']:.2f} GiB), "
            f"{ms:.1f} ms (host clock, forward and backward), "
            f"crossbar_mac {rec['crossbar_mac']} reads and {rec['crossbar_prepass']} "
            f"prepasses" + (f", worst gradient err {rec['grad_err']:.3e} of its leaf's "
                            f"largest" if "grad_err" in rec else ""))
    del ref_grads
    full = runs["full"]
    for policy in ("dots", "nothing"):
        r = runs[policy]
        if r["loss"] != full["loss"] or r["grad_err"] > REMAT_GRAD_RTOL:
            raise AssertionError(f"4m b {mode} {policy}: loss {r['loss']} against "
                                 f"{full['loss']}, gradient err {r['grad_err']}")
    reads = CB_PER_LAYER * base.n_layers if mode != "digital" else 0
    for policy, r in runs.items():
        want = reads * (1 if policy == "full" else 2)
        if r["crossbar_mac"] != want or r["crossbar_prepass"] != want:
            raise AssertionError(f"4m b {mode} {policy}: crossbar_mac {r['crossbar_mac']} "
                                 f"reads, {r['crossbar_prepass']} prepasses, expected {want}")
    # digital: each product "dots" keeps is held and adds to the peak;
    # analog: every projection is a crossbar read, no product, so "dots"
    # keeps what "nothing" keeps
    for what in ("held", "peak"):
        b = {p: r[what] for p, r in runs.items()}
        ordered = (b["nothing"] < b["dots"] < b["full"] if mode == "digital"
                   else max(b["nothing"], b["dots"]) < b["full"])
        if not ordered:
            raise AssertionError(f"4m b {mode}: {what} bytes out of order {b}")
    return runs


def seam_phase(dev) -> dict:
    """(4m c): the generic ``ops.stoch_round`` and ``ops.wta_counts``
    through the seam, against their plain versions on the card."""
    from repro_torch.kernels import ops, prng
    from repro_torch.kernels import stoch_round as SR
    from repro_torch.kernels import wta_counts as WTA

    gen = torch.Generator(device=dev).manual_seed(30)
    out = {"stoch_round": {}}
    SR.launches = 0
    for shape in SEAM_SHAPES:
        for step, lo, hi in ((1.0, -127.0, 127.0), (0.25, -8.0, 8.0)):
            x = (torch.randn(shape, generator=gen, device=dev) * hi / 3).requires_grad_(True)
            key = (7, 20241216)
            y = ops.stoch_round(x, key, step=step, lo=lo, hi=hi)
            want = ops.stoch_round_reference(x.detach(), key, step=step, lo=lo, hi=hi)
            g = torch.randn(shape, generator=gen, device=dev)
            (gx,) = torch.autograd.grad(y, x, g)
            mask = ((x >= lo) & (x <= hi)).to(g.dtype)
            same, grad_same = torch.equal(y, want), torch.equal(gx, g * mask)
            label = f"{'x'.join(map(str, shape))} step {step}"
            out["stoch_round"][label] = {"equal": same, "grad_equal": grad_same}
            log(f"  (4m c) ops.stoch_round {label}: equal to stoch_round_reference {same}, "
                f"gradient the in-range mask {grad_same}")
            if not (same and grad_same):
                raise AssertionError(f"4m c stoch_round {label}: kernel or gradient differs")
    out["stoch_round_launches"] = SR.launches
    if SR.launches != 2 * len(SEAM_SHAPES):
        raise AssertionError(f"4m c stoch_round launched {SR.launches}, expected "
                             f"{2 * len(SEAM_SHAPES)}")
    # the kernel behind a spin (its seed on the card), and the public op
    # with its host work: it copies the key's seed to the card each call
    x = torch.randn((2048, 2048), generator=gen, device=dev)
    kw = dict(step=2.0 / 31, lo=-1.0, hi=1.0)
    seed = torch.tensor([prng.key_to_seed((1, 2))], device=dev)
    rec = dict(bound_record(x.numel() * 8, 0),
               device_ms=device_ms([lambda: SR.stoch_round_cuda(x, seed, **kw)]),
               op_ms=cuda_ms([lambda: ops.stoch_round(x, (1, 2), **kw)]),
               plain_ms=cuda_ms([lambda: ops.stoch_round_reference(x, (1, 2), **kw)], iters=4,
                                warmup=1))
    out["stoch_round_timing"] = rec
    log(f"  (4m c) stoch_round 2048x2048 (the generic op's kernel): {rec['device_ms']:.4f} ms on "
        f"the device against a bound of {rec['bound_ms']:.4f} ({rec['bound_by']}); "
        f"ops.stoch_round {rec['op_ms']:.4f} ms a call, host included; plain version "
        f"{rec['plain_ms']:.4f}")
    z = torch.randn((8, 50304), generator=gen, device=dev) * WTA_SIGMA
    wkw = dict(n_trials=32, vth0=WTA_VTH0, sigma_z=WTA_SIGMA)
    WTA.launches = 0
    got = ops.wta_counts(z, 20241217, **wkw)
    launches = WTA.launches
    want = ops.wta_counts_reference(z, 20241217, **wkw)
    agree = float((got == want).float().mean())
    out["wta_counts"] = {"agreement": agree, "launches": launches}
    log(f"  (4m c) ops.wta_counts (8, 50304) T=32 against wta_counts_reference on the card: "
        f"{agree:.6f} of counts equal (gate {SEAM_AGREEMENT}), launches {launches}")
    if agree <= SEAM_AGREEMENT or launches != 1:
        raise AssertionError(f"4m c wta_counts: agreement {agree}, launches {launches}")
    return out


# ---------------------------------------------------------------------------
# Phase 5: the stochastic-rounding and WTA vote-count entry points.
# ---------------------------------------------------------------------------


def stoch_round_phase(dev) -> dict:
    """``ops.stoch_round_serving`` on bench_kernels.py's quantizer row: a
    (2048, 2048) array onto the 2/31 conductance grid in [-1, 1]."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import stoch_round as SR

    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((2048, 2048), generator=gen, device=dev)
    SR.launches = 0
    q = ops.stoch_round_serving(x, 20241216, step=2.0 / 31, lo=-1.0, hi=1.0)
    torch.cuda.synchronize()
    launches = SR.launches
    levels = (q + 1.0) * (31 / 2.0)
    on_grid = bool(((levels - levels.round()).abs() < 1e-4).all())
    mean_err = float((q - x.clamp(-1.0, 1.0)).mean())
    log(f"  stoch_round_serving (2048, 2048) step 2/31: launches {launches}, on the grid "
        f"{on_grid}, mean rounding error {mean_err:.2e} (unbiased: ~0)")
    assert launches > 0, "stoch_round_serving did not launch its kernel"
    assert on_grid and abs(mean_err) < 1e-3, (on_grid, mean_err)
    return {"launches": launches}


def wta_phase(dev) -> dict:
    """``ops.wta_counts`` at the serving head's operating point: 8 rows of
    50304 classes, 32 trials, vth0 = 1.702², σ = 1.702."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import wta_counts as WTA

    gen = torch.Generator(device=dev).manual_seed(3)
    z = torch.randn((8, 50304), generator=gen, device=dev) * WTA_SIGMA
    WTA.launches = 0
    counts = ops.wta_counts(z, 20241216, n_trials=32, vth0=WTA_VTH0, sigma_z=WTA_SIGMA)
    torch.cuda.synchronize()
    launches = WTA.launches
    votes = counts.sum(-1)
    top = counts.argmax(-1)
    rank = (z > z.gather(1, top[:, None])).sum(-1)   # the most-voted class's rank in z
    log(f"  wta_counts (8, 50304) T=32: launches {launches}, votes per row "
        f"{votes.tolist()}, most-voted class's rank in z {rank.tolist()}")
    assert launches > 0, "wta_counts entry point did not launch its kernel"
    assert counts.shape == z.shape and torch.isfinite(counts).all()
    assert torch.equal(counts, counts.round()) and bool((counts >= 0).all())
    # ~11% of 50304 classes fire per trial, so every trial casts one vote
    # (exact ties aside)
    assert bool((votes == 32).all()), votes
    return {"launches": launches}


FAULT_CLOCK = 100          # the fault clock of the faulty entry points
# Faulty weights, card against CPU: PyTorch's CUDA division by a Python
# scalar multiplies by its reciprocal (the CPU divides), so the drift's
# (G - G_ref) / G0 may differ by an ulp of G (≈ 1.2e-7 after / G0 in
# normalized units, tests/test_torch_backend.py); bound: 4 such ulps x max|w|
FAULTY_WEIGHT_ULPS = 4 * 1.2e-7
FAULTY_CROSSBAR = dict(stuck_rate=1e-3, drift_nu=0.1, seed=0)
FAULTY_WTA = dict(comparator_offset=0.5, read_sigma_inflation=0.2)


def faulty_transform(w, bk):
    """The reference's ``_faulty_weights`` written out in plain torch ops
    on ``w``'s device: drift in conductance space, then stuck cells at
    w_min / w_max, under the max|w| scale."""
    from repro_torch.core.physics import DeviceParams

    dp = DeviceParams()
    s = w.abs().amax().clamp_min(1e-6)
    g = dp.g0 * (w / s) + dp.g_ref
    wn = (bk.fault_state()["drift_mult"] * g - dp.g_ref) / dp.g0
    sa0, sa1 = (torch.from_numpy(a).to(w.device) for a in bk._stuck_masks(tuple(w.shape)))
    return wn.masked_fill(sa0, dp.w_min).masked_fill(sa1, dp.w_max) * s


def faulty_phase(dev) -> dict:
    """The entry points through ``use_backend(FaultySimBackend(...))``.

    ``ops.crossbar_mac`` at the (1024, 2560) x (2560, 2560) training read
    (linear, calibrated, quantized), 0.1% stuck cells and drift at clock
    100: the faulty weights the backend hands the kernel must equal the
    plain-torch transform of the same weights on the card bit for bit
    (:func:`faulty_transform`), and the CPU's within
    ``FAULTY_WEIGHT_ULPS``, and
    the read is held against its plain version on those weights at the
    linear gate, scaled by the read's range scale s (its output is the
    normalized read times s, one more rounding on each side: + 2**-23·|out|).
    ``ops.wta_counts`` at the serving head (8 x 50304, T = 32) with a
    comparator offset of 0.5 and 20% read-noise inflation: held against
    the plain version at the shifted (vth0 + 0.5, σ·1.2) by its agreement
    bound.  Launch counts reset just before each call, read just after."""
    from repro_torch import random as R
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.physics import DeviceParams, calibrate_v_read
    from repro_torch.kernels import backend as BK
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wta_counts as WTA

    gen = torch.Generator(device=dev).manual_seed(20)
    m, k, n = 1024, 2560, 2560
    x = torch.randn((m, k), generator=gen, device=dev)
    w = (torch.randn((k, n), generator=gen, device=dev) * k**-0.5).to(torch.bfloat16).float()
    cfg = AnalogConfig(mode="analog_linear", device=calibrate_v_read(DeviceParams(), k))
    key = R.PRNGKey(11)

    def faulty(spec):
        bk = BK.FaultySimBackend(fault=BK.FaultConfig(**spec))
        bk.advance_clock(FAULT_CLOCK)
        return bk

    bk = faulty(FAULTY_CROSSBAR)
    handed = {}
    real = ops.crossbar_mac_sim

    def recording(x, w, key, cfg, binarize=True):
        handed["w"] = w
        return real(x, w, key, cfg, binarize)

    ops.crossbar_mac_sim = recording
    try:
        CB.launches = CB.prepass_launches = 0
        with BK.use_backend(bk):
            got = ops.crossbar_mac(x, w, key, cfg, binarize=False)
        torch.cuda.synchronize()
        launches = (CB.launches, CB.prepass_launches)
    finally:
        ops.crossbar_mac_sim = real
    wf = handed["w"]
    plain_wf = faulty_transform(w, bk)
    exact = torch.equal(wf, plain_wf)
    cpu_err = float((wf.cpu() - faulty(FAULTY_CROSSBAR)._faulty_weights(w.cpu())).abs().max())
    cpu_tol = FAULTY_WEIGHT_ULPS * float(w.abs().max())
    state = bk.fault_state()
    log(f"  faulty crossbar_mac (1024, 2560) x (2560, 2560) linear: {state['stuck_cells']} stuck "
        f"cells, drift x{state['drift_mult']} at clock {FAULT_CLOCK}; faulty weights = the "
        f"plain-torch transform on the card bit for bit: {exact}; against the CPU's max|Δ| "
        f"{cpu_err:.3e} (bound {cpu_tol:.3e}); launches {launches[0]} read + {launches[1]} prepass")
    if not exact or cpu_err > cpu_tol:
        raise AssertionError("faulty weights on the card differ from the plain-torch transform")
    if launches != (1, 1):
        raise AssertionError(f"faulty crossbar_mac launched {launches}, not one read + one prepass")
    want = ops.crossbar_mac_reference(x, wf, key, cfg, binarize=False)
    err = (got - want).abs()
    worst = scaled_linear_err_over_tol(x, wf, cfg, got, want)
    healthy = ops.crossbar_mac(x, w, key, cfg, binarize=False)
    moved = float((healthy - got).abs().max())
    log(f"  faulty crossbar_mac vs its plain version on the faulty weights: max|err| "
        f"{float(err.max()):.3e}, worst err/tol {worst:.3f}; the faults moved the read by up to "
        f"{moved:.3e}")
    if worst > 1.0 or not torch.isfinite(got).all() or moved == 0.0:
        raise AssertionError("faulty crossbar_mac disagrees with its plain version")
    cb_err = float(err.max())

    bk = faulty(FAULTY_WTA)
    z = torch.randn((8, 50304), generator=gen, device=dev) * WTA_SIGMA
    seed = 20241216
    kw = dict(n_trials=32, vth0=WTA_VTH0, sigma_z=WTA_SIGMA)
    WTA.launches = 0
    with BK.use_backend(bk):
        counts = ops.wta_counts(z, seed, **kw)
    torch.cuda.synchronize()
    wta_launches = WTA.launches
    vth0, sigma = bk.wta_readout_params(WTA_VTH0, WTA_SIGMA)
    plain = ref.wta_counts_ref(z, ops._seed_tensor(seed, z.device), n_trials=32, vth0=vth0,
                               sigma_z=sigma)
    healthy = ops.wta_counts(z, seed, **kw)
    delta = float((counts - plain).abs().sum())
    sums_equal = torch.equal(counts.sum(-1), plain.sum(-1))
    log(f"  faulty wta_counts (8, 50304) T=32 at (vth0 {vth0!r}, σ {sigma!r}): launches "
        f"{wta_launches}, row sums equal {sums_equal}, sum|Δcounts| {delta:.0f} (bound "
        f"{2 * WTA_FLIP_FRACTION * 8 * 32:.1f}); differs from the healthy point's counts "
        f"{not torch.equal(counts, healthy)}")
    if wta_launches != 1 or not sums_equal or delta > 2 * WTA_FLIP_FRACTION * 8 * 32:
        raise AssertionError("faulty wta_counts disagrees with its plain version")
    if torch.equal(counts, healthy):
        raise AssertionError("the fault backend did not move wta_counts' operating point")
    return {"crossbar_launches": launches[0], "crossbar_err": cb_err,
            "wta_launches": wta_launches, "wta_err": float((counts - plain).abs().max())}


# ---------------------------------------------------------------------------
# Phase 6: RACA analog training of stablelm-3b at full width.
# ---------------------------------------------------------------------------


def analog_cfg(cfg):
    """``--analog``: analog-stochastic execution with V_r calibrated to the
    model width, as ``launch/train.py`` configures it."""
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.physics import DeviceParams, calibrate_v_read

    return dataclasses.replace(cfg, analog=AnalogConfig(
        mode="analog_stochastic", device=calibrate_v_read(DeviceParams(), cfg.d_model)))


GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


def remat_factor(cfg) -> int:
    """How many times a training step runs each unit's forward, and so each
    of its crossbar reads and gate draws: twice under ``remat_policy``
    "nothing" (every config's) and "dots", whose backward recomputes the
    unit; once under "full"; twice for an encoder-decoder, which
    checkpoints every layer whatever the policy (``models/encdec.py``)."""
    return 2 if cfg.family == "encdec" or cfg.remat_policy != "full" else 1


def train_phase(dev) -> dict:
    """``make_train_step`` on stablelm-3b at full width and depth in analog
    mode, the launcher's defaults (batch 8 x 128, lr 3e-4, warmup 100,
    bf16 moments with stochastic rounding), TRAIN_STEPS steps, then one
    profiled step."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = analog_cfg(get_config("stablelm-3b"))
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-4), total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    state = init_train_state(0, cfg, tcfg, device=dev)
    step_fn = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    log(f"  init stablelm-3b ({cfg.n_layers}L d{cfg.d_model} ff{cfg.d_ff} V{cfg.vocab} "
        f"{cfg.dtype}, {cfg.analog.mode}) and its AdamW state in {time.perf_counter() - t0:.1f} s")
    probe = state.params["units"]["l0"]["ffn"]["w_up"]
    before = probe[:, :64, :64].detach().clone()
    batches = [lm_batch(cfg, batch=8, seq=128, step=i, device=dev) for i in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CB.launches = CB.prepass_launches = 0
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[i])
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log(f"  step {i}: loss {loss:.4f}, grad norm {float(metrics['grad_norm']):.4f}, "
            f"lr {metrics['lr']:.3e}, {times[-1]:.3f} s")
    launches, prepasses = CB.launches, CB.prepass_launches
    peak = torch.cuda.max_memory_allocated()
    changed = not torch.equal(before, probe[:, :64, :64])
    steady = times[1:] or times
    step_s = sum(steady) / len(steady)
    want = CB_PER_LAYER * cfg.n_layers * remat_factor(cfg) * TRAIN_STEPS
    log(f"  {TRAIN_STEPS} steps: crossbar_mac launches {launches} "
        f"({launches / TRAIN_STEPS:.0f} per step = {CB_PER_LAYER} x {cfg.n_layers} layers x "
        f"{remat_factor(cfg)}, the backward recomputing each unit), "
        f"prepass launches {prepasses}, "
        f"step {step_s:.3f} s (steps after the first), {8 * 128 / step_s:.1f} tokens/s, "
        f"peak memory {peak / 2**30:.2f} GiB, parameters changed {changed}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not changed:
        raise AssertionError("the training steps did not change the parameters")
    if launches != want or prepasses != launches:
        raise AssertionError(f"crossbar_mac launched {launches} reads and {prepasses} "
                             f"prepasses, expected {want} each")
    profile = profile_train_step(step_fn, state, batches[TRAIN_STEPS])
    return {"launches": launches, "prepass_launches": prepasses, "losses": losses,
            "step_s": step_s, "peak": peak, "profile": profile}


# 4o: stablelm-3b at full width cut to this many of its 32 layers: the
# phase writes two checkpoints of the state and reads one back
MESH_TRAIN_LAYERS = 2
MESH_TRAIN_STEPS = 2


def mesh_loop(cfg, tcfg, dev, ckpt_dir: Path, mesh=None) -> tuple:
    """``loop.run`` of MESH_TRAIN_STEPS steps at 8 x 128 (unsharded, or on
    ``mesh``): (its final state, {its losses, each step's seconds, its
    kernel launches, its saves})."""
    import shutil

    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.train.loop import LoopConfig, run

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    lcfg = LoopConfig(steps=MESH_TRAIN_STEPS, ckpt_dir=str(ckpt_dir), ckpt_every=100,
                      log_every=100)
    torch.cuda.synchronize()
    before = ops.launch_counts()
    state, stats = run(cfg, tcfg, lcfg, lambda s: lm_batch(cfg, batch=8, seq=128, step=s,
                                                           device=dev),
                       device=dev, mesh=mesh)
    torch.cuda.synchronize()
    launched = launches_since(before)
    return state, {"losses": [loss for _, loss in stats["losses"]], "step_s": stats["step_s"],
                   "launches": launched, "saves": stats["saves"]}


def train_mesh_phase(dev) -> dict:
    """Phase 4o; see the module's docstring.  Every gate raises."""
    import shutil

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import lm_batch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import specs as SP
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    t_phase = time.perf_counter()
    # (d) the launcher in its own process (a one-rank NCCL group of its own),
    # beside (a)-(c): its process start and imports overlap them
    ck = ROOT / "build" / "ckpts" / "4o_launcher"
    shutil.rmtree(ck, ignore_errors=True)
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "stablelm-3b", "--smoke",
         "--sharded", "--steps", "2", "--ckpt-dir", str(ck)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    cut = dataclasses.replace(get_config("stablelm-3b"), n_layers=MESH_TRAIN_LAYERS)
    cfg = analog_cfg(cut)
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-4), total_steps=TRAIN_STEPS)
    root = ROOT / "build" / "ckpts" / "4o"
    out: dict = {}
    # (c) the meta side first: a fake one-rank group, before NCCL's opens
    shape = ShapeSpec("train_8x128", 128, 8, "train")
    dcfg, dtcfg = cut, TrainConfig(microbatches=1)
    t0 = time.perf_counter()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        meta = D.count_step(dcfg, shape, dtcfg, SP.cell_inputs(dcfg, shape, dtcfg),
                            LM.make_host_mesh(model=1, device="cpu"))
        meta["args_bytes"] = D.tree_bytes(D.input_tree(SP.cell_inputs(dcfg, shape, dtcfg)))
    finally:
        dist.destroy_process_group()
    meta_s = time.perf_counter() - t0
    want_reads = CB_PER_LAYER * cfg.n_layers * remat_factor(cfg) * MESH_TRAIN_STEPS
    with LM.process_group("cuda"):
        mesh = LM.make_host_mesh(model=1, data=1)
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        log(f"  mesh {LM.mesh_shape(mesh)} on {mesh.device_type}, backend {dist.get_backend()}; "
            f"stablelm-3b at full width, {cfg.n_layers} of 32 layers, {cfg.analog.mode}, "
            f"8 x 128")
        # (a) the loop unsharded, then on the mesh: the same losses and reads;
        # the unsharded state's next step is (b)'s yardstick (its checkpoint
        # holds the same bits)
        step_fn = make_train_step(cfg, tcfg)
        batch = lm_batch(cfg, batch=8, seq=128, step=MESH_TRAIN_STEPS, device=dev)
        state, plain = mesh_loop(cfg, tcfg, dev, root / "plain")
        loss_plain = float(step_fn(state, batch)[1]["loss"])
        del state
        state, sharded = mesh_loop(cfg, tcfg, dev, root / "mesh", mesh=mesh)
        del state
        shutil.rmtree(root / "mesh", ignore_errors=True)
        for tag, run in (("unsharded", plain), ("1 x 1", sharded)):
            got = (run["launches"].get("crossbar_mac", 0),
                   run["launches"].get("crossbar_prepass", 0))
            if got != (want_reads, want_reads):
                raise AssertionError(f"4o (a) {tag}: crossbar_mac launched {got} reads and "
                                     f"prepasses, expected {want_reads} each")
        if sharded["losses"] != plain["losses"]:
            raise AssertionError(f"4o (a): 1 x 1 losses {sharded['losses']} against the "
                                 f"unsharded {plain['losses']}")
        log(f"  4o (a) loop.run(mesh=1 x 1): losses {sharded['losses']} = unsharded's, bit for "
            f"bit; crossbar_mac {want_reads} reads + {want_reads} prepasses in each run "
            f"({CB_PER_LAYER} x {cfg.n_layers} layers x {remat_factor(cfg)} x "
            f"{MESH_TRAIN_STEPS} steps); step s {[round(x, 3) for x in sharded['step_s']]} "
            f"against unsharded {[round(x, 3) for x in plain['step_s']]}; final save gather "
            f"{sharded['saves'][-1]['gather_s']:.2f} s against {plain['saves'][-1]['gather_s']:.2f}")
        out["loop"] = {"plain": plain, "mesh": sharded}
        # (b) the unsharded checkpoint onto the mesh: the next step bit-equal
        t1 = time.perf_counter()
        like = init_train_state(0, cfg, tcfg, device=dev, mesh=mesh)
        placed = load_checkpoint(str(root / "plain"), MESH_TRAIN_STEPS, like,
                                 shardings=SH.state_shardings(like, mesh, cfg))
        del like
        _, m_mesh = step_fn(placed, batch)
        loss_mesh = float(m_mesh["loss"])
        del placed, m_mesh
        shutil.rmtree(root, ignore_errors=True)
        if loss_mesh != loss_plain:
            raise AssertionError(f"4o (b): step {MESH_TRAIN_STEPS} from the checkpoint on the "
                                 f"mesh {loss_mesh} against unsharded {loss_plain}")
        log(f"  4o (b) the unsharded checkpoint at step {MESH_TRAIN_STEPS} loaded onto 1 x 1: "
            f"the next step's loss {loss_mesh} = unsharded, bit for bit "
            f"({time.perf_counter() - t1:.1f} s)")
        out["ckpt"] = {"loss": loss_mesh}
        torch.cuda.empty_cache()
        # (c) the card side: the digital train step on the NCCL 1 x 1 mesh
        r = D.measure_step(dcfg, shape, dtcfg, dev, iters=1, mesh=mesh)
        card = r["card"]
        err = {k: abs(meta[k] - card[k]) / card[k] for k in ("args_bytes", "temp_bytes")}
        log(f"  4o (c) dry run at 1 x 1, stablelm-3b ({cfg.n_layers} layers) train 8 x 128 "
            f"digital: args {meta['args_bytes']} B meta against {card['args_bytes']} allocated "
            f"(err {err['args_bytes']:.6f}); temp {meta['temp_bytes']} B meta against "
            f"{card['temp_bytes']} peak (err {err['temp_bytes']:.6f}); FLOPs "
            f"{meta['flops']:.6e} meta, {card['flops']:.6e} on the card; collectives "
            f"{meta['collectives']['count']}; step {r['ms']:.3f} ms; meta count {meta_s:.1f} s")
        if max(err.values()) > DRYRUN_MEM_RTOL or meta["flops"] != card["flops"]:
            raise AssertionError(f"4o (c): meta {meta} against the card {card}")
        if meta["collectives"]["count"]:
            raise AssertionError(f"4o (c): a 1 x 1 mesh sent {meta['collectives']}")
        out["dryrun"] = {"meta": meta, "card": card, "rel_err": err, "ms": r["ms"]}
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    stdout, stderr = launcher.communicate(timeout=300)
    shutil.rmtree(ck, ignore_errors=True)
    text = stdout + stderr
    lines = [ln for ln in stdout.splitlines() if ln.startswith(("training mesh", "done"))]
    log(f"  4o (d) train.py --sharded (rc {launcher.returncode}, waited {time.perf_counter() - t1:.1f}"
        f" s after (a)-(c)): " + " | ".join(lines))
    if launcher.returncode or "training mesh: {'data': 1, 'model': 1}" not in text \
            or "done: steps=2" not in text:
        raise AssertionError(f"4o train.py --sharded failed:\n{text[-4000:]}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 4o wall time {out['wall_s']:.1f} s")
    return out


def profile_train_step(step_fn, state, batch) -> dict:
    """Device time of one training step, split into the crossbar kernel,
    cuBLAS products (the STE backward's, and the digital logits and
    attention einsums), the AdamW update with its rounding draws (the
    kernels that start inside the device side of its ``train/adamw``
    range) and the rest."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == cuda]
    ranges = [e.time_range for e in events if e.name == "train/adamw"]
    kernels = [e for e in events if not e.name.startswith("train/")]

    def ms(sel):
        return sum(e.time_range.elapsed_us() for e in sel) / 1e3

    def in_adamw(e):
        return any(r.start <= e.time_range.start < r.end for r in ranges)

    crossbar = [e for e in kernels if "crossbar" in e.name]
    prepass = [e for e in crossbar if "prepass" in e.name]
    gemm = [e for e in kernels if "crossbar" not in e.name
            and any(g in e.name.lower() for g in GEMM_NAMES) and not in_adamw(e)]
    adamw = [e for e in kernels if in_adamw(e)]
    total = ms(kernels)
    split = {"wall_ms": wall_ms, "device_ms": total, "crossbar_mac_ms": ms(crossbar),
             "crossbar_prepass_ms": ms(prepass), "gemm_ms": ms(gemm), "adamw_ms": ms(adamw),
             "kernels": len(kernels)}
    split["rest_ms"] = total - split["crossbar_mac_ms"] - split["gemm_ms"] - split["adamw_ms"]
    log(f"  profiled step: {wall_ms:.1f} ms host, device busy {total:.1f} ms "
        f"({100 * total / wall_ms:.1f}%), {len(kernels)} kernels; crossbar_mac {split['crossbar_mac_ms']:.1f} ms "
        f"({len(crossbar)} launches, of which the prepass {split['crossbar_prepass_ms']:.1f} ms in "
        f"{len(prepass)}), cuBLAS {split['gemm_ms']:.1f} ms ({len(gemm)}), AdamW + rounding "
        f"{split['adamw_ms']:.1f} ms ({len(adamw)}), rest {split['rest_ms']:.1f} ms")
    rows = [e for e in prof.key_averages() if e.device_type == cuda and not e.key.startswith("train/")]
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    return split

# ---------------------------------------------------------------------------
# Phase 4e: the fault-tolerant training loop, checkpoints, gradient
# compression, serve.py --ckpt-dir, the paper's benches and the examples.
# ---------------------------------------------------------------------------

# (a): examples/train_lm_torch.py's stablelm-100m at the example's batch,
# full depth; a fault before step LOOP_FAULT_STEP, restart from the step-8
# checkpoint.  Gate on the final parameters and moments against the clean
# run: tests/test_train.py's atol 1e-6, rtol 1e-5 (bit-equality printed).
LOOP_STEPS, LOOP_CKPT_EVERY, LOOP_FAULT_STEP = 12, 4, 9
LOOP_BATCH, LOOP_SEQ = 8, 256
LOOP_ATOL, LOOP_RTOL = 1e-6, 1e-5
# (b): tests/test_train.py:138-156's protocol (lr 1e-2, f32 moments without
# stochastic rounding, 15 steps) at stablelm-100m and the example's batch
COMPRESS_STEPS = 15
# (f): quickstart's E[comparator] against the range-quantized layer's
# sigmoid: mean error within 0.1, max error within 5 sigma of a 256-sample
# mean of a Bernoulli (sqrt(0.25 / 256))
QUICKSTART_MEAN_ERR, QUICKSTART_MAX_ERR = 0.1, 5 * (0.25 / 256) ** 0.5
# (d): Table I's changes against the paper's, in points
TABLE1_PAPER = (-58.29, -38.43, 142.37)
TABLE1_ATOL = 0.05


def load_example(name: str) -> dict:
    """An example's module globals (``__name__`` is not ``__main__``: its
    ``main`` does not run)."""
    import runpy

    return runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name=name)


def launches_since(before: dict) -> dict:
    from repro_torch.kernels import ops

    return {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}


def state_match(a, b) -> dict:
    """Final parameters and moments of two runs: bit-equal, and the largest
    excess over atol + rtol·|a| (<= 0 passes the gate)."""
    from repro_torch.optim import tree_leaves

    equal, excess, max_abs = True, -float("inf"), 0.0
    for ta, tb in ((a.params, b.params), (a.opt.m, b.opt.m), (a.opt.v, b.opt.v)):
        for x, y in zip(tree_leaves(ta), tree_leaves(tb)):
            x, y = x.detach().float(), y.detach().float()
            equal = equal and torch.equal(x, y)
            d = (x - y).abs()
            max_abs = max(max_abs, float(d.max()))
            excess = max(excess, float((d - LOOP_ATOL - LOOP_RTOL * x.abs()).max()))
    return {"bit_equal": equal, "max_abs": max_abs, "excess": excess}


def loop_run(cfg, tcfg, dev, ckpt_dir: Path, fault_step=None) -> tuple:
    """``loop.run`` at the example's batch; its state, stats, wall seconds
    and kernel launches."""
    import shutil

    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.train.loop import LoopConfig, run

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    lcfg = LoopConfig(steps=LOOP_STEPS, ckpt_dir=str(ckpt_dir), ckpt_every=LOOP_CKPT_EVERY,
                      log_every=100, fault_inject_step=fault_step)
    torch.cuda.synchronize()
    before = ops.launch_counts()
    t0 = time.perf_counter()
    state, stats = run(cfg, tcfg, lcfg,
                       lambda s: lm_batch(cfg, batch=LOOP_BATCH, seq=LOOP_SEQ, step=s, device=dev),
                       device=dev)
    torch.cuda.synchronize()
    return state, stats, time.perf_counter() - t0, launches_since(before)


def loop_phase_a(dev, analog: bool, ckpt_root: Path) -> dict:
    """(a): a clean run and a run with a fault at LOOP_FAULT_STEP; exactly
    one restart, the final states equal.  Analog: the clean run's first
    read at each shape is held against its plain version
    (:func:`check_reads`)."""
    import shutil

    ex = load_example("train_lm_torch")
    cfg = ex["small_lm"](analog)
    tcfg = ex["train_config"](LOOP_STEPS)
    tag = "analog" if analog else "digital"
    reads = {}
    with recording_reads(reads if analog else None):
        clean, cstats, cwall, claunch = loop_run(cfg, tcfg, dev, ckpt_root / f"{tag}_clean")
    faulty, fstats, fwall, flaunch = loop_run(cfg, tcfg, dev, ckpt_root / f"{tag}_fault",
                                              LOOP_FAULT_STEP)
    match = state_match(clean, faulty)
    steady = cstats["step_s"][1:]
    saves = cstats["saves"] + fstats["saves"]
    restart = fstats["restart_s"]
    res = {
        "params": cfg.param_count(), "step_ms": 1e3 * sum(steady) / len(steady),
        "first_step_ms": 1e3 * cstats["step_s"][0], "restarts": fstats["restarts"],
        "stragglers": (cstats["stragglers"], fstats["stragglers"]),
        "ckpt_bytes": saves[0]["bytes"],
        "gather_ms": [round(1e3 * s["gather_s"], 3) for s in saves],
        "write_ms": [round(1e3 * s["write_s"], 3) for s in saves],
        "restart_ms": [round(1e3 * r["total_s"], 3) for r in restart],
        "init_ms": [round(1e3 * r["init_s"], 3) for r in restart],
        "load_ms": [round(1e3 * r["load_s"], 3) for r in restart],
        "wall_s": (cwall, fwall), "losses": (cstats["losses"][0][1], cstats["losses"][-1][1]),
        "launches": (claunch, flaunch), **match,
    }
    shutil.rmtree(ckpt_root / f"{tag}_clean", ignore_errors=True)
    shutil.rmtree(ckpt_root / f"{tag}_fault", ignore_errors=True)
    log(f"  (a) {tag}: {cfg.name} ({res['params'] / 1e6:.1f} M parameters, {cfg.n_layers}L "
        f"d{cfg.d_model} V{cfg.vocab} {cfg.dtype}, batch {LOOP_BATCH} x {LOOP_SEQ}), "
        f"{LOOP_STEPS} steps, a checkpoint every {LOOP_CKPT_EVERY}: loss "
        f"{res['losses'][0]:.4f} -> {res['losses'][1]:.4f}; step {res['step_ms']:.2f} ms "
        f"(steps after the first, host clock to the loss's read), first {res['first_step_ms']:.1f} ms; "
        f"checkpoint {res['ckpt_bytes']} bytes, host gather ms {res['gather_ms']}, write ms "
        f"{res['write_ms']} (in the background); fault at step {LOOP_FAULT_STEP}: restarts "
        f"{res['restarts']}, restart ms {res['restart_ms']} (init {res['init_ms']} + load "
        f"{res['load_ms']}); wall {cwall:.1f} / {fwall:.1f} s; final state bit-equal "
        f"{match['bit_equal']}, max|diff| {match['max_abs']:.3e}; stragglers {res['stragglers']}; "
        f"launches clean {claunch}, faulty {flaunch}")
    if res["restarts"] != 1 or faulty.step != LOOP_STEPS:
        raise AssertionError(f"(a) {tag}: {res['restarts']} restarts, step {faulty.step}")
    if match["excess"] > 0:
        raise AssertionError(f"(a) {tag}: the resumed run's final state differs from the clean "
                             f"run's beyond atol {LOOP_ATOL}, rtol {LOOP_RTOL}: {match}")
    if not all(np.isfinite([res["losses"][0], res["losses"][1]])):
        raise AssertionError(f"(a) {tag}: non-finite loss {res['losses']}")
    if analog:
        per_step = CB_PER_LAYER * cfg.n_layers * remat_factor(cfg)
        steps_run = len(cstats["losses"]), len(fstats["losses"])
        want = tuple(per_step * n for n in steps_run)
        got = (claunch.get("crossbar_mac", 0), flaunch.get("crossbar_mac", 0))
        if got != want:
            raise AssertionError(f"(a) analog: crossbar_mac launched {got}, expected {want} "
                                 f"({per_step} a step over {steps_run} steps)")
        # the loop's own reads at stablelm-100m's shapes (M = 8 x 256 tokens,
        # 640² attention, 640→1728 and 1728→640 MLP), two off the 128 grid
        res["reads"] = check_reads(reads, "(a)")
        if not any(ws[0] % 128 or ws[1] % 128 for _, ws, _ in reads):
            raise AssertionError(f"(a) no read off the 128 grid was recorded: {sorted(reads)}")
    return res


@contextlib.contextmanager
def recording_reads(into):
    """Within the block, keep a copy of the inputs of the first
    ``ops.crossbar_mac`` read of each (x shape, W shape, binarize) in
    ``into``; ``None`` records nothing."""
    from repro_torch.kernels import ops

    if into is None:
        yield
        return
    real = ops.crossbar_mac_sim

    def recording(x, w, key, cfg, binarize=True):
        sig = (tuple(x.shape), tuple(w.shape), binarize)
        if sig not in into:
            into[sig] = (x.detach().clone(), w.detach().clone(),
                         key.clone() if isinstance(key, torch.Tensor) else key, cfg)
        return real(x, w, key, cfg, binarize)

    ops.crossbar_mac_sim = recording
    try:
        yield
    finally:
        ops.crossbar_mac_sim = real


def check_reads(reads: dict, tag: str, timed: bool = False) -> dict:
    """Each read that :func:`recording_reads` kept, through
    ``ops.crossbar_mac`` against ``ops.crossbar_mac_reference`` on the same
    x, W and key: comparator decisions at CB_AGREEMENT, linear reads at the
    range-scaled linear gate (:func:`scaled_linear_err_over_tol`).  With
    ``timed``, each read's device ms (prepass + GEMM, :func:`device_ms`)
    beside its bound (:func:`crossbar_bound`), its plain version's ms and
    the f32 product alone (cuBLAS SGEMM, CUDA events)."""
    from repro_torch.kernels import ops

    out = {}
    with torch.no_grad():
        for (xs, ws, binarize), (x, w, key, cfg) in sorted(reads.items()):
            label = f"{'x'.join(map(str, xs))} @ {ws[0]}x{ws[1]} {'comparator' if binarize else 'linear'}"
            got = ops.crossbar_mac(x, w, key, cfg, binarize)
            want = ops.crossbar_mac_reference(x, w, key, cfg, binarize)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{tag} crossbar_mac {label}: non-finite output")
            if binarize:
                agree = float((got == want).float().mean())
                binary = bool(((got == 0) | (got == 1)).all())
                out[label] = {"agreement": agree}
                log(f"  {tag} crossbar_mac {label}: {agree:.6f} of decisions equal "
                    f"(gate {CB_AGREEMENT})")
                if agree < CB_AGREEMENT or not binary:
                    raise AssertionError(f"{tag} crossbar_mac {label}: kernel disagrees with "
                                         f"its plain version")
            else:
                worst = scaled_linear_err_over_tol(x, w, cfg, got, want)
                err = float((got - want).abs().max())
                out[label] = {"max_abs_err": err, "err_over_tol": worst}
                log(f"  {tag} crossbar_mac {label}: max|err| {err:.3e}, worst err/tol "
                    f"{worst:.3f}")
                if worst > 1.0:
                    raise AssertionError(f"{tag} crossbar_mac {label}: kernel disagrees with "
                                         f"its plain version")
            if timed:
                m, k, n = x.numel() // x.shape[-1], w.shape[0], w.shape[1]
                x2, wf = x.reshape(m, k), w.float()
                rec = dict(crossbar_bound(m, k, n),
                           device_ms=device_ms([lambda: ops.crossbar_mac(x, w, key, cfg, binarize)]),
                           plain_ms=cuda_ms([lambda: ops.crossbar_mac_reference(
                               x, w, key, cfg, binarize)], iters=4, warmup=1),
                           library_ms=cuda_ms([lambda: x2 @ wf]))
                out[label].update(rec)
                log(f"  {tag} crossbar_mac {label}: {rec['device_ms']:.4f} ms on the device "
                    f"against a bound of {rec['bound_ms']:.4f} ({rec['bound_by']}); plain "
                    f"{rec['plain_ms']:.4f}, SGEMM product only {rec['library_ms']:.4f}")
    return out


def profile_compress(step_fn, state, batch) -> tuple[dict, object]:
    """Device ms of one compressed step's kernels inside its
    ``train/compress`` range, beside the step's device total; and the
    state the step returns."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == cuda]
    ranges = [e.time_range for e in events if e.name == "train/compress"]
    kernels = [e for e in events if not e.name.startswith("train/")]
    inside = [e for e in kernels if any(r.start <= e.time_range.start < r.end for r in ranges)]
    return {"compress_ms": sum(e.time_range.elapsed_us() for e in inside) / 1e3,
            "compress_kernels": len(inside),
            "device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3}, state


def loop_phase_b(dev) -> dict:
    """(b): COMPRESS_STEPS steps of stablelm-100m with int8 gradient
    compression against without, from the same init: both fall, the last
    three within 0.25 (tests/test_train.py:138-156)."""
    from repro_torch.data import lm_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = load_example("train_lm_torch")["small_lm"](False)
    opt = AdamWConfig(lr=1e-2, state_dtype="float32", stochastic_rounding=False)
    out = {}
    for tag, compress in (("plain", False), ("compressed", True)):
        tcfg = TrainConfig(opt=opt, compress_grads=compress)
        state = init_train_state(0, cfg, tcfg, device=dev)
        step_fn = make_train_step(cfg, tcfg)
        losses, times = [], []
        for i in range(COMPRESS_STEPS):
            batch = lm_batch(cfg, batch=LOOP_BATCH, seq=LOOP_SEQ, step=i, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        out[tag] = {"losses": losses, "step_ms": 1e3 * sum(times[1:]) / len(times[1:])}
        if compress:
            prof, state = profile_compress(
                step_fn, state, lm_batch(cfg, batch=LOOP_BATCH, seq=LOOP_SEQ, step=COMPRESS_STEPS,
                                         device=dev))
            out[tag].update(prof)
        del state
    lp, lc = out["plain"]["losses"], out["compressed"]["losses"]
    gap = abs(np.mean(lc[-3:]) - np.mean(lp[-3:]))
    log(f"  (b) compression, {cfg.name} batch {LOOP_BATCH} x {LOOP_SEQ}, {COMPRESS_STEPS} steps: "
        f"loss plain {lp[0]:.4f} -> {lp[-1]:.4f}, compressed {lc[0]:.4f} -> {lc[-1]:.4f}, last "
        f"three apart by {gap:.4f}; step ms plain {out['plain']['step_ms']:.2f}, compressed "
        f"{out['compressed']['step_ms']:.2f}; a compressed step's compression "
        f"{out['compressed']['compress_ms']:.2f} device ms over {out['compressed']['compress_kernels']} "
        f"kernels, of {out['compressed']['device_ms']:.2f} device ms")
    if not (np.all(np.isfinite(lc)) and np.mean(lc[-3:]) < lc[0] and np.mean(lp[-3:]) < lp[0]):
        raise AssertionError(f"(b) the losses did not fall: plain {lp}, compressed {lc}")
    if gap >= 0.25:
        raise AssertionError(f"(b) compressed and plain losses apart by {gap} >= 0.25")
    out["gap"] = gap
    return out


def loop_phase_c(dev, ckpt_root: Path) -> dict:
    """(c): a params-only checkpoint of the smoke config written by the
    port, served greedy by ``serve.py --ckpt-dir``; the streams equal
    serving the same parameters directly."""
    import contextlib
    import io
    import shutil

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as LS
    from repro_torch.models.transformer import init_lm

    cfg = get_smoke_config("stablelm-3b")
    params = init_lm(cfg, seed=3, device=dev)
    d = ckpt_root / "serve"
    shutil.rmtree(d, ignore_errors=True)
    save_checkpoint(str(d), 7, params)
    args = ["--arch", "stablelm-3b", "--smoke", "--requests", "4", "--new-tokens", "16"]
    buf = io.StringIO()
    before = ops.launch_counts()
    with contextlib.redirect_stdout(buf):
        served = LS.main([*args, "--ckpt-dir", str(d)])
    launches = launches_since(before)
    real = LS.get_model_fns
    LS.get_model_fns = lambda c: real(c)._replace(init=lambda seed, c2, device=None: params)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            direct = LS.main(args)
    finally:
        LS.get_model_fns = real
    shutil.rmtree(d, ignore_errors=True)
    loaded = "loaded checkpoint step 7" in buf.getvalue()
    n = sum(map(len, served))
    log(f"  (c) serve.py --ckpt-dir on a params-only checkpoint (smoke stablelm-3b, greedy): "
        f"loaded {loaded}, {len(served)} streams, {n} tokens, equal to serving the parameters "
        f"directly {served == direct}; launches {launches}")
    if not loaded or served != direct or n == 0:
        raise AssertionError("(c) serve.py --ckpt-dir did not serve the checkpoint's parameters")
    if launches.get("paged_attention", 0) == 0 or launches.get("paged_prefill_attention", 0) == 0:
        raise AssertionError(f"(c) the serve launched no attention kernel: {launches}")
    return {"tokens": n, "launches": launches}


def loop_phase_d(dev) -> dict:
    """(d): ``repro_torch.benchmarks.run``'s six benches on the card at
    the reference's protocol, gated on their own relations; the serving
    bench's report through ``validate_report``'s checks (its speculative
    floor printed, not gated: :func:`check_serving_report`)."""
    import io
    import re

    from repro_torch.benchmarks import run as BR
    from repro_torch.kernels import ops

    def num(derived, key):
        return float(re.search(rf"{key}=([-+0-9.e]+)", derived).group(1))

    buf = io.StringIO()
    reports: dict = {}
    before = ops.launch_counts()
    t0 = time.perf_counter()
    rows, failed = BR.run_all(dev, out=buf, reports=reports)
    wall = time.perf_counter() - t0
    launches = launches_since(before)
    for line in buf.getvalue().strip().splitlines():
        log(f"  (d) {line}")
    log(f"  (d) benches in {wall:.1f} s; launches {launches}")
    if failed:
        raise AssertionError("(d) a bench raised")
    fig4 = {n: num(d, "rmse") for n, _, d in rows["fig4"]}
    if not fig4["sigmoid_fit_calibrated"] < min(0.02, fig4["sigmoid_fit_detuned_x4"]):
        raise AssertionError(f"(d) Fig. 4: calibrated rmse {fig4}")
    fig5 = rows["fig5"]
    if "one_winner_per_trial=True" not in fig5[0][2] or not all(
            "argmax_agree=True" in d for n, _, d in fig5 if n.startswith("wta_tv_vs_softmax_T")):
        raise AssertionError(f"(d) Fig. 5: {fig5}")
    fig6 = {n: d for n, _, d in rows["fig6"]}
    if not num(fig6["fig6_raca_votes64"], "acc") >= num(fig6["fig6_raca_votes1"], "acc"):
        raise AssertionError(f"(d) Fig. 6: 64 votes below 1 vote: {fig6}")
    changes = [float(v) for v in re.findall(r"(?:energy|area|eff)([-+][0-9.]+)%",
                                             rows["table1"][2][2])]
    if len(changes) != 3 or max(abs(a - b) for a, b in zip(changes, TABLE1_PAPER)) > TABLE1_ATOL:
        raise AssertionError(f"(d) Table I changes {changes} against the paper's {TABLE1_PAPER}")
    for kernel in ("wta_sample", "sigmoid_sample", "crossbar_mac", "wta_counts", "stoch_round",
                   "paged_attention", "paged_prefill_attention", "write_kv_int8"):
        if launches.get(kernel, 0) == 0:
            raise AssertionError(f"(d) the benches launched no {kernel}: {launches}")
    serving = check_serving_report(reports["serving"])
    return {"rows": {tag: [list(r) for r in rs] for tag, rs in rows.items()}, "wall_s": wall,
            "launches": launches, "serving": serving}


def check_serving_report(report: dict) -> dict:
    """The serving bench's report through each of ``validate_report``'s
    checks (the reference's, ``sharded_decode``'s at 1 x 1 among them), gated, but for the
    speculative section's tokens/s floor, which is printed.  The floor is
    a claim about dispatch: the reference's plain tick on its CPU is one
    jitted call whose dispatch dominates it, and a round amortises that
    over k tokens.  The port's ticks are graph replays bound by their
    kernels, and a round runs k + 1 steps of them, so speculation does not
    win here at the bench's smoke model (ratios 0.87 to 1.01 on an H100
    80GB HBM3 at 700 W, ``PERF.md`` §6); the identity of its streams is
    gated."""
    from repro_torch.benchmarks import bench_serving as BS

    floor = None
    for check in BS.CHECKS:
        try:
            check(report)
        except ValueError as err:
            if check is BS._check_speculative and "tokens/s ratio" in str(err):
                floor = str(err)
                continue
            raise AssertionError(f"(d) serving report: {err}") from err
    spec = report["speculative_decode"]
    log(f"  (d) serving report: every check of validate_report passes"
        + ("" if floor is None else " but the speculative floor")
        + f"; speculative tokens/s {spec['plain']['tokens_per_s']} -> "
          f"{spec['spec']['tokens_per_s']}, ratio {spec['tokens_per_s_ratio']}, acceptance "
          f"{spec['acceptance']}, streams identical {spec['tokens_match']}")
    shd = report["sharded_decode"]
    log(f"  (d) sharded_decode: mesh {shd['mesh']}, streams identical {shd['tokens_match']}, "
        f"admitted {shd['admitted_single']} -> {shd['admitted_sharded']}, capacity ratio "
        f"{shd['capacity_ratio']}")
    pvd = report["paged_vs_dense"]
    log("  (d) paged vs dense decode step ms: " + ", ".join(
        f"L{r['max_len']} dense {r['dense']['decode_step_ms']} paged "
        f"{r['paged']['decode_step_ms']}" for r in pvd))
    return {"floor_failed": floor is not None, "speculative_ratio": spec["tokens_per_s_ratio"],
            "paged_vs_dense": pvd, "engines": report["engines"]}


def profiled_call(fn, n: int = 10, tries: int = 3, k: int = 8) -> dict:
    """Device ms of one call of ``fn`` (every kernel and copy it puts on
    the card, summed from the profiler over ``n`` calls), its kernels and
    host-to-device copies a call.  The public wrappers copy a Python seed
    or scalar to the card each call and wait for it, so a spin kernel
    cannot hide their host time (:func:`device_ms`).  The ``n`` calls are
    traced in the profiler's active cycle, after a warm-up cycle of the
    same calls, between two edge markers (a spin kernel and a pinned copy
    each, left out of the counts by name): a trace can lose the events at
    the edges of its window (seen late in a long process: one call's
    kernel and copy of ten), which then fall on a marker.  A trace whose
    counts are not whole multiples of ``n`` is taken again, up to
    ``tries`` times, then raises.  ``top`` lists the ``k`` event names
    that take most of the checked trace's device time: (name, ms a call,
    events a call)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.autograd.DeviceType.CUDA
    pinned = torch.zeros(1, pin_memory=True)
    landing = torch.empty(1, device="cuda")

    def edge():
        torch.cuda._sleep(1000)
        landing.copy_(pinned, non_blocking=True)
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                edge()
                for _ in range(n):
                    fn()
                edge()
                prof.step()
        # the schedule's step annotation spans the cycle on the device too
        events = [e for e in prof.events()
                  if e.device_type == cuda and not e.name.startswith("ProfilerStep")
                  and "spin_kernel" not in e.name and "Pinned" not in e.name]
        kernels = sum("Memcpy" not in e.name and "Memset" not in e.name for e in events)
        h2d = sum("HtoD" in e.name for e in events)
        seen.append((kernels, h2d))
        if kernels > 0 and kernels % n == 0 and h2d % n == 0:
            by_name: dict[str, list] = {}
            for e in events:
                by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
            top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:k]
            return {"device_ms": sum(e.time_range.elapsed_us() for e in events) / 1e3 / n,
                    "kernels": kernels / n, "h2d": h2d / n,
                    "top": [(name[:90], sum(ms) / n, len(ms) / n) for name, ms in top]}
    raise AssertionError(f"the profiler lost events in {tries} traces of {n} calls "
                         f"(kernels, host-to-device copies): {seen}")


def bench_kernel_times(dev) -> dict:
    """``bench_kernels``' cases (:func:`bench_kernels.cases`): device ms of
    a call as the bench makes it (:func:`profiled_call`), ms per call (24
    back-to-back calls between CUDA events), the plain version on the
    card, and the library call where one computes the same product (SGEMM,
    product only); the crossbar reads' decisions against the plain
    version's (CB_AGREEMENT)."""
    from repro_torch.benchmarks import bench_kernels as BK

    out = {}
    with torch.no_grad():
        for case in BK.cases(dev):
            t = {**profiled_call(case.call), "ms": cuda_ms([case.call]),
                 "plain_ms": cuda_ms([case.plain], iters=4, warmup=1),
                 "library_ms": None if case.library is None else cuda_ms([case.library]),
                 "bound_ms": case.bound_us / 1e3}
            if case.name.startswith("crossbar_mac"):
                got, want = case.call(), case.plain()
                t["agreement"] = float((got == want).float().mean())
                if t["agreement"] < CB_AGREEMENT:
                    raise AssertionError(f"(d) {case.name}: decisions agree {t['agreement']}")
            out[case.name] = t
            library = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
            log(f"  (d) {case.name}: device ms {t['device_ms']:.4f} ({t['kernels']} kernels, "
                f"{t['h2d']} host-to-device copies a call), per call {t['ms']:.4f}, plain "
                f"{t['plain_ms']:.4f}, library {library}, bound {t['bound_ms']:.4f}"
                + (f", decisions agree {t['agreement']:.6f}" if "agreement" in t else ""))
    return out


def loop_phase_f(dev) -> dict:
    """(f): ``examples/quickstart_torch.py`` and
    ``examples/serve_stochastic_torch.py`` (bf16 pool, then int8) on the
    card, each to its end, with their kernels' launches."""
    import contextlib
    import io
    import re
    import runpy

    from repro_torch.kernels import ops

    out = {}
    before = ops.launch_counts()
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = [str(ROOT / "examples" / "quickstart_torch.py")]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = argv
    text = buf.getvalue()
    out["quickstart_launches"] = launches_since(before)
    for line in text.strip().splitlines():
        log(f"  (f) quickstart: {line}")
    m = re.search(r"range-quantized layer: max err ([0-9.]+), mean err ([0-9.]+)", text)
    max_err, mean_err = float(m.group(1)), float(m.group(2))
    log(f"  (f) quickstart launches {out['quickstart_launches']}")
    if not (mean_err <= QUICKSTART_MEAN_ERR and max_err <= QUICKSTART_MAX_ERR):
        raise AssertionError(f"(f) quickstart: E[comparator] vs sigmoid mean {mean_err}, max "
                             f"{max_err} (gates {QUICKSTART_MEAN_ERR}, {QUICKSTART_MAX_ERR:.3f})")
    if "prediction agreement: True" not in text or "binary: [0.0, 1.0]" not in text:
        raise AssertionError("(f) quickstart: WTA predictions or binary activations fail")
    for k in ("crossbar_mac", "wta_sample"):
        if out["quickstart_launches"].get(k, 0) == 0:
            raise AssertionError(f"(f) quickstart launched no {k}")
    ex = load_example("serve_stochastic_torch")
    want_tokens = sum(n for _, n in ex["REQUESTS"])
    for kv in ("same", "int8"):
        before = ops.launch_counts()
        with contextlib.redirect_stdout(io.StringIO()) as sbuf:
            runs = ex["main"](["--kv-dtype", kv])
        launches = launches_since(before)
        out[f"serve_{kv}_launches"] = launches
        for line in sbuf.getvalue().strip().splitlines():
            log(f"  (f) serve_stochastic_torch --kv-dtype {kv}: {line}")
        log(f"  (f) serve_stochastic_torch --kv-dtype {kv} launches {launches}")
        for mode, _wta, _rids, outs, m in runs:
            if m.completed != 4 or sum(map(len, outs.values())) != want_tokens:
                raise AssertionError(f"(f) serve_stochastic_torch {kv} {mode}: {m.completed} "
                                     f"requests, {sum(map(len, outs.values()))} tokens")
        need = ["paged_attention", "paged_prefill_attention", "wta_sample"]
        need += ["write_kv_int8"] if kv == "int8" else []
        if any(launches.get(k, 0) == 0 for k in need):
            raise AssertionError(f"(f) serve_stochastic_torch {kv} launched {launches}")
    return out


def loop_phase(dev) -> dict:
    """Phase 4e: (a) the loop at full width, digital and analog; (b)
    compression; (c) ``serve.py --ckpt-dir``; (d) the benches; (f) the
    serving-side examples.  (e) runs in the FCNN phase.  Checkpoints go
    under ``build/ckpts`` of the checkout and are removed."""
    import shutil

    ckpt_root = ROOT / "build" / "ckpts"
    res = {}
    try:
        res["a_digital"] = loop_phase_a(dev, False, ckpt_root)
        res["a_analog"] = loop_phase_a(dev, True, ckpt_root)
        res["b"] = loop_phase_b(dev)
        res["c"] = loop_phase_c(dev, ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    res["d"] = loop_phase_d(dev)
    res["f"] = loop_phase_f(dev)
    summary = {k: {kk: vv for kk, vv in v.items() if kk not in ("rows",)}
               for k, v in res.items() if k != "b"}
    summary["b"] = {k: {kk: vv for kk, vv in v.items() if kk != "losses"} if isinstance(v, dict)
                    else v for k, v in res["b"].items()}
    log("  4e summary " + json.dumps(summary, default=str))
    return res


# ---------------------------------------------------------------------------
# Phase 6b: the paper's FCNN at full width, training and RACA inference.
# ---------------------------------------------------------------------------


def fcnn_cfgs():
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig

    return get_config("fcnn-mnist"), TrainConfig(
        opt=AdamWConfig(lr=FCNN_LR, state_dtype="float32", stochastic_rounding=False),
        total_steps=FCNN_STEPS)


def fcnn_phase(dev) -> dict:
    """Train fcnn-mnist [784, 500, 300, 10] at full width (FCNN_STEPS steps
    through ``make_train_step``), then the Fig. 6 protocol on 1024 test
    images: the digital baseline and RACA inference at 1, 4, 16 and 64
    votes.  The launches of the two kernels of the inference path, reset
    just before the four predictions and read just after, must be 2 and 1
    a vote (170 and 85).  Gates: tests/test_system.py's relations."""
    from repro_torch import random as R
    from repro_torch.data import mnist_batch, mnist_dataset
    from repro_torch.kernels import sigmoid_sample as SS
    from repro_torch.kernels import wta_sample as WS
    from repro_torch.models.fcnn import fcnn_predict_digital, fcnn_predict_raca
    from repro_torch.train import init_train_state, make_train_step

    cfg, tcfg = fcnn_cfgs()
    state = init_train_state(tcfg.seed, cfg, tcfg, device=dev)
    step_fn = make_train_step(cfg, tcfg)
    t0 = time.perf_counter()
    batches = [mnist_batch(batch=FCNN_BATCH, step=i, device=dev) for i in range(FCNN_STEPS)]
    torch.cuda.synchronize()
    log(f"  {FCNN_STEPS} batches of {FCNN_BATCH} made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    SS.launches = 0
    losses, times = [], []
    for i in range(FCNN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[i])
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i % 50 == 0 or i == FCNN_STEPS - 1:
            log(f"  step {i}: loss {losses[-1]:.4f}, {times[-1] * 1e3:.2f} ms")
    step_ms = sum(times[1:]) / len(times[1:]) * 1e3
    ref = FCNN_REFERENCE_CPU
    at = {k: losses[k] for k in ref["loss"] if k < len(losses)}
    log(f"  {FCNN_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, at steps "
        f"{ {k: round(v, 4) for k, v in at.items()} } (reference on a CPU {ref['loss']}), step "
        f"{step_ms:.3f} ms (host clock, steps after the first, each ending in a sync); "
        f"sigmoid_sample launches in training {SS.launches} (the training forward takes the "
        f"expectation)")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"FCNN training did not bring the loss down: {losses[0]} -> {losses[-1]}")
    test = mnist_dataset(FCNN_TEST, device=dev)
    y = test["label"].long()
    digital = float((fcnn_predict_digital(state.params, test["image"], cfg) == y).float().mean())
    torch.cuda.synchronize()
    raca, walls = {}, {}
    SS.launches = WS.launches = 0
    for votes in FCNN_VOTES:
        t0 = time.perf_counter()
        pred = fcnn_predict_raca(state.params, test["image"], cfg, R.PRNGKey(7), votes)
        raca[votes] = float((pred == y).float().mean())
        walls[votes] = time.perf_counter() - t0
    launches = {"sigmoid_sample": SS.launches, "wta_sample": WS.launches}
    n_votes = sum(FCNN_VOTES)
    log(f"  digital accuracy {digital:.4f} (reference on a CPU {ref['digital']})")
    for votes in FCNN_VOTES:
        log(f"  RACA {votes:2d} votes: accuracy {raca[votes]:.4f} (reference on a CPU "
            f"{ref['raca'][votes]}), {walls[votes] * 1e3:.1f} ms wall")
    log(f"  launches over the {n_votes} votes: sigmoid_sample {launches['sigmoid_sample']} "
        f"(expected {2 * n_votes}), wta_sample {launches['wta_sample']} (expected {n_votes})")
    if launches != {"sigmoid_sample": 2 * n_votes, "wta_sample": n_votes}:
        raise AssertionError(f"FCNN inference launches {launches}, expected {2 * n_votes} and "
                             f"{n_votes}")
    if not (digital > 0.85 and raca[64] >= raca[1] and raca[64] >= digital - 0.05):
        raise AssertionError(f"Fig. 6 relations fail: digital {digital}, RACA {raca}")
    sweeps = fcnn_sweeps(state.params, test["image"], y, cfg)
    profile = profile_fcnn(step_fn, state, batches[0], test["image"], cfg)
    return {"launches": launches, "losses": (losses[0], losses[-1]), "step_ms": step_ms,
            "digital": digital, "raca": raca, "walls": walls, "sweeps": sweeps,
            "profile": profile}


def fcnn_sweeps(params, x, y, cfg) -> dict:
    """Phase 4e (e): Fig. 6's threshold and SNR sweeps at the paper's
    width, as ``bench_fcnn_accuracy`` runs them: 16 votes with V_th0 = 0
    and calibrated under PRNGKey(8) (Fig. 6b), with β = 2 under
    PRNGKey(9) (Fig. 6a); 2 ``sigmoid_sample`` and 1 ``wta_sample``
    launches a vote."""
    from repro_torch import random as R
    from repro_torch.kernels import sigmoid_sample as SS
    from repro_torch.kernels import wta_sample as WS
    from repro_torch.models.fcnn import fcnn_predict_raca

    SS.launches = WS.launches = 0
    acc = {}
    for name, vth in (("vth0_zero", 0.0), ("vth0_cal", None)):
        pred = fcnn_predict_raca(params, x, cfg, R.PRNGKey(8), 16, vth0=vth)
        acc[f"fig6b_{name}_votes16"] = float((pred == y).float().mean())
    cfg_det = dataclasses.replace(cfg, analog=dataclasses.replace(cfg.analog, beta=2.0))
    pred = fcnn_predict_raca(params, x, cfg_det, R.PRNGKey(9), 16)
    acc["fig6a_detuned_beta2_votes16"] = float((pred == y).float().mean())
    launches = {"sigmoid_sample": SS.launches, "wta_sample": WS.launches}
    log(f"  (e) Fig. 6 sweeps at [784, 500, 300, 10], {FCNN_TEST} images, 16 votes: "
        + ", ".join(f"{k} {v:.4f}" for k, v in acc.items()) + f"; launches {launches}")
    if launches != {"sigmoid_sample": 2 * 48, "wta_sample": 48}:
        raise AssertionError(f"(e) sweep launches {launches}, expected 96 and 48")
    return {"acc": acc, "launches": launches}


def profile_fcnn(step_fn, state, batch, x, cfg) -> dict:
    """Device time of one FCNN training step and of one 64-vote RACA
    prediction, by kernel: ``sigmoid_sample``, ``wta_sample``, cuBLAS
    products and the rest, beside the host time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import random as R
    from repro_torch.models.fcnn import fcnn_predict_raca

    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for label, fn in (("train step", lambda: step_fn(state, batch)),
                      ("64-vote prediction",
                       lambda: fcnn_predict_raca(state.params, x, cfg, R.PRNGKey(7), 64))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # the step's record_function ranges show on the device timeline too
        kernels = [e for e in prof.events()
                   if e.device_type == cuda and not e.name.startswith("train/")]

        def ms(sel):
            return sum(e.time_range.elapsed_us() for e in sel) / 1e3

        sig = [e for e in kernels if "sigmoid_sample" in e.name]
        wta = [e for e in kernels if "wta_sample" in e.name]
        gemm = [e for e in kernels if any(g in e.name.lower() for g in GEMM_NAMES)]
        total = ms(kernels)
        rec = {"wall_ms": wall_ms, "device_ms": total, "kernels": len(kernels),
               "sigmoid_sample_ms": ms(sig), "wta_sample_ms": ms(wta), "gemm_ms": ms(gemm)}
        rec["rest_ms"] = total - rec["sigmoid_sample_ms"] - rec["wta_sample_ms"] - rec["gemm_ms"]
        log(f"  profiled {label}: {wall_ms:.2f} ms host, device busy {total:.3f} ms "
            f"({100 * total / wall_ms:.1f}%), {len(kernels)} kernels; sigmoid_sample "
            f"{rec['sigmoid_sample_ms']:.3f} ms ({len(sig)}), wta_sample {rec['wta_sample_ms']:.3f} "
            f"ms ({len(wta)}), cuBLAS {rec['gemm_ms']:.3f} ms ({len(gemm)}), rest "
            f"{rec['rest_ms']:.3f} ms")
        rows = [e for e in prof.key_averages()
                if e.device_type == cuda and not e.key.startswith("train/")]
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
        out[label] = rec
    return out


def reference_fcnn(dev) -> None:
    """The smoke FCNN (64, 32, 16, 10; the first 64 pixels) trained 5 steps
    from one state on the card (kernels, cuBLAS) and on the CPU (plain
    versions) on the same batches: losses within REF_FCNN_LOSS_ATOL; its
    digital predictions equal and its 8-vote RACA predictions at least
    REF_FCNN_AGREEMENT equal on 256 test images."""
    import dataclasses as dc

    from repro_torch import random as R
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import mnist_batch, mnist_dataset
    from repro_torch.models.fcnn import fcnn_predict_digital, fcnn_predict_raca
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_smoke_config("fcnn-mnist")
    _, tcfg = fcnn_cfgs()
    tcfg = dc.replace(tcfg, warmup_steps=1, total_steps=10)
    width = cfg.fcnn_layers[0]

    def cut(b):
        return {"image": b["image"][:, :width].contiguous(), "label": b["label"]}

    batches = [cut(mnist_batch(batch=64, step=i, device="cpu")) for i in range(5)]
    test = cut(mnist_dataset(256, device="cpu"))
    out = {}
    for d in ("cpu", dev):
        state = init_train_state(0, cfg, tcfg, device=d)
        step = make_train_step(cfg, tcfg)
        losses = []
        for b in batches:
            state, m = step(state, {k: v.to(d) for k, v in b.items()})
            losses.append(float(m["loss"]))
        x = test["image"].to(d)
        out[str(d)] = (losses, fcnn_predict_digital(state.params, x, cfg).cpu(),
                       fcnn_predict_raca(state.params, x, cfg, R.PRNGKey(7), 8).cpu())
    (lc, dc_, rc), (lg, dg, rg) = out["cpu"], out[str(dev)]
    err = max(abs(a - b) for a, b in zip(lc, lg))
    agree = float((rc == rg).float().mean())
    log(f"  smoke FCNN, 5 steps, card vs CPU: losses {lg} vs {lc} (max|Δ| {err:.3e}, atol "
        f"{REF_FCNN_LOSS_ATOL}); digital predictions equal {torch.equal(dc_, dg)}; 8-vote RACA "
        f"predictions {agree:.4f} equal (gate {REF_FCNN_AGREEMENT})")
    if err > REF_FCNN_LOSS_ATOL or not torch.equal(dc_, dg) or agree < REF_FCNN_AGREEMENT:
        raise AssertionError("the smoke FCNN disagrees card vs CPU")


# ---------------------------------------------------------------------------
# Phase 7: small input against the plain path on the CPU.
# ---------------------------------------------------------------------------


def reference_phase(dev) -> None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as TF

    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 40)).astype(np.int32))
    row = torch.tensor([3, 7, 1, 9], dtype=torch.int32)
    table = torch.tensor([[3, 7, 1, 9], [0, 0, 0, 0]], dtype=torch.int32)
    block_seeds = torch.tensor([11, 2**32 - 1, 2**31, 5], dtype=torch.int64)
    for kv in ("same", "int8"):
        cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32",
                                  kv_cache_dtype=kv)
        host = TF.init_lm(cfg, seed=1, device="cpu")
        logits, pools = {}, {}
        for d in ("cpu", dev):
            params = _tree_to(host, d)
            cache = TF.init_paged_decode_cache(cfg, 2, 12, 16, device=d)
            state = TF.init_prefill_state(cfg, d)
            out = []
            for lo, hi in ((0, 32), (32, 40)):
                seeds = block_seeds[lo // 16 : -(-hi // 16)].to(d) if kv == "int8" else None
                _, state, lg = TF.lm_prefill_chunk(
                    params, toks[:, lo:hi].to(d), cfg, cache, state, row.to(d), lo, seeds
                )
                out.append(lg)
            cache["pos"] = torch.tensor([40, 5], dtype=torch.int32, device=d)
            tok = torch.tensor([5, 9], dtype=torch.int32, device=d)
            for _ in range(3):
                cache, lg = TF.lm_decode_step(params, cache, tok, cfg, table.to(d))
                out.append(lg)
                tok = lg.argmax(-1).to(torch.int32)
            logits[str(d)] = [x.float().cpu() for x in out]
            pools[str(d)] = {k: v.cpu() for k, v in cache.items() if k.endswith("pages")}
        err = max(float((a - b).abs().max()) for a, b in zip(logits["cpu"], logits[str(dev)]))
        atol = REF_INT8_ATOL if kv == "int8" else REF_ATOL
        log(f"  smoke f32 {kv} pool logits card vs CPU: max|err| {err:.3e} (atol {atol})")
        if err > atol:
            raise AssertionError(f"card logits disagree with the CPU plain path ({kv} pool)")
        dense_err = dense_card_vs_cpu(host, cfg, toks, dev)
        log(f"  smoke f32 {kv} dense cache: prefill and 3 decode steps' logits card vs CPU: "
            f"max|err| {dense_err:.3e} (atol {atol})")
        if dense_err > atol:
            raise AssertionError(f"dense-layout card logits disagree with the CPU ({kv} cache)")
        if kv == "int8":
            for name in ("k_pages", "v_pages"):
                a, b = pools["cpu"][name].int(), pools[str(dev)][name].int()
                eq = float((a == b).float().mean())
                log(f"  smoke int8 {name} card vs CPU: {eq:.6f} of codes equal, "
                    f"max |Δ| {int((a - b).abs().max())} (gate {REF_INT8_CODES}, 1)")
                if eq < REF_INT8_CODES or int((a - b).abs().max()) > 1:
                    raise AssertionError(f"int8 {name} codes disagree card vs CPU")


def reference_ssm(dev) -> None:
    """Phase 4i (e): mamba2's smoke config in f32 (seed 1), the same
    parameters on the card and on the CPU: two prefill chunks and three
    greedy decode steps' logits within REF_ATOL, then the paged engine's
    greedy streams on tests/test_serving.py's mixed trace, equal token for
    token (the card's engine compiled)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as TF
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"), dtype="float32")
    host = TF.init_lm(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 40)).astype(np.int32))
    prompts = [[5, 6, 7, 1, 2, 3, 4, 9], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2], [4] * 20,
               [11, 12], [7] * 13]
    logits, streams = {}, {}
    for d in ("cpu", dev):
        params = _tree_to(host, d)
        cache = TF.init_paged_decode_cache(cfg, 2, 12, 16, device=d)
        row = torch.zeros((1,), dtype=torch.int32, device=d)
        out = []
        for b in range(2):
            state = TF.init_prefill_state(cfg, d)
            for lo, hi in ((0, 16), (16, 40)):
                _, state, lg = TF.lm_prefill_chunk(params, toks[b:b + 1, lo:hi].to(d), cfg, {},
                                                   state, row, lo)
                out.append(lg)
            for name, leaf in state.items():
                cache[name].narrow(0 if name == "pos" else 2, b, 1).copy_(leaf)
        tok = torch.cat(out[1::2]).argmax(-1).to(torch.int32)
        for _ in range(3):
            cache, lg = TF.lm_decode_step(params, cache, tok, cfg, None)   # no pool: no table
            out.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
        logits[str(d)] = [x.float().cpu() for x in out]
        eng = ServingEngine(params, cfg, ServeConfig(max_batch=3, max_new_tokens=8, max_len=64,
                                                     kv_block_size=8, prefill_chunk=8), device=d)
        for p in prompts:
            eng.submit(p)
        streams[str(d)] = eng.run()
        del eng
    err = max(float((a - b).abs().max()) for a, b in zip(logits["cpu"], logits[str(dev)]))
    agree = sum(a == b for r in streams["cpu"] for a, b in zip(streams["cpu"][r],
                                                               streams[str(dev)][r]))
    total = sum(len(o) for o in streams["cpu"].values())
    log(f"  (4i e) mamba2 smoke f32: prefill and decode logits card vs CPU max|err| {err:.3e} "
        f"(atol {REF_ATOL}); greedy streams {agree}/{total} tokens equal")
    if err > REF_ATOL:
        raise AssertionError("mamba2 card logits disagree with the CPU plain path")
    if streams["cpu"] != streams[str(dev)]:
        raise AssertionError("mamba2 greedy streams differ card vs CPU")


def reference_moe(dev) -> None:
    """Phase 4j (f): granite's and grok's smoke configs in f32 (seed 1), the
    same parameters on the card and on the CPU: two prefill chunks into
    the paged pool and three greedy decode steps, logits within REF_ATOL,
    then the paged engine's greedy streams on tests/test_serving.py's
    mixed trace, equal token for token (the card's engine compiled)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as TF
    from repro_torch.serving import ServeConfig, ServingEngine

    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 40)).astype(np.int32))
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    prompts = [[5, 6, 7, 1, 2, 3, 4, 9], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2], [4] * 20,
               [11, 12], [7] * 13]
    for arch in ("granite-moe-3b-a800m", "grok-1-314b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        host = TF.init_lm(cfg, seed=1, device="cpu")
        logits, streams = {}, {}
        for d in ("cpu", dev):
            params = _tree_to(host, d)
            cache = TF.init_paged_decode_cache(cfg, 2, 9, 16, device=d)
            out = []
            for b in range(2):
                state = TF.init_prefill_state(cfg, d)
                for lo, hi in ((0, 16), (16, 40)):
                    _, state, lg = TF.lm_prefill_chunk(params, toks[b:b + 1, lo:hi].to(d), cfg,
                                                       cache, state, table[b].to(d), lo)
                    out.append(lg)
            cache["pos"].fill_(40)
            tok = torch.cat(out[1::2]).argmax(-1).to(torch.int32)
            for _ in range(3):
                cache, lg = TF.lm_decode_step(params, cache, tok, cfg, table.to(d))
                out.append(lg)
                tok = lg.argmax(-1).to(torch.int32)
            logits[str(d)] = [x.float().cpu() for x in out]
            eng = ServingEngine(params, cfg, ServeConfig(max_batch=3, max_new_tokens=8,
                                                         max_len=64, kv_block_size=8,
                                                         prefill_chunk=8), device=d)
            for p in prompts:
                eng.submit(p)
            streams[str(d)] = eng.run()
            del eng
        err = max(float((a - b).abs().max()) for a, b in zip(logits["cpu"], logits[str(dev)]))
        agree = sum(a == b for r in streams["cpu"] for a, b in zip(streams["cpu"][r],
                                                                   streams[str(dev)][r]))
        total = sum(len(o) for o in streams["cpu"].values())
        log(f"  (4j f) {arch} smoke f32: prefill and decode logits card vs CPU max|err| "
            f"{err:.3e} (atol {REF_ATOL}); greedy streams {agree}/{total} tokens equal")
        if err > REF_ATOL:
            raise AssertionError(f"{arch} card logits disagree with the CPU plain path")
        if streams["cpu"] != streams[str(dev)]:
            raise AssertionError(f"{arch} greedy streams differ card vs CPU")


def reference_encdec(dev) -> None:
    """Phase 4k (d): whisper-small's smoke config in f32 (seed 1), the same
    parameters on the card and on the CPU: two requests' std-1 frames and
    6-token prompts prefilled together and 8 greedy decode steps, logits
    within REF_ATOL, greedy streams equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import encdec as ED

    cfg = dataclasses.replace(get_smoke_config("whisper-small"), dtype="float32")
    host = ED.init_encdec(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.standard_normal((2, cfg.enc_seq, cfg.d_model))
                              .astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32))
    logits, streams = {}, {}
    with torch.no_grad():
        for d in ("cpu", dev):
            params = _tree_to(host, d)
            cache, lg = ED.encdec_prefill(params, frames.to(d), toks.to(d), cfg, 32)
            out, tok = [lg], lg.argmax(-1).to(torch.int32)
            stream = [tok.cpu()]
            for _ in range(8):
                cache, lg = ED.encdec_decode_step(params, cache, tok, cfg)
                out.append(lg)
                tok = lg.argmax(-1).to(torch.int32)
                stream.append(tok.cpu())
            logits[str(d)] = [x.float().cpu() for x in out]
            streams[str(d)] = torch.stack(stream, 1).tolist()
    err = max(float((a - b).abs().max()) for a, b in zip(logits["cpu"], logits[str(dev)]))
    log(f"  (4k d) whisper-small smoke f32: prefill and decode logits card vs CPU max|err| "
        f"{err:.3e} (atol {REF_ATOL}); greedy streams equal {streams['cpu'] == streams[str(dev)]}")
    if err > REF_ATOL:
        raise AssertionError("whisper-small card logits disagree with the CPU plain path")
    if streams["cpu"] != streams[str(dev)]:
        raise AssertionError("whisper-small greedy streams differ card vs CPU")


def reference_vlm(dev) -> None:
    """Phase 4l (c): llava-next-34b's smoke config in f32 (seed 1), the same
    parameters on the card and on the CPU: two requests of 8 std-1 patch
    embeddings and 24 prompt tokens through the dense prefill and 3 greedy
    decode steps, logits within REF_ATOL; then the paged engine's greedy
    streams (a token LM, no patches) on tests/test_serving.py's mixed
    trace, equal token for token (the card's engine compiled)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as TF
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_smoke_config("llava-next-34b"), dtype="float32")
    host = TF.init_lm(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(3)
    patches = torch.from_numpy(rng.standard_normal((2, cfg.n_patches, cfg.d_model))
                               .astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32))
    prompts = [[5, 6, 7, 1, 2, 3, 4, 9], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2], [4] * 20,
               [11, 12], [7] * 13]
    logits, streams = {}, {}
    for d in ("cpu", dev):
        params = _tree_to(host, d)
        with torch.no_grad():
            cache, lg = TF.lm_prefill(params, toks.to(d), cfg, 48, prefix_embeds=patches.to(d))
            out, tok = [lg], lg.argmax(-1).to(torch.int32)
            for _ in range(3):
                cache, lg = TF.lm_decode_step(params, cache, tok, cfg)
                out.append(lg)
                tok = lg.argmax(-1).to(torch.int32)
        logits[str(d)] = [x.float().cpu() for x in out]
        eng = ServingEngine(params, cfg, ServeConfig(max_batch=3, max_new_tokens=8, max_len=64,
                                                     kv_block_size=8, prefill_chunk=8),
                            device=d)
        for p in prompts:
            eng.submit(p)
        streams[str(d)] = eng.run()
        del eng
    err = max(float((a - b).abs().max()) for a, b in zip(logits["cpu"], logits[str(dev)]))
    log(f"  (4l c) llava-next-34b smoke f32: prefix prefill and decode logits card vs CPU "
        f"max|err| {err:.3e} (atol {REF_ATOL}); paged greedy streams equal "
        f"{streams['cpu'] == streams[str(dev)]}")
    if err > REF_ATOL:
        raise AssertionError("llava-next-34b card logits disagree with the CPU plain path")
    if streams["cpu"] != streams[str(dev)]:
        raise AssertionError("llava-next-34b greedy streams differ card vs CPU")


def dense_card_vs_cpu(host: dict, cfg, toks, dev) -> float:
    """The dense layout's prefill of two prompts (one left-padded) and three
    decode steps, on the card and on the CPU from the same parameters:
    the largest logit difference."""
    from repro_torch.models import transformer as TF

    batch = torch.cat([toks[:, :40], torch.cat([torch.zeros((1, 8), dtype=torch.int32),
                                                toks[:, 8:40]], dim=1)])
    logits = {}
    for d in ("cpu", dev):
        params = _tree_to(host, d)
        cache, lg = TF.lm_prefill(params, batch.to(d), cfg, 64)
        out = [lg]
        tok = lg.argmax(-1).to(torch.int32)
        for _ in range(3):
            cache, lg = TF.lm_decode_step(params, cache, tok, cfg)
            out.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
        logits[str(d)] = [x.float().cpu() for x in out]
    return max(float((a - b).abs().max()) for a, b in zip(logits["cpu"], logits[str(dev)]))


def reference_wta(dev) -> None:
    """A smoke-size f32 WTA serve (shared prefixes, a full hit, R = 1 and
    R = 3) on the card (kernels) and on the CPU (plain versions) from the
    same weights: token streams equal; where they are not, the first
    divergence is printed with both sides' vote counts at it, and the
    check fails."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as TF
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32", wta_head=True)
    host = TF.init_lm(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, cfg.vocab, 24).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab, 8).tolist(), prefix + [7] * 8,
               rng.integers(0, cfg.vocab, 12).tolist(), prefix + [7] * 8,
               rng.integers(0, cfg.vocab, 5).tolist()]
    real = ops.wta_trial_counts
    for reads in (1, 3):
        outs, calls = {}, {}
        for d in ("cpu", dev):
            params = _tree_to(host, d)
            # eager on the card too: the recording below reads every
            # sampler call, which a graph replay does not make
            eng = ServingEngine(params, cfg, ServeConfig(
                max_batch=3, max_new_tokens=10, max_len=64, kv_block_size=8, prefill_chunk=16,
                seed=9, n_redundant_reads=reads), device=d, graphs=False)
            rec = calls[str(d)] = []

            def recording(*args, **kw):
                res = real(*args, **kw)
                rec.append(res[0].cpu())
                return res

            ops.wta_trial_counts = recording
            try:
                for p in prompts:
                    eng.submit(p)
                outs[str(d)] = eng.run()
            finally:
                ops.wta_trial_counts = real
        a, b = outs["cpu"], outs[str(dev)]
        n_tok = sum(len(o) for o in a.values())
        if a == b:
            log(f"  smoke WTA serve R={reads}, card vs CPU: {len(a)} streams, {n_tok} tokens, "
                f"equal ({len(calls['cpu'])} sampler calls)")
            continue
        k = next(i for i, (x, y) in enumerate(zip(calls["cpu"], calls[str(dev)]))
                 if x.shape != y.shape or not torch.equal(x.argmax(-1), y.argmax(-1)))
        x, y = calls["cpu"][k], calls[str(dev)][k]
        row = int((x.argmax(-1) != y.argmax(-1)).nonzero()[0])
        top_x, top_y = torch.topk(x[row], 2), torch.topk(y[row], 2)
        log(f"  smoke WTA serve R={reads}, card vs CPU: streams differ; first at sampler call "
            f"{k}, row {row}: CPU votes {top_x.values.tolist()} at {top_x.indices.tolist()}, "
            f"card votes {top_y.values.tolist()} at {top_y.indices.tolist()}")
        raise AssertionError(f"card and CPU WTA streams differ at R={reads}")


def _tree_to(tree, d):
    return {k: _tree_to(v, d) if isinstance(v, dict) else v.to(d) for k, v in tree.items()}


def reference_train(dev) -> None:
    """Two smoke-size analog training steps (f32, bf16 moments with
    stochastic rounding) from one state, on the card (the crossbar kernel,
    cuBLAS) and on the CPU (plain versions): losses within
    REF_TRAIN_LOSS_ATOL, comparator decisions at least REF_TRAIN_AGREEMENT
    equal.  The decisions are recorded by wrapping ``ops.crossbar_mac``
    for the two runs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    def tree_to(tree, d, grad=False):
        return {k: tree_to(v, d, grad) if isinstance(v, dict)
                else v.detach().to(d).requires_grad_(grad) for k, v in tree.items()}

    def state_to(state, d):
        opt = state.opt._replace(m=tree_to(state.opt.m, d), v=tree_to(state.opt.v, d))
        return state._replace(params=tree_to(state.params, d, grad=True), opt=opt)

    cfg = analog_cfg(dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32"))
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-2), warmup_steps=1, total_steps=10)
    batches = [lm_batch(cfg, batch=4, seq=32, step=i, device="cpu") for i in range(2)]
    seen = {}
    inner = ops.crossbar_mac

    def recording(x, w, key, c, binarize=True):
        y = inner(x, w, key, c, binarize)
        if binarize:
            seen.setdefault(y.device.type, []).append(y.detach().cpu())
        return y

    ops.crossbar_mac = recording
    try:
        losses = {}
        for d in ("cpu", dev):
            state = state_to(init_train_state(1, cfg, tcfg, device="cpu"), d)
            step = make_train_step(cfg, tcfg)
            out = []
            for b in batches:
                state, m = step(state, {k: v.to(d) for k, v in b.items()})
                out.append(float(m["loss"]))
            losses[str(d)] = out
    finally:
        ops.crossbar_mac = inner
    a, b = (torch.cat([t.reshape(-1) for t in seen[d]]) for d in ("cpu", "cuda"))
    agree = float((a == b).float().mean())
    err = max(abs(x - y) for x, y in zip(losses["cpu"], losses[str(dev)]))
    log(f"  smoke analog training, 2 steps, card vs CPU: losses {losses[str(dev)]} vs {losses['cpu']} "
        f"(max|Δ| {err:.3e}, atol {REF_TRAIN_LOSS_ATOL}); {agree:.6f} of {a.numel()} comparator "
        f"decisions equal (gate {REF_TRAIN_AGREEMENT})")
    if err > REF_TRAIN_LOSS_ATOL or agree < REF_TRAIN_AGREEMENT:
        raise AssertionError("smoke analog training disagrees card vs CPU")


def short_kernel_name(mangled: str) -> str:
    """``_ZN4raca21paged_decode_kernel_8I13__nv_bfloat16S1_EEv...`` ->
    ``paged_decode_kernel_8<bf16,bf16>`` (the types the kernels take)."""
    import re

    m = re.match(r"_ZN4raca(\d+)", mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    name, rest = mangled[m.end():m.end() + n], mangled[m.end() + n:]
    args, rest = [], rest[1:] if rest.startswith("I") else ""
    codes = (("13__nv_bfloat16", "bf16"), ("S1_", "bf16"), ("f", "f32"), ("a", "int8"))
    while rest and not rest.startswith("E"):
        lit = re.match(r"Li(\d+)E", rest)   # an int template argument
        code = next((c for c in codes if rest.startswith(c[0])), None)
        if lit:
            args.append(lit.group(1))
            rest = rest[lit.end():]
        elif code is not None:
            args.append(code[1])
            rest = rest[len(code[0]):]
        else:
            break
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_entries(text: str):
    """(kernel, "N registers, S bytes smem, spills S/L bytes") per entry
    function of an ``-Xptxas -v`` log, with the template arguments
    shortened."""
    import re

    entry, spill = None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = short_kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            smem = re.search(r"(\d+) bytes smem", line)
            yield entry, (f"{m.group(1)} registers, {smem.group(1) if smem else 0} bytes smem, "
                          f"{spill or 'no spill line'}")
            entry, spill = None, ""


# kernel -> its ptxas line, filled by the build phase (empty when cached)
PTXAS: dict[str, str] = {}


def log_ptxas(*kernels: str) -> None:
    for k in kernels:
        log(f"  ptxas {k}: {PTXAS.get(k, 'not rebuilt in this run')}")


def sass_instructions(sass: str, kernel: str) -> list[tuple[int, bool, str, str]]:
    """(address, predicated, opcode, operands) of ``kernel``'s instructions
    in ``cuobjdump -sass`` output."""
    import re

    body = next(b for b in sass.split("Function : ")[1:] if b.startswith(kernel + "\n"))
    return [(int(a, 16), bool(p), op, args) for a, p, op, args in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]


def _branch_target(ins, i) -> int:
    import re

    return int(re.search(r"0x([0-9a-f]+)", ins[i][3]).group(1), 16)


def sass_walk(ins, start: int = 0, *, loop: tuple[int, int] | None = None,
              first_exit: bool = False) -> list[str]:
    """Opcodes on the common path from ``ins[start]``, falling through every
    predicated branch except a forward one that jumps over a loop or a
    call (cosf's Payne-Hanek reduction, sqrtf's special-case call, a loop
    the path does not enter), up to the first unpredicated EXIT (any EXIT
    with ``first_exit``).  With ``loop = (head, back edge)`` the walk
    stays inside that loop (a branch out of it falls through) and ends at
    its back edge: one iteration."""
    at = {a: i for i, (a, *_rest) in enumerate(ins)}

    def slow(i):   # a loop's back edge or a call
        op = ins[i][2].split(".")[0]
        return op == "CALL" or (op == "BRA" and _branch_target(ins, i) <= ins[i][0])

    path, i, seen = [], start, set()
    while True:
        if i in seen:
            raise AssertionError(f"the common path loops at {ins[i][0]:#x}")
        seen.add(i)
        _addr, pred, op, _ = ins[i]
        path.append(op)
        base = op.split(".")[0]
        if loop is not None and i == loop[1]:
            return path
        if base == "EXIT" and (first_exit or not pred):
            return path
        if base == "BRA":
            j = at[_branch_target(ins, i)]
            inside = loop is None or loop[0] <= j <= loop[1]
            if inside and (not pred or (j > i and any(slow(k) for k in range(i + 1, j)))):
                i = j
                continue
        i += 1


def sass_common_path(sass: str, kernel: str) -> list[str]:
    """Opcodes on ``kernel``'s common path from its entry to its first
    unpredicated EXIT (:func:`sass_walk`)."""
    return sass_walk(sass_instructions(sass, kernel))


def sass_loops(ins) -> list[tuple[int, int]]:
    """(head, back edge) index pairs of the loops: every branch to an
    earlier address (not the ``BRA`` to itself that ends the code)."""
    at = {a: i for i, (a, *_rest) in enumerate(ins)}
    return [(at[_branch_target(ins, i)], i) for i, (a, _p, op, _) in enumerate(ins)
            if op.split(".")[0] == "BRA" and _branch_target(ins, i) < a]


def pipe_clocks(ops) -> dict:
    """Clocks of one scheduler for warp instructions ``ops`` (opcode ->
    count, the count may be fractional): the issue slot (every
    instruction), the ALU (integer logic, shifts, adds, compares, selects,
    moves), the FMA pipes (f32 arithmetic on both halves, IMAD on the
    heavy half only) and the XU (MUFU, conversions)."""
    alu = {"LOP3", "SHF", "IADD3", "VIADD", "ISETP", "FSETP", "FSEL", "SEL", "LEA", "MOV",
           "I2FP", "PRMT", "FMNMX", "IMNMX", "PLOP3", "POPC", "FLO"}
    fp = {"FFMA", "FMUL", "FADD", "HFMA2", "HADD2", "HMUL2"}
    xu = {"MUFU", "F2I", "I2F", "F2F", "FRND"}
    count = {}
    for op, k in ops.items():
        count[op.split(".")[0]] = count.get(op.split(".")[0], 0) + k
    n_imad = count.get("IMAD", 0)
    return {
        "issue": sum(count.values()),
        "ALU": 2 * sum(k for b, k in count.items() if b in alu),
        "FMA": max(sum(k for b, k in count.items() if b in fp) + n_imad, 2 * n_imad),
        "XU": 8 * sum(k for b, k in count.items() if b in xu),
    }


def issue_estimate(path: list[str]) -> dict:
    """Clocks of one scheduler per warp of elements on ``path``
    (:func:`pipe_clocks`); the pipe with the most clocks bounds it."""
    from collections import Counter

    clocks = pipe_clocks(Counter(path))
    return {"instructions": len(path), "clocks": clocks, "pipe": max(clocks, key=clocks.get)}


def ab_phase(dev, parent: Path) -> None:
    """``--ab DIR``: the wta_counts and stoch_round kernels of the checkout
    at DIR (its package loaded as ``repro_torch_ab``, built into DIR's own
    build directory) against this checkout's, on the same inputs in one
    process, and both attention kernels at stablelm-3b's head shape
    (decode B = 8 over W = 32, prefill S = 128 at q0 = 128; bf16 and int8
    pools): outputs compared (each pair runs the same arithmetic in the
    same order, so they must be equal) and device times, then per-call
    times (host included, 200 back-to-back calls), taken in turns, DIR,
    this, this, DIR."""
    import importlib
    import importlib.util

    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import stoch_round as SR
    from repro_torch.kernels import wta_counts as WTA

    pkg = parent / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "repro_torch_ab", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    sys.modules["repro_torch_ab"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["repro_torch_ab"])
    old_wta = importlib.import_module("repro_torch_ab.kernels.wta_counts")
    old_sr = importlib.import_module("repro_torch_ab.kernels.stoch_round")
    old_pa = importlib.import_module("repro_torch_ab.kernels.paged_attention")
    old_pf = importlib.import_module("repro_torch_ab.kernels.prefill_attention")
    gen = torch.Generator(device=dev).manual_seed(16)

    def seeds(k):
        return torch.randint(0, 2**32, (k,), generator=gen, device=dev, dtype=torch.int64)

    cases = []
    for b, c, t in ((8, 50304, 32), (256, 128, 64), (64, 10, 100)):
        kw = dict(n_trials=t, vth0=WTA_VTH0, sigma_z=WTA_SIGMA)
        sets = [(torch.randn((b, c), generator=gen, device=dev) * WTA_SIGMA, seeds(1), kw)
                for _ in range(ROTATE)]
        cases.append((f"wta_counts ({b}, {c}) T={t}", old_wta.wta_counts_cuda,
                      WTA.wta_counts_cuda, sets))
    for (m, n), g, step, lo, hi in (((2048, 2048), 1, 2.0 / 31, -1.0, 1.0),
                                    ((256, 80), 1, 1.0, -127.0, 127.0),
                                    ((4096, 80), 8, 1.0, -127.0, 127.0)):
        kw = dict(step=step, lo=lo, hi=hi)
        sets = [(torch.randn((m, n), generator=gen, device=dev) * 0.8 * hi, seeds(g), kw)
                for _ in range(ROTATE)]
        cases.append((f"stoch_round ({m}, {n}), {g} seeds", old_sr.stoch_round_cuda,
                       SR.stoch_round_cuda, sets))
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        sets = [decode_case(gen, dev, 8, 32, 32, 80, 16, 32, int8) for _ in range(ROTATE)]
        cases.append((f"decode attention stablelm-3b {tag} B=8 W=32",
                      old_pa.paged_attention_cuda, PA.paged_attention_cuda, sets))
        sets = [prefill_case(gen, dev, 128, 128, 32, 32, 80, 16, 16, int8) for _ in range(ROTATE)]
        cases.append((f"prefill attention stablelm-3b {tag} S=128 q0=128",
                      old_pf.paged_prefill_attention_cuda, PF.paged_prefill_attention_cuda, sets))
    for label, old, new, sets in cases:
        *args, kw = sets[0]
        if not torch.equal(old(*args, **kw), new(*args, **kw)):
            raise AssertionError(f"{label}: this checkout's kernel differs from {parent}'s")
        fns = [[(lambda f=f, a=a: f(*a[:-1], **a[-1])) for a in sets] for f in (old, new)]
        for what, timer in (("device", device_ms), ("per call", lambda f: cuda_ms(f, 200))):
            t = [timer(fns[i]) for i in (0, 1, 1, 0)]
            log(f"  A/B {label}: equal outputs; {what} ms {parent.name} {t[0]:.4f}, this "
                f"{t[1]:.4f}, this {t[2]:.4f}, {parent.name} {t[3]:.4f}; ratio "
                f"{(t[0] + t[3]) / (t[1] + t[2]):.2f}x")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log("== device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    log("== build")
    t0 = time.perf_counter()
    logs = build.build_all(build.sources())
    log(f"  built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for entry, info in ptxas_entries(text):
            PTXAS[entry] = info
            log(f"  {name}: {entry}: {info}")

    if "--ab" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--ab") + 1]).resolve()
        log(f"== A/B against {parent}")
        ab_phase(dev, parent)
        return 0

    log("== kernels vs plain versions")
    kres = kernel_phase(dev)
    # phase 4e (d)'s kernel rows, here: late in the process (after the
    # profiled serves, PRs 25 and 26) the profiler has dropped one call's
    # events of ten from every trace of a row
    log("== 4e (d): bench_kernels' cases, profiled")
    kres["bench_kernel_times"] = bench_kernel_times(dev)
    log("== serve stablelm-3b (bf16 pool, int8 pool, then WTA sampling on the bf16 pool at "
        "R = 1 and 3)")
    sres = serve_phase(dev, kres["w_invariance"]["bf16"]["identical"])
    log("== 4e: the training loop (checkpoints, restart, compression), serve.py --ckpt-dir, "
        "the paper's benches and examples")
    lres = loop_phase(dev)
    log("== stoch_round and wta_counts entry points")
    srres = stoch_round_phase(dev)
    wres = wta_phase(dev)
    log("== crossbar_mac and wta_counts through the fault backend")
    fres_faulty = faulty_phase(dev)
    log("== analog training of stablelm-3b")
    tres = train_phase(dev)
    log("== the paper's FCNN: fcnn-mnist [784, 500, 300, 10] training and RACA inference")
    fres = fcnn_phase(dev)
    # after the phases that gate on profiler event counts (4e (d)), which
    # lost events once this phase's six profiled serves ran before them
    log("== 4g: gemma2-2b at full width and depth (bf16, int8, WTA; decode past 4096), "
        "deepseek-coder-33b (8 layers) and nemotron-4-340b (2 layers)")
    gres = decoders_phase(dev)
    log("== 4h: recurrentgemma-2b at full width and depth (RG-LRU + MQA local attention: bf16, "
        "int8, WTA, WTA int8; past the window of 2048; sharing, preemption and rollback of the "
        "recurrent state; one analog training step)")
    hres = hybrid_phase(dev)
    log("== 4i: mamba2-1.3b at full width and depth (attention-free, no K/V pool: bf16 and "
        "WTA compiled = eager, an int8 config; chunked against whole prefill; sharing, "
        "preemption and rollback of the SSM state; one analog training step)")
    ires = ssm_phase(dev)
    log("== 4j: granite-moe-3b-a800m at full width and depth (40 experts top-8, GShard capacity "
        "dispatch: bf16, int8, WTA compiled = eager; its MoE sublayers a tick; the drop share), "
        "granite's and grok's heads, sharing / chunked prefill / preemption / rollback on a "
        "drop-free f32 copy, one analog step with the WTA router, grok-1-314b cut to 4 layers")
    jres = moe_phase(dev)
    log("== 4k: whisper-small at full width and depth (encoder-decoder, the dense serve step: "
        "greedy and WTA compiled = eager, the cross cache probed; an f32 copy against "
        "decode_train; one analog training step)")
    kres4 = encdec_phase(dev)
    log("== 4l: llava-next-34b at full width cut to 8 layers (served as a token LM; the patch "
        "prefix through the dense prefill and decode against lm_forward)")
    lres4 = vlm_phase(dev)
    log("== 4m: the dry run's meta counts against the card (stablelm-3b train 8 x 128, prefill "
        "4 x 2048, decode 8 x 4096), remat_policy on the card, the generic stoch_round and "
        "wta_counts_reference through the seam")
    mres = dryrun_phase(dev)
    # after 4m, whose remat peaks differ by megabytes and so depend on the
    # allocator's history
    log("== 4o: training on a 1 x 1 DTensor mesh (a one-rank NCCL group): loop.run unsharded "
        "and on the mesh, an unsharded checkpoint loaded onto it, the dry run's count at 1 x 1, "
        "train.py --sharded")
    ores = train_mesh_phase(dev)
    log("== small-input reference")
    reference_phase(dev)
    reference_wta(dev)
    reference_train(dev)
    reference_fcnn(dev)
    reference_ssm(dev)
    reference_moe(dev)
    reference_encdec(dev)
    reference_vlm(dev)

    launches = dict(sres["same"]["launches"])
    launches["write_kv_int8"] = sres["int8"]["launches"]["write_kv_int8"]
    launches["stoch_round"] = srres["launches"]
    launches["wta_counts"] = wres["launches"]
    launches["crossbar_mac"] = tres["launches"]
    launches["crossbar_prepass"] = tres["prepass_launches"]
    launches["wta_sample"] = sres["wta"]["launches"]["wta_sample"]
    launches["sigmoid_sample"] = fres["launches"]["sigmoid_sample"]
    kernels = []
    for key, tkey, name, src, replaces in (
        ("decode", ("decode", "bf16"), "paged_attention",
         "src/repro_torch/kernels/csrc/paged_attention.cu", "src/repro/kernels/paged_attention.py:204"),
        ("prefill", ("prefill", "bf16"), "paged_prefill_attention",
         "src/repro_torch/kernels/csrc/prefill_attention.cu",
         "src/repro/kernels/prefill_attention.py:210"),
        ("stoch_round", "stoch_round", "stoch_round",
         "src/repro_torch/kernels/csrc/stoch_round.cu", "src/repro/kernels/stoch_round.py:82"),
        ("write_kv_int8", "write_kv_int8", "write_kv_int8",
         "src/repro_torch/kernels/csrc/stoch_round.cu", "src/repro/kernels/stoch_round.py:82"),
        ("wta_counts", "wta_counts", "wta_counts",
         "src/repro_torch/kernels/csrc/wta_counts.cu", "src/repro/kernels/wta_kernel.py:100"),
        ("crossbar_mac", "crossbar_mac", "crossbar_mac",
         "src/repro_torch/kernels/csrc/crossbar_mac.cu", "src/repro/kernels/crossbar_mac.py:154"),
        ("crossbar_prepass", "crossbar_prepass", "crossbar_prepass",
         "src/repro_torch/kernels/csrc/crossbar_mac.cu", "src/repro/kernels/crossbar_mac.py:154"),
        # no Pallas kernel: the reference's wta_trials in jnp
        ("wta_sample", "wta_sample", "wta_sample",
         "src/repro_torch/kernels/csrc/wta_sample.cu", "src/repro/core/wta.py:50"),
        # no Pallas kernel: the reference's stochastic Sigmoid neurons in jnp
        ("sigmoid_sample", "sigmoid_sample", "sigmoid_sample",
         "src/repro_torch/kernels/csrc/sigmoid_sample.cu", "src/repro/core/neurons.py:77"),
    ):
        t = kres["timing"][tkey]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[key], "max_abs_err": max(kres["errs"][key]),
            "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
        for extra in ("f32_bound_ms", "gemm_device_ms", "tile_n", "tile_device_ms", "one_pass",
                      "issue_ms", "issue_instructions", "issue_pipe", "cluster", "cta_warps",
                      "geometry_device_ms", "byte_bound_ms", "fcnn_head"):
            if extra in t:
                kernels[-1][extra] = t[extra]
        if "cases" in t:
            kernels[-1]["cases"] = t["cases"] + (
                kres["timing"][(key, "int8")].get("cases", []) if isinstance(tkey, tuple) else [])
    # phase 3's cases at the other decoder configs' head shapes, and phase
    # 4g's launches, each run reset just before it and read just after
    heads = kres["timing"]["head_shapes"]
    for name, key in (("paged_attention", "decode"), ("paged_prefill_attention", "prefill"),
                      ("write_kv_int8", "write_kv_int8"), ("wta_sample", "wta_sample")):
        rec = next(k for k in kernels if k["name"] == name)
        rec.setdefault("cases", []).extend(heads[key])
        launches_4g = {f"gemma2 {run}": gres[run]["launches"][key]
                       for run in ("same", "int8", "wta")}
        if key in ("decode", "prefill"):
            launches_4g["gemma2 long"] = gres["long"]["launches"][key]
            for arch, run in gres["cuts"].items():
                launches_4g[arch] = run["launches"][key]
        rec["launches_4g"] = launches_4g
    # phase 4h: recurrentgemma-2b's runs, each reset just before it and read
    # just after, and its head's cases
    hheads = hres["heads"]
    for name, key in (("paged_attention", "decode"), ("paged_prefill_attention", "prefill"),
                      ("write_kv_int8", "write_kv_int8"), ("wta_sample", "wta_sample")):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_4h"] = {f"recurrentgemma {run}": hres[run]["launches"][key]
                              for run in ("same", "int8", "wta", "wta_int8")}
        if key in ("decode", "prefill"):
            rec["launches_4h"]["recurrentgemma long"] = hres["long"]["launches"][key]
        if key in hheads:
            rec["cases"].extend(hheads[key])
            rec["max_abs_err_4h"] = max(hres["head_errs"][key])
    for name in ("crossbar_mac", "crossbar_prepass", "sigmoid_sample"):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_4h"] = {"recurrentgemma analog step": hres["train"]["launches"][name]}
    next(k for k in kernels if k["name"] == "sigmoid_sample")["max_abs_err_4h"] = \
        hres["train"]["gate_err"]
    next(k for k in kernels if k["name"] == "crossbar_mac")["reads_4h"] = hres["train"]["reads"]
    # phase 4i: mamba2-1.3b's runs, each reset just before it and read just
    # after: no attention kernel and no int8 write in any of them
    for name, key in (("paged_attention", "decode"), ("paged_prefill_attention", "prefill"),
                      ("write_kv_int8", "write_kv_int8"), ("wta_sample", "wta_sample")):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_4i"] = {f"mamba2 {run}": ires[run]["launches"][key]
                              for run in ("same", "int8", "wta")}
        rec["launches_4i"].update({"mamba2 f32 preempt": ires["preempt"]["launches"][key],
                                   "mamba2 f32 spec": ires["spec"]["launches"][key]})
    for name in ("crossbar_mac", "crossbar_prepass", "sigmoid_sample"):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_4i"] = {"mamba2 analog step": ires["train"]["launches"][name]}
    next(k for k in kernels if k["name"] == "crossbar_mac")["reads_4i"] = ires["train"]["reads"]
    # phase 4j: granite's and grok's runs, each reset just before it and
    # read just after, and the two heads' cases
    jheads = jres["heads"]
    for name, key in (("paged_attention", "decode"), ("paged_prefill_attention", "prefill"),
                      ("write_kv_int8", "write_kv_int8"), ("wta_sample", "wta_sample")):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_4j"] = {f"granite {run}": jres[run]["launches"][key]
                              for run in ("same", "int8", "wta")}
        rec["launches_4j"].update({"granite f32 preempt": jres["preempt"]["launches"][key],
                                   "granite f32 spec": jres["spec"]["launches"][key]})
        if key in ("decode", "prefill"):
            rec["launches_4j"]["grok cut"] = jres["grok"]["launches"][key]
        if key in jheads:
            rec["cases"].extend(jheads[key])
            rec["max_abs_err_4j"] = max(jres["head_errs"][key])
    for name in ("crossbar_mac", "crossbar_prepass", "sigmoid_sample", "wta_sample"):
        rec = next(k for k in kernels if k["name"] == name)
        rec.setdefault("launches_4j", {})["granite analog step"] = \
            jres["train"]["launches"][name]
    next(k for k in kernels if k["name"] == "crossbar_mac")["reads_4j"] = jres["train"]["reads"]
    next(k for k in kernels if k["name"] == "wta_sample")["router_err_4j"] = \
        jres["train"]["router_err"]
    # phases 4k and 4l: whisper's dense serves and analog step, llava's
    # token-LM serve and its prefix runs, each reset just before it and
    # read just after (the dense paths launch no attention kernel)
    for name, key in (("paged_attention", "decode"), ("paged_prefill_attention", "prefill"),
                      ("write_kv_int8", "write_kv_int8"), ("wta_sample", "wta_sample")):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_4k"] = {f"whisper {mode} {run}": kres4[mode][run]["launches"][key]
                              for mode in ("greedy", "wta") for run in ("graphs", "eager")}
        rec["launches_4l"] = {"llava prefix": lres4["prefix"]["launches"][key],
                              "llava f32 prefix": lres4["prefix_f32"]["launches"][key]}
        if key in ("decode", "prefill"):
            rec["launches_4l"]["llava cut"] = lres4["cut"]["launches"][key]
    for name in ("crossbar_mac", "crossbar_prepass", "sigmoid_sample", "wta_sample"):
        rec = next(k for k in kernels if k["name"] == name)
        rec.setdefault("launches_4k", {})["whisper analog step"] = \
            kres4["train"]["launches"][name]
    next(k for k in kernels if k["name"] == "crossbar_mac")["reads_4k"] = kres4["train"]["reads"]
    # phase 4m: the remat runs' crossbar launches and the seam's, each reset
    # just before it and read just after
    for name in ("crossbar_mac", "crossbar_prepass"):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_4m"] = {f"stablelm {mode} {policy}": run[name]
                              for mode, runs in mres["remat"].items()
                              for policy, run in runs.items()}
    sr_rec = next(k for k in kernels if k["name"] == "stoch_round")
    sr_rec["launches_4m"] = {"ops.stoch_round": mres["seam"]["stoch_round_launches"]}
    sr_rec["generic_2048"] = mres["seam"]["stoch_round_timing"]
    next(k for k in kernels if k["name"] == "wta_counts")["launches_4m"] = {
        "ops.wta_counts": mres["seam"]["wta_counts"]["launches"]}
    wta_rec = next(k for k in kernels if k["name"] == "wta_sample")
    wta_rec["cases"].extend(kres4["wta_cases"])
    wta_rec["max_abs_err_4k"] = max(kres4["wta_errs"])
    # the R = 3 serve of the same trace and the FCNN's head: their own
    # paths, counted apart
    wta_rec = next(k for k in kernels if k["name"] == "wta_sample")
    wta_rec["launches_r3"] = sres["wta_r3"]["launches"]["wta_sample"]
    wta_rec["launches_fcnn_head"] = fres["launches"]["wta_sample"]
    # the backend seam's paths: the degraded serve's canary reads, the
    # entry points through the fault backend
    deg = sres["degraded"]["ladder"]
    cb_rec = next(k for k in kernels if k["name"] == "crossbar_mac")
    cb_rec["launches_canary"] = deg["crossbar_launches"]
    cb_rec["launches_faulty"] = fres_faulty["crossbar_launches"]
    cb_rec["max_abs_err_faulty"] = fres_faulty["crossbar_err"]
    wc_rec = next(k for k in kernels if k["name"] == "wta_counts")
    wc_rec["launches_faulty"] = fres_faulty["wta_launches"]
    wc_rec["max_abs_err_faulty"] = fres_faulty["wta_err"]
    # phase 4c: each run's launches, reset just before it and read just after
    pre = sres["preempt"]
    for name, key in (("paged_attention", "decode"), ("paged_prefill_attention", "prefill"),
                      ("write_kv_int8", "write_kv_int8"), ("wta_sample", "wta_sample")):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_preempt"] = {run: pre[run]["launches"][key]
                                   for run in ("a", "b", "c", "d_same", "d_int8")}
    # phase 4o: the unsharded and the 1 x 1 loop's reads, each reset just
    # before it and read just after
    for name in ("crossbar_mac", "crossbar_prepass"):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_4o"] = {f"{tag} loop": ores["loop"][tag]["launches"].get(name, 0)
                              for tag in ("plain", "mesh")}
    # phase 4n: the 1 x 1 mesh's serves, each reset just before it and
    # read just after
    mres4 = sres["mesh"]
    for name, key in (("paged_attention", "decode"), ("paged_prefill_attention", "prefill"),
                      ("write_kv_int8", "write_kv_int8"), ("wta_sample", "wta_sample")):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_4n"] = {f"1x1 {run}": mres4[run]["launches"][key]
                              for run in ("same", "int8", "wta", "spec")}
    # phase 4d: each speculative run's launches, reset just before it and
    # read just after
    spec = sres["spec"]["runs"]
    for name, key in (("paged_attention", "decode"), ("paged_prefill_attention", "prefill"),
                      ("write_kv_int8", "write_kv_int8"), ("wta_sample", "wta_sample")):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_spec"] = {run: spec[run]["launches"][key] for run in spec}
    # phase 4f: the dense layout's and the static engine's runs, each reset
    # just before it and read just after (attention and the int8 write: 0)
    dense = sres["dense"]
    for name, key in (("paged_attention", "decode"), ("paged_prefill_attention", "prefill"),
                      ("write_kv_int8", "write_kv_int8"), ("wta_sample", "wta_sample")):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_dense"] = {run: dense[run]["launches"][key]
                                 for run in ("greedy", "wta", "int8", "static", "static_wta")}
    # phase 4e: each path's launches, reset just before it and read just after
    for rec in kernels:
        name = rec["name"]
        rec["launches_4e"] = {
            "loop_analog": lres["a_analog"]["launches"][0].get(name, 0),
            "serve_ckpt": lres["c"]["launches"].get(name, 0),
            "benches": lres["d"]["launches"].get(name, 0),
            "quickstart": lres["f"]["quickstart_launches"].get(name, 0),
            "serve_example_int8": lres["f"]["serve_int8_launches"].get(name, 0),
            "fig6_sweeps": fres["sweeps"]["launches"].get(name, 0),
        }
    log("== done: the whole script, the kernels' build included")
    log(smi)  # again here, so that the tail of a long output still holds it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
