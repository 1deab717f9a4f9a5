#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and then its wall time (``time:
<phase> <s> s``); any failure exits non-zero:

1. Device and build: the card's name and power limit (``nvidia-smi``), and
   the build of the CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. The aggregation and update kernels against their plain PyTorch versions
   on the card, in fp32 and bf16 fleets, at the main path's shape (A=20,
   R=4, N=31,810), the paper fleet (A=100, R=10) and perception scale
   (A=100, R=10, N=9,540,010, the 784-12000-10 MLP): max error, the
   kernel's time (CUDA events, median of 11 timed runs of 10 launches after
   warm-up), its bound at the H100's 3.35 TB/s and 67 TFLOP/s fp32, the
   plain version's time and, for the aggregation kernels, one PyTorch
   call's time (``library_ms``).  ``agg_blend`` and ``cloud_blend`` are
   timed as the whole entry the engine calls (the weights built in the
   kernel) and in the coef form with their operands ready; ``agg_blend``'s
   bound counts prev only for its zero-mass rows, the only rows it reads.
   For the whole entries, ``dual_proximal_sgd`` in the engine's form,
   ``weighted_agg_matmul`` and the coef forms, the time split into device
   time a call (``device_ms``, ``torch.profiler``) and host time a call
   (``host_us``: 1,000 calls enqueued without a synchronise, on the host
   clock); at the main shape also the host time of the matmul's launch
   path's pieces.
2b. flash_attention against its plain version in bf16 and fp32: a small
   ragged case (B=2, S=200, H=4, KV=2, D=64), the qwen3-0.6b layer (B=1,
   S=4096, H=16, KV=8, D=128) causal and with a 1024 window, two ragged
   cases at its heads (S=129 causal, S=1000 non-causal), whisper-tiny's
   decoder self-attention at its prefill shape (B=32, S=448, H=KV=6, D=64,
   causal) and GQA 8/2 at D = 64 (B=2, S=1000, causal); in bf16 D = 64
   runs the TMA + wgmma kernel at (64, 64), each row names the kernel
   (``kernel_route``), and each bf16 D = 64 case is held again with the
   log-sum-exp saved (the output at ``TOL``, the lse against the plain
   logsumexp within 1e-5 relative, ``lse_err``) and split into device
   time a call (``device_ms``, ``torch.profiler``) and host time a call
   (``host_us``), since a short call's event time is its host path's,
   with SDPA's device time beside it (``library_device_ms``);
   bound at 989 TFLOP/s
   bf16 / 67 TFLOP/s fp32 over the live (query, key) pairs;
   ``library_ms`` is one ``scaled_dot_product_attention`` call (timed only,
   the port never calls it); for bf16 also ``ms_with_lse``, the forward
   that saves the log-sum-exp for the backward, timed in turns with the
   forward without it (``cuda_ms_pair``).  Then the serving path's
   shape (B=4, S=8192) in bf16, the plain version run one batch row at a
   time, with and without the log-sum-exp.  Then MLA's head dims (q/k 192,
   v 128; ``flash_attention_mla``: in bf16 the D = 128 kernel's TMA +
   wgmma design with q/k rows of three 128-byte boxes, in fp32 the FMA
   kernel) at deepseek-v2-lite's layer (B=1, S=4096, H=KV=16) causal and
   with a 1024 window, S=129 causal and S=1000 non-causal, bf16 and fp32,
   and its prefill shape (B=4, S=8192) in bf16, each held to the plain
   version elementwise at ``TOL`` (P stays fp32 as bf16 hi + lo parts, so
   PV is two products: one bf16 P would miss that tolerance on outputs
   near zero); bound 2 (192 + 128) flops a live pair and head (the hi + lo
   work is 2 (192 + 2 x 128), 1.4x that); ``library_ms`` SDPA, with v
   zero-padded to 192 where no fused backend takes v's width
   (``library_padded_v``).  Then zamba2-2.7b's head dim 80
   (``flash_attention_d80``: in bf16 the TMA + wgmma kernel, q/k rows of
   two 128-byte boxes and PV as wgmma m64n80k16, in fp32 the FMA kernel
   with a ragged third column group) at its shared attention layer
   (B=1, S=4096, H=KV=32) causal and with a 1024 window, S=129 causal,
   S=1000 non-causal and a GQA case (H=8, KV=2), bf16 and fp32, and its
   prefill shape (B=4, S=8192, H=32) in bf16; bound 320 flops a live pair
   and head; ``library_ms`` SDPA.  Then phi-3-vision-4.2b's head dim 96
   (``flash_attention_d96``: in bf16 the TMA + wgmma kernel, q/k rows of
   two 128-byte boxes, the second zero past column 32, and PV as wgmma
   m64n96k16; in fp32 the FMA kernel) at its layer (B=1, S=4096,
   H=KV=32) causal and with a 1024 window, S=129 causal, S=1000
   non-causal and a GQA case (H=8, KV=2), bf16 and fp32, and its prefill
   shape (B=4, 576 patches + 3,520 tokens = 4,096 positions, H=32) in
   bf16; at 80 and 96 each bf16 case also with the log-sum-exp saved, as
   the backward takes it (``lse_err``).  Then nemotron-4-340b's head dims
   (192, 192)
   (``flash_attention_d192``: in bf16 the TMA + wgmma kernel with K/V
   tiles of 64 keys, q/k/v rows of three 128-byte boxes, QK^T as wgmma
   m64n64k16 and PV as m64n192k16; in fp32 the FMA kernel) at its layer
   (B=1, S=4096, H=96 over KV=8) causal and with a 1024 window, S=129
   causal and S=1000 non-causal, bf16 and fp32, and its prefill shape
   (B=4, S=8192) in bf16; and #4 at the prefill shapes of yi-34b (H=56)
   and command-r-35b (H=64) over KV=8 at D = 128 (B=4, S=8192, bf16);
   at these prefill shapes the plain version runs one batch row and at
   most 32 heads (whole GQA groups) at a time.  Last, keys of their own length (``flash_attention_cross``: S
   queries over T keys, non-causal, whisper's cross-attention) at
   whisper-tiny's prefill (B=32, S=448, T=1500, H=6, D=64; the TMA +
   wgmma kernel in bf16), one decode token over 1500 frames at batch 8
   and one over 257 keys with GQA 4/2 (the split-key kernel in bf16), a
   ragged case (S=100, T=257) and at D = 128, 80, 96 and 192 on the TMA +
   wgmma kernel, bf16 and fp32, the bf16 D = 64 cases also with the
   log-sum-exp; bound over the S x T pairs; ``library_ms`` SDPA.
2c. slstm_scan against its plain version with R in bf16 and fp32: the
   shapes of the JAX package's kernel tests, saturated gates (inputs x25)
   and the xlstm-125m layer (B=4, S=8192, H=4, P=192); bound at 67 TFLOP/s
   fp32 (a recurrence cannot reach it: beside it the same S steps at the
   smallest width, H=1, P=8, as the kernel's latency floor); no
   ``library_ms`` (PyTorch has no sLSTM call).
3. The flat-round main path: the ``examples/quickstart.py`` scenario
   through ``ScenarioSpec -> pretrain_to_target -> run_scenario`` on the
   card, with the launch counts set to 0 just before and read just after;
   the mean final accuracy of that run and four more draw realizations
   must beat the pre-trained model by 0.05.  Then 2 rounds with a bf16
   fleet, 1 round with ``fused=False`` (the ``weighted_agg_matmul`` path),
   and 2 rounds on the card against the same 2 rounds on the host (plain
   versions) with the same injected draws.  Last, three global rounds on
   the host clock and under ``torch.profiler`` (wall, launches and device
   busy share a round), and 20 calls each of ``agg_blend``,
   ``cloud_blend`` and ``dual_proximal_sgd`` under it: each call must be
   one launch of its kernel and nothing else.
3b. The semi-async path: the quickstart fleet in the 90%-disconnect
   regime of ``benchmarks/async_round.py`` (async at CSR 0.25 with
   max_delay 2, delay_p 0.6, so CSR x P(d=0) = 0.1; staleness decay 0.5,
   buffer keep 0.5, the per-round cloud cadence; 30 rounds) through
   ``run_scenario(engine="async")`` on the card, counted: exactly one
   ``agg_absorb`` launch a tick, one ``cloud_blend`` a round, the update
   kernel each step.  The mean final accuracy of five draw realizations
   must not fall below the pre-trained model's (printed beside the flat
   engine's at CSR 0.1), with every buffer finite.  Then 2 async rounds on
   the card against the same rounds on the host (plain versions), the
   card's own draws replayed on both: fp32 buffers within 1e-5, in-flight
   weights and tick counts equal; again with a bf16 fleet (rounds of one
   tick, each from the card's state; one bf16 ulp), with ``fused=False``
   (the scatter-accumulates on the matmul kernel, counted) and with
   ``cloud_every=3``.  Faults: an empty plan equals ``faults=None`` bit for
   bit on the card, on the flat and the async engine; under churn, an RSU
   outage with recovery, NaN poison, scale caught by ``norm_clip`` and
   stale replay, card and host agree (quarantine counts and blocked mass
   equal, buffers within 1e-5, the cloud finite) on both engines.  Last,
   wall, launches and device busy share a round of the async round beside
   the flat round's at the main and paper fleets, and 20 ``agg_absorb``
   calls under the profiler: one launch of kernel #1 a call, with the
   launches and time of the weight building around it.
3s. The multi-scenario sweep (``run_scenarios``) on Fig. 2's grid of
   ``benchmarks/fig2_mu1_csr.py`` at full bench scale (A=100, R=10,
   N=31,810; LAR 5, E 3, lr 0.15), from the biased OEM model.  Each
   scenario-axis kernel entry at the sweep shape (S=16, fp32) against its
   plain version, one launch a call (``agg_blend``, ``cloud_blend``,
   ``agg_absorb``, the batched matmul of #2 with ``torch.bmm`` as its
   library call, #3 with per-scenario lr / mu1 / mu2).  Then the sweep
   against each cell's sequential ``run_scenario`` on the card, 2 rounds,
   buffers within 1e-5: 4 cells (mixed csr and mu1, one at lar 3), the
   async equivalent (cloud_every 0 and 3) and a fault grid (different
   plans, one guard); a 3-cell grid in the quickstart's regime on the card
   against the host's plain versions with the same card-drawn draws; one
   16-cell chunk, 5 rounds, counted (#1 and #3 launches a round equal to
   one scenario's); ``fused=False`` counted (#2); wall, launches and device
   busy of a sweep round beside two cells' sequential rounds; the whole
   72-cell grid at ``max_sweep=16``, 1 round: 5 chunks, one program build,
   histories in input order.
3t. Cohort streaming (``fedsim/streaming``, ``core/fleet_store``).  (a)
   At the main (A=20, R=4) and paper (A=100, R=10) fleets, 2 rounds, fp32,
   from the MLP's initial weights, the card's draws replayed on both
   sides: the host-streamed flat and async rounds in chunks of 7 (a
   padded tail) against the resident rounds (buffers within 1e-4,
   accuracy within 2e-3, the async in-flight weights and ticks equal),
   counted (one ``chunk_agg`` launch of #2 a flat chunk, two an async
   one, one ``cloud_blend`` a round); device-chunked == host-streamed and
   an empty plan == none, bit for bit, on the flat, async and two-axis
   rounds; a bf16 host store finite and within 5e-2 of the fp32 round.
   (b) The two-axis round at the perception MLP (tiles of 1,048,576
   columns, chunks of 25 agents) against the one-axis streamed round, 1
   round: max relative difference (limit 1e-6), whether it is bitwise,
   and the peak device memory of each.  (c) The fleet cell of
   ``benchmarks/streaming_round.py`` at the paper MLP's width: a pinned
   host fleet of 100,000 agents (12.72 GB), R=16, chunks of 16,384, one
   timed round after a warm-up: wall, agents/s, the bytes that crossed
   against ``streamed_transfer_bytes``, the device time split into
   compute and copies; peak device memory there and at 25,000 agents,
   equal within 1%.  (d) #2 as ``chunk_agg`` at that chunk shape (R=16,
   A=16,384, N=31,810, fp32 and bf16 rows) against its plain version,
   with its time, its byte bound and ``torch.matmul``'s time.  (e) The
   host-streamed flat round's wall, launches and device busy share at the
   main fleet beside the resident round's.  (f) Resident fleets past the
   ring kernel's shared memory: the resident flat and async rounds at A =
   5,000, R = 10 (the ring takes 4,001 agents for ``agg_blend``, 2,334 a
   cohort for ``agg_absorb``), counted (#2's agent tiles, ``agg_blend_tiled``
   / ``agg_absorb_tiled``, and no ring launch on the RSU layer), against
   the host-streamed rounds of the same spec: cloud and RSU rows within
   1e-4, accuracy within 2e-3.
3v. The continuous serving loop (``fedsim/serving``, ``core/load_gen``)
   on the nominal cell's spec of ``benchmarks/serving_loop.py`` (batch 16,
   LAR 2, E 1, lr 0.1, decay 1.0), 100 samples an agent, from the MLP's
   initial weights.  (a) Every agent once a tick window, trigger batch:A,
   the per-round cadence, 3 rounds, at the main (A=20, R=4) and paper
   (A=100, R=10) fleets against ``run_scenario(engine="async")`` on the
   card: cloud within rtol 2e-5 / atol 2e-6, accuracy within 2e-6, and
   whether bitwise.  (b) A Poisson run at the main fleet (batch:4,
   deadline:2.0, capacity 16) under churn, an RSU outage, duplicates and
   clock skew on the card and on the host with the card's draws: every
   counter, drain size and queue depth equal, buffers within 1e-5; one
   bf16 tick from the same state within one bf16 ulp.  (c) A Poisson run
   against the replay of its dumped trace, and a run resumed from a
   mid-run snapshot against the uninterrupted run, bit for bit.  (d) The
   nominal load at the paper fleet (rate 1.0, trigger auto, capacity 400,
   2,000 events, a 64-row probe a tick) after a warm-up run: updates/s,
   tick p50 / p99, serve p50, queue depth, model staleness, zero drops;
   three full-fleet ticks on the host clock and under ``torch.profiler``
   (launches, device busy share) and ``agg_absorb``'s share of a tick's
   host time.  (e) 4x the rate into a one-fleet queue, ``drop_oldest``
   (deadline:4.0) and ``backpressure`` (batch:2A): the accounting
   identities, drops and deferrals.  (f) Counted: a tick is one
   ``agg_absorb`` launch of #1, a round close one ``cloud_blend``, #3 once
   a step; ``fused=False`` #2 a tick and a close; ``cloud_every=3`` one
   ``cloud_blend`` every third tick.  (g) The perception MLP (N =
   9,540,010) at A=100, R=10, 5 ticks: tick wall, the ring kernel's device
   time against ``agg_absorb``'s byte bound, #3's share of the tick.
3h. The sharded rounds over ``torch.distributed`` (``fedsim/sharded``,
   the rsu-sharded tick of ``fedsim/async_engine``, ``core/topology``):
   the paper fleet (A=100, R=10) under the quickstart's recipe, 3 rounds
   from the MLP's initial weights, replicated and rsu_sharded, and the
   rsu-sharded tick at the main fleet in phase 3b's straggler regime, at 1
   rank over NCCL (in this process), 2 and 4 ranks over gloo (spawned,
   sharing the card), each through ``run_scenario``, counted (launches and
   collectives set to 0 just before, read just after), against the flat
   round or the async engine (``fused=False``) on the card: RSU rows and
   cloud within 1e-4 (#2's sums against #1's, the limit of phases 3 and
   3t), agent rows within 1e-3 (a flipped ReLU unit), masses within 1e-5
   relative, accuracy within 2e-3; no collective across pods in the rsu-sharded
   local-round loop, one a round in its cloud layer; ms a round (3 more
   rounds on the host clock) and collectives a round per axis, beside the
   flat round's wall, launches and device busy share.  Then the
   N-sharded cell of ``benchmarks/nshard_round.py`` (784-12000-10, N =
   9,540,010, A=8 over R=128) at model_shards 1 (1 rank) and 2 (2 ranks):
   persistent (R, N) + (N,) bytes a rank (2 shards at most 0.51 of 1),
   peak device memory a rank, ms a round, the clouds within 1e-5.  Last,
   #2 as ``block_local_agg`` at the rsu-sharded pod shape (A=50, R=5) and
   the N-sharded shape (A=8, R=128) against its plain version, with its
   bound and ``torch.matmul``'s time.
4. The serving path: qwen3-0.6b at full width in bf16 with params drawn on
   the card.  ``make_prefill_step`` at B=4, S=8192 (exactly 28
   flash_attention launches a call; ms, tokens/s, peak memory); the serve
   launcher at its defaults with ``--full-config`` (batch 8, prompt 32, gen
   32; decode tok/s, finite logits); decode against prefill logits at every
   position of 1x64 tokens (atol 0.15, rtol 0.05); a reduced qwen3 on the
   card against the host's plain versions with the same params (fp32:
   logits within 1e-3 and equal greedy tokens; bf16: atol 0.15, rtol
   0.05); one prefill with a 1024 window at S=4096; ``torch.profiler``
   over one prefill call and 8 decode steps (kernel launches a call,
   device busy share of the wall, top kernels by device time).
4b. xlstm-125m serving at full width in bf16 with params drawn on the
   card: ``make_prefill_step`` at B=4, S=8192 (exactly 3 slstm_scan and no
   flash_attention launches a call; ms, tokens/s, peak memory); the serve
   launcher with ``--arch xlstm-125m --full-config`` (batch 8, 32 + 32
   tokens; decode tok/s, finite logits); at every position of 1x64
   tokens, fp32 decode against the per-step and the chunkwise mLSTM
   prefill (atol 1e-3), and the bf16 per-step prefill with the scan kernel
   against the same with the plain scan (atol 0.15, rtol 0.05); the bf16
   gaps between decode and the prefills are printed; a reduced xlstm
   on the card against the host's plain versions (fp32: logits within 1e-3
   and equal greedy tokens; bf16: atol 0.15, rtol 0.05); ``torch.profiler``
   over one prefill call and 8 decode steps.
4c. deepseek-v2-lite-16b serving (MLA + MoE) at full width and depth in
   bf16 (16,210,311,168 params drawn on the card): ``make_prefill_step`` at
   B=4, S=8192 (exactly 27 ``flash_attention_mla`` launches a call and no
   other attention; ms, tokens/s, peak memory) and ``torch.profiler`` over
   one call; decode against prefill logits at every position of 1x64
   tokens with ``capacity_factor = n_experts`` (no drops; atol 0.15, rtol
   0.05); one decode step's profile at batch 8; the serve launcher
   ``--arch deepseek-v2-lite-16b --full-config`` (decode tok/s, finite
   logits) and kimi-k2-1t-a32b's full config refused; a reduced deepseek
   with MLA's full head dims (so #4's MLA variant runs) and a reduced
   kimi-k2 (GQA, D = 64) on the card against the host's plain versions
   (fp32 within 1e-3 and equal greedy tokens; bf16 atol 0.15, rtol 0.05).
4d. zamba2-2.7b serving (the ``zamba_super`` hybrid: one weight-shared
   attention + MLP block before each of 9 runs of 6 Mamba-2 blocks) at
   full width and depth in bf16 (2,422,670,240 params drawn on the card):
   (a) ``make_prefill_step`` at B=4, S=8192 (exactly 9
   ``flash_attention_d80`` launches a call and no other attention; ms,
   tokens/s, peak memory) and ``torch.profiler`` over one call (launches,
   busy share, top kernels, device time by kind); (b) fp32 decode against
   fp32 prefill logits at every position of 1x64 tokens (atol 1e-3, rtol
   0.05, ``tests/test_arch_smoke.py``'s fp32 tolerance), and the bf16 gap
   there; (c) one decode step's profile at batch 8; (d) the serve
   launcher ``--arch zamba2-2.7b --full-config`` (decode tok/s, finite
   logits); (e) a reduced zamba2 with head dim 80 (so #4 at 80 runs) on
   the card against the host's plain versions at S=37 (not a multiple of
   the reduced chunk 16): fp32 within 1e-3 and equal greedy tokens, bf16
   atol 0.15, rtol 0.05, and bf16 decode against prefill on the card at
   that tolerance.
4e. whisper-tiny serving (the ``encdec`` stack: self-attention,
   cross-attention to 1500 encoder frames, GELU MLP) at full width and
   depth in bf16 (41,958,528 params drawn on the card): (a)
   ``make_prefill_step`` at B=32 over the 448-token decoder context with
   memory (32, 1500, 384) (exactly 4 ``flash_attention`` (D = 64) and 4
   ``flash_attention_cross`` launches a call, both on the TMA + wgmma
   kernel, and no other attention; ms, tokens/s, peak memory) and
   ``torch.profiler`` over one call; (b) fp32 decode against fp32 prefill
   logits at every position of 2x32 tokens over the same memory (atol
   1e-3, rtol 0.05), and the bf16 gap; (c) a decode step at batch 8 (4
   ``flash_attention_cross`` launches of one query over 1500 frames, the
   split-key kernel; they are the kernels line's ``whisper_decode`` row)
   and its profile; (d) the serve launcher
   ``--arch whisper-tiny --full-config`` (the memory drawn from its seed;
   decode tok/s, finite logits, 4 cross launches a step); (e) the reduced
   whisper on the card against the host's plain versions (48 tokens over
   16 frames; fp32 within 1e-3 and equal greedy tokens, bf16 atol 0.15,
   rtol 0.05).
4f. phi-3-vision-4.2b serving (the VLM input merge: 576 patch embeddings
   projected and prepended to the tokens) at full width and depth in bf16
   (3,824,225,280 params drawn on the card): (a) ``make_prefill_step`` at
   B=4 with (4, 576, 1024) patch embeddings and 3,520 text tokens, 4,096
   positions a row (exactly 32 ``flash_attention_d96`` launches a call
   and no other attention; ms, tokens/s, peak memory) and
   ``torch.profiler`` over one call (busy share, top kernels, #4's share
   of device time); (b) text decode against text prefill logits at every
   position of 1x64 tokens, bf16 (atol 0.15, rtol 0.05); (c) the serve
   launcher's refusal of the VLM; (d) a reduced phi-3 at head dim 96 (so
   #4 at 96 runs), 16 patches before 48 tokens, on the card against the
   host's plain versions (fp32 within 1e-3 and equal greedy tokens, bf16
   atol 0.15, rtol 0.05).
4g. The dense model zoo in bf16 with params drawn on the card, each
   model's params freed before the next is drawn.  (a) yi-34b (60 layers,
   GQA 56 / 8 of 128, 34,388,917,248 params) and command-r-35b (40
   layers, GQA 64 / 8 of 128, 32,380,690,432) at full width with their
   depth cut to 12 and 8 layers (``DENSE_LAYERS``: at full depth this
   phase took 132-166 s, and the whole script 1,175 s on a slow card
   host, against the 1,200 s limit; the launcher below still runs them
   at full depth): ``make_prefill_step`` at B=4, S=8192 (exactly 12 / 8
   ``flash_attention`` launches a call and no other attention; ms median
   of 3, tokens/s, peak memory) and ``torch.profiler`` over one call
   (busy share, device time by kind); decode against prefill logits at
   every position of 1x64 tokens (atol 0.15, rtol 0.05); one decode
   step's profile at batch 8; the serve launcher ``--arch <id>
   --full-config`` (batch 8, 32 + 32 tokens;
   decode tok/s, finite logits) with its peak memory held to
   ``serve.peak_bytes``.  (b) nemotron-4-340b at full width (d_model
   18,432, 96 heads over 8 of 192, d_ff 73,728, squared-ReLU) with its
   depth cut to 2 of 96 layers (16,345,294,848 params): the prefill as in
   (a) with exactly 2 ``flash_attention_d192`` launches a call, decode
   against prefill; the launcher's ``--full-config`` refused before any
   allocation.  (c) A reduced yi at a GQA group of 7 (d_model 448, 7
   heads over 1, head dim 64) and a reduced nemotron at its head dim 192
   (d_model 384, 2 heads over 1) on the card against the host's plain
   versions (fp32 within 1e-3 and equal greedy tokens, bf16 atol 0.15,
   rtol 0.05).
4h. The reference's four shapes (``launch/steps.SHAPES``) on one card
   (``launch/dryrun``): (a) every (architecture x shape) cell's peak
   reckoned on the meta device, one line each, nothing allocated; (b)
   three cells run at full width through ``dryrun.run_cell``, each a
   decode step, its measured peak held to its reckoning: qwen3-0.6b
   ``long_500k`` (batch 1 over the live 8,192-slot ring at position
   524,287, no kernel launch), whisper-tiny ``decode_32k`` (batch 128 over
   32,768 positions and its 1,500 frames: exactly 4
   ``flash_attention_cross`` launches a step, all on the split-key
   kernel) and xlstm-125m ``decode_32k`` (no kernel launch); (c) #4 at
   that whisper step's cross-attention shape (B=128, one query over 1500
   frames, H=6, D=64, bf16) against its plain version, with its time,
   bound and SDPA's time; (d) the reduced qwen3 with ``long_500k``'s
   window on the card against the host's plain versions, 8 decode steps
   at positions 524,280-524,287 after the ring is filled from a seed
   (fp32 within 1e-3 and equal greedy tokens, bf16 atol 0.15, rtol 0.05).
5. The LLM training path (``launch/steps``, ``launch/h2fed_round``,
   ``launch/train``).  (a) The backward kernel of flash_attention
   (``csrc/flash_attention_bwd.cu``, given the forward's output and saved
   log-sum-exp) against autograd of the plain version at the qwen3-0.6b
   layer (B=1, S=4096, H=16, KV=8, D=128, causal), with a 1024 window, at
   D=64, at the layer of zamba2-2.7b's shared block and of phi-3-vision in
   (c)'s train step (B=2, S=4096, H=KV=32, D=80 and 96, causal), and at
   each of 80 and 96 GQA with a window and a ragged S: dQ, dK and dV
   within 2^-7 (max|want| + |want|); bound: the 5 products of the live
   pairs (the kernel's ``products_per_pair``) at 989 TFLOP/s or the
   bytes at 3.35 TB/s; ``library_ms`` SDPA's forward + backward less its
   forward (timed only); the model layers' rows also give the backward's
   launches a step.  (b) #3's bf16 mode against its plain version at
   the embedding leaf (151,936 x 1024) and a stacked MLP leaf (28 x 1024 x
   3072).  (c) ``make_train_step`` at full width and depth in bf16 for
   qwen3-0.6b, zamba2-2.7b and phi-3-vision-4.2b (576 drawn patch
   embeddings + 3,520 tokens a sequence), 3 steps each at A=2 agents x b=1
   x S=4096 positions: loss, ms a step, positions/s, peak memory,
   exactly 2 forward (each layer recomputed in the backward) and 1
   backward attention launch a layer (qwen3 56 + 28, zamba2 18 + 9 at head
   dim 80, phi-3 64 + 32 at 96), no other attention, and one step under
   ``torch.profiler`` (device busy share, top kernels, #4's backward's
   share, device time by kind).  (d) The launcher with
   ``--full-config``, 2 rounds of LAR 2, E 1, S=1024, b=2 an agent, at
   ``--mesh 1,1,1`` (1 rank, nccl), ``1,2,1`` (2 ranks sharing the
   card, gloo) and ``1,1,2`` (one agent's model split over 2 ranks
   sharing the card, gloo: tensor parallel, H/2 and KV/2 heads a rank):
   eval loss each round (finite and falling), ms a round, each round's
   launches and collectives (calls and bytes by axis, beside
   ``comm_model``'s bytes) and each rank's peak memory; at ``1,1,2`` the
   final cloud (gathered) within 5e-3 of the ``1,1,1`` run's and every
   round's ``tp``, ``round``, ``lar`` and ``cloud`` collectives equal to
   ``round_collectives``'s reckoning; then ``--arch zamba2-2.7b
   --full-config`` at ``--mesh 1,1,1`` (eval loss finite and falling, 36
   ``flash_attention_d80`` and 18 backward launches a round), and one
   ``make_h2fed_round`` round of phi-3-vision at full width and depth on
   one rank (LAR 2, E 1, 576 drawn patch embeddings + 448 tokens; the
   cloud finite and moved, 128 ``flash_attention_d96`` and 64 backward
   launches, peak memory).  (e) One round on the card against
   the host at the reduced qwen3 (D=64), the same params: per-leaf,
   ``flat_agg``, ``async_rounds=2`` with ``buffer_keep=0.5`` (1 rank),
   and in one spawn of 4 gloo ranks ``quantize_cloud`` at ``--mesh
   2,2,1`` and the per-leaf round at ``1,2,2`` (2 agents, each split over
   2 ranks); the new cloud within 5e-3 absolute and relative, the masses
   equal.  Then a reduced zamba2 and a reduced phi-3-vision at their full
   models' head dims (80, 96), bf16: one train step on the card against
   the host (loss within 0.15 + 0.05|loss|) and one round (masses
   equal), each leaf's update on the card as near the host's fp32 run
   from the same params as the host's bf16 update is (within 1.5x its
   2-norm gap + 1e-3).  Each part of phase 5 prints its wall time
   (``phase 5 part <name>: <s> s``).
6. The kernels' JSON line (each kernel's launches are those of the
   counted runs of the flat path, the async path, the sweep, the serve
   loop, the streamed rounds and the sharded rounds, also given by path;
   beside them the scenario-axis entries at the sweep shape with the
   sweep's launches, #2 at the streamed chunk shape with the streamed
   rounds' launches, #2 at the sharded pod shape with the sharded
   rounds' launches, and the training path's: #4 forward and backward at
   the layer shape and #3's bf16 mode, with phase 5's qwen3 steps' and
   rounds' launches, and #4's forward at head dims 80 and 96 at phase 2b's
   layer shape and its backward at the train step's layer shapes, with
   the launches of zamba2's and phi-3-vision's training runs (their
   steps, zamba2's launcher rounds, phi-3's round, the reduced models'
   card-vs-host runs); #4's MLA variant at the deepseek prefill shape
   with phase 4c's launches; #4 at head dim 80 at the zamba2 prefill shape with
   phase 4d's launches; #4 at head dim 96 at the phi-3-vision prefill
   shape with phase 4f's launches; #4 at the yi-34b and command-r-35b
   prefill shapes and at (192, 192) at the nemotron-4-340b prefill shape
   with phase 4g's launches; #4 with keys of their own length at
   whisper's prefill shape with phase 4e's cross-attention launches, and
   at whisper's ``decode_32k`` step with phase 4h's), the card's line,
   and the result line.

``python3 chip_smoke.py --attention`` runs phase 1 and phase 2b only (the
flash-attention kernel's build report, checks and times), ``--scan`` phase
1 and phase 2c only (the sLSTM scan kernel's), and ``--agg`` phase 1 and
phase 2 only (the aggregation and update kernels'), and ``--round`` phase
1 and the quickstart scenario's global round alone (wall, launches and
device busy share a round, from the MLP's initial weights), and
``--async`` phase 1 and phase 3b, ``--sweep`` phase 1 and phase 3s,
``--stream`` phase 1 and phase 3t, ``--serve`` phase 1 and phase 3v, and
``--sharded`` phase 1 and phase 3h, ``--train`` phase 1 and phase 5,
``--moe`` phase 1 and phase 4c, ``--hybrid`` phase 1 and phase 4d,
``--audio`` phase 1 and phase 4e, ``--vision`` phase 1 and phase 4f,
``--dense`` phase 1 and phase 4g, and ``--cells`` phase 1 and phase 4h;
none of them prints a result line.  ``--dryrun`` runs phase 1 and then
``launch/dryrun --all`` on the card: all 40 cells, one line each (fits,
the reckoned and the measured peak, ms, launches, roofline share; the
records under ``build/dryrun_torch``), failing if a cell fails or a
measured peak passes its reckoning.

Exits 1 without printing a result when no CUDA device is present, and
fails at import when run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM, dense bf16 tensor cores
SHAPES = (("main", 20, 4, 31_810), ("paper", 100, 10, 31_810),
          ("perception", 100, 10, 9_540_010))
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-5, 2.0 ** -7)}
SOURCES = {"fused_agg_blend": "src/repro_torch/kernels/csrc/fused_agg_blend.cu",
           "weighted_agg_matmul":
               "src/repro_torch/kernels/csrc/fused_agg_blend.cu",
           "dual_proximal_sgd":
               "src/repro_torch/kernels/csrc/dual_proximal_sgd.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_mla":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_d80":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_d96":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_d192":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_cross":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_bwd":
               "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "slstm_scan": "src/repro_torch/kernels/csrc/slstm_scan.cu"}
REPLACES = {"fused_agg_blend": "src/repro/kernels/masked_hier_agg.py:199",
            "weighted_agg_matmul": "src/repro/kernels/masked_hier_agg.py:86",
            "dual_proximal_sgd": "src/repro/kernels/dual_proximal_sgd.py:44",
            "flash_attention": "src/repro/kernels/flash_attention.py:93",
            # the same Pallas kernel, whose function MLA's prefill
            # computes with chunked_attention (src/repro/models/
            # attention.py:70) on v zero-padded to q's 192
            "flash_attention_mla": "src/repro/kernels/flash_attention.py:93",
            # the same Pallas kernel, whose function zamba2's shared
            # attention block computes with chunked_attention at head dim
            # 80 (d_model 2560 over 32 heads); in bf16 the port runs it on
            # the D = 128 kernel's TMA + wgmma design at 80 columns
            "flash_attention_d80": "src/repro/kernels/flash_attention.py:93",
            # the same Pallas kernel, whose function phi-3-vision's
            # attention computes with chunked_attention at head dim 96
            # (d_model 3072 over 32 heads), on the TMA + wgmma design
            "flash_attention_d96": "src/repro/kernels/flash_attention.py:93",
            # the same Pallas kernel, whose function nemotron-4-340b's
            # attention computes with chunked_attention at head dim 192
            # for q, k and v (d_model 18432 over 96 heads)
            "flash_attention_d192": "src/repro/kernels/flash_attention.py:93",
            # the same Pallas kernel's function with keys of their own
            # length: whisper's cross-attention, which the reference
            # computes with chunked_attention (src/repro/models/
            # attention.py:391, xattn_apply), as the Pallas kernel takes
            # one length only
            "flash_attention_cross":
                "src/repro/kernels/flash_attention.py:93",
            # no TPU kernel: the reference differentiates its jnp
            # chunked_attention (the training forward) with jax.grad
            "flash_attention_bwd": "src/repro/models/attention.py:70",
            "slstm_scan": "src/repro/kernels/slstm_scan.py:90"}
AUDIO_B, AUDIO_S = 32, 448     # whisper-tiny's prefill: its decoder context
# (name, B, S, H, KV, D, causal, window); "layer" is qwen3-0.6b's; the
# two ragged D = 128 cases end one row past a 128-row tile and mid-tile;
# "whisper_self" is whisper-tiny's decoder self-attention at its prefill
# shape and "d64_gqa" GQA 8/2 at D = 64 (both, and "small", on the TMA +
# wgmma kernel at (64, 64) in bf16, held also with the log-sum-exp)
ATTN_CASES = (("small", 2, 200, 4, 2, 64, True, 0),
              ("layer", 1, 4096, 16, 8, 128, True, 0),
              ("layer_w1024", 1, 4096, 16, 8, 128, True, 1024),
              ("s129", 2, 129, 16, 8, 128, True, 0),
              ("s1000", 1, 1000, 16, 8, 128, False, 0),
              ("whisper_self", AUDIO_B, AUDIO_S, 6, 6, 64, True, 0),
              ("d64_gqa", 2, 1000, 8, 2, 64, True, 0))
PREFILL_B, PREFILL_S = 4, 8192
# (name, B, S, H, KV, causal, window) at MLA's head dims (q/k 192 = 128 +
# 64 RoPE dims, v 128): deepseek-v2-lite's layer (H = KV = 16) and two
# ragged cases
MLA_DQK, MLA_DV = 192, 128
MLA_ATTN_CASES = (("mla_layer", 1, 4096, 16, 16, True, 0),
                  ("mla_layer_w1024", 1, 4096, 16, 16, True, 1024),
                  ("mla_s129", 1, 129, 16, 16, True, 0),
                  ("mla_s1000", 1, 1000, 16, 16, False, 0))
# (name, B, S, H, KV, causal, window) at the head dims of zamba2-2.7b (80)
# and phi-3-vision-4.2b (96), both with 32 heads: the layer (H = KV = 32),
# two ragged cases and GQA; each dim's prefill shape is HEAD_DIM_PREFILL's
HEAD_DIM_ATTN_CASES = (("layer", 1, 4096, 32, 32, True, 0),
                       ("layer_w1024", 1, 4096, 32, 32, True, 1024),
                       ("s129", 1, 129, 32, 32, True, 0),
                       ("s1000", 1, 1000, 32, 32, False, 0),
                       ("gqa", 2, 1000, 8, 2, True, 0))
# nemotron-4-340b's layer (96 heads over 8 of 192) and two ragged cases
D192_ATTN_CASES = (("layer", 1, 4096, 96, 8, True, 0),
                   ("layer_w1024", 1, 4096, 96, 8, True, 1024),
                   ("s129", 1, 129, 96, 8, True, 0),
                   ("s1000", 1, 1000, 96, 8, False, 0))
HEAD_DIM_CASES = {80: HEAD_DIM_ATTN_CASES, 96: HEAD_DIM_ATTN_CASES,
                  192: D192_ATTN_CASES}
VLM_B, VLM_PATCHES, VLM_TOKENS = 4, 576, 3520   # 4,096 positions a row
# (B, S, H, KV) of each head dim's prefill: zamba2's, phi-3-vision's 576
# patches + 3,520 tokens, and nemotron-4-340b's
HEAD_DIM_PREFILL = {80: (PREFILL_B, PREFILL_S, 32, 32),
                    96: (VLM_B, VLM_PATCHES + VLM_TOKENS, 32, 32),
                    192: (PREFILL_B, PREFILL_S, 96, 8)}
# (entry, H, KV) of #4 at D = 128 at the dense models' prefill shapes
# (B=4, S=8192): GQA groups of 7 and 8
DENSE_PREFILL_HEADS = (("yi_prefill", 56, 8), ("command_r_prefill", 64, 8))
# (name, B, S, T, H, KV, D): S queries over T keys, non-causal (whisper's
# cross-attention): whisper-tiny's prefill (B=32 over its 448-token
# decoder context, 1500 encoder frames, 6 heads of 64; the TMA + wgmma
# kernel at (64, 64) in bf16), a decode step at the launcher's batch 8
# and a ragged one over 257 keys with GQA (the split-key kernel), a
# ragged case, and T != S on the TMA + wgmma kernel at 128, 80, 96 and
# 192;
# the D = 64 cases are held also with the log-sum-exp
CROSS_ATTN_CASES = (("whisper_prefill", AUDIO_B, AUDIO_S, 1500, 6, 6, 64),
                    ("whisper_decode", 8, 1, 1500, 6, 6, 64),
                    ("decode_ragged", 2, 1, 257, 4, 2, 64),
                    ("cross_ragged", 2, 100, 257, 4, 2, 64),
                    ("cross_d128", 2, 300, 1000, 8, 4, 128),
                    ("cross_d80", 1, 200, 513, 4, 2, 80),
                    ("cross_d96", 1, 70, 130, 4, 4, 96),
                    ("cross_d192", 1, 300, 1000, 24, 2, 192))
# (name, B, S, H, P, input scale): the JAX kernel tests' shapes, saturated
# gates, and "layer", xlstm-125m's (d = 768)
SLSTM_CASES = (("test_1", 1, 17, 2, 32, 1.0), ("test_2", 2, 100, 4, 64, 1.0),
               ("test_3", 3, 256, 4, 32, 1.0), ("test_4", 1, 64, 8, 16, 1.0),
               ("saturated", 2, 48, 4, 32, 25.0),
               ("layer", PREFILL_B, PREFILL_S, 4, 192, 1.0))
SLSTM_TOL = {1.0: (2e-5, 1e-5), 25.0: (5e-5, 1e-4)}    # (atol, rtol)


# phases a run goes through; a mode flag runs the build and one kernel's
# phase alone, with no result line (which only the full run prints)
FULL_RUN = ("1", "2", "2b", "2c", "3", "3b", "3s", "3t", "3v", "3h", "4",
            "4b", "4c", "4d", "4e", "4f", "4g", "4h", "5", "6")
MODES = {"--attention": ("1", "2b"), "--scan": ("1", "2c"),
         "--agg": ("1", "2"), "--round": ("1", "3r"), "--async": ("1", "3b"),
         "--sweep": ("1", "3s"), "--stream": ("1", "3t"),
         "--serve": ("1", "3v"), "--sharded": ("1", "3h"),
         "--train": ("1", "5"), "--moe": ("1", "4c"),
         "--hybrid": ("1", "4d"), "--audio": ("1", "4e"),
         "--vision": ("1", "4f"), "--dense": ("1", "4g"),
         "--cells": ("1", "4h"), "--dryrun": ("1", "dryrun")}


def selected_phases(argv) -> tuple:
    """The phases that ``argv`` asks for: every phase, or one mode's."""
    unknown = [a for a in argv if a not in MODES]
    if unknown or len(argv) > 1:
        raise SystemExit(f"chip_smoke: usage: chip_smoke.py "
                         f"[{' | '.join(MODES)}], got {argv}")
    return MODES[argv[0]] if argv else FULL_RUN


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 11, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, bracketed by CUDA events, after a warm-up.  A call that takes
    over 100 ms is timed 3 times, one call each, its first call the
    warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    warm = 2
    if start.elapsed_time(end) > 100.0:
        reps, inner, warm = 3, 1, 0
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def cuda_ms_pair(fa, fb, reps: int = 12, inner: int = 10) -> tuple:
    """``cuda_ms`` of two calls measured in turns, a before b in even
    reps and b before a in odd ones, so that neither a drift of the card's
    clocks under a long run nor the place in a pair favours one: (median ms
    of a, median ms of b)."""
    for _ in range(2):
        fa()
        fb()
    torch.cuda.synchronize()
    times = ([], [])
    for rep in range(reps):
        order = ((fa, times[0]), (fb, times[1]))
        for fn, out in (order if rep % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / inner)
    return statistics.median(times[0]), statistics.median(times[1])


def host_device_split(fn, n_host: int = 1000, n_prof: int = 20) -> dict:
    """Where a call's time goes: ``device_ms``, its kernels' device time a
    call over ``n_prof`` calls under ``torch.profiler`` (a trace with no
    device record, which the profiler gives now and then, is taken again,
    up to 3 times; None when all 3 have none), and ``host_us``, the host
    time a call of ``n_host`` calls enqueued without a synchronise, then
    one synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_host):
        fn()
    host_us = (time.perf_counter() - t0) / n_host * 1e6
    torch.cuda.synchronize()
    for _ in range(3):
        busy = device_profile(fn, n_prof)[2]
        if busy:
            break
    return {"device_ms": busy / n_prof * 1e3 if busy else None,
            "host_us": host_us}


def host_us(fn, n: int = 1000) -> float:
    """Host time of one call of ``fn`` (no device work), mean of ``n``."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def bound(nbytes: float, flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def compare(got, want, dtype, what, tol=None):
    """Max |got - want|; raises unless |d| <= atol + rtol*|want| (``tol``
    (atol, rtol), else the dtype's)."""
    atol, rtol = tol or TOL[dtype]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    excess = ((g - w).abs() - (atol + rtol * w.abs())).max().item()
    err = (g - w).abs().max().item()
    if excess > 0:
        raise AssertionError(f"{what}: kernel disagrees with the plain "
                             f"version (max abs err {err:.3e})")
    return err


def kernel_cases(dev, shape_name, A, R, N, dtype):
    """Every kernel entry at one shape and fleet dtype; returns result
    rows.  Launches made here are comparisons, not the main path's."""
    from repro_torch.core.aggregation import (build_weight_matrix,
                                              cohort_mass)
    from repro_torch.kernels import dual_proximal_sgd as dps
    from repro_torch.kernels import masked_hier_agg as mha
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(A * 7 + R)
    sx = torch.finfo(dtype).bits // 8
    x = torch.randn(A, N, device=dev, generator=gen).to(dtype)
    prev = torch.randn(R, N, device=dev, generator=gen).to(dtype)
    w = torch.rand(A, device=dev, generator=gen) + 0.5
    assign = torch.arange(A, device=dev) % R
    mask = torch.rand(A, device=dev, generator=gen) < 0.6   # the engine's
    mask[assign == 0] = False                     # RSU 0 keeps its row
    W = build_weight_matrix(w, mask, assign, R)
    mass = cohort_mass(w, mask, assign, R)
    coef = torch.stack([torch.zeros_like(mass), torch.ones_like(mass),
                        (mass > 0).float()], dim=1)
    dead = int((mass <= 0).sum())
    rows, small = [], A * 16 + R * A * 4

    def row(kernel, entry, err, ms, plain_ms, nbytes, flops, library_ms,
            **split):
        b_ms, b_by = bound(nbytes, flops)
        rows.append({"kernel": kernel, "entry": entry, "shape": shape_name,
                     "A": A, "R": R, "N": N, "dtype": str(dtype)[6:],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms, **split})

    def split(kernel_fn, library_fn, ms):
        n = 1000 if ms < 1.0 else 100
        k = host_device_split(kernel_fn, n)
        out = {"device_ms": k["device_ms"], "host_us": k["host_us"]}
        if library_fn is not None:
            lib = host_device_split(library_fn, n)
            out.update(library_device_ms=lib["device_ms"],
                       library_host_us=lib["host_us"])
        return out

    # fused_agg_blend, RSU layer: the whole agg_blend entry (one launch
    # that builds W, mass and the guard on the device), the same kernel
    # with its operands ready (the coef form), the plain two-pass version,
    # and one matmul + where.  Bytes: X, out, and prev's zero-mass rows
    # (a row with mass reads no prev)
    got, got_mass = mha.agg_blend(x, w, mask, assign, R, prev)
    want, _ = ref.agg_blend_ref(x, w, mask, assign, R, prev)
    err = compare(got, want, dtype, f"agg_blend {shape_name} {dtype}")
    if not torch.equal(got[0], prev[0]):
        raise AssertionError("agg_blend: a zero-mass row was not kept")
    mass_err = ((got_mass - mass).abs() / mass.abs().clamp_min(1e-30)).max()
    if mass_err > 1e-6:
        raise AssertionError(f"agg_blend: mass off by {mass_err:.3e} "
                             f"relative")

    def whole():
        return mha.agg_blend(x, w, mask, assign, R, prev)

    def blend():
        return mha._fused_agg_blend(coef, (W,), (x,), prev, entry="agg_blend")

    def blend_library():
        return torch.where((mass > 0)[:, None], torch.matmul(W, x.float()),
                           prev.float())
    agg_bytes = A * N * sx + (R + dead) * N * sx + A * 9 + R * 4
    plain_ms = cuda_ms(lambda: ref.agg_blend_ref(x, w, mask, assign, R, prev))
    library_ms = cuda_ms(blend_library)
    ms = cuda_ms(whole)
    row("fused_agg_blend", "agg_blend", err, ms, plain_ms, agg_bytes,
        2 * R * A * N, library_ms, **split(whole, blend_library, ms))
    err = compare(blend(), want, dtype, f"agg_blend coef {shape_name}")
    ms = cuda_ms(blend)
    row("fused_agg_blend", "agg_blend_coef", err, ms, plain_ms,
        agg_bytes + small, 2 * R * A * N, library_ms,
        **split(blend, None, ms))

    # fused_agg_blend, cloud layer: R -> 1 into fp32, the whole cloud_blend
    # entry and the coef form
    cloud = torch.randn(N, device=dev, generator=gen)
    rmass = torch.rand(R, device=dev, generator=gen)
    got = mha.cloud_blend(prev, rmass, cloud)
    want = ref.cloud_blend_ref(prev, rmass, cloud)
    # the plain version rounds the new cloud through the fleet dtype, as
    # the reference's does; the kernel writes the fp32 sum
    err = compare(got, want, dtype, f"cloud_blend {shape_name}")
    kept = mha.cloud_blend(prev, torch.zeros_like(rmass), cloud)
    if not torch.equal(kept, cloud):
        raise AssertionError("cloud_blend: zero total mass must keep prev")
    wn = (rmass / rmass.sum())[None, :]
    ccoef = torch.tensor([[0.0, 1.0, 1.0]], device=dev)

    def cloud_whole():
        return mha.cloud_blend(prev, rmass, cloud)

    def cloud_coef():
        return mha._fused_agg_blend(ccoef, (wn,), (prev,), cloud[None, :],
                                    entry="cloud_blend")

    def cloud_library():
        return torch.where(rmass.sum() > 0, torch.matmul(wn, prev.float())[0],
                           cloud)
    cloud_bytes = R * N * sx + N * 4 + R * 4
    plain_ms = cuda_ms(lambda: ref.cloud_blend_ref(prev, rmass, cloud))
    library_ms = cuda_ms(cloud_library)
    ms = cuda_ms(cloud_whole)
    row("fused_agg_blend", "cloud_blend", err, ms, plain_ms, cloud_bytes,
        2 * R * N, library_ms, **split(cloud_whole, cloud_library, ms))
    err = compare(cloud_coef()[0], want, dtype,
                  f"cloud_blend coef {shape_name}")
    ms = cuda_ms(cloud_coef)
    row("fused_agg_blend", "cloud_blend_coef", err, ms, plain_ms,
        cloud_bytes + 12, 2 * R * N, library_ms,
        **split(cloud_coef, None, ms))

    # fused_agg_blend, two pairs (agg_absorb): two cohorts + retained buf
    x2 = x.flip(0).contiguous()
    arrivals = [(x, w * mask), (x2, w)]
    bm = torch.rand(R, device=dev, generator=gen)
    got3 = mha.agg_absorb(arrivals, assign, R, prev, bm, keep=0.5)
    want3 = ref.agg_absorb_ref(arrivals, assign, R, prev, bm, keep=0.5)
    err = compare(got3[0], want3[0], dtype, f"agg_absorb {shape_name}")
    row("fused_agg_blend", "agg_absorb", err,
        cuda_ms(lambda: mha.agg_absorb(arrivals, assign, R, prev, bm,
                                       keep=0.5)),
        cuda_ms(lambda: ref.agg_absorb_ref(arrivals, assign, R, prev, bm,
                                           keep=0.5)),
        2 * A * N * sx + 2 * R * N * sx + 2 * small, 4 * R * A * N, None)
    del x2, arrivals, got3, want3

    # weighted_agg_matmul: the fused=False path's (R, A) @ (A, N)
    got = mha.weighted_agg_matmul(W, x)
    want = ref.weighted_agg_matmul_ref(W, x)
    err = compare(got, want, dtype, f"weighted_agg_matmul {shape_name}")
    def matmul():
        return mha.weighted_agg_matmul(W, x)

    def matmul_library():
        return torch.matmul(W, x.float())
    ms = cuda_ms(matmul)
    row("weighted_agg_matmul", "weighted_agg_matmul", err, ms,
        cuda_ms(lambda: ref.weighted_agg_matmul_ref(W, x)),
        A * N * sx + R * N * sx + R * A * 4, 2 * R * A * N,
        cuda_ms(matmul_library), **split(matmul, matmul_library, ms))
    if shape_name == "main":
        # the host time of the wrapper's pieces: the output's allocation,
        # the stream lookup (a Stream object or the raw handle) and, where
        # the kernel has its own matmul entry, the ctypes call and launch
        # with every operand ready
        from repro_torch.kernels import _lib
        out = torch.empty((R, N), dtype=dtype, device=dev)
        stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
        pieces = {
            "torch.empty": lambda: torch.empty((R, N), dtype=dtype,
                                               device=dev),
            "new_empty": lambda: x.new_empty((R, N)),
            "current_stream": lambda: torch.cuda.current_stream(
                dev).cuda_stream,
            "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(
                dev.index or 0),
        }
        if "repro_weighted_agg_matmul" in _lib._SIGNATURES:
            args = (W.data_ptr(), x.data_ptr(), out.data_ptr(), R, A, N,
                    3 if dtype == torch.bfloat16 else 0, 1, stream)
            pieces["ctypes call and launch"] = (
                lambda: _lib.library().repro_weighted_agg_matmul(*args))
        print(f"host: {shape_name} {str(dtype)[6:]} launch-path pieces, us "
              f"a call: " + json.dumps({k: host_us(f)
                                        for k, f in pieces.items()}))
    del got, want, x, prev
    torch.cuda.empty_cache()

    # dual_proximal_sgd: fp32 w/g, anchors in the fleet dtype; the flat
    # engine's form (per-row live mask from active_steps and the step, the
    # broadcast cloud row, in place) and the TPU kernel's form (no scale,
    # full-shape anchors)
    wt = torch.randn(A, N, device=dev, generator=gen)
    g = torch.randn(A, N, device=dev, generator=gen) * 0.1
    a1 = torch.randn(A, N, device=dev, generator=gen).to(dtype)
    a2 = torch.randn(N, device=dev, generator=gen).to(dtype)
    active = torch.randint(0, 3, (A,), device=dev, generator=gen,
                           dtype=torch.int32)
    kw = dict(lr=0.1, mu1=0.01, mu2=0.005)
    got = dps.dual_proximal_sgd(wt, g, a1, a2, active_steps=active, step=1,
                                **kw)
    want = ref.dual_proximal_sgd_ref(wt, g, a1, a2, active_steps=active,
                                     step=1, **kw)
    err = compare(got, want, torch.float32, f"dual_proximal_sgd {shape_name}")
    if not torch.equal(got, dps.dual_proximal_sgd(
            wt, g, a1, a2, scale=(1 < active).float(), **kw)):
        raise AssertionError("dual_proximal_sgd: the active_steps form "
                             "differs from the scale form")
    del got, want

    def update():
        return dps.dual_proximal_sgd(wt, g, a1, a2, active_steps=active,
                                     step=1, out=wt, **kw)
    ms = cuda_ms(update)
    row("dual_proximal_sgd", "scaled_broadcast", err, ms,
        cuda_ms(lambda: ref.dual_proximal_sgd_ref(
            wt, g, a1, a2, active_steps=active, step=1, **kw)),
        A * N * (4 + 4 + sx + 4) + N * sx + A * 4, 8 * A * N, None,
        **split(update, None, ms))
    a2 = a2.expand(A, N).contiguous()
    got = dps.dual_proximal_sgd(wt, g, a1, a2, **kw)
    want = ref.dual_proximal_sgd_ref(wt, g, a1, a2, **kw)
    err = compare(got, want, torch.float32, f"dual_proximal_sgd full "
                  f"{shape_name}")
    del got, want
    row("dual_proximal_sgd", "tpu_form", err,
        cuda_ms(lambda: dps.dual_proximal_sgd(wt, g, a1, a2, out=wt, **kw)),
        cuda_ms(lambda: ref.dual_proximal_sgd_ref(wt, g, a1, a2, **kw)),
        A * N * (4 + 4 + 2 * sx + 4), 8 * A * N, None)
    del wt, g, a1, a2
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows


def quickstart_spec():
    from repro_torch.core.baselines import h2fed
    from repro_torch.core.heterogeneity import HeterogeneityModel
    from repro_torch.core.scenario import ScenarioSpec
    hp = h2fed(mu1=0.001, mu2=0.005, lar=4, lr=0.1)
    return ScenarioSpec(
        n_agents=20, n_rsus=4, batch=32, n_train=6_000, n_test=1_000,
        excluded_labels=(7, 8, 9), pretrain_frac=0.25, pretrain_target=0.62,
        partition="scenario_two", hp=hp,
        het=HeterogeneityModel(csr=0.3, scd=1, lar=hp.lar), rounds=10)


def timed_run(res, params, **kw):
    """run_scenario on the card with the launch counts set to 0 just
    before and read just after: (history, counts, seconds)."""
    from repro_torch.fedsim import run_scenario
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    final, hist = run_scenario(res, params, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    if hasattr(final, "cloud_params"):
        tensors = list(final.cloud_params.values())
    elif hasattr(final, "store"):   # a streamed round's buffers and stores
        tensors = [final.cloud_flat, final.rsu_flat, final.store.snapshot()]
        if hasattr(final, "pending_store"):
            tensors.append(final.pending_store.snapshot())
    else:     # the async engine's buffers, in-flight ones included
        tensors = [final.cloud_flat, final.rsu_flat, final.agent_flat,
                   final.pending_x, final.rsu_mass, final.cloud_macc]
    for p in tensors:
        if not torch.isfinite(p.float()).all():
            raise AssertionError("non-finite model or buffer")
    if not all(0.0 <= a <= 1.0 for a in hist["acc"]):
        raise AssertionError(f"bad accuracy history {hist['acc']}")
    return final, hist, counts, seconds


def pretrained(dev, spec, what: str):
    """The biased OEM model of ``spec``'s recipe on the card: (resolved
    scenario, params, accuracy)."""
    from repro_torch.configs.mnist_mlp import CONFIG
    from repro_torch.fedsim import pretrain_to_target
    from repro_torch.models import mlp
    res = spec.resolve()
    params = mlp.init_params(CONFIG, torch.Generator().manual_seed(spec.seed),
                             device=dev)
    t0 = time.perf_counter()
    pre, pre_acc = pretrain_to_target(params, res.pretrain_pool, res.test.x,
                                      res.test.y,
                                      target_acc=spec.pretrain_target,
                                      max_epochs=10)
    print(f"{what}: pre-trained (biased) accuracy {pre_acc:.4f} "
          f"({time.perf_counter() - t0:.2f} s)")
    return res, pre, pre_acc


def main_path(dev):
    """Phase 3; returns the launch counts of each path's run."""
    from repro_torch.fedsim.simulator import round_draws
    from repro_torch.core.heterogeneity import init_conn_state

    spec = quickstart_spec()
    res, pre, pre_acc = pretrained(dev, spec, "main path")
    _, hist, counts, seconds = timed_run(res, pre)
    for r, a in zip(hist["round"], hist["acc"]):
        print(f"main path: global round {int(r):2d}: test acc {a:.4f}")
    n_steps = spec.hp.local_epochs * (res.fed.x.shape[1] // spec.batch)
    rounds, lar = spec.rounds, spec.hp.lar
    print(f"main path: {seconds / rounds * 1e3:.2f} ms per round "
          f"(wall, set-up and eval included); launches {counts} "
          f"(expect agg_blend {rounds * lar}, cloud_blend {rounds}, "
          f"dual_proximal_sgd {rounds * lar * n_steps})")
    want = {"agg_blend": rounds * lar, "cloud_blend": rounds,
            "dual_proximal_sgd": rounds * lar * n_steps}
    for k, v in want.items():
        if counts[k] != v:
            raise AssertionError(f"{k}: {counts[k]} launches, want {v}")
    paths = {"main": counts}

    # one 10-round realization at CSR 0.3 swings by +-0.1 from round to
    # round, so the gain is judged on the mean final accuracy of five
    # realizations (sim_seed 0-4, the first being the run above)
    finals = [float(hist["acc"][-1])]
    for sim_seed in range(1, 5):
        _, h, _, _ = timed_run(spec.replace(sim_seed=sim_seed).resolve(), pre)
        finals.append(float(h["acc"][-1]))
    mean_final = statistics.mean(finals)
    print(f"main path: final accuracy of sim_seed 0-4: {finals}, mean "
          f"{mean_final:.4f} vs pre-trained {pre_acc:.4f}")
    if mean_final < pre_acc + 0.05:
        raise AssertionError(f"mean final accuracy {mean_final:.4f} does not "
                             f"beat the pre-trained {pre_acc:.4f} by 0.05")

    res_bf16 = spec.replace(fleet_dtype="bfloat16", rounds=2).resolve()
    _, hist, c, seconds = timed_run(res_bf16, pre)
    print(f"bf16 fleet: acc {hist['acc'].tolist()} in {seconds:.2f} s, "
          f"launches {c}")
    if not (c["agg_blend"] and c["cloud_blend"] and c["dual_proximal_sgd"]):
        raise AssertionError(f"bf16 path missed a kernel: {c}")
    paths["bf16"] = c

    res_unfused = spec.replace(fused=False, rounds=1).resolve()
    _, hist, c, seconds = timed_run(res_unfused, pre)
    print(f"fused=False: acc {hist['acc'].tolist()} in {seconds:.2f} s, "
          f"launches {c}")
    if c["weighted_agg_matmul"] != lar + 1 or c["agg_blend"]:
        raise AssertionError(f"fused=False path launches: {c}")
    paths["unfused"] = c

    # the card against the host's plain versions, same injected draws
    res2 = spec.replace(rounds=2).resolve()
    spe = res2.fed.x.shape[1] // spec.batch
    gen, conn, draws = torch.Generator().manual_seed(5), init_conn_state(
        spec.n_agents), []
    for _ in range(2):
        rd = []
        for _ in range(lar):
            conn, mask, act = round_draws(gen, conn, spec.het, spec.hp,
                                          spec.n_agents, spe)
            rd.append((mask, act))
        draws.append(rd)
    fin_gpu, h_gpu, _, _ = timed_run(res2, pre, draws=draws)
    from repro_torch.fedsim import run_scenario
    fin_cpu, h_cpu = run_scenario(res2, {k: v.cpu() for k, v in pre.items()},
                                  device="cpu", draws=draws)
    err = max((fin_gpu.cloud_params[k].cpu() - fin_cpu.cloud_params[k])
              .abs().max().item() for k in fin_cpu.cloud_params)
    acc_err = float(abs(h_gpu["acc"] - h_cpu["acc"]).max())
    print(f"card vs host (plain versions), 2 rounds, same draws: cloud max "
          f"abs err {err:.3e} (limit 1e-4), accuracy diff {acc_err:.4f} "
          f"(limit 2e-3)")
    if err > 1e-4 or acc_err > 2e-3:
        raise AssertionError("the card's round disagrees with the host's")
    entry_launches(dev, res, round_profile(dev, res, pre))
    return paths


def round_profile(dev, res, params, n: int = 3,
                  what: str = "flat round (main path)"):
    """``n`` global rounds of the flat engine on ``res``'s scenario: wall a
    round on the host clock (synchronised, no profiler), then the same
    rounds under ``torch.profiler`` (launches and device busy share a
    round).  Returns the state after them."""
    from repro_torch.core.flatten import spec_of
    from repro_torch.fedsim.simulator import (_make_flat_round_body,
                                              init_flat_state)
    s = res.spec
    fspec = spec_of(params, storage_dtype=s.fleet_dtype)
    round_fn = _make_flat_round_body(res.cfg, s.hp, s.het, res.fed, fspec,
                                     device=dev, fused=s.fused)
    state = [round_fn(init_flat_state(res.cfg, fspec, params, dev))]

    def one_round():
        state[0] = round_fn(state[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        one_round()
    torch.cuda.synchronize()
    print(f"round: {(time.perf_counter() - t0) / n * 1e3:.2f} ms a global "
          f"round (host clock, synchronised, {n} rounds, eval excluded)")
    print_profile(what, n, *device_profile(one_round, n))
    return state[0]


def flat_round(dev) -> None:
    """``--round``: the quickstart scenario's global round alone, from
    the MLP's initial weights (no pre-training)."""
    from repro_torch.configs.mnist_mlp import CONFIG
    from repro_torch.models import mlp
    spec = quickstart_spec()
    params = mlp.init_params(CONFIG, torch.Generator().manual_seed(spec.seed),
                             device=dev)
    round_profile(dev, spec.resolve(), params, n=10)


def entry_launches(dev, res, st) -> None:
    """One launch a call: 20 calls each of ``agg_blend``, ``cloud_blend``
    and ``dual_proximal_sgd`` on the round's own buffers under
    ``torch.profiler``."""
    from repro_torch.kernels import ops
    s = res.spec
    A, R = res.cfg.n_agents, res.cfg.n_rsus
    assign = torch.from_numpy(res.fed.rsu_assign).to(dev, torch.long)
    weights = torch.from_numpy(np.asarray(res.fed.n_per_agent,
                                          np.float32)).to(dev)
    mask = torch.arange(A, device=dev) % 3 != 0
    active = torch.full((A,), 2, dtype=torch.int32, device=dev)
    rsu_mass = torch.rand(R, device=dev)
    w = st.agent_flat.float().clone()
    g = torch.randn_like(w)
    hp = s.hp
    # (entry, its kernel's symbol, the call)
    calls = (
        ("agg_blend", "agg_blend_ring_kernel",
         lambda: ops.agg_blend(st.agent_flat, weights, mask, assign, R,
                               st.rsu_flat)),
        ("cloud_blend", "agg_blend_ring_kernel",
         lambda: ops.cloud_blend(st.rsu_flat, rsu_mass, st.cloud_flat)),
        ("dual_proximal_sgd", "dual_proximal_sgd_kernel",
         lambda: ops.dual_proximal_sgd(
             w, g, st.agent_flat, st.cloud_flat, lr=hp.lr, mu1=hp.mu1,
             mu2=hp.mu2, active_steps=active, step=1, out=w)))
    n = 20
    for name, symbol, fn in calls:
        fn()
        before = ops.launch_counts()[name]
        _, launches, _, _, runs = device_profile(fn, n)
        counted = ops.launch_counts()[name] - before
        print(f"profile: {n} {name} calls: {counted} wrapper launches, "
              f"{launches} host-API launches, device activity {runs}")
        # one launch a call: the wrapper launched its kernel once a call,
        # the host API saw no other launch, and whatever device activity
        # the profiler recorded is that kernel (it does not always record
        # the device side of a kernel launched from the ctypes library)
        if (counted != n or launches != n
                or any(symbol not in k for k in runs)):
            raise AssertionError(f"{name}: want one launch of {symbol} a "
                                 f"call and no other device work")


ASYNC_ROUNDS = 30


def straggler_specs():
    """Phase 3b's scenarios: the quickstart fleet in the 90%-disconnect
    regime of ``benchmarks/async_round.py`` (its defaults: max_delay 2,
    delay_p 0.6, staleness decay 0.5, buffer keep 0.5).  Async connects at
    CSR 0.25, so CSR x P(d = 0) = 0.1 arrive on time, as the flat engine's
    CSR 0.1; 30 rounds (after 10 the plain route's async mean is still
    below the pre-trained model, after 30 it is above it, PERF.md)."""
    import dataclasses
    from repro_torch.core.heterogeneity import HeterogeneityModel
    spec = quickstart_spec().replace(rounds=ASYNC_ROUNDS)
    lar = spec.hp.lar
    het = HeterogeneityModel(csr=0.25, scd=1, lar=lar, max_delay=2,
                             delay_p=0.6)
    flat = spec.replace(het=dataclasses.replace(spec.het, csr=0.1))
    return spec.replace(engine="async", het=het, staleness_decay=0.5,
                        buffer_keep=0.5, cloud_every=0), flat


def fault_plan():
    """Every fault kind on 2 rounds of 4 ticks: churn, an outage of RSU 1
    over ticks 2-4 that recovers on tick 5, NaN poison, byzantine scale
    caught by the norm clip, and stale replay."""
    from repro_torch.core.faults import (ChurnWindow, CorruptSpec, FaultPlan,
                                         RsuOutage)
    return FaultPlan(
        churn=(ChurnWindow(frac=0.25, start=1, stop=6, seed=1),),
        outages=(RsuOutage(rsu=1, start=2, stop=5),),
        corrupt=(CorruptSpec(kind="nan", frac=0.2),
                 CorruptSpec(kind="scale", frac=0.2, scale=1e4, seed=2),
                 CorruptSpec(kind="stale", frac=0.2, seed=3)),
        norm_clip=50.0, seed=4)


def card_draws(dev, spec, res, n_rounds):
    """The card's own per-tick draws for ``n_rounds`` rounds of ``spec``
    (a CUDA generator): draws[round][tick] = (mask, active_steps,
    delays) on the card."""
    from repro_torch.core.heterogeneity import init_conn_state, sample_latency
    from repro_torch.fedsim.simulator import round_draws
    A = spec.n_agents
    spe = max(res.fed.x.shape[1] // spec.batch, 1)     # the engines' spe
    gen = torch.Generator(device=dev).manual_seed(5)
    conn, out = init_conn_state(A, dev), []
    for _ in range(n_rounds):
        rd = []
        for _ in range(spec.hp.lar):
            conn, mask, act = round_draws(gen, conn, spec.het, spec.hp, A, spe)
            rd.append((mask, act, sample_latency(gen, A, spec.het, dev)))
        out.append(rd)
    return out


def _state_diff(card, host, fields, what):
    """Max |card - host| over ``fields``; raises past (atol, rtol), or on
    any difference for an exact field (atol None)."""
    errs = {}
    for name, (atol, rtol) in fields.items():
        g = getattr(card, name).cpu().float()
        w = getattr(host, name).float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite {name} on the card")
        errs[name] = (g - w).abs().max().item()
        if atol is None:
            if not torch.equal(g, w):
                raise AssertionError(f"{what}: {name} differs ({errs[name]})")
        elif ((g - w).abs() > atol + rtol * w.abs()).any():
            raise AssertionError(f"{what}: {name} off by {errs[name]:.3e} "
                                 f"(atol {atol}, rtol {rtol})")
    return errs


def _to_host(state):
    """An async state's tensors moved to the host (for the next tick)."""
    from repro_torch.core.heterogeneity import ConnState
    return state._replace(
        conn=ConnState(state.conn.remaining.cpu()),
        gen=torch.Generator().manual_seed(0),
        **{k: getattr(state, k).cpu() for k in (
            "agent_flat", "rsu_flat", "rsu_mass", "cloud_flat", "pending_x",
            "pending_w", "pending_t", "cloud_macc")})


def async_card_vs_host(dev, spec, pre, what, faults=None):
    """2 rounds of ``spec`` on the card against the same rounds on the
    host (plain versions), the card's own draws replayed on both, every
    buffer compared after every round.  fp32: the two rounds run on,
    buffers within 1e-5.  bf16: rounds of one tick, each from the card's
    state (a one-ulp difference of a stored row may flip a hidden ReLU
    unit of an agent that trains from it), buffers within one bf16 ulp.
    In-flight weights and tick counts exactly equal; with ``faults`` also
    the quarantine counts and blocked masses.  Returns the card's launch
    counts."""
    import dataclasses
    from repro_torch.core import faults as faults_mod
    from repro_torch.core.flatten import spec_of
    from repro_torch.fedsim import async_engine as ae
    from repro_torch.kernels import ops
    bf16 = spec.fleet_dtype == "bfloat16"
    lar = 1 if bf16 else spec.hp.lar
    s = spec.replace(hp=dataclasses.replace(spec.hp, lar=lar),
                     het=dataclasses.replace(spec.het, lar=lar),
                     rounds=2 * spec.hp.lar // lar, faults=faults)
    res = s.resolve()
    acfg = ae.AsyncConfig(staleness_decay=s.staleness_decay,
                          schedule=s.schedule, buffer_keep=s.buffer_keep,
                          cloud_every=s.cloud_every).validate()
    fspec = spec_of(pre, storage_dtype=s.fleet_dtype)
    host_pre = {k: v.cpu() for k, v in pre.items()}
    body = {d: ae.make_async_global_round(
        res.cfg, s.hp, s.het, res.fed, fspec, acfg, device=d, fused=s.fused,
        faults=faults) for d in (dev, "cpu")}
    card = ae.init_async_state(res.cfg, fspec, pre, dev)
    host = ae.init_async_state(res.cfg, fspec, host_pre, "cpu")
    draws = card_draws(dev, s, res, s.rounds)
    sched = None if faults is None else faults.lower(
        s.n_agents, s.n_rsus, s.rounds * lar)
    fields = {k: ((2 ** -9, 2 ** -7) if bf16 else (1e-5, 1e-5)) for k in (
        "agent_flat", "rsu_flat", "pending_x", "cloud_flat")}
    fields.update(rsu_mass=(0.0, 1e-5), cloud_macc=(0.0, 1e-5),
                  pending_w=(None, None), pending_t=(None, None))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    q, blocked, errs = [], [], {}
    for r in range(s.rounds):
        if bf16 and r:
            host = _to_host(card)
        fr = [None, None] if sched is None else [
            faults_mod.round_tensors(sched, r, lar, d) for d in (dev, "cpu")]
        card, cm = body[dev](card, draws[r], fr[0])
        host, hm = body["cpu"](host, [tuple(t.cpu() for t in tick)
                                      for tick in draws[r]], fr[1])
        for k in cm:
            g, w = cm[k].cpu(), hm[k]
            if k == "quarantined" or k == "blocked_mass":
                if not torch.equal(g, w):
                    raise AssertionError(f"{what}: {k} {g} vs {w}")
            elif not torch.allclose(g.float(), w.float(), rtol=1e-5, atol=0):
                raise AssertionError(f"{what}: metric {k} {g} vs {w}")
        if faults is not None:
            q.append(int(cm["quarantined"].sum()))
            blocked.append(float(cm["blocked_mass"].sum()))
        for k, v in _state_diff(card, host, fields,
                                f"{what}, round {r + 1}").items():
            errs[k] = max(errs.get(k, 0.0), v)
        if card.tick != host.tick:
            raise AssertionError(f"{what}: tick {card.tick} vs {host.tick}")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    extra = "" if faults is None else (f"; quarantined a round {q}, blocked "
                                       f"mass {blocked} (card == host)")
    print(f"async card vs host ({what}): max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"{extra}; launches {counts}")
    return counts


def async_round_profile(dev, spec, params, what, n: int = 3):
    """``n`` async rounds of ``spec``: wall a round on the host clock,
    then under ``torch.profiler`` (launches, device busy share)."""
    from repro_torch.core.flatten import spec_of
    from repro_torch.fedsim import async_engine as ae
    res = spec.resolve()
    acfg = ae.AsyncConfig(staleness_decay=spec.staleness_decay,
                          buffer_keep=spec.buffer_keep,
                          cloud_every=spec.cloud_every).validate()
    fspec = spec_of(params, storage_dtype=spec.fleet_dtype)
    round_fn = ae.make_async_global_round(res.cfg, spec.hp, spec.het,
                                          res.fed, fspec, acfg, device=dev,
                                          fused=spec.fused)
    state = [round_fn(ae.init_async_state(res.cfg, fspec, params, dev))[0]]

    def one_round():
        state[0] = round_fn(state[0])[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        one_round()
    torch.cuda.synchronize()
    print(f"round: {what}: {(time.perf_counter() - t0) / n * 1e3:.2f} ms a "
          f"global round (host clock, synchronised, {n} rounds, eval "
          f"excluded)")
    print_profile(what, n, *device_profile(one_round, n))
    return state[0]


def absorb_launches(dev, st) -> None:
    """One launch of kernel #1 an ``agg_absorb`` call: 20 calls on an
    async round's own buffers under ``torch.profiler``; also what the
    weight building in small PyTorch ops around it costs a call."""
    from repro_torch.kernels import ops
    A, R = st.agent_flat.shape[0], st.rsu_flat.shape[0]
    assign = torch.arange(A, device=dev) % R
    w_imm = torch.rand(A, device=dev) * (torch.arange(A, device=dev) % 2)
    w_due = torch.rand(A, device=dev) * (torch.arange(A, device=dev) % 3 == 0)

    def call():
        return ops.agg_absorb(((st.agent_flat, w_imm), (st.pending_x, w_due)),
                              assign, R, st.rsu_flat, st.rsu_mass, keep=0.5)
    n = 20
    call()
    # The profiler now and then loses device records, a few calls' worth
    # of every kernel alike (tools/profiler_drops.py), and after the
    # earlier phases it misses a few of PyTorch's own in every trace, so
    # no trace is known complete.  A loss only lowers a count: more ring
    # executions than wrapper launches, or a wrapper count other than n,
    # fails at once; fewer, and the trace is taken again, up to 3 times.
    for attempt in range(1, 4):
        before = ops.launch_counts()["agg_absorb"]
        _, launches, busy, kernels, runs = device_profile(call, n)
        counted = ops.launch_counts()["agg_absorb"] - before
        ring = {k: v for k, v in runs.items()
                if "agg_blend_ring_kernel" in k}
        if counted != n or sum(ring.values()) >= n:
            break
        executed = sum(v for k, v in runs.items()
                       if not k.startswith(("Memcpy", "Memset")))
        print(f"profile: agg_absorb trace {attempt}: "
              f"{sum(ring.values())} ring executions for {n} wrapper "
              f"launches, {executed} kernel executions for {launches} "
              f"host-API launches")
    ring_s = sum(v for k, v in kernels.items() if "agg_blend_ring_kernel" in k)
    split = host_device_split(call, 1000)
    print(f"profile: {n} agg_absorb calls (A={A}, R={R}): {counted} wrapper "
          f"launches, ring kernel executions {sum(ring.values())}, "
          f"{launches / n:.0f} host-API launches a call (the weights, masses "
          f"and coef built in small PyTorch ops), device time a call: ring "
          f"{ring_s / n * 1e6:.2f} us, other {(busy - ring_s) / n * 1e6:.2f} "
          f"us; host time a call {split['host_us']:.1f} us")
    if counted != n or sum(ring.values()) != n:
        raise AssertionError(f"agg_absorb: want one launch of the ring kernel "
                             f"a call, got {counted} wrapper launches and "
                             f"{sum(ring.values())} ring executions in {n} "
                             f"calls")


def async_path(dev):
    """Phase 3b; returns the launch counts of the fused and the
    ``fused=False`` async runs."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.fedsim import run_scenario
    a_spec, f_spec = straggler_specs()
    res, pre, pre_acc = pretrained(dev, a_spec, "async path")
    _, hist, counts, seconds = timed_run(res, pre)
    rounds, lar = a_spec.rounds, a_spec.hp.lar
    n_steps = a_spec.hp.local_epochs * (res.fed.x.shape[1] // a_spec.batch)
    want = {"agg_absorb": rounds * lar, "cloud_blend": rounds,
            "dual_proximal_sgd": rounds * lar * n_steps, "agg_blend": 0,
            "weighted_agg_matmul": 0, "scatter_accumulate": 0}
    print(f"async path: {seconds / rounds * 1e3:.2f} ms per round (wall, "
          f"set-up and eval included); launches {counts} (expect {want}); "
          f"absorbed mass a round {hist['absorbed_mass'].tolist()}, pending "
          f"{hist['pending_mass'].tolist()}")
    for k, v in want.items():
        if counts[k] != v:
            raise AssertionError(f"async {k}: {counts[k]} launches, want {v}")
    paths = {"main": counts}
    finals = {"async": [float(hist["acc"][-1])], "flat": []}
    for sim_seed in range(5):
        if sim_seed:
            _, h, _, _ = timed_run(a_spec.replace(sim_seed=sim_seed).resolve(),
                                   pre)
            finals["async"].append(float(h["acc"][-1]))
        _, h, _, _ = timed_run(f_spec.replace(sim_seed=sim_seed).resolve(), pre)
        finals["flat"].append(float(h["acc"][-1]))
    means = {k: statistics.mean(v) for k, v in finals.items()}
    print(f"async path: 90% disconnected, {rounds} rounds, final accuracy of "
          f"sim_seed 0-4: async {finals['async']} mean {means['async']:.4f}; "
          f"flat at CSR 0.1 {finals['flat']} mean {means['flat']:.4f}; "
          f"pre-trained {pre_acc:.4f}")
    if means["async"] < pre_acc:
        raise AssertionError(f"async mean final accuracy {means['async']:.4f}"
                             f" below the pre-trained {pre_acc:.4f}")

    # the card against the host, the card's draws replayed on both
    async_card_vs_host(dev, a_spec, pre, "fp32")
    async_card_vs_host(dev, a_spec.replace(fleet_dtype="bfloat16"), pre,
                       "bf16, one tick a round")
    c = async_card_vs_host(dev, a_spec.replace(fused=False), pre,
                           "fused=False")
    want = {"agg_absorb": 0, "cloud_blend": 0,
            "scatter_accumulate": 4 * lar, "weighted_agg_matmul": 2}
    if any(c[k] != v for k, v in want.items()):
        raise AssertionError(f"fused=False async launches {c}, want {want}")
    paths["unfused"] = c
    c = async_card_vs_host(dev, a_spec.replace(cloud_every=3), pre,
                           "cloud_every=3")
    if c["cloud_blend"] != 2 * lar // 3:
        raise AssertionError(f"cloud_every=3: {c['cloud_blend']} cloud "
                             f"launches, want {2 * lar // 3}")

    # faults: an empty plan is faults=None bit for bit on both engines;
    # under every fault kind the card agrees with the host
    for engine, spec in (("flat", quickstart_spec()), ("async", a_spec)):
        spec = spec.replace(rounds=2)
        runs = [run_scenario(spec.replace(faults=f).resolve(), pre)
                for f in (None, FaultPlan())]
        if engine == "flat":
            pairs = [(runs[0][0].cloud_params[k], runs[1][0].cloud_params[k])
                     for k in runs[0][0].cloud_params]
        else:
            pairs = [(getattr(runs[0][0], k), getattr(runs[1][0], k))
                     for k in ("agent_flat", "rsu_flat", "cloud_flat",
                               "pending_x", "pending_w", "rsu_mass")]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{engine}: an empty plan differs from "
                                 f"faults=None")
        print(f"faults: {engine}, empty plan == faults=None bit for bit on "
              f"the card")
    async_card_vs_host(dev, a_spec, pre, "every fault kind",
                       faults=fault_plan())
    flat_faults_card_vs_host(dev, pre)

    # launches, device busy share and wall a round, async beside flat, at
    # the main (A=20, R=4) and paper (A=100, R=10) fleets
    for fleet, A, R in (("main", 20, 4), ("paper", 100, 10)):
        a = a_spec.replace(n_agents=A, n_rsus=R)
        round_profile(dev, f_spec.replace(n_agents=A, n_rsus=R).resolve(),
                      pre, what=f"flat round ({fleet} fleet, A={A}, R={R})")
        st = async_round_profile(dev, a, pre, f"async round ({fleet} fleet, "
                                 f"A={A}, R={R})")
        absorb_launches(dev, st)
    return paths


def flat_faults_card_vs_host(dev, pre) -> None:
    """2 flat rounds under every fault kind, card against host, the same
    draws: quarantine counts equal, buffers within 1e-5, cloud finite."""
    from repro_torch.fedsim import run_scenario
    spec = quickstart_spec().replace(rounds=2, faults=fault_plan())
    res = spec.resolve()
    draws = [[(m, a) for m, a, _ in rd]
             for rd in card_draws(dev, spec, res, 2)]
    fin, h = run_scenario(res, pre, draws=draws)
    host, hh = run_scenario(res, {k: v.cpu() for k, v in pre.items()},
                            device="cpu", draws=[[tuple(t.cpu() for t in x)
                                                  for x in rd]
                                                 for rd in draws])
    err = max((fin.cloud_params[k].cpu() - host.cloud_params[k]).abs().max()
              .item() for k in host.cloud_params)
    finite = all(torch.isfinite(v).all() for v in fin.cloud_params.values())
    print(f"faults: flat, every fault kind, card vs host: quarantined "
          f"{h['quarantined'].tolist()} vs {hh['quarantined'].tolist()}, "
          f"cloud max abs err {err:.3e} (limit 1e-5), finite {finite}")
    if (h["quarantined"].tolist() != hh["quarantined"].tolist() or err > 1e-5
            or not finite or not h["quarantined"].sum()):
        raise AssertionError("flat round under faults: card and host "
                             "disagree")


# -- phase 3s: the multi-scenario sweep -----------------------------------

# Fig. 2's grid (benchmarks/fig2_mu1_csr.py): CSR x mu2 x mu1 x 3 seeds
FIG2_CSRS, FIG2_MU2S = (1.0, 0.5, 0.2), (0.0, 0.001)
FIG2_MU1S, FIG2_SEEDS = (0.0, 0.001, 0.004, 0.007), 3
SWEEP_S = 16        # the benchmarks' max_sweep
SWEEP_SHAPE = (SWEEP_S, 100, 10, 31_810)


def fig2_spec(csr, mu2, mu1, sim_seed=0, rounds=1, lar=5, **kw):
    """One cell of Fig. 2's grid at full bench scale (``base_spec`` of
    benchmarks/common.py with REPRO_BENCH_FULL=1: A=100, R=10, n_train
    22,000, n_test 4,000; the figure's LAR 5, E 3, lr 0.15)."""
    from repro_torch.core.h2fed import H2FedParams
    from repro_torch.core.heterogeneity import HeterogeneityModel
    from repro_torch.core.scenario import ScenarioSpec
    return ScenarioSpec(
        n_agents=100, n_rsus=10, batch=32, n_train=22_000, n_test=4_000,
        noise=0.8, excluded_labels=(7, 8, 9), pretrain_frac=0.12,
        pretrain_target=0.68, partition="scenario_two",
        hp=H2FedParams(mu1=mu1, mu2=mu2, lar=lar, local_epochs=3, lr=0.15),
        het=HeterogeneityModel(csr=csr, scd=1, lar=lar), rounds=rounds,
        sim_seed=sim_seed, **kw)


def fig2_grid(rounds=1):
    """The figure's 72 cells in its order (seeds innermost)."""
    return [fig2_spec(csr, mu2, mu1, s, rounds) for csr in FIG2_CSRS
            for mu2 in FIG2_MU2S for mu1 in FIG2_MU1S
            for s in range(FIG2_SEEDS)]


def sweep_kernel_cases(dev):
    """Each scenario-axis kernel entry at the sweep shape (Fig. 2's chunk of
    16 at the paper fleet, fp32) against its plain S-axis version, one
    launch a call; returns result rows."""
    from repro_torch.core.aggregation import build_weight_matrix
    from repro_torch.kernels import dual_proximal_sgd as dps
    from repro_torch.kernels import masked_hier_agg as mha
    from repro_torch.kernels import ref
    S, A, R, N = SWEEP_SHAPE
    gen = torch.Generator(device=dev).manual_seed(S + A)
    x = torch.randn(S, A, N, device=dev, generator=gen)
    prev = torch.randn(S, R, N, device=dev, generator=gen)
    w = torch.rand(S, A, device=dev, generator=gen) + 0.5
    assign = torch.arange(A, device=dev) % R       # one partition, shared
    mask = torch.rand(S, A, device=dev, generator=gen) < 0.6
    mask[:, assign == 0] = False                  # RSU 0 keeps its row
    W = build_weight_matrix(w, mask, assign, R)   # (S, R, A)
    mass = W.new_zeros(S, R).index_add_(1, assign, (w * mask).float())
    dead = int((mass <= 0).sum())
    rows = []

    def row(kernel, entry, err, ms, plain_ms, nbytes, flops, library_ms,
            fn=None, library_fn=None):
        b_ms, b_by = bound(nbytes, flops)
        r = {"kernel": kernel, "entry": entry, "shape": "sweep", "S": S,
             "A": A, "R": R, "N": N, "dtype": "float32", "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": library_ms}
        if fn is not None:
            r.update(host_device_split(fn, 1000))
        if library_fn is not None:
            lib = host_device_split(library_fn, 1000)
            r.update(library_device_ms=lib["device_ms"],
                     library_host_us=lib["host_us"])
        print("kernel " + json.dumps(r))
        rows.append(r)

    def one_launch(entry, counts, fn):
        before = counts[entry]
        out = fn()
        if counts[entry] != before + 1:
            raise AssertionError(f"{entry}: S={S} took "
                                 f"{counts[entry] - before} launches")
        return out

    # fused_agg_blend: agg_blend, the weights built in the kernel.  Bytes:
    # X, out, and prev's zero-mass rows (a row with mass reads no prev)
    got, got_mass = one_launch("agg_blend", mha.launches, lambda: mha.agg_blend(
        x, w, mask, assign, R, prev))
    want, want_mass = ref.agg_blend_ref(x, w, mask, assign, R, prev)
    err = compare(got, want, torch.float32, "agg_blend, scenario axis")
    compare(got_mass, want_mass, torch.float32, "agg_blend mass",
            tol=(0.0, 1e-6))

    def blend():
        return mha.agg_blend(x, w, mask, assign, R, prev)

    def blend_library():
        return torch.where((mass > 0)[..., None], torch.bmm(W, x), prev)
    ms = cuda_ms(blend)
    row("fused_agg_blend", "agg_blend_sweep", err, ms,
        cuda_ms(lambda: ref.agg_blend_ref(x, w, mask, assign, R, prev)),
        S * A * N * 4 + (S * R + dead) * N * 4 + S * A * 5 + A * 8
        + S * R * 4, 2 * S * R * A * N, cuda_ms(blend_library), blend,
        blend_library)

    # fused_agg_blend, cloud layer: (S, R, N) -> (S, N) fp32 masters
    cloud = torch.randn(S, N, device=dev, generator=gen)
    rmass = torch.rand(S, R, device=dev, generator=gen)
    got = one_launch("cloud_blend", mha.launches,
                     lambda: mha.cloud_blend(prev, rmass, cloud))
    err = compare(got, ref.cloud_blend_ref(prev, rmass, cloud),
                  torch.float32, "cloud_blend, scenario axis")
    wn = (rmass / rmass.sum(-1, keepdim=True))[:, None, :]

    def cloud_library():
        return torch.where(rmass.sum(-1, keepdim=True) > 0,
                           torch.bmm(wn, prev)[:, 0], cloud)
    row("fused_agg_blend", "cloud_blend_sweep", err,
        cuda_ms(lambda: mha.cloud_blend(prev, rmass, cloud)),
        cuda_ms(lambda: ref.cloud_blend_ref(prev, rmass, cloud)),
        S * (R * N * 4 + N * 4 + R * 4), 2 * S * R * N,
        cuda_ms(cloud_library))

    # fused_agg_blend, the async tick's two cohorts and the retained buffer
    x2 = x.flip(1).contiguous()
    arrivals = [(x, w * mask), (x2, w)]
    bm = torch.rand(S, R, device=dev, generator=gen)
    got3 = one_launch("agg_absorb", mha.launches, lambda: mha.agg_absorb(
        arrivals, assign, R, prev, bm, keep=0.5))
    want3 = ref.agg_absorb_ref(arrivals, assign, R, prev, bm, keep=0.5)
    err = compare(got3[0], want3[0], torch.float32,
                  "agg_absorb, scenario axis")
    row("fused_agg_blend", "agg_absorb_sweep", err,
        cuda_ms(lambda: mha.agg_absorb(arrivals, assign, R, prev, bm,
                                       keep=0.5)),
        cuda_ms(lambda: ref.agg_absorb_ref(arrivals, assign, R, prev, bm,
                                           keep=0.5)),
        2 * S * A * N * 4 + 2 * S * R * N * 4 + 2 * S * R * A * 4,
        4 * S * R * A * N, None)
    del x2, arrivals, got3, want3

    # weighted_agg_matmul: the fused=False path's (S, R, A) @ (S, A, N)
    got = one_launch("weighted_agg_matmul", mha.launches,
                     lambda: mha.weighted_agg_matmul(W, x))
    err = compare(got, ref.weighted_agg_matmul_ref(W, x), torch.float32,
                  "weighted_agg_matmul, scenario axis")

    def matmul():
        return mha.weighted_agg_matmul(W, x)

    def matmul_library():
        return torch.bmm(W, x)
    ms = cuda_ms(matmul)
    row("weighted_agg_matmul", "weighted_agg_matmul_sweep", err, ms,
        cuda_ms(lambda: ref.weighted_agg_matmul_ref(W, x)),
        S * (A * N * 4 + R * N * 4 + R * A * 4), 2 * S * R * A * N,
        cuda_ms(matmul_library), matmul, matmul_library)
    del got, want, x, prev
    torch.cuda.empty_cache()

    # dual_proximal_sgd: S*A rows, the cloud anchor one row a scenario,
    # lr / mu1 / mu2 (S,) tensors read by the row's scenario
    wt = torch.randn(S * A, N, device=dev, generator=gen)
    g = torch.randn(S * A, N, device=dev, generator=gen) * 0.1
    a1 = torch.randn(S * A, N, device=dev, generator=gen)
    a2 = torch.randn(S, N, device=dev, generator=gen)
    active = torch.randint(0, 3, (S * A,), device=dev, generator=gen,
                           dtype=torch.int32)
    hp = dict(lr=torch.rand(S, device=dev, generator=gen) * 0.2,
              mu1=torch.rand(S, device=dev, generator=gen) * 0.01,
              mu2=torch.rand(S, device=dev, generator=gen) * 0.005)
    got = one_launch("dual_proximal_sgd", dps.launches,
                     lambda: dps.dual_proximal_sgd(
                         wt, g, a1, a2, active_steps=active, step=1, **hp))
    err = compare(got, ref.dual_proximal_sgd_ref(
        wt, g, a1, a2, active_steps=active, step=1, **hp), torch.float32,
        "dual_proximal_sgd, scenario axis")
    del got

    def update():
        return dps.dual_proximal_sgd(wt, g, a1, a2, active_steps=active,
                                     step=1, out=wt, **hp)
    ms = cuda_ms(update)
    row("dual_proximal_sgd", "sweep", err, ms,
        cuda_ms(lambda: ref.dual_proximal_sgd_ref(
            wt, g, a1, a2, active_steps=active, step=1, **hp)),
        S * A * N * 16 + S * N * 4 + S * A * 4 + 3 * S * 4, 8 * S * A * N,
        None, update)
    del wt, g, a1, a2
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows


def drive_sweep(prog, rounds, draws=None):
    """``rounds`` rounds of a built sweep (its fault slices passed in);
    returns the final state."""
    state, dev = prog.state, prog.state.cloud_flat.device
    for r in range(rounds):
        fault_r = None if prog.fault_rounds is None else {
            k: torch.from_numpy(np.ascontiguousarray(v[:, r])).to(dev)
            for k, v in prog.fault_rounds.items()}
        out = prog.round_fn(state, None if draws is None else draws[r],
                            fault_r)
        state = out[0] if type(out) is tuple else out
    return state


SWEEP_FIELDS = {"flat": ("agent_flat", "rsu_flat", "cloud_flat"),
                "async": ("agent_flat", "rsu_flat", "cloud_flat", "rsu_mass",
                          "pending_x", "pending_w", "cloud_macc")}


def sweep_vs_sequential(dev, specs, params, what):
    """The card's sweep of ``specs`` against each scenario's sequential
    ``run_scenario`` on the card: every buffer within 1e-5, histories
    within 2e-3, async tick clocks and fault counts equal."""
    from repro_torch.core.flatten import spec_of
    from repro_torch.fedsim import async_engine, run_scenario, simulator
    from repro_torch.fedsim import sweep
    group = [s.resolve() for s in specs]
    if len(sweep.group_indices(group)) != 1:
        raise AssertionError(f"{what}: the cells are not one sweep group")
    prog = sweep.build_sweep(group, params)
    state = drive_sweep(prog, specs[0].rounds)
    hists = sweep.run_sweep(group, params)
    lane = (async_engine.lane_state if prog.engine == "async"
            else simulator.lane_state)
    fspec = spec_of(params, storage_dtype=specs[0].fleet_dtype)
    errs = {}
    for s, (spec, hist) in enumerate(zip(specs, hists)):
        final, want_h = run_scenario(group[s], params)
        if prog.engine == "flat":
            final = simulator.FlatSimState(
                fspec.ravel_stacked(final.agent_params),
                fspec.ravel_stacked(final.rsu_params),
                fspec.ravel(final.cloud_params), final.conn, final.gen)
        elif final.tick != lane(state, s).tick:
            raise AssertionError(f"{what}: scenario {s} tick clock")
        one = lane(state, s)
        for name in SWEEP_FIELDS[prog.engine]:
            g, want = getattr(one, name).float(), getattr(final, name).float()
            if not torch.isfinite(g).all():
                raise AssertionError(f"{what}: non-finite {name}")
            errs[name] = max(errs.get(name, 0.0),
                             (g - want).abs().max().item())
            if ((g - want).abs() > 1e-5 + 1e-5 * want.abs()).any():
                raise AssertionError(f"{what}: scenario {s} {name} off by "
                                     f"{errs[name]:.3e}")
        for k in want_h:
            if k in ("quarantined",):
                if hist[k].tolist() != want_h[k].tolist():
                    raise AssertionError(f"{what}: {k} {hist[k]} vs "
                                         f"{want_h[k]}")
            elif abs(np.asarray(hist[k], float)
                     - np.asarray(want_h[k], float)).max() > 2e-3 + 1e-5 * \
                    abs(np.asarray(want_h[k], float)).max():
                raise AssertionError(f"{what}: scenario {s} history {k} "
                                     f"{hist[k]} vs {want_h[k]}")
    print(f"sweep: {what}: {len(specs)} cells, {specs[0].rounds} rounds, "
          f"sweep vs sequential max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; final acc {[float(h['acc'][-1]) for h in hists]}")


def sweep_card_vs_host(dev, specs, params):
    """The card's sweep against the host's plain route on the same
    card-drawn draws (one CUDA generator a scenario): buffers within 1e-5,
    accuracy within 2e-3.  Held in the quickstart's regime (lr 0.1, one
    epoch): Fig. 2's (lr 0.15, three epochs of a label shard) amplifies
    last-bit differences to O(0.1-1) on some agents within one round, on
    the host alone too (PERF.md, section 6), whatever the kernels."""
    from repro_torch.core.heterogeneity import init_conn_state
    from repro_torch.fedsim import sweep
    from repro_torch.fedsim.simulator import round_draws
    group = [s.resolve() for s in specs]
    rounds = specs[0].rounds
    per = []
    for i, (spec, res) in enumerate(zip(specs, group)):
        spe = res.fed.x.shape[1] // spec.batch
        gen = torch.Generator(device=dev).manual_seed(5 + i)
        conn, rds = init_conn_state(spec.n_agents, dev), []
        for _ in range(rounds):
            rd = []
            for _ in range(spec.hp.lar):
                conn, mask, act = round_draws(gen, conn, spec.het, spec.hp,
                                              spec.n_agents, spe)
                rd.append((mask, act))
            rds.append(rd)
        per.append(rds)
    draws = [[per[s][r] for s in range(len(specs))] for r in range(rounds)]
    host_draws = [[[tuple(t.cpu() for t in x) for x in rd] for rd in rnd]
                  for rnd in draws]
    card = sweep.build_sweep(group, params)
    host = sweep.build_sweep(group, {k: v.cpu() for k, v in params.items()},
                             device="cpu")
    t0 = time.perf_counter()
    cs = drive_sweep(card, rounds, draws)
    hs = drive_sweep(host, rounds, host_draws)
    errs = {}
    for name in SWEEP_FIELDS["flat"]:
        g, w = getattr(cs, name).cpu().float(), getattr(hs, name).float()
        errs[name] = (g - w).abs().max().item()
        if ((g - w).abs() > 1e-5 + 1e-5 * w.abs()).any():
            raise AssertionError(f"sweep card vs host: {name} off by "
                                 f"{errs[name]:.3e}")
    acc_c = card.eval_fn(cs.cloud_flat).cpu()
    acc_h = host.eval_fn(hs.cloud_flat)
    acc_err = (acc_c - acc_h).abs().max().item()
    print(f"sweep: card vs host (plain versions), {len(specs)} cells, "
          f"{rounds} round(s), same card-drawn draws: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f", accuracy {acc_err:.4f} (limits 1e-5, 2e-3; "
          f"{time.perf_counter() - t0:.1f} s)")
    if acc_err > 2e-3:
        raise AssertionError("sweep: the card's accuracy disagrees with the "
                             "host's")


def sweep_round_profile(dev, specs, params, what, n=5):
    """Wall a round of the sweep of ``specs`` (host clock, synchronised,
    eval excluded), then one round under the profiler: returns (ms a
    round, host-API launches a round, device busy share)."""
    from repro_torch.fedsim import sweep
    prog = sweep.build_sweep([s.resolve() for s in specs], params)
    state = [prog.state]

    def one_round():
        out = prog.round_fn(state[0])
        state[0] = out[0] if type(out) is tuple else out
    one_round()                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        one_round()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    wall, launches, busy, kernels, runs = device_profile(one_round, 1)
    print_profile(what, 1, wall, launches, busy, kernels, runs)
    return ms, launches, (busy / wall if busy else None)


def sweep_path(dev):
    """Phase 3s; returns (result rows of the scenario-axis kernels, the
    launch counts of the counted sweep runs)."""
    import dataclasses
    from repro_torch.core import program_cache
    from repro_torch.core.faults import (ChurnWindow, CorruptSpec, FaultPlan,
                                         RsuOutage)
    from repro_torch.fedsim import run_scenario, run_scenarios
    from repro_torch.kernels import ops
    rows = sweep_kernel_cases(dev)
    grid = fig2_grid()
    # every cell starts from the figure's biased OEM model (one dataset)
    _, params, _ = pretrained(dev, grid[0], "sweep")

    # sweep against sequential on the card: 4 cells (mixed csr and mu1,
    # one mixed lar), 2 rounds; the async equivalent with cloud_every 0
    # and 3; a fault grid (different plans, one guard)
    four = [fig2_spec(1.0, 0.0, 0.0, 0, 2), fig2_spec(0.5, 0.0, 0.004, 1, 2),
            fig2_spec(0.2, 0.001, 0.007, 2, 2),
            fig2_spec(0.5, 0.001, 0.001, 0, 2, lar=3)]
    sweep_vs_sequential(dev, four, params, "flat, fp32, lar 5 and 3")
    asyn = [s.replace(engine="async", staleness_decay=0.5, buffer_keep=0.5,
                      cloud_every=(0, 3)[i % 2],
                      het=dataclasses.replace(s.het, max_delay=2,
                                              delay_p=0.6))
            for i, s in enumerate(four)]
    sweep_vs_sequential(dev, asyn, params, "async, cloud_every 0 and 3")
    plans = [FaultPlan(churn=(ChurnWindow(frac=0.25, start=1, stop=6,
                                          seed=i),),
                       outages=(RsuOutage(rsu=i, start=2, stop=5),),
                       corrupt=(CorruptSpec(kind="nan", frac=0.2, seed=i),
                                CorruptSpec(kind="scale", frac=0.2,
                                            scale=1e4, seed=i + 5)),
                       norm_clip=50.0, seed=i) for i in range(4)]
    sweep_vs_sequential(dev, [s.replace(faults=p)
                              for s, p in zip(four[:3] + [four[1]], plans)],
                        params, "flat, a fault grid")
    qs = quickstart_spec().replace(rounds=2)
    sweep_card_vs_host(dev, [qs.replace(
        het=dataclasses.replace(qs.het, csr=c),
        hp=dataclasses.replace(qs.hp, mu1=m), sim_seed=i)
        for i, (c, m) in enumerate(((0.3, 0.001), (0.6, 0.004), (1.0, 0.0)))],
        params)

    # the counted sweep: one 16-wide chunk of the grid, 5 rounds
    chunk = fig2_grid(rounds=5)[:SWEEP_S]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hists = run_scenarios(chunk, params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    if not all(np.isfinite(h["acc"]).all() and len(h["acc"]) == 5
               for h in hists):
        raise AssertionError("sweep: bad accuracy histories")
    res = chunk[0].resolve()
    lar, rounds = chunk[0].hp.lar, chunk[0].rounds
    n_steps = chunk[0].hp.local_epochs * (res.fed.x.shape[1]
                                          // chunk[0].batch)
    want = {"agg_blend": rounds * lar, "cloud_blend": rounds,
            "dual_proximal_sgd": rounds * lar * n_steps}
    print(f"sweep: {SWEEP_S} cells x {rounds} rounds in {seconds:.2f} s "
          f"(wall, set-up and eval included); launches {counts} (expect "
          f"{want}: one a call, as one scenario's run)")
    for k, v in want.items():
        if counts[k] != v:
            raise AssertionError(f"sweep {k}: {counts[k]} launches, want {v}")
    paths = {"sweep": counts}

    # launches of #1 and #3 a round at S = 16 against S = 1
    one = chunk[0].replace(rounds=1)
    ops.reset_launch_counts()
    run_scenario(one, params)
    torch.cuda.synchronize()
    single = ops.launch_counts()
    for k in ("agg_blend", "cloud_blend", "dual_proximal_sgd"):
        if counts[k] != rounds * single[k]:
            raise AssertionError(f"sweep {k}: {counts[k] / rounds:.0f} "
                                 f"launches a round at S={SWEEP_S}, "
                                 f"{single[k]} at S=1")
    print(f"sweep: launches a round at S={SWEEP_S} equal S=1's: "
          f"{ {k: single[k] for k in want} }")

    # fused=False: #2 a call at S = 4, counted
    ops.reset_launch_counts()
    run_scenarios([s.replace(fused=False, rounds=1) for s in four[:3]]
                  + [four[1].replace(fused=False, rounds=1, sim_seed=5)],
                  params)
    torch.cuda.synchronize()
    c = ops.launch_counts()
    print(f"sweep: fused=False, 4 cells, 1 round: launches {c}")
    if c["weighted_agg_matmul"] != lar + 1 or c["agg_blend"]:
        raise AssertionError(f"sweep fused=False launches {c}")
    paths["unfused"] = c

    # the sweep round beside sequential rounds: wall, launches, busy
    ms, launches, busy = sweep_round_profile(
        dev, chunk, params, f"sweep round (S={SWEEP_S}, A=100, R=10)")
    seq = [sweep_round_profile(dev, [s], params,
                               f"sequential round (cell {i}, A=100, R=10)")
           for i, s in enumerate(chunk[:2])]
    print(f"sweep: {ms:.2f} ms a sweep round, {ms / SWEEP_S:.3f} ms a "
          f"scenario-round, {launches} host-API launches a round, device "
          f"busy {busy:.1%}; sequential: "
          + "; ".join(f"{m:.2f} ms a scenario-round, {n} launches, busy "
                      f"{b:.1%}" for m, n, b in seq)
          + f" (NVIDIA card of this run: {gpu_line()})")

    # the whole grid: 72 cells at max_sweep 16, 1 round: 5 chunks, one
    # build, histories in input order
    program_cache.clear()
    t0 = time.perf_counter()
    hists = run_scenarios(grid, params, max_sweep=SWEEP_S)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    st = program_cache.stats()
    print(f"sweep: the whole grid, {len(grid)} cells at max_sweep "
          f"{SWEEP_S}, 1 round: {seconds:.2f} s, registry {st}")
    if (len(hists) != len(grid) or program_cache.trace_count("sweep_round")
            != 1 or st["hits"] != 4):
        raise AssertionError(f"sweep: the 72-cell grid took {st}")
    for i in (0, 37, 71):
        _, h = run_scenario(grid[i], params)
        if abs(float(h["acc"][-1]) - float(hists[i]["acc"][-1])) > 2e-3:
            raise AssertionError(f"sweep: cell {i}'s history is not its own "
                                 f"({hists[i]['acc']} vs {h['acc']})")
    return rows, paths


# -- phase 3t: cohort streaming --------------------------------------------

# the fleet cell of benchmarks/streaming_round.py at its CI scale, at the
# paper MLP's width: one synthetic shard of 4 samples every agent sees
# through a broadcast view, R = 16, chunks of 16,384 agents, LAR 1, E 1
FLEET_A, FLEET_SMALL_A, FLEET_R, FLEET_CHUNK = 100_000, 25_000, 16, 16_384
FLEET_SAMPLES = 4
PERCEPTION_HIDDEN = (12_000,)     # the 784-12000-10 perception MLP
PERCEPTION_TILE = 1_048_576       # chunk_params of the two-axis round
STREAM_CHUNK = 7                  # a padded tail at A = 20 and A = 100


def stream_specs(fleet: str):
    """Phase 3t (a)'s scenarios at the main (A=20, R=4) or the paper
    (A=100, R=10) fleet, 2 rounds: the quickstart's flat round and the
    straggler regime's async round."""
    A, R = {"main": (20, 4), "paper": (100, 10)}[fleet]
    a_spec, _ = straggler_specs()
    return (quickstart_spec().replace(n_agents=A, n_rsus=R, rounds=2),
            a_spec.replace(n_agents=A, n_rsus=R, rounds=2))


def _cloud(state) -> torch.Tensor:
    """The (N,) cloud master of any engine's final state."""
    if hasattr(state, "cloud_params"):
        return torch.cat([state.cloud_params[k].reshape(-1)
                          for k in sorted(state.cloud_params)])
    return state.cloud_flat


def _rsu(state) -> torch.Tensor:
    """The (R, N) RSU rows of any engine's final state."""
    if hasattr(state, "rsu_params"):
        p = state.rsu_params
        return torch.cat([p[k].reshape(p[k].shape[0], -1)
                          for k in sorted(p)], dim=1)
    return state.rsu_flat


def _limit(what, err, limit):
    if not err <= limit:
        raise AssertionError(f"{what}: {err:.3e} past {limit}")
    return err


def stream_equivalence(dev, params):
    """Phase 3t (a): the streamed rounds against the resident ones, the
    card's own draws replayed on both; returns the counted runs' launch
    counts (the host-streamed flat and async rounds at the main fleet)."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.fedsim import run_scenario
    paths = {}
    for fleet in ("main", "paper"):
        for s in stream_specs(fleet):
            engine = s.engine
            res = s.resolve()
            draws = card_draws(dev, s, res, 2)
            if engine == "flat":
                draws = [[(m, a) for m, a, _ in rd] for rd in draws]
            resident, rh = run_scenario(res, params, draws=draws)
            host = s.replace(fleet_store="host", chunk_agents=STREAM_CHUNK)
            st, sh, counts, _ = timed_run(host.resolve(), params, draws=draws)
            n_chunks = -(-s.n_agents // STREAM_CHUNK)
            lar, rounds = s.hp.lar, s.rounds
            per = 2 if engine == "async" else 1
            want = {"chunk_agg": rounds * lar * n_chunks * per,
                    "cloud_blend": rounds, "agg_blend": 0, "agg_absorb": 0}
            if any(counts[k] != v for k, v in want.items()):
                raise AssertionError(f"streamed {engine} launches {counts}, "
                                     f"want {want}")
            if fleet == "main":
                paths[engine] = counts
            # streamed (#2 sums + normalize) against resident (#1): the
            # limit of phase 3's card-vs-host check after 2 rounds
            errs = {"cloud": (_cloud(st) - _cloud(resident)).abs().max()
                    .item(), "acc": float(abs(sh["acc"] - rh["acc"]).max())}
            if engine == "async":
                errs["agents"] = (st.store.snapshot().to(dev)
                                  - resident.agent_flat).abs().max().item()
                fly = resident.pending_t > 0
                errs["pending rows"] = ((st.pending_store.snapshot().to(dev)
                                         - resident.pending_x)[fly].abs()
                                        .max().item() if fly.any() else 0.0)
                if not (torch.equal(st.pending_t, resident.pending_t)
                        and torch.equal(st.pending_w, resident.pending_w)):
                    raise AssertionError("streamed async: the in-flight "
                                         "weights or ticks differ")
                for k in ("absorbed_mass", "pending_mass"):
                    if not np.allclose(sh[k], rh[k], rtol=1e-6, atol=0):
                        raise AssertionError(f"streamed async {k}: {sh[k]} "
                                             f"vs {rh[k]}")
            for k, v in errs.items():
                _limit(f"{fleet} {engine} streamed vs resident {k}", v,
                       2e-3 if k == "acc" else 1e-4)
            # device-chunked against host-streamed, and an empty plan
            # against none: the same kernels in the same order, bit for bit
            dst, _ = run_scenario(host.replace(fleet_store="device").resolve(),
                                  params, draws=draws)
            fst, _ = run_scenario(host.replace(faults=FaultPlan()).resolve(),
                                  params, draws=draws)
            same = (torch.equal(dst.store.snapshot().cpu(),
                                st.store.snapshot())
                    and torch.equal(dst.cloud_flat, st.cloud_flat)
                    and torch.equal(fst.cloud_flat, st.cloud_flat)
                    and torch.equal(fst.store.snapshot(), st.store.snapshot()))
            if not same:
                raise AssertionError(f"{fleet} {engine}: device-chunked or "
                                     f"the empty plan differs from the host-"
                                     f"streamed round")
            print(f"stream: {fleet} fleet (A={s.n_agents}, R={s.n_rsus}), "
                  f"{engine}, chunk {STREAM_CHUNK}, 2 rounds, the card's "
                  f"draws: streamed vs resident max abs err "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f" (limit 1e-4, acc 2e-3); device-chunked == host-"
                  f"streamed and empty plan == none bit for bit; launches "
                  f"{ {k: v for k, v in counts.items() if v} }")
            if engine == "flat":
                # the two-axis round's empty plan, and a bf16 host store
                two = host.replace(chunk_params=8192)
                a, _ = run_scenario(two.resolve(), params, draws=draws)
                b, _ = run_scenario(two.replace(faults=FaultPlan()).resolve(),
                                    params, draws=draws)
                if not torch.equal(a.cloud_flat, b.cloud_flat):
                    raise AssertionError("two-axis: the empty plan differs")
                bst, bh = run_scenario(host.replace(
                    fleet_dtype="bfloat16").resolve(), params, draws=draws)
                err = (bst.cloud_flat - st.cloud_flat).abs().max().item()
                if not (np.isfinite(bh["acc"]).all() and torch.isfinite(
                        bst.store.snapshot().float()).all()):
                    raise AssertionError("bf16 host store: non-finite")
                print(f"stream: {fleet} two-axis (tiles of 8,192) empty "
                      f"plan == none bit for bit; bf16 host store: finite, "
                      f"cloud within {err:.3e} of the fp32 round (limit "
                      f"5e-2: bf16 storage over 8 local rounds)")
                _limit("bf16 host store vs fp32", err, 5e-2)
    return paths


def stream_twoaxis(dev):
    """Phase 3t (b): the two-axis round at the perception MLP (N =
    9,540,010, A = 100, R = 10, tiles of 1,048,576 columns) against the
    one-axis streamed round on the same draws, 1 round; peak device memory
    of each."""
    import dataclasses
    from repro_torch.configs.mnist_mlp import CONFIG
    from repro_torch.fedsim import run_scenario
    from repro_torch.models import mlp
    spec, _ = stream_specs("paper")
    spec = spec.replace(hidden_dims=PERCEPTION_HIDDEN, rounds=1,
                        fleet_store="host", chunk_agents=25)
    params = mlp.init_params(dataclasses.replace(
        CONFIG, hidden_dims=PERCEPTION_HIDDEN),
        torch.Generator().manual_seed(0), device=dev)
    res = spec.resolve()
    draws = [[(m, a) for m, a, _ in rd] for rd in card_draws(dev, spec, res,
                                                             1)]
    out = {}
    for name, s in (("one-axis", spec),
                    ("two-axis", spec.replace(chunk_params=PERCEPTION_TILE))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st, h = run_scenario(s.resolve(), params, draws=draws)
        torch.cuda.synchronize()
        out[name] = (st, time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated())
    (one, t1, m1), (two, t2, m2) = out["one-axis"], out["two-axis"]
    n = one.cloud_flat.shape[0]
    got, want = two.cloud_flat[:n].to(dev), one.cloud_flat
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"stream: perception (N={n}, A=100, R=10, chunk 25), 1 round: "
          f"two-axis (tiles of {PERCEPTION_TILE}) vs one-axis max relative "
          f"diff {rel:.3e} (limit 1e-6), bitwise {torch.equal(got, want)}; "
          f"peak device memory one-axis {m1 / 1e9:.3f} GB, two-axis "
          f"{m2 / 1e9:.3f} GB; wall {t1:.2f} s / {t2:.2f} s (eval "
          f"included)")
    _limit("two-axis vs one-axis", rel, 1e-6)
    if two.cloud_flat[n:].any():
        raise AssertionError("two-axis: a padded column is not zero")


def fleet_data(A: int, R: int, seed: int = 0):
    """One shard of FLEET_SAMPLES 784-feature samples every agent sees
    through a broadcast view (the fleet cell's data), agents on R RSUs
    round robin."""
    from repro_torch.data.partition import FederatedData
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=(1, FLEET_SAMPLES, 784)).astype(np.float32)
    y1 = rng.integers(0, 10, size=(1, FLEET_SAMPLES)).astype(np.int32)
    return FederatedData(
        x=np.broadcast_to(x1, (A, FLEET_SAMPLES, 784)),
        y=np.broadcast_to(y1, (A, FLEET_SAMPLES)),
        n_per_agent=np.broadcast_to(np.int32(FLEET_SAMPLES), (A,)),
        rsu_assign=np.arange(A, dtype=np.int32) % R)


def fleet_round(dev, A: int, profile: bool = False) -> dict:
    """Phase 3t (c): one timed streamed flat round over a host fleet of A
    agents (paper MLP, R = 16, chunks of 16,384) after a warm-up round:
    wall, agents/s, the bytes that crossed against the analytic count,
    peak device memory; with ``profile`` a third round under the
    profiler (compute and copy time on the device)."""
    from repro_torch.configs.mnist_mlp import CONFIG
    from repro_torch.core.flatten import spec_of
    from repro_torch.core.h2fed import H2FedParams
    from repro_torch.core.heterogeneity import HeterogeneityModel
    from repro_torch.fedsim.simulator import SimConfig
    from repro_torch.fedsim.streaming import (init_stream_state,
                                              make_streamed_flat_round,
                                              streamed_transfer_bytes)
    from repro_torch.models import mlp
    cfg = SimConfig(n_agents=A, n_rsus=FLEET_R, batch=FLEET_SAMPLES, seed=0)
    hp = H2FedParams(mu1=0.01, mu2=0.005, lar=1, local_epochs=1, lr=0.1)
    het = HeterogeneityModel(csr=1.0)
    params = mlp.init_params(CONFIG, torch.Generator().manual_seed(0),
                             device=dev)
    fspec, fed = spec_of(params), fleet_data(A, FLEET_R)
    round_fn = make_streamed_flat_round(cfg, hp, het, fed, fspec, device=dev,
                                        chunk_agents=FLEET_CHUNK)
    t0 = time.perf_counter()
    state = [init_stream_state(cfg, fspec, params, dev, fleet_store="host")]
    setup_s = time.perf_counter() - t0
    if not state[0].store.pinned:
        raise AssertionError("the host store is not pinned")

    def one_round():
        state[0] = round_fn(state[0])
    one_round()                          # warm-up: staging buffers pinned
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(round_fn.link.bytes)
    t0 = time.perf_counter()
    one_round()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    moved = {k: round_fn.link.bytes[k] - before[k] for k in before}
    xfer = streamed_transfer_bytes(round_fn.plan, fspec, hp, fed)
    # every agent sees the same shard from the same start: every row of the
    # fleet, and the cloud, is the one agent's update
    st = state[0]
    first, last = st.store.gather(0, 1), st.store.gather(A - 1, A)
    cloud = st.cloud_flat.cpu()
    if not (torch.isfinite(cloud).all() and torch.equal(first, last)):
        raise AssertionError("fleet round: rows differ or are not finite")
    _limit("fleet round: cloud vs an agent row", ((cloud - first[0]).abs()
           .max() / first.abs().max()).item(), 1e-5)
    out = {"A": A, "n_chunks": round_fn.plan.n_chunks, "wall_s": wall,
           "agents_per_s": A / wall, "setup_s": setup_s,
           "store_gb": st.store.nbytes / 1e9, "peak_gb": peak / 1e9,
           "h2d_gb": moved["h2d"] / 1e9, "d2h_gb": moved["d2h"] / 1e9,
           "h2d_analytic_gb": xfer["h2d"] / 1e9,
           "d2h_analytic_gb": xfer["d2h"] / 1e9}
    if profile:
        pw, launches, _, kernels, _ = device_profile(one_round, 1)
        copy = {d: sum(v for k, v in kernels.items()
                       if k.startswith("Memcpy") and d in k)
                for d in ("HtoD", "DtoH")}
        compute = sum(v for k, v in kernels.items()
                      if not k.startswith(("Memcpy", "Memset")))
        out.update(profiled_wall_s=pw, launches=launches,
                   compute_s=compute, h2d_s=copy["HtoD"],
                   d2h_s=copy["DtoH"], busy_compute=compute / pw)
    print("stream: fleet round " + json.dumps(out))
    del state, st
    torch.cuda.empty_cache()
    return out


def chunk_agg_cases(dev):
    """Phase 3t (d): #2 as ``chunk_agg`` at the fleet round's chunk shape
    (R = 16, A = 16,384, N = 31,810: 32 tiles of 512 agents a block)
    against its plain version, fp32 and bf16 rows; returns result rows.
    The check holds both to the exact sum: |got - plain| within 2e-6 of
    the sum of |terms| (each is within a few fp32 ulps of it).  The masses
    are held to the exact (fp64) sum within 1e-6 relative: the plain
    version's fp32 ``index_add_`` adds its 1,024 weights an RSU in an
    order that varies from run to run, which alone moves its sum by about
    that much."""
    from repro_torch.core.aggregation import unnormalized_weight_matrix
    from repro_torch.kernels import masked_hier_agg as mha
    from repro_torch.kernels import ref
    A, R, N = FLEET_CHUNK, FLEET_R, 31_810
    gen = torch.Generator(device=dev).manual_seed(19)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        sx = torch.finfo(dtype).bits // 8
        x = torch.randn(A, N, device=dev, generator=gen).to(dtype)
        w = torch.rand(A, device=dev, generator=gen) + 0.5
        w[-100:] = 0.0                     # a padded tail rides along
        assign = torch.arange(A, device=dev) % R
        got, mass = mha.scatter_accumulate(x, w, assign, R,
                                           entry="chunk_agg")
        want, want_mass = ref.chunk_agg_ref(x, w, assign, R)
        W = unnormalized_weight_matrix(w, torch.ones_like(w), assign, R)
        scale = W.abs() @ x.float().abs()
        excess = ((got - want).abs() - 2e-6 * scale).max().item()
        err = (got - want).abs().max().item()
        exact = torch.zeros(R, dtype=torch.float64, device=dev).index_add_(
            0, assign, w.double())
        mass_err = ((mass.double() - exact).abs() / exact).max().item()
        if excess > 0 or mass_err > 1e-6 or not torch.allclose(
                want_mass.double(), exact, rtol=1e-5, atol=0):
            raise AssertionError(f"chunk_agg {dtype}: the kernel disagrees "
                                 f"with the plain version ({err:.3e}) or "
                                 f"its mass with the exact sum (relative "
                                 f"{mass_err:.1e})")
        del scale
        ms = cuda_ms(lambda: mha.scatter_accumulate(x, w, assign, R,
                                                    entry="chunk_agg"))
        b_ms, b_by = bound(A * N * sx + R * N * 4 + A * 12, 2 * R * A * N)
        row = {"kernel": "weighted_agg_matmul", "entry": "chunk_agg",
               "shape": "chunk", "A": A, "R": R, "N": N,
               "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms,
               "plain_ms": cuda_ms(lambda: ref.chunk_agg_ref(x, w, assign,
                                                             R)),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": cuda_ms(lambda: torch.matmul(W, x.float()))}
        print("kernel " + json.dumps(row))
        rows.append(row)
        del x, got, want
        torch.cuda.empty_cache()
    return rows


def stream_round_profile(dev, params, n: int = 3) -> None:
    """Phase 3t (e): the host-streamed flat round at the main fleet (chunk
    7, 3 chunks) on the host clock and under the profiler, beside the
    resident round (548 launches)."""
    from repro_torch.core.flatten import spec_of
    from repro_torch.fedsim.streaming import (init_stream_state,
                                              make_streamed_flat_round)
    s = quickstart_spec()
    res = s.resolve()
    round_profile(dev, res, params, what="resident flat round (main fleet)")
    fspec = spec_of(params)
    round_fn = make_streamed_flat_round(res.cfg, s.hp, s.het, res.fed, fspec,
                                        device=dev,
                                        chunk_agents=STREAM_CHUNK)
    state = [round_fn(init_stream_state(res.cfg, fspec, params, dev))]

    def one_round():
        state[0] = round_fn(state[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        one_round()
    torch.cuda.synchronize()
    print(f"round: host-streamed flat round (main fleet, chunk "
          f"{STREAM_CHUNK}): {(time.perf_counter() - t0) / n * 1e3:.2f} ms "
          f"a global round (host clock, synchronised, {n} rounds, eval "
          f"excluded)")
    print_profile("host-streamed flat round (main fleet)", n,
                  *device_profile(one_round, n))


# resident fleets past the ring kernel's shared memory: 4,001 agents at R
# = 10 for agg_blend, 2,334 a cohort for the async tick's agg_absorb
RESIDENT_A, RESIDENT_R, RESIDENT_CHUNK = 5_000, 10, 2_048


def resident_past_ring(dev, params):
    """Phase 3t (f): the resident flat and async rounds at A = 5,000, R =
    10 (N = 31,810), past what the ring kernel's shared memory holds, so
    ``agg_blend`` and ``agg_absorb`` take #2's agent tiles (counted: no
    ring launch on the RSU layer), against the host-streamed rounds of the
    same spec, 1 round, the card's own draws replayed on both: cloud and
    RSU rows within 1e-4, accuracy within 2e-3.  Returns the resident
    runs' launch counts."""
    a_spec, _ = straggler_specs()
    specs = [s.replace(n_agents=RESIDENT_A, n_rsus=RESIDENT_R,
                       n_train=50_000, batch=8, rounds=1)
             for s in (quickstart_spec(), a_spec)]
    paths = {}
    for s in specs:
        res = s.resolve()
        draws = card_draws(dev, s, res, 1)
        if s.engine == "flat":
            draws = [[(m, a) for m, a, _ in rd] for rd in draws]
        resident, rh, counts, secs = timed_run(res, params, draws=draws)
        lar = s.hp.lar
        want = ({"agg_blend_tiled": lar, "agg_blend": 0, "cloud_blend": 1}
                if s.engine == "flat" else
                {"agg_absorb_tiled": 2 * lar, "agg_absorb": 0,
                 "cloud_blend": 1})
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"resident {s.engine} at A={RESIDENT_A}: "
                                 f"launches {counts}, want {want}")
        host = s.replace(fleet_store="host", chunk_agents=RESIDENT_CHUNK)
        st, sh, _, _ = timed_run(host.resolve(), params, draws=draws)
        errs = {"cloud": (_cloud(st) - _cloud(resident)).abs().max().item(),
                "rsu rows": (st.rsu_flat - _rsu(resident)).abs().max()
                .item(),
                "acc": float(abs(sh["acc"] - rh["acc"]).max())}
        for k, v in errs.items():
            _limit(f"resident {s.engine} A={RESIDENT_A} vs streamed {k}", v,
                   2e-3 if k == "acc" else 1e-4)
        paths[f"resident_{s.engine}"] = counts
        print(f"stream: resident {s.engine} round at A={RESIDENT_A}, "
              f"R={RESIDENT_R} (past the ring), {secs * 1e3:.1f} ms with "
              f"set-up and eval, launches "
              f"{ {k: v for k, v in counts.items() if v} }; against the "
              f"host-streamed round (chunks of {RESIDENT_CHUNK}): max abs "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + " (limit 1e-4, acc 2e-3)")
        del resident, st
        torch.cuda.empty_cache()
    return paths


def stream_path(dev):
    """Phase 3t; returns (#2's rows at the chunk shape, the launch counts
    of the counted streamed and resident-past-the-ring runs)."""
    from repro_torch.configs.mnist_mlp import CONFIG
    from repro_torch.models import mlp
    rows = chunk_agg_cases(dev)
    params = mlp.init_params(CONFIG, torch.Generator().manual_seed(0),
                             device=dev)
    paths = stream_equivalence(dev, params)
    paths.update(resident_past_ring(dev, params))
    stream_twoaxis(dev)
    big = fleet_round(dev, FLEET_A, profile=True)
    small = fleet_round(dev, FLEET_SMALL_A)
    gap = abs(big["peak_gb"] - small["peak_gb"]) / big["peak_gb"]
    print(f"stream: peak device memory at A={FLEET_A}: {big['peak_gb']:.4f} "
          f"GB, at A={FLEET_SMALL_A}: {small['peak_gb']:.4f} GB (differ by "
          f"{gap:.3%}, limit 1%)")
    _limit("peak device memory against the fleet size", gap, 0.01)
    stream_round_profile(dev, params)
    return rows, paths


# -- phase 3v: the continuous serving loop ----------------------------------

# the nominal cell of benchmarks/serving_loop.py (its _spec, l.52-60),
# moved to the main (A=20, R=4) and paper (A=100, R=10) fleets with its
# 100 samples an agent kept (n_train 100 A)
SERVE_HP = dict(mu1=0.01, mu2=0.005, lar=2, local_epochs=1, lr=0.1)
SERVE_WINDOWS = 20
SERVE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_serve"
# the host-side schedule of a serve run: equal card against host and
# replay against run
SERVE_SCHEDULE = ("events_generated", "events_absorbed", "events_dropped",
                  "events_deferred", "events_coalesced", "events_lost_churn",
                  "events_duplicated", "events_stale_rejected",
                  "quarantined_updates", "blocked_mass", "n_ticks",
                  "n_rounds", "n_cloud_aggs", "sim_time", "queue_depth",
                  "drain_sizes", "event_wait", "model_staleness")


def serve_spec(A: int, R: int, **kw):
    from repro_torch.core.h2fed import H2FedParams
    from repro_torch.core.scenario import ScenarioSpec
    return ScenarioSpec(**{**dict(
        n_agents=A, n_rsus=R, batch=16, n_train=100 * A, n_test=400,
        hp=H2FedParams(**SERVE_HP), engine="async", staleness_decay=1.0,
        rounds=2), **kw})


def timed_serve(res, params, **kw):
    """run_serve_loop on the card with the launch counts set to 0 just
    before and read just after: (state, history, stats, counts, s)."""
    from repro_torch.fedsim import run_serve_loop
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist, stats, _ = run_serve_loop(res, params, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    for t in (state.cloud_flat, state.rsu_flat, state.agent_flat,
              state.rsu_mass, state.cloud_macc):
        if not torch.isfinite(t.float()).all():
            raise AssertionError("serve loop: non-finite buffer")
    if not all(0.0 <= a <= 1.0 for a in hist["acc"]):
        raise AssertionError(f"bad accuracy history {hist['acc']}")
    return state, hist, stats, counts, seconds


def serve_steps(res) -> int:
    """Kernel #3 launches a tick: the minibatch steps of every epoch."""
    s = res.spec
    return s.hp.local_epochs * max(res.fed.x.shape[1] // s.batch, 1)


def _check_counts(what, counts, want):
    print(f"serve: {what}: launches {counts} (expect {want})")
    for k, v in want.items():
        if counts[k] != v:
            raise AssertionError(f"{what}: {k} {counts[k]} launches, want "
                                 f"{v}")


def serve_anchor(dev, params):
    """(a) and (f): every agent once a tick window, trigger batch:A, decay
    1.0, the per-round cadence, 3 rounds, against ``run_scenario(engine=
    "async")`` on the card at the main and paper fleets; each tick one
    ``agg_absorb``, each round close one ``cloud_blend``, #3 once a step.
    Returns the main fleet's serve-run counts."""
    from repro_torch.core.heterogeneity import HeterogeneityModel
    from repro_torch.core.load_gen import every_agent_once_trace
    counts_main = None
    for fleet, A, R in (("main", 20, 4), ("paper", 100, 10)):
        a_spec = serve_spec(A, R, het=HeterogeneityModel(
            csr=0.5, fsr=0.8, lar=SERVE_HP["lar"])).replace(rounds=3)
        lar = a_spec.hp.lar
        st_a, h_a, _, _ = timed_run(a_spec.resolve(), params)
        res = a_spec.replace(serve_events=A * lar * 3,
                             tick_trigger=f"batch:{A}").resolve()
        st_s, h_s, stats, counts, seconds = timed_serve(
            res, params, gen=every_agent_once_trace(A, lar * 3))
        err = (st_s.cloud_flat - st_a.cloud_flat).abs().max().item()
        acc_err = float(np.abs(h_s["acc"] - h_a["acc"]).max())
        bitwise = torch.equal(st_s.cloud_flat, st_a.cloud_flat)
        print(f"serve: (a) anchor, {fleet} fleet (A={A}, R={R}), "
              f"{stats.n_ticks} ticks, {stats.n_rounds} rounds: cloud max "
              f"abs diff against "
              f"the async engine {err:.3e} (rtol 2e-5, atol 2e-6), bitwise "
              f"{bitwise}; accuracy serve {h_s['acc'].tolist()} async "
              f"{h_a['acc'].tolist()} (diff {acc_err:.2e}, limit 2e-6); "
              f"{seconds:.3f} s")
        if (not torch.allclose(st_s.cloud_flat, st_a.cloud_flat, rtol=2e-5,
                               atol=2e-6) or acc_err > 2e-6
                or stats.n_ticks != lar * 3 or stats.events_coalesced
                or stats.events_dropped):
            raise AssertionError(f"{fleet}: the serve anchor differs from "
                                 f"the async engine")
        _check_counts(f"(f) anchor, {fleet} fleet", counts, {
            "agg_absorb": stats.n_ticks, "cloud_blend": stats.n_rounds,
            "dual_proximal_sgd": stats.n_ticks * serve_steps(res),
            "agg_blend": 0, "weighted_agg_matmul": 0,
            "scatter_accumulate": 0})
        counts_main = counts_main or counts
    return counts_main


def serve_launches(dev, params):
    """(f) more: ``fused=False`` (#2 a tick as the scatter-accumulate, #2
    at each round close as ``cloud_agg``) and ``cloud_every=3`` (one
    ``cloud_blend`` every third tick), Poisson load at the main fleet.
    Returns the ``fused=False`` run's counts."""
    base = dict(serve_events=120, arrival_rate=1.0, tick_trigger="auto",
                queue_capacity=80)
    res = serve_spec(20, 4, fused=False, **base).resolve()
    _, _, st, unfused, _ = timed_serve(res, params)
    _check_counts("(f) fused=False", unfused, {
        "scatter_accumulate": st.n_ticks, "weighted_agg_matmul":
        st.n_cloud_aggs, "agg_absorb": 0, "cloud_blend": 0,
        "dual_proximal_sgd": st.n_ticks * serve_steps(res)})
    res = serve_spec(20, 4, cloud_every=3, **base).resolve()
    _, _, st, counts, _ = timed_serve(res, params)
    _check_counts("(f) cloud_every=3", counts, {
        "agg_absorb": st.n_ticks, "cloud_blend": st.n_ticks // 3,
        "dual_proximal_sgd": st.n_ticks * serve_steps(res)})
    return unfused


def serve_draws(dev, res, n_ticks):
    """The card's own per-tick draws (a CUDA generator, ``conn`` carried):
    draws[t] = (mask, active_steps) on the card."""
    from repro_torch.core.heterogeneity import init_conn_state
    from repro_torch.fedsim.simulator import round_draws
    s = res.spec
    spe = max(res.fed.x.shape[1] // s.batch, 1)
    gen = torch.Generator(device=dev).manual_seed(5)
    conn, out = init_conn_state(s.n_agents, dev), []
    for _ in range(n_ticks):
        conn, mask, act = round_draws(gen, conn, s.het, s.hp, s.n_agents, spe)
        out.append((mask, act))
    return out


def _schedule_diff(a, b):
    return [k for k in SERVE_SCHEDULE if getattr(a, k) != getattr(b, k)]


def serve_card_vs_host(dev, params):
    """(b): one Poisson run at the main fleet under churn, an RSU outage
    with recovery, duplicates and clock skew, on the card and on the host
    with the card's per-tick draws injected: every counter, the drain
    sizes and queue depths equal, the buffers within 1e-5.  Then one bf16
    tick from the same state on both, within one bf16 ulp."""
    from repro_torch.core.faults import ChurnWindow, FaultPlan, RsuOutage
    from repro_torch.core.flatten import spec_of
    from repro_torch.core.heterogeneity import HeterogeneityModel
    from repro_torch.fedsim import run_serve_loop, serving
    from repro_torch.fedsim.async_engine import async_config, init_async_state
    plan = FaultPlan(churn=(ChurnWindow(frac=0.25, start=2, stop=12,
                                        seed=1),),
                     outages=(RsuOutage(rsu=1, start=3, stop=9),),
                     dup_frac=0.25, clock_skew=0.05, seed=3)
    spec = serve_spec(20, 4, serve_events=64, arrival_rate=1.5,
                      tick_trigger="batch:4,deadline:2.0", queue_capacity=16,
                      staleness_decay=0.5, buffer_keep=0.4, faults=plan,
                      het=HeterogeneityModel(csr=0.6, fsr=0.8,
                                             lar=SERVE_HP["lar"]))
    res = spec.resolve()
    draws = serve_draws(dev, res, 2 * 64 + 4)
    host_params = {k: v.cpu() for k, v in params.items()}
    card, _, cs, _ = run_serve_loop(res, params, draws=draws)
    host, _, hs, _ = run_serve_loop(
        res, host_params, device="cpu",
        draws=[tuple(t.cpu() for t in d) for d in draws])
    differ = _schedule_diff(cs, hs)
    errs = _state_diff(card, host, {k: (1e-5, 1e-5) for k in (
        "cloud_flat", "rsu_flat", "agent_flat", "rsu_mass", "cloud_macc")},
        "serve card vs host")
    print(f"serve: (b) card vs host, main fleet, Poisson batch:4,deadline:2.0"
          f", capacity 16, churn + outage + duplicates + skew, the card's "
          f"draws on both: {cs.n_ticks} ticks, drains {cs.drain_sizes}, "
          f"lost to churn {cs.events_lost_churn}, duplicated "
          f"{cs.events_duplicated}, stale rejected "
          f"{cs.events_stale_rejected}, blocked mass {cs.blocked_mass}; "
          f"counters differing: {differ or 'none'}; max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    if differ or not (cs.events_lost_churn and cs.events_duplicated
                      and cs.blocked_mass > 0):
        raise AssertionError("serve card vs host: the schedules differ or "
                             "a fault did not fire")

    # one bf16 tick from the same state on both (two card ticks in)
    bspec = spec.replace(fleet_dtype="bfloat16", faults=None)
    fspec = spec_of(params, storage_dtype="bfloat16")
    acfg = async_config(bspec).validate()
    ticks = {d: serving._make_serve_tick(res.cfg, bspec.hp, bspec.het,
                                         res.fed, fspec, acfg, device=d)
             for d in (dev, "cpu")}
    A = spec.n_agents
    arrive = (torch.arange(A, device=dev) % 2).float()
    age = (torch.arange(A, device=dev) % 3).int()
    state = init_async_state(res.cfg, fspec, params, dev)
    for d in draws[:2]:
        state, _ = ticks[dev](state, arrive, age, draw=d)
    host_state = _to_host(state)
    c, cm = ticks[dev](state, arrive, age, draw=draws[2])
    h, hm = ticks["cpu"](host_state, arrive.cpu(), age.cpu(),
                         draw=tuple(t.cpu() for t in draws[2]))
    errs = _state_diff(c, h, {"agent_flat": (2 ** -9, 2 ** -7),
                              "rsu_flat": (2 ** -9, 2 ** -7),
                              "cloud_flat": (1e-5, 1e-5),
                              "rsu_mass": (0.0, 1e-5)}, "serve bf16 tick")
    print(f"serve: (b) bf16 tick, card vs host from the same state: max abs "
          f"err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (one bf16 ulp)")


def serve_determinism(dev, params):
    """(c): a seeded Poisson run against the replay of its dumped trace,
    and a run resumed from a mid-run snapshot against the uninterrupted
    run, bit for bit on the card."""
    from repro_torch.core.faults import ChurnWindow, FaultPlan
    from repro_torch.core.load_gen import (PoissonLoadGen, agent_rates,
                                           write_trace)
    from repro_torch.fedsim import run_serve_loop
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    SERVE_DIR.mkdir(parents=True)
    fields = ("cloud_flat", "rsu_flat", "agent_flat", "rsu_mass",
              "cloud_macc")
    try:
        base = dict(serve_events=200, arrival_rate=1.5,
                    tick_trigger="batch:8,deadline:2.0", queue_capacity=64)
        res = serve_spec(20, 4, **base).resolve()
        st1, h1, s1, _ = run_serve_loop(res, params)
        trace = SERVE_DIR / "trace.jsonl"
        rates = agent_rates(res.spec.het, 20, 1.5, seed=res.cfg.seed)
        write_trace(PoissonLoadGen(rates, seed=res.cfg.seed,
                                   n_events=200).events(), trace)
        st2, h2, s2, _ = run_serve_loop(
            serve_spec(20, 4, **base, serve_trace=str(trace)).resolve(),
            params)
        same = (all(torch.equal(getattr(st1, f), getattr(st2, f))
                    for f in fields) and not _schedule_diff(s1, s2)
                and np.array_equal(h1["acc"], h2["acc"]))
        print(f"serve: (c) Poisson run against the replay of its trace: "
              f"{s1.n_ticks} ticks, bit for bit {same}")
        if not same:
            raise AssertionError("serve: the trace replay differs")

        plan = FaultPlan(churn=(ChurnWindow(frac=0.25, start=4),),
                         dup_frac=0.2, clock_skew=0.05, seed=5)
        res = serve_spec(20, 4, faults=plan, **base).resolve()
        snaps = SERVE_DIR / "snaps"
        st3, h3, s3, _ = run_serve_loop(res, params, snapshot_dir=snaps,
                                        snapshot_every=4)
        mid = 4 * (s3.n_ticks // 8)
        st4, h4, s4, _ = run_serve_loop(res, params, resume_from=snaps,
                                        resume_step=mid)
        same = (all(torch.equal(getattr(st3, f), getattr(st4, f))
                    for f in fields)
                and torch.equal(st3.conn.remaining, st4.conn.remaining)
                and torch.equal(st3.gen.get_state(), st4.gen.get_state())
                and not _schedule_diff(s3, s4)
                and np.array_equal(h3["acc"], h4["acc"]))
        print(f"serve: (c) resumed at tick {mid} of {s3.n_ticks} (churn, "
              f"duplicates, skew) against the uninterrupted run: bit for "
              f"bit {same}")
        if not same:
            raise AssertionError("serve: the resumed run differs")
    finally:
        shutil.rmtree(SERVE_DIR, ignore_errors=True)


def serve_tick_profile(dev, res, params, what, n: int = 3):
    """``n`` full-fleet ticks (every agent arriving) through the serve
    tick on ``res``'s fleet: wall a tick on the host clock, then under
    ``torch.profiler`` (host-API launches, device busy share, the ring
    kernel's and #3's device time), and the host time ``agg_absorb`` takes
    of a tick's enqueue.  Returns (ring device s a tick, #3 device s a
    tick, wall s a tick)."""
    from repro_torch.core.flatten import spec_of
    from repro_torch.fedsim import serving
    from repro_torch.fedsim.async_engine import async_config, init_async_state
    from repro_torch.kernels import ops
    s = res.spec
    fspec = spec_of(params, storage_dtype=s.fleet_dtype)
    tick = serving._make_serve_tick(res.cfg, s.hp, s.het, res.fed, fspec,
                                    async_config(s).validate(), device=dev,
                                    fused=s.fused)
    A = s.n_agents
    arrive = torch.ones(A, device=dev)
    age = torch.zeros(A, dtype=torch.int32, device=dev)
    state = [tick(init_async_state(res.cfg, fspec, params, dev), arrive,
                  age)[0]]

    def one_tick():
        state[0] = tick(state[0], arrive, age)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        one_tick()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    wall_p, launches, busy, kernels, runs = device_profile(one_tick, n)
    print_profile(what, n, wall_p, launches, busy, kernels, runs)
    ring = sum(v for k, v in kernels.items() if "agg_blend_ring_kernel" in k)
    dps = sum(v for k, v in kernels.items() if "dual_proximal_sgd" in k)

    real, spent = ops.agg_absorb, [0.0]

    def timed(*a, **kw):
        t = time.perf_counter()
        out = real(*a, **kw)
        spent[0] += time.perf_counter() - t
        return out
    ops.agg_absorb = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            one_tick()
        enqueue = (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
    finally:
        ops.agg_absorb = real
    print(f"serve: {what}: {wall * 1e3:.3f} ms a tick (host clock, "
          f"synchronised, {n} ticks); enqueueing a tick {enqueue * 1e3:.3f} "
          f"ms of host time, agg_absorb {spent[0] / n * 1e3:.3f} ms of it "
          f"({spent[0] / n / enqueue:.1%}); device a tick: ring (#1) "
          f"{ring / n * 1e3:.4f} ms, #3 {dps / n * 1e3:.4f} ms "
          f"({dps / busy if busy else 0:.1%} of device busy)")
    return ring / n, dps / n, wall


def serve_nominal(dev, params):
    """(d) and (e): the nominal load at the paper fleet (rate 1.0, trigger
    auto, capacity 4A, 20 windows, a 64-row probe every tick) after a
    warm-up run, with zero drops; three of its ticks under the profiler;
    then 4x the rate into a one-fleet queue under both overload
    policies."""
    A, R = 100, 10
    common = dict(arrival_rate=1.0, tick_trigger="auto",
                  queue_capacity=4 * A)
    res = serve_spec(A, R, serve_events=A * SERVE_WINDOWS, **common).resolve()
    probe = res.test.x[:64]
    timed_serve(serve_spec(A, R, serve_events=4 * A, **common).resolve(),
                params, probe_x=probe)                          # warm-up
    _, hist, stats, counts, seconds = timed_serve(res, params, probe_x=probe)
    s = stats.summary()
    print(f"serve: (d) nominal load, paper fleet (A={A}, R={R}), rate 1.0, "
          f"trigger auto, capacity {4 * A}, {stats.events_generated} events,"
          f" 64-row probe a tick: {stats.n_ticks} ticks in {seconds:.3f} s; "
          f"updates_per_s {s['updates_per_s']:.1f}, tick p50 "
          f"{s['tick_p50_ms']:.3f} ms p99 {s['tick_p99_ms']:.3f} ms, serve "
          f"p50 {s['serve_p50_ms']:.3f} ms, queue depth mean "
          f"{s['queue_depth_mean']:.1f} max {s['queue_depth_max']}, model "
          f"staleness mean {s['model_staleness_mean']:.2f}, dropped "
          f"{stats.events_dropped}, coalesced {stats.events_coalesced}; "
          f"accuracy {hist['acc'][0]:.4f} -> {hist['acc'][-1]:.4f}; "
          f"launches {counts}")
    if stats.events_dropped:
        raise AssertionError("nominal load dropped events")
    serve_tick_profile(dev, res, params, f"serve tick (paper fleet, A={A}, "
                       f"R={R}, every agent arriving)")

    base = dict(serve_events=A * SERVE_WINDOWS, arrival_rate=4.0,
                queue_capacity=A)
    _, _, sd, _, _ = timed_serve(serve_spec(
        A, R, tick_trigger="deadline:4.0", overload_policy="drop_oldest",
        **base).resolve(), params)
    _, _, sb, _, _ = timed_serve(serve_spec(
        A, R, tick_trigger=f"batch:{2 * A}", overload_policy="backpressure",
        **base).resolve(), params)
    for name, st in (("drop_oldest, deadline:4.0", sd),
                     (f"backpressure, batch:{2 * A}", sb)):
        sm = st.summary()
        print(f"serve: (e) overload x4, capacity {A}, {name}: generated "
              f"{st.events_generated} = absorbed {st.events_absorbed} + "
              f"coalesced {st.events_coalesced} + dropped "
              f"{st.events_dropped}; deferred {st.events_deferred}; "
              f"{st.n_ticks} ticks, event wait mean "
              f"{sm['event_wait_mean']:.3f}, model staleness mean "
              f"{sm['model_staleness_mean']:.2f}")
    if not (sd.events_generated == sd.events_absorbed + sd.events_coalesced
            + sd.events_dropped and sd.events_dropped > 0):
        raise AssertionError("drop_oldest overload: accounting or no drops")
    if not (sb.events_generated == sb.events_absorbed + sb.events_coalesced
            and sb.events_deferred > 0 and sb.events_dropped == 0):
        raise AssertionError("backpressure overload: accounting or no "
                             "deferrals")


def serve_perception(dev):
    """(g): the 784-12000-10 MLP (N = 9,540,010) at A=100, R=10, 5 ticks
    of every agent arriving once: tick wall, the ring kernel's device time
    a tick against ``agg_absorb``'s byte bound (X read once, the buffer
    read and written), and #3's share of the tick."""
    from repro_torch.core.load_gen import every_agent_once_trace
    from repro_torch.fedsim.sweep import default_params
    A, R = 100, 10
    res = serve_spec(A, R, hidden_dims=PERCEPTION_HIDDEN,
                     serve_events=5 * A,
                     tick_trigger=f"batch:{A}").resolve()
    params = default_params(res.spec, dev)
    state, _, stats, counts, seconds = timed_serve(
        res, params, gen=every_agent_once_trace(A, 5))
    N = state.cloud_flat.numel()
    lat = stats.tick_latency_s
    print(f"serve: (g) perception width (N={N:,}, A={A}, R={R}): "
          f"{stats.n_ticks} ticks in {seconds:.3f} s, tick wall "
          + ", ".join(f"{t * 1e3:.1f}" for t in lat)
          + f" ms (the first warms up); launches {counts}")
    del state
    ring, dps, wall = serve_tick_profile(
        dev, res, params, f"serve tick (perception, N={N:,})", n=2)
    bound_ms, _ = bound((A * N + 2 * R * N) * 4.0, 2.0 * A * N)
    print(f"serve: (g) agg_absorb at perception: ring {ring * 1e3:.4f} ms a "
          f"tick against its byte bound {bound_ms:.4f} ms "
          f"({bound_ms / (ring * 1e3) if ring else 0:.1%} of it); #3 "
          f"{dps * 1e3:.4f} ms a tick, {dps / wall:.1%} of the tick's wall")
    torch.cuda.empty_cache()


def serve_path(dev):
    """Phase 3v; returns the launch counts of the counted serve runs (the
    main fleet's anchor, and ``fused=False``).  Every run starts from the
    MLP's initial weights."""
    from repro_torch.fedsim.sweep import default_params
    params = default_params(serve_spec(20, 4), dev)
    counts = serve_anchor(dev, params)
    unfused = serve_launches(dev, params)
    serve_card_vs_host(dev, params)
    serve_determinism(dev, params)
    serve_nominal(dev, params)
    serve_perception(dev)
    return {"main": counts, "unfused": unfused}


# -- phase 3h: the sharded engines over torch.distributed -------------------

# the paper fleet (A = 100, R = 10) at the paper MLP's width with the
# quickstart's recipe; 3 rounds from the MLP's initial weights
SHARD_ROUNDS = 3
# ranks -> (name, spec fields (None: the tick), make_fleet_mesh kwargs):
# the paper fleet's sync rounds and the main fleet's rsu-sharded tick in
# phase 3b's straggler regime, at 1 rank over NCCL and 2 and 4 over gloo
SHARD_CASES = {
    1: (("replicated", dict(), dict()),
        ("rsu_sharded", dict(rsu_sharded=True), dict(n_pods=1)),
        ("async", None, dict(n_pods=1))),
    2: (("replicated", dict(), dict()),
        ("rsu_sharded", dict(rsu_sharded=True), dict(n_pods=2)),
        ("async", None, dict(n_pods=2))),
    4: (("replicated", dict(), dict()),
        ("rsu_sharded", dict(rsu_sharded=True), dict(n_pods=2)),
        ("async", None, dict(n_pods=2))),
}
# the N-sharded cell of benchmarks/nshard_round.py (l.44-52): the
# 784-12000-10 MLP (N = 9,540,010), A = 8 agents spread over R = 128 RSUs,
# batch 8, 80 training samples, LAR 2, CSR 0.8
NSHARD_HIDDEN, NSHARD_A, NSHARD_R, NSHARD_ROUNDS = 12_000, 8, 128, 2


def shard_spec(**kw):
    """The paper fleet under the quickstart's recipe, engine="sharded"."""
    return quickstart_spec().replace(**dict(dict(
        n_agents=100, n_rsus=10, rounds=SHARD_ROUNDS, engine="sharded"),
        **kw))


def shard_async_spec():
    """Phase 3b's straggler regime at the main fleet, 3 rounds, the
    rsu-sharded tick."""
    spec, _ = straggler_specs()
    return spec.replace(rounds=SHARD_ROUNDS, rsu_sharded=True)


def nshard_res(model_shards: int):
    """The N-sharded cell's resolved scenario, RSUs spread as the bench
    spreads them (``arange(A) * (R // A)``)."""
    import dataclasses
    from repro_torch.core.baselines import h2fed
    from repro_torch.core.heterogeneity import HeterogeneityModel
    from repro_torch.core.scenario import ScenarioSpec
    hp = h2fed(mu1=0.01, mu2=0.005, lar=2, lr=0.1)
    spec = ScenarioSpec(n_agents=NSHARD_A, n_rsus=NSHARD_R, batch=8,
                        n_train=80, n_test=100, hidden_dims=(NSHARD_HIDDEN,),
                        hp=hp, het=HeterogeneityModel(csr=0.8, lar=hp.lar),
                        rounds=NSHARD_ROUNDS, engine="sharded",
                        rsu_sharded=True, model_shards=model_shards)
    res = spec.resolve()
    assign = (np.arange(NSHARD_A) * (NSHARD_R // NSHARD_A)).astype(np.int32)
    return dataclasses.replace(res, fed=dataclasses.replace(
        res.fed, rsu_assign=assign))


def _round_ms(round_fn, state, n: int):
    """Wall of ``n`` rounds on the host clock, every rank lined up before
    and after (ms a round); returns (ms, state)."""
    import torch.distributed as dist
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        state = round_fn(state)
        if isinstance(state, tuple) and not hasattr(state, "_fields"):
            state = state[0]
    torch.cuda.synchronize()
    dist.barrier()
    return (time.perf_counter() - t0) / n * 1e3, state


def shard_rank(world: int, params: dict, device: str = "cuda") -> dict:
    """Runs on every rank of a phase 3h run: each of SHARD_CASES[world]
    through ``run_scenario`` on the card, counted (kernel launches and
    collectives set to 0 just before, read just after), then 3 more rounds
    timed; returns rank 0's view (the state on the host)."""
    from repro_torch.core.flatten import spec_of
    from repro_torch.core.topology import make_fleet_mesh
    from repro_torch.fedsim import async_engine, run_scenario
    from repro_torch.fedsim import sharded
    from repro_torch.kernels import ops
    from repro_torch.launch import collectives
    dev = torch.device(device)
    params = {k: v.to(dev) for k, v in params.items()}
    out = {}
    for name, fields, mesh_kw in SHARD_CASES[world]:
        spec = shard_async_spec() if fields is None else shard_spec(**fields)
        res = spec.resolve()
        mesh = make_fleet_mesh(**mesh_kw)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        collectives.reset()
        t0 = time.perf_counter()
        state, hist = run_scenario(res, params, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, colls = ops.launch_counts(), collectives.counts()
        topo = sharded.resolve_topology(res.cfg, res.fed, mesh,
                                        rsu_sharded=spec.rsu_sharded)
        fspec = spec_of(params)
        if fields is None:
            acfg = async_engine.async_config(spec).validate()
            round_fn = async_engine.make_sharded_async_global_round(
                res.cfg, spec.hp, spec.het, res.fed, fspec, topo, acfg,
                device=dev)
            st = async_engine.init_sharded_async_state(res.cfg, fspec,
                                                       params, topo, dev)
        else:
            round_fn = sharded.make_sharded_global_round(
                res.cfg, spec.hp, spec.het, res.fed, fspec, topo, device=dev)
            st = sharded.init_sharded_state(res.cfg, fspec, params, topo, dev)
        ms, _ = _round_ms(round_fn, st, 3)
        out[name] = {
            "mesh": dict(mesh.shape), "seconds": seconds, "round_ms": ms,
            "launches": launches, "collectives": colls, "hist": hist,
            "state": {k: getattr(state, k).cpu() for k in (
                "agent_flat", "rsu_flat", "cloud_flat", "rsu_mass",
                "pending_x", "pending_w", "pending_t", "cloud_macc")
                if hasattr(state, k)}}
    return out


def nshard_rank(model_shards: int, params: dict,
                device: str = "cuda") -> dict:
    """Runs on every rank of the N-sharded perception cell: a warm-up
    round, then NSHARD_ROUNDS rounds counted and timed; returns rank 0's
    persistent (R, N) + (N,) bytes, peak device memory, ms a round,
    launches, collectives and whole cloud (on the host)."""
    from repro_torch.core.flatten import spec_of
    from repro_torch.core.topology import make_fleet_mesh
    from repro_torch.fedsim import sharded
    from repro_torch.kernels import ops
    from repro_torch.launch import collectives
    dev = torch.device(device)
    params = {k: v.to(dev) for k, v in params.items()}
    res = nshard_res(model_shards)
    s = res.spec
    topo = sharded.resolve_topology(
        res.cfg, res.fed, make_fleet_mesh(n_model_shards=model_shards),
        rsu_sharded=True)
    fspec = spec_of(params)
    state = sharded.init_sharded_state(res.cfg, fspec, params, topo, dev)
    persistent = (state.rsu_flat.numel() * state.rsu_flat.element_size()
                  + state.cloud_flat.numel() * state.cloud_flat.element_size())
    round_fn = sharded.make_sharded_global_round(res.cfg, s.hp, s.het,
                                                 res.fed, fspec, topo,
                                                 device=dev)
    state = round_fn(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    collectives.reset()
    ms, state = _round_ms(round_fn, state, NSHARD_ROUNDS)
    launches, colls = ops.launch_counts(), collectives.counts()
    peak = torch.cuda.max_memory_allocated()
    cloud = sharded.full_cloud(state.cloud_flat, topo).cpu()
    return {"mesh": dict(topo.mesh.shape), "n": fspec.n,
            "n_pad": topo.model_pad(fspec.n), "persistent_bytes": persistent,
            "peak_bytes": peak, "round_ms": ms, "launches": launches,
            "collectives": colls, "cloud": cloud}


def _per_round(colls: dict, rounds: int) -> dict:
    """Calls and bytes a round per (where, axes), the rounds' own
    collectives (not the gather of the result, nor eval's)."""
    return {k: {"calls": v["calls"] / rounds, "bytes": v["bytes"] / rounds}
            for k, v in colls.items()
            if k.split("/")[0] in ("lar", "cloud", "round")}


def block_local_agg_cases(dev):
    """Phase 3h's #2 rows: ``ops.block_local_agg`` at the rsu-sharded
    paper fleet's pod shape (A = 50 agents of R = 5 local RSUs, N =
    31,810) and at the N-sharded cell's (A = 8 over R = 128, the padded
    N), fp32 rows, against its plain version (``index_add_``), num within
    1e-6 of the sum of |terms| of the fp64 sum, mass within 1e-6 relative
    of the exact (fp64) sum; its time, its bound (the rows read once, the
    (R, N) fp32 sums written once, and 2 A N operations: one multiply-add
    an element, the work the one-hot weights need) and ``torch.matmul``'s
    time with the same (R, A) weights."""
    from repro_torch.core.aggregation import (scatter_accumulate,
                                              unnormalized_weight_matrix)
    from repro_torch.kernels import ops
    rows = []
    for shape, A, R, N in (("paper_pod", 50, 5, 31_810),
                           ("nshard", NSHARD_A, NSHARD_R, 9_540_096)):
        gen = torch.Generator(device=dev).manual_seed(A + R)
        x = torch.randn(A, N, device=dev, generator=gen)
        w = torch.rand(A, device=dev, generator=gen) + 0.5
        assign = (torch.arange(A, device=dev) * (R // A) if A < R
                  else torch.arange(A, device=dev) % R)
        w[assign == 0] = 0.0                # a weightless RSU block
        got, mass = ops.block_local_agg(x, w, assign, R)
        want, _ = scatter_accumulate(x, w, assign, R)
        W = unnormalized_weight_matrix(w, torch.ones_like(w), assign, R)
        exact = torch.zeros(R, dtype=torch.float64, device=dev).index_add_(
            0, assign, w.double())
        scale = W.abs() @ x.abs()
        excess = ((got - want).abs() - 2e-6 * scale).max().item()
        err = (got - want).abs().max().item()
        safe = torch.where(exact > 0, exact, torch.ones_like(exact))
        mass_err = ((mass.double() - exact).abs() / safe).max().item()
        if excess > 0 or mass_err > 1e-6 or got[0].any():
            raise AssertionError(f"block_local_agg {shape}: the kernel "
                                 f"disagrees with the plain version "
                                 f"({err:.3e}) or its mass with the exact "
                                 f"sum (relative {mass_err:.1e})")
        del scale
        b_ms, b_by = bound(A * N * 4 + R * N * 4 + A * 12, 2 * A * N)
        row = {"kernel": "weighted_agg_matmul", "entry": "block_local_agg",
               "shape": shape, "A": A, "R": R, "N": N, "dtype": "float32",
               "max_abs_err": err,
               "ms": cuda_ms(lambda: ops.block_local_agg(x, w, assign, R)),
               "plain_ms": cuda_ms(lambda: scatter_accumulate(x, w, assign,
                                                              R)),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": cuda_ms(lambda: torch.matmul(W, x))}
        print("kernel " + json.dumps(row))
        rows.append(row)
        del x, got, want
        torch.cuda.empty_cache()
    return rows


def _shard_limit(what, err, limit):
    print(f"shard: {what}: {err:.3e} (limit {limit})")
    _limit(what, err, limit)


# (atol, rtol) of a sharded round's fields against the flat round's or
# the async engine's on the card.  #2's sums, summed across ranks, then
# normalized, differ from #1's (flat) or one rank's (async) in last bits.
# The aggregates (RSU rows, the cloud) hold the limit of phase 3's
# card-vs-host and phase 3t's streamed-vs-resident checks; an agent row is
# one more SGD step from an RSU row, where a last-bit difference can flip
# a hidden ReLU unit and move the row by lr times a gradient term; the
# masses are sums of the same weights in another order.
SHARD_TOL = {"agent_flat": (1e-3, 0.0), "pending_x": (1e-3, 0.0),
             "rsu_flat": (1e-4, 0.0), "cloud_flat": (1e-4, 0.0),
             "rsu_mass": (0.0, 1e-5), "pending_w": (0.0, 1e-5),
             "cloud_macc": (0.0, 1e-5)}


def _diffs(a: dict, b, fields) -> dict:
    """Max |a - b| of each field, a rank's state on the host against an
    engine's state on the card; raises past ``SHARD_TOL``."""
    errs = {}
    for k in fields:
        g, w = a[k].float(), getattr(b, k).cpu().float()
        atol, rtol = SHARD_TOL[k]
        errs[k] = (g - w).abs().max().item()
        if not torch.isfinite(g).all() or (
                (g - w).abs() > atol + rtol * w.abs()).any():
            raise AssertionError(f"{k}: {errs[k]:.3e} past atol {atol}, "
                                 f"rtol {rtol}")
    return errs


def sharded_path(dev):
    """Phase 3h; returns (#2's rows at the block_local_agg shapes, the
    launch counts of the counted sharded runs, summed over ranks' rank 0
    and cases)."""
    from repro_torch.fedsim import run_scenario
    from repro_torch.fedsim.sweep import default_params
    from repro_torch.launch.mesh import run_ranks
    params = default_params(shard_spec(), dev)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    # the references on the card: the flat round and the async engine
    flat_state, flat_h = run_scenario(shard_spec(engine="flat"), params,
                                      device=dev)
    from repro_torch.core.flatten import spec_of
    fspec = spec_of(params)
    flat = type("Flat", (), {
        "agent_flat": fspec.ravel_stacked(flat_state.agent_params),
        "rsu_flat": fspec.ravel_stacked(flat_state.rsu_params),
        "cloud_flat": fspec.ravel(flat_state.cloud_params)})
    round_profile(dev, shard_spec(engine="flat").resolve(), params,
                  what="flat round (paper fleet, phase 3h)")
    aspec = shard_async_spec()
    async_state, async_h = run_scenario(aspec.replace(rsu_sharded=False,
                                                      fused=False),
                                        params, device=dev)
    totals: dict = {}
    for world in (1, 2, 4):
        t0 = time.perf_counter()
        out = run_ranks(world, shard_rank, world, cpu_params,
                        backend="nccl" if world == 1 else "gloo",
                        device="cuda")
        print(f"shard: {world} rank(s) over "
              f"{'nccl' if world == 1 else 'gloo'}: "
              f"{time.perf_counter() - t0:.2f} s with the ranks' start")
        for name, r in out.items():
            is_async = name == "async"
            want, want_h = ((async_state, async_h) if is_async
                            else (flat, flat_h))
            fields = ("agent_flat", "rsu_flat", "cloud_flat") + (
                ("rsu_mass", "pending_x", "pending_w", "cloud_macc")
                if is_async else ())
            errs = _diffs(r["state"], want, fields)
            acc = float(abs(r["hist"]["acc"] - want_h["acc"]).max())
            rounds = SHARD_ROUNDS
            per = _per_round(r["collectives"], rounds)
            print(f"shard: {world} rank(s), {name} on {r['mesh']}: against "
                  f"the {'async' if is_async else 'flat'} engine on the "
                  f"card, buffers max abs diff "
                  f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } "
                  f"(limits {SHARD_TOL}), "
                  f"accuracy {r['hist']['acc'].tolist()} vs "
                  f"{want_h['acc'].tolist()} (equal: "
                  f"{bool(acc == 0.0)}); {r['round_ms']:.2f} ms a round "
                  f"(host clock, 3 rounds, eval excluded); run_scenario "
                  f"{r['seconds']:.2f} s; rank 0's launches {r['launches']}; "
                  f"collectives a round {per}")
            if acc > 2e-3:
                raise AssertionError(f"{world} ranks, {name}: disagrees "
                                     f"with the reference engine")
            # the rsu-sharded rounds' RSU layer stays inside its pod (the
            # replicated round sums over every agent axis by design)
            pod_lar = sum(v["calls"] for k, v in r["collectives"].items()
                          if k.startswith("lar/") and "pod" in k)
            if name != "replicated" and pod_lar:
                raise AssertionError(f"{name}: {pod_lar} collectives across "
                                     f"pods inside the local-round loop")
            if (name == "rsu_sharded" and "pod" in r["mesh"]
                    and r["mesh"]["pod"] > 1 and
                    r["collectives"]["cloud/pod"]["calls"] != rounds):
                raise AssertionError(f"rsu_sharded: cloud collectives "
                                     f"{r['collectives']}")
            for k, v in r["launches"].items():
                totals[k] = totals.get(k, 0) + v
        if not (out["replicated"]["launches"]["block_local_agg"]
                and out["async"]["launches"]["block_local_agg"]
                and out["rsu_sharded"]["launches"]["dual_proximal_sgd"]):
            raise AssertionError(f"{world} ranks: a sharded run missed a "
                                 f"kernel")

    # the N-sharded perception cell: model_shards 1 (one rank, nccl)
    # against 2 (two ranks sharing the card, gloo)
    from repro_torch.configs.mnist_mlp import CONFIG
    import dataclasses
    from repro_torch.models import mlp
    big = mlp.init_params(dataclasses.replace(
        CONFIG, hidden_dims=(NSHARD_HIDDEN,)), torch.Generator().manual_seed(0))
    cells = {}
    for shards in (1, 2):
        t0 = time.perf_counter()
        cells[shards] = r = run_ranks(shards, nshard_rank, shards, big,
                                      backend="nccl" if shards == 1
                                      else "gloo", device="cuda")
        print(f"shard: N-sharded cell (784-{NSHARD_HIDDEN}-10, N={r['n']}, "
              f"padded {r['n_pad']}; A={NSHARD_A}, R={NSHARD_R}) at "
              f"model_shards {shards} on {r['mesh']}: persistent (R, N) + "
              f"(N,) {r['persistent_bytes'] / 1e9:.4f} GB a rank, peak "
              f"device memory {r['peak_bytes'] / 1e9:.4f} GB a rank, "
              f"{r['round_ms']:.2f} ms a round (host clock, "
              f"{NSHARD_ROUNDS} rounds after a warm-up); rank 0's launches "
              f"{r['launches']}; collectives a round "
              f"{_per_round(r['collectives'], NSHARD_ROUNDS)} "
              f"({time.perf_counter() - t0:.2f} s with the ranks' start)")
        for k, v in r["launches"].items():
            totals[k] = totals.get(k, 0) + v
    ratio = cells[2]["persistent_bytes"] / cells[1]["persistent_bytes"]
    _shard_limit("N-sharded persistent bytes a rank, 2 shards over 1", ratio,
                 0.51)
    n = cells[1]["n"]
    c1, c2 = cells[1]["cloud"], cells[2]["cloud"]
    _shard_limit("N-sharded cloud, 2 shards against 1, max abs diff",
                 (c2[:n] - c1[:n]).abs().max().item(), 1e-5)
    print(f"shard: N-sharded clouds bitwise equal: "
          f"{torch.equal(c1[:n], c2[:n])}; padded tail zero: "
          f"{not c2[n:].any()}")
    if c2[n:].any() or not torch.isfinite(c2).all():
        raise AssertionError("N-sharded cloud: the padded tail moved or a "
                             "value is not finite")
    rows = block_local_agg_cases(dev)
    return rows, totals


def live_pairs(S: int, causal: bool, window: int, T=None) -> int:
    """(query, key) pairs the masks keep (``launch/dryrun.live_pairs``):
    keys t < S, t <= s when causal, t > s - window when window > 0; S * T
    for S queries over T keys of their own length (non-causal, no
    window)."""
    from repro_torch.launch import dryrun
    return dryrun.live_pairs(S, S if T is None else T, causal, window)


def attention_bound(B, S, H, KV, D, causal, window, dtype, Dv=None,
                    T=None):
    """(bound ms, bound_by): q, k, v read and out written once; 2*(D + Dv)
    flops per live pair and head (QK^T over D, PV over v's Dv), at the
    dtype's peak.  T: the keys' length when it is not S."""
    Dv = D if Dv is None else Dv
    T = S if T is None else T
    sx = torch.finfo(dtype).bits // 8
    nbytes = (B * S * H * (D + Dv) + B * T * KV * (D + Dv)) * sx
    flops = 2 * B * H * (D + Dv) * live_pairs(S, causal, window, T)
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    return bound(nbytes, flops, peak)


def sdpa_call(q, k, v, causal, window):
    """One ``scaled_dot_product_attention`` call on the same inputs (the
    library yardstick, timed only); k/v repeated to H heads first.  Where
    v is narrower than q and k (MLA) and no fused SDPA backend (flash,
    memory-efficient, cuDNN) takes it, v is zero-padded to q's width and
    the call's output sliced back, as the reference pads it (the call's
    ``padded_v`` attribute says which)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    kw = dict(is_causal=causal)
    if window:
        S = q.shape[1]
        pos = torch.arange(S, device=q.device)
        mask = pos[None, :] > pos[:, None] - window
        if causal:
            mask &= pos[None, :] <= pos[:, None]
        kw = dict(attn_mask=mask)
    if v.shape[-1] == q.shape[-1]:
        call = lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)  # noqa: E731
        call.padded_v = False
        return call
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    try:
        with sdpa_kernel(fused):
            F.scaled_dot_product_attention(qt, kt, vt, **kw)

        def call():
            with sdpa_kernel(fused):
                return F.scaled_dot_product_attention(qt, kt, vt, **kw)
        call.padded_v = False
    except RuntimeError:
        Dv = v.shape[-1]
        vp = F.pad(vt, (0, q.shape[-1] - Dv))

        def call():
            return F.scaled_dot_product_attention(qt, kt, vp,
                                                  **kw)[..., :Dv]
        call.padded_v = True
    return call


def check_lse(q, k, v, kw, what) -> float:
    """The bf16 forward that also saves the log-sum-exp: its output held
    to the plain version at ``TOL``, its lse to ``ref.attention_lse_ref``
    within 1e-5 relative with a floor of 1e-5 of the largest value (fp32
    scores and sums in another order); returns the lse's max abs error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    compare(out, ref.flash_attention_ref(q, k, v, **kw), torch.bfloat16,
            f"{what} with lse")
    want = ref.attention_lse_ref(q, k, **kw)
    return compare(lse, want, torch.float32, f"{what} lse",
                   tol=(1e-5 * want.abs().max().item(), 1e-5))


def attention_cases(dev):
    """Phase 2b; returns result rows.  Launches made here are comparisons,
    not the serving path's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rows = []
    for name, B, S, H, KV, D, causal, window in ATTN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(S + H)
            q, k, v = (torch.randn(B, S, n, D, device=dev,
                                   generator=gen).to(dtype)
                       for n in (H, KV, KV))
            kw = dict(causal=causal, window=window)
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            err = compare(got, want, dtype, f"flash_attention {name} {dtype}")
            del got, want
            b_ms, b_by = attention_bound(B, S, H, KV, D, causal, window,
                                         dtype)
            call = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
            rows.append({
                "kernel": "flash_attention", "entry": name,
                "kernel_route": fa.forward_route(dtype, D, D, S, causal,
                                                 window),
                "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D,
                          "causal": causal, "window": window},
                "dtype": str(dtype)[6:], "max_abs_err": err,
                "ms": cuda_ms(call),
                "plain_ms": cuda_ms(
                    lambda: ref.flash_attention_ref(q, k, v, **kw)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": cuda_ms(sdpa_call(q, k, v, causal, window))})
            if dtype == torch.bfloat16:
                # in turns with the call that saves the log-sum-exp
                rows[-1]["ms"], rows[-1]["ms_with_lse"] = cuda_ms_pair(
                    call, lambda: fa.flash_attention(q, k, v,
                                                     return_lse=True, **kw))
                if D == 64:
                    rows[-1]["lse_err"] = check_lse(
                        q, k, v, kw, f"flash_attention {name}")
                    rows[-1].update(host_device_split(call))
                    rows[-1]["library_device_ms"] = host_device_split(
                        sdpa_call(q, k, v, causal, window))["device_ms"]
            print("kernel " + json.dumps(rows[-1]))
            del q, k, v
            torch.cuda.empty_cache()
    # the serving path's shape (B=4, S=8192): the plain version runs one
    # batch row at a time (about 4.3 GB of fp32 scores a row, some 13-17 GB
    # with its intermediates), against the kernel's output at full B
    B, S, H, KV, D = PREFILL_B, PREFILL_S, 16, 8, 128
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(B, S, n, D, device=dev, generator=gen).to(
        torch.bfloat16) for n in (H, KV, KV))

    def plain_by_row():
        return torch.cat([ref.flash_attention_ref(q[b:b + 1], k[b:b + 1],
                                                  v[b:b + 1])
                          for b in range(B)])
    got = fa.flash_attention(q, k, v)
    err = max(compare(got[b:b + 1], ref.flash_attention_ref(
        q[b:b + 1], k[b:b + 1], v[b:b + 1]), torch.bfloat16,
        f"flash_attention prefill row {b}") for b in range(B))
    del got
    torch.cuda.empty_cache()
    b_ms, b_by = attention_bound(B, S, H, KV, D, True, 0, torch.bfloat16)
    ms, ms_lse = cuda_ms_pair(lambda: fa.flash_attention(q, k, v),
                              lambda: fa.flash_attention(q, k, v,
                                                         return_lse=True),
                              reps=6, inner=2)
    rows.append({
        "kernel": "flash_attention", "entry": "prefill",
        "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D, "causal": True,
                  "window": 0},
        "dtype": "bfloat16", "max_abs_err": err,
        "ms": ms, "ms_with_lse": ms_lse,
        "plain_ms": cuda_ms(plain_by_row), "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": cuda_ms(sdpa_call(q, k, v, True, 0), reps=5, inner=2)})
    print("kernel " + json.dumps(rows[-1]))
    del q, k, v
    torch.cuda.empty_cache()
    rows += mla_attention_cases(dev)
    rows += head_dim_attention_cases(dev, 80)
    rows += head_dim_attention_cases(dev, 96)
    rows += head_dim_attention_cases(dev, 192)
    rows += dense_prefill_attention_cases(dev)
    rows += cross_attention_cases(dev)
    return rows


def mla_attention_cases(dev):
    """Phase 2b at MLA's head dims (q/k 192, v 128, deepseek-v2-lite's 16
    heads): the layer causal and with a 1024 window, S=129 causal, S=1000
    non-causal, bf16 and fp32; then the prefill shape (B=4, S=8192) in
    bf16, the plain version one batch row at a time."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def inputs(B, S, H, KV, dtype, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k = (torch.randn(B, S, n, MLA_DQK, device=dev,
                            generator=gen).to(dtype) for n in (H, KV))
        v = torch.randn(B, S, KV, MLA_DV, device=dev,
                        generator=gen).to(dtype)
        return q, k, v

    def row(name, B, S, H, KV, causal, window, dtype, err, ms, plain_ms,
            lib):
        b_ms, b_by = attention_bound(B, S, H, KV, MLA_DQK, causal, window,
                                     dtype, Dv=MLA_DV)
        r = {"kernel": "flash_attention_mla", "entry": name,
             "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": MLA_DQK,
                       "Dv": MLA_DV, "causal": causal, "window": window},
             "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": cuda_ms(lib, reps=5, inner=2),
             "library_padded_v": lib.padded_v}
        print("kernel " + json.dumps(r))
        return r

    rows = []
    for name, B, S, H, KV, causal, window in MLA_ATTN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = inputs(B, S, H, KV, dtype, S + H)
            kw = dict(causal=causal, window=window)
            err = compare(fa.flash_attention(q, k, v, **kw),
                          ref.flash_attention_ref(q, k, v, **kw), dtype,
                          f"flash_attention_mla {name} {dtype}")
            rows.append(row(
                name, B, S, H, KV, causal, window, dtype, err,
                cuda_ms(lambda: fa.flash_attention(q, k, v, **kw)),
                cuda_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                        reps=5, inner=2),
                sdpa_call(q, k, v, causal, window)))
            del q, k, v
            torch.cuda.empty_cache()
    B, S, H = PREFILL_B, PREFILL_S, 16
    q, k, v = inputs(B, S, H, H, torch.bfloat16, 1)

    def plain_by_row():
        return torch.cat([ref.flash_attention_ref(q[b:b + 1], k[b:b + 1],
                                                  v[b:b + 1])
                          for b in range(B)])
    got = fa.flash_attention(q, k, v)
    err = max(compare(got[b:b + 1], ref.flash_attention_ref(
        q[b:b + 1], k[b:b + 1], v[b:b + 1]), torch.bfloat16,
        f"flash_attention_mla prefill row {b}") for b in range(B))
    del got
    torch.cuda.empty_cache()
    rows.append(row("prefill", B, S, H, H, True, 0, torch.bfloat16, err,
                    cuda_ms(lambda: fa.flash_attention(q, k, v), reps=6,
                            inner=2),
                    cuda_ms(plain_by_row, reps=3, inner=1),
                    sdpa_call(q, k, v, True, 0)))
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def plain_in_chunks(q, k, v, max_heads: int = 32, **kw):
    """The plain version (causal unless ``kw`` says otherwise) one batch
    row and at most ``max_heads`` heads (whole GQA groups) at a time, so
    that its fp32 scores at S = 8192 stay under ~9 GB a chunk
    (nemotron-4-340b's 96 heads a row would take 26 GB); at H <= 32 a
    chunk is a batch row."""
    from repro_torch.kernels import ref
    G = q.shape[2] // k.shape[2]
    per = max(1, max_heads // G)          # KV heads a chunk
    return torch.cat([torch.cat([ref.flash_attention_ref(
        q[b:b + 1, :, j * G:(j + per) * G], k[b:b + 1, :, j:j + per],
        v[b:b + 1, :, j:j + per], **kw) for j in range(0, k.shape[2], per)],
        dim=2) for b in range(q.shape[0])])


def prefill_attention_row(dev, kernel, name, B, S, H, KV, D, seed=1):
    """#4 at a prefill shape in bf16, causal: held to ``plain_in_chunks``
    elementwise at ``TOL``, its time, bound, the plain version's time and
    one SDPA call's; counted under ``kernel``."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, D, device=dev, generator=gen).to(
        torch.bfloat16) for n in (H, KV, KV))
    err = compare(fa.flash_attention(q, k, v), plain_in_chunks(q, k, v),
                  torch.bfloat16, f"{kernel} {name}")
    torch.cuda.empty_cache()
    b_ms, b_by = attention_bound(B, S, H, KV, D, True, 0, torch.bfloat16)
    r = {"kernel": kernel, "entry": name,
         "kernel_route": fa.forward_route(torch.bfloat16, D, D, S, True, 0),
         "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D, "causal": True,
                   "window": 0},
         "dtype": "bfloat16", "max_abs_err": err,
         "ms": cuda_ms(lambda: fa.flash_attention(q, k, v), reps=6, inner=2),
         "plain_ms": cuda_ms(lambda: plain_in_chunks(q, k, v), reps=3,
                             inner=1),
         "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": cuda_ms(sdpa_call(q, k, v, True, 0), reps=5,
                               inner=2)}
    print("kernel " + json.dumps(r))
    del q, k, v
    torch.cuda.empty_cache()
    return r


def dense_prefill_attention_cases(dev):
    """Phase 2b: #4 at D = 128 at yi-34b's and command-r-35b's prefill
    shapes (B=4, S=8192, GQA 56 / 8 and 64 / 8), what each of their
    prefill launches computes."""
    return [prefill_attention_row(dev, "flash_attention", name, PREFILL_B,
                                  PREFILL_S, H, KV, 128)
            for name, H, KV in DENSE_PREFILL_HEADS]


def head_dim_attention_cases(dev, D: int):
    """Phase 2b at head dim ``D`` (80: zamba2-2.7b, 96: phi-3-vision-4.2b,
    192: nemotron-4-340b), counted as ``flash_attention_d{D}``: the dim's
    ``HEAD_DIM_CASES`` in bf16 and fp32, at a dim the backward takes (80,
    96) each bf16 case also with the log-sum-exp saved (``check_lse``,
    ``lse_err``), then its prefill shape (``HEAD_DIM_PREFILL``, causal) in
    bf16, the plain version in ``plain_in_chunks``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    kernel = f"flash_attention_d{D}"

    def inputs(B, S, H, KV, dtype, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tuple(torch.randn(B, S, n, D, device=dev,
                                 generator=gen).to(dtype)
                     for n in (H, KV, KV))

    def row(name, B, S, H, KV, causal, window, dtype, err, ms, plain_ms,
            lib_ms):
        b_ms, b_by = attention_bound(B, S, H, KV, D, causal, window, dtype)
        r = {"kernel": kernel, "entry": name,
             "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D,
                       "causal": causal, "window": window},
             "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib_ms}
        print("kernel " + json.dumps(r))
        return r

    rows = []
    for name, B, S, H, KV, causal, window in HEAD_DIM_CASES[D]:
        name = f"d{D}_{name}"
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = inputs(B, S, H, KV, dtype, S + H)
            kw = dict(causal=causal, window=window)
            err = compare(fa.flash_attention(q, k, v, **kw),
                          ref.flash_attention_ref(q, k, v, **kw), dtype,
                          f"{kernel} {name} {dtype}")
            rows.append(row(
                name, B, S, H, KV, causal, window, dtype, err,
                cuda_ms(lambda: fa.flash_attention(q, k, v, **kw)),
                cuda_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                        reps=5, inner=2),
                cuda_ms(sdpa_call(q, k, v, causal, window), reps=5,
                        inner=2)))
            if dtype == torch.bfloat16 and D in fa.BWD_HEAD_DIMS:
                rows[-1]["lse_err"] = check_lse(q, k, v, kw,
                                                f"{kernel} {name}")
            del q, k, v
            torch.cuda.empty_cache()
    B, S, H, KV = HEAD_DIM_PREFILL[D]
    rows.append(prefill_attention_row(dev, kernel, "prefill", B, S, H, KV,
                                      D))
    return rows


def cross_attention_cases(dev):
    """Phase 2b with keys of their own length (``CROSS_ATTN_CASES``, S
    queries over T keys, non-causal) in bf16 and fp32: error against the
    plain version, the kernel's time, its bound over the S x T pairs and
    one ``scaled_dot_product_attention`` call's time."""
    return [cross_attention_row(dev, case, dtype)
            for case in CROSS_ATTN_CASES
            for dtype in (torch.bfloat16, torch.float32)]


def cross_attention_row(dev, case, dtype) -> dict:
    """One ``CROSS_ATTN_CASES``-style case (name, B, S, T, H, KV, D) in
    ``dtype``: the kernel against its plain version, its time, bound and
    SDPA's time (bf16 D = 64 also with the lse and the host/device
    split); prints and returns the row."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    name, B, S, T, H, KV, D = case
    gen = torch.Generator(device=dev).manual_seed(S + T + D)
    q = torch.randn(B, S, H, D, device=dev, generator=gen).to(dtype)
    k, v = (torch.randn(B, T, KV, D, device=dev,
                        generator=gen).to(dtype) for _ in range(2))
    err = compare(fa.flash_attention(q, k, v, causal=False),
                  ref.flash_attention_ref(q, k, v, causal=False),
                  dtype, f"flash_attention_cross {name} {dtype}")
    b_ms, b_by = attention_bound(B, S, H, KV, D, False, 0, dtype, T=T)
    r = {"kernel": "flash_attention_cross", "entry": name,
         "kernel_route": fa.forward_route(dtype, D, D, S, False, 0),
         "shape": {"B": B, "S": S, "T": T, "H": H, "KV": KV,
                   "D": D, "causal": False, "window": 0},
         "dtype": str(dtype)[6:], "max_abs_err": err,
         "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=False)),
         "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(
             q, k, v, causal=False), reps=5, inner=2),
         "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": cuda_ms(sdpa_call(q, k, v, False, 0),
                               reps=5, inner=2)}
    if dtype == torch.bfloat16 and D == 64:
        r["lse_err"] = check_lse(q, k, v, dict(causal=False),
                                 f"flash_attention_cross {name}")
        r.update(host_device_split(
            lambda: fa.flash_attention(q, k, v, causal=False)))
        r["library_device_ms"] = host_device_split(
            sdpa_call(q, k, v, False, 0))["device_ms"]
    print("kernel " + json.dumps(r))
    del q, k, v
    torch.cuda.empty_cache()
    return r


def slstm_inputs(dev, B, S, H, P, r_dtype, scale=1.0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = H * P
    wx = torch.randn(B, S, 4 * d, device=dev, generator=gen) * scale
    r = (torch.randn(H, P, 4 * P, device=dev, generator=gen)
         * P ** -0.5).to(r_dtype)
    b = torch.randn(4 * d, device=dev, generator=gen) * 0.1
    return wx, r, b


def slstm_cases(dev):
    """Phase 2c; returns result rows.  Launches made here are comparisons,
    not the serving path's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm_scan as ss

    rows = []
    for name, B, S, H, P, scale in SLSTM_CASES:
        for r_dtype in (torch.bfloat16, torch.float32):
            wx, r, b = slstm_inputs(dev, B, S, H, P, r_dtype, scale, seed=S)
            got = ss.slstm_scan(wx, r, b)
            want = ref.slstm_scan_ref(wx, r, b)
            err = compare(got, want, torch.float32,
                          f"slstm_scan {name} {r_dtype}", SLSTM_TOL[scale])
            del got, want
            d = H * P
            nbytes = (B * S * 4 * d + B * S * d + 4 * d) * 4 \
                + r.numel() * r.element_size()
            b_ms, b_by = bound(nbytes, 2 * B * S * d * 4 * P)
            row = {"kernel": "slstm_scan", "entry": name,
                   "shape": {"B": B, "S": S, "H": H, "P": P, "scale": scale},
                   "r_dtype": str(r_dtype)[6:], "plan": ss.plan(d, P, r_dtype),
                   "max_abs_err": err,
                   "ms": cuda_ms(lambda: ss.slstm_scan(wx, r, b)),
                   "plain_ms": cuda_ms(lambda: ref.slstm_scan_ref(wx, r, b),
                                       reps=3, inner=1),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            if name == "layer":
                # the same S steps at the smallest width the kernel runs
                fw, fr, fb = slstm_inputs(dev, 1, S, 1, 8, r_dtype)
                row["latency_floor_ms"] = cuda_ms(
                    lambda: ss.slstm_scan(fw, fr, fb))
                row["us_per_step"] = row["ms"] / S * 1e3
            rows.append(row)
            print("kernel " + json.dumps(row))
            del wx, r, b
    torch.cuda.empty_cache()
    return rows


def device_profile(fn, n: int):
    """``fn`` run ``n`` times under ``torch.profiler``: (wall s, kernel
    launches the host API saw, device busy s, {kernel: device s},
    {device activity: executions}).  Wall includes the profiler's own
    cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, runs, launches = {}, {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = e.self_device_time_total / 1e6
            runs[e.key] = e.count
        elif e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches += e.count
    return wall, launches, sum(kernels.values()), kernels, runs


def print_profile(what: str, n: int, wall, launches, busy, kernels,
                  runs) -> None:
    if not busy:
        print(f"profile: {what}: the profiler saw no device time (not "
              f"measured)")
        return
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile: {what}: {wall / n * 1e3:.2f} ms wall a call, "
          f"{launches / n:.0f} kernel launches a call (host API), "
          f"{sum(runs.values()) / n:.0f} device executions a call, device "
          f"busy {busy / wall:.1%} of wall; top kernels by device time: "
          + "; ".join(f"{k[:60]} {v / busy:.1%}" for k, v in top))


def _logits_check(got, want, what, atol, rtol):
    """Max |got - want| of fp32 logits; raises unless finite and
    |d| <= atol + rtol*|want|."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite logits")
    d = (g - w).abs()
    if (d > atol + rtol * w.abs()).any():
        raise AssertionError(f"{what}: max abs diff {d.max().item():.3e} "
                             f"exceeds atol {atol} + rtol {rtol}")
    return d.max().item()


def serving_path(dev):
    """Phase 4; returns the flash_attention launches of the counted
    prefill call."""
    from repro_torch.configs.registry import get_config, get_reduced_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M
    from repro_torch import tree

    cfg = get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"serving: qwen3-0.6b full width, {n_params} params "
          f"({cfg.param_dtype}), drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    # prefill at B=4, S=8192: one counted call, then timed calls
    prefill = make_prefill_step(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           device=dev, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    counts = prefill_counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if counts["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"prefill: {counts['flash_attention']} "
                             f"flash_attention launches, want "
                             f"{cfg.n_layers}")
    if (tuple(logits.shape) != (PREFILL_B, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"prefill: bad logits {tuple(logits.shape)}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    print(f"serving: prefill B={PREFILL_B} S={PREFILL_S}: {ms:.1f} ms a call "
          f"(median of 3, host clock), "
          f"{PREFILL_B * PREFILL_S / ms * 1e3:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB, launches {counts}")
    prof = device_profile(lambda: prefill(params, {"tokens": tokens}), 1)
    print_profile(f"prefill B={PREFILL_B} S={PREFILL_S}", 1, *prof)
    attn = sum(v for k, v in prof[3].items() if "flash_attention" in k)
    if prof[2]:
        print(f"profile: prefill: flash_attention kernels {attn * 1e3:.1f} "
              f"ms of {prof[2] * 1e3:.1f} ms device time "
              f"({attn / prof[2]:.1%})")
    del tokens, logits
    torch.cuda.empty_cache()

    # the serve launcher at its defaults, full width (decode path: no
    # flash_attention launch)
    ops.reset_launch_counts()
    res = serve.main(["--full-config"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"serving: serve launcher --full-config: decode "
          f"{res['tok_per_s']:.1f} tok/s, launches {counts}")
    if not torch.isfinite(res["logits"]).all():
        raise AssertionError("serve: non-finite logits")

    # decode == prefill at every position, full width (1 x 64 tokens)
    s = 64
    toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                         generator=gen)
    with torch.no_grad():
        full, _ = M.forward(cfg, params, {"tokens": toks})
        cache = M.init_cache(cfg, 1, s, device=dev)
        outs = []
        for t in range(s):
            lg, cache = M.decode_step(cfg, params, cache, toks[:, t:t + 1],
                                      torch.tensor([t], dtype=torch.int32,
                                                   device=dev))
            outs.append(lg[:, 0])
    err = _logits_check(torch.stack(outs, 1), full, "decode vs prefill",
                        0.15, 0.05)
    print(f"serving: decode vs prefill logits, 1x{s} tokens, full width: "
          f"max abs diff {err:.4f} (limit 0.15 + 0.05|logit|)")
    del full, cache, outs

    # where a decode step's time goes: batch 8, as the serve launcher
    decode_step_profile(dev, cfg, params, gen, "decode step")

    # one prefill with a 1024 window at S=4096
    wcfg = cfg.replace(attn_window=1024)
    wtoks = torch.randint(0, cfg.vocab_size, (1, 4096), device=dev,
                          generator=gen)
    ops.reset_launch_counts()
    wlogits = make_prefill_step(wcfg, device=dev)(params, {"tokens": wtoks})
    torch.cuda.synchronize()
    if (ops.launch_counts()["flash_attention"] != cfg.n_layers
            or not torch.isfinite(wlogits).all()):
        raise AssertionError("window prefill: launches or logits wrong")
    print(f"serving: window 1024 prefill at S=4096: "
          f"{cfg.n_layers} launches, finite logits")
    del params
    torch.cuda.empty_cache()

    # a reduced qwen3 on the card against the host's plain versions
    rcfg = get_reduced_config("qwen3-0.6b")
    reduced_card_vs_host(dev, "serving", "qwen3-0.6b", rcfg,
                         {"flash_attention": rcfg.n_layers})
    return prefill_counts["flash_attention"]


def xlstm_serving(dev):
    """Phase 4b; returns the slstm_scan launches of the counted prefill
    call."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_config, get_reduced_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import model as M

    cfg = get_config("xlstm-125m")
    n_slstm = sum(r for p, r in cfg.layout_ if p == "slstm")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"xlstm: xlstm-125m full width, {n_params} params "
          f"({cfg.param_dtype}), drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    # prefill at B=4, S=8192: one counted call, then timed calls
    prefill = make_prefill_step(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           device=dev, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    counts = prefill_counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if counts["slstm_scan"] != n_slstm or counts["flash_attention"]:
        raise AssertionError(f"xlstm prefill launches {counts}, want "
                             f"{n_slstm} slstm_scan and no flash_attention")
    if (tuple(logits.shape) != (PREFILL_B, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"xlstm prefill: bad logits "
                             f"{tuple(logits.shape)}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    print(f"xlstm: prefill B={PREFILL_B} S={PREFILL_S}: {ms:.1f} ms a call "
          f"(median of 3, host clock), "
          f"{PREFILL_B * PREFILL_S / ms * 1e3:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB, launches {counts}")
    prof = device_profile(lambda: prefill(params, {"tokens": tokens}), 1)
    print_profile(f"xlstm prefill B={PREFILL_B} S={PREFILL_S}", 1, *prof)
    scan = sum(v for k, v in prof[3].items() if "slstm_scan" in k)
    if prof[2]:
        print(f"profile: xlstm prefill: slstm_scan kernels {scan * 1e3:.1f} "
              f"ms of {prof[2] * 1e3:.1f} ms device time "
              f"({scan / prof[2]:.1%})")
    del tokens, logits
    torch.cuda.empty_cache()

    # the serve launcher, full width (decode path: no slstm_scan launch)
    ops.reset_launch_counts()
    res = serve.main(["--arch", "xlstm-125m", "--full-config"])
    torch.cuda.synchronize()
    print(f"xlstm: serve launcher --arch xlstm-125m --full-config: decode "
          f"{res['tok_per_s']:.1f} tok/s, launches {ops.launch_counts()}")
    if not torch.isfinite(res["logits"]).all():
        raise AssertionError("xlstm serve: non-finite logits")

    # decode == prefill at every position, full width (1 x 64 tokens).
    # Decode runs the per-step mLSTM and the reference's sLSTM step, which
    # rounds h and h @ R to bf16; the full config's prefill runs the
    # chunkwise mLSTM and the scan kernel, which keeps h in fp32 as its
    # plain version does.  The forms are equal in exact arithmetic, but in
    # bf16 their rounding differs by about the bf16 tolerance, the plain
    # scan's prefill as much as the kernel's.  So decode is held to both
    # prefills in fp32 (the same weights, widened), the kernel's bf16
    # prefill to the same prefill with the plain scan in its place, and
    # the bf16 gaps between decode and the prefills are printed.
    s = 64
    toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                         generator=gen)

    def decode_all(c, p):
        cache = M.init_cache(c, 1, s, device=dev)
        outs = []
        for t in range(s):
            lg, cache = M.decode_step(c, p, cache, toks[:, t:t + 1],
                                      torch.tensor([t], dtype=torch.int32,
                                                   device=dev))
            outs.append(lg[:, 0])
        return torch.stack(outs, 1)

    def prefill_logits(c, p):
        return M.forward(c, p, {"tokens": toks})[0]
    step_cfg = cfg.replace(mlstm_chunk=0)
    with torch.no_grad():
        dec = decode_all(cfg, params)
        step_pre = prefill_logits(step_cfg, params)
        kernel_scan = ops.slstm_scan
        ops.slstm_scan = ref.slstm_scan_ref
        try:
            plain_pre = prefill_logits(step_cfg, params)
        finally:
            ops.slstm_scan = kernel_scan
        err = _logits_check(step_pre, plain_pre,
                            "xlstm bf16 prefill, kernel vs plain scan", 0.15,
                            0.05)
        chunk_pre = prefill_logits(cfg, params)
        gaps = [(dec - x).abs().max().item()
                for x in (step_pre, plain_pre, chunk_pre)]
        cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
        p32 = tree.map_tree(lambda t: t.float(), params)
        dec32 = decode_all(cfg32, p32)
        err32 = [_logits_check(dec32, prefill_logits(c, p32),
                               f"xlstm fp32 decode vs {name} prefill", 1e-3,
                               0.0)
                 for name, c in (("per-step", cfg32.replace(mlstm_chunk=0)),
                                 ("chunkwise", cfg32))]
    print(f"xlstm: 1x{s} tokens, full width: bf16 prefill with the scan "
          f"kernel vs with the plain scan max abs diff {err:.4f} (limit 0.15 "
          f"+ 0.05|logit|); fp32 decode vs the per-step and the chunkwise "
          f"prefill {err32[0]:.3e}, {err32[1]:.3e} (limit 1e-3); bf16 decode "
          f"vs the per-step prefill with the kernel {gaps[0]:.4f}, with the "
          f"plain scan {gaps[1]:.4f}, vs the chunkwise prefill {gaps[2]:.4f} "
          f"(not checks)")
    del dec, step_pre, plain_pre, chunk_pre, p32, dec32

    # where a decode step's time goes: batch 8, as the serve launcher
    B, n = 8, 8
    step = make_serve_step(cfg, device=dev)
    cache = M.init_cache(cfg, B, 2 * n, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=dev, generator=gen)

    def decode_once():
        step(params, cache, tok, torch.zeros((B,), dtype=torch.int32,
                                             device=dev))
    decode_once()
    print_profile(f"xlstm decode step, batch {B}", n,
                  *device_profile(decode_once, n))
    del cache, params
    torch.cuda.empty_cache()

    # a reduced xlstm on the card (the kernel) against the host (the plain
    # per-step scan), same params
    reduced_card_vs_host(dev, "xlstm", "xlstm-125m",
                         get_reduced_config("xlstm-125m"), {"slstm_scan": 3})
    return prefill_counts["slstm_scan"]


# -- phase 4c: deepseek-v2-lite-16b serving (MLA + MoE) ----------------------

MOE_ARCH, KIMI_ARCH = "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"


def _no_drops(cfg):
    """``cfg`` with capacity_factor = n_experts: no group drops a token, so
    a 1-token decode group and a 64-token prefill group route alike (the
    reference's own decode check, tests/test_arch_smoke.py:137-144)."""
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def reduced_card_vs_host(dev, tag, arch, rcfg, counted, seq: int = 48,
                         extra=None):
    """A reduced ``arch`` on the card against the host's plain versions
    with the same params: fp32 prefill logits of 2 x ``seq`` tokens within
    1e-3 and equal greedy tokens, bf16 within atol 0.15 / rtol 0.05; the
    counted prefill must launch ``counted`` ({launch key: launches}).
    ``extra``: the batch's other inputs (CPU tensors with a batch of 2:
    ``memory``, which the greedy decode attends too, or
    ``patch_embeds``).  Lines start ``tag:``."""
    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M
    for dtype, atol, rtol in (("float32", 1e-3, 0.0),
                              ("bfloat16", 0.15, 0.05)):
        c = rcfg.replace(dtype=dtype, param_dtype=dtype)
        host = M.init_params(c, torch.Generator().manual_seed(3),
                             device="cpu")
        card = tree.map_tree(lambda t: t.to(dev), host)
        ptoks = torch.from_numpy(np.random.default_rng(4).integers(
            0, c.vocab_size, (2, seq)))
        batch = {"tokens": ptoks, **(extra or {})}
        ops.reset_launch_counts()
        lg_card = make_prefill_step(c, device=dev)(card, batch)
        torch.cuda.synchronize()
        got = {k: ops.launch_counts()[k] for k in counted}
        if got != counted:
            raise AssertionError(f"reduced {arch} prefill launches "
                                 f"{ops.launch_counts()}, want {counted}")
        lg_host = make_prefill_step(c, device="cpu")(host, batch)
        err = _logits_check(lg_card.cpu(), lg_host,
                            f"{arch} card vs host {dtype}", atol, rtol)
        memory = batch.get("memory")
        dec_card = serve.greedy_decode(c, card, ptoks, 8, device=dev,
                                       memory=memory)
        dec_host = serve.greedy_decode(c, host, ptoks, 8, device="cpu",
                                       memory=memory)
        same = bool(np.array_equal(dec_card["tokens"], dec_host["tokens"]))
        print(f"{tag}: reduced {arch} {dtype} ({counted} launches a "
              f"prefill), card vs host: prefill logits max abs diff "
              f"{err:.3e}, greedy tokens equal: {same}")
        if dtype == "float32":
            if not same:
                raise AssertionError(f"{arch} fp32 greedy tokens differ: "
                                     f"{dec_card['tokens']} vs "
                                     f"{dec_host['tokens']}")
            err = _logits_check(dec_card["logits"].cpu(), dec_host["logits"],
                                f"{arch} card vs host fp32 decode", atol,
                                rtol)
            print(f"{tag}: reduced {arch} float32, card vs host: last "
                  f"decode logits max abs diff {err:.3e}")


def decode_step_profile(dev, cfg, params, gen, what: str, n: int = 8):
    """Where a decode step's time goes at batch 8, as the serve launcher
    decodes: one warm-up step from a fresh cache, then ``n`` steps under
    ``torch.profiler``."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import model as M
    B = 8
    step = make_serve_step(cfg, device=dev)
    cache = M.init_cache(cfg, B, 2 * n, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=dev, generator=gen)
    pos = [0]

    def decode_once():
        nonlocal cache
        _, cache = step(params, cache, tok, torch.full(
            (B,), pos[0], dtype=torch.int32, device=dev))
        pos[0] += 1
    decode_once()
    print_profile(f"{what}, batch {B}", n, *device_profile(decode_once, n))


def kernel_kind(name: str) -> str:
    """A kernel's kind by its name, for a device-time breakdown."""
    low = name.lower()
    for kind, keys in (("#4 attention", ("flash_attention",)),
                       ("GEMMs", ("gemm", "nvjet", "cutlass", "xmma")),
                       ("index / gather / scatter", ("index",)),
                       ("sort", ("sort", "radix")),
                       ("scans (cumsum)", ("scan",)),
                       ("reductions", ("reduce",)),
                       ("elementwise / copies", ("elementwise", "copy",
                                                 "memcpy", "memset",
                                                 "fill", "cat"))):
        if any(k in low for k in keys):
            return kind
    return "other"


def print_kinds(what: str, prof) -> None:
    """A ``device_profile``'s device time by ``kernel_kind``."""
    busy, kernels = prof[2], prof[3]
    if not busy:
        return
    shares = {}
    for k, v in kernels.items():
        shares[kernel_kind(k)] = shares.get(kernel_kind(k), 0.0) + v
    print(f"profile: {what}: {busy * 1e3:.1f} ms device time: " + "; ".join(
        f"{kind} {v * 1e3:.1f} ms ({v / busy:.1%})"
        for kind, v in sorted(shares.items(), key=lambda kv: -kv[1])))


def _full_params(dev, cfg, tag, depth="full width and depth"):
    """``cfg``'s params drawn on the card from seed 0, held to
    ``count_params_analytic``: (params, their bytes); ``depth`` says how
    the config was cut, for the printed line."""
    from repro_torch import tree
    from repro_torch.models import model as M
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    if n_params != M.count_params_analytic(cfg):
        raise AssertionError(f"{cfg.name}: {n_params} params drawn, "
                             f"{M.count_params_analytic(cfg)} counted")
    print(f"{tag}: {cfg.name} {depth}, {n_params} params "
          f"({w_bytes / 1e9:.2f} GB, {cfg.param_dtype}; attention head dim "
          f"{cfg.head_dim_}), drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    return params, w_bytes


def _counted_prefill(dev, tag, cfg, prefill, params, batch, want, w_bytes,
                     n_tokens):
    """One prefill call with the launch counts set to 0 just before and
    read just after: #4's counts must be ``want`` exactly (every other
    attention count 0), the logits (B, V) finite.  Then 3 timed calls (ms,
    tokens/s over ``n_tokens`` a call, peak memory) and one call under
    ``torch.profiler`` (busy share, top kernels, device time by kind).
    Returns the counts."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    attention = {k: v for k, v in counts.items()
                 if k.startswith("flash_attention")}
    if attention != {**dict.fromkeys(attention, 0), **want}:
        raise AssertionError(f"{cfg.name} prefill launches {counts}, want "
                             f"{want} and no other attention")
    B = batch["tokens"].shape[0]
    if (tuple(logits.shape) != (B, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} prefill: bad logits "
                             f"{tuple(logits.shape)}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    shape = "x".join(str(n) for n in batch["tokens"].shape)
    print(f"{tag}: prefill tokens {shape}: {ms:.2f} ms a call (median of 3, "
          f"host clock; {', '.join(f'{t * 1e3:.2f}' for t in times)}), "
          f"{n_tokens} positions a call, {n_tokens / ms * 1e3:.0f} "
          f"positions/s, peak memory "
          f"{peak / 1e9:.2f} GB ({w_bytes / 1e9:.2f} GB of weights), "
          f"launches {counts}")
    prof = device_profile(lambda: prefill(params, batch), 1)
    print_profile(f"{cfg.name} prefill {shape}", 1, *prof)
    print_kinds(f"{cfg.name} prefill", prof)
    return counts


def moe_serving(dev):
    """Phase 4c; returns the flash_attention_mla launches of the counted
    prefill call."""
    from repro_torch.configs.registry import get_config, get_reduced_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M

    cfg = get_config(MOE_ARCH)
    params, w_bytes = _full_params(dev, cfg, "moe")
    print(f"moe: {M.count_params_analytic(cfg, active_only=True)} params "
          f"active a token")

    # prefill at B=4, S=8192: one counted call, then timed calls
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           device=dev, generator=gen)
    counts = _counted_prefill(
        dev, "moe", cfg, make_prefill_step(cfg, device=dev), params,
        {"tokens": tokens}, {"flash_attention_mla": cfg.n_layers}, w_bytes,
        PREFILL_B * PREFILL_S)
    del tokens
    torch.cuda.empty_cache()

    # decode == prefill at every position, full width (1 x 64 tokens), no
    # capacity drops
    ncfg = _no_drops(cfg)
    s = 64
    toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                         generator=gen)
    with torch.no_grad():
        full, _ = M.forward(ncfg, params, {"tokens": toks})
        cache = M.init_cache(ncfg, 1, s, device=dev)
        outs = []
        for t in range(s):
            lg, cache = M.decode_step(ncfg, params, cache, toks[:, t:t + 1],
                                      torch.tensor([t], dtype=torch.int32,
                                                   device=dev))
            outs.append(lg[:, 0])
    err = _logits_check(torch.stack(outs, 1), full,
                        f"{MOE_ARCH} decode vs prefill", 0.15, 0.05)
    print(f"moe: decode vs prefill logits, 1x{s} tokens, full width, "
          f"capacity_factor {ncfg.moe.capacity_factor:g}: max abs diff "
          f"{err:.4f} (limit 0.15 + 0.05|logit|)")
    del full, cache, outs

    # where a decode step's time goes: batch 8, as the serve launcher
    decode_step_profile(dev, cfg, params, gen, f"{MOE_ARCH} decode step")
    del params
    torch.cuda.empty_cache()

    # the serve launcher at its defaults, full width (its own params)
    ops.reset_launch_counts()
    res = serve.main(["--arch", MOE_ARCH, "--full-config"])
    torch.cuda.synchronize()
    print(f"moe: serve launcher --arch {MOE_ARCH} --full-config: decode "
          f"{res['tok_per_s']:.1f} tok/s, launches {ops.launch_counts()}")
    if not torch.isfinite(res["logits"]).all():
        raise AssertionError(f"{MOE_ARCH} serve: non-finite logits")
    try:
        serve.main(["--arch", KIMI_ARCH, "--full-config"])
    except ValueError as e:
        print(f"moe: serve launcher --arch {KIMI_ARCH} --full-config "
              f"refused: {e}")
    else:
        raise AssertionError(f"{KIMI_ARCH} --full-config was not refused")
    del res
    torch.cuda.empty_cache()

    # reduced models on the card against the host: deepseek cut in depth,
    # width, experts and vocab but with MLA's full head dims (q/k 192, v
    # 128), so that #4's MLA variant runs; kimi-k2 (GQA, D = 64)
    rcfg = get_reduced_config(MOE_ARCH).replace(mla=cfg.mla)
    reduced_card_vs_host(dev, "moe", MOE_ARCH, rcfg,
                         {"flash_attention_mla": rcfg.n_layers})
    kcfg = get_reduced_config(KIMI_ARCH)
    reduced_card_vs_host(dev, "moe", KIMI_ARCH, kcfg,
                         {"flash_attention": kcfg.n_layers})
    return counts["flash_attention_mla"]


# -- phase 4d: zamba2-2.7b serving (Mamba-2 + a weight-shared attention) ---

HYBRID_ARCH = "zamba2-2.7b"


def _decode_vs_prefill(cfg, params, toks, dev, memory=None):
    """(decode logits at every position from a fresh cache, the forward's
    logits) of tokens (B, S), no grad; an audio model attends ``memory``
    in both."""
    from repro_torch.models import model as M
    B, s = toks.shape
    batch = {"tokens": toks}
    if memory is not None:
        batch["memory"] = memory
    with torch.no_grad():
        full, _ = M.forward(cfg, params, batch)
        cache = M.init_cache(cfg, B, s, device=dev)
        outs = []
        for t in range(s):
            lg, cache = M.decode_step(cfg, params, cache, toks[:, t:t + 1],
                                      torch.full((B,), t, dtype=torch.int32,
                                                 device=dev), memory=memory)
            outs.append(lg[:, 0])
    return torch.stack(outs, 1), full


def hybrid_serving(dev):
    """Phase 4d; returns the flash_attention_d80 launches of the counted
    prefill call."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_config, get_reduced_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M

    cfg = get_config(HYBRID_ARCH)
    n_apps = cfg.layout_[0][1]          # applications of the shared block
    params, w_bytes = _full_params(dev, cfg, "hybrid")

    # (a) prefill at B=4, S=8192: one counted call, then timed calls; the
    # shared block's attention launches once an application
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           device=dev, generator=gen)
    counts = _counted_prefill(
        dev, "hybrid", cfg, make_prefill_step(cfg, device=dev), params,
        {"tokens": tokens}, {"flash_attention_d80": n_apps}, w_bytes,
        PREFILL_B * PREFILL_S)
    del tokens
    torch.cuda.empty_cache()

    # (b) decode == prefill at every position, full width (1 x 64 tokens):
    # fp32 at the reference's fp32 tolerance, and the bf16 gap
    s = 64
    toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                         generator=gen)
    c32 = cfg.replace(dtype="float32", param_dtype="float32")
    p32 = tree.map_tree(lambda t: t.float(), params)
    dec, full = _decode_vs_prefill(c32, p32, toks, dev)
    err = _logits_check(dec, full, f"{HYBRID_ARCH} fp32 decode vs prefill",
                        1e-3, 0.05)
    del p32, dec, full
    torch.cuda.empty_cache()
    dec, full = _decode_vs_prefill(cfg, params, toks, dev)
    gap = (dec.float() - full.float()).abs().max().item()
    print(f"hybrid: decode vs prefill logits, 1x{s} tokens, full width: "
          f"fp32 max abs diff {err:.3e} (limit 1e-3 + 0.05|logit|), bf16 "
          f"{gap:.4f}")
    del dec, full

    # (c) where a decode step's time goes: batch 8, as the serve launcher
    decode_step_profile(dev, cfg, params, gen, f"{HYBRID_ARCH} decode step")
    del params
    torch.cuda.empty_cache()

    # (d) the serve launcher at its defaults, full width (its own params)
    ops.reset_launch_counts()
    res = serve.main(["--arch", HYBRID_ARCH, "--full-config"])
    torch.cuda.synchronize()
    print(f"hybrid: serve launcher --arch {HYBRID_ARCH} --full-config: "
          f"decode {res['tok_per_s']:.1f} tok/s, launches "
          f"{ops.launch_counts()}")
    if not torch.isfinite(res["logits"]).all():
        raise AssertionError(f"{HYBRID_ARCH} serve: non-finite logits")
    del res
    torch.cuda.empty_cache()

    # (e) a reduced zamba2 at head dim 80, so #4 at 80 runs: the card
    # against the host, and bf16 decode against prefill on the card, at 37
    # tokens (the reduced chunk is 16)
    rcfg = get_reduced_config(HYBRID_ARCH).replace(head_dim=80)
    reduced_card_vs_host(dev, "hybrid", HYBRID_ARCH, rcfg,
                         {"flash_attention_d80": rcfg.layout_[0][1]},
                         seq=37)
    rp = M.init_params(rcfg, torch.Generator(device=dev).manual_seed(3),
                       device=dev)
    rtoks = torch.from_numpy(np.random.default_rng(4).integers(
        0, rcfg.vocab_size, (2, 37))).to(dev)
    err = _logits_check(*_decode_vs_prefill(rcfg, rp, rtoks, dev),
                        f"reduced {HYBRID_ARCH} bf16 decode vs prefill",
                        0.15, 0.05)
    print(f"hybrid: reduced {HYBRID_ARCH} (head dim 80) bf16 decode vs "
          f"prefill on the card, 2x37 tokens: max abs diff {err:.4f} "
          f"(limit 0.15 + 0.05|logit|)")
    return counts["flash_attention_d80"]


# -- phase 4e: whisper-tiny serving (the encdec stack, cross-attention) ----

AUDIO_ARCH = "whisper-tiny"


def audio_serving(dev):
    """Phase 4e; returns the launches of the counted prefill call and
    those of one decode step."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_config, get_reduced_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import model as M

    cfg = get_config(AUDIO_ARCH)
    L, M_frames = cfg.n_layers, cfg.encoder.n_positions
    params, w_bytes = _full_params(dev, cfg, "audio")

    # (a) prefill at B=32 over the 448-token decoder context, 1500 frames
    # of memory a row: L self-attention and L cross-attention launches
    gen = torch.Generator(device=dev).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (AUDIO_B, AUDIO_S),
                                     device=dev, generator=gen),
             "memory": torch.randn(AUDIO_B, M_frames, cfg.encoder.d_embed,
                                   device=dev, generator=gen)}
    counts = _counted_prefill(
        dev, "audio", cfg, make_prefill_step(cfg, device=dev), params, batch,
        {"flash_attention": L, "flash_attention_cross": L}, w_bytes,
        AUDIO_B * AUDIO_S)
    del batch
    torch.cuda.empty_cache()

    # (b) decode == prefill at every position of 2 x 32 tokens with the
    # same memory: fp32 at the reference's fp32 tolerance, and the bf16 gap
    s = 32
    toks = torch.randint(0, cfg.vocab_size, (2, s), device=dev,
                         generator=gen)
    mem = torch.randn(2, M_frames, cfg.encoder.d_embed, device=dev,
                      generator=gen)
    c32 = cfg.replace(dtype="float32", param_dtype="float32")
    p32 = tree.map_tree(lambda t: t.float(), params)
    err = _logits_check(*_decode_vs_prefill(c32, p32, toks, dev, mem),
                        f"{AUDIO_ARCH} fp32 decode vs prefill", 1e-3, 0.05)
    del p32
    dec, full = _decode_vs_prefill(cfg, params, toks, dev, mem)
    gap = (dec.float() - full.float()).abs().max().item()
    print(f"audio: decode vs prefill logits, 2x{s} tokens over {M_frames} "
          f"frames, full width: fp32 max abs diff {err:.3e} (limit 1e-3 + "
          f"0.05|logit|), bf16 {gap:.4f}")
    del dec, full

    # (c) a decode step at batch 8, as the serve launcher: L
    # cross-attention launches of one query over the frames
    B, n = 8, 8
    step = make_serve_step(cfg, device=dev)
    cache = M.init_cache(cfg, B, 2 * n, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=dev, generator=gen)
    memory = torch.randn(B, M_frames, cfg.encoder.d_embed, device=dev,
                         generator=gen)
    pos = [0]

    def decode_once():
        nonlocal cache
        _, cache = step(params, cache, tok, torch.full(
            (B,), pos[0], dtype=torch.int32, device=dev), memory)
        pos[0] += 1
    ops.reset_launch_counts()
    decode_once()
    torch.cuda.synchronize()
    step_counts = ops.launch_counts()
    if step_counts["flash_attention_cross"] != L:
        raise AssertionError(f"{AUDIO_ARCH} decode step launches "
                             f"{step_counts}, want {L} flash_attention_cross")
    print_profile(f"{AUDIO_ARCH} decode step, batch {B}", n,
                  *device_profile(decode_once, n))
    del cache, params, memory
    torch.cuda.empty_cache()

    # (d) the serve launcher at its defaults, full width (its own params,
    # the memory drawn from its seed as the reference's launcher draws it)
    ops.reset_launch_counts()
    res = serve.main(["--arch", AUDIO_ARCH, "--full-config"])
    torch.cuda.synchronize()
    launched = ops.launch_counts()
    print(f"audio: serve launcher --arch {AUDIO_ARCH} --full-config: decode "
          f"{res['tok_per_s']:.1f} tok/s, launches {launched}")
    if not torch.isfinite(res["logits"]).all():
        raise AssertionError(f"{AUDIO_ARCH} serve: non-finite logits")
    if launched["flash_attention_cross"] != L * (32 + 32):
        raise AssertionError(f"{AUDIO_ARCH} serve: {launched} launches, "
                             f"want {L} flash_attention_cross a step")
    del res
    torch.cuda.empty_cache()

    # (e) the reduced whisper on the card against the host: 48 tokens over
    # 16 frames of memory (T != S, so the cross-attention's launches are
    # counted as such)
    rcfg = get_reduced_config(AUDIO_ARCH)
    rmem = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, rcfg.encoder.n_positions, rcfg.encoder.d_embed)).astype(
            np.float32))
    reduced_card_vs_host(dev, "audio", AUDIO_ARCH, rcfg,
                         {"flash_attention": rcfg.n_layers,
                          "flash_attention_cross": rcfg.n_layers},
                         extra={"memory": rmem})
    return counts, step_counts


# -- phase 4f: phi-3-vision-4.2b serving (the VLM input merge, head dim 96) -

VISION_ARCH = "phi-3-vision-4.2b"


def vision_serving(dev):
    """Phase 4f; returns the launches of the counted prefill call."""
    import dataclasses

    from repro_torch.configs.registry import get_config, get_reduced_config
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step

    cfg = get_config(VISION_ARCH)
    params, w_bytes = _full_params(dev, cfg, "vision")

    # (a) prefill at B=4: 576 patch embeddings and 3,520 text tokens a row,
    # 4,096 positions through 32 layers, one #4 launch at 96 a layer
    gen = torch.Generator(device=dev).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (VLM_B, VLM_TOKENS),
                                     device=dev, generator=gen),
             "patch_embeds": torch.randn(VLM_B, VLM_PATCHES,
                                         cfg.encoder.d_embed, device=dev,
                                         generator=gen)}
    counts = _counted_prefill(
        dev, "vision", cfg, make_prefill_step(cfg, device=dev), params, batch,
        {"flash_attention_d96": cfg.n_layers}, w_bytes,
        VLM_B * (VLM_PATCHES + VLM_TOKENS))
    del batch
    torch.cuda.empty_cache()

    # (b) text decode == text prefill at every position of 1 x 64 tokens:
    # a VLM decodes text from a fresh cache, so the prefill is the
    # language backbone's alone (the same params, no patches); bf16 at
    # the serving path's tolerance
    s = 64
    toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                         generator=gen)
    text = cfg.replace(encoder=dataclasses.replace(cfg.encoder, kind="none"))
    err = _logits_check(*_decode_vs_prefill(text, params, toks, dev),
                        f"{VISION_ARCH} decode vs prefill", 0.15, 0.05)
    print(f"vision: text decode vs prefill logits, 1x{s} tokens, full "
          f"width, bf16: max abs diff {err:.4f} (limit 0.15 + "
          f"0.05|logit|)")
    del params
    torch.cuda.empty_cache()

    # (c) the text decode launcher refuses the VLM, as the reference's
    try:
        serve.main(["--arch", VISION_ARCH, "--full-config"])
    except SystemExit as e:
        print(f"vision: serve launcher --arch {VISION_ARCH} refused: {e}")
    else:
        raise AssertionError(f"{VISION_ARCH}: the serve launcher took a VLM")

    # (d) a reduced phi-3 at head dim 96 (so #4 at 96 runs) on the card
    # against the host, 16 patches before 48 tokens
    rcfg = get_reduced_config(VISION_ARCH).replace(head_dim=96)
    patches = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, rcfg.encoder.n_positions, rcfg.encoder.d_embed)).astype(
            np.float32))
    reduced_card_vs_host(dev, "vision", VISION_ARCH, rcfg,
                         {"flash_attention_d96": rcfg.n_layers},
                         extra={"patch_embeds": patches})
    return counts


# -- phase 4g: the dense model zoo (yi-34b, command-r-35b, nemotron-4-340b) -

DENSE_ARCHS = ("yi-34b", "command-r-35b")
NEMOTRON_ARCH = "nemotron-4-340b"
# layers each config is cut to for (a) and (b), full width: nemotron's 96
# do not fit one card; yi's 60 and command-r's 40 do, but take 90 of the
# phase's 132-166 s at full depth, which the whole script's 1,200 s limit
# no longer holds beside the training phase (its serve launcher below
# still runs each at full depth)
DENSE_LAYERS = {"yi-34b": 12, "command-r-35b": 8, NEMOTRON_ARCH: 2}


def dense_serving(dev):
    """Phase 4g; returns the #4 launches of the counted prefill calls, by
    arch: {arch: {launch key: launches}}."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.config import reduced

    counts = {}
    s = 64
    # (a) yi-34b and command-r-35b, (b) nemotron, each at full width and
    # its ``DENSE_LAYERS``: drawn, its prefill counted and timed, decode
    # held to prefill, its params freed before the next
    for arch in (*DENSE_ARCHS, NEMOTRON_ARCH):
        cut = arch == NEMOTRON_ARCH       # its full config is refused
        cfg = get_config(arch).replace(n_layers=DENSE_LAYERS[arch])
        params, w_bytes = _full_params(
            dev, cfg, "dense", f"full width, {cfg.n_layers} of "
            f"{get_config(arch).n_layers} layers")
        key = ("flash_attention_d192" if cfg.head_dim_ == 192
               else "flash_attention")
        gen = torch.Generator(device=dev).manual_seed(2)
        tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                               device=dev, generator=gen)
        c = _counted_prefill(
            dev, "dense", cfg, make_prefill_step(cfg, device=dev), params,
            {"tokens": tokens}, {key: cfg.n_layers}, w_bytes,
            PREFILL_B * PREFILL_S)
        counts[arch] = {key: c[key]}
        del tokens
        torch.cuda.empty_cache()

        toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                             generator=gen)
        err = _logits_check(*_decode_vs_prefill(cfg, params, toks, dev),
                            f"{arch} decode vs prefill", 0.15, 0.05)
        print(f"dense: {arch} decode vs prefill logits, 1x{s} tokens, "
              f"bf16: max abs diff {err:.4f} (limit 0.15 + 0.05|logit|)")
        decode_step_profile(dev, cfg, params, gen, f"{arch} decode step")
        del params
        torch.cuda.empty_cache()

        # the serve launcher at its defaults (batch 8, 32 + 32 tokens),
        # its own params; its peak held to the reckoning it refuses by
        full = get_config(arch)
        argv = ["--arch", arch, "--full-config"]
        base = torch.cuda.memory_allocated(dev)
        if cut:
            try:
                serve.main(argv)
            except ValueError as e:
                print(f"dense: serve launcher {' '.join(argv)} refused: {e}")
            else:
                raise AssertionError(f"{arch} --full-config was not refused")
            if torch.cuda.memory_allocated(dev) != base:
                raise AssertionError(f"{arch}: the refusal allocated")
            continue
        need = serve.peak_bytes(full, 8, 64)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        res = serve.main(argv)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        print(f"dense: serve launcher {' '.join(argv)}: decode "
              f"{res['tok_per_s']:.1f} tok/s, peak {peak / 1e9:.2f} GB "
              f"(reckoned {need['total'] / 1e9:.2f}: params "
              f"{need['params'] / 1e9:.2f}, cache {need['cache'] / 1e9:.3f}, "
              f"transient {need['transient'] / 1e9:.2f}), launches "
              f"{ops.launch_counts()}")
        if not torch.isfinite(res["logits"]).all():
            raise AssertionError(f"{arch} serve: non-finite logits")
        if peak > need["total"]:
            raise AssertionError(f"{arch} serve: peak {peak} bytes over the "
                                 f"reckoned {need['total']}")
        del res
        torch.cuda.empty_cache()

    # (c) reduced configs on the card against the host: yi at a GQA group
    # of 7 (head dim 64), nemotron at its head dim 192 (squared-ReLU)
    rcfg = reduced(get_config("yi-34b"), d_model=448, n_heads=7,
                   n_kv_heads=1)
    reduced_card_vs_host(dev, "dense", "yi-34b", rcfg,
                         {"flash_attention": rcfg.n_layers})
    rcfg = reduced(get_config(NEMOTRON_ARCH), d_model=384, n_heads=2,
                   n_kv_heads=1)
    reduced_card_vs_host(dev, "dense", NEMOTRON_ARCH, rcfg,
                         {"flash_attention_d192": rcfg.n_layers})
    return counts


# -- phase 4h and --dryrun: the reference's shapes on one card ---------------
#
# the cells phase 4h runs at full width (a decode step each): qwen3 over
# the long_500k ring (8,192 slots, position 524,287), whisper's batch 128
# over 32,768 positions and 1,500 frames, xlstm's batch 128 states
DRYRUN_CELLS = (("qwen3-0.6b", "long_500k"), ("whisper-tiny", "decode_32k"),
                ("xlstm-125m", "decode_32k"))
# #4's launches a whisper decode_32k step: one split-key cross-attention a
# layer
WHISPER_STEP = {"flash_attention_cross": 4}
# the cells that fit one H100 80GB and run, each with its kernels'
# launches a call and #4's routes (qwen3's 28 layers, xlstm's 3 sLSTM
# blocks, whisper's 4 decoder layers); every other cell is reckoned not to
# fit but whisper long_500k, which is skipped
DRYRUN_RUNS = {
    ("qwen3-0.6b", "prefill_32k"): ({"flash_attention": 28},
                                    {"flash_attention:tma_wgmma": 28}),
    ("qwen3-0.6b", "long_500k"): ({}, {}),
    ("xlstm-125m", "prefill_32k"): ({"slstm_scan": 3}, {}),
    ("xlstm-125m", "decode_32k"): ({}, {}),
    ("xlstm-125m", "long_500k"): ({}, {}),
    ("zamba2-2.7b", "long_500k"): ({}, {}),
    ("deepseek-v2-lite-16b", "long_500k"): ({}, {}),
    ("whisper-tiny", "prefill_32k"): (
        {"flash_attention": 4, "flash_attention_cross": 4},
        {"flash_attention:tma_wgmma": 4,
         "flash_attention_cross:tma_wgmma": 4}),
    ("whisper-tiny", "decode_32k"): (
        WHISPER_STEP, {"flash_attention_cross:split_keys": 4}),
    ("phi-3-vision-4.2b", "long_500k"): ({}, {}),
    ("yi-34b", "long_500k"): ({}, {}),
    ("command-r-35b", "long_500k"): ({}, {})}
# the plain version's fp32 scores a chunk, at most (``plain_in_chunks`` at
# the run cells' shapes)
PLAIN_CHUNK_BYTES = 9e9
LONG_FIRST = 524_280     # the reduced card-vs-host decode: 524,280-524,287


def _held_to_reckoning(rec) -> None:
    """A run cell's measured peak must not pass its reckoning, nor, where
    the cell drew its params, the draw's peak the reckoning's draw term
    (the params, the fp32 slice drawn at once and the runtime
    allowance)."""
    m, need = rec["measured"], rec["reckoned"]
    what = f"dryrun {rec['arch']} {rec['shape']}"
    if m["peak_bytes"] > need["total"]:
        raise AssertionError(f"{what}: peak {m['peak_bytes']} bytes over "
                             f"the reckoned {need['total']}")
    draw = need["params"] + need["draw"] + need["runtime"]
    if m["draw_peak_bytes"] is not None and m["draw_peak_bytes"] > draw:
        raise AssertionError(f"{what}: the params' draw peaked at "
                             f"{m['draw_peak_bytes']} bytes, over the "
                             f"reckoned {draw}")


def _held_to_launches(rec) -> None:
    """A run cell's launches a call and #4's routes must be
    ``DRYRUN_RUNS``'s."""
    want = DRYRUN_RUNS[(rec["arch"], rec["shape"])]
    if (rec["launches"], rec["routes"]) != want:
        raise AssertionError(f"dryrun {rec['arch']} {rec['shape']}: "
                             f"launches {rec['launches']} routes "
                             f"{rec['routes']} a call, want {want}")


def dryrun_reckoning(dev) -> None:
    """Every (architecture x shape) cell reckoned on the meta device, one
    line each; nothing may be allocated."""
    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.launch import dryrun, steps
    base = torch.cuda.memory_allocated(dev)
    have = steps.card_bytes(dev)
    cells = [(a, s) for a in ARCH_IDS for s in steps.SHAPES]
    for arch, shape, desc, need in dryrun.reckon_cells(cells):
        if need is None:
            print(f"dryrun: {arch} {shape}: skipped")
            continue
        print(f"dryrun: {arch} {shape} ({desc}): reckoned "
              f"{need['total'] / 1e9:.2f} GB, fits "
              f"{need['total'] <= have} (params "
              f"{need['params'] / 1e9:.2f}, cache "
              f"{need['cache'] / 1e9:.2f}, state "
              f"{need['state'] / 1e9:.2f}, transient "
              f"{need['transient'] / 1e9:.2f})")
    if torch.cuda.memory_allocated(dev) != base:
        raise AssertionError("dryrun: the reckoning allocated device memory")


def long_card_vs_host(dev) -> None:
    """The reduced qwen3 with ``long_500k``'s window on the card against
    the host's plain versions: the same params and the same ring (8,192
    slots filled from a seed for position 524,280), 8 decode steps at
    positions 524,280-524,287 (RoPE past 2^19, the ring slot idx % 8192):
    fp32 logits within 1e-3 and equal greedy tokens, bf16 atol 0.15 /
    rtol 0.05."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    cfg = steps.shape_adapted_config(get_reduced_config("qwen3-0.6b"),
                                     "long_500k")
    B, n, seq = 2, 8, steps.SHAPES["long_500k"]["seq"]
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, n)))
    for dtype, atol, rtol in (("float32", 1e-3, 0.0),
                              ("bfloat16", 0.15, 0.05)):
        c = cfg.replace(dtype=dtype, param_dtype=dtype)
        host = M.init_params(c, torch.Generator().manual_seed(3),
                             device="cpu")
        card = tree.map_tree(lambda t: t.to(dev), host)
        h_cache = steps.fill_cache(M.init_cache(c, B, seq, device="cpu"),
                                   torch.Generator().manual_seed(5),
                                   LONG_FIRST)
        c_cache = M.init_cache(c, B, seq, device=dev)
        for dst, src in zip(tree.leaves(c_cache), tree.leaves(h_cache)):
            dst.copy_(src)
        h_step = steps.make_serve_step(c, device="cpu")
        c_step = steps.make_serve_step(c, device=dev)
        worst, same = 0.0, True
        for i in range(n):
            pos = torch.full((B,), LONG_FIRST + i, dtype=torch.int32)
            want, h_cache = h_step(host, h_cache, toks[:, i:i + 1], pos)
            got, c_cache = c_step(card, c_cache, toks[:, i:i + 1], pos)
            worst = max(worst, _logits_check(
                got.cpu(), want, f"long_500k card vs host {dtype} at "
                f"{LONG_FIRST + i}", atol, rtol))
            same &= bool((got.argmax(-1).cpu() == want.argmax(-1)).all())
        print(f"dryrun: reduced qwen3 long_500k {dtype} (window "
              f"{c.attn_window}, ring {c_cache[0]['attn'].pos.shape[-1]} "
              f"slots), card vs host at positions {LONG_FIRST}-"
              f"{LONG_FIRST + n - 1}: logits max abs diff {worst:.3e}, "
              f"greedy tokens equal: {same}")
        if dtype == "float32" and not same:
            raise AssertionError("long_500k fp32 greedy tokens differ")


def dryrun_path(dev):
    """Phase 4h; returns (the whisper decode_32k step's launches, #4's
    row at that step's cross-attention shape)."""
    from repro_torch.launch import dryrun, steps
    t0 = time.perf_counter()
    dryrun_reckoning(dev)
    print(f"dryrun: (a) the reckoning {time.perf_counter() - t0:.1f} s")
    store = dryrun.ParamStore(dev, seed=0)
    step_counts = None
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, device=dev, store=store)
        print(f"dryrun: {arch} {shape}: {dryrun.summary(rec)} "
              f"({time.perf_counter() - t0:.1f} s)")
        if not rec["fits"]:
            raise AssertionError(f"dryrun {arch} {shape}: reckoned not to "
                                 f"fit")
        _held_to_reckoning(rec)
        _held_to_launches(rec)
        if arch == "whisper-tiny":
            step_counts = rec["launches"]
    store.free()
    t0 = time.perf_counter()
    B = steps.SHAPES["decode_32k"]["batch"]
    row = cross_attention_row(dev, ("whisper_decode_32k", B, 1, 1500, 6, 6,
                                    64), torch.bfloat16)
    print(f"dryrun: (c) #4 at the decode_32k step "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    long_card_vs_host(dev)
    print(f"dryrun: (d) card vs host {time.perf_counter() - t0:.1f} s")
    return step_counts, row


def compare_rows(got, want, dtype, what, tol=None) -> float:
    """``compare`` a batch row at a time (its fp32 copies of a 2^31-element
    output would take ~40 GB at once); returns the max abs error."""
    return max(compare(got[b], want[b], dtype, f"{what} row {b}", tol)
               for b in range(got.shape[0]))


def attention_call_row(dev, tag, q_shape, k_shape, v_shape, causal, window,
                       dtype) -> dict:
    """#4 at one call's shapes and dtype (``dryrun.kernel_calls``), on
    inputs drawn from a seed, held to ``plain_in_chunks`` (a chunk's fp32
    scores under ``PLAIN_CHUNK_BYTES``) elementwise at ``TOL``: its time,
    bound, the plain version's time and one SDPA call's; prints and
    returns the row."""
    from repro_torch.kernels import flash_attention as fa
    dtype = getattr(torch, dtype)
    B, S, H, D = q_shape
    _, T, KV, _ = k_shape
    Dv = v_shape[-1]
    kernel = fa._launch_key(D, Dv, T != S)
    gen = torch.Generator(device=dev).manual_seed(S + T + D)
    q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dtype)
               for shape in (q_shape, k_shape, v_shape))
    kw = dict(causal=causal, window=window)
    heads = max(1, int(PLAIN_CHUNK_BYTES // (4 * S * T)))

    def plain():
        return plain_in_chunks(q, k, v, max_heads=heads, **kw)

    err = compare_rows(fa.flash_attention(q, k, v, **kw), plain(), dtype,
                       f"{kernel} {tag}")
    torch.cuda.empty_cache()
    b_ms, b_by = attention_bound(B, S, H, KV, D, causal, window, dtype,
                                 Dv=Dv, T=T)
    r = {"kernel": kernel, "entry": tag,
         "kernel_route": fa.forward_route(dtype, D, Dv, S, causal, window),
         "shape": {"B": B, "S": S, "T": T, "H": H, "KV": KV, "D": D,
                   "Dv": Dv, "causal": causal, "window": window},
         "dtype": str(dtype)[6:], "elements": q.numel(),
         "max_abs_err": err,
         "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, **kw)),
         "plain_ms": cuda_ms(plain, reps=3, inner=1),
         "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": cuda_ms(sdpa_call(q, k, v, causal, window), reps=5,
                               inner=2)}
    print("kernel " + json.dumps(r))
    del q, k, v
    torch.cuda.empty_cache()
    return r


def slstm_call_row(dev, tag, wx_shape, r_shape, r_dtype) -> dict:
    """#5 at one call's shapes and R dtype (``dryrun.kernel_calls``), on
    ``slstm_inputs``, held to ``ref.slstm_scan_ref`` a batch row at a time
    at ``SLSTM_TOL``: its time, bound and the plain version's; prints and
    returns the row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm_scan as ss
    B, S, _ = wx_shape
    H, P, _ = r_shape
    r_dtype = getattr(torch, r_dtype)
    wx, r, b = slstm_inputs(dev, B, S, H, P, r_dtype, seed=S)
    err = compare_rows(ss.slstm_scan(wx, r, b), ref.slstm_scan_ref(wx, r, b),
                       torch.float32, f"slstm_scan {tag}", SLSTM_TOL[1.0])
    torch.cuda.empty_cache()
    d = H * P
    nbytes = (B * S * 4 * d + B * S * d + 4 * d) * 4 \
        + r.numel() * r.element_size()
    b_ms, b_by = bound(nbytes, 2 * B * S * d * 4 * P)
    row = {"kernel": "slstm_scan", "entry": tag,
           "shape": {"B": B, "S": S, "H": H, "P": P, "scale": 1.0},
           "r_dtype": str(r_dtype)[6:], "plan": ss.plan(d, P, r_dtype),
           "elements": wx.numel(), "max_abs_err": err,
           "ms": cuda_ms(lambda: ss.slstm_scan(wx, r, b)),
           "plain_ms": cuda_ms(lambda: ref.slstm_scan_ref(wx, r, b),
                               reps=3, inner=1),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print("kernel " + json.dumps(row))
    del wx, r, b
    torch.cuda.empty_cache()
    return row


def cell_kernel_rows(dev, records) -> list:
    """Each distinct hand-written kernel call of the run cells (their
    ``calls``: #4 at qwen3's and whisper's ``prefill_32k``, whose q has
    2^31 elements at qwen3, and at whisper's ``decode_32k``; #5 at xlstm's
    ``prefill_32k``, 3.2e9 elements of wx) held to its plain version at
    those shapes; returns the rows."""
    seen, rows = [], []
    for rec in records:
        for call in rec["calls"]:
            if call in seen:
                continue
            seen.append(call)
            tag = f"{rec['arch']}_{rec['shape']}"
            row = (attention_call_row if call[0] == "flash_attention"
                   else slstm_call_row)
            rows.append(row(dev, tag, *call[1:]))
    return rows


def dryrun_matrix(dev) -> list:
    """``--dryrun``: ``launch/dryrun --all`` on the card, one line a cell
    (records under ``build/dryrun_torch``), then each kernel at the run
    cells' shapes against its plain version (``cell_kernel_rows``); fails
    if a cell fails, a run cell's peak passes its reckoning or its
    launches and routes are not ``DRYRUN_RUNS``'s, the run cells are not
    ``DRYRUN_RUNS``'s, the 40 cells are not all accounted for, or a kernel
    disagrees.  Returns the kernel rows."""
    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.launch import dryrun, steps
    out = Path(__file__).resolve().parent / "build" / "dryrun_torch"
    shutil.rmtree(out, ignore_errors=True)
    cells = [(a, s) for a in ARCH_IDS for s in steps.SHAPES]
    records, failures = dryrun.run_cells(cells, out, device=dev)
    ran = [r for r in records if "measured" in r]
    for rec in ran:
        _held_to_reckoning(rec)
        _held_to_launches(rec)
    skipped = sum("skipped" in r for r in records)
    print(f"dryrun: {len(records)} cells: {len(ran)} run, "
          f"{len(records) - len(ran) - skipped} reckoned not to fit, "
          f"{skipped} skipped, {failures} failed")
    if failures or len(records) != len(cells):
        raise AssertionError(f"dryrun: {failures} cells failed, "
                             f"{len(records)} of {len(cells)} recorded")
    run = {(r["arch"], r["shape"]) for r in ran}
    if run != set(DRYRUN_RUNS):
        raise AssertionError(f"dryrun: ran {sorted(run)}, want "
                             f"{sorted(DRYRUN_RUNS)}")
    t0 = time.perf_counter()
    rows = cell_kernel_rows(dev, ran)
    print(f"dryrun: {len(rows)} kernel calls at the run cells' shapes "
          f"held to their plain versions, {time.perf_counter() - t0:.1f} s")
    return rows


# -- phase 5: the LLM training path ------------------------------------------
#
# (name, B, S, H, KV, D, causal, window): the qwen3-0.6b layer, with a 1024
# window, and the reduced qwen3's heads (D = 64) at the launcher's S; then
# the layer of zamba2-2.7b's shared attention block (32 heads of 80) and
# of phi-3-vision-4.2b (32 of 96) in phase (c)'s train step (A x b = 2
# sequences of 4,096 positions), and at each width GQA with a window and a
# ragged S (not a multiple of the 64-row query or 128-key tiles)
BWD_CASES = (("layer", 1, 4096, 16, 8, 128, True, 0),
             ("layer_w1024", 1, 4096, 16, 8, 128, True, 1024),
             ("reduced_d64", 2, 1024, 4, 2, 64, True, 0),
             ("zamba2_layer", 2, 4096, 32, 32, 80, True, 0),
             ("d80_gqa_w", 2, 1000, 8, 2, 80, True, 256),
             ("phi3_layer", 2, 4096, 32, 32, 96, True, 0),
             ("d96_gqa_w", 1, 777, 12, 4, 96, True, 100))
# |got - want| <= BWD_TOL * (max|want| + |want|): the backward rounds P and
# dS to bf16 as product operands (2^-9 each) and its outputs to bf16
BWD_TOL = 2.0 ** -7
# (c): A agents x b sequences of S positions (the train_4k length), 3 steps
STEP_A, STEP_B, STEP_S, STEP_N = 2, 1, 4096, 3
# (c): each model's train step: (arch, #4's forward launch key, text tokens
# and patches a sequence, attention layers: qwen3's 28, zamba2's 9
# applications of its shared block, phi-3-vision's 32); a step launches
# the forward twice a layer (again under the checkpoint's recompute) and
# the backward once; phi-3's S is phase 4f's 576 patches + 3,520 tokens
TRAIN_MODELS = (("qwen3-0.6b", "flash_attention", STEP_S, 0, 28),
                ("zamba2-2.7b", "flash_attention_d80", STEP_S, 0, 9),
                ("phi-3-vision-4.2b", "flash_attention_d96",
                 STEP_S - VLM_PATCHES, VLM_PATCHES, 32))
# (d): the launcher at full width, 2 rounds of LAR 2, E 1; at 1,1,2 the
# agent's model is split over 2 ranks (tensor parallel) sharing the card
LAUNCH_ARGS = ("--full-config", "--rounds", "2", "--lar", "2", "--epochs",
               "1", "--seq", "1024", "--batch", "2")
LAUNCH_MESHES = ("1,1,1", "1,2,1", "1,1,2")
# (e): card against host at the reduced qwen3 (D = 64); the reference's own
# bf16 round tolerance (tests/test_launch.py); the two 4-rank cases share
# one spawn, per_leaf_tp at 2 agents x a model split over 2 ranks
ROUND_TOL = dict(atol=5e-3, rtol=5e-3)
# (d): the split run's update (its final cloud less the drawn params) held
# to the 1-rank run's, relative in the 2-norm over all leaves and over each
# leaf, and its eval losses to the 1-rank run's (absolute), so that a
# wrong tensor-parallel gradient fails even where the cloud's elementwise
# ROUND_TOL is wider than the update itself
UPDATE_TOL = {"update_vs_1,1,1_rel_gap": 0.25,
              "update_vs_1,1,1_max_leaf_rel_gap": 0.5}
LOSS_TOL = 5e-3
# (d): phi-3-vision's one round at full width, one rank: LAR 2, E 1, one
# sequence of 576 patches + 448 tokens an agent (the launcher's 1,024)
VLM_ROUND_TOKENS = 1024 - VLM_PATCHES
# (e): zamba2 and phi-3-vision reduced at their full models' head dims,
# card against host in bf16: (arch, head dim, #4's forward launch key)
ZOO_REDUCED = (("zamba2-2.7b", 80, "flash_attention_d80"),
               ("phi-3-vision-4.2b", 96, "flash_attention_d96"))
# (e): tests/test_torch_train.py's bf16 train-step loss tolerance; each
# leaf's update on the card within ZOO_GAP x the host bf16 update's 2-norm
# gap from the host's fp32 run (+ 1e-3).  Not elementwise at ROUND_TOL:
# on the CPU the reference's own bf16 round of the reduced zamba2 at head
# dim 80 lies 0.045 from its fp32 round and 0.051 from the port's bf16
# round (embedding rows whose update is 0.23); and a norm scale drawn at
# 1.0 and moved by less than a bf16 step rounds to 1 - 2^-8 in one run and
# 1 + 2^-7 in another, 0.0117 apart, past 5e-3 + 5e-3 |w| (phi-3's round
# on the card)
STEP_LOSS_TOL = dict(atol=0.15, rtol=0.05)
ZOO_GAP = 1.5
ROUND_CASES = (("per_leaf", None, {}), ("flat", None, dict(flat_agg=True)),
               ("async", None, dict(flat_agg=True, async_rounds=2,
                                    buffer_keep=0.5)),
               ("quantized", (2, 2, 1), dict(quantize_cloud=True)),
               ("per_leaf_tp", (1, 2, 2), {}))


def attention_bwd_bound(B, S, H, KV, D, causal, window):
    """(bound ms, bound_by) of the backward: q, k, v, O and dO read once,
    dQ, dK, dV written once (bf16); the 5 products of the live pairs (S,
    dP, dV, dQ, dK: 2*D flops each per pair and head) at 989 TFLOP/s."""
    nbytes = 2 * (5 * B * S * H * D + 4 * B * S * KV * D)
    flops = 5 * 2 * D * B * H * live_pairs(S, causal, window)
    return bound(nbytes, flops, BF16_FLOPS_PER_S)


def sdpa_backward_ms(q, k, v, do, causal, window) -> float:
    """SDPA's forward + backward less its forward (timed only): k/v
    repeated to H heads first, as ``sdpa_call``."""
    qt, kt, vt = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fwd = sdpa_call(qt, kt, vt, causal, window)
    dot = do.transpose(1, 2)

    def both():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot, retain_graph=True)
    with torch.no_grad():
        fwd_ms = cuda_ms(fwd)
    return cuda_ms(both) - fwd_ms


def attention_bwd_cases(dev):
    """Phase 5a: the backward kernel against autograd of the plain version
    (comparisons: its launches are not the training path's)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rows = []
    for name, B, S, H, KV, D, causal, window in BWD_CASES:
        gen = torch.Generator(device=dev).manual_seed(S + D)
        q, k, v, do = (torch.randn(B, S, n, D, device=dev, generator=gen)
                       .bfloat16() for n in (H, KV, KV, H))
        kw = dict(causal=causal, window=window)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out_ref = ref.flash_attention_ref(*leaves, **kw)
        want = torch.autograd.grad(out_ref, leaves, do, retain_graph=True)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        errs = {}
        for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
            scale = w.float().abs().max().item()
            errs[g_name] = compare(g, w, torch.bfloat16,
                                   f"flash_attention_bwd {name} {g_name}",
                                   tol=(BWD_TOL * scale, BWD_TOL))
        del got, want
        b_ms, b_by = attention_bwd_bound(B, S, H, KV, D, causal, window)
        rows.append({
            "kernel": "flash_attention_bwd", "entry": name,
            "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D,
                      "causal": causal, "window": window},
            "dtype": "bfloat16", "max_abs_err": max(errs.values()),
            "max_abs_err_by_grad": errs, "tol": f"{BWD_TOL} * (max|want| "
            f"+ |want|)",
            "ms": cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, do,
                                                         lse, **kw)),
            "plain_ms": cuda_ms(lambda: torch.autograd.grad(
                out_ref, leaves, do, retain_graph=True), reps=5, inner=2),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": sdpa_backward_ms(q, k, v, do, causal, window),
            "products_per_pair": 5})
        print("kernel " + json.dumps(rows[-1]))
        del q, k, v, do, leaves, out_ref, out, lse
        torch.cuda.empty_cache()
    return rows


def dps_bf16_cases(dev):
    """Phase 5b: #3's bf16 mode (bf16 w, g, anchors and out) against its
    plain version at the embedding leaf and a stacked MLP leaf of
    qwen3-0.6b, raveled to one row as the round's local epoch launches
    it."""
    from repro_torch.kernels import dual_proximal_sgd as dps
    from repro_torch.kernels import ref

    rows = []
    kw = dict(lr=0.1, mu1=0.001, mu2=0.005)
    for name, n in (("embed", 151_936 * 1024), ("mlp_stacked",
                                                28 * 1024 * 3072)):
        gen = torch.Generator(device=dev).manual_seed(n % 1000)
        w, g, a1, a2 = (torch.randn(n, device=dev, generator=gen).bfloat16()
                        for _ in range(4))
        got = dps.dual_proximal_sgd(w, g, a1, a2, **kw)
        want = ref.dual_proximal_sgd_ref(w, g, a1, a2, **kw)
        if got.dtype != torch.bfloat16:
            raise AssertionError("dual_proximal_sgd bf16: out is not bf16")
        err = compare(got, want, torch.bfloat16, f"dual_proximal_sgd {name}")
        del got, want
        b_ms, b_by = bound(5 * 2 * n, 9 * n)
        rows.append({
            "kernel": "dual_proximal_sgd", "entry": f"bf16_{name}",
            "shape": {"N": n}, "dtype": "bfloat16", "max_abs_err": err,
            "ms": cuda_ms(lambda: dps.dual_proximal_sgd(w, g, a1, a2, **kw)),
            "plain_ms": cuda_ms(lambda: ref.dual_proximal_sgd_ref(
                w, g, a1, a2, **kw)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        print("kernel " + json.dumps(rows[-1]))
        del w, g, a1, a2
        torch.cuda.empty_cache()
    return rows


def _train_batch(A: int, b: int, S: int, patches: int = 0,
                 d_embed: int = 1024) -> dict:
    """A Non-IID Markov stream an agent (the launcher's), cut into b
    sequences of S tokens and their next tokens; with ``patches``, a
    VLM's (A, b, patches, d_embed) fp32 patch embeddings drawn from a
    seed."""
    from repro_torch.data.synthetic import lm_token_task
    toks = np.zeros((A, b, S), np.int32)
    labs = np.zeros_like(toks)
    for a in range(A):
        s = lm_token_task(vocab=512, n_tokens=b * (S + 1),
                          seed=100 + a).reshape(b, S + 1)
        toks[a], labs[a] = s[:, :-1], s[:, 1:]
    out = {"tokens": toks, "labels": labs}
    if patches:
        out["patch_embeds"] = np.random.default_rng(7).standard_normal(
            (A, b, patches, d_embed)).astype(np.float32)
    return out


def _attention_counts(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if k.startswith(
        "flash_attention")}


def train_step_run(dev, arch: str, key: str, text: int, patches: int,
                   layers: int) -> dict:
    """Phase 5c: ``make_train_step`` of ``arch`` at full width and depth,
    counted and timed: each step exactly 2 ``key`` forward launches and 1
    backward launch an attention layer, no other attention; finite losses,
    ms a step, positions/s, peak memory, and one step under
    ``torch.profiler`` with #4's backward's share of device time."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.h2fed import H2FedParams
    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    cfg = get_config(arch)
    t0 = time.perf_counter()
    state = steps.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    step = steps.make_train_step(cfg, H2FedParams(mu1=0.001, mu2=0.005,
                                                  lr=0.05), device=dev)
    batch = _train_batch(STEP_A, STEP_B, text, patches,
                         cfg.encoder.d_embed)
    mask = np.ones((STEP_A,), np.float32)
    want = {**dict.fromkeys(_attention_counts(ops.launch_counts()), 0),
            key: 2 * layers, "flash_attention_bwd": layers}
    losses, ms, launches = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(STEP_N):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, mask)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(ops.launch_counts())
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{arch} train step: non-finite loss {losses}")
    for c in launches:
        if _attention_counts(c) != want:
            raise AssertionError(
                f"{arch} train step: attention launches "
                f"{_attention_counts(c)}, want {want}: 2 forward (the layer "
                f"recomputed in the backward) and 1 backward a layer")
    positions = STEP_A * STEP_B * (text + patches)
    out = {"arch": arch, "A": STEP_A, "b": STEP_B, "S": text + patches,
           "patches": patches, "loss": losses, "step_ms": ms,
           "tokens_per_s": positions / (statistics.median(ms[1:]) / 1e3),
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "params_drawn_s": draw_s,
           "launches_per_step": {k: v for k, v in want.items() if v},
           "launches": launches}
    print("train step " + json.dumps(out))
    prof = device_profile(lambda: step(state, batch, mask), 1)
    print_profile(f"{arch} train step (A=2, b=1, S={text + patches})", 1,
                  *prof)
    busy, kernels = prof[2], prof[3]
    if busy:
        bwd = sum(v for k, v in kernels.items() if "attn_bwd" in k)
        fwd = sum(v for k, v in kernels.items() if "flash_attention" in k)
        out["bwd_share"], out["device_ms"] = bwd / busy, busy * 1e3
        print(f"profile: {arch} train step: device time {busy * 1e3:.1f} ms; "
              f"#4's backward kernels {bwd * 1e3:.2f} ms ({bwd / busy:.1%}), "
              f"its forward {fwd * 1e3:.2f} ms ({fwd / busy:.1%})")
        print_kinds(f"{arch} train step", prof)
    del state
    torch.cuda.empty_cache()
    return out


def launcher_runs(dev) -> dict:
    """Phase 5d: ``python -m repro_torch.launch.train --full-config`` at 1
    rank (nccl), 2 agents (2 ranks sharing the card over gloo) and one
    agent split over 2 ranks (tensor parallel, gloo), in process through
    its ``main``; each round's launches and collectives were counted by
    the ranks themselves (set to 0 just before the round).  The split run
    is held to the 1-rank run (the same seed and draws, A = 1): the final
    cloud within ``ROUND_TOL``, its update and eval losses within
    ``UPDATE_TOL`` and ``LOSS_TOL`` (``update_gap``), and its collectives
    each round to ``round_collectives``'s reckoning."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_config
    from repro_torch.core.h2fed import H2FedParams
    from repro_torch.launch import train
    from repro_torch.launch.h2fed_round import comm_model, round_collectives
    from repro_torch.launch.mesh import ShapeMesh

    out, base = {}, None
    for mesh in LAUNCH_MESHES:
        t0 = time.perf_counter()
        res = train.main([*LAUNCH_ARGS, "--mesh", mesh])
        shape = tuple(int(x) for x in mesh.split(","))
        fake = ShapeMesh(shape, ("pod", "data", "model"))
        cm = comm_model(get_config("qwen3-0.6b"), H2FedParams(lar=2), fake)
        losses = [res["init_loss"], *res["loss"]]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"launcher {mesh}: eval loss {losses} is "
                                 f"not finite and falling")
        rec = {"mesh": mesh, "seconds": time.perf_counter() - t0,
               "eval_loss": losses, "mass": res["mass"],
               "round_ms": res["round_ms"], "launches": res["launches"],
               "collectives": res["collectives"],
               "comm_model_bytes": {"data": cm["ici_bytes_per_dev"],
                                    "pod": cm["dci_bytes_per_dev"]},
               "peak_bytes_by_rank": res["peak_bytes_by_rank"]}
        cloud = res.pop("cloud")
        if mesh == "1,1,1":
            base, base_losses = cloud, losses
        if shape[2] > 1:
            rec.update(update_gap(dev, cloud, base))
            rec["eval_loss_vs_1,1,1_max_abs_gap"] = max(
                abs(a - b) for a, b in zip(losses, base_losses))
            print("launcher hold " + json.dumps({
                k: rec[k] for k in rec if "1,1,1" in k}))
            want = round_collectives(get_config("qwen3-0.6b"),
                                     H2FedParams(lar=2, local_epochs=1),
                                     fake, 2, 1024)   # b, S of LAUNCH_ARGS
            rec["collectives_reckoned"] = want
            for r, got in enumerate(res["collectives"]):
                mine = {k: v for k, v in got.items()
                        if k.split("/")[0] in ("tp", "round", "lar",
                                               "cloud")}
                if mine != want:
                    raise AssertionError(f"launcher {mesh} round {r + 1}: "
                                         f"collectives {mine}, reckoned "
                                         f"{want}")
            err = 0.0
            for a, b in zip(tree.leaves(cloud), tree.leaves(base)):
                err = max(err, compare(a, b, torch.bfloat16,
                                       f"launcher {mesh} vs 1,1,1 cloud",
                                       tol=(ROUND_TOL["atol"],
                                            ROUND_TOL["rtol"])))
            rec["cloud_vs_1,1,1_max_abs_err"] = err
            if any(rec[k] > v for k, v in UPDATE_TOL.items()):
                raise AssertionError(f"launcher {mesh}: update "
                                     f"{ {k: rec[k] for k in UPDATE_TOL} } "
                                     f"from 1,1,1's, limits {UPDATE_TOL}")
            if rec["eval_loss_vs_1,1,1_max_abs_gap"] > LOSS_TOL:
                raise AssertionError(f"launcher {mesh}: eval loss {losses} "
                                     f"against 1,1,1's {base_losses}, "
                                     f"limit {LOSS_TOL}")
            rec["kernel_launches_per_round"] = [
                {k: c.get(k, 0) for k in ("flash_attention",
                                          "flash_attention_bwd",
                                          "dual_proximal_sgd")}
                for c in res["launches"]]
        print("launcher " + json.dumps(rec))
        out[mesh] = rec
        torch.cuda.empty_cache()
    return out


def update_gap(dev, cloud, base) -> dict:
    """How far the split run's update (``cloud`` less the params that the
    launcher draws from its seed) is from the 1-rank run's (``base`` less
    the same): ||d - d_base|| / ||d_base||, over all leaves and the most
    of any leaf, with ||d_base|| / ||params||.  Raises unless the update
    is under half the params' norm (else the draw is not the
    launcher's)."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    init = M.init_params(get_config("qwen3-0.6b"),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    gap = upd = par = leaf = 0.0
    for p, a, b in zip(tree.leaves(init), tree.leaves(cloud),
                       tree.leaves(base)):
        p = p.float()
        d_base = b.to(dev).float() - p
        g = (a.to(dev).float() - p - d_base).norm().item() ** 2
        u = d_base.norm().item() ** 2
        gap, upd, par = gap + g, upd + u, par + p.norm().item() ** 2
        leaf = max(leaf, (g / u) ** 0.5 if u else
                   (float("inf") if g else 0.0))
    del init
    torch.cuda.empty_cache()
    if not upd ** 0.5 < 0.5 * par ** 0.5:
        raise AssertionError(f"launcher: the 1,1,1 update {upd ** 0.5:.4g} "
                             f"is not under half the drawn params' "
                             f"{par ** 0.5:.4g}: not the launcher's draw")
    return {"update_vs_1,1,1_rel_gap": (gap / upd) ** 0.5,
            "update_vs_1,1,1_max_leaf_rel_gap": leaf,
            "update_1,1,1_rel_size": (upd / par) ** 0.5}


def train_round_rank(device: str, params_cpu: dict) -> dict:
    """Runs on every rank of phase 5e's 4-rank cases (module level,
    spawned by ``run_ranks`` once): each case's round on the card and on
    the host, on its own mesh of the same 4 ranks."""
    from repro_torch.launch.mesh import FleetMesh
    out = {}
    for name, shape, kw in ROUND_CASES:
        if shape is not None:
            mesh = FleetMesh(shape, ("pod", "data", "model"))
            out[name] = {d: _one_round(d, params_cpu, mesh, kw)
                         for d in (device, "cpu")}
    return out


def _round_inputs(A: int):
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 512, (2, A, 2, 128)).astype(np.int32)
             for k in ("tokens", "labels")}
    mask = rng.integers(0, 2, (2, A)).astype(np.float32)
    mask[:, 0] = 1.0
    delays = rng.integers(0, 3, (2, A)).astype(np.int32)
    delays[0, 0] = 1
    return batch, mask, rng.uniform(1, 3, (A,)).astype(np.float32), delays


def _one_round(device, params_cpu, mesh, kw) -> dict:
    """One round on ``device``: the params handed in as this rank's blocks
    of the round's layout, the new cloud gathered whole; the kernels'
    launches of the round."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.core.h2fed import H2FedParams
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shard
    from repro_torch.launch.h2fed_round import make_h2fed_round
    from repro_torch.launch.mesh import n_agents
    dev = torch.device(device)
    params = tree.map_tree(lambda t: t.to(dev), params_cpu)
    layout = None
    if mesh is not None:
        layout = shard.param_shardings_model_only(params, mesh)
        params = shard.shard_tree(params, layout)
    batch, mask, n_data, delays = _round_inputs(
        1 if mesh is None else n_agents(mesh))
    fn = make_h2fed_round(get_reduced_config("qwen3-0.6b"),
                          H2FedParams(mu1=0.05, mu2=0.01, lar=2,
                                      local_epochs=1, lr=0.1),
                          mesh, device=dev, **kw)
    ops.reset_launch_counts()
    cloud, m = fn(params, batch, mask, n_data,
                  *((delays,) if kw.get("async_rounds") else ()))
    launches = ops.launch_counts()
    if layout is not None:
        cloud = shard.gather_tree(cloud, layout)
    return {"cloud": tree.map_tree(lambda t: t.cpu(), cloud),
            "mass": float(m["surviving_mass"]), "launches": launches}


def round_card_vs_host(dev) -> dict:
    """Phase 5e: one round of each case on the card and on the host, the
    same params (reduced qwen3, bf16, D = 64): the new cloud within the
    reference's bf16 round tolerance, the surviving masses equal.  The
    4-rank cases run in one spawn; ``per_leaf_tp`` splits each of 2
    agents' model over 2 ranks.  Returns the cases' records and the
    split case's card launches (rank 0's)."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import model as M

    params = M.init_params(get_reduced_config("qwen3-0.6b"),
                           torch.Generator().manual_seed(0), device="cpu")
    out, spawned = {}, None
    for name, shape, kw in ROUND_CASES:
        if shape is None:
            card, host = (_one_round(d, params, None, kw)
                          for d in (str(dev), "cpu"))
        else:
            if spawned is None:
                spawned = run_ranks(4, train_round_rank, str(dev), params,
                                    backend="gloo", device="cuda")
            card, host = spawned[name][str(dev)], spawned[name]["cpu"]
        err = 0.0
        for a, b in zip(tree.leaves(card["cloud"]),
                        tree.leaves(host["cloud"])):
            err = max(err, compare(a, b, torch.bfloat16,
                                   f"round {name} card vs host",
                                   tol=(ROUND_TOL["atol"],
                                        ROUND_TOL["rtol"])))
        if card["mass"] != host["mass"]:
            raise AssertionError(f"round {name}: surviving mass "
                                 f"{card['mass']} on the card, "
                                 f"{host['mass']} on the host")
        out[name] = {"mesh": shape, "max_abs_err": err,
                     "mass": card["mass"], "launches": card["launches"]}
        print("round card-vs-host " + json.dumps({"case": name, **out[name]}))
    return out, spawned["per_leaf_tp"][str(dev)]["launches"]


def zamba2_launcher_run(dev) -> dict:
    """Phase 5d, zamba2: ``python -m repro_torch.launch.train --arch
    zamba2-2.7b --full-config`` at ``--mesh 1,1,1`` (nccl), 2 rounds of
    LAR 2, E 1, S=1024, b=2, in process through its ``main``: the eval
    loss finite and falling; each round's attention launches exactly LAR x
    E local steps of the shared block's 2 x 9 forward and 9 backward
    launches; ms a round, peak memory.  Returns the record."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    res = train.main(["--arch", HYBRID_ARCH, *LAUNCH_ARGS, "--mesh",
                      "1,1,1"])
    losses = [res["init_loss"], *res["loss"]]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"launcher {HYBRID_ARCH}: eval loss {losses} "
                             f"is not finite and falling")
    steps_a_round = 2 * 1       # --lar 2, --epochs 1
    want = {**dict.fromkeys(_attention_counts(res["launches"][0]), 0),
            "flash_attention_d80": steps_a_round * 2 * 9,
            "flash_attention_bwd": steps_a_round * 9}
    for r, c in enumerate(res["launches"]):
        if _attention_counts(c) != want:
            raise AssertionError(f"launcher {HYBRID_ARCH} round {r + 1}: "
                                 f"attention launches "
                                 f"{_attention_counts(c)}, want {want}")
    rec = {"arch": HYBRID_ARCH, "mesh": "1,1,1",
           "seconds": time.perf_counter() - t0, "eval_loss": losses,
           "mass": res["mass"], "round_ms": res["round_ms"],
           "launches": res["launches"],
           "peak_bytes_by_rank": res["peak_bytes_by_rank"]}
    print("launcher " + json.dumps(rec))
    del res
    torch.cuda.empty_cache()
    return rec


def vision_round_run(dev) -> dict:
    """Phase 5d, phi-3-vision: one ``make_h2fed_round`` round at full width
    and depth on one rank (LAR 2, E 1, one agent's sequence of 576 drawn
    patch embeddings + 448 tokens): the new cloud finite and moved from
    the drawn params, exactly LAR x E steps of 2 x 32 ``flash_attention_d96``
    and 32 backward launches, ms and peak memory.  Returns the record."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_config
    from repro_torch.core.h2fed import H2FedParams
    from repro_torch.kernels import ops
    from repro_torch.launch.h2fed_round import make_h2fed_round
    from repro_torch.models import model as M

    cfg = get_config(VISION_ARCH)
    lar = 2
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    fn = make_h2fed_round(cfg, H2FedParams(mu1=0.001, mu2=0.005, lar=lar,
                                           local_epochs=1, lr=0.1),
                          device=dev)
    one = _train_batch(lar, 1, VLM_ROUND_TOKENS, VLM_PATCHES,
                       cfg.encoder.d_embed)
    batch = {k: v[:, None] for k, v in one.items()}   # (LAR, A=1, b=1, ...)
    mask = np.ones((lar, 1), np.float32)
    n_data = np.ones((1,), np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cloud, m = fn(params, batch, mask, n_data)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    want = {**dict.fromkeys(_attention_counts(counts), 0),
            "flash_attention_d96": lar * 2 * 32,
            "flash_attention_bwd": lar * 32}
    if _attention_counts(counts) != want:
        raise AssertionError(f"{VISION_ARCH} round: attention launches "
                             f"{_attention_counts(counts)}, want {want}")
    moved, finite = 0.0, True
    for a, b in zip(tree.leaves(cloud), tree.leaves(params)):
        finite = finite and bool(torch.isfinite(a).all())
        moved = max(moved, (a.float() - b.float()).abs().max().item())
    if not finite or moved == 0.0:
        raise AssertionError(f"{VISION_ARCH} round: cloud finite {finite}, "
                             f"largest update {moved}")
    rec = {"arch": VISION_ARCH, "lar": lar, "epochs": 1,
           "positions": VLM_PATCHES + VLM_ROUND_TOKENS, "round_ms": ms,
           "surviving_mass": float(m["surviving_mass"]),
           "max_abs_update": moved,
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "launches": counts}
    print("vision round " + json.dumps(rec))
    del params, cloud
    torch.cuda.empty_cache()
    return rec


def _zoo_batch(cfg, lead, S: int, seed: int) -> dict:
    """Tokens and labels ``lead + (S,)`` from a numpy seed, and for the VLM
    fp32 patch embeddings ``lead + (P, d_embed)``."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, lead + (S,)).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.encoder.kind == "vision":
        out["patch_embeds"] = rng.standard_normal(
            lead + (cfg.encoder.n_positions, cfg.encoder.d_embed)).astype(
                np.float32)
    return out


def _update_gaps(final, truth, init) -> list:
    """Per leaf, ||final - truth|| / ||truth - init|| in float64 on the
    host: how far a run's update is from the fp32 run's, relative to it."""
    out = []
    for a, t, p in zip(final, truth, init):
        a, t, p = (x.detach().cpu().double() for x in (a, t, p))
        out.append(((a - t).norm() / (t - p).norm().clamp(min=1e-30)).item())
    return out


def zoo_card_vs_host(dev) -> dict:
    """Phase 5e, zamba2 and phi-3-vision: each reduced at its full model's
    head dim (80, 96; the stock reduced configs land on 64), bf16, the same
    params on the card and on the host: one train step (2 agents x 1 x 48
    tokens, phi-3's after 16 patches), the loss within 0.15 + 0.05 |loss|
    (``tests/test_torch_train.py``'s bf16 tolerance), and one round (LAR 2,
    E 1), the masses equal.  The new params (step) and cloud (round) are
    held to the host's fp32 run from the same bf16 params: each leaf's
    update on the card as near it as the host's bf16 update is, within
    ``ZOO_GAP`` x its 2-norm gap + 1e-3 (``_update_gaps``; the largest
    elementwise gap to the host's bf16 run is printed beside it).  The
    card's runs must launch #4 at the dim and its backward.  Returns {head
    dim: the card runs' launch counts summed}."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.core.h2fed import H2FedParams
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.h2fed_round import make_h2fed_round
    from repro_torch.models import model as M

    out = {}
    for arch, hd, key in ZOO_REDUCED:
        cfg = get_reduced_config(arch).replace(head_dim=hd, dtype="bfloat16",
                                               param_dtype="bfloat16")
        c32 = cfg.replace(dtype="float32", param_dtype="float32")
        host = M.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
        host32 = tree.map_tree(lambda t: t.float(), host)
        card = tree.map_tree(lambda t: t.to(dev), host)
        init = tree.leaves(host)
        hp = H2FedParams(mu1=0.05, mu2=0.01, lr=0.1)
        rhp = H2FedParams(mu1=0.05, mu2=0.01, lar=2, local_epochs=1, lr=0.1)
        batch = _zoo_batch(cfg, (2, 1), 48, 5)
        mask = np.array([1.0, 1.0], np.float32)
        rb = _zoo_batch(cfg, (2, 1, 1), 32, 6)        # (LAR, A, b, ...)
        rmask, n_data = np.ones((2, 1), np.float32), np.ones((1,),
                                                              np.float32)

        def step_on(c, params, device):
            state, m = steps.make_train_step(c, hp, device=device)(
                steps.train_state(params), batch, mask)
            return tree.leaves(state.params), float(m["loss"])

        def round_on(c, params, device):
            cloud, m = make_h2fed_round(c, rhp, device=device)(
                params, rb, rmask, n_data)
            return tree.leaves(cloud), float(m["surviving_mass"])

        rec = {"arch": arch, "head_dim": hd}
        counts = {}
        for what, run in (("train_step", step_on), ("round", round_on)):
            ops.reset_launch_counts()
            got, c_val = run(cfg, card, dev)
            torch.cuda.synchronize()
            counts[what] = ops.launch_counts()
            want, h_val = run(cfg, host, "cpu")
            truth, _ = run(c32, host32, "cpu")
            if what == "train_step":
                if not abs(c_val - h_val) <= (STEP_LOSS_TOL["atol"]
                                              + STEP_LOSS_TOL["rtol"]
                                              * abs(h_val)):
                    raise AssertionError(f"reduced {arch} train step: loss "
                                         f"{c_val} on the card, {h_val} on "
                                         f"the host")
            elif c_val != h_val:
                raise AssertionError(f"reduced {arch} round: surviving mass "
                                     f"{c_val} on the card, {h_val} on the "
                                     f"host")
            card_gap = _update_gaps(got, truth, init)
            host_gap = _update_gaps(want, truth, init)
            worse = [(i, g, h) for i, (g, h) in enumerate(zip(card_gap,
                                                              host_gap))
                     if not g <= ZOO_GAP * h + 1e-3]
            if worse:
                raise AssertionError(
                    f"reduced {arch} {what}: the card's update is farther "
                    f"from the host's fp32 run than the host's bf16 update "
                    f"(leaf, card gap, host gap): {worse}")
            err = max((a.float().cpu() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
            c = counts[what]
            if not (c[key] > 0 and c["flash_attention_bwd"] > 0):
                raise AssertionError(f"reduced {arch} {what}: launches {c}, "
                                     f"want {key} and its backward")
            rec[what] = {"card": c_val, "host": h_val, "max_abs_err": err,
                         "max_card_gap": max(card_gap),
                         "max_host_gap": max(host_gap),
                         "launches": _attention_counts(c)}
            del got, want, truth
        out[hd] = {k: counts["train_step"][k] + counts["round"][k]
                   for k in counts["round"]}
        print("zoo card-vs-host " + json.dumps(rec))
    return out


def train_path(dev):
    """Phase 5; returns (kernel rows; the qwen3 training runs' launch
    counts: the train step's 3 steps, every launcher run's rounds and the
    split card-vs-host round's card run; and zamba2's and phi-3-vision's,
    by head dim (80, 96): each model's 3 full-width steps, zamba2's
    launcher rounds or phi-3's full-width round, and the reduced model's
    card-vs-host step and round on the card)."""
    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase 5 part {name}: {time.perf_counter() - t0:.1f} s")
        return out
    rows = part("5a", attention_bwd_cases, dev) + part("5b", dps_bf16_cases,
                                                       dev)
    runs = {arch: part(f"5c {arch}", train_step_run, dev, arch, key, text,
                       patches, layers)
            for arch, key, text, patches, layers in TRAIN_MODELS}
    for r in rows:
        arch = {"zamba2_layer": HYBRID_ARCH,
                "phi3_layer": VISION_ARCH}.get(r["entry"])
        if arch:
            r["launches_per_step"] = runs[arch]["launches_per_step"][
                "flash_attention_bwd"]
    launch = part("5d qwen3 launcher", launcher_runs, dev)
    _, tp_launches = part("5e qwen3", round_card_vs_host, dev)
    zamba = part("5d zamba2 launcher", zamba2_launcher_run, dev)
    vision = part("5d phi-3 round", vision_round_run, dev)
    reduced = part("5e zamba2 and phi-3", zoo_card_vs_host, dev)

    def total(runs_counts) -> dict:
        counts: dict = {}
        for c in runs_counts:
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        return counts
    counts = total(runs["qwen3-0.6b"]["launches"]
                   + [c for r in launch.values() for c in r["launches"]]
                   + [tp_launches])
    zoo = {80: total(runs[HYBRID_ARCH]["launches"] + zamba["launches"]
                     + [reduced[80]]),
           96: total(runs[VISION_ARCH]["launches"] + [vision["launches"]]
                     + [reduced[96]])}
    return rows, counts, zoo


def ptxas_by_kernel(log: str) -> list:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its name
    (demangled where ``c++filt`` is present), then its stack and spill line
    and its register and shared-memory line."""
    entries = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entries.append((line.split("'")[1], []))
        elif entries and ("spill" in line or "Used" in line):
            entries[-1][1].append(
                line.strip().removeprefix("ptxas info    : "))
    names = [e[0] for e in entries]
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and names:
        out = subprocess.run([cxxfilt], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = out.stdout.splitlines()
    return [f"{n}: {'; '.join(e[1])}" for n, e in zip(names, entries)]


def ptxas_notes(log: str) -> list:
    """ptxas's "Potential Performance Loss" notes (e.g. wgmma products it
    serialized), which it prints as info lines, not warnings."""
    return [line.strip().removeprefix("ptxas info    : ")
            for line in log.splitlines() if "Performance Loss" in line]


def device_and_build():
    """Phase 1: (device, the card's nvidia-smi line)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _lib

    dev = resolve_device()
    card = gpu_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _lib.library()
    report = _lib.build_report()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{report['build_seconds']} s)")
    for line in ptxas_by_kernel(report["ptxas_log"]):
        print(f"ptxas: {line}")
    for line in ptxas_notes(report["ptxas_log"]):
        print(f"ptxas: {line}")
    return dev, card


def aggregation_cases(dev):
    """Phase 2 at every shape and fleet dtype; returns result rows."""
    rows = []
    for name, A, R, N in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for r in kernel_cases(dev, name, A, R, N, dtype):
                print("kernel " + json.dumps(r))
                rows.append(r)
    return rows


def run_phase(fn, dev):
    """``fn(dev)``, its wall time (host clock) printed on a line of its
    own, so that a run shows where its time limit goes."""
    t0 = time.perf_counter()
    out = fn(dev)
    print(f"time: {getattr(fn, '__name__', 'phase')} "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    phases = selected_phases(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev, card = device_and_build()
    rows = run_phase(aggregation_cases, dev) if "2" in phases else []
    attn_rows = run_phase(attention_cases, dev) if "2b" in phases else []
    scan_rows = run_phase(slstm_cases, dev) if "2c" in phases else []
    if "3r" in phases:
        run_phase(flat_round, dev)
    if phases != FULL_RUN:
        if "3b" in phases:
            run_phase(async_path, dev)
        if "3s" in phases:
            run_phase(sweep_path, dev)
        if "3t" in phases:
            run_phase(stream_path, dev)
        if "3v" in phases:
            run_phase(serve_path, dev)
        if "3h" in phases:
            run_phase(sharded_path, dev)
        if "4c" in phases:
            run_phase(moe_serving, dev)
        if "4d" in phases:
            run_phase(hybrid_serving, dev)
        if "4e" in phases:
            run_phase(audio_serving, dev)
        if "4f" in phases:
            run_phase(vision_serving, dev)
        if "4g" in phases:
            run_phase(dense_serving, dev)
        if "4h" in phases:
            run_phase(dryrun_path, dev)
        if "dryrun" in phases:
            run_phase(dryrun_matrix, dev)
        if "5" in phases:
            run_phase(train_path, dev)
        return 0

    paths = run_phase(main_path, dev)
    async_paths = run_phase(async_path, dev)
    sweep_rows, sweep_paths = run_phase(sweep_path, dev)
    stream_rows, stream_paths = run_phase(stream_path, dev)
    serve_paths = run_phase(serve_path, dev)
    shard_rows, shard_counts = run_phase(sharded_path, dev)
    flash_launches = run_phase(serving_path, dev)
    scan_launches = run_phase(xlstm_serving, dev)
    mla_launches = run_phase(moe_serving, dev)
    d80_launches = run_phase(hybrid_serving, dev)
    audio_counts, audio_step_counts = run_phase(audio_serving, dev)
    vision_counts = run_phase(vision_serving, dev)
    dense_counts = run_phase(dense_serving, dev)
    dry_counts, dry_row = run_phase(dryrun_path, dev)
    train_rows, train_counts, zoo_counts = run_phase(train_path, dev)

    def pick(kernel, entry):
        return next(r for r in rows if r["kernel"] == kernel and
                    r["entry"] == entry and r["shape"] == "main" and
                    r["dtype"] == "float32")

    # launches of each path's counted run: the flat round (fused and
    # fused=False), the async round (fused, and fused=False with its
    # scatter-accumulates on the matmul kernel), the sweep (fused and
    # fused=False), the serve loop (fused and fused=False) and the
    # host-streamed flat and async rounds (#2 as chunk_agg, #1 as
    # cloud_blend)
    by_path = {}
    for path, fused, unfused in (("flat", paths["main"], paths["unfused"]),
                                 ("async", async_paths["main"],
                                  async_paths["unfused"]),
                                 ("sweep", sweep_paths["sweep"],
                                  sweep_paths["unfused"]),
                                 ("serve", serve_paths["main"],
                                  serve_paths["unfused"])):
        by_path[path] = {
            "fused_agg_blend": sum(fused[k] for k in (
                "agg_blend", "cloud_blend", "agg_absorb")),
            "weighted_agg_matmul": unfused["weighted_agg_matmul"]
            + unfused["scatter_accumulate"],
            "dual_proximal_sgd": fused["dual_proximal_sgd"]}
    streamed = list(stream_paths.values())
    by_path["stream"] = {
        "fused_agg_blend": sum(c[k] for c in streamed for k in (
            "agg_blend", "cloud_blend", "agg_absorb")),
        "weighted_agg_matmul": sum(c[k] for c in streamed for k in (
            "weighted_agg_matmul", "scatter_accumulate", "chunk_agg",
            "agg_blend_tiled", "agg_absorb_tiled")),
        "dual_proximal_sgd": sum(c["dual_proximal_sgd"] for c in streamed)}
    # the sharded rounds (every rank's count a case, at 1, 2 and 4 ranks
    # and the N-sharded cell): #2 as block_local_agg, #3 each step; the
    # cloud layer is plain math, so #1 is not on this path
    by_path["sharded"] = {
        "fused_agg_blend": sum(shard_counts.get(k, 0) for k in (
            "agg_blend", "cloud_blend", "agg_absorb")),
        "weighted_agg_matmul": shard_counts["block_local_agg"],
        "dual_proximal_sgd": shard_counts["dual_proximal_sgd"]}
    kernels = []
    for kernel, entry in (("fused_agg_blend", "agg_blend"),
                          ("weighted_agg_matmul", "weighted_agg_matmul"),
                          ("dual_proximal_sgd", "scaled_broadcast")):
        r = pick(kernel, entry)
        kernels.append({
            "name": kernel, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel],
            "launches": sum(c[kernel] for c in by_path.values()),
            "launches_by_path": {p: c[kernel] for p, c in by_path.items()},
            "max_abs_err": max(x["max_abs_err"] for x in rows
                               if x["kernel"] == kernel),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "entry": entry,
            "shape": {"A": r["A"], "R": r["R"], "N": r["N"]},
            **{k: r[k] for k in ("device_ms", "host_us", "library_device_ms",
                                 "library_host_us") if k in r}})
    # the scenario-axis entries at the sweep shape, launched by the sweep
    for kernel, entry in (("fused_agg_blend", "agg_blend_sweep"),
                          ("weighted_agg_matmul", "weighted_agg_matmul_sweep"),
                          ("dual_proximal_sgd", "sweep")):
        r = next(x for x in sweep_rows if x["kernel"] == kernel
                 and x["entry"] == entry)
        kernels.append({
            "name": kernel, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel],
            "launches": by_path["sweep"][kernel],
            "launches_by_path": {"sweep": by_path["sweep"][kernel]},
            "max_abs_err": max(x["max_abs_err"] for x in sweep_rows
                               if x["kernel"] == kernel),
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "entry")},
            "shape": {k: r[k] for k in ("S", "A", "R", "N")},
            **{k: r[k] for k in ("device_ms", "host_us", "library_device_ms",
                                 "library_host_us") if k in r}})
    # #2 at the streamed rounds' chunk shape, launched by them as chunk_agg
    r = next(x for x in stream_rows if x["dtype"] == "float32")
    kernels.append({
        "name": "weighted_agg_matmul", "route": "cuda",
        "source": SOURCES["weighted_agg_matmul"],
        "replaces": REPLACES["weighted_agg_matmul"],
        "launches": by_path["stream"]["weighted_agg_matmul"],
        "launches_by_path": {"stream":
                             by_path["stream"]["weighted_agg_matmul"]},
        "max_abs_err": max(x["max_abs_err"] for x in stream_rows),
        **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "entry")},
        "shape": {k: r[k] for k in ("A", "R", "N")}})
    # #2 at the rsu-sharded paper fleet's pod shape, launched by the
    # sharded rounds as block_local_agg
    r = next(x for x in shard_rows if x["shape"] == "paper_pod")
    kernels.append({
        "name": "weighted_agg_matmul", "route": "cuda",
        "source": SOURCES["weighted_agg_matmul"],
        "replaces": REPLACES["weighted_agg_matmul"],
        "launches": by_path["sharded"]["weighted_agg_matmul"],
        "launches_by_path": {"sharded":
                             by_path["sharded"]["weighted_agg_matmul"]},
        "max_abs_err": max(x["max_abs_err"] for x in shard_rows),
        **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "entry")},
        "shape": {k: r[k] for k in ("A", "R", "N")}})
    # the serving path's shape: what each of its prefill launches computes
    r = next(x for x in attn_rows if x["entry"] == "prefill"
             and x["kernel"] == "flash_attention")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"], "launches": flash_launches,
        "max_abs_err": max(x["max_abs_err"] for x in attn_rows
                           if x["kernel"] == "flash_attention"),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "entry": "prefill", "shape": r["shape"], "dtype": r["dtype"]})
    # MLA's head dims at deepseek-v2-lite's prefill shape, as each of its
    # prefill launches (phase 4c)
    mla_rows = [x for x in attn_rows if x["kernel"] == "flash_attention_mla"]
    r = next(x for x in mla_rows if x["entry"] == "prefill")
    kernels.append({
        "name": "flash_attention_mla", "route": "cuda",
        "source": SOURCES["flash_attention_mla"],
        "replaces": REPLACES["flash_attention_mla"],
        "launches": mla_launches,
        "max_abs_err": max(x["max_abs_err"] for x in mla_rows),
        **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "library_padded_v", "shape",
                             "dtype")},
        "entry": "prefill"})
    # head dim 80 at zamba2-2.7b's prefill shape, as each of its prefill
    # launches (phase 4d): the TMA + wgmma kernel at (80, 80), its blocks
    # in groups of 16 (b, h) pairs
    d80_rows = [x for x in attn_rows if x["kernel"] == "flash_attention_d80"]
    r = next(x for x in d80_rows if x["entry"] == "prefill")
    kernels.append({
        "name": "flash_attention_d80", "route": "cuda",
        "source": SOURCES["flash_attention_d80"],
        "replaces": REPLACES["flash_attention_d80"],
        "launches": d80_launches,
        "max_abs_err": max(x["max_abs_err"] for x in d80_rows),
        **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "shape", "dtype")},
        "entry": "prefill"})
    # head dim 96 at phi-3-vision's prefill shape (576 patches + 3,520
    # tokens), as each of its prefill launches (phase 4f)
    d96_rows = [x for x in attn_rows if x["kernel"] == "flash_attention_d96"]
    r = next(x for x in d96_rows if x["entry"] == "prefill")
    kernels.append({
        "name": "flash_attention_d96", "route": "cuda",
        "source": SOURCES["flash_attention_d96"],
        "replaces": REPLACES["flash_attention_d96"],
        "launches": vision_counts["flash_attention_d96"],
        "max_abs_err": max(x["max_abs_err"] for x in d96_rows),
        **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "shape", "dtype")},
        "entry": "prefill"})
    # #4 at yi-34b's and command-r-35b's prefill shapes (D = 128, GQA 7
    # and 8), as each of their prefill launches (phase 4g), and at (192,
    # 192) at nemotron-4-340b's (phase 4g, 2 of its 96 layers)
    for kernel, entry, arch in (
            ("flash_attention", "yi_prefill", "yi-34b"),
            ("flash_attention", "command_r_prefill", "command-r-35b"),
            ("flash_attention_d192", "prefill", NEMOTRON_ARCH)):
        r = next(x for x in attn_rows if x["kernel"] == kernel
                 and x["entry"] == entry)
        kernels.append({
            "name": kernel, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel],
            "launches": dense_counts[arch][kernel],
            "max_abs_err": max(x["max_abs_err"] for x in attn_rows
                               if x["kernel"] == kernel),
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "shape", "dtype",
                                 "kernel_route")},
            "entry": entry})
    # whisper's decoder self-attention (D = 64, the TMA + wgmma kernel) at
    # its prefill shape (B=32, S=448), as each of its self-attention
    # launches (phase 4e)
    self_rows = [x for x in attn_rows if x["kernel"] == "flash_attention"
                 and x["entry"] == "whisper_self"]
    r = next(x for x in self_rows if x["dtype"] == "bfloat16")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"],
        "launches": audio_counts["flash_attention"],
        "max_abs_err": max(x["max_abs_err"] for x in self_rows),
        **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "shape", "dtype",
                             "kernel_route", "device_ms", "host_us",
                             "library_device_ms")},
        "entry": "whisper_self"})
    # keys of their own length at whisper's prefill shape (B=32, 448
    # tokens over 1500 frames; the TMA + wgmma kernel), as each of its
    # cross-attention launches (phase 4e), and at a decode step's (B=8,
    # one query over 1500 frames; the split-key kernel), as each of the
    # step's cross-attention launches
    cross_rows = [x for x in attn_rows
                  if x["kernel"] == "flash_attention_cross"]
    for entry, counted in (("whisper_prefill", audio_counts),
                           ("whisper_decode", audio_step_counts)):
        r = next(x for x in cross_rows if x["entry"] == entry
                 and x["dtype"] == "bfloat16")
        kernels.append({
            "name": "flash_attention_cross", "route": "cuda",
            "source": SOURCES["flash_attention_cross"],
            "replaces": REPLACES["flash_attention_cross"],
            "launches": counted["flash_attention_cross"],
            "max_abs_err": max(x["max_abs_err"] for x in cross_rows
                               if x["kernel_route"] == r["kernel_route"]),
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "shape", "dtype",
                                 "kernel_route", "device_ms", "host_us",
                                 "library_device_ms")},
            "entry": entry})
    # keys of their own length at whisper decode_32k's step (B=128, one
    # query over 1500 frames; the split-key kernel), as each of that
    # step's cross-attention launches (phase 4h's counted step)
    kernels.append({
        "name": "flash_attention_cross", "route": "cuda",
        "source": SOURCES["flash_attention_cross"],
        "replaces": REPLACES["flash_attention_cross"],
        "launches": dry_counts["flash_attention_cross"],
        **{k: dry_row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "shape", "dtype", "kernel_route",
                                   "device_ms", "host_us",
                                   "library_device_ms")},
        "entry": "whisper_decode_32k"})
    # the xlstm-125m layer with bf16 R, as each of its prefill launches
    r = next(x for x in scan_rows
             if x["entry"] == "layer" and x["r_dtype"] == "bfloat16")
    kernels.append({
        "name": "slstm_scan", "route": "cuda", "source": SOURCES["slstm_scan"],
        "replaces": REPLACES["slstm_scan"], "launches": scan_launches,
        "max_abs_err": max(x["max_abs_err"] for x in scan_rows),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None, "entry": "layer",
        "shape": r["shape"], "r_dtype": r["r_dtype"],
        "latency_floor_ms": r["latency_floor_ms"]})
    # the training path (phase 5): #4's forward at the qwen3-0.6b layer and
    # its backward kernel there, #3's bf16 mode at the embedding leaf, each
    # with the launches of the train step's steps and the launcher's rounds
    r = next(x for x in attn_rows
             if x["entry"] == "layer" and x["dtype"] == "bfloat16")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"],
        "launches": train_counts["flash_attention"],
        "max_abs_err": max(x["max_abs_err"] for x in attn_rows
                           if x["kernel"] == "flash_attention"),
        **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "shape", "dtype")},
        "entry": "train"})
    r = next(x for x in train_rows if x["kernel"] == "flash_attention_bwd"
             and x["entry"] == "layer")
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": SOURCES["flash_attention_bwd"],
        "replaces": REPLACES["flash_attention_bwd"],
        "launches": train_counts["flash_attention_bwd"],
        "max_abs_err": max(x["max_abs_err"] for x in train_rows
                           if x["kernel"] == "flash_attention_bwd"),
        **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "shape", "dtype", "tol")},
        "products_per_pair": 5, "entry": "train"})
    r = next(x for x in train_rows if x["entry"] == "bf16_embed")
    kernels.append({
        "name": "dual_proximal_sgd", "route": "cuda",
        "source": SOURCES["dual_proximal_sgd"],
        "replaces": REPLACES["dual_proximal_sgd"],
        "launches": train_counts["dual_proximal_sgd"],
        "max_abs_err": max(x["max_abs_err"] for x in train_rows
                           if x["kernel"] == "dual_proximal_sgd"),
        **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "shape", "dtype", "entry")}})
    # zamba2's and phi-3-vision's training (phase 5): #4's forward at head
    # dim 80 / 96 at its layer shape (phase 2b) and its backward at the
    # train step's layer shape (phase 5a), each with the launches of that
    # model's training runs (its 3 steps, zamba2's launcher rounds or
    # phi-3's round, the reduced model's card-vs-host step and round)
    for D, layer in ((80, "zamba2_layer"), (96, "phi3_layer")):
        fwd_key = f"flash_attention_d{D}"
        r = next(x for x in attn_rows if x["kernel"] == fwd_key
                 and x["entry"] == f"d{D}_layer"
                 and x["dtype"] == "bfloat16")
        kernels.append({
            "name": fwd_key, "route": "cuda", "source": SOURCES[fwd_key],
            "replaces": REPLACES[fwd_key],
            "launches": zoo_counts[D][fwd_key],
            "max_abs_err": max(x["max_abs_err"] for x in attn_rows
                               if x["kernel"] == fwd_key),
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "shape", "dtype")},
            "entry": "train"})
        r = next(x for x in train_rows if x["entry"] == layer)
        kernels.append({
            "name": "flash_attention_bwd", "route": "cuda",
            "source": SOURCES["flash_attention_bwd"],
            "replaces": REPLACES["flash_attention_bwd"],
            "launches": zoo_counts[D]["flash_attention_bwd"],
            "max_abs_err": max(x["max_abs_err"] for x in train_rows
                               if x["kernel"] == "flash_attention_bwd"
                               and x["shape"]["D"] == D),
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "shape", "dtype", "tol",
                                 "launches_per_step")},
            "products_per_pair": 5, "entry": f"train_d{D}"})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
