#!/usr/bin/env python3
"""Smoke-run the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build  — compile every CUDA source of the port with nvcc (one
   process per source, started together) and print the build seconds
   and ptxas's register/shared-memory report; count the tensor-core
   instructions (HGMMA in flash_tc_kernel, HMMA in gqa_chunk_tc_kernel,
   mla_tc_kernel, qconv1d_tc_kernel, ssd_state_tc_kernel and
   ssd_chunk_tc_kernel, HMMA or HGMMA in each qmatmul_tc_kernel: HGMMA
   at 64 rows) in ``cuobjdump -sass`` of the built libraries, and fail
   on none.
2. kernel — hold each kernel against its plain PyTorch version on the
   card at the main path's shapes (qconv1d_block on the unpadded
   window, the plain version on the padded one: C=344, every RUBICALL
   k, B=4, T=2500, a ragged T and T < k, ReLU on and off; fp32 on the
   CUDA-core route with TF32 off at 1e-3, bf16 on the tensor-core route
   at one bf16 ulp), then time each route's kernel, plain version, the
   library composition (device time, host excluded, L2-warm) and the
   computed bound at B=4, T=2500.
3. serve  — full-width RUBICALL (28 blocks, C=344, bf16), random
   seeded weights packed to int8 as ``launch/serve.py --wbits 8`` does,
   served through the port's ServingEngine (4 slots, 1024-sample
   chunks, warmup) on 8 simulated reads. Checks every read finishes,
   the kernel launched 19 times per forward, all on the tensor-core
   route, and one tick's log-probs through the kernels agree with the
   same tick through the plain versions on the card (bf16 on the
   tensor-core route, fp32 on the CUDA-core route).
4. kernel (LM) — hold qmatmul (int8 and int4 at every qwen1.5-4b
   projection shape, M = 4 and 64, ragged shapes; each call on the
   route the wrapper picks, asserted: bf16 tensor-core, fp32 CUDA-core)
   and the paged
   attention kernels (qwen1.5-4b's 20 x 128 heads and chatglm3-6b's 2
   KV heads x group 16; block_len 16; fp32, bf16, fp8, int8 and fp16
   arenas; holes, out-of-order blocks, pad rows, a ring window; C = 1,
   4, 16; also at 2048 positions, where the tensor-core kernel splits
   the walk across CTAs, at R = C * group = 1, 4, 16 and 256) against
   their plain versions, checking each call's route (tensor-core over
   bf16, fp8, int8 and fp16 arenas at any C, CUDA-core over fp32),
   then time kernel, plain version, library call and bound at the
   served shapes (qmatmul on both routes at M = 4 and 64, summed over
   one qwen1.5-4b decode and one mixed tick; the decode at 160, 256 and
   2048 positions and on its fp32 route, the chunk at 160 and 2048).
5. serve (LM) — full-width qwen1.5-4b (40 layers, d 2560, no depth
   cut), seeded random weights drawn on the card and packed to int8
   under QuantPolicy(8, 0), a bf16 paged arena (block_len 16), 4 slots,
   prefill chunk 16, warmup; 8 greedy and 2 sampled requests of 32-128
   prompt tokens and 32 new tokens. Checks every request finishes, the
   kernel launches reconcile with the ticks the plans ran (281 qmatmul
   per tick, 40 attention launches per tick: gqa_paged on C = 1 ticks,
   gqa_paged_chunk on wider ones, every one of both and every qmatmul
   launch on the tensor-core route), and one mixed and one decode tick
   through the kernels agree
   with the same ticks through the plain versions on the same pool
   state: bf16 as served, over an fp16 copy of the arena (both on the
   tensor-core route) and in fp32 (the CUDA-core route).
6. trace (LM) — host enqueue, device and wall time of one decode and
   one mixed tick, then the device busy share and top kernels under
   torch.profiler. The qwen engine is then freed.
7. kernel (MLA) — hold mla_paged (C = 1) and mla_paged_chunk (C = 16)
   against their plain versions at deepseek-v3's widths (128 heads,
   latent 512, rope 64, block_len 16; fp32, bf16, fp8, int8 and fp16
   arenas; holes, out-of-order blocks, pad rows) at 160 and 2048
   positions, checking each call's route (tensor-core over bf16, fp8,
   int8 and fp16 arenas, CUDA-core over fp32), then time both routes
   (``path=``), plain version, library call and bound (bf16): the
   decode at 160, 256 and 2048 positions, the chunk at 160 and 2048.
8. serve (MLA) — full-width deepseek-v3-671b cut to 4 layers (3
   mla_dense + 1 mla_moe with all 256 experts, top-8 and the shared
   expert), seeded random weights drawn on the card and packed to int8
   as they are drawn, a bf16 latent arena, the same engine settings and
   traffic as phase 5. Checks as phase 5: every request finishes,
   launches reconcile with the ticks (mla_paged on C = 1 ticks,
   mla_paged_chunk on wider ones, 4 a tick; qmatmul per tick counted
   from the projections; every one of the three on the tensor-core
   route), kernel vs plain ticks (bf16 and the fp16 arena on the
   tensor-core route, fp32 on the CUDA-core one; the tick is called
   eagerly, so the plain path can replay the kernel path's routing);
   peak device memory. The MoE block routes on the device at fixed
   shapes (``moe._routed``), so every plan of this runner is a CUDA
   graph as phase 26 checks them.
9. graphs (MLA) — over phase 8's weights (not drawn again), the same
   traffic drained through an engine with graph plans and one with
   eager plans, as phase 26 does (``lm_graphs``): the same tokens and
   statuses, launches by route, retraces 0, one graph a plan, each
   graph's kernel nodes equal to its capture's tally, a mixed and a
   decode tick's logits bit for bit, both plan kinds traced; the peak
   device memory after warmup and after each drain. The deepseek
   weights are then freed.
10. kernel (prefill) — hold flash_attention (qwen1.5-4b's 20 x 128
   heads and a GQA case of group 8; causal and not; S 512 and 2048,
   ragged S 333 and 129 and Sq != Sk; fp32 at 1e-4 on the CUDA-core
   route, bf16 at one bf16 ulp on the tensor-core route) and ssd_scan
   (mamba2-130m's 24 heads of 64, state 128, chunk 256; S 2048 and a
   ragged 2000; y and the final state; fp32 at 5e-3 on the CUDA-core
   route, bf16 y at one bf16 ulp on both routes, the route asserted)
   against their plain versions, print the error of P . V with p as one
   bf16 term and as the kernel's two, then time kernel (ssd_scan on both
   routes), plain version, library call
   (F.scaled_dot_product_attention for flash; none for the SSD scan)
   and bound at the served shapes.
11. static (mamba2) — full-width mamba2-130m (24 layers, no cut),
   seeded bf16 weights drawn on the card, through launch/serve.py's
   static path (run_static): 4 prompts of 2048 tokens, 32 greedy new
   tokens, through its two plans captured as CUDA graphs (the prefill,
   and the decode step with its position staged on the card), then
   again through eager plans on the same weights and prompts: the same
   tokens, the prefill's last-position logits and every cache leaf
   after the last step bit for bit (a leaf one bf16 ulp off at most is
   listed), the same launches by route, 2 graphs and no retrace; prints
   each kind's capture s, prefill ms and decode ms a step and tok/s, and
   the peak memory after the graphed run. Checks ssd_scan launched 24
   times in the prefill, all on the tensor-core route, and never in the
   decode (and nothing else), and that the prefill's
   last-position logits and every layer's handed-off h/conv state
   through the kernel agree with the same prefill through the plain
   version, in fp32 and bf16; prints prefill ms, decode tok/s, peak
   device memory and a trace of one prefill with ssd_scan's share.
12. static (qwen1.5-4b) — the same for full-width qwen1.5-4b (40
   layers, no cut), weights drawn again on the card as int8 packed as
   drawn and dequantized once to bf16 (``--static --wbits 8``), 4
   prompts of 512 tokens: flash_attention launched 40 times in the
   prefill, all on the tensor-core route, never in the decode.
13. stream — full-width RUBICALL as phase 3 serves it, fed LIVE reads
   through ``launch/serve.py``'s ``run_streamed``: 8 reads of 1000-2000
   bases (9k-18k samples; a frame is stable only once 3237 samples past
   it have arrived), Poisson starts at 4 reads/s, appended at PORE_HZ
   on the wall clock. Under qos ``accuracy`` and ``latency``: every
   read finishes, qconv1d_block launches 19 times per forward, all on
   the tensor-core route, and no idle tick reaches the runner; prints
   emit-latency p50/p99, forwards and windows per read, tick p50. Then,
   with the activation quantizers off (still bf16, same route), the
   streamed ``accuracy`` bases of 4 reads equal the same reads served
   whole, token for token. Then read-until: the classifier trained on
   the card by ``make_read_until`` (32 windows a class of 7500
   samples, 150 steps), 8 reads at ``--target-frac 0.5``, ejecting
   after 2 windows: every read finishes or is ejected, each ejected
   read after at most 2 x 1026 samples; prints ejections, off-target
   rejected, on-target lost, samples saved. One read-until tick is
   traced (the classifier's kernels and their share; its one readback
   of log-probs and logits). Last, forced verdicts on a replayed append
   schedule: threshold +1e9 ejects every read after 2 windows, -1e9
   none, with the bases of the same schedule served without
   read-until.
14. train — full-width RUBICALL (28 blocks, C=344, no cut) trained as
   ``launch/train.py`` trains it: ``train_loop.run``, fp32 params and
   AdamW state, bf16 compute, its QABAS fake-quant on, 50 steps of 8 x
   2048 simulated samples, checkpoints every 25 steps into a temporary
   directory. Checks every loss is finite, the mean of the last 10 is
   below the mean of the first 10, and the step-50 checkpoint restores
   bit for bit; prints the losses at steps 1, 25 and 50, step time p50
   (CUDA events, host enqueue beside it), samples/s, peak device memory
   and one traced step. Then the offline identity gate on the benchmark
   simulator (``training/evaluate.py``): rubicall-smoke under
   QuantPolicy(8, 8) trained 300 steps, and full-width RUBICALL for
   ``FULL_TRAIN_STEPS`` steps (a fixed count: a time budget made the
   count follow the host, and near the onset of emission, ~100 steps,
   kernel and plain parted); each basecalls its held-out reads
   with float weights, with int8-packed weights through qconv1d_block
   (3 launches a forward on the CUDA-core route at smoke, packed with
   min_size=1; 19 on the tensor-core route at full width, packed as
   ``launch/serve.py --wbits 8``) and through the plain version; the
   kernel's identity must be within 0.005 of the plain version's (no
   absolute identity is gated). Last, the RUBICON core on the card: a
   QABAS search over TINY_SPACE, ``derive_config``, one SkipClip step
   from a bonito-smoke teacher, pruning and packing the student.
15. lm_train — LM training on the card through ``train_loop.run`` as
   ``launch/train.py`` runs it (fp32 master leaves drawn on the card,
   bf16 compute, AdamW, every block rematerialised; the training forward
   runs ``blockwise_attn``, the chunked SSD and the MoE routing, never
   the prefill kernels, which have no backward): full-width qwen1.5-4b
   cut to 8 of 40 layers, 4 x 1024 tokens of the synthetic token stream,
   30 steps (finite, falling loss); mamba2-130m whole (24 layers, chunk
   256), 4 x 2048, 10 steps (finite loss and gradients); full-width
   granite-moe-1b-a400m (all 32 experts, top-8), 4 x 1024, 10 steps
   (finite loss and aux). Each prints its cut, the losses at the first,
   middle and last step, step p50 (CUDA events, host enqueue beside
   it), tokens/s, the step's matmul FLOPs, peak device memory and one
   traced step (launches, device ms, busy share). Then the card's loss
   and every gradient leaf at smoke size (qwen1.5-4b, granite-moe,
   deepseek-v3 with MLA, MoE and MTP, mamba2) against the CPU's, fp32
   with TF32 off, each leaf within 1e-5 of the tree's largest; the
   mixers' projections (wq, wk, wv; MLA's; the SSM's in_proj) non-zero,
   and no kernel launched.

16. rubicon — RUBICON's own front door on the card. First
   ``launch/serve.py --knob-search`` (``core/qabas/serving.py``) at
   full-width qwen1.5-4b (40 layers, no cut), int8 weights drawn on the
   card under QuantPolicy(8, 0), 4 slots, ``--attn-backend auto`` (both
   ``gather`` and ``cuda``), block_len 16 and 8, bf16, fp8 and int8
   arenas, 8 requests of 8 prompt and 8 new tokens a candidate,
   ``--knob-budget 10`` (the baseline, every fp8 and int8 candidate
   and bf16 on ``cuda``). It prints the ranked table; each candidate's
   pool must equal the arena's analytic size, every ``cuda`` candidate
   launch gqa_paged and gqa_paged_chunk on the tensor-core route, 40 a
   tick, every ``gather`` candidate none, and every candidate 281
   qmatmul launches a tick on the tensor-core route. In each
   candidate's warm drain (the first of three) every paged-attention
   call is held against its plain version on the same pool state at
   phase 4's tolerances (block_len 8 and 16), and each served row's
   top logits are kept: each ``cuda`` candidate's greedy tokens are read
   against the ``gather`` candidate of its cache mode, the shared
   steps' top-1 logits within phase 5's one-tick bound and, where
   tokens part, the two margins crossed within twice that bound; the
   three drains of a candidate must serve the same tokens. The tok/s
   are launch and route evidence, not a measurement of the knobs: at
   8 + 8 tokens the pool is a sliver beside the weights. Then the three
   examples (``examples/*_torch.py``) as subprocesses on the card at
   their default flags (serve_quantized_lm at qwen1.5-4b-smoke): each
   exits 0; prints their seconds, identities and tok/s.
17. serve (hybrid) — full-width hymba-1.5b (32 layers: hybrid_full at
   0, 16 and 31, hybrid_swa with a 1024 window between; 25 x 64 query
   heads over 5 KV heads; 50 SSM heads of 64, state 16), int8 weights
   drawn on the card under QuantPolicy(8, 0), a bf16 paged arena (4
   slots, chunk 16, block_len 16, cache_len 1280: window layers ring at
   1024), 8 greedy requests of 32-128 prompt tokens and one of 1100,
   16 new tokens each. The ``cuda`` drain: every request finishes, 32
   gqa_paged (C == 1) or gqa_paged_chunk (wider) launches a tick on the
   tensor-core route, no qmatmul (no projection meets the reference's
   tiling contract at d_model 1600) and no other kernel, every paged
   call held against its plain version (replayed from a CUDA graph) at
   phase 4's tolerances; then the ``gather`` drain of the same
   requests on the same weights (the rings wrap there too), its greedy
   tokens read against the ``cuda`` ones under phase 16's
   near-tie rule; pool bytes by class, a traced decode and mixed tick,
   peak memory. Then the static path (``--static --wbits 8``, 4 prompts
   of 1536 tokens, 32 new) graphed against eager plans as phase 11
   runs it: flash_attention 3 times (the full layers)
   and ssd_scan 32 times in the prefill, none in the decode, the
   prefill through the kernels against their plain versions in fp32 and
   bf16, and a traced prefill.
18. serve (ssm) — full-width mamba2-130m (24 layers) through the engine
   on phase 17's traffic (the slot recurrence, no KV pool), int8
   weights drawn on the card: 24 qmatmul launches a tick (out_proj) on
   the tensor-core route, each held against its plain version, no
   other kernel; its greedy tokens read against the static path's
   (the chunked SSD prefill through ssd_scan, then the one-token decode)
   on the same weights and prompts under the near-tie rule.
19. serve (audio) — full-width whisper-tiny (arXiv:2212.04356: 4
   encoder and 4 xdec layers, d 384, 6 heads of 64, d_ff 1536, 1500
   frames, vocab 51865), int8 weights drawn on the card, a bf16 paged
   arena (4 slots, chunk 16, block_len 16, cache_len 96); 8 greedy
   requests of 8-64 prompt tokens, each with its own seeded stub
   frames, 32 new tokens. The ``cuda`` drain: 32 qmatmul a tick; on
   width-1 ticks 8 gqa_paged (4 self-attention over the bf16 arena on
   tensor cores, 4 cross-attention over the fp32 encoder rows on CUDA
   cores), on wider ones 4 gqa_paged_chunk (the cross-attention's
   einsum launches none); 4 flash_attention (not causal) an admission
   on tensor cores; every launch held against its plain version, the
   cross-attention's calls in a bucket of their own at one bf16 ulp of
   the output (``CROSS_TOL``), each flash launch also on fp32 copies.
   Then the ``gather`` drain and the port's one-shot path (encode + prefill
   + decode_step), tokens read against the ``cuda`` drain's under the
   near-tie rule; the encoder buffer's and the pool's bytes against
   their analytic sizes, the admission's ms.
20. static+train (frontends) — the static path (``--static``) of
   whisper-tiny (4 x 64 tokens over 1500 frames), internvl2-1b whole
   (``--wbits 8`` dequantized to bf16, 4 x (256 patches + 256 tokens)),
   chatglm3-6b whole (2 x 128) and command-r-plus-104b and llama3-405b
   at published widths cut to 2 layers (2 x 128, 8 new tokens), each
   graphed against eager plans as phase 11 runs it: flash
   once a decoder and an encoder layer in the prefill (whisper 4 not
   causal and 4 causal), none in the decode, tensor-core; one eager
   prefill with every flash call held against its plain version in bf16 and
   fp32; prefill ms, decode tok/s, peak memory. Then 10 training steps
   each of whisper-tiny (4 x 448) and internvl2-1b (2 x 1024 after its
   256 patches) as phase 15 trains, on the token stream's first batch
   repeated (finite, falling loss, step p50, a traced step), card-vs-CPU
   loss and gradients at smoke for both, and whisper-tiny's training
   encoder over 1500 frames (blockwise, not causal, several chunks)
   against the dense plain attention at full width.
21. static (moe) — ``--static --wbits 8`` through ``run_static`` (4
   prompts of 512 tokens, 32 greedy new tokens; weights packed to int8
   as drawn on the card and dequantized once to bf16), graphed against
   eager plans as phase 11 runs it, of
   granite-moe-1b-a400m whole (24 ``moe`` layers, 32 experts, top-8)
   and deepseek-v3-671b at published widths cut to 4 layers (3
   mla_dense + 1 mla_moe, 256 experts, top-8 and the shared expert):
   granite's prefill launches flash_attention 24 times, all on the
   tensor-core route, and its decode none; deepseek's
   prefill (MLA: the plain ``blockwise_attn``, as the reference)
   launches none and its decode (the latent rows through
   ``decode_mla``'s gather route) scatter_rows 3 times a layer and step
   (the latent row, its rope key and its position, written in the
   reference's drop form). granite's eager prefill with every flash call held against
   its plain version in bf16 (one bf16 ulp) and on fp32 copies (1e-4),
   and its whole prefill through the kernel against the plain path in
   fp32 (1e-4) and bf16 (last-position logits, every layer's handed-off
   K/V; the plain pass replays the kernel pass's MoE routing and counts
   the tokens whose own routing would have differed); deepseek's bf16
   prefill the same way (no kernel: the two paths are one);
   prefill ms, decode tok/s, peak memory. Then ``decode_mla``'s
   contiguous ``cuda`` route (``table=None``: latent rows viewed as an
   arena of ``mla_contiguous_block_len`` blocks) held against its plain
   version at deepseek-v3's widths: L = 544 and the prime 541, C = 1
   and 16, bf16 (tensor-core) and fp32 (CUDA-core) rows, a hole and
   pad rows; the route of every launch asserted (these check launches
   are counted apart from the main path's).
22. dry run — ``python -m repro_torch.launch.dryrun`` as subprocesses
   (started before phase 17, CPU only, one thread each, at the lowest
   priority, all held to two of the host's cores, so phases 17 to 21
   run beside them on the other six) on qwen1.5-4b x decode_32k, granite-moe-1b-a400m x
   train_4k and deepseek-v3-671b x prefill_32k on the multi-pod mesh,
   each under the reference's schedule (``""``: the full masked grid)
   and the variants ``tri``, ``bf16attn`` and ``qc1024``: each record's
   roofline terms and per-device bytes printed, CUDA never initialised
   in them; the bmm flops of each train and prefill cell under the
   grid over the triangle, beside the reference's block pairs. Then on a one-rank
   NCCL group over the card: the dry run's per-device parameter bytes
   on the 1 x 1 host mesh for qwen1.5-4b-smoke and
   deepseek-v3-671b-smoke equal what ``api.init_params`` allocates on
   the card (``torch.cuda.memory_allocated`` before and after, each
   leaf's bytes rounded to the caching allocator's 512-byte blocks, and
   the leaves' own bytes exactly), and ``elastic.reshard`` moves a
   smoke tree onto that mesh bit for bit.
23. train (data-parallel) — a one-rank NCCL group over a file store (no
   socket) and ``train_loop.run(mesh=make_host_mesh(1))``: rubicall-smoke
   trained 20 steps data-parallel (BatchNorm's statistics and the
   activation amax all-reduced over the data group, the gradients
   averaged, rank 0's checkpoints behind a barrier) against the plain
   one-device loop from the same seed on the same batches: step 1's
   loss equal, steps 2 to ``DP_EARLY`` within ``DP_EARLY_RTOL`` and
   every step within ``DP_RTOL`` relative, two checkpoints written; a
   second plain run gives the card's own spread beside it; the step's
   wall ms of each, beside the card's name and power limit.
24. analysis — ``python -m repro_torch.analysis``'s five rules on the
   card (its full-width half runs after phase 6).
25. train (tensor-parallel) — two processes share the card through a
   gloo group over a file store (NCCL refuses two ranks on one card)
   and train on the ``(1, 2)`` host mesh through
   ``train_loop.run(mesh=make_host_mesh(2), device="cuda")``, at
   published widths, 3 steps each (``TP_RUNS``): qwen1.5-4b cut to 2 of
   40 layers and granite-moe-1b-a400m cut to 4 of 24, 4 x 1024 tokens
   (qwen: 10 of 20 heads, 3456 of 6912 MLP columns and 75968 of 151936
   vocabulary rows a rank; granite: 8 of 16 query and 4 of 8 KV heads,
   16 of 32 experts, its odd vocabulary whole); mamba2-130m cut to 8 of
   24 layers, 4 x 1024 (12 of 24 SSM heads a rank, B and C whole on
   both); hymba-1.5b cut to 4 of 32 layers (a ``hybrid_swa`` layer
   among them), 1 x 2048 (its 25/5 attention heads whole, 25 of 50 SSM
   heads a rank: the hybrid's mixed case); whisper-tiny whole, 4 x 448 over 1500 frames
   (3 of 6 heads of every attention a rank, its odd vocabulary whole);
   deepseek-v3-671b cut to one ``mla_moe`` layer and its ``mtp`` block,
   8 of 256 experts and 16160 of 129280 vocabulary rows (the share of
   one of 32 and of 8 cards), 1 x 256 (64 of 128 MLA heads, 4 of 8
   experts a rank). Each against the one-process bf16 run from the same
   seed on the same batches (qwen's and granite's with a second
   one-process run's spread beside it): step 1's loss within
   ``TP_RTOL_FIRST`` and steps 2-3 within ``TP_RTOL`` relative, both ranks' losses equal, each rank's parameter
   bytes equal to ``sharding.per_device_bytes`` on the mesh but for the
   leaves named where the unit rule and ``_filter_axes`` part
   (``TP_UNIT_PARTS``), and granite's and mamba2's step-3 checkpoints
   (whole leaves, gathered over the model group, written by rank 0;
   mamba2's ``in_proj`` and conv in segments) against the one-process
   ones leaf by leaf. Prints the all-reduces a step (calls and bytes,
   ``tensor_parallel.COUNTS``), each rank's peak memory, parameter and
   AdamW bytes, and the step ms of each run. This phase says nothing
   about speed: the ranks' all-reduces go through the host.
26. graphs (runs after phase 19) — the tick plans as CUDA graphs
   (``serving/plan.py``: each plan bucket captured once at warmup and
   replayed every tick) against eager plans (``graphs=False``). First
   scatter_rows, the tick's fixed-shape KV, scale and position writes
   with dropped sentinels, held byte for byte against its plain version
   (the filtered ``index_put_``) at the main path's row shapes (qwen's
   bf16, fp8, int8 and fp16 K/V and int8 scales, deepseek's latent and
   rope key, hymba's and whisper's K/V, the int32 positions), 4 and 64
   writes with every fourth dropped, and timed over one qwen1.5-4b
   decode tick's 120 launches beside its byte bound. Then RUBICALL at
   B = 4 with read-until (phase 13's classifier), qwen1.5-4b (6
   requests, 16 new: decode and mixed ticks, greedy and sampled),
   hymba-1.5b (2 requests, 8 new), mamba2-130m (4 of phase 18's short
   requests: the SSM-only runner) and whisper-tiny (phase 19's traffic) each
   drained through an engine with graph plans and one
   with eager plans: the same tokens, bases, statuses and ejections,
   the same launches by route, retraces 0, one graph a plan and none;
   so are qwen1.5-4b over an int8 and over an fp8 arena and on the
   ``gather`` backend (4 requests, 8 new: the served paths phase 16
   drives eagerly) and granite-moe-1b-a400m (24 layers, 32 experts,
   int8, its routing on the device; 4 requests, 8 new). Each
   captured graph is read node by node (``cudaGraphDebugDotPrint``):
   the port's kernels in it, by source, equal the launches its capture
   tallied, and the traced tick's graph holds what the same tick
   launches eagerly, so a launch counted under graphs is a node the
   device runs. One tick's outputs (RUBICALL's log-probs and
   classifier logits; a mixed and a decode tick's logits for the LMs,
   over one pool state) through a captured graph and eagerly, bit for
   bit or within an eager rerun's spread; each plan kind's tick traced
   (host enqueue, device, wall to readback; for the int8, fp8 and
   gather paths and granite-moe an all-pad decode tick; the eager plans
   without the profiler). Every profiled trace (this phase's and those
   of phases 3, 6, 9, 11-15 and 17; device activity only) prints the
   port's kernels that torch.profiler saw start beside the launches
   counted (the profiler has lost a few kernels of a long run). Phases that swap or
   watch a kernel wrapper in Python (16-19) serve through eager plans;
   every other runner, the MoE ones included, captures every plan.

Prints each phase's seconds, the card's name and power limit, a
``{"kernels": [...]}`` line, and as its last line ``{"ok": true,
"device": {...}}``. Exits non-zero
without CUDA, and when run outside a checkout of the repository.
"""
from __future__ import annotations

import ast
import contextlib
import functools
import gc
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types
from dataclasses import replace
from pathlib import Path
from typing import Optional
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.config import QuantPolicy, get_config  # noqa: E402
from repro_torch.core.quant.policy import (Packer, PackedTensor,  # noqa: E402
                                           quantize_tensor, tree_items,
                                           tree_leaves, tree_map)
from repro_torch.kernels import _build, ops, qconv1d, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import qmatmul as qmm  # noqa: E402
from repro_torch.kernels import scatter_rows as sr  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.basecaller import classifier as rc  # noqa: E402
from repro_torch.models.basecaller import model as bc  # noqa: E402
from repro_torch.models.lm import attention as attn_mod  # noqa: E402
from repro_torch.models.lm import common  # noqa: E402
from repro_torch.models.lm import encdec  # noqa: E402
from repro_torch.models.lm import moe as moe_mod  # noqa: E402
from repro_torch.models.lm import transformer as tfm  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402
from repro_torch.serving import runner as runner_mod  # noqa: E402
from repro_torch.serving.plan import PlanCache  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from repro_torch.core import pruning, skipclip  # noqa: E402
from repro_torch.core.qabas.search import (QABASConfig,  # noqa: E402
                                           derive_config, run_search)
from repro_torch.core.qabas.space import TINY_SPACE  # noqa: E402
from repro_torch.core.quant.policy import (quantize_tree,  # noqa: E402
                                           tree_size_bytes)
from repro_torch.data.squiggle import SquiggleConfig, normalize  # noqa: E402
from repro_torch.data.squiggle import batches as squiggle_batches  # noqa: E402
from repro_torch.data.tokens import token_batches  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.training import evaluate as train_eval  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402
from repro_torch.training.checkpoint import leaf_items  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            adamw_update, init_opt_state)
from repro_torch.training.train_loop import TrainLoopConfig  # noqa: E402

# H100 SXM peaks (analysis/roofline.py, from NVIDIA's data sheet,
# dense): bytes/s of HBM3 and FLOP/s by operand type (bf16 on tensor
# cores, fp32 on CUDA cores).
HBM_BYTES_PER_S = roofline.HBM_BW
PEAK_FLOPS = {torch.bfloat16: roofline.PEAK_BF16,
              torch.float32: roofline.PEAK_FP32}

C = 344                       # RUBICALL width
B = 4                         # serving slots -> windows per forward
T_MAIN = 2500                 # frames per 7500-sample serving window
T_RAGGED = 1001               # not a multiple of the kernel's frame tile
KS = (5, 9, 25, 31, 55, 75)   # every RUBICALL kernel size
KERNEL_BLOCKS = range(5, 24)  # blocks 05-23 take qconv1d under --wbits 8
# fp32: the reference test's tolerance (tests/test_kernels.py). bf16:
# kernel and plain version both round an fp32 result to bf16, and their
# different fp32 summation orders can land on either side of a rounding
# boundary: one bf16 ulp, at most 2^-7 relative; atol covers fp32 order
# noise near zero (~1e2-sized terms, ~400 of them).
TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (2 ** -7, 1e-2)}
# one served tick, kernel path vs plain path: (mean, max) |d log-prob|
# and the least share of frames whose argmax agrees. As served (bf16,
# 8- and 4-bit activation fake-quant), a one-ulp difference of a block
# output can flip an activation grid step (1/7 of the tensor's max at 4
# bits) and that flip propagates: the first chip run measured mean 0.023,
# max 0.51, 99.7% agreement (PERF.md). In fp32 with the activation
# quantizers off only the fp32 summation order differs.
TICK_BF16 = (0.05, 2.0, 0.99)
TICK_FP32 = (1e-4, 1e-3, 0.999)


def qconv1d_bytes(b: int, t: int, c: int, k: int, esize: int) -> int:
    """Least bytes the function moves: x and y once, weights, scales."""
    return (b * (t + k - 1) * c * esize + k * c + c * c + 4 * c * 4
            + b * t * c * esize)


def qconv1d_flops(b: int, t: int, c: int, k: int) -> int:
    """Depthwise k-tap FMAs plus the C x C pointwise product."""
    return 2 * b * t * c * (k + c)


def bound_ms(nbytes: int, flops: int, dtype) -> tuple:
    """(least ms on an H100, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the plain versions are timed over this many copies of their arena: a
# plain call walks a table column in ~25 ops, thousands of times the
# kernel's time, and the 128 MB of copies the kernels need (hundreds of
# copies at 160 positions) made the plain timings most of phase 7
PLAIN_COPIES = 8


def device_ms(calls, reps: int = 5) -> float:
    """Median device time of one call of ``calls`` run back to back with
    the host out of the way: a sleep kernel holds the stream while the
    host enqueues every call, and the CUDA events bracket device work
    only. The LM phases' ``calls`` read distinct copies of their weights
    or arenas, so these come from HBM, as on the served path; the
    qconv1d calls repeat one window, L2-warm, as inside a forward."""
    for fn in calls[:2]:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    # sleep for twice the host's time to enqueue (and run) the calls, in
    # cycles of an SM clock of at most 2 GHz
    cycles = int((time.perf_counter() - t0) * 4e9) + 1_000_000
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for fn in calls:
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(calls))
    return statistics.median(times)


def qconv_inputs(rs: np.random.RandomState, b: int, t: int, k: int, dtype):
    """Unpadded x and packed weights for one kernel call, on the card."""
    dev = "cuda"
    x = torch.from_numpy(rs.randn(b, t, C).astype(np.float32))
    dw = quantize_tensor(torch.from_numpy(rs.randn(k, C).astype(np.float32)), 8)
    pw = quantize_tensor(torch.from_numpy(rs.randn(C, C).astype(np.float32)), 8)
    g = torch.from_numpy(rs.rand(1, C).astype(np.float32))
    bt = torch.from_numpy(rs.randn(1, C).astype(np.float32))
    return (x.to(dev, dtype), dw.data.to(dev), pw.data.to(dev),
            dw.scale.to(dev), pw.scale.to(dev), g.to(dev), bt.to(dev))


def qconv_plain(x, *w, relu=True):
    """The plain version on the unpadded window: the halo padded as
    ``ops.qconv1d_block`` pads it on the CPU, then
    ``ref.qconv1d_block_ref`` (the JAX kernel's signature)."""
    k = w[0].shape[0]
    pad = (k - 1) // 2
    return ref.qconv1d_block_ref(F.pad(x, (0, 0, pad, k - 1 - pad)), *w,
                                 relu=relu)


def library_qconv(args):
    """The same function (no ReLU, as RUBICALL's blocks call it) from
    library calls, timed only and never used by the port: cuDNN
    depthwise conv (its own zero padding; every k is odd) + cuBLAS
    linear with beta as bias."""
    x, dw_q, pw_q, dws, pws, g, bt = args
    k = dw_q.shape[0]
    w_dw = (dw_q.float() * dws).t().unsqueeze(1).to(x.dtype)    # (C, 1, k)
    w_pw = (pw_q.float() * pws * g).t().contiguous().to(x.dtype)
    xc = x.transpose(1, 2).contiguous()                        # (B, C, T)
    bias = bt.reshape(-1).to(x.dtype)
    return lambda: F.linear(F.conv1d(xc, w_dw, padding=(k - 1) // 2,
                                     groups=C).transpose(1, 2), w_pw, bias)


# the tensor-core kernels: (library, kernel name, the SASS instructions
# that show the tensor cores at work, as a regex alternation)
TENSOR_CORE_SASS = (("flash_attention", "flash_tc_kernel", "HGMMA"),
                    ("paged_attention", "gqa_chunk_tc_kernel", "HMMA"),
                    ("mla_paged_attention", "mla_tc_kernel", "HMMA"),
                    ("qconv1d", "qconv1d_tc_kernel", "HMMA"),
                    ("qmatmul", "qmatmul_tc_kernel", "HMMA|HGMMA"),
                    ("ssd_scan", "ssd_state_tc_kernel", "HMMA"),
                    ("ssd_scan", "ssd_chunk_tc_kernel", "HMMA"))


def sass_counts(lib: str, kernel: str, op: str) -> dict:
    """{mangled function: count of ``op`` instructions} over the
    functions of the built ``lib`` whose name holds ``kernel``, from
    ``cuobjdump -sass``."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build._target(lib))],
                          capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            if fn:
                counts[fn] = 0
        elif fn and re.search(rf"\b(?:{op})\b", line):
            counts[fn] += 1
    return counts


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] nvcc {built or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, log in _build.LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    for lib, kernel, op in TENSOR_CORE_SASS:
        counts = sass_counts(lib, kernel, op)
        if not counts or min(counts.values()) == 0:
            raise AssertionError(f"{kernel}: no {op} in the SASS of "
                                 f"{lib}: {counts}")
        print(f"[build] {lib}: {kernel}, {len(counts)} instantiations, "
              f"{op} instructions {sorted(counts.values())}")


QCONV_ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}


def phase_kernel() -> dict:
    """Kernel vs plain version at every shape, on the route each dtype
    takes, then each route's timings."""
    rs = np.random.RandomState(0)
    err_main = 0.0
    fn = qconv1d.qconv1d_block_cuda
    for dtype, route in QCONV_ROUTES.items():
        rtol, atol = TOL[dtype]
        for k in KS:
            for t in (T_MAIN, T_RAGGED, k // 2):     # k // 2: T < k
                args = qconv_inputs(rs, B, t, k, dtype)
                for relu in (True, False):
                    before = dict(fn.routes)
                    got = fn(*args, relu=relu)
                    if fn.routes != {**before, route: before[route] + 1}:
                        raise AssertionError(f"qconv1d {dtype} k={k}: "
                                             f"routes {before} -> "
                                             f"{fn.routes}, want {route}")
                    want = qconv_plain(*args, relu=relu)
                    torch.cuda.synchronize()
                    if got.shape != (B, t, C) or got.dtype != dtype:
                        raise AssertionError(f"qconv1d {tuple(got.shape)} "
                                             f"{got.dtype}")
                    torch.testing.assert_close(got.float(), want.float(),
                                               rtol=rtol, atol=atol)
                    err = float((got.float() - want.float()).abs().max())
                    print(f"[kernel] qconv1d_block {str(dtype)[6:]} k={k} "
                          f"T={t} relu={int(relu)} ({route}): max|err| "
                          f"{err:.3g} ok")
                    if dtype == torch.bfloat16 and t == T_MAIN:
                        err_main = max(err_main, err)
    per_route = {}
    for dtype, route in QCONV_ROUTES.items():
        per_k = per_route[route] = {}
        for k in KS:
            args = qconv_inputs(rs, B, T_MAIN, k, dtype)
            esize = torch.finfo(dtype).bits // 8
            nb = qconv1d_bytes(B, T_MAIN, C, k, esize)
            bms, by = bound_ms(nb, qconv1d_flops(B, T_MAIN, C, k), dtype)
            # relu=False: each RUBICALL block has one repeat, and sep_conv
            # calls the kernel without ReLU for a block's last repeat.
            # Device time with the host out of the way, the same call back
            # to back: L2-warm, as a block reads the window the block
            # before it just wrote
            row = {
                "ms": device_ms([lambda: fn(*args, relu=False)] * 20),
                "plain_ms": device_ms(
                    [lambda: qconv_plain(*args, relu=False)] * 5, reps=3),
                "library_ms": device_ms([library_qconv(args)] * 20),
                "bound_ms": bms, "bound_by": by}
            per_k[k] = row
            print(f"[kernel] qconv1d_block {str(dtype)[6:]} ({route}) B={B} "
                  f"T={T_MAIN} C={C} k={k}: kernel {row['ms']:.4f} ms | "
                  f"plain {row['plain_ms']:.4f} ms | library "
                  f"{row['library_ms']:.4f} ms | bound {bms * 1e3:.2f} us "
                  f"({by})")
    return {"err_main": err_main, "per_route": per_route}


def unit_gain(params) -> None:
    """Rescale each separable conv's random taps to unit gain. With the
    reference's init scale (dw std 0.2, pw std 0.02) a block's gain is
    0.12-0.35 in std, so some 15 blocks in the activations fall under
    the activation quantizer's 1e-8 scale floor and round to zero; a
    trained network's folded BN keeps them O(1), as this does."""
    for name, blk in params.items():
        if not name.startswith("block"):
            continue
        for rep in blk.values():
            if isinstance(rep, dict) and "dw" in rep:
                dw, pw = rep["dw"], rep["pw"]
                rep["dw"] = dw / (dw.std() * dw.shape[0] ** 0.5)
                rep["pw"] = pw * (2.0 / pw.shape[1]) ** 0.5 / pw.std()


def tick_both_paths(runner, cfg, window):
    """One batched window forward through the kernels and through the
    plain versions (the kernel wrapper swapped for its plain version on
    the unpadded window), on the card; checks the log-probs' shape and
    finiteness."""
    wins, start, rlen = (torch.from_numpy(a).to(runner.device)
                         for a in window)
    out = []
    for plain in (False, True):
        swap = (mock.patch.object(qconv1d, "qconv1d_block_cuda",
                                  qconv_plain)
                if plain else contextlib.nullcontext())
        with torch.inference_mode(), swap:
            out.append(bc.forward_window(runner.params, runner.state, wins,
                                         cfg, start, rlen).float())
    frames = wins.shape[1] // runner.stride
    for lp in out:
        if lp.shape != (B, frames, cfg.n_bases) or \
                not bool(torch.isfinite(lp).all()):
            raise AssertionError(f"log-probs {tuple(lp.shape)} not finite "
                                 f"or not ({B}, {frames}, {cfg.n_bases})")
    return out


# the port's kernels by CUDA source: the wrappers that count their
# launches there, and the kernels that start each counted launch, once
# (a split's combine or finish kernel and ssd's chunk pass follow it)
OWN_KERNELS = {
    "qmatmul.cu": (("qmatmul",), ("qmatmul_kernel", "qmatmul_tc_kernel")),
    "paged_attention.cu": (("gqa_paged", "gqa_paged_chunk"),
                           ("gqa_paged_kernel", "gqa_chunk_tc_kernel")),
    "mla_paged_attention.cu": (("mla_paged", "mla_paged_chunk"),
                               ("mla_paged_kernel", "mla_tc_kernel")),
    "qconv1d.cu": (("qconv1d_block",),
                   ("qconv1d_block_kernel", "qconv1d_tc_kernel")),
    "ssd_scan.cu": (("ssd_scan",), ("ssd_kernel", "ssd_state_tc_kernel")),
    "flash_attention.cu": (("flash_attention",),
                           ("flash_kernel", "flash_tc_kernel")),
    "scatter_rows.cu": (("scatter_rows",), ("scatter_rows_kernel",))}
OWN_FOLLOWERS = ("qmatmul_finish", "gqa_chunk_combine", "ssd_chunk_tc_kernel")


@contextlib.contextmanager
def kept_graphs():
    """CUDA graphs made inside keep their ``cudaGraph_t`` after they are
    instantiated (``keep_graph=True``), so that :func:`graph_census`
    can read their nodes."""
    base = torch.cuda.CUDAGraph

    class Kept(base):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, keep_graph=True)

        def __init__(self, keep_graph=False):
            super().__init__(keep_graph=True)
    with mock.patch.object(torch.cuda, "CUDAGraph", Kept):
        yield


# a kernel node of cudaGraphDebugDotPrint's verbose output: "{ID | 3
# (topoId: 0) | <mangled name>\<\<\<..."
DOT_KERNEL = re.compile(r"\{ID \| \d+ \(topoId: \d+\) \| ([^\\\s|}]+)")


def graph_nodes(graph) -> dict:
    """The port's kernels in one captured graph, read from the graph
    itself: {CUDA source: kernel nodes that start a launch}. A mangled
    name holds each identifier behind its length."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        names = DOT_KERNEL.findall(Path(path).read_text())
    out = {}
    for src, (_, heads) in OWN_KERNELS.items():
        n = sum(any(f"{len(h)}{h}" in name for h in heads) for name in names)
        if n:
            out[src] = n
    return out


def tally_by_source(tally) -> dict:
    """A capture's tally ({(wrapper, kernel, route): n}) by CUDA source."""
    out = {}
    for (_, kernel, _), n in tally.items():
        src = next(s for s, (ws, _) in OWN_KERNELS.items() if kernel in ws)
        out[src] = out.get(src, 0) + n
    return out


def graph_census(plans, where: str) -> dict:
    """Every captured plan of ``plans`` (made under :func:`kept_graphs`,
    not replayed yet; instantiated here, as a graph that is not kept is
    at the end of its capture): the port's kernel nodes in its graph,
    by source, against the launches its capture tallied, which each
    replay counts. They must be equal: a launch counted under graphs is
    then a node the device runs at every replay. Returns {plan key:
    {source: nodes}}."""
    out, t0 = {}, time.perf_counter()
    for key, st in plans._staged.items():
        if st.graph is None:
            continue
        # a kept graph is instantiated at its first replay, not at the
        # end of its capture: here, before any tick is timed
        st.graph.instantiate()
        nodes, tallied = graph_nodes(st.graph), tally_by_source(st.tally)
        if nodes != tallied:
            raise AssertionError(f"{where} plan {key}: the graph holds "
                                 f"{nodes} of the port's kernels, its "
                                 f"capture tallied {tallied}")
        out[key] = nodes
    print(f"[graphs] {where}: {len(out)} graphs read node by node in "
          f"{time.perf_counter() - t0:.1f}s, the port's kernels in each "
          f"equal to its capture's tally (e.g. "
          f"{next(iter(out.items()), None)})")
    return out


def kernel_name(key: str) -> str:
    """The function name in a profiler kernel key such as ``void
    (anonymous namespace)::qmatmul_tc_kernel<8, 1>(...)``."""
    m = re.search(r"(\w+)[<(]", key)
    return m.group(1) if m else key


def own_launches(averages, counted: dict) -> dict:
    """The port's kernels that torch.profiler saw start (``averages``:
    its ``key_averages()``), by CUDA source, beside the launches the
    wrappers counted in the same call: ``{source: [counted,
    profiled]}``, sources with either."""
    seen = {}
    for e in averages:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = kernel_name(e.key)
            seen[name] = seen.get(name, 0) + e.count
    out = {}
    for src, (wrappers, heads) in OWN_KERNELS.items():
        pair = [sum(counted.get(w, 0) for w in wrappers),
                sum(seen.get(h, 0) for h in heads)]
        if any(pair):
            out[src] = pair
    return out


def trace(label: str, enqueue, share: tuple = (), fetch=None,
          profiled: bool = True) -> dict:
    """Where one served tick's time goes. ``enqueue()`` enqueues the
    tick and returns its output on the card; ``fetch(out)`` reads it
    back (default ``out.cpu()``). Without the profiler: host time to
    enqueue, device time from the first enqueue to the last kernel (CUDA
    events), and wall time to the readback. Under torch.profiler
    (CUPTI; skipped where not ``profiled``, and ``own_launches`` then
    holds the launches counted in the timed call): the device time of
    every kernel, summed and by kernel, the share of the kernels whose
    names hold one of ``share``, and the port's kernels it saw start
    beside the launches the wrappers counted in that call
    (``own_launches``; printed, not a gate: the profiler has lost
    kernels of a long process, 2 of a graphed tick's 281 qmatmul in one
    whole run; :func:`graph_census` reads a graph's own nodes)."""
    from torch.profiler import ProfilerActivity, profile
    fetch = fetch or (lambda out: out.cpu())
    t_trace = time.perf_counter()
    enqueue()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    a.record()
    out = enqueue()
    b.record()
    t_host = time.perf_counter() - t0
    fetch(out)
    t_wall = time.perf_counter() - t0
    print(f"[trace] {label}: host enqueue {t_host * 1e3:.2f} ms, device "
          f"{a.elapsed_time(b):.2f} ms from first enqueue to last kernel, "
          f"wall to readback {t_wall * 1e3:.2f} ms")
    if not profiled:
        counted = {k: n - before[k] for k, n in ops.launch_counts().items()}
        own = {src: [sum(counted.get(w, 0) for w in wrappers), None]
               for src, (wrappers, _) in OWN_KERNELS.items()}
        own = {src: pair for src, pair in own.items() if pair[0]}
        print(f"[trace] {label}: the port's kernels by source, launches "
              f"counted { {s: c for s, (c, _) in own.items()} }; traced "
              f"in {time.perf_counter() - t_trace:.1f}s")
        return {"host_ms": t_host * 1e3, "device_ms": a.elapsed_time(b),
                "wall_ms": t_wall * 1e3, "own_launches": own}
    before = ops.launch_counts()
    # device activity only: the host's op events of an eager tick of
    # ~10,000 launches took ~10 s a trace to record and sort
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fetch(enqueue())
        t_prof = time.perf_counter() - t0
    counted = {k: n - before[k] for k, n in ops.launch_counts().items()}
    averages = prof.key_averages()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in averages
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    print(f"[trace] {label} under torch.profiler: device kernels "
          f"{busy:.2f} ms in {sum(r[1] for r in rows)} launches, wall "
          f"{t_prof * 1e3:.2f} ms (device busy {busy / (t_prof * 1e3):.1%})")
    # the top 8, then the port's own kernels further down
    own_names = {h for _, heads in OWN_KERNELS.values() for h in heads}
    own_names.update(OWN_FOLLOWERS)
    for i, (us, n, key) in enumerate(rows):
        if i < 8 or kernel_name(key) in own_names:
            print(f"[trace]   {us / 1e3:8.3f} ms  {n:4d}x  {key[:90]}")
    own = own_launches(averages, counted)
    parted = any(c != p for c, p in own.values())
    print(f"[trace] {label}: the port's kernels by source, launches "
          f"counted / started under the profiler "
          f"{ {s: f'{c}/{p}' for s, (c, p) in own.items()} }"
          + (" (the profiler lost or gained events)" if parted else "")
          + f"; traced in {time.perf_counter() - t_trace:.1f}s")
    out = {"host_ms": t_host * 1e3, "device_ms": a.elapsed_time(b),
           "wall_ms": t_wall * 1e3, "busy_ms": busy, "own_launches": own}
    out["launches"] = sum(r[1] for r in rows)
    if share:
        mine = [r for r in rows if any(k in r[2] for k in share)]
        out["share_ms"] = sum(r[0] for r in mine) / 1e3
        print(f"[trace] {label}: {'/'.join(share)} {out['share_ms']:.3f} ms "
              f"in {sum(r[1] for r in mine)} launches, "
              f"{out['share_ms'] / busy:.1%} of the device kernels")
    return out


def rubicall_served():
    """Full-width RUBICALL as phase 3 serves it: seeded weights at unit
    gain, packed to int8 as ``launch/serve.py --wbits 8`` does."""
    cfg = get_config("rubicall")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    unit_gain(params)
    return cfg, serve.quantize_for_serving(params, 8)


def no_act_quant(cfg):
    """``cfg`` with its activation quantizers off and its weight bits
    kept (the same blocks take the kernel)."""
    return replace(cfg, quant=QuantPolicy(8, 0, overrides=tuple(
        (p, (w, 0)) for p, (w, _) in cfg.quant.overrides)))


def phase_serve() -> dict:
    cfg, params = rubicall_served()
    engine = api.make_serving_engine(params, cfg, device="cuda", n_slots=B,
                                     chunk_samples=1024)
    runner = engine.runner
    t0 = time.perf_counter()
    engine.warmup()
    print(f"[serve] rubicall {cfg.n_blocks} blocks C={cfg.channels[0]} "
          f"{cfg.dtype}, window {runner.core + 2 * runner.halo} samples; "
          f"warmup {time.perf_counter() - t0:.2f}s")
    reads = serve.build_reads(types.SimpleNamespace(
        requests=8, rate=1.0, read_bases=300))
    ops.reset_launch_counts()
    # all reads queued up front: the batch composition, and so the bases
    # (activation fake-quant scales span the batch), repeat run to run
    for r in reads:
        engine.submit(r)
    engine.run()
    torch.cuda.synchronize()
    launches = ops.launch_counts()["qconv1d_block"]
    routes = ops.launch_counts(routes=True)
    check_routes(routes, ("qconv1d_block",), "rubicall served")
    st = engine.metrics.summary()
    forwards = st["bucket_hits"] + st["bucket_misses"]
    done = engine.completed
    if len(done) != len(reads) or any(r.status != "finished"
                                       for r in done.values()):
        raise AssertionError(f"reads not all finished: "
                             f"{[(r.rid, r.status) for r in done.values()]}")
    if forwards < 1 or launches != len(KERNEL_BLOCKS) * forwards:
        raise AssertionError(f"qconv1d_block launched {launches} times in "
                             f"{forwards} forwards, want "
                             f"{len(KERNEL_BLOCKS)} per forward")
    ticks = list(engine.metrics.tick_latency_samples)
    print(f"[serve] {st['requests_done']} reads, {st['generated_tokens']} "
          f"bases in {st['elapsed_s']:.3f}s: "
          f"{st['requests_done'] / st['elapsed_s']:.2f} reads/s, "
          f"{st['tokens_per_s']:.0f} bases/s | {forwards} forwards, "
          f"tick p50 {st['tick_latency_p50_s'] * 1e3:.2f} ms mean "
          f"{1e3 * sum(ticks) / len(ticks):.2f} ms | qconv1d_block "
          f"launches {launches} = {len(KERNEL_BLOCKS)} x {forwards}, "
          f"routes {routes['qconv1d_block']}")

    # one tick, kernel path vs the plain versions on the card: as served
    # (bf16, activation fake-quant on), then in fp32 with the activation
    # quantizers off (same 19 kernel blocks; no grid step can flip)
    chunks = [runner.make_chunks(r)[0].payload for r in reads[:B]]
    window = (np.stack([c[0] for c in chunks]),
              np.array([c[3] for c in chunks], np.int32),
              np.array([c[4] for c in chunks], np.int32))
    exact = replace(no_act_quant(cfg), dtype="float32")
    for name, c, bound in (("bf16 as served", cfg, TICK_BF16),
                           ("fp32, no act-quant", exact, TICK_FP32)):
        ops.reset_launch_counts()
        lp_k, lp_p = tick_both_paths(runner, c, window)
        r = ops.launch_counts(routes=True)
        check_routes(r, ("qconv1d_block",) if c is cfg else (),
                     f"rubicall tick, {name}")
        if r["qconv1d_block"] != {
                QCONV_ROUTES[getattr(torch, c.dtype)]: len(KERNEL_BLOCKS),
                "tensor_core" if c is exact else "cuda_core": 0}:
            raise AssertionError(f"rubicall tick, {name}: routes "
                                 f"{r['qconv1d_block']}")
        d = (lp_k - lp_p).abs()
        agree = float((lp_k.argmax(-1) == lp_p.argmax(-1)).float().mean())
        print(f"[serve] one tick kernel vs plain, {name}: mean|d logp| "
              f"{float(d.mean()):.3g} max {float(d.max()):.3g}, argmax "
              f"agree {agree:.4f}")
        if float(d.mean()) > bound[0] or float(d.max()) > bound[1] \
                or agree < bound[2]:
            raise AssertionError(f"served tick ({name}): kernel path "
                                 f"disagrees with the plain path")
    fwd = runner.plans.fn(runner._plan_key)        # eager: phase 26 graphs
    trace("one tick", lambda: fwd(*window))
    return {"launches": launches, "routes": routes["qconv1d_block"]}

# ---------------------------------------------------------------------------
# LM slice: full-width qwen1.5-4b

LM_ARCH = "qwen1.5-4b"
LM_SLOTS = 4
LM_CHUNK = 16                 # prefill chunk
LM_CACHE = 256                # per-request KV capacity -> 16 blocks/slot
BLOCK = 16                    # block_len
HD = 128                      # head_dim (qwen1.5-4b and chatglm3-6b)
# (K, N) of qwen1.5-4b's projections and how often a layer runs each:
# wq, wk, wv, wo; wi, wg; the MLP's wo. lm_head once per tick.
QWEN_PROJ = {(2560, 2560): 4, (2560, 6912): 2, (6912, 2560): 1}
QWEN_HEAD = (2560, 151936)
# the reference tests' tolerances: fp32 arenas 1e-5; bf16, fp8 and int8
# arenas (bf16 compute), fp16 arenas (fp16 compute) and qmatmul 2e-2
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2,
            torch.float8_e4m3fn: 2e-2, torch.int8: 2e-2,
            torch.float16: 2e-2}
QMM_TOL = 2e-2
# a bf16 query over fp32 rows (the audio family's cross-attention): fp32
# compute, then one bf16 rounding of the output, which fp32 sums in
# another order can land one bf16 ulp apart, at most 2^-7 of |want|
# (rtol, atol); tests/test_torch_cuda.py holds the same
CROSS_TOL = (2 ** -7, 1e-6)
QMM_ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
# One served tick, kernel path vs plain path on the same pool state:
# (largest |d logit| of a live row, least share of live rows whose
# argmax agrees). Bounds stated before the first run on the card. With
# seeded random weights (std 0.02) the final norm and the 2560-wide
# head give logits of std ~1. bf16 as served: both paths round every
# projection's fp32 sum to bf16 but in other summation orders, so a
# one-ulp difference (2^-8 relative) can start in any of 281 products
# per tick and carry through 40 residual layers: a few hundredths
# expected, 0.25 allowed; an argmax may flip where the top two logits
# are that close. fp32 compute (same weights and bf16 arena): only fp32
# summation order and the odd bf16 arena rounding that it moves.
LM_TICK_BF16 = (0.25, 0.5)
LM_TICK_FP32 = (0.02, 0.75)
MIXED_POSITIONS = 160         # cached positions of a row in the timed tick
FULL_POSITIONS = 256          # a row's whole table at LM_CACHE
LONG_POSITIONS = 2048         # a long row: the walk split across CTAs


def paged_inputs(rs, b, hkv, group, c, fills, arena, *, holes=(),
                 t_blocks=LM_CACHE // BLOCK, q_dtype=torch.bfloat16,
                 hd=HD):
    """Paged attention inputs on the card as the read sees them mid-tick:
    row i has positions [0, fills[i] + c) written (its c query tokens
    last) in arena blocks handed out in random order; every other byte
    is stale (99.0); ``holes`` (i, j) punches table entry j of row i back
    to -1 with its positions emptied. ``arena`` is the storage dtype
    (int8 comes with its fp32 scale arenas)."""
    bl, T = BLOCK, t_blocks
    n_blocks = b * T + 3
    k = torch.full((n_blocks, bl, hkv, hd), 99.0)
    v = torch.full((n_blocks, bl, hkv, hd), 99.0)
    table = torch.full((b, T), -1, dtype=torch.int32)
    pos = torch.full((b, T * bl), pa.EMPTY_POS, dtype=torch.int32)
    free = list(rs.permutation(n_blocks))
    t = torch.zeros((b, c), dtype=torch.int32)
    for i, n in enumerate(fills):
        t[i] = torch.arange(n, n + c)
        for j in range(-(-(n + c) // bl)):
            table[i, j] = int(free.pop())
        p = torch.arange(n + c)
        blk, off = table[i, p // bl].long(), p % bl
        k[blk, off] = torch.from_numpy(rs.randn(n + c, hkv, hd).astype(
            np.float32))
        v[blk, off] = torch.from_numpy(rs.randn(n + c, hkv, hd).astype(
            np.float32))
        pos[i, :n + c] = p.to(torch.int32)
    for i, j in holes:
        table[i, j] = -1
        pos[i, j * bl:(j + 1) * bl] = pa.EMPTY_POS
    if arena == torch.int8:
        (k, ks), (v, vs) = pa.quantize_kv(k), pa.quantize_kv(v)
        ks, vs = ks.cuda(), vs.cuda()
    else:
        k, v, ks, vs = k.to(arena), v.to(arena), None, None
    q = torch.from_numpy(rs.randn(b, c, hkv * group, hd).astype(np.float32))
    return dict(q=q.to("cuda", q_dtype), k=k.cuda(), v=v.cuda(), k_scale=ks,
                v_scale=vs, pos=pos.cuda(), t=t.cuda(), table=table.cuda())


def attn_call(x, fn_chunk, fn_single):
    """(kernel-or-plain) call on ``paged_inputs``: the single-token
    function for C == 1 (q folded to (B, Hkv, group, hd)), the chunk
    function otherwise; returns (B, C, H*hd)."""
    q = x["q"]
    B, Cq, H, hd = q.shape
    hkv = x["k"].shape[2]
    kw = dict(window=x.get("window", 0), k_scale=x["k_scale"],
              v_scale=x["v_scale"])
    if Cq == 1:
        return fn_single(q.reshape(B, hkv, H // hkv, hd), x["k"], x["v"],
                         x["pos"], x["t"][:, 0].contiguous(), x["table"],
                         **kw).reshape(B, 1, H * hd)
    return fn_chunk(q, x["k"], x["v"], x["pos"], x["t"], x["table"], **kw)


def attn_kernel(x):
    return attn_call(x, pa.gqa_paged_chunk_cuda, pa.gqa_paged_cuda)


def attn_plain(x):
    return attn_call(x, ref.gqa_paged_chunk_ref, ref.gqa_paged_ref)


def attn_library(x):
    """Gather + F.scaled_dot_product_attention with the validity mask:
    the same function from library calls, timed only, never used by the
    port."""
    q, k, v, pos, t, table = (x[n] for n in ("q", "k", "v", "pos", "t",
                                             "table"))
    B, Cq, H, hd = q.shape
    hkv, bl = k.shape[2], k.shape[1]
    L = table.shape[1] * bl

    def fn():
        idx = table.long().clamp(min=0)
        kr = k[idx].reshape(B, L, hkv, hd).transpose(1, 2).to(q.dtype)
        vr = v[idx].reshape(B, L, hkv, hd).transpose(1, 2).to(q.dtype)
        mask = (pos[:, None, :] >= 0) & (pos[:, None, :] <= t[:, :, None])
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kr, vr, attn_mask=mask[:, None],
            enable_gqa=H != hkv)
    return fn


def library_qmatmul(x, w_q, scale):
    """The same function from library calls (dequantize to x's dtype,
    ``torch.matmul``, scale), timed only, never used by the port."""
    return torch.matmul(x, w_q.to(x.dtype)) * scale


def qwen_qmatmul_plan() -> dict:
    """{(K, N): launches} of one qwen1.5-4b tick: each layer's
    projections and the head."""
    layers = get_config(LM_ARCH).n_layers
    return {**{kn: layers * m for kn, m in QWEN_PROJ.items()}, QWEN_HEAD: 1}


def qmatmul_tick(timing: dict, m: int) -> dict:
    """The qmatmul timings of one qwen1.5-4b tick at M = ``m``: each
    timed quantity summed over the tick's launches."""
    plan = qwen_qmatmul_plan()
    return {key: sum(timing[(m, k, n)][key] * c for (k, n), c in
                     plan.items())
            for key in (*qmm.ROUTES, "ms", "plain_ms", "library_ms",
                        "bound_ms")}


def attn_bound(x) -> tuple:
    """Least time for one call on this run's data: each assigned block's
    K and V (and positions) read once, q and t read, out written; 4 flops
    per query row, head dim and cached position of an assigned block."""
    q, k = x["q"], x["k"]
    B, Cq, H, hd = q.shape
    hkv, bl = k.shape[2], k.shape[1]
    blocks = int((x["table"] >= 0).sum())
    kv = blocks * bl * hkv * hd * k.element_size() * 2
    if x["k_scale"] is not None:
        kv += blocks * bl * hkv * 4 * 2
    nbytes = (kv + blocks * bl * 4 + 2 * q.numel() * q.element_size()
              + x["t"].numel() * 4 + x["table"].numel() * 4)
    flops = 4 * blocks * bl * Cq * H * hd
    return bound_ms(nbytes, flops, torch.float32 if k.dtype == torch.float32
                    else torch.bfloat16)


def phase_lm_kernel() -> dict:
    """qmatmul and paged attention vs their plain versions, then timed."""
    rs = np.random.RandomState(1)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    err = {"qmatmul": 0.0, "gqa_paged": 0.0, "gqa_paged_chunk": 0.0}
    # ---- qmatmul: every projection shape, int8 and int4, M = 4 and 64
    shapes = [(m, k, n, bits, torch.bfloat16)
              for (k, n) in list(QWEN_PROJ) + [QWEN_HEAD]
              for m in (4, 64) for bits in (8, 4)]
    shapes += [(5, 37, 50, 4, torch.float32), (130, 301, 200, 8,
                                                torch.bfloat16)]
    fn = qmm.qmatmul_cuda
    for m, k, n, bits, dt in shapes:
        w = quantize_tensor(randn(k, n), bits)
        x = randn(m, k).to(dt)
        route = QMM_ROUTES[dt]
        if qmm.route(dt, m) != route:
            raise AssertionError(f"qmatmul {dt} M={m}: route "
                                 f"{qmm.route(dt, m)}, want {route}")
        before = dict(fn.routes)
        got = fn(x, w.data, w.scale, bits=bits)
        if fn.routes != {**before, route: before[route] + 1}:
            raise AssertionError(f"qmatmul {dt} M={m}: routes {before} -> "
                                 f"{fn.routes}, want {route}")
        want = ref.qmatmul_ref(x, w.data, w.scale, bits=bits)
        torch.cuda.synchronize()
        if got.shape != (m, n) or got.dtype != dt:
            raise AssertionError(f"qmatmul {tuple(got.shape)} {got.dtype}")
        torch.testing.assert_close(got.float(), want.float(), rtol=QMM_TOL,
                                   atol=QMM_TOL)
        e = float((got.float() - want.float()).abs().max())
        if dt == torch.bfloat16 and bits == 8 and (k, n) != (301, 200):
            err["qmatmul"] = max(err["qmatmul"], e)
        print(f"[kernel] qmatmul int{bits} {str(dt)[6:]} M={m} K={k} N={n} "
              f"({route}): max|err| {e:.3g} ok")
    # ---- paged attention: qwen1.5-4b heads and chatglm3-6b's GQA
    cases = [(hkv, group, c, arena, 0, LM_CACHE)
             for hkv, group in ((20, 1), (2, 16))
             for arena in ATTN_TOL for c in (1, 4, 16)]
    cases.append((20, 1, 4, torch.bfloat16, 40, LM_CACHE))   # ring window
    # 2048 positions: the tensor-core kernel splits the walk across CTAs;
    # R = C * group = 1, 4, 16 and 256 query rows
    cases += [(hkv, group, c, arena, 0, LONG_POSITIONS)
              for hkv, group, c in ((20, 1, 1), (20, 1, 4), (20, 1, 16),
                                    (2, 16, 16))
              for arena in ATTN_TOL]
    for hkv, group, c, arena, window, cache in cases:
        x = paged_inputs(rs, 4, hkv, group, c, [cache - c, BLOCK - 1, 0,
                                                159], arena,
                         holes=[(0, 5)], t_blocks=cache // BLOCK,
                         q_dtype=(torch.float32 if arena == torch.float32
                                  else torch.bfloat16))
        x["t"][3, 1:] = -1                 # a decode row padded to C
        if c == 1:
            x["t"][2] = -1                 # a free slot
        x["window"] = window
        fn = pa.gqa_paged_cuda if c == 1 else pa.gqa_paged_chunk_cuda
        route = "tensor_core" if arena != torch.float32 else "cuda_core"
        before = dict(fn.routes)
        got = attn_kernel(x)
        if fn.routes != {**before, route: before[route] + 1}:
            raise AssertionError(f"gqa_paged C={c} {arena}: routes "
                                 f"{before} -> {fn.routes}, want {route}")
        want = attn_plain(x)
        torch.cuda.synchronize()
        live = x["t"] >= 0
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("gqa_paged: non-finite output")
        tol = ATTN_TOL[arena]
        torch.testing.assert_close(got.float()[live], want.float()[live],
                                   rtol=tol, atol=tol)
        e = float((got.float() - want.float())[live].abs().max())
        name = "gqa_paged" if c == 1 else "gqa_paged_chunk"
        if (hkv, arena, window) == (20, torch.bfloat16, 0):
            err[name] = max(err[name], e)
        print(f"[kernel] {name} Hkv={hkv} group={group} C={c} "
              f"{str(arena)[6:]} window={window} positions {cache} "
              f"({route}): max|err| {e:.3g} ok")
    # ---- device times at the served shapes (bf16, 4 slots), each call
    # on its own copy of the weights or arena (>= 128 MB in all, past L2)
    timing = {"qmatmul": {}, "attn": {}}
    for k, n in list(QWEN_PROJ) + [QWEN_HEAD]:
        copies = max(1, -(-(128 << 20) // (k * n)))
        ws = [quantize_tensor(randn(k, n), 8) for _ in range(copies)]
        for m in (4, 64):
            x = randn(m, k).to(torch.bfloat16)
            nbytes = k * n + 4 * n + 2 * m * k + 2 * m * n
            bms, by = bound_ms(nbytes, 2 * m * k * n, torch.bfloat16)
            row = {path: device_ms([functools.partial(
                qmm.qmatmul_cuda, x, w.data, w.scale, path=path)
                for w in ws]) for path in qmm.ROUTES}
            row.update({
                "ms": row[qmm.route(torch.bfloat16, m)],
                "plain_ms": device_ms([functools.partial(
                    ref.qmatmul_ref, x, w.data, w.scale) for w in ws]),
                "library_ms": device_ms([functools.partial(
                    library_qmatmul, x, w.data, w.scale) for w in ws]),
                "bound_ms": bms, "bound_by": by})
            timing["qmatmul"][(m, k, n)] = row
            print(f"[kernel] qmatmul int8 bf16 M={m} K={k} N={n}: "
                  f"tensor_core {row['tensor_core']:.4f} ms | cuda_core "
                  f"{row['cuda_core']:.4f} ms | plain {row['plain_ms']:.4f} "
                  f"ms | library {row['library_ms']:.4f} ms | bound "
                  f"{bms * 1e3:.2f} us ({by})")
        del ws
    for m, kind in ((LM_SLOTS, "decode"), (LM_SLOTS * LM_CHUNK, "mixed")):
        tick = qmatmul_tick(timing["qmatmul"], m)
        print(f"[kernel] qmatmul over one qwen1.5-4b {kind} tick (M={m}, "
              f"{sum(qwen_qmatmul_plan().values())} launches): tensor_core "
              f"{tick['tensor_core']:.4f} ms | cuda_core "
              f"{tick['cuda_core']:.4f} ms | plain {tick['plain_ms']:.4f} ms "
              f"| library {tick['library_ms']:.4f} ms | bound "
              f"{tick['bound_ms']:.4f} ms")
    # the decode on both routes (fp32 arena: CUDA cores) at the served
    # fill, the whole table and 2048 positions; the chunk at 160 and 2048
    for c, n, kv in ((1, MIXED_POSITIONS, torch.bfloat16),
                     (1, MIXED_POSITIONS, torch.float32),
                     (1, FULL_POSITIONS, torch.bfloat16),
                     (1, LONG_POSITIONS, torch.bfloat16),
                     (16, MIXED_POSITIONS, torch.bfloat16),
                     (16, LONG_POSITIONS, torch.bfloat16)):
        x = paged_inputs(rs, LM_SLOTS, 20, 1, c, [n - c] * LM_SLOTS,
                         kv, t_blocks=max(n, LM_CACHE) // BLOCK,
                         q_dtype=(torch.float32 if kv == torch.float32
                                  else torch.bfloat16))
        x["window"] = 0
        bms, by = attn_bound(x)
        arena = x["k"].numel() * x["k"].element_size() * 2
        xs = [dict(x, k=x["k"].clone(), v=x["v"].clone())
              for _ in range(max(1, -(-(128 << 20) // arena)))]
        row = {"ms": device_ms([functools.partial(attn_kernel, xi)
                                for xi in xs]),
               "plain_ms": device_ms([functools.partial(attn_plain, xi)
                                      for xi in xs[:PLAIN_COPIES]], reps=3),
               "library_ms": device_ms([attn_library(xi) for xi in xs]),
               "bound_ms": bms, "bound_by": by}
        name = "gqa_paged" if c == 1 else "gqa_paged_chunk"
        key = name if n == MIXED_POSITIONS else f"{name}@{n}"
        if kv == torch.float32:
            key = f"{name}/cuda_core"
        timing["attn"][key] = row
        print(f"[kernel] {name} {str(kv)[6:]} B={LM_SLOTS} C={c} Hkv=20 "
              f"hd={HD} positions 0..{n - 1}: kernel {row['ms']:.4f} ms | "
              f"plain {row['plain_ms']:.4f} ms | library "
              f"{row['library_ms']:.4f} ms | bound {bms * 1e3:.2f} us "
              f"({by})")
        del xs
    return {"err": err, "timing": timing}


def lm_tick(runner, cfg, tok, t, last=None, fresh=None, plain=False,
            caches=None):
    """One step of the served model on ``caches`` (the runner's pool by
    default), through the kernels or (``plain``) with every kernel
    wrapper swapped for its plain version; returns the live logits
    (B, V) in fp32."""
    pool = runner.pool
    caches = pool.caches if caches is None else caches
    swaps = ((qmm, "qmatmul_cuda", ref.qmatmul_ref),
             (pa, "gqa_paged_cuda", ref.gqa_paged_ref),
             (pa, "gqa_paged_chunk_cuda", ref.gqa_paged_chunk_ref),
             (pa, "mla_paged_cuda", ref.mla_paged_ref),
             (pa, "mla_paged_chunk_cuda", ref.mla_paged_chunk_ref))
    with contextlib.ExitStack() as stack, torch.inference_mode():
        if plain:
            for mod, name, fn in swaps:
                stack.enter_context(mock.patch.object(mod, name, fn))
        if fresh is not None:
            pool.mask_fresh_rows(caches, fresh)
        logits, _ = tfm.decode_step_slots(
            runner.params, caches, tok, t, cfg, logits_at=last,
            tables=pool.host_tables(), attn_backend=runner.attn_backend,
            layers=runner.layers)
    return logits[:, 0].float()


def lm_requests(cfg):
    """The LM phases' traffic: 8 greedy and 2 sampled requests of 32-128
    random prompt tokens and 32 new tokens, all queued at once."""
    rs = np.random.RandomState(0)
    reqs = []
    for i in range(10):
        plen = int(rs.randint(32, 129))
        sp = (SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50,
                             top_p=0.95, seed=i) if i in (3, 7)
              else SamplingParams(max_new_tokens=32))
        reqs.append(Request(rid=i, prompt=rs.randint(
            1, cfg.vocab_size, size=plen).tolist(), sampling=sp))
    return reqs


def qmatmul_per_tick(cfg) -> int:
    """Projections of one tick that take the quantized-matmul kernel: the
    packed ones (a group's stack holds ``min_size`` values or more, as
    ``api.init_params(wbits=8)`` packs) whose (M, K, N) meet the
    reference kernel's tiling contract (``common._qmatmul_tiles``, the
    same at every M a tick makes: 4 to 64). wukv is dequantized, the
    routed experts run dequantized rows, and neither is a projection.
    An SSM mixer (ssm, hybrid kinds) projects d -> 2 d_in + 2 N + nh and
    d_in -> d. An xdec block adds the cross-attention's q and o and
    runs an ungated MLP; its cross K/V project the encoder's 1500 frames
    at admission (M = 1500 fails the contract: dequantized)."""
    d, plan = cfg.d_model, tfm.layer_plan(cfg)
    hd = cfg.resolved_head_dim
    d_in = cfg.ssm_expand * d
    ssm = [(d, 2 * d_in + 2 * cfg.ssm_state + d_in // max(cfg.ssm_headdim,
                                                          1)), (d_in, d)]
    min_size = Packer(QuantPolicy(8, 0)).min_size
    shapes = []
    for kind, n in plan:
        if kind == "ssm":
            shapes += [(k, nn) for k, nn in ssm if n * k * nn >= min_size] * n
            continue
        if kind in tfm.MLA_KINDS:
            H, qr, kvr = cfg.n_heads, cfg.mla_q_lora_rank, \
                cfg.mla_kv_lora_rank
            nope, rope, vd = (cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim,
                              cfg.mla_v_dim)
            mix = [(d, qr), (qr, H * (nope + rope)), (d, kvr + rope),
                   (H * vd, d)]
        else:
            mix = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
                   (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d)]
            if kind in tfm.HYBRID_KINDS:
                mix += ssm
            if kind == "xdec":       # cross q and o; k, v at admission
                mix += [(d, cfg.n_heads * hd), (cfg.n_heads * hd, d)]
        if kind == "xdec":           # ungated MLP
            ffn = [(d, cfg.d_ff), (cfg.d_ff, d)]
        elif kind in tfm.MOE_KINDS:
            ff = cfg.moe_d_ff or cfg.d_ff
            sh = ff * cfg.n_shared_experts
            ffn = [(d, cfg.n_experts)] + (
                [(d, sh), (d, sh), (sh, d)] if sh else [])
        else:
            ff = (cfg.dense_d_ff or cfg.d_ff) if kind == "mla_dense" \
                else cfg.d_ff
            ffn = [(d, ff), (d, ff), (ff, d)]
        shapes += [(k, nn) for k, nn in mix + ffn
                   if n * k * nn >= min_size] * n
    if not cfg.tie_embeddings and d * cfg.vocab_size >= min_size:
        shapes.append((d, cfg.vocab_size))
    return sum(common._qmatmul_tiles(LM_SLOTS, k, n, 8) for k, n in shapes)


def check_routes(routes: dict, tensor_core: tuple, where: str) -> None:
    """Every launch in ``routes`` (``ops.launch_counts(routes=True)``) of
    a kernel in ``tensor_core`` took the tensor-core route, every other
    launch the CUDA-core one."""
    for name, r in routes.items():
        off = "cuda_core" if name in tensor_core else "tensor_core"
        if r[off]:
            raise AssertionError(f"{where}: {name} launched {r[off]} times "
                                 f"on the {off} route: {r}")


def phase_lm_serve(cfg, attn: tuple, bounds: tuple,
                   tensor_core: tuple = ()) -> dict:
    """Serve ``cfg`` at full width, int8 weights drawn and packed on the
    card, then one mixed and one decode tick through the kernels against
    the plain versions. ``attn``: the (C == 1, C > 1) attention kernels
    the path must launch once per layer and tick; ``bounds``: the (bf16,
    fp32) tick bounds; ``tensor_core``: the kernels whose served (bf16)
    launches must all take the tensor-core route (fp32 ones the CUDA-core
    route)."""
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, device="cuda", wbits=8)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    peak_init = torch.cuda.max_memory_allocated()
    engine = api.make_serving_engine(
        params, cfg, device="cuda", n_slots=LM_SLOTS, cache_len=LM_CACHE,
        prefill_chunk=LM_CHUNK, block_len=BLOCK,
        cache_dtype=torch.bfloat16)
    del params
    runner = engine.runner
    t0 = time.perf_counter()
    engine.warmup()
    print(f"[serve-lm] {cfg.name}: {cfg.n_layers} layers "
          f"{[k for k, _ in tfm.layer_plan(cfg)]}, d {cfg.d_model}, "
          f"{cfg.dtype}, int8 weights ({torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB on the card), {runner.attn_backend} attention over a "
          f"{runner.pool.quant_policy.describe()} arena of "
          f"{runner.pool.nbytes() / 2**30:.3f} GiB; drawn + packed in "
          f"{t_init:.1f}s (peak {peak_init / 2**30:.2f} GiB, "
          f"{before / 2**30:.2f} GiB held before), warmup "
          f"{time.perf_counter() - t0:.2f}s")
    reqs = lm_requests(cfg)
    ops.reset_launch_counts()
    runner.plans.calls.clear()
    for r in reqs:
        engine.submit(r)
    engine.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    by_route = ops.launch_counts(routes=True)
    check_routes(by_route, tensor_core, f"{cfg.name} served")
    calls = dict(runner.plans.calls)
    done = engine.completed
    if len(done) != len(reqs) or any(r.status != "finished" or
                                      len(r.out_tokens) != 32
                                      for r in done.values()):
        raise AssertionError(f"requests not all finished: "
                             f"{[(r.rid, r.status) for r in done.values()]}")
    ticks = sum(calls.values())
    narrow = sum(n for (_, w, _), n in calls.items() if w == 1)
    per_tick = qmatmul_per_tick(cfg)
    want = {"qmatmul": per_tick * ticks,
            attn[0]: cfg.n_layers * narrow,
            attn[1]: cfg.n_layers * (ticks - narrow),
            "scatter_rows": scatter_per_tick(cfg) * ticks}
    for name, n in want.items():
        if counts[name] != n or n == 0:
            raise AssertionError(f"{name} launched {counts[name]} times in "
                                 f"{ticks} ticks ({calls}), want {n}")
    others = {n: c for n, c in counts.items() if n not in want and c}
    if others:
        raise AssertionError(f"kernels off this path launched: {others}")
    # every served bf16 qmatmul launch the plans imply, on tensor cores
    if "qmatmul" in tensor_core and by_route["qmatmul"] != {
            "tensor_core": want["qmatmul"], "cuda_core": 0}:
        raise AssertionError(f"qmatmul routes {by_route['qmatmul']}, want "
                             f"{want['qmatmul']} on tensor_core")
    st = engine.metrics.summary()
    check_plan_stats(runner, cfg, st)
    decode_ticks = sum(n for (kind, _, _), n in calls.items()
                       if kind == "decode")
    print(f"[serve-lm] {cfg.name}: {st['requests_done']} requests (8 "
          f"greedy, 2 sampled), {st['generated_tokens']} tokens in "
          f"{st['elapsed_s']:.3f}s: {st['tokens_per_s']:.1f} tok/s, decode "
          f"{st['decode_tokens_per_s']:.1f} tok/s, TTFT p50 "
          f"{st['ttft_p50_s'] * 1e3:.1f} ms, decode interval p50 "
          f"{st['decode_interval_p50_s'] * 1e3:.2f} ms, tick p50 "
          f"{st['tick_latency_p50_s'] * 1e3:.2f} ms")
    print(f"[serve-lm] {cfg.name}: {ticks} ticks ({decode_ticks} "
          f"decode-only, {ticks - decode_ticks} mixed, {narrow} of width "
          f"1): launches qmatmul {counts['qmatmul']} = {per_tick} x "
          f"{ticks}, {attn[0]} {counts[attn[0]]} = {cfg.n_layers} x "
          f"{narrow}, {attn[1]} {counts[attn[1]]} = {cfg.n_layers} x "
          f"{ticks - narrow}; routes "
          f"{ {n: r for n, r in by_route.items() if counts[n]} }")

    # one mixed and one decode tick, kernels vs plain versions, on the
    # same pool state: rows 0-3 hold 48 positions written by the kernels
    pool = runner.pool
    for slot in range(LM_SLOTS):
        pool.release_slot(slot)
    for slot in range(LM_SLOTS):
        assert pool.alloc(slot, 64)
    trs = np.random.RandomState(1)
    dev_tok = torch.from_numpy(trs.randint(1, cfg.vocab_size, (LM_SLOTS, 64))
                               .astype(np.int32))
    for c0 in (0, 16, 32):
        t = torch.arange(c0, c0 + 16, dtype=torch.int32).repeat(LM_SLOTS, 1)
        fresh = torch.full((LM_SLOTS,), int(c0 == 0), dtype=torch.int32)
        lm_tick(runner, cfg, dev_tok[:, c0:c0 + 16], t,
                last=torch.full((LM_SLOTS,), 15, dtype=torch.int32),
                fresh=fresh)
    snap = {g: {n: a.clone() for n, a in tree.items()}
            for g, tree in pool.caches.items()}
    # the fp32 comparison reads an fp32 copy of the arena, so no bf16
    # rounding of the latent or of the MLA compute dtype is left in it
    wide = {g: {n: a.float() if a.is_floating_point() else a.clone()
                for n, a in tree.items()} for g, tree in snap.items()}
    # an fp16 arena (a served storage mode, ``--cache-dtype fp16``): the
    # bf16 state rounded to fp16, the kernels computing in fp16
    half = {g: {n: a.half() if a.dtype == torch.bfloat16 else a.clone()
                for n, a in tree.items()} for g, tree in snap.items()}

    def restore(caches=None):
        caches = pool.caches if caches is None else caches
        for g, tree in caches.items():
            for n, a in tree.items():
                a.copy_(snap[g][n])
    t_mixed = torch.full((LM_SLOTS, 16), -1, dtype=torch.int32)
    t_mixed[0:2] = torch.arange(48, 64, dtype=torch.int32)
    t_mixed[2, 0] = 48                     # a decode row; row 3 is a pad
    mixed = (dev_tok[:, 48:64], t_mixed,
             torch.tensor([15, 15, 0, 0], dtype=torch.int32))
    decode = (dev_tok[:, 48:49],
              torch.full((LM_SLOTS, 1), 48, dtype=torch.int32), None)
    live = {"mixed": [0, 1, 2], "decode": [0, 1, 2, 3]}
    exact = replace(cfg, dtype="float32")
    agree = {}
    # Expert routing is a discrete choice: a rounding difference between
    # the two paths that lands on a near-tie of two gates moves a token
    # to another expert. The plain path replays the kernel path's routing
    # (dispatch and combine weights), so the comparison measures the
    # kernels; the tokens whose own routing would have differed are
    # counted and printed.
    real_dispatch = moe_mod._top_k_dispatch
    routes, moved = [], [0, 0]

    def record(*args, **kw):
        out = real_dispatch(*args, **kw)
        routes.append(out)
        return out

    def replay(*args, **kw):
        own = real_dispatch(*args, **kw)[0].any(-1)     # (G, S, E)
        rec = routes[moved[1]]
        moved[0] += int((own != rec[0].any(-1)).any(-1).sum())
        moved[1] += 1
        return rec
    for label, c, bound, caches in (
            ("bf16 as served", cfg, bounds[0], pool.caches),
            ("fp16 arena", cfg, bounds[0], half),
            ("fp32 compute and arena", exact, bounds[1], wide)):
        for kind, (tok, t, last) in (("mixed", mixed), ("decode", decode)):
            out, routes[:], moved[:] = [], [], [0, 0]
            for plain, hook in ((False, record), (True, replay)):
                restore(caches)
                ops.reset_launch_counts()
                with mock.patch.object(moe_mod, "_top_k_dispatch", hook):
                    out.append(lm_tick(runner, c, tok, t, last, plain=plain,
                                       caches=caches))
                if not plain:
                    check_routes(ops.launch_counts(routes=True),
                                 tensor_core if c is cfg else (),
                                 f"{cfg.name} {kind} tick, {label}")
            lk, lp = (o[live[kind]] for o in out)
            if not bool(torch.isfinite(lk).all()):
                raise AssertionError("LM tick: non-finite logits")
            d = float((lk - lp).abs().max())
            a = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
            agree[f"{kind}, {label}"] = (d, a)
            routed = ""
            if routes:
                total = sum(int(r[0].any(-1).any(-1).sum()) for r in routes)
                routed = (f"; routing replayed: {moved[0]} of {total} routed "
                          f"tokens would have picked other experts")
            print(f"[serve-lm] {cfg.name}: one {kind} tick kernel vs plain, "
                  f"{label}: max|d logit| {d:.4g} (logit std "
                  f"{float(lk.std()):.3g}), argmax agree {a:.3f} over "
                  f"{len(live[kind])} live rows{routed}")
            if d > bound[0] or a < bound[1]:
                raise AssertionError(f"served {kind} tick ({label}): kernel "
                                     f"path disagrees with the plain path")
    del wide, half
    restore()
    print(f"[serve-lm] {cfg.name}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"launches": counts, "routes": by_route, "runner": runner,
            "cfg": cfg,
            "mixed": mixed, "decode": decode, "restore": restore,
            "per_tick": per_tick}


def phase_lm_trace(served: dict) -> dict:
    """Trace one decode and one mixed tick of the served plans on the
    comparison state (re-running a tick rewrites the same positions
    with the same values, so repeats see the same state)."""
    runner = served["runner"]
    served["restore"]()
    out = {}
    for kind, (tok, t, last) in (("decode", served["decode"]),
                                 ("mixed", served["mixed"])):
        B = LM_SLOTS
        zeros = torch.zeros((B,), dtype=torch.int32)
        fn = runner.plans.fn((kind, t.shape[1], "greedy"))
        args = ((tok, t, zeros, zeros, last) if kind == "mixed"
                else (tok, t, zeros, None, None))

        def enqueue():
            return fn(*args, runner.pool.host_tables(), None)
        out[kind] = trace(f"one {kind} tick ({served['cfg'].name}, B={B}, "
                          f"C={t.shape[1]})", enqueue)
    return out


# ---------------------------------------------------------------------------
# MLA slice: full-width deepseek-v3-671b, cut to 4 layers

DS_ARCH = "deepseek-v3-671b"
# 3 mla_dense + 1 mla_moe layer: the least depth that keeps every kind
# of layer (the published 61 layers are 3 + 58); widths, the 256 routed
# experts, top-8 and the shared expert as published
DS_LAYERS = 4
KVR, ROPE, NOPE, DS_H = 512, 64, 128, 128
MLA_SCALE = (NOPE + ROPE) ** -0.5
MLA_POSITIONS = (160, 2048)
# one served tick, kernel path vs plain path (bounds stated before the
# first run on the card): the tick is 4 layers deep; bf16 as served
# allows 0.5, fp32 compute (and an fp32 copy of the arena) 0.02: only
# summation order differs. The MoE routing is replayed (phase_lm_serve).
DS_TICK_BF16 = (0.5, 0.5)
DS_TICK_FP32 = (0.02, 0.75)


def latent_inputs(rs, b, c, fills, arena, *, holes=(), t_blocks,
                  q_dtype=torch.bfloat16):
    """MLA inputs on the card as the read sees them mid-tick: the arena
    of :func:`paged_inputs` with one KV head of width 512 + 64, split
    into the latent c (n_blocks, 16, 512) and kr (n_blocks, 16, 64) in
    the storage dtype ``arena``; q_abs (b, c, 128, 512) and q_rope (b,
    c, 128, 64)."""
    x = paged_inputs(rs, b, 1, 1, c, fills, torch.float32, holes=holes,
                     t_blocks=t_blocks, hd=KVR + ROPE)
    lat = x["k"][:, :, 0]
    cl, kr = lat[..., :KVR].contiguous(), lat[..., KVR:].contiguous()
    if arena == torch.int8:
        (cl, cs), (kr, krs) = pa.quantize_kv(cl), pa.quantize_kv(kr)
    else:
        cl, kr, cs, krs = cl.to(arena), kr.to(arena), None, None
    qa = torch.from_numpy(rs.randn(b, c, DS_H, KVR).astype(np.float32))
    qr = torch.from_numpy(rs.randn(b, c, DS_H, ROPE).astype(np.float32))
    return dict(qa=qa.to("cuda", q_dtype), qr=qr.to("cuda", q_dtype),
                c=cl, kr=kr, c_scale=cs, kr_scale=krs, pos=x["pos"],
                t=x["t"], table=x["table"])


def mla_call(x, fn_chunk, fn_single, **kw):
    """(kernel-or-plain) call on ``latent_inputs``: the single-token
    function for C == 1, the chunk function otherwise; returns o_lat
    (B, C, H, kvr)."""
    kw.update(scale=MLA_SCALE, c_scale=x["c_scale"],
              kr_scale=x["kr_scale"])
    if x["qa"].shape[1] == 1:
        return fn_single(x["qa"][:, 0], x["qr"][:, 0], x["c"], x["kr"],
                         x["pos"], x["t"][:, 0].contiguous(), x["table"],
                         **kw)[:, None]
    return fn_chunk(x["qa"], x["qr"], x["c"], x["kr"], x["pos"], x["t"],
                    x["table"], **kw)


def mla_kernel(x, path=None):
    """The kernel call; ``path`` names a route (timing only)."""
    return mla_call(x, pa.mla_paged_chunk_cuda, pa.mla_paged_cuda,
                    path=path)


def mla_plain(x):
    return mla_call(x, ref.mla_paged_chunk_ref, ref.mla_paged_ref)


def mla_library(x):
    """Gather + F.scaled_dot_product_attention with the validity mask,
    the latent as one shared KV head (keys [c | kr], values c): the
    same function from library calls, timed only, never used by the
    port."""
    qa, qr, c, kr, pos, t, table = (x[n] for n in ("qa", "qr", "c", "kr",
                                                   "pos", "t", "table"))
    B, Cq = qa.shape[:2]
    L = table.shape[1] * BLOCK

    def fn():
        idx = table.long().clamp(min=0)
        cr = c[idx].reshape(B, 1, L, KVR).to(qa.dtype)
        krr = kr[idx].reshape(B, 1, L, ROPE).to(qa.dtype)
        q = torch.cat([qa, qr], -1).transpose(1, 2)     # (B, H, C, 576)
        mask = (pos[:, None, :] >= 0) & (pos[:, None, :] <= t[:, :, None])
        return F.scaled_dot_product_attention(
            q, torch.cat([cr, krr], -1), cr, attn_mask=mask[:, None],
            scale=MLA_SCALE, enable_gqa=True)
    return fn


def mla_bound(x) -> tuple:
    """Least time for one call on this run's data: each assigned block's
    latent and rope rows (and scales, positions) read once, q_abs,
    q_rope, t and the table read, the fp32 o_lat written; 2 (kvr + rope)
    flops per query row and cached position for the scores and 2 kvr
    for PV."""
    qa, c = x["qa"], x["c"]
    B, Cq, H, kvr = qa.shape
    bl = c.shape[1]
    blocks = int((x["table"] >= 0).sum())
    lat = blocks * bl * (KVR + ROPE) * c.element_size()
    if x["c_scale"] is not None:
        lat += blocks * bl * 4 * 2
    nbytes = (lat + blocks * bl * 4
              + (qa.numel() + x["qr"].numel()) * qa.element_size()
              + B * Cq * H * kvr * 4 + x["t"].numel() * 4
              + x["table"].numel() * 4)
    flops = 2 * blocks * bl * Cq * H * (2 * KVR + ROPE)
    return bound_ms(nbytes, flops, torch.bfloat16)


def phase_mla_kernel() -> dict:
    """mla_paged / mla_paged_chunk vs their plain versions at
    deepseek-v3's widths on every arena dtype, then timed."""
    rs = np.random.RandomState(2)
    err = {"mla_paged": 0.0, "mla_paged_chunk": 0.0}
    for npos in MLA_POSITIONS:
        T = npos // BLOCK
        for arena in ATTN_TOL:
            for c in (1, 16):
                x = latent_inputs(
                    rs, 4, c, [T * BLOCK - c, BLOCK - 1, 0, npos // 2],
                    arena, holes=[(0, 5)], t_blocks=T,
                    q_dtype=(torch.float32 if arena == torch.float32
                             else torch.bfloat16))
                x["t"][3, 1:] = -1         # a decode row padded to C
                if c == 1:
                    x["t"][2] = -1         # a free slot
                name = "mla_paged" if c == 1 else "mla_paged_chunk"
                fn = getattr(pa, f"{name}_cuda")
                route = ("cuda_core" if arena == torch.float32
                         else "tensor_core")
                picked = pa.mla_route(arena, KVR, ROPE, BLOCK, npos)
                if picked != route:
                    raise AssertionError(f"{name} {arena}: route {picked}, "
                                         f"want {route}")
                before = dict(fn.routes)
                got = mla_kernel(x)
                if fn.routes != {**before, route: before[route] + 1}:
                    raise AssertionError(f"{name} C={c} {arena}: routes "
                                         f"{before} -> {fn.routes}, want "
                                         f"{route}")
                want = mla_plain(x)
                torch.cuda.synchronize()
                live = x["t"] >= 0
                if got.shape != (4, c, DS_H, KVR) or \
                        not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"mla_paged: {tuple(got.shape)} "
                                         f"or non-finite output")
                tol = ATTN_TOL[arena]
                torch.testing.assert_close(got[live], want[live], rtol=tol,
                                           atol=tol)
                e = float((got - want)[live].abs().max())
                if arena == torch.bfloat16 and npos == MLA_POSITIONS[0]:
                    err[name] = max(err[name], e)
                print(f"[kernel] {name} H={DS_H} kvr={KVR} rope={ROPE} "
                      f"C={c} {str(arena)[6:]} positions {npos} ({route}): "
                      f"max|err| {e:.3g} ok")
    # both routes (path=, timing only) of the decode at the served fill,
    # the whole table and 2048 positions, and of the chunk at 160 and
    # 2048; bf16 arena, the route the wrapper picks is the "ms"
    timing = {}
    for c, npos in ((1, MLA_POSITIONS[0]), (1, FULL_POSITIONS),
                    (1, MLA_POSITIONS[1]), (16, MLA_POSITIONS[0]),
                    (16, MLA_POSITIONS[1])):
        x = latent_inputs(rs, LM_SLOTS, c, [npos - c] * LM_SLOTS,
                          torch.bfloat16, t_blocks=npos // BLOCK)
        bms, by = mla_bound(x)
        arena = x["c"].numel() * x["c"].element_size()
        xs = [dict(x, c=x["c"].clone(), kr=x["kr"].clone())
              for _ in range(max(1, -(-(128 << 20) // arena)))]
        row = {path: device_ms([functools.partial(mla_kernel, xi, path)
                                for xi in xs]) for path in pa.ROUTES}
        row.update({
            "ms": row[pa.mla_route(torch.bfloat16, KVR, ROPE, BLOCK, npos)],
            "plain_ms": device_ms([functools.partial(mla_plain, xi)
                                   for xi in xs[:PLAIN_COPIES]], reps=3),
            "library_ms": device_ms([mla_library(xi) for xi in xs]),
            "bound_ms": bms, "bound_by": by})
        name = "mla_paged" if c == 1 else "mla_paged_chunk"
        timing[(name, npos)] = row
        print(f"[kernel] {name} bf16 B={LM_SLOTS} C={c} H={DS_H} "
              f"kvr={KVR} rope={ROPE} positions 0..{npos - 1}: tensor_core "
              f"{row['tensor_core']:.4f} ms | cuda_core "
              f"{row['cuda_core']:.4f} ms | plain {row['plain_ms']:.4f} ms "
              f"| library {row['library_ms']:.4f} ms | bound "
              f"{bms * 1e3:.2f} us ({by})")
        del xs
    return {"err": err, "timing": timing}


# ---------------------------------------------------------------------------
# Prefill slice: the static path of full-width mamba2-130m and qwen1.5-4b

SSM_ARCH = "mamba2-130m"
STATIC_SLOTS = 4
SSM_PROMPT = 2048             # mamba2 prompt tokens per row
QWEN_PROMPT = 512             # qwen1.5-4b prompt tokens per row
STATIC_NEW = 32               # greedy new tokens per row
FLASH_TOL = {torch.float32: (1e-4, 1e-4),   # tests/test_kernels.py:44
             torch.bfloat16: (2 ** -7, 1e-5)}
# SSD: fp32 at tests/test_kernels.py:101's 5e-3; bf16 y at one bf16 ulp
# (2^-7 relative) with atol 1e-3 for fp32 order noise on |y| up to ~50;
# the fp32 state at 5e-3 in both
SSD_TOL = {torch.float32: (5e-3, 5e-3), torch.bfloat16: (2 ** -7, 1e-3)}
# One whole-prompt prefill through the kernel vs through its plain
# version (bounds stated before the first run on the card): (max |d
# logit| of the last position, max |d| / max |ref| of every layer's
# handed-off state). fp32: only fp32 summation order differs. bf16 as
# served: a one-ulp difference of a layer's bf16 output can start
# anywhere and carry through 24 (mamba2) or 40 (qwen) residual layers.
SSM_PREFILL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (0.25, 0.05)}
QWEN_PREFILL = {torch.float32: (0.02, 1e-3), torch.bfloat16: (0.25, 0.05)}
FLASH_SWAP = (fa, "flash_attention_cuda", ref.flash_attention_gqa_ref)
SSD_SWAP = (ssd, "ssd_scan_cuda", ref.ssd_chunked)


def flash_inputs(rs, b, s, h, hkv, dtype, d=HD):
    return tuple(torch.from_numpy(rs.randn(b, s, n, d).astype(np.float32))
                 .to("cuda", dtype) for n in (h, hkv, hkv))


def flash_bound(b, sq, sk, h, hkv, d, esize, causal) -> tuple:
    """q, k, v read once and out written once; 4 d flops per (query,
    key) pair the mask keeps (k <= q when causal)."""
    nbytes = esize * d * (2 * b * sq * h + 2 * b * sk * hkv)
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
             else sq * sk)
    return bound_ms(nbytes, 4 * d * pairs * b * h, torch.bfloat16)


def ssd_inputs(rs, b, s, dtype, nh=24, hd=64, n=128):
    """mamba2-130m's SSD shapes: dt from softplus of the smallest
    dt_bias band, A across the model's -1..-16."""
    x = torch.from_numpy(rs.randn(b, s, nh, hd).astype(np.float32))
    dt = torch.from_numpy((rs.rand(b, s, nh) * 0.1).astype(np.float32))
    bm = torch.from_numpy(rs.randn(b, s, n).astype(np.float32))
    cm = torch.from_numpy(rs.randn(b, s, n).astype(np.float32))
    D = torch.from_numpy(rs.rand(nh).astype(np.float32) + 0.5)
    A = -torch.linspace(1.0, 16.0, nh)
    return (x.to("cuda", dtype), dt.cuda(), A.cuda(), bm.to("cuda", dtype),
            cm.to("cuda", dtype), D.cuda())


def ssd_bound(b, s, nh, hd, n, esize, chunk=256) -> tuple:
    """x, dt, B, C read once, y and the fp32 state written once; flops of
    the chunked form at the reference's chunk: C.B^T once per batch row
    and chunk (causal half), then per head M.x, C.h and the state
    update."""
    nbytes = (2 * b * s * nh * hd * esize + b * s * nh * 4
              + 2 * b * s * n * esize + b * nh * hd * n * 4 + 2 * nh * 4)
    tri = chunk * (chunk + 1) // 2
    chunks = -(-s // chunk)
    flops = 2 * b * chunks * (tri * n + nh * (tri * hd + 2 * chunk * n * hd))
    return bound_ms(nbytes, flops, torch.bfloat16)


def held_row(got, want, rtol: float, atol: float,
             live=None) -> torch.Tensor:
    """One kernel call against its plain version, on the card: (max
    |err|, the largest excess over ``atol + rtol |want|``, all finite,
    max |want|) over the live entries (``live`` broadcasts; None: all)."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    fin = torch.isfinite(got)
    if live is not None:
        d, want = torch.where(live, d, 0.0), torch.where(live, want, 0.0)
        fin = fin | ~live
    return torch.stack([d.amax(), (d - atol - rtol * want.abs()).amax(),
                        fin.all().float(), want.abs().amax()])


def fold_held(rows) -> dict:
    """{bucket: [calls, max|err|, max excess, all finite, max|want|]}
    from (bucket, :func:`held_row`) pairs, read back once."""
    held = {}
    for name, row in rows:
        e, x, fin, w = row.tolist()
        h = held.setdefault(name, [0, 0.0, -np.inf, True, 0.0])
        h[0] += 1
        h[1], h[2], h[4] = max(h[1], e), max(h[2], x), max(h[4], w)
        h[3] = h[3] and fin == 1.0
    return held


def held_ok(held: dict) -> bool:
    """Every bucket within its tolerance and finite."""
    return all(h[2] <= 0.0 and h[3] for h in held.values())


def flash_held(out, q, k, v, causal: bool) -> torch.Tensor:
    """One flash launch's output against its plain version on the same
    inputs, at ``FLASH_TOL`` of q's dtype (:func:`held_row`)."""
    want = ref.flash_attention_gqa_ref(q, k, v, causal=causal)
    rtol, atol = FLASH_TOL[q.dtype]
    return held_row(out, want, rtol, atol)


@contextlib.contextmanager
def uncounted():
    """Kernel launches made inside (a kernel held against its plain
    version) leave every launch count as it was: only the main path's
    launches count."""
    saved = {name: (fn.launches, dict(fn.routes))
             for name, fn in ops._COUNTED.items()}
    try:
        yield
    finally:
        for name, fn in ops._COUNTED.items():
            fn.launches, routes = saved[name]
            fn.routes.update(routes)


def flash_p_terms(q, k, v) -> tuple:
    """The bf16 tensor-core flash kernel's arithmetic in plain PyTorch on
    the card (64-key tiles, online softmax, bf16 operands), causal, with
    P . V taking p as one bf16 term and as the kernel's two (p_hi +
    p_lo); returns the max |error| of each fp32 output against the
    reference's fp32 p (``ref.flash_attention_gqa_ref``)."""
    B, S, H, d = q.shape
    qf, kf, vf = (a.float().transpose(1, 2) for a in (q, k, v))
    want = ref.flash_attention_gqa_ref(*(a.float() for a in (q, k, v)),
                                       causal=True).transpose(1, 2)
    rows = torch.arange(S, device=q.device)[:, None]
    errs = []
    for terms in (1, 2):
        m = torch.full((B, H, S, 1), -1e30, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf)
        for k0 in range(0, S, 64):
            kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
            sc = (qf @ kt.transpose(-1, -2)) * d ** -0.5
            keys = torch.arange(k0, k0 + kt.shape[2], device=q.device)
            sc = torch.where(keys[None] <= rows, sc,
                             torch.full_like(sc, -1e30))
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            pr = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(-1, keepdim=True)
            hi = pr.to(torch.bfloat16).float()
            pv = hi @ vt
            if terms == 2:
                pv = pv + (pr - hi).to(torch.bfloat16).float() @ vt
            acc = acc * corr + pv
            m = m_new
        errs.append(float((acc / l - want).abs().max()))
    return tuple(errs)


def phase_prefill_kernel() -> dict:
    """flash_attention and ssd_scan vs their plain versions at the
    served shapes and ragged ones, then timed at the served shapes."""
    rs = np.random.RandomState(3)
    err = {"flash_attention": 0.0, "ssd_scan": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, sk, h, hkv, causal in (
                (STATIC_SLOTS, QWEN_PROMPT, QWEN_PROMPT, 20, 20, True),
                (STATIC_SLOTS, QWEN_PROMPT, QWEN_PROMPT, 20, 20, False),
                (2, 333, 333, 20, 20, True),
                (2, QWEN_PROMPT, QWEN_PROMPT, 16, 2, True),
                (2, 333, 333, 16, 2, True), (2, 200, 77, 16, 2, False),
                (1, 2048, 2048, 20, 20, True), (2, 129, 129, 20, 20, True)):
            q, k, v = flash_inputs(rs, b, s, h, hkv, dtype)
            k, v = (a[:, :sk].contiguous() for a in (k, v))
            route = fa.route(dtype)
            before = dict(fa.flash_attention_cuda.routes)
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            if fa.flash_attention_cuda.routes != {
                    **before, route: before[route] + 1}:
                raise AssertionError(f"flash_attention {dtype}: routes "
                                     f"{before} -> "
                                     f"{fa.flash_attention_cuda.routes}")
            want = ref.flash_attention_gqa_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if got.shape != q.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flash_attention {tuple(got.shape)} "
                                     f"or non-finite")
            rtol, atol = FLASH_TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=atol)
            e = float((got.float() - want.float()).abs().max())
            if dtype == torch.bfloat16 and (s, h, causal) == (
                    QWEN_PROMPT, 20, True):
                err["flash_attention"] = e
            print(f"[kernel] flash_attention {str(dtype)[6:]} B={b} Sq={s} "
                  f"Sk={sk} H={h} Hkv={hkv} d={HD} causal={int(causal)} "
                  f"({route}): max|err| {e:.3g} ok")
        # bf16 on both routes (the tensor-core route is the one routed),
        # fp32 on the CUDA-core route
        paths = (("tensor_core", "cuda_core") if dtype == torch.bfloat16
                 else ("cuda_core",))
        for s, path in ((s, p) for s in (SSM_PROMPT, 2000) for p in paths):
            args = ssd_inputs(rs, STATIC_SLOTS, s, dtype)
            fn = ssd.ssd_scan_cuda
            before = dict(fn.routes)
            routed = ssd.route(dtype, 64, 128) == path
            y, h = fn(*args, chunk=256, path=None if routed else path)
            if fn.routes != {**before, path: before[path] + 1}:
                raise AssertionError(f"ssd_scan {dtype}: routes {before} -> "
                                     f"{fn.routes}, want {path}")
            wy, wh = ref.ssd_chunked(*args, 256)
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(y).all())
                    and bool(torch.isfinite(h).all())):
                raise AssertionError("ssd_scan: non-finite output")
            rtol, atol = SSD_TOL[dtype]
            torch.testing.assert_close(y.float(), wy.float(), rtol=rtol,
                                       atol=atol)
            torch.testing.assert_close(h, wh, rtol=5e-3, atol=5e-3)
            ey = float((y.float() - wy.float()).abs().max())
            eh = float((h - wh).abs().max())
            if dtype == torch.bfloat16 and s == SSM_PROMPT and routed:
                err["ssd_scan"] = ey
            print(f"[kernel] ssd_scan {str(dtype)[6:]} B={STATIC_SLOTS} "
                  f"S={s} nh=24 hd=64 N=128 chunk=256 ({path}"
                  f"{'' if routed else ', named'}): max|err| y {ey:.3g} "
                  f"(max|y| {float(wy.float().abs().max()):.3g}), state "
                  f"{eh:.3g} ok")
    # P . V with the reference's fp32 p: one bf16 term against two, at
    # the served shape (bf16-representable inputs, fp32 outputs)
    q, k, v = flash_inputs(rs, STATIC_SLOTS, QWEN_PROMPT, 20, 20,
                           torch.bfloat16)
    one, two = flash_p_terms(q, k, v)
    err["flash_p_terms"] = {"one": one, "two": two}
    print(f"[kernel] flash_attention P . V, B={STATIC_SLOTS} S={QWEN_PROMPT}"
          f" H=20 causal, fp32 output vs the reference's fp32 p: max|err| "
          f"{one:.3g} with p as one bf16 term, {two:.3g} as p_hi + p_lo")
    del q, k, v
    # device times at the served shapes (bf16), each call on its own copy
    # of the inputs (>= 128 MB in all, from HBM)
    timing = {}
    b, s, h = STATIC_SLOTS, QWEN_PROMPT, 20
    per = 4 * b * s * h * HD * 2
    xs = [flash_inputs(rs, b, s, h, h, torch.bfloat16)
          for _ in range(max(2, -(-(128 << 20) // per)))]
    bms, by = flash_bound(b, s, s, h, h, HD, 2, True)
    timing["flash_attention"] = {
        "ms": device_ms([functools.partial(fa.flash_attention_cuda, *x,
                                           causal=True) for x in xs]),
        "plain_ms": device_ms([functools.partial(
            ref.flash_attention_gqa_ref, *x, causal=True) for x in xs]),
        "library_ms": device_ms([functools.partial(
            F.scaled_dot_product_attention, *(a.transpose(1, 2) for a in x),
            is_causal=True, enable_gqa=True) for x in xs]),
        "bound_ms": bms, "bound_by": by,
        "shape": f"bf16 B={b} S={s} H={h} Hkv={h} d={HD} causal"}
    del xs
    per = 2 * STATIC_SLOTS * SSM_PROMPT * 24 * 64 * 2
    xs = [ssd_inputs(rs, STATIC_SLOTS, SSM_PROMPT, torch.bfloat16)
          for _ in range(max(2, -(-(128 << 20) // per)))]
    bms, by = ssd_bound(STATIC_SLOTS, SSM_PROMPT, 24, 64, 128, 2)
    timing["ssd_scan"] = {
        "ms": device_ms([functools.partial(ssd.ssd_scan_cuda, *x, chunk=256)
                         for x in xs]),
        "cuda_core_ms": device_ms([functools.partial(
            ssd.ssd_scan_cuda, *x, chunk=256, path="cuda_core")
            for x in xs]),
        "plain_ms": device_ms([functools.partial(ref.ssd_chunked, *x, 256)
                               for x in xs], reps=3),
        "library_ms": None,
        "bound_ms": bms, "bound_by": by,
        "shape": f"bf16 B={STATIC_SLOTS} S={SSM_PROMPT} nh=24 hd=64 N=128 "
                 f"chunk=256"}
    del xs
    for name, row in timing.items():
        lib = ("no single PyTorch call" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        other = (f" | cuda_core route {row['cuda_core_ms']:.4f} ms"
                 if "cuda_core_ms" in row else "")
        print(f"[kernel] {name} {row['shape']}: kernel {row['ms']:.4f} ms"
              f"{other} | plain {row['plain_ms']:.4f} ms | library {lib} | "
              f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
    return {"err": err, "timing": timing}


def cache_leaves(tree, path=()):
    """(key path, tensor) of every leaf of a nested cache tree (a hybrid
    group nests ``kv`` and ``ssm``)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from cache_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def prefill_both_paths(params, cfg, tokens, swaps, dtype, tensor_core=(),
                       moved=None):
    """One whole-prompt prefill through the kernels and through their
    plain versions (``swaps``: (module, wrapper name, plain function)
    each) on the same tokens, in ``dtype``; returns the max |d logit| of
    the last position and the worst max |d| / max |ref| over the
    handed-off cache leaves (every layer). The kernel pass's launches of
    a kernel in ``tensor_core`` take the tensor-core route in bf16, and
    every other launch the CUDA-core route. ``moved`` (a list): the
    plain pass replays the kernel pass's MoE routing, as phase 5 replays
    a tick's, and ``moved`` gets the count of routed tokens whose own
    routing would have picked other experts, then the routed total."""
    cfg = replace(cfg, dtype=str(dtype)[6:])
    p = tree_map(lambda t: t.to(dtype), params)
    real_dispatch, routes = moe_mod._top_k_dispatch, []

    def record(*args, **kw):
        routes.append(real_dispatch(*args, **kw))
        return routes[-1]

    def replay(*args, **kw):
        own = real_dispatch(*args, **kw)[0].any(-1)     # (G, S, E)
        rec = routes[moved[2]]
        moved[0] += int((own != rec[0].any(-1)).any(-1).sum())
        moved[1] += int(rec[0].any(-1).any(-1).sum())
        moved[2] += 1
        return rec
    if moved is not None:
        moved[:] = [0, 0, 0]
    out = []
    for plain in (False, True):
        ctx = contextlib.ExitStack()
        for swap in (swaps if plain else ()):
            ctx.enter_context(mock.patch.object(*swap))
        if moved is not None:
            ctx.enter_context(mock.patch.object(
                moe_mod, "_top_k_dispatch", replay if plain else record))
        ops.reset_launch_counts()
        with ctx, torch.no_grad():
            out.append(tfm.prefill(p, tokens, cfg, cache_len=tokens.shape[1],
                                   cache_dtype=dtype))
        if not plain:
            check_routes(ops.launch_counts(routes=True),
                         tensor_core if dtype == torch.bfloat16 else (),
                         f"{cfg.name} prefill, {dtype}")
    (lk, ck), (lp, cp) = out
    if not bool(torch.isfinite(lk).all()):
        raise AssertionError("prefill: non-finite logits")
    if moved is not None:
        del moved[2:]
    d_logit = float((lk.float() - lp.float()).abs().max())
    d_state = 0.0
    got_leaves = dict(cache_leaves(ck))
    for path, want in cache_leaves(cp):
        if not want.is_floating_point():
            continue
        got = got_leaves[path].float()
        scale = float(want.float().abs().max()) or 1.0
        d_state = max(d_state, float((got - want.float()).abs().max())
                      / scale)
    return d_logit, d_state, float(lk.float().std())


def prefill_launches(cfg) -> dict:
    """Launches of the prefill kernels in one whole-prompt prefill of
    ``cfg``: flash_attention per full-attention layer (dense,
    hybrid_full; a hybrid_swa layer's window runs blockwise_attn),
    ssd_scan per SSM mixer (ssm and both hybrid kinds)."""
    want = {"flash_attention": 0, "ssd_scan": 0}
    for kind, n in tfm.layer_plan(cfg):
        if kind in ("dense", "hybrid_full"):
            want["flash_attention"] += n
        if kind in ("ssm", "hybrid_full", "hybrid_swa"):
            want["ssd_scan"] += n
    return {k: n for k, n in want.items() if n}


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units of one bf16 ulp of the larger
    magnitude of the pair (2^-7 of its power of two); integer leaves
    count each difference as infinitely many."""
    if not want.is_floating_point():
        return 0.0 if torch.equal(got, want) else float("inf")
    a, b = got.float(), want.float()
    m = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
    return float(((a - b).abs() / ulp).amax())


def static_graph_vs_eager(params, cfg, args, where: str, tag: str) -> dict:
    """``run_static`` at ``args`` through its plans captured as CUDA
    graphs (as ``--static`` runs on a card), then through eager plans on
    the same weights and prompts (``graphs=False``), counts from 0 before
    each. Checks the same greedy tokens; the prefill's last-position
    logits and every cache leaf after the last step bit for bit (a leaf
    off by at most one bf16 ulp is held there and listed); the same
    launches by route in all and by kernel in each half; 2 graphs and no
    retrace, no graph eager. Returns the graph run's result without its
    tensors, its launches by route (``routes``), the peak device memory
    after it (``peak_gib``: the weights, the caches and the graphs'
    pool), each kind's capture s, prefill ms and decode ms a step and
    tok/s (``kinds``) and the leaves that were not bit for bit
    (``ulps``)."""
    runs = {}
    for kind in ("graph", "eager"):
        ops.reset_launch_counts()
        r = serve.run_static(params, cfg, args, "cuda",
                             graphs=kind == "graph")
        torch.cuda.synchronize()
        r["routes"] = ops.launch_counts(routes=True)
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        runs[kind] = r
    g, e = runs["graph"], runs["eager"]
    steps = args.tokens - 1
    kinds = {k: {"capture_s": r["capture_s"],
                 "prefill_ms": r["prefill_s"] * 1e3,
                 "decode_ms_step": r["decode_s"] * 1e3 / max(steps, 1),
                 "decode_tok_s": args.slots * steps / r["decode_s"],
                 "plans": r["plans"]} for k, r in runs.items()}
    pairs = [("logits", g["logits"], e["logits"])]
    for grp in g["caches"]:
        want = dict(cache_leaves(e["caches"][grp]))
        pairs += [("/".join((grp, *path)), a, want[path])
                  for path, a in cache_leaves(g["caches"][grp])]
    ulps = {name: bf16_ulps(a, b) for name, a, b in pairs
            if not torch.equal(a, b)}
    st_g, st_e = g["plans"], e["plans"]
    if not torch.equal(g["tokens"], e["tokens"]) or \
            any(u > 1 for u in ulps.values()) or \
            g["routes"] != e["routes"] or \
            g["launches_prefill"] != e["launches_prefill"] or \
            g["launches_decode"] != e["launches_decode"] or \
            (st_g["graphs"], st_g["retraces"]) != (2, 0) or \
            (st_e["graphs"], st_e["retraces"]) != (0, 0):
        raise AssertionError(
            f"{where}: graph vs eager plans: tokens equal "
            f"{torch.equal(g['tokens'], e['tokens'])}, leaves off (bf16 "
            f"ulps) {ulps}, launches {g['launches_prefill']} / "
            f"{g['launches_decode']} vs {e['launches_prefill']} / "
            f"{e['launches_decode']}, plans {st_g} vs {st_e}")
    print(f"[{tag}] {cfg.name}: static plans graph vs eager: capture "
          + " / ".join(f"{kinds[k]['capture_s']:.2f}" for k in kinds)
          + " s, prefill " + " / ".join(f"{kinds[k]['prefill_ms']:.2f}"
                                       for k in kinds)
          + " ms, decode " + " / ".join(
              f"{kinds[k]['decode_ms_step']:.3f} ms a step "
              f"({kinds[k]['decode_tok_s']:.1f} tok/s)" for k in kinds)
          + f"; tokens, logits and {len(pairs) - 1} cache leaves "
          + ("bit for bit" if not ulps else
             f"equal but {ulps} (bf16 ulps)")
          + f"; launches by route equal; plans {st_g}; peak device "
          f"memory after the graphed run {g['peak_gib']:.2f} GiB")
    out = {k: v for k, v in g.items()
           if k not in ("tokens", "logits", "caches")}
    out.update(kinds=kinds, ulps=ulps, tokens=g["tokens"])
    return out


def phase_static(cfg, prompt: int, swaps, bounds, wbits: int = 0,
                 tensor_core: tuple = (), share: tuple = ()) -> dict:
    """The static path at full width through ``launch/serve.py``'s
    ``run_static``: seeded weights drawn on the card (``wbits``: packed
    as drawn and dequantized once up front, as ``--static --wbits``
    does), 4 prompts of ``prompt`` tokens, 32 greedy new tokens, through
    the plans captured as CUDA graphs and again through eager plans
    (:func:`static_graph_vs_eager`). Checks each prefill kernel launched
    as often as :func:`prefill_launches` says in the prefill and never
    in the decode, and no other kernel; then the prefill through the
    kernels vs their plain versions (``swaps``) in fp32 and bf16,
    eagerly; then traces one prefill."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, device="cuda", wbits=wbits)
    if wbits:
        params = serve.dequantize_tree(params, getattr(torch, cfg.dtype))
    torch.cuda.synchronize()
    print(f"[static] {cfg.name}: {cfg.n_layers} layers "
          f"{[k for k, _ in tfm.layer_plan(cfg)]}, d {cfg.d_model}, "
          f"{cfg.dtype} weights ({torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB{', int8-packed as drawn, dequantized once' if wbits else ''}"
          f") in {time.perf_counter() - t0:.1f}s")
    args = types.SimpleNamespace(slots=STATIC_SLOTS, prompt_len=prompt,
                                 tokens=STATIC_NEW, seed=0)
    r = static_graph_vs_eager(params, cfg, args, cfg.name, "static")
    routes = r["routes"]
    check_routes(routes, tensor_core, f"{cfg.name} static")
    want = prefill_launches(cfg)
    if r["launches_prefill"] != want or r["launches_decode"] or \
            {k: sum(c.values()) for k, c in routes.items()
             if sum(c.values())} != {k: 2 * n for k, n in want.items()}:
        raise AssertionError(f"{cfg.name}: launches prefill "
                             f"{r['launches_prefill']}, decode "
                             f"{r['launches_decode']}, in all {routes}; "
                             f"want {want} (twice in all: the warm-up's "
                             f"eager pass and the replay) and none")
    toks = r["tokens"]
    if toks.shape != (STATIC_SLOTS, STATIC_NEW) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: tokens {tuple(toks.shape)}")
    n_dec = STATIC_SLOTS * (STATIC_NEW - 1)
    row = {"capture_s": r["capture_s"], "prefill_ms": r["prefill_s"] * 1e3,
           "decode_tok_s": n_dec / r["decode_s"],
           "launches": want, "routes": {k: routes[k] for k in want},
           "graph_vs_eager": r["kinds"], "ulps": r["ulps"],
           "static_peak_gib": r["peak_gib"]}
    print(f"[static] {cfg.name}: graphed, capture {row['capture_s']:.2f} s,"
          f" prefill {STATIC_SLOTS}x{prompt} "
          f"{row['prefill_ms']:.2f} ms, decode {n_dec} tokens "
          f"{row['decode_tok_s']:.1f} tok/s; launches {want} in 1 "
          f"prefill, 0 in {STATIC_NEW - 1} decode steps; routes "
          f"{row['routes']}")
    del r
    tokens = api.make_smoke_batch(2, cfg, STATIC_SLOTS, prompt,
                                  device="cuda")["tokens"]
    for dtype in (torch.float32, torch.bfloat16):
        dl, ds, std = prefill_both_paths(params, cfg, tokens, swaps, dtype,
                                         tensor_core)
        print(f"[static] {cfg.name}: prefill kernel vs plain, "
              f"{str(dtype)[6:]}: max|d logit| {dl:.4g} (logit std "
              f"{std:.3g}), handed-off state max|d|/max|ref| {ds:.3g}")
        if dl > bounds[dtype][0] or ds > bounds[dtype][1]:
            raise AssertionError(f"{cfg.name} prefill ({dtype}): kernel "
                                 f"path disagrees with the plain path")
    gc.collect()
    torch.cuda.empty_cache()
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[static] {cfg.name}: peak device memory {row['peak_gib']:.2f} "
          f"GiB")

    def enqueue():
        with torch.no_grad():
            return tfm.prefill(params, tokens, cfg,
                               cache_len=prompt + STATIC_NEW)[0]
    row["trace"] = trace(f"one prefill ({cfg.name}, B={STATIC_SLOTS}, "
                         f"S={prompt})", enqueue, share)
    del params
    return row


# ---------------------------------------------------------------------------
# Streaming slice: live reads and read-until on full-width RUBICALL

# reads of 1000-2000 bases (9k-18k samples, 2.3-4.5 s at PORE_HZ): a
# frame is stable only once (g+1)*3 + 3237 samples have arrived, so the
# launcher's default 300-base reads (< one halo) would emit every base
# at finish() and measure nothing
STREAM = dict(requests=8, rate=4.0, read_bases=2000, seed=0,
              chunk_samples=1024, eject_after_chunks=2, target_frac=0.5,
              async_dispatch=False, read_until=False)
EXACT_READS = 4
REPLAY_DT = 0.1               # pore seconds per loop of a replayed schedule


class PoreClock:
    """A clock that advances ``dt`` seconds each time it is read: with a
    no-op sleep, ``serve.stream_reads`` replays one append schedule
    exactly, however fast the card runs."""

    def __init__(self, dt: float):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def replayed() -> dict:
    return {"clock": PoreClock(REPLAY_DT), "sleep": lambda s: None}


def stream_engine(params, cfg, **kw):
    engine = api.make_serving_engine(params, cfg, device="cuda", n_slots=B,
                                     chunk_samples=STREAM["chunk_samples"],
                                     **kw)
    engine.warmup()
    return engine


def streamed_run(engine, args, where: str, **kw) -> dict:
    """``serve.run_streamed`` with the kernel's launches counted from 0
    just before and read just after. Checks that every runner call had
    work (idle ticks never reach the runner), one call per forward, 19
    qconv1d_block launches per forward, all on the tensor-core route.
    Times each forward tick's host enqueue (``dispatch``) and its
    readback and CTC merge (``collect``) on the host clock."""
    runner = engine.runner
    calls = {"calls": 0, "windows": 0, "step_s": [], "dispatch_s": [],
             "collect_s": []}
    step, dispatch, collect = runner.step, runner.dispatch, runner.collect

    def timed(fn, key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            calls[key].append(time.perf_counter() - t0)
            return out
        return call

    def counted(works):
        n = sum(w is not None for w in works)
        if not n:
            raise AssertionError(f"{where}: an idle tick reached the runner")
        calls["calls"] += 1
        calls["windows"] += n
        return step(works)
    runner.dispatch = timed(dispatch, "dispatch_s")
    runner.collect = timed(collect, "collect_s")     # ends in the readback
    runner.step = timed(counted, "step_s")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    # warmup: stream_engine warmed the engine, so the launcher's report
    # gates on retraces as after --warmup
    out = serve.run_streamed(engine, types.SimpleNamespace(
        **args, warmup=True), **kw)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    launches = ops.launch_counts()["qconv1d_block"]
    routes = ops.launch_counts(routes=True)
    check_routes(routes, ("qconv1d_block",), where)
    s = out["summary"]
    forwards = s["bucket_hits"] + s["bucket_misses"]
    if forwards < 1 or launches != len(KERNEL_BLOCKS) * forwards:
        raise AssertionError(f"{where}: qconv1d_block launched {launches} "
                             f"times in {forwards} forwards, want "
                             f"{len(KERNEL_BLOCKS)} per forward")
    if calls["calls"] != forwards:
        raise AssertionError(f"{where}: {calls['calls']} runner calls for "
                             f"{forwards} forwards")
    if len(out["done"]) != args["requests"]:
        raise AssertionError(f"{where}: {len(out['done'])} of "
                             f"{args['requests']} reads done")
    out.update(calls, launches=launches, forwards=forwards,
               routes=routes["qconv1d_block"])
    return out


def watch_ejections(engine) -> dict:
    """Each ejected read's consumed samples, as the engine books them."""
    seen = {}
    record = engine.metrics.record_eject

    def watched(rid, consumed, arrived):
        seen[rid] = consumed
        record(rid, consumed=consumed, arrived=arrived)
    engine.metrics.record_eject = watched
    return seen


def record_frames(runner) -> dict:
    """The argmax frame ids each read's CTC merge is fed, by rid (a far
    finer check than the bases: random weights emit mostly blanks)."""
    frames = {}
    admit = runner.admit

    def recording(slot, req):
        admit(slot, req)
        merge, fed = runner._merge[slot], frames.setdefault(req.rid, [])
        feed = merge.feed

        def feed_recorded(ids):
            fed.extend(int(i) for i in ids)
            return feed(ids)
        merge.feed = feed_recorded
    runner.admit = recording
    return frames


def queue_waits(engine, rids) -> list:
    """Seconds each read waited for a slot (submit to admission)."""
    req = engine.metrics.requests
    return [req[r].admit - req[r].arrival for r in rids]


def tokens(run: dict) -> dict:
    return {rid: list(map(int, r.out_tokens))
            for rid, r in run["done"].items()}


def statuses(run: dict) -> dict:
    return {rid: r.status for rid, r in run["done"].items()}


def phase_stream() -> dict:
    cfg, params = rubicall_served()
    params = tree_map(lambda t: t.to("cuda"), params)
    exact = no_act_quant(cfg)
    out = {"launches": 0}

    # 1) both QoS as served, paced by the wall clock
    for qos in ("accuracy", "latency"):
        eng = stream_engine(params, cfg, qos=qos)
        core = eng.runner.core
        run = streamed_run(eng, STREAM, f"stream {qos}")
        if set(statuses(run).values()) != {"finished"}:
            raise AssertionError(f"stream {qos}: {statuses(run)}")
        s = run["summary"]
        if not s["emit_events"] or not all(tokens(run).values()):
            raise AssertionError(f"stream {qos}: no bases emitted")
        lens = [sig.shape[0] for _, _, sig in run["reads"]]
        n = len(lens)
        waits = queue_waits(eng, run["done"])
        row = {"emit_p50_ms": s["emit_latency_p50_s"] * 1e3,
               "emit_p99_ms": s["emit_latency_p99_s"] * 1e3,
               "emit_events": s["emit_events"], "forwards": run["forwards"],
               "windows_per_read": run["windows"] / n,
               "forwards_per_read": run["forwards"] / n,
               "tick_p50_ms": s["tick_latency_p50_s"] * 1e3,
               "forward_tick_p50_ms":
                   statistics.median(run["step_s"]) * 1e3,
               "dispatch_p50_ms": statistics.median(run["dispatch_s"]) * 1e3,
               "collect_p50_ms": statistics.median(run["collect_s"]) * 1e3,
               "idle_ticks": s["idle_ticks"], "launches": run["launches"],
               "queue_wait_mean_s": sum(waits) / n,
               "queue_wait_max_s": max(waits),
               "routes": run["routes"], "wall_s": run["wall_s"],
               "samples": sum(lens)}
        out[qos] = row
        out["launches"] += run["launches"]
        print(f"[stream] qos={qos}: {n} live reads of {min(lens)}-"
              f"{max(lens)} samples in {run['wall_s']:.2f}s | emit latency "
              f"p50 {row['emit_p50_ms']:.2f} ms p99 {row['emit_p99_ms']:.2f} "
              f"ms ({row['emit_events']} emissions) | {run['forwards']} "
              f"forwards ({row['forwards_per_read']:.2f} a read, "
              f"{row['windows_per_read']:.2f} windows a read; offline "
              f"{sum(-(-n_ // core) for n_ in lens) / n:.2f}) | tick p50 "
              f"{row['tick_p50_ms']:.2f} ms, with a forward "
              f"{row['forward_tick_p50_ms']:.2f} ms (enqueue "
              f"{row['dispatch_p50_ms']:.2f}, readback + merge "
              f"{row['collect_p50_ms']:.2f}) | idle ticks skipped "
              f"{row['idle_ticks']:.0f} | wait for a slot mean "
              f"{row['queue_wait_mean_s']:.3f} s max "
              f"{row['queue_wait_max_s']:.3f} s | qconv1d_block launches "
              f"{run['launches']} = {len(KERNEL_BLOCKS)} x {run['forwards']},"
              f" routes {run['routes']}")

    # 2) exactness: activation quantizers off (no row couples to another),
    # streamed accuracy bases == the same reads served whole
    eng = stream_engine(params, exact)
    frames = record_frames(eng.runner)
    args = {**STREAM, "requests": EXACT_READS}
    run = streamed_run(eng, args, "stream exact", **replayed())
    ops.reset_launch_counts()
    for rid, (_, _, sig) in enumerate(run["reads"]):
        eng.submit(Request(rid=100 + rid, signal=sig))
    offline = eng.run()
    check_routes(ops.launch_counts(routes=True), ("qconv1d_block",),
                 "offline exact")
    got = tokens(run)
    for rid in got:
        want = list(map(int, offline[100 + rid].out_tokens))
        fs, fo = frames[rid], frames[100 + rid]
        if offline[100 + rid].status != "finished" or got[rid] != want \
                or fs != fo or len(fs) != -(-run["reads"][rid][2].shape[0]
                                           // eng.runner.stride):
            diff = next((i for i, (a, b) in enumerate(zip(fs, fo))
                         if a != b), None)
            raise AssertionError(
                f"stream exact: read {rid}: {len(got[rid])} bases streamed, "
                f"{len(want)} offline; {len(fs)} frames streamed, "
                f"{len(fo)} offline, first differing frame {diff}")
    out["exact"] = {"reads": EXACT_READS,
                    "bases": sum(map(len, got.values())),
                    "frames": sum(len(frames[r]) for r in got)}
    print(f"[stream] exact (no act-quant, bf16): {EXACT_READS} streamed "
          f"accuracy reads == the same reads served whole: "
          f"{out['exact']['frames']} argmax frames fed to the CTC merge and "
          f"{out['exact']['bases']} bases, each equal")

    # 3) read-until: the classifier trained on the card, as the launcher
    # does; the mechanics asserted, not the classifier's quality
    ru_args = {**STREAM, "read_until": True}
    ru = serve.make_read_until(cfg, types.SimpleNamespace(**ru_args), "cuda")
    eng = stream_engine(params, cfg, read_until=ru)
    where = {v.device.type for v in ru.params.values()} | {
        v.device.type for v in eng.runner.read_until.params.values()}
    if where != {eng.runner.device.type}:
        raise AssertionError(f"read-until: the classifier lies on {where}, "
                             f"the forward runs on {eng.runner.device}")
    consumed = watch_ejections(eng)
    run = streamed_run(eng, ru_args, "read-until")
    out["launches"] += run["launches"]
    st = statuses(run)
    if not set(st.values()) <= {"finished", "ejected"} or \
            any(c > 2 * core for c in consumed.values()) or \
            sorted(consumed) != sorted(r for r, v in st.items()
                                       if v == "ejected"):
        raise AssertionError(f"read-until: statuses {st}, consumed "
                             f"{consumed}")
    on = {i: tgt for i, (_, tgt, _) in enumerate(run["reads"])}
    s = run["summary"]
    total = sum(sig.shape[0] for _, _, sig in run["reads"])
    off_samples = sum(sig.shape[0] for _, tgt, sig in run["reads"]
                      if not tgt)
    out["read_until"] = {
        "off_target_samples": off_samples,
        "ejections": s["ejections"],
        "off_target": sum(not v for v in on.values()),
        "off_target_rejected": sum(not on[r] for r in consumed),
        "on_target_lost": sum(on[r] for r in consumed),
        "samples_saved": s["samples_saved"], "samples": total,
        "ejected_consumed_samples": s["ejected_consumed_samples"],
        "emit_p50_ms": s["emit_latency_p50_s"] * 1e3,
        "emit_p99_ms": s["emit_latency_p99_s"] * 1e3,
        "tick_p50_ms": s["tick_latency_p50_s"] * 1e3,
        "forward_tick_p50_ms": statistics.median(run["step_s"]) * 1e3,
        "forwards": run["forwards"], "launches": run["launches"]}
    r_ = out["read_until"]
    print(f"[stream] read-until: {r_['ejections']:.0f} ejections, "
          f"{r_['off_target_rejected']}/{r_['off_target']} off-target "
          f"rejected, {r_['on_target_lost']} on-target lost | samples saved "
          f"{r_['samples_saved']:.0f}/{total} ({off_samples} off-target) | "
          f"basecalled "
          f"{r_['ejected_consumed_samples']:.0f} samples on ejected reads "
          f"(each <= {2 * core}) | tick p50 {r_['tick_p50_ms']:.2f} ms, "
          f"with a forward {r_['forward_tick_p50_ms']:.2f} ms")

    # one read-until tick traced (phase 3 traces the same tick without
    # the classifier), then the classifier alone: its kernels and device
    # time, and the tick's one readback
    runner = eng.runner
    works = [types.SimpleNamespace(final=False, payload=runner.make_chunks(
        Request(rid=i, signal=sig))[1].payload)
        for i, (_, _, sig) in enumerate(run["reads"][:B])]
    out["trace"] = trace("one read-until tick (rubicall, B=4, qos accuracy)",
                         lambda: runner.dispatch(works)[1],
                         fetch=lambda o: runner_mod.readback(*o))
    wins = torch.from_numpy(np.stack([w.payload[0] for w in works])).cuda()
    cls_params = runner.read_until.params
    with torch.inference_mode():
        cls_ms = device_ms([lambda: rc.forward(cls_params, wins)] * 20)
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            rc.forward(cls_params, wins)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in kernels:
        print(f"[trace]   classifier alone, 3 calls: "
              f"{e.self_device_time_total / 1e3:8.4f} ms {e.count:3d}x "
              f"{e.key[:80]}")
    per_call = sum(e.count for e in kernels) / 3
    busy = out["trace"]["busy_ms"]
    out["classifier"] = {"device_ms": cls_ms, "kernels_per_call": per_call,
                         "share_of_tick": cls_ms / busy if busy else None}
    print(f"[trace] read-until classifier: {cls_ms:.4f} ms of device time "
          f"a call (host out of the way), {per_call:.0f} kernels a call; "
          f"the read-until tick's kernels: {busy:.2f} ms in "
          f"{out['trace']['launches']} launches")
    reads_back = []
    real = runner_mod.readback

    def counted(*ts):
        reads_back.append([tuple(t.shape) for t in ts])
        return real(*ts)
    for i in range(B):
        runner.admit(i, None)
    with mock.patch.object(runner_mod, "readback", counted):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.collect(runner.dispatch(works))
        t_tick = time.perf_counter() - t0
    for i in range(B):
        runner.reset_row(i)
    if len(reads_back) != 1 or len(reads_back[0]) != 2:
        raise AssertionError(f"read-until tick: readbacks {reads_back}")
    print(f"[trace] read-until tick: one readback of {reads_back[0]} "
          f"(log-probs, logits); dispatch + collect {t_tick * 1e3:.2f} ms")

    # 4) forced verdicts on a replayed schedule, activation quantizers off:
    # +1e9 ejects every read after two windows, -1e9 none, with the bases
    # of the same schedule served without read-until
    base = streamed_run(stream_engine(params, exact), ru_args,
                        "no read-until", **replayed())
    forced = {}
    for thr in (1e9, -1e9):
        eng = stream_engine(params, exact,
                            read_until=replace(ru, threshold=thr))
        consumed = watch_ejections(eng)
        run = streamed_run(eng, ru_args, f"forced {thr:+.0e}", **replayed())
        st = statuses(run)
        if thr > 0 and (set(st.values()) != {"ejected"}
                        or any(c != 2 * core for c in consumed.values())):
            raise AssertionError(f"forced +1e9: {st}, consumed {consumed}")
        if thr < 0 and (set(st.values()) != {"finished"}
                        or tokens(run) != tokens(base)):
            raise AssertionError(f"forced -1e9: {st}, bases differ from "
                                 f"the run without read-until")
        forced[f"{thr:+.0e}"] = {"ejections": run["summary"]["ejections"],
                                 "samples_saved":
                                     run["summary"]["samples_saved"]}
    out["forced"] = forced
    out["ru"] = ru                        # phase 26 serves with it
    print(f"[stream] forced verdicts: +1e9 ejected all {STREAM['requests']} "
          f"reads after {2 * core} samples each (saved "
          f"{forced['+1e+09']['samples_saved']:.0f}); -1e9 ejected none, "
          f"bases == the run without read-until")
    return out


# ---------------------------------------------------------------------------
# Training slice: full-width RUBICALL trained as launch/train.py trains it,
# the offline identity gate through qconv1d_block, the RUBICON core

TRAIN = dict(batch=8, seq=2048, steps=50, ckpt_every=25)   # the launcher's
TRAIN_TIMED = 20            # steps timed one by one after the loop
IDENT_BATCHES = 4           # held-out batches of 8 reads (evaluate.py)
SMOKE_STEPS = 300           # the reference identity test's setting
FULL_TRAIN_STEPS = 160      # full-width training steps: the gate compares
#                             kernel and plain identity and sets no absolute
#                             one. A fixed count past the onset of emission
#                             (kernel 0.4118, plain 0.4087 in two runs on an
#                             H100 80GB HBM3 at 700 W); near ~100 steps,
#                             where emission starts, the two parted by 0.0104
IDENT_TOL = 0.005           # kernel identity vs plain identity
REF_SMOKE_IDENTITY = 0.018  # the reference's, on the CPU (ROADMAP Queue 3)


def time_train_steps(step, carry, batches) -> tuple:
    """Each step alone: host enqueue, device time from its first enqueue
    to its last kernel (CUDA events) and wall to the synchronise.
    Returns (carry, per-step dict of lists in ms)."""
    out = {"host": [], "device": [], "wall": []}
    for b in batches:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        carry, _ = step(carry, b)
        e1.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out["host"].append((t1 - t0) * 1e3)
        out["device"].append(e0.elapsed_time(e1))
        out["wall"].append((t2 - t0) * 1e3)
    return carry, out


def identity_gate(name, cfg, params, state, packed, per_forward,
                  route) -> dict:
    """Held-out identity of the float weights, of ``packed`` through
    ``qconv1d_block`` (``per_forward`` launches a forward, all on
    ``route``, counted from 0 around the call) and of ``packed`` through
    the plain version on the card."""
    float_id = train_eval.eval_identity(cfg, params, state, IDENT_BATCHES)
    ops.reset_launch_counts()
    kern_id = train_eval.eval_identity(cfg, packed, state, IDENT_BATCHES)
    torch.cuda.synchronize()
    routes = ops.launch_counts(routes=True)["qconv1d_block"]
    kern_ctc = train_eval.eval_ctc_loss(cfg, packed, state, IDENT_BATCHES)
    with mock.patch.object(qconv1d, "qconv1d_block_cuda", qconv_plain):
        plain_id = train_eval.eval_identity(cfg, packed, state,
                                            IDENT_BATCHES)
        plain_ctc = train_eval.eval_ctc_loss(cfg, packed, state,
                                             IDENT_BATCHES)
    want = {r: per_forward * IDENT_BATCHES if r == route else 0
            for r in routes}
    print(f"[train] identity {name}: float {float_id:.4f}, int8 packed "
          f"through qconv1d_block {kern_id:.4f}, through the plain version "
          f"{plain_id:.4f} (the reference, rubicall-smoke on the CPU: "
          f"{REF_SMOKE_IDENTITY}); held-out CTC loss, kernel {kern_ctc:.4f} "
          f"plain {plain_ctc:.4f} | qconv1d_block {routes}")
    if routes != want:
        raise AssertionError(f"{name}: qconv1d_block routes {routes}, want "
                             f"{want} ({per_forward} a forward)")
    if abs(kern_id - plain_id) > IDENT_TOL:
        raise AssertionError(f"{name}: kernel identity {kern_id} vs plain "
                             f"{plain_id}, more than {IDENT_TOL} apart")
    return {"float": float_id, "kernel": kern_id, "plain": plain_id,
            "ctc_kernel": kern_ctc, "ctc_plain": plain_ctc,
            "launches": sum(routes.values()), "routes": routes}


def phase_train() -> dict:
    import tempfile
    out = {}
    # (a) full-width RUBICALL through train_loop.run, as launch/train.py
    cfg = get_config("rubicall")
    opt_cfg = AdamWConfig(lr=2e-3, total_steps=TRAIN["steps"])
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckdir:
        loop = TrainLoopConfig(steps=TRAIN["steps"], log_every=1,
                               ckpt_every=TRAIN["ckpt_every"],
                               ckpt_dir=ckdir)
        t0 = time.perf_counter()
        run = train_loop.run(cfg, opt_cfg, loop,
                             train_launcher.data_for(cfg, TRAIN["batch"],
                                                     TRAIN["seq"]),
                             torch.Generator().manual_seed(0),
                             device="cuda")
        t_loop = time.perf_counter() - t0
        carry = run["carry"]
        # the checkpoint of step 50 is the final carry, bit for bit
        like = tree_map(torch.zeros_like, carry.params)
        step_no, restored = run["ckpt"].restore(api.TrainCarry(
            like, init_opt_state(like, opt_cfg), carry.model_state))
        bad = [k for (k, a), (_, b) in zip(leaf_items(restored),
                                           leaf_items(carry))
               if not (a.device == b.device and a.dtype == b.dtype
                       and torch.equal(a, b))]
        if step_no != TRAIN["steps"] or bad:
            raise AssertionError(f"checkpoint of step {step_no}: leaves "
                                 f"{bad[:4]} differ from the carry")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [r["loss"] for r in run["history"]]
    if len(losses) != TRAIN["steps"] or not np.isfinite(losses).all():
        raise AssertionError(f"losses: {losses}")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    marks = (1, TRAIN["steps"] // 2, TRAIN["steps"])
    at = {m: losses[m - 1] for m in marks}
    print(f"[train] rubicall {cfg.n_blocks} blocks C={cfg.channels[0]} "
          f"{cfg.dtype} compute, fp32 params and AdamW state, batch "
          f"{TRAIN['batch']} x {TRAIN['seq']}: {TRAIN['steps']} steps of "
          f"train_loop.run in {t_loop:.2f}s; loss at steps "
          f"{', '.join(f'{m}: {v:.2f}' for m, v in at.items())} (mean of the first 10 "
          f"{first:.2f}, of the last 10 {last:.2f}); checkpoint of step "
          f"{step_no} restored bit-exact ({len(list(leaf_items(carry)))} leaves); "
          f"peak device memory {peak:.3f} GiB")
    if not last < first:
        raise AssertionError(f"the loss did not fall over {len(losses)} "
                             f"steps")
    step = api.make_train_step(cfg, opt_cfg)
    data = train_launcher.data_for(cfg, TRAIN["batch"], TRAIN["seq"])
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
               for _ in range(TRAIN_TIMED)]
    carry, t = time_train_steps(step, carry, batches)
    p50 = {k: statistics.median(v) for k, v in t.items()}
    sps = TRAIN["batch"] * TRAIN["seq"] / (p50["wall"] / 1e3)
    print(f"[train] step p50 over {TRAIN_TIMED}: device (events, first "
          f"enqueue to last kernel) {p50['device']:.2f} ms, host enqueue "
          f"{p50['host']:.2f} ms, wall {p50['wall']:.2f} ms: {sps:.0f} "
          f"samples/s")
    tr = trace("one train step",
               lambda: step(carry, batches[0])[1]["loss"],
               fetch=lambda loss: float(loss))
    out["rubicall"] = {"losses": at,
                       "loop_s": t_loop, "step_ms_p50": p50,
                       "samples_per_s": sps, "peak_gib": peak,
                       "trace": tr}
    del run, carry, batches, restored, like
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the offline identity gate on the benchmark simulator
    smoke = replace(get_config("rubicall-smoke"), quant=QuantPolicy(8, 8))
    t0 = time.perf_counter()
    p, s, loss = train_eval.train_model(smoke, steps=SMOKE_STEPS,
                                        device="cuda")
    print(f"[train] rubicall-smoke QuantPolicy(8, 8): {SMOKE_STEPS} steps in "
          f"{time.perf_counter() - t0:.2f}s, final loss {loss:.2f}")
    out["smoke"] = identity_gate(
        "rubicall-smoke", smoke, p, s,
        quantize_tree(p, QuantPolicy(8, 0), min_size=1), 3, "cuda_core")
    # full width: a fixed step count (its identity does not follow the
    # host's speed)
    steps = FULL_TRAIN_STEPS
    t0 = time.perf_counter()
    p, s, loss = train_eval.train_model(cfg, steps=steps, device="cuda")
    t_full = time.perf_counter() - t0
    print(f"[train] rubicall (full width) on the simulator: {steps} steps "
          f"of {train_eval.BATCH} x {train_eval.CHUNK} in {t_full:.2f}s, "
          f"final loss {loss:.2f}")
    out["rubicall"]["identity"] = identity_gate(
        "rubicall", cfg, p, s, serve.quantize_for_serving(p, 8),
        len(KERNEL_BLOCKS), "tensor_core")
    out["rubicall"]["identity"].update(steps=steps, train_s=t_full)

    # (c) the RUBICON core on the card
    t0 = time.perf_counter()
    qc = QABASConfig(steps=5, channels=16, chunk=96)
    _, arch, hist = run_search(torch.Generator().manual_seed(0), TINY_SPACE,
                               qc, squiggle_batches(
                                   SquiggleConfig(chunk_len=96), 2),
                               device="cuda")
    student = derive_config(arch, TINY_SPACE, channels=16)
    t_search = time.perf_counter() - t0
    t_cfg = get_config("bonito-smoke")
    t_p = tree_map(lambda x: x.cuda(), api.init_params(
        torch.Generator().manual_seed(0), t_cfg))
    t_s = tree_map(lambda x: x.cuda(), api.init_model_state(t_cfg))
    s_p = tree_map(lambda x: x.cuda(), api.init_params(
        torch.Generator().manual_seed(3), student))
    s_s = tree_map(lambda x: x.cuda(), api.init_model_state(student))
    sc_loss = skipclip.make_skipclip_loss(student, t_cfg,
                                          skipclip.SkipClipConfig())
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(
        squiggle_batches(SquiggleConfig(chunk_len=96), 2)).items()}
    gates = skipclip.gates_for_epoch(student.n_blocks, 2, 1, device="cuda")
    t1 = time.perf_counter()
    (_, (sm, _)), g = api.value_and_grad(sc_loss, s_p, s_s, t_p, t_s,
                                          batch, gates)
    sc_opt = AdamWConfig(lr=2e-3, total_steps=1, warmup_steps=0)
    s_p2, _, _ = adamw_update(s_p, g, init_opt_state(s_p, sc_opt), sc_opt)
    sk = {k: float(v) for k, v in sm.items()}
    t_skip = time.perf_counter() - t1
    mask = pruning.unstructured_mask(s_p2, 0.3)
    pruned = pruning.apply_mask(s_p2, mask)
    q = quantize_tree(pruned, student.quant, min_size=64)
    size = (tree_size_bytes(s_p2), tree_size_bytes(q))
    print(f"[train] QABAS over TINY_SPACE: {qc.steps} steps in "
          f"{t_search:.2f}s (weight loss {hist['w_loss'][0]:.2f} -> "
          f"{hist['w_loss'][-1]:.2f}, E[latency] {hist['latency'][-1]:.3e} s"
          f" on the H100 table) -> {student.n_blocks} blocks k="
          f"{student.kernel_sizes}; SkipClip step (bonito-smoke teacher) "
          f"{t_skip:.2f}s: ctc {sk['ctc']:.2f} kd {sk['kd']:.4f} loss "
          f"{sk['loss']:.2f}; pruned to sparsity "
          f"{pruning.sparsity_of(mask):.3f} and packed: {size[0]} -> "
          f"{size[1]} bytes")
    finite = hist["w_loss"] + hist["a_loss"] + list(sk.values())
    if not np.isfinite(finite).all() or not size[1] < size[0]:
        raise AssertionError(f"RUBICON core: losses {finite}, sizes {size}")
    out["core"] = {"search_s": t_search, "skipclip_s": t_skip,
                   "skipclip": sk, "bytes": size}
    return out


# ---------------------------------------------------------------------------
# LM training: the training forward (blockwise attention, the chunked SSD,
# MoE routing with its aux loss) through train_loop.run at full width,
# and the card's gradients against the CPU's at smoke size

# (arch, layers kept (None: all), batch, seq, steps, the loss must fall):
# qwen1.5-4b cut to 8 of 40 layers, so fp32 params, grads and both Adam
# moments (16 B a parameter, 22.6 GB at 1.41 B parameters) and the
# 151936-wide logits fit the card with room; mamba2-130m whole (its chunk
# of 256 is where the reference's SSD gradient overflows: its gradients
# must be finite); granite-moe-1b-a400m whole (all 32 experts, top-8: a
# finite loss and aux). Six or four steps, within the five of warmup,
# need not lower a loss; qwen's 30 decide that its loss falls.
LM_TRAIN = [("qwen1.5-4b", 8, 4, 1024, 30, True),
            (SSM_ARCH, None, 4, 2048, 6, False),
            ("granite-moe-1b-a400m", None, 4, 1024, 4, False)]
LM_TRAIN_TIMED = 3          # steps timed one by one after the loop
# peak lr, after 5 warmup steps: the launcher's 2e-3 (QABAS's setting)
# moves each 0.02-std weight by a tenth a step, and qwen's loss climbed
# from 12.33 to 13.2 on an H100; there, at 3e-4, the mean of 5 steps
# fell 0.013 in 30 steps, at 6e-4 0.23
LM_LR = 6e-4
LM_GRAD_ARCHS = ("qwen1.5-4b-smoke", "granite-moe-1b-a400m-smoke",
                 "deepseek-v3-671b-smoke", "mamba2-130m-smoke")
# card vs CPU gradients at smoke size, both fp32 with TF32 off: only the
# order of fp32 sums differs (tests/test_torch_cuda.py holds the same)
LM_GRAD_TOL = 1e-5          # of the tree's largest |gradient|
MIXER_LEAVES = ("wq", "wk", "wv", "wdq", "wuq", "wdkv", "wukv", "in_proj")


def lm_step_flops(cfg, batch: int, seq: int) -> float:
    """Matmul FLOPs of one training step with each block rematerialised:
    2 N per token forward, 4 N backward, 2 N again for the remat, over
    the non-embedding parameters N a token touches (MoE: the top-k
    experts), the unembedding's 6 V d per token, and the attention's
    score and value products (4 S^2 hd a head forward, the whole S x S
    block, as blockwise_attn computes it at S <= kv_chunk) four times.
    An SSM counts its projections; its chunked scan's products are
    left out. A vlm's patch positions run through every layer (and the
    d x d projection) but not the unembedding, which the loss takes
    over the text positions only; an audio arch adds its encoder over
    the frames,
    the cross-attention (q and o a token, k and v a frame, scores and
    values against every frame) and runs an ungated MLP."""
    d, L = cfg.d_model, cfg.n_layers
    P = cfg.frontend_tokens if cfg.family == "vlm" else 0
    S = seq + P
    tokens = batch * S
    extra = 8.0 * d * d * batch * P
    if cfg.family == "ssm":
        from repro_torch.models.lm.ssm import ssm_dims
        d_in, nh, N, _ = ssm_dims(cfg)
        per_layer = d * (2 * d_in + 2 * N + nh) + d_in * d
        attn = 0.0
    else:
        hd, H, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
        per_layer = d * hd * (2 * H + 2 * Hkv)
        ff = cfg.moe_d_ff or cfg.d_ff
        gates = 2 if cfg.family == "audio" else 3
        per_layer += gates * d * ff * (cfg.experts_per_tok or 1)
        attn = 4 * 4.0 * batch * H * S * S * hd * L
    if cfg.family == "audio":
        F, n_enc = cfg.frontend_tokens, cfg.n_enc_layers
        enc_layer = d * hd * (2 * H + 2 * Hkv) + 2 * d * cfg.d_ff
        extra += (8.0 * enc_layer * n_enc * batch * F
                  + 4 * 4.0 * batch * H * F * F * hd * n_enc
                  + 8.0 * L * (2 * d * H * hd * tokens
                               + 2 * d * Hkv * hd * batch * F)
                  + 4 * 4.0 * batch * H * S * F * hd * L)
    return (8.0 * per_layer * L * tokens
            + 6.0 * cfg.vocab_size * d * batch * seq + attn + extra)


def lm_train_one(arch, layers, batch, seq, steps, falls, smi,
                 repeat=False) -> dict:
    """One LM trained through ``train_loop.run`` on the card (fp32 master
    leaves drawn there, bf16 compute, AdamW at ``LM_LR`` after 5 warmup
    steps) on the launcher's token stream (``repeat``: its first batch
    over and over), then each of ``LM_TRAIN_TIMED`` steps timed alone
    and one step traced."""
    import tempfile
    full = get_config(arch)
    cfg = full if layers is None else replace(full, n_layers=layers)
    cut = ("no cut" if layers is None else
           f"cut to {layers} of {full.n_layers} layers with "
           f"dataclasses.replace")
    opt_cfg = AdamWConfig(lr=LM_LR, warmup_steps=5, total_steps=steps)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = train_launcher.data_for(cfg, batch, seq)
    if repeat:
        data = itertools.repeat(next(data))
    with tempfile.TemporaryDirectory() as ckdir:
        t0 = time.perf_counter()
        run = train_loop.run(
            cfg, opt_cfg, TrainLoopConfig(steps=steps, log_every=1,
                                          ckpt_every=10 ** 9, ckpt_dir=ckdir),
            data, device="cuda")
        t_loop = time.perf_counter() - t0
    carry = run["carry"]
    n_params = sum(v.numel() for v in tree_leaves(carry.params))
    hist = run["history"]
    losses = [r["loss"] for r in hist]
    norms = [r["grad_norm"] for r in hist]
    finite = np.isfinite(losses).all() and np.isfinite(norms).all()
    k = max(2, steps // 6)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    marks = sorted({1, (steps + 1) // 2, steps})
    at = {m: losses[m - 1] for m in marks}
    step = api.make_train_step(cfg, opt_cfg)
    data = train_launcher.data_for(cfg, batch, seq)
    batches = [{key: torch.from_numpy(v).cuda() for key, v in
                next(data).items()} for _ in range(LM_TRAIN_TIMED)]
    carry, t = time_train_steps(step, carry, batches)
    p50 = {key: statistics.median(v) for key, v in t.items()}
    flops = lm_step_flops(cfg, batch, seq)
    # the loss's terms (ce, moe_aux, mtp) at the trained params, on a
    # batch no step saw: the step's metrics carry only their sum, and on
    # a batch it trained on mamba2's ce read 6.90 against 10.92 (H100),
    # as Adam's momentum kept raising the tied embedding rows it touched
    held_out = {key: torch.from_numpy(v).cuda() for key, v in next(
        token_batches(cfg, batch, seq, seed=1)).items()}
    with torch.no_grad():
        _, (terms, _) = api.make_loss_fn(cfg)(carry.params, {}, held_out)
    terms = {key: float(v) for key, v in terms.items()}
    print(f"[lm-train] {cfg.name} ({smi}): {cfg.n_layers} layers ({cut}), "
          f"d {cfg.d_model}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B "
          f"params; fp32 master leaves and AdamW state, {cfg.dtype} "
          f"compute, remat {cfg.remat}, lr {opt_cfg.lr:g}; batch {batch} x "
          f"{seq} tokens{' (one batch, repeated)' if repeat else ''}, "
          f"{steps} steps of train_loop.run in {t_loop:.2f}s; loss at steps "
          f"{', '.join(f'{m}: {v:.4f}' for m, v in at.items())} (mean of "
          f"the first {k} {first:.4f}, of the last {k} {last:.4f}); grad "
          f"norm {norms[0]:.4f} -> {norms[-1]:.4f}; the loss's terms after "
          f"{steps + LM_TRAIN_TIMED} steps on a held-out batch: "
          + ", ".join(f"{key} {v:.4f}" for key, v in terms.items()))
    wall_s = p50["wall"] / 1e3
    print(f"[lm-train] {cfg.name} ({smi}): step p50 over {LM_TRAIN_TIMED}: "
          f"device (events, first enqueue to last kernel) "
          f"{p50['device']:.2f} ms, host enqueue {p50['host']:.2f} ms, wall "
          f"{p50['wall']:.2f} ms: {batch * seq / wall_s:.0f} tokens/s; "
          f"{flops / 1e12:.2f} TFLOP of matmuls a step, "
          f"{flops / wall_s / 1e12:.1f} TFLOP/s")
    if not (finite and np.isfinite(list(terms.values())).all()):
        raise AssertionError(f"{cfg.name}: losses {losses}, grad norms "
                             f"{norms}, terms {terms}")
    if falls and not last < first:
        raise AssertionError(f"{cfg.name}: the loss did not fall: {losses}")
    tr = trace(f"one {cfg.name} train step ({smi})",
               lambda: step(carry, batches[0])[1]["loss"],
               fetch=lambda loss: float(loss))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[lm-train] {cfg.name}: peak device memory {peak:.2f} GiB "
          f"({smi})")
    del run, carry, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "cut": cut, "params": n_params,
            "losses": at, "first_mean": first, "last_mean": last,
            "grad_norms": (norms[0], norms[-1]), "loop_s": t_loop,
            "step_ms_p50": p50, "tflop_per_step": flops / 1e12,
            "peak_gib": peak, "trace": tr, "terms": terms}


def lm_grad_check(arch, smi) -> dict:
    """The LM loss and every gradient leaf at smoke size (fp32 leaves,
    fp32 compute, TF32 off) on the card against the CPU, from the same
    params and token batch; the training forward launches no kernel."""
    cfg = get_config(arch)
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             dtype=torch.float32)
    batch = {key: torch.from_numpy(v) for key, v in next(
        train_launcher.data_for(cfg, 2, 64)).items()}
    out = []
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        ops.reset_launch_counts()
        (loss, (m, _)), g = api.value_and_grad(
            api.make_loss_fn(cfg), p, {}, {key: v.to(dev)
                                           for key, v in batch.items()})
        launched = {key: n for key, n in ops.launch_counts().items() if n}
        out.append((float(loss), {key: float(v) for key, v in m.items()},
                    {key: v.cpu() for key, v in tree_items(g)}, launched))
    (cl, cm, cg, _), (gl, gm, gg, launched) = out
    scale = max(float(v.abs().max()) for v in cg.values())
    err = {key: float((gg[key] - v).abs().max()) for key, v in cg.items()}
    worst = max(err, key=err.get)
    mixer = {key: (float(gg[key].abs().max()), err[key]) for key in cg
             if any(f"/{n}/" in key for n in MIXER_LEAVES)}
    print(f"[lm-train] gradients {arch} ({smi}): loss card {gl:.6f} CPU "
          f"{cl:.6f}; "
          f"{len(cg)} leaves, worst |card - CPU| {err[worst]:.3e} at {worst} "
          f"(tree max |g| {scale:.3e}, bound {LM_GRAD_TOL:g} of it); mixer "
          + ", ".join(f"{key.split('/', 2)[-1]} max|g| {a:.2e} err {e:.1e}"
                      for key, (a, e) in mixer.items()
                      if key.endswith("kernel")))
    bad = (launched or abs(gl - cl) > 1e-5 * abs(cl)
           or any(abs(gm[key] - cm[key]) > 1e-5 * abs(cm[key]) for key in cm)
           or err[worst] > LM_GRAD_TOL * scale or not mixer
           or any(a == 0.0 for a, _ in mixer.values()))
    if bad:
        raise AssertionError(f"{arch}: card gradients vs CPU: launched "
                             f"{launched}, loss {gl} vs {cl}, metrics {gm} "
                             f"vs {cm}, worst {worst} {err[worst]}, mixer "
                             f"{mixer}")
    return {"loss": (gl, cl), "max_abs_err": err[worst], "scale": scale,
            "mixer": mixer}


def phase_lm_train(smi: str) -> dict:
    out = {name: lm_train_one(name, *rest, smi=smi)
           for name, *rest in LM_TRAIN}
    out["grads"] = {arch: lm_grad_check(arch, smi) for arch in LM_GRAD_ARCHS}
    return out


# phase 16: the knob search at full width, then the three examples
KNOB_BUDGET = 10      # baseline + every fp8 and int8 candidate + bf16 cuda
KNOB_PROMPT = 8       # prompt and new tokens a request: cache_len 16
KNOB_ARGV = ["--arch", LM_ARCH, "--wbits", "8", "--slots", str(LM_SLOTS),
             "--attn-backend", "auto", "--prompt-len", str(KNOB_PROMPT),
             "--tokens", str(KNOB_PROMPT), "--knob-budget",
             str(KNOB_BUDGET), "--knob-search"]
EXAMPLES = ("quickstart_torch.py", "train_basecaller_torch.py",
            "serve_quantized_lm_torch.py")
ATTN_KERNELS = ("gqa_paged", "gqa_paged_chunk")
KNOB_TOPK = 4         # top logits kept a row, to read where tokens part


def knob_cache_bytes(cfg, knobs, n_slots: int, cache_len: int) -> int:
    """The paged pool of one uniform-mode candidate, counted from the
    config: K and V arenas of every layer over n_slots x ceil(cache_len
    / block_len) blocks, int8's fp32 scale per position and KV head,
    the int32 positions and each layer's window."""
    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    esize = {"bf16": 2, "fp8": 1, "int8": 1}[knobs.quant_policy]
    positions = n_slots * -(-cache_len // knobs.block_len) * knobs.block_len
    scales = 2 * L * positions * hkv * 4 if knobs.quant_policy == "int8" \
        else 0
    return 2 * L * positions * hkv * hd * esize + scales \
        + L * positions * 4 + L * 4


class KnobWatch:
    """Hooks on the knob search's warm drain (the first of a candidate's
    three; the two timed drains run bare). Every paged-attention call of
    a held ``cuda`` candidate (``start(hold=True)``) is held against its
    plain version on the same pool state, at phase 4's tolerances; every
    served row's top ``KNOB_TOPK`` logits are kept by (request,
    position), so a greedy token that leaves another candidate's can be
    read at its margin. Every drain's greedy tokens are kept too."""

    topk = KNOB_TOPK

    def __init__(self):
        self.on = self.first = False
        self.hold = True
        self.rids, self.calls, self.tops = [], [], []
        self.drains = []

    def paged(self, real):
        """``ops._paged``: the kernel (counted as ever), then its plain
        version on the same inputs; errors stay on the card until the
        candidate ends."""
        def fn(q, *args, chunk, **kw):
            out = real(q, *args, chunk=chunk, **kw)
            if self.on and self.hold and q.is_cuda:
                plain = ref.gqa_paged_chunk_ref if chunk else \
                    ref.gqa_paged_ref
                want = self.run_plain(plain, (q, *args), kw)
                t = args[3]
                live = (t >= 0).reshape(*t.shape,
                                        *(1,) * (out.ndim - t.ndim))
                name = "gqa_paged_chunk" if chunk else "gqa_paged"
                if q.dtype != args[0].dtype == torch.float32:
                    # the audio family's cross-attention: a bucket of
                    # its own, at one rounding of the bf16 output
                    name, (rtol, atol) = f"{name} cross", CROSS_TOL
                else:
                    rtol = atol = ATTN_TOL[args[0].dtype]
                self.calls.append((name, held_row(out, want, rtol, atol,
                                                  live)))
            return out
        return fn

    def run_plain(self, fn, args: tuple, kw: dict):
        return fn(*args, **kw)

    def dispatch(self, real):
        """``TokenRunner.dispatch``: the request in each slot, and which
        ticks are held (:meth:`select`)."""
        def fn(runner, works):
            self.rids = [None if w is None else w.req.rid for w in works]
            self.select(works)
            return real(runner, works)
        return fn

    def select(self, works) -> None:
        """Every tick of a held candidate is held."""

    def step(self, real):
        """``transformer.decode_step_slots``: each row's top logits at
        the position it emits from."""
        def fn(params, caches, tokens, t, cfg, logits_at=None, **kw):
            logits, caches = real(params, caches, tokens, t, cfg,
                                  logits_at=logits_at, **kw)
            if self.on:
                col = (torch.zeros(t.shape[0], dtype=torch.long)
                       if logits_at is None else logits_at.long().cpu())
                at = t.cpu().gather(1, col[:, None])[:, 0].tolist()
                top = logits[:, 0, :].float().topk(self.topk, dim=-1)
                self.tops.append((list(self.rids), at, top.values,
                                  top.indices))
            return logits, caches
        return fn

    def drain(self, real):
        """``serving._drain``: watch the first drain of a candidate;
        keep each drain's tokens."""
        def fn(*a, **kw):
            self.on, self.first = self.first, False
            try:
                self.drains.append(real(*a, **kw))
                return self.drains[-1]
            finally:
                self.on = False
        return fn

    def start(self, hold: bool = True) -> None:
        self.first, self.calls, self.tops = True, [], []
        self.drains, self.hold = [], hold

    def take(self) -> tuple:
        """(:func:`fold_held` of the calls, by kernel, (the warm drain's
        tokens, {(rid, position): (top values, top ids)}), whether every
        drain served the same tokens) of the candidate just measured,
        read back once."""
        held = fold_held(self.calls)
        tops = {}
        for rids, at, vals, ids in self.tops:
            for rid, p, v, i in zip(rids, at, vals.tolist(), ids.tolist()):
                if rid is not None and p >= 0:
                    tops[(rid, p)] = (v, i)
        return (held, (self.drains[0], tops),
                all(d == self.drains[0] for d in self.drains))


def flip_margins(base: tuple, cand: tuple, prompt_len) -> dict:
    """Greedy tokens and top logits of one drain of each of two
    candidates that hold the same arena values (one ``gather``, one
    ``cuda``), request by request up to the first token where they part:
    the largest |d top-1 logit| over the shared steps, and at each
    parting token the two margins that the kernel's rounding had to
    cross (baseline's top-1 minus its logit of the candidate's token,
    and the reverse), summed."""
    (btok, btop), (ctok, ctop) = base, cand
    shared, flips = 0.0, []
    for rid, seq in btok.items():
        P = prompt_len[rid] if isinstance(prompt_len, dict) else prompt_len
        for j, (a, b) in enumerate(zip(seq, ctok[rid])):
            (bv, bi), (cv, ci) = btop[(rid, P + j - 1)], \
                ctop[(rid, P + j - 1)]
            # the served token holds the top logit (argmax takes the
            # first of a tie, topk may list another first: logits are
            # bf16, so ties are common)
            if a not in bi or bv[bi.index(a)] != bv[0] or \
                    b not in ci or cv[ci.index(b)] != cv[0]:
                raise AssertionError(f"request {rid} token {j}: top "
                                     f"logits {bi} {bv} / {ci} {cv} vs "
                                     f"tokens {a} / {b}")
            if a == b:
                shared = max(shared, abs(bv[0] - cv[0]))
                continue
            gap = ((bv[0] - bv[bi.index(b)]) if b in bi else np.inf) + \
                ((cv[0] - cv[ci.index(a)]) if a in ci else np.inf)
            flips.append((rid, j, gap))
            break
    return {"shared_max_d_top1": shared, "flips": flips,
            "equal": sum(btok[r] == ctok[r] for r in btok)}


def start_example(script: str, *args) -> tuple:
    """``examples/<script>`` on the card as a subprocess at its default
    flags, started; returns (the process, its start time)."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.Popen([sys.executable, str(root / "examples" / script),
                             *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=str(root))
    return proc, time.perf_counter()


def finish_example(script: str, proc, t0: float) -> tuple:
    """Wait for a :func:`start_example` process (killed past 240 s);
    returns (stdout, seconds). Fails on a non-zero exit."""
    try:
        out, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{script} exited {proc.returncode}:\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
    return out, secs


def example_figures(script: str, out: str) -> dict:
    """The identities and throughputs an example prints."""
    def num(pattern):
        m = re.search(pattern, out)
        if m is None:
            raise AssertionError(f"{script}: no match for {pattern!r}:\n"
                                 f"{out[-2000:]}")
        return float(m.group(1))
    if script.startswith("quickstart"):
        return {"identity_fresh": num(r"identity on fresh reads: (\S+)"),
                "identity_served": num(r"\); identity (\S+)"),
                "bases_per_s": num(r"\((\d+) bases/s"),
                "loss_last": num(r"step \d+: ctc loss (\S+)\n== 3")}
    if script.startswith("train_basecaller"):
        rows = [ast.literal_eval(line) for line in out.splitlines()
                if line.startswith("{")]
        return {"identity": num(r"held-out read identity: (\S+)"),
                "steps": rows[-1]["step"], "loss_first": rows[0]["loss"],
                "loss_last": rows[-1]["loss"], "wall_s": rows[-1]["wall_s"]}
    return {"bf16_tok_s": num(r"\[engine bf16\].*\((\S+) tok/s decode"),
            "int8_tok_s": num(r"\[engine int8\].*\((\S+) tok/s decode"),
            "h100_weight_read_ms_bf16": num(r"projection.*bf16 (\S+) ms"),
            "h100_weight_read_ms_int8": num(r"-> int8 (\S+) ms")}


def phase_rubicon() -> dict:
    """``launch/serve.py --knob-search`` at full-width qwen1.5-4b (int8
    weights drawn on the card, 4 slots, both backends), each candidate's
    launches by route and pool bytes checked, its paged-attention calls
    held against their plain version and its greedy tokens read against
    the ``gather`` candidate's; then the three examples on the card."""
    import tempfile

    from repro_torch.core.qabas import serving as knobs_mod
    cfg = get_config(LM_ARCH)
    real = knobs_mod.measure_knobs
    per, watch = [], KnobWatch()
    # the first cuda candidate of each cache mode has its paged calls
    # held: every route and arena dtype the search serves
    held_modes = set()

    def counted(*a, **kw):
        knobs = kw["knobs"] if "knobs" in kw else a[2]
        hold = (knobs.attn_backend == "cuda"
                and knobs.quant_policy not in held_modes)
        if hold:
            held_modes.add(knobs.quant_policy)
        before = ops.launch_counts(routes=True)
        watch.start(hold=hold)
        t = time.perf_counter()
        r = real(*a, **kw)
        after = ops.launch_counts(routes=True)
        per.append((r, time.perf_counter() - t, {
            k: {rt: after[k][rt] - before[k][rt] for rt in after[k]}
            for k in after}, *watch.take()))
        return r
    print(f"[rubicon] knob search: {' '.join(KNOB_ARGV)} (budget "
          f"{KNOB_BUDGET})")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for mod, name, hook in (
                (knobs_mod, "measure_knobs", lambda f: counted),
                (knobs_mod, "_drain", watch.drain),
                (ops, "_paged", watch.paged),
                (runner_mod.TokenRunner, "dispatch", watch.dispatch),
                (tfm, "decode_step_slots", watch.step)):
            stack.enter_context(mock.patch.object(
                mod, name, hook(getattr(mod, name))))
        # the watch hooks Python wrappers and the step: eager plans
        stack.enter_context(eager_plans())
        serve.main(KNOB_ARGV)
    search_s = time.perf_counter() - t0
    total = ops.launch_counts(routes=True)
    per_tick = qmatmul_per_tick(replace(cfg, quant=QuantPolicy(8, 0)))
    cache_len = 2 * KNOB_PROMPT
    rows, modes_on_cuda, modes_held = [], set(), set()
    for r, secs, got, held, _, same_tokens in per:
        k = r.knobs
        where = f"knob candidate {k.label()}"
        want = knob_cache_bytes(cfg, k, LM_SLOTS, cache_len)
        if r.cache_bytes != want:
            raise AssertionError(f"{where}: pool {r.cache_bytes} B, the "
                                 f"arena's analytic size {want} B")
        q = got["qmatmul"]
        attn = {n: got[n] for n in ATTN_KERNELS}
        n_attn = sum(sum(v.values()) for v in attn.values())
        if q["cuda_core"] or not q["tensor_core"] or \
                q["tensor_core"] % per_tick:
            raise AssertionError(f"{where}: qmatmul {q}, {per_tick} a "
                                 f"tick, all on tensor_core")
        ticks = q["tensor_core"] // per_tick
        if k.attn_backend == "cuda":
            check_routes(attn, ATTN_KERNELS, where)
            if not all(v["tensor_core"] for v in attn.values()) or \
                    n_attn != ticks * cfg.n_layers:
                raise AssertionError(f"{where}: {attn} over {ticks} ticks")
            # the warm drain's calls, held against the plain version
            if held and (set(held) != set(ATTN_KERNELS)
                         or not held_ok(held)):
                raise AssertionError(f"{where}: kernel vs plain over the "
                                     f"warm drain {held}")
            if held:
                modes_held.add(k.quant_policy)
            modes_on_cuda.add(k.quant_policy)
        elif n_attn:
            raise AssertionError(f"{where}: the gather backend launched "
                                 f"paged kernels {attn}")
        # the parity column reads the last drain, the margins the warm
        # one: greedy decode must serve the same tokens in each
        if not same_tokens:
            raise AssertionError(f"{where}: drains served other tokens")
        others = {n: v for n, v in got.items() if sum(v.values()) and
                  n not in ATTN_KERNELS + ("qmatmul", "scatter_rows")}
        sc = ticks * scatter_per_tick(cfg, int8=k.quant_policy == "int8")
        if others or got["scatter_rows"] != {"tensor_core": 0,
                                             "cuda_core": sc}:
            raise AssertionError(f"{where}: launched {others}, scatter_rows "
                                 f"{got['scatter_rows']} (want {sc} on "
                                 f"cuda_core)")
        rows.append({"knobs": k.label(), "tok_s": r.decode_tok_s,
                     "cache_bytes": r.cache_bytes,
                     "tok_s_per_mib": r.score * 2 ** 20,
                     "parity_bf16": r.tokens_match_bf16, "seconds": secs,
                     "ticks": ticks, "launches": got,
                     "held_vs_plain": held})
        print(f"[rubicon] {k.label()}: {r.decode_tok_s:.1f} tok/s decode, "
              f"{r.cache_bytes} B pool (analytic {want}), {ticks} ticks, "
              f"qmatmul {q}, attention {attn}, {secs:.2f}s"
              + "".join(f"; {n} vs plain over the warm drain: {c} calls, "
                        f"max|err| {e:.3g}" for n, (c, e, *_) in
                        held.items()))
    if modes_on_cuda != {"bf16", "fp8", "int8"} or modes_held != modes_on_cuda:
        raise AssertionError(f"cuda candidates measured {modes_on_cuda}, "
                             f"held {modes_held}")
    # each cuda candidate against a gather one of the same cache mode
    # (the same arena values; only the attention's arithmetic differs):
    # where greedy tokens part, the two margins crossed sum to at most
    # twice phase 5's one-tick |d logit| bound
    gathers = {r.knobs.quant_policy: warm
               for r, _, _, _, warm, _ in per
               if r.knobs.attn_backend == "gather"}
    if not gathers:
        raise AssertionError("no gather candidate measured")
    for row, (r, _, _, _, warm, _) in zip(rows, per):
        mode = r.knobs.quant_policy
        if r.knobs.attn_backend != "cuda" or mode not in gathers:
            continue
        m = row["vs_gather"] = flip_margins(gathers[mode], warm,
                                            KNOB_PROMPT)
        print(f"[rubicon] {r.knobs.label()} vs {mode} gather: "
              f"{m['equal']} of {len(warm[0])} requests equal in the warm "
              f"drains; shared "
              f"steps max |d top-1 logit| {m['shared_max_d_top1']:.4f}; "
              f"parted at (request, token, margins crossed) "
              f"{[(rid, j, round(g, 4)) for rid, j, g in m['flips']]}")
        if m["shared_max_d_top1"] > LM_TICK_BF16[0] or any(
                not g <= 2 * LM_TICK_BF16[0] for *_, g in m["flips"]):
            raise AssertionError(f"{r.knobs.label()} vs gather: {m}")
    print(f"[rubicon] knob search: {len(rows)} candidates in "
          f"{search_s:.1f}s, launches {total}")
    examples = {}
    with tempfile.TemporaryDirectory() as ckdir:
        # the three at once, each mostly host time on a core of its own
        t = time.perf_counter()
        running = [(script, start_example(script, *(
            ("--ckpt-dir", ckdir) if script.startswith("train") else ())))
            for script in EXAMPLES]
        for script, proc in running:
            out, secs = finish_example(script, *proc)
            fig = {"seconds": secs, **example_figures(script, out)}
            examples[script] = fig
            print(f"[rubicon] example {script}: {json.dumps(fig)}")
        print(f"[rubicon] examples, run together: "
              f"{time.perf_counter() - t:.1f}s")
    return {"search_s": search_s, "candidates": rows, "launches": total,
            "examples": examples}


# ---------------------------------------------------------------------------
# The ssm and hybrid families through the engine: full-width hymba-1.5b
# and mamba2-130m

HYMBA_ARCH = "hymba-1.5b"
HYMBA_CACHE = 1280            # per-request capacity: a window layer rings at
#                               1024, a full layer holds 80 blocks of 16
LONG_PROMPT = 1100            # one prompt past the window: every ring wraps
ENGINE_NEW = 16               # greedy new tokens a request
HYMBA_PROMPT = 1536           # static prompt tokens per row
# hymba's whole-prompt prefill, kernels vs plain versions (bounds stated
# before the first run on the card; 32 residual layers, as qwen's 40)
HYMBA_PREFILL = {torch.float32: (0.02, 1e-3), torch.bfloat16: (0.25, 0.05)}


def engine_requests(cfg, long: bool = True):
    """The served traffic of phases 17 and 18: 8 greedy requests of
    32-128 random prompt tokens (phase 5's prompts), ``ENGINE_NEW`` new
    tokens each, and (``long``) one more whose 1100-token prompt passes
    the 1024-position window."""
    rs = np.random.RandomState(0)
    lens = [int(rs.randint(32, 129)) for _ in range(8)] + [LONG_PROMPT]
    reqs = [Request(rid=i, prompt=rs.randint(1, cfg.vocab_size,
                                             size=n).tolist(),
                    sampling=SamplingParams(max_new_tokens=ENGINE_NEW))
            for i, n in enumerate(lens)]
    return reqs if long else reqs[:-1]


HELD_TOPK = 64          # top logits kept a row in phases 17 and 18


class GraphedPlain:
    """A plain version captured into a CUDA graph once per input
    signature and replayed on copies of each call's inputs: the same
    PyTorch ops on the card, enqueued at once. The paged plain versions
    walk a table column at a time (~20 ops a column, 64-80 columns at
    hymba's cache_len), so launched op by op they cost ~40 ms of host
    time a call, thousands of calls a drain."""

    def __init__(self):
        self.graphs = {}

    def __call__(self, fn, args: tuple, kw: dict):
        names = sorted(kw)
        ins = list(args) + [kw[n] for n in names]
        key = (fn, tuple((tuple(a.shape), a.dtype, a.stride())
                         if torch.is_tensor(a) else a for a in ins))
        if key not in self.graphs:
            static = [a.clone() if torch.is_tensor(a) else a for a in ins]

            def run():
                return fn(*static[:len(args)],
                          **dict(zip(names, static[len(args):])))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = run()
            self.graphs[key] = (graph, static, out)
        graph, static, out = self.graphs[key]
        for dst, src in zip(static, ins):
            if torch.is_tensor(dst):
                dst.copy_(src)
        graph.replay()
        return out


class HeldWatch(KnobWatch):
    """:class:`KnobWatch` on one whole drain: every paged-attention call
    held against its plain version (replayed from a CUDA graph,
    :class:`GraphedPlain`), every qmatmul launch too (``QMM_TOL``), and
    the top ``HELD_TOPK`` logits of each row kept. Flash launches are
    held by a :class:`FlashHold` beside it.

    ``hold_from`` (a window's length) holds a fixed set of ticks
    instead: the first decode-only tick, the first mixed tick, and
    every tick with a row at or past that position — every tick in
    which a window ring wraps."""

    topk = HELD_TOPK

    def __init__(self, hold_from: Optional[int] = None):
        super().__init__()
        self.plain = GraphedPlain()
        self.hold_from = hold_from
        self.kinds_seen = set()
        self.held_ticks = self.ticks = 0

    def select(self, works) -> None:
        self.ticks += 1
        if self.hold_from is None:
            return
        live = [w for w in works if w is not None]
        mixed = any(isinstance(w, runner_mod.PrefillWork) for w in live)
        top = max(w.pos + (len(w.payload) - 1
                           if isinstance(w, runner_mod.PrefillWork) else 0)
                  for w in live) if live else -1
        self.hold = mixed not in self.kinds_seen or top >= self.hold_from
        self.kinds_seen.add(mixed)
        self.held_ticks += self.hold

    def run_plain(self, fn, args: tuple, kw: dict):
        return self.plain(fn, args, kw)

    def qmatmul(self, real):
        """``ops.qmatmul``: the kernel (counted as ever), then its plain
        version on the same operands."""
        def fn(x, w, scale=None, **kw):
            out = real(x, w, scale, **kw)
            if self.on and self.hold and x.is_cuda:
                bits, scale, w = (w.bits, w.scale, w.data)  \
                    if isinstance(w, PackedTensor) else (kw.get("bits", 8),
                                                         scale, w)
                want = ref.qmatmul_ref(
                    x.reshape(-1, x.shape[-1]), w,
                    scale.float().reshape(1, -1), bits=bits).float()
                self.calls.append(("qmatmul", held_row(
                    out.reshape(want.shape), want, QMM_TOL, QMM_TOL)))
            return out
        return fn


def serve_held(params, cfg, backend: str, reqs,
               cache_len: int = HYMBA_CACHE,
               hold_from: Optional[int] = None) -> dict:
    """One drain of ``reqs`` through a fresh engine on ``backend`` (4
    slots, chunk 16, blocks of 16, a bf16 arena of ``cache_len``
    positions a slot, warmed up), every paged-attention and qmatmul
    launch (:class:`HeldWatch`; with ``hold_from``, those of its fixed
    set of ticks) and every flash launch (:class:`FlashHold`) held
    against its plain version and each row's top logits kept. Returns
    the engine, the launches by kernel and route, the plans' calls, the
    held calls by bucket and the ticks held of the ticks served."""
    # eager plans: the watch and the flash hold wrap Python functions,
    # which a graph's replay never calls
    engine = api.make_serving_engine(
        params, cfg, device="cuda", n_slots=LM_SLOTS, cache_len=cache_len,
        prefill_chunk=LM_CHUNK, block_len=BLOCK, cache_dtype=torch.bfloat16,
        attn_backend=backend, graphs=False)
    runner = engine.runner
    engine.warmup()
    watch = HeldWatch(hold_from)
    flash = FlashHold(attn_mod.flash_attention)
    watch.start()
    ops.reset_launch_counts()
    runner.plans.calls.clear()
    with contextlib.ExitStack() as stack:
        for mod, name, new in (
                (ops, "_paged", watch.paged(ops._paged)),
                (ops, "qmatmul", watch.qmatmul(ops.qmatmul)),
                (attn_mod, "flash_attention", flash),
                (runner_mod.TokenRunner, "dispatch",
                 watch.dispatch(runner_mod.TokenRunner.dispatch)),
                (tfm, "decode_step_slots",
                 watch.step(tfm.decode_step_slots))):
            stack.enter_context(mock.patch.object(mod, name, new))
        for r in reqs:
            engine.submit(r)
        watch.on = True
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        watch.on = False
    done = engine.completed
    if len(done) != len(reqs) or any(
            r.status != "finished" or
            len(r.out_tokens) != r.sampling.max_new_tokens
            for r in done.values()):
        raise AssertionError(f"{cfg.name} ({backend}): requests not all "
                             f"finished: "
                             f"{[(r.rid, r.status) for r in done.values()]}")
    watch.drains = [{rid: list(r.out_tokens) for rid, r in done.items()}]
    held, warm, _ = watch.take()
    held.update(flash.take())
    return {"engine": engine, "counts": ops.launch_counts(),
            "routes": ops.launch_counts(routes=True),
            "calls": dict(runner.plans.calls), "held": held, "warm": warm,
            "held_ticks": (watch.held_ticks if hold_from is not None
                           else watch.ticks, watch.ticks),
            "seconds": secs, "summary": engine.metrics.summary()}


def check_served(cfg, r: dict, want: dict, where: str) -> tuple:
    """The launches of a held drain equal ``want`` ({kernel: per tick on
    C == 1 ticks, per tick on wider ones}), every launch on the
    tensor-core route, no other kernel launched, and every held call
    within its tolerance and finite. Returns (ticks, narrow ticks)."""
    calls = {key: n for key, n in r["calls"].items()
             if key[0] in ("decode", "mixed")}
    ticks = sum(calls.values())
    narrow = sum(n for (_, w, _), n in calls.items() if w == 1)
    counts = {k: c for k, c in r["counts"].items() if c}
    sc = scatter_per_tick(cfg)
    expect = {k: a * narrow + b * (ticks - narrow)
              for k, (a, b) in {**want, "scatter_rows": (sc, sc)}.items()}
    expect = {k: n for k, n in expect.items() if n}
    if counts != expect:
        raise AssertionError(f"{where}: launches {counts} in {ticks} ticks "
                             f"({narrow} of width 1), want {expect}")
    # the tick's writes (scatter_rows, a byte copy on CUDA cores) are held
    # in phase 26, at full width, not call by call here
    mma = tuple(k for k in counts if k != "scatter_rows")
    check_routes({k: r["routes"][k] for k in counts}, mma, where)
    if set(r["held"]) != set(mma) or not held_ok(r["held"]):
        raise AssertionError(f"{where}: kernels vs plain over the drain "
                             f"{r['held']}, launched {counts}")
    return ticks, narrow


def report_served(cfg, r: dict, where: str) -> None:
    st = r["summary"]
    print(f"[{where}] {cfg.name}: {st['requests_done']} requests, "
          f"{st['generated_tokens']} tokens in {st['elapsed_s']:.3f}s: "
          f"{st['tokens_per_s']:.1f} tok/s, decode "
          f"{st['decode_tokens_per_s']:.1f} tok/s, TTFT p50 "
          f"{st['ttft_p50_s'] * 1e3:.1f} ms, decode interval p50 "
          f"{st['decode_interval_p50_s'] * 1e3:.2f} ms, tick p50 "
          f"{st['tick_latency_p50_s'] * 1e3:.2f} ms; launches "
          f"{ {k: c for k, c in r['counts'].items() if c} }; held vs plain "
          + "; ".join(f"{n}: {c} calls, max|err| {e:.3g} (max|want| "
                      f"{w:.3g})" for n, (c, e, _, _, w) in
                      r["held"].items()))


def near_ties(base: tuple, cand: tuple, prompt_len: dict, tag: str,
              where: str) -> dict:
    """:func:`flip_margins` of ``cand`` against ``base`` under phase
    16's rule: shared steps' |d top-1 logit| within phase 5's one-tick
    bound, the margins crossed where tokens part within twice it."""
    m = flip_margins(base, cand, prompt_len)
    print(f"[{tag}] {where}: {m['equal']} of {len(base[0])} requests equal; "
          f"shared steps max |d top-1 logit| {m['shared_max_d_top1']:.4f};"
          f" parted at (request, token, margins crossed) "
          f"{[(rid, j, round(g, 4)) for rid, j, g in m['flips']]}")
    if m["shared_max_d_top1"] > LM_TICK_BF16[0] or any(
            not g <= 2 * LM_TICK_BF16[0] for *_, g in m["flips"]):
        raise AssertionError(f"{where}: {m}")
    return m


def phase_hybrid_serve() -> dict:
    """Full-width hymba-1.5b (32 layers: 3 hybrid_full, 29 hybrid_swa
    with a 1024 window) through the engine, int8 weights drawn on the
    card, a bf16 arena: the ``cuda`` drain with every paged call held
    against its plain version, then the ``gather`` drain on the same
    weights, the greedy tokens read against each other at near-tie
    margins; a traced decode and mixed tick; then the static path."""
    cfg = replace(get_config(HYMBA_ARCH), quant=QuantPolicy(8, 0))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, device="cuda", wbits=8)
    torch.cuda.synchronize()
    print(f"[serve-hybrid] {cfg.name}: {cfg.n_layers} layers "
          f"{tfm.layer_plan(cfg)}, d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, window "
          f"{cfg.sliding_window}, int8 weights "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB) in "
          f"{time.perf_counter() - t0:.1f}s")
    reqs = engine_requests(cfg)
    plen = {r.rid: len(r.prompt) for r in reqs}
    per_tick = qmatmul_per_tick(cfg)
    L = cfg.n_layers
    # the paged calls of a fixed set of ticks held: the first decode and
    # mixed ticks and every tick a ring wraps in, the 1100-token
    # request's past position 1024
    cuda = serve_held(params, cfg, "cuda", reqs,
                      hold_from=cfg.sliding_window)
    ticks, narrow = check_served(
        cfg, cuda, {"qmatmul": (per_tick, per_tick), "gqa_paged": (L, 0),
                    "gqa_paged_chunk": (0, L)}, f"{cfg.name} cuda")
    report_served(cfg, cuda, "serve-hybrid")
    pool = cuda["engine"].pool
    by = pool.nbytes_by_class()
    print(f"[serve-hybrid] {cfg.name}: {ticks} ticks ({narrow} of width 1),"
          f" {cuda['held_ticks'][0]} of them held against the plain versions"
          f" (the first decode and mixed ticks and those with a row at or "
          f"past position {cfg.sliding_window}, where the window rings "
          f"wrap), qmatmul {per_tick} a tick (d_model {cfg.d_model} is no "
          f"multiple of 128: every packed projection dequantizes on read,"
          f" as the reference's tiling contract routes it); pool "
          f"{pool.nbytes()} B = {by}; layout (blocks a slot) "
          f"{pool.layout}")
    # the plain backend on the same traffic: only the 1100-token prompt
    # passes the 1024-position window, the one place its mask drops keys
    gather = serve_held(params, cfg, "gather", engine_requests(cfg))
    check_served(cfg, gather, {"qmatmul": (per_tick, per_tick)},
                 f"{cfg.name} gather")
    report_served(cfg, gather, "serve-hybrid")
    margins = near_ties(gather["warm"], cuda["warm"], plen, "serve-hybrid",
                        f"{cfg.name} cuda vs gather")
    del gather
    # a traced decode and mixed tick on a state of 48 positions a row
    runner = cuda["engine"].runner
    for slot in range(LM_SLOTS):
        pool.release_slot(slot)
    for slot in range(LM_SLOTS):
        assert pool.alloc(slot, 64)
    trs = np.random.RandomState(1)
    tok = torch.from_numpy(trs.randint(1, cfg.vocab_size, (LM_SLOTS, 64))
                           .astype(np.int32))
    for c0 in (0, 16, 32):
        lm_tick(runner, cfg, tok[:, c0:c0 + 16],
                torch.arange(c0, c0 + 16, dtype=torch.int32).repeat(
                    LM_SLOTS, 1),
                last=torch.full((LM_SLOTS,), 15, dtype=torch.int32),
                fresh=torch.full((LM_SLOTS,), int(c0 == 0),
                                 dtype=torch.int32))
    snap = [(a, a.clone()) for _, a in cache_leaves(pool.caches)]
    t_mixed = torch.full((LM_SLOTS, 16), -1, dtype=torch.int32)
    t_mixed[0:2] = torch.arange(48, 64, dtype=torch.int32)
    t_mixed[2, 0] = 48
    traced = phase_lm_trace({
        "runner": runner, "cfg": cfg,
        "restore": lambda: [a.copy_(b) for a, b in snap],
        "mixed": (tok[:, 48:64], t_mixed,
                  torch.tensor([15, 15, 0, 0], dtype=torch.int32)),
        "decode": (tok[:, 48:49],
                   torch.full((LM_SLOTS, 1), 48, dtype=torch.int32), None)})
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[serve-hybrid] {cfg.name}: peak device memory {peak:.2f} GiB")
    out = {"launches": cuda["counts"], "routes": cuda["routes"],
           "ticks": ticks, "narrow": narrow, "per_tick": per_tick,
           "held": cuda["held"], "vs_gather": margins, "pool_bytes": by,
           "tick_p50_ms": cuda["summary"]["tick_latency_p50_s"] * 1e3,
           "drain_s": cuda["seconds"], "trace": traced, "peak_gib": peak}
    del cuda, params, snap, runner, pool
    out["static"] = phase_static(
        get_config(HYMBA_ARCH), HYMBA_PROMPT, (FLASH_SWAP, SSD_SWAP),
        HYMBA_PREFILL, 8, ("flash_attention", "ssd_scan"),
        ("flash_", "ssd_"))
    return out


def static_tops(params, cfg, prompt, n_new: int, frames=None) -> tuple:
    """The static path on one prompt (whole-prompt prefill, then
    lockstep decode, as ``serve.static_generate``; an audio prompt's
    ``frames`` through the encoder first): its greedy tokens and each
    step's top logits by position, as :class:`KnobWatch` keeps them."""
    P = len(prompt)
    tok = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    out, tops = [], {}
    with torch.inference_mode():
        enc = (None if frames is None else encdec.encode(
            params["encoder"], torch.from_numpy(frames).cuda()[None], cfg))
        logits, caches = tfm.prefill(params, tok, cfg, cache_len=P + n_new,
                                     enc_out=enc)
        for j in range(n_new):
            row = logits[0, -1].float()
            top = row.topk(HELD_TOPK)
            tops[P + j - 1] = (top.values.tolist(), top.indices.tolist())
            nxt = row.argmax().to(torch.int32).reshape(1, 1)
            out.append(int(nxt))
            if j < n_new - 1:
                logits, caches = tfm.decode_step(params, caches, nxt, P + j,
                                                 cfg)
    return out, tops


def phase_ssm_serve() -> dict:
    """Full-width mamba2-130m (24 layers) through the engine, int8
    weights drawn on the card: the slot recurrence on phase 17's
    traffic, every qmatmul launch held against its plain version; its
    greedy tokens read against the static path's (the chunked SSD
    prefill through ssd_scan, then the one-token decode) on the same
    weights and prompts, at near-tie margins."""
    cfg = replace(get_config(SSM_ARCH), quant=QuantPolicy(8, 0))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(0, cfg, device="cuda", wbits=8)
    # the 1100-token prompt carries the SSM state over 69 chunks
    reqs = engine_requests(cfg)
    plen = {r.rid: len(r.prompt) for r in reqs}
    per_tick = qmatmul_per_tick(cfg)
    served = serve_held(params, cfg, "cuda", reqs)
    ticks, narrow = check_served(cfg, served,
                                 {"qmatmul": (per_tick, per_tick)},
                                 f"{cfg.name} engine")
    report_served(cfg, served, "serve-ssm")
    pool = served["engine"].pool
    print(f"[serve-ssm] {cfg.name}: {ticks} ticks ({narrow} of width 1), "
          f"qmatmul {per_tick} a tick; pool {pool.nbytes()} B = "
          f"{pool.nbytes_by_class()}, no block table")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    static = {}, {}
    for r in reqs:
        toks, tops = static_tops(params, cfg, r.prompt, ENGINE_NEW)
        static[0][r.rid] = toks
        static[1].update({(r.rid, p): v for p, v in tops.items()})
    counts = {k: c for k, c in ops.launch_counts().items() if c}
    print(f"[serve-ssm] {cfg.name}: the static path on each prompt in "
          f"{time.perf_counter() - t0:.1f}s, launches {counts}")
    if counts.get("ssd_scan") != len(reqs) * cfg.n_layers:
        raise AssertionError(f"static path launches {counts}")
    margins = near_ties(static, served["warm"], plen, "serve-ssm",
                        f"{cfg.name} engine vs static")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[serve-ssm] {cfg.name}: peak device memory {peak:.2f} GiB")
    return {"launches": served["counts"], "routes": served["routes"],
            "ticks": ticks, "narrow": narrow, "per_tick": per_tick,
            "held": served["held"], "vs_static": margins,
            "tick_p50_ms": served["summary"]["tick_latency_p50_s"] * 1e3,
            "drain_s": served["seconds"], "peak_gib": peak}


# ---------------------------------------------------------------------------
# Phase 19: the audio family through the engine (whisper-tiny)

AUDIO_ARCH = "whisper-tiny"
AUDIO_NEW = 32               # greedy new tokens a request
AUDIO_CACHE = 64 + AUDIO_NEW  # the longest prompt + its new tokens


def audio_requests(cfg):
    """8 greedy requests of 8-64 random prompt tokens, each with its own
    seeded stub frames (1500 x 384 standard normal), 32 new tokens."""
    rs = np.random.RandomState(0)
    reqs = []
    for i in range(8):
        n = int(rs.randint(8, 65))
        reqs.append(Request(
            rid=i, prompt=rs.randint(1, cfg.vocab_size, size=n).tolist(),
            sampling=SamplingParams(max_new_tokens=AUDIO_NEW),
            frames=rs.randn(cfg.frontend_tokens,
                            cfg.d_model).astype(np.float32)))
    return reqs


def enc_buffer_bytes(cfg, n_slots: int, dtype=torch.bfloat16) -> int:
    """The per-slot encoder buffer, counted from the config: K and V of
    every xdec layer over every slot's frames."""
    return (2 * cfg.n_layers * n_slots * cfg.frontend_tokens
            * cfg.n_kv_heads * cfg.resolved_head_dim * dtype.itemsize)


def check_audio_served(cfg, r: dict, where: str) -> tuple:
    """A whisper drain's launches against its ticks: ``qmatmul``
    (``qmatmul_per_tick``) every tick on tensor cores; on width-1 ticks
    ``gqa_paged`` twice a layer, self-attention over the bf16 arena on
    tensor cores and cross-attention over the fp32 encoder rows on CUDA
    cores; on wider ticks ``gqa_paged_chunk`` once a layer on tensor
    cores (the cross-attention's einsum launches none);
    ``flash_attention`` once an encoder layer at each admission, on
    tensor cores. Every launch held against its plain version and
    finite, the cross-attention's in a bucket of its own at
    ``CROSS_TOL`` and each flash launch also on fp32 copies. Returns
    (ticks, narrow ticks, admissions)."""
    calls = {key: n for key, n in r["calls"].items()
             if key[0] in ("decode", "mixed")}
    ticks = sum(calls.values())
    narrow = sum(n for (_, w, _), n in calls.items() if w == 1)
    admits = r["calls"].get(("stage", 0, "enc"), 0)
    L, per_tick = cfg.n_layers, qmatmul_per_tick(cfg)
    want = {"qmatmul": {"tensor_core": per_tick * ticks, "cuda_core": 0},
            "gqa_paged": {"tensor_core": L * narrow, "cuda_core": L * narrow},
            "gqa_paged_chunk": {"tensor_core": L * (ticks - narrow),
                                "cuda_core": 0},
            "flash_attention": {"tensor_core": cfg.n_enc_layers * admits,
                                "cuda_core": 0},
            "scatter_rows": {"tensor_core": 0,
                             "cuda_core": scatter_per_tick(cfg) * ticks}}
    want = {k: v for k, v in want.items() if sum(v.values())}
    got = {k: v for k, v in r["routes"].items() if sum(v.values())}
    if got != want or admits != 8:
        raise AssertionError(f"{where}: launches by route {got} in {ticks} "
                             f"ticks ({narrow} of width 1), {admits} "
                             f"admissions; want {want}")
    held = {n: h[0] for n, h in r["held"].items()}
    want_held = {"qmatmul": per_tick * ticks, "gqa_paged": L * narrow,
                 "gqa_paged cross": L * narrow,
                 "gqa_paged_chunk": L * (ticks - narrow),
                 "flash_attention": cfg.n_enc_layers * admits,
                 "flash_attention fp32": cfg.n_enc_layers * admits}
    if held != {n: c for n, c in want_held.items() if c} or \
            not held_ok(r["held"]):
        raise AssertionError(f"{where}: kernels vs plain over the drain "
                             f"{r['held']}; calls held want {want_held}")
    return ticks, narrow, admits


def phase_audio_serve() -> dict:
    """Full-width whisper-tiny (4 encoder and 4 decoder layers, d 384, 6
    heads of 64, 1500 frames) through the engine, int8 weights drawn on
    the card, a bf16 paged arena (4 slots, chunk 16, block_len 16): the
    ``cuda`` drain with every paged self- and cross-attention call,
    every qmatmul and every admission's flash launch held against its
    plain version; the ``gather`` drain, its greedy tokens read against
    the ``cuda`` ones at near-tie margins; both against the port's
    one-shot path (``encode`` + ``prefill`` + ``decode_step``); the
    encoder buffer's bytes against their analytic size and the
    admission's (staging's) ms."""
    cfg = replace(get_config(AUDIO_ARCH), quant=QuantPolicy(8, 0))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(0, cfg, device="cuda", wbits=8)
    reqs = audio_requests(cfg)
    plen = {r.rid: len(r.prompt) for r in reqs}
    print(f"[serve-audio] {cfg.name}: {cfg.n_enc_layers} encoder + "
          f"{cfg.n_layers} xdec layers, d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"{cfg.frontend_tokens} frames, int8 weights "
          f"({torch.cuda.memory_allocated() / 2**20:.1f} MiB); 8 requests "
          f"of {sorted(plen.values())} prompt tokens, {AUDIO_NEW} new")
    cuda = serve_held(params, cfg, "cuda", reqs, AUDIO_CACHE)
    ticks, narrow, admits = check_audio_served(cfg, cuda, f"{cfg.name} cuda")
    report_served(cfg, cuda, "serve-audio")
    runner = cuda["engine"].runner
    pool = runner.pool
    enc_bytes = sum(t.numel() * t.element_size()
                    for g in runner.enc_kv.values() for t in g.values())
    want_enc = enc_buffer_bytes(cfg, LM_SLOTS)
    want_pool = knob_cache_bytes(cfg, types.SimpleNamespace(
        quant_policy="bf16", block_len=BLOCK), LM_SLOTS, AUDIO_CACHE)
    if enc_bytes != want_enc or pool.nbytes() != want_pool:
        raise AssertionError(f"encoder buffer {enc_bytes} B (want "
                             f"{want_enc}), pool {pool.nbytes()} B (want "
                             f"{want_pool})")
    frames = torch.from_numpy(reqs[0].frames)
    stage_ms = []
    for _ in range(5):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        runner._stage(frames, 0)
        b.record()
        torch.cuda.synchronize()
        stage_ms.append((a.elapsed_time(b), (time.perf_counter() - t0) * 1e3))
    stage = {"device_ms": statistics.median(x for x, _ in stage_ms),
             "wall_ms": statistics.median(y for _, y in stage_ms)}
    per = {k: round(v / ticks, 2) for k, v in cuda["counts"].items() if v}
    print(f"[serve-audio] {cfg.name}: {ticks} ticks ({narrow} of width 1), "
          f"{admits} admissions; launches a tick (mean) {per}; encoder "
          f"buffer {enc_bytes} B = analytic {want_enc} (K, V x "
          f"{cfg.n_layers} layers x {LM_SLOTS} slots x "
          f"{cfg.frontend_tokens} frames x {cfg.n_kv_heads} x "
          f"{cfg.resolved_head_dim} x bf16); pool {pool.nbytes()} B = "
          f"analytic {want_pool} ({pool.nbytes_by_class()}); admission "
          f"(encode + cross K/V of {cfg.n_layers} layers) p50 device "
          f"{stage['device_ms']:.3f} ms, wall {stage['wall_ms']:.3f} ms")
    gather = serve_held(params, cfg, "gather", audio_requests(cfg),
                        AUDIO_CACHE)
    g_calls = {k: n for k, n in gather["calls"].items()
               if k[0] in ("decode", "mixed")}
    g_ticks = sum(g_calls.values())
    g_want = {"qmatmul": qmatmul_per_tick(cfg) * g_ticks,
              "flash_attention": cfg.n_enc_layers * 8,
              "scatter_rows": scatter_per_tick(cfg) * g_ticks}
    if {k: c for k, c in gather["counts"].items() if c} != g_want:
        raise AssertionError(f"gather drain launches {gather['counts']}, "
                             f"want {g_want}")
    report_served(cfg, gather, "serve-audio")
    vs_gather = near_ties(gather["warm"], cuda["warm"], plen, "serve-audio",
                          f"{cfg.name} cuda vs gather")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    oneshot = {}, {}
    for r in reqs:
        toks, tops = static_tops(params, cfg, r.prompt, AUDIO_NEW, r.frames)
        oneshot[0][r.rid] = toks
        oneshot[1].update({(r.rid, p): v for p, v in tops.items()})
    counts = {k: c for k, c in ops.launch_counts().items() if c}
    print(f"[serve-audio] {cfg.name}: the one-shot path (encode + prefill "
          f"+ decode_step) on each request in {time.perf_counter() - t0:.1f}"
          f"s, launches {counts}")
    vs_oneshot = near_ties(oneshot, cuda["warm"], plen, "serve-audio",
                           f"{cfg.name} engine vs one-shot")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[serve-audio] {cfg.name}: peak device memory {peak:.2f} GiB")
    return {"launches": cuda["counts"], "routes": cuda["routes"],
            "ticks": ticks, "narrow": narrow, "admissions": admits,
            "held": cuda["held"], "vs_gather": vs_gather,
            "vs_oneshot": vs_oneshot, "enc_bytes": enc_bytes,
            "pool_bytes": pool.nbytes(), "stage": stage,
            "tick_p50_ms": cuda["summary"]["tick_latency_p50_s"] * 1e3,
            "gather_tick_p50_ms":
                gather["summary"]["tick_latency_p50_s"] * 1e3,
            "drain_s": cuda["seconds"], "peak_gib": peak}


# ---------------------------------------------------------------------------
# Phase 20: the static path of the frontends and the last dense configs,
# then training of both frontends

# (arch, layers kept (None: whole), --wbits, prompt tokens (a vlm's
# patches included), new tokens, rows)
FRONT_STATIC = [("whisper-tiny", None, 0, 64, 32, 4),
                ("internvl2-1b", None, 8, 512, 32, 4),
                ("chatglm3-6b", None, 0, 128, 32, 2),
                ("command-r-plus-104b", 2, 0, 128, 8, 2),
                ("llama3-405b", 2, 0, 128, 8, 2)]
# (arch, batch, seq): 10 steps each; whisper's 448 tokens are its
# decoder's context, internvl2's 1024 follow its 256 patches. Each
# trains on the token stream's first batch, repeated, where a working
# step must lower the loss: on the stream itself whisper-tiny's loss did
# not fall in 10 steps (H100), nor does the reference's at the published
# vocab (tests/test_torch_lm_training.py::
# test_frontend_steps_on_the_stream_at_the_published_vocab): each step
# meets new (token, next token) pairs of a ring of V tokens.
FRONT_TRAIN = [("whisper-tiny", 4, 448), ("internvl2-1b", 2, 1024)]
FRONT_GRAD_ARCHS = ("whisper-tiny-smoke", "internvl2-1b-smoke")


class FlashHold:
    """``attention.flash_attention`` (``ops.flash_attention`` as the model
    calls it) held call by call: the kernel as the main path launches it
    (counted; bucket ``flash_attention``), then, uncounted, the kernel
    again on fp32 copies of its inputs (``flash_attention fp32``); each
    held against its plain version at ``FLASH_TOL`` of its dtype (bf16
    on the tensor-core route, fp32 on the CUDA-core one). Keeps each
    call's shape and mask."""

    def __init__(self, real):
        self.real, self.rows, self.shapes = real, [], []

    def __call__(self, q, k, v, *, causal=True):
        out = self.real(q, k, v, causal=causal)
        self.shapes.append((tuple(q.shape), tuple(k.shape), causal))
        self.rows.append(("flash_attention",
                          flash_held(out, q, k, v, causal)))
        with uncounted():
            q32, k32, v32 = (a.float().contiguous() for a in (q, k, v))
            self.rows.append(("flash_attention fp32", flash_held(
                fa.flash_attention_cuda(q32, k32, v32, causal=causal), q32,
                k32, v32, causal)))
        return out

    def take(self) -> dict:
        """:func:`fold_held` of the calls, by bucket."""
        return fold_held(self.rows)


def front_static_one(arch, layers, wbits, prompt, new, rows, smi) -> dict:
    """One config through ``launch/serve.py``'s static path at full width
    (``layers``: cut to that many with ``dataclasses.replace``), seeded
    weights drawn on the card (``wbits``: packed as drawn, dequantized
    once to bf16): a run through the captured plans against one through
    eager plans (:func:`static_graph_vs_eager`: capture s, prefill ms,
    decode tok/s, launches: flash once per attention layer, encoder
    layers included, in the prefill, none in the decode; every launch on
    the tensor-core route), then one prefill, eagerly, with every flash
    call held against its plain version in bf16 and fp32
    (:class:`FlashHold`); peak memory."""
    full = get_config(arch)
    cfg = full if layers is None else replace(full, n_layers=layers)
    cut = ("no cut" if layers is None else
           f"cut to {layers} of {full.n_layers} layers with "
           f"dataclasses.replace")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, device="cuda", wbits=wbits)
    if wbits:
        params = serve.dequantize_tree(params, getattr(torch, cfg.dtype))
    torch.cuda.synchronize()
    gib = torch.cuda.memory_allocated() / 2**30
    packed = (f", int{wbits}-packed as drawn, dequantized once" if wbits
              else "")
    print(f"[static-front] {cfg.name} ({smi}): {cfg.n_layers} layers "
          f"({cut}), d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
          f"of {cfg.resolved_head_dim}, "
          f"{api.count_params_analytic(cfg) / 1e9:.3f} B params, "
          f"{cfg.dtype} weights ({gib:.2f} GiB{packed}) in "
          f"{time.perf_counter() - t0:.1f}s")
    args = types.SimpleNamespace(slots=rows, prompt_len=prompt, tokens=new,
                                 seed=0)
    r = static_graph_vs_eager(params, cfg, args, cfg.name, "static-front")
    routes = r["routes"]
    check_routes(routes, ("flash_attention",), f"{cfg.name} static")
    want = {"flash_attention": cfg.n_layers + cfg.n_enc_layers}
    if r["launches_prefill"] != want or r["launches_decode"]:
        raise AssertionError(f"{cfg.name}: launches prefill "
                             f"{r['launches_prefill']}, decode "
                             f"{r['launches_decode']}; want {want}, none")
    toks = r["tokens"]
    if toks.shape != (rows, new) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: tokens {tuple(toks.shape)}")
    n_dec = rows * (new - 1)
    row = {"layers": cfg.n_layers, "cut": cut, "weights_gib": gib,
           "capture_s": r["capture_s"], "prefill_ms": r["prefill_s"] * 1e3,
           "decode_tok_s": n_dec / r["decode_s"], "launches": want,
           "graph_vs_eager": r["kinds"], "ulps": r["ulps"],
           "static_peak_gib": r["peak_gib"]}
    del r
    # one prefill, eagerly, with every flash call held against its plain
    # version
    batch = api.make_smoke_batch(2, cfg, rows, prompt, device="cuda")
    hold = FlashHold(attn_mod.flash_attention)
    with mock.patch.object(attn_mod, "flash_attention", hold), \
            torch.no_grad():
        ops.reset_launch_counts()
        api.make_prefill_step(cfg)(params, batch)
        torch.cuda.synchronize()
        launched = {k: c for k, c in ops.launch_counts().items() if c}
    held = hold.take()
    masks = {"causal": sum(c for *_, c in hold.shapes),
             "not causal": sum(not c for *_, c in hold.shapes)}
    want_masks = {"causal": cfg.n_layers, "not causal": cfg.n_enc_layers}
    if launched != want or masks != want_masks or not held_ok(held) or \
            {n: h[0] for n, h in held.items()} != {
                "flash_attention": sum(want.values()),
                "flash_attention fp32": sum(want.values())}:
        raise AssertionError(f"{cfg.name}: flash held {held}, masks "
                             f"{masks}, launched {launched}")
    row.update(held=held, masks=masks,
               shapes=sorted({str(x) for x in hold.shapes}))
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[static-front] {cfg.name} ({smi}): graphed, capture "
          f"{row['capture_s']:.2f} s, prefill {rows}x{prompt} "
          f"{row['prefill_ms']:.2f} ms, decode {n_dec} tokens "
          f"{row['decode_tok_s']:.1f} tok/s; flash {want['flash_attention']}"
          f" a prefill ({masks}), 0 in the decode, tensor-core; held vs "
          f"plain: " + "; ".join(f"{dt}: {c} calls, max|err| {e:.3g}"
                                 for dt, (c, e, *_) in held.items())
          + f"; shapes {row['shapes']}; peak device memory "
          f"{row['peak_gib']:.2f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return row


def encoder_train_check(smi: str) -> dict:
    """whisper-tiny's training encoder at full width and frame count (2
    x 1500 frames; ``blockwise_attn``, not causal: query chunks of 500
    against KV chunks of 750) against the same encoder through the dense
    plain attention (``ref.flash_attention_gqa_ref``), on the card in
    fp32 with TF32 off: the output and the gradient of every encoder
    leaf (of the output's dot with a seeded tensor) within
    ``LM_GRAD_TOL`` of their largest magnitudes. No kernel launches."""
    cfg = replace(get_config(AUDIO_ARCH), dtype="float32")
    F_ = cfg.frontend_tokens
    chunks = (F_ // attn_mod._chunk(F_, 512), F_ // attn_mod._chunk(F_, 1024))
    params = encdec.init_encoder(torch.Generator(device="cuda").manual_seed(0),
                                 cfg, dtype=torch.float32)
    rs = np.random.RandomState(0)
    frames, w = (torch.from_numpy(rs.randn(2, F_, cfg.d_model)
                                  .astype(np.float32)).cuda()
                 for _ in range(2))
    leaves = tree_items(params)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        ops.reset_launch_counts()
        for train in (True, False):
            with mock.patch.object(attn_mod, "flash_attention",
                                   ref.flash_attention_gqa_ref):
                for _, leaf in leaves:
                    leaf.requires_grad_(True)
                y = encdec.encode(params, frames, cfg, train=train)
                g = torch.autograd.grad((y * w).sum(),
                                        [leaf for _, leaf in leaves])
            out.append((y.detach(), g))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
        for _, leaf in leaves:
            leaf.requires_grad_(False)
    launched = {k: c for k, c in ops.launch_counts().items() if c}
    (y, g), (y_d, g_d) = out
    y_err, y_max = float((y - y_d).abs().max()), float(y_d.abs().max())
    g_err = {path: float((a - b).abs().max())
             for (path, _), a, b in zip(leaves, g, g_d)}
    g_max = max(float(b.abs().max()) for b in g_d)
    worst = max(g_err, key=g_err.get)
    print(f"[static-front] {cfg.name} ({smi}): training encoder (2 x {F_} "
          f"frames, {chunks[0]} query chunks x {chunks[1]} KV chunks, not "
          f"causal, fp32) vs the dense plain attention: output max|err| "
          f"{y_err:.3e} (max|y| {y_max:.3e}); {len(g)} gradient leaves, "
          f"worst {g_err[worst]:.3e} at {worst} (max|g| {g_max:.3e}); "
          f"bound {LM_GRAD_TOL:g} of the largest")
    if launched or chunks != (3, 2) or y_err > LM_GRAD_TOL * y_max or \
            g_err[worst] > LM_GRAD_TOL * g_max or not all(
                torch.isfinite(a).all() for a in (y, *g)):
        raise AssertionError(f"training encoder vs dense: launched "
                             f"{launched}, chunks {chunks}, output "
                             f"{y_err} of {y_max}, grads {g_err}")
    return {"chunks": chunks, "out_err": y_err, "out_max": y_max,
            "grad_err": g_err[worst], "grad_max": g_max}


def phase_front_static_train(smi: str) -> dict:
    """Phase 20: the static path of whisper-tiny, internvl2-1b (``--wbits
    8`` dequantized to bf16), chatglm3-6b, and command-r-plus-104b and
    llama3-405b at published widths cut to 2 layers; then 10 training
    steps each of whisper-tiny and internvl2-1b (phase 15's loop and
    checks on one repeated batch: finite, falling loss, step p50, a
    traced step), their card-vs-CPU gradients at smoke and the training
    encoder at full width and frame count against the dense one."""
    out = {"static": {a: front_static_one(a, *rest, smi=smi)
                      for a, *rest in FRONT_STATIC}}
    out["train"] = {a: lm_train_one(a, None, b, s, 10, True, smi,
                                    repeat=True)
                    for a, b, s in FRONT_TRAIN}
    out["grads"] = {a: lm_grad_check(a, smi) for a in FRONT_GRAD_ARCHS}
    out["encoder"] = encoder_train_check(smi)
    return out


# ---------------------------------------------------------------------------
# The moe family on the static path, and the dry run

MOE_ARCH = "granite-moe-1b-a400m"
MOE_STATIC = [(MOE_ARCH, None), (DS_ARCH, DS_LAYERS)]
MOE_PROMPT = 512
# A moe-family prefill through the kernel vs the plain path: (max |d
# logit| of the last position, max |d| / max |ref| of every layer's
# handed-off cache). fp32 at 1e-4: only summation order differs. bf16
# (bound stated before the first run on the card, as QWEN_PREFILL): each
# flash call agrees with its plain version at one bf16 ulp (FlashHold),
# and that difference carries through 24 residual layers. A near-tie of
# two gates parted by it moves a token to other experts (the first card
# run, without a replay: bf16 logits 0.369 apart, K/V 0.238), so the
# plain pass replays the kernel pass's routing, as phase 5 replays a
# tick's
MOE_PREFILL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (0.25, 0.05)}
# decode_mla's contiguous rows: L (a multiple of 34, and a prime padded
# to 9 blocks of 64), C, the rows' dtype
MLA_CONTIG = [(L, c, dt) for L in (544, 541) for c in (1, 16)
              for dt in (torch.bfloat16, torch.float32)]
DRYRUN_CELLS = [("qwen1.5-4b", "decode_32k", False),
                (MOE_ARCH, "train_4k", False),
                (DS_ARCH, "prefill_32k", True)]
# each cell under the reference's schedule ("": the full masked grid)
# and the three attention variants
DRYRUN_VARIANTS = ("", "tri", "bf16attn", "qc1024")
DRYRUN_OUT = Path(__file__).resolve().parent / "results" / "dryrun_torch"
# the dry run's subprocesses share this many of the host's cores (its
# last) with one another, beside phases 17 to 21
DRYRUN_CORES = 2
ALLOC_BLOCK = 512             # the caching allocator's rounding (bytes)
# phase 23: rubicall-smoke data-parallel on the card's 1 x 1 NCCL mesh
# against the plain one-device loop, both from seed 0 on the same
# batches. On one rank every reduction is the identity and the two steps
# take the same formulas, so on the CPU they agree bit for bit
# (tests/test_torch_distributed.py). On the card CTC's backward adds
# with atomics, so two plain runs part too, slowly (H100 80GB HBM3,
# 700 W): in five runs of 20 steps the first three losses of the
# data-parallel run equaled the plain run's; in eight, the two parted
# by up to 1.89e-4 later on, and two plain runs by up to 1.53e-4.
# Step 1's loss, before any update, must be equal, steps 2 to DP_EARLY
# within DP_EARLY_RTOL relative (where a fault of the data-parallel step
# would show), and every step within DP_RTOL (the card's own spread).
DP_ARCH, DP_STEPS, DP_BATCH, DP_SEQ = "rubicall-smoke", 20, 8, 2048
DP_EARLY, DP_EARLY_RTOL, DP_RTOL = 3, 1e-6, 5e-4


def moe_static_one(arch, layers, smi) -> dict:
    """One moe-family config through ``launch/serve.py``'s static path
    (``--static --wbits 8``): ``run_static`` through the captured plans
    against eager plans (:func:`static_graph_vs_eager`), launches (flash
    once an attention layer of a ``moe`` block in the prefill, no kernel
    for MLA's prefill; in the decode none for ``moe`` blocks and, for
    MLA, ``scatter_rows`` for the latent rows, their rope keys and
    positions), then for a config that launches flash one eager prefill
    with every call held (:class:`FlashHold`), and the whole prefill
    through the kernel against the plain path (:data:`MOE_PREFILL`): in
    fp32 and bf16, or bf16 alone where the fp32 weights would not
    fit."""
    full = get_config(arch)
    cfg = full if layers is None else replace(full, n_layers=layers)
    cut = ("no cut" if layers is None else
           f"cut to {layers} of {full.n_layers} layers with "
           f"dataclasses.replace")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, device="cuda", wbits=8)
    params = serve.dequantize_tree(params, getattr(torch, cfg.dtype))
    torch.cuda.synchronize()
    gib = torch.cuda.memory_allocated() / 2**30
    kinds = [k for k, _ in tfm.layer_plan(cfg)]
    print(f"[static-moe] {cfg.name} ({smi}): {cfg.n_layers} layers {kinds} "
          f"({cut}), d {cfg.d_model}, {cfg.n_experts} experts top-"
          f"{cfg.experts_per_tok}, {cfg.dtype} weights ({gib:.2f} GiB, "
          f"int8-packed as drawn, dequantized once) in "
          f"{time.perf_counter() - t0:.1f}s")
    args = types.SimpleNamespace(slots=STATIC_SLOTS, prompt_len=MOE_PROMPT,
                                 tokens=STATIC_NEW, seed=0)
    r = static_graph_vs_eager(params, cfg, args, cfg.name, "static-moe")
    routes = r["routes"]
    check_routes(routes, ("flash_attention",), f"{cfg.name} static")
    want = {"flash_attention": n for k, n in tfm.layer_plan(cfg)
            if k == "moe"}
    # MLA writes its latent rows and positions through scatter_rows, three
    # launches a layer and decode step (the prefill fills them in place)
    mla_layers = sum(n for k, n in tfm.layer_plan(cfg)
                     if k in tfm.MLA_KINDS)
    want_decode = ({"scatter_rows": 3 * mla_layers * (STATIC_NEW - 1)}
                   if mla_layers else {})
    if r["launches_prefill"] != want or \
            r["launches_decode"] != want_decode:
        raise AssertionError(f"{cfg.name}: launches prefill "
                             f"{r['launches_prefill']}, decode "
                             f"{r['launches_decode']}; want {want}, "
                             f"{want_decode}")
    toks = r["tokens"]
    if toks.shape != (STATIC_SLOTS, STATIC_NEW) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: tokens {tuple(toks.shape)}")
    n_dec = STATIC_SLOTS * (STATIC_NEW - 1)
    row = {"layers": cfg.n_layers, "kinds": kinds, "cut": cut,
           "weights_gib": gib, "capture_s": r["capture_s"],
           "prefill_ms": r["prefill_s"] * 1e3,
           "decode_tok_s": n_dec / r["decode_s"], "launches": want,
           "launches_decode": want_decode,
           "routes": {k: routes[k] for k in (*want, *want_decode)},
           "graph_vs_eager": r["kinds"], "ulps": r["ulps"],
           "static_peak_gib": r["peak_gib"]}
    print(f"[static-moe] {cfg.name} ({smi}): graphed, capture "
          f"{row['capture_s']:.2f} s, prefill {STATIC_SLOTS}x"
          f"{MOE_PROMPT} {row['prefill_ms']:.2f} ms, decode {n_dec} tokens "
          f"{row['decode_tok_s']:.1f} tok/s; launches {want or 'none'} in "
          f"the prefill, {want_decode or 'none'} in {STATIC_NEW - 1} "
          f"decode steps")
    del r
    batch = api.make_smoke_batch(2, cfg, STATIC_SLOTS, MOE_PROMPT,
                                 device="cuda")
    if want:
        # one prefill, eagerly, with every flash call held
        hold = FlashHold(attn_mod.flash_attention)
        with mock.patch.object(attn_mod, "flash_attention", hold), \
                torch.no_grad():
            ops.reset_launch_counts()
            api.make_prefill_step(cfg)(params, batch)
            torch.cuda.synchronize()
            launched = {k: c for k, c in ops.launch_counts().items() if c}
        held = hold.take()
        n = want["flash_attention"]
        if launched != want or not held_ok(held) or {
                k: h[0] for k, h in held.items()} != {
                "flash_attention": n, "flash_attention fp32": n}:
            raise AssertionError(f"{cfg.name}: flash held {held}, "
                                 f"launched {launched}")
        row["held"] = held
        print(f"[static-moe] {cfg.name}: every flash call held vs plain: "
              + "; ".join(f"{dt}: {c} calls, max|err| {e:.3g}"
                          for dt, (c, e, *_) in held.items()))
    # fp32 where the weights' fp32 copy fits beside them (granite's 5
    # GiB, not deepseek's 59); with no kernel in the prefill the kernel
    # path is the plain one
    tokens = batch["tokens"]
    row["prefill_vs_plain"] = {}
    for dtype in ((torch.float32, torch.bfloat16) if want
                  else (torch.bfloat16,)):
        moved = []
        dl, ds, std = prefill_both_paths(params, cfg, tokens, (FLASH_SWAP,),
                                         dtype, ("flash_attention",), moved)
        row["prefill_vs_plain"][str(dtype)[6:]] = (dl, ds, *moved)
        print(f"[static-moe] {cfg.name}: prefill kernel vs plain, "
              f"{str(dtype)[6:]}: max|d logit| {dl:.4g} (logit std "
              f"{std:.3g}), handed-off cache max|d|/max|ref| {ds:.3g}; "
              f"routing replayed: {moved[0]} of {moved[1]} routed tokens "
              f"would have picked other experts")
        if dl > MOE_PREFILL[dtype][0] or ds > MOE_PREFILL[dtype][1]:
            raise AssertionError(f"{cfg.name} prefill ({dtype}): kernel "
                                 f"path disagrees with the plain path")
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[static-moe] {cfg.name} ({smi}): peak device memory "
          f"{row['peak_gib']:.2f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return row


def mla_contiguous_check(smi) -> dict:
    """``ops.decode_mla(table=None, backend="cuda")`` on the card against
    the same call on CPU copies (the kernels' plain versions walking the
    same arena view) at deepseek-v3's widths (B 4, H 128, kvr 512, rope
    64): rows stale past their fill, a hole, a decode row padded to C and
    a free row; live rows at ``ATTN_TOL``. One launch a call, on
    ``pa.mla_route``'s route (bf16: tensor-core, fp32: CUDA-core); the
    launches are counted here, apart from the main path's."""
    rs = np.random.RandomState(21)
    rows, counted = [], {"mla_paged": dict.fromkeys(pa.ROUTES, 0),
                         "mla_paged_chunk": dict.fromkeys(pa.ROUTES, 0)}
    with uncounted():
        for L, c, dt in MLA_CONTIG:
            B = 4
            cl = rs.randn(B, L, KVR).astype(np.float32)
            kr = rs.randn(B, L, ROPE).astype(np.float32)
            fills = (L - c, L // 2, 7, 0)
            pos = np.full((B, L), pa.EMPTY_POS, np.int32)
            t = np.zeros((B, c), np.int32)
            for b, f in enumerate(fills):
                pos[b, :f + c] = np.arange(f + c)
                t[b] = np.arange(f, f + c)
            pos[0, 3] = pa.EMPTY_POS                  # a hole
            t[2, 1:] = -1                             # decode row padded
            t[3] = -1                                 # a free row
            qa = rs.randn(B, c, DS_H, KVR).astype(np.float32)
            qr = rs.randn(B, c, DS_H, ROPE).astype(np.float32)
            cpu = [torch.from_numpy(a) for a in (qa, qr, cl, kr)]
            cpu = [a.to(dt) for a in cpu] + [torch.from_numpy(pos),
                                             torch.from_numpy(t)]
            kw = dict(scale=MLA_SCALE, table=None, backend="cuda")
            want = ops.decode_mla(*cpu, **kw)
            ops.reset_launch_counts()
            got = ops.decode_mla(*(a.cuda() for a in cpu), **kw)
            torch.cuda.synchronize()
            name = "mla_paged" if c == 1 else "mla_paged_chunk"
            route = dict(ops.launch_counts(routes=True)[name])
            bl = ops.mla_contiguous_block_len(L)
            want_route = pa.mla_route(dt, KVR, ROPE, bl, -(-L // bl) * bl)
            if route != {**dict.fromkeys(pa.ROUTES, 0), want_route: 1} or \
                    want_route != ("tensor_core" if dt == torch.bfloat16
                                   else "cuda_core"):
                raise AssertionError(f"decode_mla contiguous L {L} C {c} "
                                     f"{dt}: launches {route}")
            counted[name][want_route] += 1
            live = torch.from_numpy(t >= 0)[:, :, None, None].cuda()
            tol = ATTN_TOL[dt]
            h = held_row(got, want.cuda(), tol, tol, live).tolist()
            rows.append({"L": L, "C": c, "dtype": str(dt)[6:],
                         "block_len": bl, "route": want_route,
                         "max_abs_err": h[0], "excess": h[1],
                         "finite": h[2] == 1.0})
            if h[1] > 0 or h[2] != 1.0:
                raise AssertionError(f"decode_mla contiguous L {L} C {c} "
                                     f"{dt}: max|err| {h[0]}")
    print(f"[static-moe] decode_mla contiguous cuda route vs plain ({smi}): "
          + "; ".join(f"L {r['L']} (blocks of {r['block_len']}) C {r['C']} "
                      f"{r['dtype']} {r['route']} max|err| "
                      f"{r['max_abs_err']:.3g}" for r in rows))
    return {"rows": rows, "launches": counted,
            "max_abs_err": {n: max(r["max_abs_err"] for r in rows
                                   if (r["C"] == 1) == (n == "mla_paged"))
                            for n in counted}}


def dryrun_tag(arch: str, shape: str, multi: bool, variant: str) -> str:
    tag = f"{arch}__{shape}__{'pod2' if multi else 'pod1'}"
    return tag + (f"__{variant}" if variant else "")


def start_dryrun() -> list:
    """Every dry-run cell under every variant as a subprocess on the CPU
    (one thread each, at the lowest priority, all held to the host's
    last :data:`DRYRUN_CORES` cores, so the phases that run beside them
    keep the rest of the host), started together; phase 22 reads them."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    cores = sorted(os.sched_getaffinity(0))[-DRYRUN_CORES:]

    def confine():
        os.nice(19)
        os.sched_setaffinity(0, cores)
    procs = []
    for arch, shape, multi in DRYRUN_CELLS:
        for variant in DRYRUN_VARIANTS:
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--force",
                    "--save-hlo", "--variant", variant, "--results",
                    str(DRYRUN_OUT)] + (["--multi-pod"] if multi else [])
            procs.append(subprocess.Popen(
                argv, env=env, cwd=str(root), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, preexec_fn=confine))
    return procs


def reference_pairs(s: int, q_chunk: int = 512, kv_chunk: int = 1024
                    ) -> tuple:
    """The reference's blockwise attention block pairs at Sq = Sk = s:
    its full grid and ``_blockwise_tri``'s triangle (chunks the largest
    divisors of s not above 512 and 1024)."""
    def chunk(n, pref):
        c = min(n, pref)
        while n % c:
            c -= 1
        return c
    qc, kc = chunk(s, q_chunk), chunk(s, kv_chunk)
    grid = (s // qc) * (s // kc)
    tri = sum(1 for i in range(s // qc) for j in range(s // kc)
              if j * kc <= i * qc + qc - 1)
    return grid, tri


def phase_static_moe(smi: str) -> dict:
    """Phase 21: the moe family's static path and decode_mla's contiguous
    route."""
    out = {a: moe_static_one(a, layers, smi) for a, layers in MOE_STATIC}
    out["mla_contiguous"] = mla_contiguous_check(smi)
    return out


def host_param_bytes(cfg, mesh) -> tuple:
    """The dry run's per-device parameter bytes of ``cfg`` on ``mesh``
    (fake parameters, nothing allocated), each leaf rounded up to the
    caching allocator's block."""
    from repro_torch.compat import FakeTensorMode
    from repro_torch.parallel import sharding as shd
    with FakeTensorMode():
        p = api.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
        sh = shd.param_shardings(p, cfg, mesh)
        leaves = []
        shd.zip_map(lambda t, s: leaves.append(s.local_bytes(t)), p, sh)
    return sum(leaves), sum(-(-n // ALLOC_BLOCK) * ALLOC_BLOCK
                            for n in leaves)


def phase_dryrun(procs, smi: str) -> dict:
    """Phase 22: the dry-run cells' records, then the 1 x 1 host mesh of
    the card (a one-rank NCCL group): parameter bytes against the card's
    allocation, and a smoke tree resharded onto it bit for bit."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import sharding as shd
    from repro_torch.training import elastic
    out = {"cells": {}, "grid_to_tri": {}}
    runs = [(cell, v) for cell in DRYRUN_CELLS for v in DRYRUN_VARIANTS]
    for ((arch, shape, multi), variant), proc in zip(runs, procs):
        log, _ = proc.communicate(timeout=900)
        tag = dryrun_tag(arch, shape, multi, variant)
        if proc.returncode != 0:
            raise AssertionError(f"dry run {tag} exited {proc.returncode}:"
                                 f"\n{log[-3000:]}")
        rec = json.loads((DRYRUN_OUT / f"{tag}.json").read_text())
        mem = rec["memory_analysis"]
        r = rec["roofline"]
        if rec["cuda_initialized"] or rec["compile_s"] is not None or \
                mem["temp_size_in_bytes"] is not None or \
                not rec["hlo"]["flops"] > 0:
            raise AssertionError(f"dry run {tag}: {rec}")
        out["cells"][tag] = {
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "bottleneck": r["bottleneck"],
            "argument_bytes_per_device": mem["argument_size_in_bytes"],
            "bytes_per_device": rec["bytes_per_device"],
            "counted_s": rec["lower_s"], "layer_cuts": rec["layer_cuts"]}
        print(f"[dryrun] {tag} ({rec['n_chips']} stand-in chips, counted on "
              f"the CPU in {rec['lower_s']}s over cuts "
              f"{rec['layer_cuts']}): compute {r['compute_s'] * 1e3:.3f} ms,"
              f" memory {r['memory_s'] * 1e3:.3f} ms, collective "
              f"{r['collective_s'] * 1e3:.3f} ms <- {r['bottleneck']}; "
              f"arguments {mem['argument_size_in_bytes']} B/device, "
              f"{rec['bytes_per_device']} B/device in all; CUDA never "
              f"initialised")
    # the schedules side by side: every bmm of a cell (the attention's
    # and, in a moe layer, the dispatch einsums') under "" and tri; the
    # attention's own ratio is the CPU test's gate (test_torch_dryrun.py)
    from repro_torch.config import SHAPES
    for arch, shape, multi in DRYRUN_CELLS:
        if SHAPES[shape].kind == "decode":
            continue                      # no blockwise pass in a decode
        tables = [json.loads((DRYRUN_OUT / f"{dryrun_tag(arch, shape, multi, v)}"
                              f".ops.json").read_text())["bmm"]
                  for v in ("", "tri")]
        grid, tri = reference_pairs(SHAPES[shape].seq_len)
        ratio = tables[0]["flops"] / tables[1]["flops"]
        out["grid_to_tri"][f"{arch}__{shape}"] = {
            "bmm_flops": [tables[0]["flops"], tables[1]["flops"]],
            "ratio": ratio, "reference_pairs": [grid, tri]}
        print(f"[dryrun] {arch} x {shape}: bmm flops under the full grid / "
              f"the triangle = {tables[0]['flops']:.6g} / "
              f"{tables[1]['flops']:.6g} = {ratio:.4f} (the reference's "
              f"attention block pairs {grid} / {tri} = {grid / tri:.4f})")
        if not 1 < ratio <= grid / tri:
            raise AssertionError(f"{arch} x {shape}: grid/tri {ratio}, "
                                 f"reference pairs {grid}/{tri}")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
        world_size=1)
    try:
        host = mesh_mod.make_host_mesh(1)
        if tuple(host.shape) != (1, 1) or host.device_type != "cuda":
            raise AssertionError(f"host mesh {host}")
        out["host_mesh"] = {}
        for arch in ("qwen1.5-4b-smoke", "deepseek-v3-671b-smoke"):
            cfg = get_config(arch)
            exact, rounded = host_param_bytes(cfg, host)
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            params = api.init_params(0, cfg, device="cuda")
            torch.cuda.synchronize()
            allocated = torch.cuda.memory_allocated() - before
            own = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
            out["host_mesh"][arch] = {"dry_run_bytes": exact,
                                      "dry_run_blocks": rounded,
                                      "leaf_bytes": own,
                                      "allocated": allocated}
            print(f"[dryrun] {arch} on the 1x1 host mesh ({smi}): dry run "
                  f"{exact} B of parameters ({rounded} B in 512-byte "
                  f"blocks); init_params on the card: leaves {own} B, "
                  f"memory_allocated +{allocated} B")
            if exact != own or rounded != allocated:
                raise AssertionError(f"{arch}: dry run {exact}/{rounded}, "
                                     f"card {own}/{allocated}")
            del params
        cfg = get_config("qwen1.5-4b-smoke")
        tree = api.init_params(0, cfg, device="cpu")
        moved = elastic.reshard(tree, shd.param_shardings(tree, cfg, host))
        same = all(torch.equal(m.to_local().cpu(), t) and
                   m.to_local().is_cuda for t, m in
                   zip(tree_leaves(tree), tree_leaves(moved)))
        if not same:
            raise AssertionError("reshard onto the card's mesh changed bits")
        out["reshard_leaves"] = len(tree_leaves(tree))
        print(f"[dryrun] elastic.reshard: {out['reshard_leaves']} leaves of "
              f"qwen1.5-4b-smoke onto the card's 1x1 NCCL mesh, bit for bit")
    finally:
        dist.destroy_process_group()
    return out


def phase_dp_train(smi: str) -> dict:
    """Phase 23: ``train_loop.run(mesh=make_host_mesh(1))`` on a one-rank
    NCCL group over a file store (no socket): rubicall-smoke trained
    data-parallel on the card against the plain one-device run on the
    same batches; the step's wall ms of each (the loop reads each
    logged step's loss back, so a step's wall time is its device time
    and its host time)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import data_for
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import AdamWConfig
    cfg = get_config(DP_ARCH)

    def one(mesh, ckpt_dir):
        return train_loop.run(
            cfg, AdamWConfig(lr=2e-3, total_steps=DP_STEPS),
            train_loop.TrainLoopConfig(steps=DP_STEPS, log_every=1,
                                       ckpt_every=DP_STEPS // 2,
                                       ckpt_dir=ckpt_dir),
            data_for(cfg, DP_BATCH, DP_SEQ), mesh=mesh,
            device=None if mesh is not None else "cuda")

    def step_ms(run):
        wall = [r["wall_s"] for r in run["history"]]
        return (wall[-1] - wall[0]) / (len(wall) - 1) * 1e3

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            f"{tmp}/store", 1), rank=0, world_size=1)
        try:
            mesh = mesh_mod.make_host_mesh(1)
            if tuple(mesh.shape) != (1, 1) or mesh.device_type != "cuda":
                raise AssertionError(f"host mesh {mesh}")
            dp = one(mesh, f"{tmp}/dp")
        finally:
            dist.destroy_process_group()
        plain = one(None, f"{tmp}/plain")
        again = one(None, f"{tmp}/again")
        saved = sorted(x.name for x in Path(f"{tmp}/dp").iterdir())

    def rel_diff(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))
    dl = [r["loss"] for r in dp["history"]]
    pl = [r["loss"] for r in plain["history"]]
    rel = rel_diff(dl, pl)
    early = rel_diff(dl[1:DP_EARLY], pl[1:DP_EARLY])
    rel_again = rel_diff([r["loss"] for r in again["history"]], pl)
    out = {"arch": DP_ARCH, "steps": DP_STEPS,
           "batch": [DP_BATCH, DP_SEQ], "loss_dp": dl, "loss_plain": pl,
           "max_rel_loss_diff": rel, "max_rel_early": early,
           "max_rel_plain_rerun": rel_again,
           "checkpoints": saved,
           "step_ms_dp": step_ms(dp), "step_ms_plain": step_ms(plain)}
    print(f"[dp] {DP_ARCH} {DP_BATCH} x {DP_SEQ}, {DP_STEPS} steps on the "
          f"1x1 NCCL mesh vs one device ({smi}): losses "
          f"{dl[0]:.5f} -> {dl[-1]:.5f} vs {pl[0]:.5f} -> {pl[-1]:.5f}, "
          f"step 1 {'equal' if dl[0] == pl[0] else 'DIFFERS'}, steps 2-"
          f"{DP_EARLY} within {early:.3g} (bound {DP_EARLY_RTOL}), max "
          f"relative difference {rel:.3g} (bound {DP_RTOL}; the plain "
          f"run against itself {rel_again:.3g}); step "
          f"{out['step_ms_dp']:.2f} ms data-parallel, "
          f"{out['step_ms_plain']:.2f} ms plain; checkpoints {saved}")
    if (not all(np.isfinite(dl)) or dl[0] != pl[0]
            or early > DP_EARLY_RTOL or rel > DP_RTOL or len(saved) != 2):
        raise AssertionError(f"data-parallel run: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 24: the serving-invariant analyzer (python -m repro_torch.analysis)

ANALYSIS_KERNELS = ("gqa_paged", "gqa_paged_chunk", "mla_paged",
                    "mla_paged_chunk", "qmatmul", "scatter_rows")


def analysis_expected(tgt) -> dict:
    """The launches a ``cuda`` smoke target of the analyzer makes on the
    card, ``{kernel: {route: n}}``, from the wrappers' own route rules:
    a serving tick one attention kernel a layer (none on ``gather``)
    and its writes (``scatter_rows``), an attention op or
    ``qmatmul[int8]`` one launch."""
    from repro_torch.analysis import targets as atg
    name = tgt.name
    dt = (torch.int8 if "int8" in name else
          torch.bfloat16 if "/bf16" in name else torch.float32)
    if tgt.kind == "qmatmul":
        return {"qmatmul": {qmm.route(torch.float32, 128): 1}}
    if name.startswith("decode_mla["):
        return {"mla_paged": {pa.mla_route(dt, 16, 8, 4, 16): 1}}
    if name.startswith("decode_gqa["):
        if "/chunk/" in name:
            return {"gqa_paged_chunk": {pa.chunk_route(dt, 4, 16): 1}}
        return {"gqa_paged": {pa.decode_route(dt, 16): 1}}
    cfg = get_config(name[len("step["):].split("/")[0])
    chunk = name.endswith("/mixed]")
    L, bl = atg.CACHE_LEN, atg.BLOCK_LEN
    writes = {"scatter_rows": {"cuda_core": scatter_per_tick(
        cfg, int8=dt == torch.int8)}}
    if tgt.backend != "cuda":
        return writes
    if cfg.mla_kv_lora_rank:
        return {**writes, ("mla_paged_chunk" if chunk else "mla_paged"): {
            pa.mla_route(dt, cfg.mla_kv_lora_rank, cfg.mla_qk_rope_dim, bl,
                         L): cfg.n_layers}}
    hd = cfg.resolved_head_dim
    route = (pa.chunk_route(dt, atg.CHUNK, hd) if chunk
             else pa.decode_route(dt, hd))
    return {**writes, ("gqa_paged_chunk" if chunk else "gqa_paged"):
            {route: cfg.n_layers}}


def phase_analysis(smi: str) -> dict:
    """Phase 24: ``python -m repro_torch.analysis``'s five rules as the
    CPU gate runs them, on the card: the smoke targets are recorded
    here, so the ``cuda`` ones launch the paged kernels and ``qmatmul``
    (each target's launches checked by kernel and route); every rule
    timed, any finding fails the phase."""
    from repro_torch.analysis.cli import run_rules
    from repro_torch.analysis.context import AnalysisContext
    from repro_torch.analysis.rules import all_rules
    ctx = AnalysisContext(device="cuda")
    t = time.perf_counter()
    targets = ctx.jaxpr_targets
    secs = {"record": time.perf_counter() - t}
    found = []
    for r in all_rules():
        t = time.perf_counter()
        got = run_rules(ctx, [r.id])
        secs[r.id] = time.perf_counter() - t
        found += got
        print(f"[analysis] {r.id} ({r.kind}): {len(got)} finding(s) in "
              f"{secs[r.id]:.2f}s ({smi})")
    for f in found:
        print(f"[analysis] {f}")
    launched = {}
    for tgt in targets:
        got = tgt.jaxpr.launches()
        want = (analysis_expected(tgt) if tgt.backend == "cuda"
                or tgt.kind == "qmatmul" or (tgt.kind == "serving-step"
                                             and tgt.backend == "gather")
                else {})
        if got != want:
            raise AssertionError(f"{tgt.name}: launched {got}, want {want}")
        for k, by in got.items():
            for route, n in by.items():
                launched.setdefault(k, {}).setdefault(route, 0)
                launched[k][route] += n
        if got:
            print(f"[analysis] {tgt.name}: {len(tgt.jaxpr.ops)} ops "
                  f"recorded, launches {got}")
    if set(launched) != set(ANALYSIS_KERNELS) or \
            set(launched["gqa_paged_chunk"]) != set(pa.ROUTES):
        raise AssertionError(f"analysis targets launched {launched}")
    print(f"[analysis] {len(targets)} targets recorded on the card in "
          f"{secs['record']:.2f}s; launches {launched}; "
          f"{len(found)} finding(s) ({smi})")
    if found:
        raise AssertionError(f"repro_torch.analysis on the card: "
                             f"{len(found)} finding(s)")
    return {"seconds": secs, "launches": launched,
            "targets": len(targets)}


def phase_analysis_full(served: dict, smi: str) -> dict:
    """Phase 24 at full width: no-materialization and trace-stability
    over phase 5's full-width qwen1.5-4b ``TokenRunner`` (int8 weights,
    bf16 arena, 4 slots, chunk 16, the ``cuda`` read path): one decode
    and one mixed tick recorded from its plans, then the load audit.
    Precision runs at smoke only, in fp32, as the reference's gate runs
    it (phase 24's smoke half): at full width the bf16 projections of
    either package are bf16 matmuls by design."""
    from repro_torch.analysis import targets as atg
    from repro_torch.analysis.rules import materialization
    from repro_torch.analysis.rules import trace_stability
    runner, cfg = served["runner"], served["cfg"]
    pool = runner.pool
    for slot in range(runner.n_slots):
        pool.release_slot(slot)
    t = time.perf_counter()
    recorded = atg.record_runner_steps(
        runner, f"{cfg.name}/{pool.attn_backend}", quantized=False)
    t_rec = time.perf_counter() - t
    found = [f for tgt in recorded for f in materialization.check_target(tgt)]
    floors = {}
    for g, leaf in cache_leaves(pool.caches):
        shape = tuple(leaf.shape[1:])
        floor = recorded[0].view_floor(shape)
        if floor is not None:
            floors["/".join(g)] = (shape, floor)
    per_tick = qmatmul_per_tick(cfg)
    for tgt in recorded:
        kernel = ("gqa_paged" if tgt.name.endswith("/decode]")
                  else "gqa_paged_chunk")
        want = {kernel: {"tensor_core": cfg.n_layers},
                "qmatmul": {"tensor_core": per_tick},
                "scatter_rows": {"cuda_core": scatter_per_tick(cfg)}}
        got = tgt.jaxpr.launches()
        print(f"[analysis] {tgt.name}: {len(tgt.jaxpr.ops)} ops recorded "
              f"(aten ops and kernel launches), launches {got} ({smi})")
        if got != want:
            raise AssertionError(f"{tgt.name}: launched {got}, want {want}")
    t = time.perf_counter()
    found += trace_stability.audit_token_runner(
        runner, *atg.canned_works(runner), cfg.name)
    t_audit = time.perf_counter() - t
    for slot in range(runner.n_slots):
        pool.release_slot(slot)
    print(f"[analysis] {cfg.name}: view floor by arena leaf "
          + ", ".join(f"{g} {shape}: {fl} elements"
                      for g, (shape, fl) in floors.items())
          + f"; no-materialization over both ticks (recorded in "
          f"{t_rec:.2f}s) and the load audit ({t_audit:.2f}s): "
          f"{len(found)} finding(s) ({smi})")
    for f in found:
        print(f"[analysis] {f}")
    if found or not floors:
        raise AssertionError(f"{cfg.name}: {len(found)} finding(s), view "
                             f"floors {floors}")
    return {"ops": {tgt.name: len(tgt.jaxpr.ops) for tgt in recorded},
            "floors": {g: fl for g, (_, fl) in floors.items()},
            "record_s": t_rec, "audit_s": t_audit}


# ---------------------------------------------------------------------------
# Phase 25: tensor-parallel training, two ranks sharing the card

# (arch, config fields cut, batch rows, sequence, checkpoint compared, a
# second one-process run for the card's own spread): the published
# widths, depth cut with dataclasses.replace. The MLA, SSM, hybrid and
# encoder-decoder runs (mamba2, hymba, whisper, deepseek) take no second
# one-process run, mamba2 a third of its depth and hymba one row, so the
# script stays near its limit (the whole script took 1057.9 s with them whole, phase
# 25 125.3 s of it, on an H100 80GB HBM3 at 700.00 W). deepseek-v3
# keeps one mla_moe layer and its mtp block (the mla_dense one), 8 of
# its 256 experts and an eighth of its vocabulary, the share of one of
# 32 and of 8 cards: whole, its vocabulary alone is 1.85 B parameters,
# and this loop's step holds about 44 bytes a parameter at its peak
# (fp32 masters, gradients, the clipped gradients and AdamW's m and v,
# old and new, and the bf16 weights the backward keeps), so one process
# could not train it on one card; with 16 experts the two ranks' peaks
# (34.3 and 41.0 GiB allocated, 0.994 B parameters a rank) overran the
# card's 79.2 GiB
TP_RUNS = [("qwen1.5-4b", dict(n_layers=2), 4, 1024, False, True),
           ("granite-moe-1b-a400m", dict(n_layers=4), 4, 1024, True, True),
           ("mamba2-130m", dict(n_layers=8), 4, 1024, True, False),
           ("hymba-1.5b", dict(n_layers=4), 1, 2048, False, False),
           ("whisper-tiny", {}, 4, 448, False, False),
           ("deepseek-v3-671b", dict(n_layers=1, n_dense_layers=0,
                                     n_experts=8, vocab_size=16160),
            1, 256, False, False)]
# the leaves (their names under a group) where a rank's bytes part from
# ``sharding.per_device_bytes``: the unit rule keeps whole what
# ``_filter_axes`` cuts by flat dims (hymba's 25/5 attention heads at 2,
# MLA's down-projections, mtp's projection to the replicated residual),
# splits by heads the SSM's per-head vectors the specs keep whole, and
# keeps B's and C's segments whole inside in_proj and the conv
_SSM_PARTS = {"ssm/in_proj/kernel", "ssm/conv_w", "ssm/conv_b", "ssm/A_log",
              "ssm/D", "ssm/dt_bias"}
TP_UNIT_PARTS = {
    "mamba2-130m": _SSM_PARTS,
    "hymba-1.5b": _SSM_PARTS | {f"attn/{w}/kernel"
                                for w in ("wq", "wk", "wv", "wo")},
    "deepseek-v3-671b": {"attn/wdq/kernel", "attn/wdkv/kernel",
                         "mtp/block/attn/wdq/kernel",
                         "mtp/block/attn/wdkv/kernel", "mtp/proj/kernel"},
}
TP_STEPS = 3
# bf16 compute: the row-parallel products are rounded per rank before
# their sum, so the runs part at bf16's precision, not fp32's
TP_RTOL_FIRST, TP_RTOL = 1e-3, 1e-2
# a weight's step-3 difference: where a gradient near 0 takes the other
# sign in one run, AdamW's update (|u| about 1 in its first steps) moves
# the weight the other way, by up to 2 lr a step; 2x that over 3 steps
TP_PARAM_ATOL = 2 * 2 * LM_LR * 3


def tp_cfg(arch: str, cut: dict):
    return replace(get_config(arch), **cut)


def tp_cut_text(arch: str, cut: dict) -> str:
    """How a run of :data:`TP_RUNS` is cut, in words."""
    full = get_config(arch)
    if not cut:
        return f"whole ({full.n_layers} layers)"
    return "cut to " + ", ".join(
        f"{k} {v} of {getattr(full, k)}" for k, v in cut.items())


def tp_leaf_name(path: str) -> str:
    """A leaf's name under its layer group (``groups/g0_ssm/`` off)."""
    return re.sub(r"^groups/g\d+_[a-z_]+/", "", path)


def tp_loop(ckpt_dir: str, ckpt: bool) -> TrainLoopConfig:
    return TrainLoopConfig(steps=TP_STEPS, log_every=1,
                           ckpt_every=TP_STEPS if ckpt else 10 ** 9,
                           ckpt_dir=ckpt_dir)


TP_OPT = AdamWConfig(lr=LM_LR, warmup_steps=1, total_steps=TP_STEPS)


def tp_step_ms(run) -> float:
    wall = [r["wall_s"] for r in run["history"]]
    return (wall[-1] - wall[0]) / (len(wall) - 1) * 1e3


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tp_rank_main(rank: int, store: str, out: str) -> int:
    """One of the two ranks of phase 25: a gloo group over a file store
    (no socket) whose ranks share card 0; each of :data:`TP_RUNS`
    trained through ``train_loop.run(mesh=make_host_mesh(2),
    device="cuda")``; this rank's figures as JSON under ``out``."""
    import torch.distributed as dist

    from repro_torch.compat import FakeTensorMode
    from repro_torch.core.quant.policy import tree_items
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor_parallel as tp
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    mesh = make_host_mesh(2)
    res = {}
    for arch, cut, batch, seq, ckpt, _ in TP_RUNS:
        cfg = tp_cfg(arch, cut)
        with FakeTensorMode():
            whole = api.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu", dtype=torch.float32)
        psh = shd.param_shardings(whole, cfg, mesh)
        want = shd.per_device_bytes(whole, psh)
        spec = []
        shd.zip_map(lambda t, sh: spec.append(sh.local_bytes(t)), whole, psh)
        dims = tp.split_dims(whole, cfg, 2)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tp.reset_counts()
        run = train_loop.run(cfg, TP_OPT, tp_loop(f"{out}/ckpt-{arch}", ckpt),
                             train_launcher.data_for(cfg, batch, seq),
                             device="cuda", mesh=mesh)
        carry = run["carry"]
        local = {k: t.numel() * t.element_size()
                 for k, t in tree_items(carry.params)}
        spec = dict(zip((k for k, _ in tree_items(whole)), spec))
        parted = {k for k in local if local[k] != spec[k]}
        # the step-3 checkpoint's gather: every split leaf of the params
        # and of AdamW's m and v, whole (a buffer of the whole leaf
        # summed over the group), once
        split = [w for w, d in zip(tree_leaves(whole), tree_leaves(dims))
                 if d is not None]
        gather = ((3 * len(split), 3 * sum(
            w.numel() * w.element_size() for w in split)) if ckpt
            else (0, 0))
        res[arch] = {
            "loss": [r["loss"] for r in run["history"]],
            "step_ms": tp_step_ms(run),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "param_bytes": tree_bytes(carry.params),
            "per_device_bytes": want,
            "unit_rule_parts": sorted({tp_leaf_name(k) for k in parted}),
            "parted_bytes": [sum(local[k] for k in parted),
                             sum(spec[k] for k in parted)],
            "opt_bytes": tree_bytes(carry.opt_state.m)
            + tree_bytes(carry.opt_state.v),
            "allreduce_calls_per_step":
                (tp.COUNTS["calls"] - gather[0]) / TP_STEPS,
            "allreduce_bytes_per_step":
                (tp.COUNTS["bytes"] - gather[1]) / TP_STEPS,
            "gather": gather}
        del run, carry
    dist.destroy_process_group()
    Path(f"{out}/rank{rank}.json").write_text(json.dumps(res))
    return 0


def checkpoint_diffs(got_dir: Path, want_dir: Path) -> dict:
    """Leaf by leaf, two checkpoints of one step: the same keys, shapes
    and dtypes, every leaf finite; max |difference| by leaf class
    (params, m, v, step)."""
    from repro_torch.training.checkpoint import CheckpointManager
    got, want = (CheckpointManager(str(d)).latest_valid()
                 for d in (got_dir, want_dir))
    if got is None or want is None or got[0] != want[0]:
        raise AssertionError(f"checkpoints {got} and {want}")
    mg, mw = (json.loads((c[1] / "manifest.json").read_text())["leaves"]
              for c in (got, want))
    if set(mg) != set(mw):
        raise AssertionError(f"checkpoint keys differ: "
                             f"{sorted(set(mg) ^ set(mw))[:8]}")
    diffs = {}
    for k in mw:
        if (mg[k]["shape"], mg[k]["dtype"]) != (mw[k]["shape"],
                                                mw[k]["dtype"]):
            raise AssertionError(f"{k}: {mg[k]} against {mw[k]}")
        a = np.load(got[1] / mg[k]["file"])
        b = np.load(want[1] / mw[k]["file"])
        if not np.isfinite(a).all():
            raise AssertionError(f"{k}: not finite")
        cls = k.split("/")[0] if k.startswith(".params") else \
            k.split("/")[1] if "/" in k else k
        d = float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0
        diffs[cls] = max(diffs.get(cls, 0.0), d)
    return {"step": got[0], "leaves": len(mw), "max_abs_diff": diffs}


def phase_tp_train(smi: str) -> dict:
    """Phase 25: tensor-parallel training at full width. Two processes
    share the one H100 through a gloo group over a file store (NCCL
    refuses two ranks on one card); each trains :data:`TP_RUNS` on the
    ``(1, 2)`` host mesh through ``train_loop.run`` (``tp_rank_main``).
    Held against the one-process bf16 run on the card from the same seed
    and batches, a second one-process run's spread beside it: step 1's
    loss within ``TP_RTOL_FIRST`` relative, steps 2-3 within
    ``TP_RTOL``; each rank's parameter bytes equal to
    ``sharding.per_device_bytes`` on the mesh; rank 0's step-3
    checkpoint of whole leaves against the one-process checkpoint, leaf
    by leaf. Printed: the all-reduces a step (the helper's counter),
    each rank's peak memory and parameter and AdamW bytes (the leaves
    where the unit rule and ``_filter_axes`` part named,
    :data:`TP_UNIT_PARTS`), step ms."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        plain = {}
        for arch, cut, batch, seq, ckpt, rerun in TP_RUNS:
            cfg = tp_cfg(arch, cut)
            runs = []
            for i in range(2 if rerun else 1):
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                run = train_loop.run(
                    cfg, TP_OPT, tp_loop(f"{tmp}/plain{i}-{arch}",
                                         ckpt and i == 0),
                    train_launcher.data_for(cfg, batch, seq),
                    device="cuda")
                runs.append({
                    "loss": [r["loss"] for r in run["history"]],
                    "step_ms": tp_step_ms(run),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "param_bytes": tree_bytes(run["carry"].params),
                    "opt_bytes": tree_bytes(run["carry"].opt_state.m)
                    + tree_bytes(run["carry"].opt_state.v)})
                del run
            plain[arch] = runs
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--tp-rank",
             str(r), f"{tmp}/store", tmp]) for r in range(2)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        t_ranks = time.perf_counter() - t
        if rcs != [0, 0]:
            raise AssertionError(f"tensor-parallel ranks exited {rcs}")
        ranks = [json.loads(Path(f"{tmp}/rank{r}.json").read_text())
                 for r in range(2)]
        ckpts = {arch: checkpoint_diffs(Path(f"{tmp}/ckpt-{arch}"),
                                        Path(f"{tmp}/plain0-{arch}"))
                 for arch, _, _, _, ckpt, _ in TP_RUNS if ckpt}

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]
    ok = True
    for arch, cut, batch, seq, ckpt, rerun in TP_RUNS:
        p0, p1 = (plain[arch] + [None])[:2]
        r0, r1 = ranks[0][arch], ranks[1][arch]
        d = rel(r0["loss"], p0["loss"])
        spread = rel(p1["loss"], p0["loss"]) if p1 else [None]
        parts = TP_UNIT_PARTS.get(arch, set())
        row = {"cut": cut, "batch": [batch, seq], "plain": p0,
               "plain_again": p1, "ranks": [r0, r1],
               "max_rel_first": d[0], "max_rel": max(d),
               "plain_spread": max(spread) if p1 else None,
               "checkpoint": ckpts.get(arch)}
        out[arch] = row
        print(f"[tp] {arch} {tp_cut_text(arch, cut)}, {batch} x {seq} tokens, "
              f"{TP_STEPS} steps on a (1, 2) "
              f"gloo mesh, two ranks sharing cuda:0 ({smi}): losses "
              f"{', '.join(f'{v:.5f}' for v in r0['loss'])} against one "
              f"process {', '.join(f'{v:.5f}' for v in p0['loss'])}: step 1 "
              f"within {d[0]:.3g} (bound {TP_RTOL_FIRST}), steps 2-3 "
              f"{max(d[1:]):.3g} (bound {TP_RTOL}); "
              + (f"a second one-process run parts by {max(spread):.3g}"
                 if p1 else "no second one-process run")
              + f"; rank losses "
              f"{'equal' if r0['loss'] == r1['loss'] else 'DIFFER'}")
        print(f"[tp] {arch}: {r0['allreduce_calls_per_step']:.0f} "
              f"all-reduces a step, {r0['allreduce_bytes_per_step'] / 2**20:.2f}"
              f" MiB; params {r0['param_bytes'] / 2**30:.3f} GiB a rank "
              f"(per_device_bytes {r0['per_device_bytes'] / 2**30:.3f}) against"
              f" {p0['param_bytes'] / 2**30:.3f} GiB in one process, AdamW "
              f"m+v {r0['opt_bytes'] / 2**30:.3f} against "
              f"{p0['opt_bytes'] / 2**30:.3f} GiB; peak "
              f"{r0['peak_gib']:.2f} / {r1['peak_gib']:.2f} GiB a rank "
              f"against {p0['peak_gib']:.2f} GiB; step {r0['step_ms']:.1f} / "
              f"{r1['step_ms']:.1f} ms a rank against {p0['step_ms']:.1f} ms "
              + (f"(again {p1['step_ms']:.1f} ms) " if p1 else "")
              + f"({smi})")
        if r0["unit_rule_parts"]:
            print(f"[tp] {arch}: the unit rule and _filter_axes part on "
                  f"{', '.join(r0['unit_rule_parts'])}: "
                  f"{r0['parted_bytes'][0] / 2**20:.2f} MiB a rank against "
                  f"per_device_bytes' {r0['parted_bytes'][1] / 2**20:.2f} "
                  f"MiB; every other leaf equal ({smi})")
        if ckpt:
            print(f"[tp] {arch}: rank 0's step-{ckpts[arch]['step']} "
                  f"checkpoint, {ckpts[arch]['leaves']} whole leaves against "
                  f"the one-process one: max |difference| "
                  + ", ".join(f"{k} {v:.3g}" for k, v in
                              ckpts[arch]["max_abs_diff"].items())
                  + f" (params bound {TP_PARAM_ATOL:g})")
        ok &= (np.isfinite(r0["loss"]).all() and r0["loss"] == r1["loss"]
               and d[0] <= TP_RTOL_FIRST and max(d) <= TP_RTOL
               and all(set(r["unit_rule_parts"]) == parts
                       and r["param_bytes"] == r["per_device_bytes"]
                       - r["parted_bytes"][1] + r["parted_bytes"][0]
                       for r in (r0, r1))
               and (not ckpt or ckpts[arch]["max_abs_diff"][".params"]
                    <= TP_PARAM_ATOL))
    print(f"[tp] both ranks in {t_ranks:.1f}s, start-up included")
    if not ok:
        raise AssertionError(f"tensor-parallel run: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 26: the tick plans as CUDA graphs (serving/plan.py) against eager
# plans, and the tick's fixed-shape writes (scatter_rows) against their
# plain version

GRAPH_LM = [(LM_ARCH, 6, 16), (HYMBA_ARCH, 2, 8)]   # (arch, requests, new)
# qwen1.5-4b's served paths that phases 16-19 drive only through eager
# plans (they watch Python wrappers), drained here with graph plans too:
# (label, engine keywords)
VARIANT_TRAFFIC = (4, 8)   # (requests, new): the variants' and granite's
GRAPH_VARIANTS = [("int8 arena", {"quant_policy": "int8"}),
                  ("fp8 arena", {"quant_policy": "fp8"}),
                  ("gather backend", {"attn_backend": "gather"})]
# the main path's scatter_rows shapes: (label, arena row shape, dtype);
# qwen1.5-4b's K/V, int8 bytes and scales, deepseek's latent and rope
# key, hymba's and whisper-tiny's K/V, every group's positions
SCATTER_ROWS = [("qwen K/V bf16", (20, HD), torch.bfloat16),
                ("qwen K/V fp8", (20, HD), torch.float8_e4m3fn),
                ("qwen K/V int8", (20, HD), torch.int8),
                ("qwen int8 scales", (20,), torch.float32),
                ("qwen K/V fp16", (20, HD), torch.float16),
                ("deepseek latent bf16", (512,), torch.bfloat16),
                ("deepseek rope key bf16", (64,), torch.bfloat16),
                ("hymba K/V bf16", (5, 64), torch.bfloat16),
                ("whisper K/V bf16", (6, 64), torch.bfloat16),
                ("positions int32", (), torch.int32)]
SCATTER_BLOCKS = LM_SLOTS * LM_CACHE // BLOCK     # qwen's arena blocks


def scatter_per_tick(cfg, int8: bool = False) -> int:
    """scatter_rows launches of one served tick: per layer with a KV
    cache its K and V (an MLA layer's latent and rope key) and its
    positions, and over an int8 arena the two scale leaves."""
    per = 5 if int8 else 3
    return per * sum(n for _, kind, n in tfm.group_names(cfg)
                     if kind != "ssm")


@contextlib.contextmanager
def eager_plans():
    """Every runner built inside keeps eager plans (``graphs=False``): a
    phase that swaps or watches a kernel wrapper, or hooks the step, in
    Python would see nothing of a graph's replay."""
    with contextlib.ExitStack() as stack:
        for cls in (runner_mod.BasecallerRunner, runner_mod.TokenRunner):
            stack.enter_context(mock.patch.object(
                cls, "__init__",
                functools.partialmethod(cls.__init__, graphs=False)))
        yield


def check_plan_stats(runner, cfg, summary) -> dict:
    """A served runner's plans: every one warmed, no retrace, and one
    CUDA graph each when the runner captures; no runner, a MoE one
    included, keeps its plans eager for a reason of its own."""
    st = runner.plan_stats()
    want = st["plans"] if runner.plans.graphed else 0
    if summary["retraces"] or st["warmed"] != st["plans"] or \
            st["graphs"] != want or "eager_reason" in st:
        raise AssertionError(f"{cfg.name}: plans {st}, retraces "
                             f"{summary['retraces']}")
    print(f"[graphs] {cfg.name}: {st['plans']} plans, {st['graphs']} CUDA "
          f"graphs, retraces={summary['retraces']:.0f}")
    return st


def scatter_inputs(rs, n: int, row: tuple, dtype):
    """``n`` writes into an arena of ``SCATTER_BLOCKS`` blocks of
    ``BLOCK`` rows of shape ``row`` (int32: a position table (4, 256)),
    at distinct rows, as a tick's are, every fourth carrying the
    sentinel (a pad token or an unassigned block); on the card."""
    if dtype == torch.int32:
        n0, n1 = LM_SLOTS, LM_CACHE
        dst = torch.from_numpy(rs.randint(-9, 9, (n0, n1)).astype(np.int32))
        src = torch.from_numpy(rs.randint(0, 999, n).astype(np.int32))
    else:
        n0, n1 = SCATTER_BLOCKS, BLOCK

        def draw(shape):
            if dtype == torch.int8:
                return torch.from_numpy(rs.randint(-127, 128, shape).astype(
                    np.int8))
            return torch.from_numpy(rs.randn(*shape).astype(
                np.float32)).to(dtype)
        dst, src = draw((n0, n1, *row)), draw((n, *row))
    flat = rs.permutation(n0 * n1)[:n]
    i0, i1 = flat // n1, flat % n1
    if dtype == torch.int32:
        i1[::4] = n1                  # a pad token's position column
    else:
        i0[::4] = n0                  # a pad token or an unassigned block
    return (dst.cuda(), torch.from_numpy(i0.astype(np.int64)).cuda(),
            torch.from_numpy(i1.astype(np.int64)).cuda(), src.cuda())


def synced_ms(calls, reps: int = 3) -> float:
    """Median time of one call of ``calls``, each of which waits for the
    device (the plain scatter reads its filter back): CUDA events around
    the calls, host time included, no sleep ahead of them."""
    for fn in calls[:2]:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for fn in calls:
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(calls))
    return statistics.median(times)


def scatter_check() -> dict:
    """scatter_rows at the main path's shapes (a decode tick's 4 writes
    and a mixed tick's 64, every fourth dropped) against its plain
    version, byte for byte; then the time of one qwen1.5-4b decode
    tick's 120 launches (40 layers' K, V and positions) for the kernel
    and the plain version, and their byte bound."""
    rs = np.random.RandomState(26)
    rows = {}
    with uncounted():
        for label, row, dtype in SCATTER_ROWS:
            for n in (LM_SLOTS, LM_SLOTS * LM_CHUNK):
                dst, i0, i1, src = scatter_inputs(rs, n, row, dtype)
                want = dst.clone()
                ref.scatter_rows_ref(want, i0, i1, src)
                before = dict(sr.scatter_rows_cuda.routes)
                ops.scatter_rows(dst, i0, i1, src)
                if sr.scatter_rows_cuda.routes != {
                        **before, "cuda_core": before["cuda_core"] + 1}:
                    raise AssertionError(f"scatter_rows {label}: routes "
                                         f"{sr.scatter_rows_cuda.routes}")
                bad = int((pa._bytes_view(dst) != pa._bytes_view(want))
                          .sum())
                print(f"[kernel] scatter_rows {label} n={n}: bytes that "
                      f"differ from the plain version {bad}")
                if bad:
                    raise AssertionError(f"scatter_rows {label} n={n}: "
                                         f"{bad} bytes differ")
                rows[f"{label} n={n}"] = bad
        # one decode tick's launches, each over its own layer's arena
        kv = [scatter_inputs(rs, LM_SLOTS, (20, HD), torch.bfloat16)
              for _ in range(2 * PLAIN_COPIES)]
        posi = [scatter_inputs(rs, LM_SLOTS, (), torch.int32)
                for _ in range(PLAIN_COPIES)]
        k_ms = device_ms([functools.partial(ops.scatter_rows, *a)
                          for a in kv])
        p_ms = device_ms([functools.partial(ops.scatter_rows, *a)
                          for a in posi])
        k_pl = synced_ms([functools.partial(ref.scatter_rows_ref, *a)
                          for a in kv])
        p_pl = synced_ms([functools.partial(ref.scatter_rows_ref, *a)
                          for a in posi])
    L = get_config(LM_ARCH).n_layers
    landed = LM_SLOTS - len(range(0, LM_SLOTS, 4))
    nbytes = L * (2 * landed * 2 * (20 * HD * 2) + landed * 2 * 4
                  + 3 * LM_SLOTS * 16)
    bound, by = bound_ms(nbytes, 0, torch.bfloat16)
    out = {"ms": L * (2 * k_ms + p_ms), "plain_ms": L * (2 * k_pl + p_pl),
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "max_abs_err": 0.0, "per_call_ms": {
               "K/V bf16 (4, 20, 128)": k_ms, "positions int32": p_ms},
           "differing_bytes": rows}
    print(f"[kernel] scatter_rows, one qwen1.5-4b decode tick ({3 * L} "
          f"launches, 4 writes each, one in four dropped): kernel "
          f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, bound "
          f"{bound:.5f} ms ({by}); per call K/V {k_ms * 1e3:.2f} us, "
          f"positions {p_ms * 1e3:.2f} us")
    return out


def graph_drains(make_engine, reqs_fn, cfg, where: str) -> dict:
    """One drain of the same traffic through an engine with graph plans
    and through one with eager plans, each warmed up (``require_warm``
    set) and counted from 0: the same tokens (bases) and statuses, the
    same launches by route, no retrace, one graph a plan and none, and
    every graph's own kernel nodes equal to its capture's tally
    (:func:`graph_census`)."""
    runs = {}
    for mode in ("graph", "eager"):
        torch.cuda.reset_peak_memory_stats()
        with kept_graphs():
            eng = make_engine(graphs=mode == "graph")
            t0 = time.perf_counter()
            eng.warmup()
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
        peak_warm = torch.cuda.max_memory_allocated()
        census = (graph_census(eng.runner.plans, where) if mode == "graph"
                  else {})
        eng.runner.plans.require_warm = True
        reqs = reqs_fn()
        ops.reset_launch_counts()
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        st = eng.metrics.summary()
        plans = check_plan_stats(eng.runner, cfg, st)
        runs[mode] = {
            "engine": eng, "routes": ops.launch_counts(routes=True),
            "tokens": {rid: (r.status, list(map(int, r.out_tokens)))
                       for rid, r in eng.completed.items()},
            "summary": st, "plans": plans, "warmup_s": warm,
            "drain_s": secs, "peak_gib": (peak_warm / 2**30, peak / 2**30),
            "census": census}
        print(f"[graphs] {where}, {mode} plans: warmup {warm:.2f}s, drain "
              f"{secs:.2f}s, {st['requests_done']} requests, tick p50 "
              f"{st['tick_latency_p50_s'] * 1e3:.2f} ms p99 "
              f"{st['tick_latency_p99_s'] * 1e3:.2f} ms, ejections "
              f"{st['ejections']:.0f}; peak device memory "
              f"{peak_warm / 2**30:.2f} GiB after warmup, "
              f"{peak / 2**30:.2f} GiB after the drain")
    g, e = runs["graph"], runs["eager"]
    if g["tokens"] != e["tokens"] or len(g["tokens"]) != len(reqs) or \
            g["summary"]["ejections"] != e["summary"]["ejections"]:
        raise AssertionError(f"{where}: graph plans served {g['tokens']}, "
                             f"eager {e['tokens']}")
    if g["routes"] != e["routes"]:
        raise AssertionError(f"{where}: launches by route, graph "
                             f"{g['routes']}, eager {e['routes']}")
    if g["plans"]["graphs"] != g["plans"]["plans"] or e["plans"]["graphs"]:
        raise AssertionError(f"{where}: graphs {g['plans']} / "
                             f"{e['plans']}")
    print(f"[graphs] {where}: graph and eager plans served the same "
          f"{'bases' if cfg.family == 'basecaller' else 'tokens'} and "
          f"statuses; launches by route equal "
          f"{ {k: v for k, v in g['routes'].items() if sum(v.values())} }")
    return runs


def bitwise(where: str, got, want, rerun) -> dict:
    """Graph output against eager, bit for bit, or within the eager
    rerun's own spread."""
    d = float((got.float() - want.float()).abs().max())
    spread = float((rerun.float() - want.float()).abs().max())
    equal = bool(torch.equal(got, want))
    print(f"[graphs] {where}: graph vs eager max|d| {d:.3g} (bit for bit "
          f"{equal}), eager rerun spread {spread:.3g}")
    if not bool(torch.isfinite(got.float()).all()) or \
            not (equal or d <= spread):
        raise AssertionError(f"{where}: graph differs from eager by {d} "
                             f"(eager rerun {spread})")
    return {"max_abs_diff": d, "bitwise": equal, "rerun_spread": spread}


def rubicall_graphs(ru) -> dict:
    """RUBICALL through the engine at B = 4 with read-until (phase 13's
    classifier, in the same plan): graph against eager plans, some reads
    ejected."""
    cfg, params = rubicall_served()

    def make(graphs):
        return api.make_serving_engine(params, cfg, device="cuda",
                                       n_slots=B, chunk_samples=1024,
                                       read_until=ru, graphs=graphs)

    def reads():
        """8 reads of 400-800 bases (4-7 windows: the classifier decides
        after 2), every other one swapped for white noise of its length
        (an off-target read, as phase 13's), so some are ejected."""
        rs = np.random.RandomState(5)
        out = serve.build_reads(types.SimpleNamespace(
            requests=8, rate=1.0, read_bases=800))
        return [r if r.rid % 2 == 0 else Request(
            rid=r.rid, signal=normalize(rs.randn(len(r.signal)).astype(
                np.float32))) for r in out]
    runs = graph_drains(make, reads, cfg, "rubicall (read-until)")
    if not runs["graph"]["summary"]["ejections"]:
        raise AssertionError("rubicall (read-until): no read ejected, so "
                             "the ejections compared nothing")
    gr, er = (runs[m]["engine"].runner for m in ("graph", "eager"))
    works = [types.SimpleNamespace(final=False, payload=gr.make_chunks(r)[0]
                                   .payload) for r in reads()[:B]]
    ops.reset_launch_counts()
    lp_g, cls_g = gr.dispatch(works)[1]
    r_g = ops.launch_counts(routes=True)
    ops.reset_launch_counts()
    lp_e, cls_e = er.dispatch(works)[1]
    r_e = ops.launch_counts(routes=True)
    lp_r, cls_r = er.dispatch(works)[1]
    if r_g != r_e:
        raise AssertionError(f"rubicall tick: routes {r_g} / {r_e}")
    out = {"log_probs": bitwise("rubicall tick log-probs", lp_g, lp_e, lp_r),
           "logits": bitwise("rubicall tick classifier logits", cls_g, cls_e,
                             cls_r)}
    for mode, rn in (("graph", gr), ("eager", er)):
        out[f"trace_{mode}"] = trace(
            f"one read-until tick (rubicall, B={B}), {mode} plan",
            lambda: rn.dispatch(works)[1],
            fetch=lambda o: runner_mod.readback(*o),
            profiled=mode == "graph")
    same_kernels("rubicall read-until tick",
                 runs["graph"]["census"][gr._plan_key], out["trace_eager"])
    out["drains"] = {m: graph_figures(r) for m, r in runs.items()}
    return out


def same_kernels(where: str, nodes: dict, eager: dict) -> None:
    """A plan's graph holds, by source, as many of the port's kernels as
    the same tick launched eagerly (``eager``: a trace's counts)."""
    want = {s: c for s, (c, _) in eager["own_launches"].items() if c}
    if nodes != want:
        raise AssertionError(f"{where}: the graph holds {nodes} of the "
                             f"port's kernels, the eager tick launched "
                             f"{want}")
    print(f"[graphs] {where}: the graph's kernel nodes equal the eager "
          f"tick's launches {nodes}")


def graph_figures(run: dict) -> dict:
    st = run["summary"]
    return {"tick_p50_ms": st["tick_latency_p50_s"] * 1e3,
            "tick_p99_ms": st["tick_latency_p99_s"] * 1e3,
            "warmup_s": run["warmup_s"], "drain_s": run["drain_s"],
            "plans": run["plans"]["plans"], "graphs": run["plans"]["graphs"],
            "retraces": st["retraces"], "peak_gib": run["peak_gib"],
            "launches": {k: v for k, v in run["routes"].items()
                         if sum(v.values())}}


def fill_slots(runner, fn, tok) -> None:
    """Rows 0-3 of ``runner``'s pool hold positions 0-47, written in
    three chunk ticks of 16 (eagerly, through ``fn``)."""
    pool = runner.pool
    for slot in range(runner.n_slots):
        pool.release_slot(slot)
    for slot in range(runner.n_slots):
        assert pool.alloc(slot, 64)
    for c0 in (0, 16, 32):
        t = torch.arange(c0, c0 + 16, dtype=torch.int32).repeat(LM_SLOTS, 1)
        fn(tok[:, c0:c0 + 16], t, torch.full((LM_SLOTS,), 15,
                                             dtype=torch.int32),
           torch.full((LM_SLOTS,), int(c0 == 0), dtype=torch.int32),
           pool.host_tables())


def logits_fn(runner):
    """A tick program returning the live logits (fp32) over the runner's
    pool, as the runner's own plans run it."""
    pool, cfg = runner.pool, runner.cfg

    def fn(tok, t, last, fresh, tables):
        with torch.inference_mode():
            if fresh is not None:
                pool.mask_fresh_rows(pool.caches, fresh)
            logits, _ = tfm.decode_step_slots(
                runner.params, pool.caches, tok, t, cfg, logits_at=last,
                tables=tables, attn_backend=runner.attn_backend,
                layers=runner.layers, enc_kv=runner.enc_kv)
            return logits[:, 0].float()
    return fn


def lm_graphs(cfg, params, reqs_fn, where: str, **kw) -> dict:
    """``cfg`` through the engine with graph and with eager plans; then a
    mixed and a decode tick over the same pool state, captured as a CUDA
    graph and run eagerly, logits bit for bit; each plan kind traced
    (the eager plans without the profiler: their kernels are the
    graph's)."""
    t0 = time.perf_counter()

    def make(graphs):
        return api.make_serving_engine(
            params, cfg, device="cuda", n_slots=LM_SLOTS,
            prefill_chunk=LM_CHUNK, block_len=BLOCK,
            cache_dtype=torch.bfloat16, graphs=graphs, **kw)
    runs = graph_drains(make, reqs_fn, cfg, where)
    gr, er = (runs[m]["engine"].runner for m in ("graph", "eager"))
    tok = torch.from_numpy(np.random.RandomState(1).randint(
        1, cfg.vocab_size, (LM_SLOTS, 64)).astype(np.int32))
    fn = logits_fn(gr)
    fill_slots(gr, fn, tok)
    fill_slots(er, logits_fn(er), tok)
    leaves = [leaf for _, leaf in cache_leaves(gr.pool.caches)]
    snap = [leaf.clone() for leaf in leaves]

    def restore():
        for leaf, saved in zip(leaves, snap):
            leaf.copy_(saved)
    t_mixed = torch.full((LM_SLOTS, LM_CHUNK), -1, dtype=torch.int32)
    t_mixed[0:2] = torch.arange(48, 64, dtype=torch.int32)
    t_mixed[2, 0] = 48                     # a decode row; row 3 is a pad
    zeros = torch.zeros((LM_SLOTS,), dtype=torch.int32)
    ticks = {
        "mixed": (tok[:, 48:64], t_mixed,
                  torch.tensor([15, 15, 0, 0], dtype=torch.int32)),
        "decode": (tok[:, 48:49],
                   torch.full((LM_SLOTS, 1), 48, dtype=torch.int32), None)}
    plans = PlanCache("cuda")
    out = {"drains": {m: graph_figures(r) for m, r in runs.items()}}
    for kind, (tk, t, last) in ticks.items():
        plans.register(("logits", t.shape[1], kind), fn)
        restore()
        with kept_graphs():
            plans.warm(("logits", t.shape[1], kind), tk, t, last, None,
                       gr.pool.host_tables())
    graph_census(plans, f"{where} logits ticks")
    for kind, (tk, t, last) in ticks.items():
        key = ("logits", t.shape[1], kind)
        args = (tk, t, last, None, gr.pool.host_tables())
        restore()
        ops.reset_launch_counts()
        got = plans.lookup(key)(*args)
        r_g = ops.launch_counts(routes=True)
        restore()
        ops.reset_launch_counts()
        want = fn(*args)
        r_e = ops.launch_counts(routes=True)
        restore()
        rerun = fn(*args)
        if r_g != r_e:
            raise AssertionError(f"{where} {kind} tick: routes {r_g} / "
                                 f"{r_e}")
        live = [0, 1, 2] if kind == "mixed" else list(range(LM_SLOTS))
        out[kind] = bitwise(f"{where} {kind} tick logits", got[live],
                            want[live], rerun[live])
    restore()
    for kind, (tk, t, last) in ticks.items():
        key = (kind, t.shape[1], "greedy")
        args = (tk, t, zeros, zeros if kind == "mixed" else None, last)
        for mode, rn in (("graph", gr), ("eager", er)):
            tick = rn.plans.lookup(key)
            out[f"trace_{kind}_{mode}"] = trace(
                f"one {kind} tick ({cfg.name}, B={LM_SLOTS}, C="
                f"{t.shape[1]}), {mode} plan",
                lambda: tick(*args, rn.pool.host_tables(), None),
                profiled=mode == "graph")
        same_kernels(f"{where} {kind} tick", runs["graph"]["census"][key],
                     out[f"trace_{kind}_eager"])
    for rn in (gr, er):
        for slot in range(rn.n_slots):
            rn.pool.release_slot(slot)
    print(f"[graphs] {where}: {time.perf_counter() - t0:.1f}s in all")
    return out


def variant_graphs(cfg, params, reqs_fn, where: str, **kw) -> dict:
    """``cfg`` served with engine keywords ``kw`` (an int8 or fp8 arena,
    the gather backend; none for granite-moe): one drain with graph
    plans against one with eager plans, then one all-pad decode tick of
    each traced (the eager one without the profiler), the graph's kernel
    nodes against the eager tick's launches."""
    t0 = time.perf_counter()

    def make(graphs):
        return api.make_serving_engine(
            params, cfg, device="cuda", n_slots=LM_SLOTS, cache_len=LM_CACHE,
            prefill_chunk=LM_CHUNK, block_len=BLOCK,
            cache_dtype=torch.bfloat16, graphs=graphs, **kw)
    runs = graph_drains(make, reqs_fn, cfg, where)
    out = {"drains": {m: graph_figures(r) for m, r in runs.items()}}
    pad = (torch.zeros((LM_SLOTS, 1), dtype=torch.int32),
           torch.full((LM_SLOTS, 1), -1, dtype=torch.int32),
           torch.zeros((LM_SLOTS,), dtype=torch.int32), None, None)
    for mode, run in runs.items():
        rn = run["engine"].runner
        tick = rn.plans.lookup(("decode", 1, "greedy"))
        out[f"trace_decode_{mode}"] = trace(
            f"one all-pad decode tick ({where}), {mode} plan",
            lambda: tick(*pad, rn.pool.host_tables(), None),
            profiled=mode == "graph")
    same_kernels(f"{where} decode tick",
                 runs["graph"]["census"][("decode", 1, "greedy")],
                 out["trace_decode_eager"])
    print(f"[graphs] {where}: {time.perf_counter() - t0:.1f}s in all")
    return out


def phase_graphs(ru, smi: str) -> dict:
    """Phase 26: scatter_rows against its plain version; then RUBICALL
    with read-until, qwen1.5-4b (also over an int8 and an fp8 arena and
    on the gather backend), hymba-1.5b, granite-moe-1b-a400m,
    mamba2-130m and whisper-tiny through the engine with graph plans and
    with eager plans."""
    out = {"scatter_rows": scatter_check()}
    out["rubicall"] = rubicall_graphs(ru)
    for arch, n, new in GRAPH_LM:
        cfg = replace(get_config(arch), quant=QuantPolicy(8, 0))
        gc.collect()
        torch.cuda.empty_cache()
        params = api.init_params(0, cfg, device="cuda", wbits=8)

        def reqs(cfg=cfg, n=n, new=new):
            return [Request(rid=r.rid, prompt=r.prompt, sampling=replace(
                r.sampling, max_new_tokens=new))
                for r in lm_requests(cfg)[:n]]
        out[arch] = lm_graphs(cfg, params, reqs, cfg.name,
                              cache_len=LM_CACHE)
        for label, kw in (GRAPH_VARIANTS if arch == LM_ARCH else ()):
            gc.collect()
            torch.cuda.empty_cache()
            out[f"{arch} {label}"] = variant_graphs(
                cfg, params, functools.partial(reqs, n=VARIANT_TRAFFIC[0],
                                               new=VARIANT_TRAFFIC[1]),
                f"{cfg.name} {label}", **kw)
        del params
    # the GQA + MoE runner, its routing on the device (phase 9 holds a
    # MoE tick's logits, graph against eager, for deepseek's)
    cfg = replace(get_config(MOE_ARCH), quant=QuantPolicy(8, 0))
    gc.collect()
    torch.cuda.empty_cache()
    params = api.init_params(0, cfg, device="cuda", wbits=8)
    out[MOE_ARCH] = variant_graphs(cfg, params, lambda: [
        Request(rid=r.rid, prompt=r.prompt, sampling=replace(
            r.sampling, max_new_tokens=VARIANT_TRAFFIC[1]))
        for r in lm_requests(cfg)[:VARIANT_TRAFFIC[0]]], cfg.name)
    del params
    # the SSM-only runner (no block table, no writes) on the first 4 of
    # phase 18's short requests (all 8 until the static phases grew
    # their eager comparisons)
    cfg = replace(get_config(SSM_ARCH), quant=QuantPolicy(8, 0))
    gc.collect()
    torch.cuda.empty_cache()
    params = api.init_params(0, cfg, device="cuda", wbits=8)
    out[SSM_ARCH] = lm_graphs(
        cfg, params, lambda: engine_requests(cfg, long=False)[:4],
        cfg.name, cache_len=HYMBA_CACHE)
    del params
    cfg = replace(get_config(AUDIO_ARCH), quant=QuantPolicy(8, 0))
    params = api.init_params(0, cfg, device="cuda", wbits=8)
    out[AUDIO_ARCH] = lm_graphs(cfg, params, lambda: audio_requests(cfg),
                                cfg.name, cache_len=AUDIO_CACHE)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[graphs] every plan of the basecaller, token and encoder-prefix "
          f"runners captured and replayed, the same tokens, bases and "
          f"ejections as eager plans ({smi})")
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# the phases cut to fit the time limit, and their seconds at the depth
# they ran before their last cut (on an H100 80GB HBM3 at 700.00 W: the
# first six in a run whose build phase took 74.1 s; serve (hybrid) and
# serve (ssm), cut again, in a run whose build took 91.6 s: 16 new
# tokens a request, drains of 4 requests for qwen's arena and backend
# variants, traces of device activity alone and eager plans' traces
# without the profiler; graphs, cut again to 4 requests in mamba2-130m's
# drains and 2 in hymba-1.5b's, in a run whose build took 84.4 s)
BEFORE_CUT_S = {"kernel (LM)": 30.2, "kernel (MLA)": 84.8, "train": 92.8,
                "lm_train": 134.3, "rubicon": 104.5,
                "serve (hybrid)": 230.4, "serve (ssm)": 61.4,
                "graphs": 96.4}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    laps = {}

    def lap(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        laps[name] = time.perf_counter() - t
        print(f"[chip_smoke] phase {name}: {laps[name]:.1f}s"
              + (f" (at the previous depth: {BEFORE_CUT_S[name]}s)"
                 if name in BEFORE_CUT_S else ""))
        return out
    lap("build", phase_build)
    kern = lap("kernel", phase_kernel)
    served = lap("serve", phase_serve)
    lm_kern = lap("kernel (LM)", phase_lm_kernel)
    mla_kern = lap("kernel (MLA)", phase_mla_kernel)
    qwen = replace(get_config(LM_ARCH), quant=QuantPolicy(8, 0))
    lm = lap("serve (LM)", phase_lm_serve, qwen,
             ("gqa_paged", "gqa_paged_chunk"), (LM_TICK_BF16, LM_TICK_FP32),
             ("gqa_paged", "gqa_paged_chunk", "qmatmul"))
    lap("trace (LM)", phase_lm_trace, lm)
    lap("analysis (qwen1.5-4b)", phase_analysis_full, lm, smi)
    lm_launches, lm_per_tick = lm["launches"], lm["per_tick"]
    lm_routes = lm["routes"]
    lm.clear()                             # free qwen's engine and weights
    gc.collect()
    torch.cuda.empty_cache()
    ds_cfg = replace(get_config(DS_ARCH), n_layers=DS_LAYERS,
                     quant=QuantPolicy(8, 0))
    ds = lap("serve (MLA)", phase_lm_serve, ds_cfg,
             ("mla_paged", "mla_paged_chunk"), (DS_TICK_BF16, DS_TICK_FP32),
             ("qmatmul", "mla_paged", "mla_paged_chunk"))
    ds_launches, ds_routes = ds["launches"], ds["routes"]
    ds_params = ds["runner"].params
    ds.clear()                             # free deepseek's engine
    gc.collect()
    torch.cuda.empty_cache()
    ds_graphs = lap("graphs (MLA)", lm_graphs, ds_cfg, ds_params,
                    lambda: lm_requests(ds_cfg),
                    f"{DS_ARCH} ({DS_LAYERS} layers)", cache_len=LM_CACHE)
    del ds_params                          # and its weights
    gc.collect()
    torch.cuda.empty_cache()
    pre = lap("kernel (prefill)", phase_prefill_kernel)
    ssm_run = lap("static (mamba2)", phase_static, get_config(SSM_ARCH),
                  SSM_PROMPT, (SSD_SWAP,), SSM_PREFILL, 0, ("ssd_scan",),
                  ("ssd_",))
    qwen_run = lap("static (qwen1.5-4b)", phase_static, get_config(LM_ARCH),
                   QWEN_PROMPT, (FLASH_SWAP,), QWEN_PREFILL, 8,
                   ("flash_attention",), ("flash_",))
    stream = lap("stream", phase_stream)
    trained = lap("train", phase_train)
    lap("lm_train", phase_lm_train, smi)
    rub = lap("rubicon", phase_rubicon)
    knob_routes = rub["launches"]
    # the dry run counts on the CPU (~200 s for deepseek's 32k prefill
    # under the full grid): it runs, at the lowest priority, beside
    # phases 17 to 21, which keep the card busy
    dry_procs = start_dryrun()
    try:
        hyb = lap("serve (hybrid)", phase_hybrid_serve)
        ssm_eng = lap("serve (ssm)", phase_ssm_serve)
        aud = lap("serve (audio)", phase_audio_serve)
        graphs = lap("graphs", phase_graphs, stream.pop("ru"), smi)
        front = lap("static+train (frontends)", phase_front_static_train,
                    smi)
        moe_static = lap("static (moe)", phase_static_moe, smi)
        lap("dry run", phase_dryrun, dry_procs, smi)
        lap("train (data-parallel)", phase_dp_train, smi)
        lap("analysis", phase_analysis, smi)
        lap("train (tensor-parallel)", phase_tp_train, smi)
    finally:
        for proc in dry_procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    front_flash = {a: r["launches"]["flash_attention"]
                   for a, r in front["static"].items()}
    blocks_k = [get_config("rubicall").kernel_sizes[i] for i in KERNEL_BLOCKS]

    def forward_sum(pk):
        """One forward's 19 launches summed, per timed quantity."""
        out = {key: sum(pk[k][key] for k in blocks_k)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        out["bound_by"] = pk[max(blocks_k)]["bound_by"]
        return out
    routes = {r: {**forward_sum(pk),
                  "per_k": {str(k): v for k, v in pk.items()}}
              for r, pk in kern["per_route"].items()}
    kernels = [{
        "name": "qconv1d_block", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/qconv1d.cu",
        "replaces": "src/repro/kernels/qconv1d.py:38",
        "launches": served["launches"], "max_abs_err": kern["err_main"],
        "launches_by_phase": {"serve": served["launches"],
                              "stream": stream["launches"],
                              "train": {
                                  "rubicall": trained["rubicall"]["identity"][
                                      "launches"],
                                  "rubicall-smoke": trained["smoke"][
                                      "launches"]}},
        "train": trained,
        "stream": {k: stream[k] for k in ("accuracy", "latency", "exact",
                                          "read_until", "classifier",
                                          "forced")},
        **forward_sum(kern["per_route"]["tensor_core"]),
        "shape": f"sum over one forward's {len(blocks_k)} launches, bf16 "
                 f"(qconv1d_tc_kernel) B={B} T={T_MAIN} C={C} k={blocks_k}",
        "launches_by_route": served["routes"],
        "routes": {"tensor_core": {"kernel": "qconv1d_tc_kernel", "x": "bf16",
                                   **routes["tensor_core"]},
                   "cuda_core": {"kernel": "qconv1d_block_kernel",
                                 "x": "fp32", **routes["cuda_core"]}},
    }]
    qt = lm_kern["timing"]["qmatmul"]
    plan = qwen_qmatmul_plan()
    if sum(plan.values()) != lm_per_tick:
        raise AssertionError(f"qmatmul timing covers {plan}, the served "
                             f"tick launches {lm_per_tick}")
    decode = qmatmul_tick(qt, LM_SLOTS)
    mixed = qmatmul_tick(qt, LM_SLOTS * LM_CHUNK)
    kernels.append({
        "name": "qmatmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/qmatmul.cu",
        "replaces": "src/repro/kernels/qmatmul.py:57",
        "launches": lm_launches["qmatmul"] + ds_launches["qmatmul"]
        + sum(knob_routes["qmatmul"].values()) + hyb["launches"]["qmatmul"]
        + ssm_eng["launches"]["qmatmul"] + aud["launches"]["qmatmul"],
        "max_abs_err": lm_kern["err"]["qmatmul"],
        **{key: decode[key] for key in ("ms", "plain_ms", "bound_ms",
                                        "library_ms")},
        "bound_by": "bytes",
        "shape": f"sum over one qwen1.5-4b decode tick's "
                 f"{sum(plan.values())} launches, int8 weights, bf16 x, "
                 f"M={LM_SLOTS} (qmatmul_tc_kernel); launches: both LM "
                 f"phases",
        "mixed_tick": {**mixed, "M": LM_SLOTS * LM_CHUNK},
        "launches_by_phase": {LM_ARCH: lm_launches["qmatmul"],
                              DS_ARCH: ds_launches["qmatmul"],
                              "rubicon": knob_routes["qmatmul"],
                              HYMBA_ARCH: hyb["routes"]["qmatmul"],
                              SSM_ARCH + " (engine)":
                                  ssm_eng["routes"]["qmatmul"],
                              AUDIO_ARCH: aud["routes"]["qmatmul"]},
        "launches_by_route": {
            r: lm_routes["qmatmul"][r] + ds_routes["qmatmul"][r]
            + knob_routes["qmatmul"][r] + hyb["routes"]["qmatmul"][r]
            + ssm_eng["routes"]["qmatmul"][r] + aud["routes"]["qmatmul"][r]
            for r in qmm.ROUTES},
        "routes": {r: {"kernel": kern, "x": "bf16 (timed); served: "
                       + x, "decode_tick_ms": decode[r],
                       "mixed_tick_ms": mixed[r]}
                   for r, kern, x in (
                       ("tensor_core", "qmatmul_tc_kernel", "bf16"),
                       ("cuda_core", "qmatmul_kernel", "fp32"))},
        "per_shape": {f"M={m} K={k} N={n}": row
                      for (m, k, n), row in qt.items()}})
    attn = lm_kern["timing"]["attn"]
    for name, replaces in (("gqa_paged", 260), ("gqa_paged_chunk", 492)):
        row = attn[name]
        extra = {f"per_call_{n}_positions": attn[f"{name}@{n}"]
                 for n in (FULL_POSITIONS, LONG_POSITIONS)
                 if f"{name}@{n}" in attn}
        if f"{name}/cuda_core" in attn:
            extra["routes"] = {
                "tensor_core": {"arena": "bf16", **row},
                "cuda_core": {"arena": "fp32", **attn[f"{name}/cuda_core"]}}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": f"src/repro/kernels/paged_attention.py:{replaces}",
            "launches": lm_launches[name] + sum(knob_routes[name].values())
            + hyb["launches"][name] + aud["launches"][name],
            "max_abs_err": lm_kern["err"][name],
            **{key: (row[key] * qwen.n_layers if key.endswith("ms")
                     else row[key]) for key in row},
            "shape": f"sum over one tick's {qwen.n_layers} launches, bf16 "
                     f"arena, B={LM_SLOTS} Hkv=20 hd={HD} block_len={BLOCK}"
                     f", positions 0..159, C="
                     f"{1 if name == 'gqa_paged' else 16}",
            "launches_by_route": {r: lm_routes[name][r]
                                  + knob_routes[name][r]
                                  + hyb["routes"][name][r]
                                  + aud["routes"][name][r]
                                  for r in pa.ROUTES},
            "audio_held_vs_plain": {
                n: dict(zip(("calls", "max_abs_err", "max_excess",
                             "finite", "max_abs_want"), h))
                for n, h in aud["held"].items() if n.split()[0] == name},
            "launches_by_phase": {LM_ARCH: lm_routes[name],
                                  "rubicon": knob_routes[name],
                                  HYMBA_ARCH: hyb["routes"][name],
                                  SSM_ARCH + " (engine)":
                                      ssm_eng["routes"][name],
                                  AUDIO_ARCH + " (self + cross)":
                                      aud["routes"][name]},
            "per_call": row, **extra})
    for name, replaces in (("mla_paged", 372), ("mla_paged_chunk", 608)):
        row = mla_kern["timing"][(name, MLA_POSITIONS[0])]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mla_paged_attention.cu",
            "replaces": f"src/repro/kernels/paged_attention.py:{replaces}",
            "launches": ds_launches[name],
            "max_abs_err": mla_kern["err"][name],
            **{key: (row[key] * DS_LAYERS if key.endswith("ms")
                     else row[key]) for key in row if key not in pa.ROUTES},
            "shape": f"sum over one tick's {DS_LAYERS} launches, bf16 "
                     f"latent arena, B={LM_SLOTS} H={DS_H} kvr={KVR} "
                     f"rope={ROPE} block_len={BLOCK}, positions "
                     f"0..{MLA_POSITIONS[0] - 1}, C="
                     f"{1 if name == 'mla_paged' else 16}",
            "launches_by_route": ds_routes[name],
            # decode_mla's contiguous cuda route, held in phase 21 (check
            # launches, not the main path's: --static decodes on gather)
            "contiguous_route_checks": {
                "launches_by_route": moe_static["mla_contiguous"][
                    "launches"][name],
                "max_abs_err": moe_static["mla_contiguous"][
                    "max_abs_err"][name]},
            "per_call": row,
            **{f"per_call_{n}_positions": mla_kern["timing"][(name, n)]
               for n in (FULL_POSITIONS, MLA_POSITIONS[1])
               if (name, n) in mla_kern["timing"]},
            "routes": {r: {"kernel": k, "arena": "bf16 (timed); served: "
                           + a, "per_call_ms": row[r]}
                       for r, k, a in (
                           ("tensor_core", "mla_tc_kernel",
                            "bf16, fp16, fp8, int8"),
                           ("cuda_core", "mla_paged_kernel", "fp32"))}})
    hyb_static = hyb["static"]
    for name, src, replaces, run, arch in (
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:68", qwen_run, LM_ARCH),
            ("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:62",
             ssm_run, SSM_ARCH)):
        row = pre["timing"][name]
        n = run["launches"][name]
        flash = name == "flash_attention"
        new = ({f"{AUDIO_ARCH} admissions (engine)":
                aud["launches"][name],
                **{f"{a} static": c for a, c in front_flash.items()},
                f"{MOE_ARCH} static":
                    moe_static[MOE_ARCH]["launches"][name]}
               if flash else {})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": n + hyb_static["launches"][name]
            + sum(new.values()),
            "launches_by_phase": {f"{arch} static": n,
                                  f"{HYMBA_ARCH} static":
                                      hyb_static["launches"][name], **new},
            "max_abs_err": pre["err"][name],
            **{key: (row[key] * n if key.endswith("ms") and row[key]
                     is not None else row[key]) for key in row
               if key != "shape"},
            "shape": f"sum over one {arch} prefill's {n} launches, "
                     f"{row['shape']}",
            # phases 19, 20 and 21 assert their flash launches tensor-core
            "launches_by_route": {
                r: run["routes"][name][r] + hyb_static["routes"][name][r]
                + (sum(new.values()) if r == "tensor_core" else 0)
                for r in ("tensor_core", "cuda_core")},
            "per_call": row,
            "static": {k: v for k, v in run.items() if k != "trace"},
            "prefill_trace": run["trace"],
            "hymba_static": {k: v for k, v in hyb_static.items()
                             if k != "trace"},
            **({"p_terms_max_abs_err": pre["err"]["flash_p_terms"]}
               if name == "flash_attention" else {})})
    drains = [run["drains"][m]["launches"].get("scatter_rows", {})
              for arch, run in [*graphs.items(), (DS_ARCH, ds_graphs)]
              if arch != "scatter_rows" for m in ("graph", "eager")]
    sc_phases = {LM_ARCH: lm_routes, DS_ARCH: ds_routes,
                 "rubicon": knob_routes, HYMBA_ARCH: hyb["routes"],
                 SSM_ARCH + " (engine)": ssm_eng["routes"],
                 AUDIO_ARCH: aud["routes"]}
    sc_by_phase = {k: r["scatter_rows"] for k, r in sc_phases.items()}
    sc_by_phase[f"{DS_ARCH} static (decode)"] = moe_static[DS_ARCH][
        "routes"]["scatter_rows"]
    sc_by_phase["graphs (phases 9 and 26 drains)"] = {
        r: sum(d.get(r, 0) for d in drains) for r in sr.ROUTES}
    kernels.append({
        "name": "scatter_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scatter_rows.cu",
        "replaces": "none (port-only: the reference's mode=\"drop\" "
                    "scatter, src/repro/models/lm/attention.py:465, is "
                    "XLA's, inside its jitted step)",
        "launches": sum(sum(v.values()) for v in sc_by_phase.values()),
        **{k: graphs["scatter_rows"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "shape": f"sum over one {LM_ARCH} decode tick's "
                 f"{3 * get_config(LM_ARCH).n_layers} launches (K, V, "
                 f"positions a layer), {LM_SLOTS} writes each, one in four "
                 f"dropped; bf16 rows of 20 x {HD}",
        "launches_by_phase": sc_by_phase,
        "launches_by_route": {r: sum(v[r] for v in sc_by_phase.values())
                              for r in sr.ROUTES},
        "per_call_ms": graphs["scatter_rows"]["per_call_ms"]})
    print(f"[chip_smoke] all phases ok in {time.perf_counter() - t0:.1f}s "
          f"({', '.join(f'{k} {v:.0f}s' for k, v in laps.items())})")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
