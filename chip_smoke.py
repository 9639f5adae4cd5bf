#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed N]

Needs one CUDA device (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``; exits non-zero without them. Phases, each printed
as it runs, any failure ending the run:

1. build    — compile the CUDA sources of ``src/repro_torch/csrc`` (one
              nvcc per source, started together: ``flashbias_attn.cu``,
              which holds the static and the ragged attention kernels,
              ``flash_decode.cu``, which holds the contiguous and the
              paged decode kernels, and ``ssd_scan.cu``, the SSD chunk
              scan) and print ptxas's register / shared-memory report;
              count the HGMMA (wgmma) instructions of every kernel function
              of the attention and SSD libraries in their SASS
              (``cuobjdump -sass``): the run fails if a tensor-core body
              (``attn_fwd_tc``; ``ssd_states``, ``ssd_cb``,
              ``ssd_chunk_scan``) has none;
2. kernels  — each of the four attention kernels against its plain
              PyTorch version on the card, at the serving paths' shapes
              and off-path modes (N off the 64-row tile, head dims and
              ranks off 16), within the stated tolerances (length-0 rows
              of the ragged and the decode kernels exactly 0); every bf16
              call of kernels 1 and 2 takes the tensor-core body, every
              float32 call the CUDA-core one. The split-KV decode kernels
              also take lengths across their span boundaries
              (SPLIT_LENGTHS), and the cases that write the new token's
              row (the path shapes among them; paged, one with its write
              block the sentinel) must leave the caches bit-equal to the
              plain version's; the path shapes, called twice, must give
              bit-identical outputs; kernels 3 and 4 also at 12 and 16 q
              heads per kv head (KVH 8, D 128, the MG = 16 body) at
              SPLIT_LENGTHS;
3. serve    — GPT-2-ALiBi-1.5B at full width (N_LAYERS = 24 of its 48
              layers, d_model 1600,
              bf16, random weights from ``--seed``) through ``ServeEngine``
              on 4 slots x 2048 positions: 8 ragged requests (prompts
              64-512 tokens, 32 new tokens each, 6 greedy and 2 sampled),
              staggered as the launcher does. Every request must end OK
              with 32 tokens, and the kernels' launch counters must equal
              24 x prefill waves and 24 x decode steps, every prefill
              launch on the tensor-core body;
4. paged    — the same 8 requests through a paged engine (page size 16,
              lazy reservation) whose pool is sized from the mix so that
              it grows pages and preempts; every request OK with 32
              tokens, the paged decode kernel launched 24 x decode steps
              and the contiguous one never, every prefill launch on the
              tensor-core body, every page free at the end;
5. parity   — the first wave's prefill and 4 decode steps again, with the
              plain path (impl="torch") on the card, logits compared, on
              the contiguous cache and on a paged cache (whose kernel path
              is also held against the contiguous kernel path): the kernel
              path's decode calls write the new row themselves, the plain
              path's by gather / where / scatter; then decode steps of both
              kernel paths timed and traced with torch.profiler (device
              busy time, idle share, top kernels, and the indexing kernels'
              calls and time per step);
6. times    — each kernel at the path shapes checked against its plain
              version on the timed tensors, then kernel, plain-version and
              library device times per call (torch.profiler), the least
              time the card could take (bound), decode step times and
              end-to-end tokens/s;
              the decode kernels' calls write the new row, as on the serve
              path, and their bounds count its bytes (the library calls
              write none);
6a. chunked — the serve phase's 8 requests plus two long prompts
              (LONG_PROMPTS, arriving at steps 2 and 6 while the others
              decode) through chunked engines (CHUNK tokens per step, 4
              slots x 2048), contiguous and then paged (page size 16).
              Every request OK; each request's first-token logits within
              LOGIT_TOL of the whole-prompt engine's (the serve phase's,
              and for the long two a whole-prompt wave's); the decode
              kernel launched 24 x decode steps and the prefill kernel
              never; some engine step ran a chunk and a decode together;
              paged, every page free after the drain. Then the chunk step,
              the decode step and the 1900-token prompt's first-token time
              against the whole-prompt wave, on the host clock and as
              device busy;
6b. prefix  — PREFIX_REQUESTS requests sharing a PREFIX_LEN-token prefix
              (tails PREFIX_TAILS, 2 sampled) and one whose prompt is the
              prefix, through a paged chunked engine with the prefix cache
              and one without: the first 4 stepped until their prompts
              land (pages are indexed then), then the rest. Streams
              bit-equal; tokens matched > 0 and pages copied on write
              >= 1; after the drain every page free or held by the index
              alone (refcount 1);
6c. lm-dense — the serve phase's first wave (4 prompts right-padded to
              512) prefilled on its weights with bias_mode="dense" (the
              materialized float32 ALiBi bias, plain chunked attention)
              and with "flashbias": kernel 1 launched 48 times in the
              flashbias wave, each on the tensor-core body, and never in the
              dense one; first-token logits within LOGIT_TOL; both waves
              timed on the host clock and as device busy (the paper's Sec.
              4.2 A/B);
7. pair     — Pairformer-lite at full width (PAIR_LAYERS = 8 of its 16
              layers, d_single 384, d_pair 128, 4 heads x 96, bf16
              compute, random float32 weights from ``--seed``) through ``ServeEngine`` on 4 slots x
              384 residues in SVD mode: 8 complexes (n_res 96-384), 4-8
              refinement steps each, staggered. Every request must end OK
              with a finite (n_res, 384) result, the ragged kernel's counter
              must equal 8 x (admission waves + refinement steps), each
              launch on the tensor-core body, and the other kernels must
              not launch;
8. pair parity — the first wave's admission and 2 steps again with the
              plain path (impl="torch"): bf16 in SVD mode and in factor-MLP
              mode (MLPs from ``--seed``, hidden 256), every ragged kernel
              call held in situ against the plain version on its inputs,
              and the final single reps' gap at most PAIR_CONTROL_MULT times
              that of a float64-attention control; float32 in SVD mode
              within PAIR_TOL_F32; deliberate faults of the attention, each
              of which the bf16 check must reject; and one complex served
              alone through a 4-slot engine bit-equal to its batched
              result. A failed check here fails the run at its end, after
              phase 9 has measured;
9. pair times — the ragged kernel, its plain version and the library call
              per call at the path shape, a refinement step of 4 full slots
              in the three cache modes (factored SVD, dense_recompute,
              dense) in alternating rounds, one factored step traced, and
              the admission wave's time;
10. ssm kernel — the SSD chunk-scan kernel against its plain version on y
              and the final state: at the SSM path's shape (4 x 4096
              positions, 32 heads x 64, state 128, float32, one b/c group,
              through the model's strided layout), then S off the chunk,
              S shorter than a chunk, a nonzero h0, b/c per head, a dt
              that would overflow an unmasked exp, bf16 x, under
              ``ssd_tolerance``, each on the tensor-core body; and one
              shape off it (P 20, N 8, chunk 48) on the CUDA-core body;
11. ssm serve — mamba2-130m at full width (24 layers, d_model 768, 32 SSM
              heads x 64, state 128, bf16, random weights from ``--seed``)
              through ``ServeEngine`` on 4 slots, max_len 2048: 8 requests
              with prompts of 4096 (longer than max_len), 3000, 1024, 2048,
              512, 777, 1500 and 256 tokens, 32 new tokens each, 6 greedy
              and 2 sampled, staggered. Every request ends OK with 32
              tokens; the SSD kernel launches 24 x admission waves, each
              on the tensor-core body, and the attention kernels never.
              An engine built with page_size=16 serves the same mix with
              the same greedy streams and reports that it does not page;
12. ssm parity and times — the first wave's prefill and 4 decode steps
              again with the plain path (impl="torch"): every SSD kernel
              call held in situ against the plain version on its inputs,
              the logits within SSM_LOGIT_TOL, and a deliberate fault (the
              state not carried across chunks) that the check must reject;
              then the kernel (and its split over the four device kernels
              of the tensor-core body), its plain version and its bound
              per call at the path shape, the admission wave, the decode
              step of 4 slots (device busy, idle share) and end-to-end
              tokens/s;
12a. ssm chunked — the SSM mix through a chunked engine (SSM_CHUNK tokens
              per step), every SSD kernel call (the state h0 carried from
              the previous chunk) held in situ against the plain version:
              every request OK, the SSD kernel launched 24 x chunk steps
              and no attention kernel, first-token logits within
              SSM_LOGIT_TOL of the whole-prompt engine's.
13. swin    — SwinV2-B at full width (SWIN_LAYERS = 12 of its 24 layers,
              d_model 512, 16 heads x 32, window 576, d_ff 2048, bf16,
              random float32 weights from ``--seed``), its bias tables
              overwritten with exact rank-16 per-head products of seeded
              factors; ``svd_factorize`` timed (192 SVDs of 576 x 576) and
              its reconstruction error bounded; one forward of 32 images x
              4 windows in flashbias mode, kernel 1 launched exactly once
              per layer, each on the tensor-core body and
              held in situ against its plain version; the logits within
              MODEL_ULPS per layer of the dense-table forward's and the
              plain path's; the three forwards timed; kernel 1 at this
              shape alone and as the model calls it (the wrapper's float32
              factor copies), its plain version, SDPA with the table as a
              float mask, its bound and exponential floor;
14. pde     — the PDE solver at full width (8 layers, d_model 128, 8 heads x
              16, d_ff 256, coords 3-D, bf16) on PDE_POINTS = 32186 points in
              the unit cube: one flashbias forward, kernel 1 launched
              exactly 8 times on the tensor-core body (rank-9 float32
              factors, phi_k shared by the heads), each call held in situ on
              query-row slices (the last partial 64-row tile among them);
              at PDE_PARITY_POINTS = 8192 the output within MODEL_ULPS per
              layer of the dense-bias forward's and the plain path's; the
              forwards timed at both sizes; kernel 1 at both shapes against
              its bound and exponential floor (the dense bias at 32186 would
              be 33 GB a layer and is not run).

15. faults  — the paged phase's engine and 8 requests again under
              FAULT_PLAN, which fires every kind on live work (a delay, a
              NaN written into slot 0's logits on the card, a failed page
              growth, a failed decode step): every request OK with 32
              tokens, its stream, greedy and sampled, bit-equal to the
              paged phase's fault-free run; faults contained >= 2, a
              quarantine, every page free; kernel 1 launched 24 x waves and
              the paged decode kernel 24 x the decode steps that
              dispatched;
16. checkpoint — engines snapshotted part way (``snapshot_engine``),
              through ``json.dumps`` / ``json.loads``, the source run on and
              then deleted, the snapshot restored onto a fresh engine: (a)
              the prefix phase's engine (paged, chunk 256, prefix cache) on
              its traffic plus a CHECKPOINT_LONG-token prompt, caught with
              that prompt mid-ChunkPlan and two live requests sharing
              prefix pages; (b) the SSM serve phase's engine and mix once
              every request was submitted; (c) a Pairformer engine at
              PAIR_CKPT_LAYERS layers (full width) on PAIR_CKPT_COMPLEXES
              complexes. Every request OK and bit-equal, greedy and
              sampled, to the uninterrupted run, for the restored and the
              source engine; the JSON sizes logged;
17. hybrid  — hymba-1.5b at full width (HYBRID_LAYERS = 16 of its 32
              layers, d_model 1600, 48 heads x 64 over 6 kv heads, window 1024, 64 SSM heads x 64, state
              16, bf16, random weights from ``--seed``) through
              ``ServeEngine`` on 4 slots x 4096, so the attention cache is
              a ring: 8 requests (HYBRID_PROMPTS, five at or above the
              window), 32 new tokens, 6 greedy and 2 sampled, staggered.
              Every request OK; kernel 1 launched 16 x prefill waves, each
              in local mode (window 1024) on the tensor-core body and held
              in situ against its plain version one batch row at a time;
              kernel 5 16 x waves on the tensor-core body, each held in
              situ under ``ssd_tolerance``; decode launches no kernel (the
              ring is attended in plain torch, as the reference does). The
              first wave's prefill and 4 decode steps again with the plain
              path, logits within HYBRID_LOGIT_TOL; a chunked engine
              (chunk 512): every request OK, first-token logits within
              HYBRID_LOGIT_TOL of the whole-prompt engine's; kernel 1 at
              the path shape against its plain version, SDPA with the
              ALiBi + local float mask, its bound (in-window scores only)
              and exponential floor; kernel 5 at N 16 against its plain
              version and bound; the prefill wave and the decode step on
              the host clock, device busy and idle share.

18. paged-hybrid — hymba-1.5b at full width (HYBRID_LAYERS = 16 of its 32
              layers, random bf16
              weights from ``--seed``) through a paged ``ServeEngine`` on
              4 slots x PAGED_HYBRID_MAX_LEN = 1024, which the window
              covers: no ring, the attention cache pages (page size 16,
              lazy, a pool that grows and preempts), the SSM state rides
              per slot. 8 requests (PAGED_HYBRID_PROMPTS), 32 new tokens,
              6 greedy and 2 sampled, staggered. Every request OK, every
              page free after the drain; kernel 4 launched once per layer
              and decode step (G 8, D 64, phi against the [1, pos] slab)
              and kernel 3 never; kernels 1 (local, window 1024) and 5 once
              per layer and wave,
              held in situ as in phase 17. The first wave's prefill and 4
              decode steps on the contiguous and the paged cache against
              the plain path, within HYBRID_LOGIT_TOL (the contiguous
              cache of 1024 rows is a ring of the window, attended in
              plain torch, as the reference does). Kernel 1 (local) and
              kernel 4 at this config's shapes checked against their plain
              versions, then timed with them, bounds and library calls
              (``model_kernel_times``);
              the prefill wave and the paged decode step on the host
              clock, device busy, idle share and top kernels;
19. moe     — granite-moe-3b-a800m at MOE_GRANITE_LAYERS = 8 of its 32
              layers, full width (d_model 1536, 32 heads x 64 over 8 kv
              heads, 40 experts padded to 48, top 8, bf16) on the LM
              phase's traffic, contiguous and then paged (a pool that
              preempts): every request OK; kernel 1 once per layer and
              wave, kernel 3 (contiguous) or 4 (paged) per layer and step;
              the
              paged first-token logits within LOGIT_TOL of the contiguous
              ones (greedy streams compared and logged); phase 5's parity
              on the first wave and 4 decode steps, with launch counts,
              every path fed the contiguous kernel path's expert choices
              (``RouteFeed``; the share of the other paths' routings whose
              own top-k set differs within ROUTE_SET_SHARE); kernels 1, 3
              and 4 at the config's shapes checked against their plain
              versions, then timed; phase 6b's prefix engines (chunk 256, a
              512-token shared prefix), streams bit-equal; the wave's and
              the decode step's top device kernels (the dispatch's share).
              Then
              llama4-scout-17b-a16e at MOE_LLAMA_LAYERS = 4 of 48 layers,
              full width (16 experts, top 1, G 6, D 128): a short serve (4
              requests, SHORT_PROMPTS, 16 new tokens), contiguous and paged,
              with the same checks (the pool grows; a preemption is not
              required of 4 requests);
20. dense-configs — codeqwen1.5-7b (MHA 32 x 128) and minicpm-2b (48
              heads x 64) at DENSE_LAYERS = 8 of their 32 / 40 layers,
              and command-r-plus-104b at DENSE_R_LAYERS = 4 of 64 layers,
              all at full
              width (96 heads x 128 over 8 kv heads, G 12): a short paged
              serve each (every request OK, launch counts, the pool grows
              and drains) and phase 5's parity on the first wave and 2
              decode steps, within LOGIT_ULPS bf16 ulps at the config's top
              |logit| (at least LOGIT_TOL); kernels 1, 3 and 4 at each
              config's shapes checked against their plain versions, then
              timed with them, bounds and library calls; kernels 3 and 4
              at command-r-plus's shape at SPLIT_LENGTHS against their
              plain versions.

21. frontends — musicgen-medium (48 layers, d_model 1536, 24 heads padded
              to 32 x 64, 64 audio frontend rows) and phi-3-vision-4.2b (32
              layers, d_model 3072, 32 heads x 96, 576 vision frontend
              rows) whole, bf16, random weights and frontend rows from
              ``--seed``: FRONTEND_PROMPTS (6 requests of 64-512 tokens,
              each opening with its frontend rows), FRONTEND_NEW_TOKENS
              new tokens, through a contiguous and a paged engine (a pool
              that grows). Every request OK, the launch counters (kernel 1
              per layer and wave, kernel 3 or 4 per layer and step), the
              paged first-token logits within LOGIT_ULPS ulps of the
              contiguous ones, phase 5's parity on the first wave (its
              frontend rows included) and 4 decode steps; kernels 1, 3 and
              4 at phi-3-vision's D 96 shapes checked against their plain
              versions, then timed with them, bounds and library calls;
22. train   — GPT-2-ALiBi-1.5B at full width (TRAIN_LAYERS = 12 of its
              48 layers) trained through ``TrainLoop``:
              float32 master weights from ``init_params`` and ``--seed``,
              bf16 compute, the config's remat "dots" and grad_accum 4,
              TRAIN_BATCH x TRAIN_SEQ = 8 x 1024 tokens a step from
              ``LMBatches``, AdamW with a cosine schedule. Step 0 first on
              the kernel path and the plain path (impl="torch"): loss
              within TRAIN_LOSS_RTOL, every leaf's gradient norm within
              TRAIN_GRAD_RTOL. Then TRAIN_STEPS = 8 steps, a checkpoint
              after step TRAIN_CKPT_STEP = 3 (the first loop ends there;
              steps 4-7 go on in the same process), kernel 1 launched
              exactly 2 x 12 x 4 times a step (forward, and again where the
              backward recomputes each checkpointed layer), every launch on
              the tensor-core body, the loss finite and lower at step 7
              than at step 0; a fresh loop on fresh weights restores the
              checkpoint and runs steps 4-7 with losses equal to the
              uninterrupted run's (its own final save skipped: the
              machine allows 45 GiB of disk writes, a checkpoint is ~26
              GB at full depth). The step's host time, device busy
              (a profile checked against the counters), idle share,
              tokens/s, the share of 989 TFLOP/s the model FLOPs reach
              (``train_flops``: the roofline's ``model_flops``, 6 x active
              parameters x tokens, plus ``attention_kernel_flops`` at the
              step's ``ShapeSpec``), peak memory, and kernel 1's forward and
              the plain attention backward at the step's shape with the
              backward's share of the step. Then Mamba2-130M whole
              (remat "dots", grad_accum 4): step 0 against the plain path
              as above, SSM_TRAIN_STEPS = 2 steps, kernel 5 launched 2 x
              24 x 4 times a step on the tensor-core body.
23. pair-train — Pairformer-lite whole (16 layers, d_single 384, d_pair
              128, 4 heads x 96, R 96, bf16 compute, float32 masters from
              ``--seed``), factor MLPs of hidden 256: ``fit_factor_mlps``
              for PAIR_FIT_STEPS steps on PAIR_FIT_COMPLEXES complexes of
              384 residues (the Eq. 5 loss must fall); ``denoise_loss`` with
              the fitted factors, kernel 1 launched once per layer on the
              tensor-core body (phi mode, float32 factors) and held in situ;
              the loss and every leaf's gradient norm (trunk and factor
              MLPs) on the kernel path against the plain path within
              TRAIN_LOSS_RTOL / TRAIN_GRAD_RTOL; the output drift of the
              fitted factors against the dense bias logged; then
              MODEL_TRAIN_STEPS AdamW steps training trunk and MLPs
              together on one complex (the loss must fall, kernel 1 once
              per layer and step); step time, device busy, idle share and
              peak memory;
24. pde-train — the PDE solver whole (8 layers, d_model 128, 8 heads x
              16, bf16) on PDEBatches of PDE_POINTS = 32186 points: the
              loss and gradient norms of the kernel path against the plain
              path at PDE_PARITY_POINTS and of FlashBias against the dense
              bias at PDE_TABLE5_POINTS (Table 5's claim), as in phase 23;
              MODEL_TRAIN_STEPS AdamW steps through ``Model.loss`` at 32186
              points (the loss must fall; kernel 1 once per layer and step;
              the backward recomputes the plain attention by query blocks,
              ``ops.BWD_SCORE_BYTES``); step time, device busy, idle share,
              peak memory, and the plain attention backward at the step's
              shape with its share of the step's device busy;
25. swin-train — SwinV2-B whole (24 layers, d_model 512, 16 heads x 32,
              window 576, bf16): the loss and gradient norms with the
              tables' rank-16 SVD factors (kernel 1, once per layer) against
              the plain path, as in phase 23; then MODEL_TRAIN_STEPS AdamW
              steps with the dense tables (how the reference trains) on a
              PatchBatches batch of SWIN_TRAIN_IMAGES x SWIN_TRAIN_WINDOWS
              windows (the loss must fall); step time, device busy, idle
              share, peak memory.
26. sharded — the sharded serve path on a one-card mesh: a ``(1, 1)``
              ``(data, model)`` DeviceMesh over an NCCL process group of one
              rank. GPT-2-ALiBi-1.5B at full width (N_LAYERS of its 48
              layers; bf16, weights
              from ``--seed``), SHARDED_REQUESTS of the serve phase's
              requests, served by the unsharded and the sharded engine,
              contiguous and then paged; then mamba2-130m whole on the SSM
              mix's first SHARDED_REQUESTS requests. Every stream of the
              sharded engine bit-equal to the unsharded one's (one rank
              reorders no sum); kernels 1, 3, 4 and 5 launched as often on
              the sharded path as on the unsharded one (the counters prove
              the local shards reach the kernels, with no plain fallback);
              ``check_backend_mesh`` with no finding (state axes in the
              vocabulary, no pool replicated; no collective expected, none
              can run on one rank). Then the decode step of each engine on
              the host clock in alternating rounds, with device busy and
              idle share.

27. sharded-train — the sharded train step on the same one-card mesh
              (``make_train_step(mesh=)``, masters placed by
              ``TrainLayout``): GPT-2-ALiBi-1.5B at full width and phase
              22's depth (TRAIN_LAYERS of 48, remat "dots", grad_accum 4,
              TRAIN_BATCH x TRAIN_SEQ tokens a step) for
              SHARDED_TRAIN_STEPS steps from the seed's float32 masters,
              once unsharded and once sharded: the losses, grad norms and
              every final parameter bit-equal (one rank reorders no sum;
              every collective is the identity), kernel 1 launched 2 x
              layers x 4 times a step on both paths; Mamba2-130M whole for
              SHARDED_SSM_STEPS steps the same way with kernel 5. Then
              ``launch.train --mesh 1x1`` on Mamba2 in this process (its
              process group, ``--grad-accum`` LAUNCH_ACCUM): LAUNCH_STEPS
              steps with a checkpoint, a rerun
              that resumes for one more, kernel 5's launches counted; the
              checkpoint restored unsharded and stepped once must give the
              resumed step's loss and grad norm bit for bit. The sharded
              and unsharded host step times (TRAIN_TIMING_ROUNDS more
              GPT-2 steps each, SSM_TIMING_ROUNDS Mamba2 steps, rounds
              alternating) are logged beside the card's
              name and power limit. No collective runs on one rank: the
              CPU tests (``gloo``) carry the collectives.
28. dryrun  — the cost model against the card (``launch.dryrun``: the
              step run on the host on fake tensors with ``impl="io_stub"``
              kernels, which validate and allocate but launch nothing):
              GPT-2-ALiBi-1.5B at full width, bf16, weights from
              ``--seed``, in three cells (``dryrun_cells``): phase 22's
              train step (TRAIN_LAYERS, TRAIN_BATCH x TRAIN_SEQ, remat
              "dots", grad_accum 4; kernel 1 2 x 12 x 4 = 96 times), a
              prefill wave of DRYRUN_PREFILL at N_LAYERS (kernel 1, 24)
              and a contiguous decode step of DRYRUN_DECODE at N_LAYERS
              (kernel 3, 24). Each predicted on the host, then run on the
              card after a warm-up step: the io_stub's kernel calls equal
              to the launch counters' movement, ``FlopCounterMode``'s count
              of the card's step equal to the dry run's (the differing ops
              named otherwise), the card's memory in parts: arguments
              and resident bytes (cuBLAS workspaces, arrival counters:
              ``dryrun.resident_bytes``) exactly as predicted, the step's
              temporaries in DRYRUN_TEMP_BAND (plus DRYRUN_TEMP_SLACK) and
              its peak (``max_memory_allocated`` after
              ``reset_peak_memory_stats``) in DRYRUN_PEAK_BAND of the
              predicted ones; the roofline of the step's deployment
              terms (compute, memory and collective ms, the dominant term)
              beside the device busy time of one profiled step.
29. statcheck — the port's static contracts (``repro_torch.statcheck``)
              on one full-width decode step, in the main process on the
              serve phase's weights: a contiguous and a paged backend
              (STATCHECK_PROMPTS admitted), one decode step of each logged
              op by op on the card, with zero findings (no pool relayout,
              no host sync — device-to-host copies are visible here —, the
              static-shape key bound) and kernels 3 and 4 each launched
              N_LAYERS times by the logged step; then the tripwire (the
              decode op wrapped in a per-layer pool transpose) must fire.
30. examples — the four ported examples (``quickstart_torch``,
              ``serve_lm_torch``, ``serve_pairformer_torch``,
              ``pde_solver_torch``) through their ``main`` with ``--device
              cuda``: each raises where its exactness check fails; their
              kernel launches (kernels 1, 3 and 5 in serve_lm, 2 in
              serve_pairformer, 1 in pde_solver) join the record.

Phases 13-14, 17-28 and 30 each run in a process of their own (``run_child``):
late in a long process torch.profiler has lost device events (PERF.md
section 7), and phase 13's library profile did so in PR 22's first full
run. Kernel 1's ``launches`` in the record adds phases 13, 14 and 17-30
to the serve phase's (phases 23-24: their training steps; 25: the
SVD-factor gradient run; 26: its sharded engines'; 27: its sharded train
steps; 28: its measured steps; 29: its two prefill waves; 30: the
examples'), kernels 3 and 4 add phases 18-21's, 26's, 29's, (kernel 3)
28's and 30's, kernel 2's adds phase 30's, kernel 5's adds
phases 17, 18, 22, 26, 27 and 30's (27: the sharded steps and the
launcher's); their
times stay at the LM prefill, LM decode and SSM shapes (the other shapes'
are logged above the record).

The last lines are the per-kernel JSON record, the card's name and power
limit as nvidia-smi reports them, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's data-sheet figures, from the port's one source of them
from repro_torch.hw import H100_SXM  # noqa: E402

HBM_BYTES_PER_S = H100_SXM.hbm_bandwidth       # 3.35e12 B/s
BF16_FLOP_PER_S = H100_SXM.peak_flops_bf16     # 989e12, dense bf16
# GPT-2's serve phases (3-6c, 15-16, 26) run N_LAYERS of its 48 layers
# (cut when phase 27 was added, PERF.md section 4)
N_LAYERS = 24
SLOTS, MAX_LEN, PROMPT_MAX, NEW_TOKENS = 4, 2048, 512, 32
PAGE = 16                        # page size of the paged phases
LOGIT_TOL = 0.25                 # bf16 logits, set 48 layers deep (phase 5)
# LOGIT_TOL is 4 bf16 ulps of logits in [8, 16), GPT-2's top scale. Wider
# models' logits reach higher (random embeddings: std 0.02 * sqrt(d_model),
# 2.2 at command-r-plus's 12288), where a bf16 ulp is larger: 0.25 is one
# ulp of logits in [32, 64). Phase 20 holds its configs to LOGIT_ULPS = 2
# ulps at their own top |logit| (never below LOGIT_TOL); its readings were
# one ulp (0.25 at top logits of 39.5-63.0). Its kernels are also held at
# the model shapes directly (``model_kernel_times``).
LOGIT_ULPS = 2
# decode lengths across the split kernel's span boundaries (128 keys at D 32,
# 32 at D 160) and the whole cache
SPLIT_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129, 777, 2048]
KERNELS = ("flashbias_attention_fwd", "flash_decode_fwd",
           "flash_decode_paged_fwd", "flashbias_attention_ragged_fwd",
           "ssd_scan_fwd")
# phases 7-9 run the Pairformer at 8 of its 16 layers, full width: the
# whole script must stay well inside its time limit with phases 21-22
PAIR_LAYERS, PAIR_SLOTS, PAIR_MAX_LEN = 8, 4, 384
PAIR_STEPS = 2                   # refinement steps of the parity phase
# Pair parity, bf16. Both paths keep s in bf16 through the layers and three
# passes (admission + 2 steps), so any change in where one attention output
# rounds spreads to most elements of s: the plain path against itself with
# its attention computed in float64 moves s by ~0.1 x RMS(s) at max |diff|.
# A bound on that end-to-end gap alone either sits below this floor or
# cannot tell a kernel fault from rounding, so the check has two parts:
# 1. in situ: every ragged kernel call of the kernel path is held against
#    the plain version on the same inputs under ``tolerance()``, the kernel
#    phase's rule: a fault of the kernel shows there, before rounding
#    compounds through the layers;
# 2. end to end: the kernel path's max |diff| of s from the plain path is at
#    most PAIR_CONTROL_MULT times the float64 control's, read in the same
#    run and mode. The kernel's output is one bf16 rounding of a float32
#    result and the control's one of a float64 result: drifts of one size.
# Deliberate faults of the plain attention (PAIR_FAULTS) stand in for a wrong
# kernel: the check must reject each of them, or the run fails.
PAIR_CONTROL_MULT = 2.0
# The same comparison in float32 throughout (compute dtype float32): the
# paths then differ only in the order of float32 sums inside attention
# (~1e-6 relative per call), which over the layers and three passes stays
# orders of magnitude below 1e-3 of RMS(s). In situ, the float32 rule of
# ``tolerance()`` holds.
PAIR_TOL_F32 = 1e-3
# (name, keys the attention skips, whether the bias takes the softmax
# scale): a kv tile the block loop misses, and the bias added before the
# scaling
PAIR_FAULTS = (("keys 64-127 skipped", (64, 128), False),
               ("bias scaled by the softmax scale", None, True))
CHUNK = 256                      # prefill chunk of the chunked LM phases
LONG_PROMPTS = (1536, 1900)      # long arrivals of the chunked phase
PREFIX_LEN, PREFIX_REQUESTS = 512, 8
PREFIX_TAILS = (32, 300)         # tail lengths of the prefix phase
SSM_LAYERS, SSM_SLOTS, SSM_MAX_LEN = 24, 4, 2048
SSM_CHUNK = 512                  # prefill chunk of the SSM chunked phase
SSM_PROMPTS = (4096, 3000, 1024, 2048, 512, 777, 1500, 256)
SSM_DECODE_STEPS = 4             # decode steps of the parity phase
# SSM parity, bf16 compute. The scan runs in float32 on both paths (the
# model casts x, b, c to float32 and keeps dt, a and the state there), so
# the paths differ only in float32 rounding inside the scan (the order of
# sums; on the tensor-core body also the bf16 hi + lo split of each
# operand, < 2^-15 relative per product term), ~1e-6 to 1e-5 relative.
# Such a difference shows in the bf16 model only where it flips the
# rounding of an element (1 bf16 ulp, 2^-8 relative) after the gated norm,
# and spreads through 24 layers as the attention kernels' roundings spread
# through the LM's 48 (phase 5: within 0.125 of the plain path's logits,
# tolerance 0.25). The largest logits here are bf16 values in [8, 16),
# whose ulp is 2^-4 = 0.0625 (the gap has read 0.0625, one such ulp): the
# bound, 0.125, is 2 such ulps at the logits' top scale. In situ, every
# kernel call is held against the plain version on its own inputs under
# ``ssd_tolerance``: a fault of the kernel shows there first.
SSM_LOGIT_TOL = 0.125
SWIN_IMAGES, SWIN_WINDOWS = 32, 4  # 128 windows of 576 tokens per forward
PDE_POINTS = 32186               # the paper's Table 5 mesh
PDE_PARITY_POINTS = 8192         # where the dense and plain paths fit
# The vision and PDE forwards against their dense-bias and plain paths,
# bf16. Each path rounds every layer's attention output to bf16 once, on a
# different float32 result (the kernel sums in another order, reads the
# factors as bf16 hi + lo, and the dense path adds a float32 table where the
# kernel adds bf16-rounded SVD factors' product), so the gap may grow by
# about one bf16 ulp of the output's scale per layer: the bound is
# MODEL_ULPS ulps (2^-8 relative) at the top |output| per layer. In situ,
# every kernel call is held to ``tolerance()``.
MODEL_ULPS = 1
# svd_factorize's relative Frobenius error on tables of exact rank 16:
# float32 rounding through cuSOLVER's iterative SVD (1.6e-5 read on the
# card), where a rank-16 truncation of a full-rank normal table leaves ~0.9
SVD_REL_TOL = 1e-4
# special-function (exp) rate of one H100 SXM, the figure FlashAttention-3
# gives (3.9 TFLOPS of exponentials against 989 TFLOPS of bf16 products)
SFU_EXP_PER_S = 3.9e12
# phase 15: the paged phase's traffic under a plan that fires every kind on
# live work (a CPU run of the same schedule chose the steps: slot 0 is
# decoding at step 6, a page grows at step 11; delay@1 finds no free slot)
FAULT_PLAN = "delay@1,nan@6/0,alloc@11,step@12"
CHECKPOINT_LONG = 1536           # the mid-plan prompt of phase 16a
CHILD_RESULT = "[child-result] "  # a --phase run's result line
PAIR_CKPT_LAYERS, PAIR_CKPT_COMPLEXES = 2, 6   # phase 16c's cut depth
# phase 17 runs hymba at 16 of its 32 layers, full width (time, as above)
HYBRID_LAYERS, HYBRID_MAX_LEN, HYBRID_CHUNK = 16, 4096, 512
HYBRID_PROMPTS = (3000, 1900, 1536, 1024, 700, 512, 300, 64)
HYBRID_DECODE_STEPS = 4          # decode steps of the hybrid parity
# Hybrid parity, bf16. Each layer rounds the attention branch
# (kernel 1 against the plain float32 softmax: one bf16 rounding of results
# that differ in the order of float32 sums) and the SSM branch (kernel 5's
# float32 scan against the plain one, as SSM_LOGIT_TOL argues) to bf16
# once; a 1-ulp flip of an element spreads through the layers as the LM's
# do through 48 (phase 5: within 0.125, tolerance 0.25). The ring decode is
# plain torch on both paths. The bound is LOGIT_TOL's: 4 bf16 ulps of
# logits in [8, 16), 2 in [16, 32).
HYBRID_LOGIT_TOL = 0.25
# phase 18: hymba with max_len 1024, which its window covers: no ring, the
# attention cache pages (kernel 4 at G 8, D 64), the SSM state per slot
PAGED_HYBRID_MAX_LEN = 1024
PAGED_HYBRID_PROMPTS = (960, 700, 512, 300, 64, 900, 400, 128)
# phases 19-20: depth cut where the whole model would not fit one card
# (llama4-scout 100.7 B parameters, command-r-plus 103.8 B; bf16 weights
# of 201 and 208 GB), and the short serves' traffic
MOE_LLAMA_LAYERS, DENSE_R_LAYERS = 4, 4
# cut for time, full width (PR 22): with phases 21-22 the whole script
# must stay well inside its limit on a slow host too (PR 21's ran 1.55x
# another's): Swin, granite-moe, paged hymba (HYBRID_LAYERS), codeqwen
# and minicpm run at these depths. With phases 23-25 the whole script
# took 858 s (695 s before them, PERF.md section 5), so granite-moe,
# codeqwen and minicpm run 8 layers and GPT-2's training (phase 22)
# TRAIN_LAYERS of its 48. With phase 26 it took 887 s (74% of the
# limit); phase 27 adds ~50-65 s, so GPT-2's training (phases 22 and 27)
# runs 12 layers, its serving N_LAYERS and phase 22's Mamba2
# SSM_TRAIN_STEPS steps (785 s and 889 s on two hosts with serving at 48
# layers, PERF.md section 5)
SWIN_LAYERS, MOE_GRANITE_LAYERS, DENSE_LAYERS = 12, 8, 8
TRAIN_LAYERS = 12
# MoE parity: the share of the router calls of the parity's other paths
# (plain, paged kernel, paged plain) whose own top-k expert set differs from
# the fed one (``RouteFeed``). Rounding re-routes a token only at a near tie
# of the k-th and (k+1)-th router probability; a fault that moves the
# router's inputs re-routes a large share. Each limit is 4 times the
# config's reading on the card (granite 1783 of 67072 routings, 2.66%;
# llama4 30 of 8384, 0.36%; PERF.md, PR 21).
ROUTE_SET_SHARE = {"granite-moe-3b-a800m": 0.1063,
                   "llama4-scout-17b-a16e": 0.0143}
SHORT_PROMPTS, SHORT_NEW_TOKENS = (512, 300, 64, 450), 16
# phase 21: the frontend configs' traffic (prompt tokens; the frontend rows
# come on top: 64 for musicgen, 576 for phi-3-vision)
FRONTEND_PROMPTS, FRONTEND_NEW_TOKENS = (512, 300, 64, 450, 200, 128), 24
# phase 22: GPT-2 1.5B training, its config's remat ("dots") and grad_accum
# (4): TRAIN_BATCH sequences of TRAIN_SEQ tokens per step, TRAIN_STEPS
# steps, a checkpoint after step TRAIN_CKPT_STEP; AdamW, cosine from
# TRAIN_LR (the launcher's recipe: warmup steps // 10)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_STEP = 8, 1024, 8, 3
TRAIN_LR = 3e-4
SSM_TRAIN_STEPS = 2
# Step 0 of the kernel path (impl="cuda") against the plain path
# (impl="torch") on the same weights and batch, bf16 compute. The paths
# differ in each layer's attention forward (kernel 1 against the plain
# float32 softmax, each rounded to bf16 once); the backward is the plain
# version's on both. The loss is a mean over 8192 tokens of a float32
# cross-entropy of bf16 logits: a one-ulp flip of some logits moves it by
# far less than one bf16 ulp of ~10.8 (0.0625), so TRAIN_LOSS_RTOL = 1e-3
# (0.011 at 10.8). Each leaf's gradient norm sums over O(10^6-10^8)
# elements whose bf16 roundings differ between the paths independently,
# so the norms agree far closer than an element does: TRAIN_GRAD_RTOL =
# 1e-2 of each leaf's norm (an element of bf16 has 2^-8 = 0.4% relative
# error).
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-3, 1e-2
# Phases 22-25 compare leaf gradient norms relative to at least this share
# of the largest leaf norm: a leaf whose gradient vanishes analytically
# (the last bias of the Pairformer's phi_k MLP shifts every key's factor by
# one vector, moving each query's logits by a constant the softmax ignores)
# holds rounding noise only (2e-10 against leaf norms of 1e-2 on the
# card, PERF.md section 6)
TRAIN_GRAD_FLOOR = 1e-6
# phases 23-25: the paper's models trained whole. Phase 23 fits the
# Pairformer's factor MLPs (hidden 256, App. H Table 12) with Eq. 5 on
# PAIR_FIT_COMPLEXES complexes of PAIR_TRAIN_RES residues, then trains on
# PAIR_TRAIN_BATCH of them; phase 24 trains the PDE solver on PDE_POINTS,
# its paths compared at PDE_PARITY_POINTS (kernel and plain) and at
# PDE_TABLE5_POINTS (FlashBias and dense, where the dense bias is small);
# phase 25 trains Swin on SWIN_TRAIN_IMAGES x SWIN_TRAIN_WINDOWS windows.
# Each takes MODEL_TRAIN_STEPS AdamW steps (cosine from TRAIN_LR, as
# phase 22; the Pairformer from PAIR_TRAIN_LR) on one batch, so its loss
# must fall. On the card, at 1e-3 the PDE's loss rose 4.4x at step 1
# before falling and Swin's rose over 3 steps of fresh PatchBatches; the
# Pairformer's rose 4.9x at step 1 from 3e-4 and stayed above its start
# (PERF.md section 6: Adam's first steps move every weight by the
# learning rate, and the triangle update sums the coherent change over all
# N residues; on the CPU at N 192 the loss fell at every step from 1e-5
# only).
PAIR_FIT_COMPLEXES, PAIR_TRAIN_RES, PAIR_TRAIN_BATCH = 2, 384, 1
PAIR_TRAIN_HIDDEN, PAIR_FIT_STEPS, PAIR_FIT_LR = 256, 30, 1e-3
PAIR_TRAIN_LR = 1e-5
PDE_TABLE5_POINTS = 2048
SWIN_TRAIN_IMAGES, SWIN_TRAIN_WINDOWS = 8, 4
MODEL_TRAIN_STEPS = 4


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call between CUDA events around ``iters`` back-to-back calls:
    the device's time plus any gaps in which it waits for the host to issue
    the next call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_rows(prof) -> list:
    """The device-side (kernel and copy) rows of a profile's averages."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def device_kernels(prof) -> list:
    """The device rows of the profiled calls: all but the profiler's own
    step annotation (``ProfilerStep#n``, which spans the step on the device
    timeline) and the spin kernels that open the kept step."""
    return [e for e in device_rows(prof)
            if not e.key.startswith("ProfilerStep")
            and SPIN_KERNEL not in e.key]


def device_us(e) -> float:
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0))


PROFILE_TRIES = 3                # an incomplete profile is retried
PROFILE_HEAD = 4                 # ~25 ms spin kernels opening the warm-up
                                 # step and the kept step, doubled at every
                                 # retry
SPIN_KERNEL = "spin_kernel"      # torch.cuda._sleep's kernel
# the port's CUDA kernels as torch.profiler names them (kernels 1 and 2
# share the attn_fwd_tc template in bf16 and attn_fwd in float32, kernels 3
# and 4 the split-KV decode_split one; kernel 5 is ssd_fwd on the CUDA cores
# and the four SSD_STAGES on the tensor cores)
SSD_STAGES = ("ssd_states", "ssd_cb", "ssd_state_pass", "ssd_chunk_scan")
PORT_KERNEL = re.compile(
    r"(?<![A-Za-z0-9_])(attn_fwd|attn_fwd_tc|decode_split|ssd_fwd|"
    + "|".join(SSD_STAGES) + r")[<(]")
# the wrappers that also count their tensor-core launches: the two attention
# wrappers and the SSD scan's
ATTENTION = ("flashbias_attention_fwd", "flashbias_attention_ragged_fwd")
TENSOR_CORE = ATTENTION + ("ssd_scan_fwd",)


def window(prof) -> str:
    """Where a profile's device events and kernel launches lie in time
    (us, from the first event), for the report of an incomplete one."""
    from torch.autograd import DeviceType
    events = prof.events()
    t0 = min(e.time_range.start for e in events)
    dev = [e.time_range.start - t0 for e in events
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    host = [e.time_range.start - t0 for e in events
            if "LaunchKernel" in e.name]
    span = (lambda t: f"{len(t)} from {min(t):.0f} to {max(t):.0f}"
            if t else "none")
    return f"device events {span(dev)}, launches {span(host)}"


def device_launches(wrapper) -> int:
    """The device kernels a counted wrapper has launched: its launch count,
    or, for the SSD wrapper, one of whose calls launches up to four, its
    count of device kernels."""
    return getattr(wrapper, "device_kernels", wrapper.launches)


def profiled(fn, iters: int, uniform: bool = True):
    """Run ``fn`` ``iters`` times under torch.profiler; returns the
    profile's device rows (``device_kernels``). The profiler has been seen to drop device events,
    so a profile is taken only when it is complete by what the run knows:
    the port's kernels recorded exactly as often as their counters of
    device kernels moved during it (``device_launches``), and, where every
    call of ``fn`` runs the same kernels (``uniform``), every device row
    counted a multiple of ``iters`` times.
    The events lost were those of a tracing session's start, more of them
    the longer the process had run, so the session opens with a warm-up
    step, traced and discarded (PROFILE_HEAD spin kernels of ~25 ms each,
    each behind a synchronize, and one call of ``fn``), and only the step
    after it is kept. Late in the run the kept step still lost its own
    first 1-36 ms (the SSD kernel's 20 calls of 4.4 ms, however long the
    warm-up), so the kept step opens with PROFILE_HEAD spin kernels too,
    left out of every sum (``device_kernels``), and waits for them before
    the calls, which then start on an idle device. The kept step's host
    rows hold that wait: a host breakdown comes from ``host_ops``. An
    incomplete profile is taken again with twice the spins, up to
    PROFILE_TRIES times, before the run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    counters = launch_counters().values()
    seen = []
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     acc_events=True) as prof:
            for _ in range(PROFILE_HEAD << attempt):
                torch.cuda._sleep(50_000_000)         # clock cycles
                torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(PROFILE_HEAD << attempt):
                torch.cuda._sleep(50_000_000)
            torch.cuda.synchronize()
            before = sum(device_launches(c) for c in counters)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
        launched = sum(device_launches(c) for c in counters) - before
        kernels = device_kernels(prof)
        port = sum(e.count for e in kernels if PORT_KERNEL.search(e.key))
        ragged = [(e.key[:40], e.count) for e in kernels
                  if e.count % iters]
        if kernels and port == launched and not (uniform and ragged):
            return kernels
        seen.append(f"{len(kernels)} device rows, port kernels {port} of "
                    f"{launched} launched, rows not a multiple of {iters}: "
                    f"{ragged if uniform else 'not checked'}; "
                    f"{window(prof)}")
    raise AssertionError(f"torch.profiler recorded an incomplete profile in "
                         f"{PROFILE_TRIES} tries: {seen}")


def host_ops(fn, iters: int, top: int = 6) -> list:
    """The ``top`` host-side rows (by self CPU time) of ``iters`` calls of
    ``fn`` under torch.profiler, in a profile of their own that queues
    nothing ahead of the calls: after a traced and discarded warm-up call
    and a synchronize, the calls start on an idle device, as between
    serving steps, and end with one synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    device = {e.key for e in device_rows(prof)}
    host = [e for e in prof.key_averages() if e.key not in device]
    return sorted(host, key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:top]


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn``: the summed durations of the kernels
    and copies it runs, from a complete torch.profiler profile over
    ``iters`` calls — without the gaps ``event_ms`` counts, which for a
    ~20 us decode kernel behind a Python wrapper are most of the bracket."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    kernels = profiled(fn, iters)
    return sum(device_us(e) for e in kernels) / iters / 1e3


def tolerance(dtype, ref) -> float:
    """float32: summation order only (1e-4). bfloat16: both sides round the
    same float32 result once, so 2 bf16 ulps at the output's scale."""
    import torch
    if dtype == torch.float32:
        return 1e-4
    return 2.0 ** -6 * max(1.0, float(ref.float().abs().max()))


def sass_functions(name: str, pattern: str) -> dict:
    """HGMMA instructions per kernel function of the built library ``name``,
    from ``cuobjdump -sass``: the functions whose mangled names match
    ``pattern``, keyed ``name<template arguments>`` from its two groups."""
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            head = re.search(r"Function : " + pattern, line)
            fn = (head.group(1) + (f"<{head.group(2)}>" if head.group(2)
                                   else "")) if head else None
            if fn is not None:
                counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def sass_hgmma() -> None:
    """HGMMA instructions per kernel function of the built attention and SSD
    libraries; fails unless every tensor-core body has some: each
    ``attn_fwd_tc<Dv, phi>`` and each instantiation of the SSD body's three
    kernels with products (``ssd_states``, ``ssd_cb``, ``ssd_chunk_scan``;
    ``ssd_state_pass`` has none, nor has the CUDA-core ``ssd_fwd``)."""
    attn = sass_functions("flashbias_attn",
                          r"\S*?\d(attn_fwd(?:_tc)?)I(\w+?)EE")
    ssd = sass_functions("ssd_scan", r"\S*?\d(ssd_\w+?)(?:I(\w+?)E)?E")
    log("build", f"HGMMA instructions per function in the SASS of "
                 f"libflashbias_attn: {attn}")
    log("build", f"HGMMA instructions per function in the SASS of "
                 f"libssd_scan: {ssd}")
    tc = {k: n for k, n in attn.items() if k.startswith("attn_fwd_tc")}
    tc.update({k: n for k, n in ssd.items()
               if k.split("<")[0] in ("ssd_states", "ssd_cb",
                                      "ssd_chunk_scan")})
    stages = {k.split("<")[0] for k in tc}
    if not all(tc.values()) or not {"attn_fwd_tc", "ssd_states", "ssd_cb",
                                    "ssd_chunk_scan"} <= stages:
        raise AssertionError(f"a tensor-core body without HGMMA: {tc}")


def check_tensor_core(phase: str, names=ATTENTION) -> None:
    """Every launch of the wrappers ``names`` (the attention wrappers by
    default) since their counters were set to 0 took the tensor-core
    body."""
    counters = launch_counters()
    got = {name: (counters[name].tensor_core_launches,
                  counters[name].launches) for name in names}
    log(phase, f"tensor-core launches / launches: {got}")
    if any(tc != n for tc, n in got.values()):
        raise AssertionError(f"{phase}: launches off the tensor-core body: "
                             f"{got}")


def reset_counters() -> dict:
    """Every launch counter set to 0; returns the counted wrappers."""
    counters = launch_counters()
    for name, fn in counters.items():
        fn.launches = 0
        if name in TENSOR_CORE:
            fn.tensor_core_launches = 0
        if hasattr(fn, "device_kernels"):
            fn.device_kernels = 0
    return counters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def prefill_inputs(gen, b, h, kvh, n, d, dtype, bias, r=4):
    import torch
    dev = "cuda"
    q = torch.randn((b, h, n, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, kvh, n, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, kvh, n, d), generator=gen, device=dev).to(dtype)
    extra = {}
    if bias == "phi":
        extra["phi_q"] = torch.randn((b, h, n, r), generator=gen, device=dev)
        extra["phi_k"] = torch.randn((b, h, n, r), generator=gen, device=dev)
    elif bias == "alibi":
        from repro_torch.core.bias import alibi_slopes
        extra["slopes"] = alibi_slopes(h, device=dev)
    return q, k, v, extra


def decode_inputs(gen, b, kvh, g, s, d, dtype, bias, lengths, r=4):
    import torch
    dev = "cuda"
    q = torch.randn((b, kvh, g, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, kvh, s, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, kvh, s, d), generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    extra = {}
    if bias == "phi":
        extra["phi_q"] = torch.randn((b, kvh, g, r), generator=gen,
                                     device=dev)
        extra["phi_k"] = torch.randn((b, kvh, s, r), generator=gen,
                                     device=dev)
    elif bias == "alibi":
        from repro_torch.core.bias import alibi_slopes
        extra["slopes"] = alibi_slopes(kvh * g, device=dev).reshape(kvh, g)
    return q, k, v, lens, extra


def paged_table(rng, b, n_live, n_pages):
    """(b, n_live + 4) int32 page table: a random permutation of the pool's
    pages, then garbage columns (ids past the pool and negative ones) that
    the kernel must clamp and never reach past the length mask."""
    live = rng.permutation(n_pages)[:b * n_live].reshape(b, n_live)
    junk = rng.integers(-3, 2 * n_pages, (b, 4))
    junk[:, 0] = n_pages                     # the engine's sentinel
    return np.concatenate([live, junk], 1).astype(np.int32)


def widen_table(table, width: int, n_pages: int):
    """``table`` padded with sentinel columns (``n_pages``) to ``width``,
    the serve engine's table width: the split axis of the paged kernel's
    grid is sized from it."""
    import torch
    pad = torch.full((table.shape[0], width - table.shape[1]), n_pages,
                     dtype=table.dtype, device=table.device)
    return torch.cat([table, pad], 1).contiguous()


def sentinel_write(table, row: int, block: int, n_live: int, n_pages: int):
    """``table`` with the sentinel (``n_pages``) at ``row``'s ``block``, and
    the pool's last page (where the kernel clamps the sentinel to) taken
    out of every row's live pages, so that no row writes what another
    reads."""
    import torch
    t = table.cpu().numpy().copy()
    live = t[:, :n_live]
    spare = min(set(range(n_pages)) - set(live.ravel().tolist()))
    live[live == n_pages - 1] = spare
    t[row, block] = n_pages
    return torch.as_tensor(t, device=table.device)


def alibi_slab(table, lengths, n_pages, ps, rng):
    """The engine's factor slab ``(n_pages, ps, 2)``: row ``[1, pos]`` of
    every logical position a table maps, random rows elsewhere."""
    slab = rng.standard_normal((n_pages, ps, 2)).astype(np.float32)
    for b, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            pos = np.arange(j * ps, (j + 1) * ps, dtype=np.float32)
            slab[table[b, j]] = np.stack([np.ones_like(pos), pos], -1)
    return slab


def paged_inputs(gen, rng, b, kvh, g, d, ps, dtype, bias, lengths, r=4):
    """Inputs of the paged decode kernel. ``bias="alibi_slab"`` is the
    serving path: phi mode with ``phi_q = slope * [-(len-1), 1]`` against
    the shared rank-2 ``[1, pos]`` slab; ``"phi"`` / ``"phi_kvh"`` random
    factors on a shared / per-kv-head slab; ``"alibi"`` in-kernel slopes."""
    import torch
    from repro_torch.core.bias import alibi_slopes
    dev = "cuda"
    n_live = -(-max(lengths) // ps)
    n_pages = b * n_live + 3
    q = torch.randn((b, kvh, g, d), generator=gen, device=dev).to(dtype)
    kp, vp = (torch.randn((kvh, n_pages, ps, d), generator=gen,
                          device=dev).to(dtype) for _ in range(2))
    table = paged_table(rng, b, n_live, n_pages)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    extra = {}
    slopes = alibi_slopes(kvh * g, device=dev).reshape(kvh, g)
    if bias == "alibi_slab":
        qpos = (lens.float() - 1)[:, None, None]
        extra["phi_q"] = torch.stack(
            [-qpos * slopes[None], slopes[None].expand(b, kvh, g)], -1)
        extra["phi_pages"] = torch.as_tensor(
            alibi_slab(table, lengths, n_pages, ps, rng), device=dev)[None]
    elif bias.startswith("phi"):
        lead = kvh if bias == "phi_kvh" else 1
        extra["phi_q"] = torch.randn((b, kvh, g, r), generator=gen,
                                     device=dev)
        extra["phi_pages"] = torch.randn((lead, n_pages, ps, r),
                                         generator=gen, device=dev)
    elif bias == "alibi":
        extra["slopes"] = slopes
    pt = torch.as_tensor(table, device=dev)
    return q, kp, vp, lens, pt, extra


def check_kernel(worst: dict, name, got, want, dtype, path=False,
                 wrapper=None, before=0, label="kernels"):
    """One kernel call against its plain version under ``tolerance``
    (and, with ``wrapper``, on the body its dtype selects); a path shape's
    error goes into ``worst`` under the kernel's name."""
    import torch
    torch.cuda.synchronize()
    if wrapper is not None:
        tc = wrapper.tensor_core_launches - before
        if tc != (dtype == torch.bfloat16):
            raise AssertionError(f"{name}: {tc} tensor-core launches")
    err = float((got.float() - want.float()).abs().max())
    tol = tolerance(dtype, want)
    ok = bool(torch.isfinite(got).all()) and err <= tol
    log(label, f"{name}: max_abs_err {err:.3e} (tol {tol:.1e}) "
               f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err:.3e} > {tol:.1e})")
    if path:
        worst[name.split(" ")[0]] = err
    return err


def decode_case(gen, check, name, fn, plain, q, k, v, lens, extra, kw,
                dtype, path, write, new=None):
    """A decode kernel call against its plain version (``check``). Where it
    writes the new token's row (k_new, v_new, as the serve path does; drawn
    from ``gen`` unless ``new`` gives them) the caches after the call must
    be bit-equal to the plain version's; every length-0 row must be exactly
    0; a path shape runs twice and must be bit-identical."""
    import torch
    b, kvh, _, d = q.shape
    if not write:
        new = {}
    elif new is None:
        new = {"k_new": torch.randn((b, kvh, d), generator=gen,
                                    device="cuda").to(dtype),
               "v_new": torch.randn((b, kvh, v.shape[-1]), generator=gen,
                                    device="cuda").to(dtype)}

    def run(f):
        kc, vc = k.clone(), v.clone()
        return f(q, kc, vc, lens, *extra, **kw, **new), kc, vc

    got, k_got, v_got = run(fn)
    want, k_want, v_want = run(plain)
    check(name, got, want, dtype, path)
    if bool(got[lens == 0].any()):
        raise AssertionError(f"{name}: rows of length 0 are not 0")
    if write and not (torch.equal(k_got, k_want)
                      and torch.equal(v_got, v_want)):
        raise AssertionError(f"{name}: the caches after the fused row "
                             f"write differ from the plain version's")
    if path:
        again, _, _ = run(fn)
        torch.cuda.synchronize()
        if not torch.equal(again, got):
            raise AssertionError(f"{name}: two calls on the same inputs "
                                 f"are not bit-identical")
        log("kernels", f"{name}: caches bit-equal to the plain "
                       f"version's, two calls bit-identical")


def wide_group_decode(gen, rng, check, g: int, kvh: int = 8,
                      d: int = 128) -> None:
    """Kernels 3 and 4 at ``g`` q heads per kv head (12 is command-r-plus's
    group, 6 llama4-scout's; 9 to 16 take the MG = 16 body), ``kvh`` kv
    heads, D ``d``, at
    SPLIT_LENGTHS, writing the new row: contiguous with ALiBi slopes (bf16)
    and phi (float32), paged at page size PAGE on the serve path's [1, pos]
    slab (bf16) and with random phi factors (float32)."""
    import torch
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_paged_fwd,
                                                  flash_decode_paged_torch,
                                                  flash_decode_torch)
    b = len(SPLIT_LENGTHS)
    for dtype, bias in ((torch.bfloat16, "alibi"), (torch.float32, "phi")):
        q, k, v, lens, extra = decode_inputs(gen, b, kvh, g, 2048, d, dtype,
                                             bias, SPLIT_LENGTHS)
        decode_case(gen, check, f"flash_decode_fwd splits KVH{kvh} G{g} "
                                f"D{d} {str(dtype)[6:]} {bias} write",
                    flash_decode_fwd, flash_decode_torch, q, k, v, lens, (),
                    dict(scale=d ** -0.5, **extra), dtype, False, True)
    for dtype, bias in ((torch.bfloat16, "alibi_slab"),
                        (torch.float32, "phi")):
        q, kp, vp, lens, pt, extra = paged_inputs(gen, rng, b, kvh, g, d,
                                                  PAGE, dtype, bias,
                                                  SPLIT_LENGTHS)
        decode_case(gen, check, f"flash_decode_paged_fwd splits KVH{kvh} "
                                f"G{g} D{d} ps{PAGE} {str(dtype)[6:]} "
                                f"{bias} write",
                    flash_decode_paged_fwd, flash_decode_paged_torch, q, kp,
                    vp, lens, (pt,), dict(scale=d ** -0.5, **extra), dtype,
                    False, True)


def phase_kernels(seed: int) -> dict:
    import torch
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_paged_fwd,
                                                  flash_decode_paged_torch,
                                                  flash_decode_torch)
    from repro_torch.kernels.flashbias_attn import (
        flashbias_attention_fwd, flashbias_attention_ragged_fwd,
        flashbias_attention_torch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    worst = {}
    check = functools.partial(check_kernel, worst)

    # prefill kernel: the serving path's shape, then off-path modes
    cases = [("flashbias_attention_fwd path B4 H64 N512 D32 bf16 alibi "
              "causal", 4, 64, 64, 512, 32, torch.bfloat16, "alibi",
              "causal", True)]
    for dtype in (torch.float32, torch.bfloat16):
        for bias in ("alibi", "phi", "none"):
            for mask in ("causal", "local", "none"):
                cases.append((f"flashbias_attention_fwd GQA4:2 N200 D160 "
                              f"{str(dtype)[6:]} {bias} {mask}", 2, 4, 2,
                              200, 160, dtype, bias, mask, False))
    cases.append(("flashbias_attention_fwd GQA8:2 N130 D64 f32 alibi local",
                  1, 8, 2, 130, 64, torch.float32, "alibi", "local", False))
    # the bf16 body off its tiles: N off the 64-row tile at the path's D,
    # D 40 (k-steps of 16 zero-padded, v's 32-column panel cut) and rank 4;
    # grids under 264 blocks split each block's kv tiles over two
    # warpgroups, larger ones take one
    cases += [("flashbias_attention_fwd N130 D32 bf16 alibi causal", 2, 8,
               8, 130, 32, torch.bfloat16, "alibi", "causal", False),
              ("flashbias_attention_fwd GQA4:2 N200 D40 bf16 phi local", 2,
               4, 2, 200, 40, torch.bfloat16, "phi", "local", False),
              ("flashbias_attention_fwd N77 D40 bf16 alibi none", 2, 4, 4,
               77, 40, torch.bfloat16, "alibi", "none", False),
              # a grid of 512 blocks: one warpgroup per block, with phi
              ("flashbias_attention_fwd B4 H16 N512 D64 bf16 phi causal", 4,
               16, 16, 512, 64, torch.bfloat16, "phi", "causal", False)]
    for name, b, h, kvh, n, d, dtype, bias, mask, path in cases:
        q, k, v, extra = prefill_inputs(gen, b, h, kvh, n, d, dtype, bias)
        kw = dict(scale=d ** -0.5, mask_kind=mask, window=48, **extra)
        before = flashbias_attention_fwd.tensor_core_launches
        check(name, flashbias_attention_fwd(q, k, v, **kw),
              flashbias_attention_torch(q, k, v, **kw), dtype, path,
              flashbias_attention_fwd, before)

    # decode kernels (3 and 4), each case through ``decode_case``
    decode = functools.partial(decode_case, gen, check)

    # contiguous: the serving path's shape (writing the row), phi mode and
    # GQA, then lengths across the split boundaries (SPLIT_LENGTHS)
    cases = [("flash_decode_fwd path B4 KVH64 G1 S2048 D32 bf16 alibi write",
              4, 64, 1, 2048, 32, torch.bfloat16, "alibi",
              [0, 1, 777, 2048], True, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for bias in ("alibi", "phi", "none"):
            cases.append((f"flash_decode_fwd GQA G4 S1024 D160 "
                          f"{str(dtype)[6:]} {bias}", 4, 2, 4, 1024, 160,
                          dtype, bias, [0, 1, 333, 1024], False, False))
    cases.append(("flash_decode_fwd MHA G1 S512 D32 f32 phi", 3, 8, 1, 512,
                  32, torch.float32, "phi", [512, 5, 0], False, False))
    cases += [(f"flash_decode_fwd splits B{len(SPLIT_LENGTHS)} KVH64 G1 "
               f"S2048 D32 bf16 alibi write", len(SPLIT_LENGTHS), 64, 1,
               2048, 32, torch.bfloat16, "alibi", SPLIT_LENGTHS, False, True),
              ("flash_decode_fwd splits GQA G4 S2048 D160 f32 alibi write",
               len(SPLIT_LENGTHS), 2, 4, 2048, 160, torch.float32, "alibi",
               SPLIT_LENGTHS, False, True),
              ("flash_decode_fwd splits GQA G4 S2048 D160 bf16 phi write",
               len(SPLIT_LENGTHS), 2, 4, 2048, 160, torch.bfloat16, "phi",
               SPLIT_LENGTHS, False, True)]
    for name, b, kvh, g, s, d, dtype, bias, lengths, path, write in cases:
        q, k, v, lens, extra = decode_inputs(gen, b, kvh, g, s, d, dtype,
                                             bias, lengths)
        decode(name, flash_decode_fwd, flash_decode_torch, q, k, v, lens, (),
               dict(scale=d ** -0.5, **extra), dtype, path, write)

    # paged: the paged serving path's shape (phi mode against the shared
    # [1, pos] slab, page size 16, writing the row), then GQA, the other
    # bias modes, a per-kv-head slab and page size 48, then lengths across
    # the split boundaries, one row's write block the sentinel (the write
    # dropped, the clamped page's old row read; that page no row's own)
    cases = [(f"flash_decode_paged_fwd path B4 KVH64 G1 D32 ps{PAGE} bf16 "
              f"alibi-slab write", 4, 64, 1, 32, PAGE, torch.bfloat16,
              "alibi_slab", [0, 1, 777, 2048], True, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for bias in ("alibi_slab", "phi", "phi_kvh", "alibi", "none"):
            cases.append((f"flash_decode_paged_fwd GQA G4 D160 ps48 "
                          f"{str(dtype)[6:]} {bias}", 4, 2, 4, 160, 48,
                          dtype, bias, [0, 1, 333, 1024], False, False))
    cases.append(("flash_decode_paged_fwd MHA G1 D32 ps8 f32 phi_kvh", 3, 8,
                  1, 32, 8, torch.float32, "phi_kvh", [200, 5, 0], False,
                  False))
    cases += [(f"flash_decode_paged_fwd splits B{len(SPLIT_LENGTHS)} KVH64 G1 "
               f"D32 ps{PAGE} bf16 alibi-slab write", len(SPLIT_LENGTHS), 64,
               1, 32, PAGE, torch.bfloat16, "alibi_slab", SPLIT_LENGTHS,
               False, True),
              ("flash_decode_paged_fwd splits GQA G4 D160 ps48 f32 phi write "
               "sentinel", len(SPLIT_LENGTHS), 2, 4, 160, 48, torch.float32,
               "phi", SPLIT_LENGTHS, False, "sentinel")]
    for name, b, kvh, g, d, ps, dtype, bias, lengths, path, write in cases:
        q, kp, vp, lens, pt, extra = paged_inputs(gen, rng, b, kvh, g, d, ps,
                                                  dtype, bias, lengths)
        if write == "sentinel":
            pt = sentinel_write(pt, lengths.index(65), 64 // ps,
                                -(-max(lengths) // ps), kp.shape[1])
        decode(name, flash_decode_paged_fwd, flash_decode_paged_torch, q, kp,
               vp, lens, (pt,), dict(scale=d ** -0.5, **extra), dtype, path,
               bool(write))
    # the model groups off the powers of two and the wide ones: llama4's 6
    # (MG 8, two rows masked), command-r-plus's 12 (phase 20's shape) and
    # 16, the MG = 16 body's top
    for g in (6, 12, 16):
        wide_group_decode(gen, rng, check, g)

    # ragged attention kernel (kernel 2): the Pairformer path's shape (4
    # slots, H = KVH 4, N = M = 384, D = Dv = R = 96, bf16 q/k/v, float32
    # factors, no mask), then off-path: float32, lengths off the 64-key
    # tile, a whole batch at length 0, rank 8, causal, ALiBi slopes, GQA.
    # Rows of length 0 must come out exactly 0.
    bf, f32 = torch.bfloat16, torch.float32
    path_lens = [PAIR_MAX_LEN, 200, 1, 0]
    cases = [("flashbias_attention_ragged_fwd path B4 H4 N384 D96 R96 bf16 "
              "phi", 4, 4, 4, 384, 96, 96, bf, "phi", "none", path_lens,
              True),
             ("flashbias_attention_ragged_fwd B4 H4 N384 D96 R96 f32 phi",
              4, 4, 4, 384, 96, 96, f32, "phi", "none", path_lens, False),
             ("flashbias_attention_ragged_fwd lengths 333/77/5/0 bf16 phi",
              4, 4, 4, 384, 96, 96, bf, "phi", "none", [333, 77, 5, 0],
              False),
             ("flashbias_attention_ragged_fwd all lengths 0 bf16 phi", 4, 4,
              4, 384, 96, 96, bf, "phi", "none", [0, 0, 0, 0], False),
             ("flashbias_attention_ragged_fwd R8 D64 f32 phi", 4, 4, 4, 200,
              64, 8, f32, "phi", "none", [200, 130, 63, 0], False),
             ("flashbias_attention_ragged_fwd causal bf16 phi", 4, 4, 4, 384,
              96, 96, bf, "phi", "causal", path_lens, False),
             ("flashbias_attention_ragged_fwd GQA8:2 f32 alibi causal", 2, 8,
              2, 130, 64, 0, f32, "alibi", "causal", [130, 65], False),
             ("flashbias_attention_ragged_fwd GQA8:2 bf16 alibi none", 4, 8,
              2, 256, 32, 0, bf, "alibi", "none", [256, 100, 0, 31], False)]
    for name, b, h, kvh, n, d, r, dtype, bias, mask, lengths, path in cases:
        q, k, v, extra = prefill_inputs(gen, b, h, kvh, n, d, dtype, bias,
                                        r=r)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        kw = dict(scale=d ** -0.5, mask_kind=mask)
        before = flashbias_attention_ragged_fwd.tensor_core_launches
        got = flashbias_attention_ragged_fwd(
            q, k, v, extra.get("phi_q"), extra.get("phi_k"),
            extra.get("slopes"), lens, **kw)
        check(name, got, flashbias_attention_torch(q, k, v, lengths=lens,
                                                   **kw, **extra),
              dtype, path, flashbias_attention_ragged_fwd, before)
        if bool(got[lens == 0].any()):
            raise AssertionError(f"{name}: rows of length 0 are not 0")
    return worst


# ---------------------------------------------------------------------------
# phases 3-5: full-width serving, paged serving and parity
# ---------------------------------------------------------------------------

def make_requests(seed: int, vocab: int):
    from repro_torch.serve import SamplingParams
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, PROMPT_MAX + 1, (8,))
    sampled = {2, 6}                 # one in each half of the arrivals
    return [(rng.integers(0, vocab, (int(n),)).astype(np.int32), NEW_TOKENS,
             SamplingParams(0.8, 40, seed=seed + i) if i in sampled
             else SamplingParams()) for i, n in enumerate(lens)]


def launch_counters() -> dict:
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_paged_fwd)
    from repro_torch.kernels.flashbias_attn import (
        flashbias_attention_fwd, flashbias_attention_ragged_fwd)
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd
    return {"flashbias_attention_fwd": flashbias_attention_fwd,
            "flash_decode_fwd": flash_decode_fwd,
            "flash_decode_paged_fwd": flash_decode_paged_fwd,
            "flashbias_attention_ragged_fwd": flashbias_attention_ragged_fwd,
            "ssd_scan_fwd": ssd_scan_fwd}


def drive_counted(engine, requests, frontends=None):
    """Drive ``requests`` (with ``frontends``, each one's frontend rows)
    through ``engine`` with every launch counter set to 0 just before and
    read just after; check every result."""
    import torch
    from repro_torch.launch.serve import drive
    counters = reset_counters()
    t0 = time.monotonic()
    rids = drive(engine, requests, frontends)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    budgets = [n for _, n, _ in requests]
    check_results(engine.model.cfg.name, engine, rids, budgets)
    return rids, launches, sum(budgets) / wall, wall


def phase_serve(seed: int):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, init_params
    from repro_torch.serve import ServeEngine

    full = get_config("gpt2_alibi_15b")
    check_width(full, (full.n_layers, full.d_model, full.heads_padded),
                (48, 1600, 64))
    cfg = full.replace(n_layers=N_LAYERS)
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    engine = ServeEngine(get_model(cfg), params, max_len=MAX_LEN,
                         n_slots=SLOTS, prefill_len=PROMPT_MAX,
                         device="cuda")
    del params                       # the engine holds its bf16 copy
    torch.cuda.synchronize()
    log("serve", f"{cfg.name}: {cfg.n_layers} layers, d_model "
                 f"{cfg.d_model}, {cfg.heads_padded} heads x "
                 f"{cfg.resolved_head_dim}, vocab {cfg.vocab_padded}; "
                 f"weights ready in {time.monotonic() - t0:.1f}s")
    requests = make_requests(seed, cfg.vocab)
    with observe(engine) as obs:
        rids, launches, tok_s, wall = drive_counted(engine, requests)
    first = {i: obs.first[rid] for i, rid in enumerate(rids)}
    stats = engine.stats()
    want = {"flashbias_attention_fwd": N_LAYERS * stats["prefill_waves"],
            "flash_decode_fwd": N_LAYERS * stats["decode_steps"],
            "flash_decode_paged_fwd": 0,
            "flashbias_attention_ragged_fwd": 0, "ssd_scan_fwd": 0}
    log("serve", f"{len(rids)} requests OK x {NEW_TOKENS} tokens in "
                 f"{wall:.2f}s ({tok_s:.1f} tok/s); "
                 f"{stats['prefill_waves']} prefill waves, "
                 f"{stats['decode_steps']} decode steps; launches {launches}")
    if launches != want or not launches["flash_decode_fwd"]:
        raise AssertionError(f"kernel launches {launches} != {want}")
    check_tensor_core("serve")
    return engine, requests, launches, tok_s, first


def phase_paged(engine, requests):
    """The same requests through a paged engine (page size 16, lazy
    reservation) on the same weights. The pool holds the first wave's
    prompt pages and one more: the first page grown takes the spare, the
    next finds the pool dry and preempts."""
    from repro_torch.serve import ServeEngine
    first = sum(-(-p.size // PAGE) for p, _, _ in requests[:SLOTS])
    paged = ServeEngine(engine.model, engine.backend.params, max_len=MAX_LEN,
                        n_slots=SLOTS, prefill_len=PROMPT_MAX,
                        page_size=PAGE, n_pages=first + 1,
                        pages_per_slot=MAX_LEN // PAGE, device="cuda")
    rids, launches, tok_s, wall = drive_counted(paged, requests)
    stats, pages = paged.stats(), paged.page_stats()
    want = {"flashbias_attention_fwd": N_LAYERS * stats["prefill_waves"],
            "flash_decode_fwd": 0,
            "flash_decode_paged_fwd": N_LAYERS * stats["decode_steps"],
            "flashbias_attention_ragged_fwd": 0, "ssd_scan_fwd": 0}
    log("paged", f"{len(rids)} requests OK x {NEW_TOKENS} tokens in "
                 f"{wall:.2f}s ({tok_s:.1f} tok/s); "
                 f"{stats['prefill_waves']} prefill waves, "
                 f"{stats['decode_steps']} decode steps; launches "
                 f"{launches}; pages {pages}")
    if launches != want or not launches["flash_decode_paged_fwd"]:
        raise AssertionError(f"kernel launches {launches} != {want}")
    check_tensor_core("paged")
    if pages["grown"] < 1 or pages["preemptions"] < 1:
        raise AssertionError(f"the pool of {pages['n_pages']} pages neither "
                             f"grew and preempted: {pages}")
    if pages["n_free"] != pages["n_pages"]:
        raise AssertionError(f"pages left in use after the drain: {pages}")
    return launches, tok_s, [paged.result(r) for r in rids]


def page_cap(longest: int) -> int:
    """The serve engine's page bound: pages of ``longest`` rounded up to a
    power of two."""
    need, cap = -(-longest // PAGE), 1
    while cap < need:
        cap *= 2
    return cap


def paged_copy(model, cache, lengths, extra: int):
    """A paged cache holding the contiguous wave ``cache``: each row gets
    the pages of its length plus ``extra`` positions, in a random order."""
    rng = np.random.default_rng(7)
    need = [-(-(int(n) + extra) // PAGE) for n in lengths]
    n_pages = sum(need) + 2
    order = rng.permutation(n_pages)
    tables = np.full((SLOTS, MAX_LEN // PAGE), n_pages, np.int64)
    for i, n in enumerate(need):
        tables[i, :n] = order[sum(need[:i]):sum(need[:i]) + n]
    paged = model.init_paged_cache(SLOTS, n_pages, PAGE, MAX_LEN // PAGE,
                                   device="cuda")
    return model.insert_paged(paged, cache, np.arange(SLOTS), tables)


PARITY_PAIRS = (("cuda", "torch"), ("paged_cuda", "paged_torch"),
                ("paged_cuda", "cuda"))


class RouteFeed:
    """MoE expert choices fed across the parity's paths, as its greedy
    tokens are: the contiguous kernel path's router calls
    (``lm._moe_route``) recorded in order, and replayed in the same order
    on the other paths, each with its own router probabilities gathered at
    the fed experts. A choice is a discontinuous function of the router's
    input: a near tie that bf16 rounding tips the other way sends a token
    to another expert, whose output differs by O(1) (top 1 replaces all of
    it), so without the feed the paths' gap measures routing ties, not the
    kernels. The choices the other paths would have made are counted where
    they differ: in order (``differ``) and as top-k sets (``set_differ``,
    the count ``phase_parity`` bounds with ROUTE_SET_SHARE)."""

    def __init__(self, route):
        self.route, self.calls, self.pos = route, [], 0
        self.differ = self.set_differ = self.total = 0

    def record(self, mp, x, cfg):
        out = self.route(mp, x, cfg)
        self.calls.append(out[2])
        return out

    def replay(self, mp, x, cfg):
        probs, _, own = self.route(mp, x, cfg)
        idx = self.calls[self.pos]
        self.pos += 1
        self.differ += int((own != idx).any(-1).sum())
        self.set_differ += int((own.sort(-1).values
                                != idx.sort(-1).values).any(-1).sum())
        self.total += own[..., 0].numel()
        gates = probs.gather(-1, idx)
        return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx

    def calling(self, name: str, fn):
        """``fn()`` on path ``name``: "cuda" records, the others replay."""
        from repro_torch.models import lm
        if name == "cuda":
            self.calls.clear()
        self.pos = 0
        with patched(lm, "_moe_route",
                     self.record if name == "cuda" else self.replay):
            return fn()


def phase_parity(engine, requests, *, max_len: int = MAX_LEN,
                 steps: int = 4, tol: float | None = LOGIT_TOL,
                 trace: bool = True, label: str = "parity",
                 frontends=None):
    """The first wave again, on the card: prefill (right-padded to
    PROMPT_MAX, or the longest prompt's pages), then ``steps`` greedy decode
    steps fed the contiguous kernel path's tokens, through four paths —
    contiguous and paged caches, each with impl="cuda" and impl="torch".
    The kernel path is held against the plain path on both caches, and the
    paged kernel path against the contiguous one, within ``tol`` (None:
    LOGIT_ULPS bf16 ulps at the plain path's top |logit|, at least
    LOGIT_TOL); MoE paths
    are fed the contiguous kernel path's expert choices (``RouteFeed``); the
    kernel paths launched kernel 1 (and kernel 5, where the model has SSM
    layers) once per layer and the decode kernels once per layer and step
    (kernel 3 not where the contiguous cache is a ring, which decode
    attends in plain torch). Then, with ``trace``, decode steps of both
    kernel paths are traced: returns (traces, the decode lengths). With
    ``frontends`` (each request's frontend rows) the wave's prompts open
    with them, and the lengths count them."""
    import torch
    from repro_torch.models import get_model, lm

    cfg = engine.model.cfg
    params = engine.backend.params
    wave = requests[:SLOTS]
    lengths = np.array([p.size for p, _, _ in wave], np.int32)
    toks = np.zeros((SLOTS, wave_width(requests)), np.int64)
    for i, (p, _, _) in enumerate(wave):
        toks[i, :p.size] = p
    batch = {"tokens": torch.as_tensor(toks, device="cuda")}
    if frontends is not None:
        batch["frontend"] = torch.as_tensor(np.stack(frontends[:SLOTS]),
                                            device="cuda")
        lengths += cfg.frontend_len
    lens = torch.as_tensor(lengths, device="cuda")
    models = {impl: get_model(cfg.replace(attn_impl=impl))
              for impl in ("cuda", "torch")}
    worst = {pair: 0.0 for pair in PARITY_PAIRS}
    agree = {pair: 0 for pair in PARITY_PAIRS}
    logits, caches = {}, {}
    top_logit = 0.0
    feed = RouteFeed(lm._moe_route)

    def call(name, fn):
        return feed.calling(name, fn) if cfg.family == "moe" else fn()

    counters = reset_counters()
    with torch.no_grad():
        for impl, m in models.items():
            logits[impl], caches[impl] = call(impl, lambda: m.prefill(
                params, batch, max_len=max_len, lengths=lens))
            logits[f"paged_{impl}"] = logits[impl]
            caches[f"paged_{impl}"] = paged_copy(m, caches[impl], lengths,
                                                 steps + TRACE_STEPS + 1)
        for step in range(steps + 1):
            top = {}
            for name, lg in logits.items():
                lg = lg[:, 0, :cfg.vocab].float()
                top[name] = (lg, lg.argmax(-1))
            top_logit = max(top_logit, float(top["torch"][0].abs().max()))
            parts = []
            for a, b in PARITY_PAIRS:
                err = float((top[a][0] - top[b][0]).abs().max())
                same = int((top[a][1] == top[b][1]).sum())
                worst[(a, b)] = max(worst[(a, b)], err)
                agree[(a, b)] += same
                parts.append(f"{a} vs {b} {err:.3e} ({same}/{SLOTS})")
            log(label, f"{'prefill' if step == 0 else f'decode {step}'}: "
                       f"max |logits gap| (greedy agree) " + "; ".join(parts))
            if step == steps:
                break
            nxt = top["cuda"][1][:, None]
            cap = page_cap(int(lengths.max()) + step + 2)
            for name in logits:
                m = models[name.removeprefix("paged_")]
                kw = {"max_pages": cap} if name.startswith("paged") else {}
                logits[name], caches[name] = call(name, lambda: m.decode(
                    params, caches[name], nxt, **kw))
        torch.cuda.synchronize()
        decode_lengths = caches["cuda"]["length"].clone()
    launched = {name: fn.launches for name, fn in counters.items()}
    layers = cfg.n_layers
    ring = "k" in caches["cuda"] and lm._is_ring(cfg, caches["cuda"]["k"][0])
    want = {name: 0 for name in launched}
    want.update(flashbias_attention_fwd=layers,
                flash_decode_fwd=0 if ring else layers * steps,
                flash_decode_paged_fwd=layers * steps)
    if "ssm_h" in caches["cuda"]:
        want["ssd_scan_fwd"] = layers
    if tol is None:
        tol = max(LOGIT_TOL, LOGIT_ULPS * float(bf16_ulp(
            torch.tensor(top_logit))))
    log(label, f"max |logit| of the plain path {top_logit:.3f}; tol {tol}")
    for a, b in PARITY_PAIRS:
        log(label, f"{a} vs {b}: worst |logits| gap {worst[(a, b)]:.3e} "
                   f"(tol {tol}); greedy agreement {agree[(a, b)]}/"
                   f"{(steps + 1) * SLOTS}")
        if not worst[(a, b)] <= tol:
            raise AssertionError(f"{label}: {a} and {b} paths disagree: "
                                 f"{worst[(a, b)]:.3e}")
    log(label, f"kernel paths' launches {launched}")
    if feed.total:
        share, limit = feed.set_differ / feed.total, ROUTE_SET_SHARE[cfg.name]
        log(label, f"MoE: every path fed the contiguous kernel path's "
                   f"expert choices; the other paths' own choices differed "
                   f"for {feed.differ} of {feed.total} token routings, as "
                   f"top-k sets for {feed.set_differ} ({share:.4%}; limit "
                   f"{limit:.2%})")
        if not share <= limit:
            raise AssertionError(f"{label}: {share:.4%} of the routings "
                                 f"chose other experts (limit {limit:.2%})")
    if launched != want:
        raise AssertionError(f"{label}: launches {launched} != {want}")
    for name in ("torch", "paged_torch"):
        del caches[name]
    torch.cuda.empty_cache()
    if not trace:
        del caches
        torch.cuda.empty_cache()
        return None, decode_lengths
    cap = page_cap(int(lengths.max()) + steps + TRACE_STEPS + 1)
    traces = trace_decode(models["cuda"], params, nxt, {
        "contiguous": (caches["cuda"], {}),
        "paged": (caches["paged_cuda"], {"max_pages": cap})})
    del caches
    torch.cuda.empty_cache()
    return traces, decode_lengths


INDEX_KERNELS = ("index", "gather", "scatter")
TRACE_ROUNDS, ROUND_STEPS = 6, 3
# steps per path: the timed rounds, then each profile try's warm-up step
# and 3 profiled steps
TRACE_STEPS = TRACE_ROUNDS * ROUND_STEPS + PROFILE_TRIES * (1 + 3)


def trace_decode(model, params, tokens, paths: dict) -> dict:
    """Decode steps of the kernel path on each cache of ``paths`` ({label:
    (cache, decode kwargs)}): timed on the host clock in alternating rounds
    of 3 steps (A B B A ..., each step ending in a synchronize), so both
    see the same host; then 3 steps each under torch.profiler for the
    device's busy time per step (the sum of its kernels' and copies'
    durations), the kernels that hold it longest, and the indexing kernels
    (gathers and scatters of cache rows, page ids and the factor slab)."""
    import torch

    labels = list(paths)
    caches = {label: cache for label, (cache, _) in paths.items()}
    walls = {label: [] for label in labels}

    def steps(label, n):
        kw = paths[label][1]
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            _, caches[label] = model.decode(params, caches[label], tokens,
                                            **kw)
            torch.cuda.synchronize()
            walls[label].append((time.monotonic() - t0) * 1e3)

    traces = {}
    with torch.no_grad():
        for r in range(TRACE_ROUNDS):
            for label in (labels if r % 2 == 0 else labels[::-1]):
                steps(label, ROUND_STEPS)
        for label in labels:
            def step():
                _, caches[label] = model.decode(params, caches[label],
                                                tokens, **paths[label][1])
            kernels = profiled(step, 3, uniform=False)
            step_ms = float(np.median(walls[label]))
            busy_ms = sum(device_us(e) for e in kernels) / 3 / 1e3
            index = [e for e in kernels
                     if any(w in e.key.lower() for w in INDEX_KERNELS)]
            traces[label] = t = {
                "step_ms": step_ms, "busy_ms": busy_ms,
                "idle_share": 1 - busy_ms / step_ms,
                "index_calls": sum(e.count for e in index) // 3,
                "index_ms": sum(device_us(e) for e in index) / 3 / 1e3}
            log("trace", f"{label} decode step {step_ms:.3f} ms on the host "
                         f"clock (median of {len(walls[label])}, rounds "
                         f"alternating with the other path); device busy "
                         f"{busy_ms:.3f} ms/step, idle share "
                         f"{t['idle_share']:.3f}; indexing kernels "
                         f"{t['index_calls']} calls, {t['index_ms']:.3f} "
                         f"ms/step")
            for e in sorted(kernels, key=device_us, reverse=True)[:8]:
                log("trace", f"  {device_us(e) / 3 / 1e3:8.3f} ms/step "
                             f"{e.count // 3:5d} calls/step  {e.key[:90]}")
            for e in host_ops(step, 3):
                log("trace", f"  host {e.self_cpu_time_total / 3 / 1e3:8.3f} "
                             f"ms/step {e.count // 3:5d} calls/step  "
                             f"{e.key[:70]}")
    return traces


# ---------------------------------------------------------------------------
# phase 6: times and bounds
# ---------------------------------------------------------------------------

def decode_kernel_times(gen, kvh: int, g: int, d: int, decode_lengths,
                        slopes, s: int, paged_only: bool = False,
                        label: str = "times"):
    """Kernels 3 and 4 at one decode shape (B rows at ``decode_lengths``,
    ``kvh`` kv heads of ``g`` q heads, D ``d``, bf16, each call writing the
    new token's row as the serve path does): each call first held against
    its plain version on the same tensors (``decode_case``, ``tolerance()``),
    then timed with its plain version, the library call and the bound:
    ({name: times}, {name: the kernel's call}).

    Contiguous: ALiBi ``slopes`` (H,) in the kernel, caches of ``s`` rows;
    library SDPA with a float ALiBi mask. Paged: phi mode against the
    shared [1, pos] slab, page size PAGE, pages in random order, a table
    ``s // PAGE`` wide (the serve engine's); library: gather each row's
    pages, then SDPA with the float mask (two calls). The bounds count the
    live rows read once, q, phi_q and the output, the lengths and page ids,
    and the row write (k_new and v_new read once and written once); the
    library calls write no row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_paged_fwd,
                                                  flash_decode_paged_torch,
                                                  flash_decode_torch)
    bf = torch.bfloat16
    b, h, scale = len(decode_lengths), kvh * g, d ** -0.5
    gqa = {"enable_gqa": True} if g > 1 else {}
    qd = torch.randn((b, kvh, g, d), generator=gen, device="cuda").to(bf)
    kc, vc = (torch.randn((b, kvh, s, d), generator=gen,
                          device="cuda").to(bf) for _ in range(2))
    lens = torch.as_tensor(decode_lengths, device="cuda").to(
        torch.int32).contiguous()
    kwd = dict(slopes=slopes.reshape(kvh, g), scale=scale)
    kpos = torch.arange(s, device="cuda")
    dmask = slopes[None, :, None, None] * (
        kpos[None, None, None, :] - (lens - 1)[:, None, None, None]).float()
    dmask = dmask.masked_fill(
        kpos[None, None, None, :] >= lens[:, None, None, None],
        -torch.inf).to(bf)
    live = int(lens.sum())
    new = {"k_new": torch.randn((b, kvh, d), generator=gen,
                                device="cuda").to(bf),
           "v_new": torch.randn((b, kvh, d), generator=gen,
                                device="cuda").to(bf)}
    row_bytes = 2 * 2 * b * kvh * d * 2
    out, calls = {}, {}
    shape = f"B{b} KVH{kvh} G{g} D{d} bf16"
    check = functools.partial(decode_case, gen, functools.partial(
        check_kernel, {}, label=label))
    if not paged_only:
        check(f"flash_decode_fwd {shape} alibi write", flash_decode_fwd,
              flash_decode_torch, qd, kc, vc, lens, (), kwd, bf, False, True,
              new)
        bytes_ = (live * kvh * 2 * d * 2 + 2 * b * h * d * 2 + b * 4
                  + h * 4 + row_bytes)
        flops = live * h * 4 * d
        calls["flash_decode_fwd"] = (lambda: flash_decode_fwd(
            qd, kc, vc, lens, **kwd, **new))
        out["flash_decode_fwd"] = dict(
            ms=device_ms(calls["flash_decode_fwd"]),
            plain_ms=device_ms(lambda: flash_decode_torch(qd, kc, vc, lens,
                                                          **kwd, **new)),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qd.reshape(b, h, 1, d), kc, vc, attn_mask=dmask,
                scale=scale, **gqa)),
            **bound(bytes_, flops))

    lengths = [int(n) for n in lens.tolist()]
    qp, kp, vp, lens_p, pt, extra = paged_inputs(
        gen, np.random.default_rng(2), b, kvh, g, d, PAGE, bf, "alibi_slab",
        lengths)
    pt = widen_table(pt, max(s // PAGE, pt.shape[1]), kp.shape[1])
    n_live = -(-max(lengths) // PAGE)
    last = (lens_p.long() - 1).clamp(min=0) // PAGE
    pages = pt.long()[:, :n_live].gather(
        1, torch.minimum(torch.arange(n_live, device="cuda")[None],
                         last[:, None]))
    kvp = torch.stack([kp, vp])                  # (2, KVH, n_pages, ps, d)
    pmask = dmask[..., :n_live * PAGE].contiguous()

    def gather_sdpa():
        kv = kvp[:, :, pages].reshape(2, kvh, b, n_live * PAGE, d)
        return F.scaled_dot_product_attention(
            qp.reshape(b, h, 1, d), kv[0].transpose(0, 1),
            kv[1].transpose(0, 1), attn_mask=pmask, scale=scale, **gqa)

    n_pages_read = sum(-(-n // PAGE) for n in lengths)
    bytes_ = (live * kvh * 2 * d * 2 + live * 2 * 4 + 2 * b * h * d * 2
              + b * h * 2 * 4 + b * 4 + n_pages_read * 4 + row_bytes)
    flops = live * h * (4 * d + 4)
    check(f"flash_decode_paged_fwd {shape} ps{PAGE} alibi-slab write",
          flash_decode_paged_fwd, flash_decode_paged_torch, qp, kp, vp, lens_p,
          (pt,), dict(scale=scale, **extra), bf, False, True, new)
    calls["flash_decode_paged_fwd"] = (lambda: flash_decode_paged_fwd(
        qp, kp, vp, lens_p, pt, scale=scale, **extra, **new))
    out["flash_decode_paged_fwd"] = dict(
        ms=device_ms(calls["flash_decode_paged_fwd"]),
        plain_ms=device_ms(lambda: flash_decode_paged_torch(
            qp, kp, vp, lens_p, pt, scale=scale, **extra, **new)),
        library_ms=device_ms(gather_sdpa),
        **bound(bytes_, flops))
    return out, calls


def prefill_kernel_times(gen, h: int, kvh: int, n: int, d: int, slopes,
                         window: int = 0, label: str = "times"):
    """Kernel 1 at one prefill shape (SLOTS rows of ``n`` positions, ``h``
    heads over ``kvh`` kv heads, D ``d``, bf16, ALiBi ``slopes`` (H,),
    causal, or local with ``window``), first held against its plain version
    on the same tensors (``check_kernel``: ``tolerance()``, finite, the
    tensor-core body), then timed with its plain version, SDPA with the
    ALiBi + mask as a float mask, and the bound (q, k, v, o once; the
    scores the mask keeps): ({ms, plain_ms, library_ms, bound}, the
    kernel's call)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flashbias_attn import (
        flashbias_attention_fwd, flashbias_attention_torch)
    bf, b, scale = torch.bfloat16, SLOTS, d ** -0.5
    q = torch.randn((b, h, n, d), generator=gen, device="cuda").to(bf)
    k, v = (torch.randn((b, kvh, n, d), generator=gen, device="cuda").to(bf)
            for _ in range(2))
    kw = dict(slopes=slopes, scale=scale,
              mask_kind="local" if window else "causal", window=window)
    pos = torch.arange(n, device="cuda")
    rel = pos[None, :] - pos[:, None]
    keep = (rel <= 0) & ((rel > -window) if window else True)
    mask = (slopes[:, None, None] * rel[None]).masked_fill(
        ~keep[None], -torch.inf).to(bf)[None]
    pairs = local_pairs(n, window) if window else n * (n + 1) // 2
    bytes_ = (2 * b * h * n * d + 2 * b * kvh * n * d) * 2 + h * 4
    gqa = {"enable_gqa": True} if kvh != h else {}

    def kernel():
        return flashbias_attention_fwd(q, k, v, **kw)
    before = flashbias_attention_fwd.tensor_core_launches
    check_kernel({}, f"flashbias_attention_fwd B{b} H{h} KVH{kvh} N{n} D{d} "
                     f"bf16 {kw['mask_kind']}", kernel(),
                 flashbias_attention_torch(q, k, v, **kw), bf,
                 wrapper=flashbias_attention_fwd, before=before, label=label)
    return dict(
        ms=device_ms(kernel),
        plain_ms=device_ms(lambda: flashbias_attention_torch(q, k, v, **kw)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, **gqa)),
        **bound(bytes_, b * h * pairs * 4 * d)), kernel


def log_prefill_times(label: str, shape: str, t: dict, card: str) -> None:
    log(label, f"flashbias_attention_fwd at {shape} (device time per "
               f"call): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
               f"ms, library (SDPA, ALiBi and mask as a float mask) "
               f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
               f"({t['bound_by']}) [{card}]")


def wave_width(requests) -> int:
    """The first wave's padded width: PROMPT_MAX, or its longest prompt's
    pages where that is longer."""
    longest = max(p.size for p, _, _ in requests[:SLOTS])
    return max(PROMPT_MAX, -(-longest // PAGE) * PAGE)


def model_kernel_times(label: str, cfg, params, n: int, lengths, card: str,
                       window: int = 0, paged_only: bool = False) -> dict:
    """Kernel 1 at the config's prefill shape (SLOTS x ``n``) and kernels 3
    and 4 (or 4 alone) at its decode shape (``lengths``), each checked
    against its plain version, then timed with it, the library call and
    the bound, logged: {name: times}."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    slopes = params["layers"]["attn"]["slopes"][0].float()
    h, kvh, d = cfg.heads_padded, cfg.kv_heads_padded, cfg.resolved_head_dim
    t1, _ = prefill_kernel_times(gen, h, kvh, n, d, slopes, window, label)
    log_prefill_times(label, f"B{SLOTS} H{h} KVH{kvh} N{n} D{d} bf16 "
                      f"{'local' if window else 'causal'}", t1, card)
    times, _ = decode_kernel_times(gen, kvh, cfg.kv_groups, d, lengths,
                                   slopes, MAX_LEN, paged_only=paged_only,
                                   label=label)
    log_decode_times(label, f"B{SLOTS} KVH{kvh} G{cfg.kv_groups} D{d} bf16, "
                     f"lengths {list(lengths)}", times, card)
    return {"flashbias_attention_fwd": t1, **times}


def phase_times(engine, decode_lengths, card: str):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    slopes = engine.backend.params["layers"]["attn"]["slopes"][0].float()
    h, d = slopes.shape[0], 32
    # prefill kernel at the path shape: alibi + causal, bf16
    times, kernel = prefill_kernel_times(gen, h, h, PROMPT_MAX, d, slopes)
    out = {"flashbias_attention_fwd": times}
    events = {"flashbias_attention_fwd": event_ms(kernel)}

    # decode kernels at the path shapes, this run's lengths
    times, kernels = decode_kernel_times(gen, h, 1, d, decode_lengths,
                                         slopes, MAX_LEN)
    out.update(times)
    events.update({name: event_ms(fn) for name, fn in kernels.items()})
    library = {"flashbias_attention_fwd": "SDPA, dense float mask",
               "flash_decode_fwd": "SDPA, float mask, no row write",
               "flash_decode_paged_fwd": "page gather + SDPA with a float "
                                         "mask, two calls, no row write"}
    for name, t in out.items():
        log("times", f"{name} (device time per call): kernel "
                     f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                     f"library ({library[name]}) {t['library_ms']:.4f} ms, "
                     f"bound "
                     f"{t['bound_ms']:.4f} ms ({t['bound_by']}); kernel "
                     f"between CUDA events, host gaps included, "
                     f"{events[name]:.4f} ms [{card}]")
    return out


# ---------------------------------------------------------------------------
# phases 6a-6b: chunked prefill and prefix caching
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def observe(engine):
    """Record, while the block runs, each request's first-token logits (the
    float32 row its admission wave or its final chunk samples from, the
    first time a rid emits; kept on the card) in ``.first``, the host time
    each rid was first admitted in ``.admitted``, and every chunk call and
    decode step of the backend as (engine step, "chunk" | "decode", host
    ms, each ending in a synchronize) in ``.steps``."""
    import torch
    be = engine.backend
    vocab = engine.model.cfg.vocab
    obs = argparse.Namespace(first={}, admitted={}, steps=[])
    owner: dict = {}
    sample, admit, chunk, step = (be._sample, be.admit, be.prefill_step,
                                  be.step)

    def rec_sample(logits2d, mask):
        for slot in np.nonzero(mask)[0]:
            rid = owner.get(int(slot))
            if rid is not None and rid not in obs.first:
                obs.first[rid] = logits2d[slot, :vocab].float().clone()
        return sample(logits2d, mask)

    def owned(fn, slots_of, kind=None):
        def call(*args):
            owner.clear()
            owner.update(slots_of(*args))
            torch.cuda.synchronize()
            t0 = time.monotonic()
            try:
                return fn(*args)
            finally:
                owner.clear()
                torch.cuda.synchronize()
                if kind is not None:
                    obs.steps.append((engine.step_idx, kind,
                                      (time.monotonic() - t0) * 1e3))
        return call

    def admitted(wave, slots):
        for r in wave:
            obs.admitted.setdefault(r.rid, time.monotonic())
        return {s: r.rid for s, r in zip(slots, wave)}

    be._sample = rec_sample
    be.admit = owned(admit, admitted)
    be.prefill_step = owned(chunk, lambda: {
        s: p.req.rid for s, p in be._pending.items()}, "chunk")
    be.step = owned(step, lambda live: {}, "decode")
    try:
        yield obs
    finally:
        del be._sample, be.admit, be.prefill_step, be.step


def first_gaps(label, got: dict, want: dict, tol: float) -> None:
    """Each request's first-token logits (``got``, by request index)
    against the whole-prompt engine's (``want``): logged with the greedy
    agreement; fails over ``tol``."""
    gaps = {i: float((got[i] - want[i]).abs().max()) for i in want}
    agree = sum(int(got[i].argmax() == want[i].argmax()) for i in want)
    worst = max(gaps.values())
    log(label, f"first-token logits against the whole-prompt engine's: "
               f"max |gap| {worst:.3e} (tol {tol}; per request "
               f"{', '.join(f'{g:.3e}' for g in gaps.values())}); greedy "
               f"agreement {agree}/{len(gaps)}")
    if not worst <= tol:
        raise AssertionError(f"{label}: first-token logits gap {worst:.3e} "
                             f"over {tol}")


def drive_schedule(engine, traffic, arrivals: dict):
    """Submit ``traffic`` (prompt, new tokens, sampling) by ``arrivals``
    ({engine step: [indices]}, key None up front) and step the engine until
    it drains. Returns the rids in traffic order and each request's host
    times of submission and first token (s, by traffic index)."""
    rids, t_sub, t_first = {}, {}, {}

    def submit(i):
        p, n, sp = traffic[i]
        t_sub[i] = time.monotonic()
        rids[i] = engine.submit(p, n, sampling=sp, on_token=lambda _, i=i:
                                t_first.setdefault(i, time.monotonic()))

    for i in arrivals.get(None, ()):
        submit(i)
    step = 0
    while len(rids) < len(traffic) or len(engine.scheduler) \
            or engine.occupancy:
        for i in arrivals.get(step, ()):
            submit(i)
        engine.step()
        step += 1
    return [rids[i] for i in range(len(traffic))], t_sub, t_first


def check_results(label, engine, rids, budgets) -> None:
    """Every request ended OK with its full budget of in-vocabulary ids."""
    from repro_torch.serve import OK
    vocab = engine.model.cfg.vocab
    for rid, n in zip(rids, budgets):
        rec = engine.result(rid)
        if rec.status != OK or rec.size != n:
            raise AssertionError(f"{label}: request {rid}: {rec!r}")
        if rec.min() < 0 or rec.max() >= vocab:
            raise AssertionError(f"{label}: request {rid}: token ids out "
                                 f"of range")


def check_launches(label, engine, decode: str) -> dict:
    """The decode kernel launched layers x decode steps since the counters
    were set to 0, and no other kernel (a chunked engine runs no
    whole-prompt wave)."""
    launches = {name: fn.launches for name, fn in launch_counters().items()}
    want = {name: 0 for name in launches}
    want[decode] = engine.model.cfg.n_layers * engine.stats()["decode_steps"]
    if launches != want or not want[decode]:
        raise AssertionError(f"{label}: kernel launches {launches} != "
                             f"{want}")
    return launches


def long_requests(seed: int, vocab: int):
    from repro_torch.serve import SamplingParams
    rng = np.random.default_rng(seed + 300)
    return [(rng.integers(0, vocab, (n,)).astype(np.int32), NEW_TOKENS,
             SamplingParams()) for n in LONG_PROMPTS]


def phase_chunked(engine, requests, whole_first: dict, seed: int,
                  card: str) -> dict:
    """The serve phase's 8 requests plus two long prompts (LONG_PROMPTS)
    arriving while the others decode, through chunked engines (CHUNK
    tokens per step) on the same weights, contiguous and then paged. Every
    request OK; first-token logits within LOGIT_TOL of the whole-prompt
    engine's (the serve phase's for the 8, a whole-prompt wave's for the
    long two); the decode kernel launched N_LAYERS x decode steps and the
    prefill kernel never; a step ran a chunk and a decode together; paged,
    every page free after the drain. Then the chunk step, the decode step
    and the long prompt's first-token time against the whole-prompt wave's,
    on the host clock and as device busy."""
    import torch
    from repro_torch.serve import ServeEngine

    model, params = engine.model, engine.backend.params
    cfg = model.cfg
    longs = long_requests(seed, cfg.vocab)
    traffic = list(requests) + longs
    n_req = len(requests)
    # the launcher's staggering for the 8, the long two at steps 2 and 6
    arrivals = {None: list(range(SLOTS)), 0: [4], 1: [5], 2: [6, n_req],
                3: [7], 6: [n_req + 1]}

    # the long prompts' whole-prompt wave: one wave of SLOTS rows padded to
    # the longest, as a whole-prompt engine admits them
    toks = np.zeros((SLOTS, max(LONG_PROMPTS)), np.int64)
    lens = np.ones((SLOTS,), np.int32)
    for i, (p, _, _) in enumerate(longs):
        toks[i, :p.size], lens[i] = p, p.size
    batch = {"tokens": torch.as_tensor(toks, device="cuda")}
    lens_t = torch.as_tensor(lens, device="cuda")

    def wave():
        return model.prefill(params, batch, max_len=MAX_LEN, lengths=lens_t)

    reset_counters()
    with torch.no_grad():
        logits, cache = wave()
        del cache
        want = dict(whole_first)
        for i in range(len(longs)):
            want[n_req + i] = logits[i, 0, :cfg.vocab].float()
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            wave()
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
        wave_ms = float(np.median(walls[1:]))
        wave_busy, _ = profile_steps(wave, 1)
    torch.cuda.empty_cache()

    out = {"wave_ms": wave_ms, "wave_busy_ms": wave_busy}
    for mode in ("contiguous", "paged"):
        label = f"chunked-{mode}"
        kw = ({"page_size": PAGE, "pages_per_slot": MAX_LEN // PAGE}
              if mode == "paged" else {})
        eng = ServeEngine(model, params, max_len=MAX_LEN, n_slots=SLOTS,
                          prefill_chunk=CHUNK, device="cuda", **kw)
        reset_counters()
        t0 = time.monotonic()
        with observe(eng) as obs:
            rids, t_sub, t_first = drive_schedule(eng, traffic, arrivals)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        check_results(label, eng, rids, [n for _, n, _ in traffic])
        decode = "flash_decode_paged_fwd" if mode == "paged" else \
            "flash_decode_fwd"
        launches = check_launches(label, eng, decode)
        stats = eng.stats()
        chunk_at = {s for s, kind, _ in obs.steps if kind == "chunk"}
        decode_at = {s for s, kind, _ in obs.steps if kind == "decode"}
        mixed = len(chunk_at & decode_at)
        log(label, f"{len(rids)} requests OK (prompts "
                   f"{[p.size for p, _, _ in traffic]}, chunk {CHUNK}) in "
                   f"{wall:.2f}s; {stats['chunk_steps']} chunk steps, "
                   f"{stats['decode_steps']} decode steps, {mixed} engine "
                   f"steps with both; launches {launches}")
        if not mixed:
            raise AssertionError(f"{label}: no engine step ran a chunk and "
                                 f"a decode together")
        first_gaps(label, {i: obs.first[rid] for i, rid in enumerate(rids)},
                   want, LOGIT_TOL)
        if mode == "paged":
            pages = eng.page_stats()
            log(label, f"pages after the drain: {pages}")
            if pages["n_free"] != pages["n_pages"]:
                raise AssertionError(f"{label}: pages left in use: {pages}")
        chunk_ms = [ms for _, kind, ms in obs.steps if kind == "chunk"]
        dec_mixed = [ms for s, kind, ms in obs.steps
                     if kind == "decode" and s in chunk_at]
        dec_alone = [ms for s, kind, ms in obs.steps
                     if kind == "decode" and s not in chunk_at]
        last = n_req + 1                   # the longest prompt
        t = out[mode] = {
            "chunk_ms": float(np.median(chunk_ms)),
            "decode_ms": float(np.median(dec_alone)),
            "decode_mixed_ms": float(np.median(dec_mixed)),
            "ttft_s": t_first[last] - t_sub[last],
            "ttft_admitted_s": t_first[last] - obs.admitted[rids[last]]}
        # device busy of one chunk call (every row a full chunk) and one
        # decode step (one row frozen mid-prompt) on the engine's cache
        be = eng.backend
        ctoks = torch.as_tensor(np.stack([longs[i % 2][0][:CHUNK]
                                          for i in range(SLOTS)]),
                                device="cuda")
        offs = np.arange(SLOTS) * ((MAX_LEN - CHUNK) // SLOTS)
        clens, flens = np.full(SLOTS, CHUNK), np.full(SLOTS, -1)
        cache = be._cache
        dec = {"cache": {**cache, "length": torch.as_tensor(
            np.arange(SLOTS) * (MAX_LEN // (SLOTS + 1)), dtype=torch.int32,
            device="cuda")}}
        dkw = {"max_pages": MAX_LEN // PAGE} if mode == "paged" else {}
        tok1 = torch.zeros((SLOTS, 1), dtype=torch.int64, device="cuda")

        def chunk_call():
            model.prefill_chunk(params, cache, ctoks, offs, clens, flens,
                                max_pages=be._chunk_page_cap())

        def decode_call():
            _, dec["cache"] = model.decode(params, dec["cache"], tok1, **dkw)

        with torch.no_grad():
            t["chunk_busy_ms"], kernels = profile_steps(chunk_call, 3)
            t["decode_busy_ms"], _ = profile_steps(decode_call, 3)
        log(label, "chunk step: top device kernels:")
        for e in sorted(kernels, key=device_us, reverse=True)[:8]:
            log(label, f"  {device_us(e) / 3 / 1e3:8.3f} ms/step "
                       f"{e.count // 3:5d} calls/step  {e.key[:80]}")
        log(label, f"chunk step ({SLOTS} x {CHUNK}, {N_LAYERS} layers): "
                   f"{t['chunk_ms']:.3f} ms on the host clock (median of "
                   f"{len(chunk_ms)} in the drive), device busy "
                   f"{t['chunk_busy_ms']:.3f} ms; decode step "
                   f"{t['decode_ms']:.3f} ms alone / "
                   f"{t['decode_mixed_ms']:.3f} ms in a step with a chunk "
                   f"(medians of {len(dec_alone)} / {len(dec_mixed)}), "
                   f"device busy "
                   f"{t['decode_busy_ms']:.3f} ms; the {LONG_PROMPTS[1]}-token"
                   f" prompt's first token {t['ttft_s'] * 1e3:.1f} ms after "
                   f"its submission, {t['ttft_admitted_s'] * 1e3:.1f} ms "
                   f"after its admission, against a whole-prompt wave "
                   f"({SLOTS} x "
                   f"{max(LONG_PROMPTS)}) of {wave_ms:.1f} ms on the host "
                   f"clock, device busy {wave_busy:.1f} ms [{card}]")
        del eng, be, cache, dec
        torch.cuda.empty_cache()
    return out


def prefix_traffic(seed: int, vocab: int):
    """PREFIX_REQUESTS requests that share a PREFIX_LEN-token prefix, with
    distinct tails of PREFIX_TAILS tokens (2 and 6 sampled), then one whose
    whole prompt is the prefix: a page-aligned hit, which copies on
    write."""
    from repro_torch.serve import SamplingParams
    rng = np.random.default_rng(seed + 400)
    common = rng.integers(0, vocab, (PREFIX_LEN,)).astype(np.int32)
    tails = rng.integers(PREFIX_TAILS[0], PREFIX_TAILS[1] + 1,
                         (PREFIX_REQUESTS,))
    sampled = {2, 6}
    out = [(np.concatenate([common, rng.integers(0, vocab, (int(n),))
                            .astype(np.int32)]), NEW_TOKENS,
            SamplingParams(0.8, 40, seed=seed + i) if i in sampled
            else SamplingParams()) for i, n in enumerate(tails)]
    return out + [(common.copy(), NEW_TOKENS, SamplingParams())]


def phase_prefix(engine, seed: int, card: str, label: str = "prefix") -> dict:
    """Shared-prefix traffic through a paged chunked engine with the prefix
    cache and through one without, on the same weights and schedule: the
    first SLOTS requests, stepped until their prompts have landed (a
    prompt's pages are indexed when its final chunk lands), then the rest.
    Streams bit-equal, greedy and sampled; tokens matched and pages copied
    on write; after the drain every page free or held by the index alone."""
    import torch
    from repro_torch.serve import ServeEngine

    model, params = engine.model, engine.backend.params
    traffic = prefix_traffic(seed, model.cfg.vocab)

    def run(prefix_cache: bool):
        name = label if prefix_cache else f"{label}-off"
        eng = ServeEngine(model, params, max_len=MAX_LEN, n_slots=SLOTS,
                          page_size=PAGE, pages_per_slot=MAX_LEN // PAGE,
                          prefill_chunk=CHUNK, prefix_cache=prefix_cache,
                          device="cuda")
        reset_counters()
        t0 = time.monotonic()
        rids = [eng.submit(p, n, sampling=sp)
                for p, n, sp in traffic[:SLOTS]]
        while eng.backend.prefill_pending() or len(eng.scheduler):
            eng.step()
        rids += [eng.submit(p, n, sampling=sp)
                 for p, n, sp in traffic[SLOTS:]]
        eng.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        check_results(name, eng, rids, [n for _, n, _ in traffic])
        launches = check_launches(name, eng, "flash_decode_paged_fwd")
        stats = eng.stats()
        log(name, f"{len(rids)} requests OK in {wall:.2f}s; "
                   f"{stats['chunk_steps']} chunk steps, "
                   f"{stats['decode_steps']} decode steps; launches "
                   f"{launches}")
        return eng, [eng.result(r) for r in rids]

    on, got = run(True)
    off, want = run(False)
    same = [bool(np.array_equal(a, b)) for a, b in zip(got, want)]
    pf = on.page_stats()["prefix"]
    pool, index = on.backend._pool, on.backend._prefix
    held = {e.page for e in index._entries.values()}
    refs = {pool.refcount(p) for p in held}
    log(label, f"streams equal to the unshared engine's: {sum(same)}/"
                  f"{len(same)} (greedy and sampled); prefix stats {pf}; "
                  f"after the drain {pool.n_free} pages free + {len(held)} "
                  f"held by the index of {pool.n_pages}, their refcounts "
                  f"{sorted(refs)} [{card}]")
    if not all(same):
        raise AssertionError(f"{label}: streams differ from the unshared "
                             f"engine's: {same}")
    if not (pf["tokens_matched"] > 0 and pf["cow_copies"] >= 1):
        raise AssertionError(f"{label}: no hit or no copy-on-write: {pf}")
    if pool.n_free + len(held) != pool.n_pages or refs - {1}:
        raise AssertionError(f"{label}: pages unaccounted for after the "
                             f"drain: {pool.n_free} free, {len(held)} "
                             f"index-held, refcounts {refs}")
    out = {"matched": pf["tokens_matched"], "cow": pf["cow_copies"],
           "steps": (on.stats()["chunk_steps"], off.stats()["chunk_steps"])}
    del on, off
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 7-9: Pairformer serving, parity and times
# ---------------------------------------------------------------------------

def make_complexes(seed: int):
    """8 complexes as (features, refinement steps, sampling): n_res drawn
    in [96, 384], the first at exactly 384 and the second off the 64-residue
    tile; 64-wide features (the ``single_in`` stub is (64, d)); 4-8 steps."""
    from repro_torch.serve import SamplingParams
    rng = np.random.default_rng(seed + 100)
    lens = rng.integers(96, PAIR_MAX_LEN + 1, (8,))
    lens[0] = PAIR_MAX_LEN
    if lens[1] % 64 == 0:
        lens[1] += 17 if lens[1] < 300 else -17
    steps = rng.integers(4, 9, (8,))
    return [(rng.standard_normal((int(n), 64)).astype(np.float32), int(t),
             SamplingParams()) for n, t in zip(lens, steps)]


def pair_wave(complexes):
    """A full admission wave of the first PAIR_SLOTS complexes: features
    padded to (PAIR_SLOTS, PAIR_MAX_LEN, 64) and their lengths, on the
    card."""
    import torch
    feats = np.zeros((PAIR_SLOTS, PAIR_MAX_LEN, 64), np.float32)
    lengths = np.zeros((PAIR_SLOTS,), np.int32)
    for i, (f, _, _) in enumerate(complexes[:PAIR_SLOTS]):
        feats[i, :f.shape[0]] = f
        lengths[i] = f.shape[0]
    return ({"feats": torch.as_tensor(feats, device="cuda")},
            torch.as_tensor(lengths, device="cuda"))


def phase_pair_serve(seed: int):
    """Pairformer-lite at full width through ServeEngine (SVD mode), with
    every launch counter set to 0 just before the drive and read after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import drive
    from repro_torch.models import get_model, init_params
    from repro_torch.serve import OK, ServeEngine

    full = get_config("pairformer_lite")
    cfg = full.replace(n_layers=PAIR_LAYERS)
    if full.n_layers != 16:
        raise AssertionError(f"config has {full.n_layers} layers")
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    engine = ServeEngine(get_model(cfg), params, max_len=PAIR_MAX_LEN,
                         n_slots=PAIR_SLOTS, device="cuda")
    del params                       # the engine holds its cast copy
    torch.cuda.synchronize()
    log("pair", f"{cfg.name}: {cfg.n_layers} layers, d_single "
                f"{cfg.d_model}, d_pair {cfg.d_pair}, {cfg.n_heads} heads x "
                f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, rank "
                f"{cfg.bias_rank}, {cfg.dtype}; weights ready in "
                f"{time.monotonic() - t0:.1f}s")
    complexes = make_complexes(seed)
    counters = reset_counters()
    t0 = time.monotonic()
    rids = drive(engine, complexes)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    stats = engine.stats()
    for rid, (f, _, _) in zip(rids, complexes):
        rec = engine.result(rid)
        if rec.status != OK or rec.shape != (f.shape[0], cfg.d_model):
            raise AssertionError(f"complex {rid}: {rec.status} "
                                 f"{rec.shape}")
        if not np.isfinite(rec).all():
            raise AssertionError(f"complex {rid}: non-finite result")
    want = {name: 0 for name in counters}
    want["flashbias_attention_ragged_fwd"] = PAIR_LAYERS * (
        stats["prefill_waves"] + stats["decode_steps"])
    n_steps = sum(t for _, t, _ in complexes)
    log("pair", f"{len(rids)} complexes OK (n_res "
                f"{[f.shape[0] for f, _, _ in complexes]}, "
                f"{n_steps} refinement steps in all) in {wall:.2f}s; "
                f"{stats['prefill_waves']} admission waves, "
                f"{stats['decode_steps']} engine steps; launches {launches}")
    if launches != want or not launches["flashbias_attention_ragged_fwd"]:
        raise AssertionError(f"kernel launches {launches} != {want}")
    check_tensor_core("pair")
    return engine, complexes, rids, launches


def bf16_ulp(x):
    """The bf16 spacing at |x| (8-bit significand): 2^(floor(log2|x|) - 7)."""
    import torch
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def ragged_attention(q, k, v, phi_q, phi_k, slopes=None, lengths=None, *,
                     scale, mask_kind="none", window=0, acc=None, skip=None,
                     bias_scale=1.0):
    """The pair path's ragged attention (factor bias, no mask, key bound
    ``lengths``) computed in ``acc``, optionally with a deliberate fault:
    keys in ``skip = (lo, hi)`` dropped, or the bias term scaled by
    ``bias_scale``. Takes both calling conventions of the ragged path (the
    kernel wrapper's and the plain version's). Rows with no key give 0."""
    import torch
    from repro_torch.core.attention import DEFAULT_MASK_VALUE
    if slopes is not None or mask_kind != "none":
        raise ValueError("the pair path attends with factors only, no mask")
    logits = (torch.einsum("bhnd,bhmd->bhnm", q.to(acc), k.to(acc)) * scale
              + bias_scale * torch.einsum("bhnr,bhmr->bhnm", phi_q.to(acc),
                                          phi_k.to(acc)))
    keys = torch.arange(k.shape[2], device=q.device)
    live = keys[None, :] < lengths.reshape(-1, 1)
    if skip is not None:
        live = live & ~((keys >= skip[0]) & (keys < skip[1]))[None, :]
    live = live[:, None, None, :]
    logits = logits.masked_fill(~live, DEFAULT_MASK_VALUE)
    o = torch.einsum("bhnm,bhmd->bhnd", torch.softmax(logits, -1), v.to(acc))
    return (o * live.any(-1, keepdim=True)).to(q.dtype)


@contextlib.contextmanager
def patched(module, name, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def phase_pair_parity(engine, complexes, rids, seed: int) -> list:
    """The first wave's admission and PAIR_STEPS refinement steps through
    the kernel path and the plain path on the card — bf16 in SVD mode and
    in factor-MLP mode, and float32 in SVD mode — with every ragged kernel
    call held in situ against the plain version on its inputs, and the
    final single reps compared on valid rows against the float64 control
    of the same mode; the check run on deliberate faults of the attention,
    each of which it must reject; then the first complex served alone
    through a 4-slot engine, bit-equal to its batched result. Returns the
    failed checks (every check runs and prints; ``main`` fails the run at
    its end if any did, after the remaining phases' measurements)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.models.common import materialize, stack_layers, tree_map
    from repro_torch.models.pairformer import factor_mlp_template
    from repro_torch.serve import ServeEngine

    cfg, params = engine.model.cfg, engine.backend.params
    batch, lens = pair_wave(complexes)
    valid = (torch.arange(PAIR_MAX_LEN, device="cuda")[None, :]
             < lens[:, None])
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    factors = materialize(stack_layers(factor_mlp_template(cfg, 256),
                                       cfg.n_layers), gen, device="cuda")
    params32 = tree_map(lambda x: x.float(), params)
    plain = ops.flashbias_attention_torch
    kernel = ops.flashbias_attention_ragged_fwd
    scale = cfg.resolved_head_dim ** -0.5

    def final_s(c, p, fac, impl):
        m = get_model(c.replace(attn_impl=impl))
        _, cache = m.prefill(p, batch, max_len=PAIR_MAX_LEN, lengths=lens,
                             factors=fac)
        for _ in range(PAIR_STEPS):
            cache = m.decode(p, cache)
        return cache["s"].float()[valid].flatten()

    def in_situ(fn, calls):
        """``fn`` with each call's output held against the plain version on
        the same inputs: (max |diff|, tolerance, diff in bf16 ulps of the
        worst element) appended to ``calls``."""
        def call(q, k, v, phi_q, phi_k, slopes=None, lengths=None, **kw):
            got = fn(q, k, v, phi_q, phi_k, slopes, lengths, **kw)
            want = plain(q, k, v, phi_q, phi_k, slopes, lengths=lengths, **kw)
            diff = (got.float() - want.float()).abs().flatten()
            worst = int(diff.argmax())
            ref = want.float().flatten()[worst:worst + 1]
            calls.append((float(diff[worst]), tolerance(want.dtype, want),
                          float(diff[worst] / bf16_ulp(ref)[0])))
            return got
        return call

    def in_situ_log(label, calls):
        """Logs the in-situ record of one run; True if every call was
        within its tolerance."""
        if len(calls) != PAIR_LAYERS * (1 + PAIR_STEPS):
            raise AssertionError(f"{label}: {len(calls)} ragged calls seen")
        worst = max(calls, key=lambda c: c[0] / c[1])
        over = sum(err > tol for err, tol, _ in calls)
        log("pair-parity", f"{label}: in situ, {len(calls)} ragged calls "
                           f"against the plain version on their inputs: "
                           f"worst {worst[0]:.3e} (tol {worst[1]:.1e}, "
                           f"{worst[2]:.1f} bf16 ulps of the element); "
                           f"{over} calls over the tolerance")
        return over == 0

    def gap(got, want):
        diff = (got - want).abs()
        worst = int(diff.argmax())
        return (float(diff.max()), float(want.square().mean().sqrt()),
                float(diff[worst] / bf16_ulp(want[worst])),
                int((diff > 0).sum()), bool(torch.isfinite(got).all()))

    def ratio(a, b):
        return a / b if b else (0.0 if a == 0 else float("inf"))

    def gap_log(label, g):
        log("pair-parity", f"{label}: max |s gap| {g[0]:.4e} = "
                           f"{g[0] / g[1]:.4f} x RMS(s) {g[1]:.4f} "
                           f"({g[2]:.1f} bf16 ulps of the worst element); "
                           f"elements differing {g[3]}"
                           f"{'' if g[4] else '; NON-FINITE values'}")

    failed, floor = [], {}
    with torch.no_grad():
        for label, fac in (("bf16 svd", None), ("bf16 mlp", factors)):
            want = final_s(cfg, params, fac, "torch")
            calls = []
            with patched(ops, "flashbias_attention_ragged_fwd",
                         in_situ(kernel, calls)):
                got = final_s(cfg, params, fac, "cuda")
            with patched(ops, "flashbias_attention_torch", functools.partial(
                    ragged_attention, acc=torch.float64)):
                control = final_s(cfg, params, fac, "torch")
            ok = in_situ_log(f"{label} kernel path", calls)
            g, gc = gap(got, want), gap(control, want)
            gap_log(f"{label} kernel path vs plain path", g)
            gap_log(f"{label} control: plain path with float64 attention vs "
                    f"plain path", gc)
            ok_e2e = g[4] and g[0] <= PAIR_CONTROL_MULT * gc[0]
            log("pair-parity", f"{label}: kernel gap / control gap "
                               f"{ratio(g[0], gc[0]):.3f} (at most "
                               f"{PAIR_CONTROL_MULT}); in situ "
                               f"{'ok' if ok else 'FAIL'}, end to end "
                               f"{'ok' if ok_e2e else 'FAIL'}")
            if not (ok and ok_e2e):
                failed.append(f"pair parity {label}: in situ ok {ok}, gap "
                              f"{g[0]:.4e} vs {PAIR_CONTROL_MULT} x control "
                              f"{gc[0]:.4e}")
            floor[label] = (want, gc[0])
        want = final_s(cfg.replace(dtype="float32"), params32, None, "torch")
        calls = []
        with patched(ops, "flashbias_attention_ragged_fwd",
                     in_situ(kernel, calls)):
            got = final_s(cfg.replace(dtype="float32"), params32, None,
                          "cuda")
        ok = in_situ_log("f32 svd kernel path", calls)
        g = gap(got, want)
        gap_log("f32 svd kernel path vs plain path", g)
        if not (ok and g[4] and g[0] <= PAIR_TOL_F32 * g[1]):
            log("pair-parity", "f32 svd: FAIL")
            failed.append(f"pair parity f32 svd: in situ ok {ok}, gap "
                          f"{g[0]:.4e} > {PAIR_TOL_F32} x RMS(s) {g[1]:.4e}")
        # the check on deliberate faults of the plain attention (bf16, SVD
        # mode): each must be rejected, in situ or end to end
        want, control_gap = floor["bf16 svd"]
        for name, skip, scaled in PAIR_FAULTS:
            calls = []
            fault = functools.partial(
                ragged_attention, acc=torch.float32, skip=skip,
                bias_scale=scale if scaled else 1.0)
            with patched(ops, "flashbias_attention_torch",
                         in_situ(fault, calls)):
                got = final_s(cfg, params, None, "torch")
            seen = not in_situ_log(f"fault '{name}'", calls)
            g = gap(got, want)
            gap_log(f"fault '{name}' vs plain path", g)
            seen_e2e = not (g[4] and g[0] <= PAIR_CONTROL_MULT * control_gap)
            log("pair-parity", f"fault '{name}': rejected in situ {seen}, "
                               f"end to end {seen_e2e} (gap / control gap "
                               f"{ratio(g[0], control_gap):.3f})")
            if not (seen or seen_e2e):
                failed.append(f"pair parity check passes the fault '{name}'")
    torch.cuda.empty_cache()
    feats, steps, _ = complexes[0]
    alone = ServeEngine(engine.model, params, max_len=PAIR_MAX_LEN,
                        n_slots=PAIR_SLOTS, device="cuda")
    rid = alone.submit(feats, steps)
    alone.run()
    got, want = alone.result(rid), engine.result(rids[0])
    same = bool(np.array_equal(got, want))
    log("pair-parity", f"complex 0 (n_res {feats.shape[0]}, {steps} steps) "
                       f"alone through a {PAIR_SLOTS}-slot engine: "
                       f"{'bit-equal' if same else 'DIFFERS'} to its batched "
                       f"result (max |gap| "
                       f"{float(np.abs(got - want).max()):.3e})")
    if not same:
        failed.append("pair batched != alone at the same slot count")
    del alone
    torch.cuda.empty_cache()
    return failed


STEP_MODES = {"factored": "flashbias", "dense_recompute": "dense_recompute",
              "dense": "dense"}
PAIR_ROUNDS, PAIR_ROUND_STEPS = 4, 2


def profile_steps(fn, n: int):
    """Run ``fn`` n times under torch.profiler (every call runs the same
    kernels); returns (device busy ms per call, the device rows of the
    profile)."""
    kernels = profiled(fn, n)
    return sum(device_us(e) for e in kernels) / n / 1e3, kernels


def phase_pair_times(engine, complexes, card: str) -> dict:
    """Kernel 2 against its plain version and the library call at the path
    shape; the admission wave; a refinement step of 4 full slots in the
    three cache modes, in alternating rounds; one factored step traced."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flashbias_attn import (
        flashbias_attention_ragged_fwd, flashbias_attention_torch)
    from repro_torch.models import get_model

    cfg, params = engine.model.cfg, engine.backend.params
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    b, h, n, d = PAIR_SLOTS, cfg.n_heads, PAIR_MAX_LEN, cfg.resolved_head_dim
    r = min(cfg.bias_rank, n)
    scale = d ** -0.5
    lengths = [f.shape[0] for f, _, _ in complexes[:PAIR_SLOTS]]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(bf)
               for _ in range(3))
    pq, pk = (torch.randn((b, h, n, r), generator=gen, device="cuda")
              for _ in range(2))
    # library: the bias materialized from the float32 factors the kernel
    # reads, with the length mask folded in (one baddbmm into an additive
    # 0 / -inf key mask), cast once to the attention's bf16, then SDPA with
    # that float mask — the paper's "attention with bias" baseline, three
    # calls
    kpos = torch.arange(n, device="cuda")
    keymask = torch.zeros((b, h, 1, n), device="cuda").masked_fill(
        kpos >= lens[:, None, None, None], -torch.inf)
    keymask = keymask.reshape(b * h, 1, n).contiguous()
    pq3 = pq.reshape(b * h, n, r)
    pk3t = pk.reshape(b * h, n, r).transpose(1, 2)

    def library():
        mask = torch.baddbmm(keymask, pq3, pk3t).view(b, h, n, n)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask.to(bf),
                                              scale=scale)

    live = sum(lengths)
    bytes_ = (2 * b * h * n * d * 2 + 2 * live * h * d * 2 + live * h * r * 4
              + b * h * n * r * 4 + b * 4)
    flops = n * live * h * 2 * (d + r + d)
    kernel = (lambda: flashbias_attention_ragged_fwd(
        q, k, v, pq, pk, None, lens, scale=scale))
    out = dict(ms=device_ms(kernel),
               plain_ms=device_ms(lambda: flashbias_attention_torch(
                   q, k, v, pq, pk, scale=scale, lengths=lens)),
               library_ms=device_ms(library), **bound(bytes_, flops))
    log("pair-times", f"flashbias_attention_ragged_fwd (device time per "
                      f"call, B{b} H{h} N=M{n} D=Dv=R{d}, lengths "
                      f"{lengths}): kernel {out['ms']:.4f} ms, plain "
                      f"{out['plain_ms']:.4f} ms, library (float32 bias "
                      f"baddbmm, cast to bf16, SDPA with that float mask, "
                      f"three calls) "
                      f"{out['library_ms']:.4f} ms, bound "
                      f"{out['bound_ms']:.4f} ms ({out['bound_by']}); "
                      f"kernel between CUDA events, host gaps included, "
                      f"{event_ms(kernel):.4f} ms [{card}]")
    del q, k, v, pq, pk, pq3, pk3t
    torch.cuda.empty_cache()

    # four full slots (n_res 384 each): the admission wave, then one slot
    # cache per mode
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((b, n, 64)).astype(np.float32)
    batch = {"feats": torch.as_tensor(feats, device="cuda")}
    full = torch.full((b,), n, dtype=torch.int32, device="cuda")
    models = {label: get_model(cfg.replace(bias_mode=mode))
              for label, mode in STEP_MODES.items()}
    caches = {}
    with torch.no_grad():
        for label, m in models.items():
            torch.cuda.synchronize()
            t0 = time.monotonic()
            _, wave = m.prefill(params, batch, max_len=n, lengths=full)
            torch.cuda.synchronize()
            wave_ms = (time.monotonic() - t0) * 1e3
            cache = m.insert_cache(m.init_cache(b, n, device="cuda"), wave,
                                   np.arange(b))
            caches[label] = cache
            del wave
            torch.cuda.empty_cache()
            log("pair-times", f"{label}: admission wave of {b} x {n} "
                              f"residues {wave_ms:.1f} ms on the host clock "
                              f"[{card}]")
        fm = models["factored"]
        busy, kernels = profile_steps(
            lambda: fm.prefill(params, batch, max_len=n, lengths=full), 1)
        log("pair-times", f"factored admission wave: device busy "
                          f"{busy:.1f} ms; top kernels:")
        for e in sorted(kernels, key=device_us, reverse=True)[:6]:
            log("pair-times", f"  {device_us(e) / 1e3:9.3f} ms {e.count:6d} "
                              f"calls  {e.key[:80]}")
        torch.cuda.empty_cache()

        walls = {label: [] for label in models}

        def steps(label, count):
            for _ in range(count):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                caches[label] = models[label].decode(params, caches[label])
                torch.cuda.synchronize()
                walls[label].append((time.monotonic() - t0) * 1e3)

        labels = list(models)
        for label in labels:                       # warm-up
            steps(label, 1)
        for label in labels:
            walls[label].clear()
        for rnd in range(PAIR_ROUNDS):
            for label in (labels if rnd % 2 == 0 else labels[::-1]):
                steps(label, PAIR_ROUND_STEPS)
        step = {}
        for label in labels:
            busy, kernels = profile_steps(
                lambda: caches.__setitem__(label, models[label].decode(
                    params, caches[label])), 3)
            wall = float(np.median(walls[label]))
            step[label] = {"step_ms": wall, "busy_ms": busy,
                           "idle_share": 1 - busy / wall}
            log("pair-times", f"{label} refinement step ({b} x {n}, "
                              f"{cfg.n_layers} layers): "
                              f"{wall:.3f} ms on the host clock (median of "
                              f"{len(walls[label])}, rounds alternating "
                              f"between the modes); device busy {busy:.3f} "
                              f"ms/step, idle share "
                              f"{1 - busy / wall:.3f} [{card}]")
            if label == "factored":
                for e in sorted(kernels, key=device_us, reverse=True)[:8]:
                    log("pair-times", f"  {device_us(e) / 3 / 1e3:8.3f} "
                                      f"ms/step {e.count // 3:5d} calls/step"
                                      f"  {e.key[:80]}")
    del caches
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 10-12: Mamba2 SSM serving, parity and times
# ---------------------------------------------------------------------------

def ssd_tolerance(dtype, ref) -> float:
    """float32: the order of float32 sums of up to chunk x N terms, 1e-4 at
    the output's scale. bfloat16 y: both sides round one float32 result
    once, so 2 bf16 ulps at the output's scale."""
    import torch
    scale = max(1.0, float(ref.float().abs().max()))
    return (1e-4 if dtype == torch.float32 else 2.0 ** -6) * scale


def ssd_inputs(gen, b, s, h, p, n, dtype, per_head=False, dt_shift=0.0,
               with_h0=False):
    """Inputs of the SSD kernel as the model hands them over: x and dt as
    (B, H, S, *) views of (B, S, H, *) tensors, b and c one group sliced from
    a (B, S, 2N) tensor and seen as (B, 1, S, N) (or per head, (B, H, S,
    N)), a < 0; then h0 (B, H, P, N) or None."""
    import torch
    import torch.nn.functional as F
    dev = "cuda"
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=dev))
    a = -torch.exp(0.3 * torch.randn((h,), generator=gen, device=dev))
    if per_head:
        bm, cm = (torch.randn((b, h, s, n), generator=gen, device=dev)
                  for _ in range(2))
    else:
        bc = torch.randn((b, s, 2 * n), generator=gen, device=dev)
        bm, cm = bc[:, None, :, :n], bc[:, None, :, n:]
    h0 = (torch.randn((b, h, p, n), generator=gen, device=dev)
          if with_h0 else None)
    return (x.transpose(1, 2), (dt + dt_shift).transpose(1, 2), a, bm,
            cm), h0


def phase_ssm_kernel(seed: int) -> float:
    """Kernel 5 against its plain version on y and the final state: the SSM
    path's shape, then off-path cases. Returns the path case's worst
    error."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    f32, bf = torch.float32, torch.bfloat16
    # (name, B, S, H, P, N, chunk, x dtype, b/c per head, dt shift, h0, path);
    # every case takes the tensor-core body but the last, whose P, N and
    # chunk are off it
    cases = [
        ("ssd_scan_fwd path B4 H32 S4096 P64 N128 chunk256 f32 b/c shared",
         4, 4096, 32, 64, 128, 256, f32, False, 0.0, False, True),
        ("ssd_scan_fwd path shape bf16 x", 4, 4096, 32, 64, 128, 256, bf,
         False, 0.0, False, False),
        ("ssd_scan_fwd S1000 (off the chunk) h0", 2, 1000, 8, 64, 128, 256,
         f32, False, 0.0, True, False),
        ("ssd_scan_fwd S100 (one short chunk) h0", 2, 100, 8, 64, 128, 256,
         f32, False, 0.0, True, False),
        ("ssd_scan_fwd S777 b/c per head h0", 2, 777, 8, 64, 128, 256, f32,
         True, 0.0, True, False),
        ("ssd_scan_fwd S600 dt + 20 (an unmasked exp overflows)", 2, 600, 8,
         64, 128, 256, f32, False, 20.0, False, False),
        ("ssd_scan_fwd S600 bf16 x b/c per head h0", 2, 600, 8, 64, 128,
         256, bf, True, 0.0, True, False),
        ("ssd_scan_fwd P32 N64 chunk128 S333 b/c per head h0", 3, 333, 3,
         32, 64, 128, f32, True, 0.0, True, False),
        ("ssd_scan_fwd P20 N8 chunk48 S97 h0 (the CUDA-core body)", 2, 97,
         3, 20, 8, 48, f32, False, 0.0, True, False),
    ]
    worst = None
    for name, b, s, h, p, n, chunk, dtype, per_head, shift, with_h0, path \
            in cases:
        args, h0 = ssd_inputs(gen, b, s, h, p, n, dtype, per_head, shift,
                              with_h0)
        tc_before = ssd_scan_fwd.tensor_core_launches
        y, hf = ssd_scan_fwd(*args, chunk=chunk, h0=h0)
        torch.cuda.synchronize()
        tc = ssd_scan_fwd.tensor_core_launches - tc_before
        if tc != (name != cases[-1][0]):     # the last case is off the body
            raise AssertionError(f"{name}: the {'tensor' if tc else 'CUDA'}"
                                 f"-core body took the call")
        y_ref, h_ref = ssd_scan_torch(*args, chunk=chunk, h0=h0)
        err_y = float((y.float() - y_ref.float()).abs().max())
        err_h = float((hf - h_ref).abs().max())
        tol_y, tol_h = ssd_tolerance(dtype, y_ref), ssd_tolerance(f32, h_ref)
        ok = (bool(torch.isfinite(y).all() and torch.isfinite(hf).all())
              and y.dtype == dtype and err_y <= tol_y and err_h <= tol_h)
        log("ssm-kernel", f"{name}: {'tensor' if tc else 'CUDA'}-core "
                          f"body, y max_abs_err {err_y:.3e} (tol "
                          f"{tol_y:.1e}), h_fin {err_h:.3e} (tol "
                          f"{tol_h:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version")
        if path:
            worst = max(err_y, err_h)
        del args, h0, y, hf, y_ref, h_ref
    torch.cuda.empty_cache()
    return worst


def make_ssm_requests(seed: int, vocab: int):
    """The SSM mix: SSM_PROMPTS tokens each (the first longer than
    SSM_MAX_LEN), NEW_TOKENS new tokens, requests 2 and 6 sampled."""
    from repro_torch.serve import SamplingParams
    rng = np.random.default_rng(seed + 200)
    sampled = {2, 6}
    return [(rng.integers(0, vocab, (n,)).astype(np.int32), NEW_TOKENS,
             SamplingParams(0.8, 40, seed=seed + i) if i in sampled
             else SamplingParams()) for i, n in enumerate(SSM_PROMPTS)]


def phase_ssm_serve(seed: int):
    """mamba2-130m at full width through ServeEngine, every launch counter
    set to 0 just before the drive and read after; then the same mix
    through an engine built with page_size, which must not page and must
    give the same greedy streams."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, init_params
    from repro_torch.serve import ServeEngine

    cfg = get_config("mamba2_130m")
    if cfg.n_layers != SSM_LAYERS:
        raise AssertionError(f"config has {cfg.n_layers} layers")
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    engine = ServeEngine(get_model(cfg), params, max_len=SSM_MAX_LEN,
                         n_slots=SSM_SLOTS, device="cuda")
    del params                       # the engine holds its bf16 copy
    torch.cuda.synchronize()
    log("ssm", f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
               f"{cfg.ssm_heads_padded} SSM heads x {cfg.ssm_head_dim}, "
               f"state {cfg.ssm_state}, conv {cfg.conv_width}, chunk "
               f"{cfg.ssd_chunk}, vocab {cfg.vocab_padded}, {cfg.dtype}; "
               f"weights ready in {time.monotonic() - t0:.1f}s")
    requests = make_ssm_requests(seed, cfg.vocab)
    with observe(engine) as obs:
        rids, launches, tok_s, wall = drive_counted(engine, requests)
    first = {i: obs.first[rid] for i, rid in enumerate(rids)}
    stats = engine.stats()
    want = {name: 0 for name in launches}
    want["ssd_scan_fwd"] = SSM_LAYERS * stats["prefill_waves"]
    log("ssm", f"{len(rids)} requests OK x {NEW_TOKENS} tokens (prompts "
               f"{list(SSM_PROMPTS)}, max_len {SSM_MAX_LEN}) in {wall:.2f}s "
               f"({tok_s:.1f} tok/s); {stats['prefill_waves']} admission "
               f"waves, {stats['decode_steps']} decode steps; launches "
               f"{launches}")
    if launches != want or not launches["ssd_scan_fwd"]:
        raise AssertionError(f"kernel launches {launches} != {want}")
    check_tensor_core("ssm", ("ssd_scan_fwd",))

    paged = ServeEngine(engine.model, engine.backend.params,
                        max_len=SSM_MAX_LEN, n_slots=SSM_SLOTS,
                        page_size=PAGE, device="cuda")
    if paged.backend.paged or paged.page_stats():
        raise AssertionError(f"an SSM engine built with page_size={PAGE} "
                             f"pages: {paged.page_stats()}")
    prids, plaunches, _, pwall = drive_counted(paged, requests)
    same = [bool(np.array_equal(engine.result(a), paged.result(b)))
            for a, b in zip(rids, prids)]
    greedy = [i for i, (_, _, sp) in enumerate(requests)
              if sp.temperature == 0]
    log("ssm", f"page_size={PAGE} engine: pages {paged.backend.paged}, "
               f"page stats {paged.page_stats()}; {len(prids)} requests OK in "
               f"{pwall:.2f}s; streams equal to the first engine's: greedy "
               f"{sum(same[i] for i in greedy)}/{len(greedy)}, all "
               f"{sum(same)}/{len(same)}; launches {plaunches}")
    if not all(same[i] for i in greedy):
        raise AssertionError("page_size changed an SSM greedy stream")
    if plaunches["ssd_scan_fwd"] != SSM_LAYERS * paged.stats()[
            "prefill_waves"]:
        raise AssertionError(f"page_size engine launches {plaunches}")
    check_tensor_core("ssm", ("ssd_scan_fwd",))
    del paged
    torch.cuda.empty_cache()
    return engine, requests, launches, tok_s, first


def ssd_no_carry(x, dt, a, b, c, *, chunk, h0=None):
    """The deliberate fault: the plain version with the state reset to zero
    at every chunk (the final state is the last chunk's alone)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_torch
    ys, h = [], None
    for s0 in range(0, x.shape[2], chunk):
        part = slice(s0, s0 + chunk)
        y, h = ssd_scan_torch(x[:, :, part], dt[:, :, part], a,
                              b[:, :, part], c[:, :, part], chunk=chunk)
        ys.append(y)
    return torch.cat(ys, dim=2), h


def ssm_wave(requests):
    """The first admission wave: SSM_SLOTS prompts right-padded to the
    longest, on the card, with their lengths (the SSM and hybrid phases)."""
    import torch
    wave = [p for p, _, _ in requests[:SSM_SLOTS]]
    toks = np.zeros((SSM_SLOTS, max(p.size for p in wave)), np.int64)
    for i, p in enumerate(wave):
        toks[i, :p.size] = p
    lengths = np.array([p.size for p in wave], np.int32)
    return ({"tokens": torch.as_tensor(toks, device="cuda")},
            torch.as_tensor(lengths, device="cuda"))


def in_situ_ssd(fn, calls: list):
    """``fn`` (the SSD kernel's wrapper, or a stand-in) that also runs the
    plain version on the same inputs and appends (y gap, y tolerance, h_fin
    gap, h_fin tolerance) to ``calls``."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_torch

    def call(x, dt, a, b, c, *, chunk, h0=None):
        got = fn(x, dt, a, b, c, chunk=chunk, h0=h0)
        want = ssd_scan_torch(x, dt, a, b, c, chunk=chunk, h0=h0)
        calls.append((float((got[0].float() - want[0].float()).abs().max()),
                      ssd_tolerance(want[0].dtype, want[0]),
                      float((got[1] - want[1]).abs().max()),
                      ssd_tolerance(torch.float32, want[1])))
        return got
    return call


def in_situ_report(phase: str, label: str, calls: list) -> bool:
    """Log the in-situ SSD checks of ``calls``; True when every call is
    within its tolerances."""
    over = sum(ey > ty or eh > th for ey, ty, eh, th in calls)
    wy = max(calls, key=lambda c: c[0] / c[1])
    wh = max(calls, key=lambda c: c[2] / c[3])
    log(phase, f"{label}: in situ, {len(calls)} SSD calls against the plain "
               f"version on their inputs: worst y {wy[0]:.3e} (tol "
               f"{wy[1]:.1e}), worst h_fin {wh[2]:.3e} (tol {wh[3]:.1e}); "
               f"{over} calls over the tolerance")
    return over == 0


def phase_ssm_parity(engine, requests) -> list:
    """The first wave's prefill and SSM_DECODE_STEPS decode steps through
    the kernel path (every SSD kernel call held in situ against the plain
    version on its inputs) and the plain path, fed the kernel path's greedy
    tokens; the logits compared; then the check run on the deliberate
    fault, which it must reject. Returns the failed checks."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd
    from repro_torch.models import get_model

    cfg, params = engine.model.cfg, engine.backend.params
    batch, lens = ssm_wave(requests)
    models = {impl: get_model(cfg.replace(attn_impl=impl))
              for impl in ("cuda", "torch")}

    def run(model, fed=None):
        """Prefill and decode steps; the (B, vocab) float32 logits of each
        and the tokens fed (the run's own greedy picks unless ``fed``)."""
        logits, cache = model.prefill(params, batch, lengths=lens)
        out, tokens = [], []
        for step in range(SSM_DECODE_STEPS + 1):
            out.append(logits[:, 0, :cfg.vocab].float())
            if step == SSM_DECODE_STEPS:
                return out, tokens
            nxt = fed[step] if fed else out[-1].argmax(-1)[:, None]
            tokens.append(nxt)
            logits, cache = model.decode(params, cache, nxt)

    def in_situ_ok(label, calls) -> bool:
        if len(calls) != SSM_LAYERS:
            raise AssertionError(f"{label}: {len(calls)} SSD calls seen")
        return in_situ_report("ssm-parity", label, calls)

    def gaps(got, want):
        return [float((g - w).abs().max()) for g, w in zip(got, want)]

    failed = []
    with torch.no_grad():
        calls = []
        with patched(ops, "ssd_scan_fwd", in_situ_ssd(ssd_scan_fwd, calls)):
            got, fed = run(models["cuda"])
        want, _ = run(models["torch"], fed)
        fault_calls = []
        with patched(ops, "ssd_scan_fwd",
                     in_situ_ssd(ssd_no_carry, fault_calls)):
            fault, _ = run(models["cuda"], fed)
    ok = in_situ_ok("kernel path", calls)
    g = gaps(got, want)
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    ok_e2e = finite and max(g) <= SSM_LOGIT_TOL
    log("ssm-parity", f"kernel path vs plain path, prefill of "
                      f"{lens.tolist()} tokens then {SSM_DECODE_STEPS} "
                      f"decode steps: max |logits gap| per step "
                      f"{', '.join(f'{x:.3e}' for x in g)} (tol "
                      f"{SSM_LOGIT_TOL}); greedy agreement {agree}/"
                      f"{len(got) * SSM_SLOTS}; logit RMS "
                      f"{float(want[0].square().mean().sqrt()):.3f}, max "
                      f"|logit| {float(want[0].abs().max()):.3f}; in situ "
                      f"{'ok' if ok else 'FAIL'}, end to end "
                      f"{'ok' if ok_e2e else 'FAIL'}")
    if not (ok and ok_e2e):
        failed.append(f"ssm parity: in situ ok {ok}, logits gap {max(g):.3e}"
                      f" vs {SSM_LOGIT_TOL}")
    seen = not in_situ_ok("fault 'state not carried across chunks'",
                          fault_calls)
    gf = gaps(fault, want)
    seen_e2e = max(gf) > SSM_LOGIT_TOL
    log("ssm-parity", f"fault 'state not carried across chunks': max |logits "
                      f"gap| per step {', '.join(f'{x:.3e}' for x in gf)}; "
                      f"rejected in situ {seen}, end to end {seen_e2e}")
    if not (seen or seen_e2e):
        failed.append("ssm parity check passes the fault 'state not carried'")
    del got, want, fault
    torch.cuda.empty_cache()
    return failed


def ssd_stage_ms(fn, iters: int = 20):
    """Device time per call of ``fn`` (as ``device_ms``) and its part in
    each kernel of the SSD scan's tensor-core body (SSD_STAGES) and in the
    CUDA-core body (ssd_fwd)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    kernels = profiled(fn, iters)
    stages = {}
    for st in SSD_STAGES + ("ssd_fwd",):
        pat = re.compile(rf"(?<![A-Za-z0-9_]){st}[<(]")
        stages[st] = sum(device_us(e) for e in kernels
                         if pat.search(e.key)) / iters / 1e3
    return sum(device_us(e) for e in kernels) / iters / 1e3, stages


def phase_ssm_times(engine, requests, tok_s: float, card: str) -> dict:
    """Kernel 5 and its plain version per call at the path shape, with the
    bound; the admission wave of the first wave's 4 prompts; the decode
    step of 4 slots x 24 layers, its device busy time and idle share; and
    the serve phase's end-to-end tokens/s."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_torch

    cfg, params, model = engine.model.cfg, engine.backend.params, \
        engine.model
    batch, lens = ssm_wave(requests)
    b, s = batch["tokens"].shape
    h, p, n, q = (cfg.ssm_heads_padded, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssd_chunk)
    gen = torch.Generator(device="cuda").manual_seed(3)
    args, _ = ssd_inputs(gen, b, s, h, p, n, torch.float32)
    chunks = [min(q, s - s0) for s0 in range(0, s, q)]
    flops = b * h * sum(ln * (ln + 1) // 2 * (2 * n + 2 * p)
                        + 4 * ln * n * p for ln in chunks)
    bytes_ = (2 * b * s * h * p * 4 + 2 * b * s * n * 4 + b * s * h * 4
              + h * 4 + b * h * p * n * 4)
    kernel = (lambda: ssd_scan_fwd(*args, chunk=q))
    ms, stages = ssd_stage_ms(kernel)
    out = dict(ms=ms,
               plain_ms=device_ms(lambda: ssd_scan_torch(*args, chunk=q)),
               library_ms=None,
               **bound(bytes_, flops))
    log("ssm-times", "ssd_scan_fwd device ms per call by kernel: " + ", ".join(
        f"{st} {t:.4f}" for st, t in stages.items()) + f" [{card}]")
    log("ssm-times", f"ssd_scan_fwd (device time per call, B{b} H{h} S{s} "
                     f"P{p} N{n} chunk {q}, float32): kernel "
                     f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
                     f"library none (no PyTorch call computes the SSD "
                     f"scan), bound {out['bound_ms']:.4f} ms "
                     f"({out['bound_by']}: {bytes_ / 1e9:.3f} GB at 3.35 "
                     f"TB/s, {flops / 1e9:.2f} GFLOP at 989 TFLOP/s "
                     f"{flops / BF16_FLOP_PER_S * 1e3:.4f} ms; as float32 "
                     f"FMAs at 67 TFLOP/s, the kernel's own arithmetic, "
                     f"{flops / 67e12 * 1e3:.4f} ms); kernel "
                     f"between CUDA events, host gaps included, "
                     f"{event_ms(kernel, iters=10):.4f} ms [{card}]")
    del args
    torch.cuda.empty_cache()

    with torch.no_grad():
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            _, cache = model.prefill(params, batch, lengths=lens)
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
            del cache
        wave_ms = float(np.median(walls[1:]))
        busy, kernels = profile_steps(
            lambda: model.prefill(params, batch, lengths=lens), 1)
        log("ssm-times", f"admission wave ({b} x {s} positions, prompts "
                         f"{lens.tolist()}): {wave_ms:.1f} ms on the host "
                         f"clock (median of 3 after a warm-up); device busy "
                         f"{busy:.1f} ms; top kernels: [{card}]")
        for e in sorted(kernels, key=device_us, reverse=True)[:6]:
            log("ssm-times", f"  {device_us(e) / 1e3:9.3f} ms {e.count:6d} "
                             f"calls  {e.key[:80]}")

        logits, cache = model.prefill(params, batch, lengths=lens)
        tokens = logits[:, 0, :cfg.vocab].argmax(-1)[:, None]
        step_walls = []

        def step():
            model.decode(params, cache, tokens)

        for _ in range(13):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            step()
            torch.cuda.synchronize()
            step_walls.append((time.monotonic() - t0) * 1e3)
        step_ms = float(np.median(step_walls[1:]))
        kernels = profiled(step, 3)
        busy = sum(device_us(e) for e in kernels) / 3 / 1e3
        log("ssm-times", f"decode step ({SSM_SLOTS} slots, {cfg.n_layers} "
                         f"layers): {step_ms:.3f} ms on the host clock "
                         f"(median of 12 after a warm-up); device busy "
                         f"{busy:.3f} ms/step, idle share "
                         f"{1 - busy / step_ms:.3f}; end to end (serve "
                         f"phase) {tok_s:.1f} tok/s [{card}]")
        for e in sorted(kernels, key=device_us, reverse=True)[:6]:
            log("ssm-times", f"  {device_us(e) / 3 / 1e3:8.3f} ms/step "
                             f"{e.count // 3:5d} calls/step  {e.key[:80]}")
        log("ssm-times", f"decode step: {sum(e.count for e in kernels) // 3}"
                         f" device calls per step; top host ops:")
        for e in host_ops(step, 3):
            log("ssm-times", f"  host {e.self_cpu_time_total / 3 / 1e3:8.3f} "
                             f"ms/step {e.count // 3:5d} calls/step  "
                             f"{e.key[:70]}")
    del cache
    torch.cuda.empty_cache()
    return out


def phase_ssm_chunked(engine, requests, whole_first: dict, card: str):
    """The SSM mix through a chunked engine (SSM_CHUNK tokens per step) on
    the same weights, every SSD kernel call held in situ against the plain
    version on its inputs (the carried state h0 among them): every request
    OK, the SSD kernel launched SSM_LAYERS x chunk steps and the attention
    kernels never, first-token logits within SSM_LOGIT_TOL of the
    whole-prompt engine's."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd
    from repro_torch.launch.serve import drive
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(engine.model, engine.backend.params,
                      max_len=SSM_MAX_LEN, n_slots=SSM_SLOTS,
                      prefill_chunk=SSM_CHUNK, device="cuda")
    calls: list = []
    counters = reset_counters()
    t0 = time.monotonic()
    with patched(ops, "ssd_scan_fwd", in_situ_ssd(ssd_scan_fwd, calls)), \
            observe(eng) as obs:
        rids = drive(eng, requests)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check_results("ssm-chunked", eng, rids, [n for _, n, _ in requests])
    launches = {name: fn.launches for name, fn in counters.items()}
    stats = eng.stats()
    want = {name: 0 for name in launches}
    want["ssd_scan_fwd"] = SSM_LAYERS * stats["chunk_steps"]
    chunk_ms = [ms for _, kind, ms in obs.steps if kind == "chunk"]
    log("ssm-chunked", f"{len(rids)} requests OK (prompts "
                       f"{list(SSM_PROMPTS)}, chunk {SSM_CHUNK}) in "
                       f"{wall:.2f}s, the in-situ checks included; "
                       f"{stats['chunk_steps']} chunk steps (median "
                       f"{float(np.median(chunk_ms)):.3f} ms on the host "
                       f"clock, the plain scan beside each call included), "
                       f"{stats['decode_steps']} decode steps; launches "
                       f"{launches} [{card}]")
    if launches != want or len(calls) != want["ssd_scan_fwd"]:
        raise AssertionError(f"ssm-chunked: kernel launches {launches}, "
                             f"{len(calls)} calls seen, != {want}")
    check_tensor_core("ssm-chunked", ("ssd_scan_fwd",))
    if not in_situ_report("ssm-chunked", "chunked engine", calls):
        raise AssertionError("ssm-chunked: SSD kernel calls off their plain "
                             "version")
    first_gaps("ssm-chunked",
               {i: obs.first[rid] for i, rid in enumerate(rids)},
               whole_first, SSM_LOGIT_TOL)
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6c: the LM's dense-bias baseline
# ---------------------------------------------------------------------------

def alternate(fns: dict, rounds: int = 3, per_round: int = 1) -> dict:
    """Median host ms per call of each of ``fns`` ({label: fn}), each call
    ending in a synchronize, in alternating rounds (A B B A ...) after one
    warm-up call each, so all see the same host."""
    import torch
    walls = {label: [] for label in fns}
    labels = list(fns)
    with torch.no_grad():
        for label in labels:
            fns[label]()
        for r in range(rounds):
            for label in (labels if r % 2 == 0 else labels[::-1]):
                for _ in range(per_round):
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    fns[label]()
                    torch.cuda.synchronize()
                    walls[label].append((time.monotonic() - t0) * 1e3)
    return {label: float(np.median(w)) for label, w in walls.items()}


def counted(fn):
    """``fn()`` with every launch counter set to 0 just before and read just
    after: (its result, {wrapper: launches} of the wrappers that moved)."""
    import torch
    counters = reset_counters()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in counters.items()
                 if w.launches}


def phase_lm_dense(engine, requests, card: str) -> None:
    """The serve phase's first wave (4 prompts right-padded to 512) prefilled
    with bias_mode="dense" (the materialized float32 ALiBi bias, the plain
    chunked attention) and with "flashbias" (kernel 1), on the serve phase's
    weights: kernel 1 launches N_LAYERS times in the flashbias wave and
    never in the dense one, the first-token logits agree within LOGIT_TOL,
    and both waves are timed (the paper's Sec. 4.2 A/B)."""
    import torch
    from repro_torch.models import get_model

    cfg, params = engine.model.cfg, engine.backend.params
    wave = requests[:SLOTS]
    toks = np.zeros((SLOTS, PROMPT_MAX), np.int64)
    for i, (p, _, _) in enumerate(wave):
        toks[i, :p.size] = p
    batch = {"tokens": torch.as_tensor(toks, device="cuda")}
    lens = torch.tensor([p.size for p, _, _ in wave], dtype=torch.int32,
                        device="cuda")
    models = {mode: get_model(cfg.replace(bias_mode=mode))
              for mode in ("flashbias", "dense")}
    waves = {mode: (lambda m=m: m.prefill(params, batch, max_len=PROMPT_MAX,
                                          lengths=lens))
             for mode, m in models.items()}
    first = {}
    for mode, fn in waves.items():
        (logits, _), launches = counted(fn)
        first[mode] = logits[:, 0, :cfg.vocab].float()
        want = ({"flashbias_attention_fwd": N_LAYERS} if mode == "flashbias"
                else {})
        log("lm-dense", f"{mode} wave of {SLOTS} x {PROMPT_MAX} (lengths "
                        f"{lens.tolist()}): launches {launches}")
        if launches != want:
            raise AssertionError(f"lm-dense: {mode} wave launched "
                                 f"{launches}, want {want}")
        if mode == "flashbias":
            check_tensor_core("lm-dense", ("flashbias_attention_fwd",))
    gap = float((first["flashbias"] - first["dense"]).abs().max())
    agree = int((first["flashbias"].argmax(-1)
                 == first["dense"].argmax(-1)).sum())
    log("lm-dense", f"first-token logits, flashbias against dense: max "
                    f"|gap| {gap:.3e} (tol {LOGIT_TOL}); greedy agreement "
                    f"{agree}/{SLOTS}")
    if not gap <= LOGIT_TOL:
        raise AssertionError(f"lm-dense: flashbias and dense waves disagree "
                             f"({gap:.3e} > {LOGIT_TOL})")
    walls = alternate(waves)
    with torch.no_grad():
        for mode, fn in waves.items():
            busy, kernels = profile_steps(fn, 1)
            log("lm-dense", f"{mode} wave: {walls[mode]:.2f} ms on the host "
                            f"clock (median, rounds alternating), device "
                            f"busy {busy:.2f} ms, idle share "
                            f"{1 - busy / walls[mode]:.3f} [{card}]")
            top_kernels("lm-dense", kernels)
    torch.cuda.empty_cache()


def top_kernels(phase: str, kernels: list, top: int = 5) -> None:
    """Log the ``top`` device rows of a one-call profile by time."""
    for e in sorted(kernels, key=device_us, reverse=True)[:top]:
        log(phase, f"  {device_us(e) / 1e3:8.3f} ms {e.count:5d} calls  "
                   f"{e.key[:80]}")


# ---------------------------------------------------------------------------
# phases 13-14: the paper's vision (SwinV2-B) and PDE models on kernel 1
# ---------------------------------------------------------------------------

def in_situ_attention(calls: list, rows=None):
    """A stand-in for kernel 1's wrapper in ``ops`` (which ``_FlashAttention``
    calls): the kernel, then its plain version on the same inputs, appending
    (query rows, max |error|, ``tolerance``) to ``calls``. With ``rows`` (a
    function of N giving (lo, hi) query-row slices) the plain version runs
    on those rows against every key, which mask "none" allows (each output
    row depends on its own query row alone): at N = 32186 whole dense
    logits would not fit on the card."""
    from repro_torch.kernels.flashbias_attn import (flashbias_attention_fwd,
                                                    flashbias_attention_torch)

    def call(q, k, v, phi_q=None, phi_k=None, slopes=None, **kw):
        got = flashbias_attention_fwd(q, k, v, phi_q, phi_k, slopes, **kw)
        n = q.shape[2]
        spans = [(0, n)] if rows is None else rows(n)
        if rows is not None and kw.get("mask_kind", "none") != "none":
            raise ValueError("row slices need mask 'none'")
        for lo, hi in spans:
            want = flashbias_attention_torch(
                q[:, :, lo:hi], k, v,
                None if phi_q is None else phi_q[:, :, lo:hi], phi_k,
                slopes, **kw)
            err = float((got[:, :, lo:hi].float() - want.float()).abs().max())
            calls.append(((lo, hi), err, tolerance(q.dtype, want)))
        return got
    return call


def in_situ_check(phase: str, calls: list, n_calls: int) -> None:
    """Log the in-situ checks; fail unless there were ``n_calls`` kernel
    calls' worth and each is within its tolerance."""
    over = [c for c in calls if not c[1] <= c[2]]
    worst = max(calls, key=lambda c: c[1] / c[2])
    log(phase, f"in situ: {len(calls)} checks of {n_calls} kernel calls "
               f"against the plain version on their inputs (query rows "
               f"{sorted({c[0] for c in calls})}): worst {worst[1]:.3e} "
               f"(tol {worst[2]:.1e}, rows {worst[0]}); {len(over)} over")
    if over or not calls:
        raise AssertionError(f"{phase}: kernel 1 off its plain version in "
                             f"situ: {over[:4]}")


def model_gap(phase: str, label: str, got, want, n_layers: int) -> float:
    """max |got - want| of two bf16 forwards' outputs, held to MODEL_ULPS
    bf16 ulps per layer at the output's top scale (see MODEL_ULPS)."""
    import torch
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    tol = n_layers * MODEL_ULPS * 2.0 ** -8 * top
    ok = bool(torch.isfinite(got).all()) and err <= tol
    log(phase, f"{label}: max |gap| {err:.3e} (tol {tol:.3e} = {n_layers} "
               f"layers x {MODEL_ULPS} bf16 ulp at the top |output| "
               f"{top:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{phase}: {label}: {err:.3e} > {tol:.3e}")
    return err


def attention_call(phase: str, label: str, q, k, v, fq, fk, model_fq,
                   model_fk, card: str, library=None, plain=True) -> dict:
    """Kernel 1 (no mask) at one path shape, device time per call: alone
    (contiguous float32 factors ``fq`` / ``fk`` of a rank the bf16 body
    takes as they are, nothing for the wrapper to copy), as the model calls
    it (``model_fq`` / ``model_fk``, broadcast or bf16: the wrapper's float32
    copies included), its plain version and a library call; the bound from
    bytes and operations at the model's rank, and beside it the exponential
    floor (one exp per score at the special-function rate)."""
    from repro_torch.kernels.flashbias_attn import (flashbias_attention_fwd,
                                                    flashbias_attention_torch)
    b, h, n, d = q.shape
    m, r = k.shape[2], model_fq.shape[-1]
    scale = d ** -0.5
    out = {"ms": device_ms(lambda: flashbias_attention_fwd(
        q, k, v, fq, fk, scale=scale)),
        "model_ms": device_ms(lambda: flashbias_attention_fwd(
            q, k, v, model_fq, model_fk, scale=scale))}
    if plain:
        out["plain_ms"] = device_ms(lambda: flashbias_attention_torch(
            q, k, v, fq, fk, scale=scale), iters=5)
    if library is not None:
        out["library_ms"] = device_ms(library, iters=5)
    bytes_ = 2 * (2 * b * h * n * d + 2 * b * h * m * d) + 4 * b * h * (
        n + m) * r
    flops = 2 * b * h * n * m * (2 * d + r)
    out.update(bound(bytes_, flops))
    out["exp_ms"] = b * h * n * m / SFU_EXP_PER_S * 1e3
    larger = ("exponentials" if out["exp_ms"] > out["bound_ms"]
              else out["bound_by"])
    log(phase, f"{label} (device time per call): kernel alone "
               f"{out['ms']:.4f} ms, as the model calls it (the wrapper's "
               f"factor copies included) {out['model_ms']:.4f} ms, plain "
               f"{out.get('plain_ms', float('nan')):.4f} ms, library "
               f"{out.get('library_ms', float('nan')):.4f} ms; bound "
               f"{out['bound_ms']:.4f} ms ({out['bound_by']}: "
               f"{bytes_ / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP), "
               f"exponential floor {out['exp_ms']:.4f} ms ({b * h * n * m:.3e}"
               f" exp at {SFU_EXP_PER_S:.1e}/s); the larger: {larger} "
               f"[{card}]")
    return out


def check_width(cfg, got: tuple, want: tuple) -> None:
    """The config runs at the published width the phase states."""
    if got != want:
        raise AssertionError(f"{cfg.name}: {got} != the published {want}")


def phase_swin(seed: int, card: str) -> int:
    """SwinV2-B at full width on kernel 1 (see the module docstring, phase
    13). Returns kernel 1's launches in the counted forward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.decomp import reconstruction_error
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, swin

    full = get_config("swinv2_b")
    cfg = full.replace(n_layers=SWIN_LAYERS)
    layers, heads, w, r = cfg.n_layers, cfg.n_heads, cfg.window, cfg.bias_rank
    check_width(cfg, (full.n_layers, cfg.d_model, heads,
                      cfg.resolved_head_dim, w, r, cfg.d_ff),
                (24, 512, 16, 32, 576, 16, 2048))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    # exact rank-r tables (std 0.5, the init law's): random normal tables
    # are full rank, and a FlashBias-vs-dense comparison on them would only
    # measure truncation
    a, b = (torch.randn((layers, heads, w, r), generator=gen, device="cuda")
            for _ in range(2))
    tables = (a @ b.transpose(-1, -2)) * (0.5 / r ** 0.5)
    params["layers"]["bias_table"] = tables
    del a, b
    torch.cuda.synchronize()
    t0 = time.monotonic()
    factors = swin.svd_factorize(params, r)
    torch.cuda.synchronize()
    svd_s = time.monotonic() - t0
    rel = reconstruction_error(tables, factors["phi_q"], factors["phi_k"])
    log("swin", f"{cfg.name}: {layers} layers, d_model {cfg.d_model}, "
                f"{heads} heads x {cfg.resolved_head_dim}, window {w}, "
                f"d_ff {cfg.d_ff}, {cfg.dtype}; svd_factorize of "
                f"{layers * heads} tables of {w} x {w} at rank {r}: "
                f"{svd_s:.2f} s on the host clock (paper: 4.79 s); relative "
                f"reconstruction error {rel:.3e} [{card}]")
    if not rel <= SVD_REL_TOL:
        raise AssertionError(f"swin: exact rank-{r} tables reconstructed "
                             f"to {rel:.3e}")
    patches = torch.randn((SWIN_IMAGES, SWIN_WINDOWS, w, 48), generator=gen,
                          device="cuda")
    calls: list = []
    with patched(ops, "flashbias_attention_fwd", in_situ_attention(calls)):
        logits, launches = counted(lambda: swin.forward(params, patches, cfg,
                                                        factors))
    log("swin", f"flashbias forward of {SWIN_IMAGES} images x "
                f"{SWIN_WINDOWS} windows: logits {tuple(logits.shape)}, "
                f"launches {launches}")
    if launches != {"flashbias_attention_fwd": layers}:
        raise AssertionError(f"swin: launches {launches}, want {layers} of "
                             f"kernel 1")
    check_tensor_core("swin", ("flashbias_attention_fwd",))
    if tuple(logits.shape) != (SWIN_IMAGES, 1000):
        raise AssertionError(f"swin: logits shape {tuple(logits.shape)}")
    in_situ_check("swin", calls, layers)
    runs = {"flashbias": lambda: swin.forward(params, patches, cfg, factors),
            "dense": lambda: swin.forward(params, patches,
                                          cfg.replace(bias_mode="dense")),
            "plain": lambda: swin.forward(params, patches,
                                          cfg.replace(attn_impl="torch"),
                                          factors)}
    with torch.no_grad():
        for label in ("dense", "plain"):
            model_gap("swin", f"logits, kernel path against the "
                              f"{label} path", logits, runs[label](), layers)
    walls = alternate(runs)
    with torch.no_grad():
        for label, fn in runs.items():
            busy, kernels = profile_steps(fn, 1)
            log("swin", f"{label} forward: {walls[label]:.2f} ms on the host "
                        f"clock (median, rounds alternating), device busy "
                        f"{busy:.2f} ms [{card}]")
            top_kernels("swin", kernels)
    # kernel 1 at the path shape, on layer 0's factors
    bsz = SWIN_IMAGES * SWIN_WINDOWS
    q, k, v = (torch.randn((bsz, heads, w, cfg.resolved_head_dim),
                           generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    model_f = [factors[key][0].to(torch.bfloat16)[None].expand(
        bsz, heads, w, r) for key in ("phi_q", "phi_k")]
    alone = [f.float().contiguous() for f in model_f]
    mask = tables[0].to(torch.bfloat16)[None]
    attention_call("swin", f"kernel 1 at the Swin shape B{bsz} H{heads} "
                           f"N=M{w} D{cfg.resolved_head_dim} R{r} bf16 phi",
                   q, k, v, *alone, *model_f, card,
                   library=lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask))
    del params, factors, tables, patches, q, k, v, alone, model_f, mask
    torch.cuda.empty_cache()
    return launches["flashbias_attention_fwd"]


def pde_slices(n: int) -> list:
    """Query-row slices of the PDE's in-situ check: the first 512 rows, 1024
    in the middle, and the last 512, which hold the last, partial 64-row
    tile (32186 = 502 x 64 + 58)."""
    mid = n // 2 // 64 * 64
    return [(0, 512), (mid, mid + 1024), (n - 512, n)]


def phase_pde(seed: int, card: str) -> int:
    """The PDE solver at full width on kernel 1 (see the module docstring,
    phase 14). Returns kernel 1's launches in the counted forward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.bias import sqdist_factors
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, pde

    cfg = get_config("pde_solver")
    layers, heads, hd = cfg.n_layers, cfg.n_heads, cfg.resolved_head_dim
    check_width(cfg, (layers, cfg.d_model, heads, hd, cfg.d_ff,
                      cfg.coord_dim), (8, 128, 8, 16, 256, 3))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    coords = torch.rand((1, PDE_POINTS, cfg.coord_dim), generator=gen,
                        device="cuda")
    dense_gb = heads * PDE_POINTS ** 2 * 4 / 1e9
    log("pde", f"{cfg.name}: {layers} layers, d_model {cfg.d_model}, "
               f"{heads} heads x {hd}, d_ff {cfg.d_ff}, {cfg.dtype}; "
               f"{PDE_POINTS} points in the unit cube; the dense float32 "
               f"bias would be (1, {heads}, {PDE_POINTS}, {PDE_POINTS}) = "
               f"{dense_gb:.1f} GB per layer (not run)")
    calls: list = []
    with patched(ops, "flashbias_attention_fwd",
                 in_situ_attention(calls, pde_slices)):
        out, launches = counted(lambda: pde.forward(params, coords, cfg))
    log("pde", f"flashbias forward at N={PDE_POINTS}: output "
               f"{tuple(out.shape)}, launches {launches}")
    if launches != {"flashbias_attention_fwd": layers}:
        raise AssertionError(f"pde: launches {launches}, want {layers} of "
                             f"kernel 1")
    check_tensor_core("pde", ("flashbias_attention_fwd",))
    if tuple(out.shape) != (1, PDE_POINTS, 4) or not torch.isfinite(out).all():
        raise AssertionError(f"pde: output {tuple(out.shape)} not finite or "
                             f"misshapen")
    in_situ_check("pde", calls, layers)
    small = torch.rand((1, PDE_PARITY_POINTS, cfg.coord_dim), generator=gen,
                       device="cuda")
    runs = {"flashbias": lambda: pde.forward(params, small, cfg),
            "dense": lambda: pde.forward(params, small,
                                         cfg.replace(bias_mode="dense")),
            "plain": lambda: pde.forward(params, small,
                                         cfg.replace(attn_impl="torch"))}
    with torch.no_grad():
        got = runs["flashbias"]()
        for label in ("dense", "plain"):
            model_gap("pde", f"N={PDE_PARITY_POINTS} output, kernel path "
                             f"against the {label} path", got,
                      runs[label](), layers)
    full = {"flashbias": lambda: pde.forward(params, coords, cfg)}
    for label, fns in ((f"N={PDE_POINTS}", full),
                       (f"N={PDE_PARITY_POINTS}", runs)):
        walls = alternate(fns)
        with torch.no_grad():
            for mode, fn in fns.items():
                busy, kernels = profile_steps(fn, 1)
                log("pde", f"{label} {mode} forward: {walls[mode]:.2f} ms on "
                           f"the host clock (median, rounds alternating), "
                           f"device busy {busy:.2f} ms [{card}]")
                top_kernels("pde", kernels)
    # kernel 1 at the path shape, on layer 0's factors of these points
    lp0 = {key: val[0] for key, val in params["layers"].items()}
    for n, pts in ((PDE_POINTS, coords), (PDE_PARITY_POINTS, small)):
        q, k, v = (torch.randn((1, heads, n, hd), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        alpha = F.softplus(pts @ lp0["alpha_w"] + lp0["alpha_b"])
        pq0, pk0 = sqdist_factors(pts, pts)
        model_fq = (alpha[..., None] * pq0[:, :, None]).transpose(1, 2)
        model_fk = pk0[:, None].expand(1, heads, n, pk0.shape[-1])
        # the bf16 body's factor rows are 16-byte aligned: R 9 pads to 12
        alone = [F.pad(f, (0, -f.shape[-1] % 4)).contiguous()
                 for f in (model_fq, model_fk)]
        library = None
        if n == PDE_PARITY_POINTS:
            mask = torch.einsum("bhnr,bhmr->bhnm", *alone).to(torch.bfloat16)
            library = (lambda mask=mask: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))
        attention_call("pde", f"kernel 1 at the PDE shape B1 H{heads} N=M{n} "
                              f"D{hd} R{pq0.shape[-1]} bf16 phi (float32 "
                              f"factors, phi_k shared by the heads)",
                       q, k, v, *alone, model_fq, model_fk, card,
                       library=library, plain=n == PDE_PARITY_POINTS)
        del q, k, v, alone, model_fq, model_fk, library
    del params, coords, small
    torch.cuda.empty_cache()
    return launches["flashbias_attention_fwd"]


# ---------------------------------------------------------------------------
# phase 15: fault injection on the paged serve path
# ---------------------------------------------------------------------------

def serve_weights(seed: int):
    """The serve phase's model and weights again, from ``seed``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, init_params
    cfg = get_config("gpt2_alibi_15b").replace(n_layers=N_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return get_model(cfg), init_params(cfg, gen, device="cuda")


def phase_faults(model, params, requests, want: list, card: str) -> None:
    """The paged phase's engine (the serve phase's weights, made again from
    the seed) and requests again, under FAULT_PLAN: every
    request OK with NEW_TOKENS tokens and its stream, greedy and sampled,
    bit-equal to the paged phase's fault-free run (``want``); every fault
    kind fired, faults contained >= 2, a quarantine, every page free; the
    paged decode kernel launched N_LAYERS x the decode steps that
    dispatched (a ``step`` fault dispatches nothing) and kernel 1 N_LAYERS
    x waves."""
    import torch
    from repro_torch.serve import FAULT_KINDS, FaultPlan, ServeEngine

    plan = FaultPlan.parse(FAULT_PLAN)
    first = sum(-(-p.size // PAGE) for p, _, _ in requests[:SLOTS])
    eng = ServeEngine(model, params, max_len=MAX_LEN, n_slots=SLOTS,
                      prefill_len=PROMPT_MAX, page_size=PAGE,
                      n_pages=first + 1, pages_per_slot=MAX_LEN // PAGE,
                      faults=plan, device="cuda")
    rids, launches, tok_s, wall = drive_counted(eng, requests)
    stats, pages = eng.stats(), eng.page_stats()
    same = [bool(np.array_equal(eng.result(r), w))
            for r, w in zip(rids, want)]
    kinds = {kind for _, kind, _ in plan.fired}
    expect = {name: 0 for name in launches}
    expect["flashbias_attention_fwd"] = N_LAYERS * stats["prefill_waves"]
    expect["flash_decode_paged_fwd"] = N_LAYERS * stats["decode_steps"]
    log("faults", f"plan {plan.spec_str()!r}: fired {plan.fired}; "
                  f"{len(rids)} requests OK x {NEW_TOKENS} tokens in "
                  f"{wall:.2f}s ({tok_s:.1f} tok/s); streams bit-equal to "
                  f"the fault-free paged run: {sum(same)}/{len(same)} "
                  f"(greedy and sampled); {stats['prefill_waves']} prefill "
                  f"waves, {stats['decode_steps']} decode steps dispatched "
                  f"in {eng.step_idx} engine steps; launches {launches}; "
                  f"pages {pages} [{card}]")
    if not all(same):
        raise AssertionError(f"faults: streams differ from the fault-free "
                             f"run: {same}")
    if kinds != set(FAULT_KINDS):
        raise AssertionError(f"faults: kinds fired {sorted(kinds)}")
    if pages["faults_contained"] < 2 or pages["quarantines"] < 1:
        raise AssertionError(f"faults: contained / quarantined {pages}")
    if pages["n_free"] != pages["n_pages"]:
        raise AssertionError(f"faults: pages left in use: {pages}")
    if launches != expect:
        raise AssertionError(f"faults: launches {launches} != {expect}")
    check_tensor_core("faults", ("flashbias_attention_fwd",))
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 16: crash-safe engine checkpoints
# ---------------------------------------------------------------------------

def resume_from_snapshot(label: str, make, src, want: list,
                         rids: list) -> int:
    """Snapshot ``src`` (stepped part way), put it through JSON, run ``src``
    on, delete it, restore the snapshot onto a fresh engine from ``make``
    and run that: both must end every request OK, bit-equal to ``want``
    (the uninterrupted run's results). Returns the snapshot's JSON size."""
    import torch
    from repro_torch.serve import OK
    text = json.dumps(src.snapshot_engine())
    state = json.loads(text)
    live = [d["rid"] for d in state["live"]]
    src.run()
    on = [bool(np.array_equal(src.result(r), w)) for r, w in zip(rids, want)]
    del src
    torch.cuda.empty_cache()
    dst = make()
    dst.restore_engine(state)
    dst.run()
    torch.cuda.synchronize()
    recs = [dst.result(r) for r in rids]
    back = [bool(np.array_equal(rec, w)) for rec, w in zip(recs, want)]
    ok = all(rec.status == OK for rec in recs)
    log(label, f"snapshot at engine step {state['step_idx']}: "
               f"{len(text)} bytes of JSON, live {live}, queued "
               f"{sum(len(q) for q in state['queue'].values())}; source "
               f"run on: bit-equal {sum(on)}/{len(on)}; restored "
               f"onto a fresh engine: all OK {ok}, bit-equal "
               f"{sum(back)}/{len(back)}")
    if not (all(on) and all(back) and ok and live):
        raise AssertionError(f"{label}: run on {on}, restored {back}, OK "
                             f"{ok}, live {live}")
    del dst
    torch.cuda.empty_cache()
    return len(text)


def checkpoint_traffic(seed: int, vocab: int):
    """The prefix phase's traffic with a CHECKPOINT_LONG-token prompt of its
    own placed first among the late arrivals: it is still mid-ChunkPlan
    when the next wave's prefix sharers start decoding."""
    from repro_torch.serve import SamplingParams
    traffic = prefix_traffic(seed, vocab)
    rng = np.random.default_rng(seed + 600)
    long = (rng.integers(0, vocab, (CHECKPOINT_LONG,)).astype(np.int32),
            NEW_TOKENS, SamplingParams())
    return traffic[:SLOTS] + [long] + traffic[SLOTS:]


def shared_live_pages(eng) -> bool:
    """Two live requests hold one page (a prefix share)."""
    held = [set(p) for p in eng.backend._slot_pages.values()]
    return any(a & b for i, a in enumerate(held) for b in held[i + 1:])


def phase_checkpoint_prefix(model, params, seed: int) -> int:
    """16a: the prefix phase's engine (paged, chunk CHUNK, prefix cache) on
    checkpoint traffic, snapshotted while a prompt is mid-ChunkPlan and two
    live requests share prefix pages, restored onto a fresh engine: streams
    bit-equal to an uninterrupted run, greedy and sampled. Returns the
    snapshot's JSON size."""
    from repro_torch.serve import ServeEngine

    traffic = checkpoint_traffic(seed, model.cfg.vocab)

    def make():
        return ServeEngine(model, params, max_len=MAX_LEN, n_slots=SLOTS,
                           page_size=PAGE, pages_per_slot=MAX_LEN // PAGE,
                           prefill_chunk=CHUNK, prefix_cache=True,
                           device="cuda")

    def submit(eng, until=None):
        """The prefix phase's schedule; with ``until`` it stops stepping at
        the first engine step after which ``until(eng)`` holds."""
        rids = [eng.submit(p, n, sampling=sp) for p, n, sp in traffic[:SLOTS]]
        while eng.backend.prefill_pending() or len(eng.scheduler):
            eng.step()
        rids += [eng.submit(p, n, sampling=sp) for p, n, sp in traffic[SLOTS:]]
        while until is not None and not until(eng):
            if not (eng.occupancy or len(eng.scheduler)):
                raise AssertionError("checkpoint: drained before the "
                                     "snapshot point")
            eng.step()
        return rids

    ref = make()
    rids = submit(ref)
    ref.run()
    want = [ref.result(r) for r in rids]
    check_results("checkpoint-prefix", ref, rids, [n for _, n, _ in traffic])
    del ref
    src = make()
    submit(src, lambda e: e.backend._pending and shared_live_pages(e))
    log("checkpoint-prefix", f"{len(traffic)} requests (a "
                             f"{CHECKPOINT_LONG}-token prompt among the "
                             f"prefix traffic); at the snapshot "
                             f"{len(src.backend._pending)} prompt(s) "
                             f"mid-ChunkPlan, prefix pages shared by live "
                             f"requests, "
                             f"{src.page_stats()['prefix']['tokens_matched']}"
                             f" tokens matched")
    return resume_from_snapshot("checkpoint-prefix", make, src, want, rids)


def phase_checkpoint_ssm(engine, requests) -> int:
    """16b: the SSM serve phase's engine and mix (its streams the
    uninterrupted run), snapshotted once every request was submitted,
    restored onto a fresh engine. Returns the snapshot's JSON size."""
    from repro_torch.serve import ServeEngine
    want = [engine.result(r) for r in range(len(requests))]

    def make():
        return ServeEngine(engine.model, engine.backend.params,
                           max_len=SSM_MAX_LEN, n_slots=SSM_SLOTS,
                           device="cuda")

    src = make()
    half = len(requests) // 2
    rids = [src.submit(p, n, sampling=sp) for p, n, sp in requests[:half]]
    for p, n, sp in requests[half:]:      # the launcher's staggering
        rids.append(src.submit(p, n, sampling=sp))
        src.step()
    return resume_from_snapshot("checkpoint-ssm", make, src, want, rids)


def phase_checkpoint_pair(seed: int) -> int:
    """16c: a Pairformer engine at PAIR_CKPT_LAYERS layers (full width) on
    PAIR_CKPT_COMPLEXES complexes, snapshotted after 2 steps, restored onto
    a fresh engine. Returns the snapshot's JSON size."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import drive
    from repro_torch.models import get_model, init_params
    from repro_torch.serve import ServeEngine

    cfg = get_config("pairformer_lite").replace(n_layers=PAIR_CKPT_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = get_model(cfg)
    params = init_params(cfg, gen, device="cuda")
    complexes = make_complexes(seed)[:PAIR_CKPT_COMPLEXES]

    def make():
        return ServeEngine(model, params, max_len=PAIR_MAX_LEN,
                           n_slots=PAIR_SLOTS, device="cuda")

    ref = make()
    rids = drive(ref, complexes)
    want = [ref.result(r) for r in rids]
    del ref
    src = make()
    rids = [src.submit(f, n) for f, n, _ in complexes]
    for _ in range(2):
        src.step()
    return resume_from_snapshot("checkpoint-pair", make, src, want, rids)


# ---------------------------------------------------------------------------
# phase 17: the hybrid family (hymba-1.5b) on kernel 1 (local) and kernel 5
# ---------------------------------------------------------------------------

def make_traffic(seed: int, vocab: int, prompts, new_tokens: int,
                 sampled=(2, 6), stream: int = 0):
    """Requests of ``prompts`` tokens each (drawn from ``seed + stream``),
    ``new_tokens`` new tokens, ``sampled`` of them sampled (temperature
    0.8, top-k 40), the rest greedy."""
    from repro_torch.serve import SamplingParams
    rng = np.random.default_rng(seed + stream)
    return [(rng.integers(0, vocab, (int(n),)).astype(np.int32), new_tokens,
             SamplingParams(0.8, 40, seed=seed + i) if i in sampled
             else SamplingParams()) for i, n in enumerate(prompts)]


def rowwise(fn):
    """``fn`` (kernel 1's plain version) applied one batch row at a time: a
    row's output depends on its own q, k, v alone, and the whole (4, 48,
    3000, 3000) float32 logits would take 6.9 GB per tensor."""
    import torch

    def call(q, k, v, phi_q=None, phi_k=None, slopes=None, **kw):
        return torch.cat([fn(q[b:b + 1], k[b:b + 1], v[b:b + 1], phi_q,
                             phi_k, slopes, **kw)
                          for b in range(q.shape[0])])
    return call


def in_situ_local(calls: list):
    """A stand-in for kernel 1's wrapper in ``ops``: the kernel, then its
    plain version on the same inputs one batch row at a time, appending
    ((row, mask, window), max |error|, ``tolerance``) to ``calls``."""
    from repro_torch.kernels.flashbias_attn import (flashbias_attention_fwd,
                                                    flashbias_attention_torch)

    def call(q, k, v, phi_q=None, phi_k=None, slopes=None, **kw):
        got = flashbias_attention_fwd(q, k, v, phi_q, phi_k, slopes, **kw)
        for b in range(q.shape[0]):
            want = flashbias_attention_torch(q[b:b + 1], k[b:b + 1],
                                             v[b:b + 1], phi_q, phi_k,
                                             slopes, **kw)
            err = float((got[b:b + 1].float() - want.float()).abs().max())
            calls.append(((b, kw.get("mask_kind"), kw.get("window")), err,
                          tolerance(q.dtype, want)))
        return got
    return call


def local_pairs(n: int, w: int) -> int:
    """Query-key pairs of a causal window of ``w`` over ``n`` positions."""
    return sum(min(i + 1, w) for i in range(n))


def phase_hybrid(seed: int, card: str) -> dict:
    """hymba-1.5b at full width through ServeEngine with the ring engaged
    (see the module docstring, phase 17). Returns kernel 1's and kernel 5's
    launches in the serve drive; their times at the path shapes are logged
    (the record keeps the earlier shapes')."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flashbias_attn import (flashbias_attention_fwd,
                                                    flashbias_attention_torch)
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_torch
    from repro_torch.launch.serve import drive
    from repro_torch.models import get_model, init_params
    from repro_torch.serve import ServeEngine

    full = get_config("hymba_15b")
    cfg = full.replace(n_layers=HYBRID_LAYERS)
    check_width(cfg, (full.n_layers, cfg.d_model, cfg.heads_padded,
                      cfg.kv_heads_padded, cfg.resolved_head_dim,
                      cfg.window, cfg.ssm_heads_padded, cfg.ssm_head_dim,
                      cfg.ssm_state),
                (32, 1600, 48, 6, 64, 1024, 64, 64, 16))
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    model = get_model(cfg)
    engine = ServeEngine(model, params, max_len=HYBRID_MAX_LEN,
                         n_slots=SLOTS, device="cuda")
    del params                       # the engine holds its bf16 copy
    params = engine.backend.params
    torch.cuda.synchronize()
    if not engine.backend.ring or engine.backend.paged:
        raise AssertionError("hybrid: the ring is not engaged")
    log("hybrid", f"{cfg.name}: {cfg.n_layers} layers, d_model "
                  f"{cfg.d_model}, {cfg.heads_padded} heads x "
                  f"{cfg.resolved_head_dim} over {cfg.kv_heads_padded} kv "
                  f"heads, window {cfg.window}, {cfg.ssm_heads_padded} SSM "
                  f"heads x {cfg.ssm_head_dim}, state {cfg.ssm_state}, d_ff "
                  f"{cfg.d_ff}, vocab {cfg.vocab_padded}, {cfg.dtype}; "
                  f"weights ready in {time.monotonic() - t0:.1f}s")
    requests = make_traffic(seed, cfg.vocab, HYBRID_PROMPTS, NEW_TOKENS,
                            stream=500)
    attn_calls, ssd_calls = [], []
    counters = reset_counters()
    t0 = time.monotonic()
    with patched(ops, "flashbias_attention_fwd", in_situ_local(attn_calls)), \
            patched(ops, "ssd_scan_fwd", in_situ_ssd(ssd_scan_fwd,
                                                     ssd_calls)), \
            observe(engine) as obs:
        rids = drive(engine, requests)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    check_results("hybrid", engine, rids, [n for _, n, _ in requests])
    stats = engine.stats()
    want = {name: 0 for name in launches}
    want["flashbias_attention_fwd"] = HYBRID_LAYERS * stats["prefill_waves"]
    want["ssd_scan_fwd"] = HYBRID_LAYERS * stats["prefill_waves"]
    log("hybrid", f"{len(rids)} requests OK x {NEW_TOKENS} tokens (prompts "
                  f"{list(HYBRID_PROMPTS)}, max_len {HYBRID_MAX_LEN}) in "
                  f"{wall:.2f}s, the in-situ checks included; "
                  f"{stats['prefill_waves']} prefill waves, "
                  f"{stats['decode_steps']} decode steps; launches "
                  f"{launches}")
    if launches != want or not stats["decode_steps"]:
        raise AssertionError(f"hybrid: kernel launches {launches} != {want}")
    check_tensor_core("hybrid", ("flashbias_attention_fwd", "ssd_scan_fwd"))
    modes = {c[0][1:] for c in attn_calls}
    if modes != {("local", cfg.window)}:
        raise AssertionError(f"hybrid: kernel 1 modes {modes}")
    if len(attn_calls) != SLOTS * want["flashbias_attention_fwd"]:
        raise AssertionError(f"hybrid: {len(attn_calls)} in-situ rows")
    in_situ_check("hybrid", attn_calls, want["flashbias_attention_fwd"])
    if len(ssd_calls) != want["ssd_scan_fwd"] or not in_situ_report(
            "hybrid", "kernel 5 at N 16", ssd_calls):
        raise AssertionError("hybrid: SSD kernel calls off their plain "
                             "version")
    whole_first = {i: obs.first[rid] for i, rid in enumerate(rids)}

    # parity: the first wave's prefill and HYBRID_DECODE_STEPS decode steps,
    # kernel path against plain path fed the kernel path's greedy tokens
    batch, lens = ssm_wave(requests)         # SSM_SLOTS == SLOTS prompts
    models = {impl: get_model(cfg.replace(attn_impl=impl))
              for impl in ("cuda", "torch")}

    def run(m, fed=None):
        logits, cache = m.prefill(params, batch, max_len=HYBRID_MAX_LEN,
                                  lengths=lens)
        out, tokens = [], []
        for step in range(HYBRID_DECODE_STEPS + 1):
            out.append(logits[:, 0, :cfg.vocab].float())
            if step == HYBRID_DECODE_STEPS:
                return out, tokens
            nxt = fed[step] if fed else out[-1].argmax(-1)[:, None]
            tokens.append(nxt)
            logits, cache = m.decode(params, cache, nxt)

    with torch.no_grad():
        (got, fed), launched = counted(lambda: run(models["cuda"]))
        with patched(ops, "flashbias_attention_torch",
                     rowwise(flashbias_attention_torch)):
            want_l, _ = run(models["torch"], fed)
    gaps = [float((a - b).abs().max()) for a, b in zip(got, want_l)]
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(got, want_l))
    log("hybrid-parity", f"kernel path vs plain path, prefill of "
                         f"{lens.tolist()} tokens then {HYBRID_DECODE_STEPS} "
                         f"decode steps over the ring: max |logits gap| per "
                         f"step {', '.join(f'{g:.3e}' for g in gaps)} (tol "
                         f"{HYBRID_LOGIT_TOL}); greedy agreement {agree}/"
                         f"{len(got) * SLOTS}; max |logit| "
                         f"{float(want_l[0].abs().max()):.3f}; kernel path "
                         f"launches {launched}")
    if not (max(gaps) <= HYBRID_LOGIT_TOL
            and all(bool(torch.isfinite(x).all()) for x in got)):
        raise AssertionError(f"hybrid parity: gap {max(gaps):.3e}")
    if launched != {"flashbias_attention_fwd": HYBRID_LAYERS,
                    "ssd_scan_fwd": HYBRID_LAYERS}:
        raise AssertionError(f"hybrid parity: launches {launched}")
    del got, want_l
    torch.cuda.empty_cache()

    # the chunked engine: chunk HYBRID_CHUNK over the ring
    eng = ServeEngine(model, params, max_len=HYBRID_MAX_LEN, n_slots=SLOTS,
                      prefill_chunk=HYBRID_CHUNK, device="cuda")
    counters = reset_counters()
    t0 = time.monotonic()
    with observe(eng) as cobs:
        crids = drive(eng, requests)
    torch.cuda.synchronize()
    cwall = time.monotonic() - t0
    check_results("hybrid-chunked", eng, crids, [n for _, n, _ in requests])
    claunch = {name: fn.launches for name, fn in counters.items()}
    cstats = eng.stats()
    cwant = {name: 0 for name in claunch}
    cwant["ssd_scan_fwd"] = HYBRID_LAYERS * cstats["chunk_steps"]
    log("hybrid-chunked", f"{len(crids)} requests OK (chunk "
                          f"{eng.backend.chunk_size}) in {cwall:.2f}s; "
                          f"{cstats['chunk_steps']} chunk steps, "
                          f"{cstats['decode_steps']} decode steps; launches "
                          f"{claunch}")
    if claunch != cwant:
        raise AssertionError(f"hybrid-chunked: launches {claunch} != {cwant}")
    first_gaps("hybrid-chunked",
               {i: cobs.first[rid] for i, rid in enumerate(crids)},
               whole_first, HYBRID_LOGIT_TOL)
    del eng
    torch.cuda.empty_cache()

    # times at the path shapes
    b, h, kvh, d, w = (SLOTS, cfg.heads_padded, cfg.kv_heads_padded,
                       cfg.resolved_head_dim, cfg.window)
    n = int(lens.max())
    q = torch.randn((b, h, n, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((b, kvh, n, d), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    slopes = params["layers"]["attn"]["slopes"][0].float()
    kw = dict(scale=d ** -0.5, mask_kind="local", window=w)
    pos = torch.arange(n, device="cuda")
    rel = (pos[None, :] - pos[:, None]).float()
    inside = (rel <= 0) & (rel > -w)
    mask = torch.where(inside[None], slopes[:, None, None] * rel[None],
                       torch.tensor(float("-inf"), device="cuda")).to(
        torch.bfloat16)[None]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=d ** -0.5, enable_gqa=True)

    pairs = local_pairs(n, w)
    a_out = {"ms": device_ms(lambda: flashbias_attention_fwd(
        q, k, v, None, None, slopes, **kw)),
        "plain_ms": device_ms(lambda: flashbias_attention_torch(
            q, k, v, None, None, slopes, **kw), iters=3),
        "library_ms": device_ms(sdpa, iters=5)}
    a_bytes = 2 * (2 * b * h * n * d + 2 * b * kvh * n * d) + 4 * h
    a_flops = 4 * b * h * pairs * d
    a_out.update(bound(a_bytes, a_flops))
    a_out["exp_ms"] = b * h * pairs / SFU_EXP_PER_S * 1e3
    log("hybrid-times", f"kernel 1, local (B{b} H{h} KVH{kvh} N{n} D{d} "
                        f"window {w}, ALiBi, bf16; device time per call): "
                        f"kernel {a_out['ms']:.4f} ms, plain "
                        f"{a_out['plain_ms']:.4f} ms, SDPA with the ALiBi + "
                        f"local float mask {a_out['library_ms']:.4f} ms; "
                        f"bound {a_out['bound_ms']:.4f} ms "
                        f"({a_out['bound_by']}: {a_bytes / 1e6:.1f} MB, "
                        f"{a_flops / 1e9:.2f} GFLOP over the {pairs} "
                        f"in-window scores per head), exponential floor "
                        f"{a_out['exp_ms']:.4f} ms [{card}]")
    del q, k, v, mask
    torch.cuda.empty_cache()

    hs, p, ns, qc = (cfg.ssm_heads_padded, cfg.ssm_head_dim, cfg.ssm_state,
                     cfg.ssd_chunk)
    args, _ = ssd_inputs(gen, b, n, hs, p, ns, torch.float32)
    chunks = [min(qc, n - s0) for s0 in range(0, n, qc)]
    s_flops = b * hs * sum(ln * (ln + 1) // 2 * (2 * ns + 2 * p)
                           + 4 * ln * ns * p for ln in chunks)
    s_bytes = (2 * b * n * hs * p * 4 + 2 * b * n * ns * 4 + b * n * hs * 4
               + hs * 4 + b * hs * p * ns * 4)
    ms, stages = ssd_stage_ms(lambda: ssd_scan_fwd(*args, chunk=qc))
    s_out = dict(ms=ms, plain_ms=device_ms(
        lambda: ssd_scan_torch(*args, chunk=qc), iters=5), library_ms=None,
        **bound(s_bytes, s_flops))
    log("hybrid-times", f"kernel 5 at N {ns} (B{b} H{hs} S{n} P{p} chunk "
                        f"{qc}, float32; device time per call): kernel "
                        f"{s_out['ms']:.4f} ms (" + ", ".join(
                            f"{st} {t:.4f}" for st, t in stages.items())
        + f"), plain {s_out['plain_ms']:.4f} ms, library none; bound "
          f"{s_out['bound_ms']:.4f} ms ({s_out['bound_by']}: "
          f"{s_bytes / 1e6:.1f} MB, {s_flops / 1e9:.2f} GFLOP) [{card}]")
    del args
    torch.cuda.empty_cache()

    step_profile("hybrid-times", model, params, batch, lens, HYBRID_MAX_LEN,
                 card, paged=False)
    del engine
    torch.cuda.empty_cache()
    return {name: launches[name]
            for name in ("flashbias_attention_fwd", "ssd_scan_fwd")}


# ---------------------------------------------------------------------------
# phases 18-20: the paged hybrid, the MoE family, the plain dense configs
# ---------------------------------------------------------------------------

def bf16_params(cfg, seed: int) -> dict:
    """Random weights of ``cfg``'s model made on the card from ``seed`` in
    bf16, the layer-stacked leaves one layer at a time: a float32 copy of a
    whole model (or of one stacked leaf) of the larger configs would not fit
    beside the rest."""
    import torch
    from repro_torch.models import get_model
    from repro_torch.models.common import PDef, materialize, tree_map
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16

    def one(p, stacked):
        if not stacked:
            return materialize({"w": p}, gen, device="cuda", dtype=bf)["w"]
        out = torch.empty(p.shape, dtype=bf, device="cuda")
        for i in range(p.shape[0]):
            layer = PDef(p.shape[1:], p.axes[1:], p.init)
            out[i] = materialize({"w": layer}, gen, device="cuda",
                                 dtype=bf)["w"]
        return out

    tmpl = get_model(cfg).template()
    params = {k: one(v, False) for k, v in tmpl.items() if k != "layers"}
    params["layers"] = tree_map(lambda p: one(p, True), tmpl["layers"])
    torch.cuda.synchronize()
    return params


def serve_checked(label: str, engine, requests, *, paged: bool,
                  ssd: bool = False, preempt: bool = True, frontends=None):
    """Drive ``requests`` through ``engine`` (``drive_counted``: every
    request OK with its budget) and hold the launch counters to one kernel
    1 (and kernel 5 with ``ssd``) launch per layer and wave and one decode
    launch (kernel 4 paged, else kernel 3) per layer and step, every
    prefill launch on the tensor-core body; paged, the pool must have grown
    (and, with ``preempt``, preempted) and be free after the drain.
    Returns (rids, launches, tok/s, first-token logits by request
    index). ``frontends`` gives each request its frontend rows."""
    layers = engine.model.cfg.n_layers
    with observe(engine) as obs:
        rids, launches, tok_s, wall = drive_counted(engine, requests,
                                                    frontends)
    stats = engine.stats()
    decode = "flash_decode_paged_fwd" if paged else "flash_decode_fwd"
    want = {name: 0 for name in launches}
    want["flashbias_attention_fwd"] = layers * stats["prefill_waves"]
    want[decode] = layers * stats["decode_steps"]
    if ssd:
        want["ssd_scan_fwd"] = layers * stats["prefill_waves"]
    pages = engine.page_stats()
    log(label, f"{len(rids)} requests OK in {wall:.2f}s ({tok_s:.1f} tok/s);"
               f" {stats['prefill_waves']} prefill waves, "
               f"{stats['decode_steps']} decode steps; launches {launches}"
               + (f"; pages {pages}" if paged else ""))
    if launches != want or not want[decode]:
        raise AssertionError(f"{label}: kernel launches {launches} != {want}")
    check_tensor_core(label, ("flashbias_attention_fwd",)
                      + (("ssd_scan_fwd",) if ssd else ()))
    if paged and not (pages["grown"] >= 1 and pages["n_free"]
                      == pages["n_pages"] and (pages["preemptions"] >= 1
                                               or not preempt)):
        raise AssertionError(f"{label}: the pool did not grow, "
                             f"{'preempt, ' if preempt else ''}and drain: "
                             f"{pages}")
    return rids, launches, tok_s, {i: obs.first[r]
                                   for i, r in enumerate(rids)}


def paged_engine(model, params, requests, max_len: int, **kw):
    """A paged engine (page size PAGE, lazy) whose pool holds the first
    wave's prompt pages (frontend rows included) and one more, as phase
    4's: the first page grown takes the spare, the next finds the pool dry
    and preempts."""
    from repro_torch.serve import ServeEngine
    front = model.cfg.frontend_len
    first = sum(-(-(p.size + front) // PAGE) for p, _, _ in requests[:SLOTS])
    return ServeEngine(model, params, max_len=max_len, n_slots=SLOTS,
                       page_size=PAGE, n_pages=first + 1,
                       pages_per_slot=max_len // PAGE, device="cuda", **kw)


def merge_launches(total: dict, *more) -> dict:
    for launches in more:
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


def step_profile(label: str, model, params, batch, lens, max_len: int,
                 card: str, paged: bool = True) -> dict:
    """The first wave's prefill (whole, through the model) and a decode step
    of its 4 slots on a paged (or contiguous) cache: host clock in
    alternating rounds, device busy from a complete profile, idle share,
    and each one's top device kernels."""
    import torch
    from repro_torch.models import lm
    with torch.no_grad():
        def wave():
            return model.prefill(params, batch, max_len=max_len,
                                 lengths=lens)
        walls = alternate({"wave": wave})
        busy, kernels = profile_steps(wave, 1)
        log(label, f"prefill wave ({SLOTS} x {batch['tokens'].shape[1]}, "
                   f"prompts {lens.tolist()}): {walls['wave']:.1f} ms on "
                   f"the host clock, device busy {busy:.1f} ms, idle share "
                   f"{1 - busy / walls['wave']:.3f} [{card}]")
        top_kernels(label, kernels)
        out = {"wave_ms": walls["wave"], "wave_busy_ms": busy}
        logits, cache = wave()
        lengths = lens.cpu().numpy()
        kw = {}
        if paged:
            cache = paged_copy(model, cache, lengths, 1 + TRACE_STEPS)
            kw["max_pages"] = page_cap(int(lengths.max()) + 1 + TRACE_STEPS)
        tokens = logits[:, 0, :model.cfg.vocab].argmax(-1)[:, None]
        kind = ("paged" if paged else "over the ring"
                if lm._is_ring(model.cfg, cache["k"][0]) else "contiguous")

        def step():
            model.decode(params, cache, tokens, **kw)

        walls = alternate({"step": step}, rounds=6)
        kernels = profiled(step, 3)
        busy = sum(device_us(e) for e in kernels) / 3 / 1e3
        log(label, f"decode step ({SLOTS} slots {kind}, "
                   f"{model.cfg.n_layers} layers): {walls['step']:.3f} ms on "
                   f"the host clock, device busy {busy:.3f} ms, idle share "
                   f"{1 - busy / walls['step']:.3f}; "
                   f"{sum(e.count for e in kernels) // 3} device calls per "
                   f"step [{card}]")
        top_kernels(label, kernels)
    out.update(step_ms=walls["step"], step_busy_ms=busy)
    return out


def log_decode_times(label: str, shape: str, times: dict, card: str) -> None:
    library = {"flash_decode_fwd": "SDPA, float mask, no row write",
               "flash_decode_paged_fwd": "page gather + SDPA with a float "
                                         "mask, two calls, no row write"}
    for name, t in times.items():
        log(label, f"{name} at {shape} (device time per call): kernel "
                   f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                   f"({library[name]}) {t['library_ms']:.4f} ms, bound "
                   f"{t['bound_ms']:.4f} ms ({t['bound_by']}) [{card}]")


def phase_paged_hybrid(seed: int, card: str) -> dict:
    """hymba-1.5b at full width through a paged ServeEngine whose window
    covers max_len (see the module docstring, phase 18). Returns the
    serve's launches and kernel 4's times at this shape."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flashbias_attn import flashbias_attention_torch
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd
    from repro_torch.models import get_model

    full = get_config("hymba_15b")
    cfg = full.replace(n_layers=HYBRID_LAYERS)
    check_width(cfg, (full.n_layers, cfg.d_model, cfg.heads_padded,
                      cfg.kv_heads_padded, cfg.resolved_head_dim,
                      cfg.window, cfg.ssm_state),
                (32, 1600, 48, 6, 64, 1024, 16))
    t0 = time.monotonic()
    model = get_model(cfg)
    params = bf16_params(cfg, seed)
    requests = make_traffic(seed, cfg.vocab, PAGED_HYBRID_PROMPTS,
                            NEW_TOKENS, stream=600)
    engine = paged_engine(model, params, requests, PAGED_HYBRID_MAX_LEN)
    del params
    params = engine.backend.params
    if engine.backend.ring or not engine.backend.paged:
        raise AssertionError("paged-hybrid: the engine keeps a ring or "
                             "does not page")
    log("paged-hybrid", f"{cfg.name}: {cfg.n_layers} layers, "
                        f"{cfg.heads_padded} heads x "
                        f"{cfg.resolved_head_dim} over "
                        f"{cfg.kv_heads_padded} kv heads, window "
                        f"{cfg.window} covering max_len "
                        f"{PAGED_HYBRID_MAX_LEN}, SSM state "
                        f"{cfg.ssm_state}; page size {PAGE}, pool "
                        f"{engine.n_pages} pages; weights ready in "
                        f"{time.monotonic() - t0:.1f}s")
    attn_calls, ssd_calls = [], []
    with patched(ops, "flashbias_attention_fwd", in_situ_local(attn_calls)), \
            patched(ops, "ssd_scan_fwd", in_situ_ssd(ssd_scan_fwd,
                                                     ssd_calls)):
        rids, launches, tok_s, _ = serve_checked(
            "paged-hybrid", engine, requests, paged=True, ssd=True)
    waves = engine.stats()["prefill_waves"]
    modes = {c[0][1:] for c in attn_calls}
    if modes != {("local", cfg.window)}:
        raise AssertionError(f"paged-hybrid: kernel 1 modes {modes}")
    in_situ_check("paged-hybrid", attn_calls, cfg.n_layers * waves)
    if len(ssd_calls) != cfg.n_layers * waves or not in_situ_report(
            "paged-hybrid", f"kernel 5 at N {cfg.ssm_state}", ssd_calls):
        raise AssertionError("paged-hybrid: SSD kernel calls off their "
                             "plain version")

    with patched(ops, "flashbias_attention_torch",
                 rowwise(flashbias_attention_torch)):
        _, lengths = phase_parity(engine, requests,
                                  max_len=PAGED_HYBRID_MAX_LEN,
                                  steps=HYBRID_DECODE_STEPS,
                                  tol=HYBRID_LOGIT_TOL, trace=False,
                                  label="paged-hybrid-parity")
    times = model_kernel_times("paged-hybrid-times", cfg, params,
                               wave_width(requests), lengths.tolist(), card,
                               window=cfg.window, paged_only=True)
    batch, lens = ssm_wave(requests)
    steps = step_profile("paged-hybrid-times", model, params, batch, lens,
                         PAGED_HYBRID_MAX_LEN, card)
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches, "times": times, "steps": steps,
            "tok_s": tok_s}


def moe_serve(label: str, cfg, seed: int, requests, card: str,
              full: bool = False) -> dict:
    """One MoE config through a contiguous and a paged engine, the paged
    first-token logits within LOGIT_TOL of the contiguous ones and the
    greedy streams compared, the first wave's parity on both caches; with
    ``full`` (the LM phase's traffic) the paged pool must preempt, and the
    chunked prefix-cached engines and the step profiles follow. Returns the
    launches of the serves."""
    import torch
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine
    t0 = time.monotonic()
    model = get_model(cfg)
    params = bf16_params(cfg, seed)
    engine = ServeEngine(model, params, max_len=MAX_LEN, n_slots=SLOTS,
                         prefill_len=PROMPT_MAX, device="cuda")
    del params
    params = engine.backend.params
    log(label, f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
               f"{cfg.heads_padded} heads x {cfg.resolved_head_dim} over "
               f"{cfg.kv_heads_padded} kv heads, {cfg.n_experts} experts "
               f"(padded {cfg.experts_padded}) top {cfg.top_k}, d_ff "
               f"{cfg.d_ff}, vocab {cfg.vocab_padded}, {cfg.dtype}; weights "
               f"ready in {time.monotonic() - t0:.1f}s")
    rids, l_con, tok_s, first = serve_checked(label, engine, requests,
                                              paged=False)
    paged = paged_engine(model, params, requests, MAX_LEN,
                         prefill_len=PROMPT_MAX)
    prids, l_pag, ptok_s, pfirst = serve_checked(f"{label}-paged", paged,
                                                 requests, paged=True,
                                                 preempt=full)
    first_gaps(f"{label}-paged", pfirst, first, LOGIT_TOL)
    greedy = [i for i, (_, _, sp) in enumerate(requests)
              if sp.temperature == 0]
    same = sum(np.array_equal(engine.result(rids[i]), paged.result(prids[i]))
               for i in greedy)
    log(f"{label}-paged", f"greedy streams equal to the contiguous "
                          f"engine's: {same}/{len(greedy)} (bf16: the paths "
                          f"round in other places, so a near tie may flip "
                          f"a token; the rule is the logits parity below)")
    del paged
    torch.cuda.empty_cache()
    _, lengths = phase_parity(engine, requests, trace=False,
                              label=f"{label}-parity")
    out = {"launches": merge_launches({}, l_con, l_pag), "tok_s": tok_s,
           "paged_tok_s": ptok_s, "times": model_kernel_times(
               f"{label}-times", cfg, params, wave_width(requests),
               lengths.tolist(), card)}
    if full:
        phase_prefix(engine, seed, card, label=f"{label}-prefix")
        batch, lens = ssm_wave(requests)
        out["steps"] = step_profile(f"{label}-times", model, params, batch,
                                    lens, MAX_LEN, card)
    del engine
    torch.cuda.empty_cache()
    return out


def phase_moe(seed: int, card: str) -> dict:
    """granite-moe-3b-a800m at MOE_GRANITE_LAYERS of its 32 layers and
    llama4-scout-17b-a16e at MOE_LLAMA_LAYERS of its 48, full width (see
    the module docstring, phase 19)."""
    from repro_torch.configs import get_config
    full = get_config("granite_moe_3b_a800m")
    cfg = full.replace(n_layers=MOE_GRANITE_LAYERS)
    check_width(cfg, (full.n_layers, cfg.d_model, cfg.heads_padded,
                      cfg.kv_heads_padded, cfg.resolved_head_dim,
                      cfg.experts_padded, cfg.top_k, cfg.d_ff),
                (32, 1536, 32, 8, 64, 48, 8, 512))
    granite = moe_serve("moe", cfg, seed, make_requests(seed, cfg.vocab),
                        card, full=True)
    full = get_config("llama4_scout_17b_a16e")
    cfg = full.replace(n_layers=MOE_LLAMA_LAYERS)
    check_width(cfg, (full.n_layers, cfg.d_model, cfg.heads_padded,
                      cfg.kv_heads_padded, cfg.resolved_head_dim,
                      cfg.experts_padded, cfg.top_k, cfg.d_ff),
                (48, 5120, 48, 8, 128, 16, 1, 8192))
    log("moe-llama4", f"{cfg.name} at {MOE_LLAMA_LAYERS} of {full.n_layers}"
                      f" layers (full width; the whole model's 100.7 B "
                      f"parameters would not fit one card)")
    llama = moe_serve("moe-llama4", cfg, seed, make_traffic(
        seed, cfg.vocab, SHORT_PROMPTS, SHORT_NEW_TOKENS, (1,), stream=700),
        card)
    return {"granite": granite, "llama4": llama,
            "launches": merge_launches({}, granite["launches"],
                                       llama["launches"])}


def phase_dense_configs(seed: int, card: str) -> dict:
    """codeqwen1.5-7b and minicpm-2b at DENSE_LAYERS, command-r-plus-104b
    at DENSE_R_LAYERS of its 64 layers, full width (see the module
    docstring, phase 20)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    out = {"launches": {}}
    widths = {"codeqwen15_7b": ("codeqwen", (32, 4096, 32, 32, 128)),
              "minicpm_2b": ("minicpm", (40, 2304, 48, 48, 64)),
              "command_r_plus_104b": ("command-r", (64, 12288, 96, 8, 128))}
    for arch, (tag, want) in widths.items():
        full = get_config(arch)
        cfg = full.replace(n_layers=DENSE_R_LAYERS
                           if arch == "command_r_plus_104b" else DENSE_LAYERS)
        check_width(cfg, (full.n_layers, cfg.d_model, cfg.heads_padded,
                          cfg.kv_heads_padded, cfg.resolved_head_dim), want)
        label = f"dense-{tag}"
        t0 = time.monotonic()
        model = get_model(cfg)
        params = bf16_params(cfg, seed)
        requests = make_traffic(seed, cfg.vocab, SHORT_PROMPTS,
                                SHORT_NEW_TOKENS, (1,), stream=800)
        engine = paged_engine(model, params, requests, MAX_LEN)
        del params
        log(label, f"{cfg.name}: {cfg.n_layers} of {full.n_layers} layers, "
                   f"d_model {cfg.d_model}, {cfg.heads_padded} heads x "
                   f"{cfg.resolved_head_dim} over {cfg.kv_heads_padded} kv "
                   f"heads (G {cfg.kv_groups}), d_ff {cfg.d_ff}, vocab "
                   f"{cfg.vocab_padded}; weights ready in "
                   f"{time.monotonic() - t0:.1f}s")
        _, launches, tok_s, _ = serve_checked(label, engine, requests,
                                              paged=True, preempt=False)
        merge_launches(out["launches"], launches)
        _, lengths = phase_parity(engine, requests, steps=2, tol=None,
                                  trace=False, label=f"{label}-parity")
        out[arch] = {"tok_s": tok_s, "times": model_kernel_times(
            f"{label}-times", cfg, engine.backend.params,
            wave_width(requests), lengths.tolist(), card)}
        if arch == "command_r_plus_104b":
            gen = torch.Generator(device="cuda").manual_seed(seed + 2)
            wide_group_decode(gen, np.random.default_rng(seed + 2),
                              functools.partial(check_kernel, {},
                                                label=f"{label}-kernels"), 12)
        del engine
        torch.cuda.empty_cache()
    return out

def phase_frontends(seed: int, card: str) -> dict:
    """musicgen-medium and phi-3-vision-4.2b whole, at full width, each
    request opening with the config's frontend rows (see the module
    docstring, phase 21)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import frontend_rows
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine
    out = {"launches": {}}
    widths = {"musicgen_medium": ("musicgen", (48, 1536, 32, 32, 64, 64)),
              "phi3_vision_42b": ("phi3", (32, 3072, 32, 32, 96, 576))}
    for arch, (tag, want) in widths.items():
        cfg = get_config(arch)
        check_width(cfg, (cfg.n_layers, cfg.d_model, cfg.heads_padded,
                          cfg.kv_heads_padded, cfg.resolved_head_dim,
                          cfg.frontend_len), want)
        label = f"frontends-{tag}"
        t0 = time.monotonic()
        model = get_model(cfg)
        params = bf16_params(cfg, seed)
        requests = make_traffic(seed, cfg.vocab, FRONTEND_PROMPTS,
                                FRONTEND_NEW_TOKENS, (1,), stream=900)
        fronts = frontend_rows(cfg, len(requests), seed)
        engine = ServeEngine(model, params, max_len=MAX_LEN, n_slots=SLOTS,
                             device="cuda")
        del params
        params = engine.backend.params
        log(label, f"{cfg.name}: {cfg.n_layers} layers, d_model "
                   f"{cfg.d_model}, {cfg.heads_padded} heads x "
                   f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
                   f"{cfg.vocab_padded}, {cfg.frontend} frontend of "
                   f"{cfg.frontend_len} rows per request; "
                   f"{cfg.param_count() / 1e9:.2f} B parameters; weights "
                   f"ready in {time.monotonic() - t0:.1f}s")
        rids, l_con, tok_s, first = serve_checked(label, engine, requests,
                                                  paged=False,
                                                  frontends=fronts)
        paged = paged_engine(model, params, requests, MAX_LEN)
        _, l_pag, ptok_s, pfirst = serve_checked(
            f"{label}-paged", paged, requests, paged=True, preempt=False,
            frontends=fronts)
        top = max(float(v.abs().max()) for v in first.values())
        first_gaps(f"{label}-paged", pfirst, first, max(
            LOGIT_TOL, LOGIT_ULPS * float(bf16_ulp(torch.tensor(top)))))
        del paged
        torch.cuda.empty_cache()
        _, lengths = phase_parity(engine, requests, steps=4, tol=None,
                                  trace=False, label=f"{label}-parity",
                                  frontends=fronts)
        merge_launches(out["launches"], l_con, l_pag)
        out[arch] = {"tok_s": tok_s, "paged_tok_s": ptok_s}
        if arch == "phi3_vision_42b":
            out[arch]["times"] = model_kernel_times(
                f"{label}-times", cfg, params,
                wave_width(requests) + cfg.frontend_len, lengths.tolist(),
                card)
        del engine, params
        torch.cuda.empty_cache()
    return out


def grad_norms(params: dict) -> dict:
    """Each leaf's gradient norm (float32), by leaf path."""
    import torch
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{path}/{k}" if path else k)
        else:
            out[path] = (float(torch.linalg.vector_norm(tree.grad.float()))
                         if tree.grad is not None else 0.0)
    walk(params, "")
    return out


def step0_parity(label: str, cfg, params, batch: dict, kernel: str,
                 calls: int) -> dict:
    """Step 0's loss and each leaf's gradient norm on the kernel path
    (impl="cuda") and the plain path (impl="torch"), the same weights and
    batch, ``cfg.grad_accum`` microbatches each; ``kernel`` (the counted
    wrapper) launched ``calls`` times on the kernel path and never on the
    plain one. Returns the kernel path's loss and norms."""
    import torch
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_leaves
    got = {}
    for impl in ("cuda", "torch"):
        model = get_model(cfg.replace(attn_impl=impl))
        for p in tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        counters = reset_counters()
        a = cfg.grad_accum
        loss = 0.0
        for i in range(a):
            mb = {k: v.reshape((a, -1) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            part = model.loss(params, mb)
            part.backward()
            loss += float(part.detach()) / a
        launched = {n: w.launches for n, w in counters.items() if w.launches}
        want = {kernel: calls} if impl == "cuda" else {}
        if launched != want:
            raise AssertionError(f"{label}: impl={impl} launches {launched} "
                                 f"!= {want}")
        got[impl] = (loss, grad_norms(params))
    for p in tree_leaves(params):
        p.grad = None
    torch.cuda.empty_cache()
    paths_agree(label, "step 0, kernel path against the plain path",
                (*got["cuda"], None), (*got["torch"], None))
    return got["cuda"]


def train_setup(cfg, seed: int, steps: int):
    """Float32 master weights made on the card from ``seed``
    (``init_params``), AdamW (cosine from TRAIN_LR, the launcher's warmup),
    the train step at the config's grad_accum, and the step's data: the
    LMBatches of TRAIN_BATCH x TRAIN_SEQ tokens from ``seed``. Returns
    (fresh, step_fn, data_fn), ``fresh()`` -> (params, opt_state)."""
    import torch
    from repro_torch.data import LMBatches
    from repro_torch.models import get_model, init_params
    from repro_torch.optim import AdamW, cosine
    from repro_torch.train import make_train_step
    opt = AdamW(lr_fn=cosine(TRAIN_LR, steps // 10, steps))
    data = LMBatches(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                     global_batch=TRAIN_BATCH, seed=seed)

    def fresh():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = init_params(cfg, gen, device="cuda")
        return params, opt.init(params)

    def data_fn(step):
        return {k: torch.as_tensor(v, device="cuda")
                for k, v in data.batch(step).items()}

    step_fn = make_train_step(get_model(cfg).loss, opt,
                              grad_accum=cfg.grad_accum)
    return fresh, step_fn, data_fn


def train_shape():
    """Phase 22's step as a dry-run shape: TRAIN_BATCH x TRAIN_SEQ."""
    from repro_torch.configs import ShapeSpec
    return ShapeSpec(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", TRAIN_SEQ,
                     TRAIN_BATCH, "train")


def train_flops(cfg) -> float:
    """Model FLOPs of one training step, by the roofline's definition
    (``analysis.roofline``): ``model_flops`` (6 x the active, unpadded
    parameters x tokens; the tied embedding once, as the unembedding)
    plus ``attention_kernel_flops`` (causal: half the pairs, 2 x 2 x D + 4
    (ALiBi) FLOPs a pair and head, at the padded heads the card computes,
    forward and backward 3x) at the step's ``ShapeSpec`` on one card, with
    kernel 1's 64-row tiles; recomputation not counted."""
    from repro_torch.analysis.roofline import (attention_kernel_flops,
                                               model_flops)
    from repro_torch.kernels.io_stub import KERNEL1_TILE
    shape = train_shape()
    return model_flops(cfg, shape) + attention_kernel_flops(
        cfg, shape, 1, 1, block=KERNEL1_TILE[0])


def attention_train_ms(cfg, micro: int) -> dict:
    """Device time per call of kernel 1's forward and of the plain backward
    (``_FlashAttention.backward``: the plain forward recomputed and
    differentiated) at one training microbatch's attention shape."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(5)
    h, d = cfg.heads_padded, cfg.resolved_head_dim
    q, k, v = (torch.randn((micro, h, TRAIN_SEQ, d), generator=gen,
                           device="cuda").to(torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    from repro_torch.core.bias import alibi_slopes
    slopes = alibi_slopes(h, device="cuda").requires_grad_(True)

    def fwd():
        return ops.flash_attention(q, k, v, slopes=slopes,
                                   mask_kind="causal", impl="cuda",
                                   layout="bhsd")
    out = fwd()
    grad = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    with torch.no_grad():
        fwd_ms = device_ms(fwd)
    bwd_ms = device_ms(lambda: torch.autograd.grad(
        out, (q, k, v, slopes), grad, retain_graph=True), iters=5)
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms}


def phase_train(seed: int, card: str) -> dict:
    """GPT-2-ALiBi-1.5B trained at full width through TrainLoop, with a
    checkpoint, a restore and the kernel path held against the plain one;
    then Mamba2-130M whole (see the module docstring, phase 22)."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flashbias_attn import flashbias_attention_fwd
    from repro_torch.models import get_model
    from repro_torch.models.common import count_params
    from repro_torch.train import TrainLoop

    full = get_config("gpt2_alibi_15b")
    cfg = full.replace(n_layers=TRAIN_LAYERS)
    check_width(cfg, (full.n_layers, cfg.d_model, cfg.heads_padded,
                      cfg.resolved_head_dim, cfg.vocab_padded, cfg.remat,
                      cfg.grad_accum), (48, 1600, 64, 32, 50272, "dots", 4))
    n_params = count_params(get_model(cfg).template())
    # kernel 1 per step: one forward per layer and microbatch, and one more
    # when the backward recomputes the checkpointed layer ("dots" and
    # "full": no policy can keep the output of a kernel that is no aten op)
    per_step = (2 if cfg.remat != "none" else 1) * cfg.n_layers \
        * cfg.grad_accum
    fresh, step_fn, data_fn = train_setup(cfg, seed, TRAIN_STEPS)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(ckpt_dir).free
    log("train", f"{cfg.name}: {cfg.n_layers} layers, d_model "
                 f"{cfg.d_model}, {cfg.heads_padded} heads x "
                 f"{cfg.resolved_head_dim}, vocab {cfg.vocab_padded}; "
                 f"{n_params / 1e9:.3f} B parameters as float32 masters, "
                 f"{cfg.dtype} compute, remat {cfg.remat!r}, grad_accum "
                 f"{cfg.grad_accum}; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a "
                 f"step; kernel 1 expected {per_step} times a step; "
                 f"checkpoints in {ckpt_dir} ({free / 2**30:.0f} GiB free)")

    params, opt_state = fresh()
    step0_parity("train", cfg, params, data_fn(0), "flashbias_attention_fwd",
                 per_step)

    # the uninterrupted run: steps 0..TRAIN_CKPT_STEP through a loop that
    # checkpoints after its last step, then the rest in the same process
    # on the same tensors
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.monotonic()
    first = TrainLoop(step_fn, data_fn, ckpt_dir=ckpt_dir,
                      ckpt_every=TRAIN_CKPT_STEP + 1,
                      log_path=f"{ckpt_dir}/first.jsonl")
    params, opt_state, info1 = first.run(params, opt_state,
                                         TRAIN_CKPT_STEP + 1)
    t_ckpt = time.monotonic() - t0
    rest = TrainLoop(step_fn, data_fn, log_path=f"{ckpt_dir}/first.jsonl")
    params, opt_state, info2 = rest.run(params, opt_state, TRAIN_STEPS,
                                        start_step=TRAIN_CKPT_STEP + 1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launched = flashbias_attention_fwd.launches
    other = {n: w.launches for n, w in counters.items()
             if w.launches and n != "flashbias_attention_fwd"}
    with open(f"{ckpt_dir}/first.jsonl") as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs]
    walls = [r["wall_s"] for r in recs]
    log("train", f"uninterrupted: losses {losses}; grad norms "
                 f"{[round(r['grad_norm'], 4) for r in recs]}; lr "
                 f"{[r['lr'] for r in recs]}")
    log("train", f"kernel 1 launched {launched} times in "
                 f"{TRAIN_STEPS} steps (expected {per_step} x "
                 f"{TRAIN_STEPS} = {per_step * TRAIN_STEPS}); others "
                 f"{other}; tensor-core launches "
                 f"{flashbias_attention_fwd.tensor_core_launches}")
    if launched != per_step * TRAIN_STEPS or other or \
            flashbias_attention_fwd.tensor_core_launches != launched:
        raise AssertionError("train: kernel 1's launches off the derived "
                             "count")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train: the loss did not fall: {losses}")

    # a fresh loop on fresh weights restores the checkpoint and runs on;
    # its own final save is skipped: the card's machine takes at most 45
    # GiB of disk writes a call, and each checkpoint is ~26 GB at 48 layers
    ckpt_bytes = sum(f.stat().st_size
                     for f in Path(ckpt_dir).rglob("*.npy"))
    del params, opt_state
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    resumed = TrainLoop(step_fn, data_fn, ckpt_dir=ckpt_dir,
                        ckpt_every=TRAIN_STEPS,
                        log_path=f"{ckpt_dir}/resumed.jsonl")
    from repro_torch.train import loop as train_loop
    with patched(train_loop, "save_checkpoint", lambda *a, **k: None):
        params, opt_state, info3 = resumed.run(*fresh(), TRAIN_STEPS)
    t_resume = time.monotonic() - t0
    with open(f"{ckpt_dir}/resumed.jsonl") as f:
        again = [json.loads(line)["loss"] for line in f]
    log("train", f"restored after step {TRAIN_CKPT_STEP}: losses {again} "
                 f"(uninterrupted {losses[TRAIN_CKPT_STEP + 1:]}); the "
                 f"checkpoint {ckpt_bytes / 2**30:.2f} GiB; the first loop "
                 f"with its save {t_ckpt:.1f}s, the restored loop with its "
                 f"restore {t_resume:.1f}s")
    if again != losses[TRAIN_CKPT_STEP + 1:] or info3["final_step"] != \
            TRAIN_STEPS:
        raise AssertionError("train: the resumed losses differ from the "
                             "uninterrupted run's")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # host clock, device busy and idle share of one more step
    batch = data_fn(TRAIN_STEPS)
    state = {"p": params, "o": opt_state}

    def step():
        state["p"], state["o"], m = step_fn(state["p"], state["o"], batch)
        float(m["loss"])

    walls_more = []
    for _ in range(2):
        t0 = time.monotonic()
        step()
        walls_more.append(time.monotonic() - t0)
    busy, kernels = profile_steps(step, 1)
    host = float(np.median(walls[1:] + walls_more))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg)
    log("train", f"step: {host * 1e3:.1f} ms on the host clock (median of "
                 f"steps 1-{TRAIN_STEPS - 1} and 2 more; step 0 "
                 f"{walls[0] * 1e3:.1f} ms), device busy {busy:.1f} ms, "
                 f"idle share {1 - busy / (host * 1e3):.3f}; "
                 f"{tokens / host:.0f} tokens/s; model FLOPs {flops:.4e} a "
                 f"step (roofline model_flops + attention_kernel_flops): "
                 f"{flops / host / BF16_FLOP_PER_S:.4f} of 989 "
                 f"TFLOP/s on the host clock, {flops / (busy / 1e3) / BF16_FLOP_PER_S:.4f} "
                 f"of device busy; peak memory "
                 f"{peak / 2**30:.2f} GiB [{card}]")
    top_kernels("train", kernels, top=8)
    del state, params, opt_state, batch
    torch.cuda.empty_cache()
    attn = attention_train_ms(cfg, TRAIN_BATCH // cfg.grad_accum)
    calls = cfg.n_layers * cfg.grad_accum
    log("train", f"attention at the step's shape (B "
                 f"{TRAIN_BATCH // cfg.grad_accum} H {cfg.heads_padded} N "
                 f"{TRAIN_SEQ} D {cfg.resolved_head_dim} bf16, ALiBi "
                 f"causal), device time per call: kernel 1 forward "
                 f"{attn['fwd_ms']:.4f} ms, the plain backward (recompute "
                 f"and gradients of q, k, v and the slopes) "
                 f"{attn['bwd_ms']:.4f} ms; {calls} backward calls a step "
                 f"take {attn['bwd_ms'] * calls:.1f} ms, "
                 f"{attn['bwd_ms'] * calls / busy:.3f} of the step's device "
                 f"busy [{card}]")
    gpt2 = {"launches": launched, "losses": losses, "step_ms": host * 1e3,
            "busy_ms": busy, "tok_s": tokens / host, "peak_gib":
            peak / 2**30, "mfu_host": flops / host / BF16_FLOP_PER_S,
            "attn_bwd_share": attn["bwd_ms"] * calls / busy}

    ssm = phase_train_ssm(seed, card)
    return {"launches": {"flashbias_attention_fwd": launched,
                         "ssd_scan_fwd": ssm["launches"]},
            "gpt2": gpt2, "ssm": ssm}


def phase_train_ssm(seed: int, card: str) -> dict:
    """Mamba2-130M whole for SSM_TRAIN_STEPS steps: kernel 5's launches and
    step 0 against the plain path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd
    from repro_torch.train import TrainLoop
    cfg = get_config("mamba2_130m")
    check_width(cfg, (cfg.n_layers, cfg.d_model, cfg.ssm_heads_padded,
                      cfg.ssm_head_dim, cfg.ssm_state, cfg.remat,
                      cfg.grad_accum), (24, 768, 32, 64, 128, "dots", 4))
    per_step = (2 if cfg.remat != "none" else 1) * cfg.n_layers \
        * cfg.grad_accum
    fresh, step_fn, data_fn = train_setup(cfg, seed, SSM_TRAIN_STEPS)
    params, opt_state = fresh()
    step0_parity("train-ssm", cfg, params, data_fn(0), "ssd_scan_fwd",
                 per_step)
    counters = reset_counters()
    losses = []
    loop = TrainLoop(lambda p, o, b: _keep(losses, step_fn(p, o, b)),
                     data_fn)
    t0 = time.monotonic()
    params, opt_state, info = loop.run(params, opt_state, SSM_TRAIN_STEPS)
    wall = time.monotonic() - t0
    launched = {n: w.launches for n, w in counters.items() if w.launches}
    log("train-ssm", f"{cfg.name}: losses {losses}; {info}; "
                     f"{SSM_TRAIN_STEPS} steps in {wall:.1f}s; launches "
                     f"{launched} (kernel 5 expected {per_step} x "
                     f"{SSM_TRAIN_STEPS}); tensor-core launches "
                     f"{ssd_scan_fwd.tensor_core_launches} [{card}]")
    if launched != {"ssd_scan_fwd": per_step * SSM_TRAIN_STEPS} or \
            ssd_scan_fwd.tensor_core_launches != per_step * SSM_TRAIN_STEPS:
        raise AssertionError("train-ssm: kernel 5's launches off the "
                             "derived count")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train-ssm: losses {losses}")
    del params, opt_state
    torch.cuda.empty_cache()
    return {"launches": per_step * SSM_TRAIN_STEPS, "losses": losses}


def _keep(losses: list, out):
    """A train step's result, its loss appended to ``losses``."""
    losses.append(float(out[2]["loss"]))
    return out


# ---------------------------------------------------------------------------
# phases 23-25: training the paper's models (Pairformer, PDE solver, Swin)
# ---------------------------------------------------------------------------

def loss_and_norms(loss_fn, *trees) -> tuple:
    """``loss_fn(*trees)`` and its backward on leaf copies of ``trees``,
    every launch counter set to 0 just before and read just after: (the
    loss, each leaf's gradient norm by path (0 where the loss does not
    reach the leaf), {wrapper: launches} of the wrappers that moved)."""
    import torch
    from repro_torch.models.common import tree_map
    leaves = [tree_map(lambda p: p.detach().clone().requires_grad_(True), t)
              for t in trees]
    counters = reset_counters()
    loss = loss_fn(*leaves)
    loss.backward()
    torch.cuda.synchronize()
    launched = {n: w.launches for n, w in counters.items() if w.launches}
    norms = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{path}/{k}")
        else:
            norms[path] = (0.0 if tree.grad is None else float(
                torch.linalg.vector_norm(tree.grad.float())))
    for i, tree in enumerate(leaves):
        walk(tree, str(i))
    out = float(loss.detach())
    del leaves, loss
    torch.cuda.empty_cache()
    return out, norms, launched


def paths_agree(phase: str, label: str, got: tuple, want: tuple) -> None:
    """Two (loss, leaf gradient norms, launches) results, as
    ``loss_and_norms`` gives them, within TRAIN_LOSS_RTOL (the loss) and
    TRAIN_GRAD_RTOL (every leaf's gradient norm, relative to at least
    TRAIN_GRAD_FLOOR of the largest leaf norm), logged."""
    (lk, gk, _), (lt, gt, _) = got, want
    floor = TRAIN_GRAD_FLOOR * max(gt.values())
    rel = {k: abs(gk[k] - gt[k]) / max(gt[k], floor, 1e-30) for k in gt}
    worst = max(rel, key=rel.get)
    ok = (abs(lk - lt) <= TRAIN_LOSS_RTOL * abs(lt)
          and rel[worst] <= TRAIN_GRAD_RTOL)
    log(phase, f"{label}: loss {lk:.6f} / {lt:.6f} (relative gap "
               f"{abs(lk - lt) / abs(lt):.3e}, tol {TRAIN_LOSS_RTOL}); leaf "
               f"gradient norms' worst relative gap {rel[worst]:.3e} at "
               f"{worst} (norm {gt[worst]:.4e}; tol {TRAIN_GRAD_RTOL}); "
               f"{len(rel)} leaves {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{phase}: {label}: the paths disagree")


def train_model(phase: str, loss_fn, params, batch: dict, launches: dict,
                card: str, lr: float = TRAIN_LR) -> dict:
    """MODEL_TRAIN_STEPS steps of ``make_train_step(loss_fn, AdamW)`` (cosine
    from ``lr``, the launcher's warmup) on ``batch``, the launch counters
    set to 0 just before and read just after, each wrapper of ``launches``
    held to its count a step; then one more step traced (device busy, idle
    share, top kernels). The losses finite and lower at the last step than
    at the first. Returns the losses, the step's host ms (median of steps
    1..), device busy, peak memory (GiB) and the launches."""
    import torch
    from repro_torch.optim import AdamW, cosine
    from repro_torch.train import make_train_step
    steps = MODEL_TRAIN_STEPS
    opt = AdamW(lr_fn=cosine(lr, steps // 10, steps))
    step_fn = make_train_step(loss_fn, opt)
    state = {"p": params, "o": opt.init(params)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    losses, walls = [], []
    for i in range(steps):
        t0 = time.monotonic()
        state["p"], state["o"], m = step_fn(state["p"], state["o"], batch)
        losses.append(float(m["loss"]))
        walls.append(time.monotonic() - t0)
    peak = torch.cuda.max_memory_allocated()
    launched = {n: w.launches for n, w in counters.items() if w.launches}
    want = {n: c * steps for n, c in launches.items()}
    log(phase, f"{steps} steps: losses {losses}; host s "
               f"{[round(w, 3) for w in walls]}; launches {launched} (expected {want}); peak memory "
               f"{peak / 2**30:.2f} GiB [{card}]")
    if launched != want:
        raise AssertionError(f"{phase}: launches {launched} != {want}")
    check_tensor_core(phase, tuple(launches))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")

    def step():
        state["p"], state["o"], m = step_fn(state["p"], state["o"], batch)
        float(m["loss"])

    busy, kernels = profile_steps(step, 1)
    host = float(np.median(walls[1:])) * 1e3
    log(phase, f"step: {host:.1f} ms on the host clock (median of steps "
               f"1-{steps - 1}; step 0 {walls[0] * 1e3:.1f} ms), device "
               f"busy {busy:.1f} ms, idle share {1 - busy / host:.3f} "
               f"[{card}]")
    top_kernels(phase, kernels, top=8)
    del state
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": host, "busy_ms": busy,
            "peak_gib": peak / 2**30, "launches": launched}


def phase_pair_train(seed: int, card: str) -> dict:
    """Pairformer-lite whole: the Eq. 5 fit, denoise_loss through kernel 1
    held in situ and against the plain path, training steps (see the module
    docstring, phase 23)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, pairformer
    from repro_torch.models.common import materialize, stack_layers

    cfg = get_config("pairformer_lite")
    layers = cfg.n_layers
    check_width(cfg, (layers, cfg.d_model, cfg.d_pair, cfg.n_heads,
                      cfg.resolved_head_dim, cfg.bias_rank, cfg.dtype),
                (16, 384, 128, 4, 96, 96, "bfloat16"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    factors = materialize(stack_layers(pairformer.factor_mlp_template(
        cfg, PAIR_TRAIN_HIDDEN), layers), gen, device="cuda")
    n = PAIR_TRAIN_RES
    feats = torch.randn((PAIR_FIT_COMPLEXES, n, 64), generator=gen,
                        device="cuda")
    batch = {"feats": feats[:PAIR_TRAIN_BATCH],
             "coords": torch.randn((PAIR_TRAIN_BATCH, n, 3), generator=gen,
                                   device="cuda")}
    log("pair-train", f"{cfg.name}: {layers} layers, d_single "
                      f"{cfg.d_model}, d_pair {cfg.d_pair}, {cfg.n_heads} "
                      f"heads x {cfg.resolved_head_dim}, R {cfg.bias_rank}, "
                      f"factor MLPs of hidden {PAIR_TRAIN_HIDDEN}, "
                      f"{cfg.dtype} compute, float32 masters; {n} residues")

    # step 1: Eq. 5 on two complexes, the trunk frozen
    torch.cuda.synchronize()
    t0 = time.monotonic()
    factors, fit = pairformer.fit_factor_mlps(params, factors, feats, cfg,
                                              steps=PAIR_FIT_STEPS,
                                              lr=PAIR_FIT_LR)
    fit_s = time.monotonic() - t0
    log("pair-train", f"fit_factor_mlps, {PAIR_FIT_STEPS} steps on "
                      f"{PAIR_FIT_COMPLEXES} complexes: Eq. 5 loss "
                      f"{fit[0]:.6f} -> {fit[-1]:.6f} ({fit_s:.1f} s on the "
                      f"host clock, the trunk replay included)")
    if not (all(np.isfinite(fit)) and fit[-1] < fit[0]):
        raise AssertionError(f"pair-train: the Eq. 5 loss did not fall: "
                             f"{fit}")

    # step 2: the forward through kernel 1, every call held in situ
    calls: list = []
    with patched(ops, "flashbias_attention_fwd", in_situ_attention(calls)):
        loss, launches = counted(lambda: pairformer.denoise_loss(
            params, batch, cfg, factors))
    log("pair-train", f"denoise_loss with the fitted factors: "
                      f"{float(loss):.6f}, launches {launches}")
    if launches != {"flashbias_attention_fwd": layers}:
        raise AssertionError(f"pair-train: launches {launches}, want "
                             f"{layers} of kernel 1")
    check_tensor_core("pair-train", ("flashbias_attention_fwd",))
    in_situ_check("pair-train", calls, layers)

    # step 3: loss and gradients of the trunk and the factors, kernel path
    # against the plain path
    torch.cuda.reset_peak_memory_stats()
    paths = {impl: loss_and_norms(
        lambda p, f, c=cfg.replace(attn_impl=impl):
            pairformer.denoise_loss(p, batch, c, f), params, factors)
        for impl in ("cuda", "torch")}
    grad_peak = torch.cuda.max_memory_allocated()
    if paths["cuda"][2] != {"flashbias_attention_fwd": layers} or \
            paths["torch"][2]:
        raise AssertionError(f"pair-train: launches {paths['cuda'][2]} / "
                             f"{paths['torch'][2]}")
    paths_agree("pair-train", f"loss and gradients (trunk and factor MLPs, "
                              f"B {PAIR_TRAIN_BATCH}), kernel path against "
                              f"the plain path", paths["cuda"], paths["torch"])
    log("pair-train", f"peak memory of a forward and backward: "
                      f"{grad_peak / 2**30:.2f} GiB [{card}]")

    # the output drift of the fitted factors against the dense bias
    with torch.no_grad():
        fb = pairformer.forward(params, batch["feats"], cfg, factors)
        dense = pairformer.forward(params, batch["feats"],
                                   cfg.replace(bias_mode="dense"))
    drift = float((fb.float() - dense.float()).abs().max())
    log("pair-train", f"output drift, fitted factors against the dense "
                      f"bias: max |gap| {drift:.4e} at a top |output| of "
                      f"{float(dense.float().abs().max()):.4e}")
    if not (torch.isfinite(fb).all() and np.isfinite(drift)):
        raise AssertionError("pair-train: the outputs are not finite")

    # kernel 1 at the training path's shape, on random factors of its rank
    h, hd, r = cfg.n_heads, cfg.resolved_head_dim, cfg.bias_rank
    q, k, v = (torch.randn((PAIR_TRAIN_BATCH, h, n, hd), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    fq, fk = (torch.randn((PAIR_TRAIN_BATCH, h, n, r), generator=gen,
                          device="cuda") * r ** -0.5 for _ in range(2))
    mask = torch.einsum("bhnr,bhmr->bhnm", fq, fk).to(torch.bfloat16)
    times = attention_call(
        "pair-train", f"kernel 1 at the Pairformer's training shape B"
        f"{PAIR_TRAIN_BATCH} H{h} N=M{n} D{hd} R{r} bf16 phi (float32 "
        f"factors)", q, k, v, fq, fk, fq, fk, card,
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
    del q, k, v, fq, fk, mask

    # step 4: the trunk and the factor MLPs trained together
    trained = train_model(
        "pair-train", lambda p, b: pairformer.denoise_loss(
            p["trunk"], b, cfg, p["factors"]),
        {"trunk": params, "factors": factors}, batch,
        {"flashbias_attention_fwd": layers}, card, lr=PAIR_TRAIN_LR)
    del params, factors, feats, batch
    torch.cuda.empty_cache()
    return {"launches": trained["launches"],
            "fit": [fit[0], fit[-1]], "drift": drift, "kernel": times,
            "grad_peak_gib": grad_peak / 2**30, **{
                k: trained[k] for k in ("losses", "step_ms", "busy_ms",
                                        "peak_gib")}}


def attention_bwd_ms(q, k, v, phi_q, phi_k) -> float:
    """Device time per call of ``_FlashAttention``'s plain backward (the
    plain forward recomputed, by query blocks where it must be, and
    differentiated) on head-major inputs."""
    import torch
    from repro_torch.kernels import ops
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v, phi_q,
                                                         phi_k)]
    out = ops.flash_attention(*leaves[:4], leaves[4].expand_as(leaves[3])
                              if leaves[4].shape[1] == 1 else leaves[4],
                              impl="cuda", layout="bhsd")
    grad = torch.randn_like(out)
    return device_ms(lambda: torch.autograd.grad(
        out, leaves, grad, retain_graph=True), iters=2, warmup=1)


def phase_pde_train(seed: int, card: str) -> dict:
    """The PDE solver whole trained at 32186 points through kernel 1 and the
    query-blocked plain backward (see the module docstring, phase 24)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.bias import sqdist_factors
    from repro_torch.data import PDEBatches
    from repro_torch.kernels import ops
    from repro_torch.models import get_model, init_params

    cfg = get_config("pde_solver")
    layers, heads, hd = cfg.n_layers, cfg.n_heads, cfg.resolved_head_dim
    check_width(cfg, (layers, cfg.d_model, heads, hd, cfg.d_ff,
                      cfg.coord_dim, cfg.dtype),
                (8, 128, 8, 16, 256, 3, "bfloat16"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    model = get_model(cfg)

    def points(n, step=0):
        b = PDEBatches(n_points=n, global_batch=1, seed=seed).batch(step)
        return {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}

    rows = ops.backward_block_rows(1, heads, PDE_POINTS, PDE_POINTS)
    log("pde-train", f"{cfg.name}: {layers} layers, d_model {cfg.d_model}, "
                     f"{heads} heads x {hd}, {cfg.dtype}; PDEBatches of "
                     f"{PDE_POINTS} points; the backward recomputes "
                     f"{-(-PDE_POINTS // rows)} query blocks of {rows} rows "
                     f"a layer (scores under {ops.BWD_SCORE_BYTES / 2**30:.1f}"
                     f" GiB)")
    # the kernel path against the plain path, and FlashBias against the
    # dense bias (Table 5), on the same weights
    small = points(PDE_PARITY_POINTS)
    paths = {impl: loss_and_norms(
        lambda p, c=cfg.replace(attn_impl=impl): get_model(c).loss(p, small),
        params) for impl in ("cuda", "torch")}
    if paths["cuda"][2] != {"flashbias_attention_fwd": layers} or \
            paths["torch"][2]:
        raise AssertionError(f"pde-train: launches {paths['cuda'][2]} / "
                             f"{paths['torch'][2]}")
    paths_agree("pde-train", f"N={PDE_PARITY_POINTS}, kernel path against "
                             f"the plain path", paths["cuda"], paths["torch"])
    tiny = points(PDE_TABLE5_POINTS)
    modes = {mode: loss_and_norms(
        lambda p, c=cfg.replace(bias_mode=mode): get_model(c).loss(p, tiny),
        params) for mode in ("flashbias", "dense")}
    if modes["dense"][2]:
        raise AssertionError(f"pde-train: the dense path launched "
                             f"{modes['dense'][2]}")
    paths_agree("pde-train", f"N={PDE_TABLE5_POINTS}, FlashBias against the "
                             f"dense bias (Table 5)", modes["flashbias"],
                modes["dense"])

    batch = points(PDE_POINTS)
    trained = train_model("pde-train", model.loss, params, batch,
                          {"flashbias_attention_fwd": layers}, card)
    # the plain backward at the step's attention shape, per layer
    lp0 = {key: val[0].detach() for key, val in params["layers"].items()}
    pts = batch["coords"]
    q, k, v = (torch.randn((1, heads, PDE_POINTS, hd), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    alpha = F.softplus(pts @ lp0["alpha_w"] + lp0["alpha_b"])
    pq0, pk0 = sqdist_factors(pts, pts, negate=True)
    phi_q = (alpha[..., None] * pq0[:, :, None]).transpose(1, 2).contiguous()
    bwd = attention_bwd_ms(q, k, v, phi_q, pk0[:, None])
    share = bwd * layers / trained["busy_ms"]
    log("pde-train", f"the plain attention backward at the step's shape (B 1 "
                     f"H {heads} N=M {PDE_POINTS} D {hd} bf16, R "
                     f"{pq0.shape[-1]} float32 factors, phi_k shared by the "
                     f"heads): {bwd:.2f} ms a call; {layers} calls a step "
                     f"take {bwd * layers:.1f} ms, {share:.3f} of the step's "
                     f"device busy [{card}]")
    del params, batch, small, tiny, q, k, v, phi_q
    torch.cuda.empty_cache()
    return {"launches": trained["launches"],
            "bwd_ms": bwd, "bwd_share": share, "block_rows": rows, **{
                k: trained[k] for k in ("losses", "step_ms", "busy_ms",
                                        "peak_gib")}}


def phase_swin_train(seed: int, card: str) -> dict:
    """SwinV2-B whole trained with the dense tables, and its gradients with
    SVD factors through kernel 1 against the plain path (see the module
    docstring, phase 25)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import PatchBatches
    from repro_torch.models import get_model, init_params, swin

    cfg = get_config("swinv2_b")
    layers, w, r = cfg.n_layers, cfg.window, cfg.bias_rank
    check_width(cfg, (layers, cfg.d_model, cfg.n_heads,
                      cfg.resolved_head_dim, w, r, cfg.d_ff, cfg.dtype),
                (24, 512, 16, 32, 576, 16, 2048, "bfloat16"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in PatchBatches(
        n_windows=SWIN_TRAIN_WINDOWS, window=w, global_batch=SWIN_TRAIN_IMAGES,
        seed=seed).batch(0).items()}
    log("swin-train", f"{cfg.name}: {layers} layers, d_model {cfg.d_model}, "
                      f"{cfg.n_heads} heads x {cfg.resolved_head_dim}, "
                      f"window {w}, {cfg.dtype}; PatchBatches of "
                      f"{SWIN_TRAIN_IMAGES} images x {SWIN_TRAIN_WINDOWS} "
                      f"windows; training with the dense tables")
    # gradients with the SVD factors of the tables (kernel 1) against the
    # plain path
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        factors = swin.svd_factorize(params, r)
    torch.cuda.synchronize()
    log("swin-train", f"svd_factorize of {layers * cfg.n_heads} tables: "
                      f"{time.monotonic() - t0:.1f} s on the host clock")
    paths = {impl: loss_and_norms(
        lambda p, f, c=cfg.replace(attn_impl=impl):
            swin.classify_loss(p, batch, c, f), params, factors)
        for impl in ("cuda", "torch")}
    if paths["cuda"][2] != {"flashbias_attention_fwd": layers} or \
            paths["torch"][2]:
        raise AssertionError(f"swin-train: launches {paths['cuda'][2]} / "
                             f"{paths['torch'][2]}")
    paths_agree("swin-train", f"rank-{r} SVD factors, kernel path against "
                              f"the plain path", paths["cuda"],
                paths["torch"])
    launched = paths["cuda"][2]
    del factors
    torch.cuda.empty_cache()
    trained = train_model("swin-train", get_model(cfg).loss, params, batch,
                          {}, card)
    del params
    torch.cuda.empty_cache()
    return {"launches": launched, **{
        k: trained[k] for k in ("losses", "step_ms", "busy_ms", "peak_gib")}}


# ---------------------------------------------------------------------------
# phase 26: sharded serving on a one-card mesh
# ---------------------------------------------------------------------------

SHARDED_REQUESTS = 4             # of the serve phase's (and the SSM mix's)
SHARDED_TIMING_TOKENS = 64       # budget of the timed engines' requests


def one_card_mesh():
    """A ``(1, 1)`` ``(data, model)`` DeviceMesh over an NCCL process group
    of one rank (a file rendezvous under ``build/``; no port)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    store = ROOT / "build" / f"mesh-store-{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


def sharded_pair(label: str, model, params, requests, mesh, prefill: str,
                 decode, **kw) -> dict:
    """``requests`` through an unsharded and a sharded engine of the same
    settings, each drive counted: the sharded streams bit-equal to the
    unsharded ones, the same launches (``prefill``, kernel 1 or 5, once per
    layer and wave; ``decode``, kernel 3 or 4 or None, once per layer and
    step), and ``check_backend_mesh`` clean. Returns the sharded drive's
    launches."""
    import torch
    from repro_torch.serve import ServeEngine
    from repro_torch.statcheck import check_backend_mesh
    runs = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        eng = ServeEngine(model, params, n_slots=SLOTS, device="cuda",
                          mesh=m, **kw)
        rids, launches, tok_s, wall = drive_counted(eng, requests)
        runs[name] = (eng, [eng.result(r) for r in rids], launches)
        log(label, f"{name}: {len(rids)} requests OK in {wall:.2f}s "
                   f"({tok_s:.1f} tok/s); {eng.stats()['prefill_waves']} "
                   f"waves, {eng.stats()['decode_steps']} decode steps; "
                   f"launches {launches}")
    (ref, want, want_l), (eng, got, got_l) = runs["unsharded"], \
        runs["sharded"]
    equal = [bool(np.array_equal(a, b)) for a, b in zip(got, want)]
    stats = eng.stats()
    if not all(equal):
        raise AssertionError(f"{label}: sharded streams differ: {equal}")
    layers = model.cfg.n_layers
    per = {prefill: layers * stats["prefill_waves"]}
    if decode is not None:
        per[decode] = layers * stats["decode_steps"]
    if got_l != want_l or any(not n or got_l.get(k) != n
                              for k, n in per.items()):
        raise AssertionError(f"{label}: launches {got_l} (unsharded "
                             f"{want_l}, per layer x wave / step {per})")
    findings = check_backend_mesh(eng.backend, expect_any=())
    placed = {k: [repr(p) for p in d.placements]
              for k, d in eng.backend.state_dtensors().items()}
    log(label, f"sharded streams bit-equal to the unsharded engine's "
               f"({sum(equal)}/{len(equal)}); launches equal; "
               f"check_backend_mesh findings: {[str(f) for f in findings]};"
               f" state placements {placed}")
    if findings:
        raise AssertionError(f"{label}: {findings}")
    del runs, ref, eng
    torch.cuda.empty_cache()
    return got_l


def sharded_step_times(label: str, model, params, requests, mesh,
                       card: str, **kw) -> dict:
    """The decode step (``engine.step()``: the step, the sampling and the
    host bookkeeping) of an unsharded and a sharded engine, the same
    requests admitted to both: host ms in alternating rounds, then device
    busy from a complete profile and the idle share."""
    import torch
    from repro_torch.serve import ServeEngine
    engines = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        eng = ServeEngine(model, params, n_slots=SLOTS, device="cuda",
                          mesh=m, **kw)
        for p, _, sp in requests:
            eng.submit(p, SHARDED_TIMING_TOKENS, sampling=sp)
        eng.step()                   # the admission wave and a first step
        engines[name] = eng
    walls = alternate({name: eng.step for name, eng in engines.items()},
                      rounds=4, per_round=3)
    out = {}
    for name, eng in engines.items():
        kernels = profiled(eng.step, 3, uniform=False)
        busy = sum(device_us(e) for e in kernels) / 3 / 1e3
        out[name] = {"step_ms": walls[name], "busy_ms": busy,
                     "idle_share": 1 - busy / walls[name]}
        log(label, f"{name} decode step ({SLOTS} slots, "
                   f"{model.cfg.n_layers} layers): {walls[name]:.3f} ms on "
                   f"the host clock (median, rounds alternating), device "
                   f"busy {busy:.3f} ms, idle share "
                   f"{out[name]['idle_share']:.3f} [{card}]")
    log(label, f"sharded / unsharded host step: "
               f"{out['sharded']['step_ms'] / out['unsharded']['step_ms']:.4f}"
               f" [{card}]")
    del engines
    torch.cuda.empty_cache()
    return out


def phase_sharded(seed: int, card: str) -> dict:
    """Phase 26 (module docstring)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    mesh = one_card_mesh()
    log("sharded", f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                   f"over {dist.get_backend()} (world "
                   f"{dist.get_world_size()}) [{card}]")
    cfg = get_config("gpt2_alibi_15b").replace(n_layers=N_LAYERS)
    model, params = get_model(cfg), bf16_params(cfg, seed)
    requests = make_requests(seed, cfg.vocab)[:SHARDED_REQUESTS]
    launches, times = {}, {}
    for paged in (False, True):
        label = "sharded-paged" if paged else "sharded"
        kw = {"max_len": MAX_LEN, "prefill_len": PROMPT_MAX}
        if paged:
            kw.update(page_size=PAGE, pages_per_slot=MAX_LEN // PAGE)
        merge_launches(launches, sharded_pair(
            label, model, params, requests, mesh, "flashbias_attention_fwd",
            "flash_decode_paged_fwd" if paged else "flash_decode_fwd", **kw))
        times[label] = sharded_step_times(label, model, params, requests,
                                          mesh, card, **kw)
    del params
    torch.cuda.empty_cache()
    cfg = get_config("mamba2_130m")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    from repro_torch.models import init_params
    model = get_model(cfg)
    params = init_params(cfg, gen, device="cuda")
    ssm = make_ssm_requests(seed, cfg.vocab)[:SHARDED_REQUESTS]
    merge_launches(launches, sharded_pair(
        "sharded-ssm", model, params, ssm, mesh, "ssd_scan_fwd", None,
        max_len=SSM_MAX_LEN))
    dist.destroy_process_group()
    return {"launches": launches, "times": times}


# ---------------------------------------------------------------------------
# phase 27: sharded training on a one-card mesh
# ---------------------------------------------------------------------------

# GPT-2 1.5B at phase 22's width, depth and batch, SHARDED_TRAIN_STEPS steps
# on each path; Mamba2-130M whole SHARDED_SSM_STEPS steps; the launcher on
# Mamba2 (LAUNCH_STEPS steps with a checkpoint, then one more resumed, at
# grad_accum LAUNCH_ACCUM: Mamba2's step is host-bound, 2.7 s at 4 on a
# slow host). The
# host step of each path is then timed over TRAIN_TIMING_ROUNDS more steps
# in alternating rounds (medians of 1-2 steps per path read 0.907-1.085,
# the host clock's noise, PERF.md section 6)
SHARDED_TRAIN_STEPS, SHARDED_SSM_STEPS, LAUNCH_STEPS, LAUNCH_ACCUM = \
    3, 2, 2, 1
TRAIN_TIMING_ROUNDS, SSM_TIMING_ROUNDS = 4, 2


def train_run(cfg, seed: int, steps: int, mesh, kernel: str,
              per_step: int) -> dict:
    """``steps`` steps of ``cfg`` from the seed's weights on the path of
    ``mesh`` (None: the unsharded step; a mesh: the sharded step on its
    local shards), the counters set to 0 just before and read just after:
    ``kernel`` must launch ``per_step`` times a step, no other wrapper.
    Returns the losses, grad norms, host step times, the final parameters
    (the local shards; on one rank the whole tensors) and ``more``, which
    runs one more step on the last batch (updating them in place)."""
    import torch
    from repro_torch.data import LMBatches
    from repro_torch.models import get_model, init_params
    from repro_torch.optim import AdamW, cosine
    from repro_torch.train import make_train_step
    model = get_model(cfg)
    opt = AdamW(lr_fn=cosine(TRAIN_LR, steps // 10, steps))
    step_fn = make_train_step(model.loss, opt, grad_accum=cfg.grad_accum,
                              mesh=mesh, template=model.template())
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    if step_fn.layout is not None:
        params = step_fn.layout.shard(params)
    state = opt.init(params)
    data = LMBatches(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                     global_batch=TRAIN_BATCH, seed=seed)
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in data.batch(i).items()} for i in range(steps)]
    torch.cuda.synchronize()
    counters = reset_counters()
    losses, norms, walls = [], [], []
    for batch in batches:
        t0 = time.monotonic()
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["loss"]))
        walls.append(time.monotonic() - t0)
        norms.append(float(m["grad_norm"]))
    launched = {n: w.launches for n, w in counters.items() if w.launches}
    if launched != {kernel: per_step * steps}:
        raise AssertionError(f"sharded-train: {cfg.name} "
                             f"{'sharded' if mesh else 'unsharded'}: "
                             f"launches {launched} != {kernel} "
                             f"{per_step} x {steps}")
    live = {"params": params, "state": state}

    def more():
        live["params"], live["state"], m = step_fn(
            live["params"], live["state"], batches[-1])
        float(m["loss"])
    return {"losses": losses, "norms": norms, "walls": walls,
            "params": params, "launches": launched[kernel], "more": more}


def sharded_train_pair(label: str, cfg, seed: int, steps: int, mesh,
                       kernel: str, card: str, rounds: int) -> dict:
    """The unsharded and the sharded step from the same weights on the
    same batches: losses, grad norms and every final parameter bit-equal,
    ``kernel`` launched 2 x layers x grad_accum times a step on both."""
    import torch
    per_step = (2 if cfg.remat != "none" else 1) * cfg.n_layers \
        * cfg.grad_accum
    want = train_run(cfg, seed, steps, None, kernel, per_step)
    got = train_run(cfg, seed, steps, mesh, kernel, per_step)
    differ = [k for k in want["params"]
              if not _tree_equal(got["params"][k], want["params"][k])]
    runs = {"unsharded": want, "sharded": got}
    walls = {name: [] for name in runs}
    for r in range(rounds):                       # A B B A ...
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            runs[name]["more"]()
            walls[name].append(time.monotonic() - t0)
    host = {name: float(np.median(w)) for name, w in walls.items()}
    log(label, f"{cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model},"
               f" remat {cfg.remat!r}, grad_accum {cfg.grad_accum}, "
               f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step): losses "
               f"{got['losses']} (unsharded {want['losses']}); grad norms "
               f"{got['norms']} (unsharded {want['norms']}); {kernel} "
               f"{got['launches']} launches (unsharded {want['launches']}, "
               f"{per_step} a step); parameters that differ: {differ}")
    log(label, f"host step (median of {rounds} more steps "
               f"each, rounds alternating): sharded "
               f"{host['sharded'] * 1e3:.1f} ms, unsharded "
               f"{host['unsharded'] * 1e3:.1f} ms, ratio "
               f"{host['sharded'] / host['unsharded']:.4f}; steps 0-"
               f"{steps - 1} {[round(w * 1e3, 1) for w in got['walls']]} "
               f"/ {[round(w * 1e3, 1) for w in want['walls']]} ms [{card}]")
    if got["losses"] != want["losses"] or got["norms"] != want["norms"] \
            or differ or got["launches"] != want["launches"]:
        raise AssertionError(f"{label}: the sharded step is not bit-equal "
                             f"to the unsharded one")
    out = {"launches": got["launches"], "host_ms": {
        k: v * 1e3 for k, v in host.items()}, "losses": got["losses"]}
    del got, want, runs
    torch.cuda.empty_cache()
    return out


def _tree_equal(a, b) -> bool:
    import torch
    if isinstance(a, dict):
        return all(_tree_equal(a[k], b[k]) for k in a)
    return bool(torch.equal(a, b))


def phase_sharded_train(seed: int, card: str) -> dict:
    """Phase 27 (module docstring)."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import LMBatches
    from repro_torch.launch import train as launch_train
    from repro_torch.models import get_model, init_params
    from repro_torch.optim import AdamW, cosine
    from repro_torch.train import make_train_step
    mesh = one_card_mesh()
    log("sharded-train", f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                         f" over {dist.get_backend()} (world "
                         f"{dist.get_world_size()}) [{card}]")
    full = get_config("gpt2_alibi_15b")
    cfg = full.replace(n_layers=TRAIN_LAYERS)
    check_width(cfg, (full.n_layers, cfg.d_model, cfg.heads_padded,
                      cfg.resolved_head_dim, cfg.vocab_padded, cfg.remat,
                      cfg.grad_accum), (48, 1600, 64, 32, 50272, "dots", 4))
    gpt2 = sharded_train_pair("sharded-train", cfg, seed,
                              SHARDED_TRAIN_STEPS, mesh,
                              "flashbias_attention_fwd", card,
                              TRAIN_TIMING_ROUNDS)
    ssm_cfg = get_config("mamba2_130m")
    check_width(ssm_cfg, (ssm_cfg.n_layers, ssm_cfg.d_model,
                          ssm_cfg.ssm_heads_padded, ssm_cfg.remat,
                          ssm_cfg.grad_accum), (24, 768, 32, "dots", 4))
    ssm = sharded_train_pair("sharded-train-ssm", ssm_cfg, seed,
                             SHARDED_SSM_STEPS, mesh, "ssd_scan_fwd", card,
                             SSM_TIMING_ROUNDS)

    # the launcher on the same one-card mesh (the process group is this
    # phase's): LAUNCH_STEPS steps with a checkpoint, then a resumed run
    # to LAUNCH_STEPS + 1; the checkpoint after step LAUNCH_STEPS - 1 then
    # restored unsharded and stepped once, bit-equal to the resumed run
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_sharded_ckpt_")
    argv = ["--arch", "mamba2_130m", "--mesh", "1x1", "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--seed", str(seed),
            "--grad-accum", str(LAUNCH_ACCUM),
            "--ckpt-dir", ckpt, "--ckpt-every", str(LAUNCH_STEPS),
            "--log", f"{ckpt}/log.jsonl"]
    counters = reset_counters()
    t0 = time.monotonic()
    first = launch_train.main(argv + ["--steps", str(LAUNCH_STEPS)])
    again = launch_train.main(argv + ["--steps", str(LAUNCH_STEPS + 1)])
    wall = time.monotonic() - t0
    launched = {n: w.launches for n, w in counters.items() if w.launches}
    with open(f"{ckpt}/log.jsonl") as f:
        recs = [json.loads(line) for line in f]
    steps = LAUNCH_STEPS + 1
    model = get_model(ssm_cfg)
    opt = AdamW(lr_fn=cosine(3e-4, steps // 10, steps))
    params = init_params(ssm_cfg, torch.Generator(device="cuda")
                         .manual_seed(seed + 1), device="cuda")
    (params, state), extras = restore_checkpoint(
        ckpt, LAUNCH_STEPS - 1, (params, opt.init(params)))
    step_fn = make_train_step(model.loss, opt, grad_accum=LAUNCH_ACCUM)
    data = LMBatches(vocab=ssm_cfg.vocab, seq_len=TRAIN_SEQ,
                     global_batch=TRAIN_BATCH, seed=seed)
    _, _, m = step_fn(params, state, {
        k: torch.as_tensor(v, device="cuda")
        for k, v in data.batch(LAUNCH_STEPS).items()})
    resumed = recs[-1]
    log("sharded-train", f"launch.train --mesh 1x1 (mamba2-130m): "
                         f"{first} then {again} in {wall:.1f}s; steps "
                         f"logged {[r['step'] for r in recs]}; launches "
                         f"{launched}; the checkpoint of step "
                         f"{extras['step']} restored unsharded: step "
                         f"{LAUNCH_STEPS} loss {float(m['loss'])} grad norm "
                         f"{float(m['grad_norm'])} (resumed on the mesh "
                         f"{resumed['loss']}, {resumed['grad_norm']})")
    per_step = (2 if ssm_cfg.remat != "none" else 1) * ssm_cfg.n_layers \
        * LAUNCH_ACCUM
    if launched != {"ssd_scan_fwd": per_step * steps}:
        raise AssertionError(f"sharded-train: the launcher's launches "
                             f"{launched} != ssd_scan_fwd {per_step} x "
                             f"{steps}")
    if first["final_step"] != LAUNCH_STEPS or again["final_step"] != steps \
            or [r["step"] for r in recs] != list(range(steps)) or \
            float(m["loss"]) != resumed["loss"] or \
            float(m["grad_norm"]) != resumed["grad_norm"]:
        raise AssertionError("sharded-train: the launcher's run did not "
                             "resume, or its checkpoint restored unsharded "
                             "gives another step")
    shutil.rmtree(ckpt, ignore_errors=True)
    del params, state
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    return {"launches": {
        "flashbias_attention_fwd": gpt2["launches"],
        "ssd_scan_fwd": ssm["launches"] + launched.get("ssd_scan_fwd", 0)},
        "gpt2": gpt2, "ssm": ssm}


# phase 28: the dry run's predictions against the card. The cells are
# GPT-2-ALiBi-1.5B at full width: phase 22's train step (TRAIN_LAYERS,
# TRAIN_BATCH x TRAIN_SEQ, its remat and grad_accum), a prefill wave of
# DRYRUN_PREFILL (slots, tokens) and a contiguous decode step of
# DRYRUN_DECODE (slots, cache positions) at N_LAYERS. The card's memory
# (``torch.cuda.memory_allocated``, ``max_memory_allocated`` over the
# step after a warm-up step and ``reset_peak_memory_stats``) is held to
# the prediction in three parts: the arguments exactly; what the process
# holds beside its steps exactly (``dryrun.resident_bytes``: the cuBLAS
# workspaces, the arrival counters); the step's temporaries (peak minus
# what was held before it) in DRYRUN_TEMP_BAND x the predicted ones plus
# DRYRUN_TEMP_SLACK, the caching allocator's largest excess for one
# cached block it hands out whole (aten kernels' own scratch, which the
# dry run does not see, only adds); and the whole peak in
# DRYRUN_PEAK_BAND x the predicted peak plus the resident bytes. The
# bands were written into PERF.md before the first card run that held
# them.
DRYRUN_PREFILL, DRYRUN_DECODE = (4, 512), (4, 2048)
DRYRUN_TEMP_BAND, DRYRUN_TEMP_SLACK = (1.00, 1.10), 1 << 20
DRYRUN_PEAK_BAND = (1.00, 1.05)


def dryrun_cells():
    """(label, config, ShapeSpec, kernel, launches a step) of phase 28."""
    from repro_torch.configs import ShapeSpec, get_config
    full = get_config("gpt2_alibi_15b")
    train = full.replace(n_layers=TRAIN_LAYERS)
    serve = full.replace(n_layers=N_LAYERS)
    remat = 2 if train.remat != "none" else 1
    (pb, pn), (db, ds) = DRYRUN_PREFILL, DRYRUN_DECODE
    return [("train", train, train_shape(), "flashbias_attention_fwd",
             remat * train.n_layers * train.grad_accum),
            ("prefill", serve, ShapeSpec(f"prefill_{pb}x{pn}", pn, pb,
                                         "prefill"),
             "flashbias_attention_fwd", serve.n_layers),
            ("decode", serve, ShapeSpec(f"decode_{db}x{ds}", ds, db,
                                        "decode"),
             "flash_decode_fwd", serve.n_layers)]


def phase_dryrun(seed: int, card: str) -> dict:
    """The dry run (``launch.dryrun``: the step on fake tensors with the
    ``io_stub`` kernels, on the host) against the same steps on the card,
    per cell of ``dryrun_cells``: the stub's kernel calls equal to the
    launch counters' movement, ``FlopCounterMode``'s count of the real
    step equal to the dry run's count of the same aten ops, the card's
    memory against the prediction (arguments and resident bytes exact,
    temporaries in DRYRUN_TEMP_BAND, the peak in DRYRUN_PEAK_BAND), and
    the roofline of the step's deployment terms beside its device busy
    time (one profiled step, checked against the counters)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis.roofline import roofline_report
    from repro_torch.dist.sharding import Rules
    from repro_torch.launch import dryrun
    log("dryrun", f"torch {torch.__version__}: MemTracker, FlopCounterMode "
                  f"and FakeTensorMode imported; card memory "
                  f"{torch.cuda.get_device_properties(0).total_memory} "
                  f"bytes (spec {H100_SXM.name}: {H100_SXM.hbm_bytes}) "
                  f"[{card}]")
    launches = {}
    rows = {}
    base = torch.cuda.memory_allocated()
    gemm_threads, decode_rows = 1, 0
    for label, cfg, shape, kernel, per_step in dryrun_cells():
        check_width(cfg, (cfg.d_model, cfg.heads_padded,
                          cfg.resolved_head_dim, cfg.vocab_padded),
                    (1600, 64, 32, 50272))
        t0 = time.monotonic()
        pred = dryrun.run_step(cfg.replace(attn_impl="io_stub"), shape,
                               None, Rules(), device="cuda", seed=seed)
        t_pred = time.monotonic() - t0
        calls = {k: v["calls"] for k, v in pred["kernels"].items()}
        before = torch.cuda.memory_allocated()
        fn, externals, _ = dryrun.prepare(cfg.replace(attn_impl="cuda"),
                                          shape, None, Rules(), "cuda",
                                          fake=False, seed=seed)
        args_blocks = torch.cuda.memory_allocated() - before
        args = dryrun.storage_bytes(dryrun.tensors(externals),
                                    dryrun.CUDA_BLOCK)
        fn()                                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        if shape.kind == "train":
            gemm_threads = 2
        if kernel == "flash_decode_fwd":
            decode_rows = shape.global_batch * cfg.kv_heads_padded
        resident = held - base - args_blocks
        resident_pred = dryrun.resident_bytes(gemm_threads=gemm_threads,
                                              decode_rows=decode_rows)
        counters = reset_counters()
        with FlopCounterMode(display=False) as fc:
            out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        moved = {n: w.launches for n, w in counters.items() if w.launches}
        flops = float(fc.get_total_flops())
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in dryrun.tensors(out) if t.is_floating_point())
        busy, _ = profile_steps(fn, 1)
        merge_launches(launches, moved)
        kt = pred["kernels"][kernel]
        dep_flops, dep_bytes = dryrun.deployment_terms(pred)
        rep = roofline_report(flops_per_device=dep_flops,
                              bytes_per_device=dep_bytes,
                              coll_bytes_per_device=0.0, cfg=cfg,
                              shape=shape, n_devices=1)
        mem = pred["memory"]
        temp = peak - held
        temp_pred = mem["peak_bytes"] - mem["argument_bytes"]
        temp_hi = DRYRUN_TEMP_BAND[1] * temp_pred + DRYRUN_TEMP_SLACK
        ratio = (peak - base) / (mem["peak_bytes"] + resident_pred)
        dominant_ms = rep[rep["dominant"]] * 1e3
        log("dryrun", f"{label} ({shape.name}, {cfg.n_layers} layers): "
                      f"predicted on the host in {t_pred:.1f}s; kernel "
                      f"calls predicted {calls}, launched {moved} "
                      f"(expected {kernel} x {per_step}); FLOPs (aten) "
                      f"predicted {pred['flops']:.6e}, counted on the card "
                      f"{flops:.6e} [{card}]")
        log("dryrun", f"{label} memory, predicted -> card (bytes): "
                      f"arguments {mem['argument_bytes']} -> {args} "
                      f"({args_blocks} in the allocator's blocks); "
                      f"resident {resident_pred} -> {resident} (cuBLAS "
                      f"workspaces of {gemm_threads} threads, arrival "
                      f"counters of {decode_rows} rows); temporaries "
                      f"{temp_pred} -> {temp} ({temp / temp_pred:.4f} x, "
                      f"band {DRYRUN_TEMP_BAND} + {DRYRUN_TEMP_SLACK}); "
                      f"peak {mem['peak_bytes']} + {resident_pred} -> "
                      f"{peak - base} ({ratio:.4f} x, band "
                      f"{DRYRUN_PEAK_BAND}; {(peak - base) / 2**30:.3f} GiB) "
                      f"[{card}]")
        log("dryrun", f"{label} roofline ({H100_SXM.name} data sheet, the "
                      f"io_stub's deployment terms; {kernel}: "
                      f"{kt['flops']:.4e} FLOPs, "
                      f"{kt['bytes'] + kt['reread_bytes']:.4e} bytes): "
                      f"compute {rep['compute_s'] * 1e3:.4f} ms, memory "
                      f"{rep['memory_s'] * 1e3:.4f} ms, collective "
                      f"{rep['collective_s'] * 1e3:.4f} ms, dominant "
                      f"{rep['dominant']}; device busy {busy:.3f} ms, "
                      f"{busy / dominant_ms:.3f} x the dominant term "
                      f"[{card}]")
        rows[label] = {"pred_peak": mem["peak_bytes"],
                       "peak": peak - base, "ratio": ratio,
                       "args_pred": mem["argument_bytes"], "args": args,
                       "args_blocks": args_blocks,
                       "resident_pred": resident_pred, "resident": resident,
                       "temp_pred": temp_pred, "temp": temp,
                       "flops_pred": pred["flops"], "flops": flops,
                       "calls": calls, "launched": moved, "busy_ms": busy,
                       "compute_ms": rep["compute_s"] * 1e3,
                       "memory_ms": rep["memory_s"] * 1e3,
                       "dominant": rep["dominant"]}
        bad = []
        if calls != {kernel: per_step} or moved != calls:
            bad.append(f"kernel calls {calls} / launched {moved} != "
                       f"{{{kernel}: {per_step}}}")
        if flops != pred["flops"]:
            ops = {str(k): v for k, v in
                   fc.get_flop_counts().get("Global", {}).items()}
            bad.append(f"FLOPs {flops} != predicted {pred['flops']} "
                       f"(card's per op: {ops})")
        if args != mem["argument_bytes"]:
            bad.append(f"argument bytes {args} != predicted "
                       f"{mem['argument_bytes']}")
        if resident != resident_pred:
            bad.append(f"resident bytes {resident} != predicted "
                       f"{resident_pred}")
        if not DRYRUN_TEMP_BAND[0] * temp_pred <= temp <= temp_hi:
            bad.append(f"temporaries {temp} outside [{temp_pred}, "
                       f"{temp_hi:.0f}]")
        if not DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1]:
            bad.append(f"peak ratio {ratio:.4f} outside {DRYRUN_PEAK_BAND}")
        if not finite:
            bad.append("non-finite output")
        if bad:
            raise AssertionError(f"dryrun {label}: {'; '.join(bad)}")
        del fn, externals, out
        torch.cuda.empty_cache()
    return {"launches": launches, "cells": rows}


# ---------------------------------------------------------------------------
# phase 29: the static contracts of one full-width decode step on the card
# prompt lengths of the wave admitted before the logged decode step
STATCHECK_PROMPTS = (512, 333, 100, 64)


def phase_statcheck(model, params, seed: int, card: str) -> dict:
    """One decode step of a contiguous and of a paged backend on the serve
    phase's weights, logged op by op (``statcheck.contracts
    .check_token_backend``) with every launch counter set to 0 before and
    read after: zero findings, kernel 3 and kernel 4 each launched
    N_LAYERS times by its logged step; then the tripwire on fresh
    backends. Returns the phase's launches (the two prefill waves' kernel
    1 and the logged steps'; the tripwire's are not counted)."""
    import torch
    from repro_torch.serve.backend import TokenDecodeBackend
    from repro_torch.statcheck import contracts
    t0 = time.monotonic()

    def backends():
        return [(f"{model.cfg.name}/decode[{kind}]", TokenDecodeBackend(
            model, params, max_len=MAX_LEN, n_slots=SLOTS, device="cuda",
            **kw)) for kind, kw in (("contiguous", {}),
                                    ("paged", {"page_size": PAGE}))]
    counters = reset_counters()
    findings, steps = [], {}
    for program, be in backends():
        found, steps[program] = contracts.check_token_backend(
            be, program, prompts=STATCHECK_PROMPTS, seed=seed)
        findings += found
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for program, got in steps.items():
        log("statcheck", f"{program}: the logged decode step launched "
                         f"{got}")
    for f in findings:
        log("statcheck", f"FINDING {f}")
    want = {"flash_decode_fwd": N_LAYERS, "flash_decode_paged_fwd": N_LAYERS}
    step_total = merge_launches({}, *steps.values())
    if findings or step_total != want:
        raise AssertionError(f"statcheck: {len(findings)} findings; the "
                             f"logged steps launched {step_total}, want "
                             f"{want}")
    torch.cuda.empty_cache()
    tripwire = contracts.verify_tripwire(backends=backends())
    torch.cuda.empty_cache()
    if tripwire:
        raise AssertionError(f"statcheck tripwire: {tripwire[0]}")
    log("statcheck", f"{model.cfg.name} ({model.cfg.n_layers} layers, "
                     f"{model.cfg.dtype}): 0 findings on the contiguous and "
                     f"the paged decode step; the pool-transpose tripwire "
                     f"fired on both; launches {launches}; "
                     f"{time.monotonic() - t0:.1f}s [{card}]")
    return {"launches": launches}


def phase_statcheck_alone(seed: int, card: str) -> dict:
    """Phase 29 on the serve phase's weights made again from ``seed``
    (``--phase statcheck``)."""
    model, params = serve_weights(seed)
    return phase_statcheck(model, params, seed, card)


# ---------------------------------------------------------------------------
# phase 30: the four ported examples on the card
# example -> the kernels it must launch
EXAMPLE_KERNELS = {
    "quickstart_torch": (),
    "serve_lm_torch": ("flashbias_attention_fwd", "flash_decode_fwd",
                       "ssd_scan_fwd"),
    "serve_pairformer_torch": ("flashbias_attention_ragged_fwd",),
    "pde_solver_torch": ("flashbias_attention_fwd",),
}
EXAMPLE_PDE_STEPS = 80           # the example's default


def load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(seed: int, card: str) -> dict:
    """Each example's ``main`` with ``--device cuda`` (the PDE solver at
    its default 80 steps), every launch counter set to 0 just before it
    and read just after: each launches its kernels (EXAMPLE_KERNELS), the
    PDE solver kernel 1 once per layer in the factored forward it checks
    and in each training step's forward (4 layers). An example whose
    exactness check fails raises."""
    import torch
    total: dict = {}
    for name, kernels in EXAMPLE_KERNELS.items():
        t0 = time.monotonic()
        mod = load_example(name)
        counters = reset_counters()
        args = ["--device", "cuda"]
        if name == "pde_solver_torch":
            args += ["--steps", str(EXAMPLE_PDE_STEPS)]
        mod.main(args)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()
                    if fn.launches}
        missing = [k for k in kernels if not launches.get(k)]
        if missing or set(launches) - set(kernels):
            raise AssertionError(f"{name}: launches {launches}, want "
                                 f"each of {kernels} and no other")
        if name == "pde_solver_torch" and launches[
                "flashbias_attention_fwd"] != 4 * (1 + EXAMPLE_PDE_STEPS):
            raise AssertionError(f"{name}: kernel 1 launched "
                                 f"{launches['flashbias_attention_fwd']} "
                                 f"times, want {4 * (1 + EXAMPLE_PDE_STEPS)}")
        merge_launches(total, launches)
        log("examples", f"{name}: OK, launches {launches}, "
                        f"{time.monotonic() - t0:.1f}s [{card}]")
        torch.cuda.empty_cache()
    return {"launches": total}


def bound(bytes_: int, flops: int) -> dict:
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def run_child(phase: str, seed: int) -> dict:
    """Run ``phase`` in a fresh process of this script (``--phase``), its
    log lines passed through; returns the result it prints. A fresh
    process gets complete profiles: late in a long one torch.profiler
    drops device events (PERF.md section 7)."""
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--phase", phase, "--seed", str(seed)],
                            stdout=subprocess.PIPE, text=True)
    result = None
    for line in proc.stdout:
        if line.startswith(CHILD_RESULT):
            result = json.loads(line[len(CHILD_RESULT):])
        else:
            print(line, end="", flush=True)
    if proc.wait() != 0 or result is None:
        raise AssertionError(f"phase {phase} failed in its process (exit "
                             f"{proc.returncode})")
    log(phase, f"its process ran {time.monotonic() - t0:.0f}s")
    return result


CHILD_PHASES = {"swin": lambda seed, card: {"launches": {
                    "flashbias_attention_fwd": phase_swin(seed, card)}},
                "pde": lambda seed, card: {"launches": {
                    "flashbias_attention_fwd": phase_pde(seed, card)}},
                "hybrid": phase_hybrid, "paged-hybrid": phase_paged_hybrid,
                "moe": phase_moe, "dense-configs": phase_dense_configs,
                "frontends": phase_frontends, "train": phase_train,
                "pair-train": phase_pair_train, "pde-train": phase_pde_train,
                "swin-train": phase_swin_train, "sharded": phase_sharded,
                "sharded-train": phase_sharded_train,
                "dryrun": phase_dryrun, "statcheck": phase_statcheck_alone,
                "examples": phase_examples}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=tuple(CHILD_PHASES), default=None,
                    help="run one phase alone (the full run starts phases "
                         "13-14, 17-28 and 30 this way, each in a process "
                         "of its own; 29 runs in the main process)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    card = card_line()
    log("device", f"{torch.cuda.get_device_name(0)} x "
                  f"{torch.cuda.device_count()}; torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}; TF32 off; [{card}]")

    if args.phase is not None:
        build.build()
        result = CHILD_PHASES[args.phase](args.seed, card_line())
        print(CHILD_RESULT + json.dumps(result), flush=True)
        return 0
    t_start = t0 = time.monotonic()
    report = build.build()
    log("build", f"{sorted(report)} built in {time.monotonic() - t0:.1f}s")
    for name, rep in report.items():
        fn = name
        for line in rep["ptxas"].splitlines():
            entry = re.search(r"Compiling entry function '\S*?\d([a-z_]+?)"
                              r"(?:I(\w+?)E)?E", line)
            if entry:
                fn = f"{name} {entry.group(1)}" + (
                    f"<{entry.group(2)}>" if entry.group(2) else "")
            elif "Used " in line or "spill" in line:
                log("build", f"{fn}: {line.strip()}")
    sass_hgmma()

    def clock(done: str) -> None:
        log("clock", f"{done} done at {time.monotonic() - t_start:.0f}s")

    errors = phase_kernels(args.seed)
    clock("phases 1-2")
    engine, requests, launches, tok_s, whole_first = phase_serve(args.seed)
    paged_launches, paged_tok_s, paged_streams = phase_paged(engine,
                                                             requests)
    launches["flash_decode_paged_fwd"] = \
        paged_launches["flash_decode_paged_fwd"]
    traces, decode_lengths = phase_parity(engine, requests)
    for label, rate in (("contiguous", tok_s), ("paged", paged_tok_s)):
        t = traces[label]
        log("times", f"{label}: decode step {t['step_ms']:.3f} ms (4 slots, "
                     f"{N_LAYERS} layers), device idle share "
                     f"{t['idle_share']:.3f}; "
                     f"end to end {rate:.1f} tok/s [{card}]")
    times = phase_times(engine, decode_lengths, card)
    phase_chunked(engine, requests, whole_first, args.seed, card)
    phase_prefix(engine, args.seed, card)
    phase_lm_dense(engine, requests, card)
    clock("phases 3-6c")
    merge_launches(launches, phase_statcheck(
        engine.model, engine.backend.params, args.seed, card)["launches"])
    del engine, whole_first
    torch.cuda.empty_cache()
    clock("phase 29")

    pair, complexes, rids, pair_launches = phase_pair_serve(args.seed)
    launches["flashbias_attention_ragged_fwd"] = \
        pair_launches["flashbias_attention_ragged_fwd"]
    failed = phase_pair_parity(pair, complexes, rids, args.seed)
    times["flashbias_attention_ragged_fwd"] = phase_pair_times(
        pair, complexes, card)
    del pair
    torch.cuda.empty_cache()
    clock("phases 7-9")

    errors["ssd_scan_fwd"] = phase_ssm_kernel(args.seed)
    ssm, ssm_requests, ssm_launches, ssm_tok_s, ssm_first = \
        phase_ssm_serve(args.seed)
    launches["ssd_scan_fwd"] = ssm_launches["ssd_scan_fwd"]
    failed += phase_ssm_parity(ssm, ssm_requests)
    times["ssd_scan_fwd"] = phase_ssm_times(ssm, ssm_requests, ssm_tok_s,
                                            card)
    phase_ssm_chunked(ssm, ssm_requests, ssm_first, card)
    del ssm_first                    # the SSM engine serves phase 16b
    torch.cuda.empty_cache()

    torch.cuda.empty_cache()
    for phase in ("swin", "pde"):
        merge_launches(launches, run_child(phase, args.seed)["launches"])
    clock("phases 10-14")

    # phases 15-16 take no profile: they run after the profiled phases,
    # which then see the process as old as before them (PERF.md section 7)
    model, params = serve_weights(args.seed)
    phase_faults(model, params, requests, paged_streams, card)
    ckpt = {"prefix": phase_checkpoint_prefix(model, params, args.seed)}
    del model, params
    ckpt["ssm"] = phase_checkpoint_ssm(ssm, ssm_requests)
    del ssm
    torch.cuda.empty_cache()
    ckpt["pair"] = phase_checkpoint_pair(args.seed)
    log("checkpoint", f"snapshot JSON sizes (bytes): {ckpt}; the prefix "
                      f"and SSM engines at full width, the Pairformer at "
                      f"{PAIR_CKPT_LAYERS} of 16 layers [{card}]")
    torch.cuda.empty_cache()
    clock("phases 15-16")
    hybrid = run_child("hybrid", args.seed)
    for name in ("flashbias_attention_fwd", "ssd_scan_fwd"):
        launches[name] += hybrid[name]
    for phase in ("paged-hybrid", "moe", "dense-configs", "frontends",
                  "train", "pair-train", "pde-train", "swin-train",
                  "sharded", "sharded-train", "dryrun", "examples"):
        merge_launches(launches, run_child(phase, args.seed)["launches"])
    clock("phases 17-30")

    replaces = {"flashbias_attention_fwd": "src/repro/kernels/"
                                           "flashbias_attn.py:149",
                "flash_decode_fwd": "src/repro/kernels/flash_decode.py:121",
                "flash_decode_paged_fwd": "src/repro/kernels/"
                                          "flash_decode.py:195",
                "flashbias_attention_ragged_fwd": "src/repro/kernels/"
                                                  "flashbias_attn.py:139",
                "ssd_scan_fwd": "src/repro/kernels/ssd_scan.py:78"}
    sources = {"flashbias_attention_fwd": "src/repro_torch/csrc/"
                                          "flashbias_attn.cu",
               "flash_decode_fwd": "src/repro_torch/csrc/flash_decode.cu",
               "flash_decode_paged_fwd": "src/repro_torch/csrc/"
                                         "flash_decode.cu",
               "flashbias_attention_ragged_fwd": "src/repro_torch/csrc/"
                                                 "flashbias_attn.cu",
               "ssd_scan_fwd": "src/repro_torch/csrc/ssd_scan.cu"}
    kernels = [{"name": name, "route": "cuda", "source": sources[name],
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": errors[name], **times[name]}
               for name in KERNELS]
    log("done", f"every phase ran in {time.monotonic() - t_start:.0f}s, "
                f"the build included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    if failed:
        print(f"chip_smoke: FAILED: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
