#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds every kernel of the
   port with nvcc, one process per source, all started together:
   ``placement.cu``, ``flash_attention.cu``, ``flash_attention_bwd.cu``,
   ``decode_attention.cu``, ``ssd.cu``, ``ssd_bwd.cu``,
   ``selective_scan.cu`` and ``selective_scan_bwd.cu``.  For the two
   attention libraries, the SSD's forward and backward and the fused
   scan's backward it prints each kernel's registers, shared memory and
   spills (``-Xptxas -v``; the verbose build prints them for every
   source) and its tensor-core (HMMA, HGMMA), asynchronous-copy (LDGSTS,
   UTMALDG) and LDSM instruction counts (``cuobjdump -sass``), and fails
   unless the bf16 flash kernels, every SSD forward kernel and the SSD
   backward's two product kernels (``SSD_BWD_TC_KERNELS``) use the tensor
   cores and copy asynchronously, as the bf16 attention kernels must.

The batch placement path (the first slice):

2. Kernel phase: each placement kernel's wrapper against its plain
   PyTorch version on the card, on the same inputs, bitwise (``==`` on
   every double, ``+inf`` included, and the same indices):
   ``score_fleet`` at 32 and 1000 lanes with dead lanes and forced ties,
   ``greedy_window`` on a 4096-task and on a 32,768-task x 32-endpoint
   window, 4 heuristics, and on 384-task windows of 400 endpoints (416
   lanes, C = 64), 1,028 (1,056 lanes, two a thread), 1,600 (the step
   operands in global memory) and 2,400 (the lane state too), each timed
   with its launch plan, which is checked;
   ``mhra(device=None)`` on the 400-endpoint fleet against the CPU's
   plain path.
3. Main path: ``GreenFaaSExecutor`` with ``MHRAPolicy`` on the card,
   ``TestbedSim(seed=0)``, monitoring on, three ``run_batch`` calls of
   32,768 tasks on the 32-endpoint ``scaled_testbed(8)`` federation;
   launch counts are zeroed just before and read just after.  A small
   window placed on the card is held against the CPU's plain path.
3b. The default executor (no strategy: Cluster MHRA) on the same three
   batches' shape: every window clustered, placed by the host's SoA
   engine, no kernel launched (counts zeroed just before, read just
   after); each batch's placement, clustering and SoA-engine seconds,
   cluster count, makespan, measured energy and EDP.  Then Cluster MHRA
   with single-task clusters on 384 tasks (one window launch, equal to the
   CPU), and one 32,768-task window placed by the host SoA engine and by
   the window kernel, equal on every field, both timed.
3c. The four scoring registers armed (carbon, lookahead with per-task hop
   vectors, warm pool, fairness; snapshots from numpy seeds):
   ``greedy_window`` bitwise against its plain version on a 4,096-task x
   32-endpoint x 4-heuristic window with ``not_before`` floors and on
   384-task windows at 416, 1,600 and 2,176 lanes (each launch plan
   checked); then two 32,768-task windows, (a) carbon and warm only, (b)
   all four, each placed by ``mhra(device=None)`` (counts zeroed just
   before, read just after: one window launch) and by the host SoA
   engine, equal on every field and ``carbon_g``, with the kernel's ms and
   us a step, the share of run boundaries (``new_run``) and the seconds of
   ``window_inputs``; then ``carbon_mhra`` with a diurnal carbon signal and
   ``lookahead_mhra`` with the DAG view of a 3-level DAG through
   ``get_policy`` on the card, one launch each, equal to the CPU.
3d. The streaming path: three ``OnlineEngine`` streams, each on the card
   (``device=None``) and on the CPU (``device="cpu"``), equal on every
   window (the whole ``Schedule``, the tasks placed and their floors, the
   simulator's records) and on the summary, completions, WAN events, shed
   and permanently failed tasks; the window kernel's launches (counts
   zeroed just before the card's run, read just after) equal the placement
   calls whose tasks all have at most one input. (poisson) the reference's
   sustained-Poisson latency cell at its largest fleet, planner-only;
   (long) its 16,384-task fork-join stream, pruned; (armed) a monitored
   stream with churn, stragglers, warm pools, a noisy carbon forecast
   with deferral, ``"defer"`` admission, two agent-routed regions and
   speculation.  Each prints its windows, launches, placement seconds (a
   window's p50/p95 and a decision's), the kernel's device ms and the
   wall seconds.
3e. The paper's evaluation: the six scenarios of
   ``examples/torch_paper_eval.py`` (synthetic, the molecular-design DAG,
   carbon, chaos, multi-tenant, geo) at the paper's sizes (1,792 tasks; the
   DAG in 4 waves of 48/48/96), every policy row and every paper gate,
   through ``run_policy``/``evaluate_trace`` on the card (``device=None``;
   the DAG's edges checked on the card's windows) and on the CPU
   (``device="cpu"``), equal on every ``PolicyRun`` field but
   ``scheduling_s`` and ``engine``.  Each prints its wall seconds, its
   placement seconds split into the host SoA engine's calls, the window
   wrapper and the kernel (CUDA events), its window launches (counts zeroed
   just before, read just after) and the device's idle share.
4. Timing with CUDA events after warm-up, at the main path's shapes.

The zamba2-2.7b serving path (the second slice):

5. Kernels against their plain versions on the card: flash attention at
   the shared block's width (b=2, s=2048, 32 heads of 80, bf16, causal)
   and GQA, d=128, sq < sk and non-causal cases, and the bf16 kernel's
   tile edges (one query row, 65 rows, 129 keys, ragged tiles, every
   head_dim, groups of 4 and 8); flash-decode at b=8, S=2176 with ragged
   ``cache_len``, a GQA case, a group of 16 and the f32 route at lengths
   of 1 and around a split boundary, each also with a stale NaN tail; the
   SSD at b=2, L=2048, 80 heads of 64, state 64, chunk 128, and at its
   edges (one token, L=17 < chunk, hd = n = 128, n=8 at hd=16).  Tolerances
   are the reference's (``tests/test_kernels.py``): bf16 2e-2, f32 2e-5,
   SSD 5e-4 / 5e-3.
6. The reduced zamba2 slice on the card against the same slice on the
   CPU (same weights, teacher-forced tokens, prefill at 128 and 4 decode
   steps): logits within 0.15.
7. Main path: ``serve_batch("zamba2-2.7b", reduced=False, batch=8,
   prompt_len=2048, gen_tokens=128, seed=0)`` at full width on the card;
   launch counts are zeroed just before and read just after (9 flash and
   54 SSD launches in the prefill, 9 decode launches in each of the 127
   decode steps); every logit finite.
8. Timing with CUDA events after warm-up at the serving shapes (b=8),
   beside each plain version's time and the one-call PyTorch yardstick
   (``scaled_dot_product_attention``) where there is one, with the
   achieved TFLOP/s and GB/s of the kernel and the yardstick beside the
   bound; the SSD's bound from ``ssd_bound_ms`` (bytes, or the faster of
   its recurrence on the f32 cores and its chunked form as 3xTF32 on the
   tensor cores) and its achieved 3xTF32 rate.
9. A ``torch.profiler`` trace of one prefill and 4 decode steps at the
   serving shapes: the device's busy and idle share and the kernels that
   take the most device time.

The falcon-mamba-7b loss forward and serving paths (the third slice):

10. The selective-scan kernel in both forms against its plain versions
    on the card.  The reference's interface (f32): y and the final state
    within the reference's 1e-4 (atol and rtol) on the reference's
    ``SCAN_CASES``, a ragged length (L=1000, d=520), d of 13 and 518 with
    x not 16-byte aligned (``SCAN_ANY_D``), one full-width layer
    at the loss shape (b=4, L=4096, d=8192, n=16), where it is also timed
    beside the plain version and its bound, and one at the serving
    prefill's shape (b=8, L=2048).  The fused form the model runs
    (``mamba1_scan_fused``: softplus, scan, D*x, SiLU gate, bf16 cast;
    z, B and C read through the projections' strided views): the same
    shapes, y within 1e-4 and one bf16 ulp, the state within 1e-4, with
    and without the state at the loss and prefill shapes, timed at the
    loss shape beside ``fused_scan_bound``.  Then the cost of the Mamba1
    block's bf16 SiLU in the reference's rounding steps beside ``F.silu``:
    launches and time at the loss shape.
11. The reduced falcon-mamba slice on the card against the CPU (same
    weights and tokens): the loss within 4e-4, the forward's, the
    prefill's (128 tokens) and 4 decode steps' logits within 0.125 and
    the forward's within 2e-3 on average, the strict-precision bounds of
    ``tests/test_torch_falcon_mamba.py``.
12. Main path: ``api.loss`` of falcon-mamba-7b at full width on b=4 x
    4,096 tokens (bf16 weights from seed 0) under ``torch.inference_mode()``;
    counts zeroed just before and read just after (64 fused-scan
    launches, no unfused one); a finite loss; wall seconds, tokens/s,
    peak memory; a profiler trace of one more forward (its 12 largest
    kernels, the fused scan's 64 launches).
13. ``serve_batch("falcon-mamba-7b", batch=8, prompt_len=2048,
    gen_tokens=128, seed=0)``: 64 fused-scan launches, all in the
    prefill; a trace of a prefill and 4 decode steps (64 and 0 launches).

The dense family (the sixth slice): granite-3-2b, the reference's
serving default, at full width; starcoder2-7b and qwen3-14b through the
same two kernels:

14. Flash attention and flash-decode against their plain versions at each
    dense config's serving shapes: flash at b=8, s=2048 (granite 32 heads
    of 64 over 8 kv heads, GQA group 4; starcoder2 36 of 128 over 4, group
    9; qwen3 40 of 128 over 8, group 5), bf16, causal; decode against a
    2,176-entry cache with ragged lengths (1, around the planned split,
    the whole cache), then with a NaN tail past them, which must change
    nothing; bf16 tolerance 2e-2.  Each timed by CUDA events beside its
    plain version and SDPA (``enable_gqa=True``), with the bound from the
    shapes (``attention_bound``).
15. The reduced granite, starcoder2 and qwen3 slices on the card against
    the CPU (prefill at 128 and 4 decode steps): logits within the CPU
    tests' bounds (0.11, 0.17, 0.09).
16. Main path: ``serve_batch("granite-3-2b", batch=8, prompt_len=2048,
    gen_tokens=128, seed=0)`` at full width and depth; counts zeroed just
    before and read just after (40 flash launches in the prefill, 40
    decode launches in each of the 127 decode steps, no other kernel);
    every logit finite; prefill seconds, decode tokens/s, peak memory;
    a trace of a prefill and 4 decode steps (40 and 160 launches).
17. starcoder2-7b and qwen3-14b the same way at b=8, prompt 2048, 16 new
    tokens, each after the previous model is freed: every logit finite,
    the launches (32 / 40 a prefill, as many a decode step), prefill
    seconds and peak memory.

The MoE and VLM families (the seventh slice): moonshot-v1-16b-a3b and
internvl2-26b at full width, llama4-scout-17b-a16e reduced, through the
same two kernels:

18. Flash attention and flash-decode against their plain versions at
    moonshot's (16 heads of 128 over 16, group 1) and internvl2's (48 over
    8, group 6) serving shapes, as in phase 14: bf16, ragged lengths and
    a NaN tail; each timed beside its plain version, SDPA and its bound.
19. The reduced moonshot, llama4-scout and internvl2 slices on the card
    against the CPU (internvl2 with its 8 vision embeddings): the largest
    logit error and each output's mean error within the CPU tests'
    bounds (moonshot 0.33 and 0.051, llama4-scout 5.5 and 0.129: a token
    routed to another near-equal expert moves its logits, as between the
    reference's own backends; internvl2 0.09 and 0.018); flash and decode
    launched on every layer; and a reduced MoE prefill on the card drops
    a token at capacity (each MoE layer's routing counted by
    ``moe.dropped`` on its input).
20. Main path: ``serve_batch("moonshot-v1-16b-a3b", batch=8,
    prompt_len=2048, gen_tokens=16, seed=0)`` at full width and depth,
    after the dense models are freed: 48 flash launches in the prefill,
    48 decode launches a step, no other kernel; every logit finite; peak
    memory under the card's; a trace of a prefill and 4 decode steps in
    which the MoE's four parts (router, dispatch loop, expert products,
    combine) are ranges of ``torch.profiler.record_function``, with their
    device ms and the idle share.
21. ``serve_batch("internvl2-26b")`` the same way, its 256 vision
    embeddings drawn by ``make_inputs`` (48 and 48 launches), with a trace.

The enc-dec family (the eighth slice): whisper-tiny at full width, its
encoder, cross-attention and cross-decode through the same two kernels:

22. Flash attention and flash-decode against their plain versions at
    whisper-tiny's serving shapes (b=8, 6 heads of 64, MHA, bf16): flash
    for the encoder (1,500 frames against themselves, non-causal: a
    ragged 92-key last tile), the decoder's self-attention (the 384-token
    prompt, causal) and cross-attention (the prompt against the frames,
    non-causal); decode against the 448-entry self cache (ragged lengths,
    then a NaN tail) and the 1,500-entry cross cache with every entry
    live; each timed beside its plain version, SDPA and its bound.
23. The reduced whisper slice on the card against the CPU at 32 frames
    (the reduced config's) and at 256: logits within the CPU tests' bound
    (0.44); 6 flash launches in the prefill, 16 decode launches in the 4
    steps.
24. Main path: ``serve_batch("whisper-tiny", batch=8, prompt_len=384,
    gen_tokens=64, seed=0)`` at full width (random bf16 frames from
    ``make_inputs``): 12 flash launches in the prefill (4 encoder, 4
    self, 4 cross), 8 decode launches a step (4 self, 4 cross; 504 in
    all), no other kernel; every logit finite; prefill seconds, decode
    tokens/s, peak memory; a trace of a prefill and 4 decode steps.
25. ``examples/torch_molecular_design.py`` (the paper's molecular-design
    campaign through ``OnlineEngine`` with Cluster MHRA, the surrogate
    trained by autograd) on the card and on the CPU: every window and the
    summary equal; its window-kernel launches printed.

The trainer for the dense family (the ninth slice): granite-3-2b trained
at full width, through flash attention's backward kernel:

26. Flash attention's forward with its log-sum-exp and its backward
    kernel against their plain versions (``attention_plain_lse``,
    ``attention_plain_bwd``) on ``BWD_CASES``: head dims 16, 64, 80 and
    128, GQA groups 1, 4, 5 and 6, causal with sq = sk and sq < sk and
    not (sq = sk and sq != sk: whisper-tiny's encoder and cross-attention
    with their ragged last key tile), ragged lengths, one query row, bf16
    and f32; at head_dim 80 (the wgmma route) zamba2's 32 heads of group 1
    at 1,000, group 4, non-causal sq != sk and one query row; o within
    2e-2 (f32
    2e-5), the lse within 1e-4 (bf16 route; f32 2e-5), each gradient
    element within 2e-2 (f32 2e-5) of |want| plus its row's RMS plus a
    tenth of the gradient's RMS, the relative Frobenius error within 1e-2
    (f32 1e-5), and a second call bitwise the same.  At the two timed
    shapes the check must also reject dk and dv with their later half of keys
    planted 1.5 times too large.  Then timed at
    granite's microbatch (b=2, 4,096, 32 heads of 64 over 8, causal) and
    at qwen3's head_dim 128 (40 over 8): the forward with and without the
    lse, the backward beside the plain backward, SDPA's backward
    (``torch.autograd.grad`` through ``scaled_dot_product_attention(...,
    is_causal=True, enable_gqa=True)`` on a retained graph) and the bound
    (2.5 times the forward's products); and so at the new trainers' shapes
    (``BWD_TIMED_FAMILIES``): whisper-tiny's encoder (32 x 1,500 frames, 6
    heads of 64, non-causal) and cross-attention (32 x 448 queries against
    1,500 frames) and internvl2-26b's microbatch (2 x 4,096, 48 heads over
    8 of 128, causal), each with its planted dk/dv rejected.
27. The reduced granite train slice on the card against the CPU: 4 steps
    of ``build_train_step`` from one float32 state on b=4 x 128 tokens
    (numpy seed 0), the step-1 gradients, every step's loss and grad norm
    and the state after the steps within the CPU tests' bounds (twice the
    reference's own spread, ``tests/test_torch_train.py``); 4 flash
    launches and 2 backward calls a step (remat).
28. Main path: ``train("granite-3-2b", reduced=False, steps=4, batch=8,
    seq=4096, microbatches=4, seed=0)`` at full width and depth (f32
    masters, bf16 compute, remat per layer, AdamW, the synthetic
    structured stream): 320 flash launches and 160 backward calls a step
    (counts zeroed just before, read after each step), no other kernel;
    every loss and grad norm finite, the peak under 80 GB; each step's
    loss, grad norm, lr, seconds and tokens/s; a trace of one more step
    (the idle share, the top kernels).  (Until the hybrid trainer came,
    the same run was also stopped at step 2 with a checkpoint and
    resumed; phase 35 stops and resumes zamba2-2.7b instead.)
29. The reduced granite trainer on the card for 30 steps (b=8 x 64, lr
    5e-3): the loss falls by more than 0.3, the twin of the CPU test.

The MoE, VLM and enc-dec trainers (the sixteenth slice): whisper-tiny
trained at full width and depth, moonshot-v1-16b-a3b and internvl2-26b at
full width with 2 of their 48 layers, through the same two kernels:

30. The reduced moonshot, internvl2 and whisper train slices on the card
    against the CPU: 3 steps of ``build_train_step`` from one float32
    state on b=4 x 128 tokens with the frontend inputs drawn after them
    (numpy seed 0); the step-1 gradients, every step's loss and grad
    norm and the state after the steps within the CPU tests' bounds
    (``FAMILY_SLICE_TOL``: twice the reference's own spread,
    ``tests/test_torch_train_families.py``; whisper's state after the
    card's last step from the CPU's state before it); 2 flash launches and
    one backward call an attention a step (whisper: one an encoder layer,
    two a decoder layer).  Then whisper-tiny at full width, one train
    step at b=2 x 448 with 1,500 frames on the card and the CPU: every
    backward on the wgmma route, the loss and grad norm within
    ``WHISPER_FULL_TOL``, 24 flash launches and 12 backward calls.  And
    the same shape's loss gradient in float32 on the card through the
    flash kernels (their f32 route) and through the plain attention: each
    group of leaves (the encoder's attention, the decoder's self
    attention, its cross attention's q/o and k/v projections, the rest)
    within the CPU's own float32-against-float64 spread at that group,
    measured in the same run.
31. Main path: ``train("whisper-tiny", reduced=False, steps=20,
    batch=256, seq=448, microbatches=8, lr=1e-3, seed=0)``, the frames
    drawn for each step by ``frontend_inputs``: 192 flash launches and 96
    backward calls a step (12 attentions x 8 microbatches, each forward
    twice under remat), no other kernel, the backward's calls by shape;
    every loss and grad norm finite, the loss lower at the last step than
    at the first, the peak under 80 GB; each step's loss, ce, grad norm,
    seconds and tokens/s; a trace of one more step with its flash
    launches.  Then the run stopped at step 10 with a checkpoint and
    resumed: the resumed steps and the final state's bits equal the
    uninterrupted run's.
32. ``train(arch, reduced=False, model_dims={"n_layers": 2}, steps=3,
    batch=8, seq=4096, microbatches=4)`` for moonshot-v1-16b-a3b and
    internvl2-26b (internvl2's 256 vision embeddings drawn for each step):
    16 flash launches and 8 backward calls a step, every loss and grad
    norm finite, the peak under 80 GB, step seconds and tokens/s; a trace
    of one more step, in which moonshot's MoE parts (router, dispatch
    loop, expert products, combine) are ``record_function`` ranges in the
    forward and, as ``<part>.backward``, in the backward.  Then, on one
    microbatch of the trained moonshot state, each MoE layer's recomputed
    top-k experts under remat equal its forward's bitwise.

The hybrid and ssm trainers (the seventeenth slice): zamba2-2.7b trained
at full width and depth, falcon-mamba-7b at full width with 8 of its 64
layers, through the SSD's and the fused Mamba1 scan's backward kernels
(``ssd_bwd.cu``, ``selective_scan_bwd.cu``, built in phase 1 with the
rest):

33. Each backward kernel against its plain version (the explicit reverse
    recurrences): the SSD's on ``SSD_BWD_CASES`` (ragged lengths against
    its chunk, state 5 to 128, head_dim 7 to 128, head counts that are
    not a multiple of its 8-head group, one token, with and without the
    final state's gradient), the fused scan's on ``SCAN_BWD_CASES`` (d
    not a multiple of its 64-channel CTA, ragged lengths, lengths over
    several of its 512-token segments, state 4 to 64, one token, strided
    z, B and C); every gradient element within
    ``ssm_grad_errors``'s bound (1e-3 of |want| + its RMS, plus one bf16
    ulp for the scan's bf16 gradients) and a second call bitwise equal.
    Then at zamba2's microbatch (2 x 4,096, 80 heads of 64, state 64) and
    falcon-mamba's (2 x 4,096, 8,192 channels, state 16): checked, a 1%
    error planted in the SSD's dxdt and the scan's dB caught, and timed
    beside the forward kernel, the plain backward and the bound
    (``ssd_bwd_bound_ms``, ``fused_scan_bwd_bound``); no single PyTorch
    call computes either.  Then flash attention at zamba2's training
    shape (``SSM_FLASH_TIMED``: 2 x 4,096, 32 heads of 80, causal, bf16;
    the backward on the wgmma kernel, ``flash_bwd_sm90_bf16_kernel<80>``)
    as phase 26 times its shapes: checked (the planted dk/dv rejected),
    the forward with and without the lse and the
    backward beside the plain versions, SDPA's forward and backward and
    the bounds.
34. The reduced zamba2 and falcon-mamba train slices on the card against
    the CPU, as phase 30 (``FAMILY_SLICE_TOL``: twice the reference's
    spread, ``tests/test_torch_train_ssm.py``), falcon-mamba's card steps
    each from the CPU's state before it (``SSM_STEPS_FROM_CPU``); each
    step's launches as ``step_launches`` counts them.  Then, printed and
    not held, falcon-mamba's free-running grad norms on the card through
    the kernel and through the plain backward, each against the CPU's
    (``slice_drift``).
35. Main path: ``train("zamba2-2.7b", reduced=False, steps=4, batch=8,
    seq=4096, microbatches=4)`` at full width and depth; then the same run
    stopped at step 2 with a checkpoint (preempted: ``on_step`` raises
    after the step-2 checkpoint) and resumed from it to step 4: the first
    run's losses, then the resumed steps' losses, grad norms and final
    state (every parameter's bits) equal the uninterrupted run's.  And
    falcon-mamba-7b with 8 layers for 3 steps.  Every step launches what
    ``step_launches`` counts (zamba2 a step: 72 flash forwards and 36
    backwards, 612 SSD forwards and 216 backwards; falcon-mamba: 64 fused
    scans and 32 backwards) and nothing else; a trace of one more step
    reports the scans', their backwards' and flash's device time by name.

The fleet (the eighteenth slice): GreenFaaS placing LLM jobs on a fleet of
simulated TPU endpoints (``tpu_fleet``) and running the placed jobs on the
card, through ``examples/torch_fleet_train.py`` and
``examples/torch_fleet_serve.py``:

36. The training job (granite-3-2b, train_4k, a 5 GB checkpoint: one
    input, so a cluster of one on the fused window) placed by
    ``FleetManager`` on the card, its endpoint leaving and the job placed
    again, and the serving wave (6 granite decode, 3 qwen3 prefill, 2
    zamba2 decode jobs: one cluster, the host SoA engine), each also on
    the CPU: equal in every field's bits, with 2 window launches for the
    job's two placements on the card and 0 for the wave.  The managers
    read the port's own dry-run costs (``repro_torch/launch/dryrun.py``)
    of the four cells the jobs name: a child process started after phase
    1 counts them on meta tensors on the host through the dry-run's
    command line (``start_dryrun``, ``dryrun_counts``), beside the card's
    phases; each cell's FLOPs, bytes and counting seconds are printed,
    and the placements beside those made on the profile store's priors.
    Then the training example at ``--full-width --dryrun DIR``
    (granite-3-2b's widths, 2 of its
    40 layers, b=8 x 4,096 in 4 microbatches) for 4 steps with a
    checkpoint every 2: its endpoint leaves after step 2, the job is
    re-placed and resumes; counts zeroed just before and read just after
    (2 window launches, ``step_launches`` for each step, nothing else);
    the losses before the leave and the resumed steps' losses and grad
    norms equal one uninterrupted 4-step run's.  Then the serving example
    at ``--full-width --dryrun DIR``: the wave placed as above and its
    first job served at granite-3-2b's full width and depth, b=4, prompt
    32, 16 new tokens (40 flash launches, 40 decode launches a step).
    Placements, launch counts, step seconds, peak memory, tokens/s and the
    phase's wall time are printed as one JSON line.
37. The dry-run's count of the train steps that phases 28 and 35 time
    (``COUNTED_STEPS``: granite-3-2b and zamba2-2.7b at b=8 x 4,096 in 4
    microbatches, falcon-mamba-7b with 8 layers; counted by the same
    child, ``count_cell``) against the card's runs (``count_check``): its
    kernel launches equal the card's (granite 320 flash forwards and 160
    backwards a step; zamba2 612 SSD forwards, 216 backwards, 72 flash
    forwards and 36 backwards; falcon-mamba 64 fused scans and 32
    backwards); its FLOPs over each measured step's seconds as TFLOP/s
    and a share of 989 TFLOP/s, failing above 100%; its arguments less
    the batch equal the bytes of the state the card held; its predicted
    peak beside ``max_memory_allocated``.  Each kernel's work in the
    bounds of the phases above and in the dry-run's count is one
    definition, ``repro_torch/launch/costs.py``.
38. The sharded trainer (``sharded_training``): granite-3-2b trained as
    phase 28 trains it, under ``make_host_mesh()`` (a (1, 1) ("data",
    "model") mesh over a one-rank NCCL group on an in-process store), the
    state placed by ``param_shardings``; counts zeroed just before and
    read just after (320 flash forwards and 160 backwards a step); the
    four losses ``==`` phase 28's and every parameter's bits equal (at
    world size 1 every collective is an identity); step seconds and peak
    memory beside phase 28's, and one more step traced for the card's idle
    share.  Then each kernel under the layouts the sharded path gives it,
    rank by rank of a 4-wide "model" axis (``sharded_kernel_checks``):
    flash at granite's microbatch under head_tp (forward and backward
    ``==`` the whole call's slices) and seq_cp (o within the bf16 flash
    tolerance, dq and the ranks' summed dk / dv by ``grad_ok``), the SSD at
    zamba2's microbatch on a quarter of its heads and the fused scan at
    falcon-mamba's on a quarter of its channels (outputs and per-head or
    per-channel gradients ``==``, the summed dB / dC within their bounds).

Phases 28, 31, 32 and 35 are one function, ``full_width_training``.

Any failed check raises and the script exits non-zero.  The last lines
are the kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import atexit
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))
try:  # each kernel's work and the card's rates, one definition with the dry-run's
    from repro_torch.launch import costs
except ImportError:  # chip_smoke.py alone: main() says what is missing
    costs = None
CU_SOURCE = "src/repro_torch/kernels/placement/csrc/placement.cu"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
BWD_FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"
DECODE_SOURCE = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
SSD_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd.cu"
SSD_BWD_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd_bwd.cu"
SCAN_SOURCE = "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu"
SCAN_BWD_SOURCE = "src/repro_torch/kernels/selective_scan/csrc/selective_scan_bwd.cu"

N_TASKS = 32768          # the main path's batch (largest gated cell)
REPLICAS = 8             # scaled_testbed(8): 32 endpoints
N_BATCHES = 3
CHECK_TASKS = 4096       # window of the kernel-vs-plain check
# fleets past the old kernel's cap, on a window of LARGE_TASKS, each with
# what its launch plan must hold: scaled_testbed(100), 400 endpoints in 416
# lanes (the slot matrix in global memory); (257), 1,028 in 1,056 (two lanes
# a thread); (400), 1,600 (the step operands in global memory); (600), 2,400
# (the lane state too)
LARGE_PLANS = {
    100: {"lanes_per_thread": 1, "state_on_chip": True, "slots_on_chip": False},
    257: {"lanes_per_thread": 2, "state_on_chip": True, "operands_on_chip": True},
    400: {"lanes_per_thread": 2, "state_on_chip": True, "operands_on_chip": False},
    600: {"lanes_per_thread": 3, "state_on_chip": False, "operands_on_chip": False},
}
LARGE_TASKS = 384
# phase 3c: fleets whose plans put the lane state and the step operands on
# and off chip, for the register-armed windows: scaled_testbed(100), 416
# lanes; (400), 1,600 (the operands in global memory); (540), 2,160
# endpoints in 2,176 lanes (the lane state too)
REG_PLANS = {
    100: {"lanes_per_thread": 1, "state_on_chip": True, "slots_on_chip": False},
    400: {"lanes_per_thread": 2, "state_on_chip": True, "operands_on_chip": False},
    540: {"lanes_per_thread": 3, "state_on_chip": False, "operands_on_chip": False},
}
REGISTERS = ("carbon", "lookahead", "warm", "fairness")
USERS = ("alice", "bob", "carol")
# phase 3d: the streaming path.  (poisson) the reference's sustained-Poisson
# latency cell at its largest fleet (benchmarks/placement_latency.py:100-126,
# :66, :151-152: scaled_testbed(8), 4,096 tasks at 64 tasks/s, windows of
# 0.25 s); (long) its long stream (:196-254: 16,384 tasks in fork-join epochs of 127
# on scaled_testbed(2)); (armed) a monitored stream with every fault and
# register armed: 2,048 tasks from 4 users in windows of up to 256
STREAMS = ("poisson", "long", "armed")
POISSON_TASKS, POISSON_RATE_HZ, POISSON_WINDOW_S = 4096, 64.0, 0.25
LONG_STREAM_TASKS, LONG_STREAM_WIDTH = 16384, 127
ARMED_TASKS, ARMED_WINDOW, ARMED_RATE_HZ, ARMED_HORIZON_S = 2048, 256, 16.0, 300.0
ARMED_USERS = ("u0", "u1", "u2", "u3")
# phase 3e: the paper's evaluation (examples/torch_paper_eval.py, the twin of
# examples/paper_eval.py) at the reference's paper sizes: 1,792 tasks a
# scenario, the DAG in 4 waves of 48 docks, 48 simulations and 96 inferences
EVAL_SIZE = "full"

# zamba2-2.7b serving (the second slice's main path)
ARCH = "zamba2-2.7b"
SERVE_BATCH, PROMPT_LEN, GEN_TOKENS = 8, 2048, 128
SLICE_TOL = 0.15            # logits, card against CPU (tests/test_torch_zamba2.py)

# falcon-mamba-7b (the third slice's main path): the loss forward at the
# reference's train_4k sequence length, and serving
FM_ARCH = "falcon-mamba-7b"
LOSS_BATCH, LOSS_LEN = 4, 4096
# (b, L, d, n): tests/test_kernels.py SCAN_CASES, a ragged length, then one
# full-width layer at the loss shape (checked, and timed, in falcon_scan)
SCAN_CASES = [(2, 64, 128, 16), (1, 128, 64, 8), (1, 64, 256, 16), (2, 1000, 520, 16)]
# the f32 form takes any d, as the reference's interface does: d not a
# multiple of the kernel's 4-float vector, x one float into its storage
SCAN_ANY_D = [(2, 100, 13, 16), (1, 257, 518, 8)]
SCAN_TOL = (1e-4, 1e-4)     # the reference's (tests/test_kernels.py)
# the fused scan's bf16 y: the scan's 1e-4 before the cast, and one bf16 ulp
# (at most 2^-7 of the value) after it, where the two sides round apart
FUSED_TOL = (1e-4, 1e-4 + 2.0 ** -7)
# the reduced slice, card against CPU: both sides round bf16 at the same
# places, as the port and the reference without excess precision do, so
# the bounds of that comparison (tests/test_torch_falcon_mamba.py, (c))
FM_LOSS_TOL, FM_LOGIT_TOL, FM_LOGIT_MEAN = 4e-4, 0.125, 2e-3

# the dense family (the sixth slice): granite-3-2b, the reference's serving
# default (src/repro/launch/serve.py:21-24), served at full width with 128
# new tokens; starcoder2-7b (GQA group 9, d=128, GELU) and qwen3-14b (group 5,
# d=128, qk_norm) at full width with DENSE_OTHER_GEN new tokens
DENSE_ARCHS = ("granite-3-2b", "starcoder2-7b", "qwen3-14b")
DENSE_OTHER_GEN = 16
# the reduced slices, card against CPU: the CPU tests' bounds, twice the
# reference's own xla-vs-Pallas spread (tests/test_torch_dense.py)
DENSE_SLICE_TOL = {"granite-3-2b": 0.11, "starcoder2-7b": 0.17, "qwen3-14b": 0.09}

# the MoE and VLM families (the seventh slice): moonshot-v1-16b-a3b (52.3 GiB
# in bf16) and internvl2-26b (37.0 GiB) served at full width with
# DENSE_OTHER_GEN new tokens; llama4-scout-17b-a16e (189.5 GiB) reduced only
MOE_VLM_ARCHS = ("moonshot-v1-16b-a3b", "internvl2-26b")
# the reduced slices, card against CPU: the CPU tests' bounds
# (tests/test_torch_moe.py, tests/test_torch_vlm.py), (largest logit error,
# mean logit error of each output)
MOE_VLM_SLICE_TOL = {"moonshot-v1-16b-a3b": (0.33, 0.051),
                     "llama4-scout-17b-a16e": (5.5, 0.129),
                     "internvl2-26b": (0.09, 0.018)}

# the enc-dec family (the eighth slice): whisper-tiny served at full width,
# b=8, a 384-token prompt and 64 new tokens (448 in all, whisper's decoder
# context) against 1,500 random frames (the reference's stubbed frontend)
WHISPER = "whisper-tiny"
WHISPER_PROMPT, WHISPER_GEN = 384, 64
# the reduced slice, card against CPU, at the reduced config's 32 frames and
# at 256: the CPU tests' bound, twice the reference's own xla-vs-Pallas
# spread at 256 (tests/test_torch_encdec.py)
WHISPER_ENC_LENS, WHISPER_SLICE_TOL = (32, 256), 0.44
# the molecular-design surrogate's first-wave MSE, card against CPU: float32
# autograd over 200 steps from one model on the same data (the CPU test holds
# the CPU to the reference within 1e-7)
MD_MSE_TOL = 1e-5

# the trainer for the dense family (the ninth slice): granite-3-2b, the
# reference's training default (src/repro/launch/train.py:30), trained at full
# width and depth at the reference's train_4k length: a global batch of 8 in 4
# microbatches of 2, 4 steps.  Its stopped and resumed run (~170 s of
# checkpoint I/O for 31.6 GB) gave way to zamba2-2.7b's at full width in
# phase 35, which keeps the smoke inside its time limit
TRAIN_ARCH = "granite-3-2b"
TRAIN = dict(batch=8, seq=4096, microbatches=4, steps=4)
TRAIN_PEAK_LIMIT = 80e9     # bytes: the state and activations fit one card
# the checkpoints of the resumed runs (gitignored; removed after each)
TRAIN_CKPT = ROOT / "_train_ckpt"
# (b, sq, sk, h, kv, d, causal, dtype name): head dims 16, 64, 80 and 128,
# GQA groups 1, 4, 5 and 6, causal sq = sk and sq < sk, non-causal with sq
# = sk and sq != sk, ragged lengths, one query row; the f32 route.  The
# MoE, VLM and enc-dec trainers' shapes on the wgmma route: whisper-tiny's
# encoder (1,500 frames: 11 key tiles of 128, then 92), cross-attention
# (448 queries: 3 tiles of 128, then 64; against the 1,500 frames) and
# causal decoder, 6 heads of 64 (group 1), and internvl2's 48 heads over 8
# (group 6) at 1,000 (15 tiles of 64, then 40).  Head_dim 80 on the wgmma
# route: zamba2's 32 heads of group 1 at 1,000, group 4, non-causal with
# sq != sk (333 keys: 2 tiles of 128, then 77) and one query row
BWD_CASES = [
    (2, 128, 128, 4, 4, 16, True, "bfloat16"),
    (2, 200, 200, 8, 2, 64, True, "bfloat16"),
    (1, 100, 229, 10, 2, 128, True, "bfloat16"),
    (2, 257, 257, 5, 1, 128, False, "bfloat16"),
    (1, 130, 333, 4, 1, 80, True, "bfloat16"),
    (1, 1000, 1000, 32, 32, 80, True, "bfloat16"),
    (2, 200, 200, 8, 2, 80, True, "bfloat16"),
    (2, 90, 333, 8, 2, 80, False, "bfloat16"),
    (2, 1, 300, 8, 2, 80, True, "bfloat16"),
    (2, 1, 300, 8, 2, 64, True, "bfloat16"),
    (1, 1500, 1500, 6, 6, 64, False, "bfloat16"),
    (2, 448, 1500, 6, 6, 64, False, "bfloat16"),
    (2, 448, 448, 6, 6, 64, True, "bfloat16"),
    (1, 1000, 1000, 48, 8, 128, True, "bfloat16"),
    (1, 65, 65, 4, 4, 16, True, "float32"),
    (2, 100, 229, 8, 2, 64, True, "float32"),
    (1, 90, 90, 10, 2, 128, False, "float32"),
]
# a gradient against its plain version, element by element (bf16: P^T and
# dS rounded to bf16 for their products): |err| <= BWD_TOL * (|want| + the
# RMS of its row (the d entries of one position and head) + BWD_FLOOR x the
# RMS of the whole gradient).  The gradients fall off with the position (a
# causal softmax row of length i weights each key about 1/i), so a bound
# from the largest element would pass any error on the late tiles; a row's
# RMS is the size of its products' terms, and the floor covers the rows
# whose terms cancel (the first query's dq).  And the error's Frobenius
# norm relative to the gradient's, within BWD_FRO_TOL.
BWD_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
BWD_FLOOR = 0.1
BWD_FRO_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
LSE_TOL = {"bfloat16": (1e-4, 1e-5), "float32": (2e-5, 2e-5)}
# the timed shapes: granite's microbatch, and qwen3-14b's head_dim 128
BWD_TIMED = {"granite-3-2b": (2, 4096, 32, 8, 64), "qwen3-14b": (2, 4096, 40, 8, 128)}
# the same checks on the backward's earlier design (two mma.sync kernels,
# dK/dV then dQ): at most 0.59 of an element's allowance (dq at granite's
# microbatch) and a relative Frobenius error of 0.0025-0.0028, printed
# beside this kernel's
BWD_MMA_SYNC_ERRORS = (0.59, (0.0025, 0.0028))
# the backward's wgmma kernels (bf16 at head_dim 64, 80 and 128): their
# SASS must hold warpgroup products (HGMMA) fed by TMA (UTMALDG)
BWD_WGMMA_KERNELS = tuple(f"flash_bwd_sm90_bf16_kernel<{d}>" for d in (64, 80, 128))
# the reduced granite train slice, card against CPU: the CPU tests' bounds,
# twice the reference's own spread (tests/test_torch_train.py): the loss and
# the grad norm (relative) pooled over the steps; the step-1 gradients'
# relative Frobenius norm and largest error; the state's largest errors
TRAIN_SLICE_TOL = {"loss": 3.46e-3, "grad_norm": 0.12, "grads_rel": 0.0914,
                   "grads_max": 0.021, "params": 0.0106, "m": 8.6e-3, "v": 8.8e-4}

# the MoE, VLM and enc-dec trainers (the sixteenth slice).  The backward
# timed at their shapes, (b, sq, sk, h, kv, d, causal): whisper-tiny's
# encoder and cross-attention at its training microbatch (32 sequences of
# 448 tokens against 1,500 frames, 6 heads of 64), non-causal, and
# internvl2-26b's microbatch (2 x 4,096, 48 heads over 8 of 128), causal
BWD_TIMED_FAMILIES = {"whisper-tiny encoder": (32, 1500, 1500, 6, 6, 64, False),
                      "whisper-tiny cross": (32, 448, 1500, 6, 6, 64, False),
                      "internvl2-26b": (2, 4096, 4096, 48, 8, 128, True)}
# the reduced train slices, card against CPU (3 steps at b=4 x 128, the
# frontend inputs drawn after the tokens): twice the reference's own
# spread in the CPU tests (tests/test_torch_train_families.py): the loss
# and the grad norm (relative) pooled over the four configs' steps, the
# step-1 gradients and the state per config.  whisper's state is held after
# the card's last step from the CPU's state before it (its free-running
# states separate: the config is chaotic in bf16)
FAMILY_SLICE_TOL = {
    "moonshot-v1-16b-a3b": {"loss": 0.0216, "grad_norm": 0.331, "grads_rel": 0.181,
                            "grads_max": 0.0911, "params": 9.11e-3, "m": 0.0368,
                            "v": 1.34e-3},
    "internvl2-26b": {"loss": 0.0216, "grad_norm": 0.331, "grads_rel": 0.0961,
                      "grads_max": 0.0227, "params": 9.20e-3, "m": 0.0127, "v": 1.85e-3},
    "whisper-tiny": {"loss": 0.0216, "grad_norm": 0.331, "grads_rel": 0.988,
                     "grads_max": 0.444, "params": 9.71e-3, "m": 0.0352, "v": 1.56e-3},
    # the hybrid and ssm trainers: twice the spreads of
    # tests/test_torch_train_ssm.py (the loss and the grad norm pooled over
    # both configs' steps)
    "zamba2-2.7b": {"loss": 3.14e-3, "grad_norm": 0.0197, "grads_rel": 0.0659,
                    "grads_max": 0.043, "params": 8.48e-3, "m": 1.22e-3, "v": 1.15e-4},
    "falcon-mamba-7b": {"loss": 3.14e-3, "grad_norm": 0.0197, "grads_rel": 0.0545,
                        "grads_max": 0.0781, "params": 6.7e-3, "m": 3.02e-3, "v": 2.2e-4},
}
SSM_ARCHS = ("zamba2-2.7b", "falcon-mamba-7b")
# falcon-mamba's free-running grad norms drift apart by its third step:
# 2.0% between the card and the CPU against 1.97% allowed, as far with the
# plain backward in place of the kernel on the card (``slice_drift``
# prints both), while the step-1 gradients agree to 0.27%: the card's bf16
# rounding, amplified by two updates.  So its card steps each start from
# the CPU's state.
SSM_STEPS_FROM_CPU = ("falcon-mamba-7b",)
# the hybrid and ssm trainers at full width (phase 35): zamba2-2.7b at its
# full depth (54 Mamba2 layers, the shared block 9 times) and falcon-mamba-7b
# with 8 of its 64 layers (its full depth needs 116.4 GB of f32 state), each
# at granite's 8 x 4,096 tokens in 4 microbatches; zamba2 stopped after
# step 2 with a checkpoint and resumed, at 6 of its 54 layers (the shared
# block once): at full depth its stopped and resumed runs, with three
# checkpoints' I/O of 29 GB each, took 184 s of the smoke's 1,200
SSM_TRAIN = {"zamba2-2.7b": dict(batch=8, seq=4096, microbatches=4, steps=4),
             "falcon-mamba-7b": dict(batch=8, seq=4096, microbatches=4, steps=3)}
SSM_STOP = {"zamba2-2.7b": 2}
SSM_STOP_DIMS = {"zamba2-2.7b": {"n_layers": 6}}
SSM_LAYERS = {"falcon-mamba-7b": 8}
# kernels whose device time the traced train steps report by name
SSM_WATCH = ("ssd_tc_kernel", "ssd_bwd", "scan_kernel", "scan_bwd", "flash_fwd", "flash_bwd")
# whisper-tiny at full width, card against CPU, one train step at b=2 x 448
# with 1,500 frames: twice the reference's own spread at that shape
# (``tests/_torch_train_families_ref.py ... whisper-full``: the loss 2.58e-3,
# the grad norm 5.39%; its two runs' gradients differ by 127% relative
# Frobenius, so their elements are not compared)
WHISPER_FULL_TOL = {"loss": 5.16e-3, "grad_norm": 0.108}
# whisper-tiny trained at full width and depth: 256 sequences (the batch
# the Whisper paper trained with, arXiv:2212.04356) of 448 tokens (its
# decoder's context, not train_4k's 4,096) with 1,500 frames each, in 8
# microbatches of 32, 20 steps at lr 1e-3, seed 0; stopped at step 10 with
# a checkpoint and resumed
WHISPER_TRAIN = dict(batch=256, seq=448, microbatches=8, steps=20, lr=1e-3)
WHISPER_STOP = 10
# moonshot-v1-16b-a3b and internvl2-26b at full width with 2 of their 48
# layers: b=8 x 4,096 in 4 microbatches, 3 steps
WIDE_ARCHS = ("moonshot-v1-16b-a3b", "internvl2-26b")
WIDE_TRAIN = dict(batch=8, seq=4096, microbatches=4, steps=3)
WIDE_LAYERS = 2


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


# SASS opcodes that show which units a kernel uses: tensor-core products
# (HMMA from mma.sync, HGMMA from wgmma), asynchronous copies (LDGSTS from
# cp.async, UTMALDG from TMA) and shared-memory matrix loads (LDSM)
SASS_OPS = ("HMMA", "HGMMA", "LDGSTS", "UTMALDG", "LDSM")


def kernel_label(mangled: str) -> str:
    """``_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi80EEv...`` ->
    ``flash_fwd_bf16_kernel<80>``: the base name, the element type where
    there is one, and the integer template arguments (the head_dim; the
    SSD's width bound and compile-time widths, ``ssd_tc_kernel<8, 64, 64>``)."""
    base, i = mangled[:60], 3 if mangled.startswith("_ZN") else 2
    while (m := re.match(r"\d+", mangled[i:])):      # <length><identifier>, nested
        i += m.end()
        name, i = mangled[i:i + int(m.group())], i + int(m.group())
        if name.endswith("_kernel"):
            base = name
            break
    targs = re.search(r"_kernelI(\w*?)EEv", mangled)
    ints = re.findall(r"Li(\d+)", targs.group(1)) if targs else []
    tag = "bf16" if "_kernelI13__nv_bfloat16" in mangled else \
        "f32" if "_kernelIf" in mangled else ""
    args = ", ".join(x for x in (tag, *ints) if x)
    return f"{base}<{args}>" if args else base


def ptxas_usage(report: str) -> dict:
    """Per kernel (``kernel_label``) in an ``nvcc -Xptxas -v`` report:
    registers, static shared memory and spill bytes."""
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)), {
                "registers": 0, "static_smem": 0, "spill_stores": 0, "spill_loads": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def sass_counts(sass: str) -> dict:
    """Per kernel (``kernel_label``) in ``cuobjdump -sass`` output: the
    count of each opcode of ``SASS_OPS``."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)), dict.fromkeys(SASS_OPS, 0))
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if cur is not None and m and m.group(1) in cur:
            cur[m.group(1)] += 1
    return out


def kernel_resources(kbuild, card, flash_kernel, dec_kernel, ssd_kernel, scan_kernel) -> dict:
    """After a verbose build: each kernel of the attention libraries (flash
    forward and backward, decode), of the SSD (forward and backward) and
    of the fused scan's backward with its registers, static shared memory
    and spills (``-Xptxas -v``) and its SASS counts (``cuobjdump -sass``),
    and the dynamic shared memory each route asks at head_dim 80 (the
    SSD's at zamba2's widths).  Raises unless every bf16 flash kernel,
    every SSD forward kernel and the SSD backward's product kernels
    (``SSD_BWD_TC_KERNELS``) run on the tensor cores (HMMA or HGMMA) and
    copy asynchronously (LDGSTS or UTMALDG), as every bf16 attention
    kernel must copy, and unless the backward's wgmma kernels
    (``BWD_WGMMA_KERNELS``) hold both HGMMA and UTMALDG."""
    cuobjdump = pathlib.Path(kbuild.nvcc()).parent / "cuobjdump"
    fl, dl, sl = flash_kernel.lib(), dec_kernel.lib(), ssd_kernel.lib()
    bwd = types.SimpleNamespace(SOURCE=flash_kernel.BWD_SOURCE)
    sbl = ssd_kernel.bwd_lib()
    ssd_bwd = types.SimpleNamespace(SOURCE=ssd_kernel.BWD_SOURCE)
    scan_bwd = types.SimpleNamespace(SOURCE=scan_kernel.BWD_SOURCE)
    dyn = [(flash_kernel, f"at d=80 {fl.gf_flash_smem(80, 1)} B (bf16 route), "
                          f"{fl.gf_flash_smem(80, 0)} B (f32 route)"),
           (bwd, "set per launch (the source's *_smem functions)"),
           (dec_kernel, f"at d=80 {dl.gf_decode_smem(1, 80, 1)} B (bf16 route), "
                        f"{dl.gf_decode_smem(1, 80, 0)} B (f32 route)"),
           (ssd_kernel, f"at chunk 128, n=hd=64 {sl.gf_ssd_smem(128, 64, 64)} B, at "
                        f"n=hd=128 {sl.gf_ssd_smem(128, 128, 128)} B"),
           (ssd_bwd, f"at chunk 64, n=hd=64 {sbl.gf_ssd_bwd_smem(64, 64, 64)} B, at "
                     f"chunk 32, n=hd=128 {sbl.gf_ssd_bwd_smem(32, 128, 128)} B"),
           (scan_bwd, "fixed per state width (the source's *_smem_floats)")]
    out = {}
    # one cuobjdump for each library, all started together
    dumps = [subprocess.Popen([str(cuobjdump), "-sass", str(kbuild.library_path(mod.SOURCE))],
                              stdout=subprocess.PIPE, text=True) for mod, _ in dyn]
    sass_texts = []
    for proc in dumps:
        text, _ = proc.communicate(timeout=300)
        if proc.returncode:
            raise subprocess.CalledProcessError(proc.returncode, proc.args)
        sass_texts.append(text)
    for (mod, smem), sass in zip(dyn, sass_texts):
        counts = sass_counts(sass)
        usage = ptxas_usage(kbuild.BUILD_STATS[mod.SOURCE.name]["report"])
        print(f"kernels of {mod.SOURCE.name}: dynamic shared memory {smem} [{card}]",
              flush=True)
        for name in sorted(set(counts) | set(usage)):
            row = {**usage.get(name, {}), **counts.get(name, {})}
            out[name] = row
            print(f"  {name}: {row.get('registers')} registers, static smem "
                  f"{row.get('static_smem')} B, spills {row.get('spill_stores')}/"
                  f"{row.get('spill_loads')} B; SASS "
                  + ", ".join(f"{op} {row.get(op, 0)}" for op in SASS_OPS), flush=True)
    for name, row in out.items():
        bf16 = "_bf16_kernel" in name
        ssd = name.startswith("ssd_tc_kernel") or name in SSD_BWD_TC_KERNELS
        if (ssd or bf16 and name.startswith("flash")) and not (row["HMMA"] or row["HGMMA"]):
            raise AssertionError(f"{name} has no tensor-core instruction")
        if (ssd or bf16) and not (row["LDGSTS"] or row["UTMALDG"]):
            raise AssertionError(f"{name} has no asynchronous copy")
    for name in BWD_WGMMA_KERNELS:
        row = out.get(name)
        if row is None or not (row["HGMMA"] and row["UTMALDG"]):
            raise AssertionError(f"{name}: no wgmma fed by TMA ({row})")
    if not any("_bf16_kernel" in n for n in out):
        raise AssertionError("no bf16 attention kernel found in the libraries")
    if not any(n.startswith("ssd_tc_kernel") for n in out):
        raise AssertionError("no SSD kernel found in its library")
    if not set(SSD_BWD_TC_KERNELS) <= set(out):
        raise AssertionError("the SSD backward's product kernels are missing from its library")
    return out


def base_machine(name: str) -> tuple[str, int]:
    """``theta_3`` -> ``("theta", 3)``; a Table-I name is replica 0."""
    if "_" in name:
        base, k = name.rsplit("_", 1)
        return base, int(k)
    return name, 0


def replica_profiles(eps, BASE_PROFILES, MACHINE_COEFS):
    """Testbed truth for a scaled federation: replica k of a machine runs
    its functions (1 + 0.02k)x faster at the same dynamic power, with the
    machine's power coefficients."""
    profiles = {fn: {} for fn in BASE_PROFILES}
    coefs = {}
    for ep in eps:
        base, k = base_machine(ep.name)
        coefs[ep.name] = MACHINE_COEFS[base]
        for fn, per in BASE_PROFILES.items():
            rt, w = per[base]
            profiles[fn][ep.name] = (rt / (1.0 + 0.02 * k), w)
    return profiles, coefs


def seeded_store(eps, TaskProfileStore, BASE_PROFILES, SEBS_FUNCTIONS):
    """Profiles seeded as the scheduler-overhead benchmark seeds them:
    replica k runs (1 + 0.02k)x faster, three observations each."""
    store = TaskProfileStore(eps)
    for fn in SEBS_FUNCTIONS:
        for ep in eps:
            base, k = base_machine(ep.name)
            rt, w = BASE_PROFILES[fn][base]
            rt = rt / (1.0 + 0.02 * k)
            for _ in range(3):
                store.record(fn, ep.name, rt, rt * w)
    return store


def make_tasks(n, src, TaskSpec, SEBS_FUNCTIONS, prefix="t"):
    inputs = ((src, 1, 200e6, True),)
    return [
        TaskSpec(id=f"{prefix}{i}", fn=SEBS_FUNCTIONS[i % len(SEBS_FUNCTIONS)],
                 inputs=inputs)
        for i in range(n)
    ]


def register_snapshots(tasks, eps, seed, which=REGISTERS, floors=False,
                       n_vectors=64):
    """Seeded scoring snapshots for ``tasks`` on ``eps``: per-endpoint
    carbon rates and warm-pool penalties, two indebted users, lookahead
    weights on a share of the tasks (``tail_w`` on every second, ``out_j``
    on every third, each of those with one of ``n_vectors`` per-task hop
    vectors).  Tasks get users, and with ``floors`` one of four
    ``not_before`` values each.  Returns ``(tasks, mhra keyword dict)``."""
    import dataclasses

    import numpy as np

    from repro_torch.core.carbon import CarbonWeights
    from repro_torch.core.dag import LookaheadWeights
    from repro_torch.core.fairness import FairnessWeights
    from repro_torch.core.faults import WarmWeights
    rng = np.random.default_rng(seed)
    n_ep = len(eps)
    nb = (rng.choice(np.round(rng.uniform(0.0, 20.0, 4), 3), len(tasks))
          if floors else [t.not_before for t in tasks])
    tasks = [dataclasses.replace(t, user=USERS[i % len(USERS)],
                                 not_before=float(nb[i]))
             for i, t in enumerate(tasks)]
    pool = [tuple(float(x) for x in rng.uniform(0.5, 3.0, n_ep))
            for _ in range(n_vectors)]
    out_ids = [t.id for t in tasks[::3]]
    snaps = {
        "carbon": CarbonWeights(
            tuple(float(x) for x in rng.uniform(0.0, 1e-3, n_ep)), 12.0),
        "warm": WarmWeights(tuple(float(x) for x in rng.uniform(0.0, 40.0, n_ep)),
                            tuple(float(x) for x in rng.uniform(0.0, 4.0, n_ep))),
        "fairness": FairnessWeights({"bob": 2.5, "carol": 0.75}, mu=0.6),
        "lookahead": LookaheadWeights(
            tail_w={t.id: float(rng.uniform(0.0, 1.0)) for t in tasks[::2]},
            out_j={tid: float(rng.uniform(0.0, 50.0)) for tid in out_ids},
            hops_mean=tuple(float(x) for x in rng.uniform(0.5, 3.0, n_ep)),
            lam=0.8,
            hops_task={tid: pool[int(rng.integers(n_vectors))] for tid in out_ids}),
    }
    return tasks, {k: snaps[k] for k in which}


def bits_equal(a, b) -> bool:
    """Bitwise equality of two tensors (floats compared as raw bits)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float64:
        return bool(torch.equal(a.view(torch.int64), b.view(torch.int64)))
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    """Largest |a - b| over two tensors, 0 where they are equal (so equal
    infinities count as no error)."""
    import torch
    a64, b64 = a.double(), b.double()
    d = torch.where(a64 == b64, 0.0, (a64 - b64).abs())
    return float(d.max()) if d.numel() else 0.0


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device():
    import torch
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# zamba2-2.7b serving: kernels, slice, main path, timing
# ---------------------------------------------------------------------------

# (b, sq, sk, h, kv, d, causal, dtype name): the shared block's full width,
# then GQA, d=128, sq < sk (bottom-right causal) and non-causal; then the
# bf16 kernel's tile edges (128 query rows a CTA, 32 a warp at d <= 80,
# 64-key tiles): one query row, one row or key past a tile, ragged q and k
# tiles, every head_dim, GQA groups of 4 and 8
FLASH_CASES = [
    (2, 2048, 2048, 32, 32, 80, True, "bfloat16"),
    (2, 512, 512, 32, 8, 64, True, "bfloat16"),
    (1, 512, 512, 16, 16, 128, True, "float32"),
    (2, 256, 640, 8, 8, 80, True, "bfloat16"),
    (2, 384, 512, 8, 4, 80, False, "float32"),
    (2, 1, 300, 8, 2, 80, True, "bfloat16"),
    (1, 65, 65, 4, 4, 80, True, "bfloat16"),
    (1, 129, 129, 32, 4, 64, True, "bfloat16"),
    (2, 100, 229, 16, 2, 128, True, "bfloat16"),
    (2, 130, 130, 4, 4, 16, True, "bfloat16"),
    (2, 90, 333, 8, 1, 16, False, "bfloat16"),
]
# (b, S, h, kv, d, dtype name, lengths): the serving cache with ragged
# lengths, GQA; then a group of 16 and the f32 route with lengths of 1 and
# around the first split boundary the wrapper plans ("edges")
DECODE_CASES = [
    (8, PROMPT_LEN + GEN_TOKENS, 32, 32, 80, "bfloat16", None),
    (4, 1000, 32, 8, 64, "bfloat16", None),
    (5, PROMPT_LEN + GEN_TOKENS, 16, 1, 128, "bfloat16", "edges"),
    (5, 777, 8, 2, 80, "float32", "edges"),
]
# (b, L, nh, hd, n, chunk): zamba2's Mamba2 layer at prompt length; then
# the kernel's edges: one token, one ragged chunk shorter than the chunk,
# the widest head and state, the reduced config's n=8 at hd=16 (chunk 64)
SSD_CASES = [(2, PROMPT_LEN, 80, 64, 64, 128), (2, 1, 4, 64, 64, 128),
             (1, 17, 4, 64, 64, 128), (1, 300, 4, 128, 128, 128),
             (2, 256, 6, 16, 8, 64)]
# the reference's tolerances (tests/test_kernels.py): (atol, rtol)
TOLS = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-5), "ssd": (5e-4, 5e-3)}


def randn(gen, shape, dtype, dev):
    import torch
    return torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))


def check_close(name, got, want, tol, card) -> float:
    """Max |got - want|; raises if any entry is past atol + rtol*|want| or
    not finite."""
    import torch
    atol, rtol = tol
    g, w = got.float(), want.float()
    err = (g - w).abs()
    e = float(err.max())
    if not bool(torch.isfinite(g).all()) or bool((err > atol + rtol * w.abs()).any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max |err| {e})")
    print(f"kernel {name}: max |err| {e:.6g} within atol {atol} rtol {rtol} "
          f"[{card}]", flush=True)
    return e


def event_ms(fn) -> float:
    """One call's time by CUDA events (the plain versions: run once)."""
    import torch
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def zamba2_kernel_checks(dev, card, fk, fr, dk, dr, sk, sr) -> dict:
    """Phase 5: each kernel against its plain version; returns the largest
    error per kernel."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"flash_attention": 0.0, "decode_attention": 0.0, "ssd": 0.0}
    for b, sq, skk, h, kv, d, causal, dt in FLASH_CASES:
        q = randn(gen, (b, sq, h, d), dt, dev)
        k = randn(gen, (b, skk, kv, d), dt, dev)
        v = randn(gen, (b, skk, kv, d), dt, dev)
        got = fk.flash_attention(q, k, v, causal=causal)
        want = fr.attention_plain(q, k, v, causal=causal)
        e = check_close(f"flash_attention b={b} sq={sq} sk={skk} h={h} kv={kv} "
                        f"d={d} causal={causal} {dt}", got, want, TOLS[dt], card)
        errs["flash_attention"] = max(errs["flash_attention"], e)
    for b, S, h, kv, d, dt, edges in DECODE_CASES:
        q = randn(gen, (b, 1, h, d), dt, dev)
        kc = randn(gen, (b, S, kv, d), dt, dev)
        vc = randn(gen, (b, S, kv, d), dt, dev)
        if edges:
            split = dk.plan_splits(b, S, h, kv, d)["split"]
            lens = torch.tensor([1, split - 1, split, split + 1, S], dtype=torch.int32,
                                device=dev)
        else:
            lens = torch.randint(1, S + 1, (b,), generator=gen, device=dev,
                                 dtype=torch.int32)
            lens[0] = S
        got = dk.decode_attention(q, kc, vc, lens)
        want = dr.decode_attention_plain(q, kc, vc, lens)
        e = check_close(f"decode_attention b={b} S={S} h={h} kv={kv} d={d} {dt} "
                        f"cache_len={lens.tolist()}", got, want, TOLS[dt], card)
        errs["decode_attention"] = max(errs["decode_attention"], e)
        # stale tail: garbage (NaN in V) at and past cache_len changes nothing
        for i, n in enumerate(lens.tolist()):
            kc[i, n:] = 1e4
            vc[i, n:] = float("nan")
        stale = dk.decode_attention(q, kc, vc, lens)
        torch.cuda.synchronize()
        if not torch.equal(stale, got):
            raise AssertionError("decode_attention read the cache past cache_len")
        print(f"kernel decode_attention b={b} S={S}: output unchanged by a NaN "
              f"tail past cache_len [{card}]", flush=True)
    for b, L, nh, hd, n, chunk in SSD_CASES:
        x = torch.randn((b, L, nh, hd), generator=gen, device=dev)
        dtf = torch.nn.functional.softplus(
            torch.randn((b, L, nh), generator=gen, device=dev) * 0.5)
        A = -torch.exp(torch.randn((nh,), generator=gen, device=dev) * 0.3)
        B = torch.randn((b, L, n), generator=gen, device=dev)
        C = torch.randn((b, L, n), generator=gen, device=dev)
        args = (x * dtf[..., None], dtf * A, B, C)
        y, st = sk.ssd(*args, chunk=chunk)
        yp, stp = sr.ssd_plain(*args)
        e = max(check_close(f"ssd y b={b} L={L} nh={nh} hd={hd} n={n} chunk={chunk}",
                            y, yp, TOLS["ssd"], card),
                check_close(f"ssd state b={b} L={L} nh={nh} hd={hd} n={n}",
                            st, stp, TOLS["ssd"], card))
        errs["ssd"] = max(errs["ssd"], e)
    return errs


def slice_check(dev, card, get_api, arch, tol) -> float:
    """Phases 6 and 15: a reduced serving path on the card (the kernels)
    against the same path on the CPU (their plain versions): same weights,
    tokens fed from one array, prefill at 128 then 4 decode steps; every
    logit within ``tol``."""
    import numpy as np
    import torch
    api = get_api(arch, reduced=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, api.cfg.vocab, (2, 132)))
    outs = []
    for where in ("cpu", dev):
        params = api.init(0, "cpu").to(where)
        t = toks.to(where)
        lg, cache = api.prefill(params, {"tokens": t[:, :128]}, max_len=136)
        got = [lg.float().cpu()]
        for i in range(4):
            lg, cache = api.decode_step(params, t[:, 128 + i:129 + i], cache, 128 + i)
            got.append(lg[:, 0].float().cpu())
        outs.append(got)
    errs = [float((a - b).abs().max()) for a, b in zip(*outs)]
    err = max(errs)
    if not all(bool(torch.isfinite(b).all()) for b in outs[1]) or err >= tol:
        raise AssertionError(f"reduced {arch} on the card differs from the CPU by {err}")
    print(f"slice reduced {arch} b=2 prefill 128 + 4 decode steps: card vs CPU "
          f"max |logit err| {err:.6g} < {tol} (prefill {errs[0]:.6g}, decode "
          f"steps {', '.join(f'{e:.6g}' for e in errs[1:])}) [{card}]", flush=True)
    return err


def zamba2_timing(dev, card, fk, fr, dk, dr, sk, sr, cfg) -> dict:
    """Phase 8: each kernel at the serving shapes (b=8), its plain version
    once, and the one-call PyTorch yardstick; bound from the shapes."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s, h, kv, d = SERVE_BATCH, PROMPT_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rows = {}

    # flash: one shared-block application of the prefill
    q = randn(gen, (b, s, h, d), "bfloat16", dev)
    k = randn(gen, (b, s, kv, d), "bfloat16", dev)
    v = randn(gen, (b, s, kv, d), "bfloat16", dev)
    ms = cuda_ms(lambda: fk.flash_attention(q, k, v, causal=True), reps=10)
    out = {}
    plain = event_ms(lambda: out.setdefault("p", fr.attention_plain(q, k, v, causal=True)))
    err = check_close("flash_attention at the serving shape",
                      fk.flash_attention(q, k, v, causal=True), out.pop("p"),
                      TOLS["bfloat16"], card)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                  reps=10)
    nbytes = 4 * q.numel() * q.element_size()
    flops = 4 * b * h * d * (s * (s + 1) // 2)        # QK^T and PV, causal pairs
    rows["flash_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib, err=err,
                                   nbytes=nbytes, flops=flops, peak=costs.BF16_FLOPS)
    del q, k, v, qt, kt, vt

    # decode: one shared-block application of a decode step, mid-run
    S = PROMPT_LEN + GEN_TOKENS
    live = PROMPT_LEN + GEN_TOKENS // 2
    q = randn(gen, (b, 1, h, d), "bfloat16", dev)
    kc = randn(gen, (b, S, kv, d), "bfloat16", dev)
    vc = randn(gen, (b, S, kv, d), "bfloat16", dev)
    lens = torch.full((b,), live, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: dk.decode_attention(q, kc, vc, lens), reps=50)
    plain = event_ms(lambda: out.setdefault("p", dr.decode_attention_plain(q, kc, vc, lens)))
    err = check_close("decode_attention at the serving shape",
                      dk.decode_attention(q, kc, vc, lens), out.pop("p"),
                      TOLS["bfloat16"], card)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kc, vc))
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                  reps=50)
    esize = q.element_size()
    nbytes = 2 * q.numel() * esize + 2 * b * live * kv * d * esize + lens.numel() * 4
    flops = 4 * b * h * d * live
    rows["decode_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib, err=err,
                                    nbytes=nbytes, flops=flops, peak=costs.BF16_FLOPS)
    del q, kc, vc, qt, kt, vt, mask

    # ssd: one Mamba2 layer of the prefill
    nh, hd, n, chunk = cfg.inner // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state, 128
    x = torch.randn((b, s, nh, hd), generator=gen, device=dev)
    dtf = F.softplus(torch.randn((b, s, nh), generator=gen, device=dev) * 0.5)
    A = -torch.exp(torch.randn((nh,), generator=gen, device=dev) * 0.3)
    B = torch.randn((b, s, n), generator=gen, device=dev)
    C = torch.randn((b, s, n), generator=gen, device=dev)
    args = (x * dtf[..., None], dtf * A, B, C)
    del x
    ms = cuda_ms(lambda: sk.ssd(*args, chunk=chunk), reps=10)
    plain = event_ms(lambda: out.setdefault("p", sr.ssd_plain(*args)))
    y, st = sk.ssd(*args, chunk=chunk)
    yp, stp = out.pop("p")
    err = max(check_close("ssd y at the serving shape", y, yp, TOLS["ssd"], card),
              check_close("ssd state at the serving shape", st, stp, TOLS["ssd"], card))
    bound = costs.ssd_bound_ms(b, s, nh, hd, n, chunk)
    if bound["nbytes"] != sum(t.numel() * 4 for t in args) + y.numel() * 4 + st.numel() * 4:
        raise AssertionError("ssd_bound_ms counts other bytes than the call moves")
    rows["ssd"] = dict(ms=ms, plain_ms=plain, library_ms=None, err=err,
                       nbytes=bound["nbytes"], flops=costs.ssd_flops(b, s, nh, hd, n, chunk),
                       peak=costs.FP32_FLOPS, bound_ms=bound["bound_ms"],
                       bound_by=bound["bound_by"])
    print(f"bound ssd b={b}: {bound['nbytes']} B take {bound['t_bytes']:.6g} ms at "
          f"{costs.HBM_BYTES_PER_S / 1e12:g} TB/s; operations {bound['t_ops']:.6g} ms, set by "
          f"{bound['ops_form']} (chunked {bound['chunked_flops']} FLOP x 3, recurrence "
          f"{bound['recurrence_flops']} FLOP); the kernel's 3xTF32 rate "
          f"{3 * bound['chunked_flops'] / ms / 1e9:.6g} TFLOP/s of {costs.TF32_FLOPS / 1e12:g} "
          f"[{card}]", flush=True)

    for name, r in rows.items():
        t_bytes = r["nbytes"] / costs.HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / r["peak"] * 1e3
        r.setdefault("bound_ms", max(t_bytes, t_ops))
        r.setdefault("bound_by", "bytes" if t_bytes >= t_ops else "operations")
        lib_txt = (f"{r['library_ms']:.6g} ms" if r["library_ms"] is not None
                   else "none")
        print(f"time {name} b={b}: kernel {r['ms']:.6g} ms, plain version "
              f"{r['plain_ms']:.6g} ms, library call {lib_txt}, bound "
              f"{r['bound_ms']:.6g} ms by {r['bound_by']} ({r['nbytes']} B, "
              f"{r['flops']} FLOP) [{card}]", flush=True)
        # achieved rates: the function's operations and bytes over each time
        r["tflops"] = r["flops"] / r["ms"] / 1e9
        r["gbps"] = r["nbytes"] / r["ms"] / 1e6
        lib_rate = (f"; the library call {r['flops'] / r['library_ms'] / 1e9:.6g} TFLOP/s, "
                    f"{r['nbytes'] / r['library_ms'] / 1e6:.6g} GB/s, the kernel "
                    f"{r['library_ms'] / r['ms']:.4g}x its speed"
                    if r["library_ms"] is not None else "")
        print(f"rate {name} b={b}: kernel {r['tflops']:.6g} TFLOP/s (peak "
              f"{r['peak'] / 1e12:g}), {r['gbps']:.6g} GB/s (peak "
              f"{costs.HBM_BYTES_PER_S / 1e9:g}); {r['bound_ms'] / r['ms']:.4f} of its bound"
              f"{lib_rate} [{card}]", flush=True)
    return rows


def trace_tables(prof, ranges=()) -> tuple[dict, dict]:
    """The device events of a finished ``torch.profiler`` trace, read from
    its raw Kineto events (``key_averages`` builds an object and a tree
    node for every host event: 5.27 s of host time against 0.31 s here
    for a trace of granite's decode with 10,936 launches on an H100's
    host, both reading the same names, counts and times, by
    ``smoke_tools.py trace-check``): {name: [count, device ns]} over every
    device event but the ``ranges``' own spans on the device timeline, and
    {range: [calls, device ns]}, a range's device time being that of the
    kernels launched from inside its host span on its thread, as
    ``key_averages`` counts a host event's ``device_time_total`` (a
    kernel belongs to the frontend op it is linked to, and the op to the
    range whose span holds its start)."""
    import bisect

    from torch.autograd import DeviceType
    # launches: {thread: [(start ns, frontend op id)]}, the ops a range may hold
    kernels, launches, spans, dev_ns = {}, {}, {name: [] for name in ranges}, {}
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name in spans:
                continue
            row = kernels.setdefault(name, [0, 0])
            row[0] += 1
            row[1] += e.duration_ns()
            if ranges:
                # the host op that launched it (a frontend op's id)
                op = e.linked_correlation_id()
                dev_ns[op] = dev_ns.get(op, 0) + e.duration_ns()
        elif ranges and not e.linked_correlation_id():
            if name in spans:
                spans[name].append((e.start_thread_id(), e.start_ns(), e.end_ns()))
            launches.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.correlation_id()))
    for rows in launches.values():
        rows.sort()
    out = {}
    for name, calls in spans.items():
        ns = 0
        for tid, t0, t1 in calls:
            rows = launches.get(tid, [])
            lo = bisect.bisect_left(rows, (t0, -1))
            hi = bisect.bisect_right(rows, (t1, float("inf")))
            ns += sum(dev_ns.get(corr, 0) for _, corr in rows[lo:hi])
        out[name] = [len(calls), ns]
    return kernels, out


def trace(label, fn, card, top_n=6, ranges=(), watch=()) -> dict:
    """A ``torch.profiler`` trace of ``fn()`` (ended by a synchronise): the
    CUDA kernels' summed time over the host clock, the launches, and the
    kernels that take the most device time.  Where the trace holds no
    device time it says so (None).  ``ranges``: names of
    ``record_function`` ranges inside ``fn``, each reported with its calls
    and the device time of the kernels launched inside it.  ``watch``:
    name fragments, each reported with the device time and launches of the
    kernels whose names hold it, whether or not they are among the top."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, range_rows = trace_tables(prof, ranges)
    busy_us = sum(ns for _, ns in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)[:top_n]
    out = {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if busy_us else None,
        "device_idle_share": 1.0 - busy_us / wall_us if busy_us else None,
        "kernel_launches": sum(n for n, _ in kernels.values()),
        "top_kernels": [{"name": name[:80], "ms": ns / 1e6, "count": n}
                        for name, (n, ns) in top],
    }
    share = out["device_idle_share"]
    print(f"profile {label}: wall {wall_us / 1e3:.6g} ms, device busy "
          f"{busy_us / 1e3:.6g} ms, idle share "
          f"{'not measured' if share is None else f'{share:.4f}'}, "
          f"{out['kernel_launches']} kernel launches [{card}]", flush=True)
    for name, (n, ns) in top:
        print(f"  {ns / 1e6:10.4f} ms x{n:5d}  {name[:90]}", flush=True)
    if watch:
        out["watched"] = {}
        for part in watch:
            hits = [v for name, v in kernels.items() if part in name]
            out["watched"][part] = {"ms": sum(ns for _, ns in hits) / 1e6,
                                    "count": sum(n for n, _ in hits)}
            print(f"  kernels named *{part}*: {out['watched'][part]['ms']:.6g} ms, "
                  f"{out['watched'][part]['count']} launches", flush=True)
    if ranges:
        out["ranges"] = {}
        for name in ranges:
            calls, ns = range_rows[name]
            ms = ns / 1e6
            share = ms * 1e3 / busy_us if busy_us else None
            out["ranges"][name] = {"calls": calls, "device_ms": ms, "busy_share": share}
            print(f"  range {name}: {calls} calls, kernels {ms:.6g} ms on the device"
                  f"{'' if share is None else f', {share:.4f} of the busy time'}",
                  flush=True)
    return out


def serving_profile(dev, card, serve, api, counts=None, top_n=6, ranges=None,
                    prompt_len=PROMPT_LEN) -> dict:
    """The device's busy share of the serving path: a trace of one prefill
    at the serving shapes (b=8, ``prompt_len``; a VLM's vision embeddings
    or an enc-dec's frames from ``make_inputs``) and of 4 decode steps
    after it.  ``counts`` (a kernel's LAUNCHES, or a tuple of them) is read
    per window.  ``ranges``: {name: (module, function name)}, each function
    wrapped in a ``record_function`` range of that name for the traces."""
    import torch
    tables = () if counts is None else (counts,) if isinstance(counts, dict) \
        else tuple(counts)
    params, prompts, frontend = serve.make_inputs(api, SERVE_BATCH, prompt_len, 0, dev)
    serve.generate(api, params, prompts[:, :256], 3, frontend)    # warm-up
    batch = serve.prefill_batch(api, prompts, frontend)
    state = {}

    def prefill():
        logits, state["cache"] = api.prefill(params, batch, max_len=prompt_len + 8)
        state["tok"] = torch.argmax(logits, dim=-1)[:, None]

    def decode():
        for i in range(4):
            logits, state["cache"] = api.decode_step(params, state["tok"],
                                                     state["cache"], prompt_len + i)
            state["tok"] = torch.argmax(logits[:, 0], dim=-1)[:, None]

    ranges = ranges or {}
    saved = {name: getattr(mod, fn) for name, (mod, fn) in ranges.items()}

    def in_range(name, f):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(name):
                return f(*a, **kw)
        return wrapped

    out = {}
    try:
        for name, (mod, fn) in ranges.items():
            setattr(mod, fn, in_range(name, saved[name]))
        for phase, fn in (("prefill", prefill), ("decode", decode)):
            before = [dict(c) for c in tables]
            out[phase] = trace(f"{api.cfg.name} {phase} (b={SERVE_BATCH})", fn, card,
                               top_n, tuple(ranges))
            if tables:
                out[phase]["launches"] = {k: c[k] - b[k] for c, b in zip(tables, before)
                                          for k in c}
        if ranges:
            # the ranges again by CUDA events around each call, on one more
            # prefill (the card is busy through a prefill, so a call's span
            # on the stream is its kernels' time): a check of the trace's
            # attribution
            spans = {name: [] for name in ranges}

            def in_events(name, f):
                def wrapped(*a, **kw):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    res = f(*a, **kw)
                    e1.record()
                    spans[name].append((e0, e1))
                    return res
                return wrapped

            for name, (mod, fn) in ranges.items():
                setattr(mod, fn, in_events(name, saved[name]))
            prefill()
            torch.cuda.synchronize()
            pre = out["prefill"]
            pre["range_event_ms"] = {name: sum(a.elapsed_time(b) for a, b in pairs)
                                     for name, pairs in spans.items()}
            inside = sum(r["device_ms"] for r in pre["ranges"].values())
            print(f"  prefill ranges by CUDA events: "
                  f"{', '.join(f'{k} {v:.6g} ms' for k, v in pre['range_event_ms'].items())}"
                  f"; the trace's ranges {inside:.6g} ms of {pre['device_busy_ms']} ms "
                  f"busy [{card}]", flush=True)
    finally:
        for name, (mod, fn) in ranges.items():
            setattr(mod, fn, saved[name])
    return out


# ---------------------------------------------------------------------------
# falcon-mamba-7b: the scan kernel, the slice, the loss forward, serving
# ---------------------------------------------------------------------------


def scan_inputs(gen, b, L, d, n, dev):
    """As the reference's kernel tests draw them: dt = softplus(0.5 g - 1),
    A = -exp(0.3 g)."""
    import torch
    import torch.nn.functional as F
    x = torch.randn((b, L, d), generator=gen, device=dev)
    dt = F.softplus(torch.randn((b, L, d), generator=gen, device=dev) * 0.5 - 1)
    A = -torch.exp(torch.randn((d, n), generator=gen, device=dev) * 0.3)
    B = torch.randn((b, L, n), generator=gen, device=dev)
    C = torch.randn((b, L, n), generator=gen, device=dev)
    D = torch.randn((d,), generator=gen, device=dev)
    return x, dt, A, B, C, D


def fused_scan_inputs(gen, b, L, d, n, r, dev):
    """The fused op's inputs laid out as the Mamba1 block leaves them: xc
    and dt_raw contiguous bf16, z the second half of an in_proj product
    (rows of 2d), B and C views of an x_proj product (rows of r + 2n);
    dt_raw drawn so that softplus(dt_raw + dt_b) is spread as the
    reference's kernel tests draw dt."""
    import torch
    bf = torch.bfloat16
    xc = torch.randn((b, L, d), generator=gen, device=dev).to(bf)
    dt_raw = (torch.randn((b, L, d), generator=gen, device=dev) * 0.5 - 1).to(bf)
    dt_b = torch.randn((d,), generator=gen, device=dev) * 0.1
    A = -torch.exp(torch.randn((d, n), generator=gen, device=dev) * 0.3)
    D = torch.randn((d,), generator=gen, device=dev)
    xz = torch.randn((b, L, 2 * d), generator=gen, device=dev).to(bf)
    dbc = torch.randn((b, L, r + 2 * n), generator=gen, device=dev).to(bf)
    z = xz[..., d:]
    B, C = dbc[..., r:r + n], dbc[..., r + n:]
    return xc, dt_raw, dt_b, A, B, C, D, z


def falcon_fused_scan(dev, card, sk, sr, cfg) -> dict:
    """Phase 10b: the fused scan against its plain version, y (bf16) and
    the final state, on the SCAN_CASES shapes with strided z, B and C, and
    at the loss and the serving prefill's shapes with and without the
    state; timed at the loss shape beside its plain version and its
    bound."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(4)
    r = cfg.dtrank
    err = 0.0

    def check(label, args, state):
        nonlocal err
        if state:
            y, h = sk.mamba1_scan_fused(*args, return_state=True)
            yp, hp = sr.mamba1_scan_fused_plain(*args, return_state=True)
            err = max(err, check_close(f"mamba1_scan_fused state {label}", h, hp,
                                       SCAN_TOL, card))
        else:
            y = sk.mamba1_scan_fused(*args)
            yp = sr.mamba1_scan_fused_plain(*args)
        if y.dtype != torch.bfloat16 or y.shape != args[0].shape:
            raise AssertionError(f"mamba1_scan_fused {label}: y {y.dtype} {y.shape}")
        err = max(err, check_close(f"mamba1_scan_fused y {label} state={state}", y, yp,
                                   FUSED_TOL, card))
        return y

    for b, L, d, n in SCAN_CASES:
        args = fused_scan_inputs(gen, b, L, d, n, r, dev)
        check(f"b={b} L={L} d={d} n={n}", args, True)
    b, L, d, n = LOSS_BATCH, LOSS_LEN, cfg.inner, cfg.ssm_state
    args = fused_scan_inputs(gen, b, L, d, n, r, dev)
    ms = cuda_ms(lambda: sk.mamba1_scan_fused(*args), reps=10)
    ms_state = cuda_ms(lambda: sk.mamba1_scan_fused(*args, return_state=True), reps=10)
    out = {}
    plain = event_ms(lambda: out.setdefault("p", sr.mamba1_scan_fused_plain(*args)))
    out.clear()
    y = check(f"at the loss shape b={b} L={L} d={d} n={n}", args, False)
    check("at the loss shape", args, True)
    row = dict(costs.fused_scan_bound(b, L, d, n), ms=ms, ms_with_state=ms_state,
               plain_ms=plain, library_ms=None)
    moved = sum(t.numel() * t.element_size() for t in args) + y.numel() * y.element_size()
    if row["nbytes"] != moved:
        raise AssertionError(f"fused_scan_bound counts {row['nbytes']} B, the call "
                             f"moves {moved} B")
    print(f"time mamba1_scan_fused b={b} L={L} d={d} n={n}: kernel {ms:.6g} ms "
          f"({ms_state:.6g} ms with the state), plain version {plain:.6g} ms, library "
          f"call none, bound {row['bound_ms']:.6g} ms by {row['bound_by']} "
          f"({row['nbytes']} B take {row['t_bytes']:.6g} ms; {row['sfu']} special-"
          f"function operations take {row['sfu'] / costs.SFU_PER_S * 1e3:.6g} ms; "
          f"{row['flops']} f32 FLOP take {row['flops'] / costs.FP32_FLOPS * 1e3:.6g} ms); "
          f"{row['bound_ms'] / ms:.4f} of its bound [{card}]", flush=True)
    del args, y
    b, L = SERVE_BATCH, PROMPT_LEN
    args = fused_scan_inputs(gen, b, L, d, n, r, dev)
    check(f"at the serving prefill's shape b={b} L={L} d={d} n={n}", args, True)
    check("at the serving prefill's shape", args, False)
    row["err"] = err
    return row


def falcon_scan(dev, card, sk, sr, cfg) -> dict:
    """Phase 10: the scan kernel against its plain version, y and the final
    state, on SCAN_CASES, on one full-width layer at the loss shape, where
    it is also timed beside the plain version and its bound, and on one at
    the serving prefill's shape."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(2)
    err = 0.0
    for b, L, d, n in SCAN_CASES:
        args = scan_inputs(gen, b, L, d, n, dev)
        y, h = sk.selective_scan(*args, return_state=True)
        yp, hp = sr.selective_scan_plain(*args, return_state=True)
        err = max(err, check_close(f"selective_scan y b={b} L={L} d={d} n={n}", y, yp,
                                   SCAN_TOL, card),
                  check_close(f"selective_scan state b={b} L={L} d={d} n={n}", h, hp,
                              SCAN_TOL, card))
    for b, L, d, n in SCAN_ANY_D:
        x, *rest = scan_inputs(gen, b, L, d, n, dev)
        x = torch.empty(x.numel() + 1, device=dev)[1:].view_as(x).copy_(x)
        y, h = sk.selective_scan(x, *rest, return_state=True)
        yp, hp = sr.selective_scan_plain(x, *rest, return_state=True)
        err = max(err, check_close(f"selective_scan y b={b} L={L} d={d} n={n} (x 4 B "
                                   f"past 16-byte alignment)", y, yp, SCAN_TOL, card),
                  check_close(f"selective_scan state b={b} L={L} d={d} n={n}", h, hp,
                              SCAN_TOL, card))
    b, L, d, n = LOSS_BATCH, LOSS_LEN, cfg.inner, cfg.ssm_state
    args = scan_inputs(gen, b, L, d, n, dev)
    ms = cuda_ms(lambda: sk.selective_scan(*args), reps=10)
    out = {}
    plain = event_ms(lambda: out.setdefault("p", sr.selective_scan_plain(
        *args, return_state=True)))
    y, h = sk.selective_scan(*args, return_state=True)
    yp, hp = out.pop("p")
    err = max(err, check_close(f"selective_scan y at the loss shape b={b} L={L} d={d} "
                               f"n={n}", y, yp, SCAN_TOL, card),
              check_close("selective_scan state at the loss shape", h, hp, SCAN_TOL,
                          card))
    # the loss forward asks for no state
    row = dict(costs.scan_bound(b, L, d, n), ms=ms, plain_ms=plain, library_ms=None, err=err)
    print(f"time selective_scan b={b} L={L} d={d} n={n}: kernel {ms:.6g} ms, plain "
          f"version {plain:.6g} ms, library call none, bound {row['bound_ms']:.6g} ms "
          f"by {row['bound_by']} ({row['nbytes']} B take {row['t_bytes']:.6g} ms; "
          f"{row['exps']} exp take {row['exps'] / costs.SFU_PER_S * 1e3:.6g} ms; "
          f"{row['flops']} f32 FLOP take {row['flops'] / costs.FP32_FLOPS * 1e3:.6g} ms) "
          f"[{card}]", flush=True)
    if row["nbytes"] != sum(t.numel() * 4 for t in args) + y.numel() * 4:
        raise AssertionError("scan_bound counts other bytes than the call moves")
    del args, y, h, yp, hp
    b, L = SERVE_BATCH, PROMPT_LEN
    args = scan_inputs(gen, b, L, d, n, dev)
    y, h = sk.selective_scan(*args, return_state=True)
    yp, hp = sr.selective_scan_plain(*args, return_state=True)
    row["err"] = max(row["err"], check_close(
        f"selective_scan y at the serving prefill's shape b={b} L={L} d={d} n={n}", y, yp,
        SCAN_TOL, card), check_close("selective_scan state at the serving prefill's shape",
                                     h, hp, SCAN_TOL, card))
    return row


def silu_cost(dev, card, common, cfg) -> dict:
    """What the Mamba1 block's bf16 SiLU in the reference's rounding steps
    (``common.silu``, taken once a layer for the reference's loss parity)
    costs beside ``F.silu`` on the same input at the loss shape: launches
    (from a profiler trace of one call) and time (CUDA events)."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(3)
    x = randn(gen, (LOSS_BATCH, LOSS_LEN, cfg.inner), "bfloat16", dev)

    def kernels_in_trace(fn, calls):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(x)
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)

    out = {}
    for name, fn in (("stepwise", common.silu), ("F.silu", F.silu)):
        fn(x)
        # a fresh trace can miss its first kernel: count the 10 calls that a
        # trace of 11 holds beyond a trace of 1
        launches = (kernels_in_trace(fn, 11) - kernels_in_trace(fn, 1)) / 10
        out[name] = {"launches": launches, "ms": cuda_ms(lambda: fn(x), reps=20)}
    extra = out["stepwise"]["ms"] - out["F.silu"]["ms"]
    print(f"silu bf16 ({LOSS_BATCH}, {LOSS_LEN}, {cfg.inner}): stepwise "
          f"{out['stepwise']['launches']:g} launches {out['stepwise']['ms']:.6g} ms, F.silu "
          f"{out['F.silu']['launches']:g} launches {out['F.silu']['ms']:.6g} ms; the "
          f"stepwise form adds {extra:.6g} ms a layer, {extra * cfg.n_layers:.6g} ms a "
          f"loss forward [{card}]", flush=True)
    return out


def falcon_slice_check(dev, card, get_api, lm) -> dict:
    """Phase 11: reduced falcon-mamba on the card (the scan kernel) against
    the same paths on the CPU (its plain version), same weights and
    tokens: ``api.loss`` and the forward's logits over 128 tokens, then a
    prefill of 128 tokens and 4 teacher-forced decode steps."""
    import numpy as np
    import torch
    api = get_api(FM_ARCH, reduced=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, api.cfg.vocab, (2, 133)))
    outs = []
    for where in ("cpu", dev):
        params = api.init(0, "cpu").to(where)
        t = toks.to(where)
        batch = {"tokens": t[:, :128], "labels": t[:, 1:129]}
        loss, _ = api.loss(params, batch)
        got = [loss.reshape(1).cpu(),
               lm.lm_forward(params, api.cfg, batch["tokens"]).float().cpu()]
        lg, cache = api.prefill(params, {"tokens": t[:, :128]})
        got.append(lg.float().cpu())
        for i in range(4):
            lg, cache = api.decode_step(params, t[:, 128 + i:129 + i], cache, 128 + i)
            got.append(lg[:, 0].float().cpu())
        outs.append(got)
    loss_err = abs(float(outs[0][0] - outs[1][0]))
    logit_err = max(float((a - b).abs().max()) for a, b in zip(outs[0][1:], outs[1][1:]))
    mean_err = float((outs[0][1] - outs[1][1]).abs().mean())
    if not all(bool(torch.isfinite(b).all()) for b in outs[1]) or \
            loss_err >= FM_LOSS_TOL or logit_err >= FM_LOGIT_TOL or \
            mean_err >= FM_LOGIT_MEAN:
        raise AssertionError(f"reduced falcon-mamba on the card differs from the CPU: "
                             f"loss by {loss_err}, logits by {logit_err} (forward's "
                             f"mean {mean_err})")
    print(f"slice reduced {FM_ARCH} b=2: loss over 128 tokens, card vs CPU |err| "
          f"{loss_err:.6g} < {FM_LOSS_TOL}; forward, prefill 128 + 4 decode steps max "
          f"|logit err| {logit_err:.6g} < {FM_LOGIT_TOL}; forward's mean |logit err| "
          f"{mean_err:.6g} < {FM_LOGIT_MEAN} [{card}]", flush=True)
    return {"loss_err": loss_err, "logit_err": logit_err, "mean_logit_err": mean_err}


def falcon_loss(dev, card, api, scan_counts, zero_counts, others) -> dict:
    """Phase 12, the main path: ``api.loss`` of falcon-mamba-7b at full
    width (bf16 weights from seed 0) on b=4 x 4096 tokens under
    ``torch.inference_mode()``; counts zeroed just before and read just
    after; then a profiler trace of one more forward."""
    import torch
    cfg = api.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init(gen, dev)
    toks = torch.randint(0, cfg.vocab, (LOSS_BATCH, LOSS_LEN + 1), generator=gen,
                         device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.inference_mode():
        api.loss(params, {k: v[:1, :256] for k, v in batch.items()})   # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        loss, parts = api.loss(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = scan_counts["mamba1_scan_fused"]
        stray = {k: v for c in others for k, v in c.items() if v}
        stray.update({k: v for k, v in scan_counts.items()
                      if v and k != "mamba1_scan_fused"})
        peak = torch.cuda.max_memory_allocated(dev)
        value = float(loss)
        if launches != cfg.n_layers or stray:
            raise AssertionError(f"the loss forward launched mamba1_scan_fused "
                                 f"{launches} times (and {stray}), expected "
                                 f"{cfg.n_layers} and no other kernel")
        if not (torch.isfinite(loss) and float(parts["aux"]) == 0.0):
            raise AssertionError(f"loss {value}, aux {float(parts['aux'])}")
        ntok = LOSS_BATCH * LOSS_LEN
        res = {"arch": FM_ARCH, "params": api.n_params(), "batch": LOSS_BATCH,
               "seq_len": LOSS_LEN, "loss": value, "wall_s": wall,
               "tokens_per_s": ntok / wall, "peak_mem_bytes": peak,
               "mamba1_scan_fused_launches": launches, "card": card}
        print(f"loss {FM_ARCH} b={LOSS_BATCH} L={LOSS_LEN}: loss {value:.6g} (finite), "
              f"wall {wall:.6g} s, {ntok / wall:.6g} tokens/s, peak memory {peak} B, "
              f"mamba1_scan_fused launches {launches}, selective_scan 0 [{card}]",
              flush=True)
        before = dict(scan_counts)
        res["profile"] = trace(f"{FM_ARCH} loss forward (b={LOSS_BATCH}, L={LOSS_LEN})",
                               lambda: api.loss(params, batch), card, top_n=12)
        res["profile"]["launches"] = {k: scan_counts[k] - before[k] for k in scan_counts}
        if res["profile"]["launches"] != {"selective_scan": 0,
                                          "mamba1_scan_fused": cfg.n_layers,
                                          "mamba1_scan_bwd": 0}:
            raise AssertionError(f"traced loss forward: {res['profile']['launches']}")
    return res


def falcon_serving(dev, card, serve, api, scan_counts, zero_counts, others) -> dict:
    """Phase 13, the serving path: ``serve_batch(falcon-mamba-7b)`` at full
    width, b=8, prompt 2048, 128 new tokens; counts zeroed just before and
    read just after (64 scan launches, all in the prefill: decode is plain
    ops), then a trace of a prefill and 4 decode steps."""
    import torch
    cfg = api.cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    tokens, t_prefill, t_decode = serve.serve_batch(
        FM_ARCH, reduced=False, batch=SERVE_BATCH, prompt_len=PROMPT_LEN,
        gen_tokens=GEN_TOKENS, seed=0)
    wall = time.perf_counter() - t0
    launches = scan_counts["mamba1_scan_fused"]
    stray = {k: v for c in others for k, v in c.items() if v}
    stray.update({k: v for k, v in scan_counts.items() if v and k != "mamba1_scan_fused"})
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != cfg.n_layers or stray:
        raise AssertionError(f"serving launched mamba1_scan_fused {launches} times (and "
                             f"{stray}), expected {cfg.n_layers} and no other kernel")
    if tokens.shape != (SERVE_BATCH, GEN_TOKENS) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab:
        raise AssertionError(f"bad generated tokens {tokens.shape}")
    tps = SERVE_BATCH * (GEN_TOKENS - 1) / t_decode
    print(f"serve {FM_ARCH} b={SERVE_BATCH} prompt {PROMPT_LEN} gen {GEN_TOKENS}: "
          f"prefill {t_prefill:.6g} s, decode {t_decode:.6g} s ({tps:.6g} tok/s), "
          f"peak memory {peak} B, mamba1_scan_fused launches {launches} [{card}]",
          flush=True)
    prof = serving_profile(dev, card, serve, api, scan_counts, top_n=12)
    if prof["prefill"]["launches"] != {"selective_scan": 0,
                                       "mamba1_scan_fused": cfg.n_layers,
                                       "mamba1_scan_bwd": 0} or \
            any(prof["decode"]["launches"].values()):
        raise AssertionError(f"scan launches by window: {prof}")
    return {"arch": FM_ARCH, "batch": SERVE_BATCH, "prompt_len": PROMPT_LEN,
            "gen_tokens": GEN_TOKENS, "prefill_s": t_prefill, "decode_s": t_decode,
            "decode_tok_per_s": tps, "serve_batch_wall_s": wall, "peak_mem_bytes": peak,
            "mamba1_scan_fused_launches": launches,
            "launches_by_window": {k: v["launches"] for k, v in prof.items()},
            "profile": prof, "card": card}


# ---------------------------------------------------------------------------
# the dense family: granite-3-2b served at full width, starcoder2-7b and
# qwen3-14b through the same two kernels
# ---------------------------------------------------------------------------


def flash_row(dev, card, fk, fr, gen, b, sq, sk, h, kv, d, causal, tag) -> dict:
    """Flash attention at (b, sq, sk, h, kv, d) in bf16 against its plain
    version (2e-2), then timed by CUDA events beside the plain version and
    SDPA (``enable_gqa=True``); the shapes' bytes and FLOP."""
    import torch
    import torch.nn.functional as F
    q = randn(gen, (b, sq, h, d), "bfloat16", dev)
    k = randn(gen, (b, sk, kv, d), "bfloat16", dev)
    v = randn(gen, (b, sk, kv, d), "bfloat16", dev)
    got = fk.flash_attention(q, k, v, causal=causal)
    plain = {}
    plain_ms = event_ms(lambda: plain.setdefault(
        "p", fr.attention_plain(q, k, v, causal=causal)))
    err = check_close(f"flash_attention {tag} b={b} sq={sq} sk={sk} "
                      f"{'causal' if causal else 'non-causal'} bf16", got,
                      plain.pop("p"), TOLS["bfloat16"], card)
    del got
    ms = cuda_ms(lambda: fk.flash_attention(q, k, v, causal=causal), reps=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), reps=10)
    nbytes, flops = costs.attention_bound(b, sq, sk, h, kv, d, 2, causal)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib, err=err, nbytes=nbytes,
                flops=flops, shape=[b, sq, sk, h, kv, d], causal=causal)


def decode_row(dev, card, dk, dr, gen, b, S, live, h, kv, d, tag, lens=None) -> dict:
    """Flash-decode against a (b, S, kv, d) bf16 cache: with ``lens`` (ragged
    ``cache_len`` per row) against its plain version (2e-2), then with a NaN
    tail past them, which must change nothing; then at ``live`` entries on
    every row, against the plain version and timed by CUDA events beside it
    and SDPA (``enable_gqa=True``, with a ``cache_len`` mask where ``live``
    is short of S)."""
    import torch
    import torch.nn.functional as F
    q = randn(gen, (b, 1, h, d), "bfloat16", dev)
    kc = randn(gen, (b, S, kv, d), "bfloat16", dev)
    vc = randn(gen, (b, S, kv, d), "bfloat16", dev)
    split = dk.plan_splits(b, S, h, kv, d)["split"]
    err = 0.0
    if lens is not None:
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = dk.decode_attention(q, kc, vc, lens)
        err = check_close(f"decode_attention {tag} b={b} S={S} cache_len="
                          f"{lens.tolist()} bf16", got,
                          dr.decode_attention_plain(q, kc, vc, lens),
                          TOLS["bfloat16"], card)
        kc2, vc2 = kc.clone(), vc.clone()
        for i, n in enumerate(lens.tolist()):
            kc2[i, n:] = 1e4
            vc2[i, n:] = float("nan")
        stale = dk.decode_attention(q, kc2, vc2, lens)
        torch.cuda.synchronize()
        if not torch.equal(stale, got):
            raise AssertionError(f"decode_attention {tag} read the cache past cache_len")
        del kc2, vc2, stale
    lens = torch.full((b,), live, dtype=torch.int32, device=dev)
    got = dk.decode_attention(q, kc, vc, lens)
    plain = {}
    plain_ms = event_ms(lambda: plain.setdefault(
        "p", dr.decode_attention_plain(q, kc, vc, lens)))
    err = max(err, check_close(f"decode_attention {tag} b={b} S={S} at {live} live "
                               f"entries", got, plain.pop("p"), TOLS["bfloat16"], card))
    ms = cuda_ms(lambda: dk.decode_attention(q, kc, vc, lens), reps=50)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kc, vc))
    mask = None
    if live < S:
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), reps=50)
    nbytes, flops = costs.attention_bound(b, 1, live, h, kv, d, 2, False)
    del q, kc, vc, qt, kt, vt, mask, got
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib, err=err, nbytes=nbytes,
                flops=flops, shape=[b, S, live, h, kv, d], split=split)


def bound_rows(rows, tag, card) -> None:
    """Each row's bound (the larger of its bytes at the memory rate and its
    FLOP at the bf16 tensor-core rate), printed beside its times."""
    for name, r in rows.items():
        t_bytes = r["nbytes"] / costs.HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / costs.BF16_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"time {name} {tag} shape {r['shape']}: kernel {r['ms']:.6g} ms, plain "
              f"version {r['plain_ms']:.6g} ms, SDPA {r['library_ms']:.6g} ms, bound "
              f"{r['bound_ms']:.6g} ms by {r['bound_by']} ({r['nbytes']} B, "
              f"{r['flops']} FLOP); {r['bound_ms'] / r['ms']:.4f} of the bound, "
              f"{r['flops'] / r['ms'] / 1e9:.6g} TFLOP/s, "
              f"{r['nbytes'] / r['ms'] / 1e6:.6g} GB/s, SDPA "
              f"{r['library_ms'] / r['ms']:.4g}x the kernel's speed [{card}]",
              flush=True)


def attention_kernel_checks(dev, card, fk, fr, dk, dr, get_api, archs) -> dict:
    """Phases 14 and 18: flash and decode at each config's serving shapes
    (b=8, prompt 2048; decode against a 2,176-entry cache), each against
    its plain version (bf16 2e-2; decode with ragged lengths and a NaN
    tail past them), then timed by CUDA events beside the plain version
    and SDPA (``enable_gqa=True``) with the bound from the shapes."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(2)
    b, s, S = SERVE_BATCH, PROMPT_LEN, PROMPT_LEN + GEN_TOKENS
    live = PROMPT_LEN + GEN_TOKENS // 2
    out = {}
    for arch in archs:
        cfg = get_api(arch).cfg
        h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        tag = f"{arch} (h={h}, kv={kv}, group {h // kv}, d={d})"
        split = dk.plan_splits(b, S, h, kv, d)["split"]
        rows = out[arch] = {
            "flash_attention": flash_row(dev, card, fk, fr, gen, b, s, s, h, kv, d,
                                         True, tag),
            "decode_attention": decode_row(
                dev, card, dk, dr, gen, b, S, live, h, kv, d, tag,
                lens=[S, live, 1, split - 1, split, split + 1, 700, 1500])}
        bound_rows(rows, tag, card)
    return out


def whisper_kernel_checks(dev, card, fk, fr, dk, dr, cfg) -> dict:
    """Phase 22: flash and decode at whisper-tiny's serving shapes (b=8, 6
    heads of 64, MHA): flash for the encoder (1,500 frames against
    themselves, non-causal), the decoder's self-attention (the 384-token
    prompt, causal) and cross-attention (the prompt against the 1,500
    frames, non-causal); decode against the self cache (448 entries,
    ragged lengths and a NaN tail, timed at 416 live) and against the
    cross cache (1,500 entries, every one live); each against its plain
    version and timed beside it, SDPA and its bound."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(3)
    b, h, kv, d = SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    P, E = WHISPER_PROMPT, cfg.enc_len
    S = P + WHISPER_GEN
    live = P + WHISPER_GEN // 2
    split = dk.plan_splits(b, S, h, kv, d)["split"]
    lens = [min(max(n, 1), S) for n in (S, live, 1, split - 1, split, split + 1,
                                        P + 1, S - 1)]
    tag = f"{cfg.name} (h={h}, kv={kv}, d={d})"
    rows = {
        "flash_attention/encoder": flash_row(dev, card, fk, fr, gen, b, E, E, h, kv, d,
                                             False, tag),
        "flash_attention/self": flash_row(dev, card, fk, fr, gen, b, P, P, h, kv, d,
                                          True, tag),
        "flash_attention/cross": flash_row(dev, card, fk, fr, gen, b, P, E, h, kv, d,
                                           False, tag),
        "decode_attention/self": decode_row(dev, card, dk, dr, gen, b, S, live, h, kv,
                                            d, tag, lens=lens),
        "decode_attention/cross": decode_row(dev, card, dk, dr, gen, b, E, E, h, kv, d,
                                             tag)}
    bound_rows(rows, tag, card)
    return rows


def attention_launches(cfg) -> tuple[int, int]:
    """(flash launches a prefill, decode launches a decode step) of a served
    attention model: one of each a layer; an enc-dec adds a flash launch
    for each encoder layer, and a flash launch in the prefill and a decode
    launch in each step for each decoder layer's cross-attention."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    return cfg.n_layers, cfg.n_layers


def attention_serving(dev, card, serve, get_api, arch, gen_tokens, attn_counts,
                      zero_counts, others, profile, ranges=None,
                      prompt_len=PROMPT_LEN) -> dict:
    """Phases 16-17, 20-21 and 24: ``serve_batch(arch)`` at full width and
    depth, b=8, ``prompt_len`` (2048), ``gen_tokens`` new tokens, seed 0, on
    the card (a VLM's vision embeddings or an enc-dec's frames drawn by
    ``make_inputs``); counts zeroed just before and read just after: the
    flash launches of ``attention_launches`` in the prefill and its decode
    launches in each decode step, no other kernel; peak memory under the
    card's.  With ``profile``, a trace of a prefill and 4 decode steps
    (``ranges``: see ``serving_profile``)."""
    import gc

    import torch
    api = get_api(arch)
    cfg = api.cfg
    flash_c, dec_c = attn_counts
    per_prefill, per_step = attention_launches(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    tokens, t_prefill, t_decode = serve.serve_batch(
        arch, reduced=False, batch=SERVE_BATCH, prompt_len=prompt_len,
        gen_tokens=gen_tokens, seed=0)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_c["flash_attention"],
                "decode_attention": dec_c["decode_attention"]}
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"flash_attention": per_prefill,
            "decode_attention": per_step * (gen_tokens - 1)}
    stray = {k: v for c in others for k, v in c.items() if v}
    if flash_c["flash_attention_bwd"]:
        stray["flash_attention_bwd"] = flash_c["flash_attention_bwd"]
    if launches != want or stray:
        raise AssertionError(f"serving {arch} launched {launches} (and {stray}), "
                             f"expected {want} and no other kernel")
    if tokens.shape != (SERVE_BATCH, gen_tokens) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab:
        raise AssertionError(f"bad generated tokens {tokens.shape} from {arch}")
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    if peak >= card_bytes:
        raise AssertionError(f"serving {arch} peaked at {peak} B, the card holds "
                             f"{card_bytes} B")
    tps = SERVE_BATCH * (gen_tokens - 1) / t_decode
    print(f"serve {arch} ({api.n_params()} parameters) b={SERVE_BATCH} prompt "
          f"{prompt_len} gen {gen_tokens}: every logit finite; prefill {t_prefill:.6g} s, "
          f"decode {t_decode:.6g} s ({tps:.6g} tok/s), peak memory {peak} B, launches "
          f"{launches} (expected {want}) [{card}]", flush=True)
    res = {"arch": arch, "params": api.n_params(), "batch": SERVE_BATCH,
           "prompt_len": prompt_len, "gen_tokens": gen_tokens, "prefill_s": t_prefill,
           "decode_s": t_decode, "decode_tok_per_s": tps, "serve_batch_wall_s": wall,
           "peak_mem_bytes": peak, "launches": launches, "card": card}
    if profile:
        prof = serving_profile(dev, card, serve, api, attn_counts, top_n=8,
                               ranges=ranges, prompt_len=prompt_len)
        by_window = {k: v["launches"] for k, v in prof.items()}
        # serving takes no gradient: no backward call in either window
        if by_window != {"prefill": {"flash_attention": per_prefill,
                                     "flash_attention_bwd": 0, "decode_attention": 0},
                         "decode": {"flash_attention": 0, "flash_attention_bwd": 0,
                                    "decode_attention": 4 * per_step}}:
            raise AssertionError(f"{arch} launches by window: {by_window}")
        res.update(launches_by_window=by_window, profile=prof)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def moe_vlm_slice_check(dev, card, get_api, moe, arch, tol, attn_counts) -> dict:
    """Phase 19: a reduced MoE or VLM serving path on the card against the
    same path on the CPU: same weights, tokens (and a VLM's vision
    embeddings) from one numpy generator, prefill at 128 then 4 decode
    steps; the largest logit error and each output's mean error within
    ``tol``; one flash launch a layer in the prefill and one decode launch
    a layer a step.  Each MoE layer's routing on the card is counted by
    ``moe.dropped`` on its input (a second ``route``, outside the counts)."""
    import numpy as np
    import torch
    api = get_api(arch, reduced=True)
    cfg = api.cfg
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 132)))
    vision = None
    if cfg.family == "vlm":
        vision = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    flash_c, dec_c = attn_counts
    drops = []
    apply = moe.moe_apply

    def counted(p, x, cfg_, group_size=None):
        if x.device.type == dev.type and x.shape[1] > 1:
            drops.append(moe.dropped(moe.route(p, x, cfg_, group_size)))
        return apply(p, x, cfg_, group_size)

    outs = []
    moe.moe_apply = counted
    try:
        for where in ("cpu", dev):
            params = api.init(0, "cpu").to(where)
            t = toks.to(where)
            batch = {"tokens": t[:, :128]}
            if vision is not None:
                batch["vision_embeds"] = vision.to(where)
            before = (flash_c["flash_attention"], dec_c["decode_attention"])
            lg, cache = api.prefill(params, batch, max_len=136)
            got = [lg.float().cpu()]
            for i in range(4):
                lg, cache = api.decode_step(params, t[:, 128 + i:129 + i], cache, 128 + i)
                got.append(lg[:, 0].float().cpu())
            outs.append(got)
            launched = (flash_c["flash_attention"] - before[0],
                        dec_c["decode_attention"] - before[1])
    finally:
        moe.moe_apply = apply
    if launched != (cfg.n_layers, 4 * cfg.n_layers):
        raise AssertionError(f"reduced {arch} on the card launched {launched} (flash, "
                             f"decode), expected {(cfg.n_layers, 4 * cfg.n_layers)}")
    errs = [float((a - b).abs().max()) for a, b in zip(*outs)]
    means = [float((a - b).abs().mean()) for a, b in zip(*outs)]
    max_tol, mean_tol = tol
    if not all(bool(torch.isfinite(b).all()) for b in outs[1]) or max(errs) >= max_tol \
            or max(means) >= mean_tol:
        raise AssertionError(f"reduced {arch} on the card differs from the CPU: max "
                             f"{errs}, mean {means}")
    print(f"slice reduced {arch} b=2 prefill 128 + 4 decode steps: card vs CPU max "
          f"|logit err| {max(errs):.6g} < {max_tol}, largest mean {max(means):.6g} < "
          f"{mean_tol} (prefill {errs[0]:.6g}, decode steps "
          f"{', '.join(f'{e:.6g}' for e in errs[1:])}); tokens dropped at capacity "
          f"by each MoE layer of the card's prefill: {drops} [{card}]", flush=True)
    return {"max_logit_err": max(errs), "mean_logit_err": max(means),
            "prefill_drops": drops}


def whisper_slice_check(dev, card, get_api, build_api, attn_counts) -> dict:
    """Phase 23: the reduced whisper serving path on the card against the
    same path on the CPU, at the reduced config's 32 frames and at 256:
    same weights, frames and tokens from one numpy generator, prefill at
    128 then 4 decode steps; every logit within ``WHISPER_SLICE_TOL``;
    the flash launches of the encoder, self- and cross-attention in the
    prefill and a self and a cross decode launch a layer a step."""
    import dataclasses

    import numpy as np
    import torch
    flash_c, dec_c = attn_counts
    out = {}
    for enc_len in WHISPER_ENC_LENS:
        api = build_api(dataclasses.replace(get_api(WHISPER, reduced=True).cfg,
                                            enc_len=enc_len))
        cfg = api.cfg
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 132)))
        frames = torch.from_numpy(rng.standard_normal(
            (2, enc_len, cfg.d_model)).astype(np.float32))
        outs = []
        for where in ("cpu", dev):
            params = api.init(0, "cpu").to(where)
            t = toks.to(where)
            before = (flash_c["flash_attention"], dec_c["decode_attention"])
            lg, cache = api.prefill(params, {"frames": frames.to(where),
                                             "tokens": t[:, :128]}, max_len=136)
            got = [lg.float().cpu()]
            for i in range(4):
                lg, cache = api.decode_step(params, t[:, 128 + i:129 + i], cache, 128 + i)
                got.append(lg[:, 0].float().cpu())
            outs.append(got)
            launched = (flash_c["flash_attention"] - before[0],
                        dec_c["decode_attention"] - before[1])
        per_prefill, per_step = attention_launches(cfg)
        if launched != (per_prefill, 4 * per_step):
            raise AssertionError(f"reduced {WHISPER} (enc_len {enc_len}) on the card "
                                 f"launched {launched} (flash, decode), expected "
                                 f"{(per_prefill, 4 * per_step)}")
        errs = [float((a - b).abs().max()) for a, b in zip(*outs)]
        if not all(bool(torch.isfinite(b).all()) for b in outs[1]) \
                or max(errs) >= WHISPER_SLICE_TOL:
            raise AssertionError(f"reduced {WHISPER} (enc_len {enc_len}) on the card "
                                 f"differs from the CPU: {errs}")
        print(f"slice reduced {WHISPER} enc_len {enc_len} b=2 prefill 128 + 4 decode "
              f"steps: card vs CPU max |logit err| {max(errs):.6g} < "
              f"{WHISPER_SLICE_TOL} (prefill {errs[0]:.6g}, decode steps "
              f"{', '.join(f'{e:.6g}' for e in errs[1:])}); launches {launched} "
              f"[{card}]", flush=True)
        out[enc_len] = {"max_logit_err": max(errs), "errs": errs, "launches": launched}
    return out


def moldesign_phase(card, counters, zero_counts) -> dict:
    """Phase 25: ``examples/torch_molecular_design.py`` (the paper's
    molecular-design campaign, four waves of 48, through ``OnlineEngine``
    with Cluster MHRA; the surrogate trained by autograd) on the card and
    on the CPU: every window (``window_digest``) and the engine's summary
    but its host clock equal; the window kernel's launches on the card's
    run (counts zeroed just before, read just after), no model kernel."""
    md = load_example("torch_molecular_design")
    runs = {}
    for where in (None, "cpu"):
        zero_counts()
        t0 = time.perf_counter()
        res = md.main(device=where)
        wall = time.perf_counter() - t0
        launches = {k: v for c in counters for k, v in c.items() if v}
        runs["card" if where is None else "cpu"] = (res, wall, launches)
    (card_res, card_wall, launches), (cpu_res, cpu_wall, _) = runs["card"], runs["cpu"]
    if set(launches) - {"greedy_window"}:
        raise AssertionError(f"the molecular-design campaign launched {launches}")
    got = bits([window_digest(w) for w in card_res.windows])
    want = bits([window_digest(w) for w in cpu_res.windows])
    if got != want:
        raise AssertionError("molecular design: the card's windows differ from the CPU's "
                             f"at {first_difference(got, want)}")
    s_card = summary_without_clock(card_res.engine.summary())
    if bits(s_card) != bits(summary_without_clock(cpu_res.engine.summary())):
        raise AssertionError("molecular design: the card's summary differs from the CPU's")
    # the surrogate starts from one model on both: its first wave trains on
    # the same data, so the card's float32 autograd is held to the CPU's
    mse_err = abs(card_res.waves[0][0] - cpu_res.waves[0][0])
    if not mse_err < MD_MSE_TOL:
        raise AssertionError(f"molecular design: the surrogate's first-wave MSE on the "
                             f"card differs from the CPU's by {mse_err}")
    n = launches.get("greedy_window", 0)
    print(f"molecular design ({s_card['tasks']} tasks, {len(got)} windows, "
          f"{card_res.edges} DAG edges): card == CPU on every window and the summary; "
          f"{n} window launches; wall {card_wall:.6g} s (CPU {cpu_wall:.6g} s); "
          f"surrogate mse by wave card {[round(m, 6) for m, _, _ in card_res.waves]}, "
          f"CPU {[round(m, 6) for m, _, _ in cpu_res.waves]} (first wave within "
          f"{MD_MSE_TOL}: {mse_err:.3g}); picks equal in "
          f"{sum(bool((a == b).all()) for a, b in zip(card_res.picks, cpu_res.picks))} "
          f"of {len(card_res.picks)} waves [{card}]", flush=True)
    return {"tasks": s_card["tasks"], "windows": len(got), "dag_edges": card_res.edges,
            "first_wave_mse_err": mse_err,
            "window_launches": n, "wall_s": card_wall, "cpu_wall_s": cpu_wall,
            "surrogate_mse": [m for m, _, _ in card_res.waves],
            "surrogate_mse_cpu": [m for m, _, _ in cpu_res.waves],
            "best": card_res.best, "placements": card_res.placements}


def default_executor(dev, card, sched, eps, GreenFaaSExecutor, TestbedSim,
                     TaskProfileStore, BASE_PROFILES, MACHINE_COEFS,
                     SEBS_FUNCTIONS, kernel, counters, zero_counts) -> dict:
    """Phase 3b: the executor as users build it (no strategy: Cluster
    MHRA) on the card for three batches of the main path's shape, which
    must place on the host's SoA engine and launch no kernel; then Cluster
    MHRA with single-task clusters (one window launch, equal to the CPU),
    and the SoA engine against the window kernel on one 32,768-task
    window (the reference's soa <=> jax contract)."""
    import numpy as np
    import torch
    fields = ("assignments", "objective", "energy_j", "makespan_s",
              "transfer_j", "heuristic", "timeline")
    # host-clock spans of the two layers Cluster MHRA adds, read per batch
    spans = {"compute_clusters": [], "_mhra_soa": []}
    clusters = []
    originals = {k: getattr(sched, k) for k in spans}

    def timed(name):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = originals[name](*args, **kw)
            spans[name].append(time.perf_counter() - t0)
            if name == "compute_clusters":
                clusters.append(out)
            return out
        return call

    profiles, coefs = replica_profiles(eps, BASE_PROFILES, MACHINE_COEFS)
    sim = TestbedSim(eps, profiles=profiles, coefs=coefs, seed=0)
    ex = GreenFaaSExecutor(eps, sim, alpha=0.5, monitoring=True)
    if ex.policy.name != "cluster_mhra" or ex.device != dev:
        raise AssertionError(f"default executor: {ex.policy.name} on {ex.device}")
    ex.store = seeded_store(eps, TaskProfileStore, BASE_PROFILES, SEBS_FUNCTIONS)
    batches = []
    for k in spans:
        setattr(sched, k, timed(k))
    try:
        zero_counts()
        for b in range(N_BATCHES):
            tasks = make_tasks(N_TASKS, eps[0].name, sched.TaskSpec,
                               SEBS_FUNCTIONS, f"d{b}t")
            t0 = time.perf_counter()
            res = ex.run_batch(tasks)
            wall = time.perf_counter() - t0
            s = res.schedule
            cl = clusters[-1]
            vals = (s.objective, s.energy_j, s.makespan_s, res.measured_energy_j,
                    res.attributed_energy_j, res.makespan_s, res.edp())
            if len(s.assignments) != N_TASKS or len(s.timeline) != N_TASKS \
                    or not np.all(np.isfinite(vals)):
                raise AssertionError(f"default executor batch {b}: incomplete "
                                     f"schedule or non-finite result")
            if sorted(i for c in cl for i in c) != list(range(N_TASKS)):
                raise AssertionError(f"batch {b}: clusters are not a partition")
            if set(s.assignments.values()) - {e.name for e in eps}:
                raise AssertionError(f"batch {b}: assignment to an unknown endpoint")
            batches.append({
                "batch": b, "placement_s": res.scheduling_s, "run_batch_s": wall,
                "compute_clusters_s": spans["compute_clusters"][-1],
                "mhra_soa_s": spans["_mhra_soa"][-1], "clusters": len(cl),
                "largest_cluster": max(map(len, cl)), "makespan_s": res.makespan_s,
                "measured_energy_j": res.measured_energy_j, "edp": res.edp(),
                "heuristic": s.heuristic,
                "endpoints_used": len(set(s.assignments.values())),
            })
            print(f"default executor batch {b}: placement {res.scheduling_s:.3f} s "
                  f"(compute_clusters {spans['compute_clusters'][-1]:.3f} s, "
                  f"{len(cl)} clusters of up to {max(map(len, cl))} tasks; "
                  f"_mhra_soa {spans['_mhra_soa'][-1]:.3f} s), run_batch "
                  f"{wall:.3f} s, makespan {res.makespan_s:.3f} s, measured "
                  f"energy {res.measured_energy_j:.1f} J, EDP {res.edp():.6g} J*s "
                  f"[{card}]", flush=True)
        counts = {k: v for c in counters for k, v in c.items()}
    finally:
        for k, fn in originals.items():
            setattr(sched, k, fn)
    if any(counts.values()):
        raise AssertionError(f"the default executor launched kernels: {counts}")
    print(f"default executor launches: {counts} (greedy_window 0: every "
          f"window clustered, placed on the host)", flush=True)

    store = seeded_store(eps, TaskProfileStore, BASE_PROFILES, SEBS_FUNCTIONS)
    tm = ex.transfer
    # single-task clusters: the fused route, one launch, equal to the CPU
    small = make_tasks(LARGE_TASKS, eps[0].name, sched.TaskSpec, SEBS_FUNCTIONS, "c")
    before = kernel.LAUNCHES["greedy_window"]
    s_card = sched.cluster_mhra(small, eps, store, tm, 0.5, max_cluster_size=1)
    n_launch = kernel.LAUNCHES["greedy_window"] - before
    s_cpu = sched.cluster_mhra(small, eps, store, tm, 0.5, max_cluster_size=1,
                               device="cpu")
    if n_launch != 1:
        raise AssertionError(f"single-task Cluster MHRA launched greedy_window "
                             f"{n_launch} times")
    for f in fields:
        if getattr(s_card, f) != getattr(s_cpu, f):
            raise AssertionError(f"single-task Cluster MHRA on the card differs "
                                 f"from the CPU on {f}")
    print(f"cluster_mhra max_cluster_size=1 {LARGE_TASKS}x{len(eps)}: one "
          f"greedy_window launch, card == CPU (assignments, objective, energy, "
          f"makespan, transfer, heuristic, timeline)", flush=True)

    # the SoA engine against the window kernel at the main path's shape
    tasks = make_tasks(N_TASKS, eps[0].name, sched.TaskSpec, SEBS_FUNCTIONS, "x")
    t0 = time.perf_counter()
    table = sched.PredictionTable(tasks, eps, store)
    sf1, sf2, _ = sched._normalizers_fast(tasks, eps, table, tm)
    s_host = sched._mhra_soa([[t] for t in tasks], [[i] for i in range(N_TASKS)],
                             eps, table, tm, 0.5, sched.HEURISTICS, sf1, sf2, None)
    host_s = time.perf_counter() - t0
    before = kernel.LAUNCHES["greedy_window"]
    t0 = time.perf_counter()
    s_kernel = sched.mhra(tasks, eps, store, tm, 0.5)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    if kernel.LAUNCHES["greedy_window"] != before + 1:
        raise AssertionError("mhra(device=None) did not launch greedy_window once")
    for f in fields:
        if getattr(s_host, f) != getattr(s_kernel, f):
            raise AssertionError(f"the SoA engine and the window kernel differ on "
                                 f"{f} at {N_TASKS}x{len(eps)}")
    print(f"cross-check {N_TASKS}x{len(eps)}x{len(sched.HEURISTICS)}: host SoA "
          f"engine == window kernel (assignments, objective, energy, makespan, "
          f"transfer, heuristic, timeline); placement on the host {host_s:.3f} s, "
          f"mhra(device=None) {kernel_s:.3f} s [{card}]", flush=True)
    return {"batches": batches, "launches": counts,
            "singleton_clusters": {"tasks": LARGE_TASKS, "launches": n_launch},
            "cross_check": {"tasks": N_TASKS, "endpoints": len(eps),
                            "soa_s": host_s, "mhra_device_s": kernel_s},
            "card": card}


def registers_phase(dev, card, sched, eps, store, tm, kernel, ops, counters,
                    zero_counts) -> dict:
    """Phase 3c: the window kernel with the four scoring registers armed,
    against its plain version and against the host SoA engine, and the two
    policies that build the registers on the card."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.carbon import CarbonIntensitySignal
    from repro_torch.core.dag import DAGView, LookaheadWeights
    from repro_torch.core.endpoint import scaled_testbed
    from repro_torch.core.policy import PolicyContext, get_policy
    from repro_torch.core.predictor import TaskProfileStore
    from repro_torch.core.testbed import BASE_PROFILES, SEBS_FUNCTIONS
    from repro_torch.core.transfer import TransferModel
    fields = ("assignments", "objective", "energy_j", "makespan_s",
              "transfer_j", "heuristic", "timeline", "carbon_g")
    outs = ("ei", "start", "end", "base", "slots", "run", "staged", "hs")

    def packed(tasks, kw, fleet):
        """window_inputs (timed) and the packed window on the card."""
        f_eps, f_store, f_tm = fleet
        t0 = time.perf_counter()
        table = sched.PredictionTable(tasks, f_eps, f_store)
        sf1, sf2, sf3 = sched._normalizers_fast(tasks, f_eps, table, f_tm,
                                                kw.get("carbon"))
        prep0 = time.perf_counter()
        n_ep, consts, init, xs, _ = sched.window_inputs(
            [[t] for t in tasks], [[i] for i in range(len(tasks))], f_eps, table,
            f_tm, 0.5, sched.HEURISTICS, sf1, sf2, sched.SoAState(f_eps, f_tm),
            None, dev, sf3=sf3, **kw)
        prep_s = time.perf_counter() - prep0
        p, n_units = ops.pack(consts, init, xs, dev)
        share = float(xs["new_run"].sum()) / (len(sched.HEURISTICS) * n_units)
        return p, n_ep, n_units, {"window_inputs_s": prep_s,
                                  "table_and_normalizers_s": prep0 - t0,
                                  "new_run_share": share,
                                  "hv_rows": int(p["hv_tab"].shape[0])}

    def against_plain(p, n_ep, n_units, label):
        out_k = kernel.greedy_window(p, n_ep, n_units)
        out_p = ops._greedy_scan_plain(p, n_ep, n_units)
        torch.cuda.synchronize()
        for k in outs:
            if not bits_equal(out_k[k], out_p[k]):
                raise AssertionError(f"greedy_window with registers disagrees with "
                                     f"the plain version on '{k}' ({label})")
        return max(max_abs_err(out_k[k], out_p[k])
                   for k in ("start", "end", "base", "slots", "run", "hs"))

    res = {"card": card, "plain_checks": [], "windows": {}, "policies": {}}
    fleet = (eps, store, tm)
    # 1. the kernel against its plain version, every register armed
    tasks, kw = register_snapshots(
        make_tasks(CHECK_TASKS, eps[0].name, sched.TaskSpec, SEBS_FUNCTIONS, "g"),
        eps, 40, floors=True)
    p, n_ep, n_units, info = packed(tasks, kw, fleet)
    if info["hv_rows"] < 64:
        raise AssertionError(f"the hop table has {info['hv_rows']} rows")
    err = against_plain(p, n_ep, n_units, f"{CHECK_TASKS} tasks")
    pl = kernel.plan(p["base"].shape[2], p["slots"].shape[2], p["staged"].shape[1])
    res["plain_checks"].append({"tasks": n_units, "endpoints": n_ep, "plan": pl,
                                "max_abs_err": err, **info})
    print(f"registers: greedy_window {n_units}x{n_ep}x{len(sched.HEURISTICS)} "
          f"(carbon, lookahead with {info['hv_rows']} hop rows, warm, fairness, "
          f"floors): bitwise equal to the plain version; new_run share "
          f"{info['new_run_share']:.4f}; plan {pl}", flush=True)
    for replicas, want_plan in REG_PLANS.items():
        l_eps = scaled_testbed(replicas)
        l_fleet = (l_eps, seeded_store(l_eps, TaskProfileStore, BASE_PROFILES,
                                       SEBS_FUNCTIONS), TransferModel(l_eps))
        tasks, kw = register_snapshots(
            make_tasks(LARGE_TASKS, l_eps[0].name, sched.TaskSpec, SEBS_FUNCTIONS,
                       "g"), l_eps, 41, floors=True)
        p, n_ep_l, n_units_l, info = packed(tasks, kw, l_fleet)
        E_l = p["base"].shape[2]
        pl = kernel.plan(E_l, p["slots"].shape[2], p["staged"].shape[1])
        if any(pl[k] != v for k, v in want_plan.items()):
            raise AssertionError(f"greedy_window at {n_ep_l} endpoints planned {pl}, "
                                 f"expected {want_plan}")
        err = against_plain(p, n_ep_l, n_units_l, f"{n_ep_l} endpoints")
        ms_l = cuda_ms(lambda: kernel.greedy_window(p, n_ep_l, n_units_l), reps=3,
                       warmup=1)
        res["plain_checks"].append({"tasks": n_units_l, "endpoints": n_ep_l,
                                    "lanes": E_l, "plan": pl, "max_abs_err": err,
                                    "ms": ms_l, "us_per_step": ms_l * 1e3 / n_units_l,
                                    **info})
        print(f"registers: greedy_window {n_units_l}x{n_ep_l} (E={E_l}): bitwise "
              f"equal to the plain version; {ms_l:.6g} ms, "
              f"{ms_l * 1e3 / n_units_l:.4g} us a step; new_run share "
              f"{info['new_run_share']:.4f}; plan {pl} [{card}]", flush=True)
    del p

    # 2. full-size windows: (a) carbon and warm (the run keys of phase 2),
    # (b) all four; each through mhra(device=None) and the host SoA engine
    H = len(sched.HEURISTICS)
    for variant, which in (("a", ("carbon", "warm")), ("b", REGISTERS)):
        tasks, kw = register_snapshots(
            make_tasks(N_TASKS, eps[0].name, sched.TaskSpec, SEBS_FUNCTIONS,
                       f"w{variant}"), eps, 42, which=which)
        p, n_ep, n_units, info = packed(tasks, kw, fleet)
        gw_ms = cuda_ms(lambda: kernel.greedy_window(p, n_ep, n_units), reps=3,
                        warmup=1)
        n_new_run = int(p["xs_i"][:, 4].sum())
        in_bytes = sum(v.numel() * v.element_size() for v in p.values())
        out_bytes = sum(v.numel() * v.element_size()
                        for v in kernel.greedy_window(p, n_ep, n_units).values())
        C = p["slots"].shape[2]
        # the FP64 operations of phase 4's count, the run boundaries of this
        # window; the register terms add ~25 a lane to each full pass
        w_ops = (H * n_units * (13 * n_ep + 35 + 2 * C)
                 + n_new_run * (55 * n_ep + 2 * n_ep))
        bound = max((in_bytes + out_bytes) / costs.HBM_BYTES_PER_S,
                    w_ops / costs.FP64_FLOPS) * 1e3
        del p
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        s_card = sched.mhra(tasks, eps, store, tm, 0.5, **kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts = {k: v for c in counters for k, v in c.items()}
        if counts["greedy_window"] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"register window ({variant}) launched {counts}")
        t0 = time.perf_counter()
        table = sched.PredictionTable(tasks, eps, store)
        sf1, sf2, sf3 = sched._normalizers_fast(tasks, eps, table, tm,
                                                kw.get("carbon"))
        s_host = sched._mhra_soa([[t] for t in tasks],
                                 [[i] for i in range(len(tasks))], eps, table, tm,
                                 0.5, sched.HEURISTICS, sf1, sf2, None, sf3=sf3, **kw)
        host_s = time.perf_counter() - t0
        for f in fields:
            if getattr(s_host, f) != getattr(s_card, f):
                raise AssertionError(f"register window ({variant}): the host SoA "
                                     f"engine and the window kernel differ on {f}")
        if s_card.carbon_g is None or not np.isfinite(s_card.carbon_g):
            raise AssertionError(f"register window ({variant}): no carbon_g")
        res["windows"][variant] = {
            "registers": list(which), "tasks": n_units, "endpoints": n_ep,
            "kernel_ms": gw_ms, "us_per_step": gw_ms * 1e3 / n_units,
            "new_run_steps": n_new_run, "bound_ms": bound,
            "mhra_device_s": card_s, "soa_s": host_s, "launches": counts,
            "carbon_g": s_card.carbon_g, "heuristic": s_card.heuristic, **info}
        print(f"registers ({variant}: {', '.join(which)}) {n_units}x{n_ep}x{H}: "
              f"kernel {gw_ms:.6g} ms, {gw_ms * 1e3 / n_units:.4g} us a step, "
              f"new_run share {info['new_run_share']:.4f} ({n_new_run} steps), "
              f"bound {bound * 1e3:.3f} us; window_inputs "
              f"{info['window_inputs_s']:.3f} s; mhra(device=None) {card_s:.3f} s "
              f"(one launch), host SoA engine {host_s:.3f} s, equal on "
              f"{', '.join(fields)} [{card}]", flush=True)

    # 3. the two policies that build registers, through get_policy
    names = [e.name for e in eps]
    signal = CarbonIntensitySignal.diurnal(names, seed=5)
    tasks = make_tasks(2048, eps[0].name, sched.TaskSpec, SEBS_FUNCTIONS, "cp")
    devs = {"card": dev, "cpu": torch.device("cpu")}
    ctx = {k: PolicyContext(eps, store, tm, 0.5, carbon=signal, now=30_000.0,
                            device=d) for k, d in devs.items()}
    # a 3-level DAG: roots, three children each and a join per root; the
    # first half of the roots completed, their children ready with the
    # parent's output as their one input
    rng = np.random.default_rng(6)
    runtime = {fn: float(np.mean([store.predict(fn, n).runtime_s for n in names]))
               for fn in SEBS_FUNCTIONS}
    dag = DAGView(runtime.__getitem__)
    roots, ready = [], []
    for r in range(256):
        root = sched.TaskSpec(id=f"r{r}", fn=SEBS_FUNCTIONS[r % 7])
        kids = [sched.TaskSpec(id=f"r{r}c{k}", fn=SEBS_FUNCTIONS[(r + k + 1) % 7],
                               deps=(root.id,),
                               dep_bytes=float(rng.uniform(1e7, 4e8)))
                for k in range(3)]
        join = sched.TaskSpec(id=f"r{r}j", fn=SEBS_FUNCTIONS[(r + 5) % 7],
                              deps=tuple(k.id for k in kids),
                              dep_bytes=float(rng.uniform(1e7, 2e8)))
        for t in (root, *kids, join):
            dag.add_task(t)
        roots.append((root, kids))
    for r, (root, kids) in enumerate(roots[:128]):
        ep, t_end = names[r % len(names)], 10.0 + r % 7
        dag.complete(root.id, ep, t_end)
        ready += [dataclasses.replace(k, deps=(), not_before=t_end,
                                      inputs=((ep, 1, k.dep_bytes, False),))
                  for k in kids]
    batch = [root for root, _ in roots[128:]] + ready
    lk = LookaheadWeights.from_dag(dag, batch, eps, tm, 1.0, store=store,
                                   producer_aware=True)
    if lk is None or not lk.hops_task:
        raise AssertionError("the DAG view gave no producer-aware lookahead")
    lctx = {k: PolicyContext(eps, store, tm, 0.5, dag=dag, device=d)
            for k, d in devs.items()}
    for name, pol_kw, p_tasks, pctx in (
            ("carbon_mhra", {}, tasks, ctx),
            ("lookahead_mhra", {"producer_aware": True}, batch, lctx)):
        policy = get_policy(name, **pol_kw)
        zero_counts()
        t0 = time.perf_counter()
        s_card = policy.place(p_tasks, pctx["card"])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts = {k: v for c in counters for k, v in c.items()}
        s_cpu = policy.place(p_tasks, pctx["cpu"])
        if counts["greedy_window"] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"{name} launched {counts}")
        for f in fields:
            if getattr(s_card, f) != getattr(s_cpu, f):
                raise AssertionError(f"{name} on the card differs from the CPU on {f}")
        res["policies"][name] = {"tasks": len(p_tasks), "place_s": card_s,
                                 "launches": counts, "carbon_g": s_card.carbon_g,
                                 "heuristic": s_card.heuristic}
        print(f"{name} {len(p_tasks)}x{len(eps)} through get_policy on the card: "
              f"one greedy_window launch, card == CPU ({', '.join(fields)}); "
              f"place {card_s:.3f} s [{card}]", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 3d: the streaming path, OnlineEngine over one live state
# ---------------------------------------------------------------------------


def epoch_dag_tasks(n_tasks, width, TaskSpec, SEBS_FUNCTIONS):
    """Fork-join epochs (``benchmarks/placement_latency.py:196-224``):
    ``width`` workers fan out of the previous epoch's reducer with 5 MB
    each, then a reducer joins them with 1 MB from each."""
    tasks, epoch = [], 0
    while len(tasks) < n_tasks:
        prev = f"r{epoch - 1}" if epoch else None
        workers = []
        for j in range(width):
            if len(tasks) >= n_tasks - 1:
                break
            tid = f"e{epoch}_{j}"
            tasks.append(TaskSpec(id=tid, fn=SEBS_FUNCTIONS[j % len(SEBS_FUNCTIONS)],
                                  deps=(prev,) if prev else (), dep_bytes=5e6))
            workers.append(tid)
        tasks.append(TaskSpec(id=f"r{epoch}",
                              fn=SEBS_FUNCTIONS[epoch % len(SEBS_FUNCTIONS)],
                              deps=tuple(workers), dep_bytes=1e6))
        epoch += 1
    return tasks


def build_stream(name, device):
    """One of phase 3d's streams as a fresh engine and its script of
    calls: ``("tick", t)``, ``("submit", task, t)``, ``("submit_many",
    tasks, t)``, ``("drain",)``."""
    import dataclasses

    import numpy as np

    from repro_torch.core.carbon import CarbonIntensitySignal
    from repro_torch.core.endpoint import scaled_testbed
    from repro_torch.core.engine import OnlineEngine
    from repro_torch.core.fairness import FairShare
    from repro_torch.core.predictor import TaskProfileStore
    from repro_torch.core.region import RegionRouter, RegionSpec
    from repro_torch.core.scheduler import TaskSpec
    from repro_torch.core.testbed import (
        BASE_PROFILES, MACHINE_COEFS, SEBS_FUNCTIONS, TestbedSim,
    )
    from repro_torch.workloads.faults import churn_fault_trace
    fns = SEBS_FUNCTIONS
    if name == "poisson":
        # placement_latency.py:100-126 at its largest fleet
        eps = scaled_testbed(8)
        store = seeded_store(eps, TaskProfileStore, BASE_PROFILES, fns)
        eng = OnlineEngine(eps, None, policy="lookahead_mhra", alpha=0.5,
                           window_s=POISSON_WINDOW_S, max_batch=256, store=store,
                           monitoring=False, device=device)
        n = POISSON_TASKS
        arrivals = np.cumsum(np.random.default_rng(0).exponential(
            1.0 / POISSON_RATE_HZ, size=n))
        rng = np.random.default_rng(1)
        dep_draw, dep_of = rng.random(n), rng.integers(1, 64, size=n)
        inputs = ((eps[0].name, 1, 200e6, True),)
        script = []
        for i, arr in enumerate(arrivals):
            deps = ()
            if dep_draw[i] < 0.1 and i > 0:
                deps = (f"t{max(0, i - int(dep_of[i]))}",)
            script.append(("tick", float(arr)))
            script.append(("submit", TaskSpec(
                id=f"t{i}", fn=fns[i % len(fns)], inputs=inputs, deps=deps,
                dep_bytes=1e6 if deps else 0.0), float(arr)))
        return eng, script + [("drain",)]
    if name == "long":
        # placement_latency.py:196-254: fork-join epochs, pruned, 8 windows kept
        eps = scaled_testbed(2)
        store = seeded_store(eps, TaskProfileStore, BASE_PROFILES, fns)
        eng = OnlineEngine(eps, None, policy="lookahead_mhra", alpha=0.5,
                           window_s=1e9, max_batch=10**9, store=store,
                           monitoring=False, prune=True, retain_windows=8,
                           device=device)
        tasks = epoch_dag_tasks(LONG_STREAM_TASKS, LONG_STREAM_WIDTH, TaskSpec, fns)
        return eng, [("submit_many", tasks, 0.0), ("drain",)]
    # "armed": a monitored stream with every fault and register armed
    eps = [dataclasses.replace(e, cold_start_s=1.5, cold_start_j=30.0,
                               keepalive_s=20.0) for e in scaled_testbed(8)]
    names = [e.name for e in eps]
    half = len(names) // 2
    regions = {n: ("east" if i < half else "west") for i, n in enumerate(names)}
    faults = churn_fault_trace(names, ARMED_HORIZON_S, churn=0.15, mttr_s=30.0,
                               seed=0, protect=(names[0], names[half]),
                               straggler_p=0.05, straggler_factor=3.0)
    profiles, coefs = replica_profiles(eps, BASE_PROFILES, MACHINE_COEFS)
    sim = TestbedSim(eps, profiles=profiles, coefs=coefs, seed=0, faults=faults)
    carbon = CarbonIntensitySignal.diurnal(
        ["east", "west"], period_s=600.0, seed=2, regions=regions,
    ).with_forecast_noise(0.1, seed=3)
    router = RegionRouter([
        RegionSpec("east", tuple(names[:half]), callers=ARMED_USERS[:2]),
        RegionSpec("west", tuple(names[half:]), callers=ARMED_USERS[2:]),
    ], mode="agent")
    store = seeded_store(eps, TaskProfileStore, BASE_PROFILES, fns)
    eng = OnlineEngine(
        eps, sim, policy="carbon_mhra", alpha=0.5, window_s=30.0,
        max_batch=ARMED_WINDOW, store=store, monitoring=True, device=device,
        carbon=carbon, defer_horizon_s=60.0, faults=faults, spec_factor=2.0,
        retry_backoff_s=5.0,
        fairness=FairShare(budget_j=1500.0, window_s=30.0, mu=0.5),
        admission="defer", regions=router)
    n = ARMED_TASKS
    rng = np.random.default_rng(4)
    arrivals = np.cumsum(rng.exponential(1.0 / ARMED_RATE_HZ, size=n))
    # one heavy user and three light ones
    users = rng.choice(len(ARMED_USERS), size=n, p=[0.55, 0.15, 0.15, 0.15])
    src = {"east": names[0], "west": names[half]}
    script = []
    for i, arr in enumerate(arrivals):
        u = ARMED_USERS[int(users[i])]
        home = "east" if u in ARMED_USERS[:2] else "west"
        script.append(("tick", float(arr)))
        script.append(("submit", TaskSpec(
            id=f"a{i}", fn=fns[i % len(fns)], user=u,
            inputs=((src[home], 1, 2e6, True),)), float(arr)))
    return eng, script + [("drain",)]


def window_digest(res) -> tuple:
    """A ``WindowResult`` as compared between the card and the CPU: its
    index, arrival, tasks and their floors, the whole ``Schedule``, the
    attributed energy and the simulator's records."""
    s = res.schedule
    return (res.index, res.submitted_at, tuple(t.id for t in res.tasks),
            tuple(t.not_before for t in res.tasks), s.assignments,
            s.objective, s.energy_j, s.makespan_s, s.transfer_j,
            s.heuristic, s.timeline, s.carbon_g, res.attributed_j,
            None if res.sim is None else tuple(
                (r.task_id, r.endpoint, r.worker_pid, r.t_start, r.t_end,
                 r.energy_j, r.failed) for r in res.sim.records))


def run_stream(eng, script, kernel, ops):
    """Drive one stream; return every window's digest (the whole
    ``Schedule``, the tasks placed, the simulator's records), the summary
    but its host clock, the placement calls (all, and those whose units
    are all single tasks with at most one input: the window kernel's),
    per-decision placement latencies, the window kernel's device ms (CUDA
    events around each launch) and the window wrapper's host seconds."""
    import numpy as np
    import torch

    digests, lat, sched_s = [], [], []
    calls = {"place": 0, "fused_shape": 0, "fused_place_s": 0.0,
             "window_wrapper_s": 0.0}
    events = []
    flush, place = eng.flush, eng.policy.place
    k_window, o_window = kernel.greedy_window, ops.greedy_window

    def recorded():
        res = flush()
        if res is not None:
            digests.append(window_digest(res))
            lat.extend([res.scheduling_s / len(res.tasks) * 1e3] * len(res.tasks))
            sched_s.append(res.scheduling_s)
        return res

    def counted(tasks, ctx, state=None):
        t0 = time.perf_counter()
        out = place(tasks, ctx, state=state)
        dt = time.perf_counter() - t0
        calls["place"] += 1
        if tasks and all(len(t.inputs) <= 1 for t in tasks):
            calls["fused_shape"] += 1
            calls["fused_place_s"] += dt
        return out

    def timed_kernel(p, n_ep, n_units):
        if p["base"].device.type != "cuda":
            return k_window(p, n_ep, n_units)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = k_window(p, n_ep, n_units)
        ev[1].record()
        events.append(ev)
        return out

    def timed_window(*a, **k):
        t0 = time.perf_counter()
        out = o_window(*a, **k)
        calls["window_wrapper_s"] += time.perf_counter() - t0
        return out

    eng.flush, eng.policy.place = recorded, counted
    kernel.greedy_window, ops.greedy_window = timed_kernel, timed_window
    try:
        t0 = time.perf_counter()
        for op, *args in script:
            if op == "tick":
                eng.tick(args[0])
            elif op == "submit":
                eng.submit(args[0], when=args[1])
            elif op == "submit_many":
                eng.submit_many(args[0], when=args[1])
            else:
                eng.drain()
        wall = time.perf_counter() - t0
    finally:
        kernel.greedy_window, ops.greedy_window = k_window, o_window
    if events:
        torch.cuda.synchronize()
    summary = summary_without_clock(eng.summary())
    p50, p95 = np.percentile(lat, (50.0, 95.0)) if lat else (0.0, 0.0)
    return {
        "digests": digests, "summary": summary, "calls": calls, "wall_s": wall,
        "windows": len(digests), "placement_s": float(sum(sched_s)),
        "window_p50_s": float(np.percentile(sched_s, 50.0)),
        "window_p95_s": float(np.percentile(sched_s, 95.0)),
        "decision_p50_ms": float(p50), "decision_p95_ms": float(p95),
        "kernel_ms": float(sum(a.elapsed_time(b) for a, b in events)),
        "end": {"completed": dict(eng.completed), "wan_events": list(eng.wan_events),
                "shed": sorted(eng.shed_ids),
                "failed_permanently": sorted(eng.failed_permanently)},
    }


def summary_without_clock(summary) -> dict:
    """An ``EngineSummary`` as a dict, but its host clock."""
    import dataclasses
    d = dataclasses.asdict(summary)
    d.pop("scheduling_s")
    return d


def streaming_phase(card, kernel, ops, counters, zero_counts) -> dict:
    """Phase 3d: three streams through ``OnlineEngine`` on the card
    (``device=None``) and on the CPU (``device="cpu"``), equal window by
    window and in the end state; the window kernel launched once per
    placement call whose units are all single tasks with at most one
    input, and never otherwise."""
    out = {"card": card}
    for name in STREAMS:
        eng, script = build_stream(name, None)
        zero_counts()
        card_run = run_stream(eng, script, kernel, ops)
        counts = {k: v for c in counters for k, v in c.items()}
        eng, script = build_stream(name, "cpu")
        cpu_run = run_stream(eng, script, kernel, ops)
        launches = counts.pop("greedy_window")
        if launches != card_run["calls"]["fused_shape"] or any(counts.values()):
            raise AssertionError(
                f"stream {name}: {launches} window launches for "
                f"{card_run['calls']['fused_shape']} single-input placement calls "
                f"(other kernels {counts})")
        if card_run["windows"] != cpu_run["windows"]:
            raise AssertionError(f"stream {name}: {card_run['windows']} windows on "
                                 f"the card, {cpu_run['windows']} on the CPU")
        for i, (a, b) in enumerate(zip(card_run["digests"], cpu_run["digests"])):
            if a != b:
                raise AssertionError(f"stream {name}: window {i} on the card "
                                     f"differs from the CPU")
        for k in ("summary", "end"):
            if card_run[k] != cpu_run[k]:
                raise AssertionError(f"stream {name}: the card's {k} differs "
                                     f"from the CPU's")
        c = card_run["calls"]
        s = card_run["summary"]
        row = {
            "windows": card_run["windows"], "tasks": s["tasks"],
            "placement_calls": c["place"], "launches": launches,
            "placement_s": card_run["placement_s"],
            "window_p50_s": card_run["window_p50_s"],
            "window_p95_s": card_run["window_p95_s"],
            "decision_p50_ms": card_run["decision_p50_ms"],
            "decision_p95_ms": card_run["decision_p95_ms"],
            "fused_calls_place_s": c["fused_place_s"],
            "window_wrapper_s": c["window_wrapper_s"],
            "kernel_ms": card_run["kernel_ms"], "wall_s": card_run["wall_s"],
            "cpu_wall_s": cpu_run["wall_s"], "cpu_placement_s": cpu_run["placement_s"],
            "summary": s,
        }
        out[name] = row
        print(f"stream {name}: {row['windows']} windows, {s['tasks']} tasks placed, "
              f"{c['place']} placement calls, {launches} greedy_window launches "
              f"(= the single-input calls); card == CPU on every window's "
              f"schedule, tasks and records, the summary, completions, WAN "
              f"events, shed and failed tasks; placement {row['placement_s']:.3f} s "
              f"(a window p50 {row['window_p50_s'] * 1e3:.3f} ms, p95 "
              f"{row['window_p95_s'] * 1e3:.3f} ms; a decision p50 "
              f"{row['decision_p50_ms']:.4f} ms, p95 {row['decision_p95_ms']:.4f} ms), "
              f"of which the single-input calls {c['fused_place_s']:.3f} s, the "
              f"window wrapper {c['window_wrapper_s']:.3f} s, the kernel "
              f"{row['kernel_ms']:.3f} ms; wall {row['wall_s']:.3f} s (CPU twin "
              f"{row['cpu_wall_s']:.3f} s) [{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3e: the paper's evaluation, six scenarios replayed per policy
# ---------------------------------------------------------------------------


def load_example(name):
    """``examples/<name>.py`` as a module (the repository's ``src`` on the
    path)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod     # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def bits(x):
    """``x`` with every float as its hex string: equal bits compare equal,
    NaN included."""
    if isinstance(x, float):
        return x.hex()
    if isinstance(x, dict):
        return {k: bits(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [bits(v) for v in x]
    return x


def policy_run_digest(run) -> dict:
    """Every ``PolicyRun`` field but the host clock (``scheduling_s``) and
    the device it ran on (``engine``), floats as bits."""
    import dataclasses
    d = dataclasses.asdict(run)
    d.pop("scheduling_s")
    d.pop("engine")
    return bits(d)


def scenario_digest(scn) -> dict:
    """A scenario's tables (every row), its payload numbers and its gated
    runs, as compared between the card and the CPU."""
    return {
        "results": [(r.workload, r.n_tasks, bits(r.alpha), r.baseline,
                     [policy_run_digest(x) for x in r.rows]) for r in scn.results],
        "extra": bits(scn.extra),
        "gated": [(label, policy_run_digest(run)) for label, run, _ in scn.gated],
    }


def first_difference(a, b, path="") -> str:
    """Where two digests first differ, as a path of keys and indices."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in a.keys() | b.keys():
            if a.get(k) != b.get(k):
                return first_difference(a.get(k), b.get(k), f"{path}.{k}")
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_difference(x, y, f"{path}[{i}]")
    return f"{path}: {a!r} != {b!r}"


def evaluation_phase(card, sched, kernel, ops, counters, zero_counts) -> dict:
    """Phase 3e: the six scenarios of ``examples/torch_paper_eval.py`` at
    ``EVAL_SIZE``, every policy row and every paper gate, through
    ``run_policy``/``evaluate_trace`` on the card (``device=None``) and
    again on the CPU (``device="cpu"``), equal on every ``PolicyRun``
    field but ``scheduling_s`` and ``engine``, in every row, payload number
    and gated run.  The card's run is timed: wall seconds, placement
    seconds (every run's ``PolicyRun.scheduling_s``) split into the host
    SoA engine's calls (``_mhra_soa``), the window path's (``_mhra_fused``:
    host prep, then the window wrapper ``ops.greedy_window``, then the
    kernel, CUDA events around each launch), the window kernel's launches
    (counts zeroed just before, read just after; one per wrapper call) and
    the device's idle share of the wall time (1 - kernel time / wall; the
    kernel is the only device work of this path besides the wrapper's
    copies)."""
    import torch

    from repro_torch.core import evaluate
    pe = load_example("torch_paper_eval")
    out = {"card": card, "size": EVAL_SIZE}
    for name in pe.SCENARIOS:
        t = {"runs": 0, "placement_s": 0.0, "soa_s": 0.0, "soa_calls": 0,
             "fused_s": 0.0, "fused_calls": 0, "wrapper_s": 0.0, "wrapper_calls": 0}
        events = []
        orig = {"run_policy": evaluate.run_policy, "_mhra_soa": sched._mhra_soa,
                "_mhra_fused": sched._mhra_fused, "ops_window": ops.greedy_window,
                "kernel_window": kernel.greedy_window}

        def counted_run(*a, **k):
            res = orig["run_policy"](*a, **k)
            run = res[0] if isinstance(res, tuple) else res
            t["runs"] += 1
            t["placement_s"] += run.scheduling_s
            return res

        def host_timed(key, fn):
            def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    t[f"{key}_s"] += time.perf_counter() - t0
                    t[f"{key}_calls"] += 1
            return timed

        def timed_kernel(p, n_ep, n_units):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            res = orig["kernel_window"](p, n_ep, n_units)
            ev[1].record()
            events.append(ev)
            return res

        evaluate.run_policy = pe.run_policy = counted_run
        sched._mhra_soa = host_timed("soa", orig["_mhra_soa"])
        sched._mhra_fused = host_timed("fused", orig["_mhra_fused"])
        ops.greedy_window = host_timed("wrapper", orig["ops_window"])
        kernel.greedy_window = timed_kernel
        zero_counts()
        try:
            t0 = time.perf_counter()
            card_scn = pe.RUNNERS[name](EVAL_SIZE, None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            evaluate.run_policy = pe.run_policy = orig["run_policy"]
            sched._mhra_soa, sched._mhra_fused = orig["_mhra_soa"], orig["_mhra_fused"]
            ops.greedy_window, kernel.greedy_window = orig["ops_window"], orig["kernel_window"]
        counts = {k: v for c in counters for k, v in c.items()}
        launches = counts.pop("greedy_window")
        if launches != t["wrapper_calls"] or any(counts.values()):
            raise AssertionError(
                f"evaluation {name}: {launches} window launches for "
                f"{t['wrapper_calls']} window wrapper calls (other kernels {counts})")
        if name == "moldesign" and launches < 1:
            raise AssertionError("evaluation moldesign: no window launch")
        t0 = time.perf_counter()
        cpu_scn = pe.RUNNERS[name](EVAL_SIZE, "cpu")
        cpu_wall = time.perf_counter() - t0
        a, b = scenario_digest(card_scn), scenario_digest(cpu_scn)
        if a != b:
            raise AssertionError(f"evaluation {name}: the card differs from the "
                                 f"CPU at {first_difference(a, b)}")
        engines = {r.engine for res in card_scn.results for r in res.rows} - {"n/a"}
        if engines - {"cuda"}:
            raise AssertionError(f"evaluation {name}: rows placed on {engines}")
        kernel_ms = float(sum(x.elapsed_time(y) for x, y in events))
        rows = sum(len(res.rows) for res in card_scn.results)
        row = {
            "rows": rows, "runs": t["runs"], "launches": launches,
            "wall_s": wall, "placement_s": t["placement_s"],
            "soa_engine_s": t["soa_s"], "soa_engine_calls": t["soa_calls"],
            "fused_calls_s": t["fused_s"], "fused_calls": t["fused_calls"],
            "window_wrapper_s": t["wrapper_s"], "kernel_ms": kernel_ms,
            "idle_share": 1.0 - kernel_ms / (wall * 1e3),
            "cpu_wall_s": cpu_wall, "extra": card_scn.extra,
        }
        out[name] = row
        print(f"evaluation {name} ({EVAL_SIZE}): {rows} rows, {t['runs']} runs, card "
              f"== CPU on every PolicyRun field but scheduling_s and engine, every "
              f"payload number and gated run; every paper gate passed; "
              f"{launches} greedy_window launches; wall {wall:.3f} s (CPU twin "
              f"{cpu_wall:.3f} s); placement {t['placement_s']:.3f} s, of which the "
              f"host SoA engine {t['soa_s']:.3f} s ({t['soa_calls']} calls), the "
              f"window path {t['fused_s']:.3f} s ({t['fused_calls']} calls: window "
              f"wrapper {t['wrapper_s']:.3f} s, kernel {kernel_ms:.3f} ms); device "
              f"idle {row['idle_share']:.6f} of the wall [{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# the trainer: flash attention's backward, the reduced slice, granite at
# full width, the loss drop
# ---------------------------------------------------------------------------


def grad_errors(got, want, dt) -> dict:
    """A gradient against its plain version by the rule of ``BWD_TOL``: the
    largest |err|, the largest |err| over its element's allowance (<= 1
    passes), the elements past it, and the relative Frobenius norm."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    floor = BWD_FLOOR * float(w.pow(2).mean().sqrt())
    allowed = BWD_TOL[dt] * (w.abs() + w.pow(2).mean(-1, keepdim=True).sqrt() + floor)
    return {"max_abs": float(err.max()),
            "ratio": float((err / allowed.clamp_min(1e-30)).max()),
            "past": int((err > allowed).sum()),
            "fro": float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)),
            "finite": bool(torch.isfinite(g).all())}


def grad_ok(e, dt) -> bool:
    return e["finite"] and e["past"] == 0 and e["fro"] <= BWD_FRO_TOL[dt]


def bwd_check(fk, fr, q, k, v, do, causal, tag, card, plant=False) -> tuple[float, float]:
    """The forward's o and lse, then the backward (from the kernel
    forward's o and lse), against their plain versions on the same inputs;
    a second backward call bitwise the same.  With ``plant``, also shows
    that the check rejects dk and dv with their second half of keys 1.5
    times too large.  Returns the forward's and the backward's largest
    errors."""
    import torch
    dt = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    o, lse = fk.flash_attention(q, k, v, causal=causal, return_lse=True)
    want_o, want_lse = fr.attention_plain_lse(q, k, v, causal=causal)
    fwd_err = max(check_close(f"flash_attention o {tag}", o, want_o, TOLS[dt], card),
                  check_close(f"flash_attention lse {tag}", lse, want_lse, LSE_TOL[dt], card))
    del want_o, want_lse
    got = fk.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = fk.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = fr.attention_plain_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.equal(g, g2):
            raise AssertionError(f"flash_attention_bwd {tag}: {name} differs between calls")
        e = grad_errors(g, w, dt)
        if not grad_ok(e, dt):
            raise AssertionError(f"flash_attention_bwd {tag}: {name} disagrees with its "
                                 f"plain version: {e}")
        err = max(err, e["max_abs"])
        ratio, (fro_lo, fro_hi) = BWD_MMA_SYNC_ERRORS
        print(f"kernel flash_attention_bwd {tag} {name}: max |err| {e['max_abs']:.6g}, "
              f"at most {e['ratio']:.4g} of its allowance ({BWD_TOL[dt]} x (|want| + "
              f"row RMS + {BWD_FLOOR} x RMS)), relative Frobenius {e['fro']:.4g} <= "
              f"{BWD_FRO_TOL[dt]} (the mma.sync design's: at most {ratio} of the "
              f"allowance, Frobenius {fro_lo}-{fro_hi}), bitwise equal on a second call "
              f"[{card}]", flush=True)
        if plant and name != "dq":
            bad = g.clone()
            bad[:, bad.shape[1] // 2:] *= 1.5
            e = grad_errors(bad, w, dt)
            if grad_ok(e, dt):
                raise AssertionError(f"flash_attention_bwd {tag}: the check passed {name} "
                                     f"with its later keys planted 1.5x: {e}")
            print(f"check flash_attention_bwd {tag} {name}: the later half of the keys "
                  f"planted 1.5x is rejected ({e['past']} elements past their allowance, "
                  f"relative Frobenius {e['fro']:.4g}) [{card}]", flush=True)
            del bad
    return fwd_err, err


def flash_bwd_checks(dev, card, fk, fr) -> tuple[float, float]:
    """Phase 26a: the lse and the backward on every case of BWD_CASES."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(4)
    fwd_err = err = 0.0
    for b, sq, sk, h, kv, d, causal, dt in BWD_CASES:
        q, do = (randn(gen, (b, sq, h, d), dt, dev) for _ in range(2))
        k, v = (randn(gen, (b, sk, kv, d), dt, dev) for _ in range(2))
        tag = (f"b={b} sq={sq} sk={sk} h={h} kv={kv} d={d} "
               f"{'causal' if causal else 'non-causal'} {dt}")
        f, e = bwd_check(fk, fr, q, k, v, do, causal, tag, card)
        fwd_err, err = max(fwd_err, f), max(err, e)
    return fwd_err, err


def bwd_instance(fk, b, sq, sk, h, kv, d) -> str:
    """The kernel that does a bf16 backward's products at this shape, by
    the route ``bwd_plan`` picks."""
    import torch
    if fk.bwd_plan(b, sq, sk, h, kv, d, torch.bfloat16).route == "wgmma":
        return f"flash_bwd_sm90_bf16_kernel<{d}>"
    return f"flash_bwd_dkdv_bf16_kernel<{d}> + flash_bwd_dq_bf16_kernel<{d}>"


def flash_bwd_row(dev, card, fk, fr, b, s, h, kv, d, tag, sk=None, causal=True) -> dict:
    """Phase 26b: at (b, s, h, kv, d) against ``sk`` keys (default s),
    bf16: the checks of ``bwd_check``, then CUDA-event times of the
    forward with and without the lse and of the backward, beside the plain
    versions (one call each) and SDPA (its forward; its backward by
    ``torch.autograd.grad`` on a retained graph); the bounds of both."""
    import torch
    import torch.nn.functional as F
    sk = sk or s
    gen = torch.Generator(device=dev).manual_seed(5)
    q, do = (randn(gen, (b, s, h, d), "bfloat16", dev) for _ in range(2))
    k, v = (randn(gen, (b, sk, kv, d), "bfloat16", dev) for _ in range(2))
    shape_tag = f"b={b} s={s}" if sk == s else f"b={b} sq={s} sk={sk}"
    fwd_err, err = bwd_check(fk, fr, q, k, v, do, causal,
                             f"{tag} {shape_tag} {'' if causal else 'non-causal '}bf16",
                             card, plant=True)
    o, lse = fk.flash_attention(q, k, v, causal=causal, return_lse=True)
    plain = {}
    plain_fwd = event_ms(lambda: plain.setdefault(
        "f", fr.attention_plain_lse(q, k, v, causal=causal)))
    plain.clear()
    plain_bwd = event_ms(lambda: plain.setdefault(
        "b", fr.attention_plain_bwd(q, k, v, o, lse, do, causal=causal)))
    plain.clear()
    torch.cuda.empty_cache()
    fwd_lse = cuda_ms(lambda: fk.flash_attention(q, k, v, causal=causal, return_lse=True),
                      reps=10)
    fwd = cuda_ms(lambda: fk.flash_attention(q, k, v, causal=causal), reps=10)
    ms = cuda_ms(lambda: fk.flash_attention_bwd(q, k, v, o, lse, do, causal=causal), reps=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach(), is_causal=causal, enable_gqa=True), reps=10)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    lib = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True),
                  reps=10)
    nbytes, flops = costs.flash_bwd_bound(b, s, sk, h, kv, d, 2, causal)
    f_bytes, f_flops = costs.attention_bound(b, s, sk, h, kv, d, 2, causal)
    f_bytes += 4 * b * h * s     # the lse written
    del q, k, v, do, o, lse, qt, kt, vt, dot, out
    torch.cuda.empty_cache()
    rows = {"flash_attention_bwd": dict(ms=ms, plain_ms=plain_bwd, library_ms=lib, err=err,
                                        nbytes=nbytes, flops=flops,
                                        shape=[b, s, sk, h, kv, d], causal=causal,
                                        instance=bwd_instance(fk, b, s, sk, h, kv, d)),
            "flash_attention (lse)": dict(ms=fwd_lse, ms_without_lse=fwd, plain_ms=plain_fwd,
                                          library_ms=lib_fwd, err=fwd_err, nbytes=f_bytes,
                                          flops=f_flops, shape=[b, s, sk, h, kv, d],
                                          causal=causal)}
    bound_rows(rows, tag, card)
    print(f"time flash_attention_bwd {tag}: its SDPA is the backward alone, "
          f"torch.autograd.grad(..., retain_graph=True) through one retained "
          f"scaled_dot_product_attention graph: {lib:.6g} ms [{card}]", flush=True)
    print(f"time flash_attention {tag}: forward with the lse {fwd_lse:.6g} ms, without "
          f"{fwd:.6g} ms [{card}]", flush=True)
    return rows


def fingerprint(params) -> list:
    """Per parameter: its bits summed as integers and its values summed in
    float64: equal states give equal lists, and a changed bit changes the
    first."""
    import torch
    with torch.no_grad():
        return [(int(p.view(torch.int32).long().sum()), float(p.double().sum()))
                for p in params.parameters()]


def train_slice_check(dev, card, get_api, counters) -> dict:
    """Phase 27: the reduced granite train slice, card against CPU, from
    one float32 state: the step-1 gradients, 4 steps' losses and grad
    norms, and the state after them, within ``TRAIN_SLICE_TOL``; on the
    card 2 flash launches a layer and one backward call a layer a step."""
    return train_slice_compare(dev, card, get_api(TRAIN_ARCH, reduced=True),
                               TRAIN_SLICE_TOL, counters, 4, TRAIN_ARCH)


class Preempted(Exception):
    """Raised by a training run's ``on_step`` hook to stop it (phase 28)."""


def full_width_training(dev, card, p_train, steps_mod, adamw, fk, counters, zero_counts,
                        arch, train_kw, stop=None, model_dims=None, ranges_fn=None,
                        loss_falls=False, check=None, watch=(), stop_dims=None,
                        keep_prints=False) -> dict:
    """``arch`` trained at full width (``train_kw``: batch, seq,
    microbatches, steps and an lr; ``model_dims`` cuts the depth): on the
    card each step launches ``step_launches`` by the ``counters`` (remat's
    recompute included) and no other kernel, finite metrics (with
    ``loss_falls``, the last loss under the first), the peak under
    ``TRAIN_PEAK_LIMIT``; then one more step, traced (``ranges_fn()``
    gives its ranges and their undo; ``watch`` names kernels whose device
    time it reports), after which ``check(api, params, batch)`` runs;
    then, with ``stop``, the run stopped after step ``stop`` with its
    checkpoint and resumed, bitwise equal to the uninterrupted run (with
    ``stop_dims``, all three runs at that cut depth, which shrinks the
    checkpoint's I/O).  Flash's backward calls are counted by shape.  With
    ``keep_prints`` the result holds the parameters' ``fingerprint`` after
    the ``train_kw`` steps (``"fingerprint"``)."""
    import dataclasses
    import gc
    import shutil

    import numpy as np
    import torch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.dryrun import storage_bytes, tensors
    from repro_torch.models.registry import build_api, get_api
    api = get_api(arch)
    full_layers = api.cfg.n_layers
    if model_dims:
        api = build_api(dataclasses.replace(api.cfg, **model_dims))
    kw = dict(arch=arch, reduced=False, model_dims=model_dims, seed=0, log_every=1,
              device=None, **train_kw)
    micro, n_steps = train_kw["microbatches"], train_kw["steps"]
    want = step_launches(api.cfg, micro)
    label = arch + (f" ({api.cfg.n_layers} of {full_layers} layers)" if model_dims else "")
    frames = f" with {api.cfg.enc_len} frames" if api.cfg.family == "encdec" else ""
    per_step = []

    def count_step(i, loss, dt):
        per_step.append(launch_counts(counters))

    gc.collect()
    torch.cuda.empty_cache()
    shapes = {}
    undo = count_bwd_shapes(fk, shapes)
    try:
        zero_counts()
        t0 = time.perf_counter()
        state, losses, run = p_train.train(on_step=count_step, **kw)
        wall = time.perf_counter() - t0
    finally:
        undo()
    launches = launch_counts(counters)
    steps, peak = run["steps"], run["peak_mem_bytes"]
    zero = {k: 0 for k in launches}
    deltas = [launch_deltas(a, b) for a, b in zip(per_step, [zero] + per_step)]
    if any(d != want for d in deltas) or launch_deltas(launches, per_step[-1]):
        raise AssertionError(f"{label} training launched {deltas} a step (expected "
                             f"{want}), {launches} in all")
    if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in steps):
        raise AssertionError(f"a non-finite loss or grad norm: {steps}")
    if loss_falls and not losses[-1] < losses[0]:
        raise AssertionError(f"{label}'s loss did not fall: {losses}")
    if peak >= TRAIN_PEAK_LIMIT:
        raise AssertionError(f"{label} training peaked at {peak} B")
    n_params = api.n_params()
    for r in steps:
        print(f"train {label} full width step {r['step']}: loss {r['loss']:.6g}, ce "
              f"{r['ce']:.6g}, aux {r['aux']:.6g}, grad norm {r['grad_norm']:.6g}, lr "
              f"{r['lr']:.6g}, {r['seconds']:.6g} s, {r['tokens_per_s']:.6g} tokens/s "
              f"[{card}]", flush=True)
    print(f"train {label} ({n_params} parameters) b={train_kw['batch']} x {train_kw['seq']}"
          f"{frames} in {micro} microbatches, {n_steps} steps: wall {wall:.6g} s, peak "
          f"memory {peak} B, launches {launches} ({want} a step), the backward by shape "
          f"{shapes}; loss {losses[0]:.6g} -> {losses[-1]:.6g} [{card}]", flush=True)
    prints = fingerprint(state["params"])

    # one more step, traced
    step_fn = steps_mod.build_train_step(api, adamw.AdamWConfig(
        lr=train_kw.get("lr", 3e-3), warmup_steps=min(20, n_steps // 5 + 1),
        total_steps=n_steps), microbatches=micro)
    data = SyntheticTokens(api.cfg.vocab, train_kw["seq"], train_kw["batch"], seed=0)
    batch = {k: torch.from_numpy(v).to(dev, torch.long)
             for k, v in data.batch_at(n_steps).items()}
    batch.update(p_train.frontend_inputs(api, train_kw["batch"], 0, n_steps, dev))
    holder = {"state": state}
    del state
    # the state the card holds (params, m, v, step), as the dry-run counts it
    state_bytes = storage_bytes(tensors(holder["state"]))
    before = launch_counts(counters)

    def one_step():
        holder["state"], _ = step_fn(holder["state"], batch)

    ranges, undo = ranges_fn() if ranges_fn else ((), lambda: None)
    try:
        profile = trace(f"{label} train step (b={train_kw['batch']} x {train_kw['seq']}, "
                        f"{micro} microbatches)", one_step, card, top_n=12, ranges=ranges,
                        watch=watch)
    finally:
        undo()
    profile["launches"] = launch_deltas(launch_counts(counters), before)
    print(f"profile {label} train step: launches {profile['launches']} [{card}]",
          flush=True)
    out = {"arch": arch, "layers": api.cfg.n_layers, "n_params": n_params, **train_kw,
           "steps": steps, "wall_s": wall, "peak_mem_bytes": peak, "state_bytes": state_bytes,
           "launches": launches,
           "launches_per_step": want, "bwd_launches_by_shape": shapes, "profile": profile,
           "card": card, **({"fingerprint": prints} if keep_prints else {})}
    if check:
        out["check"] = check(api, holder["state"]["params"], batch)
    holder.clear()
    del step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    if stop is None:
        return out

    # preempted after step ``stop`` and its checkpoint, then resumed
    if stop_dims:
        kw = {**kw, "model_dims": stop_dims}
        label = f"{arch} ({stop_dims['n_layers']} of {full_layers} layers)"
        state, losses, ref_run = p_train.train(**kw)
        steps, prints = ref_run["steps"], fingerprint(state["params"])
        del state, ref_run
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    first = []

    def preempt(i, loss, dt):
        first.append(loss)
        if i + 1 == stop:
            raise Preempted

    t0 = time.perf_counter()
    # (the stopped run's state goes with the exception: two of granite's
    # states do not fit)
    try:
        p_train.train(checkpoint_dir=str(TRAIN_CKPT), checkpoint_every=stop,
                      on_step=preempt, **kw)
        raise AssertionError("the run meant to be preempted ran to its end")
    except Preempted:
        pass
    stop_wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    if first != losses[:stop]:
        raise AssertionError(f"the interrupted run's losses {first} differ from "
                             f"{losses[:stop]}")

    def drop_old(i, loss, dt):
        # one checkpoint on the disk at a time: the resumed one has been read
        if i == stop:
            for f in TRAIN_CKPT.glob(f"step_{stop:08d}.*"):
                f.unlink()

    t0 = time.perf_counter()
    resumed, rest, r_run = p_train.train(checkpoint_dir=str(TRAIN_CKPT), resume=True,
                                         on_step=drop_old, **kw)
    resume_wall = time.perf_counter() - t0
    same = (rest == losses[stop:]
            and [r["grad_norm"] for r in r_run["steps"]]
            == [r["grad_norm"] for r in steps[stop:]]
            and fingerprint(resumed["params"]) == prints)
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    if not same:
        raise AssertionError(f"the resumed run differs from the uninterrupted one: losses "
                             f"{rest} against {losses[stop:]}")
    print(f"train {label} stopped at step {stop} with a checkpoint ({stop_wall:.6g} s) and "
          f"resumed to step {n_steps} ({resume_wall:.6g} s): losses, grad norms and every "
          f"parameter's bits equal the uninterrupted run's [{card}]", flush=True)
    return {**out, "stopped_run_wall_s": stop_wall, "resumed_run_wall_s": resume_wall,
            "resume_layers": kw["model_dims"]["n_layers"] if kw["model_dims"]
            else full_layers, "resume_equal": same}


def train_loss_drop(card, p_train) -> dict:
    """Phase 29: the reduced trainer on the card, 30 steps at b=8 x 64, lr
    5e-3: the loss falls by more than 0.3 (``test_loss_decreases_training``)."""
    _, losses, _ = p_train.train(arch=TRAIN_ARCH, reduced=True, steps=30, batch=8,
                                 seq=64, lr=5e-3, log_every=1000, device=None)
    if not losses[-1] < losses[0] - 0.3:
        raise AssertionError(f"reduced training on the card: loss {losses[0]} -> {losses[-1]}")
    print(f"train reduced {TRAIN_ARCH} 30 steps on the card: loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g} [{card}]", flush=True)
    return {"first": losses[0], "last": losses[-1]}


# ---------------------------------------------------------------------------
# the MoE, VLM and enc-dec trainers: the reduced slices, whisper-tiny at
# full width, moonshot and internvl2 at full width and cut depth
# ---------------------------------------------------------------------------


def n_attentions(cfg) -> int:
    """Flash attention calls in one forward: one an attention layer, two
    (self and cross) an enc-dec decoder layer, one a zamba2 group (its
    shared block), none in falcon-mamba."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def step_launches(cfg, micro=1) -> dict:
    """The kernel launches of one train step over ``micro`` microbatches,
    remat on, by counter name (every other counter 0): flash's forward
    twice an attention (the forward, the recompute) and its backward once;
    the fused Mamba1 scan twice a layer and its backward once; the SSD
    three times a layer but twice for the last layer of each zamba2 group
    (the group's recompute stops after its last layer's input, PyTorch's
    non-reentrant checkpoint stopping early) and its backward once."""
    n_att = n_attentions(cfg)
    want = {"flash_attention": 2 * n_att, "flash_attention_bwd": n_att}
    if cfg.family == "hybrid":
        want.update(ssd=3 * cfg.n_layers - n_att, ssd_bwd=cfg.n_layers)
    if cfg.family == "ssm":
        want.update(mamba1_scan_fused=2 * cfg.n_layers, mamba1_scan_bwd=cfg.n_layers)
    return {k: v * micro for k, v in want.items() if v}


def launch_counts(counters) -> dict:
    """Every counter's launches so far, by name (the names are distinct)."""
    return {k: v for c in counters for k, v in c.items()}


def launch_deltas(after, before) -> dict:
    """The counters that moved between two ``launch_counts``."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def slice_batches(cfg, n, rows=4, seq=128) -> list:
    """n batches of rows x seq tokens and their next tokens from numpy seed
    0, then each batch's frontend input (a VLM's vision embeddings, an
    enc-dec's frames), standard normal in bf16, from the same generator (the
    CPU tests' draws)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (n, rows, seq + 1))
    out = [{"tokens": torch.from_numpy(t[:, :-1]), "labels": torch.from_numpy(t[:, 1:])}
           for t in toks]
    key = {"vlm": "vision_embeds", "encdec": "frames"}.get(cfg.family)
    if key:
        n_rows = cfg.n_vision_tokens if cfg.family == "vlm" else cfg.enc_len
        for b in out:
            b[key] = torch.from_numpy(rng.standard_normal(
                (rows, n_rows, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    return out


def state_to(state, where) -> dict:
    """A copy of a train state on ``where``."""
    import copy
    return {"params": copy.deepcopy(state["params"]).to(where),
            "opt": {"m": {n: t.clone().to(where) for n, t in state["opt"]["m"].items()},
                    "v": {n: t.clone().to(where) for n, t in state["opt"]["v"].items()},
                    "step": state["opt"]["step"].clone().to(where)}}


def state_numbers(state) -> dict:
    return {"params": {n: p.detach().cpu() for n, p in state["params"].named_parameters()},
            "m": {n: t.cpu() for n, t in state["opt"]["m"].items()},
            "v": {n: t.cpu() for n, t in state["opt"]["v"].items()}}


def train_slice_compare(dev, card, api, tol, counters, n_steps, label,
                        last_from_cpu=False, steps_from_cpu=False) -> dict:
    """A reduced train slice, card against CPU, from one float32 state
    (``api.init(0)``) on ``slice_batches``: the step-1 gradients, every
    step's loss and grad norm, and the state after the steps within
    ``tol``; on the card each step launches ``step_launches`` by the
    ``counters`` (the kernels' ``LAUNCHES``) and nothing else.  With
    ``last_from_cpu`` the state is held after the card's last step from
    the CPU's state before it; with ``steps_from_cpu`` every card step
    starts from the CPU's state before it, so each step's loss, grad norm
    and (after the last) state are held without the free-running runs'
    drift."""
    import numpy as np
    import torch
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    want = step_launches(api.cfg)
    data = slice_batches(api.cfg, n_steps)
    runs = {}
    cpu_in = []   # the CPU's state before each step
    for run, where in (("cpu", "cpu"), ("card", dev)):
        params = api.init(0, "cpu", dtype=torch.float32, trainable=True).to(where)
        state = {"params": params, "opt": init_opt_state(params)}
        batches = [{k: v.to(where) for k, v in b.items()} for b in data]
        loss, _ = api.loss(params, batches[0], remat=True)
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        step = build_train_step(api, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8))
        metrics = []
        for i, b in enumerate(batches):
            if run == "cpu":
                cpu_in.append(state_to(state, "cpu"))
            elif steps_from_cpu and i:
                state = state_to(cpu_in[i], where)
            before = launch_counts(counters)
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
            if run == "card":
                got = launch_deltas(launch_counts(counters), before)
                if got != want:
                    raise AssertionError(f"a reduced {label} train step launched {got}, "
                                         f"expected {want}")
        runs[run] = {"grads": grads, "metrics": metrics, **state_numbers(state)}
        del state, params
    cpu, card_run = runs["cpu"], runs["card"]
    if last_from_cpu:
        state, _ = build_train_step(api, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8))(
            state_to(cpu_in[-1], dev), {k: v.to(dev) for k, v in data[-1].items()})
        card_run.update(state_numbers(state))
        del state

    def largest(what):
        return max(float((card_run[what][n] - cpu[what][n]).abs().max()) for n in cpu[what])

    num = sum(float(((card_run["grads"][n] - cpu["grads"][n]) ** 2).sum())
              for n in cpu["grads"])
    den = sum(float((cpu["grads"][n] ** 2).sum()) for n in cpu["grads"])
    errs = {
        "loss": max(abs(a["loss"] - b["loss"]) for a, b in zip(card_run["metrics"],
                                                               cpu["metrics"])),
        "grad_norm": max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                         for a, b in zip(card_run["metrics"], cpu["metrics"])),
        "grads_rel": (num / den) ** 0.5, "grads_max": largest("grads"),
        "params": largest("params"), "m": largest("m"), "v": largest("v")}
    finite = all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in card_run["metrics"])
    bad = {k: (e, tol[k]) for k, e in errs.items() if not e <= tol[k]}
    if bad or not finite:
        raise AssertionError(f"reduced {label} training on the card differs from the "
                             f"CPU: {bad} (finite {finite})")
    print(f"slice reduced {label} train b=4 x 128, {n_steps} steps"
          f"{' (the state after the last step from the CPU state)' if last_from_cpu else ''}"
          f"{' (each step from the CPU state before it)' if steps_from_cpu else ''}"
          ": card vs CPU " + ", ".join(f"{k} {e:.6g} (bound {tol[k]})"
                                       for k, e in errs.items())
          + f"; losses card {[round(m['loss'], 6) for m in card_run['metrics']]} [{card}]",
          flush=True)
    return {"errors": errs, "card_losses": [m["loss"] for m in card_run["metrics"]],
            "cpu_losses": [m["loss"] for m in cpu["metrics"]]}


def slice_drift(dev, card, api, fk, fr, n_steps=3) -> dict:
    """Phase 34b, printed and not held: reduced falcon-mamba's free-running
    steps (``slice_batches``, one float32 state) on the CPU, on the card
    through the fused scan's backward kernel, and on the card with its
    plain backward in the kernel's place: each card run's grad norms
    against the CPU's, step by step.  Where the plain backward drifts as
    far, the drift is the card's rounding, not the kernel."""
    import torch
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    data = slice_batches(api.cfg, n_steps)
    kernel_bwd = fk.mamba1_scan_fused_bwd
    norms = {}
    for run, where in (("cpu", "cpu"), ("kernels", dev), ("plain backward", dev)):
        if run == "plain backward":
            fk.mamba1_scan_fused_bwd = fr.mamba1_scan_fused_plain_bwd
        try:
            params = api.init(0, "cpu", dtype=torch.float32, trainable=True).to(where)
            state = {"params": params, "opt": init_opt_state(params)}
            step = build_train_step(api, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8))
            norms[run] = []
            for b in data:
                state, m = step(state, {k: v.to(where) for k, v in b.items()})
                norms[run].append(float(m["grad_norm"]))
        finally:
            fk.mamba1_scan_fused_bwd = kernel_bwd
        del state, params
    drift = {run: [abs(a - c) / c for a, c in zip(norms[run], norms["cpu"])]
             for run in ("kernels", "plain backward")}
    print(f"slice reduced {api.cfg.name} free-running {n_steps} steps, grad norms against "
          f"the CPU's {norms['cpu']}: "
          + "; ".join(f"{run} {[round(x, 6) for x in norms[run]]}, relative drift "
                      f"{[f'{x:.4g}' for x in drift[run]]}" for run in drift)
          + f" (not held) [{card}]", flush=True)
    return {"grad_norms": norms, "drift": drift}


def whisper_full_check(dev, card, api, fk, flash_counts) -> dict:
    """Phase 30b: whisper-tiny at full width, one train step at b=2 x 448
    with 1,500 frames (``slice_batches``'s draws) from one float32 state,
    card against CPU: the loss and the grad norm within
    ``WHISPER_FULL_TOL``, every parameter finite after the step; on the
    card every attention's backward takes the wgmma route, 24 flash
    launches and 12 backward calls."""
    import math

    import torch
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    cfg = api.cfg
    b, s = 2, 448
    for sq, sk, causal in ((cfg.enc_len, cfg.enc_len, False), (s, s, True),
                           (s, cfg.enc_len, False)):
        route = fk.bwd_plan(b, sq, sk, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            torch.bfloat16, causal).route
        if route != "wgmma":
            raise AssertionError(f"whisper's ({sq}, {sk}) backward takes the {route} route")
    batch = slice_batches(cfg, 1, rows=b, seq=s)[0]
    n_att = n_attentions(cfg)
    got = {}
    for run, where in (("cpu", "cpu"), ("card", dev)):
        params = api.init(0, "cpu", dtype=torch.float32, trainable=True).to(where)
        state = {"params": params, "opt": init_opt_state(params)}
        before = dict(flash_counts)
        t0 = time.perf_counter()
        state, m = build_train_step(api, AdamWConfig(lr=1e-3))(
            state, {k: v.to(where) for k, v in batch.items()})
        got[run] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "seconds": time.perf_counter() - t0,
                    "finite": all(bool(torch.isfinite(p).all())
                                  for p in state["params"].parameters())}
        if run == "card":
            launches = (flash_counts["flash_attention"] - before["flash_attention"],
                        flash_counts["flash_attention_bwd"] - before["flash_attention_bwd"])
            if launches != (2 * n_att, n_att):
                raise AssertionError(f"whisper's full-width step launched {launches} flash "
                                     f"forward / backward, expected {(2 * n_att, n_att)}")
        del state, params
    errs = {"loss": abs(got["card"]["loss"] - got["cpu"]["loss"]),
            "grad_norm": abs(got["card"]["grad_norm"] - got["cpu"]["grad_norm"])
            / got["cpu"]["grad_norm"]}
    bad = {k: (e, WHISPER_FULL_TOL[k]) for k, e in errs.items() if not e <= WHISPER_FULL_TOL[k]}
    if bad or not (got["card"]["finite"] and math.isfinite(got["card"]["loss"])):
        raise AssertionError(f"whisper-tiny's full-width train step on the card differs from "
                             f"the CPU: {bad}, {got}")
    print(f"slice {WHISPER} full width train step b={b} x {s}, {cfg.enc_len} frames: card vs "
          f"CPU loss {errs['loss']:.6g} (bound {WHISPER_FULL_TOL['loss']}), grad norm "
          f"{errs['grad_norm']:.6g} (bound {WHISPER_FULL_TOL['grad_norm']}); card loss "
          f"{got['card']['loss']:.6g}, grad norm {got['card']['grad_norm']:.6g}; the CPU step "
          f"{got['cpu']['seconds']:.6g} s [{card}]", flush=True)
    return {"errors": errs, "card": got["card"], "cpu": got["cpu"]}


def count_bwd_shapes(fk, tally):
    """Wrap ``fk.flash_attention_bwd`` to count its calls by (sq, sk,
    causal) in ``tally``; returns the wrapper's undo."""
    orig = fk.flash_attention_bwd

    def counted(q, k, v, o, lse, do, *, causal=True):
        key = f"{q.shape[1]}x{k.shape[1]}{'' if causal else ' non-causal'}"
        tally[key] = tally.get(key, 0) + 1
        return orig(q, k, v, o, lse, do, causal=causal)

    fk.flash_attention_bwd = counted

    def undo():
        fk.flash_attention_bwd = orig
    return undo


def moe_backward_ranges(moe):
    """Wrap the MoE's four parts (router, dispatch loop, expert products,
    combine) so that each runs in a ``record_function`` range of its name
    (``moe.router``, ...; the forward and remat's recompute) and its
    backward in ``<name>.backward``: an identity autograd function on the
    part's outputs opens the range when their gradients arrive, after it
    has unpacked a saved tensor (which runs a checkpointed layer's
    recompute first, outside the range), and one on its inputs closes it.
    Returns (the range names, the wrappers' undo)."""
    import torch
    from torch.profiler import record_function

    class Open(torch.autograd.Function):
        @staticmethod
        def forward(ctx, box, *ts):
            ctx.box = box
            ctx.save_for_backward(ts[0])
            return tuple(t.view_as(t) for t in ts)

        @staticmethod
        def backward(ctx, *gs):
            ctx.saved_tensors    # the recompute, if this layer's is pending
            ctx.box["range"] = record_function(ctx.box["name"] + ".backward")
            ctx.box["range"].__enter__()
            return (None,) + gs

    class Close(torch.autograd.Function):
        @staticmethod
        def forward(ctx, box, *ts):
            ctx.box = box
            return tuple(t.view_as(t) for t in ts)

        @staticmethod
        def backward(ctx, *gs):
            rng = ctx.box.pop("range", None)
            if rng is not None:
                rng.__exit__(None, None, None)
            return (None,) + gs

    def router(p, x, cfg, group_size):
        box = {"name": "moe.router"}
        with record_function(box["name"]):
            (x,) = Close.apply(box, x)
            r = orig["_router"](p, x, cfg, group_size)
            r["xg"], r["topv"], r["aux"] = Open.apply(box, r["xg"], r["topv"], r["aux"])
        return r

    def dispatch(topi, topv, e, cap, dt):
        box = {"name": "moe.dispatch"}
        with record_function(box["name"]):
            (topv,) = Close.apply(box, topv)
            d, c = orig["_dispatch"](topi, topv, e, cap, dt)
            (c,) = Open.apply(box, c)
        return d, c

    def experts(p, dispatch, xg):
        box = {"name": "moe.experts"}
        with record_function(box["name"]):
            (xg,) = Close.apply(box, xg)
            (ye,) = Open.apply(box, orig["_experts"](p, dispatch, xg))
        return ye

    def combine(c, ye):
        box = {"name": "moe.combine"}
        with record_function(box["name"]):
            c, ye = Close.apply(box, c, ye)
            (out,) = Open.apply(box, orig["_combine"](c, ye))
        return out

    wrappers = {"_router": router, "_dispatch": dispatch, "_experts": experts,
                "_combine": combine}
    orig = {name: getattr(moe, name) for name in wrappers}
    for name, fn in wrappers.items():
        setattr(moe, name, fn)

    def undo():
        for name, fn in orig.items():
            setattr(moe, name, fn)

    parts = ("moe.router", "moe.dispatch", "moe.experts", "moe.combine")
    return parts + tuple(p + ".backward" for p in parts), undo


def moe_recompute_routes(moe, card, api, params, batch, rows=2) -> dict:
    """Under remat each MoE layer's router runs twice: the forward, then
    the recompute in the backward (the last layer first).  On ``rows`` of
    ``batch`` every layer's recomputed top-k experts must equal its
    forward's bitwise; the gradients this leaves are dropped."""
    import torch
    seen = []
    orig = moe._router

    def record(*a, **kw):
        r = orig(*a, **kw)
        seen.append(r["topi"].detach().clone())
        return r

    moe._router = record
    try:
        loss, _ = api.loss(params, {k: v[:rows] for k, v in batch.items()}, remat=True)
        loss.backward()
    finally:
        moe._router = orig
        for p in params.parameters():
            p.grad = None
    n = api.cfg.n_layers
    if len(seen) != 2 * n:
        raise AssertionError(f"{n} MoE layers routed {len(seen)} times under remat")
    differ = [li for li in range(n) if not torch.equal(seen[li], seen[2 * n - 1 - li])]
    if differ:
        raise AssertionError(f"{api.cfg.name}: the recompute routed layers {differ} "
                             f"differently from the forward")
    print(f"check {api.cfg.name} ({n} layers) remat on {rows} x {batch['tokens'].shape[1]} "
          f"tokens: each layer's recomputed top-{api.cfg.top_k} experts equal the forward's "
          f"bitwise ({seen[0].numel()} routes a layer) [{card}]", flush=True)
    return {"layers": n, "routes_per_layer": seen[0].numel(), "recompute_equal": True}


def grad_group(name: str) -> str:
    """An enc-dec parameter's group: the encoder's attention, the
    decoder's self attention, its cross attention's q/o and k/v
    projections (the k/v from the encoder output), the rest."""
    if name.startswith("enc_layers.") and ".attn." in name:
        return "encoder attention"
    if ".self_attn." in name:
        return "decoder self attention"
    if ".cross_attn.w" in name:
        return ("decoder cross attention k/v" if name[-2:] in ("wk", "wv")
                else "decoder cross attention q/o")
    return "the rest"


def group_errors(got, want) -> dict:
    """{group: (relative Frobenius norm of got - want over its leaves,
    largest |got - want|)} of two {name: tensor} maps."""
    num, den, big = {}, {}, {}
    for n, w in want.items():
        g = grad_group(n)
        d = (got[n].double() - w.double())
        num[g] = num.get(g, 0.0) + float((d ** 2).sum())
        den[g] = den.get(g, 0.0) + float((w.double() ** 2).sum())
        big[g] = max(big.get(g, 0.0), float(d.abs().max()))
    return {g: ((num[g] / den[g]) ** 0.5, big[g]) for g in num}


def whisper_f32_gradients(dev, card, api, fk, fr, lm_mod, encdec_mod, b=2, s=448) -> dict:
    """Phase 30c: whisper-tiny at full width in float32 (both modules'
    compute dtype), the loss's gradient at b=2 x 448 with 1,500 frames
    (``slice_batches``'s draws) from one state: on the card through the
    flash kernels (their f32 route: 24 launches, 12 backward calls) and
    through the plain attention (``fr``, the rest of the model the same),
    and on the CPU in float32 and in float64.  Each group of leaves
    (``grad_group``) of the kernels' gradient must lie within the plain
    attention's by less than the CPU's float32 gradient lies from its
    float64 one: the kernels and their wrappers move the card's gradient
    by less than float32 arithmetic does.  The card against the CPU is
    printed, not held: at this width the gradient is ill-conditioned (the
    CPU's own float32 lies percents from its float64), and the card's
    float32 ops land farther from the CPU's still, with the plain
    attention as with the kernels."""
    import torch
    cfg = api.cfg
    for sq, sk, causal in ((cfg.enc_len, cfg.enc_len, False), (s, s, True),
                           (s, cfg.enc_len, False)):
        route = fk.bwd_plan(b, sq, sk, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            torch.float32, causal).route
        if route != "f32":
            raise AssertionError(f"whisper's float32 ({sq}, {sk}) backward takes the "
                                 f"{route} route")
    batch = slice_batches(cfg, 1, rows=b, seq=s)[0]
    n_att = n_attentions(cfg)
    flash_counts = fk.LAUNCHES
    kernels = (fk.flash_attention, fk.flash_attention_bwd)
    dtypes = (lm_mod.COMPUTE_DTYPE, encdec_mod.COMPUTE_DTYPE)

    def plain_fwd(q, k, v, *, causal=True, return_lse=False):
        return (fr.attention_plain_lse if return_lse else fr.attention_plain)(
            q, k, v, causal=causal)

    def gradient(where, dt, plain=False):
        lm_mod.COMPUTE_DTYPE = encdec_mod.COMPUTE_DTYPE = dt
        if plain:
            fk.flash_attention, fk.flash_attention_bwd = plain_fwd, fr.attention_plain_bwd
        try:
            params = api.init(0, "cpu", dtype=torch.float32, trainable=True).to(dt).to(where)
            loss, _ = api.loss(params, {k: v.to(where) for k, v in batch.items()},
                               remat=True)
            loss.backward()
            return float(loss.detach()), {n: p.grad.cpu() for n, p in
                                          params.named_parameters()}
        finally:
            fk.flash_attention, fk.flash_attention_bwd = kernels
            lm_mod.COMPUTE_DTYPE, encdec_mod.COMPUTE_DTYPE = dtypes

    before = dict(flash_counts)
    runs = {"kernels": gradient(dev, torch.float32)}
    got = (flash_counts["flash_attention"] - before["flash_attention"],
           flash_counts["flash_attention_bwd"] - before["flash_attention_bwd"])
    if got != (2 * n_att, n_att):
        raise AssertionError(f"whisper's float32 gradient launched {got} flash forward / "
                             f"backward, expected {(2 * n_att, n_att)}")
    runs["plain"] = gradient(dev, torch.float32, plain=True)
    runs["cpu f32"] = gradient("cpu", torch.float32)
    runs["cpu f64"] = gradient("cpu", torch.float64)
    errs = group_errors(runs["kernels"][1], runs["plain"][1])
    spread = group_errors(runs["cpu f32"][1], runs["cpu f64"][1])
    vs_cpu = {k: group_errors(runs[k][1], runs["cpu f32"][1]) for k in ("kernels", "plain")}
    bad = {g: (e[0], spread[g][0]) for g, e in errs.items() if not e[0] < spread[g][0]}
    finite = all(bool(torch.isfinite(t).all()) for t in runs["kernels"][1].values())
    if bad or not finite:
        raise AssertionError(f"whisper-tiny's float32 gradient through the kernels differs "
                             f"from the plain attention's by more than the CPU's float32 "
                             f"from its float64: {bad} (finite {finite})")
    print(f"slice {WHISPER} full width float32 gradient b={b} x {s}, {cfg.enc_len} frames: "
          f"kernels vs plain attention on the card, relative Frobenius per group (bound: the "
          f"CPU's float32 vs float64) " + ", ".join(
              f"{g} {e[0]:.6g} ({spread[g][0]:.6g})" for g, e in errs.items())
          + "; the card (kernels / plain attention) vs the CPU's float32 (not held) "
          + ", ".join(f"{g} {e[0]:.6g} / {vs_cpu['plain'][g][0]:.6g}"
                      for g, e in vs_cpu["kernels"].items())
          + f"; losses {', '.join(f'{k} {v[0]:.9g}' for k, v in runs.items())} [{card}]",
          flush=True)
    return {"loss": {k: v[0] for k, v in runs.items()},
            "kernels_vs_plain": {g: e[0] for g, e in errs.items()},
            "cpu_f32_vs_f64": {g: e[0] for g, e in spread.items()},
            "card_vs_cpu_f32": {k: {g: e[0] for g, e in v.items()}
                                for k, v in vs_cpu.items()}}


# ---------------------------------------------------------------------------
# the hybrid and ssm trainers: the SSD's and the fused scan's backward
# kernels, the reduced slices, zamba2 and falcon-mamba at full width
# ---------------------------------------------------------------------------


# the backward kernels against their plain versions (phase 33).  SSD: (b, L,
# nh, hd, n, dS given): ragged lengths against the kernel's chunk, state 8,
# 16 and 64, the widest head and state (its smaller chunk), one token.
# Then the edges of its head groups and chunk-parallel states: head counts
# that leave a smaller last group of 8 (12, 20, 9), many chunks with a
# ragged tail, state and head_dim 128 (chunk 32), and widths whose rows are
# not 16-byte vectors (state 5, head_dim 20 and 7).
SSD_BWD_CASES = [(2, 300, 4, 64, 64, True), (1, 100, 3, 16, 8, True),
                 (2, 77, 5, 32, 16, False), (1, 130, 2, 128, 128, True),
                 (2, 1, 4, 64, 64, True), (1, 1000, 8, 64, 64, False),
                 (1, 1000, 12, 64, 64, True), (2, 777, 20, 32, 16, False),
                 (1, 300, 9, 128, 128, True), (1, 150, 9, 20, 5, True),
                 (1, 70, 3, 7, 3, False)]
# the fused scan: (b, L, d, n): d not a multiple of the 64-channel CTA,
# ragged lengths against the 16-token chunk, state 8, 16 and 64, one token;
# then lengths over several 512-token segments with a ragged last chunk, at
# state 16, 64 (4-token chunks) and 32 (8-token chunks), and d = 100, whose
# rows (and z's, at an offset of d) are not 16-byte vectors
SCAN_BWD_CASES = [(2, 100, 72, 16), (1, 64, 128, 8), (2, 33, 200, 64), (1, 1, 8, 4),
                  (1, 500, 520, 16), (1, 1100, 200, 16), (2, 600, 136, 64),
                  (1, 520, 72, 32), (1, 300, 100, 16)]
# zamba2's microbatch (b=2 of the trainer's 8 x 4,096 in 4) and
# falcon-mamba's, timed
SSD_BWD_TIMED = (2, 4096, 80, 64, 64)
SCAN_BWD_TIMED = (2, 4096, 8192, 16)
# flash attention at zamba2-2.7b's training microbatch (b, s, h, kv, d):
# its shared attention block, 32 heads of 80, causal, bf16
SSM_FLASH_TIMED = {"zamba2-2.7b": (2, 4096, 32, 32, 80)}
# the SSD backward's kernels that run its products on the tensor cores and
# stage their operands by cp.async (<..., 64>: zamba2's widths, fixed at
# compile time; <..., 0>: any widths)
SSD_BWD_TC_KERNELS = ("ssd_bwd_local_kernel<0>", "ssd_bwd_local_kernel<64>",
                      "ssd_bwd_chunk_kernel<1, 0>", "ssd_bwd_chunk_kernel<2, 0>",
                      "ssd_bwd_chunk_kernel<1, 64>")
# each gradient element within rtol (|want| + RMS(want)) of the plain
# backward: both sides add in f32 in other orders (the SSD's kernel in
# chunks, its plain version token by token; the scan's exp is ex2.approx);
# the scan's bf16 gradients also one bf16 ulp (2^-7 of the value) apart
# where the two round on either side of a boundary
SSM_BWD_RTOL = 1e-3
BF16_ULP = 2.0 ** -7


def ssm_grad_errors(got, want) -> dict:
    """Per gradient: the largest |got - want| over its bound
    (``SSM_BWD_RTOL`` (|want| + RMS(want)), plus a bf16 ulp of |want| for
    bf16 gradients), and the largest |got - want|.  Ratios above 1 fail."""
    import torch
    out = {}
    for name, g in got.items():
        w = want[name].double()
        e = (g.double() - w).abs()
        rms = float(w.pow(2).mean().sqrt()) if w.numel() else 0.0
        bound = SSM_BWD_RTOL * (w.abs() + rms)
        if g.dtype == torch.bfloat16:
            bound = bound + BF16_ULP * w.abs()
        finite = bool(torch.isfinite(g).all())
        out[name] = {"ratio": float((e / bound.clamp_min(1e-30)).max()) if finite
                     else float("inf"), "max_abs_err": float(e.max()) if finite else
                     float("inf")}
    return out


def ssd_bwd_case(gen, dev, b, L, nh, hd, n, with_dS):
    """Seeded inputs of the SSD's gradient: the trainer's pre-weighted
    forms (xdt = x dt, loga = dt A with dt a softplus), dy standard normal
    and dS where given."""
    import torch
    x = torch.randn((b, L, nh, hd), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, L, nh), generator=gen, device=dev) * 0.5)
    A = -torch.exp(torch.randn((nh,), generator=gen, device=dev) * 0.3)
    B = torch.randn((b, L, n), generator=gen, device=dev)
    C = torch.randn((b, L, n), generator=gen, device=dev)
    dy = torch.randn((b, L, nh, hd), generator=gen, device=dev)
    dS = torch.randn((b, nh, n, hd), generator=gen, device=dev) if with_dS else None
    return (x * dt[..., None], dt * A, B, C, dy, dS)


def scan_bwd_case(gen, dev, b, L, d, n, r=8):
    """The fused scan's inputs as the block leaves them (strided z, B and
    C) and a bf16 dy."""
    import torch
    args = fused_scan_inputs(gen, b, L, d, n, r, dev)
    dy = torch.randn((b, L, d), generator=gen, device=dev).to(torch.bfloat16)
    return args, dy


SSD_GRADS = ("dxdt", "dloga", "dB", "dC")
SCAN_GRADS = ("dxc", "ddt_raw", "ddt_b", "dA", "dB", "dC", "dD", "dz")


def ssm_bwd_check(label, run, plain, names, card, plant=None) -> float:
    """``run()`` (the kernel) against ``plain()`` (its plain version) by
    ``ssm_grad_errors``, a second call bitwise equal to the first; with
    ``plant`` = (gradient, index), that gradient's later half scaled by
    1.01 must fail the check.  Returns the largest ratio and the largest
    |got - want|."""
    import torch
    got = dict(zip(names, run()))
    again = dict(zip(names, run()))
    want = dict(zip(names, plain()))
    torch.cuda.synchronize()
    if not all(bits_equal(got[k], again[k]) for k in names):
        raise AssertionError(f"{label}: two calls differ")
    errs = ssm_grad_errors(got, want)
    worst = max(e["ratio"] for e in errs.values())
    if not worst <= 1.0:
        raise AssertionError(f"{label}: the kernel disagrees with its plain backward: "
                             f"{errs}")
    if plant:
        bad = dict(got)
        t = bad[plant].clone()
        flat = t.view(-1)
        flat[flat.numel() // 2:] *= 1.01
        bad[plant] = t
        if max(e["ratio"] for e in ssm_grad_errors(bad, want).values()) <= 1.0:
            raise AssertionError(f"{label}: a 1% error planted in {plant} passed")
    print(f"kernel {label}: largest error over its bound {worst:.4g} ("
          + ", ".join(f"{k} {e['ratio']:.3g} ({e['max_abs_err']:.3g})"
                      for k, e in errs.items())
          + "), a second call bitwise equal"
          + (f"; a 1% error planted in {plant} caught" if plant else "") + f" [{card}]",
          flush=True)
    return worst, max(e["max_abs_err"] for e in errs.values())


def ssm_bwd_checks(dev, card, sk, sr, fk, fr) -> dict:
    """Phase 33: the SSD's backward kernel (``sk.ssd_bwd``) and the fused
    scan's (``fk.mamba1_scan_fused_bwd``) against their plain versions on
    ``SSD_BWD_CASES`` and ``SCAN_BWD_CASES``, then each at its timed shape:
    checked (a 1% error planted in the SSD's dxdt and the scan's dB must
    be caught), timed beside the plain version and the bound.  Returns the
    two kernel rows."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(33)
    worst = {"ssd_bwd": (0.0, 0.0), "mamba1_scan_bwd": (0.0, 0.0)}

    def keep(name, res):
        worst[name] = tuple(max(x, y) for x, y in zip(worst[name], res))

    for b, L, nh, hd, n, with_dS in SSD_BWD_CASES:
        a = ssd_bwd_case(gen, dev, b, L, nh, hd, n, with_dS)
        keep("ssd_bwd", ssm_bwd_check(
            f"ssd_bwd b={b} L={L} nh={nh} hd={hd} n={n} dS={with_dS}",
            lambda: sk.ssd_bwd(*a), lambda: sr.ssd_plain_bwd(*a), SSD_GRADS, card))
    for b, L, d, n in SCAN_BWD_CASES:
        args, dy = scan_bwd_case(gen, dev, b, L, d, n)
        keep("mamba1_scan_bwd", ssm_bwd_check(
            f"mamba1_scan_bwd b={b} L={L} d={d} n={n}",
            lambda: fk.mamba1_scan_fused_bwd(*args, dy),
            lambda: fr.mamba1_scan_fused_plain_bwd(*args, dy), SCAN_GRADS, card))
    rows = {}
    b, L, nh, hd, n = SSD_BWD_TIMED
    a = ssd_bwd_case(gen, dev, b, L, nh, hd, n, False)
    keep("ssd_bwd", ssm_bwd_check(
        f"ssd_bwd at zamba2's microbatch b={b} L={L} nh={nh} hd={hd} n={n}",
        lambda: sk.ssd_bwd(*a), lambda: sr.ssd_plain_bwd(*a), SSD_GRADS, card,
        plant="dxdt"))
    ms = cuda_ms(lambda: sk.ssd_bwd(*a), reps=5)
    fwd_ms = cuda_ms(lambda: sk.ssd(*a[:4]), reps=5)
    plain = event_ms(lambda: sr.ssd_plain_bwd(*a))
    bound = costs.ssd_bwd_bound_ms(b, L, nh, hd, n)
    rows["ssd_bwd"] = dict(bound, shape=[b, L, nh, hd, n], ms=ms, forward_ms=fwd_ms,
                           plain_ms=plain, library_ms=None, err=worst["ssd_bwd"][0],
                           max_abs_err=worst["ssd_bwd"][1])
    print(f"time ssd_bwd b={b} L={L} nh={nh} hd={hd} n={n}: kernel {ms:.6g} ms (the "
          f"forward kernel {fwd_ms:.6g} ms), plain backward {plain:.6g} ms, library call "
          f"none, bound {bound['bound_ms']:.6g} ms by {bound['bound_by']} "
          f"({bound['nbytes']} B take {bound['t_bytes']:.6g} ms; the operations "
          f"{bound['t_ops']:.6g} ms as {bound['ops_form']}); "
          f"{bound['bound_ms'] / ms:.4f} of its bound [{card}]", flush=True)
    del a
    b, L, d, n = SCAN_BWD_TIMED
    args, dy = scan_bwd_case(gen, dev, b, L, d, n, r=256)
    keep("mamba1_scan_bwd", ssm_bwd_check(
        f"mamba1_scan_bwd at falcon-mamba's microbatch b={b} L={L} d={d} n={n}",
        lambda: fk.mamba1_scan_fused_bwd(*args, dy),
        lambda: fr.mamba1_scan_fused_plain_bwd(*args, dy), SCAN_GRADS, card, plant="dB"))
    ms = cuda_ms(lambda: fk.mamba1_scan_fused_bwd(*args, dy), reps=5)
    fwd_ms = cuda_ms(lambda: fk.mamba1_scan_fused(*args), reps=5)
    plain = event_ms(lambda: fr.mamba1_scan_fused_plain_bwd(*args, dy))
    bound = costs.fused_scan_bwd_bound(b, L, d, n)
    outs = fk.mamba1_scan_fused_bwd(*args, dy)
    moved = sum(t.numel() * t.element_size() for t in (*args, dy, *outs))
    del outs
    if bound["nbytes"] != moved:
        raise AssertionError(f"fused_scan_bwd_bound counts {bound['nbytes']} B, the call "
                             f"moves {moved} B")
    rows["mamba1_scan_bwd"] = dict(bound, shape=[b, L, d, n], ms=ms, forward_ms=fwd_ms,
                                   plain_ms=plain, library_ms=None,
                                   err=worst["mamba1_scan_bwd"][0],
                                   max_abs_err=worst["mamba1_scan_bwd"][1])
    print(f"time mamba1_scan_bwd b={b} L={L} d={d} n={n}: kernel {ms:.6g} ms (the fused "
          f"forward {fwd_ms:.6g} ms), plain backward {plain:.6g} ms, library call none, "
          f"bound {bound['bound_ms']:.6g} ms by {bound['bound_by']} ({bound['nbytes']} B "
          f"take {bound['t_bytes']:.6g} ms; {bound['sfu']} special-function operations "
          f"take {bound['sfu'] / costs.SFU_PER_S * 1e3:.6g} ms; {bound['flops']} f32 FLOP take "
          f"{bound['flops'] / costs.FP32_FLOPS * 1e3:.6g} ms); {bound['bound_ms'] / ms:.4f} of "
          f"its bound [{card}]", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 36: the fleet, GreenFaaS placing LLM jobs and running them
# ---------------------------------------------------------------------------

# examples/torch_fleet_train.py at --full-width for 4 steps: it checkpoints
# every 2, its endpoint leaves after step 2 and the job resumes from there
FLEET_STEPS = 4
FLEET_TRAIN_ARGS = ["--full-width", "--steps", str(FLEET_STEPS)]
# the train steps that phases 28 and 35 time, counted by the dry-run as they
# run (phase 37 holds the count to the card)
COUNTED_STEPS = {
    TRAIN_ARCH: {k: v for k, v in TRAIN.items() if k != "steps"},
    **{arch: {**{k: v for k, v in kw.items() if k != "steps"},
              **({"depth": SSM_LAYERS[arch]} if arch in SSM_LAYERS else {})}
       for arch, kw in SSM_TRAIN.items()}}


def fleet_cells() -> list[tuple[str, str]]:
    """The (arch, shape) cells the fleet examples' jobs name: the training
    job's and the serving wave's."""
    train_ex, serve_ex = load_example("torch_fleet_train"), load_example("torch_fleet_serve")
    jobs = [(train_ex.JOB["arch"], train_ex.JOB["shape"])]
    jobs += [(j.arch, j.shape) for j in serve_ex.wave()]
    return sorted(set(jobs))


def dryrun_counts(out: str) -> int:
    """The dry-run's work for phases 36 and 37, run in a child process
    (``start_dryrun``): the fleet examples' cells through the dry-run's
    command line into ``out/cells``, then each of ``COUNTED_STEPS`` by
    ``count_cell`` into ``out/steps.json``.  Meta tensors on the host, one
    torch thread, no card."""
    import torch
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    out = pathlib.Path(out)
    t0 = time.perf_counter()
    for arch, shape in fleet_cells():
        dryrun.main(["--arch", arch, "--shape", shape, "--out", str(out / "cells")])
    steps = {arch: dryrun.count_cell(arch, "train_4k", **kw)
             for arch, kw in COUNTED_STEPS.items()}
    (out / "steps.json").write_text(json.dumps(steps))
    print(f"dry-run counts: wall {time.perf_counter() - t0:.6g} s", flush=True)
    return 0


def start_dryrun() -> tuple[subprocess.Popen, pathlib.Path]:
    """Start ``dryrun_counts`` in a child process beside the card's phases
    (it is host work: the CUDA devices are hidden from it), writing under a
    new temporary directory, its output in ``log.txt`` there.  The child
    and the directory go when this process exits."""
    import tempfile
    out = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    log = open(out / "log.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-counts", str(out)],
        stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
        shutil.rmtree(out, ignore_errors=True)

    atexit.register(stop)
    return proc, out


def dryrun_results(proc, out, card) -> tuple[pathlib.Path, dict]:
    """Wait for the child of ``start_dryrun``; raise unless it succeeded.
    Prints each cell's FLOPs, bytes and counting seconds; returns the cells'
    directory and the counted steps."""
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    waited = time.perf_counter() - t0
    log = (out / "log.txt").read_text()
    if rc != 0:
        raise AssertionError(f"the dry-run's counts failed ({rc}):\n{log[-4000:]}")
    cells = out / "cells"
    for fp in sorted(cells.glob("*__single.json")):
        r = json.loads(fp.read_text())
        print(f"dry-run {r['arch']} {r['shape']} (b={r['global_batch']} x {r['seq']}, one "
              f"card): {r['flops_per_device']:.6g} FLOP, {r['bytes_accessed_per_device']:.6g} "
              f"B, kernel launches {r['kernel_launches']}, counted in {r['count_s']} s on the "
              f"host [{card}]", flush=True)
    print(f"{log.strip().splitlines()[-1]} (waited {waited:.6g} s for it here) [{card}]",
          flush=True)
    return cells, json.loads((out / "steps.json").read_text())


def fleet_placements(where, train_ex, serve_ex, kernel, dryrun_dir=None) -> dict:
    """The fleet example's training job placed, its endpoint leaving and the
    job placed again, and the serving wave placed, by managers on ``where``
    reading the dry-run's costs from ``dryrun_dir`` (None: the profile
    store's priors): each schedule's every field with its floats as bits,
    the window kernel's launches of each, and each ``place`` call's seconds
    (host clock; the schedule is on the host when it returns)."""
    import dataclasses

    from repro_torch.core.endpoint import tpu_fleet
    from repro_torch.fleet.manager import FleetJob, FleetManager
    job = FleetJob(steps=FLEET_STEPS, **train_ex.JOB)
    mgr = FleetManager(tpu_fleet(), dryrun_dir, alpha=0.5, device=where)
    wave_mgr = FleetManager(tpu_fleet(), dryrun_dir, alpha=0.3, device=where)
    seconds = []

    def place(m, jobs):
        t0 = time.perf_counter()
        s = m.place(jobs)
        seconds.append(time.perf_counter() - t0)
        return s

    before = kernel.LAUNCHES["greedy_window"]
    first = place(mgr, [job])
    mgr.endpoint_leave(first.assignments[job.id])
    second = place(mgr, [job])
    train_launches = kernel.LAUNCHES["greedy_window"] - before
    before = kernel.LAUNCHES["greedy_window"]
    wave = place(wave_mgr, serve_ex.wave())
    return {"train": [bits(dataclasses.asdict(s)) for s in (first, second)],
            "wave": bits(dataclasses.asdict(wave)),
            "launches": {"train": train_launches,
                         "wave": kernel.LAUNCHES["greedy_window"] - before},
            "place_s": seconds}


def fleet_phase(card, p_train, kernel, counters, zero_counts, dryrun_dir) -> dict:
    """Phase 36: the fleet layer on the card, on the port's own dry-run
    costs (``dryrun_dir``: the cells the jobs name, counted by
    ``start_dryrun``'s child).  (1) The training job and the serving wave
    placed by ``FleetManager`` from those costs on the card and on the CPU,
    equal in every field's bits; the job's two placements launch the
    window kernel twice on the card, the wave (one cluster, the host SoA
    engine) none; beside them the same placed on the profile store's
    priors.  (2) ``examples/torch_fleet_train.py --dryrun DIR`` on the card at
    granite-3-2b's full width with 2 of its 40 layers (counts zeroed just
    before, read just after: the two placements' window launches and
    flash's launches of ``step_launches`` for each of the 4 steps, nothing
    else), then one uninterrupted 4-step run: the losses before the leave
    and the resumed steps' losses and grad norms equal it.  (3)
    ``examples/torch_fleet_serve.py --full-width``: the wave placed, its
    first job (granite-3-2b, full width and depth) served at b=4, prompt
    32, 16 new tokens (40 flash launches, 40 decode launches a step), with
    ``--dryrun DIR`` too; each example's placement equals (1)'s."""
    import dataclasses
    import gc
    import shutil

    import numpy as np
    import torch
    from repro_torch.models.registry import build_api, get_api
    t_phase = time.perf_counter()
    train_ex = load_example("torch_fleet_train")
    serve_ex = load_example("torch_fleet_serve")

    # (1) placement on the card against the CPU, from the dry-run's costs and
    # on the priors
    placed = {}
    for costs_from, d in (("dry-run", dryrun_dir), ("priors", None)):
        card_p, cpu_p = (fleet_placements(w, train_ex, serve_ex, kernel, d)
                         for w in (None, "cpu"))
        if card_p["launches"] != {"train": 2, "wave": 0} or \
                cpu_p["launches"] != {"train": 0, "wave": 0}:
            raise AssertionError(f"fleet placement ({costs_from}) launched "
                                 f"{card_p['launches']} on the card and {cpu_p['launches']} "
                                 f"on the CPU, expected 2 and 0 for the job and 0 for the "
                                 f"wave")
        for k in ("train", "wave"):
            if card_p[k] != cpu_p[k]:
                raise AssertionError(f"fleet placement ({costs_from}) of the {k} job(s) on "
                                     f"the card differs from the CPU: "
                                     f"{first_difference(card_p[k], cpu_p[k])}")
        print(f"fleet placement ({costs_from}): the training job on "
              f"{card_p['train'][0]['assignments']}, after its endpoint leaves on "
              f"{card_p['train'][1]['assignments']} (2 window launches); the wave "
              f"{card_p['wave']['assignments']} (0 launches); card == CPU in every field's "
              f"bits; place s {card_p['place_s']} (CPU {cpu_p['place_s']}) [{card}]",
              flush=True)
        placed[costs_from] = (card_p, cpu_p)
    card_p, cpu_p = placed["dry-run"]
    dryrun_args = ["--dryrun", str(dryrun_dir)]

    # (2) the training example at full width, then an uninterrupted run
    cfg = build_api(dataclasses.replace(
        get_api(train_ex.JOB["arch"]).cfg, **train_ex.FULL_WIDTH["model_dims"])).cfg
    n_steps, half = FLEET_STEPS, FLEET_STEPS // 2
    per_step = step_launches(cfg, train_ex.FULL_WIDTH["microbatches"])
    want = {"greedy_window": 2, **{k: v * n_steps for k, v in per_step.items()}}
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    zero_counts()
    t0 = time.perf_counter()
    try:
        out = train_ex.main(FLEET_TRAIN_ARGS + dryrun_args
                            + ["--checkpoint-dir", str(TRAIN_CKPT)])
    finally:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    train_wall = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts(counters).items() if v}
    if launches != want:
        raise AssertionError(f"the fleet's training run launched {launches}, expected "
                             f"{want}")
    if bits(dataclasses.asdict(out["schedules"][0])) != card_p["train"][0]:
        raise AssertionError("the training example's placement differs from the job's")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    whole, whole_run = p_train.train(arch=train_ex.JOB["arch"], steps=n_steps, log_every=20,
                                     device=None, **train_ex.FULL_WIDTH)[1:]
    whole_wall = time.perf_counter() - t0
    before, resumed = out["losses"]
    resumed_norms = [r["grad_norm"] for r in out["run"]["steps"]]
    whole_norms = [r["grad_norm"] for r in whole_run["steps"]]
    if not np.isfinite(whole + whole_norms).all():
        raise AssertionError(f"a non-finite loss or grad norm: {whole}, {whole_norms}")
    if (before != whole[:half] or resumed != whole[half:]
            or resumed_norms != whole_norms[half:]):
        raise AssertionError(f"the fleet's run (losses {before} then {resumed}, grad norms "
                             f"{resumed_norms} resumed) differs from the uninterrupted "
                             f"run's {whole}, {whole_norms}")
    for run in (out["run"], whole_run):
        if run["peak_mem_bytes"] >= TRAIN_PEAK_LIMIT:
            raise AssertionError(f"the fleet's training peaked at {run['peak_mem_bytes']} B")
    step_s = [o["seconds"] for o in out["observed"]]
    print(f"fleet train {cfg.name} ({cfg.n_layers} layers, full width) b=8 x 4096 in 4 "
          f"microbatches: placed on {out['targets'][0]}, left after step {half}, re-placed on "
          f"{out['targets'][1]}, resumed; losses {before} + {resumed} == the uninterrupted "
          f"run's, grad norms of the resumed steps equal; step s {step_s} (uninterrupted "
          f"{[r['seconds'] for r in whole_run['steps']]}); peak memory "
          f"{out['run']['peak_mem_bytes']} B resumed, {whole_run['peak_mem_bytes']} B "
          f"uninterrupted; launches {launches}; wall {train_wall:.6g} s (uninterrupted "
          f"{whole_wall:.6g} s); events {out['events']} [{card}]", flush=True)

    # (3) the serving example at full width and depth
    serve_cfg = get_api(serve_ex.wave()[0].arch).cfg
    gen = 16
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    served = serve_ex.main(["--full-width"] + dryrun_args)
    serve_wall = time.perf_counter() - t0
    s_launches = {k: v for k, v in launch_counts(counters).items() if v}
    per_prefill, per_decode = attention_launches(serve_cfg)
    s_want = {"flash_attention": per_prefill, "decode_attention": per_decode * (gen - 1)}
    if s_launches != s_want:
        raise AssertionError(f"the fleet's serving run launched {s_launches}, expected "
                             f"{s_want}")
    tokens = served["served"]["tokens"]
    if tokens.shape != (4, gen) or tokens.min() < 0 or tokens.max() >= serve_cfg.vocab:
        raise AssertionError(f"bad served tokens {tokens.shape}")
    if bits(dataclasses.asdict(served["schedule"])) != card_p["wave"]:
        raise AssertionError("the serving example's placement differs from the wave's")
    tps = 4 * (gen - 1) / served["served"]["decode_s"]
    print(f"fleet serve {serve_cfg.name} (full width and depth) b=4 prompt 32 gen {gen} on "
          f"{served['served']['endpoint']}: prefill {served['served']['prefill_s']:.6g} s, "
          f"decode {served['served']['decode_s']:.6g} s ({tps:.6g} tok/s), launches "
          f"{s_launches}, wall {serve_wall:.6g} s [{card}]", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "placements": {"train": card_p["train"], "wave": card_p["wave"],
                       "train_example": [s.assignments for s in out["schedules"]],
                       "priors": {k: placed["priors"][0][k] for k in ("train", "wave")}},
        "place_s": {"card": card_p["place_s"], "cpu": cpu_p["place_s"]},
        "launches": {"placement": card_p["launches"], "train": launches, "serve": s_launches},
        "train": {"arch": cfg.name, "layers": cfg.n_layers, "steps": n_steps,
                  "targets": out["targets"], "losses": before + resumed,
                  "step_s": step_s, "peak_mem_bytes": out["run"]["peak_mem_bytes"],
                  "uninterrupted_step_s": [r["seconds"] for r in whole_run["steps"]],
                  "uninterrupted_peak_mem_bytes": whole_run["peak_mem_bytes"],
                  "wall_s": train_wall, "uninterrupted_wall_s": whole_wall,
                  "events": out["events"], "resume_equal": True},
        "serve": {"arch": serve_cfg.name, "endpoint": served["served"]["endpoint"],
                  "load": served["load"], "prefill_s": served["served"]["prefill_s"],
                  "decode_s": served["served"]["decode_s"], "decode_tok_per_s": tps,
                  "wall_s": serve_wall},
        "wall_s": time.perf_counter() - t_phase, "card": card}


def count_check(card, counted, trained) -> dict:
    """Phase 37: the dry-run's count of each timed train step
    (``COUNTED_STEPS``, counted by ``start_dryrun``'s child) against the
    card's run of it (``trained``: ``full_width_training``'s results):
    (a) its kernel launches times the steps equal those the card counted
    in its run, exactly;
    (b) its FLOPs over each measured step's seconds, as TFLOP/s and as a
    share of the dense bf16 rate, at most 1 (a larger share means the
    count is wrong); (c) its arguments less the batch (the
    count's int32 tokens and labels) equal the bytes of the state the card
    held, exactly; (d) its predicted peak (arguments + temporaries) beside
    the card's ``max_memory_allocated``."""
    from repro_torch.launch.dryrun import cell_api, cell_inputs, storage_bytes, tensors
    out = {}
    for arch, kw in COUNTED_STEPS.items():
        c, t = counted[arch], trained[arch]
        label = f"{arch} ({kw['depth']} layers)" if "depth" in kw else arch
        step_s = [r["seconds"] for r in t["steps"]]
        card_launches = {k: v for k, v in t["launches"].items() if v}
        if {k: v * len(step_s) for k, v in c["kernel_launches"].items()} != card_launches:
            raise AssertionError(f"the dry-run counts {c['kernel_launches']} launches in a "
                                 f"{label} train step, the card {card_launches} in "
                                 f"{len(step_s)} steps")
        shares = [c["flops_per_device"] / s / costs.BF16_FLOPS for s in step_s]
        if max(shares) > 1:
            raise AssertionError(f"the dry-run's {c['flops_per_device']} FLOP of a {label} "
                                 f"train step would run at {max(shares):.4f} of the card's "
                                 f"bf16 rate in the fastest measured step ({min(step_s)} s)")
        cfg = cell_api(arch, depth=kw.get("depth")).cfg
        batch = storage_bytes(tensors(cell_inputs(cfg, "train_4k", kw["batch"], kw["seq"])))
        mem = c["memory"]
        if mem["argument_size_in_bytes"] - batch != t["state_bytes"]:
            raise AssertionError(f"the dry-run's arguments of a {label} train step less its "
                                 f"batch ({batch} B) are {mem['argument_size_in_bytes'] - batch}"
                                 f" B, the card held a {t['state_bytes']} B state")
        predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        ratio = predicted / t["peak_mem_bytes"]
        tflops = [c["flops_per_device"] / s / 1e12 for s in step_s]
        print(f"dry-run against the card, {label} train step b={kw['batch']} x {kw['seq']} "
              f"in {kw['microbatches']} microbatches: launches {c['kernel_launches']} == the "
              f"card's; {c['flops_per_device']:.6g} FLOP ({c['kernel_flops']:.6g} in the "
              f"kernels), {c['bytes_accessed_per_device']:.6g} B; at the measured steps "
              f"{step_s} s: {[round(x, 2) for x in tflops]} TFLOP/s, "
              f"{[round(x, 4) for x in shares]} of {costs.BF16_FLOPS / 1e12:g}; state "
              f"{t['state_bytes']} B == arguments less the batch; predicted peak {predicted} B "
              f"against the card's {t['peak_mem_bytes']} B ({ratio:.4f}); counted in "
              f"{c['count_s']} s [{card}]", flush=True)
        out[arch] = {"launches": c["kernel_launches"], "flops": c["flops_per_device"],
                     "kernel_flops": c["kernel_flops"], "bytes": c["bytes_accessed_per_device"],
                     "step_s": step_s, "tflops": tflops, "bf16_share": shares,
                     "state_bytes": t["state_bytes"], "predicted_peak_bytes": predicted,
                     "card_peak_bytes": t["peak_mem_bytes"], "peak_ratio": ratio,
                     "count_s": c["count_s"]}
    return out


# ---------------------------------------------------------------------------
# phase 38: the sharded trainer (distributed/sharding.py, launch/mesh.py)
# ---------------------------------------------------------------------------

# the "model" axis each kernel's layouts are emulated on, one rank at a time
SHARD_RANKS = 4


def sharded_training(dev, card, p_train, steps_mod, adamw, counters, zero_counts, trained,
                     mesh_free_prints) -> dict:
    """Phase 38 (a): granite-3-2b trained as phase 28 trains it (``TRAIN``,
    seed 0) under ``make_host_mesh()``, a (1, 1) ("data", "model") mesh over
    a one-rank NCCL group, the state placed by ``param_shardings``.  At
    world size 1 every collective is an identity, so the four losses and
    every parameter's bits (``fingerprint``) must equal phase 28's, and
    each step launches ``step_launches`` (320 flash forwards and 160
    backwards).  Then one more step, traced beside phase 28's: the host's
    DTensor dispatch shows as the card's idle share."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed.sharding import ctx_for
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_api
    api = get_api(TRAIN_ARCH)
    want = step_launches(api.cfg, TRAIN["microbatches"])
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_host_mesh()
    per_step = []
    try:
        zero_counts()
        t0 = time.perf_counter()
        state, losses, run = p_train.train(
            arch=TRAIN_ARCH, reduced=False, seed=0, log_every=1, device=None, mesh=mesh,
            on_step=lambda i, loss, dt: per_step.append(launch_counts(counters)), **TRAIN)
        wall = time.perf_counter() - t0
        launches = launch_counts(counters)
        zero = {k: 0 for k in launches}
        deltas = [launch_deltas(a, b) for a, b in zip(per_step, [zero] + per_step)]
        if any(d != want for d in deltas) or launch_deltas(launches, per_step[-1]):
            raise AssertionError(f"the sharded {TRAIN_ARCH} training launched {deltas} a "
                                 f"step (expected {want}), {launches} in all")
        free = [r["loss"] for r in trained["steps"]]
        if losses != free:
            raise AssertionError(f"the sharded {TRAIN_ARCH} losses {losses} differ from the "
                                 f"mesh-free run's {free}")
        local = [p.to_local() for p in state["params"].parameters()]
        prints = fingerprint(types.SimpleNamespace(parameters=lambda: local))
        differ = [n for (n, _), a, b in zip(state["params"].named_parameters(), prints,
                                            mesh_free_prints) if a != b]
        if len(prints) != len(mesh_free_prints) or differ:
            raise AssertionError(f"the sharded {TRAIN_ARCH} parameters differ in bits from "
                                 f"the mesh-free run's: {differ[:8]} ({len(differ)} leaves)")
        del local
        peak = run["peak_mem_bytes"]
        steps = run["steps"]
        for r, f in zip(steps, trained["steps"]):
            print(f"train {TRAIN_ARCH} under a (1, 1) mesh step {r['step']}: loss "
                  f"{r['loss']:.6g} (== mesh-free), grad norm {r['grad_norm']:.6g}, "
                  f"{r['seconds']:.6g} s against mesh-free {f['seconds']:.6g} s [{card}]",
                  flush=True)
        print(f"train {TRAIN_ARCH} under a (1, 1) mesh, b={TRAIN['batch']} x {TRAIN['seq']} "
              f"in {TRAIN['microbatches']} microbatches, {TRAIN['steps']} steps: wall "
              f"{wall:.6g} s, peak memory {peak} B against mesh-free "
              f"{trained['peak_mem_bytes']} B, launches {launches} ({want} a step); the "
              f"losses and every parameter's bits equal phase 28's [{card}]", flush=True)

        # one more step, traced
        ctx = ctx_for(api.cfg, mesh)
        n_steps = TRAIN["steps"]
        step_fn = steps_mod.build_train_step(api, adamw.AdamWConfig(
            lr=3e-3, warmup_steps=min(20, n_steps // 5 + 1), total_steps=n_steps),
            microbatches=TRAIN["microbatches"], shd=ctx)
        data = SyntheticTokens(api.cfg.vocab, TRAIN["seq"], TRAIN["batch"], seed=0)
        batch = {k: torch.from_numpy(v).to(dev, torch.long)
                 for k, v in data.batch_at(n_steps).items()}
        holder = {"state": state}
        del state

        def one_step():
            holder["state"], _ = step_fn(holder["state"], batch)

        profile = trace(f"{TRAIN_ARCH} train step under a (1, 1) mesh (b={TRAIN['batch']} x "
                        f"{TRAIN['seq']}, {TRAIN['microbatches']} microbatches)", one_step,
                        card, top_n=8)
        free_idle = trained["profile"]["device_idle_share"]
        print(f"profile {TRAIN_ARCH} train step: the card idle "
              f"{profile['device_idle_share']} under the mesh, {free_idle} mesh-free; wall "
              f"{profile['wall_ms']:.6g} ms against {trained['profile']['wall_ms']:.6g} ms "
              f"[{card}]", flush=True)
        holder.clear()
        del step_fn, batch
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return {"arch": TRAIN_ARCH, "mesh": [1, 1], **TRAIN, "steps": steps, "wall_s": wall,
            "peak_mem_bytes": peak, "mesh_free_peak_mem_bytes": trained["peak_mem_bytes"],
            "mesh_free_step_s": [r["seconds"] for r in trained["steps"]],
            "launches": launches, "launches_per_step": want, "losses_equal": True,
            "parameter_bits_equal": True, "profile": profile,
            "mesh_free_idle_share": free_idle, "card": card}


def sharded_kernel_checks(dev, card, fk, sk, scan_k) -> dict:
    """Phase 38 (b): each kernel under the layouts the sharded path gives
    it, rank by rank of a ``SHARD_RANKS``-wide "model" axis, against the
    whole call on the same inputs.  flash at granite's microbatch
    (``BWD_TIMED``): head_tp (a rank's 8 query heads with its 2 kv heads)
    forward and backward ``torch.equal`` to the whole call's slice of
    heads; seq_cp (a rank's 1,024 queries against the keys up to its
    block's end) its o within ``TOLS["bfloat16"]``, its dq and the ranks'
    dk and dv (summed in f32 and rounded once, as the gather's backward
    reduces them) by ``grad_ok``.  The SSD at zamba2's microbatch (``SSD_BWD_TIMED``) with a
    quarter of the heads, and the fused scan at falcon-mamba's
    (``SCAN_BWD_TIMED``) with a quarter of the channels: y, the final
    state and every per-head or per-channel gradient ``torch.equal`` to
    the whole call's slice; the ranks' dB and dC summed in f32 (the SSD's
    within ``ssm_grad_errors``' bound, the scan's rounded to bf16 by
    ``grad_ok``)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(38)
    n, bf = SHARD_RANKS, "bfloat16"
    out = {}

    def same(label, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: the rank's call differs from the whole call's "
                                 f"slice (max |err| {max_abs_err(got, want)})")

    b, s, h, kv, d = BWD_TIMED[TRAIN_ARCH]
    q = randn(gen, (b, s, h, d), bf, dev)
    k, v = randn(gen, (b, s, kv, d), bf, dev), randn(gen, (b, s, kv, d), bf, dev)
    do = randn(gen, (b, s, h, d), bf, dev)
    o, lse = fk.flash_attention(q, k, v, causal=True, return_lse=True)
    dq, dk, dv = fk.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    hl, kl = h // n, kv // n
    for r in range(n):
        qs, ks = slice(r * hl, (r + 1) * hl), slice(r * kl, (r + 1) * kl)
        args = (q[:, :, qs].contiguous(), k[:, :, ks].contiguous(), v[:, :, ks].contiguous())
        o_r, lse_r = fk.flash_attention(*args, causal=True, return_lse=True)
        grads = fk.flash_attention_bwd(*args, o_r, lse_r, do[:, :, qs].contiguous())
        for name, got, want in (("o", o_r, o[:, :, qs]), ("lse", lse_r, lse[:, qs]),
                                ("dq", grads[0], dq[:, :, qs]), ("dk", grads[1], dk[:, :, ks]),
                                ("dv", grads[2], dv[:, :, ks])):
            same(f"flash head_tp rank {r} {name}", got, want)
    print(f"kernel flash_attention and flash_attention_bwd head_tp at {TRAIN_ARCH}'s "
          f"microbatch (b={b}, s={s}, h={h}, kv={kv}, d={d}), {n} ranks of {hl} heads over "
          f"{kl}: o, lse, dq, dk and dv equal to the whole call's slices [{card}]", flush=True)
    out["flash_head_tp"] = {"shape": [b, s, h, kv, d], "ranks": n, "equal": True}

    blk = s // n
    dk_sum = torch.zeros(k.shape, device=dev)
    dv_sum = torch.zeros(v.shape, device=dev)
    fwd_err, dq_worst = 0.0, None
    for r in range(n):
        qs, keys = slice(r * blk, (r + 1) * blk), (r + 1) * blk
        args = (q[:, qs].contiguous(), k[:, :keys].contiguous(), v[:, :keys].contiguous())
        o_r, lse_r = fk.flash_attention(*args, causal=True, return_lse=True)
        fwd_err = max(fwd_err, check_close(f"flash_attention seq_cp rank {r} o", o_r,
                                           o[:, qs], TOLS[bf], card))
        dq_r, dk_r, dv_r = fk.flash_attention_bwd(*args, o_r, lse_r, do[:, qs].contiguous())
        e = grad_errors(dq_r, dq[:, qs], bf)
        if not grad_ok(e, bf):
            raise AssertionError(f"flash seq_cp rank {r} dq disagrees with the whole "
                                 f"call's: {e}")
        dq_worst = e if dq_worst is None or e["ratio"] > dq_worst["ratio"] else dq_worst
        dk_sum[:, :keys] += dk_r
        dv_sum[:, :keys] += dv_r
    errs = {"dq": dq_worst}
    for name, got, want in (("dk", dk_sum.to(dk.dtype), dk), ("dv", dv_sum.to(dv.dtype), dv)):
        errs[name] = grad_errors(got, want, bf)
        if not grad_ok(errs[name], bf):
            raise AssertionError(f"flash seq_cp: the {n} ranks' summed {name} disagrees "
                                 f"with the whole call's: {errs[name]}")
    print(f"kernel flash_attention and flash_attention_bwd seq_cp at {TRAIN_ARCH}'s "
          f"microbatch, {n} ranks of {blk} queries: o within {TOLS[bf]} (max |err| "
          f"{fwd_err:.6g}); " + ", ".join(
              f"{k} at most {e['ratio']:.4g} of its allowance, relative Frobenius "
              f"{e['fro']:.4g}" for k, e in errs.items())
          + f" (dk and dv summed over the ranks in f32, then rounded to bf16) [{card}]",
          flush=True)
    out["flash_seq_cp"] = {"shape": [b, s, h, kv, d], "ranks": n, "o_max_abs_err": fwd_err,
                           "grads": errs}
    del q, k, v, do, o, lse, dq, dk, dv, dk_sum, dv_sum

    b, L, nh, hd, st = SSD_BWD_TIMED
    xdt, loga, B, C, dy, _ = ssd_bwd_case(gen, dev, b, L, nh, hd, st, False)
    y, S = sk.ssd(xdt, loga, B, C)
    g = dict(zip(SSD_GRADS, sk.ssd_bwd(xdt, loga, B, C, dy)))
    hl = nh // n
    sums = {"dB": torch.zeros_like(B), "dC": torch.zeros_like(C)}
    for r in range(n):
        hs = slice(r * hl, (r + 1) * hl)
        xr, lr_ = xdt[:, :, hs].contiguous(), loga[:, :, hs].contiguous()
        y_r, S_r = sk.ssd(xr, lr_, B, C)
        g_r = dict(zip(SSD_GRADS, sk.ssd_bwd(xr, lr_, B, C, dy[:, :, hs].contiguous())))
        for name, got, want in (("y", y_r, y[:, :, hs]), ("state", S_r, S[:, hs]),
                                ("dxdt", g_r["dxdt"], g["dxdt"][:, :, hs]),
                                ("dloga", g_r["dloga"], g["dloga"][:, :, hs])):
            same(f"ssd rank {r} {name}", got, want)
        sums["dB"] += g_r["dB"]
        sums["dC"] += g_r["dC"]
    ssd_errs = ssm_grad_errors(sums, {"dB": g["dB"], "dC": g["dC"]})
    if max(e["ratio"] for e in ssd_errs.values()) > 1.0:
        raise AssertionError(f"ssd: the {n} ranks' summed dB / dC disagree: {ssd_errs}")
    print(f"kernel ssd and ssd_bwd at zamba2's microbatch (b={b}, L={L}, nh={nh}, hd={hd}, "
          f"n={st}), {n} ranks of {hl} heads: y, the state, dxdt and dloga equal to the "
          f"whole call's slices; the summed dB / dC at most "
          f"{ssd_errs['dB']['ratio']:.4g} / {ssd_errs['dC']['ratio']:.4g} of their bound "
          f"[{card}]", flush=True)
    out["ssd"] = {"shape": [b, L, nh, hd, st], "ranks": n, "equal": True, "summed": ssd_errs}
    del xdt, loga, B, C, dy, y, S, g, sums

    b, L, dd, st = SCAN_BWD_TIMED
    args, dy = scan_bwd_case(gen, dev, b, L, dd, st, r=256)
    xc, dt_raw, dt_b, A, B, C, D, z = args
    y = scan_k.mamba1_scan_fused(*args)
    g = dict(zip(SCAN_GRADS, scan_k.mamba1_scan_fused_bwd(*args, dy)))
    cl = dd // n
    sums = {"dB": torch.zeros(B.shape, device=dev), "dC": torch.zeros(C.shape, device=dev)}
    # B and C reach a rank whole and contiguous (x_proj's partial sum reduced)
    Bc, Cc = B.contiguous(), C.contiguous()
    for r in range(n):
        cs = slice(r * cl, (r + 1) * cl)
        a_r = (xc[..., cs].contiguous(), dt_raw[..., cs].contiguous(), dt_b[cs], A[cs], Bc,
               Cc, D[cs], z[..., cs])
        y_r = scan_k.mamba1_scan_fused(*a_r)
        g_r = dict(zip(SCAN_GRADS, scan_k.mamba1_scan_fused_bwd(*a_r,
                                                                 dy[..., cs].contiguous())))
        same(f"mamba1_scan_fused rank {r} y", y_r, y[..., cs])
        for name in ("dxc", "ddt_raw", "dz"):
            same(f"mamba1_scan_bwd rank {r} {name}", g_r[name], g[name][..., cs])
        for name in ("ddt_b", "dA", "dD"):
            same(f"mamba1_scan_bwd rank {r} {name}", g_r[name], g[name][cs])
        sums["dB"] += g_r["dB"]
        sums["dC"] += g_r["dC"]
    scan_errs = {k: grad_errors(v.to(g[k].dtype), g[k], bf) for k, v in sums.items()}
    if not all(grad_ok(e, bf) for e in scan_errs.values()):
        raise AssertionError(f"mamba1_scan_bwd: the {n} ranks' summed dB / dC disagree: "
                             f"{scan_errs}")
    print(f"kernel mamba1_scan_fused and mamba1_scan_bwd at falcon-mamba's microbatch "
          f"(b={b}, L={L}, d={dd}, n={st}), {n} ranks of {cl} channels: y and every "
          f"per-channel gradient equal to the whole call's slices; the summed dB / dC (in "
          f"f32, rounded to bf16) at most {scan_errs['dB']['ratio']:.4g} / {scan_errs['dC']['ratio']:.4g} "
          f"of their allowance, relative Frobenius {scan_errs['dB']['fro']:.4g} / "
          f"{scan_errs['dC']['fro']:.4g} [{card}]", flush=True)
    out["mamba1_scan"] = {"shape": [b, L, dd, st], "ranks": n, "equal": True,
                          "summed": scan_errs}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import scheduler as sched
    from repro_torch.core.endpoint import scaled_testbed
    from repro_torch.core.executor import GreenFaaSExecutor
    from repro_torch.core.policy import MHRAPolicy
    from repro_torch.core.predictor import TaskProfileStore
    from repro_torch.core.testbed import (
        BASE_PROFILES, MACHINE_COEFS, SEBS_FUNCTIONS, TestbedSim,
    )
    from repro_torch.core.transfer import TransferModel
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.placement import build, kernel, ops, ref
    from repro_torch.kernels.selective_scan import kernel as scan_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel

    counters = (kernel.LAUNCHES, flash_kernel.LAUNCHES, dec_kernel.LAUNCHES,
                ssd_kernel.LAUNCHES, scan_kernel.LAUNCHES)

    def zero_counts():
        for c in counters:
            for k in c:
                c[k] = 0

    dev = device()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    # each phase's wall time, the build's included, printed as it ends
    phase_s, mark = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now
        print(f"phase {name}: wall {phase_s[name]:.6g} s [{card}]", flush=True)
    # numpy's version too: seeded workloads draw through its generators
    # (the multi-tenant trace's Zipf ranks differ between its versions)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} numpy "
          f"{np.__version__} python {sys.version.split()[0]}", flush=True)

    # ---- 1. build: one nvcc per source, all started together ----------
    t0 = time.perf_counter()
    kbuild.build_all([(build.SOURCE, build.NVCC_FLAGS)] + [
        (src, kbuild.NVCC_FLAGS)
        for src in (flash_kernel.SOURCE, flash_kernel.BWD_SOURCE, dec_kernel.SOURCE,
                    ssd_kernel.SOURCE, ssd_kernel.BWD_SOURCE, scan_kernel.SOURCE,
                    scan_kernel.BWD_SOURCE)], verbose=True)
    for lib in (build.lib, flash_kernel.lib, flash_kernel.bwd_lib, dec_kernel.lib,
                ssd_kernel.lib, ssd_kernel.bwd_lib, scan_kernel.lib, scan_kernel.bwd_lib):
        lib()
    for name, st in kbuild.BUILD_STATS.items():
        print(f"build {name}: nvcc {st['builds']} build(s), {st['seconds']:.2f} s "
              f"[{card}]", flush=True)
    print(f"build: wall {time.perf_counter() - t0:.2f} s for "
          f"{len(kbuild.BUILD_STATS)} sources in parallel [{card}]", flush=True)
    kernel_resources(kbuild, card, flash_kernel, dec_kernel, ssd_kernel, scan_kernel)
    # the dry-run's counts for phases 36 and 37, on the host beside the card
    dryrun_proc, dryrun_out = start_dryrun()

    lap("1")

    # ---- 2. kernel phase ------------------------------------------------
    def score_case(seed, n, ties):
        rng = np.random.default_rng(seed)
        regs = {
            "e_base": rng.uniform(0.0, 5e4, n), "nl": rng.uniform(0.0, 300.0, n),
            "g_base": rng.uniform(0.0, 10.0, n), "lk": rng.uniform(0.0, 3.0, n),
            "fw": rng.uniform(0.0, 2.0, n), "wt": rng.uniform(0.0, 1.0, n),
        }
        alive = rng.random(n) < 0.8
        if ties:
            for k in regs:
                regs[k] = np.zeros(n)
            alive[: n // 3] = False     # the first alive lane must win
        alive[int(rng.integers(n))] = True
        scal = dict(c_cur=float(rng.uniform(0.0, 200.0)),
                    idle_on_sum=float(rng.uniform(0.0, 500.0)),
                    a1=float(rng.uniform(0.0, 1e-4)), b1=float(rng.uniform(0.0, 1e-2)),
                    g1=float(rng.uniform(0.0, 1.0)), w_idle_on=float(rng.uniform(0.0, 1e-3)))
        t = {k: torch.from_numpy(v).to(dev) for k, v in regs.items()}
        t["alive"] = torch.from_numpy(alive).to(dev)
        return t, scal

    sf_err = 0.0
    for seed, n, ties in ((0, 32, False), (1, 32, True), (2, 1000, False),
                          (3, 1000, True)):
        t, scal = score_case(seed, n, ties)
        obj_k, idx_k = kernel.score_fleet(**t, **scal)
        obj_p, idx_p = ref.score_fleet_plain(**t, **scal)
        torch.cuda.synchronize()
        sf_err = max(sf_err, max_abs_err(obj_k, obj_p))
        if not bits_equal(obj_k, obj_p) or int(idx_k) != int(idx_p):
            raise AssertionError(f"score_fleet disagrees at {n} lanes (ties={ties})")
        if ties and int(idx_k) != int(torch.nonzero(t["alive"])[0]):
            raise AssertionError("score_fleet tie not broken to the first lane")
        print(f"kernel score_fleet lanes={n} ties={ties}: bitwise equal, "
              f"argmin {int(idx_k)}", flush=True)

    eps = scaled_testbed(REPLICAS)
    store = seeded_store(eps, TaskProfileStore, BASE_PROFILES, SEBS_FUNCTIONS)
    tm = TransferModel(eps)

    def window(n_tasks, fleet=(eps, store, tm)):
        f_eps, f_store, f_tm = fleet
        tasks = make_tasks(n_tasks, f_eps[0].name, sched.TaskSpec, SEBS_FUNCTIONS)
        table = sched.PredictionTable(tasks, f_eps, f_store)
        sf1, sf2, _ = sched._normalizers_fast(tasks, f_eps, table, f_tm)
        units = [[t] for t in tasks]
        idx = [[i] for i in range(n_tasks)]
        n_ep, consts, init, xs, _ = sched.window_inputs(
            units, idx, f_eps, table, f_tm, 0.5, sched.HEURISTICS, sf1, sf2,
            sched.SoAState(f_eps, f_tm), None, dev)
        p, n_units = ops.pack(consts, init, xs, dev)
        return p, n_ep, n_units

    # the window kernel against its plain version: on a 4096-task window,
    # then at the main path's shape (32,768 tasks); the plain version's
    # one run on each is its time on the card
    gw_err = 0.0
    plain_ms = {}
    windows = {}
    for n_tasks in (CHECK_TASKS, N_TASKS):
        p, n_ep, n_units = windows[n_tasks] = window(n_tasks)
        out_k = kernel.greedy_window(p, n_ep, n_units)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out_p = ops._greedy_scan_plain(p, n_ep, n_units)
        ev1.record()
        torch.cuda.synchronize()
        plain_ms[n_tasks] = ev0.elapsed_time(ev1)
        gw_err = max([gw_err] + [max_abs_err(out_k[k], out_p[k]) for k in
                                 ("start", "end", "base", "slots", "run", "hs")])
        for k in ("ei", "start", "end", "base", "slots", "run", "staged", "hs"):
            if not bits_equal(out_k[k], out_p[k]):
                raise AssertionError(f"greedy_window disagrees with the plain "
                                     f"version on '{k}' at {n_tasks} tasks")
        print(f"kernel greedy_window {n_tasks}x{n_ep}x{len(sched.HEURISTICS)}: "
              f"ei/start/end and carry bitwise equal to the plain version "
              f"(plain version {plain_ms[n_tasks]:.1f} ms) [{card}]", flush=True)

    # small window: the card's placement against the CPU's plain path
    small = make_tasks(1792, eps[0].name, sched.TaskSpec, SEBS_FUNCTIONS, "s")
    s_gpu = sched.mhra(small, eps, store, tm, 0.5, device=dev)
    s_cpu = sched.mhra(small, eps, store, tm, 0.5, device="cpu")
    for f in ("assignments", "objective", "energy_j", "makespan_s",
              "transfer_j", "heuristic", "timeline"):
        if getattr(s_gpu, f) != getattr(s_cpu, f):
            raise AssertionError(f"mhra on the card differs from the CPU on {f}")
    print("mhra 1792x32: card == CPU plain path (assignments, objective, "
          "energy, makespan, transfer, heuristic, timeline)", flush=True)

    # fleets past the old kernel's shared-memory cap (LARGE_PLANS), bitwise
    # against the plain version on a window of a few hundred tasks, and timed
    large = {}
    for replicas, want_plan in LARGE_PLANS.items():
        l_eps = scaled_testbed(replicas)
        fleet = (l_eps, seeded_store(l_eps, TaskProfileStore, BASE_PROFILES,
                                     SEBS_FUNCTIONS), TransferModel(l_eps))
        p, n_ep_l, n_units_l = window(LARGE_TASKS, fleet)
        out_k = kernel.greedy_window(p, n_ep_l, n_units_l)
        out_p = ops._greedy_scan_plain(p, n_ep_l, n_units_l)
        torch.cuda.synchronize()
        for k in ("ei", "start", "end", "base", "slots", "run", "staged", "hs"):
            if not bits_equal(out_k[k], out_p[k]):
                raise AssertionError(f"greedy_window disagrees with the plain version "
                                     f"on '{k}' at {n_ep_l} endpoints")
        E_l, C_l = p["base"].shape[2], p["slots"].shape[2]
        ms_l = cuda_ms(lambda: kernel.greedy_window(p, n_ep_l, n_units_l), reps=3,
                       warmup=1)
        pl = kernel.plan(E_l, C_l, p["staged"].shape[1])
        if any(pl[k] != v for k, v in want_plan.items()):
            raise AssertionError(f"greedy_window at {n_ep_l} endpoints planned {pl}, "
                                 f"expected {want_plan}")
        large[E_l] = {"endpoints": n_ep_l, "tasks": n_units_l, "C": C_l, "ms": ms_l,
                      "us_per_step": ms_l * 1e3 / n_units_l, "plan": pl}
        print(f"kernel greedy_window {n_units_l}x{n_ep_l}x{len(sched.HEURISTICS)} (E={E_l}, "
              f"C={C_l}): bitwise equal to the plain version; {ms_l:.6g} ms, "
              f"{ms_l * 1e3 / n_units_l:.4g} us a step; plan {pl} [{card}]", flush=True)
        if replicas == 100:
            l_tasks = make_tasks(LARGE_TASKS, l_eps[0].name, sched.TaskSpec,
                                 SEBS_FUNCTIONS, "L")
            s_gpu = sched.mhra(l_tasks, l_eps, fleet[1], fleet[2], 0.5)
            s_cpu = sched.mhra(l_tasks, l_eps, fleet[1], fleet[2], 0.5, device="cpu")
            for f in ("assignments", "objective", "energy_j", "makespan_s",
                      "transfer_j", "heuristic", "timeline"):
                if getattr(s_gpu, f) != getattr(s_cpu, f):
                    raise AssertionError(f"mhra(device=None) at {len(l_eps)} endpoints "
                                         f"differs from the CPU on {f}")
            print(f"mhra(device=None) {LARGE_TASKS}x{len(l_eps)}: card == CPU plain path "
                  f"(assignments, objective, energy, makespan, transfer, heuristic, "
                  f"timeline)", flush=True)
    # the later phases' peak memory counts none of these windows
    del p, out_k, out_p

    lap("2")

    # ---- 3. main path ---------------------------------------------------
    profiles, coefs = replica_profiles(eps, BASE_PROFILES, MACHINE_COEFS)
    sim = TestbedSim(eps, profiles=profiles, coefs=coefs, seed=0)
    ex = GreenFaaSExecutor(eps, sim, alpha=0.5,
                           policy=MHRAPolicy(), monitoring=True)
    ex.store = seeded_store(eps, TaskProfileStore, BASE_PROFILES, SEBS_FUNCTIONS)
    obs0 = sum(st.n for st in ex.store._rt.values())
    zero_counts()
    batches = []
    for b in range(N_BATCHES):
        tasks = make_tasks(N_TASKS, eps[0].name, sched.TaskSpec,
                           SEBS_FUNCTIONS, f"b{b}t")
        before = kernel.LAUNCHES["greedy_window"]
        t0 = time.perf_counter()
        res = ex.run_batch(tasks)
        wall = time.perf_counter() - t0
        if kernel.LAUNCHES["greedy_window"] != before + 1:
            raise AssertionError("run_batch did not launch greedy_window once")
        obs = sum(st.n for st in ex.store._rt.values())
        if obs <= obs0:
            raise AssertionError("the profile store learned nothing")
        obs0 = obs
        s = res.schedule
        vals = (s.objective, s.energy_j, s.makespan_s, res.measured_energy_j,
                res.attributed_energy_j, res.makespan_s)
        if len(s.assignments) != N_TASKS or not np.all(np.isfinite(vals)):
            raise AssertionError(f"batch {b}: bad schedule or non-finite result")
        if set(s.assignments.values()) - {e.name for e in eps}:
            raise AssertionError(f"batch {b}: assignment to an unknown endpoint")
        batches.append({
            "batch": b, "placement_s": res.scheduling_s,
            "kernel_s": ops.LAST_RUN["seconds"], "run_batch_s": wall,
            "makespan_s": res.makespan_s, "measured_energy_j": res.measured_energy_j,
            "edp": res.edp(), "heuristic": s.heuristic,
            "endpoints_used": len(set(s.assignments.values())),
        })
        print(f"batch {b}: placement {res.scheduling_s:.3f} s (window kernel "
              f"{ops.LAST_RUN['seconds']:.3f} s), run_batch {wall:.3f} s, "
              f"makespan {res.makespan_s:.3f} s, measured energy "
              f"{res.measured_energy_j:.1f} J, EDP {res.edp():.6g} J*s, "
              f"heuristic {s.heuristic} [{card}]", flush=True)
    launches = dict(kernel.LAUNCHES)
    if any(v for c in counters[1:] for v in c.values()):
        raise AssertionError("the placement path launched a model kernel")
    if launches["greedy_window"] != N_BATCHES:
        raise AssertionError(f"main path launched greedy_window "
                             f"{launches['greedy_window']} times")
    print(f"main path launches: {launches}", flush=True)

    lap("3")

    # ---- 3b. the default executor: Cluster MHRA --------------------------
    default = default_executor(dev, card, sched, eps, GreenFaaSExecutor, TestbedSim,
                               TaskProfileStore, BASE_PROFILES, MACHINE_COEFS,
                               SEBS_FUNCTIONS, kernel, counters, zero_counts)
    print(json.dumps({"default_executor": default}), flush=True)

    lap("3b")

    # ---- 3c. the four scoring registers armed ------------------------------
    registers = registers_phase(dev, card, sched, eps, store, tm, kernel, ops,
                                counters, zero_counts)
    print(json.dumps({"registers": registers}), flush=True)

    lap("3c")

    # ---- 3d. the streaming path: OnlineEngine over one live state --------
    streams = streaming_phase(card, kernel, ops, counters, zero_counts)
    print(json.dumps({"streams": streams}), flush=True)

    lap("3d")

    # ---- 3e. the paper's evaluation: six scenarios, every policy row -------
    evaluation = evaluation_phase(card, sched, kernel, ops, counters, zero_counts)
    print(json.dumps({"evaluation": evaluation}), flush=True)

    lap("3e")

    # ---- 4. timing ------------------------------------------------------
    p_full, n_ep, n_units_full = windows[N_TASKS]
    p_chk, _, n_units = windows[CHECK_TASKS]
    gw_ms = cuda_ms(lambda: kernel.greedy_window(p_full, n_ep, n_units_full),
                    reps=5, warmup=1)
    gw_chk_ms = cuda_ms(lambda: kernel.greedy_window(p_chk, n_ep, n_units),
                        reps=5, warmup=1)
    H = p_full["base"].shape[0]
    E = p_full["base"].shape[2]
    C = p_full["slots"].shape[2]
    in_bytes = sum(v.numel() * v.element_size() for v in p_full.values())
    out_k = kernel.greedy_window(p_full, n_ep, n_units_full)
    out_bytes = sum(v.numel() * v.element_size() for v in out_k.values())
    n_new_run = int(p_full["xs_i"][:, 4].sum())
    # FP64 operations this window needs: the score of every true lane per
    # step (13), the commit (about 35 plus two passes over the C slots),
    # and the full pass (about 30 per lane plus two pairwise sums) on
    # every run boundary
    gw_ops = (H * n_units_full * (13 * n_ep + 35 + 2 * C)
              + n_new_run * (30 * n_ep + 2 * n_ep))
    gw_bound_bytes = (in_bytes + out_bytes) / costs.HBM_BYTES_PER_S * 1e3
    gw_bound_ops = gw_ops / costs.FP64_FLOPS * 1e3
    print(f"time greedy_window {N_TASKS}x{n_ep}x{H} (E={E}, C={C}): "
          f"{gw_ms:.6g} ms ({gw_ms * 1e3 / n_units_full:.4g} us a step; plan "
          f"{kernel.plan(E, C, p_full['staged'].shape[1])}), plain version on the card "
          f"{plain_ms[N_TASKS]:.1f} ms; at {CHECK_TASKS} tasks "
          f"{gw_chk_ms:.3f} ms, plain version {plain_ms[CHECK_TASKS]:.1f} ms; "
          f"bound {max(gw_bound_bytes, gw_bound_ops) * 1e3:.3f} us "
          f"({in_bytes + out_bytes} B, {gw_ops} FP64 ops); "
          f"{n_new_run} run boundaries [{card}]", flush=True)

    sf_rows = {}
    for n in (32, 1024):
        t, scal = score_case(10 + n, n, False)
        k_ms = cuda_ms(lambda: kernel.score_fleet(**t, **scal), reps=2000, warmup=20)
        p_ms = cuda_ms(lambda: ref.score_fleet_plain(**t, **scal), reps=2000, warmup=20)
        nbytes = n * (6 * 8 + 1) + n * 8 + 8 + 4
        ops_n = 13 * n
        bound = max(nbytes / costs.HBM_BYTES_PER_S, ops_n / costs.FP64_FLOPS) * 1e3
        sf_rows[n] = (k_ms, p_ms, bound, nbytes, ops_n)
        print(f"time score_fleet lanes={n}: kernel {k_ms * 1e3:.2f} us, plain "
              f"version on the card {p_ms * 1e3:.2f} us, bound "
              f"{bound * 1e6:.3f} ns ({nbytes} B, {ops_n} FP64 ops) [{card}]",
              flush=True)
    # The main path's one kernel is greedy_window: it replaces the Pallas
    # score kernel together with the lax.scan that called it on every
    # step.  The standalone score_fleet (the counterpart of the reference's
    # score_fleet entry point) is not launched by the main path; it is
    # checked and timed above and reported on its own line.
    kernels = [
        {"name": "greedy_window", "route": "cuda", "source": CU_SOURCE,
         "replaces": "src/repro/kernels/placement/kernel.py:22",
         "also_replaces": "src/repro/kernels/placement/ops.py:163",
         "launches": launches["greedy_window"], "max_abs_err": gw_err,
         "ms": gw_ms, "plain_ms": plain_ms[N_TASKS],
         "bound_ms": max(gw_bound_bytes, gw_bound_ops),
         "bound_by": "bytes" if gw_bound_bytes >= gw_bound_ops else "operations",
         "library_ms": None,
         "registers_armed": {v: {k: w[k] for k in ("kernel_ms", "us_per_step",
                                                  "new_run_share", "bound_ms")}
                             for v, w in registers["windows"].items()},
         "stream_launches": {name: streams[name]["launches"] for name in STREAMS},
         "stream_kernel_ms": {name: streams[name]["kernel_ms"] for name in STREAMS}},
    ]
    standalone = [
        {"name": "score_fleet", "route": "cuda", "source": CU_SOURCE,
         "replaces": "src/repro/kernels/placement/kernel.py:22",
         "launches_on_main_path": launches["score_fleet"], "lanes": n,
         "max_abs_err": sf_err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
         "bound_by": ("bytes" if nbytes / costs.HBM_BYTES_PER_S >= ops_n / costs.FP64_FLOPS
                      else "operations"),
         "library_ms": None}
        for n, (k_ms, p_ms, bound, nbytes, ops_n) in sf_rows.items()
    ]
    print(json.dumps({"batches": batches, "large_fleets": large}), flush=True)
    print(json.dumps({"standalone_kernels": standalone}), flush=True)

    lap("4")

    # ---- 5. zamba2 kernels against their plain versions ----------------
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_api
    mods = (flash_kernel, flash_ref, dec_kernel, dec_ref, ssd_kernel, ssd_ref)
    errs = zamba2_kernel_checks(dev, card, *mods)

    lap("5")

    # ---- 6. the reduced slice, card against CPU ---------------------------
    slice_err = slice_check(dev, card, get_api, ARCH, SLICE_TOL)

    lap("6")

    # ---- 7. main path: serve zamba2-2.7b at full width --------------------
    cfg = get_api(ARCH).cfg
    napp = cfg.n_layers // cfg.shared_attn_every
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    tokens, t_prefill, t_decode = serve.serve_batch(
        ARCH, reduced=False, batch=SERVE_BATCH, prompt_len=PROMPT_LEN,
        gen_tokens=GEN_TOKENS, seed=0)
    serve_wall = time.perf_counter() - t0
    zlaunches = {"flash_attention": flash_kernel.LAUNCHES["flash_attention"],
                 "decode_attention": dec_kernel.LAUNCHES["decode_attention"],
                 "ssd": ssd_kernel.LAUNCHES["ssd"]}
    peak = torch.cuda.max_memory_allocated(dev)
    # flash and the SSD run only in the prefill, decode attention only in
    # the decode steps
    want = {"flash_attention": napp, "ssd": cfg.n_layers,
            "decode_attention": napp * (GEN_TOKENS - 1)}
    if zlaunches != want or any(kernel.LAUNCHES.values()) or \
            any(scan_kernel.LAUNCHES.values()) or flash_kernel.LAUNCHES["flash_attention_bwd"]:
        raise AssertionError(f"serving launched {zlaunches} (placement "
                             f"{dict(kernel.LAUNCHES)}, scan {scan_kernel.LAUNCHES}), "
                             f"expected {want}")
    if tokens.shape != (SERVE_BATCH, GEN_TOKENS) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab:
        raise AssertionError(f"bad generated tokens {tokens.shape}")
    tps = SERVE_BATCH * (GEN_TOKENS - 1) / t_decode
    serving = {
        "arch": ARCH, "params": get_api(ARCH).n_params(), "batch": SERVE_BATCH,
        "prompt_len": PROMPT_LEN, "gen_tokens": GEN_TOKENS, "prefill_s": t_prefill,
        "decode_s": t_decode, "decode_tok_per_s": tps, "serve_batch_wall_s": serve_wall,
        "peak_mem_bytes": peak, "launches": zlaunches,
        "slice_max_logit_err": slice_err, "card": card,
    }
    print(f"serve {ARCH} b={SERVE_BATCH} prompt {PROMPT_LEN} gen {GEN_TOKENS}: "
          f"prefill {t_prefill:.6g} s, decode {t_decode:.6g} s ({tps:.6g} tok/s), "
          f"peak memory {peak} B, launches {zlaunches} [{card}]", flush=True)

    lap("7")

    # ---- 8. zamba2 kernel timing at the serving shapes ---------------------
    rows = zamba2_timing(dev, card, *mods, cfg)
    for name, source, line in (
            ("flash_attention", FLASH_SOURCE,
             "src/repro/kernels/flash_attention/kernel.py:23"),
            ("decode_attention", DECODE_SOURCE,
             "src/repro/kernels/decode_attention/kernel.py:21"),
            ("ssd", SSD_SOURCE, "src/repro/kernels/ssd/kernel.py:26")):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": line,
            "launches": zlaunches[name], "max_abs_err": max(errs[name], r["err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"serving": serving}), flush=True)

    lap("8")

    # ---- 9. where the serving time goes: a profiler trace -----------------
    print(json.dumps({"profile": serving_profile(dev, card, serve, get_api(ARCH))}),
          flush=True)

    lap("9")

    # ---- 10. the scan kernel against its plain version, and its time -------
    from repro_torch.kernels.selective_scan import ref as scan_ref
    from repro_torch.models import common, lm
    fm_api = get_api(FM_ARCH)
    scan_row = falcon_scan(dev, card, scan_kernel, scan_ref, fm_api.cfg)
    fused_row = falcon_fused_scan(dev, card, scan_kernel, scan_ref, fm_api.cfg)
    silu = silu_cost(dev, card, common, fm_api.cfg)

    lap("10")

    # ---- 11. the reduced falcon-mamba slice, card against CPU --------------
    fm_slice = falcon_slice_check(dev, card, get_api, lm)

    lap("11")

    # ---- 12. main path: falcon-mamba-7b's loss forward at full width -------
    others = [c for c in counters if c is not scan_kernel.LAUNCHES]
    fm_loss = falcon_loss(dev, card, fm_api, scan_kernel.LAUNCHES, zero_counts, others)
    fm_loss["slice"] = fm_slice
    fm_loss["silu_cost"] = silu
    print(json.dumps({"falcon_loss": fm_loss}), flush=True)

    lap("12")

    # ---- 13. falcon-mamba-7b serving at full width ---------------------------
    torch.cuda.empty_cache()
    fm_serving = falcon_serving(dev, card, serve, fm_api, scan_kernel.LAUNCHES,
                                zero_counts, others)
    print(json.dumps({"falcon_serving": fm_serving}), flush=True)
    # the model's path runs the scan in its fused form; the reference's
    # interface (the same CUDA design without its prologue and epilogue)
    # is checked and timed in phase 10 and reported on its own line
    kernels.append({
        "name": "mamba1_scan_fused", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": "src/repro/kernels/selective_scan/kernel.py:23",
        "launches": fm_loss["mamba1_scan_fused_launches"],
        "max_abs_err": fused_row["err"], "ms": fused_row["ms"],
        "plain_ms": fused_row["plain_ms"], "bound_ms": fused_row["bound_ms"],
        "bound_by": fused_row["bound_by"], "library_ms": None})
    print(json.dumps({"standalone_kernels": [{
        "name": "selective_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": "src/repro/kernels/selective_scan/kernel.py:23",
        "launches_on_main_path": 0, "max_abs_err": scan_row["err"],
        "ms": scan_row["ms"], "plain_ms": scan_row["plain_ms"],
        "bound_ms": scan_row["bound_ms"], "bound_by": scan_row["bound_by"],
        "library_ms": None}]}), flush=True)

    lap("13")

    # ---- 14. the dense family's shapes: flash and decode against plain -----
    torch.cuda.empty_cache()
    dense_rows = attention_kernel_checks(dev, card, flash_kernel, flash_ref, dec_kernel,
                                         dec_ref, get_api, DENSE_ARCHS)

    lap("14")

    # ---- 15. the reduced dense slices, card against CPU ---------------------
    dense_slice = {arch: slice_check(dev, card, get_api, arch, DENSE_SLICE_TOL[arch])
                   for arch in DENSE_ARCHS}

    lap("15")

    # ---- 16. main path: serve granite-3-2b at full width and depth ----------
    attn_counts = (flash_kernel.LAUNCHES, dec_kernel.LAUNCHES)
    dense_others = (kernel.LAUNCHES, ssd_kernel.LAUNCHES, scan_kernel.LAUNCHES)
    dense = {DENSE_ARCHS[0]: attention_serving(dev, card, serve, get_api,
                                               DENSE_ARCHS[0], GEN_TOKENS, attn_counts,
                                               zero_counts, dense_others, profile=True)}

    lap("16")

    # ---- 17. starcoder2-7b and qwen3-14b at full width and depth -------------
    for arch in DENSE_ARCHS[1:]:
        dense[arch] = attention_serving(dev, card, serve, get_api, arch,
                                        DENSE_OTHER_GEN, attn_counts, zero_counts,
                                        dense_others, profile=False)
    for arch, res in dense.items():
        res["slice_max_logit_err"] = dense_slice[arch]
        res["kernels"] = dense_rows[arch]
    print(json.dumps({"dense": dense}), flush=True)

    lap("17")

    # ---- 18. the MoE and VLM shapes: flash and decode against plain ---------
    from repro_torch.models import moe
    torch.cuda.empty_cache()
    mv_rows = attention_kernel_checks(dev, card, flash_kernel, flash_ref, dec_kernel,
                                      dec_ref, get_api, MOE_VLM_ARCHS)
    dense_rows.update(mv_rows)

    lap("18")

    # ---- 19. the reduced MoE and VLM slices, card against CPU ---------------
    mv_slice = {arch: moe_vlm_slice_check(dev, card, get_api, moe, arch, tol,
                                          attn_counts)
                for arch, tol in MOE_VLM_SLICE_TOL.items()}
    if not sum(sum(r["prefill_drops"]) for r in mv_slice.values()):
        raise AssertionError("no reduced MoE prefill dropped a token on the card: "
                             "the capacity path did not run there")

    lap("19")

    # ---- 20-21. main path: moonshot-v1-16b-a3b and internvl2-26b at full width
    moe_ranges = {"moe.router": (moe, "_router"), "moe.dispatch": (moe, "_dispatch"),
                  "moe.experts": (moe, "_experts"), "moe.combine": (moe, "_combine")}
    mv = {arch: {"slice": res} for arch, res in mv_slice.items()}
    for arch in MOE_VLM_ARCHS:
        moe_family = get_api(arch).cfg.family == "moe"
        mv[arch].update(attention_serving(
            dev, card, serve, get_api, arch, DENSE_OTHER_GEN, attn_counts, zero_counts,
            dense_others, profile=True, ranges=moe_ranges if moe_family else None),
            kernels=mv_rows[arch])
    print(json.dumps({"moe_vlm": mv}), flush=True)

    lap("20-21")

    # ---- 22. whisper-tiny's shapes: flash and decode against plain ----------
    from repro_torch.models.registry import build_api
    w_cfg = get_api(WHISPER).cfg
    w_rows = whisper_kernel_checks(dev, card, flash_kernel, flash_ref, dec_kernel,
                                   dec_ref, w_cfg)

    lap("22")

    # ---- 23. the reduced whisper slice, card against CPU ---------------------
    w_slice = whisper_slice_check(dev, card, get_api, build_api, attn_counts)

    lap("23")

    # ---- 24. main path: serve whisper-tiny at full width ---------------------
    whisper = attention_serving(dev, card, serve, get_api, WHISPER, WHISPER_GEN,
                                attn_counts, zero_counts, dense_others, profile=True,
                                prompt_len=WHISPER_PROMPT)
    whisper.update(slice=w_slice, kernels=w_rows)
    print(json.dumps({"whisper": whisper}), flush=True)

    lap("24")

    # ---- 25. the molecular-design campaign on the card and the CPU -----------
    moldesign = moldesign_phase(card, counters, zero_counts)
    print(json.dumps({"moldesign": moldesign}), flush=True)

    lap("25")

    # ---- 26. flash attention's lse and backward against their plain versions
    from repro_torch.distributed import steps as train_steps
    from repro_torch.launch import train as p_train
    from repro_torch.optim import adamw
    torch.cuda.empty_cache()
    fwd_lse_err, bwd_err = flash_bwd_checks(dev, card, flash_kernel, flash_ref)
    bwd_rows = {arch: flash_bwd_row(dev, card, flash_kernel, flash_ref, *shape,
                                    f"{arch} (h={shape[2]}, kv={shape[3]}, d={shape[4]})")
                for arch, shape in BWD_TIMED.items()}
    family_bwd_rows = {
        tag: flash_bwd_row(dev, card, flash_kernel, flash_ref, b, sq, h, kv, d,
                           f"{tag} (h={h}, kv={kv}, d={d})", sk=sk, causal=causal)
        for tag, (b, sq, sk, h, kv, d, causal) in BWD_TIMED_FAMILIES.items()}

    lap("26")

    # ---- 27. the reduced granite train slice, card against CPU ---------------
    train_slice = train_slice_check(dev, card, get_api, counters)

    lap("27")

    # ---- 28. main path: granite-3-2b trained at full width and depth ---------
    training = full_width_training(dev, card, p_train, train_steps, adamw, flash_kernel,
                                   counters, zero_counts, TRAIN_ARCH, TRAIN, keep_prints=True)
    mesh_free_prints = training.pop("fingerprint")
    training["slice"] = train_slice

    lap("28")

    # ---- 29. the reduced trainer's loss drop on the card ----------------------
    training["loss_drop"] = train_loss_drop(card, p_train)
    training["kernels"] = bwd_rows
    print(json.dumps({"training": training}), flush=True)

    lap("29")

    # ---- 30. the MoE, VLM and enc-dec train slices, card against CPU ---------
    family_slices = {
        arch: train_slice_compare(dev, card, get_api(arch, reduced=True),
                                  FAMILY_SLICE_TOL[arch], counters, 3, arch,
                                  last_from_cpu=arch == WHISPER)
        for arch in FAMILY_SLICE_TOL if arch not in SSM_ARCHS}
    family_slices["whisper-tiny full width"] = whisper_full_check(
        dev, card, get_api(WHISPER), flash_kernel, flash_kernel.LAUNCHES)
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.models import lm as lm_mod
    family_slices["whisper-tiny full width float32 gradient"] = whisper_f32_gradients(
        dev, card, get_api(WHISPER), flash_kernel, flash_ref, lm_mod, encdec_mod)

    lap("30")

    # ---- 31. main path: whisper-tiny trained at full width and depth ---------
    families = {WHISPER: full_width_training(
        dev, card, p_train, train_steps, adamw, flash_kernel, counters, zero_counts, WHISPER,
        WHISPER_TRAIN, stop=WHISPER_STOP, loss_falls=True)}

    lap("31")

    # ---- 32. moonshot-v1-16b-a3b and internvl2-26b at full width, 2 layers ---
    # (moonshot's trace splits the MoE's forward and backward into its four
    # parts; its recomputed routes are held to the forward's)
    for arch in WIDE_ARCHS:
        is_moe = get_api(arch).cfg.family == "moe"
        families[arch] = full_width_training(
            dev, card, p_train, train_steps, adamw, flash_kernel, counters, zero_counts, arch,
            WIDE_TRAIN, model_dims={"n_layers": WIDE_LAYERS},
            ranges_fn=(lambda: moe_backward_ranges(moe)) if is_moe else None,
            check=(lambda api, params, batch: moe_recompute_routes(
                moe, card, api, params, batch)) if is_moe else None)
    families["slices"] = family_slices
    families["kernels"] = family_bwd_rows
    print(json.dumps({"family_training": families}), flush=True)

    lap("32")

    # ---- 33. the SSD's and the fused scan's backward kernels -----------------
    torch.cuda.empty_cache()
    ssm_rows = ssm_bwd_checks(dev, card, ssd_kernel, ssd_ref, scan_kernel, scan_ref)
    ssm_flash_rows = {arch: flash_bwd_row(dev, card, flash_kernel, flash_ref, *shape,
                                          f"{arch} (h={shape[2]}, kv={shape[3]}, d={shape[4]})")
                      for arch, shape in SSM_FLASH_TIMED.items()}

    lap("33")

    # ---- 34. the reduced zamba2 and falcon-mamba train slices, card vs CPU ---
    ssm_slices = {arch: train_slice_compare(dev, card, get_api(arch, reduced=True),
                                            FAMILY_SLICE_TOL[arch], counters, 3, arch,
                                            steps_from_cpu=arch in SSM_STEPS_FROM_CPU)
                  for arch in SSM_ARCHS}
    for arch in SSM_STEPS_FROM_CPU:
        ssm_slices[arch]["free_running"] = slice_drift(
            dev, card, get_api(arch, reduced=True), scan_kernel, scan_ref)

    lap("34")

    # ---- 35. main path: zamba2-2.7b at full width and depth, falcon-mamba-7b
    # at full width with 8 layers
    ssm_training = {}
    for arch in SSM_ARCHS:
        ssm_training[arch] = full_width_training(
            dev, card, p_train, train_steps, adamw, flash_kernel, counters, zero_counts, arch,
            SSM_TRAIN[arch], stop=SSM_STOP.get(arch), stop_dims=SSM_STOP_DIMS.get(arch),
            model_dims={"n_layers": SSM_LAYERS[arch]} if arch in SSM_LAYERS else None,
            watch=SSM_WATCH)
    ssm_training["slices"] = ssm_slices
    ssm_training["kernels"] = {**ssm_rows, "flash": ssm_flash_rows}
    print(json.dumps({"ssm_training": ssm_training}), flush=True)

    lap("35")

    # ---- 36. the fleet: granite's jobs placed by Cluster MHRA on the card,
    # trained at full width through a leave and a resume, and served
    dryrun_dir, counted = dryrun_results(dryrun_proc, dryrun_out, card)
    fleet = fleet_phase(card, p_train, kernel, counters, zero_counts, dryrun_dir)
    print(json.dumps({"fleet": fleet}), flush=True)

    lap("36")

    # ---- 37. the dry-run's count of the timed train steps against the card --
    checked = count_check(card, counted, {TRAIN_ARCH: training, **ssm_training})
    print(json.dumps({"dryrun_check": checked}), flush=True)

    lap("37")

    # ---- 38. the sharded trainer: granite-3-2b under a (1, 1) host mesh,
    # then each kernel under the sharded path's layouts, rank by rank
    sharded = {"training": sharded_training(dev, card, p_train, train_steps, adamw, counters,
                                            zero_counts, training, mesh_free_prints),
               "kernels": sharded_kernel_checks(dev, card, flash_kernel, ssd_kernel,
                                                scan_kernel)}
    print(json.dumps({"sharded": sharded}), flush=True)

    lap("38")
    served = {**dense, **mv}
    for arch in DENSE_ARCHS + MOE_VLM_ARCHS:
        for name, source, line in (
                ("flash_attention", FLASH_SOURCE,
                 "src/repro/kernels/flash_attention/kernel.py:23"),
                ("decode_attention", DECODE_SOURCE,
                 "src/repro/kernels/decode_attention/kernel.py:21")):
            r = dense_rows[arch][name]
            kernels.append({
                "name": f"{name}/{arch}", "route": "cuda", "source": source,
                "replaces": line, "model": arch, "shape": r["shape"],
                "launches": served[arch]["launches"][name], "max_abs_err": r["err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # whisper's rows: the largest shape of each kernel on the path (the
    # encoder's flash, the cross-decode) at the top level, every shape in
    # "shapes"
    for name, source, line, main_shape in (
            ("flash_attention", FLASH_SOURCE,
             "src/repro/kernels/flash_attention/kernel.py:23", "encoder"),
            ("decode_attention", DECODE_SOURCE,
             "src/repro/kernels/decode_attention/kernel.py:21", "cross")):
        shapes = {k.split("/", 1)[1]: v for k, v in w_rows.items()
                  if k.startswith(name + "/")}
        r = shapes[main_shape]
        kernels.append({
            "name": f"{name}/{WHISPER}", "route": "cuda", "source": source,
            "replaces": line, "model": WHISPER, "shape": r["shape"],
            "launches": whisper["launches"][name],
            "max_abs_err": max(v["err"] for v in shapes.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shapes": {k: {f: v[f] for f in ("shape", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "err")}
                       for k, v in shapes.items()}})
    # the trainer's rows: the backward at granite's microbatch (the main
    # path) and at qwen3's head_dim 128 (not on a path), and the forward
    # with the lse at granite's microbatch
    for arch, rows in bwd_rows.items():
        r = rows["flash_attention_bwd"]
        kernels.append({
            "name": f"flash_attention_bwd/{arch}", "route": "cuda",
            "source": BWD_FLASH_SOURCE, "instance": r["instance"],
            "replaces": "src/repro/kernels/flash_attention/kernel.py:23",
            "model": arch, "shape": r["shape"],
            "launches": training["launches"]["flash_attention_bwd"]
            if arch == TRAIN_ARCH else 0,
            "max_abs_err": max(bwd_err, r["err"]), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the backward at the new families' shapes, with their launches in the
    # main paths' runs (whisper's by shape)
    bwd_launches = {
        "whisper-tiny encoder": families[WHISPER]["bwd_launches_by_shape"].get(
            "1500x1500 non-causal", 0),
        "whisper-tiny cross": families[WHISPER]["bwd_launches_by_shape"].get(
            "448x1500 non-causal", 0),
        "internvl2-26b": families["internvl2-26b"]["launches"]["flash_attention_bwd"]}
    for tag, rows in family_bwd_rows.items():
        r = rows["flash_attention_bwd"]
        kernels.append({
            "name": f"flash_attention_bwd/{tag}", "route": "cuda",
            "source": BWD_FLASH_SOURCE, "instance": r["instance"],
            "replaces": "src/repro/kernels/flash_attention/kernel.py:23",
            "model": tag.split()[0], "shape": r["shape"], "causal": r["causal"],
            "launches": bwd_launches[tag], "max_abs_err": max(bwd_err, r["err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    r = bwd_rows[TRAIN_ARCH]["flash_attention (lse)"]
    kernels.append({
        "name": f"flash_attention/{TRAIN_ARCH}-train", "route": "cuda",
        "source": FLASH_SOURCE, "replaces": "src/repro/kernels/flash_attention/kernel.py:23",
        "model": TRAIN_ARCH, "shape": r["shape"],
        "launches": training["launches"]["flash_attention"],
        "max_abs_err": max(fwd_lse_err, r["err"]),
        "ms": r["ms"], "ms_without_lse": r["ms_without_lse"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"]})
    # the hybrid and ssm trainers' backward kernels, timed at their
    # microbatches, with their launches in phase 35's runs
    for name, source, line, arch in (
            ("ssd_bwd", SSD_BWD_SOURCE, "src/repro/kernels/ssd/kernel.py:26", "zamba2-2.7b"),
            ("mamba1_scan_bwd", SCAN_BWD_SOURCE,
             "src/repro/kernels/selective_scan/kernel.py:23", "falcon-mamba-7b")):
        r = ssm_rows[name]
        kernels.append({
            "name": f"{name}/{arch}", "route": "cuda", "source": source, "replaces": line,
            "model": arch, "shape": r["shape"],
            "launches": ssm_training[arch]["launches"].get(name, 0),
            "max_abs_err": r["max_abs_err"], "err_over_bound": r["err"], "ms": r["ms"],
            "forward_ms": r["forward_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None})
    # flash at zamba2's training shape (head_dim 80; the backward on the
    # wgmma kernel), with its launches in phase 35's run
    for arch, rows in ssm_flash_rows.items():
        for name, tag in (("flash_attention_bwd", "flash_attention_bwd"),
                          ("flash_attention", "flash_attention (lse)")):
            r = rows[tag]
            kernels.append({
                "name": f"{name}/{arch}-train", "route": "cuda",
                "source": BWD_FLASH_SOURCE if name.endswith("bwd") else FLASH_SOURCE,
                "replaces": "src/repro/kernels/flash_attention/kernel.py:23",
                "model": arch, "shape": r["shape"],
                **({"instance": r["instance"]} if "instance" in r else {}),
                "launches": ssm_training[arch]["launches"].get(name, 0),
                "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]})
    print(json.dumps({"phase_s": phase_s, "total_s": sum(phase_s.values())}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-counts"]:
        sys.exit(dryrun_counts(sys.argv[2]))
    sys.exit(main())
