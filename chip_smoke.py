"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
 1. device: the card's name and power limit (nvidia-smi);
 2. build: K1 (src/repro_torch/csrc/potq_matmul.cu), K2/K3 and their
    G pre-pass (src/repro_torch/csrc/potq_grad.cu) and K4
    (src/repro_torch/csrc/potq_encode.cu) with nvcc for sm_90a, one nvcc
    process per source, started together;
 3. K1 against its plain PyTorch version on the card, bit for bit
    (torch.equal), at the serving shapes of llama3-8b (decode M = 4,
    prefill M = 128, a verify pass M = 16 at 5 bits, the lockstep wave's
    batched prefill M = 512 = 4 x 128 under one activation scale, a
    self-draft step M = 4 at 3 bits) and of mistral-nemo-12b and
    starcoder2-7b (M = 4
    and 128 at each linear's (K, N)), both modes, and at
    the edges of its paths (kernels/potq_matmul.py ``plan``): M from 1 to
    4100 across the decode threshold and the tensor cores' 128-row tile,
    split and unsplit grids, K and N off 128, off 32 and off 8 (rows not
    16-byte aligned: the scalar loads), a subnormal row, an all-zero row
    and a lattice-extreme operand set at the 5 x 5 pair; and the MoE
    decoders (``moe_k1_checks``): each llama4-scout and grok-1 linear at
    M = 4 and, but the head, at a chunk step's M = 128 (among them the
    routers (5120, 16) and (6144, 8), ragged N), and the
    expert-batched launch equal to its plain version and to E
    single-expert launches at llama4-scout's experts (E = 16, (5120,
    8192) and (8192, 5120), M = 4, 12, 16 and 40) and grok-1's (E = 8,
    (6144, 32768) and (32768, 6144), M = 16 and 48), a decode step's
    rows with capacity padding (zero rows between the real ones); and
    the vlm and encdec configs (``family_k1_checks``): every linear of
    internvl2-76b and whisper-large-v3 at decode (M = 4) and, but the
    head, at a chunk step's M = 128, internvl2's at its solo prefill's
    M = 384 and its patch_proj (3200, 8192) at the 256 patch rows,
    whisper's encoder side (frame_proj (128, 1280), the encoder layers,
    the cross K/V) at M = 1500; and the recurrent configs: every linear
    of mamba2-2.7b (in_proj (2560, 10576), N off 32; out_proj (5120,
    2560); the head (2560, 50688)) and recurrentgemma-2b ((2560, 2560),
    (2560, 256), (2560, 7680), (7680, 2560), the head (2560, 256000)) at
    M = 1 (a request decoding alone; a prefill's last row into the head)
    and M = 4, and but the head at their solo prefill's M (512, 128);
 4. timing at the serving shapes: kernel, plain version, torch.matmul on
    the same bf16 operands (yardstick only), and the roofline bound,
    summed over one llama3-8b decode weight pass (M = 4), prefill (M =
    128), verify pass (M = 16), self-draft step (M = 4, 3 bits) and
    lockstep wave prefill (M = 512), and over one decode weight pass and
    one prefill of each other config, and one decode weight pass of each
    MoE decoder at phases 26-27's depth (its experts at 16 rows, through
    the expert-batched launch; ``torch.bmm`` their yardstick), and over
    internvl2's decode weight pass and solo prefill and whisper's decode
    weight pass and encoder-side pass, and each recurrent model's decode
    weight pass and solo prefill (``family_k1_timing``, with their FP64
    tensor-core bounds);
 5. serve: llama3-8b at full width (random weights from seed 0) through
    PoolEngine on an 8-request Poisson trace; K1 must launch exactly
    once per linear per weight pass (``k1_per_pass``: 225 for
    llama3-8b, 281 for mistral-nemo-12b, 193 for starcoder2-7b);
 6. pool vs solo: two requests served alone give the same tokens;
 7. CUDA vs CPU: a smoke-width model agrees within the CPU tests' logit
    tolerance;
 8. K2/K3 against their plain versions on the card, bit for bit (dA, the
    dgamma rows, dgamma, dW), and the G pre-pass against its plain version
    (``_quantize_g``), at the four olmo-1b training shapes with M = 4096,
    PRC on and off, bits_g 5 (6 at the LM head), a ragged shape and G with
    subnormal and zero entries, shapes off every edge of the kernels'
    tiling (128 x 128 block tiles, 32-wide slices, k-steps of 8, rows not
    16-byte aligned), one below one tile, and a lattice-extreme set whose
    products reach both ends of the 52-bit chunk lattice at the head's
    6 x 5 pair; K1 bit for bit at the four training shapes, one activation
    scale, as the training forward runs it; and llama4-scout's training
    shapes: an expert's 320 rows (8 groups x capacity 40) at (5120, 8192)
    and (8192, 5120), its router (5120, 16) at M = 4096, PRC on and off;
 9. timing of K1/K2/K3 and the pre-pass at the training shapes: kernel,
    plain version, torch.matmul on the same bf16 operands (yardstick
    only), the roofline bound and, for K1/K2/K3, the bound of their
    datapath (the FP64 tensor cores); K2's rows include its pre-pass;
    K2/K3 and the pre-pass also at one llama4-scout expert's training
    shapes (M = 320, PRC on), apart from olmo-1b's step sums;
10. train olmo-1b at full width (random weights from seed 0, AdamW,
    batch 8 x seq 512) through ``repro_torch.launch.train.main``: 1
    warm-up + 3 steps, the losses printed with repr; K1/K2/K3/pre-pass
    launch counts per step must be 225/113/113/113 (K1: 113 forward + 112
    recomputed); one more step profiled;
11. determinism: one step run twice from the same state is bit-equal;
12. training CUDA vs CPU at smoke width, within the CPU tests' tolerances;
13. K4 (src/repro_torch/csrc/potq_encode.cu) against its plain version on
    the card, bit for bit: the four olmo-1b pack shapes and ragged shapes
    at bits 4/5/6, with zeros of both signs, subnormals, values at and
    above emax, mantissas on both sides of √2/2, NaN and ±inf, and betas
    whose scale 2^-beta is not a normal float; decompress(codes, beta)
    equals pot_quantize(x, bits, beta);
14. K4 timing at the pack shapes: kernel, plain version, ``x.to(int8)``
    (a bytes yardstick, not the same function) and the bytes bound;
15. checkpoint and restart at full width (olmo-1b at ``CKPT_LAYERS`` = 2
    of its 16 layers, 4 until phase 37q, batch 8 x seq 512, through
    ``launch.train.main`` and a checkpoint directory made with tempfile,
    15 GB free required): run A trains 2 steps and saves; run B
    (--steps 3) restores step 2 and runs step 2 only; run C trains 3 steps
    uninterrupted; B's params and AdamW m/v equal C's bit for bit; save
    and restore seconds and GB/s;
16. pack run B's served weights to int8 (K4: 8 launches), store the packed
    tree with CheckpointManager, restore, unpack, count per linear leaf
    the elements that differ from the served tree, and serve a 4-request
    trace from the unpacked and from the served tree (equal tokens where
    no element differs);
17. CUDA vs CPU at smoke width: pack_int8 code for code and beta for
    beta; checkpoints written from one device restore on the other;
19. chunked + paged serving at llama3-8b's widths and 2 of its layers
    (``PAGED_LAYERS``: 8 since phase 37 took the script to 980.6 s, 4
    from phase 37q, 2 since 37r; the serve cell's weights and trace): engine A (4 slots, chunk 32, page 16) is the main
    path, its launch counts set to 0 just before and read just after; B
    (page = span) and C (each request alone, chunk 32) give A's tokens bit
    for bit; A's counters (weight passes, decode steps, prefills, emitted
    tokens, per-request TTFT in passes, admission deferrals) equal a CPU
    run of the port at smoke width on the same requests (token ids modulo
    the smoke vocab); a chunk-step decode row equals ``decode_step`` in
    logits and cache bytes; K1 launches once a linear (15 at 2 layers)
    per chunk step and per decode step; tokens/s, TTFT in passes and ms, chunk- and decode-step
    wall times, one profiled chunk step (M = 128);
20. the prefix cache at phase 19's depth (shared_prefix_trace: 8 requests,
    prefix 96 + suffix 32): prefix on gives prefix off's tokens bit for
    bit, a hit rate above 0, fewer weight passes and a lower mean TTFT,
    and both runs' counters (prefix hits, copies on write and evictions
    included) equal the CPU smoke-width run's;
21. PoT-quantized KV pages (``KV_PINNED``) on phase 19's engine and trace,
    at llama3-8b's widths and 2 of its layers (``KVQ_LAYERS``, to keep
    the script inside its time limit; 8 before phase 37p, 4 before 37r): A (page 16) is the
    main path; B (page = span) and C (each request alone) give A's tokens
    bit for bit; A's counters equal the CPU smoke-width run's;
    ``kv_page_bytes`` is 33,024 (528,384 at 32 layers); a chunk-step
    decode row equals ``decode_step`` in logits and every cache leaf
    (codes and betas); K1 launches 15 times per weight pass; tokens/s, TTFT, KV bytes per token
    beside phase 19's bf16 figure at that depth, peak memory, a profiled
    decode step;
22. speculative decoding on the same engine at llama3-8b's widths and
    1 of its layers (``SPEC_LAYERS``; 4 before phase 37p, 2 before 37r): ``NgramDrafter(3)``
    and ``LowBitSelfDraft(3, 3)`` over bf16 pages and the self-draft over quantized pages give the
    tokens of their spec-off runs at that depth, bit for bit, in no more
    weight passes; K1 launches once a linear per verify pass and per
    draft step; at that depth too (all 32 layers until PR 22), a verify
    pass over 4 slots x 4 positions (one row across a page) equals 4
    sequential ``decode_step`` calls in logits and every cache leaf, over
    bf16 and quantized pages; weight passes, accepted tokens, draft
    passes, tokens/s, a profiled verify pass and draft step, and the
    draft's weight re-quantizations timed alone;
23. lockstep serving and float32 pages at llama3-8b's widths and
    ``LOCKSTEP_LAYERS`` (4) of its layers (32, then 8 before), on the
    serve trace's first 4 requests: ``lockstep_generate`` serves them as
    one wave (one batched prefill, then lockstep steps to the longest
    output; 29 K1 launches a weight pass); request 0 by batch-1
    lockstep equals its tokens from a solo-prefill pool (page 16), bit
    for bit; a ``cache_dtype=torch.float32`` chunked (32) + paged (16)
    engine gives each request's tokens alone, its counters equal the CPU
    smoke-width run's and ``kv_page_bytes`` is twice bf16's;
24. mistral-nemo-12b and 25. starcoder2-7b at full width and 4 of their
    40 and 32 layers (``OTHER_LAYERS``; 8 before phase 37r; weights from seed 0,
    llama3-8b's freed first), each through phase 19's engine on
    ``poisson_trace(4 requests, prompt 128, lam 2.0, 8-16 new, seed 0)``:
    A is the main path (its implicit host syncs counted under PyTorch's
    sync debug mode); C (each request alone) gives A's tokens bit for
    bit; A's counters equal the CPU smoke-width run's; K1 launches 57 /
    49 times a weight pass; a chunk-step decode row equals
    ``decode_step``; tokens/s, TTFT, chunk- and decode-step wall times
    and one profiled decode step (K1's device time beside its bytes
    bound);
26. llama4-scout-17b-a16e (16 experts top-1 + a shared expert) at its
    published widths and 8 of its 48 layers, and 27. grok-1-314b (8
    experts top-2, gelu) at 2 of its 64, each through phase 24's engine,
    trace and gates (A = C, counters = the CPU smoke-width run's, no
    implicit host sync, a chunk-step decode row = ``decode_step``); K1
    launches 89 / 15 times a weight pass (the experts one expert-batched
    launch per expert matrix); the weights' parameter count, seconds,
    held and peak GiB (phase 26's peak under ``MOE_PEAK_GIB``);
28. MoE training at smoke width, both MoE decoders: three AdamW steps on
    the card against the CPU (losses, the first step's gradients), the
    last step run twice bit for bit, and its K1/K2/K3/pre-pass launches
    equal to ``step_launches`` (the experts' backward once per expert);
29. internvl2-76b (vlm) at its published widths and ``VLM_LAYERS`` (8;
    16 before phase 37r) of its 80 layers, and 30. whisper-large-v3
    (encdec) at full width, ``ENCDEC_LAYERS`` (4; 8 before phase 37r) of
    its 32 decoder layers and the whole encoder, through
    phase 24's engine and gates (A = C, counters = the CPU smoke-width
    run's, no implicit host sync, a chunk-step decode row =
    ``decode_step``, peak under ``MOE_PEAK_GIB``): internvl2's requests
    carry 256 patch embeddings of 3200 (max_len 400) and solo-prefill,
    K1 57 a weight pass and one patch_proj more a prefill; whisper
    serves ``ENCDEC_TRACE`` (prompt 16, 16-32 new, 1500 x 128 frames,
    max_len 64), each admission one encoder-side pass
    (``registry.encode_cross_kv``), K1 33 a decode or chunk pass and 201
    an encoder-side pass (257 each at all 32 decoder layers); the
    encoder-side pass timed and profiled against its FP64 tensor-core
    bound;
31. (a) internvl2-76b and whisper-large-v3 training at smoke width as
    phase 28 (CUDA against CPU losses within ``FAMILY_LOSS_RTOL``); (b)
    whisper-large-v3 at full width and ``WHISPER_TRAIN_LAYERS`` (8) of
    its 32 encoder and 32 decoder layers (all of them before phase 37q)
    through ``launch.train.main``, batch 2 x 1500 frames x 448 tokens, 3
    AdamW steps with recomputation: finite losses printed with repr,
    258/130/130/130 launches a step (1026/514/514/514 at 32 + 32), peak
    GiB, a profiled step (K1, K2, K3 device ms beside their FP64
    tensor-core bounds) and one step run twice bit for bit;
32. mamba2-2.7b (ssm) and 33. recurrentgemma-2b (hybrid: RG-LRU and
    local attention) at full width and ``RECURRENT_SERVE_LAYERS`` (8 of
    64, 6 of 26) layers (all of them before phase 37r; weights from seed
    0, drawn leaf by leaf into served form) through ``PoolEngine(max_slots=4)`` on
    the slot-row pool (no pages; solo-prefill admissions) on
    ``RECURRENT_TRACE`` (4 requests, 8-16 new; prompts of 512 and 128):
    A is the main path (no implicit host sync by the port); C (each
    request alone) gives A's tokens bit for bit; A's counters equal the
    CPU smoke-width run's; K1 launches 17 / 47 times a weight pass, in
    a solo prefill and in a decode step; tokens/s, TTFT in passes and ms,
    prefill and decode-step wall times, one profiled decode step (kernels,
    K1 device ms beside its bytes bound, idle share), the state bytes a
    slot, peak under ``MOE_PEAK_GIB``;
34. mamba2-2.7b and recurrentgemma-2b training at smoke width as phase
    28 (CUDA against CPU losses within ``FAMILY_LOSS_RTOL``, a step twice
    bit for bit, launches a step);
35. the paper's CNN (``models/cnn.py``: every conv an im2col product, the
    head a linear; ``examples/cnn_classification_torch.py``): (a) K1, the
    G pre-pass, K2 and K3 against their plain versions bit for bit at
    every (M, K, N) of both cells (``CNN_CELLS``: width 16, 16 x 16
    images, batch 64; width 64, 64 x 64, batch 256), under
    ``PAPER_FAITHFUL`` and the example's ``BITS444``; (b) their times
    there (CUDA events, L2 flushed) beside the plain versions,
    ``torch.matmul`` on the same bf16 operands, the roofline and FP64
    tensor-core bounds, summed over one step of each cell; (c)
    ``train_cnn`` at width 16 for 120 steps under FP32, 5/5/5 and 4/4/4
    (the main path: launches counted from 0 around each run, 7/7/7/7 a
    quantized step, 0 under FP32; accuracy at least ``CNN_MIN_ACCURACY``;
    step ms; one profiled step); (d) 3 steps on CUDA and on the CPU from
    the same state (losses within ``LOSS_RTOL``, the first step's
    gradients within ``GRAD_RTOL`` of each leaf's largest); (e) one step
    twice, bit for bit; (f) width 64, 3 steps and one profiled (K1-K3
    device ms, peak under ``CNN_PEAK_GIB``);
36. ``quantize_attention`` (attention products through ``mf_act_dot``):
    (a) olmo-1b, whisper-large-v3 and recurrentgemma-2b training at smoke
    width as phase 28 (losses within ``LOSS_RTOL``); (b) one olmo-1b step
    at full width from phase 10's state (after phase 11), timed and
    profiled beside phase 10's; (c) phase 5's engine and trace at
    llama3-8b's widths and ``SPEC_LAYERS`` layers (after phase 23): K1
    once a linear a weight pass, each request alone gives its pooled
    tokens;
37. multi-GPU on ``torch.distributed``: two ranks spawned on the one card
    (gloo: ranks share the card), the parent holding no model meanwhile
    (``multi_gpu``): 37a llama3-8b at full width and ``TP_SERVE_LAYERS``
    (2) layers on the (1, 2) mesh through phase 5's engine and trace
    against one rank (tokens and counters, K1 once a linear shard a
    weight pass on each rank, row-parallel folds counted, tokens/s, a
    decode step's wall and device times, each rank's weight bytes, the
    collectives' share),
    37b the (2, 1) mesh at 2 layers against one rank, 37c olmo-1b at its
    published widths and ``DP_TRAIN_LAYERS`` (2) of its 16 layers
    data-parallel at batch 4 x 512, 2 steps, against one rank (first-step
    per-token losses bit for bit, launches a step, peaks), 37d
    ``compressed_psum`` on CUDA tensors; 37e grok-1-314b at its published
    widths and 2 of 64 layers on the (1, 2) mesh with EP (4 experts a
    rank), phase 27's seed, engine and trace (tokens = phase 27's, K1 15
    a weight pass a rank, 2 folds a pass, each rank's weight bytes and
    peak, the ranks' summed peak under ``MULTI_PEAK_GIB``), 37f
    llama4-scout-17b-a16e the same way (8 experts a rank, the shared
    expert folded) against one rank at 2 layers (tokens and counters
    equal), 37g both MoE smoke configs data-parallel on (2, 1) at batch
    4 x 256 against one rank (first-step per-token losses bit for bit,
    launches a step equal), 37h internvl2-76b at its published widths and
    ``VLM_LAYERS`` layers on (1, 2) through phase 29's engine and trace
    (tokens = phase 29's, K1 57 a weight pass a rank and one patch_proj
    a solo prefill, 16 folds a pass), 37i whisper-large-v3 at
    ``ENCDEC_LAYERS`` decoder layers and the whole encoder on (1, 2)
    through phase 30's (tokens = phase 30's, K1 65 a decode pass and 209
    an encoder-side pass a rank, 24 and 64 folds, 10 of the 20 (cross)
    K/V heads a rank), 37j whisper on (2, 1) at ``ENCDEC_DP_LAYERS``
    decoder layers against one rank, 37k the vlm and encdec smoke configs
    data-parallel on (2, 1) against one rank (as 37g, 3 steps, their
    launches a step ``step_launches``'), 37l mamba2-2.7b at its published
    widths and ``SSM_PLAN_LAYERS`` (8) of 64 layers on (1, 2) (40 of the
    80 SSD heads a rank, out_proj folding over their 2560 channels)
    through phase 32's engine and trace against one rank at that depth,
    and on (2, 1) against that run (tokens and counters equal, K1 17 a
    weight pass a rank, 8 folds a pass on (1, 2), no implicit host sync
    outside the collectives; tokens/s, a decode step's wall and device
    ms a rank, the collectives' share, each rank's weight bytes and
    peak), 37m recurrentgemma-2b at ``HYBRID_PLAN_LAYERS`` (6) of 26 layers
    the same way through phase 33's (RG-LRU channels, MLP, q heads and the
    vocabulary split, the one K/V head whole; K1 47 a pass a rank, 12
    folds), 37n both recurrent smoke configs and mamba2-2.7b at its
    published widths and ``SSM_DP_LAYERS`` (2) layers at batch 2 x 512
    data-parallel on (2, 1) against one rank (as 37k), 37o (a) olmo-1b at
    its published widths and ``TP_TRAIN_LAYERS`` (2) of its 16 layers
    tensor-parallel on (1, 2) (K2 chained across the ranks) at batch 4 x
    512, AdamW, remat, 2 steps, against one rank at that depth (first-step
    per-token losses and every gradient leaf's shard bit for bit, the
    second loss within ``LOSS_RTOL``, K1 / K2 / K3 / pre-pass 29 / 15 / 15
    / 15 a step a rank, 8 forward folds and 15 backward chains a step,
    no implicit host sync outside the collectives; step seconds, the
    collectives' share, master and optimizer bytes and device busy a step
    a rank, and the seconds of the shadow alone and of the shadow and the
    forward), and (b) olmo-1b's smoke config on (2, 2), four ranks spawned
    on the card, 4 x 64, 3 steps, against one rank (first-step per-token
    losses bit for bit, losses within ``LOSS_RTOL``, launches a step a
    rank), 37p (a) whisper-large-v3 at its published widths and
    ``ENCDEC_TP_TRAIN_LAYERS`` (2) of its 32 encoder and 32 decoder layers
    tensor-parallel on (1, 2) at phase 31b's batch (2 x 448 tokens, 1500
    frames), AdamW, remat, 2 steps, against one rank at that depth with
    37o (a)'s gates (K1 / K2 / K3 / pre-pass 66 / 34 / 34 / 34 a step a
    rank, 20 forward folds and 32 backward chains, ``tp_step_folds``),
    (b) internvl2-76b's smoke config on (1, 2) (its one K/V head selected
    from a whole product; the attention's backward whole on every rank)
    with the same gates, 3 steps at 4 x 64, and (c) internvl2-76b's and
    whisper-large-v3's smoke configs in 37o (b)'s four-rank world with its
    gates (``_tp_smoke_rank``, ``TP_SMOKE_ARCHS``), 37q (a)
    llama4-scout-17b-a16e at its published widths and
    ``MOE_TP_TRAIN_LAYERS`` (1) of its 48 layers on (1, 2) under EP (8 of
    16 experts a rank), batch 2 x 512 (two dispatch groups), remat, the
    first step only (its per-token losses and gradients, no optimizer
    state), against one rank run on rank 0 of 37o (b)'s four-rank world
    before its cells (no collective runs in it; it leaves the losses and
    a sha256 of each gradient leaf's shard a rank): per-token losses and every gradient
    leaf's shard bit for bit, K1 / K2 / K3 / pre-pass 23 / 33 / 33 / 33 a
    rank (``tp_step_launches``), 4 forward folds, 8 backward chains and 3
    owner selections (``tp_step_folds``), no implicit host sync outside
    the collectives; step seconds, the collectives' share and MiB, device
    busy a rank and each run's peak; (b) grok-1-314b's smoke config (EP)
    and the 3-expert grok-1 (TP experts) at smoke width and at
    ``GROK3_CHUNKED_FF`` (each expert's K2 chained) on (1, 2) with 37p
    (b)'s gates, 3 steps at 4 x 64; (c) llama4-scout's and grok-1's smoke
    configs in 37o (b)'s four-rank world at 4 x 256 (``TP_SMOKE_SEQS``:
    whole dispatch groups a data rank) with its gates; 37r (a)
    mamba2-2.7b at its published widths and ``SSM_TP_TRAIN_LAYERS`` (4) of
    its 64 layers on (1, 2) (40 of 80 SSD heads a rank; under autograd
    every rank runs the conv, the SSD and out_norm whole, in_proj's dA
    over G and Wq gathered and placed by its index-set pieces), batch 4 x
    512, AdamW, remat, 2 steps, against one rank run as 37q (a)'s:
    per-token losses and every gradient leaf's shard
    (sha256) bit for bit, the step losses within ``LOSS_RTOL``, K1 / K2 /
    K3 / pre-pass 17 / 9 / 9 / 9 a step a rank, 8 forward folds, 5
    backward chains and 4 backward gathers a step (``tp_step_folds``,
    ``tp_step_gathers``), no implicit host sync outside the collectives;
    (b) recurrentgemma-2b at its published widths and
    ``HYBRID_TP_TRAIN_LAYERS`` (3) of its 26 layers on (1, 2) (1280 RG-LRU
    channels, 3840 MLP columns, 5 q heads and 128000 vocabulary rows a
    rank; the RG-LRU whole on every rank under autograd), batch 2 x 512,
    the first step's losses and gradients alone, with (a)'s gates (47 / 24
    / 24 / 24; 12 folds, 22 chains, no gather); (c) both smoke configs and
    their ``RECURRENT_WIDE`` widenings on (1, 2) with 37p (b)'s gates and
    their gathers; (d) both smoke configs in 37o (b)'s four-rank world
    with its gates; 37s llama3-8b's serving options on a plan at its
    published widths through phase 19's engine (chunked 32 + paged 16)
    and ``OPTION_TRACE`` (4 requests, prompts of 64, 4-8 new tokens),
    each against one rank in the same world: (a)
    ``SPEC_PLAN_LAYERS`` (2) layers on (1, 2) with ``KV_PINNED`` pages and
    the 3-bit self-draft (each weight shard rounded with its whole
    matrix's statistics; spec on = spec off on the plan), (b) the same
    engine on (2, 1) with the n-gram drafter, (c) ``OPTION_LAYERS`` (1)
    layer on (1, 2) under ``quantize_attention``, (d) the same under the
    FP32 baseline (a fresh pool's decode step's logits within
    ``FP32_LOGIT_RTOL`` of one rank's, the ranks' equal): tokens and every
    counter (accepted tokens, draft passes, KV bytes a token) equal one
    rank's, K1 once a linear shard a weight pass and a draft step (none
    under FP32), the folds, no implicit host sync outside the
    collectives; tokens/s, wall, a decode step's device ms and gloo bytes
    beside the card's name and power limit; each sub-phase's seconds
    printed, and its summed peak under ``MULTI_PEAK_GIB``; phase 3
    also holds K1's ``start`` variant (the row-parallel fold) at
    llama3-8b's, whisper's, internvl2's, mamba2's and recurrentgemma's
    row-parallel shapes (``START_CASES``) and times
    it beside the unstarted half, and phase 8 K2's (``k2_start_checks``:
    olmo-1b's column-parallel dA chained over the two ranks' N at 37o's
    rows, the row-parallel dgamma rows chained over their K, a ragged
    three-rank case; bit for bit against the unsplit launch and the plain
    chain, the last rank's launch timed beside the same launch without
    its start);
18. the ``kernels`` JSON line, then the device line (phase 18 runs last;
    32-33 run after 30, 34 after 31, 35-36a after 34, 37 after 35-36).

Per-shape details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the trainer runs with deterministic algorithms, which need a fixed cuBLAS
# workspace from the first cuBLAS call on (phase 4 makes it)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# H100 SXM published peaks (NVIDIA data sheet), the roofline's two terms
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the FP64 tensor cores, K1's, K2's and K3's datapath (same data sheet)
PEAK_FP64_TC_FLOPS = 67e12
LOGIT_ATOL = 1e-3  # tests/test_torch_serve.py's tolerance
# tests/test_torch_train.py's tolerances (port vs reference on the CPU)
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6
SERVE_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128512)]
# The seconds quoted in the depth constants' comments below are this
# script's phases on one NVIDIA H100 80GB HBM3 at 700.00 W (a "slow host"
# ran the same phases 22-32% longer than another; PERF.md section 6).
# the other dense decoders, served at full width in phases 24-25; phase 3
# checks K1 at their linears' (K, N), phase 4 times their weight passes
OTHER_ARCHS = ("mistral-nemo-12b", "starcoder2-7b")
# phases 24-25's depth: mistral-nemo-12b at 4 of its 40 layers (52 s at
# 40 on an H100) and starcoder2-7b at 4 of its 32 (39 s at 32); 8 from
# phase 37o until phase 37r took the room (14.1 and 13.9 s at 8 of a slow
# host's 951.8 s)
OTHER_LAYERS = {"mistral-nemo-12b": 4, "starcoder2-7b": 4}
# the serving shapes of speculative decoding: a verify pass scores 4 slots x
# 4 positions (max_draft 3), a self-draft step runs decode at 3 bits
VERIFY_M, DRAFT_BITS = 16, 3
# the MoE decoders, served in phases 26-27 at their published widths and
# this depth (all their layers do not fit one card): llama4-scout 8 of 48,
# grok-1 2 of 64
MOE_ARCHS = {"llama4-scout-17b-a16e": 8, "grok-1-314b": 2}
# phase 3 holds the expert-batched K1 at these rows an expert: llama4-scout
# one slot's capacity (4), a 128-token solo prefill's (12), a decode step's
# 4 slots x 4 (16, the capacity padding zero between the real rows) and a
# 512-token group's (40); grok-1 a decode step's 16 and 48
MOE_EXPERT_M = {"llama4-scout-17b-a16e": (4, 12, 16, 40), "grok-1-314b": (16, 48)}
# phase 8: llama4-scout's experts at training (8 groups of 512 tokens,
# capacity 40: 320 rows an expert), PRC on and off, and its router; phase
# 9 times the experts' shapes, launches an expert of one layer (gate and
# up, down)
MOE_TRAIN_M = 320
MOE_TRAIN_COUNTS = {(5120, 8192): 2, (8192, 5120): 1}
MOE_GRAD_CASES = ([(MOE_TRAIN_M, kk, nn, 5, prc, "random") for kk, nn in MOE_TRAIN_COUNTS
                   for prc in (True, False)]
                  + [(8 * 512, 5120, 16, 5, prc, "random") for prc in (True, False)])
# phase 23's lockstep wave prefills 4 requests of 128 tokens as one batch:
# K1 sees (4 x 128, K) rows under one activation scale (per tensor)
LOCKSTEP_PREFILL_M = 4 * 128
# olmo-1b training: (K, N) of each linear and its launches per step (16
# layers: wq/wk/wv/wo, wi_gate/wi_up, mlp wo; then the LM head, 6-bit G)
TRAIN_M = 8 * 512
TRAIN_COUNTS = {(2048, 2048): 64, (2048, 8192): 32, (8192, 2048): 16, (2048, 50688): 1}
# K1 per step: every forward, and again when the backward recomputes a layer
# (the head is not recomputed)
TRAIN_K1_COUNTS = {(2048, 2048): 128, (2048, 8192): 64, (8192, 2048): 32, (2048, 50688): 1}
# olmo-1b pack: ops.potq_encode views each linear leaf as (rows, last axis)
# -> launches per pack (wq/wk/wv/wo; wi_gate/wi_up; mlp wo; the LM head)
PACK_SHAPES = {(32768, 2048): 4, (32768, 8192): 2, (131072, 2048): 1, (2048, 50688): 1}
PACK_BYTES_PER_ELEMENT = 5  # f32 read, int8 code written
# the encode's integer/compare work per element (abs, inf and zero tests,
# frexp, threshold, exponent arithmetic, clip, sign, pack) against the
# CUDA cores' instruction rate (67 TFLOP/s f32 counts an FMA as two operations)
ENCODE_OPS_PER_ELEMENT = 16
PEAK_ALU_OPS = 33.5e12
# phases 15-16 train, checkpoint, pack and serve olmo-1b's widths at this
# depth: the three writes and reads of the whole state are disk-bound (15.4
# GB at 0.43-0.57 GB/s took 90 of phase 15's 102 s at 16 layers on an NVIDIA
# H100 80GB HBM3 machine, 700.00 W), and a slow host took the whole script
# to 1172 s with phase 37e-g; 4 until phase 37q took the room
CKPT_LAYERS = 2
CKPT_FREE_BYTES = 15e9  # two 4.1 GB training checkpoints + the packed tree
TRAIN_ARGS = ["--arch", "olmo-1b", "--batch", "8", "--seq", "512", "--log-every", "1"]
# the vlm and encdec families (phases 29-31): internvl2-76b served at its
# published widths and this many of its 80 layers (all 80 do not fit one
# card; 16 until phase 37r took the room, when phases 29 and 37h took 27.3
# and 28.3 s of a slow host's 1091.8 s), whisper-large-v3 served and
# trained at full width and depth
VLM_ARCH, VLM_LAYERS = "internvl2-76b", 8
ENCDEC_ARCH = "whisper-large-v3"
# K1's rows there: a decode step (4 slots), a chunk step (4 x 32), an
# internvl2 solo prefill (256 patches + 128 tokens; its patch_proj at the
# 256 patch rows) and a whisper encoder-side pass (one request's frames)
VLM_PREFILL_M, ENC_M = 256 + 128, 1500
# phase 30's trace: transcription requests (a short task prefix, 30 s of
# audio as 1500 frames, a few dozen tokens out)
ENCDEC_TRACE = dict(n_requests=4, prompt_len=16, lam=2.0, new_lo=16, new_hi=32, seed=0)
# phase 30 serves whisper's decoder at this depth, the encoder whole: on an
# NVIDIA H100 80GB HBM3 (700.00 W) phase 30 took 104.3 s at all 32 layers
# and 36.8 s at 8 in one call (an earlier form of tools/phase37_probe.py),
# the room phase 37e-g needed; at 8 phases 30 and 37i took 40.2 and 26.9 s
# of a slow host's 1091.8 s, cut to 4 for phase 37r's room
ENCDEC_LAYERS = 4
# phase 31: whisper trained at full width on batch 2 x its 448-token decoder
# context (31b at this many encoder and decoder layers of its 32 + 32: at
# all of them 31b took 49.2 s, the room phase 37q needed); CUDA against
# CPU losses at smoke width within this relative bound
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 2, 448
WHISPER_TRAIN_LAYERS = 8
FAMILY_LOSS_RTOL = 1e-6
# the recurrent families (phases 32-34), served whole at full width and
# depth through the slot-row pool (4 slots, solo-prefill admissions): each
# one's prompt length (mamba2's 512 runs two SSD chunks of 256) and
# max_len (recurrentgemma's span 256: its 2048 window does not wrap here)
RECURRENT = {"mamba2-2.7b": dict(prompt=512, max_len=528),
             "recurrentgemma-2b": dict(prompt=128, max_len=256)}
# phases 32-33 serve them at this depth: at all 64 and 26 layers they took
# 25.8 s each of 776.2 s on an NVIDIA H100 80GB HBM3 (700.00 W); cut to
# 37l-m's depth for phase 37r's room
RECURRENT_SERVE_LAYERS = {"mamba2-2.7b": 8, "recurrentgemma-2b": 6}
RECURRENT_TRACE = dict(n_requests=4, lam=2.0, new_lo=8, new_hi=16, seed=0)


_T0 = time.perf_counter()


def k1_per_pass(cfg):
    """K1 launches in one weight pass of a decoder: every layer's 4
    attention linears, then its MLP's matrices (3 swiglu, 2 gelu) or, in a
    MoE layer, the router, one expert-batched launch per expert matrix (3
    swiglu, 2 gelu: gate and down) and the shared expert's MLP; then the LM
    head (llama3-8b 225, mistral-nemo-12b 281, starcoder2-7b 193;
    llama4-scout 89 at 8 layers, grok-1 15 at 2; internvl2 57 at 8, its
    solo prefill one more, patch_proj).  An encdec decode or chunk pass:
    every decoder layer's 4 self- and 2 cross-attention linears (cq, co)
    and its 2 MLP matrices, then the tied head (whisper 257; its
    encoder-side pass, ``encdec_pass_counts``, also 257).  An ssm layer:
    in_proj and out_proj (mamba2 129); a hybrid RG-LRU layer wx, wy, wa,
    wi, wout and its 3 MLP matrices, an attention layer its 4 attention
    linears and 3 MLP matrices (recurrentgemma 18 x 8 + 8 x 7 + 1 = 201)."""
    if cfg.family == "encdec":
        return 8 * cfg.n_layers + 1
    if cfg.family == "ssm":
        return 2 * cfg.n_layers + 1
    if cfg.family == "hybrid":
        from repro_torch.models import recurrent

        return sum(7 if k == "attn" else 8 for k in recurrent.layer_kinds(cfg)) + 1
    mlp = 3 if cfg.act == "swiglu" else 2
    ffn = mlp if cfg.moe is None else 1 + mlp + (mlp if cfg.moe.shared_expert else 0)
    return cfg.n_layers * (4 + ffn) + 1


def pass_counts(cfg):
    """{shape: K1 launches} of one weight pass, from the parameter specs:
    (K, N) for a linear, (E, K, N) for an expert matrix (one launch for
    its E experts); gelu's unused ``up`` is never read."""
    from repro_torch.models import registry, spec

    if cfg.family == "encdec":
        return encdec_pass_counts(cfg)[0]
    counts = {}
    for name, leaf in spec.named_leaves(registry.param_specs(cfg)):
        if not name.endswith("/w") or (name == "layers/moe/up/w" and cfg.act != "swiglu"):
            continue
        if name == "patch_proj/w":  # a vlm's prefill only
            continue
        shape = tuple(leaf.shape)
        key = shape[1:] if len(shape) == 4 else shape[-2:]
        counts[key] = counts.get(key, 0) + (shape[0] if len(shape) >= 3 else 1)
    if sum(counts.values()) != k1_per_pass(cfg):
        raise SystemExit(f"{cfg.name}: {counts} is not one weight pass")
    return counts


def encdec_pass_counts(cfg):
    """({(K, N): K1 launches} of an encdec decode or chunk pass, the same of
    its encoder-side pass (``registry.encode_cross_kv``: frame_proj, the
    encoder layers, every decoder layer's ck and cv)), from the parameter
    specs; the decode pass ends in the tied head (d_model, vocab_padded)."""
    from repro_torch.models import registry, spec

    dec, enc = {}, {}
    for name, leaf in spec.named_leaves(registry.param_specs(cfg)):
        if not name.endswith("/w"):
            continue
        into = enc if name.startswith(("frame_proj", "enc_layers", "dec_layers/ck",
                                       "dec_layers/cv")) else dec
        shape = tuple(leaf.shape)
        into[shape[-2:]] = into.get(shape[-2:], 0) + (shape[0] if len(shape) == 3 else 1)
    head = (cfg.d_model, cfg.vocab_padded)
    dec[head] = dec.get(head, 0) + 1
    want = (k1_per_pass(cfg), 1 + 6 * cfg.enc_layers + 2 * cfg.n_layers)
    if (sum(dec.values()), sum(enc.values())) != want:
        raise SystemExit(f"{cfg.name}: {dec}, {enc} are not one decode and one encoder pass")
    return dec, enc


def train_linears(cfg, batch, seq):
    """(M, K, N, recomputed) of every linear launch of one training step's
    forward at ``batch`` x ``seq`` tokens: an encdec's encoder side at
    batch x enc_seq rows (its ck/cv included), its decoder side at batch x
    seq; a vlm's patch_proj at batch x num_patches rows and its backbone at
    batch x seq (patches and text).  Every layer linear is recomputed in
    the backward; frame_proj, patch_proj and the head are not."""
    from repro_torch.models import registry, spec

    out = []
    for name, leaf in spec.named_leaves(registry.param_specs(cfg)):
        if not name.endswith("/w"):
            continue
        shape = tuple(leaf.shape)
        stacked = len(shape) == 3
        if cfg.family == "encdec" and name.startswith(("frame_proj", "enc_layers",
                                                       "dec_layers/ck", "dec_layers/cv")):
            m = batch * cfg.enc_seq
        elif name == "patch_proj/w":
            m = batch * cfg.num_patches
        else:
            m = batch * seq
        out += [(m,) + shape[-2:] + (stacked,)] * (shape[0] if stacked else 1)
    if cfg.family == "encdec" or cfg.tie_embeddings:
        out.append((batch * seq, cfg.d_model, cfg.vocab_padded, False))
    return out


def whisper_train_counts():
    """{(M, K, N): (K1 launches, K2 = K3 = pre-pass launches)} of one
    whisper-large-v3 training step at phase 31b's batch (``train_linears``:
    8 shapes, the encoder side at M = 3000, the decoder side at 896)."""
    from repro_torch import configs

    out = {}
    for m, kk, nn, recomputed in train_linears(configs.get_config(ENCDEC_ARCH),
                                               WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ):
        k1, bwd = out.get((m, kk, nn), (0, 0))
        out[(m, kk, nn)] = (k1 + 1 + recomputed, bwd + 1)
    return out


def moe_config(arch):
    """``arch`` at its published widths and phases 26-27's depth."""
    from repro_torch import configs

    return dataclasses.replace(configs.get_config(arch), n_layers=MOE_ARCHS[arch])


def expert_rows(cfg, slots=4):
    """Rows of each expert in a pooled decode step of ``slots`` slots: every
    slot is a dispatch group of one token with its capacity of rows."""
    from repro_torch.models import transformer

    return slots * transformer.moe_capacity(cfg, 1)


def decode_pass_bytes(cfg, slots=4):
    """Bytes K1 must move in one pooled decode weight pass: each weight read
    once (bf16), the activations read (bf16) and the outputs written (f32);
    a linear takes ``slots`` rows, an expert ``expert_rows`` of its own."""
    total = 0
    for key, c in pass_counts(cfg).items():
        e, (kk, nn) = (key[0], key[1:]) if len(key) == 3 else (1, key)
        m = expert_rows(cfg, slots) if len(key) == 3 else slots
        total += c * e * (2 * (m * kk + kk * nn) + 4 * m * nn)
    return total


def check_tokens(cfg, reqs, out):
    """Each request got its ``max_new_tokens`` ids, all inside the padded
    vocabulary."""
    for r in reqs:
        toks = out[r.uid]
        if toks.shape != (r.max_new_tokens,) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_padded:
            raise SystemExit(f"{cfg.name}: bad tokens for request {r.uid}: {toks}")


def step_launches(cfg=None):
    """Launches of one training step (default olmo-1b): K1 runs each forward
    linear and again where the backward recomputes a layer (not the head):
    2 k1_per_pass - 1; K2, K3 and the G pre-pass ("gq", shared by K2 and K3)
    once per linear and once per expert of an expert linear: L x (4 + the
    MLP's matrices) + 1, or for MoE L x (4 + 1 + E x the expert matrices +
    the shared expert's) + 1 (E x 2 for gelu: gate and down); a vlm or
    encdec as ``train_linears`` lists them (whisper 514 linears, K1 1026)."""
    from repro_torch import configs

    cfg = cfg or configs.get_config("olmo-1b")
    if cfg.family in ("vlm", "encdec"):
        # every linear once forward and backward; recomputed but for
        # frame_proj, patch_proj and the head
        lin = train_linears(cfg, 1, 1)
        bwd = len(lin)
        return {"k1": bwd + sum(r for *_, r in lin), "k2": bwd, "k3": bwd, "gq": bwd}
    n = k1_per_pass(cfg)
    bwd = n
    if cfg.moe is not None:
        mlp = 3 if cfg.act == "swiglu" else 2
        shared = mlp if cfg.moe.shared_expert else 0
        bwd = cfg.n_layers * (4 + 1 + cfg.moe.num_experts * mlp + shared) + 1
    return {"k1": 2 * n - 1, "k2": bwd, "k3": bwd, "gq": bwd}


#: (phase header, seconds since start) of every phase this process began,
#: written to chiprun_out/chip_smoke.json (a long run's printed output
#: may be kept only in part)
PHASE_STARTS = []


def phase(name):
    at = time.perf_counter() - _T0
    PHASE_STARTS.append((name, round(at, 1)))
    print(f"== {name} (at {at:.1f} s)", flush=True)


def bound(m, k, n, in_bytes):
    flops = 2.0 * m * n * k
    nbytes = in_bytes * (m * k + k * n) + 4 * m * n
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def train_bound(m, k, n, which, prc=True):
    """Roofline of one training-step launch: 2MNK operations against the
    bytes it must move (inputs read once, outputs written once)."""
    flops = 2.0 * m * n * k
    if which == "k1":  # Aq bf16, Wq bf16 -> out f32
        nbytes = 2 * (m * k + k * n) + 4 * m * n
    elif which == "k2":  # G f32, Wq bf16, a f32 (PRC) -> dA f32, rows f32
        nbytes = 4 * m * n + 2 * k * n + (4 * m * k + 4 * m if prc else 0) + 4 * m * k
    else:  # Aq bf16, G f32 -> dW f32
        nbytes = 2 * m * k + 4 * m * n + 4 * k * n
    return flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def time_ms(fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events around
    each call, L2 flushed before each (the serving path finds weights cold)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.core import mfmac, potq
    from repro_torch.core.policy import PAPER_FAITHFUL, draft_policy
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import potq_encode as KE
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.models import registry, spec, transformer
    from repro_torch.serve import PoolEngine, generate, poisson_trace, slots
    from repro_torch.serve import quantized_weights as qw

    dev = resolve_device("cuda")
    detail = {}

    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0))
    detail["card"] = smi

    phase("2 build")
    t0 = time.perf_counter()
    nvcc_s = _build.compile_all([K.SOURCE, KG.SOURCE, KE.SOURCE])
    K.build()
    KG.build()
    KE.build()
    print(f"build: nvcc {nvcc_s} s, all built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    # ptxas -v: (registers, spill store bytes, spill load bytes) per kernel
    for src, kern in _build.RESOURCES.items():
        print(f"ptxas {src}: {json.dumps(kern)}")
    detail["build_seconds"] = nvcc_s
    detail["ptxas"] = _build.RESOURCES

    phase("3 K1 vs plain version (bit for bit)")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    max_err = 0.0
    weights = {}
    for kk, nn in SERVE_SHAPES:
        w = torch.randn(kk, nn, generator=gen, device=dev) * 0.02 + 1e-3
        weights[(kk, nn)] = qw.quantize_leaf("w", w, PAPER_FAITHFUL)
        del w
    # (M, K, N, bits): decode (M = 4 slots) and prefill / chunk step (M =
    # 128) at 5 bits, a verify pass (M = 4 slots x 4 positions) and the
    # lockstep wave's batched prefill (M = 512) at 5 bits, and a self-draft
    # step (M = 4) at 3 bits: the served 5-bit weights re-quantized by the
    # draft policy, as each draft step does
    cases = ([(m, kk, nn, 5) for m in (4, 128, VERIFY_M, LOCKSTEP_PREFILL_M)
              for kk, nn in SERVE_SHAPES]
             + [(4, kk, nn, DRAFT_BITS) for kk, nn in SERVE_SHAPES] + [(3, 200, 130, 5)])
    dpol = draft_policy(dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True),
                        DRAFT_BITS)
    operands = {}

    def q0_case(m, kk, nn, bits, wq):
        """K1 on (M, K) serving activations, one scale group per slot (and
        position) at M <= 16 and one per request above, bit for bit."""
        nonlocal max_err
        a = torch.randn(m, kk, generator=gen, device=dev)
        axes = (1,) if m <= VERIFY_M else None
        aq = potq.pot_quantize(a, bits, potq.compute_beta(a, bits, axes)).to(torch.bfloat16)
        out_k = K.potq_matmul_cuda(aq, wq)
        out_p = K.potq_matmul_plain(aq, wq)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        ok = torch.equal(out_k, out_p) and bool(torch.isfinite(out_k).all())
        print(f"q0 M={m} K={kk} N={nn} bits={bits}: equal={ok} max_abs_err={err}")
        if not ok:
            raise SystemExit(f"K1 differs from its plain version at {(m, kk, nn, bits)}")
        max_err = max(max_err, err)
        operands[(m, kk, nn, bits)] = (aq, wq)

    for m, kk, nn, bits in cases:
        wq = weights.get((kk, nn))
        if wq is None:
            wq = qw.quantize_leaf("w", torch.randn(kk, nn, generator=gen, device=dev),
                                  PAPER_FAITHFUL)
        if bits != 5:
            wq = mfmac._quantize_w(wq, dpol)
        q0_case(m, kk, nn, bits, wq)
    # the other dense decoders' linears: decode (M = 4) and prefill or a
    # chunk step (M = 128)
    counts = {arch: pass_counts(configs.get_config(arch))
              for arch in ("llama3-8b",) + OTHER_ARCHS}
    for arch in OTHER_ARCHS:
        for kk, nn in counts[arch]:
            w = torch.randn(kk, nn, generator=gen, device=dev) * 0.02 + 1e-3
            wq = qw.quantize_leaf("w", w, PAPER_FAITHFUL)
            del w
            for m in (4, 128):
                q0_case(m, kk, nn, 5, wq)
    moe_ops, err = moe_k1_checks(dev, gen)
    max_err = max(max_err, err)
    fam_ops, err = family_k1_checks(dev, gen)
    max_err = max(max_err, err)
    # quantize=True: raw f32 operands, PRC and WBC on, subnormals included
    a = torch.randn(128, 4096, generator=gen, device=dev)
    w = torch.randn(4096, 1024, generator=gen, device=dev) * 0.02 + 3e-3
    a[0, :3] = torch.tensor([1e-40, -3e-39, 0.0], device=dev)
    w_mean, clip_t = w.mean(), a.abs().max() * 0.95
    out_k = ops.potq_matmul(a, w, w_mean=w_mean, clip_t=clip_t)
    emax = potq.pot_emax(5)
    beta_a = potq.compute_beta(torch.clamp(a, -clip_t, clip_t), 5)
    beta_w = potq.compute_beta(w - w_mean, 5)
    q_scal = torch.stack([potq.exp2i(-beta_a), potq.exp2i(-beta_w),
                          potq.exp2i(beta_a + beta_w), w_mean, clip_t])
    out_p = K.potq_matmul_plain(a, w, q_scal, emax_a=emax, emax_w=emax, quantize=True)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    ok = torch.equal(out_k, out_p)
    print(f"q1 M=128 K=4096 N=1024 (PRC+WBC): equal={ok} max_abs_err={err}")
    if not ok:
        raise SystemExit("K1 quantize=True differs from its plain version")
    max_err = max(max_err, err)
    max_err = max(max_err, k1_edges(dev, gen))
    start_rows, err = k1_start_checks(dev, gen)
    max_err = max(max_err, err)
    detail["k1_start_variant"] = start_rows

    phase("4 timing (CUDA events, L2 flushed)")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    # summed over one llama3-8b decode weight pass (M = 4), prefill (M =
    # 128), verify pass (M = 16), self-draft step (M = 4, 3 bits) and
    # lockstep wave prefill (M = 512), and over a decode weight pass and a
    # prefill of each other dense decoder
    regimes = ([("llama3-8b", m, bits) for m, bits in
                ((4, 5), (128, 5), (VERIFY_M, 5), (4, DRAFT_BITS),
                 (LOCKSTEP_PREFILL_M, 5))]
               + [(arch, m, 5) for arch in OTHER_ARCHS for m in (4, 128)])
    sums = {r: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                "t_ops": 0.0, "t_bytes": 0.0} for r in regimes}
    for (m, kk, nn, bits), (aq, wq) in operands.items():
        big = m * kk * nn > 1e10
        it = 3 if big else 10
        t_k = time_ms(lambda: K.potq_matmul_cuda(aq, wq), it, flush)
        t_p = time_ms(lambda: K.potq_matmul_plain(aq, wq), 2 if big else 5, flush)
        t_l = time_ms(lambda: torch.matmul(aq, wq), it, flush)
        b_ms, b_by = bound(m, kk, nn, 2)
        path, groups = K.plan(m, nn, kk)
        row = dict(mode="q0", M=m, K=kk, N=nn, bits=bits, path=path, groups=groups, ms=t_k,
                   plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                   fp64_tc_bound_ms=2.0 * m * kk * nn / PEAK_FP64_TC_FLOPS * 1e3)
        rows.append(row)
        print(json.dumps(row))
        for (arch, rm, rbits), acc in sums.items():
            c = counts[arch].get((kk, nn))
            if (rm, rbits) != (m, bits) or c is None:
                continue
            acc["ms"] += c * t_k
            acc["plain_ms"] += c * t_p
            acc["library_ms"] += c * t_l
            flops = 2.0 * m * kk * nn
            nbytes = 2 * (m * kk + kk * nn) + 4 * m * nn
            acc["t_ops"] += c * flops / PEAK_BF16_FLOPS * 1e3
            acc["t_bytes"] += c * nbytes / PEAK_BYTES * 1e3
    moe_rows, moe_passes = moe_k1_timing(moe_ops, flush)
    rows += moe_rows
    del moe_ops
    fam_rows, fam_passes = family_k1_timing(fam_ops, flush)
    rows += fam_rows
    del fam_ops
    t_k = time_ms(lambda: ops.potq_matmul(a, w, w_mean=w_mean, clip_t=clip_t), 10, flush)
    t_p = time_ms(lambda: K.potq_matmul_plain(a, w, q_scal, emax_a=emax, emax_w=emax,
                                              quantize=True), 5, flush)
    t_l = time_ms(lambda: torch.matmul(a, w), 10, flush)
    b_ms, b_by = bound(128, 4096, 1024, 4)
    row = dict(mode="q1", M=128, K=4096, N=1024, ms=t_k, plain_ms=t_p,
               library_ms=t_l, bound_ms=b_ms, bound_by=b_by)
    rows.append(row)
    print(json.dumps(row))
    for acc in sums.values():
        t_ops, t_bytes = acc.pop("t_ops"), acc.pop("t_bytes")
        acc["bound_ms"] = max(t_ops, t_bytes)
        acc["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
        acc["fp64_tc_bound_ms"] = t_ops * PEAK_BF16_FLOPS / PEAK_FP64_TC_FLOPS
    per_pass, per_prefill = sums[("llama3-8b", 4, 5)], sums[("llama3-8b", 128, 5)]
    per_verify, per_draft = sums[("llama3-8b", VERIFY_M, 5)], sums[("llama3-8b", 4, DRAFT_BITS)]
    per_wave_prefill = sums[("llama3-8b", LOCKSTEP_PREFILL_M, 5)]
    print("one decode weight pass (M=4, 225 launches):", json.dumps(per_pass))
    print("one prefill (M=128, 225 launches):", json.dumps(per_prefill))
    print(f"one verify pass (M={VERIFY_M}, 225 launches):", json.dumps(per_verify))
    print(f"one self-draft step (M=4, {DRAFT_BITS} bits, 225 launches):",
          json.dumps(per_draft))
    print(f"one lockstep wave prefill (M={LOCKSTEP_PREFILL_M} = 4 x 128, 225 launches):",
          json.dumps(per_wave_prefill))
    other_passes = {}
    for arch in OTHER_ARCHS:
        n = sum(counts[arch].values())
        other_passes[arch] = dict(launches_per_pass=n, decode_pass=sums[(arch, 4, 5)],
                                  prefill=sums[(arch, 128, 5)])
        print(f"{arch}: one decode weight pass (M=4, {n} launches):",
              json.dumps(sums[(arch, 4, 5)]))
        print(f"{arch}: one prefill (M=128, {n} launches):", json.dumps(sums[(arch, 128, 5)]))
    detail["k1_shapes"] = rows
    detail["k1_decode_pass"] = per_pass
    detail["k1_prefill"] = per_prefill
    detail["k1_verify_pass"] = per_verify
    detail["k1_draft_step"] = per_draft
    detail["k1_lockstep_prefill"] = per_wave_prefill
    detail["k1_other_configs"] = other_passes
    detail["k1_moe_configs"] = moe_passes
    detail["k1_family_configs"] = fam_passes
    del operands, weights, flush, a, w, sums

    phase("5 serve llama3-8b at full width")
    cfg = configs.get_config("llama3-8b")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    pgen = torch.Generator(device=dev).manual_seed(0)
    params = spec.materialize(
        registry.param_specs(cfg), pgen,
        transform=lambda name, x: qw.quantize_leaf(name, x, PAPER_FAITHFUL))
    torch.cuda.synchronize()
    print(f"params: {spec.count_params(registry.param_specs(cfg))} "
          f"materialized + quantized in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    policy = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
    reqs = poisson_trace(cfg, n_requests=8, prompt_len=128, lam=2.0, new_lo=8,
                         new_hi=32, seed=0)
    eng = PoolEngine(cfg, policy, params, max_slots=4, max_len=160, device=dev)
    eng.run([dataclasses.replace(reqs[0], uid="warm-up", max_new_tokens=2)])
    torch.cuda.synchronize()
    K.potq_matmul_cuda.launches = 0
    t0 = time.perf_counter()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.potq_matmul_cuda.launches
    st = eng.last_stats
    serve = dict(wall_s=wall, tokens_per_s=st.emitted_tokens / wall,
                 emitted_tokens=st.emitted_tokens, weight_passes=st.weight_passes,
                 decode_steps=st.decode_steps, prefills=st.prefills,
                 mean_ttft_passes=st.mean_ttft_passes,
                 mean_occupancy=st.mean_occupancy, k1_launches=launches,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(json.dumps(serve))
    detail["serve"] = serve
    if launches != k1_per_pass(cfg) * st.weight_passes:
        raise SystemExit(f"K1 launched {launches} times, expected {k1_per_pass(cfg)} x "
                         f"{st.weight_passes} weight passes")
    check_tokens(cfg, reqs, out)
    # where a weight pass's time goes: one prefill and one pooled decode step
    with torch.inference_mode():
        mini = registry.init_cache(cfg, 1, 160, device=dev)
        toks = torch.as_tensor(reqs[0].tokens, dtype=torch.int64, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = registry.prefill(cfg, eng.policy, params, {"tokens": toks}, mini)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()):
            raise SystemExit("non-finite prefill logits")
        pool = registry.init_pool_cache(cfg, 4, 160, device=dev)
        for s in range(4):
            slots.write_slot(pool, mini, s)
        tok = torch.zeros(4, dtype=torch.int64, device=dev)
        t_steps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, pool = registry.decode_step(cfg, eng.policy, params, tok, pool)
            torch.cuda.synchronize()
            t_steps.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(logits).all()):
            raise SystemExit("non-finite decode logits")
        # device time inside one pooled decode step, by kernel
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, pool = registry.decode_step(cfg, eng.policy, params, tok, pool)
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    k1_us = sum(e.time_range.elapsed_us() for e in kern if "potq_mm" in e.name)
    prof_row = dict(wall_ms=t_prof * 1e3, device_kernels=len(kern),
                    device_busy_ms=busy_us / 1e3, k1_ms=k1_us / 1e3,
                    # against the unprofiled step time measured above
                    idle_share=(1 - busy_us / 1e6 / (sum(t_steps) / len(t_steps)))
                    if kern else None)
    print("profiled decode step:", json.dumps(prof_row))
    detail["step_breakdown"] = dict(prefill_s=t_prefill, decode_step_s=t_steps,
                                    profiled_decode_step=prof_row)
    print(f"one prefill (S=128): {t_prefill * 1e3:.1f} ms; one pooled decode step "
          f"(4 slots): {[round(t * 1e3, 1) for t in t_steps]} ms; K1 share of a "
          f"decode step (phase 4 sum): {per_pass['ms']:.2f} ms")

    phase("6 pool vs solo")
    for r in reqs[:2]:
        solo = generate(cfg, policy, params, {"tokens": r.tokens},
                        max_new_tokens=r.max_new_tokens, max_len=160, device=dev)
        same = np.array_equal(solo[0].numpy(), out[r.uid])
        print(f"request {r.uid}: pool == solo: {same}")
        if not same:
            raise SystemExit(f"pool-vs-solo mismatch for request {r.uid}")
    del params, eng
    torch.cuda.empty_cache()

    phase("7 CUDA vs CPU (smoke width)")
    scfg = configs.smoke_config("llama3-8b")
    p_cpu = spec.materialize(registry.param_specs(scfg), torch.Generator().manual_seed(0))
    p_gpu = spec.params_from_numpy(
        {name: x.numpy() for name, x in spec.named_leaves(p_cpu)}, dev)
    spol = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, scfg.vocab, (1, 9)))
    seq = torch.from_numpy(rng.integers(0, scfg.vocab, (2, 8)))
    worst = 0.0
    with torch.inference_mode():
        outs = {}
        for d, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            ls = []
            lg, _ = transformer.prefill(scfg, spol, p, prompt.to(d),
                                        transformer.init_cache(scfg, 1, 24, device=d))
            ls.append(lg.cpu())
            c = slots.lift_cache(transformer.init_cache(scfg, 2, 24, device=d), 2)
            c["len"] = torch.tensor([0, 3], device=d)
            for i in range(seq.shape[1]):
                lg, c = transformer.decode_step(scfg, spol, p, seq[:, i].to(d), c)
                ls.append(lg.cpu())
            outs[d] = ls
        for x, y in zip(outs["cpu"], outs["cuda"]):
            worst = max(worst, (x - y).abs().max().item())
    print(f"max |logit(cuda) - logit(cpu)| = {worst:.3g} (tolerance {LOGIT_ATOL})")
    detail["cuda_vs_cpu_max_logit_diff"] = worst
    if not worst <= LOGIT_ATOL:
        raise SystemExit("CUDA and CPU logits disagree beyond the tolerance")

    grads = training_kernels(dev, detail)
    train = training(dev, detail)
    enc = encode_kernel(dev, detail)
    k4_launches = checkpoint_and_pack(dev, detail)
    cpu_vs_card(dev, detail)
    paged = serving(dev, detail)
    moe_train = moe_training(dev, detail)
    fam_train, whisper_launches, whisper_step = family_training(dev, detail)
    fam_train.update(recurrent_training(dev, detail))
    qa_train = qa_training(dev, detail)
    cnn_kernels, cnn_launches = cnn_phase(dev, detail)
    multi = multi_gpu(dev, detail)
    m_a, m_c = multi["a"][0], multi["c"]["ranks"][0]
    # 37c's, 37g's, 37k's and 37n's data-parallel steps and 37o's and
    # 37p's tensor-parallel steps on rank 0
    tp = multi["tp"]
    multi_steps = {k: sum(s[k] for s in m_c["launches"])
                   + sum(s[k] for key in "gkn" for g in multi[key].values()
                         for s in g["dp"][0]["launches"])
                   + sum(s[k] for key in _tp_cells() for s in tp[key]["ranks"][0]["launches"])
                   + sum(s[k] for a in TP_SMOKE_ARCHS for s in tp["two_by_two"][a]["launches"])
                   + tp["q"]["ranks"][0]["launches"][k]
                   for k in ("k1", "k2", "k3", "gq")}
    # 37e-f's, 37h-j's, 37l-m's and 37s's served passes on rank 0
    multi_served = sum(multi[key][0]["k1_launches"]
                       for key in tuple("efhij") + ("l", "l2", "m", "m2") + tuple(OPTION_CELLS))

    phase("18 results")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    detail["phase_starts"] = PHASE_STARTS
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    # internvl2_* and whisper_*: phase 4's sums of each regime (internvl2's
    # decode pass and solo prefill, whisper's decode and encoder-side
    # passes) and phases 29-30's launches
    family = {}
    for arch, by in detail["k1_family_configs"].items():
        prefix = arch.split("-")[0]
        family[f"{prefix}_launches"] = paged["family_launches"][arch]
        for regime, acc in by.items():
            for f in ("launches", "ms", "plain_ms", "bound_ms", "bound_by", "fp64_tc_bound_ms",
                      "library_ms"):
                family[f"{prefix}_{regime}_{f}"] = acc[f]
    kernels = [{
        "name": "potq_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/potq_matmul.cu",
        "replaces": "src/repro/kernels/potq_matmul.py:70",
        "forms": ["(M, K) @ (K, N) a launch",
                  "an expert batch (E, M, K) @ (E, K, N) a launch (MoE, phases 26-28)"],
        # serve runs (phases 5, 19, 20's prefix-on run, 21, 22's three
        # speculative runs, 23's lockstep wave and float32 run, 24-27's A)
        # + training (phase 10); since phases 26-27 it also runs the
        # expert-batched form (one launch counts one)
        # ... + phase 37 on rank 0: 37a's, 37e-f's and 37h-j's served
        # passes, 37c's, 37g's and 37k's steps
        "launches": (launches + train["launches"]["k1"] + paged["launches"]
                     + whisper_launches["k1"] + cnn_launches["k1"]
                     + m_a["k1_launches"] + multi_served + multi_steps["k1"]),
        # phase 37: two ranks on the card; 37a's K1 launches on each rank
        # (one a linear shard a weight pass), its row-parallel folds (K1's
        # start variant chained over the model axis, phase 3), 37c's
        # launches a data-parallel step on each rank; 37e-f's MoE decoders
        # with EP (an expert-batched launch over a rank's experts), 37g's
        # MoE smoke steps
        "multi_gpu": dict(
            serve_launches_per_rank=[r["k1_launches"] for r in multi["a"]],
            serve_weight_passes=m_a["weight_passes"], serve_folds=m_a["folds"],
            train_step_launches=[r["launches"] for r in multi["c"]["ranks"]],
            moe_ep_launches_per_rank={
                r["arch"]: [x["k1_launches"] for x in multi[key]]
                for key in "ef" for r in multi[key][:1]},
            moe_ep_weight_passes={multi[key][0]["arch"]: multi[key][0]["weight_passes"]
                                  for key in "ef"},
            moe_train_step_launches={a: g["dp"][0]["launches"] for a, g in multi["g"].items()},
            # 37h-i: internvl2 and whisper on (1, 2), each rank's launches,
            # weight passes, prefills (encoder-side passes) and folds; 37j
            # whisper on (2, 1); 37k their smoke steps data-parallel
            family_launches_per_rank={
                multi[key][0]["arch"] + ("" if key != "j" else " (2, 1)"):
                [x["k1_launches"] for x in multi[key]] for key in "hij"},
            family_weight_passes={key: multi[key][0]["weight_passes"] for key in "hij"},
            family_prefills={key: multi[key][0]["prefills"] for key in "hij"},
            family_folds={key: multi[key][0]["folds"] for key in "hi"},
            family_train_step_launches={a: g["dp"][0]["launches"]
                                        for a, g in multi["k"].items()},
            # 37l-m: mamba2 and recurrentgemma on (1, 2) and (2, 1), each
            # rank's launches, weight passes and folds; 37n their steps
            recurrent_launches_per_rank={
                f"{multi[key][0]['arch']} {tuple(multi[key][0]['mesh'].values())}":
                [x["k1_launches"] for x in multi[key]] for key in ("l", "l2", "m", "m2")},
            recurrent_weight_passes={key: multi[key][0]["weight_passes"]
                                     for key in ("l", "l2", "m", "m2")},
            recurrent_folds={key: multi[key][0]["folds"] for key in "lm"},
            recurrent_train_step_launches={a: g["dp"][0]["launches"]
                                           for a, g in multi["n"].items()},
            # 37s: llama3-8b's serving options on a plan, each rank's
            # launches and the run's weight passes and draft steps
            option_launches_per_rank={row["label"]: row["k1_launches"]
                                      for row in multi["s"].values()},
            option_passes={row["label"]: (row["counters"]["weight_passes"],
                                          row["counters"]["draft_weight_passes"])
                           for row in multi["s"].values()},
            backend=m_a["backend"]),
        "start_variant": detail["k1_start_variant"],
        "lockstep_launches": paged["lockstep_launches"],
        "chunk_step_launches": paged["chunk_launches"],
        "verify_step_launches": paged["verify_launches"],
        "draft_step_launches": paged["draft_launches"],
        "max_abs_err": max(max_err, grads["k1"]["max_abs_err"], cnn_kernels["k1"]["max_abs_err"]),
        "ms": per_pass["ms"],
        "plain_ms": per_pass["plain_ms"],
        "bound_ms": per_pass["bound_ms"],
        "bound_by": per_pass["bound_by"],
        "library_ms": per_pass["library_ms"],
        # the other two regimes: one olmo-1b training step (phase 9) and
        # one llama3-8b prefill (phase 4)
        "train_ms": grads["k1"]["ms"],
        "train_plain_ms": grads["k1"]["plain_ms"],
        "train_bound_ms": grads["k1"]["bound_ms"],
        "train_fp64_tc_bound_ms": grads["k1"]["fp64_tc_bound_ms"],
        "train_library_ms": grads["k1"]["library_ms"],
        # phase 9's sums over one whisper-large-v3 training step (phase 31b)
        "whisper_train_step": grads["k1"]["whisper_step"],
        "prefill_ms": per_prefill["ms"],
        "prefill_plain_ms": per_prefill["plain_ms"],
        "prefill_bound_ms": per_prefill["bound_ms"],
        "prefill_fp64_tc_bound_ms": per_prefill["fp64_tc_bound_ms"],
        "prefill_library_ms": per_prefill["library_ms"],
        # speculative decoding (phase 4): one verify pass (M = 16) and one
        # self-draft step (M = 4, 3-bit operands)
        "verify_ms": per_verify["ms"],
        "verify_plain_ms": per_verify["plain_ms"],
        "verify_bound_ms": per_verify["bound_ms"],
        "verify_library_ms": per_verify["library_ms"],
        "draft_ms": per_draft["ms"],
        "draft_plain_ms": per_draft["plain_ms"],
        "draft_bound_ms": per_draft["bound_ms"],
        "draft_library_ms": per_draft["library_ms"],
        # phase 23's lockstep wave: its batched prefill (M = 512, phase 4)
        "lockstep_prefill_ms": per_wave_prefill["ms"],
        "lockstep_prefill_plain_ms": per_wave_prefill["plain_ms"],
        "lockstep_prefill_bound_ms": per_wave_prefill["bound_ms"],
        "lockstep_prefill_fp64_tc_bound_ms": per_wave_prefill["fp64_tc_bound_ms"],
        "lockstep_prefill_library_ms": per_wave_prefill["library_ms"],
        # the MoE decoders (phase 4's sums, phases 26-27's launches): their
        # experts run the expert-batched form, one launch per expert matrix
        "moe_configs": {
            arch: dict(launches=paged["moe_launches"][arch], layers=o["layers"],
                       launches_per_pass=o["launches_per_pass"],
                       expert_rows=o["expert_rows"],
                       **{f"decode_{f}": o["decode_pass"][f]
                          for f in ("ms", "plain_ms", "bound_ms", "library_ms")})
            for arch, o in detail["k1_moe_configs"].items()},
        # internvl2-76b at 16 layers and whisper-large-v3 (phases 4 and
        # 29-30), and one whisper training step at full width (31b)
        **family,
        "whisper_train_step_launches": whisper_step["launches"]["k1"],
        "whisper_train_step_device_ms": whisper_step["k1_ms"],
        "whisper_train_step_fp64_tc_bound_ms": whisper_step["fp64_tc_bound_ms"]["k1_ms"],
        # phase 35: the CNN (conv = im2col + K1): the main path's launches,
        # the kernel summed over one step of each cell, the wide step's
        # device ms; phase 36c's launches under quantize_attention
        "cnn": cnn_kernels["k1"],
        "quantize_attention_serving_launches": paged["qa_launches"],
        # the other dense decoders (phase 4's sums, phases 24-25's launches)
        "other_configs": {
            arch: dict(launches=paged["dense_launches"][arch],
                       launches_per_pass=o["launches_per_pass"],
                       **{f"{key}_{f}": o[regime][f]
                          for key, regime in (("decode", "decode_pass"), ("prefill", "prefill"))
                          for f in ("ms", "plain_ms", "bound_ms", "fp64_tc_bound_ms",
                                    "library_ms")})
            for arch, o in detail["k1_other_configs"].items()},
    }]
    # K2's ms includes its pre-pass, which also has a line of its own; it
    # takes the place of the in-VMEM quantization of G in both TPU kernels
    for key, name, line in (("k2", "grad_da", 68), ("k3", "grad_dw", 143),
                            ("gq", "grad_g_quantize", 99)):
        kernels.append(dict(name=name, route="cuda",
                            source="src/repro_torch/csrc/potq_grad.cu",
                            replaces=f"src/repro/kernels/potq_grad.py:{line}",
                            # phase 10 (olmo-1b), phase 31b (whisper), phase 35 (the CNN)
                            launches=(train["launches"][key] + whisper_launches[key]
                                      + cnn_launches[key] + multi_steps[key]),
                            # phase 37c: a data-parallel step on each rank
                            multi_gpu_step_launches=[[s[key] for s in r["launches"]]
                                                     for r in multi["c"]["ranks"]],
                            # phases 37o-q: a tensor-parallel step on
                            # each rank of (1, 2), and on rank 0 of (2, 2)
                            multi_gpu_tp_step_launches={
                                f"{c} {_tp_cells()[c][0].name}": [
                                    [s[key] for s in r["launches"]] for r in tp[c]["ranks"]]
                                for c in _tp_cells()},
                            # phase 37q (a): llama4-scout's first step
                            # at published widths on each rank of (1, 2)
                            multi_gpu_moe_tp_step_launches=[
                                r["launches"][key] for r in tp["q"]["ranks"]],
                            multi_gpu_tp_smoke_step_launches={
                                a: [s[key] for s in tp["two_by_two"][a]["launches"]]
                                for a in TP_SMOKE_ARCHS},
                            **({"start_variant": detail["k2_start_variant"]}
                               if key == "k2" else {}),
                            # phase 37g / 37k: a MoE / vlm / encdec smoke
                            # step, data-parallel, rank 0
                            multi_gpu_moe_step_launches={
                                a: [s[key] for s in g["dp"][0]["launches"]]
                                for a, g in multi["g"].items()},
                            multi_gpu_family_step_launches={
                                a: [s[key] for s in g["dp"][0]["launches"]]
                                for a, g in multi["k"].items()},
                            # phases 28, 31a, 34 and 36a: one step at smoke width
                            moe_step_launches={a: n[key] for a, n in moe_train.items()},
                            family_step_launches={a: n[key] for a, n in fam_train.items()},
                            quantize_attention_step_launches={a: n[key]
                                                              for a, n in qa_train.items()},
                            # phase 35: the CNN's conv shapes
                            cnn=cnn_kernels[key],
                            # phase 31b: one whisper step at full width, profiled
                            whisper_train_step_launches=whisper_step["launches"][key],
                            whisper_train_step_device_ms=whisper_step[
                                "prepass_ms" if key == "gq" else f"{key}_ms"],
                            whisper_train_step_fp64_tc_bound_ms=whisper_step[
                                "fp64_tc_bound_ms"].get(f"{key}_ms"),
                            **dict(grads[key], max_abs_err=max(
                                grads[key]["max_abs_err"], cnn_kernels[key]["max_abs_err"]))))
    kernels.append(dict(name="potq_encode", route="cuda",
                        source="src/repro_torch/csrc/potq_encode.cu",
                        replaces="src/repro/kernels/potq_encode.py:24",
                        launches=k4_launches, **enc))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _k1_lattice(dev, gen, m, k, n):
    """Aq (m, k) and Wq (k, n) at the 5 x 5 pair whose products reach both
    ends of each output's chunk lattice: exponents ±7 around each row's own
    beta (every row another) and around W's, big and small alternating
    along K, random signs; in each chunk the second half's big Aq terms
    cancel the first half's, so the small products decide the sums."""
    from repro_torch.core import potq

    kk = torch.arange(k, device=dev)
    rows = torch.arange(m, device=dev)
    ea = torch.where((kk[None] + rows[:, None]) % 2 == 0, 7, -7)
    sa = torch.randint(0, 2, (m, k), generator=gen, device=dev) * 2.0 - 1.0
    second = kk % 128 >= 64
    src = torch.where(second, kk - 64, kk)
    sa = torch.where(second[None] & (ea[:, src] > 0), -sa[:, src], sa)
    beta = (rows % 7 - 3)[:, None] * 2
    aq = sa * potq.exp2i(ea + beta)
    cols = torch.arange(n, device=dev)
    ew = torch.where((kk[:, None] + cols[None]) % 2 == 0, 7, -7)
    sw = torch.where(((kk % 64) // 3) % 2 == 0, 1.0, -1.0)[:, None].expand(k, n)
    wq = sw * potq.exp2i(ew - 5)
    return aq.to(torch.bfloat16), wq.to(torch.bfloat16)


def moe_k1_checks(dev, gen):
    """Phase 3 for the MoE decoders at their published widths: each
    linear through K1 at decode (M = 4 slots, a scale per row) and, but
    the head, at a chunk step's M = 128 (the routers: ragged N under one
    decode strip), and each
    expert matrix through the expert-batched launch at ``MOE_EXPERT_M``
    rows (E experts, each its own PoT weight scale; activation scales per
    (expert, slot of 4 rows), as serving's per-slot dispatch makes them;
    at a decode step's rows three of each slot's four are zero, the
    capacity padding).  Each launch equals its plain version, and the
    batched one E single-expert launches, bit for bit.  Returns the
    operands of one decode weight pass, {(arch, pass_counts key): (aq,
    wq)}, and the largest |difference|."""
    from repro_torch.core import potq
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.serve import quantized_weights as qw

    keep, max_err = {}, 0.0
    for arch in MOE_ARCHS:
        cfg = moe_config(arch)
        decode_m = expert_rows(cfg)
        for key in pass_counts(cfg):
            batched = len(key) == 3
            e, (kk, nn) = (key[0], key[1:]) if batched else (1, key)
            w = torch.randn((e, kk, nn) if batched else (kk, nn), generator=gen,
                            device=dev) * 0.02 + 1e-3
            wq = qw.quantize_leaf("w", w, PAPER_FAITHFUL)  # per expert
            del w
            # every linear but the head (gathered to the emit rows first)
            # also at a chunk step's 4 slots x 32 rows
            ms = (MOE_EXPERT_M[arch] if batched
                  else (4,) if nn == cfg.vocab_padded else (4, 128))
            for m in ms:
                if batched:
                    a = torch.randn(e, m // 4, 4, kk, generator=gen, device=dev)
                    if m == decode_m:
                        a[:, :, 1:] = 0.0
                    aq = potq.pot_quantize(a, 5, potq.compute_beta(a, 5, (2, 3)))
                    aq = aq.to(torch.bfloat16).reshape(e, m, kk)
                    out_k = K.potq_matmul_cuda(aq, wq)
                    out_p = K.potq_matmul_plain(aq, wq)
                    single = torch.stack([K.potq_matmul_cuda(aq[i], wq[i]) for i in range(e)])
                else:
                    a = torch.randn(m, kk, generator=gen, device=dev)
                    aq = potq.pot_quantize(a, 5, potq.compute_beta(a, 5, (1,)))
                    aq = aq.to(torch.bfloat16)
                    out_k = K.potq_matmul_cuda(aq, wq)
                    out_p = single = K.potq_matmul_plain(aq, wq)
                del a
                torch.cuda.synchronize()
                err = (out_k - out_p).abs().max().item()
                ok = (torch.equal(out_k, out_p) and torch.equal(out_k, single)
                      and bool(torch.isfinite(out_k).all()))
                print(f"{arch} {'experts E=%d ' % e if batched else ''}M={m} K={kk} N={nn} "
                      f"{K.plan(m, nn, kk, 132, e)}: equal={ok} max_abs_err={err}", flush=True)
                if not ok:
                    raise SystemExit(f"K1 differs from its plain version at {(arch, e, m, kk, nn)}")
                max_err = max(max_err, err)
                if m == (decode_m if batched else 4):
                    keep[(arch, key)] = (aq, wq)
                del out_k, out_p, single
    return keep, max_err


def moe_k1_timing(operands, flush):
    """Phase 4 for the MoE decoders: each operand pair of ``moe_k1_checks``
    timed (the kernel, its plain version, ``torch.matmul`` or ``torch.bmm``
    on the same bf16 operands, a yardstick and not the same function) with
    its bound, and summed over one decode weight pass of each config.
    Returns (the rows, {arch: the pass})."""
    from repro_torch.kernels import potq_matmul as K

    rows, sums = [], {}
    for (arch, key), (aq, wq) in operands.items():
        batched = len(key) == 3
        e, (kk, nn) = (key[0], key[1:]) if batched else (1, key)
        m = aq.shape[-2]
        c = pass_counts(moe_config(arch))[key]
        lib = torch.bmm if batched else torch.matmul
        big = e * m * kk * nn > 1e10
        t_k = time_ms(lambda: K.potq_matmul_cuda(aq, wq), 3 if big else 10, flush)
        t_p = time_ms(lambda: K.potq_matmul_plain(aq, wq), 2, flush)
        t_l = time_ms(lambda: lib(aq, wq), 3 if big else 10, flush)
        t_ops = 2.0 * e * m * kk * nn / PEAK_BF16_FLOPS * 1e3
        t_bytes = e * (2 * (m * kk + kk * nn) + 4 * m * nn) / PEAK_BYTES * 1e3
        path, groups = K.plan(m, nn, kk, 132, e)
        row = dict(mode="experts" if batched else "q0", arch=arch, E=e, M=m, K=kk, N=nn,
                   path=path, groups=groups, launches_per_pass=c, ms=t_k, plain_ms=t_p,
                   library_ms=t_l, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops > t_bytes else "bytes")
        rows.append(row)
        print(json.dumps(row), flush=True)
        acc = sums.setdefault(arch, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, t_ops=0.0,
                                         t_bytes=0.0))
        for f, t in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l), ("t_ops", t_ops),
                     ("t_bytes", t_bytes)):
            acc[f] += c * t
    passes = {}
    for arch, acc in sums.items():
        t_ops, t_bytes = acc.pop("t_ops"), acc.pop("t_bytes")
        acc.update(bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops > t_bytes else "bytes")
        cfg = moe_config(arch)
        passes[arch] = dict(layers=cfg.n_layers, launches_per_pass=k1_per_pass(cfg),
                            expert_rows=expert_rows(cfg), decode_pass=acc)
        print(f"{arch} at {cfg.n_layers} layers: one decode weight pass (M=4, experts "
              f"M={expert_rows(cfg)}, {k1_per_pass(cfg)} launches):", json.dumps(acc))
    return rows, passes


def family_configs():
    """{arch: config} of phases 29-30 and 32-33: internvl2-76b at its
    published widths and ``VLM_LAYERS`` layers; whisper-large-v3,
    mamba2-2.7b and recurrentgemma-2b whole."""
    from repro_torch import configs

    out = {VLM_ARCH: dataclasses.replace(configs.get_config(VLM_ARCH), n_layers=VLM_LAYERS),
           ENCDEC_ARCH: configs.get_config(ENCDEC_ARCH)}
    out.update({arch: configs.get_config(arch) for arch in RECURRENT})
    return out


def family_regimes():
    """{(arch, regime): (M, {(K, N): K1 launches})} of the vlm, encdec and
    recurrent paths that phase 4 sums: a decode weight pass of each (M =
    4), internvl2's solo prefill (M = 384; its patch_proj at the 256 patch
    rows, keyed (M, K, N)), whisper's encoder-side pass (M = 1500) and
    each recurrent model's solo prefill (M = its prompt; the head at the
    last row alone, M = 1, keyed (M, K, N))."""
    cf = family_configs()
    vlm, enc = cf[VLM_ARCH], cf[ENCDEC_ARCH]
    prefill = dict(pass_counts(vlm))
    prefill[(vlm.num_patches, vlm.patch_dim, vlm.d_model)] = 1
    out = {(VLM_ARCH, "decode"): (4, pass_counts(vlm)),
           (VLM_ARCH, "prefill"): (VLM_PREFILL_M, prefill),
           (ENCDEC_ARCH, "decode"): (4, pass_counts(enc)),
           (ENCDEC_ARCH, "encoder"): (ENC_M, encdec_pass_counts(enc)[1])}
    for arch, rc in RECURRENT.items():
        cfg = cf[arch]
        head = (cfg.d_model, cfg.vocab_padded)
        prefill = {kn: c for kn, c in pass_counts(cfg).items() if kn != head}
        prefill[(1,) + head] = 1
        out[(arch, "decode")] = (4, pass_counts(cfg))
        out[(arch, "prefill")] = (rc["prompt"], prefill)
    return out


def family_k1_checks(dev, gen):
    """Phase 3 for the vlm, encdec and recurrent families at their
    published widths: every (M, K, N) K1 meets on phases 29-33's serving
    paths, bit for bit against its plain version: each linear of a decode
    pass at M = 4 and, but the head, at a chunk step's M = 128; internvl2's
    at its solo prefill's M = 384 (the head too) and patch_proj (3200,
    8192) at the 256 patch rows; whisper's encoder side (frame_proj (128,
    1280), a single K chunk, the encoder layers' and the cross K/V's
    linears) at M = 1500; mamba2's and recurrentgemma's linears at their
    solo prefill's M (512, 128; the head at the prompt's last row, M = 1)
    and every one of them at M = 1 (a request decoding alone) and M = 4.
    One scale group per row at M <= 16, one per operand above.  Returns
    phase 4's operands {(arch, regime, (M, K, N)): (aq, wq)} and the
    largest |difference|."""
    from repro_torch.core import potq
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.serve import quantized_weights as qw

    cases = {}  # (K, N) -> {M: [(arch, regime) kept for timing]}
    for (arch, regime), (m, counts) in family_regimes().items():
        for key in counts:
            mm, kn = (key[0], key[1:]) if len(key) == 3 else (m, key)
            cases.setdefault((arch, kn), {}).setdefault(mm, []).append(regime)
    cf = family_configs()
    for arch, cfg in cf.items():
        for kn in list(pass_counts(cfg)):
            if arch in RECURRENT:  # no chunk step; a decode row alone
                cases[(arch, kn)].setdefault(1, [])
            elif kn[1] != cfg.vocab_padded:  # a chunk step gathers before the head
                cases[(arch, kn)].setdefault(128, [])
    keep, max_err = {}, 0.0
    for (arch, (kk, nn)), ms in cases.items():
        w = torch.randn(kk, nn, generator=gen, device=dev) * 0.02 + 1e-3
        wq = qw.quantize_leaf("w", w, PAPER_FAITHFUL)
        del w
        for m, regimes in sorted(ms.items()):
            a = torch.randn(m, kk, generator=gen, device=dev)
            axes = (1,) if m <= 16 else None
            aq = potq.pot_quantize(a, 5, potq.compute_beta(a, 5, axes)).to(torch.bfloat16)
            del a
            out_k = K.potq_matmul_cuda(aq, wq)
            out_p = K.potq_matmul_plain(aq, wq)
            torch.cuda.synchronize()
            err = (out_k - out_p).abs().max().item()
            ok = torch.equal(out_k, out_p) and bool(torch.isfinite(out_k).all())
            print(f"{arch} M={m} K={kk} N={nn} {K.plan(m, nn, kk)}: equal={ok} "
                  f"max_abs_err={err}", flush=True)
            if not ok:
                raise SystemExit(f"K1 differs from its plain version at {(arch, m, kk, nn)}")
            max_err = max(max_err, err)
            for regime in regimes:
                keep[(arch, regime, (m, kk, nn))] = (aq, wq)
            del out_k, out_p
    return keep, max_err


def family_k1_timing(operands, flush):
    """Phase 4 for the vlm and encdec families: each operand pair of
    ``family_k1_checks`` timed (the kernel, its plain version and
    ``torch.matmul`` on the same bf16 operands, a yardstick and not the
    same function) with its bounds, and summed over each of
    ``family_regimes``.  Returns (the rows, {arch: {regime: sums}})."""
    from repro_torch.kernels import potq_matmul as K

    rows, sums, timed = [], {}, {}
    regimes = family_regimes()
    for (arch, regime, (m, kk, nn)), (aq, wq) in operands.items():
        counts = regimes[(arch, regime)][1]
        c = counts.get((kk, nn), counts.get((m, kk, nn)))
        if (m, kk, nn) not in timed:
            big = m * kk * nn > 1e10
            t_k = time_ms(lambda: K.potq_matmul_cuda(aq, wq), 3 if big else 10, flush)
            t_p = time_ms(lambda: K.potq_matmul_plain(aq, wq), 2, flush)
            t_l = time_ms(lambda: torch.matmul(aq, wq), 3 if big else 10, flush)
            t_ops = 2.0 * m * kk * nn / PEAK_BF16_FLOPS * 1e3
            t_bytes = (2 * (m * kk + kk * nn) + 4 * m * nn) / PEAK_BYTES * 1e3
            path, groups = K.plan(m, nn, kk)
            timed[(m, kk, nn)] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, t_ops=t_ops,
                                      t_bytes=t_bytes)
            row = dict(mode="q0", arch=arch, M=m, K=kk, N=nn, path=path, groups=groups,
                       ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops > t_bytes else "bytes",
                       fp64_tc_bound_ms=t_ops * PEAK_BF16_FLOPS / PEAK_FP64_TC_FLOPS)
            rows.append(row)
            print(json.dumps(row), flush=True)
        acc = sums.setdefault(arch, {}).setdefault(regime, dict(
            M=regimes[(arch, regime)][0], launches=sum(counts.values()), ms=0.0, plain_ms=0.0,
            library_ms=0.0, t_ops=0.0, t_bytes=0.0))
        for f, t in timed[(m, kk, nn)].items():
            acc[f] += c * t
    for arch, by in sums.items():
        for regime, acc in by.items():
            t_ops, t_bytes = acc.pop("t_ops"), acc.pop("t_bytes")
            acc.update(bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops > t_bytes else "bytes",
                       fp64_tc_bound_ms=t_ops * PEAK_BF16_FLOPS / PEAK_FP64_TC_FLOPS)
            print(f"{arch}: one {regime} pass (M={acc['M']}, {acc['launches']} launches):",
                  json.dumps(acc), flush=True)
    return rows, sums


# phase 3: K1's start variant at the row-parallel shapes of two model
# ranks, {(K, N): (arch, rows)}: llama3-8b's wo (K 4096 -> 2048 a rank)
# and down projection (14336 -> 7168) at a decode step's, a chunk step's
# and a lockstep wave's rows; whisper-large-v3's wo and co (1280 -> 640)
# and wo2 (5120 -> 2560) at a decode step's, a chunk step's and the
# encoder's rows; internvl2-76b's wo (8192 -> 4096) and down projection
# (28672 -> 14336) at a decode step's, a chunk step's and its solo
# prefill's rows; mamba2-2.7b's out_proj (5120 -> 2560) and
# recurrentgemma-2b's wout and wo (2560 -> 1280) and down projection
# (7680 -> 3840) at a decode step's rows and their solo prefill's
START_CASES = {(4096, 4096): ("llama3-8b", (4, 128, 512)),
               (14336, 4096): ("llama3-8b", (4, 128, 512)),
               (1280, 1280): (ENCDEC_ARCH, (4, 128, ENC_M)),
               (5120, 1280): (ENCDEC_ARCH, (4, 128, ENC_M)),
               (8192, 8192): (VLM_ARCH, (4, 128, VLM_PREFILL_M)),
               (28672, 8192): (VLM_ARCH, (4, 128, VLM_PREFILL_M)),
               (5120, 2560): ("mamba2-2.7b", (4, 512)),
               (2560, 2560): ("recurrentgemma-2b", (4, 128)),
               (7680, 2560): ("recurrentgemma-2b", (4, 128))}


def k1_start_checks(dev, gen):
    """Phase 3: the second rank's half of a row-parallel product continued
    from the first half's fold (``start``) equals the whole product and
    the plain version with the same start, bit for bit.  Returns (rows
    with the variant's time beside the plain half's, max_abs_err)."""
    from repro_torch.core import potq
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.serve import quantized_weights as qw

    rows, worst = [], 0.0
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    for (kk, nn), (arch, ms) in START_CASES.items():
        w = torch.randn(kk, nn, generator=gen, device=dev) * 0.02 + 1e-3
        wq = qw.quantize_leaf("w", w, PAPER_FAITHFUL)
        del w
        half = kk // 2
        w0, w1 = wq[:half].contiguous(), wq[half:].contiguous()
        for m in ms:
            a = torch.randn(m, kk, generator=gen, device=dev)
            axes = (1,) if m <= VERIFY_M else None
            aq = potq.pot_quantize(a, 5, potq.compute_beta(a, 5, axes)).to(torch.bfloat16)
            a0, a1 = aq[:, :half].contiguous(), aq[:, half:].contiguous()
            first = K.potq_matmul_cuda(a0, w0)
            second = K.potq_matmul_cuda(a1, w1, start=first)
            whole = K.potq_matmul_cuda(aq, wq)
            plain = K.potq_matmul_plain(a1, w1, start=first)
            torch.cuda.synchronize()
            err = (second - plain).abs().max().item()
            ok = torch.equal(second, whole) and torch.equal(second, plain)
            row = dict(arch=arch, M=m, K=kk, K_rank=half, N=nn, equal=ok, max_abs_err=err,
                       path=K.plan(m, nn, half),
                       start_ms=time_ms(lambda: K.potq_matmul_cuda(a1, w1, start=first), 5,
                                        flush),
                       half_ms=time_ms(lambda: K.potq_matmul_cuda(a1, w1), 5, flush))
            print("start variant:", json.dumps(row))
            if not ok:
                raise SystemExit(f"K1's start variant differs at {(m, kk, nn)}")
            worst = max(worst, err)
            rows.append(row)
    return rows, worst


def k1_edges(dev, gen):
    """Phase 3's edge cases of K1's paths, each bit for bit; returns the
    largest error (0 when every case is equal)."""
    from repro_torch.core import potq
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.serve import quantized_weights as qw
    from repro_torch.core.policy import PAPER_FAITHFUL

    worst = 0.0
    cases = [(m, kk, nn, "random") for m in (1, 2, 3, 5, 8, 31, 32, 33, 64, 127, 129, 4100)
             for kk, nn in ((1000, 1032), (1001, 1030))]
    # odd N: rows only 2-byte aligned, the scalar loads of either path
    cases += [(m, 1000, 1031, "random") for m in (1, 5, 33)]
    cases += [(m, 264, 1032, "lattice") for m in (4, 33, 300)]
    for i, (m, kk, nn, kind) in enumerate(cases):
        if kind == "lattice":
            aq, wq = _k1_lattice(dev, gen, m, kk, nn)
        else:
            wq = qw.quantize_leaf("w", torch.randn(kk, nn, generator=gen, device=dev) * 0.02,
                                  PAPER_FAITHFUL)
            a = torch.randn(m, kk, generator=gen, device=dev)
            aq = potq.pot_quantize(a, 5, potq.compute_beta(a, 5, (1,))).to(torch.bfloat16)
            # a subnormal row and an all-zero row (for M < 3, one of them)
            sub = torch.randint(0, 2, (kk,), generator=gen, device=dev) * 2.0 - 1.0
            sub = torch.ldexp(sub, -128 - torch.randint(0, 6, (kk,), generator=gen,
                                                        device=dev)).to(torch.bfloat16)
            if m >= 3:
                aq[0], aq[1] = 0.0, sub
            else:
                aq[m - 1] = sub if i % 2 == 0 else 0.0
        out_k = K.potq_matmul_cuda(aq, wq)
        out_p = K.potq_matmul_plain(aq, wq)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        ok = torch.equal(out_k, out_p) and bool(torch.isfinite(out_k).all())
        print(f"edge M={m} K={kk} N={nn} {kind} {K.plan(m, nn, kk)}: equal={ok} "
              f"max_abs_err={err}", flush=True)
        if not ok:
            raise SystemExit(f"K1 differs from its plain version at {(m, kk, nn, kind)}")
        worst = max(worst, err)
    return worst


def _grad_operands(dev, gen, m, k, n, *, subnormal=False):
    """a, w, g as a training step makes them and the forward's residuals."""
    from repro_torch.core import potq

    a = torch.randn(m, k, generator=gen, device=dev) * 1.7
    w = torch.randn(k, n, generator=gen, device=dev) * 0.02 + 1e-3
    g = torch.randn(m, n, generator=gen, device=dev) * 1e-4
    if subnormal:
        g[0, :4] = torch.tensor([1e-40, -3e-39, 0.0, -0.0], device=dev)
        g[1] = 0.0
    amax = a.abs().amax()
    t = amax * 0.95
    aq = potq.pot_quantize(torch.clamp(a, -t, t), 5).to(torch.bfloat16)
    wq = potq.pot_quantize(w - w.mean(), 5).to(torch.bfloat16)
    return a, g, aq, wq, amax, t


def _lattice_operands(dev, gen, m, k, n):
    """Operands whose products reach both ends of the chunk lattice at the
    LM head's 6 x 5 pair: G's scaled values are ±2^±15 and Wq's and Aq's
    ±2^±7 (around their betas), big and small alternating along the
    contraction, with random signs; along N the big products of a chunk's
    second half cancel the first half's, so the small ones decide dA."""
    from repro_torch.core import potq

    def pattern(rows, cols, emax, beta):
        par = (torch.arange(rows, device=dev)[:, None] + torch.arange(cols, device=dev)[None]) % 2
        sign = torch.randint(0, 2, (rows, cols), generator=gen, device=dev) * 2.0 - 1.0
        e = torch.where(par == 0, emax, -emax)
        return sign, e, potq.exp2i(e + beta)

    sg, eg, mag = pattern(m, n, 15, -10)
    col = torch.arange(n, device=dev) % 128
    first = torch.clamp(torch.arange(n, device=dev) - 64, min=0)
    second = (col >= 64)[None].expand(m, n)
    sg = torch.where(second & (eg[:, first] > 0), -sg[:, first], sg)
    g = sg * mag
    sw, _, wmag = pattern(k, n, 7, -3)
    wq = (sw * wmag).to(torch.bfloat16)
    sa, _, amag = pattern(m, k, 7, -2)
    aq = (sa * amag).to(torch.bfloat16)
    a = torch.randn(m, k, generator=gen, device=dev) * 1.7
    amax = a.abs().amax()
    return a, g, aq, wq, amax, amax * 0.95


def grad_checks(dev, gen, cases, max_err):
    """Phase 8's checks: for each (M, K, N, bits_g, PRC, operand kind) case
    the G pre-pass, K2 (dA, the dgamma rows, dgamma) and K3 (dW) against
    their plain versions, and K2/K3 with their own pre-pass, bit for bit;
    at the olmo-1b and whisper training shapes also K1 under one
    activation scale.  Updates ``max_err``; returns phase 9's timing
    inputs, {(M, K, N): ...} at olmo-1b's, an expert's and whisper's
    training shapes, PRC on."""
    from repro_torch.core import potq
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.kernels import ref

    timing_inputs = {}
    whisper = whisper_train_counts()
    for m, kk, nn, bits, prc, kind in cases:
        if kind == "lattice":
            a, g, aq, wq, amax, t = _lattice_operands(dev, gen, m, kk, nn)
        else:
            a, g, aq, wq, amax, t = _grad_operands(dev, gen, m, kk, nn,
                                                   subnormal=kind == "subnormal")
        e = potq.pot_emax(bits)
        beta = potq.compute_beta(g, bits)
        s = torch.stack([potq.exp2i(-beta), potq.exp2i(beta), t])
        gq_k = KG.quantize_g_cuda(g, s, emax_g=e)
        gq_p = KG._quantize_g(g, s, e)
        da_k, rows_k = KG.grad_da_cuda(g, wq, a if prc else None, s, emax_g=e, prc=prc, gq=gq_k)
        da_p, rows_p = KG.grad_da_plain(g, wq, a if prc else None, s, emax_g=e, prc=prc)
        dw_k = KG.grad_dw_cuda(aq, g, s, emax_g=e, gq=gq_k)
        dw_p = KG.grad_dw_plain(aq, g, s, emax_g=e)
        # K2 and K3 alone (each launches its own pre-pass) give the same bits
        da_1, _ = KG.grad_da_cuda(g, wq, a if prc else None, s, emax_g=e, prc=prc)
        dw_1 = KG.grad_dw_cuda(aq, g, s, emax_g=e)
        torch.cuda.synchronize()
        ok = (torch.equal(gq_k.float(), gq_p) and torch.equal(da_k, da_p)
              and torch.equal(dw_k, dw_p) and torch.equal(da_1, da_k) and torch.equal(dw_1, dw_k))
        errs = dict(gq=(gq_k.float() - gq_p).abs().max().item(),
                    da=(da_k - da_p).abs().max().item(), dw=(dw_k - dw_p).abs().max().item())
        if prc:
            dg_k = ref.halves_fold(rows_k) * amax
            dg_p = ref.halves_fold(rows_p) * amax
            ok = ok and torch.equal(rows_k, rows_p) and torch.equal(dg_k, dg_p)
            errs.update(rows=(rows_k - rows_p).abs().max().item(),
                        dgamma=(dg_k - dg_p).abs().item())
        ok = ok and bool(torch.isfinite(da_k).all()) and bool(torch.isfinite(dw_k).all())
        print(f"M={m} K={kk} N={nn} bits_g={bits} prc={prc} {kind}: "
              f"equal={ok} {json.dumps(errs)}", flush=True)
        if not ok:
            raise SystemExit(f"K2/K3/pre-pass differ from their plain versions at "
                             f"{(m, kk, nn, bits, prc, kind)}")
        max_err["gq"] = max(max_err["gq"], errs["gq"])
        max_err["k2"] = max(max_err["k2"], errs["da"], errs.get("rows", 0.0), errs.get("dgamma", 0.0))
        max_err["k3"] = max(max_err["k3"], errs["dw"])
        del da_k, da_p, dw_k, dw_p, da_1, dw_1, gq_k, gq_p
        if m == MOE_TRAIN_M and prc and kind == "random" and (kk, nn) in MOE_TRAIN_COUNTS:
            timing_inputs[(m, kk, nn)] = (a, g, aq, wq, s, e)
        if prc and kind == "random" and ((m == TRAIN_M and (kk, nn) in TRAIN_COUNTS)
                                         or (m, kk, nn) in whisper):
            # K1 as the training forward launches it: M = B*S, one scale
            out_k = K.potq_matmul_cuda(aq, wq)
            out_p = K.potq_matmul_plain(aq, wq)
            torch.cuda.synchronize()
            err = (out_k - out_p).abs().max().item()
            ok = torch.equal(out_k, out_p) and bool(torch.isfinite(out_k).all())
            print(f"K1 M={m} K={kk} N={nn}: equal={ok} max_abs_err={err}", flush=True)
            if not ok:
                raise SystemExit(f"K1 differs from its plain version at {(m, kk, nn)}")
            max_err["k1"] = max(max_err["k1"], err)
            del out_k, out_p
            timing_inputs[(m, kk, nn)] = (a, g, aq, wq, s, e)
    return timing_inputs


# K2's start variant (phase 8): olmo-1b's column-parallel linears on the
# (1, 2) mesh at phase 37o's rows (M = 4 x 512), each rank N / 2 of wq, wk,
# wv (K 2048, N 2048), wi_gate and wi_up (2048, 8192) and the head (2048,
# 50688, G at 6 bits), dA's fold chained over the two halves; the
# row-parallel wo (2048 -> 2048) and down projection (8192 -> 2048) with
# K / 2 a rank, their dgamma rows' fold chained; and a ragged case (M, K
# and the last rank's N off every tile, three ranks)
TP_TRAIN_M = 4 * 512
K2_START_COLUMN = ((2048, 2048, 5), (2048, 8192, 5), (2048, 50688, 6))
K2_START_ROW = ((2048, 2048), (8192, 2048))
K2_START_RAGGED = (300, 200, (128, 256, 70))


def k2_start_checks(dev, gen):
    """Phase 8's chain checks of K2: a column-parallel dA chained over the
    ranks' N (``start``; the ranks before the last return the raw running
    sum, ``last=False``) and a row-parallel linear's dgamma rows chained
    over its K (``rows_start``) equal the unsplit launch and the chained
    plain version bit for bit; the last rank's launch is timed beside the
    same launch without a start.  Returns (rows, max_abs_err)."""
    from repro_torch.core import potq
    from repro_torch.kernels import potq_grad as KG

    rows, worst = [], 0.0
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def chain(pieces, kind, a, s, e):
        """Each rank's K2 in rank order (CUDA, then plain)."""
        outs = []
        for fn in (KG.grad_da_cuda, KG.grad_da_plain):
            carry, das = None, []
            for i, (g_r, w_r, a_r) in enumerate(pieces):
                last = i == len(pieces) - 1
                if kind == "column":
                    carry, r = fn(g_r, w_r, a if last else None, s, emax_g=e, prc=last,
                                  start=carry, last=last)
                else:
                    da, carry = fn(g_r, w_r, a_r, s, emax_g=e, prc=True, rows_start=carry)
                    das.append(da)
            outs.append((carry, r if kind == "column" else torch.cat(das, dim=1)))
        return outs

    cases = [("column", TP_TRAIN_M, kk, nn, b, (nn // 2, nn // 2))
             for kk, nn, b in K2_START_COLUMN]
    cases += [("row", TP_TRAIN_M, kk, nn, 5, (kk // 2, kk // 2)) for kk, nn in K2_START_ROW]
    m_r, k_r, widths = K2_START_RAGGED
    cases += [("column", m_r, k_r, sum(widths), 5, widths),
              ("row", m_r, sum(widths), k_r, 5, widths)]
    for kind, m, kk, nn, bits, widths in cases:
        a, g, _, wq, _, t = _grad_operands(dev, gen, m, kk, nn)
        e = potq.pot_emax(bits)
        beta = potq.compute_beta(g, bits)
        s = torch.stack([potq.exp2i(-beta), potq.exp2i(beta), t])
        whole_da, whole_rows = KG.grad_da_cuda(g, wq, a, s, emax_g=e, prc=True)
        pieces, lo = [], 0
        for n in widths:
            if kind == "column":
                pieces.append((g[:, lo:lo + n].contiguous(), wq[:, lo:lo + n].contiguous(), None))
            else:
                pieces.append((g, wq[lo:lo + n].contiguous(), a[:, lo:lo + n].contiguous()))
            lo += n
        (k_first, k_second), (p_first, p_second) = chain(pieces, kind, a, s, e)
        # column: (dA, rows); row: (rows, dA)
        da_k, rows_k = (k_first, k_second) if kind == "column" else (k_second, k_first)
        da_p, rows_p = (p_first, p_second) if kind == "column" else (p_second, p_first)
        torch.cuda.synchronize()
        err = max((da_k - da_p).abs().max().item(), (rows_k - rows_p).abs().max().item())
        ok = (torch.equal(da_k, whole_da) and torch.equal(rows_k, whole_rows)
              and torch.equal(da_k, da_p) and torch.equal(rows_k, rows_p))
        # the last rank's launch, with and without its start
        g_l, w_l, a_l = pieces[-1]
        if kind == "column":
            last_rank = (g_l, w_l, a)
            chained = dict(start=KG.grad_da_cuda(*pieces[0][:2], None, s, emax_g=e, prc=False,
                                                 last=False)[0])
            n_l, k_l = w_l.shape[1], kk
        else:
            last_rank = (g_l, w_l, a_l)
            chained = dict(rows_start=KG.grad_da_cuda(*pieces[0], s, emax_g=e, prc=True)[1])
            n_l, k_l = nn, w_l.shape[0]

        def with_start():
            return KG.grad_da_cuda(*last_rank, s, emax_g=e, prc=True, **chained)

        def without():
            return KG.grad_da_cuda(*last_rank, s, emax_g=e, prc=True)
        t_ops, t_bytes = train_bound(m, k_l, n_l, "k2")
        if kind == "column":  # the start read once
            t_bytes += 4.0 * m * k_l / PEAK_BYTES * 1e3
        row = dict(kind=kind, M=m, K=kk, N=nn, bits_g=bits, ranks=len(widths),
                   rank_widths=list(widths), equal=ok, max_abs_err=err,
                   start_ms=time_ms(with_start, 3, flush), half_ms=time_ms(without, 3, flush),
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops > t_bytes else "bytes",
                   fp64_tc_bound_ms=2.0 * m * k_l * n_l / PEAK_FP64_TC_FLOPS * 1e3)
        print("K2 start variant:", json.dumps(row), flush=True)
        if not ok:
            raise SystemExit(f"K2's chained launches differ from the unsplit launch or the "
                             f"plain chain at {(kind, m, kk, nn, widths)}")
        worst = max(worst, err)
        rows.append(row)
        del a, g, wq, whole_da, pieces, chained, da_k, da_p
    torch.cuda.empty_cache()
    return rows, worst


def training_kernels(dev, detail):
    """Phases 8 and 9: K1/K2/K3 and the G pre-pass at the training shapes
    against their plain versions, then timing; each summed over one
    olmo-1b step, one llama4-scout expert of one layer and one
    whisper-large-v3 step."""
    from repro_torch import configs
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K

    phase("8 K2/K3 (and K1) vs plain versions at the training shapes (bit for bit)")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(TRAIN_M, kk, nn, 6 if nn == 50688 else 5, prc, "random")
             for kk, nn in TRAIN_COUNTS for prc in (True, False)]
    cases += [(200, 130, 300, bits, prc, "subnormal") for bits in (5, 6) for prc in (True, False)]
    # edges of the tiling: M, K, N off the 128 tile, the 32 slice and the
    # 8 k-step, rows that are not 16-byte aligned (scalar loads), below a tile
    cases += [(4160, 2056, 2052, 5, True, "subnormal"), (4160, 2052, 2056, 6, True, "subnormal"),
              (4100, 2056, 2056, 5, False, "subnormal"), (17, 9, 5, 5, True, "subnormal"),
              (1, 1, 1, 6, True, "random")]
    cases += [(520, 264, 1032, 6, True, "lattice")] + MOE_GRAD_CASES
    # whisper-large-v3's training shapes at phase 31b's batch (the head's
    # G at 6 bits)
    vocab = configs.get_config(ENCDEC_ARCH).vocab_padded
    cases += [(m, kk, nn, 6 if nn == vocab else 5, True, "random")
              for m, kk, nn in whisper_train_counts()]
    max_err = {"k1": 0.0, "k2": 0.0, "k3": 0.0, "gq": 0.0}
    timing_inputs = grad_checks(dev, gen, cases, max_err)
    start_rows, err = k2_start_checks(dev, gen)
    max_err["k2"] = max(max_err["k2"], err)
    detail["k2_start_variant"] = start_rows

    phase("9 K1/K2/K3 and pre-pass timing at the training shapes (CUDA events, L2 flushed)")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows, per_step, per_expert, per_whisper = [], {}, {}, {}
    whisper = whisper_train_counts()
    for key in ("k1", "k2", "k3", "gq"):
        per_step[key] = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                         "t_ops": 0.0, "t_bytes": 0.0, "max_abs_err": max_err[key]}
        per_whisper[key] = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                            "t_ops": 0.0, "t_bytes": 0.0, "fp64_tc_bound_ms": 0.0}
    for key in ("k2", "k3", "gq"):
        per_expert[key] = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                           "t_ops": 0.0, "t_bytes": 0.0}
    for key in ("k1", "k2", "k3"):
        per_step[key]["fp64_tc_bound_ms"] = 0.0
    for key in ("k2", "k3"):
        per_expert[key]["fp64_tc_bound_ms"] = 0.0
    per_step["k2"]["prepass_ms"] = 0.0
    per_step["gq"]["library_ms"] = None
    per_expert["gq"]["library_ms"] = None
    per_whisper["gq"]["library_ms"] = None
    del per_whisper["gq"]["fp64_tc_bound_ms"]
    for (m, kk, nn), (a, g, aq, wq, s, e) in timing_inputs.items():
        gq = KG.quantize_g_cuda(g, s, emax_g=e)
        expert = m == MOE_TRAIN_M
        fns = {
            "k1": (lambda: K.potq_matmul_cuda(aq, wq),
                   lambda: K.potq_matmul_plain(aq, wq),
                   lambda: torch.matmul(aq, wq)),
            # K2's row includes its pre-pass (gq=None launches it)
            "k2": (lambda: KG.grad_da_cuda(g, wq, a, s, emax_g=e, prc=True),
                   lambda: KG.grad_da_plain(g, wq, a, s, emax_g=e, prc=True),
                   lambda: torch.matmul(gq, wq.T)),
            "k3": (lambda: KG.grad_dw_cuda(aq, g, s, emax_g=e, gq=gq),
                   lambda: KG.grad_dw_plain(aq, g, s, emax_g=e),
                   lambda: torch.matmul(aq.T, gq)),
            "gq": (lambda: KG.quantize_g_cuda(g, s, emax_g=e),
                   lambda: KG._quantize_g(g, s, e),
                   None),
        }
        if expert:  # an expert's forward is phase 4's expert-batched launch
            del fns["k1"]
        for key, (kern, plain, lib) in fns.items():
            if expert:
                c = MOE_TRAIN_COUNTS[(kk, nn)]
            elif (m, kk, nn) in whisper:
                c = whisper[(m, kk, nn)][0 if key == "k1" else 1]
            else:
                c = (TRAIN_K1_COUNTS if key == "k1" else TRAIN_COUNTS)[(kk, nn)]
            t_k = time_ms(kern, 3 if key != "gq" else 10, flush)
            t_p = time_ms(plain, 1, flush)
            t_l = time_ms(lib, 5, flush) if lib is not None else None
            if key == "gq":  # G f32 read once, Gq bf16 written once
                t_ops, t_bytes = 0.0, 6.0 * m * nn / PEAK_BYTES * 1e3
            else:
                t_ops, t_bytes = train_bound(m, kk, nn, key)
            row = dict(kernel=key, M=m, K=kk, N=nn, ms=t_k, plain_ms=t_p, library_ms=t_l,
                       bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops > t_bytes else "bytes")
            if expert:
                row.update(arch="llama4-scout-17b-a16e", launches_per_expert_layer=c)
            else:
                row["launches_per_step"] = c
            if (m, kk, nn) in whisper:
                row["arch"] = ENCDEC_ARCH
                acc = per_whisper[key]
            else:
                acc = (per_expert if expert else per_step)[key]
            if key != "gq":
                row["fp64_tc_bound_ms"] = 2.0 * m * kk * nn / PEAK_FP64_TC_FLOPS * 1e3
                acc["fp64_tc_bound_ms"] += c * row["fp64_tc_bound_ms"]
            rows.append(row)
            print(json.dumps(row), flush=True)
            acc["ms"] += c * t_k
            acc["plain_ms"] += c * t_p
            if t_l is not None:
                acc["library_ms"] += c * t_l
            acc["t_ops"] += c * t_ops
            acc["t_bytes"] += c * t_bytes
        del gq
    per_step["k2"]["prepass_ms"] = per_step["gq"]["ms"]
    for sums in (per_step, per_expert, per_whisper):
        for acc in sums.values():
            t_ops, t_bytes = acc.pop("t_ops"), acc.pop("t_bytes")
            acc["bound_ms"] = max(t_ops, t_bytes)
            acc["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
    for key, acc in per_step.items():
        print(f"{key}, one training step ({step_launches()[key]} launches):", json.dumps(acc))
        # one llama4-scout expert's backward of one layer, at its
        # training rows (M = 320): gate, up and down
        acc["moe_expert_layer"] = per_expert.get(key)
        if key in per_expert:
            print(f"{key}, one llama4-scout expert of one layer (M={MOE_TRAIN_M}, "
                  f"{sum(MOE_TRAIN_COUNTS.values())} launches):", json.dumps(per_expert[key]))
        acc["whisper_step"] = per_whisper[key]
        print(f"{key}, one whisper-large-v3 training step "
              f"({step_launches(configs.get_config(ENCDEC_ARCH))[key]} launches):",
              json.dumps(per_whisper[key]))
    detail["train_kernels_per_step"] = per_step
    detail["train_kernel_shapes"] = rows
    del timing_inputs, flush
    torch.cuda.empty_cache()
    return per_step


def _state_copy(tree):
    from repro_torch.models import spec

    return spec.tree_map(lambda x: x.clone(), tree)


def _state_load(dst, src):
    from repro_torch.models import spec

    spec.tree_map(lambda d, s: d.copy_(s), dst, src)


def training(dev, detail):
    """Phases 10-12: the full-width trainer, determinism, CUDA vs CPU."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.data import pipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.train import make_train_step

    counters = _kernel_counters()

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    phase("10 train olmo-1b at full width (batch 8 x seq 512)")
    steps = 4
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    run = train_cli.main(["--arch", "olmo-1b", "--steps", str(steps), "--batch", "8",
                          "--seq", "512", "--log-every", "1"])
    wall = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in run.records:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0):
            raise SystemExit(f"bad training step {r}")
    want = {k: v * steps for k, v in step_launches().items()}
    print(f"launches over {steps} steps: {launches} (expected {want}); "
          f"peak device memory {peak:.2f} GiB; run wall {wall:.1f} s")
    if launches != want:
        raise SystemExit(f"kernel launches {launches}, expected {want}")
    # every bit of the losses, for the next change to compare with
    print("losses:", [repr(r["loss"]) for r in run.records], flush=True)
    timed = run.records[1:]
    train = dict(steps=run.records, peak_gib=peak, launches=launches,
                 mean_step_s=sum(r["seconds"] for r in timed) / len(timed),
                 tokens_per_s=sum(r["tokens_per_s"] for r in timed) / len(timed))

    # one more step, profiled: device busy/idle share and time by kernel
    batch = pipeline.make_batch(run.cfg, run.shape, steps, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    reset()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run.step_fn(run.params, run.opt_state, batch, steps)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    per_step = read()
    if per_step != step_launches():
        raise SystemExit(f"one step launched {per_step}, expected {step_launches()}")
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    # K2 counts its pre-pass and its rows fold (grad_da_rows_fold_kernel)
    by = {k: sum(e.time_range.elapsed_us() for e in kern if any(p in e.name for p in ps)) / 1e3
          for k, ps in KERNEL_PATTERNS.items()}
    prof_row = dict(wall_ms=t_prof * 1e3, device_kernels=len(kern), device_busy_ms=busy_us / 1e3,
                    launches=per_step, **by,
                    idle_share=(1 - busy_us / 1e3 / (train["mean_step_s"] * 1e3)) if kern else None)
    print("profiled training step:", json.dumps(prof_row), flush=True)
    train["profiled_step"] = prof_row

    phase("11 determinism: one step twice from the same state")
    batch = pipeline.make_batch(run.cfg, run.shape, steps + 1, device=dev)
    saved = (_state_copy(run.params), _state_copy(run.opt_state))
    _, _, m1 = run.step_fn(run.params, run.opt_state, batch, steps + 1)
    first = _state_copy(run.params)
    _state_load(run.params, saved[0])
    _state_load(run.opt_state, saved[1])
    del saved
    _, _, m2 = run.step_fn(run.params, run.opt_state, batch, steps + 1)
    torch.cuda.synchronize()
    same = torch.equal(m1["loss"], m2["loss"]) and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(spec.named_leaves(first),
                                                    spec.named_leaves(run.params)))
    print(f"loss {float(m1['loss'])!r} / {float(m2['loss'])!r}; every parameter bit-equal: {same}")
    if not same:
        raise SystemExit("two runs of one training step differ")
    train["deterministic"] = same
    del first
    train["quantize_attention_step"] = qa_train_step(dev, run, batch, steps + 2, prof_row)
    del run, batch
    torch.cuda.empty_cache()

    phase("12 training, CUDA vs CPU (smoke width)")
    scfg = configs.smoke_config("olmo-1b")
    p_cpu = spec.materialize(registry.param_specs(scfg), torch.Generator().manual_seed(0))
    p_gpu = spec.params_from_numpy({n: x.numpy() for n, x in spec.named_leaves(p_cpu)}, dev)
    b_cpu = pipeline.make_batch(scfg, ShapeConfig("t", 64, 8, "train"), 0, device="cpu")
    b_gpu = {k: v.to(dev) for k, v in b_cpu.items()}
    res = {}
    for d, p, b in (("cpu", p_cpu, b_cpu), ("cuda", p_gpu, b_gpu)):
        opt = adamw(warmup_cosine_schedule(3e-3, 5, 30))
        step = make_train_step(scfg, PAPER_FAITHFUL, opt)
        loss, grads = step.grads(p, b)
        state = opt.init(p)
        p, _, _ = step(p, state, b, 0)
        res[d] = (float(loss), {n: g.cpu() for n, g in spec.named_leaves(grads)},
                  {n: x.cpu() for n, x in spec.named_leaves(p)})
    (lc, gc, pc), (lg, gg, pg) = res["cpu"], res["cuda"]
    g_worst = max(float((gg[n] - gc[n]).abs().max() / gc[n].abs().max().clamp(min=1e-30))
                  for n in gc)
    p_worst = max(float((pg[n] - pc[n]).abs().max()) for n in pc)
    cmp = dict(loss_cpu=lc, loss_cuda=lg, grad_rel_err=g_worst, param_abs_err=p_worst)
    print(json.dumps(cmp), f"(tolerances: loss rtol {LOSS_RTOL}, grads {GRAD_RTOL} x max|g|, "
          f"params atol {PARAM_ATOL})")
    train["cuda_vs_cpu"] = cmp
    if not (abs(lg - lc) <= LOSS_RTOL * abs(lc) and g_worst <= GRAD_RTOL and p_worst <= PARAM_ATOL):
        raise SystemExit("CUDA and CPU training steps disagree beyond the tolerances")
    detail["train"] = train
    return train


def moe_training(dev, detail):
    """Phase 28: MoE training at smoke width, both MoE decoders
    (``smoke_training`` with ``LOSS_RTOL``).  Returns the launch counts of
    each config's step."""
    phase("28 MoE training at smoke width: CUDA vs CPU, a step twice, launches a step")
    out = smoke_training(dev, MOE_ARCHS, LOSS_RTOL)
    detail["moe_training"] = out
    return {arch: r["launches"] for arch, r in out.items()}


def smoke_training(dev, archs, loss_rtol, policy=None):
    """Three AdamW steps of each arch at smoke width (under ``policy``,
    default ``PAPER_FAITHFUL``) on the card against the
    same steps on the CPU (each loss within ``loss_rtol``, the first
    step's gradients within ``GRAD_RTOL`` of their leaf's largest; a top-1
    router's exact gradient is zero (its gate is g / g), so its rounding
    noise is held to ``GRAD_RTOL`` of the tree's largest), the last step
    run twice from the same state bit for bit, and its K1/K2/K3/pre-pass
    launches equal to ``step_launches``.  Under ``quantize_attention`` the
    attention operands' PoT codes are compared too (``_attention_ties``):
    where a near tie rounds differently on the two devices, the gradients
    and the later losses follow two different quantized models and are
    reported, not held; the first loss still is.  Returns {arch: its row}."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.data import pipeline
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.train import make_train_step

    counters = _kernel_counters()
    policy = policy or PAPER_FAITHFUL
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)  # as the trainer runs
    out = {}
    for arch in archs:
        scfg = configs.smoke_config(arch)
        p_cpu = spec.materialize(registry.param_specs(scfg), torch.Generator().manual_seed(0))
        p_gpu = spec.params_from_numpy({n: x.numpy() for n, x in spec.named_leaves(p_cpu)}, dev)
        batches = [pipeline.make_batch(scfg, ShapeConfig("t", 64, 8, "train"), i, device="cpu")
                   for i in range(3)]
        runs, calls = {}, {}
        for d, where, p in (("cpu", "cpu", p_cpu), ("cuda", dev, p_gpu)):
            opt = adamw(warmup_cosine_schedule(3e-3, 5, 30))
            step = make_train_step(scfg, policy, opt)
            bs = [{k: v.to(where) for k, v in b.items()} for b in batches]
            with _recording_qact() as calls[d]:
                _, grads = step.grads(p, bs[0])
            state = opt.init(p)
            losses = []
            for i, b in enumerate(bs):
                if d == "cuda" and i == len(bs) - 1:
                    saved = (_state_copy(p), _state_copy(state))
                    torch.cuda.synchronize()
                    _zero_launches()
                p, state, m = step(p, state, b, i)
                losses.append(float(m["loss"]))
            runs[d] = (losses, {n: g.cpu() for n, g in spec.named_leaves(grads)})
        launches = {k: fn.launches for k, fn in counters.items()}
        first = _state_copy(p)
        _state_load(p, saved[0])
        _state_load(state, saved[1])
        p, state, m = step(p, state, bs[-1], len(bs) - 1)
        torch.cuda.synchronize()
        same = float(m["loss"]) == runs["cuda"][0][-1] and all(
            torch.equal(x, y) for (_, x), (_, y) in zip(spec.named_leaves(first),
                                                        spec.named_leaves(p)))
        (lc, gc), (lg, gg) = runs["cpu"], runs["cuda"]
        top = max(float(g.abs().max()) for g in gc.values())
        top1 = scfg.moe is not None and scfg.moe.top_k == 1
        g_worst = max(float((gg[n] - gc[n]).abs().max()) / max(
            top if top1 and "/router/" in n else float(gc[n].abs().max()), 1e-30)
            for n in gc)
        want = step_launches(scfg)
        tie = _attention_ties(arch, calls["cpu"], calls["cuda"])
        row = dict(losses_cpu=lc, losses_cuda=lg, grad_rel_err=g_worst, step_twice_equal=same,
                   launches=launches, expected_launches=want, attention_tie=tie)
        print(f"{arch}:", json.dumps(row), f"(tolerances: loss rtol {loss_rtol}, grads "
              f"{GRAD_RTOL} x max|g|)", flush=True)
        held = 1 if tie else len(lc)  # after a tie: the first loss only
        if not all(abs(a - b) <= loss_rtol * abs(b) for a, b in zip(lg[:held], lc[:held])) or \
                not (tie or g_worst <= GRAD_RTOL):
            raise SystemExit(f"{arch}: CUDA and CPU training disagree beyond the tolerances")
        if not same:
            raise SystemExit(f"{arch}: two runs of one training step differ")
        if launches != want:
            raise SystemExit(f"{arch}: a training step launched {launches}, expected {want}")
        out[arch] = row
    torch.use_deterministic_algorithms(deterministic)
    return out


@contextlib.contextmanager
def _recording_qact():
    """Record (input, output) of every attention-operand quantization
    (``mfmac._qact``) made inside the block, on the host."""
    from repro_torch.core import mfmac

    calls, orig = [], mfmac._qact

    def recorded(x, bits, axes=None, *scale_groups, **kw):
        out = orig(x, bits, axes, *scale_groups, **kw)
        calls.append((x.detach().float().cpu(), out.detach().float().cpu(), bits, axes))
        return out

    mfmac._qact = recorded
    try:
        yield calls
    finally:
        mfmac._qact = orig


# a near tie: an element whose scaled mantissa lies within this many ulps of
# the rounding threshold of round(log2) (potq.SQRT_HALF_UP) on both devices
TIE_ULPS = 8


def _attention_ties(arch, cpu_calls, cuda_calls):
    """Walk the attention-operand quantizations of one step in order on the
    two devices.  Where every PoT code is equal, returns None.  At the
    first call whose codes differ, every differing element must be a near
    tie (its scaled mantissa within ``TIE_ULPS`` of the threshold on both
    devices, the group scales equal), else this fails; returns where the
    tie was.  Past that call the two devices run two different quantized
    models."""
    from repro_torch.core import potq

    if len(cpu_calls) != len(cuda_calls):
        raise SystemExit(f"{arch}: {len(cpu_calls)} vs {len(cuda_calls)} attention quantizations")
    for i, ((xc, oc, bits, axes), (xg, og, _, _)) in enumerate(zip(cpu_calls, cuda_calls)):
        if torch.equal(oc, og):
            continue
        bc, bg = potq.compute_beta(xc, bits, axes), potq.compute_beta(xg, bits, axes)
        diff = oc != og
        # each device's scaled mantissa of the differing elements, in [0.5, 1)
        dist = [(torch.frexp((x.abs() / potq.exp2i(bc))[diff])[0] - potq.SQRT_HALF_UP).abs()
                / 2.0 ** -24 for x in (xc, xg)]
        tie = dict(call=i, of=len(cpu_calls), shape=list(xc.shape), codes_differ=int(diff.sum()),
                   max_input_rel_diff=float((xc - xg).abs().max() / xc.abs().max()),
                   ulps_from_threshold=[float(d.max()) for d in dist])
        print(f"{arch}: first differing attention quantization:", json.dumps(tie))
        if not (torch.equal(bc, bg) and all(bool((d <= TIE_ULPS).all()) for d in dist)):
            raise SystemExit(f"{arch}: CUDA and CPU quantize an attention operand differently "
                             f"away from a near tie ({tie})")
        return tie
    return None


def recurrent_training(dev, detail):
    """Phase 34: mamba2-2.7b and recurrentgemma-2b at smoke width
    (``smoke_training`` with ``FAMILY_LOSS_RTOL``: CUDA against CPU, a step
    twice, launches a step).  Full width does not fit one card's training
    state at ~21 bytes a parameter (ROADMAP).  Returns the launches a step
    by arch."""
    phase("34 ssm and hybrid training at smoke width: CUDA vs CPU, a step twice, "
          "launches a step")
    res = smoke_training(dev, tuple(RECURRENT), FAMILY_LOSS_RTOL)
    detail["recurrent_training"] = res
    return {a: r["launches"] for a, r in res.items()}


def family_training(dev, detail):
    """Phase 31: (a) internvl2-76b and whisper-large-v3 at smoke width
    (``smoke_training`` with ``FAMILY_LOSS_RTOL``); (b) whisper-large-v3 at
    full width, ``PAPER_FAITHFUL``, through ``launch.train.main``: batch 2
    x 1500 frames x 448 decoder tokens, 3 AdamW steps with recomputation,
    the losses finite and printed with repr, the launches of each step
    equal to ``step_launches``, peak GiB, then one more step profiled (K1,
    K2 with its pre-pass, K3 device ms beside their FP64 tensor-core
    bounds) and one step run twice from the same state, bit-equal.
    Returns (31a's launches a step by arch, 31b's launches over its 3
    steps, 31b's profiled step)."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.models import spec

    phase("31a vlm and encdec training at smoke width: CUDA vs CPU, a step twice, "
          "launches a step")
    small = smoke_training(dev, (VLM_ARCH, ENCDEC_ARCH), FAMILY_LOSS_RTOL)
    res = {"smoke": small}

    phase(f"31b train {ENCDEC_ARCH} at full width, {WHISPER_TRAIN_LAYERS} + "
          f"{WHISPER_TRAIN_LAYERS} layers (batch {WHISPER_TRAIN_BATCH} x "
          f"{configs.get_config(ENCDEC_ARCH).enc_seq} frames x {WHISPER_TRAIN_SEQ} tokens)")
    counters = _kernel_counters()
    steps = 3
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    with _arch_depth(ENCDEC_ARCH, n_layers=WHISPER_TRAIN_LAYERS,
                     enc_layers=WHISPER_TRAIN_LAYERS):
        run = train_cli.main(["--arch", ENCDEC_ARCH, "--steps", str(steps),
                              "--batch", str(WHISPER_TRAIN_BATCH), "--seq",
                              str(WHISPER_TRAIN_SEQ), "--log-every", "1"])
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cfg = run.cfg
    want = step_launches(cfg)
    for r in run.records:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0):
            raise SystemExit(f"bad training step {r}")
    print(f"launches over {steps} steps: {launches} (expected {want} a step); peak device "
          f"memory {peak:.2f} GiB; run wall {wall:.1f} s")
    print("losses:", [repr(r["loss"]) for r in run.records], flush=True)
    if launches != {k: v * steps for k, v in want.items()}:
        raise SystemExit(f"whisper training launched {launches}, expected {want} a step")
    timed = run.records[1:]
    full = dict(steps=run.records, peak_gib=peak, launches=launches,
                mean_step_s=sum(r["seconds"] for r in timed) / len(timed),
                tokens_per_s=sum(r["tokens_per_s"] for r in timed) / len(timed))
    # the FP64 tensor-core bound of each kernel's launches in one step
    lin = train_linears(cfg, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ)
    fwd = sum(2.0 * m * kk * nn for m, kk, nn, _ in lin)
    rec = sum(2.0 * m * kk * nn for m, kk, nn, r in lin if r)
    bounds = {"k1_ms": (fwd + rec) / PEAK_FP64_TC_FLOPS * 1e3,
              "k2_ms": fwd / PEAK_FP64_TC_FLOPS * 1e3, "k3_ms": fwd / PEAK_FP64_TC_FLOPS * 1e3}

    batch = pipeline.make_batch(cfg, run.shape, steps, device=dev)
    # the device's kernels only: the step's ~140k launches with their host
    # ops take the profiler tens of seconds to collect
    acts = [torch.profiler.ProfilerActivity.CUDA]
    _zero_launches()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run.step_fn(run.params, run.opt_state, batch, steps)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    per_step = {k: fn.launches for k, fn in counters.items()}
    if per_step != want:
        raise SystemExit(f"one whisper step launched {per_step}, expected {want}")
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    by = {k: sum(e.time_range.elapsed_us() for e in kern if any(p in e.name for p in ps)) / 1e3
          for k, ps in KERNEL_PATTERNS.items()}
    prof_row = dict(wall_ms=t_prof * 1e3, device_kernels=len(kern), device_busy_ms=busy_us / 1e3,
                    launches=per_step, **by,
                    fp64_tc_bound_ms=bounds,
                    idle_share=(1 - busy_us / 1e3 / (full["mean_step_s"] * 1e3)) if kern else None)
    print("profiled whisper training step:", json.dumps(prof_row), flush=True)
    full["profiled_step"] = prof_row
    phase("31b a whisper step twice from the same state")

    batch = pipeline.make_batch(cfg, run.shape, steps + 1, device=dev)
    saved = (_state_copy(run.params), _state_copy(run.opt_state))
    _, _, m1 = run.step_fn(run.params, run.opt_state, batch, steps + 1)
    first = _state_copy(run.params)
    _state_load(run.params, saved[0])
    _state_load(run.opt_state, saved[1])
    del saved
    _, _, m2 = run.step_fn(run.params, run.opt_state, batch, steps + 1)
    torch.cuda.synchronize()
    same = torch.equal(m1["loss"], m2["loss"]) and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(spec.named_leaves(first),
                                                    spec.named_leaves(run.params)))
    print(f"loss {float(m1['loss'])!r} / {float(m2['loss'])!r}; every parameter bit-equal: {same}")
    if not same:
        raise SystemExit("two runs of one whisper training step differ")
    full["deterministic"] = same
    full["peak_gib_with_step_twice"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["whisper_full_width"] = full
    detail["family_training"] = res
    del run, first, batch
    torch.cuda.empty_cache()
    return {a: r["launches"] for a, r in small.items()}, launches, prof_row


def _encode_edges(x, dev):
    """Write zeros of both signs, subnormals and mantissas just below and at
    the √2/2 threshold (0x3F3504F3 / 0x3F3504F4, scaled into the tensor's
    range) into the first elements of ``x``."""
    below = torch.tensor(0x3F3504F3, dtype=torch.int32).view(torch.float32).item() * 2.0 ** -7
    above = torch.tensor(0x3F3504F4, dtype=torch.int32).view(torch.float32).item() * 2.0 ** -7
    edge = torch.tensor([0.0, -0.0, 1e-40, -3e-39, below, -above, above, -below, 2.0 ** -126],
                        device=dev)
    flat = x.view(-1)
    k = min(flat.numel(), edge.numel())
    flat[:k] = edge[:k]
    return x


def encode_kernel(dev, detail):
    """Phases 13 and 14: K4 against its plain version, then timing."""
    from repro_torch.core import compress, potq
    from repro_torch.kernels import ops
    from repro_torch.kernels import potq_encode as KE

    phase("13 K4 vs plain version (bit for bit)")
    gen = torch.Generator(device=dev).manual_seed(2)
    max_err = 0

    def check(x, beta, bits, label):
        e = potq.pot_emax(bits)
        beta = torch.as_tensor(beta, device=dev).to(torch.int32)
        ck = KE.potq_encode_cuda(x, beta, emax=e)
        cp = KE.potq_encode_plain(x, beta, emax=e)
        torch.cuda.synchronize()
        err = (ck.to(torch.int32) - cp.to(torch.int32)).abs().max().item()
        ok = torch.equal(ck, cp)
        print(f"{label} bits={bits} beta={int(beta)}: equal={ok} max_code_diff={err}", flush=True)
        if not ok:
            raise SystemExit(f"K4 differs from its plain version at {label}, beta {int(beta)}")
        return err

    inputs = {}
    for m, n in PACK_SHAPES:
        x = _encode_edges(torch.randn(m, n, generator=gen, device=dev) * 0.02, dev)  # olmo init
        x[1, :2] = torch.tensor([0.5, -0.5], device=dev)  # the amax: codes at ±emax
        codes, beta = ops.potq_encode(x, 5)
        ref = KE.potq_encode_plain(x, beta, emax=potq.pot_emax(5))
        # a zero code has no sign: decompress gives +0 where pot_quantize
        # gives -0 for a negative underflow, which torch.equal counts equal
        same = torch.equal(codes, ref) and torch.equal(compress.decompress(codes, beta, 5),
                                                       potq.pot_quantize(x, 5, beta))
        print(f"pack shape {(m, n)}: ops.potq_encode == plain and decompress == "
              f"pot_quantize: {same}", flush=True)
        if not same:
            raise SystemExit(f"K4 round trip fails at {(m, n)}")
        max_err = max(max_err, check(x, beta - 3, 5, f"{(m, n)} saturating"))
        inputs[(m, n)] = (x, beta)
    for shape in [(7, 1000), (100, 300), (1, 3)]:
        for bits in (4, 5, 6):
            x = _encode_edges(torch.randn(shape, generator=gen, device=dev) * 1e-3, dev)
            b0 = int(potq.compute_beta(x, bits))
            for beta in (b0, b0 - 3, 127, 140, -127, -140):
                max_err = max(max_err, check(x, beta, bits, f"{shape}"))
            codes, beta = ops.potq_encode(x, bits)
            # (1, 3) holds only zeros and subnormals: its beta is below -126,
            # where neither decoder's 2^beta is a float (the reference's too)
            if -126 <= int(beta) <= 126 and not torch.equal(
                    compress.decompress(codes, beta, bits), potq.pot_quantize(x, bits, beta)):
                raise SystemExit(f"decompress(potq_encode) != pot_quantize at {shape}")
    odd = torch.randn(1001, generator=gen, device=dev) * 1e-3
    odd[:4] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0], device=dev)
    max_err = max(max_err, check(odd, -12, 5, "(1001,) with NaN and ±inf"))
    max_err = max(max_err, check(odd[1:], -12, 5, "(1000,) unaligned view"))

    phase("14 K4 timing at the pack shapes (CUDA events, L2 flushed)")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    pack = {"ms": 0.0, "plain_ms": 0.0, "to_int8_ms": 0.0, "t_ops": 0.0, "t_bytes": 0.0}
    for (m, n), count in PACK_SHAPES.items():
        x, beta = inputs[(m, n)]
        t_k = time_ms(lambda: KE.potq_encode_cuda(x, beta, emax=7), 10, flush)
        t_p = time_ms(lambda: KE.potq_encode_plain(x, beta, emax=7), 2, flush)
        t_y = time_ms(lambda: x.to(torch.int8), 10, flush)
        t_bytes = PACK_BYTES_PER_ELEMENT * m * n / PEAK_BYTES * 1e3
        t_ops = ENCODE_OPS_PER_ELEMENT * m * n / PEAK_ALU_OPS * 1e3
        row = dict(M=m, N=n, launches_per_pack=count, ms=t_k, plain_ms=t_p, to_int8_ms=t_y,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops > t_bytes else "bytes",
                   gb_per_s=PACK_BYTES_PER_ELEMENT * m * n / t_k / 1e6)
        rows.append(row)
        print(json.dumps(row), flush=True)
        for key, t in (("ms", t_k), ("plain_ms", t_p), ("to_int8_ms", t_y),
                       ("t_ops", t_ops), ("t_bytes", t_bytes)):
            pack[key] += count * t
    t_ops, t_bytes = pack.pop("t_ops"), pack.pop("t_bytes")
    pack["bound_ms"] = max(t_ops, t_bytes)
    pack["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
    print("one olmo-1b pack (8 launches):", json.dumps(pack))
    detail["k4_shapes"] = rows
    detail["k4_pack"] = pack
    del inputs, flush
    torch.cuda.empty_cache()
    # no single PyTorch call computes the PoT encode: library_ms is null
    return dict(max_abs_err=max_err, ms=pack["ms"], plain_ms=pack["plain_ms"],
                bound_ms=pack["bound_ms"], bound_by=pack["bound_by"], library_ms=None)


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.out.write(text)
        self.buf.write(text)
        return len(text)

    def flush(self):
        self.out.flush()


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _trees_equal(a, b):
    from repro_torch.models import spec

    la, lb = list(spec.named_leaves(a)), list(spec.named_leaves(b))
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y.to(x.device)) for (_, x), (_, y) in zip(la, lb))


def checkpoint_and_pack(dev, detail):
    """Phases 15 and 16 in one checkpoint directory, removed at the end."""
    tmp_root = tempfile.gettempdir()
    free = shutil.disk_usage(tmp_root).free
    print(f"checkpoint directory under {tmp_root}: {free / 1e9:.1f} GB free", flush=True)
    if free < CKPT_FREE_BYTES:
        raise SystemExit(f"only {free / 1e9:.1f} GB free under {tmp_root}; the checkpoint "
                         f"phases need {CKPT_FREE_BYTES / 1e9:.0f} GB")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        run_b = restart(dev, detail, ckpt_dir)
        return pack_and_serve(dev, detail, ckpt_dir, run_b)
    finally:
        shutil.rmtree(ckpt_dir)


@contextlib.contextmanager
def _arch_depth(name, **layers):
    """Within the block ``repro_torch.configs.get_config(name)``, which
    ``launch.train.main`` builds its model from, gives ``name`` at its
    published widths and ``layers`` (``n_layers``, an encdec's
    ``enc_layers``)."""
    from repro_torch import configs

    real = configs.get_config
    configs.get_config = lambda arch: (dataclasses.replace(real(arch), **layers)
                                       if arch == name else real(arch))
    try:
        yield
    finally:
        configs.get_config = real


def restart(dev, detail, ckpt_dir):
    """Phase 15: runs A (2 steps, saved), B (resumed to 3) and C (3 steps
    uninterrupted) at ``CKPT_LAYERS`` layers; B must equal C bit for bit."""
    with _arch_depth("olmo-1b", n_layers=CKPT_LAYERS):
        return _restart(dev, detail, ckpt_dir)


def _restart(dev, detail, ckpt_dir):
    from repro_torch.launch import train as train_cli

    phase(f"15 checkpoint and restart at full width, {CKPT_LAYERS} of olmo-1b's 16 layers "
          "(batch 8 x seq 512)")
    counters = _kernel_counters()
    ck = ["--ckpt-dir", ckpt_dir, "--ckpt-every", "100"]
    peaks = {}

    def peak_gib(run):
        torch.cuda.synchronize()
        peaks[run] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()

    peak_gib("before")
    t0 = time.perf_counter()
    run_a = train_cli.main(TRAIN_ARGS + ["--steps", "2"] + ck)
    wall_a = time.perf_counter() - t0
    peak_gib("A")
    if run_a.ckpt.all_steps() != [2]:
        raise SystemExit(f"run A left checkpoints {run_a.ckpt.all_steps()}, expected [2]")
    timings = [dict(run="A", **t) for t in run_a.ckpt.timings]
    del run_a
    torch.cuda.empty_cache()

    tee = _Tee(sys.stdout)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        run_b = train_cli.main(TRAIN_ARGS + ["--steps", "3"] + ck)
    wall_b = time.perf_counter() - t0
    peak_gib("B")
    launches_b = {k: fn.launches for k, fn in counters.items()}
    if "restoring checkpoint step 2" not in tee.buf.getvalue():
        raise SystemExit("run B did not print 'restoring checkpoint step 2'")
    if run_b.start_step != 2 or [r["step"] for r in run_b.records] != [2]:
        raise SystemExit(f"run B started at {run_b.start_step} and ran "
                         f"{[r['step'] for r in run_b.records]}, expected step 2 only")
    if launches_b != step_launches():
        raise SystemExit(f"run B launched {launches_b}, expected one step's {step_launches()}")
    if run_b.ckpt.all_steps() != [2, 3]:
        raise SystemExit(f"run B left checkpoints {run_b.ckpt.all_steps()}, expected [2, 3]")
    timings += [dict(run="B", **t) for t in run_b.ckpt.timings]
    on_disk = {s: _dir_bytes(os.path.join(ckpt_dir, f"step_{s:010d}"))
               for s in run_b.ckpt.all_steps()}

    t0 = time.perf_counter()
    run_c = train_cli.main(TRAIN_ARGS + ["--steps", "3"])
    wall_c = time.perf_counter() - t0
    peak_gib("C (run B's state held)")
    same_p = _trees_equal(run_b.params, run_c.params)
    same_s = _trees_equal(run_b.opt_state, run_c.opt_state)
    loss_b, loss_c = run_b.records[0]["loss"], run_c.records[2]["loss"]
    del run_c
    torch.cuda.empty_cache()
    for t in timings:
        if t["op"] == "save":
            t["seconds"] = t["snapshot_s"] + t["write_s"]
        t["gb_per_s"] = t["bytes"] / t["seconds"] / 1e9
        print(f"run {t['run']} {t['op']} step {t['step']}: {t['bytes'] / 1e9:.3f} GB in "
              f"{t['seconds']:.2f} s = {t['gb_per_s']:.3f} GB/s"
              + (f" (device to host {t['snapshot_s']:.2f} s, file write {t['write_s']:.2f} s)"
                 if t["op"] == "save" else ""), flush=True)
    print(f"bytes on disk per step: {on_disk}; runs A / B / C {wall_a:.1f} / {wall_b:.1f} / "
          f"{wall_c:.1f} s; B launched {launches_b}; peak device GiB {json.dumps(peaks)}")
    print(f"step 2 loss: resumed {loss_b!r}, uninterrupted {loss_c!r}; params bit-equal "
          f"{same_p}, AdamW m/v bit-equal {same_s}", flush=True)
    detail["restart"] = dict(timings=timings, bytes_on_disk=on_disk, wall_s=[wall_a, wall_b, wall_c],
                             peak_gib=peaks,
                             launches_b=launches_b, loss_resumed=loss_b,
                             loss_uninterrupted=loss_c, params_equal=same_p, opt_equal=same_s)
    if not (same_p and same_s and loss_b == loss_c):
        raise SystemExit("the resumed run differs from the uninterrupted run")
    return run_b


def pack_and_serve(dev, detail, ckpt_dir, run_b):
    """Phase 16: quantize_for_serving -> pack_int8 (K4) -> save -> restore ->
    unpack_int8 -> PoolEngine, against serving the bf16 tree itself.
    Returns K4's launches in the pack."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import potq
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.kernels import potq_encode as KE
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.models import spec
    from repro_torch.serve import PoolEngine, poisson_trace
    from repro_torch.serve import quantized_weights as qw

    phase("16 pack (K4), store, restore, unpack and serve olmo-1b")
    cfg = run_b.cfg
    served = qw.quantize_for_serving(cfg, PAPER_FAITHFUL, run_b.params)
    del run_b
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    KE.potq_encode_cuda.launches = 0
    t0 = time.perf_counter()
    packed = qw.pack_int8(served)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    launches = KE.potq_encode_cuda.launches
    if launches != sum(PACK_SHAPES.values()):
        raise SystemExit(f"pack_int8 launched K4 {launches} times, expected "
                         f"{sum(PACK_SHAPES.values())}")
    mgr = CheckpointManager(os.path.join(ckpt_dir, "packed"), async_write=False)
    mgr.save(3, {"packed": packed}, blocking=True)
    restored = mgr.restore(3, {"packed": packed})["packed"]
    if not _trees_equal(restored, packed):
        raise SystemExit("the packed tree changed through the checkpoint")
    unpacked = qw.unpack_int8(restored)
    del restored
    torch.cuda.synchronize()
    leaves, all_equal = [], True
    packed_leaves = dict(spec.named_leaves(packed))
    served_leaves = dict(spec.named_leaves(served))
    for name, x in spec.named_leaves(unpacked):
        if not name.endswith("/w"):
            continue
        s = served_leaves[name]
        n_diff = int((x.float() != s.float()).sum())
        all_equal = all_equal and n_diff == 0
        sf = s.float()
        layer_betas = (potq.compute_beta(sf, 5, axes=(1, 2)).flatten().tolist()
                       if sf.dim() == 3 else [int(potq.compute_beta(sf, 5))])
        row = dict(leaf=name, elements=x.numel(), differ=n_diff,
                   beta=int(packed_leaves[name + "/beta"]), layer_betas=layer_betas,
                   packed_bytes=x.numel() + 4, f32_bytes=4 * x.numel())
        leaves.append(row)
        print(json.dumps(row), flush=True)
    packed_bytes = sum(r["packed_bytes"] for r in leaves)
    f32_bytes = sum(r["f32_bytes"] for r in leaves)
    on_disk = _dir_bytes(os.path.join(ckpt_dir, "packed"))
    print(f"pack: {launches} K4 launches in {pack_s * 1e3:.1f} ms (betas included); linear "
          f"leaves {packed_bytes / 1e9:.3f} GB packed vs {f32_bytes / 1e9:.3f} GB f32; the "
          f"packed checkpoint {on_disk / 1e9:.3f} GB on disk; {mgr.timings}", flush=True)

    pol = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
    reqs = poisson_trace(cfg, n_requests=4, prompt_len=128, lam=2.0, new_lo=8, new_hi=32, seed=0)
    outs, serve = {}, {}
    for label, tree in (("unpacked", unpacked), ("served", served)):
        eng = PoolEngine(cfg, pol, tree, max_slots=4, max_len=160, prequantize=False, device=dev)
        eng.run([dataclasses.replace(reqs[0], uid="warm-up", max_new_tokens=2)])
        torch.cuda.synchronize()
        K.potq_matmul_cuda.launches = 0
        t0 = time.perf_counter()
        outs[label] = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.last_stats
        k1 = K.potq_matmul_cuda.launches
        serve[label] = dict(wall_s=wall, tokens_per_s=st.emitted_tokens / wall,
                            emitted_tokens=st.emitted_tokens, weight_passes=st.weight_passes,
                            k1_launches=k1)
        print(label, json.dumps(serve[label]), flush=True)
        if k1 != k1_per_pass(cfg) * st.weight_passes:
            raise SystemExit(f"K1 launched {k1} times over {st.weight_passes} weight passes")
        check_tokens(cfg, reqs, outs[label])
        del eng
    same = [int((outs["unpacked"][r.uid] == outs["served"][r.uid]).sum()) for r in reqs]
    share = sum(same) / sum(r.max_new_tokens for r in reqs)
    print(f"every linear leaf round-trips exactly: {all_equal}; tokens equal to the served "
          f"tree's: {share:.4f} of them", flush=True)
    detail["pack_serve"] = dict(leaves=leaves, pack_s=pack_s, k4_launches=launches,
                                packed_bytes=packed_bytes, f32_bytes=f32_bytes,
                                on_disk=on_disk, timings=mgr.timings, serve=serve,
                                all_leaves_exact=all_equal, token_share_equal=share)
    if all_equal and share != 1.0:
        raise SystemExit("exact round trip, yet the tokens differ from the served tree's")
    del served, packed, unpacked
    torch.cuda.empty_cache()
    return launches


def cpu_vs_card(dev, detail):
    """Phase 17: pack_int8 and checkpoints agree across CPU and card."""
    from repro_torch import configs
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import registry, spec
    from repro_torch.serve import quantized_weights as qw

    phase("17 CUDA vs CPU: pack_int8 and checkpoints (smoke width)")
    scfg = configs.smoke_config("olmo-1b")
    p_cpu = spec.materialize(registry.param_specs(scfg), torch.Generator().manual_seed(0))
    s_cpu = qw.quantize_for_serving(scfg, PAPER_FAITHFUL, p_cpu)

    def to_card(tree):
        out = {}
        for n, x in spec.named_leaves(tree):
            spec.set_leaf(out, n, x.to(dev))
        return out

    res = {label: _trees_equal(qw.pack_int8(tree), qw.pack_int8(to_card(tree)))
           for label, tree in (("raw", p_cpu), ("served", s_cpu))}
    print(f"pack_int8 CPU == card, code for code and beta for beta: {res}", flush=True)
    d = tempfile.mkdtemp(prefix="chip_smoke_xdev_")
    try:
        p_gpu = to_card(p_cpu)
        mgr = CheckpointManager(d, async_write=False)
        pk_gpu = qw.pack_int8(p_gpu)
        mgr.save(1, {"params": p_gpu, "packed": pk_gpu}, blocking=True)
        back = mgr.restore(1, {"params": p_gpu, "packed": pk_gpu}, device="cpu")
        card_to_cpu = (_trees_equal(back["params"], p_cpu)
                       and _trees_equal(back["packed"], qw.pack_int8(p_cpu))
                       and all(x.device.type == "cpu" for _, x in spec.named_leaves(back)))
        mgr.save(2, {"params": p_cpu}, blocking=True)
        back = mgr.restore(2, {"params": p_cpu}, device=dev)
        cpu_to_card = _trees_equal(back["params"], p_gpu) and all(
            x.device.type == dev.type for _, x in spec.named_leaves(back))
    finally:
        shutil.rmtree(d)
    print(f"checkpoint card -> CPU bit-equal: {card_to_cpu}; CPU -> card: {cpu_to_card}")
    detail["cpu_vs_card_pack"] = dict(pack=res, card_to_cpu=card_to_cpu, cpu_to_card=cpu_to_card)
    if not (all(res.values()) and card_to_cpu and cpu_to_card):
        raise SystemExit("packing or checkpoints differ between CPU and card")


SERVE_COUNTERS = ("weight_passes", "decode_steps", "prefills", "emitted_tokens",
                  "ttft_passes", "admission_deferrals")
# 37s's rows: a spec round's and the KV pages' counters too
OPTION_COUNTERS = SERVE_COUNTERS + ("accepted_tokens", "draft_weight_passes",
                                    "accepted_tokens_per_weight_pass", "kv_page_bytes",
                                    "kv_hbm_bytes_per_token", "pages_in_use_sum")
PREFIX_COUNTERS = SERVE_COUNTERS + ("prefix_hit_tokens", "cow_copies", "evictions")


def _kernel_counters():
    """K1, K2, K3 and the pre-pass wrappers by key, each with its launch count."""
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K

    return {"k1": K.potq_matmul_cuda, "k2": KG.grad_da_cuda, "k3": KG.grad_dw_cuda,
            "gq": KG.quantize_g_cuda}


def _zero_launches():
    from repro_torch.kernels import potq_encode as KE
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K

    for fn in (K.potq_matmul_cuda, KG.quantize_g_cuda, KG.grad_da_cuda, KG.grad_dw_cuda,
               KE.potq_encode_cuda):
        fn.launches = 0


@contextlib.contextmanager
def _counting_syncs(syncs):
    """With a dict ``syncs``, run the body under PyTorch's CUDA sync debug
    mode and count its implicit host syncs by the innermost line of the
    port (``src/``) that made them, else by torch's own line (waiting on
    an event is explicit and not counted); with None, just the body."""
    if syncs is None:
        yield
        return

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(str(ROOT / "src"))]
        where = ours[-1] if ours else None
        key = (f"{os.path.relpath(where.filename, ROOT)}:{where.lineno} "
               f"({where.line})" if where else f"{filename}:{lineno}")
        syncs[key] = syncs.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")


def _timed_run(eng, reqs, syncs=None):
    """One engine run with every launch count set to 0 just before it;
    returns (tokens, wall seconds, K1 launches); with a dict ``syncs`` its
    implicit host syncs counted (:func:`_counting_syncs`: the engine's one
    sync a step waits on an event and is not counted)."""
    from repro_torch.kernels import potq_matmul as K

    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    with _counting_syncs(syncs):
        out = eng.run(reqs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, K.potq_matmul_cuda.launches


def _serve_row(st, wall, launches):
    return dict(wall_s=wall, tokens_per_s=st.emitted_tokens / wall,
                emitted_tokens=st.emitted_tokens, weight_passes=st.weight_passes,
                decode_steps=st.decode_steps, prefills=st.prefills,
                mean_ttft_passes=st.mean_ttft_passes, mean_ttft_ms=st.mean_ttft_s * 1e3,
                mean_occupancy=st.mean_occupancy, prefix_hit_rate=st.prefix_hit_rate,
                cow_copies=st.cow_copies, evictions=st.evictions,
                admission_deferrals=st.admission_deferrals,
                kv_hbm_bytes_per_token=st.kv_hbm_bytes_per_token, k1_launches=launches)


def _cpu_counters(reqs, engine_kw, keys, arch="llama3-8b"):
    """The same requests (token ids modulo the smoke vocab) through the
    port on the CPU at ``arch``'s smoke width: the counters that do not
    depend on the model's width when no request has an EOS.  A request's
    frames or patch embeddings are redrawn at the smoke width; a vlm keeps
    its full count of patches, which take cache positions."""
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import registry, spec
    from repro_torch.serve import PoolEngine

    scfg = configs.smoke_config(arch)
    if scfg.family == "vlm":
        scfg = dataclasses.replace(scfg, num_patches=configs.get_config(arch).num_patches)
    rng = np.random.default_rng(0)
    shapes = {"frames": (1, scfg.enc_seq, scfg.frame_dim),
              "patch_embeds": (1, scfg.num_patches, scfg.patch_dim)}
    p_cpu = spec.materialize(registry.param_specs(scfg), torch.Generator().manual_seed(0))
    eng = PoolEngine(scfg, PAPER_FAITHFUL, p_cpu, device="cpu", **engine_kw)
    eng.run([dataclasses.replace(
        r, tokens=np.asarray(r.tokens) % scfg.vocab,
        extras={k: rng.standard_normal(shapes[k]).astype(np.float32) for k in r.extras})
        for r in reqs])
    return {k: getattr(eng.last_stats, k) for k in keys}


def _check_counters(label, st, cpu):
    card = {k: getattr(st, k) for k in cpu}
    same = card == cpu
    print(f"{label}: counters equal the CPU smoke-width run's: {same}")
    if not same:
        raise SystemExit(f"{label}: counters differ from the CPU run: card {card}, cpu {cpu}")


def _streamed_pool(cfg, pol, params, dev, prompts, kv_quant=None, frames=None):
    """A 4-slot pool (page 16, a reversed page table: not the identity)
    with ``prompts`` streamed in by chunk steps of 32; K1 must launch
    ``k1_per_pass(cfg)`` times in each.  An encdec pool first gets each
    slot's cross K/V from its request's ``frames`` (one encoder-side pass
    a slot).  Returns (pool, last logits, chunk-step seconds, K1
    launches of the last chunk step)."""
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.models import registry
    from repro_torch.serve import slots

    pool = registry.init_pool_cache(cfg, 4, 160, device=dev, page_size=16,
                                    kv_quant=kv_quant)
    pool["table"].copy_(torch.arange(40, device=dev).flip(0).reshape(4, 10))
    for s, f in enumerate(frames or ()):
        cks, cvs = registry.encode_cross_kv(cfg, pol, params, torch.as_tensor(f, device=dev))
        slots.write_cross(pool, cks, cvs, s)
    t_chunk, logits, launches = [], None, 0
    for c0 in range(0, max(len(p) for p in prompts), 32):
        tokens = np.zeros((4, 32), np.int64)
        n_new = np.zeros((4,), np.int64)
        for s, p in enumerate(prompts):
            part = p[c0:c0 + 32]
            tokens[s, :len(part)] = part
            n_new[s] = len(part)
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, pool = registry.chunk_step(cfg, pol, params,
                                           torch.as_tensor(tokens, device=dev), n_new, pool)
        torch.cuda.synchronize()
        t_chunk.append(time.perf_counter() - t0)
        launches = K.potq_matmul_cuda.launches
        if launches != k1_per_pass(cfg):
            raise SystemExit(f"K1 launched {launches} times in one chunk step")
    return pool, logits, t_chunk, launches


def _decode_row_check(cfg, pol, params, pool, logits, dev):
    """A chunk-step decode row equals ``decode_step`` in logits and every
    cache leaf, and a decode step launches K1 once a linear.  Returns (the
    decoded tokens, decode_step's cache, its K1 launches)."""
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.models import registry

    last = torch.argmax(logits, -1)
    dec = torch.zeros((4, 32), dtype=torch.int64, device=dev)
    dec[:, 0] = last
    c1 = {k: v.clone() for k, v in pool.items()}
    c2 = {k: v.clone() for k, v in pool.items()}
    lg_chunk, c1 = registry.chunk_step(cfg, pol, params, dec, [1, 1, 1, 1], c1)
    _zero_launches()
    lg_plain, c2 = registry.decode_step(cfg, pol, params, last, c2)
    torch.cuda.synchronize()
    launches = K.potq_matmul_cuda.launches
    equal = bool(torch.equal(lg_chunk, lg_plain)) and all(
        torch.equal(c1[k], c2[k]) for k in c1)
    print(f"chunk-step decode row == decode_step (logits and every cache leaf: "
          f"{sorted(c1)}): {equal}")
    if not equal or launches != k1_per_pass(cfg):
        raise SystemExit(f"decode row differs between the step bodies ({equal}) "
                         f"or K1 launched {launches} times in a decode step")
    return last, c2, launches


# kernel names by the ms they are summed into (K2 with its pre-pass)
KERNEL_PATTERNS = {"k1_ms": ("potq_mm",), "k2_ms": ("grad_da", "grad_g_quantize"),
                   "k3_ms": ("grad_dw",), "prepass_ms": ("grad_g_quantize",)}


def _profiled(fn, wall_s):
    """Device kernels of one call of ``fn`` under torch.profiler: count,
    busy ms, K1's (and K2's, K3's, the pre-pass's) ms, and the idle share
    against ``wall_s``, the call's unprofiled wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    by = {k: sum(e.time_range.elapsed_us() for e in kern if any(p in e.name for p in ps)) / 1e3
          for k, ps in KERNEL_PATTERNS.items()}
    return dict(wall_ms=wall_s * 1e3, device_kernels=len(kern), device_busy_ms=busy_us / 1e3,
                **by, idle_share=1 - busy_us / 1e6 / wall_s if kern else None)


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def serving(dev, detail):
    """Phases 19-23 on one llama3-8b at full width (weights from seed 0):
    chunked + paged serving, the prefix cache, PoT-quantized KV pages,
    speculative decoding, lockstep serving and float32 pages; then phases
    24-25, mistral-nemo-12b and starcoder2-7b at full width, and 26-27,
    llama4-scout and grok-1 at full width and cut depth.  Returns K1's
    launch counts of their main paths."""
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import registry, spec
    from repro_torch.serve import poisson_trace
    from repro_torch.serve import quantized_weights as qw

    # the trainer (phases 10-16) turns PyTorch's deterministic algorithms on
    # for the whole process; a server runs without them (they make each
    # index_put_ sort), so these phases do too
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    cfg = configs.get_config("llama3-8b")
    pgen = torch.Generator(device=dev).manual_seed(0)
    params = spec.materialize(
        registry.param_specs(cfg), pgen,
        transform=lambda name, x: qw.quantize_leaf(name, x, PAPER_FAITHFUL))
    policy = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
    reqs = poisson_trace(cfg, n_requests=8, prompt_len=128, lam=2.0, new_lo=8,
                         new_hi=32, seed=0)
    paged = paged_serving(dev, detail, cfg, params, policy, reqs)
    kvq = kv_quant_serving(dev, detail, cfg, params, policy, reqs)
    spec_run = spec_serving(dev, detail, cfg, params, policy, reqs)
    lockstep = lockstep_serving(dev, detail, cfg, params, policy, reqs)
    qa = qa_serving(dev, detail, cfg, params, policy, reqs)
    del params
    torch.cuda.empty_cache()
    dense = {arch: dense_serving(dev, detail, arch, number, n_layers=OTHER_LAYERS.get(arch))
             for number, arch in enumerate(OTHER_ARCHS, start=24)}
    moe = moe_serving(dev, detail)
    family = family_serving(dev, detail)
    torch.use_deterministic_algorithms(deterministic)
    return dict(launches=paged["launches"] + kvq["launches"] + spec_run["launches"]
                + lockstep["launches"] + qa + sum(dense.values()) + sum(moe.values())
                + sum(family.values()), family_launches=family, qa_launches=qa,
                chunk_launches=paged["chunk_launches"],
                verify_launches=spec_run["verify_launches"],
                draft_launches=spec_run["draft_launches"],
                lockstep_launches=lockstep["wave_launches"], dense_launches=dense,
                moe_launches=moe)


def _encoder_pass(cfg, pol, params, dev, frames):
    """Phase 30's encoder-side pass (``registry.encode_cross_kv`` of one
    request's frames): K1 launches (``encdec_pass_counts``), wall times,
    and one profiled pass, K1's device ms beside its FP64 tensor-core
    bound at M = enc_seq."""
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.models import registry

    f = torch.as_tensor(frames, device=dev)
    _zero_launches()
    t = [_wall(lambda: registry.encode_cross_kv(cfg, pol, params, f)) for _ in range(3)]
    launches = K.potq_matmul_cuda.launches // 3
    want = sum(encdec_pass_counts(cfg)[1].values())
    prof = _profiled(lambda: registry.encode_cross_kv(cfg, pol, params, f), min(t))
    flops = sum(2.0 * cfg.enc_seq * kk * nn * c for (kk, nn), c in
                encdec_pass_counts(cfg)[1].items())
    prof["k1_fp64_tc_bound_ms"] = flops / PEAK_FP64_TC_FLOPS * 1e3
    row = dict(wall_ms=[x * 1e3 for x in t], k1_launches=launches, profiled=prof)
    print(f"{cfg.name}: encoder-side pass (M={cfg.enc_seq}, K1 device ms against its "
          f"{prof['k1_fp64_tc_bound_ms']:.2f} ms FP64 tensor-core bound):", json.dumps(row))
    if launches != want:
        raise SystemExit(f"K1 launched {launches} times in an encoder-side pass, expected {want}")
    return row


def family_serving(dev, detail):
    """Phases 29-30: internvl2-76b at its published widths and
    ``VLM_LAYERS`` layers (max_len 400: 256 patches, 128 tokens, 16 new),
    and whisper-large-v3 at ``ENCDEC_LAYERS`` decoder layers (the encoder
    whole) on ``ENCDEC_TRACE`` (max_len 64), through
    phase 24's engine and gates; phases 32-33: mamba2-2.7b and
    recurrentgemma-2b at ``RECURRENT_SERVE_LAYERS`` layers through the
    slot-row pool (``recurrent_serving``).  Returns each one's K1 launches on its main
    path."""
    out = {VLM_ARCH: dense_serving(dev, detail, VLM_ARCH, 29, n_layers=VLM_LAYERS,
                                   max_len=400),
           ENCDEC_ARCH: dense_serving(dev, detail, ENCDEC_ARCH, 30, n_layers=ENCDEC_LAYERS,
                                      max_len=64, trace=ENCDEC_TRACE)}
    for number, arch in enumerate(RECURRENT, start=32):
        out[arch] = recurrent_serving(dev, detail, arch, number)
    return out


def _state_bytes(cache):
    """Bytes of a batch-1 cache's state leaves (``len`` aside): one slot's
    recurrent state (and ring, for the hybrid's attention layers)."""
    from repro_torch.models import spec

    return sum(x.numel() * x.element_size() for name, x in spec.named_leaves(cache)
               if name != "len")


def recurrent_serving(dev, detail, arch, number):
    """Phase 32 or 33: ``arch`` (mamba2-2.7b, recurrentgemma-2b) at full
    width and ``RECURRENT_SERVE_LAYERS`` layers (weights from seed 0,
    drawn leaf by leaf into served form) through ``PoolEngine(max_slots=4)`` on its slot-row pool: no
    pages, each admission a solo prefill.  A is the main path (its launch
    counts set to 0 just before and read just after, its implicit host
    syncs counted); C (each request alone) gives A's tokens bit for bit;
    A's counters equal the CPU smoke-width run's; K1 launches
    ``k1_per_pass`` times a weight pass (17 / 47), in a solo prefill and
    in a 4-slot decode step; the prefill and decode-step wall times, one
    profiled decode step (kernels, busy, K1 device ms beside its bytes
    bound, idle share); the state bytes a slot; peak memory under
    ``MOE_PEAK_GIB``.  Returns A's K1 launches."""
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.models import registry, spec
    from repro_torch.serve import PoolEngine, poisson_trace, slots
    from repro_torch.serve import quantized_weights as qw

    cfg = configs.get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=RECURRENT_SERVE_LAYERS[arch])
    rc = RECURRENT[arch]
    phase(f"{number} {arch} at full width, {cfg.n_layers} of its layers: slot-row pool, 4 "
          "slots, solo prefill")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = spec.materialize(
        registry.param_specs(cfg), torch.Generator(device=dev).manual_seed(0),
        transform=lambda name, x: qw.quantize_leaf(name, x, PAPER_FAITHFUL))
    torch.cuda.synchronize()
    res = {"params": dict(count=spec.count_params(registry.param_specs(cfg)),
                          seconds=time.perf_counter() - t0,
                          held_gib=torch.cuda.memory_allocated() / 2 ** 30,
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)}
    print("params:", json.dumps(res["params"]))
    policy = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
    reqs = poisson_trace(cfg, prompt_len=rc["prompt"], **RECURRENT_TRACE)
    kw = dict(max_slots=4, max_len=rc["max_len"])
    eng_a = PoolEngine(cfg, policy, params, device=dev, **kw)
    eng_a.run([dataclasses.replace(reqs[0], uid="warm-up", max_new_tokens=2)])
    syncs = {}
    out_a, wall, launches = _timed_run(eng_a, reqs, syncs)  # the main path
    st = eng_a.last_stats
    res["A"] = dict(_serve_row(st, wall, launches), implicit_syncs=syncs)
    res["tokens"] = {str(u): t.tolist() for u, t in out_a.items()}
    print("A (slot rows, 4 slots):", json.dumps(res["A"]))
    port_syncs = {k: n for k, n in syncs.items() if k.startswith("src/")}
    print(f"implicit host syncs in A made by the port: {port_syncs}")
    if port_syncs:
        raise SystemExit(f"{arch}: the engine synchronized outside its token copy: {port_syncs}")
    if launches != expected_k1(cfg, st):
        raise SystemExit(f"{arch}: K1 launched {launches} times in A, expected "
                         f"{expected_k1(cfg, st)} ({k1_per_pass(cfg)} x {st.weight_passes} "
                         "weight passes)")
    check_tokens(cfg, reqs, out_a)
    _check_counters("A", st, _cpu_counters(reqs, kw, SERVE_COUNTERS, arch))
    eng_c = PoolEngine(cfg, policy, params, device=dev, **dict(kw, max_slots=1))
    same_c = [bool(np.array_equal(eng_c.run([dataclasses.replace(r, arrival=0)])[r.uid],
                                  out_a[r.uid])) for r in reqs]
    print(f"A == C (each request alone): {same_c}")
    if not all(same_c):
        raise SystemExit(f"{arch}: pooled tokens differ from solo")
    pol = eng_a.policy
    with torch.inference_mode():
        pool = registry.init_pool_cache(cfg, 4, rc["max_len"], device=dev)
        t_prefill, prefill_launches = [], []
        for s, r in enumerate(reqs):
            mini = registry.init_cache(cfg, 1, rc["max_len"], device=dev)
            toks = torch.as_tensor(r.tokens, dtype=torch.int64, device=dev)
            _zero_launches()
            t_prefill.append(_wall(lambda: registry.prefill(cfg, pol, params,
                                                            {"tokens": toks}, mini)))
            prefill_launches.append(K.potq_matmul_cuda.launches)
            slots.write_slot(pool, mini, s)
        state_bytes = _state_bytes(mini)
        tok = torch.zeros(4, dtype=torch.int64, device=dev)
        _zero_launches()
        logits, pool = registry.decode_step(cfg, pol, params, tok, pool)
        torch.cuda.synchronize()
        decode_launches = K.potq_matmul_cuda.launches
        if not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"{arch}: non-finite decode logits")
        if set(prefill_launches) != {k1_per_pass(cfg)} or decode_launches != k1_per_pass(cfg):
            raise SystemExit(f"{arch}: K1 launched {prefill_launches} times in a solo prefill "
                             f"and {decode_launches} in a decode step, expected "
                             f"{k1_per_pass(cfg)}")
        t_decode = [_wall(lambda: registry.decode_step(cfg, pol, params, tok, pool))
                    for _ in range(3)]
        prof = _profiled(lambda: registry.decode_step(cfg, pol, params, tok, pool),
                         min(t_decode))
    # K1's bytes bound over one decode weight pass (M = 4): each bf16
    # operand read once, the f32 output written once
    prof["k1_bytes_bound_ms"] = decode_pass_bytes(cfg) / PEAK_BYTES * 1e3
    res["steps"] = dict(prefill_ms=[t * 1e3 for t in t_prefill],
                        decode_step_ms=[t * 1e3 for t in t_decode],
                        k1_launches_prefill=prefill_launches[0],
                        k1_launches_decode_step=decode_launches,
                        state_bytes_per_slot=state_bytes, profiled_decode_step=prof)
    print(f"{arch}: solo prefills (M={rc['prompt']}) "
          f"{[round(t * 1e3, 1) for t in t_prefill]} ms, decode steps (4 slots) "
          f"{[round(t * 1e3, 1) for t in t_decode]} ms; state {state_bytes} bytes a slot")
    print(f"{arch}: profiled decode step (K1 device ms against its "
          f"{prof['k1_bytes_bound_ms']:.2f} ms bytes bound):", json.dumps(prof))
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{arch}: peak device memory over the phase {res['peak_gib']:.2f} GiB")
    if res["peak_gib"] >= MOE_PEAK_GIB:
        raise SystemExit(f"{arch}: the phase peaked at {res['peak_gib']:.1f} GiB, over "
                         f"{MOE_PEAK_GIB}")
    detail[f"serving_{arch}"] = res
    del params, eng_a, eng_c, pool, mini
    torch.cuda.empty_cache()
    return launches


def moe_serving(dev, detail):
    """Phases 26-27: the MoE decoders at their published widths, cut in
    depth to one card, through phase 24's engine and gates.  Returns each
    one's K1 launches on its main path."""
    return {arch: dense_serving(dev, detail, arch, number, n_layers=layers)
            for number, (arch, layers) in enumerate(MOE_ARCHS.items(), start=26)}


# phases 19-20 run llama3-8b's widths at this depth: at all 32 layers the
# whole script read 980.6 s on an H100 with phase 37 (phases 19-20: 142 s);
# 8 until phase 37q took the room, 4 until phase 37r (32 s of a slow host's
# 951.8 s for both)
PAGED_LAYERS = 2


def paged_serving(dev, detail, cfg, params, policy, reqs):
    """Phases 19-20: chunked piggybacked prefill over the paged cache and
    the prefix cache, at llama3-8b's widths and ``PAGED_LAYERS`` layers."""
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.models import registry
    from repro_torch.serve import PoolEngine, shared_prefix_trace

    phase(f"19 chunked + paged serving, llama3-8b's widths at {PAGED_LAYERS} layers")
    cfg = dataclasses.replace(cfg, n_layers=PAGED_LAYERS)
    params = dict(params, layers=_first_layers(params["layers"], PAGED_LAYERS))
    kw = dict(max_slots=4, max_len=160, prefill_chunk=32)
    eng_a = PoolEngine(cfg, policy, params, page_size=16, device=dev, **kw)
    eng_a.run([dataclasses.replace(reqs[0], uid="warm-up", max_new_tokens=2)])
    out_a, wall, launches = _timed_run(eng_a, reqs)  # the main path
    st_a = eng_a.last_stats
    res = {"A": dict(_serve_row(st_a, wall, launches), layers=PAGED_LAYERS)}
    print("A (page 16):", json.dumps(res["A"]))
    if launches != k1_per_pass(cfg) * st_a.weight_passes:
        raise SystemExit(f"K1 launched {launches} times in A, expected {k1_per_pass(cfg)} x "
                         f"{st_a.weight_passes} weight passes")
    check_tokens(cfg, reqs, out_a)
    _check_counters("A", st_a, _cpu_counters(reqs, dict(kw, page_size=16), SERVE_COUNTERS))
    eng_b = PoolEngine(cfg, policy, params, device=dev, **kw)
    out_b, wall, launches = _timed_run(eng_b, reqs)
    res["B"] = _serve_row(eng_b.last_stats, wall, launches)
    print("B (page = span):", json.dumps(res["B"]))
    same_b = all(np.array_equal(out_a[r.uid], out_b[r.uid]) for r in reqs)
    eng_c = PoolEngine(cfg, policy, params, max_slots=1, max_len=160, prefill_chunk=32,
                       device=dev)
    same_c = []
    for r in reqs:
        solo = eng_c.run([dataclasses.replace(r, arrival=0)])
        same_c.append(bool(np.array_equal(solo[r.uid], out_a[r.uid])))
    print(f"A == B (page 16 vs page = span) bit for bit: {same_b}; "
          f"A == C (each request alone, chunk 32): {same_c}")
    if not (same_b and all(same_c)):
        raise SystemExit("paged pool tokens differ across page sizes or from solo")

    # a chunk-step decode row against decode_step, and the step times
    with torch.inference_mode():
        prompts = [np.asarray(r.tokens).reshape(-1)[:n] for r, n in
                   zip(reqs, (70, 40, 96, 128))]
        pool, logits, t_chunk, chunk_launches = _streamed_pool(cfg, eng_a.policy, params,
                                                               dev, prompts)
        last, c2, decode_launches = _decode_row_check(cfg, eng_a.policy, params, pool,
                                                      logits, dev)
        t_decode = [_wall(lambda: registry.decode_step(cfg, eng_a.policy, params, last, c2))
                    for _ in range(3)]
        # device time inside one chunk step (4 slots x 32 positions), by kernel
        tokens = torch.as_tensor(np.stack([p[:32] for p in prompts]), device=dev)
        c3 = {k: v.clone() for k, v in pool.items()}
        c3["len"].zero_()
        registry.chunk_step(cfg, eng_a.policy, params, tokens, [32] * 4,
                            {k: v.clone() for k, v in c3.items()})
        c4 = {k: v.clone() for k, v in c3.items()}
        t_full = _wall(lambda: registry.chunk_step(cfg, eng_a.policy, params, tokens,
                                                   [32] * 4, c4))
        prof_row = _profiled(lambda: registry.chunk_step(cfg, eng_a.policy, params, tokens,
                                                         [32] * 4, c3), t_full)
    steps = dict(chunk_step_ms=[t * 1e3 for t in t_chunk],
                 decode_step_ms=[t * 1e3 for t in t_decode],
                 profiled_chunk_step=prof_row, k1_launches_per_chunk_step=chunk_launches,
                 k1_launches_per_decode_step=decode_launches)
    print(f"chunk steps (4 slots x 32, prompts streaming): "
          f"{[round(t, 1) for t in steps['chunk_step_ms']]} ms; decode steps (4 slots): "
          f"{[round(t, 1) for t in steps['decode_step_ms']]} ms")
    print("profiled chunk step (M = 128):", json.dumps(prof_row))
    res["steps"] = steps
    del eng_b, eng_c, pool, c2, c3, c4

    phase(f"20 prefix cache, llama3-8b's widths at {PAGED_LAYERS} layers")
    preqs = shared_prefix_trace(cfg, n_requests=8, prefix_len=96, suffix_len=32, lam=2.0,
                                new_lo=8, new_hi=32, seed=0)
    pkw = dict(kw, page_size=16)
    runs = {}
    for on in (False, True):
        eng = PoolEngine(cfg, policy, params, prefix_cache=on, device=dev, **pkw)
        out, wall, launches = _timed_run(eng, preqs)
        st = eng.last_stats
        runs[on] = (out, st)
        res[f"prefix_{'on' if on else 'off'}"] = row = _serve_row(st, wall, launches)
        print(f"prefix {'on' if on else 'off'}:", json.dumps(row))
        if launches != k1_per_pass(cfg) * st.weight_passes:
            raise SystemExit(f"K1 launched {launches} times, expected {k1_per_pass(cfg)} x "
                             f"{st.weight_passes} weight passes")
        _check_counters(f"prefix {'on' if on else 'off'}", st,
                        _cpu_counters(preqs, dict(pkw, prefix_cache=on), PREFIX_COUNTERS))
        del eng
    (off, st_off), (on, st_on) = runs[False], runs[True]
    same = all(np.array_equal(on[r.uid], off[r.uid]) for r in preqs)
    print(f"prefix on == off bit for bit: {same}; hit rate {st_on.prefix_hit_rate}; "
          f"weight passes {st_on.weight_passes} vs {st_off.weight_passes}; mean TTFT "
          f"{st_on.mean_ttft_passes} vs {st_off.mean_ttft_passes} passes")
    if not (same and st_on.prefix_hit_rate > 0
            and st_on.weight_passes < st_off.weight_passes
            and st_on.mean_ttft_passes < st_off.mean_ttft_passes):
        raise SystemExit("prefix cache: tokens changed or no saving")
    detail["paged_serving"] = res
    return dict(launches=res["A"]["k1_launches"] + res["prefix_on"]["k1_launches"],
                chunk_launches=chunk_launches)


# phase 21's engines run llama3-8b's widths at this depth: at all 32
# layers the whole script read 912.0 s on an H100 (phase 21: 133 s of it);
# at 8 phase 21 took 37.0 s of 875.7 s; cut to 4 to make room for 37p,
# and at 4 26.4 s of a slow host's 951.8 s, cut to 2 for 37r
KVQ_LAYERS = 2
# kv_page_bytes of phase 21's engine at KVQ_LAYERS layers: a 16-position
# page of K and of V holds 8 KV heads x 64 code bytes and one int32 beta a
# token, 8256 bytes a layer each (528,384 at all 32 layers)
KVQ_PAGE_BYTES = 2 * KVQ_LAYERS * 16 * (8 * 64 + 4)


def kv_quant_serving(dev, detail, cfg, params, policy, reqs):
    """Phase 21: phase 19's engine with PoT-quantized KV pages, at
    llama3-8b's widths and ``KVQ_LAYERS`` layers."""
    from repro_torch.core.policy import KV_PINNED
    from repro_torch.models import registry
    from repro_torch.serve import PoolEngine

    phase(f"21 PoT-quantized KV pages (KV_PINNED), llama3-8b's widths at {KVQ_LAYERS} layers")
    cfg = dataclasses.replace(cfg, n_layers=KVQ_LAYERS)
    params = dict(params, layers=_first_layers(params["layers"], KVQ_LAYERS))
    kw = dict(max_slots=4, max_len=160, prefill_chunk=32, kv_quant=KV_PINNED)
    eng_a = PoolEngine(cfg, policy, params, page_size=16, device=dev, **kw)
    eng_a.run([dataclasses.replace(reqs[0], uid="warm-up", max_new_tokens=2)])
    torch.cuda.reset_peak_memory_stats()
    out_a, wall, launches = _timed_run(eng_a, reqs)  # the main path
    st = eng_a.last_stats
    res = {"A": dict(_serve_row(st, wall, launches), kv_page_bytes=st.kv_page_bytes,
                     peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)}
    # phase 19's bf16 figure at this depth (bytes a token scale with layers)
    p19 = detail["paged_serving"]["A"]
    bf16 = p19["kv_hbm_bytes_per_token"] * KVQ_LAYERS / p19["layers"]
    print("A (page 16, KV_PINNED):", json.dumps(res["A"]))
    print(f"kv_page_bytes {st.kv_page_bytes} (bf16: {2 * KVQ_LAYERS * 16 * 8 * 128 * 2}); "
          f"kv_hbm_bytes_per_token {st.kv_hbm_bytes_per_token} (phase 19's bf16 at "
          f"{KVQ_LAYERS} layers: {bf16})")
    if launches != k1_per_pass(cfg) * st.weight_passes:
        raise SystemExit(f"K1 launched {launches} times in A, expected {k1_per_pass(cfg)} x "
                         f"{st.weight_passes} weight passes")
    if st.kv_page_bytes != KVQ_PAGE_BYTES:
        raise SystemExit(f"kv_page_bytes {st.kv_page_bytes}, expected {KVQ_PAGE_BYTES}")
    check_tokens(cfg, reqs, out_a)
    _check_counters("A", st, _cpu_counters(reqs, dict(kw, page_size=16), SERVE_COUNTERS))
    eng_b = PoolEngine(cfg, policy, params, device=dev, **kw)
    out_b, wall, launches = _timed_run(eng_b, reqs)
    res["B"] = _serve_row(eng_b.last_stats, wall, launches)
    print("B (page = span):", json.dumps(res["B"]))
    same_b = all(np.array_equal(out_a[r.uid], out_b[r.uid]) for r in reqs)
    eng_c = PoolEngine(cfg, policy, params, **dict(kw, max_slots=1), device=dev)
    same_c = [bool(np.array_equal(eng_c.run([dataclasses.replace(r, arrival=0)])[r.uid],
                                  out_a[r.uid])) for r in reqs]
    print(f"A == B (page 16 vs page = span) bit for bit: {same_b}; "
          f"A == C (each request alone): {same_c}")
    if not (same_b and all(same_c)):
        raise SystemExit("quantized pool tokens differ across page sizes or from solo")
    with torch.inference_mode():
        prompts = [np.asarray(r.tokens).reshape(-1)[:n] for r, n in
                   zip(reqs, (70, 40, 96, 128))]
        pool, logits, t_chunk, _ = _streamed_pool(cfg, eng_a.policy, params, dev, prompts,
                                                  KV_PINNED)
        last, c2, decode_launches = _decode_row_check(cfg, eng_a.policy, params, pool,
                                                      logits, dev)
        t_decode = [_wall(lambda: registry.decode_step(cfg, eng_a.policy, params, last, c2))
                    for _ in range(3)]
        prof_row = _profiled(lambda: registry.decode_step(cfg, eng_a.policy, params, last, c2),
                             min(t_decode))
    res["steps"] = dict(chunk_step_ms=[t * 1e3 for t in t_chunk],
                        decode_step_ms=[t * 1e3 for t in t_decode],
                        profiled_decode_step=prof_row)
    print(f"quantized pool: chunk steps {[round(t * 1e3, 1) for t in t_chunk]} ms, "
          f"decode steps {[round(t * 1e3, 1) for t in t_decode]} ms")
    print("profiled decode step over the quantized pages:", json.dumps(prof_row))
    detail["kv_quant_serving"] = res
    return dict(launches=res["A"]["k1_launches"])


def _verify_check(cfg, pol, params, dev, prompts, kv_quant, label):
    """Verify logits for 4 slots x 4 positions against 4 sequential
    ``decode_step`` calls, bit for bit, and every cache leaf after them;
    one K1 launch a linear in the verify pass.  Returns (verify seconds, its K1
    launches, a verify call for the profiler)."""
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.models import registry

    pool, _, _, _ = _streamed_pool(cfg, pol, params, dev, prompts, kv_quant)
    rows = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (4, 4)),
                           device=dev)
    c1 = {k: v.clone() for k, v in pool.items()}
    c2 = {k: v.clone() for k, v in pool.items()}
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lv, c1 = registry.verify_step(cfg, pol, params, rows, [4] * 4, c1)
    torch.cuda.synchronize()
    t_verify = time.perf_counter() - t0
    launches = K.potq_matmul_cuda.launches
    seq = []
    for j in range(4):
        lg, c2 = registry.decode_step(cfg, pol, params, rows[:, j], c2)
        seq.append(lg)
    equal = bool(torch.equal(lv, torch.stack(seq, dim=1))) and all(
        torch.equal(c1[k], c2[k]) for k in c1)
    print(f"{label}: verify (4 slots x 4 positions, slot 0 across a page) == 4 sequential "
          f"decode steps (logits and every cache leaf): {equal}; K1 launches {launches}")
    if not equal or launches != k1_per_pass(cfg):
        raise SystemExit(f"{label}: verify differs from sequential decode ({equal}) or K1 "
                         f"launched {launches} times in a verify pass")
    c3 = {k: v.clone() for k, v in pool.items()}
    return t_verify, launches, lambda: registry.verify_step(cfg, pol, params, rows, [4] * 4, c3)


def _counted(fn, calls):
    """``fn`` that appends 1 to ``calls`` at each call (host-side only)."""
    def wrapped(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)
    return wrapped


def _first_layers(tree, n):
    """The first ``n`` layers of a stacked layer tree (views)."""
    return {k: _first_layers(v, n) if isinstance(v, dict) else v[:n] for k, v in tree.items()}


# phase 22 runs llama3-8b's widths at this depth (its verify and draft
# checks too since PR 22): five engine runs on a host-bound path, kept
# short so the whole script stays well inside its time limit (at 4 the
# phase took 59.9 s and 36c 13.0 s of 875.7 s on an NVIDIA H100 80GB HBM3
# at 700.00 W; cut to 2 to make room for phase 37p; at 2 phase 22 took
# 45.8 s of a slow host's 951.8 s, cut to 1 for phase 37r's room)
SPEC_LAYERS = 1


def spec_serving(dev, detail, cfg, params, policy, reqs):
    """Phase 22: speculative decoding on phase 19's engine (bf16 pages) and
    on phase 21's (quantized pages), at ``SPEC_LAYERS`` layers against
    their spec-off runs at that depth."""
    from repro_torch.core import mfmac
    from repro_torch.core.policy import KV_PINNED
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.models import registry
    from repro_torch.serve import LowBitSelfDraft, NgramDrafter, PoolEngine

    phase(f"22 speculative decoding, llama3-8b's widths at {SPEC_LAYERS} layers")
    verify_step = registry.verify_step
    kw = dict(max_slots=4, max_len=160, prefill_chunk=32, page_size=16)
    scfg = dataclasses.replace(cfg, n_layers=SPEC_LAYERS)
    sparams = dict(params, layers=_first_layers(params["layers"], SPEC_LAYERS))
    res, off = {}, {}
    for kvq, label in ((None, "spec_off"), (KV_PINNED, "kvq_spec_off")):
        eng = PoolEngine(scfg, policy, sparams, kv_quant=kvq, device=dev, **kw)
        out, wall, launches = _timed_run(eng, reqs)
        st = eng.last_stats
        res[label] = _serve_row(st, wall, launches)
        print(f"{label}:", json.dumps(res[label]))
        if launches != k1_per_pass(scfg) * st.weight_passes:
            raise SystemExit(f"{label}: K1 launched {launches} times, expected "
                             f"{k1_per_pass(scfg)} x {st.weight_passes} weight passes")
        off[kvq] = (out, st.weight_passes)
    runs = {"ngram": (NgramDrafter(max_draft=3), None),
            "self_draft": (LowBitSelfDraft(max_draft=3, bits=DRAFT_BITS), None),
            "kvq_self_draft": (LowBitSelfDraft(max_draft=3, bits=DRAFT_BITS), KV_PINNED)}
    launches_total, eng = 0, None
    for name, (drafter, kvq) in runs.items():
        eng = PoolEngine(scfg, policy, sparams, spec=drafter, kv_quant=kvq, device=dev, **kw)
        eng.run([dataclasses.replace(reqs[0], uid="warm-up", max_new_tokens=2)])
        verify_calls = []
        registry.verify_step = _counted(verify_step, verify_calls)
        try:
            out, wall, launches = _timed_run(eng, reqs)
        finally:
            registry.verify_step = verify_step
        st = eng.last_stats
        launches_total += launches
        res[name] = row = dict(_serve_row(st, wall, launches), verify_passes=len(verify_calls),
                               accepted_tokens=st.accepted_tokens,
                               draft_weight_passes=st.draft_weight_passes,
                               accepted_tokens_per_weight_pass=st.accepted_tokens_per_weight_pass)
        toks_off, passes_off = off[kvq]
        same = all(np.array_equal(out[r.uid], toks_off[r.uid]) for r in reqs)
        row["spec_off_weight_passes"] = passes_off
        print(f"{name}:", json.dumps(row))
        print(f"{name}: tokens == spec off ({'quantized' if kvq else 'bf16'} pages, "
              f"{SPEC_LAYERS} layers) bit for bit: {same}; weight passes "
              f"{st.weight_passes} <= {passes_off}")
        if not same or st.weight_passes > passes_off:
            raise SystemExit(f"{name}: speculation changed the tokens or added passes")
        want = k1_per_pass(scfg) * (st.weight_passes + st.draft_weight_passes)
        if launches != want:
            raise SystemExit(f"{name}: K1 launched {launches} times, expected "
                             f"{k1_per_pass(scfg)} x (weight passes + draft steps) = {want}")
    # the verify pass and the draft step on the card at SPEC_LAYERS layers
    # (32 until PR 22, when the script read 1041.7 s), each against its
    # sequential or plain counterpart; slot 0's row (positions 62..65)
    # crosses a 16-position page
    prompts = [np.asarray(r.tokens).reshape(-1)[:n] for r, n in
               zip(reqs, (62, 40, 96, 126))]
    steps = {}
    with torch.inference_mode():
        for kvq, label in ((None, "bf16"), (KV_PINNED, "KV_PINNED")):
            pol = dataclasses.replace(eng.policy, kv_quant=kvq)
            t_verify, verify_launches, again = _verify_check(scfg, pol, sparams, dev, prompts,
                                                             kvq, label)
            steps[f"verify_{label}"] = dict(wall_ms=t_verify * 1e3,
                                            profiled=_profiled(again, t_verify))
        dpol = eng.draft_policy
        pool, logits, _, _ = _streamed_pool(scfg, eng.policy, sparams, dev, prompts, KV_PINNED)
        last = torch.argmax(logits, -1)
        _zero_launches()
        t_draft = [_wall(lambda: registry.decode_step(scfg, dpol, sparams, last, pool))
                   for _ in range(3)]
        draft_launches = K.potq_matmul_cuda.launches // 3
        if draft_launches != k1_per_pass(scfg):
            raise SystemExit(f"K1 launched {draft_launches} times in a draft step")
        prof = _profiled(lambda: registry.decode_step(scfg, dpol, sparams, last, pool),
                         min(t_draft))
        # the draft's weight re-quantizations (5 -> 3 bits, WBC) alone
        leaves = [lp[key]["w"] for lp in (sparams["layers"], sparams["layers"]["mlp"])
                  for key in lp if isinstance(lp[key], dict) and "w" in lp[key]]
        requant = _wall(lambda: [mfmac._quantize_w(w[i], dpol) for w in leaves
                                 for i in range(w.shape[0])]
                        + [mfmac._quantize_w(sparams["lm_head"]["w"], dpol)])
    steps["draft_step"] = dict(wall_ms=[t * 1e3 for t in t_draft], profiled=prof,
                               weight_requantization_ms=requant * 1e3,
                               requantized_leaves=sum(w.shape[0] for w in leaves) + 1)
    res["steps"] = steps
    for key, row in steps.items():
        print(f"{key}:", json.dumps(row))
    detail["spec_serving"] = res
    return dict(launches=launches_total, verify_launches=verify_launches,
                draft_launches=draft_launches)


# phase 23 runs llama3-8b's widths at this depth (at all 32 layers it was
# the script's largest phase, 82 s of 909.7 s on an NVIDIA H100 80GB HBM3;
# 8 until phase 37r took the room, when it took 19.7 s of 776.2 s)
LOCKSTEP_LAYERS = 4


def lockstep_serving(dev, detail, cfg, params, policy, reqs):
    """Phase 23: lockstep serving and float32 K/V pages, llama3-8b's widths
    at ``LOCKSTEP_LAYERS`` layers, on the serve trace's first 4 requests."""
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.serve import PoolEngine, lockstep_generate

    phase(f"23 lockstep serving and cache_dtype, llama3-8b's widths at {LOCKSTEP_LAYERS} "
          "layers")
    cfg = dataclasses.replace(cfg, n_layers=LOCKSTEP_LAYERS)
    params = dict(params, layers=_first_layers(params["layers"], LOCKSTEP_LAYERS))
    wave = reqs[:4]
    horizon = max(r.max_new_tokens for r in wave)
    batch = {"tokens": np.concatenate([np.asarray(r.tokens) for r in wave], axis=0)}
    lockstep_generate(cfg, policy, params, batch, max_new_tokens=2, max_len=160, device=dev)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    out = lockstep_generate(cfg, policy, params, batch, max_new_tokens=horizon, max_len=160,
                            device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.potq_matmul_cuda.launches
    # one batched prefill, then horizon - 1 lockstep steps, each a weight pass
    useful = sum(r.max_new_tokens for r in wave)
    res = {"wave": dict(wall_s=wall, tokens_per_s=useful / wall, emitted_tokens=useful,
                        slot_tokens_per_s=len(wave) * horizon / wall, weight_passes=horizon,
                        decode_steps=horizon - 1, prefills=1, k1_launches=launches)}
    print("lockstep wave (4 requests):", json.dumps(res["wave"]))
    if launches != k1_per_pass(cfg) * horizon:
        raise SystemExit(f"lockstep: K1 launched {launches} times, expected "
                         f"{k1_per_pass(cfg)} x {horizon} weight passes")
    if out.shape != (len(wave), horizon) or int(out.min()) < 0 or \
            int(out.max()) >= cfg.vocab_padded:
        raise SystemExit(f"bad lockstep tokens: {out}")
    # batch-1 lockstep (per-tensor scales, the lockstep cache) against the
    # same request served by a solo-prefill pool (paged, per-sample scales)
    eng = PoolEngine(cfg, policy, params, max_slots=4, max_len=160, page_size=16, device=dev)
    pooled, wall, launches = _timed_run(eng, wave)
    res["solo_prefill_pool"] = _serve_row(eng.last_stats, wall, launches)
    r0 = wave[0]
    solo = lockstep_generate(cfg, policy, params, {"tokens": r0.tokens},
                             max_new_tokens=r0.max_new_tokens, max_len=160, device=dev)
    same = bool(np.array_equal(solo[0].numpy(), pooled[r0.uid]))
    print(f"batch-1 lockstep of request {r0.uid} == solo-prefill pool bit for bit: {same}")
    if not same:
        raise SystemExit("batch-1 lockstep differs from the pool")
    # float32 K/V pages: pooled against each request alone
    kw = dict(max_slots=4, max_len=160, prefill_chunk=32, page_size=16,
              cache_dtype=torch.float32)
    eng = PoolEngine(cfg, policy, params, device=dev, **kw)
    out32, wall, launches32 = _timed_run(eng, wave)
    st = eng.last_stats
    res["float32_pages"] = dict(_serve_row(st, wall, launches32),
                                kv_page_bytes=st.kv_page_bytes)
    print("float32 pages (chunk 32, page 16):", json.dumps(res["float32_pages"]))
    bf16_page = 2 * cfg.n_layers * 16 * cfg.kv_heads * cfg.head_dim * 2
    if st.kv_page_bytes != 2 * bf16_page:
        raise SystemExit(f"float32 kv_page_bytes {st.kv_page_bytes}, expected {2 * bf16_page}")
    if launches32 != k1_per_pass(cfg) * st.weight_passes:
        raise SystemExit(f"float32 pages: K1 launched {launches32} times, expected "
                         f"{k1_per_pass(cfg)} x {st.weight_passes} weight passes")
    _check_counters("float32 pages", st, _cpu_counters(wave, kw, SERVE_COUNTERS))
    alone = PoolEngine(cfg, policy, params, device=dev, **dict(kw, max_slots=1))
    same_c = [bool(np.array_equal(alone.run([dataclasses.replace(r, arrival=0)])[r.uid],
                                  out32[r.uid])) for r in wave]
    print(f"float32 pages: pooled == each request alone: {same_c}")
    if not all(same_c):
        raise SystemExit("float32 pages: pooled tokens differ from solo")
    detail["lockstep_serving"] = res
    return dict(launches=res["wave"]["k1_launches"] + launches32,
                wave_launches=res["wave"]["k1_launches"])


# phases 24-25: each other dense decoder through phase 19's engine
DENSE_TRACE = dict(n_requests=4, prompt_len=128, lam=2.0, new_lo=8, new_hi=16, seed=0)


# phase 26's weights, drawn leaf by leaf in f32, must leave this much room
MOE_PEAK_GIB = 75.0


def expected_k1(cfg, st):
    """K1 launches of an engine run: ``k1_per_pass`` a weight pass, one
    patch_proj more for each vlm request (they all solo-prefill); an
    encdec's weight passes include one encoder-side pass an admission
    (``encdec_pass_counts``: as many launches as a decode pass only at
    whisper's full depth)."""
    if cfg.family == "encdec":
        enc = sum(encdec_pass_counts(cfg)[1].values())
        return k1_per_pass(cfg) * (st.weight_passes - st.prefills) + enc * st.prefills
    return k1_per_pass(cfg) * st.weight_passes + (st.prefills if cfg.family == "vlm" else 0)


def dense_serving(dev, detail, arch, number, n_layers=None, max_len=160, trace=DENSE_TRACE):
    """Phase 24 or 25: ``arch`` at full width (weights from seed 0) through
    the chunked (32) + paged (16) engine: A is the main path, C each
    request alone; A's counters against the CPU smoke-width run's; the
    step times and one profiled decode step.  Phases 26-27 serve a MoE
    decoder the same way at its published widths and ``n_layers`` layers,
    and phases 29-30 internvl2-76b (``VLM_LAYERS`` layers, its requests
    with their patches) and whisper-large-v3 (with its frames; the
    encoder-side pass timed and profiled), the peak device memory under
    ``MOE_PEAK_GIB`` in all four.  Returns A's K1 launches."""
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import registry, spec
    from repro_torch.serve import PoolEngine, poisson_trace
    from repro_torch.serve import quantized_weights as qw

    cfg = configs.get_config(arch)
    depth = "" if n_layers is None else f", {n_layers} of {cfg.n_layers} layers" + (
        " (decoder; the encoder whole)" if cfg.family == "encdec" else "")
    phase(f"{number} {arch} at full width{depth}: chunked (32) + paged (16) serving")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    peak_gate = n_layers is not None or cfg.family != "decoder"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = spec.materialize(
        registry.param_specs(cfg), torch.Generator(device=dev).manual_seed(0),
        transform=lambda name, x: qw.quantize_leaf(name, x, PAPER_FAITHFUL))
    torch.cuda.synchronize()
    res = {"params": dict(count=spec.count_params(registry.param_specs(cfg)),
                          seconds=time.perf_counter() - t0,
                          held_gib=torch.cuda.memory_allocated() / 2 ** 30,
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)}
    print("params:", json.dumps(res["params"]))
    if peak_gate and res["params"]["peak_gib"] >= MOE_PEAK_GIB:
        raise SystemExit(f"{arch}: making the weights peaked at {res['params']['peak_gib']:.1f} "
                         f"GiB, over {MOE_PEAK_GIB}")
    policy = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
    reqs = poisson_trace(cfg, **trace)
    kw = dict(max_slots=4, max_len=max_len, prefill_chunk=32, page_size=16)
    eng_a = PoolEngine(cfg, policy, params, device=dev, **kw)
    eng_a.run([dataclasses.replace(reqs[0], uid="warm-up", max_new_tokens=2)])
    syncs = {}
    out_a, wall, launches = _timed_run(eng_a, reqs, syncs)  # the main path
    st = eng_a.last_stats
    res["A"] = dict(_serve_row(st, wall, launches), implicit_syncs=syncs)
    res["tokens"] = {str(u): t.tolist() for u, t in out_a.items()}
    print("A (chunk 32, page 16):", json.dumps(res["A"]))
    # the engine's one host sync a step is its wait on the token copy's
    # event; nothing of the port may synchronize implicitly
    port_syncs = {k: n for k, n in syncs.items() if k.startswith("src/")}
    print(f"implicit host syncs in A made by the port: {port_syncs}")
    if port_syncs:
        raise SystemExit(f"{arch}: the engine synchronized outside its token copy: {port_syncs}")
    if launches != expected_k1(cfg, st):
        raise SystemExit(f"{arch}: K1 launched {launches} times in A, expected "
                         f"{expected_k1(cfg, st)} ({k1_per_pass(cfg)} x {st.weight_passes} "
                         f"weight passes, {st.prefills} prefills)")
    check_tokens(cfg, reqs, out_a)
    _check_counters("A", st, _cpu_counters(reqs, kw, SERVE_COUNTERS, arch))
    eng_c = PoolEngine(cfg, policy, params, device=dev, **dict(kw, max_slots=1))
    same_c = [bool(np.array_equal(eng_c.run([dataclasses.replace(r, arrival=0)])[r.uid],
                                  out_a[r.uid])) for r in reqs]
    print(f"A == C (each request alone, chunk 32): {same_c}")
    if not all(same_c):
        raise SystemExit(f"{arch}: pooled tokens differ from solo")
    with torch.inference_mode():
        prompts = [np.asarray(r.tokens).reshape(-1)[:n] for r, n in
                   zip(reqs, (70, 40, 96, 128))]
        frames = ([r.extras["frames"] for r in reqs] if cfg.family == "encdec" else None)
        pool, logits, t_chunk, _ = _streamed_pool(cfg, eng_a.policy, params, dev, prompts,
                                                  frames=frames)
        if frames:
            res["encoder_pass"] = _encoder_pass(cfg, eng_a.policy, params, dev, frames[0])
        last, c2, _ = _decode_row_check(cfg, eng_a.policy, params, pool, logits, dev)
        t_decode = [_wall(lambda: registry.decode_step(cfg, eng_a.policy, params, last, c2))
                    for _ in range(3)]
        prof = _profiled(lambda: registry.decode_step(cfg, eng_a.policy, params, last, c2),
                         min(t_decode))
    # K1's bytes bound over one decode weight pass (M = 4, an expert its
    # capacity rows of the 4 slots): each bf16 operand read once, the f32
    # output written once
    prof["k1_bytes_bound_ms"] = decode_pass_bytes(cfg) / PEAK_BYTES * 1e3
    res["steps"] = dict(chunk_step_ms=[t * 1e3 for t in t_chunk],
                        decode_step_ms=[t * 1e3 for t in t_decode], profiled_decode_step=prof)
    print(f"{arch}: chunk steps {[round(t * 1e3, 1) for t in t_chunk]} ms, decode steps "
          f"{[round(t * 1e3, 1) for t in t_decode]} ms")
    print(f"{arch}: profiled decode step (K1 device ms against its "
          f"{prof['k1_bytes_bound_ms']:.2f} ms bytes bound):", json.dumps(prof))
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{arch}: peak device memory over the phase {res['peak_gib']:.2f} GiB")
    if peak_gate and res["peak_gib"] >= MOE_PEAK_GIB:
        raise SystemExit(f"{arch}: the phase peaked at {res['peak_gib']:.1f} GiB, over "
                         f"{MOE_PEAK_GIB}")
    detail[f"serving_{arch}"] = res
    del params, eng_a, eng_c, pool, c2
    torch.cuda.empty_cache()
    return launches



# ---------------------------------------------------------------------------
# Phase 35: the paper's CNN; phase 36: quantized attention
# ---------------------------------------------------------------------------

# phase 35's cells: the repo's width (16 channels, 16 x 16 images, batch 64,
# the example's) and ResNet-18's first-stage width (64 channels, 64 x 64,
# batch 256)
CNN_CELLS = {"narrow": dict(width=16, res=16, batch=64), "wide": dict(width=64, res=64, batch=256)}
CNN_STEPS, CNN_WIDE_STEPS = 120, 3
CNN_MIN_ACCURACY = 0.5  # chance is 0.1
# launches of K1, K2, K3 and the pre-pass a quantized CNN step: 6 convs + the head
CNN_STEP_LAUNCHES = 7
CNN_PEAK_GIB = 75.0


def cnn_example():
    """``examples/cnn_classification_torch.py`` as a module."""
    sys.path.insert(0, str(ROOT / "examples"))
    import cnn_classification_torch

    return cnn_classification_torch


def conv_shapes(width, res, batch):
    """(M, K, N) of each linear of the CNN at one cell: each conv as its
    im2col product (M = B x Ho x Wo, K = Cin x KH x KW), then the head."""
    w, m1, m2 = width, batch * res * res, batch * (res // 2) ** 2
    return {"stem": (m1, 27, w), "block1a": (m1, 9 * w, w), "block1b": (m1, 9 * w, w),
            "block2a": (m2, 9 * w, 2 * w), "block2b": (m2, 18 * w, 2 * w),
            "proj2": (m2, w, 2 * w), "head": (batch, 2 * w, 10)}


def _conv_operands(dev, gen, m, k, n, bits_a, bits_w):
    """a, g, aq, wq, amax, t of one CNN linear as a training step makes
    them (PRC at 0.95, WBC, the policy's bit-widths)."""
    from repro_torch.core import potq

    a = torch.randn(m, k, generator=gen, device=dev) * 1.7
    w = torch.randn(k, n, generator=gen, device=dev) * 0.1
    g = torch.randn(m, n, generator=gen, device=dev) * 1e-4
    amax = a.abs().amax()
    t = amax * 0.95
    aq = potq.pot_quantize(torch.clamp(a, -t, t), bits_a).to(torch.bfloat16)
    wq = potq.pot_quantize(w - w.mean(), bits_w).to(torch.bfloat16)
    return a, g, aq, wq, amax, t


def cnn_kernel_checks(dev, pols):
    """Phase 35a: K1, the G pre-pass, K2 (dA, the dgamma rows, dgamma) and
    K3 against their plain versions, bit for bit, at every distinct (M, K,
    N) of both cells under each policy of ``pols``.  Returns ({kernel: max
    abs err}, the first policy's operands by shape for 35b)."""
    from repro_torch.core import potq
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(35)
    max_err = {"k1": 0.0, "k2": 0.0, "k3": 0.0, "gq": 0.0}
    timing = {}
    for name, pol in pols.items():
        for cell, c in CNN_CELLS.items():
            for layer, (m, kk, nn) in conv_shapes(**c).items():
                if layer == "block1b":
                    continue  # block1a's shape
                bits_g = pol.bits_g_last if layer == "head" else pol.bits_g
                a, g, aq, wq, amax, t = _conv_operands(dev, gen, m, kk, nn, pol.bits_a,
                                                       pol.bits_w)
                e = potq.pot_emax(bits_g)
                beta = potq.compute_beta(g, bits_g)
                s = torch.stack([potq.exp2i(-beta), potq.exp2i(beta), t])
                out_k, out_p = K.potq_matmul_cuda(aq, wq), K.potq_matmul_plain(aq, wq)
                gq_k, gq_p = KG.quantize_g_cuda(g, s, emax_g=e), KG._quantize_g(g, s, e)
                da_k, rows_k = KG.grad_da_cuda(g, wq, a, s, emax_g=e, prc=True, gq=gq_k)
                da_p, rows_p = KG.grad_da_plain(g, wq, a, s, emax_g=e, prc=True)
                dw_k = KG.grad_dw_cuda(aq, g, s, emax_g=e, gq=gq_k)
                dw_p = KG.grad_dw_plain(aq, g, s, emax_g=e)
                dg_k, dg_p = ref.halves_fold(rows_k) * amax, ref.halves_fold(rows_p) * amax
                torch.cuda.synchronize()
                errs = dict(k1=(out_k - out_p).abs().max().item(),
                            gq=(gq_k.float() - gq_p).abs().max().item(),
                            k2=max((da_k - da_p).abs().max().item(),
                                   (rows_k - rows_p).abs().max().item(),
                                   (dg_k - dg_p).abs().item()),
                            k3=(dw_k - dw_p).abs().max().item())
                ok = (torch.equal(out_k, out_p) and torch.equal(gq_k.float(), gq_p)
                      and torch.equal(da_k, da_p) and torch.equal(rows_k, rows_p)
                      and torch.equal(dg_k, dg_p) and torch.equal(dw_k, dw_p)
                      and all(bool(torch.isfinite(x).all()) for x in (out_k, da_k, dw_k)))
                print(f"{name} {cell} {layer} M={m} K={kk} N={nn} bits_g={bits_g}: "
                      f"equal={ok} {json.dumps(errs)}", flush=True)
                if not ok:
                    raise SystemExit(f"K1/K2/K3/pre-pass differ from their plain versions at "
                                     f"the CNN's {cell} {layer} under {name}")
                for key, v in errs.items():
                    max_err[key] = max(max_err[key], v)
                del out_k, out_p, gq_k, gq_p, da_k, da_p, dw_k, dw_p
                if name == next(iter(pols)):
                    timing[(cell, layer)] = (a, g, aq, wq, s, e)
                del a, g, aq, wq
        torch.cuda.empty_cache()
    return max_err, timing


def cnn_kernel_timing(timing, flush):
    """Phase 35b: K1, K2 (its pre-pass included), K3 and the pre-pass alone
    at each CNN shape (CUDA events, L2 flushed) beside their plain
    versions, ``torch.matmul`` on the same bf16 operands (a yardstick),
    their roofline bound and their FP64 tensor-core bound, and each summed
    over one training step of each cell (block1's shape twice).  Returns
    (rows, {cell: {kernel: sums}})."""
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K

    rows, steps = [], {}
    for cell, c in CNN_CELLS.items():
        steps[cell] = {key: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "t_ops": 0.0,
                             "t_bytes": 0.0, "fp64_tc_bound_ms": 0.0}
                       for key in ("k1", "k2", "k3", "gq")}
        for layer, (m, kk, nn) in conv_shapes(**c).items():
            a, g, aq, wq, s, e = timing[(cell, "block1a" if layer == "block1b" else layer)]
            gq = KG.quantize_g_cuda(g, s, emax_g=e)
            fns = {"k1": (lambda: K.potq_matmul_cuda(aq, wq), lambda: K.potq_matmul_plain(aq, wq),
                          lambda: torch.matmul(aq, wq)),
                   "k2": (lambda: KG.grad_da_cuda(g, wq, a, s, emax_g=e, prc=True),
                          lambda: KG.grad_da_plain(g, wq, a, s, emax_g=e, prc=True),
                          lambda: torch.matmul(gq, wq.T)),
                   "k3": (lambda: KG.grad_dw_cuda(aq, g, s, emax_g=e, gq=gq),
                          lambda: KG.grad_dw_plain(aq, g, s, emax_g=e),
                          lambda: torch.matmul(aq.T, gq)),
                   "gq": (lambda: KG.quantize_g_cuda(g, s, emax_g=e),
                          lambda: KG._quantize_g(g, s, e), None)}
            for key, (kern, plain, lib) in fns.items():
                if layer == "block1b":  # block1a's row, counted twice
                    row = dict(next(r for r in rows if r["cell"] == cell
                                    and r["layer"] == "block1a" and r["kernel"] == key),
                               layer="block1b")
                else:
                    t_k = time_ms(kern, 3 if key != "gq" else 10, flush)
                    t_p = time_ms(plain, 1, flush)
                    t_l = time_ms(lib, 3, flush) if lib is not None else None
                    if key == "gq":
                        t_ops, t_bytes = 0.0, 6.0 * m * nn / PEAK_BYTES * 1e3
                    else:
                        t_ops, t_bytes = train_bound(m, kk, nn, key)
                    row = dict(cell=cell, layer=layer, kernel=key, M=m, K=kk, N=nn, ms=t_k,
                               plain_ms=t_p, library_ms=t_l, bound_ms=max(t_ops, t_bytes),
                               bound_by="operations" if t_ops > t_bytes else "bytes",
                               t_ops=t_ops, t_bytes=t_bytes,
                               fp64_tc_bound_ms=(2.0 * m * kk * nn / PEAK_FP64_TC_FLOPS * 1e3
                                                 if key != "gq" else None))
                    if key == "k3":  # one block per 128 x 128 tile of dW walks all of M
                        row["grid_blocks"] = -(-kk // 128) * -(-nn // 128)
                    print(json.dumps({k: v for k, v in row.items()
                                      if k not in ("t_ops", "t_bytes")}), flush=True)
                rows.append(row)
                acc = steps[cell][key]
                for f in ("ms", "plain_ms", "t_ops", "t_bytes"):
                    acc[f] += row[f]
                acc["library_ms"] = (None if row["library_ms"] is None
                                     else acc["library_ms"] + row["library_ms"])
                acc["fp64_tc_bound_ms"] = (None if row["fp64_tc_bound_ms"] is None
                                           else acc["fp64_tc_bound_ms"] + row["fp64_tc_bound_ms"])
            del gq
        for key, acc in steps[cell].items():
            t_ops, t_bytes = acc.pop("t_ops"), acc.pop("t_bytes")
            acc["bound_ms"] = max(t_ops, t_bytes)
            acc["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
            acc["launches"] = CNN_STEP_LAUNCHES
            print(f"{key}, one {cell} CNN training step ({CNN_STEP_LAUNCHES} launches):",
                  json.dumps(acc), flush=True)
    for r in rows:
        r.pop("t_ops", None)
        r.pop("t_bytes", None)
    return rows, steps


def cnn_training(dev, detail, ex):
    """Phases 35c-f: ``train_cnn`` at the repo's width under the example's
    three policies (the main path: launches counted from 0 around each
    run), CUDA against CPU, a step twice, and the wide cell's steps."""
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import spec
    from repro_torch.train import value_and_grad
    from repro_torch.models import cnn

    counters = _kernel_counters()
    narrow = CNN_CELLS["narrow"]
    phase(f"35c train_cnn at width {narrow['width']}, {narrow['res']} x {narrow['res']}, batch "
          f"{narrow['batch']}, {CNN_STEPS} steps, three policies")
    res, launches_total = {}, {k: 0 for k in counters}
    for label, pol in ex.POLICIES:
        times = []

        def mark(step, loss):
            torch.cuda.synchronize()
            times.append(time.perf_counter())

        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        acc, loss, params = ex.train_cnn(pol, steps=CNN_STEPS, device=dev, on_step=mark)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        q = pol.enabled
        # every step, then the eval forward (K1 only)
        want = {k: (CNN_STEPS * CNN_STEP_LAUNCHES + (CNN_STEP_LAUNCHES if k == "k1" else 0))
                if q else 0 for k in counters}
        step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
        opt, step = ex.make_step(pol)
        state = opt.init(params)
        x, y = ex.batch_at(CNN_STEPS, narrow["batch"], narrow["res"], dev)
        _zero_launches()
        prof = _profiled(lambda: step(params, state, x, y, CNN_STEPS),
                             sum(step_ms) / len(step_ms) / 1e3)
        per_step = {k: fn.launches for k, fn in counters.items()}
        row = dict(accuracy=acc, final_loss=loss, wall_s=wall, launches=launches,
                   expected_launches=want, step_ms_mean=sum(step_ms) / len(step_ms),
                   step_ms_min=min(step_ms), step_ms_max=max(step_ms),
                   launches_a_step=per_step, profiled_step=prof)
        print(f"{label}:", json.dumps(row), flush=True)
        if launches != want or per_step != {k: CNN_STEP_LAUNCHES if q else 0 for k in counters}:
            raise SystemExit(f"{label}: the CNN launched {launches} ({per_step} a step), "
                             f"expected {want}")
        if not (acc >= CNN_MIN_ACCURACY and np.isfinite(loss)):
            raise SystemExit(f"{label}: accuracy {acc} (below {CNN_MIN_ACCURACY}) or loss {loss}")
        res[label.split()[0]] = row
        for k in counters:
            launches_total[k] += launches[k]
        del params, state

    phase("35d the CNN on CUDA and on the CPU, 3 steps from the same state")
    cmp = {}
    for label, pol in ex.POLICIES:
        runs = {}
        for where in ("cpu", dev):
            p = ex.init_params(narrow["width"], 0, where)
            opt, step = ex.make_step(pol)
            state = opt.init(p)
            bs = [ex.batch_at(i, narrow["batch"], narrow["res"], where) for i in range(3)]
            _, grads = value_and_grad(lambda t: cnn.loss_fn(pol, t, *bs[0]), p)
            losses = []
            for i, (x, y) in enumerate(bs):
                p, state, loss = step(p, state, x, y, i)
                losses.append(float(loss))
            runs[str(where)] = (losses, {n: g.cpu() for n, g in spec.named_leaves(grads)})
            if where is dev:
                saved = (p, state, bs, step)
        (lc, gc), (lg, gg) = runs["cpu"], runs[str(dev)]
        g_worst = max(float((gg[n] - gc[n]).abs().max()) / max(float(gc[n].abs().max()), 1e-30)
                      for n in gc)
        row = dict(losses_cpu=lc, losses_cuda=lg, grad_rel_err=g_worst)
        print(f"{label}:", json.dumps(row), f"(tolerances: loss rtol {LOSS_RTOL}, grads "
              f"{GRAD_RTOL} x max|g|)", flush=True)
        if not all(abs(a - b) <= LOSS_RTOL * abs(b) for a, b in zip(lg, lc)) or                 not g_worst <= GRAD_RTOL:
            raise SystemExit(f"{label}: the CNN on CUDA and on the CPU disagree")
        cmp[label.split()[0]] = row
        if pol is PAPER_FAITHFUL:
            twice = saved
    res["cuda_vs_cpu"] = cmp

    phase("35e one CNN step twice from the same state (PAPER_FAITHFUL)")
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    p, state, bs, step = twice
    x, y = bs[0]
    keep = (_state_copy(p), _state_copy(state))
    p, state, l1 = step(p, state, x, y, 3)
    first = _state_copy(p)
    _state_load(p, keep[0])
    _state_load(state, keep[1])
    p, state, l2 = step(p, state, x, y, 3)
    torch.cuda.synchronize()
    same = torch.equal(l1, l2) and all(torch.equal(a, b) for (_, a), (_, b) in
                                       zip(spec.named_leaves(first), spec.named_leaves(p)))
    print(f"loss {float(l1)!r} / {float(l2)!r}; every parameter bit-equal: {same}")
    torch.use_deterministic_algorithms(deterministic)
    if not same:
        raise SystemExit("two runs of one CNN step differ")
    res["step_twice_equal"] = same
    del twice, p, state, keep, first

    wide = CNN_CELLS["wide"]
    phase(f"35f the CNN at width {wide['width']}, {wide['res']} x {wide['res']}, batch "
          f"{wide['batch']}: {CNN_WIDE_STEPS} steps (PAPER_FAITHFUL), one profiled")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p = ex.init_params(wide["width"], 0, dev)
    opt, step = ex.make_step(PAPER_FAITHFUL)
    state = opt.init(p)
    _zero_launches()
    times, losses = [], []
    for i in range(CNN_WIDE_STEPS):
        x, y = ex.batch_at(i, wide["batch"], wide["res"], dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, state, loss = step(p, state, x, y, i)
        losses.append(float(loss))  # waits for the device
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    x, y = ex.batch_at(CNN_WIDE_STEPS, wide["batch"], wide["res"], dev)
    prof = _profiled(lambda: step(p, state, x, y, CNN_WIDE_STEPS), min(times[1:]))
    shapes = conv_shapes(**wide).values()
    prof["fp64_tc_bound_ms"] = sum(2.0 * m * k * n for m, k, n in shapes) / PEAK_FP64_TC_FLOPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    row = dict(losses=losses, step_ms=[t * 1e3 for t in times], launches=launches,
               peak_gib=peak, profiled_step=prof)
    print("wide:", json.dumps(row), flush=True)
    want = {k: CNN_WIDE_STEPS * CNN_STEP_LAUNCHES for k in counters}
    if launches != want or not all(np.isfinite(losses)) or peak >= CNN_PEAK_GIB:
        raise SystemExit(f"the wide CNN: launches {launches} (expected {want}), losses {losses}, "
                         f"peak {peak:.1f} GiB (gate {CNN_PEAK_GIB})")
    res["wide"] = row
    for k in counters:
        launches_total[k] += launches[k]
    del p, state
    torch.cuda.empty_cache()
    detail["cnn_training"] = res
    return res, launches_total


def cnn_phase(dev, detail):
    """Phase 35: the paper's CNN (``models/cnn.py``, every conv an im2col
    product through K1-K3).  Returns (kernel rows by kernel for the
    ``kernels`` line, the main path's launches)."""
    from repro_torch.core.policy import PAPER_FAITHFUL

    ex = cnn_example()
    phase("35a K1, K2, K3 and the pre-pass vs plain versions at the CNN's shapes (bit for bit)")
    max_err, timing = cnn_kernel_checks(dev, {"PAPER_FAITHFUL": PAPER_FAITHFUL,
                                              "BITS444": ex.BITS444})
    phase("35b K1, K2, K3 and pre-pass timing at the CNN's shapes (CUDA events, L2 flushed)")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows, steps = cnn_kernel_timing(timing, flush)
    del timing, flush
    torch.cuda.empty_cache()
    detail["cnn_kernel_shapes"] = rows
    train, launches = cnn_training(dev, detail, ex)
    kernels = {k: dict(max_abs_err=max_err[k], launches=launches[k],
                       **{f"{cell}_step": steps[cell][k] for cell in CNN_CELLS},
                       wide_step_device_ms=train["wide"]["profiled_step"][
                           "prepass_ms" if k == "gq" else f"{k}_ms"])
               for k in max_err}
    return kernels, launches



QA_ARCHS = ("olmo-1b", ENCDEC_ARCH, "recurrentgemma-2b")


def qa_policy():
    from repro_torch.core.policy import PAPER_FAITHFUL

    return dataclasses.replace(PAPER_FAITHFUL, quantize_attention=True)


def qa_training(dev, detail):
    """Phase 36a: a training step of olmo-1b, whisper-large-v3 and
    recurrentgemma-2b at smoke width under ``quantize_attention``, CUDA
    against CPU (``smoke_training``: losses, gradients, a step twice,
    launches a step: the attention products add no kernel launch)."""
    phase("36a training under quantize_attention at smoke width: CUDA vs CPU, a step twice, "
          "launches a step")
    res = smoke_training(dev, QA_ARCHS, LOSS_RTOL, qa_policy())
    detail["quantize_attention_training"] = res
    return {a: r["launches"] for a, r in res.items()}


def qa_train_step(dev, run, batch, step_no, base):
    """Phase 36b: from phase 10's olmo-1b state at full width, one step
    under ``quantize_attention`` (timed, then one profiled), beside phase
    10's profiled step ``base``; K1/K2/K3/pre-pass launches as phase 10's."""
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.train import make_train_step

    phase("36b olmo-1b at full width: one step under quantize_attention from phase 10's state")
    counters = _kernel_counters()
    step = make_train_step(run.cfg, qa_policy(), adamw(warmup_cosine_schedule(3e-3, 20, 4)))
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, m = step(run.params, run.opt_state, batch, step_no)
    loss = float(m["loss"])
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    # the device's kernels only, as phase 31b: the host's ops of a 40k-kernel
    # step take the profiler seconds to collect
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        _, _, m2 = step(run.params, run.opt_state, batch, step_no + 1)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t1
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    k1_us = sum(e.time_range.elapsed_us() for e in kern if "potq_mm" in e.name)
    row = dict(loss=loss, loss_next=float(m2["loss"]), step_s=wall, launches=launches,
               profiled=dict(wall_ms=t_prof * 1e3, device_kernels=len(kern),
                             device_busy_ms=busy_us / 1e3, k1_ms=k1_us / 1e3,
                             idle_share=1 - busy_us / 1e6 / wall if kern else None),
               phase10_profiled=dict(wall_ms=base["wall_ms"], device_kernels=base["device_kernels"],
                                     device_busy_ms=base["device_busy_ms"],
                                     idle_share=base["idle_share"]))
    print(json.dumps(row), flush=True)
    if launches != step_launches() or not (np.isfinite(loss) and np.isfinite(row["loss_next"])):
        raise SystemExit(f"quantize_attention step: launches {launches} (expected "
                         f"{step_launches()}), loss {loss}")
    return row


def qa_serving(dev, detail, cfg, params, policy, reqs):
    """Phase 36c: phase 5's engine (4 slots, solo prefill, paged) and trace
    under ``quantize_attention`` at llama3-8b's widths and ``SPEC_LAYERS``
    layers: A is the main path; C (each request alone) gives A's tokens
    bit for bit; K1 once a linear a weight pass."""
    from repro_torch.serve import PoolEngine

    phase(f"36c serving under quantize_attention, llama3-8b's widths at {SPEC_LAYERS} layers")
    scfg = dataclasses.replace(cfg, n_layers=SPEC_LAYERS)
    sparams = dict(params, layers=_first_layers(params["layers"], SPEC_LAYERS))
    pol = dataclasses.replace(policy, quantize_attention=True)
    eng = PoolEngine(scfg, pol, sparams, max_slots=4, max_len=160, device=dev)
    eng.run([dataclasses.replace(reqs[0], uid="warm-up", max_new_tokens=2)])
    out, wall, launches = _timed_run(eng, reqs)
    st = eng.last_stats
    row = _serve_row(st, wall, launches)
    print("A:", json.dumps(row))
    if launches != k1_per_pass(scfg) * st.weight_passes:
        raise SystemExit(f"quantize_attention serving: K1 launched {launches} times, expected "
                         f"{k1_per_pass(scfg)} x {st.weight_passes} weight passes")
    check_tokens(scfg, reqs, out)
    solo = PoolEngine(scfg, pol, sparams, max_slots=1, max_len=160, device=dev)
    same = [bool(np.array_equal(solo.run([dataclasses.replace(r, arrival=0)])[r.uid],
                                out[r.uid])) for r in reqs]
    row["a_equals_c"] = same
    print(f"A == C (each request alone): {same}")
    if not all(same):
        raise SystemExit("quantize_attention serving: pooled tokens differ from solo")
    detail["quantize_attention_serving"] = row
    return launches


# ---------------------------------------------------------------------------
# Phase 37: multi-GPU on torch.distributed, two ranks on the one card
# ---------------------------------------------------------------------------

# 37a: the (1, 2) mesh through phase 5's engine and trace at llama3-8b's
# widths and this depth, against one rank; 37b: the (2, 1) mesh at
# llama3-8b's widths and this depth; 37c: olmo-1b at its published widths
# and this depth, data-parallel at this global batch, these steps.  On an
# NVIDIA H100 80GB HBM3 37a took 62-85 s of the script at all 32 layers
# (against phase 5's tokens) and 38-44 s at 8, 37c 27-44 s at all 16; a
# slow host took the whole script to 1086.6 s with both at those depths;
# 37a at 4 took 22.6 s of 776.2 s, cut to 2 for phase 37r's room, and so
# was 37c (18.1 s at 4 of a slow host's 951.8 s); 37b took 9.0 s at 4 of
# 822.5 s on an NVIDIA H100 80GB HBM3, cut to 2 (and 37j to 2) for phase
# 37s's room
TP_SERVE_LAYERS = 2
DP_SERVE_LAYERS = 2
DP_TRAIN_LAYERS = 2
DP_TRAIN_BATCH, DP_TRAIN_SEQ, DP_TRAIN_STEPS = 4, 512, 2
# 37o (a): olmo-1b at its published widths and this depth tensor-parallel
# on the (1, 2) mesh, phase 37c's batch, these steps; (b): its smoke config
# on the (2, 2) mesh (four ranks on the card) at this batch and steps; 4
# layers until phase 37r took the room (21.4 s of a slow host's 951.8 s)
TP_TRAIN_LAYERS = 2
TP_TRAIN_BATCH, TP_TRAIN_SEQ, TP_TRAIN_STEPS = 4, 512, 2
TP_SMOKE_BATCH, TP_SMOKE_SEQ, TP_SMOKE_STEPS = 4, 64, 3
# 37p (a): whisper-large-v3 at its published widths and this encoder and
# decoder depth tensor-parallel on (1, 2), phase 31b's batch (2 x 448
# tokens, 1500 frames), 37o's steps (37k's depth: its ~1 GB of f32 masters
# fit many times over, but two ranks' shadow gathers through the host grow
# with it); (b) internvl2-76b's smoke config on (1, 2) (its one K/V head
# selected from a whole product); (c) the (2, 2) world of 37o (b) trains
# these smoke configs; 4 + 4 layers until phase 37r took the room (22.0 s
# of a slow host's 951.8 s)
ENCDEC_TP_TRAIN_LAYERS = 2
TP_SMOKE_ARCHS = ("olmo-1b", "internvl2-76b", "whisper-large-v3", "llama4-scout-17b-a16e",
                  "grok-1-314b", "mamba2-2.7b", "recurrentgemma-2b")
# 37q (a): llama4-scout-17b-a16e at its published widths and this depth on
# (1, 2) under EP (8 of its 16 experts a rank), this batch (two dispatch
# groups of 512 tokens), remat, the first step's losses and gradients alone
# (AdamW's m and v at published widths need a card a rank: ROADMAP 9.3b);
# (b) grok-1's smoke config (EP) and the 3-expert grok-1 (TP experts) at
# smoke width and at this d_ff (whole 128-chunks a rank: each expert's K2
# chained) on (1, 2), 37p (b)'s batch and steps; (c) the MoE smoke configs
# in 37o (b)'s (2, 2) world at this sequence (whole dispatch groups a data
# rank; the others at TP_SMOKE_SEQ)
MOE_TP_ARCH = "llama4-scout-17b-a16e"
MOE_TP_TRAIN_LAYERS = 1
MOE_TP_TRAIN_BATCH, MOE_TP_TRAIN_SEQ = 2, 512
GROK3_CHUNKED_FF = 256
TP_SMOKE_SEQS = {"llama4-scout-17b-a16e": 256, "grok-1-314b": 256}
# 37r (a): mamba2-2.7b at its published widths and this depth
# tensor-parallel on (1, 2) (40 of its 80 SSD heads a rank), this batch
# (two SSD chunks of 256 a row), AdamW, remat, these steps; (b)
# recurrentgemma-2b at its published widths and this depth (one rglru,
# rglru, attn period: the RG-LRU, the MLP and the attention under
# ``select``), this batch, the first step's losses and gradients alone
# (its 256000-row head's whole gather and logits lead the gloo bytes);
# each against one rank (run on rank 0 of the four-rank world); (c) both smoke configs and these
# widenings of them (whole 128-chunks a rank: every split contraction
# folds, every column-parallel product but mamba2's in_proj and the
# 160-row vocab shard chains K2) on (1, 2), 37p (b)'s batch and steps;
# (d) both smoke configs in 37o (b)'s (2, 2) world
SSM_TP_TRAIN_LAYERS = 4
SSM_TP_TRAIN_BATCH, SSM_TP_TRAIN_SEQ, SSM_TP_TRAIN_STEPS = 4, 512, 2
HYBRID_TP_TRAIN_LAYERS = 3
HYBRID_TP_TRAIN_BATCH, HYBRID_TP_TRAIN_SEQ = 2, 512
RECURRENT_WIDE = {"mamba2-2.7b": dict(d_model=256),
                  "recurrentgemma-2b": dict(lru_width=256, d_ff=512, head_dim=64)}
# the two ranks' device memory, summed, stays under this
MULTI_PEAK_GIB = 75.0
# 37d: the compressor's unbiasedness bound (standard errors) and draws
PSUM_Z, PSUM_DRAWS = 6.0, 64


def _serve_trace(cfg):
    from repro_torch.serve import poisson_trace

    return poisson_trace(cfg, n_requests=8, prompt_len=128, lam=2.0, new_lo=8, new_hi=32,
                         seed=0)


def _count_kernels():
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K

    return {"k1": K.potq_matmul_cuda.launches, "k2": KG.grad_da_cuda.launches,
            "k3": KG.grad_dw_cuda.launches, "gq": KG.quantize_g_cuda.launches}


# 37e-f: the MoE decoders on the (1, 2) mesh through phases 26-27's engine
# (chunked 32 + paged 16, 4 slots) and trace, at this depth
MOE_EP_LAYERS = 2
MOE_ENGINE = dict(max_slots=4, max_len=160, prefill_chunk=32, page_size=16)
# 37g: both MoE smoke configs data-parallel at this global batch (two
# dispatch groups of 512 tokens, one a rank), these steps
MOE_DP_BATCH, MOE_DP_SEQ, MOE_DP_STEPS = 4, 256, 2
# 37h-i: internvl2-76b (``VLM_LAYERS`` layers) and whisper-large-v3
# (``ENCDEC_LAYERS`` decoder layers, the encoder whole) on the (1, 2) mesh
# through phases 29-30's engine (max_len 400 / 64) and traces; 37j:
# whisper on the (2, 1) mesh at this many decoder layers, against one rank
FAMILY_ENGINE = dict(max_slots=4, prefill_chunk=32, page_size=16)
ENCDEC_DP_LAYERS = 2
# 37k: both smoke configs data-parallel at this global batch, these steps;
# and whisper-large-v3 at its published widths, this encoder and decoder
# depth (all 32 + 32 fit, but two ranks' gloo gradient sums of the whole
# model through the host would take minutes), on phase 31b's batch (one
# row of 1500 frames and 448 tokens a rank), these steps
FAMILY_DP_BATCH, FAMILY_DP_SEQ, FAMILY_DP_STEPS = 4, 64, 3
WHISPER_DP_LAYERS, WHISPER_DP_STEPS = 4, 2
WHISPER_DP = f"{ENCDEC_ARCH} at published widths"
# 37l-m: the recurrent families on the (1, 2) and (2, 1) meshes through
# phases 32-33's engine (4 slots, slot rows, solo prefill) and
# ``RECURRENT`` prompts and max_len, each against one rank at this depth:
# mamba2-2.7b at 8 of its 64 layers (a prompt of 512: two SSD chunks of
# 256), recurrentgemma-2b at 6 of its 26 (two rglru, rglru, attn periods,
# so attention runs)
SSM_PLAN_LAYERS = 8
HYBRID_PLAN_LAYERS = 6
RECURRENT_PLAN_LAYERS = {"mamba2-2.7b": SSM_PLAN_LAYERS, "recurrentgemma-2b": HYBRID_PLAN_LAYERS}
# 37n: both recurrent smoke configs data-parallel as 37k; and mamba2-2.7b
# at its published widths and this depth (4 until phase 37r: 19.8 s of a
# slow host's 951.8 s for 37n), global batch, sequence and steps
SSM_DP_LAYERS, SSM_DP_BATCH, SSM_DP_SEQ, SSM_DP_STEPS = 2, 2, 512, 2
SSM_DP = "mamba2-2.7b at published widths"


# 37s: the serving options on a plan at llama3-8b's published widths,
# each against one rank in the same world, through phase 19's engine
# (chunked 32 + paged 16, 4 slots) and OPTION_TRACE (phase 24's with
# prompts of two chunks and 4-8 new tokens: at phase 24's own, 37s (a)
# took 47.1 s on rank 0 on an NVIDIA H100 80GB HBM3, 15.0 s of it the
# served run, whose 79 passes each wait on ~20 collectives through
# gloo): (a) the 3-bit
# self-draft over KV_PINNED pages on (1, 2) at SPEC_PLAN_LAYERS layers
# (and spec off on the plan; every draft step's tokens = one rank's), (b)
# the n-gram drafter over KV_PINNED pages on (2, 1) with one-token prompts
# (:func:`_repeat_requests`: on phase 24's random prompts no n-gram draft
# was accepted), (c) quantize_attention and (d) the FP32 baseline on
# (1, 2) at OPTION_LAYERS.  One rank's runs alternate between the ranks (rank 1
# runs (b)'s and (d)'s before its sharded run), so each overlaps the other
# rank's of the cell before.
SPEC_PLAN_LAYERS = 2
OPTION_LAYERS = 1
OPTION_ENGINE = dict(max_slots=4, max_len=160, prefill_chunk=32, page_size=16)
OPTION_TRACE = dict(n_requests=4, prompt_len=64, lam=2.0, new_lo=4, new_hi=8, seed=0)
OPTION_CELLS = {
    "sa": ("37s (a)", (1, 2), SPEC_PLAN_LAYERS, dict(spec="self", kv_quant=True, spec_off=True),
           0),
    "sb": ("37s (b)", (2, 1), SPEC_PLAN_LAYERS, dict(spec="ngram", kv_quant=True,
                                                     prompts="repeat"), 1),
    "sc": ("37s (c)", (1, 2), OPTION_LAYERS, dict(policy="qa"), 0),
    "sd": ("37s (d)", (1, 2), OPTION_LAYERS, dict(policy="fp32"), 1)}
# 37s (b)'s prompts: each one token repeated, the tokens drawn from this
# seed.  A random model at published widths does not copy: on an NVIDIA
# H100 80GB HBM3 (tools/ngram_accept_probe.py) no n-gram draft token was
# accepted on random prompts, on patterns of 2-16 tokens or on prompts
# that echo the model's own continuation, but on one-token prompts the
# model sometimes repeats a token of its own: at SPEC_PLAN_LAYERS layers
# this seed's prompts had 3 draft tokens accepted
REPEAT_SEED = 1
# 37s (d): the FP32 baseline's folds add the ranks' partial products in
# rank order, so its logits are one rank's within this share of the step's
# largest |logit| (tests/test_torch_parallel_serve_plan.py's bound)
FP32_LOGIT_RTOL = 1e-4


def _option_cells_rank(rank, dev):
    """37s's cells on one of the two ranks (:data:`OPTION_CELLS`), each
    with its seconds."""
    res = {}
    for key, (_, mesh, layers, opts, one) in OPTION_CELLS.items():
        t0 = time.perf_counter()
        res[key] = _sharded_serve(rank, dev, mesh, layers, one, "llama3-8b", OPTION_ENGINE,
                                  OPTION_TRACE, count_syncs=True, options=opts)
        res[key][1]["seconds"] = time.perf_counter() - t0
    return res


def _check_options(ranks, failures, card):
    """37s's gates on both ranks (:func:`_check_sharded`'s: tokens and
    every counter of :data:`OPTION_COUNTERS` equal one rank's, K1 once a
    linear shard a weight pass and a draft step, folds, no implicit host
    sync outside the collectives), and (a) spec on = spec off on the plan
    and every draft step's tokens on a rank = one rank's on its rows, (b)
    n-gram drafts accepted (the accept-and-roll-back path ran),
    (d) a fresh pool's decode step's logits within ``FP32_LOGIT_RTOL`` of
    one rank's and equal on both ranks.  Prints each cell's tokens/s,
    wall, a decode step's device ms and gloo bytes beside ``card``."""
    from repro_torch import configs

    llama = configs.get_config("llama3-8b")
    rows = {}
    for key, (label, mesh, layers, opts, one_rank) in OPTION_CELLS.items():
        _check_sharded(key, ranks, dataclasses.replace(llama, n_layers=layers), failures)
        both = [res[key][1] for res in ranks]
        one = both[one_rank]
        if opts.get("spec_off") and not all(r["spec_off_tokens_equal"] for r in both):
            failures.append(f"{label}: spec-on tokens differ from spec off on the plan")
        if opts.get("spec") == "ngram" and not one["counters"]["accepted_tokens"] > 0:
            failures.append(f"{label}: no n-gram draft accepted (the accept path did not run)")
        if opts.get("spec") == "self":
            steps = one["one_rank_draft_steps"]
            for rank, r in enumerate(both):
                lo, hi = r["draft_rows"]
                if not steps or r["draft_steps"] != [s[lo:hi] for s in steps]:
                    failures.append(f"{label}: rank {rank}'s {len(r['draft_steps'])} draft "
                                    f"steps differ from one rank's {len(steps)}")
        if opts.get("policy") == "fp32":
            if not one["one_rank_logits_max_rel"] <= FP32_LOGIT_RTOL:
                failures.append(f"{label}: decode logits {one['one_rank_logits_max_rel']:.3g} "
                                f"of the largest from one rank's (bound {FP32_LOGIT_RTOL})")
        if both[0]["logits_digest"] != both[1]["logits_digest"]:
            failures.append(f"{label}: the ranks' decode logits differ")
        rows[key] = dict(label=label, mesh=mesh, layers=layers, options=opts,
                         tokens_per_s=[r["tokens_per_s"] for r in both],
                         wall_s=[r["wall_s"] for r in both],
                         decode_step_device_ms=[r["decode_step_device_ms"] for r in both],
                         gloo_bytes=[r["collective_bytes"] for r in both],
                         counters=one["counters"], k1_launches=[r["k1_launches"] for r in both],
                         logits_max_rel=one.get("one_rank_logits_max_rel"),
                         logits_bit_equal=one.get("one_rank_logits_bit_equal"),
                         draft_steps=[len(r.get("draft_steps", ())) for r in both],
                         seconds=[r["seconds"] for r in both])
        print(f"{label} ({card}): llama3-8b, {layers} layer(s), mesh {mesh}, {opts}: tokens/s "
              f"{[round(x, 2) for x in rows[key]['tokens_per_s']]}, wall s "
              f"{[round(x, 3) for x in rows[key]['wall_s']]}, a decode step's device ms "
              f"{[round(x, 3) for x in rows[key]['decode_step_device_ms']]}, gloo MiB "
              f"{[round(x / 2 ** 20, 1) for x in rows[key]['gloo_bytes']]}, counters "
              f"{one['counters']}, K1 {rows[key]['k1_launches']}"
              + (f", draft steps {rows[key]['draft_steps']} (one rank's)"
                 if opts.get("spec") == "self" else "")
              + (f", logits {one['one_rank_logits_max_rel']:.3g} of the largest from one "
                 f"rank's (bit for bit: {one['one_rank_logits_bit_equal']})"
                 if opts.get("policy") == "fp32" else ""))
    return rows


def _repeat_requests(reqs, vocab):
    """``reqs`` with each prompt one token, drawn from
    :data:`REPEAT_SEED`, repeated to the prompt's length."""
    rng = np.random.default_rng(REPEAT_SEED)
    return [dataclasses.replace(r, tokens=np.full_like(r.tokens, rng.integers(0, vocab, 1)[0]))
            for r in reqs]


def _recording_drafts(eng):
    """A list that takes each self-draft step's tokens (this data rank's
    rows, on the device) as ``eng`` drafts them."""
    steps, draft = [], eng._draft

    def recording(*args):
        toks = draft(*args)
        steps.append(toks)
        return toks

    eng._draft = recording
    return steps


def _sharded_serve(rank, dev, mesh, n_layers, one_rank, arch="llama3-8b",
                   engine=None, trace=None, count_syncs=False, options=None):
    """One sharded engine over ``mesh`` (a (data, model) pair) at
    ``arch``'s widths and ``n_layers`` layers (None: all), seed 0: every
    leaf drawn whole from the phase's generator and quantized whole, each
    rank keeping its shard.  ``engine`` (PoolEngine keywords) and
    ``trace`` (poisson_trace keywords) default to phase 5's (4 slots,
    solo prefill; ``_serve_trace``).  ``one_rank`` (None, or a rank):
    that rank also serves the trace alone (no plan) and compares tokens
    and counters; rank 1 does so before the sharded run, so that it
    overlaps rank 0's one-rank run of the cell before.
    ``count_syncs``: the run goes under PyTorch's sync debug mode and the
    row lists the port's implicit host syncs outside the collectives
    (gloo stages a card's tensors through the host there).  ``options``
    (37s, :data:`OPTION_CELLS`): ``policy`` ('qa': quantize_attention,
    'fp32': the FP32 baseline, its weights drawn unquantized), ``spec``
    ('self' or 'ngram'), ``kv_quant`` (``KV_PINNED`` pages), ``spec_off``
    (the plan's engine also runs without spec), ``prompts`` ('repeat':
    :func:`_repeat_requests`); a row of
    them also carries the spec counters, and one pooled decode step's
    logits (their digest, and the largest difference from one rank's
    where that rank ran it).  Returns the served tokens and a row."""
    from repro_torch import configs
    from repro_torch.core.policy import FP32_BASELINE, KV_PINNED, PAPER_FAITHFUL
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.models import registry, spec
    from repro_torch.parallel import actshard, collectives, meshes, planner
    from repro_torch.serve import LowBitSelfDraft, NgramDrafter, PoolEngine, poisson_trace
    from repro_torch.serve import quantized_weights as qw

    opts = dict(options or {})
    cfg = configs.get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    engine = engine or dict(max_slots=4, max_len=160)
    kv_quant = KV_PINNED if opts.get("kv_quant") else None
    drafter = {None: None, "ngram": NgramDrafter(max_draft=3),
               "self": LowBitSelfDraft(max_draft=3, bits=DRAFT_BITS)}[opts.get("spec")]
    fp32 = opts.get("policy") == "fp32"
    policy = (FP32_BASELINE if fp32 else dataclasses.replace(
        PAPER_FAITHFUL, weights_prequantized=True,
        quantize_attention=opts.get("policy") == "qa"))
    counters = OPTION_COUNTERS if options else SERVE_COUNTERS
    plan = planner.plan_for(cfg, meshes.make_mesh(mesh, ("data", "model")),
                            configs.ShapeConfig("serve", engine["max_len"], 4, "decode"),
                            pool_slots=4, page_size=engine.get("page_size"), kv_quant=kv_quant)
    reqs = _serve_trace(cfg) if trace is None else poisson_trace(cfg, **trace)
    if opts.get("prompts") == "repeat":
        reqs = _repeat_requests(reqs, cfg.vocab)
    lcfg = plan.local_config()
    tok = torch.zeros(4, dtype=torch.int64, device=dev)

    def draw(shard):
        """The seed-0 weights, quantized whole (unquantized under the FP32
        baseline), this rank's shards with ``shard``."""
        def leaf(name, x):
            if fp32:
                return plan.shard_leaf(name, x) if shard else x
            return qw.quantize_leaf(name, x, PAPER_FAITHFUL, plan if shard else None)

        return spec.materialize(registry.param_specs(cfg),
                                torch.Generator(device=dev).manual_seed(0), transform=leaf)

    def serve_alone(row):
        """The same model on this rank alone (no plan), the same trace, and
        one pooled decode step of a fresh pool (37s)."""
        whole = draw(False)
        one = PoolEngine(cfg, policy, whole, device=dev, num_pages=plan.num_pages,
                         spec=drafter, kv_quant=kv_quant, **engine)
        drafts = _recording_drafts(one)
        row["one_rank_tokens"] = {str(u): t.tolist() for u, t in one.run(reqs).items()}
        if drafter is not None and drafter.needs_draft_pass:
            row["one_rank_draft_steps"] = [t.tolist() for t in drafts]
        row["one_rank_counters"] = {k: getattr(one.last_stats, k) for k in counters}
        if options:
            with torch.inference_mode():
                pool = registry.init_pool_cache(cfg, 4, engine["max_len"], device=dev)
                row["one_rank_logits"] = registry.decode_step(
                    cfg, one.policy, whole, tok, pool)[0].float().cpu()
        del whole, one
        torch.cuda.empty_cache()

    early = {}
    if rank == one_rank == 1:
        serve_alone(early)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = draw(True)
    torch.cuda.synchronize()
    weight_bytes = sum(x.numel() * x.element_size() for _, x in spec.named_leaves(params))
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = PoolEngine(cfg, policy, params, device=dev, plan=plan, num_pages=plan.num_pages,
                     spec=drafter, kv_quant=kv_quant, **engine)
    engine_s = time.perf_counter() - t0
    eng.run([dataclasses.replace(reqs[0], uid="warm-up", max_new_tokens=2)])
    drafts = _recording_drafts(eng)
    collectives.reset_stats()
    syncs = {} if count_syncs else None
    out, wall, _ = _timed_run(eng, reqs, syncs)
    st = eng.last_stats
    k1_pass = 0 if fp32 else k1_per_pass(cfg)
    row = dict(arch=arch, mesh=plan.mesh_shape(), layers=cfg.n_layers,
               backend=collectives.backend(), counters={k: getattr(st, k) for k in counters},
               wall_s=wall, tokens_per_s=st.emitted_tokens / wall,
               emitted_tokens=st.emitted_tokens, weight_passes=st.weight_passes,
               data_shards=st.data_shards, model_shards=st.model_shards,
               per_device_weight_passes=st.per_device_weight_passes,
               k1_launches=K.potq_matmul_cuda.launches,
               k1_per_pass_expected=k1_pass,
               k1_expected=(0 if fp32 else expected_k1(cfg, st)
                            + k1_pass * st.draft_weight_passes),
               prefills=st.prefills, heads_local=lcfg.n_heads,
               kv_heads_local=lcfg.kv_heads,
               folds=collectives.stats["folds"], collective_calls=collectives.stats["calls"],
               collective_bytes=collectives.stats["bytes"],
               collective_s=collectives.stats["seconds"], weight_bytes=weight_bytes,
               draw_quantize_shard_s=draw_s, engine_start_s=engine_s,
               overrides=sorted(f"{k}:{p}" for k, p in plan.overrides),
               experts=plan.layout().experts, options=opts)
    if drafter is not None and drafter.needs_draft_pass:
        row["draft_steps"], row["draft_rows"] = [t.tolist() for t in drafts], eng._local_rows()
    if count_syncs:
        row["implicit_syncs"] = {k: n for k, n in syncs.items() if k.startswith("src/")
                                 and not k.startswith("src/repro_torch/parallel/collectives")}
    tokens = {str(u): t.tolist() for u, t in out.items()}
    if opts.get("spec_off"):  # the plan's engine without speculation
        off = PoolEngine(cfg, policy, params, device=dev, plan=plan, num_pages=plan.num_pages,
                         kv_quant=kv_quant, **engine)
        row["spec_off_tokens_equal"] = {
            str(u): t.tolist() for u, t in off.run(reqs).items()} == tokens
        row["spec_off_weight_passes"] = off.last_stats.weight_passes
        del off
    # one pooled decode step of the model axis's ranks (4 slots), wall and device
    with torch.inference_mode(), actshard.use_plan(plan if mesh[1] > 1 else None):
        pool = registry.init_pool_cache(lcfg, 4, engine["max_len"], device=dev)
        walls = []
        for _ in range(3):
            collectives.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, pool = registry.decode_step(lcfg, eng.policy, eng.params, tok, pool)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        row["decode_step_wall_ms"] = [w * 1e3 for w in walls]
        row["decode_step_rows"] = "all 4 slots on each rank" if mesh[1] == 1 else "4 slots"
        row["decode_step_collective_share"] = collectives.stats["seconds"] / walls[-1]
        row["decode_step_collective_calls"] = collectives.stats["calls"]
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        if options:  # a fresh pool's first step, as one rank's
            pool = registry.init_pool_cache(lcfg, 4, engine["max_len"], device=dev)
        with torch.profiler.profile(activities=acts) as prof:
            logits, pool = registry.decode_step(lcfg, eng.policy, eng.params, tok, pool)
            torch.cuda.synchronize()
        if not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"rank {rank}: non-finite decode logits on mesh {mesh}")
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    row["decode_step_device_ms"] = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    row["decode_step_k1_ms"] = sum(e.time_range.elapsed_us() for e in kern
                                   if "potq_mm" in e.name) / 1e3
    row["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if options:
        host = logits.float().cpu()
        row["logits_digest"] = _sha256([_host_bytes(host)])[0]
    del eng, pool, params
    torch.cuda.empty_cache()
    if rank == one_rank == 0:
        serve_alone(early)
    if "one_rank_tokens" in early:
        row["one_rank_tokens_equal"] = early.pop("one_rank_tokens") == tokens
        if "one_rank_logits" in early:
            one = early.pop("one_rank_logits")
            row["one_rank_logits_max_rel"] = float((host - one).abs().max()
                                                   / one.abs().max())
            row["one_rank_logits_bit_equal"] = bool(torch.equal(host, one))
        row.update(early)
    return tokens, row


def _dp_train(rank, dev):
    """37c: olmo-1b at its published widths and ``DP_TRAIN_LAYERS`` layers,
    data-parallel over the (2, 1) mesh: the first step's per-token losses (this rank's rows) and
    ``DP_TRAIN_STEPS`` steps' losses, launches a step, peak memory."""
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.data import pipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import collectives, meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    train_cli.make_deterministic()
    cfg = dataclasses.replace(configs.get_config("olmo-1b"), n_layers=DP_TRAIN_LAYERS)
    shape = configs.ShapeConfig("dp", DP_TRAIN_SEQ, DP_TRAIN_BATCH, "train")
    plan = planner.plan_for(cfg, meshes.make_mesh((2, 1), ("data", "model")), shape)
    opt = adamw(warmup_cosine_schedule(3e-3, 20, DP_TRAIN_STEPS))
    step_fn = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig(), plan=plan)
    dp = step_fn.data_parallel
    torch.cuda.reset_peak_memory_stats()
    params = dp.shard(spec.materialize(registry.param_specs(cfg),
                                       torch.Generator(device=dev).manual_seed(0)))
    torch.cuda.empty_cache()
    state = opt.init(params)
    held = sum(x.numel() * x.element_size() for _, x in spec.named_leaves(params))
    batches = [pipeline.make_batch(cfg, shape, s, device=dev) for s in range(DP_TRAIN_STEPS)]
    token_losses = step_fn.token_losses(params, batches[0]).cpu().numpy()
    losses, launches, seconds, coll = [], [], [], []
    for s in range(DP_TRAIN_STEPS):
        before = _count_kernels()
        collectives.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batches[s], s)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        coll.append(collectives.stats["seconds"])
        launches.append({k: v - before[k] for k, v in _count_kernels().items()})
    row = dict(losses=losses, step_s=seconds, collective_s=coll, launches=launches,
               master_bytes=held, peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               backend=collectives.backend())
    del params, state, batches
    torch.cuda.empty_cache()
    return token_losses, row


def _tree_bytes(tree):
    from repro_torch.models import spec

    return sum(x.numel() * x.element_size() for _, x in spec.named_leaves(tree))


def _device_busy_ms(fn):
    """Device busy ms of this process's kernels during one call of ``fn``
    (torch.profiler, CUDA activity only)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, sum(e.time_range.elapsed_us() for e in kern) / 1e3


def tp_step_folds(cfg, model=2):
    """(forward folds, backward chains, owner selections) of one
    tensor-parallel training step a rank on ``model`` ranks, from the
    layout: each row-parallel fold (``wo``, ``co``, the down projection,
    a MoE layer's shared expert's, ``wo2``) twice, the forward and its
    recomputation; a chain for every column-parallel dA whose shard is
    whole 128-chunks (q, the split K/V and cross K/V heads, the MLP's or
    shared expert's input products, TP experts' gate and up, one chain
    over all the experts, the vocab-split head) and for the dgamma rows of
    every row-parallel product; under EP three selections a MoE layer
    (the combine, forward and recomputed, and the dispatch's backward)
    (olmo-1b at 4 layers 16 / 29 / 0, whisper at 4 + 4 layers 40 / 64 /
    0, llama4-scout at 1 layer 4 / 8 / 3, the smoke widths 0 / 0 and 3 a
    MoE layer under EP)."""
    from repro_torch.kernels.ref import CANONICAL_BK
    from repro_torch.parallel.planner import runtime_layout

    lay = runtime_layout(cfg, model)
    whole = lambda split, width: int(split and width % CANONICAL_BK == 0)  # noqa: E731
    head = whole(lay.vocab, cfg.vocab_padded // model)
    if cfg.family in ("ssm", "hybrid"):
        return _recurrent_tp_folds(cfg, lay, whole, head)
    inputs = 2 if cfg.act == "swiglu" else 1  # gate and up, or gate (wi)
    mlp = int(cfg.moe is None or cfg.moe.shared_expert)  # a dense MLP, or a shared expert
    q = whole(lay.heads, lay.heads_local * cfg.head_dim)
    kv = 2 * whole(lay.kv == "split", lay.kv_local * cfg.head_dim)
    ffn = inputs * whole(lay.ffn, lay.ffn_local) * mlp
    wo, down = int(lay.wo == "fold"), int(lay.mlp_wo == "fold") * mlp
    experts = inputs * whole(lay.experts == "TP", lay.ffn_local)
    selects = 3 * cfg.n_layers * int(lay.experts == "EP")
    if cfg.family == "encdec":  # an encoder layer, then a decoder layer with cross attention
        fwd = cfg.enc_layers * (wo + down) + cfg.n_layers * (2 * wo + down)
        bwd = (cfg.enc_layers * (q + kv + ffn + wo + down)
               + cfg.n_layers * (2 * (q + kv + wo) + ffn + down))
    else:
        fwd = cfg.n_layers * (wo + down)
        bwd = (cfg.n_layers * (q + kv + ffn + wo + down + experts)
               + whole(lay.vocab, cfg.vocab_padded // model))
    return 2 * fwd, bwd, selects


def _recurrent_tp_folds(cfg, lay, whole, head):
    """:func:`tp_step_folds` of an ssm (out_proj's fold and its dgamma
    rows a layer where it folds; in_proj always gathers) or a hybrid (an
    RG-LRU layer's wx, wy, wa and wi over its channels, an attention
    layer's q heads, each layer's gate and up column-parallel; wout, wo
    and the down projection row-parallel); no owner selections."""
    from repro_torch.models.recurrent import layer_kinds

    if cfg.family == "ssm":
        wo = int(lay.wo == "fold")
        return 2 * cfg.n_layers * wo, cfg.n_layers * wo + head, 0
    kinds = layer_kinds(cfg)
    attn = kinds.count("attn")
    lru = len(kinds) - attn
    mlp = 2 * whole(lay.ffn, lay.ffn_local) + int(lay.mlp_wo == "fold")
    lru_layer = 4 * whole(lay.lru, lay.lru_local) + int(lay.lru_wo == "fold")
    attn_layer = (whole(lay.heads, lay.heads_local * cfg.head_dim)
                  + 2 * whole(lay.kv == "split", lay.kv_local * cfg.head_dim)
                  + int(lay.wo == "fold"))
    fwd = lru * (int(lay.lru_wo == "fold") + int(lay.mlp_wo == "fold")) + attn * (
        int(lay.wo == "fold") + int(lay.mlp_wo == "fold"))
    return 2 * fwd, lru * (lru_layer + mlp) + attn * (attn_layer + mlp) + head, 0


def tp_step_gathers(cfg, model=2):
    """Column-parallel backwards of one tensor-parallel step a rank of an
    ssm or a hybrid that gather G and Wq whole instead of chaining K2
    (``collectives.stats['bwd_gathers']``): mamba2's in_proj a layer
    (index-set pieces, whatever the width), every other column-parallel
    product whose shard is not whole 128-chunks (the 160-row vocab shard
    of the smoke configs, their RG-LRU, MLP and q shards); None for the
    other families."""
    from repro_torch.kernels.ref import CANONICAL_BK
    from repro_torch.models.recurrent import layer_kinds
    from repro_torch.parallel.planner import runtime_layout

    lay = runtime_layout(cfg, model)
    part = lambda split, width: int(split and width % CANONICAL_BK != 0)  # noqa: E731
    head = part(lay.vocab, cfg.vocab_padded // model)
    if cfg.family == "ssm":
        return cfg.n_layers * int(lay.heads) + head
    if cfg.family != "hybrid":
        return None
    kinds = layer_kinds(cfg)
    attn = kinds.count("attn")
    mlp = 2 * part(lay.ffn, lay.ffn_local)
    return ((len(kinds) - attn) * (4 * part(lay.lru, lay.lru_local) + mlp)
            + attn * (part(lay.heads, lay.heads_local * cfg.head_dim)
                      + 2 * part(lay.kv == "split", lay.kv_local * cfg.head_dim) + mlp) + head)


def tp_step_launches(cfg, model=2):
    """K1/K2/K3/pre-pass launches of one tensor-parallel training step a
    rank on ``model`` ranks: ``step_launches``' (one rank's), but under EP
    a rank's experts' backward runs once per expert it holds (K1's expert
    batch is one launch over them, as over all)."""
    from repro_torch.parallel.planner import runtime_layout

    want = step_launches(cfg)
    lay = runtime_layout(cfg, model)
    if cfg.moe is None or lay.experts != "EP":
        return want
    fewer = (cfg.n_layers * (cfg.moe.num_experts - lay.experts_local)
             * (3 if cfg.act == "swiglu" else 2))
    return dict(want, **{k: want[k] - fewer for k in ("k2", "k3", "gq")})


def _tp_cells():
    """The tensor-parallel training cells of the (1, 2) runs, each
    (config, global batch, seq, steps): 37o (a) olmo-1b at
    ``TP_TRAIN_LAYERS`` layers, 37p (a) whisper-large-v3 at
    ``ENCDEC_TP_TRAIN_LAYERS`` encoder and decoder layers, 37p (b)
    internvl2-76b's smoke config, 37q (b) grok-1-314b's smoke config
    (EP) and the 3-expert grok-1 (TP experts) at smoke width and at
    ``GROK3_CHUNKED_FF``, 37r (c) mamba2-2.7b's and recurrentgemma-2b's
    smoke configs and their ``RECURRENT_WIDE`` widenings."""
    from repro_torch import configs

    olmo = dataclasses.replace(configs.get_config("olmo-1b"), n_layers=TP_TRAIN_LAYERS)
    whisper = dataclasses.replace(configs.get_config(ENCDEC_ARCH),
                                  n_layers=ENCDEC_TP_TRAIN_LAYERS,
                                  enc_layers=ENCDEC_TP_TRAIN_LAYERS)
    grok = configs.smoke_config("grok-1-314b")
    grok3 = dataclasses.replace(grok, moe=dataclasses.replace(grok.moe, num_experts=3))
    smoke = (TP_SMOKE_BATCH, TP_SMOKE_SEQ, TP_SMOKE_STEPS)
    cells = {"o": (olmo, TP_TRAIN_BATCH, TP_TRAIN_SEQ, TP_TRAIN_STEPS),
             "p": (whisper, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, TP_TRAIN_STEPS),
             "p_vlm": (configs.smoke_config(VLM_ARCH),) + smoke,
             "q_grok": (grok,) + smoke,
             "q_grok3": (grok3,) + smoke,
             "q_grok3_chunked": (dataclasses.replace(grok3, d_ff=GROK3_CHUNKED_FF),) + smoke}
    for arch, wide in RECURRENT_WIDE.items():  # 37r (c)
        key = "r_" + arch.split("-")[0]
        cells[key] = (configs.smoke_config(arch),) + smoke
        cells[key + "_wide"] = (dataclasses.replace(configs.smoke_config(arch), **wide),) + smoke
    return cells


def _tp_train(rank, dev, key="o"):
    """One of ``_tp_cells`` (37o (a), 37p (a) or (b), 37q (b)) tensor-parallel on the
    (1, 2) mesh (K2 chained across the two ranks where a shard is whole
    128-chunks), against one rank at that depth run here after it: the
    first step's per-token losses, every gradient leaf's shard against one
    rank's slice, both runs' losses; per step the launches, collectives
    (calls, bytes, seconds, forward folds, backward chains) and seconds;
    the first step's implicit host syncs outside the collectives, the
    last one's device busy ms (profiled), the masters' and optimizer
    state's bytes, the peak."""
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.data import pipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import collectives, meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    t_start = time.perf_counter()
    train_cli.make_deterministic()
    cfg, batch, seq, steps = _tp_cells()[key]
    shape = configs.ShapeConfig("tp", seq, batch, "train")
    plan = planner.plan_for(cfg, meshes.make_mesh((1, 2), ("data", "model")), shape)
    opt = adamw(warmup_cosine_schedule(3e-3, 20, steps))
    step_fn = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig(), plan=plan)
    sharded = step_fn.data_parallel
    batches = [pipeline.make_batch(cfg, shape, s, device=dev) for s in range(steps)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = sharded.shard(spec.materialize(registry.param_specs(cfg),
                                            torch.Generator(device=dev).manual_seed(0)))
    torch.cuda.empty_cache()
    state = opt.init(params)
    row = dict(master_bytes=_tree_bytes(params), optimizer_bytes=_tree_bytes(state),
               backend=collectives.backend(), kv=plan.layout().kv)
    token_losses = step_fn.token_losses(params, batches[0])
    _, grads = step_fn.grads(params, batches[0])
    losses, launches, seconds, colls, syncs = [], [], [], [], {}
    for s in range(steps):
        before = _count_kernels()
        collectives.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if s == 0:  # its implicit host syncs counted
            with _counting_syncs(syncs):
                params, state, m = step_fn(params, state, batches[s], s)
        elif s == steps - 1:  # the last one profiled
            (params, state, m), busy = _device_busy_ms(
                lambda: step_fn(params, state, batches[s], s))
            row["profiled_step_device_busy_ms"] = busy
        else:
            params, state, m = step_fn(params, state, batches[s], s)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        colls.append(dict(collectives.stats))
        launches.append({k: v - before[k] for k, v in _count_kernels().items()})
    row.update(losses=losses, step_s=seconds, collectives=colls, launches=launches,
               collective_share=[c["seconds"] / t for c, t in zip(colls, seconds)],
               implicit_syncs={k: n for k, n in syncs.items() if k.startswith("src/")
                               and not k.startswith("src/repro_torch/parallel/collectives")},
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    # where a step's time goes: the shadow alone (each matrix gathered
    # whole, quantized, its shard kept), then the forward with it (the
    # folds); the rest of a step is the backward (recomputation, chains)
    for part, fn in (("shadow", lambda: sharded.inputs(params, PAPER_FAITHFUL)),
                     ("shadow_and_forward", lambda: step_fn.token_losses(params, batches[0]))):
        collectives.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        row[f"{part}_s"] = time.perf_counter() - t0
        row[f"{part}_collectives"] = dict(collectives.stats)
    del params, state
    torch.cuda.empty_cache()
    # one rank at the same depth: every rank holds its own slices to it
    one_fn = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig())
    whole = spec.materialize(registry.param_specs(cfg), torch.Generator(device=dev).manual_seed(0))
    row["token_losses_bit_equal"] = bool(torch.equal(token_losses,
                                                     one_fn.token_losses(whole, batches[0])))
    _, g1 = one_fn.grads(whole, batches[0])
    differ = {}
    for (name, x), (_, y) in zip(spec.named_leaves(grads), spec.named_leaves(g1)):
        y = plan.shard_leaf(name, y)
        if not torch.equal(x, y):
            differ[name] = dict(max_abs=(x - y).abs().max().item(), max=y.abs().max().item())
    row["grad_leaves"] = len(list(spec.named_leaves(grads)))
    row["grad_leaves_differing"] = differ
    del grads, g1
    if rank == 0:
        state = opt.init(whole)
        one_losses = []
        for s in range(steps):
            whole, state, m = one_fn(whole, state, batches[s], s)
            one_losses.append(float(m["loss"]))
        row["one_rank_losses"] = one_losses
        del state
    del whole, batches
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t_start
    return row


def _tp_smoke_rank(rank):
    """37o (b), 37p (c) and 37q (c): the smoke configs of ``TP_SMOKE_ARCHS``
    (olmo-1b, internvl2-76b, whisper-large-v3, the MoE decoders at
    ``TP_SMOKE_SEQS``) tensor-parallel on the (2, 2)
    mesh, four ranks on the card: each one's first-step per-token losses
    (this rank's rows), ``TP_SMOKE_STEPS`` steps' losses and launches;
    rank 0 then runs one rank on the same batches (every row).  Before
    them rank 0 runs the one-rank runs of ``FIRST_STEP_CELLS``
    (:func:`_first_steps_one_rank`, ``first_steps``) while the other
    ranks wait: a process of its own would cost its start-up."""
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.data import pipeline
    from repro_torch.device import resolve_device
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    dev = resolve_device(torch.device("cuda", torch.cuda.current_device()))
    K.build()
    KG.build()
    train_cli.make_deterministic()
    out = {}
    if rank == 0:  # no collective runs in it; the other ranks wait at their first
        t0 = time.perf_counter()
        out["first_steps"] = _first_steps_one_rank(rank)
        out["first_steps_s"] = time.perf_counter() - t0
    for arch in TP_SMOKE_ARCHS:
        t0 = time.perf_counter()
        cfg = configs.smoke_config(arch)
        shape = configs.ShapeConfig("tp", TP_SMOKE_SEQS.get(arch, TP_SMOKE_SEQ), TP_SMOKE_BATCH,
                                    "train")
        plan = planner.plan_for(cfg, meshes.make_mesh((2, 2), ("data", "model")), shape)
        opt = adamw(warmup_cosine_schedule(3e-3, 20, TP_SMOKE_STEPS))
        batches = [pipeline.make_batch(cfg, shape, s, device=dev)
                   for s in range(TP_SMOKE_STEPS)]
        res = dict(coords=(plan.mesh.coord("data"), plan.mesh.coord("model")))
        for name, p in (("tp", plan), ("one", None)):
            step_fn = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig(), plan=p)
            params = spec.materialize(registry.param_specs(cfg),
                                      torch.Generator(device=dev).manual_seed(0))
            if p is not None:
                params = step_fn.data_parallel.shard(params)
            tl = step_fn.token_losses(params, batches[0]).cpu().numpy()
            state = opt.init(params)
            losses, launches = [], []
            for s in range(TP_SMOKE_STEPS):
                before = _count_kernels()
                params, state, m = step_fn(params, state, batches[s], s)
                losses.append(float(m["loss"]))
                launches.append({k: v - before[k] for k, v in _count_kernels().items()})
            res[name] = dict(token_losses=tl, losses=losses, launches=launches)
            if rank != 0:
                break  # one rank's run is rank 0's
        res["seconds"] = time.perf_counter() - t0
        out[arch] = res
    return out


#: the cells trained on (1, 2) at their published widths against one rank
#: (run on rank 0 of the four-rank world before its cells: 37q (a), 37r
#: (a), 37r (b)) and their labels
FIRST_STEP_CELLS = {"q": "37q (a)", "r_a": "37r (a)", "r_b": "37r (b)"}


def _first_step_cell(key, dev=None):
    """One of ``FIRST_STEP_CELLS``: its config at its published widths
    (37q (a): ``MOE_TP_ARCH`` at ``MOE_TP_TRAIN_LAYERS``, 37r (a):
    mamba2-2.7b at ``SSM_TP_TRAIN_LAYERS``, 37r (b): recurrentgemma-2b at
    ``HYBRID_TP_TRAIN_LAYERS``), its shape, its AdamW steps after the first
    step's gradients (0: those alone) and, on ``dev``, its batches."""
    from repro_torch import configs
    from repro_torch.data import pipeline

    arch, layers, batch, seq, steps = {
        "q": (MOE_TP_ARCH, MOE_TP_TRAIN_LAYERS, MOE_TP_TRAIN_BATCH, MOE_TP_TRAIN_SEQ, 0),
        "r_a": ("mamba2-2.7b", SSM_TP_TRAIN_LAYERS, SSM_TP_TRAIN_BATCH, SSM_TP_TRAIN_SEQ,
                SSM_TP_TRAIN_STEPS),
        "r_b": ("recurrentgemma-2b", HYBRID_TP_TRAIN_LAYERS, HYBRID_TP_TRAIN_BATCH,
                HYBRID_TP_TRAIN_SEQ, 0)}[key]
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
    shape = configs.ShapeConfig(f"tp_{key}", seq, batch, "train")
    batches = None if dev is None else [pipeline.make_batch(cfg, shape, s, device=dev)
                                        for s in range(max(steps, 1))]
    return cfg, shape, steps, batches


def _sha256(chunks):
    """sha256 hex digests of host byte arrays, hashed on threads (hashlib
    lets go of the GIL over large buffers)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda b: hashlib.sha256(b).hexdigest(), chunks))


def _host_bytes(x):
    return x.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy()


def _first_steps_one_rank(rank):
    """The one-rank runs of ``FIRST_STEP_CELLS``, one after the other on
    rank 0 of the four-rank world before its cells (no collective runs
    in them; the other ranks wait): the whole model from seed 0, the first step's
    per-token losses and gradients (remat), the sha256 of each model
    rank's shard of each gradient leaf on (1, 2) (``ShardingPlan.shard_slice``
    of every rank: an ssm's in_proj and conv by their index sets), then
    the cell's AdamW steps' losses; the gradients' seconds, each run's
    peak and seconds."""
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.device import resolve_device
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    dev = resolve_device("cuda")
    K.build()
    KG.build()
    train_cli.make_deterministic()
    out = {}
    for key in FIRST_STEP_CELLS:
        t0 = time.perf_counter()
        cfg, shape, steps, batches = _first_step_cell(key, dev)
        plan = planner.plan_for(cfg, meshes.make_abstract_mesh((1, 2), ("data", "model")),
                                shape)
        opt = adamw(warmup_cosine_schedule(3e-3, 20, max(steps, 1)))
        step_fn = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig())
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = spec.materialize(registry.param_specs(cfg),
                                  torch.Generator(device=dev).manual_seed(0))
        token_losses = step_fn.token_losses(params, batches[0]).cpu().numpy()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, grads = step_fn.grads(params, batches[0])
        torch.cuda.synchronize()
        grads_s = time.perf_counter() - t1
        names, parts = [], []
        for name, g in spec.named_leaves(grads):
            host = g.detach().cpu()
            names.append(name)
            cuts = [plan.shard_slice(name, r) for r in range(2)]
            parts += [host if c is None else plan.take(host, c) for c in cuts]
        del grads
        hashes = _sha256([_host_bytes(p) for p in parts])
        del parts
        losses = []
        if steps:
            state = opt.init(params)
            for s in range(steps):
                params, state, m = step_fn(params, state, batches[s], s)
                losses.append(float(m["loss"]))
            del state
        del params, batches
        out[key] = dict(token_losses=token_losses, losses=losses, grads_s=grads_s,
                        digests={n: hashes[2 * i:2 * i + 2] for i, n in enumerate(names)},
                        peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                        seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    return out


def _first_step_rank(rank, dev, key):
    """One of ``FIRST_STEP_CELLS`` on one of the two ranks of (1, 2): the
    parameters drawn leaf by leaf from seed 0, this rank's shard of each
    kept; the seconds and collectives of the shadow alone and of the shadow
    and the forward (the per-token losses' call); the first step's
    gradients (counted: launches, collectives, implicit host syncs, device
    busy) and the sha256 of each leaf; then the cell's AdamW steps, each
    counted."""
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import collectives, meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    t_start = time.perf_counter()
    train_cli.make_deterministic()
    cfg, shape, steps, batches = _first_step_cell(key, dev)
    plan = planner.plan_for(cfg, meshes.make_mesh((1, 2), ("data", "model")), shape)
    opt = adamw(warmup_cosine_schedule(3e-3, 20, max(steps, 1)))
    step_fn = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig(), plan=plan)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def keep(name, x):  # a split leaf's shard as a copy of its own: the whole is freed
        return x if plan.model_split_dim(name) is None else plan.shard_leaf(name, x).clone()

    t0 = time.perf_counter()
    params = spec.materialize(registry.param_specs(cfg),
                              torch.Generator(device=dev).manual_seed(0), transform=keep)
    torch.cuda.synchronize()
    lay = plan.layout()
    row = dict(draw_s=time.perf_counter() - t0, master_bytes=_tree_bytes(params),
               experts=lay.experts, layout=str(lay))
    # where the step's time goes: the shadow alone, the shadow and the
    # forward, then the whole step (its backward the difference)
    for part, fn in (("shadow", lambda: step_fn.data_parallel.inputs(params, PAPER_FAITHFUL)),
                     ("shadow_and_forward", lambda: step_fn.token_losses(params, batches[0]))):
        got = None  # the shadow alone is freed before the forward makes its own
        collectives.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            got = fn()
        torch.cuda.synchronize()
        row[f"{part}_s"] = time.perf_counter() - t0
        row[f"{part}_collectives"] = dict(collectives.stats)
    row["token_losses"] = got.cpu().numpy()
    del got
    syncs = {}
    before = _count_kernels()
    collectives.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _counting_syncs(syncs):
        (_, grads), busy = _device_busy_ms(lambda: step_fn.grads(params, batches[0]))
    torch.cuda.synchronize()
    row.update(grads_s=time.perf_counter() - t0, device_busy_ms=busy,
               collectives=dict(collectives.stats),
               launches={k: v - before[k] for k, v in _count_kernels().items()},
               implicit_syncs={k: n for k, n in syncs.items() if k.startswith("src/")
                               and not k.startswith("src/repro_torch/parallel/collectives")})
    row["collective_share"] = row["collectives"]["seconds"] / row["grads_s"]
    names, chunks = [], []
    for name, g in spec.named_leaves(grads):
        names.append(name)
        chunks.append(_host_bytes(g))
    del grads
    row["digests"] = dict(zip(names, _sha256(chunks)))
    del chunks
    losses, step_s, colls, launches = [], [], [], []
    if steps:
        state = opt.init(params)
        row["optimizer_bytes"] = _tree_bytes(state)
        for s in range(steps):
            before = _count_kernels()
            collectives.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, batches[s], s)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            colls.append(dict(collectives.stats))
            launches.append({k: v - before[k] for k, v in _count_kernels().items()})
        del state
    row.update(losses=losses, step_s=step_s, step_collectives=colls, step_launches=launches,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    del params, batches
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t_start
    return row


def _check_first_steps(one, ranks, failures):
    """The gates of ``FIRST_STEP_CELLS`` (``one``: the one-rank runs,
    ``ranks``: each rank's results): each rank's first-step per-token
    losses and every gradient leaf's shard (its sha256) one rank's, the
    launches of the gradients and of each step ``tp_step_launches``', the
    folds, chains and owner selections ``tp_step_folds``', an ssm's or
    hybrid's gathers ``tp_step_gathers``', no implicit host sync outside
    the collectives, 37q (a)'s experts under EP; the ranks' step losses
    equal and within ``LOSS_RTOL`` of one rank's.  Returns a row a cell."""
    out = {}
    for key, label in FIRST_STEP_CELLS.items():
        cfg = _first_step_cell(key)[0]
        want, want_folds = tp_step_launches(cfg), tp_step_folds(cfg)
        want_gathers = tp_step_gathers(cfg)
        rows = [res[key] for res in ranks]
        ref = one[key]
        for r, row in enumerate(rows):
            differ = sorted(n for n, h in row["digests"].items() if h != ref["digests"][n][r])
            print(f"{label} rank {r}:", json.dumps(
                {k: v for k, v in row.items() if k not in ("token_losses", "digests")}))
            if cfg.moe is not None and row["experts"] != "EP":
                failures.append(f"{label} rank {r}: experts {row['experts']}, expected EP")
            if row["token_losses"].view(np.uint32).tolist() != \
                    ref["token_losses"].view(np.uint32).tolist():
                failures.append(f"{label} rank {r}: first-step per-token losses differ from "
                                "one rank's")
            if differ or set(row["digests"]) != set(ref["digests"]):
                failures.append(f"{label} rank {r}: gradient shards differ from one rank's: "
                                f"{differ}")
            for got in [row["launches"]] + row["step_launches"]:
                if got != want:
                    failures.append(f"{label} rank {r}: launches {got}, expected {want}")
            for c in [row["collectives"]] + row["step_collectives"]:
                folds = (c["folds"], c["bwd_folds"], c["selects"])
                if folds != want_folds or (want_gathers is not None
                                           and c["bwd_gathers"] != want_gathers):
                    failures.append(f"{label} rank {r}: (forward folds, backward chains, "
                                    f"selections) {folds}, gathers {c['bwd_gathers']}, "
                                    f"expected {want_folds}, {want_gathers}")
            if row["implicit_syncs"]:
                failures.append(f"{label} rank {r}: implicit host syncs {row['implicit_syncs']}")
            if row["losses"] != rows[0]["losses"]:
                failures.append(f"{label}: the ranks' losses differ")
        rel = max([abs(a - b) / abs(b) for a, b in zip(rows[0]["losses"], ref["losses"])],
                  default=0.0)
        if not rel <= LOSS_RTOL:
            failures.append(f"{label}: losses differ from one rank's by {rel:.3g} relative")
        loss = float(np.mean(ref["token_losses"]))
        c = rows[0]["collectives"]
        print(f"{label} {cfg.name} at {cfg.n_layers} layer(s), published widths, (1, 2): one "
              f"rank's mean token loss {loss!r}, losses {[repr(x) for x in ref['losses']]}, "
              f"its grads {ref['grads_s']:.2f} s, peak {ref['peak_gib']:.2f} GiB, "
              f"{ref['seconds']:.1f} s in all; tensor-parallel losses "
              f"{[repr(x) for x in rows[0]['losses']]} (max relative {rel:.3g}); a rank's "
              f"shadow {[round(row['shadow_s'], 2) for row in rows]} s, shadow and forward "
              f"{[round(row['shadow_and_forward_s'], 2) for row in rows]} s, "
              f"{rows[0]['shadow_and_forward_collectives']['bytes'] / 2 ** 20:.1f} MiB; its "
              f"first step's gradients {[round(row['grads_s'], 2) for row in rows]} s "
              f"(profiled), collectives {c['calls']} calls, {c['bytes'] / 2 ** 20:.1f} MiB, "
              f"share {[round(row['collective_share'], 3) for row in rows]}; device busy a rank "
              f"{[round(row['device_busy_ms'], 1) for row in rows]} ms; steps a rank "
              f"{[[round(t, 2) for t in row['step_s']] for row in rows]} s; peak a rank "
              f"{[round(row['peak_gib'], 2) for row in rows]} GiB; {rows[0]['seconds']:.1f} s "
              "on rank 0")
        out[key] = dict(one_rank={k: v for k, v in ref.items()
                                  if k not in ("token_losses", "digests")},
                        ranks=[{k: v for k, v in row.items()
                                if k not in ("token_losses", "digests")} for row in rows],
                        token_loss_mean=loss, leaves=len(ref["digests"]), max_rel=rel)
    return out


def _check_tp_run(key, label, rows, failures):
    """The gates of a (1, 2) run of ``_tp_cells()[key]`` on both ranks
    (``rows``, each rank's :func:`_tp_train` row): first-step per-token
    losses and every gradient leaf's shard one rank's bit for bit, the
    launches a step ``tp_step_launches``', the folds, chains and owner
    selections a step ``tp_step_folds``', no implicit host sync outside
    the collectives, the ranks' losses equal and within ``LOSS_RTOL`` of
    one rank's."""
    cfg = _tp_cells()[key][0]
    want, want_folds = tp_step_launches(cfg), tp_step_folds(cfg)
    want_gathers = tp_step_gathers(cfg)
    one = rows[0]["one_rank_losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(rows[0]["losses"], one))
    for r, row in enumerate(rows):
        print(f"{label} (1, 2) rank {r}:", json.dumps(row))
        if not row["token_losses_bit_equal"]:
            failures.append(f"{label} rank {r}: first-step per-token losses differ from one "
                            "rank's")
        if row["grad_leaves_differing"]:
            failures.append(f"{label} rank {r}: gradient leaves differ from one rank's slices: "
                            f"{row['grad_leaves_differing']}")
        if any(n != want for n in row["launches"]):
            failures.append(f"{label} rank {r}: launches {row['launches']}, expected {want}")
        folds = [(c["folds"], c["bwd_folds"], c["selects"]) for c in row["collectives"]]
        if any(f != want_folds for f in folds):
            failures.append(f"{label} rank {r}: (forward folds, backward chains, selections) "
                            f"a step {folds}, expected {want_folds}")
        gathers = [c["bwd_gathers"] for c in row["collectives"]]
        if want_gathers is not None and any(n != want_gathers for n in gathers):
            failures.append(f"{label} rank {r}: backward gathers a step {gathers}, expected "
                            f"{want_gathers}")
        if row["implicit_syncs"]:
            failures.append(f"{label} rank {r}: implicit host syncs {row['implicit_syncs']}")
        if row["losses"] != rows[0]["losses"]:
            failures.append(f"{label}: the ranks' losses differ")
    if not rel <= LOSS_RTOL:
        failures.append(f"{label}: losses differ from one rank's by {rel:.3g} relative")
    print(f"{label} (1, 2) {cfg.name}: one rank losses {[repr(x) for x in one]}; "
          f"tensor-parallel {[repr(x) for x in rows[0]['losses']]}; max relative {rel:.3g}; "
          f"step s a rank {[[round(t, 3) for t in row['step_s']] for row in rows]}; "
          f"collectives a step {[c['calls'] for c in rows[0]['collectives']]} calls, "
          f"{[round(c['bytes'] / 2 ** 20, 1) for c in rows[0]['collectives']]} MiB, share "
          f"{[round(x, 3) for x in rows[0]['collective_share']]}; device busy a step a rank "
          f"{[round(row['profiled_step_device_busy_ms'], 1) for row in rows]} ms; master / "
          f"optimizer bytes a rank "
          f"{[(row['master_bytes'], row['optimizer_bytes']) for row in rows]}; "
          f"{rows[0]['seconds']:.1f} s on rank 0")
    return dict(ranks=rows, max_rel=rel)


def _check_tp_smoke(arch, label, ranks4, failures):
    """The gates of ``arch``'s (2, 2) smoke run (``_tp_smoke_rank``): the
    first-step per-token losses of the data ranks' rows (model rank 0 of
    each) one rank's bit for bit, every rank's equal to its data group's,
    the ranks' losses equal and within ``LOSS_RTOL`` of one rank's, the
    launches a step one rank's (under EP less the experts a rank does not
    hold, ``tp_step_launches``)."""
    from repro_torch import configs

    runs = [res[arch] for res in ranks4]
    one = runs[0]["one"]
    cfg = configs.smoke_config(arch)
    fewer = {k: n - tp_step_launches(cfg)[k] for k, n in step_launches(cfg).items()}
    want = [{k: n - fewer[k] for k, n in s.items()} for s in one["launches"]]
    by_data = {}
    for r, res in enumerate(runs):
        d, _ = res["coords"]
        tl = res["tp"]["token_losses"]
        if d in by_data and tl.view(np.uint32).tolist() != by_data[d].view(np.uint32).tolist():
            failures.append(f"{label} (2, 2) rank {r}: per-token losses differ from its data "
                            "group's")
        by_data.setdefault(d, tl)
        if res["tp"]["launches"] != want:
            failures.append(f"{label} (2, 2) rank {r}: launches {res['tp']['launches']}, "
                            f"expected {want} (one rank {one['launches']})")
        if res["tp"]["losses"] != runs[0]["tp"]["losses"]:
            failures.append(f"{label} (2, 2): the ranks' losses differ")
    tl = np.concatenate([by_data[d] for d in sorted(by_data)])
    tl_equal = tl.view(np.uint32).tolist() == one["token_losses"].view(np.uint32).tolist()
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs[0]["tp"]["losses"], one["losses"]))
    print(f"{label} (2, 2) {arch} smoke: one rank losses {[repr(x) for x in one['losses']]}; "
          f"tensor-parallel {[repr(x) for x in runs[0]['tp']['losses']]}; max relative "
          f"{rel:.3g}; first-step per-token losses bit for bit: {tl_equal}; launches a step "
          f"{runs[0]['tp']['launches']} / one rank {one['launches']}; seconds a rank "
          f"{[round(res['seconds'], 1) for res in runs]}")
    if not tl_equal:
        failures.append(f"{label} (2, 2): first-step per-token losses differ from one rank's")
    if not rel <= LOSS_RTOL:
        failures.append(f"{label} (2, 2): losses differ from one rank's by {rel:.3g} relative")
    return dict(launches=runs[0]["tp"]["launches"], one_rank_launches=one["launches"],
                losses=runs[0]["tp"]["losses"], one_rank_losses=one["losses"], max_rel=rel,
                token_losses_bit_equal=tl_equal, seconds=[res["seconds"] for res in runs])


def _dp_cells(key):
    """The data-parallel training cells of 37g (``key`` 'g'), 37k or 37n:
    (label, config, global batch, seq, steps) each."""
    from repro_torch import configs

    if key == "g":
        return [(a, configs.smoke_config(a), MOE_DP_BATCH, MOE_DP_SEQ, MOE_DP_STEPS)
                for a in MOE_ARCHS]
    if key == "n":
        full = dataclasses.replace(configs.get_config("mamba2-2.7b"), n_layers=SSM_DP_LAYERS)
        return [(a, configs.smoke_config(a), FAMILY_DP_BATCH, FAMILY_DP_SEQ, FAMILY_DP_STEPS)
                for a in RECURRENT] + [(SSM_DP, full, SSM_DP_BATCH, SSM_DP_SEQ, SSM_DP_STEPS)]
    full = dataclasses.replace(configs.get_config(ENCDEC_ARCH), n_layers=WHISPER_DP_LAYERS,
                               enc_layers=WHISPER_DP_LAYERS)
    return [(a, configs.smoke_config(a), FAMILY_DP_BATCH, FAMILY_DP_SEQ, FAMILY_DP_STEPS)
            for a in (VLM_ARCH, ENCDEC_ARCH)] + [
        (WHISPER_DP, full, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_DP_STEPS)]


def _dp_cells_train(rank, dev, key):
    """37g, 37k and 37n: each of ``_dp_cells(key)`` data-parallel over the
    (2, 1) mesh against one rank (rank 0 runs it too, after its own run):
    the first step's per-token losses (this rank's rows; one rank's, every
    row), both runs' losses and launches a step, the data-parallel run's
    peak."""
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.data import pipeline
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import collectives, meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    out = {}
    for label, cfg, batch, seq, steps in _dp_cells(key):
        shape = configs.ShapeConfig("dp", seq, batch, "train")
        plan = planner.plan_for(cfg, meshes.make_mesh((2, 1), ("data", "model")), shape)
        opt = adamw(warmup_cosine_schedule(3e-3, 20, steps))
        batches = [pipeline.make_batch(cfg, shape, s, device=dev) for s in range(steps)]
        res = {}
        for name, p in (("dp", plan), ("one", None)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step_fn = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig(), plan=p)
            params = spec.materialize(registry.param_specs(cfg),
                                      torch.Generator(device=dev).manual_seed(0))
            if p is not None:
                params = step_fn.data_parallel.shard(params)
            # data-parallel: this rank's rows; one rank: every row
            res[f"{name}_token_losses"] = step_fn.token_losses(params, batches[0]).cpu().numpy()
            state = opt.init(params)
            losses, launches, seconds = [], [], []
            for s in range(steps):
                before = _count_kernels()
                collectives.reset_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = step_fn(params, state, batches[s], s)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                launches.append({k: v - before[k] for k, v in _count_kernels().items()})
            res[name] = dict(losses=losses, launches=launches, step_s=seconds,
                             collective_calls=collectives.stats["calls"],
                             peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            del params, state
            if rank != 0:
                break  # one rank's run is rank 0's
        out[label] = res
        del batches
    torch.cuda.empty_cache()
    return out


def _psum_check(rank, dev):
    """37d: ``compressed_psum`` on CUDA tensors over the two ranks: the
    sum equals the ranks' own decoded values summed, and the mean of
    ``PSUM_DRAWS`` sums lies within ``PSUM_Z`` standard errors of the
    exact sum (elements on the grid's range)."""
    from repro_torch.core import compress, potq
    from repro_torch.parallel import collectives

    group = collectives.axis_group((2, 1), 0)
    gens = [torch.Generator(device=dev).manual_seed(50 + r) for r in range(2)]
    gs = [torch.randn((1 << 20,), generator=g, device=dev) * 1e-3 for g in gens]
    g = gs[rank]
    amax = torch.stack([x.abs().max() for x in gs]).max()
    beta = potq.compute_beta(amax, 5, conservative=True)
    out = compress.compressed_psum(g, torch.Generator(device=dev).manual_seed(rank), group)
    own = [potq.pot_quantize(x, 5, beta, stochastic=True,
                             generator=torch.Generator(device=dev).manual_seed(r))
           for r, x in enumerate(gs)]
    equal = bool(torch.equal(out, own[0] + own[1]))
    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    small = g[:4096]
    mean = torch.stack([compress.compressed_psum(small, gen, group)
                        for _ in range(PSUM_DRAWS)]).mean(0)
    want = gs[0][:4096] + gs[1][:4096]
    scale = potq.exp2i(potq.compute_beta(torch.stack([x[:4096].abs().max() for x in gs]).max(),
                                         5, conservative=True))
    var, inside = 0.0, None
    for x in (gs[0][:4096], gs[1][:4096]):
        mag = (x / scale).abs()
        ok = mag >= potq.exp2i(torch.tensor(-potq.pot_emax(5), device=dev))
        lo = torch.where(ok, potq.exp2i(torch.frexp(mag)[1] - 1), torch.ones_like(mag))
        var = var + torch.where(ok, ((2 * lo - mag) * (mag - lo)).clamp(min=0) * scale ** 2,
                                torch.zeros_like(mag))
        inside = ok if inside is None else inside & ok
    z = ((mean - want).abs() / (torch.sqrt(var / PSUM_DRAWS) + 1e-30))[inside]
    return dict(sum_equals_decoded=equal, max_z=float(z.max()), elements=int(inside.sum()),
                unbiased=bool(float(z.max()) <= PSUM_Z),
                wire_bytes=compress.wire_bytes(g), f32_bytes=g.numel() * 4)


def _phase37_rank(rank):
    """Everything phase 37 runs on one of the two ranks."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import potq_encode as KE
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K

    dev = resolve_device(torch.device("cuda", torch.cuda.current_device()))
    K.build()
    KG.build()
    KE.build()
    res = {}
    # (key, mesh, layers, against one rank, arch, engine, trace)
    # (key, mesh, layers, the rank that serves one rank's engine, arch,
    # engine, trace); rank 1's one-rank runs come first in their cells, so
    # each overlaps rank 0's of the cell before (a and b, f and j, l and m)
    serves = (("a", (1, 2), TP_SERVE_LAYERS, 0, "llama3-8b", None, None),
              ("b", (2, 1), DP_SERVE_LAYERS, 1, "llama3-8b", None, None),
              ("e", (1, 2), MOE_EP_LAYERS, None, "grok-1-314b", MOE_ENGINE, DENSE_TRACE),
              ("f", (1, 2), MOE_EP_LAYERS, 0, "llama4-scout-17b-a16e", MOE_ENGINE,
               DENSE_TRACE),
              ("j", (2, 1), ENCDEC_DP_LAYERS, 1, ENCDEC_ARCH,
               dict(FAMILY_ENGINE, max_len=64), ENCDEC_TRACE),
              ("h", (1, 2), VLM_LAYERS, None, VLM_ARCH, dict(FAMILY_ENGINE, max_len=400),
               DENSE_TRACE),
              ("i", (1, 2), ENCDEC_LAYERS, None, ENCDEC_ARCH,
               dict(FAMILY_ENGINE, max_len=64), ENCDEC_TRACE))
    # 37l-m: (1, 2) against one rank, then (2, 1) (held to that one rank)
    for arch, one in (("mamba2-2.7b", 0), ("recurrentgemma-2b", 1)):
        engine = dict(max_slots=4, max_len=RECURRENT[arch]["max_len"])
        trace = dict(RECURRENT_TRACE, prompt_len=RECURRENT[arch]["prompt"])
        serves += (("l" if one == 0 else "m", (1, 2), RECURRENT_PLAN_LAYERS[arch], one, arch,
                    engine, trace),)
    for arch in RECURRENT:
        engine = dict(max_slots=4, max_len=RECURRENT[arch]["max_len"])
        trace = dict(RECURRENT_TRACE, prompt_len=RECURRENT[arch]["prompt"])
        serves += (("l2" if arch == "mamba2-2.7b" else "m2", (2, 1), RECURRENT_PLAN_LAYERS[arch],
                    None, arch, engine, trace),)
    for key, mesh, layers, one, arch, engine, trace in serves:
        t0 = time.perf_counter()
        res[key] = _sharded_serve(rank, dev, mesh, layers, one, arch, engine, trace,
                                  count_syncs=key[0] in "lm")
        res[key][1]["seconds"] = time.perf_counter() - t0
    res.update(_option_cells_rank(rank, dev))  # 37s
    t0 = time.perf_counter()
    res["c"] = _dp_train(rank, dev)
    res["c"][1]["seconds"] = time.perf_counter() - t0
    for key in _tp_cells():  # 37o (a), 37p (a) and (b)
        res[key] = _tp_train(rank, dev, key)
    t0 = time.perf_counter()
    res["g"] = _dp_cells_train(rank, dev, "g")
    res["g"]["seconds"] = time.perf_counter() - t0
    for key in "kn":
        t0 = time.perf_counter()
        res[key] = _dp_cells_train(rank, dev, key)
        res[key]["seconds"] = time.perf_counter() - t0
    res["d"] = _psum_check(rank, dev)
    for key in FIRST_STEP_CELLS:  # 37q (a), 37r (a-b)
        res[key] = _first_step_rank(rank, dev, key)
    return res


def _served_folds(cfg, row):
    """Row-parallel folds of a (1, 2) engine run at published widths: a
    decoder's ``wo`` and down projection (a MoE layer's shared expert's;
    its experts do not fold) a layer a weight pass, an ssm's ``out_proj``,
    a hybrid's ``wout`` or ``wo`` and its down projection; an encdec decode or
    chunk pass its decoder layers' ``wo``, ``co`` and ``wo2``, an
    encoder-side pass (one an admission) its encoder layers' ``wo`` and
    ``wo2``."""
    if cfg.family == "encdec":
        return (3 * cfg.n_layers * (row["weight_passes"] - row["prefills"])
                + 2 * cfg.enc_layers * row["prefills"])
    # an ssm layer's out_proj; a hybrid layer's wout or wo and its MLP's down
    # projection; a decoder layer's wo and down projection (the shared
    # expert's); a self-draft step folds as a weight pass does (37s)
    per_layer = 2 if cfg.family != "ssm" and (cfg.moe is None or cfg.moe.shared_expert) else 1
    return per_layer * cfg.n_layers * (row["weight_passes"]
                                       + row["counters"].get("draft_weight_passes", 0))


def _check_sharded(key, ranks, cfg, failures, tokens=None, counters=None):
    """The gates of a sharded serving sub-phase on both ranks: K1 once a
    linear shard a weight pass (``expected_k1``; over a data axis every
    rank runs each pooled step over its slots, and only a slot's owner its
    admission's pass: the ranks' sum), the folds (model axis), no implicit
    host sync where the row counted them, the ranks' tokens equal, and
    equal to ``tokens`` (and the counters to ``counters``, given) or to
    rank 0's one-rank run (tokens and counters)."""
    rows = [res[key][1] for res in ranks]
    # a draft step (37s) runs on every rank over its slots, as a pooled step
    steps = rows[0]["k1_per_pass_expected"] * (
        rows[0]["counters"]["decode_steps"] + rows[0]["counters"].get("draft_weight_passes", 0))
    admissions = rows[0]["k1_expected"] - steps
    if rows[0]["data_shards"] > 1 and sum(row["k1_launches"] for row in rows) != (
            rows[0]["data_shards"] * steps + admissions):
        failures.append(f"37{key}: K1 launched {[row['k1_launches'] for row in rows]}, "
                        f"expected {steps} a rank and {admissions} over the ranks")
    for r, res in enumerate(ranks):
        toks, row = res[key]
        print(f"37{key} rank {r}:", json.dumps(row))
        if row["data_shards"] == 1 and row["k1_launches"] != row["k1_expected"]:
            failures.append(f"37{key} rank {r}: K1 launched {row['k1_launches']}, expected "
                            f"{row['k1_expected']} ({row['k1_per_pass_expected']} a pass)")
        if row["model_shards"] > 1:
            want = _served_folds(cfg, row)
            if row["folds"] != want:
                failures.append(f"37{key} rank {r}: {row['folds']} row-parallel folds, "
                                f"expected {want}")
        if row.get("implicit_syncs"):
            failures.append(f"37{key} rank {r}: implicit host syncs {row['implicit_syncs']}")
    if ranks[0][key][0] != ranks[1][key][0]:
        failures.append(f"37{key}: the ranks' tokens differ")
    if tokens is not None:
        if ranks[0][key][0] != tokens:
            failures.append(f"37{key}: tokens differ from the one-card phase's")
        if counters is not None and ranks[0][key][1]["counters"] != counters:
            failures.append(f"37{key}: counters {ranks[0][key][1]['counters']} differ from "
                            f"one rank's {counters}")
        return
    row = next(r for r in rows if "one_rank_tokens_equal" in r)  # the rank that ran it
    if not row["one_rank_tokens_equal"] or row["one_rank_counters"] != row["counters"]:
        failures.append(f"37{key}: tokens or counters differ from one rank's "
                        f"({row['counters']} / {row['one_rank_counters']})")


def _check_dp_cells(key, ranks, failures, launches=False):
    """37g / 37k: data-parallel training against one rank (rank 0's own
    run): first-step per-token losses bit for bit, losses within
    LOSS_RTOL, launches a step equal on both ranks and one rank's (and,
    with ``launches``, ``step_launches``').  Returns a row a cell."""
    rows = {}
    for label, cfg, *_ in _dp_cells(key):
        one = ranks[0][key][label]["one"]
        dp_tl = np.concatenate([res[key][label]["dp_token_losses"] for res in ranks])
        one_tl = ranks[0][key][label]["one_token_losses"]
        tl_equal = dp_tl.view(np.uint32).tolist() == one_tl.view(np.uint32).tolist()
        dp = [res[key][label]["dp"] for res in ranks]
        rel = max(abs(a - b) / abs(b) for a, b in zip(dp[0]["losses"], one["losses"]))
        print(f"37{key} {label}: one rank losses {[repr(x) for x in one['losses']]}; "
              f"data-parallel {[repr(x) for x in dp[0]['losses']]}; max relative {rel:.3g}; "
              f"first-step per-token losses bit for bit: {tl_equal}; launches a step "
              f"{dp[0]['launches']} / one rank {one['launches']}; step s "
              f"{[round(x, 3) for x in dp[0]['step_s']]} / {[round(x, 3) for x in one['step_s']]}"
              f"; peak GiB a rank {[round(d['peak_gib'], 2) for d in dp]} / one rank "
              f"{one['peak_gib']:.2f}")
        if not tl_equal:
            failures.append(f"37{key} {label}: first-step per-token losses differ from one "
                            "rank's")
        if not rel <= LOSS_RTOL:
            failures.append(f"37{key} {label}: losses differ by {rel:.3g} relative")
        if any(d["launches"] != one["launches"] for d in dp) or dp[0]["losses"] != dp[1]["losses"]:
            failures.append(f"37{key} {label}: launches or losses differ between the ranks and "
                            "one rank")
        want = step_launches(cfg)
        if launches and any(n != want for n in dp[0]["launches"]):
            failures.append(f"37{key} {label}: launches {dp[0]['launches']}, expected {want}")
        rows[label] = dict(dp=dp, one=one, max_rel=rel, token_losses_bit_equal=tl_equal,
                           peak_gib=sum(d["peak_gib"] for d in dp))
    return rows


def multi_gpu(dev, detail):
    """Phase 37: two gloo ranks on the one card (``collectives.spawn``),
    the parent holding no model meanwhile.  37a: llama3-8b at its
    published widths and ``TP_SERVE_LAYERS`` layers on the (1, 2) mesh,
    phase 5's engine and trace, against one rank at that depth: tokens
    and counters equal, K1 once a linear shard a weight pass on each
    rank, the row-parallel folds counted.  37b: the (2, 1) mesh at
    ``DP_SERVE_LAYERS`` layers against one rank at that depth.  37c: olmo-1b at
    ``DP_TRAIN_LAYERS`` layers data-parallel, global batch 4 x 512, 2
    steps, against one rank here after the ranks
    exit: first-step per-token losses bit for bit, losses within
    LOSS_RTOL, launches a step.  37d: ``compressed_psum`` on the card.
    37e: grok-1 at its published widths and ``MOE_EP_LAYERS`` layers on
    the (1, 2) mesh with EP (4 experts a rank), phase 27's seed, engine
    and trace: tokens = phase 27's, K1 15 a weight pass a rank, 2 folds a
    pass.  37f: llama4-scout the same way (8 experts a rank, the shared
    expert folded) against one rank at that depth in the same world:
    tokens and counters equal.  37g: both MoE smoke configs
    data-parallel on (2, 1) against one rank: first-step per-token
    losses bit for bit, losses within LOSS_RTOL, K1/K2/K3/pre-pass
    launches a step equal.  37h: internvl2-76b at its published widths
    and ``VLM_LAYERS`` layers on (1, 2), phase 29's engine and trace:
    tokens = phase 29's, K1 57 a weight pass a rank and one patch_proj
    a solo prefill, 16 folds a pass.  37i: whisper-large-v3 at
    ``ENCDEC_LAYERS`` decoder layers and the whole encoder on (1, 2),
    phase 30's engine and trace: tokens = phase 30's, K1 33 a decode pass
    and 201 an encoder-side pass a rank, 12 and 64 folds, 10 of the 20
    (cross) K/V heads a rank.  37j: whisper on (2, 1) at
    ``ENCDEC_DP_LAYERS`` decoder layers against one rank.  37k: the vlm
    and encdec smoke configs, and whisper-large-v3 at its published widths
    and ``WHISPER_DP_LAYERS`` encoder and decoder layers on phase 31b's
    batch, data-parallel on (2, 1) against one rank, as 37g, their
    launches a step ``step_launches``'.  37l: mamba2-2.7b at its published
    widths and ``SSM_PLAN_LAYERS`` layers on (1, 2) (40 SSD heads a rank,
    out_proj folding) through phase 32's engine and trace against one rank
    at that depth, and on (2, 1) against that run: tokens and counters
    equal, K1 17 a weight pass a rank, 8 folds a pass on (1, 2), no
    implicit host sync outside the collectives.  37m: recurrentgemma-2b
    at ``HYBRID_PLAN_LAYERS`` layers the same way (K1 47 a pass, 12
    folds).  37n: both recurrent smoke configs and mamba2-2.7b at its
    published widths and ``SSM_DP_LAYERS`` layers (batch 2 x 512)
    data-parallel on (2, 1) against one rank, as 37k.  37o (a):
    olmo-1b at ``TP_TRAIN_LAYERS`` layers tensor-parallel on (1, 2) against
    one rank, (b): its smoke config on (2, 2) over four ranks.  37p (a):
    whisper-large-v3 at ``ENCDEC_TP_TRAIN_LAYERS`` encoder and decoder
    layers on (1, 2), (b): internvl2-76b's smoke config on (1, 2), (c):
    both smoke configs in 37o (b)'s four ranks (:func:`tp_training`,
    :func:`_check_tp_run`, :func:`_check_tp_smoke`).  37q (a):
    llama4-scout at its published widths and ``MOE_TP_TRAIN_LAYERS``
    layers on (1, 2) under EP, its first step against one rank run on
    rank 0 of the four-rank world (:func:`_first_steps_one_rank`,
    :func:`_first_step_rank`, :func:`_check_first_steps`), (b): grok-1's
    smoke configs on (1, 2) under EP and TP experts, (c): the MoE smoke
    configs in the four ranks.  37r (a): mamba2-2.7b at
    ``SSM_TP_TRAIN_LAYERS`` layers, batch 4 x 512, 2 steps, (b):
    recurrentgemma-2b at ``HYBRID_TP_TRAIN_LAYERS`` layers, batch 2 x 512,
    its first step, both at their published widths on (1, 2) against one
    rank run as 37q (a)'s (``FIRST_STEP_CELLS``), (c): both smoke configs
    and their ``RECURRENT_WIDE`` widenings on (1, 2), (d): both smoke
    configs in the four ranks.  37s (:data:`OPTION_CELLS`,
    :func:`_option_cells_rank`, :func:`_check_options`): llama3-8b at its
    published widths through phase 19's engine and ``OPTION_TRACE``,
    against one rank in the same world: (a) ``SPEC_PLAN_LAYERS`` layers on
    (1, 2), ``KV_PINNED`` pages and the 3-bit self-draft (spec on = off on
    the plan, every draft step's tokens = one rank's), (b) the same on
    (2, 1) with the n-gram drafter and one-token prompts (drafts
    accepted), (c) and (d)
    ``OPTION_LAYERS`` layer on (1, 2) under ``quantize_attention`` and the
    FP32 baseline (a fresh pool's decode logits within
    ``FP32_LOGIT_RTOL`` of one rank's): tokens and every counter of
    ``OPTION_COUNTERS`` equal one rank's, K1 once a linear shard a weight
    pass and a draft step (none under FP32), the folds, no implicit host
    sync outside the collectives; tokens/s, wall, a decode step's device
    ms and gloo bytes printed beside the card.  The ranks' summed
    peak stays under ``MULTI_PEAK_GIB`` in each serving and training
    sub-phase."""
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.data import pipeline
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import collectives
    from repro_torch.parallel.planner import runtime_layout
    from repro_torch.train import TrainConfig, make_train_step

    phase("37 multi-GPU: two ranks on the one card (37a-s), then four (37o (b), 37p (c), "
          "37q (c), 37r (d), after 37q (a)'s and 37r (a-b)'s one rank on rank 0)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = collectives.spawn(_phase37_rank, 2, device="cuda")
    spawn_s = time.perf_counter() - t0
    out = {"spawn_s": spawn_s}
    failures = []
    llama = configs.get_config("llama3-8b")
    _check_sharded("a", ranks, dataclasses.replace(llama, n_layers=TP_SERVE_LAYERS), failures)
    _check_sharded("b", ranks, dataclasses.replace(llama, n_layers=DP_SERVE_LAYERS), failures)
    # 37e-f: the MoE decoders with EP on the model axis
    phase27 = detail["serving_grok-1-314b"]
    for key, arch in (("e", "grok-1-314b"), ("f", "llama4-scout-17b-a16e")):
        cfg = dataclasses.replace(configs.get_config(arch), n_layers=MOE_EP_LAYERS)
        for r, res in enumerate(ranks):
            if res[key][1]["experts"] != "EP":
                failures.append(f"37{key} rank {r}: experts {res[key][1]['experts']}, "
                                "expected EP")
        _check_sharded(key, ranks, cfg, failures, phase27["tokens"] if key == "e" else None)
    print(f"37e: a decode step's device busy {ranks[0]['e'][1]['decode_step_device_ms']:.2f} ms "
          f"a rank against phase 27's "
          f"{phase27['steps']['profiled_decode_step']['device_busy_ms']:.2f} ms")
    # 37h-j: the vlm and the encdec on a plan
    vlm = dataclasses.replace(configs.get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    enc = configs.get_config(ENCDEC_ARCH)
    _check_sharded("h", ranks, vlm, failures, detail[f"serving_{VLM_ARCH}"]["tokens"])
    _check_sharded("i", ranks, dataclasses.replace(enc, n_layers=ENCDEC_LAYERS), failures,
                   detail[f"serving_{ENCDEC_ARCH}"]["tokens"])
    _check_sharded("j", ranks, dataclasses.replace(enc, n_layers=ENCDEC_DP_LAYERS), failures)
    for r, res in enumerate(ranks):
        heads = (res["i"][1]["heads_local"], res["i"][1]["kv_heads_local"])
        if heads != (enc.n_heads // 2, enc.kv_heads // 2):
            failures.append(f"37i rank {r}: (q, K/V) heads a rank {heads}, expected "
                            f"{(enc.n_heads // 2, enc.kv_heads // 2)}")
    print(f"37h-i: a decode step's device busy a rank {ranks[0]['h'][1]['decode_step_device_ms']:.2f}"
          f" / {ranks[0]['i'][1]['decode_step_device_ms']:.2f} ms against phases 29-30's "
          f"{detail[f'serving_{VLM_ARCH}']['steps']['profiled_decode_step']['device_busy_ms']:.2f}"
          f" / {detail[f'serving_{ENCDEC_ARCH}']['steps']['profiled_decode_step']['device_busy_ms']:.2f}"
          " ms")
    # 37l-m: the recurrent families on (1, 2) against one rank, and on
    # (2, 1) against that one rank's tokens and counters
    for key, arch in (("l", "mamba2-2.7b"), ("m", "recurrentgemma-2b")):
        cfg = dataclasses.replace(configs.get_config(arch),
                                  n_layers=RECURRENT_PLAN_LAYERS[arch])
        _check_sharded(key, ranks, cfg, failures)
        one_row = next(res[key][1] for res in ranks if "one_rank_counters" in res[key][1])
        _check_sharded(key + "2", ranks, cfg, failures, tokens=ranks[0][key][0],
                       counters=one_row["one_rank_counters"])
        lay = runtime_layout(cfg, 2)
        for r, res in enumerate(ranks):
            if res[key][1]["heads_local"] != lay.heads_local:
                failures.append(f"37{key} rank {r}: {res[key][1]['heads_local']} heads a "
                                f"rank, expected {lay.heads_local}")
        print(f"37{key}: a decode step's device busy a rank "
              f"{[round(res[key][1]['decode_step_device_ms'], 3) for res in ranks]} ms on "
              f"(1, 2), {[round(res[key + '2'][1]['decode_step_device_ms'], 3) for res in ranks]}"
              f" ms on (2, 1); tokens/s {ranks[0][key][1]['tokens_per_s']:.2f} / "
              f"{ranks[0][key + '2'][1]['tokens_per_s']:.2f}")
    # 37g, 37k, 37n: data-parallel smoke training against one rank
    g_rows = _check_dp_cells("g", ranks, failures)
    k_rows = _check_dp_cells("k", ranks, failures, launches=True)
    n_rows = _check_dp_cells("n", ranks, failures, launches=True)
    # 37d
    for r, res in enumerate(ranks):
        print(f"37d rank {r}:", json.dumps(res["d"]))
        if not (res["d"]["sum_equals_decoded"] and res["d"]["unbiased"]):
            failures.append(f"37d rank {r}: compressed_psum check failed")
    # 37c: one rank at the same global batch, here
    cfg = dataclasses.replace(configs.get_config("olmo-1b"), n_layers=DP_TRAIN_LAYERS)
    shape = configs.ShapeConfig("dp", DP_TRAIN_SEQ, DP_TRAIN_BATCH, "train")
    opt = adamw(warmup_cosine_schedule(3e-3, 20, DP_TRAIN_STEPS))
    step_fn = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig())
    params = spec.materialize(registry.param_specs(cfg),
                              torch.Generator(device=dev).manual_seed(0))
    state = opt.init(params)
    batches = [pipeline.make_batch(cfg, shape, s, device=dev) for s in range(DP_TRAIN_STEPS)]
    one_tl = step_fn.token_losses(params, batches[0]).cpu().numpy()
    one_losses = []
    for s in range(DP_TRAIN_STEPS):
        params, state, m = step_fn(params, state, batches[s], s)
        one_losses.append(float(m["loss"]))
    del params, state, batches
    torch.cuda.empty_cache()
    dp_tl = np.concatenate([res["c"][0] for res in ranks])
    tl_equal = dp_tl.view(np.uint32).tolist() == one_tl.view(np.uint32).tolist()
    tl_rel = float(np.max(np.abs(dp_tl - one_tl) / np.maximum(np.abs(one_tl), 1e-30)))
    dp_rows = [res["c"][1] for res in ranks]
    rel = max(abs(a - b) / abs(b) for a, b in zip(dp_rows[0]["losses"], one_losses))
    want = step_launches(cfg)
    for r, row in enumerate(dp_rows):
        print(f"37c rank {r}:", json.dumps(row))
        if any(n != want for n in row["launches"]):
            failures.append(f"37c rank {r}: launches {row['launches']}, expected {want}")
    print(f"37c one rank: losses {[repr(x) for x in one_losses]}; data-parallel "
          f"{[repr(x) for x in dp_rows[0]['losses']]}; max relative {rel:.3g}; first-step "
          f"per-token losses bit for bit: {tl_equal} (max relative {tl_rel:.3g})")
    if not tl_equal:
        failures.append("37c: first-step per-token losses differ from one rank's")
    if not rel <= LOSS_RTOL:
        failures.append(f"37c: losses differ by {rel:.3g} relative (bound {LOSS_RTOL})")
    out["s"] = _check_options(ranks, failures, detail["card"])
    tp_rows, one = tp_training(ranks, failures)
    tp_rows.update(_check_first_steps(one, ranks, failures))
    served = tuple("abefhij") + ("l", "l2", "m", "m2") + tuple(OPTION_CELLS)
    peaks = {k: sum(res[k][1]["peak_gib"] for res in ranks) for k in served}
    peaks["c"] = sum(row["peak_gib"] for row in dp_rows)
    peaks.update({k: sum(res[k]["peak_gib"] for res in ranks)
                  for k in (*_tp_cells(), *FIRST_STEP_CELLS)})
    peaks.update(g=max(r["peak_gib"] for r in g_rows.values()),
                 k=max(r["peak_gib"] for r in k_rows.values()),
                 n=max(r["peak_gib"] for r in n_rows.values()))
    seconds = {k: round(ranks[0][k][1]["seconds"], 1) for k in served + ("c",)}
    seconds.update({k: round(ranks[0][k]["seconds"], 1)
                    for k in ("g", "k", "n", *_tp_cells(), *FIRST_STEP_CELLS)})
    seconds["q, r one rank"] = round(tp_rows["first_steps_s"], 1)
    seconds["o, p (2, 2)"] = round(tp_rows["two_by_two_spawn_s"], 1)
    print(f"37 peaks, both ranks summed (GiB): "
          f"{ {k: round(v, 2) for k, v in sorted(peaks.items())} }; backend "
          f"{ranks[0]['a'][1]['backend']}; seconds a sub-phase (rank 0) {seconds}; spawn to "
          f"exit {spawn_s:.1f} s")
    if max(peaks.values()) >= MULTI_PEAK_GIB:
        failures.append(f"37: the ranks' summed peak passed {MULTI_PEAK_GIB} GiB")
    out.update({k: [res[k][1] for res in ranks] for k in served})
    out.update(c=dict(ranks=dp_rows, one_rank_losses=one_losses, max_rel=rel,
                      token_losses_bit_equal=tl_equal, token_losses_max_rel=tl_rel),
               d=[res["d"] for res in ranks], g=g_rows, k=k_rows, n=n_rows, tp=tp_rows,
               peak_gib=peaks, seconds=seconds)
    detail["multi_gpu"] = out
    if failures:
        raise SystemExit("phase 37: " + "; ".join(failures))
    return out


def tp_training(ranks, failures):
    """37o, 37p, 37q (b-c) and 37r (c-d): their (1, 2) runs (37o (a), 37p
    (a) and (b), 37q (b), 37r (c)) ran in phase 37's two-rank world; their
    (2, 2) smoke runs (37o (b), 37p (c), 37q (c), 37r (d)) spawn four
    ranks, whose rank 0 first runs 37q (a)'s and 37r (a-b)'s one rank.
    Returns the rows and that one rank's results."""
    from repro_torch.parallel import collectives

    t0 = time.perf_counter()
    ranks4 = collectives.spawn(_tp_smoke_rank, 4, device="cuda", threads=2)
    spawn_s = time.perf_counter() - t0
    from repro_torch import configs

    def label(cfg):
        if cfg.family in ("ssm", "hybrid"):
            return "37r"
        return "37o" if cfg.name == "olmo-1b" else "37q" if cfg.moe is not None else "37p"

    out = {key: _check_tp_run(key, label(_tp_cells()[key][0]), [res[key] for res in ranks],
                              failures)
           for key in _tp_cells()}
    out["two_by_two"] = {arch: _check_tp_smoke(arch, label(configs.smoke_config(arch)),
                                                ranks4, failures)
                         for arch in TP_SMOKE_ARCHS}
    out["two_by_two_spawn_s"] = spawn_s
    out["first_steps_s"] = ranks4[0]["first_steps_s"]
    print(f"37o/p/q/r: (1, 2) {[round(ranks[0][k]['seconds'], 1) for k in _tp_cells()]} s on rank "
          f"0, (2, 2) spawn to exit {spawn_s:.1f} s (37q (a)'s and 37r (a-b)'s one rank "
          f"{ranks4[0]['first_steps_s']:.1f} s of it)")
    return out, ranks4[0]["first_steps"]


if __name__ == "__main__":
    sys.exit(main())
