#!/usr/bin/env python3
"""Drive the PyTorch port's serving and giant-graph training paths, its
band-SpMM variants, its band-pipeline probes, graph-classification
training, the random-row gather, mixed precision, the headline bench and
entry point, the giant-graph layout set-up, sampled node training
(host-sampled, device-sampled and scanned epochs), and the parallel modes
(data parallelism, the edge-, band- and hybrid-partitioned models, the 2-D
step, sampled data parallelism and graph-sharded sampling), and the
giant-graph demo with the profiling utilities, once on one NVIDIA card.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   TF32 is switched off for every f32 product;
2. the build: ``nvcc`` compiles ``connectome_gnn_tpu_torch/csrc`` for sm_90a,
   and what ``ptxas -v`` says of the fused kernels K1 and K2
   (``fused_forward.cu``) and of the tensor-core body's kernels
   (registers, spills, shared memory; role A over the int8 band with the
   scale on the dot (K3, B2c) or folded into the tile (B2c ``wrow_bf16``),
   over the int8 band on s8 products with an int8 frame (B2b) and over the
   float32 band (K7), role A's schedule on s8 products (K5, B3a
   ``fm_w8a8``),
   and role B over the int8 band on a float32 frame, feature-major (K4,
   B3c) and blocked (K6), and on a bfloat16 frame, feature-major (timed
   against K4), with B3b's panel map and blocked (B3d), among them) and of
   B1's (``row_gather.cu``) and any warning it gives, and C7518 (``wgmma``
   serialized); the full run fails if a kernel spills or draws C7518; then ``g++`` builds the native host
   helpers (``native.AVAILABLE``, timed; phase 28 fails without them);
3. each fused kernel (K1 GCN, K2 SAGE) against its plain PyTorch version on
   the card at sixteen (B, n, F, H, L) shapes, rtol 1e-4 / atol 1e-5 (the
   repository's f32 gate), which take every cluster size the rule picks
   (1 to 8 CTAs a graph; printed), and each at one shape that takes the
   compact layout (n = 128, H = 161 or 151: odd strides); then the
   kernels' own shared-memory layout (``cgt_fused_smem_bytes``) against
   the routing rule: every shape it admits fits one block;
4. the main path: ``generate_dataset`` → dense ``ConnectomeDataLoader`` on
   CUDA → ``Trainer.predict`` for GCN and SAGE at the flagship width
   (hidden 64, 3 layers, random weights from seed 0 and non-trivial
   BatchNorm state), checked against the unfused path on the card and on
   the CPU, with each kernel's launch count; then ``Trainer.evaluate``;
5. times, at batch 16 and 512: each kernel and its plain version per call
   by CUDA events (median of 100 after warm-up, in turns) and as device
   time by ``torch.profiler``; the kernel wrapper's host µs alone (host
   clock, mean over 200 calls with no sync among them); the kernel's bound
   and its share of it; the padded batch's dense multiply-adds and their
   time at 67 TFLOP/s (f32 on the CUDA cores) and at 989/6 TFLOP/s (six
   bf16 products of the split on the tensor cores); the device time of the
   launch alone (the C entry with its arguments ready) with 0 to 3 layers
   and, at batch 16, at every cluster size; and ``predict`` over
   the 64 graphs by the host clock (``--fused-times`` runs this phase
   alone, so that another tree's package can be timed by the same code;
   ``--host-times`` runs only the wrappers' host time and ``predict``, for
   many alternating processes of two trees).

Then the giant-graph node-classification serving path, at the 5qs
configuration of ``benchmarks/suite.py:676-737`` (1,048,576 nodes, degree
38, band ±512, block 256 so W = 2, 64 input channels, hidden 64, 2 layers;
random weights from seed 0 and non-trivial BatchNorm state):

6. the band: ``generate_spatial_graph`` on the host, ``to_banded`` on the
   card, the float32 logits of ``BandedNodeGCN`` / ``BandedNodeSAGE``, then
   ``prepare_quantized`` (feature-major and row-major) and the float32 band
   freed; bytes and the memory peak;
7. each band kernel (K3, K4 and K5, all on the tensor-core body) against
   its plain PyTorch version on the card, rtol 1e-5 / atol 1e-5 (K5 bit for
   bit): on random non-symmetric int8 bands at small shapes (the ragged
   tail, W = 0, F = 5, F = 1, a block of 100; for K3 and K4 also a block of
   16 and F = 130), K5 on a saturated band and x of ±127 at b = 256, and on
   the prepared 1M-node bands;
8. the serving path: ``apply_quantized`` feature-major (K4), w8a8 (K5),
   row-major (K3), on a hybrid graph with 10 % shortcuts (K3 and the COO
   remainder), and ``BandedNodeSAGE`` feature-major (K4), each with its
   kernel's launch count, against the plain path on the card (rtol 1e-4 /
   atol 1e-4) and against the float32 logits (relative Frobenius error and
   argmax agreement, the gates of ``tests/test_banded_quant.py``);
9. RCM at the demo size (20,000 nodes, degree 12, band 256): scramble,
   recover, bandwidth before and after;
10. K4's reads past its node block: K4 and its backward launch over the
   transposed band with an Inf and then a NaN of x in one interior node
   block, at blocks of 16, 32 and 48 and W = 0, 1, 2, against the plain
   version NaN for NaN (rtol 1e-5 / atol 1e-5), every row block that does
   not read that block finite; then
   times: each band kernel, its plain version and its library call (one
   ``torch.bmm`` over a strided window view of the padded frame and the
   dequantized band, checked for hidden copies; K5 has none) per call at
   full size (CUDA events, median, in turns and back to back, then the
   card's SM clock and power; device time from ``torch.profiler``), beside
   the kernel's bound; the launch alone on the operands the wrapper
   prepares (K3: the padded band and the bf16 frame; K4: the band and
   ``xT`` as they are; K5: the band and the int8 frame with its scales,
   its output equal to the wrapper's and so to the plain version's bit for
   bit), its share of the bound and the rate at which it streams the band,
   and K5's activation quantization in torch alone; and
   ``apply_quantized`` ms per forward and
   edge-messages/s for
   feature-major, w8a8, row-major and hybrid serving, with a device-time
   breakdown by kernel (``--serving-forwards`` runs phase 6's build and
   these forwards alone, so that another tree's package can be timed by
   the same code).

Then the giant-graph int8 training path, at the 5tq / 5tqb configuration
of ``benchmarks/suite.py:986-1171`` (the same graph and widths, 2 classes,
``torch.optim.Adam(lr=1e-3)`` on the mean cross-entropy over all nodes,
dropout 0; fresh weights from seed 0):

11. set-up: the band rebuilt on the card, ``prepare`` (the normalized
    float32 band, the oracle's operand) and ``prepare_quant_trainable``
    (the int8 band and its transpose); times and the memory peak;
12. K6 and K4 over the transposed band (K4's backward launch) against
    their plain versions, rtol 1e-5 / atol 1e-5: K6 on the random
    non-symmetric small bands (with a block of 16 and F = 130), both on
    the prepared 1M-node bands;
13. the gradient of each trainable op at a small shape, kernels against
    ``plain=True`` at 1e-5, and blocked against feature-major;
14. the main path: one Adam step through ``apply_quant_trainable`` (K4
    2L times, L of them over the transpose) and one through
    ``apply_quant_trainable_blocked`` (K6 2L times, K4 none), with the
    launch counts; loss and every parameter gradient against the
    ``plain=True`` path (rtol 1e-4 / atol 1e-5) and against the float32
    ``apply_normalized`` step with the JAX package's gates (loss within
    2e-2 relative, gradients within 5e-2 relative Frobenius,
    ``tests/test_banded_quant.py:525-533``); the running moments moved
    and finite;
15. a short run: 8 Adam steps on learnable labels (the sign of the
    aggregated first feature against its median): the int8 loss falls
    and ends within 0.05 of the float32 path's, for both layouts;
16. times: ms per train step (host clock ending in a synchronize, median,
    in turns) for feature-major, blocked, the plain path and float32, and
    edge-messages/s (L × E / step time, ``benchmarks/suite.py:1075``); K6
    and K4 over the transpose per call against their plain versions and
    their library call (CUDA events), beside their bound, and their launch
    alone with its share of the bound and its band rate; a
    ``torch.profiler`` device-time breakdown of one step; the memory peak
    of training (``--train-steps`` runs phase 11's set-up and these steps,
    feature-major, blocked and float32, alone, through the public API only,
    so that another tree's package is timed by the same code).

Then the band-SpMM variants at the 5d geometry of
``benchmarks/quant_kernel_diag.py`` (the same graph: 1M nodes, band ±512,
block 256, F = 64), whose path is their entry points:

17. set-up: the float32 band rebuilt on the card, its bfloat16 copy and
    its int8 quantization; bytes and the memory peak;
18. K7 (``banded_spmm_direct`` over the float32 and the bfloat16 band),
    B2a (``banded_spmm_bf16``), B2b (``banded_spmm_w8a8``) and B2c
    (``banded_spmm_quant_fused_dot``, with ``wrow_bf16`` False and True)
    against their plain versions, rtol 1e-5 / atol 1e-5 (B2b bit for bit,
    and its launch alone on the operands its wrapper prepares bit for bit
    the wrapper's output, also at blocks of 40 and 48 and F = 130), on the
    random non-symmetric small bands (K7 over the float32 band and B2c without
    ``wrow_bf16``, whose order of sums the plain version's float32 sums
    cannot share, against their plain versions summed in float64 at 1e-5
    and against the float32 plain versions within 1e-5 of the sum of the
    products' magnitudes; the plain version's own distance from its
    float64 sums is printed beside); then the main path, each entry point
    once at 1M nodes with one launch each, its output against its plain
    version at 1e-5 (B2b bit for bit, and its launch alone) and against
    the float32 ``banded_spmm`` under the checks phase's gate (relative
    Frobenius error < 3e-2, ``quant_kernel_diag.py:327``);
19. times: each variant's kernel, plain version and library call per call
    (CUDA events, median of 10, in turns; B2b has no library call) and
    the launch alone on the operands its wrapper prepares, G
    edge-messages/s and the kernel's and the launch's share of the bound;
    B2b's int8 frame built three ways, bit for bit the same (the wrapper's
    node-major quantization and the int8 values transposed as 32-bit words
    of four senders; the same transposed byte by byte; a float32 transpose
    and K5's feature-major quantization), each timed, and the node-major
    quantization alone; the memory peak.

Then the feature-major band-pipeline probes B3a-B3d of
``benchmarks/fm_kernel_diag.py`` at its 5qm geometry (the same graph: 1M
nodes, band ±512, block 256, F = 64), whose path is their entry points:

20. set-up: the float32 band rebuilt on the card, the float32 product
    the gate holds the variants to, then the feature-major int8 band, its
    bfloat16 copy (``swapaxes(band / scales)``, the script's ``:603-606``),
    the bfloat16 padded frame, its blocked form and its int8 quantization;
    bytes and the memory peak;
21. each B3 kernel (``fm_dma_only`` bitwise, the others at rtol 1e-5 /
    atol 1e-5) against its plain version on random non-symmetric small
    bands, ``fm_deep`` (B3c, K4's launch) and ``fm_blocked`` (B3d, role B
    over the int8 band on a bfloat16 frame) also at blocks of 48 and 80
    and at a few (R, S, K) and (R, S) of the script's sweeps, each the one
    result bit for bit, ``fm_w8a8`` bit for bit its plain version and K5's
    kernel on K5's operands, and ``fm_dma_only``, also at a block of 40
    (padded to 48); then the
    main path, each entry point once at 1M nodes with one
    launch each, against its plain version and, for ``fm_deep``,
    ``fm_blocked``, ``fm_bf16_band`` and ``fm_w8a8``, under the 3e-2 gate
    against the float32 ``banded_spmm``, the sweeps' calls the one result;
22. times: each B3 kernel's wrapper, plain version, library call (the
    feature-major ``torch.bmm`` for ``fm_deep`` and ``fm_blocked``, its
    bfloat16 form for ``fm_bf16_band``; the others have none) and, where the
    wrapper prepares its operands in torch first, the launch alone (CUDA
    events, median of 10, in turns), G edge-messages/s and the share of the
    bound (for the two probes, the bound of what their output needs: one
    chunk for compute-only, diagonal 0's first F tile rows for dma-only,
    and for compute-only also the work bound of every chunk's dense dots);
    role B over the same int8 band on a float32 frame against a bfloat16
    one, launches alone in turns (K4 on ``xT``, B3c's route, against the
    feature-major launch on ``pad_xT``'s bfloat16 frame; K6 on the blocked
    frame in float32 against B3d), each output equal to its pair's bit for
    bit, each with the bytes it stages into shared memory and their rate,
    and the bfloat16 route whole (``pad_xT``, then the launch) beside K4's
    launch; role B's ring alone: the dma-only probe's launch, the bytes it
    stages (B3d's) and their rate, against the bound of its function and of
    that stream; role B taken apart: the launches alone in turns of the
    ring alone (dma-only), role B without its HBM stream (B3b, its panel in
    L2), all of role B (B3d) and the feature-major bfloat16-frame launch,
    each with its stages a block and µs a stage, and their differences a
    stage; the memory peak.

Then graph-classification training (``Trainer.fit``, which runs no
hand-written kernel) and the random-row gather B1 of
``benchmarks/gather_dma_experiments.py``:

23. training on the card: ``examples/demo.py``'s flow, run by
    ``examples/demo_torch.py``'s ``train_and_test`` (``generate_dataset(300,
    seed=42)``, its 70/15/15 split, COO batches of 16) through ``Trainer.fit``
    for GCN and SAGE at hidden 64, 3 layers, dropout 0.3, 30 epochs with
    patience 8: the history is finite, the train loss falls, no step is
    skipped; then three Adam steps with dropout 0 on the card against the
    port on the CPU (dense and COO; loss at 1e-5, gradients and parameters
    at rtol 1e-4 / atol 1e-5, the GCN conv biases and running means looser
    for the reason ``step_tolerance`` gives); a batch with NaN features is
    skipped and leaves parameters, buffers and Adam's state (its step count
    on the card) bitwise unchanged; a fit preempted by SIGTERM and resumed
    from its checkpoint equals an uninterrupted one bitwise (dense layout,
    dropout 0.3); and the steps of an epoch, fed batches already on the
    card, run under ``torch.cuda.set_sync_debug_mode("error")``;
24. B1 (``ops.gather_dma.dma_gather``) against ``table[idx]``, bitwise: small
    cases at every K in (4, 8, 16, 32) and C in (1, 7, 256, 1024,
    ``MAX_CHUNK``), ragged L, L < C, rows of 1, 2, 3, 4, 64, 65, 68 and 1024
    elements in float32, int32 and bfloat16; an index outside the table (N,
    then -1) fails a child process with the kernel's trap, in 16-B and in
    4-B words, by its synchronize at the latest, and this process still
    gathers; then the script's three cases at full size (``:245-252``), one
    launch each, and the launch alone at each;
25. times: ms per train step with and without the guard (host clock ending
    in a synchronize, median, in turns), the device's busy share and a
    ``torch.profiler`` breakdown of one step, and a GCN epoch of 256 graphs at
    batch 16 beside ``BASELINE.md``'s torch-CPU row; for B1, the entry point
    (no host sync: it runs under ``set_sync_debug_mode("error")``), the
    launch alone (the C entry called with its arguments ready), the plain
    version and ``torch.index_select`` per call (CUDA events, median, in
    turns) and the launch and ``index_select`` by device time, with ns/row,
    GB/s, the bound and where the table stands against the 50 MB L2, the
    entry point at every (K, C), where the entry point's host time goes
    against ``index_select``'s (host clock, mean over many calls, piece by
    piece), and the launch at case (a)'s indices from tables of 4.2 to 67.1
    MB (what bounds it: rows that miss L2).
    ``--gather`` runs phases 24 and 25's B1 half alone.

Then this slice's paths: mixed precision, the application surface and
the giant-graph set-up.

26. bf16: the precision flags as found; ``mixed_matmul`` on the card
    within 1e-5 of sum |a||b| from the float64 product of the rounded
    operands, at the model's product shapes, with TF32 and bfloat16
    reduced-precision reduction off and on (the product pins both off,
    backward too, and restores them); GCN and SAGE at hidden 64, L=3 with
    ``compute_dtype=torch.bfloat16`` on a dense batch of 16: against the
    port's CPU bf16 path (1e-3) and the float32 path (0.05, argmax 0.9);
    ``forward_auto`` of the bf16 model launches K1 or K2 once and gives
    the float32 logits (1e-4 / 1e-5); the whole bf16 forward and one
    product by ``mixed_matmul``'s route (round, then a float32 product)
    and by cuBLAS on the bfloat16 operands into a float32 output (CUDA
    events, in turns); one bf16 train step on the card against the CPU
    (loss 1e-4, gradients 1e-2 relative Frobenius over all of them and
    4e-2 each), and the same gates read on two faulty steps, which must
    fail them: a bfloat16 output of every product, and each gradient
    zeroed in turn;
27. ``bench_torch.py`` as a subprocess: its lines, its gate passed, its
    JSON line with ``bench.py``'s four keys; then ``entry()`` on the card
    against ``model(batch)`` and the CPU entry point (1e-4 / 1e-5);
28. the giant-graph set-up: ``native.AVAILABLE`` (built in phase 2); the
    planner's two rates on the card (the port's ``coo_spmm`` per edge at
    4,194,304 random edges and F = 64; the bytes ``_band_cost_curve``
    prices for phase 6's band over the float32 ``banded_spmm``'s time);
    then a scrambled graph at ``benchmarks/suite.py:738-756``'s 5c scale
    (65,536 nodes, degree 16, band 512, 10 % shortcuts, F = 64, ids
    permuted from a seed): ``plan_layout`` and ``build_layout`` timed on
    the host, ``auto_layout(..., quantized=True)`` the same plan, then
    ``BandedNodeGCN.prepare_quantized`` + ``apply_quantized`` with K3
    launched L = 2 times and nothing else, against the float32 COO model
    on the scrambled input through ``plan.perm`` (the int8 gate: 5e-2
    relative Frobenius, 0.99 argmax), and the plan's predicted µs for one
    SpMM against its measured time;
29. host-sampled training at ``benchmarks/suite.py``'s S2 widths
    (``SAMPLED``: the spatial graph of 1,048,576 nodes with in-degree 38 and
    10 % shortcuts, 5 channels, hidden 64, two layers, 1024 seeds a step,
    fanout (10, 10)): ``SampledNodeLoader`` (fused) on the card, its first
    batch bitwise a CPU loader's; one ``NodeGCN`` step on the card against
    the CPU (loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5); then
    ``Trainer.train_epoch`` over 20 steps, ms a step with prefetch 2 and 0;
30. device-sampled training (SD2): ``device_sampled_gcn``,
    ``device_sampled_sage`` and SAGE multiset (``dedup=False``): the CSR's
    bytes, ``device_sample`` on the card bitwise the CPU's for one row, eval
    logits against the CPU (1e-4 / 1e-5), a step against the CPU, ms a
    step stepwise over 20 steps, the memory peak and the device time by
    kernel (``torch.profiler``) with the busy share;
31. ``Trainer(scan_epochs=True)`` (SE2 GCN, SME2 SAGE multiset): 64 steps
    scanned, one captured CUDA graph replayed a step, against the same
    steps stepwise and stepwise again: parameters, BatchNorm buffers and
    Adam state bitwise or their largest difference, the epoch's loss
    within 1e-4 of the stepwise one, ms a step both ways and the host's
    dispatches an epoch (kernel and graph launches, copies and fills by
    ``torch.profiler``).  ``--sampled`` runs phases 29-31 alone.

Then the parallel modes (``connectome_gnn_tpu_torch.parallel``), in one
rank of an NCCL group of size 1 (a ``file://`` rendezvous in a temporary
directory) holding 4 shards on the card: every collective goes through
NCCL, crossing no card.  Each phase prints ms a forward or a step, sharded
and unsharded (host clock ending in a synchronize, median of 3), the
memory peak and the bytes each collective moved: what sharding costs on
one card, not scaling.

32. data-parallel graph classification, GCN and SAGE (hidden 64, 3
    layers, dropout 0, dense layout): ``Trainer(mesh=...)`` over batches
    of 16 graphs a shard × 4 for 8 steps against the unsharded ``Trainer``
    at batch 64: parameters and buffers within rtol 1e-4 / atol 1e-5, a
    GCN conv's bias within 2·k·lr and the running means it feeds within
    momentum·lr·k·(k−1) (noise gradients: BatchNorm cancels the bias);
    then ``evaluate`` and ``predict`` (K1/K2 on the merged shards) on the
    same weights against the unsharded ones;
33. ``EdgePartitionedGCN`` on the giant graph's COO form (1,048,576 nodes,
    39.8M edges, F = H = 64, 2 layers) in 4 shards: ``partition_graph`` on
    the host (the send table's borrowed rows printed), eval logits against
    the unsharded COO ``NodeGCN`` (rtol 1e-4 / atol 1e-5), one step's
    gradients by relative Frobenius error (gate 1e-4);
34. ``ShardedBandedGCN`` and ``ShardedBandedSAGE`` forwards and the
    ``ShardedBandedGCN`` step on the float32 band (W = 2, b = 256) against
    ``BandedNodeGCN`` / ``BandedNodeSAGE``; then the hybrid form of the
    graph with 10 % shortcuts against the unsharded hybrid forward;
35. ``make_banded_train_step_2d`` on a (data 2 × edge 2) mesh over a cohort
    of two 262,144-node subjects at the same widths, against one device's
    ``BandedNodeGCN`` step on ``banded_block_diag`` (loss rtol 1e-5,
    gradients by relative Frobenius error, gate 1e-4).
``--parallel`` runs phases 32-35 alone.

Then sampled data parallelism and graph-sharded sampling (slice E3), in
one rank of an NCCL group of size 1 holding 4 shards, at S2's widths
(phases 29-31: 1024 seeds a step, 256 a shard).  Every byte stays on the
card: what the exchange and the merge cost, not scaling.

36. sampled data parallelism: ``SampledNodeLoader(num_shards=4)`` into
    the data-parallel ``NodeGCN`` step (its first stacked batch bitwise a
    CPU loader's, a step against the CPU's: loss rtol 1e-5, gradients rtol
    1e-4 / atol 1e-5, ms a step in turns with the unsharded S2 step); then
    the device-sampled GCN and SAGE multiset through
    ``make_device_sampled_dp_step`` on the CSR on the card (one shard row's
    ``device_sample`` bitwise the CPU's, a step against the CPU's, ms a
    step against phase 30's unsharded step, device time by kernel, the
    busy share and the peak);
37. ``Trainer(scan_epochs=True, mesh=...)`` (SE2, SME2 over 4 shards): 64
    steps scanned, one captured step with its NCCL collectives, against
    the same steps stepwise: the state bitwise or its largest difference,
    the epoch loss within 1e-4, ms a step both ways, the host's
    dispatches an epoch, the bytes of each collective in a step and over
    the epochs (the replays counted by the captured step's counts: exactly
    64 a step's an epoch);
38. ``graph_sharded_sage`` (4 shards of 262,144 nodes): the partition's
    seconds and each shard's bytes, ``plan_compaction`` on 4 probe
    batches, one step's ``sharded_device_sample`` on the card bitwise the
    CPU's with both exchanges and overflow 0, compacted bitwise broadcast,
    eval logits and a step's gradients against the CPU's (rtol 1e-4 /
    atol 1e-5; relative Frobenius, gate 1e-4), ms a step compacted,
    broadcast and replicated (phase 36's SAGE multiset DP step), each
    collective's counted bytes (``count_collective_bytes``) against
    ``sharded_sampling_comm_model``, the peak; then
    ``entry.dryrun_multichip(4)`` on the card and the launcher's
    ``sampled_dp``, ``device_sampled_dp``, ``device_sampled_dp_scanned``
    and ``graph_sharded`` programs with no device argument (NCCL), each
    with a finite loss and a first-step gradient sum.
``--sampled-parallel`` runs phases 36-38 alone (about 112 s).

Then slice F, the port's last: the giant-graph demo and the profiling
utilities.

39. ``examples/giant_graph_demo_torch.py``'s ``main`` at its defaults
    (20,000 nodes, 200 band-training steps) on the card with 4 shards in
    this process: every parameter and the band on the card, every loss
    finite, the sharded band and hybrid logits within 1e-4 of the single
    model's, its host-side numbers (edges, scrambled and RCM bandwidths,
    row blocks and diagonals, shortcuts, the sampled minibatch's nodes and
    edges) equal to the same functions' on the CPU; each section's seconds
    and peak memory, the graph-sharded overflow and the planner's alphas
    and payloads, and the kernel launches on the demo's path (none: its
    ops are the port's torch ops); then ``utils.trace`` around one
    ``Trainer.predict`` batch at b16, whose trace must name K1's kernel,
    and ``StepTimer.toc(result)`` around an 8192² float32 matmul, at least
    0.9 × its CUDA-event time, with the product as the result and as the
    tensor field of a dataclass (the tree rules of ``utils/tree.py``),
    beside ``toc(None)``; then a checkpoint of a card-resident
    ``ConnectomeBatch`` with a NamedTuple and a ``None`` beside it, saved
    and restored onto the card: no pickle, the template's types, bitwise.
``--giant-demo`` runs phase 39 alone.

It prints the card's name and power limit, the kernels' JSON line (K1 to
K7, K4's backward, B2a-B2c, B3a-B3d and B1 at the script's three cases,
each with its launches on the main path, its largest error against its
plain version, its time, its plain
version's, its bound and what bounds it, and its library call's time or
null), then ``{"ok": true, "device": ...}`` as the last line.  The bound
is the larger of the bytes the call must move (each input read once,
each output written once) over 3.35 TB/s and the operations its inputs
need (a multiply-add per nonzero band or adjacency entry) over the card's
published peak for their type (``PEAK_OPS``).  Any failure raises
and exits non-zero; without CUDA it fails at once.  JAX is not imported:
the machine with the card has none.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from connectome_gnn_tpu_torch import (
    BandedNodeGCN,
    BandedNodeSAGE,
    ConnectomeDataLoader,
    GCNConnectome,
    GraphSAGEConnectome,
    NodeGCN,
    SampledNodeLoader,
    Trainer,
    collate_graphs,
    device_sampled_gcn,
    device_sampled_sage,
    generate_dataset,
    generate_spatial_graph,
)
from connectome_gnn_tpu_torch import entry as port_entry
from connectome_gnn_tpu_torch import native
from connectome_gnn_tpu_torch.data import (
    DeviceGraphCSR,
    DeviceSampledModel,
    NeighborSampler,
    SeedBatch,
    apply_ordering,
    auto_layout,
    bandwidth,
    build_layout,
    collate_dense,
    device_sample,
    make_seed_batch,
    plan_layout,
    reverse_cuthill_mckee,
)
from connectome_gnn_tpu_torch.data import layout
from connectome_gnn_tpu_torch.models import layers as conv_layers
from connectome_gnn_tpu_torch import parallel
from connectome_gnn_tpu_torch.ops import _build
from connectome_gnn_tpu_torch.ops import band_mma
from connectome_gnn_tpu_torch.ops import band_variants as bv
from connectome_gnn_tpu_torch.ops import banded_direct as bd
from connectome_gnn_tpu_torch.ops import banded_quant as bq
from connectome_gnn_tpu_torch.ops import fm_variants as fv
from connectome_gnn_tpu_torch.ops import fused
from connectome_gnn_tpu_torch.ops import gather_dma as gd
from connectome_gnn_tpu_torch.ops.banded import (
    BandedMatrix,
    banded_block_diag,
    banded_spmm,
    pad_blocks,
    to_banded,
    to_hybrid,
)
from connectome_gnn_tpu_torch.ops.segment import coo_spmm
from connectome_gnn_tpu_torch.train import restore_checkpoint, save_checkpoint
from connectome_gnn_tpu_torch.utils import StepTimer, trace
from connectome_gnn_tpu_torch.utils.tree import leaves_with_path, map_leaves
from connectome_gnn_tpu_torch.ops.fused import (
    fused_gcn_forward_reference,
    fused_gcn_kernel,
    fused_sage_forward_reference,
    fused_sage_kernel,
    gcn_weights,
    sage_weights,
)

RTOL, ATOL = 1e-4, 1e-5
#: (B, n, F, H, L): flagship batch 16 and 512, the largest fused shape, a
#: small one; then the shapes that take every cluster size the rule picks
#: (n = 88 at 1, 48, 64, 80 and 100 graphs, n = 128 at 36) and n = 40, not
#: a multiple of 16, at H = 32, 72 (nine n8 tiles), 128 and 37 (odd, F = 7)
SHAPES = [(16, 88, 5, 64, 3), (512, 88, 5, 64, 3), (7, 128, 5, 128, 1), (3, 24, 5, 32, 2),
          (1, 88, 5, 64, 3), (48, 88, 5, 64, 3), (64, 88, 5, 64, 3), (80, 88, 5, 64, 3),
          (100, 88, 5, 64, 3), (36, 128, 5, 64, 2), (5, 40, 5, 32, 2), (5, 40, 5, 128, 2),
          (200, 40, 5, 128, 2), (5, 40, 5, 72, 2), (300, 40, 5, 72, 2), (5, 40, 7, 37, 2)]
#: (B, n, F, H, L) a kernel takes with the compact layout (the padded
#: strides do not fit at one CTA a graph): odd widths, no 8-byte access
COMPACT_SHAPES = {"gcn": (140, 128, 5, 161, 1), "sage": (140, 128, 5, 151, 1)}
#: input widths at which phase 3 holds the kernels' layout to the routing rule
LAYOUT_FEATURES = (1, 5, 16, 64, 200)
TIMED_BATCHES = (16, 512)
#: calls over which a fused wrapper's host time is averaged (few enough that
#: the launch queue never fills at batch 512)
FUSED_HOST_CALLS = 200
KERNELS = {
    "gcn": dict(
        name="fused_gcn_forward", model=GCNConnectome, weights=gcn_weights,
        kernel=fused_gcn_kernel, plain=fused_gcn_forward_reference,
        replaces="connectome_gnn_tpu/ops/fused_pallas.py:218",
    ),
    "sage": dict(
        name="fused_sage_forward", model=GraphSAGEConnectome, weights=sage_weights,
        kernel=fused_sage_kernel, plain=fused_sage_forward_reference,
        replaces="connectome_gnn_tpu/ops/fused_pallas.py:487",
    ),
}
SOURCE = "connectome_gnn_tpu_torch/csrc/fused_forward.cu"

#: the giant serving configuration 5qs (benchmarks/suite.py:676-737)
GIANT = dict(num_nodes=1 << 20, degree=38, band=512, block=256, in_channels=64, hidden=64, layers=2)
#: band kernel vs plain version: the JAX package's kernel-vs-emulation gate
BAND_RTOL, BAND_ATOL = 1e-5, 1e-5
#: quantized model vs its plain path on the card
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-4
#: quantized vs float32 logits: (largest relative Frobenius error, least
#: argmax agreement), tests/test_banded_quant.py:295-418
GATES = {"bf16": (5e-2, 0.99), "w8a8": (8e-2, 0.98)}
#: (num_blocks, W, block, num_nodes, F): the ragged tail, W = 0, SAGE's
#: F = 5, F = 1, a block of 100 with two feature slices, the full block
BAND_SHAPES = [(10, 1, 64, 640, 16), (10, 1, 64, 600, 16), (10, 0, 64, 600, 16),
               (10, 1, 64, 600, 5), (10, 2, 64, 640, 1), (7, 1, 100, 650, 70),
               (16, 2, 256, 4000, 64)]
BAND_KERNELS = {
    "K3": dict(name="banded_spmm_quant", kernel=bq.banded_spmm_quant_kernel,
               plain=bq.banded_spmm_quant_reference, feature_major=False,
               source="connectome_gnn_tpu_torch/csrc/band_mma.cu",
               replaces="connectome_gnn_tpu/ops/banded_quant.py:820"),
    "K4": dict(name="banded_spmm_quant_fm", kernel=bq.banded_spmm_quant_fm_kernel,
               plain=bq.banded_spmm_quant_fm_reference, feature_major=True,
               source="connectome_gnn_tpu_torch/csrc/band_mma.cu",
               replaces="connectome_gnn_tpu/ops/banded_quant.py:284"),
    "K5": dict(name="banded_spmm_quant_fm_w8a8", kernel=bq.banded_spmm_quant_fm_w8a8_kernel,
               plain=bq.banded_spmm_quant_fm_w8a8_reference, feature_major=True, exact=True,
               source="connectome_gnn_tpu_torch/csrc/band_mma.cu",
               replaces="connectome_gnn_tpu/ops/banded_quant.py:434"),
}
#: K3's, K4's and K6's further shapes on the tensor-core body: a block of
#: 16, F = 130 (three 64-feature units)
MMA_SHAPES = [(12, 1, 16, 180, 8), (6, 1, 64, 350, 130)]
#: the tensor-core body of K3-K7, B2a-B2c, B3a bf16_band and w8a8, B3b, B3c
#: and B3d
MMA_SOURCE = "connectome_gnn_tpu_torch/csrc/band_mma.cu"
#: a train step against its plain path on the card: the f32 gate
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
#: int8 against float32 training, tests/test_banded_quant.py:525-533:
#: (loss relative difference, gradient relative Frobenius error)
TRAIN_GATES = (2e-2, 5e-2)
#: the training kernels, each with its plain version
TRAIN_KERNELS = {
    "K4 backward": dict(name="banded_spmm_quant_fm_grad", kernel=bq.banded_spmm_quant_fm_grad_kernel,
                        plain=bq.banded_spmm_quant_fm_reference, source=MMA_SOURCE,
                        replaces="connectome_gnn_tpu/ops/banded_quant.py:743"),
    "K6": dict(name="banded_spmm_quant_blocked", kernel=bq.banded_spmm_quant_blocked_kernel,
               plain=bq.banded_spmm_quant_blocked_reference, source=MMA_SOURCE,
               replaces="connectome_gnn_tpu/ops/banded_quant.py:564"),
}
#: the band variants of phases 17-19 (K7 over each band dtype, B2a-B2c):
#: kernel wrapper, entry point, plain version, launch counter, band operand
#: (``raw``: passed as the band tensor, num_nodes and W), the operand type
#: of the products (for the bound), keyword arguments, its source, and
#: ``exact`` where it is held to its plain version bit for bit
VARIANTS = {
    "K7-f32": dict(name="banded_spmm_direct (float32 band)", kernel=bd.banded_spmm_direct_kernel,
                   entry=bd.banded_spmm_direct, plain=bd.banded_spmm_direct_reference,
                   counter="K7", band="f32", ops="f32", source=MMA_SOURCE,
                   replaces="connectome_gnn_tpu/ops/banded_pallas.py:66"),
    "K7-bf16": dict(name="banded_spmm_direct (bfloat16 band)", kernel=bd.banded_spmm_direct_kernel,
                    entry=bd.banded_spmm_direct, plain=bd.banded_spmm_direct_reference,
                    counter="K7", band="bf16", ops="bf16", source=MMA_SOURCE,
                    replaces="connectome_gnn_tpu/ops/banded_pallas.py:66"),
    "B2a": dict(name="banded_spmm_bf16", kernel=bv.banded_spmm_bf16_kernel, entry=bv.banded_spmm_bf16,
                plain=bv.banded_spmm_bf16_reference, counter="B2a", band="bf16", raw=True, ops="bf16",
                source=MMA_SOURCE, replaces="benchmarks/quant_kernel_diag.py:92"),
    "B2b": dict(name="banded_spmm_w8a8", kernel=bv.banded_spmm_w8a8_kernel, entry=bv.banded_spmm_w8a8,
                plain=bv.banded_spmm_w8a8_reference, counter="B2b", band="int8", ops="int8",
                source=MMA_SOURCE, exact=True, replaces="benchmarks/quant_kernel_diag.py:173"),
    "B2c": dict(name="banded_spmm_quant_fused_dot", kernel=bv.banded_spmm_quant_fused_dot_kernel,
                entry=bv.banded_spmm_quant_fused_dot, plain=bv.banded_spmm_quant_fused_dot_reference,
                counter="B2c", band="int8", ops="bf16", source=MMA_SOURCE,
                replaces="benchmarks/quant_kernel_diag.py:250"),
    "B2c wrow_bf16": dict(name="banded_spmm_quant_fused_dot (wrow_bf16)",
                          kernel=bv.banded_spmm_quant_fused_dot_kernel,
                          entry=bv.banded_spmm_quant_fused_dot,
                          plain=bv.banded_spmm_quant_fused_dot_reference, counter="B2c",
                          band="int8", ops="bf16", kw={"wrow_bf16": True}, source=MMA_SOURCE,
                          replaces="benchmarks/quant_kernel_diag.py:250"),
}
#: the variants held at 1e-5 to their plain version summed in float64, and
#: to the float32 plain version within 1e-5 of the sum of the products'
#: magnitudes (the products carry more bits than a float32 sum keeps, and
#: the kernel's order of sums is not the plain version's)
FLOAT64_SUMS = ("K7-f32", "B2c")
MAGNITUDE_RTOL = 1e-5
#: B2b's further shapes: a block of 48 (one partial 128-sender chunk) with
#: three 64-feature units, a block of 40 (padded to 48) with F = 5
B2B_SHAPES = [(6, 2, 48, 280, 130), (6, 1, 40, 230, 5)]
#: the checks phase's gate against the float32 band SpMM
#: (benchmarks/quant_kernel_diag.py:327)
CHECK_GATE = 3e-2
#: the feature-major band-pipeline probes of phases 20-22
#: (benchmarks/fm_kernel_diag.py): kernel wrapper, entry point, plain version
FM_KERNELS = {
    "B3a dma_only": dict(name="fm_dma_only", kernel=fv.fm_dma_only_kernel, entry=fv.fm_dma_only,
                         plain=fv.fm_dma_only_reference, source=MMA_SOURCE,
                         replaces="benchmarks/fm_kernel_diag.py:130"),
    "B3a bf16_band": dict(name="fm_bf16_band", kernel=fv.fm_bf16_band_kernel, entry=fv.fm_bf16_band,
                          plain=fv.fm_bf16_band_reference, source=MMA_SOURCE,
                          replaces="benchmarks/fm_kernel_diag.py:130"),
    "B3a w8a8": dict(name="fm_w8a8", kernel=fv.fm_w8a8_kernel, entry=fv.fm_w8a8,
                     plain=fv.fm_w8a8_reference, source=MMA_SOURCE,
                     replaces="benchmarks/fm_kernel_diag.py:130"),
    "B3b": dict(name="fm_compute_only", kernel=fv.fm_compute_only_kernel, entry=fv.fm_compute_only,
                plain=fv.fm_compute_only_reference, source=MMA_SOURCE,
                replaces="benchmarks/fm_kernel_diag.py:242"),
    "B3c": dict(name="fm_deep", kernel=fv.fm_deep_kernel, entry=fv.fm_deep,
                plain=fv.fm_deep_reference, source=MMA_SOURCE,
                replaces="benchmarks/fm_kernel_diag.py:393"),
    "B3d": dict(name="fm_blocked", kernel=fv.fm_blocked_kernel, entry=fv.fm_blocked,
                plain=fv.fm_blocked_reference, source=MMA_SOURCE,
                replaces="benchmarks/fm_kernel_diag.py:495"),
}
#: some of the script's sweeps, fm_deep (R, S, K) at :654-657 and fm_blocked
#: (R, S) at :679: on role B they shape nothing, so each gives the one result
DEEP_SWEEP = [(32, 2, 1), (32, 4, 4), (16, 8, 2)]
BLOCKED_SWEEP = [(32, 4), (16, 4)]
#: (num_blocks, W, block, num_nodes, F, R) of the random small bands: W = 0,
#: 1, 2, F = 1, 5, 16, 64, ragged tails; NB = 12 at R = 2 and 4 puts chunk
#: i* of fm_compute_only at 4 and 2
FM_SHAPES = [(8, 1, 64, 512, 16, 4), (12, 0, 64, 700, 16, 2), (12, 2, 64, 768, 5, 4),
             (8, 1, 64, 500, 1, 2), (8, 2, 64, 512, 64, 4)]
#: B3c's and B3d's further shapes: blocks of 48 and 80, multiples of 16 but
#: not of 64, so a 64-sender stage of role B reaches past the block
FM_ROLE_B_SHAPES = [(12, 1, 48, 560, 16, 4), (8, 2, 80, 600, 20, 4)]
#: fm_dma_only's and fm_w8a8's further shape: a block of 40, not a multiple
#: of 16 (padded to 48)
FM_ANY_BLOCK_SHAPES = [(8, 1, 40, 300, 5, 4)]
#: K4's non-finite check: blocks that are not multiples of 64, each W
NONFINITE_BLOCKS, NONFINITE_WS = (16, 32, 48), (0, 1, 2)
#: every band kernel's launch counter
COUNTERS = {"K3": bq.banded_spmm_quant_kernel, "K4": bq.banded_spmm_quant_fm_kernel,
            "K5": bq.banded_spmm_quant_fm_w8a8_kernel,
            "K4 backward": bq.banded_spmm_quant_fm_grad_kernel,
            "K6": bq.banded_spmm_quant_blocked_kernel, "K7": bd.banded_spmm_direct_kernel,
            "B2a": bv.banded_spmm_bf16_kernel, "B2b": bv.banded_spmm_w8a8_kernel,
            "B2c": bv.banded_spmm_quant_fused_dot_kernel, "B3a dma_only": fv.fm_dma_only_kernel,
            "B3a bf16_band": fv.fm_bf16_band_kernel, "B3a w8a8": fv.fm_w8a8_kernel,
            "B3b": fv.fm_compute_only_kernel, "B3c": fv.fm_deep_kernel, "B3d": fv.fm_blocked_kernel,
            "B1": gd.dma_gather}
#: the card's published peaks (H100 SXM at 700 W, dense): HBM bytes/s, and
#: operations/s by the products' operand type (tensor cores for bf16 and
#: int8, whose products are exact for int8 x bf16 too; the CUDA cores for
#: exact float32)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
NO_LIBRARY = "none (no single PyTorch call; no batched int8 matmul)"
#: the demo's training flow (examples/demo.py): 300 subjects split 70/15/15,
#: batches of 16, hidden 64, 3 layers, dropout 0.3, Adam lr 1e-3 with L2
#: 1e-4, seed 42, 30 epochs with patience 8
DEMO = dict(subjects=300, batch=16, hidden=64, layers=3, dropout=0.3, epochs=30, patience=8, seed=42)
TRAIN_CLASSES = {"gcn": GCNConnectome, "sage": GraphSAGEConnectome}
#: train steps on the card against the port on the CPU, and their
#: tolerances (tests/test_torch_train_fit.py): the loss, then the f32 gate;
#: a GCN conv's bias and the running means it feeds at 2·k·lr and
#: momentum·lr·k·(k - 1) (noise gradients, ``step_tolerance``)
TRAIN_STEPS, LOSS_ATOL = 3, 1e-5
GCN_BIAS_ATOL = 2 * TRAIN_STEPS * 1e-3
GCN_RUNNING_MEAN_ATOL = 0.1 * 1e-3 * TRAIN_STEPS * (TRAIN_STEPS - 1)
#: BASELINE.md's reference row: a GCN train epoch, 256 graphs, batch 16, on 1 CPU
BASELINE_EPOCH = dict(graphs=256, batch=16, cpu_s=0.395)
#: B1's cases, the script's three (gather_dma_experiments.py:245-252): name, N, F, L, dtype
GATHER_CASES = [("spmm_feature_gather", 262_144, 64, 1 << 22, "f32"),
                ("sampler_pair_gather", 4_194_304, 2, 1 << 17, "int32"),
                ("sampler_feature_gather", 262_144, 64, 1 << 17, "f32")]
#: (N, F, L) of the small checks: ragged L, L < C, L = 1, rows of 1, 2, 3, 4, 64, 65, 68 and 1024
#: elements
GATHER_SMALL = [(4096, 64, 5000), (4096, 65, 3000), (1000, 3, 1025), (16384, 2, 700), (500, 1, 257),
                (300, 64, 1), (2000, 4, 3001), (1000, 68, 1777), (600, 1024, 333)]
#: the chunks of the small checks: 1, a prime, the default and MAX_CHUNK
GATHER_CHUNKS = (1, 7, 256, 1024, gd.MAX_CHUNK)
GATHER_SOURCE = "connectome_gnn_tpu_torch/csrc/row_gather.cu"
#: a child process that gathers from a 300-row table of F float32 (its second
#: argument: 64 copies in 16-B words, 65 in 4-B words) with one index (its
#: first) outside it, then synchronizes
OUT_OF_RANGE_CHILD = """
import sys
import numpy as np
import torch
from connectome_gnn_tpu_torch.ops import gather_dma as gd
table = torch.randn(300, int(sys.argv[2]), device="cuda")
idx = torch.from_numpy(np.random.default_rng(0).integers(0, 300, 1000).astype(np.int32)).cuda()
idx[517] = int(sys.argv[1])
gd.dma_gather(table, idx)
torch.cuda.synchronize()
print("synchronized")
"""
REPO = os.path.dirname(os.path.abspath(__file__))
#: calls per host-time sample of B1's launch path
HOST_CALLS = 2000
GATHER_REPLACES = "benchmarks/gather_dma_experiments.py:91"
L2_BYTES = 50e6
#: bf16 against the port's CPU bf16 path (one bfloat16 flip of an
#: intermediate allowed, tests/test_torch_mixed_precision.py), and against
#: float32 at tests/test_dense.py:95-109's gate: 0.05, argmax agreement 0.9
BF16_CPU_TOL, BF16_F32_TOL, BF16_F32_AGREE = 1e-3, 0.05, 0.9
#: one bf16 train step on the card against the CPU: the loss, the
#: gradients by relative Frobenius error over all of them, and each tensor
#: alone at a looser limit: a float32 sum in another order can flip a
#: bfloat16 rounding downstream, which moves a small gradient such as a
#: BatchNorm bias's by up to 1.41 % on the card, and by up to 3.6 % on the
#: CPU under 1.2e-7 relative noise on each product's sum.  A bfloat16
#: output of every product moved the worst tensor 5.2 % (GCN) and 22 %
#: (SAGE) on the CPU, all of them 2.6 % and 7.7 %
BF16_STEP_LOSS_ATOL, BF16_STEP_GRAD_REL, BF16_STEP_TENSOR_REL = 1e-4, 1e-2, 4e-2
#: the giant graph the layout phase scrambles: benchmarks/suite.py:738-756's
#: 5c scale (65,536 nodes, degree 16, band ±512, 10 % shortcuts, F = 64),
#: ids permuted from a seed as benchmarks/layout_experiments.py:133-135 does
SCRAMBLED = dict(num_nodes=65_536, degree=16, band=512, shortcut_frac=0.1, feat=64, seed=0)
#: the scatter rate's COO SpMM: random edges over the giant graph's nodes
SCATTER = dict(num_nodes=1 << 20, num_edges=1 << 22, feat=64)
#: sampled training (phases 29-31) at benchmarks/suite.py's S2, SD2, SE2 and
#: SME2 widths (:1174-1189, :1741-1779): the spatial graph with 10 %
#: shortcuts, 1,048,576 nodes, in-degree 38 (39.8M edges), 5 input channels,
#: hidden 64, two layers, 1024 seeds a step, fanout (10, 10); steps a timed
#: epoch (S2, SD2) and steps of the scanned epoch (SE2, SME2)
SAMPLED = dict(num_nodes=1 << 20, degree=38, band=512, shortcut_frac=0.1, hidden=64, seeds=1024,
               fanout=(10, 10), steps=20, scan_steps=64)
SAMPLED_FIELDS = ("node_features", "senders", "receivers", "edge_weight", "node_mask", "labels",
                  "label_mask", "seed_mask", "node_ids")
#: the parallel phases (32-35): shards on the card, phase 32's batch a
#: shard, its steps and learning rate, and phase 35's cohort
PARALLEL = dict(shards=4, shard_batch=16, steps=8, hidden=64, layers=3, lr=1e-3, subjects=2,
                subject_nodes=1 << 18)
PARALLEL_NOTE = ("one rank of an NCCL group of size 1, 4 shards on one card: what sharding costs "
                 "on one card, not scaling")
#: phase 39: examples/giant_graph_demo_torch.py at its defaults with 4
#: shards, the sharded-vs-single gate on its logits, and StepTimer's
#: workload (an 8192² float32 matmul, about 20 ms with TF32 off)
GIANT_DEMO = dict(shards=4, nodes=20_000, degree=12, band=256, gate=1e-4, timer_n=8192, timer_reps=5)
#: the runtime calls by which the host puts work on the card
DISPATCH = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|MemcpyAsync|MemsetAsync|Memcpy|Memset)")


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def randomize_batch_norms(model, rng: np.random.Generator) -> None:
    """Non-trivial BatchNorm affine and running moments, drawn from numpy."""
    with torch.no_grad():
        for bn in model.batch_norms:
            H = bn.num_features
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, H).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.2, H).astype(np.float32)))
            bn.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.5, H).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, H).astype(np.float32)))


def make_model(kind, F, H, L, seed=0, compute_dtype=torch.float32):
    model = KERNELS[kind]["model"](
        in_channels=F, hidden_dim=H, num_classes=2, num_layers=L, compute_dtype=compute_dtype,
        generator=torch.Generator().manual_seed(seed),
    )
    randomize_batch_norms(model, np.random.default_rng(seed))
    return model.eval()


def random_dense_batch(B, n, F, seed, device):
    """Dense inputs with ragged real node counts and ~10% edge density."""
    rng = np.random.default_rng(seed)
    real = rng.integers(max(1, 3 * n // 4), n + 1, size=B)
    mask = np.arange(n)[None, :] < real[:, None]
    x = rng.normal(size=(B, n, F)).astype(np.float32) * mask[:, :, None]
    adj = rng.beta(2, 5, size=(B, n, n)) * (rng.random((B, n, n)) < 0.1)
    adj = (adj * mask[:, :, None] * mask[:, None, :]).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, adj, mask))


def cuda_ms(fns, iters=100, warmup=10):
    """Median CUDA-event time (ms) of each function, sampled in turns."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    events = [[] for _ in fns]
    for _ in range(iters):
        for fn, ev in zip(fns, events):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            ev.append((start, end))
    torch.cuda.synchronize()
    return [statistics.median(s.elapsed_time(e) for s, e in ev) for ev in events]


def host_ms(fns, iters=20):
    """Median host-clock time (ms) of each function ending in a
    synchronize, sampled in turns."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(iters):
        for fn, ts in zip(fns, times):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(ts) for ts in times]


def profiled(fn, iters):
    """A torch.profiler profile of ``iters`` calls of ``fn`` (after one
    unprofiled call)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof


def device_rows(prof, iters):
    """Device time (ms) per call by kernel name, largest first: CUDA-typed
    events only (a CPU op's device time repeats its kernels'), without the
    device-side ranges of user annotations such as
    ``Optimizer.step#Adam.step``, which span kernels already counted."""
    annotations = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    rows = [
        (e.key, e.self_device_time_total / 1e3 / iters)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0 and e.key not in annotations
    ]
    return sorted(rows, key=lambda r: -r[1])


def device_ms(fn, iters=20):
    """Device time (ms) per call: the kernels and copies it puts on the
    card, from torch.profiler (:func:`device_rows`)."""
    return sum(ms for _, ms in device_rows(profiled(fn, iters), iters))


def device_breakdown(fn, iters=5):
    """Device time (ms) per call by kernel name, largest first, from
    torch.profiler (:func:`device_rows`)."""
    return device_rows(profiled(fn, iters), iters)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(moved_bytes: int, ops: int, kind: str):
    """The least time (ms) the card could take: the larger of the bytes
    over HBM's rate and the operations over the peak for their type; and
    which of the two it is."""
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def band_bound(band, scales, x_in, out_numel: int, F: int, kind: str):
    """A band SpMM's bound: the band (every tile entry, zeros included),
    its scales and the activations read once, the float32 output written
    once; a multiply-add per nonzero band entry and feature, the products
    this band's data needs (counted in slices, so the count adds no
    band-sized temporary to the memory peak)."""
    return bound(nbytes(band, scales, x_in) + 4 * out_numel, 2 * F * count_nonzero(band), kind)


def count_nonzero(t) -> int:
    """Nonzero entries, counted in slices (no band-sized temporary)."""
    return sum(int(torch.count_nonzero(s)) for s in t.reshape(-1).split(1 << 26))


def fused_bound(kind, inputs, w):
    """K1's or K2's bound: inputs and weights read once, the logits written
    once; the multiply-adds of the matrix products that this batch's data
    needs (one per nonzero adjacency entry, the weight products on the real
    nodes only; the elementwise work left out, so the bound stays a lower
    bound), on the CUDA cores."""
    x, adj, mask = inputs
    B, F = x.shape[0], x.shape[2]
    nodes, edges = int(mask.sum()), int(torch.count_nonzero(adj))
    L, H = w.scale.shape
    H2, C = w.w2.shape
    widths = [F] + [H] * (L - 1)
    if kind == "gcn":  # h @ W, then adj_n @ hw
        macs = sum(nodes * fin * H + edges * H for fin in widths)
    else:  # adj @ h, then h @ W_self and agg @ W_agg
        macs = sum(edges * fin + 2 * nodes * fin * H for fin in widths)
    macs += B * (H * H2 + H2 * C)
    return bound(nbytes(*inputs, *w) + 4 * B * C, 2 * macs, "f32")


def fused_dense_macs(kind, B, n, F, H, L) -> int:
    """The multiply-adds of a padded batch's dense products (every node and
    adjacency entry of the padded graphs, the head left out)."""
    widths = [F] + [H] * (L - 1)
    if kind == "gcn":  # h @ W, then adj_n @ hw
        return B * sum(n * fin * H + n * n * H for fin in widths)
    return B * sum(n * n * fin + 2 * n * fin * H for fin in widths)  # adj @ h, two weights


def cluster_note(B, n, dev) -> str:
    """The CTAs a graph spans at this batch (a tree whose kernels have no
    cluster prints one block a graph)."""
    rule = getattr(fused, "cluster_size", None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return f"cluster {rule(B, n, sms) if rule else 1} CTA(s) a graph"


def timing_inputs_for(dev) -> dict:
    """Phase 3's inputs and weights at the timed flagship shapes."""
    out = {}
    for B in TIMED_BATCHES:
        inputs = random_dense_batch(B, 88, 5, seed=B + 88, device=dev)
        for kind, k in KERNELS.items():
            out[kind, B] = (inputs, k["weights"](make_model(kind, 5, 64, 3).to(dev)))
    return out


def main_path_setup(dev):
    """Phase 4's 64 graphs, their dense loader on the card and one trainer
    a model."""
    graphs = generate_dataset(num_subjects=64, seed=42)
    loader = ConnectomeDataLoader(graphs, batch_size=16, shuffle=False, layout="dense", device=dev)
    trainers = {kind: Trainer(make_model(kind, 5, 64, 3), device=dev) for kind in KERNELS}
    return graphs, loader, trainers


def fused_launch_alone(kind, inputs, w, L=None, cs=None):
    """K1's or K2's C entry point with its arguments ready (no wrapper), at
    the first ``L`` of the weights' layers and ``cs`` CTAs a graph (by
    default all layers and the rule's size; another tree's first-design
    entry takes its byte count instead).  Counts no launch."""
    x, adj, mask = inputs
    B, n, F = x.shape
    H, H2, C = w.scale.shape[1], w.w1.shape[1], w.w2.shape[1]
    L = w.scale.shape[0] if L is None else L
    if not hasattr(fused, "cluster_size"):  # another tree's entry: its byte count in place of cs
        size = (fused.smem_bytes(kind, n, F, H, H2),)
    else:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        size = (fused.cluster_size(B, n, sms) if cs is None else cs,)
    out = torch.empty((B, C), dtype=torch.float32, device=x.device)
    args = (*(t.data_ptr() for t in (x, adj, mask, *w, out)), B, n, F, H, H2, C, L, *size,
            torch.cuda.current_stream(x.device).cuda_stream)
    lib = _build.library()
    entry = getattr(lib, f"cgt_fused_{kind}_forward")

    def run():
        err = entry(*args)
        check(err == 0, (kind, L, cs, lib.cgt_error_string(err)))

    return run


def fused_breakdown(card, kind, B, inputs, w) -> None:
    """Phase 5's breakdown of one kernel by device time (torch.profiler,
    mean of 20): its launch alone with 0 to L layers (0: loads, degrees or
    weight sums, pool and head), and at batch 16 at every cluster size the
    graphs' tiles allow."""
    if not hasattr(fused, "cluster_size"):  # another tree's kernels take no cluster size
        return
    L, n = w.scale.shape[0], inputs[0].shape[1]
    by_layers = [device_ms(fused_launch_alone(kind, inputs, w, L=layers)) for layers in range(L + 1)]
    print(f"[5 breakdown] {card} | {kind} B={B}: the launch alone with 0..{L} layers "
          + ", ".join(f"{t:.4f}" for t in by_layers) + " ms of device time", flush=True)
    if B <= 16:
        sizes = range(1, min(fused.MAX_CLUSTER, -(-n // fused.TILE_ROWS)) + 1)
        by_size = [device_ms(fused_launch_alone(kind, inputs, w, cs=cs)) for cs in sizes]
        print(f"[5 breakdown] {card} | {kind} B={B}: the launch alone at " + ", ".join(
            f"{cs} CTA(s) a graph {t:.4f}" for cs, t in zip(sizes, by_size)) + " ms of device time", flush=True)


def fused_times(dev, card, timing_inputs, graphs, loader, trainers) -> dict:
    """Phase 5: each fused kernel at the timed batches, then ``predict``."""
    times = {}
    for (kind, B), (inputs, w) in sorted(timing_inputs.items()):
        k = KERNELS[kind]
        run_kernel = lambda: k["kernel"](*inputs, w)  # noqa: E731
        run_plain = lambda: k["plain"](*inputs, w)  # noqa: E731
        times[kind, B] = cuda_ms([run_kernel, run_plain])
        dev_kernel, dev_plain = device_ms(run_kernel), device_ms(run_plain)
        wrapper_us = host_us(run_kernel, calls=FUSED_HOST_CALLS)
        b_ms, b_by = fused_bound(kind, inputs, w)
        n, F = inputs[0].shape[1:]
        L, H = w.scale.shape
        macs = fused_dense_macs(kind, B, n, F, H, L)
        print(
            f"[5 times] {card} | {kind} B={B} n={n} H={H} L={L}, {cluster_note(B, n, dev)}: "
            f"kernel {times[kind, B][0]:.4f} ms, plain {times[kind, B][1]:.4f} ms per call (CUDA events, "
            f"median of 100, in turns); device time kernel {dev_kernel:.4f} ms, plain {dev_plain:.4f} ms "
            f"(torch.profiler, mean of 20); the wrapper's host time {wrapper_us:.1f} us a call (host clock, "
            f"mean of {FUSED_HOST_CALLS}, no sync); bound {b_ms:.5f} ms ({b_by}), "
            f"{b_ms / dev_kernel * 100:.2f} % of the device time; dense work {macs:,} multiply-adds: "
            f"{2 * macs / PEAK_OPS['f32'] * 1e3:.4f} ms at 67 TFLOP/s f32, "
            f"{6 * 2 * macs / PEAK_OPS['bf16'] * 1e3:.4f} ms as six bf16 products at 989 TFLOP/s; "
            f"library call none (no single PyTorch call)",
            flush=True,
        )
        fused_breakdown(card, kind, B, inputs, w)
    edge_messages = 3 * sum(g.num_edges for g in graphs)
    for kind, tr in trainers.items():
        fused_ms, plain_ms = host_ms(
            [lambda: tr.predict(loader), lambda: tr.predict(loader, prefer_fused=False)]
        )
        print(
            f"[5 times] {card} | {kind} predict, 64 graphs in 4 batches of 16: fused {fused_ms:.3f} ms "
            f"({64 / fused_ms * 1e3:.1f} graphs/s, {edge_messages / fused_ms * 1e3:.4g} edge-messages/s), "
            f"unfused {plain_ms:.3f} ms ({64 / plain_ms * 1e3:.1f} graphs/s) (host clock, median of 20, in turns)",
            flush=True,
        )
    return times


def host_times(card, timing_inputs, loader, trainers) -> None:
    """``--host-times``: the fused wrappers' host time alone at batch 16 and
    512, the C call alone (at the rule's cluster size and, where that is
    more than one, at one CTA a graph), and ``predict`` over the 64 graphs,
    nothing else, so that two trees can be run in many alternating
    processes on one machine."""
    for (kind, B), (inputs, w) in sorted(timing_inputs.items()):
        kernel = KERNELS[kind]["kernel"]
        us = host_us(lambda: kernel(*inputs, w), calls=FUSED_HOST_CALLS)  # noqa: B023
        alone = host_us(fused_launch_alone(kind, inputs, w), calls=FUSED_HOST_CALLS)
        one, sms = "", torch.cuda.get_device_properties(inputs[0].device).multi_processor_count
        if hasattr(fused, "cluster_size") and fused.cluster_size(B, inputs[0].shape[1], sms) > 1:
            one = f", at one CTA a graph {host_us(fused_launch_alone(kind, inputs, w, cs=1), FUSED_HOST_CALLS):.2f}"
        print(f"[5 host] {card} | {kind} B={B}: the wrapper's host time {us:.2f} us a call; the C call alone "
              f"{alone:.2f}{one} (host clock, mean of {FUSED_HOST_CALLS}, no sync)", flush=True)
    for kind, tr in trainers.items():
        (ms,) = host_ms([lambda: tr.predict(loader)])  # noqa: B023
        print(f"[5 host] {card} | {kind} predict, 64 graphs in 4 batches of 16: fused {ms:.3f} ms "
              f"(host clock, median of 20)", flush=True)


def layout_check(lib) -> None:
    """Phase 3's check that the kernels' own layout (``cgt_fused_smem_bytes``)
    fits one block for every shape the routing rule admits at cs = 1 (the
    most a CTA holds): n from 1 to 128, F in LAYOUT_FEATURES, every H up to
    the rule's largest, the model's head of H // 2."""
    checked = 0
    for kind in ("gcn", "sage"):
        sage = int(kind == "sage")
        for n in range(1, fused.MAX_FUSED_NODES + 1):
            for F in LAYOUT_FEATURES:
                H = 1
                while fused.smem_bytes(kind, n, F, H, H // 2) <= fused.SMEM_LIMIT_BYTES:
                    got = lib.cgt_fused_smem_bytes(sage, n, F, H, H // 2, 1)
                    check(got <= fused.SMEM_LIMIT_BYTES, ("layout past the limit", kind, n, F, H, got))
                    checked += 1
                    H += 1
    print(f"[3 layout] every one of {checked:,} shapes the routing rule admits (n <= 128, F in "
          f"{LAYOUT_FEATURES}, every H up to the rule's largest, H2 = H // 2) fits the kernels' own "
          f"layout at one CTA a graph", flush=True)


def rowmajor_library(rows, x_pad, block):
    """One torch.bmm over strided windows: ``rows [NB, b, D·b]`` (the band
    arranged once, receiver-major) times the view ``[NB, D·b, F]`` of the
    padded node-major frame ``x_pad [(NB + 2W)·b, F]`` that starts each
    window at its row block; no copy of x.  A bfloat16 band multiplies
    bfloat16 windows into float32."""
    nb, Db, F = rows.shape[0], rows.shape[2], x_pad.shape[1]
    windows = x_pad.as_strided((nb, Db, F), (block * F, F, 1))
    if rows.dtype == torch.bfloat16:
        return lambda: torch.bmm(rows, windows, out_dtype=torch.float32)
    return lambda: torch.bmm(rows, windows)


def fm_library(rowsT, xT_pad, block):
    """The feature-major form: the view ``[NB, F, D·b]`` of ``xT_pad [F,
    (NB + 2W)·b]`` times the transposed tiles ``[NB, D·b, b]``; bfloat16
    operands multiply into float32."""
    nb, Db = rowsT.shape[:2]
    F, ldx = xT_pad.shape
    windows = xT_pad.as_strided((nb, F, Db), (block, ldx, 1))
    if rowsT.dtype == torch.bfloat16:
        return lambda: torch.bmm(windows, rowsT, out_dtype=torch.float32)
    return lambda: torch.bmm(windows, rowsT)


def dequantized(band_q, scales):
    """The int8 band with its scales folded in, float32."""
    return band_q.to(torch.float32) * scales[:, :, None, None]


def band_rows(band):
    """Receiver-major tiles ``[NB, D, b, b]`` as one row per receiver,
    ``[NB, b, D·b]`` (a copy): the left operand of :func:`rowmajor_library`."""
    nb, D, b, _ = band.shape
    return band.permute(0, 2, 1, 3).reshape(nb, b, D * b)


def library_kernels(fn) -> str:
    """Whether one library call copies its operands: a hidden copy of the
    window view would allocate beyond the output, and would run a copy or
    elementwise kernel among those torch.profiler sees.  Resets the
    memory peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - nbytes(out)
    del out
    names = [name for name, _ in device_breakdown(fn, iters=2)]
    copies = [nm for nm in names if any(w in nm.lower() for w in ("copy", "memcpy", "elementwise"))]
    seen = f"kernels {[nm[:60] for nm in names]}" if names else "no kernel seen by torch.profiler"
    return f"{seen}; copy kernels: {copies or 'none'}; allocated beyond the output: {extra:,} B"


def fm_launch_alone(kid, q, xT):
    """Role B's launch over the int8 band on the operands K4's wrapper hands
    it: at the main shape the band and ``xT`` as they are (checked)."""
    x, x_block, x_cols = band_mma.fm_x_operand(xT, q.num_nodes, q.num_blocks, q.block)
    check(x is xT and band_mma.pad_band(q.band_qT) is q.band_qT, (kid, "the wrapper copies its operands"))
    return lambda: band_mma.launch_fm_int8(kid, q.band_qT, q.scales, xT, x_block, x_cols, q.num_nodes,
                                           q.bandwidth, q.block)


def k5_launch_alone(kid, q, xT):
    """K5's launch alone on the operands its wrapper hands it (at the main
    shape the band and the int8 frame as they are, checked), its output the
    wrapper's bit for bit; and the activation quantization in torch alone."""
    xq, xscales = bq.quantize_activations_padded(q, xT)
    check(band_mma.fm_frame(xq, q.num_blocks, q.bandwidth, q.block) is xq
          and band_mma.pad_band(q.band_qT) is q.band_qT, (kid, "the wrapper copies its operands"))
    launch = lambda: band_mma.launch_w8a8(kid, q.band_qT, q.scales, xq, xscales, q.num_nodes,  # noqa: E731
                                          q.bandwidth, q.block)
    out = launch()
    check(torch.equal(out, bq.banded_spmm_quant_fm_w8a8_kernel(q, xT)), (kid, "launch alone != wrapper"))
    check(torch.equal(out, bq.banded_spmm_quant_fm_w8a8_reference(q, xT)), (kid, "launch alone != plain"))
    print(f"[10 K5] the launch alone at {q.num_nodes:,} nodes: bit for bit the wrapper's output and the "
          f"plain version's", flush=True)
    return launch, lambda: bq.quantize_activations_padded(q, xT)


def launch_note(operands: str, ms: float, bound_ms: float, band) -> str:
    """The launch alone's time, its share of the bound and the rate at which
    it streams the band (the band's bytes over its time)."""
    return (f"the launch alone {operands} {ms:.4f} ms, {bound_ms / ms:.1%} of the bound, the band "
            f"({nbytes(band) / 1e9:.4g} GB) at {nbytes(band) / ms / 1e9:.4g} TB/s")


def random_quantized_band(nb, W, block, n, seed, device):
    """A random NON-symmetric int8 band (70 % zeros; tile (0, 0) all zero
    with scale 1), so a swapped tile axis cannot go unseen."""
    rng = np.random.default_rng(seed)
    shape = (nb, 2 * W + 1, block, block)
    q = (rng.integers(-127, 128, shape) * (rng.random(shape) < 0.3)).astype(np.int8)
    scales = rng.uniform(1e-3, 1.1e-2, shape[:2]).astype(np.float32)
    q[0, 0], scales[0, 0] = 0, 1.0
    return bq.QuantizedBandedMatrix(
        torch.from_numpy(q).to(device), torch.from_numpy(scales).to(device), n, W
    )


def check_band_kernel(kid, q, x) -> float:
    """One band kernel (K3-K6, K4's backward) against its plain version on
    the same operands (K5 bit for bit); returns max |kernel - plain|."""
    k = {**BAND_KERNELS, **TRAIN_KERNELS}[kid]
    got = k["kernel"](q, x)
    torch.cuda.synchronize()
    want = k["plain"](q, x)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()), (kid, tuple(got.shape)))
    if k.get("exact"):
        check(torch.equal(got, want), (kid, "not the plain version bit for bit"))
    else:
        torch.testing.assert_close(got, want, rtol=BAND_RTOL, atol=BAND_ATOL)
    return float((got - want).abs().max())


def k5_saturated_check(dev) -> None:
    """K5 on a non-symmetric band and x of ±127 at b = 256, one tile all
    +127 against a frame block all +127 (a dot of 127²·256, the largest the
    block allows): bit for bit its plain version."""
    nb, W, block, F = 6, 2, 256, 64
    n = nb * block - 37
    rng = np.random.default_rng(12)
    band = (127 * rng.choice([-1, 1], (nb, 2 * W + 1, block, block))).astype(np.int8)
    band[2, W] = 127
    band[3, W + 1] = np.triu(np.full((block, block), 127, np.int8))
    scales = rng.uniform(1e-3, 1.1e-2, (nb, 2 * W + 1)).astype(np.float32)
    q = bq.QuantizedBandedMatrixFM(torch.from_numpy(band).to(dev), torch.from_numpy(scales).to(dev), n, W)
    xT = torch.from_numpy(rng.choice([-3.0, 3.0], (F, n)).astype(np.float32)).to(dev)
    xT[:, 2 * block:3 * block] = 3.0
    xq, _ = bq.quantize_activations_padded(q, xT)
    check(int(xq[:, W * block:(W + nb) * block - 37].abs().min()) == 127, "K5 saturated: x not at ±127")
    err = check_band_kernel("K5", q, xT)
    print(f"[7 band kernel] K5 on a saturated band and x of ±127, NB={nb} W={W} b={block} n={n} F={F} "
          f"(a dot of 127²·{block} = {127 * 127 * block:,}): bit for bit its plain version "
          f"(max|kernel-plain| = {err:.3e})", flush=True)


def k4_nonfinite_check(dev) -> None:
    """K4, and its backward launch over the transposed band, with an Inf and
    a NaN of x in one interior node block k, at blocks that are not
    multiples of 64 (a 64-sender stage reaches into the next node blocks)
    and each W: equal to the plain version NaN for NaN at 1e-5, and finite
    in every row block that does not read block k, as the plain version is."""
    nb, F, worst, runs = 12, 8, 0.0, 0
    k = nb // 2
    for block in NONFINITE_BLOCKS:
        for W in NONFINITE_WS:
            n = nb * block - 5
            q = random_quantized_band(nb, W, block, n, seed=block + W, device=dev)
            rng = np.random.default_rng(block + W)
            xT = torch.from_numpy(rng.standard_normal((F, n)).astype(np.float32)).to(dev)
            reads_k = (torch.arange(n, device=dev) // block - k).abs() <= W
            for value in (float("inf"), float("nan")):
                x = xT.clone()
                x[2, k * block + 3] = value
                for kid, qf in (("K4", bq.to_feature_major(q)),
                                ("K4 backward", bq.transposed_feature_major(q))):
                    kern = {**BAND_KERNELS, **TRAIN_KERNELS}[kid]
                    got = kern["kernel"](qf, x)
                    torch.cuda.synchronize()
                    want = kern["plain"](qf, x)
                    what = (kid, block, W, value)
                    torch.testing.assert_close(got, want, rtol=BAND_RTOL, atol=BAND_ATOL, equal_nan=True,
                                               msg=str(what))
                    check(bool(torch.isfinite(got[:, ~reads_k]).all()), ("non-finite past block k",) + what)
                    check(not bool(torch.isfinite(want[:, reads_k]).all()), ("nothing read it",) + what)
                    both = torch.isfinite(got) & torch.isfinite(want)
                    worst = max(worst, float((got - want)[both].abs().max()))
                    runs += 1
    print(f"[10 K4 non-finite] K4 and K4 over the transposed band, an Inf and a NaN of x at node "
          f"{k} * b + 3, blocks {NONFINITE_BLOCKS}, W in {NONFINITE_WS}: {runs} launches equal to the plain "
          f"version NaN for NaN (largest finite |kernel-plain| {worst:.3e}), every row block with "
          f"|rb - {k}| > W finite", flush=True)


def reset_counters() -> None:
    for k in COUNTERS.values():
        k.launches = 0


def counts() -> dict:
    return {kid: k.launches for kid, k in COUNTERS.items()}


def quant_gate(got, want, gate):
    """Relative Frobenius error and argmax agreement of quantized against
    float32 logits, held to the gate."""
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    agree = float((got.argmax(1) == want.argmax(1)).float().mean())
    max_rel, min_agree = GATES[gate]
    check(rel < max_rel and agree > min_agree, (gate, rel, agree))
    return rel, agree


def make_node_model(cls, device, seed=0):
    model = cls(
        in_channels=GIANT["in_channels"], hidden_dim=GIANT["hidden"], num_classes=2,
        num_layers=GIANT["layers"], generator=torch.Generator().manual_seed(seed),
    )
    randomize_batch_norms(model, np.random.default_rng(seed))
    return model.to(device).eval()


def hybrid_operands(n: int, dev):
    """The 5qs graph with 10 % shortcut edges as a hybrid matrix on the card
    (band W = 2 plus the COO remainder), its node features, its edge count."""
    g = generate_spatial_graph(
        n, degree=GIANT["degree"], band=GIANT["band"], num_features=GIANT["in_channels"],
        seed=3, shortcut_frac=0.1,
    )
    h = to_hybrid(g.edge_index[0], g.edge_index[1], g.edge_weight, n, block=GIANT["block"],
                  bandwidth=2, device=dev)
    return h, torch.from_numpy(g.node_features).to(dev), g.num_edges


@torch.no_grad()
def time_forwards(card, gcn, runs) -> None:
    """``apply_quantized`` ms per forward against its plain path (host clock
    ending in a synchronize, median of 10, in turns), edge-messages/s, the
    memory peak and the device time by kernel, for each (label, prepared
    adjacency, norm, x, edges, keywords)."""
    L = GIANT["layers"]
    for label, adj_q, norm, x, E, kw in runs:
        forward = lambda: gcn.apply_quantized(adj_q, norm, x, **kw)  # noqa: E731
        plain = lambda: gcn.apply_quantized(adj_q, norm, x, plain=True, **kw)  # noqa: E731
        torch.cuda.reset_peak_memory_stats()
        fwd_ms, plain_ms = host_ms([forward, plain], iters=10)
        serve_peak = torch.cuda.max_memory_allocated()
        rows = device_breakdown(forward)
        busy = sum(ms for _, ms in rows)
        print(
            f"[10 times] {card} | GCN apply_quantized {label}, {x.shape[0]:,} nodes, L={L}: "
            f"{fwd_ms:.3f} ms/forward ({L * E / fwd_ms * 1e3:.4g} edge-messages/s); plain path "
            f"{plain_ms:.3f} ms/forward (host clock, median of 10, in turns); device busy "
            f"{busy:.3f} ms/forward ({busy / fwd_ms:.1%} of its wall time); "
            f"max_memory_allocated {serve_peak:,} B",
            flush=True,
        )
        for name, ms in rows[:10]:
            print(f"[10 times] {card} |     {ms:9.4f} ms/forward  {name[:200]}", flush=True)


@torch.no_grad()
def serving_forwards(dev, card) -> None:
    """``--serving-forwards``: phase 6's band and phase 8's hybrid graph,
    prepared for GCN serving, and phase 10's forwards alone, through the
    public API only, so that the package of another tree (on ``sys.path``
    first) is timed by the same code."""
    n, block = GIANT["num_nodes"], GIANT["block"]
    graph = generate_spatial_graph(n, degree=GIANT["degree"], band=GIANT["band"],
                                   num_features=GIANT["in_channels"], seed=0)
    a = to_banded(graph.edge_index[0], graph.edge_index[1], graph.edge_weight, n, block=block, device=dev)
    x = torch.from_numpy(graph.node_features).to(dev)
    gcn = make_node_model(BandedNodeGCN, dev)
    q_fm, dinv = gcn.prepare_quantized(a)
    q_rm, _ = gcn.prepare_quantized(a, feature_major=False)
    del a
    h, xh, E_h = hybrid_operands(n, dev)
    hq, hdinv = gcn.prepare_quantized(h)
    del h
    E = graph.num_edges
    time_forwards(card, gcn, [("feature-major", q_fm, dinv, x, E, {}), ("w8a8", q_fm, dinv, x, E, {"w8a8": True}),
                              ("row-major", q_rm, dinv, x, E, {}), ("hybrid", hq, hdinv, xh, E_h, {})])


@torch.no_grad()
def giant_graph_phases(dev, card):
    """Phases 6-10; returns the band kernels' entries of the JSON line and
    the host graph."""
    L, block = GIANT["layers"], GIANT["block"]

    # 6. the band, built on the card
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph = generate_spatial_graph(
        GIANT["num_nodes"], degree=GIANT["degree"], band=GIANT["band"],
        num_features=GIANT["in_channels"], seed=0,
    )
    t_gen = time.perf_counter() - t0
    n, E = graph.num_nodes, graph.num_edges
    t0 = time.perf_counter()
    a = to_banded(graph.edge_index[0], graph.edge_index[1], graph.edge_weight, n, block=block,
                  device=dev)
    torch.cuda.synchronize()
    t_band = time.perf_counter() - t0
    check(a.bandwidth == 2 and a.num_blocks * block == n, (a.bandwidth, a.num_blocks))
    x = torch.from_numpy(graph.node_features).to(dev)
    xT = x.T.contiguous()
    gcn, sage = make_node_model(BandedNodeGCN, dev), make_node_model(BandedNodeSAGE, dev)
    f32 = {"gcn": gcn(a, x), "sage": sage(a, x)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_fm, dinv = gcn.prepare_quantized(a)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    q_rm, _ = gcn.prepare_quantized(a, feature_major=False)
    sage_q, w_sum = sage.prepare_quantized(a)
    f32_bytes = a.band.numel() * 4
    del a  # the float32 band: only the int8 bands serve
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(
        f"[6 band] {card} | {n:,} nodes, {E:,} edges, W={q_fm.bandwidth}, block {block}: "
        f"f32 band {f32_bytes:,} B, int8 band {q_fm.band_qT.numel():,} B; "
        f"generate {t_gen:.2f} s (host), to_banded {t_band:.2f} s (card), "
        f"GCN prepare_quantized {t_prep:.3f} s; max_memory_allocated {peak:,} B; "
        f"f32 band freed, {torch.cuda.memory_allocated():,} B now allocated",
        flush=True,
    )

    # 7. each band kernel against its plain version
    max_err = dict.fromkeys(BAND_KERNELS, 0.0)
    for shape in BAND_SHAPES:
        nb, W, b, nodes, F = shape
        q = random_quantized_band(nb, W, b, nodes, seed=sum(shape), device=dev)
        xs = torch.from_numpy(
            np.random.default_rng(nodes + F).standard_normal((nodes, F)).astype(np.float32)
        ).to(dev)
        errs = {}
        for kid, k in BAND_KERNELS.items():
            operands = (bq.to_feature_major(q), xs.T.contiguous()) if k["feature_major"] else (q, xs)
            errs[kid] = check_band_kernel(kid, *operands)
            max_err[kid] = max(max_err[kid], errs[kid])
        print(f"[7 band kernel] NB={nb} W={W} b={b} n={nodes} F={F}, random non-symmetric band: "
              + ", ".join(f"{kid} max|kernel-plain| = {e:.3e}" for kid, e in errs.items()), flush=True)
    for shape in MMA_SHAPES:
        nb, W, b, nodes, F = shape
        q = random_quantized_band(nb, W, b, nodes, seed=sum(shape), device=dev)
        xs = torch.from_numpy(
            np.random.default_rng(nodes + F).standard_normal((nodes, F)).astype(np.float32)
        ).to(dev)
        errs = {"K3": check_band_kernel("K3", q, xs),
                "K4": check_band_kernel("K4", bq.to_feature_major(q), xs.T.contiguous()),
                "K5": check_band_kernel("K5", bq.to_feature_major(q), xs.T.contiguous())}
        for kid, err in errs.items():
            max_err[kid] = max(max_err[kid], err)
        print(f"[7 band kernel] NB={nb} W={W} b={b} n={nodes} F={F}, random non-symmetric band: "
              + ", ".join(f"{kid} max|kernel-plain| = {e:.3e}" for kid, e in errs.items()), flush=True)
    k5_saturated_check(dev)
    full = {"K3": (q_rm, x), "K4": (q_fm, xT), "K5": (q_fm, xT)}
    for kid, operands in full.items():
        err = check_band_kernel(kid, *operands)
        max_err[kid] = max(max_err[kid], err)
        print(f"[7 band kernel] {kid} at {n:,} nodes, F={x.shape[1]}, the prepared GCN band: "
              f"max|kernel-plain| = {err:.3e}", flush=True)

    # 8. the giant serving path
    h, xh, E_h = hybrid_operands(n, dev)
    remainder = int((h.remainder_weights > 0).sum())
    f32["hybrid"] = gcn(h, xh)
    hq, hdinv = gcn.prepare_quantized(h)
    del h
    runs = [
        ("GCN feature-major", gcn, q_fm, dinv, x, {}, "K4", "gcn", "bf16"),
        ("GCN w8a8", gcn, q_fm, dinv, x, {"w8a8": True}, "K5", "gcn", "w8a8"),
        ("GCN row-major", gcn, q_rm, dinv, x, {}, "K3", "gcn", "bf16"),
        (f"GCN hybrid ({remainder:,} remainder edges)", gcn, hq, hdinv, xh, {}, "K3", "hybrid", "bf16"),
        ("SAGE feature-major", sage, sage_q, w_sum, x, {}, "K4", "sage", "bf16"),
    ]
    torch.cuda.synchronize()
    reset_counters()
    logits = {}
    for label, model, adj_q, norm, inputs, kw, kid, ref, gate in runs:
        before = counts()
        logits[label] = model.apply_quantized(adj_q, norm, inputs, **kw)
        torch.cuda.synchronize()
        delta = {k: c - before[k] for k, c in counts().items()}
        check(delta == {k: L if k == kid else 0 for k in COUNTERS}, (label, delta))
    launches = counts()
    for label, model, adj_q, norm, inputs, kw, kid, ref, gate in runs:
        out = logits[label]
        check(out.shape == (n, 2) and bool(torch.isfinite(out).all()), (label, tuple(out.shape)))
        plain = model.apply_quantized(adj_q, norm, inputs, plain=True, **kw)
        torch.testing.assert_close(out, plain, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        rel, agree = quant_gate(out, f32[ref], gate)
        print(
            f"[8 giant serving] {label}: logits {tuple(out.shape)} finite, {kid} launches {L}, "
            f"max|kernels-plain| = {float((out - plain).abs().max()):.3e}; against f32: "
            f"relative error {rel:.4e}, argmax agreement {agree:.5f}",
            flush=True,
        )
    del f32, logits

    # 9. RCM at the demo size
    demo_n = 20_000
    demo = generate_spatial_graph(demo_n, degree=12, band=256, seed=0)
    scrambled = apply_ordering(demo, np.random.default_rng(0).permutation(demo_n))
    t0 = time.perf_counter()
    recovered = apply_ordering(scrambled, reverse_cuthill_mckee(scrambled.edge_index, demo_n))
    t_rcm = time.perf_counter() - t0
    before_bw, after_bw = bandwidth(scrambled.edge_index), bandwidth(recovered.edge_index)
    check(after_bw < before_bw // 4, (before_bw, after_bw))
    banded = to_banded(recovered.edge_index[0], recovered.edge_index[1], recovered.edge_weight,
                       demo_n, block=128, device=dev)
    print(f"[9 RCM] {demo_n:,} nodes, {demo.num_edges:,} edges: scrambled bandwidth {before_bw:,}, "
          f"RCM bandwidth {after_bw:,} ({t_rcm:.2f} s host); banded at block 128: "
          f"W={banded.bandwidth}, {banded.num_blocks} row blocks", flush=True)

    # 10. K4's reads past its node block, then times (nothing asserted but
    # K5's launch alone, bit for bit)
    k4_nonfinite_check(dev)
    times, bounds, lib_ms = {}, {}, {}
    for kid, (q, xin) in full.items():
        k = BAND_KERNELS[kid]
        run_kernel = lambda k=k, q=q, xin=xin: k["kernel"](q, xin)  # noqa: E731
        run_plain = lambda k=k, q=q, xin=xin: k["plain"](q, xin)  # noqa: E731
        band = q.band_qT if k["feature_major"] else q.band_q
        xread = xin[:, :n] if k["feature_major"] else xin[:n]
        bounds[kid] = band_bound(band, q.scales, xread, n * x.shape[1], x.shape[1],
                                 "int8" if kid == "K5" else "bf16")
        fns, lib_note = [run_kernel, run_plain], NO_LIBRARY
        if kid == "K3":  # receiver-major rows against node-major windows
            rows = band_rows(dequantized(q.band_q, q.scales))
            xpad = pad_blocks(x.to(torch.bfloat16).to(torch.float32), q.num_blocks, q.bandwidth,
                              block).reshape(-1, x.shape[1])
            fns.append(rowmajor_library(rows, xpad, block))
        elif kid == "K4":  # feature-major windows against the transposed tiles
            rows = dequantized(q.band_qT, q.scales).reshape(q.num_blocks, -1, block)
            xpad = bq._pad_fm(xT, q.num_blocks, q.bandwidth, block, torch.bfloat16).to(torch.float32)
            fns.append(fm_library(rows, xpad, block))
        alone_note = ""
        if kid == "K3":  # the launch alone, on the operands the wrapper prepares
            band_p = band_mma.pad_band(q.band_q)
            frame = band_mma.rowmajor_frame(x, n, q.num_blocks, q.bandwidth, block)
            fns.append(lambda: band_mma.launch_rowmajor(kid, band_p, frame, n, q.bandwidth, block,
                                                         x.shape[1], q.scales))
        elif kid == "K4":  # the launch alone: at this shape the wrapper passes band and xT as they are
            fns.append(fm_launch_alone(kid, q, xin))
        else:  # K5: the launch alone on the band and the int8 frame, then the quantization alone
            fns += k5_launch_alone(kid, q, xin)
        ms = cuda_ms(fns, iters=20, warmup=3)
        times[kid], lib_ms[kid] = ms[:2], (ms[2] if kid != "K5" else None)
        if kid in ("K3", "K4"):
            alone_note = "; " + launch_note(
                "on the padded band and the bf16 frame" if kid == "K3" else "on the band and f32 xT",
                ms[3], bounds[kid][0], band)
        else:
            alone_note = ("; " + launch_note("on the band and the int8 frame (bit for bit the wrapper's)",
                                             ms[2], bounds[kid][0], band)
                          + f"; the activation quantization in torch alone {ms[3]:.4f} ms")
        if kid == "K3":
            del band_p, frame
        if lib_ms[kid] is not None:
            lib_note = (f"{lib_ms[kid]:.4f} ms, one torch.bmm over the dequantized band and x rounded "
                        f"to bf16 ({library_kernels(fns[2])})")
            del rows, xpad, fns
        (alone,) = cuda_ms([run_kernel], iters=20, warmup=3)
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, check=True,
        ).stdout.strip()
        dev_kernel, dev_plain = device_ms(run_kernel, iters=5), device_ms(run_plain, iters=5)
        print(
            f"[10 times] {card} | {kid} {k['name']} at {n:,} nodes, F={GIANT['in_channels']}: "
            f"kernel {times[kid][0]:.4f} ms, plain {times[kid][1]:.4f} ms per call (CUDA events, "
            f"median of 20, in turns; kernel back to back {alone:.4f} ms; then SM clock, max "
            f"clock, power, temperature: {clocks}); "
            f"device time kernel {dev_kernel:.4f} ms, plain {dev_plain:.4f} ms (torch.profiler, "
            f"mean of 5); kernel {E / times[kid][0] / 1e6:.4g} G edges/s; bound {bounds[kid][0]:.4f} ms "
            f"({bounds[kid][1]}), {bounds[kid][0] / times[kid][0]:.1%} of it{alone_note}; library call "
            f"{lib_note}",
            flush=True,
        )
    time_forwards(card, gcn, [("feature-major", q_fm, dinv, x, E, {}), ("w8a8", q_fm, dinv, x, E, {"w8a8": True}),
                              ("row-major", q_rm, dinv, x, E, {}), ("hybrid", hq, hdinv, xh, E_h, {})])
    del hq, hdinv, xh

    return [
        {
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": launches[kid], "max_abs_err": max_err[kid],
            "ms": times[kid][0], "plain_ms": times[kid][1], "bound_ms": bounds[kid][0],
            "bound_by": bounds[kid][1], "library_ms": lib_ms[kid],
        }
        for kid, k in BAND_KERNELS.items()
    ], graph


def grad_step(model, forward, labels):
    """One forward and backward; returns (loss, {name: gradient})."""
    model.zero_grad(set_to_none=True)
    loss = F.cross_entropy(forward(model), labels)
    loss.backward()
    return loss.detach(), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def flat(grads) -> torch.Tensor:
    return torch.cat([g.reshape(-1) for _, g in sorted(grads.items())])


def train_setup(dev, card, graph):
    """Phase 11: the band rebuilt on the card, a fresh ``BandedNodeGCN`` from
    seed 0, ``prepare`` and ``prepare_quant_trainable``, through the public
    API only; returns the model, the normalized float32 band, ``dinv``, the
    int8 band and its transpose, and the memory peak."""
    L, block, n, E = GIANT["layers"], GIANT["block"], graph.num_nodes, graph.num_edges
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        a = to_banded(graph.edge_index[0], graph.edge_index[1], graph.edge_weight, n, block=block,
                      device=dev)
    torch.cuda.synchronize()
    t_band = time.perf_counter() - t0
    model0 = BandedNodeGCN(
        in_channels=GIANT["in_channels"], hidden_dim=GIANT["hidden"], num_classes=2,
        num_layers=L, generator=torch.Generator().manual_seed(0),
    ).to(dev).train()
    t0 = time.perf_counter()
    adj_norm, dinv = model0.prepare(a)
    torch.cuda.synchronize()
    t_norm = time.perf_counter() - t0
    t0 = time.perf_counter()
    q, qT, dinv_q = model0.prepare_quant_trainable(a)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    check(torch.equal(dinv, dinv_q), "prepare and prepare_quant_trainable disagree on dinv")
    del a, dinv_q
    setup_peak = torch.cuda.max_memory_allocated()
    print(f"[11 train set-up] {card} | {n:,} nodes, {E:,} edges: to_banded {t_band:.2f} s (card), prepare "
          f"(f32 normalized band, {adj_norm.band.numel() * 4:,} B) {t_norm:.3f} s, "
          f"prepare_quant_trainable (int8 band and its transpose, 2 x {q.band_qT.numel():,} B) "
          f"{t_prep:.3f} s; max_memory_allocated {setup_peak:,} B; raw band freed, "
          f"{torch.cuda.memory_allocated():,} B now allocated", flush=True)
    return model0, adj_norm, dinv, q, qT, setup_peak


def train_paths(q, qT, adj_norm, dinv, x) -> dict:
    """The train-step forwards: feature-major (K4) and blocked (K6) over the
    int8 band, ``plain=True`` for their plain paths, and float32."""
    return {
        "feature-major": lambda m, plain=False: m.apply_quant_trainable(q, qT, dinv, x, plain=plain),
        "blocked": lambda m, plain=False: m.apply_quant_trainable_blocked(q, qT, dinv, x, plain=plain),
        "float32": lambda m, plain=False: m.apply_normalized(adj_norm, dinv, x),
    }


def time_train_steps(card, model0, forwards: dict, labels, E: int) -> dict:
    """Adam steps (lr 1e-3, mean cross-entropy over all nodes) through each
    forward, from copies of ``model0``: ms per step (host clock ending in a
    synchronize, median of 10, in turns) and edge-messages/s; returns the
    times and the steppers."""
    L, n = GIANT["layers"], labels.shape[0]
    steppers = {}
    for label, forward in forwards.items():
        model = copy.deepcopy(model0)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)

        def step(model=model, opt=opt, forward=forward):
            opt.zero_grad(set_to_none=True)
            F.cross_entropy(forward(model), labels).backward()
            opt.step()

        steppers[label] = step
    step_ms = dict(zip(steppers, host_ms(list(steppers.values()), iters=10)))
    for label, ms in step_ms.items():
        print(f"[16 times] {card} | train step {label}, {n:,} nodes, L={L}: {ms:.3f} ms/step "
              f"({L * E / ms * 1e3:.4g} edge-messages/s) (host clock, median of 10, in turns)",
              flush=True)
    return step_ms, steppers


def step_breakdowns(card, steppers: dict, step_ms: dict, labels) -> None:
    """Each step's device time by kernel (torch.profiler, mean of 3)."""
    for label in labels:
        rows = device_breakdown(steppers[label], iters=3)
        busy = sum(ms for _, ms in rows)
        print(f"[16 times] {card} | train step {label}: device busy {busy:.3f} ms/step "
              f"({busy / step_ms[label]:.1%} of the unprofiled step time; torch.profiler, mean of 3)",
              flush=True)
        for name, ms in rows[:12]:
            print(f"[16 times] {card} |     {ms:9.4f} ms/step  {name[:200]}", flush=True)


def train_steps(dev, card) -> None:
    """``--train-steps``: phase 11's set-up and phase 16's step times
    (feature-major, blocked, float32) with their device breakdowns, alone,
    through the public API only, so that the package of another tree (on
    ``sys.path`` first) is timed by the same code."""
    n = GIANT["num_nodes"]
    graph = generate_spatial_graph(n, degree=GIANT["degree"], band=GIANT["band"],
                                   num_features=GIANT["in_channels"], seed=0)
    model0, adj_norm, dinv, q, qT, _ = train_setup(dev, card, graph)
    x = torch.from_numpy(graph.node_features).to(dev)
    labels = torch.from_numpy(np.random.default_rng(2).integers(0, 2, n)).to(dev)
    step_ms, steppers = time_train_steps(card, model0, train_paths(q, qT, adj_norm, dinv, x), labels,
                                         graph.num_edges)
    step_breakdowns(card, steppers, step_ms, step_ms)


def giant_training_phases(dev, card, graph) -> list[dict]:
    """Phases 11-16; returns the training kernels' entries of the JSON line."""
    L, block, n, E = GIANT["layers"], GIANT["block"], graph.num_nodes, graph.num_edges

    # 11. set-up
    model0, adj_norm, dinv, q, qT, setup_peak = train_setup(dev, card, graph)
    x = torch.from_numpy(graph.node_features).to(dev)
    xT = x.T.contiguous()
    nb, W = q.num_blocks, q.bandwidth

    # 12. K6 and K4 over the transposed band against their plain versions
    max_err = dict.fromkeys(TRAIN_KERNELS, 0.0)
    with torch.no_grad():
        for shape in BAND_SHAPES + MMA_SHAPES:
            snb, sW, sb, snodes, sF = shape
            q_row = random_quantized_band(snb, sW, sb, snodes, seed=sum(shape), device=dev)
            xb_pad = torch.from_numpy(np.random.default_rng(snodes + sF).standard_normal(
                (snb + 2 * sW, sF, sb)).astype(np.float32)).to(dev)
            err = check_band_kernel("K6", bq.to_feature_major(q_row), xb_pad)
            max_err["K6"] = max(max_err["K6"], err)
            print(f"[12 train kernel] NB={snb} W={sW} b={sb} n={snodes} F={sF}, random non-symmetric "
                  f"band, the whole padded frame random: K6 max|kernel-plain| = {err:.3e}", flush=True)
        xb_full = bq._pad_blocked(bq.to_blocked(torch.nn.functional.pad(xT, (0, nb * block - n)),
                                                block), W)
        full = {"K6": (q, xb_full), "K4 backward": (qT, xT)}
        for kid, operands in full.items():
            err = check_band_kernel(kid, *operands)
            max_err[kid] = max(max_err[kid], err)
            print(f"[12 train kernel] {kid} at {n:,} nodes, F={xT.shape[0]}, the prepared "
                  f"{'transposed ' if kid == 'K4 backward' else ''}band: max|kernel-plain| = "
                  f"{err:.3e}", flush=True)

    # 13. the gradient of each trainable op at a small shape
    snb, sW, sb, snodes, sF = BAND_SHAPES[-1]
    q_row = random_quantized_band(snb, sW, sb, snodes, seed=11, device=dev)
    sq, sqT = bq.to_feature_major(q_row), bq.transposed_feature_major(q_row)
    rng = np.random.default_rng(12)
    xs, cot = (torch.from_numpy(rng.standard_normal((sF, snodes)).astype(np.float32)).to(dev)
               for _ in range(2))
    grads = {}
    for label, op, arg, c in (
        ("feature-major", bq.banded_spmm_quant_fm_grad, xs, cot),
        ("blocked", bq.banded_spmm_quant_blocked_grad,
         bq.to_blocked(torch.nn.functional.pad(xs, (0, snb * sb - snodes)), sb),
         bq.to_blocked(torch.nn.functional.pad(cot, (0, snb * sb - snodes)), sb)),
    ):
        outs = []
        for plain in (False, True):
            v = arg.clone().requires_grad_()
            out = op(sq, sqT, v, plain=plain)
            (out * c).sum().backward()
            torch.cuda.synchronize()
            outs.append((out.detach(), v.grad))
        for got, want in zip(*outs):
            torch.testing.assert_close(got, want, rtol=BAND_RTOL, atol=BAND_ATOL)
        grads[label] = outs[0][1]
        print(f"[13 train op] {label} at NB={snb} W={sW} b={sb} n={snodes} F={sF}: forward and "
              f"activation gradient, kernels against plain=True: max|diff| = "
              f"{max(float((g - w).abs().max()) for g, w in zip(*outs)):.3e}", flush=True)
    g_blocked = bq.from_blocked(grads["blocked"])[:, :snodes]
    torch.testing.assert_close(g_blocked, grads["feature-major"], rtol=BAND_RTOL, atol=BAND_ATOL)
    print(f"[13 train op] blocked against feature-major activation gradient: max|diff| = "
          f"{float((g_blocked - grads['feature-major']).abs().max()):.3e}", flush=True)

    # 14. the main path: one Adam step each way
    labels = torch.from_numpy(np.random.default_rng(2).integers(0, 2, n)).to(dev)
    forwards = train_paths(q, qT, adj_norm, dinv, x)
    paths = {label: forwards[label] for label in ("feature-major", "blocked")}
    expected = {"feature-major": {"K4": 2 * L, "K4 backward": L},
                "blocked": {"K6": 2 * L}}
    f32_loss, f32_grads = grad_step(copy.deepcopy(model0), forwards["float32"], labels)
    launched = {}
    for label, forward in paths.items():
        model = copy.deepcopy(model0)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        torch.cuda.synchronize()
        reset_counters()
        loss, step_grads = grad_step(model, forward, labels)
        opt.step()
        torch.cuda.synchronize()
        launched[label] = counts()
        check(launched[label] == {kid: expected[label].get(kid, 0) for kid in COUNTERS},
              (label, launched[label]))
        check(bool(torch.isfinite(loss)), (label, "loss", float(loss)))
        plain_loss, plain_grads = grad_step(copy.deepcopy(model0),
                                            lambda m: forward(m, plain=True), labels)
        torch.testing.assert_close(loss, plain_loss, rtol=STEP_RTOL, atol=STEP_ATOL)
        for name, g in step_grads.items():
            torch.testing.assert_close(g, plain_grads[name], rtol=STEP_RTOL, atol=STEP_ATOL,
                                       msg=f"{label} {name}")
        loss_rel = float((loss - f32_loss).abs() / f32_loss.abs())
        grad_rel = float(torch.linalg.norm(flat(step_grads) - flat(f32_grads))
                         / torch.linalg.norm(flat(f32_grads)))
        check(loss_rel < TRAIN_GATES[0] and grad_rel < TRAIN_GATES[1], (label, loss_rel, grad_rel))
        moved = []
        for bn, bn0 in zip(model.batch_norms, model0.batch_norms):
            for buf in ("running_mean", "running_var"):
                new, old = getattr(bn, buf), getattr(bn0, buf)
                check(bool(torch.isfinite(new).all()) and not torch.equal(new, old), (label, buf))
                moved.append(float((new - old).abs().max()))
        print(
            f"[14 giant training] {label}: one Adam step, loss {float(loss):.6f}, launches "
            f"{ {k: v for k, v in launched[label].items() if v} }; against plain=True: |loss diff| "
            f"{float((loss - plain_loss).abs()):.3e}, max|grad diff| "
            f"{max(float((g - plain_grads[k]).abs().max()) for k, g in step_grads.items()):.3e}; "
            f"against float32 (loss {float(f32_loss):.6f}): loss relative difference "
            f"{loss_rel:.3e}, gradient relative Frobenius error {grad_rel:.3e}; running moments "
            f"finite, moved by up to {max(moved):.3e}",
            flush=True,
        )

    # 15. a short run on learnable labels
    with torch.no_grad():
        agg = banded_spmm(adj_norm, x[:, :1])[:, 0]
    learnable = (agg > agg.median()).long()
    losses = {}
    for label, forward in forwards.items():
        model = copy.deepcopy(model0)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        losses[label] = []
        for _ in range(8):
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(forward(model), learnable)
            loss.backward()
            opt.step()
            losses[label].append(loss.item())
    for label in paths:
        lq, lf = losses[label], losses["float32"]
        check(lq[-1] < lq[0] and abs(lq[-1] - lf[-1]) < 0.05, (label, lq, lf))
        print(f"[15 short run] {label}, 8 Adam steps (lr 1e-3) on learnable labels: loss "
              f"{lq[0]:.5f} -> {lq[-1]:.5f}; float32 {lf[0]:.5f} -> {lf[-1]:.5f}; final "
              f"|int8 - f32| = {abs(lq[-1] - lf[-1]):.3e}", flush=True)

    # 16. times (nothing asserted)
    torch.cuda.reset_peak_memory_stats()
    step_ms, steppers = time_train_steps(
        card, model0, {**paths, "plain path (feature-major)": lambda m: paths["feature-major"](m, True),
                       "float32": forwards["float32"]}, labels, E)
    train_peak = torch.cuda.max_memory_allocated()
    print(f"[16 times] max_memory_allocated over the four timed steppers {train_peak:,} B "
          f"(set-up peak {setup_peak:,} B)", flush=True)
    times, bounds, lib_ms, Fx = {}, {}, {}, x.shape[1]
    with torch.no_grad():
        for kid, (qq, xin) in full.items():
            k = TRAIN_KERNELS[kid]
            run_kernel = lambda k=k, qq=qq, xin=xin: k["kernel"](qq, xin)  # noqa: E731
            run_plain = lambda k=k, qq=qq, xin=xin: k["plain"](qq, xin)  # noqa: E731
            # the same function in the feature-major layout: K6's padded
            # blocked frame is the padded feature-major frame, reordered
            if kid == "K6":
                xread, out_numel = xin, nb * Fx * block
                xpad = bq.from_blocked(xin).to(torch.bfloat16).to(torch.float32)
            else:
                xread, out_numel = xin[:, :n], Fx * n
                xpad = bq._pad_fm(xin, nb, W, block, torch.bfloat16).to(torch.float32)
            bounds[kid] = band_bound(qq.band_qT, qq.scales, xread, out_numel, Fx, "bf16")
            rows = dequantized(qq.band_qT, qq.scales).reshape(nb, -1, block)
            run_lib = fm_library(rows, xpad, block)
            if kid == "K6":  # the launch alone: at this shape the wrapper passes band and frame as they are
                check(band_mma.blocked_x_operand(xin, block) is xin and band_mma.pad_band(qq.band_qT) is qq.band_qT,
                      (kid, "the wrapper copies its operands"))
                run_alone = lambda qq=qq, xin=xin: band_mma.launch_blocked(kid, qq.band_qT, qq.scales, xin, W,  # noqa: E731
                                                                           block)
                operands = "on the band and the f32 blocked frame"
            else:
                run_alone, operands = fm_launch_alone(kid, qq, xin), "on the transposed band and f32 xT"
            times[kid] = cuda_ms([run_kernel, run_plain, run_lib, run_alone], iters=20, warmup=3)
            lib_ms[kid] = times[kid][2]
            print(f"[16 times] {card} | {kid} {k['name']} at {n:,} nodes, F={GIANT['hidden']}: "
                  f"kernel {times[kid][0]:.4f} ms, plain {times[kid][1]:.4f} ms, library call "
                  f"{lib_ms[kid]:.4f} ms per call (CUDA events, median of 20, in turns; the library "
                  f"call is one torch.bmm of feature-major windows by the dequantized transposed tiles, "
                  f"{library_kernels(run_lib)}); kernel {E / times[kid][0] / 1e6:.4g} G edges/s; bound "
                  f"{bounds[kid][0]:.4f} ms ({bounds[kid][1]}), {bounds[kid][0] / times[kid][0]:.1%} "
                  f"of it; {launch_note(operands, times[kid][3], bounds[kid][0], qq.band_qT)}", flush=True)
            del rows, xpad, run_lib, run_alone
    step_breakdowns(card, steppers, step_ms, paths)

    return [
        {
            "name": k["name"], "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "launches": launched["feature-major" if kid == "K4 backward" else "blocked"][kid],
            "max_abs_err": max_err[kid], "ms": times[kid][0], "plain_ms": times[kid][1],
            "bound_ms": bounds[kid][0], "bound_by": bounds[kid][1], "library_ms": lib_ms[kid],
        }
        for kid, k in TRAIN_KERNELS.items()
    ]


def random_float_band(nb, W, block, n, seed, device):
    """A random NON-symmetric float32 band (70 % zeros; tile (0, 0) all
    zero), so a swapped tile axis cannot go unseen."""
    rng = np.random.default_rng(seed)
    shape = (nb, 2 * W + 1, block, block)
    band = (rng.standard_normal(shape) * (rng.random(shape) < 0.3)).astype(np.float32)
    band[0, 0] = 0
    return BandedMatrix(torch.from_numpy(band).to(device), n, W)


def variant_operands(a: BandedMatrix) -> dict:
    """The band operands of the variants, from one float32 band: itself,
    its bfloat16 copy and its int8 quantization."""
    return {"f32": a, "bf16": a._replace(band=a.band.to(torch.bfloat16)), "int8": bq.quantize_band(a)}


def variant_call(kid, fn, ops, x, **kw):
    """``fn`` (the kernel, entry point or plain version of variant ``kid``)
    on ``x`` and the band operand the variant takes from ``ops``."""
    v = VARIANTS[kid]
    band = ops[v["band"]]
    if v.get("raw"):
        return fn(band.band, band.num_nodes, band.bandwidth, x)
    return fn(band, x, **v.get("kw", {}), **kw)


def variant_launch(kid, ops, x):
    """Variant ``kid``'s launch alone on the operands its wrapper prepares
    (built here, outside the timing)."""
    v, W, block, n, F = VARIANTS[kid], ops["f32"].bandwidth, ops["f32"].block, ops["f32"].num_nodes, x.shape[1]
    if v["band"] != "int8":
        band_p, frame = band_mma.rowmajor_operands(ops[v["band"]], x)
        return lambda: band_mma.launch_rowmajor(kid, band_p, frame, n, W, block, F)
    q = ops["int8"]
    if kid == "B2b":
        band_p, (xq_p, xscales) = band_mma.pad_band(q.band_q), bv.w8a8_operands(q, x)
        return lambda: band_mma.launch_rowmajor_w8a8(kid, band_p, q.scales, xq_p, xscales, n, W, block)
    band_p, frame = band_mma.pad_band(q.band_q), band_mma.rowmajor_frame(x, n, q.num_blocks, W, block)
    wrow = v.get("kw", {}).get("wrow_bf16", False)
    return lambda: band_mma.launch_rowmajor(kid, band_p, frame, n, W, block, F, q.scales, wrow_bf16=wrow)


def tolerance_ratio(got, want) -> float:
    """max |got - want| / (atol + rtol |want|) at the band gate: at most 1
    where ``assert_close`` passes."""
    return float(((got - want).abs() / (BAND_ATOL + BAND_RTOL * want.abs())).max())


def check_variant(kid, ops, x) -> tuple[float, str]:
    """One variant's kernel against its plain version on the same operands
    (for :data:`FLOAT64_SUMS`, against its plain version summed in float64
    at the gate and the float32 one within the magnitude gate); returns max
    |kernel - plain| and, for those, how far kernel and plain version lie
    from the float64 sums in units of the gate."""
    v = VARIANTS[kid]
    got = variant_call(kid, v["kernel"], ops, x)
    torch.cuda.synchronize()
    want = variant_call(kid, v["plain"], ops, x)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()), (kid, tuple(got.shape)))
    note = ""
    if v.get("exact"):
        check(torch.equal(got, want), (kid, "not the plain version bit for bit"))
        check(torch.equal(variant_launch(kid, ops, x)(), got), (kid, "launch alone != wrapper"))
    elif kid in FLOAT64_SUMS:
        abs_ops = {"f32": ops["f32"]._replace(band=ops["f32"].band.abs()),
                   "int8": ops["int8"]._replace(band_q=ops["int8"].band_q.abs())}
        magnitude = variant_call(kid, v["plain"], abs_ops, x.abs())
        check(bool(((got - want).abs() <= MAGNITUDE_RTOL * magnitude).all()), (kid, "magnitude gate"))
        exact = variant_call(kid, v["plain"], ops, x, sum_dtype=torch.float64)
        note = (f" [{kid} against the float64 sums, in units of the gate: kernel "
                f"{tolerance_ratio(got, exact):.3f}, plain {tolerance_ratio(want, exact):.3f}]")
        torch.testing.assert_close(got, exact, rtol=BAND_RTOL, atol=BAND_ATOL)
    else:
        torch.testing.assert_close(got, want, rtol=BAND_RTOL, atol=BAND_ATOL)
    return float((got - want).abs().max()), note


def variant_library(kid, ops, x_pad, block):
    """Variant ``kid``'s library call, or None (B2b: no batched int8
    matmul): one torch.bmm of the band arranged as rows (built here, outside
    the timing) by windows of the padded frame ``x_pad``, x rounded to
    bfloat16 where the variant rounds it."""
    v = VARIANTS[kid]
    if kid == "B2b":
        return None
    if v["band"] == "int8":
        q = ops["int8"]
        band = dequantized(q.band_q, q.scales)
        if v.get("kw", {}).get("wrow_bf16"):
            band = band.to(torch.bfloat16).to(torch.float32)
    else:
        band = ops[v["band"]].band
    rows = band_rows(band)
    if kid != "K7-f32":
        x_pad = x_pad.to(torch.bfloat16)
        if rows.dtype == torch.float32:
            x_pad = x_pad.to(torch.float32)
    return rowmajor_library(rows, x_pad, block)


def b2b_frame_bytewise(q, x):
    """B2b's int8 frame and scales with the int8 values transposed one by
    one: the node-major quantization, then a permuting copy."""
    xq, xscales = bv._w8a8_operands(q, x)
    return xq.permute(2, 0, 1).contiguous().view(x.shape[1], -1), xscales


def band_variant_phases(dev, card, graph) -> list[dict]:
    """Phases 17-19; returns the variants' entries of the JSON line."""
    block, n, E = GIANT["block"], graph.num_nodes, graph.num_edges

    # 17. set-up: the band, its bfloat16 copy and its int8 quantization
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        a = to_banded(graph.edge_index[0], graph.edge_index[1], graph.edge_weight, n, block=block,
                      device=dev)
        full = variant_operands(a)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    x = torch.from_numpy(graph.node_features).to(dev)
    F_ = x.shape[1]
    q = full["int8"]
    print(f"[17 variants set-up] {card} | {n:,} nodes, {E:,} edges, W={a.bandwidth}, block {block}, F={F_}: "
          f"f32 band {nbytes(a.band):,} B, bf16 band {nbytes(full['bf16'].band):,} B, int8 band and "
          f"scales {nbytes(q.band_q, q.scales):,} B; to_banded, the bf16 copy and quantize_band "
          f"{t_setup:.2f} s (card); max_memory_allocated {torch.cuda.max_memory_allocated():,} B",
          flush=True)

    # 18. each variant against its plain version, then the main path
    max_err = dict.fromkeys(VARIANTS, 0.0)
    with torch.no_grad():
        for shape in BAND_SHAPES + MMA_SHAPES + B2B_SHAPES:
            snb, sW, sb, snodes, sF = shape
            ops = variant_operands(random_float_band(snb, sW, sb, snodes, seed=sum(shape), device=dev))
            xs = torch.from_numpy(
                np.random.default_rng(snodes + sF).standard_normal((snodes, sF)).astype(np.float32)
            ).to(dev)
            errs = {kid: check_variant(kid, ops, xs) for kid in (VARIANTS if shape not in B2B_SHAPES else ("B2b",))}
            for kid, (err, _) in errs.items():
                max_err[kid] = max(max_err[kid], err)
            print(f"[18 variant kernel] NB={snb} W={sW} b={sb} n={snodes} F={sF}, random non-symmetric "
                  f"band, max|kernel-plain|: " + ", ".join(f"{kid} {e:.3e}" for kid, (e, _) in errs.items())
                  + " (B2b bit for bit, its launch alone the wrapper's)"
                  + "".join(note for _, note in errs.values()), flush=True)
        del ops, xs
        # the main path: each entry point once at the 1M-node shape
        torch.cuda.synchronize()
        reset_counters()
        outs, launched = {}, {}
        for kid, v in VARIANTS.items():
            before = counts()
            outs[kid] = variant_call(kid, v["entry"], full, x)
            torch.cuda.synchronize()
            delta = {k: c - before[k] for k, c in counts().items()}
            check(delta == {k: 1 if k == v["counter"] else 0 for k in COUNTERS}, (kid, delta))
            launched[kid] = delta[v["counter"]]
        print(f"[18 variant main path] launches: { {k: c for k, c in counts().items() if c} }", flush=True)
        ref = banded_spmm(a, x)
        ref_norm = torch.linalg.norm(ref)
        for kid, v in VARIANTS.items():
            out = outs[kid]
            want = variant_call(kid, v["plain"], full, x)
            check(out.shape == (n, F_) and bool(torch.isfinite(out).all()), (kid, tuple(out.shape)))
            torch.testing.assert_close(out, want, rtol=BAND_RTOL, atol=BAND_ATOL)
            if v.get("exact"):
                check(torch.equal(out, want), (kid, "not the plain version bit for bit"))
                check(torch.equal(variant_launch(kid, full, x)(), out), (kid, "launch alone != wrapper"))
            err = float((out - want).abs().max())
            max_err[kid] = max(max_err[kid], err)
            rel = float(torch.linalg.norm(out - ref) / ref_norm)
            check(rel < CHECK_GATE, (kid, "against the float32 banded_spmm", rel))
            note = ""
            if kid in FLOAT64_SUMS:
                exact = variant_call(kid, v["plain"], full, x, sum_dtype=torch.float64)
                note = (f"; against the float64 sums, in units of the gate: kernel "
                        f"{tolerance_ratio(out, exact):.3f}, plain {tolerance_ratio(want, exact):.3f}")
                del exact
            exact = "; bit for bit, and the launch alone the wrapper's" if v.get("exact") else ""
            print(f"[18 variant main path] {kid} {v['name']} at {n:,} nodes, F={F_}: output "
                  f"{tuple(out.shape)} finite, {launched[kid]} launch{exact}; max|kernel-plain| = {err:.3e} "
                  f"({tolerance_ratio(out, want):.3f} of the gate){note}; against the float32 banded_spmm: "
                  f"relative Frobenius error {rel:.4e} (gate {CHECK_GATE})", flush=True)
            del want
        del ref

    # 19. times (nothing asserted)
    entries, peak = [], torch.cuda.max_memory_allocated()
    x_pad = pad_blocks(x, a.num_blocks, a.bandwidth, block).reshape(-1, F_)
    with torch.no_grad():
        for kid, v in VARIANTS.items():
            run_kernel = lambda kid=kid, v=v: variant_call(kid, v["kernel"], full, x)  # noqa: E731
            run_plain = lambda kid=kid, v=v: variant_call(kid, v["plain"], full, x)  # noqa: E731
            run_lib = variant_library(kid, full, x_pad, block)
            # the launch alone on the operands its wrapper prepares first in
            # torch (x rounded to bf16, or split in three, in the padded
            # frame; B2b: quantized into K5's int8 frame)
            run_alone = variant_launch(kid, full, x)
            fns = [run_kernel, run_plain] + ([run_lib] if run_lib else []) + [run_alone]
            ms = cuda_ms(fns, iters=10, warmup=2)
            band = full[v["band"]]
            b_ms, b_by = (band_bound(q.band_q, q.scales, x, n * F_, F_, v["ops"]) if v["band"] == "int8"
                          else band_bound(band.band, None, x, n * F_, F_, v["ops"]))
            lib_ms, lib_note = None, NO_LIBRARY
            peak = max(peak, torch.cuda.max_memory_allocated())
            if run_lib:
                lib_ms = ms[2]
                lib_diff = float((run_lib().reshape(-1, F_)[:n] - outs[kid]).abs().max())
                lib_note = (f"{lib_ms:.4f} ms, one torch.bmm over strided windows, max|library-kernel| "
                            f"{lib_diff:.3e} ({library_kernels(run_lib)})")
            alone = f"; the launch alone on its prepared operands {ms[-1]:.4f} ms, {b_ms / ms[-1]:.1%} of the bound"
            print(f"[19 times] {card} | {kid} {v['name']} at {n:,} nodes, F={F_}: kernel {ms[0]:.4f} ms, "
                  f"plain {ms[1]:.4f} ms per call (CUDA events, median of 10, in turns){alone}; kernel "
                  f"{E / ms[0] / 1e6:.4g} G edge-messages/s; bound {b_ms:.4f} ms ({b_by}), the kernel at "
                  f"{b_ms / ms[0]:.1%} of it; library call {lib_note}", flush=True)
            entries.append({
                "name": v["name"], "route": "cuda", "source": v["source"],
                "replaces": v["replaces"],
                "launches": launched[kid], "max_abs_err": max_err[kid], "ms": ms[0],
                "plain_ms": ms[1], "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            })
            del run_lib, run_alone, fns
        # B2b's int8 frame, three builds of the same bits: the wrapper's
        # (node-major quantization, then the int8 values transposed as
        # 32-bit words of four senders), the same with the bytes transposed
        # one by one, and a float32 transpose, then K5's feature-major
        # quantization; and the node-major quantization alone
        nb, W = q.num_blocks, q.bandwidth
        builds = {
            "node-major quantization, int8 transposed as words (the wrapper's)": lambda: bv.w8a8_operands(q, x),
            "node-major quantization, int8 transposed byte by byte": lambda: b2b_frame_bytewise(q, x),
            "float32 transposed, feature-major quantization": lambda: bq.quantize_activations_fm(
                bq._pad_fm(x[:n].T, nb, W, block, torch.float32), block),
            "the node-major quantization alone": lambda: bv._w8a8_operands(q, x),
        }
        frames = [fn() for fn in list(builds.values())[:3]]
        for other in frames[1:]:
            check(torch.equal(frames[0][0], band_mma.fm_frame(other[0], nb, W, block))
                  and torch.equal(frames[0][1], other[1]), "B2b's frame builds differ")
        del frames, other
        build_ms = cuda_ms(list(builds.values()), iters=10, warmup=2)
        peak = max(peak, torch.cuda.max_memory_allocated())
        print(f"[19 B2b frame] {card} | B2b's int8 frame [{F_}, {(nb + 2 * W) * block:,}] and scales at {n:,} "
              f"nodes, three builds bit for bit the same (CUDA events, median of 10, in turns): "
              + "; ".join(f"{label} {t:.4f} ms" for label, t in zip(builds, build_ms)), flush=True)
    print(f"[19 times] max_memory_allocated over phases 18-19 {peak:,} B", flush=True)
    return entries


def fm_operands(q, band_bf16T, xT) -> dict:
    """The B3 operands of one feature-major int8 band ``q``: the bfloat16
    band, ``xT [F, n]``, its bfloat16 padded frame, the frame blocked and
    quantized per block (the script's ``:603-606``, ``:678``, ``:734-735``)."""
    x_pad = fv.pad_xT(xT, q.num_nodes, q.num_blocks, q.bandwidth, q.block)
    xq, xs = fv.quantize_xT_blocks(x_pad, q.block)
    return dict(q=q, band_bf16T=band_bf16T, xT=xT, x_pad=x_pad, xb=bq.to_blocked(x_pad, q.block),
                xq=xq, xs=xs)


def fm_call(kid, fn, ops, R=32, **kw):
    """``fn`` (the kernel, entry point or plain version of B3 kernel
    ``kid``) on its operands in ``ops``."""
    q = ops["q"]
    if kid == "B3a bf16_band":
        return fn(ops["band_bf16T"], q.scales, q.num_nodes, q.bandwidth, ops["xT"], R)
    if kid == "B3a w8a8":
        return fn(q, ops["xq"], ops["xs"], R)
    return fn(q, ops["xb"] if kid == "B3d" else ops["xT"], R, **kw)


#: the B3 kernels held to their plain version bit for bit: one float32 add,
#: and K5's launch
FM_EXACT = ("B3a dma_only", "B3a w8a8")


def fm_tolerance(kid) -> dict:
    """``fm_dma_only`` (one float32 add) and ``fm_w8a8`` (K5's launch)
    bitwise, the others at the band kernels' 1e-5."""
    exact = kid in FM_EXACT
    return {"rtol": 0.0 if exact else BAND_RTOL, "atol": 0.0 if exact else BAND_ATOL}


def check_fm(kid, ops, R=32, **kw) -> float:
    """One B3 kernel against its plain version on the same operands
    (``fm_dma_only`` bitwise); returns max |kernel - plain|."""
    k = FM_KERNELS[kid]
    got = fm_call(kid, k["kernel"], ops, R, **kw)
    torch.cuda.synchronize()
    want = fm_call(kid, k["plain"], ops, R, **kw)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()), (kid, R, kw, tuple(got.shape)))
    torch.testing.assert_close(got, want, **fm_tolerance(kid), msg=f"{kid} R={R} {kw}")
    if kid in FM_EXACT:
        check(torch.equal(got, want), (kid, R, "not the plain version bit for bit"))
    if kid == "B3a w8a8":
        check_fm_w8a8_is_k5(ops, R)
    return float((got - want).abs().max())


def check_fm_w8a8_is_k5(ops, R=32) -> None:
    """``fm_w8a8`` on K5's operands (the float32-padded frame quantized per
    block) against K5's kernel on ``xT``: bit for bit."""
    q = ops["q"]
    xq, xs = bq.quantize_activations_padded(q, ops["xT"])
    check(torch.equal(fv.fm_w8a8_kernel(q, xq, xs, R), bq.banded_spmm_quant_fm_w8a8_kernel(q, ops["xT"])),
          "fm_w8a8 != K5's kernel on K5's operands")


def sweep_kw(config) -> dict:
    """``depth`` (and ``band_splits``) of an (R, S[, K]) sweep entry."""
    return dict(zip(("depth", "band_splits"), config[1:]))


def check_sweep(kid, ops, sweep) -> float:
    """B3c or B3d at each (R, S[, K]) of ``sweep``: its plain version at
    1e-5, and the default call's output bit for bit (on role B R, S and K
    shape nothing); returns max |kernel - plain|."""
    kernel = FM_KERNELS[kid]["kernel"]
    one, err = fm_call(kid, kernel, ops), 0.0
    for config in sweep:
        err = max(err, check_fm(kid, ops, config[0], **sweep_kw(config)))
        check(torch.equal(fm_call(kid, kernel, ops, config[0], **sweep_kw(config)), one),
              (kid, config, "not the one result"))
    return err


def role_b_staged(nb, W, block, F, frame_elem_bytes) -> int:
    """The bytes role B over the int8 band stages into shared memory: for
    each (row block, 128-receiver tile, 64-feature tile) unit, D·⌈b'/64⌉
    stages of an 8 KB band box and 64 senders by 64 features of the frame
    (f32: 16 KB, bf16: 8 KB)."""
    bp = band_mma.padded(block, band_mma.BLOCK_MULTIPLE)
    units = nb * -(-bp // 128) * -(-F // 64)
    return units * (2 * W + 1) * -(-bp // 64) * (8192 + 64 * 64 * frame_elem_bytes)


def fm_pipeline_phases(dev, card, graph) -> list[dict]:
    """Phases 20-22; returns the B3 kernels' entries of the JSON line."""
    block, n, E = GIANT["block"], graph.num_nodes, graph.num_edges

    # 20. set-up: the int8 band in the feature-major form, its bf16 copy, x
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        a = to_banded(graph.edge_index[0], graph.edge_index[1], graph.edge_weight, n, block=block,
                      device=dev)
        x = torch.from_numpy(graph.node_features).to(dev)
        ref = banded_spmm(a, x)  # the float32 product the gate holds each variant to
        q = bq.to_feature_major(bq.quantize_band(a))
        # the script's bf16 band, one diagonal at a time: the int8 kernel's
        # scale structure, a bf16 payload, tiles transposed
        inv = 1.0 / torch.clamp_min(q.scales, 1e-30)
        band_bf16T = torch.empty(q.band_qT.shape, dtype=torch.bfloat16, device=dev)
        for d in range(band_bf16T.shape[1]):
            band_bf16T[:, d] = (a.band[:, d] * inv[:, d, None, None]).to(torch.bfloat16).transpose(1, 2)
        f32_bytes = nbytes(a.band)
        del a, inv
        full = fm_operands(q, band_bf16T, x.T.contiguous())
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    nb, W, F_ = q.num_blocks, q.bandwidth, x.shape[1]
    print(f"[20 fm set-up] {card} | {n:,} nodes, {E:,} edges, W={W}, block {block}, F={F_}: f32 band "
          f"{f32_bytes:,} B (freed), int8 transposed band and scales {nbytes(q.band_qT, q.scales):,} B, "
          f"bf16 transposed band {nbytes(band_bf16T):,} B, bf16 padded frame "
          f"{nbytes(full['x_pad']):,} B, blocked {nbytes(full['xb']):,} B, int8 frame and scales "
          f"{nbytes(full['xq'], full['xs']):,} B; {t_setup:.2f} s (card); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated():,} B, {torch.cuda.memory_allocated():,} B now allocated",
          flush=True)

    # 21. each kernel against its plain version, then the main path
    max_err = dict.fromkeys(FM_KERNELS, 0.0)
    with torch.no_grad():
        for shape in FM_SHAPES + FM_ROLE_B_SHAPES + FM_ANY_BLOCK_SHAPES:
            snb, sW, sb, snodes, sF, sR = shape
            sq = bq.to_feature_major(random_quantized_band(snb, sW, sb, snodes, seed=sum(shape), device=dev))
            sxT = torch.from_numpy(np.random.default_rng(snodes + sF).standard_normal(
                (sF, snodes)).astype(np.float32)).to(dev)
            ops = fm_operands(sq, (sq.band_qT.float() * 1.37).to(torch.bfloat16), sxT)
            kids = (FM_KERNELS if shape in FM_SHAPES else ("B3c", "B3d") if shape in FM_ROLE_B_SHAPES
                    else ("B3a dma_only", "B3a w8a8", "B3c", "B3d"))
            errs = {kid: check_fm(kid, ops, sR) for kid in kids}
            errs["B3c"] = max(errs["B3c"], check_sweep("B3c", ops, DEEP_SWEEP))
            errs["B3d"] = max(errs["B3d"], check_sweep("B3d", ops, BLOCKED_SWEEP))
            for kid, err in errs.items():
                max_err[kid] = max(max_err[kid], err)
            print(f"[21 fm kernel] NB={snb} W={sW} b={sb} n={snodes} F={sF} R={sR}, random non-symmetric "
                  f"band, fm_deep at each (R, S, K) of {DEEP_SWEEP} and fm_blocked at each (R, S) of "
                  f"{BLOCKED_SWEEP} the one result bit for bit"
                  + (", fm_dma_only and fm_w8a8 bit for bit their plain versions, fm_w8a8 also K5's kernel"
                     if "B3a w8a8" in kids else "")
                  + ", max|kernel-plain|: "
                  + ", ".join(f"{kid} {e:.3e}" for kid, e in errs.items()), flush=True)
        del ops, sq, sxT
        # the main path: each entry point once at the 1M-node shape
        torch.cuda.synchronize()
        reset_counters()
        outs = {}
        for kid, k in FM_KERNELS.items():
            before = counts()
            outs[kid] = fm_call(kid, k["entry"], full)
            torch.cuda.synchronize()
            delta = {c: v - before[c] for c, v in counts().items()}
            check(delta == {c: 1 if c == kid else 0 for c in COUNTERS}, (kid, delta))
        launched = {kid: COUNTERS[kid].launches for kid in FM_KERNELS}
        print(f"[21 fm main path] launches: { {c: v for c, v in counts().items() if v} }", flush=True)
        ref_norm = torch.linalg.norm(ref)
        for kid, k in FM_KERNELS.items():
            out = outs.pop(kid)
            want = fm_call(kid, k["plain"], full)
            check(bool(torch.isfinite(out).all()) and out.shape == want.shape, (kid, tuple(out.shape)))
            torch.testing.assert_close(out, want, **fm_tolerance(kid), msg=kid)
            if kid in FM_EXACT:
                check(torch.equal(out, want), (kid, "not the plain version bit for bit"))
            err = float((out - want).abs().max())
            max_err[kid] = max(max_err[kid], err)
            gate = ""
            if kid not in ("B3a dma_only", "B3b"):
                nodes = bq.from_blocked(out)[:, :n] if kid == "B3d" else out
                rel = float(torch.linalg.norm(nodes.T - ref) / ref_norm)
                check(rel < CHECK_GATE, (kid, "against the float32 banded_spmm", rel))
                gate = f"; against the float32 banded_spmm: relative Frobenius error {rel:.4e} (gate {CHECK_GATE})"
            if kid == "B3a w8a8":
                check_fm_w8a8_is_k5(full)
                gate += "; bit for bit, and K5's kernel on K5's operands"
            sweep = {"B3c": DEEP_SWEEP, "B3d": BLOCKED_SWEEP}.get(kid, [])
            for config in sweep:
                got = fm_call(kid, k["kernel"], full, config[0], **sweep_kw(config))
                check(torch.equal(got, out), (kid, config, "not the one result"))
            if sweep:
                gate += f"; at each of {sweep} the one result bit for bit"
            print(f"[21 fm main path] {kid} {k['name']} at {n:,} nodes, F={F_}: output {tuple(out.shape)} "
                  f"finite, 1 launch; max|kernel-plain| = {err:.3e}{gate}", flush=True)
            del out, want
        del outs, ref

    # 22. times (nothing asserted)
    R = 32
    qb = bq.QuantizedBandedMatrixFM(band_bf16T, q.scales, n, W)
    x_pad, xT = full["x_pad"], full["xT"]
    x_win = fv._window0(q, xT, R)
    nnz8, nnz16, nnz_panel = count_nonzero(q.band_qT), count_nonzero(band_bf16T), count_nonzero(q.band_qT[:R])
    out_bytes = 4 * F_ * n
    i_star = (nb // R - 1) // 2 * 2
    # the two probes' bounds count what their output needs: diagonal 0's
    # first F tile rows (dma-only), and one chunk's dots (compute-only)
    bounds = {
        "B3a dma_only": bound(nbytes(q.band_qT[:, 0, :F_], xT) + out_bytes, F_ * n, "f32"),
        "B3a bf16_band": bound(nbytes(band_bf16T, q.scales, xT) + out_bytes, 2 * F_ * nnz16, "bf16"),
        "B3a w8a8": bound(nbytes(q.band_qT, q.scales, full["xq"], full["xs"]) + out_bytes,
                          2 * F_ * nnz8, "int8"),
        "B3b": bound(nbytes(q.band_qT[:R], q.scales[i_star * R : (i_star + 1) * R])
                     + 4 * F_ * (min(n, (R + W) * block) + R * block), 2 * F_ * nnz_panel, "bf16"),
        "B3c": bound(nbytes(q.band_qT, q.scales, xT) + out_bytes, 2 * F_ * nnz8, "bf16"),
        "B3d": bound(nbytes(q.band_qT, q.scales, full["xb"]) + out_bytes, 2 * F_ * nnz8, "bf16"),
    }
    # B3b's work bound beside its output's: every chunk's dots over the
    # panel, dense (its R·D tiles, NB / R times) and by the panel's nonzeros
    b3b_dense_flop = 2 * F_ * block * block * (2 * W + 1) * nb
    b3b_work = {"dense": b3b_dense_flop / PEAK_OPS["bf16"] * 1e3,
                "nonzeros": 2 * F_ * nnz_panel * (nb // R) / PEAK_OPS["bf16"] * 1e3}
    # the launch alone, on operands the wrapper would build first in torch
    alone = {
        "B3a dma_only": lambda: fv._launch_dma_only(q, x_pad),
        "B3a bf16_band": lambda: fv._launch_bf16_band(qb, x_pad),
        "B3b": lambda: fv._launch_compute_only(q, x_win, R),
    }
    entries, peak, alone_ms = [], torch.cuda.max_memory_allocated(), {}
    with torch.no_grad():
        rows = dequantized(q.band_qT, q.scales).reshape(nb, -1, block)
        x_pad32 = x_pad.to(torch.float32)
        rows16 = torch.empty_like(band_bf16T)
        for d in range(rows16.shape[1]):
            rows16[:, d] = (band_bf16T[:, d].float() * q.scales[:, d, None, None]).to(torch.bfloat16)
        library = {"B3c": fm_library(rows, x_pad32, block), "B3d": fm_library(rows, x_pad32, block),
                   "B3a bf16_band": fm_library(rows16.reshape(nb, -1, block), x_pad, block)}
        for kid, k in FM_KERNELS.items():
            fns = [lambda kid=kid, k=k: fm_call(kid, k["kernel"], full),
                   lambda kid=kid, k=k: fm_call(kid, k["plain"], full)]
            run_lib = library.get(kid)
            fns += [f for f in (run_lib, alone.get(kid)) if f is not None]
            ms = cuda_ms(fns, iters=10, warmup=2)
            peak = max(peak, torch.cuda.max_memory_allocated())
            b_ms, b_by = bounds[kid]
            lib_ms, lib_note = None, "none (no single PyTorch call computes it)"
            if run_lib is not None:
                lib_ms = ms[2]
                got = fm_call(kid, k["kernel"], full)
                lib_out = run_lib().permute(1, 0, 2).reshape(F_, nb * block)[:, :n]
                nodes = bq.from_blocked(got)[:, :n] if kid == "B3d" else got
                lib_note = (f"{lib_ms:.4f} ms, one torch.bmm of strided feature-major windows by the "
                            f"{'bf16 band with its scales folded in' if kid == 'B3a bf16_band' else 'dequantized band'}, "
                            f"max|library-kernel| {float((lib_out - nodes).abs().max()):.3e} "
                            f"({library_kernels(run_lib)})")
                del got, lib_out, nodes
            if kid in alone:
                alone_ms[kid] = ms[-1]
            note = (f"; the launch alone on the prepared bf16 frame {alone_ms[kid]:.4f} ms" if kid in alone
                    else "; the wrapper is the launch alone")
            if kid == "B3b":
                note += (f"; its work bound, every chunk's dense dots ({b3b_dense_flop / 1e9:.4g} GFLOP at "
                         f"{PEAK_OPS['bf16'] / 1e12:.0f} TFLOP/s bf16), {b3b_work['dense']:.4f} ms, the launch "
                         f"at {b3b_work['dense'] / alone_ms[kid]:.1%} of it (by the panel's nonzeros "
                         f"{b3b_work['nonzeros']:.4f} ms)")
            print(f"[22 times] {card} | {kid} {k['name']} at {n:,} nodes, F={F_}, R={R}: kernel {ms[0]:.4f} ms, "
                  f"plain {ms[1]:.4f} ms per call (CUDA events, median of 10, in turns){note}; kernel "
                  f"{E / ms[0] / 1e6:.4g} G edge-messages/s; bound {b_ms:.4f} ms ({b_by}), the kernel at "
                  f"{b_ms / ms[0]:.1%} of it; library call {lib_note}", flush=True)
            entries.append({
                "name": k["name"], "route": "cuda", "source": k["source"],
                "replaces": k["replaces"],
                "launches": launched[kid], "max_abs_err": max_err[kid], "ms": ms[0], "plain_ms": ms[1],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            })
        del rows, rows16, x_pad32, library
        # the frame's type alone: role B over the same int8 band, f32 frame
        # (K4 on xT, B3c's route; K6 on the blocked frame widened) against
        # bf16 (the feature-major launch on pad_xT's frame; B3d), first
        # checked to give the same bits; then the bf16 feature-major route
        # whole (pad_xT, then the launch)
        xb32 = full["xb"].float()
        frames = {
            "K4 f32 frame": fm_launch_alone("K4", q, xT),
            "feature-major bf16 frame": lambda: band_mma.launch_fm("B3c", q.band_qT, q.scales, x_pad, W,
                                                                   block),
            "K6 f32 frame": lambda: band_mma.launch_blocked("K6", q.band_qT, q.scales, xb32, W, block),
            "B3d bf16 frame": lambda: band_mma.launch_blocked("B3d", q.band_qT, q.scales, full["xb"], W,
                                                              block),
        }
        outs = {label: fn() for label, fn in frames.items()}
        check(torch.equal(outs["feature-major bf16 frame"][:, :n], outs["K4 f32 frame"]), "bf16 frame != K4")
        check(torch.equal(outs["B3d bf16 frame"], outs["K6 f32 frame"]), "B3d != K6 on its frame in float32")
        del outs
        bf16_route = lambda: band_mma.launch_fm(  # noqa: E731
            "B3c", q.band_qT, q.scales, fv.pad_xT(xT, n, nb, W, block), W, block)
        timed = cuda_ms([*frames.values(), bf16_route], iters=10, warmup=2)
        frame_ms, route_ms = dict(zip(frames, timed)), timed[-1]
        staged = {label: role_b_staged(nb, W, block, F_, 4 if "f32" in label else 2) for label in frames}
        print(f"[22 frame] {card} | role B over the same int8 band, the launch alone (CUDA events, median "
              f"of 10, the five in turns; the bf16 frame's output equal to the f32 frame's bit for bit): "
              + "; ".join(f"{label} {ms:.4f} ms, {staged[label] / 1e9:.4g} GB staged into shared memory at "
                          f"{staged[label] / ms / 1e9:.4g} TB/s" for label, ms in frame_ms.items())
              + f"; bf16 / f32 frame: feature-major "
              f"{frame_ms['feature-major bf16 frame'] / frame_ms['K4 f32 frame']:.3f}, blocked "
              f"{frame_ms['B3d bf16 frame'] / frame_ms['K6 f32 frame']:.3f}; the bf16 route whole (pad_xT, "
              f"then the launch) {route_ms:.4f} ms against K4's launch on xT (B3c's route) "
              f"{frame_ms['K4 f32 frame']:.4f} ms", flush=True)
        del xb32
        # the ring alone: fm_dma_only stages role B's stream over the int8
        # band on the bf16 frame, B3d's bytes (its output needs far less)
        dma_staged, dma_ms = role_b_staged(nb, W, block, F_, 2), alone_ms["B3a dma_only"]
        print(f"[22 times] {card} | role B's ring alone, fm_dma_only's launch alone: {dma_ms:.4f} ms, "
              f"{dma_staged / 1e9:.4g} GB staged into shared memory at {dma_staged / dma_ms / 1e9:.4g} TB/s; "
              f"against the bound of its function {bounds['B3a dma_only'][0]:.4f} ms "
              f"({bounds['B3a dma_only'][0] / dma_ms:.1%}) and of the stream it stages, B3d's "
              f"{bounds['B3d'][0]:.4f} ms ({bounds['B3d'][0] / dma_ms:.1%})", flush=True)
        # role B taken apart, the same units and 16 KB stages each: the ring
        # alone (dma-only), each stage widened, fenced, met at a named
        # barrier and multiplied without the HBM stream (B3b: its 10.5 MB
        # panel and window stay in L2) and with it (B3d, blocked; the
        # feature-major bf16-frame launch, K4's function)
        units, sms = nb * -(-block // 128) * -(-F_ // 64), torch.cuda.get_device_properties(dev).multi_processor_count
        stages = -(-units // sms) * (2 * W + 1) * -(-block // 64)
        parts = {
            "dma-only (the ring alone)": alone["B3a dma_only"],
            f"B3b (no HBM stream: panel in L2, {nbytes(q.band_qT[:R]) / 1e6:.4g} MB, evict_last)": alone["B3b"],
            f"B3d (all of role B, the band streamed, {nbytes(q.band_qT) / 1e9:.4g} GB)":
                lambda: band_mma.launch_blocked("B3d", q.band_qT, q.scales, full["xb"], W, block),
            "feature-major bf16 frame (K4's function)": frames["feature-major bf16 frame"],
        }
        dma_ms, b3b_ms, b3d_ms, fm_ms = cuda_ms(list(parts.values()), iters=10, warmup=2)
        us = lambda ms: ms / stages * 1e3  # noqa: E731
        print(f"[22 role B] {card} | launches alone in turns (CUDA events, median of 10), {stages:,} stages "
              f"of 16 KB a block: "
              + "; ".join(f"{label} {ms:.4f} ms, {us(ms):.4f} µs a stage"
                          for label, ms in zip(parts, (dma_ms, b3b_ms, b3d_ms, fm_ms)))
              + f"; a stage's own work (B3d - dma-only) {us(b3d_ms - dma_ms):.4f} µs, the feature-major "
              f"launch's (- dma-only) {us(fm_ms - dma_ms):.4f} µs; the HBM stream (B3d - B3b) "
              f"{us(b3d_ms - b3b_ms):.4f} µs; dma-only / B3d {dma_ms / b3d_ms:.3f}", flush=True)
    print(f"[22 times] max_memory_allocated over phases 20-22 {peak:,} B", flush=True)
    return entries


def demo_module():
    """``examples/demo_torch.py``, whose train-and-test flow phase 23 runs."""
    spec = importlib.util.spec_from_file_location("demo_torch", os.path.join(REPO, "examples", "demo_torch.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    check((demo.NUM_SUBJECTS, demo.BATCH_SIZE, demo.HIDDEN_DIM, demo.NUM_LAYERS, demo.DROPOUT, demo.EPOCHS,
           demo.PATIENCE, demo.SEED) == tuple(DEMO[k] for k in ("subjects", "batch", "hidden", "layers",
                                                              "dropout", "epochs", "patience", "seed")),
          "examples/demo_torch.py's constants are not the demo's")
    return demo


def train_model(kind, dropout, seed=0):
    """A classifier at the demo's width (hidden 64, 3 layers), weights from ``seed``."""
    return TRAIN_CLASSES[kind](in_channels=5, hidden_dim=DEMO["hidden"], num_classes=2,
                               num_layers=DEMO["layers"], dropout=dropout,
                               generator=torch.Generator().manual_seed(seed))


def training_state(trainer) -> dict:
    """Parameters, buffers and optimizer state (Adam's step count
    included), cloned, by name."""
    out = {f"model/{k}": v.clone() for k, v in trainer.model.state_dict().items()}
    for i, state in trainer.optimizer.state_dict()["state"].items():
        out.update({f"opt/{i}/{k}": v.clone() for k, v in state.items()})
    return out


def same_bits(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def step_tolerance(kind, name) -> dict:
    """A GCN conv's bias is followed directly by masked BatchNorm, so the
    loss does not depend on it: its gradient is float32 noise, different on
    the card and the CPU, which Adam turns into steps of up to lr either
    way (``tests/test_torch_train_fit.py``)."""
    if kind == "gcn" and name.startswith("convs.") and name.endswith(".bias"):
        return dict(rtol=0.0, atol=GCN_BIAS_ATOL)
    if kind == "gcn" and name.endswith("running_mean"):
        return dict(rtol=0.0, atol=GCN_RUNNING_MEAN_ATOL)
    return dict(rtol=RTOL, atol=ATOL)


class PreemptingLoader:
    """Delegates to a loader and raises SIGTERM as epoch ``fire_at``
    (0-based) begins: a preemption arriving mid-epoch."""

    def __init__(self, inner, fire_at):
        self.inner, self.fire_at, self.epoch = inner, fire_at, 0

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.inner.set_epoch(epoch)

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        for i, batch in enumerate(self.inner):
            if i == 0 and self.epoch == self.fire_at:
                signal.raise_signal(signal.SIGTERM)
            yield batch


def graph_training_phases(dev, card) -> None:
    """Phase 23 and the training half of phase 25."""
    t_start = time.perf_counter()
    # 23. training on the card: the demo's flow (examples/demo_torch.py)
    demo = demo_module()
    graphs = generate_dataset(num_subjects=DEMO["subjects"], seed=DEMO["seed"])
    train_g, val_g, test_g = demo.split(graphs)
    loaders = demo.make_loaders(graphs)
    for kind, name in zip(TRAIN_CLASSES, demo.MODELS):
        hist, ev, t_fit = demo.train_and_test(name, loaders, graphs[0].num_features, device=dev, verbose=False)
        losses = hist["train_loss"]
        check(np.isfinite(losses + hist["val_loss"]).all(), (kind, hist))
        check(min(losses[1:]) < losses[0], (kind, "train loss did not fall", losses))
        check(set(hist["skipped_steps"]) == {0}, (kind, hist["skipped_steps"]))
        print(f"[23 training] {card} | {kind} fit on the card, demo flow ({len(train_g)}/{len(val_g)}/{len(test_g)} "
              f"graphs, COO batches of {DEMO['batch']}, hidden {DEMO['hidden']}, L={DEMO['layers']}, dropout "
              f"{DEMO['dropout']}; examples/demo_torch.py's train_and_test): {len(losses)} epochs in "
              f"{t_fit:.2f} s, train loss {losses[0]:.4f} -> {losses[-1]:.4f} (least {min(losses):.4f}), best "
              f"val loss {min(hist['val_loss']):.4f}, skipped steps 0; test accuracy {ev['accuracy']:.3f} "
              f"({ev['correct']}/{ev['total']}; the reference run {demo.BASELINE_ACCURACY[name]:.3f})",
              flush=True)

    # three steps with dropout 0 on the card against the port on the CPU
    data = graphs[: TRAIN_STEPS * DEMO["batch"]]
    for kind in TRAIN_CLASSES:
        for layout in ("dense", "coo"):
            model = train_model(kind, 0.0)
            on_cpu = Trainer(copy.deepcopy(model), device="cpu", prefetch_depth=0)
            on_card = Trainer(model, device=dev, prefetch_depth=0)
            worst_loss, worst_grad = 0.0, 0.0
            for batch in ConnectomeDataLoader(data, batch_size=DEMO["batch"], shuffle=False, layout=layout):
                want, got = on_cpu.train_epoch([batch]), on_card.train_epoch([batch])
                worst_loss = max(worst_loss, abs(got - want))
                check(abs(got - want) <= LOSS_ATOL, (kind, layout, "loss", got, want))
                for (name, pc), pg in zip(on_cpu.model.named_parameters(), on_card.model.parameters()):
                    torch.testing.assert_close(pg.grad.cpu(), pc.grad, rtol=RTOL, atol=ATOL,
                                               msg=f"{kind} {layout} gradient {name}")
                    worst_grad = max(worst_grad, float((pg.grad.cpu() - pc.grad).abs().max()))
            card_state = on_card.model.state_dict()
            worst_param = 0.0
            for name, value in on_cpu.model.state_dict().items():
                torch.testing.assert_close(card_state[name].cpu(), value, **step_tolerance(kind, name),
                                           msg=f"{kind} {layout} {name} after {TRAIN_STEPS} steps")
                if step_tolerance(kind, name)["rtol"]:
                    worst_param = max(worst_param, float((card_state[name].cpu() - value).abs().max()))
            step = on_card.optimizer.state[next(on_card.model.parameters())]["step"]
            check(step.device.type == dev.type and float(step) == TRAIN_STEPS, (kind, layout, step))
            print(f"[23 training] {kind} {layout}: {TRAIN_STEPS} Adam steps on the card against the port on "
                  f"the CPU (dropout 0, TF32 off): max|loss| {worst_loss:.3e} (atol {LOSS_ATOL}), "
                  f"max|gradient| {worst_grad:.3e} (rtol {RTOL} / atol {ATOL}), max|parameter or moment| "
                  f"{worst_param:.3e} apart from the GCN conv biases and running means (atol "
                  f"{GCN_BIAS_ATOL} / {GCN_RUNNING_MEAN_ATOL}, noise gradients); Adam's step on the card",
                  flush=True)

    # a poisoned batch is skipped: a bitwise no-op, Adam's step count included
    poisoned = copy.deepcopy(graphs[: 2 * DEMO["batch"]])
    poisoned[DEMO["batch"] + 3].node_features[:] = np.nan
    clean, bad = ConnectomeDataLoader(poisoned, batch_size=DEMO["batch"], shuffle=False, layout="dense",
                                      device=dev)
    trainer = Trainer(train_model("gcn", DEMO["dropout"]), device=dev, prefetch_depth=0)
    trainer.train_epoch([clean])
    before = training_state(trainer)
    loss, n, ok = trainer._train_step(bad)
    check((float(loss), float(n), float(ok)) == (0.0, 0.0, 0.0), ("rejected step", loss, n, ok))
    check(same_bits(before, training_state(trainer)), "a rejected step changed the training state")
    check(trainer.train_epoch([bad]) == 0.0 and trainer.last_skipped_steps == 1, "skip count")
    check(same_bits(before, training_state(trainer)), "a skipped epoch changed the training state")
    step = trainer.optimizer.state[next(trainer.model.parameters())]["step"]
    print(f"[23 training] poisoned batch (NaN features): step rejected, loss 0, n 0, skipped 1; parameters, "
          f"buffers and Adam state bitwise unchanged ({len(before)} tensors; Adam's step {float(step):.0f}, "
          f"on {step.device})", flush=True)

    # preempted, then resumed: bitwise equal to an uninterrupted run (dense)
    data = graphs[: 6 * DEMO["batch"]]

    def loaders():
        kw = dict(batch_size=DEMO["batch"], layout="dense", device=dev)
        return (ConnectomeDataLoader(data[: 4 * DEMO["batch"]], shuffle=True, seed=0, **kw),
                ConnectomeDataLoader(data[4 * DEMO["batch"] :], shuffle=False, **kw))

    def make_trainer():
        return Trainer(train_model("gcn", DEMO["dropout"]), seed=3, device=dev)

    ref = make_trainer()
    h_ref = ref.fit(*loaders(), num_epochs=4, patience=10, verbose=False)
    with tempfile.TemporaryDirectory() as ckpt:
        train, val = loaders()
        h_first = make_trainer().fit(PreemptingLoader(train, fire_at=1), val, num_epochs=4, patience=10,
                                     verbose=False, checkpoint_dir=ckpt)
        check(len(h_first["train_loss"]) == 2, ("preempted run", h_first))
        resumed = make_trainer()
        h_resumed = resumed.fit(*loaders(), num_epochs=4, patience=10, verbose=False, checkpoint_dir=ckpt,
                                resume=True)
    check(h_resumed == h_ref, ("resumed history", h_resumed, h_ref))
    check(same_bits(training_state(resumed), training_state(ref)), "resumed state differs")
    check(torch.equal(resumed.generator.get_state(), ref.generator.get_state()), "generator state")
    print(f"[23 training] preempted at epoch 2 (SIGTERM), checkpointed, resumed by a new Trainer: history and "
          f"every parameter, buffer, Adam state and the dropout generator bitwise equal to an uninterrupted "
          f"4-epoch run (dense layout, dropout {DEMO['dropout']})", flush=True)

    # the steps of an epoch make no host sync (batches already on the card)
    batches = list(ConnectomeDataLoader(train_g, batch_size=DEMO["batch"], shuffle=False, layout="dense",
                                        device=dev))
    trainer = Trainer(train_model("gcn", DEMO["dropout"]), device=dev, prefetch_depth=0)
    trainer.train_epoch(batches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sums, steps = trainer._train_steps(batches)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    total, count, oks, _ = sums.tolist()  # loss·n, n, ok, the exchange overflow
    check(steps == len(batches) and oks == steps and count == len(train_g), (steps, count, oks))
    print(f"[23 training] {steps} steps of one epoch under torch.cuda.set_sync_debug_mode('error'): no host "
          f"sync; one at the epoch's end reads loss per graph {total / count:.4f}", flush=True)

    # 25. times (nothing asserted)
    for kind in TRAIN_CLASSES:
        for layout in ("dense", "coo"):
            batch = next(iter(ConnectomeDataLoader(train_g, batch_size=DEMO["batch"], shuffle=False,
                                                   layout=layout, device=dev)))
            guarded = Trainer(train_model(kind, DEMO["dropout"]), device=dev, prefetch_depth=0)
            unguarded = Trainer(train_model(kind, DEMO["dropout"]), device=dev, prefetch_depth=0,
                                skip_nonfinite=False)
            on_ms, off_ms = host_ms([lambda: guarded._train_step(batch), lambda: unguarded._train_step(batch)],
                                    iters=20)
            rows = device_breakdown(lambda: guarded._train_step(batch), iters=10)
            busy = sum(ms for _, ms in rows)
            print(f"[25 train times] {card} | {kind} {layout}, batch {DEMO['batch']}, hidden {DEMO['hidden']}, "
                  f"L={DEMO['layers']}: {on_ms:.3f} ms per train step with the guard, {off_ms:.3f} ms without "
                  f"(host clock ending in a synchronize, median of 20, in turns); device busy {busy:.3f} "
                  f"ms per step ({busy / on_ms:.1%} of the step; torch.profiler, mean of 10), in "
                  f"{len(rows)} kernels", flush=True)
            if (kind, layout) == ("gcn", "dense"):
                for name, ms in rows[:10]:
                    print(f"[25 train times] {card} |     {ms:9.4f} ms/step  {name[:160]}", flush=True)
    epoch_graphs = graphs[: BASELINE_EPOCH["graphs"]]
    for label, kw in (("COO, host loader, prefetch 2", dict(layout="coo")),
                      ("dense, host loader, prefetch 2", dict(layout="dense")),
                      ("dense, loader on the card, prefetch 2", dict(layout="dense", device=dev))):
        loader = ConnectomeDataLoader(epoch_graphs, batch_size=BASELINE_EPOCH["batch"], shuffle=True,
                                      seed=0, **kw)
        trainer = Trainer(train_model("gcn", DEMO["dropout"]), device=dev)
        (epoch_ms,) = host_ms([lambda: trainer.train_epoch(loader)], iters=3)
        print(f"[25 train times] {card} | GCN train epoch, {BASELINE_EPOCH['graphs']} graphs, batch "
              f"{BASELINE_EPOCH['batch']} ({label}): {epoch_ms / 1e3:.4f} s "
              f"({BASELINE_EPOCH['graphs'] / epoch_ms * 1e3:.1f} graphs/s; host clock, median of 3); "
              f"BASELINE.md's reference torch on 1 CPU: {BASELINE_EPOCH['cpu_s']} s (~648 graphs/s)",
              flush=True)
    print(f"[25 train times] {card} | phases 23 and 25 (training) took {time.perf_counter() - t_start:.1f} s", flush=True)


def gather_operands(N, F, L, dtype, device, seed=0):
    """The script's inputs (``gather_dma_experiments.py:157-165``), bf16 by
    rounding the float32 table."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        table = torch.from_numpy(rng.integers(0, 2**30, (N, F)).astype(np.int32))
    else:
        table = torch.from_numpy(rng.standard_normal((N, F)).astype(np.float32))
        table = table.to(torch.bfloat16) if dtype == "bf16" else table
    idx = torch.from_numpy(rng.integers(0, N, L).astype(np.int32))
    return table.to(device), idx.to(device)


def bits(t):
    """The raw bits of a 2- or 4-byte tensor, for a bitwise comparison."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def bare_gather_launch(table, idx, K=8, C=1024):
    """B1's C entry point with its arguments ready: ``(launch, out)``, where
    ``launch()`` gathers into ``out`` without the wrapper's Python and
    returns the entry's error code.  Counts no launch."""
    L, (N, F) = idx.numel(), table.shape
    out = torch.empty((L, F), dtype=table.dtype, device=table.device)
    args = (table.data_ptr(), idx.data_ptr(), out.data_ptr(), L, N, F * table.element_size(),
            gd.vector_bytes(table, out), K, C, bq._stream(table.device))
    entry = _build.library().cgt_row_gather
    return (lambda: entry(*args)), out


def bare_gather(table, idx, K=8, C=1024):
    """``table[idx]`` by the C entry alone (:func:`bare_gather_launch`)."""
    launch, out = bare_gather_launch(table, idx, K, C)
    err = launch()
    check(err == 0, ("B1 launch alone failed", tuple(table.shape), K, C, err))
    return out


def host_us(fn, calls=HOST_CALLS) -> float:
    """Host time (us) per call of ``fn``: the mean over ``calls`` calls
    after one, with no sync among them (what the host spends issuing)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def gather_host_pieces(table, idx) -> list[tuple[str, float]]:
    """Where B1's entry point spends its host time: the entry point, each
    piece of its launch path alone, the bare C call, and
    ``torch.index_select`` (with its output allocation, as the entry
    point's)."""
    dev = table.device
    L, F = idx.numel(), table.shape[1]
    index = dev.index
    launch, out = bare_gather_launch(table, idx)
    row_bytes, t_ptr, o_ptr = F * table.element_size(), table.data_ptr(), out.data_ptr()
    pieces = [
        ("dma_gather", lambda: gd.dma_gather(table, idx)),
        ("torch.index_select", lambda: torch.index_select(table, 0, idx)),
        ("operand checks", lambda: gd._check(table, idx, 8, 1024)),
        ("is_cuda and is_contiguous", lambda: table.is_cuda and table.is_contiguous() and idx.is_contiguous()),
        ("table.new_empty", lambda: table.new_empty((L, F))),
        ("torch.empty", lambda: torch.empty((L, F), dtype=table.dtype, device=dev)),
        ("get_device and current_device", lambda: table.get_device() != torch.cuda.current_device()),
        ("three data_ptr()", lambda: (table.data_ptr(), idx.data_ptr(), out.data_ptr())),
        ("the word (_word)", lambda: gd._word(row_bytes, t_ptr, o_ptr)),
        ("the entry (_entry())", gd._entry),
        ("the stream's raw handle", lambda: torch._C._cuda_getCurrentRawStream(index)),
        ("the bare C call", launch),
    ]
    return [(piece, host_us(fn)) for piece, fn in pieces]


def gather_l2_curve(dev, card) -> None:
    """What bounds B1 at case (a): the same 4,194,304 indices of 256-B rows
    into tables from 4.2 MB (resident in L2) to the script's 67.1 MB; the
    launch alone, CUDA events, median of 10, with the write-only floor
    (the 1.07 GB output over HBM's rate) beside it."""
    floor_ms = (1 << 22) * 256 / HBM_BYTES_PER_S * 1e3
    times = []
    for N in (16_384, 65_536, 131_072, 196_608, 262_144):
        table, idx = gather_operands(N, 64, 1 << 22, "f32", dev, seed=N)
        (t,) = cuda_ms([bare_gather_launch(table, idx)[0]], iters=10, warmup=2)
        times.append(f"{nbytes(table) / 1e6:.1f} MB {t:.4f} ms")
        del table, idx
    print(f"[25 gather L2] {card} | 4,194,304 rows of 256 B by table size (launch alone, CUDA events, median "
          f"of 10): {'; '.join(times)}; the output alone over HBM's rate {floor_ms:.4f} ms", flush=True)


def gather_phases(dev, card) -> list[dict]:
    """Phases 24 and the B1 half of 25; returns B1's entries of the JSON line."""
    t_start = time.perf_counter()
    # 24. B1 against its plain version, bitwise
    checked = 0
    for N, F_, L in GATHER_SMALL:
        for dtype in ("f32", "int32", "bf16"):
            table, idx = gather_operands(N, F_, L, dtype, dev, seed=N + L)
            want = gd.dma_gather_reference(table, idx)
            for K in gd.K_OUTSTANDING:
                for C in GATHER_CHUNKS:
                    got = gd.dma_gather(table, idx, k_outstanding=K, chunk=C)
                    check(got.shape == want.shape and torch.equal(bits(got), bits(want)),
                          ("B1", N, F_, L, dtype, K, C))
                    checked += 1
    torch.cuda.synchronize()
    failures = {}
    for F_ in (64, 65):  # 16-B words, then 4-B words
        for bad in (300, -1):  # the kernel traps, which leaves a context unusable: one child each
            child = subprocess.run([sys.executable, "-c", OUT_OF_RANGE_CHILD, str(bad), str(F_)], cwd=REPO,
                                   capture_output=True, text=True, timeout=300)
            # the trap surfaces at the synchronize (torch's "CUDA error"), or at the
            # launch's own error check if the kernel has already stopped by then
            errors = [ln for ln in child.stderr.splitlines() if "CUDA error" in ln or "kernel launch failed" in ln]
            check(child.returncode != 0 and "synchronized" not in child.stdout and bool(errors),
                  ("B1 took index", bad, F_, child.returncode, child.stdout[-500:], child.stderr[-2000:]))
            failures[F_, bad] = errors[0].strip()[:120]
    table, idx = gather_operands(300, 64, 1000, "f32", dev)
    check(torch.equal(bits(gd.dma_gather(table, idx)), bits(gd.dma_gather_reference(table, idx))),
          "B1 after the children's traps")
    print(f"[24 gather] dma_gather against table[idx] on the card: {checked} calls bitwise equal (every K in "
          f"{gd.K_OUTSTANDING} and C in {GATHER_CHUNKS}; (N, F, L) in {GATHER_SMALL}; f32, int32, bf16); "
          f"an index N, then -1, of a 300-row table of F float32 fails a child process with the kernel's "
          f"trap: {failures}; this process still gathers", flush=True)
    cases = {name: gather_operands(N, F_, L, dtype, dev) for name, N, F_, L, dtype in GATHER_CASES}
    torch.cuda.synchronize()
    reset_counters()
    outs, launches = {}, {}
    for name, (table, idx) in cases.items():
        before = counts()
        outs[name] = gd.dma_gather(table, idx)
        torch.cuda.synchronize()
        delta = {c: v - before[c] for c, v in counts().items()}
        check(delta == {c: 1 if c == "B1" else 0 for c in COUNTERS}, (name, delta))
        launches[name] = delta["B1"]
    for name, (table, idx) in cases.items():
        want = gd.dma_gather_reference(table, idx)
        check(torch.equal(bits(outs[name]), bits(want)), (name, "not bitwise equal"))
        check(torch.equal(bits(bare_gather(table, idx)), bits(want)), (name, "launch alone not bitwise equal"))
        print(f"[24 gather main path] {name}: table {tuple(table.shape)} {table.dtype}, {idx.numel():,} "
              f"indices: output {tuple(outs[name].shape)}, 1 launch in {gd.vector_bytes(table, outs[name])}-B "
              f"words, bitwise equal to table[idx], and the launch alone too", flush=True)
    del outs

    # 25. times (nothing asserted)
    entries = []
    for name, (table, idx) in cases.items():
        L, row_bytes = idx.numel(), table.shape[1] * table.element_size()
        distinct = int(torch.unique(idx).numel())
        b_ms, b_by = bound(distinct * row_bytes + nbytes(idx) + L * row_bytes, 0, "f32")
        launch_alone, _ = bare_gather_launch(table, idx)
        fns = [lambda: gd.dma_gather(table, idx), launch_alone,
               lambda: gd.dma_gather_reference(table, idx), lambda: torch.index_select(table, 0, idx)]
        ms = cuda_ms(fns, iters=20, warmup=3)
        dev_alone, dev_lib = device_ms(fns[1]), device_ms(fns[3])
        torch.cuda.set_sync_debug_mode("error")  # any synchronizing call raises
        try:
            synced = [gd.dma_gather(table, idx) for _ in range(3)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(all(torch.equal(bits(out), bits(synced[0])) for out in synced), (name, "under sync debug"))
        del synced
        sweep = cuda_ms([lambda K=K, C=C: gd.dma_gather(table, idx, k_outstanding=K, chunk=C)
                         for K in gd.K_OUTSTANDING for C in (256, 1024)], iters=20, warmup=3)
        gbytes = L * row_bytes / 1e9
        table_mb, touched_mb = nbytes(table) / 1e6, distinct * -(-row_bytes // 32) * 32 / 1e6
        print(f"[25 gather times] {card} | {name}: table {tuple(table.shape)} {table.dtype} ({table_mb:.1f} MB; "
              f"{'fits' if table_mb < L2_BYTES / 1e6 else 'exceeds'} the 50 MB L2; its {distinct:,} touched rows "
              f"span {touched_mb:.1f} MB of 32-B sectors), {L:,} indices: dma_gather (K=8, C=1024; no host "
              f"sync: 3 calls under set_sync_debug_mode('error')) {ms[0]:.4f} ms, launch alone (the C entry "
              f"with its arguments ready) {ms[1]:.4f} ms, plain table[idx] {ms[2]:.4f} ms, "
              f"torch.index_select {ms[3]:.4f} ms per call (CUDA events, median of 20, in turns); launch "
              f"alone {ms[1] * 1e6 / L:.3f} ns/row, {gbytes / ms[1] * 1e3:.4g} GB/s of rows; device time (torch."
              f"profiler, mean of 20) launch alone {dev_alone:.4f} ms, index_select {dev_lib:.4f} ms; bound "
              f"{b_ms:.5f} ms ({b_by}: {distinct:,} distinct rows read, the indices and the output), the "
              f"launch at {b_ms / ms[1]:.1%} of it by events, "
              f"{f'{b_ms / dev_alone:.1%}' if dev_alone else 'not seen'} by device time", flush=True)
        for (K, C), t in zip([(K, C) for K in gd.K_OUTSTANDING for C in (256, 1024)], sweep):
            print(f"[25 gather sweep] {card} | {name} K={K} C={C}: {t:.4f} ms (the entry point, the eight "
                  f"in turns), {t * 1e6 / L:.3f} ns/row, {gbytes / t * 1e3:.4g} GB/s", flush=True)
        if name == "sampler_pair_gather":
            print(f"[25 gather host] {card} | {name}: host time per call (host clock, mean of "
                  f"{HOST_CALLS} calls after one, no sync among them): "
                  + "; ".join(f"{piece} {us:.2f} us" for piece, us in gather_host_pieces(table, idx)),
                  flush=True)
        entries.append({
            "name": f"dma_gather ({name})", "route": "cuda", "source": GATHER_SOURCE,
            "replaces": GATHER_REPLACES, "launches": launches[name],
            "max_abs_err": 0.0, "ms": ms[0], "plain_ms": ms[2], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": ms[3],
        })
    del cases
    gather_l2_curve(dev, card)
    print(f"[25 gather times] {card} | phases 24 and 25 (B1) took {time.perf_counter() - t_start:.1f} s", flush=True)
    return entries


def product_gate(a, b, got) -> float:
    """The worst ratio of |got - the float64 product of the bfloat16-rounded
    operands| to 1e-5 · Σ|a|·|b| (tests/test_torch_mixed_precision.py)."""
    a64, b64 = conv_layers.round_bf16(a).double(), conv_layers.round_bf16(b).double()
    want = torch.matmul(a64, b64)
    return float(((got.double() - want).abs() / (1e-5 * torch.matmul(a64.abs(), b64.abs()))).max())


def grad_rel_errors(on_card, on_cpu, kind, zeroed=None) -> dict:
    """Relative Frobenius error of each gradient on the card against the
    CPU's, and of all of them as one vector (``"all"``); a GCN conv's bias
    left out: BatchNorm follows it, so its gradient is float32 noise
    (tests/test_torch_mixed_precision.py).  ``zeroed`` names a gradient
    read as zeros, a control the gates must refuse."""
    out, card, cpu = {}, [], []
    for (name, pc), pg in zip(on_cpu.model.named_parameters(), on_card.model.parameters()):
        if kind == "gcn" and name.startswith("convs.") and name.endswith(".bias"):
            continue
        g = torch.zeros_like(pc.grad) if name == zeroed else pg.grad.cpu()
        out[name] = float(torch.linalg.norm(g - pc.grad) / torch.linalg.norm(pc.grad))
        card.append(g.flatten())
        cpu.append(pc.grad.flatten())
    card, cpu = torch.cat(card), torch.cat(cpu)
    out["all"] = float(torch.linalg.norm(card - cpu) / torch.linalg.norm(cpu))
    return out


def step_gates_pass(rel) -> bool:
    """The bf16 train step's gradient gates: all of them, and each alone."""
    return rel["all"] <= BF16_STEP_GRAD_REL and max(v for k, v in rel.items() if k != "all") <= BF16_STEP_TENSOR_REL


def out_dtype_product(a, b):
    """The other route to ``mixed_matmul``'s bf16 product, timed against
    it and used nowhere in the port: cuBLAS on the bfloat16 operands into
    a float32 output (``out_dtype``, which has no derivative)."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    with conv_layers.exact_products():
        if b.dim() == 2:
            out = torch.mm(a16.reshape(-1, a.shape[-1]), b16, out_dtype=torch.float32)
            return out.view(*a.shape[:-1], b.shape[-1])
        return torch.bmm(a16, b16, out_dtype=torch.float32)


@contextlib.contextmanager
def products_by(product):
    """The dense layers' bf16 products computed by ``product(a, b)``
    instead of ``mixed_matmul``'s (float32 products stay as they are)."""
    taken = conv_layers.mixed_matmul

    def mixed(a, b, compute_dtype=torch.float32):
        return product(a, b) if compute_dtype == torch.bfloat16 else taken(a, b, compute_dtype)

    conv_layers.mixed_matmul = mixed
    try:
        yield
    finally:
        conv_layers.mixed_matmul = taken


def bf16_output_product(a, b, exact=conv_layers.mixed_matmul):
    """A faulty bf16 product, the train step's control: ``mixed_matmul``'s
    result rounded to bfloat16, as a bfloat16 output would round it."""
    return conv_layers.round_bf16(exact(a, b, torch.bfloat16))


def grad_gate(a, b, out, got, want) -> float:
    """The worst ratio of the card's gradients of ``sum(out²)`` to the
    CPU's: each is a float32 sum of exact products rounded to bfloat16
    last, so they may sit one bfloat16 step (2^-7 relative) apart, plus
    1e-5 of the sum of the products' magnitudes for the sums' order."""
    a16, b16, g = conv_layers.round_bf16(a).abs(), conv_layers.round_bf16(b).abs(), 2 * out.abs()
    if b.dim() == 2:
        scale_b = a16.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
    else:
        scale_b = a16.transpose(-1, -2) @ g
    scales = (g @ b16.transpose(-1, -2), scale_b)
    return max(float(((gc - g0).abs() / (2.0 ** -7 * g0.abs() + 1e-5 * sc)).max())
               for gc, g0, sc in zip(got, want, scales))


def bf16_phase(dev, card) -> None:
    """Phase 26: mixed precision (``compute_dtype=torch.bfloat16``) on the card."""
    t_start = time.perf_counter()
    flags = torch.backends.cuda.matmul
    found = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
    print(f"[26 bf16] {card} | precision flags as found: allow_tf32 {found[0]} (phase 1 switched it off), "
          f"allow_bf16_reduced_precision_reduction {found[1]}; mixed_matmul (round the operands, then a "
          f"float32 product) pins both off around its products, backward too", flush=True)
    graphs = generate_dataset(num_subjects=DEMO["batch"], seed=DEMO["seed"])
    batch_cpu = collate_dense(graphs)
    batch = batch_cpu.to(dev)
    B, n = batch.node_features.shape[:2]
    H, L = DEMO["hidden"], DEMO["layers"]

    # the product and its gradients on the card against the CPU's, with the
    # caller's flags off and on
    rng = np.random.default_rng(0)
    shapes = [((B * n, 5), (5, H)), ((B * n, H), (H, H)), ((B, n, n), (B, n, H)), ((B, n, 2 * H), (2 * H, H))]
    operands = [tuple(torch.from_numpy(rng.standard_normal(sh).astype(np.float32)) for sh in pair)
                for pair in shapes]
    worst, worst_grad = 0.0, 0.0
    for on in (False, True):
        flags.allow_tf32 = flags.allow_bf16_reduced_precision_reduction = on
        try:
            for a, b in operands:
                ac, bc = (t.to(dev).clone().requires_grad_() for t in (a, b))
                got = conv_layers.mixed_matmul(ac, bc, torch.bfloat16)
                got.square().sum().backward()
                torch.cuda.synchronize()
                check((flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction) == (on, on),
                      "mixed_matmul did not restore the flags")
                worst = max(worst, product_gate(a, b, got.detach().cpu()))
                a0, b0 = (t.detach().clone().requires_grad_() for t in (a, b))
                out0 = conv_layers.mixed_matmul(a0, b0, torch.bfloat16)
                out0.square().sum().backward()
                worst_grad = max(worst_grad, grad_gate(a, b, out0.detach(), (ac.grad.cpu(), bc.grad.cpu()),
                                                       (a0.grad, b0.grad)))
        finally:
            flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = found
    check(worst <= 1.0, ("mixed_matmul on the card outside 1e-5 of sum |a||b|", worst))
    check(worst_grad <= 1.0, ("mixed_matmul's gradients on the card more than a bfloat16 step off", worst_grad))
    print(f"[26 bf16] mixed_matmul on the card at the model's four product shapes, flags off and on: worst "
          f"error {worst:.3f} of the gate (1e-5 of sum |a||b| from the float64 product of the rounded "
          f"operands); gradients against the CPU's (round, multiply in float32) within {worst_grad:.3f} of "
          f"a bfloat16 step (2^-7 relative)", flush=True)

    for kind in KERNELS:
        f32 = make_model(kind, 5, H, L).to(dev)
        bf16 = make_model(kind, 5, H, L, compute_dtype=torch.bfloat16)
        with torch.no_grad():
            on_cpu = bf16(batch_cpu)
            bf16.to(dev)
            got, want = bf16(batch), f32(batch)
            torch.cuda.synchronize()
            check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()), (kind, got.dtype))
            torch.testing.assert_close(got.cpu(), on_cpu, rtol=BF16_CPU_TOL, atol=BF16_CPU_TOL)
            torch.testing.assert_close(got, want, rtol=BF16_F32_TOL, atol=BF16_F32_TOL)
            agree = float((got.argmax(1) == want.argmax(1)).float().mean())
            check(agree >= BF16_F32_AGREE, (kind, "argmax agreement", agree))
            # forward_auto serves it in float32 through K1/K2, as JAX's does
            fused_gcn_kernel.launches = fused_sage_kernel.launches = 0
            served = fused.forward_auto(bf16, batch)
            torch.cuda.synchronize()
            launches = {"gcn": fused_gcn_kernel.launches, "sage": fused_sage_kernel.launches}
            check(launches == {k: int(k == kind) for k in launches}, (kind, launches))
            torch.testing.assert_close(served, want, rtol=RTOL, atol=ATOL)

            def other_route():
                with products_by(out_dtype_product):
                    return bf16(batch)

            taken_ms, other_ms, f32_ms = cuda_ms([lambda: bf16(batch), other_route, lambda: f32(batch)], iters=50)
            a, b = (t.to(dev) for t in operands[2])
            mm_ms = cuda_ms([lambda: conv_layers.mixed_matmul(a, b, torch.bfloat16),
                             lambda: out_dtype_product(a, b)], iters=100)
        print(f"[26 bf16] {card} | {kind} hidden {H}, L={L}, dense batch of {B} (n={n}): bf16 forward "
              f"against the port's CPU bf16 path max|diff| {float((got.cpu() - on_cpu).abs().max()):.3e} "
              f"(gate {BF16_CPU_TOL}), against float32 max|diff| {float((got - want).abs().max()):.3e} "
              f"(gate {BF16_F32_TOL}), argmax agreement {agree:.3f}; forward_auto: {launches[kind]} "
              f"{KERNELS[kind]['name']} launch, float32 logits, max|served - float32 unfused| "
              f"{float((served - want).abs().max()):.3e} (rtol {RTOL} / atol {ATOL}); the bf16 eval forward "
              f"(CUDA events, median of 50, in turns): mixed_matmul's route (round, then a float32 product) "
              f"{taken_ms:.4f} ms, the other (bf16 operands, out_dtype float32) {other_ms:.4f} ms, the "
              f"float32 forward {f32_ms:.4f} ms; the [{B}, {n}, {n}] x [{B}, {n}, {H}] product alone: "
              f"{mm_ms[0]:.4f} ms against {mm_ms[1]:.4f} ms", flush=True)

    # one bf16 train step on the card against the CPU (dropout 0), the
    # gates' controls, then step times
    for kind in KERNELS:
        model = train_model(kind, 0.0)
        model.compute_dtype = torch.bfloat16
        on_cpu = Trainer(copy.deepcopy(model), device="cpu", prefetch_depth=0)
        faulty = Trainer(copy.deepcopy(model), device=dev, prefetch_depth=0)
        on_card = Trainer(model, device=dev, prefetch_depth=0)
        want, got = on_cpu.train_epoch([batch_cpu]), on_card.train_epoch([batch])
        check(abs(got - want) <= BF16_STEP_LOSS_ATOL, (kind, "bf16 step loss", got, want))
        rel = grad_rel_errors(on_card, on_cpu, kind)
        check(step_gates_pass(rel), (kind, "bf16 step gradients", rel))
        worst = max((v, k) for k, v in rel.items() if k != "all")
        with products_by(bf16_output_product):
            faulty_loss = faulty.train_epoch([batch])
        bad = grad_rel_errors(faulty, on_cpu, kind)
        bad_worst = max((v, k) for k, v in bad.items() if k != "all")
        check(not step_gates_pass(bad), (kind, "the gates passed a bfloat16 output of every product", bad))
        dropped = [grad_rel_errors(on_card, on_cpu, kind, zeroed=name) for name in rel if name != "all"]
        check(not any(step_gates_pass(r) for r in dropped), (kind, "the gates passed a zeroed gradient"))
        by_all = sum(r["all"] > BF16_STEP_GRAD_REL for r in dropped)
        f32_trainer = Trainer(train_model(kind, 0.0), device=dev, prefetch_depth=0)
        step_ms = host_ms([lambda: on_card._train_step(batch), lambda: f32_trainer._train_step(batch)], iters=20)
        print(f"[26 bf16] {card} | {kind}: one bf16 Adam step (dense batch of {B}, dropout 0) on the card "
              f"against the CPU: |loss| {abs(got - want):.3e} (atol {BF16_STEP_LOSS_ATOL}), gradients' relative "
              f"Frobenius error {rel['all']:.3e} over all of them (gate {BF16_STEP_GRAD_REL}), the worst tensor "
              f"{worst[1]} {worst[0]:.3e} (gate {BF16_STEP_TENSOR_REL}); controls, which must fail the gates: "
              f"a bfloat16 output of every product: |loss| {abs(faulty_loss - want):.3e}, all {bad['all']:.3e}, "
              f"worst tensor {bad_worst[1]} {bad_worst[0]:.3e}; each of the {len(dropped)} gradients zeroed in "
              f"turn: {by_all} refused by the gate over all of them, {len(dropped)} by each tensor's; a train "
              f"step (host clock ending in a synchronize, median of 20, in turns): bf16 {step_ms[0]:.3f} ms, "
              f"float32 {step_ms[1]:.3f} ms", flush=True)
    print(f"[26 bf16] {card} | phase 26 took {time.perf_counter() - t_start:.1f} s", flush=True)


def bench_and_entry_phase(dev, card) -> None:
    """Phase 27: ``bench_torch.py`` as a subprocess, then ``entry()``."""
    t_start = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, ("bench_torch.py failed", proc.returncode, proc.stderr[-3000:]))
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"[27 bench] {line}", flush=True)
    result = json.loads(lines[-1])
    check(set(result) == {"metric", "value", "unit", "vs_baseline"}, result)
    check(result["metric"] == "gcn_fwd_edge_messages_per_s" and result["value"] > 0, result)
    check(any(line.startswith("[bench] gate:") and line.endswith("passed") for line in lines), "bench gate")
    print(f"[27 bench] {card} | bench_torch.py's last line: {lines[-1]}", flush=True)

    forward, (model, batch) = port_entry.entry()
    logits = forward(model, batch)
    with torch.no_grad():
        want = model(batch)
    cpu_forward, (cpu_model, cpu_batch) = port_entry.entry(device="cpu")
    on_cpu = cpu_forward(cpu_model, cpu_batch)
    check(logits.is_cuda and logits.shape == (16, 2) and bool(torch.isfinite(logits).all()), logits.shape)
    torch.testing.assert_close(logits, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(logits.cpu(), on_cpu, rtol=RTOL, atol=ATOL)
    print(f"[27 entry] {card} | entry() on {logits.device}: logits {tuple(logits.shape)}, max|forward - "
          f"model(batch)| {float((logits - want).abs().max()):.3e}, max|card - CPU entry| "
          f"{float((logits.cpu() - on_cpu).abs().max()):.3e} (rtol {RTOL} / atol {ATOL}); phase 27 took "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)


def coo_node_logits(model, s, r, w, x):
    """Eval-mode logits of a node GCN over a COO graph in float32: each
    conv's COO form (``GCNConv.forward``), BatchNorm's running moments, ReLU."""
    h = x
    for conv, norm in zip(model.convs, model.batch_norms):
        h = torch.relu(norm(conv(h, s, r, w)))
    return model.head(h)


def layout_stream_bytes(num_nodes, W, block, feat) -> float:
    """The bytes ``plan_layout``'s cost model prices for one float32 band
    SpMM at bandwidth W (band, activation windows, output)."""
    cost, _ = layout._band_cost_curve(np.zeros(W + 1, np.int64), num_nodes, 0, block=block, feat=feat,
                                      hbm_gbps=1e-9, scatter_ns_per_edge=0.0, max_band_bytes=np.inf,
                                      quantized=False)
    return float(cost[W])


@torch.no_grad()
def layout_phase(dev, card, graph) -> None:
    """Phase 28: the giant-graph set-up: native helpers, the layout
    pipeline on a scrambled graph into K3's hybrid serving, and the two
    rates of the planner's cost model."""
    t_start = time.perf_counter()
    check(native.AVAILABLE, "the native helpers did not build on the card's host")
    print(f"[28 layout] {card} | native.AVAILABLE {native.AVAILABLE}, {os.path.basename(native.library_path())} "
          f"(built in phase 2); planner defaults: hbm_gbps {layout.HBM_GBPS}, scatter_ns_per_edge "
          f"{layout.SCATTER_NS_PER_EDGE}", flush=True)

    # the two rates the cost model prices, measured first
    sc = SCATTER
    rng = np.random.default_rng(2)
    r = np.sort(rng.integers(0, sc["num_nodes"], sc["num_edges"]))
    s = rng.integers(0, sc["num_nodes"], sc["num_edges"])
    edges = [torch.from_numpy(a).to(dev) for a in (s, r)]
    w = torch.from_numpy(rng.random(sc["num_edges"], np.float32)).to(dev)
    xs = torch.randn(sc["num_nodes"], sc["feat"], device=dev)
    coo_ms, = cuda_ms([lambda: coo_spmm(w, *edges, xs, sc["num_nodes"])], iters=20, warmup=3)
    scatter_ns = coo_ms * 1e6 / sc["num_edges"]
    del edges, w, xs
    n, block = graph.num_nodes, GIANT["block"]
    a = to_banded(graph.edge_index[0], graph.edge_index[1], graph.edge_weight, n, block=block, device=dev)
    xb = torch.randn(n, sc["feat"], device=dev)
    band_ms, = cuda_ms([lambda: banded_spmm(a, xb)], iters=20, warmup=3)
    priced = layout_stream_bytes(n, a.bandwidth, block, sc["feat"])
    hbm_gbps = priced / (band_ms * 1e-3) / 1e9
    del a, xb
    print(f"[28 layout rates] {card} | scatter_ns_per_edge {scatter_ns:.4f} (the port's coo_spmm, "
          f"{sc['num_edges']:,} random edges over {sc['num_nodes']:,} nodes, F={sc['feat']}: {coo_ms:.4f} ms, "
          f"CUDA events, median of 20); hbm_gbps {hbm_gbps:.2f} (the port's float32 banded_spmm on phase 6's "
          f"band, {n:,} nodes, W=2, block {block}, F={sc['feat']}: {priced:,.0f} B priced by "
          f"_band_cost_curve in {band_ms:.4f} ms)", flush=True)

    # the scrambled graph, planned, built and served
    cfg = SCRAMBLED
    g = generate_spatial_graph(cfg["num_nodes"], degree=cfg["degree"], band=cfg["band"],
                               num_features=cfg["feat"], seed=cfg["seed"], shortcut_frac=cfg["shortcut_frac"])
    gs = apply_ordering(g, np.random.default_rng(cfg["seed"] + 1).permutation(cfg["num_nodes"]))
    s, r, w = gs.edge_index[0], gs.edge_index[1], gs.edge_weight
    t0 = time.perf_counter()
    plan = plan_layout(s, r, gs.num_nodes, weights=w, feat=cfg["feat"], quantized=True)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_layout(plan, s, r, w, gs.num_nodes, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    adj, g2, auto_plan = auto_layout(gs, quantized=True, device=dev)
    torch.cuda.synchronize()
    t_auto = time.perf_counter() - t0
    check(auto_plan.format == plan.format and np.array_equal(auto_plan.perm, plan.perm), "auto_layout's plan")
    check(plan.format in ("banded", "hybrid") and plan.reordered, ("the plan kept the scramble", plan.format))
    model = make_node_model(BandedNodeGCN, dev)
    x_perm = torch.from_numpy(g2.node_features).to(dev)
    reset_counters()
    adj_q, dinv = model.prepare_quantized(adj, feature_major=False)
    logits = model.apply_quantized(adj_q, dinv, x_perm)
    torch.cuda.synchronize()
    launches = counts()
    check(launches["K3"] == GIANT["layers"] and sum(launches.values()) == GIANT["layers"], launches)
    edges = [torch.from_numpy(a.astype(np.int64)).to(dev) for a in (s, r)]
    ref = coo_node_logits(model, *edges, torch.from_numpy(w).to(dev), torch.from_numpy(gs.node_features).to(dev))
    ref = ref[torch.from_numpy(plan.perm).to(dev)]
    rel, agree = quant_gate(logits, ref, "bf16")
    spmm = bq.serving_spmm(adj_q)
    xf = torch.randn(gs.num_nodes, cfg["feat"], device=dev)
    spmm_ms, = cuda_ms([lambda: spmm(adj_q, xf)], iters=20, warmup=3)
    print(f"[28 layout] {card} | scrambled 5c graph ({gs.num_nodes:,} nodes, {gs.num_edges:,} edges, "
          f"{cfg['shortcut_frac']:.0%} shortcuts, ids permuted): plan {plan.format}, W={plan.bandwidth} "
          f"(block {plan.block}), remainder {plan.remainder_frac:.4f}, index bandwidth "
          f"{plan.bandwidth_before:,} -> {plan.bandwidth_after:,}; host plan_layout {t_plan:.2f} s, "
          f"build_layout {t_build:.2f} s (on the card), auto_layout {t_auto:.2f} s; serving "
          f"prepare_quantized + apply_quantized: launches {launches}; against the float32 COO model on the "
          f"scrambled input through plan.perm: relative Frobenius {rel:.3e}, argmax agreement {agree:.4f} "
          f"(gate {GATES['bf16']}); one SpMM of the plan (serving_spmm: K3 "
          f"{'plus the COO remainder ' if plan.format == 'hybrid' else ''}at F={cfg['feat']}): predicted "
          f"{plan.est_us['chosen']:.1f} µs, measured {spmm_ms * 1e3:.1f} µs (CUDA events, median of 20); "
          f"COO predicted {plan.est_us['coo']:.1f} µs; phase 28 took {time.perf_counter() - t_start:.1f} s",
          flush=True)


def sampled_graph():
    """S2's graph and its learnable neighborhood-mean label
    (``benchmarks/suite.py:1174-1189``, the sums by ``bincount``)."""
    g = generate_spatial_graph(SAMPLED["num_nodes"], degree=SAMPLED["degree"], band=SAMPLED["band"],
                               shortcut_frac=SAMPLED["shortcut_frac"], seed=0)
    src, dst = g.edge_index
    num = np.bincount(dst, weights=g.edge_weight * g.node_features[src, 0], minlength=g.num_nodes)
    den = np.bincount(dst, weights=g.edge_weight, minlength=g.num_nodes)
    return g, (num / (den + 1e-8) > 0).astype(np.int32)


def masked_ce(logits, batch):
    """The Trainer's loss: cross-entropy averaged over the labelled seeds."""
    ce = F.cross_entropy(logits, batch.labels, reduction="none")
    m = batch.label_mask.to(logits.dtype)
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def step_on(model, batch):
    """One forward and backward of ``model`` in train mode; returns the loss
    and the gradients on the CPU."""
    model.train()
    model.zero_grad(set_to_none=True)
    loss = masked_ce(model(batch), batch)
    loss.backward()
    return loss.item(), {k: p.grad.detach().cpu() for k, p in model.named_parameters()}


def check_step_matches(card_step, cpu_step, what) -> tuple[float, float]:
    """A step on the card against the same step on the CPU: loss rtol 1e-5,
    gradients rtol 1e-4 / atol 1e-5; returns the largest differences."""
    (loss_g, grads_g), (loss_c, grads_c) = card_step, cpu_step
    check(abs(loss_g - loss_c) <= 1e-5 * abs(loss_c) and np.isfinite(loss_g), (what, loss_g, loss_c))
    for name, g in grads_c.items():
        torch.testing.assert_close(grads_g[name], g, rtol=RTOL, atol=ATOL, msg=f"{what} gradient {name}")
    return abs(loss_g - loss_c), max(float((grads_g[k] - g).abs().max()) for k, g in grads_c.items())


def epoch_ms(trainer, loader, steps: int) -> tuple[float, float]:
    """One timed epoch: ms a step (host clock ending in a synchronize) and
    its loss."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = trainer.train_epoch(loader)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps, loss


def dispatches(fn) -> int:
    """The runtime calls that put work on the card while ``fn`` runs:
    kernel and graph launches, copies and fills (torch.profiler)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if DISPATCH.match(e.key))


def state_diff(a: Trainer, b: Trainer) -> dict:
    """The largest difference of two trainers' parameters, BatchNorm
    buffers and Adam state (0.0 where bitwise equal)."""
    def groups(t):
        params = [p.detach() for p in t.model.parameters()]
        adam = [v for p in t.model.parameters() for v in t.optimizer.state[p].values() if torch.is_tensor(v)]
        return {"parameters": params, "buffers": list(t.model.buffers()), "Adam state": adam}

    out = {}
    for (name, xs), ys in zip(groups(a).items(), groups(b).values()):
        check(len(xs) == len(ys), (name, len(xs), len(ys)))
        out[name] = max(float((x.double() - y.double()).abs().max()) for x, y in zip(xs, ys))
    return out


def diff_text(diff: dict) -> str:
    return ", ".join(f"{k} {'bitwise' if v == 0.0 else f'max|diff| {v:.3e}'}" for k, v in diff.items())


def sampled_phases(dev, card):
    """Phases 29-31: sampled node training at S2, SD2, SE2 and SME2's widths;
    returns S2's graph and labels."""
    t_start = time.perf_counter()
    S, fanout, steps = SAMPLED["seeds"], SAMPLED["fanout"], SAMPLED["steps"]
    t0 = time.perf_counter()
    g, labels = sampled_graph()
    t_gen = time.perf_counter() - t0
    n = g.num_nodes
    pool = np.random.default_rng(0).permutation(n)[: steps * S]
    print(f"[29 host-sampled] {card} | S2's graph: {n:,} nodes, {g.num_edges:,} edges, {g.num_features} "
          f"channels, labels {labels.mean():.3f} positive; generated in {t_gen:.2f} s (host)", flush=True)

    # 29. host-sampled training (S2): the fused loader feeds Trainer.train_epoch
    torch.cuda.reset_peak_memory_stats()
    kw = dict(seed_nodes=pool, batch_size=S, fanout=fanout, seed=0)
    loader = SampledNodeLoader(g, labels, device=dev, **kw)
    check(loader.fused and len(loader) == steps, (loader.fused, len(loader)))
    on_card, on_cpu = next(iter(loader)), next(iter(SampledNodeLoader(g, labels, device="cpu", **kw)))
    for name in SAMPLED_FIELDS:
        got = getattr(on_card, name)
        check(got.is_cuda and torch.equal(got.cpu(), getattr(on_cpu, name)), ("S2 batch", name))
    model = NodeGCN(g.num_features, SAMPLED["hidden"], num_layers=len(fanout),
                    generator=torch.Generator().manual_seed(0))
    randomize_batch_norms(model, np.random.default_rng(0))
    d_loss, d_grad = check_step_matches(step_on(copy.deepcopy(model).to(dev), on_card),
                                        step_on(copy.deepcopy(model), on_cpu), "S2 step")
    real = int(on_card.node_mask.sum())
    edges = int((on_card.edge_weight != 0).sum())
    print(f"[29 host-sampled] {card} | SampledNodeLoader (fused: native sample and collate, one int32 and one "
          f"float32 buffer to the card, features gathered there): budgets {loader.node_budget:,} nodes, "
          f"{loader.edge_budget:,} edges; batch 0 holds {real:,} nodes, {edges:,} edges, bitwise the CPU "
          f"loader's ({len(SAMPLED_FIELDS)} arrays); NodeGCN step on the card against the CPU: |loss| "
          f"{d_loss:.3e} (rtol 1e-5), max|gradient| {d_grad:.3e} (rtol {RTOL} / atol {ATOL})", flush=True)
    for depth in (2, 0):
        trainer = Trainer(copy.deepcopy(model), device=dev, prefetch_depth=depth)
        trainer.train_epoch(loader)  # warm
        ms, loss = epoch_ms(trainer, loader, steps)
        check(np.isfinite(loss) and trainer.last_skipped_steps == 0, ("S2 epoch", depth, loss))
        print(f"[29 host-sampled] {card} | Trainer.train_epoch, {steps} steps of {S} seeds, fanout {fanout}, "
              f"NodeGCN hidden {SAMPLED['hidden']}, prefetch {depth}: {ms:.3f} ms a step (host clock ending "
              f"in a synchronize, one epoch after one warm epoch), loss {loss:.4f}, skipped 0", flush=True)
    print(f"[29 host-sampled] {card} | max_memory_allocated {torch.cuda.max_memory_allocated():,} B; phase 29 "
          f"took {time.perf_counter() - t_start:.1f} s", flush=True)
    del loader, trainer, on_card

    # 30. device-sampled training (SD2)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    csr_cpu = DeviceGraphCSR.from_graph(g, device="cpu")
    t_cpu_csr = time.perf_counter() - t0
    models = {}
    for label, make, dedup in (("GCN", device_sampled_gcn, True), ("SAGE", device_sampled_sage, True),
                               ("SAGE multiset", device_sampled_sage, False)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = make(g, hidden_dim=SAMPLED["hidden"], fanout=fanout, device=dev,
                     **({} if make is device_sampled_gcn else {"dedup": dedup}))
        torch.cuda.synchronize()
        t_up = time.perf_counter() - t0
        cpu_model = DeviceSampledModel(csr_cpu, copy.deepcopy(model.inner).cpu(), fanout, dedup=dedup)
        row = make_seed_batch(pool[:S], labels, 12345, S, device="cpu")
        got = device_sample(model.csr, row.seeds.to(dev), row.key_words.to(dev), fanout, dedup=dedup)
        want = device_sample(csr_cpu, row.seeds, row.key_words, fanout, dedup=dedup)
        for name in ("node_ids", "node_mask", "node_features", "senders", "receivers", "edge_weight"):
            check(torch.equal(getattr(got, name).cpu(), getattr(want, name)), (label, "device_sample", name))
        for h, (a, b) in enumerate(zip(got.hop_blocks, want.hop_blocks)):
            check(all(torch.equal(getattr(a, k).cpu(), getattr(b, k)) for k in ("senders", "weights", "recv")),
                  (label, "hop block", h))
        sampled_nodes, sampled_edges = int(got.node_mask.sum()), int((got.edge_weight != 0).sum())
        with torch.no_grad():
            lg = model.eval()(row.to(dev)).cpu()
            lc = cpu_model.eval()(row)
        torch.testing.assert_close(lg, lc, rtol=RTOL, atol=ATOL, msg=f"{label} eval logits")
        d_step = check_step_matches(step_on(model, row.to(dev)), step_on(cpu_model, row), f"{label} step")
        loader = model.make_loader(pool, labels, batch_size=S, seed=1, drop_last=True)
        trainer = Trainer(model, device=dev)
        trainer.train_epoch(loader)  # warm
        ms, loss = epoch_ms(trainer, loader, steps)
        check(np.isfinite(loss) and trainer.last_skipped_steps == 0, (label, "epoch", loss))
        peak = torch.cuda.max_memory_allocated() - before
        rows = device_breakdown(lambda: trainer.train_epoch(loader), iters=1)
        busy = sum(r for _, r in rows) / steps
        print(f"[30 device-sampled] {card} | {label} (device_sampled_{'gcn' if label == 'GCN' else 'sage'}"
              f"{', dedup=False' if not dedup else ''}): DeviceGraphCSR {model.csr.nbytes:,} B on the card "
              f"(packed (sender, weight) pairs, indptr, float32 features), built and uploaded in {t_up:.2f} s "
              f"(the CPU's {t_cpu_csr:.2f} s); device_sample bitwise the CPU's ({sampled_nodes:,} nodes, "
              f"{sampled_edges:,} edges, both modes' arrays and hop blocks); eval logits within "
              f"{float((lg - lc).abs().max()):.3e} of the CPU's; a step: |loss| {d_step[0]:.3e}, max|gradient| "
              f"{d_step[1]:.3e}", flush=True)
        print(f"[30 device-sampled] {card} | {label}: {ms:.3f} ms a step stepwise (Trainer.train_epoch over a "
              f"DeviceSeedLoader, prefetch 2, {steps} steps, host clock ending in a synchronize), loss "
              f"{loss:.4f}; device busy {busy:.3f} ms a step ({busy / ms:.1%}; torch.profiler over one epoch, "
              f"{len(rows)} kernels); peak {peak:,} B above the {before:,} B held before", flush=True)
        for name, ms_k in rows[:8]:
            print(f"[30 device-sampled] {card} |     {ms_k / steps:9.4f} ms/step  {name[:150]}", flush=True)
        models[label] = model
        del trainer, loader, cpu_model
    del csr_cpu
    print(f"[30 device-sampled] {card} | phase 30 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 31. scan_epochs (SE2, SME2): one captured CUDA graph a step against the stepwise loop
    t_phase = time.perf_counter()
    scan_pool = np.random.default_rng(1).permutation(n)[: SAMPLED["scan_steps"] * S]
    for label, key, deterministic in (("SE2 GCN", "GCN", False),
                                      ("SE2 GCN, deterministic algorithms", "GCN", True),
                                      ("SME2 SAGE multiset", "SAGE multiset", False)):
        # the GCN adds by atomics (index_add_ and index_select's backward),
        # so it is compared once more under torch's deterministic
        # algorithms; SAGE multiset adds by slices and is deterministic
        with deterministic_algorithms(deterministic) as caught:
            sampled_scan(card, label, models[key], labels, scan_pool, exact=deterministic or key != "GCN")
        check(not caught, (label, "deterministic-algorithm warnings", caught))
    del models
    print(f"[31 scan_epochs] {card} | max_memory_allocated {torch.cuda.max_memory_allocated():,} B; phase 31 "
          f"took {time.perf_counter() - t_phase:.1f} s; phases 29-31 {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return g, labels


@contextlib.contextmanager
def deterministic_algorithms(on: bool):
    """``torch.use_deterministic_algorithms(on)`` inside, warnings for an op
    without a deterministic form recorded (yielded) rather than raised, off
    after."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(on, warn_only=True)
        try:
            yield caught
        finally:
            torch.use_deterministic_algorithms(False)
    caught[:] = [str(w.message)[:200] for w in caught if "deterministic" in str(w.message)]


def sampled_scan(card, label, base, labels, pool, exact: bool) -> None:
    """Phase 31 for one model: a scanned epoch against the stepwise one and
    a second stepwise one; ``exact`` asks for their states bitwise equal."""
    fanout, steps, S = SAMPLED["fanout"], SAMPLED["scan_steps"], SAMPLED["seeds"]
    trainers, loaders = {}, {}
    for way in ("stepwise", "stepwise again", "scanned"):
        m = DeviceSampledModel(base.csr, copy.deepcopy(base.inner), fanout, dedup=base.dedup)
        trainers[way] = Trainer(m, device=base.csr.device, seed=0, scan_epochs=way == "scanned")
        loaders[way] = m.make_loader(pool, labels, batch_size=S, seed=2, drop_last=True)
    first = {way: epoch_ms(t, loaders[way], steps) for way, t in trainers.items()}
    check(len(trainers["scanned"]._captured) == 1, "one captured step")
    diffs = [state_diff(trainers["scanned"], trainers["stepwise"]),
             state_diff(trainers["stepwise again"], trainers["stepwise"])]
    second = {way: epoch_ms(t, loaders[way], steps) for way, t in trainers.items()}
    for way in trainers:
        check(np.isfinite(second[way][1]) and trainers[way].last_skipped_steps == 0, (label, way))
    check(len(trainers["scanned"]._captured) == 1, "the step was captured once")
    diffs.append(state_diff(trainers["scanned"], trainers["stepwise"]))
    calls = {way: dispatches(lambda t=t, way=way: t.train_epoch(loaders[way]))
             for way, t in trainers.items() if way != "stepwise again"}
    loss_gap = abs(second["scanned"][1] - second["stepwise"][1])
    print(f"[31 scan_epochs] {card} | {label}, {steps} steps of {S} seeds: epoch 1 "
          f"{first['stepwise'][0]:.3f} ms a step stepwise, {first['scanned'][0]:.3f} scanned (the warm-up "
          f"step and the capture included); epoch 2 {second['stepwise'][0]:.3f} stepwise, "
          f"{second['stepwise again'][0]:.3f} stepwise again, {second['scanned'][0]:.3f} scanned (host "
          f"clock ending in a synchronize); host dispatches an epoch: {calls['stepwise']:,} stepwise, "
          f"{calls['scanned']:,} scanned (kernel and graph launches, copies, fills; torch.profiler)",
          flush=True)
    print(f"[31 scan_epochs] {card} | {label}: scanned against stepwise after epoch 1: {diff_text(diffs[0])}; "
          f"after epoch 2: {diff_text(diffs[2])}, epoch-2 loss {second['scanned'][1]:.6f} against "
          f"{second['stepwise'][1]:.6f} (|diff| {loss_gap:.3e}); stepwise against stepwise after epoch 1: "
          f"{diff_text(diffs[1])}", flush=True)
    for epoch, (scanned, stepwise) in enumerate(((first["scanned"], first["stepwise"]),
                                                 (second["scanned"], second["stepwise"])), 1):
        # the epoch's mean loss; the GCN conv biases, which BatchNorm
        # cancels, drift apart by noise gradients and change no loss
        check(abs(scanned[1] - stepwise[1]) <= 1e-4 * abs(stepwise[1]), (label, epoch, scanned, stepwise))
    if exact:
        check(all(d == 0.0 for diff in diffs for d in diff.values()), (label, "not bitwise", diffs))


def synced_ms(fn, iters: int = 3) -> float:
    """Median ms of ``fn`` by the host clock, each call ending in a
    synchronize."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rel_frobenius(got: dict, want: dict) -> float:
    """Relative Frobenius error of two gradient dicts, over all of them."""
    a, b = flat(got), flat(want)
    return float((a - b).norm() / b.norm())


def moved_text(mesh) -> str:
    """Each collective's bytes and calls since the counters were cleared."""
    return ", ".join(f"{k} {v:,} B in {mesh.calls[k]} calls" for k, v in sorted(mesh.bytes_moved.items()))


def clear_counts(mesh) -> None:
    mesh.bytes_moved.clear()
    mesh.calls.clear()


def dp_trap_atol(kind: str, name: str, k: int) -> float:
    """A GCN conv's bias (its gradient is noise: BatchNorm cancels it) and
    the running means it feeds, after k Adam steps; else the f32 gate."""
    lr = PARALLEL["lr"]
    if kind == "gcn" and name.startswith("convs.") and name.endswith(".bias"):
        return 2 * k * lr
    if kind == "gcn" and name.endswith("running_mean"):
        return 0.1 * lr * k * (k - 1)
    return ATOL


def dp_phase(dev, card) -> None:
    """Phase 32: data-parallel graph classification against one device."""
    t_start = time.perf_counter()
    D, S, k = PARALLEL["shards"], PARALLEL["shard_batch"], PARALLEL["steps"]
    graphs = generate_dataset(num_subjects=D * S * k, seed=42)
    sharded = ConnectomeDataLoader(graphs, batch_size=D * S, shuffle=False, num_shards=D,
                                   layout="dense", device=dev)
    whole = ConnectomeDataLoader(graphs, batch_size=D * S, shuffle=False, layout="dense", device=dev)
    mesh = parallel.create_mesh((D,), ("data",), device=dev)
    check(mesh.group is not None and mesh.world == 1 and mesh.local_shards == D, mesh)
    for kind, cls in TRAIN_CLASSES.items():
        base = cls(in_channels=5, hidden_dim=PARALLEL["hidden"], num_layers=PARALLEL["layers"],
                   dropout=0.0, generator=torch.Generator().manual_seed(0))
        one = Trainer(copy.deepcopy(base), device=dev, seed=0)
        dp = Trainer(copy.deepcopy(base), mesh=mesh, seed=0)
        clear_counts(mesh)
        torch.cuda.reset_peak_memory_stats()
        _, loss_dp = epoch_ms(dp, sharded, k)
        peak = torch.cuda.max_memory_allocated()
        moved = moved_text(mesh)
        calls = sum(mesh.calls.values()) / k
        _, loss_one = epoch_ms(one, whole, k)
        check(dp.last_skipped_steps == one.last_skipped_steps == 0, ("skipped", kind))
        check(abs(loss_dp - loss_one) <= 1e-5 * abs(loss_one), (kind, loss_dp, loss_one))
        worst = {}
        want = one.model.state_dict()
        for name, t in dp.model.state_dict().items():
            if t.is_floating_point():
                atol = dp_trap_atol(kind, name, k)
                torch.testing.assert_close(t, want[name], rtol=RTOL, atol=atol,
                                           msg=f"32 {kind} {name}")
                worst[name] = float((t - want[name]).abs().max())
        trap = max((v for n, v in worst.items() if dp_trap_atol(kind, n, k) > ATOL), default=0.0)
        rest = max(v for n, v in worst.items() if dp_trap_atol(kind, n, k) == ATOL)
        # evaluate and predict on the same weights
        one.model.load_state_dict(dp.model.state_dict())
        ev_dp, ev_one = dp.evaluate(sharded), one.evaluate(whole)
        check(ev_dp["total"] == ev_one["total"] == len(graphs) and ev_dp["correct"] == ev_one["correct"]
              and abs(ev_dp["loss"] - ev_one["loss"]) <= 1e-5 * abs(ev_one["loss"]), (ev_dp, ev_one))
        # mesh-mode predict serves each merged batch through K1 (GCN) or K2 (SAGE)
        fused_gcn_kernel.launches = fused_sage_kernel.launches = 0
        pred_dp = dp.predict(sharded)
        torch.cuda.synchronize()
        launches = {"gcn": fused_gcn_kernel.launches, "sage": fused_sage_kernel.launches}
        check(launches == {n: len(sharded) * (n == kind) for n in launches}, (kind, launches))
        pred_one = one.predict(whole)
        check(pred_dp.shape == (len(graphs), 2), pred_dp.shape)
        np.testing.assert_allclose(pred_dp, pred_one, rtol=RTOL, atol=ATOL)
        batch_s, batch_w = next(iter(sharded)), next(iter(whole))
        steps = [lambda: dp._train_step(batch_s), lambda: one._train_step(batch_w)]
        ms_dp, ms_one = host_ms(steps, iters=20)
        dev_dp, dev_one = (device_ms(fn, iters=10) for fn in steps)
        disp_dp, disp_one = (dispatches(fn) for fn in steps)
        scalar = torch.zeros(1, device=dev)
        ms_call = synced_ms(lambda: [mesh.reduce_(scalar, "probe") for _ in range(100)]) / 100
        print(f"[32 data parallel] {card} | {kind.upper()} hidden {PARALLEL['hidden']}, "
              f"L={PARALLEL['layers']}, {k} steps of {S} graphs a shard x {D} (dense) against the "
              f"unsharded Trainer at batch {D * S}: epoch loss {loss_dp:.6f} / {loss_one:.6f}; "
              f"max|diff| {rest:.3e} over parameters and buffers (rtol {RTOL} / atol {ATOL}), "
              f"{trap:.3e} for the GCN conv biases and running means (2*k*lr / momentum*lr*k*(k-1)); "
              f"evaluate loss {ev_dp['loss']:.6f} acc {ev_dp['accuracy']:.4f} total {ev_dp['total']} "
              f"= unsharded; predict {pred_dp.shape} max|diff| {np.abs(pred_dp - pred_one).max():.3e}, "
              f"{launches[kind]} {'K1' if kind == 'gcn' else 'K2'} launches in mesh-mode predict "
              f"({len(sharded)} merged batches); "
              f"ms a step sharded {ms_dp:.3f}, unsharded {ms_one:.3f} (host clock ending in a synchronize, "
              f"median of 20 in turns), device ms {dev_dp:.3f} / {dev_one:.3f}, host dispatches "
              f"{disp_dp} / {disp_one}; "
              f"{calls:.0f} collective calls a step, one all_reduce of 4 B alone {ms_call:.4f} ms (host "
              f"clock, 100 in a row); max_memory_allocated {peak:,} B; moved in the first epoch: {moved} "
              f"({PARALLEL_NOTE})",
              flush=True)
    print(f"[32 data parallel] {card} | phase 32 took {time.perf_counter() - t_start:.1f} s", flush=True)


def giant_node_labels(graph) -> np.ndarray:
    return (graph.node_features[:, 0] > 0).astype(np.int32)


def node_grads(model, forward, labels, mask=None):
    """Train-mode forward and backward of the masked mean cross-entropy;
    ``(loss, {name: gradient})``."""
    model.train()
    model.zero_grad(set_to_none=True)
    logits = forward()
    ce = F.cross_entropy(logits, labels, reduction="none")
    m = torch.ones_like(ce) if mask is None else mask.to(ce.dtype)
    loss = (ce * m).sum() / m.sum()
    loss.backward()
    return float(loss.detach()), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def lr0_step(make, model, mesh):
    """A sharded train step from ``make`` at lr 0: each call returns ``(loss,
    {name: reduced gradient})`` and leaves the weights as they were."""
    step = make(model, torch.optim.SGD(model.parameters(), lr=0.0), mesh)

    def run(sharded):
        loss, _ = step(sharded)
        return float(loss), {k: p.grad.detach().clone() for k, p in model.named_parameters()}

    return run


def twin(cls_sharded, cls_plain, dev):
    """A sharded model with random weights and BatchNorm state from seed 0,
    and the unsharded model holding the same, both on ``dev``."""
    sharded = make_node_model(cls_sharded, dev)
    plain = make_node_model(cls_plain, dev)
    plain.load_state_dict(sharded.state_dict())
    return sharded, plain


@torch.no_grad()
def held_logits(got, want, what) -> float:
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=what)
    return float((got - want).abs().max())


def edge_phase(dev, card, graph) -> None:
    """Phase 33: the edge-partitioned GCN on the giant COO graph."""
    t_start = time.perf_counter()
    D, n = PARALLEL["shards"], graph.num_nodes
    labels_np = giant_node_labels(graph)
    t0 = time.perf_counter()
    part = parallel.partition_graph(graph, D, node_labels=labels_np)
    t_part = time.perf_counter() - t0
    mesh = parallel.create_mesh((D,), ("edge",), device=dev)
    torch.cuda.reset_peak_memory_stats()
    sharded = mesh.place(part)
    model, plain = twin(parallel.EdgePartitionedGCN, NodeGCN, dev)
    s, r = (torch.from_numpy(graph.edge_index[i]).to(dev) for i in (0, 1))
    x = torch.from_numpy(graph.node_features).to(dev)
    batch = SimpleNamespace(node_features=x, senders=s, receivers=r,
                            edge_weight=torch.from_numpy(graph.edge_weight).to(dev),
                            node_mask=torch.ones(n, dtype=torch.bool, device=dev), num_seeds=n,
                            hop_blocks=None)
    labels = torch.from_numpy(labels_np).long().to(dev)
    with torch.no_grad():
        model.eval(), plain.eval()
        clear_counts(mesh)
        got = model(sharded, mesh).reshape(-1, 2)[:n]
        moved = moved_text(mesh)
        err = held_logits(got, plain(batch), "33 EdgePartitionedGCN logits")
        ms_fwd = synced_ms(lambda: model(sharded, mesh))
        ms_fwd_plain = synced_ms(lambda: plain(batch))
    step = lr0_step(parallel.make_partitioned_train_step, model, mesh)
    loss_s, g_s = step(sharded)
    loss_p, g_p = node_grads(plain, lambda: plain(batch), labels)
    rel = rel_frobenius(g_s, g_p)
    check(abs(loss_s - loss_p) <= 1e-5 * abs(loss_p) and rel <= 1e-4, ("33 step", loss_s, loss_p, rel))
    ms_step = synced_ms(lambda: step(sharded))
    ms_step_plain = synced_ms(lambda: node_grads(plain, lambda: plain(batch), labels))
    print(f"[33 edge partition] {card} | EdgePartitionedGCN, {n:,} nodes, {graph.num_edges:,} edges in "
          f"{D} shards: partition_graph {t_part:.2f} s (host), {part.nodes_per_shard:,} nodes and "
          f"{int(part.src_slot.shape[1]):,} edge slots a shard, send table [{D}, {D}, "
          f"{part.borrowed_rows}] (borrowed rows a pair; {int((part.send_idx < part.nodes_per_shard).sum()):,} "
          f"real); logits max|sharded - NodeGCN| {err:.3e} (rtol {RTOL} / atol {ATOL}); one step: loss "
          f"{loss_s:.6f} / {loss_p:.6f}, gradients relative Frobenius {rel:.3e} (gate 1e-4); ms a forward "
          f"sharded {ms_fwd:.3f}, unsharded {ms_fwd_plain:.3f}; ms a step (forward and backward) sharded "
          f"{ms_step:.3f}, unsharded {ms_step_plain:.3f}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated():,} B; a forward moved {moved} ({PARALLEL_NOTE}); phase 33 "
          f"took {time.perf_counter() - t_start:.1f} s", flush=True)


def band_phase(dev, card, graph) -> None:
    """Phase 34: the band- and hybrid-partitioned models on the giant graph."""
    t_start = time.perf_counter()
    D, n, block = PARALLEL["shards"], graph.num_nodes, GIANT["block"]
    labels_np = giant_node_labels(graph)
    labels = torch.from_numpy(labels_np).long().to(dev)
    mesh = parallel.create_mesh((D,), ("edge",), device=dev)
    torch.cuda.reset_peak_memory_stats()
    a = to_banded(graph.edge_index[0], graph.edge_index[1], graph.edge_weight, n, block=block,
                  device=dev)
    x = torch.from_numpy(graph.node_features).to(dev)
    sharded = mesh.place(parallel.partition_banded(a, graph.node_features, D, labels=labels_np))
    check(sharded.band.data_ptr() == a.band.data_ptr(), "the partition's band is a view of the band")
    lines = []
    for name, cls_s, cls_p in (("GCN", parallel.ShardedBandedGCN, BandedNodeGCN),
                               ("SAGE", parallel.ShardedBandedSAGE, BandedNodeSAGE)):
        model, plain = twin(cls_s, cls_p, dev)
        with torch.no_grad():
            model.eval(), plain.eval()
            clear_counts(mesh)
            got = model(sharded, mesh).reshape(-1, 2)[:n]
            moved = moved_text(mesh)
            err = held_logits(got, plain(a, x), f"34 ShardedBanded{name} logits")
            ms_fwd = synced_ms(lambda: model(sharded, mesh))
            ms_fwd_plain = synced_ms(lambda: plain(a, x))
        line = (f"ShardedBanded{name} forward: max|sharded - BandedNode{name}| {err:.3e} (rtol {RTOL} / "
                f"atol {ATOL}), ms sharded {ms_fwd:.3f}, unsharded {ms_fwd_plain:.3f}, moved {moved}")
        if name == "GCN":
            step = lr0_step(parallel.make_sharded_banded_train_step, model, mesh)
            loss_s, g_s = step(sharded)
            loss_p, g_p = node_grads(plain, lambda: plain(a, x), labels)
            rel = rel_frobenius(g_s, g_p)
            check(abs(loss_s - loss_p) <= 1e-5 * abs(loss_p) and rel <= 1e-4, ("34 step", loss_s, loss_p, rel))
            ms_step = synced_ms(lambda: step(sharded))
            ms_step_plain = synced_ms(lambda: node_grads(plain, lambda: plain(a, x), labels))
            line += (f"; step: loss {loss_s:.6f} / {loss_p:.6f}, gradients relative Frobenius {rel:.3e} "
                     f"(gate 1e-4), ms a step sharded {ms_step:.3f}, unsharded float32 BandedNodeGCN "
                     f"{ms_step_plain:.3f} (forward, normalizing the band each call, and backward)")
        lines.append(line)
        del model, plain
    peak_band = torch.cuda.max_memory_allocated()
    del sharded, a
    torch.cuda.empty_cache()
    # the hybrid form: the same widths with 10 % shortcuts
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g2 = generate_spatial_graph(n, degree=GIANT["degree"], band=GIANT["band"], shortcut_frac=0.1,
                                num_features=GIANT["in_channels"], seed=0)
    h = to_hybrid(g2.edge_index[0], g2.edge_index[1], g2.edge_weight, n, block=block, bandwidth=2,
                  device=dev)
    ph = mesh.place(parallel.partition_hybrid(h, g2.node_features, D, labels=giant_node_labels(g2)))
    t_hybrid = time.perf_counter() - t0
    x2 = torch.from_numpy(g2.node_features).to(dev)
    model, plain = twin(parallel.ShardedBandedGCN, BandedNodeGCN, dev)
    with torch.no_grad():
        model.eval(), plain.eval()
        clear_counts(mesh)
        got = model(ph, mesh).reshape(-1, 2)[:n]
        moved = moved_text(mesh)
        err = held_logits(got, plain(h, x2), "34 hybrid ShardedBandedGCN logits")
        ms_fwd = synced_ms(lambda: model(ph, mesh))
        ms_fwd_plain = synced_ms(lambda: plain(h, x2))
    remainder = int((ph.rem_weights > 0).sum())
    lines.append(f"hybrid (10 % shortcuts, {remainder:,} remainder edges, send table [{D}, {D}, "
                 f"{int(ph.send_idx.shape[-1])}], generated and partitioned in {t_hybrid:.1f} s): "
                 f"ShardedBandedGCN max|sharded - BandedNodeGCN| {err:.3e}, ms a forward sharded "
                 f"{ms_fwd:.3f}, unsharded {ms_fwd_plain:.3f}, moved {moved}; max_memory_allocated "
                 f"{torch.cuda.max_memory_allocated():,} B")
    for line in lines:
        print(f"[34 band partition] {card} | {n:,} nodes, W=2, b={block}, F={GIANT['in_channels']}, "
              f"H={GIANT['hidden']}, L={GIANT['layers']}, {D} shards: {line}", flush=True)
    print(f"[34 band partition] {card} | max_memory_allocated {peak_band:,} B (band); {PARALLEL_NOTE}; "
          f"phase 34 took {time.perf_counter() - t_start:.1f} s", flush=True)


def mesh2d_phase(dev, card) -> None:
    """Phase 35: the 2-D step against the cohort's block diagonal."""
    t_start = time.perf_counter()
    n, block = PARALLEL["subject_nodes"], GIANT["block"]
    subjects = []
    for i in range(PARALLEL["subjects"]):
        g = generate_spatial_graph(n, degree=GIANT["degree"], band=GIANT["band"],
                                   num_features=GIANT["in_channels"], seed=1 + i)
        a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight, n, block=block, device=dev)
        subjects.append((a, g.node_features, giant_node_labels(g)))
    mesh = parallel.create_mesh((PARALLEL["subjects"], 2), ("data", "edge"), device=dev)
    torch.cuda.reset_peak_memory_stats()
    stacked = mesh.place(parallel.stack_partitioned(
        [parallel.partition_banded(a, xs, 2, labels=lab) for a, xs, lab in subjects]))
    combined, valid = banded_block_diag([a for a, _, _ in subjects])
    x = torch.from_numpy(np.concatenate([xs for _, xs, _ in subjects])).to(dev)
    labels = torch.from_numpy(np.concatenate([lab for _, _, lab in subjects])).long().to(dev)
    model, oracle = twin(parallel.ShardedBandedGCN, BandedNodeGCN, dev)
    clear_counts(mesh)
    step = lr0_step(parallel.make_banded_train_step_2d, model, mesh)
    loss_s, g_s = step(stacked)
    moved = moved_text(mesh)
    loss_p, g_p = node_grads(oracle, lambda: oracle(combined, x, node_mask=valid), labels, valid)
    rel = rel_frobenius(g_s, g_p)
    check(abs(loss_s - loss_p) <= 1e-5 * abs(loss_p) and rel <= 1e-4, ("35 step", loss_s, loss_p, rel))
    ms_step = synced_ms(lambda: step(stacked))
    ms_plain = synced_ms(lambda: node_grads(oracle, lambda: oracle(combined, x, node_mask=valid), labels,
                                            valid))
    print(f"[35 2-D] {card} | make_banded_train_step_2d on a (data {PARALLEL['subjects']} x edge 2) mesh, "
          f"{PARALLEL['subjects']} subjects of {n:,} nodes (W=2, b={block}, F={GIANT['in_channels']}, "
          f"H={GIANT['hidden']}, L={GIANT['layers']}): loss {loss_s:.6f} "
          f"against banded_block_diag's {loss_p:.6f}, gradients relative Frobenius {rel:.3e} (gate 1e-4); "
          f"ms a step 2-D {ms_step:.3f}, one device on the block diagonal {ms_plain:.3f}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated():,} B; a step moved {moved} "
          f"({PARALLEL_NOTE}); phase 35 took {time.perf_counter() - t_start:.1f} s", flush=True)


@contextlib.contextmanager
def nccl_group(dev, card, tag: str):
    """One rank of an NCCL group of size 1, by a ``file://`` rendezvous in a
    temporary directory; shut down and removed after."""
    import torch.distributed as dist

    rendezvous = tempfile.mkdtemp(prefix="cgt_nccl_")
    parallel.initialize_distributed(f"file://{rendezvous}/rendezvous", 1, 0, device=dev)
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, dist.get_backend())
        print(f"[{tag}] {card} | torch.distributed {dist.get_backend()}, world size "
              f"{dist.get_world_size()}, nccl {'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
        yield
    finally:
        parallel.shutdown_distributed()
        shutil.rmtree(rendezvous, ignore_errors=True)


def parallel_phases(dev, card, graph=None) -> None:
    """Phases 32-35 in one rank of an NCCL group of size 1."""
    t_start = time.perf_counter()
    with nccl_group(dev, card, "32 data parallel"):
        dp_phase(dev, card)
        if graph is None:
            graph = generate_spatial_graph(GIANT["num_nodes"], degree=GIANT["degree"], band=GIANT["band"],
                                           num_features=GIANT["in_channels"], seed=0)
        edge_phase(dev, card, graph)
        torch.cuda.empty_cache()
        band_phase(dev, card, graph)
        torch.cuda.empty_cache()
        mesh2d_phase(dev, card)
    print(f"[35 2-D] {card} | phases 32-35 took {time.perf_counter() - t_start:.1f} s", flush=True)


SAMPLED_PARALLEL_NOTE = ("one rank of an NCCL group of size 1 holding 4 shards on one card: every byte "
                         "stays on the card, so this is what the exchange costs, not scaling")


def cpu_mesh(D: int):
    """A mesh of ``D`` shards on the CPU in this process alone (no group):
    the reference the card's mesh is held to."""
    return parallel.Mesh((D,), ("data",), "cpu")


def lr0_grads(step, model, *args):
    """A train step at lr 0: ``(loss, {name: reduced gradient on the CPU})``,
    the weights as they were."""
    out = step(*args)
    return float(out[0]), {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()}


def sgd0(model):
    return torch.optim.SGD(model.parameters(), lr=0.0)


def sharded_fields_equal(got, want, fields, what) -> None:
    for name in fields:
        a, b = getattr(got, name), getattr(want, name)
        check(a.is_cuda and torch.equal(a.cpu(), b), (what, name))


def sampled_dp_phase(dev, card, g, labels) -> dict:
    """Phase 36: host- and device-sampled data parallelism over 4 shards."""
    t_start = time.perf_counter()
    D, S, fanout = PARALLEL["shards"], SAMPLED["seeds"], SAMPLED["fanout"]
    mesh, ref_mesh = parallel.create_mesh((D,), ("data",), device=dev), cpu_mesh(D)
    pool = np.random.default_rng(3).permutation(g.num_nodes)[: SAMPLED["steps"] * S]
    torch.cuda.reset_peak_memory_stats()
    # host-sampled (S2 over 4 shards)
    kw = dict(seed_nodes=pool, batch_size=S, fanout=fanout, seed=0)
    loader = SampledNodeLoader(g, labels, device=dev, num_shards=D, **kw)
    on_card = next(iter(loader))
    on_cpu = next(iter(SampledNodeLoader(g, labels, device="cpu", num_shards=D, **kw)))
    sharded_fields_equal(on_card, on_cpu, SAMPLED_FIELDS, "36 stacked S2 batch")
    check(on_card.node_features.shape[0] == D and on_card.num_seeds == S // D, on_card.num_seeds)
    base = NodeGCN(g.num_features, SAMPLED["hidden"], num_layers=len(fanout),
                   generator=torch.Generator().manual_seed(0))
    randomize_batch_norms(base, np.random.default_rng(0))
    card_model, cpu_model = copy.deepcopy(base).to(dev), copy.deepcopy(base)
    d_step = check_step_matches(
        lr0_grads(parallel.make_dp_train_step(card_model, sgd0(card_model), mesh), card_model,
                  mesh.place(on_card)),
        lr0_grads(parallel.make_dp_train_step(cpu_model, sgd0(cpu_model), ref_mesh), cpu_model,
                  on_cpu), "36 host-sampled DP step")
    dp = Trainer(copy.deepcopy(base), mesh=mesh, seed=0)
    one = Trainer(copy.deepcopy(base), device=dev, seed=0)
    whole = next(iter(SampledNodeLoader(g, labels, device=dev, **kw)))
    ms_dp, ms_one = host_ms([lambda: dp._train_step(on_card), lambda: one._train_step(whole)], iters=10)
    print(f"[36 sampled DP] {card} | host-sampled: SampledNodeLoader(num_shards={D}) on the card, {S} "
          f"seeds a step ({S // D} a shard), fanout {fanout}: the first stacked batch bitwise the CPU "
          f"loader's ({len(SAMPLED_FIELDS)} arrays); NodeGCN data-parallel step on the card against the "
          f"CPU's: |loss| {d_step[0]:.3e}, max|gradient| {d_step[1]:.3e} (rtol {RTOL} / atol {ATOL}); ms "
          f"a step sharded {ms_dp:.3f}, unsharded S2 step {ms_one:.3f} (host clock ending in a "
          f"synchronize, median of 10 in turns)", flush=True)
    del loader, dp, one, card_model

    # device-sampled (SD2 over 4 shards): the CSR on the card, seed rows sharded
    t0 = time.perf_counter()
    csr_cpu = DeviceGraphCSR.from_graph(g, device="cpu")
    t_csr = time.perf_counter() - t0
    models = {}
    for label, make, dedup in (("GCN", device_sampled_gcn, True),
                               ("SAGE multiset", device_sampled_sage, False)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        model = make(g, hidden_dim=SAMPLED["hidden"], fanout=fanout, device=dev,
                     **({} if dedup else {"dedup": False}))
        cpu_model = DeviceSampledModel(csr_cpu, copy.deepcopy(model.inner).cpu(), fanout, dedup=dedup)
        rows = model.make_loader(pool, labels, batch_size=S, seed=1, num_shards=D, drop_last=True)
        packed = next(iter(rows)).packed
        row = SeedBatch(packed=packed[0].cpu(), num_seeds=S // D)
        got = device_sample(model.csr, row.seeds.to(dev), row.key_words.to(dev), fanout, dedup=dedup)
        want = device_sample(csr_cpu, row.seeds, row.key_words, fanout, dedup=dedup)
        for name in ("node_ids", "node_mask", "node_features", "senders", "receivers", "edge_weight"):
            check(torch.equal(getattr(got, name).cpu(), getattr(want, name)), (label, "36 shard row", name))
        card_step = parallel.make_device_sampled_dp_step(model, sgd0(model), mesh)
        cpu_step = parallel.make_device_sampled_dp_step(cpu_model, sgd0(cpu_model), ref_mesh)
        d_step = check_step_matches(lr0_grads(card_step, model, packed, model.csr),
                                    lr0_grads(cpu_step, cpu_model, packed.cpu(), csr_cpu),
                                    f"36 {label} device-sampled DP step")
        dp = Trainer(model, mesh=mesh, seed=0)
        one = Trainer(DeviceSampledModel(model.csr, copy.deepcopy(model.inner), fanout, dedup=dedup),
                      device=dev, seed=0)
        seeds_one = make_seed_batch(pool[:S], labels, 12345, S, csr=model.csr)
        stacked = next(iter(rows))
        ms_dp, ms_one = host_ms([lambda: dp._train_step(stacked), lambda: one._train_step(seeds_one)],
                                iters=10)
        kernels = device_breakdown(lambda: dp._train_step(stacked), iters=5)
        busy = sum(ms for _, ms in kernels)
        peak = torch.cuda.max_memory_allocated() - before
        print(f"[36 sampled DP] {card} | device-sampled {label}: device_sample of shard 0's row bitwise "
              f"the CPU's ({int(got.node_mask.sum()):,} nodes); a data-parallel step against the CPU's: "
              f"|loss| {d_step[0]:.3e}, max|gradient| {d_step[1]:.3e}; ms a step stepwise sharded "
              f"{ms_dp:.3f}, unsharded (phase 30's step) {ms_one:.3f} (host clock, median of 10 in turns); "
              f"device busy {busy:.3f} ms a step ({busy / ms_dp:.1%}; torch.profiler, {len(kernels)} "
              f"kernels); peak {peak:,} B above the {before:,} B held before (the CSR built on the host "
              f"in {t_csr:.2f} s for the CPU copy)", flush=True)
        for name, ms_k in kernels[:6]:
            print(f"[36 sampled DP] {card} |     {ms_k:9.4f} ms/step  {name[:150]}", flush=True)
        models[label] = model
        del dp, one, cpu_model
    print(f"[36 sampled DP] {card} | {SAMPLED_PARALLEL_NOTE}; phase 36 took "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return models


def sampled_mesh_scan_phase(dev, card, models, labels, n) -> None:
    """Phase 37: the scanned mesh epoch (SE2, SME2 over 4 shards) against
    stepwise."""
    t_start = time.perf_counter()
    D, S, steps, fanout = PARALLEL["shards"], SAMPLED["seeds"], SAMPLED["scan_steps"], SAMPLED["fanout"]
    mesh = parallel.create_mesh((D,), ("data",), device=dev)
    pool = np.random.default_rng(1).permutation(n)[: steps * S]
    for label, key in (("SE2 GCN", "GCN"), ("SME2 SAGE multiset", "SAGE multiset")):
        base = models[key]
        trainers, loaders = {}, {}
        for way in ("stepwise", "scanned"):
            m = DeviceSampledModel(base.csr, copy.deepcopy(base.inner), fanout, dedup=base.dedup)
            trainers[way] = Trainer(m, mesh=mesh, seed=0, scan_epochs=way == "scanned")
            loaders[way] = m.make_loader(pool, labels, batch_size=S, seed=2, num_shards=D,
                                         drop_last=True)
        first = {way: epoch_ms(t, loaders[way], steps) for way, t in trainers.items()}
        diff = state_diff(trainers["scanned"], trainers["stepwise"])
        clear_counts(mesh)
        second = {way: epoch_ms(t, loaders[way], steps) for way, t in trainers.items()}
        check(len(trainers["scanned"]._captured) == 1, "37 one captured step")
        epoch_moved = dict(mesh.bytes_moved)  # both epochs, the scanned one by its replays
        for epoch in (first, second):
            check(abs(epoch["scanned"][1] - epoch["stepwise"][1]) <= 1e-4 * abs(epoch["stepwise"][1]),
                  (label, epoch))
        check(trainers["scanned"].last_skipped_steps == 0, label)
        clear_counts(mesh)
        batch = next(iter(loaders["stepwise"]))
        trainers["stepwise"]._train_step(batch)
        step_moved = dict(mesh.bytes_moved)
        check(epoch_moved == {k: 2 * steps * v for k, v in step_moved.items()},
              ("37 counted bytes: an epoch each way is 64 steps", epoch_moved, step_moved))
        # the stepwise epoch's dispatches from 4 steps profiled (a step's
        # are the same every step); the scanned epoch's from a whole epoch
        four = [b for _, b in zip(range(4), loaders["stepwise"])]
        calls = {"stepwise": dispatches(lambda: [trainers["stepwise"]._train_step(b) for b in four])
                 * steps // 4,
                 "scanned": dispatches(lambda: trainers["scanned"].train_epoch(loaders["scanned"]))}
        print(f"[37 scanned mesh epoch] {card} | {label} over {D} shards, {steps} steps of {S} seeds: "
              f"scanned against stepwise after epoch 1: {diff_text(diff)}; epoch-2 loss "
              f"{second['scanned'][1]:.6f} / {second['stepwise'][1]:.6f} (within 1e-4); ms a step "
              f"stepwise {second['stepwise'][0]:.3f}, scanned {second['scanned'][0]:.3f} (epoch 2, host "
              f"clock ending in a synchronize; epoch 1 {first['stepwise'][0]:.3f} / "
              f"{first['scanned'][0]:.3f} with the warm-up and the capture); host dispatches an epoch "
              f"{calls['stepwise']:,} stepwise (4 steps profiled, x {steps // 4}), {calls['scanned']:,} "
              f"scanned (a whole epoch; torch.profiler); bytes a "
              f"step by collective {step_moved}, over the two epochs' {2 * steps} steps a way "
              f"{ {k: v // 2 for k, v in epoch_moved.items()} } (the scanned epoch's replays counted "
              f"by the captured step's counts)", flush=True)
        del trainers, loaders
    print(f"[37 scanned mesh epoch] {card} | {SAMPLED_PARALLEL_NOTE}; phase 37 took "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)


def graph_sharded_phase(dev, card, g, labels, models) -> None:
    """Phase 38: graph-sharded sampling (graph_sharded_sage, 4 shards)."""
    t_start = time.perf_counter()
    D, S, fanout, hidden = PARALLEL["shards"], SAMPLED["seeds"] // PARALLEL["shards"], \
        SAMPLED["fanout"], SAMPLED["hidden"]
    mesh, ref_mesh = parallel.create_mesh((D,), ("data",), device=dev), cpu_mesh(D)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = parallel.graph_sharded_sage(g, D, hidden_dim=hidden, fanout=fanout, device=dev)
    torch.cuda.synchronize()
    t_part = time.perf_counter() - t0
    csr_cpu = model.csr.to("cpu")
    gs = parallel.shard_csr(model.csr, mesh)
    shard_bytes = [sum(t[i].numel() * t[i].element_size()
                       for t in (gs.indptr, gs.sender_weight, gs.node_features)) for i in range(D)]
    rng = np.random.default_rng(5)
    probes = rng.integers(0, g.num_nodes, size=(4, D, S))
    t0 = time.perf_counter()
    planned, loads = parallel.plan_compaction(gs, mesh, probes, 11, fanout, return_loads=True)
    t_plan = time.perf_counter() - t0
    seeds = torch.from_numpy(rng.permutation(g.num_nodes)[: D * S].reshape(D, S))
    keys = torch.from_numpy(parallel.sharded_sampling.probe_key_words(12, 1, D)[0])
    lab = torch.from_numpy(labels[seeds.numpy()]).long()
    mask = torch.ones(D, S, dtype=torch.bool)
    fields = ("node_ids", "node_mask", "node_features", "senders", "receivers", "edge_weight")
    samples = {}
    for name, comp in (("broadcast", None), ("compacted", planned)):
        got, ovf = parallel.sharded_device_sample_with_stats(gs, seeds, keys, fanout, mesh,
                                                             compaction=comp)
        want, ovf_cpu = parallel.sharded_device_sample_with_stats(csr_cpu, seeds, keys, fanout, ref_mesh,
                                                                  compaction=comp)
        check(ovf.tolist() == ovf_cpu.tolist() == [0] * D, (name, ovf, ovf_cpu))
        for a, b in zip(got, want):
            sharded_fields_equal(a, b, fields, f"38 {name} sample")
            for h, (x, y) in enumerate(zip(a.hop_blocks, b.hop_blocks)):
                check(torch.equal(x.senders.cpu(), y.senders) and torch.equal(x.weights.cpu(), y.weights),
                      (name, "hop block", h))
        samples[name] = got
    for a, b in zip(samples["broadcast"], samples["compacted"]):
        for name in fields:
            check(torch.equal(getattr(a, name), getattr(b, name)), ("38 compacted is broadcast", name))
    inner_cpu = copy.deepcopy(model.inner).cpu()
    randomize_batch_norms(model.inner, np.random.default_rng(1))
    inner_cpu.load_state_dict(model.inner.state_dict())
    fwd = parallel.make_graph_sharded_sampled_forward(model.inner, mesh, fanout, compaction=planned)
    fwd_cpu = parallel.make_graph_sharded_sampled_forward(inner_cpu, ref_mesh, fanout, compaction=planned)
    err = held_logits(fwd(gs, seeds, keys).cpu(), fwd_cpu(csr_cpu, seeds, keys), "38 eval logits")
    steps = {}
    for name, comp in (("compacted", planned), ("broadcast", None)):
        steps[name] = parallel.make_graph_sharded_train_step(model.inner, sgd0(model.inner), mesh, fanout,
                                                             compaction=comp)
    step_cpu = parallel.make_graph_sharded_train_step(inner_cpu, sgd0(inner_cpu), ref_mesh, fanout,
                                                      compaction=planned)
    loss_g, g_g = lr0_grads(steps["compacted"], model.inner, gs, seeds, keys, lab, mask)
    loss_c, g_c = lr0_grads(step_cpu, inner_cpu, csr_cpu, seeds, keys, lab, mask)
    rel = rel_frobenius(g_g, g_c)
    check(abs(loss_g - loss_c) <= 1e-5 * abs(loss_c) and rel <= 1e-4, ("38 step", loss_g, loss_c, rel))
    counted = {name: parallel.count_collective_bytes(mesh, step, gs, seeds, keys, lab, mask)
               for name, step in steps.items()}
    md = max(gs.max_in_degree, max(fanout))
    modelled = {name: parallel.sharded_sampling_comm_model(D=D, S=S, fanout=fanout, F=g.num_features,
                                                           max_deg=md, compaction=comp)
                for name, comp in (("compacted", planned), ("broadcast", None))}
    for name in counted:
        exchange = counted[name].get("all_gather", 0) + counted[name].get("all_to_all", 0)
        check(exchange == modelled[name]["per_device_bytes_per_step"], (name, counted[name], modelled[name]))
    # the replicated device-sampled DP step of phase 36 at the same seeds a shard
    replicated = models["SAGE multiset"]
    dp = Trainer(replicated, mesh=mesh, seed=0)
    rows = replicated.make_loader(np.arange(g.num_nodes), labels, batch_size=D * S, seed=4,
                                  num_shards=D)
    stacked = next(iter(rows))
    ms = host_ms([lambda: steps["compacted"](gs, seeds, keys, lab, mask),
                  lambda: steps["broadcast"](gs, seeds, keys, lab, mask),
                  lambda: dp._train_step(stacked)], iters=10)
    peak = torch.cuda.max_memory_allocated() - before
    print(f"[38 graph-sharded] {card} | graph_sharded_sage's partition of {g.num_nodes:,} nodes into {D} "
          f"shards of {gs.nodes_per_shard:,}: {t_part:.2f} s (the host's partition and the upload); CSR "
          f"bytes a shard "
          f"{shard_bytes} (indptr, packed (sender, weight) pairs, features; max in-degree "
          f"{gs.max_in_degree}); plan_compaction on 4 probe batches {t_plan:.2f} s: {planned}, loads "
          f"{loads}; one step's sharded_device_sample on the card bitwise the CPU's, both exchanges, "
          f"overflow 0; compacted bitwise the broadcast exchange", flush=True)
    print(f"[38 graph-sharded] {card} | eval logits max|card - CPU| {err:.3e} (rtol {RTOL} / atol {ATOL}); "
          f"one step: loss {loss_g:.6f} / {loss_c:.6f}, gradients relative Frobenius {rel:.3e} (gate "
          f"1e-4); ms a step (hidden {hidden}, fanout {fanout}, {S} seeds a shard) compacted {ms[0]:.3f}, "
          f"broadcast {ms[1]:.3f}, the replicated device-sampled DP step (SAGE multiset) {ms[2]:.3f} "
          f"(host clock, median of 10 in turns); bytes received a device a step, counted "
          f"(count_collective_bytes) compacted {counted['compacted']}, broadcast {counted['broadcast']}; "
          f"modelled (sharded_sampling_comm_model) exchange compacted "
          f"{modelled['compacted']['per_device_bytes_per_step']:,}, broadcast "
          f"{modelled['broadcast']['per_device_bytes_per_step']:,} = counted all_gather + all_to_all; "
          f"peak {peak:,} B above the {before:,} B held before; {SAMPLED_PARALLEL_NOTE}; phase 38 took "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)


def sampled_parallel_surface(card) -> None:
    """``entry.dryrun_multichip`` on the card and the launcher's four sampled
    programs on NCCL, with no device argument."""
    from connectome_gnn_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    port_entry.dryrun_multichip(4)
    t_dry = time.perf_counter() - t0
    programs = ("sampled_dp", "device_sampled_dp", "device_sampled_dp_scanned", "graph_sharded")
    t0 = time.perf_counter()
    runs = launch.launch(1, PARALLEL["shards"], programs, timeout_s=300.0)
    out = runs[0]["results"]
    for name in programs:
        r = out[name]
        check(all(np.isfinite(r["losses"])) and r["grads_sum"] > 0 and r["n"] > 0, (name, r))
    check(out["graph_sharded"]["overflow"] == [0, 0], out["graph_sharded"])
    print(f"[38 surface] {card} | entry.dryrun_multichip(4) on the card: {t_dry:.1f} s; "
          f"parallel.launch (no device: NCCL, one worker on the card, 4 shards) of {', '.join(programs)}: "
          f"{ {k: [round(x, 6) for x in v['losses']] for k, v in out.items()} } losses, first-step gradient "
          f"sums { {k: round(v['grads_sum'], 6) for k, v in out.items()} }, graph_sharded's counted bytes "
          f"{out['graph_sharded']['comm_bytes_per_device_per_step']}; {time.perf_counter() - t0:.1f} s",
          flush=True)


def sampled_parallel_phases(dev, card, g=None, labels=None) -> None:
    """Phases 36-38 in one rank of an NCCL group of size 1 holding 4 shards,
    then the dry runs and the launcher's programs."""
    t_start = time.perf_counter()
    if g is None:
        g, labels = sampled_graph()
    with nccl_group(dev, card, "36 sampled DP"):
        models = sampled_dp_phase(dev, card, g, labels)
        sampled_mesh_scan_phase(dev, card, models, labels, g.num_nodes)
        torch.cuda.empty_cache()
        graph_sharded_phase(dev, card, g, labels, models)
        del models
        torch.cuda.empty_cache()
        sampled_parallel_surface(card)
    print(f"[38 graph-sharded] {card} | phases 36-38 took {time.perf_counter() - t_start:.1f} s", flush=True)


def giant_demo_module():
    """``examples/giant_graph_demo_torch.py``, whose ``main`` phase 39 runs."""
    spec = importlib.util.spec_from_file_location(
        "giant_graph_demo_torch", os.path.join(REPO, "examples", "giant_graph_demo_torch.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo


def demo_host_numbers(demo) -> dict:
    """The giant demo's host-side numbers from the same functions on the CPU
    (its seeds and its ``default_rng(0)`` draws in its order)."""
    n, deg, band = GIANT_DEMO["nodes"], GIANT_DEMO["degree"], GIANT_DEMO["band"]
    rng = np.random.default_rng(0)
    g = generate_spatial_graph(n, degree=deg, band=band, seed=0)
    scrambled = apply_ordering(g, rng.permutation(n))
    recovered = apply_ordering(scrambled, reverse_cuthill_mckee(scrambled.edge_index, n))
    a = to_banded(recovered.edge_index[0], recovered.edge_index[1], recovered.edge_weight, n,
                  block=demo.BLOCK)
    sw = generate_spatial_graph(n, degree=deg, band=band, seed=3, shortcut_frac=0.1)
    h = to_hybrid(sw.edge_index[0], sw.edge_index[1], sw.edge_weight, n, block=demo.BLOCK,
                  bandwidth=-(-band // demo.BLOCK))
    sub, _ = NeighborSampler(sw).sample(rng.integers(0, n, 512), fanout=[10, 10], seed=0)
    return dict(edges=g.num_edges, scrambled_bandwidth=bandwidth(scrambled.edge_index),
                rcm_bandwidth=bandwidth(recovered.edge_index), row_blocks=a.num_blocks,
                diagonals=2 * a.bandwidth + 1, shortcuts=int((h.remainder_weights > 0).sum()),
                sampled_nodes=sub.num_nodes, sampled_edges=sub.num_edges)


def traced_predict(dev) -> dict:
    """One ``Trainer.predict`` batch at b16 (GCN, flagship width) under
    ``utils.trace``: K1's launches in it, the trace files written, and the
    kernel events and K1 names in the trace."""
    graphs = generate_dataset(num_subjects=16, seed=42)
    loader = ConnectomeDataLoader(graphs, batch_size=16, shuffle=False, layout="dense", device=dev)
    trainer = Trainer(make_model("gcn", 5, 64, 3), device=dev)
    trainer.predict(loader)
    torch.cuda.synchronize()
    log_dir = tempfile.mkdtemp(prefix="cgt_trace_")
    try:
        fused_gcn_kernel.launches = 0
        with trace(log_dir):
            logits = trainer.predict(loader)
            torch.cuda.synchronize()
        files = [os.path.join(root, f) for root, _, names in os.walk(log_dir) for f in names]
        with open(files[0]) as fh:
            text = fh.read()
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    events = json.loads(text)["traceEvents"]
    return {"launches": fused_gcn_kernel.launches, "files": len(files), "bytes": len(text),
            "finite": logits.shape == (16, 2) and bool(np.isfinite(logits).all()),
            "kernel_events": sum(e.get("cat") == "kernel" for e in events),
            "k1_names": sorted({e["name"] for e in events if "fused_gcn_kernel" in str(e.get("name"))})}


#: a step's result as a dataclass: ``StepTimer.toc`` must wait on its
#: tensor field (phase 39).  Made by ``make_dataclass``, whose field types
#: are objects: a class statement's string annotations would need this file
#: registered in ``sys.modules``, which the tests that load it do not do
TimedResult = dataclasses.make_dataclass(
    "TimedResult", [("out", torch.Tensor), ("step", int, dataclasses.field(default=0))])


class Moments(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor


def checkpoint_round_trip(dev) -> dict:
    """Save a card-resident ``ConnectomeBatch`` with a NamedTuple and a
    ``None`` beside it, restore it onto the card into a zeroed template,
    and check the file (no pickle, one key a tensor leaf), the types and
    every leaf bitwise."""
    batch = collate_graphs(generate_dataset(num_subjects=16, seed=42), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tree = {"batch": batch, "moments": Moments(torch.randn(64, 64, device=dev, generator=gen),
                                              torch.rand(64, device=dev, generator=gen)),
            "opt": None}
    template = map_leaves(tree, torch.zeros_like)
    log_dir = tempfile.mkdtemp(prefix="cgt_ckpt_")
    try:
        path = os.path.join(log_dir, "tree.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, tree)
        t_save = time.perf_counter() - t0
        with np.load(path, allow_pickle=False) as data:
            keys = sorted(data.keys())
            file_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        back = restore_checkpoint(path, template)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    saved, restored = leaves_with_path(tree), leaves_with_path(back)
    check(keys == sorted(k for k, _ in saved) and len(keys) == 13, ("39 checkpoint keys", keys))
    check(type(back["batch"]) is type(batch) and back["batch"].num_graphs == batch.num_graphs
          and type(back["moments"]) is Moments and back["opt"] is None,
          ("39 checkpoint types", type(back["batch"]), type(back["moments"]), back["opt"]))
    for (key, want), (_, got) in zip(saved, restored):
        check(got.device == want.device and got.dtype == want.dtype and torch.equal(got, want),
              ("39 checkpoint leaf bitwise on the card", key, got.device, got.dtype))
    return {"keys": len(keys), "bytes": file_bytes, "save_ms": t_save * 1e3,
            "restore_ms": t_restore * 1e3, "num_graphs": batch.num_graphs}


def giant_demo_phase(dev, card) -> None:
    """Phase 39: the giant-graph demo on the card, then the profiling
    utilities: a trace of one ``Trainer.predict`` batch and ``StepTimer``."""
    t_start = time.perf_counter()
    demo = giant_demo_module()
    reset_counters()
    fused_gcn_kernel.launches = fused_sage_kernel.launches = 0
    out = demo.main(["--shards", str(GIANT_DEMO["shards"])])
    launched = {**counts(), "K1": fused_gcn_kernel.launches, "K2": fused_sage_kernel.launches}
    t_demo = time.perf_counter() - t_start
    check(out["device"] == str(dev) and out["devices"] == [str(dev)],
          ("39 every parameter and the band on the card", out["device"], out["devices"]))
    check(out["shards"] == GIANT_DEMO["shards"], ("39 shards", out["shards"]))
    for key in ("losses", "sampled_losses", "device_sampled_losses", "graph_sharded_losses"):
        check(len(out[key]) > 0 and bool(np.isfinite(out[key]).all()), ("39 finite losses", key, out[key]))
    for key in ("sharded_max_diff", "hybrid_sharded_max_diff"):
        check(out[key] <= GIANT_DEMO["gate"], ("39 sharded against single", key, out[key]))
    t0 = time.perf_counter()
    host = demo_host_numbers(demo)
    t_host = time.perf_counter() - t0
    check({k: out[k] for k in host} == host, ("39 host-side numbers", {k: out[k] for k in host}, host))
    sections = ", ".join(f"{k}: {out['seconds'][k]:.2f} s / {out['peak_bytes'][k] / 1e9:.3f} GB"
                         for k in out["seconds"])
    print(f"[39 giant demo] {card} | examples/giant_graph_demo_torch.py at {out['nodes']:,} nodes, "
          f"{out['shards']} shards on {out['device']}: {t_demo:.1f} s; band and every parameter on "
          f"{out['devices']}; sharded - single max|Δlogit| band {out['sharded_max_diff']:.3e}, hybrid "
          f"{out['hybrid_sharded_max_diff']:.3e} (gate {GIANT_DEMO['gate']}); every loss finite; "
          f"host-side numbers equal the CPU's ({t_host:.1f} s): {host}", flush=True)
    print(f"[39 giant demo] {card} | band training {len(out['losses'])} steps in "
          f"{out['train_seconds']:.2f} s, last loss {out['losses'][-1]:.4f}; sampled "
          f"{out['sampled_steps_per_s']:.1f} steps/s, device-sampled scanned "
          f"{out['device_sampled_steps_per_s']:.1f} steps/s; graph-sharded overflow {out['overflow']}; "
          f"plan_compaction alpha {out['plan_alpha']:.4f}, alpha_features {out['plan_alpha_features']:.4f}, "
          f"loads {out['draw_loads']} / {out['feature_load']}, payload MB a step a device "
          f"{out['payload_mb']}; in_degree_cap 8: {out['max_in_degree']} -> {out['capped_max_in_degree']}; "
          f"kernel launches on the demo's path {launched}", flush=True)
    print(f"[39 giant demo] {card} | seconds / max_memory_allocated a section: {{{sections}}}", flush=True)

    # the profiler: a trace of one predict batch at b16 names K1's kernel.
    # Checked in a fresh process: in this one, the epoch-long profiles of
    # phases 31 and 37 (~10^5 dispatches each) leave later torch.profiler
    # traces short of device events, so this process's trace is printed
    # beside it (its kernel events against the fresh one's) and not
    # checked for the name.
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    here = traced_predict(dev)
    code = ("import json, torch, chip_smoke; "
            "print('TRACED ' + json.dumps(chip_smoke.traced_predict(torch.device('cuda', 0))))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, ("39 traced predict in a fresh process", proc.stderr[-3000:]))
    fresh = json.loads(next(line for line in proc.stdout.splitlines() if line.startswith("TRACED "))[7:])
    for where, got in (("this process", here), ("a fresh process", fresh)):
        check(got["files"] == 1 and got["finite"] and got["launches"] == 1, ("39 traced predict", where, got))
    check(len(fresh["k1_names"]) > 0, ("39 the trace names K1's kernel", fresh))
    print(f"[39 profiling] {card} | trace() around one Trainer.predict batch at b16 in a fresh process: K1 "
          f"launched {fresh['launches']} time, one Chrome trace of {fresh['bytes']:,} B with "
          f"{fresh['kernel_events']} kernel events, naming {fresh['k1_names'][:1]} ({SOURCE}); in this process "
          f"after the earlier phases: K1 launched {here['launches']} time, {here['kernel_events']} kernel "
          f"events, K1 named {len(here['k1_names']) > 0}", flush=True)

    # StepTimer: toc(result) waits for the device work behind its result
    n = GIANT_DEMO["timer_n"]
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(n, n, device=dev, generator=gen)
    b = torch.randn(n, n, device=dev, generator=gen)
    work = lambda: a @ b  # noqa: E731
    work()
    torch.cuda.synchronize()
    timer, ev_ms, toc_ms, dc_ms, none_ms = StepTimer(), [], [], [], []
    for _ in range(GIANT_DEMO["timer_reps"]):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        work()
        end.record()
        torch.cuda.synchronize()
        ev_ms.append(start.elapsed_time(end))
        timer.tic()
        toc_ms.append(timer.toc(work()) * 1e3)
        timer.tic()
        dc_ms.append(timer.toc(TimedResult(work(), step=1)) * 1e3)
        timer.tic()
        result = work()
        none_ms.append(timer.toc() * 1e3)
        torch.cuda.synchronize()
        del result
    ev, toc_med, dc_med, none_med = (statistics.median(v) for v in (ev_ms, toc_ms, dc_ms, none_ms))
    check(all(t >= 0.9 * e for t, e in zip(toc_ms, ev_ms)), ("39 StepTimer.toc(result)", toc_ms, ev_ms))
    check(all(t >= 0.9 * e for t, e in zip(dc_ms, ev_ms)), ("39 StepTimer.toc(dataclass)", dc_ms, ev_ms))
    summary = timer.summary()
    print(f"[39 profiling] {card} | StepTimer around a {n}² float32 matmul: CUDA events {ev:.3f} ms, "
          f"toc(result) {toc_med:.3f} ms (each >= 0.9 × its event time: {[f'{t:.2f}' for t in toc_ms]} "
          f"against {[f'{e:.2f}' for e in ev_ms]}), toc(dataclass result) {dc_med:.3f} ms (each >= 0.9 × "
          f"its event time: {[f'{t:.2f}' for t in dc_ms]}), toc(None) {none_med:.3f} ms (no wait; medians "
          f"of {GIANT_DEMO['timer_reps']}); summary {summary}; {time.perf_counter() - t0:.1f} s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated():,} B", flush=True)
    del a, b
    torch.cuda.empty_cache()

    # checkpoints: a card-resident ConnectomeBatch, a NamedTuple and a None
    ck = checkpoint_round_trip(dev)
    print(f"[39 checkpoint] {card} | a ConnectomeBatch of {ck['num_graphs']} graphs on the card with a "
          f"NamedTuple and a None: {ck['keys']} keys, {ck['bytes']:,} B, loads with allow_pickle=False; "
          f"save {ck['save_ms']:.2f} ms, restore onto the card {ck['restore_ms']:.2f} ms (host clock); "
          f"the template's types, every leaf bitwise", flush=True)
    print(f"[39 giant demo] {card} | phase 39 took {time.perf_counter() - t_start:.1f} s", flush=True)


def demangled(name: str) -> str:
    """A kernel's C++ name, through ``c++filt`` where the machine has it."""
    try:
        return subprocess.run(["c++filt", name], capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return name


def main() -> None:
    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"[1 card] {card} | torch {torch.__version__} | cuda {torch.version.cuda}", flush=True)

    # 2. the build
    t0 = time.perf_counter()
    _build.library()
    print(f"[2 build] {card} | nvcc {' '.join(_build.NVCC_FLAGS)}: {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = _build.ptxas_report().splitlines()
    for i, line in enumerate(ptxas):
        if "Compiling entry function" in line:
            kernel = demangled(line.split("'")[1])
            usage = " ".join(s.strip().removeprefix("ptxas info    : ") for s in ptxas[i + 2 : i + 4])
            print(f"[2 build] ptxas -v, {', '.join(_build.PTXAS_VERBOSE)}: {kernel}: {usage}", flush=True)
        elif "warning" in line.lower() or "C7518" in line:
            print(f"[2 build] ptxas: {line.strip()[:400]}", flush=True)
    spills = [line.strip() for line in ptxas if any(int(n) for n in re.findall(r"(\d+) bytes spill", line))]
    serialized = [line for line in ptxas if "C7518" in line]
    print(f"[2 build] ptxas: {len(spills)} kernels spill, {len(serialized)} have their wgmma serialized (C7518)",
          flush=True)
    t0 = time.perf_counter()
    available = native.AVAILABLE
    print(f"[2 build] native host helpers (g++ -O3, connectome_gnn_tpu_torch/native/cgt_native.cpp): "
          f"AVAILABLE {available}, {time.perf_counter() - t0:.2f} s", flush=True)
    if "--serving-forwards" in sys.argv[1:]:
        serving_forwards(dev, card)
        return
    if "--train-steps" in sys.argv[1:]:
        train_steps(dev, card)
        return
    if "--fused-times" in sys.argv[1:]:
        fused_times(dev, card, timing_inputs_for(dev), *main_path_setup(dev))
        return
    if "--host-times" in sys.argv[1:]:
        _, loader, trainers = main_path_setup(dev)
        host_times(card, timing_inputs_for(dev), loader, trainers)
        return
    if "--sampled" in sys.argv[1:]:
        sampled_phases(dev, card)
        return
    if "--parallel" in sys.argv[1:]:
        parallel_phases(dev, card)
        return
    if "--sampled-parallel" in sys.argv[1:]:
        sampled_parallel_phases(dev, card)
        return
    if "--giant-demo" in sys.argv[1:]:
        giant_demo_phase(dev, card)
        return
    if "--gather" in sys.argv[1:]:
        gather_phases(dev, card)
        return
    # the timing modes above may time another tree's package; this tree's
    # kernels must neither spill nor have their wgmma serialized
    check(not spills and not serialized, ("a kernel spills or ptxas serialized its wgmma (C7518)", spills))

    # 3. each kernel against its plain version on the card
    max_err = {kind: 0.0 for kind in KERNELS}
    cases = [(shape, kind) for shape in SHAPES for kind in KERNELS]
    cases += [(shape, kind) for kind, shape in COMPACT_SHAPES.items()]
    for (B, n, F, H, L), kind in cases:
        inputs = random_dense_batch(B, n, F, seed=B + n, device=dev)
        k = KERNELS[kind]
        w = k["weights"](make_model(kind, F, H, L).to(dev))
        got = k["kernel"](*inputs, w)
        torch.cuda.synchronize()
        want = k["plain"](*inputs, w)
        torch.cuda.synchronize()
        check(got.shape == (B, 2) and bool(torch.isfinite(got).all()), (kind, B, n))
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        err = float((got - want).abs().max())
        max_err[kind] = max(max_err[kind], err)
        print(f"[3 kernel] {kind} B={B} n={n} F={F} H={H} L={L}, {cluster_note(B, n, dev)}: "
              f"max|kernel-plain| = {err:.3e}", flush=True)
    layout_check(_build.library())
    timing_inputs = timing_inputs_for(dev)

    # 4. the main path
    graphs, loader, trainers = main_path_setup(dev)
    cpu_loader = ConnectomeDataLoader(graphs, batch_size=16, shuffle=False, layout="dense")
    cpu_logits = {
        kind: Trainer(copy.deepcopy(tr.model), device="cpu").predict(cpu_loader, prefer_fused=False)
        for kind, tr in trainers.items()
    }
    fused_gcn_kernel.launches = 0
    fused_sage_kernel.launches = 0
    logits = {kind: tr.predict(loader) for kind, tr in trainers.items()}
    torch.cuda.synchronize()
    launches = {"gcn": fused_gcn_kernel.launches, "sage": fused_sage_kernel.launches}
    for kind, tr in trainers.items():
        out = logits[kind]
        check(out.shape == (64, 2) and np.isfinite(out).all(), (kind, out.shape))
        check(launches[kind] == len(loader) == 4, ("launches", kind, launches[kind]))
        plain = tr.predict(loader, prefer_fused=False)
        np.testing.assert_allclose(out, plain, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out, cpu_logits[kind], rtol=RTOL, atol=ATOL)
        ev = tr.evaluate(loader)
        check(ev["total"] == 64 and np.isfinite(ev["loss"]), ev)
        print(
            f"[4 main path] {kind}: predict {out.shape} finite, {launches[kind]} kernel launches, "
            f"max|fused-unfused| = {np.abs(out - plain).max():.3e}, "
            f"max|fused-cpu| = {np.abs(out - cpu_logits[kind]).max():.3e}; "
            f"evaluate loss={ev['loss']:.4f} acc={ev['accuracy']:.3f} total={ev['total']}",
            flush=True,
        )

    # 5. times (nothing asserted)
    times = fused_times(dev, card, timing_inputs, graphs, loader, trainers)

    # 6-10. the giant-graph serving path
    band_entries, graph = giant_graph_phases(dev, card)

    # 11-16. the giant-graph training path
    band_entries += giant_training_phases(dev, card, graph)

    # 17-19. the band variants K7 and B2a-B2c
    band_entries += band_variant_phases(dev, card, graph)

    # 20-22. the feature-major band-pipeline probes B3a-B3d
    band_entries += fm_pipeline_phases(dev, card, graph)

    # 23 and 25. graph-classification training on the card
    graph_training_phases(dev, card)

    # 24 and 25. the random-row gather B1
    band_entries += gather_phases(dev, card)

    # 26. mixed precision on the card
    bf16_phase(dev, card)

    # 27. bench_torch.py and entry()
    bench_and_entry_phase(dev, card)

    # 28. the giant-graph set-up: native helpers, the layout pipeline, the planner's rates
    layout_phase(dev, card, graph)

    # 29-31. sampled node training: host-sampled, device-sampled, scan_epochs
    sampled_graph_, sampled_labels = sampled_phases(dev, card)

    # 32-35. the parallel modes: data parallelism, edge, band and hybrid partitions, the 2-D step
    parallel_phases(dev, card, graph)
    del graph

    # 36-38. sampled data parallelism, the scanned mesh epoch, graph-sharded sampling
    sampled_parallel_phases(dev, card, sampled_graph_, sampled_labels)
    del sampled_graph_
    torch.cuda.empty_cache()

    # 39. slice F: the giant-graph demo on the card, trace() and StepTimer
    giant_demo_phase(dev, card)

    fused_entries = []
    for kind, k in KERNELS.items():
        b_ms, b_by = fused_bound(kind, *timing_inputs[kind, 16])
        fused_entries.append({
            "name": k["name"], "route": "cuda", "source": SOURCE, "replaces": k["replaces"],
            "launches": launches[kind], "max_abs_err": max_err[kind],
            "ms": times[kind, 16][0], "plain_ms": times[kind, 16][1], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
        })
    print(card)
    print(json.dumps({"kernels": fused_entries + band_entries}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
