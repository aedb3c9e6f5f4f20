#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --parent-csrc DIR   # also time a parent's kernels

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit, as nvidia-smi reports them;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all at once) and print the build time and ptxas report;
3. K1 elastic_matmul against its plain version at the serving shapes of the
   full Dynamic-OFA supernet, fp32 and bf16, including widths that are not
   multiples of the tile, with exact zeros past n_act; and across its
   variants (small_m, tma, f32_splitk, tile): M in 1..2048 around the
   small_m boundary, k_act not a multiple of 64 in sliced mode and in the
   TPU op's shape, a width that is not a multiple of 8 (no TMA), n_out >
   n_act; and f32_splitk at the fp32 MoE router's shape (K 2048, 64
   experts) for M from 17 to 2048 and n_act from 1 to 64, each call the
   same bits twice and under 3 CUDA-graph replays;
4. K2 flash_attention against its plain version: S = T = 197, D = 64,
   BH 6 and 48, non-causal and causal, one GQA case, the smoke configs'
   head dims (16 and 8), the ragged S = T = 577, and decode (S = 1) at
   T = 1, 63, 64, 65, 300 and 528 with GQA R = 2, D 64 and 128;
5. full-config (224 px, 12 layers, d 384) logits of the kernel path against
   the plain path on the card for the max, min and one mid subnet: fp32
   within a stated tolerance, bf16 max-abs error and top-1 agreement;
6. the main path at full width: ``build_server`` on ``make_config()``, the
   measured LUT over the serve launcher's subnets (each entry a replay of
   the subnet's CUDA graph at bucket 8), the governor summaries, a ladder
   warm (every (subnet, bucket) captured as a CUDA graph) and 64 requests
   through the JointGovernor, served as graph replays; every future
   answered, zero cold (subnet, bucket) pairs, both kernels' launch
   counters (replay-accounted: each replay adds the launches its capture
   recorded) rising while serving, none of the bf16 calls on the old K1
   tile or K2 FMA kernel (per-variant counters), served logits finite and
   equal to a direct forward of the same subnet;
7. each kernel's device time over the recorded calls of one full-width
   forward at bucket 8 -- each loop captured once in a CUDA graph and the
   graph replayed between events -- beside its plain version's, one
   PyTorch library call's (the yardstick; the port never calls it) and,
   with ``--parent-csrc``, the parent's kernel's, timed in turns; the
   eager loop's time (what the eager path pays, host launches included);
   and the bound from bytes and operations at the H100 data-sheet peaks;

the LM slice (deepseek-moe-16b at full width):

8. K3 expert_matmul against its plain version: E 64 and 32, d 2048,
   expert widths 1408/1056/704 read as strided views of the full weight,
   up and down products, ragged counts (0, a partial tile, the full C) at
   prefill's C = 240 and decode's C = 4, fp32 and bf16, exact zeros past
   each count; and across its variants (stream, tma, tile): C = 16 and
   17 around the stream boundary, E = 1, all counts 0 and all C, NaN in
   x past every count, and the dense oracle's stride-0 expert axis (tile
   at C > 16); a backward through the kernel route launches K3's dgrad
   and wgrad kernels once each and equals the plain route's;
9. K2 at head dim 128 against its plain version: causal prefill
   S = T = 512, and decode S = 1 against T = 1, 300 and 528 taken as
   strided slices of a 528-slot cache;
10. full-width LM logits (depth cut to 2: the dense layer and one MoE
    layer), kernel path against plain path, at the five operating points
    of ``repro_torch.launch.elastic_moe``: fp32 within a stated tolerance;
    bf16 once as it runs and once with the plain path's routing replayed
    in the kernel path, which must then agree within a stated tolerance
    (bf16 rounding alone), with the tokens routed differently counted;
11. the LM main path at full width and full depth (28 layers, bf16,
    initialised on the card): ``repro_torch.launch.elastic_moe.run``, the
    prefill of 4 x 512 seed tokens at each operating point as a CUDA
    graph (latency, tokens/s, the model-FLOPs bound), then 16
    teacher-forced decode steps, each a replay of one graph per point over
    a 528-slot cache whose fill lives on the device, at the points the
    reference can decode; every output finite, all three kernels'
    replay-accounted launch counters rising in prefill and in decode, no
    bf16 call
    on the old K1 tile, K2 FMA or K3 tile kernel, no fp32 router call on
    K1's tile (f32_splitk at prefill, small_m at decode), every K3 call on
    tma in prefill and on stream in decode (counted by stage in this
    run), one
    decode step's logits of the kernel path against the plain path (as it
    runs and with the plain path's routing replayed), peak device memory;
12. K1, K2 and K3 against their plain versions at the main path's own
    calls: every distinct call (shapes, strides, widths) of a prefill and
    one decode step at each operating point, on its recorded inputs in
    bf16 (fp32 for the routers) and again cast to fp32, exact zeros past
    each K3 count; every bf16 K3 call on tma in prefill and on stream in
    decode; each fp32 router call on the variant its M gives, the
    f32_splitk ones the same bits twice and under 3 CUDA-graph replays;
    and the capacity drops of each point (kept slots of the routed ones,
    rows per live expert);
13. phase 7 for the LM slice: K1, K2 and K3 over the recorded calls of
    one prefill forward and of one decode step, each beside its plain
    version, its library yardstick (``torch.matmul`` on the sliced
    weight; ``F.scaled_dot_product_attention``; ``torch.bmm`` over the
    same slabs), the parent's kernel (given) and its bound; the host's
    time to issue each row's launches (kernel and parent); K1's and K3's
    rows broken down by call shape and variant; and the prefill's fp32
    router calls as a row of their own (``torch.matmul`` in fp32, TF32
    off);
14. with ``--parent-csrc`` only: the full point's prefill and decode step
    as wall time, on this tree's kernels and on the parent's, in turns,
    both eager (a parent before the device-length K2 decode reads the
    cache's fill on the host, which no graph can capture), then this
    tree's as graph replays;

the training slice (sandwich-rule supernet training of the full-width
Dynamic-OFA ViT, batch 256, bf16):

15. the training main path: ``repro_torch.launch.train --arch
    dynamic-ofa-supernet --sandwich`` for 8 steps with a checkpoint every
    4 and a failure injected at step 6: finite losses, exactly one restart,
    the K1 forward, dgrad and wgrad and the K2 forward and backward
    counters all rising, every bf16 K1 dgrad and wgrad call on ``tma``
    and every K2 backward on ``resident``, no bf16 call on K1
    ``tile_bf16``, K2 ``fma_bf16`` or the backward's ``wmma_bf16`` (nor a
    backward on ``fma_f32``), the median step time after the first step
    and the peak device memory;
16. K1 forward, dgrad and wgrad against their plain versions at every
    distinct call (shapes, strides, widths) of one recorded sandwich step,
    full and masked widths, on the recorded bf16 inputs, cast to fp32 and
    with x or dy scaled to unit rms, exact zeros past k_act (dgrad) and
    outside the active block (wgrad), each comparison one launch of the
    variant it should take (``tma`` in bf16, ``fma_f32`` in fp32); each
    recorded wgrad call twice, bit for bit equal (the fused split-K
    reduce adds in split order), and once captured in a CUDA graph and
    replayed 3 times, each equal to the plain version (its tile counters
    reset);
17. K2's backward (dQ, dK, dV) and its forward's logsumexp against their
    plain versions: the recorded step's call (S = T = 197, D = 64) and
    random cases with T not a multiple of the 64-key tile and GQA (R = 2
    and 3), bf16 and fp32, each on the variant it
    should take (``resident`` at S, T <= 256 in bf16, ``wgmma`` past it,
    ``fma_f32``); the recorded call the same bits twice and under 3
    CUDA-graph replays;
18. one fp32 sandwich step of the full-width config at batch 4, kernel
    path against plain path: the loss within 1e-4 relative, every gradient
    leaf within 1e-3 of its largest value;
19. phase 7 for the training slice: K1's forward, dgrad and wgrad and K2's
    forward and backward over the recorded calls of one sandwich step as
    graph-replayed device time, each beside its bound, its plain version,
    a yardstick the port never calls (``torch.matmul`` on the active
    block; SDPA, and autograd's backward of SDPA) and, with
    ``--parent-csrc``, the parent's kernel, dgrad's and wgrad's broken
    down by call shape; one whole step's device time by kernel from a
    ``torch.profiler`` trace, beside its wall time (the device's busy
    share); and with ``--parent-csrc`` the whole sandwich step as wall
    time on this tree's kernels and on the parent's, in turns;

the serving control plane (two full-width ViT servers behind the
multi-tenant ResourceArbiter):

20. phase 6's server and measured LUT through the serve launcher's
    ``run_trace_mode`` with ``--trace poisson`` at the launcher's defaults
    (64 interactive requests over 5 s, the batch class at half the rate),
    a Tracer, a MetricsRegistry, a CalibrationStore and ``--record``: every
    arrival accounted for against the recorded schedule, zero cold
    (subnet, bucket) pairs on both servers, schema-valid spans whose
    components sum to each request's latency, the Chrome trace read back,
    ``engine_served_total`` equal to each class's completions, a
    calibration row for every served (subnet, bucket) and the store the
    same through save/load, K1's and K2's counters rising during the
    traffic with no bf16 call on K1 tile or K2 FMA, served logits equal
    to a direct forward of the subnet each payload names; it prints each
    class's percentiles, goodput and mean batch, the arbiter summary, the
    p50/p95 decomposition, the recorded schedule's p95 replayed through
    ``simulate(calibration=store)`` beside the live p95, the LUT's spread
    and the launches by variant (both servers serve graph replays);

the compiled executables (CUDA graphs, the reference's jit executables):

21. in two halves.  The LM's, at the end of the LM slice while its
    weights are on the card: K2 decode over a whole 528-slot cache with
    the fill on the device against its plain version at fills 1, mid and
    capacity, eagerly and under graph replays; ``elastic_moe.run`` eager
    beside phase 11's graph run: prefill and decode-step wall and event
    time at every point, peak memory and the graph pool, and the 16
    graph decode steps' logits within 2e-2 of the largest eager logit at
    every decodable point.  The ViT's, after phase 20: at bucket 8 for
    all 25 subnets the eager forward's wall (median of 5), the graph
    replay's wall (``server.measure``) and its device time (events around
    the replay); graph logits equal to the eager forward bit for bit;
    captures equal to subnets x buckets on both servers (phase 20's batch
    server all at warm), no cold pair; the graph LUT's full subnet slower
    than its smallest, its spread and its rank correlation with
    ``subnet_flops_ratio``; each server's graph-pool memory;

the conv nets (ResNet-152 and EfficientNet-B7 trained at full width,
their 1x1 convs and classifier on K1, the other convs on cuDNN):

22. (a) K1's forward, dgrad and wgrad against their plain versions at
    the conv shapes, fp32 and bf16: M = 802,816 rows (ResNet stage 0 at
    batch 256, EfficientNet's 112 px layers at microbatch 64) at (K, N) =
    (64, 64), (64, 256), (256, 64) and at k_act = n_act = 16 of 64 (width
    setting 0.25, also with zeros past 16 in the TPU op's shape), and M =
    256 at the squeeze-excite widths 12 and 20 (row strides TMA cannot
    take); each call one launch of the variant its shape, dtype and
    strides choose, exact zeros outside the active block, wgrad within
    tolerance of its largest value; (b) full-size logits, kernel path
    against plain path at batch 8: ResNet-152 at width settings 0 and 3,
    EfficientNet-B7 at 0 and 2 (kernel size 3), depth 0.5 and 1.0, BN in
    eval and train mode, fp32 (cuDNN's TF32 off) within a stated share of
    the largest |logit|, bf16 no farther from the fp32 logits than twice
    the plain path's bf16 logits are (plus the bf16 tolerance), bf16
    difference and top-1 agreement;
    (c) ``repro_torch.launch.train --arch resnet-152`` at cls_224, batch
    256, bf16: 4 steps, a checkpoint every 2, a failure at step 3;
    finite losses, exactly one restart, K1's forward, dgrad and wgrad
    counters rising, no other kernel launched, no launch on a variant
    (a) did not hold in bf16; median step, images/s, peak memory; (d) the
    same for EfficientNet-B7, 3 steps of 256 as 4 microbatches of 64
    (``--accum 4``: batch 256 at once does not fit), no restart; (e) one
    profiled step of each: device time in K1, convolutions, BN,
    elementwise and reduction kernels, and the rest, the busy share and
    the model-FLOPs rate (``launch/flops.py``) against the bf16 dense
    peak; (f) K1's forward, dgrad and wgrad against their plain versions
    at every distinct call of a recorded ResNet-152 step (batch 256) and
    EfficientNet-B7 microbatch (64), bf16 as recorded: forward and dgrad
    within tolerance and within tolerance of the largest value, wgrad
    within tolerance of the largest value, exact zeros past the active
    widths, one launch per comparison; and K1's forward, dgrad and wgrad
    over the recorded calls of the ResNet-152 step and of EfficientNet-B7's
    squeeze-excite as graph-replayed device time beside the plain version,
    ``torch.matmul`` and the bound.

the diffusion nets (DiT-L/2 and UNet-SDXL trained at full width at
train_256, DDIM-sampled; their products on K1 and K2, their 3x3 convs on
cuDNN):

23. (p), before the process turns TF32 off: an fp32 3x3 conv's dx and dw
    under torch's default cuDNN flags against a float64 conv, through
    the port's conv (within 1e-4 of the largest) and, for comparison,
    through autograd of a plain ``F.conv2d``; (k) K2's fp32 backward at
    the smoke head dims 8 and 16 against its plain version, on
    ``fma_f32``; (a) K1's forward, dgrad and wgrad and K2's forward and
    backward against their plain versions at every distinct call of one
    recorded DiT-L/2 step (batch 256) and UNet-SDXL microbatch (32), bf16
    as recorded, the cross-attention's K2 calls (77 keys) apart, one
    launch per comparison; then each kernel's graph-replayed device time
    over those calls beside its plain version, ``torch.matmul`` or SDPA
    (and SDPA's autograd backward) and the bound; (b) both denoisers'
    full-size outputs (batch 4), the zero-init gates drawn from a seeded
    normal, kernel path against plain path: fp32 within a stated share of
    the largest value, bf16 no farther from fp32 than twice the plain
    path's bf16 output (plus the bf16 tolerance); (c)
    ``repro_torch.launch.train --arch dit-l2`` (6 steps, a checkpoint
    every 3, a failure at step 5) and ``--arch unet-sdxl`` (2 steps as
    the launcher's 8 microbatches of 32, no checkpoint, a failure at step
    1): finite losses, one restart each, the step run again after the
    restart with the same loss as its first run, K1's and K2's five
    counters rising, no other kernel, every bf16 call on ``tma``,
    ``mma`` and ``resident``; median step, images/s, peak memory; one
    profiled step of each (device time in K1, K2, cuDNN's convolutions,
    norms and elementwise kernels; the busy share; the model-FLOPs rate
    against the bf16 dense peak); (d) the DDIM sampler at gen_fast (512
    px, batch 16, 4 steps) and (e) one denoiser call at gen_1024 (1024
    px, batch 4: K2's forward at 4096 tokens) for both nets, kernel path
    against plain path in bf16, every value finite, with the kernel
    path's time.

the LM's training (deepseek-moe-16b at train_4k, full width, cut to 4
layers: the launcher's one-card cut; K3's backward -- dgrad and wgrad on
their ``persistent`` kernels -- and K2's causal, D = 128 backward on
``wgmma``):

24. (a) K2's backward against its plain version, causal and not, bf16 at
    D = 64 and 128, fp32 at D = 8, 16 and 64, S = T in (1, 63, 64, 65,
    127, 129, 257, 4095, 4096), GQA R = 2, each comparison one launch on
    the variant its shape and dtype choose (``wgmma`` but for the
    non-causal D = 64 calls at S <= 256, which stay on ``resident``),
    within a stated share of the largest gradient;
    (b) K3's dgrad and wgrad against their plain versions, bf16 and fp32:
    C = 480, 16 and 17, E = 1, counts all 0, all C and ragged, NaN in x
    and dy past every count, the expert width and count as strided views,
    x as a strided view, the dense oracle's stride-0 expert axis; dgrad
    exact zeros past the counts, a dead expert's dw exactly 0, one launch
    per comparison on the variant it should take (``persistent``);
    then both at every distinct call of one recorded train_4k microbatch
    (4 x 4096, bf16, counts as routed), K2's first sequence against the
    plain version, every call the same bits twice and under 3 CUDA-graph
    replays, and (e) their graph-replayed device time over that
    microbatch, and K3's and K2's forward's, beside the plain versions,
    ``torch.bmm``, SDPA's forward and autograd backward and the bound,
    and with ``--parent-csrc`` the parent's kernels (a parent without
    ``wgmma`` on its two-pass ``mma`` backward, one without a
    ``persistent`` dgrad or wgrad on ``tma``) in turns, the K3 dgrad and
    wgrad rows broken down by shape, and the persistent wgrad at items
    of 128 and 256 columns, its experts by descending count and by index;
    (c) one AdamW step of the smoke config in fp32 on the card, kernel
    route against plain route: loss, gradient norm and every updated
    parameter; (d) ``repro_torch.launch.train --arch deepseek-moe-16b``:
    train_4k (256 x 4096) as the launcher's 64 microbatches of 4, 2
    steps, no checkpoint and no failure (the LM's restart is phase 29
    (a)'s): finite losses, all eight training counters rising on the Hopper variants (no bf16
    K3 backward on ``tile_bf16``); median step, tokens/s, peak memory; one
    profiled step (device time in K1, K2 and K3 forward and backward,
    norms and elementwise kernels, the MoE dispatch and the rest; the
    busy share; the model-FLOPs rate) and the share of routed slots the
    capacity keeps.

the cluster, chaos and watchtower layers (the full-width ViT on two
health-checked nodes sharing the card):

25. one replica built and warmed as the cluster builds it, timed (its
    captures and graph pool; the health interval is twice a capture's
    time, floor 0.2 s); (a) the serve launcher's ``run_trace_mode`` at
    phase 20's defaults with ``--nodes 2 --router p2c --health-interval
    H --rebalance-interval 1.0``, ``--record``, ``--trace-out``,
    ``--metrics-out``, ``--stream-trace``, ``--alerts-out`` and
    ``--profile-out`` under ``build/cluster/``: every arrival accounted
    for against the recording, zero cold pairs on the four replicas,
    every answer equal to a direct forward of its subnet, the streamed
    events equal to the one-shot export's, a profile row per (subnet,
    bucket) of the DEVICE spans, no node health-failed, K1's and K2's
    counters rising in the traffic; (b) two nodes through the Cluster
    API, both classes at 32 rps for 16 s through ``drive_live`` with a
    ``Reliability`` layer and a ``Watchtower``, node1 wedged at 1 s by a
    ``ChaosController``: the health check fails it within (K + 1)
    intervals of the wedge, no replica holds an unresolved future once
    ``drive_live`` has stopped the cluster, the retried count is
    positive, the batch class (on node1 alone, node0 gaining its second
    modelled chip at 0.5 s) is readmitted on node0, whose new replica
    then answers batch requests of the stream; answers equal to a
    direct forward; the launch counts of the kernels' record are those
    of (a)'s and (b)'s clusters alone; after each cluster stops
    and is dropped, the device memory allocated is back within 64 MiB.
    It prints per-class percentiles and goodput, routed, retried and
    health-failed counts, the wedge-to-HEALTH_FAIL time, the alerts, the
    replica's warm time and pool and the phase's seconds, each with the
    card's name and power limit.

the other LM configs (qwen1.5-110b, granite-20b and kimi-k2-1t-a32b at
full width, each at the LM launcher's one-card cut: 8 of 80 layers, all
52, 2 of 61; one config on the card at a time):

26. (a) K2 against its plain version at kimi-k2's head dim 112 (causal
    prefill 4 x 512, H 64 on KH 8, also read in place from a fused
    buffer) and decode over the 528-slot cache at kimi's D = 112 and
    granite's 48 query heads on one kv head (six groups of 8), each at
    fills 1, mid and capacity eagerly and inside one captured CUDA graph
    with the fill advanced between replays, q and k at 1.5 x randn so the
    scores spread by about 2 and a kernel that misread the scores or a
    group's heads would miss the tolerance by far; every other call on
    ``wgmma`` or ``decode``, and an fp32 call and unaligned bf16 rows at
    D = 112 on ``fma``; (b) each config through
    ``elastic_moe.run``: random bf16 weights drawn on the card from a
    seed, a prefill of 4 x 512 at each of its five operating points and
    16 teacher-forced decode steps at the decodable ones, all graph
    replays (wall and device time, tokens/s, the model-FLOPs bound, the
    launches by kernel and variant, the graph pool and peak memory); every
    logit finite; every kernel of the point launched (K3 where the point's
    depth reaches a MoE layer); no bf16 call on K1 tile, K2 fma or K3
    tile, no fp32 router call on K1 tile; every decode K2 call on
    ``decode``; kimi's K3 on ``tma`` in prefill and ``stream`` in decode
    at E = 384, and the routed slots it keeps; the 16 graph decode steps
    at the full point within 2e-2 of the largest eager logit; (c) the
    kernel route against the plain route at full width and depth 2 at
    every operating point: fp32 (qwen, granite) within the LM's fp32
    tolerance, bf16 on the plain route's routing within its bf16
    tolerance, and one decode step at the full point from a 528-slot
    cache that a plain prefill filled, the kernel route (every K2 call on
    ``decode``: granite's six head groups, kimi's D = 112) against the
    plain route on the same caches and routing, within the bf16
    tolerance; (d) masked widths (0-d tensors: the FFN, the heads, the
    depth; kimi's experts) against sliced ones at depth 2, qwen and kimi,
    bf16 (and fp32 for qwen), within the same tolerances; (e) K1, K2 and
    K3 over the recorded calls of one prefill and one decode step at the
    full point as graph-replayed device time beside the plain version,
    ``torch.matmul``, SDPA or ``torch.bmm`` and the bound (with
    ``--parent-csrc``, the parent's K2 beside the prefill's); after each
    config the device memory allocated is back within 64 MiB.

K2's wgmma forward (FlashAttention-3's, on wgmma fed by TMA):

27. (a) against its plain version on fp32 copies of the same bf16 inputs
    at every call class of the port's prefill, training and serving
    paths (train_4k's causal S = T = 4096 at D 128, DiT-L/2's 256, the
    LMs' causal 512 prefills with GQA 64 / 8, MQA 48 / 1 and kimi-k2's
    D = 112, the ViT's and the sandwich step's 197 read in place from a
    fused buffer, the UNet's 256 and its cross-attention over 77 keys,
    ragged 300, 256 queries over 4096 keys, the route's edge at S = 65),
    o and the logsumexp, eagerly, twice bit for bit and under 3 CUDA-graph
    replays, one ``wgmma`` launch a call; q and k at 1.5 x randn, and a
    "no scores" answer and the next head's answer shown to fail the
    check; (b) the route's evidence: one call of each class at its full
    size on ``wgmma`` and on ``mma`` (each forced), and SDPA, as
    graph-replayed device time in turns, beside the call's bound and the
    variant ``choose_variant`` takes.  Phases 6, 11, 15, 20, 23, 24, 25
    and 26 check that their main paths took ``wgmma`` (``mma`` only at
    the UNet's 8 x 8 latent); with ``--parent-csrc`` every K2 forward row
    (phases 7, 13, 19, 23, 24 and 26) times the parent's ``mma`` beside
    it (``LATER_VARIANTS``).  Phase 24 (e) also times K1's forward, dgrad
    and wgrad over the train_4k microbatch, by call shape.

the LM served across a device mesh (deepseek-moe-16b at full width and
depth on a 1 x 2 mesh: two ranks sharing the one card over gloo, so its
times are not a multi-card speed):

28. the one-process route first, in this process (einsum dispatch,
    unsharded decode, at a capacity factor where no slot drops: prefill
    4 x 260 and 8 decode steps, its routing recorded; its weights freed),
    then two ranks (``spawn``; each draws the weights leaf by leaf from the
    seed and keeps its block: 32 of the 64 experts, the other leaves
    whole): gloo's collectives probed on CUDA tensors, values checked;
    the main path, ``elastic_moe.run`` under the mesh at every operating
    point (prefill 4 x 512 on the a2a dispatch, 8 decode steps against
    the cache sharded over the sequence, K2 ``decode`` with its
    logsumexp), the launch counters reset before it and read after,
    every kernel launched on each rank on the variants its shapes take,
    the kept share of routed slots beside each time; (b) at the config's
    capacity factor 1.25, each rank's kernel route against its plain
    route on the plain route's routing (prefill and one decode step),
    within the bf16 pinned tolerance; (a) the 2-rank prefill and 8 decode
    steps, the one-process run's routing pinned, 100% kept, writing
    slots 260 .. 267 across the shard boundary at 264, within the same
    tolerance of the one-process route; beside it the routing the ranks
    compute themselves, by stage: each prefill block routed again at the
    one-process call's size must give the pinned routing bit for bit and
    its probabilities stay within round-off of it, and the share of
    token-layer routings sent elsewhere stays under a stated limit at
    prefill and at decode; (c) K2 ``decode`` with the logsumexp against its
    plain version on fp32 copies over each half of a 528-slot cache, one
    half with no key (o 0, lse -inf, no NaN), the halves merged as the
    sharded decode merges them against the whole attention, and a merge
    without a half's partial and one with the halves swapped shown to
    fail; a graph-replayed row over one rank's decode step beside SDPA
    and the bound; (d) K3 at rank 0's recorded a2a prefill calls (32
    local experts, 2 x 120 rows, the live counts of the exchange) against
    its plain version, and their row beside ``torch.bmm`` and the bound.

the LM trained across a 2 x 2 (data, model) mesh (four ranks sharing the
one card over gloo, so its times are not a multi-card speed):

29. deepseek-moe-16b at train_4k, full width, cut to its dense layer and
    one MoE layer and to a global batch of 4 x 4096 as 2 microbatches:
    (c)'s one-process step first, in this process (no slot drops, aux
    weight 0; its gradients and routing kept), then four ranks: (a) the
    main path, each rank the training launcher's own rank entry
    (``--mesh 2x2``: the reference's TP and FSDP placement, the a2a
    dispatch, remat) for 2 steps with a failure at step 1 and a restart
    from step 0, the launch counts reset before it and read after, every
    one of the eight kernels launched on every rank on its Hopper
    variant, finite losses, step 0 the same bits after the restart; (b)
    one step on the kernel route against the plain route on the plain
    route's expert choice: the loss, the gradient norm and every
    gradient block within stated tolerances, and AdamW's first update
    where the gradient stands above them; (c) the mesh step against the
    one-process step on its expert choice, within twice (b)'s
    differences; (d) ``compressed_all_reduce`` over ``data`` on CUDA
    tensors the same bits as on CPU copies, and fault F8's biased mean;
    (e) rank 0's recorded calls of K1-K3 and their backward kernels,
    timed beside the plain version, the library call and the bound.
30. qwen1.5-110b, granite-20b and kimi-k2-1t-a32b trained on the card:
    (a) K2's wgmma backward at kimi-k2's head dim 112 at its train_4k
    microbatch (4 x 4096, causal, 64 query heads on 8 kv heads) from the
    forward's logsumexp, against the plain version on fp32 copies, a
    corrupted dK shown to fail that check, the backward and the forward
    timed beside SDPA (``enable_gqa``) and the bound; (b) each config
    through the training launcher at its one-card cut at full width
    (``ONE_CARD_CUT``, ``ONE_CARD_ACCUM``'s microbatch), 2 steps with the
    global batch cut for this phase to 2 microbatches (the launcher's
    ``ONE_CARD_CUT`` entry given a ``global_batch``, its cut line
    checked): finite losses, the first against the plain route's loss on
    the same batch and parameters (within phase 29 (b)'s loss tolerance;
    ln(vocab) plus half the logits' variance logged beside it), step
    time, tokens/s, model FLOPs rate, peak memory and launches by
    variant; one
    microbatch's K1 calls held against the plain versions and timed; one
    row of 1024 positions on the kernel route against the plain route
    within phase 29 (b)'s tolerances; (c) K3's forward, dgrad and wgrad
    at kimi-k2's MoE shapes (E 384, d 7168, F 2048) over the live counts
    of one 4 x 4096 microbatch's routing through a kimi router, against
    the plain versions and timed; (d) granite-20b (MQA) and kimi-k2 (GQA,
    D 112, bf16 Adafactor on blocks) on a 1 x 2 mesh of two ranks sharing
    the card over gloo (``SHARED_CARD_CUT``), one step each against the
    one-process step within phase 29 (c)'s tolerances.

the vision family trained across a 2 x 2 (data, model) mesh (four ranks
sharing the card over gloo):

31. ResNet-152, the dynamic-ofa-supernet and EfficientNet-B7 at cls_224,
    full width and depth, under the reference's ``vision_rules``
    (attention and MLP tensor parallel, convs split on their output
    channels and the classifier on its rows over ``model``, no FSDP; BN's
    statistics summed over ``data``), the global batch cut to 8 images as
    2 microbatches (``SHARED_CARD_CUT``): the one-process steps of
    ResNet-152 (fp32) and the ViT (bf16) first, in this process (kept
    for (c); the plain route (b'); each microbatch's rows reversed, the
    same step in exact arithmetic (b'')); then four ranks: (a) each net
    through the launcher's own rank entry (``--mesh 2x2``) for 2 steps
    with a failure at step 1 and a restart from step 0 (EfficientNet-B7
    without: ``VM_RESTART``), the launch counts
    reset before each and read after, K1's forward, dgrad and wgrad (and
    the ViT's K2 forward and backward) launched on every rank on their
    Hopper variants, finite losses, step 0 the same bits after the
    restart; (b) one bf16 step of ResNet-152 and the ViT on the kernel
    route against the plain route (loss, gradient norm and gradient
    blocks within phase 29 (b)'s tolerances), its launches counted; (c)
    the mesh step in the one-process step's dtype against it (loss,
    gradient norm, gradient blocks, each row's loss and, for ResNet-152,
    both microbatches' BN statistics) within twice the step's noise
    ((b), (b'), (b'')), at least phase 29 (b)'s tolerances (phase 29
    (c)'s rule; ``VM_C_DTYPE`` says why ResNet-152 is held in fp32); (e)
    rank 0's recorded K1 and K2 calls timed beside the plain version,
    the library call and the bound.
    Each phase's seconds end its log, and a ``phases_s`` line gathers
    them.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

# H100 SXM data sheet: bf16 dense tensor-core peak and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12     # outside the tensor cores (the MoE router)
HBM_BYTES_PER_S = 3.35e12
BUCKET = 8           # the serve launcher's max batch: the largest bucket
N_REQUESTS = 64
TOL = {"float32": 2e-4, "bfloat16": 2e-2}         # K1, as the ref tests
ATTN_TOL = {"float32": 3e-3, "bfloat16": 3e-2}    # K2, as the ref tests
# a gradient under this share of the largest gradient beside it is 0 but
# for fp32 round-off (phases 17 and 18)
ZERO_GRAD_REL = 1e-5
LOGITS_FP32_TOL = 1e-3   # 12 fp32 layers, logits of order one
EXPERT_TOL = {"float32": 3e-4, "bfloat16": 3e-2}  # K3, as the ref tests
# 2 fp32 layers at d 2048 and a 102400-way head, logits of order one; a
# routing flip between the paths (a near-tie in the top-6) would exceed it
LM_LOGITS_FP32_TOL = 1e-3
# the same in bf16 with the plain path's routing replayed in the kernel
# path: what is left is bf16 rounding (a few ulps of logits below ~6)
LM_LOGITS_BF16_PINNED_TOL = 0.125
LM_BATCH, PREFILL_LEN, DECODE_STEPS = 4, 512, 16
E2E_ROUNDS = 4       # phase 14: rounds of parent, kernel, kernel, parent


def log(msg: str) -> None:
    print(msg, flush=True)


# (key, start) of every phase begun, in order: each phase's seconds run to
# the next one's start (a phase's own sub-steps log their own)
PHASES: list = []


def phase(name: str):
    now = time.perf_counter()
    if PHASES:
        log(f"  [phase {PHASES[-1][0]}: {now - PHASES[-1][1]:.1f} s]")
    key = re.match(r"\d+\.(?: \([a-z]\)(?:, \([a-z]\))*)?", name)
    PHASES.append((key.group(0) if key else name[:24], now))
    log(f"\n== {name}")
    return now


def phases_s(end: float) -> dict:
    """Seconds by phase key (a key met twice sums), the last phase to
    ``end``."""
    out: dict = {}
    for (k, t0), nxt in zip(PHASES, [t for _, t in PHASES[1:]] + [end]):
        out[k] = round(out.get(k, 0.0) + nxt - t0, 1)
    return out


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Eager time of fn(): a Python loop of calls between two CUDA events.
    It includes the host's launch cost of every call: what the eager path
    pays, not device time."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_time_ms(fn, iters: int = 3) -> float:
    """Host time to issue fn()'s launches (the loop's wall time up to its
    last launch, with no wait for the card): the launch cost the eager
    path pays on the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / iters * 1e3


def profiler_time_ms(fn, iters: int = 3) -> float:
    """Device time of fn() as torch.profiler's per-kernel sums report it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0.0)
             for e in prof.key_averages())
    return us / 1e3 / iters


def graph_time_ms(fn, iters: int = 10) -> tuple:
    """(device time of one fn() call in ms, how it was taken).  fn() is
    warmed up on a side stream (first-use builds, attributes, the widths
    tensors, library workspaces), captured once in a CUDA graph, and the
    graph replayed ``iters`` times between two events: device time with
    no host gaps.  If capture fails, the profiler's device time instead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            fn()
    except Exception as e:  # noqa: BLE001 -- any capture failure
        del graph
        torch.cuda.synchronize()
        return profiler_time_ms(fn), f"profiler ({type(e).__name__})"
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters, "graph"


# bytes and operations of one recorded call, and the peak that bounds it:
# inputs read once, outputs written once, this call's live rows

def k1_work(args, kw) -> tuple:
    import torch
    x, w, k_act, n_act = args
    M = x.numel() // x.shape[-1]
    n_out = kw.get("n_out", w.shape[-1])
    peak = PEAK_BF16_FLOPS if x.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return (x.element_size() * (M * k_act + k_act * n_act + M * n_out),
            2 * M * k_act * n_act, peak)


# the host value of each recorded decode call's device key count, read
# once outside any capture (the library yardstick and the bound need it)
_HOST_LEN = {}


def host_len(kv_len) -> int:
    """int(kv_len), read afresh outside a graph capture and remembered
    for the capture (where a device read is illegal)."""
    import torch
    got = _HOST_LEN.get(id(kv_len))
    if not torch.cuda.is_current_stream_capturing() or got is None \
            or got[0] is not kv_len:
        got = _HOST_LEN[id(kv_len)] = (kv_len, int(kv_len))
    return got[1]


def k2_work(args, kw) -> tuple:
    q, k, _ = args
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if kw.get("kv_len") is not None:      # the cache's valid keys only
        T = host_len(kw["kv_len"])
    if kw.get("causal", True):
        pairs = sum(min(T, s + 1) for s in range(S))
    else:
        pairs = S * T
    return (q.element_size() * (2 * B * S * H * D + 2 * B * T * KH * D),
            4 * B * H * D * pairs, PEAK_BF16_FLOPS)


def k3_work(args, kw) -> tuple:
    x, w, c = args
    Ee, C, K = x.shape
    live = c.clamp(max=C).long()
    rows, experts = int(live.sum()), int((live > 0).sum())
    F_ = w.shape[2]
    return (2 * (rows * K + experts * K * F_ + Ee * C * F_),
            2 * rows * K * F_, PEAK_BF16_FLOPS)


def k1_plain(x, w, k_act, n_act, n_out=None):
    from repro_torch.kernels import elastic_matmul as em
    n_out = w.shape[-1] if n_out is None else n_out
    return em.elastic_matmul_plain(x.reshape(-1, x.shape[-1]), w, k_act,
                                   n_act, n_out)


def k1_library(x, w, k_act, n_act, n_out=None):
    """The yardstick: one torch.matmul on the active block (the port
    never calls it)."""
    import torch
    return torch.matmul(x[..., :k_act], w[:k_act, :n_act])


def k2_plain(q, k, v, causal=True, kv_len=None):
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)


def k2_library(q, k, v, causal=True, kv_len=None):
    """The yardstick: scaled_dot_product_attention on (B, H, S, D) views
    (the port never calls it), over the valid keys of a decode cache."""
    import torch.nn.functional as F
    if kv_len is not None:
        n = host_len(kv_len)
        k, v = k[:, :n], v[:, :n]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=k.shape[2] != q.shape[2])


# the forward kernels (the serving and LM paths launch no backward)
FORWARD = ("elastic_matmul", "flash_attention", "expert_matmul")
# the kernels no bf16 main-path call may take: the first port's forward
# kernels, the first backward of K1, K3's backward tile loop, and K3's
# tma dgrad and wgrad, which the persistent ones replaced (dgrad where it
# stores dx; the serving and LM inference paths launch no backward)
OLD_BF16 = {("elastic_matmul", "tile_bf16"), ("flash_attention", "fma_bf16"),
            ("expert_matmul", "tile_bf16"),
            ("elastic_matmul_dgrad", "wmma_bf16"),
            ("elastic_matmul_wgrad", "wmma_bf16"),
            ("expert_matmul_dgrad", "tma"),
            ("expert_matmul_dgrad", "tile_bf16"),
            ("expert_matmul_wgrad", "tma"),
            ("expert_matmul_wgrad", "tile_bf16")}


# K2's mma forward: kept for the call classes where it measured faster
# than wgmma (S <= 64: the UNet's 8 x 8 latent); a path takes it only
# where its ``need`` names it
ONLY_WHERE_NEEDED = {("flash_attention", "mma")}


def main_path_variants(counts: dict, need: set) -> None:
    """Raise unless a main path's bf16 calls all went through the new
    variants: no launch of the old K1 tile, K2 FMA, K3 tile or K1 WMMA
    backward kernel in bf16, no K2 ``mma`` unless ``need`` names it, and
    every (kernel, variant) in ``need`` launched.  ``counts``
    is ``ops.variant_counts()``: variants by kernel."""
    flat = {(k, v): n for k, per in counts.items() for v, n in per.items()}
    old = {kv: flat[kv] for kv in sorted(OLD_BF16) if flat.get(kv)}
    if old:
        raise AssertionError(f"bf16 main-path calls took the old kernels: "
                             f"{old}")
    stray = {kv: flat[kv] for kv in sorted(ONLY_WHERE_NEEDED)
             if flat.get(kv) and kv not in need}
    if stray:
        raise AssertionError(f"main-path calls took a variant this path "
                             f"keeps only for other shapes: {stray}")
    idle = sorted(kv for kv in need if not flat.get(kv))
    if idle:
        raise AssertionError(f"variants never launched on the main path: "
                             f"{idle}")


def k3_on_stage(by_stage: dict) -> None:
    """Raise unless K3's bf16 main-path calls took tma in prefill and
    stream in decode, and nothing else: ``by_stage`` is {"prefill",
    "decode"} -> launches by variant."""
    for kind, want in (("prefill", "tma"), ("decode", "stream")):
        other = {v: n for v, n in by_stage[kind].items() if n and v != want}
        if other or not by_stage[kind][want]:
            raise AssertionError(f"K3 bf16 {kind} calls took {other} "
                                 f"besides {want}")


def k1_group(args, kw) -> str:
    """A K1 call's shape and the variant it takes, for the breakdown."""
    import torch

    from repro_torch.kernels import elastic_matmul as em
    x, w, k_act, n_act = args
    M = x.numel() // x.shape[-1]
    x2 = x.reshape(-1, x.shape[-1])
    variant = em.choose_variant(
        M, k_act, n_act, x.dtype, em._row_stride(x2), em._row_stride(w),
        x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    if variant == "tma":
        cwg, bn = em.tma_tile(M, n_act)
        variant += f" {64 * cwg}x{bn}"
    elif variant == "f32_splitk":
        splits, kc = em.f32_splitk_plan(M, k_act, n_act)
        variant += f" splits {splits}x{kc}"
    dt = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    return f"M={M} k={k_act} n={n_act} {dt} {variant}"


def k2_group(args, kw) -> str:
    """A K2 forward call's shape and the variant it takes, for the
    breakdown."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = args
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    causal = kw.get("causal", True)
    variant = fa.choose_variant(S, min(T, 1) if causal and S == 1 else T, H,
                                KH, D, q.dtype, fa._aligned(q, k, v))
    return (f"B={B} S={S} T={T} H={H}/{KH} D={D}"
            f"{' causal' if causal else ''} {variant}")


def k3_group(args, kw) -> str:
    """A K3 call's shape and the variant it takes, for the breakdown."""
    import torch

    from repro_torch.kernels import expert_matmul as xm
    x, w, _ = args
    E, C, K = x.shape
    variant = xm.variant_of(x, w)
    if variant == "tma":
        variant += " {}x{}".format(*xm.TMA_TILE)
    elif variant == "stream":
        variant += " {}x{}".format(*xm.stream_plan(E, C, K, w.shape[2],
                                                   x.element_size()))
    dt = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    return f"E={E} C={C} K={K} F={w.shape[2]} {dt} {variant}"


def time_rows(label: str, calls: list, kern, plain, lib, lib_name: str,
              work, parent=None, group=None, mode=None) -> dict:
    """Time one row -- the recorded calls of a forward or a step -- as
    graph-replayed device time for the kernel, its plain version, the
    library yardstick and (given) the parent commit's kernel, in turns
    parent, kernel, kernel, parent; as the eager loop the eager path pays;
    and as the host's time to issue the loop (kernel and parent).
    ``parent`` is (op, libs): the parent's op, to be called inside
    ``libs()``.  The bound sums each call's bound at the data-sheet
    peaks.  ``mode`` is the grad-mode context the loops run in
    (``torch.inference_mode`` by default)."""
    import torch
    mode = mode or torch.inference_mode
    bound, b_sum, o_sum, b_ms, o_ms = 0.0, 0.0, 0.0, 0.0, 0.0
    for args, kw in calls:
        nb, no, peak = work(args, kw)
        bound += kernel_bound_ms(nb, no, peak)[0]
        b_sum, o_sum = b_sum + nb, o_sum + no
        b_ms += kernel_bound_ms(nb, 0.0)[0]
        o_ms += kernel_bound_ms(0.0, no, peak)[0]
    # what bounds the row: its bytes or its operations, each at the peak
    # of the calls' own dtype (fp32 operations outside the tensor cores)
    by = "bytes" if b_ms >= o_ms else "operations"

    def run(fn):
        def go():
            for args, kw in calls:
                fn(*args, **kw)
        return go

    hows = set()
    p_fn, p_libs = parent or (None, contextlib.nullcontext)

    def timed(fn):
        ms, how = graph_time_ms(run(fn))
        hows.add(how)
        return ms
    with mode():
        ts_parent, ts_kernel = [], []
        for who in (("parent", "kernel", "kernel", "parent") if parent
                    else ("kernel",)):
            if who == "parent":
                with p_libs():
                    ts_parent.append(timed(p_fn))
            else:
                ts_kernel.append(timed(kern))
        t_p, t_l = timed(plain), timed(lib)
        e_k = cuda_time_ms(run(kern), iters=3, warmup=1)
        e_l = cuda_time_ms(run(lib), iters=3, warmup=1)
        h_k = host_time_ms(run(kern))
        if parent:
            with p_libs():
                e_p = cuda_time_ms(run(p_fn), iters=3, warmup=1)
                h_p = host_time_ms(run(p_fn))
    t_k = sum(ts_kernel) / len(ts_kernel)
    row = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": bound,
           "bound_by": by, "calls": len(calls), "eager_ms": e_k,
           "eager_library_ms": e_l, "host_ms": h_k,
           "timing": "/".join(sorted(hows))}
    line = (f"  {label} x{len(calls)} calls, device time ({row['timing']}):"
            f" kernel {t_k:.4f} ms")
    if parent:
        row.update(parent_ms=sum(ts_parent) / len(ts_parent),
                   eager_parent_ms=e_p, host_parent_ms=h_p)
        line += (f" (runs {', '.join(f'{t:.4f}' for t in ts_kernel)}), "
                 f"parent {row['parent_ms']:.4f} ms (runs "
                 f"{', '.join(f'{t:.4f}' for t in ts_parent)})")
    line += (f", plain {t_p:.4f} ms, {lib_name} {t_l:.4f} ms, bound "
             f"{bound:.4f} ms ({by}; {b_sum / 1e9:.3f} GB, "
             f"{o_sum / 1e12:.4f} TFLOP); eager loop (with host launch "
             f"cost): kernel {e_k:.4f} ms, {lib_name} {e_l:.4f} ms")
    n = max(len(calls), 1)
    line += f"; host issue kernel {h_k:.4f} ms ({h_k / n * 1e3:.1f} us/call)"
    if parent:
        line += (f", parent eager {e_p:.4f} ms, host issue {h_p:.4f} ms "
                 f"({h_p / n * 1e3:.1f} us/call)")
    log(line)
    if group is not None:     # where the row's time goes, by call shape
        groups = {}
        for args, kw in calls:
            groups.setdefault(group(args, kw), []).append((args, kw))
        row["groups"] = {}
        with mode():
            for name, sub in sorted(groups.items()):
                gb = sum(kernel_bound_ms(*work(a, k))[0] for a, k in sub)
                tk = graph_time_ms(lambda sub=sub: [kern(*a, **k)
                                                    for a, k in sub])[0]
                tl = graph_time_ms(lambda sub=sub: [lib(*a, **k)
                                                    for a, k in sub])[0]
                row["groups"][name] = {"calls": len(sub), "ms": tk,
                                       "library_ms": tl, "bound_ms": gb}
                was = ""
                if parent:
                    with p_libs():
                        tp = graph_time_ms(lambda sub=sub: [
                            p_fn(*a, **k) for a, k in sub])[0]
                    row["groups"][name]["parent_ms"] = tp
                    was = f", parent {tp:.4f} ms"
                log(f"    {name}: x{len(sub)} kernel {tk:.4f} ms{was}, "
                    f"{lib_name} {tl:.4f} ms, bound {gb:.4f} ms")
    return row


# K1's backward launchers since its tma variants; a parent without them
# runs its backward through the older entry points, unchanged since
K1_BWD_TMA = ("repro_elastic_matmul_dgrad_tma",
              "repro_elastic_matmul_wgrad_tma")
# K2's decode launcher since it reads the key count on the device; a
# parent without it runs decode calls through its host-count entry point
K2_DECODE_LEN = "repro_flash_attention_decode_len"
# K2's decode launcher with the logsumexp (the sharded decode's, called
# only with ``return_lse``: a parent without it runs every other decode
# call through ``K2_DECODE_LEN``, and phase 28 runs on this tree's build)
K2_DECODE_LSE = "repro_flash_attention_decode_lse"
# the launchers of later variants: (source, launcher, module attribute of
# the variant choice, the choice's ``kind`` it serves or None for every
# call, {variant: the variant it took before}); a parent without one runs
# those calls on the older variant, through this tree's wrapper and the
# parent's library (K3's persistent wgrad came after its persistent
# dgrad: a parent may have the one and not the other)
LATER_VARIANTS = (
    ("elastic_matmul", "repro_elastic_matmul_f32_splitk", "choose_variant",
     None, {"f32_splitk": "tile_f32"}),
    ("expert_matmul", "repro_expert_matmul_dgrad_persistent",
     "choose_bwd_variant", "dgrad", {"persistent": "tma"}),
    ("expert_matmul", "repro_expert_matmul_wgrad_persistent",
     "choose_bwd_variant", "wgrad", {"persistent": "tma"}),
    ("flash_attention", "repro_flash_attention_wgmma", "choose_variant",
     None, {"wgmma": "mma"}),
)


# K2's bf16 backward launchers since its two-pass mma.sync kernels, by
# variant; a parent without one runs those calls on its two-pass entry
# point
K2_BWD_LATER = {"resident": "repro_flash_attention_bwd_resident",
                "wgmma": "repro_flash_attention_bwd_wgmma"}


def later_launchers(name: str) -> tuple:
    return tuple(launcher for src, launcher, *_ in LATER_VARIANTS
                 if src == name)


def parent_kernels(csrc: str) -> dict:
    """The parent commit's kernels, built from its ``csrc`` directory
    beside ours.  Returns {"k1", "k2", "k3", "k1_dgrad", "k1_wgrad",
    "k2_bwd"}: ops
    to call inside {"libs"}(), which serves the parent's libraries in the
    build's place.  A kernel whose parent library exports every launcher
    this tree's wrapper binds runs through that wrapper (variant choice
    and plans as here); K3 before its tma and stream variants runs through
    its one C interface (the tile launcher, unchanged since) behind the
    checks and allocation of its wrapper of the time; K1's backward before
    its tma variants through this wrapper's ``wmma_bf16`` route (in bf16),
    which calls the parent's entry points as its wrapper did; and a call
    whose variant the parent lacks (``LATER_VARIANTS``: K1 ``f32_splitk``,
    K3's ``persistent`` dgrad or wgrad) on the variant it took before; a K2
    backward whose variant the parent lacks (``K2_BWD_LATER``) on its
    two-pass entry point, called as its wrapper of the time called it."""
    import ctypes
    from pathlib import Path

    import torch

    from repro_torch.kernels import build, ops
    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import expert_matmul as xm
    from repro_torch.kernels import flash_attention as fa
    out = build.BUILD_DIR.parent / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {n: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-o", str(out / f"lib{n}.so"),
         str(Path(csrc) / f"{n}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in build.SOURCES}
    libs = {}
    for n, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"parent {n} failed to build:\n{text}")
        libs[n] = ctypes.CDLL(str(out / f"lib{n}.so"))
    f_xm = libs["expert_matmul"].repro_expert_matmul
    f_xm.argtypes, f_xm.restype = xm._ARGTYPES["repro_expert_matmul"], \
        ctypes.c_int

    def exports_all(name, mod, skip=()):
        return all(hasattr(libs[name], fn) for fn in mod._ARGTYPES
                   if fn not in skip)

    def k3(x, w, counts):
        xm.check_cuda_args(x, w, counts)
        E, C, K = x.shape
        y = torch.empty((E, C, w.shape[2]), dtype=x.dtype, device=x.device)
        if y.numel() == 0:
            return y
        rc = f_xm(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                  counts.data_ptr(), E, C, K, w.shape[2], *xm.strides(x, w),
                  xm.DTYPE_CODES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent K3 launch failed ({rc})")
        return y

    mods = {"elastic_matmul": em, "flash_attention": fa,
            "expert_matmul": xm}
    lacking = {}     # (source, attribute): [(kind, before), ...]
    for name, launcher, attr, kind, before in LATER_VARIANTS:
        if not hasattr(libs[name], launcher):
            lacking.setdefault((name, attr), []).append((kind, before))
    older = []       # (module, attribute, key) of the choices to route
    fns = {}
    for (name, attr), rules in lacking.items():
        orig = getattr(mods[name], attr)

        def choose(*a, _orig=orig, _sig=inspect.signature(orig),
                   _rules=rules, **kw):
            v = _orig(*a, **kw)
            bound = _sig.bind(*a, **kw)
            bound.apply_defaults()
            for kind, before in _rules:
                if kind in (None, bound.arguments.get("kind")):
                    v = before.get(v, v)
            return v
        older.append((mods[name], attr, f"{name}.{attr}"))
        fns[f"{name}.{attr}"] = choose

    @contextlib.contextmanager
    def parent_libs():
        with contextlib.ExitStack() as stack:
            for n, lib in libs.items():
                stack.enter_context(build.loaded_as(n, lib))
            stack.enter_context(routed(older, fns))
            yield
    def wmma_route(fn):
        def call(a, *args):
            return fn(a, *args, variant="wmma_bf16"
                      if a.dtype == torch.bfloat16 else None)
        return call
    for name, mod, skip in (("elastic_matmul", em, K1_BWD_TMA),
                            ("flash_attention", fa,
                             (K2_DECODE_LEN, K2_DECODE_LSE,
                              *K2_BWD_LATER.values()))):
        skip = (*skip, *later_launchers(name))
        if not exports_all(name, mod, skip):
            raise RuntimeError(f"parent {name} lacks a launcher of "
                               f"{sorted(set(mod._ARGTYPES) - set(skip))}")
    k1_tma_bwd = all(hasattr(libs["elastic_matmul"], fn)
                     for fn in K1_BWD_TMA)
    k2 = ops.flash_attention_op
    if not hasattr(libs["flash_attention"], K2_DECODE_LEN):
        f_dec = libs["flash_attention"].repro_flash_attention_decode
        f_dec.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        f_dec.restype = ctypes.c_int

        def k2(q, k, v, causal=True, kv_len=None):
            """The parent's K2 at a host key count: its decode entry point
            (the wrapper's decode branch of its time), anything else
            through this tree's wrapper on the valid keys."""
            B, S, H, D = q.shape
            T = k.shape[1] if kv_len is None else host_len(kv_len)
            k, v = k[:, :T], v[:, :T]
            T_seen = min(T, 1) if causal and S == 1 else T
            if fa.choose_variant(S, T_seen, H, k.shape[2], D, q.dtype,
                                 fa._aligned(q, k, v)) != "decode":
                return ops.flash_attention_op(q, k, v, causal=causal)
            o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
            st = (ctypes.c_longlong * 12)(
                *(x for t in (q, k, v, o) for x in t.stride()[:3]))
            splits, chunk = fa.decode_plan(T_seen, B * k.shape[2])
            ws = torch.empty(B * H * splits * (D + 2), dtype=torch.float32,
                             device=q.device)
            rc = f_dec(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       ws.data_ptr(), B, H, k.shape[2], T_seen, D, st,
                       1.0 / math.sqrt(D), splits, chunk,
                       torch.cuda.current_stream(q.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"parent K2 decode launch failed ({rc})")
            return o
    k2_bwd = k2_bwd_kernel
    lacks = {v for v, fn in K2_BWD_LATER.items()
             if not hasattr(libs["flash_attention"], fn)}
    if lacks:
        f_bwd = libs["flash_attention"].repro_flash_attention_bwd
        f_bwd.argtypes = fa._ARGTYPES["repro_flash_attention_bwd"]
        f_bwd.restype = ctypes.c_int

        def k2_bwd(q, k, v, o, lse, do, causal=False):
            """The parent's K2 backward: a call on a variant it lacks
            on its two-pass entry point (mma.sync in bf16: a delta
            launch, then dK/dV and dQ), anything else through this
            tree's wrapper."""
            B, S, H, D = q.shape
            T, KH = k.shape[1], k.shape[2]
            if fa.choose_bwd_variant(S, T, D, q.dtype, causal) not in lacks:
                return k2_bwd_kernel(q, k, v, o, lse, do, causal)
            q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            delta = torch.empty((B, H, S), dtype=torch.float32,
                                device=q.device)
            st = (ctypes.c_longlong * 24)(
                *(x for t in (q, k, v, o, do, dq, dk, dv)
                  for x in t.stride()[:3]))
            rc = f_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                       delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                       dv.data_ptr(), B, H, KH, S, T, D, st,
                       1.0 / math.sqrt(D), int(causal),
                       fa.DTYPE_CODES[q.dtype],
                       torch.cuda.current_stream(q.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"parent K2 backward launch failed ({rc})")
            return dq, dk, dv
    return {"k1": ops.elastic_matmul_op, "k2": k2, "k2_bwd": k2_bwd,
            "k3": ops.expert_matmul_op
            if exports_all("expert_matmul", xm,
                           later_launchers("expert_matmul")) else k3,
            "k1_dgrad": em.elastic_matmul_dgrad if k1_tma_bwd
            else wmma_route(em.elastic_matmul_dgrad),
            "k1_wgrad": em.elastic_matmul_wgrad if k1_tma_bwd
            else wmma_route(em.elastic_matmul_wgrad),
            "libs": parent_libs}


def repeatable(fn, want, tol: float, what: str) -> float:
    """Run fn() (a kernel call: a tensor or a tuple of them) twice, and
    once captured in a CUDA graph replayed 3 times; raise unless every
    result equals the first call's bit for bit and that is within ``tol``
    of ``want`` (the plain version's).  Returns the max abs err."""
    import torch

    def flat(r):
        return tuple(r) if isinstance(r, (tuple, list)) else (r,)
    first, again = flat(fn()), flat(fn())
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{what}: two calls differ")
    err = max(close(a, b, tol) for a, b in zip(first, flat(want)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = flat(fn())
    for _ in range(3):
        for r in replayed:
            r.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(replayed, first)):
            raise AssertionError(f"{what}: a graph replay differs from the "
                                 f"eager call")
    del graph
    return err


# elements a check reads at once in fp32 (a head's logits, 16384 x 163840,
# would take four 10.7 GB temporaries whole)
CHECK_CHUNK = 1 << 26


def _chunks(a, b):
    """fp32 copies of a's and b's flat elements, CHECK_CHUNK at a time
    (whole, as they broadcast, where their shapes differ)."""
    if a.shape != b.shape or a.numel() <= CHECK_CHUNK:
        if a.numel():
            yield a.float(), b.float()
        return
    a, b = a.reshape(-1), b.reshape(-1)
    for i in range(0, a.numel(), CHECK_CHUNK):
        yield a[i:i + CHECK_CHUNK].float(), b[i:i + CHECK_CHUNK].float()


def close(a, b, tol: float) -> float:
    """Max |a - b|; raises unless |a - b| <= tol + tol*|b| everywhere."""
    import torch
    err, ok = 0.0, True
    for x, y in _chunks(a, b):
        d = (x - y).abs()
        err = max(err, float(d.max()))
        ok = ok and bool(torch.isfinite(x).all()) and bool(
            (d <= tol + tol * y.abs()).all())
    if not ok:
        raise AssertionError(f"max abs err {err} beyond tolerance {tol}")
    return err


def kernel_bound_ms(n_bytes: float, n_ops: float,
                    peak: float = PEAK_BF16_FLOPS) -> tuple:
    """(bound in ms, "bytes" | "operations") at the data-sheet peaks."""
    b = n_bytes / HBM_BYTES_PER_S * 1e3
    f = n_ops / peak * 1e3
    return max(b, f), ("bytes" if b >= f else "operations")


@contextlib.contextmanager
def routed(targets, fns: dict):
    """Replace each ``(module, attr, key)`` of ``targets`` whose key is in
    ``fns`` by ``fns[key]`` inside the block."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, key in targets
             if key in fns]
    for mod, attr, key in targets:
        if key in fns:
            setattr(mod, attr, fns[key])
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def recording(targets, sink):
    """Route each ``(module, attr, key)`` of ``targets`` through a wrapper
    that calls ``sink(key, args, kw)`` and then the original function."""
    def wrap(fn, key):
        def call(*args, **kw):
            sink(key, args, kw)
            return fn(*args, **kw)
        return call
    return routed(targets, {key: wrap(getattr(mod, attr), key)
                            for mod, attr, key in targets})


@contextlib.contextmanager
def router_tape(moe_mod, tape: list, replay: bool = False):
    """Record each MoE router output (probs, gates, experts) of a run into
    ``tape``, or with ``replay`` hand them back in order instead of
    routing, so that a second run takes the first run's routing (and so
    its capacity drops) exactly."""
    orig, it = moe_mod._router, iter(list(tape))

    def router(*args, **kw):
        if replay:
            return next(it)
        out = orig(*args, **kw)
        tape.append(out)
        return out
    moe_mod._router = router
    try:
        yield
    finally:
        moe_mod._router = orig
    if replay and next(it, None) is not None:
        raise AssertionError("the replayed run routed fewer layers")


def rerouted(tape_a: list, tape_b: list) -> tuple:
    """(tokens whose expert set differs between two router tapes, tokens),
    summed over the MoE layers."""
    n = total = 0
    for (_, _, ia), (_, _, ib) in zip(tape_a, tape_b, strict=True):
        ia, ib = ia.sort(-1).values, ib.sort(-1).values
        n += int((ia != ib).any(-1).sum())
        total += ia[..., 0].numel()
    return n, total


def call_signature(key: str, args, kw) -> tuple:
    """What a kernel's launch depends on: shapes, strides, dtypes and the
    plain arguments (widths, causal), not the values."""
    import torch

    def one(a):
        if isinstance(a, torch.Tensor):
            return (tuple(a.shape), a.stride(), str(a.dtype))
        return a
    return (key, tuple(one(a) for a in args),
            tuple((k, one(v)) for k, v in sorted(kw.items())))


def lm_phases(dev, parent) -> dict:
    """Phases 8-13: the LM slice.  Returns what the kernels' record needs.
    ``parent``: the parent commit's kernels to time beside ours, or None."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import layers as layers_mod
    from repro_torch.core.layers import cast_params
    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import expert_matmul as xm
    from repro_torch.kernels import ops
    from repro_torch.launch import elastic_moe
    from repro_torch.launch.flops import lm_model_flops
    from repro_torch.launch.steps import lm_decode, lm_prefill
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import lm_apply, lm_init

    cfg = get_arch("deepseek-moe-16b").make_config()
    d, Fe, E = cfg.d_model, cfg.moe.d_ff, cfg.moe.n_experts
    H, Dh = cfg.n_heads, cfg.d_head
    points = elastic_moe.operating_points(cfg)
    out = {}
    dgen = torch.Generator(device=dev).manual_seed(8)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        # drawn on the card: the expert weights are 184 M values each
        return (torch.randn(shape, generator=dgen, device=dev)
                * scale).to(dtype)

    t0 = phase("8. K3 expert_matmul vs plain (d 2048, expert widths "
               "1408/1056/704, E 64/32; across its variants)")
    k3_err, k3_variants = 0.0, {}
    cnt_gen = torch.Generator().manual_seed(8)
    # the slab rows the dispatch gives K3: G groups x C' capacity slots
    T_pre = LM_BATCH * PREFILL_LEN
    g = min(cfg.moe.group_size, T_pre)
    slots = lambda g_: max(4, math.ceil(g_ * cfg.moe.top_k
                                        * cfg.moe.capacity_factor / E))
    C_pre, C_dec = T_pre // g * slots(g), slots(LM_BATCH)

    def k3_check(x, w, counts, tol) -> tuple:
        """(max abs err, the variant that ran) of one call against the
        plain version; raises unless exact zeros past every count."""
        before = dict(xm.variant_launches)
        y = ops.expert_matmul_op(x, w, counts)
        ran = [v for v, c in xm.variant_launches.items() if c != before[v]]
        with ops.plain_kernels():
            yp = ops.expert_matmul_op(x, w, counts)
        torch.cuda.synchronize()
        err = close(y, yp, tol)
        rows = torch.arange(x.shape[1], device=dev)[None, :] \
            >= counts[:, None]
        if not bool((y[rows] == 0).all()):
            raise AssertionError(f"K3 ({ran[0]}): non-zero past counts")
        k3_variants[ran[0]] = max(k3_variants.get(ran[0], 0.0), err)
        return err, ran[0]

    for dtype in (torch.float32, torch.bfloat16):
        tol = EXPERT_TOL[str(dtype).split(".")[1]]
        dt = str(dtype).split(".")[1]
        wi = randn(E, d, Fe, scale=d ** -0.5, dtype=dtype)
        wo = randn(E, Fe, d, scale=Fe ** -0.5, dtype=dtype)
        xs, bases = {}, {}
        for C, kind in ((C_pre, "prefill"), (C_dec, "decode")):
            x = xs[kind] = randn(E, C, d, dtype=dtype)
            if kind == "prefill":   # 0, partial tiles, the full C, ragged
                pattern = [0, 1, 37, 64, 65, 128, C - 40, C - 1, C, C]
                base = torch.tensor(pattern * E, dtype=torch.int32)[:E]
                base = base.clamp(0, C)
            else:   # top-k slots of each sequence, <= C per expert
                base = torch.zeros(E, dtype=torch.int32)
                n_live = LM_BATCH * cfg.moe.top_k
                live = torch.randperm(E, generator=cnt_gen)[:n_live // 2]
                base[live] = 2
            bases[kind] = base.to(dev)
            for n_exp in (E, E // 2):
                counts = base[:n_exp].to(dev)
                for a_ff in (Fe, 3 * Fe // 4, Fe // 2):
                    hid = randn(n_exp, C, a_ff, dtype=dtype)
                    e_up, v_up = k3_check(x[:n_exp], wi[:n_exp, :, :a_ff],
                                          counts, tol)
                    e_dn, v_dn = k3_check(hid, wo[:n_exp, :a_ff], counts,
                                          tol)
                    err = max(e_up, e_dn)
                    k3_err = max(k3_err, err)
                    log(f"  {dt:8s} {kind:7s} C={C:3d} E={n_exp} "
                        f"F={a_ff:4d} live rows {int(counts.sum()):5d}  "
                        f"{v_up}/{v_dn} max abs err {err:.3g} (tol {tol})")
        # across the variants: the stream | tma boundary, one expert, no
        # rows and all rows, the dense oracle's stride-0 expert axis, NaN
        # in x past every count (which must not reach the output); the
        # down product at a_ff 704 (not a multiple of 128)
        cases = []
        for C in (16, 17):
            c = torch.tensor([0, 1, C - 1, C] * (E // 4),
                             dtype=torch.int32, device=dev)
            cases += [(f"C={C} up", randn(E, C, d, dtype=dtype), wi, c),
                      (f"C={C} down a_ff 704",
                       randn(E, C, Fe // 2, dtype=dtype),
                       wo[:, :Fe // 2], c)]
        for kind, x in xs.items():
            C = x.shape[1]
            cases += [
                (f"{kind} E=1", x[:1], wi[:1],
                 torch.tensor([C // 2 + 1], dtype=torch.int32, device=dev)),
                (f"{kind} counts all 0", x, wi,
                 torch.zeros(E, dtype=torch.int32, device=dev)),
                (f"{kind} counts all C", x, wi,
                 torch.full((E,), C, dtype=torch.int32, device=dev)),
                (f"{kind} stride-0 experts", x[:1].expand(E, C, d), wi,
                 torch.full((E,), C, dtype=torch.int32, device=dev)),
                (f"{kind} NaN past counts", x.masked_fill(
                    (torch.arange(C, device=dev)[None, :]
                     >= bases[kind][:, None])[..., None], float("nan")), wi,
                 bases[kind])]
        for label, x, w, c in cases:
            C = x.shape[1]
            want = ("stream" if C <= xm.STREAM_C_MAX else
                    "tile_f32" if dtype == torch.float32 else
                    "tile_bf16" if x.stride(0) == 0 else "tma")
            err, ran = k3_check(x, w, c, tol)
            if ran != want:
                raise AssertionError(f"K3 {label}: took {ran}, not {want}")
            k3_err = max(k3_err, err)
            log(f"  {dt:8s} {label:26s} C={C:3d} E={x.shape[0]:2d} "
                f"F={w.shape[2]:4d} {ran:9s} max abs err {err:.3g}")
        del wi, wo, xs, bases, cases
    if set(k3_variants) != set(xm.VARIANTS):
        raise AssertionError(f"not every K3 variant ran: "
                             f"{sorted(k3_variants)}")
    out["k3_err"] = k3_err
    log("  max abs err by variant: " + ", ".join(
        f"{v} {e:.3g}" for v, e in sorted(k3_variants.items())))
    # with a gradient wanted K3 runs inside an autograd Function whose
    # backward is K3's dgrad and wgrad kernels (phase 24 holds them at the
    # LM step's calls): one backward through it, against the plain route's
    c17 = torch.tensor([17, 0, 5] * (E // 3) + [17] * (E % 3),
                       dtype=torch.int32, device=dev)
    xw = (randn(E, 17, d, dtype=torch.bfloat16),
          randn(E, d, 64, scale=d ** -0.5, dtype=torch.bfloat16))
    gy = randn(E, 17, 64, dtype=torch.bfloat16)
    grads = []
    for plain in (False, True):
        ins = [t.detach().requires_grad_() for t in xw]
        before = ops.launch_counts()
        with ops.plain_kernels() if plain else contextlib.nullcontext():
            ops.expert_matmul_op(*ins, c17).backward(gy)
        torch.cuda.synchronize()
        ran = {k: ops.launch_counts()[k] - before[k]
               for k in ("expert_matmul_dgrad", "expert_matmul_wgrad")}
        if set(ran.values()) != {0 if plain else 1}:
            raise AssertionError(f"K3 backward launches {ran}")
        grads.append([t.grad for t in ins])
    k3_bwd_err = max(close(a, b, EXPERT_TOL["bfloat16"])
                     for a, b in zip(*grads))
    del xw, gy, grads
    log(f"  K3 max abs err {k3_err:.3g}; exact zeros past every count; a "
        f"backward through the kernel route launches K3's dgrad and wgrad "
        f"once each, max abs err {k3_bwd_err:.3g} from the plain route's "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = phase("9. K2 flash_attention at D = 128 vs plain (causal prefill "
               "S = T = 512; decode S = 1 over a strided 528-slot cache)")
    k2_err = 0.0
    T_cache = PREFILL_LEN + DECODE_STEPS
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        qkv = randn(LM_BATCH, PREFILL_LEN, 3 * H, Dh, scale=0.3, dtype=dtype)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:]
        ck = randn(LM_BATCH, T_cache, H, Dh, scale=0.3, dtype=dtype)
        cv = randn(LM_BATCH, T_cache, H, Dh, dtype=dtype)
        cases = [("prefill", q, k, v, True, PREFILL_LEN)] + [
            ("decode", q[:, :1], ck[:, :T], cv[:, :T], False, T)
            for T in (1, 300, T_cache)]
        for kind, qq, kk, vv, causal, T in cases:
            o = ops.flash_attention_op(qq, kk, vv, causal=causal)
            with ops.plain_kernels():
                o_p = ops.flash_attention_op(qq, kk, vv, causal=causal)
            torch.cuda.synchronize()
            err = close(o, o_p, tol)
            k2_err = max(k2_err, err)
            log(f"  {str(dtype):15s} {kind:7s} BH={LM_BATCH * H} "
                f"S={qq.shape[1]:3d} T={T:3d} D={Dh} causal={causal!s:5s} "
                f"max abs err {err:.3g} (tol {tol})")
    out["k2_err"] = k2_err
    log(f"  K2 (D 128) max abs err {k2_err:.3g} "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = phase("10. full-width LM logits (depth 2: dense + 1 MoE layer), "
               "kernel path vs plain path")
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    p32 = lm_init(torch.Generator(device=dev).manual_seed(10), cfg2,
                  device=dev, dtype=torch.float32)
    p16 = cast_params(p32, torch.bfloat16)
    cfg16 = dataclasses.replace(cfg2, compute_dtype="bfloat16")
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(11))
    with torch.inference_mode():
        for name, E_, _ in points:
            yk = lm_apply(p32, toks, cfg2, E=E_)[0]
            with ops.plain_kernels():
                yp = lm_apply(p32, toks, cfg2, E=E_)[0]
            err32 = close(yk, yp, LM_LOGITS_FP32_TOL)
            tape_k, tape_p = [], []
            with router_tape(moe_mod, tape_k):
                yk16 = lm_apply(p16, toks, cfg16, E=E_)[0]
            with ops.plain_kernels(), router_tape(moe_mod, tape_p):
                yp16 = lm_apply(p16, toks, cfg16, E=E_)[0]
            # the kernel path again, on the plain path's routing
            with router_tape(moe_mod, tape_p, replay=True):
                yq16 = lm_apply(p16, toks, cfg16, E=E_)[0]
            if not (torch.isfinite(yk16).all() and torch.isfinite(yq16).all()):
                raise AssertionError("non-finite bf16 LM logits")
            err16 = float((yk16.float() - yp16.float()).abs().max())
            top1 = float((yk16.argmax(-1) == yp16.argmax(-1)).float().mean())
            pin = float((yq16.float() - yp16.float()).abs().max())
            top1_pin = float((yq16.argmax(-1) == yp16.argmax(-1))
                             .float().mean())
            n_re, n_tok = rerouted(tape_k, tape_p)
            if pin > LM_LOGITS_BF16_PINNED_TOL:
                raise AssertionError(
                    f"{name}: bf16 logits on the same routing differ by "
                    f"{pin} > {LM_LOGITS_BF16_PINNED_TOL}")
            log(f"  {name:24s} fp32 max abs err {err32:.3g} (tol "
                f"{LM_LOGITS_FP32_TOL}); bf16 max abs err {err16:.3g}, "
                f"top-1 {top1:.3f}, {n_re}/{n_tok} tokens routed "
                f"differently; same routing: {pin:.3g} (tol "
                f"{LM_LOGITS_BF16_PINNED_TOL}), top-1 {top1_pin:.3f}")
    del p32, p16, yk, yp, yk16, yp16, yq16, tape_k, tape_p
    torch.cuda.empty_cache()
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    t0 = phase("11. LM main path: deepseek-moe-16b, full width and depth, "
               "bf16 on the card; prefill 4 x 512, 16 decode steps")
    torch.cuda.reset_peak_memory_stats(dev)
    t_init = time.perf_counter()
    params = lm_init(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev, dtype=cfg.cdtype())
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"  {n_params / 1e9:.2f} B parameters initialised on the card in "
        f"{time.perf_counter() - t_init:.1f} s; "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB allocated")
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, T_cache),
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    prompt = tokens[:, :PREFILL_LEN]
    ops.reset_launch_counts()
    # on the card run() captures each point's prefill and decode step as
    # CUDA graphs and times their replays
    rows = elastic_moe.run(params, cfg, tokens, PREFILL_LEN, iters=2)
    out["launches"] = ops.launch_counts()
    out["variants"] = ops.variant_counts()
    out["graph_rows"] = rows
    out["graph_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    full_flops = lm_model_flops(cfg, "prefill", LM_BATCH, PREFILL_LEN)
    for r in rows:
        if r["logits"].shape != (LM_BATCH, cfg.vocab_size) or \
                not torch.isfinite(r["logits"]).all() or \
                not torch.isfinite(r.get("decode_logits", r["logits"])).all():
            raise AssertionError(f"{r['name']}: bad logits")
        if min(r["prefill_launches"][k] for k in FORWARD) <= 0 or (
                "decode_launches" in r
                and min(r["decode_launches"][k] for k in FORWARD) <= 0):
            raise AssertionError(f"{r['name']}: a kernel was not launched: "
                                 f"prefill {r['prefill_launches']}, decode "
                                 f"{r.get('decode_launches')}")
        bound = r["rel_flops"] * full_flops / PEAK_BF16_FLOPS * 1e3
        line = (f"  {r['name']:24s} prefill {r['prefill_ms']:8.1f} ms "
                f"{r['prefill_tok_s']:8.0f} tok/s  rel flops "
                f"{r['rel_flops']:.2f} (model-FLOPs bound {bound:.1f} ms, "
                f"{bound / r['prefill_ms']:.1%} of the bf16 peak)")
        line += (f"; decode {r['decode_ms']:7.2f} ms/step "
                 f"{r['decode_tok_s']:7.1f} tok/s" if "decode_ms" in r
                 else "; decode n/a (sliced depth: fault F4)")
        log(line)
    if not any("decode_ms" in r for r in rows):
        raise AssertionError("no operating point decoded")
    log(f"  launches on the LM main path: {out['launches']}; at "
        f"{rows[0]['name']}: prefill {rows[0]['prefill_launches']} (3 "
        f"forwards), decode {rows[0]['decode_launches']} "
        f"({DECODE_STEPS} steps)")
    log(f"  by variant: {out['variants']}")
    main_path_variants(out["variants"], need={
        ("elastic_matmul", "small_m"), ("elastic_matmul", "tma"),
        ("elastic_matmul", "f32_splitk"),
        ("flash_attention", "wgmma"), ("flash_attention", "decode"),
        ("expert_matmul", "tma"), ("expert_matmul", "stream")})
    # the fp32 router: f32_splitk at prefill, small_m at decode (M = 4),
    # never the tile loop
    if out["variants"]["elastic_matmul"]["tile_f32"]:
        raise AssertionError(f"fp32 router calls took tile_f32: "
                             f"{out['variants']['elastic_matmul']}")
    # K3's launches by variant in each stage of this run: bf16 prefill on
    # tma, decode on stream (the timed replays; a capture's eager warm-up
    # counts in the totals above, not here)
    out["k3_by_stage"] = {
        stage: {v: sum(r[f"{stage}_variants"]["expert_matmul"][v]
                       for r in rows if f"{stage}_variants" in r)
                for v in xm.VARIANTS} for stage in ("prefill", "decode")}
    log(f"  K3 launches by variant: prefill {out['k3_by_stage']['prefill']}"
        f", decode {out['k3_by_stage']['decode']}")
    k3_on_stage(out["k3_by_stage"])
    # one decode step, kernel path against plain path, from one state; then
    # the kernel path again on the plain path's routing
    step = tokens[:, PREFILL_LEN:PREFILL_LEN + 1]
    with torch.inference_mode():
        _, caches = lm_prefill(params, prompt, cfg, max_len=T_cache)
        twin, pinned = ({k: [{"k": c["k"].clone(), "v": c["v"].clone(),
                              "len": c["len"].clone(), "fill": c["fill"]}
                             for c in v]
                         for k, v in caches.items()} for _ in range(2))
        tape_k, tape_p = [], []
        with router_tape(moe_mod, tape_k):
            lk, _ = lm_decode(params, caches, step, cfg)
        with ops.plain_kernels(), router_tape(moe_mod, tape_p):
            lp, _ = lm_decode(params, twin, step, cfg)
        with router_tape(moe_mod, tape_p, replay=True):
            lq, _ = lm_decode(params, pinned, step, cfg)
        err16 = float((lk.float() - lp.float()).abs().max())
        top1 = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
        pin = float((lq.float() - lp.float()).abs().max())
        top1_pin = float((lq.argmax(-1) == lp.argmax(-1)).float().mean())
        n_re, n_tok = rerouted(tape_k, tape_p)
    if not torch.isfinite(lq).all():
        raise AssertionError("non-finite decode logits")
    del caches, twin, pinned, tape_k, tape_p
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  one decode step (full), kernel vs plain path, bf16: max abs err "
        f"{err16:.3g}, top-1 agreement {top1:.2f}, {n_re}/{n_tok} "
        f"(token, layer) pairs routed differently; on the plain path's "
        f"routing: max abs err {pin:.3g}, top-1 agreement {top1_pin:.2f}")
    out["decode_step"] = {"max_abs_err": err16, "top1": top1,
                          "rerouted": [n_re, n_tok], "pinned_err": pin,
                          "pinned_top1": top1_pin}
    log(f"  peak device memory {peak / 2**30:.2f} GiB "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = phase("12. K1, K2 and K3 vs plain at the main path's own calls "
               "(a prefill and one decode step at each point; recorded "
               "dtype and fp32); capacity drops")
    targets = [(layers_mod, "elastic_matmul_op", "k1"),
               (layers_mod, "flash_attention_op", "k2"),
               (moe_mod, "expert_matmul_op", "k3")]
    kernel_fn = {key: getattr(mod, attr) for mod, attr, key in targets}
    distinct, k3_counts, stage = {}, {}, [None]

    def keep(key, args, kw):
        distinct.setdefault(call_signature(key, args, kw), (key, args, kw))
        if key == "k3":      # one counts tensor per MoE layer (3 calls)
            k3_counts.setdefault(stage[0], {})[id(args[2])] = \
                (args[2], args[0].shape[1])

    # K3's launches by variant in each stage of this pass (as phase 11)
    k3_stage = {"prefill": dict.fromkeys(xm.VARIANTS, 0),
                "decode": dict.fromkeys(xm.VARIANTS, 0)}

    @contextlib.contextmanager
    def k3_launches(kind):
        before = dict(xm.variant_launches)
        yield
        for v, n in xm.variant_launches.items():
            k3_stage[kind][v] += n - before[v]

    with torch.inference_mode(), recording(targets, keep):
        for name, E_, decodable in points:
            stage[0] = (name, "prefill")
            with k3_launches("prefill"):
                if not decodable:
                    lm_prefill(params, prompt, cfg, E=E_)
                    continue
                _, caches = lm_prefill(params, prompt, cfg, E=E_,
                                       max_len=T_cache)
            stage[0] = (name, "decode")
            with k3_launches("decode"):
                lm_decode(params, caches, step, cfg, E=E_)
            del caches
    log(f"  K3 launches by variant: prefill {k3_stage['prefill']}, decode "
        f"{k3_stage['decode']}")
    k3_on_stage(k3_stage)
    tols = {"k1": TOL, "k2": ATTN_TOL, "k3": EXPERT_TOL}
    worst = {}
    for key, args, kw in distinct.values():
        errs = []
        for dt in dict.fromkeys((args[0].dtype, torch.float32)):
            a = [t.to(dt) if torch.is_tensor(t) and t.is_floating_point()
                 else t for t in args]
            y = kernel_fn[key](*a, **kw)
            with ops.plain_kernels():
                yp = kernel_fn[key](*a, **kw)
            err = close(y, yp, tols[key][str(dt).split(".")[1]])
            if key == "k3" and not bool(
                    (y[torch.arange(y.shape[1], device=dev)[None, :]
                       >= a[2][:, None]] == 0).all()):
                raise AssertionError("K3: non-zero past counts")
            worst[key, dt] = max(worst.get((key, dt), 0.0), err)
            errs.append(f"{str(dt).split('.')[1]} {err:.3g}")
        x, w = args[0], args[1]
        if key == "k1":
            what = (f"M={x.numel() // x.shape[-1]:4d} k={args[2]:5d} "
                    f"n={args[3]:6d} w={tuple(w.shape)}")
        elif key == "k2":
            what = (f"B={x.shape[0]} S={x.shape[1]} T={w.shape[1]} "
                    f"H={x.shape[2]} D={x.shape[3]} causal={kw['causal']}")
            if kw.get("kv_len") is not None:
                what += f" valid keys {host_len(kw['kv_len'])}"
        else:
            what = (f"E={x.shape[0]} C={x.shape[1]} K={x.shape[2]} "
                    f"F={w.shape[2]} live rows {int(args[2].sum())}")
        log(f"  {key.upper()} {what}: {', '.join(errs)}")
    log("  max abs err: " + ", ".join(
        f"{k.upper()} {str(dt).split('.')[1]} {e:.3g} (tol "
        f"{tols[k][str(dt).split('.')[1]]})"
        for (k, dt), e in sorted(worst.items(), key=str)))
    # the fp32 router's calls: each on the variant its M gives (f32_splitk
    # at prefill, small_m at decode); the f32_splitk ones the same bits
    # twice and under 3 CUDA-graph replays
    router, r_err = {}, 0.0
    for key, args, kw in distinct.values():
        if key != "k1" or args[0].dtype != torch.float32:
            continue
        x, w = args[0], args[1]
        M = x.numel() // x.shape[-1]
        n_out = kw.get("n_out", w.shape[-1])
        want_v = "small_m" if M <= em.SMALL_M_MAX else "f32_splitk"
        before = em.variant_launches[want_v]
        fn = (lambda a=args, k=kw, n=n_out:
              kernel_fn["k1"](*a, **k).reshape(-1, n))
        if want_v == "f32_splitk":
            r_err = max(r_err, repeatable(
                fn, k1_plain(*args, **kw), TOL["float32"],
                f"router M={M} n_act={args[3]}"))
            ran = em.variant_launches[want_v] - before == 3
        else:
            fn()
            ran = em.variant_launches[want_v] - before == 1
        if not ran:
            raise AssertionError(f"router M={M}: not on {want_v}")
        router[(M, args[3], want_v)] = router.get((M, args[3], want_v),
                                                  0) + 1
    if not any(v == "f32_splitk" for _, _, v in router):
        raise AssertionError("no fp32 router call at prefill recorded")
    log(f"  fp32 router calls (M, n_act, variant): {sorted(router)}; the "
        f"f32_splitk ones bit for bit twice and under 3 graph replays, max "
        f"abs err {r_err:.3g} (tol {TOL['float32']})")
    out["main_path_calls"] = {
        "distinct": len(distinct),
        "max_abs_err": {f"{k}_{str(dt).split('.')[1]}": e
                        for (k, dt), e in worst.items()}}
    del distinct
    # capacity drops: kept slots of the T * top_k routed ones, per layer
    out["kept"] = {}
    knobs = {name: E_ for name, E_, _ in points}
    for (name, st), per_layer in k3_counts.items():
        E_ = knobs[name]
        cs = torch.stack([c.long() for c, _ in per_layer.values()])
        C = next(iter(per_layer.values()))[1]
        routed = LM_BATCH * (PREFILL_LEN if st == "prefill" else 1) \
            * E_.get("top_k", cfg.moe.top_k)
        share = cs.sum(1).double() / routed
        live = cs[cs > 0].double()
        out["kept"][f"{name} {st}"] = float(share.mean())
        log(f"  {name:24s} {st:7s} kept {float(share.mean()):.1%} of "
            f"{routed} routed slots a layer (layers "
            f"{float(share.min()):.1%}-{float(share.max()):.1%}); rows per "
            f"live expert mean {float(live.mean()):.1f}, max "
            f"{int(cs.max())} of C {C}; experts live "
            f"{float((cs > 0).double().mean()):.1%}")
    del k3_counts
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    t0 = phase("13. LM kernel times (bf16; graph-replayed device time): "
               "K1, K2 and K3 over the calls of one prefill forward and of "
               "one decode step")
    calls = {"k1": [], "k2": [], "k3": []}
    with torch.inference_mode(), recording(
            targets, lambda key, args, kw: calls[key].append((args, kw))):
        _, caches = lm_prefill(params, prompt, cfg, max_len=T_cache)
        n_pre = {k: len(v) for k, v in calls.items()}
        lm_decode(params, caches, step, cfg)
    del caches     # the recorded decode calls keep their cache views
    kinds = {
        "k1": (kernel_fn["k1"], k1_plain, k1_library, "torch.matmul",
               k1_work),
        "k2": (kernel_fn["k2"], k2_plain, k2_library, "sdpa", k2_work),
        "k3": (xm.expert_matmul, xm.expert_matmul_plain,
               lambda x, w, c: torch.bmm(x, w), "torch.bmm", k3_work),
    }
    for key, (kern, plain, lib, lib_name, work) in kinds.items():
        for label, batch in (("prefill", calls[key][:n_pre[key]]),
                             ("decode", calls[key][n_pre[key]:])):
            out[f"{key}_{label}"] = time_rows(
                f"{key.upper()} {label:7s}", batch, kern, plain, lib,
                lib_name, work, parent and (parent[key], parent["libs"]),
                group={"k1": k1_group, "k3": k3_group}.get(key))
    # the fp32 MoE router's calls of the prefill on their own (f32_splitk;
    # the parent's on the variant it had), torch.matmul in fp32, TF32 off
    out["k1_router"] = time_rows(
        "K1 router prefill (fp32)",
        [c for c in calls["k1"][:n_pre["k1"]]
         if c[0][0].dtype == torch.float32], *kinds["k1"],
        parent and (parent["k1"], parent["libs"]), group=k1_group)
    del calls
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    if parent:
        t0 = phase("14. end to end against the parent's kernels (full "
                   "point, bf16, wall time): prefill 4 x 512 and 16 decode "
                   f"steps, in turns parent, kernel, kernel, parent, "
                   f"{E2E_ROUNDS} times")
        out["e2e"] = end_to_end(
            params, cfg, tokens, targets,
            {k: parent[k] for k in ("k1", "k2", "k3")}, parent["libs"])
        log(f"  ({time.perf_counter() - t0:.1f} s)")
    out["compiled"] = lm_compiled(params, cfg, tokens, rows,
                                  out["graph_peak_gib"], dev)
    del params
    torch.cuda.empty_cache()
    return out


# phase 21: graph decode logits within this share of the largest eager
# logit (the same kernels in the same order: bf16 noise at most)
GRAPH_DECODE_REL_TOL = 2e-2


def lm_compiled(params, cfg, tokens, graph_rows, graph_peak, dev) -> dict:
    """Phase 21, the LM's half: K2 decode through the device length at
    fills 1, mid and capacity (eager and under graph replays), then
    ``elastic_moe.run`` eager beside phase 11's graph run."""
    import torch

    from repro_torch.graphs import Graph, new_pool
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import elastic_moe

    t0 = phase("21. compiled executables, the LM: K2 decode with the fill "
               "on the device; prefill and decode step eager against CUDA "
               "graphs at every point")
    out = {}
    B, total = tokens.shape
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = torch.Generator(device=dev).manual_seed(21)
    q = (torch.randn(B, 1, H, D, generator=g, device=dev) * 0.3
         ).to(torch.bfloat16)
    ck = (torch.randn(B, total, KH, D, generator=g, device=dev) * 0.3
          ).to(torch.bfloat16)
    cv = torch.randn(B, total, KH, D, generator=g, device=dev
                     ).to(torch.bfloat16)
    n = torch.full((), 1, dtype=torch.int32, device=dev)
    fills = (1, total // 2, total)
    splits, chunk = fa.decode_plan(total, B * KH * fa.decode_groups(H, KH))

    def plain(fill):
        with ops.plain_kernels():
            return ops.flash_attention_op(q, ck[:, :fill], cv[:, :fill],
                                          causal=False)
    errs, dev_ms = {}, {}
    with torch.inference_mode():
        graph = Graph(lambda t: ops.flash_attention_op(
            q, ck, cv, causal=False, kv_len=t), [n], pool=new_pool(),
            stream=torch.cuda.Stream(dev))
        for fill in fills:
            n.fill_(fill)
            before = fa.variant_launches["decode"]
            o = ops.flash_attention_op(q, ck, cv, causal=False, kv_len=n)
            if fa.variant_launches["decode"] != before + 1:
                raise AssertionError("K2 with a device length left decode")
            want = plain(fill)
            err = close(o, want, ATTN_TOL["bfloat16"])
            o_g = graph.run(torch.full((), fill, dtype=torch.int32,
                                       device=dev))
            err = max(err, close(o_g, want, ATTN_TOL["bfloat16"]))
            errs[fill] = err
            start, end = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            with graph.lock:
                graph.replay()                      # warm
                start.record()
                for _ in range(20):
                    graph.replay()
                end.record()
            torch.cuda.synchronize()
            dev_ms[fill] = start.elapsed_time(end) / 20
    del graph
    log(f"  K2 decode over the whole {total}-slot cache (B {B}, H {H}, D "
        f"{D}; plan from capacity: {splits} splits of {chunk} keys): "
        + ", ".join(f"fill {f}: max abs err {errs[f]:.3g}, device "
                    f"{dev_ms[f] * 1e3:.2f} us a call (graph)"
                    for f in fills)
        + f" (tol {ATTN_TOL['bfloat16']}; eager and graph replay)")
    out["k2_decode"] = {"fills": list(fills), "max_abs_err": errs,
                        "device_us": {f: dev_ms[f] * 1e3 for f in fills},
                        "splits": splits, "chunk": chunk}
    del q, ck, cv

    torch.cuda.reset_peak_memory_stats(dev)
    eager_rows = elastic_moe.run(params, cfg, tokens, PREFILL_LEN, iters=2,
                                 graphs=False)
    eager_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    pool = graph_rows[-1].get("graph_pool_bytes")
    rows = []
    for eg, gr in zip(eager_rows, graph_rows, strict=True):
        row = {"point": gr["name"]}
        for kind in ("prefill", "decode"):
            if f"{kind}_ms" in gr:
                row[kind] = {"eager_ms": eg[f"{kind}_ms"],
                             "eager_event_ms": eg[f"{kind}_event_ms"],
                             "graph_ms": gr[f"{kind}_ms"],
                             "graph_event_ms": gr[f"{kind}_event_ms"]}
        if "decode_logits" in gr:
            ref = eg["decode_logits"].float()
            rel = float((gr["decode_logits"].float() - ref).abs().max()
                        / ref.abs().max())
            row["decode_rel_err"] = rel
            if not torch.isfinite(gr["decode_logits"]).all() or \
                    rel > GRAPH_DECODE_REL_TOL:
                raise AssertionError(
                    f"{gr['name']}: {DECODE_STEPS} graph decode steps "
                    f"differ from eager by {rel:.3g} of the largest logit "
                    f"(tol {GRAPH_DECODE_REL_TOL})")
        rows.append(row)
        line = f"  {gr['name']:24s}"
        for kind in ("prefill", "decode"):
            if kind in row:
                r = row[kind]
                line += (f" {kind} eager {r['eager_ms']:7.2f} ms (events "
                         f"{r['eager_event_ms']:7.2f}), graph "
                         f"{r['graph_ms']:7.2f} ms (device "
                         f"{r['graph_event_ms']:7.2f});")
        if "decode_rel_err" in row:
            line += (f" {DECODE_STEPS} graph steps vs eager: max abs err "
                     f"{row['decode_rel_err']:.3g} of the largest logit")
        else:
            line += " decode n/a (F4)"
        log(line)
    out.update(rows=rows, eager_peak_gib=eager_peak,
               graph_peak_gib=graph_peak,
               graph_pool_gib=None if pool is None else pool / 2**30)
    log(f"  peak device memory (weights included): eager run "
        f"{eager_peak:.2f} GiB, graph run (phase 11, captures included) "
        f"{graph_peak:.2f} GiB; the LM's graph pool "
        f"{'not measured' if pool is None else f'{pool / 2**30:.2f} GiB'}"
        f" ({time.perf_counter() - t0:.1f} s)")
    return out


def end_to_end(params, cfg, tokens, targets, parent_ops: dict,
               parent_libs) -> dict:
    """Wall time of the full point's prefill (mean of 2 after a warm-up)
    and decode step (mean of the 16 teacher-forced steps after a prefill)
    as ``repro_torch.launch.elastic_moe.run`` times them, eagerly on this
    tree's kernels and on the parent's (its ops routed in at
    ``targets``), in turns parent, kernel, kernel, parent, ``E2E_ROUNDS``
    times; then twice on this tree's kernels as graph replays; the mean
    and the median of each."""
    import torch

    from repro_torch.launch import elastic_moe
    from repro_torch.launch.steps import LMGraphs, lm_decode, lm_prefill
    dev = tokens.device
    prompt = tokens[:, :PREFILL_LEN]

    def once():
        pre_ms, _ = elastic_moe.timed(lambda: lm_prefill(params, prompt, cfg),
                                      dev, 2)
        _, caches = lm_prefill(params, prompt, cfg, max_len=tokens.shape[1])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(PREFILL_LEN, tokens.shape[1]):
            _, caches = lm_decode(params, caches, tokens[:, t:t + 1], cfg)
        torch.cuda.synchronize()
        return pre_ms, (time.perf_counter() - t1) / DECODE_STEPS * 1e3

    runs = {"parent": [], "kernel": []}
    with torch.inference_mode():
        for who in ("parent", "kernel", "kernel", "parent") * E2E_ROUNDS:
            if who == "parent":
                with parent_libs(), routed(targets, parent_ops):
                    runs[who].append(once())
            else:
                runs[who].append(once())
    # this tree's full point as graph replays (phase 11's way), after
    with torch.inference_mode():
        lm = LMGraphs(params, cfg, tokens.shape[0], PREFILL_LEN,
                      tokens.shape[1], dev)
        lm.capture()

        def graphed():
            pre_ms, _ = elastic_moe.timed(lambda: lm.prefill(prompt), dev, 2)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for t in range(PREFILL_LEN, tokens.shape[1]):
                lm.decode(tokens[:, t:t + 1])
            torch.cuda.synchronize()
            return pre_ms, (time.perf_counter() - t1) / DECODE_STEPS * 1e3
        runs["kernel, graphs"] = [graphed() for _ in range(2)]
        del lm
    res = {}
    for who, rs in runs.items():
        pre, dec = [r[0] for r in rs], [r[1] for r in rs]
        res[who] = {"prefill_ms": sum(pre) / len(pre),
                    "decode_ms": sum(dec) / len(dec),
                    "prefill_median_ms": statistics.median(pre),
                    "decode_median_ms": statistics.median(dec),
                    "prefill_runs": pre, "decode_runs": dec}
        log(f"  {who:14s} prefill {res[who]['prefill_ms']:.2f} ms (median "
            f"{res[who]['prefill_median_ms']:.2f}; runs "
            f"{', '.join(f'{t:.2f}' for t in pre)}); decode "
            f"{res[who]['decode_ms']:.2f} ms/step (median "
            f"{res[who]['decode_median_ms']:.2f}; runs "
            f"{', '.join(f'{t:.2f}' for t in dec)})")
    return res


# the training slice: K1's dgrad and wgrad, K2's backward (recorded calls
# are (args, kw) of the wrappers in kernels/elastic_matmul.py and
# kernels/flash_attention.py)

def k1_dgrad_work(args, kw) -> tuple:
    import torch
    dy, w, _, k_act, n_act, kx = args
    M = dy.shape[0]
    peak = PEAK_BF16_FLOPS if dy.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return (dy.element_size() * (M * n_act + k_act * n_act + M * kx),
            2 * M * k_act * n_act, peak)


def k1_wgrad_work(args, kw) -> tuple:
    import torch
    x, dy, _, k_act, n_act, w_shape = args
    M = x.shape[0]
    peak = PEAK_BF16_FLOPS if x.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return (x.element_size() * (M * k_act + M * n_act
                                + w_shape[0] * w_shape[1]),
            2 * M * k_act * n_act, peak)


def k2_bwd_work(args, kw) -> tuple:
    """q, o, dO and k, v read, the fp32 logsumexp read, dq, dk, dv
    written; five products of 2 D a (query, key) pair a head (S = QK^T
    recomputed, dP, dV, dQ, dK), over the pairs the causal mask keeps."""
    q, k, *_ = args
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    e = q.element_size()
    pairs = sum(min(T, s + 1) for s in range(S)) if kw.get("causal") \
        else S * T
    return (e * (4 * B * S * H * D + 4 * B * T * KH * D) + 4 * B * H * S,
            10 * B * H * pairs * D, PEAK_BF16_FLOPS)


def k1_dgrad_plain(dy, w, widths, k_act, n_act, kx):
    from repro_torch.kernels import elastic_matmul as em
    return em.elastic_matmul_dgrad_plain(dy, w, k_act, n_act, kx)


def k1_dgrad_library(dy, w, widths, k_act, n_act, kx):
    """The yardstick: one torch.matmul on the active block."""
    import torch
    return torch.matmul(dy[:, :n_act], w[:k_act, :n_act].T)


def k1_wgrad_plain(x, dy, widths, k_act, n_act, w_shape):
    from repro_torch.kernels import elastic_matmul as em
    return em.elastic_matmul_wgrad_plain(x, dy, k_act, n_act, w_shape)


def k1_wgrad_library(x, dy, widths, k_act, n_act, w_shape):
    """The yardstick: one torch.matmul on the active block."""
    import torch
    return torch.matmul(x[:, :k_act].T, dy[:, :n_act])


def k2_bwd_kernel(q, k, v, o, lse, do, causal=False):
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)


def k2_bwd_plain(q, k, v, o, lse, do, causal=False):
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention_bwd_plain(q, k, v, o, do, causal=causal)


class SdpaBackward:
    """The yardstick for K2's backward: autograd's backward of
    F.scaled_dot_product_attention on the same q, k, v and dO (the
    forward run once per distinct call, outside the timing)."""

    def __init__(self):
        self.graphs = {}

    def __call__(self, q, k, v, o, lse, do, causal=False):
        import torch
        import torch.nn.functional as F
        key = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr())
        if key not in self.graphs:
            with torch.enable_grad():
                ins = [t.transpose(1, 2).detach().requires_grad_()
                       for t in (q, k, v)]
                out = F.scaled_dot_product_attention(
                    *ins, is_causal=causal,
                    enable_gqa=k.shape[2] != q.shape[2])
            self.graphs[key] = (out, ins, do.transpose(1, 2))
        out, ins, g = self.graphs[key]
        return torch.autograd.grad(out, ins, g, retain_graph=True)


# kernel-name fragments -> the row of the step's device-time breakdown
STEP_GROUPS = (("dgrad", "K1 dgrad"), ("wgrad", "K1 wgrad"),
               ("flash_attention_bwd", "K2 backward"),
               ("flash_attention", "K2 forward"),
               ("gemm_tma", "K1 forward"), ("small_m", "K1 forward"),
               ("elastic_matmul", "K1 forward"))


class NoTrace(Exception):
    """torch.profiler could not trace the card."""


def step_breakdown(fn, groups=STEP_GROUPS, warmup: bool = True) -> dict:
    """Device time of one call of fn() (a training step) by kernel, from a
    torch.profiler trace: {"wall_ms", "device_ms", "groups": {row: ms},
    "other_top": [(kernel, ms, calls)]}, each kernel in the row of the
    first of ``groups`` (name fragment, row) whose fragment its name
    holds; fn() runs once before, unless ``warmup`` is False (a step the
    process has already run).  Raises NoTrace if the profiler fails or its
    trace holds no device time; what fn() raises propagates (a kernel's
    failed launch is a failure, not a missing trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        raise NoTrace(f"the profiler did not start: {e}") from e
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    except BaseException:
        prof.stop()
        raise
    try:
        prof.stop()
        # the trace's raw events: the device ones are read directly, not
        # through torch's FunctionEvent tree over every host op (which
        # took about a minute a step of ~100k launches)
        events = prof.profiler.kineto_results.events()
    except RuntimeError as e:
        raise NoTrace(f"the profiler gave no trace: {e}") from e
    kernels = {}     # kernel name -> (ms, launches): the device events only
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            ms, n = kernels.get(e.name(), (0.0, 0))
            kernels[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    if not kernels:
        raise NoTrace("the profiler recorded no device time")
    rows, other, top = {}, [], {}
    for name, (ms, n) in kernels.items():
        row = next((g for frag, g in groups if frag in name), None)
        if row is None:
            other.append((name[:80], ms, n))
        else:
            rows[row] = rows.get(row, 0.0) + ms
            top.setdefault(row, []).append((name[:80], ms, n))
    rows["other kernels"] = sum(ms for _, ms, _ in other)
    return {"wall_ms": wall * 1e3, "device_ms": sum(rows.values()),
            "groups": rows,
            "other_top": sorted(other, key=lambda r: -r[1])[:8],
            "group_top": {row: sorted(ks, key=lambda r: -r[1])[:4]
                          for row, ks in top.items()}}


def expand(distinct: dict) -> list:
    """Recorded distinct calls {signature: [args, kw, count]} -> the step's
    call list (each distinct call repeated as often as the step made it,
    on its first call's inputs)."""
    return [(a, kw) for a, kw, n in distinct.values() for _ in range(n)]


def bwd_group(args, kw) -> str:
    """A K1 dgrad or wgrad call's shape and the variant it takes (with its
    tile or split plan), for the breakdown."""
    import torch

    from repro_torch.kernels import elastic_matmul as em
    a, b, _, k_act, n_act, last = args
    M = a.shape[0]
    variant = em._bwd_variant(a, b, k_act, n_act, None,
                              8 if isinstance(last, tuple) else last)
    if variant == "tma":
        variant += " {}x{}".format(*em.BWD_TMA_TILE)
        if isinstance(last, tuple):                           # wgrad
            variant += " splits {}x{}".format(
                *em.wgrad_tma_plan(M, k_act, n_act))
    dt = "bf16" if a.dtype == torch.bfloat16 else "fp32"
    return f"M={M} k={k_act} n={n_act} {dt} {variant}"


def step_wall(step, parent, rounds: int = 2, steps: int = 3) -> dict:
    """Wall time of one sandwich step (``step()`` then a synchronise), on
    this tree's kernels and on the parent's (K1's backward routed to the
    parent's ops, its libraries served in the build's place), in turns
    parent, kernel, kernel, parent, ``rounds`` times; each turn one
    warm-up step and ``steps`` timed ones.  The mean and median of each."""
    import torch

    from repro_torch.kernels import elastic_matmul as em
    targets = [(em, "elastic_matmul_dgrad", "k1_dgrad"),
               (em, "elastic_matmul_wgrad", "k1_wgrad")]

    def turn():
        step()
        torch.cuda.synchronize()
        ts = []
        for _ in range(steps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return ts
    runs = {"parent": [], "kernel": []}
    for who in ("parent", "kernel", "kernel", "parent") * rounds:
        if who == "parent":
            with parent["libs"](), routed(targets, parent):
                runs[who] += turn()
        else:
            runs[who] += turn()
    res = {}
    for who, ts in runs.items():
        res[who] = {"step_ms": sum(ts) / len(ts),
                    "step_median_ms": statistics.median(ts), "runs": ts}
        log(f"  {who:6s} sandwich step {res[who]['step_ms']:.1f} ms (median "
            f"{res[who]['step_median_ms']:.1f}; runs "
            f"{', '.join(f'{t:.1f}' for t in ts)})")
    return res


def train_phases(dev, parent) -> dict:
    """Phases 15-19: the training slice (sandwich-rule supernet training of
    the full-width Dynamic-OFA ViT).  Returns what the kernels' record
    needs.  ``parent``: the parent commit's kernels to time beside ours,
    or None."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import layers as layers_mod
    from repro_torch.core.supernet import (make_sandwich_step,
                                           sandwich_backward)
    from repro_torch.data import synthetic_image_batches, to_device
    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models.vit import vit_apply, vit_init
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.api import named_leaves, pop_grads

    arch = get_arch("dynamic-ofa-supernet")
    cfg = arch.make_config()
    B = arch.shape("cls_224").global_batch
    dims = {"d_model": cfg.d_model, "d_ff": cfg.d_ff,
            "n_heads": cfg.n_heads, "n_layers": cfg.n_layers}
    out = {}

    t0 = phase(f"15. training main path: repro_torch.launch.train --arch "
               f"dynamic-ofa-supernet --sandwich, full width, batch {B}, "
               f"bf16; 8 steps, a checkpoint every 4, a failure injected at "
               f"step 6")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)   # earlier phases' leftovers
    ops.reset_launch_counts()
    res = train_mod.main(["--arch", "dynamic-ofa-supernet", "--sandwich",
                          "--steps", "8", "--save-every", "4", "--fail-at",
                          "6", "--ckpt-dir", ckpt, "--log-every", "1",
                          "--device", "cuda"])
    torch.cuda.synchronize()
    out["launches"] = ops.launch_counts()
    out["variants"] = ops.variant_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    shutil.rmtree(ckpt, ignore_errors=True)
    if res["restarts"] != 1:
        raise AssertionError(f"{res['restarts']} restarts, want exactly the "
                             f"injected one")
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"non-finite losses {res['losses']}")
    for _, p in named_leaves(res["params"]):
        if not torch.isfinite(p).all():
            raise AssertionError("non-finite parameters after training")
    need = ("elastic_matmul", "elastic_matmul_dgrad", "elastic_matmul_wgrad",
            "flash_attention", "flash_attention_bwd")
    idle = [k for k in need if out["launches"][k] <= 0]
    if idle:
        raise AssertionError(f"kernels not launched while training: {idle}")
    main_path_variants(out["variants"], need={
        ("elastic_matmul", "tma"), ("flash_attention", "wgmma"),
        ("elastic_matmul_dgrad", "tma"),
        ("elastic_matmul_wgrad", "tma"),
        ("flash_attention_bwd", "resident")})
    # every bf16 K2 backward of the sandwich step (S = T = 197) on resident
    if out["variants"]["flash_attention_bwd"]["wgmma"]:
        raise AssertionError(f"K2 backward calls took wgmma: "
                             f"{out['variants']['flash_attention_bwd']}")
    for kern in ("elastic_matmul_dgrad", "elastic_matmul_wgrad",
                 "flash_attention_bwd"):
        if out["variants"][kern]["fma_f32"]:
            raise AssertionError(f"{kern}: bf16 training took fma_f32")
    steady = res["step_ms"][1:]
    out["step_ms"] = statistics.median(steady)
    out["step_ms_all"] = res["step_ms"]
    out["peak_gib"] = peak / 2**30
    out["peak_run_gib"] = (peak - base) / 2**30
    out["losses"] = res["losses"]
    log(f"  {len(res['step_ms'])} steps run (one restart: "
        f"{res['restarts']}); losses {', '.join(f'{x:.3f}' for x in res['losses'])}")
    log(f"  step time: median {out['step_ms']:.1f} ms over the steps after "
        f"the first (all: {', '.join(f'{x:.1f}' for x in res['step_ms'])} "
        f"ms); peak device memory {out['peak_gib']:.2f} GiB "
        f"({out['peak_run_gib']:.2f} GiB above the "
        f"{base / 2**30:.2f} GiB allocated before the run)")
    log(f"  launches on the training path: {out['launches']}")
    log(f"  by variant: {out['variants']}")
    del res
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    t0 = phase(f"16. K1 forward, dgrad and wgrad vs plain at every distinct "
               f"call of one recorded sandwich step (batch {B}; bf16 as "
               f"recorded, cast to fp32, and with x or dy at unit rms)")
    params = vit_init(torch.Generator().manual_seed(0), cfg, device=dev)
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    batch = to_device(next(synthetic_image_batches(
        global_batch=B, img_res=cfg.img_res, n_classes=cfg.n_classes)), dev)

    def apply_fn(p, b, E):
        return vit_apply(p, b["images"], cfg, E=E)[0]
    opt_init, opt_update = make_optimizer(arch.optimizer)
    step_fn, sample = make_sandwich_step(apply_fn, opt_update, dims)
    E_stack = sample(cfg.elastic, np.random.default_rng(0))
    rec = {k: {} for k in ("k1", "k2", "dgrad", "wgrad", "k2_bwd")}

    def sink(key, args, kw):
        sig = call_signature(key, args, kw)
        if sig in rec[key]:
            rec[key][sig][2] += 1
        else:
            rec[key][sig] = [tuple(a.detach() if isinstance(a, torch.Tensor)
                                   else a for a in args), dict(kw), 1]
    with recording([(layers_mod, "elastic_matmul_op", "k1"),
                    (layers_mod, "flash_attention_op", "k2"),
                    (em, "elastic_matmul_dgrad", "dgrad"),
                    (em, "elastic_matmul_wgrad", "wgrad"),
                    (fa, "flash_attention_bwd", "k2_bwd")], sink):
        loss = sandwich_backward(apply_fn, params, batch, E_stack)
        torch.cuda.synchronize()
    pop_grads(params)
    if not math.isfinite(float(loss)):
        raise AssertionError(f"recorded step loss {float(loss)}")
    counts = {k: sum(n for *_, n in v.values()) for k, v in rec.items()}
    log(f"  recorded step: loss {float(loss):.4f}; calls {counts}, distinct "
        f"{ {k: len(v) for k, v in rec.items()} }; students "
        f"{ {k: v.tolist() for k, v in E_stack.items()} }")
    errs = {}
    # key -> (kernel, plain version, the argument scaled to unit rms, the
    # index of k_act in the arguments)
    checks = {"k1": (ops.elastic_matmul_op, k1_plain, 0, 2),
              "dgrad": (em.elastic_matmul_dgrad, k1_dgrad_plain, 0, 3),
              "wgrad": (em.elastic_matmul_wgrad, k1_wgrad_plain, 1, 3)}
    counter = {"k1": "elastic_matmul", "dgrad": "elastic_matmul_dgrad",
               "wgrad": "elastic_matmul_wgrad"}
    for key, (kern, plain, iu, iw) in checks.items():
        before = ops.launch_counts()[counter[key]]
        # as recorded, cast to fp32, and with x (forward) or dy (backward)
        # scaled to unit rms: the gradients of a batch-mean loss are small,
        # and so are their errors, so at unit scale the error must also be
        # within tol of the largest value (a kernel writing zeros fails)
        for dt, unit in ((torch.bfloat16, False), (torch.float32, False),
                         (torch.bfloat16, True)):
            tol = TOL[str(dt).split(".")[1]]
            worst = rel = 0.0
            for args, kw, n in rec[key].values():
                a = [t.to(dt) if isinstance(t, torch.Tensor)
                     and t.is_floating_point() else t for t in args]
                if unit:
                    a[iu] = (a[iu].float() / a[iu].float().square().mean()
                             .sqrt()).to(dt)
                a = tuple(a)
                k_act, n_act = a[iw], a[iw + 1]
                want = plain(*a, **kw)
                was = dict(ops.variant_counts()[counter[key]])
                got = kern(*a, **kw).reshape(want.shape)
                torch.cuda.synchronize()
                took = {v: c - was[v] for v, c in
                        ops.variant_counts()[counter[key]].items()
                        if c != was[v]}
                expect = "tma" if dt == torch.bfloat16 else "fma_f32"
                if key != "k1" and took != {expect: 1}:
                    raise AssertionError(
                        f"{key} {dt} at {(k_act, n_act)}: launches {took}, "
                        f"want one on {expect}")
                err = close(got, want, tol)
                worst = max(worst, err)
                r = err / max(float(want.abs().max()), 1e-30)
                rel = max(rel, r)
                if unit and not r <= tol:
                    raise AssertionError(
                        f"{key} at {(k_act, n_act)}: max abs err {err} is "
                        f"{r:.3g} of the largest value (tol {tol})")
                if key == "dgrad":
                    zero = got[:, k_act:]
                elif key == "wgrad":
                    zero = torch.cat([got[k_act:].flatten(),
                                      got[:k_act, n_act:].flatten()])
                else:
                    zero = got[:, n_act:]
                if zero.numel() and not bool((zero == 0).all()):
                    raise AssertionError(f"{key}: non-zero outside the "
                                         f"active block at {a[iw:iw + 2]}")
            errs[(key, str(dt), unit)] = worst
            widths = sorted({(v[0][iw], v[0][iw + 1])
                             for v in rec[key].values()})
            log(f"  {key:5s} {str(dt):15s}"
                f"{' at unit rms' if unit else ''} {len(rec[key])} distinct "
                f"calls (widths {widths}): max abs err {worst:.3g}, "
                f"{rel:.3g} of the largest value (tol {tol} + {tol} x "
                f"|plain|{'; and tol of the largest value' if unit else ''}"
                f"); zeros outside the active block exact")
        # the comparisons ran the kernel (an error of 0 is the kernel
        # summing in the library's order, not the plain route)
        ran = ops.launch_counts()[counter[key]] - before
        if ran != 3 * len(rec[key]):
            raise AssertionError(f"{key}: {ran} kernel launches in "
                                 f"{3 * len(rec[key])} comparisons")
    # the fused split-K reduce of wgrad's tma variant: the same call twice
    # gives the same bits (the partials are added in split order), and a
    # call captured in a CUDA graph gives the plain result at every replay
    # (the last block of each tile resets its counter)
    tol = TOL["bfloat16"]
    worst = 0.0
    for args, kw, _ in rec["wgrad"].values():
        worst = max(worst, repeatable(
            lambda: em.elastic_matmul_wgrad(*args, **kw),
            k1_wgrad_plain(*args, **kw), tol, f"wgrad at {args[3:5]}"))
    log(f"  wgrad: {len(rec['wgrad'])} distinct calls each twice, bit for "
        f"bit equal; each captured in a CUDA graph and replayed 3 times: "
        f"equal to the eager call, max abs err {worst:.3g} against plain "
        f"(tol {tol})")
    # the main path's own inputs; the unit-rms pass is logged above
    out["k1_bwd_err"] = {k: max(e for (kk, _, unit), e in errs.items()
                                if kk == k and not unit)
                         for k in ("dgrad", "wgrad")}
    out["k1_train_fwd_err"] = max(e for (kk, _, unit), e in errs.items()
                                  if kk == "k1" and not unit)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    t0 = phase("17. K2 backward (dQ, dK, dV), the forward's output and its "
               "logsumexp vs plain: the recorded step's call (S = T = 197, "
               "D = 64) as recorded and with dO at unit rms, and random "
               "cases, T not a multiple of the 64-key tile, GQA, resident "
               "and wgmma; the recorded call bit for bit twice and under "
               "graph replay")
    gen = torch.Generator().manual_seed(17)

    def rn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)
    # (name, q, k, v, dO, unit scale): the recorded dO is the gradient of
    # a batch-mean loss, so small, and so are its errors; at unit scale
    # each gradient's error must also be within tol of its largest value
    # (a kernel writing zeros fails)
    cases = []
    for v in rec["k2_bwd"].values():
        q, k, v_, do = (*v[0][:3], v[0][5])
        cases.append(("recorded", q, k, v_, do, False))
        cases.append(("recorded, dO unit rms", q, k, v_,
                      do.float() / do.float().square().mean().sqrt(), True))
    # resident at each of its warpgroup counts (T <= 64, 128, 192, 256),
    # GQA R = 3 and 2, one key (P = 1, so dQ and dK are 0: round-off of 0
    # is held below) and one query (the decode forward keeps no
    # logsumexp, training runs no S = 1: the backward reads the plain
    # forward's o and logsumexp there); wgmma past 256 queries and keys
    # (GQA R = 2)
    for Bq, S_, T_, H_, KH in ((8, 197, 197, 6, 6), (8, 197, 100, 6, 2),
                               (4, 65, 77, 4, 4), (4, 40, 50, 4, 4),
                               (4, 150, 150, 4, 2), (2, 256, 230, 4, 4),
                               (3, 2, 1, 2, 2), (4, 1, 77, 4, 2),
                               (2, 300, 300, 4, 2)):
        cases.append((f"B{Bq} S{S_} T{T_} H{H_}/{KH}",
                      rn(Bq, S_, H_, 64, scale=0.5), rn(Bq, T_, KH, 64,
                                                        scale=0.5),
                      rn(Bq, T_, KH, 64), rn(Bq, S_, H_, 64), True))
    k2_err = k2_fwd_err = 0.0
    k2_variants = {}
    before = (ops.launch_counts()["flash_attention"],
              ops.launch_counts()["flash_attention_bwd"])
    for name, q, k, v, do, unit in cases:
        for dt in (torch.bfloat16, torch.float32):
            tol = ATTN_TOL[str(dt).split(".")[1]]
            q_, k_, v_, do_ = (t.to(dt) for t in (q, k, v, do))
            o_p, lse_p = fa.flash_attention_plain(q_, k_, v_, causal=False,
                                                  return_lse=True)
            o, lse = (o_p, lse_p) if q.shape[1] == 1 else \
                fa.flash_attention(q_, k_, v_, causal=False, return_lse=True)
            was = dict(fa.bwd_variant_launches)
            got = fa.flash_attention_bwd(q_, k_, v_, o, lse, do_,
                                         causal=False)
            took = [n for n, c in fa.bwd_variant_launches.items()
                    if c != was[n]]
            want_v = ("fma_f32" if dt == torch.float32 else "resident"
                      if max(q.shape[1], k.shape[1]) <= fa.RESIDENT_MAX
                      else "wgmma")
            if took != [want_v]:
                raise AssertionError(f"K2 backward {name} {dt}: took "
                                     f"{took}, not {want_v}")
            want = fa.flash_attention_bwd_plain(q_, k_, v_, o, do_,
                                                causal=False)
            torch.cuda.synchronize()
            e_o = close(o, o_p, tol)
            e_lse = close(lse, lse_p, 1e-3)
            es = [close(a, b, tol) for a, b in zip(got, want)]
            # a gradient that is 0 but for round-off (its plain value
            # under ZERO_GRAD_REL of the call's largest gradient) must be
            # round-off on the kernel too; the others within tol of their
            # largest value
            zero = ZERO_GRAD_REL * max(float(b.abs().max()) for b in want)
            zeros = [float(b.abs().max()) < zero for b in want]
            for z, a, g in zip(zeros, got, "qkv"):
                if z and not float(a.abs().max()) < zero:
                    raise AssertionError(
                        f"K2 backward {name} {dt}: d{g} {float(a.abs().max())}"
                        f" is not round-off of 0 (under {zero:.3g})")
            rels = [0.0 if z else e / float(b.abs().max())
                    for z, e, b in zip(zeros, es, want)]
            if unit and not max(rels) <= tol:
                raise AssertionError(
                    f"K2 backward {name} {dt}: errors {es} are {rels} of "
                    f"the largest values (tol {tol})")
            k2_err = max(k2_err, *es)
            k2_fwd_err = max(k2_fwd_err, e_o)
            k2_variants[took[0]] = max(k2_variants.get(took[0], 0.0), *es)
            shares = "/".join("0" if z else f"{r:.3g}"
                              for z, r in zip(zeros, rels))
            log(f"  {str(dt):15s} {took[0]:8s} {name:22s} {tuple(q.shape)}: "
                f"o err "
                f"{e_o:.3g} (tol {tol}), lse err {e_lse:.3g} (tol 1e-3); "
                f"dq/dk/dv max abs err {'/'.join(f'{e:.3g}' for e in es)}"
                f", {shares} of the largest values (0: round-off of a zero "
                f"gradient; tol {tol}{' each' if unit else ' + x |plain|'})")
    ran = (ops.launch_counts()["flash_attention"] - before[0],
           ops.launch_counts()["flash_attention_bwd"] - before[1])
    n_fwd = 2 * sum(q.shape[1] > 1 for _, q, *_ in cases)
    if ran != (n_fwd, 2 * len(cases)):
        raise AssertionError(f"K2 forward/backward launches {ran} in "
                             f"{n_fwd} and {2 * len(cases)} comparisons")
    if set(k2_variants) != set(fa.BWD_VARIANTS):
        raise AssertionError(f"not every K2 backward variant ran: "
                             f"{sorted(k2_variants)}")
    log("  dq/dk/dv max abs err by variant: " + ", ".join(
        f"{v} {e:.3g}" for v, e in sorted(k2_variants.items())))
    # the recorded call on resident: the same bits twice and under 3
    # CUDA-graph replays (no atomics: GQA's sum over heads and every
    # output in a fixed order)
    rep_err = 0.0
    for v in rec["k2_bwd"].values():
        q, k, v_, o, lse, do = v[0][:6]
        was = fa.bwd_variant_launches["resident"]
        rep_err = max(rep_err, repeatable(
            lambda: fa.flash_attention_bwd(q, k, v_, o, lse, do,
                                           causal=False),
            fa.flash_attention_bwd_plain(q, k, v_, o, do, causal=False),
            ATTN_TOL["bfloat16"], "K2 backward (resident)"))
        if fa.bwd_variant_launches["resident"] - was != 3:
            raise AssertionError("the recorded K2 backward left resident")
    log(f"  recorded call on resident: bit for bit twice and under 3 graph "
        f"replays, max abs err {rep_err:.3g} (tol {ATTN_TOL['bfloat16']})")
    out["k2_fwd_err"] = k2_fwd_err
    out["k2_bwd_err"] = k2_err
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    t0 = phase("18. one fp32 sandwich step of the full-width config (batch "
               "4): kernel path vs plain path on the card")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = vit_init(torch.Generator().manual_seed(1), cfg32, device=dev)
    for _, p in named_leaves(p32):
        p.requires_grad_(True)
    b4 = to_device(next(synthetic_image_batches(
        global_batch=4, img_res=cfg.img_res, n_classes=cfg.n_classes,
        seed=1)), dev)

    def apply32(p, b, E):
        return vit_apply(p, b["images"], cfg32, E=E)[0]
    E4 = sample(cfg.elastic, np.random.default_rng(4))
    loss_k = float(sandwich_backward(apply32, p32, b4, E4))
    g_k = dict(named_leaves(pop_grads(p32)))
    with ops.plain_kernels():
        loss_p = float(sandwich_backward(apply32, p32, b4, E4))
    g_p = dict(named_leaves(pop_grads(p32)))
    rel = abs(loss_k - loss_p) / abs(loss_p)
    if not rel <= 1e-4:
        raise AssertionError(f"fp32 step loss {loss_k} vs plain {loss_p}")
    worst, worst_leaf = 0.0, ""
    g_max = max(float(g.abs().max()) for g in g_p.values() if g is not None)
    for path, gp in g_p.items():
        gk = g_k[path]
        if (gp is None) != (gk is None):
            raise AssertionError(f"{path}: gradient on one path only")
        if gp is None:
            continue
        scale = float(gp.abs().max())
        err = float((gk - gp).abs().max())
        if path.endswith("attn/k/bias"):
            # its true gradient is 0 (softmax ignores a shift shared by a
            # row's scores): both paths must give round-off of zero
            if max(scale, float(gk.abs().max())) > ZERO_GRAD_REL * g_max:
                raise AssertionError(f"{path}: {scale} is not round-off "
                                     f"of 0 (largest gradient {g_max})")
            continue
        if not math.isfinite(err) or err > 1e-3 * max(scale, 1e-12):
            raise AssertionError(f"{path}: grad err {err} > 1e-3 x {scale}")
        if scale > 0 and err / scale > worst:
            worst, worst_leaf = err / scale, path
    out["fp32_step"] = {"loss": loss_k, "loss_plain": loss_p,
                        "loss_rel_err": rel, "grad_rel_err": worst}
    log(f"  loss {loss_k:.6f} vs plain {loss_p:.6f} (rel {rel:.2g}, tol "
        f"1e-4); {len(g_p)} gradient leaves, worst max |diff| / max |grad| "
        f"{worst:.3g} at {worst_leaf} (tol 1e-3; the key biases, whose "
        f"true gradient is 0, within 1e-5 of the largest gradient "
        f"{g_max:.3g} on both paths); students "
        f"{ {k: v.tolist() for k, v in E4.items()} }")
    del p32, g_k, g_p, b4
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    t0 = phase("19. training kernel times over one recorded sandwich step "
               "(bf16, batch 256; graph-replayed device time), and one whole "
               "step's device time by kernel (torch.profiler)")
    opt = opt_init(params)
    try:
        bd = step_breakdown(lambda: step_fn(params, opt, batch, E_stack, 0))
    except NoTrace as e:
        bd = None
        log(f"  step breakdown not measured: {e}")
    if bd is not None:
        log(f"  one step: wall {bd['wall_ms']:.1f} ms (profiled), device "
            f"time in kernels {bd['device_ms']:.1f} ms (busy "
            f"{bd['device_ms'] / bd['wall_ms']:.0%}): " + ", ".join(
                f"{k} {v:.1f}" for k, v in sorted(bd["groups"].items(),
                                                  key=lambda kv: -kv[1])))
        log("  largest other kernels: " + "; ".join(
            f"{n} {ms:.1f} ms x{c}" for n, ms, c in bd["other_top"]))
    out["step_breakdown"] = bd
    if parent:
        log("  the whole step, wall time, on this tree's kernels and on the "
            "parent's, in turns:")
        out["step_e2e"] = step_wall(
            lambda: step_fn(params, opt, batch, E_stack, 0), parent)
    del opt, batch
    nograd = torch.no_grad

    def par(key):
        return parent and (parent[key], parent["libs"])
    out["k1_train_fwd"] = time_rows(
        "K1 forward, sandwich step", expand(rec["k1"]),
        ops.elastic_matmul_op, k1_plain, k1_library, "torch.matmul", k1_work,
        par("k1"))
    out["k2_train_fwd"] = time_rows(
        "K2 forward, sandwich step", expand(rec["k2"]),
        ops.flash_attention_op, k2_plain, k2_library, "sdpa", k2_work,
        par("k2"))
    out["k1_dgrad"] = time_rows(
        "K1 dgrad, sandwich step", expand(rec["dgrad"]),
        em.elastic_matmul_dgrad, k1_dgrad_plain, k1_dgrad_library,
        "torch.matmul", k1_dgrad_work, par("k1_dgrad"), group=bwd_group,
        mode=nograd)
    out["k1_wgrad"] = time_rows(
        "K1 wgrad, sandwich step", expand(rec["wgrad"]),
        em.elastic_matmul_wgrad, k1_wgrad_plain, k1_wgrad_library,
        "torch.matmul", k1_wgrad_work, par("k1_wgrad"), group=bwd_group,
        mode=nograd)
    out["k2_bwd"] = time_rows(
        "K2 backward, sandwich step", expand(rec["k2_bwd"]), k2_bwd_kernel,
        k2_bwd_plain, SdpaBackward(), "sdpa backward", k2_bwd_work,
        par("k2_bwd"), mode=nograd)
    del rec, params
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return out


# phase 20: the serve launcher's --trace defaults (64 interactive requests
# over 5 s: 12.8 rps, and 6.4 rps of batch)
TRACE_REQUESTS, TRACE_SECONDS = 64, 5.0


SERVED_TOL = 3e-2    # served logits against a direct forward


def served_err(sink: list, servers: list, by_name: dict, x, cfg) -> tuple:
    """Every answered payload against a direct forward of the subnet it
    names on each replica given (every request sends x[0]; the replicas
    share phase 6's weights).  Returns (max abs err, answers, subnets)."""
    import torch
    direct, err = {}, 0.0
    for _, out in sink:
        y = torch.from_numpy(out["y"])
        if y.shape != (cfg.n_classes,) or not torch.isfinite(y).all():
            raise AssertionError(f"bad served logits {tuple(y.shape)}")
        if out["subnet"] not in direct:
            direct[out["subnet"]] = [
                s.infer(x[:1], by_name[out["subnet"]])[0].float().cpu()
                for s in servers]
        for d in direct[out["subnet"]]:
            err = max(err, close(y, d, SERVED_TOL))
    return err, len(sink), len(direct)


def counting_drive_live(serve):
    """serve.drive_live wrapped to read the kernels' counters around the
    traffic alone; returns (wrapper, dict filled with before/after)."""
    from repro_torch.kernels import ops
    around, real = {}, serve.drive_live

    def drive_live(*a, **kw):
        around["before"] = ops.variant_counts()
        around["t0"] = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            around["seconds"] = time.perf_counter() - around["t0"]
            around["after"] = ops.variant_counts()
    return drive_live, around


def during(around: dict) -> dict:
    return {k: {v: around["after"][k][v] - around["before"][k][v]
                for v in around["after"][k]} for k in FORWARD}


def trace_phase(serve, arch, cfg, server, lut, x, base_ms, out_dir) -> dict:
    """Phase 20: ``serve.run_trace_mode`` on the card at full width with a
    Tracer, a MetricsRegistry, a CalibrationStore and --record; then the
    checks, and the recorded schedule replayed through ``simulate``."""
    from repro_torch.kernels import ops
    from repro_torch.obs import (iter_trace_events, quantile,
                                 to_chrome_trace, validate_schema)
    from repro_torch.obs.analyze import check_trace
    from repro_torch.obs.trace import (COLLECT, DEVICE, DISPATCH, QUEUE,
                                       STACK)
    from repro_torch.runtime import CalibrationStore, GlobalConstraints
    from repro_torch.traffic import load_schedule, simulate

    t0 = phase(f"20. serving control plane at full width: two servers "
               f"behind the ResourceArbiter, --trace poisson, "
               f"{TRACE_REQUESTS} requests over {TRACE_SECONDS:g} s")
    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, n) for k, n in (
        ("rec", "trace_rec.json"), ("cal", "trace_cal.json"),
        ("trace", "trace_chrome.json"), ("metrics", "trace_metrics.prom"))}
    args = serve.parse_args([
        "--trace", "poisson", "--requests", str(TRACE_REQUESTS),
        "--trace-duration", str(TRACE_SECONDS), "--record", paths["rec"],
        "--calibrate", "--calibrate-out", paths["cal"],
        "--trace-out", paths["trace"], "--metrics-out", paths["metrics"]])
    # the counts before and after the live traffic alone (the ladder warm
    # of both servers runs inside run_trace_mode, before drive_live)
    drive_live, around = counting_drive_live(serve)
    sink = []
    real, serve.drive_live = serve.drive_live, drive_live
    ops.reset_launch_counts()
    try:
        run = serve.run_trace_mode(args, arch, cfg, server, lut, x, base_ms,
                                   sink=sink)
    finally:
        serve.drive_live = real
    launches = ops.launch_counts()
    variants = ops.variant_counts()
    ran = during(around)
    rep, tracer, store = run.report, run.tracer, run.store

    # every arrival accounted for, against the recorded schedule
    recorded = load_schedule(paths["rec"])
    for name, cs in rep.classes.items():
        if cs.submitted != cs.rejected + cs.dropped + cs.failed + \
                cs.completed or cs.submitted != len(recorded[name]):
            raise AssertionError(f"{name}: {cs.summary()} against "
                                 f"{len(recorded[name])} recorded arrivals")
    cold = {n: s.cold_compiles for n, s in run.servers.items()}
    if any(cold.values()):
        raise AssertionError(f"cold (subnet, bucket) pairs: {cold}")
    # well-formed spans, each retained tree summing to its latency (5%)
    bad = validate_schema(tracer.spans())
    if bad:
        raise AssertionError(f"span schema: {bad[:5]}")
    trees = tracer.requests()
    for t in trees:
        check_trace(t)
    completed = sum(cs.completed for cs in rep.classes.values())
    if len(trees) != completed or tracer.dropped:
        raise AssertionError(f"{len(trees)} trees retained ({tracer.dropped} "
                             f"evicted) for {completed} completed")
    # the exports read back
    events = list(iter_trace_events(paths["trace"]))
    if events != to_chrome_trace(tracer)["traceEvents"] or sum(
            e.get("name") == DEVICE for e in events) != completed:
        raise AssertionError("the Chrome trace did not read back")
    for name, cs in rep.classes.items():
        served = run.metrics.value("engine_served_total", tenant=name,
                                   node="")
        if served != cs.completed:
            raise AssertionError(f"engine_served_total{{{name}}} {served} "
                                 f"!= completed {cs.completed}")
    # the calibration store: a latency row for every served (subnet,
    # bucket); save then load gives the same summary (load starts a new
    # version count)
    pairs = {(s.attrs["subnet"], s.attrs["bucket"]) for s in tracer.spans()
             if s.name == DEVICE}
    rows = store.summary()["latency"]
    missing = sorted(f"{sn}/b{b}" for sn, b in pairs
                     if f"{sn}/b{b}" not in rows)
    if missing:
        raise AssertionError(f"no calibration row for {missing}")
    again = CalibrationStore.load(paths["cal"]).summary()
    want = dict(store.summary(), version=1)
    if again != want:
        raise AssertionError("calibration store changed through save/load")
    # the kernels ran during the traffic, none of bf16 on the old kernels
    if min(sum(ran[k].values()) for k in ("elastic_matmul",
                                          "flash_attention")) <= 0:
        raise AssertionError(f"kernels not launched in the trace: {ran}")
    main_path_variants(ran, need={
        ("elastic_matmul", "tma"), ("elastic_matmul", "small_m"),
        ("flash_attention", "wgmma")})
    # every answer against a direct forward of the subnet it names (the
    # same image, x[0], on the same weights)
    by_name = {p.subnet.name(): p.subnet for p in lut.points}
    err_served, n_ans, n_sub = served_err(sink, list(run.servers.values()),
                                          by_name, x, cfg)

    # what it measured
    for name, cs in rep.classes.items():
        dev_spans = {(s.t0, s.attrs["n"]) for s in tracer.spans()
                     if s.name == DEVICE and s.cls == name}
        mean_batch = (sum(n for _, n in dev_spans) / len(dev_spans)
                      if dev_spans else 0.0)
        log(f"  {name:12s} submitted {cs.submitted}, completed "
            f"{cs.completed}, p50/p95/p99 {cs.p(50):.3f}/{cs.p(95):.3f}/"
            f"{cs.p(99):.3f} ms, goodput rate "
            f"{cs.good / max(cs.submitted, 1):.4f}, mean batch "
            f"{mean_batch:.3f} ({len(dev_spans)} batches), deadline "
            f"{[c.deadline_ms for c in run.classes if c.name == name][0]:.2f}"
            f" ms")
    log(f"  arbiter: {json.dumps(rep.arbiter)}")
    decomp, parts = {}, (QUEUE, COLLECT, STACK, DISPATCH, DEVICE)
    for name in rep.classes:
        mine = [t for t in trees if t.cls == name]
        for q in (50, 95):
            total = quantile([t.total_ms for t in mine], q)
            t = next(t for t in mine if t.total_ms == total)
            comp = t.component_ms()
            decomp[f"{name} p{q}"] = {"total_ms": total, **{
                c: comp.get(c, 0.0) for c in parts}}
            log(f"  {name} p{q} {total:.3f} ms = " + " + ".join(
                f"{c} {comp.get(c, 0.0):.3f}" for c in parts))
    sim = simulate(run.classes, {c.name: lut for c in run.classes},
                   recorded, lambda t: GlobalConstraints(total_chips=2),
                   interval_s=0.05, calibration=store)
    replay = {}
    for name, cs in rep.classes.items():
        replay[name] = {"live_p95_ms": cs.p(95),
                        "sim_p95_ms": sim.classes[name].p(95)}
        log(f"  {name:12s} p95 live {cs.p(95):.3f} ms, replayed through "
            f"simulate(calibration=store) {sim.classes[name].p(95):.3f} ms")
    at_nominal = [p for p in lut.points if p.hw_state.freq == 1.0]
    lo = min(at_nominal, key=lambda p: p.latency_ms)
    hi = max(at_nominal, key=lambda p: p.latency_ms)
    log(f"  measured LUT at freq 1.0: fastest {lo.subnet.name()} "
        f"{lo.latency_ms:.3f} ms, slowest {hi.subnet.name()} "
        f"{hi.latency_ms:.3f} ms ({hi.latency_ms / lo.latency_ms:.3f}x)")
    log(f"  launches by variant during the trace: "
        f"K1 {ran['elastic_matmul']}, K2 {ran['flash_attention']}; "
        f"run_trace_mode in all (warm included): {launches}")
    log(f"  served logits vs direct forward ({n_ans} answers, "
        f"{n_sub} subnets): max abs err {err_served:.3g}; cold pairs "
        f"{cold}; "
        f"{len(trees)} trees, {len(events)} trace events, "
        f"{len(rows)} calibration rows")
    seconds = time.perf_counter() - t0
    log(f"  ({seconds:.1f} s)")
    return {"launches": launches, "variants": variants,
            "servers": run.servers,
            "trace_variants": ran, "classes": {
                n: cs.summary() for n, cs in rep.classes.items()},
            "decomposition": decomp, "replay": replay,
            "lut_spread_ms": [lo.latency_ms, hi.latency_ms],
            "served_err": err_served, "seconds": seconds}


def ranks(xs) -> list:
    """Ranks of xs (ties share their mean rank)."""
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    r = [0.0] * len(xs)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        for k in range(i, j + 1):
            r[order[k]] = (i + j) / 2
        i = j + 1
    return r


def spearman(a, b) -> float:
    """Rank correlation of two sequences."""
    ra, rb = ranks(a), ranks(b)
    ma, mb = statistics.fmean(ra), statistics.fmean(rb)
    cov = sum((x - ma) * (y - mb) for x, y in zip(ra, rb))
    va = sum((x - ma) ** 2 for x in ra)
    vb = sum((y - mb) ** 2 for y in rb)
    return cov / math.sqrt(va * vb) if va and vb else float("nan")


def vit_compiled(servers: dict, specs, lut, x, cfg, dims) -> dict:
    """Phase 21, the ViT's half: eager forward against graph replay for
    every profiled subnet at bucket 8 on phase 6's server (the interactive
    tenant of phase 20), the captures of both servers, the graph LUT."""
    import torch

    from repro_torch.core.elastic import spec_to_static
    from repro_torch.runtime.lut import subnet_flops_ratio

    t0 = phase("21. compiled executables, the ViT: eager forward against "
               "CUDA-graph replay at bucket 8 for every profiled subnet")
    server = servers["interactive"]
    want = len(specs) * len(server.buckets)
    captures = {}
    for name, srv in servers.items():
        held = sum(srv.graph(sp, b) is not None for sp in specs
                   for b in srv.buckets)
        captures[name] = srv.captures
        if held != want or srv.captures != want or srv.cold_compiles:
            raise AssertionError(
                f"{name} server: {held} of {want} (subnet, bucket) graphs, "
                f"{srv.captures} captures, cold {srv.cold_compiles}")
    dev = server.device
    xd = torch.from_numpy(x).to(dev)
    rows = {}
    with torch.inference_mode():
        for spec in specs:
            E = spec_to_static(spec, dims)

            def eager():
                return server.apply_fn(server.params, xd, E)
            walls = []
            y_eager = eager()
            torch.cuda.synchronize()
            for _ in range(5):
                ts = time.perf_counter()
                eager()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - ts) * 1e3)
            y_graph = server.infer(x, spec)
            if not torch.equal(y_graph, y_eager):
                raise AssertionError(
                    f"{spec.name()}: graph logits differ from the eager "
                    f"forward by "
                    f"{float((y_graph.float() - y_eager.float()).abs().max())}")
            g = server.graph(spec, BUCKET)
            dms = []
            with g.lock:
                for _ in range(6):
                    a, b = torch.cuda.Event(enable_timing=True), \
                        torch.cuda.Event(enable_timing=True)
                    a.record()
                    g.replay()
                    b.record()
                    torch.cuda.synchronize()
                    dms.append(a.elapsed_time(b))
            rows[spec.name()] = {
                "eager_ms": statistics.median(walls),
                "graph_ms": server.measure(spec, x, iters=5),
                "graph_device_ms": statistics.median(dms[1:]),
                "flops_ratio": subnet_flops_ratio(spec)}
    for name, r in rows.items():
        log(f"  {name:28s} flops {r['flops_ratio']:.3f}: eager "
            f"{r['eager_ms']:7.3f} ms, graph replay {r['graph_ms']:7.3f} ms "
            f"(copy in and out included), graph device "
            f"{r['graph_device_ms']:7.3f} ms")
    at1 = {p.subnet.name(): p.latency_ms for p in lut.points
           if p.hw_state.freq == 1.0}
    full, small = cfg.elastic.max_spec().name(), cfg.elastic.min_spec().name()
    if not at1[full] > at1[small]:
        raise AssertionError(f"graph LUT: full {full} {at1[full]:.3f} ms not "
                             f"above the smallest {small} {at1[small]:.3f}")
    names = list(rows)
    flops = [rows[n]["flops_ratio"] for n in names]
    rho = {"lut": spearman([at1[n] for n in names], flops),
           "eager": spearman([rows[n]["eager_ms"] for n in names], flops),
           "graph_device": spearman([rows[n]["graph_device_ms"]
                                     for n in names], flops)}
    lo, hi = min(at1, key=at1.get), max(at1, key=at1.get)
    pools = {n: srv.graph_pool_bytes() for n, srv in servers.items()}
    fmt = lambda b: "not measured" if b is None else f"{b / 2**20:.1f} MiB"
    log(f"  graph LUT at freq 1.0 (phase 6's measure): full {at1[full]:.3f} "
        f"ms > smallest {at1[small]:.3f} ms; fastest {lo} {at1[lo]:.3f}, "
        f"slowest {hi} {at1[hi]:.3f} ms ({at1[hi] / at1[lo]:.3f}x); rank "
        f"correlation with subnet_flops_ratio: LUT {rho['lut']:.3f}, eager "
        f"wall {rho['eager']:.3f}, graph device {rho['graph_device']:.3f}")
    log(f"  captures {captures} (= {len(specs)} subnets x "
        f"{len(server.buckets)} buckets each; the batch server's all at "
        f"warm), cold (subnet, bucket) pairs 0, graph logits equal the "
        f"eager forward bit for bit for all {len(rows)} subnets; graph "
        f"pools " + ", ".join(f"{n} {fmt(b)}" for n, b in pools.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    return {"rows": rows, "lut_ms": {"full": at1[full], "smallest":
                                     at1[small], "fastest": [lo, at1[lo]],
                                     "slowest": [hi, at1[hi]]},
            "rank_corr": rho, "captures": captures,
            "pool_mib": {n: None if b is None else b / 2**20
                         for n, b in pools.items()}}


# the conv nets (phase 22): K1's kernels by name in a profiled step (the
# backward's before the forward's: cuDNN's own kernels carry "dgrad" and
# "wgrad" in their names too), then cuDNN's and ATen's convolutions, then
# PyTorch's BN, elementwise and reduction kernels
CONV_STEP_GROUPS = (
    ("dgrad_tma_kernel", "K1 dgrad"), ("dgrad_wmma", "K1 dgrad"),
    ("dgrad_fma", "K1 dgrad"), ("wgrad_tma_kernel", "K1 wgrad"),
    ("wgrad_wmma", "K1 wgrad"), ("wgrad_fma", "K1 wgrad"),
    ("wgrad_reduce", "K1 wgrad"), ("gemm_tma_kernel", "K1 forward"),
    ("small_m_", "K1 forward"), ("f32_splitk_kernel", "K1 forward"),
    ("elastic_matmul_", "K1 forward"),
    ("conv", "convolutions (cuDNN, ATen)"),
    ("xmma", "convolutions (cuDNN, ATen)"),
    ("cudnn", "convolutions (cuDNN, ATen)"),
    ("implicit", "convolutions (cuDNN, ATen)"),
    ("fprop", "convolutions (cuDNN, ATen)"),
    ("dgrad", "convolutions (cuDNN, ATen)"),
    ("wgrad", "convolutions (cuDNN, ATen)"),
    ("depthwise", "convolutions (cuDNN, ATen)"),
    ("elementwise", "BN, elementwise and reductions"),
    ("reduce", "BN, elementwise and reductions"),
    ("Reduce", "BN, elementwise and reductions"),
    ("max_pool", "BN, elementwise and reductions"))
K1_KERNELS = ("elastic_matmul", "elastic_matmul_dgrad",
              "elastic_matmul_wgrad")
# the conv nets' logits, kernel path against plain path, as a share of the
# largest |logit| (eval mode at init lets the residual stream grow, so the
# scale is the logits' own): fp32 over 150 or so layers (worst reading
# 1.42e-5, NVIDIA H100 80GB HBM3, 700.00 W).  In bf16 each layer rounds
# its output, and EfficientNet-B7's 55 blocks with batch-statistics BN
# over 8 images grow a rounding apart to a sixth of the largest logit
# (the same card), so bf16 is held to the fp32 plain logits: the kernel
# path's distance from them at most twice the plain path's bf16 distance,
# plus the bf16 tolerance
CONV_LOGITS_FP32_TOL = 1e-4
CONV_BF16_FACTOR = 2.0
CONV_B = 8                   # phase 22 (b)'s batch
EFF_ACCUM = 4                # phase 22 (d): 256 images as 4 x 64


def close_to_largest(a, b, tol: float) -> float:
    """Max |a - b| / max |b|; raises unless it is within ``tol`` and a is
    finite.  For sums over long reductions (wgrad over 802,816 rows),
    where an element near 0 carries the round-off of its large partial
    sums."""
    import torch
    scale, diff, finite = 1e-30, 0.0, True
    for x, y in _chunks(a, b):
        scale = max(scale, float(y.abs().max()))
        diff = max(diff, float((x - y).abs().max()))
        finite = finite and bool(torch.isfinite(x).all())
    rel = diff / scale
    if not finite or not rel <= tol:
        raise AssertionError(f"max abs err {rel:.3g} of the largest value "
                             f"{scale:.3g}, beyond tolerance {tol}")
    return rel


def k1_conv_checks(dev, randn) -> dict:
    """Phase 22 (a): K1's forward, dgrad and wgrad against their plain
    versions at the conv nets' shapes, fp32 and bf16; each call one launch
    of the variant its shape, dtype and strides choose.  Returns {"err",
    "held": the (kernel, variant) pairs held in bf16}."""
    import torch

    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import ops

    t0 = phase("22. the conv nets: ResNet-152 and EfficientNet-B7 trained "
               "at full width; (a) K1 forward, dgrad and wgrad vs plain at "
               "the conv shapes")
    M = 256 * 56 * 56          # ResNet stage 0 at batch 256 = B7's 112 px
    # at microbatch 64
    # (label, M, full weight (K, N), k_act, n_act, n_out, dgrad's kx)
    cases = [
        ("1x1 64->64", M, (64, 64), 64, 64, 64, 64),
        ("1x1 64->256", M, (64, 256), 64, 256, 256, 64),
        ("1x1 256->64", M, (256, 64), 256, 64, 64, 256),
        ("width 0.25: 16 of 64->64", M, (64, 64), 16, 16, 16, 16),
        ("width 0.25, zeros past 16", M, (64, 64), 16, 16, 64, 64),
        ("SE reduce 288->12", 256, (288, 12), 288, 12, 12, 288),
        ("SE expand 12->288", 256, (12, 288), 12, 288, 288, 12),
        ("SE reduce 480->20", 256, (480, 20), 480, 20, 20, 480),
        ("SE expand 20->480", 256, (20, 480), 20, 480, 480, 20),
    ]
    counters = {"elastic_matmul": "variant_launches",
                "elastic_matmul_dgrad": "dgrad_variant_launches",
                "elastic_matmul_wgrad": "wgrad_variant_launches"}

    def took(kernel, before):
        now = getattr(em, counters[kernel])
        return {v: n - before[v] for v, n in now.items() if n != before[v]}
    held, errs = set(), {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        tol = TOL[dt]
        for label, rows, (K, N), ka, na, n_out, kx in cases:
            w = randn(K, N, scale=K ** -0.5, dtype=dtype)
            x = randn(rows, ka, dtype=dtype)
            dy = randn(rows, n_out, dtype=dtype)
            widths = ops.widths_tensor(dev, ka, na)
            aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
            want = {
                "elastic_matmul": em.choose_variant(rows, ka, na, dtype, ka,
                                                    N, aligned),
                "elastic_matmul_dgrad": em.choose_bwd_variant(
                    rows, ka, na, dtype, (n_out, N, kx), aligned),
                "elastic_matmul_wgrad": em.choose_bwd_variant(
                    rows, ka, na, dtype, (ka, n_out), aligned)}
            calls = {
                "elastic_matmul": (
                    lambda: ops.elastic_matmul_op(x, w, ka, na, n_out=n_out),
                    lambda: em.elastic_matmul_plain(x, w, ka, na, n_out)),
                "elastic_matmul_dgrad": (
                    lambda: em.elastic_matmul_dgrad(dy, w, widths, ka, na,
                                                    kx),
                    lambda: em.elastic_matmul_dgrad_plain(dy, w, ka, na,
                                                          kx)),
                "elastic_matmul_wgrad": (
                    lambda: em.elastic_matmul_wgrad(x, dy, widths, ka, na,
                                                    (K, N)),
                    lambda: em.elastic_matmul_wgrad_plain(x, dy, ka, na,
                                                          (K, N)))}
            line = []
            for kernel, (kern, plain) in calls.items():
                before = dict(getattr(em, counters[kernel]))
                with torch.inference_mode():
                    got = kern()
                    ran = took(kernel, before)
                    ref = plain()
                torch.cuda.synchronize()
                if ran != {want[kernel]: 1}:
                    raise AssertionError(f"{kernel} {dt} {label}: launches "
                                         f"{ran}, want one on "
                                         f"{want[kernel]}")
                if kernel == "elastic_matmul_wgrad":
                    # of the largest value: 802,816-row sums
                    err = close_to_largest(got, ref, tol)
                    zero = torch.cat([got[ka:].flatten(),
                                      got[:ka, na:].flatten()])
                else:
                    err = close(got, ref, tol)
                    zero = got[:, na:] if kernel == "elastic_matmul" \
                        else got[:, ka:]
                if zero.numel() and not bool((zero == 0).all()):
                    raise AssertionError(f"{kernel} {dt} {label}: non-zero "
                                         f"outside the active block")
                errs[(kernel, dt)] = max(errs.get((kernel, dt), 0.0), err)
                if dtype == torch.bfloat16:
                    held.add((kernel, want[kernel]))
                line.append(f"{kernel.replace('elastic_matmul', 'fwd')[:9]}"
                            f" {want[kernel]} {err:.3g}")
                del got, ref
            log(f"  {dt:8s} {label:26s} M={rows:6d} k={ka:3d}/{K:3d} "
                f"n={na:3d}/{n_out:3d}: " + "; ".join(line))
            del w, x, dy
    log(f"  max errors (forward and dgrad: abs, tol {TOL['float32']} / "
        f"{TOL['bfloat16']} + tol x |plain|; wgrad: of the largest value): "
        + ", ".join(f"{k.replace('elastic_matmul', 'K1')} {d} {e:.3g}"
                    for (k, d), e in sorted(errs.items())))
    log(f"  bf16 variants held: {sorted(held)}; zeros outside every active "
        f"block exact ({time.perf_counter() - t0:.1f} s)")
    return {"err": errs, "held": held}


def conv_logits(dev, randn) -> dict:
    """Phase 22 (b): full-size ResNet-152 and EfficientNet-B7 logits,
    kernel path against plain path, at batch 8."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.efficientnet import effnet_apply, effnet_init
    from repro_torch.models.resnet import resnet_apply, resnet_init

    t0 = phase(f"22. (b) full-size logits, kernel path vs plain path (batch "
               f"{CONV_B}, 224 px; fp32 with cuDNN's TF32 off, and bf16)")
    out = {}
    nets = (
        ("resnet-152", resnet_init, resnet_apply,
         [dict(setting=s, depth_mult=d) for s in (0, 3) for d in (0.5, 1.0)]),
        ("efficientnet-b7", effnet_init, effnet_apply,
         [dict(setting=s, depth_mult=d, kernel_size=3) for s in (0, 2)
          for d in (0.5, 1.0)]))
    imgs = randn(CONV_B, 224, 224, 3)
    for arch_id, init, apply, knobs in nets:
        cfg = dataclasses.replace(get_arch(arch_id).make_config(),
                                  img_res=224)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        params = init(torch.Generator().manual_seed(1), cfg32, device=dev)
        worst32, worst16, top1, wk, wp = 0.0, 0.0, 1.0, 0.0, 0.0
        for kw in knobs:
            for train in (False, True):
                with torch.inference_mode():
                    yk = apply(params, imgs, cfg32, train=train, **kw)[0]
                    with ops.plain_kernels():
                        yp = apply(params, imgs, cfg32, train=train, **kw)[0]
                    e32 = close_to_largest(yk, yp, CONV_LOGITS_FP32_TOL)
                    yk16 = apply(params, imgs, cfg, train=train, **kw)[0]
                    with ops.plain_kernels():
                        yp16 = apply(params, imgs, cfg, train=train, **kw)[0]
                scale = max(float(yp.abs().max()), 1e-30)
                ek, ep = (float((y.float() - yp).abs().max()) / scale
                          for y in (yk16, yp16))
                e16 = float((yk16.float() - yp16.float()).abs().max()) / scale
                if not torch.isfinite(yk16).all() or \
                        not ek <= CONV_BF16_FACTOR * ep + TOL["bfloat16"]:
                    raise AssertionError(
                        f"{arch_id} {kw} train={train}: the kernel path's "
                        f"bf16 logits {ek:.3g} of the largest fp32 logit "
                        f"from the fp32 ones, the plain path's {ep:.3g}")
                t1 = float((yk16.argmax(-1) == yp16.argmax(-1)).float()
                           .mean())
                worst32, worst16 = max(worst32, e32), max(worst16, e16)
                wk, wp = max(wk, ek), max(wp, ep)
                top1 = min(top1, t1)
                log(f"  {arch_id:15s} {kw} train={train!s:5s}: fp32 "
                    f"{e32:.3g} of the largest |logit| "
                    f"{float(yp.abs().max()):.4g} (tol "
                    f"{CONV_LOGITS_FP32_TOL}); bf16 kernel vs plain path "
                    f"{e16:.3g} of it, top-1 agreement {t1:.2f}; from the "
                    f"fp32 logits: kernel path {ek:.3g}, plain path "
                    f"{ep:.3g} (kernel at most {CONV_BF16_FACTOR:g} x plain "
                    f"+ {TOL['bfloat16']})")
        out[arch_id] = {"fp32_rel_err": worst32, "bf16_rel_err": worst16,
                        "bf16_top1": top1, "bf16_kernel_from_fp32": wk,
                        "bf16_plain_from_fp32": wp}
        del params
    torch.cuda.empty_cache()
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return out


def conv_train(label: str, argv: list, held: set, restarts: int,
               dev) -> dict:
    """Phase 22 (c) and (d): the training launcher on the card; finite
    losses, ``restarts`` restarts, K1's forward, dgrad and wgrad counters
    rising and every launch on a variant that phase (a) held in bf16."""
    import shutil
    import tempfile

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.optim.api import named_leaves

    t0 = phase(f"22. {label}: python -m repro_torch.launch.train "
               f"{' '.join(argv)}")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ops.reset_launch_counts()
    try:
        res = train_mod.main(argv + ["--ckpt-dir", ckpt, "--log-every", "1",
                                     "--device", "cuda"])
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    launches, variants = ops.launch_counts(), ops.variant_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if res["restarts"] != restarts:
        raise AssertionError(f"{res['restarts']} restarts, want {restarts}")
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"non-finite losses {res['losses']}")
    for _, p in named_leaves(res["params"]):
        if not torch.isfinite(p).all():
            raise AssertionError("non-finite parameters after training")
    idle = [k for k in K1_KERNELS if launches[k] <= 0]
    if idle:
        raise AssertionError(f"K1 kernels not launched: {idle}")
    other = {k: n for k, n in launches.items() if n and k not in K1_KERNELS}
    if other:
        raise AssertionError(f"kernels other than K1 launched: {other}")
    unheld = {(k, v): n for k in K1_KERNELS for v, n in variants[k].items()
              if n and (k, v) not in held}
    if unheld:
        raise AssertionError(f"launches on variants phase (a) did not hold "
                             f"in bf16: {unheld}")
    steady = res["step_ms"][1:] or res["step_ms"]
    B = 256
    n_params = sum(p.numel() for _, p in named_leaves(res["params"]))
    out = {"step_ms": statistics.median(steady), "params": n_params,
           "step_ms_all": res["step_ms"], "losses": res["losses"],
           "images_per_s": B / statistics.median(steady) * 1e3,
           "peak_gib": peak / 2**30, "peak_run_gib": (peak - base) / 2**30,
           "launches": {k: launches[k] for k in K1_KERNELS},
           "variants": {k: variants[k] for k in K1_KERNELS}}
    log(f"  {n_params / 1e6:.2f} M parameters (switchable BN's sets and "
        f"running stats included); {len(res['step_ms'])} steps run, "
        f"{res['restarts']} restarts; losses "
        f"{', '.join(f'{x:.4f}' for x in res['losses'])}")
    log(f"  step: median {out['step_ms']:.1f} ms after the first (all: "
        f"{', '.join(f'{x:.1f}' for x in res['step_ms'])} ms), "
        f"{out['images_per_s']:.1f} images/s; peak device memory "
        f"{out['peak_gib']:.2f} GiB ({out['peak_run_gib']:.2f} GiB above "
        f"the {base / 2**30:.2f} GiB allocated before)")
    log(f"  K1 launches {out['launches']}; by variant {out['variants']}")
    del res
    torch.cuda.empty_cache()
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return out


def conv_profile(arch_id: str, accum: int, step_ms: float, dev) -> dict:
    """Phase 22 (e) for one net: one profiled vis_train step at batch 256
    (device time by kernel group; the busy share and the model-FLOPs rate
    over ``step_ms``, the launcher's median step, since the profiler
    slows the host), and K1's forward, dgrad and wgrad calls of one
    recorded microbatch for the timing rows.  Returns {"breakdown",
    "model_tflop", "calls"}."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import layers as layers_mod
    from repro_torch.core.distill import ce_loss
    from repro_torch.data import synthetic_image_batches, to_device
    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.launch import flops
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import (accum_grads, make_vis_train_step,
                                          vis_forward)
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.api import named_leaves, pop_grads

    arch = get_arch(arch_id)
    shape = arch.shape("cls_224")
    cfg = dataclasses.replace(arch.make_config(), img_res=shape.img_res)
    B = shape.global_batch
    t0 = phase(f"22. (e) {arch_id}: one profiled step (batch {B}, accum "
               f"{accum}) and the K1 calls of one recorded step")
    params = train_mod.init_params(arch, cfg, dev)
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    init_fn, update_fn = make_optimizer(arch.optimizer)
    opt = init_fn(params)
    step_fn = make_vis_train_step(arch_id, cfg, update_fn, accum)
    batch = to_device(next(synthetic_image_batches(
        global_batch=B, img_res=cfg.img_res, n_classes=cfg.n_classes)), dev)
    model_flops = flops.model_flops(arch, cfg, shape)
    out = {"model_tflop": model_flops / 1e12}
    try:
        bd = step_breakdown(lambda: step_fn(params, opt, batch, 0),
                            CONV_STEP_GROUPS)
    except NoTrace as e:
        bd = None
        log(f"  step breakdown not measured: {e}")
    rate = model_flops / (step_ms / 1e3)
    out.update(step_ms=step_ms, model_tflops=rate / 1e12,
               model_flops_share=rate / PEAK_BF16_FLOPS)
    if bd is not None:
        bd.update(busy=bd["device_ms"] / step_ms,
                  busy_profiled=bd["device_ms"] / bd["wall_ms"])
        log(f"  one step: device time in kernels {bd['device_ms']:.1f} ms, "
            f"busy {bd['busy']:.0%} of the launcher's median step "
            f"{step_ms:.1f} ms ({bd['busy_profiled']:.0%} of the profiled "
            f"step's wall {bd['wall_ms']:.1f} ms): " + ", ".join(
                f"{k} {v:.1f}" for k, v in sorted(
                    bd["groups"].items(), key=lambda kv: -kv[1])))
        for row, ks in bd["group_top"].items():
            log(f"    {row}: " + "; ".join(f"{n} {ms:.1f} ms x{c}"
                                          for n, ms, c in ks))
        log("    other kernels: " + "; ".join(
            f"{n} {ms:.1f} ms x{c}" for n, ms, c in bd["other_top"][:4]))
    log(f"  model FLOPs {model_flops / 1e12:.2f} TFLOP a step "
        f"(launch/flops.py): {rate / 1e12:.1f} TFLOP/s over the median "
        f"step, {rate / PEAK_BF16_FLOPS:.1%} of the "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 dense peak")
    out["breakdown"] = bd
    rec = {k: {} for k in ("k1", "dgrad", "wgrad")}

    def sink(key, args, kw):
        sig = call_signature(key, args, kw)
        if sig in rec[key]:
            rec[key][sig][2] += 1
        else:
            rec[key][sig] = [tuple(a.detach() if isinstance(a, torch.Tensor)
                                   else a for a in args), dict(kw), 1]
    forward = vis_forward(arch_id, cfg)
    mb = {k: v[:B // accum] for k, v in batch.items()}
    with recording([(layers_mod, "elastic_matmul_op", "k1"),
                    (em, "elastic_matmul_dgrad", "dgrad"),
                    (em, "elastic_matmul_wgrad", "wgrad")], sink):
        loss, _ = accum_grads(lambda p, b: ce_loss(
            forward(p, b["images"]), b["labels"]), params, mb, 1)
        torch.cuda.synchronize()
    pop_grads(params)
    if not math.isfinite(float(loss)):
        raise AssertionError(f"recorded step loss {float(loss)}")
    log(f"  recorded one microbatch of {B // accum}: calls "
        f"{ {k: sum(n for *_, n in v.values()) for k, v in rec.items()} }, "
        f"distinct { {k: len(v) for k, v in rec.items()} }")
    out["calls"] = rec
    del params, opt, batch
    torch.cuda.empty_cache()
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return out


def k1_recorded_checks(label: str, rec: dict) -> dict:
    """Phase 22 (f) for one recorded step: K1's forward, dgrad and wgrad
    against their plain versions at every distinct call, bf16 as recorded.
    Forward and dgrad within ``close``'s tolerance and within tolerance of
    the largest value (a batch-mean loss's gradients are small, so the
    absolute tolerance alone would pass a kernel writing zeros), wgrad
    within tolerance of the largest value (sums over up to 802,816 rows);
    exact zeros past the active widths; one launch per comparison.
    Returns {kernel: {"abs": worst max abs err, "of_largest": worst share
    of the largest value, "variants": launches by variant}}."""
    import torch

    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import ops

    tol = TOL["bfloat16"]
    # key -> (counter, kernel, plain version, the index of k_act)
    checks = {"k1": ("elastic_matmul", ops.elastic_matmul_op, k1_plain, 2),
              "dgrad": ("elastic_matmul_dgrad", em.elastic_matmul_dgrad,
                        k1_dgrad_plain, 3),
              "wgrad": ("elastic_matmul_wgrad", em.elastic_matmul_wgrad,
                        k1_wgrad_plain, 3)}
    out = {}
    for key, (name, kern, plain, iw) in checks.items():
        before = ops.launch_counts()[name]
        was = dict(ops.variant_counts()[name])
        worst = rel = 0.0
        for args, kw, _ in rec[key].values():
            k_act, n_act = args[iw], args[iw + 1]
            with torch.no_grad():
                want = plain(*args, **kw)
                got = kern(*args, **kw).reshape(want.shape)
            torch.cuda.synchronize()
            where = f"{label} {name} {tuple(args[0].shape)} at " \
                    f"{(k_act, n_act)}"
            try:
                r = close_to_largest(got, want, tol)
                if key != "wgrad":
                    worst = max(worst, close(got, want, tol))
            except AssertionError as e:
                raise AssertionError(f"{where}: {e}") from None
            rel = max(rel, r)
            if key == "wgrad":
                zero = torch.cat([got[k_act:].flatten(),
                                  got[:k_act, n_act:].flatten()])
            else:
                zero = got.reshape(-1, got.shape[-1])[
                    :, (n_act if key == "k1" else k_act):]
            if zero.numel() and not bool((zero == 0).all()):
                raise AssertionError(f"{where}: non-zero outside the active "
                                     f"block")
            del want, got, zero
        ran = ops.launch_counts()[name] - before
        if ran != len(rec[key]):
            raise AssertionError(f"{label} {name}: {ran} kernel launches in "
                                 f"{len(rec[key])} comparisons")
        took = {v: c - was[v] for v, c in ops.variant_counts()[name].items()
                if c != was[v]}
        out[name] = {"abs": worst, "of_largest": rel, "variants": took}
        log(f"  {label}: {name:20s} {len(rec[key]):3d} distinct calls on "
            f"{took}: " + (f"max abs err {worst:.3g} (tol {tol} + {tol} x "
                           f"|plain|), " if key != "wgrad" else "")
            + f"{rel:.3g} of the largest value (tol {tol}); zeros outside "
            f"the active block exact")
    return out


def se_calls(calls: dict, M: int, key: str) -> dict:
    """The recorded squeeze-excite calls of one microbatch: the K1
    forward, dgrad or wgrad calls (``key``) over M = batch rows but the
    classifier's (a weight of 1000 columns)."""
    def rows(args):
        return args[0].numel() // args[0].shape[-1]

    def n_full(args):
        return args[5][1] if key == "wgrad" else args[1].shape[-1]
    return {sig: v for sig, v in calls.items()
            if rows(v[0]) == M and n_full(v[0]) != 1000}


def conv_phases(dev, randn) -> dict:
    """Phase 22: the conv nets at full width on the card.  Returns what
    the kernels' record needs."""
    import torch

    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import ops

    torch.cuda.empty_cache()
    log(f"\n(device memory allocated before phase 22: "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB)")
    out = {"k1": k1_conv_checks(dev, randn)}
    out["logits"] = conv_logits(dev, randn)
    held = out["k1"]["held"]
    out["resnet"] = conv_train(
        "(c) ResNet-152, full width and depth, cls_224 batch 256, bf16; 4 "
        "steps, a checkpoint every 2, a failure injected at step 3",
        ["--arch", "resnet-152", "--steps", "4", "--save-every", "2",
         "--fail-at", "3"], held, 1, dev)
    out["effnet"] = conv_train(
        f"(d) EfficientNet-B7, full width and depth, cls_224 batch 256 as "
        f"{EFF_ACCUM} microbatches of {256 // EFF_ACCUM}, bf16; 3 steps",
        ["--arch", "efficientnet-b7", "--steps", "3", "--accum",
         str(EFF_ACCUM), "--save-every", "100"], held, 0, dev)
    prof_r = conv_profile("resnet-152", 1, out["resnet"]["step_ms"], dev)
    prof_e = conv_profile("efficientnet-b7", EFF_ACCUM,
                          out["effnet"]["step_ms"], dev)
    out["breakdown"] = {
        arch: dict(breakdown=p["breakdown"], **{k: p[k] for k in (
            "model_tflop", "model_tflops", "model_flops_share")})
        for arch, p in (("resnet-152", prof_r), ("efficientnet-b7",
                                                 prof_e))}
    rc, ec = prof_r["calls"], prof_e["calls"]
    mb = 256 // EFF_ACCUM
    t0 = phase(f"22. (f) K1 forward, dgrad and wgrad vs plain at every "
               f"distinct call of the recorded ResNet-152 step (batch 256) "
               f"and EfficientNet-B7 microbatch ({mb}), bf16 as recorded")
    out["recorded"] = {
        "resnet": k1_recorded_checks("ResNet-152 step", rc),
        "effnet": k1_recorded_checks("EfficientNet-B7 microbatch", ec)}
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = phase("22. (e) K1 times over the recorded calls (bf16; "
               "graph-replayed device time)")
    nograd = torch.no_grad
    out["rows"] = {
        "resnet_fwd": time_rows(
            "K1 forward, ResNet-152 step", expand(rc["k1"]),
            ops.elastic_matmul_op, k1_plain, k1_library, "torch.matmul",
            k1_work, group=k1_group),
        "resnet_dgrad": time_rows(
            "K1 dgrad, ResNet-152 step", expand(rc["dgrad"]),
            em.elastic_matmul_dgrad, k1_dgrad_plain, k1_dgrad_library,
            "torch.matmul", k1_dgrad_work, group=bwd_group, mode=nograd),
        "resnet_wgrad": time_rows(
            "K1 wgrad, ResNet-152 step", expand(rc["wgrad"]),
            em.elastic_matmul_wgrad, k1_wgrad_plain, k1_wgrad_library,
            "torch.matmul", k1_wgrad_work, group=bwd_group, mode=nograd),
        "effnet_se_fwd": time_rows(
            f"K1 forward, EfficientNet-B7 SE (microbatch {mb})",
            expand(se_calls(ec["k1"], mb, "k1")), ops.elastic_matmul_op,
            k1_plain, k1_library, "torch.matmul", k1_work, group=k1_group),
        "effnet_se_dgrad": time_rows(
            f"K1 dgrad, EfficientNet-B7 SE (microbatch {mb})",
            expand(se_calls(ec["dgrad"], mb, "dgrad")),
            em.elastic_matmul_dgrad, k1_dgrad_plain, k1_dgrad_library,
            "torch.matmul", k1_dgrad_work, group=bwd_group, mode=nograd),
        "effnet_se_wgrad": time_rows(
            f"K1 wgrad, EfficientNet-B7 SE (microbatch {mb})",
            expand(se_calls(ec["wgrad"], mb, "wgrad")),
            em.elastic_matmul_wgrad, k1_wgrad_plain, k1_wgrad_library,
            "torch.matmul", k1_wgrad_work, group=bwd_group, mode=nograd)}
    del prof_r, prof_e, rc, ec
    torch.cuda.empty_cache()
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return out


# the diffusion nets (phase 23): the profiled step's rows, K2's kernels by
# name first (its backward's names hold no "dgrad"/"wgrad"), then K1's,
# cuDNN's and ATen's convolutions and the rest as phase 22 has them
DIFF_STEP_GROUPS = (("flash_attention_bwd", "K2 backward"),
                    ("flash_attention", "K2 forward")) + CONV_STEP_GROUPS
K2_KERNELS = ("flash_attention", "flash_attention_bwd")
DIFF_ARCHS = ("dit-l2", "unet-sdxl")
DIFF_KERNELS = K1_KERNELS + K2_KERNELS
# every bf16 call of a diffusion step on the kernels' Hopper variants; K2's
# forward on wgmma, and at the UNet's 8 x 8 latent (S = 64, self and
# cross) on mma, which measured faster there (phase 27 (b))
DIFF_VARIANTS = {("elastic_matmul", "tma"), ("elastic_matmul_dgrad", "tma"),
                 ("elastic_matmul_wgrad", "tma"), ("flash_attention", "wgmma"),
                 ("flash_attention_bwd", "resident")}
DIFF_K2_MMA = {"dit-l2": set(), "unet-sdxl": {("flash_attention", "mma")}}
# (b): fp32 denoiser outputs, kernel path against plain path, as a share
# of the largest |output| (24 DiT blocks, or the UNet's 70 transformer
# blocks and 22 res blocks, in fp32 with TF32 off); bf16 is held as phase
# 22 holds the conv nets' logits (CONV_BF16_FACTOR)
DIFF_FP32_TOL = 1e-3
DIFF_B = 4                   # (b)'s batch
# (c): UNet-SDXL's train_256 step of 256 as 8 microbatches of 32, the
# launcher's default on one card (``launch/train.py:ONE_CARD_ACCUM``): at
# the reference's 2 x 128, and at 4 x 64, the step does not fit in 80 GB
# (fp32 parameters, gradients and AdamW moments alone are 41 GB)
UNET_ACCUM = 8
# (d), (e): the sampler's final iterate and the gen_1024 outputs in bf16,
# kernel path against plain path, as a share of the largest value (each
# DDIM step divides by sqrt(alphas_bar[t]): 1/157 at t = 999)
DIFF_BF16_TOL = 5e-2


def ungate(tree, gen) -> None:
    """Draw the zero-init leaves (DiT's ``ada`` and ``final_ada``, the
    UNet's ``proj_out``) in place from a seeded normal, kernels at
    0.5/sqrt(fan_in) and biases at 0.1: at init they gate every block's
    output to exactly 0, and a comparison would check none of them."""
    import torch
    if isinstance(tree, list):
        for v in tree:
            ungate(v, gen)
        return
    for k, v in tree.items():
        if k in ("ada", "final_ada", "proj_out"):
            ker, b = v["kernel"], v["bias"]
            ker.copy_(torch.randn(ker.shape, generator=gen,
                                  device=ker.device) * ker.shape[0] ** -0.5
                      * 0.5)
            b.copy_(torch.randn(b.shape, generator=gen, device=b.device)
                    * 0.1)
        elif isinstance(v, (dict, list)):
            ungate(v, gen)


def diff_setup(arch_id: str, img_res: int, dev, seed: int = 1):
    """(arch, cfg at ``img_res``, fp32 parameters drawn on the card from
    ``seed`` with the gates drawn non-zero)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.dit import dit_init
    from repro_torch.models.unet import unet_init
    arch = get_arch(arch_id)
    cfg = dataclasses.replace(arch.make_config(), img_res=img_res)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = (dit_init if arch_id.startswith("dit") else unet_init)(
        gen, cfg, device=dev)
    with torch.no_grad():
        ungate(params, gen)
    return arch, cfg, params


def diff_inputs(arch_id: str, cfg, B: int, dev, seed: int = 2) -> tuple:
    """(latents (B, r, r, 4), t, cond) on the card from ``seed``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = cfg.latent_res
    lat = torch.randn((B, r, r, 4), generator=gen, device=dev)
    t = torch.randint(0, 1000, (B,), generator=gen, device=dev,
                      dtype=torch.int32)
    if arch_id.startswith("dit"):
        cond = {"y": torch.randint(0, cfg.n_classes, (B,), generator=gen,
                                   device=dev, dtype=torch.int32)}
    else:
        cond = {"ctx": torch.randn((B, 77, cfg.ctx_dim), generator=gen,
                                   device=dev),
                "pooled": torch.randn((B, cfg.pooled_dim), generator=gen,
                                      device=dev)}
    return lat, t, cond


def diff_batch(cfg, B: int, dev, step: int = 0) -> dict:
    """The launcher's seeded batch of ``step`` (``diffusionize`` of the
    label stream), on the card."""
    from repro_torch.data import to_device
    from repro_torch.launch import train as train_mod
    return to_device(next(train_mod.diffusion_batches(cfg, B, step)), dev)


def keep_calls(rec: dict, rename=None):
    """A ``recording`` sink that keeps each distinct call (by
    :func:`call_signature`) in ``rec[key]`` as [args, kw, count], the
    first call's tensors detached; ``rename(key, args)`` may file a call
    under another key."""
    import torch

    def sink(key, args, kw):
        if rename is not None:
            key = rename(key, args)
        sig = call_signature(key, args, kw)
        if sig in rec[key]:
            rec[key][sig][2] += 1
        else:
            rec[key][sig] = [tuple(a.detach() if isinstance(a, torch.Tensor)
                                   else a for a in args), dict(kw), 1]
    return sink


def diff_record(label: str, arch_id: str, cfg, params, mb: dict) -> dict:
    """Phase 23 (a)'s recording: one microbatch's loss and backward of
    the ``diff_train`` step (no update), every K1 forward, dgrad and
    wgrad and K2 forward and backward call kept by signature (the
    cross-attention's K2 calls, S != T, apart)."""
    import torch

    from repro_torch.core import layers as layers_mod
    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_diff_train_step
    from repro_torch.models import unet as unet_mod
    from repro_torch.optim.api import pop_grads

    rec = {k: {} for k in ("k1", "dgrad", "wgrad", "k2", "k2_bwd", "k2x",
                           "k2x_bwd")}

    def cross(key, args):
        if key in ("k2", "k2_bwd") and args[0].shape[1] != args[1].shape[1]:
            return key.replace("k2", "k2x")
        return key
    sink = keep_calls(rec, cross)
    step = make_diff_train_step(arch_id, cfg,
                                lambda p, g, o, s: (p, o), accum=1)
    with recording([(layers_mod, "elastic_matmul_op", "k1"),
                    (ops, "elastic_matmul_op", "k1"),
                    (em, "elastic_matmul_dgrad", "dgrad"),
                    (em, "elastic_matmul_wgrad", "wgrad"),
                    (layers_mod, "flash_attention_op", "k2"),
                    (unet_mod, "flash_attention_op", "k2x"),
                    (fa, "flash_attention_bwd", "k2_bwd")], sink):
        _, _, m = step(params, None, mb, 0)
        torch.cuda.synchronize()
    pop_grads(params)
    if not math.isfinite(float(m["loss"])):
        raise AssertionError(f"{label}: recorded loss {float(m['loss'])}")
    log(f"  {label}: loss {float(m['loss']):.4f}; calls "
        f"{ {k: sum(n for *_, n in v.values()) for k, v in rec.items()} }, "
        f"distinct { {k: len(v) for k, v in rec.items()} }")
    return rec


def k2_recorded_checks(label: str, rec: dict) -> dict:
    """Phase 23 (a) for K2: its forward and backward against their plain
    versions at every distinct recorded call, bf16 as recorded (the
    cross-attention's apart); the forward within tolerance, each gradient
    within tolerance of its largest value; one launch per comparison.
    Returns {key: worst error}."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    tol = ATTN_TOL["bfloat16"]
    out = {}
    for key in ("k2", "k2x", "k2_bwd", "k2x_bwd"):
        name = "flash_attention_bwd" if key.endswith("bwd") \
            else "flash_attention"
        before = ops.launch_counts()[name]
        was = dict(ops.variant_counts()[name])
        worst = 0.0
        for args, kw, n in rec[key].values():
            with torch.no_grad():
                if name == "flash_attention":
                    want = k2_plain(*args, **kw)
                    got = ops.flash_attention_op(*args, **kw)
                    torch.cuda.synchronize()
                    err = close(got, want, tol)
                else:
                    q, k, v, o, lse, do = args
                    want = fa.flash_attention_bwd_plain(q, k, v, o, do,
                                                        causal=False)
                    got = fa.flash_attention_bwd(*args, **kw)
                    torch.cuda.synchronize()
                    err = max(close_to_largest(a, b, tol)
                              for a, b in zip(got, want))
            worst = max(worst, err)
            what = ("max abs err" if name == "flash_attention"
                    else "of the largest gradient")
            log(f"  {label}: {key:7s} q {tuple(args[0].shape)} k "
                f"{tuple(args[1].shape)} (x{n} in the step): {what} "
                f"{err:.3g} (tol {tol})")
            del want, got
        ran = ops.launch_counts()[name] - before
        if ran != len(rec[key]):
            raise AssertionError(f"{label} {key}: {ran} launches in "
                                 f"{len(rec[key])} comparisons")
        took = {v: c - was[v] for v, c in ops.variant_counts()[name].items()
                if c != was[v]}
        out[key] = {"err": worst, "variants": took, "calls": len(rec[key])}
    return out


def p3_check(dev) -> dict:
    """Phase 23 (p), run before the script turns TF32 off for the
    process: an fp32 3x3 conv of the UNet-smoke config (32 -> 64
    channels, batch 2 at 8 x 8) under torch's default cuDNN flags (TF32
    on), its dx and dw against a float64 conv on the CPU, through
    ``conv_apply`` (the port's fp32 conv Function) and, for comparison,
    through autograd of a plain ``F.conv2d``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import layers as L
    t0 = phase("23. (p) P3: an fp32 3x3 conv's backward on the card under "
               "torch's default cuDNN flags (TF32 on)")
    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("cuDNN's TF32 is not at torch's default (on)")
    g = torch.Generator().manual_seed(21)
    w = torch.randn(3, 3, 32, 64, generator=g) / 17.0
    x = torch.randn(2, 8, 8, 32, generator=g)
    dy = torch.randn(2, 8, 8, 64, generator=g)

    def grads(dev_, dt, plain=False):
        ww = w.to(dev_, dt).requires_grad_()
        xx = x.to(dev_, dt).requires_grad_()
        if plain:
            y = F.conv2d(xx.permute(0, 3, 1, 2), ww.permute(3, 2, 0, 1),
                         padding=1).permute(0, 2, 3, 1)
        else:
            y = L.conv_apply({"kernel": ww}, xx)
        return [a.double().cpu() for a in torch.autograd.grad(
            y, (xx, ww), dy.to(dev_, dt))]
    want = grads("cpu", torch.float64)
    out = {}
    for name, plain in (("conv_apply (the port)", False),
                        ("autograd of F.conv2d", True)):
        got = grads(dev, torch.float32, plain)
        out[name] = [float((a - b).abs().max() / b.abs().max())
                     for a, b in zip(got, want)]
    port = max(out["conv_apply (the port)"])
    log(f"  dx, dw of the largest value from a float64 conv: "
        + "; ".join(f"{k} {v[0]:.3g}, {v[1]:.3g}" for k, v in out.items())
        + f" (the port's within 1e-4: TF32's 10 mantissa bits give ~1e-3)")
    if not port <= 1e-4:
        raise AssertionError(f"P3: the fp32 conv's backward is {port:.3g} "
                             f"off float64 under the default flags")
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return {"port": out["conv_apply (the port)"],
            "plain_autograd": out["autograd of F.conv2d"]}


def k2_small_d_checks(dev) -> float:
    """Phase 23 (k): K2's fp32 backward at the smoke configs' head dims
    8 and 16 (DiT-smoke, UNet-smoke self- and cross-attention) against
    the plain backward, each one launch on fma_f32."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    t0 = phase("23. (k) K2's fp32 backward at head dims 8 and 16 vs plain")
    g = torch.Generator().manual_seed(23)
    worst = 0.0
    for D, S, T, H, KH in ((8, 16, 16, 4, 4), (16, 16, 16, 4, 4),
                           (16, 16, 77, 4, 4), (8, 100, 37, 6, 2),
                           (16, 197, 197, 4, 4)):
        q = (torch.randn(3, S, H, D, generator=g) * 0.5).to(dev)
        k = (torch.randn(3, T, KH, D, generator=g) * 0.5).to(dev)
        v = torch.randn(3, T, KH, D, generator=g).to(dev)
        do = torch.randn(3, S, H, D, generator=g).to(dev)
        o, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
        was = fa.bwd_variant_launches["fma_f32"]
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
        want = fa.flash_attention_bwd_plain(q, k, v, o, do, causal=False)
        torch.cuda.synchronize()
        if fa.bwd_variant_launches["fma_f32"] - was != 1:
            raise AssertionError(f"K2 backward D {D}: not one fma_f32 "
                                 f"launch")
        err = max(close(a, b, ATTN_TOL["float32"]) for a, b in zip(got,
                                                                    want))
        worst = max(worst, err)
        log(f"  D {D:2d} S {S:3d} T {T:3d} H {H}/{KH}: dq, dk, dv max abs "
            f"err {err:.3g} (tol {ATTN_TOL['float32']}) on fma_f32")
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return worst


def diff_outputs(arch_id: str, cfg, params, dev) -> dict:
    """Phase 23 (b): the full-size denoiser's output, kernel path against
    plain path, at batch ``DIFF_B``: fp32 (TF32 off) within
    ``DIFF_FP32_TOL`` of the largest |output|; bf16 no farther from the
    fp32 plain output than twice the plain path's bf16 output is (plus
    the bf16 tolerance)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import diff_denoise
    lat, t, cond = diff_inputs(arch_id, cfg, DIFF_B, dev)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        yk = diff_denoise(arch_id, cfg32)(params, lat, t, cond)
        with ops.plain_kernels():
            yp = diff_denoise(arch_id, cfg32)(params, lat, t, cond)
        e32 = close_to_largest(yk, yp, DIFF_FP32_TOL)
        yk16 = diff_denoise(arch_id, cfg)(params, lat, t, cond)
        with ops.plain_kernels():
            yp16 = diff_denoise(arch_id, cfg)(params, lat, t, cond)
    scale = max(float(yp.abs().max()), 1e-30)
    ek, ep = (float((y.float() - yp).abs().max()) / scale
              for y in (yk16, yp16))
    if not torch.isfinite(yk16).all() or \
            not ek <= CONV_BF16_FACTOR * ep + TOL["bfloat16"]:
        raise AssertionError(f"{arch_id}: the kernel path's bf16 output "
                             f"{ek:.3g} of the largest fp32 value from the "
                             f"fp32 one, the plain path's {ep:.3g}")
    e16 = float((yk16.float() - yp16.float()).abs().max()) / scale
    log(f"  {arch_id}: output {tuple(yk.shape)}, largest |value| "
        f"{scale:.4g}; fp32 kernel vs plain path {e32:.3g} of it (tol "
        f"{DIFF_FP32_TOL}); bf16 kernel vs plain path {e16:.3g}; from the "
        f"fp32 output: kernel path {ek:.3g}, plain path {ep:.3g} (kernel at "
        f"most {CONV_BF16_FACTOR:g} x plain + {TOL['bfloat16']})")
    return {"fp32_rel_err": e32, "bf16_rel_err": e16,
            "bf16_kernel_from_fp32": ek, "bf16_plain_from_fp32": ep}


def train_run(title: str, argv: list, restarts: int, repeat: tuple,
              kernels: tuple, need: set, per_step: int, unit: str, dev,
              repeat_tol: float = 0.0) -> dict:
    """A training launcher on the card (phases 23 (c) and 24 (d)): finite
    losses, ``restarts`` restarts, the step run again after the restart
    (losses ``repeat``; None: no restart) within ``repeat_tol`` of its
    first run (relative; 0: the same bits), every counter of ``kernels`` rising, no other
    kernel, every bf16 call on the Hopper variants (``need``); the median
    step, ``unit``/s at ``per_step`` a step, peak memory."""
    import shutil
    import tempfile

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.optim.api import named_leaves

    t0 = phase(f"{title}: python -m repro_torch.launch.train "
               f"{' '.join(argv)}")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ops.reset_launch_counts()
    try:
        res = train_mod.main(argv + ["--ckpt-dir", ckpt, "--log-every", "1",
                                     "--device", "cuda"])
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    launches, variants = ops.launch_counts(), ops.variant_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = res["losses"]
    if res["restarts"] != restarts:
        raise AssertionError(f"{res['restarts']} restarts, want {restarts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    first, again = (None, None) if repeat is None else (
        losses[repeat[0]], losses[repeat[1]])
    if repeat is not None and not abs(first - again) <= repeat_tol * abs(
            first):
        raise AssertionError(f"the step run again after the restart: loss "
                             f"{again!r}, its first run {first!r}")
    for _, p in named_leaves(res["params"]):
        if not torch.isfinite(p).all():
            raise AssertionError("non-finite parameters after training")
    idle = [k for k in kernels if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels not launched: {idle}")
    other = {k: n for k, n in launches.items() if n and k not in kernels}
    if other:
        raise AssertionError(f"other kernels launched: {other}")
    main_path_variants(variants, need)
    steady = res["step_ms"][1:] or res["step_ms"]
    n_params = sum(p.numel() for _, p in named_leaves(res["params"]))
    out = {"step_ms": statistics.median(steady), "params": n_params,
           "step_ms_all": res["step_ms"], "losses": losses,
           "resumed_loss_diff": None if repeat is None else again - first,
           f"{unit}_per_s": per_step / statistics.median(steady) * 1e3,
           "peak_gib": peak / 2**30, "peak_run_gib": (peak - base) / 2**30,
           "launches": {k: launches[k] for k in kernels},
           "variants": {k: variants[k] for k in kernels}}
    log(f"  {n_params / 1e6:.2f} M parameters; {len(res['step_ms'])} steps "
        f"run, {res['restarts']} restarts; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}"
        + ("" if repeat is None else f"; the step run again after the "
           f"restart: {again!r} against {first!r} first"))
    log(f"  step: median {out['step_ms']:.1f} ms after the first (all: "
        f"{', '.join(f'{x:.1f}' for x in res['step_ms'])} ms), "
        f"{out[f'{unit}_per_s']:.1f} {unit}/s; peak device memory "
        f"{out['peak_gib']:.2f} GiB ({out['peak_run_gib']:.2f} GiB above "
        f"the {base / 2**30:.2f} GiB allocated before)")
    log(f"  launches {out['launches']}; by variant {out['variants']}")
    del res
    torch.cuda.empty_cache()
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return out


def diff_train(label: str, argv: list, restarts: int, repeat: tuple,
               dev) -> dict:
    """Phase 23 (c): :func:`train_run` of a diffusion net at batch 256,
    K1's and K2's five counters, the repeated step within 1e-6."""
    need = DIFF_VARIANTS | DIFF_K2_MMA[argv[argv.index("--arch") + 1]]
    return train_run(f"23. {label}", argv, restarts, repeat, DIFF_KERNELS,
                     need, 256, "images", dev, repeat_tol=1e-6)


def profiled_step(fn, groups, step_ms: float, model_flops: float,
                  warmup: bool = True) -> dict:
    """One profiled training step, fn() (phases 23 (c) and 24 (d)):
    device time by kernel group (:func:`step_breakdown`), the busy share
    over the launcher's median step ``step_ms`` and the model-FLOPs rate
    against the bf16 dense peak, logged."""
    try:
        bd = step_breakdown(fn, groups, warmup=warmup)
    except NoTrace as e:
        bd = None
        log(f"  step breakdown not measured: {e}")
    rate = model_flops / (step_ms / 1e3)
    out = {"model_tflop": model_flops / 1e12, "step_ms": step_ms,
           "model_tflops": rate / 1e12,
           "model_flops_share": rate / PEAK_BF16_FLOPS}
    if bd is not None:
        bd.update(busy=bd["device_ms"] / step_ms,
                  busy_profiled=bd["device_ms"] / bd["wall_ms"])
        log(f"  one step: device time in kernels {bd['device_ms']:.1f} ms, "
            f"busy {bd['busy']:.0%} of the launcher's median step "
            f"{step_ms:.1f} ms ({bd['busy_profiled']:.0%} of the profiled "
            f"step's wall {bd['wall_ms']:.1f} ms): " + ", ".join(
                f"{k} {v:.1f}" for k, v in sorted(
                    bd["groups"].items(), key=lambda kv: -kv[1])))
        for row, ks in bd["group_top"].items():
            log(f"    {row}: " + "; ".join(f"{n} {ms:.1f} ms x{c}"
                                          for n, ms, c in ks))
        log("    other kernels: " + "; ".join(
            f"{n} {ms:.1f} ms x{c}" for n, ms, c in bd["other_top"][:4]))
    log(f"  model FLOPs {model_flops / 1e12:.2f} TFLOP a step "
        f"(launch/flops.py): {rate / 1e12:.1f} TFLOP/s over the median "
        f"step, {rate / PEAK_BF16_FLOPS:.1%} of the "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 dense peak")
    out["breakdown"] = bd
    return out


def diff_profile(arch_id: str, accum: int, step_ms: float, dev) -> dict:
    """Phase 23 (c)'s profiled step: :func:`profiled_step` of one
    ``diff_train`` step at train_256 (batch 256 as ``accum``
    microbatches)."""
    import torch

    from repro_torch.launch import flops
    from repro_torch.launch import train as train_mod
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_diff_train_step
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.api import named_leaves

    arch = get_arch(arch_id)
    shape = arch.shape("train_256")
    cfg = dataclasses.replace(arch.make_config(), img_res=shape.img_res)
    B = shape.global_batch
    t0 = phase(f"23. (c) {arch_id}: one profiled step (batch {B}, accum "
               f"{accum})")
    params = train_mod.init_params(arch, cfg, dev)
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    init_fn, update_fn = make_optimizer(arch.optimizer)
    opt = init_fn(params)
    step_fn = make_diff_train_step(arch_id, cfg, update_fn, accum)
    batch = diff_batch(cfg, B, dev)
    out = profiled_step(lambda: step_fn(params, opt, batch, 0),
                        DIFF_STEP_GROUPS, step_ms,
                        flops.model_flops(arch, cfg, shape))
    del params, opt, batch
    torch.cuda.empty_cache()
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return out


def diff_sample(arch_id: str, shape_name: str, dev) -> dict:
    """Phase 23 (d) and (e): at ``gen_fast`` the DDIM sampler (its step
    count, batch and resolution), at ``gen_1024`` one denoiser call, on
    the kernels and on the plain path, bf16: every value finite, the
    kernel path within ``DIFF_BF16_TOL`` of the plain path's largest
    value; the kernel path's time (CUDA events) and K2's forward
    variants."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import diff_denoise
    from repro_torch.models import diffusion as diff
    shape = get_arch(arch_id).shape(shape_name)
    arch, cfg, params = diff_setup(arch_id, shape.img_res, dev)
    B = shape.global_batch
    lat, _, cond = diff_inputs(arch_id, cfg, B, dev, seed=3)
    denoise = diff_denoise(arch_id, cfg)
    sched = diff.make_schedule(device=dev)
    steps = shape.steps if shape_name == "gen_fast" else 1

    def run():
        if shape_name == "gen_fast":
            return diff.ddim_loop(lambda x, t: denoise(params, x, t, cond),
                                  sched, lat, steps=steps)
        t = torch.full((B,), 999, dtype=torch.int32, device=dev)
        return denoise(params, lat, t, cond)
    with torch.inference_mode():
        was = dict(ops.variant_counts()["flash_attention"])
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        run()                                  # first use: cuDNN plans
        torch.cuda.synchronize()
        start.record()
        xk = run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        took = {v: c - was[v] for v, c in
                ops.variant_counts()["flash_attention"].items()
                if c != was[v]}
        with ops.plain_kernels():
            xp = run()
        err = close_to_largest(xk, xp, DIFF_BF16_TOL)
    what = (f"DDIM {steps} steps" if shape_name == "gen_fast"
            else "one denoiser call")
    log(f"  {arch_id} {shape_name} ({shape.img_res} px, latent "
        f"{cfg.latent_res}, batch {B}): {what}, {ms:.1f} ms on the "
        f"kernels (CUDA events, after one warm-up run); output "
        f"{tuple(xk.shape)} finite, largest |value| "
        f"{float(xp.float().abs().max()):.4g}, kernel vs plain path "
        f"{err:.3g} of it (tol {DIFF_BF16_TOL}); K2 forward launches by "
        f"variant {took}")
    del params
    torch.cuda.empty_cache()
    return {"ms": ms, "rel_err": err, "k2_variants": took,
            "steps": steps, "batch": B, "img_res": shape.img_res}


def diffusion_phases(dev, parent) -> dict:
    """Phase 23: the diffusion nets at full width on the card.  Returns
    what the kernels' record needs.  ``parent``: the parent commit's
    kernels to time beside K2's forward, or None."""
    import torch

    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import ops
    from repro_torch.optim.api import named_leaves

    from repro_torch.launch.train import ONE_CARD_ACCUM
    if ONE_CARD_ACCUM.get(("unet-sdxl", "train_256")) != UNET_ACCUM:
        raise AssertionError("the launcher's UNet-SDXL accum is not "
                             f"{UNET_ACCUM}")
    torch.cuda.empty_cache()
    log(f"\n(device memory allocated before phase 23: "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB)")
    out = {"k2_small_d_err": k2_small_d_checks(dev), "recorded": {},
           "rows": {}, "outputs": {}}
    nograd = torch.no_grad
    for arch_id, name, mb in (("dit-l2", "DiT-L/2 step", 256),
                              ("unet-sdxl", "UNet-SDXL microbatch",
                               256 // UNET_ACCUM)):
        key = arch_id.split("-")[0]
        t0 = phase(f"23. (a) {arch_id}: K1 and K2 vs plain at every "
                   f"distinct call of one recorded {name} ({mb} images, "
                   f"train_256, bf16), then their times over it "
                   f"(graph-replayed device time); (b) the full-size "
                   f"denoiser's output, kernel path vs plain path")
        arch, cfg, params = diff_setup(arch_id, 256, dev)
        for _, p in named_leaves(params):
            p.requires_grad_(True)
        rec = diff_record(name, arch_id, cfg, params,
                          diff_batch(cfg, mb, dev))
        out["recorded"][key] = {"k1": k1_recorded_checks(name, rec),
                                "k2": k2_recorded_checks(name, rec)}
        rows = {
            "fwd": time_rows(f"K1 forward, {name}", expand(rec["k1"]),
                             ops.elastic_matmul_op, k1_plain, k1_library,
                             "torch.matmul", k1_work, group=k1_group),
            "dgrad": time_rows(f"K1 dgrad, {name}", expand(rec["dgrad"]),
                               em.elastic_matmul_dgrad, k1_dgrad_plain,
                               k1_dgrad_library, "torch.matmul",
                               k1_dgrad_work, group=bwd_group, mode=nograd),
            "wgrad": time_rows(f"K1 wgrad, {name}", expand(rec["wgrad"]),
                               em.elastic_matmul_wgrad, k1_wgrad_plain,
                               k1_wgrad_library, "torch.matmul",
                               k1_wgrad_work, group=bwd_group, mode=nograd),
            "k2": time_rows(f"K2 forward (self-attention), {name}",
                            expand(rec["k2"]), ops.flash_attention_op,
                            k2_plain, k2_library, "sdpa", k2_work,
                            parent and (parent["k2"], parent["libs"]),
                            group=k2_group),
            "k2_bwd": time_rows(f"K2 backward (self-attention), {name}",
                                expand(rec["k2_bwd"]), k2_bwd_kernel,
                                k2_bwd_plain, SdpaBackward(),
                                "sdpa backward", k2_bwd_work, mode=nograd)}
        if rec["k2x"]:
            rows["k2x"] = time_rows(
                f"K2 forward (cross-attention, 77 keys), {name}",
                expand(rec["k2x"]), ops.flash_attention_op, k2_plain,
                k2_library, "sdpa", k2_work,
                parent and (parent["k2"], parent["libs"]), group=k2_group)
            rows["k2x_bwd"] = time_rows(
                f"K2 backward (cross-attention, 77 keys), {name}",
                expand(rec["k2x_bwd"]), k2_bwd_kernel, k2_bwd_plain,
                SdpaBackward(), "sdpa backward", k2_bwd_work, mode=nograd)
        out["rows"][key] = rows
        del rec
        for _, p in named_leaves(params):
            p.requires_grad_(False)
        out["outputs"][arch_id] = diff_outputs(arch_id, cfg, params, dev)
        del params
        torch.cuda.empty_cache()
        log(f"  ({time.perf_counter() - t0:.1f} s)")
    out["dit"] = diff_train(
        "(c) DiT-L/2, full width and depth, train_256 batch 256, bf16; 6 "
        "steps, a checkpoint every 3, a failure injected at step 5",
        ["--arch", "dit-l2", "--steps", "6", "--save-every", "3",
         "--fail-at", "5"], 1, (4, 5), dev)
    out["unet"] = diff_train(
        f"(c) UNet-SDXL, full width and depth, train_256 batch 256 as "
        f"{UNET_ACCUM} microbatches of {256 // UNET_ACCUM}, bf16; 2 steps, "
        f"no checkpoint (41 GB of state), a failure injected at step 1 and "
        f"a restart from step 0",
        ["--arch", "unet-sdxl", "--steps", "2", "--save-every", "0",
         "--fail-at", "1"], 1, (0, 1), dev)
    out["breakdown"] = {
        "dit-l2": diff_profile("dit-l2", 1, out["dit"]["step_ms"], dev),
        "unet-sdxl": diff_profile("unet-sdxl", UNET_ACCUM,
                                  out["unet"]["step_ms"], dev)}
    t0 = phase("23. (d) DDIM at gen_fast (512 px, batch 16, 4 steps) and "
               "(e) one denoiser call at gen_1024 (1024 px, batch 4: K2's "
               "forward at 4096 tokens), kernel path vs plain path, bf16")
    out["sample"] = {f"{a}/{s}": diff_sample(a, s, dev)
                     for s in ("gen_fast", "gen_1024") for a in DIFF_ARCHS}
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return out


# ---------------------------------------------------------------- phase 24

# the LM's train_4k step on one card: the launcher's cuts (checked against
# launch/train.py's tables), its steps in (d), and its kernels
LM_TRAIN_ARCH, LM_TRAIN_SHAPE = "deepseek-moe-16b", "train_4k"
LM_TRAIN_ACCUM = 64           # 256 x 4096 as 64 microbatches of 4
LM_TRAIN_CUT = {"n_layers": 4}     # 1 dense + 3 MoE layers, full width
LM_TRAIN_STEPS = 2          # no failure: the LM restarts in phase 29 (a)
# K2's backward against its plain version, of the largest gradient (bf16:
# the kernel rounds P and dS to bf16 for its products); K3's dgrad and
# wgrad of the largest value (bf16 outputs; fp32 sums in both)
K2_BWD_TOL = {"bfloat16": 1e-2, "float32": 3e-3}
K3_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# (c): the smoke step in fp32, kernel route against plain route: the loss
# relative, the gradient norm relative, and each updated parameter as the
# CPU test holds the port to the reference (1e-3 of the learning rate
# where AdamW's first |u| >= 0.99, else the learning rate)
LM_SMOKE_LOSS_TOL, LM_SMOKE_GNORM_TOL, LM_LR = 1e-5, 1e-4, 1e-4
LM_TRAIN_KERNELS = ("elastic_matmul", "flash_attention", "expert_matmul",
                    "elastic_matmul_dgrad", "elastic_matmul_wgrad",
                    "flash_attention_bwd", "expert_matmul_dgrad",
                    "expert_matmul_wgrad")
# every bf16 call of the LM step on the Hopper variants (the fp32 router's
# forward on f32_splitk, its backward on fma_f32)
LM_TRAIN_VARIANTS = {("elastic_matmul", "tma"),
                     ("elastic_matmul", "f32_splitk"),
                     ("flash_attention", "wgmma"), ("expert_matmul", "tma"),
                     ("elastic_matmul_dgrad", "tma"),
                     ("elastic_matmul_wgrad", "tma"),
                     ("flash_attention_bwd", "wgmma"),
                     ("expert_matmul_dgrad", "persistent"),
                     ("expert_matmul_wgrad", "persistent")}
LM_STEP_GROUPS = (
    ("expert_tma_kernel<1>", "K3 dgrad"), ("expert_dgrad", "K3 dgrad"),
    ("expert_wgrad", "K3 wgrad"), ("expert_", "K3 forward"),
    ("flash_attention_bwd", "K2 backward"),
    ("flash_attention", "K2 forward")) + CONV_STEP_GROUPS[:11] + tuple(
    (frag, "MoE dispatch (index, scatter, gather, sort, top-k)")
    for frag in ("index", "Index", "scatter", "gather", "sort", "Sort",
                 "topk", "TopK", "scan", "Scan")) + tuple(
    (frag, "norms, elementwise and reductions")
    for frag in ("elementwise", "reduce", "Reduce", "softmax", "SoftMax"))


def errs_of(got, want, tol: float) -> tuple:
    """(max abs err, that of the largest value) of a tensor or of a tuple
    of them (dq, dk, dv: of the largest gradient of the three, since at a
    single key dq and dk are round-off of 0); raises unless the second is
    within ``tol`` and every value is finite."""
    import torch
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err, scale, finite = 0.0, 1e-30, True
    for a, b in zip(got, want):
        for x, y in _chunks(a, b):
            err = max(err, float((x - y).abs().max()))
            scale = max(scale, float(y.abs().max()))
            finite = finite and bool(torch.isfinite(x).all())
    if not finite or not err <= tol * scale:
        raise AssertionError(f"max abs err {err:.3g}, {err / scale:.3g} of "
                             f"the largest value {scale:.3g}, beyond "
                             f"tolerance {tol}")
    return err, err / scale


K2_BWD_SIZES = (1, 63, 64, 65, 127, 129, 257, 4095, 4096)


def k2_bwd_cases(dev) -> dict:
    """Phase 24 (a), random half: K2's backward against its plain version
    (o and the logsumexp from the plain forward), causal and not, bf16 at
    D = 64 and 128, fp32 at D = 8, 16 and 64, S = T in K2_BWD_SIZES
    (ragged against wgmma's 64-query chunks and 128-key tiles), GQA R =
    2; each comparison one launch on the variant its shape and dtype
    choose (bf16: resident for non-causal D = 64 at S <= 256, else
    wgmma)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(24)
    worst = {}
    for dtype, dims in ((torch.bfloat16, (64, 128)),
                        (torch.float32, (8, 16, 64))):
        dt = str(dtype).split(".")[1]
        tol = K2_BWD_TOL[dt]
        for D in dims:
            for causal in (False, True):
                errs, took = [], []
                for S in K2_BWD_SIZES:
                    B, H, KH = (1, 4, 2) if S >= 4095 else (2, 4, 2)
                    q, do = (torch.randn((B, S, H, D), generator=g,
                                         device=dev).to(dtype)
                             for _ in range(2))
                    k, v = (torch.randn((B, S, KH, D), generator=g,
                                        device=dev).to(dtype)
                            for _ in range(2))
                    o, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                                      return_lse=True)
                    o = o.to(dtype).contiguous()
                    want_v = ("fma_f32" if dtype == torch.float32 else
                              "resident" if not causal and D == 64
                              and S <= fa.RESIDENT_MAX else "wgmma")
                    before = ops.launch_counts()["flash_attention_bwd"]
                    was = fa.bwd_variant_launches[want_v]
                    got = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=causal)
                    want = fa.flash_attention_bwd_plain(q, k, v, o, do,
                                                        causal=causal)
                    torch.cuda.synchronize()
                    if ops.launch_counts()["flash_attention_bwd"] - before \
                            != 1 or fa.bwd_variant_launches[want_v] - was \
                            != 1:
                        raise AssertionError(f"K2 backward {dt} D={D} S={S} "
                                             f"causal={causal}: not one "
                                             f"launch of {want_v}")
                    errs.append(errs_of(got, want, tol))
                    took.append(want_v)
                    del q, k, v, o, lse, do, got, want
                worst[(dt, D, causal)] = tuple(map(max, zip(*errs)))
                log(f"  K2 backward {dt:8s} D={D:3d} causal={causal!s:5s} "
                    f"S = T in {K2_BWD_SIZES}, GQA R = 2: "
                    f"{', '.join(f'{e[1]:.3g}' for e in errs)} of the "
                    f"largest gradient (tol {tol}) on "
                    f"{', '.join(took)}")
    return worst


def k3_bwd_cases(dev) -> dict:
    """Phase 24 (b), edge half: K3's dgrad and wgrad against their plain
    versions, bf16 and fp32, at the LM's expert shapes (up 2048 -> 1408,
    down 1408 -> 2048) with C = 480 (one sequence's slab), 16 and 17;
    E = 1; counts all 0, all C and ragged (0, 1, a partial box, C - 1,
    C); NaN in x and dy past every count; the expert width (a_ff) and
    count (slice_e) as strided views of the full weights (F = 128 too:
    half of the persistent wgrad's 256-column item), x as a strided view;
    the dense oracle's stride-0 expert axis; in bf16 at C 16 and 17, 513
    experts (more than the persistent kernels' prologues hold).  dgrad
    exact zeros past the counts, a dead expert's dw exactly 0; each
    comparison one launch on the variant it should take (bf16: dgrad and
    wgrad on persistent, tma past 512 experts, tile_bf16 for the stride-0
    expert axis)."""
    import torch

    from repro_torch.kernels import expert_matmul as xm
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(25)
    E, d, Fe = 64, 2048, 1408

    def rn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[1]
        tol = K3_BWD_TOL[dt]
        wi = rn(E, d, Fe, dtype=dtype, scale=d ** -0.5)
        wo = rn(E, Fe, d, dtype=dtype, scale=Fe ** -0.5)
        # the only bf16 calls the tma kernels take: more than 512 experts
        E_big = xm.PERSISTENT_E_MAX + 1
        w_big = rn(E_big, d, Fe, dtype=dtype, scale=d ** -0.5) \
            if dtype == torch.bfloat16 else None
        for C in (480, 16, 17):
            ragged = torch.tensor([0, 1, C // 3, C - 1, C, 63 % (C + 1),
                                   65 % (C + 1), C // 2] * (E // 8),
                                  dtype=torch.int32, device=dev)
            cases = [("ragged", ragged, wi, None),
                     ("all 0", torch.zeros_like(ragged), wi, None),
                     ("all C", torch.full_like(ragged, C), wi, None),
                     ("down", ragged, wo, None),
                     ("a_ff 1056 view", ragged, wi[..., :1056], None),
                     ("down a_ff 704 view", ragged, wo[:, :704], None),
                     ("F 128 view", ragged, wi[..., :128], None),
                     ("slice_e 32 view", ragged[:32], wi[:32], None),
                     ("E=1", ragged[3:4], wi[:1], None),
                     ("strided x", ragged, wi, "strided"),
                     ("stride-0 experts", torch.full_like(ragged, C), wi,
                      "expand")]
            if w_big is not None and C < 480:
                cases.append((f"E={E_big}", ragged.repeat(
                    -(-E_big // E))[:E_big], w_big, None))
            for label, counts, w, how in cases:
                Ee, K, F_ = w.shape
                live = (torch.arange(C, device=dev)[None, :]
                        < counts[:, None])[..., None]
                nan = torch.full((), float("nan"), dtype=dtype, device=dev)
                dy = torch.where(live, rn(Ee, C, F_, dtype=dtype), nan)
                if how == "expand":
                    x = rn(1, C, K, dtype=dtype).expand(Ee, C, K)
                elif how == "strided":      # rows of K + 64, read in place
                    x = torch.where(live, rn(Ee, C, K + 64, dtype=dtype),
                                    nan)[..., :K]
                else:
                    x = torch.where(live, rn(Ee, C, K, dtype=dtype), nan)
                for kind, fn, args, a in (
                        ("dgrad", xm.expert_matmul_dgrad, (dy, w, counts),
                         w),
                        ("wgrad", xm.expert_matmul_wgrad, (x, dy, counts),
                         x)):
                    want_v = xm.bwd_variant_of(a, dy, kind)
                    if dtype == torch.bfloat16 and want_v != (
                            "tile_bf16" if a.stride(0) == 0 else "tma"
                            if Ee > xm.PERSISTENT_E_MAX else "persistent"):
                        raise AssertionError(f"K3 {kind} {label}: chose "
                                             f"{want_v}")
                    name = f"expert_matmul_{kind}"
                    before = ops.launch_counts()[name]
                    was = ops.variant_counts()[name][want_v]
                    got = fn(*args)
                    plain = getattr(xm, f"{name}_plain")(*args)
                    torch.cuda.synchronize()
                    if ops.launch_counts()[name] - before != 1 or \
                            ops.variant_counts()[name][want_v] - was != 1:
                        raise AssertionError(f"K3 {kind} {label}: not one "
                                             f"launch of {want_v}")
                    if not bool((plain == 0).all()):
                        err = errs_of(got, plain, tol)
                    elif not bool((got == 0).all()):
                        raise AssertionError(f"K3 {kind} {label}: non-zero "
                                             f"where nothing is live")
                    else:
                        err = (0.0, 0.0)
                    if kind == "dgrad" and not bool(
                            (got.masked_select(~live) == 0).all()):
                        raise AssertionError(f"K3 dgrad {label}: non-zero "
                                             f"past the counts")
                    if kind == "wgrad" and not bool(
                            (got[counts == 0] == 0).all()):
                        raise AssertionError(f"K3 wgrad {label}: a dead "
                                             f"expert's dw is not 0")
                    key = (dt, kind, want_v)
                    worst[key] = tuple(map(max, zip(worst.get(key, err),
                                                    err)))
                del x, dy
        del wi, wo, w_big
    for (dt, kind, v), e in sorted(worst.items()):
        which = (f"E = {xm.PERSISTENT_E_MAX + 1} at C 16 and 17" if v == "tma"
                 else "C in (480, 16, 17) x (ragged, all 0, all C, down, "
                 "a_ff, F 128 and slice_e views, E = 1, strided x, "
                 "stride-0 experts)")
        log(f"  K3 {kind} {dt:8s} on {v:9s}: {which}, NaN past every count: "
            f"{e[1]:.3g} of the largest value, max abs err {e[0]:.3g} "
            f"(tol {K3_BWD_TOL[dt]}); dgrad zeros past the counts, dead "
            f"experts' dw 0")
    return worst


def k3_dgrad_work(args, kw) -> tuple:
    """dy's live rows and the live experts' weights read, dx written;
    2 K F a live row."""
    import torch
    dy, w, c = args
    Ee, C, F_ = dy.shape
    K = w.shape[1]
    live = c.clamp(max=C).long()
    rows, experts = int(live.sum()), int((live > 0).sum())
    peak = PEAK_BF16_FLOPS if dy.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return (dy.element_size() * (rows * F_ + experts * K * F_ + Ee * C * K),
            2 * rows * K * F_, peak)


def k3_wgrad_work(args, kw) -> tuple:
    """x's and dy's live rows read, dw written; 2 K F a live row."""
    import torch
    x, dy, c = args
    Ee, C, K = x.shape
    F_ = dy.shape[2]
    rows = int(c.clamp(max=C).long().sum())
    peak = PEAK_BF16_FLOPS if x.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return (x.element_size() * (rows * (K + F_) + Ee * K * F_),
            2 * rows * K * F_, peak)


def k3_dgrad_group(args, kw) -> str:
    """A K3 dgrad call's dx width and dy's, for the breakdown."""
    _, w, _ = args
    return f"dx width {w.shape[1]}, dy width {w.shape[2]}"


def k3_wgrad_group(args, kw) -> str:
    """A K3 wgrad call's dw shape, for the breakdown."""
    x, dy, _ = args
    return f"dw {x.shape[2]} x {dy.shape[2]}"


def k3_dgrad_library(dy, w, c):
    """The yardstick: one torch.bmm over the slabs (the port never calls
    it; it reads every row, live or not)."""
    import torch
    return torch.bmm(dy, w.transpose(1, 2))


def k3_wgrad_library(x, dy, c):
    import torch
    return torch.bmm(x.transpose(1, 2), dy)


def lm_train_batch(B: int, S: int, vocab: int, dev, step: int = 0) -> dict:
    """The launcher's step-``step`` batch of ``synthetic_lm_batches``, on
    the card."""
    from repro_torch.data import synthetic_lm_batches, to_device
    it = synthetic_lm_batches(global_batch=B, seq_len=S, vocab=vocab,
                              start_step=step)
    return to_device(next(it), dev)


def lm_train_setup(dev):
    """The cut full-width config at train_4k, its parameters (the
    launcher's init, on the card, requiring grad) and the AdamW pair."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.api import named_leaves
    arch = get_arch(LM_TRAIN_ARCH)
    cfg = dataclasses.replace(arch.make_config(), **LM_TRAIN_CUT)
    params = train_mod.init_params(arch, cfg, dev)
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    return arch, cfg, params, make_optimizer(arch.optimizer)


def lm_record(cfg, params, dev) -> dict:
    """Phase 24's recording: one microbatch (4 x 4096) of the train_4k
    step, its loss and backward (no update), every K1, K3 and K2 forward
    (remat's recompute included), dgrad and wgrad (K2's backward) call
    kept by signature, with the counts as routed."""
    import torch

    from repro_torch.core import layers as layers_mod
    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import expert_matmul as xm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.optim.api import pop_grads
    B = 256 // LM_TRAIN_ACCUM
    rec = {k: {} for k in ("x_dgrad", "x_wgrad", "k2_bwd", "x_fwd",
                           "k2_fwd", "k1_fwd", "k1_dgrad", "k1_wgrad")}
    sink = keep_calls(rec)
    step = make_lm_train_step(cfg, lambda p, g, o, s: (p, o), accum=1)
    mb = lm_train_batch(B, 4096, cfg.vocab_size, dev)
    with recording([(xm, "expert_matmul_dgrad", "x_dgrad"),
                    (xm, "expert_matmul_wgrad", "x_wgrad"),
                    (fa, "flash_attention_bwd", "k2_bwd"),
                    (xm, "expert_matmul", "x_fwd"),
                    (fa, "flash_attention", "k2_fwd"),
                    (layers_mod, "elastic_matmul_op", "k1_fwd"),
                    (em, "elastic_matmul_dgrad", "k1_dgrad"),
                    (em, "elastic_matmul_wgrad", "k1_wgrad")], sink):
        _, _, m = step(params, None, mb, 0)
        torch.cuda.synchronize()
    pop_grads(params)
    if not math.isfinite(float(m["loss"])):
        raise AssertionError(f"recorded loss {float(m['loss'])}")
    log(f"  one microbatch ({B} x 4096): loss {float(m['loss']):.4f}; calls "
        f"{ {k: sum(n for *_, n in v.values()) for k, v in rec.items()} }, "
        f"distinct { {k: len(v) for k, v in rec.items()} }")
    return rec


def lm_recorded_checks(rec: dict) -> dict:
    """Phase 24 (a) and (b) at the recorded calls, bf16 as recorded: K2's
    backward (the kernel at the recorded shape, its first sequence held
    against the plain version on that sequence: the plain scores of all
    four are 4 GiB each) and K3's dgrad and wgrad (dgrad exact zeros past
    the counts); each call the same bits twice and under 3 CUDA-graph
    replays; one launch per comparison, on wgmma or persistent."""
    import torch

    from repro_torch.kernels import expert_matmul as xm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    out = {}
    for key, name in (("k2_bwd", "flash_attention_bwd"),
                      ("x_dgrad", "expert_matmul_dgrad"),
                      ("x_wgrad", "expert_matmul_wgrad")):
        worst = (0.0, 0.0)
        for args, kw, n in rec[key].values():
            before = ops.launch_counts()[name]
            was = dict(ops.variant_counts()[name])
            if key == "k2_bwd":
                tol = K2_BWD_TOL["bfloat16"]
                got = fa.flash_attention_bwd(*args, **kw)
                q, k, v, o, lse, do = (t[:1] for t in args)
                want = fa.flash_attention_bwd_plain(q, k, v, o, do, **kw)
                torch.cuda.synchronize()
                err = errs_of([a[:1] for a in got], want, tol)
                what = f"q {tuple(args[0].shape)} causal {kw.get('causal')}"
            else:
                tol = K3_BWD_TOL["bfloat16"]
                fn = getattr(xm, name)
                got = fn(*args)
                want = getattr(xm, f"{name}_plain")(*args)
                torch.cuda.synchronize()
                err = errs_of(got, want, tol)
                c = args[2]
                if key == "x_dgrad":
                    dead = torch.arange(got.shape[1], device=got.device)[
                        None, :] >= c[:, None]
                    if not bool((got[dead] == 0).all()):
                        raise AssertionError("K3 dgrad: non-zero past the "
                                             "counts")
                else:
                    if not bool((got[c == 0] == 0).all()):
                        raise AssertionError("K3 wgrad: a dead expert's dw "
                                             "is not 0")
                what = (f"{tuple(args[0].shape)} x {tuple(args[1].shape)}, "
                        f"{int(c.sum())} live rows, "
                        f"{int((c == 0).sum())} dead experts")
            ran = ops.launch_counts()[name] - before
            took = {v: c_ - was[v] for v, c_ in
                    ops.variant_counts()[name].items() if c_ != was[v]}
            want_v = {"k2_bwd": "wgmma", "x_dgrad": "persistent",
                      "x_wgrad": "persistent"}[key]
            if ran != 1 or took != {want_v: 1}:
                raise AssertionError(f"{name} {what}: launches {took}")
            was = ops.variant_counts()[name][want_v]
            if key == "k2_bwd":
                repeatable(lambda args=args, kw=kw: fa.flash_attention_bwd(
                    *args, **kw), got, 0.0, f"K2 backward {what}")
            else:
                repeatable(lambda args=args, fn=fn: fn(*args), got, 0.0,
                           f"K3 {key[2:]} {what}")
            # two eager calls and one capture, each on the new variant
            if ops.variant_counts()[name][want_v] - was != 3:
                raise AssertionError(f"{name} {what}: the repeats left "
                                     f"{want_v}")
            log(f"  {name} {what} (x{n} in the microbatch): {err[1]:.3g} of "
                f"the largest (tol {tol}), max abs err {err[0]:.3g}, on "
                f"{want_v}; the same bits twice and under 3 graph replays")
            worst = tuple(map(max, zip(worst, err)))
            del got, want
        out[name] = worst
    return out


def lm_smoke_step(dev) -> dict:
    """Phase 24 (c): one AdamW step of the smoke config (fp32, batch 2 x
    64) on the card, kernel route against plain route from the same
    parameters: loss, gradient norm and every updated parameter; K3's
    dgrad and wgrad and K2's backward launched on the kernel route (fp32:
    tile_f32, fma_f32), none on the plain."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models.transformer import lm_init
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.api import _wd_ok, named_leaves
    arch = get_arch(LM_TRAIN_ARCH)
    cfg = arch.make_smoke()
    init_fn, update_fn = make_optimizer(arch.optimizer)
    batch = lm_train_batch(2, 64, cfg.vocab_size, dev, step=3)
    res = []
    for plain in (False, True):
        params = lm_init(torch.Generator(device=dev).manual_seed(3), cfg,
                         device=dev)
        for _, p in named_leaves(params):
            p.requires_grad_(True)
        p0 = {k: p.detach().clone() for k, p in named_leaves(params)}
        step = make_lm_train_step(cfg, update_fn, accum=2)
        before = ops.launch_counts()
        with ops.plain_kernels() if plain else contextlib.nullcontext():
            params, _, m = step(params, init_fn(params), batch, 0)
        torch.cuda.synchronize()
        ran = {k: ops.launch_counts()[k] - before[k]
               for k in ("expert_matmul_dgrad", "expert_matmul_wgrad",
                         "flash_attention_bwd")}
        if any((n > 0) == plain for n in ran.values()):
            raise AssertionError(f"(c) plain={plain}: backward launches "
                                 f"{ran}")
        res.append((float(m["loss"]), float(m["gnorm"]),
                    dict(named_leaves(params)), p0, ran))
    (lk, gk, pk, p0, ran), (lp, gp, pp, _, _) = res
    if not abs(lk - lp) <= LM_SMOKE_LOSS_TOL * abs(lp):
        raise AssertionError(f"(c) loss {lk!r} against the plain {lp!r}")
    if not abs(gk - gp) <= LM_SMOKE_GNORM_TOL * abs(gp):
        raise AssertionError(f"(c) gradient norm {gk!r} against {gp!r}")
    worst = 0.0
    for path, t in pk.items():
        u = (p0[path] - pp[path]) / LM_LR - (0.1 * p0[path] if _wd_ok(path)
                                             else 0.0)
        atol = torch.where(u.abs() >= 0.99, 1e-3 * LM_LR, LM_LR)
        err = (t.detach() - pp[path].detach()).abs()
        if not bool((err <= atol).all()):
            raise AssertionError(f"(c) {path}: {float(err.max())} from the "
                                 f"plain route's update")
        worst = max(worst, float(err.max()) / LM_LR)
    out = {"loss": lk, "loss_plain": lp, "gnorm": gk, "gnorm_plain": gp,
           "param_err_of_lr": worst, "launches": ran}
    log(f"  smoke step (fp32, 2 x 64, accum 2): loss {lk:.7f} / plain "
        f"{lp:.7f}, gradient norm {gk:.6f} / {gp:.6f}; parameters within "
        f"{worst:.3g} of the learning rate of the plain route's; kernel "
        f"route launches {ran}")
    return out


def lm_train_run(dev) -> dict:
    """Phase 24 (d): :func:`train_run` of the LM launcher at the cut
    full-width config, all eight training counters, no checkpoint (36 GB
    of state) and no failure (the LM's restart is phase 29 (a)'s)."""
    argv = ["--arch", LM_TRAIN_ARCH, "--steps", str(LM_TRAIN_STEPS),
            "--save-every", "0"]
    title = (f"24. (d) train_4k (256 x 4096) as {LM_TRAIN_ACCUM} "
             f"microbatches of {256 // LM_TRAIN_ACCUM}, full width, cut to 4 "
             f"layers; {LM_TRAIN_STEPS} steps, no checkpoint (36 GB of "
             f"state), no failure")
    return train_run(title, argv, 0, None, LM_TRAIN_KERNELS,
                     LM_TRAIN_VARIANTS, 256 * 4096, "tokens", dev)


def lm_profile(step_ms: float, dev) -> dict:
    """Phase 24 (d)'s profiled step: :func:`profiled_step` of one
    train_4k step of the cut config (the launcher's init and batch), and
    the share of routed slots the capacity keeps (random weights route
    unevenly: ROADMAP §3)."""
    import torch

    from repro_torch.launch import flops
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models import moe as moe_mod

    t0 = phase("24. (d) one profiled train_4k step of the cut config "
               f"({LM_TRAIN_ACCUM} microbatches)")
    _, cfg, params, (init_fn, update_fn) = lm_train_setup(dev)
    opt = init_fn(params)
    step_fn = make_lm_train_step(cfg, update_fn, LM_TRAIN_ACCUM)
    batch = lm_train_batch(256, 4096, cfg.vocab_size, dev)
    model_flops = flops.lm_model_flops(cfg, "train", 256, 4096)
    kept = torch.zeros(2, dtype=torch.float64, device=dev)
    orig = moe_mod.dispatch_plan

    def plan(*a, **kw):
        dest, keep, counts = orig(*a, **kw)
        kept[0] += keep.sum()
        kept[1] += keep.numel()
        return dest, keep, counts
    moe_mod.dispatch_plan = plan
    try:    # the launcher has run this step: no warm-up step first
        out = profiled_step(lambda: step_fn(params, opt, batch, 0),
                            LM_STEP_GROUPS, step_ms, model_flops,
                            warmup=False)
    finally:
        moe_mod.dispatch_plan = orig
    out["kept_share"] = float(kept[0] / kept[1])
    log(f"  routed slots kept by the capacity: {out['kept_share']:.1%} "
        f"(random router weights route unevenly)")
    del params, opt, batch
    torch.cuda.empty_cache()
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return out


def k2_fwd_lse(q, k, v, causal=True, return_lse=True):
    """K2's forward with the logsumexp, as training launches it."""
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention(q, k, v, causal=causal, return_lse=return_lse)


def k2_fwd_lse_plain(q, k, v, causal=True, return_lse=True):
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention_plain(q, k, v, causal=causal,
                                    return_lse=return_lse)


def k2_fwd_lse_library(q, k, v, causal=True, return_lse=True):
    """The yardstick: SDPA's forward (it keeps its own logsumexp)."""
    return k2_library(q, k, v, causal=causal)


def lm_train_phases(dev, parent) -> dict:
    """Phase 24: the MoE LM trained at full width (cut depth) on the
    card.  Returns what the kernels' record needs.  ``parent``: the parent
    commit's kernels to time beside ours in (e), or None."""
    import torch

    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import expert_matmul as xm
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import ONE_CARD_CUT
    from repro_torch.launch.train import ONE_CARD_ACCUM
    key = (LM_TRAIN_ARCH, LM_TRAIN_SHAPE)
    if ONE_CARD_ACCUM.get(key) != LM_TRAIN_ACCUM or \
            ONE_CARD_CUT.get(key) != LM_TRAIN_CUT:
        raise AssertionError("the launcher's train_4k cuts are not "
                             f"{LM_TRAIN_ACCUM} microbatches, {LM_TRAIN_CUT}")
    torch.cuda.empty_cache()
    log(f"\n(device memory allocated before phase 24: "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB)")
    nograd = torch.no_grad
    t0 = phase("24. (a) K2's backward vs plain (causal and not; bf16 D 64 "
               "and 128, fp32 D 8, 16 and 64; S = T from 1 to 4096; GQA)")
    out = {"k2_cases": k2_bwd_cases(dev)}
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = phase("24. (b) K3's dgrad and wgrad vs plain (edge cases)")
    out["k3_cases"] = k3_bwd_cases(dev)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = phase("24. (a), (b) at every distinct call of one recorded train_4k "
               "microbatch (4 x 4096, bf16, the cut full-width config), "
               "then (e) their graph-replayed device time over it"
               + (", the parent's kernels in turns" if parent else ""))
    _, cfg, params, _ = lm_train_setup(dev)
    rec = lm_record(cfg, params, dev)
    out["recorded"] = lm_recorded_checks(rec)
    k1_calls = {k: rec.pop(k) for k in ("k1_fwd", "k1_dgrad", "k1_wgrad")}

    def par(fn):        # this tree's wrapper on the parent's libraries
        return parent and (fn, parent["libs"])
    out["rows"] = {
        "k3_dgrad": time_rows("K3 dgrad, train_4k microbatch",
                              expand(rec["x_dgrad"]), xm.expert_matmul_dgrad,
                              xm.expert_matmul_dgrad_plain,
                              k3_dgrad_library, "torch.bmm", k3_dgrad_work,
                              par(xm.expert_matmul_dgrad),
                              group=k3_dgrad_group, mode=nograd),
        "k3_wgrad": time_rows("K3 wgrad, train_4k microbatch",
                              expand(rec["x_wgrad"]), xm.expert_matmul_wgrad,
                              xm.expert_matmul_wgrad_plain,
                              k3_wgrad_library, "torch.bmm", k3_wgrad_work,
                              par(xm.expert_matmul_wgrad),
                              group=k3_wgrad_group, mode=nograd),
        "k2_bwd": time_rows("K2 backward (causal, D 128), train_4k "
                            "microbatch", expand(rec["k2_bwd"]),
                            k2_bwd_kernel, k2_bwd_plain, SdpaBackward(),
                            "sdpa backward", k2_bwd_work,
                            parent and (parent["k2_bwd"], parent["libs"]),
                            mode=nograd),
        "k3_fwd": time_rows("K3 forward, train_4k microbatch",
                            expand(rec["x_fwd"]), xm.expert_matmul,
                            xm.expert_matmul_plain,
                            lambda x, w, c: torch.bmm(x, w), "torch.bmm",
                            k3_work, par(xm.expert_matmul), mode=nograd),
        "k2_fwd": time_rows("K2 forward (causal, D 128, with the "
                            "logsumexp), train_4k microbatch",
                            expand(rec["k2_fwd"]), k2_fwd_lse,
                            k2_fwd_lse_plain, k2_fwd_lse_library, "sdpa",
                            k2_work, par(k2_fwd_lse), mode=nograd)}
    # the dgrad at dx widths that are not a multiple of its 256-column
    # items: the recorded down projection's calls with w cut to the a_ff
    # slices 0.75 and 0.5 (a view, as the sliced model reads it)
    sliced = [((dy, w[:, :round(w.shape[1] * f)], c), kw)
              for (dy, w, c), kw in expand(rec["x_dgrad"])
              if w.shape[1] < w.shape[2] for f in (0.75, 0.5)]
    out["rows"]["k3_dgrad_sliced"] = time_rows(
        "K3 dgrad, train_4k down projection at a_ff 0.75 and 0.5", sliced,
        xm.expert_matmul_dgrad, xm.expert_matmul_dgrad_plain,
        k3_dgrad_library, "torch.bmm", k3_dgrad_work,
        par(xm.expert_matmul_dgrad), group=k3_dgrad_group, mode=nograd)
    # K1 over the same microbatch (no kernel change: the rows that rank
    # its next redesign): the attention projections, the dense and
    # shared-expert FFNs, the fp32 router and the 102400-wide head
    out["rows"].update({
        "k1_fwd": time_rows("K1 forward, train_4k microbatch",
                            expand(k1_calls["k1_fwd"]),
                            ops.elastic_matmul_op, k1_plain, k1_library,
                            "torch.matmul", k1_work, group=k1_group,
                            mode=nograd),
        "k1_dgrad": time_rows("K1 dgrad, train_4k microbatch",
                              expand(k1_calls["k1_dgrad"]),
                              em.elastic_matmul_dgrad, k1_dgrad_plain,
                              k1_dgrad_library, "torch.matmul",
                              k1_dgrad_work, group=bwd_group, mode=nograd),
        "k1_wgrad": time_rows("K1 wgrad, train_4k microbatch",
                              expand(k1_calls["k1_wgrad"]),
                              em.elastic_matmul_wgrad, k1_wgrad_plain,
                              k1_wgrad_library, "torch.matmul",
                              k1_wgrad_work, group=bwd_group, mode=nograd)})
    rec.update(k1_calls)
    out["row_launches"] = {k: sum(n for *_, n in v.values())
                           for k, v in rec.items()}
    del rec, params, k1_calls
    torch.cuda.empty_cache()
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = phase("24. (c) the smoke LM train step (fp32) on the card, kernel "
               "route vs plain route")
    out["smoke"] = lm_smoke_step(dev)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    out["run"] = lm_train_run(dev)
    out["profile"] = lm_profile(out["run"]["step_ms"], dev)
    return out


# ---------------------------------------------------------------- phase 25
# the cluster, chaos and watchtower layers: (a) the serve launcher's cluster
# trace mode at its --trace defaults over 2 nodes; (b) a 16 s stream through
# drive_live over 2 nodes with node1 wedged 1 s in.  node0 joins (b) with one
# modelled chip and gains its second at GROW_AT: the batch class starts on
# node1 alone, so node1's failover orphans it and readmits it on node0 (a
# replica built and captured beside node0's live replays).  The stream
# outlasts the failover and the readmitted replica's build and warm, so that
# replica serves inside drive_live.  That build is host-bound: the replica
# was ready 5.2 to 7.6 s in on most H100 hosts and 8.8 s in on a slower one,
# so the stream runs 16 s, twice the slowest reading
CHAOS_SECONDS, WEDGE_AT, GROW_AT = 16.0, 1.0, 0.5
# node1 alone takes the batch class until its failover: at 32 rps a request
# reaches it within one health interval (>= 0.2 s) of the wedge but for a
# chance of exp(-6.4), so the stall check has work to see
CHAOS_RPS = {"interactive": 32.0, "batch": 32.0}
H_MIN = 0.2                 # the health interval's floor, seconds
MEM_SLACK = 64 << 20        # bytes a dropped cluster may leave allocated


def settled_allocated() -> int:
    """Device bytes allocated once unreachable servers are collected."""
    import gc

    import torch
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def stream_rows(events: list, ids: set) -> list:
    """The complete events of the retained traces (and every decision),
    keyed by node name, span, duration and args, with times relative to
    the earliest: two exports of the same spans give the same rows even
    where their pid/tid numbering and time base differ."""
    names = {e["pid"]: e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "process_name"}
    rows = []
    for e in events:
        tid = e.get("args", {}).get("trace_id", -1)
        if e["ph"] != "X" or (tid >= 0 and tid not in ids):
            continue
        rows.append((json.dumps([names[e["pid"]], e["name"], e["cat"],
                                 e["dur"], e["args"]], sort_keys=True),
                     e["ts"]))
    t_min = min(ts for _, ts in rows)
    return sorted((k, ts - t_min) for k, ts in rows)


def replica_timing(serve, arch, cfg, server, warm, x) -> dict:
    """One replica as the cluster builds it, timed: the build (random
    weights on the card), the ladder warm (a CUDA graph per (subnet,
    bucket)), and its graph pool; then killed with 32 requests in
    flight."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = serve.build_server(arch, cfg, max_batch=server.max_batch,
                           device=server.device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s.warm(warm, example_input=x[0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = {"build_s": t1 - t0, "warm_s": t2 - t1, "captures": s.captures,
           "pool_bytes": s.graph_pool_bytes()}
    # fail-stop with dispatches in flight: every future resolves, with
    # logits once its batch is ready or with the failed payload
    s.start()
    futs = [s.submit(x[0]) for _ in range(32)]
    first = futs[0].get(timeout=10)      # batches now in the pipeline
    futs[0].put(first)
    out["kill_outstanding"] = s.outstanding()
    t3 = time.perf_counter()
    s.kill("chip_smoke: kill with work in flight")
    outs = [f.get(timeout=10) for f in futs]
    out["kill_s"] = time.perf_counter() - t3
    out["kill_answered"] = sum(not o.get("cancelled") for o in outs)
    if any(o.get("cancelled") and not o.get("failed") for o in outs) or \
            s.outstanding():
        raise AssertionError(f"kill with work in flight: {outs[-1]}, "
                             f"{s.outstanding()} outstanding")
    del s
    return out


def cluster_trace(serve, arch, cfg, server, lut, x, base_ms: float,
                  H: float, card: str, out_dir: str) -> dict:
    """Phase 25 (a): ``serve.run_trace_mode`` with --nodes 2 --router p2c
    and every observability output; then the checks."""
    from repro_torch.kernels import ops
    from repro_torch.launch.flops import vit_model_flops
    from repro_torch.obs import (iter_trace_events, profile_devices,
                                 validate_schema)
    from repro_torch.obs.analyze import check_trace
    from repro_torch.obs.trace import DEVICE
    from repro_torch.runtime.lut import subnet_flops_ratio
    from repro_torch.traffic import load_schedule

    paths = {k: os.path.join(out_dir, n) for k, n in (
        ("rec", "rec.json"), ("trace", "chrome.json"),
        ("metrics", "metrics.prom"), ("stream", "stream.json"),
        ("alerts", "alerts.txt"), ("profile", "profile.txt"))}
    args = serve.parse_args([
        "--trace", "poisson", "--requests", str(TRACE_REQUESTS),
        "--trace-duration", str(TRACE_SECONDS), "--nodes", "2",
        "--router", "p2c", "--health-interval", repr(H),
        "--rebalance-interval", "1.0", "--record", paths["rec"],
        "--trace-out", paths["trace"], "--metrics-out", paths["metrics"],
        "--stream-trace", paths["stream"], "--alerts-out", paths["alerts"],
        "--profile-out", paths["profile"]])
    sink = []
    drive_live, around = counting_drive_live(serve)
    real, serve.drive_live = serve.drive_live, drive_live
    # the path's counts: the cluster's build, warm and traffic alone
    ops.reset_launch_counts()
    try:
        run = serve.run_trace_mode(args, arch, cfg, server, lut, x, base_ms,
                                   sink=sink)
    finally:
        serve.drive_live = real
    launches, variants = ops.launch_counts(), ops.variant_counts()
    rep, tracer, cluster = run.report, run.tracer, run.arbiter
    recorded = load_schedule(paths["rec"])
    for name, cs in rep.classes.items():
        if cs.submitted != cs.rejected + cs.dropped + cs.failed + \
                cs.completed or cs.submitted != len(recorded[name]):
            raise AssertionError(f"(a) {name}: {cs.summary()} against "
                                 f"{len(recorded[name])} recorded arrivals")
    cold = {n: s.cold_compiles for n, s in run.servers.items()}
    if len(cold) < 4 or any(cold.values()):
        raise AssertionError(f"(a) replicas {sorted(cold)}, cold pairs "
                             f"{cold}")
    bad = validate_schema(tracer.spans())
    if bad:
        raise AssertionError(f"(a) span schema: {bad[:5]}")
    trees = tracer.requests()
    for t in trees:
        check_trace(t)
    if rep.arbiter["health_failed"]:
        raise AssertionError(f"(a) health-failed under healthy load: "
                             f"{rep.arbiter['health_failed']}")
    ran = during(around)
    if min(sum(ran[k].values()) for k in ("elastic_matmul",
                                          "flash_attention")) <= 0:
        raise AssertionError(f"(a) kernels not launched in the traffic: "
                             f"{ran}")
    main_path_variants(ran, need={("elastic_matmul", "tma"),
                                  ("elastic_matmul", "small_m"),
                                  ("flash_attention", "wgmma")})
    by_name = {p.subnet.name(): p.subnet for p in lut.points}
    err, n_ans, n_sub = served_err(sink, list(run.servers.values()),
                                   by_name, x, cfg)
    # the stream against the one-shot export, trace by trace
    ids = {t.trace_id for t in trees}
    streamed = list(iter_trace_events(paths["stream"]))
    one_shot = list(iter_trace_events(paths["trace"]))
    a, b = stream_rows(streamed, ids), stream_rows(one_shot, ids)
    if len(a) != len(b) or any(ka != kb or abs(ta - tb) > 0.01
                               for (ka, ta), (kb, tb) in zip(a, b)):
        raise AssertionError(f"(a) streamed events ({len(a)}) differ from "
                             f"the one-shot export's ({len(b)})")
    # the profile: a row for every (subnet, bucket) a DEVICE span names
    keys = {(str(s.attrs["subnet"]), int(s.attrs["bucket"]))
            for s in tracer.spans() if s.name == DEVICE}
    prof = profile_devices(tracer, flops_of=lambda sn, b: vit_model_flops(
        cfg, "infer", b, cfg.img_res) * subnet_flops_ratio(by_name[sn]))
    rows = open(paths["profile"]).read().splitlines()[1:]
    if set(prof) != keys or len(rows) != len(keys):
        raise AssertionError(f"(a) profile rows {sorted(prof)} ({len(rows)} "
                             f"written) for DEVICE keys {sorted(keys)}")
    for name, cs in rep.classes.items():
        log(f"  (a) {name:12s} submitted {cs.submitted}, completed "
            f"{cs.completed}, p50/p95/p99 {cs.p(50):.3f}/{cs.p(95):.3f}/"
            f"{cs.p(99):.3f} ms, goodput rate "
            f"{cs.good / max(cs.submitted, 1):.4f} [{card}]")
    routed = rep.arbiter["routed"]
    log(f"  (a) routed {json.dumps(routed)}, health-failed "
        f"{rep.arbiter['health_failed']}, migrations "
        f"{len(rep.arbiter['migrations'])}, preempted "
        f"{rep.arbiter['preempted']} [{card}]")
    log(f"  (a) {len(run.watchtower.alerts)} alerts fired; "
        f"time-in-SLO {run.watchtower.summary()['time_in_slo']} [{card}]")
    top = sorted(prof.values(), key=lambda r: -r["batches"])[:4]
    log("  (a) device profile (busiest rows; utilisation = model FLOPs over "
        "the DEVICE span at 989 TFLOP/s): " + "; ".join(
            f"{r['subnet']} b{r['bucket']} {r['batches']} batches "
            f"{r['ms_per_batch']:.3f} ms {100 * r['mxu_util']:.2f}%"
            for r in top) + f" [{card}]")
    log(f"  (a) launches by variant during the traffic: K1 "
        f"{ran['elastic_matmul']}, K2 {ran['flash_attention']}; served "
        f"logits vs direct forward ({n_ans} answers, {n_sub} subnets): max "
        f"abs err {err:.3g}; {len(trees)} trees, {len(a)} streamed events "
        f"equal to the one-shot export's; {len(prof)} profile rows")
    out = {"classes": {n: cs.summary() for n, cs in rep.classes.items()},
           "routed": routed, "preempted": rep.arbiter["preempted"],
           "migrations": rep.arbiter["migrations"],
           "alerts": len(run.watchtower.alerts), "variants": ran,
           "served_err": err, "profile_rows": len(prof),
           "traffic_s": around["seconds"], "launches": launches,
           "launch_variants": variants}
    cluster.stop()
    del run, cluster, tracer, sink, rep
    return out


def cluster_chaos(serve, arch, cfg, server, lut, x, H: float, warm: list,
                  card: str) -> dict:
    """Phase 25 (b): two nodes behind the Cluster API, both classes, a
    CHAOS_SECONDS stream through drive_live with Reliability and a Watchtower; a
    ChaosController wedges node1 at WEDGE_AT; then the checks."""
    from repro_torch.chaos import (WEDGE, ChaosController, Injection,
                                   Reliability, RetryBudget, RetryPolicy,
                                   Scenario)
    from repro_torch.cluster import DEAD, HEALTH_EPOCHS, Cluster, ClusterNode
    from repro_torch.kernels import ops
    from repro_torch.obs import (MetricsRegistry, Tracer, Watchtower,
                                 default_windows, format_alerts)
    from repro_torch.obs.trace import CHAOS, HEALTH_FAIL
    from repro_torch.runtime import GlobalConstraints
    from repro_torch.traffic import DEGRADE, SLOClass, poisson

    K = HEALTH_EPOCHS
    # interactive: a deadline that covers one failover ((K + 1) intervals)
    # and the backoff.  drive_live judges retries once the whole stream is
    # sent (ROADMAP F7), so a batch request caught on the wedged node is
    # still retried only under a deadline that outlasts the stream
    deadline_ms = 1e3 * (K + 1) * H + 500.0
    classes = [SLOClass("interactive", deadline_ms=deadline_ms, priority=2),
               SLOClass("batch", deadline_ms=1e3 * CHAOS_SECONDS,
                        priority=0, drop_policy=DEGRADE)]
    tracer, metrics = Tracer(), MetricsRegistry()
    nodes = [ClusterNode(name="node0", g_fn=lambda t: GlobalConstraints(
                 total_chips=1 if t < GROW_AT else 2)),
             ClusterNode(name="node1", g_fn=lambda t: GlobalConstraints(
                 total_chips=2))]
    cluster = Cluster(nodes, router="p2c", health_interval_s=H,
                      tracer=tracer, metrics=metrics)
    built = []

    def maker(cls_name):
        def make(node):
            t0 = time.perf_counter()
            s = serve.build_server(arch, cfg, max_batch=server.max_batch,
                                   device=server.device, tenant=cls_name)
            s.warm(warm, example_input=x[0])
            built.append((node.name, cls_name, s,
                          time.perf_counter() - t0, cluster._now()))
            return s
        return make

    # the path's counts: the cluster's build, warm and traffic alone
    ops.reset_launch_counts()
    for c in classes:
        cluster.register(c.name, lut, target_latency_ms=c.service_target_ms,
                         priority=c.priority, make_server=maker(c.name))
    placed = cluster.placements_snapshot()
    if placed != {"interactive": ["node0", "node1"], "batch": ["node1"]}:
        raise AssertionError(f"(b) placements {placed}")
    streams = {n: poisson(r, CHAOS_SECONDS, seed=3 + i)
               for i, (n, r) in enumerate(CHAOS_RPS.items())}
    wt = Watchtower({"interactive": 0.99, "batch": 0.95},
                    windows=default_windows(CHAOS_SECONDS / 86400.0),
                    tracer=tracer, registry=metrics,
                    hist_name="engine_request_ms")
    rel = Reliability(default=RetryPolicy(max_attempts=3, backoff_s=0.05),
                      budget=RetryBudget(burst=64, fraction=0.5),
                      brownout=None)
    ctl = ChaosController(cluster, Scenario(name="wedge-node1", injections=(
        Injection(t=WEDGE_AT, kind=WEDGE, node="node1"),)))
    sink = []
    drive_live, around = counting_drive_live(serve)
    ctl.start()
    # drive_live stops the cluster once the stream has drained: its stop
    # cancels what is still unanswered
    report = drive_live(classes, cluster.ports(), cluster, streams,
                        lambda name: x[0],
                        g_fn=lambda: GlobalConstraints(total_chips=2),
                        timeout_s=60.0, reliability=rel, watchtower=wt,
                        sink=sink)
    launches, variants = ops.launch_counts(), ops.variant_counts()
    ctl.join(timeout_s=10.0)
    if not ctl.done or [a for _, a, _ in ctl.applied] != ["wedge_on"]:
        raise AssertionError(f"(b) chaos applied {ctl.applied}")
    # every future resolved: no replica holds an unanswered request
    hung = {f"{n}/{c}": s.outstanding() for n, c, s, _, _ in built
            if s.outstanding()}
    if hung or around["seconds"] > CHAOS_SECONDS + 60.0:
        raise AssertionError(f"(b) unresolved futures {hung} after "
                             f"{around['seconds']:.1f} s")
    for name, cs in report.classes.items():
        if cs.submitted != cs.rejected + cs.dropped + cs.failed + \
                cs.completed or cs.submitted != len(streams[name]):
            raise AssertionError(f"(b) {name}: {cs.summary()}")
    # the health thread failed node1 over and recorded its HEALTH_FAIL span
    fails = [s.t0 for s in tracer.spans()
             if s.name == HEALTH_FAIL and s.node == "node1"]
    if cluster.nodes["node1"].state != DEAD or not fails or \
            cluster.summary()["health_failed"] != ["node1"]:
        raise AssertionError(f"(b) node1 {cluster.nodes['node1'].state}, "
                             f"health-failed {cluster.summary()['health_failed']}"
                             f", HEALTH_FAIL spans {fails}")
    # within K intervals (plus the one the wedge lands in) of the wedge
    t_wedge = min(s.t0 for s in tracer.spans()
                  if s.name == CHAOS and s.attrs.get("kind") == "wedge_on")
    to_fail = fails[0] - t_wedge
    if to_fail > (K + 1) * H:
        raise AssertionError(f"(b) node1 failed {to_fail:.3f} s after the "
                             f"wedge (bound {(K + 1) * H:.3f} s)")
    retried = sum(cs.retried for cs in report.classes.values())
    if retried <= 0 or report.reliability["retry_granted"] != retried:
        raise AssertionError(f"(b) retried {retried}, "
                             f"{report.reliability}")
    # the orphaned batch class readmitted on node0 (its replica built and
    # captured beside node0's replays) and served there inside the stream
    readmit = [b for b in built if b[:2] == ("node0", "batch")]
    if cluster.placements_snapshot()["batch"] != ["node0"] or not readmit \
            or readmit[0][4] >= CHAOS_SECONDS or readmit[0][2].served <= 0:
        raise AssertionError(
            f"(b) batch not readmitted and served on node0 in the stream: "
            f"{cluster.placements_snapshot()}, "
            f"{[(b[4], b[2].served) for b in readmit]}")
    readmit_served = readmit[0][2].served
    cold = {f"{n}/{c}": s.cold_compiles for n, c, s, _, _ in built}
    if any(cold.values()):
        raise AssertionError(f"(b) cold pairs {cold}")
    survivors = [s for n, _, s, _, _ in built if n == "node0"]
    by_name = {p.subnet.name(): p.subnet for p in lut.points}
    err, n_ans, n_sub = served_err(sink, survivors, by_name, x, cfg)
    ran = during(around)
    if min(sum(ran[k].values()) for k in ("elastic_matmul",
                                          "flash_attention")) <= 0:
        raise AssertionError(f"(b) kernels not launched: {ran}")
    for name, cs in report.classes.items():
        log(f"  (b) {name:12s} submitted {cs.submitted}, completed "
            f"{cs.completed}, failed {cs.failed}, dropped {cs.dropped}, "
            f"retried {cs.retried}, p50/p95/p99 {cs.p(50):.3f}/"
            f"{cs.p(95):.3f}/{cs.p(99):.3f} ms, goodput rate "
            f"{cs.good / max(cs.submitted, 1):.4f} (deadline "
            f"{[c.deadline_ms for c in classes if c.name == name][0]:.0f} ms)"
            f" [{card}]")
    log(f"  (b) routed {json.dumps(report.arbiter['routed'])}, retried "
        f"{retried} (budget granted {report.reliability['retry_granted']}, "
        f"denied {report.reliability['retry_denied']}), health-failed "
        f"{report.arbiter['health_failed']} [{card}]")
    log(f"  (b) wedge at {t_wedge - around['t0']:.3f} s into the stream, "
        f"HEALTH_FAIL {to_fail:.3f} s later (interval {H:.3f} s, K {K}, "
        f"bound {(K + 1) * H:.3f} s); batch readmitted on node0 "
        f"{readmit[0][4]:.3f} s into the cluster's clock, its replica built "
        f"and warmed in {readmit[0][3]:.3f} s beside node0's replays, then "
        f"answered {readmit_served} of the stream's batch requests "
        f"[{card}]")
    text = format_alerts(wt.alerts)
    log(f"  (b) {len(wt.alerts)} alerts fired, time-in-SLO "
        f"{wt.summary()['time_in_slo']} [{card}]" + (
            "\n" + "\n".join("      " + ln for ln in text.splitlines())
            if text else ""))
    log(f"  (b) launches during the traffic: K1 {ran['elastic_matmul']}, "
        f"K2 {ran['flash_attention']}; served logits vs direct forward on "
        f"node0's replicas ({n_ans} answers, {n_sub} subnets): max abs err "
        f"{err:.3g}")
    out = {"classes": {n: cs.summary() for n, cs in report.classes.items()},
           "retried": retried, "to_fail_s": to_fail,
           "routed": report.arbiter["routed"],
           "alerts": [[round(a.t, 3), a.cls, a.window, a.severity]
                      for a in wt.alerts],
           "readmit_build_s": readmit[0][3], "readmit_at_s": readmit[0][4],
           "readmit_served": readmit_served, "variants": ran,
           "served_err": err, "launches": launches,
           "launch_variants": variants}
    ctl.stop()
    del built, survivors, readmit, cluster, ctl, report, sink, tracer
    return out


def cluster_phases(serve, arch, cfg, server, lut, x, base_ms: float,
                   card: str, out_dir: str) -> dict:
    """Phase 25: the cluster, chaos and watchtower layers at full width on
    the card (see the module docstring)."""
    import torch
    from repro_torch.cluster import HEALTH_EPOCHS

    t0 = phase("25. cluster, chaos and watchtower: (a) the launcher's "
               "cluster trace mode, 2 nodes; (b) node1 wedged under live "
               "traffic, health-checked failover, retries, readmission")
    os.makedirs(out_dir, exist_ok=True)
    warm = list(dict.fromkeys(p.subnet for p in lut.points))
    m0 = settled_allocated()
    rt = replica_timing(serve, arch, cfg, server, warm, x)
    # the health interval: K intervals must outlast the longest batch a
    # healthy node can take, a cold capture of one (subnet, bucket) (the
    # stall check's operator contract); twice a capture's share of the
    # measured warm, and never under H_MIN
    per_pair = rt["warm_s"] / max(rt["captures"], 1)
    H = round(max(H_MIN, 2.0 * per_pair), 3)
    log(f"  a replica: build {rt['build_s']:.3f} s, warm {rt['warm_s']:.3f} "
        f"s ({rt['captures']} captures, {1e3 * per_pair:.1f} ms each), "
        f"graph pool {rt['pool_bytes'] / 2 ** 20:.1f} MiB; killed after "
        f"its first answer with {rt['kill_outstanding']} of 32 requests "
        f"outstanding: {rt['kill_answered']} answered, the rest failed, all "
        f"resolved {rt['kill_s']:.3f} s after the kill; health interval "
        f"{H:.3f} s x {HEALTH_EPOCHS} epochs [{card}]")
    mem = {"before": m0}
    a = cluster_trace(serve, arch, cfg, server, lut, x, base_ms, H, card,
                      out_dir)
    mem["after_a"] = settled_allocated()
    b = cluster_chaos(serve, arch, cfg, server, lut, x, H, warm, card)
    mem["after_b"] = settled_allocated()
    # the path's counts: (a)'s and (b)'s clusters, each from its build to
    # the end of its traffic (not the timing replica, nor the checks'
    # direct forwards)
    la, lb = a.pop("launches"), b.pop("launches")
    launches = {k: la[k] + lb[k] for k in ("elastic_matmul",
                                           "flash_attention")}
    va, vb = a.pop("launch_variants"), b.pop("launch_variants")
    variants = {k: {v: n + vb[k][v] for v, n in va[k].items()} for k in va}
    for k, v in mem.items():
        if abs(v - m0) > MEM_SLACK:
            raise AssertionError(f"device memory {k} {v / 2 ** 20:.1f} MiB "
                                 f"against {m0 / 2 ** 20:.1f} MiB before the "
                                 f"clusters (slack {MEM_SLACK >> 20} MiB)")
    if min(launches["elastic_matmul"], launches["flash_attention"]) <= 0:
        raise AssertionError(f"phase 25 launched {launches}")
    seconds = time.perf_counter() - t0
    log(f"  device memory allocated before / after (a) / after (b): "
        + " / ".join(f"{v / 2 ** 20:.1f}" for v in mem.values())
        + f" MiB (peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB); launches on the cluster path {launches}")
    log(f"  ({seconds:.1f} s) [{card}]")
    return {"a": a, "b": b, "replica": rt, "health_interval_s": H,
            "memory_mib": {k: v / 2 ** 20 for k, v in mem.items()},
            "launches": launches, "variants": variants, "seconds": seconds}


# ---------------------------------------------------------------- phase 26
# the three LM configs of ROADMAP item 15 (b), served on the card at full
# width through the LM launcher's path, each at its one-card cut
# (``launch/steps.py:ONE_CARD_CUT``): qwen1.5-110b 8 of 80 layers,
# granite-20b whole, kimi-k2-1t-a32b 2 of 61 (its dense layer and one MoE
# layer of 384 experts); one config on the card at a time
LM_CONFIGS = (("qwen", "qwen1.5-110b"), ("granite", "granite-20b"),
              ("kimi", "kimi-k2-1t-a32b"))
QK_SCALE = 1.5      # phase 26 (a)'s q and k: randn x 1.5 (scores spread ~2)


def k2_config_cases(dev) -> dict:
    """Phase 26 (a): K2 at kimi-k2's head dim 112 (causal prefill 4 x 512,
    H 64 on KH 8, also with q read in place from a fused buffer) and
    decode over the 528-slot cache at kimi's D = 112 and granite's 48
    query heads on one kv head, each decode at three fills inside one
    captured CUDA graph with the fill advanced between replays, against
    the plain version; every aligned bf16 call on wgmma or decode, and
    one fp32 call on fma_f32 and one of unaligned bf16 rows
    on fma_bf16 at D = 112, held the same way.  q and k are
    ``QK_SCALE`` x randn: the scores q.k / sqrt(D) then spread by
    ``QK_SCALE``^2 ~ 2.25, so the softmax picks a few keys, and a kernel
    that ignored the scores (o near the mean of v, ~0.04 at fill 528) or
    read another group's query heads would miss by about |o| ~ 0.5,
    far past the tolerance.  The plain version runs on fp32 copies of
    the same bf16 inputs: in bf16 it rounds the scores to bf16 before
    the softmax, an error of its own of ~0.03 at this spread, where the
    kernels keep them in fp32."""
    import torch

    from repro_torch.graphs import Graph, new_pool
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(26)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).to(torch.bfloat16)

    tol = ATTN_TOL["bfloat16"]
    B, S = LM_BATCH, PREFILL_LEN
    total = PREFILL_LEN + DECODE_STEPS
    before = dict(fa.variant_launches)
    errs = {}

    def held(label, o, want, variant, ran):
        err = close(o, want, tol)
        errs[label] = err
        log(f"  {label:44s} {ran:7s} max abs err {err:.3g} (tol {tol})")
        if ran != variant:
            raise AssertionError(f"K2 {label}: took {ran}, not {variant}")

    def one(label, q, k, v, causal, variant):
        b0 = dict(fa.variant_launches)
        o = ops.flash_attention_op(q, k, v, causal=causal)
        ran = [n for n, c in fa.variant_launches.items() if c != b0[n]]
        with ops.plain_kernels():
            want = ops.flash_attention_op(q.float(), k.float(), v.float(),
                                          causal=causal)
        torch.cuda.synchronize()
        held(label, o, want, variant, ran[0] if ran else "none")

    H, KH, D = 64, 8, 112
    sc = QK_SCALE
    one("kimi prefill S=T=512 H64/KH8 D112 causal", randn(B, S, H, D, scale=sc),
        randn(B, S, KH, D, scale=sc), randn(B, S, KH, D), True, "wgmma")
    fused = randn(B, S, H + 2 * KH, D, scale=sc)
    one("kimi prefill, q k v in place of a fused buffer",
        fused[:, :, :H], fused[:, :, H:H + KH], fused[:, :, H + KH:], True,
        "wgmma")
    # the fma kernel at D = 112: fp32, and bf16 rows TMA and
    # 16-byte loads cannot read
    wide = randn(2, 64, H, D + 1)                # 226-byte rows
    one("an fp32 call at D = 112", *[randn(1, 4, 1, D).float()
                                      for _ in range(3)], True, "fma_f32")
    one("bf16 rows not 16-byte aligned at D = 112", wide[..., :D],
        randn(2, 64, KH, D, scale=sc), randn(2, 64, KH, D), True,
        "fma_bf16")
    # decode over the whole cache, the fill a device int32: eager and in
    # one captured graph, the fill copied in before each replay
    fills = (1, total // 2, total)
    dev_us = {}
    with torch.inference_mode():
        for name, H_, KH_, D_ in (("kimi", 64, 8, 112),
                                  ("granite", 48, 1, 128)):
            q = randn(B, 1, H_, D_, scale=sc)
            ck, cv = randn(B, total, KH_, D_, scale=sc), \
                randn(B, total, KH_, D_)
            if fa.choose_variant(1, total, H_, KH_, D_, torch.bfloat16,
                                 fa._aligned(q, ck, cv)) != "decode":
                raise AssertionError(f"{name}: S = 1 not on decode")
            n = torch.full((), 1, dtype=torch.int32, device=dev)
            b0 = fa.variant_launches["decode"]
            graph = Graph(lambda t: ops.flash_attention_op(
                q, ck, cv, causal=False, kv_len=t), [n], pool=new_pool(),
                stream=torch.cuda.Stream(dev))
            for fill in fills:
                n.fill_(fill)
                o = ops.flash_attention_op(q, ck, cv, causal=False, kv_len=n)
                with ops.plain_kernels():
                    want = ops.flash_attention_op(
                        q.float(), ck[:, :fill].float(),
                        cv[:, :fill].float(), causal=False)
                o_g = graph.run(torch.full((), fill, dtype=torch.int32,
                                           device=dev))
                torch.cuda.synchronize()
                label = (f"{name} decode H{H_}/KH{KH_} D{D_} fill {fill}")
                held(label + " eager", o, want, "decode", "decode")
                held(label + " graph", o_g, want, "decode", "decode")
                if fill > 1:
                    # what the check would see of a kernel that ignored
                    # the scores, or read the next group's query heads
                    wb = want.float()
                    for wrong, qw in (("no scores", q * 0),
                                      ("heads of the next group",
                                       q.roll(fa.DECODE_R_MAX, dims=2))):
                        with ops.plain_kernels():
                            ow = ops.flash_attention_op(
                                qw.float(), ck[:, :fill].float(),
                                cv[:, :fill].float(), causal=False)
                        if bool(((ow - wb).abs()
                                 <= tol + tol * wb.abs()).all()):
                            raise AssertionError(
                                f"{label}: {wrong} would pass the check")
                        log(f"    {wrong}: max abs diff "
                            f"{float((ow - wb).abs().max()):.3g} from plain")
                start, end = torch.cuda.Event(enable_timing=True), \
                    torch.cuda.Event(enable_timing=True)
                with graph.lock:
                    graph.replay()
                    start.record()
                    for _ in range(20):
                        graph.replay()
                    end.record()
                torch.cuda.synchronize()
                dev_us[f"{name} {fill}"] = start.elapsed_time(end) / 20 * 1e3
            # the capture's eager warm-up, then per fill an eager call and
            # 22 replays (a capture records its launches, counts none)
            ran = fa.variant_launches["decode"] - b0
            if ran != 1 + len(fills) * 23:
                raise AssertionError(f"{name}: {ran} decode launches")
            splits, chunk = fa.decode_plan(
                total, B * KH_ * fa.decode_groups(H_, KH_))
            log(f"  {name} decode: {fa.decode_groups(H_, KH_)} head "
                f"group(s) a kv head, {splits} splits of {chunk} keys; "
                f"device time a call (graph) " + ", ".join(
                    f"fill {f}: {dev_us[f'{name} {f}']:.2f} us"
                    for f in fills))
            del graph, q, ck, cv
    ran = {v: fa.variant_launches[v] - before[v] for v in fa.VARIANTS}
    if ran["fma_bf16"] != 1 or ran["fma_f32"] != 1 or not ran["wgmma"] \
            or not ran["decode"]:
        raise AssertionError(f"phase 26 (a) K2 variants {ran}")
    log(f"  K2 launches by variant in (a): {ran}")
    return {"errs": errs, "max_abs_err": max(errs.values()),
            "decode_device_us": dev_us, "variants": ran}


def lm_depth2(params: dict, cfg):
    """(params, cfg) of the first two layers (views of ``params``)."""
    import dataclasses as dc
    if cfg.n_layers <= 2:
        return params, cfg
    p = dict(params)
    nd = min(cfg.n_dense_layers, 2)
    if "dense_layers" in p:
        p["dense_layers"] = p["dense_layers"][:nd]
    if "moe_layers" in p:
        p["moe_layers"] = p["moe_layers"][:2 - nd]
    if cfg.moe is not None:
        return p, dc.replace(cfg, n_layers=2, first_k_dense=nd)
    return p, dc.replace(cfg, n_layers=2)


def lm_config_logits(key: str, params: dict, cfg, dev) -> dict:
    """Phase 26 (c) and (d) at full width and depth 2: the kernel route
    against the plain route at every operating point, fp32 (the dense
    configs: kimi's fp32 depth 2 would take ~80 GB) and bf16 on the plain
    route's routing; then masked widths against sliced ones at one point
    with every masked knob (qwen and kimi)."""
    import torch

    from repro_torch.core.layers import cast_params
    from repro_torch.kernels import ops
    from repro_torch.launch import elastic_moe
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import lm_apply

    p16, cfg2 = lm_depth2(params, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(27))
    fp32 = cfg.moe is None
    p32 = cast_params(p16, torch.float32) if fp32 else None
    cfg32 = dataclasses.replace(cfg2, compute_dtype="float32")
    out = {"route": {}, "masked": {}}
    with torch.inference_mode():
        for name, E_, _ in elastic_moe.operating_points(cfg2):
            row = {}
            if fp32:
                yk = lm_apply(p32, toks, cfg32, E=E_)[0]
                with ops.plain_kernels():
                    yp = lm_apply(p32, toks, cfg32, E=E_)[0]
                row["fp32"] = close(yk, yp, LM_LOGITS_FP32_TOL)
                del yk, yp
            tape_p = []
            with ops.plain_kernels(), router_tape(moe_mod, tape_p):
                yp16 = lm_apply(p16, toks, cfg2, E=E_)[0]
            with router_tape(moe_mod, tape_p, replay=True):
                yq16 = lm_apply(p16, toks, cfg2, E=E_)[0]
            if not torch.isfinite(yq16).all():
                raise AssertionError(f"{key} {name}: non-finite bf16 logits")
            row["bf16_pinned"] = float((yq16.float() - yp16.float()).abs()
                                       .max())
            row["top1"] = float((yq16.argmax(-1) == yp16.argmax(-1))
                                .float().mean())
            if row["bf16_pinned"] > LM_LOGITS_BF16_PINNED_TOL:
                raise AssertionError(
                    f"{key} {name}: bf16 logits on one routing differ by "
                    f"{row['bf16_pinned']} > {LM_LOGITS_BF16_PINNED_TOL}")
            out["route"][name] = row
            log(f"  (c) {key} depth 2 {name:24s} "
                + (f"fp32 max abs err {row['fp32']:.3g} (tol "
                   f"{LM_LOGITS_FP32_TOL}); " if fp32 else "")
                + f"bf16 on the plain route's routing {row['bf16_pinned']:.3g}"
                  f" (tol {LM_LOGITS_BF16_PINNED_TOL}), top-1 "
                  f"{row['top1']:.3f}")
            del yp16, yq16, tape_p
        out["decode"] = lm_config_decode_step(key, p16, cfg2, toks)
        if key in ("qwen", "kimi"):
            E_s = {"a_ff": (cfg.moe.d_ff if cfg.moe else cfg.d_ff) // 2,
                   "a_heads": elastic_moe.fewest_heads(cfg),
                   "a_layers": 1 if cfg.moe is None else 2}
            if cfg.moe is not None:
                E_s.update(a_experts=min(cfg.elastic.expert_counts),
                           top_k=min(cfg.elastic.top_ks))
            E_m = {k: v if k == "top_k" else
                   torch.tensor(v, dtype=torch.int32) for k, v in E_s.items()}
            # the sliced run's routing replayed in the masked one: the same
            # products over the same active elements, zeros past them; what
            # is left is rounding over full-width tiles or summation order
            runs = [("bf16", p16, cfg2, LM_LOGITS_BF16_PINNED_TOL)]
            if fp32:
                runs.append(("fp32", p32, cfg32, LM_LOGITS_FP32_TOL))
            for dt, p, c, tol in runs:
                tape = []
                with router_tape(moe_mod, tape):
                    ys = lm_apply(p, toks, c, E=E_s)[0]
                with router_tape(moe_mod, tape, replay=True):
                    ym = lm_apply(p, toks, c, E=E_m)[0]
                err = float((ym.float() - ys.float()).abs().max())
                if not torch.isfinite(ym).all() or err > tol:
                    raise AssertionError(f"{key} masked vs sliced {dt}: "
                                         f"{err} > {tol}")
                out["masked"][dt] = err
                log(f"  (d) {key} depth 2 masked {E_s} against sliced, {dt}:"
                    f" max abs err {err:.3g} (tol {tol})")
    del p32
    return out


def lm_config_decode_step(key: str, p16: dict, cfg2, toks) -> float:
    """Phase 26 (c): one decode step at the full point and depth 2, the
    kernel route against the plain route, each from its own copy of one
    528-slot cache that a plain prefill of all but the last token filled,
    on the plain route's routing; every K2 call of the kernel route's
    step on ``decode`` (granite's six head groups, kimi's D = 112)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import lm_decode, lm_prefill
    from repro_torch.models import moe as moe_mod

    with ops.plain_kernels():
        _, caches = lm_prefill(p16, toks[:, :-1], cfg2,
                               max_len=PREFILL_LEN + DECODE_STEPS)
    copy = {st: [{k: v.clone() if isinstance(v, torch.Tensor) else v
                  for k, v in c.items()} for c in layers]
            for st, layers in caches.items()}
    tape = []
    with ops.plain_kernels(), router_tape(moe_mod, tape):
        yp = lm_decode(p16, caches, toks[:, -1:], cfg2)[0]
    before = dict(fa.variant_launches)
    with router_tape(moe_mod, tape, replay=True):
        yk = lm_decode(p16, copy, toks[:, -1:], cfg2)[0]
    ran = {v: fa.variant_launches[v] - before[v] for v in fa.VARIANTS}
    if ran != {v: cfg2.n_layers if v == "decode" else 0
               for v in fa.VARIANTS}:
        raise AssertionError(f"{key} decode step: K2 launches {ran}")
    err = float((yk.float() - yp.float()).abs().max())
    if not torch.isfinite(yk).all() or err > LM_LOGITS_BF16_PINNED_TOL:
        raise AssertionError(f"{key} decode step: kernel route differs from "
                             f"plain by {err} > {LM_LOGITS_BF16_PINNED_TOL}")
    top1 = float((yk.argmax(-1) == yp.argmax(-1)).float().mean())
    log(f"  (c) {key} depth 2 full: one decode step at fill "
        f"{toks.shape[1] - 1} of {PREFILL_LEN + DECODE_STEPS}, K2 on decode "
        f"x{ran['decode']}, bf16 on the plain route's caches and routing "
        f"{err:.3g} (tol {LM_LOGITS_BF16_PINNED_TOL}), top-1 {top1:.3f}")
    return err


def kept_shares(k3_calls: list, n_pre: int, cfg) -> dict:
    """The routed slots the capacity keeps, a share a MoE layer, from the
    counts of the recorded K3 calls of a prefill (the first ``n_pre``)
    and a decode step."""
    kept = {}
    for st, calls in (("prefill", k3_calls[:n_pre]),
                      ("decode", k3_calls[n_pre:])):
        counts = {id(args[2]): args[2] for args, _ in calls}
        routed = LM_BATCH * (PREFILL_LEN if st == "prefill" else 1) \
            * cfg.moe.top_k
        kept[st] = [float(c.sum()) / routed for c in counts.values()]
    return kept


def config_times(key: str, calls: dict, n_pre: dict, kernel_fn: dict,
                 parent=None) -> dict:
    """Phase 26 (e): each kernel's rows over the recorded calls of one
    prefill (the first ``n_pre[k]``) and one decode step; ``parent``'s K2
    beside K2's prefill row."""
    import torch

    from repro_torch.kernels import expert_matmul as xm
    kinds = {
        "k1": (kernel_fn["k1"], k1_plain, k1_library, "torch.matmul",
               k1_work),
        "k2": (kernel_fn["k2"], k2_plain, k2_library, "sdpa", k2_work),
        "k3": (xm.expert_matmul, xm.expert_matmul_plain,
               lambda x, w, c: torch.bmm(x, w), "torch.bmm", k3_work)}
    times = {}
    for k, (kern, plain, lib, lib_name, work) in kinds.items():
        for st, batch in (("prefill", calls[k][:n_pre[k]]),
                          ("decode", calls[k][n_pre[k]:])):
            if batch:
                times[f"{k}_{st}"] = time_rows(
                    f"{k.upper()} {key} {st:7s}", batch, kern, plain, lib,
                    lib_name, work, parent and k == "k2" and st == "prefill"
                    and (parent["k2"], parent["libs"]))
    return times


def lm_config_phase(key: str, arch_id: str, dev, card: str,
                    parent=None) -> dict:
    """Phase 26 (b), (c), (d) and (e) for one config: see
    :func:`lm_configs_phases`."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import layers as layers_mod
    from repro_torch.kernels import expert_matmul as xm
    from repro_torch.kernels import ops
    from repro_torch.launch import elastic_moe
    from repro_torch.launch.flops import lm_model_flops
    from repro_torch.launch.steps import lm_decode, lm_prefill
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import lm_init

    full = get_arch(arch_id).make_config()
    cfg = elastic_moe.one_card(arch_id, full)
    t0 = time.perf_counter()
    torch._C._cuda_clearCublasWorkspaces()
    m0 = settled_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm_init(torch.Generator(device=dev).manual_seed(26), cfg,
                     device=dev, dtype=cfg.cdtype())
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"  (b) {arch_id}: {cfg.n_layers} of {full.n_layers} layers at full "
        f"width (d {cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} "
        f"kv, head dim {cfg.d_head}"
        + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k}" if cfg.moe
           else "") + f"), {n_params / 1e9:.2f} B parameters in bf16 drawn "
        f"on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB allocated")
    total = PREFILL_LEN + DECODE_STEPS
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, total), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               28))
    prompt, step = tokens[:, :PREFILL_LEN], tokens[:, PREFILL_LEN:
                                                   PREFILL_LEN + 1]
    ops.reset_launch_counts()
    rows = elastic_moe.run(params, cfg, tokens, PREFILL_LEN, iters=2)
    launches, variants = ops.launch_counts(), ops.variant_counts()
    run_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    pool = rows[-1].get("graph_pool_bytes")
    full_flops = lm_model_flops(cfg, "prefill", LM_BATCH, PREFILL_LEN)
    need_k3 = cfg.moe is not None
    for r in rows:
        if r["logits"].shape != (LM_BATCH, cfg.vocab_size) or \
                not torch.isfinite(r["logits"]).all() or \
                not torch.isfinite(r.get("decode_logits", r["logits"])).all():
            raise AssertionError(f"{key} {r['name']}: bad logits")
        # a depth point of kimi's 2-layer cut runs its dense layer alone
        moe_runs = need_k3 and r["E"].get("a_layers", cfg.n_layers) \
            > cfg.n_dense_layers
        want = [k for k in FORWARD
                if k != "expert_matmul" or moe_runs]
        for st in ("prefill", "decode"):
            if f"{st}_launches" in r and min(
                    r[f"{st}_launches"][k] for k in want) <= 0:
                raise AssertionError(f"{key} {r['name']}: a kernel was not "
                                     f"launched in {st}: "
                                     f"{r[f'{st}_launches']}")
        bound = r["rel_flops"] * full_flops / PEAK_BF16_FLOPS * 1e3
        line = (f"  {key} {r['name']:24s} prefill {r['prefill_ms']:8.2f} ms"
                f" (device {r['prefill_event_ms']:8.2f}) "
                f"{r['prefill_tok_s']:8.0f} tok/s, rel flops "
                f"{r['rel_flops']:.2f} (model-FLOPs bound {bound:.2f} ms)")
        line += (f"; decode {r['decode_ms']:7.2f} ms/step (device "
                 f"{r['decode_event_ms']:7.2f}) {r['decode_tok_s']:7.1f} "
                 f"tok/s" if "decode_ms" in r
                 else "; decode n/a (sliced depth or heads: fault F4)")
        log(line)
    if not all("decode_ms" in r for r in rows[:2]):
        raise AssertionError(f"{key}: the full point or the next did not "
                             f"decode")
    need = {("elastic_matmul", "small_m"), ("elastic_matmul", "tma"),
            ("flash_attention", "wgmma"), ("flash_attention", "decode")}
    if need_k3:
        need |= {("elastic_matmul", "f32_splitk"), ("expert_matmul", "tma"),
                 ("expert_matmul", "stream")}
    main_path_variants(variants, need)
    fa_v = variants["flash_attention"]
    if fa_v["fma_bf16"] or fa_v["fma_f32"] or \
            variants["elastic_matmul"]["tile_f32"]:
        raise AssertionError(f"{key}: K2 on fma or K1 on tile_f32: "
                             f"{variants}")
    # every decode step's K2 calls on the decode kernel (granite's 48 heads
    # on one kv head in six groups, kimi's D = 112)
    for r in rows:
        dv = r.get("decode_variants", {}).get("flash_attention", {})
        if any(n for v, n in dv.items() if v != "decode"):
            raise AssertionError(f"{key} {r['name']}: decode K2 calls {dv}")
    by_stage = None
    if need_k3:
        by_stage = {stage: {v: sum(r[f"{stage}_variants"]["expert_matmul"][v]
                                   for r in rows if f"{stage}_variants" in r)
                            for v in xm.VARIANTS}
                    for stage in ("prefill", "decode")}
        k3_on_stage(by_stage)
    log(f"  {key} launches on the main path (replay-accounted, captures' "
        f"warm-ups included): {launches}")
    log(f"  {key} by variant: " + "; ".join(
        f"{k} {dict((v, n) for v, n in per.items() if n)}"
        for k, per in variants.items() if any(per.values())))
    log(f"  {key} at {rows[0]['name']}: prefill launches "
        f"{ {k: rows[0]['prefill_launches'][k] for k in FORWARD} } "
        f"(3 prefills), decode "
        f"{ {k: rows[0]['decode_launches'][k] for k in FORWARD} } "
        f"({DECODE_STEPS} steps); graph pool "
        f"{'not measured' if pool is None else f'{pool / 2**30:.2f} GiB'}, "
        f"peak {run_peak:.2f} GiB [{card}]")

    # (e) the calls of one eager prefill and one decode step at the full
    # point: each kernel's graph-replayed device time; K3's counts give the
    # routed slots the capacity keeps
    targets = [(layers_mod, "elastic_matmul_op", "k1"),
               (layers_mod, "flash_attention_op", "k2"),
               (moe_mod, "expert_matmul_op", "k3")]
    kernel_fn = {k: getattr(mod, attr) for mod, attr, k in targets}
    calls = {"k1": [], "k2": [], "k3": []}
    with torch.inference_mode(), recording(
            targets, lambda k, args, kw: calls[k].append((args, kw))):
        _, caches = lm_prefill(params, prompt, cfg, max_len=total)
        n_pre = {k: len(v) for k, v in calls.items()}
        lm_decode(params, caches, step, cfg)
    kept = kept_shares(calls["k3"], n_pre["k3"], cfg) if need_k3 else {}
    if kept:
        log(f"  {key} routed slots kept at {rows[0]['name']} (capacity "
            f"factor {cfg.moe.capacity_factor}, random router): prefill "
            f"{kept['prefill'][0]:.1%}, decode {kept['decode'][0]:.1%} "
            f"a layer")
    times = config_times(key, calls, n_pre, kernel_fn, parent)
    del calls, caches

    # the graph decode steps against eager ones at the full point (the
    # same kernels in the same order)
    with torch.inference_mode():
        t_e = time.perf_counter()
        _, caches = lm_prefill(params, prompt, cfg, max_len=total)
        eager = torch.stack([lm_decode(params, caches,
                                       tokens[:, t:t + 1], cfg)[0]
                             for t in range(PREFILL_LEN, total)])
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t_e
        del caches
    ref = eager.float()
    rel = float((rows[0]["decode_logits"].float() - ref).abs().max()
                / ref.abs().max())
    if rel > GRAPH_DECODE_REL_TOL:
        raise AssertionError(f"{key}: {DECODE_STEPS} graph decode steps "
                             f"differ from eager by {rel:.3g} of the "
                             f"largest logit (tol {GRAPH_DECODE_REL_TOL})")
    log(f"  {key} {DECODE_STEPS} graph decode steps at {rows[0]['name']} "
        f"against eager ones (prefill + steps {eager_s:.2f} s eager): max "
        f"abs err {rel:.3g} of the largest logit (tol "
        f"{GRAPH_DECODE_REL_TOL})")
    del eager, ref

    points = [{k: r[k] for k in (
        "name", "E", "rel_flops", "prefill_ms", "prefill_event_ms",
        "prefill_tok_s", "decode_ms", "decode_event_ms", "decode_tok_s")
        if k in r} for r in rows]
    for p_, r in zip(points, rows):
        for st in ("prefill", "decode"):
            if f"{st}_launches" in r:
                p_[f"{st}_launches"] = {k: r[f"{st}_launches"][k]
                                        for k in FORWARD}
    logits = lm_config_logits(key, params, cfg, dev)
    del params, rows, r, p_
    # what stays allocated past the config: cuBLAS's per-stream workspaces
    # (the yardsticks' and plain versions' streams) are the library's, and
    # are dropped before the count
    torch._C._cuda_clearCublasWorkspaces()
    after = settled_allocated()
    torch.cuda.empty_cache()
    if abs(after - m0) > MEM_SLACK:
        raise AssertionError(f"{key}: device memory {after / 2**20:.1f} MiB "
                             f"after the config against {m0 / 2**20:.1f} "
                             f"MiB before (slack {MEM_SLACK >> 20} MiB)")
    seconds = time.perf_counter() - t0
    log(f"  {key}: memory back to {after / 2**20:.1f} MiB (before "
        f"{m0 / 2**20:.1f}); ({seconds:.1f} s) [{card}]")
    return {"arch": arch_id, "layers": [cfg.n_layers, full.n_layers],
            "params": n_params, "launches": {k: launches[k]
                                             for k in FORWARD},
            "variants": {k: variants[k] for k in FORWARD},
            "k3_by_stage": by_stage, "kept": kept, "times": times,
            "graph_decode_rel_err": rel, "peak_gib": run_peak,
            "graph_pool_gib": None if pool is None else pool / 2**30,
            "points": points, "logits": logits, "seconds": seconds}


def lm_configs_phases(dev, card: str, parent=None) -> dict:
    """Phase 26: K2's new shapes (a), then each of the three LM configs
    through ``elastic_moe.run`` on the card (b), its kernel route against
    the plain route (c) and masked against sliced widths (d) at depth 2,
    and its kernels' times (e; ``parent``'s K2 beside the prefill's)."""
    t0 = phase("26. the LM configs at full width: qwen1.5-110b (8 of 80 "
               "layers), granite-20b (52), kimi-k2-1t-a32b (2 of 61); K2 at "
               "D = 112 and at 48 query heads a kv head")
    out = {"k2": k2_config_cases(dev), "configs": {}}
    for key, arch_id in LM_CONFIGS:
        out["configs"][key] = lm_config_phase(key, arch_id, dev, card,
                                              parent)
    out["seconds"] = time.perf_counter() - t0
    log(f"  ({out['seconds']:.1f} s) [{card}]")
    return out


# ---------------------------------------------------------------- phase 27
# K2's wgmma forward against its plain version at every call class of the
# port's prefill, training and serving paths: (label, B, S, T, H, KH, D,
# causal, logsumexp, q k v read in place from a fused buffer).
# Full sequence and head shapes; batch cut so that the fp32 plain version's
# (B H, S, T) scores stay ~1 GB.
WGMMA_CLASSES = (
    ("train_4k causal S=T=4096 D128 (+lse)", 1, 4096, 4096, 16, 16, 128,
     True, True, False),
    ("DiT-L/2 S=T=256 D64 (+lse)", 8, 256, 256, 16, 16, 64, False, True,
     False),
    ("deepseek prefill causal 512 D128", 4, 512, 512, 16, 16, 128, True,
     False, False),
    ("qwen prefill causal 512 H64/KH8", 4, 512, 512, 64, 8, 128, True,
     False, False),
    ("granite prefill causal 512 H48/KH1", 4, 512, 512, 48, 1, 128, True,
     False, False),
    ("kimi prefill causal 512 H64/KH8 D112", 4, 512, 512, 64, 8, 112, True,
     False, False),
    ("kimi prefill D112, q k v of a fused buffer", 2, 512, 512, 64, 8, 112,
     True, False, True),
    ("ViT S=T=197 D64, q k v of a fused buffer", 8, 197, 197, 6, 6, 64,
     False, False, True),
    ("sandwich S=T=197 D64 (+lse)", 32, 197, 197, 6, 6, 64, False, True,
     True),
    ("UNet self S=T=256 D64 (+lse)", 16, 256, 256, 10, 10, 64, False, True,
     False),
    ("the route's edge S=T=65 D128 causal (+lse)", 4, 65, 65, 8, 8, 128,
     True, True, False),
    ("UNet cross S=256 T=77 D64", 32, 256, 77, 10, 10, 64, False, True,
     False),
    ("ragged S=T=300 D128 causal (+lse)", 2, 300, 300, 16, 8, 128, True,
     True, False),
    ("ragged S=T=300 D64 (+lse)", 2, 300, 300, 8, 8, 64, False, True,
     False),
    ("S=256 T=4096 D128", 1, 256, 4096, 16, 16, 128, False, False, False),
)


def k2_wgmma_cases(dev) -> dict:
    """Phase 27 (a): K2's wgmma forward against the plain version on fp32
    copies of the same bf16 inputs at every call class of
    ``WGMMA_CLASSES``, o and (where the training paths ask for it) the
    logsumexp: eagerly, twice bit for bit, and under 3 replays of a CUDA
    graph (``repeatable``), one ``wgmma`` launch a call.  q and k are
    ``QK_SCALE`` x randn as in phase 26 (a), so the softmax picks a few
    keys, and the script checks that a kernel that ignored the scores or
    answered with another query head's row would miss the tolerance."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(27)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).to(torch.bfloat16)

    tol = ATTN_TOL["bfloat16"]
    errs, wrong = {}, {}
    for label, B, S, T, H, KH, D, causal, lse, fused in WGMMA_CLASSES:
        sc = QK_SCALE
        if fused:           # (B, S, H + 2 KH, D): q, k, v strided views
            if S != T:
                raise AssertionError(f"{label}: a fused buffer needs S = T")
            buf = randn(B, S, H + 2 * KH, D)
            buf[:, :, :H + KH] *= sc
            q, k, v = buf[:, :, :H], buf[:, :, H:H + KH], buf[:, :, H + KH:]
        else:
            q, k, v = randn(B, S, H, D, scale=sc), \
                randn(B, T, KH, D, scale=sc), randn(B, T, KH, D)
        want_v = fa.choose_variant(S, T, H, KH, D, torch.bfloat16,
                                   fa._aligned(q, k, v))
        if want_v != "wgmma":
            raise AssertionError(f"{label}: routed to {want_v}")
        want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal=causal, return_lse=lse)
        b0 = dict(fa.variant_launches)
        with torch.inference_mode():
            err = repeatable(lambda: fa.flash_attention(
                q, k, v, causal=causal, return_lse=lse), want, tol,
                f"K2 wgmma {label}")
        ran = {n: c - b0[n] for n, c in fa.variant_launches.items()
               if c != b0[n]}
        # two eager calls and the captured one (a bare capture counts its
        # launch once; its replays add nothing)
        if ran != {"wgmma": 3}:
            raise AssertionError(f"K2 {label}: launches {ran}, not 3 on "
                                 f"wgmma")
        errs[label] = err
        # what the check would see of a kernel that ignored the scores, or
        # answered each head with the next head's row
        o_want = (want[0] if lse else want).float()
        for name, qw in (("no scores", q * 0),
                         ("the next head's", q.roll(1, dims=2))):
            ow = fa.flash_attention_plain(qw.float(), k.float(), v.float(),
                                          causal=causal)
            d = float((ow - o_want).abs().max())
            if bool(((ow - o_want).abs()
                     <= tol + tol * o_want.abs()).all()):
                raise AssertionError(f"{label}: {name} would pass the check")
            wrong[f"{label}: {name}"] = d
        log(f"  {label:44s} max abs err {err:.3g} (tol {tol}), eager and "
            f"3 graph replays bit for bit; 'no scores' "
            f"{wrong[f'{label}: no scores']:.3g}, 'the next head's' "
            f"{wrong[f'{label}: the next head' + chr(39) + 's']:.3g} away")
        del q, k, v, want, o_want
    return {"errs": errs, "max_abs_err": max(errs.values()),
            "wrong_min": min(wrong.values())}


# phase 27 (b): the route's evidence at each call class's full size (the
# rows of PERF.md): (label, B, S, T, H, KH, D, causal, logsumexp)
ROUTE_CLASSES = (
    ("train_4k microbatch", 4, 4096, 4096, 16, 16, 128, True, True),
    ("DiT-L/2 step", 256, 256, 256, 16, 16, 64, False, True),
    ("sandwich step", 256, 197, 197, 6, 6, 64, False, True),
    ("ViT serving, bucket 8", 8, 197, 197, 6, 6, 64, False, False),
    ("deepseek prefill", 4, 512, 512, 16, 16, 128, True, False),
    ("qwen prefill", 4, 512, 512, 64, 8, 128, True, False),
    ("granite prefill", 4, 512, 512, 48, 1, 128, True, False),
    ("kimi prefill", 4, 512, 512, 64, 8, 112, True, False),
    ("UNet self S=T=256", 32, 256, 256, 10, 10, 64, False, True),
    ("UNet cross S=256 T=77", 32, 256, 77, 10, 10, 64, False, True),
    ("UNet self S=T=64", 32, 64, 64, 20, 20, 64, False, True),
    ("UNet cross S=64 T=77", 32, 64, 77, 20, 20, 64, False, True),
)


def k2_route_rows(dev) -> dict:
    """Phase 27 (b): one call of each of ``ROUTE_CLASSES`` on the wgmma
    forward and on mma (each forced on the same inputs), and SDPA, as
    graph-replayed device time, beside the call's bound: the evidence for
    ``flash_attention.choose_variant``'s rule.  Timed in turns mma,
    wgmma, wgmma, mma."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(272)
    rows = {}
    target = [(fa, "choose_variant", "choose")]
    for label, B, S, T, H, KH, D, causal, lse in ROUTE_CLASSES:
        q = torch.randn((B, S, H, D), generator=g, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((B, T, KH, D), generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2))
        nb, no, _ = k2_work((q, k, v), {"causal": causal})
        bound, by = kernel_bound_ms(nb, no)

        def call():
            fa.flash_attention(q, k, v, causal=causal, return_lse=lse)
        ts = {"mma": [], "wgmma": []}
        with torch.inference_mode():
            for v_ in ("mma", "wgmma", "wgmma", "mma"):
                with routed(target, {"choose": lambda *a, _v=v_: _v}):
                    b0 = fa.variant_launches[v_]
                    call()
                    if fa.variant_launches[v_] == b0:
                        raise AssertionError(f"{label}: not on {v_}")
                    ts[v_].append(graph_time_ms(call)[0])
            sdpa = graph_time_ms(lambda: k2_library(q, k, v,
                                                    causal=causal))[0]
        route = fa.choose_variant(S, T, H, KH, D, torch.bfloat16,
                                  fa._aligned(q, k, v))
        w, m = (statistics.mean(ts[x]) for x in ("wgmma", "mma"))
        rows[label] = {"wgmma_ms": w, "mma_ms": m, "library_ms": sdpa,
                       "bound_ms": bound, "bound_by": by, "route": route,
                       "runs": ts}
        log(f"  {label:24s} B={B} S={S} T={T} H={H}/{KH} D={D}"
            f"{' causal' if causal else ''}: wgmma {w:.4f} ms, mma "
            f"{m:.4f} ms, sdpa {sdpa:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"wgmma / mma {w / m:.2f}, wgmma / sdpa {w / sdpa:.2f}; the "
            f"route takes {route} (faster: {'wgmma' if w < m else 'mma'})")
        del q, k, v
    return rows


def wgmma_phases(dev, card: str) -> dict:
    """Phase 27: K2's wgmma forward (a) against the plain version at
    every call class and (b) against mma, the route's evidence."""
    t0 = phase("27. K2's wgmma forward: (a) vs plain at every call class "
               "of the prefill, training and serving paths, eager and "
               "under CUDA-graph replay; (b) wgmma, mma and SDPA at each "
               "class's full size (graph-replayed device time)")
    out = {"cases": k2_wgmma_cases(dev)}
    t1 = phase("27. (b) the route's evidence")
    out["route"] = k2_route_rows(dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"  (b) {time.perf_counter() - t1:.1f} s; phase 27 "
        f"{out['seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------- phase 28
# deepseek-moe-16b served across a (1, 2) mesh, both ranks on the one card
# over gloo: the a2a expert dispatch (32 experts a rank) and the decode
# cache sharded over the sequence (264 of 528 slots a rank).  (a) prefills
# 260 tokens so that the 8 decode steps write slots 260 .. 267, across the
# boundary at 264, at a capacity factor where no routed slot drops (64
# experts / top-6: each expert's capacity is every token of the group)
MESH = (1, 2)
MESH_SEED = 28
MESH_SLOTS = 528
MESH_A_PREFILL, MESH_A_STEPS = 260, 8
MESH_MAIN_STEPS = 8      # the launcher's decode steps after 512 tokens
MESH_NO_DROP_CF = 64 / 6
# K2 decode with the logsumexp, against the plain version on fp32 copies:
# (global fill) cases of a 528-slot cache split in two; at 264, 200 and 1
# the second shard holds no key (o 0, lse -inf), at 400 both shards carry
# weight, so a merge without a shard's partial, or with the shards'
# weights swapped, lands far from the whole attention
MESH_K2_FILLS = (400, 300, 264, 200, 1)
MESH_WRONG_FILL = 400
# the lse of the kernel against the plain version's (fp32 scores of the
# same bf16 inputs: round-off only)
LSE_TOL = 1e-3
# (a) the ranks' own routing against the one-process routing, by stage:
# the share of token-layer routings a rank sends to another expert set.
# Prefill: the router sees the same rows (520 a rank, 1040 in one
# process), and the call's size only changes K1's f32_splitk split of K:
# on the card its probabilities stayed within 3.6e-7 and no token moved,
# so the limits are round-off's.  Decode: the sharded merge and the
# partial combine round the hidden states otherwise; on the card 8.2% of
# routings moved (7-11 a step, not growing), where bf16 rounding alone
# (the kernel route against the plain route, (b)) moved 12.0% at decode
# and 10.0-10.7% at prefill: the limit is that share (PERF.md §6)
MESH_PREFILL_REROUTE_MAX = 1e-3
MESH_DECODE_REROUTE_MAX = 0.12
MESH_ROUTER_ROUNDOFF = 1e-6


def mesh_probe(mesh, dev) -> dict:
    """Each collective the mesh path uses, on CUDA tensors through gloo,
    its values checked (raises on a wrong value; a collective gloo
    refused would raise here first)."""
    import torch

    from repro_torch.distributed import ctx
    group = ctx.axes_group(mesh, mesh.mesh_dim_names)
    r, n = ctx.axes_index(mesh, mesh.mesh_dim_names), mesh.size()
    got = {}
    t = torch.full((4,), float(r + 1), device=dev)
    got["all_reduce sum"] = float(ctx.all_reduce(t, "sum", group)[0]) \
        == n * (n + 1) / 2
    t = torch.full((4,), float(r + 1), device=dev, dtype=torch.bfloat16)
    got["all_reduce max bf16"] = float(ctx.all_reduce(t, "max", group)[0]) \
        == n
    g = ctx.all_gather(torch.full((2, 3), float(r), device=dev), group)
    got["all_gather_into_tensor"] = g[:, 0, 0].tolist() == list(range(n))
    a = ctx.all_to_all(torch.arange(n, dtype=torch.int32, device=dev)
                       + 10 * r, group)
    got["all_to_all_single int32"] = a.tolist() == [10 * s + r
                                                    for s in range(n)]
    # reduce_scatter_tensor on fp32 and bf16, as training's FSDP
    # gradients and gathered activations take it
    for dt in (torch.float32, torch.bfloat16):
        rs = ctx.reduce_scatter(torch.arange(2 * n, dtype=dt, device=dev)
                                + r, group)
        got[f"reduce_scatter_tensor {str(dt)[6:]}"] = rs.float().tolist() \
            == [float(n * (2 * r + i) + n * (n - 1) / 2) for i in range(2)]
    if not all(got.values()):
        raise AssertionError(f"gloo collectives on CUDA tensors: {got}")
    return got


@contextlib.contextmanager
def pinned_router(moe_mod, tape: list, mesh, B: int, S: int):
    """Hand each MoE router call of a rank the one-process run's routing
    from ``tape`` (its (probs, gates, experts) over all B x S tokens),
    cut to the tokens the call routes: a prefill's a2a block (this rank's
    rows and sequence slice) or every token (the decode's dispatch); a
    tape of this rank's own calls is handed back as it is.  The rank's
    own routing is computed too, and the yielded dict keeps, by stage
    (prefill: a call of more than B rows), the tokens whose expert set
    differs from the tape's (at decode also per call), the largest
    |probability| difference, and the tape's largest margin between its
    k-th and (k+1)-th expert at such a token.  A block cut from the tape
    is also routed at the tape call's size (its rows repeated to the
    tape's row count: rows are computed independently, the call's size
    picks K1's split of K), which must give the tape's routing bit for
    bit (``same_at_full_size``: None when no block was cut)."""
    import torch

    from repro_torch.distributed import ctx
    orig, it = moe_mod._router, iter(list(tape))
    seen = {st: {"rerouted": 0, "tokens": 0, "calls": 0, "prob_diff": 0.0,
                 "margin": 0.0} for st in ("prefill", "decode")}
    seen["prefill"]["same_at_full_size"] = None
    seen["decode"]["per_call"] = []
    b_axes = tuple(a for a in mesh.mesh_dim_names if a != "model")
    n_b, n_s = ctx.axes_size(mesh, b_axes), ctx.axes_size(mesh, ("model",))
    bi, si = ctx.axes_index(mesh, b_axes), ctx.axes_index(mesh, ("model",))

    def router(p, x, cfg, a_experts, top_k):
        own = orig(p, x, cfg, a_experts, top_k)
        lead = x.shape[:-1]
        entry = next(it)
        rows = entry[0][..., 0].numel()
        block = lead.numel() != rows            # an a2a block of the tape
        out = []
        for t in entry:
            t = t.to(x.device)
            if block:
                t = t.reshape(B, S, t.shape[-1])
                t = t[bi * B // n_b:(bi + 1) * B // n_b,
                      si * S // n_s:(si + 1) * S // n_s]
            out.append(t.reshape(*lead, t.shape[-1]))
        st = seen["prefill" if lead.numel() > B else "decode"]
        a, b = own[2].sort(-1).values, out[2].sort(-1).values
        moved = (a != b).any(-1)
        st["rerouted"] += int(moved.sum())
        if "per_call" in st:
            st["per_call"].append(int(moved.sum()))
        st["tokens"] += a[..., 0].numel()
        st["calls"] += 1
        st["prob_diff"] = max(st["prob_diff"],
                              float((own[0] - out[0]).abs().max()))
        if bool(moved.any()):
            top = out[0].topk(top_k + 1, dim=-1).values
            st["margin"] = max(st["margin"], float(
                (top[..., top_k - 1] - top[..., top_k])[moved].max()))
        if block:
            xf = x.reshape(-1, x.shape[-1])
            full = orig(p, xf.repeat(rows // xf.shape[0], 1), cfg,
                        a_experts, top_k)
            n = xf.shape[0]
            st["same_at_full_size"] = st["same_at_full_size"] is not False \
                and all(torch.equal(f[:n], o.reshape(n, -1))
                        for f, o in zip(full, out))
        return tuple(out)
    moe_mod._router = router
    try:
        yield seen
    finally:
        moe_mod._router = orig
    if next(it, None) is not None:
        raise AssertionError("the pinned run routed fewer layers")


def mesh_rank(rank: int, world: int, init_file: str, tape_file: str) -> dict:
    """One rank of phase 28 (its own process, on cuda:0 beside the other
    rank): the gloo probe, the launcher's serving run at every operating
    point (the main path: launch counters reset before, read after), (b)
    the kernel route against the plain route on one routing at the
    config's capacity factor, and (a) the one-process run's routing pinned
    at a capacity factor where nothing drops.  Returns plain values."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed import ctx
    from repro_torch.kernels import ops
    from repro_torch.launch import elastic_moe as lm_launch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import lm_decode, lm_prefill
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import lm_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = ctx.init_ranks(rank, world, init_file, "cuda")
    mesh = make_mesh(MESH, ("data", "model"))
    out = {"rank": rank, "probe": mesh_probe(mesh, dev)}
    cfg = lm_launch.mesh_config(get_arch("deepseek-moe-16b").make_config())
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    params = lm_init(gen, cfg, device=dev, dtype=cfg.cdtype(),
                     shard=lm_launch.rank_shard(mesh))
    tokens = torch.randint(0, cfg.vocab_size,
                           (LM_BATCH, PREFILL_LEN + MESH_MAIN_STEPS),
                           generator=gen, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(t.numel() for t in _tensors(params))
    out["param_gib"] = sum(t.numel() * t.element_size()
                           for t in _tensors(params)) / 2 ** 30
    # the main path: the launcher's run on this rank, counters from here
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    rows = lm_launch.run(params, cfg, tokens, PREFILL_LEN, iters=1,
                         mesh=mesh)
    torch.cuda.synchronize()
    out["launches"] = ops.launch_counts()
    out["variants"] = ops.variant_counts()
    out["main_s"] = time.perf_counter() - t0
    out["points"] = [dict({k: r.get(k) for k in (
        "name", "prefill_ms", "prefill_event_ms", "decode_ms",
        "decode_event_ms", "prefill_kept", "decode_kept")},
        finite=bool(torch.isfinite(r["logits"]).all()) and bool(
            torch.isfinite(r.get("decode_logits", r["logits"])).all()),
        prefill_variants=r["prefill_variants"],
        decode_variants=r.get("decode_variants")) for r in rows]
    del rows
    # (b) kernel route vs plain route on the plain route's routing, at
    # the config's own capacity factor; K3's prefill calls recorded
    prompt, nxt = tokens[:, :PREFILL_LEN], \
        tokens[:, PREFILL_LEN:PREFILL_LEN + 1]
    tape, k3 = [], []

    def sink(key, args, kw):
        x, w, c = args
        if x.shape[1] > 16:                   # the prefill's slabs
            k3.append((tuple(x.shape), tuple(w.shape), c.cpu().numpy()))
    with torch.inference_mode():
        with ops.plain_kernels(), router_tape(moe_mod, tape):
            lp, cp = lm_prefill(params, prompt, cfg, max_len=MESH_SLOTS,
                                mesh=mesh)
            dp = lm_decode(params, cp, nxt, cfg, mesh=mesh)[0]
        del cp
        # the plain route's routing handed to the kernel route, whose own
        # routing is counted: the reroutes of bf16 rounding alone
        with pinned_router(moe_mod, tape, mesh, LM_BATCH, PREFILL_LEN) \
                as seen_b, recording(
                    [(moe_mod, "expert_matmul_op", "k3")], sink):
            lk, ck = lm_prefill(params, prompt, cfg, max_len=MESH_SLOTS,
                                mesh=mesh)
            dk = lm_decode(params, ck, nxt, cfg, mesh=mesh)[0]
        del ck
        torch.cuda.synchronize()
        out["b_err"] = {"prefill": close(lk, lp, LM_LOGITS_BF16_PINNED_TOL),
                        "decode": close(dk, dp, LM_LOGITS_BF16_PINNED_TOL)}
        out["b_rerouted"] = seen_b
        out["k3_calls"] = k3
        # (a) the one-process run's routing, nothing dropped
        cfg_a = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MESH_NO_DROP_CF))
        toks = torch.randint(0, cfg.vocab_size,
                             (LM_BATCH, MESH_A_PREFILL + MESH_A_STEPS),
                             generator=torch.Generator(device=dev)
                             .manual_seed(MESH_SEED + 1), device=dev)
        tape_a = torch.load(tape_file)
        with pinned_router(moe_mod, tape_a, mesh, LM_BATCH,
                           MESH_A_PREFILL) as seen, \
                moe_mod.dispatch_tally() as tally:
            la, ca = lm_prefill(params, toks[:, :MESH_A_PREFILL], cfg_a,
                                max_len=MESH_SLOTS, mesh=mesh)
            outs = [lm_decode(params, ca, toks[:, t:t + 1], cfg_a,
                              mesh=mesh)[0]
                    for t in range(MESH_A_PREFILL,
                                   MESH_A_PREFILL + MESH_A_STEPS)]
        out["a_kept"] = lm_launch.kept_share(tally, mesh)
        out["a_rerouted"] = seen
        c0 = ca["moe"][0]
        out["a_cache"] = {"len": int(c0["len"]), "fill": c0["fill"],
                          "block": tuple(c0["k"].shape),
                          "written": int((c0["k"].abs().sum((0, 2, 3)) > 0)
                                         .sum())}
        out["a_prefill"] = la.float().cpu().numpy()
        out["a_decode"] = torch.stack(outs).float().cpu().numpy()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def k2_dec_lse(q, k, v, causal=False, kv_len=None):
    from repro_torch.kernels import ops
    return ops.flash_attention_op(q, k, v, causal=causal, kv_len=kv_len,
                                  return_lse=True)


def k2_dec_lse_plain(q, k, v, causal=False, kv_len=None):
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                    return_lse=True)


def merge_shards(parts, weights_of=None):
    """The sharded decode's merge of per-shard (o, lse): sum_r
    exp(lse_r - M) o_r / sum_r exp(lse_r - M), in fp32.  ``weights_of``
    reorders the weights (a wrong answer)."""
    import torch
    os_ = [o.float() for o, _ in parts]
    ls = [lse[..., 0] for _, lse in parts]
    m = torch.stack(ls).max(0).values
    w = [torch.exp(lse - m) for lse in ls]
    if weights_of is not None:
        w = [w[i] for i in weights_of]
    num = sum(wi[:, None, :, None] * o for wi, o in zip(w, os_))
    return num / sum(w).clamp(min=1e-30)[:, None, :, None]


def k2_decode_lse_checks(dev) -> dict:
    """Phase 28 (c): K2 ``decode`` with its logsumexp against the plain
    version on fp32 copies, over each half of a 528-slot cache at the
    global fills of ``MESH_K2_FILLS`` (a half with no key among them),
    the halves merged as the sharded decode merges them against the whole
    attention; the merge without the second half's partial, and with the
    halves' weights swapped, shown to fail."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(MESH_SEED)
    B, H, KH, D, T = LM_BATCH, 16, 16, 128, MESH_SLOTS
    half = T // 2

    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=g) * scale).to(dev, torch.bfloat16)
    q, k, v = randn(B, 1, H, D, scale=1.5), randn(B, T, KH, D, scale=1.5), \
        randn(B, T, KH, D)
    tol = ATTN_TOL["bfloat16"]
    out = {"o_err": 0.0, "lse_err": 0.0, "merge_err": 0.0, "cases": {}}
    for fill in MESH_K2_FILLS:
        parts = []
        for r in range(2):
            kr, vr = k[:, r * half:(r + 1) * half], v[:, r * half:(r + 1)
                                                        * half]
            n = torch.tensor(min(max(fill - r * half, 0), half),
                             dtype=torch.int32, device=dev)
            before = fa.variant_launches["decode"]
            o, lse = k2_dec_lse(q, kr, vr, kv_len=n)
            if fa.variant_launches["decode"] != before + 1:
                raise AssertionError("K2 decode with lse took another "
                                     "variant")
            po, pl = k2_dec_lse_plain(q.float(), kr.float(), vr.float(),
                                      kv_len=n)
            torch.cuda.synchronize()
            if torch.isnan(o).any() or torch.isnan(lse).any():
                raise AssertionError(f"NaN at fill {fill}, shard {r}")
            oe = close(o, po, tol)
            if int(n) == 0:
                if not (bool((o == 0).all()) and
                        bool(torch.isneginf(lse).all())):
                    raise AssertionError("a shard with no key must give o "
                                         "0 and lse -inf")
                le = 0.0
            else:
                le = close(lse, pl, LSE_TOL)
            out["o_err"] = max(out["o_err"], oe)
            out["lse_err"] = max(out["lse_err"], le)
            parts.append((o, lse))
        whole = fa.flash_attention_plain(
            q.float(), k.float(), v.float(), causal=False,
            kv_len=torch.tensor(fill, dtype=torch.int32, device=dev))
        me = close(merge_shards(parts), whole, tol)
        out["merge_err"] = max(out["merge_err"], me)
        out["cases"][fill] = me
        if fill == MESH_WRONG_FILL:
            wrong = {}
            for name, got in (
                    ("without the second shard's partial",
                     merge_shards(parts[:1])),
                    ("the shards' weights swapped",
                     merge_shards(parts, weights_of=(1, 0)))):
                far = float((got - whole).abs().max())
                try:
                    close(got, whole, tol)
                except AssertionError:
                    wrong[name] = far
                    continue
                raise AssertionError(f"a merge {name} passed the check")
            out["wrong_answers"] = wrong
    log(f"  (c) K2 decode + lse vs plain (fp32 copies) over each half of "
        f"a {T}-slot cache at fills {MESH_K2_FILLS}: o max abs err "
        f"{out['o_err']:.4g} (tol {tol}), lse {out['lse_err']:.4g} (tol "
        f"{LSE_TOL}), o 0 and lse -inf where a half holds no key, no NaN; "
        f"merged vs whole attention {out['merge_err']:.4g}; wrong answers "
        + ", ".join(f"{k} {v:.3g} away" for k, v in
                    out["wrong_answers"].items()))
    return out


def mesh_phases(dev, card: str) -> dict:
    """Phase 28: deepseek-moe-16b served across 2 ranks sharing the card
    (gloo): the one-process route first (einsum dispatch, unsharded
    decode, in this process, its routing recorded and its weights freed),
    then the ranks (:func:`mesh_rank`), then (a)'s comparison, (c) K2
    decode with the logsumexp and (d) K3 at the a2a shape, each with a
    graph-replayed row."""
    import gc
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed import ctx
    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import expert_matmul as xm
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import lm_decode, lm_prefill
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import lm_init
    t_all = phase("28. deepseek-moe-16b served across a 1 x 2 mesh, two "
                  "ranks sharing the card over gloo (a2a expert dispatch, "
                  "sequence-sharded decode on K2 decode + lse); not a "
                  "multi-card speed")
    out = {}
    t0 = time.perf_counter()
    full = get_arch("deepseek-moe-16b").make_config()
    cfg1 = dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, capacity_factor=MESH_NO_DROP_CF))
    m0 = settled_allocated()
    tape = []
    with torch.inference_mode():
        params = lm_init(torch.Generator(device=dev).manual_seed(MESH_SEED),
                         cfg1, device=dev, dtype=cfg1.cdtype())
        toks = torch.randint(0, cfg1.vocab_size,
                             (LM_BATCH, MESH_A_PREFILL + MESH_A_STEPS),
                             generator=torch.Generator(device=dev)
                             .manual_seed(MESH_SEED + 1), device=dev)
        with router_tape(moe_mod, tape), moe_mod.dispatch_tally() as tally:
            last, caches = lm_prefill(params, toks[:, :MESH_A_PREFILL], cfg1,
                                      max_len=MESH_SLOTS)
            steps = [lm_decode(params, caches, toks[:, t:t + 1], cfg1)[0]
                     for t in range(MESH_A_PREFILL,
                                    MESH_A_PREFILL + MESH_A_STEPS)]
        one = {"prefill": last.float().cpu(),
               "decode": torch.stack(steps).float().cpu()}
        kept, routed = tally.counts()
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        tape_file = os.path.join(tmp, "tape.pt")
        torch.save([tuple(t.cpu() for t in e) for e in tape], tape_file)
        del params, caches, last, steps, tape, toks
        gc.collect()
        torch.cuda.empty_cache()
        freed = settled_allocated()
        log(f"  one-process route (einsum dispatch, unsharded decode, cf "
            f"{MESH_NO_DROP_CF:.4g}): prefill {MESH_A_PREFILL} + "
            f"{MESH_A_STEPS} decode steps in "
            f"{time.perf_counter() - t0:.1f} s, kept {kept} of {routed} "
            f"routed slots; weights freed ({freed / 2 ** 20:.0f} MiB "
            f"allocated, {m0 / 2 ** 20:.0f} before)")
        if kept != routed:
            raise AssertionError("the one-process route dropped slots")
        t1 = time.perf_counter()
        ranks = ctx.spawn_ranks(mesh_rank, 2, (os.path.join(
            tmp, "rendezvous"), tape_file), timeout_s=900)
    out["ranks_s"] = time.perf_counter() - t1
    r0 = ranks[0]
    log(f"  ranks: {len(ranks)} on cuda:0 over gloo in {out['ranks_s']:.1f} "
        f"s (spawn, init, every phase); gloo on CUDA tensors: "
        f"{sorted(k for k, ok in r0['probe'].items() if ok)}")
    for r in ranks:
        log(f"  rank {r['rank']}: {r['params'] / 1e9:.2f} B parameters "
            f"({r['param_gib']:.2f} GiB; drawn leaf by leaf in "
            f"{r['init_s']:.1f} s), peak {r['peak_gib']:.2f} GiB, main path "
            f"{r['main_s']:.1f} s")
    # the main path's operating points, as rank 0 measured them
    log(f"  {'operating point':24s} {'prefill':>10s} {'(events)':>10s} "
        f"{'decode/step':>12s} {'(events)':>10s} {'kept prefill':>13s} "
        f"{'decode':>7s} [{card}]")
    bad = [(r["rank"], p["name"]) for r in ranks for p in r["points"]
           if not p["finite"]]
    if bad:
        raise AssertionError(f"non-finite logits at {bad}")
    for p in r0["points"]:
        dec = (f"{p['decode_ms']:10.2f}ms {p['decode_event_ms']:8.2f}ms"
               if p["decode_ms"] is not None else f"{'n/a (F4)':>23s}")
        log(f"  {p['name']:24s} {p['prefill_ms']:8.2f}ms "
            f"{p['prefill_event_ms']:8.2f}ms {dec} "
            f"{100 * p['prefill_kept']:12.1f}% "
            + (f"{100 * p['decode_kept']:6.1f}%" if p["decode_kept"]
               is not None else "    n/a"))
    # every kernel of the path launched on every rank, on the variants
    # the shapes should take
    for r in ranks:
        if min(r["launches"][k] for k in FORWARD) <= 0:
            raise AssertionError(f"rank {r['rank']}: a kernel of the mesh "
                                 f"path never launched: {r['launches']}")
        main_path_variants(r["variants"], need={
            ("elastic_matmul", "small_m"), ("elastic_matmul", "tma"),
            ("elastic_matmul", "f32_splitk"), ("flash_attention", "wgmma"),
            ("flash_attention", "decode"), ("expert_matmul", "tma"),
            ("expert_matmul", "stream")})
        p = r["points"][0]
        k3_on_stage({"prefill": p["prefill_variants"]["expert_matmul"],
                     "decode": p["decode_variants"]["expert_matmul"]})
        if p["decode_variants"]["flash_attention"]["decode"] == 0:
            raise AssertionError("the sharded decode did not run K2 decode")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in FORWARD}
    variants = {k: {v: sum(r["variants"][k][v] for r in ranks)
                    for v in r0["variants"][k]} for k in FORWARD}
    log(f"  launches on the mesh path (both ranks): {launches}; by variant "
        + str({k: {v: n for v, n in per.items() if n}
               for k, per in variants.items()}))
    # (b) the kernel route against the plain route on one routing
    out["b_err"] = {r["rank"]: r["b_err"] for r in ranks}
    log(f"  (b) kernel route vs plain route at cf "
        f"{full.moe.capacity_factor} on the plain route's routing, prefill "
        f"{LM_BATCH} x {PREFILL_LEN} and one decode step: "
        + ", ".join(f"rank {k}: prefill {v['prefill']:.4g}, decode "
                    f"{v['decode']:.4g}" for k, v in out["b_err"].items())
        + f" (tol {LM_LOGITS_BF16_PINNED_TOL})")
    # (a) the 2-rank run against the one-process route
    out["a_err"] = {}
    for r in ranks:
        if r["a_kept"] != 1.0:
            raise AssertionError(f"rank {r['rank']} dropped slots in (a): "
                                 f"kept {r['a_kept']}")
        c = r["a_cache"]
        if c["len"] != MESH_A_PREFILL + MESH_A_STEPS or c["block"][1] != \
                MESH_SLOTS // 2:
            raise AssertionError(f"rank {r['rank']}: cache {c}")
        out["a_err"][r["rank"]] = {
            "prefill": close(torch.from_numpy(r["a_prefill"]),
                             one["prefill"], LM_LOGITS_BF16_PINNED_TOL),
            "decode": close(torch.from_numpy(r["a_decode"]), one["decode"],
                            LM_LOGITS_BF16_PINNED_TOL)}
    written = [r["a_cache"]["written"] for r in ranks]
    if written != [MESH_SLOTS // 2,
                   MESH_A_PREFILL + MESH_A_STEPS - MESH_SLOTS // 2]:
        raise AssertionError(f"slots written per rank {written}: the decode "
                             f"writes did not cross the shard boundary")
    # the ranks' own routing against the pinned one, by stage: a prefill
    # block routed at the one-process call's size gives its routing bit
    # for bit (so the block's rows and the router are right, and what
    # differs is K1's split of K at the block's size); the shares of
    # tokens routed elsewhere stay under the stated limits
    plans = {n: em.f32_splitk_plan(n, full.d_model, full.moe.n_experts)
             for n in (LM_BATCH * MESH_A_PREFILL,
                       LM_BATCH * MESH_A_PREFILL // MESH[1])}
    n_moe = full.n_moe_layers
    for r in ranks:
        for key, what in (("a_rerouted", "(a) 2 ranks vs the one-process "
                           "route"), ("b_rerouted", "(b) kernel route vs "
                           "plain route, 2 ranks (bf16 rounding alone)")):
            for st, cap in (("prefill", MESH_PREFILL_REROUTE_MAX),
                            ("decode", MESH_DECODE_REROUTE_MAX)):
                a = r[key][st]
                a["share"] = a["rerouted"] / a["tokens"]
                pc = a.get("per_call", [])
                steps = [sum(pc[i:i + n_moe]) for i in range(0, len(pc),
                                                              n_moe)]
                log(f"  {what}, rank {r['rank']} {st}: its own routing "
                    f"differs from the pinned one at {a['rerouted']} of "
                    f"{a['tokens']} token-layer routings "
                    f"({100 * a['share']:.3f}%"
                    + (f", limit {100 * cap:.3g}%" if key == "a_rerouted"
                       else "")
                    + f") over {a['calls']} router calls"
                    + (f" (by step {steps})" if st == "decode" else "")
                    + f"; largest |probability| difference "
                    f"{a['prob_diff']:.3g}, largest pinned margin between "
                    f"the k-th and (k+1)-th expert at a rerouted token "
                    f"{a['margin']:.3g}"
                    + (f"; the block routed at the one-process call's "
                       f"size: {'the same bits' if a['same_at_full_size'] else 'DIFFERENT'}"
                       f" (K1 f32_splitk (splits, K rows) by rows: {plans})"
                       if a.get("same_at_full_size") is not None else ""))
                if key == "a_rerouted" and a["share"] > cap:
                    raise AssertionError(f"rank {r['rank']}: {st} rerouted "
                                         f"{a['share']:.4f} > {cap}")
        pre = r["a_rerouted"]["prefill"]
        if not pre["same_at_full_size"]:
            raise AssertionError(f"rank {r['rank']}: its prefill block "
                                 f"routed at the one-process size differs "
                                 f"from the one-process routing")
        if pre["prob_diff"] > MESH_ROUTER_ROUNDOFF:
            raise AssertionError(f"rank {r['rank']}: prefill router "
                                 f"probabilities {pre['prob_diff']:.3g} "
                                 f"from the one-process ones")
    log(f"  (a) 2 ranks vs the one-process route at cf "
        f"{MESH_NO_DROP_CF:.4g} (kept 100% on both ranks), its routing "
        f"pinned, prefill 4 x 260 and 8 decode steps writing "
        f"slots 260 .. 267 (slots written per rank {written}, cache len "
        f"{r0['a_cache']['len']}): "
        + ", ".join(f"rank {k}: prefill {v['prefill']:.4g}, decode "
                    f"{v['decode']:.4g}" for k, v in out["a_err"].items())
        + f" (tol {LM_LOGITS_BF16_PINNED_TOL})")
    # (c) K2 decode with the logsumexp; its row over one rank's decode
    # step (28 calls: 264 slots, all valid, as rank 0's from fill 264)
    out["k2"] = k2_decode_lse_checks(dev)
    g = torch.Generator().manual_seed(MESH_SEED + 2)
    full_n = torch.tensor(MESH_SLOTS // 2, dtype=torch.int32, device=dev)
    dec_calls = []
    for _ in range(full.n_layers):
        q = torch.randn((LM_BATCH, 1, full.n_heads, full.d_head),
                        generator=g).to(dev, torch.bfloat16)
        kv = torch.randn((2, LM_BATCH, MESH_SLOTS // 2, full.n_kv_heads,
                          full.d_head), generator=g).to(dev, torch.bfloat16)
        dec_calls.append(((q, kv[0], kv[1]),
                          {"causal": False, "kv_len": full_n}))
    out["k2_row"] = time_rows(
        "K2 decode + lse, one rank's decode step (T_loc 264)", dec_calls,
        k2_dec_lse, k2_dec_lse_plain, k2_library, "sdpa", k2_work)
    del dec_calls
    # (d) K3 at the a2a shape: rank 0's prefill calls at their live counts
    calls, ws, k3_err = [], {}, 0.0
    g = torch.Generator().manual_seed(MESH_SEED + 3)
    for xs, wsh, c in r0["k3_calls"]:
        if wsh not in ws:
            ws[wsh] = (torch.randn(wsh, generator=g) * wsh[1] ** -0.5).to(
                dev, torch.bfloat16)
        x = torch.randn(xs, generator=g).to(dev, torch.bfloat16)
        cnt = torch.from_numpy(c).to(dev)
        calls.append(((x, ws[wsh], cnt), {}))
    for (x, w, cnt), _ in calls[:3]:
        y = ops.expert_matmul_op(x, w, cnt)
        yp = xm.expert_matmul_plain(x, w, cnt)
        torch.cuda.synchronize()
        k3_err = max(k3_err, close(y, yp, EXPERT_TOL["bfloat16"]))
    live = [int(c.sum()) for (_, _, c), _ in calls]
    out["k3_err"] = k3_err
    out["k3_row"] = time_rows(
        f"K3 a2a prefill (E_loc {calls[0][0][0].shape[0]}, "
        f"{MESH[1]} x {calls[0][0][0].shape[1] // MESH[1]} rows, live rows "
        f"{min(live)}-{max(live)} of {calls[0][0][0].shape[0] * calls[0][0][0].shape[1]})",
        calls, xm.expert_matmul, xm.expert_matmul_plain,
        lambda x, w, c: torch.bmm(x, w), "torch.bmm", k3_work, group=k3_group)
    log(f"  (d) K3 at the recorded a2a calls vs plain: max abs err "
        f"{k3_err:.4g} (tol {EXPERT_TOL['bfloat16']})")
    del calls, ws
    out.update(launches=launches, variants=variants, ranks=[{
        k: r[k] for k in ("rank", "params", "param_gib", "init_s", "main_s",
                          "peak_gib", "points", "a_kept", "a_rerouted",
                          "b_rerouted",
                          "a_cache", "probe")} for r in ranks])
    out["seconds"] = time.perf_counter() - t_all
    log(f"  phase 28 {out['seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------- phase 29
# deepseek-moe-16b trained across a 2 x 2 (data, model) mesh: four ranks on
# cuda:0 over gloo (not a multi-card speed), the reference's TP and FSDP
# placement (``param_specs``), train_4k at full width cut to its dense layer
# and one MoE layer (``steps.SHARED_CARD_CUT``, phase 10's cut) and to a
# global batch of 4 sequences of 4096 as 2 microbatches (a data block holds
# 1 row of each): every FSDP block crosses gloo, through host memory, in
# each microbatch's forward, remat's recompute and backward
MT_MESH = (2, 2)
# 2 steps (with the restart, 3 run), cut from 3 for the script's time:
# each is a gloo-bound 10-15 s
MT_BATCH, MT_ACCUM, MT_STEPS = 4, 2, 2
MT_CUT = {"n_layers": 2}
MT_NO_DROP_CF = 64 / 6     # C >= a shard's tokens: no slot drops (phase 28)
# (b), kernel route against plain route on the plain route's routing, bf16:
# the loss and gradient norm (relative), each leaf's gradient (of its
# largest value), and the share of a leaf's elements, among those whose
# gradient stands above MT_GRAD_TOL of the leaf's largest, whose first
# AdamW update moves by more than 1e-3 of the learning rate (the update
# is g / (|g| + eps): below bf16's rounding its sign is noise, and a fifth
# of a routed expert's elements flip there on the H100: PERF.md §6)
MT_LOSS_TOL, MT_GNORM_TOL, MT_GRAD_TOL, MT_UPDATE_TOL = 5e-3, 2e-2, 5e-2, 1e-3
# (c), the mesh step against the one-process step: (b)'s worst times this
MT_C_FACTOR = 2.0


def mesh_train_cfg(**moe):
    """The cut full-width config the ranks train (a2a dispatch, no remat
    where a routing is pinned: one router call a layer a microbatch)."""
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(LM_TRAIN_ARCH).make_config(),
                              remat="none", **MT_CUT)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


def grad_step(cfg, mesh=None, specs=None, accum: int = MT_ACCUM):
    """The train step whose update keeps the (reduced, clipped) gradients
    instead of applying them: (step, kept list)."""
    from repro_torch.launch.steps import make_lm_train_step
    kept = []

    def keep(params, grads, opt, step, layout=None):
        kept.append(grads)
        return params, opt
    return make_lm_train_step(cfg, keep, accum, mesh=mesh,
                              specs=specs), kept


def flat_grads(tree) -> dict:
    from repro_torch.optim.api import named_leaves
    return dict(named_leaves(tree))


def adamw_first(g):
    """AdamW's first update direction (bias-corrected moments of one
    gradient): g / (|g| + eps)."""
    g = g.float()
    return g / (g.abs() + 1e-8)


@contextlib.contextmanager
def pinned_experts(moe_mod, tape: list, mesh, B: int, S: int):
    """Hand each MoE router call of a training rank the expert choice of
    ``tape`` (a run's top-k expert indices over all B x S tokens, or this
    rank's own calls), cut to the rank's (rows, sequence) block; the
    gates are the rank's own probabilities at those experts,
    renormalised, so the router still gets its gradient.  The yielded
    dict counts the tokens whose own top-k differs from the pinned
    one."""
    import torch

    from repro_torch.distributed import ctx
    orig, it = moe_mod._router, iter(list(tape))
    seen = {"rerouted": 0, "tokens": 0}
    b_axes = tuple(a for a in mesh.mesh_dim_names if a != "model")
    n_b, n_s = ctx.axes_size(mesh, b_axes), ctx.axes_size(mesh, ("model",))
    bi, si = ctx.axes_index(mesh, b_axes), ctx.axes_index(mesh, ("model",))

    def router(p, x, cfg, a_experts, top_k):
        probs, vals, idx = orig(p, x, cfg, a_experts, top_k)
        pin = next(it).to(x.device)
        if pin[..., 0].numel() != idx[..., 0].numel():     # a block of it
            pin = pin.reshape(B, S, top_k)[
                bi * B // n_b:(bi + 1) * B // n_b,
                si * S // n_s:(si + 1) * S // n_s]
        pin = pin.reshape(idx.shape)
        seen["rerouted"] += int((idx.sort(-1).values != pin.sort(-1).values)
                                .any(-1).sum())
        seen["tokens"] += idx[..., 0].numel()
        gates = torch.gather(probs, -1, pin)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return probs, gates, pin
    moe_mod._router = router
    try:
        yield seen
    finally:
        moe_mod._router = orig
    if next(it, None) is not None:
        raise AssertionError("the pinned run routed fewer layers")


def mesh_train_one(dev, path: str) -> dict:
    """Phase 29 (c)'s one-process step, in this process before the ranks:
    the cut config at the no-drop capacity and aux weight 0, the
    launcher's seed-0 weights and step-0 batch; its loss, gradient norm,
    gradients and routing saved to ``path``."""
    import gc

    import torch

    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import lm_init
    from repro_torch.optim.api import named_leaves
    t0 = phase(f"29. (c) one process: the same step (train_4k, {MT_BATCH} x "
               f"4096 as {MT_ACCUM} microbatches, cut to "
               f"{MT_CUT['n_layers']} layers) at capacity factor "
               f"{MT_NO_DROP_CF:.4g} (no slot drops) and aux weight 0, "
               f"einsum dispatch, its gradients and routing kept")
    cfg = mesh_train_cfg(capacity_factor=MT_NO_DROP_CF, router_aux_weight=0.0)
    params = lm_init(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev)
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    step, kept = grad_step(cfg)
    batch = lm_train_batch(MT_BATCH, 4096, cfg.vocab_size, dev)
    tape = []
    with router_tape(moe_mod, tape), moe_mod.dispatch_tally() as tally:
        _, _, m = step(params, None, batch, 0)
    n_kept, routed = tally.counts()
    if n_kept != routed:
        raise AssertionError(f"(c) the one-process step dropped slots: "
                             f"{n_kept} of {routed}")
    out = {"loss": float(m["loss"]), "gnorm": float(m["gnorm"])}
    torch.save({"grads": {k: g.float().cpu()
                          for k, g in flat_grads(kept[0]).items()},
                "tape": [e[2].cpu() for e in tape], **out},
               path)
    del params, kept, tape, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  loss {out['loss']:.6f}, gradient norm {out['gnorm']:.6f}, "
        f"{routed} routed slots all kept ({time.perf_counter() - t0:.1f} s)")
    return out


def mesh_train_rank(rank: int, world: int, init_file: str, one_file: str,
                    argv: list) -> dict:
    """One rank of phase 29, on cuda:0 beside three others: (a) the main
    path, the launcher's own rank entry (``launch.train.train_rank``, as
    ``--mesh 2x2`` spawns it: it joins the ranks, resets the launch
    counts and reads them after its run), then on the same ranks (b) the
    kernel route against the plain route on the plain route's routing,
    (c) the mesh step against the one-process step on its routing, (d)
    ``compressed_all_reduce`` on the card against CPU copies and F8, (e)
    rank 0's recorded calls timed while the others wait.  Plain values
    back."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import layers as layers_mod
    from repro_torch.data import (microbatch_rows, synthetic_lm_batches,
                                  to_device)
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import shard_leaf, train_spec_fn
    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import expert_matmul as xm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import compress
    from repro_torch.distributed.sharding import is_spec
    from repro_torch.optim.api import named_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    out = {"rank": rank, "a": train_mod.train_rank(rank, world, init_file,
                                                   argv)}
    out["a"]["seconds"] = time.perf_counter() - t0
    dev = ctx.rank_device()
    mesh = make_mesh(MT_MESH, ("data", "model"))
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = mesh_train_cfg(dispatch="a2a")
    state, pspecs = train_mod.mesh_state(cfg, mesh, train_spec_fn(cfg),
                                         lambda p: None, dev)
    params = state["params"]
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    di = ctx.axes_index(mesh, ("data",))
    rows = microbatch_rows(MT_BATCH, MT_ACCUM, MT_MESH[0], di)
    batch = to_device(next(synthetic_lm_batches(
        global_batch=MT_BATCH, seq_len=4096, vocab=cfg.vocab_size,
        rows=rows)), dev)
    specs = dict(named_leaves(pspecs, is_leaf=is_spec))

    def run(step, kept):
        _, _, m = step(params, None, batch, 0)
        torch.cuda.synchronize()
        return float(m["loss"]), float(m["gnorm"]), flat_grads(kept.pop())

    # (b) the plain route, its routing recorded, then the kernel route on
    # it (a tape of this rank's own calls is handed back as it is), every
    # kernel call recorded for (e)
    t0 = time.perf_counter()
    tape = []
    step, kept = grad_step(cfg, mesh, pspecs)
    with ops.plain_kernels(), router_tape(moe_mod, tape):
        lp, gp, grads_p = run(step, kept)
    tape = [e[2].detach() for e in tape]
    rec = {k: {} for k in ("k1_fwd", "k1_dgrad", "k1_wgrad", "k2_fwd",
                           "k2_bwd", "x_fwd", "x_dgrad", "x_wgrad")}
    with pinned_experts(moe_mod, tape, mesh, MT_BATCH // MT_ACCUM, 4096) \
            as seen_b, \
            recording([(layers_mod, "elastic_matmul_op", "k1_fwd"),
                       (em, "elastic_matmul_dgrad", "k1_dgrad"),
                       (em, "elastic_matmul_wgrad", "k1_wgrad"),
                       (fa, "flash_attention", "k2_fwd"),
                       (fa, "flash_attention_bwd", "k2_bwd"),
                       (xm, "expert_matmul", "x_fwd"),
                       (xm, "expert_matmul_dgrad", "x_dgrad"),
                       (xm, "expert_matmul_wgrad", "x_wgrad")],
                      keep_calls(rec)):
        lk, gk, grads_k = run(step, kept)
    worst, upd, upd_above = {}, {}, {}
    for k, g in grads_k.items():
        ref = grads_p[k].float()
        worst[k] = float((g.float() - ref).abs().max()) / max(
            float(ref.abs().max()), 1e-30)
        moved = (adamw_first(g) - adamw_first(ref)).abs() > 1e-3
        upd[k] = float(moved.float().mean())
        above = ref.abs() > MT_GRAD_TOL * ref.abs().max()
        upd_above[k] = float(moved[above].float().mean()) if bool(
            above.any()) else 0.0
    out["b"] = {"loss": lk, "loss_plain": lp, "gnorm": gk,
                "gnorm_plain": gp, "grad_err": max(worst.values()),
                "worst_leaf": max(worst, key=worst.get),
                "update_share": max(upd.values()),
                "update_leaf": max(upd, key=upd.get),
                "update_share_above": max(upd_above.values()),
                "rerouted": seen_b["rerouted"], "tokens": seen_b["tokens"],
                "seconds": time.perf_counter() - t0}
    del grads_p, tape
    # (c) the mesh step at the no-drop capacity and aux weight 0, on the
    # one-process step's routing (each rank's block of it)
    t0 = time.perf_counter()
    one = torch.load(one_file, map_location="cpu", mmap=True,
                     weights_only=True)
    cfg_c = mesh_train_cfg(dispatch="a2a", capacity_factor=MT_NO_DROP_CF,
                           router_aux_weight=0.0)
    step_c, kept_c = grad_step(cfg_c, mesh, pspecs)
    with pinned_experts(moe_mod, one["tape"], mesh, MT_BATCH // MT_ACCUM,
                        4096) as seen, moe_mod.dispatch_tally() as tally:
        lc, gc_, grads_c = run(step_c, kept_c)
    n_kept, routed = tally.counts()
    c_err = {}
    for k, g in grads_c.items():
        ref = shard_leaf(one["grads"][k], specs[k], mesh).to(dev)
        c_err[k] = float((g.float() - ref).abs().max()) / max(
            float(ref.abs().max()), 1e-30)
    out["c"] = {"loss": lc, "gnorm": gc_, "grad_err": max(c_err.values()),
                "worst_leaf": max(c_err, key=c_err.get),
                "kept": [n_kept, routed],
                "rerouted": seen["rerouted"], "tokens": seen["tokens"],
                "seconds": time.perf_counter() - t0}
    del grads_c, one
    # (d) compressed_all_reduce over "data" on the kernel route's
    # gradients, on the card and on CPU copies; F8 on 1s and 2s
    t0 = time.perf_counter()
    group = ctx.axes_group(mesh, ("data",))
    same, bias, n_el = True, 0.0, 0
    for k, g in grads_k.items():
        err = torch.zeros_like(g, dtype=torch.float32)
        mean, new_err = compress.compressed_all_reduce(g, err, group)
        mean_c, err_c = compress.compressed_all_reduce(g.cpu(), err.cpu(),
                                                       group)
        same = same and torch.equal(mean.cpu(), mean_c) and torch.equal(
            new_err.cpu(), err_c)
        true = ctx.all_reduce(g.float().clone(), "sum", group) / MT_MESH[0]
        scale = float(true.abs().max()) or 1.0
        bias = max(bias, float((mean - true).abs().max()) / scale)
        n_el += g.numel()
    f8, _ = compress.compressed_all_reduce(
        torch.full((8,), 1.0 + di, device=dev), torch.zeros(8, device=dev),
        group)
    out["d"] = {"same_bits": same, "elements": n_el,
                "bias_of_largest": bias, "f8_mean": float(f8[0]),
                "seconds": time.perf_counter() - t0}
    del grads_k
    # (e) rank 0 times its recorded calls while the others wait
    nograd = torch.no_grad
    if rank == 0:
        t0 = time.perf_counter()
        rows = {
            "k1_fwd": time_rows("K1 forward, mesh step (TP blocks)",
                                expand(rec["k1_fwd"]), ops.elastic_matmul_op,
                                k1_plain, k1_library, "torch.matmul",
                                k1_work, group=k1_group, mode=nograd),
            "k1_dgrad": time_rows("K1 dgrad, mesh step",
                                  expand(rec["k1_dgrad"]),
                                  em.elastic_matmul_dgrad, k1_dgrad_plain,
                                  k1_dgrad_library, "torch.matmul",
                                  k1_dgrad_work, group=bwd_group,
                                  mode=nograd),
            "k1_wgrad": time_rows("K1 wgrad, mesh step",
                                  expand(rec["k1_wgrad"]),
                                  em.elastic_matmul_wgrad, k1_wgrad_plain,
                                  k1_wgrad_library, "torch.matmul",
                                  k1_wgrad_work, group=bwd_group,
                                  mode=nograd),
            "k2_fwd": time_rows("K2 forward (causal, 8 local heads, with the "
                                "logsumexp), mesh step",
                                expand(rec["k2_fwd"]), k2_fwd_lse,
                                k2_fwd_lse_plain, k2_fwd_lse_library, "sdpa",
                                k2_work, mode=nograd),
            "k2_bwd": time_rows("K2 backward (causal, 8 local heads), mesh "
                                "step", expand(rec["k2_bwd"]), k2_bwd_kernel,
                                k2_bwd_plain, SdpaBackward(),
                                "sdpa backward", k2_bwd_work, mode=nograd),
            "k3_fwd": time_rows("K3 forward, mesh step (a2a-packed slabs)",
                                expand(rec["x_fwd"]), xm.expert_matmul,
                                xm.expert_matmul_plain,
                                lambda x, w, c: torch.bmm(x, w), "torch.bmm",
                                k3_work, mode=nograd),
            "k3_dgrad": time_rows("K3 dgrad, mesh step (a2a-packed slabs)",
                                  expand(rec["x_dgrad"]),
                                  xm.expert_matmul_dgrad,
                                  xm.expert_matmul_dgrad_plain,
                                  k3_dgrad_library, "torch.bmm",
                                  k3_dgrad_work, group=k3_dgrad_group,
                                  mode=nograd),
            "k3_wgrad": time_rows("K3 wgrad, mesh step (a2a-packed slabs)",
                                  expand(rec["x_wgrad"]),
                                  xm.expert_matmul_wgrad,
                                  xm.expert_matmul_wgrad_plain,
                                  k3_wgrad_library, "torch.bmm",
                                  k3_wgrad_work, group=k3_wgrad_group,
                                  mode=nograd)}
        for k, r in rows.items():
            r["launches"] = sum(n for *_, n in rec[
                k.replace("k3_", "x_")].values())
        out["rows"] = rows
        out["rows_s"] = time.perf_counter() - t0
    del rec
    dist.barrier()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def mesh_train_phases(dev, card: str) -> dict:
    """Phase 29: deepseek-moe-16b trained across a 2 x 2 mesh, four ranks
    sharing the card over gloo: (c)'s one-process step in this process
    first, then four ranks (:func:`mesh_train_rank`) for (a), the
    launcher's rank entry for 2 steps with a failure at step 1 and a
    restart (no checkpoint), and (b)-(e).  Returns what the kernels'
    record needs."""
    import tempfile

    import torch

    from repro_torch.distributed import ctx
    from repro_torch.launch.steps import SHARED_CARD_CUT
    t_all = time.perf_counter()
    want = dict(MT_CUT, global_batch=MT_BATCH, accum=MT_ACCUM)
    if SHARED_CARD_CUT.get((LM_TRAIN_ARCH, LM_TRAIN_SHAPE)) != want:
        raise AssertionError(f"the launcher's shared-card cut is not "
                             f"{want}")
    out = {}
    argv = ["--arch", LM_TRAIN_ARCH, "--mesh", "x".join(map(str, MT_MESH)),
            "--steps", str(MT_STEPS), "--fail-at", "1", "--save-every", "0",
            "--log-every", "1", "--device", "cuda"]
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        one_file = os.path.join(tmp, "one.pt")
        one = mesh_train_one(dev, one_file)
        argv += ["--ckpt-dir", os.path.join(tmp, "ckpt")]
        t0 = phase(f"29. (a), (b), (d), (e) deepseek-moe-16b trained across a "
                   f"2 x 2 (data, model) mesh, four ranks sharing the card "
                   f"over gloo (not a multi-card speed): train_4k at full "
                   f"width cut to {MT_CUT['n_layers']} layers (dense + 1 MoE) "
                   f"and to {MT_BATCH} x 4096 as {MT_ACCUM} microbatches (1 "
                   f"row of each a data block); (a) a failure at step 1 and "
                   f"a restart from step 0 (no checkpoint), each rank the "
                   f"launcher's own (python -m repro_torch.launch.train "
                   f"{' '.join(argv[:-2])}); then on the same ranks (b) the "
                   f"kernel route vs the plain route on its routing, (c) the "
                   f"mesh step vs the one-process step, (d) "
                   f"compressed_all_reduce on the card, (e) rank 0's kernel "
                   f"rows")
        res = ctx.spawn_ranks(mesh_train_rank, 4, (os.path.join(
            tmp, "rendezvous"), one_file, argv), timeout_s=900)
    out["ranks_s"] = time.perf_counter() - t0
    ranks = [r["a"] for r in res]
    for r in ranks:
        ls = r["losses"]
        if r["restarts"] != 1 or len(ls) != MT_STEPS + 1:
            raise AssertionError(f"rank {r['rank']}: {r['restarts']} "
                                 f"restarts, losses {ls}")
        if not all(math.isfinite(x) for x in ls):
            raise AssertionError(f"rank {r['rank']}: losses {ls}")
        if ls[0] != ls[1]:
            raise AssertionError(f"rank {r['rank']}: step 0 after the "
                                 f"restart {ls[1]!r}, first {ls[0]!r}")
        if ls != ranks[0]["losses"]:
            raise AssertionError("the ranks' global losses differ")
        idle = [k for k in LM_TRAIN_KERNELS if r["launches"][k] <= 0]
        if idle:
            raise AssertionError(f"rank {r['rank']}: kernels not launched "
                                 f"{idle}")
        main_path_variants(r["variants"], LM_TRAIN_VARIANTS)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in LM_TRAIN_KERNELS}
    variants = {k: {v: sum(r["variants"][k][v] for r in ranks)
                    for v in ranks[0]["variants"][k]}
                for k in LM_TRAIN_KERNELS}
    steady = ranks[0]["step_ms"][1:]
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    out["a"] = {"losses": ranks[0]["losses"],
                "step_ms": ranks[0]["step_ms"],
                "step_median_ms": statistics.median(steady),
                "peak_gib": [r["peak_gib"] for r in ranks],
                "card_gib": total, "seconds": ranks[0]["seconds"]}
    log(f"  (a) losses {', '.join(f'{x:.6f}' for x in ranks[0]['losses'])} "
        f"(the same on every rank; step 0 again after the restart: the same "
        f"bits); rank 0's steps "
        f"{', '.join(f'{x:.0f}' for x in ranks[0]['step_ms'])} ms, median "
        f"after the first {out['a']['step_median_ms']:.1f} ms "
        f"({MT_BATCH * 4096 / out['a']['step_median_ms'] * 1e3:.1f} "
        f"tokens/s) [{card}]")
    log(f"  (a) peak device memory by rank "
        f"{', '.join(f'{x:.2f}' for x in out['a']['peak_gib'])} GiB, "
        f"{sum(out['a']['peak_gib']):.2f} of the card's {total:.2f} GiB")
    log(f"  (a) launches (4 ranks) {launches}; by variant "
        + str({k: {v: n for v, n in per.items() if n}
               for k, per in variants.items()}))
    out.update(launches=launches, variants=variants)
    b = [r["b"] for r in res]
    for x in b:
        if not abs(x["loss"] - x["loss_plain"]) <= MT_LOSS_TOL * abs(
                x["loss_plain"]):
            raise AssertionError(f"(b) loss {x['loss']!r} against the plain "
                                 f"route's {x['loss_plain']!r}")
        if not abs(x["gnorm"] - x["gnorm_plain"]) <= MT_GNORM_TOL * abs(
                x["gnorm_plain"]):
            raise AssertionError(f"(b) gradient norm {x['gnorm']!r} against "
                                 f"{x['gnorm_plain']!r}")
        if x["grad_err"] > MT_GRAD_TOL or \
                x["update_share_above"] > MT_UPDATE_TOL:
            raise AssertionError(f"(b) {x}")
    b_loss = max(abs(x["loss"] - x["loss_plain"]) / abs(x["loss_plain"])
                 for x in b)
    b_gnorm = max(abs(x["gnorm"] - x["gnorm_plain"]) / abs(x["gnorm_plain"])
                  for x in b)
    b_grad = max(x["grad_err"] for x in b)
    log(f"  (b) kernel route vs plain route (bf16, the plain route's "
        f"routing, one step): loss {b[0]['loss']:.6f} / {b[0]['loss_plain']:.6f} "
        f"({b_loss:.3g} relative, tol {MT_LOSS_TOL}), gradient norm "
        f"{b[0]['gnorm']:.5f} / {b[0]['gnorm_plain']:.5f} ({b_gnorm:.3g}, tol "
        f"{MT_GNORM_TOL}); each rank's gradient blocks within "
        + ", ".join(f"{x['grad_err']:.3g} ({x['worst_leaf']})" for x in b)
        + f" of a leaf's largest (tol {MT_GRAD_TOL}); AdamW's first update "
        f"off by > 1e-3 of the learning rate at "
        + ", ".join(f"{100 * x['update_share_above']:.3g}%" for x in b)
        + f" of a leaf's elements whose gradient is above {MT_GRAD_TOL} of "
        f"its largest (tol {100 * MT_UPDATE_TOL:.2g}%), at "
        + ", ".join(f"{100 * x['update_share']:.3g}% ({x['update_leaf']})"
                    for x in b)
        + " of all its elements (sign noise below bf16's rounding); the "
        "kernel route's own routing off the pinned one at "
        + ", ".join(f"{x['rerouted']} of {x['tokens']}" for x in b)
        + " token-layer routings")
    c_tol = {"loss": max(MT_C_FACTOR * b_loss, 1e-4),
             "gnorm": max(MT_C_FACTOR * b_gnorm, 1e-3),
             "grad": max(MT_C_FACTOR * b_grad, 1e-3)}
    for r in res:
        c = r["c"]
        if c["kept"][0] != c["kept"][1]:
            raise AssertionError(f"(c) rank {r['rank']} dropped slots "
                                 f"{c['kept']}")
        if not abs(c["loss"] - one["loss"]) <= c_tol["loss"] * abs(
                one["loss"]) or not abs(c["gnorm"] - one["gnorm"]) <= \
                c_tol["gnorm"] * abs(one["gnorm"]) or \
                c["grad_err"] > c_tol["grad"]:
            raise AssertionError(f"(c) rank {r['rank']}: {c} against the "
                                 f"one process's {one} (tolerances {c_tol})")
    log(f"  (c) the mesh step (a2a, TP + FSDP, no slot dropped) vs the "
        f"one-process step on its routing: loss {res[0]['c']['loss']:.6f} / "
        f"{one['loss']:.6f}, gradient norm {res[0]['c']['gnorm']:.5f} / "
        f"{one['gnorm']:.5f}; gradient blocks within "
        + ", ".join(f"{r['c']['grad_err']:.3g} ({r['c']['worst_leaf']})"
                    for r in res)
        + f" of a leaf's largest; tolerances {MT_C_FACTOR:g} x (b)'s: "
        f"{ {k: float(f'{v:.3g}') for k, v in c_tol.items()} }; the ranks' "
        f"own routing off the pinned one at "
        + ", ".join(f"{r['c']['rerouted']} of {r['c']['tokens']}"
                    for r in res) + " tokens")
    for r in res:
        d = r["d"]
        if not d["same_bits"] or d["f8_mean"] != 2.0:
            raise AssertionError(f"(d) rank {r['rank']}: {d}")
    log(f"  (d) compressed_all_reduce over data on CUDA tensors: the same "
        f"bits as on CPU copies for {res[0]['d']['elements']} gradient "
        f"elements a rank; its mean off the true one by up to "
        + ", ".join(f"{r['d']['bias_of_largest']:.3g}" for r in res)
        + " of the largest (F8: each rank's own scale, the max to "
        f"dequantise); ranks at 1 and 2 get {res[0]['d']['f8_mean']} "
        f"(true 1.5)")
    for r in res:
        log(f"  rank {r['rank']}: (a) {r['a']['seconds']:.1f} s, (b) "
            f"{r['b']['seconds']:.1f} s, (c) {r['c']['seconds']:.1f} s, (d) "
            f"{r['d']['seconds']:.1f} s"
            + (f", (e) {r['rows_s']:.1f} s" if "rows" in r else "")
            + f"; peak after (a) {r['peak_gib']:.2f} GiB")
    rows = res[0]["rows"]
    out.update(rows=rows, b={k: v for k, v in b[0].items()},
               c=[r["c"] for r in res], d=[r["d"] for r in res],
               one=one, c_tol=c_tol,
               peak_gib=[r["peak_gib"] for r in res])
    out["seconds"] = time.perf_counter() - t_all
    log(f"  phase 29 {out['seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------- phase 30
# qwen1.5-110b, granite-20b and kimi-k2-1t-a32b trained on the card: (a) K2's
# wgmma backward at kimi-k2's head dim 112 at its train_4k microbatch, (b)
# each config through the training launcher at its one-card cut
# (``steps.ONE_CARD_CUT``, ``train.ONE_CARD_ACCUM``) at full width, the
# global batch cut for this phase to TC_MICROBATCHES of the cut's
# microbatches (printed), (c) K3 at kimi-k2's MoE training shapes, which no
# one-card cut holds, (d) granite-20b (MQA) and kimi-k2 (GQA, D 112, bf16
# Adafactor on blocks) on a 1 x 2 mesh whose two ranks share the card over
# gloo (``steps.SHARED_CARD_CUT``)
TC_ARCHS = ("qwen1.5-110b", "granite-20b", "kimi-k2-1t-a32b")
TC_MESH_ARCHS = ("granite-20b", "kimi-k2-1t-a32b")
TC_MESH = (1, 2)
TC_STEPS = 2
TC_MICROBATCHES = 2        # (b)'s global batch: 2 of the cut's microbatches
TC_CHECK_LEN = 1024        # (b)'s kernel vs plain route: one row of 1024
TC_KIMI_B = 4              # kimi's train_4k microbatch (256 / 64)
# the dense configs' training kernels, every bf16 call on the Hopper
# variants (no router, no expert)
TC_KERNELS = ("elastic_matmul", "flash_attention", "elastic_matmul_dgrad",
              "elastic_matmul_wgrad", "flash_attention_bwd")
TC_VARIANTS = {("elastic_matmul", "tma"), ("flash_attention", "wgmma"),
               ("elastic_matmul_dgrad", "tma"),
               ("elastic_matmul_wgrad", "tma"),
               ("flash_attention_bwd", "wgmma")}


@contextlib.contextmanager
def one_card_batch(key: tuple, B: int):
    """The training launcher's one-card run of ``key`` (arch, shape) at a
    global batch of ``B`` sequences inside the block: its
    ``steps.ONE_CARD_CUT`` entry holds ``global_batch`` B, as
    ``SHARED_CARD_CUT``'s entries do (phase 30 (b)'s cut).  Yields the
    list of what the block prints, which still goes to stdout, so that
    the caller can check the launcher's cut line."""
    from repro_torch.launch import steps

    class Tee:
        def __init__(self, out):
            self.out, self.text = out, []

        def write(self, s):
            self.text.append(s)
            return self.out.write(s)

        def flush(self):
            self.out.flush()
    orig = steps.ONE_CARD_CUT[key]
    steps.ONE_CARD_CUT[key] = {**orig, "global_batch": B}
    tee = Tee(sys.stdout)
    try:
        with contextlib.redirect_stdout(tee):
            yield tee.text
    finally:
        steps.ONE_CARD_CUT[key] = orig


@contextlib.contextmanager
def launched(name: str):
    """The launches of kernel ``name`` inside the block, by variant, read
    from its wrapper's counters (``ops.variant_counts``) around it: the
    dict yielded is filled on leaving the block."""
    import torch

    from repro_torch.kernels import ops
    was = dict(ops.variant_counts()[name])
    took = {}
    yield took
    torch.cuda.synchronize()
    took.update({v: c - was[v] for v, c in ops.variant_counts()[name].items()
                 if c != was[v]})


def row_launches(name: str, calls: list, kern, variant: str) -> int:
    """A timed row's launches: its calls run once more, eagerly and in
    order, the launches of kernel ``name`` counted around them
    (:func:`launched`), every one on ``variant``."""
    import torch
    with torch.no_grad(), launched(name) as took:
        for args, kw in calls:
            kern(*args, **kw)
    if set(took) != {variant}:
        raise AssertionError(f"{name}: a timed row's {len(calls)} calls "
                             f"launched {took}, not {variant} alone")
    return took[variant]


def rowwise(fn):
    """``fn`` over a call's batch rows one at a time, concatenated: the
    plain K2 versions at B = 4 and 64 heads (a row's fp32 scores are
    4.3 GB, and the backward keeps four such)."""
    import torch

    def call(*args, **kw):
        outs = [fn(*(a[b:b + 1] if isinstance(a, torch.Tensor) else a
                     for a in args), **kw)
                for b in range(args[0].shape[0])]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(p) for p in zip(*outs))
        return torch.cat(outs)
    return call


def k2_d112_train(dev, card: str) -> dict:
    """Phase 30 (a): K2 at kimi-k2's head dim 112 at its train_4k
    microbatch (4 x 4096, causal, 64 query heads on 8 kv heads, bf16):
    the wgmma backward from the forward's logsumexp against the plain
    version on fp32 copies, row by row; a corrupted dK shown to fail that
    check; both directions timed against SDPA (``enable_gqa``) and the
    bound."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    t0 = phase(f"30. (a) K2 at kimi-k2's head dim 112, its train_4k "
               f"microbatch ({TC_KIMI_B} x 4096, causal, H 64 on KH 8, "
               f"bf16): the wgmma backward vs the plain version (fp32 "
               f"copies), a corrupted dK, times vs SDPA")
    B, S, H, KH, D = TC_KIMI_B, 4096, 64, 8, 112
    gen = torch.Generator(device=dev).manual_seed(30)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q, do = rnd(B, S, H, D), rnd(B, S, H, D)
    k, v = rnd(B, S, KH, D), rnd(B, S, KH, D)
    with launched("flash_attention") as took:
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    if took != {"wgmma": 1}:
        raise AssertionError(f"(a) the D = 112 forward took {took}")
    o_plain = rowwise(fa.flash_attention_plain)(q.float(), k.float(),
                                                v.float(), causal=True)
    fwd_err = close(o, o_plain, ATTN_TOL["bfloat16"])
    del o_plain
    with launched("flash_attention_bwd") as took:
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    if took != {"wgmma": 1}:
        raise AssertionError(f"(a) the D = 112 backward took {took}")
    tol = K2_BWD_TOL["bfloat16"]
    want = rowwise(fa.flash_attention_bwd_plain)(
        q.float(), k.float(), v.float(), o.float(), do.float(), causal=True)
    err = errs_of(got, want, tol)
    bad = got[1].clone()
    scale = max(float(w.abs().max()) for w in want)
    bad.view(-1)[::4099] += 0.1 * scale
    try:
        errs_of((got[0], bad, got[2]), want, tol)
    except AssertionError as e:
        caught = str(e)
    else:
        raise AssertionError("(a) a corrupted dK passed the check")
    del want, bad
    repeatable(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=True), got, 0.0,
               "K2 backward D 112")
    log(f"  forward (on wgmma, with the logsumexp) within {fwd_err:.3g} of "
        f"the plain version (tol {ATTN_TOL['bfloat16']}); backward on wgmma: "
        f"{err[1]:.3g} of the largest gradient (tol {tol}), max abs err "
        f"{err[0]:.3g}, the same bits twice and under 3 graph replays; dK "
        f"with every 4099th element off by 0.1 of the largest fails: "
        f"{caught}")
    del got
    nograd = torch.no_grad
    calls = {"k2_bwd": [((q, k, v, o, lse, do), {"causal": True})],
             "k2_fwd": [((q, k, v), {"causal": True, "return_lse": True})]}
    rows = {"k2_bwd": time_rows(
        "K2 backward D 112 (kimi-k2 train_4k microbatch)", calls["k2_bwd"],
        k2_bwd_kernel, rowwise(k2_bwd_plain), SdpaBackward(),
        "sdpa backward (enable_gqa)", k2_bwd_work, mode=nograd),
        "k2_fwd": time_rows(
        "K2 forward D 112 with the logsumexp (kimi-k2 train_4k "
        "microbatch)", calls["k2_fwd"],
        k2_fwd_lse, rowwise(k2_fwd_lse_plain), k2_fwd_lse_library,
        "sdpa (enable_gqa)", k2_work, mode=nograd)}
    for key, name, kern in (("k2_bwd", "flash_attention_bwd", k2_bwd_kernel),
                            ("k2_fwd", "flash_attention", k2_fwd_lse)):
        rows[key]["launches"] = row_launches(name, calls[key], kern, "wgmma")
    log(f"  the rows' launches, counted: "
        f"{ {k: r['launches'] for k, r in rows.items()} }")
    out = {"fwd_err": fwd_err, "bwd_err": err, "rows": rows,
           "seconds": time.perf_counter() - t0}
    del q, k, v, o, lse, do
    torch.cuda.empty_cache()
    log(f"  ({out['seconds']:.1f} s) [{card}]")
    return out


def first_loss_plain(cfg, params, B: int, dev) -> dict:
    """The launcher's first loss recomputed on its seed-0 parameters: its
    step-0 batch (B x 4096) through the plain route
    (``ops.plain_kernels``), a row at a time, without gradient, the mean
    of the rows' losses.  Beside it ln(vocab) plus half the logits' mean
    variance over the vocabulary, which the cross entropy of normal
    logits approaches where they single out no target (the gap of an
    untrained model's loss over ln(vocab))."""
    import torch

    from repro_torch.core.distill import ce_loss
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import lm_apply
    batch = lm_train_batch(B, 4096, cfg.vocab_size, dev)
    losses, half_var = [], []
    with torch.no_grad(), ops.plain_kernels():
        for r in range(B):
            z, aux, _ = lm_apply(params, batch["tokens"][r:r + 1], cfg)
            z = z[0].float()
            losses.append(float(ce_loss(z, batch["labels"][r]) + aux))
            half_var.append(float(z.var(-1, correction=0).mean()) / 2)
            del z
    torch.cuda.empty_cache()
    return {"plain": statistics.fmean(losses),
            "ln_vocab": math.log(cfg.vocab_size),
            "half_var": statistics.fmean(half_var)}


def grad_route_check(cfg, params, dev) -> dict:
    """Phase 30 (b)'s check: one step's loss, gradient norm and clipped
    gradients (no update) of one row of TC_CHECK_LEN positions on the
    kernel route against the plain route (bf16), within phase 29 (b)'s
    tolerances."""
    import torch

    from repro_torch.kernels import ops
    step, kept = grad_step(cfg, accum=1)
    mb = lm_train_batch(1, TC_CHECK_LEN, cfg.vocab_size, dev, step=1)
    _, _, mk = step(params, None, mb, 0)
    gk = flat_grads(kept.pop())
    with ops.plain_kernels():
        _, _, mp = step(params, None, mb, 0)
    gp = flat_grads(kept.pop())
    torch.cuda.synchronize()
    lk, lp = float(mk["loss"]), float(mp["loss"])
    nk, np_ = float(mk["gnorm"]), float(mp["gnorm"])
    worst = {}
    for key, g in gk.items():
        ref = gp[key].float()
        worst[key] = float((g.float() - ref).abs().max()) / max(
            float(ref.abs().max()), 1e-30)
    out = {"loss": lk, "loss_plain": lp, "gnorm": nk, "gnorm_plain": np_,
           "loss_rel": abs(lk - lp) / abs(lp),
           "gnorm_rel": abs(nk - np_) / abs(np_),
           "grad_err": max(worst.values()),
           "worst_leaf": max(worst, key=worst.get)}
    if not out["loss_rel"] <= MT_LOSS_TOL or \
            not out["gnorm_rel"] <= MT_GNORM_TOL or \
            not out["grad_err"] <= MT_GRAD_TOL:
        raise AssertionError(f"(b) kernel vs plain route: {out}")
    return out


def train_config(arch_id: str, dev, card: str) -> dict:
    """Phase 30 (b) for one config: ``python -m repro_torch.launch.train
    --arch <id>`` at its one-card cut, TC_STEPS steps of TC_MICROBATCHES of
    the cut's microbatches (the global batch cut for this phase); on
    fresh seed-0 parameters the first loss against the plain route's on
    its batch (:func:`first_loss_plain`), one microbatch recorded for
    K1's rows and checks, and the kernel route against the plain route on
    one row of TC_CHECK_LEN positions."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import layers as layers_mod
    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.flops import lm_model_flops
    from repro_torch.launch.steps import ONE_CARD_CUT, make_lm_train_step
    from repro_torch.optim.api import named_leaves, pop_grads
    key = (arch_id, "train_4k")
    arch = get_arch(arch_id)
    cut = ONE_CARD_CUT[key]
    cfg = dataclasses.replace(arch.make_config(), **cut)
    mb = 256 // train_mod.ONE_CARD_ACCUM[key]
    B = TC_MICROBATCHES * mb
    argv = ["--arch", arch_id, "--steps", str(TC_STEPS), "--save-every",
            "0", "--accum", str(TC_MICROBATCHES)]
    title = (f"30. (b) {arch_id} train_4k at full width, cut to "
             f"{cut['n_layers']} layer{'s' if cut['n_layers'] > 1 else ''} "
             f"(ONE_CARD_CUT), microbatches of {mb} x 4096 (ONE_CARD_ACCUM "
             f"{train_mod.ONE_CARD_ACCUM[key]}); for this phase the global "
             f"batch cut to {B} x 4096 as {TC_MICROBATCHES} microbatches; "
             f"{arch.optimizer}, {cfg.param_dtype} parameters")
    with one_card_batch(key, B) as printed:
        run = train_run(title, argv, 0, (0, 0), TC_KERNELS, TC_VARIANTS,
                        B * 4096, "tokens", dev)
    cut_line = (f"{arch_id} train_4k: batch {B} as {TC_MICROBATCHES} "
                f"microbatches of {mb}")
    if cut_line not in "".join(printed):
        raise AssertionError(f"(b) the launcher did not print {cut_line!r}")
    flops = lm_model_flops(cfg, "train", B, 4096)
    run["model_tflops_per_s"] = flops / run["step_ms"] * 1e3 / 1e12
    run["mfu"] = run["model_tflops_per_s"] * 1e12 / PEAK_BF16_FLOPS
    log(f"  the launcher's cut line began {cut_line!r}; model FLOPs "
        f"{flops / 1e12:.1f} TFLOP a step: {run['model_tflops_per_s']:.1f} "
        f"TFLOP/s, {100 * run['mfu']:.1f}% of the bf16 peak [{card}]")
    t0 = time.perf_counter()
    params = train_mod.init_params(arch, cfg, dev)
    first = {"loss": run["losses"][0],
             **first_loss_plain(cfg, params, B, dev)}
    first["rel"] = abs(first["loss"] - first["plain"]) / abs(first["plain"])
    run["first_loss"] = first
    if not first["rel"] <= MT_LOSS_TOL:
        raise AssertionError(f"(b) {arch_id}: the first loss against the "
                             f"plain route's on its batch: {first}")
    log(f"  first loss {first['loss']:.6f}, the plain route's on its batch "
        f"{first['plain']:.6f} ({first['rel']:.3g} relative, tol "
        f"{MT_LOSS_TOL}): ln vocab {first['ln_vocab']:.4f} + "
        f"{first['loss'] - first['ln_vocab']:.4f}, the logits' half "
        f"variance {first['half_var']:.4f}")
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    rec = {"k1": {}, "dgrad": {}, "wgrad": {}}
    step = make_lm_train_step(cfg, lambda p, g, o, s: (p, o), accum=1)
    with recording([(layers_mod, "elastic_matmul_op", "k1"),
                    (em, "elastic_matmul_dgrad", "dgrad"),
                    (em, "elastic_matmul_wgrad", "wgrad")], keep_calls(rec)):
        _, _, m = step(params, None, lm_train_batch(mb, 4096, cfg.vocab_size,
                                                    dev), 0)
        torch.cuda.synchronize()
    pop_grads(params)
    log(f"  one microbatch ({mb} x 4096) recorded: loss "
        f"{float(m['loss']):.4f}; K1 calls "
        f"{ {k: sum(n for *_, n in v.values()) for k, v in rec.items()} }, "
        f"distinct { {k: len(v) for k, v in rec.items()} }")
    checks = k1_recorded_checks(f"{arch_id} microbatch", rec)
    nograd = torch.no_grad

    def once(key):            # each distinct call of the microbatch once
        return [(a, kw) for a, kw, _ in rec[key].values()]
    rows = {
        "k1_fwd": time_rows(f"K1 forward, {arch_id} train_4k microbatch, "
                            f"each distinct call once", once("k1"),
                            ops.elastic_matmul_op, k1_plain, k1_library,
                            "torch.matmul", k1_work, mode=nograd),
        "k1_dgrad": time_rows(f"K1 dgrad, {arch_id} train_4k microbatch, "
                              f"each distinct call once", once("dgrad"),
                              em.elastic_matmul_dgrad, k1_dgrad_plain,
                              k1_dgrad_library, "torch.matmul",
                              k1_dgrad_work, mode=nograd),
        "k1_wgrad": time_rows(f"K1 wgrad, {arch_id} train_4k microbatch, "
                              f"each distinct call once", once("wgrad"),
                              em.elastic_matmul_wgrad, k1_wgrad_plain,
                              k1_wgrad_library, "torch.matmul",
                              k1_wgrad_work, mode=nograd)}
    for name, key, group in (("k1_fwd", "k1", k1_group),
                             ("k1_dgrad", "dgrad", bwd_group),
                             ("k1_wgrad", "wgrad", bwd_group)):
        rows[name]["shapes"] = [group(a, kw) for a, kw in once(key)]
    for name, r in rows.items():
        r["launches"] = sum(n for *_, n in rec[
            {"k1_fwd": "k1", "k1_dgrad": "dgrad",
             "k1_wgrad": "wgrad"}[name]].values())
    del rec, m
    torch.cuda.empty_cache()
    route = grad_route_check(cfg, params, dev)
    log(f"  kernel vs plain route (bf16, one row of {TC_CHECK_LEN}): loss "
        f"{route['loss']:.6f} / {route['loss_plain']:.6f} "
        f"({route['loss_rel']:.3g} relative, tol {MT_LOSS_TOL}), gradient "
        f"norm {route['gnorm']:.5f} / {route['gnorm_plain']:.5f} "
        f"({route['gnorm_rel']:.3g}, tol {MT_GNORM_TOL}), every leaf within "
        f"{route['grad_err']:.3g} of its largest ({route['worst_leaf']}; tol "
        f"{MT_GRAD_TOL})")
    del params
    torch.cuda.empty_cache()
    out = {"cut": dict(cut), "global_batch": B, "microbatch": mb,
           "accum": TC_MICROBATCHES, "optimizer": arch.optimizer,
           "param_dtype": cfg.param_dtype, "route": route, "rows": rows,
           "k1_checks": checks, "seconds_after_run":
               time.perf_counter() - t0,
           **{k: run[k] for k in ("params", "step_ms", "step_ms_all",
                                  "losses", "tokens_per_s", "peak_gib",
                                  "peak_run_gib", "launches", "variants",
                                  "model_tflops_per_s", "mfu",
                                  "first_loss")}}
    log(f"  ({out['seconds_after_run']:.1f} s after the run)")
    return out


def k3_kimi_train(dev, card: str) -> dict:
    """Phase 30 (c): K3 at kimi-k2's MoE training shapes (E 384, d 7168,
    F 2048), which no one-card cut holds: one train_4k microbatch (4 x
    4096 tokens) routed through a kimi router (top 8, groups of 256,
    capacity factor 1.25: 7 slots a group an expert, 448 a slab) into the
    einsum dispatch's slabs; the forward, dgrad and wgrad of the expert
    FFN's products (up and gate share a weight here: one (E, d, F) and one
    (E, F, d) weight, 11.3 GB each) at those live counts against the
    plain versions, timed against ``torch.bmm`` and the bound."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import expert_matmul as xm
    from repro_torch.models import moe as moe_mod
    t0 = phase("30. (c) K3 at kimi-k2's MoE training shapes (E 384, d 7168, "
               "F 2048) over the live counts of one 4 x 4096 microbatch "
               "routed by a kimi router: forward, dgrad and wgrad vs the "
               "plain versions, times vs torch.bmm")
    mcfg = get_arch("kimi-k2-1t-a32b").make_config().moe
    E, d, F_ = mcfg.n_experts, 7168, mcfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(31)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)
    T, g = 4 * 4096, mcfg.group_size
    G = T // g
    C = max(4, math.ceil(g * mcfg.top_k * mcfg.capacity_factor / E))
    x = rnd(G, g, d)
    router = {"router": {"kernel": rnd(d, E, scale=d ** -0.5,
                                       dtype=torch.float32)}}
    with torch.no_grad():
        _, _, top_idx = moe_mod._router(router, x, mcfg, None, mcfg.top_k)
        dest, keep, counts = moe_mod.dispatch_plan(top_idx, E, C)
        tok = torch.div(torch.arange(T * mcfg.top_k, device=dev),
                        mcfg.top_k, rounding_mode="floor")
        slabs = x.new_zeros((E * G * C + 1, d))
        slabs.index_copy_(0, dest, x.reshape(T, d)[tok])
        h = slabs[:-1].view(E, G * C, d)
    del x, slabs, top_idx, dest, keep, tok
    live = counts.clamp(max=G * C)
    kept, dead = int(live.sum()), int((live == 0).sum())
    w_in = rnd(E, d, F_, scale=d ** -0.5)
    w_out = rnd(E, F_, d, scale=F_ ** -0.5)
    hid, dy_f, dy_d = rnd(E, G * C, F_), rnd(E, G * C, F_), \
        rnd(E, G * C, d)
    calls = {
        "fwd": [((h, w_in, counts), {}), ((h, w_in, counts), {}),
                ((hid, w_out, counts), {})],
        "dgrad": [((dy_f, w_in, counts), {}), ((dy_f, w_in, counts), {}),
                  ((dy_d, w_out, counts), {})],
        "wgrad": [((h, dy_f, counts), {}), ((h, dy_f, counts), {}),
                  ((hid, dy_d, counts), {})]}
    fns = {"fwd": ("expert_matmul", xm.expert_matmul,
                   xm.expert_matmul_plain, "tma"),
           "dgrad": ("expert_matmul_dgrad", xm.expert_matmul_dgrad,
                     xm.expert_matmul_dgrad_plain, "persistent"),
           "wgrad": ("expert_matmul_wgrad", xm.expert_matmul_wgrad,
                     xm.expert_matmul_wgrad_plain, "persistent")}
    errs = {}
    rows_dead = torch.arange(G * C, device=dev)[None, :] >= counts[:, None]
    for kind, (name, kern, plain, want_v) in fns.items():
        worst = (0.0, 0.0)
        for args, _ in calls[kind][1:]:          # the two distinct calls
            with torch.no_grad(), launched(name) as took:
                got = kern(*args)
            with torch.no_grad():
                want = plain(*args)
            if took != {want_v: 1}:
                raise AssertionError(f"(c) {name}: launches {took}")
            tol = K3_BWD_TOL["bfloat16"] if kind != "fwd" \
                else TOL["bfloat16"]
            err = errs_of(got, want, tol)
            if kind == "wgrad":
                if not bool((got[counts == 0] == 0).all()):
                    raise AssertionError("(c) K3 wgrad: a dead expert's dw "
                                         "is not 0")
            elif not bool((got[rows_dead] == 0).all()):
                raise AssertionError(f"(c) K3 {kind}: non-zero past the "
                                     f"counts")
            worst = tuple(map(max, zip(worst, err)))
            del got, want
        errs[name] = worst
        log(f"  {name}: {worst[1]:.3g} of the largest value (tol {tol}), "
            f"max abs err {worst[0]:.3g}, on {want_v}; zeros past the "
            f"counts exact")
    nograd = torch.no_grad
    rows = {
        "k3_fwd": time_rows("K3 forward, kimi-k2 MoE layer (up, gate, "
                            "down)", calls["fwd"], xm.expert_matmul,
                            xm.expert_matmul_plain,
                            lambda a, w, c: torch.bmm(a, w), "torch.bmm",
                            k3_work, mode=nograd),
        "k3_dgrad": time_rows("K3 dgrad, kimi-k2 MoE layer", calls["dgrad"],
                              xm.expert_matmul_dgrad,
                              xm.expert_matmul_dgrad_plain,
                              k3_dgrad_library, "torch.bmm", k3_dgrad_work,
                              mode=nograd),
        "k3_wgrad": time_rows("K3 wgrad, kimi-k2 MoE layer", calls["wgrad"],
                              xm.expert_matmul_wgrad,
                              xm.expert_matmul_wgrad_plain,
                              k3_wgrad_library, "torch.bmm", k3_wgrad_work,
                              mode=nograd)}
    for kind, (name, kern, _, want_v) in fns.items():
        rows[f"k3_{kind}"]["launches"] = row_launches(name, calls[kind], kern,
                                                      want_v)
    log(f"  the rows' launches, counted: "
        f"{ {k: r['launches'] for k, r in rows.items()} }")
    out = {"E": E, "slab": G * C, "live_rows": kept, "dead_experts": dead,
           "errs": errs, "rows": rows}
    del calls, h, hid, dy_f, dy_d, w_in, w_out
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"  {kept} live rows of {E * G * C} slots ({dead} experts dead); "
        f"({out['seconds']:.1f} s) [{card}]")
    return out


def tc_mesh_cfg(arch_id: str):
    """(config, global batch, microbatches) of a config's shared-card
    mesh cut (``steps.SHARED_CARD_CUT``)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import SHARED_CARD_CUT
    cut = dict(SHARED_CARD_CUT[(arch_id, "train_4k")])
    B, accum = cut.pop("global_batch"), cut.pop("accum")
    return dataclasses.replace(get_arch(arch_id).make_config(), **cut), B, \
        accum


def tc_mesh_one(dev, path: str) -> dict:
    """Phase 30 (d)'s one-process steps, in this process before the
    ranks: each config at its shared-card cut, the launcher's seed-0
    parameters and step-0 batch; loss, gradient norm and clipped
    gradients saved to ``path``, in bf16 (11.4 GB of kimi's and
    granite's fp32 gradients took ~35 s to write; bf16's rounding, 2^-9
    of an element, is a tenth of (d)'s tolerances)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import train as train_mod
    from repro_torch.optim.api import named_leaves
    out, saved = {}, {}
    for arch_id in TC_MESH_ARCHS:
        cfg, B, accum = tc_mesh_cfg(arch_id)
        params = train_mod.init_params(get_arch(arch_id), cfg, dev)
        for _, p in named_leaves(params):
            p.requires_grad_(True)
        step, kept = grad_step(cfg, accum=accum)
        _, _, m = step(params, None, lm_train_batch(B, 4096, cfg.vocab_size,
                                                    dev), 0)
        out[arch_id] = {"loss": float(m["loss"]), "gnorm": float(m["gnorm"])}
        saved[arch_id] = {k: g.to(torch.bfloat16).cpu()
                          for k, g in flat_grads(kept.pop()).items()}
        del params, m
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.save({"grads": saved, **out}, path)
    out["save_s"] = time.perf_counter() - t0
    return out


def tc_mesh_rank(rank: int, world: int, init_file: str,
                 one_file: str) -> dict:
    """One rank of phase 30 (d), on cuda:0 beside the other: for each
    config, its blocks of the launcher's seed-0 parameters under the
    training placement (``mesh_state``: TP over "model", granite's one kv
    head's columns split between the ranks), one step of its optimizer
    on blocks (Adafactor's factored moments reduced over the ranks for
    kimi), its clipped gradient blocks kept and held against the one
    process's, the launches counted."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import (microbatch_rows, synthetic_lm_batches,
                                  to_device)
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import (is_spec, shard_leaf,
                                                  train_spec_fn)
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.api import named_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    ctx.init_ranks(rank, world, init_file, "cuda",
                   local_world=ctx.local_world_size(world, False))
    dev = ctx.rank_device()
    mesh = make_mesh(TC_MESH, ("data", "model"))
    one = torch.load(one_file, map_location="cpu", mmap=True,
                     weights_only=True)
    out = {"rank": rank}
    for arch_id in TC_MESH_ARCHS:
        cfg, B, accum = tc_mesh_cfg(arch_id)
        arch = get_arch(arch_id)
        init_fn, update_fn = make_optimizer(arch.optimizer)
        state, pspecs = train_mod.mesh_state(cfg, mesh, train_spec_fn(cfg),
                                             init_fn, dev)
        params, opt = state["params"], state["opt"]
        for _, p in named_leaves(params):
            p.requires_grad_(True)
        kept = []

        def keep(params, grads, opt, step, layout=None):
            kept.append({k: g.detach().clone()
                         for k, g in named_leaves(grads)})
            return update_fn(params, grads, opt, step, layout=layout)
        step = make_lm_train_step(cfg, keep, accum, mesh=mesh, specs=pspecs)
        rows = microbatch_rows(B, accum, TC_MESH[0],
                               ctx.axes_index(mesh, ("data",)))
        batch = to_device(next(synthetic_lm_batches(
            global_batch=B, seq_len=4096, vocab=cfg.vocab_size, rows=rows)),
            dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch, 0)
        loss, gn = float(m["loss"]), float(m["gnorm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches, variants = ops.launch_counts(), ops.variant_counts()
        specs = dict(named_leaves(pspecs, is_leaf=is_spec))
        err = {}
        for k, g in kept.pop().items():
            ref = shard_leaf(one["grads"][arch_id][k], specs[k], mesh).to(dev)
            err[k] = float((g.float() - ref).abs().max()) / max(
                float(ref.abs().max()), 1e-30)
        finite = all(bool(torch.isfinite(p).all())
                     for _, p in named_leaves(params))
        out[arch_id] = {"loss": loss, "gnorm": gn, "step_ms": ms,
                        "grad_err": max(err.values()),
                        "worst_leaf": max(err, key=err.get),
                        "finite": finite,
                        "peak_gib": torch.cuda.max_memory_allocated(dev)
                        / 2 ** 30,
                        "launches": launches, "variants": variants}
        del state, params, opt, kept, batch
        torch.cuda.empty_cache()
    ctx.close_ranks()
    return out


def tc_mesh(dev, card: str, b_tols: dict) -> dict:
    """Phase 30 (d): granite-20b and kimi-k2 on a 1 x 2 mesh of two ranks
    sharing the card over gloo, one step each, against the one-process
    step on the same parameters and batch, within phase 29 (c)'s
    tolerances: MT_C_FACTOR x (b)'s kernel-vs-plain errors of the same
    config (``b_tols``), with phase 29 (c)'s floors."""
    import tempfile

    from repro_torch.distributed import ctx
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.makedirs(build_dir, exist_ok=True)
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        one_file = os.path.join(tmp, "one.pt")
        t0 = phase("30. (d) one process: granite-20b (2 layers) and kimi-k2 "
                   "(its dense layer) at steps.SHARED_CARD_CUT, 2 x 4096 as "
                   "1 microbatch, their gradients kept")
        one = tc_mesh_one(dev, one_file)
        log("  " + ", ".join(f"{a}: loss {r['loss']:.6f}, gradient norm "
                             f"{r['gnorm']:.5f}" for a, r in one.items()
                             if a != "save_s")
            + f" ({time.perf_counter() - t0:.1f} s, {one['save_s']:.1f} s of "
            f"it writing the gradients)")
        t0 = phase("30. (d) the same steps across a 1 x 2 (data, model) mesh, "
                   "two ranks sharing the card over gloo (not a multi-card "
                   "speed): TP attention with the k and v projections "
                   "gathered over model (granite's MQA head split between "
                   "the ranks, kimi's 8 kv heads 4 a rank), kimi's "
                   "Adafactor on blocks")
        res = ctx.spawn_ranks(tc_mesh_rank, 2, (os.path.join(
            tmp, "rendezvous"), one_file), timeout_s=900)
    out = {"one": one, "tol": {}, "launches": {}, "variants": {}}
    for arch_id in TC_MESH_ARCHS:
        b = b_tols[arch_id]
        tol = {"loss": max(MT_C_FACTOR * b["loss_rel"], 1e-4),
               "gnorm": max(MT_C_FACTOR * b["gnorm_rel"], 1e-3),
               "grad": max(MT_C_FACTOR * b["grad_err"], 1e-3)}
        out["tol"][arch_id] = tol
        o = one[arch_id]
        for r in res:
            x = r[arch_id]
            if not x["finite"] or \
                    not abs(x["loss"] - o["loss"]) <= tol["loss"] * abs(
                        o["loss"]) or \
                    not abs(x["gnorm"] - o["gnorm"]) <= tol["gnorm"] * abs(
                        o["gnorm"]) or x["grad_err"] > tol["grad"]:
                raise AssertionError(f"(d) {arch_id} rank {r['rank']}: "
                                     f"{ {k: v for k, v in x.items() if k not in ('launches', 'variants')} } "
                                     f"against {o} (tolerances {tol})")
            idle = [k for k in TC_KERNELS if x["launches"][k] <= 0]
            if idle:
                raise AssertionError(f"(d) {arch_id} rank {r['rank']}: "
                                     f"kernels not launched {idle}")
            main_path_variants(x["variants"], TC_VARIANTS)
        out["launches"][arch_id] = {k: sum(r[arch_id]["launches"][k]
                                           for r in res)
                                    for k in res[0][arch_id]["launches"]}
        out["variants"][arch_id] = {
            k: {v: sum(r[arch_id]["variants"][k][v] for r in res)
                for v in res[0][arch_id]["variants"][k]}
            for k in res[0][arch_id]["variants"]}
        out[arch_id] = [{k: v for k, v in r[arch_id].items()
                         if k not in ("launches", "variants")} for r in res]
        log(f"  {arch_id}: loss {res[0][arch_id]['loss']:.6f} / "
            f"{o['loss']:.6f}, gradient norm {res[0][arch_id]['gnorm']:.5f} "
            f"/ {o['gnorm']:.5f}; gradient blocks within "
            + ", ".join(f"{r[arch_id]['grad_err']:.3g} "
                        f"({r[arch_id]['worst_leaf']})" for r in res)
            + f" of a leaf's largest; tolerances "
            f"{ {k: float(f'{v:.3g}') for k, v in tol.items()} }; rank 0's "
            f"step {res[0][arch_id]['step_ms']:.0f} ms (gloo-bound), peaks "
            + ", ".join(f"{r[arch_id]['peak_gib']:.2f}" for r in res)
            + " GiB; launches (2 ranks) "
            + str({k: n for k, n in out['launches'][arch_id].items() if n}))
    out["seconds"] = time.perf_counter() - t_all
    log(f"  ({time.perf_counter() - t0:.1f} s with the ranks) [{card}]")
    return out


def train_configs_phases(dev, card: str) -> dict:
    """Phase 30 (module constants above): (a), (b) for each config in
    turn (its state freed before the next), (c), (d).  Returns what the
    kernels' record needs."""
    import torch
    t_all = time.perf_counter()
    out = {"a": k2_d112_train(dev, card), "b": {}}
    for arch_id in TC_ARCHS:
        out["b"][arch_id] = train_config(arch_id, dev, card)
        torch.cuda.empty_cache()
    out["c"] = k3_kimi_train(dev, card)
    out["d"] = tc_mesh(dev, card, {a: out["b"][a]["route"]
                                   for a in TC_MESH_ARCHS})
    names = set(LM_TRAIN_KERNELS)
    out["launches"] = {k: sum(r["launches"].get(k, 0)
                              for r in out["b"].values()) for k in names}
    out["variants"] = {k: {a: r["variants"][k] for a, r in out["b"].items()
                           if k in r["variants"]} for k in names}
    out["mesh_launches"] = {k: sum(r.get(k, 0) for r in
                                   out["d"]["launches"].values())
                            for k in names}
    out["mesh_variants"] = {k: {a: r[k] for a, r in
                                out["d"]["variants"].items() if k in r}
                            for k in names}
    out["seconds"] = time.perf_counter() - t_all
    log(f"  phase 30 {out['seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------- phase 31
# the vision family trained across a 2 x 2 (data, model) mesh, four ranks
# on cuda:0 over gloo (not a multi-card speed): the reference's
# ``vision_rules`` placement (``vision_train_spec_fn``: attention and MLP
# tensor parallel, convs split on their output channels and the classifier
# on its rows over "model", no FSDP), BN over the whole microbatch (its
# sums all-reduced over "data"), cls_224 at full width and depth, the
# global batch cut from 256 to 8 images as 2 microbatches (a data block
# holds 2 of each: ``steps.SHARED_CARD_CUT``)
VM_MESH = (2, 2)
VM_STEPS = 2
VM_RUNS = ("resnet-152", "dynamic-ofa-supernet", "efficientnet-b7")   # (a)
# (a)'s nets trained with a failure at step 1 and a restart from step 0;
# EfficientNet-B7 trains its 2 steps without (cut for the script's time:
# its restart's step is ~5.5 s of four ranks' gloo traffic)
VM_RESTART = ("resnet-152", "dynamic-ofa-supernet")
VM_CHECK = ("resnet-152", "dynamic-ofa-supernet")               # (b), (c)
# (c)'s compute dtype.  ResNet-152's step at init is ill-conditioned (BN
# over 2-4 images through 155 layers, var = E[x^2] - E[x]^2): in one
# process, the same step on each microbatch's rows in another order moves
# its bf16 loss by ~0.2% and a leaf's gradient by ~100%, its fp32 loss by
# ~1e-5 and a leaf's gradient by ~10% (CPU, full depth at 64 x 64).  So
# (c) holds it in fp32, on the same kernels, where the step's own noise
# is small enough to show a fault; its bf16 main path is held by (b), and
# its mesh step by tests/_torch_resnet152_witness.py (float64, against
# the reference).  The ViT's (c) stays in bf16
VM_C_DTYPE = {"resnet-152": "float32", "dynamic-ofa-supernet": "bfloat16"}
VM_KERNELS = {"resnet-152": K1_KERNELS, "efficientnet-b7": K1_KERNELS,
              "dynamic-ofa-supernet": K1_KERNELS + (
                  "flash_attention", "flash_attention_bwd")}
# every bf16 call of these paths on the Hopper variants (EfficientNet's
# squeeze-excite widths 12 and 20 take K1's tile and wmma variants, as in
# phase 22: its path is held by its launches alone)
VM_VARIANTS = {
    "resnet-152": {("elastic_matmul", "tma"), ("elastic_matmul_dgrad", "tma"),
                   ("elastic_matmul_wgrad", "tma")},
    "dynamic-ofa-supernet": {("elastic_matmul", "tma"),
                             ("elastic_matmul_dgrad", "tma"),
                             ("elastic_matmul_wgrad", "tma"),
                             ("flash_attention", "wgmma"),
                             ("flash_attention_bwd", "resident")}}
VM_ROWS = ("k1_fwd", "k1_dgrad", "k1_wgrad", "k2_fwd", "k2_bwd")
# (c)'s tolerances: MT_C_FACTOR x the step's noise measured in this run,
# at least phase 29 (b)'s (what bf16 rounding may move the LM's mesh step
# by); BN's statistics at least 1e-3.  The noise: (b) the kernel route
# against the plain route on the mesh, (b') the same in one process, (b'')
# one process on each microbatch's rows reversed (the same step in exact
# arithmetic; BN's sums and the batched products in another order).  The
# mesh sums in other orders by design (BN's sums over "data", the ViT's o
# and wo partials over "model")
VM_C_FLOORS = {"loss": MT_LOSS_TOL, "gnorm": MT_GNORM_TOL,
               "grad": MT_GRAD_TOL, "stats": 1e-3}
# a leaf's gradient error is a share of its largest entry, or of this
# share of the whole tree's largest where it is larger: a leaf whose
# gradient vanishes in exact arithmetic (the keys' bias, which a softmax
# does not see) is round-off (tests/test_torch_vision_mesh.py's rule)
VM_VANISHING = 1e-2


def vm_cfg(arch_id: str, dtype=None) -> tuple:
    """(arch, cls_224 config, global batch, microbatches) as the launcher
    trains ``arch_id`` on ranks sharing the card; ``dtype``: the config's
    compute dtype instead (its parameters are fp32 at any)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import SHARED_CARD_CUT
    arch = get_arch(arch_id)
    cut = SHARED_CARD_CUT[(arch_id, "cls_224")]
    if set(cut) != {"global_batch", "accum"}:
        raise AssertionError(f"{arch_id}: the shared-card cut {cut} cuts "
                             f"more than the batch")
    cfg = dataclasses.replace(arch.make_config(), img_res=224)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    return arch, cfg, cut["global_batch"], cut["accum"]


def keeping(update_fn, kept: list):
    """An update that keeps the clipped gradients (fp32 copies; zeros for
    a leaf no loss reached) and then applies ``update_fn`` (None: no
    update)."""
    import torch

    from repro_torch.optim.api import named_leaves

    def update(params, grads, opt, step, layout=None):
        kept.append({k: torch.zeros_like(p, dtype=torch.float32)
                     if g is None else g.detach().float().clone()
                     for (k, p), (_, g) in zip(named_leaves(params),
                                               named_leaves(grads))})
        if update_fn is None:
            return params, opt
        return update_fn(params, grads, opt, step, layout=layout)
    return update


def vm_probe(arch_id: str, params, batch: dict, cfg, accum: int,
             mesh=None, specs=None) -> list:
    """Each microbatch's forward of ``batch`` (a rank's rows of each under
    ``mesh``) without gradient, as the train step runs it: [(ResNet-152's
    BN statistics in order, else None; each row's cross entropy)], fp32
    on the host."""
    import torch
    import torch.nn.functional as F

    from repro_torch.launch.steps import vis_forward
    from repro_torch.models.resnet import resnet_apply
    n = batch["images"].shape[0] // accum
    out = []
    with torch.no_grad():
        for i in range(accum):
            x = batch["images"][i * n:(i + 1) * n]
            st = None
            if arch_id == "resnet-152":
                logits, st = resnet_apply(params, x, cfg, train=True,
                                          collect_stats=True, mesh=mesh,
                                          specs=specs)
                st = [(name, m.float().cpu(), v.float().cpu())
                      for name, (m, v) in st]
            else:
                logits = vis_forward(arch_id, cfg, mesh=mesh,
                                     specs=specs)(params, x)
            nll = F.cross_entropy(logits.float(),
                                  batch["labels"][i * n:(i + 1) * n].long(),
                                  reduction="none")
            out.append((st, nll.cpu()))
    return out


def stats_err(got: list, want: list) -> float:
    """The largest error of BN statistics, each against its largest entry
    (a mean against the larger of its entries and its channels' spread)."""
    worst = 0.0
    for (n, m, v), (_, wm, wv) in zip(got, want, strict=True):
        spread = max(float(wm.abs().max()), float(wv.abs().max()) ** 0.5)
        worst = max(worst, float((m - wm).abs().max()) / max(spread, 1e-30),
                    float((v - wv).abs().max()) / max(
                        float(wv.abs().max()), 1e-30))
    return worst


def probe_err(got: list, want: list, rows=slice(None)) -> dict:
    """A probe (:func:`vm_probe`) against another, microbatch by
    microbatch: the largest BN statistics error (None without BN) and the
    largest relative error of a row's cross entropy; ``rows``: the rows of
    each of ``want``'s microbatches that ``got`` holds."""
    st = [None if g[0] is None else stats_err(g[0], w[0])
          for g, w in zip(got, want, strict=True)]
    nll = max(float(((g[1] - w[1][rows]).abs() / w[1][rows].abs()).max())
              for g, w in zip(got, want, strict=True))
    return {"stats_err": None if st[0] is None else max(st),
            "stats_err_by_mb": st, "nll_err": nll}


def route_diffs(loss: float, loss_ref: float, gnorm: float,
                gnorm_ref: float, grads: dict, refs: dict,
                whole: dict) -> dict:
    """A step's loss and gradient norm relative to a reference step's,
    and its gradients' largest error, each against the larger of its
    leaf's largest entry and ``VM_VANISHING`` of the largest entry of
    ``whole`` (the whole tree), with the leaf where it is worst."""
    floor = VM_VANISHING * max(float(g.abs().max()) for g in whole.values())
    err = {k: float((g - refs[k]).abs().max()) / max(
        float(refs[k].abs().max()), floor) for k, g in grads.items()}
    return {"loss_rel": abs(loss - loss_ref) / abs(loss_ref),
            "gnorm_rel": abs(gnorm - gnorm_ref) / abs(gnorm_ref),
            "grad_err": max(err.values()),
            "worst_leaf": max(err, key=err.get)}


def vm_one(dev, path: str) -> dict:
    """Phase 31's one-process steps, in this process before the ranks:
    each of ``VM_CHECK`` at the launcher's seed-0 parameters and step-0
    batch (8 x 224 as 2 microbatches) in (c)'s dtype, on the kernel route
    (its loss, gradient norm, clipped gradients and each microbatch's
    probe saved to ``path`` for (c)), on the plain route (b') and on each
    microbatch's rows reversed (b'')."""
    import torch

    from repro_torch.data import synthetic_image_batches, to_device
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_vis_train_step
    from repro_torch.optim.api import named_leaves
    out, saved = {}, {}
    for arch_id in VM_CHECK:
        arch, cfg, B, accum = vm_cfg(arch_id, VM_C_DTYPE[arch_id])
        params = train_mod.init_params(arch, cfg, dev)
        for _, p in named_leaves(params):
            p.requires_grad_(True)
        kept = []
        step = make_vis_train_step(arch_id, cfg, keeping(None, kept), accum)
        batch = to_device(next(synthetic_image_batches(
            global_batch=B, img_res=cfg.img_res, n_classes=cfg.n_classes)),
            dev)
        n = B // accum
        rev = torch.cat([torch.arange((i + 1) * n - 1, i * n - 1, -1)
                         for i in range(accum)]).to(dev)
        rbatch = {k: v[rev] for k, v in batch.items()}
        _, _, m = step(params, None, batch, 0)
        _, _, mr = step(params, None, rbatch, 0)
        with ops.plain_kernels():
            _, _, mp = step(params, None, batch, 0)
        probe = vm_probe(arch_id, params, batch, cfg, accum)
        # the reversed rows' probe, each microbatch's row losses put back
        # in the batch's order
        rprobe = [(st, nll.flip(0)) for st, nll in vm_probe(
            arch_id, params, rbatch, cfg, accum)]
        out[arch_id] = {
            "loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
            "dtype": cfg.compute_dtype,
            "mb_loss": [float(nll.mean()) for _, nll in probe],
            "b_one": route_diffs(float(m["loss"]), float(mp["loss"]),
                                 float(m["gnorm"]), float(mp["gnorm"]),
                                 kept[0], kept[2], kept[0]),
            "b_rev": dict(route_diffs(float(mr["loss"]), float(m["loss"]),
                                      float(mr["gnorm"]), float(m["gnorm"]),
                                      kept[1], kept[0], kept[0]),
                          **probe_err(rprobe, probe))}
        saved[arch_id] = {"grads": {k: g.cpu() for k, g in kept[0].items()},
                          "probe": probe}
        del params, kept, m, mr, mp, batch, rbatch
        torch.cuda.empty_cache()
    torch.save({"saved": saved, **out}, path)
    return out


def vm_rank(rank: int, world: int, tmp: str, one_file: str,
            argvs: list) -> dict:
    """One rank of phase 31, on cuda:0 beside three others: (a) each
    net of ``VM_RUNS`` through the launcher's own rank entry
    (``launch.train.train_rank``, as ``--mesh 2x2`` spawns it: the launch
    counts reset before its run and read after), the ranks brought down
    and up between nets; then on one group (b) one step of each of
    ``VM_CHECK`` on the kernel route against the plain route, the kernel
    route's launches counted and its K1 and K2 calls recorded, (c) the
    step in (c)'s dtype against the one-process step, with each
    microbatch's probe, and (e) rank 0's recorded calls timed while the
    others wait.  Plain values back."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import layers as layers_mod
    from repro_torch.data import (microbatch_rows, synthetic_image_batches,
                                  to_device)
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import (is_spec, shard_leaf,
                                                  vision_train_spec_fn)
    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_vis_train_step
    from repro_torch.optim.api import named_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {"rank": rank, "a": {}}
    for i, (arch_id, argv) in enumerate(argvs):
        torch.cuda.reset_peak_memory_stats()      # each net's own peak
        t0 = time.perf_counter()
        r = train_mod.train_rank(rank, world, os.path.join(tmp, f"a{i}"),
                                 argv)
        r["seconds"] = time.perf_counter() - t0
        out["a"][arch_id] = r
        ctx.close_ranks()
        torch.cuda.empty_cache()
    ctx.init_ranks(rank, world, os.path.join(tmp, "b"), "cuda",
                   local_world=world)
    dev = ctx.rank_device()
    mesh = make_mesh(VM_MESH, ("data", "model"))
    one = torch.load(one_file, map_location="cpu", mmap=True,
                     weights_only=True)
    rec = {k: {} for k in VM_ROWS}
    targets = [(layers_mod, "elastic_matmul_op", "k1_fwd"),
               (em, "elastic_matmul_dgrad", "k1_dgrad"),
               (em, "elastic_matmul_wgrad", "k1_wgrad"),
               (fa, "flash_attention", "k2_fwd"),
               (fa, "flash_attention_bwd", "k2_bwd")]
    out["b"], out["c"] = {}, {}
    for arch_id in VM_CHECK:
        arch, cfg, B, accum = vm_cfg(arch_id)
        c_cfg = vm_cfg(arch_id, VM_C_DTYPE[arch_id])[1]
        state, pspecs = train_mod.mesh_state(
            cfg, mesh, vision_train_spec_fn(arch_id, cfg), lambda p: None,
            dev, arch)
        params = state["params"]
        for _, p in named_leaves(params):
            p.requires_grad_(True)
        specs = dict(named_leaves(pspecs, is_leaf=is_spec))
        d = ctx.axes_index(mesh, ("data",))
        rows = microbatch_rows(B, accum, VM_MESH[0], d)
        batch = to_device(next(synthetic_image_batches(
            global_batch=B, img_res=cfg.img_res, n_classes=cfg.n_classes,
            rows=rows)), dev)
        kept = []

        def run(step_cfg):
            step = make_vis_train_step(arch_id, step_cfg,
                                       keeping(None, kept), accum,
                                       mesh=mesh, specs=pspecs)
            _, _, m = step(params, None, batch, 0)
            torch.cuda.synchronize()
            return float(m["loss"]), float(m["gnorm"]), kept.pop()
        t0 = time.perf_counter()
        with ops.plain_kernels():
            lp, gp, grads_p = run(cfg)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        with recording(targets, keep_calls(rec)):
            lk, gk, grads_k = run(cfg)
        ms = (time.perf_counter() - t1) * 1e3
        launches, variants = ops.launch_counts(), ops.variant_counts()
        whole = one["saved"][arch_id]["grads"]
        out["b"][arch_id] = dict(
            route_diffs(lk, lp, gk, gp, grads_k, grads_p, whole),
            loss=lk, loss_plain=lp, gnorm=gk, gnorm_plain=gp, step_ms=ms,
            launches=launches, variants=variants,
            seconds=time.perf_counter() - t0)
        del grads_p
        # (c): the step in (c)'s dtype (the kernel route's, where that is
        # the main path's) and each microbatch's probe
        t0 = time.perf_counter()
        if c_cfg.compute_dtype == cfg.compute_dtype:
            lc, gc, grads_c = lk, gk, grads_k
        else:
            del grads_k
            lc, gc, grads_c = run(c_cfg)
        blocks = {k: shard_leaf(whole[k], specs[k], mesh).to(dev)
                  for k in grads_c}
        per = B // accum // VM_MESH[0]
        probe = vm_probe(arch_id, params, batch, c_cfg, accum, mesh, pspecs)
        o = one[arch_id]
        out["c"][arch_id] = dict(
            route_diffs(lc, o["loss"], gc, o["gnorm"], grads_c, blocks,
                        whole),
            **probe_err(probe, one["saved"][arch_id]["probe"],
                        slice(d * per, (d + 1) * per)),
            nll=[nll.tolist() for _, nll in probe],
            seconds=time.perf_counter() - t0)
        del state, params, grads_c, blocks, batch, probe, whole
        torch.cuda.empty_cache()
    del one
    # (e) rank 0 times its recorded calls while the others wait
    nograd = torch.no_grad
    if rank == 0:
        t0 = time.perf_counter()
        rows = {
            "k1_fwd": time_rows(
                "K1 forward, vision mesh steps (ResNet-152's split convs, the "
                "ViT's TP projections)", expand(rec["k1_fwd"]),
                ops.elastic_matmul_op, k1_plain, k1_library, "torch.matmul",
                k1_work, group=k1_group, mode=nograd),
            "k1_dgrad": time_rows(
                "K1 dgrad, vision mesh steps", expand(rec["k1_dgrad"]),
                em.elastic_matmul_dgrad, k1_dgrad_plain, k1_dgrad_library,
                "torch.matmul", k1_dgrad_work, group=bwd_group,
                mode=nograd),
            "k1_wgrad": time_rows(
                "K1 wgrad, vision mesh steps", expand(rec["k1_wgrad"]),
                em.elastic_matmul_wgrad, k1_wgrad_plain, k1_wgrad_library,
                "torch.matmul", k1_wgrad_work, group=bwd_group,
                mode=nograd),
            "k2_fwd": time_rows(
                "K2 forward (non-causal, 3 of 6 heads, with the "
                "logsumexp), vision mesh step", expand(rec["k2_fwd"]),
                k2_fwd_lse, k2_fwd_lse_plain, k2_fwd_lse_library, "sdpa",
                k2_work, mode=nograd),
            "k2_bwd": time_rows(
                "K2 backward (non-causal, 3 of 6 heads), vision mesh step",
                expand(rec["k2_bwd"]), k2_bwd_kernel, k2_bwd_plain,
                SdpaBackward(), "sdpa backward", k2_bwd_work, mode=nograd)}
        for k, r in rows.items():
            r["launches"] = sum(n for *_, n in rec[k].values())
        out["rows"] = rows
        out["rows_s"] = time.perf_counter() - t0
    del rec
    dist.barrier()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ctx.close_ranks()
    return out


def vm_c_tol(arch_id: str, one: dict, b: list, c: list) -> dict:
    """Phase 31 (c)'s tolerances for ``arch_id``: ``MT_C_FACTOR`` x the
    step's noise in this run ((b) on every rank, (b') and (b'') in one
    process), at least ``VM_C_FLOORS``; and each microbatch's loss on the
    mesh (the row losses of the ``"model"``-rank-0 rank of each data
    block) beside one process's."""
    o = one[arch_id]
    noise = b + [o["b_one"], o["b_rev"]]
    worst = {k: max(x.get(k) or 0.0 for x in noise)
             for k in ("loss_rel", "gnorm_rel", "grad_err", "stats_err",
                       "nll_err")}
    tol = {k: max(MT_C_FACTOR * worst[w], VM_C_FLOORS[f])
           for k, w, f in (("loss", "loss_rel", "loss"),
                           ("gnorm", "gnorm_rel", "gnorm"),
                           ("grad", "grad_err", "grad"),
                           ("stats", "stats_err", "stats"),
                           ("nll", "nll_err", "loss"))}
    heads = range(0, len(c), VM_MESH[1])
    mb_loss = [sum(sum(c[r]["nll"][i]) for r in heads)
               / sum(len(c[r]["nll"][i]) for r in heads)
               for i in range(len(c[0]["nll"]))]
    return {"tol": tol, "mb_loss": mb_loss, "mb_loss_one": o["mb_loss"]}


def vision_mesh_phases(dev, card: str) -> dict:
    """Phase 31: the vision family trained across a 2 x 2 mesh, four ranks
    sharing the card over gloo: the one-process steps in this process
    first, then four ranks (:func:`vm_rank`) for (a) the launcher's rank
    entry, 2 steps of each net, a failure at step 1 and a restart (no
    checkpoint; ``VM_RESTART``'s nets), (b) the kernel route against the
    plain route, (c) the mesh step against the one-process step in (c)'s
    dtype, within twice the step's noise, (e) rank 0's kernel rows.  Returns what the
    kernels' record needs."""
    import tempfile

    import torch

    from repro_torch.distributed import ctx
    t_all = time.perf_counter()
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.makedirs(build_dir, exist_ok=True)
    mesh = "x".join(map(str, VM_MESH))
    argvs = [(a, ["--arch", a, "--mesh", mesh, "--steps", str(VM_STEPS)]
              + (["--fail-at", "1"] if a in VM_RESTART else [])
              + ["--save-every", "0", "--log-every", "1", "--device",
                 "cuda"]) for a in VM_RUNS]
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        one_file = os.path.join(tmp, "one.pt")
        t0 = phase("31. one process: ResNet-152 (fp32) and the "
                   "dynamic-ofa-supernet (bf16) at cls_224, full width and "
                   "depth, 8 x 224 as 2 microbatches (steps.SHARED_CARD_CUT): "
                   "the kernel route kept for (c), the plain route (b') and "
                   "each microbatch's rows reversed (b'')")
        one = vm_one(dev, one_file)
        for a, r in one.items():
            log(f"  {a} ({r['dtype']}): loss {r['loss']:.6f} (microbatches "
                + ", ".join(f"{x:.6f}" for x in r["mb_loss"])
                + f"), gradient norm {r['gnorm']:.5f}; (b') plain route: "
                f"loss {r['b_one']['loss_rel']:.3g}, gradient norm "
                f"{r['b_one']['gnorm_rel']:.3g} relative, gradients within "
                f"{r['b_one']['grad_err']:.3g} ({r['b_one']['worst_leaf']}); "
                f"(b'') rows reversed: loss {r['b_rev']['loss_rel']:.3g}, "
                f"gradient norm {r['b_rev']['gnorm_rel']:.3g}, gradients "
                f"within {r['b_rev']['grad_err']:.3g} "
                f"({r['b_rev']['worst_leaf']}), a row's loss "
                f"{r['b_rev']['nll_err']:.3g}"
                + (f", BN statistics {r['b_rev']['stats_err']:.3g}"
                   if r["b_rev"]["stats_err"] is not None else ""))
        log(f"  ({time.perf_counter() - t0:.1f} s)")
        for a, argv in argvs:
            argv += ["--ckpt-dir", os.path.join(tmp, f"ckpt-{a}")]
        t0 = phase(
            f"31. (a), (b), (c), (e) the vision family trained across a "
            f"{mesh} (data, model) mesh, four ranks sharing the card over "
            f"gloo (not a multi-card speed): the reference's vision_rules "
            f"(attention and MLP TP, convs on their output channels and "
            f"the classifier on its rows over model, no FSDP), BN over "
            f"the whole microbatch, cls_224 at full width and depth, 8 "
            f"images as 2 microbatches (2 of each a data block); (a) "
            + "; ".join(f"python -m repro_torch.launch.train "
                        f"{' '.join(v[:-4])}" for _, v in argvs)
            + f": {VM_STEPS} steps, a failure at step 1 and a restart from "
            f"step 0 (no checkpoint; EfficientNet-B7 without); then on the "
            f"same ranks (b) the kernel "
            f"route vs the plain route, (c) the mesh step vs the "
            f"one-process step, (e) rank 0's kernel rows")
        res = ctx.spawn_ranks(vm_rank, 4, (tmp, one_file, argvs),
                              timeout_s=900)
    out = {"ranks_s": time.perf_counter() - t0, "one": one, "a": {},
           "b": {}, "c": {}, "tol": {}, "launches": {}, "variants": {}}
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    for arch_id in VM_RUNS:
        ranks = [r["a"][arch_id] for r in res]
        restarts = int(arch_id in VM_RESTART)
        for r in ranks:
            ls = r["losses"]
            if r["restarts"] != restarts or len(ls) != VM_STEPS + restarts:
                raise AssertionError(f"(a) {arch_id} rank {r['rank']}: "
                                     f"{r['restarts']} restarts, losses {ls}")
            if not all(math.isfinite(x) for x in ls):
                raise AssertionError(f"(a) {arch_id} rank {r['rank']}: "
                                     f"losses {ls}")
            if restarts and ls[0] != ls[1]:
                raise AssertionError(f"(a) {arch_id} rank {r['rank']}: step "
                                     f"0 after the restart {ls[1]!r}, first "
                                     f"{ls[0]!r}")
            if ls != ranks[0]["losses"]:
                raise AssertionError(f"(a) {arch_id}: the ranks' global "
                                     f"losses differ")
            idle = [k for k in VM_KERNELS[arch_id] if r["launches"][k] <= 0]
            other = {k: n for k, n in r["launches"].items()
                     if n and k not in VM_KERNELS[arch_id]}
            if idle or other:
                raise AssertionError(f"(a) {arch_id} rank {r['rank']}: "
                                     f"kernels not launched {idle}, others "
                                     f"launched {other}")
            if arch_id in VM_VARIANTS:
                main_path_variants(r["variants"], VM_VARIANTS[arch_id])
        steady = ranks[0]["step_ms"][1:]
        out["a"][arch_id] = {
            "losses": ranks[0]["losses"], "step_ms": ranks[0]["step_ms"],
            "step_median_ms": statistics.median(steady),
            "peak_gib": [r["peak_gib"] for r in ranks],
            "seconds": ranks[0]["seconds"]}
        out["launches"][arch_id] = {k: sum(r["launches"][k] for r in ranks)
                                    for k in ranks[0]["launches"]}
        out["variants"][arch_id] = {
            k: {v: sum(r["variants"][k][v] for r in ranks)
                for v in ranks[0]["variants"][k]}
            for k in ranks[0]["variants"]}
        a = out["a"][arch_id]
        log(f"  (a) {arch_id}: losses "
            f"{', '.join(f'{x:.6f}' for x in a['losses'])} (the same on "
            f"every rank"
            + ("; step 0 again after the restart: the same bits"
               if arch_id in VM_RESTART else "; no failure") + "); "
            f"rank 0's steps {', '.join(f'{x:.0f}' for x in a['step_ms'])} "
            f"ms, median after the first {a['step_median_ms']:.1f} ms "
            f"(ranks sharing the card over gloo); peaks "
            f"{', '.join(f'{x:.2f}' for x in a['peak_gib'])} GiB of the "
            f"card's {total:.2f}; {a['seconds']:.1f} s with the init "
            f"[{card}]")
        log(f"  (a) {arch_id} launches (4 ranks) "
            + str({k: n for k, n in out['launches'][arch_id].items() if n})
            + "; by variant "
            + str({k: {v: n for v, n in per.items() if n}
                   for k, per in out["variants"][arch_id].items()
                   if any(per.values())}))
    for arch_id in VM_CHECK:
        b = [r["b"][arch_id] for r in res]
        c = [r["c"][arch_id] for r in res]
        log(f"  (b) {arch_id}: kernel route vs plain route (bf16, one "
            f"step) on the mesh: loss {b[0]['loss']:.6f} / "
            f"{b[0]['loss_plain']:.6f} ("
            + ", ".join(f"{x['loss_rel']:.3g}" for x in b)
            + f" relative, tol {MT_LOSS_TOL}), gradient norm "
            f"{b[0]['gnorm']:.5f} / {b[0]['gnorm_plain']:.5f} ("
            + ", ".join(f"{x['gnorm_rel']:.3g}" for x in b)
            + f", tol {MT_GNORM_TOL}); gradient blocks within "
            + ", ".join(f"{x['grad_err']:.3g} ({x['worst_leaf']})" for x in b)
            + f" of a leaf's largest (tol {MT_GRAD_TOL}); rank 0's "
            f"kernel-route step {b[0]['step_ms']:.0f} ms")
        for x in b:
            if not x["loss_rel"] <= MT_LOSS_TOL \
                    or not x["gnorm_rel"] <= MT_GNORM_TOL \
                    or x["grad_err"] > MT_GRAD_TOL:
                shown = {k: v for k, v in x.items()
                         if k not in ("launches", "variants")}
                raise AssertionError(f"(b) {arch_id}: {shown}")
            idle = [k for k in VM_KERNELS[arch_id] if x["launches"][k] <= 0]
            if idle:
                raise AssertionError(f"(b) {arch_id}: kernels not launched "
                                     f"{idle}")
            main_path_variants(x["variants"], VM_VARIANTS[arch_id])
        cc = vm_c_tol(arch_id, one, b, c)
        out["tol"][arch_id] = cc["tol"]
        log(f"  (c) {arch_id}: the mesh step vs the one-process step "
            f"({one[arch_id]['dtype']}): loss "
            + ", ".join(f"{x['loss_rel']:.3g}" for x in c) + ", gradient "
            "norm " + ", ".join(f"{x['gnorm_rel']:.3g}" for x in c)
            + " relative; gradient blocks within "
            + ", ".join(f"{x['grad_err']:.3g} ({x['worst_leaf']})" for x in c)
            + " of a leaf's largest; a row's loss within "
            + ", ".join(f"{x['nll_err']:.3g}" for x in c)
            + (" relative; BN statistics (the whole microbatch's) by "
               "microbatch " + ", ".join(
                   "/".join(f"{e:.3g}" for e in x["stats_err_by_mb"])
                   for x in c)
               if c[0]["stats_err"] is not None else " relative")
            + "; microbatch losses " + ", ".join(
                f"{m:.6f} / {w:.6f}" for m, w in zip(cc["mb_loss"],
                                                     cc["mb_loss_one"]))
            + f" (mesh / one process); tolerances {MT_C_FACTOR:g} x the "
            f"largest of (b), (b'), (b''), at least phase 29's: "
            f"{ {k: float(f'{v:.3g}') for k, v in cc['tol'].items()} }")
        tol = cc["tol"]
        for rank, x in enumerate(c):
            if x["loss_rel"] > tol["loss"] or x["gnorm_rel"] > tol["gnorm"] \
                    or x["grad_err"] > tol["grad"] \
                    or (x["stats_err"] or 0.0) > tol["stats"] \
                    or x["nll_err"] > tol["nll"]:
                shown = {k: v for k, v in x.items() if k != "nll"}
                raise AssertionError(f"(c) {arch_id} rank {rank}: {shown} "
                                     f"(tolerances {tol})")
        for k in VM_KERNELS[arch_id]:
            out["launches"][arch_id][k] += sum(x["launches"][k] for x in b)
            for v in out["variants"][arch_id][k]:
                out["variants"][arch_id][k][v] += sum(
                    x["variants"][k][v] for x in b)
        out["b"][arch_id] = [{k: v for k, v in x.items()
                              if k not in ("launches", "variants")}
                             for x in b]
        out["c"][arch_id] = [{k: v for k, v in x.items() if k != "nll"}
                             for x in c]
    for r in res:
        log(f"  rank {r['rank']}: (a) "
            + ", ".join(f"{a} {r['a'][a]['seconds']:.1f} s" for a in VM_RUNS)
            + ", (b) " + ", ".join(f"{a} {r['b'][a]['seconds']:.1f} s"
                                   for a in VM_CHECK)
            + ", (c) " + ", ".join(f"{a} {r['c'][a]['seconds']:.1f} s"
                                   for a in VM_CHECK)
            + (f", (e) {r['rows_s']:.1f} s" if "rows" in r else "")
            + f"; peak {r['peak_gib']:.2f} GiB")
    out["rows"] = res[0]["rows"]
    out["peak_gib"] = [r["peak_gib"] for r in res]
    out["seconds"] = time.perf_counter() - t_all
    log(f"  phase 31 {out['seconds']:.1f} s [{card}]")
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-csrc", default=None, help=(
        "a parent commit's src/repro_torch/kernels/csrc: its kernels are "
        "built too and timed beside these in phases 7, 13, 14, 19 and 24, "
        "and its K2 forward in phases 23 and 26"))
    cli = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))

    from repro_torch.configs import get_arch
    from repro_torch.core import layers as layers_mod
    from repro_torch.core.elastic import spec_to_static
    from repro_torch.core.types import SubnetSpec
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import elastic_matmul as em
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.core.layers import cast_params
    from repro_torch.models.vit import vit_apply, vit_init

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    t_all = time.perf_counter()
    phase("1. card")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(dev)}")
    # phase 23's P3 check runs under torch's default flags, before the
    # plain versions are held to fp32 for the rest of the run
    p3 = p3_check(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the plain versions' bf16 products accumulate in fp32, as the kernels
    # do (cuBLAS may otherwise reduce split-K partials in bf16: wgrad sums
    # 50,432 rows)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    phase("2. build kernels")
    logs = build.build(verbose=True)
    log(f"built {sorted(logs)} in {build.build_seconds:.1f} s (parallel nvcc)")
    for name, text in logs.items():
        entry = name
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '_ZN\d+_GLOBAL__N_\w+?"
                          r"_cu_[0-9a-f]{8}\d+(\w+?)E[vP]", line)
            if m:     # the kernel (and template arguments), still mangled
                entry = m.group(1)
            elif re.search(r"Used \d+ registers|spill|Performance Loss", line):
                log(f"  {entry}: {line.strip()}")

    parent = None
    if cli.parent_csrc:
        t_b = time.perf_counter()
        parent = parent_kernels(cli.parent_csrc)
        log(f"parent kernels from {cli.parent_csrc} built in "
            f"{time.perf_counter() - t_b:.1f} s")

    arch = get_arch("dynamic-ofa-supernet")
    cfg = arch.make_config()
    d, dff, H, Dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.d_model // cfg.n_heads
    M = BUCKET * cfg.n_tokens                       # 8 x 197 token rows
    M_patch = BUCKET * (cfg.n_tokens - 1)

    t0 = phase("3. K1 elastic_matmul vs plain at the serving shapes")
    # (label, rows, full weight (K, N), k_act, n_act, n_out): sliced mode
    # (n_out == n_act) at the widths the elastic space produces, and the TPU
    # op's shape (n_out == N) with zeros past n_act
    k1_cases = [
        ("patch", M_patch, (768, d), 768, d, d),
        ("qkv w1-h1", M, (d, d), d, d, d),
        ("wi full", M, (d, dff), d, dff, dff),
        ("wo full", M, (dff, d), dff, d, d),
        ("q w0.5-h0.5", M, (d, d), 192, 192, 192),
        ("q w0.75-h0.75", M, (d, d), 288, 256, 256),
        ("o h0.75-w0.75", M, (d, d), 256, 288, 288),
        ("wi w0.75-f0.75", M, (d, dff), 288, 1152, 1152),
        ("wo f0.25-w0.5", M, (dff, d), 384, 192, 192),
        ("head w0.5", BUCKET, (d, 1000), 192, 1000, 1000),
        ("tpu-shape 129x255", M, (d, dff), 129, 255, dff),
        ("tpu-shape 100x1000", M, (d, dff), 100, 1000, dff),
    ]
    k1_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for label, rows, (K, N), ka, na, n_out in k1_cases:
            w = randn(K, N, scale=K ** -0.5, dtype=dtype)
            x = randn(rows, K if n_out == N and n_out != na else ka,
                      dtype=dtype)
            y = ops.elastic_matmul_op(x, w, ka, na, n_out=n_out)
            with ops.plain_kernels():
                yp = ops.elastic_matmul_op(x, w, ka, na, n_out=n_out)
            torch.cuda.synchronize()
            err = close(y, yp, tol)
            if n_out > na and not bool((y[:, na:] == 0).all()):
                raise AssertionError(f"{label}: non-zero past n_act")
            k1_err = max(k1_err, err)
            log(f"  {str(dtype):15s} {label:20s} M={rows:5d} k={ka:4d} "
                f"n={na:4d}/{n_out:4d}  max abs err {err:.3g} (tol {tol})")
    # across the variant boundary (small_m up to M = 16, tma above in bf16,
    # tile in fp32 and where TMA cannot take the strides): (K, N) of the
    # full weight, k_act, n_act, n_out, x's width
    boundary = [
        ("sliced k%64", (d, dff), 200, 1000, 1000, 200),
        ("tpu-shape k%64", (d, dff), 136, 300, dff, d),
        ("width 129 (no TMA)", (d, dff), 129, 255, 255, 129),
        ("n_out > n_act", (d, dff), d, 1000, dff, d),
    ]
    variants = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for rows in (1, 4, 8, 16, 17, 64, 197, 1576, 2048):
            for label, (K, N), ka, na, n_out, xw in boundary:
                w = randn(K, N, scale=K ** -0.5, dtype=dtype)
                x = randn(rows, xw, dtype=dtype)
                before = dict(em.variant_launches)
                y = ops.elastic_matmul_op(x, w, ka, na, n_out=n_out)
                ran = [v for v, c in em.variant_launches.items()
                       if c != before[v]]
                with ops.plain_kernels():
                    yp = ops.elastic_matmul_op(x, w, ka, na, n_out=n_out)
                torch.cuda.synchronize()
                err = close(y, yp, tol)
                if n_out > na and not bool((y[:, na:] == 0).all()):
                    raise AssertionError(f"{label}: non-zero past n_act")
                k1_err = max(k1_err, err)
                key = (str(dtype).split(".")[1], ran[0])
                variants[key] = max(variants.get(key, 0.0), err)
    log("  M in (1, 4, 8, 16, 17, 64, 197, 1576, 2048) x " + ", ".join(
        b[0] for b in boundary) + ": max abs err by variant " + ", ".join(
        f"{dt} {v} {e:.3g}" for (dt, v), e in sorted(variants.items())))
    if {v for _, v in variants} != set(em.VARIANTS):
        raise AssertionError(f"not every K1 variant ran: {sorted(variants)}")
    # strided rows: the head reads h[:, 0] of the (B, N, d) tokens in place
    tok = randn(BUCKET, cfg.n_tokens, 192, dtype=torch.bfloat16)
    w = randn(d, 1000, scale=d ** -0.5, dtype=torch.bfloat16)
    y = ops.elastic_matmul_op(tok[:, 0], w, 192, 1000, n_out=1000)
    with ops.plain_kernels():
        yp = ops.elastic_matmul_op(tok[:, 0], w, 192, 1000, n_out=1000)
    k1_err = max(k1_err, close(y, yp, TOL["bfloat16"]))
    # f32_splitk at the fp32 MoE router's prefill shape (M = 2048 tokens,
    # K = d_model 2048, E = 64 experts, n_act 64 or 32 at the half-expert
    # points) and around it: M from just past small_m's 16 rows to 2048,
    # n_act from 1 to 64 (a live tile cut short, zeros past it); each call
    # one launch of f32_splitk, zeros past n_act exact, the same bits twice
    # and under 3 CUDA-graph replays (the fused split-K reduce adds the
    # partials in split order and resets its tickets)
    router_err = 0.0
    w_r = randn(2048, 64, scale=2048 ** -0.5)
    for rows in (17, 64, 129, 2048):
        x_r = randn(rows, 2048)
        for na in (64, 63, 32, 1):
            before = em.variant_launches["f32_splitk"]
            want = k1_plain(x_r, w_r, 2048, na, 64)
            err = repeatable(lambda: ops.elastic_matmul_op(
                x_r, w_r, 2048, na, n_out=64), want, TOL["float32"],
                f"f32_splitk M={rows} n_act={na}")
            y = ops.elastic_matmul_op(x_r, w_r, 2048, na, n_out=64)
            torch.cuda.synchronize()
            if not bool((y[:, na:] == 0).all()):
                raise AssertionError(f"f32_splitk M={rows}: non-zero past "
                                     f"n_act {na}")
            # twice eager, once captured (3 replays), once for the zeros
            if em.variant_launches["f32_splitk"] - before != 4:
                raise AssertionError(f"f32_splitk M={rows} n_act={na}: "
                                     f"took another variant")
            router_err = max(router_err, err)
    k1_err = max(k1_err, router_err)
    log(f"  f32_splitk at the router's shape (K 2048, n_out 64), M in (17, "
        f"64, 129, 2048) x n_act in (64, 63, 32, 1): max abs err "
        f"{router_err:.3g} (tol {TOL['float32']}), zeros past n_act exact, "
        f"bit for bit twice and under 3 graph replays (plan at M = 2048: "
        f"splits, rows of K "
        f"{em.f32_splitk_plan(2048, 2048, 64)})")
    log(f"  strided head rows ok; K1 max abs err {k1_err:.3g} "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = phase("4. K2 flash_attention vs plain (S = T = 197, D = 64; "
               "smoke shapes)")
    k2_err = 0.0
    S = cfg.n_tokens
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        # (B, S, H, KH, D, causal); the last two are the smoke configs'
        # shapes (ofa smoke: 17 tokens, D 16; deit smoke: 18 tokens, D 8)
        for B, S_, H_, KH, D_, causal in [
                (1, S, H, H, Dh, False), (BUCKET, S, H, H, Dh, False),
                (1, S, H, H, Dh, True), (BUCKET, S, H, H, Dh, True),
                (BUCKET, S, H, 2, Dh, False), (BUCKET, 17, 4, 4, 16, False),
                (BUCKET, 18, 4, 4, 8, False)]:
            # q read in place from a fused (B, S, 2H, D) buffer: strided
            qbuf = randn(B, S_, 2 * H_, D_, scale=0.3, dtype=dtype)
            q = qbuf[:, :, :H_]
            k = randn(B, S_, KH, D_, scale=0.3, dtype=dtype)
            v = randn(B, S_, KH, D_, dtype=dtype)
            before = dict(fa.variant_launches)
            o = ops.flash_attention_op(q, k, v, causal=causal)
            ran = [n for n, c in fa.variant_launches.items()
                   if c != before[n]]
            with ops.plain_kernels():
                op_ = ops.flash_attention_op(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = close(o, op_, tol)
            k2_err = max(k2_err, err)
            log(f"  {str(dtype):15s} {ran[0]:8s} BH={B * H_:3d} KH={KH} "
                f"S={S_:3d} D={D_:2d} causal={causal!s:5s}  max abs err "
                f"{err:.3g} (tol {tol})")
    # the ragged edge at T = 577 (ViT-L at 336 px), and decode (S = 1)
    # against T = 1 .. 528 with GQA R = 2 at both head dims
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        cases = [(2, 577, 577, 4, 4, 64, c) for c in (False, True)] + [
            (2, 1, T, 16, 8, D_, c) for T in (1, 63, 64, 65, 300, 528)
            for D_ in (64, 128) for c in (False, True)]
        for B, S_, T, H_, KH, D_, causal in cases:
            q = randn(B, S_, H_, D_, scale=0.3, dtype=dtype)
            k = randn(B, T, KH, D_, scale=0.3, dtype=dtype)
            v = randn(B, T, KH, D_, dtype=dtype)
            before = dict(fa.variant_launches)
            o = ops.flash_attention_op(q, k, v, causal=causal)
            ran = [n for n, c in fa.variant_launches.items()
                   if c != before[n]]
            with ops.plain_kernels():
                op_ = ops.flash_attention_op(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = close(o, op_, tol)
            k2_err = max(k2_err, err)
            if S_ > 1 or T in (1, 528):
                log(f"  {str(dtype):15s} {ran[0]:8s} BH={B * H_:3d} KH={KH} "
                    f"S={S_:3d} T={T:3d} D={D_:3d} causal={causal!s:5s}  max "
                    f"abs err {err:.3g} (tol {tol})")
    log(f"  decode T in (1, 63, 64, 65, 300, 528) x D (64, 128) x causal "
        f"within tolerance; K2 max abs err {k2_err:.3g} "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = phase("5. full-config logits: kernel path vs plain path on the card")
    dims = {"d_model": d, "d_ff": dff, "n_heads": H,
            "n_layers": cfg.n_layers}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = vit_init(torch.Generator().manual_seed(1), cfg32, device=dev)
    p16 = cast_params(p32, torch.bfloat16)
    imgs = randn(2, cfg.img_res, cfg.img_res, 3)
    mid = SubnetSpec(width_mult=0.75, ffn_mult=0.5, heads_mult=0.75,
                     depth_mult=2.0 / 3.0)
    with torch.inference_mode():
        for name, spec in [("max", cfg.elastic.max_spec()),
                           ("min", cfg.elastic.min_spec()), ("mid", mid)]:
            E = spec_to_static(spec, dims)
            yk, _ = vit_apply(p32, imgs, cfg32, E=E)
            with ops.plain_kernels():
                yp, _ = vit_apply(p32, imgs, cfg32, E=E)
            err32 = close(yk, yp, LOGITS_FP32_TOL)
            yk16, _ = vit_apply(p16, imgs, cfg, E=E)
            with ops.plain_kernels():
                yp16, _ = vit_apply(p16, imgs, cfg, E=E)
            if not torch.isfinite(yk16).all():
                raise AssertionError("non-finite bf16 logits")
            err16 = float((yk16.float() - yp16.float()).abs().max())
            top1 = float((yk16.argmax(-1) == yp16.argmax(-1)).float().mean())
            log(f"  {name} {spec.name():28s} fp32 max abs err {err32:.3g} "
                f"(tol {LOGITS_FP32_TOL}); bf16 max abs err {err16:.3g}, "
                f"top-1 agreement {top1:.2f}")
    del p32          # p16 serves phase 7's recorded forward
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    t0 = phase("6. main path: full-width server, LUT, governors, 64 requests")
    ops.reset_launch_counts()
    server = serve.build_server(arch, cfg, max_batch=BUCKET, device="cuda")
    x = torch.randn((BUCKET, cfg.img_res, cfg.img_res, 3),
                    generator=torch.Generator().manual_seed(2)).numpy()
    specs, governors, base_ms = serve.profile(server, cfg, x)
    server.warm(specs, example_input=x[0])
    before = (em.launches, fa.launches)
    outs = serve.serve_requests(server, governors["joint (paper)"], base_ms,
                                x[0], N_REQUESTS)
    launches = {"elastic_matmul": em.launches,
                "flash_attention": fa.launches}
    vit_variants = ops.variant_counts()
    serving = (em.launches - before[0], fa.launches - before[1])
    answered = [o for o in outs if not o.get("cancelled")]
    if len(answered) != N_REQUESTS:
        raise AssertionError(f"{N_REQUESTS - len(answered)} requests not "
                             f"answered")
    if server.cold_compiles != 0:
        raise AssertionError(f"cold compiles {server.cold_compiles}")
    if min(serving) <= 0:
        raise AssertionError(f"kernels not launched while serving: {serving}")
    by_name = {s.name(): s for s in specs}
    o = answered[-1]
    y = torch.from_numpy(o["y"])
    direct = server.infer(x[:1], by_name[o["subnet"]])[0].float().cpu()
    if y.shape != (1000,) or not torch.isfinite(y).all():
        raise AssertionError(f"bad served logits {tuple(y.shape)}")
    err_served = close(y, direct, 3e-2)
    log(f"  launches on the main path: {launches}; while serving: "
        f"elastic_matmul {serving[0]}, flash_attention {serving[1]}")
    log(f"  by variant: {vit_variants}")
    main_path_variants(vit_variants, need={
        ("elastic_matmul", "small_m"), ("elastic_matmul", "tma"),
        ("flash_attention", "wgmma")})
    log(f"  served logits vs direct forward of {o['subnet']}: max abs err "
        f"{err_served:.3g}; cold compiles {server.cold_compiles}")
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    t0 = phase("7. kernel times over one full-width forward at bucket 8 "
               "(bf16; the forward's own calls, graph-replayed device time)")
    E_max = spec_to_static(cfg.elastic.max_spec(), dims)
    imgs8 = randn(BUCKET, cfg.img_res, cfg.img_res, 3)
    vcalls = {"k1": [], "k2": []}
    with torch.inference_mode(), recording(
            [(layers_mod, "elastic_matmul_op", "k1"),
             (layers_mod, "flash_attention_op", "k2")],
            lambda key, args, kw: vcalls[key].append((args, kw))):
        vit_apply(p16, imgs8, cfg, E=E_max)
    vit_k1 = time_rows("K1 ViT forward", vcalls["k1"], ops.elastic_matmul_op,
                       k1_plain, k1_library, "torch.matmul", k1_work,
                       parent and (parent["k1"], parent["libs"]),
                       group=k1_group)
    vit_k2 = time_rows("K2 ViT forward", vcalls["k2"],
                       ops.flash_attention_op, k2_plain, k2_library, "sdpa",
                       k2_work, parent and (parent["k2"], parent["libs"]))
    del vcalls, p16
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    lm = lm_phases(dev, parent)
    tr = train_phases(dev, parent)
    tp = trace_phase(serve, arch, cfg, server, governors["joint (paper)"].lut,
                     x, base_ms, os.path.join(os.path.dirname(
                         os.path.abspath(__file__)), "build", "trace"))
    vc = vit_compiled(tp.pop("servers"), specs, governors["joint (paper)"].lut,
                      x, cfg, dims)
    cv = conv_phases(dev, randn)
    df = diffusion_phases(dev, parent)
    lt = lm_train_phases(dev, parent)
    lt_n, lt_v = lt["run"]["launches"], lt["run"]["variants"]
    cl = cluster_phases(serve, arch, cfg, server,
                        governors["joint (paper)"].lut, x, base_ms, card,
                        os.path.join(os.path.dirname(os.path.abspath(
                            __file__)), "build", "cluster"))
    lc = lm_configs_phases(dev, card, parent)
    wg = wgmma_phases(dev, card)
    mh = mesh_phases(dev, card)
    mt = mesh_train_phases(dev, card)
    mt_n, mt_v = mt["launches"], mt["variants"]
    tc = train_configs_phases(dev, card)
    vm = vision_mesh_phases(dev, card)
    lc_cfg = lc["configs"]

    def lc_rows(k: str) -> dict:
        # phase 26 (e): a kernel's rows at each config's prefill and decode
        return {c: {st: r["times"][f"{k}_{st}"] for st in ("prefill",
                                                            "decode")}
                for c, r in lc_cfg.items() if f"{k}_prefill" in r["times"]}

    def lc_launches(name: str) -> dict:
        return {c: r["launches"][name] for c, r in lc_cfg.items()}

    def conv_recorded(name: str) -> dict:
        # phase 22 (f): the worst errors at the recorded steps' calls
        return {n: {k: cv["recorded"][n][name][k] for k in ("abs",
                                                             "of_largest")}
                for n in ("resnet", "effnet")}

    def row_keys(vit: dict) -> dict:
        # the contract's numbers from the ViT forward's row; the LM rows
        # beside them carry the same keys
        return {k: vit.get(k) for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}

    timing = ("graph-replayed device time (CUDA graph of the recorded "
              "calls, replayed between events); eager_ms is the eager "
              "loop with host launch cost")
    record = {"kernels": [
        dict({"name": "elastic_matmul", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/elastic_matmul.cu",
              "replaces": "src/repro/kernels/elastic_matmul.py:68",
              "launches": launches["elastic_matmul"]
              + lm["launches"]["elastic_matmul"]
              + tr["launches"]["elastic_matmul"]
              + tp["launches"]["elastic_matmul"]
              + cv["resnet"]["launches"]["elastic_matmul"]
              + cv["effnet"]["launches"]["elastic_matmul"]
              + df["dit"]["launches"]["elastic_matmul"]
              + df["unet"]["launches"]["elastic_matmul"]
              + lt_n["elastic_matmul"]
              + cl["launches"]["elastic_matmul"]
              + sum(lc_launches("elastic_matmul").values())
              + mh["launches"]["elastic_matmul"]
              + mt_n["elastic_matmul"],
              "launches_by_path": {"vit_serve": launches["elastic_matmul"],
                                   "lm": lm["launches"]["elastic_matmul"],
                                   "train": tr["launches"]["elastic_matmul"],
                                   "vit_trace":
                                       tp["launches"]["elastic_matmul"],
                                   "resnet_train": cv["resnet"]["launches"][
                                       "elastic_matmul"],
                                   "effnet_train": cv["effnet"]["launches"][
                                       "elastic_matmul"],
                                   "dit_train": df["dit"]["launches"][
                                       "elastic_matmul"],
                                   "unet_train": df["unet"]["launches"][
                                       "elastic_matmul"],
                                   "lm_train": lt_n["elastic_matmul"],
                                   "vit_cluster":
                                       cl["launches"]["elastic_matmul"],
                                   "lm_configs":
                                       lc_launches("elastic_matmul"),
                                   "lm_mesh":
                                       mh["launches"]["elastic_matmul"],
                                   "lm_mesh_train":
                                       mt_n["elastic_matmul"]},
              "launches_by_variant": {
                  "vit_serve": vit_variants["elastic_matmul"],
                  "lm": lm["variants"]["elastic_matmul"],
                  "train": tr["variants"]["elastic_matmul"],
                  "vit_trace": tp["variants"]["elastic_matmul"],
                  "resnet_train": cv["resnet"]["variants"]["elastic_matmul"],
                  "effnet_train": cv["effnet"]["variants"]["elastic_matmul"],
                  "dit_train": df["dit"]["variants"]["elastic_matmul"],
                  "unet_train": df["unet"]["variants"]["elastic_matmul"],
                  "lm_train": lt_v["elastic_matmul"],
                  "vit_cluster": cl["variants"]["elastic_matmul"],
                  "lm_configs": {c: r["variants"]["elastic_matmul"]
                                 for c, r in lc_cfg.items()},
                  "lm_mesh": mh["variants"]["elastic_matmul"],
                  "lm_mesh_train": mt_v["elastic_matmul"]},
              "max_abs_err": max(k1_err, tr["k1_train_fwd_err"],
                                 cv["k1"]["err"][("elastic_matmul",
                                                  "bfloat16")],
                                 *(cv["recorded"][n]["elastic_matmul"]["abs"]
                                   for n in ("resnet", "effnet")),
                                 *(df["recorded"][n]["k1"]["elastic_matmul"][
                                     "abs"] for n in ("dit", "unet")))},
             **row_keys(vit_k1),
             timing=timing, vit_forward=vit_k1,
             lm_prefill=lm["k1_prefill"], lm_decode=lm["k1_decode"],
             lm_router_prefill=lm["k1_router"],
             train_step=tr["k1_train_fwd"],
             resnet_step=cv["rows"]["resnet_fwd"],
             effnet_se=cv["rows"]["effnet_se_fwd"],
             conv_recorded=conv_recorded("elastic_matmul"),
             dit_step=df["rows"]["dit"]["fwd"],
             unet_step=df["rows"]["unet"]["fwd"],
             lm_step=lt["rows"]["k1_fwd"],
             lm_configs=lc_rows("k1"),
             lm_mesh_train=mt["rows"]["k1_fwd"]),
        dict({"name": "flash_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention.py:71",
              "launches": launches["flash_attention"]
              + lm["launches"]["flash_attention"]
              + tr["launches"]["flash_attention"]
              + tp["launches"]["flash_attention"]
              + df["dit"]["launches"]["flash_attention"]
              + df["unet"]["launches"]["flash_attention"]
              + lt_n["flash_attention"]
              + cl["launches"]["flash_attention"]
              + sum(lc_launches("flash_attention").values())
              + mh["launches"]["flash_attention"]
              + mt_n["flash_attention"],
              "launches_by_path": {"vit_serve": launches["flash_attention"],
                                   "lm": lm["launches"]["flash_attention"],
                                   "train": tr["launches"]["flash_attention"],
                                   "vit_trace":
                                       tp["launches"]["flash_attention"],
                                   "dit_train": df["dit"]["launches"][
                                       "flash_attention"],
                                   "unet_train": df["unet"]["launches"][
                                       "flash_attention"],
                                   "lm_train": lt_n["flash_attention"],
                                   "vit_cluster":
                                       cl["launches"]["flash_attention"],
                                   "lm_configs":
                                       lc_launches("flash_attention"),
                                   "lm_mesh":
                                       mh["launches"]["flash_attention"],
                                   "lm_mesh_train":
                                       mt_n["flash_attention"]},
              "launches_by_variant": {
                  "vit_serve": vit_variants["flash_attention"],
                  "lm": lm["variants"]["flash_attention"],
                  "train": tr["variants"]["flash_attention"],
                  "vit_trace": tp["variants"]["flash_attention"],
                  "dit_train": df["dit"]["variants"]["flash_attention"],
                  "unet_train": df["unet"]["variants"]["flash_attention"],
                  "lm_train": lt_v["flash_attention"],
                  "vit_cluster": cl["variants"]["flash_attention"],
                  "lm_configs": {c: r["variants"]["flash_attention"]
                                 for c, r in lc_cfg.items()},
                  "lm_mesh": mh["variants"]["flash_attention"],
                  "lm_mesh_train": mt_v["flash_attention"]},
              "variants": list(fa.VARIANTS),
              "max_abs_err": max(k2_err, lm["k2_err"], tr["k2_fwd_err"],
                                 lc["k2"]["max_abs_err"],
                                 wg["cases"]["max_abs_err"],
                                 mh["k2"]["o_err"], mh["k2"]["merge_err"],
                                 *(df["recorded"][n]["k2"][k]["err"]
                                   for n in ("dit", "unet")
                                   for k in ("k2", "k2x")
                                   if k in df["recorded"][n]["k2"]))},
             **row_keys(vit_k2),
             timing=timing, vit_forward=vit_k2,
             lm_prefill=lm["k2_prefill"], lm_decode=lm["k2_decode"],
             train_step=tr["k2_train_fwd"],
             dit_step=df["rows"]["dit"]["k2"],
             unet_step=df["rows"]["unet"]["k2"],
             unet_cross=df["rows"]["unet"]["k2x"],
             gen=df["sample"], lm_step=lt["rows"]["k2_fwd"],
             lm_configs=lc_rows("k2"), wgmma_cases=wg["cases"]["errs"],
             route=wg["route"], lm_mesh_decode=mh["k2_row"],
             lm_mesh_decode_lse_err=mh["k2"]["lse_err"],
             lm_mesh_train=mt["rows"]["k2_fwd"]),
        dict({"name": "expert_matmul", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/expert_matmul.cu",
              "replaces": "src/repro/kernels/expert_matmul.py:48",
              "launches": lm["launches"]["expert_matmul"]
              + lt_n["expert_matmul"]
              + sum(lc_launches("expert_matmul").values())
              + mh["launches"]["expert_matmul"]
              + mt_n["expert_matmul"],
              "launches_by_path": {"lm": lm["launches"]["expert_matmul"],
                                   "lm_train": lt_n["expert_matmul"],
                                   "lm_configs":
                                       lc_launches("expert_matmul"),
                                   "lm_mesh":
                                       mh["launches"]["expert_matmul"],
                                   "lm_mesh_train":
                                       mt_n["expert_matmul"]},
              "launches_by_variant": {
                  "lm": lm["variants"]["expert_matmul"],
                  "lm_by_stage": lm["k3_by_stage"],
                  "lm_train": lt_v["expert_matmul"],
                  "lm_configs": {c: r["variants"]["expert_matmul"]
                                 for c, r in lc_cfg.items()},
                  "lm_configs_by_stage": {c: r["k3_by_stage"]
                                          for c, r in lc_cfg.items()
                                          if r["k3_by_stage"]},
                  "lm_mesh": mh["variants"]["expert_matmul"],
                  "lm_mesh_train": mt_v["expert_matmul"]},
              "max_abs_err": max(lm["k3_err"], mh["k3_err"])},
             **row_keys(lm["k3_prefill"]),
             timing=timing, lm_prefill=lm["k3_prefill"],
             lm_decode=lm["k3_decode"], kept_share=lm["kept"],
             lm_step=lt["rows"]["k3_fwd"], lm_configs=lc_rows("k3"),
             lm_a2a=mh["k3_row"], lm_mesh_train=mt["rows"]["k3_fwd"]),
    ]}
    for name, src, replaces, row, err, conv in (
            ("elastic_matmul_dgrad", "elastic_matmul.cu",
             "elastic_matmul.py:68", tr["k1_dgrad"], tr["k1_bwd_err"]["dgrad"],
             "dgrad"),
            ("elastic_matmul_wgrad", "elastic_matmul.cu",
             "elastic_matmul.py:68", tr["k1_wgrad"], tr["k1_bwd_err"]["wgrad"],
             "wgrad"),
            ("flash_attention_bwd", "flash_attention.cu",
             "flash_attention.py:71", tr["k2_bwd"], tr["k2_bwd_err"], None)):
        entry = dict(
            {"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{src}",
             "replaces": f"src/repro/kernels/{replaces}",
             "replaces_note": "its gradient: the reference has no backward "
                              "kernel (JAX differentiates through XLA)",
             "launches": tr["launches"][name],
             "launches_by_path": {"train": tr["launches"][name]},
             "launches_by_variant": {"train": tr["variants"][name]},
             "max_abs_err": err}, **row_keys(row), timing=timing,
            train_step=row)
        if conv:
            for path, key in (("resnet_train", "resnet"),
                              ("effnet_train", "effnet")):
                n = cv[key]["launches"][name]
                entry["launches"] += n
                entry["launches_by_path"][path] = n
                entry["launches_by_variant"][path] = cv[key]["variants"][name]
            # phase 22 (a) in bf16: dgrad's max abs error, wgrad's of the
            # largest value (sums over 802,816 rows of unit inputs); and
            # phase 22 (f)'s, at the recorded steps' calls
            cerr = cv["k1"]["err"][(name, "bfloat16")]
            rerr = conv_recorded(name)
            if conv == "dgrad":
                entry["max_abs_err"] = max(err, cerr, *(
                    r["abs"] for r in rerr.values()))
            else:
                entry["conv_err_of_largest"] = max(cerr, *(
                    r["of_largest"] for r in rerr.values()))
            entry["conv_recorded"] = rerr
            entry["resnet_step"] = cv["rows"][f"resnet_{conv}"]
            entry["effnet_se"] = cv["rows"][f"effnet_se_{conv}"]
            entry["lm_step"] = lt["rows"][f"k1_{conv}"]
        # phase 23: the diffusion steps' launches, errors and rows
        row = conv or "k2_bwd"
        for path, key in (("dit_train", "dit"), ("unet_train", "unet")):
            n = df[key]["launches"][name]
            entry["launches"] += n
            entry["launches_by_path"][path] = n
            entry["launches_by_variant"][path] = df[key]["variants"][name]
            entry[f"{key}_step"] = df["rows"][key][row]
        if conv:
            rerr = [df["recorded"][n]["k1"][name] for n in ("dit", "unet")]
            if conv == "dgrad":
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           *(r["abs"] for r in rerr))
            entry["diffusion_err_of_largest"] = max(r["of_largest"]
                                                    for r in rerr)
        else:
            entry["unet_cross"] = df["rows"]["unet"]["k2x_bwd"]
            entry["diffusion_err_of_largest"] = max(
                df["recorded"][n]["k2"][k]["err"] for n in ("dit", "unet")
                for k in ("k2_bwd", "k2x_bwd")
                if k in df["recorded"][n]["k2"])
            entry["max_abs_err_fp32_d8_d16"] = df["k2_small_d_err"]
            # phase 24: causal and D = 128, random and at the LM step
            errs = list(lt["k2_cases"].values()) + [
                lt["recorded"]["flash_attention_bwd"]]
            entry["lm_err_of_largest"] = max(e[1] for e in errs)
            entry["lm_max_abs_err"] = max(e[0] for e in errs)
            entry["lm_step"] = lt["rows"]["k2_bwd"]
        # phase 24: the LM step's launches; phase 29: the mesh step's
        entry["launches"] += lt_n[name] + mt_n[name]
        entry["launches_by_path"]["lm_train"] = lt_n[name]
        entry["launches_by_variant"]["lm_train"] = lt_v[name]
        entry["launches_by_path"]["lm_mesh_train"] = mt_n[name]
        entry["launches_by_variant"]["lm_mesh_train"] = mt_v[name]
        entry["lm_mesh_train"] = mt["rows"][
            {"dgrad": "k1_dgrad", "wgrad": "k1_wgrad"}.get(conv, "k2_bwd")]
        record["kernels"].append(entry)
    for name, kind in (("expert_matmul_dgrad", "dgrad"),
                       ("expert_matmul_wgrad", "wgrad")):
        row = lt["rows"][f"k3_{kind}"]
        errs = [e for (_, k, _), e in lt["k3_cases"].items()
                if k == kind] + [lt["recorded"][name]]
        record["kernels"].append(dict(
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/expert_matmul.cu",
             "replaces": "src/repro/kernels/expert_matmul.py:48",
             "replaces_note": "its gradient: the reference has no backward "
                              "kernel (JAX differentiates through XLA)",
             "launches": lt_n[name] + mt_n[name],
             "launches_by_path": {"lm_train": lt_n[name],
                                  "lm_mesh_train": mt_n[name]},
             "launches_by_variant": {"lm_train": lt_v[name],
                                     "lm_mesh_train": mt_v[name]},
             "max_abs_err": max(e[0] for e in errs),
             "err_of_largest": max(e[1] for e in errs)},
            **row_keys(row), timing=timing, lm_step=row,
            lm_mesh_train=mt["rows"][f"k3_{kind}"],
            **({"lm_sliced": lt["rows"]["k3_dgrad_sliced"]}
               if kind == "dgrad" else {})))
    # phase 30: the three configs' training (b) and their mesh steps (d),
    # launches by path and variant; its rows beside each kernel's
    tc_rows = {
        "elastic_matmul": {f"{a}_train_step": r["rows"]["k1_fwd"]
                           for a, r in tc["b"].items()},
        "elastic_matmul_dgrad": {f"{a}_train_step": r["rows"]["k1_dgrad"]
                                 for a, r in tc["b"].items()},
        "elastic_matmul_wgrad": {f"{a}_train_step": r["rows"]["k1_wgrad"]
                                 for a, r in tc["b"].items()},
        "flash_attention": {"kimi_train_d112": tc["a"]["rows"]["k2_fwd"]},
        "flash_attention_bwd": {"kimi_train_d112":
                                tc["a"]["rows"]["k2_bwd"]},
        "expert_matmul": {"kimi_moe_train": tc["c"]["rows"]["k3_fwd"]},
        "expert_matmul_dgrad": {"kimi_moe_train":
                                tc["c"]["rows"]["k3_dgrad"]},
        "expert_matmul_wgrad": {"kimi_moe_train":
                                tc["c"]["rows"]["k3_wgrad"]}}
    tc_errs = {
        "elastic_matmul": max(r["k1_checks"]["elastic_matmul"]["abs"]
                              for r in tc["b"].values()),
        "elastic_matmul_dgrad": max(
            r["k1_checks"]["elastic_matmul_dgrad"]["abs"]
            for r in tc["b"].values()),
        "flash_attention": tc["a"]["fwd_err"],
        "flash_attention_bwd": tc["a"]["bwd_err"][0],
        "expert_matmul": tc["c"]["errs"]["expert_matmul"][0],
        "expert_matmul_dgrad": tc["c"]["errs"]["expert_matmul_dgrad"][0],
        "expert_matmul_wgrad": tc["c"]["errs"]["expert_matmul_wgrad"][0]}
    for entry in record["kernels"]:
        name = entry["name"]
        n_b, n_d = tc["launches"][name], tc["mesh_launches"][name]
        entry["launches"] += n_b + n_d
        entry["launches_by_path"]["lm_configs_train"] = n_b
        entry["launches_by_path"]["lm_configs_mesh_train"] = n_d
        entry["launches_by_variant"]["lm_configs_train"] = \
            tc["variants"][name]
        entry["launches_by_variant"]["lm_configs_mesh_train"] = \
            tc["mesh_variants"][name]
        entry.update(tc_rows[name])
        if name in tc_errs:
            entry["max_abs_err"] = max(entry["max_abs_err"], tc_errs[name])
        if name == "elastic_matmul_wgrad":
            entry["lm_configs_err_of_largest"] = max(
                r["k1_checks"][name]["of_largest"] for r in tc["b"].values())
    # phase 31: the vision mesh steps' launches by net and variant, and
    # rank 0's rows at their calls
    vm_rows = {"elastic_matmul": "k1_fwd", "elastic_matmul_dgrad": "k1_dgrad",
               "elastic_matmul_wgrad": "k1_wgrad", "flash_attention": "k2_fwd",
               "flash_attention_bwd": "k2_bwd"}
    for entry in record["kernels"]:
        name = entry["name"]
        n = sum(per.get(name, 0) for per in vm["launches"].values())
        entry["launches"] += n
        entry["launches_by_path"]["vision_mesh_train"] = n
        entry["launches_by_variant"]["vision_mesh_train"] = {
            a: per[name] for a, per in vm["variants"].items() if name in per}
        if name in vm_rows:
            entry["vision_mesh_train"] = vm["rows"][vm_rows[name]]
    log("trace: " + json.dumps({k: tp[k] for k in (
        "classes", "trace_variants", "decomposition", "replay",
        "lut_spread_ms", "served_err", "seconds")}))
    log("compiled: " + json.dumps({
        "vit": {k: vc[k] for k in ("lut_ms", "rank_corr", "captures",
                                   "pool_mib")},
        "lm": {k: lm["compiled"][k] for k in (
            "k2_decode", "rows", "eager_peak_gib", "graph_peak_gib",
            "graph_pool_gib")}}))
    log("train: " + json.dumps({k: tr.get(k) for k in (
        "step_ms", "step_ms_all", "peak_gib", "peak_run_gib", "losses",
        "fp32_step", "step_breakdown", "step_e2e")}))
    log("conv: " + json.dumps({
        "logits": cv["logits"], "breakdown": cv["breakdown"],
        **{k: {kk: cv[k][kk] for kk in ("params", "step_ms", "step_ms_all",
                                         "losses", "images_per_s",
                                         "peak_gib", "peak_run_gib")}
           for k in ("resnet", "effnet")}}))
    log("diffusion: " + json.dumps({
        "p3": p3, "outputs": df["outputs"], "breakdown": df["breakdown"],
        "sample": df["sample"],
        **{k: {kk: df[k][kk] for kk in ("params", "step_ms", "step_ms_all",
                                         "losses", "resumed_loss_diff",
                                         "images_per_s", "peak_gib",
                                         "peak_run_gib")}
           for k in ("dit", "unet")}}))
    log("lm_train: " + json.dumps({
        "smoke": lt["smoke"], "profile": lt["profile"],
        "k2_cases": {f"{dt} D{D} causal={c}": e for (dt, D, c), e in
                     lt["k2_cases"].items()},
        "k3_cases": {" ".join(k): e for k, e in lt["k3_cases"].items()},
        "recorded": lt["recorded"],
        "variants": {k: {v: n for v, n in lt_v[k].items() if n}
                     for k in ("flash_attention_bwd", "expert_matmul_dgrad",
                               "expert_matmul_wgrad")},
        "microbatch_ms": {k: {kk: r.get(kk) for kk in (
            "ms", "parent_ms", "library_ms", "bound_ms")}
            for k, r in lt["rows"].items()},
        "microbatch_calls": lt["row_launches"],
        **{k: lt["run"][k] for k in ("params", "step_ms", "step_ms_all",
                                     "losses", "tokens_per_s", "peak_gib",
                                     "peak_run_gib")}}))
    log("cluster: " + json.dumps({k: cl[k] for k in (
        "a", "b", "replica", "health_interval_s", "memory_mib",
        "seconds")}))
    log("lm_configs: " + json.dumps({
        "k2": lc["k2"], "seconds": lc["seconds"],
        **{c: {k: r[k] for k in ("arch", "layers", "params", "kept",
                                 "graph_decode_rel_err", "peak_gib",
                                 "graph_pool_gib", "logits", "seconds",
                                 "points")}
           for c, r in lc_cfg.items()}}))
    log("wgmma: " + json.dumps({
        "cases": wg["cases"], "seconds": wg["seconds"],
        "route_min_s": fa.WGMMA_FWD_MIN_S,
        "route": {k: {kk: r[kk] for kk in ("wgmma_ms", "mma_ms",
                                            "library_ms", "bound_ms",
                                            "route")}
                  for k, r in wg["route"].items()}}))
    log("mesh: " + json.dumps({
        k: mh[k] for k in ("a_err", "b_err", "ranks", "ranks_s", "seconds")}
        | {"k2": mh["k2"]}))
    log("mesh_train: " + json.dumps({
        k: mt[k] for k in ("a", "b", "c", "c_tol", "d", "one", "peak_gib",
                           "ranks_s", "seconds")}
        | {"rows": {k: {kk: r.get(kk) for kk in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "launches")} for k, r in mt["rows"].items()}}))
    log("train_configs: " + json.dumps({
        "a": {k: tc["a"][k] for k in ("fwd_err", "bwd_err", "seconds")},
        "b": {a: {k: v for k, v in r.items() if k not in ("rows",
                                                          "k1_checks")}
              for a, r in tc["b"].items()},
        "c": {k: tc["c"][k] for k in ("E", "slab", "live_rows",
                                      "dead_experts", "errs", "seconds")},
        "d": {k: tc["d"][k] for k in ("one", "tol", *TC_MESH_ARCHS,
                                      "seconds")},
        "rows": {f"{n}/{k}": {kk: r.get(kk) for kk in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "launches")} for n, rows in tc_rows.items()
            for k, r in rows.items()},
        "seconds": tc["seconds"]}))
    log("vision_mesh: " + json.dumps({
        k: vm[k] for k in ("a", "b", "c", "tol", "one", "peak_gib",
                           "ranks_s", "seconds")}
        | {"rows": {k: {kk: r.get(kk) for kk in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "launches")} for k, r in vm["rows"].items()}}))
    end = time.perf_counter()
    log(f"\ncard: {card}; total {end - t_all:.1f} s")
    log("phases_s: " + json.dumps(phases_s(end)))
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
