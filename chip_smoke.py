#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (alignq_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
 1. the card's name and power limit; TF32 off for matmul and cuDNN;
 2. build the CUDA kernels from alignq_tpu_torch/csrc (qmatmul.cu,
    qmatmul_sm90.cu, qmatmul_sm90n.cu, qmatmul_sm90p.cu, quantize.cu,
    stage_kernel.cu, stage_kernel_sm90.cu, dwconv.cu, stem_sm90.cu,
    dwconv_sm90.cu, bn_table_sm90.cu, digit_sm90.cu, first_conv_sm90.cu,
    cdf_quant_sm90.cu: one nvcc each, all started together);
    (b) the table form of the act-code map (csrc/act_codes.cuh table_code,
    kernels/quantize.py act_table) against its direct map on the card,
    over all 2^32 f32 bit patterns, for the erf and poly maps at each
    served grid (TABLE_GRIDS: 127, 7, 1), relu'd and not, and K2's map
    (grid 127, its table built on the card from csrc/quantize.cu's direct
    kernel): zero differences, the count checked printed;
 3. K1 (csrc/qmatmul.cu) against its plain version. Its GEMM form at the
    path's gathered-matrix shapes of batches 2048 and 256, plus a ragged M
    with K=27; then its conv form on NHWC codes read in place, at every
    path conv (the stem over the image's 3 channels as they lie, 3x3 at
    stride 1 and 2, the 1x1
    stride-2 skips, fuse_skip's merged convs) of batches 2048 (poly and erf
    codes), 256 and a ragged 3 (int32, f32, relu and every codes mode).
    int32 bit-identical; f32 bit-identical but for at most 1e-6 of the
    elements, each one ulp away (the plain float64 evaluation can round
    twice at an f32 midpoint); act codes identical but for at most 1e-6 of
    the codes, each one code away; the counts of differing elements are
    printed. Each conv in the form the rule gives it (r20_forms): block 3's
    skip (and at batch 3 the stage-1 conv) in K1's narrow Hopper form
    (csrc/qmatmul_sm90n.cu), block 3's stride-2 conv0, the 16x16 3x3s to 32
    columns and from batch 33 on the stage-1 conv in its plane form
    (csrc/qmatmul_sm90p.cu),
    each of those also held against the mma.sync form on its operands, bit
    for bit, in every mode checked (the plane form's also with the maps
    relu'd); (b) the first-conv kernel (csrc/first_conv_sm90.cu) from f32
    images at every site's columns and modes (FIRST_CHECKS), batches 2048,
    256 and 3, against its plain version and bit for bit against the chain
    it replaced (linear_q, K1's pad pass and mma.sync form);
 4. K2's path, its entry point: the launch counts are zeroed,
    cdf_quantize_int8 maps the act-site sizes of batches 2048 and 256, a
    ragged n and a view one element into its storage, and the counts are
    read: every launch in K2's Hopper form (csrc/cdf_quant_sm90.cu, counter
    `cdf_quantize_int8:sm90`); then each result is held against the plain
    version like K1's codes and, bit for bit, against the direct kernel
    (csrc/quantize.cu, quantize._old_form); then the Hopper form against
    the direct kernel on all 2^32 f32 bit patterns (16 chunks of 2^28, NaNs
    and infinities included): zero differences;
 5. K3 through its NHWC entry point, in the form the planner gives it
    (its Hopper form, csrc/stage_kernel_sm90.cu, counted under
    `stage_identity_blocks:sm90`), against its plain version and against
    its mma.sync form (csrc/stage_kernel.cu, under stage_kernel._old_form)
    at the three identity-block runs at batch 2048, 256 and a ragged 3, on
    the A4 grid (g=7) and at one run of ResNet-56's 8 blocks at each of C =
    16, 32 and 64 (seeded weights; the weights stream): the int16 stream
    bit-identical, no differing code (the counts printed per run);
 6. forwards on the card against the same forwards on the CPU at batch 64,
    on qparams converted on the CPU: the slice's route (act_impl='poly',
    int16 stream, stage kernel and the K1 1x1 route), the default erf
    route, an A4 'bins' and a W4A4 'bins_int' forward. The final int16
    stream bit for bit, every K1 launch in codes mode (1 of the slice
    route's 7 and 7 of the others' 21 in the narrow Hopper form,
    NARROW_PER_FORWARD; 2 and 12 in the plane form, PLANE_PER_FORWARD; the
    first conv in the first-conv kernel), every K3 launch (3 a slice-route
    forward) in its Hopper form, and no tap gather of a CUDA tensor;
 7. serving, the main path: the launch counts are zeroed, an engine is
    built with build_int8_resnet20_engine(batch_size=256) on the slice's
    route and answers requests of 1, 3, 100, 256 and 40 images, and the
    counts are read: 7 K1 launches, all in codes mode, 1 of them in the
    narrow Hopper form (counter `int8_matmul_dequant:kssm90n`), 2 in the
    plane form (`:kssm90p`), 1 in the first-conv kernel (`:first_sm90`), to
    3 K3 a forward, every K3 launch in its Hopper form, and no tap gather.
    Then what was served is held against the CPU's plain path: each
    request's logits within 1e-4, and the int16 stream of the engine's
    forward at its padded batch of 256 bit for bit. Then the engine's
    latency for one-image requests and its images/s on a backlog of 32
    full batches (host clock). Then the default erf route likewise, on
    fewer requests: 21 K1 launches a forward, all in codes mode, 7 in
    the narrow form, and no tap gather;
 8. the QAT half of the main path (train -> fold -> serve):
    (a) 3 train steps of a PreActResNet num_units=(1, 1, 1), W4A4, ADMM and
        the PDF correction, batch 8, in float64 on the card and on the CPU
        from one seed: params, BatchNorm statistics and duals within 1e-9;
    (b) the training CLI (train.cli.main) on the card: ResNet-20 W8A8
        int8 deploy_exact poly ADMM on the synthetic set, batch 64, 2
        epochs (64 steps), under cuDNN's deterministic algorithms (so is
        (c)'s export); every loss finite and the last below the first;
    (c) the launch counts zeroed, export_int8 of (b)'s net with
        --stage_kernel (fake-quant and INT top-1, delta, prediction
        agreement, at least 99.0%), the counts read; then an engine serves
        that net on the slice's route, held against the CPU plain path as
        in phase 7. Both runs launch K1 in the poly codes mode only, K3
        in its Hopper form only, and gather no taps;
 9. the QAT of DenseNet-40 (f32 and int8 stage buffers) and MobileNet-V2:
    (a) 3 float64 train steps, W4A4 with ADMM and the correction, batch
        8 of 16x16 images, on the card and on the CPU from one seed, of a
        depth-10 DenseNet with the int8 buffer (ema, its statistics
        starting at a calibrated net's) and with the f32 one, and of
        MobileNet-V2: params, statistics (amax included) and duals within
        1e-9;
    (b) each family trained at full width through export_int8.main on the
        synthetic set: W8A8, the int8 grid, deploy_exact, erf; DenseNet-40
        3 epochs at batch 128, MobileNet-V2 8 at batch 64, lr 0.01 with 1
        warmup epoch, under cuDNN's deterministic algorithms (as phase
        8(b, c)); every loss finite, the last quarter's mean below the
        first's;
    (c) exported (fake-quant and INT top-1, delta, prediction agreement of
        at least 99.0%, the logit margins of the images where the two
        disagree) and its artifact served by engine_from_artifact at
        engine batch 8, held against the CPU plain path as in phase 14;
        the launches of the export and of serving: K1, the BN-act form of
        the buffer (DenseNet) or the depthwise kernel (MobileNet-V2), no
        tap gathered;
    (d) each family's train step at batch 128 with ADMM (CUDA events,
        median of 2);
10. times from CUDA events (median of 20 after warm-up): the forward at
    batches 2048 and 256 on both routes, and each kernel at each path
    shape of batches 2048 and 256 (K1 and K3 in the form the planner gives
    them, K3's mma.sync form and K2's direct kernel beside them;
    its device time from a cold L2,
    utils/cuda_timing.py graph_ms: 20 launches captured in a CUDA graph,
    each after a read that evicts the L2, and replayed, so that no
    launch's host cost is in it) beside its plain version, its bound
    (conv_bound for K1: the input read once) and, for K1, torch._int_mm's
    time on the pre-gathered (M, Kp) matrix, taken the same way (timed
    only; no one PyTorch call computes K2 or K3); beside the stem, the
    pad pass that zero-pads its 3-channel image to the 4 channels K1
    reads (glue, timed the same way);
11. QAT train-step times (CUDA events, median of 3 after warm-up, TF32
    asserted off): ResNet-20 W8A8 erf with ADMM at batch 128, and erf and
    poly without ADMM at batch 1024; the batch-128 step's device busy
    time, idle share and five largest kernels from torch.profiler;
12. the CIFAR deploy families, DenseNet-40 (f32 and int8 stage buffers)
    and MobileNet-V2 at full width from seeded random weights: each graph's
    forward at batches 256 and 3 on the card with every K1, depthwise
    (csrc/dwconv.cu) and BN-act (csrc/quantize.cu: the arithmetic form over
    the f32 buffer and to build the int8 buffer's code tables; the table
    form over the int8 buffer, in csrc/bn_table_sm90.cu) launch recorded,
    and every distinct launch
    (69 a DenseNet buffer, and 39 table builds over the int8 one; 40 for
    MobileNet-V2; at each batch; K1's streamed 3x3, N blocks, relu'd codes
    and int8 requant among them) held against its plain version on its
    recorded operands, like K1's in phase 3 (requant identical; the table
    form against the arithmetic's plain version, bn_act_codes_plain, on the
    s, b and map its table was built from, and bit for bit quantize.cu's
    bn_table_kernel, quantize._old_form; the Hopper kernel is launched at
    every distinct table site too, also where the rule gives the site to
    bn_table_kernel, and held bit for bit to both; BN_TABLE_SM90_PER_FORWARD
    (4) of the 39 table launches a forward in the Hopper kernel, the rest in
    bn_table_kernel); every depthwise launch in the
    form's Hopper kernel (csrc/dwconv_sm90.cu), each distinct one also bit
    for bit csrc/dwconv.cu's (dwconv._old_form); K1's launches in the narrow
    Hopper form counted (NARROW_PER_FORWARD: 30 and 38 of DenseNet-40's 39,
    11 and 23 of MobileNet-V2's 50, at 256 and 3) and each distinct one
    also held against the mma.sync form, bit for bit;
13. the three graphs at batch 8 on the card against the CPU plain path, on
    qparams converted on the CPU: every DenseNet stage buffer and
    MobileNet block stream bit for bit, logits within 1e-5;
14. serving from artifacts: ResNet-20 W4A4 int4-packed, ResNet-56,
    DenseNet-40 (both buffers) and MobileNet-V2 saved by the port, served
    by serve.engine_from_artifact at engine batch 8 with the counts zeroed
    before and read after; each engine's final stream bit for bit and its
    logits within 1e-5 of the CPU plain path; 39 K1 (37 in the narrow
    form) and 39 BN-act launches a DenseNet forward (table form over the
    int8 buffer, 4 under `bn_act_codes:table:sm90` and 35 under
    `:table:chunked`, its 39 tables built once; arithmetic over the f32
    one),
    50 K1 (22 in the narrow form) and 17 depthwise a MobileNet one (all
    under `int8_matmul_dequant:dw:sm90`), no tap gathered;
15. times: each graph's forward at batch 256 (CUDA events, median of
    FORWARD_RUNS), its launches a forward and its idle share under
    torch.profiler (PROFILE_ITERS calls); each distinct launch at batch 256
    (graph_ms of LAUNCH_RUNS replays) beside its plain version (one run),
    its bound and the library call of the same product, both
    timed as in phase 9 (torch._int_mm on the gathered taps for K1,
    F.conv2d with groups=C on f32 for the depthwise conv, none for either
    BN-act form), and each table launch in quantize.cu's bn_table_kernel
    beside it; the table pass's time over a forward in the rule's forms and
    in bn_table_kernel alone;
16. the ImageNet-layout trunks, ResNet-18 and ResNet-50 at 224x224 from
    seeded random weights: the K1 and stem launches of each trunk's
    forward at batches 256 and 3 (erf and poly codes, and A4 bins at batch
    3) recorded and every distinct one held against its plain version as
    in phase 12 (the 1x1 convs over 1024 and 2048 channels, the streamed
    3x3 convs among them; the stem kernel, csrc/stem_sm90.cu, once a
    forward, against stem.stem_reference and bit for bit against the chain
    it replaced, stem._old_form); no tap gathered, no K1 7x7 launch; each
    forward's launches in K1's Hopper form (csrc/qmatmul_sm90.cu) counted:
    SM90_PER_FORWARD, 19 of ResNet-18's 20 and 52 of ResNet-50's 53 (all
    but the stem);
    (b) every distinct launch of (a) in the Hopper form held against the
    mma.sync form (csrc/qmatmul.cu) on its operands, bit for bit, in the
    modes int32, f32, relu, requant and the erf, poly and A4 bins codes,
    relu'd and not; and one streamed 3x3's weight cut to N/2 (each rank's
    slice at a model axis of 2) in both forms, each slice equal to its
    columns of the whole;
17. each trunk at batch 2 on the card against the CPU plain path, on
    qparams converted on the CPU: every stage's codes (block inputs, last
    act sites, the integer stream) and the f32 stream bit for bit, the
    features within 1e-5 of the largest;
18. serving, the trunks' main path: the launch counts zeroed, each trunk
    saved by the port as an artifact and served by engine_from_artifact
    at engine batch 4 (requests of 4 and 3 images: the engine's warm-up
    forward and two batches), the counts read (20 K1 launches a ResNet-18
    forward, 53 a ResNet-50 one, one of each forward's the stem kernel
    (counter `int8_matmul_dequant:stem_sm90`, its prep pass under
    `:stem_sm90:prep`), none K1's 7x7 form, and SM90_PER_FORWARD under the
    Hopper form (counter `int8_matmul_dequant:kssm90`), every one in a
    codes or the f32 mode, no tap gathered), and
    what was served held against the CPU plain path as in phase 14;
19. times: each trunk's int8 erf forward at batch 256 (CUDA events; device
    busy, idle share and launches under torch.profiler), and each distinct
    K1 launch of it (cold L2, graph_ms) in the form the planner gave it
    (and, for one in the Hopper form, the mma.sync form's time beside it)
    beside its plain version, its conv_bound and torch._int_mm on the
    gathered taps; the stem kernel's time with its prep pass's, against the
    int8 image read and the pooled int16 codes written;
20. the baselines' QAT: three float64 ResNet-20 steps of each of the ten
    methods (two of uniform_admm, whose third turns NaN in the JAX package
    too) (W4A4, ADMM where the method has sites, BatchNorm affine
    drawn), and the trunks' float64 forward and backward (ResNet-18 at
    64x64, ResNet-50 at 224x224, batch 2, W4A4 ADMM), on the card against
    the CPU within 1e-9; then the ResNet-50 trunk's f32 W8A8 ADMM forward
    and backward at batch 28 (the DANN preset's) and the ResNet-20 W4A4
    step of each of the ten methods at batch 128;
21. domain adaptation, (a): three float64 train steps of the digit DANN,
    and of DANN, DSAN and MDD on ResNet-18 at 32x32 (W4A4, ADMM, batch 4;
    the dropouts' masks from the same CPU generators), on the card against
    the CPU within 1e-9 (params, BatchNorm statistics, duals);
22. the digit DANN: (b) trained at full width through export_da_int8
    (W8A8, erf, the int8 grid, 28x28 at batch 128, lr .01, 5 epochs of the
    synthetic mnist -> mnistm pair) under cuDNN's deterministic
    algorithms; (c) its INT graph against its fake-quant eval on the target
    test set, at least DA_AGREEMENT_GATE (99.0%) agreement, every K1 launch
    of the export in the digit kernel (csrc/digit_sm90.cu: each 5x5 conv
    with its codes and 2x2 max pool); (d) its artifact served by
    engine_from_artifact at engine batch 8 (requests of 8 and 3): 2
    launches of the digit kernel (counter `int8_matmul_dequant:ks5_sm90`,
    relu'd erf codes) a forward, none of K1's 5x5 form, held to the CPU
    plain path as in phase 14, and an
    engine at batch 256 timed (one-image latency, a backlog's images/s,
    host clock); then the
    trained graph's launches at batches 3, 256 and 2048 each held against
    its plain version, timed at 256 and 2048 beside the plain version,
    conv_bound (pad 0) and torch._int_mm on the gathered taps, and the
    forward's time;
23. the DA nets on ResNet-50 at 224x224: the preset
    dann_office_d2w_w8a8_admm (W8A8 ADMM, 31 classes, batch 28), the
    preset dsan_office_a2w_w4a4 (W4A4, bottleneck 256, batch 32) and an MDD
    net (W8A8 ADMM, batch 28), each 3 timed steps (CUDA events), on
    seeded images; folded
    on the CPU by its family's converter; the 53 K1 launches of its INT
    forward at batch 4 each held against its plain version; DANN's class
    and domain logits on the card within 1e-5 of the CPU's; its artifact
    served at engine batch 2 (requests of 2 and 1: 53 K1 launches a
    forward, one the stem kernel) and held to the CPU plain path; DANN's
    engine at batch 16 timed as the digit net's;
24. data-parallel training over torch.distributed, one process a device
    (no new kernel). The machine has one card, and NCCL refuses two ranks
    on one card, so:
    (a) NCCL at world size 1 on the card: 3 float64 steps of a depth-8
        PreAct W4A4 with ADMM in gather mode and in local mode with each
        compression (f32, bf16, int8_gather), the f32 ones against the
        plain (non-distributed) step, the compressed ones against the same
        world-1 step on the CPU through a gloo group: within 1e-12;
    (b) two gloo ranks sharing the card (subprocesses of this script,
        `--dp-rank`): 4 float64 ResNet-20 W8A8 ADMM gather steps at global
        batch 16 against one process on the card, a local int8_gather
        step against the same two ranks on the CPU, and a DANN gather pair
        (ResNet-18 trunk at 32x32, W4A4 ADMM, batch 4, 2 steps) against one
        process: params, statistics and duals within 1e-9;
    (c) `python -m torch.distributed.run --nproc_per_node 2 -m
        alignq_tpu_torch.train.cli --mesh 2 --multihost --dist_backend gloo
        --deterministic` on the synthetic set (phase 8(b)'s job: ResNet-20
        W8A8 int8 deploy_exact poly ADMM, batch 64, 2 epochs; started
        first, it trains beside (a) and (b), which time nothing), then
        export_int8 --stage_kernel from rank 0's checkpoint (agreement at
        least 99.0%) and engine_from_artifact serving it, held to the CPU
        plain path; K1 in poly codes mode only, K3, no tap gather;
    (d) the ResNet-20 W8A8 ADMM f32 step at 64 images a rank (global 128
        over two gloo ranks, or one NCCL rank), gather and local: ms a step
        (host clock, median of 3) and the collectives' ms in one more step
        (torch.profiler:
        gloo's work, NCCL's kernels); for the gloo ranks, that time split
        into transfer and waiting for the other rank: one step with every
        collective timed alone (synchronized, host clock), and one more
        with a barrier before each, whose times are the transfer alone;
        labelled with the transport and the card: one card, not a
        multi-card figure;
    (e) the native augment library (native/augment.cpp, built by g++ into
        the run's temporary directory, so that no later run's batches
        change) against numpy's path at batch 2048: the same draws, values
        within 1e-5, host ms of each;
25. tensor parallelism and mesh serving, gloo ranks sharing the card:
    (a) K1's f32 epilogue (__fmaf_rn) against the plain fma_f32 on
        acc * scale + bias operands at, above and below f32 midpoints, bit
        for bit (and how many the earlier float64 add and cast would
        round otherwise);
    (b) ResNet-20 W8A8 ADMM, DP_STEPS float64 gather steps at global batch
        DP_BATCH, the kernels column-parallel, on meshes (1, 2) and (2, 2):
        the whole network within 1e-9 of one process, the replicated
        tensors bit-identical across the model ranks, each split kernel
        Cout / n_model channels on its rank;
    (c) engines from artifacts over meshes (1, 2), (2, 1) and (2, 2):
        ResNet-20 on the slice route (K1 and K3) and the erf route,
        DenseNet-40 with the int8 stage buffer, the ResNet-18 trunk at
        224x224; rank 0's logits bit for bit the one-process engine's,
        each rank's K1 launches counted with the channels they wrote
        (half a rank's at n_model 2), its K3 launches and tap gathers;
    (d) times, one card with gloo through the host (not multi-card
        figures): the f32 TP step at DP_TIME_BATCH on (1, 2), ms a rank
        and its collectives by op and group (a barrier before each), and
        served images/s of the slice route at engine batch 256 on each
        mesh and in one process;
26. the tools (tools_phase): (a) `alignq_tpu_torch.bench`'s entry point
    at batch 2048 with bench.py's ceiling keys (frac_of_achievable,
    frac_of_nominal, conv_ceiling_ms, epilogue_isolated_ms,
    residual_vs_mandatory; tools/shape_ceilings.py), measured on the card
    in this process: each non-null, frac_of_achievable in (0, 1], the conv
    ceiling below the forward's ms; its line printed; (b) the zoo, serving,
    artifact and QAT tools of alignq_tpu_torch/tools/ at --smoke, each
    printing the card line and its rows (the corr-mode and calibration
    A/Bs drive paths phases 24(b) and 9 hold, and run apart);
27. one JSON line of the kernels (K1 and K3: times summed over the
    launches of one slice-route forward at the serving batch, K3 in its
    Hopper form, its launches those of phase 7's main path; K2 (its Hopper
    form): over one launch at each act-site size of that batch, its
    launches those of phase 4; K1 on DenseNet-40 and
    MobileNet-V2, the depthwise kernel and the BN-act kernels (the table
    form on the int8 buffer in its Hopper kernel and in bn_table_kernel,
    a row each over the launches the rule gives it; the arithmetic form on
    the f32 one): over one batch-256 forward of their graph, launches from
    phase 14 (the depthwise form's Hopper kernel's and each table kernel's
    under its own counter); K1 on
    ResNet-50 and ResNet-18 at 224x224 (both forms; the stem aside) and
    the stem kernel (its time with its prep pass's, over one batch-256
    ResNet-50 forward; its launches over both trunks' served forwards):
    launches from phase 18; K1's Hopper form: over one batch-256 forward of
    each trunk, its launches over both trunks' served forwards (phase 18);
    K1's narrow Hopper form and its plane form, and the first-conv kernel:
    over one batch-256 slice-route forward's launches in each, their
    launches those of phase 7's main path (the first conv's time from the
    f32 image, its quantization inside);
    the digit kernel (its time with its prep pass's): over one batch-256
    digit forward, launches from phase 22's serving, its error the largest
    of phases 22 and 23's checks), the card line, and the final JSON line.

Exits with code 2 and prints no result where CUDA is not available. Writes
the per-shape details to chiprun_out/chip_smoke.json.

    python3 chip_smoke.py --dp-rank RANK N PORT DEVICE OUT CASES

is one rank of phase 24(b, d), started by the script itself;

    python3 chip_smoke.py --tp-rank RANK N PORT SPEC

one rank of phase 25, likewise.

    python3 chip_smoke.py --tp-only

builds the kernels and runs phase 25 alone.

    python3 chip_smoke.py --fma-ab

times fma_f32's repair on the card: the ResNet-50 int8 forward at batch
256 and the ResNet-20 W8A8 erf ADMM QAT step at 128, with the repaired
fma_f32 and with its earlier form (float64 evaluation, one cast), in the
order ABBA, in one process.

    python3 chip_smoke.py --k1-ab

times K1's forms on the card in one process: each distinct launch whose
shape a Hopper form takes, in a forward of ResNet-18 and ResNet-50
(224x224) at batches 256, 4 and 3, MobileNet-V2 and DenseNet-40 (both
stage buffers) at 256 and 8, and ResNet-20 at 2048 and 256 (graph_ms, cold
L2), in the mma.sync form and at each option of the Hopper form that takes
it (the wide form's tiles of 256, 128 and 64 rows; the narrow form's row
groups, warpgroups and K split; the plane form's item sizes), in the order
mma.sync, the options, the options backwards, mma.sync, beside the form and
option the planner's rule gives it; each forward's K1 sum all in mma.sync, by the rule and at the
fastest option, and the whole forward in mma.sync and by the rule, ABBA
(mma.sync everywhere under qmatmul._mma_form); one JSON line, also
written to chiprun_out/k1_ab.json.

    python3 chip_smoke.py --k3-ab

times K3's two forms on the card in one process: each ResNet-20 stage run
at batches 2048, 256, 8 and 3 (graph_ms, cold L2) in the mma.sync form and
in the Hopper form at each images-a-CTA and warpgroup option, in the order
mma.sync, the options, the options backwards, mma.sync, every option's
stream bit for bit the mma.sync form's, beside the option the planner's
rule gives and the bound; K3 summed over a forward each way, and the
slice-route forward at 2048 and 256 ABBA (mma.sync under
stage_kernel._old_form); one JSON line, also written to
chiprun_out/k3_ab.json.

    python3 chip_smoke.py --stem-dw-ab

times the stem kernel and the depthwise form's Hopper kernel against the
forms they replaced, in one process: ResNet-50's stem chain at 224x224 at
batches 256 and 4 (the parent's _linear_q, pad pass, K1 7x7 form and f16
pool chain, under stem._old_form, against the prep pass and the stem
kernel), and each depthwise launch of a MobileNet-V2 forward at 256 and 8
(csrc/dwconv.cu against csrc/dwconv_sm90.cu) and their sums, each in the
order old, new, new, old (graph_ms, cold L2), the outputs bit for bit
equal; one JSON line, also written to chiprun_out/stem_dw_ab.json.

    python3 chip_smoke.py --bn-digit-ab

times the BN-act table pass's Hopper kernel and the digit kernel against
the forms they replaced, in one process: each table launch of a DenseNet-40
stage_int8 forward at batches 256 and 8 in quantize.cu's bn_table_kernel and
in bn_table_sm90.cu at 8 and 16 work items a warp (ABBA), whichever form the
rule gives the site, and their sums over the forward (the rule's among
them); each digit conv at batches 256 and 2048 as the chain (K1's 5x5 form
and the pool, digit._old_form), as the kernel after its prep pass, and as
the kernel after _linear_q and a pad in PyTorch, ABBA, and the kernel's
tile options; the DenseNet-40 stage_int8 forward (at 256 and 8: the rule's
forms against bn_table_kernel alone) and the digit forward both ways, ABBA; every output bit for bit the old form's. One JSON line, also
written to chiprun_out/bn_digit_ab.json.

    python3 chip_smoke.py --first-plane-ab

times the first-conv kernel and K1's plane form against the forms they
replaced, in one process (first_plane_ab): every first conv and plane-form
launch of ResNet-20's slice and erf routes at 2048 and 256 (the slice route
at 8, the erf route at 64 and 8 too), DenseNet-40 (both buffers) and
MobileNet-V2 at 256 and 8, the old form against each tile or item option,
ABBA, the outputs bit for bit; each forward's K1 sum and the whole forward
both ways. One JSON line, also written to chiprun_out/first_plane_ab.json.

    python3 chip_smoke.py --k2-ab

times K2's Hopper form against its direct kernel, in one process (k2_ab):
at the act-site sizes of batches 2048, 256, 64, 16 and 8 and a ragged n of
1,000,003, ABBA (graph_ms, cold L2), beside PyTorch's cast of the same f32
to int8; a view one element into its storage through the entry point both
ways; every output bit for bit; and the card's table against the CPU-built
one. One JSON line, also written to chiprun_out/k2_ab.json.

    python3 chip_smoke.py --gather-backward-ab

times the data-parallel gather step over two gloo ranks on the card with
the row gather's backward as an all-reduce of all rows (its earlier form)
and as the reduce-scatter it is, four runs in the order ABBA.

    python3 chip_smoke.py --tools-only

runs the build and phase 26 (the tools) alone.

    python3 chip_smoke.py --agreement-study

runs only phase 9(b, c)'s training and export again, without the gate:
MobileNet-V2 three times with cuDNN's default (run-to-run) algorithms,
and every family under its deterministic ones at seed 1. Each run prints
its top-1s, agreement, the logit margins of the images where the INT
graph and the fake-quant eval disagree, and the largest and median gap
between their logits, one JSON line each.
"""

import contextlib
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from alignq_tpu_torch.utils.cuda_timing import RUNS, graph_ms, median_ms, profile
from alignq_tpu_torch.utils.launches import (  # noqa: F401  (the scripts and tests read them here too)
    BN_ACT_OPS,
    K2_OPS_PER_ELEMENT,
    K2_TABLE_OPS_PER_ELEMENT,
    LAUNCH_RUNS,
    PEAK_BYTES_PER_S,
    PEAK_F32_OPS_PER_S,
    PEAK_INT8_OPS_PER_S,
    PLAIN_RUNS,
    bound,
    card_line,
    check_launch,
    code_mismatches,
    conv_bound,
    distinct_launches,
    f32_mismatches,
    k3_bound,
    launch_key,
    record_launches,
    time_launch,
)

# repetitions of the default run's timing phases (cut to keep the run
# within its call, CHANGES.md): a whole forward's CUDA-event runs, a
# profile's iterations (a launch's: utils/launches.py LAUNCH_RUNS)
FORWARD_RUNS, PROFILE_ITERS = 10, 2
ENGINE_RUNS, ENGINE_BACKLOG = 10, 16  # engine_times: one-image requests, full batches of the backlog
BATCH = 2048  # bench.py's headline batch
SERVE_BATCH = 256  # the engine's batch on the main path
K3_DEEP_MS = tuple(range(2, 10))  # ResNet-56's stage-2 and stage-3 runs: 8 blocks, multipliers 2-9
K3_DEEP_BATCH = 64  # phase 5's 8-block runs
SEED = 0


def conv_shapes(batch):
    """The path's K1 convs at `batch`: (name, B, H, W, Cin, ksize, stride,
    N) -> launches a forward on the slice route and on the default erf
    route (fuse_skip's merged convs are on neither)."""
    return {
        ("stem conv", batch, 32, 32, 3, 3, 1, 16): (1, 1),
        ("stage1 conv", batch, 32, 32, 16, 3, 1, 16): (0, 6),
        ("block3 conv0", batch, 32, 32, 16, 3, 2, 32): (1, 1),
        ("block3 skip", batch, 32, 32, 16, 1, 2, 32): (1, 1),
        ("block3 conv1", batch, 16, 16, 32, 3, 1, 32): (1, 5),
        ("block6 conv0", batch, 16, 16, 32, 3, 2, 64): (1, 1),
        ("block6 skip", batch, 16, 16, 32, 1, 2, 64): (1, 1),
        ("block6 conv1", batch, 8, 8, 64, 3, 1, 64): (1, 5),
        ("block3 merged", batch, 32, 32, 16, 3, 2, 64): (0, 0),
        ("block6 merged", batch, 16, 16, 32, 3, 2, 128): (0, 0),
    }


def k1_shapes(batch):
    """The path's K1 launches at `batch` as GEMMs over gathered taps:
    (name, M, K, N) -> launches a forward on the slice route and on the
    default erf route. K1 runs them through its GEMM form."""
    return {
        ("stem conv", batch * 1024, 27, 16): (1, 1),
        ("stage1 conv", batch * 1024, 144, 16): (0, 6),
        ("block3 conv0", batch * 256, 144, 32): (1, 1),
        ("block3 skip", batch * 256, 16, 32): (1, 1),
        ("block3 conv1", batch * 256, 288, 32): (1, 5),
        ("block6 conv0", batch * 64, 288, 64): (1, 1),
        ("block6 skip", batch * 64, 32, 64): (1, 1),
        ("block6 conv1", batch * 64, 576, 64): (1, 5),
    }


def act_site_sizes(batch):
    """The element counts of the act sites' (M, N) at `batch`: K2's sizes."""
    return [("stem sites", batch * 1024 * 16), ("stage2 sites", batch * 256 * 32),
            ("stage3 sites", batch * 64 * 64)]


def to_device(tree, dev):
    """A qparams tree (dicts, lists, QConvInt8, tensors, host scalars) on dev."""
    import torch

    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, dev) for v in tree))
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev) if torch.is_tensor(tree) else tree


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (and no autotuning) for a training
    run whose result a gate reads, restored after: cuDNN's run-to-run order
    otherwise swings a few-epoch synthetic run's accuracy, and with it the
    prediction agreement on near-tied logits (MobileNet-V2 at 92.77% top-1
    and 98.63% agreement against 99.80% and 100.00% in another run of one
    tree); deterministic runs of a tree repeat step for step."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def zero_counts(launches):
    for k in list(launches):
        launches[k] = 0


QAT_JOB_ARGS = ["--dataset", "synthetic", "--bitW", "8", "--abitW", "8", "--variant", "int8", "--deploy_exact",
                "--cdf_impl", "poly", "--admm", "--train_batch_size", "64", "--eval_batch_size", "64",
                "--num_epochs", "2", "--print_freq", "1"]


def qat_card_vs_cpu(dev, build, cfg, hw, n_sites, steps=3):
    """`steps` train steps of the model build(generator) gives, ADMM and
    the correction per cfg, batch 8 of hw x hw images, in float64 on the
    card and on the CPU from one seed; returns the largest difference of
    the params, the statistics (BatchNorm's, StageRequant's amax) and the
    duals (NaN where either side has a NaN). Raises unless the model has
    n_sites ADMM sites."""
    import numpy as np
    import torch

    from alignq_tpu_torch.train import create_train_state, make_train_step

    states = {}
    for where in ("cpu", dev):
        gen = torch.Generator().manual_seed(SEED)
        model = build(gen).double().to(where)
        state = create_train_state(gen, model, cfg, input_shape=(1, hw, hw, 3), steps_per_epoch=10_000)
        step = make_train_step(model, cfg)
        rng = np.random.RandomState(SEED)
        for _ in range(steps):
            x = torch.tensor(rng.randn(8, hw, hw, 3)).to(where)
            step(state, x, torch.tensor(rng.randint(0, 10, 8)).to(where))
        states[str(where)] = state
    cpu, card = states["cpu"], states[str(dev)]
    pairs = [(cpu.params[k], card.params[k]) for k in cpu.params]
    pairs += [(cpu.batch_stats[k], card.batch_stats[k]) for k in cpu.batch_stats]
    for k, s in cpu.admm_duals.items():
        pairs += [(s.alter_d, card.admm_duals[k].alter_d), (s.gamma, card.admm_duals[k].gamma)]
    if len(cpu.admm_duals) != n_sites or card.step != steps:
        raise AssertionError(f"QAT f64 steps: {len(cpu.admm_duals)} ADMM sites, {card.step} steps")
    diffs = [float((a.detach() - b.detach().cpu()).abs().max()) for a, b in pairs]
    return float("nan") if any(math.isnan(d) for d in diffs) else max(diffs)


def qat_on_the_card(dev, repo, serve_and_check, reqs, slice_kw):
    """Phase 8: (a) the card against the CPU in float64; (b) the training
    CLI on the card; (c) export_int8 of (b)'s net through K1 and K3, then
    serving it, held against the CPU plain path."""
    import math
    import shutil

    import torch

    from alignq_tpu_torch import export_int8
    from alignq_tpu_torch.interop import deploy_tree
    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels import stage_kernel as K3
    from alignq_tpu_torch.train import cli

    out = {}
    # (a)
    from alignq_tpu_torch.models.resnet_cifar import PreActResNet
    from alignq_tpu_torch.train import TrainConfig

    err = qat_card_vs_cpu(dev, lambda g: PreActResNet(num_units=(1, 1, 1), w_bit=4, a_bit=4, admm=True, generator=g),
                          TrainConfig(train_batch_size=8, bitW=4, abitW=4, admm=True, lr=0.02,
                                      lr_decay_steps=(1000,)), 32, 9)
    print(f"QAT (a) 3 float64 steps, W4A4 ADMM + correction, batch 8: card vs CPU max abs diff {err:.3g} "
          "(params, BatchNorm statistics, duals)", flush=True)
    if not err <= 1e-9:
        raise AssertionError(f"QAT (a): the card's float64 steps differ from the CPU's by {err}")
    out["card_vs_cpu_f64_max_abs"] = err

    # (b) the CLI, on the card (its default device)
    job = repo / "chiprun_out" / "qat_job"
    shutil.rmtree(job, ignore_errors=True)
    t0 = time.perf_counter()
    with deterministic_cudnn():
        result = cli.main(QAT_JOB_ARGS + ["--job_dir", str(job)])
    train_s = time.perf_counter() - t0
    losses = [json.loads(line)["loss"] for line in (job / "run" / "train.jsonl").read_text().splitlines()]
    print(f"QAT (b) CLI ResNet-20 W8A8 int8 deploy_exact poly ADMM, batch 64, 2 epochs: {len(losses)} steps in "
          f"{train_s:.1f} s; loss first {losses[0]:.4f} last {losses[-1]:.4f}; eval top-1 "
          f"{result['best_top1']:.2f}", flush=True)
    if "aborted" in result or len(losses) != 64 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"QAT (b): {len(losses)} steps, losses {losses[:3]}..., {result.get('aborted')}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"QAT (b): the loss did not fall ({losses[0]} -> {losses[-1]})")
    out.update(train_s=train_s, loss_first=losses[0], loss_last=losses[-1], eval_top1=result["best_top1"])

    # (c) export (b)'s net and serve it: the QAT path's kernels
    zero_counts(_build.launches)
    with deterministic_cudnn():
        rep = export_int8.main(["--dataset", "synthetic", "--bits", "8", "--variant", "int8", "--cdf_impl", "poly",
                                "--deploy_exact", "--admm", "--epochs", "2", "--batch", "64", "--job_dir", str(job),
                                "--resume", "--stage_kernel"])
    torch.cuda.synchronize()
    export_launches = {k: v for k, v in _build.launches.items() if v}
    print(f"QAT (c) export: fake-quant top-1 {rep['fq_top1']:.2f}, INT top-1 {rep['int_top1']:.2f}, delta "
          f"{rep['delta']:+.2f} pts, prediction agreement {rep['agreement']:.2f}%; launches {export_launches}",
          flush=True)
    if rep["state"].step != 64:
        raise AssertionError(f"QAT (c): exported a net of {rep['state'].step} steps, not (b)'s 64")
    if rep["agreement"] < 99.0:
        raise AssertionError(f"QAT (c): prediction agreement {rep['agreement']:.2f}% is below 99.0%")
    _, _, served = serve_and_check("QAT-trained net, slice route", slice_kw, reqs, deploy_tree(rep["state"].model))
    poly = K1.MODE.format("poly")
    for label, counts in (("export", export_launches), ("serving", served)):
        if not (counts.get(K1.KERNEL, 0) > 0 and counts.get(poly, 0) == counts[K1.KERNEL]
                and counts.get(K3.KERNEL, 0) > 0 and counts.get(K3.SM90, 0) == counts[K3.KERNEL]
                and not counts.get(K1.TAP_GATHERS, 0)):
            raise AssertionError(f"QAT (c) {label}: launches {counts}: expected K1 in poly codes mode only, "
                                 "K3 in its Hopper form, and no tap gather")
    out.update(fq_top1=rep["fq_top1"], int_top1=rep["int_top1"], delta=rep["delta"], agreement=rep["agreement"],
               export_launches=export_launches, serving_launches=served)
    return out


def qat_times(dev, card):
    """Phase 11: a ResNet-20 QAT train step, CUDA events (median of 3 after
    warm-up), TF32 off: batch 128 W8A8 erf ADMM (TrainConfig's default,
    the reference's configuration) and batch 1024 W8A8 erf and poly, ADMM
    off; then the batch-128 ADMM step under torch.profiler: device busy,
    idle share and the five largest kernels."""
    import numpy as np
    import torch

    from alignq_tpu_torch.models.registry import build_model
    from alignq_tpu_torch.train import TrainConfig, create_train_state, make_train_step
    from alignq_tpu_torch.train.loop import true_f32

    true_f32()
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on")
    out = {}
    for batch, impl, admm in ((128, "erf", True), (1024, "erf", False), (1024, "poly", False)):
        torch.cuda.reset_peak_memory_stats(dev)
        cfg = TrainConfig(train_batch_size=batch, bitW=8, abitW=8, admm=admm, cdf_impl=impl)
        model = build_model(cfg, torch.Generator().manual_seed(SEED)).to(dev)
        state = create_train_state(torch.Generator().manual_seed(SEED), model, cfg)
        step = make_train_step(model, cfg)
        rng = np.random.RandomState(SEED)
        x = torch.tensor(rng.randn(batch, 32, 32, 3), dtype=torch.float32, device=dev)
        y = torch.tensor(rng.randint(0, 10, batch), device=dev)
        ms = median_ms(lambda: step(state, x, y), runs=3, warmup=1)
        key = f"batch {batch} W8A8 {impl} admm={admm}"
        out[key] = {"ms_per_step": ms, "images_per_s": batch / ms * 1e3,
                    "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        print(f"QAT step {key}: {ms:.3f} ms/step = {batch / ms * 1e3:.0f} images/s [{card}]", flush=True)
        if batch == 128:
            out["profile_batch_128_admm"] = profile_step(lambda: step(state, x, y), card, iters=1)
        del model, state, step, x, y
        torch.cuda.empty_cache()
    return out


def profile_step(fn, card, label="QAT step batch 128 ADMM", iters=5):
    """cuda_timing.profile of fn, printed: wall, host issue and busy time
    a call, idle share, launches and the five largest kernels."""
    r = profile(fn, iters)
    print(f"{label} under torch.profiler: wall {r['wall_ms']:.3f} ms a call, device busy {r['busy_ms']:.3f} ms "
          f"(idle share {r['idle_share']:.3f}), host issue {r['host_ms']:.3f} ms "
          f"({r['host_ms_per_launch'] * 1e3:.1f} us a launch), {r['launches_per_step']} kernel launches a call "
          f"[{card}]", flush=True)
    for row in r["top5"]:
        print(f"  {row['device_ms']:9.4f} ms {row['calls']:5d} calls  {row['kernel']}", flush=True)
    return r


# ---------------------------------------------- the CIFAR deploy families

FAMILY_SERVE_BATCH = 8  # the engine batch of the families' serving phase
FAMILY_TIME_BATCHES = (256,)


def family_configs():
    """(label, build, forward, streams, pack, kw) of each new served graph."""
    from alignq_tpu_torch.kernels import infer_densenet as D
    from alignq_tpu_torch.kernels import infer_mobilenet as M

    return [
        ("densenet40 f32", D.build_densenet40_int8, D.densenet40_int8_forward, D.densenet40_int8_buffers,
         D.pack_densenet40_operands, {"stage_int8": False}),
        ("densenet40 stage_int8", D.build_densenet40_int8, D.densenet40_int8_forward, D.densenet40_int8_buffers,
         D.pack_densenet40_operands, {"stage_int8": True}),
        ("mobilenetv2", M.build_mobilenetv2_int8, M.mobilenetv2_int8_forward, M.mobilenetv2_int8_streams,
         M.pack_mobilenetv2_operands, {}),
    ]


def old_form_ms(kind, args):
    """The device time (graph_ms, cold L2) of a recorded table, digit or
    first-conv launch in the form it replaced: quantize.cu's
    bn_table_kernel; the digit conv's chain (_linear_q for conv 1, K1's 5x5
    form and its pad pass, the pool) under digit._old_form; the first
    conv's (linear_q, K1's pad pass and its mma.sync form) under
    first_conv._old_form."""
    import torch

    from alignq_tpu_torch.kernels import digit as DSm
    from alignq_tpu_torch.kernels import first_conv as FC
    from alignq_tpu_torch.kernels import quantize as K2

    if kind == "first":
        x, op, _, mode, act, scale = args

        def first_chain():
            with FC._old_form():
                return FC.first_conv(x, op, scale, act, mode)

        return graph_ms(runs=LAUNCH_RUNS, fn=first_chain)
    if kind == "bn_table":
        x, c_live, table, _, _, c_out = args
        out = torch.empty((*x.shape[:-1], c_out), device=x.device, dtype=torch.int8)
        return graph_ms(runs=LAUNCH_RUNS, fn=lambda: K2._bn_table_launch(x, c_live, table, out, None))
    x, op, plan, act = args

    def chain():
        with DSm._old_form():
            return DSm.conv_pool(plan.conv, x, op, act)

    return graph_ms(runs=LAUNCH_RUNS, fn=chain)


def family_kernel_checks(dev, batches=(256, 3)):
    """Each new graph's launches at each batch recorded from one card
    forward, and every distinct one held against its plain version. Returns
    ({(label, batch): distinct launches}, max abs error by kind, counts)."""
    import torch

    from alignq_tpu_torch.kernels import dwconv as DWm
    from alignq_tpu_torch.kernels import qmatmul as K1

    kinds = ("K1", "first", "dw", "bn", "bn_table")
    out, err, counts = {}, dict.fromkeys(kinds, 0.0), {}
    for label, build, fwd, _, pack, kw in family_configs():
        for batch in batches:
            _, (qp, x) = build(batch, device=dev, **kw)
            ops = pack(qp, **kw)
            with torch.inference_mode():
                rec = record_launches(lambda: fwd(qp, x, operands=ops, **kw))
            launches = distinct_launches(rec)
            n_pairs = 0
            for key, ((kind, args), _) in launches.items():
                diff, numel, e = check_launch(kind, args)
                err[kind] = max(err[kind], e)
                counts[f"{label} batch {batch} {key}"] = diff
                if kind == "K1" and isinstance(args[2], (K1.NarrowPlan, K1.PlanePlan)):  # and against mma.sync
                    form_pair(args[0], args[1], args[2], [(args[3], args[4])])
                    n_pairs += 1
            n_by = {k: sum(c for (kk, _), c in launches.values() if kk == k) for k in kinds}
            n_narrow = sum(isinstance(args[2], K1.NarrowPlan) for kind, args in rec if kind == "K1")
            n_dw90 = sum(isinstance(args[2], DWm.DwSm90Plan) for kind, args in rec if kind == "dw")
            n_tb90 = sum(args[3] is not None for kind, args in rec if kind == "bn_table")
            if n_by["bn_table"] and n_tb90 != BN_TABLE_SM90_PER_FORWARD:
                raise AssertionError(f"{label} batch {batch}: {n_tb90} of {n_by['bn_table']} table launches in the "
                                     f"Hopper kernel, expected {BN_TABLE_SM90_PER_FORWARD}")
            if n_dw90 != n_by["dw"]:
                raise AssertionError(f"{label} batch {batch}: {n_dw90} of {n_by['dw']} depthwise launches in the "
                                     f"Hopper form, expected all")
            if n_narrow != NARROW_PER_FORWARD[label.split()[0], batch]:
                raise AssertionError(f"{label} batch {batch}: {n_narrow} K1 launches in the narrow form, expected "
                                     f"{NARROW_PER_FORWARD[label.split()[0], batch]}")
            n_diff = sum(counts[f"{label} batch {batch} {k}"] for k in launches)
            print(f"{label} batch {batch}: {len(rec)} launches ({n_by}; K1 {n_narrow} in the narrow form, the "
                  f"depthwise {n_dw90} in the Hopper form, each distinct one bit for bit dwconv.cu's, the table "
                  f"pass {n_tb90} in its Hopper kernel, the rest in bn_table_kernel, the Hopper kernel at each "
                  f"distinct site bit for bit bn_table_kernel's), "
                  f"{len(launches)} distinct, each held against its plain version: {n_diff} differing elements; "
                  f"the {n_pairs} distinct narrow-form launches bit for bit the mma.sync form's", flush=True)
            out[label, batch] = launches
            del qp, x, ops
    return out, err, counts


def serve_artifact(label, path, streams, dev, requests, feature=False, batch=FAMILY_SERVE_BATCH):
    """Serve an artifact through serve.engine_from_artifact on the card at
    engine batch `batch`, the launch counts zeroed before the
    engine is built and read after its requests, and hold what was served
    against the CPU's plain path at the engine's padded batch: the final
    stream (a graph's last stage buffer or block stream, `streams` its
    stream function) bit for bit, the logits within 1e-5 (feature: a
    trunk's pooled feature, within 1e-5 of its largest). Returns
    {'launches', 'max_abs_err'}; raises if a conv gathered its taps."""
    import numpy as np
    import torch

    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels.infer import resnet20_int8_stream
    from alignq_tpu_torch.serve import engine_from_artifact

    def final_stream(qp, x, **kw):
        """The last stream of the graph (ResNet's stream function gives one;
        an ImageNet trunk's stages are dicts, its stream under 'out')."""
        if streams is resnet20_int8_stream:
            return streams(qp, x, **kw)
        last = list(streams(qp, x, **kw))[-1]
        return last["out"] if isinstance(last, dict) else last

    zero_counts(_build.launches)
    engine = engine_from_artifact(str(path), batch_size=batch, device=dev)
    outs = [f.result(timeout=300) for f in [engine.submit(r) for r in requests]]
    torch.cuda.synchronize()
    launched = {k: v for k, v in _build.launches.items() if v}
    engine.close()
    if launched.get(K1.TAP_GATHERS, 0):
        raise AssertionError(f"serving {label}: a conv gathered its taps on the card: {launched}")
    fkw = {k: v for k, v in engine.forward.keywords.items() if k != "operands"}
    skw = {k: v for k, v in fkw.items() if k in ("act_bits", "act_impl", "stage_int8", "stream", "use_stage_kernel")}
    qp_host = to_device(engine.params, "cpu")
    images = np.concatenate(requests)
    padded = np.concatenate([images, np.zeros((-len(images) % batch, *engine.input_shape), np.float32)])
    served = np.concatenate(outs)
    serve_err = 0.0
    for lo in range(0, len(padded), batch):
        xb = torch.from_numpy(padded[lo : lo + batch])
        with torch.inference_mode():
            s_gpu = final_stream(engine.params, xb.to(dev), operands=engine.forward.keywords["operands"], **skw)
        if not torch.equal(s_gpu.cpu(), final_stream(qp_host, xb, **skw)):
            raise AssertionError(f"serving {label}: the engine's final stream differs from the CPU's")
        want = engine.forward.func(qp_host, xb, **fkw).numpy()[: min(batch, len(served) - lo)]
        got = served[lo : lo + len(want)]
        # logits within 1e-5; a trunk's pooled feature (a sum over the map in
        # the card's order) within 1e-5 of its largest
        err = float(np.abs(got - want).max()) / (max(1.0, float(np.abs(want).max())) if feature else 1.0)
        serve_err = max(serve_err, err)
        if not (np.isfinite(got).all() and serve_err <= 1e-5):
            raise AssertionError(f"serving {label}: served results off the CPU's by {serve_err}")
    print(f"serving {label} from its artifact, engine batch {batch}: requests of "
          f"{[len(r) for r in requests]} answered, logits within {serve_err:.3g} of the CPU plain path, the final "
          f"stream identical; launches {launched}", flush=True)
    return {"launches": launched, "max_abs_err": serve_err}


def check_family_launches(label, n, batch=None):
    """The launch counts of a served or exported DenseNet-40 or MobileNet-V2
    (an engine's build and its requests, or an export's evaluation):
    DenseNet 39 K1 and 39 BN-act launches a forward, over the int8 buffer
    in the table form's Hopper kernel (its 39 tables built once, by the
    arithmetic kernel)
    and over the f32 one in the arithmetic form; MobileNet-V2 50 K1 and 17
    depthwise a forward; no tap gather. K1's launches in the narrow Hopper
    form: where every forward ran at `batch`, NARROW_PER_FORWARD's count at
    it (at the engine batch 8, 37 of DenseNet's and 22 of MobileNet's),
    else some."""
    from alignq_tpu_torch.kernels import dwconv as DWm
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels import quantize as K2

    if n.get(K1.TAP_GATHERS, 0):
        raise AssertionError(f"{label}: a conv gathered its taps on the card: {n}")
    k1 = n.get(K1.KERNEL, 0)
    if batch is not None:  # every forward at this batch: the rule's count of narrow-form launches
        n_narrow = NARROW_PER_FORWARD[label.split()[0], batch]
        if n.get(K1.NARROW, 0) * (39 if label.startswith("densenet40") else 50) != k1 * n_narrow:
            raise AssertionError(f"{label}: launches {n}, expected {n_narrow} K1 a forward in the narrow form")
    elif not 0 < n.get(K1.NARROW, 0) < k1:
        raise AssertionError(f"{label}: launches {n}, expected some K1 launches in the narrow form")
    if label.startswith("densenet40 stage_int8"):
        ok = k1 and k1 % 39 == 0 and n.get(K2.BN_ACT_TABLE) == k1 and n.get(K2.BN_ACT_ARITH) == 39 and \
            n.get(K2.BN_ACT_TABLE_SM90, 0) * 39 == k1 * BN_TABLE_SM90_PER_FORWARD and \
            n.get(K2.BN_ACT_TABLE_CHUNKED, 0) * 39 == k1 * (39 - BN_TABLE_SM90_PER_FORWARD)
        want = (f"39 K1 and 39 table launches a forward, {BN_TABLE_SM90_PER_FORWARD} in the Hopper kernel, and 39 "
                f"table builds")
    elif label.startswith("densenet40"):
        ok = k1 and k1 % 39 == 0 and n.get(K2.BN_ACT_ARITH) == k1 and not n.get(K2.BN_ACT_TABLE)
        want = "39 K1 and 39 arithmetic BN-act launches a forward"
    else:
        ok = k1 and k1 * 17 == n.get(DWm.DW, 0) * 50 and n.get(DWm.DW_SM90, 0) == n.get(DWm.DW, 0)
        want = "50 K1 and 17 depthwise a forward, every depthwise one in the Hopper form"
    if not ok:
        raise AssertionError(f"{label}: launches {n}, expected {want}")


def deploy_families(dev, card, repo, details, phase):
    """Phases 12-15: DenseNet-40 (f32 and int8 stage buffers) and
    MobileNet-V2 on the card. Returns (the batch-256 launch time rows, max
    abs error by kernel kind, each served artifact's launches and error)."""
    import torch

    from alignq_tpu_torch.interop import init_preact_resnet_params
    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels.infer import convert_resnet20, resnet20_int8_stream

    phase("deploy families: every K1, depthwise and BN-act launch against its plain version")
    from alignq_tpu_torch.kernels.artifact import save_int8_artifact
    from alignq_tpu_torch.kernels.convert import pack_qparams_int4

    fam_launches, fam_err, details["family_mismatches"] = family_kernel_checks(dev)

    phase("deploy families: full-width forwards on the card against the CPU")
    for label, build, fwd, streams, _, kw in family_configs():
        _, (qp_cpu, x_cpu) = build(8, device="cpu", **kw)
        qp_gpu = to_device(qp_cpu, dev)
        with torch.inference_mode():
            got = [t.cpu() for t in streams(qp_gpu, x_cpu.to(dev), **kw)]
            l_gpu = fwd(qp_gpu, x_cpu.to(dev), **kw).cpu()
        want = list(streams(qp_cpu, x_cpu, **kw))
        for i, (g_, w_) in enumerate(zip(got, want)):
            if not torch.equal(g_, w_):
                raise AssertionError(f"{label}: stream {i} differs between CUDA and CPU")
        lerr = float((l_gpu - fwd(qp_cpu, x_cpu, **kw)).abs().max())
        if not (torch.isfinite(l_gpu).all() and lerr <= 1e-5 and l_gpu.shape == (8, 10)):
            raise AssertionError(f"{label}: logits off the CPU's by {lerr}")
        print(f"forward {label} batch 8: all {len(got)} stage buffers / block streams identical to the CPU's, "
              f"logits max abs {lerr:.3g}", flush=True)

    phase("deploy families: serving from artifacts")
    art_dir = repo / "chiprun_out" / "artifacts"
    art_dir.mkdir(parents=True, exist_ok=True)
    freqs = [torch.randn((n, 32, 32, 3), generator=torch.Generator().manual_seed(20 + n)).numpy()
             for n in (1, 5, 8, 6)]
    p20, s20 = init_preact_resnet_params(20, torch.Generator().manual_seed(SEED + 1), "cpu")
    p56, s56 = init_preact_resnet_params(56, torch.Generator().manual_seed(SEED + 1), "cpu")
    fam = {label: (build, streams, kw) for label, build, _, streams, _, kw in family_configs()}
    served_cases = [
        ("resnet20 W4A4 int4-packed", pack_qparams_int4(convert_resnet20(p20, s20, weight_bits=4, act_bits=4)),
         {"model": "resnet20", "act_bits": 4, "weight_bits": 4, "act_impl": "bins", "stream": "int16",
          "packed_int4": 1}, resnet20_int8_stream),
        ("resnet56", convert_resnet20(p56, s56),
         {"model": "resnet56", "act_bits": 8, "weight_bits": 8, "act_impl": "erf", "stream": "int16"},
         resnet20_int8_stream),
    ]
    for label in ("densenet40 f32", "densenet40 stage_int8", "mobilenetv2"):
        build, streams, kw = fam[label]
        _, (qp_cpu, _) = build(1, device="cpu", **kw)
        meta = {"model": label.split()[0], "act_bits": 8, "weight_bits": 8, "act_impl": "erf"}
        if kw.get("stage_int8"):
            meta["stage_int8"] = 1
        served_cases.append((label, qp_cpu, meta, streams))
    fam_serving = {}
    for label, qp_cpu, meta, streams in served_cases:
        path = art_dir / f"{label.replace(' ', '_')}.npz"
        save_int8_artifact(str(path), qp_cpu, meta=meta)
        fam_serving[label] = serve_artifact(label, path, streams, dev, freqs)
    for label in ("densenet40 f32", "densenet40 stage_int8", "mobilenetv2"):
        check_family_launches(f"{label} serving", fam_serving[label]["launches"], FAMILY_SERVE_BATCH)
    details["family_serving"] = fam_serving

    phase("deploy families: times")
    fam_times = {}
    for label, build, fwd, _, pack, kw in family_configs():
        for batch in FAMILY_TIME_BATCHES:
            _, (qp_b, x_b) = build(batch, device=dev, **kw)
            ops_b = pack(qp_b, **kw)  # laid out once, as an engine does
            with torch.inference_mode():
                fwd_ms = median_ms(lambda: fwd(qp_b, x_b, operands=ops_b, **kw), runs=FORWARD_RUNS)
                zero_counts(_build.launches)
                fwd(qp_b, x_b, operands=ops_b, **kw)
                torch.cuda.synchronize()
                per_fwd = {k: v for k, v in _build.launches.items() if v}
                prof = profile_step(lambda: fwd(qp_b, x_b, operands=ops_b, **kw), card,
                                    f"{label} forward batch {batch}", iters=PROFILE_ITERS) \
                    if batch == FAMILY_TIME_BATCHES[0] else None
            if per_fwd.get(K1.TAP_GATHERS, 0):
                raise AssertionError(f"{label}: a conv gathered its taps on the card")
            fam_times[f"{label} batch {batch}"] = {"ms": fwd_ms, "images_per_s": batch / fwd_ms * 1e3,
                                                   "launches_per_forward": per_fwd, "profile": prof}
            print(f"forward {label} batch {batch}: {fwd_ms:.4f} ms = {batch / fwd_ms * 1e3:.0f} images/s; "
                  f"launches a forward {per_fwd} [{card}]", flush=True)
            del qp_b, x_b, ops_b
    fam_rows = []
    for (label, batch), launches in fam_launches.items():
        if batch != SERVE_BATCH:
            continue
        for key, ((kind, args), count) in launches.items():
            ms, plain_ms, b_ms, b_by, lib_ms, pad_ms = time_launch(kind, args)
            old_ms = old_form_ms(kind, args) if kind in ("bn_table", "first") else None
            form = ("sm90" if args[3] is not None else "chunked") if kind == "bn_table" else None
            fam_rows.append(dict(family=label, kind=kind, form=form, shape=str(key), launches=count, ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                 pad_pass_ms=pad_ms, old_ms=old_ms))
            print(f"time {label} {key} x{count}: {ms:.4f} ms, plain {plain_ms:.3f}, bound {b_ms:.4f} ({b_by}), "
                  f"library {'none' if lib_ms is None else f'{lib_ms:.4f}'}"
                  f"{'' if pad_ms is None else f', the pad pass before it {pad_ms:.4f}'}"
                  f"{'' if form is None else f' (in the {form} form)'}"
                  f"{'' if old_ms is None else f', the form it replaced {old_ms:.4f}'} [{card}]", flush=True)
    details["family_times"] = {"forwards": fam_times, "launches": fam_rows}
    torch.cuda.empty_cache()

    return fam_rows, fam_err, fam_serving


# ------------------------------------------------- the ImageNet-layout trunks

TRUNKS = ("resnet18", "resnet50")
TRUNK_SIZE = 224  # ImageNet's input, the trunks' published width
TRUNK_QAT_BATCH = 28  # the DANN preset's batch (alignq_tpu/configs.py)
# the trunks' serving engine batch: each served batch is held against the
# plain path on the host, ~10 s an image of ResNet-50 at 224x224 there
TRUNK_SERVE_BATCH = 4
# (arch, batch, act_bits, act_impl) of every forward whose K1 launches are
# recorded and each held against its plain version: both trunks at the
# serving batch 256 and a ragged 3 on both A8 maps, and the A4 bins map
TRUNK_CHECKS = [(a, b, 8, impl) for a in TRUNKS for b in (SERVE_BATCH, 3) for impl in ("erf", "poly")] + [
    (a, 3, 4, "bins") for a in TRUNKS]
# K1 launches a trunk forward takes in the Hopper form (csrc/qmatmul_sm90.cu)
# by the planner's rule (qmatmul.k1_plan): every 1x1 and 3x3 conv of the
# trunks, all but the 7x7 stem (tests/test_torch_k1_sm90.py holds the rule
# to these counts)
SM90_PER_FORWARD = {"resnet18": 19, "resnet50": 52}
# K1 launches a forward takes in the narrow Hopper form (csrc/qmatmul_sm90n.cu)
# by the planner's rule (qmatmul.k1_plan, narrow_takes): ResNet-20's block-3
# skip on the slice route, with its 6 stage-1 convs on the erf route (its
# block-3 conv0 and conv1 stay in mma.sync); of DenseNet-40's 36 growth
# convs and 2 transitions and of MobileNet-V2's narrow 1x1s those the rule
# gives it at each batch (tests/test_torch_k1_narrow.py holds the rule to
# these counts)
# table launches a DenseNet-40 stage_int8 forward in the Hopper kernel
# (csrc/bn_table_sm90.cu) at every batch: the rule's four sites of at most 64
# code channels (kernels/quantize.py bn_table_takes); bn_table_kernel the other 35
BN_TABLE_SM90_PER_FORWARD = 4
NARROW_PER_FORWARD = {"resnet20 slice": 1, "resnet20 erf": 1, ("densenet40", 256): 29, ("densenet40", 8): 37,
                      ("densenet40", 3): 38, ("mobilenetv2", 256): 11, ("mobilenetv2", 8): 22, ("mobilenetv2", 3): 23}
# K1 launches a ResNet-20 forward in the plane form (csrc/qmatmul_sm90p.cu)
# at the batches of phases 6 and 7 (64, 256): the stage-1 convs, block 3's
# stride-2 conv0 and the 16x16 3x3s to 32 columns; DenseNet-40's first
# growth conv at batch 256. NARROW_PER_FORWARD's ResNet-20 counts are those
# batches' too.
PLANE_PER_FORWARD = {"resnet20 slice": 2, "resnet20 erf": 12}


def r20_forms(batch):
    """(narrow, plane): the conv_shapes names of ResNet-20's convs the rule
    gives K1's narrow form and its plane form at `batch` (the stage-1 conv
    the plane form where its items reach qmatmul.PLANE_MIN_ITEMS)."""
    from alignq_tpu_torch.kernels import qmatmul as K1

    stage1 = {"stage1 conv"}
    if batch * 4 >= K1.PLANE_MIN_ITEMS:
        return {"block3 skip"}, {"block3 conv0", "block3 conv1"} | stage1
    return {"block3 skip"} | stage1, {"block3 conv0", "block3 conv1"}


def affine_bn(model, generator):
    """The model with every BatchNorm's scale drawn in [0.7, 1.3] and bias
    N(0, 0.2) from generator: at a zero bias, uniform-grid weights and
    codes make a conv output equal its channel's batch mean, and the BN
    output is then an ulp either side of 0 by the summation order, under
    a relu (the CUDA and CPU reductions take opposite branches)."""
    import torch

    from alignq_tpu_torch.nn.layers import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.scale.uniform_(0.7, 1.3, generator=generator)
                m.bias.normal_(0.0, 0.2, generator=generator)
    return model


def trunk_card_vs_cpu(dev, arch, hw, batch=2):
    """A float64 train forward and backward of the arch's trunk, W4A4 with
    ADMM, on the card and on the CPU from one seed: the largest difference
    of the feature, every parameter gradient (of the feature against a
    fixed cotangent plus the sites' ADMM losses), the BatchNorm statistics
    and the sites' D."""
    import numpy as np
    import torch

    from alignq_tpu_torch.admm.loss import admm_loss
    from alignq_tpu_torch.models import resnet_imagenet as RI

    res = {}
    for where in ("cpu", dev):
        gen = torch.Generator().manual_seed(SEED)
        model = affine_bn(getattr(RI, f"{arch}_quant")(4, 4, admm=True, generator=gen), gen).double().to(where)
        rng = np.random.RandomState(SEED)
        x = torch.tensor(rng.randn(batch, hw, hw, 3)).to(where)
        g = torch.tensor(rng.randn(batch, model.features)).to(where)
        sink = {}
        feat = model(x, train=True, sink=sink)
        loss = (feat * g).sum()
        for n in sorted(sink):
            loss = loss + admm_loss(sink[n], torch.full_like(sink[n], 0.3), torch.full_like(sink[n], 0.1))
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        res[str(where)] = [feat, *grads, *[b for _, b in model.named_buffers()], *[sink[n] for n in sorted(sink)]]
    cpu, card = res["cpu"], res[str(dev)]
    return max(float((a.detach() - b.detach().cpu()).abs().max() / max(1.0, float(a.detach().abs().max())))
               for a, b in zip(cpu, card)), len(sink)


def k1_out(plan, op, mode):
    """A new output of a K1 launch of `plan` in `mode` (as _run_k1 makes it)."""
    import torch

    dtype = {"int32": torch.int32, "f32": torch.float32, "relu": torch.float32}.get(mode, torch.int8)
    return torch.empty((plan.B * plan.Ho * plan.Wo, op.wt.shape[0]), device=op.wt.device, dtype=dtype)


def mma_plan(x, op, plan):
    """The mma.sync form's plan (csrc/qmatmul.cu) of a launch planned in either form."""
    from alignq_tpu_torch.kernels import qmatmul as K1

    return K1.conv_plan(*x.shape, plan.ksize, plan.stride, plan.pad, *op.wt.shape)


def form_pair(x, op, p90, modes):
    """K1's Hopper form or its narrow Hopper form (plan p90) against its
    mma.sync form on the same operands in each (mode, act) of modes, by the
    raw launches (uncounted): the outputs must be bit for bit equal. Returns
    the int32 output of the Hopper form."""
    import torch

    from alignq_tpu_torch.kernels import qmatmul as K1

    pm = mma_plan(x, op, p90)
    got32 = None
    for mode, act in modes:
        a, b = k1_out(p90, op, mode), k1_out(pm, op, mode)
        K1._k1_launch(x, op, p90, a, mode, act)
        K1._k1_launch(x, op, pm, b, mode, act)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"K1's forms differ: x {tuple(x.shape)} weight {tuple(op.wt.shape)} "
                                 f"ksize {p90.ksize} stride {p90.stride} mode {mode} "
                                 f"{act.impl if act is not None else ''}: {int((a != b).sum())} elements")
        got32 = a if mode == "int32" else got32
    return got32


# the first convs phase 3 checks: columns -> (mode, relu'd) of their sites
# (ResNet-20/56: the relu'd codes of every served map; DenseNet-40: f32 and
# the stage buffer's requant; MobileNet-V2: relu'd codes), one unrelu'd map
FIRST_CHECKS = {16: (("poly", True), ("erf", True), ("bins", True), ("bins_int", True), ("erf", False)),
                24: (("f32", False), ("requant", False)), 32: (("erf", True), ("poly", True))}


def first_conv_checks(dev, gen, code_epilogue):
    """Phase 3(b): the first-conv kernel (csrc/first_conv_sm90.cu) from f32
    images at batches 2048 (ResNet-20's relu'd poly and erf codes, the main
    path's), 256 and 3 (every site of FIRST_CHECKS), through its entry point (each call
    one launch of it), against its plain version (codes and requant
    identical, f32 within one ulp on at most 1e-6 of the elements) and bit
    for bit against the chain it replaced (linear_q, K1's pad pass and
    mma.sync form, under first_conv._old_form). Returns (max abs error,
    {batch: (images, ResNet-20's packed weight)} for phase 10)."""
    import torch

    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import first_conv as FC
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels.convert import QConvInt8
    from alignq_tpu_torch.kernels.infer import S_IMG, act_int_cutpoints

    err, ops, n_cmp = 0.0, {}, 0
    for batch in (BATCH, SERVE_BATCH, 3):
        x = torch.randn((batch, 32, 32, 3), generator=gen, device=dev) * 1.3
        for n, sites in FIRST_CHECKS.items():
            kern = torch.randint(-127, 128, (3, 3, 3, n), generator=gen, device=dev, dtype=torch.int8)
            cs, cb = code_epilogue(27, n)
            op = K1.pack_conv_weights(kern, cs, cb)
            for mode, relu in sites:
                if batch == BATCH and (n != 16 or mode not in ("poly", "erf") or not relu):  # the main path's
                    continue
                o, act = op, None
                if mode == "requant":
                    o = op._replace(bias=torch.full((n,), 1.0 / 0.021, device=dev))
                elif mode == "bins_int":
                    act = K1.pack_act_cutpoints(act_int_cutpoints(QConvInt8(kern, cs, cb), 4), n)._replace(relu=relu)
                elif mode != "f32":
                    act = K1.act_map(mode, 127 if mode != "bins" else 7, dev, relu=relu)
                before = _build.launches[FC.FIRST]
                got = FC.first_conv(x, o, S_IMG, act, mode)
                with FC._old_form():
                    old = FC.first_conv(x, o, S_IMG, act, mode)
                want = FC.first_conv_reference(x, o, S_IMG, act, mode)
                torch.cuda.synchronize()
                what = f"first conv N={n} {mode}{' relu' if relu else ''} batch {batch}"
                if _build.launches[FC.FIRST] != before + 1:
                    raise AssertionError(f"{what}: the first-conv kernel was not launched once")
                bits = (lambda t: t.view(torch.int32)) if got.dtype == torch.float32 else (lambda t: t)
                if not torch.equal(bits(got), bits(old)):
                    raise AssertionError(f"{what}: {int((got != old).sum())} elements differ from the chain")
                if mode == "f32":
                    diff = f32_mismatches(got, want)
                    if diff > 1e-6 * got.numel():
                        raise AssertionError(f"{what}: {diff} f32 elements differ from the plain version")
                elif mode == "requant":
                    diff = int((got != want).sum())
                    if diff:
                        raise AssertionError(f"{what}: {diff} requant codes differ from the plain version")
                else:
                    diff = code_mismatches(got, want, what)
                err = max(err, float((got.double() - want.double()).abs().max()))
                n_cmp += 1
                print(f"{what}: differing elements {diff} of {got.numel()}; the chain's bit for bit", flush=True)
                if n == 16 and mode == "poly" and relu:
                    ops[batch] = (x, op)
            del kern, op
    print(f"the first-conv kernel: {n_cmp} launches, each bit for bit the chain it replaced", flush=True)
    return err, ops


def first_conv_row(batch, x, op, launches, card):
    """Phase 10's row of the main path's first conv (ResNet-20's, N = 16):
    the first-conv kernel from the f32 image (relu'd poly and erf codes, f32)
    by graph_ms, its plain version, the chain it replaced (linear_q, K1's
    pad pass and mma.sync form), torch._int_mm on the gathered taps of the
    padded codes, and the bound: the f32 image read once and the outputs
    written once, against 2 * M * 27 * N int8 operations."""
    import torch

    from alignq_tpu_torch.kernels import first_conv as FC
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels.infer import S_IMG

    dev = x.device
    b = x.shape[0]
    m, n = b * 1024, op.n
    plan = FC.first_plan(b, 32, n)
    maps = {impl: K1.act_map(impl, 127, dev, relu=True) for impl in ("poly", "erf")}
    out_c = torch.empty((m, n), device=dev, dtype=torch.int8)
    out_f = torch.empty((m, n), device=dev)
    code_ms = {impl: graph_ms(lambda: FC._first_launch(x, op, S_IMG, maps[impl], impl, plan, out_c), runs=LAUNCH_RUNS)
               for impl in maps}
    f32_ms = graph_ms(lambda: FC._first_launch(x, op, S_IMG, None, "f32", plan, out_f), runs=LAUNCH_RUNS)

    def chain(impl):
        with FC._old_form():
            return FC.first_conv(x, op, S_IMG, maps[impl])

    old_ms = {impl: graph_ms(lambda: chain(impl), runs=LAUNCH_RUNS) for impl in maps}
    plain_ms = {impl: median_ms(lambda: FC.first_conv_reference(x, op, S_IMG, maps[impl]), runs=PLAIN_RUNS, warmup=0)
                for impl in maps}
    cols = K1.gather_taps(K1._conv_input(FC.linear_q(x, S_IMG), op), 3, 1, 1, K1.K_MULT)
    wmat = op.wt[:n].t().contiguous()
    lib_ms = graph_ms(lambda: torch._int_mm(cols, wmat), runs=LAUNCH_RUNS)
    del cols
    bc_ms, bc_by = conv_bound(*x.shape[:3], 3, 3, 1, n, 1, itemsize=4)
    bf_ms, _ = conv_bound(*x.shape[:3], 3, 3, 1, n, 4, itemsize=4)
    print(f"time the first conv (first-conv kernel) batch {b} M={m} K=27 N={n} (tiles of {plan.R} rows): codes poly "
          f"{code_ms['poly']:.4f} ms, erf {code_ms['erf']:.4f} (the chain it replaced {old_ms['poly']:.4f}, "
          f"{old_ms['erf']:.4f}; plain {plain_ms['poly']:.3f}, {plain_ms['erf']:.3f}; bound {bc_ms:.4f} {bc_by}); "
          f"f32 {f32_ms:.4f} (bound {bf_ms:.4f}); torch._int_mm on the gathered taps {lib_ms:.4f} [{card}]", flush=True)
    return dict(batch=batch, shape="stem conv", M=m, K=27, N=n, slice_launches=launches[0], erf_launches=launches[1],
                tile=f"{plan.R} rows", form="first", poly_ms=code_ms["poly"], erf_ms=code_ms["erf"], f32_ms=f32_ms,
                plain_poly_ms=plain_ms["poly"], plain_erf_ms=plain_ms["erf"], bound_ms=bc_ms, bound_f32_ms=bf_ms,
                bound_by=bc_by, library_ms=lib_ms, pad_pass_ms=None, old_poly_ms=old_ms["poly"],
                old_erf_ms=old_ms["erf"])


def k1_form_pairs(launches_by, dev):
    """Phase 16(b): every distinct trunk launch planned in the Hopper form
    (batches 256 and 3) against the mma.sync form in every mode the trunks
    use and the rest but bins_int (int32, f32, relu, requant; erf and poly
    codes, relu'd and not; the A4 bins map, relu'd and not), bit for bit;
    then one streamed 3x3's weight cut to N/2 columns (each rank's slice
    of a model axis of 2, the column-parallel site's) in both forms, each
    slice equal to its columns of the whole. Returns the count of
    comparisons."""
    import types

    from alignq_tpu_torch.kernels import qmatmul as K1

    maps = [K1.act_map("erf", 127, dev, relu=True), K1.act_map("erf", 127, dev), K1.act_map("poly", 127, dev),
            K1.act_map("poly", 127, dev, relu=True), K1.act_map("bins", 7, dev, relu=True),
            K1.act_map("bins", 7, dev)]
    modes = [("int32", None), ("f32", None), ("relu", None), ("requant", None)] + [(m.impl, m) for m in maps]
    seen = {}
    for launches in launches_by.values():
        for (kind, args), _ in launches.values():
            x, op, plan = args[:3]
            if isinstance(plan, K1.Sm90Plan):
                seen.setdefault((tuple(x.shape), tuple(op.wt.shape), plan.ksize, plan.stride), (x, op, plan))
    for x, op, plan in seen.values():
        form_pair(x, op, plan, modes)
    n = len(seen) * len(modes)
    # the column-parallel slices of the first 3x3 at the serving batch whose
    # weight streams and whose half N the form takes (N8 % 128 == 0)
    x, op, plan = next((x, op, p) for (xs, ws, ks, _), (x, op, p) in seen.items()
                       if ks == 3 and xs[0] == SERVE_BATCH and ws[0] % 128 == 0 and mma_plan(x, op, p).n_chunks > 1)
    whole = form_pair(x, op, plan, modes[:1])
    for rank in range(2):
        part = K1.shard_k1weights(op, types.SimpleNamespace(size=2, rank=rank))
        p90 = K1.sm90_plan(*x.shape, 3, plan.stride, 1, *part.wt.shape)
        got = form_pair(x, part, p90, modes)
        w = part.n
        if not (got[:, :w] == whole[:, rank * w:(rank + 1) * w]).all():
            raise AssertionError(f"K1's N/2 slice {rank} differs from its columns of the whole")
        n += len(modes)
    print(f"K1's two forms: {len(seen)} distinct launches in the Hopper form at batches {SERVE_BATCH} and 3, "
          f"{len(modes)} modes each, and the N/2 slices of x {tuple(x.shape)} weight {tuple(op.wt.shape)} "
          f"(N {op.n} -> {op.n // 2}): {n} comparisons, every output bit for bit equal", flush=True)
    return n


def imagenet_trunks(dev, card, repo, details, phase):
    """Phases 16-19, the ImageNet-layout trunks ResNet-18 and ResNet-50 at
    224x224: every distinct K1 launch against its plain version; the
    full-width forwards on the card against the CPU; serving from the
    port's artifacts (the main path of this part, its launches counted);
    times. Returns (the batch-256 launch rows, K1's max abs error, each
    served trunk's launches and error)."""
    import numpy as np
    import torch

    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import infer_resnet_imagenet as RI
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels import stem as ST
    from alignq_tpu_torch.kernels.artifact import save_int8_artifact

    phase("ImageNet trunks: every K1 and stem launch against its plain version")
    launches_by, err, err_sm90, err_stem, diffs, check_err = {}, 0.0, 0.0, 0.0, {}, {}
    for arch, batch, bits, impl in TRUNK_CHECKS:
        _, (qp, x) = RI.build_resnet_imagenet_int8(arch, batch, device=dev, image_size=TRUNK_SIZE, act_bits=bits)
        ops = RI.pack_resnet_imagenet_operands(qp)
        zero_counts(_build.launches)
        with torch.inference_mode():
            rec = record_launches(lambda: RI.resnet_imagenet_int8_forward(qp, x, bits, impl, ops))
        torch.cuda.synchronize()
        gathers = _build.launches[K1.TAP_GATHERS]
        launches = distinct_launches(rec)
        n_diff = 0
        for key, ((kind, args), _) in launches.items():
            diff, _, e = check_launch(kind, args)
            err, n_diff = max(err, e), n_diff + diff
            check_err[id(args)] = e
            diffs[f"{arch} batch {batch} A{bits} {impl} {key}"] = diff
        stems = sum(kind == "stem" for kind, _ in rec)
        k1_stems = [k for k in launches if k[0] == "K1" and k[3] == 7]
        n_sm90 = sum(isinstance(args[2], K1.Sm90Plan) for _, args in rec)
        for (kind, args), _ in launches.values():
            if isinstance(args[2], K1.Sm90Plan):
                err_sm90 = max(err_sm90, check_err[id(args)])
            if kind == "stem":
                err_stem = max(err_stem, check_err[id(args)])
        print(f"{arch} {TRUNK_SIZE}x{TRUNK_SIZE} batch {batch} A{bits} {impl}: {len(rec)} launches ({stems} of the "
              f"stem kernel, bit for bit the chain it replaced; {n_sm90} K1 in the Hopper form), {len(launches)} "
              f"distinct, each held against its plain version: {n_diff} differing elements; tap gathers in the "
              f"forward {gathers}", flush=True)
        if (gathers or stems != 1 or k1_stems or any(kind not in ("K1", "stem") for kind, _ in rec)
                or n_sm90 != SM90_PER_FORWARD[arch]):
            raise AssertionError(f"{arch}: gathers {gathers}, {stems} stem-kernel launches, K1 7x7 launches "
                                 f"{k1_stems}, {n_sm90} launches in the Hopper form (expected "
                                 f"{SM90_PER_FORWARD[arch]})")
        launches_by[arch, batch, bits, impl] = launches
        del qp, x, ops, rec
    details["trunk_mismatches"] = diffs
    torch.cuda.empty_cache()

    phase("ImageNet trunks: K1's Hopper form against its mma.sync form, bit for bit")
    details["k1_form_pairs"] = k1_form_pairs(launches_by, dev)
    torch.cuda.empty_cache()

    phase("ImageNet trunks: full-width forwards on the card against the CPU")
    for arch in TRUNKS:
        _, (qp_cpu, x_cpu) = RI.build_resnet_imagenet_int8(arch, 2, device="cpu", image_size=TRUNK_SIZE)
        qp_gpu = to_device(qp_cpu, dev)
        with torch.inference_mode():
            got = [{k: v.cpu() for k, v in st.items()} for st in RI.resnet_imagenet_int8_streams(qp_gpu, x_cpu.to(dev))]
            f_gpu = RI.resnet_imagenet_int8_forward(qp_gpu, x_cpu.to(dev)).cpu()
        want = list(RI.resnet_imagenet_int8_streams(qp_cpu, x_cpu))
        for i, (g_, w_) in enumerate(zip(got, want)):
            for k in w_:
                if not torch.equal(g_[k], w_[k]):
                    raise AssertionError(f"{arch} stage {i} {k}: the card's differs from the CPU's")
        f_cpu = RI.resnet_imagenet_int8_forward(qp_cpu, x_cpu)
        ferr = float((f_gpu - f_cpu).abs().max()) / float(f_cpu.abs().max())
        if not (torch.isfinite(f_gpu).all() and ferr <= 1e-5 and f_gpu.shape == f_cpu.shape):
            raise AssertionError(f"{arch}: features off the CPU's by {ferr} of the largest")
        print(f"forward {arch} {TRUNK_SIZE}x{TRUNK_SIZE} batch 2: every stage's codes and stream ({len(got)} stages) "
              f"identical to the CPU's, features within {ferr:.3g} of the largest", flush=True)

    phase("ImageNet trunks: serving from artifacts (the main path)")
    art_dir = repo / "chiprun_out" / "artifacts"
    art_dir.mkdir(parents=True, exist_ok=True)
    # the block inputs' scale is the batch's max, so a request's answer
    # depends on its batch: requests that fill the engine's batches in order
    # (the last one padded), as the check below batches the images
    reqs = [torch.randn((n, TRUNK_SIZE, TRUNK_SIZE, 3), generator=torch.Generator().manual_seed(60 + i)).numpy()
            for i, n in enumerate((TRUNK_SERVE_BATCH, 3))]
    serving = {}
    for arch in TRUNKS:
        _, (qp_cpu, _) = RI.build_resnet_imagenet_int8(arch, 1, device="cpu", image_size=TRUNK_SIZE)
        path = art_dir / f"{arch}.npz"
        save_int8_artifact(str(path), qp_cpu, meta={"model": arch, "act_bits": 8, "weight_bits": 8,
                                                    "act_impl": "erf", "image_size": TRUNK_SIZE})
        serving[arch] = serve_artifact(arch, path, RI.resnet_imagenet_int8_streams, dev, reqs, feature=True,
                                       batch=TRUNK_SERVE_BATCH)
        n = serving[arch]["launches"]
        per_fwd = {"resnet18": 20, "resnet50": 53}[arch]
        forwards = n.get(ST.STEM, 0)
        if not (n.get(K1.KERNEL, 0) and n[K1.KERNEL] == per_fwd * forwards and n.get(ST.PREP, 0) == forwards
                and n.get(K1.SM90, 0) == SM90_PER_FORWARD[arch] * forwards and not n.get(K1.FORM.format(7), 0)
                and not n.get(K1.TAP_GATHERS, 0) and n.get(K1.CODES, 0) + n.get(K1.F32, 0) == n[K1.KERNEL]):
            raise AssertionError(f"serving {arch}: launches {n}, expected {per_fwd} K1 a forward, one of them "
                                 f"the stem kernel and {SM90_PER_FORWARD[arch]} in the Hopper form, and no tap "
                                 f"gather")
        print(f"serving {arch}: {forwards} forwards, {n[K1.KERNEL]} K1 launches, {n[K1.SM90]} of them in the "
              f"Hopper form ({SM90_PER_FORWARD[arch]} a forward)", flush=True)
    details["trunk_serving"] = serving

    phase("ImageNet trunks: times")
    fwd_times, rows = {}, []
    for arch in TRUNKS:
        _, (qp, x) = RI.build_resnet_imagenet_int8(arch, SERVE_BATCH, device=dev, image_size=TRUNK_SIZE)
        ops = RI.pack_resnet_imagenet_operands(qp)
        with torch.inference_mode():
            ms = median_ms(lambda: RI.resnet_imagenet_int8_forward(qp, x, operands=ops), runs=FORWARD_RUNS)
            zero_counts(_build.launches)
            RI.resnet_imagenet_int8_forward(qp, x, operands=ops)
            torch.cuda.synchronize()
            per_fwd = {k: v for k, v in _build.launches.items() if v}
            prof = profile_step(lambda: RI.resnet_imagenet_int8_forward(qp, x, operands=ops), card,
                                f"{arch} int8 forward batch {SERVE_BATCH} {TRUNK_SIZE}x{TRUNK_SIZE}",
                                iters=PROFILE_ITERS)
        fwd_times[arch] = {"ms": ms, "images_per_s": SERVE_BATCH / ms * 1e3, "launches_per_forward": per_fwd,
                           "profile": prof}
        print(f"forward {arch} int8 erf batch {SERVE_BATCH} {TRUNK_SIZE}x{TRUNK_SIZE}: {ms:.4f} ms = "
              f"{SERVE_BATCH / ms * 1e3:.0f} images/s; launches a forward {per_fwd} [{card}]", flush=True)
        del qp, x, ops
        for key, ((kind, args), count) in launches_by[arch, SERVE_BATCH, 8, "erf"].items():
            t_ms, plain_ms, b_ms, b_by, lib_ms, pad_ms = time_launch(kind, args)
            if kind == "stem":
                x, op, plan, _, act = args
                rows.append(dict(family=arch, kind=kind, shape=str(key), ksize=7, M=plan.B * plan.Hp * plan.Wp,
                                 K=147, N=op.n, form="stem_sm90", tile=f"{plan.R} pooled rows", chunks=None,
                                 n_blocks=None, launches=count, ms=t_ms, mma_ms=None, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, pad_pass_ms=pad_ms))
                print(f"time {arch} the stem kernel {key} x{count} (tiles of {plan.R} pooled rows): {t_ms:.4f} ms "
                      f"with its prep pass's {pad_ms:.4f}, plain {plain_ms:.3f}, bound {b_ms:.4f} ({b_by}) [{card}]",
                      flush=True)
                continue
            x, op, plan, mode, act, xc = args
            sm90 = isinstance(plan, K1.Sm90Plan)
            tile = f"{plan.TM} rows" if sm90 else f"{plan.TR}x{plan.TW}"
            mma_ms = None
            if sm90:  # the mma.sync form's time beside it, on the same operands
                pm, out = mma_plan(x, op, plan), k1_out(plan, op, mode)
                mma_ms = graph_ms(lambda: K1._k1_launch(x, op, pm, out, mode, act), runs=LAUNCH_RUNS)
            rows.append(dict(family=arch, kind=kind, shape=str(key), ksize=plan.ksize, M=plan.B * plan.Ho * plan.Wo,
                             K=plan.ksize ** 2 * xc, N=op.n, form="sm90" if sm90 else "mma", tile=tile,
                             chunks=plan.n_chunks, n_blocks=plan.n_blocks, launches=count, ms=t_ms, mma_ms=mma_ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, pad_pass_ms=pad_ms))
            print(f"time {arch} K1 {key} x{count} ({'Hopper' if sm90 else 'mma.sync'} form, tile {tile}, "
                  f"{plan.n_chunks} K chunks, {plan.n_blocks} N blocks): {t_ms:.4f} ms"
                  f"{'' if mma_ms is None else f' (the mma.sync form {mma_ms:.4f})'}, plain {plain_ms:.3f}, "
                  f"bound {b_ms:.4f} ({b_by}), torch._int_mm {lib_ms:.4f}"
                  f"{'' if pad_ms is None else f', the pad pass before it {pad_ms:.4f}'} [{card}]", flush=True)
        torch.cuda.empty_cache()
    details["trunk_times"] = {"forwards": fwd_times, "launches": rows}
    return rows, (err, err_sm90, err_stem), serving


def baseline_qat(dev, card, details, phase):
    """Phase 20, the QAT of the baselines and the trunk: (a) three float64
    ResNet-20 steps of each of the ten methods, W4A4 (ADMM where the
    method has sites), batch 8 of 16x16 images, BatchNorm affine drawn;
    (b) the trunks' float64 forward and backward (ResNet-18 at 64x64,
    ResNet-50 at 224x224, batch 2, W4A4 ADMM), each on the card against the
    CPU within 1e-9; (c) the ResNet-50 trunk's f32 W8A8 ADMM forward and
    backward at the DANN preset's batch 28, and the ResNet-20 W4A4 step of
    each of the ten methods at batch 128 (CUDA events, one step after a
    warm-up one), TF32 off."""
    import numpy as np
    import torch

    from alignq_tpu_torch.admm.loss import admm_loss
    from alignq_tpu_torch.models import resnet_imagenet as RIM
    from alignq_tpu_torch.models.registry import build_model
    from alignq_tpu_torch.models.resnet_cifar import ORDERING, PreActResNet
    from alignq_tpu_torch.train import TrainConfig, create_train_state, make_train_step
    from alignq_tpu_torch.train.loop import true_f32

    out = {"f64_ten_methods": {}, "f64_trunks": {}, "step_ms": {}}
    phase("QAT of the baselines: (a) float64 ResNet-20 steps of each method, the card against the CPU")
    for method in ORDERING:
        admm = ORDERING[method] == "ours"
        cfg = TrainConfig(method=method, train_batch_size=8, bitW=4, abitW=4, admm=admm, lr=0.02,
                          lr_decay_steps=(1000,))
        # uniform_admm's D is identically 0: once a site's dual Z shrinks to
        # exactly 0 (its third step here), the constraint term is sqrt(0) and
        # its gradient NaN, in the JAX package too (ROADMAP, known
        # differences of the reference): its two finite steps are compared
        steps = 2 if method == "uniform_admm" else 3
        err = qat_card_vs_cpu(dev, lambda g, m=method, a=admm: affine_bn(
            PreActResNet(num_units=(3, 3, 3), w_bit=4, a_bit=4, method=m, admm=a, generator=g), g), cfg, 16,
            21 if admm else 0, steps)
        print(f"QAT (a) ResNet-20 {method} W4A4{' ADMM' if admm else ''}: {steps} float64 steps, card vs CPU max "
              f"abs diff {err:.3g}", flush=True)
        if not err <= 1e-9:
            raise AssertionError(f"QAT (a) {method}: the card's float64 steps differ from the CPU's by {err}")
        out["f64_ten_methods"][method] = err

    phase("QAT of the baselines: (b) the trunks' float64 forward and backward, the card against the CPU")
    for arch, hw in (("resnet18", 64), ("resnet50", TRUNK_SIZE)):
        err, n_sites = trunk_card_vs_cpu(dev, arch, hw)
        print(f"QAT (b) {arch} trunk {hw}x{hw} batch 2 W4A4 ADMM ({n_sites} sites): float64 forward and backward, "
              f"card vs CPU max diff {err:.3g} of each tensor's largest (feature, gradients, statistics, D)",
              flush=True)
        if not err <= 1e-9:
            raise AssertionError(f"QAT (b) {arch}: the card's float64 values differ from the CPU's by {err}")
        out["f64_trunks"][arch] = err

    phase("QAT of the baselines: (c) times")
    true_f32()
    gen = torch.Generator().manual_seed(SEED)
    model = RIM.resnet50_quant(8, 8, admm=True, generator=gen).to(dev)
    rng = np.random.RandomState(SEED)
    x = torch.tensor(rng.randn(TRUNK_QAT_BATCH, TRUNK_SIZE, TRUNK_SIZE, 3), dtype=torch.float32, device=dev)
    params = list(model.parameters())

    def trunk_step():
        sink = {}
        feat = model(x, train=True, sink=sink)
        loss = feat.square().mean()
        for n in sorted(sink):
            loss = loss + admm_loss(sink[n], torch.zeros_like(sink[n]), torch.zeros_like(sink[n]))
        torch.autograd.grad(loss, params)

    ms = median_ms(trunk_step, runs=1, warmup=1)
    prof = profile_step(trunk_step, card, f"ResNet-50 trunk W8A8 ADMM forward+backward batch {TRUNK_QAT_BATCH}",
                        iters=1)
    out["resnet50_trunk_fwd_bwd"] = {"ms": ms, "images_per_s": TRUNK_QAT_BATCH / ms * 1e3, "profile": prof}
    print(f"QAT (c) ResNet-50 trunk W8A8 erf ADMM forward+backward, batch {TRUNK_QAT_BATCH} at {TRUNK_SIZE}x"
          f"{TRUNK_SIZE}: {ms:.3f} ms = {TRUNK_QAT_BATCH / ms * 1e3:.1f} images/s [{card}]", flush=True)
    del model, x, params
    torch.cuda.empty_cache()
    for method in ORDERING:
        # W4A4: APoT's levels exist for 2-6 bits (at W8 its 7-bit table is
        # empty, and its weights NaN, in the JAX package too)
        cfg = TrainConfig(method=method, train_batch_size=128, bitW=4, abitW=4, admm=ORDERING[method] == "ours")
        model = build_model(cfg, torch.Generator().manual_seed(SEED)).to(dev)
        state = create_train_state(torch.Generator().manual_seed(SEED), model, cfg)
        step = make_train_step(model, cfg)
        xb = torch.tensor(rng.randn(128, 32, 32, 3), dtype=torch.float32, device=dev)
        yb = torch.tensor(rng.randint(0, 10, 128), device=dev)
        ms = median_ms(lambda: step(state, xb, yb), runs=1, warmup=1)
        out["step_ms"][method] = ms
        print(f"QAT (c) ResNet-20 {method} W4A4{' ADMM' if cfg.admm else ''} step, batch 128: {ms:.3f} ms = "
              f"{128 / ms * 1e3:.0f} images/s [{card}]", flush=True)
        del model, state, step
    details["baseline_qat"] = out
    return out


def calibrated(model, generator):
    """The model with every StageRequant statistic drawn uniform in [2, 6]
    from generator: the scale of a calibrated int8 buffer."""
    from alignq_tpu_torch.nn.layers import StageRequant

    for m in model.modules():
        if isinstance(m, StageRequant):
            m.amax.uniform_(2.0, 6.0, generator=generator)
    return model


# the families' QAT phase: (label, epochs, export_int8's arguments).
# MobileNet-V2 takes the JAX package's from-scratch recipe (lr 0.01, 1
# warmup epoch; it diverges at the default 0.04) and learns the synthetic
# set slowly: 8 epochs at batch 64 (3 at batch 128 left it at chance,
# where near-equal logits make the agreement a coin toss; 6 at batch 64
# left it at 12% top-1 with 99.02% agreement)
FAMILY_QAT = (
    ("densenet40 f32", 3, ["--model", "densenet40", "--deploy_exact", "--batch", "128"]),
    ("densenet40 stage_int8", 3, ["--model", "densenet40", "--stage_int8", "--batch", "128"]),
    ("mobilenetv2", 8, ["--model", "mobilenetv2", "--deploy_exact", "--lr", "0.01", "--warmup_epochs", "1",
                        "--batch", "64"]),
)
FAMILY_QAT_ARGS = ["--dataset", "synthetic", "--bits", "8", "--variant", "int8", "--cdf_impl", "erf",
                   "--print_freq", "1"]
FAMILY_QAT_TIME_BATCH = 128


def family_qat(dev, card, repo, phase):
    """Phase 9, the QAT of DenseNet-40 (both stage buffers) and
    MobileNet-V2: (a) float64 steps on the card against the CPU; (b) each
    family trained at full width through export_int8.main on the synthetic
    set; (c) exported, its artifact served on the card and held against
    the CPU plain path; (d) the train step's times at batch 128 with ADMM."""
    import math
    import shutil

    import numpy as np
    import torch

    from alignq_tpu_torch import export_int8
    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import infer_densenet as D
    from alignq_tpu_torch.kernels import infer_mobilenet as M
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.models.densenet import DenseNet
    from alignq_tpu_torch.models.mobilenetv2 import mobile_v2
    from alignq_tpu_torch.models.registry import build_model
    from alignq_tpu_torch.train import TrainConfig, create_train_state, make_train_step
    from alignq_tpu_torch.train.loop import true_f32

    out = {}
    phase("QAT of the families: (a) float64 steps, the card against the CPU")
    # W4A4, as phase 8(a): at W8A8 the correction's bin phase (255 bins, a
    # sawtooth of slope 2040 in the weight's CDF) grows a difference in the
    # conv's summation order by orders of magnitude a step, on the CPU
    # alone too, past 1e-9 in 3 steps of MobileNet-V2. The int8 buffer's
    # statistics start where a calibrated net's are: ema's first update
    # would seed them with the batch's max, which then sits on the clip
    # bound to within an ulp, where the gradient is 0, 1/2 or 1.
    cfg = TrainConfig(train_batch_size=8, bitW=4, abitW=4, admm=True, lr=0.02, lr_decay_steps=(1000,),
                      correction_exclude=())
    q = dict(variant="int8", deploy_exact=True, admm=True)
    f64_cases = (
        ("DenseNet depth 10 stage_int8 ema", 16, 9, lambda g: calibrated(DenseNet(
            depth=10, w_bit=4, a_bit=4, stage_int8=True, stage_calib="ema", generator=g, **q), g)),
        ("DenseNet depth 10 f32 buffer", 16, 9, lambda g: DenseNet(depth=10, w_bit=4, a_bit=4, generator=g, **q)),
        ("MobileNet-V2", 16, 67, lambda g: mobile_v2(bitW=4, abitW=4, generator=g, **q)),
    )
    out["card_vs_cpu_f64_max_abs"] = {}
    for label, hw, n_sites, build in f64_cases:
        err = qat_card_vs_cpu(dev, build, cfg, hw, n_sites)
        print(f"QAT families (a) {label}: 3 float64 steps, W4A4 ADMM + correction, batch 8 of {hw}x{hw}: card vs "
              f"CPU max abs diff {err:.3g} (params, statistics and amax, duals)", flush=True)
        if not err <= 1e-9:
            raise AssertionError(f"QAT families (a) {label}: the card's float64 steps differ from the CPU's by {err}")
        out["card_vs_cpu_f64_max_abs"][label] = err

    requests = [torch.randn((n, 32, 32, 3), generator=torch.Generator().manual_seed(40 + n)).numpy()
                for n in (1, 7, 8, 5)]
    streams = {"densenet40 f32": D.densenet40_int8_buffers, "densenet40 stage_int8": D.densenet40_int8_buffers,
               "mobilenetv2": M.mobilenetv2_int8_streams}
    out["trained"] = {}
    for label, epochs, args in FAMILY_QAT:
        phase(f"QAT of the families: (b, c) {label}: train, export, serve")
        job = repo / "chiprun_out" / f"qat_{label.replace(' ', '_')}"
        shutil.rmtree(job, ignore_errors=True)
        art = job / "net.npz"
        zero_counts(_build.launches)
        t0 = time.perf_counter()
        with deterministic_cudnn():
            rep = export_int8.main(FAMILY_QAT_ARGS + args + ["--epochs", str(epochs), "--job_dir", str(job),
                                                             "--save", str(art)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        export_launches = {k: v for k, v in _build.launches.items() if v}
        shutil.rmtree(job / "checkpoint")  # tens of MB a family: chiprun_out brings back 64 MiB
        losses = [json.loads(line)["loss"] for line in (job / "run" / "train.jsonl").read_text().splitlines()]
        print(f"QAT families (b) {label} W8A8 int8 deploy_exact erf, batch {args[args.index('--batch') + 1]}, "
              f"{epochs} epochs: {len(losses)} steps, "
              f"train + export {run_s:.1f} s; loss first {losses[0]:.4f} last {losses[-1]:.4f}, mean of the first "
              f"and last quarter {np.mean(losses[: len(losses) // 4]):.4f} {np.mean(losses[-(len(losses) // 4):]):.4f}",
              flush=True)
        evals = len((job / "run" / "test.jsonl").read_text().splitlines())
        if evals != epochs or rep["state"].step != len(losses) or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"QAT families (b) {label}: {rep['state'].step} steps, losses {losses[:3]}...")
        q = max(1, len(losses) // 4)  # the mean loss of the last quarter of the steps below the first's
        if not sum(losses[-q:]) < sum(losses[:q]):
            raise AssertionError(f"QAT families (b) {label}: the loss did not fall ({losses[:q]} -> {losses[-q:]})")
        print(f"QAT families (c) {label} export: fake-quant top-1 {rep['fq_top1']:.2f}, INT top-1 "
              f"{rep['int_top1']:.2f}, delta {rep['delta']:+.2f} pts, prediction agreement {rep['agreement']:.2f}% "
              f"(logit margins (fake-quant, INT) where they disagree {rep['disagree_margins']}, median fake-quant "
              f"top-1 less top-2 {rep['median_margin']:.4g}, INT - fake-quant logit gap largest "
              f"{rep['max_logit_gap']:.4g} median {rep['median_logit_gap']:.4g}); launches {export_launches}",
              flush=True)
        if rep["agreement"] < 99.0:
            raise AssertionError(f"QAT families (c) {label}: prediction agreement {rep['agreement']:.2f}% < 99.0%")
        check_family_launches(f"{label} export", export_launches)
        served = serve_artifact(f"QAT-trained {label}", art, streams[label], dev, requests)
        check_family_launches(f"{label} trained, served", served["launches"], FAMILY_SERVE_BATCH)
        k1_modes = {k: v for k, v in served["launches"].items() if k.startswith(K1.MODE.format(""))}
        print(f"QAT families (c) {label} served: K1 by epilogue mode {k1_modes}", flush=True)
        out["trained"][label] = dict(steps=len(losses), run_s=run_s, loss_first=losses[0], loss_last=losses[-1],
                                     fq_top1=rep["fq_top1"], int_top1=rep["int_top1"], delta=rep["delta"],
                                     agreement=rep["agreement"], disagree_margins=rep["disagree_margins"],
                                     median_margin=rep["median_margin"], max_logit_gap=rep["max_logit_gap"],
                                     median_logit_gap=rep["median_logit_gap"], export_launches=export_launches,
                                     served=served)
        del rep
        torch.cuda.empty_cache()

    phase("QAT of the families: (d) step times")
    true_f32()
    out["step_times"] = {}
    for label, target, extra in (
        ("densenet40 f32", "densenet_40_quant", {}),
        ("densenet40 stage_int8", "densenet_40_quant", {"stage_int8": True}),
        ("mobilenetv2", "mobile_v2", {}),
    ):
        tcfg = TrainConfig(target_model=target, train_batch_size=FAMILY_QAT_TIME_BATCH, admm=True, variant="int8",
                           deploy_exact=True, correction_exclude=(), **extra)
        model = build_model(tcfg, torch.Generator().manual_seed(SEED)).to(dev)
        state = create_train_state(torch.Generator().manual_seed(SEED), model, tcfg)
        step = make_train_step(model, tcfg)
        rng = np.random.RandomState(SEED)
        x = torch.tensor(rng.randn(FAMILY_QAT_TIME_BATCH, 32, 32, 3), dtype=torch.float32, device=dev)
        y = torch.tensor(rng.randint(0, 10, FAMILY_QAT_TIME_BATCH), device=dev)
        # 2 steps timed, none profiled: the profiler's processing of a
        # step's 30,000-70,000 launches takes ~25 s (phase 11 profiles one)
        ms = median_ms(lambda: step(state, x, y), runs=2, warmup=1)
        print(f"QAT step {label} batch {FAMILY_QAT_TIME_BATCH} W8A8 erf ADMM: {ms:.3f} ms/step = "
              f"{FAMILY_QAT_TIME_BATCH / ms * 1e3:.0f} images/s [{card}]", flush=True)
        out["step_times"][label] = {"ms_per_step": ms, "images_per_s": FAMILY_QAT_TIME_BATCH / ms * 1e3}
        del model, state, step, x, y
        torch.cuda.empty_cache()
    return out


def agreement_study(repo, card):
    """python3 chip_smoke.py --agreement-study: phase 9(b, c)'s training and
    export without the gate, MobileNet-V2 three times under cuDNN's default
    algorithms (which vary run to run) at seed 0, and each family under the
    deterministic ones at seed 1; one JSON line a run: top-1s, agreement,
    the logit margins where the INT graph and the fake-quant eval
    disagree, and the gap between their logits."""
    import shutil

    from alignq_tpu_torch import export_int8

    runs = [("mobilenetv2", 0, False)] * 3 + [("mobilenetv2", 1, True), ("densenet40 f32", 1, True),
                                             ("densenet40 stage_int8", 1, True)]
    family = {label: (epochs, args) for label, epochs, args in FAMILY_QAT}
    for label, seed, deterministic in runs:
        epochs, args = family[label]
        job = repo / "chiprun_out" / f"study_{label.replace(' ', '_')}"
        shutil.rmtree(job, ignore_errors=True)
        with deterministic_cudnn() if deterministic else contextlib.nullcontext():
            rep = export_int8.main(FAMILY_QAT_ARGS + args + ["--epochs", str(epochs), "--job_dir", str(job),
                                                             "--seed", str(seed)])
        shutil.rmtree(job)
        print(json.dumps({"family": label, "seed": seed, "cudnn_deterministic": deterministic,
                          "fq_top1": rep["fq_top1"], "int_top1": rep["int_top1"], "agreement": rep["agreement"],
                          "disagree_margins": rep["disagree_margins"], "median_margin": rep["median_margin"],
                          "max_logit_gap": rep["max_logit_gap"], "median_logit_gap": rep["median_logit_gap"],
                          "card": card}), flush=True)


# ------------------------------------------------------ domain adaptation

DA_F64_CASES = ("digit", "dann", "dsan", "mdd")
# the digit DANN trained and gated in phase 22: W8A8 erf on the int8 grid,
# 28x28 at the preset's batch 128 and lr .01, 5 epochs (70 steps) of the
# synthetic mnist -> mnistm pair; the JAX package's tools/export_da_int8.py
# on the same arguments reaches 100.00% agreement on the CPU
DA_EXPORT_ARGS = ["--task", "digit", "--bits", "8", "--epochs", "5", "--batch", "128", "--lr", "0.01", "--seed", "0"]
DA_AGREEMENT_GATE = 99.0
DIGIT_TIME_BATCHES = (256, 2048)  # the 5x5 form's timed batches
DA_SERVE_BATCH = 2  # the engine batch of the DA trunks' serving (the CPU holds each batch to its plain path)


def engine_times(path, dev, batch, card, label):
    """An engine of the artifact at `batch` on the card, timed on the host
    clock: one-image requests (median and max of ENGINE_RUNS), then a
    backlog of ENGINE_BACKLOG full batches (images/s)."""
    import numpy as np

    from alignq_tpu_torch.serve import engine_from_artifact

    engine = engine_from_artifact(str(path), batch_size=batch, device=dev)
    x = np.random.RandomState(SEED).uniform(-1, 1, (batch, *engine.input_shape)).astype(np.float32)
    lat = []
    for _ in range(ENGINE_RUNS):
        t0 = time.perf_counter()
        engine.submit(x[:1]).result(timeout=300)
        lat.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for f in [engine.submit(x) for _ in range(ENGINE_BACKLOG)]:
        f.result(timeout=300)
    backlog_s = time.perf_counter() - t0
    engine.close()
    out = {"engine_batch": batch, "one_image_ms_p50": statistics.median(lat), "one_image_ms_max": max(lat),
           "backlog_images_per_s": ENGINE_BACKLOG * batch / backlog_s}
    print(f"serving times {label}, engine batch {batch}: one-image request {out['one_image_ms_p50']:.2f} ms median "
          f"({out['one_image_ms_max']:.2f} max); {ENGINE_BACKLOG} x {batch} images "
          f"{out['backlog_images_per_s']:.0f} images/s "
          f"[{card}]", flush=True)
    return out


def da_f64_case(case, gen):
    """(model, DAConfig, image side, step maker, head prefixes, ramps) of
    one float64 card-vs-CPU case: W4A4 with ADMM, batch 4, ResNet-18 trunks
    at 32x32, the BatchNorm affine drawn."""
    import torch

    from alignq_tpu_torch.models import DANN, DSAN, MDDNet, MNISTModelQuant
    from alignq_tpu_torch.train import da as TDA

    q = dict(w_bit=4, a_bit=4, admm=True, generator=gen)
    model, hw, step, heads, excl = {
        "digit": (lambda: MNISTModelQuant(**q), 28, TDA.make_dann_train_step, TDA.DANN_HEADS, ()),
        "dann": (lambda: DANN("resnet18", 5, **q), 32, TDA.make_dann_train_step, TDA.DANN_HEADS, ("feature/conv1",)),
        "dsan": (lambda: DSAN("resnet18", 5, **q), 32, TDA.make_dsan_train_step, TDA.DSAN_HEADS,
                 ("feature_layers/conv1",)),
        "mdd": (lambda: MDDNet("resnet18", 5, 32, 32, **q), 32, TDA.make_mdd_train_step, TDA.MDD_HEADS,
                ("base_network/conv1",)),
    }[case]
    cfg = TDA.DAConfig(train_batch_size=4, bitW=4, abitW=4, admm=True, lr=0.01,
                       num_classes=10 if case == "digit" else 5, correction_exclude=excl,
                       use_correction=case != "digit")
    ramps = [0.0, 0.46, 0.76] if case == "dsan" else [TDA.grl_alpha(p, torch.float64) for p in (0.0, 0.3, 0.6)]
    return affine_bn(model(), gen), cfg, hw, step, heads, ramps

def da_card_vs_cpu(dev, case, steps=3):
    """`steps` float64 DA train steps on the card and on the CPU from one
    seed (the dropouts' masks from the same CPU generators on both):
    the largest difference of the params, the BatchNorm statistics and the
    duals."""
    import numpy as np
    import torch

    from alignq_tpu_torch.train import da as TDA

    states = {}
    for where in ("cpu", dev):
        gen = torch.Generator().manual_seed(SEED)
        model, cfg, hw, make_step, heads, ramps = da_f64_case(case, gen)
        model = model.double().to(where)
        state = TDA.create_da_state(gen, model, cfg, (1, hw, hw, 3), 10, heads)
        step = make_step(model, cfg)
        rng = np.random.RandomState(SEED)
        for r in ramps[:steps]:
            xs, xt = (torch.tensor(rng.randn(4, hw, hw, 3)).to(where) for _ in range(2))
            step(state, xs, torch.tensor(rng.randint(0, cfg.num_classes, 4)).to(where), xt, r)
        states[str(where)] = state
    cpu, card = states["cpu"], states[str(dev)]
    pairs = [(cpu.params[k], card.params[k]) for k in cpu.params]
    pairs += [(cpu.batch_stats[k], card.batch_stats[k]) for k in cpu.batch_stats]
    for k, s in cpu.admm_duals.items():
        pairs += [(s.alter_d, card.admm_duals[k].alter_d), (s.gamma, card.admm_duals[k].gamma)]
    if not cpu.admm_duals or card.step != steps:
        raise AssertionError(f"DA f64 {case}: {len(cpu.admm_duals)} ADMM sites, {card.step} steps")
    diffs = [float((a.detach() - b.detach().cpu()).abs().max()) for a, b in pairs]
    return float("nan") if any(math.isnan(d) for d in diffs) else max(diffs)


def digit_kernel_checks(qp, dev, card):
    """The digit graph's launches at batches 3, 256 and 2048 (seeded images
    in [-1, 1]) recorded: two of the digit kernel (csrc/digit_sm90.cu, conv
    1 and conv 2, each with its codes and pool) and no K1, every distinct
    one held against its plain version and bit for bit against the chain
    it replaced; at 256 and 2048 each timed (time_launch) beside the
    chain's time. Returns (the time rows, max abs error, differing
    elements)."""
    import torch

    from alignq_tpu_torch.kernels import infer_digit as DG

    ops = DG.pack_mnist_dann_operands(qp)
    rows, err, n_diff = [], 0.0, 0
    for batch in (3, *DIGIT_TIME_BATCHES):
        x = torch.rand((batch, 28, 28, 3), generator=torch.Generator().manual_seed(batch)).to(dev) * 2 - 1
        with torch.inference_mode():
            rec = record_launches(lambda: DG.mnist_dann_int8_forward(qp, x, operands=ops))
        launches = distinct_launches(rec)
        if [kind for kind, _ in rec] != ["digit", "digit"] or [args[2].conv for _, args in rec] != [1, 2]:
            raise AssertionError(f"digit forward batch {batch}: launches {list(launches)}, expected the digit "
                                 f"kernel's conv 1 and conv 2")
        for key, ((kind, args), count) in launches.items():
            diff, _, e = check_launch(kind, args)
            err, n_diff = max(err, e), n_diff + diff
            if batch not in DIGIT_TIME_BATCHES:
                continue
            t_ms, plain_ms, b_ms, b_by, lib_ms, pad_ms = time_launch(kind, args)
            old_ms = old_form_ms(kind, args)
            plan = args[2]
            rows.append(dict(family="digit_dann", batch=batch, shape=str(key), conv=plan.conv, tile=plan.IMG,
                             warpgroups=plan.n_wg, launches=count, ms=t_ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms, pad_pass_ms=pad_ms, old_ms=old_ms))
            print(f"time digit conv{plan.conv} {key} batch {batch} (tiles of {plan.IMG} images, {plan.n_wg} "
                  f"warpgroups): {t_ms:.4f} ms{'' if pad_ms is None else f' with its prep pass {pad_ms:.4f}'}, "
                  f"the chain it replaced {old_ms:.4f}, plain {plain_ms:.3f}, bound {b_ms:.4f} ({b_by}) [{card}]",
                  flush=True)
        print(f"digit forward batch {batch}: 2 launches of the digit kernel, each held against its plain version "
              f"and the chain: {n_diff} differing elements so far", flush=True)
    return rows, err, n_diff


def da_digit(dev, card, repo, details, phase):
    """Phase 22, the digit DANN: (b) trained at full width through
    export_da_int8 under cuDNN's deterministic algorithms, (c) its INT
    graph gated against its fake-quant eval, (d) its artifact served on the
    card (2 launches of the digit kernel a forward) and held to the CPU
    plain path; then its launches checked and timed. Returns (time rows,
    their max abs error, the served launches and error)."""
    import torch

    from alignq_tpu_torch import export_da_int8
    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import digit as DSm
    from alignq_tpu_torch.kernels import infer_digit as DG
    from alignq_tpu_torch.kernels import qmatmul as K1

    phase("DA (b, c): the digit DANN trained and exported on the card")
    job = repo / "chiprun_out" / "da_job"
    art = repo / "chiprun_out" / "artifacts" / "digit_dann.npz"
    art.parent.mkdir(parents=True, exist_ok=True)
    zero_counts(_build.launches)
    t0 = time.perf_counter()
    with deterministic_cudnn():
        rep = export_da_int8.main(DA_EXPORT_ARGS + ["--job_dir", str(job), "--save", str(art)])
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    n = {k: v for k, v in _build.launches.items() if v}
    print(f"DA (b, c) digit DANN W8A8 erf batch 128, 5 epochs ({rep['state'].step} steps) in {export_s:.1f} s: target "
          f"fake-quant top-1 {rep['fq_top1']:.2f}, INT top-1 {rep['int_top1']:.2f}, delta {rep['delta']:+.2f} pts, "
          f"prediction agreement {rep['agreement']:.2f}% (gate {DA_AGREEMENT_GATE}), disagreeing margins "
          f"{rep['disagree_margins']}, median margin {rep['median_margin']:.4g}, logit gap max "
          f"{rep['max_logit_gap']:.4g} median {rep['median_logit_gap']:.4g}; launches {n} [{card}]", flush=True)
    ks5 = n.get(DSm.DIGIT, 0)
    if not (ks5 and ks5 % 2 == 0 and n.get(K1.KERNEL) == ks5 and not n.get(K1.FORM.format(5), 0) and
            not n.get(K1.TAP_GATHERS, 0)):
        raise AssertionError(f"DA (c): launches {n}: expected the digit kernel only, two a forward, no tap gather")
    if rep["agreement"] < DA_AGREEMENT_GATE:
        raise AssertionError(f"DA (c): prediction agreement {rep['agreement']:.2f}% is below {DA_AGREEMENT_GATE}%")
    out = {k: rep[k] for k in ("fq_top1", "int_top1", "delta", "agreement", "disagree_margins", "median_margin",
                               "max_logit_gap", "median_logit_gap", "best_tgt_top1")}
    out.update(export_s=export_s, steps=rep["state"].step, export_launches=n)

    phase("DA (d): the digit DANN served from its artifact")
    reqs = [(torch.rand((k, 28, 28, 3), generator=torch.Generator().manual_seed(70 + k)) * 2 - 1).numpy()
            for k in (FAMILY_SERVE_BATCH, 3)]
    served = serve_artifact("digit_dann", art, DG.mnist_dann_int8_codes, dev, reqs)
    n = served["launches"]
    # the engine's warm-up forward and the two requests' batches
    if not (n.get(DSm.DIGIT) == 2 * 3 == n.get(K1.KERNEL) == n.get(K1.MODE.format("erf")) and
            n.get(DSm.PREP) == 3 and not n.get(K1.FORM.format(5), 0)):
        raise AssertionError(f"serving digit_dann: launches {n}, expected 2 launches of the digit kernel (erf codes) "
                             "and one prep pass a forward over 3 forwards, none of K1's 5x5 form")
    out["serving"] = served
    out["serving_times"] = engine_times(art, dev, SERVE_BATCH, card, "digit_dann")

    phase("DA: the digit DANN's launches against their plain version and the chain, and times")
    qp = rep["qparams"]
    rows, err, n_diff = digit_kernel_checks(qp, dev, card)
    with torch.inference_mode():
        ops = DG.pack_mnist_dann_operands(qp)
        for batch in DIGIT_TIME_BATCHES:
            x = torch.rand((batch, 28, 28, 3), device=dev) * 2 - 1
            ms = median_ms(lambda: DG.mnist_dann_int8_forward(qp, x, operands=ops))
            out[f"forward_ms_batch_{batch}"] = ms
            print(f"forward digit_dann int8 erf batch {batch}: {ms:.4f} ms = {batch / ms * 1e3:.0f} images/s "
                  f"[{card}]", flush=True)
    out.update(kernel_rows=rows, k1_max_abs_err=err, k1_differing=n_diff)
    details["da_digit"] = out
    return rows, err, served


def da_trunk_configs():
    """(task, preset or None, model builder, step maker, head prefixes,
    engine requests) of phase 23: the DANN preset on ResNet-50 (W8A8 ADMM,
    batch 28), the DSAN preset (W4A4, bottleneck 256, batch 32), and an
    MDD net (W8A8 ADMM, batch 28) in brief."""
    from alignq_tpu_torch import configs
    from alignq_tpu_torch.models import mddnet, resnet50_dann, resnet50_dsan
    from alignq_tpu_torch.train import da as TDA

    return [
        ("dann", configs.dann_office_d2w_w8a8_admm(), lambda c, g: resnet50_dann(8, 8, admm=True, generator=g),
         TDA.make_dann_train_step, TDA.DANN_HEADS),
        ("dsan", configs.dsan_office_a2w_w4a4(), lambda c, g: resnet50_dsan(4, 4, bottle_neck=True, generator=g),
         TDA.make_dsan_train_step, TDA.DSAN_HEADS),
        ("mdd", TDA.DAConfig(train_batch_size=28, admm=True, correction_exclude=("base_network/conv1",)),
         lambda c, g: mddnet(8, 8, admm=True, num_classes=31, generator=g), TDA.make_mdd_train_step,
         TDA.MDD_HEADS),
    ]


def da_trunks(dev, card, repo, details, phase):
    """Phase 23, the DA nets on the ImageNet-layout ResNet-50 at 224x224:
    each trained 3 timed steps at its batch (seeded images on the card),
    converted on the CPU, every K1 launch of its INT forward at batch 4
    held against its plain version,
    DANN's class and domain logits on the card against the CPU, and its
    artifact served at engine batch DA_SERVE_BATCH and held to the CPU
    plain path. Returns {task: served launches and error}, K1's max abs
    error."""
    import torch

    from alignq_tpu_torch.interop import deploy_tree
    from alignq_tpu_torch.kernels import infer_resnet_imagenet as RI
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels import stem as ST
    from alignq_tpu_torch.kernels.artifact import save_int8_artifact
    from alignq_tpu_torch.kernels.deploy_registry import DEPLOY_FAMILIES
    from alignq_tpu_torch.train import da as TDA
    from alignq_tpu_torch.train.loop import true_f32

    true_f32()
    out, serving, k1_err = {}, {}, 0.0
    tmp = tempfile.mkdtemp()
    for task, cfg, build, make_step, heads in da_trunk_configs():
        phase(f"DA (e, f): {task} on ResNet-50 at {TRUNK_SIZE}x{TRUNK_SIZE}, batch {cfg.train_batch_size}")
        gen = torch.Generator().manual_seed(SEED)
        model = build(cfg, gen).to(dev)
        b = cfg.train_batch_size
        state = TDA.create_da_state(gen, model, cfg, (1, TRUNK_SIZE, TRUNK_SIZE, 3), 1000, heads)
        step = make_step(model, cfg)
        dg = torch.Generator(device=dev).manual_seed(SEED)
        xs, xt = (torch.randn((b, TRUNK_SIZE, TRUNK_SIZE, 3), generator=dg, device=dev) for _ in range(2))
        ys = torch.randint(0, 31, (b,), generator=dg, device=dev)
        ramp = 0.5
        step_ms, losses = [], []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            _, m = step(state, xs, ys, xt, ramp)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
        print(f"DA {task} ResNet-50 W{cfg.bitW}A{cfg.abitW}{' ADMM' if cfg.admm else ''} step, batch {b} at "
              f"{TRUNK_SIZE}x{TRUNK_SIZE}: {[round(t, 3) for t in step_ms]} ms (median "
              f"{statistics.median(step_ms):.3f} = {b / statistics.median(step_ms) * 1e3:.1f} images/s); losses "
              f"{[round(v, 4) for v in losses]} [{card}]", flush=True)
        if not all(math.isfinite(v) for v in losses) or state.step < 3:
            raise AssertionError(f"DA {task}: losses {losses}, {state.step} steps")
        meta = {"model": task, "arch": "resnet50", "weight_bits": cfg.bitW, "act_bits": cfg.abitW, "act_impl": "erf",
                "image_size": TRUNK_SIZE, "num_classes": 31, **({"bottle_neck": 1} if task == "dsan" else {})}
        fam = DEPLOY_FAMILIES[task]
        params, stats = deploy_tree(model)
        qp_cpu = fam.convert(to_device(params, "cpu"), to_device(stats, "cpu"), meta)
        del model, state, step, xs, xt, params, stats
        torch.cuda.empty_cache()
        qp = to_device(qp_cpu, dev)
        fwd = fam.forward(meta)
        ops = fam.operands(qp, meta)
        x4 = torch.randn((4, TRUNK_SIZE, TRUNK_SIZE, 3), generator=torch.Generator().manual_seed(80))
        with torch.inference_mode():
            rec = record_launches(lambda: fwd(qp, x4.to(dev), operands=ops))
        launches = distinct_launches(rec)
        n_diff = 0
        for key, ((kind, args), _) in launches.items():
            diff, _, e = check_launch(kind, args)
            k1_err, n_diff = max(k1_err, e), n_diff + diff
        n_stem = sum(kind == "stem" for kind, _ in rec)
        print(f"DA {task} INT forward batch 4: {len(rec)} launches ({n_stem} of the stem kernel), {len(launches)} "
              f"distinct, each held against its plain version (the stem also against its chain): {n_diff} "
              f"differing elements", flush=True)
        if len(rec) != 53 or n_stem != 1:
            raise AssertionError(f"DA {task}: {len(rec)} launches a forward ({n_stem} of the stem kernel), expected "
                                 f"ResNet-50's 53, one of them the stem kernel")
        rec_out = {"step_ms": step_ms, "losses": losses, "k1_distinct": len(launches),
                   "k1_differing": n_diff}
        if task == "dann":
            with torch.inference_mode():
                got = [t.cpu() for t in RI.dann_int8_forward(qp["trunk"], qp["heads"], x4[:2].to(dev),
                                                             operands=ops)]
            want = RI.dann_int8_forward(qp_cpu["trunk"], qp_cpu["heads"], x4[:2])
            err = max(float((g_ - w_).abs().max()) / max(1.0, float(w_.abs().max())) for g_, w_ in zip(got, want))
            print(f"DA dann INT forward batch 2: class and domain logits on the card within {err:.3g} of the CPU's",
                  flush=True)
            if not err <= 1e-5:
                raise AssertionError(f"DA dann: logits off the CPU's by {err}")
            rec_out["card_vs_cpu_logits"] = err
        # a ResNet-50 artifact is ~25 MB: a temporary file, deleted once served
        path = Path(tmp) / f"{task}_resnet50.npz"
        save_int8_artifact(str(path), qp_cpu, meta=meta)
        reqs = [torch.randn((k, TRUNK_SIZE, TRUNK_SIZE, 3), generator=torch.Generator().manual_seed(90 + k)).numpy()
                for k in (DA_SERVE_BATCH, 1)]

        def streams(p, x, operands=None, **kw):
            return RI.resnet_imagenet_int8_streams(p["trunk"], x, operands=operands, **kw)

        served = serve_artifact(f"{task} resnet50", path, streams, dev, reqs, batch=DA_SERVE_BATCH)
        n = served["launches"]
        if not (n.get(K1.KERNEL) == 53 * 3 and n.get(ST.STEM) == 3 and not n.get(K1.FORM.format(7), 0)
                and not n.get(K1.TAP_GATHERS, 0)):
            raise AssertionError(f"serving {task}: launches {n}, expected 53 K1 a forward (one the stem kernel) over 3")
        serving[task] = served
        rec_out["serving"] = served
        if task == "dann":
            rec_out["serving_times"] = engine_times(path, dev, FAMILY_SERVE_BATCH, card, "dann resnet50")
        out[task] = rec_out
        del qp, ops, qp_cpu
        path.unlink()
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    details["da_trunks"] = out
    return serving, k1_err


def da_phase(dev, card, repo, details, phase):
    """Phases 21-23: domain adaptation. (a) float64 card-vs-CPU steps,
    then the digit DANN (phase 22) and the trunk nets (phase 23)."""
    phase("DA (a): float64 DA train steps, the card against the CPU")
    f64 = {}
    for case in DA_F64_CASES:
        err = da_card_vs_cpu(dev, case)
        print(f"DA (a) {case} W4A4 ADMM batch 4: 3 float64 steps, card vs CPU max abs diff {err:.3g} (params, "
              "BatchNorm statistics, duals)", flush=True)
        if not err <= 1e-9:
            raise AssertionError(f"DA (a) {case}: the card's float64 steps differ from the CPU's by {err}")
        f64[case] = err
    details["da_f64"] = f64
    digit_rows, digit_err, digit_served = da_digit(dev, card, repo, details, phase)
    trunk_served, trunk_err = da_trunks(dev, card, repo, details, phase)
    return digit_rows, digit_err, digit_served, trunk_served, trunk_err


# ------------------------------------------------ data-parallel training

DP_STEPS = 4  # phase 24(b)'s float64 ResNet-20 gather steps
DP_BATCH = 16  # their global batch, 32x32 images
DP_TIME_BATCH = 128  # the global batch of the timed steps (phase 24(d))
DP_JOB_ARGS = QAT_JOB_ARGS + ["--deterministic"]


def dp_resnet20(dev, bits=8, num_units=(3, 3, 3), batch=DP_BATCH, mode="gather", compression="f32", admm=True,
                dtype="float64"):
    """(model, state, config, batches) of the data-parallel phases: a
    PreActResNet (ResNet-20 by default) with ADMM and the correction,
    weights, duals and DP_STEPS batches of 32x32 images from SEED."""
    import numpy as np
    import torch

    from alignq_tpu_torch.models.resnet_cifar import PreActResNet
    from alignq_tpu_torch.train import TrainConfig, create_train_state

    gen = torch.Generator().manual_seed(SEED)
    cfg = TrainConfig(train_batch_size=batch, bitW=bits, abitW=bits, admm=admm, lr=0.02, lr_decay_steps=(1000,),
                      corr_mode=mode, grad_compression=compression)
    model = PreActResNet(num_units=num_units, w_bit=bits, a_bit=bits, admm=admm, generator=gen)
    model = model.to(getattr(torch, dtype)).to(dev)
    state = create_train_state(gen, model, cfg, input_shape=(1, 32, 32, 3), steps_per_epoch=10_000)
    rng = np.random.RandomState(SEED)
    batches = [(torch.tensor(rng.randn(batch, 32, 32, 3), dtype=getattr(torch, dtype)),
                torch.tensor(rng.randint(0, 10, batch))) for _ in range(DP_STEPS)]
    return model, state, cfg, batches


def dp_dann(dev):
    """The DANN gather pair's (model, state, config, step maker, batches):
    da_f64_case('dann') (ResNet-18 trunk at 32x32, W4A4 ADMM, batch 4),
    two steps."""
    import numpy as np
    import torch

    from alignq_tpu_torch.train import da as TDA

    gen = torch.Generator().manual_seed(SEED)
    model, cfg, hw, make_step, heads, ramps = da_f64_case("dann", gen)
    model = model.double().to(dev)
    state = TDA.create_da_state(gen, model, cfg, (1, hw, hw, 3), 10, heads)
    rng = np.random.RandomState(SEED)
    batches = [(torch.tensor(rng.randn(4, hw, hw, 3)), torch.tensor(rng.randint(0, cfg.num_classes, 4)),
                torch.tensor(rng.randn(4, hw, hw, 3)), r) for r in ramps[:2]]
    return model, state, cfg, make_step, batches


def state_tensors(state) -> dict:
    """A train state's params, statistics and duals, on the CPU."""
    out = {f"p:{k}": v.detach().cpu() for k, v in state.params.items()}
    out.update({f"b:{k}": v.detach().cpu() for k, v in state.batch_stats.items()})
    for k, s in state.admm_duals.items():
        out[f"a:{k}"], out[f"g:{k}"] = s.alter_d.cpu(), s.gamma.cpu()
    return out


def max_diff(a: dict, b: dict) -> float:
    if set(a) != set(b):
        raise AssertionError(f"states of other tensors: {sorted(set(a) ^ set(b))[:4]}")
    d = [float((a[k].double() - b[k].double()).abs().max()) for k in a]
    return float("nan") if any(math.isnan(x) for x in d) else max(d)


def rows_of(t, rank, n):
    b = t.shape[0] // n
    return t[rank * b:(rank + 1) * b]


def comm_share(fn, iters=3):
    """(ms a call, collectives' ms in one call): host clock around iters
    calls, each synchronized (median); the collectives' time from
    torch.profiler over one more (processing a trace of a step's ~12,000
    launches takes seconds): gloo's work on its threads (events 'gloo:*')
    and NCCL's kernels on the card."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    comm_us = 0.0
    for e in prof.key_averages():
        if e.key.startswith("gloo:"):
            comm_us += e.cpu_time_total
        elif "nccl" in e.key.lower() and not e.key.startswith(("c10d::", "nccl:")):
            comm_us += getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
    return statistics.median(times), comm_us / 1e3


@contextlib.contextmanager
def timed_collectives(log: list, barrier: bool, labels=None):
    """Within the block, every collective that the port's steps issue
    (torch.distributed's all_reduce, all_gather_into_tensor,
    reduce_scatter_tensor and broadcast) is timed alone on the host clock,
    the card synchronized before and after it, and (its name, its ms)
    appended to `log`; labels: {id(process group): label}, a collective on
    a labelled group named 'name:label'. With `barrier`, a barrier of its
    group comes first, so that both ranks enter it together and its time
    is the transfer without the wait for the other rank."""
    import torch
    import torch.distributed as dist

    def timed(name, f):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            group = kwargs.get("group")
            if barrier:
                dist.barrier(group=group)
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            torch.cuda.synchronize()
            label = (labels or {}).get(id(group))
            log.append((f"{name}:{label}" if label else name, (time.perf_counter() - t0) * 1e3))
            return out
        return call

    saved = {name: getattr(dist, name) for name in COLLECTIVES + ("broadcast",)}
    for name, f in saved.items():
        setattr(dist, name, timed(name, f))
    try:
        yield log
    finally:
        for name, f in saved.items():
            setattr(dist, name, f)


COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce")


def split_collectives(step, labels=None) -> dict:
    """The collectives of one distributed step, timed alone: 'in_calls_ms'
    (each call's own time) and 'transfer_ms' (a barrier before each), from
    the median of 3 steps each, every step started by the ranks together;
    the count of calls and each op's calls and transfer ms (labels: as
    timed_collectives', each labelled group's ops counted apart)."""
    import torch
    import torch.distributed as dist

    out = {}
    for label, barrier in (("in_calls", False), ("transfer", True)):
        logs = []
        for _ in range(3):
            dist.barrier()
            with timed_collectives([], barrier, labels) as log:
                step()
            logs.append(log)
        log = sorted(logs, key=lambda g: sum(ms for _, ms in g))[1]
        out[f"{label}_ms"] = torch.tensor(sum(ms for _, ms in log))
    out["calls"] = torch.tensor(len(log))
    for op in sorted({name for name, _ in log} | set(COLLECTIVES)):
        out[f"transfer_ms:{op}"] = torch.tensor(sum(ms for name, ms in log if name == op))
        out[f"calls:{op}"] = torch.tensor(sum(name == op for name, _ in log))
    return out


def allreduce_row_grad(ctx, g):
    """The row gather's backward in its earlier form, for the comparison of
    --gather-backward-ab: an all-reduce of all N*b rows' gradients, of
    which each rank keeps its own (now a reduce-scatter)."""
    import torch.distributed as dist

    g = g.contiguous().clone()
    dist.all_reduce(g, group=ctx.axis.group)
    r = ctx.axis.rank * ctx.rows
    return g[r:r + ctx.rows], None


def gather_backward_ab(repo, card) -> None:
    """python3 chip_smoke.py --gather-backward-ab: the ResNet-20 W8A8 ADMM
    f32 gather step at DP_TIME_BATCH over two gloo ranks sharing the card,
    the row gather's backward an all-reduce of all rows (its earlier form)
    or a reduce-scatter, run in the order all-reduce, reduce-scatter,
    reduce-scatter, all-reduce: ms a step (host clock, median of 5) and the
    transfer by op. One JSON line a run."""
    tmp = Path(tempfile.mkdtemp(prefix="alignq_ab_"))
    try:
        for variant in ("allreduce", "reducescatter", "reducescatter", "allreduce"):
            ranks = run_dp_ranks(repo, 2, [("cuda:0", f"rowgrad_{variant}")], tmp)[0]
            rows = [{"ms_per_step": float(r["rowgrad"]["ms"]), "transfer_ms": float(r["rowgrad"]["transfer_ms"]),
                     "by_op": {op: [int(r["rowgrad"][f"calls:{op}"]), float(r["rowgrad"][f"transfer_ms:{op}"])]
                               for op in COLLECTIVES}} for r in ranks]
            print(json.dumps({"row_gather_backward": variant, "card": card, "ranks": rows}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dp_rank_main(argv) -> int:
    """python3 chip_smoke.py --dp-rank RANK N PORT DEVICE OUT CASES: one
    gloo rank of phase 24(b, d), its results saved to OUT ({rank} filled
    in). CASES, comma-separated: gather (DP_STEPS float64 ResNet-20 W8A8
    ADMM steps), local (one local int8_gather step of a depth-8 PreAct
    W4A4), dann (the DANN pair), times (gather and local f32 steps at
    DP_TIME_BATCH), rowgrad_allreduce or rowgrad_reducescatter (the
    gather step of --gather-backward-ab)."""
    import torch
    import torch.distributed as dist

    from alignq_tpu_torch.dist import make_mesh, multihost
    from alignq_tpu_torch.dist.corr import create_local_duals
    from alignq_tpu_torch.train import make_train_step

    rank, n, port, device, out_path, cases = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4], argv[5]
    dev = multihost.initialize(f"127.0.0.1:{port}", n, rank, device=device, backend="gloo", timeout_s=600)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((n,), ("data",))
    res = {}
    for case in cases.split(","):
        if case == "gather":
            model, state, cfg, batches = dp_resnet20(dev)
            step = make_train_step(model, cfg, mesh)
            for x, y in batches:
                step(state, rows_of(x, rank, n).to(dev), rows_of(y, rank, n).to(dev))
            res["gather"] = state_tensors(state)
        elif case == "local":
            model, state, cfg, batches = dp_resnet20(dev, 4, (1, 1, 1), 8, "local", "int8_gather")
            state.admm_duals = create_local_duals(torch.Generator().manual_seed(SEED + 1), sorted(state.admm_duals),
                                                  cfg, n, rank, torch.float64, dev)
            x, y = batches[0]
            make_train_step(model, cfg, mesh)(state, rows_of(x, rank, n).to(dev), rows_of(y, rank, n).to(dev))
            res["local"] = state_tensors(state)
        elif case == "dann":
            model, state, cfg, make_step, batches = dp_dann(dev)
            import dataclasses

            step = make_step(model, dataclasses.replace(cfg, mesh_shape=(n,), mesh_axes=("data",)), mesh)
            for xs, ys, xt, r in batches:
                step(state, *(rows_of(t, rank, n).to(dev) for t in (xs, ys, xt)), r)
            res["dann"] = state_tensors(state)
        elif case == "times":
            for mode in ("gather", "local"):
                model, state, cfg, batches = dp_resnet20(dev, 8, (3, 3, 3), DP_TIME_BATCH, mode, dtype="float32")
                if mode == "local":
                    state.admm_duals = create_local_duals(torch.Generator().manual_seed(SEED + 1),
                                                          sorted(state.admm_duals), cfg, n, rank, device=dev)
                step = make_train_step(model, cfg, mesh)
                x, y = (rows_of(t, rank, n).to(dev) for t in batches[0])
                ms, comm = comm_share(lambda: step(state, x, y))
                res[f"times_{mode}"] = {"ms": torch.tensor(ms), "comm_ms": torch.tensor(comm),
                                        **split_collectives(lambda: step(state, x, y))}
        elif case in ("rowgrad_allreduce", "rowgrad_reducescatter"):
            if case == "rowgrad_allreduce":
                from alignq_tpu_torch.dist import collectives

                collectives._GatherRows.backward = staticmethod(allreduce_row_grad)
            model, state, cfg, batches = dp_resnet20(dev, 8, (3, 3, 3), DP_TIME_BATCH, "gather", dtype="float32")
            step = make_train_step(model, cfg, mesh)
            x, y = (rows_of(t, rank, n).to(dev) for t in batches[0])
            step(state, x, y)
            ts = []
            for _ in range(5):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, x, y)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            res["rowgrad"] = {"ms": torch.tensor(statistics.median(ts)), **split_collectives(lambda: step(state, x, y))}
    torch.save(res, out_path.format(rank=rank))
    multihost.shutdown()
    return 0


def run_dp_ranks(repo, n, groups, out_dir, timeout=600):
    """For each (device, cases) of `groups`, n ranks of dp_rank_main, all
    started at once (subprocesses of this interpreter, never forked: CUDA
    is initialized here); returns each group's ranks' results."""
    import torch

    from alignq_tpu_torch.entry import free_port

    env = {**os.environ, "PYTHONPATH": str(repo)}
    runs = []
    for i, (device, cases) in enumerate(groups):
        port, out = str(free_port()), str(out_dir / f"dp_{i}_{{rank}}.pt")
        runs.append((device, cases, out, [subprocess.Popen(
            [sys.executable, str(repo / "chip_smoke.py"), "--dp-rank", str(r), str(n), port, device, out, cases],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]))
    try:
        for device, cases, _, procs in runs:
            for r, p in enumerate(procs):
                log, _ = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    raise AssertionError(f"data-parallel rank {r} ({device}, {cases}) exited {p.returncode}:\n"
                                         f"{log[-4000:]}")
    finally:
        for *_, procs in runs:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return [[torch.load(out.format(rank=r), weights_only=True) for r in range(n)] for _, _, out, _ in runs]


def dp_phase(dev, card, repo, details, phase):
    """Phase 24: data-parallel training over torch.distributed (one
    process a device). The machine has one card, and NCCL refuses two
    ranks on one card, so the cross-rank equalities run two gloo ranks
    sharing it; NCCL runs at world size 1, which still runs every
    wrapper."""
    from alignq_tpu_torch.entry import free_port

    out = {}
    out_dir = repo / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="alignq_dp_"))  # the ranks' states and the job: too large to bring back

    # (c)'s torchrun job starts first and trains beside (a) and (b): host-bound
    # ranks on their own cores; (a) and (b) time nothing
    job = tmp / "dp_job"
    env = {**os.environ, "PYTHONPATH": str(repo)}
    job_log = open(out_dir / "dp_job.log", "w")
    t0 = time.perf_counter()
    torchrun = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                                 "--master_addr", "127.0.0.1", "--master_port", str(free_port()), "-m",
                                 "alignq_tpu_torch.train.cli", "--mesh", "2", "--multihost", "--dist_backend", "gloo",
                                 *DP_JOB_ARGS, "--job_dir", str(job)], env=env, stdout=job_log,
                                stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        _dp_checks(dev, card, repo, details, phase, out, tmp, torchrun, t0, job)
    finally:
        if torchrun.poll() is None:  # a check failed first: the job and its ranks stop with the run
            os.killpg(torchrun.pid, signal.SIGKILL)
            torchrun.wait()
        job_log.close()


def _dp_checks(dev, card, repo, details, phase, out, tmp, torchrun, t0, job):
    """dp_phase's checks, (a) to (e), with (c)'s torchrun job running."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from alignq_tpu_torch import export_int8
    from alignq_tpu_torch.data import native_augment
    from alignq_tpu_torch.data import datasets
    from alignq_tpu_torch.data.augment import augment_normalize as numpy_augment
    from alignq_tpu_torch.data.augment import normalize
    from alignq_tpu_torch.dist import make_mesh, multihost
    from alignq_tpu_torch.dist.corr import create_local_duals
    from alignq_tpu_torch.dist.mesh import Mesh
    from alignq_tpu_torch.entry import free_port
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels import stage_kernel as K3
    from alignq_tpu_torch.kernels.infer import resnet20_int8_stream
    from alignq_tpu_torch.train import make_train_step

    out_dir = repo / "chiprun_out"

    # (a) NCCL at world size 1 on the card
    phase("data parallel (a): NCCL at world size 1, float64 steps against the plain step")
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    mesh = make_mesh((1,), ("data",))
    gloo = Mesh(("data",), (1,), dist.new_group(backend="gloo"), 0)
    errs = {}
    for mode, compression in (("gather", "f32"), ("local", "f32"), ("local", "bf16"), ("local", "int8_gather")):
        finals = {}
        for label, where, m in (("plain", dev, None), ("nccl", dev, mesh), ("gloo cpu", "cpu", gloo)):
            if m is None and compression != "f32":
                continue
            model, state, cfg, batches = dp_resnet20(where, 4, (1, 1, 1), 8, mode, compression)
            step = make_train_step(model, cfg, m)
            for x, y in batches[:3]:
                step(state, x.to(where), y.to(where))
            finals[label] = state_tensors(state)
        ref = "plain" if compression == "f32" else "gloo cpu"
        errs[f"{mode}/{compression}"] = max_diff(finals["nccl"], finals[ref])
        print(f"data parallel (a) {mode} {compression}, 3 float64 steps at world size 1 through NCCL: max abs diff "
              f"{errs[f'{mode}/{compression}']:.3g} against the {ref} step", flush=True)
    if not all(e <= 1e-12 for e in errs.values()):
        raise AssertionError(f"data parallel (a): world-1 steps off their reference: {errs}")
    out["world1_nccl_max_abs"] = errs
    times = {}
    for mode in ("gather", "local"):
        model, state, cfg, batches = dp_resnet20(dev, 8, (3, 3, 3), DP_TIME_BATCH // 2, mode, dtype="float32")
        step = make_train_step(model, cfg, mesh)
        x, y = (t.to(dev) for t in batches[0])
        ms, comm = comm_share(lambda: step(state, x, y))
        times[f"nccl world 1, {mode}"] = {"ms_per_step": ms, "comm_ms": comm, "comm_share": comm / ms}
    multihost.shutdown()

    # (b) two gloo ranks sharing the card
    phase("data parallel (b): two gloo ranks sharing the card against one process")
    ranks, cpu_ranks = run_dp_ranks(repo, 2, [("cuda:0", "gather,local,dann,times"), ("cpu", "local")], tmp)
    model, state, cfg, batches = dp_resnet20(dev)
    step = make_train_step(model, cfg)
    for x, y in batches:
        step(state, x.to(dev), y.to(dev))
    one = state_tensors(state)
    model, state, cfg, make_step, dbatches = dp_dann(dev)
    dstep = make_step(model, cfg)
    for xs, ys, xt, r in dbatches:
        dstep(state, xs.to(dev), ys.to(dev), xt.to(dev), r)
    dann_one = state_tensors(state)
    b_err = {"resnet20 gather vs one process": max(max_diff(r["gather"], one) for r in ranks),
             "local int8_gather card vs CPU": max(max_diff(r["local"], c["local"]) for r, c in zip(ranks, cpu_ranks)),
             "dann gather vs one process": max(max_diff(r["dann"], dann_one) for r in ranks)}
    print(f"data parallel (b), 2 gloo ranks on one card: ResNet-20 W8A8 ADMM, {DP_STEPS} float64 gather steps at "
          f"global batch {DP_BATCH}, against one process on the card: {b_err['resnet20 gather vs one process']:.3g}; "
          f"a local int8_gather step, the card's ranks against the CPU's: "
          f"{b_err['local int8_gather card vs CPU']:.3g}; the DANN pair (ResNet-18 trunk, 32x32, W4A4 ADMM, 2 steps) "
          f"against one process: {b_err['dann gather vs one process']:.3g} (max abs, params, statistics, duals)",
          flush=True)
    if not all(e <= 1e-9 for e in b_err.values()):
        raise AssertionError(f"data parallel (b): {b_err}")
    out["two_rank_max_abs"] = b_err

    # (c) torchrun: the training CLI over two ranks, export, serve
    phase("data parallel (c): torchrun of the training CLI over 2 gloo ranks, export, serve through K1/K3")
    rc = torchrun.wait(timeout=900)
    train_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"data parallel (c): torchrun exited {rc}:\n"
                             f"{(out_dir / 'dp_job.log').read_text()[-4000:]}")
    losses = [json.loads(line)["loss"] for line in (job / "run" / "train.jsonl").read_text().splitlines()]
    if len(losses) != 64 or not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"data parallel (c): {len(losses)} steps, losses {losses[:2]} ... {losses[-2:]}")
    if not (job / "logger.p1.log").is_file():
        raise AssertionError("data parallel (c): rank 1 kept no log of its own")
    path = tmp / "dp_resnet20.npz"
    from alignq_tpu_torch.kernels import _build

    zero_counts(_build.launches)
    with deterministic_cudnn():
        rep = export_int8.main(["--dataset", "synthetic", "--bits", "8", "--variant", "int8", "--cdf_impl", "poly",
                                "--deploy_exact", "--admm", "--epochs", "2", "--batch", "64", "--job_dir", str(job),
                                "--resume", "--stage_kernel", "--save", str(path)])
    torch.cuda.synchronize()
    export_launches = {k: v for k, v in _build.launches.items() if v}
    print(f"data parallel (c) torchrun --nproc_per_node 2 of train.cli --mesh 2 --multihost (gloo, one card): "
          f"{len(losses)} steps in {train_s:.1f} s (beside (a) and (b)), loss {losses[0]:.4f} -> {losses[-1]:.4f}; export from rank 0's "
          f"checkpoint: fake-quant top-1 {rep['fq_top1']:.2f}, INT top-1 {rep['int_top1']:.2f}, prediction "
          f"agreement {rep['agreement']:.2f}%; launches {export_launches}", flush=True)
    if rep["state"].step != 64 or rep["agreement"] < 99.0:
        raise AssertionError(f"data parallel (c): step {rep['state'].step}, agreement {rep['agreement']:.2f}%")
    images = normalize(datasets.synthetic(seed=0)[2][:40], datasets.CIFAR10_MEAN, datasets.CIFAR10_STD)
    served = serve_artifact("the 2-rank trained ResNet-20", path, resnet20_int8_stream, dev,
                            [images[:1], images[1:8], images[8:24], images[24:40]], batch=16)
    poly = K1.MODE.format("poly")
    for label, counts in (("export", export_launches), ("serving", served["launches"])):
        if not (counts.get(K1.KERNEL, 0) > 0 and counts.get(poly, 0) == counts[K1.KERNEL]
                and counts.get(K3.KERNEL, 0) > 0 and counts.get(K3.SM90, 0) == counts[K3.KERNEL]
                and not counts.get(K1.TAP_GATHERS, 0)):
            raise AssertionError(f"data parallel (c) {label}: launches {counts}")
    out["torchrun"] = {"train_s": train_s, "loss_first": losses[0], "loss_last": losses[-1], "fq_top1": rep["fq_top1"],
                       "int_top1": rep["int_top1"], "agreement": rep["agreement"], "serving": served}

    # (d) times
    phase("data parallel (d): step times per rank and the collectives' share")
    for r, res in enumerate(ranks):
        for mode in ("gather", "local"):
            t = res[f"times_{mode}"]
            times[f"gloo 2 ranks on one card, {mode}, rank {r}"] = {
                "ms_per_step": float(t["ms"]), "comm_ms": float(t["comm_ms"]),
                "comm_share": float(t["comm_ms"]) / float(t["ms"]), "calls": int(t["calls"]),
                "in_calls_ms": float(t["in_calls_ms"]), "transfer_ms": float(t["transfer_ms"]),
                "wait_ms": float(t["in_calls_ms"]) - float(t["transfer_ms"]),
                "transfer_by_op": {op: [int(t[f"calls:{op}"]), float(t[f"transfer_ms:{op}"])] for op in COLLECTIVES}}
    for k, v in times.items():
        split = (f"; timed alone (median of 3 steps): {v['calls']} collectives, {v['in_calls_ms']:.2f} ms in the "
                 f"calls, of which transfer {v['transfer_ms']:.2f} (a barrier before each; [calls, ms] by op "
                 f"{v['transfer_by_op']}) and waiting for the other rank {v['wait_ms']:.2f}" if "calls" in v else "")
        print(f"data parallel (d) ResNet-20 W8A8 ADMM f32 step, {DP_TIME_BATCH // 2} images a rank, {k}: "
              f"{v['ms_per_step']:.2f} ms a step, in gloo calls or NCCL kernels {v['comm_ms']:.2f} ms "
              f"({v['comm_share']:.3f}){split} [{card}; one card: not a multi-card figure]", flush=True)
    out["times"] = times

    # (e) the native augment library against numpy
    phase("data parallel (e): the native augment library against numpy's path")
    lib = native_augment.build(tmp)  # the run's own directory: the checkout's build directory stays as it was
    x = np.random.RandomState(SEED).randint(0, 256, (2048, 32, 32, 3)).astype(np.uint8)
    r_np, r_nat = np.random.RandomState(1), np.random.RandomState(1)
    want = numpy_augment(x, r_np, datasets.CIFAR10_MEAN, datasets.CIFAR10_STD)
    got = native_augment.augment_normalize(x, r_nat, datasets.CIFAR10_MEAN, datasets.CIFAR10_STD, library=lib)
    err = float(np.abs(got - want).max())
    same_draws = all(np.array_equal(a, b) for a, b in zip(r_np.get_state(), r_nat.get_state()))
    host = {}
    for label, fn in (("native", lambda: native_augment.augment_normalize(x, np.random.RandomState(1),
                                                                          datasets.CIFAR10_MEAN, datasets.CIFAR10_STD,
                                                                          library=lib)),
                      ("numpy", lambda: numpy_augment(x, np.random.RandomState(1), datasets.CIFAR10_MEAN,
                                                      datasets.CIFAR10_STD))):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        host[label] = statistics.median(ts)
    print(f"data parallel (e) native augment ({lib.name}) at batch 2048: {host['native']:.2f} ms, numpy "
          f"{host['numpy']:.2f} ms (host clock, median of 5); max abs diff {err:.3g}, the same draws: {same_draws}",
          flush=True)
    if not (same_draws and err <= 1e-5):
        raise AssertionError(f"data parallel (e): draws equal {same_draws}, max abs diff {err}")
    out["native_augment"] = {"native_ms": host["native"], "numpy_ms": host["numpy"], "max_abs_err": err}
    details["data_parallel"] = out
    shutil.rmtree(tmp, ignore_errors=True)


TP_FIT_MESHES = ((1, 2), (2, 2))  # phase 25(b)'s meshes, (data, model)
TP_SERVE = (("resnet20 slice route", 8), ("resnet20 erf route", 8), ("densenet40 stage_int8", 4),
            ("resnet18 trunk 224", 4))  # phase 25(c)'s nets and engine batches
TP_SERVE_REQUESTS = 2  # full engine batches a net's requests
TP_RATE_BATCH = 256  # the engine batch of the served images/s (the slice route)
TP_RATE_BATCHES = 4


def _n_counter(K1):
    """Wrap K1's launch sites (qmatmul._run_k1, and the stem kernel's and
    the first-conv kernel's, stem._stem_launch and first_conv._first_launch,
    which count as K1's launches) so that each launch
    adds its weight's N (the output channels it writes) to the returned
    dict's 'n'; returns (counter, undo). A sharded stem weight (N/2 a rank)
    is not the stem kernel's: it runs K1's 7x7 form, through _run_k1."""
    from alignq_tpu_torch.kernels import first_conv as FC
    from alignq_tpu_torch.kernels import stem as ST

    seen = {"n": 0}
    run, run_stem, run_first = K1._run_k1, ST._stem_launch, FC._first_launch

    def counted(x, op, *args, **kwargs):
        seen["n"] += op.n
        return run(x, op, *args, **kwargs)

    def counted_stem(xq, op, *args, **kwargs):
        seen["n"] += op.n
        return run_stem(xq, op, *args, **kwargs)

    def counted_first(x, op, *args, **kwargs):
        seen["n"] += op.n
        return run_first(x, op, *args, **kwargs)

    def undo():
        K1._run_k1, ST._stem_launch, FC._first_launch = run, run_stem, run_first

    K1._run_k1, ST._stem_launch, FC._first_launch = counted, counted_stem, counted_first
    return seen, undo


def tp_rank_main(argv) -> int:
    """python3 chip_smoke.py --tp-rank RANK N PORT SPEC: one gloo rank of
    phase 25 sharing the card, its results saved to the spec's out
    ({rank} filled in). The spec (JSON): 'fit', a mesh (data, model) for
    DP_STEPS float64 ResNet-20 W8A8 ADMM gather steps at global batch
    DP_BATCH with the kernels column-parallel; 'times', a mesh for the f32
    step at DP_TIME_BATCH (ms a step, the collectives by op and group);
    'serve', meshes over which each artifact of 'artifacts' ([path,
    batch]) is served through engine_from_artifact, rank 0 submitting the
    requests of 'requests' (an .npz, 'i/j'), each rank counting its K1
    launches and the N they write; 'rate', [path, batch, n]: rank 0's
    images/s over n full batches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from alignq_tpu_torch.dist import make_mesh, multihost
    from alignq_tpu_torch.dist.sharding import shard_model, whole_model
    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.serve import engine_from_artifact
    from alignq_tpu_torch.train import make_train_step

    rank, n, port = int(argv[0]), int(argv[1]), argv[2]
    with open(argv[3]) as f:
        spec = json.load(f)
    dev = multihost.initialize(f"127.0.0.1:{port}", n, rank, backend="gloo", timeout_s=600)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    res = {}

    def placed(shape, **kw):
        mesh = make_mesh(tuple(shape), ("data", "model"))
        model, state, cfg, batches = dp_resnet20(dev, **kw)
        state.tx.shards = {k: (v.axis, v.dim) for k, v in shard_model(model, mesh).items()}
        return mesh, model, state, cfg, batches

    if "fit" in spec:
        mesh, model, state, cfg, batches = placed(spec["fit"])
        step = make_train_step(model, cfg, mesh)
        for x, y in batches:
            step(state, rows_of(x, mesh.rank, mesh.n_data).to(dev), rows_of(y, mesh.rank, mesh.n_data).to(dev))
        shards = state.tx.shards
        out = state_tensors(state)
        out.update({f"t:{k}": v.detach().cpu() for k, v in state.tx.trace.items()})
        res["fit"] = {"state": out, "sharded": sorted(shards),
                      "whole": {f"p:{k}": v.detach().cpu() for k, v in whole_model(model).named_parameters()}}
    if "times" in spec:
        mesh, model, state, cfg, batches = placed(spec["times"], batch=DP_TIME_BATCH, dtype="float32")
        step = make_train_step(model, cfg, mesh)
        x, y = (rows_of(t, mesh.rank, mesh.n_data).to(dev) for t in batches[0])
        step(state, x, y)
        ts = []
        for _ in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, x, y)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        labels = {id(mesh.model_group): "model", id(mesh.group): "data"}
        res["times"] = {"ms": torch.tensor(statistics.median(ts)),
                        **split_collectives(lambda: step(state, x, y), labels)}
    reqs = np.load(spec["requests"]) if "requests" in spec else None
    for shape in spec.get("serve", []):
        mesh = make_mesh(tuple(shape), ("data", "model"))
        for i, (path, batch) in enumerate(spec["artifacts"]):
            zero_counts(_build.launches)
            seen, undo = _n_counter(K1)
            try:
                engine = engine_from_artifact(path, batch, mesh=mesh)
                outs = ([engine.submit(reqs[f"{i}/{j}"]).result(timeout=300) for j in range(TP_SERVE_REQUESTS)]
                        if rank == 0 else [])
                engine.close()
            finally:
                undo()
            torch.cuda.synchronize()
            res[f"serve/{shape[0]}x{shape[1]}/{i}"] = {
                "logits": [torch.from_numpy(o) for o in outs], "k1": _build.launches.get(K1.KERNEL, 0),
                "k3": _build.launches.get("stage_identity_blocks", 0), "k1_n": seen["n"],
                "taps": _build.launches.get(K1.TAP_GATHERS, 0)}
    if "rate" in spec:
        path, batch, nb = spec["rate"]
        for shape in spec["serve"]:
            mesh = make_mesh(tuple(shape), ("data", "model"))
            engine = engine_from_artifact(path, batch, mesh=mesh)
            if rank == 0:
                x = np.random.RandomState(SEED).randn(batch, 32, 32, 3).astype(np.float32)
                engine.submit(x).result(timeout=300)
                t0 = time.perf_counter()
                for f in [engine.submit(x) for _ in range(nb)]:
                    f.result(timeout=300)
                res[f"rate/{shape[0]}x{shape[1]}"] = torch.tensor(nb * batch / (time.perf_counter() - t0))
            engine.close()
    torch.save(res, spec["out"].format(rank=rank))
    multihost.shutdown()
    return 0


def run_tp_ranks(repo, n, spec, out_dir, timeout=600):
    """n ranks of tp_rank_main on `spec`, started at once (subprocesses of
    this interpreter); returns each rank's results. Every rank is stopped
    when one fails or outlasts the timeout."""
    import torch

    from alignq_tpu_torch.entry import free_port

    path = out_dir / f"tp_spec_{n}.json"
    spec = dict(spec, out=str(out_dir / f"tp_{n}_{{rank}}.pt"))
    path.write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": str(repo)}
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, str(repo / "chip_smoke.py"), "--tp-rank", str(r), str(n), port,
                               str(path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        for r, p in enumerate(procs):
            log, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"tensor-parallel rank {r} of {n} exited {p.returncode}:\n{log[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(spec["out"].format(rank=r), weights_only=True) for r in range(n)]


def fma_on_the_card(dev):
    """Phase 25(a): K1's f32 epilogue (__fmaf_rn) against the plain version
    (quant/cdf.py fma_f32) on acc * scale + bias operands at, just above
    and just below f32 rounding midpoints: acc = 4096 + i, scale = 2^-12
    (1 + j 2^-12) with i j odd make acc * scale an f32 midpoint; bias 0,
    +-2^-60, +-2^-70, +-2^-40. Returns (mismatches, the elements where a
    float64 add and one cast would round otherwise, elements)."""
    import numpy as np
    import torch

    from alignq_tpu_torch.kernels import qmatmul as K1

    iv = [i for i in range(1, 95, 2)]
    jv = [j for j in range(1, 120, 2)]
    dcs = (0.0, 2.0**-60, -(2.0**-60), 2.0**-70, -(2.0**-70), 2.0**-40, -(2.0**-40))
    x = np.zeros((len(iv), 64), np.int8)
    x[:, :32] = 127
    x[:, 32] = np.array(iv) + 32  # acc = 32 * 127 + 32 + i = 4096 + i against all-ones weights
    scale = np.repeat(np.array([2.0**-12 * (1 + j * 2.0**-12) for j in jv], np.float32), len(dcs))
    bias = np.tile(np.array(dcs, np.float32), len(jv))
    w = np.ones((64, scale.size), np.int8)
    xt, wt = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    st, bt = torch.from_numpy(scale).to(dev), torch.from_numpy(bias).to(dev)
    got = K1.int8_matmul_dequant(xt, wt, st, bt).cpu()
    want = K1.int8_matmul_dequant_reference(xt.cpu(), wt.cpu(), st.cpu(), bt.cpu())
    acc = (x.astype(np.float64) @ w.astype(np.float64))
    twice = torch.from_numpy((acc * scale.astype(np.float64) + bias.astype(np.float64)).astype(np.float32))
    mism = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    return mism, int((twice.view(torch.int32) != want.view(torch.int32)).sum()), want.numel()


def tp_artifacts(out_dir):
    """Phase 25(c)'s artifacts, from seeded random weights: [(label, path,
    batch, image size)]."""
    from alignq_tpu_torch.kernels import infer_resnet_imagenet as RI
    from alignq_tpu_torch.kernels.artifact import save_int8_artifact
    from alignq_tpu_torch.kernels.infer import build_resnet20_int8
    from alignq_tpu_torch.kernels.infer_densenet import build_densenet40_int8

    _, (r20, _) = build_resnet20_int8(1, device="cpu", seed=SEED)
    _, (dn, _) = build_densenet40_int8(1, device="cpu", seed=SEED, stage_int8=True)
    _, (trunk, _) = RI.build_resnet_imagenet_int8("resnet18", 1, device="cpu", image_size=TRUNK_SIZE)
    metas = [(r20, {"model": "resnet20", "act_impl": "poly", "stream": "int16", "use_stage_kernel": 1}, 32),
             (r20, {"model": "resnet20", "act_impl": "erf", "stream": "int16"}, 32),
             (dn, {"model": "densenet40", "act_impl": "erf", "stage_int8": 1, "depth": 40}, 32),
             (trunk, {"model": "resnet18", "act_impl": "erf", "image_size": TRUNK_SIZE}, TRUNK_SIZE)]
    out = []
    for (label, batch), (qp, meta, hw) in zip(TP_SERVE, metas):
        path = out_dir / f"tp_{len(out)}.npz"
        save_int8_artifact(str(path), qp, meta={"act_bits": 8, "weight_bits": 8, **meta})
        out.append((label, path, batch, hw))
    return out


def tp_phase(dev, card, repo, details, phase):
    """Phase 25: tensor parallelism and mesh serving, gloo ranks sharing
    the one card (NCCL refuses two ranks on one card): (a) the fma_f32
    repair against K1's epilogue; (b) ResNet-20 W8A8 ADMM float64 gather
    fits on meshes (1, 2) and (2, 2) against one process; (c) serving over
    meshes (1, 2), (2, 1) and (2, 2) against the one-process engine, bit
    for bit; (d) times, one card with gloo through the host."""
    import numpy as np
    import torch

    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.serve import engine_from_artifact
    from alignq_tpu_torch.train import make_train_step

    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="alignq_tp_"))

    phase("tensor parallel (a): K1's f32 epilogue against the repaired fma_f32 at f32 midpoints")
    mism, twice, total = fma_on_the_card(dev)
    print(f"tensor parallel (a): K1's acc * scale + bias (__fmaf_rn) against the plain fma_f32 on {total} "
          f"midpoint-adjacent operands: {mism} differ; a float64 add and one cast would round {twice} of them "
          f"otherwise", flush=True)
    if mism or not twice:
        raise AssertionError(f"tensor parallel (a): {mism} of {total} differ, {twice} double-rounding cases reached")
    out["fma"] = {"mismatches": mism, "double_rounding_cases": twice, "operands": total}

    arts = tp_artifacts(tmp)
    rng = np.random.RandomState(SEED)
    reqs = {f"{i}/{j}": rng.randn(batch, hw, hw, 3).astype(np.float32)
            for i, (_, _, batch, hw) in enumerate(arts) for j in range(TP_SERVE_REQUESTS)}
    np.savez(tmp / "reqs.npz", **reqs)
    common = {"artifacts": [[str(p), b] for _, p, b, _ in arts], "requests": str(tmp / "reqs.npz")}

    phase("tensor parallel (b, c): 4 gloo ranks on the card, a (2, 2) fit and (2, 2) serving; one process beside")
    t0 = time.perf_counter()
    box = {}
    runner = threading.Thread(target=lambda: box.update(r4=run_tp_ranks(
        repo, 4, dict(common, fit=[2, 2], serve=[[2, 2]]), tmp)), daemon=True)
    runner.start()
    # the references, in this process meanwhile: the one-process fit and engines
    model, state, cfg, batches = dp_resnet20(dev)
    step = make_train_step(model, cfg)
    for x, y in batches:
        step(state, x.to(dev), y.to(dev))
    one = state_tensors(state)
    one.update({f"t:{k}": v.detach().cpu() for k, v in state.tx.trace.items()})
    ref = {}
    for i, (label, path, batch, _) in enumerate(arts):
        zero_counts(_build.launches)
        seen, undo = _n_counter(K1)
        try:
            engine = engine_from_artifact(str(path), batch)
            logits = [engine.submit(reqs[f"{i}/{j}"]).result(timeout=300) for j in range(TP_SERVE_REQUESTS)]
            engine.close()
        finally:
            undo()
        torch.cuda.synchronize()
        ref[i] = {"logits": logits, "k1": _build.launches.get(K1.KERNEL, 0),
                  "k3": _build.launches.get("stage_identity_blocks", 0), "k1_n": seen["n"]}
    runner.join()
    if "r4" not in box:
        raise AssertionError("tensor parallel: the 4-rank run failed (its error above)")
    t4 = time.perf_counter() - t0
    phase("tensor parallel (b, c, d): 2 gloo ranks on the card, a (1, 2) fit, (1, 2) and (2, 1) serving, times")
    t0 = time.perf_counter()
    r2 = run_tp_ranks(repo, 2, dict(common, fit=[1, 2], times=[1, 2], serve=[[1, 2], [2, 1]],
                                    rate=[str(arts[0][1]), TP_RATE_BATCH, TP_RATE_BATCHES]), tmp)
    t2 = time.perf_counter() - t0

    # (b) the fits against one process
    fits = {}
    for shape, ranks in (((1, 2), r2), ((2, 2), box["r4"])):
        sharded = set(ranks[0]["fit"]["sharded"])
        err = 0.0
        for r, res in enumerate(ranks):
            st, whole = res["fit"]["state"], res["fit"]["whole"]
            err = max(err, max_diff(whole, {k: v for k, v in one.items() if k.startswith("p:")}),
                      max_diff({k: v for k, v in st.items() if k[:2] in ("b:", "a:", "g:")},
                               {k: v for k, v in one.items() if k[:2] in ("b:", "a:", "g:")}))
            for name in sharded:
                if st[f"p:{name}"].shape[0 if st[f"p:{name}"].ndim == 4 else 1] * shape[1] != \
                        one[f"p:{name}"].shape[0 if one[f"p:{name}"].ndim == 4 else 1]:
                    raise AssertionError(f"tensor parallel (b) {shape}: rank {r}'s {name} is not its Cout/n_model")
        same = all(torch.equal(ranks[d * shape[1] + m]["fit"]["state"][k], v)
                   for d in range(shape[0]) for m in range(1, shape[1])
                   for k, v in ranks[d * shape[1]]["fit"]["state"].items() if k[2:] not in sharded)
        fits[f"{shape[0]}x{shape[1]}"] = {"max_abs_vs_one_process": err, "replicated_bit_identical": same,
                                          "sharded_kernels": len(sharded)}
        print(f"tensor parallel (b) mesh {shape}: ResNet-20 W8A8 ADMM, {DP_STEPS} float64 gather steps at global "
              f"batch {DP_BATCH}, {len(sharded)} kernels split over the model axis: the whole network within "
              f"{err:.3g} of one process (params, statistics, duals); replicated tensors bit-identical across "
              f"the model ranks: {same}", flush=True)
        if not (err <= 1e-9 and same and len(sharded) == 22):
            raise AssertionError(f"tensor parallel (b) {shape}: {fits}")
    out["fits"] = fits

    # (c) serving against one process
    serving = {}
    for shape, ranks in (((1, 2), r2), ((2, 1), r2), ((2, 2), box["r4"])):
        key = f"{shape[0]}x{shape[1]}"
        for i, (label, _, batch, _) in enumerate(arts):
            per_rank = [res[f"serve/{key}/{i}"] for res in ranks]
            same = all(np.array_equal(a.numpy(), b) for a, b in zip(per_rank[0]["logits"], ref[i]["logits"]))
            k1 = [p["k1"] for p in per_rank]
            k1_n = [p["k1_n"] for p in per_rank]
            ok = (same and len(per_rank[0]["logits"]) == TP_SERVE_REQUESTS and all(c == ref[i]["k1"] for c in k1)
                  and all(c * shape[1] == ref[i]["k1_n"] for c in k1_n) and not any(p["taps"] for p in per_rank)
                  and all(p["k3"] == ref[i]["k3"] for p in per_rank))
            serving[f"{key} {label}"] = {"bit_identical": same, "k1_launches_per_rank": k1,
                                         "k1_channels_per_rank": k1_n, "one_process_k1": ref[i]["k1"],
                                         "one_process_k1_channels": ref[i]["k1_n"],
                                         "k3_launches_per_rank": [p["k3"] for p in per_rank]}
            print(f"tensor parallel (c) mesh {shape} {label}, engine batch {batch}: {TP_SERVE_REQUESTS} batches bit "
                  f"for bit against the one-process engine: {same}; K1 launches a rank {k1} (one process "
                  f"{ref[i]['k1']}), the channels they wrote {k1_n} (one process {ref[i]['k1_n']}), K3 "
                  f"{[p['k3'] for p in per_rank]}", flush=True)
            if not ok:
                raise AssertionError(f"tensor parallel (c) {key} {label}: {serving[f'{key} {label}']}")
    out["serving"] = serving

    # (d) times: one card, gloo through the host
    t = r2[0]["times"]
    rates = {k: float(v) for k, v in r2[0].items() if k.startswith("rate/")}
    engine = engine_from_artifact(str(arts[0][1]), TP_RATE_BATCH)
    x = np.random.RandomState(SEED).randn(TP_RATE_BATCH, 32, 32, 3).astype(np.float32)
    engine.submit(x).result(timeout=300)
    t0 = time.perf_counter()
    for f in [engine.submit(x) for _ in range(TP_RATE_BATCHES)]:
        f.result(timeout=300)
    rates["rate/one process"] = TP_RATE_BATCHES * TP_RATE_BATCH / (time.perf_counter() - t0)
    engine.close()
    by_op = {k.split(":", 1)[1]: [int(t[f"calls:{k.split(':', 1)[1]}"]), float(v)]
             for k, v in t.items() if k.startswith("transfer_ms:") and int(t[f"calls:{k.split(':', 1)[1]}"])}
    times = {f"tp step rank {r}": {"ms": float(res["times"]["ms"]), "transfer_ms": float(res["times"]["transfer_ms"]),
                                   "in_calls_ms": float(res["times"]["in_calls_ms"])} for r, res in enumerate(r2)}
    out["times"] = {"steps": times, "transfer_by_op_rank0": by_op, "served_images_per_s": rates,
                    "wall_s": {"4 ranks": t4, "2 ranks": t2}}
    for k, v in times.items():
        print(f"tensor parallel (d) ResNet-20 W8A8 ADMM f32 step at {DP_TIME_BATCH} images, mesh (1, 2), {k}: "
              f"{v['ms']:.2f} ms a step; its collectives timed alone {v['in_calls_ms']:.2f} ms, of which transfer "
              f"{v['transfer_ms']:.2f} [{card}; one card, gloo through the host: not a multi-card figure]",
              flush=True)
    print(f"tensor parallel (d) rank 0's collectives by op and group ([calls, transfer ms]): {by_op}", flush=True)
    print(f"tensor parallel (d) served images/s, ResNet-20 slice route at engine batch {TP_RATE_BATCH} "
          f"({TP_RATE_BATCHES} batches, host clock): {rates} [{card}; one card, gloo through the host]", flush=True)
    details["tensor_parallel"] = out
    shutil.rmtree(tmp, ignore_errors=True)


def fma_ab(card) -> None:
    """python3 chip_smoke.py --fma-ab: the fma_f32 repair's cost on the card,
    the repaired fma_f32 against its earlier form (float64 evaluation, one
    cast) patched into every module that imports it (and quant/cdf.py's
    erf_f32, whose Horner steps take it), in the order new,
    old, old, new: the ResNet-50 int8 forward at batch 256 (224x224, CUDA
    events, median of 20) and the ResNet-20 W8A8 erf ADMM QAT step at
    batch 128 (CUDA events, median of 5). One JSON line."""
    import importlib

    import numpy as np
    import torch

    from alignq_tpu_torch.kernels import infer_resnet_imagenet as RI
    from alignq_tpu_torch.models.registry import build_model
    from alignq_tpu_torch.quant import cdf
    from alignq_tpu_torch.train import TrainConfig, create_train_state, make_train_step
    from alignq_tpu_torch.train.loop import true_f32

    repaired = cdf.fma_f32

    repaired_erf = cdf.erf_f32

    def earlier(a, b, c):
        a64, b64, c64 = (v.double() if torch.is_tensor(v) else v for v in (a, b, c))
        return (a64 * b64 + c64).float()

    def earlier_erf(x):  # its Horner steps through the earlier form
        xc = torch.clamp(x, -cdf._ERF_CLAMP, cdf._ERF_CLAMP)
        x2 = xc * xc
        p = torch.full_like(x2, cdf._ERF_P[0])
        for c in cdf._ERF_P[1:]:
            p = earlier(p, x2, c)
        q = torch.full_like(x2, cdf._ERF_Q[0])
        for c in cdf._ERF_Q[1:]:
            q = earlier(q, x2, c)
        return xc * p / q

    mods = [cdf] + [importlib.import_module(f"alignq_tpu_torch.kernels.{m}")
                    for m in ("dwconv", "qmatmul", "infer_digit", "infer_resnet_imagenet", "quantize", "stage_kernel")]
    dev = torch.device("cuda")
    fwd, (qp, x) = RI.build_resnet_imagenet_int8("resnet50", SERVE_BATCH, device=dev, image_size=TRUNK_SIZE)
    ops = RI.pack_resnet_imagenet_operands(qp)
    true_f32()
    cfg = TrainConfig(train_batch_size=128, bitW=8, abitW=8, admm=True, cdf_impl="erf")  # phase 11's step
    model = build_model(cfg, torch.Generator().manual_seed(SEED)).to(dev)
    state = create_train_state(torch.Generator().manual_seed(SEED), model, cfg)
    step = make_train_step(model, cfg)
    rng = np.random.RandomState(SEED)
    xb = torch.tensor(rng.randn(128, 32, 32, 3), dtype=torch.float32, device=dev)
    yb = torch.tensor(rng.randint(0, 10, 128), device=dev)
    rows = []
    for label in ("repaired", "earlier", "earlier", "repaired"):
        for m in mods:
            m.fma_f32 = repaired if label == "repaired" else earlier
        cdf.erf_f32 = repaired_erf if label == "repaired" else earlier_erf
        with torch.inference_mode():
            f_ms = median_ms(lambda: fwd(qp, x, operands=ops))
        s_ms = median_ms(lambda: step(state, xb, yb), runs=5, warmup=2)
        rows.append({"fma_f32": label, "resnet50_forward_ms": f_ms, "resnet20_qat_step_ms": s_ms})
        print(f"fma A/B {label}: ResNet-50 int8 forward at {SERVE_BATCH} ({TRUNK_SIZE}x{TRUNK_SIZE}) {f_ms:.3f} ms; "
              f"ResNet-20 W8A8 erf ADMM QAT step at 128 {s_ms:.2f} ms [{card}]", flush=True)
    for m in mods:
        m.fma_f32 = repaired
    cdf.erf_f32 = repaired_erf
    print(json.dumps({"fma_ab": rows, "card": card}), flush=True)


AB_WGS = (4, 2, 1)  # the Hopper form's warpgroups a CTA that --k1-ab times: tiles of 256, 128, 64 rows


def k1_ab_nets(dev):
    """(label, batch, build, forward) of each graph that --k1-ab times: the
    trunks (224x224, erf) at batch 256, at their serving engine's 4 and a
    ragged 3; MobileNet-V2 and DenseNet-40 (both stage buffers) at 256 and
    their serving engine's 8; ResNet-20 on its default erf route at 2048
    and 256. build() gives (operands, input) and forward(operands, input)
    runs the graph."""
    from alignq_tpu_torch.kernels import infer as R20
    from alignq_tpu_torch.kernels import infer_resnet_imagenet as RI

    def trunk(arch, batch):
        def build():
            _, (qp, x) = RI.build_resnet_imagenet_int8(arch, batch, device=dev, image_size=TRUNK_SIZE)
            return (qp, RI.pack_resnet_imagenet_operands(qp)), x
        return arch, batch, build, lambda o, x: RI.resnet_imagenet_int8_forward(o[0], x, operands=o[1])

    def family(label, build_fn, fwd_fn, pack, kw, batch):
        def build():
            _, (qp, x) = build_fn(batch, device=dev, **kw)
            return (qp, pack(qp, **kw)), x
        return label, batch, build, lambda o, x: fwd_fn(o[0], x, operands=o[1], **kw)

    def resnet20(batch):
        def build():
            _, (qp, x) = R20.build_resnet20_int8(batch, device=dev)
            return (qp, R20.pack_int8_operands(qp)), x
        return "resnet20", batch, build, lambda o, x: R20.resnet20_int8_forward(o[0], x, operands=o[1])

    nets = [trunk(arch, b) for b in (SERVE_BATCH, TRUNK_SERVE_BATCH, 3) for arch in TRUNKS]
    nets += [family(label, build, fwd, pack, kw, b) for b in (SERVE_BATCH, FAMILY_SERVE_BATCH)
             for label, build, fwd, _, pack, kw in family_configs()]
    return nets + [resnet20(b) for b in (BATCH, SERVE_BATCH)]


def k1_options(geo):
    """{option: plan} of the Hopper forms that --k1-ab times for one launch
    shape geo (conv_plan's arguments): the wide form's tiles of AB_WGS
    rows ('sm90@4' ...) where sm90_plan takes the shape, else the narrow
    form's (MG, WM, WK) options ('narrow@4,2,1' ...) where narrow_plan
    does."""
    from alignq_tpu_torch.kernels import qmatmul as K1

    if K1.sm90_plan(*geo) is not None:
        plans = {f"sm90@{n}": K1.sm90_plan(*geo, n_wg=n) for n in AB_WGS}
    else:
        plans = {"narrow@" + ",".join(map(str, o)): K1.narrow_plan(*geo, option=o)
                 for o in K1.narrow_options(geo[7])}
        ho, wo = K1.conv_out_hw(geo[1], geo[2], geo[4], geo[5], geo[6])
        plans.update({f"plane@{tr}": K1.plane_plan(*geo, rows=tr) for tr in K1.plane_rows(ho, wo)})
    return {k: p for k, p in plans.items() if p is not None}


def option_of(plan):
    """The --k1-ab option name of a plan."""
    from alignq_tpu_torch.kernels import qmatmul as K1

    if isinstance(plan, K1.Sm90Plan):
        return f"sm90@{plan.n_wg}"
    if isinstance(plan, K1.NarrowPlan):
        return f"narrow@{plan.MG},{plan.WM},{plan.WK}"
    if isinstance(plan, K1.PlanePlan):
        return f"plane@{plan.TR}"
    return "mma"


def k1_ab(card, labels=None) -> None:
    """python3 chip_smoke.py --k1-ab: K1's forms on the card, in one
    process. For each graph of k1_ab_nets (those named in labels, where
    given), each distinct K1 launch whose shape a Hopper form takes is
    timed by graph_ms (cold L2) in the mma.sync form and at each option of
    k1_options (the wide form's tiles of 256, 128 and 64 rows; the narrow
    form's row groups, warpgroups and K split), in the order mma.sync, the
    options, the options backwards, mma.sync, every option's output bit
    for bit the mma.sync form's; beside its conv_bound and torch._int_mm on
    the gathered taps (at batches of 256 and more: cuBLAS refuses some
    smaller shapes), and the option the planner's rule gives it. Then each
    graph's K1 sum (its other launches timed once: the mma.sync form takes
    them either way) all in mma.sync, by the rule, and at each launch's
    fastest option, with the rule's launches in each Hopper form; and the
    whole forward (CUDA events, median of 20) in the order mma.sync, rule,
    rule, mma.sync (mma.sync under qmatmul._mma_form).
    `hopper_slower_at` lists the launches the rule gives a Hopper form
    where mma.sync was faster, `narrow_or_plane_lost_at` those where the narrow
    or plane
    form's best option was more than 3% slower than mma.sync;
    `rule_misses` each launch where another option was faster than the
    rule's by more than 3%. One JSON line, also written to
    chiprun_out/k1_ab.json."""
    import torch

    from alignq_tpu_torch.kernels import qmatmul as K1

    dev = torch.device("cuda")
    rows, forwards, considered = [], {}, {}
    for label, batch, build, fwd_fn in k1_ab_nets(dev):
        if labels is not None and label not in labels:
            continue
        ops, x = build()

        def fwd():
            return fwd_fn(ops, x)

        with torch.inference_mode():
            launches = distinct_launches(record_launches(fwd))
            k1_sum = {"mma": 0.0, "rule": 0.0, "best": 0.0}
            n_k1, n_taken = 0, {"sm90": 0, "narrow": 0, "plane": 0}
            for key, ((kind, args), count) in launches.items():
                if kind != "K1":
                    continue
                n_k1 += count
                xk, op, plan, mode, act, xc = args
                pm, out = mma_plan(xk, op, plan), k1_out(plan, op, mode)
                geo = (*xk.shape, plan.ksize, plan.stride, plan.pad, *op.wt.shape)
                tiles = k1_options(geo)
                if not tiles:
                    t0 = graph_ms(lambda: K1._k1_launch(xk, op, pm, out, mode, act))
                    for form in k1_sum:
                        k1_sum[form] += count * t0
                    continue
                rule = option_of(plan)
                if rule != "mma":
                    n_taken[rule.split("@")[0]] += count
                t_mma, t90 = [], {n: [] for n in tiles}
                t_mma.append(graph_ms(lambda: K1._k1_launch(xk, op, pm, out, mode, act)))
                for n in list(tiles) + list(tiles)[::-1]:
                    t90[n].append(graph_ms(lambda: K1._k1_launch(xk, op, tiles[n], out, mode, act)))
                t_mma.append(graph_ms(lambda: K1._k1_launch(xk, op, pm, out, mode, act)))
                K1._k1_launch(xk, op, pm, out, mode, act)
                for n, p in tiles.items():  # each option's output is the mma.sync form's, bit for bit
                    got = k1_out(p, op, mode)
                    K1._k1_launch(xk, op, p, got, mode, act)
                    if not torch.equal(got, out):
                        raise AssertionError(f"K1's Hopper form at {n} differs from mma.sync at {key}")
                b_ms, b_by = conv_bound(*xk.shape[:3], xc, plan.ksize, plan.stride, op.n,
                                        4 if mode in ("f32", "relu") else 1, plan.pad)
                lib_ms = None  # torch._int_mm has no cuBLAS kernel for some small-batch shapes: timed at 256 and up
                if batch >= SERVE_BATCH:
                    cols = K1.gather_taps(xk, plan.ksize, plan.stride, plan.pad, K1.K_MULT)
                    wmat = op.wt.t().contiguous()
                    lib_ms = graph_ms(lambda: torch._int_mm(cols, wmat))
                    del cols, wmat
                means = {"mma": statistics.mean(t_mma), **{n: statistics.mean(t) for n, t in t90.items()}}
                best = min(means, key=means.get)
                k1_sum["mma"] += count * means["mma"]
                k1_sum["rule"] += count * means[rule]
                k1_sum["best"] += count * means[best]
                rows.append(dict(net=label, batch=batch, shape=str(key), launches=count, rule=rule, best=best,
                                 mma_ms=t_mma, hopper_ms=t90, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                 M=pm.B * pm.Ho * pm.Wo, items={n: getattr(p, "n_items", p.B) for n, p in tiles.items()}))
                print(f"k1 A/B {label} {key} x{count}: mma.sync {t_mma[0]:.4f} ms, "
                      + ", ".join(f"{n} {t[0]:.4f}" for n, t in t90.items())
                      + f", back {', '.join(f'{t[1]:.4f}' for t in list(t90.values())[::-1])}, mma.sync "
                      f"{t_mma[1]:.4f}; rule {rule}, fastest {best}; bound {b_ms:.4f} ({b_by}), torch._int_mm "
                      f"{'not timed' if lib_ms is None else f'{lib_ms:.4f}'} [{card}]", flush=True)
            fw = {"mma": [], "rule": []}
            if sum(n_taken.values()):
                for form in ("mma", "rule", "rule", "mma"):
                    with K1._mma_form() if form == "mma" else contextlib.nullcontext():
                        fw[form].append(median_ms(fwd))
        considered[f"{label} {batch}"] = {"k1_launches": n_k1, "rule_takes": n_taken}
        forwards[f"{label} {batch}"] = {"k1_sum_ms": k1_sum, "forward_ms": fw}
        print(f"k1 A/B {label} batch {batch}: of {n_k1} K1 launches a forward the rule gives {n_taken} the Hopper "
              f"forms; K1 summed over a forward {k1_sum} ms; the forward {fw} ms (order mma, rule, rule, mma) "
              f"[{card}]", flush=True)
        del ops, x, launches
        torch.cuda.empty_cache()

    def mean(r, opt):
        return statistics.mean(r["mma_ms"] if opt == "mma" else r["hopper_ms"][opt])

    slower = [f"{r['net']} {r['batch']} {r['shape']}" for r in rows
              if r["rule"] != "mma" and mean(r, r["rule"]) >= mean(r, "mma")]
    def best_of(r, form):
        return min(mean(r, o) for o in r["hopper_ms"] if o.startswith(form))

    lost = [dict(at=f"{r['net']} {r['batch']} {r['shape']}", mma_ms=mean(r, "mma"), **{f"{form}_ms": best_of(r, form)})
            for form in ("narrow", "plane") for r in rows if any(o.startswith(form) for o in r["hopper_ms"])
            and best_of(r, form) > 1.03 * mean(r, "mma")]
    misses = [dict(at=f"{r['net']} {r['batch']} {r['shape']}", rule=r["rule"], best=r["best"],
                   ratio=mean(r, r["rule"]) / mean(r, r["best"]))
              for r in rows if mean(r, r["rule"]) > 1.03 * mean(r, r["best"])]
    result = {"k1_ab": rows, "forwards": forwards, "considered": considered, "hopper_slower_at": slower,
              "narrow_or_plane_lost_at": lost, "rule_misses": misses, "card": card}
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "k1_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


K3_AB_BATCHES = (BATCH, SERVE_BATCH, 8, 3)  # --k3-ab's batches: the bench's, the engine's, a serving batch, ragged


def k3_options(batch, hw, c, n_blocks):
    """{label: plan} of every Hopper-form plan --k3-ab times for one run:
    each image count of K3_IMGS whose group holds no more pixels than a
    32x32 image (two 32x32 images a CTA ran slower at every batch and
    warpgroup count tried: PERF.md) and 1, 2 and 4 warpgroups, where they
    fit."""
    from alignq_tpu_torch.kernels import stage_kernel as K3

    opts = {}
    for imgs in (i for i in K3.K3_IMGS if i * hw * hw <= 1024):
        for n_wg in (1, 2, 4):
            plan = K3.k3_plan(batch, hw, hw, c, n_blocks, imgs=imgs, n_wg=n_wg)
            if plan is not None:
                opts[f"{imgs}i{n_wg}w"] = plan
    return opts


def k3_ab(card, ptxas: str = "") -> None:
    """python3 chip_smoke.py --k3-ab: K3's two forms on the card, in one
    process. For each ResNet-20 stage run (seeded weights from
    build_resnet20_int8, a random stream) at each batch of K3_AB_BATCHES,
    the mma.sync form (stage_kernel.cu) and every Hopper-form option of
    k3_options are timed by graph_ms (cold L2) in the order mma.sync, the
    options, the options backwards, mma.sync, beside k3_bound and the
    option the planner's rule gives; every option's stream must equal the
    mma.sync form's bit for bit. Then, at batches 2048 and 256, K3 summed
    over a slice-route forward in each form (the rule's option) and the
    whole slice-route forward (CUDA events, median of 20) in the order
    mma.sync, rule, rule, mma.sync (mma.sync under stage_kernel._old_form).
    `hopper_slower_at` lists the runs where the rule's option lost to
    mma.sync; `rule_misses` each run where another option beat the rule's
    by more than 3%. One JSON line, after the Hopper form's register and
    spill report where this call built it."""
    import torch

    from alignq_tpu_torch.kernels import stage_kernel as K3
    from alignq_tpu_torch.kernels.infer import build_resnet20_int8, pack_int8_operands, resnet20_int8_forward

    for ln in ptxas.splitlines():
        if "Compiling entry" in ln or "registers" in ln or "spill" in ln or "C75" in ln:
            print("ptxas:", ln.strip(), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    _, (qp, _) = build_resnet20_int8(1, device=dev)
    layers = qp["layers"]
    runs = [("stage1 blocks 0-2", layers[0:3], (1, 2, 3), 32), ("stage2 blocks 4-5", layers[4:6], (2, 3), 16),
            ("stage3 blocks 7-8", layers[7:9], (2, 3), 8)]
    rows, sums = [], {}
    for batch in K3_AB_BATCHES:
        sums[batch] = {"mma": 0.0, "rule": 0.0, "best": 0.0, "bound": 0.0}
        for name, blocks, ms, hw in runs:
            wt, scale, bias = K3.pack_block_weights(blocks)
            c = wt.shape[2]
            x = torch.randint(0, 4 * 127, (batch, hw, hw, c), generator=gen, device=dev, dtype=torch.int16)
            opts = k3_options(batch, hw, c, len(ms))
            rule = K3.k3_plan(batch, hw, hw, c, len(ms))
            rule_key = next(k for k, p in opts.items() if p == rule)
            old = torch.empty_like(x)
            K3._stage_launch(x, old, wt, scale, bias, ms, 127)
            outs = {}
            for key, plan in opts.items():
                outs[key] = torch.empty_like(x)
                K3._stage_launch(x, outs[key], wt, scale, bias, ms, 127, plan)
            torch.cuda.synchronize()
            for key, got in outs.items():
                if not torch.equal(got, old):
                    raise AssertionError(f"K3's Hopper form {key} differs from mma.sync at {name} batch {batch}")
            out = outs.pop(rule_key)
            del outs
            t_old, t90 = [], {k: [] for k in opts}
            t_old.append(graph_ms(lambda: K3._stage_launch(x, old, wt, scale, bias, ms, 127)))
            for key in list(opts) + list(opts)[::-1]:
                t90[key].append(graph_ms(lambda: K3._stage_launch(x, out, wt, scale, bias, ms, 127, opts[key])))
            t_old.append(graph_ms(lambda: K3._stage_launch(x, old, wt, scale, bias, ms, 127)))
            means = {"mma": statistics.mean(t_old), **{k: statistics.mean(t) for k, t in t90.items()}}
            best = min(means, key=means.get)
            b_ms, b_by = k3_bound(x.numel() // c, c, len(ms))
            for key, v in (("mma", means["mma"]), ("rule", means[rule_key]), ("best", means[best]), ("bound", b_ms)):
                sums[batch][key] += v
            rows.append(dict(batch=batch, run=name, C=c, HW=hw, mma_ms=t_old, sm90_ms=t90, rule=rule_key, best=best,
                             bound_ms=b_ms, bound_by=b_by))
            print(f"k3 A/B {name} C={c} batch {batch}: mma.sync {t_old[0]:.4f} / {t_old[1]:.4f} ms; "
                  + ", ".join(f"{k} {t[0]:.4f} / {t[1]:.4f}" for k, t in t90.items())
                  + f"; rule {rule_key}, fastest {best}; bound {b_ms:.4f} ({b_by}) [{card}]", flush=True)
            del x, old, out
        print(f"k3 A/B batch {batch}: K3 summed over the three runs of a slice-route forward {sums[batch]} ms "
              f"[{card}]", flush=True)
    slice_kw = dict(act_impl="poly", stream="int16", use_stage_kernel=True, use_pallas_1x1=True)
    forwards = {}
    for batch in (BATCH, SERVE_BATCH):
        _, (qp_b, x_b) = build_resnet20_int8(batch, device=dev)
        ops_b = pack_int8_operands(qp_b)
        fw = {"mma": [], "rule": []}
        with torch.inference_mode():
            for form in ("mma", "rule", "rule", "mma"):
                with K3._old_form() if form == "mma" else contextlib.nullcontext():
                    fw[form].append(median_ms(lambda: resnet20_int8_forward(qp_b, x_b, operands=ops_b, **slice_kw)))
        forwards[batch] = fw
        print(f"k3 A/B slice-route forward batch {batch}: {fw} ms (order mma, rule, rule, mma) [{card}]", flush=True)
        del qp_b, x_b, ops_b

    def mean(r, opt):
        return statistics.mean(r["mma_ms"] if opt == "mma" else r["sm90_ms"][opt])

    slower = [f"{r['run']} batch {r['batch']}" for r in rows if mean(r, r["rule"]) >= mean(r, "mma")]
    misses = [dict(at=f"{r['run']} batch {r['batch']}", rule=r["rule"], best=r["best"],
                   ratio=mean(r, r["rule"]) / mean(r, r["best"]))
              for r in rows if mean(r, r["rule"]) > 1.03 * mean(r, r["best"])]
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    line = {"k3_ab": rows, "k3_per_forward": sums, "forwards": forwards, "hopper_slower_at": slower,
            "rule_misses": misses, "card": card}
    (out_dir / "k3_ab.json").write_text(json.dumps(line, indent=1))
    print(json.dumps(line), flush=True)


TABLE_GRIDS = (127, 7, 1)  # the grids of the served act maps: A8, A4, A2


def act_table_checks(dev) -> dict:
    """Phase 2(b): the table form of the erf and poly maps (act_codes.cuh
    table_code, on kernels/quantize.py act_table's entries) against the
    direct map on the card, over all 2^32 f32 bit patterns, at each grid of
    TABLE_GRIDS, relu'd and not; and K2's map ('as', grid 127: the table
    csrc/cdf_quant_sm90.cu reads, built on the card from quantize.cu's
    direct kernel); any difference fails the run."""
    import torch

    from alignq_tpu_torch.kernels import stem as ST

    out = {}
    cases = [(impl, g, relu) for impl in ("erf", "poly") for g in TABLE_GRIDS for relu in (True, False)]
    for impl, g, relu in cases + [("as", 127, False)]:
        t0 = time.perf_counter()
        n, first = ST.act_table_differences(impl, g, relu, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[f"{impl} g={g} relu={relu}"] = {"patterns": 1 << 32, "differing": n, "first": first, "s": secs}
        print(f"act table {impl} g={g}{' relu' if relu else ''}: {1 << 32} f32 patterns checked, {n} differing "
              f"from the direct map ({secs:.2f} s, the table's build included)", flush=True)
        if n:
            raise AssertionError(f"the {impl} table of grid {g} (relu {relu}) differs from its map at {n} "
                                 f"patterns, the least {first:#010x}")
    return out


K2_CHUNK_BITS = 28  # phase 4's check of every f32 pattern: 16 chunks of 2^28 (1 GB of f32 each)


def k2_every_f32(dev) -> dict:
    """K2's Hopper form (csrc/cdf_quant_sm90.cu) against its direct kernel
    (csrc/quantize.cu) on all 2^32 f32 bit patterns, NaNs and infinities
    included, as 16 chunks of 2^28 consecutive patterns: the differing
    patterns counted (the least one kept) and the time taken. Raw launches:
    nothing is counted."""
    import torch

    from alignq_tpu_torch.kernels import quantize as K2

    t0 = time.perf_counter()
    base = torch.arange(1 << K2_CHUNK_BITS, dtype=torch.int32, device=dev)
    new = torch.empty(base.shape, dtype=torch.int8, device=dev)
    old = torch.empty_like(new)
    n_diff, first = 0, None
    for c in range(1 << (32 - K2_CHUNK_BITS)):
        lo = c << K2_CHUNK_BITS
        x = (base + (lo - (1 << 32) if lo >= 1 << 31 else lo)).view(torch.float32)
        plan = K2.device_k2_plan(x)
        K2._k2_sm90_launch(x, new, plan)
        K2._k2_launch(x, old)
        diff = new != old
        d = int(diff.sum())
        if d and first is None:
            first = (lo + int(diff.nonzero()[0, 0])) & 0xFFFFFFFF
        n_diff += d
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"K2's Hopper form against its direct kernel: {1 << 32} f32 patterns checked in "
          f"{1 << (32 - K2_CHUNK_BITS)} chunks of 2^{K2_CHUNK_BITS}, {n_diff} differing ({secs:.2f} s)", flush=True)
    return {"patterns": 1 << 32, "differing": n_diff, "first": first, "s": secs}


K2_AB_BATCHES = (2048, 256, 64, 16, 8)  # --k2-ab: the act-site sizes of these batches
K2_AB_EXTRA = (("ragged", 1000003, 0), ("view 1 element in", 256 * 64 * 64, 1))  # (name, n, storage offset)


def k2_ab(card) -> None:
    """python3 chip_smoke.py --k2-ab: K2's Hopper form against its direct
    kernel, in one process: at the act-site sizes of batches 2048, 256, 64,
    16 and 8 and a ragged n of 1,000,003, the raw launches of the direct
    kernel and of the Hopper form by graph_ms (cold L2) in the order old,
    new, new, old, beside PyTorch's cast of the same f32 to int8 (the same
    bytes in and out, no map); at a view one element into its storage, the
    entry point (cdf_quantize_int8, its copy included) under _old_form and
    not, ABBA. Every output bit for bit the direct kernel's. The sums over
    each batch's three sizes, and the card's table against the CPU-built
    one. One JSON line, also written to chiprun_out/k2_ab.json."""
    import torch

    from alignq_tpu_torch.kernels import quantize as K2

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(b, name, n, 0) for b in K2_AB_BATCHES for name, n in act_site_sizes(b)]
    cases += [(None, name, n, off) for name, n, off in K2_AB_EXTRA]
    res = {"card": card, "cases": []}
    card_t = K2.k2_table(dev)
    tables = [K2.k2_table(torch.device("cpu")).entries.numpy(), card_t.entries.cpu().numpy()]
    res["table"] = {"entries": len(tables[1]), "windows": int(((tables[1][:, 0] >> 16) > 0).sum()),
                    "steps_differing_from_the_cpu_table": int((tables[0] != tables[1]).any(1).sum())}
    print(f"k2-ab: the card's table of K2's map: {json.dumps(res['table'])} [{card}]", flush=True)

    def abba(a, b):
        t = [graph_ms(f) for f in (a, b, b, a)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t

    for batch, name, n, off in cases:
        x = (torch.randn(n + off, generator=gen, device=dev) * 1.5)[off:]
        out = torch.empty(x.shape, dtype=torch.int8, device=dev)
        row = {"batch": batch, "shape": name, "n": n, "offset": off, "takes": K2.k2_takes(n),
               "bound_ms": bound(5 * n, K2_TABLE_OPS_PER_ELEMENT * n, PEAK_F32_OPS_PER_S)[0]}
        if off:  # the entry point, the copy of a view included
            def old():
                with K2._old_form():
                    return K2.cdf_quantize_int8(x)

            if not torch.equal(K2.cdf_quantize_int8(x), old()):
                raise AssertionError(f"K2's entry point differs from its direct kernel at {name} n={n}")
            row["old_ms"], row["new_ms"], row["runs"] = abba(old, lambda: K2.cdf_quantize_int8(x))
        else:
            K2._k2_launch(x, out)
            want = out.clone()
            plan = K2.device_k2_plan(x)
            out.zero_()
            K2._k2_sm90_launch(x, out, plan)
            if not torch.equal(out, want):
                raise AssertionError(f"K2's Hopper form differs from its direct kernel at {name} n={n}")
            row["old_ms"], row["new_ms"], row["runs"] = abba(lambda: K2._k2_launch(x, out),
                                                             lambda: K2._k2_sm90_launch(x, out, plan))
            row["ctas"], row["steps"] = plan.ctas, plan.steps
            row["stream_ms"] = graph_ms(lambda: x.to(torch.int8))
        res["cases"].append(row)
        more = "" if off else f"; a cast to int8 {row['stream_ms']:.4f}"
        print(f"k2-ab: {name} batch {batch} n={n}{f' at offset {off}' if off else ''}: direct kernel "
              f"{row['old_ms']:.4f} ms, Hopper form {row['new_ms']:.4f} ms (bound {row['bound_ms']:.4f}; ABBA "
              f"{', '.join(f'{v:.4f}' for v in row['runs'])}; the rule gives the "
              f"{'Hopper form' if row['takes'] else 'direct kernel'}){more} [{card}]", flush=True)
        del x, out
    for batch in K2_AB_BATCHES:
        r = [x for x in res["cases"] if x["batch"] == batch]
        tot = {k: sum(x[k] for x in r) for k in ("old_ms", "new_ms", "bound_ms", "stream_ms")}
        tot["rule_ms"] = sum(x["new_ms"] if x["takes"] else x["old_ms"] for x in r)
        res[f"sum batch {batch}"] = tot
        print(f"k2-ab: the three act-site sizes of batch {batch}: direct kernel {tot['old_ms']:.4f} ms, Hopper form "
              f"{tot['new_ms']:.4f} ms, by the rule {tot['rule_ms']:.4f} (bound {tot['bound_ms']:.4f}, a cast to "
              f"int8 {tot['stream_ms']:.4f}) [{card}]", flush=True)
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "k2_ab.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))


def stem_dw_ab(card) -> None:
    """python3 chip_smoke.py --stem-dw-ab: the stem kernel and the depthwise
    Hopper form against the forms they replaced, in one process. The stem
    of ResNet-50 at 224x224 at batches 256 and 4 (the erf map): the
    parent's chain (_linear_q, the pad pass, K1's 7x7 form, the f16 pool
    chain; stem._old_form) and the new one (the prep pass and the stem
    kernel), each whole chain timed by graph_ms (cold L2) in the order old,
    new, new, old, the outputs bit for bit equal. The depthwise form: each
    launch of a MobileNet-V2 forward at batches 256 and 8 in dwconv.cu's
    and the Hopper form's plans, ABBA, outputs equal, and the sums over the
    forward. One JSON line, also written to chiprun_out/stem_dw_ab.json."""
    import torch

    from alignq_tpu_torch.kernels import dwconv as DWm
    from alignq_tpu_torch.kernels import infer_mobilenet as M
    from alignq_tpu_torch.kernels import infer_resnet_imagenet as RI
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels import stem as ST

    dev = torch.device("cuda")
    res = {"card": card, "stem": {}, "dw": {}}
    for batch in (SERVE_BATCH, TRUNK_SERVE_BATCH):
        _, (qp, x) = RI.build_resnet_imagenet_int8("resnet50", batch, device=dev, image_size=TRUNK_SIZE)
        op = RI.pack_resnet_imagenet_operands(qp)["conv1"]
        act = K1.act_map("erf", 127, dev, relu=True)

        def old():
            with ST._old_form():
                return ST.stem_pool_codes(x, op, act)

        def new():
            return ST.stem_pool_codes(x, op, act)

        if not torch.equal(old(), new()):
            raise AssertionError(f"the stem kernel differs from the parent's chain at batch {batch}")
        t = [graph_ms(f) for f in (old, new, new, old)]
        row = {"old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2, "runs": t}
        res["stem"][batch] = row
        print(f"stem-dw-ab: the stem chain of ResNet-50 at batch {batch}: parent {row['old_ms']:.4f} ms, new "
              f"{row['new_ms']:.4f} ms (ABBA {', '.join(f'{v:.4f}' for v in t)}) [{card}]", flush=True)
        del qp, x, op
    sms = DWm._sm_count(dev.index)
    for batch in (SERVE_BATCH, FAMILY_SERVE_BATCH):
        _, (qp, x) = M.build_mobilenetv2_int8(batch, device=dev)
        ops = M.pack_mobilenetv2_operands(qp)
        with torch.inference_mode():
            rec = record_launches(lambda: M.mobilenetv2_int8_forward(qp, x, operands=ops))
        rows, old_sum, new_sum = [], 0.0, 0.0
        for kind, args in rec:
            if kind != "dw":
                continue
            xx, op, recorded, impl, act = args
            stride = recorded.stride
            p_old, p_new = DWm.dw_plan(*xx.shape, stride, sms), DWm.dw_sm90_plan(*xx.shape, stride, sms)
            o1, o2 = (torch.empty((xx.shape[0], p_old.Ho, p_old.Wo, xx.shape[3]), dtype=torch.int8, device=dev)
                      for _ in range(2))
            DWm._dw_launch(xx, op, p_old, impl, act, o1)
            DWm._dw_launch(xx, op, p_new, impl, act, o2)
            if not torch.equal(o1, o2):
                raise AssertionError(f"the depthwise Hopper form differs from dwconv.cu's at {tuple(xx.shape)}")
            t = [graph_ms(lambda p_=p_: DWm._dw_launch(xx, op, p_, impl, act, o1))
                 for p_ in (p_old, p_new, p_new, p_old)]
            r = {"shape": list(xx.shape), "stride": stride, "old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2,
                 "runs": t}
            rows.append(r)
            old_sum, new_sum = old_sum + r["old_ms"], new_sum + r["new_ms"]
            print(f"stem-dw-ab: depthwise {tuple(xx.shape)} s{stride} at batch {batch}: dwconv.cu {r['old_ms']:.4f} "
                  f"ms, Hopper form {r['new_ms']:.4f} ms [{card}]", flush=True)
        res["dw"][batch] = {"launches": rows, "old_ms": old_sum, "new_ms": new_sum}
        print(f"stem-dw-ab: depthwise over a MobileNet-V2 forward at batch {batch} ({len(rows)} launches): dwconv.cu "
              f"{old_sum:.4f} ms, Hopper form {new_sum:.4f} ms [{card}]", flush=True)
        del qp, x, ops, rec
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "stem_dw_ab.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))


FIRST_AB_OPTIONS = ((1, 4), (2, 4), (4, 4), (2, 2), (4, 2))  # (MG, warpgroups) of the first-conv kernel's tiles
FIRST_AB_NETS = (("resnet20 slice", (BATCH, SERVE_BATCH, FAMILY_SERVE_BATCH)),
                 ("resnet20 erf", (BATCH, SERVE_BATCH, 64, FAMILY_SERVE_BATCH)),
                 ("densenet40 f32", (SERVE_BATCH, FAMILY_SERVE_BATCH)),
                 ("densenet40 stage_int8", (SERVE_BATCH, FAMILY_SERVE_BATCH)),
                 ("mobilenetv2", (SERVE_BATCH, FAMILY_SERVE_BATCH)))


def first_plane_ab(card) -> None:
    """python3 chip_smoke.py --first-plane-ab: the first-conv kernel and K1's
    plane form against the forms they replaced, in one process, on the
    launches of FIRST_AB_NETS' forwards (ResNet-20's slice and erf routes,
    DenseNet-40 with either buffer, MobileNet-V2): each first conv as its
    chain (linear_q, K1's pad pass and mma.sync form, under
    first_conv._old_form) and at each tile option of the kernel
    (FIRST_AB_OPTIONS), each plane-form launch in the form the rule gave it
    before (mma.sync, or the narrow form; under qmatmul._old_form) and at
    each item
    size (plane_rows: whole images, halves, quarters), in the order old,
    options, options backwards, old (graph_ms,
    cold L2), every output bit for bit the old form's; beside each its
    bound, torch._int_mm on the gathered taps and the option the rule
    gives. Then each forward's K1 sum (its other launches timed once: they
    take the same form either way) in the old forms and by the rule, and
    the whole forward (CUDA events) in the order old, rule, rule, old (old
    under first_conv._old_form and qmatmul._old_form). One JSON line, also
    written to chiprun_out/first_plane_ab.json."""
    import torch

    from alignq_tpu_torch.kernels import first_conv as FC
    from alignq_tpu_torch.kernels import infer as R20
    from alignq_tpu_torch.kernels import qmatmul as K1

    dev = torch.device("cuda")
    fams = {label: (build, fwd, pack, kw) for label, build, fwd, _, pack, kw in family_configs()}
    rows, forwards = [], {}

    def old_forms():
        stack = contextlib.ExitStack()
        stack.enter_context(FC._old_form())
        stack.enter_context(K1._old_form())
        return stack

    for label, batches in FIRST_AB_NETS:
        for batch in batches:
            if label.startswith("resnet20"):
                _, (qp, x) = R20.build_resnet20_int8(batch, device=dev)
                ops = R20.pack_int8_operands(qp)
                kw = dict(act_impl="poly", stream="int16", use_stage_kernel=True, use_pallas_1x1=True) \
                    if label.endswith("slice") else {}

                def fwd():
                    return R20.resnet20_int8_forward(qp, x, operands=ops, **kw)
            else:
                build, fwd_fn, pack, kw = fams[label]
                _, (qp, x) = build(batch, device=dev, **kw)
                ops = pack(qp, **kw)

                def fwd():
                    return fwd_fn(qp, x, operands=ops, **kw)

            with torch.inference_mode():
                launches = distinct_launches(record_launches(fwd))
                sums = {"old": 0.0, "rule": 0.0}
                for key, ((kind, args), count) in launches.items():
                    if kind == "first":
                        xi, op, plan, mode, act, scale = args
                        dtype = torch.float32 if mode in ("f32", "relu") else torch.int8
                        out = torch.empty((xi.numel() // 3, op.n), device=dev, dtype=dtype)
                        opts = {f"first@{mg},{nw}": FC.first_plan(batch, 32, op.n, mg=mg, n_wg=nw)
                                for mg, nw in FIRST_AB_OPTIONS}
                        rule = f"first@{plan.MG},{plan.n_wg}"

                        def old():
                            with FC._old_form():
                                return FC.first_conv(xi, op, scale, act, mode)

                        def new(p):
                            return lambda: FC._first_launch(xi, op, scale, act, mode, p, out)
                    elif kind == "K1" and isinstance(args[2], K1.PlanePlan):
                        xk, op, plan, mode, act, _ = args
                        geo = (*xk.shape, 3, plan.stride, 1, *op.wt.shape)
                        with K1._old_form():  # the form the rule gave the shape before: mma.sync or narrow
                            pm = K1.k1_plan(*geo)
                        out = k1_out(plan, op, mode)
                        opts = {f"plane@{tr}": K1.plane_plan(*geo, rows=tr) for tr in K1.plane_rows(plan.Ho, plan.Wo)}
                        opts = {k: p for k, p in opts.items() if p is not None}
                        rule = f"plane@{plan.TR}"

                        def old():
                            K1._k1_launch(xk, op, pm, out, mode, act)

                        def new(p):
                            return lambda: K1._k1_launch(xk, op, p, out, mode, act)
                    else:
                        if kind == "K1":  # the same form by either rule: timed once
                            xk, op, plan, mode, act, _ = args
                            out = k1_out(plan, op, mode)
                            t = graph_ms(lambda: K1._k1_launch(xk, op, plan, out, mode, act))
                            sums["old"] += count * t
                            sums["rule"] += count * t
                        continue
                    t_old, t_new = [graph_ms(old)], {k: [] for k in opts}
                    for k in list(opts) + list(opts)[::-1]:
                        t_new[k].append(graph_ms(new(opts[k])))
                    t_old.append(graph_ms(old))
                    want = old()
                    torch.cuda.synchronize()
                    want = (out if want is None else want).clone()
                    for k, p in opts.items():  # every option's output is the old form's, bit for bit
                        new(p)()
                        torch.cuda.synchronize()
                        got = out.reshape(want.shape)
                        if not torch.equal(got.view(torch.int32) if got.dtype == torch.float32 else got,
                                           want.view(torch.int32) if want.dtype == torch.float32 else want):
                            raise AssertionError(f"{label} {batch} {key}: {k} differs from the form it replaced")
                    b_ms, b_by, lib_ms = time_launch(kind, args)[2:5] if batch >= SERVE_BATCH else (None, None, None)
                    means = {"old": statistics.mean(t_old), **{k: statistics.mean(v) for k, v in t_new.items()}}
                    best = min(means, key=means.get)
                    sums["old"] += count * means["old"]
                    sums["rule"] += count * means[rule]
                    rows.append(dict(net=label, batch=batch, shape=str(key), launches=count, rule=rule, best=best,
                                     old_ms=t_old, new_ms=t_new, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
                    print(f"first/plane A/B {label} {batch} {key} x{count}: old {t_old[0]:.4f} ms, "
                          + ", ".join(f"{k} {v[0]:.4f}" for k, v in t_new.items())
                          + f", back {', '.join(f'{v[1]:.4f}' for v in list(t_new.values())[::-1])}, old "
                          f"{t_old[1]:.4f}; rule {rule}, fastest {best}; bound "
                          f"{'not timed' if b_ms is None else f'{b_ms:.4f} ({b_by})'}, torch._int_mm "
                          f"{'not timed' if lib_ms is None else f'{lib_ms:.4f}'} [{card}]", flush=True)
                fw = {"old": [], "rule": []}
                for form in ("old", "rule", "rule", "old"):
                    with old_forms() if form == "old" else contextlib.nullcontext():
                        fw[form].append(median_ms(fwd))
            forwards[f"{label} {batch}"] = {"k1_sum_ms": sums, "forward_ms": fw}
            print(f"first/plane A/B {label} batch {batch}: K1 summed over a forward {sums} ms; the forward {fw} ms "
                  f"(order old, rule, rule, old) [{card}]", flush=True)
            del qp, x, ops, launches
            torch.cuda.empty_cache()
    result = {"first_plane_ab": rows, "forwards": forwards, "card": card,
              "rule_misses": [dict(at=f"{r['net']} {r['batch']} {r['shape']}", rule=r["rule"], best=r["best"])
                              for r in rows if r["best"] != r["rule"]]}
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "first_plane_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


DIGIT_AB_OPTIONS = {1: ((1, 3), (2, 3), (4, 4), (1, 1)), 2: ((2, 2), (1, 1), (4, 4))}  # (images, warpgroups)


def bn_digit_ab(card) -> None:
    """python3 chip_smoke.py --bn-digit-ab: the table pass's Hopper kernel
    and the digit kernel against the forms they replaced, in one process.
    Each table launch of a DenseNet-40 stage_int8 forward at batches 256
    and 8 in bn_table_kernel and in the Hopper kernel at each batch of
    work items (quantize.BN_TABLE_ITEMS), in the order old, the options,
    the options backwards, old, outputs equal, and the sums over
    the forward; each digit conv of a forward at batches 256 and 2048 as
    the chain (digit._old_form), as the kernel after its prep pass and as
    the kernel after _linear_q and a pad in PyTorch, ABBA, and each tile
    option (DIGIT_AB_OPTIONS, two CTAs an SM); then the DenseNet-40
    stage_int8 forward at 256 and 8 and the digit forward at 256 and 2048
    both ways (median_ms, ABBA). One JSON line, also written to
    chiprun_out/bn_digit_ab.json."""
    import torch
    import torch.nn.functional as F

    from alignq_tpu_torch.kernels import digit as DSm
    from alignq_tpu_torch.kernels import infer_densenet as D
    from alignq_tpu_torch.kernels import infer_digit as DG
    from alignq_tpu_torch.kernels import quantize as K2
    from alignq_tpu_torch.kernels.infer import _linear_q
    from alignq_tpu_torch.kernels.infer_digit import convert_mnist_dann
    from alignq_tpu_torch.interop import init_mnist_dann_params

    dev = torch.device("cuda")
    sms = K2._sms(torch.cuda.current_device())
    res = {"card": card, "bn_table": {}, "digit": {}, "forwards": {}}
    for batch in (SERVE_BATCH, FAMILY_SERVE_BATCH):
        _, (qp, x) = D.build_densenet40_int8(batch, device=dev, stage_int8=True)
        ops = D.pack_densenet40_operands(qp, stage_int8=True)
        with torch.inference_mode():
            rec = record_launches(lambda: D.densenet40_int8_forward(qp, x, operands=ops, stage_int8=True))
        rows, sums = [], {}
        for kind, args in rec:
            if kind != "bn_table":
                continue
            xx, c_live, table, plan, _, c_out = args
            m, ld = xx.numel() // xx.shape[-1], xx.shape[-1]
            forms = {"old": None, **{f"items {u}": K2.bn_table_plan(m, ld, c_live, c_out, sms, items=u)
                                     for u in K2.BN_TABLE_ITEMS}}
            out = {k: torch.empty((*xx.shape[:-1], c_out), device=dev, dtype=torch.int8) for k in forms}
            for k, p_ in forms.items():
                K2._bn_table_launch(xx, c_live, table, out[k], p_)
            torch.cuda.synchronize()
            for k in forms:
                if not torch.equal(out[k], out["old"]):
                    raise AssertionError(f"bn-digit-ab: the table pass in form {k} differs from bn_table_kernel at "
                                         f"c_live {c_live}, pitch {ld}")
            order = list(forms) + list(forms)[::-1]
            t = [graph_ms(lambda k_=k: K2._bn_table_launch(xx, c_live, table, out[k_], forms[k_])) for k in order]
            r = {k: (t[order.index(k)] + t[len(order) - 1 - order.index(k)]) / 2 for k in forms}
            hop = forms[f"items {K2.bn_table_plan(m, ld, c_live, c_out, sms).U}"]  # the Hopper kernel's own choice
            r.update(c_live=c_live, ld=ld, c_out=c_out, rows=m, rule="old" if plan is None else f"items {plan.U}",
                     R=hop.R, ctas=hop.ctas, runs=t)
            rows.append(r)
            for k in (*forms, "rule"):
                sums[k] = sums.get(k, 0.0) + r[r["rule"] if k == "rule" else k]
            print(f"bn-digit-ab: table pass c_live {c_live} pitch {ld} ({m} rows) at batch {batch}: "
                  + ", ".join(f"{k} {r[k]:.4f}" for k in forms) + f" ms (rule: {r['rule']}) [{card}]", flush=True)
        res["bn_table"][batch] = {"launches": rows, "sums": sums}
        print(f"bn-digit-ab: the table pass over a DenseNet-40 stage_int8 forward at batch {batch} ({len(rows)} "
              f"launches): " + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()) + f" ms [{card}]", flush=True)
        def fwd():
            return D.densenet40_int8_forward(qp, x, operands=ops, stage_int8=True)

        def fwd_old():
            with K2._old_form():
                return fwd()

        with torch.inference_mode():
            t = [median_ms(f) for f in (fwd_old, fwd, fwd, fwd_old)]
        res["forwards"][f"densenet40 stage_int8 batch {batch}"] = {"old_ms": (t[0] + t[3]) / 2,
                                                                  "new_ms": (t[1] + t[2]) / 2, "runs": t}
        print(f"bn-digit-ab: DenseNet-40 stage_int8 forward at batch {batch}: bn_table_kernel {(t[0] + t[3]) / 2:.4f}"
              f" ms, the rule's forms {(t[1] + t[2]) / 2:.4f} ms [{card}]", flush=True)
        del qp, x, ops, rec
    params, stats = init_mnist_dann_params(torch.Generator().manual_seed(SEED), "cpu")
    qp = to_device(convert_mnist_dann(params, stats), dev)
    dops = DG.pack_mnist_dann_operands(qp)
    for batch in DIGIT_TIME_BATCHES:
        x = torch.rand((batch, 28, 28, 3), generator=torch.Generator().manual_seed(batch)).to(dev) * 2 - 1
        with torch.inference_mode():
            rec = record_launches(lambda: DG.mnist_dann_int8_forward(qp, x, operands=dops))
        entry = {}
        for kind, (xin, op, plan, act) in rec:
            conv = plan.conv
            c = DSm.CONVS[conv]
            out = torch.empty((batch, c.pooled, c.pooled, c.n), device=dev, dtype=torch.int8)

            def chain(xin=xin, op=op, act=act, conv=conv):
                with DSm._old_form():
                    return DSm.conv_pool(conv, xin, op, act)

            def new(xin=xin, op=op, act=act, conv=conv):
                return DSm.conv_pool(conv, xin, op, act)

            def glue(xin=xin, op=op, act=act, plan=plan, out=out):  # _linear_q and a pad in PyTorch
                DSm._digit_launch(F.pad(_linear_q(xin, DSm.S_DIGIT), (0, 1, 3, 1)), op, act, plan, out)

            want = chain()
            if not torch.equal(new(), want):
                raise AssertionError(f"bn-digit-ab: the digit kernel differs from the chain, conv {conv}")
            fns = {"chain": chain, "kernel": new}
            if conv == 1:
                glue()
                if not torch.equal(out, want):
                    raise AssertionError("bn-digit-ab: the digit kernel after PyTorch's prep differs from the chain")
                fns["kernel, prep in PyTorch"] = glue
            order = list(fns) + list(fns)[::-1]
            t = [graph_ms(fns[k]) for k in order]
            r = {k: (t[order.index(k)] + t[len(order) - 1 - order.index(k)]) / 2 for k in fns}
            xk = DSm.digit_prep(xin) if conv == 1 else xin
            opts = {}
            for img, wg in DIGIT_AB_OPTIONS[conv]:
                p_ = DSm.digit_plan(conv, batch, sms, img, wg)
                DSm._digit_launch(xk, op, act, p_, out)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"bn-digit-ab: the digit kernel's option {img}x{wg} differs, conv {conv}")
                opts[f"{img} images, {wg} warpgroups"] = graph_ms(lambda p_=p_: DSm._digit_launch(xk, op, act, p_, out))
            r.update(runs=t, options=opts, rule=f"{plan.IMG} images, {plan.n_wg} warpgroups")
            entry[f"conv{conv}"] = r
            print(f"bn-digit-ab: digit conv{conv} at batch {batch}: " + ", ".join(f"{k} {r[k]:.4f}" for k in fns)
                  + " ms; the kernel's options " + ", ".join(f"{k} {v:.4f}" for k, v in opts.items())
                  + f" (rule {r['rule']}) [{card}]", flush=True)
        res["digit"][batch] = entry

        def dfwd():
            return DG.mnist_dann_int8_forward(qp, x, operands=dops)

        def dfwd_old():
            with DSm._old_form():
                return dfwd()

        with torch.inference_mode():
            t = [median_ms(f) for f in (dfwd_old, dfwd, dfwd, dfwd_old)]
        res["forwards"][f"digit batch {batch}"] = {"old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2, "runs": t}
        print(f"bn-digit-ab: digit forward at batch {batch}: the chain {(t[0] + t[3]) / 2:.4f} ms, the kernel "
              f"{(t[1] + t[2]) / 2:.4f} ms [{card}]", flush=True)
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bn_digit_ab.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))


TOOLS_SMOKE = ("model_zoo_bench", "serve_bench", "artifact_bench", "qat_throughput", "qat_breakdown")
BENCH_CEILING_KEYS = ("frac_of_achievable", "frac_of_nominal", "conv_ceiling_ms", "epilogue_isolated_ms",
                      "residual_vs_mandatory")


def tools_phase(card, details, phase):
    """Phase 26, the tools: (a) the bench (alignq_tpu_torch.bench.main, the
    entry point `python -m alignq_tpu_torch.bench` calls) at batch 2048 with
    bench.py's ceiling keys, measured in this process on the card: every
    key non-null, frac_of_achievable in (0, 1], the conv ceiling below the
    forward's ms; (b) the zoo, serving, artifact and QAT tools
    (alignq_tpu_torch/tools/) at --smoke, each printing the card line and
    its rows."""
    import importlib

    from alignq_tpu_torch import bench

    phase("tools (a): the bench with its ceiling keys")
    t0 = time.perf_counter()
    row = bench.main([])
    e2e_ms = row["batch"] / row["value"] * 1e3
    if any(row[k] is None for k in BENCH_CEILING_KEYS) or row["batch"] != BATCH:
        raise AssertionError(f"the bench left a ceiling key null or ran at another batch: {row}")
    if not (0 < row["frac_of_achievable"] <= 1 and row["conv_ceiling_ms"] < e2e_ms):
        raise AssertionError(f"the bench's conv ceiling {row['conv_ceiling_ms']} ms against its forward's "
                             f"{e2e_ms} ms: frac_of_achievable {row['frac_of_achievable']}")
    print(f"bench: {json.dumps(row)} [{card}] ({time.perf_counter() - t0:.1f} s)", flush=True)
    out = {"bench": row}
    phase("tools (b): the zoo, serving, artifact and QAT tools at --smoke")
    t0 = time.perf_counter()
    for tool in TOOLS_SMOKE:
        out[tool] = importlib.import_module(f"alignq_tpu_torch.tools.{tool}").main(["--smoke"])
    out["smoke_s"] = time.perf_counter() - t0
    print(f"tools at --smoke: {', '.join(TOOLS_SMOKE)} in {out['smoke_s']:.1f} s [{card}]", flush=True)
    details["tools"] = out


def main() -> int:
    import numpy as np
    import torch

    if sys.argv[1:2] == ["--dp-rank"]:
        return dp_rank_main(sys.argv[2:])
    if sys.argv[1:2] == ["--tp-rank"]:
        return tp_rank_main(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from alignq_tpu_torch.kernels import _build
    from alignq_tpu_torch.kernels import digit as DSm
    from alignq_tpu_torch.kernels import dwconv as DWm
    from alignq_tpu_torch.kernels import first_conv as FC
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels import quantize as K2
    from alignq_tpu_torch.kernels import stage_kernel as K3
    from alignq_tpu_torch.kernels import stem as ST
    from alignq_tpu_torch.kernels.convert import QConvInt8
    from alignq_tpu_torch.kernels.infer import (
        act_int_cutpoints,
        augment_int_cutpoints,
        build_resnet20_int8,
        convert_resnet20,
        pack_int8_operands,
        resnet20_int8_forward,
        resnet20_int8_head,
        resnet20_int8_stream,
    )
    from alignq_tpu_torch.interop import init_preact_resnet_params
    from alignq_tpu_torch.serve import build_int8_resnet20_engine

    dev = torch.device("cuda")
    details = {}
    t_start = time.perf_counter()

    def phase(name):
        print(f"[{time.perf_counter() - t_start:.0f} s] {name}", flush=True)

    # 1. the card
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    details["card"] = card

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {sorted(reports)} built in {build_s:.1f} s", flush=True)
    details["build_s"] = build_s
    details["ptxas"] = reports
    if sys.argv[1:] == ["--gather-backward-ab"]:
        gather_backward_ab(repo, card)
        return 0
    if sys.argv[1:] == ["--agreement-study"]:
        agreement_study(repo, card)
        return 0
    if sys.argv[1:] == ["--fma-ab"]:
        fma_ab(card)
        return 0
    if sys.argv[1:] == ["--k1-ab"]:
        k1_ab(card)
        return 0
    if sys.argv[1:] == ["--k3-ab"]:
        k3_ab(card, reports.get("stage_kernel_sm90", ""))
        return 0
    if sys.argv[1:] == ["--tp-only"]:
        tp_phase(dev, card, repo, details, phase)
        return 0
    if sys.argv[1:] == ["--tools-only"]:
        tools_phase(card, details, phase)
        return 0
    if sys.argv[1:] == ["--stem-dw-ab"]:
        stem_dw_ab(card)
        return 0
    if sys.argv[1:] == ["--bn-digit-ab"]:
        bn_digit_ab(card)
        return 0
    if sys.argv[1:] == ["--first-plane-ab"]:
        first_plane_ab(card)
        return 0
    if sys.argv[1:] == ["--k2-ab"]:
        k2_ab(card)
        return 0
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def i8(shape, lo=-127, hi=128):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int8)

    def code_epilogue(k, n):
        """Per-column scale and bias that spread h = acc * s + b over the
        act grid (|h| up to ~4 for int8 operands drawn uniformly), some
        scales negative, as folded BN gives."""
        s = (torch.rand(n, generator=gen, device=dev) * 2 - 0.4) * 2 / (k**0.5 * 73.3**2)
        return s, torch.randn(n, generator=gen, device=dev) * 0.5

    # 2(b). the table form of the act-code map against its direct map
    phase("the act-code table form against its direct map, every f32 bit pattern")
    details["act_table_checks"] = act_table_checks(dev)

    # 3. K1 against its plain version
    phase("K1 against its plain version")
    k1_err = 0.0
    k1_ops = {}
    code_counts = {}
    cases = [(b, *shape) for b in (BATCH, SERVE_BATCH) for shape in k1_shapes(b)]
    for batch, name, m, k, n in cases + [(None, "ragged", 1000003, 27, 16)]:
        x, w = i8((m, k)), i8((k, n))
        scale = torch.rand(n, generator=gen, device=dev) * 2e-4
        bias = torch.randn(n, generator=gen, device=dev)
        raw, raw_ref = K1.int8_matmul_int32(x, w), K1.int8_matmul_int32_reference(x, w)
        torch.cuda.synchronize()
        if not torch.equal(raw, raw_ref):
            raise AssertionError(f"K1 int32 {name} M={m} differs from its plain version")
        del raw, raw_ref
        y, y_ref = K1.int8_matmul_dequant(x, w, scale, bias), K1.int8_matmul_dequant_reference(x, w, scale, bias)
        torch.cuda.synchronize()
        diff = f32_mismatches(y, y_ref)
        err = float((y - y_ref).abs().max())
        del y, y_ref
        if diff > 1e-6 * m * n:
            raise AssertionError(f"K1 f32 {name} M={m}: {diff} of {m * n} elements differ")
        k1_err = max(k1_err, err)
        # the codes epilogue, on scales that spread the codes over the grid
        cs, cb = code_epilogue(k, n)
        op = K1.pack_k1_weights(w, cs, cb)
        maps = {"poly": K1.act_map("poly", 127, dev), "erf": K1.act_map("erf", 127, dev)}
        if batch in (SERVE_BATCH, None):
            maps["bins"] = K1.act_map("bins", 7, dev)
            maps["bins_int"] = K1.pack_act_cutpoints(act_int_cutpoints(QConvInt8(w, cs, cb), 4), op.wt.shape[0])
        counts = {}
        for impl, act in maps.items():
            got, want = K1.int8_matmul_codes(x, op, act), K1.int8_matmul_codes_reference(x, op, act)
            torch.cuda.synchronize()
            counts[impl] = code_mismatches(got, want, f"K1 {impl} codes {name} M={m}")
            k1_err = max(k1_err, float((got.int() - want.int()).abs().max()))
            code_counts[f"{impl} {name} M={m}"] = counts[impl]
        print(f"K1 GEMM form {name} M={m} K={k} N={n}: int32 identical; f32 differs on {diff} of {m * n} "
              f"(max abs {err:.3g}); codes differ on {counts} of {m * n}", flush=True)
        del x, w

    # the conv form, on NHWC codes read in place, at every path conv of
    # batches 2048 (poly and erf) and 256 and a ragged batch 3 (every mode)
    conv_cases = [(b, *shape) for b in (BATCH, SERVE_BATCH, 3) for shape in conv_shapes(b)]
    form_pairs = {"NarrowPlan": 0, "PlanePlan": 0}
    for batch, name, b, h, w, cin, ksize, stride, n in conv_cases:
        pad = 1 if ksize == 3 else 0
        x = i8((b, h, w, cin))
        kern = i8((ksize, ksize, cin, n))
        cs, cb = code_epilogue(ksize * ksize * cin, n)
        op = K1.pack_conv_weights(kern, cs, cb)
        maps = {"poly": K1.act_map("poly", 127, dev), "erf": K1.act_map("erf", 127, dev)}
        counts = {}
        if batch != BATCH:
            maps["bins"] = K1.act_map("bins", 7, dev)
            maps["bins_int"] = K1.pack_act_cutpoints(act_int_cutpoints(QConvInt8(kern, cs, cb), 4), op.wt.shape[0])
            raw = K1.int8_conv_packed(x, op, stride, pad, "int32")
            raw_ref = K1.int8_conv_reference(x, op, stride, pad, "int32")
            torch.cuda.synchronize()
            if not torch.equal(raw, raw_ref):
                raise AssertionError(f"K1 conv int32 {name} batch {batch} differs from its plain version")
            del raw, raw_ref
            for mode in ("f32", "relu"):
                y, y_ref = K1.int8_conv_packed(x, op, stride, pad, mode), K1.int8_conv_reference(x, op, stride, pad, mode)
                torch.cuda.synchronize()
                counts[mode] = f32_mismatches(y, y_ref)
                k1_err = max(k1_err, float((y - y_ref).abs().max()))
                if counts[mode] > 1e-6 * y.numel():
                    raise AssertionError(f"K1 conv {mode} {name} batch {batch}: {counts[mode]} elements differ")
                del y, y_ref
        for impl, act in maps.items():
            got = K1.int8_conv_codes(x, op, stride, pad, act)
            want = K1.int8_conv_reference(x, op, stride, pad, impl, act)
            torch.cuda.synchronize()
            counts[impl] = code_mismatches(got, want, f"K1 conv {impl} codes {name} batch {batch}")
            k1_err = max(k1_err, float((got.int() - want.int()).abs().max()))
            code_counts[f"conv {impl} {name} batch {batch}"] = counts[impl]
            del got, want
        # the launch's form by the rule; a narrow- or plane-form launch also
        # against the mma.sync form on the same operands, bit for bit, in each
        # mode checked (the plane form's also with the maps relu'd)
        xc = K1._conv_input(x, op)
        plan = K1.k1_plan(*xc.shape, ksize, stride, pad, *op.wt.shape)
        narrow_r20, plane_r20 = r20_forms(b)
        if (name in narrow_r20) != isinstance(plan, K1.NarrowPlan) or \
                (name in plane_r20) != isinstance(plan, K1.PlanePlan):
            raise AssertionError(f"K1 conv {name} batch {batch}: the rule gave it {type(plan).__name__}")
        paired = isinstance(plan, (K1.NarrowPlan, K1.PlanePlan))
        if paired:
            modes = [(m, None) for m in ("int32", "f32", "relu", "requant")] * (batch != BATCH) + list(
                (a.impl, a) for a in maps.values())
            if isinstance(plan, K1.PlanePlan):
                modes += [(impl, K1.act_map(impl, 127, dev, relu=True)) for impl in ("poly", "erf")]
            form_pair(xc, op, plan, modes)
            form_pairs[type(plan).__name__] += len(modes)
        print(f"K1 conv {name} batch {b} {h}x{w}x{cin} k{ksize} s{stride} N={n} ({option_of(plan)}): "
              f"{'int32 identical; ' if batch != BATCH else ''}differing elements {counts} of "
              f"{b * ((h - 1) // stride + 1) * ((w - 1) // stride + 1) * n}"
              f"{'; the mma.sync form bit for bit in each mode' if paired else ''}",
              flush=True)
        if batch in (BATCH, SERVE_BATCH) and conv_shapes(batch)[name, b, h, w, cin, ksize, stride, n] != (0, 0):
            k1_ops[batch, name] = (x, kern, cs, cb, op, stride, pad)
    details["k1_code_mismatches"] = code_counts
    print(f"K1's narrow Hopper form: {form_pairs['NarrowPlan']} launches, its plane form: "
          f"{form_pairs['PlanePlan']}, each bit for bit the mma.sync form's", flush=True)
    # the first conv from the f32 image, at each family's width and in the
    # modes its sites use, against its plain version and its chain
    first_err, first_ops = first_conv_checks(dev, gen, code_epilogue)
    plane_err = k1_err

    # 4. K2's path, its entry point, then its results against the plain
    # version and the direct kernel, and the Hopper form against the direct
    # kernel on every f32 pattern
    phase("K2: its entry point, against its plain version and its direct kernel")
    k2_inputs = [(b, name, torch.randn(n, generator=gen, device=dev) * 1.5)
                 for b in (BATCH, SERVE_BATCH) for name, n in act_site_sizes(b)]
    k2_inputs.append((None, "ragged", torch.randn((1000003,), generator=gen, device=dev) * 1.5))
    k2_inputs.append((None, "view 1 element in",
                      (torch.randn((K2.K2_MIN_N + 4097,), generator=gen, device=dev) * 1.5)[1:]))
    zero_counts(_build.launches)
    k2_out = [K2.cdf_quantize_int8(x) for _, _, x in k2_inputs]
    torch.cuda.synchronize()
    k2_launches = {k: v for k, v in _build.launches.items() if v}
    if k2_launches != {K2.KERNEL: len(k2_inputs), K2.KERNEL_SM90: len(k2_inputs)}:
        raise AssertionError(f"K2's path launched {k2_launches}, expected {len(k2_inputs)} K2 launches, all in its "
                             f"Hopper form")
    k2_err = 0
    for (batch, name, x), got in zip(k2_inputs, k2_out):
        want = K2.cdf_quantize_int8_plain(x)
        diff = code_mismatches(got, want, f"K2 {name} n={x.numel()}")
        k2_err = max(k2_err, int((got.int() - want.int()).abs().max()))
        with K2._old_form():
            if not torch.equal(got, K2.cdf_quantize_int8(x)):
                raise AssertionError(f"K2's Hopper form differs from its direct kernel at {name} n={x.numel()}")
        print(f"K2 {name} batch {batch} n={x.numel()}: codes differ from the plain version on {diff} of "
              f"{x.numel()}; bit for bit the direct kernel's", flush=True)
    del k2_out
    k2_inputs.pop()  # the view: checked, not timed
    details["k2_every_f32"] = k2_every_f32(dev)
    if details["k2_every_f32"]["differing"]:
        raise AssertionError(f"K2's Hopper form differs from its direct kernel on {details['k2_every_f32']}")

    # 5. K3 against its plain version and its two forms against each other
    # (the path's runs at batch 2048, 256 and 3, g=7, and 8-block runs)
    phase("K3 against its plain version, both forms")
    _, (qp, _) = build_resnet20_int8(1, device=dev)
    layers = qp["layers"]
    k3_runs = [(batch, name, K3.pack_block_weights(blocks), ms, hw, 127) for batch in (BATCH, SERVE_BATCH, 3)
               for name, blocks, ms, hw in (("stage1 blocks 0-2", layers[0:3], (1, 2, 3), 32),
                                            ("stage2 blocks 4-5", layers[4:6], (2, 3), 16),
                                            ("stage3 blocks 7-8", layers[7:9], (2, 3), 8))]
    k3_runs.append((64, "stage1 A4 grid", K3.pack_block_weights(layers[0:1]), (2,), 32, 7))
    for c, hw in ((16, 32), (32, 16), (64, 8)):  # ResNet-56's runs of 8 blocks: the weights stream
        n = len(K3_DEEP_MS)
        wt = torch.randint(-20, 20, (n, 2, c, 9 * c), generator=gen, device=dev, dtype=torch.int8)
        scale = torch.rand((n, 2, c), generator=gen, device=dev) * 1e-3
        bias = (torch.rand((n, 2, c), generator=gen, device=dev) - 0.5) * 0.1
        k3_runs.append((K3_DEEP_BATCH, f"8 blocks C={c}", (wt, scale, bias), K3_DEEP_MS, hw, 127))
    k3_err = 0
    k3_ops = {}
    k3_diffs = {}
    for batch, name, (wt, scale, bias), ms, hw, g in k3_runs:
        c = wt.shape[2]
        # the NHWC stream, the forward's own layout
        stream = torch.randint(0, 4 * g, (batch, hw, hw, c), generator=gen, device=dev, dtype=torch.int16)
        before = dict(_build.launches)
        got = K3.stage_identity_blocks_nhwc(stream, wt, scale, bias, ms, g=g)
        sm90 = _build.launches[K3.SM90] - before.get(K3.SM90, 0)
        with K3._old_form():
            old = K3.stage_identity_blocks_nhwc(stream, wt, scale, bias, ms, g=g)
        want = K3.stage_identity_blocks_nhwc_reference(stream, wt, scale, bias, ms, g)
        torch.cuda.synchronize()
        diff, diff_old = int((got != want).sum()), int((got != old).sum())
        err = int((got.int() - want.int()).abs().max())
        k3_diffs[f"{name} batch {batch}"] = {"vs_plain": diff, "vs_old_form": diff_old, "old_vs_plain":
                                             int((old != want).sum()), "codes": got.numel()}
        print(f"K3 {name} C={c} {hw}x{hw} batch {batch} ms={ms} g={g} ({'Hopper' if sm90 else 'mma.sync'} form): "
              f"stream differs from the plain version's on {diff} of {got.numel()} codes, from the mma.sync "
              f"form's on {diff_old}", flush=True)
        if diff or diff_old or k3_diffs[f"{name} batch {batch}"]["old_vs_plain"]:
            raise AssertionError(f"K3 {name} batch {batch}: streams differ: {k3_diffs[f'{name} batch {batch}']}")
        if sm90 != 1:
            raise AssertionError(f"K3 {name} batch {batch}: the planner gave it the mma.sync form")
        k3_err = max(k3_err, err)
        if g == 127 and batch in (BATCH, SERVE_BATCH):
            k3_ops[batch, name] = (stream, wt, scale, bias, ms, hw)
    details["k3_differing_codes"] = k3_diffs

    # 6. forwards on the card against the CPU, on qparams converted once on
    # the CPU (so both sides hold the same weight codes)
    phase("forwards on the card against the CPU")
    slice_kw = dict(act_impl="poly", stream="int16", use_stage_kernel=True, use_pallas_1x1=True)
    _, (_, x_cpu) = build_resnet20_int8(64, device="cpu")
    params, stats = init_preact_resnet_params(20, torch.Generator().manual_seed(SEED + 1), "cpu")
    keys = (K1.KERNEL, K1.CODES, K1.F32, K1.NARROW, K1.PLANE, FC.FIRST, K3.KERNEL, K3.SM90, K1.TAP_GATHERS)
    n_slice, n_erf = NARROW_PER_FORWARD["resnet20 slice"], NARROW_PER_FORWARD["resnet20 erf"]
    p_slice, p_erf = PLANE_PER_FORWARD["resnet20 slice"], PLANE_PER_FORWARD["resnet20 erf"]
    for label, (wbits, abits), kw, k1_per_fwd, k3_per_fwd, narrow_per_fwd, plane_per_fwd in (
        ("slice poly+K3+K1", (8, 8), slice_kw, 7, 3, n_slice, p_slice),
        ("default erf/int16", (8, 8), {}, 21, 0, n_erf, p_erf),
        ("A4 bins", (8, 4), {"act_impl": "bins"}, 21, 0, n_erf, p_erf),
        ("W4A4 bins_int", (4, 4), {"act_impl": "bins_int"}, 21, 0, n_erf, p_erf),
    ):
        qp_cpu = convert_resnet20(params, stats, weight_bits=wbits, act_bits=abits)
        if kw.get("act_impl") == "bins_int":
            qp_cpu = augment_int_cutpoints(qp_cpu, abits)
        qp_gpu = to_device(qp_cpu, dev)
        before = dict(_build.launches)
        s_gpu = resnet20_int8_stream(qp_gpu, x_cpu.to(dev), act_bits=abits, **kw)
        torch.cuda.synchronize()
        counts = {k: _build.launches[k] - before.get(k, 0) for k in keys}
        s_cpu = resnet20_int8_stream(qp_cpu, x_cpu, act_bits=abits, **kw)
        l_gpu = resnet20_int8_head(qp_gpu, s_gpu, abits).cpu()
        l_cpu = resnet20_int8_head(qp_cpu, s_cpu, abits)
        if not torch.equal(s_gpu.cpu(), s_cpu):
            raise AssertionError(f"{label}: the final int16 stream differs between CUDA and CPU")
        lerr = float((l_gpu - l_cpu).abs().max())
        if not (torch.isfinite(l_gpu).all() and lerr <= 1e-4 and l_gpu.shape == (64, 10)):
            raise AssertionError(f"{label}: logits off by {lerr}")
        want = {K1.KERNEL: k1_per_fwd, K1.CODES: k1_per_fwd, K1.F32: 0, K1.NARROW: narrow_per_fwd,
                K1.PLANE: plane_per_fwd, FC.FIRST: 1, K3.KERNEL: k3_per_fwd, K3.SM90: k3_per_fwd,
                K1.TAP_GATHERS: 0}
        if counts != want:
            raise AssertionError(f"{label}: launches per forward {counts}, expected {want}")
        print(f"forward {label} batch 64: int16 stream identical to CPU, logits max abs {lerr:.3g}, "
              f"launches per forward {counts}", flush=True)

    # 7. serving: the main path, through the entry points a user calls
    phase("serving")
    params, stats = init_preact_resnet_params(20, torch.Generator().manual_seed(SEED + 1), dev)
    reqs = [torch.randn((n, 32, 32, 3), generator=torch.Generator().manual_seed(10 + n)).numpy()
            for n in (1, 3, 100, 256, 40)]

    def serve_and_check(label, kw, reqs, tree=None):
        """Serve reqs on an engine of the route kw, on the (params,
        batch_stats) tree given (default: the random ResNet-20); return the
        engine and the launch counts of its build and its requests. What
        was served is held against the CPU's plain path."""
        zero_counts(_build.launches)
        engine = build_int8_resnet20_engine(*(tree or (params, stats)), batch_size=SERVE_BATCH, device=dev, **kw)
        futs = [engine.submit(r) for r in reqs]
        outs = [f.result(timeout=300) for f in futs]
        torch.cuda.synchronize()
        launched = {k: v for k, v in _build.launches.items() if v}
        print(f"serving {label}: requests of {[len(r) for r in reqs]} answered; launches {launched}", flush=True)
        # the int16 stream of the engine's forward at its padded batch (the
        # kernels at the serving shapes) bit for bit, each request's logits
        qp_host = to_device(engine.params, "cpu")
        images = np.concatenate(reqs)
        padded = np.concatenate([images, np.zeros((-len(images) % SERVE_BATCH, 32, 32, 3), np.float32)])
        served = np.concatenate(outs)
        serve_err = 0.0
        for lo in range(0, len(padded), SERVE_BATCH):
            xb = torch.from_numpy(padded[lo : lo + SERVE_BATCH])
            with torch.inference_mode():
                s_gpu = resnet20_int8_stream(engine.params, xb.to(dev), **engine.forward.keywords).cpu()
            s_cpu = resnet20_int8_stream(qp_host, xb, **kw)
            if not torch.equal(s_gpu, s_cpu):
                raise AssertionError(f"{label} images {lo}-{lo + SERVE_BATCH}: the engine's int16 stream "
                                     "differs from the CPU's")
            want = resnet20_int8_head(qp_host, s_cpu).numpy()[: min(SERVE_BATCH, len(served) - lo)]
            got = served[lo : lo + len(want)]
            serve_err = max(serve_err, float(np.abs(got - want).max()))
            if not (np.isfinite(got).all() and np.abs(got - want).max() <= 1e-4):
                raise AssertionError(f"{label} images {lo}-{lo + len(want)}: served logits off the CPU's "
                                     f"by {serve_err}")
        print(f"serving {label}: every served image's logits within {serve_err:.3g} of the CPU plain path; "
              f"the engine's batch-{SERVE_BATCH} int16 stream identical to the CPU's", flush=True)
        return engine, outs, launched

    engine, outs, main_launches = serve_and_check("slice route (main path)", slice_kw, reqs)
    if any(main_launches.get(k, 0) == 0 for k in (K1.KERNEL, K3.KERNEL)):
        raise AssertionError(f"the main path did not launch every kernel: {main_launches}")
    if main_launches[K1.KERNEL] * 3 != main_launches[K3.KERNEL] * 7:
        raise AssertionError(f"main-path launches {main_launches} are not 7 K1 : 3 K3 per forward")
    if main_launches.get(K3.SM90, 0) != main_launches[K3.KERNEL]:
        raise AssertionError(f"main path: K3 launches not all in the Hopper form: {main_launches}")
    if main_launches.get(K1.NARROW, 0) * 7 != main_launches[K1.KERNEL] * n_slice:
        raise AssertionError(f"main path: not {n_slice} of 7 K1 launches a forward in the narrow form: {main_launches}")
    if main_launches.get(K1.PLANE, 0) * 7 != main_launches[K1.KERNEL] * p_slice or \
            main_launches.get(FC.FIRST, 0) * 7 != main_launches[K1.KERNEL]:
        raise AssertionError(f"main path: not {p_slice} of 7 K1 launches a forward in the plane form and 1 in the "
                             f"first-conv kernel: {main_launches}")
    if main_launches.get(K1.CODES, 0) != main_launches[K1.KERNEL] or main_launches.get(K1.F32, 0):
        raise AssertionError(f"main path: K1 launches not all in codes mode: {main_launches}")
    if main_launches.get(K1.TAP_GATHERS, 0):
        raise AssertionError(f"main path: a conv gathered its taps on the card: {main_launches}")
    again = engine.submit(reqs[2]).result(timeout=300)
    if not (again == outs[2]).all():
        raise AssertionError("a repeated request gave other logits")
    # the engine's own times, on the host clock: one image at a time, then
    # a backlog of full batches
    lat = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        engine.submit(reqs[0]).result(timeout=300)
        lat.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for f in [engine.submit(reqs[3]) for _ in range(32)]:
        f.result(timeout=300)
    backlog_s = time.perf_counter() - t0
    engine.close()
    details["serving"] = {"main_path_launches": main_launches, "one_image_ms_p50": statistics.median(lat),
                          "one_image_ms_max": max(lat), "backlog_images_per_s": 32 * 256 / backlog_s}
    print(f"serving times: one-image request {statistics.median(lat):.2f} ms median ({max(lat):.2f} max); "
          f"32 x 256 images {32 * 256 / backlog_s:.0f} images/s [{card}]", flush=True)
    # the default erf route: 21 K1 launches a forward, every one in codes mode
    engine, _, erf_launches = serve_and_check("default erf route", {}, reqs[:3])
    engine.close()
    n_k1 = erf_launches.get(K1.KERNEL, 0)
    if n_k1 == 0 or n_k1 % 21 or erf_launches.get(K1.CODES, 0) != n_k1 or erf_launches.get(K1.F32, 0) \
            or erf_launches.get(K1.NARROW, 0) * 21 != n_k1 * n_erf or \
            erf_launches.get(K1.PLANE, 0) * 21 != n_k1 * p_erf or erf_launches.get(FC.FIRST, 0) * 21 != n_k1:
        raise AssertionError(f"erf route: launches {erf_launches}, expected 21 codes-mode K1 a forward, {n_erf} "
                             f"of them in the narrow form, {p_erf} in the plane form, 1 in the first-conv kernel")
    if erf_launches.get(K1.TAP_GATHERS, 0):
        raise AssertionError(f"erf route: a conv gathered its taps on the card: {erf_launches}")
    details["serving"]["erf_route_launches"] = erf_launches

    # 8. the QAT half of the main path: train on the card, export, serve
    phase("QAT on the card")
    details["qat"] = qat_on_the_card(dev, repo, serve_and_check, reqs, slice_kw)

    # 9. the QAT of DenseNet-40 and MobileNet-V2: train, export, serve
    details["family_qat"] = family_qat(dev, card, repo, phase)

    # 10. times
    phase("times")
    details["forward"] = {}
    for batch in (BATCH, SERVE_BATCH):
        _, (qp_b, x_b) = build_resnet20_int8(batch, device=dev)
        ops_b = pack_int8_operands(qp_b)  # laid out once, as an engine does
        fwd_ms = median_ms(lambda: resnet20_int8_forward(qp_b, x_b, operands=ops_b, **slice_kw))
        print(f"forward batch {batch} (slice route): {fwd_ms:.4f} ms = {batch / fwd_ms * 1e3:.0f} images/s "
              f"[{card}]", flush=True)
        default_ms = median_ms(lambda: resnet20_int8_forward(qp_b, x_b, operands=ops_b))
        print(f"forward batch {batch} (default erf/int16): {default_ms:.4f} ms = "
              f"{batch / default_ms * 1e3:.0f} images/s [{card}]", flush=True)
        details["forward"][batch] = {"slice_ms": fwd_ms, "default_erf_ms": default_ms,
                                     "slice_images_per_s": batch / fwd_ms * 1e3}
        del qp_b, x_b, ops_b

    rows = {K1.KERNEL: [], K2.KERNEL: [], K3.KERNEL: []}
    for (batch, name), (x, kern, cs, cb, op, stride, pad) in k1_ops.items():
        _, b, h, w, cin, ksize, _, n = next(key for key in conv_shapes(batch) if key[0] == name)
        if name == "stem conv":  # the main path's first conv runs the first-conv kernel from the f32 image
            rows[K1.KERNEL].append(first_conv_row(batch, *first_ops[batch],
                                                  conv_shapes(batch)[name, b, h, w, cin, ksize, stride, n], card))
            continue
        xc = K1._conv_input(x, op)  # as the kernel takes it: the stem's channels padded to 4
        plan = K1.k1_plan(*xc.shape, ksize, stride, pad, *op.wt.shape)
        tile = f"{plan.TM} rows" if isinstance(plan, (K1.Sm90Plan, K1.NarrowPlan)) else \
            f"items of {plan.TR} rows" if isinstance(plan, K1.PlanePlan) else f"{plan.TR}x{plan.TW}"
        m = plan.B * plan.Ho * plan.Wo
        out_c = torch.empty((m, op.wt.shape[0]), device=dev, dtype=torch.int8)
        out_f = torch.empty((m, op.wt.shape[0]), device=dev)
        maps = {impl: K1.act_map(impl, 127, dev) for impl in ("poly", "erf")}
        code_ms = {impl: graph_ms(lambda: K1._k1_launch(xc, op, plan, out_c, impl, maps[impl]), runs=LAUNCH_RUNS)
                   for impl in ("poly", "erf")}
        f32_ms = graph_ms(lambda: K1._k1_launch(xc, op, plan, out_f, "f32"), runs=LAUNCH_RUNS)
        pad_ms = graph_ms(lambda: K1._conv_input(x, op), runs=LAUNCH_RUNS) if x.shape[-1] != op.cin else None
        old_ms = {}  # a plane-form launch in the form it replaced (mma.sync, or the narrow form)
        if isinstance(plan, K1.PlanePlan):
            with K1._old_form():
                pm = K1.k1_plan(*xc.shape, ksize, stride, pad, *op.wt.shape)
            old_ms = {impl: graph_ms(lambda: K1._k1_launch(xc, op, pm, out_c, impl, maps[impl]), runs=LAUNCH_RUNS)
                      for impl in ("poly", "erf")}
        plain_code_ms = {impl: median_ms(lambda: K1.int8_conv_reference(x, op, stride, pad, impl,
                                                                           K1.act_map(impl, 127, dev)),
                                         runs=PLAIN_RUNS, warmup=0)
                         for impl in ("poly", "erf")}
        # torch._int_mm on the pre-gathered (M, Kp) matrix: the raw int32 product
        cols = K1.gather_taps(xc, ksize, stride, pad, K1.K_MULT)
        wmat = op.wt[:n].t().contiguous()
        lib_ms = graph_ms(lambda: torch._int_mm(cols, wmat), runs=LAUNCH_RUNS)
        del cols
        bc_ms, bc_by = conv_bound(b, h, w, cin, ksize, stride, n, 1)
        bf_ms, _ = conv_bound(b, h, w, cin, ksize, stride, n, 4)
        slice_n, erf_n = conv_shapes(batch)[name, b, h, w, cin, ksize, stride, n]
        rows[K1.KERNEL].append(dict(
            batch=batch, shape=name, M=m, K=ksize * ksize * cin, N=n, slice_launches=slice_n, erf_launches=erf_n,
            tile=tile, form=option_of(plan), poly_ms=code_ms["poly"], erf_ms=code_ms["erf"], f32_ms=f32_ms,
            plain_poly_ms=plain_code_ms["poly"], plain_erf_ms=plain_code_ms["erf"],
            bound_ms=bc_ms, bound_f32_ms=bf_ms, bound_by=bc_by, library_ms=lib_ms, pad_pass_ms=pad_ms,
            old_poly_ms=old_ms.get("poly"), old_erf_ms=old_ms.get("erf"),
        ))
        print(f"time K1 conv {name} batch {b} M={m} K={ksize * ksize * cin} N={n} ({option_of(plan)}, tile {tile}): "
              f"codes poly {code_ms['poly']:.4f} ms, erf {code_ms['erf']:.4f} (plain {plain_code_ms['poly']:.3f}, "
              f"{plain_code_ms['erf']:.3f}; bound {bc_ms:.4f} {bc_by}); f32 {f32_ms:.4f} (bound {bf_ms:.4f}); "
              f"torch._int_mm on the gathered matrix {lib_ms:.4f}"
              f"{'' if pad_ms is None else f'; the pad pass before it {pad_ms:.4f}'}"
              f"{'' if not old_ms else f'; the form it replaced {old_ms}'} [{card}]", flush=True)
    k2_s = [time.perf_counter(), 0.0]  # the K2 loop's start, the seconds its direct kernel's timings took
    for batch, name, x in k2_inputs:
        if batch is None:
            continue
        n = x.numel()
        out = torch.empty(x.shape, device=dev, dtype=torch.int8)
        plan = K2.device_k2_plan(x)
        ms = graph_ms(lambda: K2._k2_sm90_launch(x, out, plan), runs=LAUNCH_RUNS)
        t0 = time.perf_counter()
        old_ms = graph_ms(lambda: K2._k2_launch(x, out), runs=LAUNCH_RUNS)
        k2_s[1] += time.perf_counter() - t0
        plain_ms = median_ms(lambda: K2.cdf_quantize_int8_plain(x), runs=PLAIN_RUNS, warmup=0)
        b_ms, b_by = bound(5 * n, K2_TABLE_OPS_PER_ELEMENT * n, PEAK_F32_OPS_PER_S)
        rows[K2.KERNEL].append(dict(batch=batch, shape=name, n=n, ms=ms, old_ms=old_ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=b_by, library_ms=None, ctas=plan.ctas, steps=plan.steps))
        print(f"time K2 {name} n={n}: {ms:.4f} ms (the direct kernel {old_ms:.4f}), plain {plain_ms:.3f}, bound "
              f"{b_ms:.4f} ({b_by}) [{card}]", flush=True)
    details["k2_timing_s"] = {"all": time.perf_counter() - k2_s[0], "direct_kernel": k2_s[1]}
    print(f"time K2: the loop took {details['k2_timing_s']['all']:.2f} s, of which the direct kernel's timings "
          f"{k2_s[1]:.2f} s", flush=True)
    for (batch, name), (stream, wt, scale, bias, ms_, hw) in k3_ops.items():
        mt, c = stream.numel() // stream.shape[-1], stream.shape[-1]
        out = torch.empty_like(stream)
        plan = K3.k3_plan(batch, hw, hw, c, len(ms_))  # the planner's form (the Hopper form at every path run)
        ms = graph_ms(lambda: K3._stage_launch(stream, out, wt, scale, bias, ms_, 127, plan), runs=LAUNCH_RUNS)
        old_ms = graph_ms(lambda: K3._stage_launch(stream, out, wt, scale, bias, ms_, 127), runs=LAUNCH_RUNS)
        plain_ms = median_ms(lambda: K3.stage_identity_blocks_nhwc_reference(stream, wt, scale, bias, ms_, 127),
                             runs=PLAIN_RUNS, warmup=0)
        b_ms, b_by = k3_bound(mt, c, len(ms_))
        form = "mma.sync" if plan is None else f"sm90 {plan.imgs} images {plan.n_wg} warpgroups"
        rows[K3.KERNEL].append(dict(batch=batch, shape=name, C=c, HW=hw, form=form, ms=ms, mma_sync_ms=old_ms,
                                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))
        print(f"time K3 {name} C={c} {hw}x{hw} batch {batch} ({form}): {ms:.4f} ms (the mma.sync form "
              f"{old_ms:.4f}), plain {plain_ms:.3f}, bound {b_ms:.4f} ({b_by}) [{card}]", flush=True)
    details["kernels"] = rows

    # 11. QAT step times and where a step's device time goes
    phase("QAT times")
    details["qat_times"] = qat_times(dev, card)


    # 12-15. the CIFAR deploy families: DenseNet-40 (f32 and int8 stage
    # buffers) and MobileNet-V2
    fam_rows, fam_err, fam_serving = deploy_families(dev, card, repo, details, phase)

    # 16-19. the ImageNet-layout trunks at 224x224; 20. the baselines' QAT
    trunk_rows, (trunk_err, sm90_err, stem_err), trunk_serving = imagenet_trunks(dev, card, repo, details, phase)
    baseline_qat(dev, card, details, phase)

    # 21-23. domain adaptation
    digit_rows, digit_err, digit_served, _, da_trunk_err = da_phase(dev, card, repo, details, phase)

    # 24. data-parallel training
    dp_phase(dev, card, repo, details, phase)

    # 25. tensor parallelism and mesh serving
    tp_phase(dev, card, repo, details, phase)

    # 26. the tools
    tools_phase(card, details, phase)

    # 27. the kernels line, the card line, the final line
    phase("done")

    def summed(r, ms_key, plain_key, bound_key, weight):
        """One forward's launches: each row's times times its launches."""
        r = [(x, x[weight] if weight else 1) for x in r]
        t_bytes = sum(x[bound_key] * c for x, c in r if x["bound_by"] == "bytes")
        t_ops = sum(x[bound_key] * c for x, c in r if x["bound_by"] == "operations")
        lib = [x["library_ms"] for x, _ in r]
        return {
            "ms": sum(x[ms_key] * c for x, c in r), "plain_ms": sum(x[plain_key] * c for x, c in r),
            "bound_ms": t_bytes + t_ops, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if None in lib else sum(x["library_ms"] * c for x, c in r),
        }

    per_forward = {}
    for batch in (BATCH, SERVE_BATCH):
        r1 = [x for x in rows[K1.KERNEL] if x["batch"] == batch]
        per_forward[batch] = {
            K1.KERNEL: summed(r1, "poly_ms", "plain_poly_ms", "bound_ms", "slice_launches"),
            K1.KERNEL + " (erf route)": summed(r1, "erf_ms", "plain_erf_ms", "bound_ms", "erf_launches"),
            K2.KERNEL: {**summed([x for x in rows[K2.KERNEL] if x["batch"] == batch], "ms", "plain_ms", "bound_ms",
                                 None),
                        "replaced_ms": sum(x["old_ms"] for x in rows[K2.KERNEL] if x["batch"] == batch)},
            K3.KERNEL: summed([x for x in rows[K3.KERNEL] if x["batch"] == batch], "ms", "plain_ms", "bound_ms",
                              None),
        }
        for key, form in ((K1.NARROW, "narrow"), (K1.PLANE, "plane"), (FC.FIRST, "first")):
            these = [x for x in r1 if x["form"].startswith(form)]
            per_forward[batch][key] = summed(these, "poly_ms", "plain_poly_ms", "bound_ms", "slice_launches")
            per_forward[batch][key + " (erf route)"] = summed(these, "erf_ms", "plain_erf_ms", "bound_ms",
                                                              "erf_launches")
            if form != "narrow":  # the form each replaced, over the same launches
                per_forward[batch][key]["replaced_ms"] = sum(x["old_poly_ms"] * x["slice_launches"] for x in these)
                per_forward[batch][key + " (erf route)"]["replaced_ms"] = sum(
                    x["old_erf_ms"] * x["erf_launches"] for x in these)
        for kname, v in per_forward[batch].items():
            print(f"{kname} over one batch-{batch} forward: {json.dumps(v)} [{card}]", flush=True)
    details["per_forward"] = per_forward
    meta = [
        (K1.KERNEL, "alignq_tpu_torch/csrc/qmatmul.cu", "alignq_tpu/kernels/qmatmul.py:45", k1_err,
         main_launches[K1.KERNEL]),
        (K2.KERNEL, "alignq_tpu_torch/csrc/cdf_quant_sm90.cu", "alignq_tpu/kernels/quantize.py:57", k2_err,
         k2_launches[K2.KERNEL_SM90]),
        (K3.KERNEL, "alignq_tpu_torch/csrc/stage_kernel_sm90.cu", "alignq_tpu/kernels/stage_kernel.py:171", k3_err,
         main_launches[K3.SM90]),
        (K1.NARROW, "alignq_tpu_torch/csrc/qmatmul_sm90n.cu", "alignq_tpu/kernels/qmatmul.py:45", k1_err,
         main_launches[K1.NARROW]),
        (K1.PLANE, "alignq_tpu_torch/csrc/qmatmul_sm90p.cu", "alignq_tpu/kernels/qmatmul.py:45", plane_err,
         main_launches[K1.PLANE]),
        (FC.FIRST, "alignq_tpu_torch/csrc/first_conv_sm90.cu", "alignq_tpu/kernels/qmatmul.py:45", first_err,
         main_launches[FC.FIRST]),
    ]
    kernels = [{"name": kname, "route": "cuda", "source": src, "replaces": replaces, "launches": launches,
                "max_abs_err": err, **{k: v for k, v in per_forward[SERVE_BATCH][kname].items() if k != "replaced_ms"}}
               for kname, src, replaces, err, launches in meta]

    def family_sum(label, kinds, form=None):
        """One batch-256 forward of a family's launches of the kernel kinds
        given (of one form of the table pass, where form is given)."""
        r = [x for x in fam_rows if x["family"] == label and x["kind"] in kinds and form in (None, x["form"])]
        lib = [x["library_ms"] for x in r]
        t_bytes = sum(x["bound_ms"] * x["launches"] for x in r if x["bound_by"] == "bytes")
        t_ops = sum(x["bound_ms"] * x["launches"] for x in r if x["bound_by"] == "operations")
        return {"ms": sum(x["ms"] * x["launches"] for x in r), "plain_ms": sum(x["plain_ms"] * x["launches"] for x in r),
                "bound_ms": t_bytes + t_ops, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None if None in lib else sum(x["library_ms"] * x["launches"] for x in r)}

    for kname, src, replaces, label, kinds, form, counter in (
        (K1.KERNEL + "@densenet40", "alignq_tpu_torch/csrc/qmatmul.cu", "alignq_tpu/kernels/qmatmul.py:45",
         "densenet40 stage_int8", ("K1", "first"), None, K1.KERNEL),
        (K1.KERNEL + "@mobilenetv2", "alignq_tpu_torch/csrc/qmatmul.cu", "alignq_tpu/kernels/qmatmul.py:45",
         "mobilenetv2", ("K1", "first"), None, K1.KERNEL),
        (DWm.DW_SM90, "alignq_tpu_torch/csrc/dwconv_sm90.cu", "alignq_tpu/kernels/infer_mobilenet.py:39", "mobilenetv2",
         ("dw",), None, DWm.DW_SM90),
        (K2.BN_ACT_TABLE_SM90, "alignq_tpu_torch/csrc/bn_table_sm90.cu", "alignq_tpu/kernels/infer_densenet.py:125",
         "densenet40 stage_int8", ("bn_table",), "sm90", K2.BN_ACT_TABLE_SM90),
        (K2.BN_ACT_TABLE_CHUNKED, "alignq_tpu_torch/csrc/quantize.cu", "alignq_tpu/kernels/infer_densenet.py:125",
         "densenet40 stage_int8", ("bn_table",), "chunked", K2.BN_ACT_TABLE_CHUNKED),
        (K2.BN_ACT_ARITH, "alignq_tpu_torch/csrc/quantize.cu", "alignq_tpu/kernels/infer_densenet.py:125",
         "densenet40 f32", ("bn",), None, K2.BN_ACT_ARITH),
    ):
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": fam_serving[label]["launches"].get(counter, 0),
                        "max_abs_err": max(fam_err[k] for k in kinds), **family_sum(label, kinds, form)})
        print(f"{kname} over one batch-{SERVE_BATCH} {label} forward: {json.dumps(kernels[-1])} [{card}]", flush=True)
    tb = [x for x in fam_rows if x["kind"] == "bn_table"]
    tb90 = [x for x in tb if x["form"] == "sm90"]
    print(f"the table pass over one batch-{SERVE_BATCH} densenet40 stage_int8 forward ({sum(x['launches'] for x in tb)} "
          f"launches): {sum(x['ms'] * x['launches'] for x in tb):.4f} ms in the rule's forms "
          f"({sum(x['launches'] for x in tb90)} in the Hopper kernel: {sum(x['ms'] * x['launches'] for x in tb90):.4f}"
          f" ms, bn_table_kernel {sum(x['old_ms'] * x['launches'] for x in tb90):.4f} ms at the same sites), "
          f"{sum(x['old_ms'] * x['launches'] for x in tb):.4f} ms all in bn_table_kernel [{card}]", flush=True)

    def trunk_sum(rows_):
        """One batch-256 forward's launches of the rows given (no library
        time where a row has none)."""
        t_bytes = sum(x["bound_ms"] * x["launches"] for x in rows_ if x["bound_by"] == "bytes")
        t_ops = sum(x["bound_ms"] * x["launches"] for x in rows_ if x["bound_by"] == "operations")
        lib = [x["library_ms"] for x in rows_]
        return {"ms": sum(x["ms"] * x["launches"] for x in rows_),
                "plain_ms": sum(x["plain_ms"] * x["launches"] for x in rows_), "bound_ms": t_bytes + t_ops,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None if None in lib else sum(x["library_ms"] * x["launches"] for x in rows_)}

    # K1 on each trunk: its launches but the stem, which the stem kernel takes
    for kname, arch in ((K1.KERNEL + "@resnet50", "resnet50"), (K1.KERNEL + "@resnet18", "resnet18")):
        n = trunk_serving[arch]["launches"]
        rows_ = [x for x in trunk_rows if x["family"] == arch and x["kind"] == "K1"]
        kernels.append({"name": kname, "route": "cuda", "source": "alignq_tpu_torch/csrc/qmatmul.cu",
                        "replaces": "alignq_tpu/kernels/qmatmul.py:45",
                        "launches": n.get(K1.KERNEL, 0) - n.get(ST.STEM, 0), "max_abs_err": trunk_err,
                        **trunk_sum(rows_)})
        print(f"{kname} over one batch-{SERVE_BATCH} {TRUNK_SIZE}x{TRUNK_SIZE} forward: {json.dumps(kernels[-1])} "
              f"[{card}]", flush=True)
    # the stem kernel (its time with its prep pass's): its launches over both trunks' served forwards
    kernels.append({"name": ST.STEM + "@resnet50+resnet18", "route": "cuda",
                    "source": "alignq_tpu_torch/csrc/stem_sm90.cu", "replaces": "alignq_tpu/kernels/qmatmul.py:45",
                    "launches": sum(trunk_serving[a]["launches"].get(ST.STEM, 0) for a in TRUNKS),
                    "max_abs_err": stem_err,
                    **trunk_sum([x for x in trunk_rows if x["family"] == "resnet50" and x["kind"] == "stem"])})
    print(f"{kernels[-1]['name']} over one batch-{SERVE_BATCH} {TRUNK_SIZE}x{TRUNK_SIZE} ResNet-50 forward: "
          f"{json.dumps(kernels[-1])} [{card}]", flush=True)
    # K1's Hopper form: its launches over both trunks' served forwards (phase
    # 18), its times over one batch-256 forward of each trunk (phase 19)
    kernels.append({"name": K1.SM90 + "@resnet50+resnet18", "route": "cuda",
                    "source": "alignq_tpu_torch/csrc/qmatmul_sm90.cu", "replaces": "alignq_tpu/kernels/qmatmul.py:45",
                    "launches": sum(trunk_serving[a]["launches"].get(K1.SM90, 0) for a in TRUNKS),
                    "max_abs_err": sm90_err, **trunk_sum([x for x in trunk_rows if x["form"] == "sm90"])})
    print(f"{kernels[-1]['name']} over one batch-{SERVE_BATCH} {TRUNK_SIZE}x{TRUNK_SIZE} forward of each trunk: "
          f"{json.dumps(kernels[-1])} [{card}]", flush=True)
    # the digit kernel (its time with conv 1's prep pass): its launches over the served digit forwards
    r5 = [x for x in digit_rows if x["batch"] == SERVE_BATCH]
    kernels.append({"name": DSm.DIGIT + "@digit_dann", "route": "cuda",
                    "source": "alignq_tpu_torch/csrc/digit_sm90.cu", "replaces": "alignq_tpu/kernels/qmatmul.py:45",
                    "launches": digit_served["launches"].get(DSm.DIGIT, 0),
                    "max_abs_err": max(digit_err, da_trunk_err), **trunk_sum(r5)})
    print(f"{kernels[-1]['name']} over one batch-{SERVE_BATCH} digit forward: {json.dumps(kernels[-1])}; the chain it "
          f"replaced {sum(x['old_ms'] * x['launches'] for x in r5):.4f} ms [{card}]", flush=True)
    out_dir = repo / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)  # as nvidia-smi gives it: name, power limit
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
