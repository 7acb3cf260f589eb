#!/usr/bin/env python3
"""Smoke run of the PyTorch port (uni3detr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, one or more lines each; any failure raises and exits non-zero:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile the CUDA kernels from ``uni3detr_tpu_torch/csrc/``;
3. kernels: each of K1-K4 and K11 against its plain PyTorch version on
   the card, at the shapes the flagship path gives it on a clustered
   100k-point SUN RGB-D scene: max error, median kernel and plain times
   (CUDA events, after warm-up), the bound from the roofline helper
   (``roofline`` and the ``*_roofline`` functions below: operations over
   the H100's peak rate for their type, bytes over its memory rate,
   counting the neighbour pairs and valid points this scene has), the
   yardsticks ``library_ms`` (K1: ``torch.searchsorted``, positions only)
   and ``gemm_ms`` (K2, K3: the cuBLAS product of the already gathered
   rows, which the port never calls), and for K4 its step cost (the
   same kernel and steps on one point per block: this design's cost of
   the steps alone); per call shape, summed per scene, and summed per TPU
   kernel that the JAX package would run; K1's and ``torch.searchsorted``'s
   device times per scene (``torch.profiler``);
4. flagship: ``uni3detr_sunrgbd`` as preset (bf16), seeded random
   weights, points -> head -> decode -> per-class NMS on a few scenes,
   then ``eval.indoor_eval`` of the detections against the scenes'
   synthetic GT (``synthetic.clustered_scene_gt``): valid boxes,
   ms/scene, peak memory, and the kernel launch counts of that run,
   which must be K1 4, K2 17, K3 3 and K4 1 per scene and N1's two-set
   form once a scene in the metric; ``eval_phase`` then holds that
   form's overlaps to the plain IoU and the metric to the one from the
   plain overlaps;
5. fp32: one scene through the port on the card (kernels) and on the
   CPU (plain versions), TF32 off: voxels and FPS indices must be equal,
   head outputs close;
6. train kernels: K7 and K10 (sparse-conv weight gradients) against
   their plain versions at the shapes of the SUN RGB-D train step (B=4,
   V=16000), with median kernel and plain times, bounds and
   ``gemm_ms`` per call shape and summed per step, the achieved TFLOP/s
   per call shape, and bf16 K7/K10 bit-equal on a second call; K4 equal
   to its plain version on the train batch's two sets (B=4: eight
   problems in one launch); K12 (auction) on the train step's own costs
   (all decoder layers of the seed-0 model on the train batch, the
   instances of the loss's one matching call: 36 x 64 x 384), on
   synthetic DETR-like costs of the same shape and on a KITTI-shaped (10,
   256, 384) set, in every variant that fits (one block, a cluster of
   two, global memory): assignment, rounds and bids bit-equal to the
   plain version, no bidder unassigned, event and device ms, rounds per
   instance and the round-counting bound (``auction_check``);
7. train: ``uni3detr_sunrgbd`` as preset (bf16, fp32 params), B=4
   synthetic scenes, seeded random weights, AdamW lr 1e-4 with clip 10:
   warm-up steps, then timed steps on one fixed batch; per step the loss,
   gradient norm, ms and peak memory. Losses and gradients must be
   finite, the loss must fall, and each step must launch K1 4, K2 33, K3
   6, K4 1, K7 17, K10 3 and K12 once;
8. fp32 train parity: one step in fp32, dropout 0, scipy matching, TF32
   off, on the card (kernels) and on the CPU (plain versions): losses and
   gradients close.

Then ``uni3detr_nuscenes`` (300k points, V=120000 eval / 90000 train
voxels, 900 queries, a 10-dim box code with velocity):

9. kernels at its eval shapes (K1-K4, K11) and train shapes (K4, K7,
   K10, K12: its own costs are 36 x 96 x 1024), as phases 3 and 6, each
   shape marked with the kernel the TPU package would run there (the
   lane-packed K5/K6/K8/K9 where a stage's feature table does not fit
   VMEM);
10. inference, bf16, as phase 4: K1 4, K2 17, K3 3, K4 1 per scene and
    at most ``num_thr`` (500) valid boxes; ms/scene and peak memory;
11. fp32 card vs CPU on one scene, as phase 5, with the first decoder
    layer held to the tolerance and the chaotic later layers by the
    share of outputs within it (see ``fp32_phase``);
12. train at B=4 with velocity boxes and the cyclic lr and momentum
    schedules of the reference config over the run's steps, checked as
    phase 7;
13. checkpoint: save after the timed steps, load into a fresh model and
    optimizer: parameters, buffers, optimizer state and step equal bit
    for bit; one more step from each (dropout seeded alike) gives losses
    within ``CKPT_LOSS_RTOL``.

K11 (single-set FPS), a public op that no model path calls, is driven
once more on its own, as its callers call it, for its launch count.

Every inference phase (4, 10, 15, 20, 38, 42, 43) also runs the
per-class NMS of
its scenes on the card, N1 (``u3d_iou3d_rotated_mask``, writing the
overlap bitmask) and N2 (``u3d_nms_greedy``) once a scene each, asserted,
with decoding and post-processing under
``torch.cuda.set_sync_debug_mode("error")``, and ``nms_phase`` then
holds N1 to the plain IoU and N2's keep set to the serial greedy pass on
N1's own matrix, on every scene of every preset.
Then ``uni3detr_scannet`` (18 classes, a 128x640x640 grid,
``max_num`` 5000) and ``uni3detr_scannet_large`` (dynamic voxelization,
V=120000 eval / 60000 train, sparse widths 32..256, ``conv_out`` to
512), each:

14/19. kernels at its eval shapes (K1-K4, K11), as phase 3;
15/20. inference, bf16, B=1, a warm-up and three timed scenes: ms/scene
    (host and event), peak memory, launch counts;
16/21. NMS (``nms_phase``): N1 against the plain IoU in row blocks, N2
    against the serial pass per class, the keep set against the plain
    path, with times and bounds of N1 and N2 at 5000 boxes;
17/22. train kernels (K4, K7, K10, K12 on the step's own costs), as
    phase 6;
18/23. train at B=4, two warm-up and eight timed steps, checked as
    phase 7.

Then ``uni3detr_kitti_car`` (9 decoder layers, 18000 points on a
41x1600x1408 grid, one-to-many matching with 5 copies of each GT and
eps = spread / 8**3, box merging, budget caps) on clustered and on
uniform scenes (near-isolated voxels: every strided site set reaches its
cap), and ``uni3detr_kitti_3classes`` (per-class score thresholds, class
0's at 0.0, so the shipped path merges) on uniform scenes:

24/28/34. kernels at the eval shapes (K1-K4, K11), as phase 3 (car);
25/29/35. inference, bf16, B=1, a warm-up and four timed scenes ending
    with the merged boxes on the host (``eval.postprocess``: N1's matrix
    form once a scene), then ``eval.kitti_eval`` against the scenes'
    synthetic GT (N1's 3D and BEV two-set forms once a scene each):
    launch counts K1 4, K2 17, K3 3, K4 1, N1 (NMS bitmask) and N2 0;
26/30/36. box merging on every decoded box in range (``merge_phase``:
    the card's merge equal to the CPU's) and the metric's overlaps
    (``eval_phase``), as in phase 4, with times and bounds;
27/31. fp32 card vs CPU on one scene, as phase 11 (car), the first
    decoder layer held, the share of all layers' outputs within the
    tolerance printed beside its floor (see ``fp32_phase``);
32. train kernels (K4, K7, K10, K12 on the step's own costs: 108
    instances of 256 x 384), as phase 6, on a uniform B=4 batch;
33. train at B=4, two warm-up and ten timed steps under KITTI's step
    schedule (its 40 epochs spread over the run, so that both
    milestones fall inside it), checked as phase 7, then a checkpoint
    round trip as phase 13.

Then OV-Uni3DETR inference (``ov``): ``ov_uni3detr_sunrgbd_mm`` at
full width (100k points and one 480x640 RGB image from
``synthetic.ov_scene``, ResNet-50 with DCNv2 in stages 2-4, FPN, 64
depth bins, the lift onto the encoder's 15x40x40 grid, 3 view convs,
the fusion conv, a 6-layer CLIP head with 4 x 300 queries, 46 classes):

37. kernels at its shapes (K1-K4, K11), as phase 3;
38. inference, bf16, B=1, a warm-up and three timed scenes, then the
    46-class indoor AP with the seen / unseen split against the scenes'
    synthetic GT: launch counts K1 4, K2 17, K3 3, K4 1, N1 1, N2 1 a
    scene and N1's two-set form once a scene; ``eval_phase`` as phase 4;
39. NMS at 46 classes (``nms_phase``);
40. the lift: the share of the 24000 voxels in front of the camera and
    inside its frame (at least OV_MIN_KEPT) and the largest DCN offset
    of each ResNet stage (``ov_lift_phase``);
41. fp32 card vs CPU on one scene, TF32 off: the first decoder layer
    within FP32_ATOL, the lifted voxel features and the image and fused
    volumes within OV_VOLUME_RTOL of their largest value, each beside
    its floor (``ov_fp32_phase``);
42/43. ``ov_uni3detr_sunrgbd_pc`` (points only, 3 layers) and
    ``ov_uni3detr_sunrgbd_rgb`` (camera only, 6 layers, one query group:
    no K1-K4 launch) scenes to boxes, launch counts asserted.

OV-Uni3DETR training (``ov_train``), on ``synthetic.ov_train_batch``
(the GT boxes whose centre the camera sees) at the configs' batch
sizes:

44. mm train kernels: K7 and K10 against their plain versions on the
    features and cotangents of one train step's own backward (recorded
    at the wrappers, ri 2), K4 at the B=4 batch, K12 on the step's own
    costs of all 6 layers (72 x 64 x 384) in every variant, as phase 6;
45. mm train at B=4: two warm-up and 14 timed steps under the config's
    step schedule (milestones inside the run) with its lr multipliers;
    ri drawn each step from a seeded CPU generator and each step's
    launches asserted by ri (ri 1, 2: K1 4, K2 33, K3 6, K4 1, K7 17,
    K10 3, K12 1; ri 0: K1 4, K2 17, K3 3, K4 1, K12 1); the loss must
    fall, ri take all three values and the frozen ResNet stages end
    bit-equal;
46. checkpoint round trip as phase 13, the modality generator
    included;
47. one fp32 mm step card vs CPU at B=2 (ri 2), as phase 8, with the
    image backbone, FPN + proj + depth and view convs + fusion groups;
48/49. pc at B=8 and rgb at B=2 (K12 alone): seven steps each, launches
    asserted.

Then the evaluation entry point (``cli``), on a SUN RGB-D data root
written under ``build/`` (CLI_SCENES scenes of CLI_POINTS points from
``synthetic.clustered_scene`` with their GT) and a seed-0 checkpoint of
``uni3detr_sunrgbd``:

50. the BEV bitmask (N1's BEV form, the TTA merge's NMS) on the
    flagship's own detections of the CLI's first batch in two views
    (flip False / True, mapped back; B=4, 2000 boxes a scene, 10
    classes): equal to the plain BEV IoU thresholded (but for pairs
    within NMS_IOU_ATOL of it), ``nms_bev_keep`` equal to the serial
    pass per class, one bitmask and one scan launch; times and bound
    (``bev_nms_phase``);
51. ``cli.test`` on ``configs/uni3detr/uni3detr_sunrgbd.py`` (two
    batches of 4; decoding, post-processing and the output copy under
    ``torch.cuda.set_sync_debug_mode("error")``): launches asserted a batch (K1 4, K2
    17, K3 3, K4 1, N1 1, N2 1; N1's two-set form once a scene in the
    metric), the detections equal to a direct model + coder call on the
    same collated batches and random points, ``cli.eval_metric`` on the
    written pkl equal to the CLI's metric; scenes/s, the host's load and
    collate ms a scene, stream ms a batch and the stream share (the
    stream ms over the wall time: functional timings of two batches, the
    first of them the warm-up; ``tools/profile_torch_eval.py`` measures
    the throughput);
52. the same with ``--tta`` (flips: two forwards a batch, then the BEV
    bitmask once and N2 three times a batch), at most 500 finite
    detections a scene, those of the first batch equal to phase 50's
    (its keep set, cut and ordered per scene by ``tta.select_merged``,
    then ``postprocess_sample``);
53. ``configs/ov_uni3detr/ov_uni3detr_sunrgbd_mm.py`` on a root with a
    480x640 PNG and ``calib.K`` / ``calib.Rt`` a scene (one batch of 4:
    the image loading, normalising and padding on the path), launches as
    phase 51, the metric's seen / unseen split.

Then the train entry point (``train_cli``), ``cli.train`` in this
process on data roots written under ``build/``, each step's and each
eval's kernel launches asserted (``CliWatch``: the CLI looks up
``train.step.train_step`` and ``train.evaluator`` when it runs):

54. ``configs/uni3detr/uni3detr_sunrgbd.py`` on a SUN RGB-D root of 8
    train scenes (``repeat=2``) and 4 val scenes at B=4: two epochs of 4
    steps, an eval of 4 scenes after each, a log line every step; steps
    K1 4, K2 33, K3 6, K4 1, K7 17, K10 3, K12 1, evals as phase 51 a
    batch (N1's two-set form once a scene in the metric); finite losses
    and both eval lines in ``train.log``; ``epoch_1``, ``epoch_2`` and
    ``latest`` with the config's classes in ``meta.json``; the CLI's
    first weights ``weights.init_state_dict``'s; the first
    step's loss within CKPT_LOSS_RTOL of a direct ``train_step`` on the
    recorded batch, weights and generator states; host ms/step between
    log lines after the first, the loader's ms a batch and the peak
    memory beside phase 7's;
55. ``--resume-from`` its ``epoch_1``: at the first resumed step the
    model and the AdamW state equal the checkpoint's, the step is the
    stored one (4) and the lr the schedule's; 4 steps and one eval,
    launches as phase 54;
56. ``cli.test`` on phase 54's ``latest`` (``--batch-size 4
    --max-samples 4``): launches as phase 51, the metric equal to phase
    54's eval at epoch 2;
57. ``configs/uni3detr/uni3detr_kitti_car.py`` on a KITTI root with a
    GT database (``synthetic.write_kitti_root``, 3 cars a scene): the
    native box ops built by g++ at first use (time printed), a forced
    horizontal flip of a seeded sample keeping every point in
    ``pc_range`` (``box_type_3d``'s LiDAR frame), ObjectSample's and
    ObjectNoise's host ms a sample, then 3 steps at B=1, launches as
    phase 33's, more GT boxes in every sample than its scene has;
58. ``ov_uni3detr_sunrgbd_pc.py`` (B=8) and ``_rgb.py`` (B=2: image
    loading, PhotoMetricDistortion, normalising, padding and GridMask on
    the path) one step each on a root with 480x640 PNGs, then ``_mm.py``
    two steps staged from their ``latest``: the tensors loaded per
    prefix counted and equal to their sources at the first step, the
    config's lr multipliers, the frozen ResNet stages bit-equal after
    the steps, launches as phases 45, 48 and 49 by ri.

Then data parallelism (``ddp``; ranks started by
``uni3detr_tpu_torch.parallel.launch.spawn``, each rank's launches
counted in its process and asserted against one step's or one eval
batch's counts):

59. one rank over NCCL through ``cli.train`` in this process, with the
    environment torchrun gives a rank: ``uni3detr_sunrgbd.py`` at full
    width on a written SUN RGB-D root (8 train and 8 val scenes), 2 steps
    at B=4, launches as phase 54's steps, the group NCCL during the steps
    and torn down after;
60. two ranks sharing the card over gloo on CUDA tensors: one fp32
    flagship step at B=2 a rank (TF32 off, dropout 0) against one
    process at B=4 on the same weights and batch (DDP_BATCH_SEED), run
    twice, every run after the first one process's on its matching (the
    matcher still runs: at random weights a last-bit change flips
    assignments): the loss within the larger of JAX's DP rtol 1e-5 and
    twice the two one-process runs' spread (at most 1e-4), the same step
    with each rank's own BN statistics (a planted fault) outside that
    tolerance, the grad norm within twice the two one-process runs'
    spread (at least JAX's DP 1e-3, at most 1e-2); launches K1 4, K2 33,
    K3 6, K4 1, K7 17, K10 3, K12 1 a step; each rank's ms/step over
    DDP_TIMED steps, then as many with every all-reduce timed between
    synchronisations (its calls a step and its share of the step); then
    ``run_inference_distributed`` at B=1 on the val split with draws
    keyed by scene (launches as phase 51 a batch) equal on rank 0 to
    ``run_inference``'s detections bit for bit, the GT in dataset order;
61. ``cli.train --num-processes 2`` (2 steps at 4 a rank), a resume to
    step 4 and ``cli.test --num-processes 2`` on the 8 val scenes, each
    with ``--process-id`` and a ``--coordinator host:port`` of its own
    on the loopback: each rank's launches as its steps and
    its batch (and N1's two-set form once a scene in rank 0's metric),
    rank 0 alone holding the gathered detections (the val split's GT in
    order) and the metric, ``train.log``, ``train.rank1.log``,
    ``latest`` and the pkl written;
62. ``graft_entry.dryrun_multichip(2)``: the tiny model's step and its
    eval over 5 scenes, launches a rank as one step and its shard's
    batches.

Then the on-ramps of the workflow (``onramps``), at full width on roots
written under ``build/``, each phase printing its host seconds:

63. KITTI from the raw layout (``synthetic.write_kitti_raw``: 8 train
    and 4 val scans of 120000 points, 8-12 Cars and 1-3 DontCare rows a
    scan, a non-identity calib): ``cli.create_data kitti`` for both
    splits and ``gt_database`` with ``uni3detr_kitti_car.py``, the infos'
    Cars within 1e-4 m and 1e-5 rad of the planted boxes, each database
    object's count ``points_in_rbbox``'s, the file at the config's
    ``db_info_path``; ``cli.train`` 3 steps at B=1 with ``ObjectSample``
    pasting from the new database (launches as phase 57's steps), then
    ``cli.test`` on its ``latest`` over the val scans with box merging
    and the KITTI metric (launches a scan K1 4, K2 17, K3 3, K4 1, N1's
    matrix form; N1's 3D and BEV two-set forms in the metric);
64. nuScenes from the raw tables (``synthetic.write_nuscenes_raw``: 2
    scenes of 4 key frames, LIDAR_TOP at 20 Hz with 34720 points of 5
    floats and 10 sweeps before the first key frame, 6 cameras, ~40
    annotations a key frame over the 10 classes): ``cli.create_data
    nuscenes --max-sweeps 10 --val-scenes``, boxes and velocities within
    1e-6 of the planted ones, the sweeps' poses the planted poses,
    ``valid_flag`` false exactly where both point counts are 0; then
    ``uni3detr_nuscenes.py``'s ``cli.train`` 2 steps (CBGS, 300000
    points; launches as phase 12's steps) and ``cli.test`` on the 4 val
    key frames (launches as phase 10's scenes, N1 and N2 once a batch);
65. a reference checkpoint: the seed-0 weights of ``uni3detr_sunrgbd``
    and ``ov_uni3detr_sunrgbd_mm`` as mmdet3d ``.pth`` files (sparse
    convs in spconv-v2 layout, BN counts), ``cli.import_ckpt``, then
    ``cli.test`` on the result bit-equal to ``cli.test`` on the seed-0
    weights; a ``.pth`` with one tensor of the wrong shape refused with
    the key named;
66. ``cli.get_flops`` on the six Lidar and three OV presets' configs at
    B=1 (params, GFLOP, GB moved, peak memory); the card's count equal to
    the CPU's for ``uni3detr_sunrgbd`` and the synthetic tiny config, and
    over two different scenes; ``utils.profiling.trace_context`` over
    one flagship forward, its trace listing K1 4, K2 17, K3 3 and K4 1.

Then the config options that no shipped preset uses (``options``), at
full width, each phase printing its host seconds:

67. N3 (``u3d_soft_nms``) on the decoded boxes of a random-weight
    forward at the flagship's eval batch (4 scenes, 1000 boxes of 10
    classes) and at ScanNet's (1 scene, 5000 boxes of 18 classes):
    ``post_process`` with ``soft_nms`` under
    ``set_sync_debug_mode("error")`` launches N1's matrix and N3 once,
    then N3 against ``soft_nms_plain`` on the same matrix: the keep masks
    and the kept boxes' steps equal (no near-tie flip), the scores within
    SOFT_SCORE_RTOL; kernel, device and plain ms, the bound and the
    serial bound (the longest class loop's steps x N3's least step);
68. ``cli.train configs/uni3detr/uni3detr_sunrgbd.py --max-steps 3`` with
    ``model.iou_cost_type=rdiou model.iou_loss_type=rdiou
    model.post_processing=soft_nms`` on a written SUN RGB-D root at B=4
    (launches as phase 54's steps, finite losses), ``cli.test`` on its
    ``latest`` with soft-NMS (N1's matrix and N3 once a batch, a metric),
    and one direct step with the ``axis_aligned_iou3d`` cost;
69. ``encoder_impl="dense"`` at ``uni3detr_sunrgbd``'s width: the dense
    encoder against the gather route (no budgets) in fp32 at its active
    sites, then the bf16 forward and two B=4 train steps (ms, peak
    memory; K4, and K12 in training, the only port kernels launched);
70. ``ov_uni3detr_sunrgbd_mm`` with two sweeps under ``sweep_cat`` and
    ``with_time``: two steps each at B=4 (8 images a batch and
    ``sweep_times``), launches by ri as phase 45's, the gradient at the
    sweep conv;
71. VoVNet-V2-39 at B=1 on a 480x640 image: bf16 on the card against
    fp32 on the CPU, ms.

Then spatial sharding (``spatial``): ranks sharing the card over gloo in
a (data, spatial) layout, the dense volume split along H
(``parallel/spatial.py``), each phase printing its host seconds:

72. two spatial ranks x one data group: the flagship's fp32 step (TF32
    off, dropout 0) at B=4 on one process's matching
    (``pinned_matching``) and weights against that process: the
    gathered fused volume within SPATIAL_FUSED_ATOL, the loss and the
    gradient norm by phase 60's rules, each module's largest relative
    gradient error within SPATIAL_GRAD_RTOL's rule, the BN running
    statistics; a planted fault (the sliced conv weights' gradients
    without the spatial sum) must land outside; each rank's launches
    (one process's step: K1-K4, K7, K10, K12), ms/step and the
    all-reduces' share;
73. two x two (four ranks, B=2 a data group) against the same process,
    checked as 72;
74. ``uni3detr_kitti_car`` at bf16, B=4: one process (spatial 1), then
    two spatial ranks (the encoder output's H 200 as 2 x 100): the loss
    within KITTI_SPATIAL_LOSS_RTOL of one process on the same matching
    with the sharded step's BN formula (``global_bn_formula``; the gap to
    cuDNN's printed), each rank's peak memory and ms/step, launches;
75. the dense encoder at the flagship's width in train mode, fp32,
    spatial 2 against 1 (the volume within SPATIAL_DENSE_RTOL, each
    rank's peak); ``cli.train --spatial-shard 2 --num-processes 2`` on a
    written SUN RGB-D root for one epoch (2 steps) and its eval: rank 0
    holds the gathered detections and the metric, both ranks the same
    weights, launches asserted; ``graft_entry.dryrun_multichip(4)`` in
    the (2, 2) layout.

Then training from scratch (``convergence``), the shipped convergence
configs as shipped (seed 0, their steps, lr and schedule), each phase
printing its seconds:

76. ``configs/uni3detr/uni3detr_synthetic_overfit.py``: ``cli.train``
    (600 steps at B=2, each step's launches asserted: K1-K4, K7, K10,
    K12), the CLI's first weights equal to ``weights.init_state_dict``,
    the loss at every log line, steps/s and wall seconds; then
    ``cli.test CONFIG W/latest --eval bbox`` (launches K1-K4, N1's
    bitmask and N2 a batch, N1's two-set 3D form a scene in
    ``indoor_eval``; ``cli.eval_metric`` equal): mAP@0.25 and mAP@0.50
    at least 0.9, the JAX package's bars (``tests/test_cli_overfit.py``),
    beside the card line;
77. ``configs/ov_uni3detr/ov_uni3detr_synthetic_overfit.py`` the same
    (650 steps, launches by the modality draw ri): mAP@0.25 at least 0.9;
78. ``uni3detr_sunrgbd`` at full width, B=4, bf16, on one fixed batch:
    one step from ``random_state_dict`` and one from ``init_state_dict``
    (their losses and gradient norms printed), then 20 steps from
    ``init_state_dict`` (launches as phase 7's steps), the total loss
    at the 20th below the first's.

Then one JSON line of the kernels (launches summed over every path's
run: the inference and train runs of all six Lidar presets, the three
OV presets' inference and train runs, K11's own call, the three
``cli.test`` runs and the train CLI's runs (phases 54, 55, 57 and 58:
their steps and evals; phase 56's ``cli.test``), every rank's runs
of phases 59-62 and 72-75 and the runs of phases 63-66, 67-70 and
76-78, each read right after its run; times, errors,
``bound_ms`` with
``bound_by``, ``library_ms`` (null where no single PyTorch call
computes the kernel's function) and, for the convs, ``gemm_ms``, at the
nuScenes shapes for K1-K12, summed per scene for K1-K4, per train step
for K7/K10/K12, per call for K11; N1 and N2 at ``uni3detr_scannet``'s
5000 boxes, per scene, N1's bitmask launch with its matrix launch's
``matrix_ms`` and ``matrix_bound_ms`` beside it; N1's matrix form at the
KITTI merge's 150 boxes and its two-set forms at the largest KITTI eval
scene, per call; its BEV bitmask at phase 50's batch, per call; N3 at
ScanNet's 5000 boxes of 18 classes, per scene), the card line, and the
result line ``{"ok": true, "device": {...}}``. The smoke's wall time is
printed before them. There is no CPU fallback: without a CUDA device the
script fails before any phase, as it does without cv2 and PIL (the test
pipeline's image loading and resizing).
"""
import contextlib
import dataclasses
import functools
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import time

T_START = time.perf_counter()

N_SCENES = 5          # the first is the warm-up
FP32_ATOL = 5e-3      # phases 5 and 11, see fp32_phase
FP32_SHARE = 0.98     # phase 11, see fp32_phase
WEIGHT_SEED = 0
TRAIN_B = 4           # phases 7 and 12: the reference's samples_per_gpu
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
TRAIN_LR = 1e-4
DW_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}   # phase 6, see dw_phase
PARITY_B = 2          # phase 8 batch (the CPU side runs the full model)
PARITY_LOSS_RTOL = 2e-3
# phase 8, max |grad diff| / max |grad| per group; see train_parity_phase
PARITY_GRAD_RTOL = {"sparse-conv weights": 0.3, "backbone+neck": 0.3,
                    "head": 0.01, "image backbone": 0.3, "FPN+proj+depth": 0.3,
                    "view convs+fusion": 0.3}
NUS_SCENES = 5        # phase 10, the first is the warm-up
NUS_WARMUP, NUS_STEPS = 3, 20
# uni3detr_nuscenes.py optimizer / lr_config / momentum_config
NUS_LR, NUS_LR_RATIO, NUS_MOMENTUM_RATIO, NUS_UP = \
    2e-5, (10, 1e-4), (0.85 / 0.95, 1.0), 0.4
CKPT_LOSS_RTOL = 1e-3
# N1 vs the plain IoU (see nms_phase); the keep sets of the kernels' path
# and of the plain path may differ only through pairs this close to
# nms_thr
NMS_IOU_ATOL = 1e-4
SCANNET_SCENES = 4    # the first is the warm-up
SCANNET_WARMUP, SCANNET_STEPS = 2, 8
KITTI_SCENES = 5      # the first is the warm-up
KITTI_NAMES = ("Car", "Pedestrian", "Cyclist")
KITTI_WARMUP, KITTI_STEPS = 2, 10
# uni3detr_kitti_car.py optimizer / lr_config: AdamW, the mmcv step policy
# with milestones at epochs 32 and 38 of 40 (the smoke's steps stand for
# the 40 epochs, so both milestones fall inside the run)
KITTI_LR, KITTI_MILESTONES, KITTI_EPOCHS = 2e-5 * 3 / 8 * 18 / 2, (32, 38), 40
# box merging card vs CPU: the same medians of the same fp32 boxes
MERGE_BOX_ATOL = 1e-6
# the metrics' N1 overlaps vs the plain IoU: fp32 rounding, as NMS_IOU_ATOL
EVAL_IOU_ATOL = 1e-4
OV_SCENES = 4         # phases 38 and 42-43, the first is the warm-up
OV_MIN_KEPT = 0.10    # phase 40: the least share of voxels the lift keeps
OV_VOLUME_RTOL = 1e-3  # phase 41, of the largest value; see ov_fp32_phase
# phases 44-49: the OV configs' samples_per_gpu (mm 4, pc 8, rgb 2)
OV_TRAIN_B = {"mm": 4, "pc": 8, "rgb": 2}
OV_TRAIN_WARMUP, OV_TRAIN_STEPS = 2, 14      # mm; pc and rgb 1 + 6
OV_PARITY_B = 2       # phase 47 (the CPU side runs the full model)
OV_PARITY_MODALITY = 2
# phase 47's gradient norm, relative: the ResNet's gradients carry ~1% of
# ReLU-mask noise between two correct fp32 runs (the CPU port against an
# fp64 run of itself, tests/test_torch_port_ov_train.py), which moves the
# global norm by ~0.5% between card and CPU
OV_PARITY_NORM_RTOL = 2e-2
OV_MODALITY_SEED = 0
# ov_uni3detr_sunrgbd_pc.py optimizer / lr_config (mm and rgb inherit):
# AdamW 2e-5 * 2 / 8 * 20, the step policy at epochs 32 and 38 of 40
# (the run's steps stand for the 40 epochs, so both milestones fall
# inside it)
OV_LR, OV_MILESTONES, OV_EPOCHS = 2e-5 * 2 / 8 * 20, (32, 38), 40
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_checkpoint")
# train_phase's median ms/step and peak bytes by tag (phase 54 prints
# phase 7's beside the CLI's)
DIRECT_TRAIN = {}


def fail(msg):
    raise RuntimeError(msg)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=120)
    return r.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms_by_name(torch, fn, name, reps=20):
    """Device time per call of ``fn`` under ``torch.profiler`` (after a
    warm-up call): (kernels whose name holds ``name``, all other
    kernels), in ms."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    mine = other = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if name in e.key:
                mine += e.self_device_time_total
            else:
                other += e.self_device_time_total
    return mine / 1e3 / reps, other / 1e3 / reps


def back_to_back_ms(torch, fn, calls=50):
    """Stream ms a call of ``fn`` (one kernel launch and no host sync),
    from two CUDA events around ``calls`` calls queued back to back after
    a warm-up call: while each kernel outlasts its call's host cost the
    stream never waits for the host, so this is the kernel's device time
    (it needs no profiler, which can miss launches)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def conv_cases(cfg):
    """(site-set index, C, Cout, calls per scene) of the submanifold
    convs (K2) and of the strided convs (K3, index of the output set)."""
    subm = [(0, cfg.in_point_features, cfg.encoder_base_channels, 1)]
    strided = []
    n = len(cfg.encoder_channels)
    cin = cfg.encoder_base_channels
    for i, blocks in enumerate(cfg.encoder_channels):
        body = blocks[:-1] if i < n - 1 else blocks
        subm.append((i, body[0], body[0], 2 * len(body)))
        if i < n - 1:
            strided.append((i + 1, cin, blocks[-1], 1))
            cin = blocks[-1]
    return subm, strided


# The TPU package's dispatch (uni3detr_tpu/ops/sparse_conv_pallas.py
# _unpacked_fits :520-524, idmatch_fits :546-550, gather_rows_pallas
# :1271-1278; strided route models/sparse_encoder.py:244-263): a stage
# whose feature table does not fit 12 MiB of VMEM runs a lane-packed
# kernel. Printed beside each shape; the port runs one kernel per kind.
_VMEM = 12 * 2 ** 20


def _unpacked_fits(V):
    return (max(-(-(V + 1) // 16) * 16, 512) + 512) * 256 <= _VMEM


def _idmatch_fits(V):
    Vp = max(-(-V // 1024) * 1024, 1024)
    return Vp * 260 + 512 * 27 * 4 <= _VMEM


def tpu_route(kind, V, Vout=None):
    """The TPU kernel that runs this call: ``kind`` is conv or dw of a
    subm or strided conv; V the input sites, Vout the output sites."""
    if kind.startswith("strided") and _idmatch_fits(V) \
            and _idmatch_fits(Vout):
        return "K3" if kind == "strided-conv" else "K10"
    rulebook = "K1 + " if kind == "strided-conv" else ""
    if kind.endswith("conv"):
        return rulebook + ("K2" if _unpacked_fits(V) else "K5 (packed)")
    return "K7" if _unpacked_fits(V) else "K6 (packed)"


# -- roofline ------------------------------------------------------------
# Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W):
# memory 3.35 TB/s; bf16 tensor cores 989 TFLOP/s; fp32 outside the tensor
# cores 67 TFLOP/s (also taken for the integer compares of K1).
H100_BYTES_PER_S = 3.35e12
H100_PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}
FPS_OPS_PER_POINT_STEP = 9    # 3 subtractions, 3 products, 2 sums, 1 min


def roofline(ops, nbytes, peak):
    """The least time the card could take for a call: the larger of
    ``ops`` over the peak rate ``H100_PEAK_OPS[peak]`` and ``nbytes``
    (each input read once, each output written once) over the memory
    rate; ``bound_by`` names the larger term."""
    t_ops = ops / H100_PEAK_OPS[peak] * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def conv_roofline(pairs, V, C, Vout, K, Cout, B=1, elem=2, ids=False,
                  peak="bf16"):
    """K2 (K3 with ``ids``): 2 * pairs * C * Cout products, ``pairs`` the
    (output row, offset) pairs that have a neighbour; reads the features
    (B, V, C), the rulebook or query ids (B, Vout, K) int32 (K3: and the
    site ids (B, V) int32) and the weights (K, C, Cout), writes (B, Vout,
    Cout); ``elem`` bytes a feature."""
    nbytes = (elem * (B * V * C + K * C * Cout + B * Vout * Cout)
              + 4 * B * Vout * K + (4 * B * V if ids else 0))
    return roofline(2 * pairs * C * Cout, nbytes, peak)


def dw_roofline(pairs, V, C, Vout, K, Cout, B, elem=2, ids=False):
    """K7 (K10 with ``ids``): dW = 2 * pairs * C * Cout products over the
    rate of their operands: bf16 rows and cotangents (``elem`` 2) widen to
    fp32 exactly, so the bf16 tensor-core rate with fp32 accumulation
    bounds them, fp32 ones the CUDA-core rate. Reads the features, the
    index (and site ids) and the cotangent (B, Vout, Cout), writes dW (K,
    C, Cout) fp32."""
    nbytes = (elem * (B * V * C + B * Vout * Cout) + 4 * B * Vout * K
              + (4 * B * V if ids else 0) + 4 * K * C * Cout)
    return roofline(2 * pairs * C * Cout, nbytes,
                    "bf16" if elem == 2 else "fp32")


def match_roofline(V, Vout, K, B=1):
    """K1: ceil(log2(V + 1)) compares of a binary search per query; reads
    the site ids and the query ids, writes one row per query."""
    queries = B * Vout * K
    return roofline(queries * math.ceil(math.log2(V + 1)),
                    4 * (B * V + 2 * queries), "fp32")


def fps_roofline(valid, sizes, S):
    """K4 (two sets) or K11 (one): FPS_OPS_PER_POINT_STEP fp32 operations
    per valid point (``valid``, per set) and step over S - 1 steps; reads
    the x/y/z planes and the mask of every point (``sizes``), writes S
    int32 indices per set. The S - 1 steps are also a chain of dependent
    reductions across the card, which this bound does not count."""
    return roofline(FPS_OPS_PER_POINT_STEP * sum(valid) * (S - 1),
                    13 * sum(sizes) + 4 * S * len(sizes), "fp32")


def auction_roofline(G, M, N, bids):
    """K12, a lower bound of its data-dependent bidding: each of the
    ``bids`` placed in the rounds that ran weighs all N items of its row
    (a subtraction and a compare each); reads the (G, M, N) fp32 benefit
    and the spreads once, writes (G, M) int32 items and (G, 2) int32
    counts. It counts neither the rounds' dependence nor the bids'
    second pass over a row's maximum."""
    return roofline(2 * N * bids, 4 * (G * M * N + G + G * M + 2 * G),
                    "fp32")


# N1: fp32 operations of one clipped pair, counted from csrc/nms.cu for a
# polygon of 4 vertices at every clip with 2 crossings each (the z test,
# eps, 4 clips of 2 + 4 x 5 + 4 x 6 + 2 x 6, the shoelace sum and the
# ratio); a pair without z overlap stops after the z test.
IOU_OPS_PER_PAIR = 270
IOU_OPS_Z_TEST = 5


def iou_roofline(clipped, tested, nbytes):
    """N1: ``clipped`` pairs at IOU_OPS_PER_PAIR, the other ``tested``
    pairs at IOU_OPS_Z_TEST (fp32); ``nbytes`` the boxes (and labels)
    read and the matrix or bitmask written."""
    return roofline(IOU_OPS_PER_PAIR * clipped
                    + IOU_OPS_Z_TEST * (tested - clipped), nbytes, "fp32")


def nms_scan_roofline(B, N):
    """N2: the bitmask (B, ceil(N/64), N) int64 read once, the ranked
    labels (int32) and order (int64) read, the keep mask (bool)
    written."""
    W = -(-N // 64)
    return roofline(0, 8 * B * N * W + 12 * B * N + B * N, "fp32")


def _report_add(report, name, err, ms, plain_ms, calls, bound,
                gemm_ms=None, library_ms=None):
    """Sum a call shape's numbers into ``report[name]`` (x ``calls``);
    ``by_term`` keeps how much of the bound each roofline term binds."""
    r = report.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                     bound_ms=0.0, library_ms=None,
                                     by_term={}))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += ms * calls
    r["plain_ms"] += plain_ms * calls
    r["bound_ms"] += bound["bound_ms"] * calls
    t = r["by_term"]
    t[bound["bound_by"]] = t.get(bound["bound_by"], 0.0) + \
        bound["bound_ms"] * calls
    for key, v in (("gemm_ms", gemm_ms), ("library_ms", library_ms)):
        if v is not None:
            r[key] = (r.get(key) or 0.0) + v * calls


def _report_entry(r):
    """A report entry for the JSON line: ``bound_by`` is the term that
    binds the larger part of the summed bound."""
    out = {k: v for k, v in r.items() if k != "by_term"}
    out["bound_by"] = max(r["by_term"], key=r["by_term"].get)
    return out


def print_report(tag, report, by_route):
    for name, r in report.items():
        e = _report_entry(r)
        print(f"[{tag}] sum {name}: " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in e.items()))
    for route, r in sorted(by_route.items()):
        print(f"[{tag}] sum tpu={route}: ms={r['ms']:.4f} plain_ms="
              f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f}"
              + (f" gemm_ms={r['gemm_ms']:.4f}" if "gemm_ms" in r else ""))


def _gathered(torch, features, nb):
    """(B*Vout, K*C) rows of a rulebook conv, gathered: the left operand
    of the ``gemm_ms`` yardstick."""
    B, V, C = features.shape
    padded = torch.cat([features, features.new_zeros(B, 1, C)], dim=1)
    bidx = torch.arange(B, device=features.device)[:, None, None]
    return padded[bidx, nb.long().clamp(0, V)].reshape(-1, nb.shape[2] * C)


def fps_sets(torch, points, pts_mask, coords, vmask):
    """The two sets the detector samples (``models/detector.py``): the
    raw points and the voxel coordinates as (x, y, z), zero where masked;
    ``(xyz, mask, vc, vmask)``."""
    xyz = points[..., :3].float().contiguous()
    vc = coords.flip(-1).float()
    vc = torch.where(vmask[..., None], vc, torch.zeros_like(vc))
    return xyz, pts_mask, vc, vmask


def fps_pair_check(torch, fargs, S, what):
    """K4 on ``fargs`` (``fps_sets``) against its plain version, exact;
    returns the plain indices of the raw points."""
    from uni3detr_tpu_torch.ops import fps

    ga, gb = fps.farthest_point_sample_pair(*fargs, S)
    ra = fps.farthest_point_sample_plain(*fargs[:2], S)
    rb = fps.farthest_point_sample_plain(*fargs[2:], S)
    if not (torch.equal(ga, ra) and torch.equal(gb, rb)):
        fail(f"K4 farthest_point_sample_pair differs from the plain version "
             f"at {what}")
    return ra


def kernel_phase(torch, model, pts, dev, tag):
    """K1-K4 and K11 against their plain versions at the preset's
    inference shapes; prints the sums by kernel and by the TPU kernel the
    JAX package would run, and returns the report by kernel."""
    from uni3detr_tpu_torch.ops import fps, sparse_conv_cuda as sc

    cfg = model.cfg
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    feats, coords, vmask = model.voxelize(pts, mask)
    sets = model.pts_middle_encoder.site_sets(coords, vmask)
    gen = torch.Generator(device=dev).manual_seed(1)
    report, by_route = {}, {}

    def add(name, route, *a, **kw):
        _report_add(report, name, *a, **kw)
        _report_add(by_route, route, *a, **kw)

    # K1: one rulebook per site set, exact; library: torch.searchsorted
    for s in sets:
        args = (s["ids"], s["qids"], s["n_sites"])
        got, ref = sc.match_positions(*args), sc.match_positions_plain(*args)
        if not torch.equal(got, ref):
            fail(f"K1 match_positions differs at V={s['n_sites']}")
        ms = median_ms(torch, lambda: sc.match_positions(*args), 20)
        pms = median_ms(torch, lambda: sc.match_positions_plain(*args), 20)
        q = s["qids"].reshape(s["ids"].shape[0], -1)
        lms = median_ms(torch, lambda: torch.searchsorted(s["ids"], q), 20)
        bound = match_roofline(s["n_sites"], *s["qids"].shape[1:])
        print(f"[{tag}] K1 match_positions V={s['n_sites']} "
              f"queries={tuple(s['qids'].shape)} exact ms={ms:.4f} "
              f"plain_ms={pms:.4f} searchsorted_ms={lms:.4f} (positions "
              f"only) bound_ms={bound['bound_ms']:.5f} ({bound['bound_by']})")
        add("match_positions", "K1", 0.0, ms, pms, 1, bound, library_ms=lms)
    # the same comparison in device time (the event times above of calls
    # under ~0.15 ms hold host work): kernels only, per scene
    k1_dev, lib_dev = device_ms_by_name(torch, lambda: [
        (sc.match_positions(s["ids"], s["qids"], s["n_sites"]),
         torch.searchsorted(s["ids"], s["qids"].reshape(
             s["ids"].shape[0], -1))) for s in sets], "u3d_match_positions")
    print(f"[{tag}] K1 device ms/scene={k1_dev:.4f} torch.searchsorted "
          f"device ms/scene={lib_dev:.4f} (positions only)")

    def conv_check(name, kern, plain, rest, nb, C, Cout, V, calls, route):
        Vout, K = nb.shape[1], nb.shape[2]
        pairs = int((nb < V).sum())
        for dtype, rtol in ((torch.float32, 1e-4),
                            (torch.bfloat16, 2 * 2.0 ** -8)):
            x = torch.randn((1, V, C), generator=gen, device=dev)
            a = (x.to(dtype),) + rest
            got, ref = kern(*a), plain(*a)
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if not err <= rtol * max(scale, 1e-6):
                fail(f"{name} C={C}->{Cout} {dtype}: max err {err} > "
                     f"{rtol} x {scale}")
            ms = median_ms(torch, lambda: kern(*a), 20)
            pms = median_ms(torch, lambda: plain(*a), 20)
            bf16 = dtype == torch.bfloat16
            bound = conv_roofline(pairs, V, C, Vout, K, Cout,
                                  elem=2 if bf16 else 4,
                                  ids=name == "gather_conv_ids",
                                  peak="bf16" if bf16 else "fp32")
            extra = ""
            if bf16:   # the presets' dtype: reported
                rows = _gathered(torch, a[0], nb)
                w2 = a[-1].to(dtype).reshape(K * C, Cout)
                gms = median_ms(torch, lambda: rows @ w2, 20)
                add(name, route, err, ms, pms, calls, bound, gemm_ms=gms)
                extra = f" gemm_ms={gms:.4f}"
                del rows
            print(f"[{tag}] {name} V={V} Vout={Vout} C={C}->{Cout} {dtype} "
                  f"max_abs_err={err:.3g} (max |ref| {scale:.3g}, rtol "
                  f"{rtol:.3g}) ms={ms:.4f} plain_ms={pms:.4f}{extra} "
                  f"bound_ms={bound['bound_ms']:.5f} ({bound['bound_by']}, "
                  f"{pairs} pairs) x{calls}/scene tpu={route}")

    subm, strided = conv_cases(cfg)
    for si, C, Cout, calls in subm:
        s = sets[si]
        nb = sc.match_positions_plain(s["ids"], s["qids"], s["n_sites"])
        w = torch.randn((27, C, Cout), generator=gen, device=dev) \
            / (27 * C) ** 0.5
        conv_check("gather_conv", sc.gather_conv, sc.gather_conv_plain,
                   (nb, w), nb, C, Cout, s["n_sites"], calls,
                   tpu_route("subm-conv", s["n_sites"]))
    for si, C, Cout, calls in strided:
        prev, s = sets[si - 1], sets[si]
        w = torch.randn((27, C, Cout), generator=gen, device=dev) \
            / (27 * C) ** 0.5
        nb = sc.match_positions_plain(prev["ids"], s["sq"], prev["n_sites"])
        conv_check("gather_conv_ids", sc.gather_conv_ids,
                   sc.gather_conv_ids_plain, (prev["ids"], s["sq"], w), nb,
                   C, Cout, prev["n_sites"], calls,
                   tpu_route("strided-conv", prev["n_sites"], s["n_sites"]))

    # K4: both FPS runs of the detector, exact
    fargs = fps_sets(torch, pts, mask, coords, vmask)
    xyz = fargs[0]
    S = cfg.num_query
    sizes = [xyz.shape[1], fargs[2].shape[1]]
    sms, smem_limit, _ = fps._device_limits(dev.index or 0)
    grid, in_smem = fps.fps_plan(sizes, 1, sms, smem_limit)
    ra = fps_pair_check(torch, fargs, S, f"{tag} N={sizes}")
    ms = median_ms(torch, lambda: fps.farthest_point_sample_pair(*fargs, S),
                   10)
    pms = median_ms(torch, lambda: (
        fps.farthest_point_sample_plain(*fargs[:2], S),
        fps.farthest_point_sample_plain(*fargs[2:], S)), 3, 1)
    bound = fps_roofline([int(mask.sum()), int(vmask.sum())], sizes, S)
    # this design's cost of a step alone (block update, barrier, merge of
    # the grid's partials): the same kernel and steps on one point a block
    tiny = [t[:, :grid].contiguous() for t in fargs]
    step_ms = median_ms(torch, lambda: fps.farthest_point_sample_pair(
        *tiny, S), 10)
    print(f"[{tag}] K4 fps_pair N=({sizes[0]}, {sizes[1]}) S={S} exact "
          f"ms={ms:.4f} plain_ms={pms:.4f} bound_ms="
          f"{bound['bound_ms']:.5f} ({bound['bound_by']}) grid={grid} "
          f"slices in {'shared' if in_smem else 'global'} memory; "
          f"{grid} points a set (the design's step cost): {step_ms:.4f} ms "
          f"= {step_ms / max(S - 1, 1) * 1e3:.3f} us per step")
    add("fps_pair", "K4", 0.0, ms, pms, 1, bound)
    # K11: the single-set op on the raw points, exact
    if not torch.equal(fps.farthest_point_sample(xyz, mask, S), ra):
        fail("K11 farthest_point_sample differs from the plain version")
    ms = median_ms(torch, lambda: fps.farthest_point_sample(xyz, mask, S), 10)
    pms = median_ms(torch, lambda: fps.farthest_point_sample_plain(
        xyz, mask, S), 3, 1)
    bound = fps_roofline([int(mask.sum())], sizes[:1], S)
    print(f"[{tag}] K11 fps N={sizes[0]} S={S} exact ms={ms:.4f} "
          f"plain_ms={pms:.4f} bound_ms={bound['bound_ms']:.5f} "
          f"({bound['bound_by']}) (no model path calls it)")
    add("fps", "K11", 0.0, ms, pms, 1, bound)
    print(f"[{tag}] voxels={int(vmask.sum())} sites per stage="
          f"{[int(s['mask'].sum()) for s in sets]} budgets="
          f"{[s['n_sites'] for s in sets]}")
    print_report(tag, report, by_route)
    return report


def kernel_wrappers():
    """Every model-path kernel's wrapper by the name the JSON line
    reports (``uni3detr_tpu_torch.ops.kernel_wrappers``): K1-K4 and N1/N2
    run in inference, K1-K4 and K7/K10/K12 in training. N1 on the NMS
    path is ``ops.nms.overlap_mask`` (the IoU kernel writing NMS's
    bitmask); on the box-merging path its matrix form
    ``geom.iou.iou3d_rotated_pairwise``, and in the metrics its two-set 3D
    and BEV forms; on the TTA merge its BEV bitmask,
    ``ops.nms.overlap_mask_bev``."""
    from uni3detr_tpu_torch.ops import kernel_wrappers as wrappers
    return wrappers()


def scene_inputs(torch, scene, dev):
    """A scene's model arguments on ``dev``: (points, mask, random
    points) for the Lidar detector, (batch dict, random points) for
    OV-Uni3DETR, whose scenes hold a batch dict (``synthetic.ov_scene``)."""
    inputs, rnd = scene
    rnd = torch.from_numpy(rnd).to(dev)
    if isinstance(inputs, dict):
        return ({k: torch.from_numpy(v).to(dev) for k, v in inputs.items()},
                rnd)
    pts = torch.from_numpy(inputs).to(dev)
    return pts, torch.ones(pts.shape[:2], dtype=torch.bool, device=dev), rnd


def metric_names(cfg):
    """(class names, seen classes or None) of a preset's metric: KITTI's
    names, the OV presets' 46 SUN RGB-D classes with their seen split,
    else ``class{c}``."""
    from uni3detr_tpu_torch.presets import OV_SUNRGBD_CLASSES, OV_SUNRGBD_SEEN

    if cfg.post_processing == "box_merging":
        return KITTI_NAMES[:cfg.num_classes], None
    if hasattr(cfg, "clip_dim") and cfg.num_classes == len(
            OV_SUNRGBD_CLASSES):
        return OV_SUNRGBD_CLASSES, OV_SUNRGBD_SEEN
    return [f"class{c}" for c in range(cfg.num_classes)], None


def infer_phase(torch, model, scenes, dev, tag, gts=None):
    """Scenes to boxes (bf16, B=1): ms/scene (host and CUDA events) and
    peak memory; each kernel's launches over the run asserted (N1 and N2
    once a scene, or for box merging N1's matrix form once a scene), and
    decoding and post-processing run under
    ``torch.cuda.set_sync_debug_mode("error")``: any host
    synchronisation inside them raises. A box-merging preset's time ends
    with its merged boxes on the host (``eval.postprocess``). With
    ``gts`` (a GT dict a scene) the run ends with the preset's metric on
    its detections (``kitti_eval`` for box merging, else
    ``indoor_eval``), its N1 two-set launches counted with the rest.
    Returns (launches, detections: a dict of numpy arrays a scene, the
    metric or None)."""
    import numpy as np
    from uni3detr_tpu_torch.eval import indoor_eval, kitti_eval
    from uni3detr_tpu_torch.eval.postprocess import (postprocess_batch,
                                                     split_batch)
    from uni3detr_tpu_torch.train.coder import decode_predictions, post_process

    cfg = model.cfg
    merging = cfg.post_processing == "box_merging"
    subm, strided = conv_cases(cfg)
    pts = getattr(cfg, "use_lidar", True)   # OV camera-only: no point branch
    per_scene = {"match_positions": pts * len(cfg.encoder_channels),
                 "gather_conv": pts * sum(c[-1] for c in subm),
                 "gather_conv_ids": pts * len(strided), "fps_pair": int(pts),
                 "iou3d_rotated": int(not merging),
                 "nms_greedy": int(not merging),
                 "iou3d_rotated_matrix": int(merging),
                 "iou3d_rotated_sets": 0, "iou_bev_rotated_sets": 0}
    wrappers = {k: v for k, v in kernel_wrappers().items()
                if k in per_scene}
    data = [scene_inputs(torch, sc, dev) for sc in scenes]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, stream, dets = [], [], []
    for fn in wrappers.values():
        fn.launches = 0
    for i, args in enumerate(data):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        outs = model(*args)
        torch.cuda.set_sync_debug_mode("error")
        try:
            dec = decode_predictions(outs, cfg)
            boxes, scores, labels, valid = post_process(*dec, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if merging:
            dets.append(postprocess_batch(boxes, scores, labels, valid,
                                          cfg)[0])
            e1.record()
            n_valid = len(dets[-1]["scores"])
        else:
            e1.record()
            n_valid = int(valid.sum())           # synchronizes
        times.append((time.perf_counter() - t0) * 1e3)
        stream.append(e0.elapsed_time(e1))
        if not merging and gts is not None:
            dets.append(split_batch(boxes, scores, labels, valid)[0])
        L, nq = cfg.num_decoder_layers, (4 if pts else 1) * cfg.num_query
        shapes = {"all_cls_scores": (L, 1, nq, cfg.num_classes),
                  "all_bbox_preds": (L, 1, nq, cfg.code_size),
                  "all_iou_preds": (L, 1, nq)}
        if "all_uncertainty_preds" in outs:
            shapes["all_uncertainty_preds"] = (L, 1, nq, cfg.num_classes + 1)
        for k, shp in shapes.items():
            if tuple(outs[k].shape) != shp or not bool(
                    torch.isfinite(outs[k]).all()):
                fail(f"scene {i}: {k} has shape {tuple(outs[k].shape)} "
                     f"(want {shp}) or non-finite values")
        extra = ""
        if merging:
            # random weights rarely pass score_thr: the decoded boxes
            # (in post_center_range) must exist, the merged ones be finite
            n_dec, n_thr = int(dec[3].sum()), int(valid.sum())
            if not (n_dec > 0 and n_valid <= n_thr and np.isfinite(
                    dets[-1]["boxes"]).all()):
                fail(f"scene {i}: {n_dec} decoded boxes, {n_thr} above "
                     f"score_thr, {n_valid} merged, or non-finite boxes")
            extra = (f" (decoded in range {n_dec}, above score_thr "
                     f"{n_thr}, after merging {n_valid})")
        elif not (n_valid > 0 and bool(torch.isfinite(boxes[valid]).all())):
            fail(f"scene {i}: {n_valid} valid boxes, or non-finite boxes")
        if cfg.num_thr is not None and n_valid > cfg.num_thr:
            fail(f"scene {i}: {n_valid} valid boxes > num_thr {cfg.num_thr}")
        print(f"[{tag}] scene {i}: valid boxes={n_valid} "
              f"(of {valid.shape[1]}){extra} ms={times[-1]:.3f} stream_ms="
              f"{stream[-1]:.3f}{' (warm-up)' if i == 0 else ''}")
    want = {k: v * len(data) for k, v in per_scene.items()}
    metric = None
    if gts is not None:
        t0 = time.perf_counter()
        names, seen = metric_names(cfg)
        if merging:
            metric = kitti_eval.kitti_eval(gts, dets, names, device=dev)
        else:
            metric = indoor_eval.indoor_eval(gts, dets, names,
                                             seen_classes=seen, device=dev)
        n_eval = sum(bool(len(g["boxes"]) and len(d["boxes"]))
                     for g, d in zip(gts, dets))
        want["iou3d_rotated_sets"] = n_eval
        want["iou_bev_rotated_sets"] = n_eval if merging else 0
        print(f"[{tag}] {'kitti' if merging else 'indoor'}_eval of the "
              f"{len(dets)} scenes against their synthetic GT "
              f"({time.perf_counter() - t0:.3f}s): {_metric_summary(metric)}")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[{tag}] ms/scene median of {len(times) - 1} after warm-up="
          f"{statistics.median(times[1:]):.3f} stream_ms/scene="
          f"{statistics.median(stream[1:]):.3f} (spread "
          f"{min(stream[1:]):.3f}-{max(stream[1:]):.3f}) all="
          f"{[round(t, 3) for t in times]} peak_mem_bytes={peak}")
    print(f"[{tag}] launches={launches} expected={want}")
    if launches != want:
        fail(f"kernel launch counts {launches} != {want}")
    return launches, dets, metric


def _metric_summary(metric):
    """The headline numbers of a metric dict: the moderate APs of KITTI,
    the mAPs of indoor."""
    keys = [k for k in metric if "moderate" in k or k.startswith("mAP")]
    return {k: round(metric[k], 4) for k in keys}


def _ms_or_none(ms):
    """A device time, or "not measured" where the profiler caught no
    kernel of the name (``None``)."""
    return "not measured" if ms is None else f"{ms:.4f}"


def plain_iou_rows(torch, boxes, rows=500):
    """The plain pairwise IoU (bottom z) of (B, N, 7) boxes on their
    device, in blocks of ``rows`` rows so that the plain version's
    (pairs, 16, 2) buffers stay bounded."""
    from uni3detr_tpu_torch.geom.iou import iou3d_rotated

    return torch.cat([iou3d_rotated(boxes[:, r:r + rows], boxes, "bottom")
                      for r in range(0, boxes.shape[1], rows)], dim=1)


def serial_per_class(torch, iou, scores, labels, valid, thr):
    """``_greedy_suppress_serial`` on each class of one scene (CPU)."""
    from uni3detr_tpu_torch.ops.nms import _greedy_suppress_serial

    keep = torch.zeros(valid.shape, dtype=torch.bool)
    for c in labels[valid].unique().tolist():
        keep |= _greedy_suppress_serial(iou, scores, valid & (labels == c),
                                        thr)
    return keep


def nms_phase(torch, model, scenes, dev, tag, report):
    """N1 and N2 on each scene's own decoded boxes (bf16 model, the
    preset's ``max_num``), after the inference phase:

    - N1 (matrix) against the plain IoU, computed in row blocks: max abs
      difference, held to NMS_IOU_ATOL (fp32 rounding: sin, cos and the
      shoelace sum's order, at areas down to ~1/100 of the products they
      cancel at scene-scale coordinates);
    - N2: the keep set of the main path's NMS (``ops.nms.nms_keep``: N1
      writing the bitmask, then N2) equal to ``_greedy_suppress_serial``
      per class on N1's own matrix, on the CPU copy;
    - end to end: that keep set against the plain path (the plain IoU,
      then the per-class wavefront ``_greedy_suppress``), which may
      differ only if some same-class pair's plain IoU lies within
      NMS_IOU_ATOL of ``nms_thr``; those pairs are counted.

    Every scene of the phase, the warm-up included. On the first scene:
    kernel, plain and (N1) matrix times, and the bounds from this scene's
    pairs; added to ``report``."""
    from uni3detr_tpu_torch.geom.boxes import bottom_center_boxes
    from uni3detr_tpu_torch.geom.iou import iou3d_rotated_pairwise
    from uni3detr_tpu_torch.ops import nms
    from uni3detr_tpu_torch.train.coder import decode_predictions

    cfg = model.cfg
    thr = cfg.nms_thr
    for i, sc in enumerate(scenes):
        boxes, scores, labels, valid = decode_predictions(
            model(*scene_inputs(torch, sc, dev)), cfg)
        bx = bottom_center_boxes(boxes)[..., :7].contiguous()
        B, N = scores.shape
        t0 = time.perf_counter()
        iou_k = iou3d_rotated_pairwise(bx)
        iou_p = plain_iou_rows(torch, bx)
        err = (iou_k - iou_p).abs().max().item()
        keep = nms.nms_keep(bx, scores, labels, valid, thr, cfg.num_classes)
        want = serial_per_class(torch, iou_k[0].cpu(), scores[0].cpu(),
                                labels[0].cpu(), valid[0].cpu(), thr)
        plain = nms.nms_keep_plain(bx, scores, labels, valid, thr,
                                   cfg.num_classes, iou=iou_p)
        same = ((labels[0][:, None] == labels[0][None, :])
                & valid[0][:, None] & valid[0][None, :])
        near = int((same & ((iou_p[0] - thr).abs() <= NMS_IOU_ATOL)).sum())
        n_diff = int((keep != plain).sum())
        print(f"[{tag}] NMS scene {i}: N={N} valid={int(valid.sum())} "
              f"kept={int(keep.sum())}; N1 vs plain IoU max_abs_err="
              f"{err:.3g} (atol {NMS_IOU_ATOL}); N2 keep set equal to the "
              f"serial pass on N1's matrix: {torch.equal(keep[0].cpu(), want)}"
              f"; vs the plain path: {n_diff} boxes differ, {near} "
              f"same-class pairs within {NMS_IOU_ATOL} of nms_thr {thr} "
              f"({time.perf_counter() - t0:.2f}s)")
        if not err <= NMS_IOU_ATOL:
            fail(f"N1 iou3d_rotated differs from the plain IoU by {err}")
        if not torch.equal(keep[0].cpu(), want):
            fail("N2 keep set differs from _greedy_suppress_serial on N1's "
                 "matrix")
        if n_diff and not near:
            fail(f"NMS: {n_diff} boxes differ from the plain path with no "
                 f"pair near the threshold")
        if i:
            continue
        # times and bounds on this scene
        order, lab = nms.nms_order(scores, labels, valid)
        sbx = torch.gather(bx, 1, order[..., None].expand(-1, -1, 7))
        bits = nms.overlap_mask(sbx, lab, thr)
        W = bits.shape[1]
        lo, hi = sbx[0, :, 2], sbx[0, :, 2] + sbx[0, :, 5]
        zpos = (torch.minimum(hi[:, None], hi[None, :])
                - torch.maximum(lo[:, None], lo[None, :])) > 0
        cand = torch.ones((N, N), dtype=torch.bool, device=dev).triu(1) & \
            (lab[0][:, None] == lab[0][None, :]) & (lab[0][:, None] >= 0)
        n_cand, n_clip = int(cand.sum()), int((cand & zpos).sum())
        pad = W * 64 - N
        n_tiles = int(torch.nn.functional.pad(cand, (0, pad, 0, pad))
                      .reshape(W, 64, W, 64).any(dim=3).any(dim=1).sum())
        b_mask = iou_roofline(n_clip, n_cand, 32 * N + 8 * N * W)
        b_mat = iou_roofline(int(zpos.sum()), N * N, 28 * N + 4 * N * N)
        ms = median_ms(torch, lambda: nms.overlap_mask(sbx, lab, thr), 20)
        mat_ms = median_ms(torch, lambda: iou3d_rotated_pairwise(bx), 10)
        pms = median_ms(torch, lambda: plain_iou_rows(torch, bx), 3, 1)
        dev_ms = device_ms_by_name(
            torch, lambda: nms.overlap_mask(sbx, lab, thr),
            "u3d_iou3d_rotated_mask", 10)[0] or None
        print(f"[{tag}] N1 iou3d_rotated N={N} bitmask: ms={ms:.4f} device_ms"
              f"={_ms_or_none(dev_ms)} bound_ms={b_mask['bound_ms']:.5f} "
              f"({b_mask['bound_by']}; {n_cand} same-class pairs above the "
              f"diagonal, {n_clip} with z overlap; {n_tiles} of {W * W} "
              f"tiles hold one); matrix: ms={mat_ms:.4f} "
              f"bound_ms={b_mat['bound_ms']:.5f} ({b_mat['bound_by']}; "
              f"{N * N} pairs, {int(zpos.sum())} with z overlap); plain IoU "
              f"(row blocks) ms={pms:.4f}")
        _report_add(report, "iou3d_rotated", err, ms, pms, 1, b_mask)
        report["iou3d_rotated"].update(matrix_ms=mat_ms,
                                       matrix_bound_ms=b_mat["bound_ms"],
                                       device_ms=dev_ms)
        ms = median_ms(torch, lambda: nms.greedy_scan(bits, lab, order), 20)
        dev_ms = device_ms_by_name(
            torch, lambda: nms.greedy_scan(bits, lab, order),
            "u3d_nms_greedy", 10)[0] or None
        pms = median_ms(torch, lambda: nms.greedy_scan_plain(bits, lab,
                                                             order), 3, 1)
        old_ms = median_ms(torch, lambda: nms.nms_keep_plain(
            bx, scores, labels, valid, thr, cfg.num_classes, iou=iou_p),
            3, 1)
        b_scan = nms_scan_roofline(B, N)
        print(f"[{tag}] N2 nms_greedy N={N} words={W}: ms={ms:.4f} "
              f"device_ms={_ms_or_none(dev_ms)} bound_ms={b_scan['bound_ms']:.5f} "
              f"({b_scan['bound_by']}) plain scan ms={pms:.4f}; the "
              f"per-class wavefront on the plain IoU ms={old_ms:.4f}")
        _report_add(report, "nms_greedy", 0.0, ms, pms, 1, b_scan)
        report["nms_greedy"].update(device_ms=dev_ms, wavefront_ms=old_ms)
        del bits, zpos, cand
        del iou_k, iou_p
    torch.cuda.empty_cache()


def merge_phase(torch, model, scenes, dev, tag, report=None):
    """Box merging on real input: random weights with ``coder_alpha`` 0.2
    rarely pass ``score_thr``, so the shipped path may merge nothing. Here
    every decoded box in ``post_center_range`` (all ``max_num`` rows that
    pass it) enters ``merge_boxes_3d``, with N1's matrix (one launch, the
    boxes of ``eval.postprocess.split_batch``) and with the plain IoU on
    the CPU copy: the same kept indices and labels, boxes within
    MERGE_BOX_ATOL, N1's matrix within EVAL_IOU_ATOL of the plain one.
    Fails if no box entered. On the first scene: N1's
    matrix time (event and device), the plain IoU's, the host's merge loop
    and the bound from this scene's pairs; added to ``report``."""
    import numpy as np
    from uni3detr_tpu_torch.eval.box_merging import merge_boxes_3d
    from uni3detr_tpu_torch.eval.postprocess import split_batch
    from uni3detr_tpu_torch.geom.iou import (iou3d_rotated,
                                             iou3d_rotated_pairwise)
    from uni3detr_tpu_torch.train.coder import decode_predictions, post_process

    cfg = model.cfg
    raw = dataclasses.replace(cfg, score_thr=None)
    iou_err = 0.0
    for i, sc in enumerate(scenes):
        out = post_process(*decode_predictions(
            model(*scene_inputs(torch, sc, dev)), cfg), raw)
        d = split_batch(*out, with_iou=True)[0]
        c = split_batch(*(t.cpu() for t in out))[0]
        args = (d["labels"], d["boxes"], d["scores"])
        got = merge_boxes_3d(*args, iou=d["iou"])
        want = merge_boxes_3d(c["labels"], c["boxes"], c["scores"],
                              device="cpu")
        n_in, n_out = len(d["scores"]), len(got[2])
        err = float(np.abs(got[1] - want[1]).max()) if n_out else 0.0
        cb = torch.from_numpy(c["boxes"][:, :7].copy())
        ref = iou3d_rotated(cb, cb, "bottom").numpy()
        iou_err = max(iou_err, float(np.abs(d["iou"] - ref).max())
                      if n_in else 0.0)
        same = (np.array_equal(got[3], want[3])
                and np.array_equal(got[0], want[0]))
        print(f"[{tag}] merge scene {i}: {n_in} boxes entered, {n_out} "
              f"survived; card (N1) vs CPU (plain IoU): kept indices and "
              f"labels equal: {same}, boxes max_abs_err={err:.3g} (atol "
              f"{MERGE_BOX_ATOL}), IoU max_abs_err so far={iou_err:.3g} "
              f"(atol {EVAL_IOU_ATOL})")
        if n_in == 0:
            fail("box merging: no decoded box entered")
        if not same or err > MERGE_BOX_ATOL or iou_err > EVAL_IOU_ATOL:
            fail("box merging: the card's result differs from the CPU's")
        if i or report is None:
            continue
        bx = out[0][..., :7].contiguous()
        K = bx.shape[1]
        lo, hi = bx[0, :, 2], bx[0, :, 2] + bx[0, :, 5]
        zpos = int(((torch.minimum(hi[:, None], hi[None, :])
                     - torch.maximum(lo[:, None], lo[None, :])) > 0).sum())
        bound = iou_roofline(zpos, K * K, 28 * K + 4 * K * K)
        ms = median_ms(torch, lambda: iou3d_rotated_pairwise(bx), 20)
        dev_ms = device_ms_by_name(torch, lambda: iou3d_rotated_pairwise(bx),
                                   "u3d_iou3d_rotated_kernel<false>",
                                   10)[0] or None
        pms = median_ms(torch, lambda: iou3d_rotated(bx, bx, "bottom"), 10)
        t0 = time.perf_counter()
        merge_boxes_3d(*args, iou=d["iou"])
        host_ms = (time.perf_counter() - t0) * 1e3
        print(f"[{tag}] N1 matrix (merge) K={K}: ms={ms:.4f} device_ms="
              f"{_ms_or_none(dev_ms)} plain_ms={pms:.4f} bound_ms="
              f"{bound['bound_ms']:.6f} ({bound['bound_by']}; {K * K} "
              f"pairs, {zpos} with z overlap); the host's merge loop over "
              f"{n_in} boxes ms={host_ms:.3f}")
        _report_add(report, "iou3d_rotated_matrix", 0.0, ms, pms, 1, bound)
        report["iou3d_rotated_matrix"]["device_ms"] = dev_ms
    if report is not None:
        r = report["iou3d_rotated_matrix"]
        r["max_abs_err"] = max(r["max_abs_err"], iou_err)


def eval_phase(torch, cfg, dets, gts, dev, tag, metric, report=None):
    """The metric's overlaps: N1's two-set forms (3D, and BEV for KITTI)
    on each scene's detections x GT, and on its detections x themselves
    in reverse order (random weights put few detections on a GT), against
    the plain two-set IoU on the CPU, within EVAL_IOU_ATOL; ``metric``
    (from the card's overlaps, in ``infer_phase``) equal to the metric
    from the plain overlaps. On the
    scene with the most pairs: kernel (event and device) and plain times
    and the bounds from its pairs; added to ``report``."""
    import numpy as np
    from uni3detr_tpu_torch.eval import indoor_eval, kitti_eval
    from uni3detr_tpu_torch.geom import iou as tiou

    kitti = cfg.post_processing == "box_merging"
    forms = {"iou3d_rotated_sets": (
        lambda a, b: tiou.iou3d_rotated_sets(a, b, "bottom"),
        lambda a, b: tiou.iou3d_rotated(a, b, "bottom"),
        "u3d_iou3d_rotated_kernel<false>")}
    if kitti:
        forms["iou_bev_rotated_sets"] = (tiou.iou_bev_rotated_sets,
                                         tiou.iou_bev_rotated,
                                         "u3d_iou3d_rotated_kernel<true>")
    errs = {name: 0.0 for name in forms}
    hits = {name: 0 for name in forms}
    sets = []
    for d, g in zip(dets, gts):
        if not (len(d["boxes"]) and len(g["boxes"])):
            continue
        a = torch.from_numpy(d["boxes"][:, :7].copy())[None]
        b = torch.from_numpy(g["boxes"][:, :7].copy())[None]
        sets.append((a, b))
        # detections x GT (at random weights mostly apart), and the
        # detections x themselves, which overlap
        for x, y in ((a, b), (a, a.flip(1))):
            for name, (kern, plain, _) in forms.items():
                ref = plain(x, y)
                e = (kern(x.to(dev), y.to(dev)).cpu() - ref).abs().max()
                errs[name] = max(errs[name], e.item())
                hits[name] += int((ref > 0).sum())
    names, seen = metric_names(cfg)
    if kitti:
        want = kitti_eval.kitti_eval(gts, dets, names, device="cpu")
    else:
        want = indoor_eval.indoor_eval(gts, dets, names, seen_classes=seen,
                                       device="cpu")

    def same(x, y):
        if isinstance(x, dict):
            return sorted(x) == sorted(y) and all(same(x[k], y[k])
                                                  for k in x)
        return x == y or (np.isnan(x) and np.isnan(y))

    equal = same(metric, want)
    shown = ", ".join(f"{k} {v:.3g} ({hits[k]} pairs overlap)"
                      for k, v in errs.items())
    print(f"[{tag}] eval: N1 two-set forms vs the plain IoU on {len(sets)} "
          f"scenes (detections x GT and x the detections reversed), "
          f"max_abs_err: {shown} (atol {EVAL_IOU_ATOL}); the metric from "
          f"the card's overlaps equals the plain overlaps': {equal}")
    if max(errs.values(), default=0.0) > EVAL_IOU_ATOL or not equal:
        fail(f"eval: N1 overlaps differ from the plain IoU by {errs} or "
             f"the metric differs")
    if report is None or not sets:
        return
    a, b = (t.to(dev) for t in max(sets, key=lambda s: s[0].shape[1]
                                   * s[1].shape[1]))
    M, N = a.shape[1], b.shape[1]
    zo = (torch.minimum(a[0, :, None, 2] + a[0, :, None, 5],
                        b[0, None, :, 2] + b[0, None, :, 5])
          - torch.maximum(a[0, :, None, 2], b[0, None, :, 2])) > 0
    nbytes = 28 * (M + N) + 4 * M * N
    for name, (kern, plain, kname) in forms.items():
        clipped = int(zo.sum()) if name == "iou3d_rotated_sets" else M * N
        bound = iou_roofline(clipped, M * N, nbytes)
        ms = median_ms(torch, lambda: kern(a, b), 20)
        dev_ms = device_ms_by_name(torch, lambda: kern(a, b), kname,
                                   10)[0] or None
        pms = median_ms(torch, lambda: plain(a, b), 10)
        print(f"[{tag}] N1 {name} {M}x{N}: ms={ms:.4f} device_ms="
              f"{_ms_or_none(dev_ms)} plain_ms={pms:.4f} bound_ms="
              f"{bound['bound_ms']:.6f} ({bound['bound_by']}; {clipped} "
              f"pairs clipped) x1/scene")
        _report_add(report, name, errs[name], ms, pms, 1, bound)
        report[name]["device_ms"] = dev_ms


def fp32_phase(torch, base_cfg, sd, scene, dev, tag, every_layer=True,
               min_share=FP32_SHARE):
    """Card (kernels) vs CPU (plain versions), fp32, TF32 off.

    Tolerance FP32_ATOL: the two runs sum in different orders through
    ~40 sparse and dense convs and three decoder layers; the JAX
    package's real-size torch parity test (tests/test_torch_import.py)
    holds 2e-3. With ``every_layer`` (SUN RGB-D) every head output is
    held to it. At the nuScenes scale the later decoder layers are
    chaotic under random weights: each layer moves its reference points
    by its regression output and the next samples a 180x180 volume whose
    random-weight features jump by ~100 between cells, so a 1e-6
    relative change of the volume moves the last layer's boxes by
    centimetres. There the first decoder layer is held to FP32_ATOL, all
    layers with at least ``min_share`` of their entries within it, and a
    third run, on the card with the fused volume times (1 + 1e-6 N(0,
    1)), prints that floor. ``min_share=None`` (KITTI's 9 layers) holds
    the first layer alone: there the floor itself leaves ~7% of the
    outputs of all layers outside FP32_ATOL.
    """
    from uni3detr_tpu_torch.models.detector import Uni3DETR

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(base_cfg, compute_dtype="float32")
    runs = [("card", dev), ("cpu", torch.device("cpu"))]
    if not every_layer:
        runs.append(("card, volume perturbed", dev))
    res = {}
    for label, where in runs:
        model = Uni3DETR(cfg).eval()
        model.load_state_dict(sd, strict=True)
        model.to(where)
        if label.endswith("perturbed"):
            gen = torch.Generator(device=where).manual_seed(0)
            model.pts_neck.register_forward_hook(
                lambda mod, args, out: out * (1 + 1e-6 * torch.randn(
                    out.shape, generator=gen, device=out.device)))
        pts, rnd = (torch.from_numpy(a).to(where) for a in scene)
        mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=where)
        t0 = time.perf_counter()
        outs, inter = model(pts, mask, rnd, return_intermediates=True)
        res[label] = (
            {k: v.cpu() for k, v in outs.items()},
            {k: (tuple(t.cpu() for t in v) if isinstance(v, tuple)
                 else v.cpu()) for k, v in inter.items()},
            time.perf_counter() - t0)
        del model, outs, inter
    (og, ig, tg), (oc, ic, tc) = res["card"], res["cpu"]
    nv_g, nv_c = int(ig["vmask"].sum()), int(ic["vmask"].sum())
    if nv_g != nv_c or not torch.equal(ig["coords"], ic["coords"]):
        fail(f"fp32: voxels differ card {nv_g} vs cpu {nv_c}")
    if not all(torch.equal(a, b) for a, b in zip(ig["fps_idx"],
                                                 ic["fps_idx"])):
        fail("fp32: FPS indices differ between card and cpu")

    def per_layer(a, b):
        return {k: [float(f"{(a[k][l] - b[k][l]).abs().max().item():.3g}")
                    for l in range(a[k].shape[0])] for k in a}

    def share(a, b):
        return min(((a[k] - b[k]).abs() <= FP32_ATOL).float().mean().item()
                   for k in a)

    errs, within = per_layer(og, oc), share(og, oc)
    print(f"[{tag}] voxels={nv_g} fps equal; card vs cpu max_abs_err per "
          f"decoder layer={errs} (atol {FP32_ATOL}); share within atol "
          f"{within:.6f}; card {tg:.2f}s cpu {tc:.2f}s")
    if every_layer:
        if max(max(v) for v in errs.values()) > FP32_ATOL:
            fail(f"fp32: head outputs differ by {errs}")
        return
    op = res["card, volume perturbed"][0]
    print(f"[{tag}] floor: card vs card with the volume perturbed by 1e-6 "
          f"relative, max_abs_err per decoder layer={per_layer(og, op)}; "
          f"share within atol {share(og, op):.6f}")
    if max(v[0] for v in errs.values()) > FP32_ATOL or (
            min_share is not None and within < min_share):
        fail(f"fp32: first-layer head outputs differ by {errs} or only "
             f"{within} of the outputs within {FP32_ATOL}")


def train_per_step(cfg, modality=None):
    """Kernel launches of one train step: the forward's K1-K4, K2/K3
    again for the feature gradients (not of conv_input, whose input needs
    none), K7/K10 for every weight gradient, K12 once for the instances
    of all decoder layers. OV-Uni3DETR: camera-only runs K12 alone; under
    the modality draw ri = 0 ([image, image]) no gradient reaches the
    point branch, which still runs forward."""
    counts = dict.fromkeys(kernel_wrappers(), 0)
    counts["auction_lap"] = 1
    if is_ov(cfg) and not cfg.use_lidar:
        return counts
    subm, strided = conv_cases(cfg)
    n_subm = sum(c[-1] for c in subm)
    counts.update(match_positions=len(cfg.encoder_channels),
                  gather_conv=n_subm, gather_conv_ids=len(strided),
                  fps_pair=1)
    if modality != 0:
        counts.update(gather_conv=2 * n_subm - 1,
                      gather_conv_ids=2 * len(strided),
                      gather_conv_dw=n_subm,
                      gather_conv_ids_dw=len(strided))
    return counts


def is_ov(cfg):
    return hasattr(cfg, "clip_dim")


def build_model(cfg):
    """``Uni3DETR`` or, for an OV preset, ``OV_Uni3DETR``."""
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR
    return (OV_Uni3DETR if is_ov(cfg) else Uni3DETR)(cfg)


def model_outputs(model, batch, modality=None):
    """The head's outputs on a train batch dict; an OV model with both
    branches fuses by ``modality``."""
    if is_ov(model.cfg):
        return model(batch, modality=modality)
    return model(batch["points"], batch["pts_mask"])


def dw_phase(torch, model, batch, dev, tag, kitti_auction,
             own_cotangents=False):
    """K7, K10 and K12 against their plain versions at the train step's
    shapes, and K4 at the train batch's (B sets of each kind in one
    launch). Tolerances DW_RTOL of max |dW|: fp32 sums of up to B*V rows
    in another order; bf16 rows and cotangents widen to fp32 exactly,
    looser only for safety. bf16 K7/K10 must give a bit-equal dW on a
    second call (fixed-order chunk sums, no float atomics); each shape
    prints the products' rate achieved (``pairs`` products of C x Cout).
    Auction and FPS: equal. K7/K10 take random features and cotangents
    in fp32 and bf16 at each shape, or with ``own_cotangents`` the
    features and cotangents of one train step (``own_dw_calls``, the
    preset's dtype). An OV model's step fuses [points, image] (ri 2)."""
    from uni3detr_tpu_torch.geom.boxes import gravity_center_boxes
    from uni3detr_tpu_torch.ops import fps, matching, sparse_conv_cuda as sc
    from uni3detr_tpu_torch.train import losses

    cfg = model.cfg
    B = batch["points"].shape[0]
    feats, coords, vmask = model.voxelize(batch["points"], batch["pts_mask"])
    sets = model.pts_middle_encoder.site_sets(coords, vmask, backward=True)
    gen = torch.Generator(device=dev).manual_seed(2)
    report, by_route = {}, {}

    def add(name, route, *a, **kw):
        _report_add(report, name, *a, **kw)
        _report_add(by_route, route, *a, **kw)

    def check(name, kern, plain, a, nb, V, Vout, calls, route, what):
        C, Cout, K = a[0].shape[2], a[-1].shape[2], nb.shape[2]
        pairs = int((nb < V).sum())
        key = "bfloat16" if a[0].dtype == torch.bfloat16 else "float32"
        got, ref = kern(*a), plain(*a)
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= DW_RTOL[key] * max(scale, 1e-6):
            fail(f"{name} C={C}->{Cout} {key} ({what}): max err {err} > "
                 f"{DW_RTOL[key]} x {scale}")
        bf16 = key == "bfloat16"
        if bf16 and not torch.equal(kern(*a), got):
            fail(f"{name} C={C}->{Cout} bf16 ({what}): two calls differ")
        ms = median_ms(torch, lambda: kern(*a), 10)
        pms = median_ms(torch, lambda: plain(*a), 10)
        bound = dw_roofline(pairs, V, C, Vout, K, Cout, B,
                            elem=2 if bf16 else 4,
                            ids=name == "gather_conv_ids_dw")
        extra = ""
        if bf16:   # the presets' dtype: reported
            rows_t = _gathered(torch, a[0], nb).T
            g2 = a[-1].reshape(-1, Cout)
            gms = median_ms(torch, lambda: rows_t @ g2, 10)
            add(name, route, err, ms, pms, calls, bound, gemm_ms=gms)
            extra = f" gemm_ms={gms:.4f} repeat bit-equal"
            del rows_t, g2
        print(f"[{tag}] {name} B={B} V={V} Vout={Vout} C={C}->{Cout} "
              f"{key} ({what}) max_abs_err={err:.3g} (max |ref| "
              f"{scale:.3g}, rtol {DW_RTOL[key]}) ms={ms:.4f} "
              f"plain_ms={pms:.4f}{extra} bound_ms={bound['bound_ms']:.5f} "
              f"({bound['bound_by']}, {pairs} pairs, "
              f"{bound['ops'] / ms / 1e9:.2f} TFLOP/s achieved) "
              f"x{calls}/step tpu={route}")
        del got, ref

    def random_inputs(rest, V, Vout, C, Cout):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((B, V, C), generator=gen, device=dev)
            g = torch.randn((B, Vout, Cout), generator=gen, device=dev)
            yield (x.to(dtype),) + rest + (g.to(dtype),)

    if own_cotangents:
        for name, a in own_dw_calls(torch, model, batch):
            V, Vout = a[0].shape[1], a[-1].shape[1]
            if name == "gather_conv_dw":
                nb, kern, plain = a[1], sc.gather_conv_dw, \
                    sc.gather_conv_dw_plain
                route = tpu_route("subm-dw", V)
            else:
                nb = sc.match_positions_plain(a[1], a[2], V)
                kern, plain = sc.gather_conv_ids_dw, \
                    sc.gather_conv_ids_dw_plain
                route = tpu_route("strided-dw", V, Vout)
            check(name, kern, plain, a, nb, V, Vout, 1, route,
                  "the step's own")
    else:
        subm, strided = conv_cases(cfg)
        for si, C, Cout, calls in subm:
            s = sets[si]
            V = s["n_sites"]
            nb = sc.match_positions_plain(s["ids"], s["qids"], V)
            for a in random_inputs((nb,), V, V, C, Cout):
                check("gather_conv_dw", sc.gather_conv_dw,
                      sc.gather_conv_dw_plain, a, nb, V, V, calls,
                      tpu_route("subm-dw", V), "random")
        for si, C, Cout, calls in strided:
            prev, s = sets[si - 1], sets[si]
            V, Vout = prev["n_sites"], s["n_sites"]
            nb = sc.match_positions_plain(prev["ids"], s["sq"], V)
            for a in random_inputs((prev["ids"], s["sq"]), V, Vout, C,
                                   Cout):
                check("gather_conv_ids_dw", sc.gather_conv_ids_dw,
                      sc.gather_conv_ids_dw_plain, a, nb, V, Vout, calls,
                      tpu_route("strided-dw", V, Vout), "random")

    # K4 at the train batch: 2 * B problems a launch, the largest
    # slices in shared memory of any main-path call; exact
    fargs = fps_sets(torch, batch["points"], batch["pts_mask"], coords,
                     vmask)
    S = cfg.num_query
    sizes = [fargs[0].shape[1], fargs[2].shape[1]]
    sms, smem_limit, _ = fps._device_limits(dev.index or 0)
    grid, in_smem = fps.fps_plan(sizes, B, sms, smem_limit)
    fps_pair_check(torch, fargs, S, f"{tag} B={B} N={sizes}")
    ms = median_ms(torch, lambda: fps.farthest_point_sample_pair(*fargs, S),
                   5)
    print(f"[{tag}] K4 fps_pair B={B} N=({sizes[0]}, {sizes[1]}) "
          f"S={S} exact ms={ms:.4f} grid={grid} slices in "
          f"{'shared' if in_smem else 'global'} memory x1/step")

    # K12 on the train step's own costs: every decoder layer's cost of
    # the model at seed 0 on this batch, as the loss's one matching call
    # builds them; then DETR-like synthetic costs (focal +-4, L1, IoU
    # terms) and a KITTI-shaped set (gt_repeat=5 duplicated columns)
    torch.manual_seed(0)          # dropout
    outs = model_outputs(model, batch, modality=2)
    costs = losses.all_layer_costs(outs, gravity_center_boxes(
        batch["gt_boxes"]), batch["gt_labels"], cfg)
    L, B = costs.shape[:2]
    model_case = matching.auction_problem(
        costs.reshape(L * B, *costs.shape[2:]), batch["gt_mask"].repeat(L, 1),
        cfg.num_query, cfg.gt_repeattimes, cfg.matcher_phases)
    del outs, costs
    rng = torch.Generator(device=dev).manual_seed(3)

    def synthetic(G, nq, n_gt, rep):
        c = (2 * torch.randn((G, nq, n_gt), generator=rng, device=dev)
             + 2 * torch.rand((G, nq, n_gt), generator=rng, device=dev)
             + 1.2 * torch.rand((G, nq, n_gt), generator=rng, device=dev))
        return matching._auction_instances(c.repeat(1, 1, rep))

    cases = [("model-costs", *model_case, 1),
             ("synthetic", *synthetic(B * 3, cfg.num_query,
                                      cfg.max_gt, 1), 2048.0, 0)]
    if kitti_auction:
        # KITTI: 300 queries, 50 GT columns tiled 5 times, eps spread / 8**3
        cases.append(("kitti-shaped", *synthetic(10, 300, 50, 5), 8.0 ** 3,
                      0))
    for label, benefit, spread, eps_div, calls in cases:
        auction_check(torch, tag, label, benefit, spread, eps_div, calls,
                      add)
    print(f"[{tag}] voxels={int(vmask.sum())} of {vmask.numel()} "
          f"sites per stage={[int(s['mask'].sum()) for s in sets]} "
          f"budgets={[s['n_sites'] for s in sets]}")
    print_report(tag, report, by_route)
    return report


def own_dw_calls(torch, model, batch):
    """(name, arguments) of every K7 / K10 call in the backward of one
    train step on ``batch`` (an OV model fusing [points, image], ri 2),
    recorded by wrapping the module's entry points for that step only;
    the parameters' gradients are dropped after."""
    from uni3detr_tpu_torch.geom.boxes import gravity_center_boxes
    from uni3detr_tpu_torch.ops import sparse_conv_cuda as sc
    from uni3detr_tpu_torch.train.losses import uni3detr_loss

    calls = []
    saved = {n: getattr(sc, n) for n in ("gather_conv_dw",
                                         "gather_conv_ids_dw")}

    def recorder(name, fn):
        def call(*a):
            calls.append((name, tuple(t.detach() for t in a)))
            return fn(*a)
        call.launches = fn.launches     # the wrapper counts by its name
        return call

    for name, fn in saved.items():
        setattr(sc, name, recorder(name, fn))
    try:
        with torch.enable_grad():
            torch.manual_seed(0)          # dropout
            outs = model_outputs(model.train(), batch, modality=2)
            total, _ = uni3detr_loss(outs, gravity_center_boxes(
                batch["gt_boxes"]), batch["gt_labels"], batch["gt_mask"],
                model.cfg)
            total.backward()
    finally:
        for name, fn in saved.items():
            fn.launches = getattr(sc, name).launches
            setattr(sc, name, fn)
    model.zero_grad(set_to_none=True)
    return calls


def auction_check(torch, tag, label, benefit, spread, eps_div, calls, add):
    """K12 on one instance set: every variant whose shared memory fits
    (and the default, which the model path takes) bit-equal to the plain
    version, rounds and bids equal too, no bidder left unassigned; event
    and device ms of each, the plain version's ms, the rounds per instance
    (min / median / max), device ms per round of the longest instance, and
    the round-counting bound. The default's numbers go to the report
    (``calls`` per train step)."""
    from uni3detr_tpu_torch.ops import matching

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ref, ref_counts = matching.auction_lap_plain(benefit, spread, eps_div,
                                                 return_counts=True)
    b.record()
    b.synchronize()
    pms = a.elapsed_time(b)
    rounds = ref_counts[:, 0].tolist()
    bids = int(ref_counts[:, 1].sum())
    bound = auction_roofline(*benefit.shape, bids)
    print(f"[{tag}] K12 auction_lap {label} {tuple(benefit.shape)} eps "
          f"spread/{eps_div:g}: rounds per instance min={min(rounds)} "
          f"median={statistics.median(rounds)} max={max(rounds)}, bids="
          f"{bids}, plain_ms={pms:.4f} bound_ms={bound['bound_ms']:.6f} "
          f"({bound['bound_by']}, a lower bound)")
    for variant in (None,) + matching.AUCTION_VARIANTS:
        try:
            got, counts = matching.auction_lap(benefit, spread, eps_div,
                                               return_counts=True,
                                               variant=variant)
        except ValueError as e:      # a forced variant that does not fit
            print(f"[{tag}] K12 {label} variant={variant}: {e}")
            continue
        ran = matching.auction_lap.variant
        if not (torch.equal(got, ref) and torch.equal(counts, ref_counts)) \
                or bool((got < 0).any()):
            fail(f"K12 auction_lap ({label}, {ran}) differs from the plain "
                 f"version or left a bidder unassigned")

        def call():
            matching.auction_lap(benefit, spread, eps_div, variant=variant)

        ms = median_ms(torch, call, 10)
        dev_ms, _ = device_ms_by_name(torch, call, "u3d_auction", 10)
        print(f"[{tag}] K12 {label} variant={variant or 'default'} "
              f"(ran {ran}): exact, rounds and bids equal; ms={ms:.4f} "
              f"device_ms={dev_ms:.4f} device ms per round of the longest "
              f"instance={dev_ms / max(max(rounds), 1) * 1e3:.3f} us "
              f"x{calls}/step")
        if variant is None and calls:
            add("auction_lap", "K12", 0.0, ms, pms, calls, bound)


def train_phase(torch, cfg, sd, batch, dev, tag, warmup, steps,
                lr_schedule, momentum_schedule=None, lr_mult=None,
                modality_seed=None, losses=None):
    """Train steps on one fixed batch, each step's launches asserted;
    returns (launches of the timed steps, model, optimizer, the OV
    modality generator or None); ``losses``, a list, receives each step's
    total loss. An OV model trains with the per-module
    multipliers ``lr_mult`` and, with both branches, draws ri from a CPU
    generator seeded ``modality_seed``: each step's launches are those of
    its ri, and ri must take all three values over the run; the frozen
    ResNet stages must end bit-equal to their start."""
    from uni3detr_tpu_torch.ops import matching
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    model.to(dev)
    opt = make_optimizer(model, lr_schedule,
                         momentum_schedule=momentum_schedule,
                         lr_mult=lr_mult)
    mm = is_ov(cfg) and cfg.use_lidar and cfg.use_camera
    gen = torch.Generator().manual_seed(modality_seed) if mm else None
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    counters = kernel_wrappers()
    losses = [] if losses is None else losses
    times, draws = [], []
    want = dict.fromkeys(counters, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(warmup + steps):
        if i == warmup:
            for fn in counters.values():
                fn.launches = 0
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        logs = train_step(model, opt, batch, modality_generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ri = model.last_modality if mm else None
        draws.append(ri)
        step = {k: fn.launches - before[k] for k, fn in counters.items()}
        expect = train_per_step(cfg, ri)
        if step != expect:
            fail(f"train step {i} (ri {ri}): launches {step} != {expect}")
        if i >= warmup:
            want = {k: want[k] + v for k, v in expect.items()}
        loss, gnorm = float(logs["total_loss"]), float(logs["grad_norm"])
        losses.append(loss)
        group = opt.adamw.param_groups[0]
        print(f"[{tag}] step {i}: total_loss={loss:.5f} grad_norm="
              f"{gnorm:.5f} lr={group['lr'] / group['lr_mult']:.4g} beta1="
              f"{group['betas'][0]:.4f}"
              + (f" ri={ri}" if mm else "") + f" ms={times[-1]:.3f} "
              f"peak_mem_bytes={torch.cuda.max_memory_allocated(dev)}"
              f"{' (warm-up)' if i < warmup else ''}")
        if not all(math.isfinite(float(v)) for v in logs.values()):
            fail(f"train step {i}: non-finite logs {logs}")
    launches = {k: fn.launches for k, fn in counters.items()}
    if not all(bool(torch.isfinite(p).all()) for p in model.parameters()):
        fail("train: non-finite parameters after the run")
    timed = times[warmup:]
    DIRECT_TRAIN[tag] = (statistics.median(timed),
                         torch.cuda.max_memory_allocated(dev))
    print(f"[{tag}] ms/step median of {steps} after {warmup} "
          f"warm-up={statistics.median(timed):.3f} min={min(timed):.3f} "
          f"max={max(timed):.3f} peak_mem_bytes="
          f"{torch.cuda.max_memory_allocated(dev)}")
    print(f"[{tag}] launches={launches} expected={want}")
    if launches != want:
        fail(f"train kernel launch counts {launches} != {want}")
    if frozen:
        moved = [n for n, p in model.named_parameters()
                 if n in frozen and not torch.equal(p, frozen[n])]
        print(f"[{tag}] frozen parameters: {len(frozen)} tensors, "
              f"{sum(t.numel() for t in frozen.values())} values, bit-equal "
              f"after the run: {not moved}")
        if moved:
            fail(f"train: frozen parameters moved: {moved[:4]}")
    if mm:
        print(f"[{tag}] modality draws ri by step {draws}")
        if set(draws) != {0, 1, 2}:
            fail(f"train: ri took only {sorted(set(draws))}")
    rounds = matching.auction_lap.counts[:, 0].tolist()
    print(f"[{tag}] the last step's matching (one K12 launch, "
          f"{matching.auction_lap.variant}): {len(rounds)} instances, rounds "
          f"min={min(rounds)} median={statistics.median(rounds)} "
          f"max={max(rounds)}")
    n = min(5, len(losses) // 2)
    first, last = statistics.mean(losses[:n]), statistics.mean(losses[-n:])
    print(f"[{tag}] loss mean of the first {n} steps {first:.5f}, of the "
          f"last {n} {last:.5f}")
    if not last < first:
        fail("train: the loss did not fall")
    return launches, model, opt, gen


def train_parity_phase(torch, sd, batch_np, dev, base_cfg=None,
                       modality=None, lr_mult=None, tag="fp32-train",
                       norm_rtol=PARITY_LOSS_RTOL, first_layer=False):
    """One fp32 train step on the card (kernels) and on the CPU (plain
    versions): TF32 off, dropout 0, scipy's exact matching on both; an
    OV model with both branches under the pinned ``modality`` and with
    the multipliers ``lr_mult``. ``base_cfg`` defaults to the flagship.

    Losses within PARITY_LOSS_RTOL relative (the eval phase's head
    outputs differ by ~2e-3 absolute between card and CPU). Gradients,
    read from AdamW's first moment (0.1 x the clipped gradient on both),
    within PARITY_GRAD_RTOL of the largest gradient of their group. The
    deep groups are loose because fp32 gradients of this network at
    random init are that sensitive: two card runs that differ only in
    cuDNN's algorithm choice (or in nothing, through atomics) differ by
    2-6% (sparse encoder) and 4-15% (backbone) with the head at ~0.1%,
    the same assignment replayed on both. A second card step prints that
    floor beside the card-vs-CPU numbers. OV adds the image backbone,
    the FPN with the projection and depth convs, and the view convs
    with the fusion conv, and holds the gradient norm to ``norm_rtol``
    apart from the losses (see OV_PARITY_NORM_RTOL). With
    ``first_layer`` only the first decoder layer's losses are held: the
    later layers of the 6-layer head are chaotic under random weights
    (``ov_fp32_phase``), so their worst relative error is printed beside
    a floor, a card step with the image times (1 + 1e-6 N(0, 1))."""
    from uni3detr_tpu_torch.presets import SUNRGBD
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(base_cfg or SUNRGBD, compute_dtype="float32",
                              dropout=0.0, matcher="scipy")
    B = next(iter(batch_np.values())).shape[0]
    res = {}
    runs = [("card", dev), ("card again", dev), ("cpu", torch.device("cpu"))]
    if first_layer:
        runs.append(("card, image perturbed", dev))
    for label, where in runs:
        model = build_model(cfg)
        model.load_state_dict(sd, strict=True)
        model.to(where)
        opt = make_optimizer(model, TRAIN_LR, lr_mult=lr_mult)
        batch = {k: torch.from_numpy(v).to(where) for k, v in batch_np.items()}
        if label.endswith("perturbed"):
            gen = torch.Generator(device=where).manual_seed(0)
            img = batch["images"]
            batch["images"] = img * (1 + 1e-6 * torch.randn(
                img.shape, generator=gen, device=where))
        t0 = time.perf_counter()
        logs = train_step(model, opt, batch, modality=modality)
        mu = {n: opt.adamw.state[p]["exp_avg"].cpu()
              for n, p in model.named_parameters() if p in opt.adamw.state}
        res[label] = ({k: float(v) for k, v in logs.items()}, mu,
                      time.perf_counter() - t0)
        del model, opt, batch
    lc, mc, tc = res["cpu"]
    top = {n: n.split(".")[0] for n in mc}
    groups = {
        "sparse-conv weights": [n for n in mc if top[n] ==
                                "pts_middle_encoder" and mc[n].dim() == 5],
        "backbone+neck": [n for n in mc if top[n] in ("pts_backbone",
                                                      "pts_neck")],
        "head": [n for n in mc if top[n] == "pts_bbox_head"],
        "image backbone": [n for n in mc if top[n] == "img_backbone"],
        "FPN+proj+depth": [n for n in mc if top[n] in (
            "img_neck", "input_proj", "depth_net")],
        "view convs+fusion": [n for n in mc if top[n] in (
            "view_trans", "conv_trans_head_1")]}
    bad = []

    def held(k):
        return k != "grad_norm" and (not first_layer or k.startswith("d0."))

    def rel(a, b, keys):
        return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for k in keys}

    if first_layer:
        later = [k for k in lc if k != "grad_norm" and not held(k)]
        e, f = rel(res["card"][0], lc, later), rel(
            res["card"][0], res["card, image perturbed"][0], later)
        k, kf = max(e, key=e.get), max(f, key=f.get)
        print(f"[{tag}] later decoder layers' losses (not held): worst "
              f"relative error card vs cpu {e[k]:.3g} ({k}), card vs card "
              f"with the image perturbed {f[kf]:.3g} ({kf})")
    for label in ("card", "card again"):
        lg, mg, tg = res[label]
        loss_err = rel(lg, lc, [k for k in lc if held(k)])
        worst = max(loss_err, key=loss_err.get)
        norm_err = abs(lg["grad_norm"] - lc["grad_norm"]) / max(
            abs(lc["grad_norm"]), 1e-6)
        print(f"[{tag}] B={B} {label}: total_loss "
              f"{lg['total_loss']:.6f} cpu {lc['total_loss']:.6f}; worst "
              f"relative loss error {loss_err[worst]:.3g} ({worst}, rtol "
              f"{PARITY_LOSS_RTOL}); grad_norm {lg['grad_norm']:.6f} cpu "
              f"{lc['grad_norm']:.6f}, relative {norm_err:.3g} (rtol "
              f"{norm_rtol}); {label} {tg:.2f}s cpu {tc:.2f}s")
        if label == "card" and (loss_err[worst] > PARITY_LOSS_RTOL
                                or norm_err > norm_rtol):
            bad.append(f"losses differ {loss_err}, grad norm {norm_err}")
    _, m1, _ = res["card"]
    _, m2, _ = res["card again"]
    for group, names in groups.items():
        if not names:
            continue
        scale = max(mc[n].abs().max().item() for n in names)
        err = max((m1[n] - mc[n]).abs().max().item() for n in names)
        floor = max((m1[n] - m2[n]).abs().max().item() for n in names)
        print(f"[{tag}] grads {group}: card vs cpu {err / scale:.3g} "
              f"of max |grad| {scale:.3g} (rtol {PARITY_GRAD_RTOL[group]});"
              f" card vs card again {floor / scale:.3g}")
        if not err <= PARITY_GRAD_RTOL[group] * scale:
            bad.append(f"{group} gradients differ by {err} of {scale}")
    if bad:
        fail(f"fp32 train: {bad}")


def checkpoint_phase(torch, model, opt, batch, dev, schedules, lr_mult=None,
                     generator=None):
    """Save, load into a fresh model and optimizer (and, for OV, a fresh
    modality generator), compare every tensor bit for bit, then take one
    step from each with the global generator (dropout) seeded alike:
    losses within CKPT_LOSS_RTOL relative (the two forwards see equal
    weights and inputs; the card's atomics in the sparse-conv index
    build and cuDNN may still order sums differently), and the same ri."""
    from uni3detr_tpu_torch.train import checkpoint
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    t0 = time.perf_counter()
    checkpoint.save_checkpoint(CKPT_DIR, model, opt,
                               meta={"config": model.cfg},
                               generator=generator)
    size = os.path.getsize(os.path.join(CKPT_DIR, "checkpoint.pt"))
    t1 = time.perf_counter()
    tree, meta = checkpoint.load_checkpoint(CKPT_DIR)
    fresh = build_model(model.cfg).to(dev)
    fopt = make_optimizer(fresh, schedules[0], momentum_schedule=schedules[1],
                          lr_mult=lr_mult)
    fgen = None if generator is None else torch.Generator()
    checkpoint.restore(fresh, tree, fopt, fgen)
    t2 = time.perf_counter()
    shutil.rmtree(CKPT_DIR)
    if tree["step"] != opt.steps or fopt.steps != opt.steps:
        fail(f"checkpoint: step {tree['step']} / {fopt.steps} != {opt.steps}")
    a, b = model.state_dict(), fresh.state_dict()
    for k in a:
        if not torch.equal(a[k], b[k]):
            fail(f"checkpoint: {k} differs after the round trip")
    n_state = 0
    for p, q in zip(opt.params, fopt.params):
        for key, v in opt.adamw.state[p].items():
            if not torch.equal(v, fopt.adamw.state[q][key]):
                fail(f"checkpoint: optimizer {key} differs")
            n_state += 1
    groups = [(g["lr"], g["lr_mult"]) for g in opt.adamw.param_groups]
    if groups != [(g["lr"], g["lr_mult"]) for g in fopt.adamw.param_groups]:
        fail("checkpoint: the optimizer's groups differ")
    print(f"[checkpoint] {len(a)} model tensors, {n_state} optimizer "
          f"tensors in {len(groups)} groups (lr, multiplier) {groups} and "
          f"step {opt.steps} equal bit for bit; {size} bytes, save "
          f"{t1 - t0:.2f}s load {t2 - t1:.2f}s")
    losses, draws = [], []
    for m, o, g in ((model, opt, generator), (fresh, fopt, fgen)):
        torch.manual_seed(1234)
        losses.append(float(train_step(m, o, batch, modality_generator=g)[
            "total_loss"]))
        draws.append(getattr(m, "last_modality", None))
    rel = abs(losses[0] - losses[1]) / max(abs(losses[0]), 1e-6)
    print(f"[checkpoint] next step total_loss {losses[0]:.6f} (kept run) "
          f"{losses[1]:.6f} (resumed) relative {rel:.3g} (rtol "
          f"{CKPT_LOSS_RTOL})" + (f"; ri {draws}" if generator else ""))
    if not rel <= CKPT_LOSS_RTOL or draws[0] != draws[1]:
        fail(f"checkpoint: resumed loss {losses[1]} vs {losses[0]}, ri "
             f"{draws}")


def fps_path(torch, scene, dev, num_samples):
    """K11 as its callers call it: ``ops.fps.farthest_point_sample`` on
    a scene's points, its count zeroed before and read after."""
    from uni3detr_tpu_torch.ops import fps

    pts = torch.from_numpy(scene[0]).to(dev)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    fps.farthest_point_sample.launches = 0
    idx = fps.farthest_point_sample(pts[..., :3].contiguous(), mask,
                                    num_samples)
    torch.cuda.synchronize()
    n = fps.farthest_point_sample.launches
    if n != 1 or tuple(idx.shape) != (1, num_samples) or bool(
            (idx < 0).any() | (idx >= pts.shape[1]).any()):
        fail(f"K11 path: {n} launches, indices {tuple(idx.shape)}")
    print(f"[fps] farthest_point_sample N={pts.shape[1]} S={num_samples}: "
          f"launches={n}")
    return n


def _state_dict(torch, model):
    from uni3detr_tpu_torch.weights import random_state_dict
    return {k: torch.from_numpy(v)
            for k, v in random_state_dict(model, WEIGHT_SEED).items()}


def flagship(torch, dev):
    """Phases 3-8 on ``uni3detr_sunrgbd``; returns the launches of its
    inference and train runs."""
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.presets import SUNRGBD
    from uni3detr_tpu_torch.synthetic import (clustered_scene,
                                              clustered_scene_gt,
                                              clustered_train_batch)

    cfg = SUNRGBD
    model = Uni3DETR(cfg).eval()
    sd = _state_dict(torch, model)
    model.load_state_dict(sd, strict=True)
    model.to(dev)
    scenes = [clustered_scene(seed, cfg) for seed in range(N_SCENES)]
    gts = [clustered_scene_gt(seed, cfg) for seed in range(N_SCENES)]
    with torch.inference_mode():
        kernel_phase(torch, model, torch.from_numpy(scenes[0][0]).to(dev),
                     dev, "kernels")
        run, dets, metric = infer_phase(torch, model, scenes, dev,
                                        "flagship", gts=gts)
        launches = [run]
        eval_phase(torch, cfg, dets, gts, dev, "flagship", metric)
        nms_phase(torch, model, scenes, dev, "flagship", {})
        fp32_phase(torch, cfg, sd, scenes[0], dev, "fp32")
    torch.backends.cudnn.allow_tf32 = True     # the defaults again
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             clustered_train_batch(0, cfg, TRAIN_B).items()}
    with torch.no_grad():
        dw_phase(torch, model.train(), batch, dev, "train-kernels", True)
    del model
    launches.append(train_phase(torch, cfg, sd, batch, dev, "train",
                                TRAIN_WARMUP, TRAIN_STEPS, TRAIN_LR)[0])
    train_parity_phase(torch, sd, clustered_train_batch(1, cfg, PARITY_B),
                       dev)
    torch.cuda.empty_cache()
    return launches


def nuscenes(torch, dev):
    """Phases 9-13 on ``uni3detr_nuscenes``; returns (kernel report,
    launches)."""
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.presets import NUSCENES
    from uni3detr_tpu_torch.synthetic import (clustered_scene,
                                              clustered_train_batch)
    from uni3detr_tpu_torch.train.step import (cyclic_lr_schedule,
                                               cyclic_momentum_schedule)

    cfg = NUSCENES
    model = Uni3DETR(cfg).eval()
    sd = _state_dict(torch, model)
    model.load_state_dict(sd, strict=True)
    model.to(dev)
    scenes = [clustered_scene(seed, cfg) for seed in range(NUS_SCENES)]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        report = kernel_phase(torch, model, torch.from_numpy(
            scenes[0][0]).to(dev), dev, "nuscenes-kernels")
        launches = [infer_phase(torch, model, scenes, dev, "nuscenes")[0]]
        nms_phase(torch, model, scenes, dev, "nuscenes", {})
        torch.cuda.empty_cache()
        fp32_phase(torch, cfg, sd, scenes[0], dev, "nuscenes-fp32",
                   every_layer=False)
    torch.backends.cudnn.allow_tf32 = True
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             clustered_train_batch(0, cfg, TRAIN_B).items()}
    if batch["gt_boxes"].shape[-1] != 9:
        fail("nuscenes train batch: boxes without velocity")
    with torch.no_grad():
        report.update(dw_phase(torch, model.train(), batch, dev,
                               "nuscenes-train-kernels", False))
    del model
    torch.cuda.empty_cache()
    total = NUS_WARMUP + NUS_STEPS
    schedules = (cyclic_lr_schedule(NUS_LR, total, NUS_LR_RATIO, NUS_UP),
                 cyclic_momentum_schedule(0.95, total, NUS_MOMENTUM_RATIO,
                                          NUS_UP))
    train_launches, model, opt, _ = train_phase(
        torch, cfg, sd, batch, dev, "nuscenes-train", NUS_WARMUP, NUS_STEPS,
        *schedules)
    checkpoint_phase(torch, model, opt, batch, dev, schedules)
    del model, opt
    torch.cuda.empty_cache()
    launches.append(train_launches)
    launches.append({"fps": fps_path(torch, scenes[0], dev, cfg.num_query)})
    return report, launches


def scannet(torch, dev, preset):
    """Phases 14-18 (``uni3detr_scannet``) or 19-23
    (``uni3detr_scannet_large``); returns (kernel report, launches of the
    inference and train runs)."""
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.presets import PRESETS
    from uni3detr_tpu_torch.synthetic import (clustered_scene,
                                              clustered_train_batch)

    cfg = PRESETS[preset]
    tag = preset.replace("uni3detr_", "")
    model = Uni3DETR(cfg).eval()
    sd = _state_dict(torch, model)
    model.load_state_dict(sd, strict=True)
    model.to(dev)
    scenes = [clustered_scene(seed, cfg) for seed in range(SCANNET_SCENES)]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        report = kernel_phase(torch, model, torch.from_numpy(
            scenes[0][0]).to(dev), dev, f"{tag}-kernels")
        launches = [infer_phase(torch, model, scenes, dev, tag)[0]]
        nms_phase(torch, model, scenes, dev, tag, report)
    torch.cuda.empty_cache()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             clustered_train_batch(0, cfg, TRAIN_B).items()}
    with torch.no_grad():
        report.update(dw_phase(torch, model.train(), batch, dev,
                               f"{tag}-train-kernels", False))
    del model
    torch.cuda.empty_cache()
    launches.append(train_phase(torch, cfg, sd, batch, dev, f"{tag}-train",
                                SCANNET_WARMUP, SCANNET_STEPS, TRAIN_LR)[0])
    torch.cuda.empty_cache()
    return report, launches


def kitti(torch, dev, preset):
    """Phases 24-33 (``uni3detr_kitti_car``) or 34-36
    (``uni3detr_kitti_3classes``); returns (kernel report, launches of
    the inference and train runs)."""
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.presets import PRESETS
    from uni3detr_tpu_torch.synthetic import (clustered_scene,
                                              clustered_scene_gt,
                                              clustered_train_batch)
    from uni3detr_tpu_torch.train.step import step_lr_schedule

    cfg = PRESETS[preset]
    tag = preset.replace("uni3detr_", "")
    car = preset == "uni3detr_kitti_car"
    model = Uni3DETR(cfg).eval()
    sd = _state_dict(torch, model)
    model.load_state_dict(sd, strict=True)
    model.to(dev)
    report, launches = {}, []
    for dist in ("clustered", "uniform") if car else ("uniform",):
        dtag = f"{tag}-{dist}"
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        scenes = [clustered_scene(seed, cfg, dist)
                  for seed in range(KITTI_SCENES)]
        gts = [clustered_scene_gt(seed, cfg, dist)
               for seed in range(KITTI_SCENES)]
        # the realistic shapes (near-isolated voxels) go to the JSON line
        rep = report if dist == "uniform" else None
        with torch.inference_mode():
            if car:
                kernel_phase(torch, model, torch.from_numpy(
                    scenes[0][0]).to(dev), dev, f"{dtag}-kernels")
            run, dets, metric = infer_phase(torch, model, scenes, dev, dtag,
                                            gts=gts)
            launches.append(run)
            merge_phase(torch, model, scenes, dev, dtag, rep)
            eval_phase(torch, cfg, dets, gts, dev, dtag, metric, rep)
            torch.cuda.empty_cache()
            if car:
                fp32_phase(torch, cfg, sd, scenes[0], dev, f"{dtag}-fp32",
                           every_layer=False, min_share=None)
    torch.backends.cudnn.allow_tf32 = True
    if car:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 clustered_train_batch(0, cfg, TRAIN_B, "uniform").items()}
        with torch.no_grad():
            dw_phase(torch, model.train(), batch, dev, f"{tag}-train-kernels",
                     False)
        del model
        torch.cuda.empty_cache()
        total = KITTI_WARMUP + KITTI_STEPS
        schedules = (step_lr_schedule(KITTI_LR, total / KITTI_EPOCHS,
                                      KITTI_MILESTONES), None)
        train_launches, model, opt, _ = train_phase(
            torch, cfg, sd, batch, dev, f"{tag}-train", KITTI_WARMUP,
            KITTI_STEPS, *schedules)
        launches.append(train_launches)
        checkpoint_phase(torch, model, opt, batch, dev, schedules)
        del opt
    del model
    torch.cuda.empty_cache()
    return report, launches


def ov_lift_phase(torch, model, scene, dev, tag):
    """One multimodal scene: the share of the encoder grid's voxels that
    the lift keeps (in front of the camera and inside its frame), which
    must reach OV_MIN_KEPT, and the largest DCN offset of each ResNet
    stage in pixels (random offset convs put the taps between pixels and
    outside the image)."""
    from uni3detr_tpu_torch.models.dcn import DeformConv2dV2
    from uni3detr_tpu_torch.models.view_trans import project_voxels

    offsets = {}

    def hook(name):
        def fn(mod, args, out):     # mod: the offset conv, 3 k*k outputs
            offsets[name] = max(offsets.get(name, 0.0), out.float()[
                :, :2 * mod.out_channels // 3].abs().amax().item())
        return fn

    handles = [m.conv_offset.register_forward_hook(hook(n.split(".")[0]))
               for n, m in model.img_backbone.named_modules()
               if isinstance(m, DeformConv2dV2)]
    batch, rnd = scene_inputs(torch, scene, dev)
    try:
        model(batch, rnd)
    finally:
        for h in handles:
            h.remove()
    cfg = model.cfg
    ref = model.view_trans.reference_voxels(batch["uni_rot_aug"])
    mask = project_voxels(ref, batch["lidar2img"], cfg.img_size,
                          cfg.depth_dim)[2]
    kept = mask.float().mean().item()
    print(f"[{tag}] lift: {mask.shape[-1]} voxels of the encoder grid, "
          f"kept (in front of the camera, inside the frame) {kept:.4f} "
          f"(at least {OV_MIN_KEPT}); largest |DCN offset| in pixels by "
          f"stage {({k: round(v, 3) for k, v in sorted(offsets.items())})}")
    if not kept >= OV_MIN_KEPT:
        fail(f"OV lift keeps {kept} of the voxels (< {OV_MIN_KEPT})")
    if not offsets or min(offsets.values()) <= 0.0:
        fail(f"DCN offsets {offsets}: a DCN stage with zero offsets")


def ov_fp32_phase(torch, base_cfg, sd, scene, dev, tag):
    """Card (kernels, cuDNN) vs CPU (plain versions), fp32, TF32 off, on
    one multimodal scene: voxels and FPS indices equal; the first
    decoder layer's outputs within FP32_ATOL; the lifted per-camera voxel
    features, the image volume and the fused volume within OV_VOLUME_RTOL
    of their largest value. Random weights leave ResNet-50's activations
    unnormalised (to ~1e3) and the depth softmax's logits as large, so
    an ulp of difference at the input moves the volumes by far more than
    FP32_ATOL; a third run, on the card with the image times (1 + 1e-6
    N(0, 1)), prints that floor for the volumes and each decoder layer
    (the later layers are chaotic under random weights, see
    ``fp32_phase``), beside each layer's share within FP32_ATOL."""
    from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(base_cfg, compute_dtype="float32")
    res = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu")),
                         ("card, image perturbed", dev)):
        model = OV_Uni3DETR(cfg).eval()
        model.load_state_dict(sd, strict=True)
        model.to(where)
        batch, rnd = scene_inputs(torch, scene, where)
        if label.endswith("perturbed"):
            gen = torch.Generator(device=where).manual_seed(0)
            img = batch["images"]
            batch["images"] = img * (1 + 1e-6 * torch.randn(
                img.shape, generator=gen, device=where))
        t0 = time.perf_counter()
        outs, inter = model(batch, rnd, return_intermediates=True)
        res[label] = (
            {k: v.cpu() for k, v in outs.items()},
            {k: (tuple(t.cpu() for t in v) if isinstance(v, tuple)
                 else v.cpu()) for k, v in inter.items()},
            time.perf_counter() - t0)
        del model, outs, inter
    (og, ig, tg), (oc, ic, tc) = res["card"], res["cpu"]
    op, ip, _ = res["card, image perturbed"]
    if not (torch.equal(ig["coords"], ic["coords"]) and all(
            torch.equal(a, b) for a, b in zip(ig["fps_idx"], ic["fps_idx"]))):
        fail(f"{tag}: voxels or FPS indices differ between card and cpu")
    names = ("lifted", "image_volume", "fused_volume")
    scale = {k: ic[k].abs().max().item() for k in names}
    vols = {k: (ig[k] - ic[k]).abs().max().item() / scale[k] for k in names}
    floor = {k: (ig[k] - ip[k]).abs().max().item() / scale[k]
             for k in names}

    def per_layer(a, b):
        return {k: [float(f"{(a[k][l] - b[k][l]).abs().max().item():.3g}")
                    for l in range(a[k].shape[0])] for k in a}

    def shares(a, b):
        return [round(min(((a[k][l] - b[k][l]).abs() <= FP32_ATOL).float()
                          .mean().item() for k in a), 6)
                for l in range(a["all_cls_scores"].shape[0])]

    errs = per_layer(og, oc)
    print(f"[{tag}] card vs cpu, max_abs_err / max |cpu| (floor: card vs "
          f"card with the image perturbed by 1e-6 relative): " + ", ".join(
              f"{k} {vols[k]:.3g} ({floor[k]:.3g}; max |cpu| {scale[k]:.4g})"
              for k in names)
          + f" (rtol {OV_VOLUME_RTOL}); per decoder layer max_abs_err "
          f"{errs}, share within {FP32_ATOL} {shares(og, oc)} (floor "
          f"{shares(og, op)}, max_abs_err {per_layer(og, op)}); card "
          f"{tg:.2f}s cpu {tc:.2f}s")
    first = max(v[0] for v in errs.values())
    if max(vols.values()) > OV_VOLUME_RTOL or first > FP32_ATOL:
        fail(f"{tag}: volumes {vols} (of their largest value) or "
             f"first-layer outputs {errs} differ by more than "
             f"{OV_VOLUME_RTOL} / {FP32_ATOL}")


def ov_train(torch, cfg, sd, dev, tag):
    """Phases 44-47 (``_mm``) or 48/49 (``_pc``, ``_rgb``): training on
    ``synthetic.ov_train_batch`` at the config's batch size. mm: the
    train kernels at its shapes (K7/K10 on the step's own features and
    cotangents, K12 on its own costs of all 6 layers, 72 x 64 x 384, K4
    at the batch), train steps under the step schedule with the config's
    multipliers (ri drawn each step, launches by ri, frozen stages
    bit-equal), one fp32 step card vs CPU, a checkpoint round trip. pc
    and rgb: a few steps, launches asserted (rgb: K12 alone). Returns the
    launches of the timed steps."""
    from uni3detr_tpu_torch.presets import OV_SUNRGBD_MM_LR_MULT
    from uni3detr_tpu_torch.synthetic import ov_train_batch
    from uni3detr_tpu_torch.train.step import step_lr_schedule

    mode = tag.split("-")[-1]
    B = OV_TRAIN_B[mode]
    batch_np, share = ov_train_batch(0, cfg, B)
    print(f"[{tag}-train] B={B}: GT boxes kept (centre in the camera's "
          f"frame) {share:.3f}" if cfg.use_camera else
          f"[{tag}-train] B={B}")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    lr_mult = OV_SUNRGBD_MM_LR_MULT if mode == "mm" else None
    if mode == "mm":
        model = build_model(cfg)
        model.load_state_dict(sd, strict=True)
        model.to(dev)
        dw_phase(torch, model, batch, dev, f"{tag}-train-kernels", False,
                 own_cotangents=True)
        del model
        torch.cuda.empty_cache()
        warmup, steps = OV_TRAIN_WARMUP, OV_TRAIN_STEPS
    else:
        warmup, steps = 1, 6
    total = warmup + steps
    schedules = (step_lr_schedule(OV_LR, total / OV_EPOCHS, OV_MILESTONES),
                 None)
    launches, model, opt, gen = train_phase(
        torch, cfg, sd, batch, dev, f"{tag}-train", warmup, steps,
        *schedules, lr_mult=lr_mult, modality_seed=OV_MODALITY_SEED)
    if mode == "mm":
        checkpoint_phase(torch, model, opt, batch, dev, schedules, lr_mult,
                         gen)
    del model, opt, batch
    torch.cuda.empty_cache()
    if mode == "mm":
        train_parity_phase(torch, sd, ov_train_batch(1, cfg, OV_PARITY_B)[0],
                           dev, cfg, OV_PARITY_MODALITY, lr_mult,
                           f"{tag}-fp32-train", OV_PARITY_NORM_RTOL,
                           first_layer=True)
        torch.backends.cudnn.allow_tf32 = True
        torch.cuda.empty_cache()
    return launches


def ov(torch, dev):
    """Phases 37-49: OV-Uni3DETR. ``ov_uni3detr_sunrgbd_mm`` (points and
    one 480x640 image, ResNet-50 + DCNv2, the lift, fusion, the 6-layer
    CLIP head, 46 classes): kernels at its shapes, scenes to boxes with
    the 46-class indoor AP (seen / unseen), NMS at 46 classes, the lift's
    kept share and the DCN offsets, fp32 card vs CPU, then training
    (``ov_train``); then ``ov_uni3detr_sunrgbd_pc`` and
    ``ov_uni3detr_sunrgbd_rgb`` (camera only: no K1-K4) scenes to boxes
    and a few train steps. Returns the launches of the inference and
    train runs."""
    from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR
    from uni3detr_tpu_torch.presets import PRESETS
    from uni3detr_tpu_torch.synthetic import clustered_scene_gt, ov_scene

    launches = []
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    for preset in ("ov_uni3detr_sunrgbd_mm", "ov_uni3detr_sunrgbd_pc",
                   "ov_uni3detr_sunrgbd_rgb"):
        cfg = PRESETS[preset]
        tag = preset.replace("ov_uni3detr_sunrgbd_", "ov-")
        mm = preset.endswith("_mm")
        model = OV_Uni3DETR(cfg).eval()
        sd = _state_dict(torch, model)
        model.load_state_dict(sd, strict=True)
        model.to(dev)
        scenes = [ov_scene(seed, cfg) for seed in range(OV_SCENES)]
        gts = [clustered_scene_gt(seed, cfg) for seed in range(OV_SCENES)]
        with torch.inference_mode():
            if mm:
                kernel_phase(torch, model, torch.from_numpy(
                    scenes[0][0]["points"]).to(dev), dev, f"{tag}-kernels")
            run, dets, metric = infer_phase(torch, model, scenes, dev, tag,
                                            gts=gts if mm else None)
            launches.append(run)
            if mm:
                eval_phase(torch, cfg, dets, gts, dev, tag, metric)
                nms_phase(torch, model, scenes, dev, tag, {})
                ov_lift_phase(torch, model, scenes[0], dev, tag)
        del model
        torch.cuda.empty_cache()
        if mm:
            with torch.inference_mode():
                ov_fp32_phase(torch, cfg, sd, scenes[0], dev, f"{tag}-fp32")
            torch.backends.cudnn.allow_tf32 = True
            torch.cuda.empty_cache()
        launches.append(ov_train(torch, cfg, sd, dev, tag))
    return launches


# -- the evaluation entry point: cli.test from a config and a data root ------
_ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_DIR = os.path.join(_ROOT, "build", "chip_smoke_cli")
SUNRGBD_CONFIG = os.path.join(_ROOT, "configs/uni3detr/uni3detr_sunrgbd.py")
OV_MM_CONFIG = os.path.join(_ROOT,
                            "configs/ov_uni3detr/ov_uni3detr_sunrgbd_mm.py")
CLI_SCENES = 8        # phases 51-52: two batches of the config's 4
CLI_OV_SCENES = 4     # phase 53: one batch of the mm config's 4
CLI_POINTS = 120000   # points a scene on disk, PointSample keeps 100000
TTA_NMS_THR = 0.1     # train/tta.py's merge


def cli_dataset(config, root):
    """(config, model config, val dataset) of ``config`` on ``root``, as
    ``cli.test`` builds them."""
    from uni3detr_tpu_torch.config_file import (build_model_config,
                                                load_config,
                                                merge_cfg_options)
    from uni3detr_tpu_torch.data.datasets import build_dataset

    cfg = merge_cfg_options(load_config(config),
                            [f"data.data_root={root}"])
    mc = build_model_config(cfg)
    return cfg, mc, build_dataset(cfg.data, cfg.class_names, mc.pc_range,
                                  "val")


def collated(torch, ds, mc, start, bs, dev, aug=None):
    """Scenes start .. start + bs of ``ds`` collated as ``run_inference``
    collates them (the tail padded with its last scene; ``aug`` applied
    to the points), the model's inputs on ``dev``; (batch, real)."""
    from uni3detr_tpu_torch.data.datasets import collate_batch
    from uni3detr_tpu_torch.train.evaluator import MODEL_KEYS
    from uni3detr_tpu_torch.train.tta import apply_aug_points

    samples = [ds[i] for i in range(start, min(start + bs, len(ds)))]
    real = len(samples)
    samples += [samples[-1]] * (bs - real)
    if aug is not None:
        samples = [dict(s, points=apply_aug_points(s["points"], aug))
                   for s in samples]
    batch, _ = collate_batch(samples, mc.num_points, mc.max_gt,
                             mc.in_point_features, mc.code_size)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
            if k in MODEL_KEYS}, real


def plain_bev_mask(torch, boxes, labels, thr, rows=500):
    """The plain BEV bitmask of scan-ordered (B, N, 7) boxes on their
    device: the plain BEV IoU in row blocks, thresholded, packed as
    ``ops.nms.overlap_mask_plain`` packs it; (bits, the IoU)."""
    from uni3detr_tpu_torch.geom.iou import iou_bev_rotated
    from uni3detr_tpu_torch.ops import nms

    N = boxes.shape[1]
    iou = torch.cat([iou_bev_rotated(boxes[:, r:r + rows], boxes)
                     for r in range(0, N, rows)], dim=1)
    above = torch.ones((N, N), dtype=torch.bool,
                       device=boxes.device).triu(1)
    same = (labels[..., :, None] == labels[..., None, :]) & \
        (labels[..., :, None] >= 0)
    return nms._pack_bits(above & same & (iou > thr)).transpose(1, 2) \
        .contiguous(), iou


def bev_nms_phase(torch, model, mc, ds, dev, report):
    """Phase 50: the BEV bitmask (N1's BEV form, ``ops.nms.overlap_mask_bev``)
    and N2 on the flagship's own detections of the CLI's first batch
    (B=4) in two views, flip False / True, the second mapped back, as the
    TTA merge sees them (2 x ``max_num`` boxes a scene, 10 classes):

    - the bitmask against the plain BEV IoU thresholded at TTA_NMS_THR,
      differing only on pairs within NMS_IOU_ATOL of it, and N1's BEV
      matrix within NMS_IOU_ATOL of the plain IoU;
    - ``nms_bev_keep`` (one bitmask and one scan launch) equal to
      ``_greedy_suppress_serial`` per class on N1's BEV matrix, every
      scene;
    - kernel (event a call, and device: 50 calls back to back) and plain
      times, and the bound from this
      batch's pairs (every same-class pair above the diagonal is clipped:
      no z test in BEV); added to ``report``.

    Returns the batch's merged detections a scene (the valid rows, the
    keep set cut and ordered by ``tta.select_merged``, then
    ``postprocess_sample``), which phase 52's CLI run must equal: the
    random points are drawn from a generator on the card seeded 0,
    batch 0's view 0 then view 1, as ``run_inference`` draws them."""
    from uni3detr_tpu_torch.geom.iou import iou_bev_rotated_sets
    from uni3detr_tpu_torch.ops import nms
    from uni3detr_tpu_torch.train.coder import decode_predictions, post_process
    from uni3detr_tpu_torch.train.evaluator import forward
    from uni3detr_tpu_torch.eval.postprocess import postprocess_sample
    from uni3detr_tpu_torch.train.tta import (make_aug_grid, map_boxes_back,
                                              select_merged)

    bs = 4
    gen = torch.Generator(device=dev).manual_seed(0)
    views = []
    for aug in make_aug_grid(flips=(False, True)):
        batch, _ = collated(torch, ds, mc, 0, bs, dev, aug)
        rp = torch.rand((bs, mc.num_query, 3), generator=gen, device=dev)
        boxes, scores, labels, valid = post_process(
            *decode_predictions(forward(model, mc, batch, rp), mc), mc)
        views.append((map_boxes_back(boxes, aug), scores, labels, valid))
    boxes, scores, labels, valid = (torch.cat(t, dim=1) for t in zip(*views))
    bx = boxes[..., :7].contiguous()
    B, N = scores.shape
    thr = TTA_NMS_THR
    n1, n2 = nms.overlap_mask_bev.launches, nms.greedy_scan.launches
    keep = nms.nms_bev_keep(bx, scores, labels, valid, thr, mc.num_classes)
    if (nms.overlap_mask_bev.launches - n1, nms.greedy_scan.launches - n2) \
            != (1, 1):
        fail("nms_bev_keep: not one bitmask and one scan launch")
    iou_k = iou_bev_rotated_sets(bx, bx)
    order, lab = nms.nms_order(scores, labels, valid)
    sbx = torch.gather(bx, 1, order[..., None].expand(-1, -1, 7))
    bits = nms.overlap_mask_bev(sbx, lab, thr)
    want_bits, iou_p = plain_bev_mask(torch, sbx, lab, thr)
    err = (iou_bev_rotated_sets(sbx, sbx) - iou_p).abs().max().item()
    differ = nms._unpack_bits((bits ^ want_bits).transpose(1, 2), N)
    near = ((iou_p - thr).abs() <= NMS_IOU_ATOL)
    n_differ, n_far = int(differ.sum()), int((differ & ~near).sum())
    for b in range(B):
        want = serial_per_class(torch, iou_k[b].cpu(), scores[b].cpu(),
                                labels[b].cpu(), valid[b].cpu(), thr)
        if not torch.equal(keep[b].cpu(), want):
            fail(f"nms_bev_keep differs from the serial pass on scene {b}")
    print(f"[bev-nms] B={B} N={N} (2 views x {N // 2}) valid="
          f"{int(valid.sum())} kept={int(keep.sum())}; N1 BEV matrix vs "
          f"plain IoU max_abs_err={err:.3g} (atol {NMS_IOU_ATOL}); bitmask "
          f"bits differing from the plain one: {n_differ}, {n_far} of them "
          f"farther than {NMS_IOU_ATOL} from thr {thr}; keep equal to the "
          f"serial pass per class on N1's matrix: True")
    if not err <= NMS_IOU_ATOL or n_far:
        fail("N1 BEV differs from the plain BEV IoU")
    W = bits.shape[1]
    cand = torch.ones((N, N), dtype=torch.bool, device=dev).triu(1) & \
        (lab[:, :, None] == lab[:, None, :]) & (lab[:, :, None] >= 0)
    n_cand = int(cand.sum())
    bound = iou_roofline(n_cand, n_cand, 32 * B * N + 8 * B * N * W)
    ms = median_ms(torch, lambda: nms.overlap_mask_bev(sbx, lab, thr), 20)
    before = nms.overlap_mask_bev.launches
    dev_ms = back_to_back_ms(
        torch, lambda: nms.overlap_mask_bev(sbx, lab, thr), 50)
    if nms.overlap_mask_bev.launches - before != 51:
        fail("the BEV bitmask's timing: not one launch a call")
    pms = median_ms(torch, lambda: plain_bev_mask(torch, sbx, lab, thr),
                    3, 1)
    print(f"[bev-nms] N1 BEV bitmask B={B} N={N}: ms={ms:.4f} device_ms="
          f"{dev_ms:.4f} (50 calls back to back) bound_ms={bound['bound_ms']:.5f} "
          f"({bound['bound_by']}; {n_cand} same-class pairs above the "
          f"diagonal) plain (row-block IoU + pack) ms={pms:.4f}")
    _report_add(report, "iou_bev_rotated_mask", err, ms, pms, 1, bound)
    report["iou_bev_rotated_mask"]["device_ms"] = dev_ms
    merged = []
    for b in range(B):
        m = valid[b]
        det = {"boxes": boxes[b][m].float().cpu().numpy(),
               "scores": scores[b][m].float().cpu().numpy(),
               "labels": labels[b][m].to(torch.int32).cpu().numpy(),
               "keep": keep[b][m].cpu().numpy()}
        merged.append(postprocess_sample(select_merged(det, 500), mc,
                                         device=dev))
    del cand, iou_k, iou_p, bits, want_bits, differ, near
    torch.cuda.empty_cache()
    return merged


@contextlib.contextmanager
def sync_debug_inference(mode):
    """``train.evaluator.run_inference`` called with ``sync_debug_mode=mode``
    inside the block (``cli.test`` looks it up when it runs)."""
    from uni3detr_tpu_torch.train import evaluator

    run = evaluator.run_inference
    evaluator.run_inference = functools.partial(run, sync_debug_mode=mode)
    try:
        yield
    finally:
        evaluator.run_inference = run


def infer_per_batch(mc):
    """Kernel launches of one eval batch of a Lidar-point model through
    ``run_inference``: the forward's K1-K4, then N1's NMS bitmask and N2,
    with box merging N1's matrix form, with soft-NMS N1's matrix form and
    N3."""
    subm, strided = conv_cases(mc)
    post = {"box_merging": {"iou3d_rotated_matrix": 1},
            "soft_nms": {"iou3d_rotated_matrix": 1, "soft_nms": 1}}.get(
        mc.post_processing, {"iou3d_rotated": 1, "nms_greedy": 1})
    return {"match_positions": len(mc.encoder_channels),
            "gather_conv": sum(c[-1] for c in subm),
            "gather_conv_ids": len(strided), "fps_pair": 1, **post}


def cli_run(torch, tag, config, root, n_scenes, per_batch, ckpt=None,
            tta=False, extra=(), metric_kind="indoor", cfg_options=(),
            out_dir=None):
    """``cli.test CONFIG [CKPT] --cfg-options data.data_root=ROOT
    [cfg_options] --eval bbox --out ROOT/TAG.pkl`` (with ``--tta`` if
    asked, then ``extra``; for a config with no data root, ``root`` None,
    no ``data.data_root`` and the pkl under ``out_dir``) in this process,
    decoding, post-processing and the merge under
    ``torch.cuda.set_sync_debug_mode("error")`` (``run_inference``'s
    ``sync_debug_mode``, set by :func:`sync_debug_inference`): the launches of every kernel wrapper over
    the run asserted (``per_batch`` a batch, N1's two-set form once a
    scene with GT and detections in the indoor metric (``metric_kind``),
    its 3D and BEV forms in ``kitti``, none in ``nuscenes``), every
    detection finite, detections in every scene (but for KITTI's box
    merging, which random weights rarely pass), at most 500 a scene with
    TTA, and ``cli.eval_metric`` on the
    written pkl giving the CLI's metric. Prints scenes/s, the host's load
    and collate ms a scene, the stream ms a batch and the stream share.
    Returns (launches, the CLI's result)."""
    import numpy as np
    from uni3detr_tpu_torch.cli import eval_metric, test as cli_test

    data = [f"data.data_root={root}"] if root else []
    out = os.path.join(out_dir or root, f"{tag}.pkl")
    argv = [config] + ([ckpt] if ckpt else []) + [
        "--cfg-options", *data, *cfg_options, "--eval",
        "bbox", "--out", out] + (["--tta"] if tta else []) + list(extra)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    with sync_debug_inference("error"):
        r = cli_test.main(argv)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    dets, gts, stats = r["dets"], r["gts"], r["stats"]
    n_batches = stats["batches"]
    want = dict.fromkeys(wrappers, 0)
    for k, v in per_batch.items():
        want[k] = v * n_batches
    n_eval = sum(bool(len(g["boxes"]) and len(d["boxes"]))
                 for g, d in zip(gts, dets))
    want["iou3d_rotated_sets"] = n_eval if metric_kind != "nuscenes" else 0
    want["iou_bev_rotated_sets"] = n_eval if metric_kind == "kitti" else 0
    print(f"[{tag}] launches={launches} expected={want}")
    if launches != want:
        fail(f"{tag}: kernel launch counts {launches} != {want}")
    if len(dets) != n_scenes:
        fail(f"{tag}: {len(dets)} detections for {n_scenes} scenes")
    counts = [len(d["scores"]) for d in dets]
    if not all(np.isfinite(d["boxes"]).all() and np.isfinite(
            d["scores"]).all() for d in dets) or not (
            all(counts) or metric_kind == "kitti") or (
            tta and max(counts) > 500):
        fail(f"{tag}: non-finite detections or counts {counts}")
    metric = eval_metric.main([config, out, "--cfg-options", *data])
    if not same_metric(metric, r["metrics"]):
        fail(f"{tag}: cli.eval_metric {metric} != cli.test {r['metrics']}")
    wall, stream = stats["wall_s"], stats["stream_ms"]
    print(f"[{tag}] {n_scenes} scenes, {n_batches} batches: "
          f"{n_scenes / wall:.3f} scenes/s ({wall:.3f} s), host load + "
          f"collate {sum(stats['load_ms']) / n_scenes:.3f} ms a scene, "
          f"stream ms a batch {[round(s, 3) for s in stream]}, stream "
          f"share {sum(stream) / 1e3 / wall:.3f}; detections a scene "
          f"{counts}; "
          f"{_metric_summary(r['metrics'])}; cli.eval_metric equal")
    return launches, r


def same_metric(a, b):
    """Two metric dicts equal key by key (NaN equal to NaN)."""
    return a.keys() == b.keys() and all(
        a[k] == v or (math.isnan(a[k]) and math.isnan(v))
        for k, v in b.items())


def same_dets(tag, got, want, what):
    """Fail unless the detections ``got`` equal ``want`` scene by scene,
    bit for bit."""
    import numpy as np

    for i, (a, b) in enumerate(zip(got, want)):
        for k in ("boxes", "scores", "labels"):
            if not np.array_equal(a[k], b[k]):
                fail(f"{tag} scene {i} {k} differs from {what}")
    print(f"[{tag}] the detections of {len(want)} scenes equal {what}")


def cli_direct_check(torch, model, mc, ds, dev, dets):
    """The CLI's detections (phase 51) against a direct model + coder call
    (the model, ``train.coder``, ``eval.postprocess.postprocess_batch``)
    on the same collated batches with the same random points (a
    generator on the card seeded 0, one draw a batch): equal."""
    from uni3detr_tpu_torch.eval.postprocess import postprocess_batch
    from uni3detr_tpu_torch.train.coder import decode_predictions, post_process
    from uni3detr_tpu_torch.train.evaluator import forward

    bs = 4
    gen = torch.Generator(device=dev).manual_seed(0)
    direct = []
    with torch.inference_mode():
        for start in range(0, len(dets), bs):
            batch, real = collated(torch, ds, mc, start, bs, dev)
            rp = torch.rand((bs, mc.num_query, 3), generator=gen,
                            device=dev)
            out = post_process(*decode_predictions(
                forward(model, mc, batch, rp), mc), mc)
            direct += postprocess_batch(*out, mc)[:real]
    if len(direct) != len(dets):
        fail(f"cli: {len(dets)} detections, {len(direct)} direct")
    same_dets("cli", dets, direct, "the direct model + coder call's on "
              "the same batches and random points")


def cli(torch, dev):
    """Phases 50-53: the evaluation entry point on the card. A SUN RGB-D
    data root of CLI_SCENES scenes and a seed-0 checkpoint of
    ``uni3detr_sunrgbd``; phase 50 the BEV bitmask on the flagship's own
    two-view detections; 51 ``cli.test`` on ``uni3detr_sunrgbd.py`` (two
    batches of 4) held to a direct model + coder call; 52 the same with
    ``--tta`` (flips: two forwards a batch, then the BEV bitmask and N2
    once a batch); 53 ``ov_uni3detr_sunrgbd_mm.py`` on a root with images
    and calib (one batch of 4: LoadImageFromFile, NormalizeImage and
    PadImage on the path; the metric's seen / unseen split). Returns
    (kernel report, the launches of the three CLI runs)."""
    from uni3detr_tpu_torch.cli import test as cli_test
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.presets import PRESETS, SUNRGBD
    from uni3detr_tpu_torch.synthetic import write_sunrgbd_root
    from uni3detr_tpu_torch.train.checkpoint import save_checkpoint

    from uni3detr_tpu_torch.config_file import load_config

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    root, ov_root = (os.path.join(CLI_DIR, d) for d in ("sunrgbd", "ov"))
    t0 = time.perf_counter()
    write_sunrgbd_root(root, SUNRGBD, load_config(SUNRGBD_CONFIG).class_names,
                       CLI_SCENES, num_points=CLI_POINTS)
    ckpt = os.path.join(CLI_DIR, "checkpoint")
    model = Uni3DETR(SUNRGBD)
    model.load_state_dict(_state_dict(torch, model), strict=True)
    save_checkpoint(ckpt, model)
    print(f"[cli] wrote {CLI_SCENES} scenes of {CLI_POINTS} points and a "
          f"seed-0 checkpoint under {CLI_DIR} "
          f"({time.perf_counter() - t0:.2f}s)")
    cfg, mc, ds = cli_dataset(SUNRGBD_CONFIG, root)
    model = cli_test.build_model(mc, ckpt, dev)
    report = {}
    with torch.inference_mode():
        merged = bev_nms_phase(torch, model, mc, ds, dev, report)
    per_batch = infer_per_batch(mc)
    runs = []
    run, r = cli_run(torch, "cli", SUNRGBD_CONFIG, root, CLI_SCENES,
                     per_batch, ckpt)
    runs.append(run)
    cli_direct_check(torch, model, mc, ds, dev, r["dets"])
    del model
    tta = {k: 2 * v for k, v in per_batch.items()}
    tta.update(iou_bev_rotated_mask=1, nms_greedy=3)
    run, r = cli_run(torch, "cli-tta", SUNRGBD_CONFIG, root, CLI_SCENES,
                     tta, ckpt, tta=True)
    runs.append(run)
    same_dets("cli-tta", r["dets"][:len(merged)], merged,
              "phase 50's merge of the first batch's two views")
    write_sunrgbd_root(ov_root, PRESETS["ov_uni3detr_sunrgbd_mm"],
                       load_config(OV_MM_CONFIG).class_names, CLI_OV_SCENES,
                       camera=True, num_points=CLI_POINTS)
    run, r = cli_run(torch, "cli-ov-mm", OV_MM_CONFIG, ov_root,
                     CLI_OV_SCENES, per_batch)
    runs.append(run)
    if not any("seen" in k for k in r["metrics"]):
        fail(f"cli-ov-mm: no seen / unseen split in {sorted(r['metrics'])}")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return report, runs


# -- the train entry point: cli.train from a config and a data root ----------
TRAIN_CLI_DIR = os.path.join(_ROOT, "build", "chip_smoke_train_cli")
KITTI_CAR_CONFIG = os.path.join(_ROOT, "configs/uni3detr/uni3detr_kitti_car.py")
OV_PC_CONFIG = os.path.join(_ROOT, "configs/ov_uni3detr/ov_uni3detr_sunrgbd_pc.py")
OV_RGB_CONFIG = os.path.join(_ROOT,
                             "configs/ov_uni3detr/ov_uni3detr_sunrgbd_rgb.py")
TRAIN_CLI_SCENES, TRAIN_CLI_VAL = 8, 4   # phase 54: x2 repeat, B=4, 4 steps
# phase 54's options: two epochs, an eval after each on 4 val scenes, a
# log line (the losses on the host) every step
TRAIN_CLI_OPTS = ["total_epochs=2", "evaluation.interval=1",
                  "evaluation.max_samples=4", "log_config.interval=1"]
KITTI_CLI_SCENES, KITTI_CLI_STEPS, KITTI_CLI_GT = 4, 3, 3   # phase 57
OV_CLI_SCENES = 8     # phase 58: one batch of the pc config's 8


class CliWatch:
    """One ``cli.train`` run watched from inside this process: replaces
    ``train.step.train_step`` and ``train.evaluator.run_inference`` /
    ``evaluate``, which the CLI looks up when it runs. Each step's kernel
    launches must be ``train_per_step(cfg, ri)`` (ri: the OV modality
    draw), each eval's (``run_inference`` through ``evaluate``) those of
    ``infer_per_batch`` a batch and N1's two-set form once a scene with
    GT and detections in the indoor metric. Records the first step's
    batch, model state and generator states (and calls ``on_first(model,
    opt)`` there), per step the step count before it, ri, its lr and,
    with ``gt_counts``, the batch's GT boxes a sample (a host sync)."""

    def __init__(self, torch, cfg, tag, on_first=None, gt_counts=False):
        self.torch, self.cfg, self.tag = torch, cfg, tag
        self.on_first, self.gt_counts = on_first, gt_counts
        self.steps, self.evals, self.first = [], [], None
        self.model = self.opt = None

    def _counts(self):
        return {k: fn.launches for k, fn in self.counters.items()}

    def _delta(self, before):
        return {k: fn.launches - before[k] for k, fn in self.counters.items()}

    def __enter__(self):
        from uni3detr_tpu_torch.train import evaluator, step

        torch = self.torch
        self.counters = kernel_wrappers()
        self.saved = (step.train_step, evaluator.run_inference,
                      evaluator.evaluate)
        real_step, real_run, real_eval = self.saved
        mm = is_ov(self.cfg) and self.cfg.use_lidar and self.cfg.use_camera

        def train_step(model, opt, batch, **kw):
            if self.first is None:
                self.first = dict(
                    batch={k: v.clone() for k, v in batch.items()},
                    state={k: v.detach().clone()
                           for k, v in model.state_dict().items()},
                    rng=(torch.get_rng_state(), torch.cuda.get_rng_state()),
                    step=opt.steps)
                if self.on_first is not None:
                    self.on_first(model, opt)
            self.model, self.opt = model, opt
            before, step_before = self._counts(), opt.steps
            logs = real_step(model, opt, batch, **kw)
            if "loss" not in self.first:
                self.first["loss"] = float(logs["total_loss"])
            ri = model.last_modality if mm else None
            got, want = self._delta(before), train_per_step(self.cfg, ri)
            if got != want:
                fail(f"{self.tag} step {step_before} (ri {ri}): launches "
                     f"{got} != {want}")
            group = opt.adamw.param_groups[0]
            rec = dict(step=step_before, ri=ri, launches=got,
                       lr=group["lr"] / group["lr_mult"])
            if self.gt_counts:
                rec["gt"] = batch["gt_mask"].sum(1).tolist()
            self.steps.append(rec)
            return logs

        def run_inference(*args, **kw):
            self.eval_before = self._counts()
            self.eval_stats = kw.setdefault("stats", {})
            return real_run(*args, **kw)

        def evaluate(dets, gts, *args, **kw):
            res = real_eval(dets, gts, *args, **kw)
            got = self._delta(self.eval_before)
            want = dict.fromkeys(self.counters, 0)
            for k, v in infer_per_batch(self.cfg).items():
                want[k] = v * self.eval_stats["batches"]
            want["iou3d_rotated_sets"] = sum(
                bool(len(g["boxes"]) and len(d["boxes"]))
                for g, d in zip(gts, dets))
            if got != want:
                fail(f"{self.tag} eval {len(self.evals)}: launches {got} != "
                     f"{want}")
            self.evals.append(got)
            return res

        step.train_step = train_step
        evaluator.run_inference = run_inference
        evaluator.evaluate = evaluate
        return self

    def __exit__(self, *exc):
        from uni3detr_tpu_torch.train import evaluator, step
        step.train_step, evaluator.run_inference, evaluator.evaluate = \
            self.saved

    def launches(self):
        """The run's launches, its steps and evals summed."""
        total = dict.fromkeys(self.counters, 0)
        for d in [s["launches"] for s in self.steps] + self.evals:
            for k, v in d.items():
                total[k] += v
        return total


def train_cli_run(torch, tag, config, root, argv, cfg, **watch):
    """``cli.train CONFIG --cfg-options data.data_root=ROOT ...`` in this
    process under a :class:`CliWatch`; prints the run's steps, evals,
    host ms/step between log lines of one epoch and the loader's ms a
    batch. Returns (the CLI's result, the watch)."""
    from uni3detr_tpu_torch.cli import train as cli_train

    t0 = time.perf_counter()
    full = [config] + argv[:argv.index("--cfg-options") + 1] \
        + [f"data.data_root={root}"] + argv[argv.index("--cfg-options") + 1:]
    with CliWatch(torch, cfg, tag, **watch) as w:
        r = cli_train.main(full)
    torch.cuda.synchronize()
    log_s = r["stats"]["log_s"]
    gaps = [(b[2] - a[2]) * 1e3 for a, b in zip(log_s, log_s[1:])
            if a[0] == b[0]]
    load = r["stats"]["load_ms"]
    print(f"[{tag}] {len(w.steps)} steps (first at step {w.steps[0]['step']}"
          f"), {len(w.evals)} evals, {time.perf_counter() - t0:.2f}s; host "
          f"ms/step after the first (between log lines, synchronised by the "
          f"loss read) "
          + (f"median {statistics.median(gaps):.3f} min {min(gaps):.3f} max "
             f"{max(gaps):.3f} over {len(gaps)}" if gaps else "none")
          + f"; loader (load + augment + collate + pin) ms a batch median "
            f"{statistics.median(load):.3f} over {len(load)}; launches "
            f"{w.launches()}")
    return r, w


def train_log_check(tag, work_dir, epochs):
    """``train.log``: finite losses on every step line and an eval line
    for each of ``epochs``."""
    with open(os.path.join(work_dir, "train.log")) as f:
        text = f.read()
    totals = [float(t) for t in re.findall(r"\| total (\S+) ", text)]
    if not totals or not all(math.isfinite(t) for t in totals):
        fail(f"{tag}: losses in train.log {totals}")
    for e in epochs:
        if f"eval epoch {e} | " not in text:
            fail(f"{tag}: no 'eval epoch {e}' line in train.log")
    print(f"[{tag}] train.log: {len(totals)} finite losses "
          f"({totals[0]:.4f} .. {totals[-1]:.4f}), eval lines for epochs "
          f"{list(epochs)}")


def checkpoints_check(tag, work_dir, names, classes):
    """Each checkpoint directory of ``names`` with ``meta.json`` naming
    ``classes``; returns the metas."""
    metas = {}
    for name in names:
        path = os.path.join(work_dir, name, "meta.json")
        if not os.path.exists(path):
            fail(f"{tag}: no {name}/meta.json")
        with open(path) as f:
            metas[name] = json.load(f)
        if metas[name]["classes"] != list(classes):
            fail(f"{tag}: {name} classes {metas[name]['classes']}")
    print(f"[{tag}] checkpoints " + ", ".join(
        f"{n} (epoch {m['epoch']}, step {m['step']})"
        for n, m in metas.items()) + " with the config's classes")
    return metas


def first_step_check(torch, cfg, mc, watch, dev, steps_per_epoch):
    """The CLI's first weights those of ``weights.init_state_dict`` of the
    config's seed; its first step against a direct ``train_step`` on the
    same collated batch, initial weights and generator states: losses
    within CKPT_LOSS_RTOL (the card's atomics may order sums
    differently)."""
    from uni3detr_tpu_torch.cli import train as cli_train
    from uni3detr_tpu_torch.train.step import train_step
    from uni3detr_tpu_torch.weights import init_state_dict

    model = build_model(mc)
    want = init_state_dict(model, cfg.get("seed", 0))
    for k, v in watch.first["state"].items():
        if not torch.equal(v.cpu(), torch.from_numpy(want[k])):
            fail(f"{watch.tag}: the CLI's first weights differ from "
                 f"init_state_dict at {k}")
    model.to(dev)
    model.load_state_dict(watch.first["state"], strict=True)
    opt = cli_train.build_optimizer(cfg, model, steps_per_epoch)
    torch.set_rng_state(watch.first["rng"][0])
    torch.cuda.set_rng_state(watch.first["rng"][1])
    logs = train_step(model, opt, watch.first["batch"])
    direct, cli_loss = float(logs["total_loss"]), watch.first["loss"]
    rel = abs(direct - cli_loss) / max(abs(direct), 1e-6)
    print(f"[{watch.tag}] first step total_loss: CLI {cli_loss:.6f}, direct "
          f"train_step on the recorded batch, weights and generator states "
          f"{direct:.6f}, relative {rel:.3g} (rtol {CKPT_LOSS_RTOL})")
    if not rel <= CKPT_LOSS_RTOL:
        fail(f"{watch.tag}: the CLI's first loss {cli_loss} vs direct "
             f"{direct}")
    del model, opt




def lr_mult_check(tag, model, opt, lr_mult):
    """Every trainable parameter in the optimizer group of the first
    ``lr_mult`` prefix of its name (else 1), the frozen ones in none."""
    group_of = {id(p): g["lr_mult"] for g in opt.adamw.param_groups
                for p in g["params"]}
    n_frozen = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            n_frozen += 1
            if id(p) in group_of:
                fail(f"{tag}: frozen {name} in the optimizer")
            continue
        want = next((m for pre, m in lr_mult.items()
                     if name == pre or name.startswith(pre + ".")), 1.0)
        if group_of.get(id(p)) != want:
            fail(f"{tag}: {name} in group {group_of.get(id(p))} != {want}")
    mults = sorted({g["lr_mult"] for g in opt.adamw.param_groups})
    print(f"[{tag}] lr multipliers {mults} as the config's lr_mult by "
          f"prefix; {n_frozen} frozen tensors out of the optimizer")


def train_cli(torch, dev):
    """Phases 54-58: the train entry point on the card, on data roots
    written under ``build/``. 54 ``uni3detr_sunrgbd.py`` (8 train scenes
    x ``repeat=2`` at B=4, two epochs, an eval after each); 55 a resume
    from its ``epoch_1``; 56 ``cli.test`` on its ``latest`` against its
    last eval; 57 ``uni3detr_kitti_car.py`` (ObjectSample on a GT
    database, ObjectNoise, the LiDAR flip); 58 ``ov_uni3detr_sunrgbd_pc``
    and ``_rgb`` one step each, then ``_mm`` staged from their
    ``latest``. Returns the launches of every run."""
    import numpy as np
    from uni3detr_tpu_torch import native
    from uni3detr_tpu_torch.cli import train as cli_train
    from uni3detr_tpu_torch.config_file import (build_model_config,
                                                load_config,
                                                merge_cfg_options)
    from uni3detr_tpu_torch.data.datasets import build_dataset
    from uni3detr_tpu_torch.presets import PRESETS, SUNRGBD
    from uni3detr_tpu_torch.synthetic import (write_kitti_root,
                                              write_sunrgbd_root)
    from uni3detr_tpu_torch.train.checkpoint import load_checkpoint

    def config(path, root, opts=()):
        cfg = merge_cfg_options(load_config(path),
                                [f"data.data_root={root}", *opts])
        return cfg, build_model_config(cfg)

    shutil.rmtree(TRAIN_CLI_DIR, ignore_errors=True)
    runs = []
    # -- 54: the flagship config, two epochs with an eval after each
    root = os.path.join(TRAIN_CLI_DIR, "sunrgbd")
    t0 = time.perf_counter()
    classes = load_config(SUNRGBD_CONFIG).class_names
    write_sunrgbd_root(root, SUNRGBD, classes, TRAIN_CLI_SCENES,
                       num_points=CLI_POINTS, split="train")
    write_sunrgbd_root(root, SUNRGBD, classes, TRAIN_CLI_VAL,
                       num_points=CLI_POINTS)
    print(f"[train-cli] wrote {TRAIN_CLI_SCENES} train and {TRAIN_CLI_VAL} "
          f"val scenes of {CLI_POINTS} points under {root} "
          f"({time.perf_counter() - t0:.2f}s)")
    cfg, mc = config(SUNRGBD_CONFIG, root, TRAIN_CLI_OPTS)
    spe = TRAIN_CLI_SCENES * cfg.data["repeat"] // cfg.data["samples_per_gpu"]
    wd = os.path.join(TRAIN_CLI_DIR, "flagship")
    torch.cuda.synchronize(dev)     # initialises CUDA in a partial run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    r, w = train_cli_run(torch, "train-cli", SUNRGBD_CONFIG, root,
                         ["--work-dir", wd, "--cfg-options",
                          *TRAIN_CLI_OPTS], mc)
    peak = torch.cuda.max_memory_allocated(dev)
    runs.append(w.launches())
    if len(w.steps) != 2 * spe or len(w.evals) != 2 or sorted(
            r["evals"]) != [1, 2]:
        fail(f"train-cli: {len(w.steps)} steps, evals {sorted(r['evals'])}")
    train_log_check("train-cli", wd, (1, 2))
    checkpoints_check("train-cli", wd, ("epoch_1", "epoch_2", "latest"),
                      classes)
    direct_ms, direct_peak = DIRECT_TRAIN["train"]
    print(f"[train-cli] peak_mem_bytes={peak} over the run (phase 7, direct "
          f"steps at B=4 on one batch: {direct_peak}); phase 7's direct "
          f"ms/step median {direct_ms:.3f}; eval epoch 2 "
          f"{_metric_summary(r['evals'][2])}")
    first_step_check(torch, cfg, mc, w, dev, spe)
    del w
    torch.cuda.empty_cache()

    # -- 55: resume from epoch_1 at its step, optimizer state as stored
    ckpt = os.path.join(wd, "epoch_1")
    tree, meta = load_checkpoint(ckpt)

    def resumed(model, opt):
        if opt.steps != tree["step"] or meta["epoch"] != 1:
            fail(f"train-cli-resume: step {opt.steps} != {tree['step']}")
        for k, v in model.state_dict().items():
            if not torch.equal(v.cpu(), tree["model"][k]):
                fail(f"train-cli-resume: {k} differs from the checkpoint")
        state = opt.adamw.state_dict()["state"]
        for i, st in tree["optimizer"]["adamw"]["state"].items():
            for k, v in st.items():
                if not torch.equal(state[i][k].cpu(), v):
                    fail(f"train-cli-resume: optimizer {i}.{k} differs")
        print(f"[train-cli-resume] at the first resumed step: model and "
              f"{len(state)} parameters' AdamW state equal to {ckpt}'s, "
              f"step {opt.steps}")

    r2, w2 = train_cli_run(
        torch, "train-cli-resume", SUNRGBD_CONFIG, root,
        ["--work-dir", os.path.join(TRAIN_CLI_DIR, "resumed"),
         "--resume-from", ckpt, "--cfg-options", *TRAIN_CLI_OPTS], mc,
        on_first=resumed)
    runs.append(w2.launches())
    sched = cli_train.build_schedules(cfg, spe)[0]
    lr0 = w2.steps[0]["lr"]
    print(f"[train-cli-resume] started at epoch {meta['epoch']}, step "
          f"{w2.steps[0]['step']} (stored {meta['step']}); lr at the first "
          f"resumed step {lr0} (schedule {sched(meta['step'])}); "
          f"{len(w2.steps)} steps, evals {sorted(r2['evals'])}")
    if (w2.steps[0]["step"], len(w2.steps), sorted(r2["evals"])) != (
            spe, spe, [2]) or lr0 != sched(meta["step"]):
        fail("train-cli-resume: wrong start, steps, evals or lr")
    del w2, tree
    torch.cuda.empty_cache()

    # -- 56: cli.test on phase 54's latest = phase 54's last eval
    run, rt = cli_run(torch, "train-cli-test", SUNRGBD_CONFIG, root,
                      TRAIN_CLI_VAL, infer_per_batch(mc),
                      os.path.join(wd, "latest"),
                      extra=("--batch-size", "4", "--max-samples", "4"))
    runs.append(run)
    if not same_metric(rt["metrics"], r["evals"][2]):
        fail(f"train-cli-test: {rt['metrics']} != the eval hook's "
             f"{r['evals'][2]}")
    print("[train-cli-test] cli.test's metric on latest equals the eval "
          "hook's at epoch 2")

    # -- 57: KITTI car: ObjectSample, ObjectNoise, the LiDAR flip
    kroot = os.path.join(TRAIN_CLI_DIR, "kitti")
    kmc0 = PRESETS["uni3detr_kitti_car"]
    write_kitti_root(kroot, kmc0, KITTI_CLI_SCENES, 1, n_gt=KITTI_CLI_GT)
    built_before = any(native.BUILD_DIR.glob("_data_ops_*.so"))
    t0 = time.perf_counter()
    native.library()
    print(f"[train-cli-kitti] native data ops (g++) loaded at first use in "
          f"{time.perf_counter() - t0:.3f}s from {native.build()} "
          f"({'a library was there' if built_before else 'built now'})")
    kcfg, kmc = config(KITTI_CAR_CONFIG, kroot)
    flip = dict(kcfg.data, train_pipeline=[
        dict(type="RandomFlip3D", flip_ratio_bev_horizontal=1.0),
        dict(type="PointsRangeFilter")])
    fds = build_dataset(flip, kcfg.class_names, kmc.pc_range, "train",
                        sample_rng=lambda i: np.random.default_rng(0))
    raw, s = fds.load_sample(0), fds[0]
    if len(s["points"]) != len(raw["points"]) or not np.array_equal(
            s["points"][:, 1], -raw["points"][:, 1]):
        fail("train-cli-kitti: the forced horizontal flip lost points or "
             "did not flip y")
    print(f"[train-cli-kitti] box frame {fds.pipeline.transforms[0].box_type}"
          f": a forced horizontal flip of a seeded sample keeps all "
          f"{len(raw['points'])} points in pc_range (y negated)")
    ds = build_dataset(kcfg.data, kcfg.class_names, kmc.pc_range, "train",
                       sample_rng=lambda i: np.random.default_rng(i))
    tr = {type(t).__name__: t for t in ds.pipeline.transforms}
    t_os, t_on, gts = [], [], []
    for i in range(len(ds)):
        sample, rng = ds.load_sample(i), np.random.default_rng(i)
        t0 = time.perf_counter()
        sample = tr["ObjectSample"](sample, rng)
        t1 = time.perf_counter()
        sample = tr["ObjectNoise"](sample, rng)
        t_on.append((time.perf_counter() - t1) * 1e3)
        t_os.append((t1 - t0) * 1e3)
        gts.append(len(sample["gt_boxes"]))
    print(f"[train-cli-kitti] host ms a sample over {len(ds)} samples of "
          f"{len(raw['points'])} points: ObjectSample {statistics.mean(t_os):.3f}"
          f" (median {statistics.median(t_os):.3f}), ObjectNoise "
          f"{statistics.mean(t_on):.3f} (median {statistics.median(t_on):.3f})"
          f"; GT boxes after the paste {gts} (scene {KITTI_CLI_GT})")
    r, w = train_cli_run(torch, "train-cli-kitti", KITTI_CAR_CONFIG, kroot,
                         ["--work-dir", os.path.join(TRAIN_CLI_DIR, "kwd"),
                          "--max-steps", str(KITTI_CLI_STEPS),
                          "--cfg-options", "log_config.interval=1"], kmc,
                         gt_counts=True)
    runs.append(w.launches())
    pasted = [g for st in w.steps for g in st["gt"]]
    print(f"[train-cli-kitti] GT boxes a sample in the CLI's batches "
          f"{pasted} (each scene has {KITTI_CLI_GT})")
    if len(w.steps) != KITTI_CLI_STEPS or not all(
            g > KITTI_CLI_GT for g in pasted):
        fail("train-cli-kitti: wrong step count or no paste")
    del w
    torch.cuda.empty_cache()

    # -- 58: OV pc and rgb one step each, then mm staged from them
    oroot = os.path.join(TRAIN_CLI_DIR, "ov")
    mm0 = PRESETS["ov_uni3detr_sunrgbd_mm"]
    ov_classes = load_config(OV_PC_CONFIG).class_names
    write_sunrgbd_root(oroot, mm0, ov_classes, OV_CLI_SCENES, camera=True,
                       num_points=CLI_POINTS, split="train")
    write_sunrgbd_root(oroot, mm0, ov_classes, 2, camera=True,
                       num_points=CLI_POINTS)
    latest = {}
    for mode, path in (("pc", OV_PC_CONFIG), ("rgb", OV_RGB_CONFIG)):
        owd = os.path.join(TRAIN_CLI_DIR, f"ov_{mode}")
        _, omc = config(path, oroot)
        r, w = train_cli_run(torch, f"train-cli-ov-{mode}", path, oroot,
                             ["--work-dir", owd, "--max-steps", "1",
                              "--cfg-options"], omc)
        runs.append(w.launches())
        if len(w.steps) != 1:
            fail(f"train-cli-ov-{mode}: {len(w.steps)} steps")
        latest[mode] = os.path.join(owd, "latest")
        del w
        torch.cuda.empty_cache()
    opts = [f"pretrained_pts={latest['pc']}",
            f"pretrained_img={latest['rgb']}"]
    mcfg, mmc = config(OV_MM_CONFIG, oroot, opts)
    sources = [(mcfg.load_pts, load_checkpoint(latest["pc"])[0]["model"]),
               (mcfg.load_img, load_checkpoint(latest["rgb"])[0]["model"])]
    counted = {}

    def staged(model, opt):
        sd = model.state_dict()
        for prefixes, src in sources:
            for pre in prefixes:
                keys = [k for k in sd if k.startswith(pre) and k in src
                        and src[k].shape == sd[k].shape]
                for k in keys:
                    if not torch.equal(sd[k].cpu(), src[k]):
                        fail(f"train-cli-ov-mm: {k} differs from its source")
                counted[pre] = len(keys)
        lr_mult_check("train-cli-ov-mm", model, opt, dict(mcfg.lr_mult))

    r, w = train_cli_run(torch, "train-cli-ov-mm", OV_MM_CONFIG, oroot,
                         ["--work-dir", os.path.join(TRAIN_CLI_DIR, "ov_mm"),
                          "--max-steps", "2", "--cfg-options", *opts], mmc,
                         on_first=staged)
    runs.append(w.launches())
    frozen = [n for n, p in w.model.named_parameters() if not p.requires_grad]
    moved = [n for n in frozen if not torch.equal(
        dict(w.model.named_parameters())[n], w.first["state"][n])]
    print(f"[train-cli-ov-mm] staged tensors by prefix {r['staged']} (equal "
          f"to their sources at the first step: {counted}); ri by step "
          f"{[st['ri'] for st in w.steps]}; frozen ResNet tensors "
          f"{len(frozen)}, bit-equal after {len(w.steps)} steps: "
          f"{not moved}")
    if r["staged"] != counted or not all(counted.values()) or moved \
            or not frozen or len(w.steps) != 2:
        fail("train-cli-ov-mm: staged loading, frozen stages or steps")
    del w
    shutil.rmtree(TRAIN_CLI_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return runs


DDP_DIR = os.path.join(_ROOT, "build", "chip_smoke_ddp")
DDP_RANKS = 2         # phases 60-61: two ranks share the one card (gloo)
DDP_B = 4             # phase 60: the global batch, 2 scenes a rank
DDP_TIMED = 3         # phase 60: timed steps a rank, and again with the
                      # all-reduce timed
DDP_SCENES = 8        # phases 59-60: train and val scenes of the root
# phase 60's loss tolerance: tests/test_parallel.py's DP rtol 1e-5, or
# twice the spread of two identical one-process runs on one matching
# measured in the phase where that is larger (two card runs need not
# agree bit for bit), never looser than 1e-4
DDP_LOSS_RTOL = (1e-5, 1e-4)
DDP_BATCH_SEED = 2    # phase 60's batch: clustered_train_batch's seed
# phase 60's grad-norm tolerance: twice the spread of two one-process
# runs, at least JAX's DP tolerance (the reduction order alone,
# tests/test_parallel.py), never looser than 1e-2
DDP_GNORM_RTOL = (1e-3, 1e-2)
DDP_TIMEOUT = 600     # seconds a group of ranks may take


def free_port():
    """A free TCP port on this host's loopback."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def scene_points(scenes, view, nq=None):
    """A batch's random query group keyed by its scenes' dataset indices
    (scene i's points from ``RandomState(1000 + i)``, a view apart by
    ``7919 * view``): the same draws for any number of ranks."""
    import numpy as np
    from uni3detr_tpu_torch.presets import SUNRGBD
    nq = nq or SUNRGBD.num_query
    return np.stack([np.random.RandomState(1000 + i + 7919 * view)
                     .uniform(size=(nq, 3)).astype(np.float32)
                     for i in scenes])


def ddp_step_rank(cfg, sd, batch_np, assigned, config, root, timed,
                  device="cuda"):
    """Phase 60, one rank (in the process group): the step of ``cfg``
    (fp32) on this rank's slice of ``batch_np`` (TF32 off), its launches,
    its loss taking this rank's slice of ``assigned`` (one process's
    matching of the global batch, (L, B, Q): ``pinned_matching``);
    ``timed`` steps timed, then ``timed`` with each
    ``torch.distributed.all_reduce`` timed between two synchronisations;
    then ``run_inference_distributed`` at B=1 on the val split of
    ``root`` (``config``'s model, seed-0 weights) with ``scene_points``,
    and on rank 0 ``run_inference`` over the whole split with the same
    draws; last the first step again from ``sd`` (the matching pinned
    likewise) with a planted fault, each rank's own BN statistics
    (``dist.batch_sum`` the identity).
    ``device="cpu"`` runs it on the CPU (a rehearsal). Returns host
    objects."""
    import numpy as np
    import torch
    import torch.distributed as tdist
    from uni3detr_tpu_torch.cli.test import build_model as cli_model
    from uni3detr_tpu_torch.config_file import (build_model_config,
                                                load_config,
                                                merge_cfg_options)
    from uni3detr_tpu_torch.data.datasets import build_dataset
    from uni3detr_tpu_torch.ops import launch_counts
    from uni3detr_tpu_torch.parallel import dist
    from uni3detr_tpu_torch.train import evaluator
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = device == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    model = build_model(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.to(dev)
    opt = make_optimizer(model, TRAIN_LR)
    sl = dist.local_slice(len(batch_np["points"]))
    batch = {k: torch.from_numpy(v[sl]).to(dev) for k, v in batch_np.items()}
    mine = torch.from_numpy(assigned[:, sl])
    out = {"rank": dist.rank(), "backend": tdist.get_backend(),
           "device": str(dev)}
    start = launch_counts()
    with pinned_matching(mine):
        logs = train_step(model, opt, batch)
    sync()
    first = launch_counts()
    out["logs"] = {k: float(v) for k, v in logs.items()}
    out["first"] = {k: first[k] - start[k] for k in first}
    out.update(timed_steps(torch, lambda: train_step(model, opt, batch),
                           timed, sync),
               steps=1 + 2 * timed,
               peak=torch.cuda.max_memory_allocated(dev) if cuda else 0)
    del model, opt, batch

    ecfg = merge_cfg_options(load_config(config), [f"data.data_root={root}"])
    mc = build_model_config(ecfg)
    ds = build_dataset(ecfg.data, ecfg.class_names, mc.pc_range, "val")
    emodel = cli_model(mc, None, dev, log=lambda *a: None)
    rp = functools.partial(scene_points, nq=mc.num_query)
    stats = {}
    dets, gts = evaluator.run_inference_distributed(
        ds, emodel, mc, device=dev, batch_size=1, random_points=rp,
        stats=stats)
    after = launch_counts()
    out["launches"] = {k: after[k] - start[k] for k in after}
    out["eval_batches"] = stats["batches"]
    out["n_dets"] = len(dets)
    if dist.rank() == 0:
        ref, ref_gts = evaluator.run_inference(
            ds, emodel, mc, device=dev, batch_size=1,
            random_points=lambda k, a: rp([k], a))
        out["same"] = len(dets) == len(ref) and all(
            np.array_equal(a[k], b[k]) for a, b in zip(dets, ref)
            for k in ("boxes", "scores", "labels"))
        out["same_gts"] = all(np.array_equal(a[k], b[k])
                              for a, b in zip(gts, ref_gts) for k in b)
        out["n_boxes"] = sum(len(d["scores"]) for d in dets)
    del emodel

    model = build_model(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.to(dev)
    opt = make_optimizer(model, TRAIN_LR)
    batch = {k: torch.from_numpy(v[sl]).to(dev) for k, v in batch_np.items()}
    real_sum = dist.batch_sum
    dist.batch_sum = lambda *ts: ts
    try:
        with pinned_matching(mine):
            logs = train_step(model, opt, batch)
    finally:
        dist.batch_sum = real_sum
    out["local_bn"] = {k: float(v) for k, v in logs.items()}
    return out


def ddp_cli_rank(config, root, work_dir, coordinators):
    """Phase 61, one rank: ``cli.train --num-processes 2`` for 2 steps,
    its resume from ``latest`` for 2 more, then ``cli.test
    --num-processes 2`` on ``latest`` (the val split), each with the JAX
    CLI's flags and a ``host:port`` of ``coordinators`` (train, resume,
    test); returns each run's summary with this rank's launches."""
    from uni3detr_tpu_torch.cli import test as cli_test
    from uni3detr_tpu_torch.cli import train as cli_train
    from uni3detr_tpu_torch.ops import launch_counts

    r, W = os.environ["RANK"], os.environ["WORLD_SIZE"]

    def flags(tag):
        return ["--num-processes", W, "--process-id", r, "--coordinator",
                coordinators[tag]]

    opts = ["--cfg-options", f"data.data_root={root}",
            "evaluation.interval=0", "log_config.interval=1"]
    latest = os.path.join(work_dir, "latest")
    keep = ("epoch", "step", "rank", "world_size", "launches")
    first = cli_train.main([config, "--work-dir", work_dir, "--max-steps",
                            "2", *flags("train"), *opts])
    resumed = cli_train.main([config, "--work-dir", work_dir, "--resume-from",
                              latest, "--max-steps", "4", *flags("resume"),
                              *opts])
    before = launch_counts()
    test = cli_test.main([config, latest, "--eval", "bbox", "--out",
                          os.path.join(work_dir, "dets.pkl"),
                          "--cfg-options", f"data.data_root={root}",
                          *flags("test")])
    after = launch_counts()
    return ({k: first[k] for k in keep}, {k: resumed[k] for k in keep},
            dict({k: test[k] for k in ("dets", "gts", "metrics", "rank",
                                       "world_size")},
                 batches=test["stats"]["batches"],
                 launches={k: after[k] - before[k] for k in after}))


def _sum_launches(*runs):
    total = {}
    for run in runs:
        for k, v in run.items():
            total[k] = total.get(k, 0) + v
    return total


def _times(per_step, n):
    return {k: v * n for k, v in per_step.items()}


def ddp_root(root, n_scenes):
    """A SUN RGB-D root of ``n_scenes`` train and as many val scenes of
    CLI_POINTS points (``synthetic.write_sunrgbd_root``); returns it."""
    from uni3detr_tpu_torch.config_file import load_config
    from uni3detr_tpu_torch.presets import SUNRGBD
    from uni3detr_tpu_torch.synthetic import write_sunrgbd_root

    classes = load_config(SUNRGBD_CONFIG).class_names
    for split in ("train", "val"):
        write_sunrgbd_root(root, SUNRGBD, classes, n_scenes,
                           num_points=CLI_POINTS, split=split)
    return root


@contextlib.contextmanager
def pinned_matching(fixed=None, seen=None):
    """Within: the train loss's matching (``losses.assign_layers``) runs
    and its launches count, but the loss takes ``fixed`` ((L, B, Q), a
    CPU tensor) where given; ``seen`` collects what the matcher returned
    (on the CPU)."""
    from uni3detr_tpu_torch.train import losses
    real = losses.assign_layers

    def assign(costs, gt_mask, cfg):
        got = real(costs, gt_mask, cfg)
        if seen is not None:
            seen.append(got.cpu())
        return got if fixed is None else fixed.to(got.device)

    losses.assign_layers = assign
    try:
        yield
    finally:
        losses.assign_layers = real


def one_process_steps(torch, dev, cfg, sd, batch_np, nudges=(), pin=True):
    """The first step of ``cfg`` from ``sd`` on ``batch_np`` in this
    process, twice, then once with the points x (1 + nudge) for each of
    ``nudges``: the runs' logs as floats, and the first run's matching
    ((L, B, Q) on the CPU). With ``pin`` the later runs take the first
    run's matching (``pinned_matching``)."""
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    runs, seen = [], []
    for i, nudge in enumerate((0.0, 0.0) + tuple(nudges)):
        model = build_model(cfg)
        model.load_state_dict(sd, strict=True)
        model.to(dev)
        opt = make_optimizer(model, TRAIN_LR)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        batch["points"] = batch["points"] * (1 + nudge)
        with pinned_matching(seen[0] if i and pin else None,
                             None if i else seen):
            logs = train_step(model, opt, batch)
        runs.append({k: float(v) for k, v in logs.items()})
        del model, opt, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return runs, seen[0]


def ddp_step_phase(torch, dev, n, B, backend, root, config, tag, cfg=None):
    """Phase 60 on ``n`` ranks (``backend`` expected): the fp32 step of
    ``cfg`` (default the flagship; TF32 off, dropout 0) on ``n`` ranks
    (``ddp_step_rank``) against one process on the same global batch of
    ``B`` scenes (batch seed DDP_BATCH_SEED) and weights (``one_process_steps``: run
    twice; the second run and every rank on the first run's matching),
    the loss within the larger of DDP_LOSS_RTOL[0] and twice the two
    runs' spread (at most DDP_LOSS_RTOL[1]), each rank's step with its
    own BN statistics outside it (a planted fault), the grad norm as
    DDP_GNORM_RTOL says; each rank's launches (on the card),
    ms/step and all-reduce share printed; ``run_inference_distributed``
    equal to ``run_inference`` on rank 0. Returns each rank's launches."""
    from uni3detr_tpu_torch.config_file import (build_model_config,
                                                load_config,
                                                merge_cfg_options)
    from uni3detr_tpu_torch.parallel.launch import spawn
    from uni3detr_tpu_torch.presets import SUNRGBD
    from uni3detr_tpu_torch.synthetic import clustered_train_batch

    cuda = dev.type == "cuda"
    mc = build_model_config(merge_cfg_options(load_config(config),
                                              [f"data.data_root={root}"]))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(cfg or SUNRGBD, compute_dtype="float32",
                              dropout=0.0)
    sd = _state_dict(torch, build_model(cfg))
    batch_np = clustered_train_batch(DDP_BATCH_SEED, cfg, B)
    one, assigned = one_process_steps(torch, dev, cfg, sd, batch_np)
    spread = abs(one[0]["grad_norm"] - one[1]["grad_norm"]) \
        / one[0]["grad_norm"]
    loss1, gn1 = one[0]["total_loss"], one[0]["grad_norm"]
    again = abs(one[1]["total_loss"] - loss1) / abs(loss1)
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:ddp_step_rank", n,
                  (cfg, {k: v.numpy() for k, v in sd.items()}, batch_np,
                   assigned.numpy(), config, root, DDP_TIMED),
                  {"device": dev.type}, device=dev.type, timeout=DDP_TIMEOUT)
    wall = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    per_step, per_batch = train_per_step(cfg), infer_per_batch(mc)
    gtol = min(max(2 * spread, DDP_GNORM_RTOL[0]), DDP_GNORM_RTOL[1])
    ltol = min(max(2 * again, DDP_LOSS_RTOL[0]), DDP_LOSS_RTOL[1])
    card = card_line() if cuda else "CPU"
    print(f"[{tag}] one process at B={B} (batch seed {DDP_BATCH_SEED}), "
          f"fp32, TF32 off: total_loss {[o['total_loss'] for o in one]} "
          f"(again on the first run's matching): {again:.3g} between the "
          f"two runs, loss "
          f"rtol {ltol:.3g} (twice that, within {DDP_LOSS_RTOL})")
    runs = []
    for rk in ranks:
        logs = rk["logs"]
        el = abs(logs["total_loss"] - loss1) / abs(loss1)
        eg = abs(logs["grad_norm"] - gn1) / gn1
        want = _sum_launches(_times(per_step, rk["steps"]),
                             _times(per_batch, rk["eval_batches"]))
        ar = rk["all_reduce_s"] / (sum(rk["ms_with_timers"]) / 1e3)
        print(f"[{tag}] rank {rk['rank']} of {n} ({rk['backend']}, "
              f"{rk['device']}): step 1 total_loss={logs['total_loss']:.6f} "
              f"(one process at B={B}: {loss1:.6f}, relative {el:.3g}, "
              f"rtol {ltol:.3g}), grad_norm={logs['grad_norm']:.6f} "
              f"(one process: {gn1:.6f}, relative {eg:.3g}, rtol {gtol:.3g}: "
              f"twice the spread {spread:.3g} of two one-process runs, within "
              f"{DDP_GNORM_RTOL}); ms/step median "
              f"{statistics.median(rk['ms']):.3f} over {DDP_TIMED} "
              f"({[round(t, 3) for t in rk['ms']]}); with the all-reduce "
              f"timed: {rk['all_reduce_calls']} all-reduces a step, "
              f"{rk['all_reduce_s'] * 1e3 / DDP_TIMED:.3f} ms a step (the "
              f"gradients' {rk['big_bytes']} B "
              f"{rk['big_s'] * 1e3 / DDP_TIMED:.3f} ms), share "
              f"{ar:.3f} of {statistics.median(rk['ms_with_timers']):.3f} "
              f"ms/step ({card}); peak_mem_bytes={rk['peak']}; launches "
              f"step 1 {rk['first']}, over {rk['steps']} steps and "
              f"{rk['eval_batches']} eval batches {rk['launches']}")
        fl = abs(rk["local_bn"]["total_loss"] - loss1) / abs(loss1)
        print(f"[{tag}] rank {rk['rank']}, the planted fault (each rank's "
              f"own BN statistics): total_loss "
              f"{rk['local_bn']['total_loss']:.6f}, relative {fl:.3g} "
              f"outside rtol {ltol:.3g}: {fl > ltol}")
        if rk["backend"] != backend or not el <= ltol or not eg <= gtol:
            fail(f"{tag} rank {rk['rank']}: backend, loss or grad norm")
        if not fl > ltol:
            fail(f"{tag} rank {rk['rank']}: the loss tolerance {ltol:.3g} "
                 f"passes a step with per-rank BN statistics ({fl:.3g})")
        if cuda and (rk["first"] != per_step or rk["launches"] != want):
            fail(f"{tag} rank {rk['rank']}: launches {rk['launches']} != "
                 f"{want} (step 1 {rk['first']} != {per_step})")
        runs.append(rk["launches"])
    r0 = ranks[0]
    print(f"[{tag}] {n} ranks in {wall:.1f}s; run_inference_distributed at "
          f"B=1 over {r0['n_dets']} scenes ({r0['n_boxes']} boxes) with draws "
          f"keyed by scene: rank 0 holds them all, equal to run_inference "
          f"bit for bit: {r0['same']}, GT in dataset order: "
          f"{r0['same_gts']}")
    if not (r0["same"] and r0["same_gts"] and r0["n_dets"]
            and not any(rk["n_dets"] for rk in ranks[1:])):
        fail(f"{tag}: run_inference_distributed != run_inference")
    return runs


def ddp_cli_phase(torch, n, root, wd, tag):
    """Phase 61 on ``n`` ranks on the card (``ddp_cli_rank``: ``cli.train``
    2 steps, a resume to step 4, ``cli.test`` on ``root``'s val split,
    the JAX CLI's flags with loopback ``host:port`` coordinators): each
    rank's launches as its steps and batches (and N1's two-set form once
    a scene in rank 0's metric), rank 0 alone holding the gathered
    detections (the val split's GT in order) and the metric, the files
    of rank 0 and of the other ranks' logs. Returns the launches."""
    import numpy as np
    from uni3detr_tpu_torch.config_file import (build_model_config,
                                                load_config,
                                                merge_cfg_options)
    from uni3detr_tpu_torch.data.datasets import build_dataset
    from uni3detr_tpu_torch.parallel.launch import spawn

    cfg = merge_cfg_options(load_config(SUNRGBD_CONFIG),
                            [f"data.data_root={root}"])
    mc = build_model_config(cfg)
    per_step, per_batch = train_per_step(mc), infer_per_batch(mc)
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:ddp_cli_rank", n,
                  (SUNRGBD_CONFIG, root, wd,
                   {k: f"127.0.0.1:{free_port()}"
                    for k in ("train", "resume", "test")}),
                  device="cuda", init=False, timeout=DDP_TIMEOUT)
    wall = time.perf_counter() - t0
    ds = build_dataset(cfg.data, cfg.class_names, mc.pc_range, "val")
    runs = []
    for rk, (first, resumed, test) in enumerate(ranks):
        want_test = _times(per_batch, test["batches"])
        if rk == 0:
            want_test["iou3d_rotated_sets"] = sum(
                bool(len(g["boxes"]) and len(d["boxes"]))
                for g, d in zip(test["gts"], test["dets"]))
        got = [first["launches"], resumed["launches"], test["launches"]]
        want = [_times(per_step, 2), _times(per_step, 2),
                _sum_launches(dict.fromkeys(per_step, 0), want_test)]
        print(f"[{tag}] rank {rk}: train to step {first['step']}, resumed "
              f"to step {resumed['step']}, world size {first['world_size']}; "
              f"cli.test {test['batches']} batch(es), "
              f"{len(test['dets'])} detections gathered, metrics "
              f"{'written' if test['metrics'] else 'none'}; launches train "
              f"{got[0]}, resume {got[1]}, test {got[2]}")
        if (first["step"], resumed["step"], first["rank"],
                first["world_size"]) != (2, 4, rk, n) or got != want:
            fail(f"{tag} rank {rk}: steps or launches {got} != {want}")
        runs += got
    test0 = ranks[0][2]
    files = sorted(os.listdir(wd))
    same_gt = len(test0["gts"]) == len(ds) and all(
        np.array_equal(g["boxes"], ds[i]["gt_boxes"])
        for i, g in enumerate(test0["gts"]))
    logs = {f"train.rank{r}.log" for r in range(1, n)}
    print(f"[{tag}] {n} ranks in {wall:.1f}s; files {files}; rank 0's "
          f"{len(test0['dets'])} scenes hold the val split's GT in order: "
          f"{same_gt}; {_metric_summary(test0['metrics'])}")
    if not same_gt or not test0["metrics"] or any(
            r[2]["dets"] or r[2]["metrics"] for r in ranks[1:]) or not {
                "train.log", "latest", "dets.pkl"} | logs <= set(files):
        fail(f"{tag}: rank 0's gather, files or the other ranks' outputs")
    return runs


def ddp(torch, dev):
    """Phases 59-62: data parallelism on the card. 59 one rank over NCCL
    through ``cli.train`` (torchrun's environment) at full width, 2
    steps; 60 two ranks sharing the card over gloo on CUDA tensors: one
    fp32 flagship step at B=2 a rank against one process at B=4 on the
    same weights and batch, their ms/step and the all-reduce's share,
    ``run_inference_distributed`` against ``run_inference``; 61
    ``cli.train`` / resume / ``cli.test --num-processes 2``; 62
    ``graft_entry.dryrun_multichip(2)``. Returns the launches of every
    rank's runs."""
    from uni3detr_tpu_torch import graft_entry
    from uni3detr_tpu_torch.config_file import (build_model_config,
                                                load_config,
                                                merge_cfg_options)

    shutil.rmtree(DDP_DIR, ignore_errors=True)
    runs = []
    root = ddp_root(os.path.join(DDP_DIR, "sunrgbd"), DDP_SCENES)
    cfg_file = merge_cfg_options(load_config(SUNRGBD_CONFIG),
                                 [f"data.data_root={root}"])
    mc = build_model_config(cfg_file)

    # -- 59: one rank over NCCL through cli.train, env as torchrun's
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    seen = {}

    def on_first(model, opt):
        seen.update(initialized=torch.distributed.is_initialized(),
                    backend=torch.distributed.get_backend(),
                    world=torch.distributed.get_world_size())

    os.environ.update(env)
    try:
        r, w = train_cli_run(torch, "ddp-nccl", SUNRGBD_CONFIG, root,
                             ["--work-dir", os.path.join(DDP_DIR, "nccl"),
                              "--max-steps", "2", "--cfg-options",
                              "evaluation.interval=0",
                              "log_config.interval=1"], mc,
                             on_first=on_first)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    runs.append(w.launches())
    print(f"[ddp-nccl] process group during the steps: {seen}; world size "
          f"{r['world_size']}, {len(w.steps)} steps of {mc.num_points} "
          f"points at B={cfg_file.data['samples_per_gpu']}; torn down after: "
          f"{not torch.distributed.is_initialized()}")
    if seen != dict(initialized=True, backend="nccl", world=1) or len(
            w.steps) != 2 or torch.distributed.is_initialized():
        fail(f"ddp-nccl: {seen}, {len(w.steps)} steps")
    del w
    torch.cuda.empty_cache()

    # -- 60: two ranks on the card against one process, same global batch
    runs += ddp_step_phase(torch, dev, DDP_RANKS, DDP_B, "gloo", root,
                           SUNRGBD_CONFIG, "ddp-gloo")

    # -- 61: the CLIs on two ranks
    runs += ddp_cli_phase(torch, DDP_RANKS, root, os.path.join(DDP_DIR, "cli"),
                          "ddp-cli")

    # -- 62: the graft entry's dry run on the card
    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(DDP_RANKS, device="cuda")
    dcfg = graft_entry.dryrun_config()
    # the JAX dry run's (data, spatial) layout: (1, 2), the eval over 3
    n_eval = 2 * graft_entry.dryrun_layout(DDP_RANKS)[0] + 1
    for rk in res:
        shard = len(range(rk["rank"], n_eval, DDP_RANKS))
        want = _sum_launches(train_per_step(dcfg), _times(
            infer_per_batch(dcfg), -(-shard // 2)))
        if rk["launches"] != want:
            fail(f"ddp-dryrun rank {rk['rank']}: launches {rk['launches']} "
                 f"!= {want}")
        runs.append(rk["launches"])
    print(f"[ddp-dryrun] dryrun_multichip({DDP_RANKS}) on the card in "
          f"layout {res[0]['layout']} (data x spatial) in "
          f"{time.perf_counter() - t0:.1f}s, launches a rank as one tiny "
          f"step and its eval shard")
    shutil.rmtree(DDP_DIR, ignore_errors=True)
    return runs


# -- the on-ramps: raw data to AP, a reference checkpoint, FLOPs -----------
ONRAMP_DIR = os.path.join(_ROOT, "build", "chip_smoke_onramps")
NUSCENES_CONFIG = os.path.join(_ROOT, "configs/uni3detr/uni3detr_nuscenes.py")
KITTI_RAW_TRAIN, KITTI_RAW_VAL = 8, 4     # phase 63: scans a split
KITTI_RAW_CARS = (8, 12)  # Cars a scan (ObjectSample fills to 15 a scene)
KITTI_RAW_STEPS, NUS_RAW_STEPS = 3, 2     # phases 63-64: cli.train steps
KITTI_BOX_ATOL, KITTI_YAW_ATOL = 1e-4, 1e-5   # phase 63: infos vs planted
NUS_ATOL = 1e-6           # phase 64: boxes (m, rad) and velocities (m/s)
NUS_POSE_ATOL = 1e-9      # phase 64: the sweeps' sensor2lidar vs planted
LIDAR_CONFIGS = ("uni3detr_sunrgbd", "uni3detr_scannet",
                 "uni3detr_scannet_large", "uni3detr_kitti_car",
                 "uni3detr_kitti_3classes", "uni3detr_nuscenes")
OV_CONFIGS = ("ov_uni3detr_sunrgbd_mm", "ov_uni3detr_sunrgbd_pc",
              "ov_uni3detr_sunrgbd_rgb")
TINY_CONFIG = os.path.join(_ROOT,
                           "configs/uni3detr/uni3detr_synthetic_tiny.py")
FP32_OPT = ("--cfg-options", "model.compute_dtype=float32")


def _config_path(name):
    sub = "ov_uni3detr" if name.startswith("ov_") else "uni3detr"
    return os.path.join(_ROOT, "configs", sub, f"{name}.py")


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def object_sample_watch():
    """Records (GT boxes before, after) of every ``ObjectSample`` call in
    the block (the train loader's threads included)."""
    from uni3detr_tpu_torch.data import pipeline

    calls, real = [], pipeline.ObjectSample.__call__

    def call(self, sample, rng):
        n = len(sample["gt_boxes"])
        out = real(self, sample, rng)
        calls.append((n, len(out["gt_boxes"])))
        return out

    pipeline.ObjectSample.__call__ = call
    try:
        yield calls
    finally:
        pipeline.ObjectSample.__call__ = real


def kitti_raw_phase(torch, dev):
    """Phase 63: KITTI from its raw layout to AP with ``uni3detr_kitti_car``
    at full width. ``synthetic.write_kitti_raw`` (KITTI_RAW_TRAIN +
    KITTI_RAW_VAL scans of 120000 points, KITTI_RAW_CARS Cars and 1-3
    DontCare rows a scan, a non-identity calib), ``cli.create_data kitti``
    for both splits and ``gt_database`` with the config: every info's
    Cars within KITTI_BOX_ATOL m and KITTI_YAW_ATOL rad of the planted
    boxes, the DontCare rows kept, the database at the config's
    ``db_info_path`` with each object's count ``points_in_rbbox``'s; then
    ``cli.train`` KITTI_RAW_STEPS steps at B=1 with ``ObjectSample``
    drawing from it (launches as phase 57's steps) and ``cli.test`` on its
    ``latest`` over the val scans with box merging (launches a scan K1 4,
    K2 17, K3 3, K4 1 and N1's matrix form, N1's 3D and BEV two-set forms
    in the metric). Returns the launches of both runs."""
    import numpy as np
    from uni3detr_tpu_torch.cli import create_data
    from uni3detr_tpu_torch.config_file import (build_model_config,
                                                load_config,
                                                merge_cfg_options)
    from uni3detr_tpu_torch.data import box_np_ops
    from uni3detr_tpu_torch.synthetic import write_kitti_raw

    root = os.path.join(ONRAMP_DIR, "kitti")
    planted, t_write = _timed(lambda: write_kitti_raw(
        root, KITTI_RAW_TRAIN, KITTI_RAW_VAL, cars=KITTI_RAW_CARS))
    t_conv = {}
    for split in ("train", "val"):
        _, t_conv[split] = _timed(create_data.main,
                                  ["kitti", "--root", root, "--split", split])
    db_path, t_db = _timed(create_data.main, [
        "gt_database", KITTI_CAR_CONFIG, "--out-dir", root, "--cfg-options",
        f"data.data_root={root}"])
    print(f"[onramp-kitti] host s: write_kitti_raw {t_write:.3f} "
          f"({KITTI_RAW_TRAIN + KITTI_RAW_VAL} scans), create_data kitti "
          f"train {t_conv['train']:.3f} val {t_conv['val']:.3f}, "
          f"gt_database {t_db:.3f}")
    worst, n_db, n_cars = [0.0, 0.0], 0, 0
    with open(db_path, "rb") as f:
        db = pickle.load(f)
    for split in ("train", "val"):
        with open(os.path.join(root, f"kitti_infos_{split}.pkl"), "rb") as f:
            infos = pickle.load(f)
        for i, info in enumerate(infos):
            want = planted[info["point_cloud"]["idx"]]
            n = len(want["boxes"])
            names = list(info["annos"]["name"])
            if names != ["Car"] * n + ["DontCare"] * want["dontcare"]:
                fail(f"onramp-kitti: {info['point_cloud']['idx']} names "
                     f"{names}")
            got = info["annos"]["gt_boxes_lidar"][:n].astype(np.float64)
            dyaw = (got[:, 6] - want["boxes"][:, 6] + np.pi) % (
                2 * np.pi) - np.pi
            worst = [max(worst[0], np.abs(got[:, :6]
                                          - want["boxes"][:, :6]).max()),
                     max(worst[1], np.abs(dyaw).max())]
            n_cars += n
            if split != "train":
                continue
            pts = np.fromfile(os.path.join(
                root, info["point_cloud"]["velodyne_path"]),
                np.float32).reshape(-1, 4)
            inside = box_np_ops.points_in_rbbox(
                pts[:, :3], info["annos"]["gt_boxes_lidar"][:n])
            for rec in db["Car"]:
                scene, _, j = os.path.basename(rec["path"])[:-4].split("_")
                if int(scene) == i:
                    n_db += 1
                    if rec["num_points_in_gt"] != inside[:, int(j)].sum():
                        fail(f"onramp-kitti: {rec['path']} holds "
                             f"{rec['num_points_in_gt']} points")
    print(f"[onramp-kitti] {n_cars} planted Cars: worst |box - planted| "
          f"{worst[0]:.3g} m (atol {KITTI_BOX_ATOL}), yaw {worst[1]:.3g} "
          f"rad (atol {KITTI_YAW_ATOL}); {n_db} database objects at "
          f"{os.path.relpath(db_path, root)}, each with points_in_rbbox's "
          f"count")
    cfg = merge_cfg_options(load_config(KITTI_CAR_CONFIG),
                            [f"data.data_root={root}"])
    if worst[0] > KITTI_BOX_ATOL or worst[1] > KITTI_YAW_ATOL or not n_db \
            or db_path != os.path.join(root, cfg.data["train_pipeline"][0][
                "db_info_path"]):
        fail("onramp-kitti: the infos or the GT database")
    mc = build_model_config(cfg)
    wd = os.path.join(ONRAMP_DIR, "kitti_wd")
    with object_sample_watch() as pasted:
        _, w = train_cli_run(torch, "onramp-kitti-train", KITTI_CAR_CONFIG,
                             root, ["--work-dir", wd, "--max-steps",
                                    str(KITTI_RAW_STEPS), "--cfg-options",
                                    "log_config.interval=1"], mc,
                             gt_counts=True)
    added = sum(b - a for a, b in pasted)
    print(f"[onramp-kitti-train] ObjectSample (GT before, after) "
          f"{pasted}: {added} objects pasted from the new database; GT a "
          f"sample in the batches {[g for st in w.steps for g in st['gt']]}")
    if len(w.steps) != KITTI_RAW_STEPS or added <= 0:
        fail("onramp-kitti-train: wrong step count or nothing pasted")
    runs = [w.launches()]
    del w
    torch.cuda.empty_cache()
    run, _ = cli_run(torch, "onramp-kitti-test", KITTI_CAR_CONFIG, root,
                      KITTI_RAW_VAL, infer_per_batch(mc),
                      os.path.join(wd, "latest"), metric_kind="kitti")
    runs.append(run)
    return runs


def nuscenes_raw_phase(torch, dev):
    """Phase 64: nuScenes from its raw tables to its metrics with
    ``uni3detr_nuscenes`` at full width. ``synthetic.write_nuscenes_raw``
    (2 scenes of 4 key frames, LIDAR_TOP at 20 Hz with 34720 points of 5
    floats, 10 sweeps before the first key frame, 6 cameras, ~40
    annotations a key frame over the 10 classes) and ``cli.create_data
    nuscenes --max-sweeps 10 --val-scenes``: boxes within NUS_ATOL of the
    planted ones, velocities too, each key frame's 10 sweeps at the
    planted poses, ``valid_flag`` false exactly where both point counts
    are 0; ``cli.train`` NUS_RAW_STEPS steps (CBGS, 300000 of the 381920
    points after ``LoadPointsFromMultiSweeps``; launches as phase 12's
    steps) and ``cli.test`` on the 4 val key frames (launches as phase
    10's scenes, N1 and N2 once a batch). Returns the launches of both
    runs."""
    import numpy as np
    from uni3detr_tpu_torch.cli import create_data
    from uni3detr_tpu_torch.config_file import (build_model_config,
                                                load_config,
                                                merge_cfg_options)
    from uni3detr_tpu_torch.synthetic import write_nuscenes_raw

    root = os.path.join(ONRAMP_DIR, "nuscenes")
    truth, t_write = _timed(write_nuscenes_raw, root)
    _, t_conv = _timed(create_data.main, [
        "nuscenes", "--root", root, "--max-sweeps", "10", "--val-scenes",
        os.path.join(root, "val_scenes.txt")])
    print(f"[onramp-nuscenes] host s: write_nuscenes_raw {t_write:.3f}, "
          f"create_data nuscenes {t_conv:.3f}")
    worst = dict(box=0.0, yaw=0.0, velocity=0.0, pose=0.0)
    n_inv = n_ann = 0
    for split in ("train", "val"):
        with open(os.path.join(root, f"nuscenes_infos_{split}.pkl"),
                  "rb") as f:
            infos = pickle.load(f)["infos"]
        if len(infos) != 4:
            fail(f"onramp-nuscenes: {len(infos)} {split} infos")
        for info in infos:
            want = truth[info["token"]]
            g = info["gt_boxes"]
            dyaw = (g[:, 6] - want["boxes"][:, 6] + np.pi) % (
                2 * np.pi) - np.pi
            worst["box"] = max(worst["box"], np.abs(
                g[:, :6] - want["boxes"][:, :6]).max())
            worst["yaw"] = max(worst["yaw"], np.abs(dyaw).max())
            worst["velocity"] = max(worst["velocity"], np.abs(
                info["gt_velocity"] - want["velocity"]).max())
            if len(info["sweeps"]) != 10 or not np.array_equal(
                    info["valid_flag"], want["valid"]):
                fail(f"onramp-nuscenes: {info['token']} sweeps or valid")
            for sw, (tok, rot, trans) in zip(info["sweeps"],
                                              want["sweeps"]):
                if sw["sample_data_token"] != tok:
                    fail(f"onramp-nuscenes: sweep {tok}")
                worst["pose"] = max(
                    worst["pose"],
                    np.abs(sw["sensor2lidar_rotation"] - rot).max(),
                    np.abs(sw["sensor2lidar_translation"] - trans).max())
            n_inv += int((~info["valid_flag"]).sum())
            n_ann += len(g)
    print(f"[onramp-nuscenes] {n_ann} annotations ({n_inv} without a "
          f"point): worst |box - planted| {worst['box']:.3g} m, yaw "
          f"{worst['yaw']:.3g} rad, velocity {worst['velocity']:.3g} m/s "
          f"(atol {NUS_ATOL}); sweep poses {worst['pose']:.3g} (atol "
          f"{NUS_POSE_ATOL}); valid_flag as planted")
    if max(worst["box"], worst["yaw"], worst["velocity"]) > NUS_ATOL or \
            worst["pose"] > NUS_POSE_ATOL or not n_inv:
        fail("onramp-nuscenes: the infos differ from the planted truth")
    cfg = merge_cfg_options(load_config(NUSCENES_CONFIG),
                            [f"data.data_root={root}"])
    mc = build_model_config(cfg)
    wd = os.path.join(ONRAMP_DIR, "nuscenes_wd")
    _, w = train_cli_run(torch, "onramp-nuscenes-train", NUSCENES_CONFIG,
                         root, ["--work-dir", wd, "--max-steps",
                                str(NUS_RAW_STEPS), "--cfg-options",
                                "log_config.interval=1"], mc)
    if len(w.steps) != NUS_RAW_STEPS:
        fail("onramp-nuscenes-train: wrong step count")
    runs = [w.launches()]
    del w
    torch.cuda.empty_cache()
    run, _ = cli_run(torch, "onramp-nuscenes-test", NUSCENES_CONFIG, root,
                      4, infer_per_batch(mc), os.path.join(wd, "latest"),
                      metric_kind="nuscenes")
    runs.append(run)
    return runs


def reference_pth(torch, model, path):
    """Write ``model``'s seed-0 weights (``weights.random_state_dict``) as
    a reference checkpoint: mmdet3d's ``{"meta", "state_dict"}``, the
    sparse convs in spconv-v2's (out, kd, kh, kw, in) layout, the BN
    counts set as a trained checkpoint has them. Returns the key of the
    largest tensor."""
    sd = _state_dict(torch, model)
    for k, v in sd.items():
        if k.startswith("pts_middle_encoder.") and v.dim() == 5:
            sd[k] = v.permute(4, 0, 1, 2, 3).contiguous()
        elif k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(29000)
    torch.save({"meta": {"epoch": 36, "mmdet3d_version": "1.0.0rc6"},
                "state_dict": sd}, path)
    return max(sd, key=lambda k: sd[k].numel())


def import_phase(torch, dev):
    """Phase 65: a reference checkpoint. For ``uni3detr_sunrgbd`` and
    ``ov_uni3detr_sunrgbd_mm``: the
    seed-0 weights as a reference ``.pth`` (``reference_pth``),
    ``cli.import_ckpt``, then ``cli.test`` on the result and without a
    checkpoint (the seed-0 weights): detections bit-equal; then a
    ``.pth`` with one tensor of the wrong shape, which ``import_ckpt``
    refuses naming the key. Returns the launches of the ``cli.test``
    runs."""
    from uni3detr_tpu_torch.cli import import_ckpt
    from uni3detr_tpu_torch.config_file import (build_model_config,
                                                load_config,
                                                merge_cfg_options)
    from uni3detr_tpu_torch.presets import PRESETS
    from uni3detr_tpu_torch.synthetic import write_sunrgbd_root

    runs = []
    for name, config, camera in (
            ("uni3detr_sunrgbd", SUNRGBD_CONFIG, False),
            ("ov_uni3detr_sunrgbd_mm", OV_MM_CONFIG, True)):
        how = ["--preset", name]
        root = os.path.join(ONRAMP_DIR, f"import_{name}")
        cfg = load_config(config)
        write_sunrgbd_root(root, PRESETS[name], cfg.class_names, 4,
                           camera=camera, num_points=CLI_POINTS)
        mc = build_model_config(merge_cfg_options(
            cfg, [f"data.data_root={root}"]))
        pth, out = os.path.join(root, "ref.pth"), os.path.join(root, "ckpt")
        big = reference_pth(torch, build_model(mc), pth)
        n, t_imp = _timed(import_ckpt.main, [pth, out] + how)
        with open(os.path.join(out, "meta.json")) as f:
            meta = json.load(f)
        print(f"[onramp-import] {name}: {n} tensors imported from a "
              f"spconv-v2 .pth in {t_imp:.3f}s; meta classes "
              f"{len(meta['classes'])}, preset {meta['preset']}")
        if meta["classes"] != list(cfg.class_names):
            fail(f"onramp-import {name}: classes {meta['classes']}")
        per_batch = infer_per_batch(mc)
        run, imp = cli_run(torch, f"onramp-import-{name}", config, root, 4,
                           per_batch, out)
        runs.append(run)
        run, seed0 = cli_run(torch, f"onramp-seed0-{name}", config, root, 4,
                             per_batch)
        runs.append(run)
        same_dets(f"onramp-import-{name}", imp["dets"], seed0["dets"],
                  "cli.test's on the seed-0 weights")
        raw = torch.load(pth, weights_only=False)
        raw["state_dict"][big] = raw["state_dict"][big][:-1]
        torch.save(raw, pth)
        try:
            import_ckpt.main([pth, os.path.join(root, "bad")] + how)
        except ValueError as e:
            if big not in str(e):
                fail(f"onramp-import {name}: the error {e} names no key")
            print(f"[onramp-import] {name}: a .pth with {big} cut by one "
                  f"row is refused: {str(e)[:160]}")
        else:
            fail(f"onramp-import {name}: a wrong shape was imported")
        del raw
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return runs


def flops_phase(torch, dev):
    """Phase 66: ``cli.get_flops`` on every shipped preset's config at
    B=1 (params, GFLOP, GB moved, peak memory); for ``uni3detr_sunrgbd``
    and the synthetic tiny config the card's FLOP count equal to the
    CPU's (fp32 on both, and the card's preset dtype) and, for the
    flagship, to the count over two different scenes; then
    ``trace_context`` over one flagship forward: the trace lists the port's
    kernels with K1 4, K2 17, K3 3 and K4 1 launches. Returns the
    launches of the card runs."""
    from uni3detr_tpu_torch import synthetic
    from uni3detr_tpu_torch.cli import get_flops
    from uni3detr_tpu_torch.ops.cuda_lib import forward_launches
    from uni3detr_tpu_torch.presets import SUNRGBD
    from uni3detr_tpu_torch.utils.profiling import (flops_of, trace_context,
                                                    trace_kernel_counts)

    wrappers = kernel_wrappers()
    runs = []

    def on_card(argv):
        before = {k: fn.launches for k, fn in wrappers.items()}
        r, secs = _timed(get_flops.main, argv)
        runs.append({k: fn.launches - before[k]
                     for k, fn in wrappers.items()})
        torch.cuda.empty_cache()
        return r, secs

    rows = {}
    for name in LIDAR_CONFIGS + OV_CONFIGS:
        r, secs = on_card([_config_path(name)])
        rows[name] = r
        print(f"[flops] {name}: params {r['params']} forward "
              f"{r['flops'] / 1e9:.3f} GFLOP (kernels "
              f"{sum(v['flops'] for v in r['kernels'].values()) / 1e9:.3f})"
              f" bytes {r['bytes_accessed'] / 1e9:.3f} GB peak "
              f"{r['peak_memory_bytes'] / 1e9:.3f} GB at B=1 ({secs:.1f}s)")
    for name, config in (("uni3detr_sunrgbd", SUNRGBD_CONFIG),
                         ("synthetic_tiny", TINY_CONFIG)):
        card, _ = on_card([config])
        card32, _ = on_card([config, *FP32_OPT])
        cpu, secs = _timed(get_flops.main, [config, "--device", "cpu",
                                            *FP32_OPT])
        print(f"[flops] {name}: card {card['flops']} (preset dtype), card "
              f"fp32 {card32['flops']}, CPU fp32 {cpu['flops']} FLOPs "
              f"({secs:.1f}s on the CPU); bytes card "
              f"{card32['bytes_accessed']} CPU {cpu['bytes_accessed']}")
        if not card["flops"] == card32["flops"] == cpu["flops"] > 0:
            fail(f"flops {name}: the card's count is not the CPU's")
    model = build_model(SUNRGBD)
    model.load_state_dict(_state_dict(torch, model), strict=True)
    model = model.eval().to(dev)
    counts = []
    with torch.inference_mode():
        for seed in (0, 1):
            args = scene_inputs(torch, synthetic.clustered_scene(
                seed, SUNRGBD), dev)
            before = {k: fn.launches for k, fn in wrappers.items()}
            counts.append(flops_of(model, *args)["flops"])
            runs.append({k: fn.launches - before[k]
                         for k, fn in wrappers.items()})
        model(*args)
        torch.cuda.synchronize()
        logdir = os.path.join(ONRAMP_DIR, "trace")
        before = {k: fn.launches for k, fn in wrappers.items()}
        with trace_context(logdir):
            model(*args)
            torch.cuda.synchronize()
        launched = {k: fn.launches - before[k] for k, fn in wrappers.items()}
    runs.append(launched)
    zeros = rows["uni3detr_sunrgbd"]["flops"]
    print(f"[flops] uni3detr_sunrgbd over two clustered scenes: {counts} "
          f"FLOPs (the CLI's zeros batch: {zeros})")
    if not counts[0] == counts[1] == zeros:
        fail("flops: the count depends on the scene")
    path, by_kernel = trace_kernel_counts(logdir)
    traced = forward_launches(by_kernel)
    want = {"match_positions": 4, "gather_conv": 17, "gather_conv_ids": 3,
            "fps_pair": 1}
    print(f"[trace] {os.path.basename(path)} ({os.path.getsize(path)} "
          f"bytes): port kernels {by_kernel}; by wrapper {traced}")
    if traced != want or any(launched[k] != v for k, v in want.items()):
        fail(f"trace: launches {traced} (counted {launched}) != {want}")
    del model
    torch.cuda.empty_cache()
    return runs


def onramps(torch, dev):
    """Phases 63-66 (see the module docstring); returns their launches."""
    shutil.rmtree(ONRAMP_DIR, ignore_errors=True)
    runs, t = [], [time.perf_counter()]
    for phase in (kitti_raw_phase, nuscenes_raw_phase, import_phase,
                  flops_phase):
        runs += phase(torch, dev)
        t.append(time.perf_counter())
    print("[onramps] s: " + ", ".join(
        f"{n} {b - a:.1f}" for n, a, b in zip(
            ("kitti", "nuscenes", "import", "flops"), t, t[1:])))
    shutil.rmtree(ONRAMP_DIR, ignore_errors=True)
    return runs


OPTIONS_DIR = os.path.join(_ROOT, "build", "chip_smoke_options")
# phase 67: (preset, eval batch) of N3's shapes; decoded boxes a scene are
# the preset's max_num (1000 of 10 classes, 5000 of 18)
SOFT_NMS_SHAPES = (("uni3detr_sunrgbd", 4), ("uni3detr_scannet", 1))
SOFT_SCORE_RTOL = 1e-6
# N3: fp32 operations a live box and step: the argmax compare, and while
# the step keeps a box the square, the division, exp, the product and the
# select of the decay
SOFT_OPS_PER_BOX_STEP = 6
SOFT_STEP_BOXES = 256     # phase 67's serial-step probe: one box a thread
OPT_TRAIN_SCENES, OPT_VAL_SCENES, OPT_STEPS = 8, 4, 3   # phase 68
OPT_TRAIN_OPTS = ["model.iou_cost_type=rdiou", "model.iou_loss_type=rdiou",
                  "model.post_processing=soft_nms", "log_config.interval=1"]
DENSE_RTOL, DENSE_ATOL = 2e-2, 2e-3       # phase 69, tests/test_sparse_conv.py's
DENSE_STEPS = 2                            # phase 69: B=4 steps, the first warms
SWEEPS, SWEEP_STEPS = 2, 2                 # phase 70
VOV_SIZE = (480, 640)                      # phase 71: the OV configs' img_size
VOV_RTOL = 5e-2      # phase 71: bf16 card vs fp32 CPU, of each stage's largest


def soft_nms_roofline(B, N, kept, loops):
    """N3: the kept boxes' IoU rows read once (``kept`` x N x 4 bytes), the
    scores, labels and valid flags read and the score, keep and step
    written (B N x 18 bytes); every block scans its N live scores once a
    step (``kept`` steps that keep a box, each with the decay, and the
    ``loops`` final steps that keep none) at SOFT_OPS_PER_BOX_STEP fp32
    operations a box."""
    return roofline(SOFT_OPS_PER_BOX_STEP * N * kept + N * loops,
                    4 * kept * N + 18 * B * N, "fp32")


def soft_nms_step_ms(torch, dev):
    """N3's least time for one serial step (a block argmax, its two
    barriers, the prune test and one IoU row): one scene and one class of
    SOFT_STEP_BOXES boxes, one a thread of the block, on an IoU matrix of
    zeros with every score above the prune level, so that every step
    keeps a box; (t(n steps) - t(n / 2 steps)) / (n / 2), each t from
    back-to-back launches, which cancels the launch. A class loop of k
    steps takes at least k times this on the card, whatever its width."""
    from uni3detr_tpu_torch.ops import nms
    n = SOFT_STEP_BOXES
    iou = torch.zeros((1, n, n), device=dev)
    sc = torch.linspace(1.0, 0.5, n, device=dev)[None]
    lab = torch.zeros((1, n), dtype=torch.int32, device=dev)
    val = torch.ones((1, n), dtype=torch.uint8, device=dev)
    t = {}
    for k in (n // 2, n):
        before = nms.soft_nms.launches
        t[k] = back_to_back_ms(
            torch, lambda: nms.soft_nms(iou, sc, lab, val, 1, 0.5, 0.0, k), 50)
        if nms.soft_nms.launches - before != 51:
            fail("N3's step timing: not one launch a call")
    if not bool(nms.soft_nms(iou, sc, lab, val, 1, 0.5, 0.0, n)[1].all()):
        fail("N3's step timing: a step kept no box")
    return (t[n] - t[n // 2]) / (n // 2)


def soft_nms_phase(torch, dev, report):
    """Phase 67: N3 on the decoded boxes of a random-weight forward at
    the flagship's eval batch (4 scenes, 1000 boxes of 10 classes) and at
    ScanNet's (1 scene, 5000 boxes of 18 classes). The main path
    (``post_process`` with ``soft_nms``, under
    ``set_sync_debug_mode("error")``) launches N1's matrix and N3 once;
    then N3 against ``soft_nms_plain`` on the same matrix: the keep masks
    and each kept box's step (the kept indices in order) equal, the
    scores within SOFT_SCORE_RTOL, the boxes whose step differs (a
    near-tie flipped) counted and held to 0; kernel, device and plain
    times, the bound, and the serial bound: the longest class loop's
    steps (the kept ones and the last, which keeps none) times
    :func:`soft_nms_step_ms`. The device time is N3's alone, back to back
    on arguments already in its dtypes; the profiler's reading of N3 and
    of the wrapper's casts is printed beside it (both 0: it traced no
    kernel). Returns the main path's launches."""
    import numpy as np
    from uni3detr_tpu_torch.geom.boxes import bottom_center_boxes
    from uni3detr_tpu_torch.geom.iou import iou3d_rotated_pairwise
    from uni3detr_tpu_torch.ops import nms
    from uni3detr_tpu_torch.presets import PRESETS
    from uni3detr_tpu_torch.synthetic import clustered_scene
    from uni3detr_tpu_torch.train.coder import (decode_predictions,
                                                post_process)

    wrappers = kernel_wrappers()
    runs = []
    step_ms = soft_nms_step_ms(torch, dev)
    print(f"[soft-nms] N3 one serial step at least {step_ms * 1e3:.3f} us "
          f"({SOFT_STEP_BOXES} boxes of one class, every step keeping one)")
    for preset, B in SOFT_NMS_SHAPES:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(PRESETS[preset],
                                  post_processing="soft_nms")
        model = build_model(cfg).eval()
        model.load_state_dict(_state_dict(torch, model), strict=True)
        model.to(dev)
        scenes = [clustered_scene(seed, cfg) for seed in range(B)]
        pts = torch.from_numpy(np.concatenate([s[0] for s in scenes])).to(dev)
        rnd = torch.from_numpy(np.concatenate([s[1] for s in scenes])).to(dev)
        mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
        with torch.inference_mode():
            dec = decode_predictions(model(pts, mask, rnd), cfg)
        del model
        boxes, scores, labels, valid = dec
        N, C = scores.shape[1], cfg.num_classes
        args = (scores, labels, valid, C, cfg.soft_nms_sigma,
                cfg.soft_nms_prune, min(cfg.max_num, N))
        torch.cuda.synchronize()
        before = {k: fn.launches for k, fn in wrappers.items()}
        torch.cuda.set_sync_debug_mode("error")
        try:
            post = post_process(*dec, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        run = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        want = dict.fromkeys(wrappers, 0)
        want.update(iou3d_rotated_matrix=1, soft_nms=1)
        if run != want:
            fail(f"soft-NMS {preset}: launches {run} != {want}")
        runs.append(run)
        iou = iou3d_rotated_pairwise(
            bottom_center_boxes(boxes)[..., :7].contiguous(), "bottom")
        got = nms.soft_nms(iou, *args)
        ref = nms.soft_nms_plain(iou, *args)
        flipped = int((got[2] != ref[2]).sum())
        kept = int(ref[1].sum())
        err = ((got[0] - ref[0]).abs()
               / ref[0].abs().clamp(min=1e-30)).max().item()
        per_loop = torch.zeros(B, C, dtype=torch.long, device=dev)
        per_loop.index_put_((torch.arange(B, device=dev)[:, None].expand(
            B, N)[ref[1]], labels.long()[ref[1]]),
            torch.ones(kept, dtype=torch.long, device=dev), accumulate=True)
        if cfg.score_thr is None and cfg.num_thr is None and not (
                torch.equal(post[3], got[1]) and torch.equal(post[1], got[0])):
            fail(f"soft-NMS {preset}: post_process's output is not N3's")
        ms = median_ms(torch, lambda: nms.soft_nms(iou, *args), 20)
        cast = (scores.float(), labels.to(torch.int32),
                valid.to(torch.uint8)) + args[3:]
        before = nms.soft_nms.launches
        dev_ms = back_to_back_ms(torch, lambda: nms.soft_nms(iou, *cast), 20)
        if nms.soft_nms.launches - before != 21:
            fail("N3's timing: not one launch a call")
        prof = device_ms_by_name(torch, lambda: nms.soft_nms(iou, *args),
                                 "u3d_soft_nms", 10)
        pms = median_ms(torch, lambda: nms.soft_nms_plain(iou, *args), 2, 1)
        bound = soft_nms_roofline(B, N, kept, B * C)
        longest = int(per_loop.max())
        chain_ms = (longest + 1) * step_ms
        print(f"[soft-nms] {preset} B={B} N={N} C={C}: valid="
              f"{int(valid.sum())} kept={kept}, the longest class loop "
              f"{longest} steps; post_process launches N1 matrix "
              f"{run['iou3d_rotated_matrix']} N3 {run['soft_nms']} (no host "
              f"sync); N3 vs plain: keep equal "
              f"{torch.equal(got[1], ref[1])}, steps equal "
              f"{torch.equal(got[2], ref[2])}, {flipped} boxes at another "
              f"step (near-tie flips), score max rel err {err:.3g} (rtol "
              f"{SOFT_SCORE_RTOL}); ms={ms:.4f} device_ms={dev_ms:.4f} "
              f"(20 back to back; profiler: N3 {prof[0]:.4f}, the wrapper's "
              f"dtype casts {prof[1]:.4f}) plain_ms={pms:.4f} bound_ms="
              f"{bound['bound_ms']:.5f} ({bound['bound_by']}; "
              f"{bound['bytes']} bytes, {bound['ops']} operations) "
              f"serial_bound_ms={chain_ms:.4f} ({longest + 1} steps x "
              f"{step_ms * 1e3:.3f} us) binds "
              f"{'serial' if chain_ms > bound['bound_ms'] else bound['bound_by']}"
              f" ({time.perf_counter() - t0:.1f}s)")
        if flipped or not torch.equal(got[1], ref[1]) or \
                not err <= SOFT_SCORE_RTOL:
            fail(f"N3 soft_nms differs from soft_nms_plain at {preset}")
        if preset == "uni3detr_scannet":
            _report_add(report, "soft_nms", err, ms, pms, 1, bound)
            report["soft_nms"].update(device_ms=dev_ms,
                                      serial_bound_ms=chain_ms)
        del iou, got, ref, dec, post
        torch.cuda.empty_cache()
    return runs


def rdiou_cli_phase(torch, dev):
    """Phase 68: ``cli.train`` on ``uni3detr_sunrgbd.py`` at B=4 with the
    RDIoU cost and loss and soft-NMS post-processing (``--max-steps 3``)
    on a written SUN RGB-D root, each step's launches as phase 54's and
    its loss finite; ``cli.test`` on its ``latest`` with soft-NMS (N1's
    matrix and N3 once a batch, a metric); one direct ``train_step`` with
    the ``axis_aligned_iou3d`` cost. Returns the launches of the runs."""
    from uni3detr_tpu_torch.config_file import (build_model_config,
                                                load_config,
                                                merge_cfg_options)
    from uni3detr_tpu_torch.presets import SUNRGBD
    from uni3detr_tpu_torch.synthetic import (clustered_train_batch,
                                              write_sunrgbd_root)
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    root = os.path.join(OPTIONS_DIR, "sunrgbd")
    classes = load_config(SUNRGBD_CONFIG).class_names
    write_sunrgbd_root(root, SUNRGBD, classes, OPT_TRAIN_SCENES,
                       num_points=CLI_POINTS, split="train")
    write_sunrgbd_root(root, SUNRGBD, classes, OPT_VAL_SCENES,
                       num_points=CLI_POINTS)
    mc = build_model_config(merge_cfg_options(
        load_config(SUNRGBD_CONFIG), [f"data.data_root={root}",
                                      *OPT_TRAIN_OPTS]))
    if (mc.iou_cost_type, mc.iou_loss_type, mc.post_processing) != (
            "rdiou", "rdiou", "soft_nms"):
        fail(f"options: the CLI's model config {mc}")
    wd = os.path.join(OPTIONS_DIR, "rdiou_wd")
    _, w = train_cli_run(torch, "options-train", SUNRGBD_CONFIG, root,
                         ["--work-dir", wd, "--max-steps", str(OPT_STEPS),
                          "--cfg-options", *OPT_TRAIN_OPTS], mc)
    if len(w.steps) != OPT_STEPS:
        fail(f"options-train: {len(w.steps)} steps")
    train_log_check("options-train", wd, ())
    runs = [w.launches()]
    del w
    torch.cuda.empty_cache()
    run, _ = cli_run(torch, "options-test", SUNRGBD_CONFIG, root,
                     OPT_VAL_SCENES, infer_per_batch(mc),
                     os.path.join(wd, "latest"),
                     cfg_options=["model.post_processing=soft_nms"])
    runs.append(run)
    cfg = dataclasses.replace(SUNRGBD, iou_cost_type="axis_aligned_iou3d")
    model = build_model(cfg)
    model.load_state_dict(_state_dict(torch, model), strict=True)
    model.to(dev)
    opt = make_optimizer(model, TRAIN_LR)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             clustered_train_batch(0, cfg, TRAIN_B).items()}
    wrappers = kernel_wrappers()
    before = {k: fn.launches for k, fn in wrappers.items()}
    logs = train_step(model, opt, batch)
    torch.cuda.synchronize()
    run = {k: fn.launches - before[k] for k, fn in wrappers.items()}
    print(f"[options-axis-aligned] one step at B={TRAIN_B}: total_loss="
          f"{float(logs['total_loss']):.5f} grad_norm="
          f"{float(logs['grad_norm']):.5f} launches {run}")
    if run != train_per_step(cfg) or not math.isfinite(
            float(logs["total_loss"])):
        fail(f"options-axis-aligned: launches {run} or loss")
    runs.append(run)
    del model, opt, batch
    torch.cuda.empty_cache()
    return runs


def dense_phase(torch, dev):
    """Phase 69: ``encoder_impl="dense"`` at ``uni3detr_sunrgbd``'s full
    width (its grid, one clustered scene's voxels): the dense encoder
    against the gather route in fp32,
    TF32 off, on the same weights, at the gather route's active sites
    (the gather route without budgets, so that it cuts no site), within
    DENSE_RTOL / DENSE_ATOL; then the bf16 dense model's forward on the
    scene and DENSE_STEPS train steps at B=4: ms, peak memory and
    launches (K4 and, in training, K12 alone). Returns the launches."""
    import numpy as np
    from uni3detr_tpu_torch.presets import SUNRGBD
    from uni3detr_tpu_torch.synthetic import (clustered_scene,
                                              clustered_train_batch)
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    wrappers = kernel_wrappers()
    cfg32 = dataclasses.replace(SUNRGBD, compute_dtype="float32")
    gather = build_model(dataclasses.replace(
        cfg32, encoder_budget_shrink=(1.0, 1.0, 1.0),
        encoder_budget_caps=None)).eval()
    sd = _state_dict(torch, gather)
    gather.load_state_dict(sd, strict=True)
    dense = build_model(dataclasses.replace(cfg32, encoder_impl="dense"))
    dense.load_state_dict(sd, strict=True)
    gather.to(dev)
    dense.eval().to(dev)
    pts, rnd = clustered_scene(0, SUNRGBD)
    pts = torch.from_numpy(pts).to(dev)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        feats, coords, vmask = gather.voxelize(pts, mask)
        vg, gg = gather.pts_middle_encoder(feats, coords, vmask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vd, gd = dense.pts_middle_encoder(feats, coords, vmask)
        torch.cuda.synchronize()
        fp32_ms = (time.perf_counter() - t0) * 1e3
        active = vg.abs().sum(-1) > 0
        extra = int(((vd.abs().sum(-1) > 0) & ~active).sum())
        bad = int(((vd - vg).abs() > DENSE_ATOL + DENSE_RTOL * vg.abs())[
            active].sum())
        err = (vd - vg)[active].abs().max().item()
    torch.backends.cudnn.allow_tf32 = True
    print(f"[dense] fp32 encoder, one scene: {int(vmask.sum())} voxels on "
          f"the {tuple(SUNRGBD.grid_size)} grid -> {gd} volume; dense vs "
          f"gather at the gather route's {int(active.sum())} active sites: "
          f"max abs err {err:.3g}, {bad} entries outside rtol {DENSE_RTOL} "
          f"atol {DENSE_ATOL}; {extra} sites only the dense route fills; "
          f"dense encoder ms={fp32_ms:.3f} (one call, fp32, TF32 off)")
    if gd != gg or bad or not bool(active.any()):
        fail("dense encoder differs from the gather route")
    del gather, dense, vg, vd, feats, coords, vmask
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(SUNRGBD, encoder_impl="dense")
    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    model.eval().to(dev)
    rnd = torch.from_numpy(rnd).to(dev)
    runs = []
    with torch.inference_mode():
        model(pts, mask, rnd)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = {k: fn.launches for k, fn in wrappers.items()}
        t0 = time.perf_counter()
        model(pts, mask, rnd)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    run = {k: fn.launches - before[k] for k, fn in wrappers.items()}
    want = dict.fromkeys(wrappers, 0)
    want["fps_pair"] = 1
    print(f"[dense] bf16 forward, one scene (after a warm-up): ms={ms:.3f} "
          f"peak_mem_bytes={torch.cuda.max_memory_allocated(dev)} launches "
          f"{ {k: v for k, v in run.items() if v} }")
    if run != want:
        fail(f"dense forward: launches {run} != {want}")
    runs.append(run)
    opt = make_optimizer(model, TRAIN_LR)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             clustered_train_batch(0, cfg, TRAIN_B).items()}
    want["auction_lap"] = 1
    for i in range(DENSE_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = {k: fn.launches for k, fn in wrappers.items()}
        t0 = time.perf_counter()
        logs = train_step(model, opt, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        run = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        loss = float(logs["total_loss"])
        print(f"[dense] train step {i} at B={TRAIN_B}: total_loss={loss:.5f}"
              f" grad_norm={float(logs['grad_norm']):.5f} ms={ms:.3f} "
              f"peak_mem_bytes={torch.cuda.max_memory_allocated(dev)} "
              f"launches {({k: v for k, v in run.items() if v})}"
              + (" (warm-up)" if i == 0 else ""))
        if run != want or not math.isfinite(loss):
            fail(f"dense train step {i}: launches {run} or loss {loss}")
        runs.append(run)
    del model, opt, batch
    torch.cuda.empty_cache()
    return runs


def ov_sweep_phase(torch, dev):
    """Phase 70: ``ov_uni3detr_sunrgbd_mm`` with SWEEPS sweeps under
    ``sweep_cat`` and under ``with_time``: SWEEP_STEPS train steps each
    at the config's B=4 on ``synthetic.ov_train_batch`` (sweeps x cameras
    images a scene and ``sweep_times``), ri drawn as phase 45 draws it:
    finite losses, a non-zero gradient at ``trans_conv.0`` /
    ``time_conv.0`` in every step that uses the image branch (ri 0, 2),
    each step's launches phase 45's for its ri. Returns the launches."""
    from uni3detr_tpu_torch.presets import OV_SUNRGBD_MM, OV_SUNRGBD_MM_LR_MULT
    from uni3detr_tpu_torch.synthetic import ov_train_batch
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    wrappers = kernel_wrappers()
    runs = []
    for fusion, conv in (("sweep_cat", "trans_conv"),
                         ("with_time", "time_conv")):
        cfg = dataclasses.replace(OV_SUNRGBD_MM, num_sweeps=SWEEPS,
                                  sweep_fusion=fusion)
        model = build_model(cfg)
        model.load_state_dict(_state_dict(torch, model), strict=True)
        model.to(dev)
        opt = make_optimizer(model, OV_LR, lr_mult=OV_SUNRGBD_MM_LR_MULT)
        batch_np, _ = ov_train_batch(0, cfg, OV_TRAIN_B["mm"])
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        gen = torch.Generator().manual_seed(OV_MODALITY_SEED)
        weight = getattr(model.view_trans, conv)[0].weight
        torch.cuda.reset_peak_memory_stats(dev)
        reached = []
        for i in range(SWEEP_STEPS):
            before = {k: fn.launches for k, fn in wrappers.items()}
            t0 = time.perf_counter()
            logs = train_step(model, opt, batch, modality_generator=gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            ri = model.last_modality
            run = {k: fn.launches - before[k] for k, fn in wrappers.items()}
            g = 0.0 if weight.grad is None else weight.grad.abs().max().item()
            loss = float(logs["total_loss"])
            print(f"[ov-sweeps] {fusion} step {i} (ri {ri}) at B="
                  f"{OV_TRAIN_B['mm']}, {tuple(batch['images'].shape)} "
                  f"images: total_loss={loss:.5f} grad_norm="
                  f"{float(logs['grad_norm']):.5f} |grad {conv}.0| max "
                  f"{g:.3g} ms={ms:.3f} peak_mem_bytes="
                  f"{torch.cuda.max_memory_allocated(dev)}")
            if run != train_per_step(cfg, ri) or not math.isfinite(loss) or \
                    (ri != 1 and not g > 0):
                fail(f"ov-sweeps {fusion} step {i}: launches {run}, loss "
                     f"{loss} or the {conv} gradient {g}")
            reached.append(ri != 1)
            runs.append(run)
        if not any(reached):
            fail(f"ov-sweeps {fusion}: no step used the image branch")
        del model, opt, batch
        torch.cuda.empty_cache()
    return runs


def vovnet_phase(torch, dev):
    """Phase 71: VoVNet-V2-39 at B=1 on a VOV_SIZE image, seeded random
    weights, eval: bf16 on the card against fp32 on the CPU, each stage
    within VOV_RTOL of its largest value; ms on the card."""
    import numpy as np
    from uni3detr_tpu_torch.models.vovnet import VoVNet

    model = VoVNet().eval()
    model.load_state_dict(_state_dict(torch, model), strict=True)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        1, 3, *VOV_SIZE).astype(np.float32))
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = model(x)
    cpu_s = time.perf_counter() - t0
    model.to(dev)
    xb = x.to(dev, torch.bfloat16)
    with torch.inference_mode():
        ms = median_ms(torch, lambda: model(xb), 5)
        got = model(xb)
    errs = [((g.float().cpu() - r).abs().max() / r.abs().max()).item()
            for g, r in zip(got, ref)]
    print(f"[vovnet] V2-39 B=1 {VOV_SIZE}: stages "
          f"{[tuple(r.shape) for r in ref]}; bf16 card vs fp32 CPU max err "
          f"of each stage's largest value {[f'{e:.3g}' for e in errs]} "
          f"(rtol {VOV_RTOL}); card ms={ms:.3f}; CPU fp32 {cpu_s:.2f}s")
    if not all(e <= VOV_RTOL for e in errs) or not all(
            bool(torch.isfinite(g).all()) for g in got):
        fail(f"vovnet: bf16 card vs fp32 CPU {errs}")
    del model
    torch.cuda.empty_cache()


def options(torch, dev, report):
    """Phases 67-71 (see the module docstring); returns their launches."""
    shutil.rmtree(OPTIONS_DIR, ignore_errors=True)
    runs, t = [], [time.perf_counter()]
    runs += soft_nms_phase(torch, dev, report)
    t.append(time.perf_counter())
    for phase in (rdiou_cli_phase, dense_phase, ov_sweep_phase):
        runs += phase(torch, dev)
        t.append(time.perf_counter())
    vovnet_phase(torch, dev)
    t.append(time.perf_counter())
    print("[options] s: " + ", ".join(
        f"{n} {b - a:.1f}" for n, a, b in zip(
            ("soft-nms", "rdiou-cli", "dense", "ov-sweeps", "vovnet"), t,
            t[1:])))
    shutil.rmtree(OPTIONS_DIR, ignore_errors=True)
    return runs


# -- spatial sharding: the dense volume split along H (phases 72-75) -------
SPATIAL_DIR = os.path.join(_ROOT, "build", "chip_smoke_spatial")
SPATIAL_B = 4         # phases 72-74: the global batch (73: 2 a data group)
SPATIAL_TIMED = 1     # phases 72 and 74: timed steps a rank, then as many
                      # with each all-reduce timed (73: none)
# phases 72-73: the gathered fused volume, of its largest value
# (tests/test_parallel.py's 2e-5 at the tiny model's unit scale; the
# flagship's volume reaches ~1e2, where an fp32 ulp is ~1e-5)
SPATIAL_FUSED_RTOL = 2e-5
# phases 72-73: each module's relative gradient error (the L2 norm of the
# difference over the module's gradient's): twice that of two one-process
# runs, at least 1e-3, never looser than 5e-2. (The largest entry of a
# deep layer differs by ~5% between two one-process runs on the card:
# atomics and cuDNN's algorithms; the L2 norm averages that out.)
SPATIAL_GRAD_RTOL = (1e-3, 5e-2)
SPATIAL_BN_RTOL = 1e-4   # phases 72-73: BN running statistics, of the largest
# phase 74: KITTI car's bf16 loss at spatial 2 against one process on the
# same matching that takes its batch statistics as the sharded step does
# (``global_bn_formula``: E[x^2] - E[x]^2, JAX's formula, where cuDNN's
# one-rank kernel differs in the last bits and nine chaotic decoder
# layers at random weights carry that to ~1% of the loss)
KITTI_SPATIAL_LOSS_RTOL = 1e-3
SPATIAL_DENSE_B = 1      # phase 75: scenes of the dense encoder's batch
SPATIAL_DENSE_RTOL = 1e-4   # phase 75: of the volume's largest value
SLICED_MODULES = ("pts_backbone", "pts_neck")   # run on H slices


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(torch, dev):
    """Peak device memory since the last reset (0 on the CPU)."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


@contextlib.contextmanager
def global_bn_formula():
    """Within: a train-mode ``FlaxBatchNormStats`` BN of one process takes
    its statistics as the sharded step's does (``_global_forward``), not
    from cuDNN's kernel."""
    from uni3detr_tpu_torch.models import layers

    real = layers.FlaxBatchNormStats.forward

    def forward(self, x):
        return self._global_forward(x) if self.training else real(self, x)

    layers.FlaxBatchNormStats.forward = forward
    try:
        yield
    finally:
        layers.FlaxBatchNormStats.forward = real


def first_layer_loss(logs):
    """The first decoder layer's loss (its ``d0.*`` terms)."""
    return sum(v for k, v in logs.items() if k.startswith("d0."))


def module_errors(got, ref):
    """Each top-level module's relative gradient error: the L2 norm of
    ``got - ref`` over its parameters over that of ``ref``."""
    num, den = {}, {}
    for k, r in ref.items():
        m = k.split(".")[0]
        num[m] = num.get(m, 0.0) + float(((got[k] - r) ** 2).sum())
        den[m] = den.get(m, 0.0) + float((r ** 2).sum())
    return {m: math.sqrt(num[m] / den[m]) if den[m] else math.sqrt(num[m])
            for m in num}


def bn_error(got, ref):
    """(The largest error of the BN running statistics, of each buffer's
    largest value; its buffer)."""
    return max((float((got[k] - r).abs().max())
                / max(float(r.abs().max()), 1e-12), k)
               for k, r in ref.items())


def captured_step(torch, model, opt, batch, fixed=None, seen=None,
                  plant=False):
    """One ``train_step`` (the loss on ``fixed``'s matching where given;
    ``seen`` collects the matcher's): the logs, and on the host the head's
    input (the gathered fused volume), every gradient after the
    reduction (before the clip) by name and the BN running statistics
    after. ``plant``: the sliced layers' conv weights leave the reduction,
    each rank keeping its own partial gradient (a planted fault)."""
    from uni3detr_tpu_torch.parallel import dist
    from uni3detr_tpu_torch.train.step import train_step

    name_of = {id(p): n for n, p in model.named_parameters()}
    names = [name_of[id(p)] for p in opt.params]
    convs = {f"{n}.weight" for n, m in model.named_modules()
             if n.startswith(SLICED_MODULES)
             and isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d))}
    cap = {}

    def hook(mod, args):
        cap.setdefault("fused", args[0].detach().float().cpu().clone())

    real = dist.average_gradients

    def reduce(grads, *a, **k):
        real([g for g, n in zip(grads, names) if not (plant and n in convs)],
             *a, **k)
        cap["grads"] = {n: g.detach().float().cpu().clone()
                        for n, g in zip(names, grads)}

    handle = model.pts_bbox_head.register_forward_pre_hook(hook)
    dist.average_gradients = reduce
    try:
        with pinned_matching(fixed, seen):
            logs = train_step(model, opt, batch)
    finally:
        dist.average_gradients = real
        handle.remove()
    cap["logs"] = {k: float(v) for k, v in logs.items()}
    cap["bn"] = {k: v.detach().float().cpu().clone()
                 for k, v in model.state_dict().items() if "running_" in k}
    cap["planted"] = len(convs) if plant else 0
    return cap


def timed_steps(torch, step, n, sync):
    """``n`` calls of ``step`` timed on the host after a sync each, then
    ``n`` more with each ``torch.distributed.all_reduce`` timed between
    two syncs: (ms, ms with the timers, all-reduce calls a step, their
    seconds, the largest one's bytes and its seconds)."""
    import torch.distributed as tdist

    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    real, calls = tdist.all_reduce, []

    def timed_all_reduce(t, *a, **k):
        sync()
        t0 = time.perf_counter()
        r = real(t, *a, **k)
        sync()
        calls.append((t.numel() * t.element_size(),
                      time.perf_counter() - t0))
        return r

    tdist.all_reduce = timed_all_reduce
    ms_timed = []
    try:
        for _ in range(n):
            t0 = time.perf_counter()
            step()
            sync()
            ms_timed.append((time.perf_counter() - t0) * 1e3)
    finally:
        tdist.all_reduce = real
    big = max(c[0] for c in calls)
    return dict(ms=ms, ms_with_timers=ms_timed,
                all_reduce_calls=len(calls) // n,
                all_reduce_s=sum(c[1] for c in calls), big_bytes=big,
                big_s=sum(c[1] for c in calls if c[0] == big))


def step_times(r):
    """A rank's ms/step and its all-reduces' share, as printed (empty when
    it timed no step)."""
    if not r.get("ms"):
        return ""
    n = len(r["ms"])
    share = r["all_reduce_s"] / (sum(r["ms_with_timers"]) / 1e3)
    return (f"ms/step median {statistics.median(r['ms']):.3f} over {n} "
            f"({[round(t, 3) for t in r['ms']]}); with the all-reduces "
            f"timed: {r['all_reduce_calls']} a step, "
            f"{r['all_reduce_s'] * 1e3 / n:.3f} ms a step (the largest, "
            f"{r['big_bytes']} B: {r['big_s'] * 1e3 / n:.3f} ms), share "
            f"{share:.3f} of {statistics.median(r['ms_with_timers']):.3f} "
            f"ms/step; ")


def spatial_step_task(torch, dev, cfg, sd, batch_np, assigned, timed,
                      plant=False):
    """Phases 72-74, one rank: the step of ``cfg`` from ``sd`` on this
    data group's slice of ``batch_np``, the loss on its slice of
    ``assigned`` (one process's matching), captured (``captured_step``;
    the host copies on rank 0 only); ``timed`` steps and as many with the
    all-reduces timed (none with 0); the peak; with ``plant`` the first
    step again from ``sd`` with the planted fault. Returns host
    objects."""
    import torch.distributed as tdist
    from uni3detr_tpu_torch.parallel import dist
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    sync = functools.partial(_sync, torch, dev)
    counters = kernel_wrappers()
    sl = dist.local_slice(len(batch_np["points"]))
    batch = {k: torch.from_numpy(v[sl]).to(dev) for k, v in batch_np.items()}
    mine = torch.from_numpy(assigned[:, sl])

    def fresh():
        model = build_model(cfg)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        model.to(dev)
        return model, make_optimizer(model, TRAIN_LR)

    model, opt = fresh()
    _reset_peak(torch, dev)
    start = {k: fn.launches for k, fn in counters.items()}
    cap = captured_step(torch, model, opt, batch, fixed=mine)
    sync()
    first = {k: fn.launches - start[k] for k, fn in counters.items()}
    out = timed_steps(torch, lambda: train_step(model, opt, batch), timed,
                      sync) if timed else {}
    out.update(rank=dist.rank(), backend=tdist.get_backend(),
               layout=(dist.data_size(), dist.spatial_size()),
               logs=cap["logs"], first=first, steps=1 + 2 * timed,
               peak=_peak(torch, dev),
               launches={k: fn.launches - start[k]
                         for k, fn in counters.items()})
    if dist.rank() == 0:
        out["cap"] = {k: cap[k] for k in ("fused", "grads", "bn")}
    del model, opt, cap
    if plant:
        model, opt = fresh()
        before = {k: fn.launches for k, fn in counters.items()}
        cap = captured_step(torch, model, opt, batch, fixed=mine,
                            plant=True)
        sync()
        out["planted_launches"] = {k: fn.launches - before[k]
                                   for k, fn in counters.items()}
        if dist.rank() == 0:
            out["planted"] = {k: cap[k] for k in ("grads", "planted")}
        del model, opt, cap
    torch.cuda.empty_cache()
    return out


def dense_encoder_run(torch, dev, enc_cfg, enc_sd, voxels_np):
    """The dense encoder (``enc_cfg``: a Uni3DETRConfig with
    ``encoder_impl="dense"``) from ``enc_sd`` in train mode on
    ``voxels_np`` inside ``dist.sharded_batch()`` (split along H over the
    spatial ranks of a process group), then the backward of ``sum(volume
    * w)`` for a seeded normal w of the whole volume's shape (over S
    where the volume is whole): (this rank's volume on the host, the
    global grid, ms, the peak)."""
    from uni3detr_tpu_torch.parallel import dist, spatial

    enc = build_model(enc_cfg).pts_middle_encoder
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in enc_sd.items()})
    enc.train().to(dev)
    f, co, m = (torch.from_numpy(a).to(dev) for a in voxels_np)
    _reset_peak(torch, dev)
    t0 = time.perf_counter()
    with dist.sharded_batch():
        vol, grid = enc(f, co, m, spatial=True)
        w = torch.randn((vol.shape[0], *grid, vol.shape[-1]),
                        generator=torch.Generator().manual_seed(3)).to(dev)
        if vol.shape[2] != grid[1]:
            (vol * spatial.shard(w, 2)).sum().backward()
        else:
            (vol * w).sum().div(dist.spatial_size()).backward()
    _sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3
    out = (vol.detach().cpu(), tuple(grid), ms, _peak(torch, dev))
    del enc, vol, f, co, m, w
    torch.cuda.empty_cache()
    return out


def spatial_rank(tasks, device="cuda"):
    """One rank of phases 72-75 (in a process group of a (data, spatial)
    layout): each of ``tasks`` ((phase, kind, kwargs); kind "step" runs
    ``spatial_step_task``, "dense" ``dense_encoder_run``) in turn, fp32
    tasks with TF32 off; returns {phase: result} with each task's host
    seconds. ``device="cpu"`` runs it on the CPU (a rehearsal)."""
    import torch

    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    out = {}
    for phase, kind, kw in tasks:
        t0 = time.perf_counter()
        fp32 = kw.pop("fp32")
        torch.backends.cudnn.allow_tf32 = not fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        if kind == "step":
            res = spatial_step_task(torch, dev, **kw)
        else:
            vol, grid, ms, peak = dense_encoder_run(torch, dev, **kw)
            res = dict(vol=vol, grid=grid, ms=ms, peak=peak)
        torch.backends.cudnn.allow_tf32 = True
        res["s"] = time.perf_counter() - t0
        out[phase] = res
    return out


def spatial_cli_rank(config, root, work_dir, coordinator, device="cuda"):
    """Phase 75, one rank: ``cli.train CONFIG --spatial-shard 2
    --num-processes 2`` for one epoch (2 steps) and its eval, the JAX
    CLI's flags; returns the summary, this rank's launches, the gathered
    detections' count and, on rank 0, the GT and detections, and a digest
    of the weights after."""
    import hashlib
    from uni3detr_tpu_torch.cli import train as cli_train
    from uni3detr_tpu_torch.train import evaluator
    from uni3detr_tpu_torch.train import step as step_mod

    seen = {}
    real_step, real_eval = step_mod.train_step, \
        evaluator.run_inference_distributed

    def watch_step(model, opt, batch, **kw):
        seen["model"] = model
        return real_step(model, opt, batch, **kw)

    def watch_eval(*a, **k):
        dets, gts = real_eval(*a, **k)
        seen["eval"] = (dets, gts)
        return dets, gts

    step_mod.train_step = watch_step
    evaluator.run_inference_distributed = watch_eval
    try:
        res = cli_train.main([
            config, "--work-dir", work_dir, "--spatial-shard", "2",
            "--num-processes", os.environ["WORLD_SIZE"], "--process-id",
            os.environ["RANK"], "--coordinator", coordinator, "--device",
            device,
            "--cfg-options", f"data.data_root={root}", "data.repeat=1",
            "total_epochs=1", "evaluation.interval=1",
            "log_config.interval=1"])
    finally:
        step_mod.train_step = real_step
        evaluator.run_inference_distributed = real_eval
    digest = hashlib.sha256()
    for k, v in seen["model"].state_dict().items():
        digest.update(k.encode())
        digest.update(v.detach().cpu().numpy().tobytes())
    dets, gts = seen["eval"]
    out = {k: res[k] for k in ("epoch", "step", "evals", "rank",
                               "world_size", "launches")}
    out.update(n_dets=len(dets), digest=digest.hexdigest())
    if res["rank"] == 0:
        out["sets"] = sum(bool(len(g["boxes"]) and len(d["boxes"]))
                          for g, d in zip(gts, dets))
    return out


def spatial_reference(torch, dev, cfg, sd, batch_np, tag):
    """One process's first step of ``cfg`` (fp32; TF32 off) from ``sd``
    on the whole ``batch_np``, twice, the second on the first's matching
    (``captured_step``): the first run's capture with its matching
    (``assigned``, numpy) and the tolerances from the two runs' spread:
    the loss's and the gradient norm's (phase 60's rules) and each
    module's gradient error (SPATIAL_GRAD_RTOL's rule)."""
    from uni3detr_tpu_torch.train.step import make_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs, seen = [], []
    for i in range(2):
        model = build_model(cfg)
        model.load_state_dict(sd, strict=True)
        model.to(dev)
        opt = make_optimizer(model, TRAIN_LR)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        runs.append(captured_step(torch, model, opt, batch,
                                  fixed=seen[0] if i else None,
                                  seen=None if i else seen))
        del model, opt, batch
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    one, two = runs
    loss, gnorm = one["logs"]["total_loss"], one["logs"]["grad_norm"]
    again = abs(two["logs"]["total_loss"] - loss) / abs(loss)
    gspread = abs(two["logs"]["grad_norm"] - gnorm) / gnorm
    spread = module_errors(two["grads"], one["grads"])
    fspread = float((two["fused"] - one["fused"]).abs().max())
    ref = dict(one=one, assigned=seen[0].numpy(), B=len(batch_np["points"]),
               scale=float(one["fused"].abs().max()),
               ltol=min(max(2 * again, DDP_LOSS_RTOL[0]), DDP_LOSS_RTOL[1]),
               gtol=min(max(2 * gspread, DDP_GNORM_RTOL[0]),
                        DDP_GNORM_RTOL[1]),
               mtol={m: min(max(2 * e, SPATIAL_GRAD_RTOL[0]),
                            SPATIAL_GRAD_RTOL[1]) for m, e in spread.items()})
    print(f"[{tag}] one process at B={ref['B']}, fp32, TF32 off, twice on "
          f"one matching: total_loss {loss!r} (again {again:.3g}: loss rtol "
          f"{ref['ltol']:.3g}), grad_norm {gnorm!r} (again {gspread:.3g}: "
          f"rtol {ref['gtol']:.3g}); the fused volume's largest value "
          f"{ref['scale']:.4g}, again {fspread:.3g} apart; relative "
          f"gradient error between the two runs by module "
          f"{({m: f'{e:.3g}' for m, e in spread.items()})} -> tolerance "
          f"{({m: f'{e:.3g}' for m, e in ref['mtol'].items()})}")
    return ref


def check_spatial_step(tag, ranks, key, ref, per_step, cuda, backend):
    """The ranks' ``spatial_step_task`` results (``ranks[i][key]``)
    against one process's (``spatial_reference``): each rank's loss and
    gradient norm, its launches (on the card), ms/step and the
    all-reduces' share printed; rank 0's gathered fused volume (its data
    group's scenes), BN running statistics and each module's gradient
    error. Returns the ranks' launches."""
    one, runs = ref["one"], []
    r0 = ranks[0][key]
    G = r0["layout"][0]
    fe = float((r0["cap"]["fused"] - one["fused"][:ref["B"] // G])
               .abs().max())
    errs = module_errors(r0["cap"]["grads"], one["grads"])
    be, bkey = bn_error(r0["cap"]["bn"], one["bn"])
    ok = fe <= SPATIAL_FUSED_RTOL * ref["scale"] and be <= SPATIAL_BN_RTOL \
        and all(errs[m] <= ref["mtol"][m] for m in errs)
    for rk in ranks:
        r = rk[key]
        logs = r["logs"]
        el = abs(logs["total_loss"] - one["logs"]["total_loss"]) \
            / abs(one["logs"]["total_loss"])
        eg = abs(logs["grad_norm"] - one["logs"]["grad_norm"]) \
            / one["logs"]["grad_norm"]
        print(f"[{tag}] rank {r['rank']} ({r['backend']}), layout "
              f"{r['layout']} (data x spatial), B={ref['B'] // G} a data "
              f"group: total_loss={logs['total_loss']!r} (relative {el:.3g},"
              f" rtol {ref['ltol']:.3g}), grad_norm={logs['grad_norm']!r} "
              f"(relative {eg:.3g}, rtol {ref['gtol']:.3g}); "
              f"{step_times(r)}peak_mem_bytes={r['peak']}; launches step 1 "
              f"{r['first']}, over {r['steps']} steps {r['launches']} "
              f"({r['s']:.1f}s)")
        if not (el <= ref["ltol"] and eg <= ref["gtol"]) or (
                backend and r["backend"] != backend):
            fail(f"{tag} rank {r['rank']}: loss, grad norm or backend")
        if cuda and (r["first"] != per_step or r["launches"] != _times(
                per_step, r["steps"])):
            fail(f"{tag} rank {r['rank']}: launches {r['launches']} != "
                 f"{per_step} a step")
        runs.append(r["launches"])
        if "planted_launches" in r:
            runs.append(r["planted_launches"])
    print(f"[{tag}] rank 0 against one process: the gathered fused volume "
          f"{tuple(r0['cap']['fused'].shape)} max abs err {fe:.3g} (rtol "
          f"{SPATIAL_FUSED_RTOL} of {ref['scale']:.4g}); BN running "
          f"statistics {be:.3g} at {bkey} (rtol {SPATIAL_BN_RTOL}); relative"
          f" gradient error by module "
          f"{({m: f'{e:.3g}' for m, e in errs.items()})}: within the "
          f"tolerance {ok}")
    if not ok:
        fail(f"{tag}: fused volume, BN statistics or gradients off one "
             f"process")
    return runs


def spatial(torch, dev, flagship_cfg=None, kitti_cfg=None):
    """Phases 72-75: spatial sharding on the card, ranks sharing it over
    gloo (``flagship_cfg`` / ``kitti_cfg`` replace the presets, and a CPU
    ``dev`` runs it all on the CPU without the launch checks: a
    rehearsal). 72 two spatial ranks x one data group against one process: the
    flagship's fp32 step at B=4 on one matching; 73 two x two (four
    ranks, B=2 a data group); 74 KITTI car, bf16, B=4, spatial 1 and 2:
    loss, each rank's peak and ms/step; 75 the dense encoder at the
    flagship's width, spatial 2 against 1, ``cli.train --spatial-shard 2
    --num-processes 2``, ``graft_entry.dryrun_multichip(4)`` ((2, 2)).
    Returns the launches of every rank's runs."""
    from uni3detr_tpu_torch import graft_entry
    from uni3detr_tpu_torch.config_file import (build_model_config,
                                                load_config,
                                                merge_cfg_options)
    from uni3detr_tpu_torch.parallel.launch import spawn
    from uni3detr_tpu_torch.presets import KITTI_CAR, SUNRGBD
    from uni3detr_tpu_torch.synthetic import clustered_train_batch
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    shutil.rmtree(SPATIAL_DIR, ignore_errors=True)
    cuda = dev.type == "cuda"
    card = card_line() if cuda else "CPU"
    runs, secs = [], {}
    t0 = time.perf_counter()
    cfg = dataclasses.replace(flagship_cfg or SUNRGBD,
                              compute_dtype="float32", dropout=0.0)
    per_step = train_per_step(cfg)
    sd = _state_dict(torch, build_model(cfg))
    sd_np = {k: v.numpy() for k, v in sd.items()}
    batch_np = clustered_train_batch(DDP_BATCH_SEED, cfg, SPATIAL_B)
    ref = spatial_reference(torch, dev, cfg, sd, batch_np, "spatial")
    assigned = ref["assigned"]

    kcfg = dataclasses.replace(kitti_cfg or KITTI_CAR, dropout=0.0)
    kper_step = train_per_step(kcfg)
    ksd = {k: v.numpy() for k, v in _state_dict(
        torch, build_model(kcfg)).items()}
    kbatch_np = clustered_train_batch(0, kcfg, SPATIAL_B)
    kone, kseen = [], []
    for i in range(2):
        model = build_model(kcfg)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in ksd.items()})
        model.to(dev)
        opt = make_optimizer(model, TRAIN_LR)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in kbatch_np.items()}
        _reset_peak(torch, dev)
        # the second run takes the sharded step's statistics formula
        with pinned_matching(kseen[0] if i else None, None if i else kseen), \
                global_bn_formula() if i else contextlib.nullcontext():
            logs = train_step(model, opt, batch)
        res = {"loss": float(logs["total_loss"]),
               "d0": first_layer_loss({k: float(v) for k, v in logs.items()})}
        if i == 0:
            ms = []
            for _ in range(SPATIAL_TIMED):
                t1 = time.perf_counter()
                train_step(model, opt, batch)
                _sync(torch, dev)
                ms.append((time.perf_counter() - t1) * 1e3)
            res.update(ms=ms, peak=_peak(torch, dev))
        kone.append(res)
        del model, opt, batch
        torch.cuda.empty_cache()
    kassigned = kseen[0].numpy()
    kform = abs(kone[1]["loss"] - kone[0]["loss"]) / abs(kone[0]["loss"])
    print(f"[spatial-kitti] one process (spatial 1), uni3detr_kitti_car "
          f"bf16 at B={SPATIAL_B}: total_loss {kone[0]['loss']!r}, first "
          f"decoder layer {kone[0]['d0']!r}; on its matching with the "
          f"sharded step's BN formula {kone[1]['loss']!r} ({kform:.3g} "
          f"apart); ms/step {[round(t, 3) for t in kone[0]['ms']]} after a "
          f"first; peak_mem_bytes={kone[0]['peak']} ({card})")

    dcfg = dataclasses.replace(cfg, encoder_impl="dense")
    pts = torch.from_numpy(clustered_train_batch(
        0, dcfg, SPATIAL_DENSE_B)["points"]).to(dev)
    voxels = tuple(a.cpu().numpy() for a in build_model(dcfg).train()
                   .voxelize(pts, torch.ones(pts.shape[:2], dtype=torch.bool,
                                             device=dev)))
    prefix = "pts_middle_encoder."
    enc_sd = {k[len(prefix):]: v.numpy() for k, v in sd.items()
              if k.startswith(prefix)}
    torch.backends.cudnn.allow_tf32 = False
    dvol, dgrid, dms, dpeak = dense_encoder_run(torch, dev, dcfg, enc_sd,
                                                voxels)
    torch.backends.cudnn.allow_tf32 = True
    print(f"[spatial-dense] one process (spatial 1), the dense encoder at "
          f"the flagship's width, fp32, TF32 off, train mode, B="
          f"{SPATIAL_DENSE_B} ({int(voxels[2].sum())} voxels): volume "
          f"{tuple(dvol.shape)}, forward + backward ms={dms:.3f} "
          f"peak_mem_bytes={dpeak}")
    secs["reference"] = time.perf_counter() - t0

    # -- 72, 74 and 75's encoder: two spatial ranks x one data group
    t0 = time.perf_counter()
    tasks = [
        ("72", "step", dict(cfg=cfg, sd=sd_np, batch_np=batch_np,
                            assigned=assigned, timed=SPATIAL_TIMED,
                            plant=True, fp32=True)),
        ("74", "step", dict(cfg=kcfg, sd=ksd, batch_np=kbatch_np,
                            assigned=kassigned, timed=SPATIAL_TIMED,
                            fp32=False)),
        ("75", "dense", dict(enc_cfg=dcfg, enc_sd=enc_sd,
                             voxels_np=voxels, fp32=True))]
    two = spawn("chip_smoke:spatial_rank", 2, (tasks, dev.type),
                device=dev.type, timeout=DDP_TIMEOUT, spatial=2)
    secs["1x2 ranks"] = time.perf_counter() - t0
    # -- 73: two x two
    t0 = time.perf_counter()
    four = spawn("chip_smoke:spatial_rank", 4, ([
        ("73", "step", dict(cfg=cfg, sd=sd_np, batch_np=batch_np,
                            assigned=assigned, timed=0, fp32=True))],
        dev.type), device=dev.type, timeout=DDP_TIMEOUT, spatial=2)
    secs["2x2 ranks"] = time.perf_counter() - t0

    runs += check_spatial_step("spatial-72", two, "72", ref, per_step, cuda,
                               "gloo")
    planted = two[0]["72"]["planted"]
    perrs = module_errors(planted["grads"], ref["one"]["grads"])
    outside = [m for m in SLICED_MODULES if perrs[m] > ref["mtol"][m]]
    print(f"[spatial-72] the planted fault (the {planted['planted']} sliced "
          f"conv weights' gradients without the spatial sum, rank 0's "
          f"partial one): relative gradient error by module "
          f"{({m: f'{e:.3g}' for m, e in perrs.items()})}; outside the "
          f"tolerance in {outside}")
    if set(outside) != set(SLICED_MODULES):
        fail("spatial-72: the gradient tolerance passes a step without "
             "the spatial sum of the sliced conv weights")
    runs += check_spatial_step("spatial-73", four, "73", ref, per_step,
                               cuda, "gloo")

    for rk in two:
        r = rk["74"]
        loss = r["logs"]["total_loss"]
        el = abs(loss - kone[1]["loss"]) / abs(kone[1]["loss"])
        e1 = abs(loss - kone[0]["loss"]) / abs(kone[0]["loss"])
        e0 = abs(first_layer_loss(r["logs"]) - kone[0]["d0"]) \
            / abs(kone[0]["d0"])
        print(f"[spatial-kitti] rank {r['rank']} of 2 (spatial 2, the "
              f"encoder output's H 200 as 2 x 100): total_loss={loss!r} "
              f"(one process with its BN formula: relative {el:.3g}, rtol "
              f"{KITTI_SPATIAL_LOSS_RTOL}; with cuDNN's: {e1:.3g}, the first "
              f"decoder layer's {e0:.3g}); {step_times(r)}spatial 1 ms/step "
              f"{[round(t, 3) for t in kone[0]['ms']]}; "
              f"peak_mem_bytes={r['peak']} (spatial 1 {kone[0]['peak']}: "
              f"{r['peak'] / max(kone[0]['peak'], 1):.3f}); launches "
              f"{r['launches']} ({r['s']:.1f}s; {card})")
        if not el <= KITTI_SPATIAL_LOSS_RTOL or cuda and (
                r["first"] != kper_step
                or r["launches"] != _times(kper_step, r["steps"])):
            fail(f"spatial-kitti rank {r['rank']}: loss or launches")
        runs.append(r["launches"])

    got = [rk["75"] for rk in two]
    if any(tuple(g["grid"]) != tuple(dgrid) for g in got):
        fail("spatial-dense: grids differ")
    vol = torch.cat([g["vol"] for g in got], 2) \
        if got[0]["vol"].shape[2] != dgrid[1] else got[0]["vol"]
    scale = float(dvol.abs().max())
    active = dvol.abs().sum(-1) > 0
    err = float((vol - dvol).abs().max())
    print(f"[spatial-dense] two spatial ranks: each rank's volume "
          f"{tuple(got[0]['vol'].shape)}, ms {[round(g['ms'], 3) for g in got]}"
          f", peak_mem_bytes {[g['peak'] for g in got]} (spatial 1 {dpeak}); "
          f"against spatial 1 at its {int(active.sum())} active sites: max "
          f"abs err {err:.3g} (rtol {SPATIAL_DENSE_RTOL} of {scale:.3g}), "
          f"{int((vol.abs().sum(-1) > 0).logical_xor(active).sum())} sites "
          f"active in one alone ({got[0]['s']:.1f}s)")
    if err > SPATIAL_DENSE_RTOL * scale or not scale > 0 or bool(
            (vol.abs().sum(-1) > 0).logical_xor(active).any()):
        fail("spatial-dense: the split encoder differs from the whole one")

    # -- 75: cli.train --spatial-shard 2 on two ranks, the dry run (2, 2)
    t0 = time.perf_counter()
    root = ddp_root(os.path.join(SPATIAL_DIR, "sunrgbd"), DDP_SCENES)
    cfile = merge_cfg_options(load_config(SUNRGBD_CONFIG),
                              [f"data.data_root={root}"])
    mc = build_model_config(cfile)
    bs = cfile.data["samples_per_gpu"]
    wd = os.path.join(SPATIAL_DIR, "cli")
    ranks = spawn("chip_smoke:spatial_cli_rank", 2,
                  (SUNRGBD_CONFIG, root, wd, f"127.0.0.1:{free_port()}",
                   dev.type), device=dev.type, init=False,
                  timeout=DDP_TIMEOUT)
    for r in ranks:
        shard = len(range(r["rank"], DDP_SCENES, 2))
        want = _sum_launches(_times(train_per_step(mc), DDP_SCENES // bs),
                             _times(infer_per_batch(mc), -(-shard // bs)))
        if r["rank"] == 0:
            want["iou3d_rotated_sets"] = r["sets"]
        print(f"[spatial-cli] rank {r['rank']}: {r['step']} steps, epoch "
              f"{r['epoch']}, world size {r['world_size']}, eval "
              f"{r['n_dets']} detections gathered, metric "
              f"{_metric_summary(r['evals'][1]) if r['evals'] else 'none'}; "
              f"weights {r['digest'][:16]}; launches {r['launches']}")
        if cuda and r["launches"] != want or r["step"] != DDP_SCENES // bs:
            fail(f"spatial-cli rank {r['rank']}: steps or launches "
                 f"{r['launches']} != {want}")
        runs.append(r["launches"])
    r0, r1 = ranks
    if not (r0["n_dets"] == DDP_SCENES and r1["n_dets"] == 0
            and r0["evals"] and not r1["evals"]
            and r0["digest"] == r1["digest"]
            and os.path.isdir(os.path.join(wd, "latest"))):
        fail("spatial-cli: rank 0's gather, the metric, equal weights or "
             "the checkpoint")
    secs["cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(4, device=dev.type)
    gcfg = graft_entry.dryrun_config()
    data, _ = graft_entry.dryrun_layout(4)
    for rk in res:
        shard = len(range(rk["rank"], 2 * data + 1, 4))
        want = _sum_launches(train_per_step(gcfg), _times(
            infer_per_batch(gcfg), -(-shard // 2)))
        if rk["layout"] != (2, 2) or cuda and rk["launches"] != want:
            fail(f"spatial-dryrun rank {rk['rank']}: layout {rk['layout']} "
                 f"launches {rk['launches']} != {want}")
        runs.append(rk["launches"])
    secs["dryrun (2, 2)"] = time.perf_counter() - t0
    print(f"[spatial] cli.train --spatial-shard 2: both ranks' weights "
          f"equal, rank 0 holds the {r0['n_dets']} detections and the "
          f"checkpoint; dryrun_multichip(4) in (2, 2), launches a rank as "
          f"one tiny step and its eval shard; host s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    shutil.rmtree(SPATIAL_DIR, ignore_errors=True)
    return runs


# -- convergence: the shipped convergence configs trained from scratch -------

CONV_DIR = os.path.join(_ROOT, "build", "chip_smoke_convergence")
LIDAR_OVERFIT_CONFIG = os.path.join(
    _ROOT, "configs/uni3detr/uni3detr_synthetic_overfit.py")
OV_OVERFIT_CONFIG = os.path.join(
    _ROOT, "configs/ov_uni3detr/ov_uni3detr_synthetic_overfit.py")
# phases 76-77: the JAX package's bars (tests/test_cli_overfit.py)
CONV_BARS = {"lidar": {"mAP_0.25": 0.9, "mAP_0.50": 0.9},
             "ov": {"mAP_0.25": 0.9}}
CONV_KERNELS = {"train": ("match_positions", "gather_conv", "gather_conv_ids",
                          "fps_pair", "gather_conv_dw", "gather_conv_ids_dw",
                          "auction_lap"),
                "test": ("match_positions", "gather_conv", "gather_conv_ids",
                         "fps_pair", "iou3d_rotated", "nms_greedy",
                         "iou3d_rotated_sets")}
INIT_STEPS = 20       # phase 78: flagship steps at B=4 from init_state_dict
LOG_LINE = re.compile(r"epoch (\d+) step (\d+) \| (\S+) it/s \| lr (\S+) \| "
                      r"total (\S+) cls (\S+) bbox (\S+) iou (\S+) ioup "
                      r"(\S+) gnorm (\S+)")


def used_kernels(tag, launches, names):
    """Fail unless every kernel of ``names`` launched in the run."""
    missing = [k for k in names if not launches.get(k)]
    if missing:
        fail(f"{tag}: no launch of {missing} in {launches}")


def convergence_phase(torch, tag, config, bars):
    """One shipped convergence config from scratch: ``cli.train CONFIG
    --work-dir W`` as shipped (its steps, lr, schedule, seed) under a
    :class:`CliWatch` (each step's launches, K1-K4, K7, K10 and K12 in
    the run), the CLI's first weights those of ``init_state_dict(model,
    seed)``; then ``cli.test CONFIG W/latest --eval bbox`` through
    :func:`cli_run` (launches a batch, N1's two-set form a scene,
    ``cli.eval_metric`` equal). Prints the steps, steps/s and wall
    seconds, the loss at every log line and the metric beside the card
    line; fails below a bar of ``bars``. Returns the launches of both
    runs."""
    import numpy as np
    from uni3detr_tpu_torch.cli import train as cli_train
    from uni3detr_tpu_torch.config_file import build_model_config, load_config
    from uni3detr_tpu_torch.data.datasets import build_dataset
    from uni3detr_tpu_torch.weights import init_state_dict

    cfg = load_config(config)
    mc = build_model_config(cfg)
    n_train = len(build_dataset(cfg.data, cfg.class_names, mc.pc_range,
                                "train"))
    steps = cfg.total_epochs * max(n_train // cfg.data["samples_per_gpu"], 1)
    wd = os.path.join(CONV_DIR, tag)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with CliWatch(torch, mc, f"{tag}-train") as w:
        r = cli_train.main([config, "--work-dir", wd])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    run = w.launches()
    if r["step"] != steps or len(w.steps) != steps:
        fail(f"{tag}: {r['step']} steps ({len(w.steps)} watched), the "
             f"config's {steps}")
    used_kernels(f"{tag}-train", run, CONV_KERNELS["train"])
    want = init_state_dict(build_model(mc), cfg.get("seed", 0))
    for k, v in w.first["state"].items():
        if not np.array_equal(v.cpu().numpy(), want[k]):
            fail(f"{tag}: the CLI's first weights differ from "
                 f"init_state_dict at {k}")
    with open(os.path.join(wd, "train.log")) as f:
        lines = LOG_LINE.findall(f.read())
    if len(lines) != steps // cfg.log_config["interval"]:
        fail(f"{tag}: {len(lines)} log lines for {steps} steps")
    for ep, st, its, lr, tot, cls, bbox, iou, ioup, gn in lines:
        print(f"[{tag}] step {st}: total {tot} cls {cls} bbox {bbox} iou "
              f"{iou} ioup {ioup} gnorm {gn} lr {lr} ({its} it/s)")
    if not all(math.isfinite(float(ln[4])) for ln in lines):
        fail(f"{tag}: non-finite losses in train.log")
    print(f"[{tag}] cli.train: {steps} steps in {train_s:.2f} s, "
          f"{steps / train_s:.3f} steps/s, from init_state_dict (seed "
          f"{cfg.get('seed', 0)}); launches {run}")
    t0 = time.perf_counter()
    test_run, res = cli_run(torch, f"{tag}-test", config, None,
                            len(build_dataset(cfg.data, cfg.class_names,
                                              mc.pc_range, "val")),
                            infer_per_batch(mc), os.path.join(wd, "latest"),
                            out_dir=wd)
    used_kernels(f"{tag}-test", test_run, CONV_KERNELS["test"])
    m = res["metrics"]
    print(f"[{tag}] cli.test --eval bbox in {time.perf_counter() - t0:.2f} "
          f"s: " + ", ".join(f"{k} {m[k]:.4f}" for k in sorted(m)
                             if k.startswith("mAP"))
          + f" (bars {bars}) | {card_line()}")
    low = {k: m[k] for k, bar in bars.items() if not m[k] >= bar}
    if low:
        fail(f"{tag}: below the JAX package's bars: {low}")
    return [run, test_run]


def init_phase(torch, dev):
    """Phase 78: ``uni3detr_sunrgbd`` at full width from both init
    functions on one fixed B=4 batch (bf16, as shipped): one step from
    each, its losses and gradient norm printed; then INIT_STEPS steps
    from ``init_state_dict`` (``train_phase``: each step's launches, K1-K4,
    K7, K10 and K12), the total loss at the last below the first.
    Returns the launches of the steps from ``init_state_dict``."""
    from uni3detr_tpu_torch.presets import SUNRGBD
    from uni3detr_tpu_torch.synthetic import clustered_train_batch
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step
    from uni3detr_tpu_torch.weights import init_state_dict, random_state_dict

    cfg = SUNRGBD
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             clustered_train_batch(0, cfg, TRAIN_B).items()}
    sds = {}
    for name, fn in (("random_state_dict", random_state_dict),
                     ("init_state_dict", init_state_dict)):
        model = build_model(cfg)
        sds[name] = {k: torch.from_numpy(v) for k, v in
                     fn(model, WEIGHT_SEED).items()}
        model.load_state_dict(sds[name], strict=True)
        model.to(dev).train()
        logs = train_step(model, make_optimizer(model, TRAIN_LR), batch)
        print(f"[init] first step from {name}: " + " ".join(
            f"{k}={float(v):.5f}" for k, v in sorted(logs.items())
            if "." not in k))
        del model
    losses = []
    launches = train_phase(torch, cfg, sds["init_state_dict"], batch, dev,
                           "init-train", 0, INIT_STEPS, TRAIN_LR,
                           losses=losses)[0]
    used_kernels("init-train", launches, CONV_KERNELS["train"])
    print(f"[init] total loss from init_state_dict: step 1 {losses[0]:.5f}, "
          f"step {INIT_STEPS} {losses[-1]:.5f} | {card_line()}")
    if not losses[-1] < losses[0]:
        fail(f"init: the loss at step {INIT_STEPS} {losses[-1]} is not below "
             f"step 1's {losses[0]}")
    torch.cuda.empty_cache()
    return launches


def convergence(torch, dev):
    """Phases 76-78: the train path from scratch. 76
    ``uni3detr_synthetic_overfit.py`` (600 steps) and 77
    ``ov_uni3detr_synthetic_overfit.py`` (650 steps) through ``cli.train``
    and ``cli.test`` to the JAX package's bars; 78 the flagship from
    ``init_state_dict``. Returns the launches of every run."""
    shutil.rmtree(CONV_DIR, ignore_errors=True)
    runs = []
    for tag, config in (("lidar", LIDAR_OVERFIT_CONFIG),
                        ("ov", OV_OVERFIT_CONFIG)):
        t0 = time.perf_counter()
        runs += convergence_phase(torch, f"converge-{tag}", config,
                                  CONV_BARS[tag])
        print(f"[converge-{tag}] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    runs.append(init_phase(torch, dev))
    print(f"[init] phase {time.perf_counter() - t0:.1f}s")
    shutil.rmtree(CONV_DIR, ignore_errors=True)
    return runs


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    # the test pipeline's image loading and resizing
    import cv2  # noqa: F401
    import PIL  # noqa: F401
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    from uni3detr_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f}s from {cuda_lib.CSRC}")

    t = [time.perf_counter()]
    runs = flagship(torch, dev)
    t.append(time.perf_counter())
    report, more = nuscenes(torch, dev)
    runs += more
    t.append(time.perf_counter())
    scan_reports = []
    for preset in ("uni3detr_scannet", "uni3detr_scannet_large"):
        scan_report, more = scannet(torch, dev, preset)
        scan_reports.append(scan_report)
        runs += more
        t.append(time.perf_counter())
    for preset in ("uni3detr_kitti_car", "uni3detr_kitti_3classes"):
        kitti_report, more = kitti(torch, dev, preset)
        runs += more
        t.append(time.perf_counter())
        if preset == "uni3detr_kitti_car":
            # N1's matrix and two-set forms at KITTI's merge and eval shapes
            report.update(kitti_report)
    runs += ov(torch, dev)
    t.append(time.perf_counter())
    cli_report, more = cli(torch, dev)
    report.update(cli_report)
    runs += more
    t.append(time.perf_counter())
    runs += train_cli(torch, dev)
    t.append(time.perf_counter())
    runs += ddp(torch, dev)
    t.append(time.perf_counter())
    runs += onramps(torch, dev)
    t.append(time.perf_counter())
    runs += options(torch, dev, report)
    t.append(time.perf_counter())
    runs += spatial(torch, dev)
    t.append(time.perf_counter())
    runs += convergence(torch, dev)
    t.append(time.perf_counter())
    # the NMS kernels' numbers at uni3detr_scannet's 5000 boxes
    for name in ("iou3d_rotated", "nms_greedy"):
        report[name] = scan_reports[0][name]
    launches = {}
    for run in runs:
        for k, v in run.items():
            launches[k] = launches.get(k, 0) + v
    names = ("flagship", "nuscenes", "scannet", "scannet_large", "kitti_car",
             "kitti_3classes", "ov", "cli", "train_cli", "ddp", "onramps",
             "options", "spatial", "convergence")
    print("[time] " + ", ".join(f"{n} {t[i + 1] - t[i]:.1f}s"
                                for i, n in enumerate(names))
          + f"; the whole smoke {time.perf_counter() - T_START:.1f}s")

    sp = "uni3detr_tpu/ops/sparse_conv_pallas.py"
    meta = {
        "match_positions": ("sparse_conv.cu", f"{sp}:944"),
        "gather_conv": ("sparse_conv.cu", f"{sp}:355, {sp}:150"),
        "gather_conv_ids": ("sparse_conv.cu", f"{sp}:619, {sp}:726"),
        "fps_pair": ("fps.cu", "uni3detr_tpu/ops/fps.py:123"),
        "gather_conv_dw": ("sparse_conv.cu", f"{sp}:444, {sp}:267"),
        "gather_conv_ids_dw": ("sparse_conv.cu", f"{sp}:646, {sp}:758"),
        "auction_lap": ("matching.cu",
                        "uni3detr_tpu/ops/matching_pallas.py:46"),
        "fps": ("fps.cu", "uni3detr_tpu/ops/fps.py:104"),
        "iou3d_rotated": ("nms.cu", "uni3detr_tpu/geom/iou.py:60"),
        "nms_greedy": ("nms.cu", "uni3detr_tpu/ops/nms.py:45"),
        "iou3d_rotated_matrix": ("nms.cu", "uni3detr_tpu/geom/iou.py:120"),
        "iou3d_rotated_sets": ("nms.cu", "uni3detr_tpu/geom/iou.py:120"),
        "iou_bev_rotated_sets": ("nms.cu", "uni3detr_tpu/geom/iou.py:107"),
        "iou_bev_rotated_mask": ("nms.cu", "uni3detr_tpu/geom/iou.py:107"),
        "soft_nms": ("nms.cu", "uni3detr_tpu/ops/nms.py:103"),
    }
    kernels = [dict(name=name, route="cuda",
                    source=f"uni3detr_tpu_torch/csrc/{src}", replaces=rep,
                    launches=launches[name], **_report_entry(report[name]))
               for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
