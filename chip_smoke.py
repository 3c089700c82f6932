#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dvmvs_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
hand-written kernels from ``dvmvs_tpu_torch/csrc`` (the plane sweep, its
backward and DELTAS's DLT solve, one nvcc each, in parallel) and drives
every path of the port:

  - online: the forward kernel against its plain PyTorch version at the
    online path's shape (eight geometries and modes, C=30 and C=64; its
    small-channel variant at C=1 and C=4 in both modes) and at 640x480
    frames, its timing at both beside its bound (the least time the
    card could take), a synthetic 320x256 scene through the online fusionnet
    loop (``predict_stream`` -> keyframe buffer -> ``InferenceEngine``) with
    seeded random weights, and agreement with the same engine on the CPU;
  - training: the forward kernel with one view (K3/K4) and the backward
    kernel (K5/K6) against the plain version and autograd through it at the
    training shape and around it (C=64, C=13, an unaligned meas, a ragged
    size, a wide motion whose taps outgrow the backward's bins, a motion 1 m
    back that overfills them, the online shape with a masked view, 5 views;
    d_ref bit-identical over two calls), their timing, ``run_training.main``
    on a synthetic 256x256 corpus (each train and validation step a CUDA
    graph replay, the default: fusionnet B=4 S=8 through all three stages
    with validation, then pairnet B=14, then one more fusionnet epoch
    resumed from the first run's state with ``--no-graphs`` and one more
    from that state through the graphs), a short overfit, [train-graphs]
    (fusionnet B=4 S=8 and two-way pairnet B=14 through the graphed and the
    eager step, three steps each from the eager run's state before it, with
    the capturable Adam: parameters, BatchNorm buffers, Adam moments, step
    counts and losses bit for bit or within the larger of 1e-4 and the
    eager path's own run-to-run gap, the leaves whose gradient is rounding
    noise left out, the plane-sweep kernels counted at the replays, one
    ``cudaGraphLaunch`` and no kernel launch a step, and a planted fault, an
    Adam state reassigned instead of written in place, shown to break the
    comparison), and one
    train step on the card against the same step on the CPU;
  - bulk evaluation and TSDF: the forward kernel at the batched shape (B=8,
    a geometry per element, masked views), three synthetic scenes stored at
    640x480 (written with the port's PNG writer, indexed by its keyframe
    simulator, read through its OpenCV-free crop and resize) through every
    mode of ``apps/run_testing.py`` at ``TestConfig`` (sequential, batched
    pairnet B=8, scanned, bfloat16 banks, lockstep fusionnet over the three
    scenes), each held against the sequential depths, the batched paths'
    cost volumes against the sequential ones with planted faults (a wrong
    feature row, swapped views) shown to break those limits, the first
    keyframes against the CPU, then ``run_tsdf`` on saved predictions on the
    card and the CPU, the integrate's time at 1.26M voxels, and the online
    driver with a live TSDF volume;
  - baselines: the forward kernel in L1 mode at MVDepthNet's and GP-MVS's
    shape (normalised RGB, C=3, at 256x320, planes at 0.5-50 m) against its
    plain version (also on a ragged 255x317) and timed beside its bound,
    then MVDepthNet, GP-MVS,
    DPSNet and DELTAS (their ``predict`` as CUDA graph replays, the default)
    through ``run_testing_baseline.evaluate_scene_baseline`` over one 640x480
    synthetic scene and its index file (ms a keyframe, peak memory,
    launches), each held against the same code on the CPU; then
    [baseline-graphs]: each baseline graphed and eager in turns over those
    keyframes, the depths bit for bit (at most BASELINE_RTOL; DELTAS on its
    depth before the clip), one ``cudaGraphLaunch`` a ``predict`` (two for
    GP-MVS around its host Kalman step) and no kernel launch, the forward
    kernel once a keyframe inside the U-Nets' graphs and the DLT-solve
    kernel once a keyframe inside DELTAS's; then [dlt]: the DLT-solve
    kernel (``csrc/dlt_solve.cu``) against its plain version
    (``torch.linalg.svd``) on DELTAS's systems of those keyframes and on a
    seeded batch with masked views, on the points DELTAS keeps and on every
    homogeneous solution, and its time beside one near-empty kernel's (the
    launch floor) and its bound;
  - data parallel over NCCL at world size 1 (``parallel/mesh.py``):
    ``dryrun_multichip(1)``, one pairnet (B=14) and one fusionnet (B=4,
    S=8) step at 256x256 through the data-parallel path against the plain
    step (loss and BatchNorm buffers bit for bit, updated parameters within
    the plain step's own repeat gap); the graphed data-parallel step (its
    all-reduces inside the graph) against the eager one under [train-graphs]'
    rules (three steps from the eager run's state, the eager repeat's gap,
    the planted fault, one ``cudaGraphLaunch`` a step), the two timed in
    turns; and ``run_testing --n-devices 1 --batch-size 8`` on the bulk
    scenes, its engine's steps graph replays, against the plain batched
    run;
  - the accuracy proxy's driver (``apps/accuracy_proxy.py``) end to end at a
    smoke's size: corpus, pairnet then fusionnet training, evaluation of
    both best checkpoints and the report;
  - CUDA graphs ([graphs]): the engine runs each serving step as one graph
    replay by default (``apps/graphs.py``). The 40-frame stream, fusionnet
    and pairnet, through a graphed and an eager engine: depths and kept
    features bit for bit (at most REF_RTOL), cost volumes within CV_RTOL,
    one forward launch counted a replay, and a profiled pass showing each
    ``encode_and_predict`` as one ``cudaGraphLaunch`` and no kernel launch
    besides its copies; ``run_testing``'s pairnet B=8 and lockstep
    fusionnet chunks of 4 (one replay a chunk) with float32 and bfloat16
    banks against the eager sequential depths and the eager chunks' cost
    volumes; and planted faults (kept features that alias the output
    buffer, a state reassigned instead of written in place) shown to break
    those limits;
  - real data (``data/synth_scannet.py``): a ScanNet-layout .sens of the
    committed 1296x968 JPEGs (decoded by the port's own decoder and held to
    OpenCV's pixel digests) and 640x480 depths rendered here, exported by
    the ScanNet exporter (test and training layouts), indexed, evaluated
    by ``run_testing`` (pairnet B=8, fusionnet) and ``run_testing_online
    --visualize`` from JAX-layout msgpack checkpoints (``save_jax_checkpoint``)
    bit for bit against the same weights put into the engine directly,
    reconstructed by ``run_tsdf`` and ``point_cloud``, and two fusionnet
    training steps warm-started from the pairnet msgpack.

  - arithmetic ([precision]): torch's TF32 defaults are left as they are,
    so every phase shows that the entry points pin IEEE float32 themselves
    (``utils/precision.py``); [precision] holds the online loop, an
    MVDepthNet ``predict`` and a graphed training step, each run in those
    defaults, bit for bit against the same step under an explicit IEEE
    setting, and shows that the pin bypassed (the step in TF32) breaks that
    limit, with both modes' times.

Each path runs with the launch counts set to 0 just before it and read just
after. Each phase prints its lines; any failure raises, so the exit code is
non-zero. It imports nothing of the JAX package, nor jax, nor OpenCV.

Output: phase lines, then the card's ``name, power.limit``, one JSON line
with the kernels' measurements, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import tempfile
import time

import numpy as np

ONLINE = (1, 2, 32, 128, 160, 64)  # (B, V, C, H, W, P): the cost volume at 320x256 frames
FRAMES_640 = (1, 2, 32, 240, 320, 64)  # 640x480 frames, beyond what the TPU kernels held
P = ONLINE[5]
# absolute: the JAX kernel tests' 5e-4 for the dot cost, which averages over
# channels; the L1 cost sums over them, and its measured 7.7e-4 gap (coordinate
# fold against normalised grids, C=32) gets about 2.5x room. Restated for the
# baselines' C=3 (RGB normalised by (x - 81) / 35, costs up to about 12): the
# gap does not shrink with C, because each sample's error comes from its
# coordinate and a view of weight 1 carries it undiluted; measured 3.8e-4
# with two views and 7.1e-4 with one view masked (the l1_rgb cases below,
# NVIDIA H100 80GB HBM3, 700 W), so the same 2e-3 keeps about 2.8x room
TOL = {True: 5e-4, False: 2e-3}
N_FRAMES, N_MIN_KEYFRAMES, N_REF_KEYFRAMES = 40, 8, 3
# card vs CPU depth, relative: the measured gap is 2.5e-7, and random weights
# keep the depths in a narrow band, so the limit must be tight to catch a fault
REF_RTOL = 1e-5

# training shape: half-resolution features of the 256x256 training frames
TB, TC, TH, TW = 4, 32, 128, 128
GRAD_ATOL = 2e-4  # times max(|grad|, 1): tests/test_pallas_vjp.py's gradient limit
TRAIN_STEPS, PAIR_STEPS = 3, 2  # optimizer steps per epoch (one epoch per stage)
# corpus: (seed, frames) of the training and the validation scene; at 3 cm a
# frame they crawl into 17 and 8 subsequences of 8 frames
TRAIN_SCENE, VAL_SCENE = (100, 100), (101, 60)
# card vs CPU train step (64x64, S=3, B=2, P=16), tests/test_torch_training.py's
# limits: loss and BatchNorm statistics relative; gradients per tensor with
# frozen BatchNorm, per module (relative L2) with train-mode BatchNorm, whose
# float32 gradients are ill-conditioned at that size
STEP_RTOL, FROZEN_GRAD_TOL, TRAIN_GRAD_L2 = 1e-4, 2e-3, 0.1

# bulk evaluation: the forward kernel at the batched pairnet shape, eight
# geometries with the second view masked in every other element
BULK = (8, 2, 32, 128, 160, 64)
# three synthetic scenes stored at 640x480 (read through the crop and resize
# to 320x256): (seed, frames); in the last, frames 16..47 have no pose, so
# the index file gets a TRACKING LOST line
BULK_SCENES, BULK_LOST = ((11, 32), (12, 32), (13, 64)), (13, 16, 48)
BULK_FRAME, BULK_STEP, BULK_DATASET = (640, 480), 0.05, "synth640"
BULK_BATCH, BULK_SCAN = 8, 4
# batched and scanned against sequential depths: the JAX tests' atol
# (tests/test_drivers_e2e.py) with float32 banks; with bfloat16 banks 1e-5 m,
# from the measured 4.2e-7 m. Seeded weights keep the depth in a narrow band
# where a wrong feature row moves it by about 1e-6 m, so [bulk-faults] holds
# the cost volumes instead, max |diff| over max |sequential| a keyframe:
# measured 3.4e-7 (float32) and 1.8e-3 (bfloat16) against 0.14 and more with
# a planted fault (a wrong feature row, swapped views), which must break both
BULK_ATOL, BF16_ATOL = 1e-4, 1e-5
CV_RTOL, CV_BF16_RTOL = 1e-4, 1e-2
# TSDF: card against CPU, tsdf values (colour and weight must be equal); at
# most this share of the voxels may differ (a pixel rounded at a .5 tie)
TSDF_ATOL, TSDF_FLIP_SHARE = 1e-5, 1e-4
TSDF_VOXEL, TSDF_CUBE = 0.05, 5.4  # 108^3 = 1.26M voxels for the timing


# the baselines' sweep: MVDepthNet and GP-MVS send the normalised RGB frames
# (C=3) at full 256x320 through the forward kernel in L1 mode, 64 planes at
# 0.5-50 m (one launch a keyframe)
BASELINE_SWEEP, BASELINE_DEPTHS = (1, 2, 3, 256, 320, 64), (0.5, 50.0)
# [baselines]: (seed, frames) of one 640x480 SynthScene folder, the keyframes
# each baseline predicts on the card, and how many of the first ones are held
# against the same code on the CPU (3 for the U-Nets, so the Kalman state
# carries across frames; 1 for DPSNet and DELTAS, slow on the CPU at full size)
BASELINE_SCENE, BASELINE_KEYFRAMES = (11, 32), 8
BASELINE_REF = {"mvdepthnet": 3, "gpmvs": 3, "dpsnet": 1, "deltas": 1}
BASELINE_RTOL = 1e-5
# [baseline-graphs]: graph launches a predict (GP-MVS: encoder and decoder
# around its host Kalman step; DELTAS: one, its DLT solve a kernel inside)
# and the passes of each path, in turns, over the [baselines] keyframes
BASELINE_GRAPHS = {"mvdepthnet": 1, "gpmvs": 2, "dpsnet": 1, "deltas": 1}
BASELINE_ROUNDS = 2
# [dlt]: the DLT-solve kernel against its plain version, torch.linalg.svd in
# float32, and against the same call in float64 (the exact solution of the
# float32 systems, to float32 rounding): the points DELTAS keeps (depth inside
# its range on either side) within DLT_TOL of their largest coordinate, the
# limit of tests/test_torch_deltas.py, and every homogeneous solution
# [p, 1] / |[p, 1]| (up to its sign) within DLT_TOL: a point far out of range
# keeps no float32 digit in p = x / w (tests/test_torch_dlt.py). The binding
# limit is float64's: there the kept points, the range-masked points (DELTAS's
# own range_mask on the scene, every point of the seeded batch) and the
# homogeneous solutions must each be within DLT_TOL (measured 1e-7). This
# stands in for a flat DLT_TOL against the float32 plain version, which the
# plain version itself does not meet: on the card, cuSOLVER's float32 solve of
# near rank-deficient systems (a view at 0.001 confidence beside a masked one)
# stands up to 6.4e-4 from float64 where the kernel stands 1e-7 from it and
# the CPU's LAPACK 2.2e-5 (measured on an NVIDIA H100 80GB HBM3 at 700 W). So
# against float32 each of the three gaps is held to DLT_TOL plus that
# version's own gap to float64. The seeded batch
# (sweep_measure.dlt_case: masked views, near rank-deficient and noise-free
# systems) has DLT_BATCH elements of DELTAS's 512 keypoints and 3 cameras
DLT_TOL, DLT_BATCH = 1e-4, 8

# [precision]: the quantity on which a step in TF32 must break REF_RTOL
# (apps/bench_precision.py's names). Seeded weights keep the depths nearly
# flat (MVDepthNet's within about 2% of 1 m), so MVDepthNet's depth is held
# against its spread (max - min), the cost volumes and the training step's
# metrics against their largest value. Measured TF32 against IEEE (NVIDIA
# H100 80GB HBM3, 700 W): the online cost volume 7.5e-5, MVDepthNet's depth
# 1.3e-3 of its spread (2.6e-5 of its largest value), the training metrics
# 8.4e-4
PRECISION_SHOWS = {"online": "cost_volume_max_rel", "mvdepthnet": "depth_over_spread",
                   "train": "metrics_max_rel"}

PAIR_BATCH = 14  # pairnet's training batch
# [train-graphs]: steps a path, each taken from the eager path's state before
# it (copied in place into the path's own tensors, where a graph reads them).
# One step from one state repeats itself but for rounding: the backward
# kernel's d_meas, bilinear upsampling and grid_sample sum by atomics in no
# fixed order, which moves the Adam moments by 2e-6-2e-4 (relative L2, the
# noise leaves left out) between two eager runs. Steps from each run's own last state amplify that
# instead (Adam's first step is the gradient's sign): two eager runs of three
# steps each from its own last state (the "free-running" reading) differ by
# a large share of their moments, and a fault reads little above that, in
# every leaf, not only the noise ones. Leaves whose gradient is rounding noise
# (BatchNorm shifts that reach the loss only through another train-mode
# BatchNorm, which subtracts them) are left out of the parameters and moments
# where the eager repeat moves their first moment by more than NOISE_LEAF
# (they may hold at most NOISE_SHARE of the values). Every quantity is then
# held within the larger of EAGER_GAP_FACTOR times the eager path's own
# run-to-run gap and STEP_RTOL, the [train-ref] loss limit, over every step
GRAPH_STEPS, EAGER_GAP_FACTOR, NOISE_LEAF, NOISE_SHARE = 3, 4, 1e-2, 1e-3
# [train-graphs]: the step timing of profile_step.train_paths, cut to size
GRAPH_TIMING = {"n_warmup": 1, "n_timed": 3, "n_rounds": 1}
# [real-data]: run_testing's pairnet batch; the seed of the weights written as
# JAX checkpoints (the drivers' engines start from seed 0, so the file decides)
REAL_BATCH, REAL_SEED = 8, 7
# [proxy]: the driver at a smoke's size (24 frames crawl into 20 training
# subsequences of 3 and one validation subsequence, hence batch 1)
PROXY_ARGS = ["--train-scenes", "2", "--val-scenes", "1", "--eval-scenes", "1",
              "--frames", "24", "--pair-batch", "4", "--fusion-batch", "1", "--subseq", "3",
              "--epochs", "2", "--fusion-epochs", "3", "--finetune-epochs", "1",
              "--max-steps", "2"]


def _with_c(shape, c):
    return shape[:2] + (c,) + shape[3:]


# name -> (shape, euler of view 0, translation of view 0, view weights, dot product)
CASES = {
    "lateral": (ONLINE, (0, 0, 0), (0.12, 0.0, 0.0), (0.5, 0.5), True),
    "typical": (ONLINE, (2, 3, 1), (0.12, 0.03, 0.02), (0.5, 0.5), True),
    "roll_forward": (ONLINE, (0, 0, 4), (0.05, 0.0, 0.1), (0.5, 0.5), True),
    "extreme_roll_35": (ONLINE, (0, 0, 35), (0.1, 0.0, 0.0), (0.5, 0.5), True),
    "behind_camera_yaw_120": (ONLINE, (0, 120, 0), (0.1, 0.0, 2.0), (0.5, 0.5), True),
    "masked_view": (ONLINE, (2, 3, 1), (0.12, 0.03, 0.02), (1.0, 0.0), True),
    "c30": (_with_c(ONLINE, 30), (2, 3, 1), (0.12, 0.03, 0.02), (0.5, 0.5), True),
    "c64": (_with_c(ONLINE, 64), (2, 3, 1), (0.12, 0.03, 0.02), (0.5, 0.5), True),
    "l1": (ONLINE, (2, 3, 1), (0.12, 0.03, 0.02), (0.5, 0.5), False),
    "frames_640x480": (FRAMES_640, (2, 3, 1), (0.12, 0.03, 0.02), (0.5, 0.5), True),
    # (..., depth range of the planes)
    "l1_rgb_256x320": (BASELINE_SWEEP, (2, 3, 1), (0.12, 0.03, 0.02), (0.5, 0.5), False,
                       BASELINE_DEPTHS),
    "l1_rgb_256x320_masked": (BASELINE_SWEEP, (2, 3, 1), (0.12, 0.03, 0.02), (1.0, 0.0), False,
                              BASELINE_DEPTHS),
    # the small-channel variant (C <= 4) beside the RGB cases: C=1 and C=4 in
    # both modes, and C=3 on tiles and rows the image does not fill
    "c1": (_with_c(ONLINE, 1), (2, 3, 1), (0.12, 0.03, 0.02), (0.5, 0.5), True),
    "c1_l1": (_with_c(ONLINE, 1), (2, 3, 1), (0.12, 0.03, 0.02), (0.5, 0.5), False),
    "c4": (_with_c(ONLINE, 4), (2, 3, 1), (0.12, 0.03, 0.02), (0.5, 0.5), True),
    "c4_l1": (_with_c(ONLINE, 4), (2, 3, 1), (0.12, 0.03, 0.02), (0.5, 0.5), False),
    "l1_rgb_255x317": ((1, 2, 3, 255, 317, 64), (2, 3, 1), (0.12, 0.03, 0.02), (0.5, 0.5), False,
                       BASELINE_DEPTHS),
}


def lap(state):
    """Seconds since the previous lap (each phase prints its own time)."""
    now = time.perf_counter()
    dt, state[0] = now - state[0], now
    return dt


LATERAL, TYPICAL = ((0, 0, 0), (0.12, 0.0, 0.0)), ((2, 3, 1), (0.12, 0.03, 0.02))
ROLL_35, YAW_120 = ((0, 0, 35), (0.1, 0.0, 0.0)), ((0, 120, 0), (0.1, 0.0, 2.0))
# 1 m across and 0.5 m up: the taps of a tile's 8-plane chunk spread over
# more source pixels than the backward kernel bins (about half the chunks);
# 1 m back: the image shrinks, and more samples fall on one source pixel than
# a bin holds
WIDE, BACK = ((0, 0, 0), (1.0, 0.5, 0.0)), ((0, 0, 0), (0.0, 0.0, -1.0))


def train_case(torch, ps, seed, geometries, c, device, hw=(TH, TW), weights=(1.0,),
               offset=False):
    """Backward inputs at the training shape unless told otherwise, one
    geometry (euler, t) per batch element: ref (B,H,W,C), meas (B,V,H,W,C),
    mats (B,V,P,3,3), view weights (B,V) and a cotangent (B,P,H,W). View v
    has its element's rotation and v/2 + 1 times its translation. With
    ``offset`` meas starts one float into its storage (no 16-byte loads)."""
    from dvmvs_tpu_torch.ops.cost_volume import inverse_depth_planes
    from dvmvs_tpu_torch.ops.sweep_measure import pose

    rs = np.random.RandomState(seed)
    b, v, (h, w) = len(geometries), len(weights), hw
    ref = torch.from_numpy(rs.randn(b, h, w, c).astype(np.float32)).to(device)
    meas = torch.from_numpy(rs.randn(b, v, h, w, c).astype(np.float32)).to(device)
    g = torch.from_numpy(rs.randn(b, P, h, w).astype(np.float32)).to(device)
    if offset:
        buf = torch.empty(meas.numel() + 1, device=device)
        buf[1:] = meas.reshape(-1)
        meas = buf[1:].view(meas.shape)
    K = torch.tensor([[0.75 * w, 0, w / 2], [0, 0.75 * w, h / 2], [0, 0, 1]], device=device)
    poses = np.stack([[pose(*e, np.multiply(t, 1 + i / 2)) for i in range(v)]
                      for e, t in geometries])
    mats = ps.build_plane_matrices(torch.eye(4, device=device), torch.from_numpy(poses).to(device),
                                   K, inverse_depth_planes(0.25, 20.0, P, device))
    return ref, meas, mats.contiguous(), torch.tensor([weights] * b, device=device), g


# name -> train_case options: the TB batch elements' geometries (default
# TYPICAL), C, (H, W), view weights, meas at an unaligned offset
BWD_CASES = {
    "lateral": {"geometries": [LATERAL] * TB},
    "typical": {},
    "extreme_roll_35": {"geometries": [ROLL_35] * TB},
    "behind_camera_yaw_120": {"geometries": [YAW_120] * TB},
    "c30": {"c": 30},
    "mixed_batch": {"geometries": [LATERAL, TYPICAL, ROLL_35, YAW_120]},
    "c64": {"c": 64},
    "c13_scalar": {"c": 13},
    "unaligned_meas": {"offset": True},
    "ragged_37x45": {"hw": (37, 45)},
    "wide_diagonal": {"geometries": [WIDE] * TB},
    "backward_1m": {"geometries": [BACK] * TB},
    "online_masked": {"geometries": [TYPICAL], "hw": ONLINE[3:5], "weights": (1.0, 0.0)},
    "views_5": {"weights": (0.3, 0.25, 0.2, 0.15, 0.1)},
}


def bwd_case(torch, ps, seed, name, device):
    """The inputs of BWD_CASES[name] (train_case's result)."""
    options = {"geometries": [TYPICAL] * TB, "c": TC, **BWD_CASES[name]}
    return train_case(torch, ps, seed, options.pop("geometries"), options.pop("c"), device,
                      **options)


def write_corpus(root, size=256, workers=8):
    """The training layout (per-frame npz with depth in mm, poses.txt, K.txt,
    train.txt, validation.txt) of TRAIN_SCENE and VAL_SCENE, rendered at the
    training size (no resize) by ``workers`` spawned processes."""
    from dvmvs_tpu_torch.apps.make_synth_scenes import render_scenes, write_train_scene

    scenes = (TRAIN_SCENE, VAL_SCENE)
    for (seed, _), frames in zip(scenes, render_scenes(scenes, size, size, workers)):
        write_train_scene(os.path.join(root, f"scene_{seed}"), seed, frames, size, size)
    for split, (seed, _) in zip(("train", "validation"), scenes):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write(f"scene_{seed}\n")


BULK_GEOMETRIES = [LATERAL, TYPICAL, ROLL_35, YAW_120, ((0, 0, 4), (0.05, 0.0, 0.1)), WIDE, BACK,
                   ((5, -4, 2), (0.08, -0.05, 0.04))]


def bulk_case(torch, ps, seed, device):
    """Forward inputs at the BULK shape: one geometry per batch element, the
    second view masked (weights 1, 0) in the odd elements."""
    b, v, c, h, w, _ = BULK
    ref, meas, mats, _, _ = train_case(torch, ps, seed, BULK_GEOMETRIES[:b], c, device,
                                       hw=(h, w), weights=(0.5,) * v)
    weights = torch.tensor([(0.5, 0.5) if i % 2 == 0 else (1.0, 0.0) for i in range(b)],
                           device=device)
    return ref, meas, mats, weights


def bulk_phases(torch, device, cfg, card, clock, tmp):
    """[bulk-scenes], [bulk], [bulk-reference], [tsdf] and [live-tsdf];
    returns the forward launches and timings of the batched pairnet run."""
    from dvmvs_tpu_torch.apps import run_testing as rt
    from dvmvs_tpu_torch.apps import run_testing_online, run_tsdf
    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.apps.simulate_keyframe_buffer import simulate_dataset
    from dvmvs_tpu_torch.data.io import load_depth_png
    from dvmvs_tpu_torch.data.scene_folders import write_scene_folders
    from dvmvs_tpu_torch.ops import tsdf
    from dvmvs_tpu_torch.ops.sweep_measure import TIMER, time_ms
    from dvmvs_tpu_torch.utils.results import save_results

    # [bulk-scenes]: 640x480 scene folders and their index files
    folders = write_scene_folders(os.path.join(tmp, BULK_DATASET), BULK_SCENES, BULK_FRAME,
                                  BULK_STEP, BULK_LOST)
    simulate_dataset(os.path.join(tmp, BULK_DATASET), os.path.join(tmp, "indices"), 2)
    jobs = [(f, os.path.join(tmp, "indices", f"keyframe+{BULK_DATASET}+{os.path.basename(f)}"
                                              f"+nmeas+2")) for f in folders]
    lines = [rt.read_index(index) for _, index in jobs]
    if "TRACKING LOST" not in lines[-1]:
        raise AssertionError("the scene without poses got no TRACKING LOST line")
    # the timed modes read warm frame caches and no ground truth, so they
    # time the device path and the driver, not the PNG decode
    t0 = time.perf_counter()
    assets = [rt.SceneAssets(f, cfg, evaluate=False) for f, _ in jobs]
    for a in assets:
        for name in a.image_filenames:
            a.image(name)
    n_images = sum(len(a.image_filenames) for a in assets)
    host_ms = (time.perf_counter() - t0) * 1e3 / n_images
    t0 = time.perf_counter()
    gt = assets[0].preprocessor.apply_depth(load_depth_png(
        os.path.join(jobs[0][0], "depth", assets[0].image_filenames[0])))
    gt_ms = (time.perf_counter() - t0) * 1e3
    keyframes = [sum(line != "TRACKING LOST" for line in ls) for ls in lines]
    print(f"[bulk-scenes] {len(folders)} scenes ({', '.join(map(str, keyframes))} keyframes, "
          f"{n_images} frames at {BULK_FRAME[0]}x{BULK_FRAME[1]}) written with write_png and "
          f"indexed by simulate_keyframe_buffer; PNG decode + crop + resize to "
          f"{cfg.image_width}x{cfg.image_height} without OpenCV {host_ms:.1f} ms a frame on the "
          f"host, a depth map {gt_ms:.1f} ms ({gt.shape[1]}x{gt.shape[0]}) ({lap(clock):.1f} s)",
          flush=True)

    # [bulk]: every mode twice (the first warms the convolutions up), timed
    # and checked on the second, with warm host caches
    n_kf = sum(keyframes)
    cache = {os.path.abspath(f): a for (f, _), a in zip(jobs, assets)}
    pair = InferenceEngine("pairnet", cfg, device=device, seed=0)
    fusion = InferenceEngine("fusionnet", cfg, device=device, seed=0)

    def per_scene(fn):
        return lambda: [fn(f, index, a) for (f, index), a in zip(jobs, assets)]

    modes = {
        "pairnet sequential": (per_scene(lambda f, i, a: rt.evaluate_scene(
            pair, f, i, cfg, evaluate=False, assets=a)[0]), n_kf),
        f"pairnet batched B={BULK_BATCH}": (per_scene(lambda f, i, a: rt.evaluate_scene_batched(
            pair, f, i, cfg, BULK_BATCH, evaluate=False, assets=a, bank_dtype="f32")[0]),
            sum(-(-k // BULK_BATCH) for k in keyframes)),
        f"pairnet scanned B={BULK_BATCH} chunk {BULK_SCAN}": (per_scene(
            lambda f, i, a: rt.evaluate_scene_batched(
                pair, f, i, cfg, BULK_BATCH, evaluate=False, assets=a, scan_chunk=BULK_SCAN,
                bank_dtype="f32")[0]), sum(-(-k // BULK_BATCH) for k in keyframes)),
        f"pairnet batched B={BULK_BATCH} bf16 bank": (per_scene(
            lambda f, i, a: rt.evaluate_scene_batched(
                pair, f, i, cfg, BULK_BATCH, evaluate=False, assets=a, bank_dtype="bf16")[0]),
            sum(-(-k // BULK_BATCH) for k in keyframes)),
        "fusionnet sequential": (per_scene(lambda f, i, a: rt.evaluate_scene(
            fusion, f, i, cfg, evaluate=False, assets=a)[0]), n_kf),
        f"fusionnet lockstep x{len(jobs)}": (lambda: [p for p, _ in rt.evaluate_scenes_batched_fusion(
            fusion, jobs, cfg, evaluate=False, asset_cache=cache, bank_dtype="f32")],
            max(keyframes)),
        f"fusionnet lockstep x{len(jobs)} chunk {BULK_SCAN}": (
            lambda: [p for p, _ in rt.evaluate_scenes_batched_fusion(
                fusion, jobs, cfg, evaluate=False, asset_cache=cache, scan_chunk=BULK_SCAN,
                bank_dtype="f32")], max(keyframes)),
        f"fusionnet lockstep x{len(jobs)} bf16 bank": (
            lambda: [p for p, _ in rt.evaluate_scenes_batched_fusion(
                fusion, jobs, cfg, evaluate=False, asset_cache=cache, bank_dtype="bf16")],
            max(keyframes)),
    }
    runs = {}
    for name, (fn, min_launches) in modes.items():
        fn()
        depths, seconds, peak, fwd, bwd = timed_run(torch, fn)
        if bwd or fwd < min_launches:
            raise AssertionError(f"{name}: kernels launched {fwd} forward (want >= "
                                 f"{min_launches}) and {bwd} backward (want 0)")
        flat = [d for scene in depths for d in scene]
        if len(flat) != n_kf or not all(np.isfinite(d).all() and d.shape == (
                cfg.image_height, cfg.image_width) for d in flat):
            raise AssertionError(f"{name}: {len(flat)} depths of {n_kf}, or bad values")
        base = runs.get("pairnet sequential" if name.startswith("pairnet")
                        else "fusionnet sequential")
        gap, tol = None, BF16_ATOL if "bf16" in name else BULK_ATOL
        if base is not None:
            gap = max_gap(flat, base["flat"])
            if not gap <= tol:
                raise AssertionError(f"{name}: depths {gap:.3e} from the sequential run")
        runs[name] = {"flat": flat, "seconds": seconds, "peak": peak, "fwd": fwd,
                      "kf_per_s": n_kf / seconds}
        print(f"[bulk] {name}: {n_kf} keyframes over {len(jobs)} scenes in {seconds:.3f} s "
              f"({n_kf / seconds:.1f} keyframes/s), peak memory {peak:.1f} MiB, forward kernel "
              f"launches {fwd} (>= {min_launches}), backward 0"
              + (f", max |depth - sequential| {gap:.3e} m (tol {tol:g})"
                 if gap is not None else "")
              + f" ({lap(clock):.1f} s) | {card}", flush=True)

    # [bulk-faults]: the cost volumes a keyframe of the batched pairnet run
    # (first scene) and of the lockstep run (all scenes) against the
    # sequential ones, with each bank dtype, then with a fault planted in the
    # bank's read; the sound runs must stay within the limits and every
    # fault must break the looser one
    def rows(engine, fn):
        with engine.recording_cost_volumes() as calls:
            fn()
        return [r for c in calls for r in c]

    def lockstep_rows(flat):
        """Row s of lockstep step t is scene s's keyframe t: scene by scene."""
        return [r for s, k in enumerate(keyframes) for r in flat[s::len(jobs)][:k]]

    want = {"pairnet": rows(pair, lambda: rt.evaluate_scene(pair, *jobs[0], cfg, evaluate=False,
                                                            assets=assets[0])),
            "fusionnet": rows(fusion, lambda: [rt.evaluate_scene(
                fusion, *job, cfg, evaluate=False, assets=a) for job, a in zip(jobs, assets)])}
    runs_cv = {
        "pairnet": lambda dtype: rows(pair, lambda: rt.evaluate_scene_batched(
            pair, *jobs[0], cfg, BULK_BATCH, evaluate=False, assets=assets[0],
            bank_dtype=dtype))[:keyframes[0]],
        "fusionnet": lambda dtype: lockstep_rows(rows(
            fusion, lambda: rt.evaluate_scenes_batched_fusion(
                fusion, jobs, cfg, evaluate=False, asset_cache=cache, bank_dtype=dtype))),
    }
    real = InferenceEngine.gather_features
    faults = {"measurement rows shifted by one": lambda bank, r, m: (
                  bank, r, (m + 1) % bank[0].shape[0]),
              "views swapped": lambda bank, r, m: (bank, r, m.flip(1))}
    for kind, run in runs_cv.items():
        gaps = {"f32": cv_gap(run("f32"), want[kind]), "bf16": cv_gap(run("bf16"), want[kind])}
        for fault, bend in faults.items():
            InferenceEngine.gather_features = staticmethod(
                lambda bank, r, m, bend=bend: real(*bend(bank, r, m)))
            try:
                gaps[fault] = cv_gap(run("f32"), want[kind])
            finally:
                InferenceEngine.gather_features = staticmethod(real)
        print(f"[bulk-faults] {kind} {'batched' if kind == 'pairnet' else 'lockstep'}: cost "
              f"volume gap to sequential (max |diff| / max |sequential| a keyframe) "
              + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
              + f" (limits f32 {CV_RTOL:g}, bf16 {CV_BF16_RTOL:g}; each fault must exceed "
              f"{CV_BF16_RTOL:g}; {lap(clock):.1f} s)", flush=True)
        if not (gaps["f32"] <= CV_RTOL and gaps["bf16"] <= CV_BF16_RTOL
                and all(gaps[f] > CV_BF16_RTOL for f in faults)):
            raise AssertionError(f"{kind}: cost volume limits broken by a sound run, or a "
                                 "planted fault not caught")

    # [bulk-reference]: the first keyframes of the sequential fusionnet run
    # on the CPU with the same seeded weights
    cpu = InferenceEngine("fusionnet", cfg, device="cpu", seed=0)
    want, _ = rt.evaluate_scene(cpu, *jobs[0], cfg, evaluate=False, max_frames=N_REF_KEYFRAMES,
                                assets=assets[0])
    got = runs["fusionnet sequential"]["flat"][:N_REF_KEYFRAMES]
    rel = max(float(np.max(np.abs(a - b) / b)) for a, b in zip(got, want))
    print(f"[bulk-reference] fusionnet evaluate_scene, first {N_REF_KEYFRAMES} keyframes of "
          f"{os.path.basename(jobs[0][0])}, card vs CPU: max relative depth difference "
          f"{rel:.3e} (tol {REF_RTOL:g}; {lap(clock):.1f} s)", flush=True)
    if not rel <= REF_RTOL:
        raise AssertionError("card and CPU bulk depths disagree")

    # [tsdf]: run_tsdf on the first scene's saved predictions, on the card and
    # on the CPU; then integrate and marching cubes at 1.26M voxels
    folder, index = jobs[0]
    preds, gts = rt.evaluate_scene(fusion, folder, index, cfg)
    save_results(preds, gts, "bulk_fusionnet", "scene0", os.path.join(tmp, "results"))
    saved = np.load(os.path.join(tmp, "results", "bulk_fusionnet_predictions_scene0.npz"))["arr_0"]
    poses, images, depths, K = run_tsdf.load_keyframe_data(folder, index, saved, 3.0,
                                                           BULK_DATASET)[:4]
    volumes = {}
    for dev in (device, "cpu"):
        volumes[str(dev)] = run_tsdf.reconstruct(
            poses, images, depths, K, TSDF_VOXEL, os.path.join(tmp, f"mesh_{dev}_complete.ply"),
            device=dev)
    card_vol, cpu_vol = volumes[str(device)], volumes["cpu"]
    verts, _, _, rgb = card_vol.get_mesh()
    t_card, c_card = card_vol.get_volume()
    t_cpu, c_cpu = cpu_vol.get_volume()
    w_card, w_cpu = card_vol.weight.cpu().numpy(), cpu_vol.weight.numpy()
    differ = int(((c_card != c_cpu).reshape(-1) | (w_card != w_cpu)).sum())
    same = ((c_card == c_cpu).reshape(-1) & (w_card == w_cpu))
    t_gap = float(np.abs(t_card - t_cpu).reshape(-1)[same].max())
    if not (len(verts) and rgb.any() and np.isfinite(t_card).all() and (t_card < 0.999).any()):
        raise AssertionError(f"tsdf: {len(verts)} vertices, colours {rgb.any()}, finite "
                             f"{np.isfinite(t_card).all()}, updated {(t_card < 0.999).any()}")
    if differ > TSDF_FLIP_SHARE * t_card.size or not t_gap <= TSDF_ATOL:
        raise AssertionError(f"tsdf card vs CPU: {differ} voxels differ, tsdf gap {t_gap:.3e}")

    centre = np.mean([p[:3, 3] for p in poses], axis=0)
    cube = tsdf.TSDFVolume(np.stack([centre - TSDF_CUBE / 2, centre + TSDF_CUBE / 2], axis=1),
                           TSDF_VOXEL, device=device)
    n_vox = int(np.prod(cube.vol_dim))
    frame_ms = []
    for color, depth, pose in zip(images, depths, poses):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        cube.integrate(color, depth, K, pose)
        end.record()
        end.synchronize()
        frame_ms.append(start.elapsed_time(end))
    tensors = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in (
        cube.vol_origin, tsdf.pack_color(images[0]), depths[0], K, poses[0])]
    step_ms = time_ms(lambda: tsdf.integrate_step(
        cube.tsdf, cube.weight, cube.color, tensors[0], cube.voxel_size, *tensors[1:], 1.0,
        cube.trunc_margin, tuple(int(d) for d in cube.vol_dim)), n=10, reps=5)
    t0 = time.perf_counter()
    mesh = cube.get_mesh()
    mc_s = time.perf_counter() - t0
    print(f"[tsdf] run_tsdf on {os.path.basename(folder)}: {len(images)} keyframes into "
          f"{'x'.join(map(str, card_vol.vol_dim))} voxels of {TSDF_VOXEL} m on the card, mesh of "
          f"{len(verts)} vertices with colours; card vs CPU: {differ} voxels differ in colour or "
          f"weight (limit {TSDF_FLIP_SHARE:g} of {t_card.size}), tsdf gap elsewhere {t_gap:.3e} "
          f"(tol {TSDF_ATOL:g}); integrate at {'x'.join(map(str, cube.vol_dim))} = {n_vox} voxels: "
          f"median {np.median(frame_ms):.3f} ms a frame (CUDA events around integrate, host "
          f"packing and uploads included), integrate_step alone {step_ms:.4f} ms ({TIMER}); "
          f"marching cubes {mc_s:.3f} s ({len(mesh[0])} vertices) ({lap(clock):.1f} s) | {card}",
          flush=True)

    # [live-tsdf]: the online driver fusing every keyframe into a volume
    live = run_testing_online.LiveTSDF(voxel_size=TSDF_VOXEL, max_depth=3.0, device=device)
    (preds, _), _, peak, fwd, _ = timed_run(torch, lambda: run_testing_online.predict_scene(
        fusion, folder, cfg, evaluate=False, live_tsdf=live))
    mesh_path = os.path.join(tmp, "live", "live_complete.ply")
    live.save_mesh(mesh_path)
    if not (live.n_integrated == len(preds) > 0 and fwd >= len(preds)
            and os.path.getsize(mesh_path) > 0):
        raise AssertionError(f"live tsdf: {live.n_integrated} fused of {len(preds)}, "
                             f"{fwd} launches")
    print(f"[live-tsdf] predict_scene with LiveTSDF on {os.path.basename(folder)}: "
          f"{len(preds)} keyframes fused into {'x'.join(map(str, live.volume.vol_dim))} voxels, "
          f"mesh written ({os.path.getsize(mesh_path)} bytes), forward launches {fwd}, peak "
          f"memory {peak:.1f} MiB ({lap(clock):.1f} s)", flush=True)
    return {"jobs": jobs, "assets": assets, "cache": cache, "keyframes": keyframes,
            "kf_per_s": {k: v["kf_per_s"] for k, v in runs.items()},
            "launches": runs[f"pairnet batched B={BULK_BATCH}"]["fwd"],
            "tsdf_frame_ms": float(np.median(frame_ms)), "tsdf_step_ms": step_ms,
            "tsdf_voxels": n_vox, "marching_cubes_s": mc_s}


def baseline_phases(torch, device, card, clock, tmp):
    """[baselines]: each of the four baselines through
    ``run_testing_baseline.evaluate_scene_baseline`` on the card over one
    640x480 scene folder and its index file, against the same code on the
    CPU; returns per baseline its ms a keyframe, peak MiB and launches (the
    forward sweep's; DELTAS's DLT solve's)."""
    from dvmvs_tpu_torch.apps.run_testing_baseline import evaluate_scene_baseline
    from dvmvs_tpu_torch.ops import dlt
    from dvmvs_tpu_torch.apps.simulate_keyframe_buffer import simulate_dataset
    from dvmvs_tpu_torch.baselines import BASELINE_REGISTRY
    from dvmvs_tpu_torch.data.scene_folders import write_scene_folders
    from dvmvs_tpu_torch.utils.precision import ieee_float32
    from dvmvs_tpu_torch.utils.results import InferenceTimer

    dataset = "synth640_baselines"
    folder, = write_scene_folders(os.path.join(tmp, dataset), [BASELINE_SCENE], BULK_FRAME,
                                  BULK_STEP)
    simulate_dataset(os.path.join(tmp, dataset), os.path.join(tmp, "indices"), 2)
    index = os.path.join(tmp, "indices", f"keyframe+{dataset}+{os.path.basename(folder)}+nmeas+2")
    print(f"[baselines] scene {BASELINE_SCENE} (seed, frames) written at {BULK_FRAME[0]}x"
          f"{BULK_FRAME[1]} and indexed ({lap(clock):.1f} s)", flush=True)

    def run(est, n, timer=None):
        return evaluate_scene_baseline(est, folder, index, evaluate=False, max_frames=n,
                                       timer=timer)[0]

    out = {}
    for name in ("mvdepthnet", "gpmvs", "dpsnet", "deltas"):
        est = BASELINE_REGISTRY[name](device=device, seed=0)  # graphed, the default
        run(est, 2)  # warm-up; captures the graphs
        timer = InferenceTimer(n_skip=1)
        # the weights, the graphs and what earlier phases still hold
        held = torch.cuda.memory_allocated() / 2 ** 20
        seen = []  # each keyframe's predict arguments, for [baseline-graphs]
        est.predict = lambda *a, real=est.predict: (seen.append(a), real(*a))[1]
        mark = launch_mark()
        preds, _, peak, fwd, bwd = timed_run(torch, lambda: run(est, BASELINE_KEYFRAMES,
                                                                timer))
        solves = launches_since(mark)[2]
        del est.predict
        want_fwd = len(preds) if name in ("mvdepthnet", "gpmvs") else 0
        want_solves = len(preds) if name == "deltas" else 0
        if len(preds) != BASELINE_KEYFRAMES or not all(
                p.shape == (est.image_height, est.image_width) and np.isfinite(p).all()
                and p.min() > 0 for p in preds):
            raise AssertionError(f"{name}: {len(preds)} depths, or bad shapes or values")
        if fwd != want_fwd or bwd or solves != want_solves:
            raise AssertionError(f"{name}: forward kernel launched {fwd} times for {len(preds)} "
                                 f"keyframes (want {want_fwd}), backward {bwd}, DLT solve "
                                 f"{solves} (want {want_solves})")
        cpu = BASELINE_REGISTRY[name](device="cpu", seed=0)
        n_ref = BASELINE_REF[name]
        if name == "deltas":
            # the first keyframe's inputs; the dense stages held with the
            # CPU's keypoints, the card's own top-k compared with the CPU's
            with torch.inference_mode(), ieee_float32():  # model methods, not a predict
                want = cpu.model.stages(*cpu.inputs(*seen[0]))
                own = est.model.stages(*est.inputs(*seen[0]))
                forced = est.model.stages(*est.inputs(*seen[0]),
                                          keypoints=want["keypoints"].to(device))
            kp_cpu = {tuple(k) for k in want["keypoints"][0].tolist()}
            changed = len(kp_cpu - {tuple(k) for k in own["keypoints"][0].cpu().tolist()})
            d_cpu = want["depth"].numpy()
            gap = float(np.abs(forced["depth"].cpu().numpy() - d_cpu).max() / np.abs(d_cpu).max())
            ref_text = (f"dense stages with the CPU's keypoints: raw depth gap {gap:.3e} of the "
                        f"largest |depth| (tol {BASELINE_RTOL:g}); the card's own top-k changes "
                        f"{changed} of {len(kp_cpu)} keypoints")
        else:
            want = run(cpu, n_ref)
            gap = max(float(np.max(np.abs(a - b) / b)) for a, b in zip(preds, want))
            ref_text = (f"first {n_ref} keyframe(s) card vs CPU: max relative depth difference "
                        f"{gap:.3e} (tol {BASELINE_RTOL:g})")
        steady = timer.times[1:]
        out[name] = {"ms_median": float(np.median(steady)),
                     "ms_p90": float(np.percentile(steady, 90)), "peak_mib": peak - held,
                     "launches": fwd, "dlt_launches": solves, "keyframes": len(preds),
                     "gap": gap, "inputs": seen}
        print(f"[baselines] {name} {est.image_width}x{est.image_height}: {len(preds)} keyframes, "
              f"predict median {out[name]['ms_median']:.3f} ms p90 {out[name]['ms_p90']:.3f} ms "
              f"over {len(steady)} (first {timer.times[0]:.1f} ms), peak memory {peak - held:.1f} "
              f"MiB above the {held:.1f} MiB held before (weights, earlier phases), "
              f"forward kernel launches {fwd} (want {want_fwd}), DLT-solve kernel launches "
              f"{solves} (want {want_solves}); {ref_text} "
              f"({lap(clock):.1f} s) | {card}", flush=True)
        if not gap <= BASELINE_RTOL:
            raise AssertionError(f"{name}: card and CPU disagree ({gap:.3e})")
    return out


def baseline_graphs_phase(torch, card, clock, baselines):
    """[baseline-graphs]: each baseline's predict graphed (the default) and
    eager in turns over the [baselines] keyframes
    (``apps/profile_baselines.py::compare_paths``); returns the numbers for
    the JSON line."""
    from dvmvs_tpu_torch.apps.profile_baselines import compare_paths

    report = {}
    for name, graphs in BASELINE_GRAPHS.items():
        r = compare_paths(name, baselines[name]["inputs"], BASELINE_ROUNDS)
        torch.cuda.empty_cache()
        g, e = r["graphs"], r["eager"]
        per = g["host_launches_per_predict"]
        want_fwd = r["keyframes"] if name in ("mvdepthnet", "gpmvs") else 0
        want_solves = r["keyframes"] if name == "deltas" else 0
        solve_ms = (f"; DLT-solve kernel device time a predict graphed {g['dlt_solve_ms']:.4f} ms, "
                    f"eager {e['dlt_solve_ms']:.4f} ms" if name == "deltas" else "")
        print(f"[baseline-graphs] {name}, {r['keyframes']} keyframes, {BASELINE_ROUNDS} passes a "
              f"path in turns: graphed against eager depth gap {r['depth_gap']:.3e} (tol "
              f"{BASELINE_RTOL:g}; {'bit-equal' if r['bit_equal'] else 'NOT bit-equal'}); host "
              f"calls inside one graphed predict: {per['cudaGraphLaunch']:g} cudaGraphLaunch "
              f"(want {graphs}), {per['cudaLaunchKernel']:g} kernel launches (want 0), "
              f"{per['memcpy']:g} copies; eager "
              f"{e['host_launches_per_predict']['cudaLaunchKernel']:g} kernel launches, "
              f"{e['host_launches_per_predict']['memcpy']:g} copies; kernel launches counted in "
              f"a graphed pass: forward {r['plane_sweep_launches_graphed_pass']} (want "
              f"{want_fwd}), DLT solve {r['dlt_solve_launches_graphed_pass']} (want "
              f"{want_solves}){solve_ms}; predict median / p90 graphed "
              f"{g['predict_ms']['median']:.3f} / {g['predict_ms']['p90']:.3f} ms, eager "
              f"{e['predict_ms']['median']:.3f} / {e['predict_ms']['p90']:.3f} ms; first-pass "
              f"peak above the weights graphed {g['first_pass_peak_mib']:.1f} MiB, eager "
              f"{e['first_pass_peak_mib']:.1f} MiB; kept between calls (the graphs' pools) "
              f"{g['kept_mib']:.1f} MiB, eager {e['kept_mib']:.1f} MiB ({lap(clock):.1f} s) | "
              f"{card}", flush=True)
        if not r["depth_gap"] <= BASELINE_RTOL:
            raise AssertionError(f"{name}: the graphed predict disagrees with the eager one")
        if per["cudaGraphLaunch"] != graphs or r["captured_steps"] != graphs \
                or per["cudaLaunchKernel"] != 0:
            raise AssertionError(f"{name}: a graphed predict is not {graphs} graph launch(es) "
                                 f"and copies: {g['host_api_calls_in_predict']}")
        if r["plane_sweep_launches_graphed_pass"] != want_fwd \
                or r["backward_launches_graphed_pass"] \
                or r["dlt_solve_launches_graphed_pass"] != want_solves:
            raise AssertionError(f"{name}: {r['plane_sweep_launches_graphed_pass']} forward and "
                                 f"{r['dlt_solve_launches_graphed_pass']} DLT-solve launches "
                                 f"counted for {r['keyframes']} replays")
        report[name] = r
    return report


def dlt_gaps(got, want, mask=None):
    """The DLT solve's gaps ([dlt]'s comment) between two (..., 3) point
    sets: over the points of ``mask`` (all where None), relative to their
    largest coordinate; over the points DELTAS keeps (depth inside its range
    on either side); and over every homogeneous solution."""
    from dvmvs_tpu_torch.baselines.deltas import MAX_DEPTH, MIN_DEPTH

    got, want = got.double(), want.double()
    if not (bool(got.isfinite().all()) and bool(want.isfinite().all())):
        raise AssertionError("[dlt] non-finite points")
    mask = got.new_ones(got.shape[:-1]).bool() if mask is None else mask

    def diff(sel):
        return float((got[sel] - want[sel]).abs().max()) if bool(sel.any()) else 0.0

    def rel(sel):
        return diff(sel) / float(want[sel].abs().max()) if bool(sel.any()) else 0.0

    inside = [(p[..., 2] > MIN_DEPTH) & (p[..., 2] < MAX_DEPTH) for p in (got, want)]
    kept = inside[0] | inside[1]
    hom = [p.new_ones(p.shape[:-1] + (4,)) for p in (got, want)]
    for h, p in zip(hom, (got, want)):
        h[..., :3] = p
    hom = [h / h.norm(dim=-1, keepdim=True) for h in hom]
    sign = (hom[0] * hom[1]).sum(-1, keepdim=True).sign()
    return {"range_masked": rel(mask), "kept": rel(kept), "kept_abs_m": diff(kept),
            "kept_points": int(kept.sum()), "points": int(mask.sum()),
            "homogeneous": float((hom[0] - sign * hom[1]).abs().max())}


def dlt_phase(torch, card, clock, baselines):
    """[dlt]: the DLT-solve kernel (``ops/dlt.py::launch``, launches not
    counted) against its plain version in float32 and in float64 on
    DELTAS's systems of the [baselines] keyframes (by seed-0 weights, as the
    estimators there) and on a seeded batch (``sweep_measure.dlt_case``), by
    ``dlt_gaps`` (DLT_TOL's comment); then its time at one keyframe's
    systems, the main path's shape, beside one near-empty kernel's in the
    same timer (the launch floor), its bound (``dlt_bound``), the plain
    version's and torch.linalg.svd's (the same call). Returns the numbers
    for the JSON line."""
    from dvmvs_tpu_torch.baselines.deltas import Deltas, dlt_points, dlt_system
    from dvmvs_tpu_torch.ops import dlt
    from dvmvs_tpu_torch.ops.sweep_measure import (SINGLE_LAUNCH_TIMER, TIMER, dlt_bound,
                                                   dlt_case, single_launch_ms, time_ms)
    from dvmvs_tpu_torch.utils.precision import ieee_float32

    est = Deltas(device="cuda", seed=0, graphs=False)
    with torch.inference_mode(), ieee_float32():  # a model method, not a predict
        fronts = [est.model.front(*est.inputs(*kf)) for kf in baselines["deltas"]["inputs"]]
    scene = torch.cat([f["system"] for f in fronts])
    proj, points, conf = (torch.from_numpy(a).cuda() for a in dlt_case(seed=0, B=DLT_BATCH))
    report = {}
    for name, A, mask in (("scene", scene, torch.cat([f["range_mask"] for f in fronts])),
                          ("seeded", dlt_system(proj, points, conf).contiguous(), None)):
        got, want = dlt_points(dlt.launch(A)), dlt_points(dlt.dlt_solve_plain(A))
        exact = dlt_points(dlt.dlt_solve_plain(A.double())).float()
        again = dlt.launch(A)
        torch.cuda.synchronize()
        g = report[name] = {"plain": dlt_gaps(got, want, mask),
                            "float64": dlt_gaps(got, exact, mask),
                            "plain_to_float64": dlt_gaps(want, exact, mask),
                            "deterministic": bool(torch.equal(dlt_points(again), got))}

        def text(d):
            return (f"kept points ({d['kept_points']} of {A.shape[0] * A.shape[1]}) "
                    f"{d['kept']:.3e} of their largest coordinate, "
                    f"{'range-masked' if mask is not None else 'all'} points ({d['points']}) "
                    f"{d['range_masked']:.3e}, homogeneous {d['homogeneous']:.3e}")

        print(f"[dlt] {name} systems {tuple(A.shape)}: kernel against torch.linalg.svd in "
              f"float32 (the plain version) {text(g['plain'])}; against it in float64 "
              f"{text(g['float64'])}; the float32 plain version against float64 "
              f"{text(g['plain_to_float64'])} (tol {DLT_TOL:g}, against float32 plus its own "
              f"gap to float64); two launches {'bit-equal' if g['deterministic'] else 'DIFFER'} "
              f"({lap(clock):.1f} s)", flush=True)
        own, held = g["plain_to_float64"], ("kept", "range_masked", "homogeneous")
        if not (all(g["float64"][k] <= DLT_TOL for k in held)
                and all(g["plain"][k] <= DLT_TOL + own[k] for k in held)
                and g["deterministic"] and g["plain"]["kept_points"] > 0):
            raise AssertionError(f"[dlt] the kernel disagrees with its plain version on {name}")
    A = scene[:1].contiguous()
    bound = dlt_bound(A)
    floor_ms = time_ms(lambda: torch.cuda._sleep(0))
    kernel_ms = time_ms(lambda: dlt.launch(A))
    plain_ms = time_ms(lambda: dlt.dlt_solve_plain(A))
    library_ms = time_ms(lambda: torch.linalg.svd(A, full_matrices=False))
    kernel_ms_2 = time_ms(lambda: dlt.launch(A))
    single_ms = single_launch_ms(lambda: dlt.launch(A))
    plain_single_ms = single_launch_ms(lambda: dlt.dlt_solve_plain(A))
    print(f"[dlt] time at one keyframe's systems {tuple(A.shape)}: kernel {kernel_ms:.4f} ms "
          f"(again {kernel_ms_2:.4f}; {TIMER}), single launches {single_ms:.4f} ms "
          f"({SINGLE_LAUNCH_TIMER}); launch floor (one near-empty kernel, the same timer) "
          f"{floor_ms:.4f} ms; bound {bound['bound_ms'] * 1e3:.4f} us by {bound['bound_by']} "
          f"({bound['bytes']} bytes, {bound['flops']} float64 flops); plain "
          f"(torch.linalg.svd) {plain_ms:.4f} ms, single {plain_single_ms:.4f} ms; "
          f"torch.linalg.svd again {library_ms:.4f} ms ({lap(clock):.1f} s)", flush=True)
    report.update(shape=list(A.shape), ms=kernel_ms, ms_again=kernel_ms_2,
                  ms_single_launch=single_ms, launch_floor_ms=floor_ms,
                  plain_ms=plain_ms, plain_ms_single=plain_single_ms,
                  library_ms=library_ms, bound=bound,
                  max_abs_err=max(report[n]["plain"]["kept_abs_m"] for n in ("scene", "seeded")),
                  max_abs_err_float64=max(report[n]["float64"]["kept_abs_m"]
                                          for n in ("scene", "seeded")))
    return report


def real_data_phase(torch, device, cfg, card, clock, tmp, corpus):
    """[real-data]: the path of a ScanNet user on a synthetic scan. Returns
    the phase's numbers and its kernel launches."""
    from dvmvs_tpu_torch.apps import run_testing as rt
    from dvmvs_tpu_torch.apps import run_testing_online, run_training, run_tsdf
    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.apps.simulate_keyframe_buffer import simulate_dataset
    from dvmvs_tpu_torch.data import jpeg
    from dvmvs_tpu_torch.data import synth_scannet as ss
    from dvmvs_tpu_torch.data.exporters import point_cloud, scannet
    from dvmvs_tpu_torch.data.scene_folders import spawn_pool
    from dvmvs_tpu_torch.utils.checkpoint import save_jax_checkpoint
    from dvmvs_tpu_torch.utils.visualization import VIS_DIR

    start = time.perf_counter()
    phase = launch_mark()
    # the committed JPEGs through the port's decoder (its g++ build included
    # in the first frame), against OpenCV's pixel digests
    t0 = time.perf_counter()
    first = jpeg.read_jpeg(str(ss.jpeg_paths()[0]))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = [jpeg.read_jpeg(str(p)) for p in ss.jpeg_paths()]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(decoded)
    differ = [i for i, (rgb, want) in enumerate(zip(decoded, ss.digests()))
              if ss.pixel_digest(rgb) != want]
    if differ or not np.array_equal(first, decoded[0]):
        raise AssertionError(f"[real-data] JPEG frames {differ} differ from OpenCV's pixels")
    with spawn_pool(ss.N_FRAMES) as pool:
        depths = pool.map(ss.render_depth_mm, range(ss.N_FRAMES))
    scans = os.path.join(tmp, "scans")
    sens = ss.write_scan(os.path.join(scans, "scene0000_00"), depths)
    print(f"[real-data] {ss.N_FRAMES} JPEGs of {ss.COLOR_SIZE[0]}x{ss.COLOR_SIZE[1]} (4:2:0, "
          f"q95) decoded by data/jpeg.py in {decode_ms:.1f} ms a frame on the host (the first "
          f"with the g++ build {build_s:.2f} s); {len(differ)} of {len(decoded)} frames differ "
          f"from OpenCV's pixel digests (0 pixels); {os.path.getsize(sens)} bytes of .sens with "
          f"{ss.DEPTH_SIZE[0]}x{ss.DEPTH_SIZE[1]} depths rendered here, frame {ss.NAN_FRAME}'s "
          f"pose NaN ({lap(clock):.1f} s) | {card}", flush=True)

    # export: the test layout in this process (timed), the training layout
    # through the command line (spawned workers); both sanity-checked
    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    scannet.export_scene(os.path.dirname(sens), os.path.join(data, "scannet"), train=False,
                         frame_skip=1)
    export_s = (time.perf_counter() - t0) / ss.N_FRAMES
    train_root = os.path.join(tmp, "scannet_train")
    problems = scannet.main(["--input", scans, "--output", train_root, "--train",
                             "--frame-skip", "1", "--workers", "1"])
    folder = os.path.join(data, "scannet", "scene0000_00")
    npzs = [f for f in os.listdir(os.path.join(train_root, "scene0000_00")) if f.endswith(".npz")]
    if problems or scannet.sanity_check(os.path.join(data, "scannet"), False) \
            or len(npzs) != ss.N_FRAMES - 1 \
            or len(os.listdir(os.path.join(folder, "images"))) != ss.N_FRAMES:
        raise AssertionError(f"[real-data] export: problems {problems}, {len(npzs)} npz")
    simulate_dataset(os.path.join(data, "scannet"), os.path.join(data, "indices"), 2)
    index = os.path.join(data, "indices", "keyframe+scannet+scene0000_00+nmeas+2")
    keyframes = sum(line != "TRACKING LOST" for line in rt.read_index(index))
    print(f"[real-data] exported by data/exporters/scannet.py: test layout {export_s:.3f} s a "
          f"frame ({ss.N_FRAMES} frames: decode, registration to the depth camera, two PNGs), "
          f"training layout through its command line {len(npzs)} npz (the NaN-pose frame "
          f"skipped), sanity_check clean; simulate_keyframe_buffer: {keyframes} keyframes "
          f"({lap(clock):.1f} s) | {card}", flush=True)

    # the drivers from JAX-layout checkpoints against the same weights put
    # into the engine directly
    engines = {kind: InferenceEngine(kind, cfg, device=device, seed=REAL_SEED)
               for kind in ("pairnet", "fusionnet")}
    msgpack = {kind: os.path.join(tmp, f"{kind}.msgpack") for kind in engines}
    for kind, engine in engines.items():
        save_jax_checkpoint(msgpack[kind], engine.model)

    def saved(out, system):
        return np.load(os.path.join(out, f"{system}_predictions_scene0000_00.npz"))["arr_0"]

    gaps = {}
    common = ["--data", data, "--device", str(device), "--output"]
    mark = launch_mark()
    rt.main(common + [os.path.join(tmp, "pair"), "--model", "pairnet", "--batch-size",
                      str(REAL_BATCH), "--checkpoint", msgpack["pairnet"]])
    pair_fwd = launches_since(mark)[0]
    got = saved(os.path.join(tmp, "pair"), "keyframe_scannet_320_256_2_dvmvs_tpu_torch_pairnet")
    want, _ = rt.evaluate_scene_batched(engines["pairnet"], folder, index, cfg, REAL_BATCH)
    gaps["run_testing pairnet B=8"] = float(np.abs(got - np.stack(want)).max())
    rt.main(common + [os.path.join(tmp, "fusion"), "--model", "fusionnet", "--checkpoint",
                      msgpack["fusionnet"]])
    fusion_npz = os.path.join(tmp, "fusion", "keyframe_scannet_320_256_2_dvmvs_tpu_torch_"
                                             "fusionnet_predictions_scene0000_00.npz")
    got = np.load(fusion_npz)["arr_0"]
    want, _ = rt.evaluate_scene(engines["fusionnet"], folder, index, cfg)
    gaps["run_testing fusionnet"] = float(np.abs(got - np.stack(want)).max())
    cwd = os.getcwd()
    os.chdir(tmp)  # --visualize writes under the working directory, as the JAX driver does
    try:
        mark = launch_mark()
        run_testing_online.main(["--scene", folder, "--checkpoint", msgpack["fusionnet"],
                                 "--visualize", "--device", str(device), "--output",
                                 os.path.join(tmp, "online")])
        online_fwd = launches_since(mark)[0]
    finally:
        os.chdir(cwd)
    got = saved(os.path.join(tmp, "online"),
                "keyframe_scannet_320_256_2_dvmvs_tpu_torch_fusionnet_online")
    want, _ = run_testing_online.predict_scene(engines["fusionnet"], folder, cfg)
    gaps["run_testing_online fusionnet"] = float(np.abs(got - np.stack(want)).max())
    panels = sorted(os.listdir(os.path.join(tmp, VIS_DIR)))
    if any(gaps.values()) or len(got) < 3 or not np.isfinite(got).all() \
            or len(panels) != 4 * len(got) or pair_fwd < 1 or online_fwd < len(got):
        raise AssertionError(f"[real-data] checkpoint route: gaps {gaps}, {len(got)} online "
                             f"keyframes, {len(panels)} panels, launches {pair_fwd}/{online_fwd}")
    print(f"[real-data] run_testing (pairnet --batch-size {REAL_BATCH}, fusionnet) and "
          f"run_testing_online --visualize from JAX-layout .msgpack checkpoints "
          f"(save_jax_checkpoint, seed {REAL_SEED}) against the same weights in the engine: max "
          f"|depth gap| " + ", ".join(f"{k} {v:g} m" for k, v in gaps.items())
          + f" (must be 0); {len(got)} online keyframes, {len(panels)} PNG panels; forward "
          f"launches of the msgpack routes: run_testing pairnet {pair_fwd}, run_testing_online "
          f"{online_fwd} ({lap(clock):.1f} s) | {card}", flush=True)

    # reconstruction: run_tsdf on the fusionnet predictions, point clouds
    run_tsdf.main(["--predictions", fusion_npz, "--data", data, "--dataset-name", "scannet",
                   "--scene", "scene0000_00", "--device", str(device), "--output",
                   os.path.join(tmp, "recon")])
    meshes = [f for f in os.listdir(os.path.join(tmp, "recon")) if f.endswith(".ply")]
    clouds = point_cloud.main(["--dataset", os.path.join(data, "scannet"), "--scene",
                               "scene0000_00", "--output", os.path.join(tmp, "clouds"),
                               "--stride", "1"])
    if len(meshes) != 1 or not clouds or not all(os.path.getsize(p) > 200 for p in clouds):
        raise AssertionError(f"[real-data] meshes {meshes}, point clouds {clouds}")

    # two fusionnet steps with every module trainable, warm-started from the
    # pairnet msgpack (lstm_fusion kept fresh), at the training shape
    mark = launch_mark()
    run_dir = run_training.main(
        ["--model", "fusionnet", "--dataset", corpus, "--run-directory",
         os.path.join(tmp, "runs"), "--warm-start", msgpack["pairnet"], "--epochs", "2",
         "--finetune-epochs", "0", "--max-steps", "1", "--no-validate", "--print-frequency",
         "1", "--device", str(device)])
    train_fwd, train_bwd = launches_since(mark)[:2]
    losses = [e["loss"] for e in read_run(run_dir)[0]]
    if len(losses) != 2 or not np.isfinite(losses).all() or train_fwd < 14 or train_bwd < 14:
        raise AssertionError(f"[real-data] warm-started training: losses {losses}, launches "
                             f"{train_fwd}/{train_bwd}")
    seconds = time.perf_counter() - start
    phase_fwd, phase_bwd = launches_since(phase)[:2]
    print(f"[real-data] run_tsdf mesh {meshes[0]} and {len(clouds)} point-cloud PLY files of the "
          f"exported scene; run_training fusionnet B={TB} S=8 256x256 warm-started from the "
          f"pairnet .msgpack: losses {', '.join(f'{v:.4f}' for v in losses)}, launches forward "
          f"{train_fwd}, backward {train_bwd}; phase {seconds:.1f} s, launches forward "
          f"{phase_fwd}, backward {phase_bwd} ({lap(clock):.1f} s) | {card}",
          flush=True)
    return {"jpeg_decode_ms": decode_ms, "export_s_per_frame": export_s,
            "frames_differing": len(differ), "keyframes": keyframes, "depth_gaps": gaps,
            "seconds": seconds, "fwd": phase_fwd, "bwd": phase_bwd}


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` replaced by ``value`` within the block (a planted fault)."""
    real = obj.__dict__[name]
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def reassigned_state(engine, state, new):
    """The stale-state fault: the new recurrent state bound to the engine's
    attributes instead of written into the state buffers."""
    engine.carry, engine.prev_pose, engine.prev_depth, engine.has_prev = new


def bound_carry(engine, name):
    """The LSTM carry (h, c) that the next replay of step ``name`` reads, as
    host arrays."""
    step = next(g for k, g in engine.step_graphs.items() if k[0] == name)
    return [t.cpu().numpy() for t in step.args["state"][0]]


def graphs_online_phase(torch, device, cfg, card, clock, stream):
    """[graphs] online: the 40-frame stream through the graphed and the eager
    engine, fusionnet and pairnet; returns the numbers for the JSON line."""
    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.apps.profile_step import (STEP_RANGE, api_calls, launches_per_call,
                                                   ranged, trace_events)
    from dvmvs_tpu_torch.apps.run_testing_online import predict_stream
    from dvmvs_tpu_torch.utils.results import InferenceTimer

    frames, poses, K = stream

    def run(engine, graphed_cvs=None, timer=None):
        """(depths, the kept features as host arrays, cost volumes or None)."""
        kept, real = [], engine.encode_and_predict

        def keep(*args):
            depth, half = real(*args)
            kept.append(half)
            return depth, half

        engine.encode_and_predict = keep
        try:
            if graphed_cvs is None:
                return (predict_stream(engine, frames, poses, K, cfg, timer=timer)[0],
                        [k.cpu().numpy() for k in kept], None)
            with engine.recording_cost_volumes(graphed=graphed_cvs) as cvs:
                depths = predict_stream(engine, frames, poses, K, cfg)[0]
            return depths, [k.cpu().numpy() for k in kept], cvs
        finally:
            del engine.encode_and_predict

    report = {}
    for kind in ("fusionnet", "pairnet"):
        engines, first, peak = {}, {}, {}
        for mode in ("eager", "graphs"):  # the eager engine's peak alone, then the graphed one's
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            engines[mode] = InferenceEngine(kind, cfg, device=device, seed=0,
                                            graphs=mode == "graphs")
            first[mode] = run(engines[mode])  # the graphed engine captures its steps here
            torch.cuda.synchronize()
            peak[mode] = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
        eager, graphed = engines["eager"], engines["graphs"]
        mark = launch_mark()
        again = run(graphed)
        launches, backward = launches_since(mark)[:2]
        n = len(again[0])
        depth_gap = max(float(np.max(np.abs(a - b) / b)) for a, b in zip(
            first["graphs"][0] + again[0], first["eager"][0] * 2))
        feature_gap = max_gap(first["graphs"][1] + again[1], first["eager"][1] * 2)
        bit_equal = depth_gap == 0.0 and feature_gap == 0.0
        cv = cv_gap(run(graphed, graphed_cvs=True)[2], run(eager, graphed_cvs=False)[2])
        timers = {mode: InferenceTimer(n_skip=0) for mode in engines}
        for _ in range(2):
            for mode, engine in engines.items():
                run(engine, timer=timers[mode])
        ms = {mode: (float(np.median(t.times)), float(np.percentile(t.times, 90)))
              for mode, t in timers.items()}
        ranged(graphed, ("encode_and_predict",))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            predict_stream(graphed, frames, poses, K, cfg)
            torch.cuda.synchronize()
        del graphed.encode_and_predict
        calls = api_calls(trace_events(prof), STEP_RANGE)
        per_kf = launches_per_call(calls)
        print(f"[graphs] {kind} online, {n} keyframes of {N_FRAMES} frames: graphed against "
              f"eager depth gap {depth_gap:.3e} (tol {REF_RTOL:g}), kept features gap "
              f"{feature_gap:.3e}, {'bit-equal' if bit_equal else 'NOT bit-equal'}; cost volumes "
              f"{cv:.3e} (tol {CV_RTOL:g}); forward launches after the capture {launches} for "
              f"{n} keyframes; encode_and_predict median / p90 graphs {ms['graphs'][0]:.3f} / "
              f"{ms['graphs'][1]:.3f} ms, eager {ms['eager'][0]:.3f} / {ms['eager'][1]:.3f} ms; "
              f"host calls a keyframe inside encode_and_predict (profiler, "
              f"{calls['ranges']} steps): {calls['calls']}; peak memory of the first pass "
              f"graphs {peak['graphs']:.1f} MiB, eager {peak['eager']:.1f} MiB; "
              f"{len(graphed.step_graphs)} captured steps ({lap(clock):.1f} s) | {card}",
              flush=True)
        if not (depth_gap <= REF_RTOL and feature_gap <= REF_RTOL * np.abs(
                np.concatenate([f.ravel() for f in first["eager"][1]])).max() and cv <= CV_RTOL):
            raise AssertionError(f"{kind}: the graph path disagrees with the eager path")
        if launches != n or backward:
            raise AssertionError(f"{kind}: {launches} forward launches counted for {n} replays")
        if calls["ranges"] != n or per_kf["cudaGraphLaunch"] != 1.0 \
                or per_kf["cudaLaunchKernel"] != 0.0:
            raise AssertionError(f"{kind}: encode_and_predict is not one graph launch and "
                                 f"copies: {calls}")
        report[kind] = {"depth_gap": depth_gap, "feature_gap": feature_gap, "cv_gap": cv,
                        "launches": launches, "ms": ms, "peak_mib": peak,
                        "host_launches_per_keyframe": per_kf}
        if kind == "fusionnet":
            eager_cvs = run(eager, graphed_cvs=False)[2]
            eager_carry = [t.cpu().numpy() for t in eager.carry]
            sound = cv_gap(bound_carry(graphed, "encode_and_predict"), eager_carry)
            with patched(InferenceEngine, "_copy_out", lambda self, t: t):
                aliased = cv_gap(run(InferenceEngine(kind, cfg, device=device, seed=0),
                                     graphed_cvs=True)[2], eager_cvs)
            with patched(InferenceEngine, "_write_state", reassigned_state):
                stale_engine = InferenceEngine(kind, cfg, device=device, seed=0)
                stale_depths = run(stale_engine)[0]
            stale = cv_gap(bound_carry(stale_engine, "encode_and_predict"), eager_carry)
            stale_depth = max(float(np.max(np.abs(a - b) / b))
                              for a, b in zip(stale_depths, first["eager"][0]))
            print(f"[graphs] planted faults, fusionnet online: kept features aliasing the "
                  f"output buffer: cost volume gap {aliased:.3e}; state reassigned instead of "
                  f"written in place: gap of the carry the next replay reads {stale:.3e} (sound "
                  f"{sound:.3e}), depth gap {stale_depth:.3e}; each fault must exceed "
                  f"{CV_BF16_RTOL:g} ({lap(clock):.1f} s)", flush=True)
            if not (sound == 0.0 and aliased > CV_BF16_RTOL and stale > CV_BF16_RTOL):
                raise AssertionError("a planted fault of the graph path was not caught")
            report["faults"] = {"aliased_cv_gap": aliased, "stale_carry_gap": stale,
                                "stale_depth_gap": stale_depth}
    return report


def graphs_bulk_phase(torch, device, cfg, card, clock, bulk):
    """[graphs] bulk: run_testing's chunks of BULK_SCAN through graphs
    against the eager engines; returns the numbers for the JSON line."""
    from dvmvs_tpu_torch.apps import run_testing as rt
    from dvmvs_tpu_torch.apps.engine import InferenceEngine

    jobs, assets, cache, keyframes = (bulk[k] for k in ("jobs", "assets", "cache", "keyframes"))
    eager = {kind: InferenceEngine(kind, cfg, device=device, seed=0, graphs=False)
             for kind in ("pairnet", "fusionnet")}
    graphed = {kind: InferenceEngine(kind, cfg, device=device, seed=0)
               for kind in ("pairnet", "fusionnet")}

    def chunked(kind, engine, dtype, scenes=None):
        if kind == "pairnet":
            return lambda: [d for (f, i), a in list(zip(jobs, assets))[:scenes]
                            for d in rt.evaluate_scene_batched(
                                engine, f, i, cfg, BULK_BATCH, evaluate=False, assets=a,
                                scan_chunk=BULK_SCAN, bank_dtype=dtype)[0]]
        return lambda: [d for p, _ in rt.evaluate_scenes_batched_fusion(
            engine, jobs, cfg, evaluate=False, asset_cache=cache, scan_chunk=BULK_SCAN,
            bank_dtype=dtype) for d in p]

    def recorded(engine, fn, graphed_cvs):
        with engine.recording_cost_volumes(graphed=graphed_cvs) as calls:
            fn()
        return [r for c in calls for r in c]

    steps = {"pairnet": sum(sum(rt._scan_schedule(-(-k // BULK_BATCH), BULK_SCAN))
                            for k in keyframes),
             "fusionnet": sum(rt._scan_schedule(max(keyframes), BULK_SCAN))}
    report = {}
    for kind in ("pairnet", "fusionnet"):
        seq = [d for (f, i), a in zip(jobs, assets) for d in rt.evaluate_scene(
            eager[kind], f, i, cfg, evaluate=False, assets=a)[0]]
        want_cv = recorded(eager[kind], chunked(kind, eager[kind], "f32", 1), False)
        for dtype, tol, cv_tol in (("f32", BULK_ATOL, CV_RTOL), ("bf16", BF16_ATOL, CV_BF16_RTOL)):
            fn = chunked(kind, graphed[kind], dtype)
            fn()  # captures (and drops the graphs of another bank)
            depths, seconds, peak, fwd, bwd = timed_run(torch, fn)
            gap = max_gap(depths, seq)
            cv = cv_gap(recorded(graphed[kind], chunked(kind, graphed[kind], dtype, 1), True),
                        want_cv)
            name = f"{kind} {'batched B=%d' % BULK_BATCH if kind == 'pairnet' else 'lockstep'} " \
                   f"chunk {BULK_SCAN} {dtype} bank, graphs"
            print(f"[graphs] {name}: {len(depths)} keyframes in {seconds:.3f} s "
                  f"({len(depths) / seconds:.1f} keyframes/s), peak memory {peak:.1f} MiB, "
                  f"forward launches {fwd} (one a step of the chunks: {steps[kind]}), max |depth "
                  f"- eager sequential| {gap:.3e} m (tol {tol:g}), cost volumes against the eager "
                  f"chunks {cv:.3e} (tol {cv_tol:g}) ({lap(clock):.1f} s) | {card}", flush=True)
            if not (gap <= tol and cv <= cv_tol and fwd == steps[kind] and bwd == 0):
                raise AssertionError(f"{name}: the graph path disagrees with the eager path")
            report[f"{kind}_{dtype}"] = {"kf_per_s": len(depths) / seconds, "peak_mib": peak,
                                         "launches": fwd, "depth_gap": gap, "cv_gap": cv}

    # the lockstep chunks with the state reassigned: the carry the next
    # replay reads stays the one the first chunk was given
    sound_fn = chunked("fusionnet", graphed["fusionnet"], "f32")
    sound_fn()
    sound = bound_carry(graphed["fusionnet"], "fusion_steps")
    with patched(InferenceEngine, "_write_state", reassigned_state):
        stale_engine = InferenceEngine("fusionnet", cfg, device=device, seed=0)
        chunked("fusionnet", stale_engine, "f32")()
    stale = cv_gap(bound_carry(stale_engine, "fusion_steps"), sound)
    print(f"[graphs] planted fault, lockstep chunk {BULK_SCAN}: state reassigned instead of "
          f"written in place: gap of the carry the next replay reads {stale:.3e} (must exceed "
          f"{CV_BF16_RTOL:g}; {lap(clock):.1f} s)", flush=True)
    if not stale > CV_BF16_RTOL:
        raise AssertionError("the stale lockstep state was not caught")
    report["stale_lockstep_carry_gap"] = stale
    return report


def launch_mark() -> dict:
    """A snapshot of the port's counters (``utils/profiling.py``), for
    ``launches_since``."""
    from dvmvs_tpu_torch.utils.profiling import counters

    return counters.snapshot()


def launches_since(mark: dict) -> tuple:
    """(sweep forward, sweep backward, DLT solve) kernel launches counted
    after ``mark``."""
    from dvmvs_tpu_torch.apps.graphs import LAUNCHES
    from dvmvs_tpu_torch.utils.profiling import counters

    moved = counters.since(mark)
    return tuple(moved.get(name, 0) for name in LAUNCHES)


def timed_run(torch, fn):
    """fn() with the launches counted from just before to just after:
    (result, wall seconds to the last readback, peak MiB, forward launches,
    backward launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mark = launch_mark()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 20,
            *launches_since(mark)[:2])


def max_gap(got, want):
    """Largest absolute difference over two lists of depth maps (equal
    lengths required)."""
    if len(got) != len(want) or not got:
        raise AssertionError(f"{len(got)} depths against {len(want)}")
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def cv_gap(got, want):
    """Largest max |got - want| / max |want| over two lists of cost volumes
    (equal lengths required)."""
    if len(got) != len(want) or not got:
        raise AssertionError(f"{len(got)} cost volumes against {len(want)}")
    return max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))


def read_run(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return ([e for e in lines if e["tag"] == "train"],
            [e for e in lines if e["tag"] == "validation"])


def check_run(torch, mark, run_dir, kind, n_stages, steps, s, peak_mib):
    """Losses finite, checkpoint and resume pair written, both kernels
    launched for every step; prints the [train] line."""
    train, val = read_run(run_dir)
    losses = [e["loss"] for e in train]
    if len(losses) != n_stages * steps or not np.isfinite(losses).all():
        raise AssertionError(f"{kind}: losses {losses}")
    state = os.path.join(run_dir, f"{kind}_latest.state.pt")
    for path in (state, state + ".meta.json"):
        if not os.path.isfile(path):
            raise AssertionError(f"{kind}: {path} was not written")
    # a checkpoint is written after an epoch whose validation improved (every
    # epoch without validation); the first epoch always improves
    checkpoints = sorted(f for f in os.listdir(run_dir) if f.startswith(f"{kind}_epoch"))
    if f"{kind}_epoch0.pt" not in checkpoints:
        raise AssertionError(f"{kind}: no checkpoint of the first epoch in {run_dir}")
    fwd, bwd = launches_since(mark)[:2]
    need = (s - 1) * n_stages * steps
    if fwd < need or bwd < need:
        raise AssertionError(f"{kind}: kernels launched {fwd}/{bwd} times, want >= {need} each")
    step_ms = [e["step_ms"] for e in train]
    val_text = ", ".join(f"{e['l1_inv']:.4f}" for e in val) or "off"
    print(f"[train] {kind}: {n_stages} stages x {steps} steps, losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; step median {np.median(step_ms[1:]):.1f} ms "
          f"(first {step_ms[0]:.1f} ms; all {', '.join(f'{v:.1f}' for v in step_ms)}); peak "
          f"memory {peak_mib:.1f} MiB; kernel launches fwd {fwd} bwd {bwd} (>= {need}); "
          f"validation l1_inv {val_text}; checkpoints {', '.join(checkpoints)} and the resume "
          f"state written", flush=True)
    return fwd, bwd, float(np.median(step_ms[1:]))


def small_batch(torch, device, seed=0, s=3, b=2, size=64):
    from dvmvs_tpu_torch.ops.sweep_measure import pose

    rs = np.random.RandomState(seed)
    poses = np.stack([[pose(*rs.uniform(-3, 3, 3), rs.uniform(-0.1, 0.1, 3))
                       for _ in range(s)] for _ in range(b)])
    K = np.array([[30.0, 0, size / 2], [0, 30.0, size / 2], [0, 0, 1]], np.float32)
    batch = {"images": rs.randn(b, s, size, size, 3).astype(np.float32) * 0.5,
             "depths": rs.uniform(0.5, 8.0, (b, s, size, size)).astype(np.float32),
             "poses": poses.astype(np.float32), "K": np.stack([K] * b)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_step_gaps(torch, cpu, card, freeze_bn):
    """(largest gradient gap, largest statistics gap) of two models after
    the same step. Gradients: per tensor against 1e-3 of the module's
    largest |grad| with frozen BatchNorm, per module relative L2 in train
    mode. Running statistics, per channel: a variance against itself; a
    mean against what one batch could move it by, momentum *
    sqrt(running_var), because a BatchNorm fed by a linear layer after
    another BatchNorm sees a batch mean of zero up to rounding (about 1e-11
    after one step)."""
    grad_gap, stat_gap = 0.0, 0.0
    for name in ("feature_extractor", "feature_shrinker", "cost_volume_encoder",
                 "lstm_fusion", "cost_volume_decoder"):
        want = dict(getattr(cpu, name).named_parameters())
        got = dict(getattr(card, name).named_parameters())
        pairs = [(got[k].grad.cpu(), want[k].grad) for k in want if want[k].grad is not None]
        if freeze_bn:
            floor = 1e-3 * max(w.abs().max().item() for _, w in pairs)
            grad_gap = max(grad_gap, max((g - w).abs().max().item() / max(w.abs().max().item(),
                                                                          floor)
                                         for g, w in pairs))
        else:
            diff = sum(((g - w) ** 2).sum().item() for g, w in pairs) ** 0.5
            grad_gap = max(grad_gap, diff / sum((w ** 2).sum().item() for _, w in pairs) ** 0.5)
        card_modules = dict(getattr(card, name).named_modules())
        for key, bn in getattr(cpu, name).named_modules():
            if not isinstance(bn, torch.nn.BatchNorm2d):
                continue
            mean, var = bn.running_mean, bn.running_var
            other = card_modules[key]
            mean_scale = torch.maximum(mean.abs(), bn.momentum * var.sqrt())
            stat_gap = max(stat_gap,
                           ((other.running_mean.cpu() - mean).abs() / mean_scale).max().item(),
                           ((other.running_var.cpu() - var).abs() / var).max().item())
    return grad_gap, stat_gap


STEP_QUANTITIES = ("losses", "parameters", "buffers", "exp_avg", "exp_avg_sq", "steps")


def step_state(model, optimizer):
    """The tensors a training step reads and writes: the parameters the
    optimizer updates, the BatchNorm buffers, and those parameters' Adam
    state (step counts, first and second moments), made first if absent."""
    from dvmvs_tpu_torch.utils.optim import init_optimizer_state

    tensors = init_optimizer_state(optimizer)
    return {"parameters": [p for g in optimizer.param_groups for p in g["params"]],
            "buffers": list(model.buffers()), "steps": tensors[0::3],
            "exp_avg": tensors[1::3], "exp_avg_sq": tensors[2::3]}


def snapshot(state):
    return {k: [t.detach().clone() for t in v] for k, v in state.items()}


def rel_l2(got, want, base=None):
    """||got - want|| / ||want - base|| over lists of tensors (0 when equal)."""
    if len(got) != len(want) or [g.shape for g in got] != [w.shape for w in want]:
        raise AssertionError(f"{len(got)} tensors against {len(want)}, or other shapes")
    diff = sum(float(((g.double() - w.double()) ** 2).sum()) for g, w in zip(got, want))
    if diff == 0.0:
        return 0.0
    ref = want if base is None else [w.double() - b.double() for w, b in zip(want, base)]
    return (diff / max(sum(float((r.double() ** 2).sum()) for r in ref), 1e-300)) ** 0.5


def reassigning_adam(torch):
    """The planted fault of [train-graphs]: an Adam that rebinds every state
    tensor to a copy before its update, which then writes the copy. Eagerly
    the same steps; a graph's replays read the tensors bound at its capture."""

    class ReassignedState(torch.optim.Adam):
        def step(self, closure=None):
            for state in self.state.values():
                for key, value in list(state.items()):
                    state[key] = value.clone()
            return super().step(closure)

    return ReassignedState


def lockstep_train_runs(torch, base, kind, batches, flips, make_optimizer, modes,
                        group=None):
    """GRAPH_STEPS steps of "eager" and of each of ``modes`` ("repeat":
    eagerly again; "free": eagerly, each step from its own last state;
    anything else through ``GraphedTrainStep``) from ``base``, each step
    but free ones taken from the eager run's state before it, copied in
    place (GRAPH_STEPS' comment); ``make_optimizer(mode, model)``; with
    ``group``, every path the data-parallel step (``make_data_parallel``).
    Returns ({mode: [(loss, state after) a step]}, the eager states before
    each step, {mode: plane-sweep (forward, backward) launches of the steps
    after the first})."""
    from dvmvs_tpu_torch.parallel import train as tt

    runs, before, launches = {}, [], {}
    for mode in ("eager", *modes):
        model = copy.deepcopy(base)
        if group is not None:
            tt.make_data_parallel(model, group)
        optimizer = make_optimizer(mode, model)
        graphed = tt.GraphedTrainStep(model, kind, two_way=kind == "pairnet", group=group)
        steps = []  # eager runs leave ``graphed`` unused
        for i, (batch, flip) in enumerate(zip(batches, flips)):
            live = step_state(model, optimizer)
            if mode == "eager":
                before.append(snapshot(live))
            elif mode != "free":
                with torch.no_grad():
                    for key, tensors in live.items():
                        for t, value in zip(tensors, before[i][key]):
                            t.copy_(value)
            if i == 1:
                mark = launch_mark()
            if mode in ("eager", "repeat", "free"):
                metrics = tt.train_step(model, optimizer, batch, kind, two_way=kind == "pairnet",
                                        flip_mask=flip.tolist(), group=group)
            else:
                metrics = graphed.train(optimizer, batch, flip)
            steps.append((metrics["loss"].clone(), snapshot(step_state(model, optimizer))))
        torch.cuda.synchronize()
        runs[mode], launches[mode] = steps, launches_since(mark)[:2]
    return runs, before, launches


def noise_leaves(runs):
    """Indices of the leaves whose first moment the eager repeat moves by
    more than NOISE_LEAF (relative L2) at some step (GRAPH_STEPS' comment)."""
    noisy = set()
    for (_, got), (_, want) in zip(runs["repeat"], runs["eager"]):
        for j, (g, w) in enumerate(zip(got["exp_avg"], want["exp_avg"])):
            if rel_l2([g], [w]) > NOISE_LEAF:
                noisy.add(j)
    return sorted(noisy)


def lockstep_gaps(steps, runs, before, noisy):
    """The largest gap over the steps of one mode's ``steps`` to the eager
    run's, by quantity (STEP_QUANTITIES): relative L2; the parameters' of
    the step's update; the leaves in ``noisy`` left out of the parameters
    and moments."""
    gaps = dict.fromkeys(STEP_QUANTITIES, 0.0)
    for (loss, got), (want_loss, want), prior in zip(steps, runs["eager"], before):
        def kept(tensors):
            return [t for j, t in enumerate(tensors) if j not in noisy]

        step = {"losses": rel_l2([loss], [want_loss]),
                "parameters": rel_l2(kept(got["parameters"]), kept(want["parameters"]),
                                     kept(prior["parameters"])),
                **{k: rel_l2(kept(got[k]), kept(want[k])) for k in ("exp_avg", "exp_avg_sq")},
                **{k: rel_l2(got[k], want[k]) for k in ("buffers", "steps")}}
        gaps = {k: max(gaps[k], step[k]) for k in gaps}
    return gaps


def train_gaps_within(gaps, repeat):
    """Whether the gaps of a run to the eager one (``lockstep_gaps``) are
    inside [train-graphs]' limits (GRAPH_STEPS' comment): each within the
    larger of STEP_RTOL and EAGER_GAP_FACTOR times the repeat's gap."""
    return all(gaps[n] <= max(STEP_RTOL, EAGER_GAP_FACTOR * repeat[n]) for n in gaps)


def lockstep_optimizer(torch, modules, lr):
    """``lockstep_train_runs``' ``make_optimizer``: the card's capturable
    Adam over ``modules``, or, for the "fault" mode, ``reassigning_adam``."""
    from dvmvs_tpu_torch.parallel import train as tt

    def make(mode, model):
        if mode != "fault":
            optimizer = tt.make_optimizer(model, modules, lr)
            if not optimizer.param_groups[0]["capturable"]:
                raise AssertionError("the card's optimizer is not capturable")
            return optimizer
        params = [p for name in modules for p in getattr(model, name).parameters()]
        return reassigning_adam(torch)(params, lr=lr, eps=1e-8, capturable=True)

    return make


def check_lockstep(torch, label, base, kind, batches, flips, modules, lr, modes, per_step,
                   card, clock, group=None):
    """``lockstep_train_runs`` of ``modes`` (with "graphs" and "fault")
    under deterministic cuDNN, read by [train-graphs]' rules (GRAPH_STEPS'
    comment): one line headed ``label``; raises if the graphed step leaves
    the limits, the planted fault stays inside them, too many values are
    noise leaves or the kernels are not counted at the replays (``per_step``
    forward and backward launches a step). Returns the gaps by mode, the
    noise leaves and the launches at the replays."""
    torch.backends.cudnn.deterministic = True
    try:
        runs, before, launches = lockstep_train_runs(
            torch, base, kind, batches, flips, lockstep_optimizer(torch, modules, lr), modes,
            group)
    finally:
        torch.backends.cudnn.deterministic = False
    noisy = noise_leaves(runs)
    sizes = [t.numel() for t in before[0]["parameters"]]
    noisy_share = sum(sizes[j] for j in noisy) / sum(sizes)
    gaps = {m: lockstep_gaps(runs[m], runs, before, noisy) for m in modes}
    bit_equal = all(v == 0.0 for v in gaps["graphs"].values())
    want_launches = (per_step * (GRAPH_STEPS - 1),) * 2

    def text(g):
        return ", ".join(f"{n} {g[n]:.3e}" for n in STEP_QUANTITIES)

    free = (f"; and free-running (each step from its own last state; parameters of one "
            f"step's update) {text(gaps['free'])}" if "free" in gaps else "")
    print(f"{label}, {GRAPH_STEPS} steps from one seeded model, each from the eager run's state "
          f"before it, capturable Adam, deterministic cuDNN; leaves left out as rounding "
          f"noise {len(noisy)} of {len(sizes)} ({noisy_share:.2e} of the values): "
          f"graphed against eager (largest relative L2 over the steps; parameters of the "
          f"update) {text(gaps['graphs'])} ({'bit-equal' if bit_equal else 'NOT bit-equal'}); "
          f"the eager path against its own repeat {text(gaps['repeat'])}{free}; planted fault "
          f"(Adam state reassigned, not written in place) {text(gaps['fault'])}; plane-sweep "
          f"launches counted over {GRAPH_STEPS - 1} replays {launches['graphs'][0]}/"
          f"{launches['graphs'][1]} (want {want_launches[0]}/{want_launches[1]}) "
          f"({lap(clock):.1f} s) | {card}", flush=True)
    if noisy_share > NOISE_SHARE:
        raise AssertionError(f"{label}: {noisy_share:.2e} of the values left out as noise")
    if not train_gaps_within(gaps["graphs"], gaps["repeat"]):
        raise AssertionError(f"{label}: the graphed step leaves the eager one by more than "
                             f"its limits (GRAPH_STEPS' comment): {gaps['graphs']}")
    if train_gaps_within(gaps["fault"], gaps["repeat"]):
        raise AssertionError(f"{label}: the planted fault (reassigned Adam state) was not "
                             f"caught: {gaps['fault']}")
    if launches["graphs"] != want_launches:
        raise AssertionError(f"{label}: plane-sweep launches at the replays "
                             f"{launches['graphs']}, want {want_launches}")
    return {"bit_equal": bit_equal, "gaps": gaps["graphs"], "eager_repeat_gaps": gaps["repeat"],
            **({"eager_free_running_gaps": gaps["free"]} if "free" in gaps else {}),
            "fault_gaps": gaps["fault"], "noise_leaves": len(noisy),
            "launches_at_replays": list(launches["graphs"])}


def timed_paths(torch, label, kind, batch, flip, card, clock, group=None):
    """The graphed and the eager step timed in turns and profiled
    (``profile_step.train_paths``, GRAPH_TIMING): one line headed
    ``label``; raises unless a graphed step is one ``cudaGraphLaunch`` and
    no kernel launch. Returns each path's numbers."""
    from dvmvs_tpu_torch.apps.profile_step import train_paths

    paths = train_paths(kind, batch, flip, two_way=kind == "pairnet", group=group,
                        **GRAPH_TIMING)["modes"]
    g, e = paths["graphs"], paths["eager"]
    print(f"{label} step median / p90 graphed {g['step_ms']['median']:.3f} / "
          f"{g['step_ms']['p90']:.3f} ms, eager {e['step_ms']['median']:.3f} / "
          f"{e['step_ms']['p90']:.3f} ms; host calls in one step graphed "
          f"{g['host_launches_per_step']}, eager {e['host_launches_per_step']}; device idle "
          f"share of the unprofiled median graphed {g['device_idle_share_unprofiled']:.1%}, "
          f"eager {e['device_idle_share_unprofiled']:.1%}; first-pass peak graphed "
          f"{g['first_pass_peak_mib']:.1f} MiB, eager {e['first_pass_peak_mib']:.1f} MiB; "
          f"kept reserved graphed {g['kept_mib']:.1f} MiB, eager {e['kept_mib']:.1f} MiB "
          f"({lap(clock):.1f} s) | {card}", flush=True)
    host = g["host_launches_per_step"]
    if host["cudaGraphLaunch"] != 1.0 or host["cudaLaunchKernel"] != 0.0:
        raise AssertionError(f"{label}: a graphed step is not one graph launch and copies: "
                             f"{g['host_api_calls_in_step']}")
    return {mode: {k: paths[mode][k] for k in (
        "step_ms", "first_pass_peak_mib", "kept_mib", "host_launches_per_step",
        "device_idle_share_unprofiled", "device_busy_ms")} for mode in ("graphs", "eager")}


FLIPS = ([True, False], [False, True], [True, True])  # pairnet's flips, a step


def train_graphs_phase(torch, device, card, clock, corpus):
    """[train-graphs]: fusionnet B=4 S=8 and two-way pairnet B=14 at 256x256
    on the [train] corpus, GRAPH_STEPS steps through ``GraphedTrainStep``
    and eagerly (twice, the eager path's run-to-run gap), each step from the
    eager run's state before it (``lockstep_train_runs``), every module
    trainable, the capturable Adam, deterministic cuDNN; a planted fault (an
    Adam whose state is reassigned instead of written in place); then the
    two paths timed in turns and one step of each profiled
    (``profile_step.train_paths``). Returns the numbers for the JSON line."""
    from dvmvs_tpu_torch.apps.run_training import make_model
    from dvmvs_tpu_torch.config import TrainConfig
    from dvmvs_tpu_torch.data.dataset import MVSSequenceDataset, batch_iterator
    from dvmvs_tpu_torch.parallel import train as tt

    cfg = TrainConfig()
    report = {}
    for kind, s, b, per_step in (("fusionnet", 8, TB, 7), ("pairnet", 2, PAIR_BATCH, 2)):
        data = MVSSequenceDataset(corpus, "TRAINING", s, cfg, seed=0)
        batches = [{k: torch.from_numpy(v).to(device) for k, v in raw.items()}
                   for raw, _ in zip(batch_iterator(data, b, shuffle=True, seed=1),
                                     range(GRAPH_STEPS))]
        flips = [torch.tensor(f) for f in FLIPS]
        modules = (tt.FUSIONNET_STAGES if kind == "fusionnet" else tt.PAIRNET_STAGES)[-1]
        base = make_model(kind, cfg, device, seed=0).train()
        label = (f"[train-graphs] {kind} B={b} S={s} 256x256"
                 f"{' two-way' if kind == 'pairnet' else ''}")
        report[kind] = check_lockstep(torch, label, base, kind, batches, flips, modules,
                                      cfg.learning_rate, ("repeat", "free", "graphs", "fault"),
                                      per_step, card, clock)
        del base
        report[kind].update(timed_paths(torch, f"[train-graphs] {kind}", kind, batches[0],
                                        flips[0], card, clock))
    return report


def parallel_phase(torch, card, clock):
    """[parallel]: NCCL at world size 1. ``dryrun_multichip(1)``, then one
    pairnet and one fusionnet step through the data-parallel path against
    the plain step at the training shapes; the graphed data-parallel step
    against the eager one by [train-graphs]' rules (``check_lockstep`` with
    the group: its all-reduces inside the graph), both timed in turns.
    Returns the launches of one data-parallel step of each model and the
    graphed and eager numbers."""
    from dvmvs_tpu_torch.apps.dryrun_multichip import dryrun_multichip
    from dvmvs_tpu_torch.apps.run_training import make_model
    from dvmvs_tpu_torch.config import TrainConfig
    from dvmvs_tpu_torch.parallel import mesh
    from dvmvs_tpu_torch.parallel import train as tt

    group, dev = mesh.init_data_parallel(1, device="cuda")
    out = {}
    try:
        dry = dryrun_multichip(1, "cuda")
        print(f"[parallel] NCCL group of 1 on {dev}; dryrun_multichip(1): graphed train step loss "
              f"{dry['loss']:.4f}, sharded serving and two lockstep recurrent steps finite "
              f"({lap(clock):.1f} s)", flush=True)
        for kind, s, b, per_step in (("pairnet", 2, PAIR_BATCH, 2), ("fusionnet", 8, TB, 7)):
            batches = [small_batch(torch, dev, seed=3 + i, s=s, b=b, size=256)
                       for i in range(GRAPH_STEPS)]
            batch = batches[0]
            stages = tt.FUSIONNET_STAGES if kind == "fusionnet" else tt.PAIRNET_STAGES
            two_way = kind == "pairnet"
            plain = make_model(kind, TrainConfig(), dev, seed=0).train()
            repeat = copy.deepcopy(plain)
            dp = tt.make_data_parallel(copy.deepcopy(plain), group)

            def step(model, optimizer, g):
                return tt.train_step(model, optimizer, batch, kind, two_way=two_way,
                                     flip_mask=[True, False], group=g)

            # one step each, every module trainable, deterministic cuDNN. The
            # forward repeats bit for bit, so the loss and the BatchNorm
            # buffers must be equal; the backward kernel (d_meas), bilinear
            # upsampling and grid_sample sum by atomics in no fixed order, so
            # the updated parameters are held to the plain step's own repeat
            torch.backends.cudnn.deterministic = True
            try:
                got = {}
                for name, model, g in (("plain", plain, None), ("repeat", repeat, None),
                                       ("dp", dp, group)):
                    mark = launch_mark()
                    loss = step(model, tt.make_optimizer(model, stages[-1]), g)["loss"]
                    torch.cuda.synchronize()
                    got[name] = (loss, model.state_dict(), *launches_since(mark)[:2])
            finally:
                torch.backends.cudnn.deterministic = False
            (l0, sd0, _, _), (lr, sdr, _, _), (l1, sd1, fwd, bwd) = (
                got["plain"], got["repeat"], got["dp"])
            stats = [k for k in sd0 if k.endswith(("running_mean", "running_var"))]
            params = [k for k, _ in plain.named_parameters()]
            differ = [k for k in stats if not torch.equal(sd0[k], sd1[k])]
            gap = max((sd1[k] - sd0[k]).abs().max().item() for k in params)
            repeat_gap = max((sdr[k] - sd0[k]).abs().max().item() for k in params)
            if not (torch.equal(l0, l1) and torch.equal(l0, lr)) or differ or fwd == 0 \
                    or bwd == 0 or not (gap == 0 if repeat_gap == 0 else gap <= 4 * repeat_gap):
                raise AssertionError(
                    f"[parallel] {kind}: data-parallel step at world size 1 loss {l1.item()} vs "
                    f"{l0.item()} (repeat {lr.item()}), statistics differing {differ[:5]}, "
                    f"parameter gap {gap:.3e} (repeat {repeat_gap:.3e}), launches {fwd}/{bwd}")
            print(f"[parallel] {kind} B={b} S={s} 256x256: data-parallel step at world size 1 "
                  f"against the plain step: loss {l1.item():.6f} and {len(stats)} BatchNorm "
                  f"buffers bit for bit; updated parameters max |diff| {gap:.3e} (the plain "
                  f"step against its own repeat: {repeat_gap:.3e}); kernel launches of one "
                  f"step on a rank: forward {fwd}, backward {bwd} ({lap(clock):.1f} s) | {card}",
                  flush=True)
            del repeat, dp
            # the graphed data-parallel step against the eager one
            label = f"[parallel] {kind} B={b} S={s} 256x256 data-parallel graphed"
            flips = [torch.tensor(f) for f in FLIPS]
            lock = check_lockstep(torch, label, plain, kind, batches, flips, stages[-1],
                                  TrainConfig().learning_rate, ("repeat", "graphs", "fault"),
                                  per_step, card, clock, group)
            del plain
            times = timed_paths(torch, f"[parallel] {kind} data-parallel", kind, batch, flips[0],
                                card, clock, group)
            out[kind] = {"fwd": fwd, "bwd": bwd, **lock, **times}
    finally:
        mesh.destroy()
    return out


def parallel_bulk_phase(tmp, card, clock):
    """[parallel-bulk]: run_testing --n-devices 1 --batch-size 8 on the
    [bulk] scenes against the plain batched run: the same files, equal
    depths, the forward kernel launched by the data-parallel run, and its
    engine's steps graph replays (counted at ``StepGraph.run``)."""
    from dvmvs_tpu_torch.apps import graphs as ag
    from dvmvs_tpu_torch.apps import run_testing as rt

    args = ["--data", tmp, "--dataset-name", BULK_DATASET, "--model", "pairnet",
            "--batch-size", str(BULK_BATCH), "--max-frames", str(BULK_BATCH)]
    rt.main(args + ["--output", os.path.join(tmp, "plain")])
    mark = launch_mark()
    replays = []
    real_run = ag.StepGraph.run
    with patched(ag.StepGraph, "run", lambda self: (replays.append(self.name), real_run(self))[1]):
        rt.main(args + ["--n-devices", "1", "--output", os.path.join(tmp, "dp")])
    fwd, bwd = launches_since(mark)[:2]
    files = sorted(os.listdir(os.path.join(tmp, "plain")))
    if not files or files != sorted(os.listdir(os.path.join(tmp, "dp"))) or not fwd or bwd \
            or "predict_pair_steps" not in replays:
        raise AssertionError(f"[parallel-bulk] files {files}, launches {fwd}/{bwd}, graph "
                             f"steps run {sorted(set(replays))}")
    for f in files:
        a, b = (np.load(os.path.join(tmp, d, f))["arr_0"] for d in ("plain", "dp"))
        if not np.array_equal(a, b):
            raise AssertionError(f"[parallel-bulk] {f} differs")
    print(f"[parallel-bulk] run_testing --n-devices 1 --batch-size {BULK_BATCH} (NCCL) on "
          f"{len(files) // 2} scenes: the plain batched run's {len(files)} files, depths and "
          f"errors equal; forward kernel launches {fwd}, backward 0; graph steps run "
          f"{len(replays)} ({', '.join(sorted(set(replays)))}) ({lap(clock):.1f} s) | {card}",
          flush=True)


def proxy_phase(card, clock, tmp):
    """[proxy]: apps/accuracy_proxy.py end to end at a smoke's size (child
    processes, whose kernel launches the [train] and [bulk] paths count)."""
    from dvmvs_tpu_torch.apps import accuracy_proxy
    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.utils.checkpoint import load_checkpoint

    report = accuracy_proxy.main(["--out", tmp, "--seeds", "3", *PROXY_ARGS])
    summary = report["seeds"]["3"]
    for kind in accuracy_proxy.MODELS:
        metrics = np.asarray(summary[kind])
        if metrics.shape != (8,) or not np.isfinite(metrics).all():
            raise AssertionError(f"[proxy] {kind} metrics {metrics}")
        load_checkpoint(summary["checkpoint"][kind], InferenceEngine(kind, device="cuda").model)
    val = summary["validation"]
    print(f"[proxy] accuracy_proxy {' '.join(PROXY_ARGS)}: corpus, training, evaluation and "
          f"report written; abs_inv pairnet {summary['pairnet'][2]:.4f}, fusionnet "
          f"{summary['fusionnet'][2]:.4f}; validation l1_inv pairnet "
          f"{val['pairnet']['l1_inv']}, fusionnet {val['fusionnet']['l1_inv']}; both best "
          f"checkpoints load into the engine; stage seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in summary["seconds"].items())
          + f" ({lap(clock):.1f} s) | {card}", flush=True)


def precision_phase(torch, card, clock, stream):
    """[precision]: the online fusionnet loop over the [main] stream (its
    cost volumes read out of the graphs), MVDepthNet's ``predict`` over
    seeded keyframes and a graphed fusionnet training step (B=4 S=8,
    256x256; its metrics), each run three ways from fresh objects by
    ``apps/bench_precision.py`` (once each, then one timed round): with
    torch's TF32 defaults left as they are, which the entry points override
    by pinning IEEE float32; under an explicit IEEE setting of the process;
    and with the pin bypassed (``precision.unpinned``, a planted fault: the
    step in TF32). The first way must equal the second bit for bit (at most
    REF_RTOL on every quantity, a depth also against its spread); the
    planted fault must break REF_RTOL on the quantity PRECISION_SHOWS names,
    and every way must leave the process's mode as it found it. Returns each
    path's gaps and times."""
    from dvmvs_tpu_torch.apps import bench_precision as bp
    from dvmvs_tpu_torch.apps.profile_step import synthetic_train_batch
    from dvmvs_tpu_torch.utils import precision

    defaults = precision.current()
    if defaults["cudnn.conv"] != "tf32":
        raise AssertionError(f"[precision] needs torch's TF32 convolutions as the process "
                             f"default, found {defaults}")
    host_batch = synthetic_train_batch(256, 4, 8)
    paths = {"online": lambda: bp.online("fusionnet", stream),
             "mvdepthnet": lambda: bp.baseline("mvdepthnet"),
             "train": lambda: bp.train(host_batch)}
    report = {}
    for path, make in paths.items():
        r = report[path] = bp.compare(make, rounds=1)
        pinned, fault = r["gaps_to_ieee"]["defaults"], r["gaps_to_ieee"]["tf32"]
        shows = PRECISION_SHOWS[path]
        print(f"[precision] {path}: torch's defaults against explicit IEEE, gaps "
              + ", ".join(f"{q} {v:.3e}" for q, v in pinned.items())
              + f" (tol {REF_RTOL:g}); planted fault, the pin bypassed (TF32): "
              + ", ".join(f"{q} {v:.3e}" for q, v in fault.items())
              + f" (must exceed {REF_RTOL:g} on {shows}); median ms "
              + ", ".join(f"{m} {t['median']:.3f}" for m, t in r["ms"].items())
              + f" ({lap(clock):.1f} s) | {card}", flush=True)
        if precision.current() != defaults:
            raise AssertionError(f"[precision] {path}: the process mode was not restored: "
                                 f"{precision.current()}")
        if not max(pinned.values()) <= REF_RTOL:
            raise AssertionError(f"[precision] {path}: with torch's TF32 defaults the step "
                                 f"does not compute in IEEE float32")
        if not fault[shows] > REF_RTOL:
            raise AssertionError(f"[precision] {path}: the planted fault (the pin bypassed) "
                                 f"did not break the limit on {shows}")
    return report


def main():
    start = time.perf_counter()
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    from dvmvs_tpu_torch.apps.bench_plane_sweep import ptxas_report
    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.apps.profile_step import synthetic_stream
    from dvmvs_tpu_torch.apps.run_testing_online import predict_stream
    from dvmvs_tpu_torch.config import DepthConfig, TestConfig, TrainConfig
    from dvmvs_tpu_torch.ops import cuda_build, dlt
    from dvmvs_tpu_torch.ops import plane_sweep as ps
    from dvmvs_tpu_torch.ops.sweep_measure import (SINGLE_LAUNCH_TIMER, TIMER, binned_share,
                                                   single_launch_ms, sweep_bound, sweep_case,
                                                   time_ms)
    from dvmvs_tpu_torch.utils import precision
    from dvmvs_tpu_torch.utils.results import InferenceTimer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    device = torch.device("cuda")
    # torch's TF32 defaults are left as they are: every entry point pins its
    # own mode, which [precision] checks
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | {precision.describe()}",
          flush=True)

    # 2. build: one nvcc per source, all at once
    t0 = time.perf_counter()
    logs = cuda_build.load_all(ps.KERNELS + dlt.KERNELS)
    ptxas = {name: ptxas_report(log) for name, log in logs.items()}
    print(f"[build] {', '.join(f'{n}.cu' for n in logs)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (ptxas: "
          + "; ".join(f"{n}: {', '.join(f'{k} {v}' for k, v in r.items()) or 'cached'}"
                      for n, r in ptxas.items()) + ")", flush=True)
    clock = [time.perf_counter()]

    # 3. kernel vs plain version at the path's shapes
    max_err = 0.0
    rgb_err = 0.0
    for name, (shape, euler, t, weights, dot, *depths) in CASES.items():
        ref, meas, mats, w = sweep_case(shape, euler, t, weights, seed=0, device=device,
                                        **({"depths": depths[0]} if depths else {}))
        want = ps.plane_sweep_multiview_plain(ref, meas, mats, w, dot)
        torch.cuda.synchronize()
        got = ps.plane_sweep_multiview(ref, meas, mats, w, dot)
        torch.cuda.synchronize()
        err, tol = (got - want).abs().max().item(), TOL[dot]
        print(f"[compare] {name} {shape}: max_abs_diff={err:.3e} (tol {tol:g}), "
              f"max |cost| {want.abs().max().item():.3f} ({lap(clock):.1f} s)", flush=True)
        if not (np.isfinite(err) and err <= tol):
            raise AssertionError(f"kernel disagrees with the plain version on {name}: {err}")
        max_err = max(max_err, err)
        if shape == BASELINE_SWEEP:
            rgb_err = max(rgb_err, err)

    # 4. time at the online shape and at 640x480 frames (typical geometry,
    # dot product) and at the baselines' L1 shape, beside the least time the
    # card could take (the bound)
    timing = {}
    for shape, dot, depths in ((ONLINE, True, (0.25, 20.0)), (FRAMES_640, True, (0.25, 20.0)),
                               (BASELINE_SWEEP, False, BASELINE_DEPTHS)):
        ref, meas, mats, w = sweep_case(shape, seed=1, device=device, depths=depths)
        kernel_ms = time_ms(lambda: ps.plane_sweep_multiview(ref, meas, mats, w, dot))
        plain_ms = time_ms(lambda: ps.plane_sweep_multiview_plain(ref, meas, mats, w, dot))
        kernel_ms_2 = time_ms(lambda: ps.plane_sweep_multiview(ref, meas, mats, w, dot))
        single_ms = single_launch_ms(lambda: ps.plane_sweep_multiview(ref, meas, mats, w, dot))
        bound = sweep_bound(ref, meas, mats, w)
        timing[shape] = (kernel_ms, plain_ms, bound, single_ms)
        print(f"[time] plane sweep {'dot' if dot else 'L1'} (B,V,C,H,W,P)={shape}: kernel "
              f"{kernel_ms:.4f} ms (again "
              f"{kernel_ms_2:.4f}; {TIMER}), single launches through the wrapper {single_ms:.4f} "
              f"ms ({SINGLE_LAUNCH_TIMER}), plain {plain_ms:.4f} ms; bound "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({bound['bytes']} bytes, "
              f"{bound['flops']} flops), {bound['bound_ms'] / kernel_ms:.1%} of it reached "
              f"({lap(clock):.1f} s)", flush=True)

    # 4b. the bulk shape: eight batch elements of another geometry each, the
    # second view masked in every other one
    ref, meas, mats, w = bulk_case(torch, ps, 4, device)
    want = ps.plane_sweep_multiview_plain(ref, meas, mats, w)
    got = ps.plane_sweep_multiview(ref, meas, mats, w)
    bulk_err = (got - want).abs().max().item()
    if not (np.isfinite(bulk_err) and bulk_err <= TOL[True]):
        raise AssertionError(f"kernel disagrees with the plain version at the bulk shape: "
                             f"{bulk_err}")
    max_err = max(max_err, bulk_err)
    bulk_ms = time_ms(lambda: ps.plane_sweep_multiview(ref, meas, mats, w))
    bulk_plain_ms = time_ms(lambda: ps.plane_sweep_multiview_plain(ref, meas, mats, w))
    bulk_bound = sweep_bound(ref, meas, mats, w)
    print(f"[compare] bulk (B,V,C,H,W,P)={BULK}, a geometry per element, view 1 masked in 4: "
          f"max_abs_diff={bulk_err:.3e} (tol {TOL[True]:g}); kernel {bulk_ms:.4f} ms, plain "
          f"{bulk_plain_ms:.4f} ms ({TIMER}); bound {bulk_bound['bound_ms']:.4f} ms by "
          f"{bulk_bound['bound_by']}, {bulk_bound['bound_ms'] / bulk_ms:.1%} of it reached "
          f"({lap(clock):.1f} s)", flush=True)

    # 5. main path: the fusionnet online loop at 320x256
    cfg = TestConfig()
    t0 = time.perf_counter()
    frames, poses, K = synthetic_stream(cfg, N_FRAMES)
    print(f"[scene] {N_FRAMES} frames rendered at {cfg.image_width}x{cfg.image_height} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    engine = InferenceEngine("fusionnet", cfg, device=device, seed=0)
    timer = InferenceTimer(n_skip=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mark = launch_mark()
    predictions, indices = predict_stream(engine, frames, poses, K, cfg, timer=timer)
    torch.cuda.synchronize()
    launches, backward = launches_since(mark)[:2]
    if backward:
        raise AssertionError("the online path launched the backward kernel")
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    d = cfg.depth
    if len(predictions) < N_MIN_KEYFRAMES:
        raise AssertionError(f"only {len(predictions)} keyframes predicted")
    for i, p in zip(indices, predictions):
        if p.shape != (cfg.image_height, cfg.image_width) or not np.isfinite(p).all():
            raise AssertionError(f"frame {i}: bad depth shape {p.shape} or non-finite values")
        if p.min() < d.min_depth - 1e-4 or p.max() > d.max_depth + 1e-4:
            raise AssertionError(f"frame {i}: depth outside [{d.min_depth}, {d.max_depth}]")
    if float(engine.has_prev) != 1.0:
        raise AssertionError("fusionnet recurrent state was not carried")
    if launches < len(predictions):
        raise AssertionError(f"kernel launched {launches} times for {len(predictions)} keyframes")
    steady = timer.times[1:]
    print(f"[main] fusionnet {len(predictions)} keyframes of {N_FRAMES} frames: depth "
          f"{min(p.min() for p in predictions):.4f}..{max(p.max() for p in predictions):.4f} m, "
          f"has_prev=1, kernel launches {launches}, encode_and_predict median "
          f"{np.median(steady):.3f} ms p90 {np.percentile(steady, 90):.3f} ms over "
          f"{len(steady)} (first {timer.times[0]:.1f} ms), peak memory {peak_mib:.1f} MiB "
          f"({lap(clock):.1f} s)", flush=True)

    # 6. the same stream's first keyframes on the CPU, same seeded weights
    cpu_engine = InferenceEngine("fusionnet", cfg, device="cpu", seed=0)
    stop = indices[N_REF_KEYFRAMES - 1] + 1
    ref_preds, ref_indices = predict_stream(cpu_engine, frames[:stop], poses[:stop], K, cfg)
    if ref_indices != indices[:N_REF_KEYFRAMES]:
        raise AssertionError(f"keyframe schedule differs on the CPU: {ref_indices}")
    rel = max(float(np.max(np.abs(a - b) / b)) for a, b in zip(predictions, ref_preds))
    print(f"[reference] first {N_REF_KEYFRAMES} keyframes, card vs CPU plain path: max "
          f"relative depth difference {rel:.3e} (tol {REF_RTOL:g}; {lap(clock):.1f} s)",
          flush=True)
    if not rel <= REF_RTOL:
        raise AssertionError("card and CPU depths disagree")

    # 6a. [precision] the steps in torch's TF32 defaults against an explicit
    # IEEE setting, and with the pin bypassed (a planted fault)
    arithmetic = precision_phase(torch, card, clock, (frames, poses, K))

    # 7. [bwd-compare] at the training shape and the cases around it: the
    # forward kernel (K3/K4 with V=1) and the backward kernel (K5/K6) against
    # the plain version and autograd through it; d_ref bit-identical over two
    # calls, and a masked view's d_meas exactly 0
    bwd_err = 0.0
    for name in BWD_CASES:
        ref, meas, mats, w, g = bwd_case(torch, ps, 2, name, device)
        fwd_err = (ps.plane_sweep_multiview(ref, meas, mats, w)
                   - ps.plane_sweep_multiview_plain(ref, meas, mats, w)).abs().max().item()
        want = ps.plane_sweep_backward_plain(ref, meas, mats, w, g)
        got = ps.plane_sweep_backward(ref, meas, mats, w, g)
        again = ps.plane_sweep_backward(ref, meas, mats, w, g)
        torch.cuda.synchronize()
        (nb, h, wd, c), v = ref.shape, w.shape[1]
        line = [f"[bwd-compare] {name} (B={nb}, V={v}, C={c}, {h}x{wd}, P={P}): forward "
                f"max_abs_diff {fwd_err:.3e} (tol {TOL[True]:g})"]
        if not (np.isfinite(fwd_err) and fwd_err <= TOL[True]):
            raise AssertionError(f"forward disagrees on {name}: {fwd_err}")
        for label, a, b in zip(("d_ref", "d_meas"), got, want):
            err, scale = (a - b).abs().max().item(), b.abs().max().item()
            line.append(f"{label} max_abs_diff {err:.3e} (max |grad| {scale:.3e}, limit "
                        f"{GRAD_ATOL * max(scale, 1.0):.3e})")
            if not (np.isfinite(err) and err <= GRAD_ATOL * max(scale, 1.0)):
                raise AssertionError(f"backward kernel disagrees on {name} {label}: {err}")
            bwd_err = max(bwd_err, err)
        if not torch.equal(got[0], again[0]):
            raise AssertionError(f"d_ref differs between two calls on {name}")
        masked = got[1][w == 0]
        if masked.numel() and masked.abs().max().item() != 0.0:
            raise AssertionError(f"a masked view got a gradient on {name}")
        binned, steps = binned_share(mats, w, h, wd)
        line.append(f"d_ref bit-identical over two calls; {masked.shape[0]} masked view(s) "
                    f"with d_meas exactly 0; d_meas binned in {binned} of {steps} chunk steps")
        print("; ".join(line) + f" ({lap(clock):.1f} s)", flush=True)

    # 8. [bwd-time]: forward + backward of the kernel pair against the plain
    # version with autograd, then the backward alone
    ref, meas, mats, w, g = bwd_case(torch, ps, 3, "typical", device)
    r, m = ref.clone().requires_grad_(), meas.clone().requires_grad_()

    def pair(sweep):
        return lambda: torch.autograd.grad(sweep(r, m, mats, w), (r, m), g)

    pair_ms = time_ms(pair(ps.plane_sweep_multiview))
    plain_pair_ms = time_ms(pair(ps.plane_sweep_multiview_plain))
    pair_ms_2 = time_ms(pair(ps.plane_sweep_multiview))
    plain_out = ps.plane_sweep_multiview_plain(r, m, mats, w)
    bwd_ms = time_ms(lambda: ps.plane_sweep_backward(ref, meas, mats, w, g))
    bwd_single_ms = single_launch_ms(lambda: ps.plane_sweep_backward(ref, meas, mats, w, g))
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(plain_out, (r, m), g,
                                                              retain_graph=True))
    train_fwd_ms = time_ms(lambda: ps.plane_sweep_multiview(ref, meas, mats, w))
    del plain_out
    bwd_bound = sweep_bound(ref, meas, mats, w, backward=True)
    train_fwd_bound = sweep_bound(ref, meas, mats, w)
    print(f"[bwd-time] ({TB},1,{TC},{TH},{TW}) P={P}, typical geometry: forward+backward "
          f"kernels {pair_ms:.4f} ms (again {pair_ms_2:.4f}), plain with autograd "
          f"{plain_pair_ms:.4f} ms; backward alone: kernel {bwd_ms:.4f} ms (single launches "
          f"{bwd_single_ms:.4f} ms), plain (autograd "
          f"of a kept graph) {plain_bwd_ms:.4f} ms, bound {bwd_bound['bound_ms']:.4f} ms by "
          f"{bwd_bound['bound_by']} ({bwd_bound['bound_ms'] / bwd_ms:.1%} of it reached); "
          f"forward kernel alone {train_fwd_ms:.4f} ms, bound {train_fwd_bound['bound_ms']:.4f} "
          f"ms ({train_fwd_bound['bound_ms'] / train_fwd_ms:.1%}) ({lap(clock):.1f} s)", flush=True)

    # 9. [train] the training path: run_training.main on a 256x256 corpus
    from dvmvs_tpu_torch.apps import run_training
    from dvmvs_tpu_torch.data.dataset import MVSSequenceDataset, batch_iterator
    from dvmvs_tpu_torch.parallel import train as tt

    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        write_corpus(corpus)
        print(f"[train] corpus: scenes {TRAIN_SCENE} and {VAL_SCENE} (seed, frames) rendered at "
              f"256x256 ({lap(clock):.1f} s)", flush=True)
        runs, run_dirs = {}, {}
        for kind, s, extra, steps, n_stages in (
                ("fusionnet", 8, ["--epochs", "3"], TRAIN_STEPS, 3),
                ("pairnet", 2, ["--epochs", "2", "--finetune-epochs", "1", "--no-validate"],
                 PAIR_STEPS, 2)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mark = launch_mark()
            run_dirs[kind] = run_dir = run_training.main(
                ["--model", kind, "--dataset", corpus, "--run-directory",
                 os.path.join(tmp, "runs"), "--max-steps", str(steps), "--print-frequency", "1",
                 "--device", "cuda", *extra])
            torch.cuda.synchronize()
            runs[kind] = check_run(torch, mark, run_dir, kind, n_stages, steps, s,
                                   torch.cuda.max_memory_allocated() / 2 ** 20)
            print(f"[train] {kind} run done ({lap(clock):.1f} s)", flush=True)

        # --resume across the paths: one more epoch of the last stage from the
        # graphed run's state with --no-graphs, then that state through the
        # graphs (bit for bit against each other in tests/test_torch_run_training.py)
        def resume(state, epochs, *extra):
            run_dir = run_training.main(
                ["--model", "fusionnet", "--dataset", corpus, "--run-directory",
                 os.path.join(tmp, "runs"), "--max-steps", "1", "--print-frequency", "1",
                 "--device", "cuda", "--epochs", str(epochs), "--no-validate",
                 "--resume", state, *extra])
            with open(os.path.join(run_dir, "fusionnet_latest.state.pt.meta.json")) as f:
                meta = json.load(f)
            losses = [e["loss"] for e in read_run(run_dir)[0]]
            if meta["epoch"] != epochs or meta["stage"] != 2 or len(losses) != 1 \
                    or not np.isfinite(losses).all():
                raise AssertionError(f"resume: meta {meta}, losses {losses}")
            return os.path.join(run_dir, "fusionnet_latest.state.pt"), losses[0]

        eager_state, eager_loss = resume(
            os.path.join(run_dirs["fusionnet"], "fusionnet_latest.state.pt"), 4, "--no-graphs")
        _, graphed_loss = resume(eager_state, 5)
        print(f"[train] fusionnet resumed at epoch 3 (stage 2) from the graphed run's state with "
              f"--no-graphs: loss {eager_loss:.6f}; that state resumed through the graphs at "
              f"epoch 4: loss {graphed_loss:.6f}; resume states at epochs 4 and 5 "
              f"({lap(clock):.1f} s)", flush=True)

        # 10. [overfit]: 5 Adam steps at lr 1e-3 on one fixed batch
        cfg_train = TrainConfig()
        data = MVSSequenceDataset(corpus, "TRAINING", 8, cfg_train, seed=0)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(batch_iterator(data, 4, shuffle=False)).items()}
        model = run_training.make_model("fusionnet", cfg_train, device, seed=0).train()
        optimizer = tt.make_optimizer(model, tt.FUSIONNET_STAGES[2], 1e-3)
        losses = [tt.train_step(model, optimizer, batch)["loss"].item() for _ in range(5)]
        print(f"[overfit] fusionnet B=4 S=8 256x256, 5 Adam steps at lr 1e-3 on one batch: "
              f"loss {' -> '.join(f'{v:.4f}' for v in losses)} ({lap(clock):.1f} s)", flush=True)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"the loss did not fall: {losses}")

        # 10a. [train-graphs]: the graphed training step against the eager one
        train_graphs = train_graphs_phase(torch, device, card, clock, corpus)

        # 10b. [real-data]: a ScanNet user's path, training on this corpus
        real = real_data_phase(torch, device, cfg, card, clock, tmp, corpus)

    # 11. [train-ref]: one train step on the card against the CPU, small size
    cfg_small = TrainConfig(image_width=64, image_height=64,
                                         depth=DepthConfig(0.25, 20.0, 16))
    for freeze_bn in (False, True):
        cpu = run_training.make_model("fusionnet", cfg_small, "cpu", seed=1).train(not freeze_bn)
        card_model = copy.deepcopy(cpu).to(device)
        step_losses = []
        for model, dev in ((card_model, device), (cpu, "cpu")):
            optimizer = tt.make_optimizer(model, tt.FUSIONNET_STAGES[2])
            step_losses.append(tt.train_step(model, optimizer, small_batch(torch, dev))["loss"]
                               .item())
        loss_gap = abs(step_losses[0] - step_losses[1]) / abs(step_losses[1])
        grad_gap, stat_gap = train_step_gaps(torch, cpu, card_model, freeze_bn)
        grad_tol = FROZEN_GRAD_TOL if freeze_bn else TRAIN_GRAD_L2
        print(f"[train-ref] fusionnet step 64x64 S=3 B=2 P=16, BatchNorm "
              f"{'frozen' if freeze_bn else 'train'}: card vs CPU loss {step_losses[0]:.6f} vs "
              f"{step_losses[1]:.6f} (relative gap {loss_gap:.3e}, tol {STEP_RTOL:g}); "
              f"gradients {'per tensor' if freeze_bn else 'per module, relative L2'} "
              f"{grad_gap:.3e} (tol {grad_tol:g}); statistics {stat_gap:.3e} (tol "
              f"{STEP_RTOL:g}) ({lap(clock):.1f} s)", flush=True)
        if not (loss_gap <= STEP_RTOL and grad_gap <= grad_tol and stat_gap <= STEP_RTOL):
            raise AssertionError("the card's train step disagrees with the CPU's")

    # 11b. [parallel] the data-parallel path over NCCL at world size 1
    parallel = parallel_phase(torch, card, clock)

    # 12. bulk evaluation and TSDF reconstruction at TestConfig, then the
    # data-parallel bulk driver on the same scenes
    with tempfile.TemporaryDirectory() as tmp:
        bulk = bulk_phases(torch, device, cfg, card, clock, tmp)
        parallel_bulk_phase(tmp, card, clock)
        # 12c. [graphs] every serving step as one CUDA graph replay, online
        # and in bulk chunks, against the eager path, with planted faults
        graphs = {"online": graphs_online_phase(torch, device, cfg, card, clock,
                                                (frames, poses, K)),
                  "bulk": graphs_bulk_phase(torch, device, cfg, card, clock, bulk)}

    # 12a. [proxy] the accuracy proxy's driver at a smoke's size
    with tempfile.TemporaryDirectory() as tmp:
        proxy_phase(card, clock, tmp)

    # 12b. the four baselines through their evaluation loop
    with tempfile.TemporaryDirectory() as tmp:
        baselines = baseline_phases(torch, device, card, clock, tmp)
    # 12d. [baseline-graphs] the baselines' graphed predict against the eager one
    baseline_graphs = baseline_graphs_phase(torch, card, clock, baselines)
    # 12e. [dlt] the DLT-solve kernel against its plain version, and its time
    solve = dlt_phase(torch, card, clock, baselines)

    # 13. results: the forward at the online shape (its main path), the
    # backward at the training shape
    fwd_launches, bwd_launches = runs["fusionnet"][:2]
    online_ms, online_plain_ms, online_bound, online_single_ms = timing[ONLINE]
    big_ms, big_plain_ms, big_bound, _ = timing[FRAMES_640]
    rgb_ms, rgb_plain_ms, rgb_bound, rgb_single_ms = timing[BASELINE_SWEEP]
    print(f"[total] {time.perf_counter() - start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": [{
        "name": "plane_sweep_multiview",
        "route": "cuda",
        "source": "dvmvs_tpu_torch/csrc/plane_sweep.cu",
        "replaces": "dvmvs_tpu/ops/pallas/cost_volume_kernel.py:274",
        "also_replaces": ["dvmvs_tpu/ops/pallas/cost_volume_kernel.py:408",
                          "dvmvs_tpu/ops/pallas/cost_volume_kernel.py:135",
                          "dvmvs_tpu/ops/pallas/cost_volume_kernel.py:524"],
        "note": "K3/K4 (single-view training forward) are this kernel with V=1, weight 1",
        "shape": dict(zip("BVCHWP", ONLINE)),
        "launches": launches,
        "launches_training": fwd_launches,
        "max_abs_err": max_err,
        "ms": online_ms,
        "plain_ms": online_plain_ms,
        "bound_ms": online_bound["bound_ms"],
        "bound_by": online_bound["bound_by"],
        "library_ms": None,
        "share_of_bound": online_bound["bound_ms"] / online_ms,
        "timer": TIMER,
        "ms_single_launch": online_single_ms,
        "single_launch_timer": SINGLE_LAUNCH_TIMER,
        "ms_640x480": big_ms,
        "plain_ms_640x480": big_plain_ms,
        "bound_ms_640x480": big_bound["bound_ms"],
        "ms_training": train_fwd_ms,
        "bound_ms_training": train_fwd_bound["bound_ms"],
        "shape_bulk": dict(zip("BVCHWP", BULK)),
        "launches_bulk": bulk["launches"],
        "launches_graphs_online": {k: graphs["online"][k]["launches"]
                                   for k in ("fusionnet", "pairnet")},
        "launches_graphs_bulk": {k: v["launches"] for k, v in graphs["bulk"].items()
                                 if isinstance(v, dict)},
        "max_abs_err_bulk": bulk_err,
        "ms_bulk": bulk_ms,
        "plain_ms_bulk": bulk_plain_ms,
        "bound_ms_bulk": bulk_bound["bound_ms"],
        "bound_by_bulk": bulk_bound["bound_by"],
        "share_of_bound_bulk": bulk_bound["bound_ms"] / bulk_ms,
        "launches_parallel_step": {k: v["fwd"] for k, v in parallel.items()},
        "launches_real_data": real["fwd"],
        "shape_baselines_l1": dict(zip("BVCHWP", BASELINE_SWEEP)),
        "launches_baselines_l1": {k: baselines[k]["launches"] for k in ("mvdepthnet", "gpmvs")},
        "max_abs_err_baselines_l1": rgb_err,
        "ms_baselines_l1": rgb_ms,
        "ms_single_launch_baselines_l1": rgb_single_ms,
        "plain_ms_baselines_l1": rgb_plain_ms,
        "bound_ms_baselines_l1": rgb_bound["bound_ms"],
        "bound_by_baselines_l1": rgb_bound["bound_by"],
        "share_of_bound_baselines_l1": rgb_bound["bound_ms"] / rgb_ms,
    }, {
        "name": "plane_sweep_backward",
        "route": "cuda",
        "source": "dvmvs_tpu_torch/csrc/plane_sweep_bwd.cu",
        "replaces": "dvmvs_tpu/ops/pallas/cost_volume_vjp.py:127",
        "also_replaces": ["dvmvs_tpu/ops/pallas/cost_volume_vjp.py:251"],
        "shape": {"B": TB, "V": 1, "C": TC, "H": TH, "W": TW, "P": P},
        "launches": bwd_launches,
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": plain_bwd_ms,
        "bound_ms": bwd_bound["bound_ms"],
        "bound_by": bwd_bound["bound_by"],
        "library_ms": None,
        "share_of_bound": bwd_bound["bound_ms"] / bwd_ms,
        "timer": TIMER,
        "ms_single_launch": bwd_single_ms,
        "single_launch_timer": SINGLE_LAUNCH_TIMER,
        "launches_parallel_step": {k: v["bwd"] for k, v in parallel.items()},
        "launches_real_data": real["bwd"],
    }, {
        "name": "dlt_solve",
        "route": "cuda",
        "source": "dvmvs_tpu_torch/csrc/dlt_solve.cu",
        "replaces": "dvmvs_tpu/baselines/deltas.py:343",
        "note": "replaces no TPU kernel: DELTAS's batched SVD (jnp.linalg.svd in "
                "triangulate_dlt, compiled by XLA inside the model's jit), which "
                "torch.linalg.svd cannot take inside a CUDA graph; max_abs_err in "
                "metres over the points DELTAS keeps, against the float32 plain version "
                "and (max_abs_err_float64) the same call in float64",
        "shape": {"systems": solve["shape"][1], "rows": solve["shape"][2]},
        "launches": baselines["deltas"]["dlt_launches"],
        "launches_graphed_pass": baseline_graphs["deltas"]["dlt_solve_launches_graphed_pass"],
        "max_abs_err": solve["max_abs_err"],
        "max_abs_err_float64": solve["max_abs_err_float64"],
        "ms": solve["ms"],
        "plain_ms": solve["plain_ms"],
        "bound_ms": solve["bound"]["bound_ms"],
        "bound_by": solve["bound"]["bound_by"],
        "library_ms": solve["library_ms"],
        "share_of_bound": solve["bound"]["bound_ms"] / solve["ms"],
        "timer": TIMER,
        "ms_single_launch": solve["ms_single_launch"],
        "plain_ms_single_launch": solve["plain_ms_single"],
        "ms_in_graph": baseline_graphs["deltas"]["graphs"]["dlt_solve_ms"],
        "launch_floor_ms": solve["launch_floor_ms"],
        "ptxas": ptxas["dlt_solve"],
        "gaps": {k: solve[k] for k in ("scene", "seeded")},
    }], "graphs": graphs, "baseline_graphs": {
        name: {k: v for k, v in r.items() if k in ("depth_gap", "bit_equal", "captured_steps",
                                                   "plane_sweep_launches_graphed_pass",
                                                   "dlt_solve_launches_graphed_pass")}
        | {mode: {k: r[mode][k] for k in ("predict_ms", "first_pass_peak_mib", "kept_mib",
                                          "host_launches_per_predict", "dlt_solve_ms")}
           for mode in ("graphs", "eager")}
        for name, r in baseline_graphs.items()},
        "parallel": {kind: {k: v for k, v in r.items() if k not in ("fwd", "bwd")}
                     for kind, r in parallel.items()},
        "train_graphs": train_graphs,
        "precision": arithmetic,
        "real_data": {k: v for k, v in real.items() if k not in ("fwd", "bwd")}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
