"""Bulk offline evaluation over keyframe index files (counterpart of
dvmvs_tpu/apps/run_testing.py; reference: dvmvs/fusionnet/run-testing.py,
dvmvs/pairnet/run-testing.py).

Iterates ``<data>/indices/keyframe+<dataset>+<scene>+nmeas+<N>`` files
(written by ``apps/simulate_keyframe_buffer.py``); per line it loads the
reference and measurement frames by file name, preprocesses them, predicts,
and saves the predictions and the 8 error metrics as npz. Fusionnet resets
its recurrent state on ``TRACKING LOST`` lines. Three evaluators:

  - ``evaluate_scene``: one keyframe at a time; measurement features are
    kept on the device in a bounded FIFO cache, so a frame runs the
    backbone once while it stays in the cache.
  - ``evaluate_scene_batched`` (pairnet): B independent keyframes a step
    from a device-resident feature bank of the scene's unique frames.
  - ``evaluate_scenes_batched_fusion`` (fusionnet): B scenes in lockstep,
    one batched recurrent step each, per-scene keep masks for resets.

Both batched evaluators keep the scene's unique frames and their features
on the device, upload every step's indices and poses once, and run
``scan_chunk`` steps at a time as one chunk (``InferenceEngine.
predict_pair_steps`` / ``fusion_steps``): on the card one CUDA graph replay
a chunk, the JAX driver's one ``lax.scan`` dispatch a chunk, with one
readback each; ``scan_chunk`` 0 or 1 replays and reads back every step.
The bank is encoded in batches by ``encode_batch``, one replay a batch.

Run on the card (the default; ``--device cpu`` asks for the CPU):
``python -m dvmvs_tpu_torch.apps.run_testing --model pairnet --data DIR
--batch-size 8 [--scan-chunk 4]``. ``--visualize`` writes the sequential
evaluator's PNG panels under ``visualizations/`` (``utils/visualization.py``;
the JAX package's live OpenCV windows are not ported).

Data parallel (``--n-devices N`` with ``--batch-size`` or ``--scene-batch``,
one process a device: ``torchrun --nproc-per-node N -m
dvmvs_tpu_torch.apps.run_testing --n-devices N ...``): each rank runs its
rows of every pairnet batch, or its scenes of every lockstep group, and the
results are gathered; rank 0 writes the same files as one process does.
Each rank's engine runs its steps as graph replays, as on one device (the
JAX driver's jitted programs on sharded inputs); the gathers run between
them. ``--scan-chunk`` is for one device, as in the JAX driver: with more
than one device each step is a replay and a readback.

Under ``torch.profiler`` the batched evaluators' host work shows as spans
(``utils/profiling.py::span``): ``dvmvs.bulk.index`` (the index file, the
unique frames and the bank index, once a scene), ``dvmvs.bulk.frames``
(loading, stacking and uploading a batch of bank frames),
``dvmvs.bulk.schedule`` (the step table and its upload) and
``dvmvs.bulk.readback`` (a chunk's copy to the host). The counters
``bulk.slots`` and ``bulk.pad_slots`` count the keyframe slots the chunks
compute and those no keyframe asked for; ``main`` prints every counter
that moved over the run.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dvmvs_tpu_torch.apps.engine import InferenceEngine
from dvmvs_tpu_torch.config import MEAN_RGB, SCALE_RGB, STD_RGB, TestConfig
from dvmvs_tpu_torch.data.io import load_depth_png, load_image
from dvmvs_tpu_torch.data.preprocess import PreprocessImage
from dvmvs_tpu_torch.parallel import mesh
from dvmvs_tpu_torch.utils.checkpoint import load_checkpoint
from dvmvs_tpu_torch.utils.precision import describe
from dvmvs_tpu_torch.utils.profiling import counters, describe_counts, span
from dvmvs_tpu_torch.utils.results import InferenceTimer, save_results
from dvmvs_tpu_torch.utils.visualization import VIS_DIR, save_visualization

BANK_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def read_index(index_file: str) -> List[str]:
    with open(index_file) as f:
        return [line for line in f.read().splitlines() if line]


class SceneAssets:
    """Scene loading shared by the evaluators: intrinsics, poses, file name
    indices, the preprocessor, and a bounded FIFO cache of preprocessed
    frames (the batched drivers revisit frames; an unbounded float32 cache
    would pin gigabytes of host memory on long scenes)."""

    def __init__(self, scene_folder: str, cfg: TestConfig, evaluate: bool = True,
                 cache_frames: int = 512):
        self.K_raw = np.loadtxt(os.path.join(scene_folder, "K.txt")).astype(np.float32)
        self.poses = np.fromfile(os.path.join(scene_folder, "poses.txt"), dtype=float,
                                 sep="\n ").reshape(-1, 4, 4)
        self.images_dir = os.path.join(scene_folder, "images")
        self.image_filenames = sorted(
            f for f in os.listdir(self.images_dir) if f.endswith(".png"))
        self.frame_index = {f: i for i, f in enumerate(self.image_filenames)}
        self.depth_dir = os.path.join(scene_folder, "depth")
        self.depth_filenames = (
            sorted(f for f in os.listdir(self.depth_dir) if f.endswith(".png"))
            if evaluate and os.path.isdir(self.depth_dir) else None)

        first = load_image(os.path.join(self.images_dir, self.image_filenames[0]))
        self.preprocessor = PreprocessImage(
            K=self.K_raw, old_width=first.shape[1], old_height=first.shape[0],
            new_width=cfg.image_width, new_height=cfg.image_height,
            distortion_crop=cfg.distortion_crop, perform_crop=cfg.perform_crop)
        self.updated_K = self.preprocessor.get_updated_intrinsics().astype(np.float32)
        self._cache: Dict[str, np.ndarray] = {}
        self._order: List[str] = []
        self._cap = cache_frames

    def image(self, name: str) -> np.ndarray:
        """Preprocessed float32 frame, cached (first in, first out) up to
        ``cache_frames``."""
        hit = self._cache.get(name)
        if hit is not None:
            return hit
        img = self.preprocessor.apply_rgb(
            load_image(os.path.join(self.images_dir, name)), SCALE_RGB, MEAN_RGB,
            STD_RGB).astype(np.float32)
        if len(self._order) >= self._cap:
            self._cache.pop(self._order.pop(0), None)
        self._cache[name] = img
        self._order.append(name)
        return img

    def gt_depth(self, ref_name: str) -> Optional[np.ndarray]:
        if self.depth_filenames is None:
            return None
        d = load_depth_png(os.path.join(
            self.depth_dir, self.depth_filenames[self.frame_index[ref_name]]))
        return self.preprocessor.apply_depth(d)

    def pose(self, name: str) -> np.ndarray:
        return self.poses[self.frame_index[name]]


def evaluate_scene(engine: InferenceEngine, scene_folder: str, index_file: str,
                   cfg: TestConfig, evaluate: bool = True, max_frames: Optional[int] = None,
                   cache_features: int = 384, assets: Optional[SceneAssets] = None):
    """One keyframe at a time. Measurement features stay on the device in a
    FIFO cache of at most ``cache_features`` frames (one entry is about 2.6
    MB at 320x256; a long scene can name thousands of measurement frames).
    The encoder is deterministic, so an evicted frame encodes to the same
    features and the cap does not change the results. ``assets``: a prebuilt
    SceneAssets, as in ``evaluate_scene_batched``."""
    lines = read_index(index_file)
    if assets is None:
        assets = SceneAssets(scene_folder, cfg, evaluate)
    predictions = []
    reference_depths = [] if assets.depth_filenames is not None else None
    feature_cache: Dict[str, torch.Tensor] = {}
    feature_order: List[str] = []
    timer = InferenceTimer()

    engine.reset()
    for line in lines:
        if max_frames is not None and len(predictions) >= max_frames:
            break
        if line == "TRACKING LOST":
            engine.reset()
            continue
        ref_name, *meas_names = line.split(" ")
        ref_image = assets.image(ref_name)
        if reference_depths is not None:
            reference_depths.append(assets.gt_depth(ref_name))

        timer.record_start_time()
        ref_feats = engine.encode(ref_image)
        meas_half = []
        for m in meas_names:
            hit = feature_cache.get(m)
            if hit is None:
                hit = engine.encode(assets.image(m))[0]
                if len(feature_order) >= cache_features:
                    feature_cache.pop(feature_order.pop(0), None)
                feature_cache[m] = hit
                feature_order.append(m)
            meas_half.append(hit)
        depth = engine.predict(ref_image, ref_feats, meas_half, assets.pose(ref_name),
                               [assets.pose(m) for m in meas_names], assets.updated_K)
        timer.record_end_time_and_elapsed_time()
        predictions.append(depth)
        if cfg.visualize:
            save_visualization(VIS_DIR, len(predictions) - 1, ref_image,
                               assets.image(meas_names[0]), depth, MEAN_RGB, STD_RGB, SCALE_RGB)

    timer.print_statistics()
    return predictions, reference_depths


def _scan_schedule(T: int, scan_chunk: int) -> List[int]:
    """Chunk lengths for T steps: full ``scan_chunk`` chunks plus a tail
    rounded up to the next power of two (at most ``scan_chunk``), the JAX
    package's schedule, so both pad a scene the same way."""
    full, rem = divmod(T, scan_chunk)
    sched = [scan_chunk] * full
    if rem:
        sched.append(min(1 << (rem - 1).bit_length(), scan_chunk))
    return sched


def _pad_to(items: list, n: int) -> list:
    """Pad by repeating the last item (well-formed work whose results are
    dropped)."""
    return items + [items[-1]] * (n - len(items))


def _encode_bank(engine: InferenceEngine, names: Sequence, load, batch: int, dtype):
    """Encode the frames ``load(name)`` of ``names`` in batches of ``batch``
    (the last padded) into a device-resident bank in the engine's storage
    (``InferenceEngine.bank_storage``): a tuple of (N, C, h, w) scales in
    ``dtype`` (rounded to nearest even for bfloat16) and the (N, 3, H, W)
    frames, where row i holds ``names[i]`` and the N - len(names) rows past
    them belong to no frame of this bank."""
    n, bank, images = len(names), None, None
    for s in range(0, n, batch):
        with span("dvmvs.bulk.frames"):
            imgs = engine.images(np.stack([load(x)
                                           for x in _pad_to(list(names[s:s + batch]), batch)]))
        feats = engine.encode_batch(imgs)
        if bank is None:
            bank, images = engine.bank_storage(n, dtype, feats, imgs)
        m = min(batch, n - s)
        for b, f in zip(bank, feats):
            b[s:s + m].copy_(f[:m])
        images[s:s + m].copy_(imgs[:m])
    return bank, images


def _views(names: Sequence[str], V: int):
    """The first V measurement names padded with copies of the first, and
    the validity mask."""
    names = list(names)[:V]
    mask = np.zeros((V,), np.float32)
    mask[:len(names)] = 1.0
    return names + [names[0]] * (V - len(names)), mask


def _upload_steps(engine: InferenceEngine, steps: Dict[str, np.ndarray]):
    """Host (T, B, ...) step arrays -> device tensors (indices int64)."""
    return {k: engine.upload_index(v) if k.endswith("_idx") else engine.upload(v)
            for k, v in steps.items()}


def _gather_rows(out: torch.Tensor, group) -> torch.Tensor:
    """(T, B/world, ...) step outputs of every rank -> (T, B, ...) in rank
    order, on every rank."""
    if group is None:
        return out
    parts = [torch.empty_like(out) for _ in range(mesh.world_size(group))]
    dist.all_gather(parts, out.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _check_dtype(bank_dtype: str):
    if bank_dtype not in BANK_DTYPES:
        raise ValueError(f"bank_dtype must be one of {sorted(BANK_DTYPES)}, got {bank_dtype!r}")
    return BANK_DTYPES[bank_dtype]


def evaluate_scene_batched(engine: InferenceEngine, scene_folder: str, index_file: str,
                           cfg: TestConfig, batch_size: int, evaluate: bool = True,
                           max_frames: Optional[int] = None,
                           assets: Optional[SceneAssets] = None, scan_chunk: int = 0,
                           bank_dtype: str = "bf16", group=None):
    """Throughput mode (pairnet): B independent keyframes a step. The
    scene's unique frames are encoded once into a device-resident feature
    bank (``bank_dtype`` bf16 halves its memory and is cast to float32
    where it is read); the frames stay on the device too, and each batch
    reads its rows with ``index_select``. The last batch is padded by
    repeating its last entry. ``scan_chunk`` batches run as one chunk (one
    graph replay on the card) with one readback each
    (``InferenceEngine.predict_pair_steps``).

    ``assets``: a prebuilt SceneAssets, so repeated runs over one scene skip
    the host decode and resize. With a data-parallel ``group`` every rank
    encodes the bank and runs its rows of each batch (``batch_size`` is the
    global batch); every rank gets all the predictions."""
    if engine.kind != "pairnet":
        raise ValueError("batched evaluation needs the stateless model (pairnet)")
    dtype = _check_dtype(bank_dtype)
    V, B = cfg.n_measurement_frames, batch_size
    with span("dvmvs.bulk.index"):
        entries = [line.split(" ") for line in read_index(index_file) if line != "TRACKING LOST"]
        if max_frames is not None:
            entries = entries[:max_frames]
        unique = list(dict.fromkeys(n for e in entries for n in e))
        bank_index = {n: i for i, n in enumerate(unique)}
    if not entries:
        return [], ([] if evaluate else None)
    if assets is None:
        assets = SceneAssets(scene_folder, cfg, evaluate)
    rank, world = mesh.rank(group), mesh.world_size(group)
    rows = slice(rank * B // world, (rank + 1) * B // world)
    K_b = engine.upload(np.tile(assets.updated_K[None], (B // world, 1, 1)))

    t0 = time.perf_counter()
    bank, images = _encode_bank(engine, unique, assets.image, B, dtype)
    with span("dvmvs.bulk.schedule"):
        schedule = _scan_schedule(-(-len(entries) // B), max(scan_chunk, 1))
        counters.add("bulk.slots", sum(schedule) * B)
        counters.add("bulk.pad_slots", sum(schedule) * B - len(entries))
        steps = {"ref_idx": [], "meas_idx": [], "view_mask": [], "ref_pose": [], "meas_pose": []}
        for e in _pad_to(entries, sum(schedule) * B):
            names, mask = _views(e[1:], V)
            steps["ref_idx"].append(bank_index[e[0]])
            steps["meas_idx"].append([bank_index[n] for n in names])
            steps["view_mask"].append(mask)
            steps["ref_pose"].append(assets.pose(e[0]))
            steps["meas_pose"].append([assets.pose(n) for n in names])
        xs = _upload_steps(engine, {k: np.asarray(v).reshape((-1, B) + np.shape(v)[1:])[:, rows]
                                    for k, v in steps.items()})
    predictions, c = [], 0
    for step in schedule:
        out = engine.predict_pair_steps(bank, images, K_b, {k: v[c:c + step] for k, v in xs.items()})
        out = _gather_rows(out, group)
        with span("dvmvs.bulk.readback"):
            predictions.extend(out.reshape((-1,) + tuple(out.shape[2:])).cpu().numpy())
        c += step
    predictions = predictions[:len(entries)]
    dt = time.perf_counter() - t0
    reference_depths = None
    if assets.depth_filenames is not None:
        reference_depths = [assets.gt_depth(e[0]) for e in entries]
    print(f"batched eval: {len(entries)} keyframes in {dt:.2f}s "
          f"({len(entries) / dt:.1f} images/s, batch {batch_size}, scan {scan_chunk}, "
          f"bank {bank_dtype})")
    return predictions, reference_depths


def _parse_steps(index_file: str, max_frames: Optional[int]):
    """(reset before this step, ref name, measurement names) per keyframe."""
    steps, pending_reset = [], False
    for line in read_index(index_file):
        if line == "TRACKING LOST":
            pending_reset = True
            continue
        ref, *meas = line.split(" ")
        steps.append((pending_reset, ref, meas))
        pending_reset = False
    return steps if max_frames is None else steps[:max_frames]


def evaluate_scenes_batched_fusion(engine: InferenceEngine, jobs, cfg: TestConfig,
                                   evaluate: bool = True, max_frames: Optional[int] = None,
                                   asset_cache: Optional[Dict[str, SceneAssets]] = None,
                                   scan_chunk: int = 0, bank_dtype: str = "bf16"):
    """Scene-parallel fusionnet: B independent scenes (``jobs``, a list of
    (scene_folder, index_file)) advance in lockstep, one batched recurrent
    step each. ``TRACKING LOST`` becomes a per-scene keep mask that zeroes
    that scene's state before its next step, as ``engine.reset()`` does in
    the sequential driver. Returns (predictions, ground truths) per job.

    Duplicate jobs (``main`` pads the last group by repeating its last
    index file) alias to one parsed scene: nothing is loaded or encoded
    twice. A scene without keyframes gives empty results, and its batch row
    replays a live scene so the lockstep stays well-formed; steps past a
    scene's end replay its last entry, and their outputs are dropped.
    ``asset_cache``: SceneAssets by absolute scene path, reused and filled.
    Frames and bank stay on the device; ``scan_chunk`` steps run as one
    chunk (one graph replay on the card) with one readback each
    (``InferenceEngine.fusion_steps``)."""
    if engine.kind != "fusionnet":
        raise ValueError("scene-batched evaluation needs the recurrent model (fusionnet)")
    dtype = _check_dtype(bank_dtype)
    B, V = len(jobs), cfg.n_measurement_frames

    uniq_key: Dict[tuple, int] = {}
    scene_of, uniq_jobs = [], []
    for scene_folder, index_file in jobs:
        key = (os.path.abspath(scene_folder), os.path.abspath(index_file))
        if key not in uniq_key:
            uniq_key[key] = len(uniq_jobs)
            uniq_jobs.append((scene_folder, index_file))
        scene_of.append(uniq_key[key])

    sdata = []
    for scene_folder, index_file in uniq_jobs:
        steps = _parse_steps(index_file, max_frames)
        unique = list(dict.fromkeys(n for (_, r, ms) in steps for n in [r] + list(ms)))
        akey = os.path.abspath(scene_folder)
        if asset_cache is not None and akey in asset_cache:
            scene_assets = asset_cache[akey]
        else:
            scene_assets = SceneAssets(scene_folder, cfg, evaluate)
            if asset_cache is not None:
                asset_cache[akey] = scene_assets
        sdata.append({"steps": steps, "unique": unique, "assets": scene_assets})

    live = [u for u in range(len(sdata)) if sdata[u]["steps"]]
    if not live:
        return [([], [] if evaluate else None) for _ in jobs]
    eff_of = [scene_of[si] if sdata[scene_of[si]]["steps"] else live[0] for si in range(B)]

    t0 = time.perf_counter()
    flat = [(uj, n) for uj in range(len(sdata)) for n in sdata[uj]["unique"]]
    bank_index = {key: gi for gi, key in enumerate(flat)}
    bank, images = _encode_bank(engine, flat, lambda key: sdata[key[0]]["assets"].image(key[1]),
                                B, dtype)
    K_b = engine.upload(np.stack([sdata[eff_of[si]]["assets"].updated_K for si in range(B)]))
    max_steps = max(len(sdata[u]["steps"]) for u in live)
    schedule = _scan_schedule(max_steps, max(scan_chunk, 1))

    def step_inputs(t):
        """Host inputs of lockstep step t for every batch row."""
        x = {"ref_idx": [], "meas_idx": [], "view_mask": [], "ref_pose": [], "meas_pose": [],
             "keep": np.ones((B,), np.float32)}
        for si in range(B):
            u = eff_of[si]
            s, a = sdata[u]["steps"], sdata[u]["assets"]
            reset, ref, ms = s[min(t, len(s) - 1)]
            if t < len(s) and reset:
                x["keep"][si] = 0.0
            names, mask = _views(ms, V)
            x["ref_idx"].append(bank_index[(u, ref)])
            x["meas_idx"].append([bank_index[(u, n)] for n in names])
            x["view_mask"].append(mask)
            x["ref_pose"].append(a.pose(ref))
            x["meas_pose"].append([a.pose(n) for n in names])
        return x

    results = [([], [] if sdata[scene_of[si]]["assets"].depth_filenames is not None else None)
               for si in range(B)]
    n_predicted = 0

    def collect(t, depth):
        nonlocal n_predicted
        for si in range(B):
            own = sdata[scene_of[si]]
            if t >= len(own["steps"]):
                continue
            results[si][0].append(depth[si])
            n_predicted += 1
            if results[si][1] is not None:
                results[si][1].append(own["assets"].gt_depth(own["steps"][t][1]))

    state = engine.init_batch_state(B)
    with span("dvmvs.bulk.schedule"):
        per_step = [step_inputs(t) for t in range(sum(schedule))]
        xs = _upload_steps(engine, {k: np.asarray([x[k] for x in per_step]) for k in per_step[0]})
    c = 0
    for step in schedule:
        state, out = engine.fusion_steps(bank, images, K_b, state,
                                         {k: v[c:c + step] for k, v in xs.items()})
        with span("dvmvs.bulk.readback"):
            for dt_i, depth in enumerate(out.cpu().numpy()):
                collect(c + dt_i, depth)
        c += step
    counters.add("bulk.slots", sum(schedule) * B)
    counters.add("bulk.pad_slots", sum(schedule) * B - n_predicted)

    dt = time.perf_counter() - t0
    print(f"scene-batched eval: {n_predicted} keyframes over {B} scenes in {dt:.2f}s "
          f"({n_predicted / dt:.1f} images/s, scan {scan_chunk}, bank {bank_dtype})")
    return results


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=["pairnet", "fusionnet"], default="fusionnet")
    ap.add_argument("--data", required=True, help="folder with indices/ and <dataset>/<scene>/")
    ap.add_argument("--dataset-name", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="a checkpoint of the port (torch.save) or of the JAX package "
                         "(Flax msgpack; utils/checkpoint.py)")
    ap.add_argument("--output", default="results")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n-measurement-frames", type=int, default=2)
    ap.add_argument("--no-evaluate", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="pairnet throughput mode: B independent keyframes a step")
    ap.add_argument("--scene-batch", type=int, default=None,
                    help="fusionnet throughput mode: this many scenes in lockstep")
    ap.add_argument("--scan-chunk", type=int, default=0,
                    help="with --batch-size/--scene-batch: steps run as one chunk (one CUDA "
                         "graph replay on the card) between readbacks (0 or 1: every step)")
    ap.add_argument("--bank-dtype", choices=sorted(BANK_DTYPES), default="bf16",
                    help="storage dtype of the device feature bank of the batched modes "
                         "(bf16 halves its memory; read back as float32)")
    ap.add_argument("--width", type=int, default=None,
                    help="test image width (default: config default)")
    ap.add_argument("--height", type=int, default=None,
                    help="test image height (default: config default)")
    ap.add_argument("--visualize", action="store_true",
                    help=f"sequential mode: write PNG panels of every keyframe under {VIS_DIR}/")
    ap.add_argument("--n-devices", type=int, default=None,
                    help="with --batch-size/--scene-batch: shard each batch over this many "
                         "devices, one process each (torchrun)")
    args = ap.parse_args(argv)

    size_kw = {}
    for flag, key in ((args.width, "image_width"), (args.height, "image_height")):
        if flag is not None:
            if flag % 32:
                raise SystemExit(f"--{key.split('_')[1]} must be a multiple "
                                 "of 32 (1/32 bottleneck grid)")
            size_kw[key] = flag
    if args.batch_size is not None and args.model != "pairnet":
        raise SystemExit("--batch-size requires --model pairnet (fusionnet is recurrent "
                         "within a scene; use --scene-batch)")
    if args.scene_batch is not None and args.model != "fusionnet":
        raise SystemExit("--scene-batch applies to --model fusionnet")
    cfg = TestConfig(n_measurement_frames=args.n_measurement_frames,
                     visualize=args.visualize, **size_kw)
    if args.n_devices is None:
        return _evaluate(args, cfg, args.device, None)
    batch = args.batch_size or args.scene_batch
    if batch is None:
        raise SystemExit("--n-devices shards --batch-size (pairnet) or --scene-batch "
                         "(fusionnet)")
    if args.scan_chunk and args.n_devices > 1:
        raise SystemExit("--scan-chunk is single-device (use per-step dispatch with "
                         "--n-devices)")
    if batch % args.n_devices:
        raise SystemExit("batch must divide by --n-devices")
    group, device = mesh.init_data_parallel(args.n_devices, device=args.device)
    try:
        return _evaluate(args, cfg, device, group)
    finally:
        mesh.destroy()


def _evaluate(args, cfg: TestConfig, device, group):
    lead = mesh.rank(group) == 0
    before = counters.snapshot()
    engine = InferenceEngine(args.model, cfg, device=device)
    if args.checkpoint:
        load_checkpoint(args.checkpoint, engine.model)

    indices_dir = os.path.join(args.data, "indices")
    index_files = sorted(
        os.path.join(indices_dir, f) for f in os.listdir(indices_dir)
        if (args.dataset_name is None or args.dataset_name in f)
        and f.endswith(f"nmeas+{args.n_measurement_frames}"))
    if lead:
        print(f"{len(index_files)} index files ({args.model} on {device}; {describe()})",
              flush=True)

    def parse_job(index_file):
        keyframing_type, dataset_name, scene_name, _, _ = \
            os.path.basename(index_file).split("+")
        system_name = (f"{keyframing_type}_{dataset_name}_{cfg.image_width}"
                       f"_{cfg.image_height}_{args.n_measurement_frames}"
                       f"_dvmvs_tpu_torch_{args.model}")
        return os.path.join(args.data, dataset_name, scene_name), scene_name, system_name

    evaluate = not args.no_evaluate
    if args.scene_batch is not None:
        SB = args.scene_batch
        rank, world = mesh.rank(group), mesh.world_size(group)
        for s in range(0, len(index_files), SB):
            files = index_files[s:s + SB]
            n_real = len(files)
            files = _pad_to(files, SB)
            if lead:
                print(f"Predicting scenes {s}..{s + n_real - 1} of {len(index_files)} "
                      f"(lockstep batch {SB})")
            mine = files[rank * SB // world:(rank + 1) * SB // world]
            results = evaluate_scenes_batched_fusion(
                engine, [(parse_job(f)[0], f) for f in mine], cfg, evaluate=evaluate,
                max_frames=args.max_frames, scan_chunk=args.scan_chunk,
                bank_dtype=args.bank_dtype)
            if group is not None:  # every rank's scenes, in rank order
                parts = [None] * world
                dist.all_gather_object(parts, results, group=group)
                results = [r for part in parts for r in part]
            if lead:
                for f, (predictions, gts) in list(zip(files, results))[:n_real]:
                    _, scene_name, system_name = parse_job(f)
                    save_results(predictions, gts, system_name, scene_name, args.output)
    else:
        for i, index_file in enumerate(index_files):
            scene_folder, scene_name, system_name = parse_job(index_file)
            if lead:
                print(f"Predicting for scene {scene_name} - {i}/{len(index_files)}")
            if args.batch_size is not None:
                predictions, gts = evaluate_scene_batched(
                    engine, scene_folder, index_file, cfg, args.batch_size, evaluate=evaluate,
                    max_frames=args.max_frames, scan_chunk=args.scan_chunk,
                    bank_dtype=args.bank_dtype, group=group)
            else:
                predictions, gts = evaluate_scene(engine, scene_folder, index_file, cfg,
                                                  evaluate=evaluate, max_frames=args.max_frames)
            if lead:
                save_results(predictions, gts, system_name, scene_name, args.output)
    if lead:
        print(describe_counts(counters.since(before)), flush=True)


if __name__ == "__main__":
    main()
