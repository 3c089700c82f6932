"""Online single-scene depth prediction (counterpart of
dvmvs_tpu/apps/run_testing_online.py).

Every frame goes through the keyframe buffer; accepted keyframes are
predicted. The buffer stores each keyframe's pose beside its cached
half-resolution features on the device, so the backbone runs once per
keyframe.

  - ``predict_stream`` takes frames from memory: preprocessed, or raw with
    a ``preprocess`` callable that it applies to accepted frames only.
  - ``predict_scene`` and ``main`` read a scene directory (``images/*.png``,
    ``depth/*.png``, ``poses.txt``, ``K.txt``) with the port's own PNG
    reader (``data/io.py``) and resize (``data/preprocess.py``), without
    OpenCV, whatever size the frames are stored at.
    A worker thread decodes the frames ahead of the loop
    (``_FramePrefetcher``), so file reads and PNG decodes overlap the device.
  - ``LiveTSDF`` (``--live-tsdf MESH.ply``) fuses every predicted depth into
    a TSDF volume on the device inside the loop (``ops/tsdf.py``) and
    writes the coloured mesh at the end.
  - ``--visualize`` writes each keyframe's reference and measurement frames
    and its depth, raw and coloured, as PNG panels under
    ``visualizations/`` (``utils/visualization.py``); the JAX package's live
    OpenCV windows are not ported.

Run: ``python -m dvmvs_tpu_torch.apps.run_testing_online --scene DIR
[--live-tsdf out.ply] [--checkpoint model.pt|model.msgpack] [--visualize]``
(on the card; ``--device cpu`` asks for the CPU).
"""

from __future__ import annotations

import argparse
import itertools
import os
import queue
import threading
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from dvmvs_tpu_torch.apps.engine import InferenceEngine
from dvmvs_tpu_torch.config import MEAN_RGB, SCALE_RGB, STD_RGB, TestConfig
from dvmvs_tpu_torch.data.io import load_depth_png, load_image, load_scene
from dvmvs_tpu_torch.data.preprocess import PreprocessImage
from dvmvs_tpu_torch.ops.tsdf import TSDFVolume
from dvmvs_tpu_torch.utils.checkpoint import load_checkpoint
from dvmvs_tpu_torch.utils.keyframe_buffer import KeyframeBuffer
from dvmvs_tpu_torch.utils.native import write_mesh_ply
from dvmvs_tpu_torch.utils.precision import describe
from dvmvs_tpu_torch.utils.profiling import counters, describe_counts, span
from dvmvs_tpu_torch.utils.results import InferenceTimer, save_results
from dvmvs_tpu_torch.utils.visualization import VIS_DIR, save_visualization


class LiveTSDF:
    """Streaming TSDF fusion of the predicted depths during online inference.

    A live system cannot see the trajectory in advance, so unless explicit
    ``bounds`` ((3, 2) min/max per axis) are given the volume is allocated
    at the first fused keyframe as a cube of half-extent ``max_depth + 2 *
    voxel_size`` around that camera position. Frames that wander outside
    stop contributing (voxels outside the volume are never touched). Depths
    beyond ``max_depth`` are dropped. Runs on the card unless ``device="cpu"``.
    """

    def __init__(self, voxel_size: float = 0.05, max_depth: float = 3.0, bounds=None,
                 device="cuda"):
        self.voxel_size = float(voxel_size)
        self.max_depth = float(max_depth)
        self._bounds = None if bounds is None else np.asarray(bounds, float)
        self.device = device
        self.volume = None
        self.n_integrated = 0

    def integrate(self, color_im: np.ndarray, depth: np.ndarray, K: np.ndarray,
                  pose: np.ndarray):
        """``color_im`` (H, W, 3) 0..255 must be aligned with ``depth`` and
        ``K`` (the same crop and resize: the driver reuses its
        PreprocessImage)."""
        if self.volume is None:
            if self._bounds is None:
                c = pose[:3, 3]
                r = self.max_depth + 2 * self.voxel_size
                self._bounds = np.stack([c - r, c + r], axis=1)
            self.volume = TSDFVolume(self._bounds, voxel_size=self.voxel_size,
                                     device=self.device)
        d = depth.copy()
        d[d > self.max_depth] = 0.0
        self.volume.integrate(np.clip(color_im, 0, 255).astype(np.uint8), d, K, pose)
        self.n_integrated += 1

    def save_mesh(self, path: str):
        if self.volume is None:
            print("live-tsdf: no frames integrated, no mesh written")
            return
        verts, faces, norms, colors = self.volume.get_mesh()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        write_mesh_ply(path, verts, faces, norms, colors)
        print(f"live-tsdf: {self.n_integrated} keyframes fused -> {len(verts)} vertices / "
              f"{len(faces)} faces -> {path}")


class _FramePrefetcher:
    """Iterator over ``load(f)`` for ``filenames``, decoded ahead on a worker
    thread at most ``depth`` frames ahead, so host image reads overlap the
    device (the reference loads each frame in the loop,
    run-testing-online.py:104). An exception in the worker is raised to the
    consumer at the frame it failed on, and the worker then ends; ``close``
    stops a worker whose frames are no longer wanted."""

    _END = object()

    def __init__(self, filenames: Sequence[str], load: Callable[[str], np.ndarray],
                 depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(list(filenames), load),
                                        name="frame-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, filenames, load):
        try:
            for f in filenames:
                if not self._put(load(f)):
                    return
        except Exception as error:  # handed to the consumer, which raises it
            self._put(error)
            return
        self._put(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            self._thread.join()
            raise StopIteration
        if isinstance(item, Exception):
            self._thread.join()
            raise item
        return item

    def close(self):
        self._stop.set()
        self._thread.join()


def normalize_rgb(image: np.ndarray) -> np.ndarray:
    """RGB (H, W, 3) in 0..255 -> the network's ImageNet-normalised float32."""
    out = image.astype(np.float32) / SCALE_RGB
    return ((out - np.asarray(MEAN_RGB, np.float32)) / np.asarray(STD_RGB, np.float32)
            ).astype(np.float32)


def predict_stream(engine: InferenceEngine, frames: Iterable[np.ndarray],
                   poses: Sequence[np.ndarray], K: np.ndarray, cfg: TestConfig,
                   max_frames: Optional[int] = None,
                   timer: Optional[InferenceTimer] = None,
                   on_prediction: Optional[Callable[[int, np.ndarray], None]] = None,
                   preprocess: Optional[Callable[[np.ndarray], np.ndarray]] = None
                   ) -> Tuple[List[np.ndarray], List[int]]:
    """Stream frames (H, W, 3) with camera-to-world poses and intrinsics K
    (at the network's frame size) through the keyframe buffer.

    The frames are preprocessed, or raw when ``preprocess`` is given: it is
    then called on a frame only once the buffer has accepted it (responses
    0 and 1), as the JAX driver calls ``apply_rgb``. Returns (depth per
    predicted keyframe, index of each predicted frame). Stops after
    ``max_frames`` predictions when given; ``timer`` times each
    ``encode_and_predict``; ``on_prediction(frame index, depth)`` is called
    after each prediction. With ``cfg.visualize`` each prediction's panels
    (reference, best measurement frame, depth) are written under
    ``VIS_DIR``, numbered from 0, as the JAX driver writes them headless.
    The keyframe buffer's work on a frame (the test, and for a keyframe the
    choice of measurement frames) is the span ``dvmvs.stream.buffer``.
    """
    buf = KeyframeBuffer(
        buffer_size=cfg.keyframe_buffer_size,
        keyframe_pose_distance=cfg.keyframe_pose_distance,
        optimal_t_score=cfg.optimal_t_measure,
        optimal_R_score=cfg.optimal_R_measure,
    )
    predictions, indices = [], []
    engine.reset()
    for i, (image, pose) in enumerate(zip(frames, poses)):
        if max_frames is not None and len(predictions) >= max_frames:
            break
        # keyframe entry: (pose, cached half-res features on the device)
        with span("dvmvs.stream.buffer"):
            response = buf.try_new_keyframe(pose, None)
            if response == 1:
                measurement_frames = buf.get_best_measurement_frames(cfg.n_measurement_frames)
        if response in (2, 4, 5):
            continue
        if response == 3:  # tracking lost: the buffer was cleared
            engine.reset()
            continue
        if preprocess is not None:
            image = preprocess(image)
        kept = image if cfg.visualize else None
        if response == 0:
            buf.buffer[-1] = (pose, engine.encode(image)[0], kept)
            continue

        if timer is not None:
            timer.record_start_time()
        depth, f_half = engine.encode_and_predict(
            image, [e[1] for e in measurement_frames], pose,
            [e[0] for e in measurement_frames], K)
        if timer is not None:
            timer.record_end_time_and_elapsed_time()
        buf.buffer[-1] = (pose, f_half, kept)
        predictions.append(depth)
        indices.append(i)
        if on_prediction is not None:
            on_prediction(i, depth)
        if cfg.visualize:
            save_visualization(VIS_DIR, len(predictions) - 1, image, measurement_frames[0][2],
                               depth, MEAN_RGB, STD_RGB, SCALE_RGB)
    return predictions, indices


def predict_scene(engine: InferenceEngine, scene_path: str, cfg: TestConfig,
                  evaluate: bool = True, max_frames: Optional[int] = None,
                  live_tsdf: Optional[LiveTSDF] = None):
    """Predict every keyframe of a scene directory, fusing each depth into
    ``live_tsdf`` when given. Returns (predictions, ground-truth depths of
    the predicted frames, or None). Prints the timer's statistics and the
    counters (``utils/profiling.py``) that moved over the scene."""
    before = counters.snapshot()
    scene = load_scene(scene_path)
    raw = _FramePrefetcher(scene.image_filenames[: len(scene.poses)], load_image)
    try:
        first = next(raw)
        preprocessor = PreprocessImage(
            K=scene.K, old_width=first.shape[1], old_height=first.shape[0],
            new_width=cfg.image_width, new_height=cfg.image_height,
            distortion_crop=cfg.distortion_crop, perform_crop=cfg.perform_crop)
        current = {}  # the raw frame being streamed, for the TSDF colours

        def frames():
            for image in itertools.chain([first], raw):
                current["raw"] = image
                yield image

        K = preprocessor.get_updated_intrinsics().astype(np.float32)

        def fuse(i, depth):
            color = preprocessor.apply_rgb(current["raw"], 1.0, [0.0] * 3, [1.0] * 3,
                                           normalize_colors=False)
            live_tsdf.integrate(color, depth, K, scene.poses[i])

        timer = InferenceTimer()
        predictions, indices = predict_stream(
            engine, frames(), scene.poses, K, cfg, max_frames=max_frames, timer=timer,
            on_prediction=fuse if live_tsdf is not None else None,
            preprocess=lambda image: preprocessor.apply_rgb(image, SCALE_RGB, MEAN_RGB, STD_RGB))
    finally:
        raw.close()
    timer.print_statistics()
    print(describe_counts(counters.since(before)))
    reference_depths = None
    if evaluate and scene.depth_filenames:
        reference_depths = [
            preprocessor.apply_depth(load_depth_png(scene.depth_filenames[i]))
            for i in indices]
    return predictions, reference_depths


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=["pairnet", "fusionnet"], default="fusionnet")
    ap.add_argument("--scene", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="a checkpoint of the port (torch.save) or of the JAX package "
                         "(Flax msgpack; utils/checkpoint.py)")
    ap.add_argument("--output", default="results")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n-measurement-frames", type=int, default=2)
    ap.add_argument("--no-evaluate", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--width", type=int, default=None,
                    help="test image width (default: config default)")
    ap.add_argument("--height", type=int, default=None,
                    help="test image height (default: config default)")
    ap.add_argument("--visualize", action="store_true",
                    help=f"write PNG panels of every keyframe under {VIS_DIR}/")
    ap.add_argument("--live-tsdf", default=None, metavar="MESH.ply",
                    help="fuse the predicted depths into a TSDF volume on the device inside "
                         "the loop; write the coloured mesh here at the end")
    ap.add_argument("--tsdf-voxel-size", type=float, default=0.05)
    ap.add_argument("--tsdf-max-depth", type=float, default=3.0)
    ap.add_argument("--tsdf-bounds", type=float, nargs=6, default=None,
                    metavar=("X0", "X1", "Y0", "Y1", "Z0", "Z1"),
                    help="explicit volume bounds (default: a cube of half-extent max-depth "
                         "around the first keyframe)")
    args = ap.parse_args(argv)

    size_kw = {}
    for flag, key in ((args.width, "image_width"), (args.height, "image_height")):
        if flag is not None:
            if flag % 32:
                raise SystemExit(f"--{key.split('_')[1]} must be a multiple "
                                 "of 32 (1/32 bottleneck grid)")
            size_kw[key] = flag
    cfg = TestConfig(n_measurement_frames=args.n_measurement_frames,
                     visualize=args.visualize, **size_kw)
    engine = InferenceEngine(args.model, cfg, device=args.device)
    if args.checkpoint:
        load_checkpoint(args.checkpoint, engine.model)
    live_tsdf = None
    if args.live_tsdf:
        bounds = (None if args.tsdf_bounds is None
                  else np.asarray(args.tsdf_bounds, float).reshape(3, 2))
        live_tsdf = LiveTSDF(voxel_size=args.tsdf_voxel_size, max_depth=args.tsdf_max_depth,
                             bounds=bounds, device=args.device)

    dataset_name = os.path.basename(os.path.dirname(os.path.normpath(args.scene)))
    scene_name = os.path.basename(os.path.normpath(args.scene))
    system_name = (
        f"keyframe_{dataset_name}_{cfg.image_width}_{cfg.image_height}"
        f"_{args.n_measurement_frames}_dvmvs_tpu_torch_{args.model}_online")
    print(f"Predicting with System: {system_name} (device {engine.device}; {describe()})",
          flush=True)
    predictions, gts = predict_scene(engine, args.scene, cfg,
                                     evaluate=not args.no_evaluate,
                                     max_frames=args.max_frames, live_tsdf=live_tsdf)
    save_results(predictions, gts, system_name, scene_name, args.output)
    if live_tsdf is not None:
        live_tsdf.save_mesh(args.live_tsdf)


if __name__ == "__main__":
    main()
