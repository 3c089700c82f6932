"""Online single-scene depth prediction (counterpart of
dvmvs_tpu/apps/run_testing_online.py).

Every frame goes through the keyframe buffer; accepted keyframes are
predicted. The buffer stores each keyframe's pose beside its cached
half-resolution features on the device, so the backbone runs once per
keyframe.

  - ``predict_stream`` takes preprocessed frames from memory.
  - ``predict_scene`` and ``main`` read a scene directory (``images/*.png``,
    ``depth/*.png``, ``poses.txt``, ``K.txt``) with the port's own PNG
    reader (``data/io.py``, no OpenCV). Frames stored at the test size need
    no resize; any other size needs cv2 (``data/preprocess.py``).

Run: ``python -m dvmvs_tpu_torch.apps.run_testing_online --scene DIR``.
"""

from __future__ import annotations

import argparse
import itertools
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from dvmvs_tpu_torch.apps.engine import InferenceEngine
from dvmvs_tpu_torch.config import MEAN_RGB, SCALE_RGB, STD_RGB, TestConfig
from dvmvs_tpu_torch.data.io import load_depth_png, load_image, load_scene
from dvmvs_tpu_torch.data.preprocess import PreprocessImage
from dvmvs_tpu_torch.utils.keyframe_buffer import KeyframeBuffer
from dvmvs_tpu_torch.utils.results import InferenceTimer, save_results


def normalize_rgb(image: np.ndarray) -> np.ndarray:
    """RGB (H, W, 3) in 0..255 -> the network's ImageNet-normalised float32."""
    out = image.astype(np.float32) / SCALE_RGB
    return ((out - np.asarray(MEAN_RGB, np.float32)) / np.asarray(STD_RGB, np.float32)
            ).astype(np.float32)


def predict_stream(engine: InferenceEngine, frames: Iterable[np.ndarray],
                   poses: Sequence[np.ndarray], K: np.ndarray, cfg: TestConfig,
                   max_frames: Optional[int] = None,
                   timer: Optional[InferenceTimer] = None) -> Tuple[List[np.ndarray], List[int]]:
    """Stream preprocessed frames (H, W, 3) with camera-to-world poses and
    intrinsics K (at the frame size) through the keyframe buffer.

    Returns (depth per predicted keyframe, index of each predicted frame).
    Stops after ``max_frames`` predictions when given; ``timer`` times each
    ``encode_and_predict``.
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
        response = buf.try_new_keyframe(pose, None)
        if response == 0:
            buf.buffer[-1] = (pose, engine.encode(image)[0])
            continue
        if response in (2, 4, 5):
            continue
        if response == 3:  # tracking lost: the buffer was cleared
            engine.reset()
            continue

        measurement_frames = buf.get_best_measurement_frames(cfg.n_measurement_frames)
        if timer is not None:
            timer.record_start_time()
        depth, f_half = engine.encode_and_predict(
            image, [e[1] for e in measurement_frames], pose,
            [e[0] for e in measurement_frames], K)
        if timer is not None:
            timer.record_end_time_and_elapsed_time()
        buf.buffer[-1] = (pose, f_half)
        predictions.append(depth)
        indices.append(i)
    return predictions, indices


def predict_scene(engine: InferenceEngine, scene_path: str, cfg: TestConfig,
                  evaluate: bool = True, max_frames: Optional[int] = None):
    """Predict every keyframe of a scene directory. Returns (predictions,
    ground-truth depths of the predicted frames, or None)."""
    scene = load_scene(scene_path)
    raw = (load_image(f) for f in scene.image_filenames[: len(scene.poses)])
    first = next(raw)
    preprocessor = PreprocessImage(
        K=scene.K, old_width=first.shape[1], old_height=first.shape[0],
        new_width=cfg.image_width, new_height=cfg.image_height,
        distortion_crop=cfg.distortion_crop, perform_crop=cfg.perform_crop)
    frames = (preprocessor.apply_rgb(image, SCALE_RGB, MEAN_RGB, STD_RGB)
              for image in itertools.chain([first], raw))
    K = preprocessor.get_updated_intrinsics().astype(np.float32)

    timer = InferenceTimer()
    predictions, indices = predict_stream(engine, frames, scene.poses, K, cfg,
                                          max_frames=max_frames, timer=timer)
    timer.print_statistics()
    reference_depths = None
    if evaluate and scene.depth_filenames:
        reference_depths = [
            preprocessor.apply_depth(load_depth_png(scene.depth_filenames[i]))
            for i in indices]
    return predictions, reference_depths


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", choices=["pairnet", "fusionnet"], default="fusionnet")
    ap.add_argument("--scene", required=True)
    ap.add_argument("--output", default="results")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-measurement-frames", type=int, default=2)
    ap.add_argument("--no-evaluate", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--width", type=int, default=None,
                    help="test image width (default: config default)")
    ap.add_argument("--height", type=int, default=None,
                    help="test image height (default: config default)")
    args = ap.parse_args()

    size_kw = {}
    for flag, key in ((args.width, "image_width"), (args.height, "image_height")):
        if flag is not None:
            if flag % 32:
                raise SystemExit(f"--{key.split('_')[1]} must be a multiple "
                                 "of 32 (1/32 bottleneck grid)")
            size_kw[key] = flag
    cfg = TestConfig(n_measurement_frames=args.n_measurement_frames, **size_kw)
    engine = InferenceEngine(args.model, cfg, device=args.device)

    dataset_name = os.path.basename(os.path.dirname(os.path.normpath(args.scene)))
    scene_name = os.path.basename(os.path.normpath(args.scene))
    system_name = (
        f"keyframe_{dataset_name}_{cfg.image_width}_{cfg.image_height}"
        f"_{args.n_measurement_frames}_dvmvs_tpu_torch_{args.model}_online")
    print("Predicting with System:", system_name)
    predictions, gts = predict_scene(engine, args.scene, cfg,
                                     evaluate=not args.no_evaluate,
                                     max_frames=args.max_frames)
    save_results(predictions, gts, system_name, scene_name, args.output)


if __name__ == "__main__":
    main()
