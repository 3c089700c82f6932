"""Bulk evaluation of the baseline depth estimators over keyframe index files
(counterpart of dvmvs_tpu/apps/run_testing_baseline.py; reference:
dvmvs/baselines/*/run-testing.py, one shared loop instead of four clones).

Per index line the reference and measurement frames are read, preprocessed
for the estimator (its size and normalisation, no crop), and predicted;
``TRACKING LOST`` resets the estimator. The frames come from an assets
object (``BaselineAssets``, the scene folder's PNGs, by default; or frames
held in memory); under ``torch.profiler`` each line's frames are the span
``dvmvs.baseline.frames``, beside the estimators' own spans
(``baselines/steps.py``). Predictions and the 8 error metrics
are saved as npz under the JAX package's system name.

Run on the card (the default; ``--device cpu`` asks for the CPU):
``python -m dvmvs_tpu_torch.apps.run_testing_baseline --baseline
{mvdepthnet,gpmvs,dpsnet,deltas} --data DIR [--checkpoint model.pt]``.
``--checkpoint`` reads the port's own state dict of the baseline's model
(``torch.save(estimator.model.state_dict(), path)``) or the JAX package's
Flax variables of it (msgpack, as its ``run_testing_baseline`` reads them),
mapped by ``utils/baseline_weights.py``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

import dvmvs_tpu_torch.baselines.deltas  # noqa: F401  (registry population)
import dvmvs_tpu_torch.baselines.dpsnet  # noqa: F401
import dvmvs_tpu_torch.baselines.gpmvs  # noqa: F401
import dvmvs_tpu_torch.baselines.mvdepthnet  # noqa: F401
from dvmvs_tpu_torch.baselines.registry import BASELINE_REGISTRY
from dvmvs_tpu_torch.data.io import load_depth_png, load_image
from dvmvs_tpu_torch.data.preprocess import PreprocessImage
from dvmvs_tpu_torch.utils.baseline_weights import BASELINE_STATE_DICTS
from dvmvs_tpu_torch.utils.checkpoint import is_jax_checkpoint, read_jax_variables
from dvmvs_tpu_torch.utils.precision import describe
from dvmvs_tpu_torch.utils.profiling import span
from dvmvs_tpu_torch.utils.results import InferenceTimer, save_results


class BaselineAssets:
    """A scene folder's frames as an estimator takes them: ``image(name)``
    decodes the PNG and preprocesses it to the estimator's size and
    normalisation (no crop), on every call; ``pose(name)``, ``updated_K``,
    ``depth_filenames`` (None without ``evaluate`` or a depth folder) and
    ``gt_depth(name)`` at the estimator's size, as
    ``apps/run_testing.py::SceneAssets`` gives them to the engine."""

    def __init__(self, estimator, scene_folder: str, evaluate: bool = True):
        K = np.loadtxt(os.path.join(scene_folder, "K.txt")).astype(np.float32)
        self.poses = np.fromfile(os.path.join(scene_folder, "poses.txt"), dtype=float,
                                 sep="\n ").reshape(-1, 4, 4)
        self.images_dir = os.path.join(scene_folder, "images")
        image_filenames = sorted(f for f in os.listdir(self.images_dir) if f.endswith(".png"))
        self.frame_index = {f: i for i, f in enumerate(image_filenames)}
        self.depth_dir = os.path.join(scene_folder, "depth")
        self.depth_filenames = (
            sorted(f for f in os.listdir(self.depth_dir) if f.endswith(".png"))
            if evaluate and os.path.isdir(self.depth_dir) else None)
        first = load_image(os.path.join(self.images_dir, image_filenames[0]))
        self.preprocessor = PreprocessImage(
            K=K, old_width=first.shape[1], old_height=first.shape[0],
            new_width=estimator.image_width, new_height=estimator.image_height,
            distortion_crop=0, perform_crop=False)
        self.updated_K = self.preprocessor.get_updated_intrinsics().astype(np.float32)
        self.normalisation = (estimator.scale_rgb, list(estimator.mean_rgb),
                              list(estimator.std_rgb))

    def image(self, name: str) -> np.ndarray:
        return self.preprocessor.apply_rgb(load_image(os.path.join(self.images_dir, name)),
                                           *self.normalisation)

    def pose(self, name: str) -> np.ndarray:
        return self.poses[self.frame_index[name]]

    def gt_depth(self, name: str) -> np.ndarray:
        d = load_depth_png(os.path.join(self.depth_dir,
                                        self.depth_filenames[self.frame_index[name]]))
        return self.preprocessor.apply_depth(d)


def evaluate_scene_baseline(estimator, scene_folder: str, index_file: str,
                            evaluate: bool = True, max_frames: Optional[int] = None,
                            timer: Optional[InferenceTimer] = None, assets=None):
    """Predict every keyframe line of ``index_file`` with ``estimator``.
    Returns (predictions, ground-truth depths at the estimator's size, or
    None). ``timer`` (default a fresh one) times each ``predict``.
    ``assets``: the scene's frames already at the estimator's size and
    normalisation (``image``, ``pose``, ``updated_K``, ``depth_filenames``
    and, where that is not None, ``gt_depth``), so that nothing is read
    from disk; by default ``BaselineAssets`` of ``scene_folder``."""
    with open(index_file) as f:
        lines = [line for line in f.read().splitlines() if line]
    if assets is None:
        assets = BaselineAssets(estimator, scene_folder, evaluate)

    predictions = []
    reference_depths = [] if assets.depth_filenames is not None else None
    timer = InferenceTimer() if timer is None else timer
    estimator.reset()

    for line in lines:
        if max_frames is not None and len(predictions) >= max_frames:
            break
        if line == "TRACKING LOST":
            estimator.reset()
            continue
        ref_name, *meas_names = line.split(" ")
        with span("dvmvs.baseline.frames"):
            ref_image = assets.image(ref_name)
            if reference_depths is not None:
                reference_depths.append(assets.gt_depth(ref_name))
            meas_images = [assets.image(m) for m in meas_names]
            meas_poses = [assets.pose(m) for m in meas_names]

        timer.record_start_time()
        depth = estimator.predict(ref_image, meas_images, assets.pose(ref_name), meas_poses,
                                  assets.updated_K)
        timer.record_end_time_and_elapsed_time()
        predictions.append(depth)

    timer.print_statistics()
    return predictions, reference_depths


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--baseline", choices=["mvdepthnet", "gpmvs", "dpsnet", "deltas"],
                    required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--dataset-name", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="the port's state dict of the baseline's model (torch.save) or the "
                         "JAX package's Flax variables of it (msgpack)")
    ap.add_argument("--output", default="results")
    ap.add_argument("--n-measurement-frames", type=int, default=2)
    ap.add_argument("--no-evaluate", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    state_dict = None
    if args.checkpoint and is_jax_checkpoint(args.checkpoint):
        state_dict = BASELINE_STATE_DICTS[args.baseline](read_jax_variables(args.checkpoint))
    elif args.checkpoint:
        state_dict = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    estimator = BASELINE_REGISTRY[args.baseline](
        n_measurement_frames=args.n_measurement_frames, state_dict=state_dict,
        device=args.device)

    indices_dir = os.path.join(args.data, "indices")
    index_files = sorted(
        os.path.join(indices_dir, f) for f in os.listdir(indices_dir)
        if (args.dataset_name is None or args.dataset_name in f)
        and f.endswith(f"nmeas+{args.n_measurement_frames}"))
    print(f"{len(index_files)} index files ({args.baseline} on {estimator.device}; "
          f"{describe()})", flush=True)
    for i, index_file in enumerate(index_files):
        keyframing_type, dataset_name, scene_name, _, _ = os.path.basename(index_file).split("+")
        scene_folder = os.path.join(args.data, dataset_name, scene_name)
        print(f"Predicting {dataset_name}-{scene_name} with {args.baseline} - "
              f"{i}/{len(index_files)}")
        predictions, gts = evaluate_scene_baseline(
            estimator, scene_folder, index_file,
            evaluate=not args.no_evaluate, max_frames=args.max_frames)
        system_name = (
            f"{keyframing_type}_{dataset_name}_{estimator.image_width}_"
            f"{estimator.image_height}_{args.n_measurement_frames}_{args.baseline}")
        save_results(predictions, gts, system_name, scene_name, args.output)


if __name__ == "__main__":
    main()
