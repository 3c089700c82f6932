"""Bulk evaluation of the baseline depth estimators over keyframe index files
(counterpart of dvmvs_tpu/apps/run_testing_baseline.py; reference:
dvmvs/baselines/*/run-testing.py, one shared loop instead of four clones).

Per index line the reference and measurement frames are read, preprocessed
for the estimator (its size and normalisation, no crop), and predicted;
``TRACKING LOST`` resets the estimator. Predictions and the 8 error metrics
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
from dvmvs_tpu_torch.utils.results import InferenceTimer, save_results


def evaluate_scene_baseline(estimator, scene_folder: str, index_file: str,
                            evaluate: bool = True, max_frames: Optional[int] = None,
                            timer: Optional[InferenceTimer] = None):
    """Predict every keyframe line of ``index_file`` with ``estimator``.
    Returns (predictions, ground-truth depths at the estimator's size, or
    None). ``timer`` (default a fresh one) times each ``predict``."""
    with open(index_file) as f:
        lines = [line for line in f.read().splitlines() if line]

    K = np.loadtxt(os.path.join(scene_folder, "K.txt")).astype(np.float32)
    poses = np.fromfile(os.path.join(scene_folder, "poses.txt"), dtype=float,
                        sep="\n ").reshape(-1, 4, 4)
    images_dir = os.path.join(scene_folder, "images")
    image_filenames = sorted(f for f in os.listdir(images_dir) if f.endswith(".png"))
    name_to_index = {f: i for i, f in enumerate(image_filenames)}
    depth_dir = os.path.join(scene_folder, "depth")
    depth_filenames = (
        sorted(f for f in os.listdir(depth_dir) if f.endswith(".png"))
        if evaluate and os.path.isdir(depth_dir) else None)

    predictions = []
    reference_depths = [] if depth_filenames is not None else None
    preprocessor = None
    timer = InferenceTimer() if timer is None else timer
    estimator.reset()

    def preprocess(raw):
        return preprocessor.apply_rgb(raw, estimator.scale_rgb, list(estimator.mean_rgb),
                                      list(estimator.std_rgb))

    for line in lines:
        if max_frames is not None and len(predictions) >= max_frames:
            break
        if line == "TRACKING LOST":
            estimator.reset()
            continue
        ref_name, *meas_names = line.split(" ")
        ref_index = name_to_index[ref_name]

        raw = load_image(os.path.join(images_dir, ref_name))
        if preprocessor is None:
            preprocessor = PreprocessImage(
                K=K, old_width=raw.shape[1], old_height=raw.shape[0],
                new_width=estimator.image_width, new_height=estimator.image_height,
                distortion_crop=0, perform_crop=False)
        ref_image = preprocess(raw)
        updated_K = preprocessor.get_updated_intrinsics().astype(np.float32)

        if reference_depths is not None:
            d = load_depth_png(os.path.join(depth_dir, depth_filenames[ref_index]))
            reference_depths.append(preprocessor.apply_depth(d))

        meas_images = [preprocess(load_image(os.path.join(images_dir, m))) for m in meas_names]
        meas_poses = [poses[name_to_index[m]] for m in meas_names]

        timer.record_start_time()
        depth = estimator.predict(ref_image, meas_images, poses[ref_index], meas_poses,
                                  updated_K)
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
