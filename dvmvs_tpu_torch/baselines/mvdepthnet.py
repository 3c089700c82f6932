"""MVDepthNet baseline (counterpart of dvmvs_tpu/baselines/mvdepthnet.py;
reference: dvmvs/baselines/mvdepthnet/run-testing.py).

A full-resolution L1 plane-sweep cost volume over the normalised RGB frames
(64 planes, 0.5-50 m; ``ops/cost_volume.py::cost_volume_fused`` in L1 mode,
the forward kernel ``csrc/plane_sweep.cu`` on the card) + the U-Net of
``mvdepth_backbone``; inverse depth clamped to [0.02, 2] and inverted.
Normalisation mean/std 81/35, scale 1. Missing measurement views are padded
with view 0 under a mask. ``predict`` is one CUDA graph replay on the card
(the JAX package's one jit), the sweep's kernel launched inside it.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn as nn

from dvmvs_tpu_torch.baselines.mvdepth_backbone import (
    N_LEVELS,
    MVDepthDecoder,
    MVDepthEncoder,
)
from dvmvs_tpu_torch.baselines.registry import pad_views, register_baseline
from dvmvs_tpu_torch.baselines.steps import GraphedEstimator
from dvmvs_tpu_torch.models.layers import seeded_model
from dvmvs_tpu_torch.ops.cost_volume import cost_volume_fused
from dvmvs_tpu_torch.utils.profiling import span

MIN_DEPTH, MAX_DEPTH = 0.5, 50.0


def l1_cost_volume(image, meas_images, pose, meas_poses, K, mask):
    """image (B, 3, H, W), meas_images (B, V, 3, H, W), poses camera-to-world,
    K (B, 3, 3) at the frame size, mask (B, V) -> (B, 64, H, W) masked mean of
    the per-view L1 costs."""
    return cost_volume_fused(image, meas_images, pose, meas_poses, K, MIN_DEPTH, MAX_DEPTH,
                             N_LEVELS, dot_product=False, view_mask=mask)


def inverse_disparity(disp1):
    """(B, 1, H, W) disparity -> (B, H, W) depth, the disparity clamped to
    [0.02, 2]."""
    return 1.0 / torch.clamp(disp1[:, 0], 0.02, 2.0)


class MVDepthNetModel(nn.Module):
    """Encoder + decoder; ``encoder.state_dict()`` and ``decoder.state_dict()``
    are the reference's two weight files."""

    def __init__(self):
        super().__init__()
        self.encoder = MVDepthEncoder()
        self.decoder = MVDepthDecoder()

    def forward(self, image, meas_images, pose, meas_poses, K, mask):
        cv = l1_cost_volume(image, meas_images, pose, meas_poses, K, mask)
        return inverse_disparity(self.decoder(*self.encoder(image, cv))[0])


def host_views(n_views: int, ref_image, meas_images, ref_pose, meas_poses, K) -> dict:
    """Host inputs of the U-Nets: the frame (H, W, 3), the measurement
    frames (V, H, W, 3) padded with view 0, the poses (4, 4) and (V, 4, 4),
    K (3, 3) and the view mask (V,)."""
    with span("dvmvs.baseline.inputs"):
        images, poses, mask = pad_views(n_views, meas_images, meas_poses)
        return {"image": np.asarray(ref_image), "meas": images, "pose": np.asarray(ref_pose),
                "meas_poses": poses, "K": np.asarray(K), "mask": mask[0]}


def device_views(image, meas, pose, meas_poses, K, mask):
    """``host_views`` on the device -> batch-of-one model arguments: image (1,
    3, H, W), meas (1, V, 3, H, W), pose (1, 4, 4), meas poses (1, V, 4, 4),
    K (1, 3, 3), mask (1, V)."""
    return (image[None].permute(0, 3, 1, 2), meas[None].permute(0, 1, 4, 2, 3), pose[None],
            meas_poses[None], K[None], mask[None])


def upload_views(device, ref_image, meas_images, ref_pose, meas_poses, K, n_views: int):
    """Host frames (H, W, 3), poses and K -> ``device_views``'s tensors on
    ``device``; views padded with view 0."""
    host = host_views(n_views, ref_image, meas_images, ref_pose, meas_poses, K)
    return device_views(**{k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
                           .to(device) for k, v in host.items()})


@register_baseline("mvdepthnet")
class MVDepthNet(GraphedEstimator):
    image_width = 320
    image_height = 256
    scale_rgb = 1.0
    mean_rgb = (81.0, 81.0, 81.0)
    std_rgb = (35.0, 35.0, 35.0)

    def __init__(self, n_measurement_frames: int = 2, state_dict=None, seed: int = 0,
                 device="cuda", graphs: bool = True):
        """Runs on the card unless ``device="cpu"``; weights from a generator
        seeded with ``seed``, or ``state_dict`` (the model's own keys:
        ``encoder.*``, ``decoder.*``). ``graphs``: ``predict`` as one CUDA
        graph replay on the card (``baselines/steps.py``), else eagerly."""
        self.V = n_measurement_frames
        self.model = seeded_model(MVDepthNetModel(), seed, device, state_dict)
        self.device = next(self.model.parameters()).device
        self._init_steps(graphs)

    def _forward_body(self, **views):
        return self.model(*device_views(**views))

    @torch.inference_mode()
    def predict(self, ref_image, meas_images: List[np.ndarray], ref_pose, meas_poses,
                K) -> np.ndarray:
        views = host_views(self.V, ref_image, meas_images, ref_pose, meas_poses, K)
        return self._readback(self._step("forward", self._forward_body, views))
