"""The reference's loops: keyframe selection, the online recurrence, a
bulk keyframe, and the training step with its loss and a plain Adam.

Everything is worked out from the inputs the benchmark makes (frames,
poses, K, weights): the keyframe choice and the measurement frames from the
poses, the plane matrices and the splat from the poses and K, the training
update with ``torch.optim.Adam``. Computation is in IEEE float32
(``ieee``), the configurations' precision.
"""

from __future__ import annotations

import contextlib
from collections import deque

import numpy as np
import torch

from benchmark.reference import geometry
from benchmark.reference.nets import resize_nearest

TRACKING_LOST_LIMIT = 30


@contextlib.contextmanager
def ieee():
    """cuDNN convolutions and cuBLAS matmuls in IEEE float32 inside the
    block; the flags are restored after it."""
    flags = [torch.backends.cudnn.conv, torch.backends.cuda.matmul]
    saved = [f.fp32_precision for f in flags]
    for f in flags:
        f.fp32_precision = "ieee"
    try:
        yield
    finally:
        for f, s in zip(flags, saved):
            f.fp32_precision = s


class KeyframeBuffer:
    """DeepVideoMVS's online keyframe heuristic (keyframe_buffer.py).
    ``offer`` returns 0 first frame, 1 keyframe to predict, 2 too close, 3
    tracking lost (buffer cleared), 4 still lost, 5 pose missing."""

    def __init__(self, size: int, pose_distance: float, optimal_t: float, optimal_R: float):
        self.buffer = deque([], maxlen=size)
        self.pose_distance, self.optimal_t, self.optimal_R = pose_distance, optimal_t, optimal_R
        self.lost = 0

    def offer(self, pose, entry) -> int:
        if not np.isfinite(pose).all():
            self.lost += 1
            if self.lost > TRACKING_LOST_LIMIT:
                if self.buffer:
                    self.buffer.clear()
                    return 3
                return 4
            return 5
        self.lost = 0
        if not self.buffer:
            self.buffer.append((pose, entry))
            return 0
        if geometry.pose_distance(pose, self.buffer[-1][0])[0] >= self.pose_distance:
            self.buffer.append((pose, entry))
            return 1
        return 2

    def measurement_frames(self, n: int):
        frames = list(self.buffer)
        ref = frames[-1][0]
        n = min(n, len(frames) - 1)
        penalties = []
        for pose, _ in frames[:-1]:
            _, R, t = geometry.pose_distance(ref, pose)
            t_pen = abs(t - self.optimal_t) ** 2.0 * (5.0 if t < self.optimal_t else 1.0)
            penalties.append(abs(R - self.optimal_R) ** 2.0 + t_pen)
        return [frames[i] for i in np.argpartition(penalties, n - 1)[:n]]


def keyframe_lines(poses, test: dict):
    """Per predicted keyframe (frame index, measurement frame indices), and
    the indices after which tracking was lost ("TRACKING LOST")."""
    buf = KeyframeBuffer(test["keyframe_buffer_size"], test["keyframe_pose_distance"],
                         test["optimal_t_measure"], test["optimal_R_measure"])
    lines = []
    for i, pose in enumerate(poses):
        r = buf.offer(pose, i)
        if r == 3:
            lines.append(None)
        elif r == 1:
            lines.append((i, [e for _, e in buf.measurement_frames(test["n_measurement_frames"])]))
    return lines


@torch.no_grad()
def online_walk(model, frames, poses, K, test: dict):
    """The online loop over one walk: ``frames(i)`` the normalised frame i
    (H, W, 3) on the device, ``poses`` (N, 4, 4), K (3, 3). Returns, per
    predicted keyframe, (frame index, depth (H, W), half-resolution
    features (C, h, w)), and the state at the end: (h, c, previous depth)
    of a recurrent model (fusionnet), None of a stateless one."""
    device = next(model.parameters()).device
    H, W = test["image_height"], test["image_width"]
    V = test["n_measurement_frames"]
    Kt = torch.as_tensor(K, dtype=torch.float32, device=device)[None]
    recurrent = hasattr(model, "lstm_fusion")
    hidden = model.lstm_fusion.lstm_cell.hidden_dim if recurrent else 0
    zeros = (lambda: ((torch.zeros((1, hidden, H // 32, W // 32), device=device),) * 2,
                      torch.eye(4, device=device)[None], torch.zeros((1, H, W), device=device),
                      False))
    carry, prev_pose, prev_depth, has_prev = zeros()
    buf = KeyframeBuffer(test["keyframe_buffer_size"], test["keyframe_pose_distance"],
                         test["optimal_t_measure"], test["optimal_R_measure"])
    out = []
    for i, pose in enumerate(poses):
        r = buf.offer(pose, None)
        if r in (2, 4, 5):
            continue
        if r == 3:
            carry, prev_pose, prev_depth, has_prev = zeros()
            continue
        image = frames(i).permute(2, 0, 1)[None]
        feats = model.extract_features(image)
        if r == 0:
            buf.buffer[-1] = (pose, feats[0])
            continue
        chosen = buf.measurement_frames(V)
        meas = [e[1] for e in chosen] + [chosen[0][1]] * (V - len(chosen))
        mask = torch.zeros((1, V), device=device)
        mask[0, :len(chosen)] = 1.0
        meas_poses = torch.stack([torch.as_tensor(e[0], dtype=torch.float32, device=device)
                                  for e in chosen + [chosen[0]] * (V - len(chosen))])[None]
        ref_pose = torch.as_tensor(pose, dtype=torch.float32, device=device)[None]
        if not recurrent:
            depths = model.predict_depth(image, feats, torch.stack(meas, 1), ref_pose, meas_poses,
                                         Kt, mask)
        else:
            if has_prev:
                hyp = geometry.splat_hypothesis(prev_depth, prev_pose, ref_pose, Kt, H // 32,
                                                W // 32)
            else:
                hyp = torch.zeros((1, H // 32, W // 32), device=device)
            depths, carry = model.predict_depth(image, feats, torch.stack(meas, 1), ref_pose,
                                                meas_poses, Kt, mask, carry, prev_pose, hyp)
        prev_pose, prev_depth, has_prev = ref_pose, depths[0], True
        buf.buffer[-1] = (pose, feats[0])
        out.append((i, depths[0][0], feats[0][0]))
    return out, ((carry[0][0], carry[1][0], prev_depth[0]) if recurrent else None)


@torch.no_grad()
def pair_keyframe(model, frame, ref, meas, poses, K, V: int):
    """A stateless (pairnet) keyframe: ``frame(name)`` the normalised frame
    (H, W, 3) on the device, ``ref`` and ``meas`` names, ``poses[name]``.
    Returns (depth (H, W), the reference frame's features)."""
    device = next(model.parameters()).device
    Kt = torch.as_tensor(K, dtype=torch.float32, device=device)[None]
    image = frame(ref).permute(2, 0, 1)[None]
    feats = model.extract_features(image)
    n = len(meas)
    names = list(meas) + [meas[0]] * (V - n)
    mask = torch.zeros((1, V), device=device)
    mask[0, :n] = 1.0
    meas_half = torch.stack([model.extract_features(frame(m).permute(2, 0, 1)[None])[0]
                             for m in names], 1)
    meas_poses = torch.stack([torch.as_tensor(poses[m], dtype=torch.float32, device=device)
                              for m in names])[None]
    ref_pose = torch.as_tensor(poses[ref], dtype=torch.float32, device=device)[None]
    depths = model.predict_depth(image, feats, meas_half, ref_pose, meas_poses, Kt, mask)
    return depths[0][0], feats


def fusionnet_sequence_loss(model, batch):
    """The L1-inv loss of a fusionnet subsequence batch, back-propagated
    through time: images (B, S, H, W, 3), depths (B, S, H, W), poses (B, S,
    4, 4), K (B, 3, 3). The hidden state is warped with the ground truth
    nearest-downsampled to 1/32; the loss sums, over frames 1..S-1 and the
    five scales, the masked mean of |1/gt - 1/pred| at each scale's size.
    Returns the loss and the step's metrics: the masked sums of the last
    frame's last prediction in the decoder's order (``l1``, ``huber``,
    ``l1_inv``, ``l1_rel``, ``valid_count``)."""
    images, depths, poses, K = batch["images"], batch["depths"], batch["poses"], batch["K"]
    B, S, H, W, _ = images.shape
    nchw = images.permute(0, 1, 4, 2, 3)
    feats = [f.reshape((B, S) + f.shape[1:])
             for f in model.extract_features(nchw.reshape(B * S, 3, H, W))]
    half_K = geometry.scale_intrinsics(K, 0.5)
    hyps = resize_nearest(depths.reshape(B * S, H, W), H // 32, W // 32).reshape(
        B, S, H // 32, W // 32)
    hidden = model.lstm_fusion.lstm_cell.hidden_dim
    h = c = torch.zeros((B, hidden, H // 32, W // 32), device=images.device)
    inv = geometry.inverse_depth_planes(model.min_depth, model.max_depth, model.n_depth_levels,
                                        images.device)
    total, metrics = 0.0, {}
    for t in range(1, S):
        mats = geometry.plane_matrices(poses[:, t], poses[:, t - 1], half_K, inv)
        cv = geometry.sweep_view(feats[0][:, t], feats[0][:, t - 1], mats)
        skip0, skip1, skip2, skip3, bottom = model.cost_volume_encoder(
            *(f[:, t] for f in feats), cv)
        h = geometry.warp_hidden_state(h, poses[:, t - 1], poses[:, t], hyps[:, t],
                                       geometry.scale_intrinsics(K, 1.0 / 32.0))
        h, c = model.lstm_fusion(bottom, h, c)
        preds = model.cost_volume_decoder(nchw[:, t], skip0, skip1, skip2, skip3, h)
        for pred in preds:
            gt = resize_nearest(depths[:, t], pred.shape[-2], pred.shape[-1])
            valid = gt != 0
            safe = torch.where(valid, gt, torch.ones_like(gt))
            l1_inv = ((1.0 / safe - 1.0 / pred).abs() * valid).sum()
            total = total + l1_inv / torch.clamp(valid.sum().to(pred.dtype), min=1.0)
            diff = (gt - pred).abs() * valid
            huber = torch.where((gt - pred).abs() < 1.0, 0.5 * (gt - pred) ** 2,
                                (gt - pred).abs() - 0.5) * valid
            metrics = {"l1": diff.sum(), "huber": huber.sum(), "l1_inv": l1_inv,
                       "l1_rel": (diff / safe).sum(), "valid_count": valid.sum().to(pred.dtype)}
    return total, metrics


def train_steps(model, batches, lr: float, betas, eps: float) -> dict:
    """Plain training steps of a fusionnet in train mode with
    ``torch.optim.Adam`` over every parameter, one a batch. Returns, by
    name: ``losses`` and ``metrics`` (one a step); after the first step
    ``first_grads`` (every parameter's gradient) and ``first_exp_avg_sq``
    (Adam's second moment); after the last step ``params``, ``buffers``
    (BatchNorm's running statistics) and ``adam_steps`` (Adam's step count
    of every parameter)."""
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=betas, eps=eps)
    named = list(model.named_parameters())
    losses, metrics, first = [], [], {}
    for batch in batches:
        optimizer.zero_grad(set_to_none=True)
        loss, step_metrics = fusionnet_sequence_loss(model, batch)
        loss.backward()
        optimizer.step()
        if not first:
            # a parameter that had no gradient has no state: zero moments
            first = {"first_grads": {n: p.grad.detach().clone() if p.grad is not None
                                     else torch.zeros_like(p) for n, p in named},
                     "first_exp_avg_sq": {n: optimizer.state[p]["exp_avg_sq"].clone()
                                          if p in optimizer.state else torch.zeros_like(p)
                                          for n, p in named}}
        losses.append(float(loss.detach()))
        metrics.append({k: float(v.detach()) for k, v in step_metrics.items()})
    return {"losses": losses, "metrics": metrics, **first,
            "params": {n: p.detach().clone() for n, p in named},
            "buffers": {n: b.detach().clone() for n, b in model.named_buffers()},
            "adam_steps": {n: float(optimizer.state[p]["step"]) if p in optimizer.state else 0.0
                           for n, p in named}}
