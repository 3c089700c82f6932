"""Online keyframe selection on the host (counterpart of
dvmvs_tpu/utils/keyframe_buffer.py, which cannot be imported without jax).

With ``store_return_indices`` an entry is ``(pose, data, frame index)``:
the index-file generator (``apps/simulate_keyframe_buffer.py``) reads the
measurement frames' indices back. ``SimpleBuffer`` is the fixed-stride
buffer of its ``simple<skip>`` mode.

Response codes of ``KeyframeBuffer.try_new_keyframe``:
  0  first frame accepted (no prediction yet)
  1  keyframe accepted: run a prediction
  2  pose too close to the last keyframe: skip
  3  tracking lost (> TRACKING_LOST_LIMIT consecutive invalid poses): the
     buffer was cleared and callers must reset recurrent state
  4  still lost (buffer already empty)
  5  pose missing but not yet lost
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from dvmvs_tpu_torch.ops.geometry import is_pose_available_np, pose_distance_np

TRACKING_LOST_LIMIT = 30


def _entry(store_index: bool, pose, data, index) -> Tuple:
    if store_index and index is None:
        raise ValueError("store_return_indices=True requires an index")
    return (pose, data, index) if store_index else (pose, data)


class KeyframeBuffer:
    def __init__(self, buffer_size: int, keyframe_pose_distance: float,
                 optimal_t_score: float, optimal_R_score: float,
                 store_return_indices: bool = False):
        self.buffer: deque = deque([], maxlen=buffer_size)
        self.keyframe_pose_distance = keyframe_pose_distance
        self.optimal_t_score = optimal_t_score
        self.optimal_R_score = optimal_R_score
        self._tracking_lost_counter = 0
        self._store_return_indices = store_return_indices

    def calculate_penalty(self, t_score: float, R_score: float) -> float:
        R_penalty = np.abs(R_score - self.optimal_R_score) ** 2.0
        t_diff = t_score - self.optimal_t_score
        t_penalty = np.abs(t_diff) ** 2.0
        if t_diff < 0.0:
            t_penalty *= 5.0
        return R_penalty + t_penalty

    def try_new_keyframe(self, pose: np.ndarray, entry_data,
                         index: Optional[int] = None) -> int:
        """Offer a frame; on acceptance (0 or 1) ``(pose, entry_data)`` (with
        ``index`` appended under ``store_return_indices``) is appended, and
        callers may replace ``buffer[-1]`` afterwards."""
        entry = _entry(self._store_return_indices, pose, entry_data, index)
        if not is_pose_available_np(pose):
            self._tracking_lost_counter += 1
            if self._tracking_lost_counter > TRACKING_LOST_LIMIT:
                if len(self.buffer) > 0:
                    self.buffer.clear()
                    return 3
                return 4
            return 5

        self._tracking_lost_counter = 0
        if len(self.buffer) == 0:
            self.buffer.append(entry)
            return 0
        combined, _, _ = pose_distance_np(pose, self.buffer[-1][0])
        if combined >= self.keyframe_pose_distance:
            self.buffer.append(entry)
            return 1
        return 2

    def get_best_measurement_frames(self, n_requested: int) -> List[Tuple]:
        """The ``n_requested`` buffered keyframes (excluding the newest, which
        is the reference) whose pose distance to the reference is closest to
        the optimal (t, R) scores."""
        frames = list(self.buffer)
        reference_pose = frames[-1][0]
        n = min(n_requested, len(frames) - 1)
        penalties = []
        for i in range(len(frames) - 1):
            _, R_measure, t_measure = pose_distance_np(reference_pose, frames[i][0])
            penalties.append(self.calculate_penalty(t_measure, R_measure))
        indices = np.argpartition(penalties, n - 1)[:n]
        return [frames[i] for i in indices]


class SimpleBuffer:
    """Fixed-stride buffer of the ``simple<skip>`` index mode (reference:
    dvmvs/keyframe_buffer.py:91-129): every offered frame with a pose is
    kept, and the ``buffer_size`` before the newest are its measurements.

    Response codes of ``try_new_keyframe``: 0 first frame, 1 predict, 2
    tracking lost (buffer cleared), 3 still lost, 4 pose missing."""

    def __init__(self, buffer_size: int, store_return_indices: bool = False):
        self.buffer: deque = deque([], maxlen=buffer_size + 1)
        self._tracking_lost_counter = 0
        self._store_return_indices = store_return_indices

    def try_new_keyframe(self, pose: np.ndarray, entry_data,
                         index: Optional[int] = None) -> int:
        entry = _entry(self._store_return_indices, pose, entry_data, index)
        if not is_pose_available_np(pose):
            self._tracking_lost_counter += 1
            if self._tracking_lost_counter > TRACKING_LOST_LIMIT:
                if len(self.buffer) > 0:
                    self.buffer.clear()
                    return 2
                return 3
            return 4

        self._tracking_lost_counter = 0
        self.buffer.append(entry)
        return 0 if len(self.buffer) == 1 else 1

    def get_measurement_frames(self) -> List[Tuple]:
        return list(self.buffer)[:-1]
