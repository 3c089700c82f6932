"""Configuration of dvmvs_tpu_torch (a copy of dvmvs_tpu/config.py: the
same dataclasses, field names and defaults; tests/test_torch_config.py holds
the two equal).

Parameter names and default values mirror the reference system's static
``Config`` class (reference: dvmvs/config.py:4-51) for traceability, but are
exposed as frozen dataclasses so configs are explicit values passed to
functions rather than global mutable state (the reference mutates Config at
import time from per-script hyperparameter classes; we avoid that).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DepthConfig:
    """Depth hypothesis range shared by training and testing.

    Reference: dvmvs/config.py:8-10.
    """

    min_depth: float = 0.25
    max_depth: float = 20.0
    n_depth_levels: int = 64

    @property
    def inverse_depth_base(self) -> float:
        return 1.0 / self.max_depth

    @property
    def inverse_depth_multiplier(self) -> float:
        return 1.0 / self.min_depth - 1.0 / self.max_depth

    @property
    def inverse_depth_step(self) -> float:
        return self.inverse_depth_multiplier / (self.n_depth_levels - 1)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training settings. Reference: dvmvs/config.py:5-21 and the
    per-model TrainingHyperparameters (fusionnet/run-training.py:18-32,
    pairnet/run-training.py:18-34)."""

    image_width: int = 256
    image_height: int = 256
    depth: DepthConfig = DepthConfig()
    minimum_pose_distance: float = 0.125
    maximum_pose_distance: float = 0.325
    crawl_step: int = 3
    subsequence_length: int = 8
    predict_two_way: bool = False
    freeze_batch_normalization: bool = False
    data_pipeline_workers: int = 8
    epochs: int = 100000
    print_frequency: int = 5000
    validate: bool = True
    seed: int = 0

    # optimizer (reference: fusionnet/run-training.py:20-24)
    batch_size: int = 4
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    weight_decay: float = 0.0
    loss_type: str = "L1-inv"
    # epochs per non-final unfreeze stage; the reference trains pairnet's
    # first stage for 2 epochs and fusionnet's first two stages for 1 each
    # (pairnet/run-training.py:31, fusionnet/run-training.py:30)
    finetune_epochs: int = 1


@dataclasses.dataclass(frozen=True)
class TestConfig:
    """Inference settings. Reference: dvmvs/config.py:23-33."""

    image_width: int = 320
    image_height: int = 256
    depth: DepthConfig = DepthConfig()
    distortion_crop: int = 0
    perform_crop: bool = False
    visualize: bool = False
    n_measurement_frames: int = 2
    keyframe_buffer_size: int = 30
    keyframe_pose_distance: float = 0.1
    optimal_t_measure: float = 0.15
    optimal_R_measure: float = 0.0

    @property
    def image_size(self) -> Tuple[int, int]:
        return (self.image_height, self.image_width)


@dataclasses.dataclass(frozen=True)
class PathsConfig:
    """Dataset / run directories. Reference: dvmvs/config.py:35-51."""

    dataset: Optional[str] = None
    train_run_directory: Optional[str] = None
    test_online_scene_path: Optional[str] = None
    test_offline_data_path: Optional[str] = None
    test_dataset_name: Optional[str] = None
    test_result_folder: Optional[str] = None


# ImageNet normalization used by all drivers at test time
# (reference: fusionnet/run-testing-online.py:62-64).
SCALE_RGB = 255.0
MEAN_RGB = (0.485, 0.456, 0.406)
STD_RGB = (0.229, 0.224, 0.225)

DEFAULT_TRAIN = TrainConfig()
DEFAULT_TEST = TestConfig()
