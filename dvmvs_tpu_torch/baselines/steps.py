"""The baselines' forwards as CUDA graphs: the counterpart of the JAX
package's jitted forwards (dvmvs_tpu/baselines/mvdepthnet.py:38-48,
gpmvs.py:113-125, dpsnet.py:239-240, deltas.py:651).

An estimator splits ``predict`` into steps, each a body: a plain function
of tensors that reads its arguments and the model's weights and returns its
outputs. ``GraphedEstimator._step`` runs a body one of two ways:

  - ``graphs=True`` (the default): the host inputs are copied into static
    buffers (pinned, without a host sync, on the card) and the body runs as
    an ``apps/graphs.py::StepGraph``, captured at the first ``predict`` on
    the card and one ``cudaGraphLaunch`` after that; on the CPU the same
    body runs on the same buffers without capture. The outputs are the
    step's buffers, which its next run rewrites;
  - ``graphs=False``: the body is called on freshly uploaded tensors (the
    eager path; ``apps/profile_baselines.py``'s stage split uses it).

Both ways compute in IEEE float32, the reference's mode, whatever the
process's TF32 flags are (``utils/precision.py``).

A step's ``fixed`` tensors (an earlier step's output buffers) are read in
place, so the step is keyed on their addresses: GP-MVS's decoder reads the
encoder graph's skips on the device. Both graphs run on one stream, so the
first graph's next replay cannot overwrite them before the second has read
them. What leaves for the
host is copied (``_readback``): on the CPU ``.cpu()`` of a buffer would
return the buffer itself. The buffers are made inside ``predict``'s
inference mode and written only there.

Under ``torch.profiler`` the host work of every baseline shows as spans
(``utils/profiling.py::span``), none inside a step body: ``dvmvs.baseline.
inputs`` (``relative_inputs``, and the U-Nets' ``host_views``: padding the
views, the relative poses), ``dvmvs.baseline.fill`` (the graph lookup and
the copy into static buffers), ``dvmvs.graph.run`` and ``dvmvs.baseline.
readback`` (a copy to the host: the depth, and GP-MVS's latent before it);
``apps/run_testing_baseline.py`` adds ``dvmvs.baseline.frames``. The
counters ``baseline.predicts``, ``baseline.h2d_bytes`` and
``baseline.d2h_bytes`` count the depths read back and the bytes copied in
from host arrays and out to the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dvmvs_tpu_torch.apps.graphs import StepGraph, fill, leaves
from dvmvs_tpu_torch.baselines.registry import DepthEstimator, pad_views
from dvmvs_tpu_torch.utils.precision import ieee_float32
from dvmvs_tpu_torch.utils.profiling import counters, span


def relative_inputs(n_views: int, ref_image, meas_images, ref_pose, meas_poses, K,
                    rows: int = 4) -> dict:
    """Host inputs of the models that take relative poses (DPSNet: the top
    ``rows=3``, DELTAS: all 4): the frame (H, W, 3), the measurement frames
    (V, H, W, 3) padded with view 0, measurement <- reference poses (V, rows,
    4), K (3, 3) and the view mask (1, V)."""
    with span("dvmvs.baseline.inputs"):
        images, poses, mask = pad_views(n_views, meas_images, meas_poses)
        rel = np.stack([(np.linalg.inv(p) @ ref_pose)[:rows] for p in poses])
        return {"ref": np.asarray(ref_image), "meas": images, "rel": rel, "K": np.asarray(K),
                "mask": mask}


def relative_views(ref, meas, rel, K, mask):
    """``relative_inputs`` on the device -> the model's batch-of-one
    arguments (ref (1, 3, H, W), meas (1, V, 3, H, W), rel, K, mask)."""
    return ref.permute(2, 0, 1)[None], meas.permute(0, 3, 1, 2)[None], rel[None], K[None], mask


class GraphedEstimator(DepthEstimator):
    """A ``DepthEstimator`` whose ``predict`` runs its steps through
    ``_step`` (module doc). Subclasses set ``self.device`` and call
    ``_init_steps``."""

    device: torch.device

    def _init_steps(self, graphs: bool):
        self.graphs = graphs
        self.step_graphs: Dict[tuple, StepGraph] = {}

    @staticmethod
    def _host_tensor(value) -> torch.Tensor:
        """A host array as a float32 tensor, its bytes counted as copied in."""
        t = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
        counters.add("baseline.h2d_bytes", t.nbytes)
        return t

    def _fresh(self, value) -> torch.Tensor:
        """An input as the eager path takes it: a host array uploaded as
        float32, a device tensor as given."""
        if isinstance(value, torch.Tensor):
            return value
        return self._host_tensor(value).to(self.device)

    def _buffer(self, value) -> torch.Tensor:
        dtype = value.dtype if isinstance(value, torch.Tensor) else torch.float32
        return torch.empty(tuple(value.shape), dtype=dtype, device=self.device)

    def _fill(self, buffer: torch.Tensor, value):
        """Copy an input into its static buffer (a host array through pinned
        memory, without a host sync)."""
        if not isinstance(value, torch.Tensor):
            value = self._host_tensor(value)
        fill(buffer, value)

    def _step(self, name: str, body, inputs: dict, fixed: Optional[dict] = None):
        """Run a step body on ``inputs`` (host arrays or device tensors) and
        ``fixed`` tensors; returns its outputs (module doc)."""
        fixed = fixed or {}
        if not self.graphs:
            with ieee_float32():
                return body(**{k: self._fresh(v) for k, v in inputs.items()}, **fixed)
        with span("dvmvs.baseline.fill"):
            key = (name, tuple((k, tuple(v.shape)) for k, v in inputs.items()),
                   tuple(t.data_ptr() for t in leaves(fixed)))
            step = self.step_graphs.get(key)
            if step is None:
                cls = type(self).__name__
                step = self.step_graphs[key] = StepGraph(
                    name, body, {**{k: self._buffer(v) for k, v in inputs.items()}, **fixed},
                    owner=f"the {cls}", eager=f"{cls}(..., graphs=False)")
            for k, v in inputs.items():
                self._fill(step.args[k], v)
        return step.run()

    @staticmethod
    def _to_host(t: torch.Tensor) -> np.ndarray:
        """A host copy of a device tensor (a copy on the CPU too), the bytes
        counted as read back."""
        with span("dvmvs.baseline.readback"):
            out = t.to("cpu", copy=True).numpy()
        counters.add("baseline.d2h_bytes", out.nbytes)
        return out

    @staticmethod
    def _readback(depth: torch.Tensor) -> np.ndarray:
        """The host copy of a (1, H, W) depth, once a ``predict``."""
        counters.add("baseline.predicts")
        return GraphedEstimator._to_host(depth[0])
