"""CUDA graphs of the engine's, the baselines' and ``run_training``'s
steps: the counterpart of the JAX package's jitted programs
(dvmvs_tpu/apps/engine.py:57-71, where a step or a chunk of T steps is one
compiled dispatch, the baselines' jitted forwards, dvmvs_tpu/baselines/, and
the jitted train and eval steps, dvmvs_tpu/parallel/train.py:157-227).

A step is a body: a plain function of tensors that reads its arguments and
the model's weights, may write in place the recurrent state it is given (or,
a training step, the weights, the BatchNorm statistics and the optimizer's
state), and returns its outputs (a tensor, or tuples, lists and dicts of
them).
``StepGraph`` runs one body on arguments fixed when it is made:

  - on the card it warms the body up on a side stream, captures it once into
    a ``torch.cuda.CUDAGraph`` with a private memory pool, and from then on
    each ``run`` is one ``cudaGraphLaunch``; the outputs are the tensors the
    capture allocated, rewritten by every replay;
  - on the CPU it calls the body on the same arguments and copies its
    results into output buffers made at the first run, so the CPU has the
    card's semantics: what persists is the in-place writes and the output
    buffers, which the next ``run`` overwrites.

The caller fills the input buffers with ``copy_`` before a run and copies
what it keeps out of the outputs after it. What a body must keep to be
captured: it reads nothing but its arguments and the weights (both at fixed
addresses; ``load_state_dict`` copies weights in place, so a load after the
capture takes effect), it never synchronises with the host (no ``.item()``,
``.cpu()`` or data-dependent shapes), and it keeps state only by writing
into the buffers it was given: a state reassigned instead is not seen by
the next replay. A capture or replay that fails raises; nothing falls back
to running the body eagerly.

A body runs, warms up and is captured inside
``utils/precision.py::ieee_float32``: a replay runs the convolution kernels
chosen while the graph was captured, so the graph computes in IEEE float32
whatever the process's TF32 flags are at the replay.

The kernel wrappers (the plane sweep's forward and backward, the DLT
solve) count their launches in Python (``utils/profiling.py::counters``),
which a replay does not run: the count a capture records is added back at
every replay, and the capture's own (recorded, not launched) counts are
taken away. A run is the span ``dvmvs.graph.run`` and a capture, warm-up
included, ``dvmvs.graph.capture``; the counters ``graph.builds`` and
``graph.captures`` count the graphs made and captured.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Sequence

import torch

from dvmvs_tpu_torch.ops import dlt, plane_sweep
from dvmvs_tpu_torch.utils.precision import ieee_float32
from dvmvs_tpu_torch.utils.profiling import counters, span

# warm-up runs before a capture, on a side stream (PyTorch's graph docs):
# they build the kernels, the cuBLAS / cuDNN handles and workspaces and the
# convolution plans outside the capture
WARMUP_RUNS = 2

# the kernel launch counters a graph records at its capture and adds back
# at each replay
LAUNCHES = (plane_sweep.FORWARD_LAUNCHES, plane_sweep.BACKWARD_LAUNCHES, dlt.LAUNCHES)


def leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a tree of tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from leaves(v)


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor of a tree of tuples, lists and dicts; the
    tree's shape is kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def fill(buffer: torch.Tensor, value: torch.Tensor):
    """Copy ``value`` into its static buffer on the current stream: a host
    tensor bound for the card through pinned memory, without a host sync."""
    if value.device.type == "cpu" and buffer.device.type == "cuda":
        buffer.copy_(value.pin_memory(), non_blocking=True)
    else:
        buffer.copy_(value)


def _add_launches(counts):
    for name, n in zip(LAUNCHES, counts):
        if n:
            counters.add(name, n)


class StepGraph:
    """One step body on fixed arguments, captured on the card and replayed
    (module doc).

    ``args``: the body's keyword arguments (tensors or trees of them), the
    static buffers; ``state``: the tensors the body writes in place (among
    them, or the weights and optimizer state a training step updates),
    restored after the warm-up runs so that warming up does not advance the
    recurrence or train; ``warmup``: runs before the capture (0 when the
    same shapes were warmed up by an earlier capture); ``owner`` and
    ``eager``: who runs the step and how its eager path is asked for, named
    by the errors."""

    def __init__(self, name: str, body: Callable, args: Dict, state: Sequence[torch.Tensor] = (),
                 warmup: int = WARMUP_RUNS, owner: str = "the engine",
                 eager: str = "InferenceEngine(..., graphs=False)"):
        self.name, self.body, self.args = name, body, args
        self.owner, self.eager = owner, eager
        self.state = tuple(state)
        self.warmup = warmup
        self.device = next(leaves(args)).device
        self.graph = None
        self.outputs = None
        # kernel launches inside the graph, as counted under LAUNCHES
        self.launches = (0, 0, 0)
        counters.add("graph.builds")

    def run(self):
        """One step; returns the output buffers (valid until the next run)."""
        with span("dvmvs.graph.run"):
            if self.device.type != "cuda":
                with ieee_float32():
                    out = self.body(**self.args)
                if self.outputs is None:
                    self.outputs = tree_map(torch.empty_like, out)
                for dst, src in zip(leaves(self.outputs), leaves(out)):
                    dst.copy_(src)
                return self.outputs
            if self.graph is None:
                with ieee_float32(), span("dvmvs.graph.capture"):
                    self._capture()
            try:
                self.graph.replay()
            except RuntimeError as err:
                raise RuntimeError(f"replay of the CUDA graph of {self.owner} step "
                                   f"{self.name!r} failed ({self.eager} is the eager path)"
                                   ) from err
            _add_launches(self.launches)
            return self.outputs

    def _capture(self):
        counters.add("graph.captures")
        current = torch.cuda.current_stream(self.device)
        if self.warmup:
            # outside autograd: a clone of a parameter would keep its
            # gradient accumulator alive on this stream through the warm-up
            with torch.no_grad():
                saved = [t.clone() for t in self.state]
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(self.warmup):
                    self.body(**self.args)
            current.wait_stream(side)
            with torch.no_grad():
                for t, s in zip(self.state, saved):
                    t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        before = [counters[name] for name in LAUNCHES]
        try:
            # thread_local: a CUDA call of another thread (NCCL's watchdog,
            # a host prefetcher) does not invalidate this thread's capture
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = self.body(**self.args)
        except RuntimeError as err:
            raise RuntimeError(
                f"CUDA graph capture of {self.owner} step {self.name!r} failed; it is not run "
                f"eagerly instead ({self.eager} is the eager path)") from err
        finally:
            recorded = tuple(counters[name] - b for name, b in zip(LAUNCHES, before))
            _add_launches(-n for n in recorded)
        self.graph, self.outputs, self.launches = graph, outputs, recorded
