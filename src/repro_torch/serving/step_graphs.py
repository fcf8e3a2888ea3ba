"""The serving engine's decode steps as CUDA graphs, one per shape key.

The counterpart of the reference's jitted, donated decode steps
(``repro.serving.engine``: ``decode_step`` and ``fused_steps``, one XLA
program per static shape).  A ``StepRunner`` owns one shape key of one
engine step:

  * static device inputs, packed into one byte buffer, and a pinned host
    staging buffer of the same layout, so that a call makes one
    host-to-device copy of every input;
  * a static device output and a pinned host copy of it, so that a call
    makes one device-to-host copy of the result;
  * on the card, the CUDA graph of the step.  The first call runs the
    step eagerly on the static inputs (the real step: it also builds and
    loads the kernels, their first attribute calls and the cuBLAS
    handles, outside any capture); the step is then captured, which
    executes nothing, and every later call stages its inputs and replays.

Every call rewrites every byte of the staged inputs, so a key's buffers
carry nothing from one call to the next.  The step must read only the
static inputs and tensors that are never rebound (the engine's weights
and its in-place KV pool and recurrent state), and write only the static
output and those tensors in place.

The kernel wrappers count launches in Python (``CudaKernel.launches``):
the counts a capture makes are taken back and added again at each replay
(``kernels.build.launches_withheld``), so the counts stay those of an
eager run.

Without graphs (``graphs=False``, or a CPU device) the same runner runs
the step eagerly on the same static buffers.  A failed capture or replay
raises; nothing falls back to the eager step.
"""

from __future__ import annotations

import functools
import time
from typing import Callable

import numpy as np
import torch

from ..kernels.build import launches_withheld

__all__ = ["StepRunner", "StepGraphs"]

_ALIGN = 16


@functools.cache
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of every engine's first calls and captures on one
    card.  cuBLAS keeps a workspace (32 MiB on an H100) for each stream it
    has run on, for the life of the process: a stream per engine would
    leave one behind per engine."""
    return torch.cuda.Stream(device)


class StepGraphs:
    """What the step runners of one engine share: the CUDA-graph memory
    pool, the stream the first calls and the captures run on, and the
    counts of both."""

    def __init__(self, device: torch.device, enabled: bool):
        self.device = device
        self.enabled = enabled and device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.enabled else None
        self.stream = _capture_stream(device) if self.enabled else None
        self.captured = 0             # graphs captured so far
        self.first_s = 0.0            # host seconds of first calls + captures


class StepRunner:
    """One shape key of a decode step (see the module docstring).

    ``inputs`` maps each input's name to its (shape, dtype); ``step``
    (given at each call, so that the runner holds no reference to its
    caller) takes the dict of static device inputs and returns the
    step's result, which is copied into the static output."""

    def __init__(self, graphs: StepGraphs, inputs: dict):
        self._graphs = graphs
        dev = graphs.device
        layout, size = {}, 0
        for name, (shape, dtype) in inputs.items():
            nbytes = int(np.prod(shape)) * torch.empty(
                (), dtype=dtype).element_size()
            layout[name] = (size, nbytes, tuple(shape), dtype)
            size += -(-nbytes // _ALIGN) * _ALIGN
        self._host = torch.empty(size, dtype=torch.uint8,
                                 pin_memory=dev.type == "cuda")
        self._dev = torch.empty(size, dtype=torch.uint8, device=dev)

        def views(buf):
            return {name: buf[off:off + n].view(dtype).view(shape)
                    for name, (off, n, shape, dtype) in layout.items()}

        self._staged = {name: t.numpy() for name, t in
                        views(self._host).items()}
        self.inputs = views(self._dev)
        self._out = self._host_out = None
        self._graph = None
        self._launches: dict = {}
        self._done = torch.cuda.Event() if dev.type == "cuda" else None
        self.calls = 0
        # host seconds of the calls after the first (stage, replay or the
        # eager step, copy back, wait): the steady-state cost of a call
        self.steady_s = 0.0

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, step: Callable[[dict], torch.Tensor],
                 **arrays: np.ndarray) -> np.ndarray:
        """Stage ``arrays`` (every input, by name), run the step and
        return its result in pinned host memory: a view that the next
        call overwrites."""
        if arrays.keys() != self._staged.keys():
            raise ValueError(f"StepRunner: inputs {sorted(arrays)}, "
                             f"expected {sorted(self._staged)}")
        t0 = time.perf_counter()
        for name, a in arrays.items():
            self._staged[name][...] = a
        self._dev.copy_(self._host, non_blocking=True)
        if self._graph is not None:
            self._graph.replay()
            for kern, n in self._launches.items():
                kern.launches += n
        elif self._graphs.enabled:
            t1 = time.perf_counter()
            self._first_call(step)
            self._graphs.first_s += time.perf_counter() - t1
        else:
            self._write(step(self.inputs))
        self._host_out.copy_(self._out, non_blocking=True)
        if self._done is not None:
            self._done.record()
            self._done.synchronize()
        if self.calls:
            self.steady_s += time.perf_counter() - t0
        self.calls += 1
        return self._host_out.numpy()

    def _write(self, result: torch.Tensor) -> None:
        if self._out is None:
            self._out = torch.empty_like(result)
            self._host_out = torch.empty(
                result.shape, dtype=result.dtype,
                pin_memory=result.device.type == "cuda")
        self._out.copy_(result)

    def _first_call(self, step) -> None:
        """The eager step on the capture stream, then its capture."""
        g = self._graphs
        current = torch.cuda.current_stream(g.device)
        g.stream.wait_stream(current)
        with torch.cuda.stream(g.stream):
            self._write(step(self.inputs))
        current.wait_stream(g.stream)
        graph = torch.cuda.CUDAGraph()
        with launches_withheld() as counted:
            with torch.cuda.graph(graph, pool=g.pool, stream=g.stream):
                self._out.copy_(step(self.inputs))
        self._graph, self._launches = graph, counted
        g.captured += 1
