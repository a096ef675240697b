"""One function of tensors as a CUDA graph, for the fixed-shape loops that
the learners and controllers replay: the PPO train step's phases and
evaluation (learn/ppo.py), the evolutionary fitness (learn/
neuroevolution.py), the adaptive controller (learn/adaptive.py) and the
expert rollouts (control/heuristics.py)."""

from __future__ import annotations

import gc
import time
from typing import Callable

import torch

from gym_copter_tpu_torch.core.tree import tree_leaves, tree_map
from gym_copter_tpu_torch.utils import profiling


class Graph:
    """`fn` as one CUDA graph, captured at the first call.  The inputs are
    copied into static buffers (skipped for a buffer passed back as itself;
    an input that is another slot's buffer is read first),
    the graph replays, and the static outputs are returned: a caller that
    keeps them past the next replay clones them.  Warm-up runs on a side
    stream before the capture, as torch's whole-network capture example
    does; it also fills the constant caches (`envs/base._const`), since a
    copy from the host cannot be captured.  A capture that fails raises.

    A loop that replays the graph passes its outputs back as the next
    inputs and `inputs` for what does not change, so that nothing is
    copied between replays.

    `name` (default: the function's) names the graph in the recorder of
    utils/profiling.py, which keeps every capture's host seconds and its
    nodes per region (`profiling.region`), and while it is on spans the
    capture as `graph.capture`."""

    def __init__(self, fn: Callable, warmup: int, name: str = None):
        self.fn, self.warmup = fn, warmup
        self.name = name or getattr(fn, '__qualname__', 'graph')
        self.graph = None

    def _capture(self, inputs):
        t0 = time.perf_counter_ns()
        with profiling.span('graph.capture', self.name):
            self.inputs = tree_map(torch.clone, inputs)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(self.warmup):
                    self.fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # a CUDA graph freed while another is captured (an earlier Graph
            # in a reference cycle, reached by the cyclic collector)
            # invalidates the capture: collect before it, and not during it
            gc.collect()
            enabled = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    with profiling.counting(self.name) as counts:
                        self.outputs = self.fn(*self.inputs)
            finally:
                if enabled:
                    gc.enable()
            self.graph = graph
        profiling.captured(counts, (time.perf_counter_ns() - t0) * 1e-9)

    def __call__(self, *inputs):
        if self.graph is None:
            self._capture(inputs)
        static = tree_leaves(self.inputs)
        buffers = {s.untyped_storage().data_ptr() for s in static}
        # an output passed back can be another slot's static input (a PID's
        # d2 = d1): read every such input before any buffer is overwritten
        pairs = [(s, x.clone() if x.untyped_storage().data_ptr() in buffers
                  else x)
                 for s, x in zip(static, tree_leaves(inputs)) if s is not x]
        for s, x in pairs:
            s.copy_(x)
        self.graph.replay()
        return self.outputs
