"""The card's state beside a measurement: its device time per CUDA graph
node, and the warm-up that waits until that time is back at its floor.

After a CUDA graph capture the H100 can run every graph node ~30 % slower
(~1.43 against ~1.08 µs) for seconds to a minute, with nvidia-smi showing
the same clock and no throttle reason.  A cell whose timed path replays
graphs therefore warms up, after its captures, until the node time read
by `NodeLatency` is within `fast_ratio` of the floor read before the first
capture.  (Copied from the measured package's bench/common.py and
utils/profiling.py, which the benchmark does not import for measuring.)
"""

from __future__ import annotations

import time

import torch


class NodeLatency:
    """Device µs per node of a CUDA graph of `nodes` dependent tiny kernels
    (an in-place add on `size` floats), by CUDA events around one
    replay."""

    def __init__(self, device, nodes: int = 1000, size: int = 4096):
        self.nodes = nodes
        self.x = torch.zeros(size, device=device)
        side = torch.cuda.Stream(self.x.device)
        side.wait_stream(torch.cuda.current_stream(self.x.device))
        with torch.cuda.stream(side):
            self.x.add_(1.0)
        torch.cuda.current_stream(self.x.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(nodes):
                self.x.add_(1.0)

    def __call__(self) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / self.nodes


class CardState:
    """The µs per graph node and its floor, the lowest reading so far, the
    first `reads` of them taken at construction (before the cell's
    captures)."""

    def __init__(self, device, fast_ratio: float, reads: int = 20):
        self.node = NodeLatency(device)
        self.fast_ratio = fast_ratio
        self.floor = min(self.node() for _ in range(reads))

    def read(self) -> float:
        reading = self.node()
        self.floor = min(self.floor, reading)
        return reading

    def fast(self, reading: float) -> bool:
        return reading <= self.fast_ratio * self.floor


def warm_up(unit, state, min_s: float, max_s: float,
            settled_reads: int) -> dict:
    """Run `unit()` (one synchronized unit of the cell's work) back to back
    for at least `min_s` seconds, and with a `CardState` until its last
    `settled_reads` readings are fast, or `max_s` seconds have passed.
    Returns what it saw."""
    nodes, calls = [], 0
    start = time.perf_counter()
    while True:
        unit()
        calls += 1
        elapsed = time.perf_counter() - start
        if state is not None:
            nodes.append(state.read())
        settled = state is None or (
            len(nodes) >= settled_reads
            and all(state.fast(n) for n in nodes[-settled_reads:]))
        if elapsed >= max_s or (elapsed >= min_s and settled):
            break
    return {'seconds': elapsed, 'calls': calls, 'settled': settled,
            'node_us': nodes[-settled_reads:],
            'floor_us': state.floor if state is not None else None}


def graph_nodes(fn, inputs, warmup: int):
    """(nodes, kernel nodes) of `fn(*inputs)` captured as a CUDA graph,
    counted with CUDA's cuGraphGetNodes and cuGraphNodeGetType."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn(*inputs)
    cu = ctypes.CDLL('libcuda.so.1')
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        raise RuntimeError('cuGraphGetNodes failed')
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError('cuGraphGetNodes failed')
    kind = ctypes.c_int()
    kernels = 0
    for node in nodes:
        if cu.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            raise RuntimeError('cuGraphNodeGetType failed')
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    del g
    return n.value, kernels
