"""Timing and tracing, the counterpart of `gym_copter_tpu/utils/profiling.py`.

* `differential_steps_per_sec` times the same workload at two sizes and
  divides the extra work by the extra time, which cancels the fixed cost of
  a call (launch, host enqueue, synchronization).  Every timed run ends in
  `torch.cuda.synchronize()` where CUDA is in use, so the device work is
  inside the time.  Samples whose marginal time is not positive are
  rejected and drawn again, never clamped; when every attempt is rejected
  it raises.
* `timeit` is the JAX scripts' per-call differential timing
  (`scripts/bench_train.py`, `scripts/profile_ppo.py`): seconds per call
  of an op that `fn(n)` runs n times, from the difference between n_hi
  and n_lo calls.
* `card` reads the card's name, power limit, SM clock now and at most,
  power draw, temperature and clock throttle reasons from `nvidia-smi`;
  `card_probe` starts that query and reads it later, so that a sample can
  be taken while timed work runs.
* `NodeLatency` reads the card's device time per node of a CUDA graph of
  tiny kernels, a state of the card that nvidia-smi does not show.
* `trace` wraps `torch.profiler` (CPU and, where there is a card, CUDA
  activity) and writes a Chrome trace; `device_busy` reads one: the
  device's busy share of the traced window and its kernels by device time.
* The recorder, the program's own spans and counters (last section):
  spans of the train step, the B = 1 step, the fused call and graph
  captures on the `perf_counter_ns` clock, on while `spans()` is open or
  `torch.profiler` records and off otherwise; and, always, the host
  seconds and nodes per region of every `core/graph.Graph` capture.
  `snapshot()` reads both back.

The clock is a parameter, so that tests can drive the arithmetic with a
fake one.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import json
import os
import statistics
import subprocess
import time
from typing import Callable

import torch
import torch.autograd.profiler as _torch_profiler


def synchronize() -> None:
    """Wait for every queued CUDA operation, where CUDA is in use."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_host_sync(fn: Callable[[], object], reps: int,
                    clock: Callable[[], float] = time.perf_counter) -> float:
    """Mean seconds per call of `fn` over `reps` calls after one warm-up,
    the device synchronized before the clock is read."""
    fn()
    synchronize()
    t0 = clock()
    for _ in range(reps):
        fn()
    synchronize()
    return (clock() - t0) / reps


def differential_samples(run: Callable[[int], object], t_lo: int, t_hi: int,
                         *, batch: int, reps: int = 5,
                         min_marginal_s: float = 0.0,
                         clock: Callable[[], float] = time.perf_counter
                         ) -> dict:
    """Per-rep marginal throughput samples of `run(num_steps)`: each rep
    times one (t_lo, t_hi) pair, synchronized, and yields batch * (t_hi -
    t_lo) / (d_hi - d_lo).  A rep whose marginal time is at most
    `min_marginal_s` is rejected and drawn again, up to 3 * reps attempts;
    raises if none was kept.  Returns {'samples', 'rejected'}."""
    def timed(n):
        t0 = clock()
        run(n)
        synchronize()
        return clock() - t0

    run(t_lo)
    run(t_hi)
    synchronize()
    samples, rejected = [], 0
    floor = max(min_marginal_s, 1e-9)
    for _ in range(3 * reps):
        if len(samples) >= reps:
            break
        marginal = -timed(t_lo) + timed(t_hi)
        if marginal <= floor:
            rejected += 1
            continue
        samples.append(batch * (t_hi - t_lo) / marginal)
    if not samples:
        raise RuntimeError(f'all {rejected} samples rejected: the marginal '
                           f'work of {t_hi - t_lo} steps took no more than '
                           f'{floor} s; widen t_hi - t_lo')
    return {'samples': samples, 'rejected': rejected}


def robust_stats(samples: list) -> dict:
    """Median and the MAD-based spread (1.4826 * MAD / median, in percent)
    of non-empty throughput samples."""
    if not samples:
        raise ValueError('no samples')
    med = statistics.median(samples)
    mad = statistics.median(abs(s - med) for s in samples)
    spread = (1.4826 * mad / med * 100.0) if med > 0 else float('inf')
    return {'median': med, 'spread_pct': spread, 'n': len(samples)}


def differential_steps_per_sec(run: Callable[[int], object], t_lo: int,
                               t_hi: int, *, batch: int, reps: int = 5,
                               min_marginal_s: float = 0.0,
                               clock: Callable[[], float] = time.perf_counter
                               ) -> dict:
    """Marginal throughput of `run(num_steps)`: {'steps_per_sec' (the
    median sample), 'ns_per_iter', 'samples', 'spread_pct', 'rejected',
    'n_samples'}."""
    res = differential_samples(run, t_lo, t_hi, batch=batch, reps=reps,
                               min_marginal_s=min_marginal_s, clock=clock)
    samples = res['samples']
    stats = robust_stats(samples)
    med = stats['median']
    return {
        'steps_per_sec': med,
        'ns_per_iter': batch / med * 1e9,
        'samples': samples,
        'spread_pct': stats['spread_pct'],
        'rejected': res['rejected'],
        'n_samples': len(samples),
    }


def timeit(fn: Callable[[int], object], reps: int = 8, n_lo: int = 3,
           n_hi: int = 13, *, probe: Callable[[], Callable[[], dict]] = None,
           clock: Callable[[], float] = time.perf_counter) -> dict:
    """Differential seconds per call of the op that `fn(n)` runs n times:
    one warm call fn(2), then `reps` times (t(fn(n_hi)) - t(fn(n_lo))) /
    (n_hi - n_lo), each run synchronized.  With `probe` (`card_probe`), a
    query is started before each rep and read after it.  Returns
    {'seconds' (the median), 'samples', 'spread_pct', 'beside' (one probe
    result per rep, or None)}."""
    def timed(n):
        t0 = clock()
        fn(n)
        synchronize()
        return clock() - t0

    fn(2)
    synchronize()
    samples, beside = [], []
    for _ in range(reps):
        read = probe() if probe is not None else None
        lo = timed(n_lo)
        samples.append((timed(n_hi) - lo) / (n_hi - n_lo))
        beside.append(read() if read is not None else None)
    stats = robust_stats(samples)
    return {'seconds': stats['median'], 'samples': samples,
            'spread_pct': stats['spread_pct'],
            'beside': beside if probe is not None else None}


class NodeLatency:
    """Device µs per node of a CUDA graph of `nodes` dependent tiny kernels
    (an in-place add on `size` floats), by CUDA events around one replay:
    the launch-latency floor per graph node that sets the port's graphed
    times (PERF.md), read beside a measurement as the SM clock is.  On the
    card only; capturing it allocates `size` floats."""

    def __init__(self, device='cuda', nodes: int = 1000, size: int = 4096):
        import torch

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
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / self.nodes


# nvidia-smi's fields read by `card`; the throttle reasons field took a new
# name in later drivers, which keep the old one as an alias
CARD_FIELDS = ('name', 'power.limit', 'clocks.sm', 'clocks.max.sm',
               'power.draw', 'temperature.gpu')
THROTTLE_FIELDS = ('clocks_throttle_reasons.active',
                   'clocks_event_reasons.active')
# the bits of the throttle reasons mask (NVML's nvmlClocksThrottleReason*)
THROTTLE_BITS = ((0x1, 'gpu_idle'), (0x2, 'applications_clocks_setting'),
                 (0x4, 'sw_power_cap'), (0x8, 'hw_slowdown'),
                 (0x10, 'sync_boost'), (0x20, 'sw_thermal_slowdown'),
                 (0x40, 'hw_thermal_slowdown'),
                 (0x80, 'hw_power_brake_slowdown'),
                 (0x100, 'display_clock_setting'))


def _number(field: str):
    """'700.00 W' -> 700.0, '1980 MHz' -> 1980.0; None where nvidia-smi
    has no value ('[N/A]', '[Not Supported]')."""
    try:
        return float(field.split()[0])
    except (ValueError, IndexError):
        return None


def parse_card(line: str) -> dict:
    """One line of `nvidia-smi --query-gpu=<CARD_FIELDS>,<throttle field>
    --format=csv,noheader` as a dict.  'smi' is the card's name and power
    limit exactly as `--query-gpu=name,power.limit` prints them."""
    fields = [f.strip() for f in line.split(', ')]
    if len(fields) != len(CARD_FIELDS) + 1:
        raise ValueError(f'nvidia-smi printed {line!r}')
    name, limit, sm, max_sm, draw, temp, reasons = fields
    try:
        mask = int(reasons, 16)
    except ValueError:
        mask = None
    return {'smi': f'{name}, {limit}', 'name': name,
            'power_limit_w': _number(limit), 'sm_mhz': _number(sm),
            'max_sm_mhz': _number(max_sm), 'power_draw_w': _number(draw),
            'temperature_c': _number(temp), 'throttle_reasons': reasons,
            'throttle': ([n for bit, n in THROTTLE_BITS if mask & bit]
                         if mask is not None else None)}


def _card_query(index: int, throttle_field: str) -> list:
    return ['nvidia-smi', f'--id={index}',
            '--query-gpu=' + ','.join(CARD_FIELDS + (throttle_field,)),
            '--format=csv,noheader']


def card_probe(index: int = 0,
               timeout_s: float = 60.0) -> Callable[[], dict]:
    """Start the `card` query of card `index` in the background; returns a
    function that waits for it and returns `card`'s dict.  Raises where
    nvidia-smi is missing or fails."""
    proc = subprocess.Popen(_card_query(index, THROTTLE_FIELDS[0]),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)

    def read() -> dict:
        out, _ = proc.communicate(timeout=timeout_s)
        if proc.returncode != 0:
            # an older name refused: ask once with the newer one
            alt = subprocess.run(_card_query(index, THROTTLE_FIELDS[1]),
                                 capture_output=True, text=True,
                                 timeout=timeout_s)
            if alt.returncode != 0:
                raise RuntimeError(f'nvidia-smi failed: {out.strip()} / '
                                   f'{alt.stdout.strip()}')
            out = alt.stdout
        return parse_card(out.strip().splitlines()[0])

    return read


def card(index: int = 0) -> dict:
    """The card's name and power limit ('smi', as `nvidia-smi
    --query-gpu=name,power.limit` prints them), its SM clock now and at
    most in MHz, power draw in W, temperature in C and the active clock
    throttle reasons (the hex mask and their names), from nvidia-smi."""
    return card_probe(index)()


TRACE_FILE = 'trace.json'


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA
    activity where there is a card) and write the Chrome trace
    `log_dir/trace.json`; yields the profiler.

        with profiling.trace('out/trace'):
            run_workload()
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    synchronize()
    with profile(activities=activities) as prof:
        yield prof
        synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# Chrome-trace categories of device work
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


def device_busy(trace_path: str, top: int = 10) -> dict:
    """The device's share of a Chrome trace written by `trace`: the union of
    its kernel, copy and fill intervals over the window from the first to
    the last event of host or device.  Returns {'window_us', 'busy_us',
    'busy_share', 'kernels', 'top'} with `top` [name, total µs, count] by
    device time; raises if the trace holds no kernel."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X' and 'dur' in e]
    device = sorted((float(e['ts']), float(e['ts']) + float(e['dur']))
                    for e in events if e.get('cat') in DEVICE_CATEGORIES)
    kernels = [e for e in events if e.get('cat') == 'kernel']
    if not kernels:
        raise ValueError(f'{trace_path}: the trace holds no device kernel')
    busy, end = 0.0, -float('inf')
    for lo, hi in device:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    window = (max(float(e['ts']) + float(e['dur']) for e in events)
              - min(float(e['ts']) for e in events))
    by_name = {}
    for e in kernels:
        total, count = by_name.get(e['name'], (0.0, 0))
        by_name[e['name']] = (total + float(e['dur']), count + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {'window_us': window, 'busy_us': busy,
            'busy_share': busy / window, 'kernels': len(kernels),
            'top': [[name, t, n] for name, (t, n) in ranked]}


# -- the recorder: the program's spans and counters -------------------------
#
# Off by default.  Off, a span site costs one check of the flags in
# `recording()` per phase, call or step, and nothing else: no CUDA event,
# no synchronize, no `record_function`, nothing added to a capture.  The
# counters of `Graph` captures are always on; they read the capture's own
# graph through libcuda and add no capture, node or synchronize.

SPAN_BUFFER = 1 << 16     # finished spans kept; the oldest go first
CAPTURE_BUFFER = 1 << 12  # Graph captures kept

_depth = 0                # open `spans()` blocks
_ids = itertools.count(1)
_open = []                # the open spans, innermost last
_finished = collections.deque(maxlen=SPAN_BUFFER)
_captures = collections.deque(maxlen=CAPTURE_BUFFER)
_counting = None          # the Capture of the Graph being captured, if any
_anchor = None            # the Anchor of the recorder's device events
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether the recorder is on: inside `spans()`, or while
    `torch.profiler` records (the profiler's own module flag)."""
    return _depth > 0 or _torch_profiler._is_profiler_enabled


@contextlib.contextmanager
def spans():
    """The recorder on for the block; `snapshot()` reads what it kept.

        with profiling.spans():
            ts, metrics = step(ts)
        print(profiling.snapshot()['spans'])
    """
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


class Span:
    """A named stretch of the host's work on the `perf_counter_ns` clock,
    opened and closed by `with`: its parent is the span open around it,
    its `unit` the id of its outermost span (one per train step, B = 1
    step or fused call), its `label` an optional detail (a captured
    graph's name), and `device(start, end)` gives it a device interval
    between two of `event()`'s CUDA events.  While `torch.profiler`
    records, it opens a `record_function` of its name, so that it sits on
    the device trace's clock.  Made only on the recorder's path: `span`
    checks that the recorder is on."""

    __slots__ = ('name', 'label', 'id', 'parent', 'unit', 'start_ns',
                 'end_ns', 'events', '_rf')

    def __init__(self, name: str, label: str = None):
        self.name, self.label = name, label
        self.events = None
        self._rf = None

    def __enter__(self) -> 'Span':
        parent = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.unit = parent.unit if parent is not None else self.id
        if _torch_profiler._is_profiler_enabled:
            self._rf = _torch_profiler.record_function(self.name)
            self._rf.__enter__()
        _open.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        _open.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _finished.append(self)
        return False

    def device(self, start, end) -> None:
        self.events = (start, end)


def span(name: str, label: str = None, on: bool = None):
    """A `Span` where the recorder is on, else a context that does
    nothing.  `on`: `recording()` as the caller read it once for a step
    or call of several spans."""
    if on is None:
        on = recording()
    return Span(name, label) if on else _OFF


class Anchor:
    """The device clock placed on the host's: a CUDA event recorded right
    after a synchronize, beside the `perf_counter_ns` read just after it.
    A later event happened at `host_ns(event)` on the host clock."""

    def __init__(self, event, at_ns: int):
        self.event, self.at_ns = event, at_ns

    @classmethod
    def take(cls, clock: Callable[[], int] = time.perf_counter_ns,
             make_event: Callable = None,
             synchronize: Callable[[], None] = None) -> 'Anchor':
        (synchronize or torch.cuda.synchronize)()
        event = (make_event or _timing_event)()
        event.record()
        return cls(event, clock())

    def host_ns(self, event) -> int:
        return self.at_ns + round(self.event.elapsed_time(event) * 1e6)


def _timing_event():
    return torch.cuda.Event(enable_timing=True)


def event(anchored: bool = True):
    """A CUDA timing event recorded now on the current stream, for a span's
    device interval.  The recorder's first anchored one takes the anchor
    first, which synchronizes."""
    global _anchor
    if anchored and _anchor is None:
        _anchor = Anchor.take()
    e = _timing_event()
    e.record()
    return e


class Phases:
    """Consecutive phases of one unit of work, as a `with` block: each
    `next(name)` records a CUDA event where events are wanted, ends the
    phase before at it and starts `name` at it (None starts none).
    `marks`, a list or None, receives every event in order.  While the
    recorder is on, the unit and its phases are spans, timed on the card
    (`events`) by those events; off and without `marks`, it does
    nothing."""

    def __init__(self, name: str, marks=None, events: bool = False):
        self.on = recording()
        self.marks = marks
        self.timed = marks is not None or (self.on and events)
        self.root = Span(name) if self.on else None
        self.phase = self.start = None

    def __enter__(self) -> 'Phases':
        if self.root is not None:
            self.root.__enter__()
        return self

    def next(self, name: str = None) -> None:
        e = event(anchored=self.on) if self.timed else None
        if self.marks is not None:
            self.marks.append(e)
        if self.phase is not None:
            if e is not None:
                self.phase.device(self.start, e)
            self.phase.__exit__(None, None, None)
            self.phase = None
        if self.on and name is not None:
            self.phase = Span(name).__enter__()
        self.start = e

    def __exit__(self, *exc) -> bool:
        for s in (self.phase, self.root):
            if s is not None:
                s.__exit__(*exc)
        self.phase = self.root = None
        return False


class _LibCuda:
    """The two `libcuda` calls that count a capture's nodes, over
    ctypes."""

    def __init__(self):
        cu = ctypes.CDLL('libcuda.so.1')
        self.info = cu.cuStreamGetCaptureInfo_v2
        ptr = ctypes.POINTER(ctypes.c_void_p)
        # stream, status, capture id, graph, dependencies, number of
        # dependencies
        self.info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_ulonglong), ptr, ptr,
                              ctypes.POINTER(ctypes.c_size_t)]
        self.info.restype = ctypes.c_int
        self.nodes = cu.cuGraphGetNodes
        self.nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_size_t)]
        self.nodes.restype = ctypes.c_int


_libcuda = None


def capture_nodes():
    """Nodes so far of the graph that the current CUDA stream captures
    into (`cuStreamGetCaptureInfo`, then `cuGraphGetNodes`, which CUDA
    permits during a capture), or None where the stream is not capturing
    or libcuda will not say."""
    global _libcuda
    if _libcuda is None:
        try:
            _libcuda = _LibCuda()
        except (OSError, AttributeError):
            _libcuda = False
    if not _libcuda:
        return None
    status, ident = ctypes.c_int(), ctypes.c_ulonglong()
    graph, deps = ctypes.c_void_p(), ctypes.c_void_p()
    ndeps = ctypes.c_size_t()
    if _libcuda.info(torch.cuda.current_stream().cuda_stream,
                     ctypes.byref(status), ctypes.byref(ident),
                     ctypes.byref(graph), ctypes.byref(deps),
                     ctypes.byref(ndeps)) != 0 \
            or status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        return None
    n = ctypes.c_size_t()
    if _libcuda.nodes(graph, None, ctypes.byref(n)) != 0:
        return None
    return n.value


class Capture:
    """What the recorder keeps of one `core/graph.Graph` capture: the
    graph's name, the host seconds of `Graph._capture`, the captured
    graph's nodes, and the nodes added inside each region (`region`),
    summed over the region's occurrences.  `counted` is False where the
    capture's nodes could not be read."""

    __slots__ = ('graph', 'seconds', 'nodes', 'regions', 'counted',
                 '_region', '_at', '_count')

    def __init__(self, graph: str, count: Callable[[], int] = None):
        self.graph, self.seconds, self.nodes = graph, None, None
        self.regions, self.counted = {}, True
        self._region = self._at = None
        self._count = count

    def boundary(self, name) -> None:
        n = (self._count or capture_nodes)()
        if n is None:
            self.counted = False
            return
        if self._region is not None:
            self.regions[self._region] = (self.regions.get(self._region, 0)
                                          + n - self._at)
        self._region, self._at = name, n

    def end(self) -> None:
        self.boundary(None)
        self.nodes = self._at if self.counted else None


@contextlib.contextmanager
def counting(graph: str, count: Callable[[], int] = None):
    """Count, inside `torch.cuda.graph(...)`, the nodes that the block
    adds to the graph being captured, per region: yields the `Capture`,
    which holds the graph's nodes once the block has returned.  `count`
    stands in for `capture_nodes` in tests."""
    global _counting
    rec = Capture(graph, count)
    _counting = rec
    try:
        rec.boundary(None)
        yield rec
        rec.end()
    finally:
        _counting = None


def captured(rec: Capture, seconds: float) -> None:
    """Keep a finished capture with its host seconds."""
    rec.seconds = seconds
    _captures.append(rec)


def region(name) -> None:
    """A boundary between regions of a function that `core/graph.Graph`
    captures: the nodes added from here to the next boundary count to
    `name` (None: to no region).  Outside such a capture it does nothing
    but check a module-level flag; captures made elsewhere are not
    counted."""
    if _counting is not None:
        _counting.boundary(name)


def snapshot() -> dict:
    """What the recorder holds: {'spans': [...], 'captures': [...]}.  A
    span is {'id', 'parent', 'unit', 'name', 'label', 'start_ns',
    'end_ns'}, and where it has a device interval 'device_start_ns' and
    'device_end_ns' on the host clock (through the anchor) and
    'device_ns'; it waits for those events.  A capture is {'graph',
    'seconds', 'nodes', 'regions', 'counted'}."""
    out = []
    for s in list(_finished):
        d = {'id': s.id, 'parent': s.parent, 'unit': s.unit,
             'name': s.name, 'label': s.label, 'start_ns': s.start_ns,
             'end_ns': s.end_ns}
        if s.events is not None:
            start, end = s.events
            end.synchronize()
            d['device_start_ns'] = _anchor.host_ns(start)
            d['device_end_ns'] = _anchor.host_ns(end)
            d['device_ns'] = round(start.elapsed_time(end) * 1e6)
        out.append(d)
    return {'spans': out,
            'captures': [{'graph': c.graph, 'seconds': c.seconds,
                          'nodes': c.nodes, 'regions': dict(c.regions),
                          'counted': c.counted} for c in _captures]}


def clear() -> None:
    """Forget every span and capture kept so far."""
    _finished.clear()
    _captures.clear()
