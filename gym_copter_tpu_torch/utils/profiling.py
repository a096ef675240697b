"""Timing and tracing, the counterpart of `gym_copter_tpu/utils/profiling.py`.

* `differential_steps_per_sec` times the same workload at two sizes and
  divides the extra work by the extra time, which cancels the fixed cost of
  a call (launch, host enqueue, synchronization).  Every timed run ends in
  `torch.cuda.synchronize()` where CUDA is in use, so the device work is
  inside the time.  Samples whose marginal time is not positive are
  rejected and drawn again, never clamped; when every attempt is rejected
  it raises.
* `trace` wraps `torch.profiler` (CPU and, where there is a card, CUDA
  activity) and writes a Chrome trace; `device_busy` reads one: the
  device's busy share of the traced window and its kernels by device time.

The clock is a parameter, so that tests can drive the arithmetic with a
fake one.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from typing import Callable


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
