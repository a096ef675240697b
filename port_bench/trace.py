"""The device's side of a traced run: `torch.profiler` over a short steady
part of the traced window, read back from its Chrome trace.

`profile(fn)` runs `fn()` under the profiler (CPU and CUDA activity),
writes the trace into a temporary directory under TMPDIR, reads it and
deletes it.  The reading (`summarize`, the arithmetic of the measured
package's `utils/profiling.device_busy`) gives the seconds in which some
operation ran on the device (the union of its kernel, copy and fill
intervals), the length of the traced window, each device operation's
total seconds, and the idle gaps between device operations named by what
the host was doing then (the innermost host event over the gap's middle).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATEGORIES = ('cpu_op', 'cuda_runtime', 'cuda_driver', 'user_annotation')
TOP = 10


def profile(fn) -> dict:
    """`summarize` of the Chrome trace of `fn()` run under the profiler,
    the device synchronized before and after."""
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix='port_bench_trace_') as d:
        path = os.path.join(d, 'trace.json')
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            events = json.load(f)['traceEvents']
    return summarize(events)


def _union(intervals):
    """Sorted (lo, hi) pairs -> the merged, disjoint intervals."""
    merged = []
    for lo, hi in intervals:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def summarize(events) -> dict:
    """{'busy_s', 'window_s', 'device_ops' [[name, s]], 'idle_gaps'
    [[name, s]], 'kernel_s'} of Chrome trace events (times in
    µs).  The window runs from the first traced event's start, of host or
    device, to the last one's end; None where the trace holds no device
    operation."""
    spans = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    device = sorted(((float(e['ts']), float(e['ts']) + float(e['dur']), e)
                     for e in spans if e.get('cat') in DEVICE_CATEGORIES),
                    key=lambda d: d[:2])
    if not device:
        return None
    merged = _union([(lo, hi) for lo, hi, _ in device])
    busy = sum(hi - lo for lo, hi in merged)
    first = min(float(e['ts']) for e in spans)
    last = max(float(e['ts']) + float(e['dur']) for e in spans)
    window = last - first

    by_name = {}
    for lo, hi, e in device:
        by_name[e['name']] = by_name.get(e['name'], 0.0) + (hi - lo)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    host = sorted((float(e['ts']), float(e['ts']) + float(e['dur']),
                   e['name']) for e in spans
                  if e.get('cat') in HOST_CATEGORIES)
    starts = [h[0] for h in host]
    gaps = {}
    bounds = [[first, first]] + merged + [[last, last]]
    for (_, a), (b, _) in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        # the innermost host event over the gap's middle: the shortest one
        # of those that start before it and end after it
        i = bisect.bisect_right(starts, mid)
        cover = [h for h in host[max(0, i - 2000):i] if h[1] >= mid]
        name = (min(cover, key=lambda h: h[1] - h[0])[2] if cover
                else 'host outside any traced operation')
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {'busy_s': busy * 1e-6, 'window_s': window * 1e-6,
            'device_ops': [[n, t * 1e-6] for n, t in device_ops],
            'idle_gaps': [[n, t * 1e-6] for n, t in idle_gaps],
            'kernel_s': {n: t * 1e-6 for n, t in by_name.items()}}
