"""One run of one cell of the benchmark:

    python3 -m port_bench --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

It finds the cell, its configuration and its traffic mix by name in
BENCHMARK.json, hands the traffic's loop (port_bench/loops/<loop>.py)
the run, and prints as the last line of standard output one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones, each read by port_bench/metrics/
<name>.py), `device`, with --trace 1 `breakdown`, and last `checks`, each
number that decided `correct` beside its limit.  The same numbers are the
last lines of standard error.

It exits non-zero and prints no result where there is no CUDA device or
fewer than the cell needs, and where the process has loaded JAX or the
JAX package once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MANIFEST = ROOT.parent / 'BENCHMARK.json'
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'gym_copter_tpu')


def process_start() -> float:
    """The process's start on the `time.time()` clock, from /proc (the
    kernel's start time in clock ticks since boot); the import of this
    module where /proc is missing."""
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        ticks = os.sysconf('SC_CLK_TCK')
        return time.time() - uptime + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


class Manifest:
    """BENCHMARK.json, and the files it names found by name: a
    configuration's file, a traffic mix's `traffic/<name>.json`, a
    per-layer metric's reader `metrics/<name>.py`."""

    def __init__(self, path: Path = MANIFEST):
        with open(path) as f:
            self.data = json.load(f)
        self.root = path.parent

    def cell(self, name: str) -> dict:
        for w in self.data['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f'no workload {name!r} in {MANIFEST.name}; '
                       f'cells: {[w["name"] for w in self.data["workloads"]]}')

    def config(self, name: str) -> dict:
        for c in self.data['configs']:
            if c['name'] == name:
                with open(self.root / c['file']) as f:
                    return json.load(f)
        raise KeyError(f'no configuration {name!r}')

    @staticmethod
    def traffic(name: str) -> dict:
        with open(ROOT / 'traffic' / f'{name}.json') as f:
            return json.load(f)

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.data['end_to_end']
                if cell in m.get('workloads', [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics the cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m['name'] for m in self.end_to_end(cell)}
        return [m for m in self.data['per_layer']
                if cell in m.get('workloads', ()) or (
                    'workloads' not in m and m['moves'] in e2e)]

    @staticmethod
    def reader(name: str):
        path = ROOT / 'metrics' / f'{name}.py'
        spec = importlib.util.spec_from_file_location(
            f'port_bench_metric_{name.replace(".", "_")}', path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


class Run:
    """What a loop is handed: the cell's configuration and traffic, the
    run's arguments, the device, the marks of set-up's end and of the
    memory peak, and `substitute`: None, or what the loop runs in the
    program's place (each loop says what it takes)."""

    def __init__(self, workload: str, config: dict, traffic: dict,
                 seed: int, seconds: float, trace: bool, device, started,
                 substitute=None):
        self.workload, self.config, self.traffic = workload, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.started = started
        self.substitute = substitute
        self.setup_s = None
        self.memory_peak_bytes = 0

    def window_opens(self) -> float:
        """Set-up ends here: returns the window's start (perf_counter).
        Python's garbage collector is off until `window_closes`."""
        gc.collect()
        gc.disable()
        self.setup_s = time.time() - self.started
        return time.perf_counter()

    @staticmethod
    def window_closes() -> None:
        gc.enable()

    def read_peak(self) -> None:
        """The device memory peak of the process so far (before the
        reference runs: a process's peak never falls)."""
        import torch

        if self.device.type == 'cuda':
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
                self.device))

    def limit(self, name: str) -> float:
        return float(self.traffic['limits'][name])


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = 'cuda', overrides: dict = None,
        manifest: Manifest = None, started: float = None,
        substitute=None) -> dict:
    """One run of the cell: the result object (without the checks'
    printing).  `overrides` ({'config': {...}, 'traffic': {...}}, merged
    one level deep) shrink a cell for the tests on the CPU; `substitute`
    runs in the program's place (port_bench/control.py)."""
    import torch

    manifest = manifest or Manifest()
    cell = manifest.cell(workload)
    config = manifest.config(cell['config'])
    traffic = manifest.traffic(cell['traffic'])
    for part, values in (overrides or {}).items():
        target = config if part == 'config' else traffic
        for k, v in values.items():
            if isinstance(v, dict) and isinstance(target.get(k), dict):
                target[k] = {**target[k], **v}
            else:
                target[k] = v
    ctx = Run(workload, config, traffic, seed, seconds, trace,
              torch.device(device),
              started if started is not None else process_start(),
              substitute)
    loop = importlib.import_module(f'port_bench.loops.{traffic["loop"]}')
    out = loop.run(ctx)

    checks = {name: {'value': value, 'limit': limit}
              for name, value, limit in out['checks']}
    correct = all(c['value'] == c['value'] and c['value'] <= c['limit']
                  for c in checks.values())
    if trace:
        wanted = manifest.per_layer(workload)
        metrics = {}
        for m in wanted:
            value = manifest.reader(m['name'])(out['layers'])
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        e2e = dict(out['end_to_end'], setup_s=ctx.setup_s)
        metrics = {m['name']: {'value': e2e[m['name']], 'unit': m['unit']}
                   for m in manifest.end_to_end(workload)}
    dev = {'platform': 'gpu' if ctx.device.type == 'cuda' else 'cpu',
           'kind': (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == 'cuda' else 'cpu'),
           'count': cell['chips'],
           'memory_peak_bytes': ctx.memory_peak_bytes}
    result = {'correct': correct, 'attempted': out['attempted'],
              'failed': out['failed'], 'metrics': metrics, 'device': dev}
    profile = out['layers'].get('profile')
    if trace and profile is not None:
        dev['busy_s'] = profile['busy_s']
        dev['window_s'] = profile['window_s']
        result['breakdown'] = {'device_ops': profile['device_ops'],
                               'idle_gaps': profile['idle_gaps']}
    result['checks'] = checks
    warm = out['layers'].get('warm_up')
    if warm is not None:
        print(f'port_bench: set-up {ctx.setup_s:.3f} s, of it the warm-up '
              f'{warm["seconds"]:.3f} s over {warm["calls"]} units, settled '
              f'{warm["settled"]}, node µs {warm["node_us"]} against the '
              f'floor {warm["floor_us"]}', file=sys.stderr)
    print(f'port_bench: the reference and the comparison took '
          f'{out["layers"]["check_s"]:.3f} s', file=sys.stderr)
    if 'resets_per_env_step' in out['layers']:
        print(f'port_bench: resets per env-step in the window '
              f'{out["layers"]["resets_per_env_step"]!r}', file=sys.stderr)
    if 'still_leaves' in out['layers']:
        print(f'port_bench: leaves left out of the change as still: '
              f'{out["layers"]["still_leaves"]}', file=sys.stderr)
    return result


def forbidden_modules(names=None) -> list:
    """Of `names` (default: the modules loaded in this process), those
    whose top-level name is JAX's, its libraries' or the JAX package's."""
    return sorted(m for m in (sys.modules if names is None else names)
                  if m.split('.', 1)[0] in FORBIDDEN_MODULES)


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    manifest = Manifest()
    chips = manifest.cell(args.workload)['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'port_bench: {args.workload} needs {chips} CUDA device(s); '
              f'torch sees {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    result = run(args.workload, args.seed % (1 << 64), args.seconds,
                 bool(args.trace), manifest=manifest, started=started)
    found = forbidden_modules()
    if found:
        print(f'port_bench: the process loaded {found}', file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
