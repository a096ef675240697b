"""The program's own recorder (`gym_copter_tpu_torch/utils/profiling.py`),
read once the loop has returned: the host seconds and nodes per region of
every capture of the program's `core/graph.Graph` (counted at the
program's own captures, in set-up).  Besides program.py, the one module
of the benchmark that imports the measured package.  Each reader returns
None where the program has no recorder or the recorder holds nothing.
"""

from __future__ import annotations


def snapshot():
    """The recorder's snapshot, or None where the program has none."""
    try:
        from gym_copter_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    return snapshot()


def region_nodes(graph: str, regions) -> int:
    """Nodes of `regions` together in the last counted capture of the
    graph named `graph`, or None where a region is missing."""
    snap = snapshot()
    found = [c for c in (snap or {}).get('captures', ())
             if c['graph'] == graph and c['counted']]
    if not found or any(r not in found[-1]['regions'] for r in regions):
        return None
    return sum(found[-1]['regions'][r] for r in regions)


def capture_s() -> float:
    """Host seconds of every `Graph` capture of the process, summed."""
    snap = snapshot()
    seconds = [c['seconds'] for c in (snap or {}).get('captures', ())]
    return sum(seconds) if seconds else None

