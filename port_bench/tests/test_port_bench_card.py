"""On the card: one short run of each cell through the command, its last
line the contract's result with `correct` true, and the control failing
at the cell's own size.  Skips where there is no CUDA device:

    python3 -m pytest -q -m cuda port_bench/tests/test_port_bench_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench.harness import Manifest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w['name'] for w in Manifest().data['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_a_short_run_is_correct(cell, card):
    proc = subprocess.run(
        [sys.executable, '-m', 'port_bench', '--workload', cell, '--seed',
         '4000000007', '--seconds', '2', '--trace', '0'], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['correct'], result['checks']
    assert result['device']['platform'] == 'gpu'
    assert set(result['metrics']) == {
        m['name'] for m in Manifest().end_to_end(cell)}


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_the_control_fails_at_the_cells_size(cell, card):
    from port_bench import control

    loop = Manifest().traffic(Manifest().cell(cell)['traffic'])['loop']
    for variant in control.VARIANTS[loop]:
        out = control.run(cell, 4000000009, variant)
        assert not out['correct'], (variant, out['checks'])
