"""The control of each cell and the planted faults, the plain reference
in the program's place driven through the harness at a size a test run
holds: each comes out not correct, and the reference as configured in the
same place comes out correct (the chip's runs at the cells' own sizes are
in PERF.md)."""

import pytest

from port_bench import control
from port_bench.tests.tiny import CELLS, SEED

CASES = [(cell, v) for cell, loop in (('lander3d.ppo', 'train'),
                                      ('hover3d.ppo', 'train'),
                                      ('lander3d.fused', 'fused'),
                                      ('lander3d.single', 'single'))
         for v in control.VARIANTS[loop] + ('reference',)]


def _run(cell, variant):
    overrides = dict(CELLS[cell])
    if cell == 'lander3d.fused':
        overrides['traffic'] = dict(overrides['traffic'],
                                    steps_per_call=200)
    return control.run(cell, SEED, variant, 'cpu', overrides,
                       seconds=0.5 if cell == 'lander3d.single' else 0.0)


@pytest.mark.parametrize('cell,variant', CASES)
def test_control_and_faults_fail_and_the_reference_passes(cell, variant):
    out = _run(cell, variant)
    assert out['correct'] == (variant == 'reference'), out['checks']
