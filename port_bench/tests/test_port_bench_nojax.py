"""Neither the benchmark's set-up path nor its command loads JAX or the
JAX package: checked in fresh processes, by whole top-level module
names."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench.tests.tiny import CELLS, SEED

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = '''
import json, sys
from port_bench import harness
from port_bench.tests.tiny import CELLS, SEED
cell = sys.argv[1]
result = harness.run(cell, SEED, 0.2, False, device='cpu',
                     overrides=CELLS[cell])
print(json.dumps({'correct': result['correct'],
                  'found': harness.forbidden_modules(),
                  'torch_package': 'gym_copter_tpu_torch' in sys.modules}))
'''


def _python(args, **kw):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_a_cell_loads_no_jax(cell):
    proc = _python(['-c', SCRIPT, cell])
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out['correct'] and out['torch_package']
    assert out['found'] == []


def test_forbidden_names_are_whole_top_level_names():
    from port_bench import harness

    names = ['gym_copter_tpu_torch', 'gym_copter_tpu_torch.learn.ppo',
             'gym_copter_tpu.envs', 'jaxlib.xla_client', 'jax', 'jax_free',
             'flaxen', 'flax.linen']
    assert harness.forbidden_modules(names) == [
        'flax.linen', 'gym_copter_tpu.envs', 'jax', 'jaxlib.xla_client']


def test_the_command_refuses_without_a_card():
    proc = _python(['-m', 'port_bench', '--workload', 'lander3d.ppo',
                    '--seed', str(SEED), '--seconds', '1', '--trace', '0'])
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'CUDA' in proc.stderr
