"""Importing the port's user-facing modules loads neither JAX nor the JAX
package (the port's no-JAX rule; the GPU machine has no JAX), nor orbax,
tensorstore or zstandard (the port reads and writes orbax checkpoints with
its own utils/zstd.py, utils/ocdbt.py and utils/orbax_format.py)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    'gym_copter_tpu_torch.compat.gym_adapter',
    'gym_copter_tpu_torch.compat.single',
    'gym_copter_tpu_torch.compat.numpy_oracle',
    'gym_copter_tpu_torch.sensors.vision',
    'gym_copter_tpu_torch.envs.visual',
    'gym_copter_tpu_torch.render.csvlog',
    'gym_copter_tpu_torch.render.hud',
    'gym_copter_tpu_torch.render.threed',
    'gym_copter_tpu_torch.render.twod',
    'gym_copter_tpu_torch.demos.lander',
    'gym_copter_tpu_torch.demos.hover',
    'gym_copter_tpu_torch.demos.target',
    'gym_copter_tpu_torch.demos.adaptive',
    'gym_copter_tpu_torch.examples.althold',
    'gym_copter_tpu_torch.examples.leap',
    'gym_copter_tpu_torch.examples.pidctrl',
    'gym_copter_tpu_torch.examples.simple_lander3d',
    'gym_copter_tpu_torch.examples.takeoff',
    'gym_copter_tpu_torch.examples.velhold',
    'gym_copter_tpu_torch.examples.vsa_hover1d',
    'gym_copter_tpu_torch.learn.td3',
    'gym_copter_tpu_torch.learn.train_hover3d',
    'gym_copter_tpu_torch.learn.ppo',
    'gym_copter_tpu_torch.parallel.launch',
    'gym_copter_tpu_torch.bench',
    'gym_copter_tpu_torch.bench.__main__',
    'gym_copter_tpu_torch.bench.common',
    'gym_copter_tpu_torch.bench.headline',
    'gym_copter_tpu_torch.bench.batch_sweep',
    'gym_copter_tpu_torch.bench.train',
    'gym_copter_tpu_torch.bench.profile_ppo',
    'gym_copter_tpu_torch.bench.vision',
    'gym_copter_tpu_torch.bench.scaling',
    'gym_copter_tpu_torch.utils.zstd',
    'gym_copter_tpu_torch.utils.ocdbt',
    'gym_copter_tpu_torch.utils.orbax_format',
    'gym_copter_tpu_torch.utils.checkpoint',
]
# what the GPU machine lacks, besides JAX: the libraries the JAX package
# writes orbax checkpoints with
LIBRARIES = ('orbax', 'tensorstore', 'zstandard')


def test_imports_load_no_jax():
    code = ('import importlib, sys\n'
            f'for m in {MODULES!r}:\n'
            '    importlib.import_module(m)\n'
            f'libs = {LIBRARIES!r}\n'
            'bad = sorted(m for m in sys.modules if m == "jax"\n'
            '             or m.startswith(("jax.", "gym_copter_tpu."))\n'
            '             or m == "gym_copter_tpu"\n'
            '             or m.split(".")[0] in libs)\n'
            'print(bad)\n')
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    r = subprocess.run([sys.executable, '-c', code], env=env,
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == '[]', r.stdout
