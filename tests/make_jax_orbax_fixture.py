"""Writes the JAX-written orbax checkpoint the port's tests restore, on
the CPU and on the card: tests/data/jax_orbax_lander3d/.

The JAX package on the CPU trains the PPO recipe of tests/test_torch_cuda.py
(Lander3D-v0, 4096 envs, rollout 128, hidden 128, 4 epochs x 16
minibatches, target_kl 0.015, the learning rate annealed over a 600-update
run) for one update from PRNGKey(0), and saves the TrainState with
`gym_copter_tpu.utils.checkpoint.save` (an OCDBT database of zstd-
compressed zarr arrays).  Beside it, tests/data/jax_orbax_lander3d.json
records each leaf's path, dtype, shape and SHA-256, and the metrics of
JAX's next update from the saved state.

    python tests/make_jax_orbax_fixture.py
"""

import hashlib
import json
import os
import shutil
import sys
import time
from pathlib import Path

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from gym_copter_tpu.envs import tasks  # noqa: E402
from gym_copter_tpu.envs.registry import default_params  # noqa: E402
from gym_copter_tpu.learn import ppo  # noqa: E402
from gym_copter_tpu.utils import checkpoint  # noqa: E402

OUT = REPO / 'tests' / 'data' / 'jax_orbax_lander3d'
ENVS = 4096
# tests/test_torch_cuda.py's RECIPE and RECIPE_UPDATES
CFG = dict(rollout_steps=128, hidden=128, epochs=4, learning_rate=3e-4,
           gamma=0.995, entropy_coef=0.01, value_clip=0.0, target_kl=0.015,
           anneal_lr_floor=0.0)
RUN_UPDATES = 600


def recipe():
    """(jitted train step, initial TrainState) of the recipe."""
    spec = tasks.ALL_TASKS['Lander3D-v0']
    cfg = ppo.resolve_minibatches(ppo.PPOConfig(**CFG), ENVS)
    opt = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adam(optax.linear_schedule(
            cfg.learning_rate, 0.0, RUN_UPDATES * cfg.epochs * cfg.minibatches)))
    step, opt = ppo.make_train_step(default_params(), spec, cfg,
                                    jax.random.PRNGKey(1),
                                    jnp.arange(ENVS, dtype=jnp.int32),
                                    optimizer=opt)
    ts = ppo.init_train_state(jax.random.PRNGKey(0), default_params(), spec,
                              cfg, ENVS, opt)
    return jax.jit(step), ts


def leaves(tree):
    """{path: array or None} of a JAX pytree, as orbax names its leaves:
    None for None and for an empty node (optax's EmptyState)."""
    def empty(x):
        return x is None or (isinstance(x, tuple) and not x)

    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=empty)
    return {tuple(str(getattr(k, 'key', getattr(k, 'idx', getattr(
        k, 'name', k)))) for k in p): None if empty(x) else np.asarray(x)
        for p, x in flat}


def main():
    t0 = time.perf_counter()
    step, ts = recipe()
    ts, first = step(ts)
    if OUT.exists():
        shutil.rmtree(OUT)
    checkpoint.save(str(OUT), ts)
    _, metrics = step(ts)
    record = {
        'env': 'Lander3D-v0', 'envs': ENVS, 'config': CFG,
        'run_updates': RUN_UPDATES, 'init_key': 0, 'base_key': 1,
        'updates_before_save': 1,
        'first_update_metrics': {k: float(v) for k, v in first.items()},
        'next_update_metrics': {k: float(v) for k, v in metrics.items()},
        'leaves': [{'path': list(p), 'dtype': None if a is None else a.dtype.str,
                    'shape': None if a is None else list(a.shape),
                    'sha256': None if a is None else hashlib.sha256(
                        np.ascontiguousarray(a).tobytes()).hexdigest()}
                   for p, a in leaves(ts).items()],
        'bytes': sum(f.stat().st_size for f in OUT.rglob('*') if f.is_file()),
        'versions': {'jax': jax.__version__,
                     'orbax': __import__('orbax.checkpoint').checkpoint
                     .__version__},
        'seconds': time.perf_counter() - t0,
    }
    with open(OUT.parent / 'jax_orbax_lander3d.json', 'w') as f:
        json.dump(record, f, indent=1)
        f.write('\n')
    print(json.dumps({k: record[k] for k in ('bytes', 'seconds',
                                              'next_update_metrics')}))


if __name__ == '__main__':
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    main()
