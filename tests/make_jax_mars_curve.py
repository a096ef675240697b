"""Writes the JAX package's float64 run of the Mars learning smoke, which
tests/test_torch_cuda.py's Mars smoke and tests/test_torch_mars_f64.py
hold the port's float64 run to: tests/data/jax_lander3dmars_f64_seed3.json.

The smoke is tests/test_mars.py's (Lander3DMars-v0, 256 envs, 160
updates, seed 3, rollout 64, hidden 32, gamma 0.995, learning rate 1e-3
annealed to 0.05 of itself).  The JAX package's `train` has no dtype, so
this runs its loop (the same keys, optimizer, jitted step and
evaluation every 20 updates and at the last) with the TrainState in
float64, on the CPU, and records the metrics at each evaluation.

    python tests/make_jax_mars_curve.py
"""

import json
import platform
import sys
from pathlib import Path

import jax

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from gym_copter_tpu.envs import tasks  # noqa: E402
from gym_copter_tpu.learn import ppo  # noqa: E402

OUT = REPO / 'tests' / 'data' / 'jax_lander3dmars_f64_seed3.json'
ENV, ENVS, UPDATES, SEED, LOG_EVERY = 'Lander3DMars-v0', 256, 160, 3, 20
PPO = dict(rollout_steps=64, hidden=32, gamma=0.995, learning_rate=1e-3)


def main():
    cfg = ppo.resolve_minibatches(ppo.PPOConfig(**PPO), ENVS)
    spec = tasks.ALL_TASKS[ENV]
    params = tasks.PRESET_PARAMS[ENV]()
    opt = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adam(optax.linear_schedule(
            cfg.learning_rate, cfg.learning_rate * cfg.anneal_lr_floor,
            UPDATES * cfg.epochs * cfg.minibatches)))
    step, opt = ppo.make_train_step(params, spec, cfg,
                                    jax.random.PRNGKey(SEED + 1),
                                    jnp.arange(ENVS, dtype=jnp.int32),
                                    optimizer=opt)
    step = jax.jit(step)
    ts = ppo.init_train_state(jax.random.PRNGKey(SEED), params, spec, cfg,
                              ENVS, opt, dtype=jnp.float64)
    evaluate = ppo.make_eval_fn(params, spec, cfg,
                                num_envs=ppo.EVAL_NUM_ENVS)
    history = []
    for i in range(UPDATES):
        ts, metrics = step(ts)
        if i % LOG_EVERY == 0 or i == UPDATES - 1:
            row = {k: float(v) for k, v in metrics.items()}
            row['eval_return'] = float(evaluate(ts.params)[0])
            history.append({'update': i, **row})
            print(i, row['eval_return'], flush=True)
    evals = [h['eval_return'] for h in history]
    OUT.write_text(json.dumps({
        'env': ENV, 'num_envs': ENVS, 'num_updates': UPDATES, 'seed': SEED,
        'log_every': LOG_EVERY, 'ppo': PPO, 'dtype': 'float64',
        'gain': max(evals) - evals[0],
        'made_by': 'python tests/make_jax_mars_curve.py',
        'jax': jax.__version__, 'platform': 'cpu',
        'machine': platform.machine(), 'history': history}, indent=1) + '\n')
    print('gain', max(evals) - evals[0], '->', OUT)


if __name__ == '__main__':
    main()
