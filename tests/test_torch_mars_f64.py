"""The Mars learning smoke of tests/test_mars.py in float64: the port's
`train(..., dtype=torch.float64)` against the JAX package's float64 run of
the same smoke, recorded by tests/make_jax_mars_curve.py
(tests/data/jax_lander3dmars_f64_seed3.json).  The card test
`test_mars_ppo_smoke_on_the_card` (tests/test_torch_cuda.py) holds the
card's whole run to the same record; here the CPU holds
its first two evaluations (updates 0 and 20 of the 160-update
schedule)."""

import json
from pathlib import Path

import numpy as np
import torch

from gym_copter_tpu_torch.learn import ppo

RECORD = Path(__file__).resolve().parent / 'data' / \
    'jax_lander3dmars_f64_seed3.json'
# the evaluation runs its envs in float32 whatever the params' dtype (as
# JAX's does): measured 1.1e-7 relative; the train metrics are float64
EVAL_RTOL, METRIC_RTOL, METRIC_ATOL = 1e-6, 1e-9, 1e-12
LAST = 20


class _Enough(Exception):
    pass


def test_port_float64_mars_smoke_follows_jax():
    rec = json.loads(RECORD.read_text())
    got = []

    def callback(i, metrics):
        got.append((i, metrics))
        if i >= LAST:
            raise _Enough

    try:
        ppo.train(rec['env'], num_envs=rec['num_envs'],
                  num_updates=rec['num_updates'], seed=rec['seed'],
                  cfg=ppo.PPOConfig(**rec['ppo']),
                  log_every=rec['log_every'], callback=callback,
                  device='cpu', dtype=torch.float64)
    except _Enough:
        pass
    want = [h for h in rec['history'] if h['update'] <= LAST]
    assert [i for i, _ in got] == [h['update'] for h in want] == [0, 20]
    for (i, m), w in zip(got, want):
        np.testing.assert_allclose(m['eval_return'], w['eval_return'],
                                   rtol=EVAL_RTOL, err_msg=str(i))
        for k in w:
            if k not in ('update', 'eval_return'):
                np.testing.assert_allclose(m[k], w[k], rtol=METRIC_RTOL,
                                           atol=METRIC_ATOL,
                                           err_msg=f'{k} {i}')
