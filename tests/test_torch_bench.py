"""The port's measurement entry points (gym_copter_tpu_torch/bench/) on the
CPU at small sizes: their records have the JAX scripts' keys plus the
card, their numbers are finite, the headline's sanity check and regression
gate work, no bench falls back to the CPU when there is no card, and the
pieces that compute something (the headline's workload, the update's
shuffle modes, the analytic FLOPs) agree with the JAX package and scripts.

The timings here are CPU timings of tiny workloads: they check the
arithmetic and the control flow, never a speed."""

import json
import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_copter_tpu.core import vehicles as vj
from gym_copter_tpu.core.types import EnvParams as EnvParamsJ
from gym_copter_tpu.envs import base as base_j
from gym_copter_tpu.envs import tasks as tasks_j
from gym_copter_tpu.ops import pallas_rollout as pr_j

from gym_copter_tpu_torch.bench import (batch_sweep, common, headline,
                                        profile_ppo, scaling, train, vision)
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.learn import optim, ppo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')
BENCH_PY_KEYS = ('metric', 'value', 'unit', 'vs_baseline', 'spread_pct',
                 'rejected_samples')
# the headline at CPU scale: 128 envs, windows (20, 220), sanity 300 steps
SMALL = dict(batch=128, t_lo=20, t_hi=220, reps=4, device='cpu',
             sanity_steps=300, min_marginal_s=0.0, warmup_s=0.0)


@pytest.fixture(autouse=True)
def one_thread():
    """Several test workers each running torch's default thread count slow
    each other down; one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _finite(x, path='record'):
    """Every number in a nested record is finite (None and strings
    allowed where the record says so)."""
    if isinstance(x, dict):
        for k, v in x.items():
            _finite(v, f'{path}.{k}')
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _finite(v, f'{path}[{i}]')
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        assert math.isfinite(x), path


def test_headline_line_and_history(tmp_path):
    """bench.py's keys plus the card; the sanity check passed and recorded
    in the new history entry; no vs_last_pct without a prior run."""
    hist = tmp_path / 'history.json'
    out = headline.run(history=hist, **SMALL)
    assert set(BENCH_PY_KEYS) <= set(out) and 'card' in out
    assert 'vs_last_pct' not in out
    assert out['metric'] == 'lander3d_env_steps_per_sec_128envs_1chip'
    assert out['unit'] == 'env-steps/s' and out['value'] > 0
    assert out['vs_baseline'] == round(out['value'] / 1e7, 3)
    assert out['card']['before']['name'] == 'cpu'
    json.loads(json.dumps(out))
    runs = json.loads(hist.read_text())['runs']
    assert len(runs) == 1
    assert runs[0]['sanity']['passed'] and runs[0]['card_name'] == 'cpu'
    assert runs[0]['methodology'] == headline.methodology(20, 220, 0.0, 0.0)
    _finite(out)


def test_headline_regression_gate_warns(tmp_path, monkeypatch, capsys):
    """A prior entry 50 % faster with the same methodology and card makes
    the run warn on stderr and report a negative vs_last_pct; entries of
    another methodology or card are not compared."""
    def fixed(run, t_lo, t_hi, *, batch, reps, min_marginal_s):
        run(t_lo)
        return {'steps_per_sec': 1000.0, 'spread_pct': 1.0, 'rejected': 0,
                'samples': [1000.0] * reps}

    monkeypatch.setattr(headline.profiling, 'differential_steps_per_sec',
                        fixed)
    tag = headline.methodology(20, 220, 0.0, 0.0)
    hist = tmp_path / 'history.json'
    others = [{'value': 9e9, 'methodology': 'other', 'card_name': 'cpu'},
              {'value': 9e9, 'methodology': tag, 'card_name': 'other card'}]
    hist.write_text(json.dumps({'note': '', 'runs': others}))
    assert 'vs_last_pct' not in headline.run(history=hist, **SMALL)
    assert 'WARNING' not in capsys.readouterr().err

    runs = json.loads(hist.read_text())['runs']
    runs.append({'value': 1500.0, 'methodology': tag, 'card_name': 'cpu'})
    hist.write_text(json.dumps({'note': '', 'runs': runs}))
    out = headline.run(history=hist, **SMALL)
    assert out['vs_last_pct'] == pytest.approx(-100 / 3, abs=0.01)
    assert 'WARNING: headline bench regressed' in capsys.readouterr().err
    assert len(json.loads(hist.read_text())['runs']) == 5


def test_headline_without_a_card_fails_and_writes_nothing(tmp_path):
    """`python -m gym_copter_tpu_torch.bench` where there is no card: a
    non-zero exit, no JSON line, the history untouched (no fallback)."""
    if torch.cuda.is_available():
        pytest.skip('this host has a card')
    before = (headline.HISTORY.read_bytes() if headline.HISTORY.exists()
              else None)
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    r = subprocess.run([sys.executable, '-m', 'gym_copter_tpu_torch.bench'],
                       env=env, cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert 'no CUDA device' in r.stderr
    for line in r.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
    after = (headline.HISTORY.read_bytes() if headline.HISTORY.exists()
             else None)
    assert after == before


def test_headline_workload_matches_jax():
    """bench.py's sanity workload at 128 envs x 300 steps: the port's fused
    rollout (its plain version) gives the JAX kernel's episodes per env
    (interpret mode), and the step-by-step path the JAX scan's; so the
    sanity record compares what bench.py compares."""
    steps = 300
    params_j, spec_j = EnvParamsJ(vehicle=vj.DJI_PHANTOM), tasks_j.LANDER_3D
    b = SMALL['batch']
    key_j = jax.random.PRNGKey(0)
    ids_j = jnp.arange(b, dtype=jnp.int32)
    state_j, _ = base_j.reset(key_j, ids_j, jnp.zeros(b, jnp.int32),
                              params_j, spec_j, dtype=jnp.float32)
    action_j = jnp.full((4, b), 1.625e-2, jnp.float32)
    _, fused_j = pr_j.fused_rollout(state_j, action_j, steps, params_j,
                                    spec_j, seed=0, interpret=True)
    _, scan_j = pr_j.scan_rollout(state_j, action_j, key_j, ids_j, steps,
                                  params_j, spec_j)

    params, spec, key, ids, state, action = common.lander_batch(b, CPU)
    np.testing.assert_array_equal(state.dyn.perturb.numpy(),
                                  np.asarray(state_j.dyn.perturb))
    rec = headline.sanity(state, action, key, ids, params, spec, steps)
    assert rec['passed']
    assert rec['fused_episodes'] == pytest.approx(
        float(jnp.mean(fused_j['episodes'])), abs=1e-12)
    assert rec['scan_episodes'] == pytest.approx(
        float(jnp.mean(scan_j['episodes'])), abs=1e-12)


def test_batch_sweep_rows():
    out = batch_sweep.sweep((128, 256), device='cpu',
                            marginal_env_steps=128 * 200, t_lo_floor=20,
                            min_marginal_s=0.0)
    assert [r['num_envs'] for r in out['rows']] == [128, 256]
    for r in out['rows']:
        assert set(r) >= {'num_envs', 'env_steps_per_sec', 'spread_pct',
                          'rejected_samples', 'ns_per_env_step',
                          'lanes_per_env'}
        assert r['env_steps_per_sec'] > 0 and r['lanes_per_env'] is None
        assert r['t_hi'] - r['t_lo'] == 128 * 200 // r['num_envs']
    assert out['card']['name'] == 'cpu'
    _finite(out)


def test_train_bench_keys():
    out = train.measure(16, 8, 16, device='cpu', reps=2, n_lo=1, n_hi=2,
                        warmup=(0.0, 0.0))
    for name in ('ppo_update', 'ppo_update_production',
                 'ppo_update_element_shuffle'):
        assert set(out[name]) >= {'seconds_per_update', 'updates_per_sec',
                                  'env_steps_per_sec'}
    assert out['ppo_update']['shuffle_block'] == 1  # below 4096 envs
    assert out['ppo_update_element_shuffle']['shuffle_block'] == 1
    assert (out['ppo_update']['minibatches'],
            out['ppo_update_production']['minibatches']) == (4, 4)
    assert set(out['exploration_rollout']) >= {
        'seconds_per_rollout', 'env_steps_per_sec', 'us_per_16env_step',
        'warm_up'}
    assert out['ppo_update']['warm_up']['calls'] == 1  # no warm-up
    assert {'block_vs_element_speedup', 'rollout_share_of_update',
            'card'} <= set(out)
    assert 'speedup_vs_r3_baseline' not in out
    _finite(out)


def test_profile_ppo_keys():
    out = profile_ppo.measure(16, 16, 8, device='cpu', reps=2, n_lo=1,
                              n_hi=2, warmup=(0.0, 0.0))
    for k in ('full_step_s', 'rollout_s', 'update_gather_s',
              'update_preshuffle_s', 'update_none_s', 'full_step_bf16_s'):
        assert math.isfinite(out[k]), k
    assert out['mfu']['update_flops_analytic'] == profile_ppo.update_flops(
        10, 16, 4, 16 * 8, 4)
    assert 'H100' in out['mfu']['peak_source']
    if out['accounting']['update_actual_s'] > 1e-4:
        assert {'mfu_fraction_of_h100_bf16_dense_peak',
                'mfu_fraction_of_h100_fp32_peak'} <= set(out['mfu'])
    assert {'rollout_pct', 'update_actual_s', 'update_pct'} <= set(
        out['accounting'])
    _finite(out)


def test_preshuffle_equals_gather_float64():
    """In float64, permuting the data once per epoch and slicing it gives
    the same update as gathering each minibatch by its slice of the same
    permutation; the unshuffled update differs."""
    cfg = ppo.PPOConfig(rollout_steps=8, hidden=16, minibatches=4, epochs=2)
    n = 16 * 8
    leaves = ppo.init_params(prng.PRNGKey(2, CPU), 10, 4, cfg,
                             dtype=torch.float64).leaves()
    flat = profile_ppo.synthetic_flat(10, 4, n, CPU, torch.float64)
    opt = optim.ClipAdam(cfg.max_grad_norm, cfg.learning_rate)
    key = prng.PRNGKey(5, CPU)
    out = {mode: profile_ppo.make_update(mode, cfg, opt)(
        leaves, opt.init(leaves), key, flat)[0]
        for mode in profile_ppo.MODES}
    for a, b in zip(out['gather'], out['preshuffle']):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b)
                   for a, b in zip(out['gather'], out['none']))


@pytest.mark.parametrize('o,h,a,n,epochs', [(10, 128, 4, 4096 * 128, 4),
                                            (10, 16, 4, 128, 4),
                                            (7, 64, 3, 1000, 2)])
def test_update_flops_is_the_jax_formula(o, h, a, n, epochs):
    """The port's analytic FLOPs equal scripts/profile_ppo.py's formula,
    read from the script's own lines."""
    src = open(os.path.join(REPO, 'scripts', 'profile_ppo.py')).read()
    fwd = re.search(r'^\s*fwd_flops = (.+?)\n\s*update_flops', src,
                    re.S | re.M).group(1)
    upd = re.search(r'^\s*update_flops = (.+)$', src, re.M).group(1)
    scope = {'h': h, 'O': o, 'A': a, 'N': n,
             'cfg': ppo.PPOConfig(epochs=epochs)}
    scope['fwd_flops'] = eval(fwd, {}, scope)
    assert profile_ppo.update_flops(o, h, a, n, epochs) == eval(upd, {},
                                                                scope)


def test_vision_bench():
    out = vision.measure(((8, 8, False), (8, 8, True)), reps=2,
                         device='cpu', target_marginal_s=0.02,
                         min_marginal_s=0.0, warmup=(0.0, 0.0))
    assert [c['label'] for c in out['configs']] == ['8envs_res8',
                                                    '8envs_res8_dvs']
    for c in out['configs']:
        assert c['env_steps_per_sec'] == c['images_per_sec'] > 0
        assert 1 <= c['t_lo'] < c['t_hi'] and c['warm_up']['calls'] == 1
    assert '0.02s-marginal' in out['methodology']
    _finite(out)


def test_scaling_cpu_weak_scaling():
    """Sub-measurement 2 at 64 envs per rank on 1 and 2 gloo ranks."""
    rows = [scaling.cpu_weak_scaling(n, 64, 5, 25, 2, timeout_s=300)
            for n in (1, 2)]
    for n, r in zip((1, 2), rows):
        assert r['ranks'] == n and r['envs_per_rank'] == 64
        assert r['steps_per_sec'] > 0 and len(r['samples']) == 2
        assert r['per_rank'] == pytest.approx(r['steps_per_sec'] / n)
    _finite(rows)
