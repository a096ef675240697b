"""The port's PPO learner (gym_copter_tpu_torch/learn/) against the JAX
package's (gym_copter_tpu/learn/ppo.py): the machinery tests of
tests/test_ppo.py mirrored on the port, its modules on fixed float64 inputs
against JAX's, its optimizer against optax, and whole train steps from one
state carried across by `train_state_from_numpy`.  The learning runs of
test_ppo.py are mirrored in tests/test_torch_ppo_train.py."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gym_copter_tpu.core import vehicles as jvehicles
from gym_copter_tpu.core.types import EnvParams as JEnvParams
from gym_copter_tpu.envs import tasks as jtasks
from gym_copter_tpu.learn import ppo as jppo
from gym_copter_tpu_torch.compat import convert
from gym_copter_tpu_torch.core import prng, vehicles
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.envs import tasks
from gym_copter_tpu_torch.envs.registry import default_params
from gym_copter_tpu_torch.learn import optim, ppo

PARAMS = EnvParams(vehicle=vehicles.DJI_PHANTOM)
JPARAMS = JEnvParams(vehicle=jvehicles.DJI_PHANTOM)
CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the driver runs several test workers at once, and
    torch's default of one thread per core makes them spin against each
    other on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _closure(fn, name):
    """The function `name` that `fn` closes over (the JAX module keeps GAE
    and the loss inside make_train_step)."""
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    return cells[name]


def _step(cfg, spec=tasks.HOVER_3D, num_envs=16, optimizer=None):
    return ppo.make_train_step(
        PARAMS, spec, cfg, prng.PRNGKey(0, CPU),
        torch.arange(num_envs, dtype=torch.int32), optimizer=optimizer)


def _gae_inputs(t=5, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, b)), rng.normal(size=(t, b)),
            rng.random((t, b)) < 0.3, rng.normal(size=(b,)))


def test_gae_matches_reference_recursion():
    """The port's GAE (TrainStep.advantages, the last value from a critic
    of zero weights whose last bias carries it) against a plain python
    backward recursion at rtol 1e-6, as test_ppo.py holds JAX's: both
    frameworks round gamma * lambda * (1 - done) to float32, as the JAX
    module's float32 done mask makes it.  Against the JAX module's own
    compute_gae, rtol 1e-12."""
    cfg = ppo.PPOConfig(rollout_steps=5, hidden=4)
    step, _ = _step(cfg, num_envs=2)
    t, b = 5, 2
    rewards, values, dones, last_value = _gae_inputs(t, b)
    gamma, lam = cfg.gamma, cfg.gae_lambda
    expected = np.zeros((t, b))
    gae = np.zeros(b)
    next_v = last_value
    for i in reversed(range(t)):
        nonterm = 1.0 - dones[i]
        delta = rewards[i] + gamma * next_v * nonterm - values[i]
        gae = delta + gamma * lam * nonterm * gae
        expected[i] = gae
        next_v = values[i]

    jstep, _ = jppo.make_train_step(
        JPARAMS, jtasks.HOVER_3D, jppo.PPOConfig(rollout_steps=5),
        jax.random.PRNGKey(0), jnp.arange(2, dtype=jnp.int32))
    jtraj = jppo.Transition(obs=None, action=None, log_prob=None,
                            value=jnp.asarray(values),
                            reward=jnp.asarray(rewards),
                            done=jnp.asarray(dones))
    jadv, _ = _closure(jstep, 'compute_gae')(jtraj, jnp.asarray(last_value))
    jadv = np.asarray(jadv)
    np.testing.assert_allclose(jadv, expected, rtol=1e-6)

    obs_size = tasks.HOVER_3D.obs_size
    net = ppo.init_params(prng.PRNGKey(0, CPU), obs_size, 4, cfg,
                          torch.float64)
    for env in range(b):
        leaves = [torch.zeros_like(p) for p in net.leaves()]
        leaves[11] = torch.tensor([last_value[env]], dtype=torch.float64)
        traj = ppo.Transition(
            obs=torch.zeros((t, obs_size, 1), dtype=torch.float64),
            action=torch.zeros((t, 4, 1), dtype=torch.float64),
            log_prob=torch.zeros((t, 1), dtype=torch.float64),
            value=torch.from_numpy(values[:, env:env + 1]),
            reward=torch.from_numpy(rewards[:, env:env + 1]),
            done=torch.from_numpy(dones[:, env:env + 1]))
        flat, _ = step.advantages(leaves, traj,
                                  torch.zeros((obs_size, 1),
                                              dtype=torch.float64))
        np.testing.assert_allclose(flat[4].numpy(), expected[:, env],
                                   rtol=1e-6)
        np.testing.assert_allclose(flat[4].numpy(), jadv[:, env],
                                   rtol=1e-12)
        np.testing.assert_allclose(flat[5].numpy(),
                                   jadv[:, env] + values[:, env], rtol=1e-12)


def test_log_prob_matches_scipy_form_and_jax():
    """float64: rtol 1e-12 against the closed form, and against JAX's."""
    rng = np.random.default_rng(1)
    mean = rng.normal(size=(4, 3))
    log_std = rng.normal(size=(4, 1)) * 0.1
    action = rng.normal(size=(4, 3))
    got = ppo._log_prob(torch.from_numpy(mean), torch.from_numpy(log_std),
                        torch.from_numpy(action)).numpy()
    std = np.exp(log_std)
    expected = (-0.5 * ((action - mean) / std) ** 2 - np.log(std)
                - 0.5 * np.log(2 * np.pi)).sum(0)
    np.testing.assert_allclose(got, expected, rtol=1e-12)
    want = jppo._log_prob(jnp.asarray(mean), jnp.asarray(log_std),
                          jnp.asarray(action))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12)


def _jax_params(seed=0, obs_size=10, action_size=4, hidden=16):
    cfg = jppo.PPOConfig(hidden=hidden)
    p = jppo.init_params(jax.random.PRNGKey(seed), obs_size, action_size,
                         cfg, dtype=jnp.float64)
    # non-zero biases and log-std, so that every term is exercised
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: x + 0.1 * rng.normal(size=x.shape), p)


def test_mlp_apply_and_policy_match_jax():
    """float64 MLP and policy head on fixed numpy inputs: rtol 1e-12."""
    jp = _jax_params()
    net = convert.ppo_params_from_numpy(jp, CPU)
    x = np.random.default_rng(2).normal(size=(10, 64)) * 5
    got = ppo.mlp_apply(ppo.unflatten(net.leaves())[0], torch.from_numpy(x))
    want = jppo.mlp_apply(jp['actor'], jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    cfg = ppo.PPOConfig(hidden=16)
    for a, b in zip(net(torch.from_numpy(x), cfg),
                    jppo._policy(jp, jnp.asarray(x), jppo.PPOConfig())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-15)
    back = convert.ppo_params_to_numpy(net)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize('value_clip', [0.0, 0.2])
def test_loss_and_gradients_match_jax(value_clip):
    """The clipped loss, its four aux terms and its gradients (autograd vs
    jax.grad) on fixed float64 minibatch inputs: rtol 1e-10."""
    jcfg = jppo.PPOConfig(hidden=16, value_clip=value_clip)
    jstep, _ = jppo.make_train_step(JPARAMS, jtasks.LANDER_3D, jcfg,
                                    jax.random.PRNGKey(0),
                                    jnp.arange(8, dtype=jnp.int32))
    jloss = _closure(_closure(jstep, 'update_epoch'), 'loss_fn')
    jp = _jax_params()
    rng = np.random.default_rng(3)
    n = 96
    batch = (rng.normal(size=(10, n)) * 3, rng.normal(size=(4, n)) - 1,
             rng.normal(size=n) - 2, rng.normal(size=n),
             rng.normal(size=n) * 2, rng.normal(size=n))
    (want, want_aux), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jp, *(jnp.asarray(b) for b in batch))

    step, _ = _step(ppo.PPOConfig(hidden=16, value_clip=value_clip),
                    tasks.LANDER_3D, 8)
    leaves = [p.requires_grad_() for p in
              convert.ppo_params_from_numpy(jp, CPU).leaves()]
    loss, aux = step.loss(leaves, *(torch.from_numpy(b) for b in batch))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-10)
    np.testing.assert_allclose(aux.detach().numpy(),
                               np.asarray(jnp.stack(want_aux)), rtol=1e-10)
    want_leaves = convert.ppo_params_from_numpy(want_g, CPU).leaves()
    for g, w in zip(grads, want_leaves):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-14)


@pytest.mark.parametrize('max_norm', [1e3, 0.05])
@pytest.mark.parametrize('schedule', [False, True, 'jitted'])
def test_optimizer_matches_optax(max_norm, schedule):
    """ClipAdam against optax.chain(clip_by_global_norm, adam(lr)) over 6
    steps of fixed float64 gradients, with the norm under the limit
    (1e3) and over it (0.05), constant and linearly annealed rate: updates
    and state to rtol 1e-12, counts exactly.  'jitted': the schedule
    (1e-3, 1e-4, 20) over 22 steps against `jax.jit(jopt.update)`, as the
    JAX package's train step runs it; there eager optax rounds the rate
    differently at 10 of the counts (at (1e-2, 1e-3, 4) at none)."""
    jp = _jax_params(hidden=8)
    rng = np.random.default_rng(4)
    steps = 6
    if schedule == 'jitted':
        jlr = optax.linear_schedule(1e-3, 1e-4, 20)
        lr = optim.linear_schedule(1e-3, 1e-4, 20)
        steps = 22
    elif schedule:
        jlr = optax.linear_schedule(1e-2, 1e-3, 4)
        lr = optim.linear_schedule(1e-2, 1e-3, 4)
    else:
        jlr = lr = 1e-2
    jopt = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(jlr))
    jupdate = jax.jit(jopt.update) if schedule == 'jitted' else jopt.update
    opt = optim.ClipAdam(max_norm, lr)
    jstate = jopt.init(jp)
    leaves = convert.ppo_params_from_numpy(jp, CPU).leaves()
    state = opt.init(leaves)
    for _ in range(steps):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape), jp)
        jup, jstate = jupdate(g, jstate, jp)
        up, state = opt.update(
            convert.ppo_params_from_numpy(g, CPU).leaves(), state)
        for a, b in zip(up, convert.ppo_params_from_numpy(jup, CPU).leaves()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-18)
        want = convert.opt_state_from_numpy(jstate, CPU)
        assert int(state.count) == int(want.count)
        assert int(state.schedule_count) == int(want.schedule_count)
        for xs, ys in ((state.mu, want.mu), (state.nu, want.nu)):
            for a, b in zip(xs, ys):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                           atol=1e-18)
    clipped = optax.global_norm(g) >= max_norm
    assert bool(clipped) == (max_norm < 1)


@pytest.mark.parametrize('stop', [None, False, True],
                         ids=['no_guard', 'go', 'stop'])
@pytest.mark.parametrize('clip', [True, False], ids=['clip', 'no_clip'])
@pytest.mark.parametrize('schedule', [False, True],
                         ids=['constant', 'schedule'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64],
                         ids=['f32', 'f64'])
def test_clip_adam_step_equals_the_former_sequence(dtype, schedule, clip,
                                                   stop):
    """ClipAdam.step on the CPU equals, bit for bit, the sequence the PPO
    update ran before it (update, the stop select, tree_where,
    apply_updates): params, moments and counts, a -0.0 param included."""
    from torch_cuda_cases import clip_adam_case, ppo_leaf_shapes, \
        step_mismatches

    opt, params, grads, state, flag = clip_adam_case(
        ppo_leaf_shapes(10, hidden=16), dtype, CPU, clip=clip, stop=stop,
        count=38_399, schedule=schedule)
    updates, new_state = opt.update(grads, state)
    if flag is not None:
        updates = [torch.where(flag, torch.zeros_like(u), u)
                   for u in updates]
        new_state = optim.tree_where(flag, state, new_state)
    want = optim.apply_updates(params, updates), new_state
    got = opt.step(params, grads, state, flag)
    assert step_mismatches(got, want) == []
    # -0.0 + -0.0 where the step goes, -0.0 + 0 where it stops
    assert bool(torch.signbit(got[0][0].view(-1)[0])) == (stop is not True)


def _one_update(target_kl, spec_name='HOVER_3D', dtype=np.float64):
    """One train_step from the same JAX init on both sides (the
    `_one_update_params` configuration of tests/test_ppo.py)."""
    kw = dict(rollout_steps=8, hidden=16, minibatches=2, epochs=4,
              learning_rate=1e-2, anneal_lr=False, target_kl=target_kl)
    jcfg = jppo.PPOConfig(**kw)
    jspec = getattr(jtasks, spec_name)
    jstep, jopt = jppo.make_train_step(JPARAMS, jspec, jcfg,
                                       jax.random.PRNGKey(0),
                                       jnp.arange(16, dtype=jnp.int32))
    jts = jppo.init_train_state(jax.random.PRNGKey(7), JPARAMS, jspec, jcfg,
                                16, jopt, dtype=dtype)
    jts2, jm = jax.jit(jstep)(jts)
    step, _ = _step(ppo.PPOConfig(**kw), getattr(tasks, spec_name))
    ts = convert.train_state_from_numpy(jts, CPU)
    ts2, m = step(ts)
    return ts, ts2, m, convert.train_state_from_numpy(jts2, CPU), jm


def _assert_state_close(got, want, rtol, atol, moment_rel=None, updates=1):
    for a, b in zip(got.params.leaves(), want.params.leaves()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                   atol=atol)
    # the moments to rtol, and to moment_rel (default rtol) of each
    # leaf's largest element
    moment_rel = moment_rel or rtol
    for xs, ys in ((got.opt_state.mu, want.opt_state.mu),
                   (got.opt_state.nu, want.opt_state.nu)):
        for a, b in zip(xs, ys):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                       atol=moment_rel * float(b.abs().max()))
    assert int(got.opt_state.count) == int(want.opt_state.count)
    assert int(got.opt_state.schedule_count) == int(
        want.opt_state.schedule_count)
    np.testing.assert_allclose(got.env_state.dyn.x.numpy(),
                               want.env_state.dyn.x.numpy(), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(got.obs.numpy(), want.obs.numpy(), rtol=rtol,
                               atol=atol)
    for name in ('status', 'ticks'):
        assert torch.equal(getattr(got.env_state.dyn, name),
                           getattr(want.env_state.dyn, name))
    assert torch.equal(got.env_state.steps, want.env_state.steps)
    assert torch.equal(got.env_state.episode, want.env_state.episode)
    assert torch.equal(got.key, want.key)
    assert int(got.update_idx) == int(want.update_idx) == updates


@pytest.mark.parametrize('target_kl', [0.0, 1e9, 1e-12])
@pytest.mark.parametrize('spec_name', ['HOVER_3D', 'LANDER_3D'])
def test_train_step_matches_jax_float64(spec_name, target_kl):
    """One whole float64 train step (8 rollout steps at 16 envs, 4 epochs x
    2 minibatches, with the guard off, never tripping, and tripping after
    the first minibatch) from the same TrainState: params, Adam state, env
    state, obs, key and metrics to rtol 1e-9 (measured: 3e-15 on Hover3D,
    7e-13 on Lander3D, from torch's and XLA's 1-ULP sin/cos gap and sum
    orders); counts, key and the discrete env fields exactly."""
    ts, got, m, want, jm = _one_update(target_kl, spec_name)
    _assert_state_close(got, want, rtol=1e-9, atol=1e-12)
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-9,
                                   atol=1e-12, err_msg=k)
    assert int(got.opt_state.count) == (1 if target_kl == 1e-12 else 8)


def test_scheduled_train_steps_match_jax_float64():
    """train()'s optimizer (the rate annealed to 0.05 of itself over every
    optimizer step of the run) over 3 float64 updates from the same
    TrainState, against `jax.jit` of the JAX package's step with the
    schedule its `train` builds: params, Adam state, env state, obs, key
    and metrics to rtol 1e-9 after every update, counts exactly.  With
    eager optax's rounding of the rate the port was 5.9e-11 absolute off
    from the second update on."""
    num_updates = 3
    cfg = ppo.PPOConfig(rollout_steps=8, hidden=16, minibatches=2, epochs=4,
                        learning_rate=1e-2)
    jcfg = jppo.PPOConfig(**cfg._asdict())
    assert cfg.anneal_lr and jcfg.anneal_lr
    jopt = optax.chain(
        optax.clip_by_global_norm(jcfg.max_grad_norm),
        optax.adam(optax.linear_schedule(
            jcfg.learning_rate, jcfg.learning_rate * jcfg.anneal_lr_floor,
            num_updates * jcfg.epochs * jcfg.minibatches)))
    jstep, jopt = jppo.make_train_step(JPARAMS, jtasks.HOVER_3D, jcfg,
                                       jax.random.PRNGKey(0),
                                       jnp.arange(16, dtype=jnp.int32),
                                       optimizer=jopt)
    jstep = jax.jit(jstep)
    jts = jppo.init_train_state(jax.random.PRNGKey(7), JPARAMS,
                                jtasks.HOVER_3D, jcfg, 16, jopt,
                                dtype=np.float64)
    step, _ = _step(cfg, optimizer=ppo.train_optimizer(cfg, num_updates))
    ts = convert.train_state_from_numpy(jts, CPU)
    for i in range(num_updates):
        jts, jm = jstep(jts)
        ts, m = step(ts)
        _assert_state_close(ts, convert.train_state_from_numpy(jts, CPU),
                            rtol=1e-9, atol=1e-12, updates=i + 1)
        for k, v in jm.items():
            np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-9,
                                       atol=1e-12, err_msg=f'{k} {i}')
    assert int(ts.opt_state.schedule_count) == num_updates * 8


@pytest.mark.parametrize('spec_name,atol,moment_rel,metric_rtol', [
    ('HOVER_3D', 1e-6, 1e-4, 1e-4), ('LANDER_3D', 3e-4, 3e-3, 1e-3)])
def test_train_step_matches_jax_float32(spec_name, atol, moment_rel,
                                        metric_rtol):
    """The same train step in float32.  Hover3D holds rtol 1e-4 throughout
    (params atol 1e-6; measured 5e-7 relative).  Lander3D's reward is the
    difference of two shaping potentials of ~250, which float32 rounds at
    ~1e-5 absolute against rewards of ~0.03, so its gradients differ by
    ~1e-3 relative: measured params 9.6e-5 absolute (against 0.08 of
    movement), Adam moments 9.2e-4 of each leaf's largest element, reward
    metrics 1.1e-5 and loss metrics 4.5e-4 relative; held at 3e-4, 3e-3 and
    1e-3.  Env state to rtol 1e-4 on both."""
    ts, got, m, want, jm = _one_update(1e9, spec_name, np.float32)
    assert got.params.leaves()[0].dtype == torch.float32
    _assert_state_close(got, want, rtol=1e-4, atol=atol,
                        moment_rel=moment_rel)
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=metric_rtol,
                                   atol=1e-6, err_msg=k)


def test_target_kl_guard_masks_later_epochs():
    """Mirror of test_ppo.py's guard test on the port: an unreachable
    threshold is a no-op (bit-equal here, where the JAX module allows
    fusion differences), a near-zero one lets only the first minibatch
    through, so the params move strictly less."""
    def run(target_kl):
        cfg = ppo.PPOConfig(rollout_steps=8, hidden=16, minibatches=2,
                            epochs=4, learning_rate=1e-2, anneal_lr=False,
                            target_kl=target_kl)
        step, opt = _step(cfg)
        ts = ppo.init_train_state(prng.PRNGKey(7, CPU), PARAMS,
                                  tasks.HOVER_3D, cfg, 16, opt)
        ts2, m = step(ts)
        return ts.params.leaves(), ts2.params.leaves(), m

    p0, p_free, _ = run(0.0)
    _, p_huge, _ = run(1e9)
    _, p_tiny, m_tiny = run(1e-12)
    for a, b in zip(p_free, p_huge):
        assert torch.equal(a, b)

    def dist(a, b):
        return float(sum(torch.sum((x - y) ** 2) for x, y in zip(a, b)))

    assert np.isfinite(float(m_tiny['approx_kl']))
    moved_tiny, moved_free = dist(p_tiny, p0), dist(p_free, p0)
    assert 0 < moved_tiny < moved_free


def test_eval_matches_jax():
    """make_eval_fn against JAX's on the same float32 params at 16 envs x
    200 steps of Lander3D (episodes end in the fall): returns to rtol
    1e-5, the float32 env's CPU sin/cos gap."""
    jcfg = jppo.PPOConfig(hidden=16)
    jp = jppo.init_params(jax.random.PRNGKey(5), 10, 4, jcfg)
    jeval = jppo.make_eval_fn(JPARAMS, jtasks.LANDER_3D, jcfg, num_envs=16,
                              num_steps=200)
    want_mean, want = jeval(jp)
    evaluate = ppo.make_eval_fn(PARAMS, tasks.LANDER_3D,
                                ppo.PPOConfig(hidden=16), num_envs=16,
                                num_steps=200, device=CPU)
    got_mean, got = evaluate(convert.ppo_params_from_numpy(jp, CPU))
    assert float(want_mean) < -50   # free fall: the episodes ended
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(float(got_mean), float(want_mean), rtol=1e-5)


@pytest.mark.parametrize('hidden', [32, 128])
def test_bf16_matmul_close_to_f32(hidden):
    """matmul_dtype='bfloat16': bf16 operands, float32 products and sums,
    as JAX's dot_general with preferred_element_type=float32.  On JAX's
    float32 initial parameters of seed 0 and 4096 columns: each layer,
    given the same input, within 1e-6 of JAX's (measured 7.2e-7; the
    sums' order differs); the whole actor and critic within 2e-3
    (measured 1.2e-5 on the actor's outputs of ~0.03 and 9.7e-4 on the
    critic's of ~1.8: a last-bit difference in a float32 tanh flips a bf16
    rounding of the next layer's input); within bf16's ~3 digits of the
    float32 path, rtol/atol 0.05; and a train step stays finite."""
    jp = jppo.init_params(jax.random.PRNGKey(0), 10, 4,
                          jppo.PPOConfig(hidden=hidden), jnp.float32)
    actor, critic, _ = ppo.unflatten(
        convert.ppo_params_from_numpy(jp, CPU).leaves())
    x = np.random.default_rng(1).normal(size=(10, 4096)).astype(np.float32)
    for jlayers, layers in ((jp['actor'], actor), (jp['critic'], critic)):
        xs = x
        for jlayer, layer in zip(jlayers, layers):
            want = np.asarray(jppo.mlp_apply([jlayer], jnp.asarray(xs),
                                             'bfloat16'))
            got = ppo.mlp_apply([layer], torch.from_numpy(xs), 'bfloat16')
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
            xs = np.tanh(want)
        want = np.asarray(jppo.mlp_apply(jlayers, jnp.asarray(x),
                                         'bfloat16'))
        got = ppo.mlp_apply(layers, torch.from_numpy(x), 'bfloat16')
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
        f32 = ppo.mlp_apply(layers, torch.from_numpy(x))
        np.testing.assert_allclose(f32.numpy(), got.numpy(), rtol=0.05,
                                   atol=0.05)

    cfg_t = ppo.PPOConfig(rollout_steps=4, hidden=8, minibatches=2,
                          epochs=2, matmul_dtype='bfloat16')
    step, opt = ppo.make_train_step(default_params(), tasks.HOVER_3D, cfg_t,
                                    prng.PRNGKey(0, CPU),
                                    torch.arange(16, dtype=torch.int32))
    ts = ppo.init_train_state(prng.PRNGKey(2, CPU), default_params(),
                              tasks.HOVER_3D, cfg_t, 16, opt)
    _, metrics = step(ts)
    for k, v in metrics.items():
        assert bool(torch.isfinite(v)), k


def test_scaled_minibatches_holds_minibatch_size_fixed():
    assert ppo.scaled_minibatches(1024) == 4
    assert ppo.scaled_minibatches(4096) == 16
    assert ppo.scaled_minibatches(2048) == 8
    assert ppo.scaled_minibatches(256) == 1
    assert ppo.scaled_minibatches(64) == 1
    for envs in (1024, 2048, 4096, 8192):
        assert envs * 128 // ppo.scaled_minibatches(envs) == 1024 * 128 // 4


def test_minibatches_default_auto_resolves(capsys):
    cfg = ppo.PPOConfig()
    assert cfg.minibatches is None
    resolved = ppo.resolve_minibatches(cfg, 4096)
    assert resolved.minibatches == 16
    assert ppo.resolve_minibatches(resolved, 4096).minibatches == 16
    ppo.resolve_minibatches(ppo.PPOConfig(minibatches=1), 4096)
    err = capsys.readouterr().err
    assert 'minibatch size' in err and 'scaled_minibatches' in err
    assert ppo.resolve_minibatches(ppo.PPOConfig(), 256).minibatches == 4
    assert ppo.resolve_minibatches(ppo.PPOConfig(), 64).minibatches == 4
    assert ppo.resolve_minibatches(ppo.PPOConfig(), 4096).shuffle_block == 128
    assert ppo.resolve_minibatches(ppo.PPOConfig(), 8192).shuffle_block == 128
    assert ppo.resolve_minibatches(ppo.PPOConfig(), 1024).shuffle_block == 1
    assert ppo.resolve_minibatches(
        ppo.PPOConfig(shuffle_block=128), 1024).shuffle_block == 128
    step, _ = ppo.make_train_step(default_params(), tasks.HOVER_3D,
                                  ppo.PPOConfig(rollout_steps=4, hidden=8),
                                  prng.PRNGKey(0, CPU),
                                  torch.arange(64, dtype=torch.int32))
    assert step.cfg.minibatches == 4 and step.cfg.shuffle_block == 1


def test_rollout_chunks_equal_one_rollout():
    """The rollout graphed as a 1-step graph replayed T times runs the same
    operations as one rollout: on the CPU, eight 1-step rollouts chained
    give the one 8-step rollout's bits."""
    step, opt = _step(ppo.PPOConfig(rollout_steps=8, hidden=8),
                      tasks.LANDER_3D)
    ts = ppo.init_train_state(prng.PRNGKey(3, CPU), PARAMS, tasks.LANDER_3D,
                              step.cfg, 16, opt)
    leaves = ts.params.leaves()
    whole = step.rollout(leaves, ts.env_state, ts.obs, ts.key, 8)
    carry, parts = (ts.env_state, ts.obs, ts.key), []
    for _ in range(8):
        *carry, chunk = step.rollout(leaves, *carry, 1)
        parts.append(chunk)
    for a, *bs in zip(whole[3], *parts):
        assert torch.equal(a, torch.cat(bs))
    assert torch.equal(whole[1], carry[1]) and torch.equal(whole[2], carry[2])


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, loads no JAX
    module, no optax and nothing of gym_copter_tpu."""
    code = ('import importlib, pkgutil, sys\n'
            'import gym_copter_tpu_torch as pkg\n'
            'for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):\n'
            '    importlib.import_module(m.name)\n'
            'import chip_smoke\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "gym_copter_tpu", "optax")]\n'
            'assert "gym_copter_tpu_torch.learn.ppo" in sys.modules\n'
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n')
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stdout + out.stderr
