"""The port's NEAT-style neuroevolution (gym_copter_tpu_torch/learn/
neuroevolution.py) against the JAX package's (gym_copter_tpu/learn/
neuroevolution.py): the network, the population's init, one `evolve` from
identical inputs, the fitness, a short evolution, the sharded fitness on 2
gloo ranks, the recorded Lander3D champion carried across and evaluated
on both sides, and the mirrors of tests/test_neuroevolution.py.

The JAX side runs as its tests run it: float64 under the suite's x64, and
float32 inside `jax.enable_x64(False)`, as it runs on a chip."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from gym_copter_tpu.learn import neuroevolution as jne
from gym_copter_tpu_torch.compat import convert
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.envs.registry import default_params
from gym_copter_tpu_torch.learn import neuroevolution as ne
from gym_copter_tpu_torch.parallel import launch

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device('cpu')
KW = dict(pop_size=8, episode_reps=2, hidden=4, max_steps=64)
CFG, JCFG = ne.NeatConfig(**KW), jne.NeatConfig(**KW)
# a fitness with ties (three genomes share the best value, as genomes that
# crash alike do early on)
TIED = np.array([3.0, 1.0, 3.0, 2.0, 1.0, 3.0, 0.0, 2.0])


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: several test workers share the CPU, and MKL's
    vector functions can take a less accurate variant when threads race."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_pop(key=0, obs=6, act=2, cfg=JCFG):
    return jne.init_population(jax.random.PRNGKey(key), obs, act, cfg)


def _port(g):
    return convert.genome_from_numpy(g, CPU)


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def test_init_population_matches_jax():
    """Same key: the masks equal, the weights within the `normal` gap
    (float64, 32 ULP: measured 2.8e-15)."""
    jg = _jax_pop()
    g = ne.init_population(prng.PRNGKey(0, CPU), 6, 2, CFG, torch.float64)
    for name, a, b in zip(jg._fields, jg, g):
        assert b.dtype == torch.float64
        if name.startswith('m'):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-14,
                                       atol=1e-14)


def test_network_step_matches_jax():
    """One step of every genome's net, hidden block enabled at random, from
    the same float64 inputs: within 1e-12."""
    rng = np.random.default_rng(0)
    jg = _jax_pop()
    jg = jg._replace(**{m: jnp.asarray(rng.random(np.shape(getattr(jg, m)))
                                       < 0.5, jnp.float64)
                        for m in ('m_in', 'm_rec', 'm_out')})
    obs = rng.normal(size=(6, 8, 2))
    h = rng.normal(size=(4, 8, 2))
    jh, jout = jne.network_step(jg, jnp.asarray(obs), jnp.asarray(h))
    th, tout = ne.network_step(_port(jg), torch.from_numpy(obs),
                               torch.from_numpy(h))
    assert _max_abs(jh, th) < 1e-12 and _max_abs(jout, tout) < 1e-12


@pytest.mark.parametrize('x64', [True, False], ids=['float64', 'float32'])
@pytest.mark.parametrize('seed', [3])
def test_evolve_matches_jax(x64, seed):
    """One evolve from identical inputs, with a tied fitness: the parents
    (tournament winners, drawn as JAX's make_evolve_fn draws them) and
    crossover flags are equal, the elites are the stably sorted fittest,
    every mask is equal, and every weight within 1e-12 (float64; measured
    1.3e-15, the `normal` gap) or 1e-5 (float32; measured 2.4e-7)."""
    with jax.enable_x64(x64):
        dtype = torch.float64 if x64 else torch.float32
        jg = _jax_pop()
        key = jax.random.PRNGKey(seed)
        jfit = jnp.asarray(TIED)
        want = jne.make_evolve_fn(JCFG)(jg, jfit, key)
        k_pa, k_pb, k_cx, _ = jax.random.split(key, 4)

        def tournament(k):
            idx = jax.random.randint(k, (8, JCFG.tournament), 0, 8)
            return np.asarray(idx[jnp.arange(8), jnp.argmax(jfit[idx], 1)])

        g, fit = _port(jg), torch.from_numpy(TIED).to(dtype)
        assert g.w_dir.dtype == dtype
        _, pa, pb, use_cx = ne.parents(CFG, fit, prng.PRNGKey(seed, CPU),
                                       dtype)
        np.testing.assert_array_equal(pa.numpy(), tournament(k_pa))
        np.testing.assert_array_equal(pb.numpy(), tournament(k_pb))
        np.testing.assert_array_equal(
            use_cx.numpy(), np.asarray(jax.random.bernoulli(
                k_cx, JCFG.crossover_rate, (8,))))
        got = ne.make_evolve_fn(CFG)(g, fit, prng.PRNGKey(seed, CPU))
    # elites: the first two of the stable order of -fit, genomes 0 and 2
    for leaf_new, leaf_old in zip(got, g):
        assert torch.equal(leaf_new[0], leaf_old[0])
        assert torch.equal(leaf_new[1], leaf_old[2])
    for name, a, b in zip(want._fields, want, got):
        assert b.dtype == dtype
        if name.startswith('m'):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
        else:
            assert _max_abs(a, b) <= (1e-12 if x64 else 1e-5), name


def test_evolve_preserves_elites_and_binary_masks():
    """Mirror of test_neuroevolution.py's: elite slots carry the fittest
    genomes unchanged, masks stay binary, weights stay clipped."""
    g = ne.init_population(prng.PRNGKey(0, CPU), 6, 2, CFG)
    fit = torch.arange(CFG.pop_size, 0.0, -1.0)
    nxt = ne.make_evolve_fn(CFG)(g, fit, prng.PRNGKey(3, CPU))
    for leaf_new, leaf_old in zip(nxt, g):
        assert torch.equal(leaf_new[0], leaf_old[0])
        assert torch.equal(leaf_new[1], leaf_old[1])
    for m in (nxt.m_dir, nxt.m_in, nxt.m_rec, nxt.m_out):
        assert bool(((m == 0.0) | (m == 1.0)).all())
    for w in (nxt.w_dir, nxt.w_in, nxt.w_rec, nxt.w_out):
        assert float(w.abs().max()) <= CFG.weight_clip + 1e-6


def test_structural_mutation_complexifies():
    """Mirror: a few generations from the minimal topology enable some
    hidden connections; masked connections contribute nothing."""
    g = ne.init_population(prng.PRNGKey(0, CPU), 6, 2, CFG)
    obs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(6, 8, 2)).astype(np.float32))
    _, out = ne.network_step(g, obs, torch.ones((CFG.hidden, 8, 2)))
    direct = torch.tanh(torch.einsum('pao,opr->apr', g.w_dir, obs)
                        + g.b_out.T[:, :, None])
    torch.testing.assert_close(out, direct, rtol=0, atol=1e-6)
    evolve = ne.make_evolve_fn(CFG)
    for i in range(10):
        g = evolve(g, torch.zeros(CFG.pop_size), prng.PRNGKey(100 + i, CPU))
    assert float(g.m_in.sum() + g.m_rec.sum() + g.m_out.sum()) > 0.0


def test_fitness_matches_jax():
    """make_fitness_fn on Lander2D-v0, P = 4, R = 2, 64 steps, from the same
    float64 genomes: within rtol 1e-5 (the float32 env's CPU sin/cos gap;
    measured 8.7e-8)."""
    cfg = dataclasses.replace(CFG, pop_size=4)
    jg = jne.take_genomes(_jax_pop(), jnp.arange(4))
    want = jne.make_fitness_fn('Lander2D-v0', dataclasses.replace(
        JCFG, pop_size=4))(jg, jnp.int32(3))
    got = ne.make_fitness_fn('Lander2D-v0', cfg, device=CPU)(_port(jg), 3)
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_fitness_shape_and_rep_grouping():
    """Mirror: with reset randomness off, two identical genomes get the
    same fitness, and distinct ones differ."""
    cfg = dataclasses.replace(CFG, pop_size=4)
    params = default_params()
    params = params._replace(task=params.task._replace(
        initial_random_force=0.0))
    g = ne.init_population(prng.PRNGKey(0, CPU), 6, 2, cfg)
    twin = g._replace(**{k: torch.cat([v[:1], v[:1], v[2:]])
                         for k, v in g._asdict().items()})
    fit = ne.make_fitness_fn('Lander2D-v0', cfg, env_params=params,
                             device=CPU)(twin, 0)
    assert fit.shape == (4,)
    assert float(fit[0]) == float(fit[1])
    assert float(fit[1]) != float(fit[2])


def test_evolve_population_matches_jax_history_and_is_seeded():
    """Two generations on Hover1D-v0 (P = 4, 32 steps): the history has the
    JAX package's keys, a float64 generation 0 within rtol 1e-5 of JAX's,
    and the same seed gives the same history."""
    cfg_kw = dict(KW, pop_size=4, max_steps=32)
    _, jh, _ = jne.evolve_population('Hover1D-v0', jne.NeatConfig(**cfg_kw),
                                     max_generations=2, seed=5,
                                     callback=lambda r: None)

    def run():
        return ne.evolve_population('Hover1D-v0', ne.NeatConfig(**cfg_kw),
                                    max_generations=2, seed=5,
                                    callback=lambda r: None, device=CPU,
                                    dtype=torch.float64)[1]

    h1, h2 = run(), run()
    assert h1 == h2
    assert [list(r) for r in h1] == [list(r) for r in jh]
    for k in ('best_fitness', 'mean_fitness', 'holdout_best',
              'hidden_conn_frac'):
        np.testing.assert_allclose(h1[0][k], jh[0][k], rtol=1e-5, err_msg=k)


def test_evolution_runs_and_tracks_champion():
    """Mirror: a few generations on Lander1D, the champion has a pop axis
    of 1 and evaluates on fresh episodes."""
    champ, hist, _ = ne.evolve_population(
        'Lander1D-v0', CFG, max_generations=3, seed=0,
        callback=lambda rec: None, device=CPU)
    assert len(hist) == 3 and champ.w_dir.shape[0] == 1
    mean, per = ne.evaluate_champion(champ, 'Lander1D-v0', CFG, reps=3)
    assert per.shape == (3,)
    assert abs(float(per.mean()) - mean) < 1e-5
    assert np.isfinite(mean)
    assert all('holdout_best' in h for h in hist)


def test_sharded_fitness_on_two_ranks():
    """`group=` on 2 gloo ranks: every rank returns the whole (16,) fitness,
    equal to the unsharded one within rtol 1e-5, as test_neuroevolution.py
    holds JAX's mesh (each rank steps its genomes' envs with their global
    ids; the CPU's batched products round differently at 8 genomes than at
    16, measured 3.1e-5 absolute on float32 returns of ~100); a population
    of 17 raises."""
    cfg_kw = dict(KW, pop_size=16)
    g = ne.init_population(prng.PRNGKey(4, CPU), 6, 2,
                           ne.NeatConfig(**cfg_kw), torch.float64)
    want = ne.make_fitness_fn('Lander2D-v0', ne.NeatConfig(**cfg_kw),
                              device=CPU)(g, 3)
    results = launch.spawn(cases.fitness_world, 2, 'gloo', 'cpu',
                           (g, cfg_kw, 3), timeout_s=300)
    for fit, error in results:
        np.testing.assert_allclose(fit.numpy(), want.numpy(), rtol=1e-5)
        assert 'not divisible' in error


@pytest.fixture(scope='module')
def neat_champion():
    return ROOT / 'docs' / 'neat_lander3d_champion.npz'


def test_champion_round_trips(neat_champion):
    """The recorded Lander3D champion loads through compat/convert.py and
    writes back bit for bit, dtypes kept."""
    g = convert.genome_from_numpy(neat_champion, CPU)
    back = convert.genome_to_numpy(g)
    with np.load(neat_champion) as f:
        assert list(back) == list(f.files)
        for k in f.files:
            assert back[k].dtype == f[k].dtype
            np.testing.assert_array_equal(back[k], f[k])


def test_champion_scores_as_in_jax(neat_champion):
    """The champion on 16 fresh Lander3D episodes (seed 77, episode 10000,
    999 steps) in float32, the port against JAX with x64 off: per-episode
    returns within 0.05 absolute (measured 2.7e-4 on returns of ~300: the
    float32 env's CPU sin/cos gap over 999 steps)."""
    cfg = ne.NeatConfig(hidden=16)
    with jax.enable_x64(False):
        jg = jne.Genome(**{k: jnp.asarray(v) for k, v in
                           np.load(neat_champion).items()})
        want_mean, want = jne.evaluate_champion(jg, 'Lander3D-v0',
                                                jne.NeatConfig(hidden=16),
                                                reps=16)
    g = convert.genome_from_numpy(neat_champion, CPU)
    mean, got = ne.evaluate_champion(g, 'Lander3D-v0', cfg, reps=16)
    assert got.dtype == torch.float32 and got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.05)
    assert abs(mean - want_mean) < 0.05


def test_learners_import_no_jax():
    """Importing the evolutionary learners, the adaptive controller, the
    evolve script and the controllers loads no JAX module."""
    code = ('import sys\n'
            'import gym_copter_tpu_torch.learn.neuroevolution\n'
            'import gym_copter_tpu_torch.learn.hyperneat\n'
            'import gym_copter_tpu_torch.learn.adaptive\n'
            'import gym_copter_tpu_torch.learn.evolve\n'
            'import gym_copter_tpu_torch.control.pid\n'
            'import gym_copter_tpu_torch.control.heuristics\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "gym_copter_tpu")]\n'
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
