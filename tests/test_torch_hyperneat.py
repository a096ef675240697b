"""The port's HyperNEAT (gym_copter_tpu_torch/learn/hyperneat.py) against
the JAX package's (gym_copter_tpu/learn/hyperneat.py): the substrate bit
for bit, the CPPN population's init, decoding, one `evolve` from identical
inputs, a short evolution, the recorded Lander3D champion carried across and
evaluated on both sides, and the mirrors of tests/test_hyperneat.py."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_copter_tpu.learn import hyperneat as jhn
from gym_copter_tpu_torch.compat import convert
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.learn import hyperneat as hn

CHAMPION = Path(__file__).resolve().parents[1] / 'docs' / \
    'hyperneat_lander3d_champion.npz'
CPU = torch.device('cpu')
KW = dict(pop_size=8, episode_reps=2, cppn_hidden=8, substrate_hidden=4,
          max_steps=50, topk=2, holdout_reps=2)
CFG, JCFG = hn.HyperNeatConfig(**KW), jhn.HyperNeatConfig(**KW)
TIED = np.array([3.0, 1.0, 3.0, 2.0, 1.0, 3.0, 0.0, 2.0])


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread (see test_torch_neuroevolution.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize('x64', [True, False], ids=['float64', 'float32'])
def test_substrate_is_exact(x64):
    """Every coordinate of the Lander3D (12, 4, 8) and Lander2D (6, 2, 4)
    substrates equals JAX's bit for bit: JAX's `linspace` as XLA compiles
    it (core/device.py), where `torch.linspace` differs in the last bit."""
    dtype = torch.float64 if x64 else torch.float32
    with jax.enable_x64(x64):
        for sizes in ((12, 4, 8), (6, 2, 4), (10, 4, 16)):
            want = jhn.make_substrate(*sizes)
            got = hn.make_substrate(*sizes, dtype=dtype, device=CPU)
            for a, b in zip(want, got):
                assert b.dtype == dtype
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_init_matches_jax_and_decoder_phenotype():
    """Same key: masks and activations equal, weights within the `normal`
    gap (measured 2.8e-15); the decoded phenotype (a neuroevolution.Genome)
    of the same CPPNs within 1e-12 (measured 2.7e-15), with its shapes,
    binary masks and the max_weight band of test_hyperneat.py."""
    jc = jhn.init_cppn_population(jax.random.PRNGKey(0), JCFG)
    tc = hn.init_cppn_population(prng.PRNGKey(0, CPU), CFG, torch.float64)
    for name, a, b in zip(jc._fields, jc, tc):
        if name[0] in 'ma':
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            assert _max_abs(a, b) < 1e-14
    assert tc.act_sel.dtype == torch.int32
    want = jhn.make_decoder(jhn.make_substrate(6, 2, 4), JCFG)(jc)
    got = hn.make_decoder(hn.make_substrate(6, 2, 4, torch.float64, CPU),
                          CFG)(convert.cppn_from_numpy(jc, CPU))
    P, H, I, A = 8, 4, 6, 2
    assert got.w_in.shape == (P, H, I) and got.w_rec.shape == (P, H, H)
    assert got.w_out.shape == (P, A, H) and got.w_dir.shape == (P, A, I)
    assert got.b_h.shape == (P, H) and got.b_out.shape == (P, A)
    for name, a, b in zip(want._fields, want, got):
        assert _max_abs(a, b) < 1e-12, name
        if name.startswith('m'):
            assert set(np.unique(b.numpy())) <= {0.0, 1.0}
    assert float(got.w_in.abs().max()) <= CFG.max_weight + 1e-6


def test_decoder_is_coordinate_function():
    """Mirror: the decoded weight between two nodes is the CPPN at their
    coordinates."""
    cppn = hn.init_cppn_population(prng.PRNGKey(1, CPU), CFG)
    sub = hn.make_substrate(6, 2, CFG.substrate_hidden, device=CPU)
    g = hn.make_decoder(sub, CFG)(cppn)
    coord = torch.cat([sub.inputs[0], sub.hidden[0]])[None, :]
    expect = CFG.max_weight * torch.tanh(hn._cppn_forward(cppn, coord)[:, 0,
                                                                        0])
    torch.testing.assert_close(g.w_in[:, 0, 0], expect, rtol=1e-6, atol=0)


@pytest.mark.parametrize('seed', [3, 11])
def test_evolve_matches_jax(seed):
    """One float64 evolve from identical CPPNs with a tied fitness: masks,
    activations and the elites (genomes 0 and 2, the stable order) equal,
    weights within 1e-12 (measured 1.6e-15)."""
    jc = jhn.init_cppn_population(jax.random.PRNGKey(0), JCFG)
    want = jhn.make_evolve_fn(JCFG)(jc, jnp.asarray(TIED),
                                    jax.random.PRNGKey(seed))
    tc = convert.cppn_from_numpy(jc, CPU)
    got = hn.make_evolve_fn(CFG)(tc, torch.from_numpy(TIED),
                                 prng.PRNGKey(seed, CPU))
    for name, a, b in zip(want._fields, want, got):
        if name[0] in 'ma':
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
        else:
            assert _max_abs(a, b) < 1e-12, name
    for new, old in zip(got, tc):
        assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[2])
    assert set(np.unique(got.act_sel.numpy())) <= {0, 1, 2}


def test_short_evolution_runs_end_to_end():
    """Mirror: 3 generations on Lander1D-v0, finite history, the champion
    evaluates on 4 fresh episodes."""
    champ, hist, _ = hn.evolve_population('Lander1D-v0', CFG,
                                          max_generations=3, seed=0,
                                          callback=lambda r: None,
                                          device=CPU)
    assert champ is not None and len(hist) == 3
    assert list(hist[0]) == ['generation', 'best_fitness', 'mean_fitness',
                             'holdout_best']
    for h in hist:
        assert np.isfinite(h['best_fitness'])
        assert np.isfinite(h['holdout_best'])
    mean, per = hn.evaluate_champion(champ, 'Lander1D-v0', CFG, reps=4)
    assert np.isfinite(mean) and per.shape == (4,)


def test_champion_round_trips_and_scores_as_in_jax():
    """The recorded Lander3D champion loads through compat/convert.py and
    writes back bit for bit (act_sel int32); on 16 fresh episodes (seed 77,
    episode 10000, 999 steps) in float32 its per-episode returns are within
    0.05 of JAX's with x64 off (measured 2.1e-4 on returns of ~315)."""
    c = convert.cppn_from_numpy(CHAMPION, CPU)
    back = convert.cppn_to_numpy(c)
    with np.load(CHAMPION) as f:
        assert list(back) == list(f.files)
        for k in f.files:
            assert back[k].dtype == f[k].dtype
            np.testing.assert_array_equal(back[k], f[k])
        jc = jhn.CPPNGenome(**{k: f[k] for k in f.files})
    with jax.enable_x64(False):
        jc = jhn.CPPNGenome(*(jnp.asarray(v) for v in jc))
        want_mean, want = jhn.evaluate_champion(jc, 'Lander3D-v0',
                                                jhn.HyperNeatConfig(),
                                                reps=16)
    mean, got = hn.evaluate_champion(c, 'Lander3D-v0', hn.HyperNeatConfig(),
                                     reps=16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.05)
    assert abs(mean - want_mean) < 0.05
