"""The port's adaptive disturbance rejection (gym_copter_tpu_torch/learn/
adaptive.py) against the JAX package's (gym_copter_tpu/learn/adaptive.py),
and the mirror of tests/test_adaptive.py's thresholds over the same wind
sweep and 6000 steps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_copter_tpu.core import vehicles as jvehicles
from gym_copter_tpu.core.types import EnvParams as JEnvParams
from gym_copter_tpu.learn import adaptive as jadaptive
from gym_copter_tpu_torch.control.heuristics import hover_motor_value
from gym_copter_tpu_torch.core import vehicles
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.learn import adaptive

PARAMS = EnvParams(vehicle=vehicles.DJI_PHANTOM)
JPARAMS = JEnvParams(vehicle=jvehicles.DJI_PHANTOM)
WINDS = [-4.0, -2.0, 0.0, 2.0, 4.0]
CFG = adaptive.AdaptiveConfig()
CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread (see test_torch_neuroevolution.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rbf_features_match_jax():
    """The RBF centres are JAX's linspace bit for bit; the features of the
    same float32 altitudes within 2 ULP of JAX's exp, or 1e-30 where they
    underflow (measured: 11 % differ, by at most 6e-8 absolute)."""
    z = np.linspace(-1.0, 11.0, 101, dtype=np.float32)
    want = np.asarray(jadaptive.rbf_features(jnp.asarray(z),
                                             jadaptive.AdaptiveConfig()))
    got = adaptive.rbf_features(torch.from_numpy(z), CFG).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=1e-30)


@pytest.mark.parametrize('adapt', [True, False], ids=['adaptive', 'pd'])
def test_run_matches_jax(adapt):
    """500 steps of the wind sweep from the same start, float32 on both
    sides (as the JAX module runs): u_pd and u_extra within 1e-8 and the
    weights within 1e-9 (measured 3.7e-9, 2.8e-9 and 9.3e-10), the altitude
    within 1e-6 (measured 4.8e-7, one float32 ULP at 5 m, in 44-46 % of
    the entries).  The histories first differ at step 2, in u_pd from an
    equal altitude, which points at XLA's CPU code fusing the PD law's
    float32 products and sums into FMAs where torch rounds each; the closed
    loop carries the last bits on."""
    want = jadaptive.run(JPARAMS, jnp.asarray(WINDS), 500,
                         jadaptive.AdaptiveConfig(), adapt=adapt)
    got = adaptive.run(PARAMS, WINDS, 500, CFG, adapt=adapt, device=CPU)
    for k, atol in (('z', 1e-6), ('u_pd', 1e-8), ('u_extra', 1e-8),
                    ('weights', 1e-9)):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=atol, err_msg=k)
    every = adaptive.run(PARAMS, WINDS, 500, CFG, adapt=adapt,
                         record_every=10, device=CPU)
    assert torch.equal(every['z'], got['z'][::10])


def test_adaptation_beats_pd_and_learns_each_disturbance():
    """Mirror of test_adaptive.py over 6000 steps: the bare PD controller
    keeps an offset above 1 m, adaptation brings every plant within 0.2 m
    and below a fifth of PD's; the learned steady-state thrust is monotone
    in the wind, and the zero-wind plant's is within half of the hover
    thrust."""
    pd = adaptive.run(PARAMS, WINDS, 6000, CFG, adapt=False, device=CPU)
    ad = adaptive.run(PARAMS, WINDS, 6000, CFG, adapt=True, device=CPU)
    pd_err = adaptive.tracking_error(pd, CFG).numpy()
    ad_err = adaptive.tracking_error(ad, CFG).numpy()
    assert (pd_err > 1.0).all(), pd_err
    assert (ad_err < 0.2).all(), ad_err
    assert (ad_err < pd_err / 5.0).all()
    u_final = ad['u_extra'][-200:].mean(0).numpy()
    assert (np.diff(u_final) < 0).all() or (np.diff(u_final) > 0).all()
    hover = hover_motor_value(PARAMS)
    assert abs(float(u_final[2]) - hover) < 0.5 * hover
