"""The yardstick's arithmetic on fixed inputs: rates, percentiles,
spreads, FLOPs and roofline shares, the trace's busy and idle reading and
the comparisons' gaps."""


import pytest
import torch

from port_bench import compare, trace
from port_bench.harness import Manifest
from port_bench.reference import counts


def test_rate_and_percentiles():
    assert counts.rate(39, 524288, 10.0) == pytest.approx(2044723.2)
    xs = list(range(1, 101))
    assert counts.percentile(xs, 50) == pytest.approx(50.5)
    assert counts.percentile(xs, 99) == pytest.approx(99.01)
    assert counts.percentile([7.0], 99) == 7.0
    with pytest.raises(ValueError):
        counts.rate(1, 1, 0.0)


def test_ppo_flops_of_the_recipe():
    fwd = counts.mlp_forward_flops(10, 128, 4)
    assert fwd == 2 * ((10 * 128 + 128 * 128 + 128 * 4)
                       + (10 * 128 + 128 * 128 + 128))
    flops = counts.ppo_update_flops(10, 128, 4, 4096, 128, 4)
    assert flops == fwd * 524288 * 13 + 158 * 524288
    assert flops == pytest.approx(4.90e11, rel=2e-3)


def test_mfu_reader():
    read = Manifest.reader('ppo.step_mfu_pct')
    layers = {'phase_ms': [[186.0, 0.6, 71.4], [186.0, 0.6, 71.4]],
              'flops_per_update': 4.9e11}
    assert read(layers) == pytest.approx(100 * 4.9e11 / 0.258 / 67e12)


def test_fused_roofline():
    bound = counts.fused_bound_s(4096, 10000)
    assert bound == pytest.approx(158 * 4096 * 1e4 / 67e12)
    assert counts.FUSED_WORDS_PER_ENV == 54
    read = Manifest.reader('fused_rollout_roofline')
    assert read({'kernel_s': 4 * 6.8e-3, 'kernel_calls': 4,
                 'bound_s': bound}) == pytest.approx(100 * bound / 6.8e-3)
    assert read({'bound_s': bound}) is None


def test_phase_and_node_readers():
    layers = {'phase_ms': [[1.0, 0.1, 3.0], [2.0, 0.1, 5.0],
                           [9.0, 0.1, 4.0]],
              'graph_nodes': {'rollout_step': (1213, 1200), 'gae': (500, 490),
                              'update': (35455, 35303),
                              'rollout_steps': 128}}
    assert Manifest.reader('ppo.rollout_ms')(layers) == 2.0
    assert Manifest.reader('ppo.update_ms')(layers) == 4.0
    assert Manifest.reader('graph.nodes_per_update')(layers) == \
        128 * 1213 + 500 + 35455


def _x(name, cat, ts, dur):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur}


def test_trace_busy_idle_and_gaps():
    events = [_x('step', 'cpu_op', 0, 100),
              _x('cudaGraphLaunch', 'cuda_runtime', 5, 5),
              _x('k1', 'kernel', 10, 20), _x('k2', 'kernel', 25, 15),
              _x('cudaStreamSynchronize', 'cuda_runtime', 45, 20),
              _x('k1', 'kernel', 70, 10)]
    s = trace.summarize(events)
    assert s['busy_s'] == pytest.approx(40e-6)
    assert s['window_s'] == pytest.approx(100e-6)
    assert s['device_ops'][0] == ['k1', pytest.approx(30e-6)]
    gaps = dict(s['idle_gaps'])
    assert gaps['cudaStreamSynchronize'] == pytest.approx(30e-6)
    assert gaps['cudaGraphLaunch'] == pytest.approx(10e-6)
    assert gaps['step'] == pytest.approx(20e-6)
    assert trace.summarize([_x('step', 'cpu_op', 0, 1)]) is None


def test_idle_readers_use_the_unprofiled_window():
    # two updates of 250 + 0.5 + 10 ms of events in 0.5222 s of host time
    train = {'loop': 'train', 'phase_ms': [[250.0, 0.5, 10.0]] * 2,
             'window_s': 0.5222}
    read = Manifest.reader('device.idle_pct.train')
    assert read(train) == pytest.approx(100 * (1 - 0.521 / 0.5222))
    assert read(dict(train, loop='fused')) is None
    assert read({'loop': 'train', 'phase_ms': [[1.0, 1.0, 1.0]]}) is None
    # 16 profiled calls busy 0.108 s; the window 1,470 calls in 10.0 s
    fused = {'loop': 'fused', 'profile': {'busy_s': 0.108},
             'kernel_calls': 16, 'window_calls': 1470, 'window_s': 10.0}
    read = Manifest.reader('device.idle_pct.rollout')
    assert read(fused) == pytest.approx(100 * (1 - 6.75e-3 * 147))
    # 300 profiled steps busy 0.27 s; the window 9,500 steps in 10.0 s
    single = {'loop': 'single', 'profile': {'busy_s': 0.27},
              'traced_steps': 300, 'window_steps': 9500, 'window_s': 10.0}
    read = Manifest.reader('device.idle_pct.single')
    assert read(single) == pytest.approx(100 * (1 - 0.9e-3 * 950))
    assert read(dict(single, profile=None)) is None


def test_rollout_mfu_is_the_window_over_the_peak():
    read = Manifest.reader('rollout.step_mfu_pct')
    layers = {'loop': 'fused', 'env_steps_per_call': 4096 * 10000,
              'window_calls': 1470, 'window_s': 10.0}
    assert read(layers) == pytest.approx(
        100 * 158 * 4096e4 * 1470 / 10.0 / 67e12)
    assert read({'loop': 'fused'}) is None


def test_gaps():
    assert compare.rel(2.0, 2.0) == 0.0
    assert compare.rel(2.5, 2.0) == pytest.approx(0.25)
    a = [torch.ones(4), torch.full((2,), 1e-9)]
    assert compare.leaf_norm_gap(a, a) == 0.0
    b = [torch.ones(4) * 1.5, torch.full((2,), 2e-9)]
    # the first leaf 50 % apart; the tiny leaf measured against the median
    assert compare.leaf_norm_gap(b, a) == pytest.approx(0.5)
    # a state left unchanged reads 1
    assert compare.leaf_norm_gap([torch.zeros(4)], [torch.ones(4)]) == 1.0
    assert compare.still_leaves([1.0, 2.0, 1e-6]) == {2}
    assert compare.max_gap(torch.tensor([1.0, 100.0]),
                           torch.tensor([1.5, 101.0])) == pytest.approx(1 / 3)
    assert compare.max_gap(torch.tensor([float('nan')]),
                           torch.tensor([1.0])) == float('inf')


def test_tf32_rounding():
    from port_bench.reference.ppo import round_tf32
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -10,
                      3.0])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -1.0 - 2 ** -10,
                                      3.0]
