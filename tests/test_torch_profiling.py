"""The port's timing and tracing (gym_copter_tpu_torch/utils/profiling.py),
the mirror of tests/test_profiling.py on a fake clock: each workload
advances the clock by what it would take, so no test sleeps or depends on
the machine's load."""

import json
import os

import pytest
import torch

from gym_copter_tpu_torch.utils import profiling


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_differential_throughput_cancels_fixed_overhead():
    """A fixed 30 ms per call and 0.2 ms per iteration: the differential
    estimate is the per-iteration cost exactly, the fixed cost cancels."""
    clock = FakeClock()

    def run(num_steps):
        clock.now += 30e-3 + 2e-4 * num_steps

    res = profiling.differential_steps_per_sec(run, 10, 60, batch=128,
                                               reps=3, clock=clock)
    assert res['ns_per_iter'] * 1e-9 == pytest.approx(2e-4, rel=1e-9)
    assert res['steps_per_sec'] == pytest.approx(128 / 2e-4, rel=1e-9)
    assert res['n_samples'] == 3 and res['rejected'] == 0
    assert res['spread_pct'] == pytest.approx(0.0, abs=1e-6)


def test_degenerate_samples_rejected_not_clamped():
    """Every other (t_lo, t_hi) pair takes the same time for both sizes: it
    is rejected and drawn again, never clamped into a huge throughput."""
    clock = FakeClock()
    calls = []

    def run(num_steps):
        calls.append(num_steps)
        pair = (len(calls) - 3) // 2  # after the 2 warm-up calls
        marginal = 0 if pair >= 0 and pair % 2 == 1 else 2e-5 * num_steps
        clock.now += 0.002 + marginal

    res = profiling.differential_steps_per_sec(
        run, 10, 500, batch=64, reps=4, min_marginal_s=1e-3, clock=clock)
    assert res['rejected'] == 3 and res['n_samples'] == 4
    for s in res['samples']:
        assert s == pytest.approx(64 / 2e-5, rel=1e-9)


def test_all_samples_rejected_raises():
    clock = FakeClock()

    def run(num_steps):
        clock.now += 0.002

    with pytest.raises(RuntimeError, match='rejected'):
        profiling.differential_samples(run, 10, 500, batch=64, reps=2,
                                       clock=clock)
    with pytest.raises(ValueError, match='no samples'):
        profiling.robust_stats([])


def test_robust_stats_mad_resists_outliers():
    stats = profiling.robust_stats([7.0, 7.1, 6.9, 7.05, 37.0])
    assert stats['median'] == 7.05
    assert stats['spread_pct'] < 5.0
    assert stats['n'] == 5


def test_timed_host_sync_means_over_reps():
    clock = FakeClock()
    calls = []

    def fn():
        calls.append(1)
        clock.now += 0.001

    d = profiling.timed_host_sync(fn, reps=3, clock=clock)
    assert len(calls) == 4  # 1 warm-up + 3 timed
    assert d == pytest.approx(0.001, rel=1e-12)


def _event(cat, name, ts, dur):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}


def test_device_busy_unions_the_device_intervals(tmp_path):
    """Overlapping kernels count once, copies count as busy, host events
    set the window; kernels are ranked by device time."""
    events = [_event('cpu_op', 'aten::add', 0, 10),
              _event('kernel', 'k1', 10, 20),      # 10-30
              _event('kernel', 'k2', 20, 20),      # 20-40, overlaps k1
              _event('gpu_memcpy', 'copy', 50, 10),  # 50-60
              _event('kernel', 'k1', 70, 5),       # 70-75
              _event('cuda_runtime', 'launch', 90, 10),  # window ends 100
              {'ph': 'i', 'name': 'marker', 'ts': 500}]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': events}))
    out = profiling.device_busy(str(path), top=2)
    assert out['window_us'] == 100 and out['busy_us'] == 45
    assert out['busy_share'] == pytest.approx(0.45)
    assert out['kernels'] == 3
    assert out['top'] == [['k1', 25.0, 2], ['k2', 20.0, 1]]


def test_cpu_trace_has_no_device_kernel(tmp_path):
    """`trace` on the CPU writes a Chrome trace of the block's operations;
    `device_busy` refuses it, since no kernel ran on a device."""
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64).add_(1)
    assert prof is not None
    data = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    assert any('add' in e.get('name', '') for e in data['traceEvents'])
    with pytest.raises(ValueError, match='no device kernel'):
        profiling.device_busy(str(tmp_path / profiling.TRACE_FILE))


def test_timeit_is_the_jax_scripts_differential():
    """One warm call of 2, then per rep n_lo and n_hi calls: the fixed cost
    of a call cancels; a probe is started before each rep and read after
    it."""
    clock = FakeClock()
    calls, probes = [], []

    def fn(n):
        calls.append(n)
        clock.now += 0.05 + 0.01 * n

    def probe():
        probes.append(('start', len(calls)))
        return lambda: {'rep': len(probes), 'calls': len(calls)}

    res = profiling.timeit(fn, reps=3, probe=probe, clock=clock)
    assert calls == [2] + [3, 13] * 3
    assert res['seconds'] == pytest.approx(0.01, rel=1e-9)
    assert res['samples'] == pytest.approx([0.01] * 3, rel=1e-9)
    assert res['spread_pct'] == pytest.approx(0.0, abs=1e-6)
    assert probes == [('start', 1), ('start', 3), ('start', 5)]
    assert res['beside'] == [{'rep': 1, 'calls': 3}, {'rep': 2, 'calls': 5},
                             {'rep': 3, 'calls': 7}]
    assert profiling.timeit(fn, reps=2, n_lo=1, n_hi=2,
                            clock=clock)['beside'] is None


H100_LINE = ('NVIDIA H100 80GB HBM3, 700.00 W, 1980 MHz, 1980 MHz, 312.45 W, '
             '41, 0x0000000000000000')


@pytest.mark.parametrize('reasons,names', [
    ('0x0000000000000000', []),
    ('0x0000000000000001', ['gpu_idle']),
    ('0x0000000000000024', ['sw_power_cap', 'sw_thermal_slowdown']),
    ('[N/A]', None)])
def test_parse_card(reasons, names):
    line = H100_LINE.replace('0x0000000000000000', reasons)
    card = profiling.parse_card(line)
    assert card['smi'] == 'NVIDIA H100 80GB HBM3, 700.00 W'
    assert card['name'] == 'NVIDIA H100 80GB HBM3'
    assert (card['power_limit_w'], card['sm_mhz'], card['max_sm_mhz'],
            card['power_draw_w'], card['temperature_c']) == (
        700.0, 1980.0, 1980.0, 312.45, 41.0)
    assert card['throttle_reasons'] == reasons and card['throttle'] == names


def test_parse_card_refuses_other_lines():
    with pytest.raises(ValueError, match='nvidia-smi printed'):
        profiling.parse_card('NVIDIA H100 80GB HBM3, 700.00 W')
    assert profiling.parse_card(H100_LINE.replace(
        '312.45 W', '[N/A]'))['power_draw_w'] is None


@pytest.mark.parametrize('old_name_refused', [False, True])
def test_card_asks_nvidia_smi(tmp_path, monkeypatch, old_name_refused):
    """`card` runs nvidia-smi with the card's index and the fields of
    parse_card; a driver that refuses the throttle field's older name is
    asked again with the newer one."""
    log = tmp_path / 'args.txt'
    fake = tmp_path / 'nvidia-smi'
    refuse = ('if echo "$@" | grep -q clocks_throttle_reasons; then '
              'echo \'Field "clocks_throttle_reasons.active" is not a valid '
              'field to query.\'; exit 2; fi\n' if old_name_refused else '')
    fake.write_text(f'#!/bin/sh\necho "$@" >> {log}\n{refuse}'
                    f'echo "{H100_LINE}"\n')
    fake.chmod(0o755)
    monkeypatch.setenv('PATH', f'{tmp_path}{os.pathsep}'
                       + os.environ.get('PATH', ''))
    card = profiling.card(3)
    assert card['smi'] == 'NVIDIA H100 80GB HBM3, 700.00 W'
    args = log.read_text().splitlines()
    assert all('--id=3' in a and '--format=csv,noheader' in a for a in args)
    assert len(args) == (2 if old_name_refused else 1)
    assert ('clocks_event_reasons.active' in args[-1]) == old_name_refused


def test_card_without_nvidia_smi_raises(tmp_path, monkeypatch):
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(FileNotFoundError):
        profiling.card()
