"""The port's recorder (gym_copter_tpu_torch/utils/profiling.py, last
section): off, it records nothing and adds no CUDA event, synchronize or
`record_function`; on, spans nest by unit of work and change no output;
device events are placed on the host clock through one anchor; the
`marks=` contract of `TrainStep.run`; the per-capture node counters; and
the benchmark's readers of them (port_bench/spans.py).  On the CPU and
small, but for the one `cuda` test, which counts the production graphs on
the card with the recorder on and off:

    python3 -m pytest -q --noconftest -m cuda tests/test_torch_recorder.py
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import gym_copter_tpu_torch as gt
from gym_copter_tpu_torch.compat.single import SingleCopterEnv
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.tree import tree_leaves
from gym_copter_tpu_torch.learn import ppo
from gym_copter_tpu_torch.ops import fused_rollout as fr
from gym_copter_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _step(device='cpu', num_envs=16, **kw):
    cfg = ppo.PPOConfig(**{**dict(rollout_steps=4, hidden=8, minibatches=2,
                                  epochs=1, target_kl=0.015), **kw})
    env = gt.make('Lander3D-v0', num_envs=num_envs, device=device)
    step, opt = ppo.make_train_step(env.params, env.spec, cfg,
                                    prng.PRNGKey(1, device), env.env_ids)
    ts = ppo.init_train_state(prng.PRNGKey(0, device), env.params, env.spec,
                              cfg, num_envs, opt)
    return step, ts


def _same(a, b):
    ta, tb = tree_leaves(a), tree_leaves(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def _fused_call():
    env = gt.make('Lander3D-v0', num_envs=128, device='cpu')
    state, _ = env.reset()
    action = torch.full((4, 128), 1.625e-2)
    return fr.fused_rollout(state, action, 3, env.params, env.spec, seed=7)


def _single_steps(n=3):
    env = SingleCopterEnv('Lander-v0', device='cpu')
    env.reset(seed=3)
    return [env.step(np.full(4, 1.625e-2, np.float32)) for _ in range(n)]


@pytest.fixture
def fresh():
    """An empty recorder, and no anchor from another test."""
    profiling.clear()
    profiling._anchor = None
    yield
    profiling.clear()
    profiling._anchor = None


def _refuse(*a, **k):
    raise AssertionError('the recorder is off: nothing may call this')


def test_off_records_nothing(fresh, monkeypatch):
    """Off (no `spans()`, no profiler), the train step, the B = 1 step and
    the fused call record no span and call no `record_function`, CUDA
    event, synchronize or node count."""
    monkeypatch.setattr(profiling._torch_profiler, 'record_function',
                        _refuse)
    monkeypatch.setattr(torch.cuda, 'Event', _refuse)
    monkeypatch.setattr(torch.cuda, 'synchronize', _refuse)
    monkeypatch.setattr(profiling, 'capture_nodes', _refuse)
    assert not profiling.recording()
    step, ts = _step()
    step(step(ts)[0])
    _single_steps()
    _fused_call()
    assert profiling.snapshot() == {'spans': [], 'captures': []}


def test_spans_nest_and_change_no_output(fresh):
    """Inside `spans()` every train step is a `ppo.step` unit with its
    three phases as children, in order, each step a new unit; the B = 1
    step and the fused call are units with their children; and every
    output is bit-equal to the unrecorded one."""
    step, ts = _step()
    off = [step(ts)]
    off.append(step(off[0][0]))
    single_off, fused_off = _single_steps(), _fused_call()
    with profiling.spans():
        assert profiling.recording()
        on = [step(ts)]
        on.append(step(on[0][0]))
        single_on, fused_on = _single_steps(), _fused_call()
    assert not profiling.recording()
    for (a, ma), (b, mb) in zip(off, on):
        assert _same(a, b) and _same(ma, mb)
    assert _same(fused_off, fused_on)
    for a, b in zip(single_off, single_on):
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]

    spans = profiling.snapshot()['spans']
    by_id = {s['id']: s for s in spans}
    roots = [s for s in spans if s['parent'] is None]
    assert [r['name'] for r in roots] == (
        ['ppo.step'] * 2 + ['single.step'] * 3 + ['fused.rollout'])
    assert len({r['unit'] for r in roots}) == len(roots)
    want = {'ppo.step': ['ppo.rollout', 'ppo.gae', 'ppo.update'],
            'single.step': ['single.action_to_device', 'single.eager_step',
                            'single.obs_to_host'],
            'fused.rollout': ['fused.prepare', 'fused.launch']}
    for r in roots:
        assert r['unit'] == r['id']
        kids = sorted((s for s in spans if s['parent'] == r['id']),
                      key=lambda s: s['start_ns'])
        assert [k['name'] for k in kids] == want[r['name']]
        for k in kids:
            assert k['unit'] == r['id'] and by_id[k['parent']] is r
            assert r['start_ns'] <= k['start_ns'] <= k['end_ns'] \
                <= r['end_ns']
        for a, b in zip(kids, kids[1:]):
            assert a['end_ns'] <= b['start_ns']
    assert not any('device_ns' in s for s in spans)  # no card here


def test_spans_open_record_functions_while_the_profiler_records(fresh):
    """The recorder is on while `torch.profiler` records, without
    `spans()`: each span is a `record_function` of its name in the trace,
    and kept."""
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        _fused_call()
    assert not profiling.recording()
    names = {e.name for e in prof.events()}
    assert {'fused.rollout', 'fused.prepare', 'fused.launch'} <= names
    assert [s['name'] for s in profiling.snapshot()['spans']] == [
        'fused.prepare', 'fused.launch', 'fused.rollout']


def test_phases_close_their_spans_when_the_step_raises(fresh):
    """A step that raises inside a `Phases` block still closes its phase
    and its unit, so the next step's spans do not nest under them."""
    with profiling.spans():
        with pytest.raises(RuntimeError):
            with profiling.Phases('u') as phases:
                phases.next('a')
                raise RuntimeError('step failed')
        assert profiling._open == []
        with profiling.Phases('v') as phases:
            phases.next('b')
            phases.next()
    spans = {s['name']: s for s in profiling.snapshot()['spans']}
    assert spans['a']['parent'] == spans['u']['id']
    assert spans['v']['parent'] is None
    assert spans['b']['parent'] == spans['v']['id']


class FakeDevice:
    """A device clock in ns, and events that read it when recorded (each
    record then advances it by `tick` ns)."""

    def __init__(self, tick=0):
        self.now, self.tick = 0, tick
        self.log = []

    def event(self, **kw):
        device = self

        class Event:
            def record(self):
                self.t = device.now
                device.now += device.tick
                device.log.append(self)

            def elapsed_time(self, other):
                return (other.t - self.t) * 1e-6  # ms

            def synchronize(self):
                pass

        return Event()


def test_anchor_places_device_events_on_the_host_clock():
    """The anchor is an event recorded right after a synchronize beside the
    host clock's reading: an event recorded d ns of device time later sits
    d ns after that reading, whatever the two clocks' origins."""
    dev, host = FakeDevice(), {'now': 5_000_000_000}
    synced = []
    dev.now = 123_456_789
    anchor = profiling.Anchor.take(clock=lambda: host['now'],
                                   make_event=dev.event,
                                   synchronize=lambda: synced.append(1))
    assert synced == [1] and anchor.at_ns == 5_000_000_000
    later = dev.event()
    dev.now += 2_500_000  # 2.5 ms of device time
    later.record()
    assert anchor.host_ns(later) == 5_002_500_000
    early = dev.event()
    dev.now -= 4_000_000
    early.record()
    assert anchor.host_ns(early) == 4_998_500_000


def test_marks_yield_four_events_per_update_in_order(fresh, monkeypatch):
    """`TrainStep.run(..., marks=)` appends 4 recorded events per update,
    in the order recorded, with the recorder off and on; on, the phases'
    device intervals are those same events, placed through the anchor."""
    dev = FakeDevice(tick=7)
    monkeypatch.setattr(torch.cuda, 'Event', dev.event)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda: None)
    step, ts = _step()

    def run(n, ts):
        marks = []
        for _ in range(n):
            before = len(marks)
            ts = step.run(ts, graphed=False, marks=marks)[0]
            dev.now += 1000
            assert len(marks) - before == 4
        return marks

    marks = run(2, ts)
    assert len(marks) == 8 and marks == dev.log
    dev.log.clear()
    with profiling.spans():
        marks = run(2, ts)
    anchor = dev.log[0]  # the recorder's first event is its anchor
    assert anchor is profiling._anchor.event
    assert len(marks) == 8 and marks == dev.log[1:]
    phases = [s for s in profiling.snapshot()['spans']
              if s['name'] in ('ppo.rollout', 'ppo.gae', 'ppo.update')]
    assert len(phases) == 6
    for i, s in enumerate(phases):
        start, end = marks[i + i // 3], marks[i + i // 3 + 1]
        assert s['device_ns'] == end.t - start.t
        assert s['device_start_ns'] == (profiling._anchor.at_ns + start.t
                                        - anchor.t)


def test_counting_counts_nodes_per_region(fresh, monkeypatch):
    """Inside `counting` every `region` boundary reads the capture's node
    count: the nodes between two boundaries go to the region opened by the
    first, summed over its occurrences; what no region holds counts in the
    graph's nodes only.  Outside it a boundary reads nothing."""
    nodes = iter([0, 3, 10, 14, 20, 26, 30, 31])
    monkeypatch.setattr(profiling, 'capture_nodes', _refuse)
    profiling.region('env.transition')  # no capture: nothing read
    with profiling.counting('g', count=lambda: next(nodes)) as rec:
        profiling.region('a')      # 3 (3 nodes before it: no region)
        profiling.region('b')      # 10
        profiling.region(None)     # 14
        profiling.region('a')      # 20
        profiling.region('b')      # 26
        profiling.region(None)     # 30
    assert profiling._counting is None
    profiling.captured(rec, 0.25)
    assert profiling.snapshot()['captures'] == [
        {'graph': 'g', 'seconds': 0.25, 'nodes': 31,
         'regions': {'a': 7 + 6, 'b': 4 + 4}, 'counted': True}]
    profiling.region('a')


def test_counting_gives_up_where_nodes_cannot_be_read(fresh):
    with profiling.counting('g', count=lambda: None) as rec:
        profiling.region('a')
        profiling.region(None)
    assert not rec.counted and rec.nodes is None


def _reader(name):
    path = os.path.join(REPO, 'port_bench', 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'recorder_test_{name.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


SNAPSHOT = {
    'spans': [],
    'captures': [
        {'graph': 'ppo.rollout_step', 'seconds': 0.5, 'nodes': 1,
         'regions': {}, 'counted': True},
        {'graph': 'ppo.rollout_step', 'seconds': 0.25, 'nodes': 1213,
         'regions': {'ppo.policy': 400, 'env.transition': 300,
                     'env.reset_draw': 420, 'env.select': 49},
         'counted': True},
        {'graph': 'ppo.update', 'seconds': 4.0, 'nodes': 35455,
         'regions': {'ppo.loss_grad': 9000, 'ppo.optimizer': 22000},
         'counted': True},
        {'graph': 'ppo.gae', 'seconds': 0.125, 'nodes': 500,
         'regions': {}, 'counted': False}]}

READINGS = [('graph.env_step_nodes', 'train', 769),
            ('graph.reset_draw_nodes', 'train', 420),
            ('graph.optimizer_nodes_per_update', 'train', 22000),
            ('graph.capture_s', 'train', 4.875),
            ('graph.capture_s', 'single', 4.875)]


@pytest.mark.parametrize('name,loop,value', READINGS,
                         ids=[f'{n}-{lp}' for n, lp, _ in READINGS])
def test_readers_read_the_recorder(name, loop, value, monkeypatch):
    """Each new per-layer metric reads the recorder's snapshot in its own
    loop's cells, and nothing elsewhere, where the recorder holds nothing
    or where the program has no recorder (an older program)."""
    from port_bench import spans

    read = _reader(name)
    monkeypatch.setattr(spans, 'snapshot', lambda: SNAPSHOT)
    assert read({'loop': loop}) == pytest.approx(value)
    assert read({'loop': 'fused'}) is None and read({}) is None
    monkeypatch.setattr(spans, 'snapshot',
                        lambda: {'spans': [], 'captures': []})
    assert read({'loop': loop}) is None
    monkeypatch.setattr(spans, 'snapshot', lambda: None)
    assert read({'loop': loop}) is None


def test_spans_reader_finds_no_recorder_in_an_older_program(monkeypatch):
    """port_bench/spans.py against a program whose profiling module lacks
    `snapshot`: None, not an error."""
    from port_bench import spans

    monkeypatch.delattr(profiling, 'snapshot')
    assert spans.snapshot() is None
    assert spans.capture_s() is None
    assert spans.region_nodes('ppo.update', ['ppo.optimizer']) is None


@pytest.mark.cuda
def test_production_graphs_count_the_same_with_the_recorder_on():
    """On the card: the train step's three graphs and the B = 1 step's
    graph, captured with the recorder off and inside `spans()`, have the
    same nodes and the same nodes per region; the regions sum to no more
    than the graph; the env step is a few nodes of its transition region,
    its kernel's launch among them, and its reset draw and select, inside
    the launch, hold none.  On, the rollout's host loop is a span and the
    B = 1 step has a device time."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    profiling.clear()
    profiling._anchor = None
    action = np.full(4, 1.625e-2, np.float32)

    def capture():
        step, ts = _step('cuda', num_envs=256, rollout_steps=16, hidden=16,
                         minibatches=4, epochs=2)
        step(ts)
        env = SingleCopterEnv('Lander-v0')
        env.reset(seed=1)
        for _ in range(3):
            env.step(action)
        torch.cuda.synchronize()

    capture()
    with profiling.spans():
        capture()
    snap = profiling.snapshot()
    caps = snap['captures']
    names = ['ppo.rollout_step', 'ppo.gae', 'ppo.update', 'single.step']
    assert [c['graph'] for c in caps] == names * 2
    for off, on in zip(caps[:4], caps[4:]):
        assert off['counted'] and on['counted']
        assert off['nodes'] == on['nodes'] and off['regions'] == on['regions']
        assert sum(off['regions'].values()) <= off['nodes']
        assert off['seconds'] > 0
    assert caps[1]['regions'] == {}  # GAE marks no region
    env_regions = ('env.transition', 'env.reset_draw', 'env.select')
    for c in (caps[0], caps[3]):
        assert [c['regions'][r] for r in env_regions[1:]] == [0, 0]
        assert 0 < c['regions']['env.transition'] <= 8
    assert caps[0]['regions']['ppo.policy'] > 0
    assert caps[2]['regions']['ppo.optimizer'] > 0
    assert caps[2]['regions']['ppo.loss_grad'] > 0
    spans = snap['spans']
    assert sum(s['name'] == 'ppo.rollout.host_loop' for s in spans) == 1
    assert sum(s['name'] == 'graph.capture' for s in spans) == 4
    device = [s for s in spans
              if s['name'] == 'single.step' and 'device_ns' in s]
    assert len(device) == 3
    slack = 50_000  # ns: the anchor's reading beside its event
    for s in device:
        assert 0 < s['device_ns'] <= s['end_ns'] - s['start_ns']
        assert s['start_ns'] - slack <= s['device_start_ns'] \
            < s['device_end_ns'] <= s['end_ns'] + slack
    profiling.clear()
