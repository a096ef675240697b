"""The env step's kernel (gym_copter_tpu_torch/ops/csrc/env_step.cu) on the
CPU: its instantiation table covers every task of the registry, the
wrapper's tables agree with the source's, CPU tensors take the plain step
and launch nothing, and the step's three recorder regions stay.  The
kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import pytest
import torch

from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.tree import tree_leaves
from gym_copter_tpu_torch.envs import base, registry, tasks
from gym_copter_tpu_torch.utils import profiling

SOURCE = (Path(base.__file__).resolve().parent.parent / 'ops' / 'csrc'
          / 'env_step.cu').read_text()
# the action modes that `motors_from_action` maps before the launch
ACTION_MODES = ('clip01', 'rescale01', 'raw', 'demand3')


def _constant(name):
    return int(re.search(rf'constexpr int {name} = (\d+);', SOURCE)
               .group(1))


def _names(block_pattern):
    body = re.search(block_pattern, SOURCE, re.S).group(1)
    body = re.sub(r'//[^\n]*', '', body)
    return [w for w in re.findall(r'\b(\w+)\b', body)
            if w not in ('double', 'int')]


def _cases():
    return [(name, dtype) for name in tasks.ALL_TASKS
            for dtype in base.KERNEL_DTYPES]


@pytest.mark.parametrize('name,dtype', _cases(),
                         ids=[f'{n}-{str(d)[6:]}' for n, d in _cases()])
def test_instantiations_cover_every_task(name, dtype):
    """Every (kind, termination, action mode, lift model, dtype) that the
    registry and its presets yield has an instantiation of the kernel
    within the source's table, and constants the launch can pass."""
    spec, params = registry.resolve_params(name)
    index = base.kernel_instantiation(params, spec, dtype)
    size = (_constant('kNumTypes') * _constant('kNumKinds')
            * _constant('kNumTerminations'))
    assert 0 <= index < size
    assert spec.action_mode in ACTION_MODES
    assert params.lift_model in base.KERNEL_LIFT_MODELS
    c = base.kernel_constants(params, spec)
    assert c.n_obs + (3 if spec.kind == 'target' else 0) == spec.obs_size
    assert all(isinstance(v, float) for v in c[:base.N_KERNEL_FLOATS])
    assert all(isinstance(v, int) for v in c[base.N_KERNEL_FLOATS:])


def test_wrapper_tables_match_the_source():
    """The kinds, terminations and types in the order of the source's
    indices, the constants in the order of its struct Consts, and one
    pointer for each of its enum Pointer."""
    kinds = ('kLander', 'kLanderSimple', 'kHover', 'kAltHold', 'kTakeoff',
             'kDistance', 'kTarget')
    assert [_constant(k) for k in kinds] == list(range(len(kinds)))
    assert len(base.KERNEL_KINDS) == _constant('kNumKinds') == len(kinds)
    terms = ('kStandard', 'kSimple', 'kCrashOnly', 'kNone')
    assert [_constant(k) for k in terms] == list(range(len(terms)))
    assert len(base.KERNEL_TERMINATIONS) == _constant('kNumTerminations')
    assert len(base.KERNEL_DTYPES) == _constant('kNumTypes')
    fields = _names(r'struct Consts \{(.*?)\};')
    assert fields == list(base.KernelConstants._fields)
    assert _constant('kNumFloat') == base.N_KERNEL_FLOATS
    assert _constant('kNumInt') == (len(base.KernelConstants._fields)
                                    - base.N_KERNEL_FLOATS)
    pointers = _names(r'enum Pointer \{(.*?)\};')
    assert pointers[-1] == 'kNumPointers' and len(pointers) - 1 == 26


@pytest.mark.parametrize('name', ['Lander3D-v0', 'Lander3DSimple-v0',
                                  'Target-v0'])
def test_cpu_takes_the_plain_step(name, monkeypatch):
    """On CPU tensors `step` is `step_reference`, bit for bit, and neither
    builds nor launches the kernel."""
    def refuse():
        raise AssertionError('the CPU must not load the kernel')

    monkeypatch.setattr(base, '_kernel_library', refuse)
    spec, params = registry.resolve_params(name)
    params = params._replace(task=params.task._replace(max_steps=3))
    key = prng.PRNGKey(5, 'cpu')
    ids = torch.arange(8, dtype=torch.int32)
    state, _ = base.reset(key, ids, torch.zeros(8, dtype=torch.int32),
                          params, spec)
    launches = base.step_kernel.launches
    gen = torch.Generator().manual_seed(1)
    ended = torch.zeros(8, dtype=torch.bool)
    for _ in range(5):
        act = torch.rand((spec.action_size, 8), generator=gen)
        got = base.step(state, act, key, ids, params, spec)
        want = base.step_reference(state, act, key, ids, params, spec)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        state, ended = got[0], ended | got[1].done
    assert bool(ended.all())  # every env went through the reset
    assert base.step_kernel.launches == launches


def test_step_keeps_its_three_regions():
    """With the recorder's count stub (tests/test_torch_recorder.py) the
    step's region boundaries give the transition, the reset draw and the
    select, in that order."""
    nodes = iter(range(0, 100, 10))
    spec, params = registry.resolve_params('Lander3D-v0')
    key = prng.PRNGKey(0, 'cpu')
    ids = torch.arange(4, dtype=torch.int32)
    state, _ = base.reset(key, ids, torch.zeros(4, dtype=torch.int32),
                          params, spec)
    profiling.clear()
    try:
        with profiling.counting('g', count=lambda: next(nodes)) as rec:
            base.step(state, torch.full((4, 4), 0.5), key, ids, params,
                      spec)
        assert list(rec.regions) == ['env.transition', 'env.reset_draw',
                                     'env.select']
        assert all(n == 10 for n in rec.regions.values())
    finally:
        profiling.clear()
