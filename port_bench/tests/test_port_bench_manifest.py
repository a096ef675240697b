"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from port_bench import harness

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}
M = harness.Manifest()
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}


def test_top_level():
    d = M.data
    assert set(d) == KEYS
    assert d['paths'] == ['port_bench']
    assert 1 <= d['run_seconds'] <= 51
    assert len(json.dumps(d)) < 64 * 1024
    names = [x['name'] for part in ('configs', 'workloads', 'end_to_end',
                                    'per_layer') for x in d[part]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize('cell', [w['name'] for w in M.data['workloads']])
def test_cell_finds_its_files(cell):
    w = M.cell(cell)
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert w['chips'] == 1 and len(w['why']) <= 200
    config = M.config(w['config'])
    assert config['name'] == w['config'] and config['reduced'] == []
    traffic = M.traffic(w['traffic'])
    assert (harness.ROOT / 'loops' / f'{traffic["loop"]}.py').is_file()
    e2e = [m['name'] for m in M.end_to_end(cell)]
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert M.per_layer(cell)
    assert (w['config'], w['traffic']) not in [
        (v['config'], v['traffic']) for v in M.data['workloads']
        if v['name'] != cell]


@pytest.mark.parametrize('metric', M.data['end_to_end'],
                         ids=lambda m: m['name'])
def test_end_to_end_metric(metric):
    assert UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    assert metric['source'] in ('host_clock', 'device_trace')
    assert 0.01 <= metric['bound'] <= 0.25


@pytest.mark.parametrize('metric', M.data['per_layer'],
                         ids=lambda m: m['name'])
def test_per_layer_metric_has_a_reader(metric):
    assert UNIT.match(metric['unit'])
    assert metric['source'] in SOURCES
    assert metric['moves'] in [m['name'] for m in M.data['end_to_end']]
    for cell in metric['workloads']:
        assert metric['moves'] in [m['name'] for m in M.end_to_end(cell)]
    read = M.reader(metric['name'])
    assert read({}) is None


def test_config_files_are_under_paths():
    files = [c['file'] for c in M.data['configs']]
    assert len(files) == len(set(files))
    assert all(f.startswith('port_bench/configs/') for f in files)


def test_a_per_layer_metric_without_a_list_goes_to_every_cell_of_its_moves(
        tmp_path):
    data = json.loads(json.dumps(M.data))
    data['per_layer'].append({
        'name': 'x.any', 'unit': 'ms', 'better': 'lower',
        'source': 'program_span', 'layer': 'device',
        'moves': 'train_env_steps_per_s'})
    path = tmp_path / 'BENCHMARK.json'
    path.write_text(json.dumps(data))
    m = harness.Manifest(path)
    for w in data['workloads']:
        names = [x['name'] for x in m.per_layer(w['name'])]
        reports = 'train_env_steps_per_s' in [
            x['name'] for x in m.end_to_end(w['name'])]
        assert ('x.any' in names) == reports
