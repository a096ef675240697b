"""The port's orbax checkpoint format against the libraries the JAX package
writes it with: its zstd codec (gym_copter_tpu_torch/utils/zstd.py)
against `zstandard`, its OCDBT reader (utils/ocdbt.py) against
tensorstore, and its PyTree reader and writer (utils/orbax_format.py)
against orbax through gym_copter_tpu/utils/checkpoint.py, leaf for leaf
and bit for bit; and the JAX-written checkpoint of the card's [ckpt]
phase (tests/data/jax_orbax_lander3d/, made by
tests/make_jax_orbax_fixture.py) read by both packages."""

import hashlib
import json
import os
import shutil
from pathlib import Path

import google_crc32c
import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import given, settings, strategies as st

from gym_copter_tpu.envs import tasks as jtasks
from gym_copter_tpu.envs.registry import default_params
from gym_copter_tpu.learn import ppo as jppo
from gym_copter_tpu.utils import checkpoint as jcheckpoint
from gym_copter_tpu_torch.compat import convert
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.tree import tree_leaves
from gym_copter_tpu_torch.envs import registry
from gym_copter_tpu_torch.learn import optim, ppo
from gym_copter_tpu_torch.utils import checkpoint, ocdbt, orbax_format, zstd
from make_jax_orbax_fixture import leaves as _jax_leaves

CPU = torch.device('cpu')
DATA = Path(__file__).resolve().parent / 'data'
FIXTURE = DATA / 'jax_orbax_lander3d'


# ---------------------------------------------------------------- zstd

def _payload(name):
    rng = np.random.RandomState(0)
    if name == 'empty':
        return b''
    if name == 'random':
        return rng.bytes(5000)
    if name == 'runs':
        return b'a' * 1000 + b'b' * 3000 + b'abc' * 500 + bytes(range(256))
    if name == 'float32':  # several 128 KiB blocks of Huffman literals
        return rng.randn(70_000).astype(np.float32).tobytes()
    if name == 'small_alphabet':
        return bytes(rng.choice([65, 66, 67, 200], 20_000,
                                p=[.7, .1, .1, .1]).astype(np.uint8))
    if name == 'tokens':  # > 0x7F00 sequences in one block
        voc = [rng.bytes(3) for _ in range(2000)]
        return b''.join(voc[i] for i in rng.randint(0, 2000, 60_000))
    if name == 'overlaps':  # matches with offset < length, repeat offsets
        out = bytearray()
        while len(out) < 150_000:
            if out and rng.rand() < .6:
                off, n = rng.randint(1, min(len(out), 40) + 1), \
                    rng.randint(3, 60)
                for _ in range(n):
                    out.append(out[-off])
            else:
                out += rng.bytes(rng.randint(0, 5))
        return bytes(out)
    raise KeyError(name)


PAYLOADS = ['empty', 'random', 'runs', 'float32', 'small_alphabet', 'tokens',
            'overlaps']


@pytest.mark.parametrize('name', PAYLOADS)
def test_zstd_decodes_what_zstandard_writes(name):
    """Levels 1, 3 and 19, with and without the content size and the
    checksum, one frame and a streamed frame (no content size, as
    tensorstore writes): the port decodes every byte."""
    data = _payload(name)
    for level in (1, 3, 19):
        for size, check in ((True, False), (False, True)) + (
                ((True, True), (False, False)) if level == 3 else ()):
            c = zstandard.ZstdCompressor(level=level, write_checksum=check,
                                         write_content_size=size)
            assert zstd.decompress(c.compress(data)) == data, (level, size,
                                                                check)
    stream = zstandard.ZstdCompressor(level=3).compressobj()
    frame = stream.compress(data) + stream.flush()
    assert zstd.decompress(frame) == data


def test_zstd_frames_concatenated_skippable_and_rle_literals():
    """Several frames (one skippable) decode to their contents joined; a
    hand-made block of RLE literals and no sequences decodes as zstandard
    decodes it."""
    a = zstandard.ZstdCompressor(level=3).compress(b'hello ' * 100)
    skip = (0x184D2A53).to_bytes(4, 'little') + (5).to_bytes(4, 'little') \
        + b'12345'
    b = zstd.compress(b'world')
    assert zstd.decompress(a + skip + b) == b'hello ' * 100 + b'world'
    # frame header: single segment, 1-byte content size 20; one last
    # compressed block of 3 bytes: RLE literals 'Q' x 20, 0 sequences
    rle = (zstd.MAGIC.to_bytes(4, 'little') + bytes([0x20, 20])
           + (3 << 3 | 2 << 1 | 1).to_bytes(3, 'little')
           + bytes([20 << 3 | 1, ord('Q'), 0]))
    assert zstandard.ZstdDecompressor().decompress(rle) == b'Q' * 20
    assert zstd.decompress(rle) == b'Q' * 20


@pytest.mark.parametrize('n', [0, 1, 255, 256, 65_791, 65_792, 300_000])
def test_zstandard_reads_the_port_frames(n):
    """The port's raw-block frames (every content-size width, several
    blocks) decode in zstandard and in the port."""
    data = np.random.RandomState(n).bytes(n)
    frame = zstd.compress(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data


@settings(max_examples=40, deadline=None, database=None)
@given(parts=st.lists(st.tuples(st.binary(max_size=300),
                                st.integers(0, 20)), max_size=12),
       level=st.sampled_from([1, 3, 9, 19]))
def test_zstd_round_trips_hypothesis(parts, level):
    """Random chunks, each repeated a random number of times."""
    data = b''.join(chunk * k for chunk, k in parts)
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=True).compress(data)
    assert zstd.decompress(frame) == data


def test_zstd_rejects_corruption():
    data = _payload('overlaps')[:20_000]
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(data))
    bad = bytearray(frame)
    bad[-1] ^= 1  # the checksum
    with pytest.raises(zstd.ZstdError, match='checksum'):
        zstd.decompress(bytes(bad))
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(frame[:len(frame) // 2]))
    with pytest.raises(zstd.ZstdError, match='magic'):
        zstd.decompress(b'not zstd')
    # single segment, a 1-byte Dictionary_ID 7, content size 5, 'hello'
    with_dict = (zstd.MAGIC.to_bytes(4, 'little') + bytes([0x21, 7, 5])
                 + (5 << 3 | 1).to_bytes(3, 'little') + b'hello')
    with pytest.raises(zstd.ZstdError, match='dictionary'):
        zstd.decompress(with_dict)
    # a raw-content dictionary leaves no ID in the frame: its matches
    # reach before the frame
    raw_dict = zstandard.ZstdCompressor(dict_data=zstandard.ZstdCompressionDict(
        data[:2000], dict_type=zstandard.DICT_TYPE_RAWCONTENT)).compress(data)
    with pytest.raises(zstd.ZstdError, match='before the frame'):
        zstd.decompress(raw_dict)


def test_checksums_against_their_references():
    """CRC-32C against google_crc32c; XXH64 against its published value
    for empty input and through zstandard's checksummed frames above."""
    rng = np.random.RandomState(3)
    for n in (0, 1, 7, 100, 4096):
        data = rng.bytes(n)
        assert ocdbt.crc32c(data) == google_crc32c.value(data)
    assert zstd.xxh64(b'') == 0xEF46DB3751D8E999


# ---------------------------------------------------------------- OCDBT

def _mixed_tree():
    rng = np.random.RandomState(0)
    return {'a': (np.arange(128 * 128, dtype=np.float32) * .37).reshape(
                128, 128),
            'b': np.int32(7),
            'c': {'d': np.array([1, 2, 3], np.uint32), 'e': None,
                  'f': rng.randn(5, 3)},
            'g': np.bool_(True),
            'h': [np.arange(-3, 3, dtype=np.int64), rng.randn(7, 9, 4)
                  .astype(np.float32)]}


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    """OCDBT databases: orbax's root and per-process stores of a small
    tree; a tensorstore database of 5 commits with 200-byte nodes (B+tree
    interior nodes, indirect values, version tree nodes); and a root
    database holding a copy of a nested `ocdbt.process_0/` one."""
    root = tmp_path_factory.mktemp('ocdbt')
    jcheckpoint.save(str(root / 'orbax'), _mixed_tree())
    cfg = {'max_decoded_node_bytes': 200, 'max_inline_value_bytes': 8,
           'version_tree_arity_log2': 1}
    deep = ts.KvStore.open({'driver': 'ocdbt', 'config': cfg,
                            'base': f'file://{root}/deep/'}).result()
    for gen in range(5):
        with ts.Transaction() as txn:
            for i in range(12):
                deep.with_transaction(txn)[f'key/{gen}/{i:03d}'] = (
                    f'v{gen}.{i}' * (1 + i % 4)).encode()
    ctx = ts.Context()
    nested = {'driver': 'file', 'path': f'{root}/copied/ocdbt.process_0'}
    child = ts.KvStore.open({'driver': 'ocdbt', 'config': cfg,
                             'base': nested}, context=ctx).result()
    with ts.Transaction() as txn:
        for i in range(40):
            child.with_transaction(txn)[f'arr{i % 5}/{i:03d}'] = (
                f'value{i}' * (1 + i % 3)).encode()
    child = ts.KvStore.open({'driver': 'ocdbt', 'base': nested},
                            context=ctx).result()
    parent = ts.KvStore.open({'driver': 'ocdbt', 'config': cfg, 'base': {
        'driver': 'file', 'path': f'{root}/copied'}}, context=ctx).result()
    txn = ts.Transaction(atomic=True)
    child.experimental_copy_range_to(parent.with_transaction(txn)).result()
    txn.commit_async().result()
    return root


@pytest.mark.parametrize('name', ['orbax', 'orbax/ocdbt.process_0', 'deep',
                                  'copied', 'copied/ocdbt.process_0'])
def test_ocdbt_reads_what_tensorstore_reads(stores, name):
    """Every key and value of the newest version, and every version the
    version tree keeps, as tensorstore lists and dumps them."""
    directory = str(stores / name)
    kv = ts.KvStore.open({'driver': 'ocdbt',
                          'base': f'file://{directory}/'}).result()
    want = {k.decode(): kv.read(k).result().value
            for k in kv.list().result()}
    assert ocdbt.open(directory) == want
    base = ts.KvStore.open(f'file://{directory}/').result()
    manifest = ts.ocdbt.dump(base).result()
    dumped = list(manifest['versions'])
    for ref in manifest['version_tree_nodes']:
        stack = [ts.ocdbt.dump(base, ref['location']).result()]
        while stack:
            node = stack.pop()
            for e in node['entries']:
                if node['height'] == 0:
                    dumped.append(e)
                else:
                    stack.append(ts.ocdbt.dump(base, e['location']).result())
    dumped.sort(key=lambda v: v['generation_number'])
    got = ocdbt.versions(directory)
    assert [v['generation'] for v in got] == [
        v['generation_number'] for v in dumped]
    for v, d in zip(got, dumped):
        assert v['num_keys'] == d['root']['statistics']['num_keys']
        assert v['root_height'] == d['root_height']
        loc = d['root'].get('location')
        assert (v['root'] is None) == (loc is None)
        if loc is not None:
            assert loc.endswith(f'{v["root"][0][1]}:{v["root"][1]}:'
                                f'{v["root"][2]}')
    if name == 'deep':
        assert manifest['version_tree_nodes'] and max(
            v['root_height'] for v in got) > 1


def test_ocdbt_rejects_a_flipped_byte_and_a_truncated_file(stores,
                                                           tmp_path):
    """A flipped byte in the manifest or in the root node's record within
    its data file fails the CRC-32C; a truncated manifest fails its length
    check."""
    directory = tmp_path / 'db'
    (_, file), offset, _ = ocdbt.versions(str(stores / 'deep'))[-1]['root']
    for name, at in (('manifest.ocdbt', 20), (file, offset + 20)):
        shutil.copytree(stores / 'deep', directory)
        raw = bytearray((directory / name).read_bytes())
        raw[at] ^= 0x10
        (directory / name).write_bytes(bytes(raw))
        with pytest.raises(ocdbt.OcdbtError, match='CRC-32C'):
            ocdbt.open(str(directory))
        shutil.rmtree(directory)
    shutil.copytree(stores / 'deep', directory)
    manifest = directory / 'manifest.ocdbt'
    manifest.write_bytes(manifest.read_bytes()[:-1])
    with pytest.raises(ocdbt.OcdbtError, match='bytes'):
        ocdbt.open(str(directory))



def test_ocdbt_rejects_a_path_out_of_its_directory(stores, tmp_path):
    """A data file path that climbs out of the database ('..') raises: the
    manifest rewritten so, as an uncompressed record with a valid
    CRC-32C."""
    directory = tmp_path / 'db'
    shutil.copytree(stores / 'deep', directory)
    raw = (directory / 'manifest.ocdbt').read_bytes()
    payload = zstd.decompress(raw[14:-4])  # after magic, length, 2 varints
    at = payload.index(b'd/', 16)  # the first data file: d/X... -> ../...
    payload = payload[:at] + b'../' + payload[at + 3:]
    body = ocdbt.MANIFEST_MAGIC.to_bytes(4, 'big') + (
        14 + len(payload) + 4).to_bytes(8, 'little') + bytes([0, 0]) + payload
    (directory / 'manifest.ocdbt').write_bytes(
        body + ocdbt.crc32c(body).to_bytes(4, 'little'))
    with pytest.raises(ocdbt.OcdbtError, match='bad data file path'):
        ocdbt.open(str(directory))

# ---------------------------------------------------------------- orbax

def _assert_same_leaves(got, want):
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        if w is None:
            assert g is None, path
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


@pytest.mark.parametrize('use_ocdbt', [True, False])
def test_read_equals_jax_restore_of_a_mixed_tree(tmp_path, use_ocdbt):
    """float32, float64, int32, int64, uint32 and bool leaves, 0-d and
    3-d, a None leaf, and arrays split over a grid of chunks: the port's
    read equals the JAX package's restore, leaf by leaf."""
    tree = jax.tree.map(np.asarray, _mixed_tree())
    save_args = jax.tree.map(lambda _: ocp.SaveArgs(), tree)
    save_args['a'] = ocp.SaveArgs(chunk_byte_size=4096)
    save_args['h'][1] = ocp.SaveArgs(chunk_byte_size=300)
    path = str(tmp_path / 'ckpt')
    ocp.PyTreeCheckpointer(use_ocdbt=use_ocdbt).save(path, tree,
                                                     save_args=save_args)
    keys = (ocdbt.open(path) if use_ocdbt else
            [str(p.relative_to(path)) for p in Path(path).rglob('*')])
    for name in ('a', 'h.1'):  # several chunks each
        assert sum(k.startswith(f'{name}/') for k in keys) > 3
    want = _jax_leaves(jcheckpoint.restore(path, tree))
    _assert_same_leaves(orbax_format.read(path), want)


def test_write_restores_in_jax_and_needs_the_none_entries(tmp_path):
    """What the port writes (plain zarr v2, raw-block zstd chunks)
    restores in the JAX package exactly against a template with None
    leaves; without the None entries in _METADATA orbax refuses it."""
    tree = jax.tree.map(np.asarray, _mixed_tree())
    entries = _jax_leaves(tree)
    path = str(tmp_path / 'port')
    orbax_format.write(path, entries)
    _assert_same_leaves(_jax_leaves(jcheckpoint.restore(path, tree)),
                        entries)
    _assert_same_leaves(orbax_format.read(path), entries)
    assert json.loads(Path(path, '_METADATA').read_text())['use_ocdbt'] \
        is False
    orbax_format.write(path, {k: v for k, v in entries.items()
                              if v is not None})
    with pytest.raises(Exception):
        jcheckpoint.restore(path, tree)


def test_write_replaces_the_old_checkpoint_atomically(tmp_path,
                                                      monkeypatch):
    """A second write replaces the first; a write that fails part way
    leaves the earlier checkpoint whole and nothing else beside it."""
    path = str(tmp_path / 'ckpt')
    orbax_format.write(path, {('x',): np.arange(3.0)})
    orbax_format.write(path, {('x',): np.arange(4.0), ('y',): None})
    _assert_same_leaves(orbax_format.read(path),
                        {('x',): np.arange(4.0), ('y',): None})
    real, calls = zstd.compress, []

    def broken(data):
        calls.append(1)
        if len(calls) == 2:
            raise OSError('disk full')
        return real(data)

    monkeypatch.setattr(zstd, 'compress', broken)
    with pytest.raises(OSError, match='disk full'):
        orbax_format.write(path, {('a',): np.ones(2), ('b',): np.ones(3)})
    monkeypatch.undo()
    _assert_same_leaves(orbax_format.read(path),
                        {('x',): np.arange(4.0), ('y',): None})
    assert os.listdir(tmp_path) == ['ckpt']


def test_zarr3_checkpoint_raises(tmp_path):
    path = str(tmp_path / 'z3')
    ocp.PyTreeCheckpointer(use_zarr3=True).save(path, {'a': np.ones(3)})
    with pytest.raises(ValueError, match='zarr3'):
        orbax_format.read(path)


def _recipe(scheduled, envs=4096):
    """The JAX package's initial TrainState of the recipe (Lander3D-v0,
    hidden 128), float32, with a constant or a scheduled learning rate."""
    spec = jtasks.ALL_TASKS['Lander3D-v0']
    cfg = jppo.resolve_minibatches(jppo.PPOConfig(hidden=128), envs)
    lr = optax.linear_schedule(3e-4, 0.0, 600 * 64) if scheduled else 3e-4
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(lr))
    return jppo.init_train_state(jax.random.PRNGKey(0), default_params(),
                                 spec, cfg, envs, opt, dtype=jnp.float32)


@pytest.mark.parametrize('scheduled', [False, True])
def test_recipe_train_state_reads_as_jax_restores_it(tmp_path, scheduled):
    """The recipe's TrainState (4096 envs) saved by the JAX package as an
    OCDBT directory: 53 entries (optax's empty states None), every leaf
    equal to JAX's restore."""
    jts = _recipe(scheduled)
    path = str(tmp_path / 'recipe')
    jcheckpoint.save(path, jts)
    got = orbax_format.read(path)
    assert len(got) == 53 and got[('opt_state', '0')] is None
    if scheduled:
        assert got[('opt_state', '1', '1', 'count')].dtype == np.int32
    else:
        assert got[('opt_state', '1', '1')] is None
    _assert_same_leaves(got, _jax_leaves(jcheckpoint.restore(path, jts)))


# ---------------------------------------------------------------- fixture

def test_fixture_reads_equal_in_both_packages():
    """tests/data/jax_orbax_lander3d/ (the JAX package's OCDBT checkpoint
    of the recipe after one update): the port's read equals JAX's restore
    exactly and the recorded checksums; the port's checkpoint.restore
    gives a TrainState equal to the conversion of JAX's."""
    record = json.loads((DATA / 'jax_orbax_lander3d.json').read_text())
    got = orbax_format.read(str(FIXTURE))
    assert [list(p) for p in got] == [e['path'] for e in record['leaves']]
    for e in record['leaves']:
        a = got[tuple(e['path'])]
        if e['sha256'] is None:
            assert a is None
            continue
        assert (a.dtype.str, list(a.shape)) == (e['dtype'], e['shape'])
        assert hashlib.sha256(a.tobytes()).hexdigest() == e['sha256']
    jtemplate = jax.tree.map(np.asarray, _recipe(True))
    jts = jcheckpoint.restore(str(FIXTURE), jtemplate)
    _assert_same_leaves(got, _jax_leaves(jts))

    env = registry.make('Lander3D-v0', num_envs=record['envs'], device=CPU)
    cfg = ppo.PPOConfig(**record['config'])
    opt = optim.ClipAdam(cfg.max_grad_norm, optim.linear_schedule(
        cfg.learning_rate, 0.0, record['run_updates'] * cfg.epochs * 16))
    template = ppo.init_train_state(prng.PRNGKey(9, CPU), env.params,
                                    env.spec, cfg, record['envs'], opt)
    restored = checkpoint.restore(str(FIXTURE), template, opt)
    assert int(restored.update_idx) == record['updates_before_save']
    for a, b in zip(tree_leaves(restored),
                    tree_leaves(convert.train_state_from_numpy(jts, CPU))):
        assert a.dtype == b.dtype and torch.equal(a, b)
