"""orbax PyTree checkpoints, the JAX package's checkpoint directories
(`gym_copter_tpu/utils/checkpoint.py`), as `{path: array or None}`.

A checkpoint directory holds `_METADATA` (JSON: the tree's paths in leaf
order, each with its keys and value type, and whether the arrays sit in an
OCDBT database and in zarr v2 or v3), `_CHECKPOINT_METADATA`, and the
arrays: one zarr v2 array per leaf, named by its path joined with '.',
as `<name>/.zarray` (JSON: dtype, shape, chunks, order, dimension
separator, fill value, compressor) and one file per chunk (`0.0`, or `0`
for a 0-d array).  orbax writes them into an OCDBT database by default
(`ocdbt.py`) and as plain files with `use_ocdbt=False`.

`read` takes either layout (zarr v3 raises); `write` writes the plain one,
which orbax reads back, with every chunk a zstd frame of raw blocks.  A
path is a tuple of strings; a leaf orbax keeps no data for (optax's empty
states) is None.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import tempfile
import time

import numpy as np

from gym_copter_tpu_torch.utils import ocdbt, zstd

HANDLER = ('orbax.checkpoint._src.handlers.pytree_checkpoint_handler.'
           'PyTreeCheckpointHandler')
# orbax's key types: a sequence index and a dict key (or NamedTuple field)
SEQUENCE_KEY, DICT_KEY = 1, 2


def _fill(value):
    if value is None:
        return 0
    if isinstance(value, str):  # zarr v2 spells non-finite floats out
        return {'NaN': np.nan, 'Infinity': np.inf,
                '-Infinity': -np.inf}[value]
    return value


def _array(get, name: str) -> np.ndarray:
    """The zarr v2 array `name`, from `get(key) -> bytes or None`."""
    raw = get(f'{name}/.zarray')
    if raw is None:
        raise ValueError(f'{name}: no .zarray')
    meta = json.loads(raw)
    if meta.get('zarr_format') != 2 or meta.get('filters'):
        raise ValueError(f'{name}: zarr format {meta.get("zarr_format")} '
                         f'with filters {meta.get("filters")}')
    compressor = meta.get('compressor')
    if compressor is not None and compressor.get('id') != 'zstd':
        raise ValueError(f'{name}: compressor {compressor} (only zstd and '
                         f'none are read)')
    try:
        dtype = np.dtype(meta['dtype'])
    except TypeError as e:
        raise ValueError(f'{name}: dtype {meta["dtype"]!r}') from e
    shape, chunks = tuple(meta['shape']), tuple(meta['chunks'])
    order = meta.get('order', 'C')
    sep = meta.get('dimension_separator', '.')
    if len(chunks) != len(shape) or order not in ('C', 'F'):
        raise ValueError(f'{name}: chunks {chunks}, order {order}')
    out = np.full(shape, _fill(meta.get('fill_value')), dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        raw = get(f'{name}/{sep.join(map(str, idx)) if shape else "0"}')
        if raw is None:  # a chunk never written holds the fill value
            continue
        data = zstd.decompress(raw) if compressor is not None else raw
        if len(data) != chunk_bytes:
            raise ValueError(f'{name}: chunk {idx} holds {len(data)} bytes, '
                             f'not {chunk_bytes}')
        chunk = np.frombuffer(data, dtype).reshape(chunks, order=order)
        box = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[box] = chunk[tuple(slice(0, b.stop - b.start) for b in box)]
    return out.astype(dtype.newbyteorder('='), copy=False)


def read(directory: str) -> dict[tuple[str, ...], np.ndarray | None]:
    """Every leaf of the orbax PyTree checkpoint in `directory`, in its
    tree's leaf order."""
    with open(os.path.join(directory, '_METADATA'), 'rb') as f:
        meta = json.load(f)
    if meta.get('use_zarr3'):
        raise ValueError(f'{directory}: a zarr3 checkpoint '
                         f'(use_zarr3=True); only zarr v2 is read')
    if meta.get('use_ocdbt'):
        get = ocdbt.open(directory).get
    else:
        def get(key):
            try:
                with open(os.path.join(directory, key), 'rb') as f:
                    return f.read()
            except FileNotFoundError:
                return None
    out = {}
    for entry in meta['tree_metadata'].values():
        path = tuple(str(k['key']) for k in entry['key_metadata'])
        value = entry['value_metadata']
        if value.get('skip_deserialize') or value.get('value_type') == 'None':
            out[path] = None
        else:
            out[path] = _array(get, '.'.join(path))
    return out


def _write_file(path: str, data: bytes) -> None:
    with open(path, 'wb') as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _tree_metadata(entries) -> dict:
    """orbax's `tree_metadata`: a path's digit keys are sequence indices,
    the others dict keys."""
    out = {}
    for path, a in entries.items():
        keys = [{'key': k, 'key_type': SEQUENCE_KEY if k.isdigit()
                 else DICT_KEY} for k in path]
        value = ({'value_type': 'None', 'skip_deserialize': True}
                 if a is None else
                 {'value_type': 'np.ndarray', 'skip_deserialize': False})
        out[str(tuple(path))] = {'key_metadata': keys,
                                 'value_metadata': value}
    return out


def write(directory: str,
          entries: dict[tuple[str, ...], np.ndarray | None]) -> None:
    """Write `entries` (in leaf order) as an orbax PyTree checkpoint in the
    plain zarr v2 layout at `directory`, replacing any checkpoint there.

    The checkpoint is written into a temporary directory beside the target
    and fsynced, then renamed into place; an old checkpoint is first
    renamed aside and removed after, so that at every moment one whole
    checkpoint exists under the target's name or the aside name."""
    directory = os.path.abspath(directory)
    parent, base = os.path.split(directory)
    start = time.time_ns()
    tmp = tempfile.mkdtemp(dir=parent, prefix=f'{base}.', suffix='.tmp')
    try:
        for path, a in entries.items():
            if a is None:
                continue
            a = np.asarray(a)
            name = os.path.join(tmp, '.'.join(path))
            os.mkdir(name)
            zarray = {'chunks': list(a.shape),
                      'compressor': {'id': 'zstd', 'level': 1},
                      'dimension_separator': '.', 'dtype': a.dtype.str,
                      'fill_value': None, 'filters': None, 'order': 'C',
                      'shape': list(a.shape), 'zarr_format': 2}
            _write_file(os.path.join(name, '.zarray'),
                        json.dumps(zarray, separators=(',', ':')).encode())
            _write_file(os.path.join(name, '.'.join('0' * a.ndim) or '0'),
                        zstd.compress(a.tobytes()))
            _fsync_dir(name)
        meta = {'tree_metadata': _tree_metadata(entries), 'use_ocdbt': False,
                'use_zarr3': False,
                'store_array_data_equal_to_fill_value': True,
                'custom_metadata': None}
        _write_file(os.path.join(tmp, '_METADATA'), json.dumps(meta).encode())
        _write_file(os.path.join(tmp, '_CHECKPOINT_METADATA'), json.dumps({
            'item_handlers': HANDLER, 'metrics': {},
            'performance_metrics': {}, 'init_timestamp_nsecs': start,
            'commit_timestamp_nsecs': time.time_ns(),
            'custom_metadata': {}}).encode())
        _fsync_dir(tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    aside = None
    if os.path.lexists(directory):
        aside = tempfile.mkdtemp(dir=parent, prefix=f'{base}.', suffix='.old')
        os.replace(directory, os.path.join(aside, base))
    try:
        os.replace(tmp, directory)
    except BaseException:
        if aside is not None:
            os.replace(os.path.join(aside, base), directory)
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_dir(parent)
    if aside is not None:
        shutil.rmtree(aside)
