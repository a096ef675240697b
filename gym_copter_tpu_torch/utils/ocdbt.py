"""A read-only OCDBT key-value store, the database under the JAX package's
orbax checkpoints (tensorstore's "OCDBT storage format").

An OCDBT directory holds `manifest.ocdbt` and data files under `d/`.  Each
manifest, version tree node and B+tree node is one record, alone in its
file or at an offset within a data file:

    magic u32be | length u64le | version varint (0) | compression varint
    (0 none, 1 zstd) | payload | CRC-32C (Castagnoli) u32le of all before

`open` checks each record's magic, length and checksum, decodes the
manifest, takes its newest version and walks that version's B+tree:
interior nodes down to the leaves, with the keys' prefix compression, and
inline or indirect values (bytes at an offset of a data file).  A data
file is named by a base path and a relative path, both relative to the
directory that holds the record naming it, so that a root database can
refer to the files of the nested `ocdbt.process_N/` stores orbax writes.
`versions` walks the version tree: every generation the store keeps.

Only the Python standard library is used; malformed input raises
`OcdbtError`.
"""

from __future__ import annotations

import io
import os

from gym_copter_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_NODE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1  # offset and length of an empty tree's root


class OcdbtError(ValueError):
    """The directory is not a readable OCDBT database."""


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of `data`."""
    table = _CRC32C
    crc ^= 0xFFFFFFFF
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _record(raw: bytes, magic: int, where: str) -> bytes:
    """The payload of the record `raw`, its framing checked."""
    if len(raw) < 18:
        raise OcdbtError(f'{where}: {len(raw)} bytes is too short a record')
    if int.from_bytes(raw[:4], 'big') != magic:
        raise OcdbtError(f'{where}: magic {raw[:4].hex()} is not '
                         f'{magic:08x}')
    length = int.from_bytes(raw[4:12], 'little')
    if length != len(raw):
        raise OcdbtError(f'{where}: the record says {length} bytes, '
                         f'{len(raw)} are there')
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], 'little'):
        raise OcdbtError(f'{where}: CRC-32C mismatch')
    r = _Reader(raw[:-4], where, 12)
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f'{where}: format version {version}')
    body = raw[r.pos:-4]
    if compression == 1:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f'{where}: {e}') from e
    if compression != 0:
        raise OcdbtError(f'{where}: compression {compression}')
    return body


class _Reader:
    """A cursor over a record's payload."""

    def __init__(self, buf: bytes, where: str, pos: int = 0):
        self.buf, self.where, self.pos = buf, where, pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise OcdbtError(f'{self.where}: truncated')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8s(self, n: int) -> list[int]:
        return list(self.take(n))

    def u64s(self, n: int) -> list[int]:
        return [int.from_bytes(self.take(8), 'little') for _ in range(n)]

    def varint(self) -> int:
        buf, p, v, shift = self.buf, self.pos, 0, 0
        while True:
            if p >= len(buf) or shift > 63:
                raise OcdbtError(f'{self.where}: bad varint')
            b = buf[p]
            p += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                self.pos = p
                return v

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.buf):
            raise OcdbtError(f'{self.where}: {len(self.buf) - self.pos} '
                             f'bytes left over')


def _file_table(r: _Reader, base: str) -> list[tuple[str, str]]:
    """The data file table: each file's base path and path, relative to
    the database, both prefixed with the `base` of the record naming it."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    paths, prev = [], b''
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f'{r.where}: bad path prefix')
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(path) or path.startswith(b'/') or (
                b'..' in path.split(b'/')):
            raise OcdbtError(f'{r.where}: bad data file path {path!r}')
        paths.append((base + path[:base_len[i]].decode(),
                      base + path.decode()))
        prev = path
    return paths


class _Store:
    """Reads records and values of one database directory, each data file
    once."""

    def __init__(self, directory: str):
        self.directory = directory
        self.files: dict[str, bytes] = {}

    def read(self, path: str) -> bytes:
        if path not in self.files:
            full = os.path.join(self.directory, path)
            try:
                with io.open(full, 'rb') as f:
                    self.files[path] = f.read()
            except FileNotFoundError:
                raise OcdbtError(f'{full}: missing') from None
        return self.files[path]

    def slice(self, file: tuple[str, str], offset: int,
              length: int) -> bytes:
        path = file[1]
        data = self.read(path)
        if offset + length > len(data):
            raise OcdbtError(f'{path}: [{offset}, {offset + length}) past '
                             f'its {len(data)} bytes')
        return data[offset:offset + length]

    def manifest(self):
        """(the versions the manifest holds, its version tree node
        references)."""
        where = 'manifest.ocdbt'
        r = _Reader(_record(self.read(where), MANIFEST_MAGIC, where), where)
        r.take(16)  # the database's uuid
        if r.varint() != 0:
            raise OcdbtError('numbered manifests are not supported')
        r.varints(2)  # max inline value bytes, max decoded node bytes
        r.u8s(1)  # the version tree's arity log2
        if r.varint() == 1:  # the nodes' compression: zstd, at a level
            r.take(4)
        files, versions = self._versions_leaf(r, '')
        refs = self._version_refs(r, None, files)
        r.done()
        return versions, refs

    def _versions_leaf(self, r: _Reader, base: str):
        """(data file table, versions) of a version tree leaf."""
        files = _file_table(r, base)
        n = r.varint()
        gen, height = r.varints(n), r.u8s(n)
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        keys, tree_bytes, ind_bytes = r.varints(n), r.varints(n), r.varints(n)
        commit = r.u64s(n)
        out = []
        for i in range(n):
            if fid[i] >= len(files):
                raise OcdbtError(f'{r.where}: bad data file id')
            root = (None if length[i] == MISSING
                    else (files[fid[i]], off[i], length[i]))
            out.append(dict(generation=gen[i], root_height=height[i],
                            root=root, num_keys=keys[i],
                            num_tree_bytes=tree_bytes[i],
                            num_indirect_value_bytes=ind_bytes[i],
                            commit_time=commit[i]))
        return files, out

    def _version_refs(self, r: _Reader, height, files) -> list[dict]:
        n = r.varint()
        gen, fid = r.varints(n), r.varints(n)
        off, length, ngen = r.varints(n), r.varints(n), r.varints(n)
        commit = r.u64s(n)
        heights = r.u8s(n) if height is None else [height - 1] * n
        if any(f >= len(files) for f in fid):
            raise OcdbtError(f'{r.where}: bad data file id')
        return [dict(generation=gen[i], location=(files[fid[i]], off[i],
                                                  length[i]),
                     num_generations=ngen[i], commit_time=commit[i],
                     height=heights[i]) for i in range(n)]

    def version_node(self, location, height: int) -> list[dict]:
        """The versions under the version tree node at `location`."""
        file, offset, length = location
        where = f'{file[1]}@{offset}'
        r = _Reader(_record(self.slice(file, offset, length),
                            VERSION_NODE_MAGIC, where), where)
        r.u8s(1)  # the tree's arity log2
        if r.u8s(1)[0] != height:
            raise OcdbtError(f'{where}: not at height {height}')
        if height == 0:
            out = self._versions_leaf(r, file[0])[1]
        else:
            files = _file_table(r, file[0])
            out = []
            for ref in self._version_refs(r, height, files):
                out += self.version_node(ref['location'], ref['height'])
        r.done()
        return out

    def btree(self, location, height: int, prefix: bytes,
              out: dict[bytes, bytes]) -> None:
        """Add every key and value under the B+tree node at `location`,
        whose keys follow `prefix`, to `out`."""
        file, offset, length = location
        where = f'{file[1]}@{offset}'
        r = _Reader(_record(self.slice(file, offset, length),
                            BTREE_NODE_MAGIC, where), where)
        if r.u8s(1)[0] != height:
            raise OcdbtError(f'{where}: not at height {height}')
        files = _file_table(r, file[0])
        n = r.varint()
        shared = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        common = r.varints(n) if height else None
        keys, prev = [], b''
        for i in range(n):
            if shared[i] > len(prev):
                raise OcdbtError(f'{where}: bad key prefix')
            prev = prev[:shared[i]] + r.take(suffix[i])
            keys.append(prev)
        if height:
            fid, off, size = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # per subtree: keys, tree bytes, value bytes
            r.done()
            for i in range(n):
                if fid[i] >= len(files) or common[i] > len(keys[i]):
                    raise OcdbtError(f'{where}: bad child entry')
                self.btree((files[fid[i]], off[i], size[i]), height - 1,
                           prefix + keys[i][:common[i]], out)
            return
        value_len, kind = r.varints(n), r.varints(n)
        indirect = [i for i in range(n) if kind[i] == 1]
        if any(k > 1 for k in kind):
            raise OcdbtError(f'{where}: unknown value kind')
        fid, off = r.varints(len(indirect)), r.varints(len(indirect))
        where_ind = dict(zip(indirect, zip(fid, off)))
        for i in range(n):
            if i in where_ind:
                f, o = where_ind[i]
                if f >= len(files):
                    raise OcdbtError(f'{where}: bad data file id')
                out[prefix + keys[i]] = self.slice(files[f], o, value_len[i])
            else:
                out[prefix + keys[i]] = r.take(value_len[i])
        r.done()


def open(directory: str) -> dict[str, bytes]:  # noqa: A001
    """Every key of the newest version of the OCDBT database in
    `directory`, with its value."""
    store = _Store(directory)
    versions, _ = store.manifest()
    if not versions:
        raise OcdbtError(f'{directory}: no version')
    newest = max(versions, key=lambda v: v['generation'])
    out: dict[bytes, bytes] = {}
    if newest['root'] is not None:
        store.btree(newest['root'], newest['root_height'], b'', out)
    if len(out) != newest['num_keys']:
        raise OcdbtError(f'{directory}: {len(out)} keys, the manifest says '
                         f'{newest["num_keys"]}')
    return {k.decode(): v for k, v in out.items()}


def versions(directory: str) -> list[dict]:
    """Every version the database in `directory` keeps, oldest first:
    generation, root ((base path, data file), offset, length; None when
    empty), root height, statistics and commit time."""
    store = _Store(directory)
    inline, refs = store.manifest()
    out = []
    for ref in refs:
        out += store.version_node(ref['location'], ref['height'])
    return sorted(out + inline, key=lambda v: v['generation'])
