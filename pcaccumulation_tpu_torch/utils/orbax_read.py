"""Read the JAX package's orbax checkpoints without jax, orbax or tensorstore.

The JAX package writes `train.ckpt_backend: orbax` checkpoints with
`ocp.StandardCheckpointer().save(dir, tree)` (its `utils/checkpoint.py`).
Such a directory holds:
- `_METADATA`: JSON, `tree_metadata` keyed by the tuple path of each leaf,
  with each key's type (1 a sequence index, 2 a dict key) and the leaf's
  `value_type`;
- an OCDBT key-value store (tensorstore's "optionally-cooperative
  distributed B+tree"): the root `manifest.ocdbt`, B+tree nodes and values
  in data files under `d/`, and under `ocdbt.process_N/` those each writing
  process made, which the root tree refers to by path;
- in that store, one zarr v2 array per leaf, named by its path joined with
  ".": `<name>/.zarray` (JSON) and its chunks `<name>/0.0...` (zstd).

`read_orbax(path)` returns the nested tree that
`ocp.StandardCheckpointer().restore(dir)` returns without a target: dicts
for dict keys, lists for sequence indices (optax's chain tuples), numpy
arrays for "np.ndarray" / "jax.Array" leaves, Python numbers for "scalar"
leaves, and None / () / {} / [] for the empty nodes orbax records
("None", "Tuple", "Dict", "List"). bfloat16 leaves come back as
`torch.bfloat16` tensors (numpy has no bfloat16).

The format, as tensorstore writes it (all integers varints, LEB128,
unless a width is given):
- a manifest or a B+tree node is a header (magic, uint32 big-endian:
  0x0cdb3a2a manifest, 0x0cdb20de node; its total length, uint64
  little-endian; format version, 0; compression, 0 none or 1 zstd), a body
  (one zstd frame when compressed), and the CRC-32C of everything before
  it (uint32 little-endian);
- the manifest body: the config (uuid 16 bytes, manifest kind, 0 "single";
  max_inline_value_bytes; max_decoded_node_bytes; version_tree_arity_log2,
  1 byte; compression method, with the zstd level as int32 little-endian),
  then the newest versions: a data file table, their count, and per field
  one array over them (generation, root height (1 byte), data file,
  offset, length, number of keys, tree bytes, indirect value bytes, commit
  time (uint64)), then the references to version tree nodes that hold the
  older versions (generation, data file, offset, length, number of
  generations, commit time (uint64), height (1 byte)); only the newest
  version is read;
- a data file table: the count, the length each path shares with the one
  before it (from the second on), each path's suffix length, each path's
  base-path length, then the suffixes. A node's paths are relative to the
  base path of the file that holds the node;
- a node body: its height (1 byte), a data file table, the entry count,
  the key prefix lengths shared with the previous key (from the second
  on), the key suffix lengths, for an interior node the subtree common
  prefix lengths, and the key suffixes. A leaf (height 0) then has the
  value lengths, the value kinds (0 inline, 1 in a data file), the data
  file and offset of each indirect value, and the inline values in entry
  order. An interior node has the data file, offset, length, key count,
  tree bytes and indirect value bytes of each child. A child's keys are
  stored without the prefix its parent's entry names as common to the
  subtree.

Every header, length, magic and checksum is checked, and every read is
bounded by its file: a truncated or corrupt file raises `OrbaxFormatError`
naming the file; the reader never returns a partial tree. Values carry no
checksum in OCDBT; a zarr chunk must decompress to exactly its size.

zstd is the system's `libzstd` through ctypes (`ctypes.util.find_library`);
where it is missing, reading raises a RuntimeError that names it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import math
import os
import struct

import numpy as np
import torch

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_HEADER = 4 + 8          # magic, length; then the version and compression varints
_UNKNOWN_SIZE = (1 << 64) - 1
_SIZE_ERROR = (1 << 64) - 2


class OrbaxFormatError(ValueError):
    """A file of the checkpoint is truncated, corrupt or not of the format."""


# ------------------------------------------------------------------ zstd
class _ZstdIn(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _ZstdOut(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_zstd_lib: ctypes.CDLL | None = None


def _zstd() -> ctypes.CDLL:
    global _zstd_lib
    if _zstd_lib is None:
        name = ctypes.util.find_library("zstd")
        if name is None:
            raise RuntimeError("reading an orbax checkpoint needs the system's zstd library "
                               "(libzstd.so.1), which ctypes.util.find_library('zstd') "
                               "does not find")
        lib = ctypes.CDLL(name)
        size_t, vp = ctypes.c_size_t, ctypes.c_void_p
        for fn, res, args in (
                ("ZSTD_decompress", size_t, [vp, size_t, vp, size_t]),
                ("ZSTD_findDecompressedSize", ctypes.c_ulonglong, [vp, size_t]),
                ("ZSTD_isError", ctypes.c_uint, [size_t]),
                ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                ("ZSTD_createDStream", vp, []),
                ("ZSTD_freeDStream", size_t, [vp]),
                ("ZSTD_initDStream", size_t, [vp]),
                ("ZSTD_decompressStream", size_t,
                 [vp, ctypes.POINTER(_ZstdOut), ctypes.POINTER(_ZstdIn)])):
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        _zstd_lib = lib
    return _zstd_lib


def zstd_decompress(data: bytes, size: int | None = None, limit: int = 1 << 34,
                    what: str = "zstd data") -> bytes:
    """The zstd frames in `data`, decompressed. `size`: the exact size they
    must give (else OrbaxFormatError); None: the size the frames state, or,
    where they state none (tensorstore streams its larger B+tree nodes),
    what streaming gives, at most `limit` bytes."""
    lib = _zstd()
    src = ctypes.c_char_p(data)
    if size is None:
        total = lib.ZSTD_findDecompressedSize(src, len(data))
        if total == _SIZE_ERROR:
            raise OrbaxFormatError(f"{what}: not a zstd frame")
        if total == _UNKNOWN_SIZE:
            return _zstd_stream(lib, data, limit, what)
        if total > limit:
            raise OrbaxFormatError(f"{what}: {total} bytes decompressed, over {limit}")
        size = total
    out = ctypes.create_string_buffer(max(size, 1))
    n = lib.ZSTD_decompress(out, size, src, len(data))
    if lib.ZSTD_isError(n):
        raise OrbaxFormatError(f"{what}: zstd: {lib.ZSTD_getErrorName(n).decode()}")
    if n != size:
        raise OrbaxFormatError(f"{what}: {n} bytes decompressed, {size} expected")
    return out.raw[:size]


def _zstd_stream(lib, data: bytes, limit: int, what: str) -> bytes:
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise MemoryError("ZSTD_createDStream")
    try:
        lib.ZSTD_initDStream(ds)
        src = ctypes.create_string_buffer(data, len(data))
        inb = _ZstdIn(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        step = 1 << 20
        buf = ctypes.create_string_buffer(step)
        parts, total, ret = [], 0, 1
        while inb.pos < inb.size or ret != 0:
            outb = _ZstdOut(ctypes.cast(buf, ctypes.c_void_p), step, 0)
            before = inb.pos
            ret = lib.ZSTD_decompressStream(ds, ctypes.byref(outb), ctypes.byref(inb))
            if lib.ZSTD_isError(ret):
                raise OrbaxFormatError(f"{what}: zstd: {lib.ZSTD_getErrorName(ret).decode()}")
            parts.append(buf.raw[:outb.pos])
            total += outb.pos
            if total > limit:
                raise OrbaxFormatError(f"{what}: more than {limit} bytes decompressed")
            if outb.pos == 0 and inb.pos == before:
                raise OrbaxFormatError(f"{what}: truncated zstd frame")
        return b"".join(parts)
    finally:
        lib.ZSTD_freeDStream(ds)


# ------------------------------------------------------------------ CRC-32C
def _crc_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as tensorstore's OCDBT checksums its files."""
    c, t = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ------------------------------------------------------------------ decoding
class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise OrbaxFormatError(f"{self.what}: ends inside a field")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OrbaxFormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise OrbaxFormatError(f"{self.what}: {len(self.data) - self.pos} bytes left over")


def _safe_path(path: str, what: str) -> None:
    if os.path.isabs(path) or ".." in path.split("/"):
        raise OrbaxFormatError(f"{what}: data file path {path!r} leaves the checkpoint")


class OcdbtStore:
    """The newest version of an OCDBT store under `root`, as {key: value}
    (keys str, values bytes), read once at construction."""

    def __init__(self, root: str):
        self.root = root
        self._files: dict[str, bytes] = {}
        self.max_node_bytes = 1 << 30  # until the manifest's config gives it
        manifest = os.path.join(root, "manifest.ocdbt")
        if not os.path.isfile(manifest):
            raise OrbaxFormatError(f"{manifest}: no OCDBT manifest")
        body = self._decode(self._file("manifest.ocdbt"), MANIFEST_MAGIC, manifest)
        cur = _Cursor(body, manifest)
        self._config(cur)
        versions = self._versions(cur, "")
        self._version_nodes(cur)
        cur.done()
        self.items: dict[str, bytes] = {}
        if versions:
            newest = max(versions, key=lambda v: v["generation"])
            if newest["num_keys"]:
                self._walk(newest["root"], newest["height"], b"")
            if len(self.items) != newest["num_keys"]:
                raise OrbaxFormatError(f"{manifest}: {len(self.items)} keys read, the "
                                       f"manifest counts {newest['num_keys']}")

    # -- files
    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            path = os.path.join(self.root, rel)
            if not os.path.isfile(path):
                raise OrbaxFormatError(f"{path}: a data file the store refers to is missing")
            with open(path, "rb") as f:
                self._files[rel] = f.read()
        return self._files[rel]

    def _slice(self, ref: tuple, what: str) -> bytes:
        rel, offset, length = ref
        data = self._file(rel)
        if offset + length > len(data):
            raise OrbaxFormatError(f"{os.path.join(self.root, rel)}: truncated ({len(data)} "
                                   f"bytes, {what} needs {offset + length})")
        return data[offset:offset + length]

    def _decode(self, blob: bytes, magic: int, what: str) -> bytes:
        if len(blob) < _HEADER + 2 + 4:
            raise OrbaxFormatError(f"{what}: truncated ({len(blob)} bytes)")
        got_magic, length = struct.unpack(">I", blob[:4])[0], struct.unpack("<Q", blob[4:12])[0]
        if got_magic != magic:
            raise OrbaxFormatError(f"{what}: magic {got_magic:#010x}, not {magic:#010x}")
        if length != len(blob):
            raise OrbaxFormatError(f"{what}: truncated (header says {length} bytes, "
                                   f"{len(blob)} read)")
        crc = struct.unpack("<I", blob[-4:])[0]
        if crc32c(blob[:-4]) != crc:
            raise OrbaxFormatError(f"{what}: CRC-32C mismatch (corrupt)")
        cur = _Cursor(blob[:-4], what)
        cur.take(_HEADER)
        version, compression = cur.varint(), cur.varint()
        if version != 0:
            raise OrbaxFormatError(f"{what}: OCDBT format version {version} is not read")
        rest = blob[cur.pos:-4]
        if compression == 0:
            return rest
        if compression == 1:
            return zstd_decompress(rest, limit=self.max_node_bytes, what=what)
        raise OrbaxFormatError(f"{what}: compression format {compression} is not read")

    # -- manifest
    def _config(self, cur: _Cursor) -> None:
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            raise OrbaxFormatError(f"{cur.what}: manifest kind {kind} (numbered) is not read; "
                                   "orbax writes kind 0 (single)")
        cur.varint()  # max_inline_value_bytes
        self.max_node_bytes = cur.varint()
        cur.byte()  # version_tree_arity_log2
        method = cur.varint()
        if method == 1:
            cur.take(4)  # zstd level
        elif method != 0:
            raise OrbaxFormatError(f"{cur.what}: compression method {method} is not read")

    def _table(self, cur: _Cursor, base: str) -> list:
        """The node's data files as paths relative to the root, each with its
        base path (both under the base path of the file holding the node)."""
        n = cur.varint()
        prefix = [0] + cur.varints(max(n - 1, 0))
        suffix, base_len = cur.varints(n), cur.varints(n)
        out, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                raise OrbaxFormatError(f"{cur.what}: bad data file table")
            path = prev[:prefix[i]] + cur.take(suffix[i])
            if base_len[i] > len(path):
                raise OrbaxFormatError(f"{cur.what}: bad data file table")
            text = path.decode()
            out.append((base + text[:base_len[i]], base + text))
            prev = path
        for _, full in out:
            _safe_path(full, cur.what)
        return out

    def _file_ref(self, table: list, i: int, cur: _Cursor):
        if i >= len(table):
            raise OrbaxFormatError(f"{cur.what}: data file {i} of {len(table)}")
        return table[i]

    def _versions(self, cur: _Cursor, base: str) -> list:
        table = self._table(cur, base)
        n = cur.varint()
        gen = cur.varints(n)
        height = [cur.byte() for _ in range(n)]
        fid, off, length = cur.varints(n), cur.varints(n), cur.varints(n)
        keys = cur.varints(n)
        cur.varints(n), cur.varints(n)  # tree bytes, indirect value bytes
        [cur.u64() for _ in range(n)]   # commit times
        return [{"generation": gen[i], "height": height[i], "num_keys": keys[i],
                 "root": (self._file_ref(table, fid[i], cur), off[i], length[i])
                 if keys[i] else None} for i in range(n)]

    def _version_nodes(self, cur: _Cursor) -> None:
        """The references to older versions' tree nodes: read past, unused."""
        n = cur.varint()
        if n:
            cur.varints(n), cur.varints(n), cur.varints(n), cur.varints(n), cur.varints(n)
            [cur.u64() for _ in range(n)]
            cur.take(n)

    # -- B+tree
    def _keys(self, cur: _Cursor, n: int, interior: bool) -> tuple:
        prefix = [0] + cur.varints(max(n - 1, 0))
        suffix = cur.varints(n)
        common = cur.varints(n) if interior else None
        keys, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                raise OrbaxFormatError(f"{cur.what}: bad key prefix")
            prev = prev[:prefix[i]] + cur.take(suffix[i])
            keys.append(prev)
        return keys, common

    def _walk(self, ref: tuple, height: int, key_prefix: bytes) -> None:
        (base, full), offset, length = ref
        what = f"{os.path.join(self.root, full)} @{offset}"
        cur = _Cursor(self._decode(self._slice((full, offset, length), "a B+tree node"),
                                   NODE_MAGIC, what), what)
        if cur.byte() != height:
            raise OrbaxFormatError(f"{what}: node height differs from its reference")
        table = self._table(cur, base)
        n = cur.varint()
        keys, common = self._keys(cur, n, interior=height > 0)
        if height > 0:
            fid, off, size = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(n), cur.varints(n), cur.varints(n)  # keys, tree bytes, indirect bytes
            cur.done()
            for i in range(n):
                self._walk((self._file_ref(table, fid[i], cur), off[i], size[i]), height - 1,
                           key_prefix + keys[i][:common[i]])
            return
        lengths = cur.varints(n)
        kinds = [cur.byte() for _ in range(n)]
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise OrbaxFormatError(f"{what}: unknown value kind")
        fid, off = cur.varints(len(indirect)), cur.varints(len(indirect))
        refs = {i: (self._file_ref(table, f, cur)[1], o, lengths[i])
                for i, f, o in zip(indirect, fid, off)}
        for i in range(n):
            value = (self._slice(refs[i], f"the value of {(key_prefix + keys[i])!r}")
                     if i in refs else cur.take(lengths[i]))
            self.items[(key_prefix + keys[i]).decode()] = value
        cur.done()


# ------------------------------------------------------------------ zarr v2
_DTYPES = {"bfloat16": np.dtype("<u2")}


def _zarr_dtype(name: str) -> np.dtype:
    if name in _DTYPES:
        return _DTYPES[name]
    dt = np.dtype(name)
    if dt.kind not in "biuf":
        raise OrbaxFormatError(f"zarr dtype {name!r} is not read")
    return dt


def _fill(value, dtype_name: str, dt: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        value = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}[value]
    if dtype_name == "bfloat16":
        return int(np.array(value, np.float32).view(np.uint32)) >> 16
    return value


def read_zarr(items: dict, name: str):
    """The zarr v2 array `name` of an OCDBT store's items: a numpy array in
    native byte order (bfloat16: a torch.bfloat16 tensor)."""
    meta_key = f"{name}/.zarray"
    if meta_key not in items:
        raise OrbaxFormatError(f"{name}: no array in the checkpoint's store")
    meta = json.loads(items[meta_key])
    if meta.get("zarr_format") != 2 or meta.get("filters") or meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}: zarr metadata {meta} is not read (format 2, C order, "
                               "no filters)")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: compressor {comp} is not read")
    dt = _zarr_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), meta["dtype"], dt), dtype=dt)
    grid = [-(-s // c) if c else 1 for s, c in zip(shape, chunks)]
    chunk_bytes = math.prod(chunks) * dt.itemsize
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in items:
            continue  # all fill_value
        raw = items[key]
        if comp is not None:
            raw = zstd_decompress(raw, chunk_bytes, what=key)
        elif len(raw) != chunk_bytes:
            raise OrbaxFormatError(f"{key}: {len(raw)} bytes, {chunk_bytes} expected")
        block = np.frombuffer(raw, dtype=dt).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    out = out.astype(dt.newbyteorder("="), copy=False)
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(out).view(np.int16)).view(torch.bfloat16)
    return out


# ------------------------------------------------------------------ the tree
_EMPTY = {"None": lambda: None, "Tuple": tuple, "Dict": dict, "List": list}
_ARRAYS = ("np.ndarray", "jax.Array", "scalar")


def orbax_dir(path: str) -> str | None:
    """The orbax directory a checkpoint path names: `<path>.orbax/`, or
    `path` itself where it is one; None if neither."""
    for d in (os.path.abspath(path) + ".orbax", path):
        if os.path.isfile(os.path.join(d, "_METADATA")) and os.path.isfile(
                os.path.join(d, "manifest.ocdbt")):
            return d
    return None


def _listify(node):
    if isinstance(node, _Seq):
        return [_listify(node[str(i)]) for i in range(len(node))]
    if isinstance(node, dict):
        return {k: _listify(v) for k, v in node.items()}
    return node


class _Seq(dict):
    """A sequence node while the tree is built (its entries by index)."""


def read_orbax(path: str) -> dict:
    """The tree of the orbax checkpoint at `path` (`<path>.orbax/` or the
    directory itself), as orbax's restore without a target gives it."""
    d = orbax_dir(path)
    if d is None:
        raise FileNotFoundError(f"{path}: no orbax checkpoint directory")
    meta_path = os.path.join(d, "_METADATA")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        entries = meta["tree_metadata"]
    except (ValueError, KeyError) as e:
        raise OrbaxFormatError(f"{meta_path}: not orbax tree metadata ({e})") from e
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{meta_path}: zarr3 checkpoints are not read")
    items = OcdbtStore(d).items
    root: dict = {}
    for entry in entries.values():
        keys = entry["key_metadata"]
        kind = entry["value_metadata"]["value_type"]
        if kind in _ARRAYS:
            value = read_zarr(items, ".".join(str(k["key"]) for k in keys))
            if kind == "scalar":
                value = value.item()
        elif kind in _EMPTY:
            value = _EMPTY[kind]()
        else:
            raise OrbaxFormatError(f"{meta_path}: leaf type {kind!r} is not read")
        node = root
        for k, nxt in zip(keys, keys[1:] + [None]):
            key = str(k["key"])
            if nxt is None:
                node[key] = value
            else:
                node = node.setdefault(key, _Seq() if nxt["key_type"] == 1 else {})
        if not keys:
            raise OrbaxFormatError(f"{meta_path}: a leaf without a path")
    return _listify(root)
