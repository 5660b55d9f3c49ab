"""The JAX package's orbax checkpoints, read and written with the standard
library, numpy and torch (counterpart of the orbax branch of
tracklab_tpu.models.convert: ``save_checkpoint`` and ``load_checkpoint``).

An orbax ``StandardCheckpointer`` directory holds ``_METADATA`` (JSON: the
tree's key paths, each key a dict key or a sequence index, and the layout
flags ``use_ocdbt`` and ``use_zarr3``) and one zarr v2 array per leaf, named
by the leaf's key path joined with '.': ``params.conv.kernel/.zarray`` (the
array's JSON header) and its chunks ``params.conv.kernel/0.0.0.0``. The
arrays live either in plain files under the directory (``use_ocdbt``
false) or as keys of an OCDBT database (``use_ocdbt`` true, orbax's
default): a manifest ``manifest.ocdbt`` whose newest version names a root
b-tree node, interior nodes pointing at children, leaf nodes holding small
values inline and large ones as (data file, offset, length). The reader
follows tensorstore's documented on-disk format
(https://google.github.io/tensorstore/kvstore/ocdbt/index.html): every
manifest and node carries a magic number, its length, a format version, a
compression flag (zstd) and a crc32c of what precedes it, which is checked;
keys are prefix-compressed and stored column by column; data file paths
are prefix-compressed, each with a base path that children inherit.

zstd frames (the OCDBT nodes' bodies and the zarr chunks' compressor) are
decompressed by the system's libzstd through ``ctypes``; there is no
second decoder, and a missing library raises RuntimeError naming it. A
zarr chunk's frame carries no content size, so its output size comes from
the chunk shape and the dtype's item size; a large node's frame carries
none either, and is decoded as a stream, bounded by the database's node
size limit.

``read_orbax`` gives the nested tree (dicts, and lists where the keys are
sequence indices) of CPU tensors in the stored dtypes (bfloat16 bit for
bit). ``write_orbax`` writes the ``use_ocdbt=False`` layout with
uncompressed chunks, which orbax's ``StandardCheckpointer`` restores.
zarr v3 (``use_zarr3``) and the older aggregate msgpack ``checkpoint`` file
raise ValueError.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import itertools
import json
import math
import os
import shutil
import struct
import time
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

__all__ = ["read_orbax", "write_orbax", "zstd_decompress", "crc32c",
           "zstd_library"]

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_NO_OFFSET = (1 << 64) - 1       # the pointer of an empty tree's root
_READS = ("zarr v2 arrays (use_zarr3=false) in the OCDBT layout "
          "(use_ocdbt=true, orbax's default) and the plain layout "
          "(use_ocdbt=false)")

# zarr v2 dtype string -> (numpy dtype of the stored bits, torch dtype)
_DTYPES = {
    "<f4": (np.float32, torch.float32), "<f8": (np.float64, torch.float64),
    "<f2": (np.float16, torch.float16), "bfloat16": (np.uint16,
                                                     torch.bfloat16),
    "|i1": (np.int8, torch.int8), "|u1": (np.uint8, torch.uint8),
    "<i4": (np.int32, torch.int32), "<i8": (np.int64, torch.int64),
    "|b1": (np.bool_, torch.bool),
}
_TORCH_TO_ZARR = {t: s for s, (_, t) in _DTYPES.items()}


# ----------------------------------------------------------------- zstd

_LIB = None


def zstd_library():
    """The system libzstd, loaded once through ctypes; RuntimeError where it
    cannot be loaded."""
    global _LIB
    if _LIB is None:
        names = ["libzstd.so.1", ctypes.util.find_library("zstd")]
        errors = []
        for name in filter(None, names):
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError as e:
                errors.append(f"{name}: {e}")
        else:
            raise RuntimeError(
                "reading an orbax checkpoint needs the system zstd library "
                "(libzstd.so.1, loaded through ctypes), which did not load: "
                + ("; ".join(errors) or "not found"))
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_versionNumber.restype = ctypes.c_uint
        lib.ZSTD_createDStream.restype = ctypes.c_void_p
        lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_initDStream.restype = ctypes.c_size_t
        lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_OutBuffer),
            ctypes.POINTER(_InBuffer)]
        _LIB = lib
    return _LIB


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _check(lib, ret):
    if lib.ZSTD_isError(ret):
        raise ValueError("zstd: " + lib.ZSTD_getErrorName(ret).decode())
    return ret


def zstd_decompress(data, size=None, limit=None) -> bytearray:
    """Decompress one zstd frame. Its output size is the frame header's
    content size where it gives one, else ``size`` (a zarr chunk's shape
    times its item size); where both are known they must agree, and the
    frame must decode to exactly that many bytes. A frame of unknown size
    (tensorstore streams large OCDBT nodes) with no ``size`` is decoded as
    a stream, to at most ``limit`` bytes."""
    lib = zstd_library()
    src = bytes(data)
    content = lib.ZSTD_getFrameContentSize(src, len(src))
    if content == (1 << 64) - 2:
        raise ValueError("not a zstd frame")
    if content != (1 << 64) - 1:
        if size is not None and content != size:
            raise ValueError(f"zstd frame of {content} bytes where {size} "
                             "were expected")
        size = content
    if size is None:
        return _zstd_stream(lib, src, limit)
    out = bytearray(size)
    if size == 0:
        return out
    dst = (ctypes.c_char * size).from_buffer(out)
    got = _check(lib, lib.ZSTD_decompress(dst, size, src, len(src)))
    if got != size:
        raise ValueError(f"zstd frame decoded to {got} bytes, {size} "
                         "expected")
    return out


def _zstd_stream(lib, src, limit):
    """A frame without a content size, through ZSTD_decompressStream."""
    if limit is None:
        raise ValueError("zstd frame without a content size, and no "
                         "expected size given")
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream failed")
    try:
        _check(lib, lib.ZSTD_initDStream(stream))
        keep = ctypes.create_string_buffer(src, len(src))
        inb = _InBuffer(ctypes.cast(keep, ctypes.c_void_p), len(src), 0)
        out, step = bytearray(), 1 << 20
        chunk = ctypes.create_string_buffer(step)
        while True:
            outb = _OutBuffer(ctypes.cast(chunk, ctypes.c_void_p), step, 0)
            left = _check(lib, lib.ZSTD_decompressStream(
                stream, ctypes.byref(outb), ctypes.byref(inb)))
            out += ctypes.string_at(chunk, outb.pos)
            if len(out) > limit:
                raise ValueError(f"zstd frame decodes past {limit} bytes")
            if left == 0:
                if inb.pos != len(src):
                    raise ValueError("zstd: bytes after the frame")
                return out
            if inb.pos == len(src) and outb.pos == 0:
                raise ValueError("zstd: truncated frame")
    finally:
        lib.ZSTD_freeDStream(stream)


# --------------------------------------------------------------- crc32c

_CRC_TABLE = None


def crc32c(data) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), table
    driven."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    table, crc = _CRC_TABLE, 0xFFFFFFFF
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------- OCDBT

class _Reader:
    """A cursor over a decoded manifest or node body."""

    def __init__(self, buf, what):
        self.buf, self.pos, self.what = memoryview(buf), 0, what

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.what}: truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self):
        return self.take(1)[0]

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self):
        out = shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n):
        return [self.varint() for _ in range(n)]


def _unwrap(raw, magic, what, limit=1 << 30) -> bytes:
    """A manifest's or node's body: its header (magic, length, version,
    compression) and trailing crc32c checked, zstd undone (to at most
    ``limit`` bytes, the database's node size limit, where the frame does
    not give its size)."""
    raw = bytes(raw)
    if len(raw) < 18 or struct.unpack(">I", raw[:4])[0] != magic:
        raise ValueError(f"{what}: not an OCDBT "
                         + ("manifest" if magic == _MANIFEST_MAGIC
                            else "b-tree node"))
    length = struct.unpack("<Q", raw[4:12])[0]
    if length != len(raw):
        raise ValueError(f"{what}: length field {length}, {len(raw)} bytes "
                         "read")
    if crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise ValueError(f"{what}: crc32c mismatch")
    head = _Reader(raw[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version}")
    body = bytes(head.buf[head.pos:])
    if compression == 1:
        return bytes(zstd_decompress(body, limit=limit))
    if compression != 0:
        raise ValueError(f"{what}: unknown compression {compression}")
    return body


def _data_file_table(r, transitive):
    """The (path, base) of each data file a manifest or node names, both
    relative to the database root: paths are prefix-compressed against the
    previous one, and each file's base path is prefixed with the base path
    the reading node inherited."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i]] + bytes(r.take(suffix[i]))
        prev = path
        text = path.decode()
        files.append((transitive + text, transitive + text[:base[i]]))
    return files


def _keys(r, n):
    """``n`` prefix-compressed keys: the shared-prefix lengths, the suffix
    lengths, then the suffixes."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    return prefix, suffix


def _key_bytes(r, prefix, suffix):
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + bytes(r.take(s))
        keys.append(prev)
    return keys


class _Ocdbt:
    """The key -> value map of an OCDBT database (the newest version)."""

    def __init__(self, root: Path):
        self.root = root
        self.entries = {}          # key -> bytes, or (file, offset, length)
        path = root / "manifest.ocdbt"
        r = _Reader(_unwrap(path.read_bytes(), _MANIFEST_MAGIC, str(path)),
                    str(path))
        r.take(16)                                     # the database uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{path}: a numbered OCDBT manifest (kind "
                             f"{kind}); the port reads single-file "
                             "manifests, as orbax writes them")
        r.varint()                                     # inline limit
        self.node_limit = r.varint()
        r.u8()                                         # version tree arity
        if r.varint() == 1:
            r.take(4)                                  # zstd level
        files = _data_file_table(r, "")
        n = r.varint()
        if n == 0:
            return
        gens, heights = r.varints(n), [r.u8() for _ in range(n)]
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        newest = max(range(n), key=gens.__getitem__)
        if offsets[newest] == _NO_OFFSET:
            return                                     # an empty tree
        self._node(files[ids[newest]], offsets[newest], lengths[newest],
                   heights[newest], b"")

    def _read(self, file, offset, length):
        with open(self.root / file, "rb") as f:
            f.seek(offset)
            raw = f.read(length)
        if len(raw) != length:
            raise ValueError(f"{self.root / file}: {len(raw)} bytes at "
                             f"{offset}, {length} expected")
        return raw

    def _node(self, file, offset, length, height, key_prefix):
        path, base = file
        what = f"{self.root / path} at {offset}"
        r = _Reader(_unwrap(self._read(path, offset, length), _NODE_MAGIC,
                            what, self.node_limit), what)
        if r.u8() != height:
            raise ValueError(f"{what}: node height differs from its parent's "
                             "record")
        files = _data_file_table(r, base)
        n = r.varint()
        prefix, suffix = _keys(r, n)
        if height == 0:
            keys = _key_bytes(r, prefix, suffix)
            sizes = r.varints(n)
            kinds = r.varints(n)
            far = [i for i in range(n) if kinds[i] == 1]
            ids, offsets = r.varints(len(far)), r.varints(len(far))
            where = dict(zip(far, zip(ids, offsets)))
            for i in range(n):
                if kinds[i] == 1:
                    fid, off = where[i]
                    value = (files[fid][0], off, sizes[i])
                elif kinds[i] == 0:
                    value = bytes(r.take(sizes[i]))
                else:
                    raise ValueError(f"{what}: value kind {kinds[i]}")
                self.entries[(key_prefix + keys[i]).decode()] = value
            return
        common = r.varints(n)
        keys = _key_bytes(r, prefix, suffix)
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        for i in range(n):
            self._node(files[ids[i]], offsets[i], lengths[i], height - 1,
                       key_prefix + keys[i][:common[i]])

    def get(self, key):
        value = self.entries.get(key)
        if isinstance(value, tuple):
            return self._read(*value)
        return value


class _Plain:
    """The files of the ``use_ocdbt=False`` layout, by key."""

    def __init__(self, root: Path):
        self.root = root

    def get(self, key):
        path = self.root / key
        return path.read_bytes() if path.is_file() else None


# ----------------------------------------------------------------- zarr

def _dtype(meta, name):
    spec = meta["dtype"]
    if spec not in _DTYPES:
        raise ValueError(f"{name}: zarr dtype {spec!r}; the port reads "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[spec]


def _fill(meta, np_dtype, name):
    fill = meta.get("fill_value")
    if fill is None:
        return 0
    if meta["dtype"] == "bfloat16":
        # tensorstore writes a bfloat16 fill as a number
        f32 = np.array(float(fill), np.float32)
        return int(f32.view(np.uint32) >> 16)
    if isinstance(fill, str):
        fill = {"NaN": math.nan, "Infinity": math.inf,
                "-Infinity": -math.inf}.get(fill)
        if fill is None:
            raise ValueError(f"{name}: zarr fill_value {meta['fill_value']!r}")
    return np_dtype(fill)


def _read_array(store, name) -> torch.Tensor:
    """The zarr v2 array ``name`` of ``store`` as a CPU tensor."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise ValueError(f"array {name!r} has no .zarray in the checkpoint")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}; "
                         f"the port reads {_READS}")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: zarr compressor {comp.get('id')!r}; the "
                         "port reads zstd and uncompressed chunks")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{name}: zarr order {order!r}")
    np_dtype, t_dtype = _dtype(meta, name)
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta, np_dtype, name), np_dtype)
    chunk_bytes = math.prod(chunks) * np.dtype(np_dtype).itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        data = store.get(f"{name}/{sep.join(map(str, idx)) or '0'}")
        if data is None:
            continue                   # a missing chunk holds fill_value
        if comp is not None:
            data = zstd_decompress(data, chunk_bytes)
        if len(data) != chunk_bytes:
            raise ValueError(f"{name}: chunk {idx} holds {len(data)} bytes, "
                             f"{chunk_bytes} expected")
        block = np.frombuffer(data, np_dtype).reshape(chunks, order=order)
        at = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[at] = block[tuple(slice(0, a.stop - a.start) for a in at)]
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if t_dtype == torch.bfloat16 else t


# ----------------------------------------------------------------- tree

_VALUE_TYPES = ("jax.Array", "np.ndarray", "scalar")


def _metadata(root: Path) -> dict:
    """``_METADATA`` of an orbax directory, its layout checked."""
    if not root.is_dir():
        raise FileNotFoundError(f"{root}: no orbax checkpoint directory")
    path = root / "_METADATA"
    if not path.is_file():
        if (root / "checkpoint").is_file():
            raise ValueError(
                f"{root}: an aggregate msgpack 'checkpoint' file (an older "
                f"orbax layout) is not read; the port reads {_READS}")
        raise ValueError(f"{root}: no orbax _METADATA file; the port reads "
                         f"{_READS}")
    meta = json.loads(path.read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{root}: a zarr v3 checkpoint (use_zarr3=true) "
                         f"is not read; the port reads {_READS}")
    if "tree_metadata" not in meta:
        raise ValueError(f"{path}: no tree_metadata; the port reads "
                         f"{_READS}")
    return meta


def _nest(node):
    """The built tree: a node whose keys are all sequence indices becomes a
    list in index order."""
    if not isinstance(node, dict):
        return node
    items = {k: _nest(v) for k, v in node.items()}
    if items and all(kind == 1 for kind, _ in items):
        return [items[k] for k in sorted(items, key=lambda k: int(k[1]))]
    return {key: v for (_, key), v in items.items()}


def read_orbax(path) -> dict:
    """The tree of the orbax directory ``path`` (either layout), its leaves
    CPU tensors in their stored dtypes."""
    root = Path(path)
    meta = _metadata(root)
    store = _Ocdbt(root) if meta.get("use_ocdbt", True) else _Plain(root)
    tree = {}
    for entry in meta["tree_metadata"].values():
        value = entry.get("value_metadata", {})
        kind = value.get("value_type")
        keys = entry["key_metadata"]
        name = ".".join(str(k["key"]) for k in keys)
        if kind not in _VALUE_TYPES or value.get("skip_deserialize"):
            raise ValueError(f"{root}: leaf {name!r} of value type {kind!r} "
                             f"(skip_deserialize "
                             f"{value.get('skip_deserialize')}); the port "
                             f"reads {_VALUE_TYPES}")
        node = tree
        for i, k in enumerate(keys):
            if k["key_type"] not in (1, 2):
                raise ValueError(f"{root}: leaf {name!r} has key type "
                                 f"{k['key_type']}")
            step = (k["key_type"], str(k["key"]))
            if i == len(keys) - 1:
                node[step] = _read_array(store, name)
            else:
                node = node.setdefault(step, {})
    return _nest(tree)


# --------------------------------------------------------------- writer

def _leaves(tree, prefix=()):
    """(key path, leaf) pairs of a tree of dicts, lists and tuples; each
    key a (key_type, key) pair as orbax records it (2 dict, 1 sequence)."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + ((2, str(k)),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + ((1, str(i)),))
    else:
        yield prefix, tree


def _host_array(leaf):
    """A leaf (tensor, numpy array or scalar) -> (its little-endian bytes
    as a C-ordered numpy array, the zarr dtype string)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype not in _TORCH_TO_ZARR:
            raise ValueError(f"dtype {t.dtype} is not written; the port "
                             f"writes {sorted(_TORCH_TO_ZARR, key=str)}")
        spec = _TORCH_TO_ZARR[t.dtype]
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), spec
        return t.numpy(), spec
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return np.ascontiguousarray(arr).view(np.uint16), "bfloat16"
    spec = arr.dtype.newbyteorder("<").str if arr.dtype.itemsize > 1 \
        else arr.dtype.str
    if spec not in _DTYPES:
        raise ValueError(f"dtype {arr.dtype} is not written; the port "
                         f"writes {sorted(_DTYPES)}")
    return np.ascontiguousarray(arr, np.dtype(spec)), spec


def _dump(path: Path, obj):
    path.write_text(json.dumps(obj, sort_keys=True, separators=(",", ":")))


def write_orbax(path, tree):
    """Write ``tree`` (nested dicts, lists and tuples of tensors, numpy
    arrays or scalars) as an orbax ``StandardCheckpointer`` directory in
    the ``use_ocdbt=False`` layout: one uncompressed zarr v2 chunk per
    array, and the ``_METADATA``, ``_CHECKPOINT_METADATA``, ``_sharding``
    and ``array_metadatas/process_0`` files. Written into a temporary
    sibling and renamed into place; raises ValueError where ``path``
    exists, as orbax does."""
    final = Path(path).absolute()
    if final.exists():
        raise ValueError(f"Destination {final} already exists.")
    tmp = final.with_name(f"{final.name}.orbax-checkpoint-tmp-{os.getpid()}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    start = time.time_ns()
    tree_meta, arrays = {}, []
    try:
        for keys, leaf in _leaves(tree):
            if not keys:
                raise ValueError("write_orbax takes a tree of dicts or "
                                 "sequences, not a bare leaf")
            arr, spec = _host_array(leaf)
            name = ".".join(k for _, k in keys)
            folder = tmp / name
            folder.mkdir()
            shape = list(arr.shape)
            chunks = [max(d, 1) for d in shape]
            _dump(folder / ".zarray", {
                "chunks": chunks, "compressor": None,
                "dimension_separator": ".", "dtype": spec,
                "fill_value": None, "filters": None, "order": "C",
                "shape": shape, "zarr_format": 2})
            if arr.size:
                (folder / (".".join("0" * arr.ndim) or "0")).write_bytes(
                    arr.tobytes())
            tree_meta[repr(tuple(k for _, k in keys))] = {
                "key_metadata": [{"key": k, "key_type": kind}
                                 for kind, k in keys],
                "value_metadata": {"value_type": "np.ndarray",
                                   "skip_deserialize": False}}
            arrays.append({"array_metadata": {
                "param_name": name, "write_shape": shape,
                "chunk_shape": chunks, "ext_metadata": None}})
        with open(tmp / "_METADATA", "w") as f:
            json.dump({"tree_metadata": tree_meta, "use_ocdbt": False,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        # host arrays carry no device sharding
        (tmp / "_sharding").write_text("{}")
        (tmp / "array_metadatas").mkdir()
        (tmp / "array_metadatas" / "process_0").write_text(
            json.dumps({"array_metadatas": arrays}))
        with open(tmp / "_CHECKPOINT_METADATA", "w") as f:
            json.dump({"item_handlers": "orbax.checkpoint._src.handlers."
                       "standard_checkpoint_handler."
                       "StandardCheckpointHandler",
                       "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": start,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        tmp.rename(final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
