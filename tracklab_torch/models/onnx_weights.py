"""ONNX checkpoint weights without the onnx package (counterpart of
tracklab_tpu.models.onnx_weights).

The reference runs YOLOX, RTMDet and RTMPose from published .onnx files
through ONNX Runtime; here the graph runs as the port's models, and only
the file's weights are read. ONNX is protobuf, and the part needed
(ModelProto.graph.initializer: TensorProto name, dims, dtype, data) is
parsed with a small wire-format reader.

Folded-BatchNorm exports (mmdeploy's and rtmlib's deployment files) fuse
each BN into its conv, which gains a bias, and drop the BN tensors;
:func:`convert_onnx_folded_bn` turns such a file into the port's conv + BN
layout by making each BN an exact pass-through (mean 0, var 1, weight
sqrt(1 + eps), bias the conv's bias).
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

__all__ = ["parse_onnx_initializers", "convert_onnx_folded_bn"]

# TensorProto.DataType -> numpy dtype
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
           5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
           10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64}


def _read_varint(buf, i):
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _to_i64(v):
    """Protobuf int64 varints carry negatives as 10-byte two's-complement
    (e.g. axes=[-1] in a Reshape constant); fold back into signed range."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf):
    """Yield (field_number, wire_type, value_bytes_or_int) over a
    protobuf message buffer."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _parse_tensor(buf):
    dims = []
    dtype = 1
    name = ""
    raw = None
    f32 = []
    i64 = []
    f64 = []
    for field, wt, v in _fields(buf):
        if field == 1:              # dims (int64, maybe packed)
            if wt == 0:
                dims.append(v)
            else:
                i = 0
                while i < len(v):
                    d, i = _read_varint(v, i)
                    dims.append(d)
        elif field == 2 and wt == 0:
            dtype = v
        elif field == 4:            # float_data
            if wt == 5:
                f32.append(struct.unpack("<f", v)[0])
            else:
                f32.extend(np.frombuffer(v, "<f4").tolist())
        elif field == 7:            # int64_data (two's-complement varints)
            if wt == 0:
                i64.append(_to_i64(v))
            else:
                i = 0
                while i < len(v):
                    d, i = _read_varint(v, i)
                    i64.append(_to_i64(d))
        elif field == 8 and wt == 2:
            name = v.decode("utf-8", "replace")
        elif field == 9 and wt == 2:
            raw = v
        elif field == 11:           # double_data
            if wt == 1:
                f64.append(struct.unpack("<d", v)[0])
            else:
                f64.extend(np.frombuffer(v, "<f8").tolist())
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        return name, None
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif f32:
        arr = np.asarray(f32, np.float32)
    elif f64:
        arr = np.asarray(f64, np.float64)
    elif i64:
        arr = np.asarray(i64, np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    try:
        arr = arr.reshape(dims)
    except ValueError:
        return name, None
    return name, arr


def parse_onnx_initializers(path) -> dict:
    """name -> numpy array for every graph initializer in an .onnx file
    (ModelProto field 7 = graph; GraphProto field 5 = initializer)."""
    buf = Path(path).read_bytes()
    out = {}
    for field, wt, v in _fields(buf):
        if field == 7 and wt == 2:          # ModelProto.graph
            for gf, gwt, gv in _fields(v):
                if gf == 5 and gwt == 2:    # GraphProto.initializer
                    name, arr = _parse_tensor(gv)
                    if arr is not None and name:
                        out[name] = arr
    return out


def convert_onnx_folded_bn(sd_or_path, model, bn_eps: float = 1e-3) -> dict:
    """An .onnx file's weight tensors (or its parsed initializers) -> a
    state dict in ``model``'s torch names for the family's converter
    (``convert.py``). Each BN of ``model`` whose tensors the file lacks
    and whose conv has a bias in it (``<m>.conv.bias``, as folding always
    leaves: b = beta - mean * gamma / std) becomes a pass-through of
    ``conv(x) + b``, and the conv's bias is taken up there. Initializers
    whose names are no weight's (a graph's shape constants and decode
    grids: ``onnx::Reshape_123``, ``Constant_5``) are left out; any other
    tensor the model does not hold stays, so that the converter reports
    it."""
    sd = (dict(sd_or_path) if isinstance(sd_or_path, dict)
          else parse_onnx_initializers(sd_or_path))
    sd = {k: v for k, v in sd.items() if _looks_like_weight(k)}
    out = dict(sd)
    for key, own in model.state_dict().items():
        suffix = next((s for s in _BN_SUFFIXES if key.endswith(s)), None)
        if key in sd or suffix is None:
            continue
        bias = key[:-len(suffix)] + ".conv.bias"
        if bias not in sd:
            continue            # a genuine miss: the converter reports it
        shape = tuple(own.shape)
        out[key] = {".bn.weight": np.full(shape, np.sqrt(1.0 + bn_eps),
                                          np.float32),
                    ".bn.bias": np.asarray(sd[bias],
                                           np.float32).reshape(shape),
                    ".bn.running_mean": np.zeros(shape, np.float32),
                    ".bn.running_var": np.ones(shape, np.float32)}[suffix]
        out.pop(bias, None)
    return out


_BN_SUFFIXES = (".bn.weight", ".bn.bias", ".bn.running_mean",
                ".bn.running_var")
_WEIGHT_SUFFIXES = (".weight", ".bias", ".running_mean", ".running_var")


def _looks_like_weight(name: str) -> bool:
    return name.endswith(_WEIGHT_SUFFIXES) and not name.startswith("onnx::")
