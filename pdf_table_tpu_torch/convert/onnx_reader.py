"""Minimal ONNX initializer reader — no onnx/onnxruntime dependency (a copy of
pdf_table_tpu/convert/onnx_reader.py: numpy only, the same flax-layout
trees).

The reference runs its PaddleOCR-family models (det/rec/SLANet/PicoDet/
PULC) as downloaded ONNX graphs (SURVEY.md §1 L2), so users' weights are
.onnx files. This parses just enough protobuf wire format to extract the
graph's initializer tensors (name -> numpy array) for conversion into the
flax modules.

Wire format walked: ModelProto.graph (field 7) -> GraphProto.initializer
(field 5, repeated TensorProto) -> TensorProto {dims:1, data_type:2,
float_data:4, int64_data:7, name:8, raw_data:9}.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:                      # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:                    # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:                    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:                    # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims = []
    dtype = 1
    name = ""
    raw = None
    floats = []
    int64s = []
    for field, wt, val in _iter_fields(buf):
        if field == 1 and wt == 0:
            dims.append(val)
        elif field == 1 and wt == 2:      # packed dims
            pos = 0
            while pos < len(val):
                d, pos = _read_varint(val, pos)
                dims.append(d)
        elif field == 2:
            dtype = val
        elif field == 4 and wt == 2:      # packed float_data
            floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 4 and wt == 5:
            floats.append(struct.unpack("<f", val)[0])
        elif field == 7 and wt == 2:      # packed int64_data
            pos = 0
            while pos < len(val):
                v, pos = _read_varint(val, pos)
                int64s.append(v - (1 << 64) if v >= (1 << 63) else v)
        elif field == 7 and wt == 0:
            int64s.append(val)
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def read_onnx_initializers(path_or_bytes) -> Dict[str, np.ndarray]:
    """-> {initializer name: array} from an .onnx file."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    out: Dict[str, np.ndarray] = {}
    for field, wt, val in _iter_fields(data):          # ModelProto
        if field == 7 and wt == 2:                     # graph
            for gf, gwt, gval in _iter_fields(val):    # GraphProto
                if gf == 5 and gwt == 2:               # initializer
                    name, arr = _parse_tensor(gval)
                    out[name] = arr
    return out


def encode_test_onnx(tensors: Dict[str, np.ndarray]) -> bytes:
    """Build a minimal ModelProto holding the given initializers (testing
    aid — the inverse of read_onnx_initializers for round-trips)."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                out += bytes([b7])
                return out

    def field(num: int, wt: int, payload: bytes) -> bytes:
        return varint((num << 3) | wt) + (varint(len(payload)) + payload
                                          if wt == 2 else payload)

    graph = b""
    rev_dtype = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
                 np.dtype(np.uint8): 2}
    for name, arr in tensors.items():
        t = b""
        for d in arr.shape:
            t += field(1, 0, varint(d))
        t += field(2, 0, varint(rev_dtype[arr.dtype]))
        t += field(8, 2, name.encode())
        t += field(9, 2, np.ascontiguousarray(arr).tobytes())
        graph += field(5, 2, t)
    return field(7, 2, graph)
