"""Minimal pure-python ONNX reader (protobuf wire-format walk, no onnx /
onnxruntime / protoc dependency). A copy of
``idmvton_tpu/weights/onnx_reader.py``, which imports no JAX: the port
keeps its own.

The reference ships its human-parsing models ONLY as ONNX artifacts
(reference: preprocess/humanparsing/run_parsing.py:20-22 loads
ckpt/humanparsing/parsing_atr.onnx + parsing_lip.onnx via onnxruntime).
Ingesting those weights therefore requires reading TensorProto
initializers out of a serialized ModelProto. This module parses the
protobuf wire format directly: varint/length-delimited framing, the
ModelProto -> GraphProto -> TensorProto/NodeProto fields we need, and
nothing else.

Field numbers follow onnx/onnx.proto3:
  ModelProto:  graph=7
  GraphProto:  node=1, initializer=5, input=11, output=12
  NodeProto:   input=1, output=2, name=3, op_type=4
  TensorProto: dims=1, data_type=2, float_data=4, int32_data=5,
               int64_data=7, name=8, raw_data=9, double_data=10,
               data_location=14
  ValueInfoProto: name=1
"""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Tuple, Union

import numpy as np

# TensorProto.DataType -> numpy dtype (bfloat16/strings intentionally absent)
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


class OnnxNode(NamedTuple):
    op_type: str
    name: str
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]


class OnnxModel(NamedTuple):
    initializers: Dict[str, np.ndarray]
    nodes: List[OnnxNode]
    graph_inputs: List[str]
    graph_outputs: List[str]


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    r, s = 0, 0
    while True:
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << s
        if not b & 0x80:
            return r, i
        s += 7
        if s > 70:
            raise ValueError("malformed varint")


def _fields(buf: bytes, i: int, end: int):
    """Yield (field_no, wire_type, value) where value is an int for varints,
    a (start, end) span for length-delimited fields, raw bytes otherwise."""
    while i < end:
        key, i = _varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = (i, i + ln)
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt} for field {fno}")
        yield fno, wt, v


def _string(buf: bytes, span) -> str:
    return bytes(buf[span[0]:span[1]]).decode("utf-8")


def _repeated_varints(buf, wt, v, out: list):
    """A repeated integer field arrives packed (length-delimited) or not."""
    if wt == 0:
        out.append(v)
    else:
        j, k = v
        while j < k:
            d, j = _varint(buf, j)
            out.append(d)


def _parse_tensor(buf: bytes, s: int, e: int) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code, name, raw = 1, "", None
    f32: list = []
    f64: list = []
    ints: list = []
    for fno, wt, v in _fields(buf, s, e):
        if fno == 1:
            _repeated_varints(buf, wt, v, dims)
        elif fno == 2 and wt == 0:
            dtype_code = v
        elif fno == 8 and wt == 2:
            name = _string(buf, v)
        elif fno == 9 and wt == 2:
            raw = bytes(buf[v[0]:v[1]])
        elif fno == 4:  # float_data
            if wt == 5:
                f32.append(struct.unpack("<f", v)[0])
            else:
                f32.extend(np.frombuffer(buf[v[0]:v[1]], "<f4").tolist())
        elif fno == 10:  # double_data
            if wt == 1:
                f64.append(struct.unpack("<d", v)[0])
            else:
                f64.extend(np.frombuffer(buf[v[0]:v[1]], "<f8").tolist())
        elif fno in (5, 7, 11):  # int32_data / int64_data / uint64_data
            _repeated_varints(buf, wt, v, ints)
        elif fno == 14 and wt == 0 and v != 0:
            raise ValueError(
                f"initializer '{name}': external data is not supported")
    if dtype_code not in _DTYPES:
        raise ValueError(f"initializer '{name}': unsupported data_type "
                         f"{dtype_code}")
    dt = np.dtype(_DTYPES[dtype_code])
    if raw is not None:
        arr = np.frombuffer(raw, np.uint8 if dt == np.bool_ else dt)
        arr = arr.astype(np.bool_) if dt == np.bool_ else arr
    elif f32:
        arr = np.asarray(f32, np.float32)
    elif f64:
        arr = np.asarray(f64, np.float64)
    else:
        # int32_data carries varints as two's complement already; int64_data
        # values above 2^63-1 wrap negative, matching protobuf semantics
        arr = np.asarray([x - (1 << 64) if x >= (1 << 63) else x
                          for x in ints], np.int64)
    arr = arr.astype(dt, copy=False)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _parse_node(buf: bytes, s: int, e: int) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    op_type, name = "", ""
    for fno, wt, v in _fields(buf, s, e):
        if fno == 1 and wt == 2:
            inputs.append(_string(buf, v))
        elif fno == 2 and wt == 2:
            outputs.append(_string(buf, v))
        elif fno == 3 and wt == 2:
            name = _string(buf, v)
        elif fno == 4 and wt == 2:
            op_type = _string(buf, v)
    return OnnxNode(op_type, name, tuple(inputs), tuple(outputs))


def _value_info_name(buf: bytes, s: int, e: int) -> str:
    for fno, wt, v in _fields(buf, s, e):
        if fno == 1 and wt == 2:
            return _string(buf, v)
    return ""


def _parse_graph(buf: bytes, s: int, e: int) -> OnnxModel:
    initializers: Dict[str, np.ndarray] = {}
    nodes: List[OnnxNode] = []
    gin: List[str] = []
    gout: List[str] = []
    for fno, wt, v in _fields(buf, s, e):
        if wt != 2:
            continue
        if fno == 5:
            name, arr = _parse_tensor(buf, v[0], v[1])
            initializers[name] = arr
        elif fno == 1:
            nodes.append(_parse_node(buf, v[0], v[1]))
        elif fno == 11:
            gin.append(_value_info_name(buf, v[0], v[1]))
        elif fno == 12:
            gout.append(_value_info_name(buf, v[0], v[1]))
        elif fno == 15:
            raise ValueError("sparse initializers are not supported")
    return OnnxModel(initializers, nodes, gin, gout)


def read_onnx(src: Union[str, bytes]) -> OnnxModel:
    """src: path to a .onnx file or its serialized bytes."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        buf = bytes(src)
    else:
        with open(src, "rb") as f:
            buf = f.read()
    for fno, wt, v in _fields(buf, 0, len(buf)):
        if fno == 7 and wt == 2:  # ModelProto.graph
            return _parse_graph(buf, v[0], v[1])
    raise ValueError("no GraphProto found — not a serialized ONNX ModelProto")
