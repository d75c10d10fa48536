"""A dependency-free reader of the ONNX ModelProto wire format
(counterpart of ``curl_tpu/utils/onnx_lite.py``, a copy of its own: the
port imports nothing of the JAX package).

``torch.onnx`` writes ONNX protobufs without the ``onnx`` package, so the
converter decodes the protobuf wire format directly, the few message types
a model graph uses, in place of the reference's ``onnx.load``
(curl/nn/onnx_converter.py:200-208). Numpy only.

Only the fields needed for graph conversion are decoded:

  ModelProto      graph=7
  GraphProto      node=1 initializer=5 input=11 output=12
  NodeProto       input=1 output=2 name=3 op_type=4 attribute=5
  AttributeProto  name=1 f=2 i=3 s=4 t=5 floats=7 ints=8 type=20
  TensorProto     dims=1 data_type=2 float_data=4 int32_data=5
                  int64_data=7 name=8 raw_data=9 double_data=10
  ValueInfoProto  name=1
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _signed(v: int) -> int:
    """Interpret a 64-bit varint as a signed int64 (two's complement)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples from a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fieldno, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire == _WIRE_I64:
            value = buf[pos:pos + 8]
            pos += 8
        elif wire == _WIRE_LEN:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == _WIRE_I32:
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield fieldno, wire, value


def _packed_varints(value, wire):
    """A repeated int64 field arrives packed (wire 2) or one-at-a-time."""
    if wire == _WIRE_VARINT:
        return [_signed(value)]
    out = []
    pos = 0
    while pos < len(value):
        v, pos = _read_varint(value, pos)
        out.append(_signed(v))
    return out


def _packed_floats(value, wire):
    if wire == _WIRE_I32:
        return [struct.unpack("<f", value)[0]]
    return list(struct.unpack(f"<{len(value) // 4}f", value))


# ONNX TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


@dataclass
class TensorProto:
    name: str = ""
    dims: List[int] = field(default_factory=list)
    data_type: int = 1
    array: Optional[np.ndarray] = None


def _parse_tensor(buf: bytes) -> TensorProto:
    t = TensorProto()
    float_data: List[float] = []
    int_data: List[int] = []
    double_data: List[float] = []
    raw = None
    for fieldno, wire, value in _fields(buf):
        if fieldno == 1:
            t.dims.extend(_packed_varints(value, wire))
        elif fieldno == 2:
            t.data_type = value
        elif fieldno == 4:
            float_data.extend(_packed_floats(value, wire))
        elif fieldno == 5:
            int_data.extend(_packed_varints(value, wire))
        elif fieldno == 7:
            int_data.extend(_packed_varints(value, wire))
        elif fieldno == 8:
            t.name = value.decode("utf-8")
        elif fieldno == 9:
            raw = bytes(value)
        elif fieldno == 10:
            if wire == _WIRE_I64:
                double_data.append(struct.unpack("<d", value)[0])
            else:
                double_data.extend(
                    struct.unpack(f"<{len(value) // 8}d", value)
                )
    dtype = _DTYPES.get(t.data_type, np.float32)
    shape = tuple(t.dims)
    if raw is not None:
        t.array = np.frombuffer(raw, dtype=dtype).reshape(shape)
    elif float_data:
        t.array = np.asarray(float_data, dtype=dtype).reshape(shape)
    elif double_data:
        t.array = np.asarray(double_data, dtype=dtype).reshape(shape)
    elif int_data:
        t.array = np.asarray(int_data, dtype=dtype).reshape(shape)
    else:
        t.array = np.zeros(shape, dtype=dtype)
    return t


@dataclass
class AttributeProto:
    name: str = ""
    value: Any = None


def _parse_attribute(buf: bytes) -> AttributeProto:
    a = AttributeProto()
    floats: List[float] = []
    ints: List[int] = []
    f_val = i_val = s_val = t_val = None
    atype = None
    for fieldno, wire, value in _fields(buf):
        if fieldno == 1:
            a.name = value.decode("utf-8")
        elif fieldno == 2:
            f_val = struct.unpack("<f", value)[0]
        elif fieldno == 3:
            i_val = _signed(value)
        elif fieldno == 4:
            s_val = bytes(value)
        elif fieldno == 5:
            t_val = _parse_tensor(value).array
        elif fieldno == 7:
            floats.extend(_packed_floats(value, wire))
        elif fieldno == 8:
            ints.extend(_packed_varints(value, wire))
        elif fieldno == 20:
            atype = value
    # AttributeProto.type disambiguates zero-valued scalars
    # (FLOAT=1 INT=2 STRING=3 TENSOR=4 FLOATS=6 INTS=7)
    if atype == 7 or (atype is None and ints):
        a.value = ints
    elif atype == 6 or (atype is None and floats):
        a.value = floats
    elif atype == 4 or t_val is not None:
        a.value = t_val
    elif atype == 3 or s_val is not None:
        a.value = s_val
    elif atype == 2 or i_val is not None:
        a.value = i_val
    elif atype == 1 or f_val is not None:
        a.value = f_val
    return a


@dataclass
class NodeProto:
    op_type: str = ""
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attributes: Dict[str, Any] = field(default_factory=dict)


def _parse_node(buf: bytes) -> NodeProto:
    n = NodeProto()
    for fieldno, wire, value in _fields(buf):
        if fieldno == 1:
            n.inputs.append(value.decode("utf-8"))
        elif fieldno == 2:
            n.outputs.append(value.decode("utf-8"))
        elif fieldno == 3:
            n.name = value.decode("utf-8")
        elif fieldno == 4:
            n.op_type = value.decode("utf-8")
        elif fieldno == 5:
            attr = _parse_attribute(value)
            n.attributes[attr.name] = attr.value
    return n


def _parse_value_info_name(buf: bytes) -> str:
    for fieldno, wire, value in _fields(buf):
        if fieldno == 1:
            return value.decode("utf-8")
    return ""


@dataclass
class GraphProto:
    nodes: List[NodeProto] = field(default_factory=list)
    initializers: List[TensorProto] = field(default_factory=list)
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)


@dataclass
class ModelProto:
    graph: GraphProto = field(default_factory=GraphProto)


def _parse_graph(buf: bytes) -> GraphProto:
    g = GraphProto()
    for fieldno, wire, value in _fields(buf):
        if fieldno == 1:
            g.nodes.append(_parse_node(value))
        elif fieldno == 5:
            g.initializers.append(_parse_tensor(value))
        elif fieldno == 11:
            g.inputs.append(_parse_value_info_name(value))
        elif fieldno == 12:
            g.outputs.append(_parse_value_info_name(value))
    return g


def load_model(data) -> ModelProto:
    """Parse an ONNX ModelProto from bytes, a file path, or a file object."""
    if hasattr(data, "read"):
        if hasattr(data, "seek"):
            data.seek(0)
        data = data.read()
    elif isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    model = ModelProto()
    for fieldno, wire, value in _fields(bytes(data)):
        if fieldno == 7:
            model.graph = _parse_graph(value)
    return model
