"""Minimal TF-Serving Predict wire codec, standard library and numpy only
(the port's own copy of nann_tpu/serving/tfs_proto.py; it writes the same
bytes).

TF-Serving clients speak gRPC `PredictRequest`s with `comm_seq` (fp16
`[1, L*d]`) and `level_topn` (int32) TensorProtos, answered by a
`PredictResponse`. This module encodes exactly those protobuf messages by
hand, with the field numbers and wire types of the public protos
(`tensorflow/core/framework/tensor.proto`,
`tensorflow_serving/apis/predict.proto`), so a stock TF-Serving client
(a grpc stub and `tf.make_tensor_proto`) talks to the gRPC server without
tensorflow in the serving process.

Wire layout used (field = number, type):
  PredictRequest:  model_spec = 1 (msg), inputs = 2 (map<string,TensorProto>)
  PredictResponse: outputs = 1 (map<string,TensorProto>), model_spec = 2
  ModelSpec:       name = 1 (str), version = 2 (Int64Value), sig_name = 3
  TensorProto:     dtype = 1 (enum), tensor_shape = 2 (msg),
                   tensor_content = 4 (bytes), plus the repeated *_val
                   fallbacks TF uses for small/scalar tensors
  TensorShapeProto: dim = 2 (repeated msg{size = 1})
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

try:  # the bfloat16 numpy dtype, where ml_dtypes is installed
    import ml_dtypes

    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BFLOAT16 = None

# tensorflow/core/framework/types.proto DataType values
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8 = 1, 2, 3, 4
DT_INT16, DT_INT8, DT_INT64, DT_BOOL = 5, 6, 9, 10
DT_BFLOAT16, DT_UINT16, DT_HALF = 14, 17, 19
DT_UINT32, DT_UINT64 = 22, 23

_NP_TO_DT = {
    np.dtype(np.float32): DT_FLOAT, np.dtype(np.float64): DT_DOUBLE,
    np.dtype(np.int32): DT_INT32, np.dtype(np.uint8): DT_UINT8,
    np.dtype(np.int16): DT_INT16, np.dtype(np.int8): DT_INT8,
    np.dtype(np.int64): DT_INT64, np.dtype(np.bool_): DT_BOOL,
    np.dtype(np.uint16): DT_UINT16, np.dtype(np.float16): DT_HALF,
    np.dtype(np.uint32): DT_UINT32, np.dtype(np.uint64): DT_UINT64,
}
_DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}
if _BFLOAT16 is not None:
    _NP_TO_DT[_BFLOAT16] = DT_BFLOAT16
    _DT_TO_NP[DT_BFLOAT16] = _BFLOAT16

# ----------------------------------------------------------- varint plumbing


def _enc_varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int32/int64 fields
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(buf: bytes, i: int) -> Tuple[int, int]:
    val, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _tag(field: int, wire: int) -> bytes:
    return _enc_varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _enc_varint(len(payload)) + payload


def _skip(buf: bytes, i: int, wire: int) -> int:
    if wire == 0:
        _, i = _dec_varint(buf, i)
    elif wire == 1:
        i += 8
    elif wire == 2:
        ln, i = _dec_varint(buf, i)
        i += ln
    elif wire == 5:
        i += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return i


def _fields(buf: bytes):
    """Yield (field, wire, value) — value is bytes for wire 2, int for 0,
    raw 4/8 bytes for 5/1."""
    i = 0
    while i < len(buf):
        key, i = _dec_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _dec_varint(buf, i)
        elif wire == 2:
            ln, i = _dec_varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


# ------------------------------------------------------------- TensorProto


def encode_tensor(arr: np.ndarray) -> bytes:
    """np.ndarray -> serialized tensorflow.TensorProto (tensor_content
    form, the layout `tf.make_tensor_proto` emits for numpy arrays)."""
    arr = np.ascontiguousarray(arr)
    dt = _NP_TO_DT.get(arr.dtype)
    if dt is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    shape = b"".join(
        _len_delim(2, _tag(1, 0) + _enc_varint(int(d))) for d in arr.shape)
    return (_tag(1, 0) + _enc_varint(dt)
            + _len_delim(2, shape)
            + _len_delim(4, arr.tobytes()))


def _packed_or_single(wire: int, v, fmt: Optional[str] = None) -> list:
    """Repeated scalar field: packed (wire 2) or one unpacked element."""
    if wire == 2:  # packed
        if fmt is None:  # varints
            out, i = [], 0
            while i < len(v):
                x, i = _dec_varint(v, i)
                out.append(x)
            return out
        size = struct.calcsize(fmt)
        return [struct.unpack_from("<" + fmt, v, o)[0]
                for o in range(0, len(v), size)]
    if fmt is None:
        return [v]
    return [struct.unpack("<" + fmt, v)[0]]


def decode_tensor(buf: bytes) -> np.ndarray:
    dtype_code, shape, content = DT_FLOAT, [], None
    vals: list = []
    for field, wire, v in _fields(buf):
        if field == 1 and wire == 0:
            dtype_code = v
        elif field == 2 and wire == 2:  # TensorShapeProto
            for f2, w2, v2 in _fields(v):
                if f2 == 2 and w2 == 2:  # Dim
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1 and w3 == 0:
                            shape.append(_signed(v3))
        elif field == 4 and wire == 2:
            content = v
        elif field == 5:    # float_val
            vals += _packed_or_single(wire, v, "f")
        elif field == 6:    # double_val
            vals += _packed_or_single(wire, v, "d")
        elif field == 7:    # int_val
            vals += [_signed(x) for x in _packed_or_single(wire, v)]
        elif field == 10:   # int64_val
            vals += [_signed(x) for x in _packed_or_single(wire, v)]
        elif field == 11:   # bool_val
            vals += _packed_or_single(wire, v)
        elif field == 13:   # half_val (fp16/bf16 bit patterns as int32)
            vals += _packed_or_single(wire, v)
    np_dtype = _DT_TO_NP.get(dtype_code)
    if np_dtype is None:
        raise ValueError(f"unsupported TensorProto dtype {dtype_code}")
    n = int(np.prod(shape)) if shape else 1
    if content is not None:
        arr = np.frombuffer(content, dtype=np_dtype)
    elif vals:
        if dtype_code in (DT_HALF, DT_BFLOAT16):  # bit patterns
            arr = np.asarray(vals, np.uint16).view(np_dtype)
        else:
            arr = np.asarray(vals, dtype=np_dtype)
        if arr.size == 1 and n > 1:  # proto scalar broadcast
            arr = np.full(n, arr[0], dtype=np_dtype)
    else:
        arr = np.zeros(n, dtype=np_dtype)
    return arr.reshape(shape)


def _signed(x: int, bits: int = 64) -> int:
    return x - (1 << bits) if x >= (1 << (bits - 1)) else x


# ------------------------------------------------- Predict request/response


def _enc_model_spec(name: str, signature_name: str = "serving_default",
                    version: Optional[int] = None) -> bytes:
    out = _len_delim(1, name.encode())
    if version is not None:  # google.protobuf.Int64Value{value = 1}
        out += _len_delim(2, _tag(1, 0) + _enc_varint(version))
    out += _len_delim(3, signature_name.encode())
    return out


def _dec_model_spec(buf: bytes) -> Dict[str, object]:
    spec: Dict[str, object] = {}
    for field, wire, v in _fields(buf):
        if field == 1 and wire == 2:
            spec["name"] = v.decode()
        elif field == 2 and wire == 2:
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 0:
                    spec["version"] = _signed(v2)
        elif field == 3 and wire == 2:
            spec["signature_name"] = v.decode()
    return spec


def _enc_tensor_map(field: int, tensors: Dict[str, np.ndarray]) -> bytes:
    out = b""
    for k, arr in tensors.items():
        entry = _len_delim(1, k.encode()) + _len_delim(2, encode_tensor(arr))
        out += _len_delim(field, entry)
    return out


def _dec_map_entry(buf: bytes) -> Tuple[str, np.ndarray]:
    key, val = "", np.zeros(0, np.float32)
    for field, wire, v in _fields(buf):
        if field == 1 and wire == 2:
            key = v.decode()
        elif field == 2 and wire == 2:
            val = decode_tensor(v)
    return key, val


def encode_predict_request(inputs: Dict[str, np.ndarray],
                           model_name: str = "nann",
                           signature_name: str = "serving_default") -> bytes:
    return (_len_delim(1, _enc_model_spec(model_name, signature_name))
            + _enc_tensor_map(2, inputs))


def decode_predict_request(buf: bytes) -> Tuple[Dict[str, object],
                                                Dict[str, np.ndarray]]:
    spec: Dict[str, object] = {}
    inputs: Dict[str, np.ndarray] = {}
    for field, wire, v in _fields(buf):
        if field == 1 and wire == 2:
            spec = _dec_model_spec(v)
        elif field == 2 and wire == 2:
            k, arr = _dec_map_entry(v)
            inputs[k] = arr
    return spec, inputs


def encode_predict_response(outputs: Dict[str, np.ndarray],
                            model_name: str = "nann",
                            signature_name: str = "serving_default") -> bytes:
    return (_enc_tensor_map(1, outputs)
            + _len_delim(2, _enc_model_spec(model_name, signature_name)))


def decode_predict_response(buf: bytes) -> Tuple[Dict[str, object],
                                                 Dict[str, np.ndarray]]:
    spec: Dict[str, object] = {}
    outputs: Dict[str, np.ndarray] = {}
    for field, wire, v in _fields(buf):
        if field == 2 and wire == 2:
            spec = _dec_model_spec(v)
        elif field == 1 and wire == 2:
            k, arr = _dec_map_entry(v)
            outputs[k] = arr
    return spec, outputs
