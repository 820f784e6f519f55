"""``tf.train.Example`` protobuf wire codec — dependency-free.

Port of ``tensorflowonspark_tpu/example_proto.py``, copied; the native
decoder is the port's own build of ``native/tfrecord.cc`` (``tfrecord.py``).

The reference converts DataFrame rows to/from serialized ``tf.train.Example``
protos (``dfutil.py::toTFExample`` / ``fromTFExample``) using TensorFlow's
generated proto classes.  TensorFlow isn't a dependency of this rebuild, so
the tiny stable schema is encoded/decoded directly at the protobuf wire
level.  The message graph (tensorflow/core/example/example.proto and
feature.proto):

    Example  { Features features = 1; }
    Features { map<string, Feature> feature = 1; }
    Feature  { oneof kind { BytesList bytes_list = 1;
                            FloatList float_list = 2;
                            Int64List int64_list = 3; } }
    BytesList { repeated bytes value = 1; }
    FloatList { repeated float value = 1 [packed]; }
    Int64List { repeated int64 value = 1 [packed]; }

Output is byte-compatible with TF: records written here parse with
``tf.train.Example.FromString`` and vice versa (packed and unpacked repeated
encodings are both accepted on decode).
"""

from __future__ import annotations

import struct
from typing import Any, Iterable

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


# -- varint / wire primitives ----------------------------------------------

def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit (proto int64)
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_len_field(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, _tag(field, _WIRE_LEN))
    _write_varint(out, len(payload))
    out.extend(payload)


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == _WIRE_VARINT:
        _, pos = _read_varint(buf, pos)
        return pos
    if wire == _WIRE_64BIT:
        return pos + 8
    if wire == _WIRE_LEN:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire == _WIRE_32BIT:
        return pos + 4
    raise ValueError(f"unsupported wire type {wire}")


# -- Feature encode ---------------------------------------------------------

def encode_bytes_list(values: Iterable[bytes]) -> bytes:
    inner = bytearray()
    for v in values:
        if isinstance(v, str):
            v = v.encode("utf-8")
        _write_len_field(inner, 1, bytes(v))
    out = bytearray()
    _write_len_field(out, 1, bytes(inner))  # Feature.bytes_list = 1
    return bytes(out)


def encode_float_list(values: Iterable[float]) -> bytes:
    values = list(values)
    packed = struct.pack(f"<{len(values)}f", *values)
    inner = bytearray()
    _write_len_field(inner, 1, packed)      # FloatList.value packed
    out = bytearray()
    _write_len_field(out, 2, bytes(inner))  # Feature.float_list = 2
    return bytes(out)


def encode_int64_list(values: Iterable[int]) -> bytes:
    packed = bytearray()
    for v in values:
        _write_varint(packed, int(v))
    inner = bytearray()
    _write_len_field(inner, 1, bytes(packed))  # Int64List.value packed
    out = bytearray()
    _write_len_field(out, 3, bytes(inner))     # Feature.int64_list = 3
    return bytes(out)


def encode_feature(values: Any) -> bytes:
    """Encode a python value/list into a Feature by type sniffing, the same
    dispatch ``dfutil.py::toTFExample`` does on DataFrame column types."""
    import numpy as np

    if isinstance(values, np.ndarray):
        values = values.tolist()
    if not isinstance(values, (list, tuple)):
        values = [values]
    if not values:
        return encode_bytes_list([])
    first = values[0]
    if isinstance(first, (bytes, bytearray, str)):
        return encode_bytes_list(values)
    if isinstance(first, (bool, int, np.integer)):
        return encode_int64_list(int(v) for v in values)
    if isinstance(first, (float, np.floating)):
        return encode_float_list(float(v) for v in values)
    raise TypeError(f"cannot encode feature from {type(first).__name__}")


def encode_example(features: dict[str, Any]) -> bytes:
    """dict of {name: value/list} → serialized tf.train.Example bytes."""
    feat_map = bytearray()
    for name in sorted(features):                 # deterministic output
        entry = bytearray()
        _write_len_field(entry, 1, name.encode("utf-8"))   # key
        _write_len_field(entry, 2, encode_feature(features[name]))  # value
        _write_len_field(feat_map, 1, bytes(entry))  # Features.feature entry
    out = bytearray()
    _write_len_field(out, 1, bytes(feat_map))        # Example.features = 1
    return bytes(out)


# -- Feature decode ---------------------------------------------------------

def _decode_bytes_list(buf: bytes) -> list[bytes]:
    values = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        if tag >> 3 == 1 and (tag & 7) == _WIRE_LEN:
            n, pos = _read_varint(buf, pos)
            values.append(buf[pos:pos + n])
            pos += n
        else:
            pos = _skip_field(buf, pos, tag & 7)
    return values


def _decode_float_list(buf: bytes) -> list[float]:
    values: list[float] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == _WIRE_LEN:      # packed
            n, pos = _read_varint(buf, pos)
            values.extend(struct.unpack(f"<{n // 4}f", buf[pos:pos + n]))
            pos += n
        elif field == 1 and wire == _WIRE_32BIT:  # unpacked
            values.append(struct.unpack("<f", buf[pos:pos + 4])[0])
            pos += 4
        else:
            pos = _skip_field(buf, pos, wire)
    return values


def _decode_int64_list(buf: bytes) -> list[int]:
    values: list[int] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == _WIRE_LEN:      # packed
            n, pos = _read_varint(buf, pos)
            end = pos + n
            while pos < end:
                v, pos = _read_varint(buf, pos)
                values.append(_signed64(v))
        elif field == 1 and wire == _WIRE_VARINT:  # unpacked
            v, pos = _read_varint(buf, pos)
            values.append(_signed64(v))
        else:
            pos = _skip_field(buf, pos, wire)
    return values


def decode_feature(buf: bytes) -> tuple[str, list]:
    """Feature bytes → (kind, values) where kind ∈ bytes/float/int64."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire != _WIRE_LEN:
            pos = _skip_field(buf, pos, wire)
            continue
        n, pos = _read_varint(buf, pos)
        payload = buf[pos:pos + n]
        pos += n
        if field == 1:
            return "bytes", _decode_bytes_list(payload)
        if field == 2:
            return "float", _decode_float_list(payload)
        if field == 3:
            return "int64", _decode_int64_list(payload)
    return "bytes", []   # empty Feature


_KINDS = ("bytes", "float", "int64")


def decode_example(buf: bytes) -> dict[str, tuple[str, list]]:
    """Serialized Example → {name: (kind, values)}.

    Uses the native parser (``native/tfrecord.cc::exp_scan``, measured
    ~6× the pure-Python loop on MNIST-shaped records) when the codec
    library is available; the Python path below is the behavioral oracle
    and the fallback.  Outputs are identical either way."""
    out = _decode_example_native(buf)
    if out is not None:
        return out
    return decode_example_py(buf)


def _decode_example_native(buf: bytes) -> dict[str, tuple[str, list]] | None:
    import ctypes

    import numpy as np

    from tensorflowonspark_tpu_torch.tfrecord import _native

    lib = _native()
    if lib is None:
        return None
    buf = bytes(buf)  # ctypes c_char_p rejects bytearray/memoryview
    buflen = len(buf)
    max_feats = 64
    while True:
        meta = np.empty((max_feats, 6), np.int64)
        n = lib.exp_scan(buf, buflen,
                         meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                         max_feats)
        if n < 0:
            raise ValueError("malformed Example protobuf")
        if n <= max_feats:
            break
        max_feats = int(n)
    features: dict[str, tuple[str, list]] = {}
    for i in range(int(n)):
        name_off, name_len, kind, count, pay_off, pay_len = (
            int(v) for v in meta[i])
        name = buf[name_off:name_off + name_len].decode("utf-8")
        payload = buf[pay_off:pay_off + pay_len]
        if kind == 2:                                    # int64
            arr = np.empty(count, np.int64)
            got = lib.exp_read_int64(
                payload, pay_len,
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), count)
            if got != count:
                raise ValueError("malformed int64 list")
            values = arr.tolist()
        elif kind == 1:                                  # float
            arr = np.empty(count, np.float32)
            got = lib.exp_read_float(
                payload, pay_len,
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), count)
            if got != count:
                raise ValueError("malformed float list")
            values = arr.tolist()
        else:                                            # bytes
            offs = np.empty((max(count, 1), 2), np.int64)
            got = lib.exp_read_bytes(
                payload, pay_len,
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), count)
            if got != count:
                raise ValueError("malformed bytes list")
            values = [payload[int(o):int(o) + int(ln)]
                      for o, ln in offs[:count]]
        features[name] = (_KINDS[kind], values)
    return features


def decode_example_py(buf: bytes) -> dict[str, tuple[str, list]]:
    """Pure-Python Example decoder (oracle + no-compiler fallback)."""
    features: dict[str, tuple[str, list]] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        if tag >> 3 == 1 and (tag & 7) == _WIRE_LEN:   # Example.features
            n, pos = _read_varint(buf, pos)
            fbuf = buf[pos:pos + n]
            pos += n
            fpos = 0
            while fpos < len(fbuf):
                ftag, fpos = _read_varint(fbuf, fpos)
                if ftag >> 3 == 1 and (ftag & 7) == _WIRE_LEN:  # map entry
                    en, fpos = _read_varint(fbuf, fpos)
                    entry = fbuf[fpos:fpos + en]
                    fpos += en
                    key, value = None, ("bytes", [])
                    epos = 0
                    while epos < len(entry):
                        etag, epos = _read_varint(entry, epos)
                        efield, ewire = etag >> 3, etag & 7
                        if ewire != _WIRE_LEN:
                            epos = _skip_field(entry, epos, ewire)
                            continue
                        vn, epos = _read_varint(entry, epos)
                        payload = entry[epos:epos + vn]
                        epos += vn
                        if efield == 1:
                            key = payload.decode("utf-8")
                        elif efield == 2:
                            value = decode_feature(payload)
                    if key is not None:
                        features[key] = value
                else:
                    fpos = _skip_field(fbuf, fpos, ftag & 7)
        else:
            pos = _skip_field(buf, pos, tag & 7)
    return features
