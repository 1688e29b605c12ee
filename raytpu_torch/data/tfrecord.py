"""The port's copy of :mod:`raytpu.data.tfrecord` (the port imports nothing
of the JAX package), unchanged.

TFRecord container + tf.train.Example codec, dependency-free.

Reference analogue: ``python/ray/data/datasource/tfrecords_datasource.py``
(read/write of TFRecord files holding ``tf.train.Example`` protos). The
reference leans on tensorflow / ``tfx-bsl`` for parsing; neither ships
in this image, so both layers are implemented directly:

- The TFRecord framing: ``[len u64le][masked-crc32c(len) u32le][data]
  [masked-crc32c(data) u32le]`` per record (the classic TFRecordWriter
  layout), with table-driven CRC32C (Castagnoli) in pure Python.
- The ``Example`` proto wire format, hand-rolled for its tiny fixed
  schema: Example{Features{map<string, Feature>}} where Feature is one
  of BytesList / FloatList(packed) / Int64List(packed).

Scope: enough to round-trip real TFRecord/Example files produced by
TensorFlow tooling; not a general protobuf implementation.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List

import numpy as np

# -- CRC32C (Castagnoli, reflected poly 0x82F63B78) ----------------------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    # Built into a local list and published with one atomic assignment:
    # concurrent first callers (parallel read tasks run as threads in
    # the local backend) must never observe a partially built table.
    global _CRC_TABLE
    if not _CRC_TABLE:
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- TFRecord framing ----------------------------------------------------

def write_records(path: str, records: List[bytes]) -> None:
    with open(path, "wb") as f:
        for data in records:
            length = struct.pack("<Q", len(data))
            f.write(length)
            f.write(struct.pack("<I", _masked_crc(length)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


def read_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,), (len_crc,) = (struct.unpack("<Q", header[:8]),
                                     struct.unpack("<I", header[8:]))
            if _masked_crc(header[:8]) != len_crc:
                raise ValueError(f"corrupt TFRecord length crc in {path}")
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"truncated TFRecord data in {path}")
            crc_bytes = f.read(4)
            if len(crc_bytes) < 4:
                raise ValueError(f"truncated TFRecord data crc in {path}")
            (data_crc,) = struct.unpack("<I", crc_bytes)
            if _masked_crc(data) != data_crc:
                raise ValueError(f"corrupt TFRecord data crc in {path}")
            yield data


# -- minimal protobuf wire helpers ---------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _ld(field: int, payload: bytes) -> bytes:  # length-delimited
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _fields(buf: bytes) -> Iterator[tuple]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # fixed32
            val = buf[pos:pos + 4]
            pos += 4
        elif wt == 1:  # fixed64
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, val


def _zigzag_i64(v: int) -> int:
    """int64 varints are two's-complement on the wire (not zigzag)."""
    return v - (1 << 64) if v >= 1 << 63 else v


# -- tf.train.Example codec ----------------------------------------------

def encode_example(features: Dict[str, object]) -> bytes:
    """Dict -> serialized Example. Values: bytes/str -> BytesList,
    float arrays -> FloatList, int arrays -> Int64List; lists/ndarrays
    become multi-value features."""
    feats = bytearray()
    for name, value in features.items():
        if isinstance(value, (bytes, str)):
            values = [value]
        elif isinstance(value, np.ndarray):
            values = list(value.reshape(-1))
        elif isinstance(value, (list, tuple)):
            values = list(value)
        else:
            values = [value]
        if not values:
            feature = _ld(3, b"")  # empty Int64List
        elif isinstance(values[0], (bytes, str)):
            bl = bytearray()
            for v in values:
                bl += _ld(1, v.encode() if isinstance(v, str) else v)
            feature = _ld(1, bytes(bl))
        elif isinstance(values[0], (float, np.floating)):
            packed = struct.pack(f"<{len(values)}f",
                                 *[float(v) for v in values])
            feature = _ld(2, _ld(1, packed))
        elif isinstance(values[0], (int, np.integer)):
            pv = bytearray()
            for v in values:
                pv += _varint(int(v) & 0xFFFFFFFFFFFFFFFF)
            feature = _ld(3, _ld(1, bytes(pv)))
        else:
            raise TypeError(f"feature {name!r}: unsupported value type "
                            f"{type(values[0]).__name__}")
        entry = _ld(1, name.encode()) + _ld(2, feature)
        feats += _ld(1, entry)  # map entry on Features.feature
    return _ld(1, bytes(feats))  # Example.features


def decode_example(data: bytes) -> Dict[str, object]:
    """Serialized Example -> {name: scalar or list}. Single-value
    features decode to scalars (the common case for tabular data);
    multi-value features decode to lists."""
    out: Dict[str, object] = {}
    for f, _, features_buf in _fields(data):
        if f != 1:
            continue
        for f2, _, entry in _fields(features_buf):
            if f2 != 1:
                continue
            name, feature = None, b""
            for f3, _, v in _fields(entry):
                if f3 == 1:
                    name = v.decode()
                elif f3 == 2:
                    feature = v
            if name is None:
                continue
            values: List[object] = []
            for f4, _, lst in _fields(feature):
                if f4 == 1:  # BytesList
                    values = [v for f5, _, v in _fields(lst) if f5 == 1]
                elif f4 == 2:  # FloatList (packed or not)
                    for f5, wt5, v in _fields(lst):
                        if f5 != 1:
                            continue
                        if wt5 == 2:  # packed
                            values.extend(struct.unpack(
                                f"<{len(v) // 4}f", v))
                        else:  # unpacked fixed32
                            values.append(struct.unpack("<f", v)[0])
                elif f4 == 3:  # Int64List (packed or not)
                    for f5, wt5, v in _fields(lst):
                        if f5 != 1:
                            continue
                        if wt5 == 2:  # packed varints
                            pos = 0
                            while pos < len(v):
                                iv, pos = _read_varint(v, pos)
                                values.append(_zigzag_i64(iv))
                        else:
                            values.append(_zigzag_i64(v))
            out[name] = values[0] if len(values) == 1 else values
    return out
