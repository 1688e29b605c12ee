"""The port's copy of :mod:`raytpu.data.avro` (the port imports nothing
of the JAX package), unchanged.

Avro Object Container File codec, dependency-free.

Reference analogue: ``python/ray/data/datasource/avro_datasource.py``
(which leans on the ``fastavro`` wheel; not shipped in this image, so
the format is implemented directly). Scope: the OCF container (magic,
metadata, sync-marked blocks, null/deflate codecs) and the standard
binary encoding for records built from primitives, nullable unions,
enums, fixed, arrays, maps, and nested records — enough to round-trip
files produced by fastavro / avro-tools for tabular data.

Spec: https://avro.apache.org/docs/current/specification/ (the binary
encoding + object container file sections).
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Any, Dict, Iterator, List, Tuple

MAGIC = b"Obj\x01"


# -- zigzag varint (Avro int/long) ---------------------------------------

def _write_long(out: io.BytesIO, n: int) -> None:
    n = (n << 1) ^ (n >> 63)  # zigzag
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([bits | 0x80]))
        else:
            out.write(bytes([bits]))
            return


def _read_long(buf: io.BufferedIOBase) -> int:
    result = shift = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated avro varint")
        result |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            break
        shift += 7
    return (result >> 1) ^ -(result & 1)  # un-zigzag


def _write_bytes(out: io.BytesIO, data: bytes) -> None:
    _write_long(out, len(data))
    out.write(data)


def _read_bytes(buf: io.BufferedIOBase) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) < n:
        raise EOFError("truncated avro bytes")
    return data


# -- datum encoding against a schema -------------------------------------

def _schema_type(schema) -> str:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    return schema["type"]


def write_datum(out: io.BytesIO, schema, value) -> None:
    t = _schema_type(schema)
    if t == "null":
        return
    if t == "boolean":
        out.write(b"\x01" if value else b"\x00")
    elif t in ("int", "long"):
        _write_long(out, int(value))
    elif t == "float":
        out.write(struct.pack("<f", float(value)))
    elif t == "double":
        out.write(struct.pack("<d", float(value)))
    elif t == "bytes":
        _write_bytes(out, bytes(value))
    elif t == "string":
        _write_bytes(out, value.encode() if isinstance(value, str)
                     else bytes(value))
    elif t == "union":
        idx = _pick_union_branch(schema, value)
        _write_long(out, idx)
        write_datum(out, schema[idx], value)
    elif t == "record":
        # .get: infer_schema makes omitted keys nullable; honor that.
        for f in schema["fields"]:
            write_datum(out, f["type"], value.get(f["name"]))
    elif t == "enum":
        _write_long(out, schema["symbols"].index(value))
    elif t == "fixed":
        if len(value) != schema["size"]:
            raise ValueError(f"fixed {schema.get('name')}: expected "
                             f"{schema['size']} bytes, got {len(value)}")
        out.write(bytes(value))
    elif t == "array":
        items = list(value)
        if items:
            _write_long(out, len(items))
            for item in items:
                write_datum(out, schema["items"], item)
        _write_long(out, 0)
    elif t == "map":
        if value:
            _write_long(out, len(value))
            for k, v in value.items():
                _write_bytes(out, k.encode())
                write_datum(out, schema["values"], v)
        _write_long(out, 0)
    else:
        raise ValueError(f"unsupported avro type {t!r}")


def _pick_union_branch(union: List, value) -> int:
    def matches(branch) -> bool:
        bt = _schema_type(branch)
        if bt == "null":
            return value is None
        if bt == "boolean":
            return isinstance(value, bool)
        if bt in ("int", "long"):
            return isinstance(value, int) and not isinstance(value, bool)
        if bt in ("float", "double"):
            # ints are encodable as doubles (schema wins over the
            # Python type — a nullable-double column holding 1 must not
            # fail the write).
            return isinstance(value, (int, float)) \
                and not isinstance(value, bool)
        if bt == "string":
            return isinstance(value, str)
        if bt == "bytes":
            return isinstance(value, (bytes, bytearray))
        if bt == "record":
            return isinstance(value, dict)
        if bt == "array":
            return isinstance(value, (list, tuple))
        return False

    for i, branch in enumerate(union):
        if matches(branch):
            return i
    raise ValueError(f"value {value!r} matches no union branch {union}")


def read_datum(buf: io.BufferedIOBase, schema):
    t = _schema_type(schema)
    if t == "null":
        return None
    if t == "boolean":
        return buf.read(1) == b"\x01"
    if t in ("int", "long"):
        return _read_long(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "bytes":
        return _read_bytes(buf)
    if t == "string":
        return _read_bytes(buf).decode()
    if t == "union":
        return read_datum(buf, schema[_read_long(buf)])
    if t == "record":
        return {f["name"]: read_datum(buf, f["type"])
                for f in schema["fields"]}
    if t == "enum":
        return schema["symbols"][_read_long(buf)]
    if t == "fixed":
        return buf.read(schema["size"])
    if t == "array":
        out = []
        while True:
            n = _read_long(buf)
            if n == 0:
                return out
            if n < 0:  # block with byte-size prefix
                _read_long(buf)
                n = -n
            for _ in range(n):
                out.append(read_datum(buf, schema["items"]))
    if t == "map":
        out = {}
        while True:
            n = _read_long(buf)
            if n == 0:
                return out
            if n < 0:
                _read_long(buf)
                n = -n
            for _ in range(n):
                key = _read_bytes(buf).decode()
                out[key] = read_datum(buf, schema["values"])
    raise ValueError(f"unsupported avro type {t!r}")


# -- object container file ------------------------------------------------

def read_file(path: str) -> Tuple[dict, Iterator[dict]]:
    """Returns (schema, iterator of records)."""
    f = open(path, "rb")
    try:
        if f.read(4) != MAGIC:
            raise ValueError(
                f"{path} is not an avro object container file")
        meta: Dict[str, bytes] = {}
        while True:
            n = _read_long(f)
            if n == 0:
                break
            if n < 0:
                _read_long(f)
                n = -n
            for _ in range(n):
                key = _read_bytes(f).decode()
                meta[key] = _read_bytes(f)
        if "avro.schema" not in meta:
            raise ValueError(f"{path}: no avro.schema in file metadata")
        schema = json.loads(meta["avro.schema"])
        codec = meta.get("avro.codec", b"null").decode()
        if codec not in ("null", "deflate"):
            raise ValueError(f"unsupported avro codec {codec!r} "
                             f"(supported: null, deflate)")
        sync = f.read(16)
    except BaseException:
        f.close()
        raise

    def records() -> Iterator[dict]:
        try:
            while True:
                try:
                    count = _read_long(f)
                except EOFError:
                    return
                size = _read_long(f)
                data = f.read(size)
                if len(data) < size:
                    raise EOFError(f"truncated avro block in {path}")
                if codec == "deflate":
                    data = zlib.decompress(data, -15)
                block = io.BytesIO(data)
                for _ in range(count):
                    yield read_datum(block, schema)
                if f.read(16) != sync:
                    raise ValueError(f"avro sync marker mismatch in "
                                     f"{path}")
        finally:
            f.close()

    return schema, records()


def write_file(path: str, schema: dict, records: List[dict],
               codec: str = "null", sync: bytes = None) -> None:
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    if sync is None:
        import os

        sync = os.urandom(16)  # per-file marker, as the spec intends
    with open(path, "wb") as f:
        f.write(MAGIC)
        head = io.BytesIO()
        _write_long(head, 2)
        _write_bytes(head, b"avro.schema")
        _write_bytes(head, json.dumps(schema).encode())
        _write_bytes(head, b"avro.codec")
        _write_bytes(head, codec.encode())
        _write_long(head, 0)
        f.write(head.getvalue())
        f.write(sync)
        if records:
            body = io.BytesIO()
            for r in records:
                write_datum(body, schema, r)
            data = body.getvalue()
            if codec == "deflate":
                data = zlib.compress(data)[2:-4]  # raw deflate, no adler
            block = io.BytesIO()
            _write_long(block, len(records))
            _write_long(block, len(data))
            f.write(block.getvalue())
            f.write(data)
            f.write(sync)


def infer_schema(rows: List[dict], name: str = "raytpu_record") -> dict:
    """Record schema from sample rows: long/double/string/bytes/boolean
    primitives, nullable (union with null) when any sample is None."""
    import numpy as np

    fields = []
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    for k in keys:
        sample = [r.get(k) for r in rows]
        types = set()
        for v in sample:
            if v is None:
                types.add("null")
            elif isinstance(v, bool):
                types.add("boolean")
            elif isinstance(v, (int, np.integer)):
                types.add("long")
            elif isinstance(v, (float, np.floating)):
                types.add("double")
            elif isinstance(v, str):
                types.add("string")
            elif isinstance(v, (bytes, bytearray)):
                types.add("bytes")
            else:
                raise TypeError(
                    f"column {k!r}: cannot infer avro type for "
                    f"{type(v).__name__}; pass an explicit schema")
        if {"long", "double"} <= types:  # mixed numerics widen to double
            types = (types - {"long"})
        non_null = sorted(types - {"null"})
        if len(non_null) > 1:
            raise TypeError(f"column {k!r}: mixed types {non_null}; "
                            f"pass an explicit schema")
        base = non_null[0] if non_null else "null"
        fields.append({"name": k,
                       "type": ["null", base] if "null" in types
                       and base != "null" else base})
    return {"type": "record", "name": name, "fields": fields}
