"""Minimal proto3 wire-format codec (varint + length-delimited fields):
the port's copy of tpufhe/serialize/proto.py.

Implements exactly the message surface of the reference's
fhe-math/src/proto/rq.proto and fhe/src/proto/bfv.proto, so serialized
objects are wire-compatible. No protobuf runtime dependency.
"""

from __future__ import annotations

from tpufhe_torch.errors import SerializationError


def encode_varint(v: int) -> bytes:
    assert v >= 0
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise SerializationError("varint too long")


def zigzag_encode(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1


def zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def tag(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


def emit_varint_field(field: int, v: int) -> bytes:
    if v == 0:
        return b""  # proto3 default omitted
    return tag(field, 0) + encode_varint(v)


def emit_bool_field(field: int, v: bool) -> bytes:
    return emit_varint_field(field, 1 if v else 0)


def emit_bytes_field(field: int, data: bytes, always: bool = False) -> bytes:
    if not data and not always:
        return b""
    return tag(field, 2) + encode_varint(len(data)) + bytes(data)


def emit_packed_varints(field: int, values) -> bytes:
    values = list(values)
    if not values:
        return b""
    payload = b"".join(encode_varint(int(v)) for v in values)
    return tag(field, 2) + encode_varint(len(payload)) + payload


def emit_packed_sint64(field: int, values) -> bytes:
    return emit_packed_varints(field, [zigzag_encode(int(v)) for v in values])


class ProtoReader:
    """Iterates (field_number, wire_type, value) triples of one message."""

    def __init__(self, buf: bytes):
        self.buf = bytes(buf)
        self.pos = 0

    def __iter__(self):
        while self.pos < len(self.buf):
            key, self.pos = decode_varint(self.buf, self.pos)
            field, wire = key >> 3, key & 7
            if wire == 0:
                v, self.pos = decode_varint(self.buf, self.pos)
                yield field, wire, v
            elif wire == 2:
                ln, self.pos = decode_varint(self.buf, self.pos)
                data = self.buf[self.pos : self.pos + ln]
                if len(data) != ln:
                    raise SerializationError("truncated message")
                self.pos += ln
                yield field, wire, data
            elif wire == 5:
                data = self.buf[self.pos : self.pos + 4]
                self.pos += 4
                yield field, wire, data
            elif wire == 1:
                data = self.buf[self.pos : self.pos + 8]
                self.pos += 8
                yield field, wire, data
            else:
                raise SerializationError(f"unsupported wire type {wire}")


def parse_packed_varints(data: bytes) -> list[int]:
    out = []
    pos = 0
    while pos < len(data):
        v, pos = decode_varint(data, pos)
        out.append(v)
    return out
