"""Wire-compatible codec for interfaces/libreasr.proto (the JAX
package's serving/proto.py, the port's own copy).

The two tiny messages are encoded by hand, byte-identical to the
protobuf wire format, so no generated stubs are needed:

  message Audio      { bytes data = 1; int32 sr = 3; }
  message Transcript { string data = 1; }
  service ASR { rpc Transcribe(Audio) returns (Transcript);
                rpc TranscribeStream(stream Audio) returns (stream Transcript); }

(interfaces/libreasr.proto; package ASR, so the method paths are
/ASR.ASR/Transcribe and /ASR.ASR/TranscribeStream)
"""

from __future__ import annotations

from dataclasses import dataclass

SERVICE = "ASR.ASR"
METHOD_TRANSCRIBE = f"/{SERVICE}/Transcribe"
METHOD_TRANSCRIBE_STREAM = f"/{SERVICE}/TranscribeStream"


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's complement for negative int32/int64
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:  # len-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


@dataclass
class Audio:
    data: bytes = b""
    sr: int = 16000

    def SerializeToString(self) -> bytes:
        out = b""
        if self.data:
            out += b"\x0a" + _varint(len(self.data)) + self.data
        if self.sr:
            out += b"\x18" + _varint(self.sr)
        return out

    @classmethod
    def FromString(cls, buf: bytes) -> "Audio":
        m = cls(data=b"", sr=0)
        for field, wire, val in _fields(buf):
            if field == 1 and wire == 2:
                m.data = bytes(val)
            elif field == 3 and wire == 0:
                # int32: interpret as signed 64 then truncate
                m.sr = val - (1 << 64) if val >= (1 << 63) else val
        return m


@dataclass
class Transcript:
    data: str = ""

    def SerializeToString(self) -> bytes:
        raw = self.data.encode("utf-8")
        return (b"\x0a" + _varint(len(raw)) + raw) if raw else b""

    @classmethod
    def FromString(cls, buf: bytes) -> "Transcript":
        m = cls()
        for field, wire, val in _fields(buf):
            if field == 1 and wire == 2:
                m.data = bytes(val).decode("utf-8", errors="replace")
        return m
