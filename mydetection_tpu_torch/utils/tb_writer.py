"""Dependency-free TensorBoard scalar writer.

A copy of `mydetection_tpu/utils/tb_writer.py` (pure Python). The
reference logs training scalars to TensorBoard via
`torch.utils.tensorboard.SummaryWriter`; that needs the tensorboard
package, so the train CLI's primary sink is JSONL, and this module
writes real `events.out.tfevents.*` files by hand that any external
TensorBoard can render.

Wire format (TFRecord framing, one Event proto per record):

    uint64le  length
    uint32le  masked_crc32c(length_bytes)
    bytes     payload                     # serialized Event
    uint32le  masked_crc32c(payload)

with masked_crc(c) = ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32 and
CRC32C the Castagnoli polynomial. The Event/Summary protos are encoded
directly (only the 4 fields scalars need):

    Event:   1 wall_time double, 2 step int64, 3 file_version string,
             5 summary message
    Summary: 1 value repeated { 1 tag string, 2 simple_value float }

Scope: scalars only — exactly the surface the reference used (loss
terms, lr, val AP).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven; anchored by the RFC 3720 test
# vector crc32c(b"123456789") == 0xE3069283 in tests.
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal proto encoding
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    # proto varints are unsigned; negative int64s encode as their
    # two's complement (10 bytes). Masking also keeps the loop finite —
    # Python's arithmetic right-shift never zeroes a negative n.
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, *, step: int | None = None,
           file_version: str | None = None,
           scalars: dict[str, float] | None = None) -> bytes:
    out = bytearray()
    out += bytes([0x09]) + struct.pack("<d", wall_time)        # 1: double
    if step is not None:
        out += bytes([0x10]) + _varint(step)                   # 2: int64
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if scalars:
        summary = bytearray()
        for tag, value in scalars.items():
            v = (_field_bytes(1, tag.encode())
                 + bytes([0x15]) + struct.pack("<f", float(value)))
            summary += _field_bytes(1, bytes(v))
        out += _field_bytes(5, bytes(summary))
    return bytes(out)


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class TBWriter:
    """Append-only scalar event writer, SummaryWriter-shaped.

        w = TBWriter(logdir)
        w.add_scalar("loss/total", 3.2, step=100)
        w.add_scalars({"lr": 1e-3, "loss/obj": 1.1}, step=100)
        w.close()
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(logdir, name)
        self._fh = open(self.path, "ab")
        self._fh.write(_record(_event(time.time(),
                                      file_version="brain.Event:2")))
        self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.add_scalars({tag: value}, step)

    def add_scalars(self, scalars: dict[str, float], step: int) -> None:
        self._fh.write(_record(_event(time.time(), step=int(step),
                                      scalars=scalars)))

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# reader (for tests and offline inspection without tensorboard)
# ---------------------------------------------------------------------------

def read_scalars(path: str) -> list[tuple[int, str, float]]:
    """Parse an events file back into (step, tag, value) rows,
    verifying both CRCs of every record — an independent decode path
    for tests and for inspecting runs without tensorboard installed."""
    rows = []
    with open(path, "rb") as fh:
        data = fh.read()
    off = 0
    while off < len(data):
        (ln,) = struct.unpack_from("<Q", data, off)
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        if hcrc != _masked_crc(data[off:off + 8]):
            raise ValueError(f"bad length crc at offset {off}")
        payload = data[off + 12:off + 12 + ln]
        (pcrc,) = struct.unpack_from("<I", data, off + 12 + ln)
        if pcrc != _masked_crc(payload):
            raise ValueError(f"bad payload crc at offset {off}")
        off += 12 + ln + 4
        rows.extend(_decode_event(payload))
    return rows


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _decode_event(buf: bytes) -> list[tuple[int, str, float]]:
    i, step, pairs = 0, 0, []
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 1:
            if num == 2:
                pass  # step is varint (wire 0); double fields skipped
            i += 8
        elif wire == 5:
            i += 4
        elif wire == 0:
            val, i = _read_varint(buf, i)
            if num == 2:
                step = val
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            sub = buf[i:i + ln]
            i += ln
            if num == 5:  # summary
                j = 0
                while j < len(sub):
                    k2, j = _read_varint(sub, j)
                    if k2 >> 3 == 1 and k2 & 7 == 2:
                        vlen, j = _read_varint(sub, j)
                        pairs.append(_decode_value(sub[j:j + vlen]))
                        j += vlen
                    else:
                        raise ValueError("unexpected summary field")
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return [(step, tag, val) for tag, val in pairs]


def _decode_value(buf: bytes) -> tuple[str, float]:
    i, tag, val = 0, "", float("nan")
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if num == 1 and wire == 2:
            ln, i = _read_varint(buf, i)
            tag = buf[i:i + ln].decode()
            i += ln
        elif num == 2 and wire == 5:
            (val,) = struct.unpack_from("<f", buf, i)
            i += 4
        else:
            raise ValueError(f"unexpected value field {num}/{wire}")
    return tag, val
