"""TensorBoard scalar event writer, dependency-free.

A copy of ``neuronx_distributed_llama3_2_tpu/trainer/tensorboard.py``: the
``events.out.tfevents.*`` files that TensorBoard reads, written by hand (the
TFRecord framing with its masked CRC32C, and the two small protobuf
messages), so that neither tensorflow nor tensorboard is needed:

    Event   { double wall_time = 1; int64 step = 2;
              string file_version = 3; Summary summary = 11; }
    Summary { repeated Value value = 1; }
    Value   { string tag = 1; float simple_value = 2; }

Only rank 0 writes when a ``torch.distributed`` group is up (one events
file per run, not one per process). :func:`read_scalars` reads the files
back, CRC-checked.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, Optional

_CRC_TABLE = []


def _crc32c_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _event(
    wall_time: float,
    step: int = 0,
    file_version: Optional[str] = None,
    scalars: Optional[Dict[str, float]] = None,
) -> bytes:
    msg = bytearray()
    msg += _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        msg += _varint(2 << 3 | 0) + _varint(step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = bytearray()
        for tag, value in scalars.items():
            val = (
                _field_bytes(1, tag.encode())
                + _varint(2 << 3 | 5)
                + struct.pack("<f", float(value))
            )
            summary += _field_bytes(1, val)
        msg += _field_bytes(11, bytes(summary))
    return bytes(msg)


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + data
        + struct.pack("<I", _masked_crc(data))
    )


class TensorBoardLogger:
    """Append-only scalar logger; one events file per instance."""

    def __init__(self, logdir: str, filename_suffix: str = "") -> None:
        import torch.distributed as dist

        self._enabled = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
        self._f = None
        if not self._enabled:
            return
        os.makedirs(logdir, exist_ok=True)
        name = (
            f"events.out.tfevents.{int(time.time())}."
            f"{os.uname().nodename}.{os.getpid()}{filename_suffix}"
        )
        self._f = open(os.path.join(logdir, name), "ab")
        self._f.write(_record(_event(time.time(), file_version="brain.Event:2")))
        self._f.flush()

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        if not self._enabled:
            return
        self._f.write(_record(_event(time.time(), step=step, scalars=scalars)))
        # flush per event (records are ~60 bytes): a crashed run must not
        # lose its final — most diagnostic — steps, and live TensorBoard
        # tailing should see data immediately
        self._f.flush()

    def flush(self) -> None:
        if self._f:
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.flush()
            self._f.close()
            self._f = None

    def __enter__(self) -> "TensorBoardLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_scalars(path: str) -> Dict[str, Dict[int, float]]:
    """Minimal event-file reader (crc-checked) — tag → {step: value}.
    Test/debug utility; TensorBoard itself is the real consumer."""
    out: Dict[str, Dict[int, float]] = {}
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise ValueError("corrupt event file: header crc mismatch")
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if dcrc != _masked_crc(data):
                raise ValueError("corrupt event file: data crc mismatch")
            step, summary = 0, b""
            i = 0
            while i < len(data):
                key = data[i]
                i += 1
                field, wire = key >> 3, key & 7
                if wire == 1:
                    i += 8
                elif wire == 5:
                    i += 4
                elif wire == 0:
                    v = 0
                    shift = 0
                    while True:
                        b = data[i]
                        i += 1
                        v |= (b & 0x7F) << shift
                        shift += 7
                        if not b & 0x80:
                            break
                    if field == 2:
                        step = v
                elif wire == 2:
                    ln = 0
                    shift = 0
                    while True:
                        b = data[i]
                        i += 1
                        ln |= (b & 0x7F) << shift
                        shift += 7
                        if not b & 0x80:
                            break
                    if field == 11:
                        summary = data[i : i + ln]
                    i += ln
            # parse Summary { repeated Value value = 1 }
            j = 0
            while j < len(summary):
                key = summary[j]
                j += 1
                ln = 0
                shift = 0
                while True:
                    b = summary[j]
                    j += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                val = summary[j : j + ln]
                j += ln
                tag, simple = "", None
                k = 0
                while k < len(val):
                    vkey = val[k]
                    k += 1
                    vf, vw = vkey >> 3, vkey & 7
                    if vw == 2:
                        vln = 0
                        shift = 0
                        while True:
                            b = val[k]
                            k += 1
                            vln |= (b & 0x7F) << shift
                            shift += 7
                            if not b & 0x80:
                                break
                        if vf == 1:
                            tag = val[k : k + vln].decode()
                        k += vln
                    elif vw == 5:
                        if vf == 2:
                            (simple,) = struct.unpack("<f", val[k : k + 4])
                        k += 4
                    elif vw == 1:
                        k += 8
                if tag and simple is not None:
                    out.setdefault(tag, {})[step] = simple
    return out
