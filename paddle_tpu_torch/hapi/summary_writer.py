"""Experiment-logging scalar writer, TensorBoard event-file format
(counterpart of paddle_tpu/hapi/summary_writer.py, whose code this is:
it imports nothing of JAX).

Capability match for the reference's VisualDL callback
(ref: python/paddle/hapi/callbacks.py VisualDL — scalar curves per
train/eval step): the events are written in TensorBoard's
`events.out.tfevents.*` format instead of VisualDL's, as paddle_tpu
writes them. Self-contained: the TFRecord framing (masked crc32c) and
the Event/Summary protobuf messages are hand-encoded below — no
tensorboard/protobuf dependency."""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

__all__ = ["SummaryWriter", "VisualDL"]

# -- crc32c (Castagnoli, reflected poly 0x82F63B78) ------------------------
_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 * (c & 1))
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf encoding --------------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_varint(num: int, val: int) -> bytes:
    return _varint(num << 3) + _varint(val)


def _field_double(num: int, val: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", val)


def _field_float(num: int, val: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", val)


def _field_bytes(num: int, val: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(val)) + val


def _event(wall_time: float, step: int, file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    # Event: 1=wall_time double, 2=step int64, 3=file_version string,
    # 5=summary message (tensorboard/compat/proto/event.proto)
    out = _field_double(1, wall_time)
    if step:
        out += _field_varint(2, step)
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if summary is not None:
        out += _field_bytes(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    # Summary{ repeated Value{1=tag string, 2=simple_value float} }
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    return _field_bytes(1, val)


class SummaryWriter:
    """Append-only TensorBoard scalar-event writer.

    Usage:
        w = SummaryWriter("./runs/exp1")
        w.add_scalar("train/loss", 0.3, step=10)
        w.close()
    """

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._record(_event(time.time(), 0, file_version="brain.Event:2"))

    def _record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value, step: int = 0) -> None:
        import numpy as np
        v = float(np.asarray(value).reshape(-1)[0])
        self._record(_event(time.time(), int(step),
                            summary=_scalar_summary(tag, v)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


from .model_api import Callback  # noqa: E402


class VisualDL(Callback):
    """hapi callback logging train/eval scalars per step/epoch
    (ref: python/paddle/hapi/callbacks.py VisualDL; TB event format —
    see module docstring). Drop into Model.fit(callbacks=[...])."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._writer: Optional[SummaryWriter] = None
        self._step = 0
        self._epoch = 0

    @property
    def writer(self) -> SummaryWriter:
        if self._writer is None:
            self._writer = SummaryWriter(self.log_dir)
        return self._writer

    def _log(self, prefix: str, logs, step: int) -> None:
        for k, v in (logs or {}).items():
            try:
                self.writer.add_scalar(f"{prefix}/{k}", v, step)
            except (TypeError, ValueError):
                pass        # non-scalar entries (e.g. shapes) are skipped

    def on_train_begin(self, logs=None):
        self._step = 0

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._log("train", logs, self._step)

    def on_epoch_end(self, epoch, logs=None):
        self._log("train_epoch", logs, epoch)
        self.writer.flush()

    def on_eval_end(self, logs=None):
        self._log("eval", logs, self._epoch)
        self.writer.flush()

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()
