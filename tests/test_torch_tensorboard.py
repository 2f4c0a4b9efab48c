"""The port's TensorBoard writer (trainer/tensorboard.py) against the JAX
package's: the TFRecord framing with its masked CRC32C and the scalar
encoding; a file written by either package reads back through the other's
``read_scalars`` with the same values (fp32 scalars, exact)."""

import os
import struct

import numpy as np
import pytest

from neuronx_distributed_llama3_2_tpu.trainer import tensorboard as jtb
from neuronx_distributed_llama3_2_tpu_torch.trainer import tensorboard as ttb
from neuronx_distributed_llama3_2_tpu_torch.trainer.tensorboard import (
    TensorBoardLogger,
    _crc32c,
    _masked_crc,
    read_scalars,
)


def test_crc32c_known_vectors():
    # RFC 3720 test vectors
    assert _crc32c(b"") == 0x0
    assert _crc32c(b"123456789") == 0xE3069283
    assert _crc32c(b"\x00" * 32) == 0x8A9136AA


def test_writer_roundtrip(tmp_path):
    logdir = tmp_path / "tb"
    with TensorBoardLogger(str(logdir)) as tb:
        for step in range(5):
            tb.log_scalars(step, {"train/loss": 5.0 - step * 0.5, "train/lr": 1e-4 * step})
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].startswith("events.out.tfevents.")
    scalars = read_scalars(str(logdir / files[0]))
    assert set(scalars) == {"train/loss", "train/lr"}
    np.testing.assert_allclose(scalars["train/loss"][0], 5.0)
    np.testing.assert_allclose(scalars["train/loss"][4], 3.0)
    np.testing.assert_allclose(scalars["train/lr"][3], 3e-4, rtol=1e-6)


def test_file_version_header(tmp_path):
    logdir = tmp_path / "tb"
    TensorBoardLogger(str(logdir)).close()
    data = (logdir / os.listdir(logdir)[0]).read_bytes()
    (length,) = struct.unpack("<Q", data[:8])
    assert b"brain.Event:2" in data[12:12 + length]
    assert struct.unpack("<I", data[8:12])[0] == _masked_crc(data[:8])


def test_corruption_detected(tmp_path):
    logdir = tmp_path / "tb"
    with TensorBoardLogger(str(logdir)) as tb:
        tb.log_scalars(1, {"x": 1.0})
    path = logdir / os.listdir(logdir)[0]
    raw = bytearray(path.read_bytes())
    raw[-5] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc"):
        read_scalars(str(path))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_cross_the_packages(tmp_path, writer):
    """A file written by one package reads back through the other's
    reader, scalar for scalar; the records (wall time aside) are the
    same bytes."""
    logger = TensorBoardLogger if writer == "port" else jtb.TensorBoardLogger
    reader = jtb.read_scalars if writer == "port" else read_scalars
    values = {step: {"train/loss": 4.0 / (step + 1), "train/grad_norm": 0.25 * step}
              for step in range(6)}
    with logger(str(tmp_path)) as tb:
        for step, sc in values.items():
            tb.log_scalars(step, sc)
    path = str(tmp_path / os.listdir(tmp_path)[0])
    got = reader(path)
    assert got == {tag: {s: float(np.float32(values[s][tag])) for s in values}
                   for tag in ("train/loss", "train/grad_norm")}
    assert jtb._event(1.5, step=3, scalars={"a": 1.0}) == ttb._event(1.5, step=3, scalars={"a": 1.0})
