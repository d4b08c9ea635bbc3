"""The port's TensorBoard export (``core/tb_export.py``) on the CPU, against
JAX's: the CRC32C vectors, TFRecord framing, and the port's event files
decoded by JAX's ``read_events`` into the (tag, step, value) records of
JAX's export of the same JSONL."""

import os
import struct

import numpy as np
import pytest

from soft_contrastive_learning_tpu.core import tb_export as jtb
from soft_contrastive_learning_torch.core import tb_export as ttb
from soft_contrastive_learning_torch.core.logging import MetricsWriter


@pytest.mark.parametrize("data,crc", [(b"", 0x00000000), (b"123456789", 0xE3069283),
                                      (bytes(32), 0x8A9136AA), (bytes([0xFF] * 32), 0x62A8AB43)])
def test_crc32c_known_vectors(data, crc):
    """RFC 3720's CRC32C vectors, and JAX's masked CRC of the same bytes."""
    assert ttb._crc32c(data) == crc
    assert ttb._masked_crc(data) == jtb._masked_crc(data)


def test_varint_and_event_bytes_equal_jax_s():
    for n in (0, 1, 127, 128, 300, 2**40, -1):
        assert ttb._varint(n) == jtb._varint(n)
    values = {"loss": 1.5, "%<25m@Top1": 75.0, "learning_rate": 5e-6}
    assert ttb._encode_event(123.25, 42, values) == jtb._encode_event(123.25, 42, values)
    header = ttb._encode_event(1.0, 0, file_version="brain.Event:2")
    assert ttb._record(header) == jtb._record(header)


def test_event_file_roundtrip_and_framing(tmp_path):
    w = ttb.EventFileWriter(str(tmp_path))
    w.add_scalars({"loss": 1.5, "lr": 5e-6}, step=10, wall_time=123.0)
    w.add_scalars({"loss": 0.75}, step=20, wall_time=124.0)
    w.close()
    for read in (ttb.read_events, jtb.read_events):
        events = read(w.path)
        assert events[0][1] == 0 and events[0][2] == {}  # the brain.Event:2 header
        assert events[1][:2] == (123.0, 10) and events[1][2]["loss"] == 1.5
        assert events[1][2]["lr"] == pytest.approx(5e-6, rel=1e-6)
        assert events[2][1:] == (20, {"loss": 0.75})
    data = open(w.path, "rb").read()
    (length,) = struct.unpack_from("<Q", data, 0)
    assert struct.unpack_from("<I", data, 8)[0] == jtb._masked_crc(data[:8])
    corrupt = bytearray(data)
    corrupt[-5] ^= 0xFF
    open(w.path, "wb").write(bytes(corrupt))
    with pytest.raises(ValueError):
        ttb.read_events(w.path)


def _records(path):
    return [(tag, step, value) for _, step, vals in jtb.read_events(path)
            for tag, value in vals.items()]


def test_export_run_equals_jax_s(tmp_path):
    """The same run directory exported by both packages: one event file per
    role, and the same (tag, step, value) records and wall times."""
    run_dir = tmp_path / "run"
    rng = np.random.default_rng(0)
    for role in ("local", "other"):
        mw = MetricsWriter(str(run_dir), role=role)
        for step in range(1, 6):
            mw.scalars({"loss": float(rng.normal()), "learning_rate": 5e-6}, step)
        mw.scalars({"50m-auc@Top1": 0.9, "%<25m@Top1": 75.0}, 100)
    ours = ttb.export_run(str(run_dir), str(tmp_path / "port"))
    theirs = jtb.export_run(str(run_dir), str(tmp_path / "jax"))
    assert ours == theirs == {"local": 12, "other": 12}
    for role in ("local", "other"):
        files = {pkg: [f for f in os.listdir(tmp_path / pkg / role)
                       if f.startswith("events.out.tfevents.")] for pkg in ("port", "jax")}
        assert len(files["port"]) == len(files["jax"]) == 1
        got = jtb.read_events(str(tmp_path / "port" / role / files["port"][0]))
        want = jtb.read_events(str(tmp_path / "jax" / role / files["jax"][0]))
        assert got[1:] == want[1:]  # the header's wall time is the export's own
        assert _records(str(tmp_path / "port" / role / files["port"][0])) == _records(
            str(tmp_path / "jax" / role / files["jax"][0]))
    # exporting again replaces the file: no point twice
    assert ttb.export_run(str(run_dir), str(tmp_path / "port")) == ours
    assert len(os.listdir(tmp_path / "port" / "local")) == 1


def test_cli_metrics_tb_export(tmp_path, capsys):
    from soft_contrastive_learning_torch.cli import main

    MetricsWriter(str(tmp_path), "local").scalars({"loss": 0.5}, 1)
    assert main(["metrics", "--run_dir", str(tmp_path), "--tb-export"]) == 0
    out = capsys.readouterr().out
    assert f"[tb] wrote 1 scalars -> {tmp_path}/tb/local" in out
    (name,) = os.listdir(tmp_path / "tb" / "local")
    assert _records(str(tmp_path / "tb" / "local" / name)) == [("loss", 1, 0.5)]
