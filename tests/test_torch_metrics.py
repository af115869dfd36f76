"""The port's TensorBoard event files against the JAX package's.

The port writes event files with its own small writer
(nanosandbox_tpu_torch/utils/events.py); the JAX package's MetricsWriter
writes them through tensorboardX. Both are read back with TensorBoard's
own EventFileLoader and must hold the same (tag, step, value) triples.
"""

import glob
import os

import pytest

from nanosandbox_tpu.utils.metrics import MetricsWriter as JaxMetricsWriter
from nanosandbox_tpu_torch.utils import events
from nanosandbox_tpu_torch.utils.metrics import MetricsWriter

# Scalars of a few training steps: floats, ints, a bool, and values
# float() refuses (skipped in the event file, kept in the JSONL).
STEPS = [
    (0, {"loss": 10.98, "lr": 0.0, "tok_s": 1234, "note": "warmup"}),
    (5, {"loss": 7.25, "lr": 3e-4, "mfu": 0.1046, "resumed": True,
         "skip": None}),
    (10, {"loss": 4.5, "val_loss": 4.75, "grad_norm": 1.5e-3}),
]


def _triples(run_dir):
    from tensorboard.backend.event_processing import event_file_loader
    from tensorboard.util.tensor_util import make_ndarray

    paths = glob.glob(os.path.join(run_dir, "events.out.tfevents.*"))
    assert len(paths) == 1, paths
    out, versions = [], []
    for ev in event_file_loader.EventFileLoader(paths[0]).Load():
        if ev.file_version:
            versions.append(ev.file_version)
        for value in ev.summary.value:
            # The loader migrates simple_value into a scalar tensor.
            assert value.metadata.plugin_data.plugin_name == "scalars"
            out.append((value.tag, ev.step,
                        float(make_ndarray(value.tensor))))
    return sorted(out), versions


def test_event_files_match_jax_writer(tmp_path, monkeypatch):
    pytest.importorskip("tensorboard")
    pytest.importorskip("tensorboardX")
    # TensorBoard's own record reader (it checks both CRCs of every
    # record) rather than TensorFlow's, which takes seconds to import.
    from tensorboard.backend.event_processing import event_file_loader
    from tensorboard.compat import tensorflow_stub

    monkeypatch.setattr(event_file_loader, "tf", tensorflow_stub)
    dirs = {}
    for name, cls in (("torch", MetricsWriter), ("jax", JaxMetricsWriter)):
        w = cls(str(tmp_path / name), run_name="r", tensorboard=True)
        w.write_header({"policy": "fixed"})
        for step, scalars in STEPS:
            w.log(step, scalars)
        w.close()
        dirs[name] = str(tmp_path / name / "r")
    got, versions = _triples(dirs["torch"])
    want, _ = _triples(dirs["jax"])
    assert got == want
    assert versions == ["brain.Event:2"]
    assert ("loss", 5, 7.25) in got and not any(t in ("note", "skip")
                                                for t, _, _ in got)
    # The JSONL beside it keeps every scalar.
    assert os.path.exists(os.path.join(dirs["torch"], "metrics.jsonl"))


def test_event_writer_crc_and_quiet_paths(tmp_path):
    # CRC32C (Castagnoli) check value, and TFRecord framing.
    assert events.crc32c(b"123456789") == 0xE3069283
    rec = events.tfrecord(b"abc")
    assert len(rec) == 8 + 4 + 3 + 4 and rec[12:15] == b"abc"
    # tensorboard=False writes no event file; a run that logs nothing
    # leaves no file at all.
    w = MetricsWriter(str(tmp_path), run_name="off", tensorboard=False)
    w.log(1, {"loss": 1.0})
    w.close()
    assert os.listdir(tmp_path / "off") == ["metrics.jsonl"]
    w = MetricsWriter(str(tmp_path), run_name="empty", tensorboard=True)
    w.close()
    assert os.listdir(tmp_path / "empty") == []
