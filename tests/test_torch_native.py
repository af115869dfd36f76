"""The port's native batch gather against the JAX package's, on the CPU.

* the xorshift128+ sampler draws JAX's native offsets, and the gather
  JAX's windows, bit for bit, over a few (seed, stream, n_tokens, width,
  batch), width == n_tokens among them; JAX's library must load, so the
  comparison is never Philox against Philox; the plain sampler
  (philox_offsets) draws the JAX loader's fallback offsets;
* BinDataset.sample_batch equals the JAX loader's over both splits and a
  process index;
* a missing g++ raises, in the loader too: there is no other sampler.
"""

import numpy as np
import pytest

from nanosandbox_tpu.data import loader as jloader
from nanosandbox_tpu.utils import native as jnative
from nanosandbox_tpu_torch.data import loader as tloader
from nanosandbox_tpu_torch.utils import native

CASES = [(0, 0, 1000, 65, 8), (1337, 7, 4096, 257, 16),
         (5, 2**64 - 1, 129, 129, 4), (2**40 + 3, 0x10001, 10, 3, 32)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_sampler_and_gather_equal_jax(case, monkeypatch):
    assert jnative.get_lib() is not None
    seed, stream, n, width, batch = case
    got = native.sample_offsets(seed, stream, n, width, batch)
    ref = jnative.sample_offsets(seed, stream, n, width, batch)
    np.testing.assert_array_equal(got, ref)
    assert got.min() >= 0 and got.max() <= n - width
    data = np.random.default_rng(seed % 2**32).integers(
        0, 2**16, n).astype(np.uint16)
    np.testing.assert_array_equal(native.gather_windows(data, got, width),
                                  jnative.gather_windows(data, ref, width))
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    np.testing.assert_array_equal(native.philox_offsets(*case),
                                  jnative.sample_offsets(*case))


def test_sample_batch_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    for split, n in (("train", 5000), ("val", 700)):
        rng.integers(0, 300, n).astype(np.uint16).tofile(
            tmp_path / f"{split}.bin")
    jds = jloader.BinDataset(str(tmp_path.parent), tmp_path.name)
    tds = tloader.BinDataset(str(tmp_path.parent), tmp_path.name)
    for split, step, proc in (("train", 0, 0), ("train", 9, 1),
                              ("val", 1_000_002, 0)):
        for got, ref in zip(
                tds.sample_batch(split, step, 8, 64, seed=3,
                                 process_index=proc),
                jds.sample_batch(split, step, 8, 64, seed=3,
                                 process_index=proc)):
            np.testing.assert_array_equal(got, ref)


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g..? not found"):
        native.get_lib()
    (tmp_path / "d").mkdir()
    np.zeros(100, np.uint16).tofile(tmp_path / "d" / "train.bin")
    np.zeros(100, np.uint16).tofile(tmp_path / "d" / "val.bin")
    ds = tloader.BinDataset(str(tmp_path), "d")
    with pytest.raises(RuntimeError, match="not found"):
        ds.sample_batch("train", 0, 2, 8)
