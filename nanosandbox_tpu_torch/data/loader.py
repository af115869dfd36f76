"""Memmapped batch loader with one-batch-ahead prefetch.

This package's own copy of nanosandbox_tpu/data/loader.py: nanoGPT's
get_batch contract (random-offset windows from train.bin / val.bin
uint16 memmaps, prepared with ``meta.pkl`` by either package's
data.prepare), with offsets drawn from a stream keyed by
(seed, split, step, process_index), so a resumed run draws the batches
an uninterrupted one would.

Every rank of a multi-process run draws the step's global batch, as one
process does (process_index 0), and keeps its share; no data is
exchanged. Under sequence parallelism that is its columns of x and y
(``columns``: the ring layout's positions, ops/ring_attention.py
ring_positions); over the data and fsdp axes it is its rows (``rows``:
(i, n), where i is the rank's index over (data, fsdp) and n their count):
of each of the step's ``micro_batches`` micro-batches, the i-th of n
equal row blocks. So N ranks train on one process's batches at any
accumulation. The JAX loader instead draws a stream a process
(``process_index``); ROADMAP C5 records the difference.

Offsets come from the native xorshift128+ sampler keyed by (seed,
stream), and the windows from the native gather (utils/native.py over
csrc/batchgen.cpp): the JAX loader's native path, bit for bit. The
metrics header records ``"offset_sampler": "native-xorshift128+"``. A
missing or failed g++ build raises; there is no other sampler.
"""

from __future__ import annotations

import os
import pickle
import queue
import threading

import numpy as np

from nanosandbox_tpu_torch.utils import native
from nanosandbox_tpu_torch.utils.native import OFFSET_SAMPLER  # noqa: F401


def take_rows(a: np.ndarray, micro_batches: int, index: int,
              count: int) -> np.ndarray:
    """Of each of the ``micro_batches`` equal micro-batches a holds (rows
    in order), the index-th of ``count`` equal row blocks, in order."""
    m = a.reshape(micro_batches, count, -1, *a.shape[1:])[:, index]
    return m.reshape(-1, *a.shape[1:])


class BinDataset:
    """A prepared dataset directory: {train,val}.bin (+ meta.pkl)."""

    def __init__(self, data_dir: str, dataset: str):
        self.dir = os.path.join(data_dir, dataset)
        self.splits: dict[str, np.ndarray] = {}
        for split in ("train", "val"):
            path = os.path.join(self.dir, f"{split}.bin")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{path} not found — run `python -m "
                    f"nanosandbox_tpu_torch.data.prepare {dataset} "
                    f"--data_dir={data_dir}` first")
            self.splits[split] = np.memmap(path, dtype=np.uint16, mode="r")
        meta_path = os.path.join(self.dir, "meta.pkl")
        self.meta: dict = {}
        if os.path.exists(meta_path):
            with open(meta_path, "rb") as f:
                self.meta = pickle.load(f)

    @property
    def vocab_size(self) -> int:
        # nanoGPT default: GPT-2 vocab padded to a multiple of 64.
        return int(self.meta.get("vocab_size", 50304))

    def sample_batch(self, split: str, step: int, batch_size: int,
                     block_size: int, *, seed: int = 1337,
                     process_index: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """(x, y) int32 arrays of shape (batch_size, block_size)."""
        data = self.splits[split]
        width = block_size + 1
        split_tag = 0 if split == "train" else 1
        stream = (np.uint64(step) * np.uint64(0x10001)
                  + np.uint64(process_index) * np.uint64(2)
                  + np.uint64(split_tag))
        offsets = native.sample_offsets(seed, int(stream), data.shape[0],
                                        width, batch_size)
        xy = native.gather_windows(data, offsets, width).astype(np.int32)
        return xy[:, :-1], xy[:, 1:]


class BatchLoader:
    """Iterator over batches with one-batch-ahead prefetch."""

    # Queue sentinel: the worker died on the exception in _worker_exc.
    # An object(), not None, so a batch can never be mistaken for it.
    _FAILED = object()

    def __init__(self, dataset: BinDataset, split: str, batch_size: int,
                 block_size: int, *, seed: int = 1337, start_step: int = 0,
                 prefetch: bool = True, columns: np.ndarray | None = None,
                 rows: tuple[int, int] | None = None,
                 micro_batches: int = 1):
        self.dataset = dataset
        self.split = split
        self.batch_size = batch_size
        self.block_size = block_size
        self.seed = seed
        self.columns = columns
        self.rows = rows
        self.micro_batches = micro_batches
        self.step = start_step
        self._queue: queue.Queue | None = None
        self._worker_exc: BaseException | None = None
        if prefetch:
            self._queue = queue.Queue(maxsize=2)
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _load(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        x, y = self.dataset.sample_batch(self.split, step, self.batch_size,
                                         self.block_size, seed=self.seed)
        if self.rows is not None:
            x, y = (take_rows(a, self.micro_batches, *self.rows)
                    for a in (x, y))
        if self.columns is None:
            return x, y
        return x[:, self.columns], y[:, self.columns]

    def _put(self, item) -> None:
        """Blocking put that still honours close(): a consumer that went
        away must not wedge the worker on the bounded queue."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _worker(self) -> None:
        step = self.step
        try:
            while not self._stop.is_set():
                batch = self._load(step)
                self._put((step, batch))
                step += 1
        except Exception as e:
            # Park the exception and push the sentinel, so the consumer
            # raises at its next (and every later) __next__ instead of
            # blocking on an empty queue.
            self._worker_exc = e
            self._put(self._FAILED)

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        if self._queue is not None:
            item = self._queue.get()
            if item is self._FAILED:
                self._queue.put(item)  # the worker is dead: raise again
                raise RuntimeError(
                    f"BatchLoader prefetch worker failed on split "
                    f"{self.split!r}: {self._worker_exc!r}"
                ) from self._worker_exc
            step, batch = item
            self.step = step + 1
            return batch
        batch = self._load(self.step)
        self.step += 1
        return batch

    def close(self) -> None:
        if self._queue is not None:
            self._stop.set()
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2)
