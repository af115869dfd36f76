"""Admission control for the continuous-batching engine (host-side).

This package's own copy of nanosandbox_tpu/serve/scheduler.py, cut to
what the serving slice runs: a FIFO queue, the free-slot pool, and the
two ladders that turn an arbitrary request stream into few shapes —

  * prefill pads each (suffix) prompt up to a bucket of a power-of-two
    ladder, so one wave is one (rung, bucket) block;
  * a wave of k requests pads up the admit ladder 1, 2, 4, ..., slots.

PyTorch compiles nothing per shape, but the ladders keep the waves the
same shapes as the JAX engine's, and with them the batching behaviour.
Priority classes, migration limbo and the deadline sweep are later
slices' work.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Tuple


def admit_ladder(num_slots: int) -> List[int]:
    """Power-of-two admission-wave sizes: 1, 2, 4, ..., num_slots."""
    if num_slots < 1:
        raise ValueError(f"num_slots must be >= 1, got {num_slots}")
    ladder: List[int] = []
    k = 1
    while k < num_slots:
        ladder.append(k)
        k *= 2
    ladder.append(num_slots)
    return ladder


def default_buckets(max_len: int, min_bucket: int = 16) -> List[int]:
    """Power-of-two prefill ladder capped at max_len: 16, 32, ... max_len."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    buckets: List[int] = []
    b = min(min_bucket, max_len)
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return buckets


class SlotScheduler:
    """FIFO queue + free-slot pool + bucket ladder. Owns no device state:
    the engine asks which requests go into which slots
    (``next_admission_wave``) and reports freed slots (``release``)."""

    def __init__(self, num_slots: int, buckets: List[int]):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if not buckets or sorted(buckets) != list(buckets):
            raise ValueError(f"buckets must be a sorted non-empty list, "
                             f"got {buckets!r}")
        self.num_slots = num_slots
        self.buckets = list(buckets)
        self.admit_buckets = admit_ladder(num_slots)
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self._queue: Deque = deque()

    def enqueue(self, item) -> None:
        self._queue.append(item)

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest prefill-length rung >= prompt_len."""
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest prefill "
            f"bucket {self.buckets[-1]}")

    def rung_for(self, wave_size: int) -> int:
        """Smallest admission-wave rung >= wave_size."""
        for k in self.admit_buckets:
            if wave_size <= k:
                return k
        raise ValueError(
            f"wave size {wave_size} exceeds num_slots {self.num_slots}")

    def next_admission_wave(self, *, bucket_of=None, admit=None,
                            ) -> Optional[Tuple[List, List[int], int]]:
        """(items, slots, bucket): the maximal FIFO *prefix* of the queue
        whose prompts share the head's bucket, capped at the free slots.
        A request with a different bucket ends the wave rather than being
        jumped, so admission stays FIFO.

        ``bucket_of(item)`` overrides the bucket key (the paged engine
        buckets the prefix-hit-adjusted suffix); ``admit(item) -> bool``
        commits the item's KV blocks, and False fences the wave with the
        item still queued (pool exhaustion is a wait, not a deadlock)."""
        if not self._queue or not self._free:
            return None
        key = bucket_of if bucket_of is not None else (
            lambda item: self.bucket_for(len(item.prompt)))
        bucket = key(self._queue[0])
        items: List = []
        slots: List[int] = []
        while self._queue and self._free:
            head = self._queue[0]
            if key(head) != bucket:
                break
            if admit is not None and not admit(head):
                break
            items.append(self._queue.popleft())
            slots.append(self._free.pop())
        if not items:
            return None
        return items, slots, bucket

    def release(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"slot {slot} released twice")
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        self._free.append(slot)
