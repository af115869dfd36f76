"""Admission control for the continuous-batching engine (host-side).

This package's own copy of nanosandbox_tpu/serve/scheduler.py: one FIFO
queue per priority class, the free-slot pool, the migration limbo of the
disaggregated prefill/decode handoff, and the two ladders that turn an
arbitrary request stream into few shapes --

  * prefill pads each (suffix) prompt up to a bucket of a power-of-two
    ladder, so one wave is one (rung, bucket) block;
  * a wave of k requests pads up the admit ladder 1, 2, 4, ..., slots.

PyTorch compiles nothing per shape, but the ladders keep the waves the
same shapes as the JAX engine's, and with them the batching behaviour.

Step boundaries are chunk boundaries: every wave is popped and committed
between two decode dispatches, so queue-wait accounting is in dispatch
units (a "step" of waiting spans up to scan_k tokens).
"""

from __future__ import annotations

from bisect import insort
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


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
    """Priority queue + free-slot pool + bucket ladder. Owns no device
    state: the engine asks which requests go into which slots
    (``next_admission_wave``) and reports freed slots (``release``).

    Ordering is priority, then FIFO: items with a higher ``.priority``
    sit ahead of lower ones, and within a class admission is strictly
    FIFO (a long prompt at the head of its class is never jumped by a
    later short one). Items without ``.priority`` share one class, a
    plain FIFO. Lower classes may starve under sustained higher-priority
    load; the engine's brownout ladder sheds them explicitly."""

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
        # One FIFO deque per priority class (enqueue and requeue_front
        # are O(1) at any depth); ``_negprios`` holds the negated
        # priorities of the non-empty classes in ascending order, i.e.
        # the priorities descending.
        self._queues: Dict[int, Deque] = {}
        self._negprios: List[int] = []
        # The queue depth as a plain int: HTTP handler threads read it
        # while the engine thread mutates the classes.
        self._n = 0
        # Migration limbo: exports whose prefill completed here and whose
        # block chain no decode tier has adopted yet. They hold no slot
        # (the row was released at export) but hold blocks and an
        # unserved deadline, so the deadline sweep sees them
        # (drain_expired) and /debug/scheduler shows them. FIFO: the
        # handoffs go in export order.
        self._limbo: Deque = deque()

    # -- queue side --
    @staticmethod
    def _prio(item) -> int:
        return getattr(item, "priority", 0)

    def _class(self, p: int) -> Deque:
        """The class deque for priority ``p``, created on first use."""
        q = self._queues.get(p)
        if q is None:
            q = self._queues[p] = deque()
            insort(self._negprios, -p)
        return q

    def _drop_if_empty(self, p: int) -> None:
        if not self._queues[p]:
            del self._queues[p]
            self._negprios.remove(-p)

    def enqueue(self, item) -> None:
        """Append at the tail of the item's priority class."""
        self._class(self._prio(item)).append(item)
        self._n += 1

    def peek_head(self):
        """The next item admission would consider (None when empty): the
        head of the highest non-empty class."""
        if not self._negprios:
            return None
        return self._queues[-self._negprios[0]][0]

    def pop_head(self):
        """Pop the queue head: the chunked-prefill lane claims it outside
        the wave machinery (its prefill spans several engine steps)."""
        p = -self._negprios[0]
        item = self._queues[p].popleft()
        self._n -= 1
        self._drop_if_empty(p)
        return item

    def take_slot(self) -> int:
        """Claim one free slot (the chunked lane's twin of the slot pop
        in next_admission_wave). The caller checks ``free_slots``."""
        return self._free.pop()

    @property
    def queued(self) -> int:
        return self._n

    @property
    def free_slots(self) -> int:
        return len(self._free)

    # -- migration limbo --
    @property
    def limbo(self) -> int:
        return len(self._limbo)

    def park_limbo(self, item) -> None:
        """Park an export awaiting adoption, at the tail."""
        self._limbo.append(item)

    def park_limbo_front(self, item) -> None:
        """Park again at the head (the adopting tier had no slot or
        blocks this pump): the oldest export stays first in line, so a
        stalled decode tier cannot invert the handoff order and starve
        the head into a deadline shed."""
        self._limbo.appendleft(item)

    def pop_limbo(self):
        """The oldest parked export, claimed for transfer (None when
        empty)."""
        return self._limbo.popleft() if self._limbo else None

    def limbo_items(self) -> List:
        """A copy of the limbo, oldest first (safe from handler
        threads)."""
        return list(self._limbo)

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

    def next_admission_wave(self, max_items: Optional[int] = None, *,
                            bucket_of=None, admit=None,
                            ) -> Optional[Tuple[List, List[int], int]]:
        """(items, slots, bucket): the maximal prefix of the queue, in
        priority order, whose prompts share the head's bucket, capped at
        the free slots (and at ``max_items``). A request with a different
        bucket ends the wave rather than being jumped.

        ``bucket_of(item)`` overrides the bucket key (the paged engine
        buckets the prefix-hit-adjusted suffix); ``admit(item) -> bool``
        commits the item's KV blocks, and False fences the wave with the
        item still queued (pool exhaustion is a wait, not a deadlock)."""
        if not self._negprios or not self._free:
            return None
        key = bucket_of if bucket_of is not None else (
            lambda item: self.bucket_for(len(item.prompt)))
        bucket = key(self.peek_head())
        items: List = []
        slots: List[int] = []
        while (self._negprios and self._free
               and (max_items is None or len(items) < max_items)):
            head = self.peek_head()
            if key(head) != bucket:
                break
            if admit is not None and not admit(head):
                break
            items.append(self.pop_head())
            slots.append(self._free.pop())
        if not items:
            return None
        return items, slots, bucket

    def drain_expired(self, expired) -> List:
        """Remove and return every queued or limbo-parked item for which
        ``expired(item)`` is true, the survivors keeping their order:
        the engine's deadline and brownout shed. Limbo is swept with the
        same predicate (a parked export holds blocks and an unserved
        deadline like a queued request); the caller tells the two kinds
        apart by type. Cheap when nothing expired (attribute checks
        only; a class is rebuilt only on a hit)."""
        shed: List = []
        if any(expired(item)
               for q in self._queues.values() for item in q):
            for np_ in list(self._negprios):
                p = -np_
                kept: Deque = deque()
                for item in self._queues[p]:
                    (shed if expired(item) else kept).append(item)
                self._queues[p] = kept
                self._drop_if_empty(p)
            self._n -= len(shed)
        if self._limbo and any(expired(item) for item in self._limbo):
            kept_l: Deque = deque()
            for item in self._limbo:
                (shed if expired(item) else kept_l).append(item)
            self._limbo = kept_l
        return shed

    def requeue_front(self, items: List) -> None:
        """Push items back at the head of their priority class, in the
        given order among themselves (the preemption path): a victim
        does not queue behind same-class traffic that came after it, and
        does not jump a higher class, so ``peek_head`` stays the most
        urgent item."""
        for item in reversed(list(items)):
            self._class(self._prio(item)).appendleft(item)
            self._n += 1

    def queue_mass(self, priority: int) -> Tuple[int, int]:
        """(at_or_above, strictly_above): the queued counts a request of
        ``priority`` waits behind (the retry-after hint). Safe from HTTP
        handler threads: per-class len() on a copy of the class list."""
        ahead = jumps = 0
        for np_ in list(self._negprios):
            q = self._queues.get(-np_)
            if q is None:
                continue
            n = len(q)
            if -np_ >= priority:
                ahead += n
            if -np_ > priority:
                jumps += n
        return ahead, jumps

    def queued_items(self) -> List:
        """A copy of the queue, head first (callers must not mutate the
        items); each class deque is copied whole, never iterated live."""
        out: List = []
        for np_ in list(self._negprios):
            q = self._queues.get(-np_)
            if q is not None:
                out.extend(list(q))
        return out

    def release(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"slot {slot} released twice")
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        self._free.append(slot)
