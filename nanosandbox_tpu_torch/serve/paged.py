"""Host-side block accounting for the paged KV pool: a free-list
allocator over fixed-size KV blocks plus a refcounted radix prefix cache.

This package's own copy of nanosandbox_tpu/serve/paged.py, cut to what
the serving engine runs: admission, release (with the preemption path's
donation of generated blocks), the O(1) evictable count the preemption
check probes, the cache and ledger resets that warmup needs, the debug
views, the trie's digest summary a fleet router refreshes from, and the
adoption of a migrated block chain (disaggregated prefill/decode).
Plain Python over block *ids*; the K/V bytes live in the device pool
(models/gpt.py init_paged_cache).

Allocation contract — full reservation at admission: a request is
admitted with every block it can ever touch, ceil((prompt_len +
max_new_tokens) / page) minus the blocks a prefix hit shares, so the
decode loop never allocates and pool exhaustion mid-decode cannot
happen. A request that cannot be covered right now waits in the queue.

Prefix sharing — block-aligned, copy-on-write by refcount: the radix
cache is a trie keyed on page-sized token blocks. Only FULL prompt
blocks are shared, so the block anything writes is always private. A hit
is capped one token short of the prompt, so the suffix prefill always
has a token to compute the first logit from. On release a request's
full prompt blocks are DONATED to the trie (refcount 0, evictable LRU);
a preempted request donates its generated blocks too, so its resume is a
prefix hit.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def blocks_for(n_positions: int, page: int) -> int:
    """ceil(n_positions / page): blocks covering n_positions tokens."""
    return -(-n_positions // page)


def _block_digest(prev: bytes, block: Sequence[int]) -> bytes:
    """Chained 64-bit fingerprint of one page of token ids given its
    parent chain's digest: the one hash prefix_digests() and
    RadixPrefixCache.digests() share, so a router matching a request's
    chain against a replica's summary cannot drift from the trie."""
    h = hashlib.blake2b(digest_size=8)
    h.update(prev)
    h.update(",".join(str(int(t)) for t in block).encode())
    return h.digest()


def prefix_digests(tokens: Sequence[int], page: int) -> List[str]:
    """Chained per-block fingerprints (hex) of a token sequence's FULL
    page-sized blocks: entry i fingerprints tokens[:(i+1)*page]. The same
    chain as the JAX package's, so both report identical digests."""
    out: List[str] = []
    prev = b""
    for i in range(len(tokens) // page):
        prev = _block_digest(prev, tokens[i * page:(i + 1) * page])
        out.append(prev.hex())
    return out


class _Node:
    """One cached block: a trie edge keyed by its page of token ids."""

    __slots__ = ("key", "block", "parent", "children", "refs", "last_use",
                 "locks")

    def __init__(self, key, block: int, parent):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[tuple, "_Node"] = {}
        self.refs = 0                   # in-flight requests sharing it
        self.last_use = 0
        self.locks = 0                  # refs > 0 nodes in this subtree
        #                                 (self included): evictable at 0


class RadixPrefixCache:
    """Refcounted radix/trie prefix cache over page-sized token blocks."""

    def __init__(self, page: int):
        if page < 1:
            raise ValueError(f"page must be >= 1, got {page}")
        self.page = page
        self.root = _Node(key=None, block=-1, parent=None)
        self._nodes: List[_Node] = []
        self._tick = 0
        self._evictable = 0             # nodes with locks == 0

    def __len__(self) -> int:
        return len(self._nodes)

    def _keys(self, prompt: Sequence[int], n_blocks: int) -> List[tuple]:
        p = self.page
        return [tuple(prompt[i * p:(i + 1) * p]) for i in range(n_blocks)]

    def match(self, prompt: Sequence[int]) -> List[_Node]:
        """The resident chain of FULL prompt blocks, capped one token
        short of the prompt. Touches the chain's LRU clocks."""
        usable = (len(prompt) - 1) // self.page
        path: List[_Node] = []
        node = self.root
        for key in self._keys(prompt, usable):
            child = node.children.get(key)
            if child is None:
                break
            path.append(child)
            node = child
        self._tick += 1
        for n in path:
            n.last_use = self._tick
        return path

    def _lock_chain(self, node: _Node, d: int) -> None:
        """Carry a refs 0 <-> 1 transition up the ancestor chain.
        ``locks`` counts the pinned (refs > 0) nodes of a subtree, so a
        node is evictable exactly while its locks are 0; kept here at
        O(depth) a transition so that ``evictable()`` is an O(1) read."""
        n = node
        while n is not None:
            n.locks += d
            if n.parent is not None:    # the root is not a pool block
                if d > 0 and n.locks == 1:
                    self._evictable -= 1
                elif d < 0 and n.locks == 0:
                    self._evictable += 1
            n = n.parent

    def acquire(self, node: _Node) -> None:
        node.refs += 1
        if node.refs == 1:
            self._lock_chain(node, +1)

    def release(self, node: _Node) -> None:
        if node.refs <= 0:
            raise RuntimeError("prefix-cache refcount underflow")
        node.refs -= 1
        if node.refs == 0:
            self._lock_chain(node, -1)

    def insert_chain(self, prompt: Sequence[int], blocks: Sequence[int],
                     start: int) -> List[int]:
        """Donate ``blocks[start:full]`` (a finished request's private
        full-prompt blocks; blocks[:start] are its hit chain, already in
        the trie). Returns the block ids NOT absorbed — duplicates of a
        chain another request donated first — for the caller to free."""
        full = len(prompt) // self.page
        keys = self._keys(prompt, full)
        node = self.root
        for key in keys[:start]:
            node = node.children[key]
        dup: List[int] = []
        self._tick += 1
        for i in range(start, full):
            child = node.children.get(keys[i])
            if child is None:
                child = _Node(keys[i], blocks[i], node)
                node.children[keys[i]] = child
                self._nodes.append(child)
                self._evictable += 1    # refs 0, no children: locks 0
            else:
                dup.append(blocks[i])
            child.last_use = self._tick
            node = child
        return dup

    def evictable(self) -> int:
        """Blocks reclaimable now by repeated leaf eviction: nodes with
        no pinned node in their subtree (a refs-0 parent of a pinned
        child stays: the child's prefix walk crosses it). An O(1) read
        for the engine's per-step preemption probe, audited against the
        O(n) walk in BlockPool.check."""
        return self._evictable

    def evict(self, want: int) -> List[int]:
        """Free up to ``want`` blocks, LRU refcount-zero leaves first (a
        parent becomes a leaf once its children are gone)."""
        freed: List[int] = []
        while len(freed) < want:
            victim = None
            for n in self._nodes:
                if n.refs == 0 and not n.children and (
                        victim is None or n.last_use < victim.last_use):
                    victim = n
            if victim is None:
                break
            del victim.parent.children[victim.key]
            self._nodes.remove(victim)
            self._evictable -= 1        # victims have locks 0 by choice
            freed.append(victim.block)
        return freed

    def cached_blocks(self) -> List[int]:
        return [n.block for n in self._nodes]

    def digests(self) -> List[str]:
        """Chained fingerprints of every resident chain prefix, one a
        trie node, by prefix_digests()'s chain: membership in this set
        answers "would block i of this prompt hit here". The summary a
        fleet router's per-replica index is replaced by
        (GET /debug/prefix_summary); what the LRU evicted since the last
        refresh drops out with it."""
        out: List[str] = []
        stack = [(child, b"") for child in self.root.children.values()]
        while stack:
            node, prev = stack.pop()
            d = _block_digest(prev, node.key)
            out.append(d.hex())
            for c in node.children.values():
                stack.append((c, d))
        return out


@dataclass
class Allocation:
    """One admitted request's blocks: the table row the device side
    writes, and the bookkeeping release() unwinds."""
    prompt: tuple
    table: List[int]                 # hit chain + private blocks, in order
    n_hit: int                       # leading shared (trie) blocks
    nodes: List[_Node] = field(default_factory=list)


class BlockPool:
    """Free-list allocator + radix prefix cache over ``num_blocks`` KV
    blocks of ``page`` positions each."""

    def __init__(self, num_blocks: int, page: int, *,
                 prefix_cache: bool = True):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self.page = page
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.cache = RadixPrefixCache(page) if prefix_cache else None
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.hit_requests = 0
        self.stall_steps = 0
        self.evicted_blocks = 0
        self.adoptions = 0              # migrated chains admitted here
        self.adopted_blocks = 0         # blocks filled by a KV transfer

    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        return blocks_for(prompt_len + max_new, self.page)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def _match(self, prompt: Sequence[int]) -> List[_Node]:
        return self.cache.match(tuple(prompt)) if self.cache else []

    def match_len(self, prompt: Sequence[int]) -> int:
        """Tokens a hit would skip (the engine buckets the SUFFIX with
        this before committing blocks)."""
        return len(self._match(prompt)) * self.page

    def _take(self, want: int) -> Optional[List[int]]:
        """Pop ``want`` free blocks, evicting LRU cached blocks to cover a
        shortfall; None (nothing consumed) when even that cannot."""
        short = want - len(self._free)
        if short > 0 and self.cache is not None:
            freed = self.cache.evict(short)
            self.evicted_blocks += len(freed)
            self._free.extend(freed)
        if want > len(self._free):
            return None
        return [self._free.pop() for _ in range(want)]

    def admit(self, prompt: Sequence[int],
              max_new: int) -> Optional[Allocation]:
        """Acquire the prompt's hit chain and allocate private blocks for
        the rest (suffix + the whole generation budget); None when the
        pool cannot cover it. The chain is pinned BEFORE the private
        allocation, so the shortfall eviction can never hand a just-
        matched block out a second time as a fresh private block."""
        nodes = self._match(prompt)
        n_hit = len(nodes)
        total = self.blocks_needed(len(prompt), max_new)
        for n in nodes:
            self.cache.acquire(n)
        fresh = self._take(total - n_hit)
        if fresh is None:
            for n in nodes:
                self.cache.release(n)
            self.stall_steps += 1
            return None
        hit = n_hit * self.page
        self.hit_tokens += hit
        self.miss_tokens += len(prompt) - hit
        self.hit_requests += bool(n_hit)
        return Allocation(prompt=tuple(prompt),
                          table=[n.block for n in nodes] + fresh,
                          n_hit=n_hit, nodes=nodes)

    def adopt_chain(self, prompt: Sequence[int], max_new: int
                    ) -> Optional[Tuple[Allocation, List[int]]]:
        """Admit a migrated request's chain: the receiving half of the
        disaggregated handoff. The footprint is a local admission's
        (prompt chain + the whole generation budget); ``copy`` lists the
        chain positions (indices into ``alloc.table``) of the prompt's
        blocks this pool does not already hold as a radix hit, which the
        caller fills with the source's blocks at the same positions
        before the request decodes. Hit blocks are the source's bits by
        the chained-digest argument (same tokens at the same positions),
        so a local hit shrinks the copy as it shrinks a prefill. The
        partial tail block is copied (the source's prefill wrote its
        positions below len(prompt)); generation blocks never are.
        None when the pool cannot cover the footprint (adoption
        backpressure, counted as a stall); check() holds after an
        adoption as after admit()."""
        a = self.admit(prompt, max_new)
        if a is None:
            return None
        copy = list(range(a.n_hit, blocks_for(len(prompt), self.page)))
        self.adoptions += 1
        self.adopted_blocks += len(copy)
        return a, copy

    def release(self, alloc: Allocation, *,
                generated: Sequence[int] = (),
                donate: bool = True) -> int:
        """Unwind one request: deref its hit chain, donate its full
        prompt blocks to the trie, free the rest. Returns the number of
        blocks newly donated.

        ``generated`` (the preemption path) extends the donation to the
        full prompt + generated blocks, so the victim's resume, prompt'
        = prompt + tokens so far, is a prefix hit over its own K/V. The
        last generated token's position is left out: that token was only
        sampled, never fed back, so its K/V was never written.
        ``donate=False`` frees everything (a failed row's K/V must never
        serve a hit)."""
        for n in alloc.nodes:
            self.cache.release(n)
        if self.cache is None or not donate:
            self._free.extend(alloc.table[alloc.n_hit:])
            return 0
        tokens = tuple(alloc.prompt) + tuple(generated)
        written = len(tokens) - (1 if generated else 0)
        full = written // self.page
        dup = self.cache.insert_chain(tokens[:full * self.page],
                                      alloc.table, alloc.n_hit)
        self._free.extend(dup)
        self._free.extend(alloc.table[full:])
        return full - alloc.n_hit - len(dup)

    def reset_cache(self) -> None:
        """Evict every cached block back to the free list and zero the
        hit/miss ledger. Callers must ensure no live allocation holds
        cache references (the engine checks it is idle first): with every
        refcount zero, repeated leaf eviction drains the whole trie."""
        if self.cache is None:
            return
        self._free.extend(self.cache.evict(self.num_blocks))
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.hit_requests = 0

    def reset_ledger(self) -> None:
        """Zero the telemetry counters (hit/miss tokens and requests,
        stalls, evictions) without touching allocation state, so that
        hit rates describe the traffic after a warmup (the engine's
        reset_latency_stats)."""
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.hit_requests = 0
        self.stall_steps = 0
        self.evicted_blocks = 0
        self.adoptions = 0
        self.adopted_blocks = 0

    def stats(self) -> dict:
        """Counts and the hit ledger. ``free``, ``cached`` (trie blocks
        no request holds: reclaimable) and ``live`` (every block a
        request holds) partition the pool: the serve_kv_pool_blocks
        gauge's states."""
        cached = len(self.cache) if self.cache is not None else 0
        evictable = self.cache.evictable() if self.cache is not None else 0
        free = len(self._free)
        seen = self.hit_tokens + self.miss_tokens
        return {
            "num_blocks": self.num_blocks,
            "page": self.page,
            "free": free,
            "cached": evictable,
            "live": self.num_blocks - free - evictable,
            "trie_blocks": cached,
            "prefix_hit_requests": self.hit_requests,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_miss_tokens": self.miss_tokens,
            "prefix_hit_rate": (self.hit_tokens / seen) if seen else None,
            "block_stall_steps": self.stall_steps,
            "evicted_blocks": self.evicted_blocks,
            "adoptions": self.adoptions,
            "adopted_blocks": self.adopted_blocks,
        }

    def debug(self, live: Sequence[tuple] = ()) -> dict:
        """The GET /debug/kvpool view: the block-state partition,
        fragmentation, trie occupancy and each live request's blocks.

        ``live`` is the engine's [(rid, used_positions, Allocation)]: the
        pool tracks block ids, and only the engine knows how many
        positions each reservation has written, which is what internal
        fragmentation is (a full reservation at admission holds
        positions its generation has not reached yet)."""
        out = self.stats()
        reserved_pos = used_pos = 0
        per_request = []
        for rid, used, alloc in live:
            reserved = len(alloc.table) * self.page
            reserved_pos += reserved
            used_pos += min(used, reserved)
            per_request.append({
                "rid": rid, "blocks": len(alloc.table),
                "hit_blocks": alloc.n_hit,
                "reserved_positions": reserved,
                "used_positions": min(used, reserved),
            })
        out["fragmentation"] = {
            "internal": (1.0 - used_pos / reserved_pos
                         if reserved_pos else 0.0),
            "reserved_positions": reserved_pos,
            "used_positions": used_pos,
            # A paged pool never fragments externally: any free block
            # serves any request.
            "free_frac": len(self._free) / self.num_blocks,
        }
        trie: dict = {"enabled": self.cache is not None}
        if self.cache is not None:
            depths: Dict[int, int] = {}
            # A list() snapshot: HTTP handler threads read this while the
            # loop thread inserts and evicts; an evicted node keeps its
            # parent pointers, so the depth walk stays safe.
            for n in list(self.cache._nodes):
                d = 0
                p = n.parent
                while p is not None:
                    d += 1
                    p = p.parent
                depths[d] = depths.get(d, 0) + 1
            trie.update({
                "nodes": len(self.cache),
                "cached_tokens": len(self.cache) * self.page,
                "evictable_blocks": self.cache.evictable(),
                "depth_histogram": {str(k): v
                                    for k, v in sorted(depths.items())},
                "max_depth": max(depths) if depths else 0,
            })
        out["trie"] = trie
        out["live_requests"] = per_request
        return out

    def check(self, live_allocs: Sequence[Allocation] = ()) -> None:
        """Invariant audit: the free list, the trie and the live
        allocations' private blocks partition [0, num_blocks), each
        node's refcount equals the live allocations holding it, and the
        O(1) evictable counter equals its O(n) recount. An adopted chain
        is a live allocation like any other."""
        free = list(self._free)
        cached = self.cache.cached_blocks() if self.cache else []
        owned: List[int] = []
        refs: Dict[int, int] = {}
        for a in live_allocs:
            owned.extend(a.table[a.n_hit:])
            for n in a.nodes:
                refs[id(n)] = refs.get(id(n), 0) + 1
        every = free + cached + owned
        if len(every) != len(set(every)) or set(every) != set(
                range(self.num_blocks)):
            raise AssertionError(
                f"pool partition broken: free={sorted(free)} "
                f"cached={sorted(cached)} owned={sorted(owned)}")
        if self.cache is None:
            return
        for n in self.cache._nodes:
            if n.refs != refs.get(id(n), 0):
                raise AssertionError(("refcount drift", n.key, n.refs,
                                      refs.get(id(n), 0)))
        # The O(1) evictable counter against the O(n) pinned-set walk.
        pinned: set = set()
        for n in self.cache._nodes:
            if n.refs > 0:
                while n is not None and id(n) not in pinned:
                    pinned.add(id(n))
                    n = n.parent
        slow = sum(1 for n in self.cache._nodes if id(n) not in pinned)
        if self.cache._evictable != slow:
            raise AssertionError(("evictable-counter drift",
                                  self.cache._evictable, slow))
