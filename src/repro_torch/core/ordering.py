"""Prompt and Generation Task Ordering (§3.4).

Three factors, in order:
  1. JCT-SLO deadline  — ascending, bucketed into magnitude ranges;
  2. occupied KVC      — descending, bucketed (release KVC earlier, O5);
  3. predicted RL (GTs) / prompt length (PTs) — descending (fast near-exact
     fits when filling KVC / TFS via binary search).

Two ways to consume the ordering:
  * ``sort_queue``   — full re-sort (reference semantics, O(n log n) per
    iteration with a Python key function on every element);
  * ``OrderedQueue`` — a drop-in queue replacement (append / remove / len /
    iteration) that maintains the same ordering incrementally: keys are
    computed once on append, removal is O(1) via an rid index map, and
    only requests whose deadline bucket has actually rolled over are
    re-keyed (a time-ordered heap makes that O(log n) amortized).
    ``sorted_view(now)`` is guaranteed to return exactly what
    ``sort_queue(queue, now)`` would, including stable tie-breaking.

The priority index behind ``OrderedQueue`` is pluggable
(``index="skiplist"`` default, ``"list"`` legacy): the skip list makes
insert and remove O(log n), where the bisected list paid an O(n) memmove
per insort/removal (the last O(n) term in queue maintenance). Element
order is fully determined by (key, seq) either way — the skip list's
tower heights only affect constants — so batch decisions are bitwise
identical across indexes (tests/test_scheduler_determinism.py).
"""
from __future__ import annotations

import bisect
import heapq
import random
from typing import Dict, List, Optional, Sequence, Tuple

from .request import Request

DEADLINE_EDGES = (0.2, 0.5, 2.0)          # s, paper's example ranges
KVC_BUCKET = 128                          # tokens per occupied-KVC range
LEN_BUCKET = 128                          # tokens per RL/prompt-length range


def deadline_bucket(req: Request, now: float) -> int:
    slack = req.slo_deadline - now
    return bisect.bisect_left(DEADLINE_EDGES, slack)


def order_key(req: Request, now: float, is_gt: bool) -> Tuple[int, int, int]:
    length = req.remaining_predicted if is_gt else req.prompt_len
    return (deadline_bucket(req, now),
            -(req.occupied_kvc // KVC_BUCKET),
            -length)


def sort_queue(queue: List[Request], now: float, is_gt: bool) -> List[Request]:
    return sorted(queue, key=lambda r: order_key(r, now, is_gt))


def _next_bucket_change(req: Request, bucket: int) -> float:
    """Time at which the request's deadline bucket next decrements: the
    moment its slack drops to the edge below its current bucket."""
    if bucket <= 0:
        return float("inf")
    return req.slo_deadline - DEADLINE_EDGES[bucket - 1]


class _ListIndex:
    """Legacy priority index: a flat sorted list + bisect. Insert and
    remove pay an O(n) memmove; bulk insert merges two sorted runs."""

    def __init__(self):
        self._entries: List[list] = []    # sorted [key, seq, req]

    def insert(self, key, seq: int, req: Request) -> None:
        bisect.insort(self._entries, [key, seq, req])

    def remove(self, key, seq: int) -> None:
        # the stored key always matches the stored entry (written together
        # by the queue), so the bisect is exact
        i = bisect.bisect_left(self._entries, [key, seq])
        assert self._entries[i][1] == seq, (key, seq)
        del self._entries[i]

    def bulk_insert(self, entries: List[list]) -> None:
        """Merge a large batch with one sort + merge instead of per-
        element insort (Timsort gallops over the two sorted runs)."""
        entries.sort(key=lambda e: (e[0], e[1]))
        self._entries = list(heapq.merge(self._entries, entries,
                                         key=lambda e: (e[0], e[1])))

    @staticmethod
    def use_bulk(pending: int, indexed: int) -> bool:
        """Every per-item insort pays an O(n) memmove, so merging is the
        win for any non-trivial batch."""
        return pending > 64

    def reqs(self) -> List[Request]:
        return [e[2] for e in self._entries]


class _SkipListIndex:
    """Skip-list priority index: O(log n) insert/remove with no memmove.

    Nodes are ``[ckey, req, forwards]`` with ``ckey = (key, seq)``; the
    head is a sentinel. Tower heights come from a deterministic seeded
    generator, so a given operation sequence always builds the same
    structure — and element *order* is independent of heights anyway,
    which is what bitwise-identical scheduling decisions require.
    """

    MAX_LEVEL = 32

    def __init__(self):
        self._head = [None, None, [None]]
        self._level = 1                     # live levels in the head tower
        self._rng = random.Random(0x5EED)

    def _height(self) -> int:
        h = 1
        bits = self._rng.getrandbits(self.MAX_LEVEL)
        while bits & 1 and h < self.MAX_LEVEL:
            h += 1
            bits >>= 1
        return h

    def insert(self, key, seq: int, req: Request) -> None:
        ckey = (key, seq)
        update = [self._head] * max(self._level, 1)
        cur = self._head
        for lvl in range(self._level - 1, -1, -1):
            nxt = cur[2][lvl]
            while nxt is not None and nxt[0] < ckey:
                cur = nxt
                nxt = cur[2][lvl]
            update[lvl] = cur
        h = self._height()
        node = [ckey, req, [None] * h]
        if h > self._level:
            self._head[2].extend([None] * (h - self._level))
            update.extend([self._head] * (h - self._level))
            self._level = h
        for lvl in range(h):
            prev = update[lvl]
            node[2][lvl] = prev[2][lvl]
            prev[2][lvl] = node

    def remove(self, key, seq: int) -> None:
        ckey = (key, seq)
        cur = self._head
        found = None
        for lvl in range(self._level - 1, -1, -1):
            nxt = cur[2][lvl]
            while nxt is not None and nxt[0] < ckey:
                cur = nxt
                nxt = cur[2][lvl]
            if nxt is not None and nxt[0] == ckey:
                cur[2][lvl] = nxt[2][lvl]
                found = nxt
        assert found is not None, (key, seq)
        while self._level > 1 and self._head[2][self._level - 1] is None:
            self._head[2].pop()
            self._level -= 1

    def bulk_insert(self, entries: List[list]) -> None:
        """Merge a large sorted batch in O(n): walk the current level-0
        chain, merge with the new entries, and rebuild perfectly balanced
        towers (node i gets height 1 + trailing_zeros(i)) — deterministic
        and far cheaper than n Python-level tower searches (the arrival
        burst of a standing queue lands here)."""
        # ckeys are unique (seq tie-break), so plain tuple merge never
        # falls through to comparing the payload
        new = sorted(((e[0], e[1]), e[2]) for e in entries)
        old = []
        append = old.append
        node = self._head[2][0]
        while node is not None:
            append((node[0], node[1]))
            node = node[2][0]
        merged = list(heapq.merge(old, new)) if old else new
        level = 1
        self._head = [None, None, [None] * self.MAX_LEVEL]
        last = [self._head] * self.MAX_LEVEL
        for i, (ckey, req) in enumerate(merged, 1):
            h = min(self.MAX_LEVEL, (i & -i).bit_length())
            level = max(level, h)
            node = [ckey, req, [None] * h]
            for lvl in range(h):
                last[lvl][2][lvl] = node
                last[lvl] = node
        self._level = level
        del self._head[2][level:]

    @staticmethod
    def use_bulk(pending: int, indexed: int) -> bool:
        """The rebuild walks the whole chain (O(n)), while per-item
        inserts cost O(m log n) with no memmove — only batches comparable
        to the standing queue amortize the walk."""
        return pending > 64 and pending * 8 >= indexed

    def reqs(self) -> List[Request]:
        out = []
        append = out.append
        node = self._head[2][0]
        while node is not None:
            append(node[1])
            node = node[2][0]
        return out


_INDEXES = {"list": _ListIndex, "skiplist": _SkipListIndex}


class OrderedQueue:
    """A request queue that preserves append order (what FCFS paths and
    stable-sort tie-breaks see) and a priority index kept in ``sort_queue``
    order without per-iteration re-sorts.

    The append-order backing is an insertion-ordered dict keyed by rid, so
    ``remove`` is O(1) — the previous list-subclass representation paid an
    O(n) identity scan (``list.remove``) per removal, which dominated
    batch-formation time on large standing queues. Iteration, ``len`` and
    truthiness behave like the old list view. Keys are assigned lazily at
    the first ``sorted_view`` after an append (the key needs ``now``); each
    keyed entry carries a monotone sequence number so equal keys order
    exactly like Python's stable sort over append order. ``index`` picks
    the priority-index structure (skip list by default; the legacy
    bisected list is retained for reference benchmarks/tests).
    """

    def __init__(self, is_gt: bool, index: str = "skiplist"):
        self.is_gt = is_gt
        self._seq = 0
        self._order: Dict[int, Request] = {}  # rid -> req, append order
        self._index = _INDEXES[index]()
        self._keyed: Dict[int, Tuple[Tuple, int]] = {}  # rid -> (key, seq)
        self._rekey: List[Tuple[float, int, int]] = []  # heap (t, seq, rid)
        self._pending: Dict[int, Request] = {}          # rid -> req
        self._view: Optional[List[Request]] = None

    # -- list-like interface -------------------------------------------- #
    def __iter__(self):
        return iter(self._order.values())

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, req: Request) -> bool:
        return self._order.get(req.rid) is req

    def get(self, rid: int) -> Optional[Request]:
        """O(1) member lookup by rid (None when not queued) — what lets
        the scheduler's incremental min-demand heaps validate lazily."""
        return self._order.get(rid)

    def __repr__(self) -> str:
        return f"OrderedQueue({list(self._order.values())!r})"

    def append(self, req: Request) -> None:
        self._order[req.rid] = req
        self._pending[req.rid] = req

    def remove(self, req: Request) -> None:
        del self._order[req.rid]           # O(1) index-map removal
        self._view = None
        if self._pending.pop(req.rid, None) is not None:
            return
        key, seq = self._keyed.pop(req.rid)
        self._index.remove(key, seq)

    # -- priority view -------------------------------------------------- #
    def _insert(self, req: Request, now: float,
                seq: Optional[int] = None) -> None:
        key = order_key(req, now, self.is_gt)
        if seq is None:                    # re-keys keep their seq so ties
            seq = self._seq                # still break by append order
            self._seq += 1
        self._index.insert(key, seq, req)
        self._keyed[req.rid] = (key, seq)
        t_next = _next_bucket_change(req, key[0])
        if t_next < float("inf"):
            heapq.heappush(self._rekey, (t_next, seq, req.rid))

    def _bulk_key(self, now: float) -> None:
        """Key a large pending batch through the index's bulk path."""
        new = []
        for req in self._pending.values():
            key = order_key(req, now, self.is_gt)
            seq = self._seq
            self._seq += 1
            new.append([key, seq, req])
            self._keyed[req.rid] = (key, seq)
            t_next = _next_bucket_change(req, key[0])
            if t_next < float("inf"):
                heapq.heappush(self._rekey, (t_next, seq, req.rid))
        self._index.bulk_insert(new)
        self._pending.clear()

    def sorted_view(self, now: float) -> List[Request]:
        """The queue in ``sort_queue(queue, now)`` order (a fresh list —
        callers mutate their copy)."""
        if self._pending:
            self._view = None
            if self._index.use_bulk(len(self._pending), len(self._keyed)):
                self._bulk_key(now)
            else:
                for req in self._pending.values():
                    self._insert(req, now)
                self._pending.clear()
        while self._rekey and self._rekey[0][0] <= now:
            _, seq, rid = heapq.heappop(self._rekey)
            cur = self._keyed.get(rid)
            if cur is None or cur[1] != seq:
                continue                   # removed or re-appended since
            key = cur[0]
            req = self._order[rid]
            self._index.remove(key, seq)
            del self._keyed[rid]
            self._insert(req, now, seq=seq)
            self._view = None
        if self._view is None:
            self._view = self._index.reqs()
        return list(self._view)


def pick_fit(sorted_reqs: Sequence[Request], budget: int, now: float,
             is_gt: bool) -> Optional[int]:
    """Within the highest-priority (deadline, kvc) range, binary-search the
    task whose length best fits ``budget`` (§3.4 'binary search to find a
    task ... close to the required length'). Returns an index or None."""
    if not sorted_reqs:
        return None
    head = sorted_reqs[0]
    hk = order_key(head, now, is_gt)[:2]
    # the slice sharing the head's (deadline, kvc) buckets, ordered by
    # descending length -> find first entry with length <= budget
    lo, hi = 0, len(sorted_reqs)
    while lo < hi:
        mid = (lo + hi) // 2
        r = sorted_reqs[mid]
        if order_key(r, now, is_gt)[:2] != hk:
            hi = mid
            continue
        length = r.remaining_predicted if is_gt else r.prompt_len
        if length > budget:
            lo = mid + 1
        else:
            hi = mid
    if lo < len(sorted_reqs):
        r = sorted_reqs[lo]
        length = r.remaining_predicted if is_gt else r.prompt_len
        if length <= budget:
            return lo
    return None
