"""Fibonacci heap + the paper's Algorithm 3 queue (non-private selection).
(The port's copy of ``repro.core.samplers.fib_heap``: numpy, verbatim.)

The heap is a textbook Fibonacci min-heap (O(1) amortized insert /
decrease-key, O(log n) amortized extract-min).  Algorithm 3 keys items on the
*negated* gradient magnitude and only ever decreases keys (i.e. only reacts
when |α⁽ʲ⁾| grows), so stored priorities are stale **upper bounds** on the
true magnitude.  ``get_next`` pops until the best live magnitude seen beats
the next stale bound — correct because bounds only overestimate.

This structure is pointer-chasing and inherently host-side; it is the
deterministic oracle for the TPU-adapted lazy group-argmax
(``samplers/group_argmax.py``) per DESIGN.md §2.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np


class _Node:
    __slots__ = ("key", "item", "parent", "child", "left", "right", "degree", "mark")

    def __init__(self, key: float, item: int):
        self.key = key
        self.item = item
        self.parent: Optional[_Node] = None
        self.child: Optional[_Node] = None
        self.left = self
        self.right = self
        self.degree = 0
        self.mark = False


class FibonacciHeap:
    """Min-heap over (key, item) with decrease_key."""

    def __init__(self):
        self.min: Optional[_Node] = None
        self.n = 0
        self.nodes: Dict[int, _Node] = {}

    def __len__(self) -> int:
        return self.n

    def __contains__(self, item: int) -> bool:
        return item in self.nodes

    def key_of(self, item: int) -> float:
        return self.nodes[item].key

    # -- root-list helpers ---------------------------------------------------
    @staticmethod
    def _splice(a: _Node, b: _Node) -> None:
        """Insert node b into a's circular list (after a)."""
        b.left = a
        b.right = a.right
        a.right.left = b
        a.right = b

    @staticmethod
    def _remove(x: _Node) -> None:
        x.left.right = x.right
        x.right.left = x.left
        x.left = x.right = x

    # -- public ops ----------------------------------------------------------
    def insert(self, item: int, key: float) -> None:
        if item in self.nodes:
            raise KeyError(f"item {item} already present")
        node = _Node(key, item)
        self.nodes[item] = node
        if self.min is None:
            self.min = node
        else:
            self._splice(self.min, node)
            if key < self.min.key:
                self.min = node
        self.n += 1

    def peek(self):
        if self.min is None:
            return None
        return self.min.key, self.min.item

    def extract_min(self):
        z = self.min
        if z is None:
            return None
        # promote children to root list
        if z.child is not None:
            children: List[_Node] = []
            c = z.child
            while True:
                children.append(c)
                c = c.right
                if c is z.child:
                    break
            for c in children:
                self._remove(c)
                c.parent = None
                c.mark = False
                self._splice(z, c)
            z.child = None
        if z.right is z:  # only root (children, if any, were already promoted)
            self.min = None
        else:
            self.min = z.right
            self._remove(z)
            self._consolidate()
        self.n -= 1
        del self.nodes[z.item]
        return z.key, z.item

    def _consolidate(self) -> None:
        import math

        max_degree = int(math.log2(max(self.n, 2))) + 2
        buckets: List[Optional[_Node]] = [None] * (max_degree + 2)
        roots: List[_Node] = []
        c = self.min
        while True:
            roots.append(c)
            c = c.right
            if c is self.min:
                break
        for x in roots:
            d = x.degree
            while d < len(buckets) and buckets[d] is not None:
                y = buckets[d]
                if y.key < x.key:
                    x, y = y, x
                # make y a child of x
                self._remove(y)
                y.parent = x
                y.mark = False
                if x.child is None:
                    x.child = y
                    y.left = y.right = y
                else:
                    self._splice(x.child, y)
                x.degree += 1
                buckets[d] = None
                d = x.degree
            if d >= len(buckets):
                buckets.extend([None] * (d - len(buckets) + 1))
            buckets[d] = x
        # rebuild root list & min pointer
        self.min = None
        for b in buckets:
            if b is None:
                continue
            b.left = b.right = b
            if self.min is None:
                self.min = b
            else:
                self._splice(self.min, b)
                if b.key < self.min.key:
                    self.min = b

    def decrease_key(self, item: int, key: float) -> None:
        x = self.nodes[item]
        if key > x.key:
            raise ValueError("new key larger than current key")
        x.key = key
        y = x.parent
        if y is not None and x.key < y.key:
            self._cut(x, y)
            self._cascading_cut(y)
        if x.key < self.min.key:
            self.min = x

    def _cut(self, x: _Node, y: _Node) -> None:
        if x.right is x:
            y.child = None
        else:
            if y.child is x:
                y.child = x.right
            self._remove(x)
        y.degree -= 1
        x.parent = None
        x.mark = False
        self._splice(self.min, x)

    def _cascading_cut(self, y: _Node) -> None:
        z = y.parent
        if z is None:
            return
        if not y.mark:
            y.mark = True
        else:
            self._cut(y, z)
            self._cascading_cut(z)


class FibHeapQueue:
    """Paper Algorithm 3: lazy stale-upper-bound queue over |α| magnitudes.

    ``magnitude(j)`` must return the *live* |α⁽ʲ⁾| (the queue stores stale
    bounds).  Keys are negated magnitudes (min-heap → max-magnitude first).
    """

    def __init__(self, d: int, magnitude: Callable[[int], float]):
        self.heap = FibonacciHeap()
        self.magnitude = magnitude
        self.d = d
        self.pops = 0          # Fig. 3 accounting: total pops across calls
        self.calls = 0
        self.work = 0          # comparable "touched items" counter

    def add(self, j: int, priority: float) -> None:
        self.heap.insert(j, -priority)

    def add_all(self, priorities: np.ndarray) -> None:
        for j in range(self.d):
            self.add(j, float(priorities[j]))

    def update(self, j: int, priority: float) -> None:
        """Only decrease keys (= increase priority bound); else leave stale."""
        self.work += 1
        key = -priority
        if j in self.heap:
            if key < self.heap.key_of(j):
                self.heap.decrease_key(j, key)
        else:  # item was popped and not yet re-inserted (shouldn't happen mid-iteration)
            self.heap.insert(j, key)

    def get_next(self) -> int:
        self.calls += 1
        best_j = -1
        best_mag = -np.inf
        popped: List[int] = []
        while True:
            top = self.heap.extract_min()
            self.pops += 1
            self.work += 1
            if top is None:
                break
            _, c = top
            popped.append(c)
            mag_c = self.magnitude(c)
            if mag_c > best_mag:
                best_mag = mag_c
                best_j = c
            nxt = self.heap.peek()
            if nxt is None or best_mag >= -nxt[0]:
                break
        # re-insert popped items with fresh (live) priorities
        for c in popped:
            self.heap.insert(c, -self.magnitude(c))
        return best_j


def _fib_update_batch(self, idx, priorities) -> None:
    """Per-item under the hood — a pointer heap has no vector form; kept so
    the fast fw_sparse path can treat all queues uniformly."""
    for j, v in zip(idx, priorities):
        self.update(int(j), float(v))


FibHeapQueue.update_batch = _fib_update_batch
