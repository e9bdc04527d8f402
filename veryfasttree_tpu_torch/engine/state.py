# Copy of veryfasttree_tpu/engine/state.py (which imports no jax itself, but importing it runs veryfasttree_tpu/engine/__init__.py, which does),
# with level_order added at the end.
"""Flat-array tree topology state + traversals.

The reference keeps the inferred tree as flat arrays indexed by node id
(ref NeighbourJoining.h:294-299: parent / Children / branchlength / support,
root has 3 children).  We keep the same layout in numpy on the host; device
kernels receive index lists derived from it.

Traversals: restartable post-order (ref traversePostorder tcc:3342-3379) and
level-order frontier lists (ref parallelTraverse tcc:5752-5765) -- the latter
is the TPU-native batching unit: all nodes in one level are independent, so
per-level profile recomputation is a single batched device call.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np


class TreeState:
    def __init__(self, n_seqs: int, maxnodes: int):
        self.n_seqs = n_seqs
        self.maxnodes = maxnodes
        self.maxnode = n_seqs  # next id to allocate
        self.root = -1
        self.parent = np.full(maxnodes, -1, dtype=np.int64)
        self.children = np.full((maxnodes, 3), -1, dtype=np.int64)
        self.n_child = np.zeros(maxnodes, dtype=np.int32)
        self.branchlength = np.zeros(maxnodes, dtype=np.float64)
        self.support = np.full(maxnodes, -1.0, dtype=np.float64)

    # -- topology edits ------------------------------------------------------
    def set_children(self, node: int, kids) -> None:
        self.n_child[node] = len(kids)
        self.children[node, :] = -1
        for k, c in enumerate(kids):
            self.children[node, k] = c
            self.parent[c] = node

    def replace_child(self, par: int, oldchild: int, newchild: int) -> None:
        """ref replaceChild tcc:1930-1940"""
        self.parent[newchild] = par
        for k in range(self.n_child[par]):
            if self.children[par, k] == oldchild:
                self.children[par, k] = newchild
                return
        raise AssertionError("replace_child: old child not found")

    def sibling(self, node: int) -> int:
        """ref sibling tcc:1976-1989 (at root: no unique sibling, -1)"""
        par = self.parent[node]
        if par < 0 or par == self.root:
            return -1
        for k in range(self.n_child[par]):
            if self.children[par, k] != node:
                return int(self.children[par, k])
        raise AssertionError

    def root_siblings(self, node: int) -> List[int]:
        """ref rootSiblings tcc:1991-2003"""
        assert self.parent[node] == self.root and self.n_child[self.root] == 3
        return [int(c) for c in self.children[self.root, :3] if c != node]

    def active_ancestor(self, node: int) -> int:
        if node < 0:
            return node
        while self.parent[node] >= 0:
            node = int(self.parent[node])
        return node

    def path_to_root(self, node: int) -> List[int]:
        path = []
        while node >= 0:
            path.append(node)
            node = int(self.parent[node])
        return path

    # -- traversals ----------------------------------------------------------
    def traverse_postorder(self, node: int, traversal: np.ndarray,
                           branch_root: int, want_up: bool = False):
        """Restartable postorder step (ref traversePostorder tcc:3342-3379).

        Returns (node, up) or (None, False) when done; `traversal` is a bool
        array updated in place.  With want_up, revisited nodes (after an NNI
        swap) are returned once more with up=True.
        """
        while True:
            found = False
            for k in range(self.n_child[node]):
                ch = int(self.children[node, k])
                if not traversal[ch]:
                    node = ch
                    found = True
                    break
            if found:
                continue
            if not traversal[node]:
                traversal[node] = True
                return node, False
            if node == branch_root:
                return None, False
            node = int(self.parent[node])
            if want_up and traversal[node]:
                return node, True

    def postorder_nodes(self, start: Optional[int] = None) -> Iterator[int]:
        traversal = np.zeros(self.maxnodes, dtype=bool)
        root = self.root if start is None else start
        while True:
            node, _ = self.traverse_postorder(root, traversal, root)
            if node is None:
                return
            yield node

    def level_lists(self) -> List[np.ndarray]:
        """Leaves-first level-order frontier lists (ref parallelTraverse).

        Every node in a level has all its children in earlier levels, so
        levels are the batched bottom-up recomputation schedule.
        """
        levels = [[self.root]]
        while levels[-1]:
            nxt = []
            for node in levels[-1]:
                for k in range(self.n_child[node]):
                    nxt.append(int(self.children[node, k]))
            levels.append(nxt)
        levels.pop()
        return [np.array(lv, dtype=np.int64) for lv in reversed(levels)]


def level_order(tree):
    """tree.level_lists() (the levels leaves first, each level in the
    breadth-first order from the root) by a frontier walk with one numpy
    step per level, where level_lists takes a Python step per node."""
    levels = []
    level = np.array([tree.root], dtype=np.int64)
    slots = np.arange(3)
    while len(level):
        levels.append(level)
        level = tree.children[level][slots < tree.n_child[level][:, None]]
    return levels[::-1]
