"""Host side of the whole-tree kernels (``csrc/dataflow.cuh``): level tables
in CSR form, sent to a device in one pinned copy, and the control words and
ready flags the kernels' scheduler runs on.

The ML sweep and tree log-likelihood (``ops/ml_kernels.py``) and the ME
up-profile sweep and pair list (``ops/store_kernels.py``) share them.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from . import _build

_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


def typed(buf, offset, shape, dtype):
    """A view of bytes [offset, ...) of a uint8 buffer as `dtype`; offset is
    a multiple of 16."""
    n = int(np.prod(shape)) * dtype.itemsize
    return buf[offset:offset + n].view(dtype).view(shape)


def align16(n: int) -> int:
    return (n + 15) // 16 * 16


def to_device(arrays: dict, dev) -> dict:
    """{name: tensor on dev} of int32 and float32 numpy arrays, sent in one
    copy through pinned memory, in stream order (the host does not wait)."""
    at, n = {}, 0
    for name, a in arrays.items():
        at[name] = n
        n += align16(a.nbytes)
    host = torch.empty(max(n, 16), dtype=torch.uint8, pin_memory=True)
    raw = host.numpy()
    for name, a in arrays.items():
        raw[at[name]:at[name] + a.nbytes] = a.view(np.uint8)
    buf = host.to(dev, non_blocking=True)
    return {name: typed(buf, at[name], a.shape, _TORCH[a.dtype])
            for name, a in arrays.items()}


def csr_offsets(level_ids, n_levels):
    """Offsets [L + 1] of the non-empty levels of items whose level indices
    (non-decreasing, below n_levels) are level_ids."""
    counts = np.bincount(level_ids, minlength=n_levels)
    return np.concatenate([[0], np.cumsum(counts[counts > 0])]) \
        .astype(np.int64)


def producers(targets, sources, level, name):
    """The item that writes each source row (-1: none), which must lie in
    an earlier level than the reader's."""
    order = np.argsort(targets, kind="stable")
    st = targets[order]
    if len(st) == 0:
        return np.full(len(sources), -1, dtype=np.int64)
    at = np.minimum(np.searchsorted(st, sources), len(st) - 1)
    hit = st[at] == sources
    prod = np.where(hit, order[at], -1)
    if (hit & (level[np.maximum(prod, 0)] >= level)).any():
        raise ValueError(f"{name}: a level reads a row that it or a later "
                         "level writes")
    return prod


class Chains:
    """A posterior sweep split into chains (``csrc/ml_sweep.cu``): each
    chain a list of items in which every item after the first reads the
    previous item's target, run by one unit at a chunk of positions.

    order [n]: the items in unit order, chain after chain; starts
    [n_chains + 1]: each chain's first entry of order.  Per item (the
    tables' own indices): side, bit 0 where r1 is the previous item's
    target, bit 1 where r2 is (0 for a chain's first item); wait1, wait2:
    the flag slot of the item of another chain that writes r1, r2 (-1:
    none); slot: the item's own flag slot, where an item of another chain
    reads it (-1: none), numbered in unit order."""

    def __init__(self, order, starts, side, wait1, wait2, slot):
        self.order, self.starts, self.side, self.wait1, self.wait2, \
            self.slot = (np.asarray(a, dtype=np.int64) for a in (
                order, starts, side, wait1, wait2, slot))
        self.n_chains = len(self.starts) - 1
        self.n_slots = int((self.slot >= 0).sum())


def _path_lengths(level_starts, prod1, prod2):
    """(down, up): the items of the longest path of producers that ends at
    each item, and of readers that starts there, level by level."""
    n = len(prod1)
    down = np.zeros(n, dtype=np.int64)
    up = np.zeros(n, dtype=np.int64)
    spans = list(zip(level_starts[:-1], level_starts[1:]))
    for a, b in spans:
        d = np.zeros(b - a, dtype=np.int64)
        for prod in (prod1[a:b], prod2[a:b]):
            d = np.maximum(d, np.where(prod >= 0, down[np.maximum(prod, 0)],
                                       0))
        down[a:b] = d + 1
    below = np.zeros(n, dtype=np.int64)
    for a, b in reversed(spans):
        up[a:b] = below[a:b] + 1
        for prod in (prod1[a:b], prod2[a:b]):
            hit = prod >= 0
            np.maximum.at(below, prod[hit], up[a:b][hit])
    return down, up


def build_chains(level_starts, prod1, prod2, max_len=None) -> Chains:
    """The chains of a sweep whose items (level_starts: each level's first
    item) read the items prod1, prod2 (-1: none) of earlier levels: its
    longest paths.  An item continues the chain of the producer on its
    longest path from a first item (down), and a producer hands its chain
    to the reader on its longest path to a last item (up); an edge joins
    two items where each is the other's choice.  So a tree's sweep
    bottom-up (one reader an item) continues every chain through the
    deeper child, and top-down (one producer an item, two readers) through
    the deeper subtree.  With max_len, a chain is cut into segments of at
    most max_len items, each reading the one before it as another chain.

    The chains are listed in a topological order (every chain reads only
    chains before it), by list scheduling on the critical path: of the
    chains whose producers are all listed, the one with the longest path
    of items from its first item to a last one goes next (the lowest
    chain on a tie).  So a long chain's segments and the chains they read
    come early, and a kernel that takes units in list order starts the
    critical path first.  Raises ValueError where the chains read each
    other in a cycle or an item reads an earlier item of its own chain
    than the previous one."""
    prod1 = np.asarray(prod1, dtype=np.int64)
    prod2 = np.asarray(prod2, dtype=np.int64)
    n = len(prod1)
    down, up = _path_lengths(np.asarray(level_starts, dtype=np.int64), prod1,
                             prod2)
    # each reader's producer on its longest path (r1's on a tie)
    d1 = np.where(prod1 >= 0, down[np.maximum(prod1, 0)], -1)
    d2 = np.where(prod2 >= 0, down[np.maximum(prod2, 0)], -1)
    best_p = np.where(d2 > d1, prod2, prod1)
    # each producer's reader on its longest path (the lowest item on a tie)
    readers = np.concatenate([np.flatnonzero(prod1 >= 0),
                              np.flatnonzero((prod2 >= 0) & (prod2 != prod1))])
    makers = np.concatenate([prod1[prod1 >= 0],
                             prod2[(prod2 >= 0) & (prod2 != prod1)]])
    best_k = np.full(n, -1, dtype=np.int64)
    if len(readers):
        ranked = np.lexsort((readers, -up[readers], makers))
        mk, rk = makers[ranked], readers[ranked]
        first = np.concatenate([[True], mk[1:] != mk[:-1]])
        best_k[mk[first]] = rk[first]
    pred = np.where((best_p >= 0) & (best_k[np.maximum(best_p, 0)]
                                     == np.arange(n)), best_p, -1)
    spans = list(zip(level_starts[:-1], level_starts[1:]))
    if max_len is not None:
        # each item's place in its chain; a segment starts every max_len
        place = np.zeros(n, dtype=np.int64)
        for a, b in spans:
            p = pred[a:b]
            place[a:b] = np.where(p >= 0, place[np.maximum(p, 0)] + 1, 0)
        pred = np.where(place % max_len == 0, -1, pred)
    # chain ids in level order: an item takes its predecessor's
    chain = np.full(n, -1, dtype=np.int64)
    heads = pred < 0
    chain[heads] = np.arange(int(heads.sum()))
    for a, b in spans:
        p = pred[a:b]
        has = p >= 0
        chain[a:b][has] = chain[p[has]]
    n_chains = int(heads.sum())
    # side bits and the reads of other chains
    side = np.zeros(n, dtype=np.int64)
    for bit, prod in ((1, prod1), (2, prod2)):
        side |= np.where((prod >= 0) & (prod == pred), bit, 0)
    ext = []
    for prod in (prod1, prod2):
        hit = (prod >= 0) & (prod != pred)
        same = hit & (chain[np.maximum(prod, 0)] == chain)
        if same.any():
            raise ValueError("posterior sweep: an item reads an earlier item "
                             "of its own chain than the previous one")
        ext.append(np.stack([chain[prod[hit]], chain[hit]]))
    edges = np.unique(np.concatenate(ext, axis=1), axis=1) if n else \
        np.zeros((2, 0), dtype=np.int64)
    # list scheduling: the longest path from each chain's first item
    first_of = np.full(n_chains, -1, dtype=np.int64)
    first_of[chain[heads]] = np.flatnonzero(heads)
    prio = up[first_of] if n_chains else np.zeros(0, dtype=np.int64)
    waiting = np.bincount(edges[1], minlength=n_chains).tolist()
    readers_of = [[] for _ in range(n_chains)]
    for d, c in edges.T.tolist():
        readers_of[d].append(c)
    ready = [(-int(prio[c]), c) for c in range(n_chains) if waiting[c] == 0]
    heapq.heapify(ready)
    chain_order = []
    while ready:
        _, c = heapq.heappop(ready)
        chain_order.append(c)
        for r in readers_of[c]:
            waiting[r] -= 1
            if waiting[r] == 0:
                heapq.heappush(ready, (-int(prio[r]), r))
    if len(chain_order) != n_chains:
        raise ValueError("posterior sweep: its chains read each other in a "
                         "cycle")
    chain_order = np.asarray(chain_order, dtype=np.int64)
    pos = np.empty(n_chains, dtype=np.int64)
    pos[chain_order] = np.arange(n_chains)
    # items by chain, each chain in level order (the items' own order)
    order = np.lexsort((np.arange(n), pos[chain]))
    starts = np.searchsorted(pos[chain[order]], np.arange(n_chains + 1))
    # flag slots: the items another chain reads, in unit order
    flagged = np.zeros(n, dtype=bool)
    for prod in (prod1, prod2):
        hit = (prod >= 0) & (prod != pred)
        flagged[prod[hit]] = True
    slot = np.full(n, -1, dtype=np.int64)
    ordered = order[flagged[order]]
    slot[ordered] = np.arange(len(ordered))
    waits = [np.where((prod >= 0) & (prod != pred),
                      slot[np.maximum(prod, 0)], -1) for prod in (prod1, prod2)]
    return Chains(order, starts, side, *waits, slot)


def check_chains(ch: Chains, prod1, prod2) -> None:
    """Raise ValueError unless ch runs a sweep whose items read prod1,
    prod2 (-1: none) in an order free of deadlock: every item in exactly
    one chain; each step of a chain reads the previous item's target, and
    the side bits say which source that is; every other source that an
    item of the sweep writes is waited on, through that item's flag slot,
    and lies in a chain before this one; and the items with a flag slot are
    exactly those that an item of another chain reads."""
    prod1 = np.asarray(prod1, dtype=np.int64)
    prod2 = np.asarray(prod2, dtype=np.int64)
    n = len(prod1)
    order, starts = ch.order, ch.starts
    if len(order) != n or not np.array_equal(np.sort(order), np.arange(n)):
        raise ValueError("chains: the items are not each in one chain")
    if starts[0] != 0 or starts[-1] != n or (np.diff(starts) <= 0).any():
        raise ValueError("chains: a chain is empty or the starts do not "
                         "cover the items")
    chain = np.empty(n, dtype=np.int64)
    chain[order] = np.repeat(np.arange(ch.n_chains), np.diff(starts))
    prev = np.full(n, -1, dtype=np.int64)
    inner = np.ones(n, dtype=bool)
    inner[starts[:-1]] = False
    prev[order[inner]] = order[np.flatnonzero(inner) - 1]
    side = np.zeros(n, dtype=np.int64)
    for bit, prod in ((1, prod1), (2, prod2)):
        side |= np.where((prod >= 0) & (prod == prev), bit, 0)
    if ((prev >= 0) & (side == 0)).any():
        raise ValueError("chains: a chain's item does not read the previous "
                         "item's target")
    if not np.array_equal(side, ch.side):
        raise ValueError("chains: the side bits do not name the sources "
                         "that the previous item writes")
    slot_of = ch.slot
    flagged = np.zeros(n, dtype=bool)
    for prod, wait in ((prod1, ch.wait1), (prod2, ch.wait2)):
        ext = (prod >= 0) & (prod != prev)
        p = np.maximum(prod, 0)
        if (ext & (chain[p] >= chain)).any():
            raise ValueError("chains: an item waits on a chain that is not "
                             "before its own")
        want = np.where(ext, slot_of[p], -1)
        if (ext & (slot_of[p] < 0)).any() or not np.array_equal(want, wait):
            raise ValueError("chains: a wait does not point to the flag of "
                             "the item that writes its source")
        flagged[prod[ext]] = True
    if not np.array_equal(flagged, slot_of >= 0):
        raise ValueError("chains: the flagged items are not those another "
                         "chain reads")
    slots = np.sort(slot_of[slot_of >= 0])
    if not np.array_equal(slots, np.arange(len(slots))):
        raise ValueError("chains: the flag slots are not 0..n_slots - 1")


class LevelTables:
    """Level tables in CSR form: level l's items from offsets[l] to
    offsets[l + 1].  upload(dev) sends the kernel's arrays to a device
    once."""

    def levels(self):
        """Each level's slices of `fields`, in order."""
        for a, b in zip(self.offsets[:-1], self.offsets[1:]):
            yield tuple(getattr(self, f)[a:b] for f in self.fields)

    @property
    def n_levels(self) -> int:
        return len(self.offsets) - 1

    @classmethod
    def from_levels(cls, levels):
        """The tables of a list of levels (one array per field), empty
        levels left out."""
        levels = [lv for lv in levels if len(lv[0])]
        sizes = [len(lv[0]) for lv in levels]
        cols = [np.concatenate([np.asarray(lv[i]) for lv in levels])
                if levels else np.zeros(0) for i in range(len(cls.fields))]
        return cls(np.concatenate([[0], np.cumsum(sizes)]), *cols)

    def producers_of(self, name, targets, *sources):
        """producers() of each source list, the targets checked distinct."""
        st = np.sort(targets)
        if (st[1:] == st[:-1]).any():
            raise ValueError(f"{name}: targets must be distinct")
        level = np.repeat(np.arange(self.n_levels), np.diff(self.offsets))
        return [producers(targets, s, level, name) for s in sources]

    def _rows(self):
        return np.concatenate([getattr(self, f) for f in self.row_fields])

    def check_rows(self, n_rows, name):
        rows = self._rows()
        if len(rows) and (rows.min() < 0 or rows.max() >= n_rows):
            raise IndexError(f"{name}: a row index lies outside the store")

    def upload(self, dev):
        """{name: tensor on dev} of the kernel's arrays (kernel_arrays())."""
        key = str(dev)
        if key not in self._on:
            self._on[key] = to_device(self.kernel_arrays(), dev)
        return self._on[key]


class Workspace:
    """The control words and ready flags of the whole-tree kernels on one
    stream, and the scratch of a tree log-likelihood: the flags are zeroed
    when allocated and tagged with each launch's epoch, so no launch resets
    them."""

    def __init__(self, device):
        self.device = device
        self.ctrl = None
        self.scratch = None
        self.epoch = 0

    def flags(self, n_units):
        """(control block and flags, flags they hold) for n_units."""
        words = _build.library().vft_dataflow_ctrl_words()
        if self.ctrl is None or self.ctrl.numel() < words + n_units:
            size = max(words + n_units,
                       2 * (0 if self.ctrl is None else self.ctrl.numel()))
            self.ctrl = torch.zeros(size, dtype=torch.int32,
                                    device=self.device)
        return self.ctrl, self.ctrl.numel() - words

    def scratch_buffer(self, n_bytes):
        if self.scratch is None or self.scratch.numel() < n_bytes:
            size = max(n_bytes, 2 * (0 if self.scratch is None
                                     else self.scratch.numel()), 256)
            self.scratch = torch.empty(size, dtype=torch.uint8,
                                       device=self.device)
        return self.scratch

    def next_epoch(self) -> int:
        self.epoch = self.epoch % 0x7FFFFFFF + 1
        return self.epoch


_WORKSPACES = {}


def workspace(device, stream) -> Workspace:
    """The Workspace of a device's stream (a CUDA stream handle)."""
    key = (str(device), stream)
    if key not in _WORKSPACES:
        _WORKSPACES[key] = Workspace(device)
    return _WORKSPACES[key]
