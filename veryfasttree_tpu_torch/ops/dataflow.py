"""Host side of the whole-tree kernels (``csrc/dataflow.cuh``): level tables
in CSR form, sent to a device in one pinned copy, and the control words and
ready flags the kernels' scheduler runs on.

The ML sweep and tree log-likelihood (``ops/ml_kernels.py``) and the ME
up-profile sweep and pair list (``ops/store_kernels.py``) share them.
"""
from __future__ import annotations

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
