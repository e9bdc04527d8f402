"""The host side of a whole minimum-evolution round on the card
(``csrc/me_round.cuh``), shared by the SPR round (``spr_kernels.py``) and
the NNI round (``nni_kernels.py``): the checks of the tree's indices, the
one device buffer a round uploads before its launch and fetches after it,
and the store, model and tree arguments every round entry takes first.
"""
from __future__ import annotations

import numpy as np
import torch

from .store_kernels import _check_store


def check_tree(name, tree, nodes=()):
    """Raise IndexError for a tree index outside the tree's M nodes, or a
    listed node at or past maxnode."""
    M = tree.maxnodes
    ok = lambda a: bool(((a >= -1) & (a < M)).all())  # noqa: E731
    nodes = np.asarray(nodes)
    if not (ok(tree.parent) and ok(tree.children)) or \
            not (0 <= tree.root < M) or (nodes < 0).any() \
            or (nodes >= tree.maxnode).any():
        raise IndexError(f"{name}: a tree index lies outside the {M} nodes")


def entry_args(nj):
    """(the leading arguments of a round's C entry: the store (codes, W, U,
    code_freq, n_rows, leaf_rows, P, C), the model (ev, et, tol), the tree
    (n_seqs, M, root) and the options (bionj, logdist, jc, pseudo); the
    tensors they point into that are not the store's, to keep alive until
    the launch)."""
    prof, opts = nj.prof, nj.options
    leaf_rows = prof._leaf_rows
    n_rows, P, C = _check_store(prof.codes, prof.W, prof.U, prof.code_freq,
                                leaf_rows)
    ev = et = None
    if prof.use_matrix:
        ev = prof.eigenval.to(dtype=torch.float64).contiguous()
        et = prof.eigentot.to(dtype=torch.float32).contiguous()
    jc = opts.n_codes == 4 and not opts.use_matrix
    args = [prof.codes.data_ptr(), prof.W.data_ptr(), prof.U.data_ptr(),
            prof.code_freq.data_ptr(), n_rows, int(leaf_rows), P, C,
            ev.data_ptr() if ev is not None else None,
            et.data_ptr() if et is not None else None, prof.tol, nj.n_seqs,
            nj.tree.maxnodes, nj.tree.root, int(opts.bionj),
            int(opts.logdist), int(jc), float(opts.pseudo_weight)]
    return args, (ev, et)


class RoundBuffer:
    """A round's state in one device buffer, uploaded once and fetched
    once: int64 words [n_words] (the counters first), the tree as int32
    parent [M] | children [M, 3] | child counts [M] | path scratch [M],
    `ints` (int32), then n_flags byte arrays [M] of scratch."""

    def __init__(self, tree, n_words, ints=(), n_flags=1):
        M = self.M = tree.maxnodes
        self.tree_at = 8 * n_words
        self.ints_at = self.tree_at + 4 * 6 * M
        self.flags_at = self.ints_at + 4 * len(ints)
        self.host = np.zeros(self.flags_at + n_flags * M, dtype=np.uint8)
        self.words = self.host[: self.tree_at].view(np.int64)
        t = self.host[self.tree_at: self.ints_at].view(np.int32)
        t[:M] = tree.parent
        t[M: 4 * M] = tree.children.reshape(-1)
        t[4 * M: 5 * M] = tree.n_child
        self.host[self.ints_at: self.flags_at].view(np.int32)[:] = ints
        self.buf = None

    def upload(self, dev):
        """Copy the buffer to dev; returns the device pointers of its parts
        (words, tree, path, ints, flags)."""
        self.buf = torch.from_numpy(self.host).to(dev)
        base = self.buf.data_ptr()
        return {"words": base, "tree": base + self.tree_at,
                "path": base + self.tree_at + 4 * 5 * self.M,
                "ints": base + self.ints_at, "flags": base + self.flags_at}

    def fetch(self, name, tree, counters):
        """The round's one fetch: the words and the tree's parent and
        children, which go back into `tree`.  Returns (the counters, the
        first words, by the names `counters` gives them in the kernel's
        order; all the words); raises if the kernel found the tree
        broken."""
        M = self.M
        out = self.buf[: self.tree_at + 4 * 4 * M].cpu().numpy()
        words = out[: self.tree_at].view(np.int64)
        ctr = dict(zip(counters, words[: len(counters)].tolist()))
        if ctr["fault"]:
            raise RuntimeError(f"{name}: the kernel found the tree broken (a "
                               "child missing from its parent, or no path to "
                               "the root)")
        t = out[self.tree_at:].view(np.int32)
        tree.parent[:] = t[:M]
        tree.children[:] = t[M: 4 * M].reshape(M, 3)
        return ctr, words


def raise_on(rc, name):
    if rc == -2:
        raise ValueError(f"{name}: the kernel does not take this store or "
                         "tree")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError "
                           f"{rc})")
