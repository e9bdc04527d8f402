# Copy of veryfasttree_tpu/io/newick.py, its printer (the port imports none of it).
"""Newick tree printing against the engine's flat tree arrays.

Mirrors the reference's iterative writer (ref printNJ NeighbourJoining.tcc:
2706-2794: duplicate sequences become zero-length subtrees, float trees print
branch lengths %.5f vs double %.9f, optional support values ")%.3f:").  The
reader (parse_newick) serves -intree, which the port does not run yet.
"""
from __future__ import annotations

from typing import List


def quote_name(name: str, do_quote: bool) -> str:
    return f"'{name}'" if do_quote else name


def print_newick(tree, names, unique, show_support: bool, double_precision: bool,
                 quote: bool = False) -> str:
    """tree: engine TreeState; names: original alignment names."""
    fmt = "%.9f" if double_precision else "%.5f"
    n_seqs = tree.n_seqs
    out: List[str] = []

    if n_seqs == 1 and unique.aln_next[unique.unique_first[0]] >= 0:
        first = unique.unique_first[0]
        out.append("(")
        out.append(quote_name(names[first], quote) + ":0.0")
        i = unique.aln_next[first]
        while i >= 0:
            out.append("," + quote_name(names[i], quote) + ":0.0")
            i = unique.aln_next[i]
        out.append(");")
        return "".join(out)

    stack = [(tree.root, 0)]
    while stack:
        node, end = stack.pop()
        if node < n_seqs:
            if tree.children[tree.parent[node]][0] != node:
                out.append(",")
            first = unique.unique_first[node]
            if unique.aln_next[first] == -1:
                out.append(quote_name(names[first], quote))
            else:
                out.append("(" + quote_name(names[first], quote) + ":0.0")
                i = unique.aln_next[first]
                while i >= 0:
                    out.append("," + quote_name(names[i], quote) + ":0.0")
                    i = unique.aln_next[i]
                out.append(")")
            out.append(":" + fmt % tree.branchlength[node])
        elif end:
            if node == tree.root:
                out.append(")")
            elif show_support:
                out.append(")%.3f:" % tree.support[node] + fmt % tree.branchlength[node])
            else:
                out.append("):" + fmt % tree.branchlength[node])
        else:
            if node != tree.root and tree.children[tree.parent[node]][0] != node:
                out.append(",")
            out.append("(")
            stack.append((node, 1))
            for child in reversed(tree.children[node][: tree.n_child[node]]):
                stack.append((int(child), 0))
    out.append(";")
    return "".join(out)
