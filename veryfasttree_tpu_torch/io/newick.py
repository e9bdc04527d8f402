# Copy of veryfasttree_tpu/io/newick.py, its printer and reader (the port imports none of it).
"""Newick tree printing and parsing against the engine's flat tree arrays.

Mirrors the reference's iterative writer (ref printNJ NeighbourJoining.tcc:
2706-2794: duplicate sequences become zero-length subtrees, float trees print
branch lengths %.5f vs double %.9f, optional support values ")%.3f:") and its
tokenizing reader (ref readTree :2449-2704: ignores non-unique leaves after
the first, prunes single-child internal nodes, unroots to a trifurcation),
which -intree takes.
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


def tokenize_newick(text_iter):
    """Yield Newick tokens: ():;, or name strings (ref readTreeToken :3316-3339)."""
    buf = []
    for ch in text_iter:
        if ch in "():;,":
            if buf:
                yield "".join(buf)
                buf = []
            yield ch
        elif ch.isspace():
            if buf:
                yield "".join(buf)
                buf = []
        else:
            buf.append(ch)
    if buf:
        yield "".join(buf)


def parse_newick(text: str, name_to_index, unique):
    """Parse a Newick string into (parents, children lists, root) in *unique*
    leaf index space.  Non-unique leaves after the first are ignored; internal
    nodes with <2 children pruned; root made trifurcating when possible
    (ref readTree NeighbourJoining.tcc:2449-2704).

    name_to_index: alignment name -> alignment row; unique: Uniquify.
    Returns (parent, children, n_child, root, n_used) where the arrays cover
    2*n_unique slots.
    """
    n_unique = len(unique.unique_seq)
    maxnodes = 2 * n_unique
    parent = [-1] * maxnodes
    children = [[] for _ in range(maxnodes)]
    root = n_unique
    maxnode = n_unique + 1

    stack = [root]
    n_down = 0
    n_up = 0
    tokens = list(tokenize_newick(iter(text)))
    i = 0
    if not tokens or tokens[0] != "(":
        raise ValueError("Tree parse error: no '(' at start")
    i = 1

    def add_child(par, ch):
        parent[ch] = par
        children[par].append(ch)

    def maybe_add_leaf(par, name):
        if name not in name_to_index:
            raise ValueError(f"Tree parse error: {name} not recognized as a sequence name")
        iu = unique.aln_to_uniq[name_to_index[name]]
        if parent[iu] < 0 and iu not in children[par]:
            if parent[iu] < 0:
                add_child(par, iu)

    while i < len(tokens):
        token = tokens[i]
        i += 1
        if n_down > 0:
            if token == "(":
                n_down += 1
            elif token in ",;:)":
                raise ValueError("Tree parse error while reading parentheses")
            else:
                while n_down > 0:
                    n_down -= 1
                    newnode = maxnode
                    maxnode += 1
                    add_child(stack[-1], newnode)
                    stack.append(newnode)
                maybe_add_leaf(stack[-1], token)
        elif n_up > 0:
            if token == ";":
                if n_up != len(stack):
                    raise ValueError("Tree parse error: unbalanced parentheses")
                break
            elif token == ")":
                n_up += 1
            elif token == "(":
                raise ValueError("Tree parse error: unexpected '(' after ')'")
            elif token == ":":
                i += 1  # skip branch length
            elif token == ",":
                while n_up > 0:
                    n_up -= 1
                    stack.pop()
                    if not stack:
                        raise ValueError("Tree parse error: too many ')'")
            else:
                pass  # bootstrap label -- ignore
        elif token == "(":
            n_down = 1
        elif token == ")":
            n_up = 1
        elif token == ":":
            i += 1
        elif token == ",":
            pass
        elif token == ";":
            raise ValueError("Tree parse error: unexpected ';'")
        else:
            maybe_add_leaf(stack[-1], token)

    for iu in range(n_unique):
        if parent[iu] < 0:
            raise ValueError(
                f"Alignment sequence {unique.unique_first[iu]} (unique {iu}) absent "
                "from input tree. The starting tree must include all sequences.")

    # prune internal nodes with < 2 children (iterate to fixpoint)
    def remove_node(node):
        par = parent[node]
        parent[node] = -1
        children[par].remove(node)
        for ch in children[node]:
            children[par].append(ch)
            parent[ch] = par
        children[node] = []

    changed = True
    while changed:
        changed = False
        stack2 = [root]
        while stack2:
            node = stack2.pop()
            if node >= n_unique:
                if len(children[node]) <= 1:
                    if node != root:
                        remove_node(node)
                        changed = True
                    elif len(children[node]) == 1:
                        newroot = children[node][0]
                        parent[newroot] = -1
                        children[node] = []
                        root = newroot
                        changed = True
                        stack2.append(newroot)
                else:
                    stack2.extend(children[node])

    # root with 2 children: merge one binary child to get a trifurcation
    if len(children[root]) == 2:
        for ch in list(children[root]):
            if len(children[ch]) == 2:
                remove_node(ch)
                break

    # compact the internal-node numbering
    mapping = {i: i for i in range(n_unique)}
    order = []
    stack2 = [root]
    while stack2:
        node = stack2.pop()
        if node >= n_unique:
            order.append(node)
            stack2.extend(children[node])
    next_id = n_unique
    for node in order:
        mapping[node] = next_id
        next_id += 1

    out_parent = [-1] * maxnodes
    out_children = [[] for _ in range(maxnodes)]
    for node, mapped in mapping.items():
        out_children[mapped] = [mapping[c] for c in children[node]]
        if parent[node] >= 0:
            out_parent[mapped] = mapping[parent[node]]
    return out_parent, out_children, mapping[root], next_id
