# Copy of veryfasttree_tpu/engine/partition.py (the port imports none of it).
"""Tree partitioning: split the tree into balanced subtrees for parallel
rearrangement work (ref treePartitioning NeighbourJoining.tcc:5540-5750).

The signature VeryFastTree parallel strategy: compute subtree weights and
heights, discount nodes fewer than `penalty` levels above the leaves, then
greedily split the heaviest candidate subtree while the theoretical speedup
(LPT bin-packing onto `workers` bins) keeps improving, judged by a tendency
window over the last `window` scores.  On TPU we use the partitions to run
independent SPR chains in lockstep (engine/spr_batched.py); NNI and length
phases use level batching instead (the more natural TPU idiom).
"""
from __future__ import annotations

from typing import List

import numpy as np


def tree_partitioning(nj, penalty: int, workers: int | None = None,
                      window: int | None = None) -> List[int]:
    """Returns subtree roots, round-robin flattened per worker like the
    reference (missing slots dropped rather than -1 padded)."""
    tree = nj.tree
    opts = nj.options
    workers = workers or max(opts.threads, 2)
    window = window or opts.partitioning_tendency_window
    maxnode = tree.maxnode

    # subtree weights + heights (ref :5543-5594)
    weights = np.ones(maxnode, dtype=np.int64)
    heights = np.zeros(maxnode, dtype=np.int64)
    order = []
    stack = [int(c) for c in tree.children[tree.root, : tree.n_child[tree.root]]]
    seen = np.zeros(maxnode, dtype=bool)
    while stack:
        node = stack.pop()
        order.append(node)
        heights[node] = heights[tree.parent[node]] + 1
        for k in range(tree.n_child[node]):
            stack.append(int(tree.children[node, k]))
    for node in reversed(order):
        for k in range(tree.n_child[node]):
            weights[node] += weights[int(tree.children[node, k])]
    tree_height = heights.max() if len(order) else 0
    heights = tree_height - heights

    # discounted weights: only the subtree at least `penalty` levels below
    pweights = weights.copy()
    for node in order:
        if heights[node] < penalty:
            pweights[node] = 0
        elif penalty > 0:
            frontier = [node]
            for _ in range(penalty):
                nxt = []
                for n in frontier:
                    for k in range(tree.n_child[n]):
                        nxt.append(int(tree.children[n, k]))
                frontier = nxt
            pweights[node] = sum(weights[n] for n in frontier)

    def evaluate(sol):
        """theoretical speedup of an LPT assignment (ref :5596-5620)."""
        if not sol:
            return maxnode / maxnode, maxnode
        if len(sol) <= workers:
            pwork = sum(pweights[n] for n in sol)
            result = maxnode - pwork + pweights[sol[-1]]
        else:
            bins = [0] * workers
            pwork = 0
            for n in sorted(sol, key=lambda x: -pweights[x]):
                bins.sort()
                bins[0] += pweights[n]
                pwork += pweights[n]
            result = maxnode - pwork + max(bins)
        return maxnode / max(result, 1), result

    solution = sorted(
        [int(c) for c in tree.children[tree.root, : tree.n_child[tree.root]]
         if pweights[c] > 0], key=lambda n: pweights[n])
    best_solution = list(solution)
    best_speedup, _ = evaluate(solution)
    tendency: List[float] = []

    while solution:
        speedup, _ = evaluate(solution)
        tendency.append(speedup)
        if len(solution) >= workers and len(tendency) > window:
            balance = 0
            for i in range(len(tendency)):
                for j in range(i, len(tendency)):
                    balance += 1 if tendency[i] <= tendency[j] else -1
            tendency.pop(0)
            if balance < 0:
                break
        node = solution.pop()  # heaviest
        if tree.n_child[node] == 0:
            continue
        for k in range(tree.n_child[node]):
            ch = int(tree.children[node, k])
            if pweights[ch] > 0:
                lo = 0
                while lo < len(solution) and pweights[solution[lo]] < pweights[ch]:
                    lo += 1
                solution.insert(lo, ch)
        speedup, _ = evaluate(solution)
        if speedup > best_speedup:
            best_solution = list(solution)
            best_speedup = speedup

    # LPT assignment, round-robin flattened (ref :5689-5719)
    bins = [[] for _ in range(workers)]
    loads = [0] * workers
    for n in sorted(best_solution, key=lambda x: -pweights[x]):
        k = int(np.argmin(loads))
        bins[k].append(n)
        loads[k] += pweights[n]
    result = []
    level = 0
    while any(len(b) > level for b in bins):
        for b in bins:
            if len(b) > level:
                result.append(b[level])
        level += 1
    return result
