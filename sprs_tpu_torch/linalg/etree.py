"""Elimination tree utilities, the counterpart of
``sprs_tpu/linalg/etree.py``.

The etree of an SPD matrix pattern drives the symbolic phase of LDLᵀ:
``parent[k]`` is the first row above k whose L column touches column k.
Host-side numpy (symbolic analysis is sequential pointer chasing); the
port's native library is the fast path where it is built, with the same
results.
"""

from __future__ import annotations

import numpy as np

NO_PARENT = -1


def etree_from_pattern(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Compute the elimination tree of a symmetric matrix pattern.

    Uses the classic Liu algorithm with path-compression ancestors (the
    reference folds this into ldl_symbolic, sprs-ldl/src/lib.rs:471-488;
    standalone here so orderings/tests can use it directly).
    Only the upper-triangle pattern of each row k (entries < k of row k in
    CSR upper form — equivalently we walk entries j < k) matters.
    """
    from .. import native

    fast = native.etree(indptr, indices, n)
    if fast is not None:
        return fast.astype(np.int64)
    parent = np.full(n, NO_PARENT, dtype=np.int64)
    ancestor = np.full(n, NO_PARENT, dtype=np.int64)
    for k in range(n):
        for p in range(indptr[k], indptr[k + 1]):
            j = indices[p]
            if j >= k:
                continue
            # walk from j up to the root, compressing to k
            while True:
                a = ancestor[j]
                ancestor[j] = k
                if a == NO_PARENT:
                    if parent[j] == NO_PARENT and j != k:
                        parent[j] = k
                    break
                if a == k:
                    break
                j = a
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder traversal of an elimination forest (new -> old)."""
    from .. import native

    n = parent.shape[0]
    fast = native.etree_postorder(np.asarray(parent, np.int32), n)
    if fast is not None:
        return fast.astype(np.int64)
    children: list = [[] for _ in range(n)]
    roots = []
    for v in range(n):
        p = parent[v]
        if p == NO_PARENT:
            roots.append(v)
        else:
            children[p].append(v)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    for r in roots:
        stack = [(r, 0)]
        while stack:
            node, ci = stack.pop()
            if ci < len(children[node]):
                stack.append((node, ci + 1))
                stack.append((children[node][ci], 0))
            else:
                out[pos] = node
                pos += 1
    return out


def tree_levels(parent: np.ndarray) -> np.ndarray:
    """Height of each node above its deepest descendant leaf.

    All of a node's etree children can be eliminated before it, so
    nodes of equal height are an (over-conservative but valid) parallel
    level for factorization scheduling.  parent[k] > k always holds
    (elimination order), so one ascending sweep suffices.
    """
    n = parent.shape[0]
    level = np.zeros(n, dtype=np.int64)
    for k in range(n):
        p = parent[k]
        if p != NO_PARENT:
            level[p] = max(level[p], level[k] + 1)
    return level
