"""Nested-dict helpers: the port's params, optimizer states and growth
operators are plain dicts of tensors, walked here the way the reference
package walks its pytrees (dotted path strings, leaves in sorted order).
A ``None`` is an empty subtree, as in the reference's pytrees: it holds no
leaf, and ``tree_map`` keeps it as it is."""
from __future__ import annotations


def tree_flatten_with_paths(tree, prefix=""):
    """[(dotted path, leaf)] for every leaf (neither a dict nor ``None``),
    sorted by path string (the order the reference package's flatten gives
    a tree of dicts)."""
    out = []
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.extend(tree_flatten_with_paths(val, path + "."))
        elif val is not None:
            out.append((path, val))
    return sorted(out, key=lambda t: t[0])


def tree_leaves(tree):
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_param_count(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_size_bytes(tree) -> int:
    """Total bytes across all leaves (honours per-leaf dtype)."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return None if tree is None else fn(tree, *rest)


def get_path(tree, path):
    node = tree
    for part in path.split("."):
        node = node[int(part) if part.isdigit() else part]
    return node


def set_path(tree, path, val):
    """Set ``tree[a][b]...[z] = val`` for path "a.b...z", creating
    intermediate dicts."""
    parts = path.split(".")
    node = tree
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = val
