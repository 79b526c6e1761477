"""Huffman tree model: construction, code extraction, and the tree metrics
the reference harness uses to size lookup tables.

Metric semantics match reference framework/huffdata.c:224-278
(tableHeight, treeSize, tableNumGroups, telescoped, tableMinDepth), but the
implementations here are iterative (no recursion-depth limit) and operate on
the flat ``(nodes, 3) int32`` array ``[sym, izero, ione]`` with row 0 as the
root and leaves marked by ``izero == ione == -1``.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

LEAF = -1
MAX_CODE_LEN = 31  # window/LUT math uses int32 bit windows


def _is_leaf(tree: np.ndarray, node: int) -> bool:
    return tree[node, 1] == LEAF


def _depths(tree: np.ndarray, root: int = 0) -> np.ndarray:
    """Depth of every node reachable from root; -1 for unreachable."""
    n = tree.shape[0]
    depth = np.full(n, -1, dtype=np.int64)
    stack = [(root, 0)]
    while stack:
        node, d = stack.pop()
        depth[node] = d
        if tree[node, 1] != LEAF:
            stack.append((int(tree[node, 1]), d + 1))
            stack.append((int(tree[node, 2]), d + 1))
    return depth


def table_height(tree: np.ndarray, root: int = 0) -> int:
    """Max code length (huffdata.c:224-230)."""
    d = _depths(tree, root)
    leaves = tree[:, 1] == LEAF
    return int(d[leaves & (d >= 0)].max(initial=0))


def table_min_depth(tree: np.ndarray, root: int = 0) -> int:
    """Min code length (huffdata.c:272-278)."""
    d = _depths(tree, root)
    leaves = tree[:, 1] == LEAF
    sel = d[leaves & (d >= 0)]
    return int(sel.min()) if sel.size else 0


def tree_size(tree: np.ndarray, root: int = 0) -> int:
    """Number of nodes in the subtree (huffdata.c:232-238)."""
    return int((_depths(tree, root) >= 0).sum())


def table_num_groups(tree: np.ndarray, bits: int, root: int = 0) -> int:
    """Number of k-bit jump tables a DFA decomposition needs: one per internal
    node sitting at a depth that is a multiple of ``bits`` (plus the root) —
    semantics of tableNumGroupsToGo (huffdata.c:242-256)."""
    count = 1
    stack = [(root, bits)]
    while stack:
        node, down = stack.pop()
        if tree[node, 1] == LEAF:
            continue
        if down == 0:
            count += 1
            stack.append((node, bits))
        else:
            stack.append((int(tree[node, 1]), down - 1))
            stack.append((int(tree[node, 2]), down - 1))
    return count


def telescoped(tree: np.ndarray, bits: int, root: int = 0) -> int:
    """Number of internal nodes strictly above depth ``bits``, excluding the
    root (huffdata.c:258-269) — sizes 'telescoped' partial-depth roots."""
    count = 0
    stack = [(root, bits)]
    while stack:
        node, down = stack.pop()
        if down == 0 or tree[node, 1] == LEAF:
            continue
        count += 1
        stack.append((int(tree[node, 1]), down - 1))
        stack.append((int(tree[node, 2]), down - 1))
    return count - 1


def validate_tree(tree: np.ndarray, what: str = "tree") -> None:
    """Structural validation of a node array: child indices in range,
    leaves marked consistently, and no node reachable twice (cycles or
    DAG sharing would send the bit-at-a-time decoders into unbounded
    walks).  Raises ValueError on the first violation."""
    tree = np.asarray(tree)
    n = tree.shape[0]
    z, o = tree[:, 1], tree[:, 2]
    leaf = z == LEAF
    if np.any(leaf != (o == LEAF)):
        raise ValueError(f"{what}: node with exactly one LEAF child")
    internal = ~leaf
    kids = np.concatenate([z[internal], o[internal]])
    if kids.size and (kids.min() < 0 or kids.max() >= n):
        raise ValueError(f"{what}: child index out of range")
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    while stack:
        v = stack.pop()
        if seen[v]:
            raise ValueError(f"{what}: node {v} reachable twice (cycle/DAG)")
        seen[v] = True
        if tree[v, 1] != LEAF:
            stack.append(int(tree[v, 1]))
            stack.append(int(tree[v, 2]))


def tree_codes(tree: np.ndarray, root: int = 0):
    """Extract per-symbol codes.

    Returns ``(code, length, present)``: three arrays of size 256.
    ``code[s]`` holds symbol ``s``'s codeword as an int with bit ``k``
    (``1 << k``) equal to the k-th edge taken from the root (0 => izero).
    This LSB-first convention matches the stream bit order (huffdata.c:280-288:
    bit p is ``data[p/8] >> (p%8) & 1``), so packing codes LSB-first
    reproduces the on-disk bit stream directly.
    """
    code = np.zeros(256, dtype=np.uint32)
    length = np.zeros(256, dtype=np.int32)
    present = np.zeros(256, dtype=bool)
    stack = [(root, 0, 0)]
    while stack:
        node, prefix, depth = stack.pop()
        if tree[node, 1] == LEAF:
            sym = int(tree[node, 0]) & 0xFF
            if present[sym]:
                raise ValueError(f"symbol {sym} appears at two leaves")
            if depth > MAX_CODE_LEN:
                raise ValueError(f"code length {depth} exceeds {MAX_CODE_LEN}")
            code[sym] = prefix
            length[sym] = depth
            present[sym] = True
        else:
            stack.append((int(tree[node, 1]), prefix, depth + 1))
            stack.append((int(tree[node, 2]), prefix | (1 << depth), depth + 1))
    return code, length, present


def build_tree(freqs: np.ndarray) -> np.ndarray:
    """Build a Huffman tree over byte symbols from frequency counts and
    serialize it to the reference's node-array encoding (root at index 0,
    9-byte records on disk).  New capability — the reference ships no encoder.

    Ties are broken deterministically (lowest symbol / earliest-created node
    first) so encoding is reproducible.  A single-symbol input gets a depth-1
    tree (one real leaf + one padding leaf) because the format cannot express
    zero-bit codes — the decoder walk consumes at least one bit per symbol
    (mainrun.c:38-55).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    if freqs.shape != (256,):
        raise ValueError("freqs must have shape (256,)")
    syms = [int(s) for s in np.nonzero(freqs)[0]]
    if not syms:
        raise ValueError("cannot build a Huffman tree for empty input")
    if len(syms) == 1:
        pad = 0 if syms[0] != 0 else 1  # any symbol distinct from the real one
        syms = sorted([syms[0], pad])

    # Heap items: (freq, tiebreak, temp_id). Leaves get temp ids 0..k-1.
    children: dict[int, tuple[int, int]] = {}  # temp_id -> (zero_child, one_child)
    sym_of: dict[int, int] = {}
    heap = []
    for i, s in enumerate(syms):
        sym_of[i] = s
        heapq.heappush(heap, (int(freqs[s]), i, i))
    next_id = len(syms)
    while len(heap) > 1:
        f0, t0, a = heapq.heappop(heap)
        f1, t1, b = heapq.heappop(heap)
        children[next_id] = (a, b)
        heapq.heappush(heap, (f0 + f1, next_id, next_id))
        next_id += 1
    root_tmp = heap[0][2]

    # Serialize: root at index 0, remaining nodes in BFS order.
    order = []
    queue = [root_tmp]
    while queue:
        t = queue.pop(0)
        order.append(t)
        if t in children:
            queue.extend(children[t])
    index_of = {t: i for i, t in enumerate(order)}
    tree = np.empty((len(order), 3), dtype=np.int32)
    for t, i in index_of.items():
        if t in children:
            z, o = children[t]
            tree[i] = (0, index_of[z], index_of[o])
        else:
            tree[i] = (sym_of[t], LEAF, LEAF)
    return tree


@dataclasses.dataclass
class HuffTree:
    """Convenience wrapper bundling the node array with derived metrics/codes."""

    tree: np.ndarray

    @classmethod
    def from_frequencies(cls, freqs: np.ndarray) -> "HuffTree":
        return cls(build_tree(freqs))

    @classmethod
    def from_bytes(cls, data: np.ndarray) -> "HuffTree":
        data = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else data
        return cls.from_frequencies(np.bincount(data.ravel(), minlength=256))

    @property
    def nodes(self) -> int:
        return int(self.tree.shape[0])

    @property
    def height(self) -> int:
        return table_height(self.tree)

    @property
    def min_depth(self) -> int:
        return table_min_depth(self.tree)

    @property
    def size(self) -> int:
        return tree_size(self.tree)

    def num_groups(self, bits: int) -> int:
        return table_num_groups(self.tree, bits)

    def telescoped(self, bits: int) -> int:
        return telescoped(self.tree, bits)

    def codes(self):
        return tree_codes(self.tree)

    def format_codes(self) -> str:
        """Human-readable code list (MSB-first display like listHuffCodes,
        huffdata.c:133-146)."""
        code, length, present = self.codes()
        lines = []
        for s in range(256):
            if present[s]:
                bits = "".join(
                    "1" if (int(code[s]) >> k) & 1 else "0" for k in range(int(length[s]))
                )
                ch = chr(s) if 32 <= s < 127 else f"\\x{s:02x}"
                lines.append(f"{bits} '{ch}'")
        return "\n".join(lines)

    def format_table(self) -> str:
        """Node-array dump (showHuffTable, huffdata.c:291-300)."""
        lines = []
        for i in range(self.nodes):
            sym, z, o = (int(v) for v in self.tree[i])
            if z == LEAF:
                ch = chr(sym) if 32 <= sym < 127 else f"\\x{sym:02x}"
                lines.append(f"{i}   '{ch}'")
            else:
                lines.append(f"{i}   {z}   {o}")
        return "\n".join(lines)
