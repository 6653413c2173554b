"""TEDS, tree-edit-distance similarity of table HTML (counterpart of
pdf_table_tpu/eval/teds.py): a Zhang-Shasha ordered tree edit distance
with TEDS's costs (insert and delete 1; rename 1 across tags, 0 between
equal non-cell tags; between two cells 1 where their spans differ, else 0
structure only, else the normalized Levenshtein distance of their texts);
TEDS = 1 - distance / max(|T_pred|, |T_gt|).

The Levenshtein distance is computed here, exactly: the JAX package calls
``python-Levenshtein`` and, where it is missing, scores a rename as the
longer text's length, which is no edit distance. The port's TEDS equals
JAX's with the package installed. The HTML is parsed by the port's own
parser (``utils/html_tree.py``), which builds lxml's tree, not by lxml."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence


class _Node:
    __slots__ = ("tag", "colspan", "rowspan", "text", "children")

    def __init__(self, tag: str, colspan: int = 1, rowspan: int = 1,
                 text: str = ""):
        self.tag = tag
        self.colspan = colspan
        self.rowspan = rowspan
        self.text = text
        self.children: List["_Node"] = []


def _build_tree(elem, structure_only: bool) -> _Node:
    tag = elem.tag.lower()  # as JAX's: the parser folds ASCII only
    colspan = int(elem.get("colspan", 1) or 1)
    rowspan = int(elem.get("rowspan", 1) or 1)
    text = ""
    if tag == "td" and not structure_only:
        text = "".join(elem.itertext()).strip()
    node = _Node(tag, colspan, rowspan, text)
    if tag != "td":
        for child in elem.children:
            node.children.append(_build_tree(child, structure_only))
    return node


def html_to_tree(html: str, structure_only: bool = False) -> Optional[_Node]:
    from ..utils.html_tree import ParserError, fromstring

    try:
        doc = fromstring(html)
    except ParserError:
        return None
    tables = list(doc.iter_tags("table"))
    root = tables[0] if tables else (doc if doc.tag == "table" else None)
    if root is None:
        return None
    return _build_tree(root, structure_only)


def levenshtein(a: str, b: str) -> int:
    """The edit distance of two strings (insert, delete, substitute 1)."""
    if a == b:
        return 0
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _tree_size(node: Optional[_Node]) -> int:
    if node is None:
        return 0
    return 1 + sum(_tree_size(c) for c in node.children)


def _postorder(root: _Node):
    """Zhang-Shasha data: postorder nodes, leftmost-leaf indices, keyroots."""
    nodes: List[_Node] = []
    lmld: List[int] = []

    def walk(n: _Node) -> int:
        if not n.children:
            nodes.append(n)
            lmld.append(len(nodes) - 1)
            return len(nodes) - 1
        first = None
        for c in n.children:
            li = walk(c)
            if first is None:
                first = li
        nodes.append(n)
        lmld.append(first)
        return first

    walk(root)
    keyroots = [i for i in range(len(nodes))
                if not any(lmld[j] == lmld[i] for j in range(i + 1,
                                                            len(nodes)))]
    return nodes, lmld, keyroots


def _rename_cost(a: _Node, b: _Node, structure_only: bool) -> float:
    if a.tag != b.tag:
        return 1.0
    if a.tag == "td":
        if a.colspan != b.colspan or a.rowspan != b.rowspan:
            return 1.0
        if structure_only:
            return 0.0
        if a.text == b.text:
            return 0.0
        dist = levenshtein(a.text, b.text)
        denom = max(len(a.text), len(b.text), 1)
        return dist / denom
    return 0.0


def tree_edit_distance(t1: _Node, t2: _Node,
                       structure_only: bool = False) -> float:
    """Zhang-Shasha ordered tree edit distance with TEDS costs."""
    n1, l1, k1 = _postorder(t1)
    n2, l2, k2 = _postorder(t2)
    import numpy as np

    td = np.zeros((len(n1), len(n2)))

    def treedist(i: int, j: int) -> None:
        li, lj = l1[i], l2[j]
        m, n = i - li + 2, j - lj + 2
        fd = np.zeros((m, n))
        for x in range(1, m):
            fd[x, 0] = fd[x - 1, 0] + 1
        for y in range(1, n):
            fd[0, y] = fd[0, y - 1] + 1
        for x in range(1, m):
            for y in range(1, n):
                ai, bj = li + x - 1, lj + y - 1
                if l1[ai] == li and l2[bj] == lj:
                    cost = _rename_cost(n1[ai], n2[bj], structure_only)
                    fd[x, y] = min(fd[x - 1, y] + 1, fd[x, y - 1] + 1,
                                   fd[x - 1, y - 1] + cost)
                    td[ai, bj] = fd[x, y]
                else:
                    p, q = l1[ai] - li, l2[bj] - lj
                    fd[x, y] = min(fd[x - 1, y] + 1, fd[x, y - 1] + 1,
                                   fd[p, q] + td[ai, bj])

    for i in k1:
        for j in k2:
            treedist(i, j)
    return float(td[-1, -1])


class TEDS:
    """Batchable TEDS scorer (reference TEDS, table_metric.py:93)."""

    def __init__(self, structure_only: bool = False, n_jobs: int = 1):
        self.structure_only = structure_only
        self.n_jobs = n_jobs

    def evaluate(self, pred_html: str, gt_html: str) -> float:
        t_pred = html_to_tree(pred_html, self.structure_only)
        t_gt = html_to_tree(gt_html, self.structure_only)
        if t_gt is None:
            return 0.0
        if t_pred is None:
            return 0.0
        dist = tree_edit_distance(t_pred, t_gt, self.structure_only)
        denom = max(_tree_size(t_pred), _tree_size(t_gt), 1)
        return max(0.0, 1.0 - dist / denom)

    def batch_evaluate(self, preds: Sequence[str],
                       gts: Sequence[str]) -> List[float]:
        if self.n_jobs <= 1:
            return [self.evaluate(p, g) for p, g in zip(preds, gts)]
        with ThreadPoolExecutor(max_workers=self.n_jobs) as pool:
            return list(pool.map(self.evaluate, preds, gts))
