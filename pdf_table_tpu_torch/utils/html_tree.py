"""HTML element trees from the standard library's ``html.parser``, for
the parts of lxml that the table tools read (``lxml.html.fromstring``,
``.//td``, ``./td|./th``, ``get``, ``itertext``): the JAX package parses
table HTML with lxml, which the card's host does not have.

The tree follows libxml2's HTML parser where table HTML needs it: a
``<td>`` or ``<th>`` closes an open cell, a ``<tr>`` an open row, a
``<thead>`` / ``<tbody>`` / ``<tfoot>`` an open section, a block element
an open ``<p>``; an end tag closes the elements opened after its match
and is ignored without one; void elements take no children; character
references are decoded. :func:`fromstring` returns what
``lxml.html.fromstring`` returns: the ``html`` element of a whole
document, the one element of a fragment that is one element, else a
``div`` holding the fragment. Held to lxml by tests/test_torch_aux_tasks.py
on the golden pages and the port's table HTML.
"""

from __future__ import annotations

import re
from html.parser import HTMLParser
from typing import Dict, Iterator, List, Optional

VOID = frozenset(("area", "base", "br", "col", "embed", "hr", "img",
                  "input", "link", "meta", "param", "source", "track",
                  "wbr", "basefont", "frame", "isindex"))
_CELL_CLOSES = frozenset(("td", "th", "p"))
_SECTION = frozenset(("thead", "tbody", "tfoot"))
_BLOCK = frozenset(("address", "blockquote", "center", "dir", "div", "dl",
                    "fieldset", "form", "h1", "h2", "h3", "h4", "h5", "h6",
                    "hr", "menu", "ol", "p", "pre", "table", "ul"))
# the open element each start tag closes while it is the current one
_START_CLOSES = {
    "td": _CELL_CLOSES, "th": _CELL_CLOSES,
    "tr": _CELL_CLOSES | {"tr"},
    **{s: _CELL_CLOSES | {"tr"} | _SECTION for s in _SECTION},
    **{b: frozenset(("p",)) for b in _BLOCK},
}
_FULL_DOC = re.compile(r"^\s*<(?:html|!doctype)", re.I)


class ParserError(ValueError):
    """The document holds nothing (lxml's ``ParserError``)."""


class Element:
    __slots__ = ("tag", "attrs", "children", "text", "tail")

    def __init__(self, tag: str, attrs: Optional[Dict[str, str]] = None):
        self.tag = tag
        self.attrs = attrs or {}
        self.children: List["Element"] = []
        self.text = ""
        self.tail = ""

    def get(self, name: str, default=None):
        return self.attrs.get(name, default)

    def iter_tags(self, *tags: str) -> Iterator["Element"]:
        """Descendants (not the element itself) whose tag is one of
        ``tags``, in document order (``.//td|.//th``)."""
        for c in self.children:
            if c.tag in tags:
                yield c
            yield from c.iter_tags(*tags)

    def child_tags(self, *tags: str) -> List["Element"]:
        """Children whose tag is one of ``tags`` (``./td|./th``)."""
        return [c for c in self.children if c.tag in tags]

    def itertext(self) -> Iterator[str]:
        if self.text:
            yield self.text
        for c in self.children:
            yield from c.itertext()
            if c.tail:
                yield c.tail


class _TreeBuilder(HTMLParser):
    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.root = Element("div")
        self.stack: List[Element] = [self.root]

    def _append_text(self, data: str) -> None:
        top = self.stack[-1]
        if top.children:
            top.children[-1].tail += data
        else:
            top.text += data

    def handle_starttag(self, tag, attrs):
        closes = _START_CLOSES.get(tag)
        while closes and len(self.stack) > 1 and self.stack[-1].tag in closes:
            self.stack.pop()
        el = Element(tag, {k: ("" if v is None else v) for k, v in attrs})
        self.stack[-1].children.append(el)
        if tag not in VOID:
            self.stack.append(el)

    def handle_endtag(self, tag):
        for i in range(len(self.stack) - 1, 0, -1):
            if self.stack[i].tag == tag:
                del self.stack[i:]
                return

    def handle_data(self, data):
        self._append_text(data)


def fromstring(html: str) -> Element:
    """The element ``lxml.html.fromstring(html)`` returns (module
    docstring); raises :class:`ParserError` on a document with nothing
    in it."""
    if not html or not html.strip():
        raise ParserError("Document is empty")
    b = _TreeBuilder()
    b.feed(html)
    b.close()
    root = b.root
    if _FULL_DOC.match(html):
        for c in root.children:
            if c.tag == "html":
                return c
        return root
    text = root.text + "".join(c.tail for c in root.children)
    if len(root.children) == 1 and not text.strip():
        return root.children[0]
    return root
