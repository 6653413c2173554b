"""HTML element trees as ``lxml.html.fromstring`` builds them, for the
parts of lxml that the table tools read (``.//td``, ``./td|./th``,
``get``, ``itertext``): the JAX package parses table HTML with lxml, which
the card's host does not have.

What it follows is lxml 6.1.1 over libxml2 2.14.6, whose HTML parser
tokenizes as HTML5 does and builds its tree by libxml2's own older rules:

* the input: a leading byte-order mark is skipped, CR and CRLF become LF,
  NUL becomes U+FFFD, and the parse ends at a lone surrogate (lxml cannot
  encode one);
* the tokenizer (HTML5's): tag and attribute names end at whitespace,
  ``/`` or ``>`` and are lowercased; the first of a duplicate attribute
  wins, and HTML 4's boolean attributes without a value take their name
  as value; character references follow HTML5 (the named table of
  ``html.entities.html5``, the Windows-1252 remap of ``&#128;``-``&#159;``,
  no decoding in an attribute of a name without ``;`` before ``=`` or an
  alphanumeric); ``<!-->``, ``<!x>``, ``<?x>`` and ``</3>`` are comments;
  the content of ``script`` (with its escapes), ``style``, ``xmp``,
  ``iframe``, ``noembed``, ``noframes`` and ``plaintext`` is raw text,
  that of ``title`` and ``textarea`` text with references decoded; a tag
  cut off by the end of the input is dropped;
* the tree (libxml2's): a start tag first closes the current element while
  :data:`_START_CLOSES` pairs them, then implies ``html``, ``head`` or
  ``body``; a second ``html``, a ``head`` below the top level and a
  nested ``body`` are dropped, as are their end tags; ``<x/>`` closes the
  element it opens (or, for a dropped tag, the current one); HTML 4's
  empty elements (:data:`_EMPTY`) take no content; an end tag closes the
  elements opened after its match unless one of them has a higher
  :data:`_END_PRIORITY`, and is ignored without a match; text that is not
  whitespace implies ``body``, closing an open ``head``, while whitespace
  stays in ``html`` or ``head``; once the ``html`` element is closed, the
  rest of the input builds nothing that lxml shows, and the parse halts
  at an element that would open 257 deep;
* the root (lxml.html's ``fromstring``): the ``html`` element of an input
  that starts with ``<html`` or ``<!doctype``, or of a document with a
  ``head``; else the one element of a body that holds one element and no
  other text; else the body, renamed ``div`` where it holds a block
  element and ``span`` where it does not.

Comments build no element: their tails join the text around them, as
``itertext`` reads it. :func:`fromstring` raises :class:`ParserError`
where lxml raises ``ParserError`` (a document with no element) and
``ValueError`` where lxml refuses a string with an XML encoding
declaration.

No libxml2 source was at hand, so the tables were found by probing lxml:
tests/test_torch_html_tree.py rebuilds :data:`_START_CLOSES` from lxml in
five contexts (a cell, a row, a section, a table, the body) and holds the
tree to lxml's on the rows it was probed with and on a seeded fuzz of
table tag soup.
"""

from __future__ import annotations

import re
from html.entities import html5 as _NAMED_REFS
from typing import Dict, Iterator, List, Optional, Tuple

# HTML 4's empty elements: a start tag closes them at once
_EMPTY = frozenset(("area", "base", "basefont", "br", "col", "frame", "hr",
                    "img", "input", "isindex", "link", "meta", "param"))
# content modes after a start tag
_DATA, _RCDATA, _RAWTEXT, _SCRIPT, _PLAINTEXT = range(5)
_MODES = {"title": _RCDATA, "textarea": _RCDATA, "style": _RAWTEXT,
          "xmp": _RAWTEXT, "iframe": _RAWTEXT, "noembed": _RAWTEXT,
          "noframes": _RAWTEXT, "script": _SCRIPT, "plaintext": _PLAINTEXT}
# the open element (key) that each start tag of the value closes while the
# element is the current one: libxml2's start-close pairs, found by
# probing lxml 6.1.1 / libxml2 2.14.6 with every ordered pair of the HTML
# 4 and HTML5 element names and one unknown name (``<A><B>``: B's element
# not inside A's), the same in a cell, a row, a section, a table and the
# body; ``head``'s row from ``<head><B>``
_START_CLOSES: Dict[str, frozenset] = {k: frozenset(v.split()) for k, v in {
    "a": "a fieldset table td th",
    "address": "dd dl dt form li ul",
    "b": "center p td th",
    "big": "p",
    "caption": "col colgroup tbody tfoot thead tr",
    "colgroup": "colgroup tbody tfoot thead tr",
    "dd": "dt",
    "dir": "dd dl dt form ul",
    "dl": "form li",
    "dt": "dd dl",
    "font": "center td th",
    "form": "form",
    "h1": "fieldset form li p table",
    "h2": "fieldset form li p table",
    "h3": "fieldset form li p table",
    "h4": "fieldset form li p table",
    "h5": "fieldset form li p table",
    "h6": "fieldset form li p table",
    "head": ("a abbr acronym address b bdo big blockquote body br center "
             "cite code dd dfn dir div dl dt em fieldset font form "
             "frameset h1 h2 h3 h4 h5 h6 hr i iframe img kbd li listing "
             "map menu ol p pre q s samp small span strike strong sub sup "
             "table tt u ul var xmp"),
    "i": "center p td th",
    "legend": "fieldset",
    "li": "li",
    "listing": "dd dl dt fieldset form li table ul",
    "menu": "dd dl dt form ul",
    "ol": "form",
    "option": "optgroup option",
    "p": ("address blockquote body caption center col colgroup dd dir "
          "div dl dt fieldset form frameset h1 h2 h3 h4 h5 h6 head hr "
          "li listing menu ol p pre table tbody td tfoot th title tr ul "
          "xmp"),
    "pre": "dd dl dt fieldset form li table ul",
    "s": "p",
    "small": "p",
    "span": "td th",
    "strike": "p",
    "tbody": "tbody tfoot",
    "td": "tbody td tfoot th tr",
    "tfoot": "tbody",
    "th": "tbody td tfoot th tr",
    "thead": "tbody tfoot",
    "tr": "tbody tfoot tr",
    "tt": "p",
    "u": "p td th",
    "ul": "address form menu pre",
}.items()}
# an end tag closes no open element of a higher priority (others: 100)
_END_PRIORITY = {"div": 150, "td": 160, "th": 160, "tr": 170, "thead": 180,
                 "tbody": 180, "tfoot": 180, "table": 190, "head": 200,
                 "body": 200, "html": 220}
_HEAD_TAGS = frozenset(("script", "style", "meta", "link", "title", "base"))
_BOOLEAN_ATTRS = frozenset((
    "checked", "compact", "declare", "defer", "disabled", "ismap",
    "multiple", "nohref", "noresize", "noshade", "nowrap", "readonly",
    "selected"))
# lxml.html.defs.block_tags: a body holding one of these becomes a div
_BLOCK_TAGS = frozenset((
    "address", "blockquote", "caption", "center", "col", "colgroup", "dd",
    "del", "dir", "div", "dl", "dt", "fieldset", "form", "h1", "h2", "h3",
    "h4", "h5", "h6", "hr", "ins", "isindex", "legend", "li", "menu",
    "noscript", "ol", "optgroup", "option", "p", "pre", "table", "tbody",
    "td", "tfoot", "th", "thead", "tr", "ul"))
# HTML5's numeric references to C1 controls
_WINDOWS_1252 = {
    0x80: 0x20AC, 0x82: 0x201A, 0x83: 0x0192, 0x84: 0x201E, 0x85: 0x2026,
    0x86: 0x2020, 0x87: 0x2021, 0x88: 0x02C6, 0x89: 0x2030, 0x8A: 0x0160,
    0x8B: 0x2039, 0x8C: 0x0152, 0x8E: 0x017D, 0x91: 0x2018, 0x92: 0x2019,
    0x93: 0x201C, 0x94: 0x201D, 0x95: 0x2022, 0x96: 0x2013, 0x97: 0x2014,
    0x98: 0x02DC, 0x99: 0x2122, 0x9A: 0x0161, 0x9B: 0x203A, 0x9C: 0x0153,
    0x9E: 0x017E, 0x9F: 0x0178}
_REF_MAX = max(map(len, _NAMED_REFS))
_MAX_DEPTH = 256  # open elements; libxml2 halts at one more
_COMMENT = "#comment"

_WS = "\t\n\x0c\r "  # a CR here comes from a reference
_TAG_NAME = re.compile(r"[^\t\n\x0c />]*")
_ATTR_NAME = re.compile(r"[^\t\n\x0c />=]*")
_UNQUOTED = re.compile(r"[^\t\n\x0c >]*")
_SPACES = re.compile(r"[\t\n\x0c ]*")
_ALNUM = re.compile(r"[0-9A-Za-z]")
_DEC = re.compile(r"[0-9]+")
_HEX = re.compile(r"[0-9A-Fa-f]+")
_NOT_XML = re.compile("[\x00-\x08\x0b\x0c\x0e-\x1f\ufffe\uffff]")
_DOCTYPE = re.compile(r"doctype", re.I | re.A)
_SURROGATE = re.compile(r"[\ud800-\udfff]")
_FULL_DOC = re.compile(r"^\s*<(?:html|!doctype)", re.I)
# lxml refuses a str that declares its encoding
_XML_ENCODING = re.compile(
    r"^(<\?xml[^>]+)\s+encoding\s*=\s*[\"'][^\"']*[\"'](\s*\?>|)", re.U)


class ParserError(ValueError):
    """The document holds no element (lxml's ``ParserError``)."""


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


_LOWER = {c: c + 32 for c in range(ord("A"), ord("Z") + 1)}


def _name(raw: str) -> str:
    """A tag or attribute name as libxml2 keeps it: ASCII lowercase, and
    at most 100 bytes of UTF-8, skipping a character that does not fit."""
    name = raw.translate(_LOWER)
    if name.isascii():
        return name[:100]
    out, size = [], 0
    for c in name:
        k = len(c.encode())
        if size + k <= 100:
            out.append(c)
            size += k
    return "".join(out)


def _is_letter(c: str) -> bool:
    return c.isascii() and c.isalpha()


def _numeric_ref(s: str, i: int) -> Tuple[Optional[str], int]:
    """The reference ``&#...`` at ``s[i]`` as (text, end), or (None, i)."""
    j = i + 2
    hexa = j < len(s) and s[j] in "xX"
    m = (_HEX if hexa else _DEC).match(s, j + hexa)
    if m is None:
        return None, i
    digits = m.group().lstrip("0")
    code = int(digits or "0", 16 if hexa else 10) if len(digits) < 9 else -1
    end = m.end() + (m.end() < len(s) and s[m.end()] == ";")
    if code <= 0 or code > 0x10FFFF or 0xD800 <= code <= 0xDFFF:
        return "\ufffd", end
    return chr(_WINDOWS_1252.get(code, code)), end


def _decode(s: str, attr: bool) -> str:
    """``s`` with HTML5's character references decoded (in an attribute
    value where ``attr``)."""
    i = s.find("&")
    if i < 0:
        return s
    out, start = [], 0
    while i >= 0:
        text, end = None, i
        if i + 1 < len(s) and s[i + 1] == "#":
            text, end = _numeric_ref(s, i)
        elif i + 1 < len(s) and _ALNUM.match(s, i + 1):
            for n in range(min(_REF_MAX, len(s) - i - 1), 0, -1):
                name = s[i + 1:i + 1 + n]
                if name in _NAMED_REFS:
                    end = i + 1 + n
                    if (attr and name[-1] != ";" and end < len(s)
                            and (s[end] == "=" or _ALNUM.match(s, end))):
                        end = i
                    else:
                        text = _NAMED_REFS[name]
                    break
        if text is None:
            i = s.find("&", i + 1)
            continue
        out.append(s[start:i])
        out.append(text)
        start = end
        i = s.find("&", end)
    out.append(s[start:])
    return "".join(out)


class _Parser:
    """libxml2's HTML parser over one string (module docstring)."""

    def __init__(self, s: str):
        self.s = s
        self.pos = 0
        self.mode = _DATA
        self.stack: List[Element] = []
        self.root: Optional[Element] = None
        self.seen = 0  # 3 once a head was opened, 10 once a body was
        self.depth = 0  # dropped html/head/body tags whose end tags drop
        self.done = False

    # -- the tree ---------------------------------------------------------

    def _push(self, tag: str, attrs: Dict[str, str]) -> None:
        if len(self.stack) >= _MAX_DEPTH:
            self.done = True  # libxml2 halts the parse
            return
        el = Element(tag, attrs)
        if self.stack:
            self.stack[-1].children.append(el)
        else:
            self.root = el
        self.stack.append(el)
        if tag == "head":
            self.seen = max(self.seen, 3)
        elif tag == "body":
            self.seen = 10

    def _pop(self) -> None:
        self.stack.pop()
        # what a closed html element is followed by goes to a second
        # root element, which lxml does not show
        self.done = not self.stack

    def _append(self, text: str) -> None:
        top = self.stack[-1]
        if top.children:
            top.children[-1].tail += text
        else:
            top.text += text

    def _auto_close(self, tag: str) -> None:
        while self.stack and tag in _START_CLOSES.get(self.stack[-1].tag, ()):
            self._pop()

    def _check_implied(self, tag: str) -> None:
        if tag == "html":
            return
        if not self.stack:
            self._push("html", {})
        if tag in ("body", "head"):
            return
        if len(self.stack) <= 1 and tag in _HEAD_TAGS:
            if self.seen < 3:
                self._push("head", {})
        elif tag not in ("noframes", "frame", "frameset"):
            if self.seen < 10 and not any(e.tag in ("body", "head")
                                          for e in self.stack):
                self._push("body", {})

    def _chars(self, text: str) -> None:
        if not text:
            return
        top = self.stack[-1] if self.stack else None
        if top is None or top.tag in ("html", "head"):
            rest = text.lstrip(_WS)
            if top is not None and len(rest) < len(text):
                self._append(text[:len(text) - len(rest)])
            if not rest:
                return
            text = rest
            self._start_char_data()
            if self.done:
                return
        self._append(text)

    def _start_char_data(self) -> None:
        if self.stack and self.stack[-1].tag == "head":
            self._auto_close("p")
        self._check_implied("p")

    def _comment(self) -> None:
        if self.stack:
            self.stack[-1].children.append(Element(_COMMENT))

    def _start_tag(self, name: str, attrs, self_closing: bool) -> None:
        discard = False
        if self.stack and name == "html":
            discard = True
        elif len(self.stack) != 1 and name == "head":
            discard = True
        elif name == "body":
            discard = any(e.tag == "body" for e in self.stack)
        if discard:
            self.depth += 1
        elif attrs is not None:
            self._push(name, attrs)
        if attrs is None or self.done or not self.stack:
            return
        top = self.stack[-1].tag
        if self_closing or top in _EMPTY:
            self._pop()
        else:
            self.mode = _MODES.get(top, _DATA)

    def _end_tag(self, name: str) -> None:
        if self.depth > 0 and name in ("html", "body", "head"):
            self.depth -= 1
            return
        prio = _END_PRIORITY.get(name, 100)
        for i in range(len(self.stack) - 1, -1, -1):
            if self.stack[i].tag == name:
                break
            if _END_PRIORITY.get(self.stack[i].tag, 100) > prio:
                return
        else:
            return
        while len(self.stack) > i:
            self._pop()

    # -- the tokenizer ----------------------------------------------------

    def _attributes(self, pos: int):
        """The attributes from ``pos`` to the tag's end as (attrs,
        self-closing, end); attrs is None where the input ends first."""
        s, n = self.s, len(self.s)
        attrs: Dict[str, str] = {}
        if pos < n and s[pos] == ">":
            return attrs, False, pos + 1
        while True:
            pos = _SPACES.match(s, pos).end()
            if pos >= n:
                return None, False, n
            c = s[pos]
            if c == ">":
                return attrs, False, pos + 1
            if c == "/":
                if pos + 1 < n and s[pos + 1] == ">":
                    return attrs, True, pos + 2
                pos += 1
                continue
            end = _ATTR_NAME.match(s, pos + 1).end()
            name = _name(s[pos:end])
            pos = _SPACES.match(s, end).end()
            value = None
            if pos < n and s[pos] == "=":
                pos = _SPACES.match(s, pos + 1).end()
                if pos >= n:
                    return None, False, n
                q = s[pos]
                if q in "\"'":
                    end = s.find(q, pos + 1)
                    if end < 0:
                        return None, False, n
                    value, pos = s[pos + 1:end], end + 1
                else:
                    end = _UNQUOTED.match(s, pos).end()
                    value, pos = s[pos:end], end
                value = _decode(value, attr=True)
            elif name in _BOOLEAN_ATTRS:
                value = name
            if name not in attrs:
                attrs[name] = value or ""

    def _tag(self) -> None:
        """The start tag at ``pos`` (``<`` and an ASCII letter)."""
        s = self.s
        end = _TAG_NAME.match(s, self.pos + 1).end()
        name = _name(s[self.pos + 1:end])
        self._auto_close(name)
        self._check_implied(name)
        attrs, self_closing, self.pos = self._attributes(end)
        self._start_tag(name, attrs, self_closing)

    def _end(self) -> None:
        """The markup at ``pos`` that starts ``</``."""
        s, n, pos = self.s, len(self.s), self.pos
        if pos + 2 >= n:
            self._start_char_data()
            if not self.done:
                self._append("</")
            self.pos = n
        elif s[pos + 2] == ">":
            self.pos = pos + 3
        elif not _is_letter(s[pos + 2]):
            self._bogus_comment(pos + 2)
        else:
            end = _TAG_NAME.match(s, pos + 2).end()
            attrs, _, self.pos = self._attributes(end)
            if attrs is not None:
                self._end_tag(_name(s[pos + 2:end]))

    def _bogus_comment(self, pos: int) -> None:
        end = self.s.find(">", pos)
        self.pos = len(self.s) if end < 0 else end + 1
        self._comment()

    def _markup(self) -> None:
        """The markup at ``pos`` that starts ``<!``."""
        s, pos = self.s, self.pos
        if s.startswith("--", pos + 2):
            pos += 4
            if s.startswith(">", pos):
                end = pos + 1
            elif s.startswith("->", pos):
                end = pos + 2
            else:
                ends = [e + k for e, k in ((s.find("-->", pos), 3),
                                           (s.find("--!>", pos), 4))
                        if e >= 0]
                end = min(ends) if ends else len(s)
            self.pos = end
            self._comment()
        elif _DOCTYPE.match(s, pos + 2):
            end = s.find(">", pos + 9)
            self.pos = len(s) if end < 0 else end + 1
        else:
            self._bogus_comment(pos + 2)

    def _raw_end(self, pos: int) -> int:
        """Where the raw content from ``pos`` ends: at the current
        element's end tag, or the end of the input."""
        s, n = self.s, len(self.s)
        if self.mode == _PLAINTEXT:
            return n
        tag = self.stack[-1].tag
        close = re.compile(r"</" + re.escape(tag) + r"[\t\n\x0c />]",
                           re.I | re.A)
        if self.mode != _SCRIPT:
            m = close.search(s, pos)
            return m.start() if m else n
        # script data, with HTML5's escaped (1) and double-escaped (2)
        # states: "-->" leaves both, counting the dashes of "<!--"
        opens = re.compile(r"<" + re.escape(tag) + r"[\t\n\x0c />]",
                           re.I | re.A)
        state = dash = 0
        while True:
            m = close.search(s, pos)
            if state == 0:
                k = s.find("<!--", pos)
                if k < 0 or (m is not None and m.start() < k):
                    return m.start() if m else n
                state, pos, dash = 1, k + 4, k + 2
                continue
            o = opens.search(s, pos) if state == 1 else None
            events = [(x, kind) for x, kind in (
                (s.find("-->", dash), 0), (m.start() if m else -1, 1),
                (o.start() if o else -1, 2)) if x >= 0]
            if not events:
                return n
            x, kind = min(events)
            if kind == 0:
                state, pos = 0, x + 3
            elif kind == 2:
                state, pos = 2, o.end()
                dash = pos
            elif state == 1:
                return x
            else:
                state, pos = 1, m.end()
                dash = pos

    def run(self) -> Optional[Element]:
        s, n = self.s, len(self.s)
        self.pos = _SPACES.match(s).end()
        while self.pos < n and not self.done:
            pos = self.pos
            if self.mode != _DATA:
                end = self._raw_end(pos)
                text = s[pos:end]
                self._append(_decode(text, attr=False)
                             if self.mode == _RCDATA else text)
                self.pos, self.mode = end, _DATA
                continue
            if s[pos] != "<":
                end = s.find("<", pos)
                end = n if end < 0 else end
                self._chars(_decode(s[pos:end], attr=False))
                self.pos = end
                continue
            nxt = s[pos + 1] if pos + 1 < n else ""
            if nxt == "/":
                self._end()
            elif nxt == "!":
                self._markup()
            elif nxt == "?":
                self._bogus_comment(pos + 1)
            elif _is_letter(nxt):
                self._tag()
            else:
                # a lone "<" (as "</" at the end) implies a body wherever
                # it stands
                self._start_char_data()
                if not self.done:
                    self._append("<")
                self.pos = pos + 1
        return self.root


def _drop_comments(el: Element) -> None:
    kids = []
    for c in el.children:
        if c.tag == _COMMENT:
            if kids:
                kids[-1].tail += c.tail
            else:
                el.text += c.tail
        else:
            _drop_comments(c)
            kids.append(c)
    el.children = kids


def _joined(a: str, b: str) -> str:
    """``a + b`` as lxml sets it on a text or tail: it refuses a string
    that XML cannot hold."""
    if _NOT_XML.search(a + b):
        raise ValueError("All strings must be XML compatible: Unicode or "
                         "ASCII, no NULL bytes or control characters")
    return a + b


def _append_to_last(parent: Element, at: int, text: str) -> None:
    """``text`` after child ``at - 1`` of ``parent`` (its text at 0)."""
    if at:
        prev = parent.children[at - 1]
        prev.tail = _joined(prev.tail, text)
    else:
        parent.text = _joined(parent.text, text)


def _drop_tree(parent: Element, el: Element) -> None:
    """lxml's ``drop_tree``: ``el`` goes, its tail stays."""
    i = parent.children.index(el)
    if el.tail:
        _append_to_last(parent, i, el.tail)
    del parent.children[i]


def _has_block(el: Element) -> bool:
    return el.tag in _BLOCK_TAGS or any(_has_block(c) for c in el.children)


def _fragment_root(doc: Element) -> Element:
    """lxml.html's ``fromstring`` past ``document_fromstring``."""
    bodies = [c for c in doc.children if c.tag == "body"]
    body = bodies[0] if bodies else None
    for other in bodies[1:]:
        if other.text:
            _append_to_last(body, len(body.children), other.text)
        body.children.extend(other.children)
        other.children = []
        _drop_tree(doc, other)
    heads = [c for c in doc.children if c.tag == "head"]
    if heads:
        for other in heads[1:]:
            heads[0].children.extend(other.children)
            other.children = []
            _drop_tree(doc, other)
        return doc
    if body is None:
        return doc
    if (len(body.children) == 1 and not body.text.strip()
            and not body.children[-1].tail.strip()):
        return body.children[0]
    body.tag = "div" if _has_block(body) else "span"
    return body


def fromstring(html: str) -> Element:
    """The element ``lxml.html.fromstring(html)`` returns (module
    docstring), without comments."""
    if _XML_ENCODING.match(html):
        raise ValueError(
            "Unicode strings with encoding declaration are not supported. "
            "Please use bytes input or XML fragments without declaration.")
    full = _FULL_DOC.match(html) is not None
    # libxml2 looks for a byte-order mark in four bytes or more
    s = html[1:] if html.startswith("\ufeff") and len(html) > 1 else html
    m = _SURROGATE.search(s)
    if m:
        s = s[:m.start()]
    s = s.replace("\r\n", "\n").replace("\r", "\n").replace("\x00", "\ufffd")
    doc = _Parser(s).run()
    if doc is None:
        raise ParserError("Document is empty")
    root = doc if full else _fragment_root(doc)
    _drop_comments(root)
    return root
