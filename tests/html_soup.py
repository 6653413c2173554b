"""Table HTML for holding the port's HTML parser (utils/html_tree.py) to
lxml: the fault rows a-k of the parser's repair, and seeded table tag soup.

A soup is one table grid (rows, cells, spans, texts) rendered with seeded
faults: cells, rows, sections and inline tags left open, stray end tags,
late sections, captions and nested tables, lists and options in cells,
raw-text elements, comments and references, OCR-like text with ``<``,
CR/LF and NUL, duplicate and unquoted attributes, and a document around
the table now and then. :func:`soup_pair` renders one grid twice, as a
prediction and its ground truth, so that TEDS compares related tables.
Imported by tests/test_torch_html_tree.py and tools/make_html_fixtures.py.
"""

import numpy as np

# the rows of the fault table: each input gives lxml's tree
ROWS = {
    "a": ["<table><tr><td><i>i<td>x</table>",
          "<table><tr><td><b>i<td>x</table>",
          "<table><tr><td><u>i<td>x</table>",
          "<table><tr><td><a>i<td>x</table>",
          "<table><tr><td><font>i<td>x</table>",
          "<table><tr><td><span>i<td>x</table>",
          "<table><tr><th><i>i<th>x</table>"],
    "b": ["<table><tr><td><li>a<li>b</table>",
          "<table><tr><td><dt>a<dd>b</table>",
          "<table><tr><td><option>a<option>b</table>"],
    "c": ["<table><tbody><tr><td>x<thead><tr><td>y</table>"],
    "d": ["<table><tr><td><noscript><td>n</noscript>x</table>"],
    "e": ["<table><tr><td><xmp><td></xmp>x</table>",
          "<table><tr><td><plaintext><td>x</table>",
          "<table><tr><td><iframe><td></iframe>x</table>",
          "<table><tr><td><noframes><td></noframes>x</table>"],
    "f": ["<table><tr><td><embed>x</table>"],
    "g": ["<meta charset=utf-8><table><tr><td>x</td></tr></table>",
          "<title>t</title><table><tr><td>x</td></tr></table>"],
    "h": ["<table><tr><td>x</td></tr></table></html>y",
          "<table><tr><td>x</td></tr></table><head>"],
    "i": ["<table><tr><td colspan=2 colspan=3>x</table>"],
    "j": ["<table><tr><td>a\r\nb</table>", "<table><tr><td>a\rb</table>",
          "<table><tr><td>a\x00b</table>"],
    "k": ["<table><tr><td title='a&ampb'>x</table>"],
}

WORDS = ["Total", "2023", "1.5", "A&B", "x<y", "<thead>", "<a href",
         "a\r\nb", "a\rb", "a\x00b", " ", "\n", "\t", "&amp;", "&amp",
         "&ampb", "&lt3", "&#x80;", "&#65", "&nbsp", "&notit;", "&#0;",
         "<3", "</", "< b", "q", "z", "Café", ">", "=", "'", '"', "-->",
         "Net (%)", "<td", "</td", "&#13;", "\x0c", "T<b>"]
INLINE = ["b", "i", "u", "a", "font", "span", "sup", "sub", "em", "strong",
          "small", "s", "tt", "big"]
LISTS = [("li", "li"), ("dt", "dd"), ("option", "option"), ("p", "p")]
RAW = ["xmp", "iframe", "plaintext", "noframes", "noembed", "script",
       "style", "title", "textarea"]
OTHER = ["noscript", "embed", "div", "br", "hr", "img", "center", "form",
         "x-unknown", "wbr", "source", "label", "h1", "pre", "select"]
MARKUP = ["<!--c-->", "<!-->", "<!x>", "<?x>", "</3>", "</>",
          "<!DOCTYPE html>", "<!-- a -- b -->"]
PREFIX = ["", "", "", "", "<html>", "<!DOCTYPE html>", "<meta charset=utf-8>",
          "<title>t</title>", "<html><head><title>t</title></head><body>",
          "<p>intro", " \n", "<body>", "<head></head>"]
SUFFIX = ["", "", "", "", "</html>y", "<head>", "</body>z", "<p>after",
          "\r\n", "</table>tail", "<table><tr><td>second</table>"]


def _pick(rng, seq):
    return seq[int(rng.integers(len(seq)))]


def _grid(rng):
    """Rows of cells, each (text words, rowspan, colspan, header)."""
    rows = []
    for _ in range(int(rng.integers(1, 4))):
        row = []
        for _ in range(int(rng.integers(1, 5))):
            words = [_pick(rng, WORDS) for _ in range(int(rng.integers(0, 3)))]
            row.append((words, int(_pick(rng, [1, 1, 1, 2, 3])),
                        int(_pick(rng, [1, 1, 1, 2, 3])), rng.random() < 0.2))
        rows.append(row)
    return rows


def _attrs(rng, rs, cs):
    out = []
    for name, v in (("rowspan", rs), ("colspan", cs)):
        if v > 1 or rng.random() < 0.1:
            q = _pick(rng, ['"', "'", ""])
            out.append(f" {_pick(rng, [name, name, name.upper()])}={q}{v}{q}")
            if rng.random() < 0.15:
                out.append(f" {name}={v % 3 + 1}")
    if rng.random() < 0.1:
        out.append(_pick(rng, [" nowrap", " title='a&ampb'", " class=x y",
                               " title=\"a\r\nb\"", " a/b", " id="]))
    rng.shuffle(out)
    return "".join(out)


def _content(rng, words):
    """A cell's content: its words with seeded faults around them."""
    out = []
    for w in words:
        r = rng.random()
        if r < 0.12:
            t = _pick(rng, INLINE)
            out.append(f"<{t}>{w}" + (f"</{t}>" if rng.random() < 0.6 else ""))
        elif r < 0.18:
            a, b = _pick(rng, LISTS)
            out.append(f"<{a}>{w}<{b}>{w}")
        elif r < 0.22:
            t = _pick(rng, RAW)
            out.append(f"<{t}>{w}<td>" + (f"</{t}>" if rng.random() < 0.7
                                           else ""))
        elif r < 0.28:
            out.append(f"<{_pick(rng, OTHER)}>{w}")
        elif r < 0.32:
            out.append(_pick(rng, MARKUP) + w)
        elif r < 0.35:
            out.append(f"</{_pick(rng, INLINE + OTHER + ['td', 'tr'])}>{w}")
        elif r < 0.37:
            out.append(f"<table><tr><td>{w}" + ("</table>" if rng.random()
                                                 < 0.5 else ""))
        else:
            out.append(w)
    return "".join(out)


def _render(rng, grid):
    """One seeded rendering of ``grid`` as table HTML."""
    close = float(_pick(rng, [1.0, 0.9, 0.5, 0.0]))
    parts = [_pick(rng, PREFIX), "<table>"]
    if rng.random() < 0.15:
        parts.append("<caption>" + _pick(rng, WORDS)
                     + ("</caption>" if rng.random() < 0.5 else ""))
    layout = _pick(rng, ["", "", "tbody", "thead", "late_thead", "tfoot"])
    head_rows = 1 if layout in ("thead", "late_thead") else 0
    if layout in ("tbody", "late_thead", "tfoot"):
        parts.append(f"<{'tbody' if layout != 'tfoot' else 'tfoot'}>")
    for ri, row in enumerate(grid):
        if layout == "thead" and ri == 0:
            parts.append("<thead>")
        if layout == "thead" and ri == head_rows:
            parts.append("</thead><tbody>" if rng.random() < close
                         else "<tbody>")
        if layout == "late_thead" and ri == len(grid) - 1:
            parts.append("<thead>")
        parts.append("<tr>")
        for words, rs, cs, header in row:
            tag = "th" if header else "td"
            parts.append(f"<{tag}{_attrs(rng, rs, cs)}>{_content(rng, words)}")
            if rng.random() < close:
                parts.append(f"</{tag}>")
        if rng.random() < close:
            parts.append("</tr>")
        if rng.random() < 0.05:
            parts.append(f"</{_pick(rng, ['td', 'tr', 'tbody', 'b', 'p'])}>")
    if rng.random() < max(close, 0.3):
        parts.append("</table>")
    parts.append(_pick(rng, SUFFIX))
    return "".join(parts)


def soup_pair(seed: int):
    """(prediction, ground truth): one seeded grid rendered twice."""
    grid = _grid(np.random.default_rng([seed, 0]))
    return (_render(np.random.default_rng([seed, 1]), grid),
            _render(np.random.default_rng([seed, 2]), grid))


def canonical_lxml(el):
    """lxml's element as [tag, [[name, value], ...], text, children,
    tail], comments and processing instructions dropped as itertext
    drops them (their tails kept); a comment root is tagged
    ``#comment``."""
    if not isinstance(el.tag, str):
        return ["#comment", [], "", [], el.tail or ""]
    kids, text = [], el.text or ""
    for c in el:
        if not isinstance(c.tag, str):
            if kids:
                kids[-1][4] += c.tail or ""
            else:
                text += c.tail or ""
            continue
        kids.append(canonical_lxml(c))
    return [el.tag, [list(a) for a in el.attrib.items()], text, kids,
            el.tail or ""]


def canonical_port(el):
    """The port's element in the form of :func:`canonical_lxml`."""
    return [el.tag, [list(a) for a in el.attrs.items()], el.text,
            [canonical_port(c) for c in el.children], el.tail]


def lxml_tree(html):
    """``lxml.html.fromstring``'s tree, or ["raises", its error]."""
    from lxml import html as lxml_html

    try:
        return canonical_lxml(lxml_html.fromstring(html))
    except Exception as e:  # ParserError, or ValueError on a declaration
        return ["raises", type(e).__name__]


def port_tree(html):
    """The port's tree, or ["raises", its error]."""
    from pdf_table_tpu_torch.utils.html_tree import fromstring

    try:
        return canonical_port(fromstring(html))
    except ValueError as e:
        return ["raises", type(e).__name__]


def digest(tree) -> str:
    import hashlib
    import json

    return hashlib.sha256(json.dumps(tree).encode()).hexdigest()
