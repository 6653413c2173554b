"""The port's table-HTML parser (``utils/html_tree.py``) against lxml 6.1.1
over libxml2 2.14.6, and the table tools that read its trees (TEDS,
result compare, the xlsx export) against the JAX package's, which parse
with lxml.

A tree is compared whole (tags, attributes, text, tails, children, the
root; comments dropped as ``itertext`` drops them), and so is the error
where lxml raises one. Held:

* the rows a-k of the parser's fault table (tests/html_soup.py);
* the start-close table: rebuilt here from lxml with every ordered pair
  of the HTML 4 and HTML5 element names and one unknown name, in a cell,
  a row, a section, a table and the body, and ``head``'s row at the top
  level, equal to the module's data; the end-tag priorities on the same
  names;
* every HTML5 named reference and the numeric references around the
  remapped and refused code points, in text and in attribute values;
* 2,000 seeded table soup pairs (tests/html_soup.py): both trees of each
  equal lxml's, and TEDS (full and structure only), ``_cells_of``,
  ``_rows_of`` and the xlsx worksheet's cells and merges of each equal
  JAX's;
* the digests of tests/data/html_tree/cases.json (lxml's trees, made by
  tools/make_html_fixtures.py), which chip_smoke.py's ``html`` phase
  holds the card host's parse to.
"""

import json
import os

import pytest
import torch
from lxml import etree
from lxml import html as lxml_html

from html_soup import (ROWS, canonical_lxml, digest, lxml_tree, port_tree,
                       soup_pair)
from pdf_table_tpu.eval.teds import TEDS as JTEDS
from pdf_table_tpu.tasks import result_compare as jrc
from pdf_table_tpu.utils import xlsx_writer as jxlsx
from pdf_table_tpu.utils.xlsx_writer import html_table_to_xlsx as j_to_xlsx
from pdf_table_tpu_torch.eval.teds import TEDS
from pdf_table_tpu_torch.tasks import result_compare as trc
from pdf_table_tpu_torch.utils import html_tree
from pdf_table_tpu_torch.utils import xlsx_writer as txlsx
from pdf_table_tpu_torch.utils.xlsx_writer import html_table_to_xlsx

torch.set_num_threads(1)

HTML4 = """a abbr acronym address applet area b base basefont bdo big
blockquote body br button caption center cite code col colgroup dd del dfn
dir div dl dt em fieldset font form frame frameset h1 h2 h3 h4 h5 h6 head
hr html i iframe img input ins isindex kbd label legend li link map menu
meta noframes noscript object ol optgroup option p param pre q s samp
script select small span strike strong style sub sup table tbody td
textarea tfoot th thead title tr tt u ul var""".split()
HTML5 = """article aside audio bdi canvas data datalist details dialog embed
figcaption figure footer header hgroup main mark math meter nav output
picture progress rp rt ruby search section slot source summary svg
template time track video wbr bgsound blink image keygen listing marquee
menuitem multicol nextid nobr noembed plaintext rb rtc spacer
xmp""".split()
NAMES = sorted(set(HTML4) | set(HTML5)) + ["x-unknown"]
VOID = {"area", "base", "basefont", "br", "col", "frame", "hr", "img",
        "input", "isindex", "link", "meta", "param"}
RAW = {"iframe", "noembed", "noframes", "plaintext", "script", "style",
       "textarea", "title", "xmp"}
CONTEXTS = {"cell": "<table><tr><td>", "row": "<table><tr>",
            "section": "<table><tbody>", "table": "<table>", "body": ""}
OPEN = [n for n in NAMES if n not in VOID | RAW | {"html", "head", "body"}]
N_PAIRS, CHUNKS = 2000, 4


_BY_ID = etree.XPath("//*[@id=$i]")


def _closed(prefix, a, b):
    """Whether ``<b>`` closes the open ``<a>`` after ``prefix``: B's
    element (or, where B's tag was dropped, a marker after it) does not
    stand inside A's."""
    doc = lxml_html.document_fromstring(
        f"{prefix}<{a} id=a><{b} id=b><x-marker id=c>")
    el_b = _BY_ID(doc, i="b") or _BY_ID(doc, i="c")
    return _BY_ID(doc, i="a")[0] not in el_b[0].iterancestors()


def _call(fn, *args):
    try:
        return fn(*args)
    except Exception as e:
        return type(e).__name__, str(e)


def _sheet(module, to_xlsx, html, monkeypatch):
    """The cells and merges ``to_xlsx`` hands its module's
    ``write_xlsx`` (the sheet is theirs alone: tests/test_torch_aux_tasks.py
    holds the port's writer to JAX's), or its error."""
    got = []
    monkeypatch.setattr(module, "write_xlsx",
                        lambda path, grid, merges: got.append((grid, merges)))
    err = _call(to_xlsx, html, None)
    return got or err


@pytest.mark.parametrize("html", [h for hs in ROWS.values() for h in hs],
                         ids=[f"{r}{i}" for r, hs in ROWS.items()
                              for i in range(len(hs))])
def test_fault_rows_give_lxml_tree(html):
    assert port_tree(html) == lxml_tree(html)


EDGES = [
    "", " \n\t", "<!-- c -->", "<?x?>", "</p>", "<!DOCTYPE html>", "\ud800",
    " \ufeff", "\ufeff", "\ufeffa",
    "<?xml version='1.0' encoding='utf-8'?><p>a", "<?xml version='1.0'?><p>a", "<p>a\ud800b</p><i>c</i>",
    "<b>x</b><!--c-->", "<body><!--c--></body>",
    "<body>a\x0b</body><body>b</body>",
    "".join(f"<div>t{i}" for i in range(260)) + "<p>after",
    "<b>" * 254 + "<br>z", "<frameset>" * 255 + "x"]


@pytest.mark.parametrize("html", EDGES, ids=range(len(EDGES)))
def test_errors_and_roots_where_lxml_gives_them(html):
    assert port_tree(html) == lxml_tree(html)


@pytest.mark.parametrize("html", EDGES + [
    "<table><tr><aÄ>x</aÄ><td>1</table>"], ids=range(len(EDGES) + 1))
def test_table_tools_on_edge_inputs_equal_jax(html, monkeypatch):
    """TEDS folds tags as JAX's does (Unicode ``lower``, where the parser
    folds ASCII only), and result compare answers [] on any input lxml
    refuses."""
    gt = "<table><tr><aä>x</aä><td>1</td></tr></table>"
    for j, t in ((JTEDS(), TEDS()),
                 (JTEDS(structure_only=True), TEDS(structure_only=True))):
        assert _call(t.evaluate, html, gt) == _call(j.evaluate, html, gt)
        assert _call(t.evaluate, gt, html) == _call(j.evaluate, gt, html)
    assert _call(trc._cells_of, html) == _call(jrc._cells_of, html)
    assert _call(trc._rows_of, html) == _call(jrc._rows_of, html)
    assert _sheet(txlsx, html_table_to_xlsx, html, monkeypatch) == \
        _sheet(jxlsx, j_to_xlsx, html, monkeypatch)


@pytest.mark.parametrize("context", sorted(CONTEXTS))
def test_start_close_table_is_lxml_s(context):
    probed = {}
    for a in OPEN:
        closes = frozenset(b for b in NAMES
                           if _closed(CONTEXTS[context], a, b))
        if closes:
            probed[a] = closes
    want = {k: v for k, v in html_tree._START_CLOSES.items() if k != "head"}
    assert probed == want


def test_head_start_closes_are_lxml_s():
    probed = frozenset(b for b in NAMES if _closed("<html>", "head", b))
    assert probed == html_tree._START_CLOSES["head"]


def test_end_tag_priorities_are_lxml_s():
    """``</A>`` closes the open B above it exactly where no element
    between them outranks A."""
    prio = html_tree._END_PRIORITY
    for a in OPEN:
        if a == "frameset":  # a body opens inside it first
            continue
        for b in OPEN:
            if b in html_tree._START_CLOSES.get(a, ()):
                continue
            doc = lxml_html.document_fromstring(
                f"<{a} id=a><{b} id=b></{a}><x-marker id=c>")
            el_b, el_c = (_BY_ID(doc, i=i)[0] for i in "bc")
            assert (el_b not in el_c.iterancestors()) == \
                (prio.get(b, 100) <= prio.get(a, 100)), (a, b)


def test_character_references_are_lxml_s():
    from html.entities import html5

    for name in html5:
        for html in (f"<p>&{name}x&{name};</p>", f"<p title='&{name}x'>",
                     f"<p title='&{name}'>", f"<p title='&{name}=&{name} '>",
                     f"<p>&{name}"):
            assert port_tree(html) == lxml_tree(html), html
    codes = [*range(0, 0x200), *range(0xD7F0, 0xE010), 0xFFFE, 0xFFFF,
             0x1FFFE, 0x10FFFF, 0x110000, 10 ** 30]
    for c in codes:
        raw = chr(c) if c < 0xD800 or 0xDFFF < c < 0x110000 else ""
        for html in (f"<p>&#{c};x&#x{c:x}</p>", f"<p title='&#{c}x&#X{c:X};'>",
                     f"<p>{raw}y</p>"):
            assert port_tree(html) == lxml_tree(html), html


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_soup_trees_and_table_tools_equal_lxml_and_jax(chunk, monkeypatch):
    teds = [(JTEDS(), TEDS()),
            (JTEDS(structure_only=True), TEDS(structure_only=True))]
    per = N_PAIRS // CHUNKS
    for seed in range(chunk * per, (chunk + 1) * per):
        pred, gt = soup_pair(seed)
        for j, t in teds:
            assert _call(t.evaluate, pred, gt) == \
                _call(j.evaluate, pred, gt), seed
        for html in (pred, gt):
            assert port_tree(html) == lxml_tree(html), (seed, html)
            assert _call(trc._cells_of, html) == \
                _call(jrc._cells_of, html), (seed, html)
            assert _call(trc._rows_of, html) == \
                _call(jrc._rows_of, html), (seed, html)
            assert _sheet(txlsx, html_table_to_xlsx, html, monkeypatch) \
                == _sheet(jxlsx, j_to_xlsx, html, monkeypatch), (seed, html)


def test_fixture_digests_are_lxml_s_and_the_port_s():
    path = os.path.join(os.path.dirname(__file__), "data", "html_tree",
                        "cases.json")
    with open(path) as f:
        cases = json.load(f)["cases"]
    assert len(cases) >= 300
    for case in cases:
        assert digest(lxml_tree(case["input"])) == case["sha256"]
        assert digest(port_tree(case["input"])) == case["sha256"]


def test_canonical_form_drops_comments_as_itertext_does():
    doc = lxml_html.fromstring("<td>a<!--c-->b<i>x</i><!--d-->y</td>")
    tree = canonical_lxml(doc)
    assert tree[2] + "".join(c[2] + c[4] for c in tree[3]) == \
        "".join(doc.itertext())
