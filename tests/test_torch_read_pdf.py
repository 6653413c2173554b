"""The classical ``read_pdf`` of the port against the JAX package's, on
the PDFs of tests/test_pdf_table.py (written with JAX's ``PdfWriter``):
for the "lattice", "stream" and "pdf" flavors the tables' ``df``,
``parsing_report``, ``shape``, ``bbox`` and HTML equal. The four flavor
golden cases (tests/golden/cases.py) give tests/golden/expected/ byte for
byte through the port. The lattice flavor renders the page with the
port's renderer (PIL for the text layer) and finds its lines without
cv2."""

import os
import sys

import numpy as np
import pytest

import pdf_table_tpu_torch
from pdf_table_tpu.pdf_table import read_pdf as jread_pdf
from pdf_table_tpu.pdfio.writer import PdfWriter
from pdf_table_tpu_torch.pdf_table import (Cell, Table, TableExtractor,
                                           TableList, read_pdf)
from pdf_table_tpu_torch.pdf_table.extractor import parse_pages

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402


def _grid(page, with_lines=True):
    if with_lines:
        page.table(20, 180, [80, 80, 80], 30,
                   [["h1", "h2", "h3"], ["a", "b", "c"]])
        return
    for y, row in zip([170, 140, 110], [["name", "qty", "price"],
                                        ["apple", "2", "3.50"],
                                        ["pear", "5", "1.25"]]):
        for x, txt in zip([30, 120, 210], row):
            page.text(x, y, txt, size=10)


def _span(page):
    x0, x1, x2 = 50.0, 150.0, 250.0
    for y in (180.0, 150.0, 120.0):
        page.line(x0, y, x2, y)
    for x in (x0, x2):
        page.line(x, 120.0, x, 180.0)
    page.line(x1, 120.0, x1, 150.0)
    page.text(100, 160, "HEAD", size=10)
    page.text(70, 130, "a", size=10)
    page.text(170, 130, "b", size=10)


def _aligned(page, n_rows=7, x_cols=(30, 120, 210), y_top=230, para=True,
             second=None):
    if para:
        page.text(30, 370, "An introductory paragraph line", size=10)
        page.text(30, 355, "continuing across the page width", size=10)
    for r in range(n_rows):
        for c, x in enumerate(x_cols):
            page.text(x, y_top - 18 * r, f"r{r}c{c}", size=10)
    if second is not None:
        for r in range(second["rows"]):
            for c, x in enumerate(second["x_cols"]):
                page.text(x, second["y_top"] - 18 * r, f"s{r}c{c}", size=10)


def _two_tables(page):
    page.table(20, 380, [80, 80], 30, [["a1", "a2"], ["a3", "a4"]])
    page.table(20, 160, [60, 60, 60], 25,
               [["b1", "b2", "b3"], ["b4", "b5", "b6"]])


# name -> (page size, builder, flavors)
CASES = {
    "ruled": ((300, 200), _grid, ("pdf", "lattice", "stream")),
    "unruled": ((300, 200), lambda p: _grid(p, False), ("stream",)),
    "span": ((300, 200), _span, ("pdf", "lattice")),
    "aligned": ((300, 400), _aligned, ("stream",)),
    "two_blocks": ((300, 400), lambda p: _aligned(
        p, n_rows=6, y_top=360, para=False,
        second={"rows": 6, "y_top": 140, "x_cols": (50, 150, 250)}),
        ("stream",)),
    "two_tables": ((300, 400), _two_tables, ("pdf", "lattice")),
}


def _pdf(tmp_path, name):
    (w, h), build, _ = CASES[name]
    writer = PdfWriter()
    build(writer.add_page(w, h))
    p = str(tmp_path / f"{name}.pdf")
    writer.save(p)
    return p


@pytest.mark.parametrize("name,flavor", [(n, f) for n, c in CASES.items()
                                         for f in c[2]])
def test_read_pdf_matches_jax(tmp_path, name, flavor):
    p = _pdf(tmp_path, name)
    want = jread_pdf(p, flavor=flavor)
    got = read_pdf(p, flavor=flavor)
    assert isinstance(got, TableList) and got.n == want.n >= 1
    for g, w in zip(got, want):
        assert g.df.equals(w.df)
        assert g.parsing_report == w.parsing_report
        assert g.shape == w.shape and g.data == w.data
        np.testing.assert_array_equal(g.bbox, w.bbox)
        assert g.to_html() == w.to_html()
        assert (g.flavor, g.page, g.order) == (w.flavor, w.page, w.order)


@pytest.mark.parametrize("name", sorted(cases.FLAVOR_CASES))
def test_golden_flavor_cases_through_the_port(tmp_path, name):
    build, flavor = cases.FLAVOR_CASES[name]
    tables = read_pdf(build(str(tmp_path)), flavor=flavor)
    got = tables[0].to_html() if flavor == "pdf" \
        else tables[0].df.to_csv(index=False)
    assert got == cases.load_expected(name)


def test_exports_and_flavor_check():
    assert pdf_table_tpu_torch.read_pdf is read_pdf
    assert {Cell, Table, TableList, TableExtractor}
    with pytest.raises(ValueError, match="unknown flavor"):
        read_pdf("x.pdf", flavor="nope")
    assert parse_pages("1,3-end", 5) == [0, 2, 3, 4]
    assert parse_pages("all", 2) == [0, 1]
