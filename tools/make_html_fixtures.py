"""Write tests/data/html_tree/cases.json: table HTML inputs and the
SHA-256 of the tree ``lxml.html.fromstring`` builds from each.

The inputs are the rows a-k of the port's HTML parser repair, the edge
cases of tests/test_torch_html_tree.py and a seeded sample of its table
soup (tests/html_soup.py). The digest is of the JSON of the canonical
tree of ``html_soup.canonical_lxml`` (["raises", name] where lxml
raises). chip_smoke.py's ``html`` phase parses every input with the port
on the card's host, which has no lxml, and fails on any digest that
differs. Run it where lxml 6.1.1 over libxml2 2.14.6 is installed:

    python tools/make_html_fixtures.py           # write the file
    python tools/make_html_fixtures.py --check   # compare, write nothing
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)

from html_soup import ROWS, digest, lxml_tree, soup_pair  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "html_tree", "cases.json")
LXML, LIBXML2 = (6, 1, 1, 0), (2, 14, 6)
SOUP_PAIRS = 136
EXTRA = [
    "", " \n\t", "<!-- c -->", "</p>", "\ufeffa", "<?xml version='1.0' "
    "encoding='utf-8'?><p>a", "<p>a\ud800b</p><i>c</i>",
    "<body>a\x0b</body><body>b</body>", "<b>x</b><!--c-->",
    "<script>a<!--b<script>c</script>d</script>e-->f</script>g",
    "<td>&notit; &ampx &lt3 &#x80; &#0; &#xD800; &#65 &#x41x</td>",
    "<td title='a&amp;b&lt c&ltd&copy=x&notit;' nowrap>",
    "<frameset><b>x</frameset>y", "<p>a</p></body><body x=1>b</body>d",
    "<" + "a" * 98 + "€bb>x", "<html> <head> x",
    "".join(f"<div>t{i}" for i in range(260)) + "<p>after",
]


def cases():
    inputs = [h for hs in ROWS.values() for h in hs] + EXTRA
    for seed in range(SOUP_PAIRS):
        inputs.extend(soup_pair(seed))
    return [{"input": h, "sha256": digest(lxml_tree(h))} for h in inputs]


def main(argv=None) -> int:
    from lxml import etree

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--check", action="store_true",
                   help="compare with the file instead of writing it")
    args = p.parse_args(argv)
    if (etree.LXML_VERSION, etree.LIBXML_VERSION) != (LXML, LIBXML2):
        print(f"lxml {etree.LXML_VERSION} over libxml2 "
              f"{etree.LIBXML_VERSION}: the digests are lxml "
              f"{LXML} over libxml2 {LIBXML2}", file=sys.stderr)
        return 1
    data = {"lxml": ".".join(map(str, LXML[:3])),
            "libxml2": ".".join(map(str, LIBXML2)), "cases": cases()}
    if args.check:
        with open(OUT) as f:
            same = json.load(f) == data
        print("equal" if same else "differs")
        return 0 if same else 1
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(data, f, indent=0)
        f.write("\n")
    print(f"{len(data['cases'])} cases -> {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
