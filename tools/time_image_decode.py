"""Time ``pdf_table_tpu_torch.utils.image_io.decode_image`` on scan-sized
files that the port reads with its own readers, and check each decode
against the samples it was made from.

    python tools/time_image_decode.py [--root DIR] [--repeat N]

``--root`` is the checkout whose ``pdf_table_tpu_torch`` is timed (by
default this one): an unpacked older commit gives the comparison on the
same host. The files come from tests/data/image_decode/make_fixtures.py,
from its seed: a 2480 x 3508 P3 and P2 (300 dpi A4, ASCII) and a 16,400²
grey TIFF in one deflate strip. Prints one JSON object: per file its size
in bytes, the fastest of ``--repeat`` decodes in seconds, and whether the
decode gave the file's samples (``null`` where it gave None)."""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(os.path.dirname(HERE), "tests", "data",
                                      "image_decode", "make_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    sys.path.insert(0, os.path.abspath(args.root))
    from pdf_table_tpu_torch.utils.image_io import decode_image

    side = 16400
    x = np.arange(side)
    files = {}
    for kind in (3, 2):
        data, samples = tool.page_ascii_pnm(kind)
        files[f"P{kind}_2480x3508"] = (data, np.broadcast_to(
            samples, samples.shape[:2] + (3,)))
    files[f"tiff_grey_strip_{side}"] = (
        tool.strip_tiff(tool.grey_strip(side), side, side, 1),
        lambda rgb: all(np.array_equal(rgb[y, :, c], (x + 7 * y) % 251)
                        for y in (0, 1, side - 1) for c in range(3)))
    out = {"root": os.path.abspath(args.root)}
    for name, (data, want) in files.items():
        best, rgb = float("inf"), None
        for _ in range(args.repeat):
            rgb = None
            t = time.perf_counter()
            rgb = decode_image(data)
            best = min(best, time.perf_counter() - t)
        ok = None if rgb is None else (
            want(rgb) if callable(want) else bool(np.array_equal(rgb, want)))
        out[name] = {"bytes": len(data), "decode_s": best, "equal": ok}
        del rgb
    print(json.dumps(out))


if __name__ == "__main__":
    main()
