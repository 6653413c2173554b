"""The data model and the small helpers of the public surface, held to the
JAX package: every case of tests/test_entity.py, the enums' ``desc`` and
``parse``, the geometry and cell methods, tests/test_utils.py's
``TestBenchmark``, ``ModelKey``, ``default_backend`` and
``Constants.ensure_dirs``. Each case runs on both packages with the same
inputs, made from a seed with numpy, and the results must be equal.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

JAX, PORT = "pdf_table_tpu", "pdf_table_tpu_torch"


def entity(pkg):
    return importlib.import_module(f"{pkg}.entity")


def both(case):
    """``case(E, rng)`` on the JAX entity and on the port's, each with a
    fresh generator of seed 0; the two results must be equal."""
    want = case(entity(JAX), np.random.default_rng(0))
    got = case(entity(PORT), np.random.default_rng(0))
    np.testing.assert_equal(got, want)
    return got


# --- tests/test_entity.py, case for case ------------------------------------


def _h(E, x1, x2, y=10.0):
    return E.Line(E.Point(x1, y), E.Point(x2, y),
                  E.LineDirectionType.HORIZONTAL)


def _v(E, y1, y2, x=10.0):
    return E.Line(E.Point(x, y1), E.Point(x, y2),
                  E.LineDirectionType.VERTICAL)


def _lines(lines):
    return [(ln.min_x, ln.max_x, ln.min_y, ln.max_y, ln.direction.name,
             ln.width, ln.height) for ln in lines]


def case_merge_all(E, rng):
    ivs = [E.LineInterval(5, 9), E.LineInterval(0, 3), E.LineInterval(2, 6)]
    merged = E.LineInterval.merge_all(ivs)
    assert len(merged) == 1
    assert merged[0].start == 0 and merged[0].end == 9
    return [(m.start, m.end) for m in merged]


def case_merge_disjoint(E, rng):
    merged = E.LineInterval.merge_all([E.LineInterval(0, 1),
                                       E.LineInterval(5, 6)])
    assert len(merged) == 2
    return [(m.start, m.end) for m in merged]


def case_normalizes_order(E, rng):
    iv = E.LineInterval(9, 1)
    assert iv.start == 1 and iv.end == 9
    return (iv.start, iv.end, repr(iv))


def case_merge_horizontal(E, rng):
    lines = [_h(E, 0, 5), _h(E, 4, 9), _h(E, 20, 30)]
    merged = E.Line.merge_lines(lines, diff=2,
                                direction=E.LineDirectionType.HORIZONTAL)
    assert len(merged) == 2
    assert merged[0].min_x == 0 and merged[0].max_x == 9
    assert merged[1].min_x == 20
    return _lines(merged)


def case_merge_with_gap_tolerance(E, rng):
    merged = E.Line.merge_lines([_h(E, 0, 5), _h(E, 6.5, 9)], diff=2)
    assert len(merged) == 1
    return _lines(merged)


def case_merge_vertical(E, rng):
    merged = E.Line.merge_lines([_v(E, 0, 5), _v(E, 5.5, 12)], diff=2,
                                direction=E.LineDirectionType.VERTICAL)
    assert len(merged) == 1
    assert merged[0].min_y == 0 and merged[0].max_y == 12
    return _lines(merged)


def case_merge_segments_1d_vectorized(E, rng):
    segs = np.array([[5, 9], [0, 3], [2.5, 6], [20, 25], [24, 30]])
    out = E.Line.merge_segments_1d(segs, diff=1.0)
    assert out.shape == (2, 2)
    np.testing.assert_allclose(out[0], [0, 9])
    np.testing.assert_allclose(out[1], [20, 30])
    return out


def case_merge_segments_1d_matches_interval_merge(E, rng):
    starts = rng.uniform(0, 100, size=200)
    lens = rng.uniform(0, 10, size=200)
    segs = np.stack([starts, starts + lens], axis=1)
    fast = E.Line.merge_segments_1d(segs, diff=0.0)
    slow = E.LineInterval.merge_all([E.LineInterval(a, b) for a, b in segs])
    assert len(fast) == len(slow)
    for row, iv in zip(fast, slow):
        np.testing.assert_allclose(row, [iv.start, iv.end])
    return fast


def _cell(c):
    return (c.bbox, c.text, c.cell_type.name, c.score, c.text_number,
            c.text_width, c.is_image, c.index, c.line_type.name,
            None if c.poly is None else c.poly.tolist())


def case_from_bbox(E, rng):
    c = E.OcrCell.from_bbox([10, 20, 110, 40], text="hello")
    assert c.width == 100 and c.height == 20
    assert c.cell_type == E.HtmlContentType.TXT
    assert c.text_number == 5
    assert c.text_width == 20.0
    return _cell(c)


def case_from_poly(E, rng):
    poly = np.array([[0, 0], [10, 1], [10, 11], [0, 10]], dtype=np.float32)
    c = E.OcrCell.from_poly(poly, text="x")
    assert c.bbox == (0.0, 0.0, 10.0, 11.0)
    assert c.poly.shape == (4, 2)
    return _cell(c)


def case_raw_data_image(E, rng):
    c = E.OcrCell(raw_data={"bbox": [0, 0, 5, 5], "is_image": True,
                            "image_info": {"path": "x.png"}})
    assert c.is_image
    assert c.cell_type == E.HtmlContentType.IMAGE
    return _cell(c) + (c.image_info,)


def case_contains(E, rng):
    outer = E.OcrCell.from_bbox([0, 0, 100, 100])
    inner = E.OcrCell.from_bbox([10, 10, 50, 50])
    assert outer.contains(inner)
    assert not inner.contains(outer)
    assert outer.contains_point(50, 50)
    pts = rng.uniform(-20, 120, (64, 2))
    return [outer.contains_point(x, y, tol=3.0) for x, y in pts] \
        + [inner.contains(outer), outer.contains(inner)]


def case_to_dict_roundtrip(E, rng):
    c = E.OcrCell.from_bbox([1, 2, 3, 4], text="t")
    d = c.to_dict()
    c2 = E.OcrCell(raw_data=d)
    assert c2.bbox == c.bbox
    assert c2.text == "t"
    return d, _cell(c2)


def case_table_unit_axes(E, rng):
    u = E.TableUnit(bbox=[0, 0, 10, 10], logit_axis=[0, 1, 2, 3])
    assert u.start_row == 0 and u.end_row == 1
    assert u.start_col == 2 and u.end_col == 3
    return (u.start_row, u.end_row, u.start_col, u.end_col,
            dataclasses.asdict(u))


# --- the rest of the entity's public names ----------------------------------


def case_enums(E, rng):
    out = {}
    for cls in (E.HtmlContentType, E.HtmlTableCompareType,
                E.LineDirectionType, E.PdfLineType, E.LayoutLabelEnum,
                E.ModelType):
        out[cls.__name__] = [(m.name, m.value) for m in cls]
        if hasattr(cls, "desc"):
            out[cls.__name__ + ".desc"] = [m.desc for m in cls]
    for cls in (E.HtmlContentType, E.HtmlTableCompareType,
                E.LayoutLabelEnum):
        raws = [m.value for m in cls] + [m.name for m in cls] \
            + [m.value.upper() for m in cls] + ["nothing", 3, None]
        out[cls.__name__ + ".parse"] = [
            None if (p := cls.parse(r)) is None else p.name for r in raws]
    return out


def case_point(E, rng):
    out = []
    for x, y in rng.uniform(-50, 800, (16, 2)):
        p = E.Point(float(x), float(y), is_joint=bool(x > 300))
        s = p.scaled((1.5, 1.5, 792.0))
        out.append((p.to_tuple(), p.key(), repr(p), s.to_tuple(),
                    s.is_joint))
    return out


def case_line_geometry(E, rng):
    out = []
    for row in rng.uniform(0, 600, (12, 4)):
        ln = E.Line(E.Point(row[0], row[1]), E.Point(row[2], row[3]),
                    E.LineDirectionType.HORIZONTAL, width=2.0, height=1.0)
        s = ln.scaled((2.0, 2.0, 600.0))
        out.append((ln.min_x, ln.max_x, ln.min_y, ln.max_y, ln.line_width,
                    ln.line_height, repr(ln), s.left.to_tuple(),
                    s.right.to_tuple()))
    return out


def case_line_merge_random(E, rng):
    out = []
    for direction in (E.LineDirectionType.HORIZONTAL,
                      E.LineDirectionType.VERTICAL):
        segs = rng.uniform(0, 200, (40, 2)).round(1)
        lines = [(_h if direction.name == "HORIZONTAL" else _v)(E, a, b)
                 for a, b in segs]
        for diff in (0.0, 2.0, 5.0):
            merged = E.Line.merge_lines(lines, diff=diff, direction=direction)
            out.append(_lines(merged))
            out.append([E.Line.can_merge(lines[i], lines[i + 1], diff,
                                         direction)
                        for i in range(len(lines) - 1)])
            out.append(_lines([E.Line.merge_two(lines[0], lines[1],
                                                direction)]))
        out.append(E.Line.merge_segments_1d(segs, diff=2.0))
    out.append([E.LineInterval.intersects(E.LineInterval(*a),
                                          E.LineInterval(*b))
                for a, b in rng.uniform(0, 10, (20, 2, 2))])
    out.append(E.Line.merge_segments_1d(np.zeros((0, 2))).shape)
    return out


def case_cell_methods(E, rng):
    out = []
    for box in rng.uniform(0, 500, (8, 4)):
        c = E.OcrCell(text="word", score=0.5)
        c.set_bbox(box)
        out.append(_cell(c) + (c.width, c.height, c.area,
                               c.center.to_tuple(), repr(c)))
        c.index = 3
        c.poly = box.reshape(2, 2).astype(np.float32)
        c2 = E.OcrCell(raw_data=c.to_dict())
        out.append(_cell(c2) + (c.to_dict(),))
    return out


def case_table_eval(E, rng):
    units = [E.TableUnit(bbox=list(rng.uniform(0, 100, 4)),
                         logit_axis=list(rng.integers(0, 9, 4)),
                         text="t", score=0.9) for _ in range(5)]
    ev = E.TableEval(image_name="a.png", units=units)
    empty = E.TableEval()
    blank = E.TableUnit()
    return (ev.bboxes(), ev.axes(), empty.bboxes().shape,
            empty.axes().shape, blank.start_row, blank.end_col)


CASES = [case_merge_all, case_merge_disjoint, case_normalizes_order,
         case_merge_horizontal, case_merge_with_gap_tolerance,
         case_merge_vertical, case_merge_segments_1d_vectorized,
         case_merge_segments_1d_matches_interval_merge, case_from_bbox,
         case_from_poly, case_raw_data_image, case_contains,
         case_to_dict_roundtrip, case_table_unit_axes, case_enums,
         case_point, case_line_geometry, case_line_merge_random,
         case_cell_methods, case_table_eval]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_entity_matches_jax(case):
    both(case)


def test_entity_exports_and_args():
    from pdf_table_tpu import entity as je
    from pdf_table_tpu_torch import entity as te

    assert je.__all__ == te.__all__
    for cls in ("PdfTableCliArguments", "ModelArguments",
                "DataTrainingArguments"):
        jf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(je, cls))]
        tf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(te, cls))]
        assert tf == jf


# --- utils, registry, engine ------------------------------------------------


def test_benchmark_utils_match_jax():
    """tests/test_utils.py::TestBenchmark on both packages."""
    from pdf_table_tpu.utils import benchmark_utils as jb
    from pdf_table_tpu_torch.utils import benchmark_utils as tb

    rng = np.random.default_rng(0)
    for timings in ([1.0, 2.0, 3.0], list(rng.uniform(0, 2, 50)), []):
        assert tb.timing_stats(timings) == jb.timing_stats(timings)
    st = tb.timing_stats([1.0, 2.0, 3.0])
    assert st["mean"] == pytest.approx(2.0) and st["count"] == 3
    for timings in ([0.001, 0.002], list(rng.uniform(0, 0.1, 20))):
        assert tb.print_timings("stage", timings) \
            == jb.print_timings("stage", timings)
    assert tb.print_timings("stage", [0.001, 0.002])["count"] == 2
    for mod in (jb, tb):
        buf = []
        with mod.track_infer_time(buf):
            pass
        with pytest.raises(ValueError):
            with mod.track_infer_time(buf):
                raise ValueError
        assert len(buf) == 2 and min(buf) >= 0


def test_model_key_matches_jax():
    from pdf_table_tpu.models.registry import ModelKey as J
    from pdf_table_tpu_torch.models.registry import ModelKey as T

    assert [(f.name, f.default) for f in dataclasses.fields(T)] \
        == [(f.name, f.default) for f in dataclasses.fields(J)]
    k = T("layout", "picodet", "table")
    assert dataclasses.astuple(k) == dataclasses.astuple(
        J("layout", "picodet", "table"))
    assert {k: 1}[T("layout", "picodet", "table")] == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        k.name = "other"


def test_default_backend_and_dtype_name_the_device():
    import jax.numpy as jnp

    from pdf_table_tpu.engine import compute_dtype as jax_dtype
    from pdf_table_tpu.engine import default_backend as jax_backend
    from pdf_table_tpu_torch.engine import compute_dtype, default_backend

    assert default_backend("cpu") == jax_backend() == "cpu"
    assert jax_dtype() == jnp.float32
    assert compute_dtype(device="cpu") == torch.float32
    assert compute_dtype("bfloat16") == torch.bfloat16
    if not torch.cuda.is_available():
        for fn in (default_backend, compute_dtype):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn()


def test_ensure_dirs(tmp_path, monkeypatch):
    from pdf_table_tpu.utils.constants import Constants as J
    from pdf_table_tpu_torch.utils.constants import Constants as T

    made = {}
    for name, cls in (("jax", J), ("port", T)):
        for attr in ("BASE_DIR", "OUTPUT_DIR", "MODEL_CACHE_DIR",
                     "PAGE_CACHE_DIR", "LOG_DIR"):
            monkeypatch.setattr(cls, attr, str(tmp_path / name / attr))
        cls.ensure_dirs()
        cls.ensure_dirs()
        made[name] = sorted(p.name for p in (tmp_path / name).iterdir())
    assert made["port"] == made["jax"] and len(made["jax"]) == 5
