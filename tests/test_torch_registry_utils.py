"""The port's registry, task base class, small utilities, flag surface,
device trace and image reader against the JAX package's on the CPU.

The registry: the same names per task; every entry's config equal to
JAX's field by field (dtype pinned); ``get_config``'s dtype rule (f32 on
the CPU, as JAX's on its CPU backend; on a card, which no device names,
``PDFTABLE_COMPUTE_DTYPE``, bf16 unless set); an unknown name a ``KeyError`` as in JAX and a
``NotImplementedError`` as the port's tasks raise it; ``weights_dir``
equal; the tasks' name tables delegate to it. ``InferTask``: JAX's
``TaskConfig``, ``pad_batch`` and buckets, and the detection, 0/180
classification and table-structure tasks derive from it and record JAX's
timing keys per call. ``MathUtils`` and ``FileUtils`` equal JAX's on
seeded inputs, ``Constants`` reads the same environment names,
``PdfTableCliArguments`` has JAX's fields and defaults. ``device_trace``
writes a Chrome trace. The image reader (``utils/image_io.py``) is
bit-equal to ``cv2.imread`` / ``cv2.imdecode`` with ``IMREAD_COLOR``
(then BGR -> RGB) on PNGs (RGB, grey, grey + alpha, RGBA, palette,
1-bit, 16-bit grey and RGB) and within one grey level on JPEGs, EXIF
orientation applied; bytes that are no image give None."""

import dataclasses
import io
import json
import os

import cv2
import numpy as np
import pytest
import torch

from pdf_table_tpu.engine import infer_task as jinfer
from pdf_table_tpu.entity import args as jargs
from pdf_table_tpu.models import registry as jreg
from pdf_table_tpu.utils.file_utils import FileUtils as JFile
from pdf_table_tpu.utils.math_utils import MathUtils as JMath
from pdf_table_tpu_torch.engine import infer_task
from pdf_table_tpu_torch.entity import args as targs
from pdf_table_tpu_torch.models import registry
from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
from pdf_table_tpu_torch.utils import constants, image_io
from pdf_table_tpu_torch.utils.file_utils import FileUtils
from pdf_table_tpu_torch.utils.math_utils import MathUtils
from pdf_table_tpu_torch.utils.profiling import device_trace
from pdf_table_tpu_torch.utils.time_utils import TimeUtils

torch.set_num_threads(1)

TASKS = ("detection", "recognition", "layout", "table_structure", "cls")


# -- the registry ------------------------------------------------------

def test_registry_names_match_jax():
    assert registry.TASKS == TASKS
    for task in TASKS + (None,):
        assert registry.list_models(task) == jreg.list_models(task)


@pytest.mark.parametrize("task", TASKS)
def test_every_config_matches_jax(task):
    for name in registry.list_models(task):
        kw = {"task_type": "wireless"} if name == "Lore" else {}
        got = registry.build_config(task, name, dtype="float32", **kw)
        want = jreg.get_config(task, name, dtype="float32", **kw)
        assert vars(got) == vars(want), name
        assert vars(registry.get_config(task, name, device="cpu", **kw)) \
            == vars(jreg.get_config(task, name, **kw)), name
    assert registry.weights_dir(task, "x", "en") == jreg.weights_dir(
        task, "x", "en")


def test_dtype_rule(monkeypatch):
    monkeypatch.delenv("PDFTABLE_COMPUTE_DTYPE", raising=False)
    get = registry.get_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert get("detection", "PP-OCRv4_det", device="cpu").dtype == "float32"
    # None means the card, as engine/device.py::resolve_device takes it
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get("layout", "picodet")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert get("detection", "PP-OCRv4_det", device="cuda").dtype \
        == "bfloat16"
    assert get("layout", "picodet").dtype == "bfloat16"
    assert get("table_structure", "Lore", device="cuda",
               dtype="float32").dtype == "float32"
    monkeypatch.setenv("PDFTABLE_COMPUTE_DTYPE", "fp32")
    assert get("recognition", "CRNN", device="cuda").dtype == "float32"


def test_unknown_names_raise_naming_the_known_ones():
    for exc in (KeyError, NotImplementedError):
        with pytest.raises(exc, match="db_mobilenet.*PP-OCRv4_det"):
            registry.get_config("detection", "db_mobilenet")
    with pytest.raises(KeyError):
        jreg.get_config("detection", "db_mobilenet")


def test_task_name_tables_delegate_to_the_registry(monkeypatch):
    from pdf_table_tpu_torch.tasks import detection, recognition
    from pdf_table_tpu_torch.tasks import table_structure

    seen = []
    real = registry.build_config

    def spy(task, name, **kw):
        seen.append((task, name))
        return real(task, name, **kw)

    for mod in (detection, recognition, table_structure, registry):
        monkeypatch.setattr(mod, "build_config", spy, raising=False)
    detection.det_config("db_resnet18")
    recognition.rec_config(model="CRNN")
    table_structure.lore_config("wireless")
    assert seen == [("detection", "db_resnet18"), ("recognition", "CRNN"),
                    ("table_structure", "Lore")]


# -- InferTask ----------------------------------------------------------------

def test_task_config_and_buckets_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(
        infer_task.TaskConfig) if f.name != "extra"] == \
        [(f.name, f.default) for f in dataclasses.fields(jinfer.TaskConfig)
         if f.name != "extra"]
    assert infer_task.BUCKET_SIZES == jinfer.BUCKET_SIZES
    for n in (1, 3, 8, 9, 130, 300):
        assert infer_task.bucket_batch_size(n) == jinfer.bucket_batch_size(n)
    rng = np.random.default_rng(0)
    arrays = {"image": rng.random((3, 4, 5, 3), np.float32),
              "meta": rng.random((2,))}
    for bucket in (None, 8):
        got, n = infer_task.InferTask.pad_batch(arrays, bucket)
        want, jn = jinfer.InferTask.pad_batch(arrays, bucket)
        assert n == jn and got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_tasks_derive_from_infer_task_and_time_their_calls():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (96, 128, 3)).astype(np.uint8)
    grid = np.full((120, 150, 3), 255, np.uint8)
    grid[10:115:35, 10:140] = 0
    grid[10:115, 10:145:45] = 0
    tasks = [
        (OcrDetectionTask(device="cpu", limit_side_len=64), img),
        (ClsImagePulcTask("textline_orientation", device="cpu"), img),
        (OcrTableStructureTask("LineCell", device="cpu"), grid)]
    for task, x in tasks:
        assert isinstance(task, infer_task.InferTask)
        task(x)
        task(x)
        summary = task.timing_summary()
        assert set(summary) == {"preprocess", "infer", "postprocess",
                                "total"}
        assert all(s["count"] == 2.0 for s in summary.values())
        task.reset_timings()
        assert all(not v for v in task.timings.values())
    assert tasks[2][0](grid)["cells"]


# -- small utilities ----------------------------------------------------------

def test_math_utils_match_jax():
    rng = np.random.default_rng(2)
    a = np.sort(rng.uniform(0, 500, (9, 2, 2)), axis=1).reshape(9, 4)
    b = np.sort(rng.uniform(0, 500, (7, 2, 2)), axis=1).reshape(7, 4)
    poly = rng.uniform(0, 50, (6, 2))
    for args in ((a, 1.7, 2.1, 800.0),):
        np.testing.assert_array_equal(
            MathUtils.scale_boxes_pdf_to_image(*args),
            JMath.scale_boxes_pdf_to_image(*args))
        np.testing.assert_array_equal(
            MathUtils.scale_boxes_image_to_pdf(*args),
            JMath.scale_boxes_image_to_pdf(*args))
    np.testing.assert_array_equal(MathUtils.iou_matrix(a, b),
                                  JMath.iou_matrix(a, b))
    for i in range(7):
        f = (1.5, 0.5 + i, 700.0)
        assert MathUtils.scale_pdf(a[i], f) == JMath.scale_pdf(a[i], f)
        assert MathUtils.scale_image(a[i], f) == JMath.scale_image(a[i], f)
        assert MathUtils.iou(a[i], b[i]) == JMath.iou(a[i], b[i])
        assert MathUtils.overlap_ratio(a[i], b[i]) == \
            JMath.overlap_ratio(a[i], b[i])
    assert MathUtils.poly_area(poly) == JMath.poly_area(poly)
    assert MathUtils.poly_perimeter(poly) == JMath.poly_perimeter(poly)


def test_file_utils_match_jax(tmp_path):
    obj = {"a": np.int64(3), "b": np.float32(0.5), "c": np.arange(3),
           "d": "é", "e": [1, 2]}
    for utils, side in ((FileUtils, "p"), (JFile, "j")):
        root = tmp_path / side
        utils.write_json(str(root / "x" / "o.json"), obj)
        utils.write_text(str(root / "t.txt"), "line\nnext")
        utils.write_lines(str(root / "l.txt"), ["a", 2, "c"])
        utils.write_bytes(str(root / "b.bin"), b"\x00\x01")
        utils.copy(str(root / "t.txt"), str(root / "y" / "t2.txt"))
    p, j = tmp_path / "p", tmp_path / "j"
    for name in ("x/o.json", "t.txt", "l.txt", "b.bin", "y/t2.txt"):
        assert (p / name).read_bytes() == (j / name).read_bytes()
    assert FileUtils.read_json(str(p / "x/o.json")) == \
        JFile.read_json(str(j / "x/o.json"))
    assert FileUtils.read_lines(str(p / "l.txt")) == \
        JFile.read_lines(str(j / "l.txt"))
    assert FileUtils.file_sha256(str(p / "b.bin")) == \
        JFile.file_sha256(str(j / "b.bin")) == JFile.sha256(b"\x00\x01")
    assert [os.path.relpath(f, p) for f in FileUtils.list_files(
        str(p), (".txt",))] == [os.path.relpath(f, j) for f in
                               JFile.list_files(str(j), (".txt",))]
    assert FileUtils.base_name("/a/b.c.pdf") == JFile.base_name("/a/b.c.pdf")
    assert TimeUtils.elapsed_ms(TimeUtils.now()) >= 0.0
    assert len(TimeUtils.now_tag()) == 15


def test_constants_read_the_same_environment_names():
    from pdf_table_tpu.utils.constants import Constants as J

    C = constants.Constants
    for name in ("BASE_DIR", "OUTPUT_DIR", "MODEL_CACHE_DIR",
                 "PAGE_CACHE_DIR", "LOG_DIR", "LOG_FILE", "LOG_LEVEL",
                 "USE_MODELSCOPE_HUB", "PDF_RENDER_DPI", "DEBUG"):
        assert getattr(C, name) == getattr(J, name), name


def test_cli_arguments_match_jax():
    def fields(mod):
        return [(f.name, f.default) for f in
                dataclasses.fields(mod.PdfTableCliArguments)]

    assert fields(targs) == fields(jargs)
    argv = ["--file_path_or_url", "a.pdf", "--pages", "1,3-end", "--debug",
            "--batch_pages", "4", "--detect_db_thresh", "0.3"]
    assert vars(targs.parse_cli_args(argv)) == vars(jargs.parse_cli_args(
        argv))
    for cls in ("ModelArguments", "DataTrainingArguments"):
        assert [(f.name, f.default) for f in dataclasses.fields(
            getattr(targs, cls))] == [(f.name, f.default) for f in
                                      dataclasses.fields(getattr(jargs, cls))]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(None):
        pass
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "trace").iterdir()
    trace = json.loads(path.read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with pytest.raises(ValueError):
        with device_trace(str(tmp_path / "raised")):
            raise ValueError("inside")
    assert len(list((tmp_path / "raised").iterdir())) == 1


# -- the image reader --------------------------------------------------

def _pil_png(arr, mode=None, **save):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG", **save)
    return buf.getvalue()


def _pngs():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (21, 33, 3)).astype(np.uint8)
    out = {"rgb": cv2.imencode(".png", rgb)[1].tobytes(),
           "grey": cv2.imencode(".png", rgb[..., 0])[1].tobytes(),
           "rgba": cv2.imencode(".png", rng.integers(
               0, 256, (21, 33, 4)).astype(np.uint8))[1].tobytes(),
           "grey16": cv2.imencode(".png", rng.integers(
               0, 65536, (21, 33)).astype(np.uint16))[1].tobytes(),
           "rgb16": cv2.imencode(".png", rng.integers(
               0, 65536, (21, 33, 3)).astype(np.uint16))[1].tobytes(),
           "grey_alpha": _pil_png(rng.integers(0, 256, (21, 33, 2)).astype(
               np.uint8), "LA"),
           "bilevel": _pil_png(rng.integers(0, 2, (21, 33)).astype(bool))}
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).quantize(16).save(buf, format="PNG")
    out["palette"] = buf.getvalue()
    return out


@pytest.mark.parametrize("kind", sorted(_pngs()))
def test_png_decodes_as_imread_color(kind, tmp_path):
    data = _pngs()[kind]
    want = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8),
                                     cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    got = image_io.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "x.png")
    open(path, "wb").write(data)
    np.testing.assert_array_equal(
        image_io.read_image(path),
        cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB))


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_jpeg_within_a_grey_level_with_exif_orientation(orientation):
    from PIL import Image

    rng = np.random.default_rng(orientation)
    img = np.clip(rng.normal(128, 40, (40, 64, 3)), 0, 255).astype(np.uint8)
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95, exif=exif)
    data = buf.getvalue()
    want = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8),
                                     cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    got = image_io.decode_image(data)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1
    if orientation in (6, 8):
        assert got.shape[:2] == img.shape[1::-1]


def test_bad_bytes_and_missing_files_give_none(tmp_path):
    assert image_io.decode_image(b"not an image") is None
    assert cv2.imdecode(np.frombuffer(b"not an image", np.uint8),
                        cv2.IMREAD_COLOR) is None
    assert image_io.read_image(str(tmp_path / "missing.png")) is None
    img = np.random.default_rng(5).integers(0, 256, (9, 7, 3)).astype(
        np.uint8)
    path = str(tmp_path / "w.png")
    image_io.write_png(path, img)
    np.testing.assert_array_equal(
        cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB), img)
