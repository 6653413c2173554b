"""The port's ModelScope DBNets in bf16 (``db_resnet18``, ``db_resnet50``,
``db_proxylessnas``; ``PP-OCRv4_det`` in tests/test_torch_bf16_ppocr_det.py)
against the JAX package's bf16 models
on the detection lane's own input (the trees and pages of
tests/test_torch_dbnet_backbones.py, ``limit_side_len=128``), on the CPU:
the prob map held to the yardstick of tests/test_torch_dtype_policy.py
(the port in f32 must fail it),
the lane's uint8 maps (2x2 max-pool, rounding) equal except where JAX's
bf16 prob lies within the measured prob gap of a rounding boundary (a
near-tie), and the boxes of the port's connected components on its maps,
the near-tie pixels resolved as JAX's maps have them, equal to those of
JAX's ``batch_component_boxes_u8`` on JAX's maps. The measured gaps print under ``pytest -s``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.models.dbnet import DBNet as JDBNet
from pdf_table_tpu.models.registry import get_config
from pdf_table_tpu.ops.connected_components import \
    batch_component_boxes_u8 as j_boxes
from pdf_table_tpu_torch.ops.connected_components import \
    batch_component_boxes_u8 as t_boxes
from pdf_table_tpu_torch.tasks.detection import (CC_ITERS, MAX_COMPONENTS,
                                                 OcrDetectionTask)
from test_torch_dbnet_backbones import CFG, setup  # noqa: F401
from test_torch_dtype_policy import assert_f32_fails, hold_bf16

torch.set_num_threads(1)


def test_bf16_lane_matches_jax(setup):
    check_lane(*setup)


def check_lane(model, v, x):

    def jax_prob(dtype):
        return np.asarray(JDBNet(get_config("detection", model, dtype=dtype,
                                            **CFG)).apply(v, x)["prob"])

    j32, j16 = jax_prob("float32"), jax_prob("bfloat16")
    task = OcrDetectionTask(model=model, device="cpu", variables=v,
                            dtype="bfloat16", **CFG)
    task32 = OcrDetectionTask(model=model, device="cpu", variables=v,
                              dtype="float32", **CFG)
    with torch.no_grad():
        prob = task.model(torch.from_numpy(x))["prob"]
        prob32 = task32.model(torch.from_numpy(x))["prob"]
    assert prob.dtype == torch.float32
    dists = hold_bf16(prob.numpy(), j16, j32)
    assert_f32_fails([(prob32.numpy(), j16, j32)])
    gap = float(np.abs(prob.numpy() - j16).max())
    with torch.no_grad():
        got = task.quantize(prob).numpy()
        want = task.quantize(torch.from_numpy(j16)).numpy()
    # a near-tie: the pooled prob within the gap of a rounding boundary
    pooled = torch.nn.functional.max_pool2d(torch.from_numpy(j16)[:, None],
                                            2)[:, 0].numpy() * 255.0
    frac = pooled - np.floor(pooled)
    tie = np.abs(frac - 0.5) <= gap * 255.0
    assert (got == want)[~tie].all()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # the boxes: the port's CC on its maps with the near-tie pixels
    # resolved as JAX's are, against JAX's CC on JAX's maps
    resolved = np.where(tie, want, got)
    thr = int(np.percentile(want[0], 80))
    hw = np.asarray([want.shape[1:]] * len(want), np.int32)
    tb = t_boxes(torch.from_numpy(resolved), thr, torch.from_numpy(hw),
                 max_components=MAX_COMPONENTS, num_iters=CC_ITERS).numpy()
    jb = np.asarray(j_boxes(jnp.asarray(want), thr, jnp.asarray(hw),
                            max_components=MAX_COMPONENTS,
                            num_iters=CC_ITERS))
    assert (jb[..., 5] > 0).sum() >= 3, "too few boxes to compare"
    np.testing.assert_array_equal(tb[..., [0, 1, 2, 3, 5]],
                                  jb[..., [0, 1, 2, 3, 5]])
    np.testing.assert_allclose(tb[..., 4], jb[..., 4], rtol=0, atol=1e-6)
    print(f"\n{model}: {dists}; map pixels off {(got != want).mean():.2e}, "
          f"boxes {(jb[..., 5] > 0).sum()}")
