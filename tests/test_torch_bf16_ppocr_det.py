"""The PP-OCRv4 detector in bf16 against the JAX package's bf16 model on
the detection lane's own input, as tests/test_torch_bf16_dbnet.py holds the
ModelScope DBNets (its own file: the JAX bf16 and f32 compiles of the
MobileNetV3 stack take half a minute on one CPU worker)."""

import pytest
import torch

from test_torch_bf16_dbnet import check_lane
from test_torch_dbnet_backbones import setup as _setup

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["PP-OCRv4_det"])
def ppocr(request):
    """The tree and lane input of tests/test_torch_dbnet_backbones.py's
    ``setup``, for PP-OCRv4."""
    return _setup.__wrapped__(request)


def test_bf16_ppocr_lane_matches_jax(ppocr):
    check_lane(*ppocr)
