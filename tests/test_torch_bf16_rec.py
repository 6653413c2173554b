"""The port's four CTC recognizers in bf16 (``PP-OCRv4_rec``, ``CRNN``,
``ConvNextViT``, ``LightweightEdge``) against the JAX package's bf16 models
on the same flax trees and inputs as the f32 tests
(tests/test_torch_rec_model.py, tests/test_torch_rec_backbones.py), at full
width on the CPU: the logits held to the yardstick of
tests/test_torch_dtype_policy.py (no farther from JAX's bf16 logits than
those are from JAX's f32 logits, under 4e-2 of the largest logit, and
the port in f32 failing it), the
greedy ids equal wherever JAX's bf16 top-1 beats its top-2 by more than
``TIE``. CRNN's BiLSTMs are ``nn.LSTM`` in bf16 on the port's side and
flax's ``OptimizedLSTMCell`` (bf16 gates, an f32 carry) on JAX's: the
measured gap is printed with the others (``pytest -s``)."""

import jax
import numpy as np
import pytest
import torch

from pdf_table_tpu.models.rec_ctc import CTCRecModel as JRec
from pdf_table_tpu.models.registry import get_config
from pdf_table_tpu_torch.convert.flax_bridge import load_flax_variables
from pdf_table_tpu_torch.models.rec_ctc.model import CTCRecModel
from pdf_table_tpu_torch.tasks.recognition import rec_config
from test_torch_dtype_policy import assert_f32_fails, decided, hold_bf16
from test_torch_rec_backbones import build
from test_torch_rec_model import _crops, rec_tree

torch.set_num_threads(1)

MODELS = ("PP-OCRv4_rec", "CRNN", "ConvNextViT", "LightweightEdge")


def _setup(model):
    if model == "PP-OCRv4_rec":
        cfg = rec_config(model=model)
        return rec_tree(cfg), _crops(7, n=3)
    return build(model)


@pytest.mark.parametrize("model", MODELS)
def test_bf16_logits_and_ids_match_jax(model):
    v, x = _setup(model)

    def jax_logits(dtype):
        return np.asarray(JRec(get_config("recognition", model,
                                          dtype=dtype)).apply(v, x))

    j32, j16 = jax_logits("float32"), jax_logits("bfloat16")
    nets = {}
    for d in ("bfloat16", "float32"):
        nets[d] = CTCRecModel(rec_config(model=model, dtype=d)).eval()
        load_flax_variables(nets[d], v)
    with torch.no_grad():
        got = nets["bfloat16"](torch.from_numpy(x))
        got32 = nets["float32"](torch.from_numpy(x)).numpy()
    assert got.dtype == torch.float32
    got = got.numpy()
    dists = hold_bf16(got, j16, j32)
    assert_f32_fails([(got32, j16, j32)])
    ok = decided(j16, 2.0 * float(np.abs(got - j16).max()))
    assert ok.mean() > 0.25, "too many near-ties to compare ids"
    np.testing.assert_array_equal(got.argmax(-1)[ok], j16.argmax(-1)[ok])
    print(f"\n{model}: {dists}; ids compared {ok.mean():.3f}")
