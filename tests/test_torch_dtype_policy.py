"""The port's compute-dtype policy (engine/device.py::default_dtype, the
counterpart of the JAX package's ``compute_dtype`` and of its registry's
``get_config``): bf16 on the card unless ``PDFTABLE_COMPUTE_DTYPE`` says
otherwise, f32 on the CPU, and the tasks that JAX builds through its
registry take it where the caller names no dtype.

Also the yardstick that the bf16 parity tests (tests/test_torch_bf16_*.py)
hold each model to, on the same flax tree and input, each distance
relative to the head's largest magnitude:

- the port's bf16 output no farther from JAX's bf16 output than JAX's bf16
  output is from JAX's f32 output, and under ``BF16_REL_TOL``;
- bf16 on the port's side: the port's bf16 output at least
  ``BF16_OWN_MIN`` times as far from JAX's f32 output as JAX's bf16 output
  is. A port that ran in f32 sits at about JAX's own distance from JAX's
  bf16 output, so the first rule alone cannot tell it; this one does, and
  every family's test runs the port in f32 as a control that must fail
  (:func:`assert_f32_fails`).

The distances are root-mean-square: both bf16 sides round their outputs,
so the largest deviation of two bf16 runs is one output ulp wherever any
rounding flipped upstream, and JAX's own bf16-vs-f32 maximum is about one
ulp too; a comparison of the maxima is decided by a single pixel
(measured: 4.8e-3 against 4.4e-3 for db_proxylessnas, 6.7e-3 against
7.1e-3 for db_resnet18). The largest deviation stays under
``BF16_REL_TOL`` where JAX's own maximum does. A model may state a larger
``factor`` only where it shows why: TableMaster's encoder (19 3x3
convolutions over 128-512 channels) sums each convolution in another order
than XLA's, so a few bf16 roundings flip a layer and the flips spread; its
test holds every block, fed JAX's bf16 input, to JAX's bf16 output bit for
bit on most elements, and its whole encoder to the limit of independent
round-off, sqrt(2). The distances print under ``pytest -s``."""

import numpy as np
import pytest
import torch

from pdf_table_tpu_torch.engine.device import default_dtype
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
from pdf_table_tpu_torch.tasks.layout import OcrLayoutTask
from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask

torch.set_num_threads(1)

# LORE's bf16 tolerance (tests/test_torch_lore.py): the bound no bf16 head
# may pass, whatever JAX's own bf16 error
BF16_REL_TOL = 4e-2
# the port's bf16 output from JAX's f32 output, at least this share of JAX's
# bf16 distance from it (measured 0.89-1.16)
BF16_OWN_MIN = 0.5
# two bf16 runs with independent round-off, each at JAX's distance from f32
INDEPENDENT = 2.0 ** 0.5


def rel_dist(got, want) -> float:
    """max |got - want| relative to ``want``'s largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def rms_dist(got, want) -> float:
    """RMS of ``got - want`` relative to ``want``'s largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.sqrt(np.mean((got - want) ** 2))) / max(
        float(np.abs(want).max()), 1e-6)


def bf16_distances(port, jax16, jax32) -> dict:
    """The yardstick's distances of one head: RMS port vs JAX bf16, JAX
    bf16 vs f32, port vs JAX f32, and the maxima of the first two."""
    return {"port": rms_dist(port, jax16), "ref": rms_dist(jax16, jax32),
            "own": rms_dist(port, jax32), "port_max": rel_dist(port, jax16),
            "ref_max": rel_dist(jax16, jax32)}


def meets_bf16(d: dict, factor: float = 1.0) -> bool:
    return (d["port"] <= factor * d["ref"] and d["port"] < BF16_REL_TOL
            and d["port_max"] < max(BF16_REL_TOL, d["ref_max"])
            and d["own"] >= BF16_OWN_MIN * d["ref"])


def hold_bf16(port16, jax16, jax32, factor: float = 1.0):
    """Assert the yardstick on one head; returns a line of the distances."""
    d = bf16_distances(port16, jax16, jax32)
    assert meets_bf16(d, factor), d
    return (f"port bf16 vs JAX bf16 RMS {d['port']:.3e} max "
            f"{d['port_max']:.3e}; JAX bf16 vs JAX f32 RMS {d['ref']:.3e} "
            f"max {d['ref_max']:.3e}; port bf16 vs JAX f32 RMS "
            f"{d['own']:.3e} ({d['own'] / max(d['ref'], 1e-30):.2f}x)")


def assert_f32_fails(heads, factor: float = 1.0):
    """The control: the port's f32 outputs, held as its bf16 ones would be
    (``heads``: (port f32, JAX bf16, JAX f32) triples), fail the
    yardstick on at least one head."""
    ds = [bf16_distances(*h) for h in heads]
    assert not all(meets_bf16(d, factor) for d in ds), ds


def decided(scores, margin):
    """Positions whose top-1 beats the top-2 by more than ``margin``
    (last axis): where a decision is not a near-tie."""
    s = np.sort(np.asarray(scores, np.float64), axis=-1)
    return s[..., -1] - s[..., -2] > margin


def assert_bf16_rule(model, f32=()):
    """flax's bf16 rule (``dtype=bf16``, ``param_dtype=f32``) on a bf16
    ``model``: the norms' parameters and statistics f32, every other
    floating parameter bf16, except under the submodule names in ``f32``
    (parts that compute in f32, as the JAX model's do) and ConvNext's
    ``gamma`` (a flax parameter used uncast)."""
    from pdf_table_tpu_torch.models.layers import BatchNorm, LayerNorm

    n16 = 0
    for name, mod in model.named_modules():
        own = dict(mod.named_parameters(recurse=False),
                   **dict(mod.named_buffers(recurse=False)))
        norm = isinstance(mod, (BatchNorm, LayerNorm))
        kept = any(name == p or name.startswith(p + ".") for p in f32)
        for k, t in own.items():
            if not t.is_floating_point():
                continue
            want = torch.float32 if norm or kept or k == "gamma" \
                else torch.bfloat16
            assert t.dtype == want, (name, k, t.dtype)
            n16 += want == torch.bfloat16
    assert n16, "no bf16 parameter"


VALUES = {None: torch.bfloat16, "bfloat16": torch.bfloat16,
          "bf16": torch.bfloat16, "BF16": torch.bfloat16,
          "float32": torch.float32, "fp32": torch.float32}


@pytest.mark.parametrize("value", list(VALUES))
@pytest.mark.parametrize("device", ["cpu", "cuda", torch.device("cuda", 0)])
def test_default_dtype(monkeypatch, value, device):
    """The policy reads the device's type only: no device is built."""
    if value is None:
        monkeypatch.delenv("PDFTABLE_COMPUTE_DTYPE", raising=False)
    else:
        monkeypatch.setenv("PDFTABLE_COMPUTE_DTYPE", value)
    want = torch.float32 if torch.device(device).type == "cpu" \
        else VALUES[value]
    assert default_dtype(device) == want


@pytest.mark.parametrize("value", ["float16", "fp16", "int8", ""])
def test_default_dtype_refuses_what_the_port_does_not_run(monkeypatch,
                                                          value):
    monkeypatch.setenv("PDFTABLE_COMPUTE_DTYPE", value)
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="PDFTABLE_COMPUTE_DTYPE"):
            default_dtype(device)


def _fake_card(monkeypatch):
    """The policy of a task on ``cuda`` without a card: ``resolve_device``
    passes, and the model stays on the CPU (``.to`` a cuda device is the
    identity)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    to = torch.nn.Module.to

    def to_cpu(self, *args, **kw):
        if args and str(args[0]).startswith("cuda"):
            return self
        return to(self, *args, **kw)

    monkeypatch.setattr(torch.nn.Module, "to", to_cpu)
    monkeypatch.setattr(torch, "tensor", _no_device(torch.tensor))
    monkeypatch.setattr(torch, "as_tensor", _no_device(torch.as_tensor))


def _no_device(fn):
    def call(*args, **kw):
        kw.pop("device", None)
        return fn(*args, **kw)
    return call


LORE_TINY = dict(resolution=(64, 64), max_objs=8, hidden_size=32,
                 head_conv=16, tsfm_layers=1, stacking_layers=1,
                 num_heads=4, max_fmp_size=64, d_ff=64)


def _tasks(device, **dtype):
    """One task of each kind whose dtype the policy decides, and one of
    each that JAX builds without its registry (f32 unless asked)."""
    policy = {
        "det": OcrDetectionTask(device=device, limit_side_len=128, **dtype),
        "rec": OcrRecognitionTask(device=device, **dtype),
        "picodet": OcrLayoutTask(device=device, **dtype),
        "lore": OcrTableStructureTask("Lore", task_type="wireless",
                                      device=device, **LORE_TINY, **dtype),
        "slanet": OcrTableStructureTask("SLANet", device=device,
                                        hidden_size=32, **dtype),
    }
    fixed = {
        "lgpma": OcrTableStructureTask(
            "Lgpma", device=device, backbone_depth=18, fpn_channels=32,
            rpn_pre_topk=32, num_proposals=16, mask_top=8, fc_dim=64,
            max_side=64, **dtype),
        "master": OcrTableStructureTask(
            "TableMaster", device=device, d_model=64, heads=4, ff_dim=64,
            decoder_layers=2, max_structure_len=8, img_size=(64, 64),
            **dtype),
    }
    return policy, fixed


@pytest.mark.parametrize("value", ["bfloat16", "float32"])
def test_tasks_take_the_policy_on_the_card(monkeypatch, value):
    """On ``cuda`` the registry models (DBNet, the CTC recognizers,
    PicoDet, LORE, SLANet) take ``PDFTABLE_COMPUTE_DTYPE``; LGPMA and
    TableMaster stay f32, as JAX builds their configs directly."""
    monkeypatch.setenv("PDFTABLE_COMPUTE_DTYPE", value)
    _fake_card(monkeypatch)
    policy, fixed = _tasks("cuda")
    for name, task in policy.items():
        assert task.model_config.dtype == value, name
    for name, task in fixed.items():
        assert task.model_config.dtype == "float32", name


def test_tasks_stay_f32_on_the_cpu(monkeypatch):
    monkeypatch.setenv("PDFTABLE_COMPUTE_DTYPE", "bfloat16")
    policy, fixed = _tasks("cpu")
    for name, task in {**policy, **fixed}.items():
        assert task.model_config.dtype == "float32", name


def test_a_named_dtype_wins_over_the_policy(monkeypatch):
    monkeypatch.setenv("PDFTABLE_COMPUTE_DTYPE", "float32")
    policy, fixed = _tasks("cpu", dtype="bfloat16")
    for name, task in {**policy, **fixed}.items():
        assert task.model_config.dtype == "bfloat16", name
        dtypes = {p.dtype for p in task.model.parameters()}
        assert torch.bfloat16 in dtypes, name
