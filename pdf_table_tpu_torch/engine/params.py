"""Deterministic numpy-seeded initialization in the flax layout.

:func:`init_lore`, :func:`init_centernet`, :func:`init_docx_layout`,
:func:`init_lgpma`, :func:`init_dbnet`, :func:`init_rec`, :func:`init_cls`,
:func:`init_picodet`, :func:`init_slanet` and :func:`init_table_master`
return a ``{"params", "batch_stats"}`` tree with the paths and shapes the
JAX package's ``LoreModel.init`` / ``CycleCenterNet.init`` /
``DocXLayoutModel.init`` / ``LGPMA.init`` / ``DBNet.init`` (every
backbone) / ``CTCRecModel.init`` (every backbone) /
``PPLCNetClassifier.init`` / ``PicoDet.init`` / ``SLANet.init`` /
``TableMaster.init`` give, filled with the
flax initializers' kinds: lecun-normal conv / transposed-conv / dense
kernels (LSTM gates too), zero biases, BN and LayerNorm scale/bias 1/0 and
statistics 0/1, PReLU slopes 0.25, ConvNext ``gamma`` 1e-6, he-normal
depthwise 2x2 upsample kernels, a normal(0.02) ViT position table;
for the SLANet head and the TableMaster decoder's flat parameters
xavier-uniform matrices, normal(0.02) embeddings, LayerNorm scales 1;
for LORE and Cycle-CenterNet also he-normal DCN weights,
the bilinear upsample kernel, a zero ``conv_offset_mask`` and the -2.19
``hm_out`` bias. The numbers differ from a JAX PRNG init (another
generator); the structure is the same, so the weight bridge moves either
tree.

:func:`load_or_init` restores a converted tree or falls back to a seeded
init, warning, as JAX's does.

:func:`save_params`, :func:`save_params_async` / :func:`wait_for_async_saves`
and :func:`load_params` keep a tree (nested dicts of tensors, arrays and
numbers) in the port's own format: ``torch.save`` of host tensors, one
``tree.pt`` in the checkpoint directory. JAX's orbax directories are not
read (orbax is not on the card's machine).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..convert.flax_bridge import tree_leaves
from ..models.center_net.config import CenterNetConfig
from ..models.cls.config import ClsPulcConfig
from ..models.dbnet.config import DbNetConfig
from ..models.dbnet.model import DwPwConvTranspose
from ..models.docx_layout.config import DocXLayoutConfig
from ..models.layers import BatchNorm
from ..models.lgpma.config import LgpmaConfig
from ..models.lore.config import LoreConfig
from ..models.lore.dla import (DeformConvBlock, DepthwiseUpsample,
                               bilinear_up_kernel)
from ..models.lore.processor_model import RefNorm
from ..models.nas_layers import PReLU
from ..models.picodet.config import PicoDetConfig
from ..models.rec_ctc.config import RecConfig
from ..models.rec_ctc.model import ConvNextBlock, ConvNextViTBackbone
from ..models.slanet.config import SLANetConfig
from ..models.table_master.config import TableMasterConfig
from ..utils.logging_utils import logger


CKPT_FILE = "tree.pt"


def _to_host(tree: Any) -> Any:
    """The tree with every tensor and array as a host tensor (a copy)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    return tree


def _write(host_tree: Any, ckpt_dir: str) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, CKPT_FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(host_tree, tmp)
    os.replace(tmp, path)


def save_params(variables: Any, ckpt_dir: str) -> None:
    """Write ``variables`` (any tree of dicts, tensors, arrays and numbers)
    to ``ckpt_dir``, replacing what is there."""
    _write(_to_host(variables), os.path.abspath(ckpt_dir))


_pending: Optional[threading.Thread] = None
_pending_error: list = []


def save_params_async(variables: Any, ckpt_dir: str) -> threading.Thread:
    """:func:`save_params` whose file write runs on a thread, so that the
    next training steps overlap it; the device-to-host copy is made here,
    so later in-place updates do not reach the checkpoint. One save is in
    flight at a time. Call :func:`wait_for_async_saves` before reading the
    checkpoint or exiting."""
    global _pending
    wait_for_async_saves()
    host = _to_host(variables)
    path = os.path.abspath(ckpt_dir)

    def run():
        try:
            _write(host, path)
        except Exception as e:  # re-raised by wait_for_async_saves
            _pending_error.append(e)

    _pending = threading.Thread(target=run, daemon=True)
    _pending.start()
    return _pending


def wait_for_async_saves() -> None:
    """Block until the save in flight is written; raise its error."""
    global _pending
    if _pending is not None:
        _pending.join()
        _pending = None
    if _pending_error:
        raise _pending_error.pop()


def load_params(ckpt_dir: str) -> Any:
    """The tree :func:`save_params` wrote, host tensors as leaves."""
    return torch.load(os.path.join(os.path.abspath(ckpt_dir), CKPT_FILE),
                      map_location="cpu", weights_only=True)


def has_saved_params(ckpt_dir: Optional[str]) -> bool:
    """True when ``ckpt_dir`` holds a tree :func:`save_params` wrote."""
    return bool(ckpt_dir) and os.path.isfile(os.path.join(ckpt_dir,
                                                          CKPT_FILE))


def load_or_init(ckpt_dir: Optional[str], init_fn: Callable[[], Any],
                 task_name: str = "") -> Any:
    """The converted tree in ``ckpt_dir`` when there is one, else
    ``init_fn()`` (a seeded init), as JAX's ``load_or_init``.

    Random weights are right for tests and training from scratch, but give
    confident garbage in inference, so the fallback warns (one line a
    task) naming the converter; ``PDF_TABLE_TPU_ALLOW_RANDOM_INIT=quiet``
    silences it. A tree that does not load is reported and replaced by the
    init."""
    if has_saved_params(ckpt_dir):
        try:
            variables = load_params(ckpt_dir)
            logger.info("restored params from %s", ckpt_dir)
            return variables
        except Exception as e:  # a corrupted file -> re-init
            logger.warning("restore failed (%s); falling back to init", e)
    if os.environ.get("PDF_TABLE_TPU_ALLOW_RANDOM_INIT", "") != "quiet":
        logger.warning(
            "[%s] no converted weights at %r - running with RANDOM weights "
            "(outputs will be garbage); convert a checkpoint with "
            "python -m pdf_table_tpu_torch.convert", task_name or "task",
            ckpt_dir)
    return init_fn()


def _set(tree: Dict[str, Any], path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _normal(rng: np.random.Generator, shape, fan_in: int,
            gain: float = 1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * np.sqrt(gain / fan_in)) \
        .astype(np.float32)


def _set_batch_norm(params, stats, path, c: int) -> None:
    _set(params, path + ("scale",), np.ones((c,), np.float32))
    _set(params, path + ("bias",), np.zeros((c,), np.float32))
    _set(stats, path + ("mean",), np.zeros((c,), np.float32))
    _set(stats, path + ("var",), np.ones((c,), np.float32))


def _init_dla(model: nn.Module, seed: int) -> Dict[str, Any]:
    """The tree of a model over the DLA trunk or LORE's ResNet detector:
    conv and transposed-conv kernels (``conv_offset_mask`` zero), biases
    zero but ``hm_out``'s -2.19, dense and embedding tables, BatchNorm,
    he-normal DCN weights, the bilinear upsample kernels and RefNorm."""
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def normal(shape, fan_in, gain=1.0):
        return _normal(rng, shape, fan_in, gain)

    for mname, mod in model.named_modules():
        path = tuple(mname.split(".")) if mname else ()
        name = path[-1] if path else ""
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            if isinstance(mod, nn.Conv2d):
                o, i, kh, kw = mod.weight.shape
            else:
                i, o, kh, kw = mod.weight.shape
            kern = np.zeros((kh, kw, i, o), np.float32) \
                if name == "conv_offset_mask" else \
                normal((kh, kw, i, o), kh * kw * i)
            _set(params, path + ("kernel",), kern)
            if mod.bias is not None:
                b = np.full((o,), -2.19 if name == "hm_out" else 0.0,
                            np.float32)
                _set(params, path + ("bias",), b)
        elif isinstance(mod, nn.Linear):
            o, i = mod.weight.shape
            _set(params, path + ("kernel",), normal((i, o), i))
            _set(params, path + ("bias",), np.zeros((o,), np.float32))
        elif isinstance(mod, nn.Embedding):
            v, d = mod.weight.shape
            _set(params, path + ("embedding",), normal((v, d), v))
        elif isinstance(mod, BatchNorm):
            _set_batch_norm(params, stats, path, mod.weight.shape[0])
        elif isinstance(mod, DeformConvBlock):
            kh, kw, i, o = mod.weight.shape
            _set(params, path + ("weight",),
                 normal((kh, kw, i, o), kh * kw * i, gain=2.0))
            _set(params, path + ("bias",), np.zeros((o,), np.float32))
        elif isinstance(mod, DepthwiseUpsample) and mod.factor != 1:
            c, _, k, _ = mod.weight.shape
            base = bilinear_up_kernel(mod.factor).numpy()
            _set(params, path + ("kernel",), np.ascontiguousarray(
                np.broadcast_to(base[:, :, None, None], (k, k, 1, c))))
        elif isinstance(mod, RefNorm):
            _set(params, path + ("alpha",), np.ones((mod.dim,), np.float32))
            _set(params, path + ("bias",), np.zeros((mod.dim,), np.float32))
    return {"params": params, "batch_stats": stats}


def init_lore(cfg: LoreConfig, seed: int = 0) -> Dict[str, Any]:
    """The LORE tree, for either detector (``cfg.backbone``)."""
    from ..models.lore.model import LoreModel

    with torch.device("meta"):
        model = LoreModel(cfg)
    return _init_dla(model, seed)


def init_centernet(cfg: CenterNetConfig, seed: int = 0) -> Dict[str, Any]:
    """The Cycle-CenterNet tree: the DLA trunk and its four heads."""
    from ..models.center_net.model import CycleCenterNet

    with torch.device("meta"):
        model = CycleCenterNet(cfg)
    return _init_dla(model, seed)


def init_docx_layout(cfg: DocXLayoutConfig, seed: int = 0
                     ) -> Dict[str, Any]:
    """The DocXLayout tree: the DLA trunk and its six layout heads."""
    from ..models.docx_layout.model import DocXLayoutModel

    with torch.device("meta"):
        model = DocXLayoutModel(cfg)
    return _init_dla(model, seed)


LSTM_GATES = "ifgo"


def _init_lstm(rng, params, path, mod: nn.LSTM) -> None:
    """flax's two ``OptimizedLSTMCell`` of a bidirectional ``nn.LSTM``
    named ``lstm``: under its parent, ``fwd_cell`` / ``bwd_cell`` with
    input gates ``i{g}`` (kernel) and hidden gates ``h{g}`` (kernel,
    bias)."""
    n_in, h = mod.input_size, mod.hidden_size
    for cell in ("fwd_cell", "bwd_cell"):
        for g in LSTM_GATES:
            _set(params, path[:-1] + (cell, f"i{g}", "kernel"),
                 _normal(rng, (n_in, h), n_in))
            _set(params, path[:-1] + (cell, f"h{g}", "kernel"),
                 _normal(rng, (h, h), h))
            _set(params, path[:-1] + (cell, f"h{g}", "bias"),
                 np.zeros((h,), np.float32))


def _init_modules(model: nn.Module, seed: int) -> Dict[str, Any]:
    """The tree of a model built from convs (kernels (kh, kw, In/groups,
    Out)), transposed convs (kernels (kh, kw, In, Out)), dense layers
    (kernels (In, Out)), BatchNorm, LayerNorm, bidirectional LSTMs,
    PReLU and the raw parameters of ConvNext blocks, the ViT position
    table and the depthwise 2x2 upsample; biases zero."""
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for mname, mod in model.named_modules():
        path = tuple(mname.split(".")) if mname else ()
        if isinstance(mod, nn.LSTM):
            _init_lstm(rng, params, path, mod)
        elif isinstance(mod, PReLU):
            _set(params, path + ("negative_slope",), np.float32(0.25))
        elif isinstance(mod, ConvNextBlock):
            _set(params, path + ("gamma",),
                 np.full(mod.gamma.shape, 1e-6, np.float32))
        elif isinstance(mod, ConvNextViTBackbone):
            _set(params, path + ("pos_embed",), (rng.standard_normal(
                tuple(mod.pos_embed.shape)) * 0.02).astype(np.float32))
        elif isinstance(mod, DwPwConvTranspose):
            c = mod.depthwise_bias.shape[0]
            _set(params, path + ("depthwise_kernel",),
                 _normal(rng, (2, 2, c), 4, gain=2.0))
            _set(params, path + ("depthwise_bias",),
                 np.zeros((c,), np.float32))
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            if isinstance(mod, nn.Conv2d):
                o, i, kh, kw = mod.weight.shape
            else:
                i, o, kh, kw = mod.weight.shape
            _set(params, path + ("kernel",),
                 _normal(rng, (kh, kw, i, o), kh * kw * i))
            if mod.bias is not None:
                _set(params, path + ("bias",), np.zeros((o,), np.float32))
        elif isinstance(mod, nn.Linear):
            o, i = mod.weight.shape
            _set(params, path + ("kernel",), _normal(rng, (i, o), i))
            _set(params, path + ("bias",), np.zeros((o,), np.float32))
        elif isinstance(mod, nn.LayerNorm):
            c = mod.weight.shape[0]
            _set(params, path + ("scale",), np.ones((c,), np.float32))
            _set(params, path + ("bias",), np.zeros((c,), np.float32))
        elif isinstance(mod, BatchNorm):
            _set_batch_norm(params, stats, path, mod.weight.shape[0])
    return {"params": params, "batch_stats": stats}


def init_dbnet(cfg: DbNetConfig, seed: int = 0, train: bool = False
               ) -> Dict[str, Any]:
    """The DBNet tree, for every backbone: conv and transposed-conv
    kernels, SE biases zero, BatchNorm leaves; the NAS slopes and the
    depthwise upsample's kernels and biases. ``train`` adds the ``thresh``
    head, as JAX's ``init(..., train=True)`` does."""
    from ..models.dbnet.model import DBNet

    with torch.device("meta"):
        model = DBNet(cfg, train=train)
    return _init_modules(model, seed)


def init_rec(cfg: RecConfig, seed: int = 0) -> Dict[str, Any]:
    """The CTC recognizer's tree, for every backbone: conv kernels, SE
    biases, dense kernels and biases, LayerNorm and BatchNorm leaves; the
    LSTM cells, ConvNext ``gamma``, the ViT position table and the NAS
    slopes."""
    from ..models.rec_ctc.model import CTCRecModel

    with torch.device("meta"):
        model = CTCRecModel(cfg)
    return _init_modules(model, seed)


def init_cls(cfg: ClsPulcConfig, seed: int = 0) -> Dict[str, Any]:
    """The PP-LCNet classifier's tree."""
    from ..models.cls.model import PPLCNetClassifier

    with torch.device("meta"):
        model = PPLCNetClassifier(cfg)
    return _init_modules(model, seed)


def init_lgpma(cfg: LgpmaConfig, seed: int = 0) -> Dict[str, Any]:
    """The LGPMA tree: the ResNet, FPN, RPN, the dense bbox head and the
    mask heads (the LPMA upsample a transposed conv)."""
    from ..models.lgpma.model import LGPMA

    with torch.device("meta"):
        model = LGPMA(cfg)
    return _init_modules(model, seed)


def init_picodet(cfg: PicoDetConfig, seed: int = 0) -> Dict[str, Any]:
    """The PicoDet layout model's tree: conv kernels, SE and head biases
    zero, BatchNorm leaves."""
    from ..models.picodet.model import PicoDet

    with torch.device("meta"):
        model = PicoDet(cfg)
    return _init_modules(model, seed)


def _init_flat(tree: Dict[str, Any], module: nn.Module, prefix: tuple,
               rng: np.random.Generator) -> None:
    """The flax-layout leaves of ``module``'s own raw parameters (the
    SLANet head's and the TableMaster decoder's): (in, out) matrices
    xavier-uniform, ``*embed`` tables normal(0.02), LayerNorm scales
    (``*_ln{i}s``, ``fnorm_s``) 1, other vectors 0."""
    for name, p in module.named_parameters(recurse=False):
        shape = tuple(p.shape)
        if len(shape) == 2 and "embed" in name:
            a = rng.standard_normal(shape) * 0.02
        elif len(shape) == 2:
            limit = np.sqrt(6.0 / (shape[0] + shape[1]))
            a = rng.uniform(-limit, limit, shape)
        elif name == "fnorm_s" or ("_ln" in name and name.endswith("s")):
            a = np.ones(shape)
        else:
            a = np.zeros(shape)
        _set(tree["params"], prefix + (name,), a.astype(np.float32))


def init_slanet(cfg: SLANetConfig, seed: int = 0) -> Dict[str, Any]:
    """The SLANet tree: the PicoDet LCNet and CSP-PAN leaves, the head's
    flat parameters."""
    from ..models.slanet.model import SLANet

    with torch.device("meta"):
        model = SLANet(cfg)
    tree = _init_modules(model, seed)
    _init_flat(tree, model.head, ("head",),
               np.random.default_rng([seed, 1]))
    return tree


def init_table_master(cfg: TableMasterConfig, seed: int = 0
                      ) -> Dict[str, Any]:
    """The TableMaster / MtlTabNet tree: the encoder's convs, BatchNorm and
    context-block LayerNorms, ``mem_proj`` where C != D, the decoder's flat
    parameters (the cell branch's too for ``variant="mtl_tabnet"`` with a
    ``cell_vocab_size``)."""
    from ..models.table_master.model import TableMaster

    with torch.device("meta"):
        model = TableMaster(cfg)
    tree = _init_modules(model, seed)
    _init_flat(tree, model, (), np.random.default_rng([seed, 1]))
    return tree


def set_batch_norm_scale(variables: Dict[str, Any], value: float
                         ) -> Dict[str, Any]:
    """Copy of ``variables`` with every BatchNorm ``scale`` set to
    ``value``. Calibrated at scale 1, a deep stack of random convs (PicoDet:
    some 60 layers) is chaotic: f32 rounding grows to 1e-3 of the heads,
    and two f32 runs that sum in another order disagree by that much; at
    0.2 they agree to 1e-6."""
    out: Dict[str, Any] = {}
    for path, arr in tree_leaves(variables):
        a = np.asarray(arr, np.float32)
        if path[0] == "params" and path[-1] == "scale" \
                and ("bn",) == path[-2:-1]:
            a = np.full_like(a, value)
        _set(out, path, a)
    return out


def scale_batch_variances(variables: Dict[str, Any], gain: float
                          ) -> Dict[str, Any]:
    """Copy of ``variables`` with every BatchNorm ``var`` times ``gain``.
    Calibrated as is, a deep random ReLU stack with residual blocks (DLA,
    TableMaster's encoder) amplifies f32 rounding layer by layer (1e-4 of
    the output between two f32 runs); with larger variances every residual
    branch is damped (TableMaster's encoder at 480x480: 1e-5 from XLA's
    with the variances doubled, 4e-6 at 4x)."""
    out: Dict[str, Any] = {}
    for path, arr in tree_leaves(variables):
        a = np.asarray(arr, np.float32)
        if path[0] == "batch_stats" and path[-1] == "var":
            a = a * np.float32(gain)
        _set(out, path, a)
    return out


def calibrate_batch_stats(model: nn.Module, variables: Dict[str, Any],
                          sample: torch.Tensor) -> Dict[str, Any]:
    """Copy of ``variables`` whose BatchNorm ``mean``/``var`` are the
    statistics of each layer's own input on ``sample`` (one forward of
    ``model``, which is left holding the result). Seeded kernels with the
    init's 0/1 statistics shrink the signal layer by layer (hardswish
    halves small values), until the output no longer depends on the input;
    with these statistics every layer sees unit-scale activations, as a
    trained network does."""
    from ..convert.flax_bridge import load_flax_variables

    load_flax_variables(model, variables)
    out: Dict[str, Any] = {}
    for path, arr in tree_leaves(variables):
        _set(out, path, np.asarray(arr, np.float32))

    def hook(path):
        def fn(mod, args):
            x = args[0].float()
            dims = [d for d in range(x.dim()) if d != 1]
            mean, var = x.mean(dims), x.var(dims, unbiased=False)
            mod.running_mean.copy_(mean)
            mod.running_var.copy_(var)
            _set(out, ("batch_stats",) + path + ("mean",),
                 mean.cpu().numpy())
            _set(out, ("batch_stats",) + path + ("var",), var.cpu().numpy())
        return fn

    handles = [m.register_forward_pre_hook(hook(tuple(name.split("."))))
               for name, m in model.named_modules()
               if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model.eval()(sample)
    finally:
        for h in handles:
            h.remove()
    return out


# noise scale of perturb_conv_offset_mask: kernel std gain / sqrt(fan_in),
# and the bias std in feature-map px (offsets reach a few px)
OFFSET_KERNEL_GAIN = 0.5
OFFSET_BIAS_STD = 1.5


def perturb_conv_offset_mask(variables: Dict[str, Any], seed: int = 0
                             ) -> Dict[str, Any]:
    """Copy of ``variables`` with seeded noise on every DCN
    ``conv_offset_mask`` kernel and bias. The init zeroes them, so every
    deform conv would sample integer points only; with the noise offsets
    reach a few pixels, out-of-bounds samples included, and the bilinear
    path runs."""
    rng = np.random.default_rng(seed)
    out: Dict[str, Any] = {}
    for path, arr in tree_leaves(variables):
        a = np.asarray(arr, np.float32)
        if "conv_offset_mask" in path:
            if path[-1] == "kernel":
                fan_in = a.shape[0] * a.shape[1] * a.shape[2]
                a = a + (rng.standard_normal(a.shape) * OFFSET_KERNEL_GAIN
                         / np.sqrt(fan_in)).astype(np.float32)
            else:
                a = a + (rng.standard_normal(a.shape)
                         * OFFSET_BIAS_STD).astype(np.float32)
        _set(out, path, a)
    return out
