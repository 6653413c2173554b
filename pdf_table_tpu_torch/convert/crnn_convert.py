"""CRNN (ModelScope) torch checkpoint -> flax params (a copy of
pdf_table_tpu/convert/crnn_convert.py: numpy only, the same flax-layout
trees).

Source layout (reference model/crnn/modeling_crnn.py:36): conv{0..4}
Sequentials (conv at .0/.3, bn at .1/.4), rnn.0 / rnn.1 BidirectionalLSTM
(bidirectional nn.LSTM ``rnn`` + ``embedding`` Linear), ``cls`` Linear
(no bias). Torch LSTM gates are stacked [i, f, g, o] in weight_ih/weight_hh
(4H, In); flax OptimizedLSTMCell keeps per-gate Dense kernels (In, H) —
i{i,f,g,o} without bias, h{i,f,g,o} with bias = bias_ih + bias_hh.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .torch_to_flax import (ConversionReport, TorchTensorSource,
                            assign_conv_bn, convert_dense)

_GATES = ("i", "f", "g", "o")


def assign_lstm_direction(tree: Dict, src: TorchTensorSource, tprefix: str,
                          suffix: str, rep: ConversionReport) -> None:
    """One LSTM direction -> flax RNN cell subtree {cell: {ii..ho}}."""
    w_ih = src.get(f"{tprefix}.weight_ih_l0{suffix}")
    w_hh = src.get(f"{tprefix}.weight_hh_l0{suffix}")
    b_ih = src.get(f"{tprefix}.bias_ih_l0{suffix}")
    b_hh = src.get(f"{tprefix}.bias_hh_l0{suffix}")
    H = w_hh.shape[1]
    cell = tree
    for k, g in enumerate(_GATES):
        sl = slice(k * H, (k + 1) * H)
        rep.check_assign(cell, [f"i{g}", "kernel"], w_ih[sl].T,
                         f"{tprefix}.weight_ih{suffix}")
        rep.check_assign(cell, [f"h{g}", "kernel"], w_hh[sl].T,
                         f"{tprefix}.weight_hh{suffix}")
        rep.check_assign(cell, [f"h{g}", "bias"], b_ih[sl] + b_hh[sl],
                         f"{tprefix}.bias{suffix}")


def convert_crnn(src: TorchTensorSource, variables: Dict[str, Any],
                 ) -> ConversionReport:
    """Mutates variables in place; CTC head bias (absent in the reference's
    bias-free cls) is zeroed."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    rep = ConversionReport()

    bb = params["backbone"]
    bstats = stats.get("backbone")
    conv_map = [("conv0_0", "conv0.0", "conv0.1"),
                ("conv1_0", "conv1.0", "conv1.1"),
                ("conv2_0", "conv2.0", "conv2.1"),
                ("conv2_3", "conv2.3", "conv2.4"),
                ("conv3_0", "conv3.0", "conv3.1"),
                ("conv3_3", "conv3.3", "conv3.4"),
                ("conv4_0", "conv4.0", "conv4.1")]
    for fname, tconv, tbn in conv_map:
        assign_conv_bn(bb, [fname], src, tconv, tbn, rep, bstats)

    for fl, tl in (("rnn1", "rnn.0"), ("rnn2", "rnn.1")):
        assign_lstm_direction(params[fl]["fwd_cell"], src, f"{tl}.rnn",
                              "", rep)
        assign_lstm_direction(params[fl]["bwd_cell"], src, f"{tl}.rnn",
                              "_reverse", rep)
        w = convert_dense(src.get(f"{tl}.embedding.weight"))
        rep.check_assign(params[fl], ["embedding", "kernel"], w,
                         f"{tl}.embedding")
        rep.check_assign(params[fl], ["embedding", "bias"],
                         src.get(f"{tl}.embedding.bias"), f"{tl}.embedding")

    rep.check_assign(params, ["ctc_head", "kernel"],
                     convert_dense(src.get("cls.weight")), "cls")
    params["ctc_head"]["bias"] = np.zeros_like(
        np.asarray(params["ctc_head"]["bias"]))
    return rep
