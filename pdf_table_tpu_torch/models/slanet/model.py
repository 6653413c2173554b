"""SLANet: PP-LCNet trunk + CSP-PAN neck + attention-GRU SLAHead
(counterpart of pdf_table_tpu/models/slanet/model.py).

  backbone  the port's PicoDet ``LCNetBackbone`` (scale 1.0), blocks3..6
            (strides 4/8/16/32)
  neck      the port's PicoDet ``CSPPAN``, out 96 over the 4 levels, no
            extra level
  head      SLAHead: additive attention of the GRU hidden over the
            flattened stride-32 map, a GRU cell fed [context, one-hot of
            the previous token], two-layer structure and loc generators.

The head keeps JAX's flat parameters as raw ``nn.Parameter``s in the flax
layout ((in, out) matrices), so the weight bridge moves them as they are.
The decode runs all ``max_structure_len`` steps, as the JAX scan does: one
step per host iteration, greedy argmax fed back on the device (no sync), or
``teacher_tokens`` shifted right (sos 0) in training mode. ``forward``
takes NHWC images (B, H, W, 3), already normalized. The backbone and neck
compute in ``config.dtype`` (layers.py::cast_model); the memory is cast to
f32 and the head stays f32, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...engine.device import compute_dtype
from ..layers import cast_model
from ..picodet.model import CSPPAN, LCNetBackbone
from .config import SLANetConfig
from .vocab import StructureVocab


class SLAHead(nn.Module):
    """Attention-GRU structure decoder (PaddleOCR SLAHead). The GRU gates
    split as (r, z, c) with ``c = tanh(xc + r * hc)``, ``b_hh`` inside
    ``hc``."""

    # name -> shape as a function of (C, hidden, V, L); matrices (in, out)
    PARAMS = (
        ("attn_i2h", lambda c, h, v, l: (c, h)),
        ("attn_h2h", lambda c, h, v, l: (h, h)),
        ("attn_h2h_b", lambda c, h, v, l: (h,)),
        ("attn_score", lambda c, h, v, l: (h, 1)),
        ("gru_w_ih", lambda c, h, v, l: (c + v, 3 * h)),
        ("gru_w_hh", lambda c, h, v, l: (h, 3 * h)),
        ("gru_b_ih", lambda c, h, v, l: (3 * h,)),
        ("gru_b_hh", lambda c, h, v, l: (3 * h,)),
        ("fc_struct0", lambda c, h, v, l: (h, h)),
        ("fc_struct0_b", lambda c, h, v, l: (h,)),
        ("fc_struct1", lambda c, h, v, l: (h, v)),
        ("fc_struct1_b", lambda c, h, v, l: (v,)),
        ("fc_loc0", lambda c, h, v, l: (h, h)),
        ("fc_loc0_b", lambda c, h, v, l: (h,)),
        ("fc_loc1", lambda c, h, v, l: (h, l)),
        ("fc_loc1_b", lambda c, h, v, l: (l,)),
    )

    def __init__(self, in_ch: int, vocab_size: int, hidden: int,
                 loc_reg_num: int, max_len: int):
        super().__init__()
        self.in_ch, self.vocab_size = in_ch, vocab_size
        self.hidden, self.max_len = hidden, max_len
        for name, shape in self.PARAMS:
            self.register_parameter(name, nn.Parameter(torch.zeros(
                shape(in_ch, hidden, vocab_size, loc_reg_num))))

    def forward(self, feat: torch.Tensor,
                teacher_tokens: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """``feat`` (B, C, H, W) -> structure probabilities (B, T, V) and
        sigmoid locs (B, T, L)."""
        B, C = feat.shape[:2]
        mem = feat.float().permute(0, 2, 3, 1).reshape(B, -1, C)  # (B,HW,C)
        hd = self.hidden
        keys = mem @ self.attn_i2h                       # (B, HW, hd)
        # [ctx, one_hot(tok)] @ w_ih as ctx @ w_ih[:C] + w_ih[C + tok]
        w_ctx, w_tok = self.gru_w_ih[:C], self.gru_w_ih[C:]
        dev = feat.device
        if teacher_tokens is not None:
            toks = torch.cat([torch.zeros((B, 1), dtype=torch.long,
                                          device=dev),
                              teacher_tokens[:, :self.max_len - 1].long()],
                             dim=1)
            steps = toks.shape[1]
        else:
            toks = None
            steps = self.max_len
        logits = torch.empty((B, steps, self.vocab_size), device=dev)
        hiddens = torch.empty((B, steps, hd), device=dev)
        hidden = torch.zeros((B, hd), device=dev)
        tok = torch.zeros((B,), dtype=torch.long, device=dev)   # sos
        for t in range(steps):
            if toks is not None:
                tok = toks[:, t]
            q = torch.addmm(self.attn_h2h_b, hidden, self.attn_h2h)
            e = (torch.tanh(keys + q[:, None]) @ self.attn_score)[..., 0]
            a = torch.softmax(e, dim=-1)
            ctx = torch.bmm(a[:, None], mem)[:, 0]
            gx = torch.addmm(self.gru_b_ih, ctx, w_ctx) + w_tok[tok]
            gh = torch.addmm(self.gru_b_hh, hidden, self.gru_w_hh)
            xr, xz, xc = gx.split(hd, dim=-1)
            hr, hz, hc = gh.split(hd, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            c = torch.tanh(xc + r * hc)
            hidden = z * hidden + (1 - z) * c
            step_logits = torch.addmm(
                self.fc_struct1_b,
                torch.addmm(self.fc_struct0_b, hidden, self.fc_struct0),
                self.fc_struct1)
            logits[:, t] = step_logits
            hiddens[:, t] = hidden
            tok = step_logits.argmax(-1)
        # the loc generator does not feed back: one product for all steps
        locs = torch.sigmoid(
            (hiddens @ self.fc_loc0 + self.fc_loc0_b) @ self.fc_loc1
            + self.fc_loc1_b)
        return {"structure_probs": torch.softmax(logits, dim=-1),
                "loc_preds": locs}


class SLANet(nn.Module):
    def __init__(self, config: SLANetConfig):
        super().__init__()
        cfg = self.config = config
        self.dtype = compute_dtype(cfg.dtype)
        vocab = cfg.vocab_size or len(StructureVocab())
        self.backbone = LCNetBackbone(cfg.lcnet_scale,
                                      out_stages=(3, 4, 5, 6))
        self.neck = CSPPAN(self.backbone.out_channels, cfg.neck_channels,
                           extra_level=False)
        self.head = SLAHead(cfg.neck_channels, vocab, cfg.hidden_size,
                            cfg.loc_reg_num, cfg.max_structure_len)
        cast_model(self.backbone, self.dtype)
        cast_model(self.neck, self.dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> the neck's stride-32 map (B, C, H/32, W/32),
        f32."""
        # NHWC memory read as channels_last
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        return self.neck(self.backbone(x))[-1].float()

    def forward(self, x: torch.Tensor,
                teacher_tokens: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """With ``teacher_tokens`` (B, T) the decoder consumes the
        ground-truth tokens shifted right instead of its own argmax."""
        return self.head(self.encode(x), teacher_tokens=teacher_tokens)
