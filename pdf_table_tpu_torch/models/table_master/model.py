"""TableMaster / MtlTabNet: TableResNetExtra encoder + Master transformer
decoder with a KV-cache greedy decode (counterpart of
pdf_table_tpu/models/table_master/model.py).

Encoder: stride 8, layers [1, 2, 5, 3] of basic blocks, global-context
blocks on layers 2-4. Decoder: N-1 shared pre-norm layers, then forked
``cls`` and ``bbox`` layers that share the final LayerNorm ``fnorm``;
biased q/k/v/o and cross-attention linears, the token embedding scaled by
sqrt(D), interleaved sin/cos positions, LayerNorm eps 1e-5 with the biased
variance. The decoder's parameters are JAX's flat ones, raw
``nn.Parameter``s in the flax layout ((in, out) matrices).

Each step projects only the new token and writes its K/V into per-layer
caches in place (``index_copy_`` at a device-side index, so a step's
shapes never change); the self-attention masks the whole preallocated T
with -1e9 beyond the step, as JAX does. The caches are (B, H, T, Dh),
JAX's (B, T, H, Dh) with the heads first, so that a step's products are
batched matmuls without a copy. Cross-attention K/V over the memory are
computed once per forward. All ``max_structure_len`` steps run; the
argmax feeds back on the device. ``forward`` takes NHWC images, already
normalized. The encoder computes in ``config.dtype``
(layers.py::cast_model); the memory is cast to f32, and the decoder, its
caches and the cell branch stay f32, as in JAX.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...engine.device import compute_dtype
from ..layers import ConvBNAct, LayerNorm, cast_model, softmax
from .config import TableMasterConfig
from .vocab import MasterStructureVocab

LN_EPS = 1e-5
MASK_FILL = -1e9
LAYER_KEYS = ("q", "k", "v", "o", "cq", "ck", "cv", "co", "ff1", "ff2")


def interleaved_positions(length: int, dim: int,
                          device=None) -> torch.Tensor:
    """pe[:, 0::2] = sin, pe[:, 1::2] = cos (the torch convention)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class ContextBlock(nn.Module):
    """Global-context block: attention pooling + channel-add fusion
    (headers 1, ratio 0.0625). ``ca_ln`` normalizes the channels of the
    pooled (B, planes) vector."""

    def __init__(self, channels: int, ratio: float = 0.0625):
        super().__init__()
        planes = int(channels * ratio)
        self.conv_mask = nn.Conv2d(channels, 1, 1)
        self.ca_conv1 = nn.Conv2d(channels, planes, 1)
        self.ca_ln = LayerNorm(planes, eps=LN_EPS)
        self.ca_conv2 = nn.Conv2d(planes, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        attn = softmax(self.conv_mask(x).reshape(b, 1, h * w), dim=-1)
        ctx = torch.bmm(x.reshape(b, c, h * w), attn.transpose(1, 2))
        y = self.ca_conv1(ctx[..., None]).flatten(1)          # (B, planes)
        y = torch.relu(self.ca_ln(y))[:, :, None, None]
        return x + self.ca_conv2(y)


class MasterBasicBlock(nn.Module):
    """BasicBlock with an optional global-context block after bn2."""

    def __init__(self, in_ch: int, features: int, gcb: bool = False):
        super().__init__()
        self.conv1 = ConvBNAct(in_ch, features, (3, 3), act="relu")
        self.conv2 = ConvBNAct(features, features, (3, 3), act=None)
        self.context = ContextBlock(features) if gcb else None
        self.down = ConvBNAct(in_ch, features, (1, 1), act=None) \
            if in_ch != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        if self.context is not None:
            y = self.context(y)
        identity = self.down(x) if self.down is not None else x
        return torch.relu(y + identity)


class TableResNetExtra(nn.Module):
    """Stride-8 conv encoder (layers [1, 2, 5, 3], global context on layers
    2-4); NCHW in, (B, 512, H/8, W/8) out."""

    out_channels = 512

    def __init__(self):
        super().__init__()
        self.c1 = ConvBNAct(3, 64, (3, 3), act="relu")
        self.c2 = ConvBNAct(64, 128, (3, 3), act="relu")
        self.layer1_0 = MasterBasicBlock(128, 256)
        self.c3 = ConvBNAct(256, 256, (3, 3), act="relu")
        for i in range(2):
            setattr(self, f"layer2_{i}", MasterBasicBlock(256, 256, True))
        self.c4 = ConvBNAct(256, 256, (3, 3), act="relu")
        for i in range(5):
            setattr(self, f"layer3_{i}",
                    MasterBasicBlock(256 if i == 0 else 512, 512, True))
        self.c5 = ConvBNAct(512, 512, (3, 3), act="relu")
        for i in range(3):
            setattr(self, f"layer4_{i}", MasterBasicBlock(512, 512, True))
        self.c6 = ConvBNAct(512, 512, (3, 3), act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(self.c2(self.c1(x)), 2)
        x = F.max_pool2d(self.c3(self.layer1_0(x)), 2)
        for i in range(2):
            x = getattr(self, f"layer2_{i}")(x)
        x = F.max_pool2d(self.c4(x), 2)
        for i in range(5):
            x = getattr(self, f"layer3_{i}")(x)
        x = self.c5(x)
        for i in range(3):
            x = getattr(self, f"layer4_{i}")(x)
        return self.c6(x)


def _layer_norm(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), s, b, LN_EPS)


class TableMaster(nn.Module):
    def __init__(self, config: TableMasterConfig):
        super().__init__()
        cfg = self.config = config
        self.dtype = compute_dtype(cfg.dtype)
        V = self.vocab_size = cfg.vocab_size or len(MasterStructureVocab())
        D, FF = cfg.d_model, cfg.ff_dim
        self.encoder = TableResNetExtra()
        cast_model(self.encoder, self.dtype)
        C = TableResNetExtra.out_channels
        self.mem_proj = nn.Linear(C, D) if C != D else None
        self.layer_names = [f"l{i}" for i in range(cfg.decoder_layers - 1)] \
            + ["cls", "bbox"]
        self.cell_branch = (cfg.variant == "mtl_tabnet"
                            and bool(cfg.cell_vocab_size))
        self._param("token_embed", (V, D))
        for name in self.layer_names + (["cell"] if self.cell_branch
                                        else []):
            self._layer_params(name, D, FF)
        self._param("fnorm_s", (D,))
        self._param("fnorm_b", (D,))
        self._param("fc_cls", (D, V))
        self._param("fc_cls_b", (V,))
        self._param("fc_loc", (D, cfg.loc_reg_num))
        self._param("fc_loc_b", (cfg.loc_reg_num,))
        if self.cell_branch:
            Vc = cfg.cell_vocab_size
            self._param("cell_embed", (Vc, D))
            self._param("cell_in", (2 * D, D))
            self._param("cell_in_b", (D,))
            self._param("fc_cell", (D, Vc))
            self._param("fc_cell_b", (Vc,))

    def _param(self, name: str, shape) -> None:
        self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    def _layer_params(self, name: str, D: int, FF: int) -> None:
        """One DecoderLayer's weights: biased self-attention q/k/v/o,
        biased cross-attention q/k/v/o, the FF, three pre-norms."""
        for key in LAYER_KEYS:
            shape = (D, FF) if key == "ff1" else (FF, D) if key == "ff2" \
                else (D, D)
            self._param(f"{name}_{key}", shape)
            self._param(f"{name}_{key}b", (shape[1],))
        for i in (1, 2, 3):
            self._param(f"{name}_ln{i}s", (D,))
            self._param(f"{name}_ln{i}b", (D,))

    def memory(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> the flattened encoder map with positions, (B, S,
        D) f32."""
        feat = self.encoder(x.permute(0, 3, 1, 2).to(self.dtype))
        B, C = feat.shape[:2]
        mem = feat.to(torch.promote_types(feat.dtype, torch.float32)) \
            .permute(0, 2, 3, 1).reshape(B, -1, C)
        mem = mem + interleaved_positions(mem.shape[1], C, mem.device)[None]
        return self.mem_proj(mem) if self.mem_proj is not None else mem

    def _layer(self, name: str, mem: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A layer's weights for the decode: q/k/v fused into one (D, 3D)
        product, the cross-attention K (B, H, Dh, S) and V (B, H, S, Dh)
        over ``mem``."""
        cfg = self.config
        H = cfg.heads
        B, S, D = mem.shape
        p = {k: getattr(self, f"{name}_{k}") for k in
             [*LAYER_KEYS, *(k + "b" for k in LAYER_KEYS),
              "ln1s", "ln1b", "ln2s", "ln2b", "ln3s", "ln3b"]}
        p["qkv"] = torch.cat([p["q"], p["k"], p["v"]], dim=1)
        p["qkvb"] = torch.cat([p["qb"], p["kb"], p["vb"]])
        mk = torch.addmm(p["ckb"], mem.reshape(B * S, D), p["ck"])
        mv = torch.addmm(p["cvb"], mem.reshape(B * S, D), p["cv"])
        # contiguous once here: a permuted view would be copied by every
        # step's matmul (B * S * D floats per layer and step)
        p["mem_kT"] = mk.view(B, S, H, D // H).permute(0, 2, 3, 1) \
            .contiguous()
        p["mem_v"] = mv.view(B, S, H, D // H).transpose(1, 2).contiguous()
        return p

    def _layer_step(self, h: torch.Tensor, p: Dict[str, torch.Tensor],
                    cache: List[torch.Tensor], t_idx: torch.Tensor,
                    future: torch.Tensor) -> torch.Tensor:
        """One token through one DecoderLayer (pre-norm residuals); ``h``
        (..., D), ``cache`` [K, V] (..., H, T, Dh) written at ``t_idx``,
        ``future`` (T,) True beyond the step. Without autograd the caches
        are written in place; under it each write makes new tensors (an
        in-place write would change what earlier steps' products saved
        for their backward)."""
        lead = h.shape[:-1]
        D = h.shape[-1]
        H = self.config.heads
        Dh = D // H
        rs = math.sqrt(Dh)
        y = _layer_norm(h, p["ln1s"], p["ln1b"])
        qkv = y.reshape(-1, D) @ p["qkv"] + p["qkvb"]
        q, k_new, v_new = (t.reshape(*lead, H, 1, Dh)
                           for t in qkv.split(D, dim=-1))
        kc, vc = cache
        tdim = kc.dim() - 2
        if torch.is_grad_enabled():
            kc = cache[0] = kc.index_copy(tdim, t_idx, k_new)
            vc = cache[1] = vc.index_copy(tdim, t_idx, v_new)
        else:
            kc.index_copy_(tdim, t_idx, k_new)
            vc.index_copy_(tdim, t_idx, v_new)
        att = torch.matmul(q, kc.transpose(-1, -2)) / rs
        att = att.masked_fill(future, MASK_FILL)
        sa = torch.matmul(torch.softmax(att, dim=-1), vc).reshape(*lead, D)
        h = h + sa @ p["o"] + p["ob"]
        y = _layer_norm(h, p["ln2s"], p["ln2b"])
        q2 = (y @ p["cq"] + p["cqb"]).reshape(*lead, H, 1, Dh)
        kT, mv = p["mem_kT"], p["mem_v"]
        if len(lead) == 2:          # (B, K) cell slots share the memory
            kT, mv = kT[:, None], mv[:, None]
        ca = torch.softmax(torch.matmul(q2, kT) / rs, dim=-1)
        cv = torch.matmul(ca, mv).reshape(*lead, D)
        h = h + cv @ p["co"] + p["cob"]
        y = _layer_norm(h, p["ln3s"], p["ln3b"])
        return h + torch.relu(y @ p["ff1"] + p["ff1b"]) @ p["ff2"] \
            + p["ff2b"]

    def forward(self, x: torch.Tensor,
                teacher_tokens: Optional[torch.Tensor] = None,
                decode_cells: bool = False) -> Dict[str, torch.Tensor]:
        """NHWC images -> :meth:`decode` of their :meth:`memory`."""
        return self.decode(self.memory(x), teacher_tokens, decode_cells)

    def decode(self, mem: torch.Tensor,
               teacher_tokens: Optional[torch.Tensor] = None,
               decode_cells: bool = False) -> Dict[str, torch.Tensor]:
        """Greedy decode of ``max_structure_len`` steps over ``mem`` (or,
        with ``teacher_tokens`` (B, T), the ground truth shifted right
        after sos): structure probabilities (B, T, V) and sigmoid xywh
        locs (B, T, 4); with ``decode_cells`` (MtlTabNet, ``cell_slots`` >
        0) the cell branch's ids too."""
        cfg = self.config
        D, H, T = cfg.d_model, cfg.heads, cfg.max_structure_len
        Dh = D // H
        B, dev = mem.shape[0], mem.device
        layers = [self._layer(n, mem) for n in self.layer_names]
        shared, cls_p, bbox_p = layers[:-2], layers[-2], layers[-1]
        f = mem.dtype
        caches = [[torch.zeros((B, H, T, Dh), dtype=f, device=dev),
                   torch.zeros((B, H, T, Dh), dtype=f, device=dev)]
                  for _ in layers]
        sos = self.vocab_size - 3
        teach = None
        if teacher_tokens is not None:
            teach = torch.cat([torch.full((B, 1), sos, dtype=torch.long,
                                          device=dev),
                               teacher_tokens[:, :-1].long()], dim=1)
        scale = math.sqrt(D)
        pos_tbl = interleaved_positions(T + 1, D, dev)
        steps = torch.arange(T, device=dev)
        future = steps[None, :] > steps[:, None]                  # (T, T)
        logits = torch.empty((B, T, self.vocab_size), dtype=f, device=dev)
        bbox_h = torch.empty((B, T, D), dtype=f, device=dev)
        hiddens = torch.empty((B, T, D), dtype=f, device=dev) \
            if decode_cells else None
        tok = torch.full((B,), sos, dtype=torch.long, device=dev)
        for t in range(T):
            t_idx = steps[t:t + 1]
            tok_in = teach[:, t] if teach is not None else tok
            h = self.token_embed[tok_in] * scale + pos_tbl[t]
            for p, cache in zip(shared, caches):
                h = self._layer_step(h, p, cache, t_idx, future[t])
            ch = self._layer_step(h, cls_p, caches[-2], t_idx, future[t])
            bh = self._layer_step(h, bbox_p, caches[-1], t_idx, future[t])
            step_logits = _layer_norm(ch, self.fnorm_s, self.fnorm_b) \
                @ self.fc_cls + self.fc_cls_b
            logits[:, t] = step_logits
            bbox_h[:, t] = bh
            if hiddens is not None:
                hiddens[:, t] = h
            tok = step_logits.argmax(-1)
        # the bbox fork does not feed back: one product for all steps
        locs = torch.sigmoid(_layer_norm(bbox_h, self.fnorm_s, self.fnorm_b)
                             @ self.fc_loc + self.fc_loc_b)
        out = {"structure_probs": torch.softmax(logits, dim=-1),
               "loc_preds": locs}
        if decode_cells and self.cell_branch and cfg.cell_slots:
            out.update(self._decode_cells(hiddens, logits.argmax(-1), mem))
        return out

    def _decode_cells(self, hs: torch.Tensor, ids: torch.Tensor,
                      mem: torch.Tensor) -> Dict[str, object]:
        """Greedy cell-content decode for K fixed td slots, all B * K cells
        in one KV-cache loop: each slot takes the structure decoder's
        hidden at its td token."""
        cfg = self.config
        D, H = cfg.d_model, cfg.heads
        Dh = D // H
        K, Tc = cfg.cell_slots, cfg.max_cell_len
        B, T = ids.shape
        Vc = cfg.cell_vocab_size
        td = cfg.td_token_ids or (2, 8)
        sos_c, eos_c = Vc - 3, Vc - 2
        dev = hs.device

        is_td = torch.zeros((B, T), dtype=torch.bool, device=dev)
        for t in td:
            is_td |= ids == t
        pos = torch.arange(T, device=dev)
        key = torch.where(is_td, pos[None], torch.full_like(pos, T + 1))
        order = torch.argsort(key, dim=1, stable=True)[:, :K]      # (B, K)
        valid = torch.gather(is_td, 1, order)
        x_i = torch.gather(hs, 1, order[..., None].expand(B, K, D))

        p = self._layer("cell", mem)
        pe = interleaved_positions(Tc, D, dev)
        scale = math.sqrt(D)
        steps = torch.arange(Tc, device=dev)
        future = steps[None, :] > steps[:, None]
        cache = [torch.zeros((B, K, H, Tc, Dh), device=dev),
                 torch.zeros((B, K, H, Tc, Dh), device=dev)]
        tok = torch.full((B, K), sos_c, dtype=torch.long, device=dev)
        cell_ids = torch.empty((B, K, Tc), dtype=torch.long, device=dev)
        for t in range(Tc):
            emb = self.cell_embed[tok] * scale + pe[t]
            h = torch.cat([emb, x_i], -1) @ self.cell_in + self.cell_in_b
            h = self._layer_step(h, p, cache, steps[t:t + 1], future[t])
            step_logits = _layer_norm(h, self.fnorm_s, self.fnorm_b) \
                @ self.fc_cell + self.fc_cell_b
            tok = step_logits.argmax(-1)
            cell_ids[:, :, t] = tok
        return {"cell_ids": cell_ids, "cell_valid": valid,
                "cell_eos_id": eos_c}
