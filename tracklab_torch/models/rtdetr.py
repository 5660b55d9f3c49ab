"""The lightweight RT-DETR-style query detector in PyTorch (counterpart of
tracklab_tpu.models.rtdetr).

The port's YOLOX ``CSPDarknet`` (so on the card kernel K3 runs its dense
CSPLayers of 80 x 80 pixels or less), an AIFI encoder layer over the /32
level with a learned position table ``pos5``, a memory of all three levels'
tokens, and ``dec_layers`` decoder layers over learned queries, giving
NMS-free class logits and sigmoid cxcywh boxes. The layers keep flax's
conventions, as the JAX model has them: LayerNorm eps 1e-6, the tanh GELU,
``MultiHeadDotProductAttention`` (q, k, v and out projections with bias, q
scaled by head_dim^-1/2). Weights come from the JAX package's tree through
``models/convert.py:rtdetr_from_flax``. The set loss (``rtdetr_loss``)
waits for training (ROADMAP item 6).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tracklab_torch.device import resolve_device
from tracklab_torch.models.yolox import (YOLOX_VARIANTS, CSPDarknet,
                                         _round_width)

__all__ = ["RTDETR"]

_LN_EPS = 1e-6        # flax nn.LayerNorm's default


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention``: per-head q, k, v projections
    with bias, softmax(q k^T / sqrt(head_dim)) v, an output projection."""

    def __init__(self, dim, heads):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.heads = heads

    def forward(self, q, kv):
        B, Lq, dim = q.shape
        H, D = self.heads, dim // self.heads

        def split(x, L):
            return x.reshape(B, L, H, D).transpose(1, 2)
        q_ = split(self.query(q), Lq) / math.sqrt(D)
        k_ = split(self.key(kv), kv.shape[1])
        v_ = split(self.value(kv), kv.shape[1])
        attn = torch.softmax(q_ @ k_.transpose(-1, -2), dim=-1)
        return self.out((attn @ v_).transpose(1, 2).reshape(B, Lq, dim))


class _FFN(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class EncoderLayer(nn.Module):
    """Post-norm self-attention and FFN."""

    def __init__(self, dim, heads=8):
        super().__init__()
        self.attn = Attention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.ffn = _FFN(dim)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS)

    def forward(self, x):
        x = self.norm1(x + self.attn(x, x))
        return self.norm2(x + self.ffn(x))


class DecoderLayer(nn.Module):
    """Post-norm self-attention, cross-attention over the memory, FFN."""

    def __init__(self, dim, heads=8):
        super().__init__()
        self.self_attn = Attention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.cross_attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.ffn = _FFN(dim)
        self.norm3 = nn.LayerNorm(dim, eps=_LN_EPS)

    def forward(self, q, memory):
        q = self.norm1(q + self.self_attn(q, q))
        q = self.norm2(q + self.cross_attn(q, memory))
        return self.norm3(q + self.ffn(q))


class RTDETR(nn.Module):
    """The detector on ``device`` (``cuda`` unless told otherwise) for
    ``input_size`` (h, w) images, which fixes the length of ``pos5``.
    ``forward`` takes NHWC images (the wrapper feeds pixels / 255) and
    returns (class logits (B, Q, C), boxes (B, Q, 4) cxcywh in [0, 1])."""

    def __init__(self, num_classes: int = 80, num_queries: int = 100,
                 dim: int = 256, dec_layers: int = 3, variant: str = "s",
                 input_size=(640, 640), device=None):
        super().__init__()
        v = YOLOX_VARIANTS[variant]
        self.backbone = CSPDarknet(v["depth_mult"], v["width_mult"],
                                   v["depthwise"])
        w = [_round_width(c, v["width_mult"]) for c in (256, 512, 1024)]
        self.proj3, self.proj4, self.proj5 = (nn.Linear(c, dim) for c in w)
        h5, w5 = -(-input_size[0] // 32), -(-input_size[1] // 32)
        self.pos5 = nn.Parameter(torch.zeros(1, h5 * w5, dim))
        self.encoder = EncoderLayer(dim)
        self.queries = nn.Parameter(torch.zeros(1, num_queries, dim))
        self.decoder = nn.ModuleList(DecoderLayer(dim)
                                     for _ in range(dec_layers))
        self.cls_head = nn.Linear(dim, num_classes)
        self.box_head = nn.Linear(dim, 4)
        self.eval()
        self.to(resolve_device(device))

    def forward(self, images):
        x = images.float().permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        c3, c4, c5 = self.backbone(x)

        def tokens(f, proj):
            return proj(f.flatten(2).transpose(1, 2))
        t5 = self.encoder(tokens(c5, self.proj5) + self.pos5)
        memory = torch.cat([tokens(c3, self.proj3), tokens(c4, self.proj4),
                            t5], dim=1)
        q = self.queries.expand(images.shape[0], -1, -1)
        for layer in self.decoder:
            q = layer(q, memory)
        return self.cls_head(q), torch.sigmoid(self.box_head(q))

    @torch.no_grad()
    def predict(self, images):
        """-> (B, Q, 4) cxcywh in input pixels, (B, Q) scores, (B, Q)
        classes: NMS-free."""
        logits, boxes = self(images)
        H, W = images.shape[1], images.shape[2]
        xywh = torch.stack([boxes[..., 0] * W, boxes[..., 1] * H,
                            boxes[..., 2] * W, boxes[..., 3] * H], dim=-1)
        probs = torch.sigmoid(logits)
        return xywh, probs.amax(dim=-1), torch.argmax(probs, dim=-1)

    @torch.no_grad()
    def randomize_(self, seed: int = 0):
        """Seeded random weights: lecun-normal convs and linears (std
        1/sqrt(fan_in)), identity BN and LayerNorm, zero biases, N(0, 0.02)
        ``pos5`` and ``queries`` (the JAX model's initialisers). Draws on
        the CPU, so a seed gives the same weights on every device."""
        g = torch.Generator().manual_seed(seed)
        for name, t in self.state_dict().items():
            if name in ("pos5", "queries"):
                t.copy_(0.02 * torch.randn(t.shape, generator=g))
            elif t.dim() in (2, 4):
                fan_in = t[0].numel()
                t.copy_(torch.randn(t.shape, generator=g) / math.sqrt(fan_in))
            elif name.endswith(("running_var", "bn.weight")) or (
                    "norm" in name and name.endswith("weight")):
                t.fill_(1.0)
            else:
                t.zero_()
        return self
