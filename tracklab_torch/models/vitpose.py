"""ViTPose top-down pose estimator in PyTorch (counterpart of
tracklab_tpu.models.vitpose, the HF ``VitPoseForPoseEstimation``
architecture behind the reference's VitPose wrapper).

A plain ViT encoder (pre-LN blocks, eager attention, exact-erf GELU, LN eps
1e-12) with the MAE-style position embedding quirk ``x + pos[:, 1:] +
pos[:, :1]`` (the CLS slot is added to every token), then the classic
decoder (two ConvTranspose2d(k=4, s=2, p=1) + BN + ReLU blocks and a 1x1
conv) or the simple one (ReLU, 4x bilinear, 3x3 conv). Attention is plain
``torch.matmul`` and ``softmax``: the JAX package computes it outside any
Pallas kernel too.

Submodules carry the HF state-dict names (``backbone.encoder.layer.0.
attention.attention.query.weight``, ``head.deconv1.weight``, ...), so an HF
checkpoint loads as it is (``models/convert.py:convert_vitpose_torch``).
Public layout is NHWC in and out, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tracklab_torch.models.pose import (FLAX_BN_EPS, _Model,
                                        decode_heatmaps)
from tracklab_torch.models.yolox import BatchNorm

__all__ = ["ViTPose", "VITPOSE_VARIANTS"]

VITPOSE_VARIANTS = {
    "tiny": dict(depth=4, dim=192, heads=3),
    "small": dict(depth=8, dim=384, heads=6),
    "base": dict(depth=12, dim=768, heads=12),
    "large": dict(depth=24, dim=1024, heads=16),
}

LN_EPS = 1e-12


class _Linear(nn.Linear):
    """A linear layer run in the model dtype."""

    def __init__(self, cin, cout, dtype):
        super().__init__(cin, cout)
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class _LayerNorm(nn.LayerNorm):
    """LayerNorm in f32 (eps 1e-12), output f32."""

    def __init__(self, dim):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class SelfAttention(nn.Module):
    def __init__(self, dim, heads, dtype):
        super().__init__()
        self.query = _Linear(dim, dim, dtype)
        self.key = _Linear(dim, dim, dtype)
        self.value = _Linear(dim, dim, dtype)
        self.heads = heads

    def forward(self, x):
        B, N, D = x.shape
        hd = D // self.heads

        def split(y):
            return y.reshape(B, N, self.heads, hd).transpose(1, 2)

        q, k, v = (split(f(x)) for f in (self.query, self.key, self.value))
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2))
                             * (hd ** -0.5), dim=-1)
        out = torch.matmul(attn, v)
        return out.transpose(1, 2).reshape(B, N, D)


class AttnOutput(nn.Module):
    def __init__(self, dim, dtype):
        super().__init__()
        self.dense = _Linear(dim, dim, dtype)

    def forward(self, x):
        return self.dense(x)


class Attention(nn.Module):
    def __init__(self, dim, heads, dtype):
        super().__init__()
        self.attention = SelfAttention(dim, heads, dtype)
        self.output = AttnOutput(dim, dtype)

    def forward(self, x):
        return self.output(self.attention(x))


class MLP(nn.Module):
    def __init__(self, dim, dtype):
        super().__init__()
        self.fc1 = _Linear(dim, 4 * dim, dtype)
        self.fc2 = _Linear(4 * dim, dim, dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, dim, heads, dtype):
        super().__init__()
        self.layernorm_before = _LayerNorm(dim)
        self.attention = Attention(dim, heads, dtype)
        self.layernorm_after = _LayerNorm(dim)
        self.mlp = MLP(dim, dtype)

    def forward(self, x):
        x = x + self.attention(self.layernorm_before(x))
        return x + self.mlp(self.layernorm_after(x))


class PatchEmbeddings(nn.Module):
    """The HF patch projection: a patch x patch conv of stride patch with
    padding 2 (the grid is unchanged, the windows shift by 2 px)."""

    def __init__(self, dim, patch, dtype):
        super().__init__()
        self.projection = nn.Conv2d(3, dim, patch, patch, 2)
        self.dtype = dtype

    def forward(self, x):
        p = self.projection
        return F.conv2d(x.to(self.dtype), p.weight.to(self.dtype),
                        p.bias.to(self.dtype), p.stride, p.padding)


class Embeddings(nn.Module):
    def __init__(self, dim, patch, n_tokens, dtype):
        super().__init__()
        self.patch_embeddings = PatchEmbeddings(dim, patch, dtype)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, n_tokens + 1, dim))

    def forward(self, x):
        x = self.patch_embeddings(x)                     # (B, D, gh, gw)
        x = x.flatten(2).transpose(1, 2)                 # (B, N, D)
        pos = self.position_embeddings
        # MAE-compat quirk: the CLS position slot is added to every token
        return x + pos[:, 1:] + pos[:, :1]


class Encoder(nn.Module):
    def __init__(self, depth, dim, heads, dtype):
        super().__init__()
        self.layer = nn.ModuleList(Block(dim, heads, dtype)
                                   for _ in range(depth))

    def forward(self, x):
        for blk in self.layer:
            x = blk(x)
        return x


class Backbone(nn.Module):
    def __init__(self, depth, dim, heads, patch, grid, dtype):
        super().__init__()
        self.embeddings = Embeddings(dim, patch, grid[0] * grid[1], dtype)
        self.encoder = Encoder(depth, dim, heads, dtype)
        self.layernorm = _LayerNorm(dim)
        self.grid = grid

    def forward(self, x):
        B = x.shape[0]
        x = self.layernorm(self.encoder(self.embeddings(x)))
        gh, gw = self.grid
        return x.transpose(1, 2).reshape(B, -1, gh, gw)   # (B, D, gh, gw)


class ClassicDecoder(nn.Module):
    """2 x (ConvTranspose2d k4 s2 p1, no bias, + BN (eps 1e-5) + ReLU),
    then a 1x1 conv."""

    def __init__(self, dim, num_keypoints, dtype):
        super().__init__()
        self.deconv1 = nn.ConvTranspose2d(dim, 256, 4, 2, 1, bias=False)
        self.batchnorm1 = BatchNorm(256, eps=FLAX_BN_EPS)
        self.deconv2 = nn.ConvTranspose2d(256, 256, 4, 2, 1, bias=False)
        self.batchnorm2 = BatchNorm(256, eps=FLAX_BN_EPS)
        self.conv = nn.Conv2d(256, num_keypoints, 1)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        for de, bn in ((self.deconv1, self.batchnorm1),
                       (self.deconv2, self.batchnorm2)):
            x = F.relu(bn(F.conv_transpose2d(x.to(dt), de.weight.to(dt),
                                             None, 2, 1)))
        return F.conv2d(x.to(dt), self.conv.weight.to(dt),
                        self.conv.bias.to(dt))


class SimpleDecoder(nn.Module):
    """ReLU -> 4x bilinear (half-pixel centres) -> 3x3 conv."""

    def __init__(self, dim, num_keypoints, dtype):
        super().__init__()
        self.conv = nn.Conv2d(dim, num_keypoints, 3, 1, 1)
        self.dtype = dtype

    def forward(self, x):
        x = F.interpolate(F.relu(x.float()), scale_factor=4, mode="bilinear",
                          align_corners=False)
        dt = self.dtype
        return F.conv2d(x.to(dt), self.conv.weight.to(dt),
                        self.conv.bias.to(dt), 1, 1)


class ViTPose(_Model):
    """Crops (B, H, W, 3) scaled to [0, 1] -> heatmaps (B, H/4, W/4, K).
    ``input_size`` (H, W) fixes the token grid (H // patch, W // patch) and
    so the position embeddings' length."""

    def __init__(self, num_keypoints: int = 17, variant: str = "small",
                 patch: int = 16, simple_decoder: bool = False,
                 input_size=(256, 192), dtype=torch.float32, device=None):
        super().__init__()
        v = VITPOSE_VARIANTS[variant]
        grid = (input_size[0] // patch, input_size[1] // patch)
        self.backbone = Backbone(v["depth"], v["dim"], v["heads"], patch,
                                 grid, dtype)
        head = SimpleDecoder if simple_decoder else ClassicDecoder
        self.head = head(v["dim"], num_keypoints, dtype)
        self.num_keypoints, self.dtype = num_keypoints, dtype
        self._finish(device)

    def forward(self, crops):
        x = crops.permute(0, 3, 1, 2)
        return self.head(self.backbone(x)).permute(0, 2, 3, 1)

    @torch.no_grad()
    def predict_keypoints(self, crops):
        """(B, H, W, 3) crops scaled to [0, 1] -> (B, K, 3) keypoints in
        crop pixels."""
        hm = self(crops)
        kp = decode_heatmaps(torch.sigmoid(hm.float()))
        stride = crops.shape[1] / hm.shape[1]
        return torch.cat([kp[..., :2] * stride, kp[..., 2:]], dim=-1)
