"""KPR, keypoint promptable part-based ReID, in PyTorch (counterpart of
tracklab_tpu.models.kpr).

A promptable ViT backbone (patch conv, a zero-initialised dense prompt conv
over the keypoint prompt channels, class token, positional embedding,
optional SIE camera embedding, pre-norm blocks, final LayerNorm) feeds the
BPBReID part head (pixel classifier over K + 1 maps, GAP / GWAP pooling,
four dim-reduce layers, four BatchNorms, per-part visibility).

Module attribute names follow the JAX package's flax names with '__' as
'.', so ``state_dict()`` keys are those of ``_kpr_torch_key`` and
``models.convert.kpr_from_flax`` loads a flax tree with ``strict=True``.
Public layout is the JAX package's: NHWC images and prompt maps.

Dtype rule (flax promotion in the JAX model): parameters are f32; Linear
and conv layers cast input, weight and bias to the model dtype; LayerNorm
computes in f32 and returns f32; the pixel classifier's softmax is f32;
BatchNorm computes in f32 and returns the model dtype.

Attention: every ``_Attention`` calls kernel K4's wrapper
(``kernels/vit_attention.py``) in the softmax mode of the JAX lowering that
``attn_impl`` names: ``naive``, ``einsum`` and ``einsumT`` take logits and
softmax in the compute dtype (``softmax="compute"``), ``dpa`` and ``pallas``
take the softmax in f32. On CUDA the wrapper launches K4 in that mode, on the
CPU it runs the mode's plain version (``vit_attention_compute_plain`` or
``vit_attention_plain``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tracklab_torch.device import resolve_device
from tracklab_torch.kernels.vit_attention import vit_attention

__all__ = ["KPR", "PromptableViT", "extract_test_embeddings",
           "gaussian_prompt_maps", "PROMPT_GROUPS_CCK6", "ATTN_IMPLS"]

# COCO-17 keypoints -> 6 coarse prompt channels (head, torso, left arm,
# right arm, left leg, right leg); a 7th channel carries negative
# (other-person) keypoints
PROMPT_GROUPS_CCK6: Sequence[Sequence[int]] = (
    (0, 1, 2, 3, 4),
    (5, 6, 11, 12),
    (5, 7, 9),
    (6, 8, 10),
    (11, 13, 15),
    (12, 14, 16),
)
ATTN_IMPLS = ("naive", "dpa", "einsum", "einsumT", "pallas")


def _gelu_erfpoly(x):
    """GELU through the Abramowitz-Stegun 7.1.26 erf polynomial in f32,
    cast back to the input dtype."""
    xf = x.float()
    z = xf * 0.70710678
    t = 1.0 / (1.0 + 0.3275911 * z.abs())
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                - 0.284496736) * t + 0.254829592) * t * torch.exp(-z * z)
    return (xf * 0.5 * (1.0 + torch.sign(z) * y)).to(x.dtype)


_GELU_IMPLS = {
    "erf": lambda x: F.gelu(x, approximate="none"),
    "tanh": lambda x: F.gelu(x, approximate="tanh"),
    "erfpoly": _gelu_erfpoly,
}


class Dense(nn.Linear):
    """``nn.Linear`` with f32 parameters computing in ``dtype`` (flax
    ``nn.Dense(dtype=...)``)."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__(cin, cout)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class PatchConv(nn.Module):
    """A p x p stride-s VALID conv computing in ``dtype``; attribute
    ``proj`` so keys read ``patch_embed.proj.*``."""

    def __init__(self, cin, cout, patch, stride, dtype=torch.float32):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, patch, stride)
        self.dtype = dtype

    def forward(self, x_nhwc):
        dt = self.dtype
        x = x_nhwc.permute(0, 3, 1, 2).to(dt)
        y = F.conv2d(x, self.proj.weight.to(dt), self.proj.bias.to(dt),
                     self.proj.stride)
        return y.flatten(2).transpose(1, 2)            # (B, gh * gw, D)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(epsilon=1e-6)`` without a dtype: f32 result."""

    def __init__(self, d):
        super().__init__(d, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class BatchNorm(nn.Module):
    """Inference flax ``nn.BatchNorm(epsilon=1e-5, dtype=...)`` over the last
    axis, any leading axes: ``(x - mean) * (rsqrt(var + eps) * weight) +
    bias`` in f32, returned in ``dtype``."""

    def __init__(self, c, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.dtype = dtype

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + 1e-5) * self.weight
        return ((x.float() - self.running_mean) * mul
                + self.bias).to(self.dtype)


class _Attention(nn.Module):
    """Multi-head self-attention with the JAX package's five ``impl``
    names. ``n_valid``: static count of real tokens (keys past it are
    masked) when the sequence is padded."""

    def __init__(self, dim, num_heads, dtype=torch.float32, impl="naive",
                 n_valid=None):
        super().__init__()
        if impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                             f"got {impl!r}")
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.num_heads, self.impl, self.n_valid = num_heads, impl, n_valid
        self.softmax = "f32" if impl in ("dpa", "pallas") else "compute"

    def forward(self, x):
        B, N, D = x.shape
        H = self.num_heads
        q, k, v = self.qkv(x).reshape(B, N, 3, H, D // H).unbind(2)
        y = vit_attention(q, k, v, self.n_valid, softmax=self.softmax)
        return self.proj(y.reshape(B, N, D))


class _Mlp(nn.Module):
    def __init__(self, dim, hidden, dtype=torch.float32, gelu="erf"):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype)
        self.fc2 = Dense(hidden, dim, dtype)
        self.gelu = _GELU_IMPLS[gelu]

    def forward(self, x):
        return self.fc2(self.gelu(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, dtype=torch.float32,
                 attn_impl="naive", gelu="erf", n_valid=None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = _Attention(dim, num_heads, dtype, attn_impl, n_valid)
        self.norm2 = LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), dtype, gelu)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PromptableViT(nn.Module):
    """TransReID-style ViT with dense keypoint prompting. ``forward(x,
    prompts=None, cam_id=None)`` on NHWC images (already normalised) and
    (B, H, W, P) prompt maps returns ``(cls_feat (B, D), spatial (B, gh,
    gw, D))``, both f32. ``token_pad`` pads the sequence with zero tokens
    that attention masks out (outputs of the real tokens unchanged)."""

    def __init__(self, img_size=(384, 128), patch_size=16, stride=16,
                 embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0,
                 n_prompt_ch=7, n_cameras=0, dtype=torch.float32,
                 attn_impl="naive", gelu="erf", token_pad=0):
        super().__init__()
        h, w = img_size
        self.grid = ((h - patch_size) // stride + 1,
                     (w - patch_size) // stride + 1)
        n_real = 1 + self.grid[0] * self.grid[1]
        self.n_real = n_real
        self.token_pad = token_pad if token_pad > n_real else 0
        n_valid = n_real if self.token_pad else None
        self.patch_embed = PatchConv(3, embed_dim, patch_size, stride, dtype)
        self.prompt_embed = PatchConv(n_prompt_ch, embed_dim, patch_size,
                                      stride, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_real, embed_dim))
        if n_cameras:
            self.sie_embed = nn.Parameter(torch.zeros(n_cameras, 1,
                                                      embed_dim))
        self.blocks = nn.ModuleList([
            _Block(embed_dim, num_heads, mlp_ratio, dtype, attn_impl, gelu,
                   n_valid) for _ in range(depth)])
        self.norm = LayerNorm(embed_dim)
        self.n_cameras = n_cameras
        self.embed_dim = embed_dim

    def forward(self, x, prompts=None, cam_id=None):
        B = x.shape[0]
        gh, gw = self.grid
        D = self.embed_dim
        tokens = self.patch_embed(x)
        if prompts is not None:
            tokens = tokens + self.prompt_embed(prompts.to(x.dtype))
        cls = self.cls_token.expand(B, 1, D).to(tokens.dtype)
        x = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(tokens.dtype)
        if self.n_cameras:
            cid = (torch.zeros(B, dtype=torch.long, device=x.device)
                   if cam_id is None else cam_id.long())
            x = x + self.sie_embed[cid].to(x.dtype)
        if self.token_pad:
            x = F.pad(x, (0, 0, 0, self.token_pad - self.n_real))
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 0], x[:, 1:self.n_real].reshape(B, gh, gw, D)


def _gwap(feat, attn):
    """Global weighted average pooling: (B, H, W, D) x (B, H, W) -> (B, D)."""
    w = attn[..., None]
    return (feat * w).sum((1, 2)) / (w.sum((1, 2)) + 1e-6)


class KPR(nn.Module):
    """Promptable backbone + BPBReID part head on ``device`` (``cuda``
    unless told otherwise). ``forward(images, prompt_masks=None,
    cam_id=None)`` on NHWC inputs returns the embedding-branch dict of the
    JAX model (inference: BatchNorms use their running statistics); feed
    it to :func:`extract_test_embeddings`."""

    def __init__(self, num_parts=5, dim_reduce_output=512,
                 img_size=(384, 128), patch_size=16, stride=16,
                 embed_dim=768, depth=12, num_heads=12, n_prompt_ch=7,
                 n_cameras=0, dtype=torch.float32, attn_impl="naive",
                 gelu="erf", token_pad=0, device=None):
        super().__init__()
        K, D, red = num_parts, embed_dim, dim_reduce_output
        self.backbone = PromptableViT(
            img_size, patch_size, stride, embed_dim, depth, num_heads,
            n_prompt_ch=n_prompt_ch, n_cameras=n_cameras, dtype=dtype,
            attn_impl=attn_impl, gelu=gelu, token_pad=token_pad)
        self.pixel_classifier = Dense(D, K + 1, dtype)
        self.dim_reduce_global = Dense(D, red, dtype)
        self.dim_reduce_foreground = Dense(D, red, dtype)
        self.dim_reduce_concat_parts = Dense(K * D, red, dtype)
        self.dim_reduce_parts = Dense(D, red, dtype)
        self.bn_global = BatchNorm(red, dtype)
        self.bn_foreground = BatchNorm(red, dtype)
        self.bn_concat_parts = BatchNorm(red, dtype)
        self.bn_parts = BatchNorm(red, dtype)
        self.num_parts, self.n_prompt_ch, self.dtype = K, n_prompt_ch, dtype
        self.img_size = tuple(img_size)
        self.eval()
        self.to(resolve_device(device))

    @torch.no_grad()
    def forward(self, images, prompt_masks=None, cam_id=None):
        K = self.num_parts
        cls_feat, spat = self.backbone(images, prompt_masks, cam_id)
        B = spat.shape[0]
        logits = self.pixel_classifier(spat)
        attn = torch.softmax(logits.float(), dim=-1)
        globl = spat.mean((1, 2))
        foreg = _gwap(spat, 1.0 - attn[..., 0])
        parts = torch.stack([_gwap(spat, attn[..., 1 + k])
                             for k in range(K)], dim=1)      # (B, K, D)
        conct = parts.reshape(B, -1)
        globl = self.dim_reduce_global(globl)
        foreg = self.dim_reduce_foreground(foreg)
        conct = self.dim_reduce_concat_parts(conct)
        parts = self.dim_reduce_parts(parts)
        ones = torch.ones(B, dtype=torch.float32, device=spat.device)
        return {
            "globl": globl, "foreg": foreg, "conct": conct, "parts": parts,
            "bn_globl": self.bn_global(globl),
            "bn_foreg": self.bn_foreground(foreg),
            "bn_conct": self.bn_concat_parts(conct),
            "bn_parts": self.bn_parts(parts),
            "pixels_cls_scores": logits,
            "attn": attn,
            "cls_feat": cls_feat,
            "visibility": {
                "globl": ones,
                "foreg": (1.0 - attn[..., 0]).amax(dim=(1, 2)),
                "conct": ones,
                "parts": attn[..., 1:].amax(dim=(1, 2)),      # (B, K)
            },
        }

    @torch.no_grad()
    def randomize_(self, seed: int = 0):
        """Seeded random weights for runs without a checkpoint: Linear and
        patch-conv weights trunc-normal(0.02) (at two std), the prompt
        conv zero (its flax init), the positional embedding normal(0.02),
        the class token, biases and BatchNorm statistics at their init
        (zeros, unit variance), LayerNorm ones and zeros. Draws on the CPU,
        so a seed gives the same weights on every device."""
        g = torch.Generator().manual_seed(seed)
        for name, t in self.state_dict().items():
            if name.startswith("backbone.prompt_embed."):
                t.zero_()
            elif name.endswith("weight") and t.dim() >= 2:
                w = torch.empty(t.shape)
                nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04,
                                      generator=g)
                t.copy_(w)
            elif name.endswith("pos_embed"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.02)
            elif name.endswith(("running_var", "norm1.weight",
                                "norm2.weight", "norm.weight")) or (
                    name.startswith("bn_") and name.endswith("weight")):
                t.fill_(1.0)
            else:
                t.zero_()
        return self


def extract_test_embeddings(out, test_embeddings=("bn_foreg", "parts"),
                            binary_visibility: bool = True):
    """Stack the configured branches into ``embeddings (B, P, D)`` and
    ``visibility_scores (B, P)`` (1 part for a scalar branch, K for
    'parts'/'bn_parts'); ``binary_visibility`` thresholds the scores at
    0.5 into {0, 1}."""
    embs, viss = [], []
    for name in test_embeddings:
        e = out[name]
        base = name[3:] if name.startswith("bn_") else name
        v = out["visibility"][base]
        if e.dim() == 2:
            e, v = e[:, None, :], v[:, None]
        embs.append(e)
        viss.append(v)
    emb = torch.cat(embs, dim=1)
    vis = torch.cat(viss, dim=1)
    if binary_visibility:
        vis = (vis > 0.5).float()
    return emb, vis


def gaussian_prompt_maps(keypoints_xyc, bbox_ltrb, crop_hw,
                         vis_thresh: float = 0.3, sigma_frac: float = 0.08,
                         negative_kps=None):
    """Keypoints (..., K, 3) with their detection boxes (..., 4), in any
    common frame, -> (..., h, w, 7) float32 cck6 gaussian prompt maps of
    the crop (the last channel from ``negative_kps`` (..., Kn, 3), zero
    when None)."""
    h, w = crop_hw
    kp = keypoints_xyc.float()
    box = bbox_ltrb.float()
    bw = torch.clamp(box[..., 2] - box[..., 0], min=1e-6)
    bh = torch.clamp(box[..., 3] - box[..., 1], min=1e-6)
    sigma = sigma_frac * max(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=kp.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=kp.device)[None, :]

    def kp_mask(k_idx, source, conf_gate):
        x = (source[..., k_idx, 0] - box[..., 0]) / bw * w
        y = (source[..., k_idx, 1] - box[..., 1]) / bh * h
        c = source[..., k_idx, 2]
        d2 = ((xs - x[..., None, None]) ** 2
              + (ys - y[..., None, None]) ** 2)
        m = torch.exp(-d2 / (2.0 * sigma ** 2))
        keep = (c > 0) if conf_gate is None else ((c > 0) & (c >= conf_gate))
        return m * keep[..., None, None]

    zero = torch.zeros(kp.shape[:-2] + (h, w), dtype=torch.float32,
                       device=kp.device)
    channels = []
    K = kp.shape[-2]
    for group in PROMPT_GROUPS_CCK6:
        g = zero
        for k_idx in group:
            if k_idx < K:
                g = torch.maximum(g, kp_mask(k_idx, kp, vis_thresh))
        channels.append(g)
    neg = zero
    if negative_kps is not None:
        negative_kps = negative_kps.float()
        for k_idx in range(negative_kps.shape[-2]):
            neg = torch.maximum(neg, kp_mask(k_idx, negative_kps, None))
    channels.append(neg)
    return torch.stack(channels, dim=-1)

