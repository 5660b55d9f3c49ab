"""HF-exact RT-DETR in PyTorch (counterpart of
tracklab_tpu.models.rtdetr_hf): the architecture of HuggingFace's
``RTDetrForObjectDetection`` that the PekingU rtdetr_* checkpoints hold.

- ``ResNetDBackbone``: the deep 3-conv stem and basic or bottleneck layers
  whose stride-2 shortcuts average-pool first (``_avg_pool_ceil2``).
- ``HybridEncoder``: AIFI (post-norm attention, exact GELU) on the
  stride-32 level with 2-D sincos positions, then the CSP-RepVGG FPN and
  PAN.
- ``RTDetrCore``: the encoder memory scored against anchors
  (``_generate_anchors``), two-stage top-k query selection, and the
  decoder (self-attention, ``MSDeformableAttention`` over the three
  levels, FFN) refining the boxes layer by layer through one shared
  ``query_pos_head``.

Attribute names follow the HF state dict (``model.backbone.model.encoder
.stages.0.layers.0.layer.0.convolution.weight``), so a checkpoint loads by
name (``models/convert.py:convert_rtdetr_hf_torch``; the denoising class
table is training-only and unused). Inference only, f32; NHWC images in.

The deformable sampling has no Pallas kernel in the JAX package (its
backends are plain jnp); here it is one ``F.grid_sample`` per level
(bilinear, zero padding, align_corners=False: JAX's ``gather`` backend).
Top-k selections break ties by the lower index, as ``lax.top_k`` does
(stable descending sorts): the order of detections decides tracker slots.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tracklab_torch.device import resolve_device
from tracklab_torch.models.yolox import BatchNorm

__all__ = ["RTDetrHF", "RTDetrHFConfig", "RTDETR_HF_VARIANTS",
           "postprocess_rtdetr", "MSDeformableAttention", "ResNetDBackbone",
           "stable_topk"]


@dataclasses.dataclass(frozen=True)
class RTDetrHFConfig:
    """The RTDetrConfig fields the forward pass depends on (HF
    configuration_rt_detr.py defaults)."""
    num_labels: int = 80
    d_model: int = 256
    num_queries: int = 300
    # backbone (ResNet-D)
    embedding_size: int = 64
    hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 2048)
    depths: Tuple[int, ...] = (3, 4, 6, 3)
    layer_type: str = "bottleneck"          # or "basic"
    downsample_in_bottleneck: bool = False
    # encoder
    encoder_hidden_dim: int = 256
    encoder_in_channels: Tuple[int, ...] = (512, 1024, 2048)
    feat_strides: Tuple[int, ...] = (8, 16, 32)
    encoder_layers: int = 1
    encoder_ffn_dim: int = 1024
    num_attention_heads: int = 8
    encode_proj_layers: Tuple[int, ...] = (2,)
    positional_encoding_temperature: float = 10000.0
    hidden_expansion: float = 1.0
    # decoder
    decoder_layers: int = 6
    decoder_ffn_dim: int = 1024
    decoder_attention_heads: int = 8
    decoder_n_points: int = 4
    num_feature_levels: int = 3
    learn_initial_query: bool = False
    layer_norm_eps: float = 1e-5
    batch_norm_eps: float = 1e-5
    anchor_grid_size: float = 0.05


RTDETR_HF_VARIANTS = {
    # PekingU configs (decoder depth / backbone per released variant)
    "r18vd": dict(embedding_size=64, hidden_sizes=(64, 128, 256, 512),
                  depths=(2, 2, 2, 2), layer_type="basic",
                  encoder_in_channels=(128, 256, 512), decoder_layers=3),
    "r34vd": dict(embedding_size=64, hidden_sizes=(64, 128, 256, 512),
                  depths=(3, 4, 6, 3), layer_type="basic",
                  encoder_in_channels=(128, 256, 512), decoder_layers=4),
    "r50vd": dict(),
    "r101vd": dict(depths=(3, 4, 23, 3), encoder_ffn_dim=2048,
                   encoder_hidden_dim=384),
}


def stable_topk(x, k):
    """``lax.top_k`` over the last axis: the k largest values, ties broken
    by the lower index (``torch.topk`` promises no tie order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


# ---------------------------------------------------------------- backbone

class ConvNorm(nn.Module):
    """conv (no bias) + BN (+ activation). ``names`` are the HF attribute
    names of the two (RTDetrResNetConvLayer: convolution, normalization;
    RTDetrConvNormLayer: conv, norm)."""

    def __init__(self, cin, cout, kernel, stride=1, act=None, eps=1e-5,
                 names=("convolution", "normalization")):
        super().__init__()
        self._names = names
        setattr(self, names[0], nn.Conv2d(cin, cout, kernel, stride,
                                          (kernel - 1) // 2, bias=False))
        setattr(self, names[1], BatchNorm(cout, eps=eps))
        self.act = act

    def forward(self, x):
        x = getattr(self, self._names[1])(getattr(self, self._names[0])(x))
        return x if self.act is None else self.act(x)


def _avg_pool_ceil2(x):
    """The JAX model's 2x2 / stride-2 average pool: an odd map is padded
    with zeros to even and every window divided by 4. torch's
    ``AvgPool2d(2, 2, ceil_mode=True)`` divides an edge window by its
    in-bounds count instead; the two part on odd maps only (a reference
    behaviour kept, ROADMAP section 3)."""
    ph, pw = x.shape[2] % 2, x.shape[3] % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph))
    return F.avg_pool2d(x, 2, 2)


class _AvgPoolCeil2(nn.Module):
    def forward(self, x):
        return _avg_pool_ceil2(x)


class _ShortcutPool(nn.Sequential):
    """HF's ``shortcut = Sequential(AvgPool2d, RTDetrResNetShortCut)``:
    parameters under ``shortcut.1``."""

    def __init__(self, cin, cout):
        super().__init__(_AvgPoolCeil2(), ConvNorm(cin, cout, 1))


class ResNetBasicLayer(nn.Module):
    """RTDetrResNetBasicLayer. ``shortcut``: "none", "proj" (a strided 1x1)
    or "pool_proj" (pool, then a 1x1)."""

    def __init__(self, cin, cout, stride=1, shortcut="none"):
        super().__init__()
        self.layer = nn.Sequential(ConvNorm(cin, cout, 3, stride, F.relu),
                                   ConvNorm(cout, cout, 3, 1))
        self.shortcut = {"none": nn.Identity,
                         "proj": lambda: ConvNorm(cin, cout, 1, stride),
                         "pool_proj": lambda: _ShortcutPool(cin, cout)}[
            shortcut]()

    def forward(self, x):
        return F.relu(self.layer(x) + self.shortcut(x))


class ResNetBottleNeckLayer(nn.Module):
    """RTDetrResNetBottleNeckLayer: stride 2 pools before the (optional)
    projection shortcut; the 3x3 conv carries the stride unless
    ``downsample_in_bottleneck``."""

    def __init__(self, cin, cout, stride=1, downsample_in_bottleneck=False,
                 shortcut_proj=True):
        super().__init__()
        red = cout // 4
        s1, s2 = (stride, 1) if downsample_in_bottleneck else (1, stride)
        self.layer = nn.Sequential(ConvNorm(cin, red, 1, s1, F.relu),
                                   ConvNorm(red, red, 3, s2, F.relu),
                                   ConvNorm(red, cout, 1, 1))
        if stride == 2:
            self.shortcut = (_ShortcutPool(cin, cout) if shortcut_proj
                             else _AvgPoolCeil2())
        else:
            self.shortcut = (ConvNorm(cin, cout, 1, stride) if shortcut_proj
                             else nn.Identity())

    def forward(self, x):
        return F.relu(self.layer(x) + self.shortcut(x))


class _Stage(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class _Embedder(nn.Module):
    def __init__(self, e):
        super().__init__()
        self.embedder = nn.Sequential(ConvNorm(3, e // 2, 3, 2, F.relu),
                                      ConvNorm(e // 2, e // 2, 3, 1, F.relu),
                                      ConvNorm(e // 2, e, 3, 1, F.relu))

    def forward(self, x):
        return F.max_pool2d(self.embedder(x), 3, 2, 1)


class _Encoder(nn.Module):
    def __init__(self, stages):
        super().__init__()
        self.stages = nn.ModuleList(stages)


class ResNetDBackbone(nn.Module):
    """RTDetrResNetBackbone: deep stem + 4 stages; returns the last three
    stages (strides 8, 16, 32) as NCHW maps."""

    def __init__(self, cfg: RTDetrHFConfig):
        super().__init__()
        self.embedder = _Embedder(cfg.embedding_size)
        stages, cin = [], cfg.embedding_size
        for i, (width, depth) in enumerate(zip(cfg.hidden_sizes,
                                               cfg.depths)):
            stride = 1 if i == 0 else 2
            layers = []
            for j in range(depth):
                s = stride if j == 0 else 1
                if cfg.layer_type == "bottleneck":
                    layers.append(ResNetBottleNeckLayer(
                        cin, width, s, cfg.downsample_in_bottleneck,
                        shortcut_proj=cin != width or s != 1))
                else:
                    # the first layer of every stage projects; a change of
                    # width goes through pool + a stride-1 projection
                    sc = ("none" if j else
                          "pool_proj" if cin != width else "proj")
                    layers.append(ResNetBasicLayer(cin, width, s, sc))
                cin = width
            stages.append(_Stage(layers))
        self.encoder = _Encoder(stages)

    def forward(self, x):
        x = self.embedder(x)
        outs = []
        for i, stage in enumerate(self.encoder.stages):
            x = stage(x)
            if i >= 1:
                outs.append(x)
        return outs


class _BackboneWrapper(nn.Module):
    """HF's ``RTDetrConvEncoder``: the backbone under ``model``."""

    def __init__(self, cfg):
        super().__init__()
        self.model = ResNetDBackbone(cfg)

    def forward(self, x):
        return self.model(x)


# ------------------------------------------------------------------ encoder

class MultiheadAttention(nn.Module):
    """RTDetrMultiheadAttention: positions added to q and k only."""

    def __init__(self, dim, heads):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.heads = heads

    def forward(self, hidden, pos=None):
        B, L, dim = hidden.shape
        H, D = self.heads, dim // self.heads
        qk_in = hidden if pos is None else hidden + pos

        def split(x):
            return x.reshape(B, L, H, D).transpose(1, 2)
        q = split(self.q_proj(qk_in) * (D ** -0.5))
        k = split(self.k_proj(qk_in))
        v = split(self.v_proj(hidden))
        attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(B, L, dim))


class EncoderLayer(nn.Module):
    """RTDetrEncoderLayer: post-norm attention and an exact-GELU FFN."""

    def __init__(self, cfg):
        super().__init__()
        d, eps = cfg.encoder_hidden_dim, cfg.layer_norm_eps
        self.self_attn = MultiheadAttention(d, cfg.num_attention_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.encoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, x, pos):
        x = self.self_attn_layer_norm(x + self.self_attn(x, pos))
        y = self.fc2(F.gelu(self.fc1(x)))
        return self.final_layer_norm(x + y)


class _AIFI(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.encoder_layers))


def _conv_norm(cfg, cin, cout, kernel, stride=1, act=True):
    """RTDetrConvNormLayer (names: conv, norm; SiLU or none)."""
    return ConvNorm(cin, cout, kernel, stride, F.silu if act else None,
                    eps=cfg.batch_norm_eps, names=("conv", "norm"))


class RepVggBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        h = int(cfg.encoder_hidden_dim * cfg.hidden_expansion)
        self.conv1 = _conv_norm(cfg, h, h, 3, act=False)
        self.conv2 = _conv_norm(cfg, h, h, 1, act=False)

    def forward(self, x):
        return F.silu(self.conv1(x) + self.conv2(x))


class CSPRepLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg.encoder_hidden_dim
        h = int(d * cfg.hidden_expansion)
        self.conv1 = _conv_norm(cfg, 2 * d, h, 1)
        self.conv2 = _conv_norm(cfg, 2 * d, h, 1)
        self.bottlenecks = nn.Sequential(*[RepVggBlock(cfg)
                                           for _ in range(3)])
        self.conv3 = (_conv_norm(cfg, h, d, 1) if h != d
                      else nn.Identity())

    def forward(self, x):
        return self.conv3(self.bottlenecks(self.conv1(x)) + self.conv2(x))


def _sincos_pos_embed(width, height, embed_dim, temperature, device):
    """build_2d_sincos_position_embedding: an ij-indexed meshgrid of (w,
    h), [sin w, cos w, sin h, cos h]. The rows run over (w, h) while the
    tokens run over (h, w); HF adds them so, and trained weights absorb it."""
    gw, gh = torch.meshgrid(
        torch.arange(width, dtype=torch.float32, device=device),
        torch.arange(height, dtype=torch.float32, device=device),
        indexing="ij")
    pos_dim = embed_dim // 4
    omega = torch.arange(pos_dim, dtype=torch.float32,
                         device=device) / pos_dim
    omega = 1.0 / torch.pow(temperature, omega)
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()],
                     dim=1)[None]


class HybridEncoder(nn.Module):
    """RTDetrHybridEncoder: AIFI on ``encode_proj_layers``, then top-down
    FPN and bottom-up PAN over NCHW maps."""

    def __init__(self, cfg):
        super().__init__()
        d, n = cfg.encoder_hidden_dim, len(cfg.encoder_in_channels) - 1
        self.cfg = cfg
        self.encoder = nn.ModuleList(_AIFI(cfg)
                                     for _ in cfg.encode_proj_layers)
        self.lateral_convs = nn.ModuleList(_conv_norm(cfg, d, d, 1)
                                           for _ in range(n))
        self.fpn_blocks = nn.ModuleList(CSPRepLayer(cfg) for _ in range(n))
        self.downsample_convs = nn.ModuleList(_conv_norm(cfg, d, d, 3, 2)
                                              for _ in range(n))
        self.pan_blocks = nn.ModuleList(CSPRepLayer(cfg) for _ in range(n))

    def forward(self, feats):
        c = self.cfg
        feats = list(feats)
        for i, lvl in enumerate(c.encode_proj_layers):
            b, d, h, w = feats[lvl].shape
            src = feats[lvl].flatten(2).transpose(1, 2)
            pos = _sincos_pos_embed(w, h, c.encoder_hidden_dim,
                                    c.positional_encoding_temperature,
                                    src.device)
            for layer in self.encoder[i].layers:
                src = layer(src, pos)
            feats[lvl] = src.transpose(1, 2).reshape(b, d, h, w)
        n = len(feats) - 1
        fpn = [feats[-1]]
        for idx in range(n):
            top = self.lateral_convs[idx](fpn[-1])
            fpn[-1] = top
            up = F.interpolate(top, scale_factor=2, mode="nearest")
            fpn.append(self.fpn_blocks[idx](
                torch.cat([up, feats[n - idx - 1]], dim=1)))
        fpn = fpn[::-1]
        pan = [fpn[0]]
        for idx in range(n):
            down = self.downsample_convs[idx](pan[-1])
            pan.append(self.pan_blocks[idx](
                torch.cat([down, fpn[idx + 1]], dim=1)))
        return pan


# ------------------------------------------------------------------ decoder

class MSDeformableAttention(nn.Module):
    """RTDetrMultiscaleDeformableAttention: per head, level and point a
    bilinear sample of the value map around the reference box, weighted by
    a softmax over levels x points."""

    def __init__(self, cfg):
        super().__init__()
        d, H = cfg.d_model, cfg.decoder_attention_heads
        L, P = cfg.num_feature_levels, cfg.decoder_n_points
        self.value_proj = nn.Linear(d, d)
        self.sampling_offsets = nn.Linear(d, H * L * P * 2)
        self.attention_weights = nn.Linear(d, H * L * P)
        self.output_proj = nn.Linear(d, d)
        self.heads, self.levels, self.points = H, L, P

    def forward(self, hidden, value_tokens, reference_points,
                spatial_shapes, pos):
        B, Q, d = hidden.shape
        H, L, P = self.heads, self.levels, self.points
        qin = hidden + pos
        value = self.value_proj(value_tokens)
        offsets = self.sampling_offsets(qin).reshape(B, Q, H, L, P, 2)
        weights = torch.softmax(
            self.attention_weights(qin).reshape(B, Q, H, L * P),
            dim=-1).reshape(B, Q, H, L, P)
        # reference_points: (B, Q, 4) normalised cxcywh
        ref = reference_points[:, :, None, None, None]
        loc = ref[..., :2] + offsets / P * ref[..., 2:] * 0.5
        out = sample_deformable(value.reshape(B, -1, H, d // H), loc,
                                weights, spatial_shapes)
        return self.output_proj(out.reshape(B, Q, d))


def sample_deformable(value, loc, weights, spatial_shapes):
    """value (B, S, H, D) over the levels' flattened maps, loc (B, Q, H, L,
    P, 2) in [0, 1] xy, weights (B, Q, H, L, P) -> (B, Q, H, D): per level,
    ``F.grid_sample`` (bilinear, zero padding, align_corners=False) of the
    (B*H, D, h, w) map at (B*H, Q, P, 2) grids, weighted and summed over
    points and levels."""
    B, S, H, D = value.shape
    Q, P = loc.shape[1], loc.shape[4]
    grids = 2.0 * loc - 1.0
    out = value.new_zeros((B * H, D, Q))
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(
            B * H, D, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).reshape(B * H, Q, P, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                          align_corners=False)             # (B*H, D, Q, P)
        wl = weights[:, :, :, lvl].transpose(1, 2).reshape(B * H, 1, Q, P)
        out = out + (s * wl).sum(dim=-1)
        start += h * w
    return out.reshape(B, H, D, Q).permute(0, 3, 1, 2)


class DecoderLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = MultiheadAttention(d, cfg.decoder_attention_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.encoder_attn = MSDeformableAttention(cfg)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.decoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.decoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, hidden, pos, memory, reference_points, spatial_shapes):
        hidden = self.self_attn_layer_norm(
            hidden + self.self_attn(hidden, pos))
        hidden = self.encoder_attn_layer_norm(hidden + self.encoder_attn(
            hidden, memory, reference_points, spatial_shapes, pos))
        y = self.fc2(F.relu(self.fc1(hidden)))
        return self.final_layer_norm(hidden + y)


class MLPHead(nn.Module):
    """RTDetrMLPPredictionHead (names: layers.{i}), ReLU between."""

    def __init__(self, cin, dims):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in
                                    zip((cin,) + tuple(dims[:-1]), dims))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class _Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg.d_model
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.decoder_layers))
        self.query_pos_head = MLPHead(4, (2 * d, d))


def _inverse_sigmoid(x, eps=1e-5):
    x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


def _generate_anchors(spatial_shapes, grid_size, device):
    """RTDetrModel.generate_anchors: (S, 4) logit anchors (float32 max
    where invalid) and the (S, 1) valid mask, built on ``device`` from
    Python scalars (no host copy)."""
    anchors = []
    for level, (h, w) in enumerate(spatial_shapes):
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device),
            indexing="ij")
        xy = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], dim=-1)
        wh = torch.full_like(xy, grid_size * (2.0 ** level))
        anchors.append(torch.cat([xy, wh], dim=-1).reshape(h * w, 4))
    anchors = torch.cat(anchors, dim=0)
    eps = 1e-2
    valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdim=True)
    anchors = torch.log(anchors / (1 - anchors))
    big = torch.finfo(torch.float32).max
    return torch.where(valid, anchors, torch.full_like(anchors, big)), valid


class RTDetrCore(nn.Module):
    """RTDetrModel: backbone, projections, hybrid encoder, two-stage query
    selection and the decoder; the outer module's heads are passed in (HF
    ties ``decoder.bbox_embed``/``class_embed`` to them)."""

    def __init__(self, cfg: RTDetrHFConfig):
        super().__init__()
        d, e = cfg.d_model, cfg.encoder_hidden_dim
        self.cfg = cfg
        self.backbone = _BackboneWrapper(cfg)

        def proj(cin, cout):
            return nn.Sequential(nn.Conv2d(cin, cout, 1, bias=False),
                                 BatchNorm(cout, eps=cfg.batch_norm_eps))
        self.encoder_input_proj = nn.ModuleList(
            proj(c, e) for c in cfg.encoder_in_channels)
        self.encoder = HybridEncoder(cfg)
        self.decoder_input_proj = nn.ModuleList(
            proj(e, d) for _ in cfg.encoder_in_channels)
        self.enc_output = nn.Sequential(
            nn.Linear(d, d), nn.LayerNorm(d, eps=cfg.layer_norm_eps))
        self.enc_score_head = nn.Linear(d, cfg.num_labels)
        self.enc_bbox_head = MLPHead(d, (d, d, 4))
        if cfg.learn_initial_query:
            raise NotImplementedError(
                "learn_initial_query: no RT-DETR variant sets it, and the "
                "JAX package's converters do not map its table")
        self.decoder = _Decoder(cfg)

    def forward(self, images, bbox_heads, class_heads, return_topk=False):
        c = self.cfg
        x = images.float().permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        feats = self.backbone(x)
        proj = [p(f) for p, f in zip(self.encoder_input_proj, feats)]
        sources = [p(f) for p, f in zip(self.decoder_input_proj,
                                        self.encoder(proj))]
        spatial_shapes = [tuple(s.shape[2:]) for s in sources]
        flat = torch.cat([s.flatten(2).transpose(1, 2) for s in sources],
                         dim=1)
        anchors, valid = _generate_anchors(spatial_shapes,
                                           c.anchor_grid_size, flat.device)
        out_mem = self.enc_output(flat * valid.to(flat.dtype))
        enc_class = self.enc_score_head(out_mem)
        enc_coord = self.enc_bbox_head(out_mem) + anchors
        topk = stable_topk(enc_class.amax(dim=-1), c.num_queries)[1]
        ref_unact = torch.gather(enc_coord, 1,
                                 topk[..., None].expand(-1, -1, 4))
        target = torch.gather(out_mem, 1, topk[..., None].expand(
            -1, -1, out_mem.shape[-1]))
        reference_points = torch.sigmoid(ref_unact)
        hidden = target
        logits = boxes = None
        for i, layer in enumerate(self.decoder.layers):
            pos = self.decoder.query_pos_head(reference_points)
            hidden = layer(hidden, pos, flat, reference_points,
                           spatial_shapes)
            reference_points = torch.sigmoid(
                bbox_heads[i](hidden) + _inverse_sigmoid(reference_points))
            logits = class_heads[i](hidden)
            boxes = reference_points
        if return_topk:
            return logits, boxes, topk
        return logits, boxes


class RTDetrHF(nn.Module):
    """RTDetrForObjectDetection's inference path on ``device`` (``cuda``
    unless told otherwise). ``forward`` takes NHWC images (pixels / 255)
    and returns (logits (B, Q, num_labels), boxes (B, Q, 4) normalised
    cxcywh) from the last decoder layer. ``config`` replaces the variant's
    when given."""

    def __init__(self, variant: str = "r50vd", num_labels: int = 80,
                 config: RTDetrHFConfig | None = None, device=None):
        super().__init__()
        cfg = config or RTDetrHFConfig(num_labels=num_labels,
                                       **RTDETR_HF_VARIANTS[variant])
        self.cfg = cfg
        d = cfg.d_model
        self.model = RTDetrCore(cfg)
        self.bbox_embed = nn.ModuleList(MLPHead(d, (d, d, 4))
                                        for _ in range(cfg.decoder_layers))
        self.class_embed = nn.ModuleList(nn.Linear(d, cfg.num_labels)
                                         for _ in range(cfg.decoder_layers))
        self.eval()
        self.to(resolve_device(device))

    def forward(self, images, return_topk: bool = False):
        return self.model(images, self.bbox_embed, self.class_embed,
                          return_topk=return_topk)

    @torch.no_grad()
    def randomize_(self, seed: int = 0):
        """Seeded random weights: lecun-normal convs and linears (std
        1/sqrt(fan_in)), identity BN and LayerNorm, zero biases. Draws on
        the CPU, so a seed gives the same weights on every device."""
        g = torch.Generator().manual_seed(seed)
        norms = {n for n, m in self.named_modules()
                 if isinstance(m, (nn.LayerNorm, BatchNorm))}
        for name, t in self.state_dict().items():
            owner, leaf = name.rpartition(".")[::2]
            if owner in norms:
                t.fill_(1.0 if leaf in ("weight", "running_var") else 0.0)
            elif t.dim() in (2, 4):
                fan_in = t[0].numel()
                t.copy_(torch.randn(t.shape, generator=g) / math.sqrt(fan_in))
            else:
                t.zero_()
        return self


def postprocess_rtdetr(logits, boxes, img_w, img_h, conf_threshold=0.3,
                       max_out=64):
    """RTDetrImageProcessor.post_process_object_detection: sigmoid scores,
    top-k over the flattened Q * num_labels scores (ties to the lower
    index), cxcywh -> ltrb in pixels. Returns (B, max_out) tensors ltrb,
    score, cls (int32), valid: ``ops.nms.postprocess_detections``'s
    contract, NMS-free."""
    B, Q, C = logits.shape
    scores = torch.sigmoid(logits.float()).reshape(B, Q * C)
    top_scores, top_idx = stable_topk(scores, max_out)
    q_idx = torch.div(top_idx, C, rounding_mode="floor")
    cls = (top_idx % C).to(torch.int32)
    b = torch.gather(boxes, 1, q_idx[..., None].expand(-1, -1, 4))
    cx, cy, w, h = b.unbind(-1)
    ltrb = torch.stack([(cx - w / 2) * img_w, (cy - h / 2) * img_h,
                        (cx + w / 2) * img_w, (cy + h / 2) * img_h], dim=-1)
    return {"ltrb": ltrb, "score": top_scores, "cls": cls,
            "valid": top_scores >= conf_threshold}
