"""RTMDet detector in PyTorch (counterpart of tracklab_tpu.models.rtmdet).

mmdetection's RTMDet: the CSPNeXt backbone (a 3x3 conv and a 5x5
depthwise-separable conv per block, channel attention per stage), the
CSPNeXtPAFPN neck and the SepBN head (conv kernels shared across levels,
BatchNorm per level), decoded from offset-0 grid points with ReLU-free
distances times the stride. Attribute names follow mmdet's state-dict keys
(``backbone.stage1.1.blocks.0.conv2.depthwise_conv.conv.weight``,
``bbox_head.cls_convs.0.1.bn.running_var``), so an mmdet checkpoint loads
by name (``models/convert.py:convert_rtmdet_torch``). The head keeps one
conv module per level, as mmdet's state dict does; the loaders copy the
shared kernel into each level.

This CSP layer has depthwise 5x5 blocks and channel attention: it is not
YOLOX's dense CSPLayer, and no kernel of the port runs it (the JAX package
has no Pallas kernel on this model). Public layout is the JAX package's:
``forward`` takes NHWC images and returns per-level NHWC (cls, reg) maps.
f32 throughout (the wrapper's precision).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tracklab_torch.device import resolve_device
from tracklab_torch.models.yolox import BatchNorm

__all__ = ["RTMDet", "RTMDET_VARIANTS", "decode_rtmdet"]

RTMDET_VARIANTS = {
    "nano": dict(deepen=0.33, widen=0.25),
    "tiny": dict(deepen=0.167, widen=0.375),
    "s": dict(deepen=0.33, widen=0.5),
    "m": dict(deepen=0.67, widen=0.75),
    "l": dict(deepen=1.0, widen=1.0),
    "x": dict(deepen=1.33, widen=1.25),
}

# (out_channels, num_blocks, add_identity, use_spp) at base scale;
# mmdet cspnext.py arch_settings['P5']
_ARCH = [(128, 3, True, False), (256, 6, True, False),
         (512, 6, True, False), (1024, 3, False, True)]
# flax nn.BatchNorm as the JAX model sets it (momentum 0.9 only matters to
# training, which waits for ROADMAP item 6)
_BN_EPS = 1e-5


def _widen(c, widen):
    return max(int(c * widen), 8)


def _deepen(n, deepen):
    return max(int(round(n * deepen)), 1)


class ConvModule(nn.Module):
    """mmcv ConvModule: conv (no bias) + BN + SiLU (names: conv, bn)."""

    def __init__(self, cin, cout, kernel=3, stride=1, groups=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              groups=groups, bias=False)
        self.bn = BatchNorm(cout, eps=_BN_EPS)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class DWSepConvModule(nn.Module):
    """mmcv DepthwiseSeparableConvModule (names: depthwise_conv,
    pointwise_conv)."""

    def __init__(self, cin, cout, kernel=5):
        super().__init__()
        self.depthwise_conv = ConvModule(cin, cin, kernel, groups=cin)
        self.pointwise_conv = ConvModule(cin, cout, 1)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class CSPNeXtBlock(nn.Module):
    """3x3 conv + 5x5 depthwise-separable conv, with a residual add when
    the widths agree."""

    def __init__(self, c, add_identity=True):
        super().__init__()
        self.conv1 = ConvModule(c, c, 3)
        self.conv2 = DWSepConvModule(c, c, 5)
        self.add_identity = add_identity

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.add_identity else y


class ChannelAttention(nn.Module):
    """Global mean -> 1x1 conv with bias -> hardsigmoid scale (name: fc)."""

    def __init__(self, c):
        super().__init__()
        self.fc = nn.Conv2d(c, c, 1, bias=True)

    def forward(self, x):
        w = self.fc(x.mean(dim=(2, 3), keepdim=True))
        # torch's hardsigmoid, relu6(x + 3) / 6, as the JAX model spells it
        return x * (torch.clamp(w + 3.0, 0.0, 6.0) / 6.0)


class CSPLayer(nn.Module):
    """CSP stage with CSPNeXt blocks and channel attention (names:
    main_conv, short_conv, final_conv, blocks, attention)."""

    def __init__(self, cin, cout, num_blocks, add_identity=True,
                 expand_ratio=0.5):
        super().__init__()
        mid = int(cout * expand_ratio)
        self.main_conv = ConvModule(cin, mid, 1)
        self.short_conv = ConvModule(cin, mid, 1)
        self.blocks = nn.Sequential(*[CSPNeXtBlock(mid, add_identity)
                                      for _ in range(num_blocks)])
        self.attention = ChannelAttention(2 * mid)
        self.final_conv = ConvModule(2 * mid, cout, 1)

    def forward(self, x):
        y = torch.cat([self.blocks(self.main_conv(x)), self.short_conv(x)],
                      dim=1)
        return self.final_conv(self.attention(y))


class SPPBottleneck(nn.Module):
    """Parallel max pools of 5, 9 and 13 (names: conv1, conv2), as the
    exact SPPF cascade of 5x5 pools (-inf padding)."""

    def __init__(self, cin, cout):
        super().__init__()
        mid = cin // 2
        self.conv1 = ConvModule(cin, mid, 1)
        self.conv2 = ConvModule(4 * mid, cout, 1)

    def forward(self, x):
        x = self.conv1(x)
        p5 = F.max_pool2d(x, 5, 1, 2)
        p9 = F.max_pool2d(p5, 5, 1, 2)
        p13 = F.max_pool2d(p9, 5, 1, 2)
        return self.conv2(torch.cat([x, p5, p9, p13], dim=1))


class CSPNeXt(nn.Module):
    """Backbone: a 3-conv stem and 4 stages (``stage{i}``: the stride-2
    conv, the SPP on the last stage, the CSP layer); returns strides 8, 16
    and 32."""

    def __init__(self, deepen, widen):
        super().__init__()
        c0 = _widen(64, widen)
        self.stem = nn.Sequential(ConvModule(3, c0 // 2, 3, 2),
                                  ConvModule(c0 // 2, c0 // 2, 3, 1),
                                  ConvModule(c0 // 2, c0, 3, 1))
        cin = c0
        for i, (c, n, add_id, use_spp) in enumerate(_ARCH):
            cw = _widen(c, widen)
            stage = [ConvModule(cin, cw, 3, 2)]
            if use_spp:
                stage.append(SPPBottleneck(cw, cw))
            stage.append(CSPLayer(cw, cw, _deepen(n, deepen), add_id))
            setattr(self, f"stage{i + 1}", nn.Sequential(*stage))
            cin = cw

    def forward(self, x):
        x = self.stage1(self.stem(x))
        c3 = self.stage2(x)
        c4 = self.stage3(c3)
        return c3, c4, self.stage4(c4)


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class CSPNeXtPAFPN(nn.Module):
    """Neck: top-down and bottom-up CSP paths, then a 3x3 out conv per
    level to a common width."""

    def __init__(self, deepen, widen):
        super().__init__()
        c = [_widen(256, widen), _widen(512, widen), _widen(1024, widen)]
        n = _deepen(3, deepen)
        self.reduce_layers = nn.ModuleList([ConvModule(c[2], c[1], 1),
                                            ConvModule(c[1], c[0], 1)])
        self.top_down_blocks = nn.ModuleList([
            CSPLayer(2 * c[1], c[1], n, add_identity=False),
            CSPLayer(2 * c[0], c[0], n, add_identity=False)])
        self.downsamples = nn.ModuleList([ConvModule(c[0], c[0], 3, 2),
                                          ConvModule(c[1], c[1], 3, 2)])
        self.bottom_up_blocks = nn.ModuleList([
            CSPLayer(2 * c[0], c[1], n, add_identity=False),
            CSPLayer(2 * c[1], c[2], n, add_identity=False)])
        self.out_convs = nn.ModuleList([ConvModule(ci, c[0], 3)
                                        for ci in c])

    def forward(self, feats):
        c3, c4, c5 = feats
        r1 = self.reduce_layers[0](c5)
        td1 = self.top_down_blocks[0](torch.cat([_upsample2(r1), c4], 1))
        r2 = self.reduce_layers[1](td1)
        td2 = self.top_down_blocks[1](torch.cat([_upsample2(r2), c3], 1))
        bu1 = self.bottom_up_blocks[0](torch.cat(
            [self.downsamples[0](td2), r2], 1))
        bu2 = self.bottom_up_blocks[1](torch.cat(
            [self.downsamples[1](bu1), r1], 1))
        return [conv(f) for conv, f in zip(self.out_convs, (td2, bu1, bu2))]


class RTMDetSepBNHead(nn.Module):
    """Anchor-free head: per level, ``stacked_convs`` 3x3 ConvModules on a
    cls and a reg branch (kernels equal across levels, BNs per level), then
    1x1 ``rtm_cls`` / ``rtm_reg`` with bias. Returns per-level (cls_logits,
    reg_raw) NCHW maps."""

    def __init__(self, num_classes, widen, stacked_convs=2, levels=3):
        super().__init__()
        c = _widen(256, widen)

        def branch():
            return nn.ModuleList(
                nn.ModuleList(ConvModule(c, c, 3)
                              for _ in range(stacked_convs))
                for _ in range(levels))
        self.cls_convs = branch()
        self.reg_convs = branch()
        self.rtm_cls = nn.ModuleList(nn.Conv2d(c, num_classes, 1)
                                     for _ in range(levels))
        self.rtm_reg = nn.ModuleList(nn.Conv2d(c, 4, 1)
                                     for _ in range(levels))

    def forward(self, feats):
        outs = []
        for lvl, x in enumerate(feats):
            c, r = x, x
            for conv in self.cls_convs[lvl]:
                c = conv(c)
            for conv in self.reg_convs[lvl]:
                r = conv(r)
            outs.append((self.rtm_cls[lvl](c), self.rtm_reg[lvl](r)))
        return outs


def decode_rtmdet(outputs, strides=(8, 16, 32)):
    """Per-level NHWC (cls_logits, reg_raw) -> (B, A, 5+C) f32 in the
    [xywh, obj=1, cls_probs] layout of ``ops.nms.postprocess_detections``:
    distances = reg * stride from offset-0 grid points, scores =
    sigmoid(cls)."""
    decoded = []
    for (cls_out, reg_out), stride in zip(outputs, strides):
        b, h, w, C = cls_out.shape
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=cls_out.device)
            * stride,
            torch.arange(w, dtype=torch.float32, device=cls_out.device)
            * stride, indexing="ij")
        dist = reg_out.float() * stride
        x1, y1 = gx - dist[..., 0], gy - dist[..., 1]
        x2, y2 = gx + dist[..., 2], gy + dist[..., 3]
        xywh = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                           dim=-1)
        obj = torch.ones((b, h, w, 1), dtype=torch.float32,
                         device=cls_out.device)
        dec = torch.cat([xywh, obj, torch.sigmoid(cls_out.float())], dim=-1)
        decoded.append(dec.reshape(b, h * w, 5 + C))
    return torch.cat(decoded, dim=1)


class RTMDet(nn.Module):
    """The detector on ``device`` (``cuda`` unless told otherwise).
    ``forward`` returns per-level NHWC (cls, reg) maps; ``predict`` the
    decoded (B, A, 5+C)."""

    def __init__(self, num_classes: int = 1, variant: str = "nano",
                 device=None):
        super().__init__()
        v = RTMDET_VARIANTS[variant]
        self.backbone = CSPNeXt(v["deepen"], v["widen"])
        self.neck = CSPNeXtPAFPN(v["deepen"], v["widen"])
        self.bbox_head = RTMDetSepBNHead(num_classes, v["widen"])
        self.eval()
        self.to(resolve_device(device))

    def forward(self, images):
        x = images.float().permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        maps = self.bbox_head(self.neck(self.backbone(x)))
        return [(c.permute(0, 2, 3, 1), r.permute(0, 2, 3, 1))
                for c, r in maps]

    @torch.no_grad()
    def predict(self, images):
        return decode_rtmdet(self(images))

    @torch.no_grad()
    def randomize_(self, seed: int = 0):
        """Seeded random weights: lecun-normal convs (std 1/sqrt(fan_in)),
        identity BN, zero biases, the head's shared kernels drawn once for
        every level; then each level's 1x1 prediction convs scaled to unit
        output on a seeded batch of smooth images (noise upsampled from 8 x
        8), and their distance biases set to 2 (strides). Without that,
        activations shrink about 4x per CSP stage (SiLU
        and the attention's hardsigmoid halve small values) and every score
        is 0.5 with every box empty; BN gains that hold them instead sit on
        a knife edge (1.0 vanishes, 1.3 gives 1e4). Drawn and computed on
        the CPU, so a seed gives the same weights on every device."""
        import copy

        g = torch.Generator().manual_seed(seed)
        cpu = copy.deepcopy(self).cpu()
        for name, t in cpu.state_dict().items():
            if t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=g)
                        / math.sqrt(t[0].numel()))
            elif name.endswith(("running_var", "bn.weight")):
                t.fill_(1.0)
            else:
                t.zero_()
        head = cpu.bbox_head
        for branch in (head.cls_convs, head.reg_convs):
            for lvl in branch[1:]:
                for conv, conv0 in zip(lvl, branch[0]):
                    conv.conv.weight.copy_(conv0.conv.weight)
        hooks = [m.register_forward_hook(
            lambda conv, inp, out: conv.weight.div_(out.std()))
            for m in (*head.rtm_cls, *head.rtm_reg)]
        x = F.interpolate(torch.randn((2, 3, 8, 8), generator=g),
                          size=(128, 128), mode="bilinear",
                          align_corners=False)
        try:
            cpu((x / x.std()).permute(0, 2, 3, 1))
        finally:
            for h in hooks:
                h.remove()
        for conv in head.rtm_reg:
            # distances of about two strides: the decode takes them as
            # they come (no ReLU), and a box with a negative side collapses
            conv.bias.fill_(2.0)
        self.load_state_dict(cpu.state_dict())
        return self
