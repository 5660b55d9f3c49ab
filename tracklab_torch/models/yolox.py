"""YOLOX detector in PyTorch (counterpart of tracklab_tpu.models.yolox).

Module attribute names follow the Megvii layout, so ``state_dict()`` keys
are the official checkpoint's: ``backbone.backbone.*`` for CSPDarknet,
``backbone.*`` for the PAFPN neck and ``head.*``. Public layout is the JAX
package's: ``YOLOX.forward`` takes NHWC images and returns NHWC per-level
maps; inside, tensors are NCHW views in channels-last memory.

Dtype rule (yolox.py:81-89 of the JAX package): convolutions run in the
model dtype, BN and SiLU in f32, and activations between layers are stored
in the model dtype. Parameters stay f32 like the flax params tree; each conv
casts its weight to the model dtype.

On CUDA, dense ``CSPLayer``s at <= 80x80 run as kernel K3
(``kernels/csp.py``) in inference; everything else is plain torch.

Int8 (``models/quantize.py``): ``quant="calib"`` records each dense
convolution's input absmax, ``quant="int8"`` runs it as an s8 x s8 -> s32
product on the calibrated input scale, in inference; depthwise convolutions
and the 1x1 prediction convolutions stay float, and no CSPLayer of a calib
or int8 model takes K3 (the JAX package's ``csp_pallas_supported``: ``quant
is None``).

Training (``models/train.py``): in ``train()`` mode ``BatchNorm`` normalises
with the batch's statistics and updates its running ones as flax's
``nn.BatchNorm(momentum=0.97)`` does, and no ``CSPLayer`` takes K3 (the JAX
package's ``csp_pallas_supported(..., train)`` rule: the kernel folds BN
from running statistics and has no backward).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tracklab_torch.device import resolve_device
from tracklab_torch.models.quantize import (check_mode, quant_conv_int8,
                                            record_absmax)

__all__ = ["YOLOX", "YOLOX_VARIANTS", "decode_outputs", "ConvBnAct",
           "CSPLayer", "BN_EPS", "BN_MOMENTUM"]

YOLOX_VARIANTS = {
    "nano": dict(depth_mult=0.33, width_mult=0.25, depthwise=True),
    "tiny": dict(depth_mult=0.33, width_mult=0.375, depthwise=False),
    "s": dict(depth_mult=0.33, width_mult=0.5, depthwise=False),
    "m": dict(depth_mult=0.67, width_mult=0.75, depthwise=False),
    "l": dict(depth_mult=1.0, width_mult=1.0, depthwise=False),
    "x": dict(depth_mult=1.33, width_mult=1.25, depthwise=False),
}
BN_EPS = 1e-3
BN_MOMENTUM = 0.97   # flax's convention: running = m * running + (1 - m) * batch
CSP_MAX_PIXELS = 80 * 80   # K3's shape rule (csp_pallas_supported)


def _round_width(c, mult, divisor=8):
    return max(int(round(c * mult / divisor)) * divisor, divisor)


def _round_depth(d, mult):
    return max(int(round(d * mult)), 1)


def batch_statistics(bn, x, dims):
    """The statistics a BatchNorm module ``bn`` normalises f32 ``x`` with:
    in ``eval()`` mode its running ones; in ``train()`` mode flax's, the
    batch mean and the biased batch variance over ``dims`` (E[x^2] - E[x]^2
    clipped at 0, flax's fast variance), after moving the running ones by
    ``bn.momentum`` (``running = m * running + (1 - m) * batch``)."""
    if not bn.training:
        return bn.running_mean, bn.running_var
    mean = x.mean(dims)
    var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
    return mean, var


class BatchNorm(nn.Module):
    """Batch norm in f32 with the flax formula ``(x - mean) * (rsqrt(var +
    eps) * weight) + bias``. Holds exactly weight/bias/running_mean/
    running_var (no num_batches_tracked), the keys of the converted
    checkpoints. ``eps`` is the detectors' 1e-3 unless given (flax's default
    BatchNorm uses 1e-5).

    In ``train()`` mode it is flax's ``nn.BatchNorm(use_running_average=
    False, momentum=BN_MOMENTUM)``: the batch mean and the biased batch
    variance, computed as E[x^2] - E[x]^2 clipped at 0 (flax's fast
    variance), and ``running = m * running + (1 - m) * batch`` for both
    statistics. (``F.batch_norm`` updates ``running_var`` with the unbiased
    variance, so it does not match.)"""

    def __init__(self, c, eps=BN_EPS, momentum=BN_MOMENTUM):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps
        self.momentum = momentum

    def forward(self, x):
        x = x.float()
        mean, var = batch_statistics(self, x, (0, 2, 3))
        mul = torch.rsqrt(var + self.eps) * self.weight
        sh = (1, -1, 1, 1)
        return (x - mean.view(sh)) * mul.view(sh) + self.bias.view(sh)


class ConvBnAct(nn.Module):
    """BaseConv: conv (model dtype) + BN + SiLU (f32), output in the model
    dtype.

    ``quant`` (``models/quantize.py``): None; "calib", which records the
    input's absmax in the ``absmax`` buffer; or "int8", an s8 x s8 -> s32
    convolution on the ``ascale`` buffer's input scale outside training. A
    grouped convolution stays float in every mode."""

    def __init__(self, cin, cout, kernel=3, stride=1, groups=1,
                 dtype=torch.float32, quant=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              groups=groups, bias=False)
        self.bn = BatchNorm(cout)
        self.dtype = dtype
        self.quant = check_mode(quant) if groups == 1 else None
        if self.quant == "calib":
            self.register_buffer("absmax", torch.zeros(()), persistent=False)
            self.calib_calls = 0
        elif self.quant == "int8":
            self.register_buffer("ascale", torch.ones(()), persistent=False)

    def conv_any(self, x, weight, stride, padding):
        """This module's convolution of ``x`` with ``weight`` in its quant
        mode: f32 dequantized int8 outside training in "int8", else in the
        model dtype (recording the input's absmax in "calib")."""
        if self.quant == "int8" and not self.training:
            return quant_conv_int8(x, weight, self.ascale, stride, padding)
        if self.quant == "calib":
            record_absmax(self, x)
        return F.conv2d(x.to(self.dtype), weight.to(self.dtype), None,
                        stride, padding, groups=self.conv.groups)

    def forward(self, x):
        y = self.conv_any(x, self.conv.weight, self.conv.stride[0],
                          self.conv.padding[0])
        return F.silu(self.bn(y)).to(self.dtype)


class DWConv(nn.Module):
    def __init__(self, cin, cout, kernel=3, stride=1, dtype=torch.float32,
                 quant=None):
        super().__init__()
        self.dconv = ConvBnAct(cin, cin, kernel, stride, groups=cin,
                               dtype=dtype, quant=quant)
        self.pconv = ConvBnAct(cin, cout, 1, 1, dtype=dtype, quant=quant)

    def forward(self, x):
        return self.pconv(self.dconv(x))


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, shortcut=True, depthwise=False,
                 dtype=torch.float32, quant=None):
        super().__init__()
        conv2 = DWConv if depthwise else ConvBnAct
        self.conv1 = ConvBnAct(cin, cout, 1, dtype=dtype, quant=quant)
        self.conv2 = conv2(cout, cout, 3, 1, dtype=dtype, quant=quant)
        self.use_add = shortcut and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    """conv1 -> n bottlenecks (main), conv2 (short), concat, conv3.

    ``forward`` launches kernel K3 for a CUDA tensor when the layer is dense
    and H*W <= 80*80 (the JAX kernel's shape rules), in inference only: not
    in ``train()`` mode, not when autograd needs a gradient through the
    layer, and not in a calib or int8 model. Otherwise it runs
    :meth:`forward_plain`, the unfused modules, which are also K3's plain
    version."""

    def __init__(self, cin, cout, n=1, shortcut=True, depthwise=False,
                 dtype=torch.float32, quant=None):
        super().__init__()
        hidden = cout // 2
        kw = dict(dtype=dtype, quant=quant)
        self.conv1 = ConvBnAct(cin, hidden, 1, **kw)
        self.conv2 = ConvBnAct(cin, hidden, 1, **kw)
        self.conv3 = ConvBnAct(2 * hidden, cout, 1, **kw)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, depthwise, **kw)
            for _ in range(n)])
        self.shortcut, self.depthwise = shortcut, depthwise
        self.dtype = dtype
        self.quant = check_mode(quant)

    def forward_plain(self, x):
        a = self.m(self.conv1(x))
        b = self.conv2(x)
        return self.conv3(torch.cat([a, b], dim=1))

    def _needs_grad(self, x):
        return torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad
                                   for p in self.parameters()))

    def k3_admits(self, x):
        """Whether K3 may run this layer on ``x`` (the rule of the JAX
        package's ``csp_pallas_supported``): dense, H * W <= 80 * 80,
        inference, no gradient wanted, and not a calib or int8 model."""
        return (not self.depthwise and self.quant is None
                and x.shape[2] * x.shape[3] <= CSP_MAX_PIXELS
                and not self.training and not self._needs_grad(x))

    def forward(self, x):
        if x.is_cuda and self.k3_admits(x):
            from tracklab_torch.kernels.csp import fused_csplayer
            return fused_csplayer(self, x)
        return self.forward_plain(x)


class SPPBottleneck(nn.Module):
    """SPP with the SPPF cascade: the 9x9 and 13x13 max pools as repeated
    5x5 pools (exact with -inf padding)."""

    def __init__(self, cin, cout, dtype=torch.float32, quant=None):
        super().__init__()
        hidden = cin // 2
        self.conv1 = ConvBnAct(cin, hidden, 1, dtype=dtype, quant=quant)
        self.conv2 = ConvBnAct(hidden * 4, cout, 1, dtype=dtype, quant=quant)

    def forward(self, x):
        x = self.conv1(x)
        p5 = F.max_pool2d(x, 5, 1, 2)
        p9 = F.max_pool2d(p5, 5, 1, 2)
        p13 = F.max_pool2d(p9, 5, 1, 2)
        return self.conv2(torch.cat([x, p5, p9, p13], dim=1))


class Focus(nn.Module):
    """Space-to-depth stem, fused: a 3x3 conv over the s2d image is exactly
    a 6x6/stride-2 conv over the raw image with the kernel relaid as
    k6[2a+di, 2b+dj, c, o] = k3[a, b, (di + 2 dj) C + c, o] and padding
    (2, 2). The parameter keeps the checkpoint layout (F, 4C, 3, 3); in a
    calib or int8 model the 6x6 convolution is the quantized one (its
    weight scales are the 3x3 kernel's, the same entries)."""

    def __init__(self, cin, cout, dtype=torch.float32, quant=None):
        super().__init__()
        self.conv = ConvBnAct(cin * 4, cout, 3, 1, dtype=dtype, quant=quant)
        self.cin = cin

    def forward(self, x):
        C, Fo = self.cin, self.conv.conv.weight.shape[0]
        k3 = self.conv.conv.weight.permute(2, 3, 1, 0)      # HWIO
        k6 = (k3.reshape(3, 3, 2, 2, C, Fo).permute(0, 3, 1, 2, 4, 5)
              .reshape(6, 6, C, Fo).permute(3, 2, 0, 1))     # OIHW
        y = self.conv.conv_any(x, k6, 2, 2)
        return F.silu(self.conv.bn(y)).to(self.conv.dtype)


class CSPDarknet(nn.Module):
    def __init__(self, depth_mult, width_mult, depthwise=False,
                 dtype=torch.float32, quant=None):
        super().__init__()
        w = lambda c: _round_width(c, width_mult)  # noqa: E731
        d = lambda n: _round_depth(n, depth_mult)  # noqa: E731
        conv = DWConv if depthwise else ConvBnAct
        kw = dict(dtype=dtype, quant=quant)
        self.stem = Focus(3, w(64), **kw)
        self.dark2 = nn.Sequential(
            conv(w(64), w(128), 3, 2, **kw),
            CSPLayer(w(128), w(128), d(3), depthwise=depthwise, **kw))
        self.dark3 = nn.Sequential(
            conv(w(128), w(256), 3, 2, **kw),
            CSPLayer(w(256), w(256), d(9), depthwise=depthwise, **kw))
        self.dark4 = nn.Sequential(
            conv(w(256), w(512), 3, 2, **kw),
            CSPLayer(w(512), w(512), d(9), depthwise=depthwise, **kw))
        self.dark5 = nn.Sequential(
            conv(w(512), w(1024), 3, 2, **kw),
            SPPBottleneck(w(1024), w(1024), **kw),
            CSPLayer(w(1024), w(1024), d(3), shortcut=False,
                     depthwise=depthwise, **kw))

    def forward(self, x):
        x = self.dark2(self.stem(x))
        c3 = self.dark3(x)
        c4 = self.dark4(c3)
        c5 = self.dark5(c4)
        return c3, c4, c5


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOPAFPN(nn.Module):
    """Megvii's YOLOPAFPN: holds the CSPDarknet as ``backbone`` plus the
    neck layers."""

    def __init__(self, depth_mult, width_mult, depthwise=False,
                 dtype=torch.float32, quant=None):
        super().__init__()
        w = lambda c: _round_width(c, width_mult)  # noqa: E731
        d = lambda n: _round_depth(n, depth_mult)  # noqa: E731
        conv = DWConv if depthwise else ConvBnAct
        kw = dict(dtype=dtype, quant=quant)
        self.backbone = CSPDarknet(depth_mult, width_mult, depthwise, **kw)
        self.lateral_conv0 = ConvBnAct(w(1024), w(512), 1, **kw)
        self.C3_p4 = CSPLayer(w(1024), w(512), d(3), False,
                              depthwise=depthwise, **kw)
        self.reduce_conv1 = ConvBnAct(w(512), w(256), 1, **kw)
        self.C3_p3 = CSPLayer(w(512), w(256), d(3), False,
                              depthwise=depthwise, **kw)
        self.bu_conv2 = conv(w(256), w(256), 3, 2, **kw)
        self.C3_n3 = CSPLayer(w(512), w(512), d(3), False,
                              depthwise=depthwise, **kw)
        self.bu_conv1 = conv(w(512), w(512), 3, 2, **kw)
        self.C3_n4 = CSPLayer(w(1024), w(1024), d(3), False,
                              depthwise=depthwise, **kw)

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        p5 = self.lateral_conv0(c5)
        m4 = self.C3_p4(torch.cat([_upsample2(p5), c4], dim=1))
        p4 = self.reduce_conv1(m4)
        out3 = self.C3_p3(torch.cat([_upsample2(p4), c3], dim=1))
        out4 = self.C3_n3(torch.cat([self.bu_conv2(out3), p4], dim=1))
        out5 = self.C3_n4(torch.cat([self.bu_conv1(out4), p5], dim=1))
        return out3, out4, out5


class _PredConv(nn.Conv2d):
    """1x1 prediction conv with bias, run in the model dtype."""

    def __init__(self, cin, cout, dtype):
        super().__init__(cin, cout, 1)
        self.dtype = dtype

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class YOLOXHead(nn.Module):
    """Per level: a 1x1 stem, two 3x3 convs on each of the class and the
    box branch, and the 1x1 prediction convs (float in every quant
    mode)."""

    def __init__(self, num_classes, width_mult, depthwise=False,
                 dtype=torch.float32, quant=None):
        super().__init__()
        hidden = _round_width(256, width_mult)
        conv = DWConv if depthwise else ConvBnAct
        kw = dict(dtype=dtype, quant=quant)
        self.stems = nn.ModuleList()
        self.cls_convs = nn.ModuleList()
        self.reg_convs = nn.ModuleList()
        self.cls_preds = nn.ModuleList()
        self.reg_preds = nn.ModuleList()
        self.obj_preds = nn.ModuleList()
        for cin in (256, 512, 1024):
            self.stems.append(ConvBnAct(_round_width(cin, width_mult),
                                        hidden, 1, **kw))
            self.cls_convs.append(nn.Sequential(conv(hidden, hidden, 3, 1, **kw),
                                                conv(hidden, hidden, 3, 1, **kw)))
            self.reg_convs.append(nn.Sequential(conv(hidden, hidden, 3, 1, **kw),
                                                conv(hidden, hidden, 3, 1, **kw)))
            self.cls_preds.append(_PredConv(hidden, num_classes, dtype))
            self.reg_preds.append(_PredConv(hidden, 4, dtype))
            self.obj_preds.append(_PredConv(hidden, 1, dtype))

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            s = self.stems[i](x)
            c = self.cls_convs[i](s)
            r = self.reg_convs[i](s)
            outs.append(torch.cat([self.reg_preds[i](r), self.obj_preds[i](r),
                                   self.cls_preds[i](c)], dim=1))
        return outs


def decode_outputs(outputs, apply_sigmoid: bool = True):
    """Per-level (B, H, W, 5+C) maps at strides 8, 16, 32 -> (B, A, 5+C)
    f32 predictions: xywh in input pixels, then the obj/cls scores,
    sigmoided unless ``apply_sigmoid`` is false (the training loss takes
    the logits)."""
    decoded = []
    for out, stride in zip(outputs, (8, 16, 32)):
        b, h, w, ch = out.shape
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=out.device),
            torch.arange(w, dtype=torch.float32, device=out.device),
            indexing="ij")
        out = out.float()
        xy = (out[..., 0:2] + torch.stack([gx, gy], dim=-1)) * stride
        wh = torch.exp(torch.clamp(out[..., 2:4], -10.0, 8.0)) * stride
        rest = torch.sigmoid(out[..., 4:]) if apply_sigmoid else out[..., 4:]
        dec = torch.cat([xy, wh, rest], dim=-1)
        decoded.append(dec.reshape(b, h * w, ch))
    return torch.cat(decoded, dim=1)


class YOLOX(nn.Module):
    """Full detector on ``device`` (``cuda`` unless told otherwise).
    ``forward`` returns raw NHWC per-level maps; ``predict`` returns decoded
    (B, A, 5+C). ``quant``: None, "calib" or "int8" (``models/
    quantize.py``); the parameters and their keys are the same in every
    mode."""

    def __init__(self, num_classes: int = 80, variant: str = "s",
                 dtype=torch.float32, device=None, quant=None):
        super().__init__()
        v = YOLOX_VARIANTS[variant]
        self.backbone = YOLOPAFPN(v["depth_mult"], v["width_mult"],
                                  v["depthwise"], dtype=dtype, quant=quant)
        self.head = YOLOXHead(num_classes, v["width_mult"], v["depthwise"],
                              dtype=dtype, quant=quant)
        self.num_classes = num_classes
        self.dtype = dtype
        self.quant = quant
        self.eval()
        self.to(resolve_device(device))

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        maps = self.head(self.backbone(x))
        return [m.permute(0, 2, 3, 1) for m in maps]

    @torch.no_grad()
    def predict(self, images):
        return decode_outputs(self(images))

    @torch.no_grad()
    def randomize_(self, seed: int = 0):
        """Seeded random weights: lecun-normal convs (std 1/sqrt(fan_in)),
        identity BN, zero biases. Draws on the CPU, so a seed gives the same
        weights on every device."""
        g = torch.Generator().manual_seed(seed)
        for name, t in self.state_dict().items():
            if t.dim() == 4:
                fan_in = t[0].numel()
                t.copy_(torch.randn(t.shape, generator=g) / math.sqrt(fan_in))
            elif name.endswith(("running_var", "bn.weight")):
                t.fill_(1.0)
            else:
                t.zero_()
        return self
