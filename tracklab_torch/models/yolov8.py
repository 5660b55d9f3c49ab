"""YOLOv8 detector in PyTorch (counterpart of tracklab_tpu.models.yolov8).

C2f backbone with SPPF, the PAN neck, and the decoupled anchor-free head
that regresses per-side distance distributions (DFL over ``reg_max`` bins)
beside class logits. Submodules are named as ultralytics names them
(``model.0.conv.weight`` .. ``model.22.cv3.2.2.bias``), so an ultralytics
state dict loads once its ``model.22.dfl.`` projection is dropped
(``models/convert.py:convert_yolov8_torch``): the DFL projection is the
fixed ``arange(reg_max)`` kernel, computed as math in :func:`decode_v8`.

Public layout is the JAX package's: ``forward`` takes NHWC images scaled to
[0, 1] and returns NHWC per-level maps; inside, tensors are NCHW in
channels-last memory. BN runs in f32 with eps 1e-3 (``models/yolox.py``'s
``ConvBnAct``). Every convolution is plain torch (cuDNN on the card): the
JAX package runs none of this model in a Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tracklab_torch.device import resolve_device
from tracklab_torch.models.yolox import ConvBnAct, _PredConv

__all__ = ["YOLOv8", "YOLOV8_VARIANTS", "decode_v8", "Bottleneck", "C2f",
           "SPPF", "make_divisible_width"]

# depth_mult, width_mult, max_channels
YOLOV8_VARIANTS = {
    "n": dict(d=0.33, w=0.25, mc=1024),
    "s": dict(d=0.33, w=0.50, mc=1024),
    "m": dict(d=0.67, w=0.75, mc=768),
    "l": dict(d=1.00, w=1.00, mc=512),
    "x": dict(d=1.00, w=1.25, mc=512),
}


def make_divisible_width(c, w, mc):
    """ultralytics make_divisible(min(c, max_channels) * width, 8)."""
    return max(math.ceil(min(c, mc) * w / 8) * 8, 8)


def _n(n, d):
    return max(int(round(n * d)), 1)


class Bottleneck(nn.Module):
    """Two 3x3 convs (hidden width ``int(cout * e)``), residual when the
    widths match."""

    def __init__(self, cin, cout, shortcut=True, e=1.0, dtype=torch.float32):
        super().__init__()
        hidden = int(cout * e)
        self.cv1 = ConvBnAct(cin, hidden, 3, dtype=dtype)
        self.cv2 = ConvBnAct(hidden, cout, 3, dtype=dtype)
        self.add = shortcut and cin == cout

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """cv1 to 2c channels, split in halves, n bottlenecks chained on the
    second half, every part concatenated into cv2. ``block(c)`` builds an
    inner block (YOLO11's C3k2 passes its own)."""

    def __init__(self, cin, cout, n=1, shortcut=True, e=0.5,
                 dtype=torch.float32, block=None):
        super().__init__()
        self.c = c = int(cout * e)
        self.cv1 = ConvBnAct(cin, 2 * c, 1, dtype=dtype)
        self.cv2 = ConvBnAct((2 + n) * c, cout, 1, dtype=dtype)
        block = block or (lambda c_: Bottleneck(c_, c_, shortcut, 1.0,
                                                dtype=dtype))
        self.m = nn.ModuleList(block(c) for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """cv1 to half width, three chained 5x5 max pools, concat, cv2."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        c = cin // 2
        self.cv1 = ConvBnAct(cin, c, 1, dtype=dtype)
        self.cv2 = ConvBnAct(4 * c, cout, 1, dtype=dtype)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.cv2(torch.cat(pools, dim=1))


def up2(x):
    """Nearest-neighbour x2 upsampling (``jax.image.resize`` "nearest")."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class _YOLOBase(nn.Module):
    """What YOLOv8 and YOLO11 share: NHWC in and out, ``predict``, seeded
    weights and the device."""

    def _finish(self, device):
        self.eval()
        self.to(resolve_device(device))

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return [m.permute(0, 2, 3, 1) for m in self._maps(x)]

    @torch.no_grad()
    def predict(self, images):
        """(B, H, W, 3) images in [0, 1] -> decoded (B, A, 5 + C)."""
        return decode_v8(self(images), self.num_classes, self.reg_max)

    @torch.no_grad()
    def randomize_(self, seed: int = 0):
        """Seeded random weights: He-normal convs (std sqrt(2 / fan_in)),
        identity BN, zero biases, drawn on the CPU so a seed gives the same
        weights on every device. (YOLOX's lecun-normal draw leaves this
        deeper SiLU stack's class scores within 1e-4 of 0.5; He-normal
        spreads them over about 0.49-0.51.)"""
        g = torch.Generator().manual_seed(seed)
        for name, t in self.state_dict().items():
            if t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=g)
                        * math.sqrt(2.0 / t[0].numel()))
            elif name.endswith(("running_var", "bn.weight")):
                t.fill_(1.0)
            else:
                t.zero_()
        return self


class YOLOv8(_YOLOBase):
    """Full detector on ``device`` (``cuda`` unless told otherwise)."""

    def __init__(self, num_classes: int = 80, variant: str = "n",
                 reg_max: int = 16, dtype=torch.float32, device=None):
        super().__init__()
        v = YOLOV8_VARIANTS[variant]
        d, w, mc = v["d"], v["w"], v["mc"]
        ch = lambda c: make_divisible_width(c, w, mc)  # noqa: E731
        n = lambda k: _n(k, d)  # noqa: E731
        kw = dict(dtype=dtype)
        self.num_classes, self.reg_max, self.dtype = num_classes, reg_max, \
            dtype
        m = {
            "0": ConvBnAct(3, ch(64), 3, 2, **kw),
            "1": ConvBnAct(ch(64), ch(128), 3, 2, **kw),
            "2": C2f(ch(128), ch(128), n(3), **kw),
            "3": ConvBnAct(ch(128), ch(256), 3, 2, **kw),
            "4": C2f(ch(256), ch(256), n(6), **kw),
            "5": ConvBnAct(ch(256), ch(512), 3, 2, **kw),
            "6": C2f(ch(512), ch(512), n(6), **kw),
            "7": ConvBnAct(ch(512), ch(1024), 3, 2, **kw),
            "8": C2f(ch(1024), ch(1024), n(3), **kw),
            "9": SPPF(ch(1024), ch(1024), **kw),
            "12": C2f(ch(1024) + ch(512), ch(512), n(3), False, **kw),
            "15": C2f(ch(512) + ch(256), ch(256), n(3), False, **kw),
            "16": ConvBnAct(ch(256), ch(256), 3, 2, **kw),
            "18": C2f(ch(256) + ch(512), ch(512), n(3), False, **kw),
            "19": ConvBnAct(ch(512), ch(512), 3, 2, **kw),
            "21": C2f(ch(512) + ch(1024), ch(1024), n(3), False, **kw),
            "22": DetectV8((ch(256), ch(512), ch(1024)), num_classes,
                           reg_max, **kw),
        }
        self.model = nn.ModuleDict(m)
        self._finish(device)

    def _maps(self, x):
        m = self.model
        x = m["1"](m["0"](x))
        x = m["3"](m["2"](x))
        p3 = m["4"](x)
        p4 = m["6"](m["5"](p3))
        p5 = m["9"](m["8"](m["7"](p4)))
        u4 = m["12"](torch.cat([up2(p5), p4], dim=1))
        u3 = m["15"](torch.cat([up2(u4), p3], dim=1))
        d4 = m["18"](torch.cat([m["16"](u3), u4], dim=1))
        d5 = m["21"](torch.cat([m["19"](d4), p5], dim=1))
        return m["22"]((u3, d4, d5))


class DetectV8(nn.Module):
    """The decoupled DFL head. Branch widths come from the FIRST level's
    channels for every level (ultralytics Detect.__init__)."""

    def __init__(self, chs, num_classes, reg_max=16, dtype=torch.float32):
        super().__init__()
        c_reg = max(16, chs[0] // 4, reg_max * 4)
        c_cls = max(chs[0], min(num_classes, 100))
        self.cv2 = nn.ModuleList(nn.Sequential(
            ConvBnAct(c, c_reg, 3, dtype=dtype),
            ConvBnAct(c_reg, c_reg, 3, dtype=dtype),
            _PredConv(c_reg, 4 * reg_max, dtype)) for c in chs)
        self.cv3 = nn.ModuleList(nn.Sequential(
            ConvBnAct(c, c_cls, 3, dtype=dtype),
            ConvBnAct(c_cls, c_cls, 3, dtype=dtype),
            _PredConv(c_cls, num_classes, dtype)) for c in chs)

    def forward(self, feats):
        return [torch.cat([r(f), c(f)], dim=1)
                for f, r, c in zip(feats, self.cv2, self.cv3)]


def decode_v8(outputs, num_classes, reg_max=16, strides=(8, 16, 32)):
    """Per-level (B, H, W, 4 reg_max + C) maps -> (B, A, 5 + C) f32
    [xywh, obj = 1, class scores] in input pixels: the (xywh, obj, cls)
    layout ``ops/nms.py:postprocess_detections`` reads (YOLOv8 has no
    objectness branch, so obj is 1). Anchors sit at cell centres."""
    decoded = []
    bins = torch.arange(reg_max, dtype=torch.float32,
                        device=outputs[0].device)
    for out, stride in zip(outputs, strides):
        b, h, w, _ = out.shape
        out = out.float()
        reg = out[..., :4 * reg_max].reshape(b, h, w, 4, reg_max)
        dist = (torch.softmax(reg, dim=-1) * bins).sum(-1)
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=out.device) + 0.5,
            torch.arange(w, dtype=torch.float32, device=out.device) + 0.5,
            indexing="ij")
        x1 = (gx - dist[..., 0]) * stride
        y1 = (gy - dist[..., 1]) * stride
        x2 = (gx + dist[..., 2]) * stride
        y2 = (gy + dist[..., 3]) * stride
        box = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                          dim=-1)
        obj = torch.ones((b, h, w, 1), dtype=torch.float32, device=out.device)
        cls = torch.sigmoid(out[..., 4 * reg_max:])
        decoded.append(torch.cat([box, obj, cls], dim=-1)
                       .reshape(b, h * w, 5 + num_classes))
    return torch.cat(decoded, dim=1)
