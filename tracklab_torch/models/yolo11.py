"""YOLO11 detector in PyTorch (counterpart of tracklab_tpu.models.yolo11).

C3k2 stages (a C2f whose inner blocks are e = 0.5 bottlenecks or C3k
sub-CSPs), SPPF, a C2PSA attention stage after the backbone, the PAN neck
with C3k2 fusion blocks, and the v11 Detect head, whose class branch uses
depthwise-separable pairs. Decoding is ``models/yolov8.py:decode_v8``.
Submodules carry the ultralytics names (``model.0`` .. ``model.23``), so
``models/convert.py:convert_yolov8_torch`` loads yolo11 state dicts too.

C2PSA's attention is plain tensor ops (matmul and softmax in f32), as in the
JAX package, where it is not a Pallas kernel. ``YOLO11Pose`` adds the
ultralytics Pose head's keypoint branch (``model.23.cv4``) on the same
trunk: the bottom-up pose wrapper's ``variant: "11m"``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from tracklab_torch.models.yolov8 import (C2f, SPPF, Bottleneck, _n,
                                          _YOLOBase, decode_v8,
                                          make_divisible_width, up2)
from tracklab_torch.models.yolox import BatchNorm, ConvBnAct, _PredConv

__all__ = ["YOLO11", "YOLO11Pose", "YOLO11_VARIANTS", "C3k", "C3k2",
           "Attention", "PSABlock", "C2PSA", "decode_v11_kpts"]

# depth, width, max_channels; the m/l/x scales force c3k=True in every C3k2
# (ultralytics nn/tasks.py parse_model)
YOLO11_VARIANTS = {
    "n": dict(d=0.50, w=0.25, mc=1024, force_c3k=False),
    "s": dict(d=0.50, w=0.50, mc=1024, force_c3k=False),
    "m": dict(d=0.50, w=1.00, mc=512, force_c3k=True),
    "l": dict(d=1.00, w=1.00, mc=512, force_c3k=True),
    "x": dict(d=1.00, w=1.50, mc=512, force_c3k=True),
}


class C3k(nn.Module):
    """C3 with n kernel-3 bottlenecks (e = 1.0) at half width."""

    def __init__(self, cin, cout, n=2, shortcut=True, dtype=torch.float32):
        super().__init__()
        c = cout // 2
        self.cv1 = ConvBnAct(cin, c, 1, dtype=dtype)
        self.cv2 = ConvBnAct(cin, c, 1, dtype=dtype)
        self.cv3 = ConvBnAct(2 * c, cout, 1, dtype=dtype)
        self.m = nn.Sequential(*[Bottleneck(c, c, shortcut, 1.0, dtype=dtype)
                                 for _ in range(n)])

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class C3k2(C2f):
    """C2f whose inner blocks are C3k (``c3k=True``) or e = 0.5
    bottlenecks."""

    def __init__(self, cin, cout, n=1, c3k=False, e=0.5, shortcut=True,
                 dtype=torch.float32):
        if c3k:
            block = lambda c: C3k(c, c, 2, shortcut, dtype=dtype)  # noqa
        else:
            block = lambda c: Bottleneck(c, c, shortcut, 0.5,  # noqa: E731
                                         dtype=dtype)
        super().__init__(cin, cout, n, shortcut, e, dtype=dtype, block=block)


class ConvBn(nn.Module):
    """ultralytics Conv(act=False): conv (model dtype) + BN (f32), no
    activation, output in the model dtype."""

    def __init__(self, cin, cout, kernel=1, groups=1, dtype=torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, 1, kernel // 2,
                              groups=groups, bias=False)
        self.bn = BatchNorm(cout)
        self.dtype = dtype

    def forward(self, x):
        y = nn.functional.conv2d(x.to(self.dtype),
                                 self.conv.weight.to(self.dtype), None, 1,
                                 self.conv.padding, groups=self.conv.groups)
        return self.bn(y).to(self.dtype)


class Attention(nn.Module):
    """ultralytics Attention: a 1x1 qkv conv, softmax attention over the
    pixels per head, and a depthwise 3x3 positional term on v.

    qkv's channels are per-head blocks [q (kd), k (kd), v (hd)]:
    ``view(B, nh, 2 kd + hd, N)`` of the NCHW map, which is the JAX
    package's ``reshape(B, N, nh, 2 kd + hd)`` of its NHWC map."""

    def __init__(self, dim, num_heads, attn_ratio=0.5, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        h = dim + 2 * self.key_dim * num_heads
        self.qkv = ConvBn(dim, h, 1, dtype=dtype)
        self.proj = ConvBn(dim, dim, 1, dtype=dtype)
        self.pe = ConvBn(dim, dim, 3, groups=dim, dtype=dtype)
        self.dtype = dtype

    def forward(self, x):
        B, C, H, W = x.shape
        N, kd = H * W, self.key_dim
        qkv = self.qkv(x).reshape(B, self.num_heads, 2 * kd + self.head_dim,
                                  N)
        q, k, v = qkv.split([kd, kd, self.head_dim], dim=2)
        attn = torch.matmul(q.float().transpose(-2, -1), k.float()) \
            * (kd ** -0.5)
        attn = torch.softmax(attn, dim=-1)                  # (B, nh, N, N)
        out = torch.matmul(v.float(), attn.transpose(-2, -1))
        out = out.reshape(B, C, H, W).to(self.dtype)
        pe = self.pe(v.reshape(B, C, H, W))
        return self.proj(out + pe)


class PSABlock(nn.Module):
    """Attention and a conv FFN, both residual."""

    def __init__(self, dim, num_heads, dtype=torch.float32):
        super().__init__()
        self.attn = Attention(dim, num_heads, dtype=dtype)
        self.ffn = nn.Sequential(ConvBnAct(dim, 2 * dim, 1, dtype=dtype),
                                 ConvBn(2 * dim, dim, 1, dtype=dtype))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    """A CSP wrapper around n PSABlocks (c1 == c2, e = 0.5)."""

    def __init__(self, c, n=1, dtype=torch.float32):
        super().__init__()
        self.c = h = c // 2
        self.cv1 = ConvBnAct(c, 2 * h, 1, dtype=dtype)
        self.cv2 = ConvBnAct(2 * h, c, 1, dtype=dtype)
        self.m = nn.Sequential(*[PSABlock(h, max(h // 64, 1), dtype=dtype)
                                 for _ in range(n)])

    def forward(self, x):
        y = self.cv1(x)
        a, b = y[:, :self.c], y[:, self.c:]
        return self.cv2(torch.cat([a, self.m(b)], dim=1))


class DetectV11(nn.Module):
    """The v11 Detect head (legacy=False): the regression branch as v8's,
    the class branch two depthwise + pointwise pairs, then 1x1."""

    def __init__(self, chs, num_classes, reg_max=16, dtype=torch.float32):
        super().__init__()
        c2 = max(16, chs[0] // 4, reg_max * 4)
        c3 = max(chs[0], min(num_classes, 100))
        kw = dict(dtype=dtype)
        self.cv2 = nn.ModuleList(nn.Sequential(
            ConvBnAct(c, c2, 3, **kw), ConvBnAct(c2, c2, 3, **kw),
            _PredConv(c2, 4 * reg_max, dtype)) for c in chs)
        self.cv3 = nn.ModuleList(nn.Sequential(
            nn.Sequential(ConvBnAct(c, c, 3, groups=c, **kw),
                          ConvBnAct(c, c3, 1, **kw)),
            nn.Sequential(ConvBnAct(c3, c3, 3, groups=c3, **kw),
                          ConvBnAct(c3, c3, 1, **kw)),
            _PredConv(c3, num_classes, dtype)) for c in chs)

    def forward(self, feats):
        return [torch.cat([r(f), c(f)], dim=1)
                for f, r, c in zip(feats, self.cv2, self.cv3)]


class YOLO11(_YOLOBase):
    """Full detector on ``device`` (``cuda`` unless told otherwise)."""

    def __init__(self, num_classes: int = 80, variant: str = "n",
                 reg_max: int = 16, dtype=torch.float32, device=None):
        super().__init__()
        v = YOLO11_VARIANTS[variant]
        ch = lambda c: make_divisible_width(c, v["w"], v["mc"])  # noqa
        n = lambda k: _n(k, v["d"])  # noqa: E731
        fc = v["force_c3k"]
        kw = dict(dtype=dtype)
        self.num_classes, self.reg_max, self.dtype = num_classes, reg_max, \
            dtype
        m = {
            "0": ConvBnAct(3, ch(64), 3, 2, **kw),
            "1": ConvBnAct(ch(64), ch(128), 3, 2, **kw),
            "2": C3k2(ch(128), ch(256), n(2), fc, 0.25, **kw),
            "3": ConvBnAct(ch(256), ch(256), 3, 2, **kw),
            "4": C3k2(ch(256), ch(512), n(2), fc, 0.25, **kw),
            "5": ConvBnAct(ch(512), ch(512), 3, 2, **kw),
            "6": C3k2(ch(512), ch(512), n(2), True, **kw),
            "7": ConvBnAct(ch(512), ch(1024), 3, 2, **kw),
            "8": C3k2(ch(1024), ch(1024), n(2), True, **kw),
            "9": SPPF(ch(1024), ch(1024), **kw),
            "10": C2PSA(ch(1024), n(2), **kw),
            "13": C3k2(ch(1024) + ch(512), ch(512), n(2), fc, **kw),
            "16": C3k2(ch(512) + ch(512), ch(256), n(2), fc, **kw),
            "17": ConvBnAct(ch(256), ch(256), 3, 2, **kw),
            "19": C3k2(ch(256) + ch(512), ch(512), n(2), fc, **kw),
            "20": ConvBnAct(ch(512), ch(512), 3, 2, **kw),
            "22": C3k2(ch(512) + ch(1024), ch(1024), n(2), True, **kw),
            "23": DetectV11((ch(256), ch(512), ch(1024)), num_classes,
                            reg_max, **kw),
        }
        self.model = nn.ModuleDict(m)
        self._finish(device)

    def _maps(self, x):
        m = self.model
        x = m["3"](m["2"](m["1"](m["0"](x))))
        p3 = m["4"](x)
        p4 = m["6"](m["5"](p3))
        p5 = m["10"](m["9"](m["8"](m["7"](p4))))
        u4 = m["13"](torch.cat([up2(p5), p4], dim=1))
        u3 = m["16"](torch.cat([up2(u4), p3], dim=1))
        d4 = m["19"](torch.cat([m["17"](u3), u4], dim=1))
        d5 = m["22"](torch.cat([m["20"](d4), p5], dim=1))
        return m["23"]((u3, d4, d5))


def decode_v11_kpts(kpt_outs, num_keypoints, strides=(8, 16, 32)):
    """ultralytics ``Pose.kpts_decode``: per-level NHWC (B, h, w, K * 3) raw
    maps -> (B, A, K, 3) keypoints in input pixels: xy = (raw * 2 + anchor -
    0.5) * stride with the anchor at the cell centre (x + 0.5, y + 0.5),
    conf = sigmoid(raw)."""
    out = []
    for kmap, stride in zip(kpt_outs, strides):
        b, h, w, _ = kmap.shape
        k = kmap.float().reshape(b, h * w, num_keypoints, 3)
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=k.device) + 0.5,
            torch.arange(w, dtype=torch.float32, device=k.device) + 0.5,
            indexing="ij")
        anchor = torch.stack([gx, gy], dim=-1).reshape(1, h * w, 1, 2)
        xy = (k[..., :2] * 2.0 + anchor - 0.5) * stride
        out.append(torch.cat([xy, torch.sigmoid(k[..., 2:3])], dim=-1))
    return torch.cat(out, dim=1)


class PoseV11(DetectV11):
    """The v11 Detect head plus the Pose head's keypoint branch ``cv4``:
    two 3x3 convs of max(chs[0] // 4, 3 K) channels and a 1x1 to 3 K
    (keypoint k's x, y, conf at channels 3k, 3k + 1, 3k + 2). Returns
    (detection maps, keypoint maps)."""

    def __init__(self, chs, num_classes, num_keypoints, reg_max=16,
                 dtype=torch.float32):
        super().__init__(chs, num_classes, reg_max, dtype=dtype)
        nk = num_keypoints * 3
        c4 = max(chs[0] // 4, nk)
        kw = dict(dtype=dtype)
        self.cv4 = nn.ModuleList(nn.Sequential(
            ConvBnAct(c, c4, 3, **kw), ConvBnAct(c4, c4, 3, **kw),
            _PredConv(c4, nk, dtype)) for c in chs)

    def forward(self, feats):
        return super().forward(feats), [k(f) for f, k in zip(feats,
                                                             self.cv4)]


class YOLO11Pose(YOLO11):
    """YOLO11 with the ultralytics Pose head (yolo11m-pose.pt's layout, the
    reference's bottom-up pose default). ``forward`` returns NHWC
    (detection maps, keypoint maps); ``predict`` returns (decoded boxes
    (B, A, 5 + C), keypoints (B, A, K, 3) in input pixels)."""

    def __init__(self, num_classes: int = 1, num_keypoints: int = 17,
                 variant: str = "n", reg_max: int = 16, dtype=torch.float32,
                 device=None):
        super().__init__(num_classes, variant, reg_max, dtype, device="cpu")
        chs = [seq[0].conv.weight.shape[1] for seq in self.model["23"].cv2]
        self.model["23"] = PoseV11(chs, num_classes, num_keypoints, reg_max,
                                   dtype)
        self.num_keypoints = num_keypoints
        self._finish(device)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        det, kpt = self._maps(x)
        return ([m.permute(0, 2, 3, 1) for m in det],
                [m.permute(0, 2, 3, 1) for m in kpt])

    @torch.no_grad()
    def predict(self, images):
        """(B, H, W, 3) images in [0, 1] -> (decoded (B, A, 5 + C),
        keypoints (B, A, K, 3))."""
        det, kpt = self(images)
        return (decode_v8(det, self.num_classes, self.reg_max),
                decode_v11_kpts(kpt, self.num_keypoints))
