"""Pose estimation models in PyTorch (counterpart of
tracklab_tpu.models.pose).

* :class:`TopDownPose`: crop -> CSPDarknet /32 -> three stride-2 deconvs ->
  heatmaps at /4, decoded by :func:`decode_heatmaps` (the RTMPose role:
  per-detection crops in, (K, 3) keypoints out).
* :class:`SimCCPose`: the same backbone with a SimCC head (x and y bin
  vectors, :func:`decode_simcc`).
* :class:`YOLOXPose`: YOLOX with an extra per-anchor keypoint branch (the
  RTMO role): one pass over the full image gives boxes and keypoints.

Public layout is the JAX package's: ``forward`` takes NHWC images and
returns NHWC maps; inside, tensors are NCHW in channels-last memory. The
backbones are the port's ``CSPDarknet`` / ``YOLOPAFPN``, so on CUDA every
dense CSPLayer of <= 80 x 80 runs as kernel K3 (``models/yolox.py``).

The deconvs: flax's ``nn.ConvTranspose(256, (4, 4), strides=2,
padding="SAME")`` (no kernel flip) is a cross-correlation of the input
dilated by 2 and padded by 2 on each side (``lax.conv_transpose``'s SAME
padding for k = 4, s = 2: k + s - 2 = 4, split 2 / 2). torch's
``ConvTranspose2d(k=4, s=2, p=1)`` is the same correlation with padding
k - 1 - p = 2 and its kernel flipped, so the flax kernel K (kh, kw, in, out)
loads as ``K[::-1, ::-1].transpose(2, 3, 0, 1)``
(``models/convert.py:_deconv_weight``).

``torch.argmax`` returns the first maximal index, as ``jnp.argmax`` does,
and ``torch.sign(0)`` is 0, as ``jnp.sign(0)``: the quarter-pixel
refinement takes the same steps on ties.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tracklab_torch.device import resolve_device
from tracklab_torch.models.yolox import (YOLOX_VARIANTS, BatchNorm,
                                         ConvBnAct, CSPDarknet, YOLOPAFPN,
                                         _PredConv, decode_outputs)

__all__ = ["TopDownPose", "SimCCPose", "YOLOXPose", "decode_heatmaps",
           "decode_simcc", "randomize_"]

FLAX_BN_EPS = 1e-5   # flax nn.BatchNorm's default (the heads' BN)


def decode_heatmaps(heatmaps):
    """(B, H, W, K) heatmaps -> (B, K, 3) [x, y, conf] in heatmap
    coordinates, with the quarter-pixel step toward the larger neighbour
    (clamped at the border) on each axis."""
    B, H, W, K = heatmaps.shape
    hm = heatmaps.permute(0, 3, 1, 2).reshape(B, K, H * W)
    idx = torch.argmax(hm, dim=-1)
    conf = torch.gather(hm, -1, idx[..., None])[..., 0]
    yi, xi = idx // W, idx % W

    def at(dx, dy):
        xn = torch.clamp(xi + dx, 0, W - 1)
        yn = torch.clamp(yi + dy, 0, H - 1)
        return torch.gather(hm, -1, (yn * W + xn)[..., None])[..., 0]

    x = xi.float() + 0.25 * torch.sign(at(1, 0) - at(-1, 0))
    y = yi.float() + 0.25 * torch.sign(at(0, 1) - at(0, -1))
    return torch.stack([x, y, conf], dim=-1)


def decode_simcc(simcc_x, simcc_y, split_ratio: float = 2.0):
    """mmpose ``get_simcc_maximum``: per keypoint the argmax of the x and
    y bin vectors over ``split_ratio``, score the smaller of the two
    maxima, locations -1 where the score is <= 0.

    simcc_x (B, K, W * ratio), simcc_y (B, K, H * ratio) -> (B, K, 3)
    [x, y, score] in crop pixels."""
    x_locs = torch.argmax(simcc_x, dim=-1).float()
    y_locs = torch.argmax(simcc_y, dim=-1).float()
    vals = torch.minimum(simcc_x.amax(dim=-1), simcc_y.amax(dim=-1))
    locs = torch.stack([x_locs, y_locs], dim=-1) / split_ratio
    locs = torch.where(vals[..., None] > 0, locs, torch.full_like(locs, -1.0))
    return torch.cat([locs, vals[..., None]], dim=-1)


@torch.no_grad()
def randomize_(model, seed: int = 0):
    """Seeded random weights for runs without a checkpoint: lecun-normal
    conv, deconv and linear weights (std 1 / sqrt(fan_in), YOLOX's draw:
    SiLU shrinks the 0-255 input's scale layer by layer, so keypoint
    offsets stay within a few cells and scores spread over ~0.27-0.31; a
    He-normal draw puts the offsets at thousands of pixels), identity BN,
    zero biases, N(0, 0.02) position embeddings. Drawn on the CPU, so a
    seed gives the same weights on every device."""
    g = torch.Generator().manual_seed(seed)
    for name, t in model.state_dict().items():
        if name.endswith("position_embeddings"):
            t.copy_(torch.randn(t.shape, generator=g) * 0.02)
        elif t.dim() in (2, 4):
            fan_in = t[0].numel() if ".deconv" not in name else \
                t.shape[0] * t.shape[2] * t.shape[3]
            t.copy_(torch.randn(t.shape, generator=g) / fan_in ** 0.5)
        elif name.endswith(("running_var", "bn.weight")) or (
                name.endswith("weight") and t.dim() == 1):
            t.fill_(1.0)
        else:
            t.zero_()
    return model


class _Model(nn.Module):
    """NHWC in, the device, seeded weights."""

    def _finish(self, device):
        self.eval()
        self.to(resolve_device(device))

    @staticmethod
    def _nchw(images):
        return images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)

    def randomize_(self, seed: int = 0):
        return randomize_(self, seed)


class _Deconv(nn.Module):
    """ConvTranspose2d(k=4, s=2, p=1, no bias) in the model dtype + flax BN
    (eps 1e-5, f32) + ReLU; the weight is (in, out, 4, 4)."""

    def __init__(self, cin, cout, dtype):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=False)
        self.bn = BatchNorm(cout, eps=FLAX_BN_EPS)
        self.dtype = dtype

    def forward(self, x):
        y = F.conv_transpose2d(x.to(self.dtype),
                               self.deconv.weight.to(self.dtype), None, 2, 1)
        return F.relu(self.bn(y)).to(self.dtype)


class TopDownPose(_Model):
    """Crop (B, H, W, 3) -> heatmaps (B, H/4, W/4, K): the backbone's /32
    map and three deconvs of 256 channels."""

    def __init__(self, num_keypoints: int = 17, variant: str = "s",
                 dtype=torch.float32, device=None):
        super().__init__()
        v = YOLOX_VARIANTS[variant]
        self.backbone = CSPDarknet(v["depth_mult"], v["width_mult"],
                                   v["depthwise"], dtype=dtype)
        c5 = self.backbone.dark5[-1].conv3.conv.weight.shape[0]
        self.deconvs = nn.Sequential(_Deconv(c5, 256, dtype),
                                     _Deconv(256, 256, dtype),
                                     _Deconv(256, 256, dtype))
        self.final = _PredConv(256, num_keypoints, dtype)
        self.num_keypoints, self.dtype = num_keypoints, dtype
        self._finish(device)

    def forward(self, crops):
        _, _, c5 = self.backbone(self._nchw(crops))
        return self.final(self.deconvs(c5)).permute(0, 2, 3, 1)

    @torch.no_grad()
    def predict_keypoints(self, crops):
        """(B, H, W, 3) crops scaled to [0, 1] -> (B, K, 3) keypoints in
        crop pixels."""
        hm = self(crops)
        kp = decode_heatmaps(torch.sigmoid(hm.float()))
        stride = crops.shape[1] / hm.shape[1]
        return torch.cat([kp[..., :2] * stride, kp[..., 2:]], dim=-1)


class SimCCPose(_Model):
    """Top-down pose with a SimCC head: the backbone's /32 map -> 1x1 conv
    to K channels -> flattened per keypoint -> two linear maps to the x and
    y bin vectors (``input_size`` (H, W) times ``split_ratio`` bins)."""

    def __init__(self, num_keypoints: int = 17, variant: str = "s",
                 input_size=(256, 192), split_ratio: float = 2.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        v = YOLOX_VARIANTS[variant]
        self.backbone = CSPDarknet(v["depth_mult"], v["width_mult"],
                                   v["depthwise"], dtype=dtype)
        c5 = self.backbone.dark5[-1].conv3.conv.weight.shape[0]
        H, W = input_size
        self.final_layer = _PredConv(c5, num_keypoints, dtype)
        cells = -(-H // 32) * -(-W // 32)
        self.mlp_x = nn.Linear(cells, int(W * split_ratio))
        self.mlp_y = nn.Linear(cells, int(H * split_ratio))
        self.num_keypoints, self.split_ratio = num_keypoints, split_ratio
        self.dtype = dtype
        self._finish(device)

    def forward(self, crops):
        _, _, c5 = self.backbone(self._nchw(crops))
        y = self.final_layer(c5)
        y = y.reshape(y.shape[0], self.num_keypoints, -1).to(self.dtype)
        return (F.linear(y, self.mlp_x.weight.to(self.dtype),
                         self.mlp_x.bias.to(self.dtype)),
                F.linear(y, self.mlp_y.weight.to(self.dtype),
                         self.mlp_y.bias.to(self.dtype)))

    @torch.no_grad()
    def predict_keypoints(self, crops):
        simcc_x, simcc_y = self(crops)
        return decode_simcc(simcc_x.float(), simcc_y.float(),
                            self.split_ratio)


class YOLOXPoseHead(nn.Module):
    """Per level: a 1x1 stem, then three 3x3 ConvBnAct branches (class,
    regression, keypoints) and their 1x1 predictions, concatenated as
    [reg (4), obj (1), cls (C), kp (K * 3)] (keypoint k's x, y, conf at
    channels 3k, 3k + 1, 3k + 2)."""

    def __init__(self, chans, num_classes, num_keypoints, hidden, dtype):
        super().__init__()
        kw = dict(dtype=dtype)
        self.stems = nn.ModuleList(ConvBnAct(c, hidden, 1, **kw)
                                   for c in chans)
        self.cls_convs, self.reg_convs, self.kp_convs = (
            nn.ModuleList(ConvBnAct(hidden, hidden, 3, **kw) for _ in chans)
            for _ in range(3))
        self.cls_preds = nn.ModuleList(_PredConv(hidden, num_classes, dtype)
                                       for _ in chans)
        self.reg_preds = nn.ModuleList(_PredConv(hidden, 4, dtype)
                                       for _ in chans)
        self.obj_preds = nn.ModuleList(_PredConv(hidden, 1, dtype)
                                       for _ in chans)
        self.kp_preds = nn.ModuleList(
            _PredConv(hidden, num_keypoints * 3, dtype) for _ in chans)

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            s = self.stems[i](x)
            r = self.reg_convs[i](s)
            outs.append(torch.cat([
                self.reg_preds[i](r), self.obj_preds[i](r),
                self.cls_preds[i](self.cls_convs[i](s)),
                self.kp_preds[i](self.kp_convs[i](s))], dim=1))
        return outs


class YOLOXPose(_Model):
    """Bottom-up pose: YOLOX's CSPDarknet + PAFPN and a head that adds a
    keypoint branch; keypoint xy are offsets from the anchor cell in stride
    units, conf a logit."""

    def __init__(self, num_classes: int = 1, num_keypoints: int = 17,
                 variant: str = "s", dtype=torch.float32, device=None):
        super().__init__()
        v = YOLOX_VARIANTS[variant]
        self.backbone = YOLOPAFPN(v["depth_mult"], v["width_mult"],
                                  v["depthwise"], dtype=dtype)
        chans = [self.backbone.C3_p3.conv3.conv.weight.shape[0],
                 self.backbone.C3_n3.conv3.conv.weight.shape[0],
                 self.backbone.C3_n4.conv3.conv.weight.shape[0]]
        hidden = max(int(256 * v["width_mult"]), 64)
        self.head = YOLOXPoseHead(chans, num_classes, num_keypoints, hidden,
                                  dtype)
        self.num_classes, self.num_keypoints = num_classes, num_keypoints
        self.dtype = dtype
        self._finish(device)

    def forward(self, images):
        maps = self.head(self.backbone(self._nchw(images)))
        return [m.permute(0, 2, 3, 1) for m in maps]

    @torch.no_grad()
    def predict(self, images):
        """(B, H, W, 3) raw 0-255 images -> (decoded boxes (B, A, 5 + C),
        keypoints (B, A, K, 3) in input pixels, conf sigmoided)."""
        outs = self(images)
        C, K = self.num_classes, self.num_keypoints
        decoded = decode_outputs([o[..., :5 + C] for o in outs])
        kps = []
        for o, stride in zip(outs, (8, 16, 32)):
            b, h, w, _ = o.shape
            kp = o[..., 5 + C:].float().reshape(b, h, w, K, 3)
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=o.device),
                torch.arange(w, dtype=torch.float32, device=o.device),
                indexing="ij")
            x = (kp[..., 0] + gx[None, :, :, None]) * stride
            y = (kp[..., 1] + gy[None, :, :, None]) * stride
            kps.append(torch.stack([x, y, torch.sigmoid(kp[..., 2])],
                                   dim=-1).reshape(b, h * w, K, 3))
        return decoded, torch.cat(kps, dim=1)
