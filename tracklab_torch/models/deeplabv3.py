"""DeepLabV3-ResNet101, the reference's pitch-line segmentation net, in
PyTorch (counterpart of tracklab_tpu.models.deeplabv3).

torchvision's ``deeplabv3_resnet101(num_classes=29, aux_loss=True)``
rebuilt with its attribute names, so the SoccerNet checkpoint loads by
name (``models/convert.py:convert_deeplabv3_torch``):

- a ResNet-101 of output stride 8 (``replace_stride_with_dilation=[False,
  True, True]``): layer3 and layer4 keep stride 1 with dilations 2 and 4,
  and the first block of a dilated layer uses the previous dilation for its
  3x3 conv;
- ``classifier``: ASPP (1x1, 3x3 at rates 12, 24 and 36, image pooling) ->
  1x1 projection -> 3x3 conv -> 1x1 classifier;
- ``aux_classifier``: the FCN head on layer3.

Both heads' logits are upsampled bilinearly (align_corners=False) to the
input size. NHWC images in (ImageNet-normalised), NHWC logits out; f32. No
Pallas kernel exists for this model in the JAX package, so none here.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tracklab_torch.device import resolve_device
from tracklab_torch.models.yolox import BatchNorm

__all__ = ["DeepLabV3", "PITCH_NUM_CLASSES", "PITCH_LINES_CLASSES",
           "segment_class_lut"]

# the checkpoint's class order: SoccerPitch.lines_classes (the SoccerNet
# calibration baseline's soccerpitch.py); class 0 = background
PITCH_LINES_CLASSES = [
    "Big rect. left bottom", "Big rect. left main", "Big rect. left top",
    "Big rect. right bottom", "Big rect. right main",
    "Big rect. right top", "Circle central", "Circle left",
    "Circle right", "Goal left crossbar", "Goal left post left",
    "Goal left post right", "Goal right crossbar",
    "Goal right post left", "Goal right post right", "Goal unknown",
    "Line unknown", "Middle line", "Side line bottom", "Side line left",
    "Side line right", "Side line top", "Small rect. left bottom",
    "Small rect. left main", "Small rect. left top",
    "Small rect. right bottom", "Small rect. right main",
    "Small rect. right top",
]
PITCH_NUM_CLASSES = len(PITCH_LINES_CLASSES) + 1  # 29

# checkpoint line name -> calibration/pitch.py segment name (goal-frame
# and unknown classes have no 2-D pitch-template segment -> dropped)
_LINE_TO_SEGMENT = {
    "Big rect. left bottom": "big_rect_left_bottom",
    "Big rect. left main": "big_rect_left_main",
    "Big rect. left top": "big_rect_left_top",
    "Big rect. right bottom": "big_rect_right_bottom",
    "Big rect. right main": "big_rect_right_main",
    "Big rect. right top": "big_rect_right_top",
    "Circle central": "center_circle",
    "Circle left": "circle_left",
    "Circle right": "circle_right",
    "Middle line": "middle_line",
    "Side line bottom": "side_line_bottom",
    "Side line left": "goal_line_left",
    "Side line right": "goal_line_right",
    "Side line top": "side_line_top",
    "Small rect. left bottom": "small_rect_left_bottom",
    "Small rect. left main": "small_rect_left_main",
    "Small rect. left top": "small_rect_left_top",
    "Small rect. right bottom": "small_rect_right_bottom",
    "Small rect. right main": "small_rect_right_main",
    "Small rect. right top": "small_rect_right_top",
}


def segment_class_lut(segment_names, device=None) -> torch.Tensor:
    """(29,) int64 LUT from the checkpoint's class indices onto ``1 +
    segment_names.index(segment)`` (0 = background or dropped): a DeepLabV3
    argmax map re-indexes onto the calibration pipeline's segment classes
    with one gather, ``lut[cmap]``."""
    lut = [0] * PITCH_NUM_CLASSES
    for c, line in enumerate(PITCH_LINES_CLASSES, start=1):
        seg = _LINE_TO_SEGMENT.get(line)
        if seg is not None and seg in segment_names:
            lut[c] = 1 + list(segment_names).index(seg)
    return torch.tensor(lut, dtype=torch.int64, device=device)


def _conv(cin, cout, kernel, stride=1, dilation=1, bias=False):
    """A conv with torch's symmetric padding ``dilation * (kernel // 2)``."""
    return nn.Conv2d(cin, cout, kernel, stride, dilation * (kernel // 2),
                     dilation=dilation, bias=bias)


class Bottleneck(nn.Module):
    """torchvision resnet.Bottleneck with the dilation on conv2."""

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = BatchNorm(planes, eps=1e-5)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = BatchNorm(planes, eps=1e-5)
        self.conv3 = _conv(planes, 4 * planes, 1)
        self.bn3 = BatchNorm(4 * planes, eps=1e-5)
        self.downsample = nn.Sequential(
            _conv(cin, 4 * planes, 1, stride),
            BatchNorm(4 * planes, eps=1e-5)) if downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idt)


class ResNetDilated(nn.Module):
    """ResNet of output stride 8; ``forward`` returns (layer3, layer4)."""

    def __init__(self, layers=(3, 4, 23, 3)):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNorm(64, eps=1e-5)
        cin, dilation = 64, 1
        for li, (planes, n, stride, dilate) in enumerate(zip(
                (64, 128, 256, 512), layers, (1, 2, 2, 2),
                (False, False, True, True))):
            prev = dilation
            if dilate:
                dilation *= stride
                stride = 1
            blocks = []
            for b in range(n):
                s = stride if b == 0 else 1
                blocks.append(Bottleneck(
                    cin, planes, s, prev if b == 0 else dilation,
                    downsample=b == 0 and (s != 1 or cin != 4 * planes)))
                cin = 4 * planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer2(self.layer1(x))
        aux = self.layer3(x)
        return aux, self.layer4(aux)


def _conv_bn_relu(cin, cout, kernel, dilation=1):
    return nn.Sequential(_conv(cin, cout, kernel, 1, dilation),
                         BatchNorm(cout, eps=1e-5), nn.ReLU())


class _ASPPPooling(nn.Sequential):
    """Image pooling branch (keys ``convs.4.1`` conv, ``convs.4.2`` BN;
    index 0 is the parameter-free pool)."""

    def __init__(self, cin, cout):
        super().__init__(nn.AdaptiveAvgPool2d(1), _conv(cin, cout, 1),
                         BatchNorm(cout, eps=1e-5), nn.ReLU())

    def forward(self, x):
        g = super().forward(x)
        return g.expand(-1, -1, x.shape[2], x.shape[3])


class ASPP(nn.Module):
    def __init__(self, cin, rates=(12, 24, 36), out=256):
        super().__init__()
        self.convs = nn.ModuleList(
            [_conv_bn_relu(cin, out, 1)]
            + [_conv_bn_relu(cin, out, 3, r) for r in rates]
            + [_ASPPPooling(cin, out)])
        # project.3 is the (inference no-op) dropout
        self.project = nn.Sequential(
            _conv(out * (len(rates) + 2), out, 1),
            BatchNorm(out, eps=1e-5), nn.ReLU(), nn.Identity())

    def forward(self, x):
        return self.project(torch.cat([c(x) for c in self.convs], dim=1))


class DeepLabV3(nn.Module):
    """The segmenter on ``device`` (``cuda`` unless told otherwise).
    ``forward``: images (B, H, W, 3), ImageNet-normalised -> {"out",
    "aux"} logits (B, H, W, C) at the input size."""

    def __init__(self, num_classes: int = PITCH_NUM_CLASSES,
                 layers=(3, 4, 23, 3), aux: bool = True, device=None):
        super().__init__()
        self.backbone = ResNetDilated(layers)
        # classifier.{0,1,2,4}: ASPP, 3x3 conv, BN, (ReLU), 1x1 conv
        self.classifier = nn.Sequential(
            ASPP(2048), _conv(256, 256, 3), BatchNorm(256, eps=1e-5),
            nn.ReLU(), _conv(256, num_classes, 1, bias=True))
        self.aux = aux
        if aux:
            # aux_classifier.{0,1,4}: 3x3 conv, BN, (ReLU, dropout), 1x1
            self.aux_classifier = nn.Sequential(
                _conv(1024, 256, 3), BatchNorm(256, eps=1e-5), nn.ReLU(),
                nn.Identity(), _conv(256, num_classes, 1, bias=True))
        self.eval()
        self.to(resolve_device(device))

    def forward(self, images):
        H, W = images.shape[1], images.shape[2]
        x = images.float().permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        aux, feats = self.backbone(x)

        def up(y):
            return F.interpolate(y, size=(H, W), mode="bilinear",
                                 align_corners=False).permute(0, 2, 3, 1)
        out = {"out": up(self.classifier(feats))}
        if self.aux:
            out["aux"] = up(self.aux_classifier(aux))
        return out

    @torch.no_grad()
    def predict(self, images):
        """Per-pixel argmax class map (B, H, W) of the main head."""
        return torch.argmax(self(images)["out"], dim=-1)

    @torch.no_grad()
    def randomize_(self, seed: int = 0):
        """Seeded random weights: He-normal convs (std sqrt(2/fan_in)),
        identity BN, zero biases. Draws on the CPU, so a seed gives the same
        weights on every device."""
        g = torch.Generator().manual_seed(seed)
        bns = {n for n, m in self.named_modules()
               if isinstance(m, BatchNorm)}
        for name, t in self.state_dict().items():
            owner, leaf = name.rpartition(".")[::2]
            if owner in bns:
                t.fill_(1.0 if leaf in ("weight", "running_var") else 0.0)
            elif t.dim() == 4:
                fan_in = t[0].numel()
                t.copy_(torch.randn(t.shape, generator=g)
                        * math.sqrt(2.0 / fan_in))
            else:
                t.zero_()
        return self
