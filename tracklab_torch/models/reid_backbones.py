"""The ReID backbone zoo in PyTorch (counterpart of
tracklab_tpu.models.reid_backbones).

torchreid's global-feature backbones, as the reference's StrongSORT model
zoo holds them: ResNet / ResNeXt (torchvision v1.5, torchreid's
``last_stride`` and fc head), ResNet50-IBN-a and -IBN-b, MobileNetV2,
ShuffleNetV2, SE-ResNet50, ResNet50-mid, PCB, DenseNet121, SqueezeNet 1.0,
MLFN, Xception, HACNN, MuDeep, InceptionV4 and InceptionResNetV2 (OSNet-AIN
is in ``models/osnet.py``, NASNet-A mobile in ``models/nasnet_reid.py``).
Each is a ``ReidBackbone``: ``forward`` takes normalised NHWC crops and
returns the eval-mode feature vector in f32.

Module attribute names are torchreid's, so ``state_dict()`` keys are the
keys of a torchreid checkpoint (``models.convert.convert_reid_backbone_torch``
loads one; ``reid_backbone_from_flax`` maps the JAX package's flax names onto
them). Inference only: BatchNorm is the flax inference form of
``models/osnet.py`` (epsilon 1e-5, 1e-3 in the Inception families), the
InstanceNorms flax's one-group-per-channel ``GroupNorm``. The JAX package
computes the zoo with XLA convolutions and no Pallas kernel; here it is
cuDNN's, in f32.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from tracklab_torch.models.osnet import ReidBackbone, _BatchNorm, _InstanceNorm

__all__ = ["RESNET_VARIANTS", "MOBILENETV2_VARIANTS", "SHUFFLENETV2_VARIANTS",
           "ReidResNet", "ReidResNetIBN", "ReidResNetIBNb", "ReidMobileNetV2",
           "ReidShuffleNetV2", "ReidSEResNet", "ReidResNetMid", "ReidPCB",
           "ReidDenseNet", "ReidSqueezeNet", "ReidMLFN", "ReidXception",
           "ReidHACNN", "ReidMuDeep", "ReidInceptionV4",
           "ReidInceptionResNetV2", "zoo_model"]

RESNET_VARIANTS = {
    # (block, layers, last_stride, fc_dims[, groups, width])
    "resnet18": ("basic", (2, 2, 2, 2), 2, None),
    "resnet34": ("basic", (3, 4, 6, 3), 2, None),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 2, None),
    "resnet101": ("bottleneck", (3, 4, 23, 3), 2, None),
    "resnet152": ("bottleneck", (3, 8, 36, 3), 2, None),
    "resnet50_fc512": ("bottleneck", (3, 4, 6, 3), 1, (512,)),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3), 2, None, 32, 4),
    "resnext101_32x8d": ("bottleneck", (3, 4, 23, 3), 2, None, 32, 8),
}

MOBILENETV2_VARIANTS = {"mobilenetv2_x1_0": 1.0, "mobilenetv2_x1_4": 1.4}

SHUFFLENETV2_VARIANTS = {
    "shufflenet_v2_x0_5": ((4, 8, 4), (24, 48, 96, 192, 1024)),
    "shufflenet_v2_x1_0": ((4, 8, 4), (24, 116, 232, 464, 1024)),
    "shufflenet_v2_x1_5": ((4, 8, 4), (24, 176, 352, 704, 1024)),
    "shufflenet_v2_x2_0": ((4, 8, 4), (24, 244, 488, 976, 2048)),
}


def _conv(cin, cout, k, stride=1, pad=None, groups=1, bias=False):
    """``nn.Conv2d`` with flax's symmetric padding (``k // 2`` unless
    given; ``k`` and ``pad`` may be (h, w) pairs)."""
    if pad is None:
        pad = k // 2 if isinstance(k, int) else (k[0] // 2, k[1] // 2)
    return nn.Conv2d(cin, cout, k, stride, pad, groups=groups, bias=bias)


def _down(cin, cout, stride):
    """The projection shortcut ``downsample``: 1x1 conv + BN."""
    return nn.Sequential(_conv(cin, cout, 1, stride), _BatchNorm(cout))


def _max_pool_ceil3(x):
    """``MaxPool2d(3, 2, ceil_mode=True)`` (the JAX package pads the right
    and bottom with -inf so that partial windows count)."""
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


def _gap(x):
    return x.mean(dim=(2, 3))


# --------------------------------------------------------------- ResNet

class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = _BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _BatchNorm(planes)
        self.downsample = _down(cin, planes, stride) if downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idt)


class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck (stride on conv2; ResNeXt's grouped
    conv2 of width ``planes * base_width / 64 * groups``); out 4 x planes."""

    def __init__(self, cin, planes, stride=1, downsample=False, groups=1,
                 base_width=64):
        super().__init__()
        width = int(planes * base_width / 64.0) * groups
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = _BatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride, groups=groups)
        self.bn2 = _BatchNorm(width)
        self.conv3 = _conv(width, 4 * planes, 1)
        self.bn3 = _BatchNorm(4 * planes)
        self.downsample = (_down(cin, 4 * planes, stride) if downsample
                           else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idt)


def _stem(model):
    """The 7x7 / 2 conv1 + bn1 of the ResNet families."""
    model.conv1 = _conv(3, 64, 7, 2)
    model.bn1 = _BatchNorm(64)


def _stem_forward(model, x):
    return F.max_pool2d(F.relu(model.bn1(model.conv1(x))), 3, 2, 1)


def _layers(model, make, layers, strides, exp):
    """``layer1``..``layer4`` of ``make(cin, planes, stride, downsample,
    li, b)`` blocks; the first block of a layer projects its shortcut when
    the stride or the width changes."""
    cin = 64
    for li, (w, n, s) in enumerate(zip((64, 128, 256, 512), layers,
                                       strides)):
        blocks = []
        for b in range(n):
            stride = s if b == 0 else 1
            down = b == 0 and (stride != 1 or cin != w * exp)
            blocks.append(make(cin, w, stride, down, li, b))
            cin = w * exp
        setattr(model, f"layer{li + 1}", nn.Sequential(*blocks))


def _trunk(model, x):
    x = _stem_forward(model, x)
    return model.layer4(model.layer3(model.layer2(model.layer1(x))))


class ReidResNet(ReidBackbone):
    """torchreid ResNet / ResNeXt: the pooled feature (post-fc with
    ``fc_dims``: Linear + BN + ReLU)."""

    def __init__(self, variant="resnet50"):
        super().__init__()
        spec = RESNET_VARIANTS[variant]
        kind, layers, last_stride, fc_dims = spec[:4]
        groups, base_width = (spec[4], spec[5]) if len(spec) > 4 else (1, 64)
        exp = 1 if kind == "basic" else 4
        _stem(self)
        if kind == "basic":
            def make(cin, w, s, d, li, b):
                return BasicBlock(cin, w, s, d)
        else:
            def make(cin, w, s, d, li, b):
                return Bottleneck(cin, w, s, d, groups, base_width)
        _layers(self, make, layers, (1, 2, 2, last_stride), exp)
        self.fc = None
        if fc_dims:
            fc, cin = [], 512 * exp
            for dim in fc_dims:
                fc += [nn.Linear(cin, dim), _BatchNorm(dim), nn.ReLU()]
                cin = dim
            self.fc = nn.Sequential(*fc)

    def _embed(self, x):
        v = _gap(_trunk(self, x))
        return v if self.fc is None else self.fc(v)


# ------------------------------------------------------------ ResNet-IBN

class _IBN(nn.Module):
    """IBN-a's norm: the first half of the channels instance-normalised
    (``IN``), the rest batch-normalised (``BN``)."""

    def __init__(self, c):
        super().__init__()
        self.half = c // 2
        self.IN = _InstanceNorm(self.half)
        self.BN = _BatchNorm(c - self.half)

    def forward(self, x):
        return torch.cat([self.IN(x[:, :self.half]),
                          self.BN(x[:, self.half:])], dim=1)


class BottleneckIBN(nn.Module):
    """resnet_ibn_a's bottleneck: bn1 is IBN in layers 1-3."""

    def __init__(self, cin, planes, ibn, stride=1, downsample=False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = _IBN(planes) if ibn else _BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = _BatchNorm(planes)
        self.conv3 = _conv(planes, 4 * planes, 1)
        self.bn3 = _BatchNorm(4 * planes)
        self.downsample = (_down(cin, 4 * planes, stride) if downsample
                           else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idt)


class ReidResNetIBN(ReidBackbone):
    """resnet50_ibn_a: IBN in layers 1-3, a plain layer4; the pooled
    feature."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        _stem(self)
        _layers(self, lambda cin, w, s, d, li, b: BottleneckIBN(
            cin, w, w != 512, s, d), layers, (1, 2, 2, 2), 4)

    def _embed(self, x):
        return _gap(_trunk(self, x))


class _BottleneckIBNb(nn.Module):
    """resnet_ibn_b's bottleneck: an InstanceNorm after the residual add
    (``IN``) in the last block of layers 1 and 2."""

    def __init__(self, cin, planes, stride=1, downsample=False,
                 post_in=False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = _BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = _BatchNorm(planes)
        self.conv3 = _conv(planes, 4 * planes, 1)
        self.bn3 = _BatchNorm(4 * planes)
        self.downsample = (_down(cin, 4 * planes, stride) if downsample
                           else None)
        self.IN = _InstanceNorm(4 * planes) if post_in else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        y = y + (x if self.downsample is None else self.downsample(x))
        return F.relu(y if self.IN is None else self.IN(y))


class ReidResNetIBNb(ReidBackbone):
    """resnet50_ibn_b: an InstanceNorm stem norm (``bn1``); the pooled
    feature."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _InstanceNorm(64)
        _layers(self, lambda cin, w, s, d, li, b: _BottleneckIBNb(
            cin, w, s, d, post_in=li < 2 and b == layers[li] - 1),
            layers, (1, 2, 2, 2), 4)

    def _embed(self, x):
        return _gap(_trunk(self, x))


# ----------------------------------------------------------- MobileNetV2

class _MBConvBlock(nn.Module):
    """conv + BN + ReLU6."""

    def __init__(self, cin, cout, k, stride=1, pad=0, groups=1):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride, pad, groups)
        self.bn = _BatchNorm(cout)

    def forward(self, x):
        return torch.clamp(self.bn(self.conv(x)), 0.0, 6.0)


class _MBBottleneck(nn.Module):
    """Inverted residual: 1x1 expand, depthwise 3x3, linear 1x1."""

    def __init__(self, cin, cout, expansion, stride=1):
        super().__init__()
        mid = cin * expansion
        self.conv1 = _MBConvBlock(cin, mid, 1)
        self.dwconv2 = _MBConvBlock(mid, mid, 3, stride, 1, groups=mid)
        self.conv3 = nn.Sequential(_conv(mid, cout, 1), _BatchNorm(cout))
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        m = self.conv3(self.dwconv2(self.conv1(x)))
        return x + m if self.residual else m


class ReidMobileNetV2(ReidBackbone):
    """torchreid MobileNetV2 (x1_0, x1_4): the pooled 1280-wide (x 1.4)
    conv9 feature."""

    def __init__(self, variant="mobilenetv2_x1_0"):
        super().__init__()
        wm = MOBILENETV2_VARIANTS[variant]
        feat_dim = int(1280 * wm) if wm > 1 else 1280
        cin = int(32 * wm)
        self.conv1 = _MBConvBlock(3, cin, 3, 2, 1)
        stages = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                  (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        for si, (t, c, n, s) in enumerate(stages):
            c = int(c * wm)
            blocks = []
            for b in range(n):
                blocks.append(_MBBottleneck(cin, c, t, s if b == 0 else 1))
                cin = c
            setattr(self, f"conv{si + 2}", nn.Sequential(*blocks))
        self.conv9 = _MBConvBlock(cin, feat_dim, 1)

    def _embed(self, x):
        x = self.conv1(x)
        for si in range(2, 9):
            x = getattr(self, f"conv{si}")(x)
        return _gap(self.conv9(x))


# ---------------------------------------------------------- ShuffleNetV2

def _channel_shuffle(x, groups=2):
    """NCHW channel shuffle: channel i * (C / g) + j goes to j * g + i, the
    permutation of the JAX package's NHWC reshape and swap."""
    b, c, h, w = x.shape
    return (x.view(b, groups, c // groups, h, w).transpose(1, 2)
            .reshape(b, c, h, w))


class _ShuffleUnit(nn.Module):
    """InvertedResidual: the stride-2 unit runs both branches on the whole
    input; the stride-1 unit passes its first half through."""

    def __init__(self, cin, cout, stride=1):
        super().__init__()
        half = cout // 2
        self.stride = stride
        self.branch1 = None
        if stride > 1:
            self.branch1 = nn.Sequential(
                _conv(cin, cin, 3, stride, groups=cin), _BatchNorm(cin),
                _conv(cin, half, 1), _BatchNorm(half), nn.ReLU())
        b2_in = cin if stride > 1 else cin - half
        self.branch2 = nn.Sequential(
            _conv(b2_in, half, 1), _BatchNorm(half), nn.ReLU(),
            _conv(half, half, 3, stride, groups=half), _BatchNorm(half),
            _conv(half, half, 1), _BatchNorm(half), nn.ReLU())
        self.half = half

    def forward(self, x):
        if self.branch1 is not None:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        else:
            out = torch.cat([x[:, :self.half],
                             self.branch2(x[:, self.half:])], dim=1)
        return _channel_shuffle(out, 2)


class ReidShuffleNetV2(ReidBackbone):
    """torchreid ShuffleNetV2 (torchvision layout): the pooled conv5
    feature."""

    def __init__(self, variant="shufflenet_v2_x1_0"):
        super().__init__()
        repeats, chans = SHUFFLENETV2_VARIANTS[variant]
        self.conv1 = nn.Sequential(_conv(3, chans[0], 3, 2),
                                   _BatchNorm(chans[0]), nn.ReLU())
        cin = chans[0]
        for si, (n, c) in enumerate(zip(repeats, chans[1:4])):
            setattr(self, f"stage{si + 2}", nn.Sequential(
                *[_ShuffleUnit(cin if j == 0 else c, c, 2 if j == 0 else 1)
                  for j in range(n)]))
            cin = c
        self.conv5 = nn.Sequential(_conv(cin, chans[4], 1),
                                   _BatchNorm(chans[4]), nn.ReLU())

    def _embed(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        x = self.stage4(self.stage3(self.stage2(x)))
        return _gap(self.conv5(x))


# ------------------------------------------------------------ SE-ResNet50

class _SEModule(nn.Module):
    """Squeeze and excitation: mean -> fc1 -> ReLU -> fc2 -> sigmoid
    scale (biased 1x1 convs)."""

    def __init__(self, c, reduction=16):
        super().__init__()
        self.fc1 = _conv(c, c // reduction, 1, bias=True)
        self.fc2 = _conv(c // reduction, c, 1, bias=True)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class _SEResNetBottleneck(nn.Module):
    """senet's SEResNetBottleneck: stride on conv1 (Caffe layout), the SE
    module on the 4x output before the residual add."""

    def __init__(self, cin, planes, stride=1, reduction=16,
                 downsample=False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1, stride)
        self.bn1 = _BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _BatchNorm(planes)
        self.conv3 = _conv(planes, 4 * planes, 1)
        self.bn3 = _BatchNorm(4 * planes)
        self.downsample = (_down(cin, 4 * planes, stride) if downsample
                           else None)
        self.se_module = _SEModule(4 * planes, reduction)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.se_module(self.bn3(self.conv3(y)))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idt)


class ReidSEResNet(ReidBackbone):
    """torchreid se_resnet50 (7x7 ``layer0`` stem, ceil-mode pool, last
    stride 2): the pooled feature."""

    def __init__(self, layers=(3, 4, 6, 3), reduction=16):
        super().__init__()
        self.layer0 = nn.Sequential(OrderedDict(
            conv1=_conv(3, 64, 7, 2), bn1=_BatchNorm(64)))
        _layers(self, lambda cin, w, s, d, li, b: _SEResNetBottleneck(
            cin, w, s, reduction, d), layers, (1, 2, 2, 2), 4)

    def _embed(self, x):
        x = _max_pool_ceil3(F.relu(self.layer0(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return _gap(x)


# ------------------------------------------------------------ ResNet-mid

class ReidResNetMid(ReidBackbone):
    """resnet50mid: the ResNet50 trunk; fc_fusion(gap(layer4[0]) ++
    gap(layer4[1])) (1024) concatenated with gap(layer4[2]) (2048)."""

    def __init__(self, layers=(3, 4, 6, 3), fc_dim=1024):
        super().__init__()
        _stem(self)
        _layers(self, lambda cin, w, s, d, li, b: Bottleneck(cin, w, s, d),
                layers, (1, 2, 2, 2), 4)
        self.fc_fusion = nn.Sequential(nn.Linear(4096, fc_dim),
                                       _BatchNorm(fc_dim), nn.ReLU())

    def _embed(self, x):
        x = self.layer3(self.layer2(self.layer1(_stem_forward(self, x))))
        mids = []
        for block in self.layer4:
            x = block(x)
            mids.append(_gap(x))
        v = self.fc_fusion(torch.cat(mids[:-1], dim=1))
        return torch.cat([v, mids[-1]], dim=1)


# ------------------------------------------------------------------- PCB

def _adaptive_avg_pool_rows(x, parts):
    """``AdaptiveAvgPool2d((parts, 1))``: bin i averages rows
    [floor(i H / p), ceil((i + 1) H / p)) over the whole width."""
    return F.adaptive_avg_pool2d(x, (parts, 1))


class ReidPCB(ReidBackbone):
    """torchreid pcb_p6 / pcb_p4: the ResNet50 trunk at last stride 1,
    ``parts`` horizontal bins, each l2-normalised over its 2048 channels,
    flattened channel-major (B, 2048 * parts)."""

    def __init__(self, layers=(3, 4, 6, 3), parts=6):
        super().__init__()
        self.parts = parts
        _stem(self)
        _layers(self, lambda cin, w, s, d, li, b: Bottleneck(cin, w, s, d),
                layers, (1, 2, 2, 1), 4)

    def _embed(self, x):
        v = _adaptive_avg_pool_rows(_trunk(self, x), self.parts)
        v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
        return v.flatten(1)


# -------------------------------------------------------------- DenseNet

class _DenseLayer(nn.Module):
    def __init__(self, cin, growth_rate, bn_size=4):
        super().__init__()
        self.norm1 = _BatchNorm(cin)
        self.conv1 = _conv(cin, bn_size * growth_rate, 1)
        self.norm2 = _BatchNorm(bn_size * growth_rate)
        self.conv2 = _conv(bn_size * growth_rate, growth_rate, 3)

    def forward(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class _DenseTransition(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm = _BatchNorm(cin)
        self.conv = _conv(cin, cout, 1)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class _DenseFeatures(nn.Module):
    def __init__(self, growth_rate, block_config, num_init_features):
        super().__init__()
        self.conv0 = _conv(3, num_init_features, 7, 2)
        self.norm0 = _BatchNorm(num_init_features)
        n = num_init_features
        self.n_blocks = len(block_config)
        for i, layers in enumerate(block_config):
            block = nn.Module()
            for j in range(layers):
                block.add_module(f"denselayer{j + 1}",
                                 _DenseLayer(n + j * growth_rate,
                                             growth_rate))
            self.add_module(f"denseblock{i + 1}", block)
            n += layers * growth_rate
            if i != len(block_config) - 1:
                self.add_module(f"transition{i + 1}",
                                _DenseTransition(n, n // 2))
                n //= 2
        self.norm5 = _BatchNorm(n)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.norm0(self.conv0(x))), 3, 2, 1)
        for i in range(self.n_blocks):
            for layer in getattr(self, f"denseblock{i + 1}").children():
                x = layer(x)
            if i != self.n_blocks - 1:
                x = getattr(self, f"transition{i + 1}")(x)
        return self.norm5(x)


class ReidDenseNet(ReidBackbone):
    """torchreid densenet121 (torchvision layout): the pooled feature after
    a ReLU."""

    def __init__(self, growth_rate=32, block_config=(6, 12, 24, 16),
                 num_init_features=64):
        super().__init__()
        self.features = _DenseFeatures(growth_rate, block_config,
                                       num_init_features)

    def _embed(self, x):
        return _gap(F.relu(self.features(x)))


# ------------------------------------------------------------ SqueezeNet

class _Fire(nn.Module):
    def __init__(self, cin, s, e1, e3):
        super().__init__()
        self.squeeze = _conv(cin, s, 1, bias=True)
        self.expand1x1 = _conv(s, e1, 1, bias=True)
        self.expand3x3 = _conv(s, e3, 3, bias=True)

    def forward(self, x):
        x = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(x)),
                          F.relu(self.expand3x3(x))], dim=1)


class ReidSqueezeNet(ReidBackbone):
    """torchreid squeezenet1_0 (torchvision layout: biased convs, an
    unpadded first conv, ceil-mode pools): the pooled 512-wide feature."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            _conv(3, 96, 7, 2, 0, bias=True), nn.ReLU(),
            nn.MaxPool2d(3, 2, ceil_mode=True),
            _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
            _Fire(128, 32, 128, 128), nn.MaxPool2d(3, 2, ceil_mode=True),
            _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
            _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
            nn.MaxPool2d(3, 2, ceil_mode=True), _Fire(512, 64, 256, 256))

    def _embed(self, x):
        return _gap(self.features(x))


# ------------------------------------------------------------------ MLFN

class _MLFNBlock(nn.Module):
    """A factor module and its factor-selection gate ``fsm``: the (groups,)
    sigmoid selector scales the grouped conv's channels (channel c takes
    gate c // (mid / groups)); returns (features, selector)."""

    def __init__(self, cin, cout, stride=1, fsm=(128, 64), groups=32):
        super().__init__()
        mid = cout // 2
        self.n = mid // groups
        self.fsm = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            _conv(cin, fsm[0], 1, bias=True), _BatchNorm(fsm[0]), nn.ReLU(),
            _conv(fsm[0], fsm[1], 1, bias=True), _BatchNorm(fsm[1]),
            nn.ReLU(),
            _conv(fsm[1], groups, 1, bias=True), _BatchNorm(groups),
            nn.Sigmoid())
        self.fm_conv1 = _conv(cin, mid, 1)
        self.fm_bn1 = _BatchNorm(mid)
        self.fm_conv2 = _conv(mid, mid, 3, stride, groups=groups)
        self.fm_bn2 = _BatchNorm(mid)
        self.fm_conv3 = _conv(mid, cout, 1)
        self.fm_bn3 = _BatchNorm(cout)
        self.downsample = (_down(cin, cout, stride)
                           if cin != cout or stride > 1 else None)

    def forward(self, x):
        s = self.fsm(x)                                     # (B, g, 1, 1)
        y = F.relu(self.fm_bn1(self.fm_conv1(x)))
        y = F.relu(self.fm_bn2(self.fm_conv2(y)))
        y = y * s.repeat_interleave(self.n, dim=1)
        y = F.relu(self.fm_bn3(self.fm_conv3(y)))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(res + y), s


class ReidMLFN(ReidBackbone):
    """torchreid MLFN: 16 factorisation blocks; the feature is the mean of
    the projected pooled feature (``fc_x``) and the projected concatenated
    selectors (``fc_s``)."""

    def __init__(self, groups=32, channels=(64, 256, 512, 1024, 2048),
                 embed_dim=1024):
        super().__init__()
        ch = channels
        self.conv1 = _conv(3, ch[0], 7, 2, bias=True)
        self.bn1 = _BatchNorm(ch[0])
        spec = ([(ch[1], 1, (128, 64))] * 3 + [(ch[2], 2, (256, 128))]
                + [(ch[2], 1, (256, 128))] * 3 + [(ch[3], 2, (512, 128))]
                + [(ch[3], 1, (512, 128))] * 5 + [(ch[4], 2, (512, 128))]
                + [(ch[4], 1, (512, 128))] * 2)
        blocks, cin = [], ch[0]
        for c, stride, fsm in spec:
            blocks.append(_MLFNBlock(cin, c, stride, fsm, groups))
            cin = c
        self.feature = nn.ModuleList(blocks)
        self.fc_x = nn.Sequential(_conv(cin, embed_dim, 1),
                                  _BatchNorm(embed_dim), nn.ReLU())
        self.fc_s = nn.Sequential(_conv(groups * len(spec), embed_dim, 1),
                                  _BatchNorm(embed_dim), nn.ReLU())

    def _embed(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        sels = []
        for block in self.feature:
            x, s = block(x)
            sels.append(s)
        vx = self.fc_x(x.mean(dim=(2, 3), keepdim=True))
        vs = self.fc_s(torch.cat(sels, dim=1))
        return ((vx + vs) * 0.5).flatten(1)


# -------------------------------------------------------------- Xception

class _XSepConv(nn.Module):
    """SeparableConv2d: depthwise ``conv1`` and ``pointwise``, unbiased."""

    def __init__(self, cin, cout, k=3, stride=1, pad=1):
        super().__init__()
        self.conv1 = _conv(cin, cin, k, stride, pad, groups=cin)
        self.pointwise = _conv(cin, cout, 1)

    def forward(self, x):
        return self.pointwise(self.conv1(x))


class _XBlock(nn.Module):
    """An Xception block: ``rep`` holds ReLU / separable conv / BN at
    torchreid's Sequential indices (``plan``: (index of the separable conv,
    its width) pairs; a ReLU before each but one at index 0, block1's
    first); a strided 3x3 max pool; the shortcut projected (``skip``,
    ``skipbn``) when the width or the stride changes."""

    def __init__(self, cin, out, plan, stride=1):
        super().__init__()
        mods, c = [], cin
        for idx, feats in plan:
            while len(mods) < idx:
                mods.append(nn.ReLU())
            mods += [_XSepConv(c, feats), _BatchNorm(feats)]
            c = feats
        self.rep = nn.Sequential(*mods)
        self.stride = stride
        self.skip = self.skipbn = None
        if cin != out or stride != 1:
            self.skip = _conv(cin, out, 1, stride)
            self.skipbn = _BatchNorm(out)

    def forward(self, inp):
        x = self.rep(inp)
        if self.stride != 1:
            x = F.max_pool2d(x, 3, self.stride, 1)
        skip = inp if self.skip is None else self.skipbn(self.skip(inp))
        return x + skip


class ReidXception(ReidBackbone):
    """torchreid Xception (unpadded stem convs): the pooled 2048-wide
    feature."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 32, 3, 2, 0)
        self.bn1 = _BatchNorm(32)
        self.conv2 = _conv(32, 64, 3, 1, 0)
        self.bn2 = _BatchNorm(64)
        self.block1 = _XBlock(64, 128, ((0, 128), (3, 128)), stride=2)
        self.block2 = _XBlock(128, 256, ((1, 256), (4, 256)), stride=2)
        self.block3 = _XBlock(256, 728, ((1, 728), (4, 728)), stride=2)
        for i in range(4, 12):
            setattr(self, f"block{i}", _XBlock(
                728, 728, ((1, 728), (4, 728), (7, 728))))
        self.block12 = _XBlock(728, 1024, ((1, 728), (4, 1024)), stride=2)
        self.conv3 = _XSepConv(1024, 1536)
        self.bn3 = _BatchNorm(1536)
        self.conv4 = _XSepConv(1536, 2048)
        self.bn4 = _BatchNorm(2048)

    def _embed(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        for i in range(1, 13):
            x = getattr(self, f"block{i}")(x)
        x = F.relu(self.bn3(self.conv3(x)))
        return _gap(F.relu(self.bn4(self.conv4(x))))


# ----------------------------------------------------------------- HACNN

class _HConv(nn.Module):
    """ConvBlock: biased conv + BN + ReLU."""

    def __init__(self, cin, cout, k=1, stride=1, pad=0):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride, pad, bias=True)
        self.bn = _BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class _HInceptionA(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        m = cout // 4
        for s in (1, 2, 3):
            setattr(self, f"stream{s}", nn.Sequential(
                _HConv(cin, m, 1), _HConv(m, m, 3, pad=1)))
        self.stream4 = nn.Sequential(nn.AvgPool2d(3, 1, 1),
                                     _HConv(cin, m, 1))

    def forward(self, x):
        return torch.cat([self.stream1(x), self.stream2(x), self.stream3(x),
                          self.stream4(x)], dim=1)


class _HInceptionB(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        m = cout // 4
        self.stream1 = nn.Sequential(_HConv(cin, m, 1),
                                     _HConv(m, m, 3, 2, 1))
        self.stream2 = nn.Sequential(_HConv(cin, m, 1),
                                     _HConv(m, m, 3, 1, 1),
                                     _HConv(m, m, 3, 2, 1))
        self.stream3 = nn.Sequential(nn.MaxPool2d(3, 2, 1),
                                     _HConv(cin, 2 * m, 1))

    def forward(self, x):
        return torch.cat([self.stream1(x), self.stream2(x), self.stream3(x)],
                         dim=1)


def _resize_bilinear_ac(x, oh, ow):
    """``F.upsample(mode='bilinear', align_corners=True)`` to (oh, ow)."""
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=True)


def _stn_scale_y(x, theta):
    """HACNN's hard-attention crop: ``affine_grid`` of [[1, 0, tx], [0,
    0.25, ty]] (theta (B, 2) = (tx, ty)) and ``grid_sample`` with
    torch's defaults (bilinear, zeros outside, align_corners=False) onto a
    map of the input's size."""
    b, c, h, w = x.shape
    xn = (2.0 * torch.arange(w, device=x.device) + 1.0) / w - 1.0
    yn = (2.0 * torch.arange(h, device=x.device) + 1.0) / h - 1.0
    gx = xn[None, None, :] + theta[:, 0, None, None]
    gy = yn[None, :, None] * 0.25 + theta[:, 1, None, None]
    grid = torch.stack([gx.expand(b, h, w), gy.expand(b, h, w)], dim=-1)
    return F.grid_sample(x.float(), grid, mode="bilinear",
                         padding_mode="zeros", align_corners=False)


class _HSoftAttn(nn.Module):
    """Spatial x channel attention, a 1x1 ConvBlock, then a sigmoid."""

    def __init__(self, c):
        super().__init__()
        self.spatial_attn = nn.ModuleDict(dict(
            conv1=_HConv(1, 1, 3, 2, 1), conv2=_HConv(1, 1, 1)))
        self.channel_attn = nn.ModuleDict(dict(
            conv1=_HConv(c, c // 16, 1), conv2=_HConv(c // 16, c, 1)))
        self.conv = _HConv(c, c, 1)

    def forward(self, x):
        s = self.spatial_attn["conv1"](x.mean(dim=1, keepdim=True))
        s = _resize_bilinear_ac(s, s.shape[2] * 2, s.shape[3] * 2)
        s = self.spatial_attn["conv2"](s)
        ch = x.mean(dim=(2, 3), keepdim=True)
        ch = self.channel_attn["conv2"](self.channel_attn["conv1"](ch))
        return torch.sigmoid(self.conv(s * ch))


class _HHarmAttn(nn.Module):
    """Harmonious attention: the soft attention map and the hard
    attention's (B, 4, 2) translations, tanh(fc(mean))."""

    def __init__(self, c):
        super().__init__()
        self.soft_attn = _HSoftAttn(c)
        self.hard_attn = nn.ModuleDict(dict(fc=nn.Linear(c, 8)))

    def forward(self, x):
        theta = torch.tanh(self.hard_attn["fc"](x.mean(dim=(2, 3))))
        return self.soft_attn(x), theta.view(-1, 4, 2)


class ReidHACNN(ReidBackbone):
    """torchreid HACNN (input 160 x 64): the l2-normalised global and local
    features concatenated (2 x feat_dim)."""

    def __init__(self, nchannels=(128, 256, 384), feat_dim=512):
        super().__init__()
        nc = nchannels
        self.conv = _HConv(3, 32, 3, 2, 1)
        cin = 32
        for i, c in enumerate(nc):
            setattr(self, f"inception{i + 1}", nn.Sequential(
                _HInceptionA(cin, c), _HInceptionB(c, c)))
            setattr(self, f"ha{i + 1}", _HHarmAttn(c))
            setattr(self, f"local_conv{i + 1}", _HInceptionB(cin, c))
            cin = c
        self.fc_global = nn.Sequential(nn.Linear(nc[2], feat_dim),
                                       _BatchNorm(feat_dim), nn.ReLU())
        self.fc_local = nn.Sequential(nn.Linear(4 * nc[2], feat_dim),
                                      _BatchNorm(feat_dim), nn.ReLU())

    def _embed(self, x):
        x = self.conv(x)
        prev, locals_ = x, None
        for i, size in enumerate(((24, 28), (12, 14), (6, 7))):
            xi = getattr(self, f"inception{i + 1}")(prev)
            attn, theta = getattr(self, f"ha{i + 1}")(xi)
            conv = getattr(self, f"local_conv{i + 1}")
            crops = [_resize_bilinear_ac(_stn_scale_y(prev, theta[:, r]),
                                         *size) for r in range(4)]
            locals_ = [conv(c if locals_ is None else c + locals_[r])
                       for r, c in enumerate(crops)]
            prev = xi * attn
        vg = self.fc_global(_gap(prev))
        vl = self.fc_local(torch.cat([_gap(v) for v in locals_], dim=1))
        return torch.cat([F.normalize(vg, dim=1, eps=0.0),
                          F.normalize(vl, dim=1, eps=0.0)], dim=1)


# ---------------------------------------------------------------- MuDeep

class _MConv(nn.Module):
    """ConvBlock: biased conv + BN + ReLU (kernel and padding per axis)."""

    def __init__(self, cin, cout, k, stride, pad):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride, pad, bias=True)
        self.bn = _BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg3(cin, cout):
    """A 3x3 / 1 average pool (padding counted) and a 1x1 ConvBlock."""
    return nn.Sequential(nn.AvgPool2d(3, 1, 1), _MConv(cin, cout, 1, 1, 0))


class ReidMuDeep(ReidBackbone):
    """torchreid MuDeep (input 256 x 128): a conv stem, multi-scale block
    A, a reduction, multi-scale block B, the saliency-weighted fusion
    (``block5.a1``..``a4``, (1, 256, 1, 1) each) and the 4096-wide fc
    feature over the channel-major flatten."""

    def __init__(self):
        super().__init__()
        M = _MConv
        self.block1 = nn.ModuleDict(dict(conv1=M(3, 48, 3, 1, 1),
                                         conv2=M(48, 96, 3, 1, 1)))
        self.block2 = nn.ModuleDict(dict(
            stream1=nn.Sequential(M(96, 96, 1, 1, 0), M(96, 24, 3, 1, 1)),
            stream2=_avg3(96, 24),
            stream3=M(96, 24, 1, 1, 0),
            stream4=nn.Sequential(M(96, 16, 1, 1, 0), M(16, 24, 3, 1, 1),
                                  M(24, 24, 3, 1, 1))))
        self.block3 = nn.ModuleDict(dict(
            stream2=M(96, 96, 3, 2, 1),
            stream3=nn.Sequential(M(96, 48, 1, 1, 0), M(48, 56, 3, 1, 1),
                                  M(56, 64, 3, 2, 1))))
        self.block4 = nn.ModuleDict(dict(
            stream1=_avg3(256, 256),
            stream2=nn.Sequential(M(256, 64, 1, 1, 0),
                                  M(64, 128, (1, 3), 1, (0, 1)),
                                  M(128, 256, (3, 1), 1, (1, 0))),
            stream3=M(256, 256, 1, 1, 0),
            stream4=nn.Sequential(M(256, 64, 1, 1, 0),
                                  M(64, 64, (1, 3), 1, (0, 1)),
                                  M(64, 128, (3, 1), 1, (1, 0)),
                                  M(128, 128, (1, 3), 1, (0, 1)),
                                  M(128, 256, (3, 1), 1, (1, 0)))))
        self.block5 = nn.ParameterDict({
            f"a{i}": nn.Parameter(torch.zeros(1, 256, 1, 1))
            for i in (1, 2, 3, 4)})
        self.fc = nn.Sequential(nn.Linear(256 * 16 * 8, 4096),
                                _BatchNorm(4096), nn.ReLU())

    def _embed(self, x):
        b1, b2, b3, b4, b5 = (self.block1, self.block2, self.block3,
                              self.block4, self.block5)
        x = F.max_pool2d(b1["conv2"](b1["conv1"](x)), 3, 2, 1)
        x = torch.cat([b2["stream1"](x), b2["stream2"](x), b2["stream3"](x),
                       b2["stream4"](x)], dim=1)
        x = torch.cat([F.max_pool2d(x, 3, 2, 1), b3["stream2"](x),
                       b3["stream3"](x)], dim=1)
        y = (b5["a1"] * b4["stream1"](x) + b5["a2"] * b4["stream2"](x)
             + b5["a3"] * b4["stream3"](x) + b5["a4"] * b4["stream4"](x))
        return self.fc(F.avg_pool2d(y, 4, 4).flatten(1))


# ----------------------------------------------------------- Inception

class _IConv(nn.Module):
    """BasicConv2d: unbiased conv + BN (epsilon 1e-3) + ReLU."""

    def __init__(self, cin, cout, k=(3, 3), stride=1, pad=(0, 0)):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride, pad)
        self.bn = _BatchNorm(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _maxp3v(x):
    return F.max_pool2d(x, 3, 2)


def _seq(*convs):
    """A Sequential of BasicConv2d specs (cin, cout[, k, stride, pad])."""
    return nn.Sequential(*[_IConv(*c) for c in convs])


class _Branches(nn.Module):
    """An Inception module: ``forward`` concatenates, in ``order``, its
    named branches and parameterless ops (``"maxpool"``: the unpadded 3x3 /
    2 max pool)."""

    def __init__(self, order, **branches):
        super().__init__()
        self.order = order
        for name, mod in branches.items():
            setattr(self, name, mod)

    def forward(self, x):
        return torch.cat([_maxp3v(x) if n == "maxpool"
                          else getattr(self, n)(x) for n in self.order],
                         dim=1)


def _pooled(cin, cout):
    """branch3: a 3x3 / 1 average pool that excludes its own padding, then
    a 1x1 BasicConv2d (``branch3.1``)."""
    return nn.Sequential(nn.AvgPool2d(3, 1, 1, count_include_pad=False),
                         _IConv(cin, cout, (1, 1)))


class _InceptionC(nn.Module):
    """Inception-C: torchreid's literal-underscore attributes (branch1_0,
    branch1_1a, ...), which the JAX package spells with 'q'."""

    def __init__(self):
        super().__init__()
        C = _IConv
        self.branch0 = C(1536, 256, (1, 1))
        self.branch1_0 = C(1536, 384, (1, 1))
        self.branch1_1a = C(384, 256, (1, 3), 1, (0, 1))
        self.branch1_1b = C(384, 256, (3, 1), 1, (1, 0))
        self.branch2_0 = C(1536, 384, (1, 1))
        self.branch2_1 = C(384, 448, (3, 1), 1, (1, 0))
        self.branch2_2 = C(448, 512, (1, 3), 1, (0, 1))
        self.branch2_3a = C(512, 256, (1, 3), 1, (0, 1))
        self.branch2_3b = C(512, 256, (3, 1), 1, (1, 0))
        self.branch3 = _pooled(1536, 256)

    def forward(self, x):
        h = self.branch1_0(x)
        b1 = torch.cat([self.branch1_1a(h), self.branch1_1b(h)], dim=1)
        h = self.branch2_2(self.branch2_1(self.branch2_0(x)))
        b2 = torch.cat([self.branch2_3a(h), self.branch2_3b(h)], dim=1)
        return torch.cat([self.branch0(x), b1, b2, self.branch3(x)], dim=1)


class ReidInceptionV4(ReidBackbone):
    """torchreid InceptionV4 (unpadded stem and reduction convs): the pooled
    1536-wide feature. Crops under 75 x 75 leave a reduction no input."""

    def __init__(self):
        super().__init__()
        C, B = _IConv, _Branches
        s17, s71 = ((1, 7), 1, (0, 3)), ((7, 1), 1, (3, 0))
        feats = [C(3, 32, stride=2), C(32, 32), C(32, 64, pad=(1, 1)),
                 B(("maxpool", "conv"), conv=C(64, 96, stride=2)),
                 B(("branch0", "branch1"),
                   branch0=_seq((160, 64, (1, 1)), (64, 96)),
                   branch1=_seq((160, 64, (1, 1)), (64, 64, *s17),
                                (64, 64, *s71), (64, 96))),
                 B(("conv", "maxpool"), conv=C(192, 192, stride=2))]
        for _ in range(4):
            feats.append(B(("branch0", "branch1", "branch2", "branch3"),
                           branch0=C(384, 96, (1, 1)),
                           branch1=_seq((384, 64, (1, 1)),
                                        (64, 96, (3, 3), 1, (1, 1))),
                           branch2=_seq((384, 64, (1, 1)),
                                        (64, 96, (3, 3), 1, (1, 1)),
                                        (96, 96, (3, 3), 1, (1, 1))),
                           branch3=_pooled(384, 96)))
        feats.append(B(("branch0", "branch1", "maxpool"),
                       branch0=C(384, 384, stride=2),
                       branch1=_seq((384, 192, (1, 1)),
                                    (192, 224, (3, 3), 1, (1, 1)),
                                    (224, 256, (3, 3), 2))))
        for _ in range(7):
            feats.append(B(("branch0", "branch1", "branch2", "branch3"),
                           branch0=C(1024, 384, (1, 1)),
                           branch1=_seq((1024, 192, (1, 1)),
                                        (192, 224, *s17), (224, 256, *s71)),
                           branch2=_seq((1024, 192, (1, 1)),
                                        (192, 192, *s71), (192, 224, *s17),
                                        (224, 224, *s71), (224, 256, *s17)),
                           branch3=_pooled(1024, 128)))
        feats.append(B(("branch0", "branch1", "maxpool"),
                       branch0=_seq((1024, 192, (1, 1)),
                                    (192, 192, (3, 3), 2)),
                       branch1=_seq((1024, 256, (1, 1)), (256, 256, *s17),
                                    (256, 320, *s71),
                                    (320, 320, (3, 3), 2))))
        feats += [_InceptionC() for _ in range(3)]
        self.features = nn.Sequential(*feats)

    def _embed(self, x):
        return _gap(self.features(x))


class _ResidualInception(nn.Module):
    """Block35 / Block17 / Block8: branches concatenated, a biased 1x1
    ``conv2d`` back to the input width, ``y * scale + x``, a ReLU (not
    after the last Block8)."""

    def __init__(self, width, scale, branches, relu=True):
        super().__init__()
        self.scale, self.relu, self.names = scale, relu, list(branches)
        for name, mod in branches.items():
            setattr(self, name, mod)
        cat = sum(m[-1].bn.weight.shape[0] if isinstance(m, nn.Sequential)
                  else m.bn.weight.shape[0] for m in branches.values())
        self.conv2d = _conv(cat, width, 1, bias=True)

    def forward(self, x):
        y = self.conv2d(torch.cat([getattr(self, n)(x) for n in self.names],
                                  dim=1))
        y = y * self.scale + x
        return F.relu(y) if self.relu else y


def _block35():
    return _ResidualInception(320, 0.17, dict(
        branch0=_IConv(320, 32, (1, 1)),
        branch1=_seq((320, 32, (1, 1)), (32, 32, (3, 3), 1, (1, 1))),
        branch2=_seq((320, 32, (1, 1)), (32, 48, (3, 3), 1, (1, 1)),
                     (48, 64, (3, 3), 1, (1, 1)))))


def _block17():
    return _ResidualInception(1088, 0.10, dict(
        branch0=_IConv(1088, 192, (1, 1)),
        branch1=_seq((1088, 128, (1, 1)), (128, 160, (1, 7), 1, (0, 3)),
                     (160, 192, (7, 1), 1, (3, 0)))))


def _block8(scale=0.20, relu=True):
    return _ResidualInception(2080, scale, dict(
        branch0=_IConv(2080, 192, (1, 1)),
        branch1=_seq((2080, 192, (1, 1)), (192, 224, (1, 3), 1, (0, 1)),
                     (224, 256, (3, 1), 1, (1, 0)))), relu)


class ReidInceptionResNetV2(ReidBackbone):
    """torchreid InceptionResNetV2: the pooled 1536-wide feature. The
    torch attributes ``repeat_1`` / ``repeat_2`` are the JAX package's
    ``repeatq1`` / ``repeatq2``. Crops under 75 x 75 leave a reduction no
    input."""

    def __init__(self):
        super().__init__()
        C = _IConv
        self.conv2d_1a = C(3, 32, stride=2)
        self.conv2d_2a = C(32, 32)
        self.conv2d_2b = C(32, 64, pad=(1, 1))
        self.conv2d_3b = C(64, 80, (1, 1))
        self.conv2d_4a = C(80, 192)
        self.mixed_5b = _Branches(
            ("branch0", "branch1", "branch2", "branch3"),
            branch0=C(192, 96, (1, 1)),
            branch1=_seq((192, 48, (1, 1)), (48, 64, (5, 5), 1, (2, 2))),
            branch2=_seq((192, 64, (1, 1)), (64, 96, (3, 3), 1, (1, 1)),
                         (96, 96, (3, 3), 1, (1, 1))),
            branch3=_pooled(192, 64))
        self.repeat = nn.Sequential(*[_block35() for _ in range(10)])
        self.mixed_6a = _Branches(
            ("branch0", "branch1", "maxpool"),
            branch0=C(320, 384, stride=2),
            branch1=_seq((320, 256, (1, 1)), (256, 256, (3, 3), 1, (1, 1)),
                         (256, 384, (3, 3), 2)))
        self.repeat_1 = nn.Sequential(*[_block17() for _ in range(20)])
        self.mixed_7a = _Branches(
            ("branch0", "branch1", "branch2", "maxpool"),
            branch0=_seq((1088, 256, (1, 1)), (256, 384, (3, 3), 2)),
            branch1=_seq((1088, 256, (1, 1)), (256, 288, (3, 3), 2)),
            branch2=_seq((1088, 256, (1, 1)), (256, 288, (3, 3), 1, (1, 1)),
                         (288, 320, (3, 3), 2)))
        self.repeat_2 = nn.Sequential(*[_block8() for _ in range(9)])
        self.block8 = _block8(1.0, relu=False)
        self.conv2d_7b = C(2080, 1536, (1, 1))

    def _embed(self, x):
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = self.conv2d_4a(self.conv2d_3b(_maxp3v(x)))
        x = self.repeat(self.mixed_5b(_maxp3v(x)))
        x = self.repeat_1(self.mixed_6a(x))
        x = self.block8(self.repeat_2(self.mixed_7a(x)))
        return _gap(self.conv2d_7b(x))


# -------------------------------------------------------------- registry

_SIMPLE = {"resnet50_ibn_a": ReidResNetIBN, "resnet50_ibn_b": ReidResNetIBNb,
           "resnet50mid": ReidResNetMid, "se_resnet50": ReidSEResNet,
           "densenet121": ReidDenseNet, "squeezenet1_0": ReidSqueezeNet,
           "mlfn": ReidMLFN, "xception": ReidXception,
           "inceptionv4": ReidInceptionV4,
           "inceptionresnetv2": ReidInceptionResNetV2}


def zoo_model(backbone, feat_dim=512, crop_size=(256, 128)):
    """The zoo's model for a ``backbone=`` key other than "osnet" (the JAX
    package's ``select_backbone_model`` keys), built with torch's default
    initialisation on the current default device (build it under
    ``torch.device("meta")`` to skip that). Raises ValueError for an
    unknown key and for HACNN and MuDeep given another crop than their
    fixed input."""
    from tracklab_torch.models.nasnet_reid import ReidNASNetAMobile
    from tracklab_torch.models.osnet import OSNET_AIN_VARIANTS, OSNetAIN

    ain = backbone.replace("osnet_", "")
    if backbone in RESNET_VARIANTS:
        return ReidResNet(backbone)
    if backbone in MOBILENETV2_VARIANTS:
        return ReidMobileNetV2(backbone)
    if ain in OSNET_AIN_VARIANTS:
        return OSNetAIN(ain, feat_dim)
    if backbone in SHUFFLENETV2_VARIANTS:
        return ReidShuffleNetV2(backbone)
    if backbone in _SIMPLE:
        return _SIMPLE[backbone]()
    if backbone == "nasnetamobile":
        return ReidNASNetAMobile()
    if backbone in ("pcb_p6", "pcb_p4"):
        return ReidPCB(parts=6 if backbone == "pcb_p6" else 4)
    if backbone == "hacnn":
        if tuple(crop_size) != (160, 64):
            raise ValueError("HACNN requires crop_size=(160, 64) "
                             "(fixed upstream input)")
        return ReidHACNN()
    if backbone == "mudeep":
        if tuple(crop_size) != (256, 128):
            raise ValueError("MuDeep requires crop_size=(256, 128)")
        return ReidMuDeep()
    raise ValueError(f"Unknown reid backbone {backbone!r}")
