"""OSNet person re-identification in PyTorch (counterpart of
tracklab_tpu.models.osnet's ``OSNet``).

The omni-scale network behind the reference's ReID zoo (torchreid's
osnet.py; osnet_x1_0 and osnet_ibn_x1_0 are StrongSORT's defaults): a 7x7
stem and max pool, three stages of omni-scale blocks (four lite streams of
depth 1..4 from a 1x1 bottleneck, each a 1x1 and a depthwise 3x3, fused by
one shared channel gate) with 1x1 + average-pool transitions, a 1x1 conv5,
and the Linear + BN + ReLU feature head; beside it the JAX package's
first-party part head (horizontal stripes, a dense layer, visibility from
the stripes' activation mass).

Module attribute names are torchreid's, so ``state_dict()`` keys are the
keys of a torchreid ``osnet_x1_0`` checkpoint (``models.convert`` maps the
flax names onto them). Public layout is the JAX package's: NHWC images.
Dtype rule (flax promotion in the JAX model): parameters are f32, convs and
dense layers compute in the model dtype, BatchNorm and InstanceNorm in f32.
The JAX package computes OSNet with XLA convolutions and no Pallas kernel;
here it is cuDNN's, through ``torch.nn.functional``.

Beside it: ``ReidBackbone``, the base of the ReID backbone zoo's
global-feature models (``models/reid_backbones.py``, ``nasnet_reid.py``),
and ``OSNetAIN`` (torchreid's osnet_ain_x*: per-stream lite-conv stacks, one
shared gate, InstanceNorm inside selected residuals), one of them.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tracklab_torch.device import resolve_device

__all__ = ["OSNet", "OSNET_VARIANTS", "OSNetAIN", "OSNET_AIN_VARIANTS",
           "ReidBackbone"]

OSNET_VARIANTS = {
    # channels per stage, blocks per stage (torchreid osnet.py factories)
    "x1_0": dict(channels=(64, 256, 384, 512), blocks=(2, 2, 2)),
    "x0_75": dict(channels=(48, 192, 288, 384), blocks=(2, 2, 2)),
    "x0_5": dict(channels=(32, 128, 192, 256), blocks=(2, 2, 2)),
    "x0_25": dict(channels=(16, 64, 96, 128), blocks=(2, 2, 2)),
}
_EPS = 1e-5


class _Conv(nn.Conv2d):
    """``nn.Conv2d`` with f32 parameters computing in ``dtype``."""

    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1,
                 bias=False, dtype=torch.float32):
        super().__init__(cin, cout, k, stride, padding, groups=groups,
                         bias=bias)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt),
                        self.stride, self.padding, groups=self.groups)


class _Linear(nn.Linear):
    """``nn.Linear`` with f32 parameters computing in ``dtype`` (flax
    ``nn.Dense(dtype=...)``)."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__(cin, cout)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _BatchNorm(nn.Module):
    """Inference flax ``nn.BatchNorm(epsilon=eps)`` over dim 1 (NCHW or
    (B, C)) in f32: ``(x - mean) * (rsqrt(var + eps) * weight) + bias``."""

    def __init__(self, c, eps=_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        sh = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean.view(sh)) * mul.view(sh)
                + self.bias.view(sh))


class _InstanceNorm(nn.Module):
    """``nn.InstanceNorm2d(affine=True)`` as the JAX model computes it (a
    flax ``GroupNorm`` with one group per channel): per sample and channel,
    var = mean(x^2) - mean(x)^2 (at least 0), in f32."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = torch.clamp((x * x).mean(dim=(2, 3), keepdim=True)
                          - mean * mean, min=0.0)
        sh = (1, -1, 1, 1)
        return ((x - mean) * (torch.rsqrt(var + _EPS) * self.weight.view(sh))
                + self.bias.view(sh))


class ConvLayer(nn.Module):
    """conv + BN (or InstanceNorm, still named ``bn``) + ReLU."""

    def __init__(self, cin, cout, k, stride=1, instance_norm=False,
                 dtype=torch.float32):
        super().__init__()
        self.conv = _Conv(cin, cout, k, stride, k // 2, dtype=dtype)
        self.bn = _InstanceNorm(cout) if instance_norm else _BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Conv1x1(nn.Module):
    """1x1 conv + BN + ReLU (``relu=False``: Conv1x1Linear)."""

    def __init__(self, cin, cout, relu=True, dtype=torch.float32):
        super().__init__()
        self.conv = _Conv(cin, cout, 1, dtype=dtype)
        self.bn = _BatchNorm(cout)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class LightConv3x3(nn.Module):
    """1x1 (linear) + depthwise 3x3 + BN + ReLU."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.conv1 = _Conv(cin, cout, 1, dtype=dtype)
        self.conv2 = _Conv(cout, cout, 3, 1, 1, groups=cout, dtype=dtype)
        self.bn = _BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv2(self.conv1(x))))


class ChannelGate(nn.Module):
    """The unified aggregation gate: global average -> fc1 (1x1 conv with
    bias, reduction 16) -> ReLU -> fc2 -> sigmoid; returns input * gate."""

    def __init__(self, c, reduction=16, dtype=torch.float32):
        super().__init__()
        self.fc1 = _Conv(c, c // reduction, 1, bias=True, dtype=dtype)
        self.fc2 = _Conv(c // reduction, c, 1, bias=True, dtype=dtype)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class OSBlock(nn.Module):
    """Omni-scale block: four independent lite streams of depth 1..4 from
    the bottleneck, one shared gate, a linear 1x1, the residual (projected
    when the width changes) and, in IBN's conv2 stage, an InstanceNorm."""

    def __init__(self, cin, cout, instance_norm=False, dtype=torch.float32):
        super().__init__()
        mid = cout // 4
        self.conv1 = Conv1x1(cin, mid, dtype=dtype)
        self.conv2a = LightConv3x3(mid, mid, dtype)
        self.conv2b = nn.Sequential(*[LightConv3x3(mid, mid, dtype)
                                      for _ in range(2)])
        self.conv2c = nn.Sequential(*[LightConv3x3(mid, mid, dtype)
                                      for _ in range(3)])
        self.conv2d = nn.Sequential(*[LightConv3x3(mid, mid, dtype)
                                      for _ in range(4)])
        self.gate = ChannelGate(mid, dtype=dtype)
        self.conv3 = Conv1x1(mid, cout, relu=False, dtype=dtype)
        self.downsample = (Conv1x1(cin, cout, relu=False, dtype=dtype)
                           if cin != cout else None)
        self.IN = _InstanceNorm(cout) if instance_norm else None

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = (self.gate(self.conv2a(x1)) + self.gate(self.conv2b(x1))
              + self.gate(self.conv2c(x1)) + self.gate(self.conv2d(x1)))
        identity = x if self.downsample is None else self.downsample(x)
        out = self.conv3(x2) + identity
        if self.IN is not None:
            out = self.IN(out)
        return F.relu(out)


class OSNet(nn.Module):
    """Backbone + global and part feature heads on ``device`` (``cuda``
    unless told otherwise).

    ``forward(images (B, H, W, 3))`` (NHWC, already normalised) returns a
    dict of f32 tensors: ``embeddings`` (B, feat_dim), the eval-mode output
    of torchreid's model; ``part_features`` (B, n_parts + 1, feat_dim), the
    global feature and one per horizontal stripe; ``visibility`` (B,
    n_parts + 1), 1 for the global part and each stripe's activation mass
    over the largest. ``ibn=True`` is osnet_ibn_x1_0: InstanceNorm in the
    stem and after the residual of every conv2-stage block.
    ``in_channels`` is the stem's input width: 3, or 3 + the keypoint
    prompt channels of ``OSNetReId(use_keypoints=True)`` (8)."""

    def __init__(self, variant="x1_0", feat_dim=512, n_parts=6, ibn=False,
                 in_channels=3, dtype=torch.float32, device=None):
        super().__init__()
        v = OSNET_VARIANTS[variant]
        chans, blocks = v["channels"], v["blocks"]
        self.n_parts = n_parts
        self.conv1 = ConvLayer(in_channels, chans[0], 7, 2,
                               instance_norm=ibn, dtype=dtype)
        cin = chans[0]
        for stage, (c, n) in enumerate(zip(chans[1:], blocks)):
            layers = []
            for b in range(n):
                layers.append(OSBlock(cin if b == 0 else c, c,
                                      instance_norm=ibn and stage == 0,
                                      dtype=dtype))
            if stage < len(blocks) - 1:
                layers.append(nn.Sequential(Conv1x1(c, c, dtype=dtype),
                                            nn.AvgPool2d(2, 2)))
            setattr(self, f"conv{stage + 2}", nn.Sequential(*layers))
            cin = c
        self.conv5 = Conv1x1(chans[-1], chans[-1], dtype=dtype)
        self.fc = nn.Sequential(_Linear(chans[-1], feat_dim, dtype),
                                _BatchNorm(feat_dim))
        self.part_fc = _Linear(chans[-1], feat_dim, dtype)
        self.to(resolve_device(device))

    @torch.no_grad()
    def forward(self, images):
        x = images.permute(0, 3, 1, 2)
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        x = self.conv5(self.conv4(self.conv3(self.conv2(x))))
        g = F.relu(self.fc(x.mean(dim=(2, 3))))

        # part head: stripes of H // P rows (rows past P * (H // P) unused)
        B, C, H, W = x.shape
        P = self.n_parts
        usable = (H // P) * P
        stripes = x[:, :, :usable].reshape(B, C, P, usable // P, W)
        part_feat = self.part_fc(stripes.mean(dim=(3, 4)).transpose(1, 2))
        mass = stripes.abs().mean(dim=(1, 3, 4))               # (B, P)
        vis = mass / torch.clamp(mass.amax(dim=1, keepdim=True), min=1e-6)
        parts = torch.cat([g[:, None, :], part_feat.to(g.dtype)], dim=1)
        vis_full = torch.cat([torch.ones_like(vis[:, :1]), vis], dim=1)
        return {"embeddings": g.float(), "part_features": parts.float(),
                "visibility": vis_full.float()}

    @torch.no_grad()
    def randomize_(self, seed: int = 0):
        """Seeded random weights for runs without a checkpoint: convs
        He-normal (std sqrt(2 / fan_in)), linear layers normal(0.01) as
        torchreid initialises them, BatchNorm and InstanceNorm at identity,
        biases zero. Draws on the CPU, so a seed gives the same weights on
        every device."""
        g = torch.Generator().manual_seed(seed)
        for name, t in self.state_dict().items():
            if t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=g)
                        * math.sqrt(2.0 / t[0].numel()))
            elif t.dim() == 2:
                t.copy_(torch.randn(t.shape, generator=g) * 0.01)
            elif name.endswith("running_var") or (
                    name.endswith("weight") and t.dim() == 1):
                t.fill_(1.0)
            else:
                t.zero_()
        return self


class ReidBackbone(nn.Module):
    """A global-feature backbone of the ReID zoo. ``forward(images (B, H, W,
    C))`` (NHWC, already normalised, f32) returns the eval-mode feature
    vector (B, D) in f32, the appearance embedding StrongSORT consumes;
    subclasses compute it from NCHW in ``_embed``."""

    def _embed(self, x):
        raise NotImplementedError

    @torch.no_grad()
    def forward(self, images):
        return self._embed(images.permute(0, 3, 1, 2)).float()

    @torch.no_grad()
    def randomize_(self, seed: int = 0):
        """Seeded random weights for runs without a checkpoint, drawn on the
        CPU (the same on every device): conv kernels He-normal (std
        sqrt(2 / fan_in)), linear weights normal(0.01), BatchNorm and
        InstanceNorm at identity, biases zero, and raw parameters (MuDeep's
        fusion weights) uniform in [0, 1) as flax initialises them."""
        g = torch.Generator().manual_seed(seed)
        for name, t in self.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=g)
                        * math.sqrt(2.0 / t[0].numel()))
            elif leaf == "weight" and t.dim() == 2:
                t.copy_(torch.randn(t.shape, generator=g) * 0.01)
            elif leaf in ("weight", "running_var"):
                t.fill_(1.0)
            elif leaf in ("bias", "running_mean"):
                t.zero_()
            else:
                t.copy_(torch.rand(t.shape, generator=g))
        return self


# ---------------------------------------------------------------------------
# OSNet-AIN (torchreid osnet_ain.py): the counterpart of the JAX package's
# ``OSNetAIN``
# ---------------------------------------------------------------------------

OSNET_AIN_VARIANTS = {
    # channels and per-stage block kinds (True: OSBlockINin)
    "ain_x1_0": dict(channels=(64, 256, 384, 512),
                     blocks=((True, True), (False, True), (True, False))),
    "ain_x0_75": dict(channels=(48, 192, 288, 384),
                      blocks=((True, True), (False, True), (True, False))),
    "ain_x0_5": dict(channels=(32, 128, 192, 256),
                     blocks=((True, True), (False, True), (True, False))),
    "ain_x0_25": dict(channels=(16, 64, 96, 128),
                      blocks=((True, True), (False, True), (True, False))),
}


class _LightConvStream(nn.Module):
    """``depth`` LightConv3x3 layers (torchreid's ``layers``)."""

    def __init__(self, c, depth):
        super().__init__()
        self.layers = nn.Sequential(*[LightConv3x3(c, c)
                                      for _ in range(depth)])

    def forward(self, x):
        return self.layers(x)


class _Conv1x1NoBN(nn.Module):
    """Conv1x1Linear(bn=False): a bare 1x1 conv named ``conv``."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = _Conv(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


class OSBlockAIN(nn.Module):
    """osnet_ain's OSBlock / OSBlockINin: four lite streams of depth 1..4
    from a 1x1 bottleneck (width / 4), one shared gate, a linear 1x1 out;
    the INin kind drops the 1x1's BN and instance-normalises it before the
    residual add."""

    def __init__(self, cin, cout, instance_norm=False, T=4, reduction=4):
        super().__init__()
        mid = cout // reduction
        self.conv1 = Conv1x1(cin, mid)
        self.conv2 = nn.ModuleList([_LightConvStream(mid, t + 1)
                                    for t in range(T)])
        self.gate = ChannelGate(mid)
        if instance_norm:
            self.conv3 = _Conv1x1NoBN(mid, cout)
            self.IN = _InstanceNorm(cout)
        else:
            self.conv3 = Conv1x1(mid, cout, relu=False)
            self.IN = None
        self.downsample = (Conv1x1(cin, cout, relu=False)
                           if cin != cout else None)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = None
        for stream in self.conv2:
            s = self.gate(stream(x1))
            x2 = s if x2 is None else x2 + s
        x3 = self.conv3(x2)
        if self.IN is not None:
            x3 = self.IN(x3)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(x3 + identity)


class OSNetAIN(ReidBackbone):
    """osnet_ain_x*: an InstanceNorm stem, three stages of OSBlockAIN with
    1x1 + average-pool transitions (``pool2``, ``pool3``), a 1x1 conv5 and
    the Linear + BN + ReLU head; returns the (B, feat_dim) feature."""

    def __init__(self, variant="ain_x1_0", feat_dim=512):
        super().__init__()
        v = OSNET_AIN_VARIANTS[variant]
        chans = v["channels"]
        self.conv1 = ConvLayer(3, chans[0], 7, 2, instance_norm=True)
        cin = chans[0]
        for stage, kinds in enumerate(v["blocks"]):
            c = chans[stage + 1]
            setattr(self, f"conv{stage + 2}", nn.Sequential(
                *[OSBlockAIN(cin if b == 0 else c, c, instance_norm=inin)
                  for b, inin in enumerate(kinds)]))
            if stage < len(v["blocks"]) - 1:
                setattr(self, f"pool{stage + 2}", nn.Sequential(
                    Conv1x1(c, c), nn.AvgPool2d(2, 2)))
            cin = c
        self.conv5 = Conv1x1(chans[-1], chans[-1])
        self.fc = nn.Sequential(_Linear(chans[-1], feat_dim),
                                _BatchNorm(feat_dim), nn.ReLU())

    def _embed(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        x = self.pool2(self.conv2(x))
        x = self.pool3(self.conv3(x))
        x = self.conv5(self.conv4(x))
        return self.fc(x.mean(dim=(2, 3)))
