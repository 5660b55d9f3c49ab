"""NASNet-A mobile for ReID in PyTorch (counterpart of
tracklab_tpu.models.nasnet_reid).

torchreid's nasnetamobile: two stem cells, then three groups of a first
cell and three normal cells with a reduction cell between groups, built
from separable branches, with NASNet's shifted pad-and-crop pools and
shortcuts, as the JAX package computes them:

- ``_maxpool_pad`` pads the top-left row and column with -inf before its
  3x3 / 2 pool (torchreid pads zeros); the crop after the pool drops the
  windows that see that row and column, so the two agree;
- ``_avgpool_pad`` pads zeros, which count in the mean (the pool excludes
  only its own padding);
- BatchNorm epsilon is 1e-3.

Module attribute names are torchreid's (``cell_stem_0``, ``conv_1x1``,
``comb_iter_0_left``, ``separable_1``, ...), which the JAX package spells
with 'q' for the literal underscores; each cell is an ``nn.ModuleDict``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tracklab_torch.models.osnet import ReidBackbone, _BatchNorm

__all__ = ["ReidNASNetAMobile"]

_NEG = float("-inf")


def _bn(c):
    return _BatchNorm(c, eps=1e-3)


def _maxpool_pad(x):
    """MaxPoolPad: pad top-left with -inf, 3x3 / 2 pool (padding 1), crop
    the first row and column."""
    y = F.max_pool2d(F.pad(x, (1, 0, 1, 0), value=_NEG), 3, 2, 1)
    return y[:, :, 1:, 1:]


def _avgpool_pad(x):
    """AvgPoolPad: pad top-left with zeros (counted), 3x3 / 2 average pool
    excluding its own padding, crop the first row and column."""
    y = F.avg_pool2d(F.pad(x, (1, 0, 1, 0)), 3, 2, 1,
                     count_include_pad=False)
    return y[:, :, 1:, 1:]


def _avgp31(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _maxp321(x):
    return F.max_pool2d(x, 3, 2, 1)


def _avgp321(x):
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


class _SepConv(nn.Module):
    """SeparableConv2d: ``depthwise_conv2d`` + ``pointwise_conv2d``."""

    def __init__(self, cin, cout, k, stride=1, pad=0):
        super().__init__()
        self.depthwise_conv2d = nn.Conv2d(cin, cin, k, stride, pad,
                                          groups=cin, bias=False)
        self.pointwise_conv2d = nn.Conv2d(cin, cout, 1, bias=False)

    def forward(self, x):
        return self.pointwise_conv2d(self.depthwise_conv2d(x))


class _BranchSep(nn.Module):
    """BranchSeparables: ReLU -> separable (k, stride) -> BN -> ReLU ->
    separable (k, 1) -> BN. ``mode`` "specific" and "reduction" pad the
    top-left with zeros before the first separable and crop the first row
    and column after it; "stem" lets the first separable change the
    width."""

    def __init__(self, cin, cout, k, stride=1, mode=""):
        super().__init__()
        p = k // 2
        mid = cout if mode == "stem" else cin
        self.crop = mode in ("specific", "reduction")
        self.separable_1 = _SepConv(cin, mid, k, stride, p)
        self.bn_sep_1 = _bn(mid)
        self.separable_2 = _SepConv(mid, cout, k, 1, p)
        self.bn_sep_2 = _bn(cout)

    def forward(self, x):
        x = F.relu(x)
        if self.crop:
            x = F.pad(x, (1, 0, 1, 0))
        x = self.separable_1(x)
        if self.crop:
            x = x[:, :, 1:, 1:]
        x = F.relu(self.bn_sep_1(x))
        return self.bn_sep_2(self.separable_2(x))


class _ReluConvBn(nn.Module):
    """The ``conv_1x1`` / ``conv_prev_1x1`` Sequential: ReLU -> 1x1 conv
    -> BN."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = _bn(cout)

    def forward(self, x):
        return self.bn(self.conv(F.relu(x)))


def _shifted_paths(cell, x_relu):
    """path_1 / path_2 + final_path_bn: the stride-2 1x1 shortcut pair
    (path_2 sees the map shifted by one row and column, zero-padded at the
    bottom-right)."""
    p1 = cell["path_1"]["conv"](x_relu[:, :, ::2, ::2])
    p2 = F.pad(x_relu, (0, 1, 0, 1))[:, :, 1:, 1:]
    p2 = cell["path_2"]["conv"](p2[:, :, ::2, ::2])
    return cell["final_path_bn"](torch.cat([p1, p2], dim=1))


def _paths(cin, half):
    return dict(path_1=nn.ModuleDict(dict(conv=nn.Conv2d(cin, half, 1,
                                                         bias=False))),
                path_2=nn.ModuleDict(dict(conv=nn.Conv2d(cin, half, 1,
                                                         bias=False))),
                final_path_bn=_bn(2 * half))


class ReidNASNetAMobile(ReidBackbone):
    """nasnetamobile: the pooled feature after a ReLU (24 x
    penultimate_filters / 24 = 1056 wide at the defaults)."""

    def __init__(self, stem_filters=32, penultimate_filters=1056):
        super().__init__()
        f = penultimate_filters // 24
        B = _BranchSep
        self.conv0 = nn.ModuleDict(dict(
            conv=nn.Conv2d(3, stem_filters, 3, 2, 0, bias=False),
            bn=_bn(stem_filters)))
        nf0, sf = f // 4, stem_filters
        self.cell_stem_0 = nn.ModuleDict(dict(
            conv_1x1=_ReluConvBn(sf, nf0),
            comb_iter_0_left=B(nf0, nf0, 5, 2),
            comb_iter_0_right=B(sf, nf0, 7, 2, "stem"),
            comb_iter_1_right=B(sf, nf0, 7, 2, "stem"),
            comb_iter_2_right=B(sf, nf0, 5, 2, "stem"),
            comb_iter_4_left=B(nf0, nf0, 3, 1)))
        nf1 = f // 2
        self.cell_stem_1 = nn.ModuleDict(dict(
            conv_1x1=_ReluConvBn(4 * nf0, nf1), **_paths(sf, nf1 // 2),
            comb_iter_0_left=B(nf1, nf1, 5, 2, "specific"),
            comb_iter_0_right=B(nf1, nf1, 7, 2, "specific"),
            comb_iter_1_right=B(nf1, nf1, 7, 2, "specific"),
            comb_iter_2_right=B(nf1, nf1, 5, 2, "specific"),
            comb_iter_4_left=B(nf1, nf1, 3, 1, "specific")))
        # (name, kind, width of x, width of x_prev, out_l, out_r); the
        # widths are those of the cells' concatenations
        plan, x_c, prev_c = [], 4 * nf1, 4 * nf0
        for g, mult in enumerate((1, 2, 4)):
            base = 6 * g
            if g:
                plan.append((f"reduction_cell_{g - 1}", "reduction", x_c,
                             prev_c, mult * f, mult * f))
                x_c, prev_c = 4 * mult * f, x_c
            plan.append((f"cell_{base}", "first", x_c, prev_c,
                         mult * f // 2, mult * f))
            x_c, prev_c = 6 * mult * f, x_c
            for i in (1, 2, 3):
                plan.append((f"cell_{base + i}", "normal", x_c, prev_c,
                             mult * f, mult * f))
                x_c, prev_c = 6 * mult * f, x_c
        # the first reduction cell crops like ReductionCell0, the second
        # like CellStem1 ("specific")
        self.plan = []
        for name, kind, xc, pc, out_l, out_r in plan:
            if kind == "first":
                cell = dict(conv_1x1=_ReluConvBn(xc, out_r),
                            **_paths(pc, out_l),
                            comb_iter_0_left=B(out_r, out_r, 5),
                            comb_iter_0_right=B(out_l * 2, out_r, 3),
                            comb_iter_1_left=B(out_l * 2, out_r, 5),
                            comb_iter_1_right=B(out_l * 2, out_r, 3),
                            comb_iter_4_left=B(out_r, out_r, 3))
            elif kind == "normal":
                cell = dict(conv_prev_1x1=_ReluConvBn(pc, out_l),
                            conv_1x1=_ReluConvBn(xc, out_r),
                            comb_iter_0_left=B(out_r, out_r, 5),
                            comb_iter_0_right=B(out_l, out_l, 3),
                            comb_iter_1_left=B(out_l, out_l, 5),
                            comb_iter_1_right=B(out_l, out_l, 3),
                            comb_iter_4_left=B(out_r, out_r, 3))
            else:
                mode = "specific" if name.endswith("_1") else "reduction"
                o = out_l
                cell = dict(conv_prev_1x1=_ReluConvBn(pc, o),
                            conv_1x1=_ReluConvBn(xc, o),
                            comb_iter_0_left=B(o, o, 5, 2, mode),
                            comb_iter_0_right=B(o, o, 7, 2, mode),
                            comb_iter_1_right=B(o, o, 7, 2, mode),
                            comb_iter_2_right=B(o, o, 5, 2, mode),
                            comb_iter_4_left=B(o, o, 3, 1, mode))
            setattr(self, name, nn.ModuleDict(cell))
            self.plan.append((name, kind))

    def _embed(self, x):
        x_conv0 = self.conv0["bn"](self.conv0["conv"](x))
        c = self.cell_stem_0
        x1 = c["conv_1x1"](x_conv0)
        c0 = c["comb_iter_0_left"](x1) + c["comb_iter_0_right"](x_conv0)
        c1 = _maxp321(x1) + c["comb_iter_1_right"](x_conv0)
        c2 = _avgp321(x1) + c["comb_iter_2_right"](x_conv0)
        c3 = _avgp31(c0) + c1
        c4 = c["comb_iter_4_left"](c0) + _maxp321(x1)
        x_stem_0 = torch.cat([c1, c2, c3, c4], dim=1)

        c = self.cell_stem_1
        x_left = c["conv_1x1"](x_stem_0)
        x_right = _shifted_paths(c, F.relu(x_conv0))
        prev, x = x_stem_0, self._reduce(c, x_left, x_right)
        for name, kind in self.plan:
            cell = getattr(self, name)
            if kind == "reduction":
                a = cell["conv_1x1"](x)
                b = cell["conv_prev_1x1"](prev)
                prev, x = x, self._reduce(cell, a, b)
            else:
                prev, x = x, self._cell(cell, kind, x, prev)
        return F.relu(x).mean(dim=(2, 3))

    @staticmethod
    def _reduce(c, a, b):
        """CellStem1's and the reduction cells' combinations of (a, b)."""
        c0 = c["comb_iter_0_left"](a) + c["comb_iter_0_right"](b)
        c1 = _maxpool_pad(a) + c["comb_iter_1_right"](b)
        c2 = _avgpool_pad(a) + c["comb_iter_2_right"](b)
        c3 = _avgp31(c0) + c1
        c4 = c["comb_iter_4_left"](c0) + _maxpool_pad(a)
        return torch.cat([c1, c2, c3, c4], dim=1)

    @staticmethod
    def _cell(c, kind, x, x_prev):
        """A first cell (its left input the shifted paths of x_prev) or a
        normal cell."""
        x_right = c["conv_1x1"](x)
        x_left = (_shifted_paths(c, F.relu(x_prev)) if kind == "first"
                  else c["conv_prev_1x1"](x_prev))
        c0 = c["comb_iter_0_left"](x_right) + c["comb_iter_0_right"](x_left)
        c1 = c["comb_iter_1_left"](x_left) + c["comb_iter_1_right"](x_left)
        c2 = _avgp31(x_right) + x_left
        c3 = _avgp31(x_left) + _avgp31(x_left)
        c4 = c["comb_iter_4_left"](x_right) + x_right
        return torch.cat([x_left, c0, c1, c2, c3, c4], dim=1)
