"""K3: the fused CSPLayer kernel (``csrc/csp.cu``), its weight packing and
its dispatch.

Replaces the Pallas TPU kernel ``tracklab_tpu/ops/csp_pallas.py``
(``_make_kernel`` behind ``fused_csplayer``). The CUDA kernel runs one CTA
per (frame, spatial tile) with an n-pixel halo and keeps the layer's
intermediates in shared memory; it is bound by operations (~600 FLOP/B at
YOLOX-s 640). See the source note in ``csrc/csp.cu``.

The plain version is the unfused layer, ``CSPLayer.forward_plain``
(``models/yolox.py``). :func:`fused_csplayer` runs it for CPU tensors and
launches the kernel for CUDA tensors; its ``launches`` attribute counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tracklab_torch.models.yolox import BN_EPS

__all__ = ["fold_convbn", "pack_csplayer", "choose_tile", "fused_csplayer",
           "SMEM_LIMIT"]

SMEM_LIMIT = 232448    # bytes of shared memory one Hopper CTA may use
_TILES = (16, 10, 8, 5, 4, 2, 1)
_DTYPES = {torch.float32: "tl_csp_f32", torch.bfloat16: "tl_csp_bf16"}


def fold_convbn(m):
    """A ConvBnAct (``.conv.weight`` OIHW, ``.bn``) -> (W OIHW f32, b f32)
    with BN folded: silu(bn(conv(x))) == silu(conv(x; W) + b) exactly in
    real arithmetic."""
    bn = m.bn
    scale = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    return (m.conv.weight * scale[:, None, None, None],
            bn.bias - bn.running_mean * scale)


def pack_csplayer(layer, dtype) -> dict:
    """Fold and lay out a CSPLayer's weights for the kernel: ``wm``/``ws``
    (cin, ch), ``w1`` (n, ch, ch), ``w3`` (n, 9, ch, ch) with tap
    dy * 3 + dx, ``wf`` (2 ch, cout) with rows [main; short], all [in, out]
    in ``dtype``; biases f32."""
    def one_by_one(m):
        w, b = fold_convbn(m)
        return w[:, :, 0, 0].t(), b

    wm, bm = one_by_one(layer.conv1)
    ws, bs = one_by_one(layer.conv2)
    wf, bf = one_by_one(layer.conv3)
    w1, b1, w3, b3 = [], [], [], []
    for blk in layer.m:
        w, b = one_by_one(blk.conv1)
        w1.append(w)
        b1.append(b)
        w, b = fold_convbn(blk.conv2)
        ch = w.shape[0]
        w3.append(w.permute(2, 3, 1, 0).reshape(9, ch, ch))
        b3.append(b)
    cast = lambda t: t.to(dtype).contiguous()          # noqa: E731
    f32 = lambda t: t.float().contiguous()             # noqa: E731
    return dict(wm=cast(wm), bm=f32(bm), ws=cast(ws), bs=f32(bs),
                w1=cast(torch.stack(w1)), b1=f32(torch.stack(b1)),
                w3=cast(torch.stack(w3)), b3=f32(torch.stack(b3)),
                wf=cast(wf), bf=f32(bf))


def choose_tile(H, W, n, ch, itemsize):
    """Square output tile side for the kernel: the largest candidate whose
    two haloed (side + 2n)^2 x ch buffers fit in shared memory, preferring
    sides that divide H and W (no ragged tiles)."""
    def fits(ts):
        return 2 * (ts + 2 * n) ** 2 * ch * itemsize <= SMEM_LIMIT

    for want_divisor in (True, False):
        for ts in _TILES:
            if ts <= max(H, W) and fits(ts) and (
                    not want_divisor or (H % ts == 0 and W % ts == 0)):
                return ts
    raise ValueError(f"CSPLayer with ch={ch}, n={n} does not fit in shared "
                     "memory at any tile size")


@functools.cache
def _lib(symbol):
    from tracklab_torch.kernels._build import load

    fn = getattr(load("csp"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_csplayer(layer, x: torch.Tensor) -> torch.Tensor:
    """Run ``layer`` (a dense ``models.yolox.CSPLayer``) on ``x`` (B, C, H,
    W). CPU tensors take the plain layer; CUDA tensors launch K3 in the
    layer's dtype (f32 or bf16) and get an NCHW view of an NHWC
    (channels-last) result."""
    if not x.is_cuda:
        return layer.forward_plain(x)
    if layer.depthwise:
        raise ValueError("K3 takes dense CSPLayers only")
    dtype = layer.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"K3 takes f32 or bf16, not {dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    B, cin, H, W = x.shape
    p = pack_csplayer(layer, dtype)
    n, ch = p["w1"].shape[0], p["w1"].shape[1]
    cout = p["wf"].shape[1]
    if p["wm"].shape[0] != cin or cin % 4 or ch % 4 or cout % 4:
        raise ValueError(f"K3 needs matching channel counts divisible by 4; "
                         f"got cin={cin}, ch={ch}, cout={cout}")
    xh = x.to(dtype).permute(0, 2, 3, 1).contiguous()
    out = torch.empty((B, H, W, cout), dtype=dtype, device=x.device)
    ts = choose_tile(H, W, n, ch, xh.element_size())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda k: p[k].data_ptr()                    # noqa: E731
    with torch.cuda.device(x.device):
        err = _lib(_DTYPES[dtype])(
            xh.data_ptr(), out.data_ptr(), ptr("wm"), ptr("bm"), ptr("ws"),
            ptr("bs"), ptr("w1"), ptr("b1"), ptr("w3"), ptr("b3"),
            ptr("wf"), ptr("bf"), B, H, W, cin, ch, cout, n,
            int(layer.shortcut), ts, ts, stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err}")
    fused_csplayer.launches += 1
    return out.permute(0, 3, 1, 2)


fused_csplayer.launches = 0
