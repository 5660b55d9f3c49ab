"""K3: the fused CSPLayer kernel (``csrc/csp.cu``), its weight packing,
its tile planner and its dispatch.

Replaces the Pallas TPU kernel ``tracklab_tpu/ops/csp_pallas.py``
(``_make_kernel`` behind ``fused_csplayer``). The CUDA kernels run one CTA
per (frame, spatial tile) with an n-pixel halo and keep the layer's
intermediates in shared memory; they are bound by operations (~600 FLOP/B
at YOLOX-s 640). Both run on the tensor cores (``mma.sync`` with
``ldmatrix`` and a ``cp.async`` ring).

The staged route (:data:`STAGED`) keeps the intermediates in device memory
and runs the layer's 2n + 3 stages as GEMMs over the whole batch. bf16
takes it where the haloed region exceeds shared memory at every tile, so
K3 takes every dense layer the JAX kernel takes; f32 takes it at every
layer, in 3xTF32 (each operand split into two TF32 parts, three
products): its haloed buffers take twice the bytes, and the tiles that fit
lost to the staged route at every YOLOX-s layer timed. See the source note
in ``csrc/csp.cu``.

The plain version is the unfused layer, ``CSPLayer.forward_plain``
(``models/yolox.py``). :func:`fused_csplayer` runs it for CPU tensors and
launches the kernel :func:`route` names for CUDA tensors, with the plan
:func:`choose_tile` gives; a layer the kernel refuses raises ValueError.
Its ``launches`` attribute counts layers run on the card, one for each call
of the C entry point (the staged route's entry runs its stage grids).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from tracklab_torch.models.yolox import BN_EPS

__all__ = ["fold_convbn", "pack_csplayer", "smem_bytes", "choose_tile",
           "route", "fused_csplayer", "SMEM_LIMIT", "STAGED"]

SMEM_LIMIT = 232448    # bytes of shared memory one Hopper CTA may use
# the bf16 tiled kernel's two cp.async rings (csrc/csp.cu: Wide, Compact):
# (CTA tile rows, ring bytes); each slot holds a rows x KX chunk of x and a
# 64 x KX chunk of weights, rows padded by 8 elements
_RINGS = ((256, 3 * (256 + 64) * (32 + 8) * 2),    # KX 32, three slots
          (64, 2 * (64 + 64) * (16 + 8) * 2))      # KX 16, two slots
_MMA_BN = 64          # CTA tile channels of both rings
STAGED = 2            # the plan's ring for the staged route
_MULT = {torch.float32: 4, torch.bfloat16: 8}     # channel multiples


def fold_convbn(m):
    """A ConvBnAct (``.conv.weight`` OIHW, ``.bn``) -> (W OIHW f32, b f32)
    with BN folded: silu(bn(conv(x))) == silu(conv(x; W) + b) exactly in
    real arithmetic."""
    bn = m.bn
    scale = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    return (m.conv.weight * scale[:, None, None, None],
            bn.bias - bn.running_mean * scale)


def pack_csplayer(layer, dtype) -> dict:
    """Fold a CSPLayer's weights and lay them out for the kernel, in
    ``dtype``; biases f32. Both types take them K-contiguous, [out, in]
    (the col-major B operand): ``wm``/``ws`` (ch, cin), ``w1`` (n, ch, ch),
    ``w3`` (n, 9, ch, ch) with tap dy * 3 + dx, ``wf`` (cout, 2 ch) with
    columns [main; short]."""
    def one_by_one(m):
        w, b = fold_convbn(m)
        return w[:, :, 0, 0], b

    wm, bm = one_by_one(layer.conv1)
    ws, bs = one_by_one(layer.conv2)
    wf, bf = one_by_one(layer.conv3)
    w1, b1, w3, b3 = [], [], [], []
    for blk in layer.m:
        w, b = one_by_one(blk.conv1)
        w1.append(w)
        b1.append(b)
        w, b = fold_convbn(blk.conv2)
        co, ci = w.shape[:2]
        w3.append(w.permute(2, 3, 0, 1).reshape(9, co, ci))
        b3.append(b)
    def cast(t):
        return t.to(dtype).contiguous()

    f32 = lambda t: t.float().contiguous()             # noqa: E731
    return dict(wm=cast(wm), bm=f32(bm), ws=cast(ws), bs=f32(bs),
                w1=cast(torch.stack(w1)), b1=f32(torch.stack(b1)),
                w3=cast(torch.stack(w3)), b3=f32(torch.stack(b3)),
                wf=cast(wf), bf=f32(bf))


def smem_bytes(th, tw, n, ch, ring=0) -> int:
    """Shared memory one CTA of the bf16 tiled kernel asks for with th x tw
    output tiles: the two haloed (th + 2n) x (tw + 2n) x ch buffers (a and
    t) with 8 elements of row padding, and cp.async ring ``ring`` (0 wide,
    1 compact). ``csrc/csp.cu`` computes the same sum
    (``tl_csp_smem_bytes``) and refuses a launch over :data:`SMEM_LIMIT`."""
    region = (th + 2 * n) * (tw + 2 * n)
    return 2 * region * (ch + 8) * 2 + _RINGS[ring][1]


def _work(th, tw, H, W, n, cin, ch, cout, bm):
    """The kernel's work for one frame with th x tw tiles and bm-row CTA
    tiles, counted in its own units: each stage's GEMM rounded up to whole
    (bm x 64) tiles, times K. It counts the halo's recomputation and ragged
    tiles."""
    def gemm(pix, N, K):
        return math.ceil(pix / bm) * math.ceil(N / _MMA_BN) * K

    RH, RW = th + 2 * n, tw + 2 * n
    w = gemm(RH * RW, ch, cin) + gemm(th * tw, ch, cin) \
        + gemm(th * tw, cout, 2 * ch)
    for i in range(n):
        w += gemm((RH - 2 * i) * (RW - 2 * i), ch, ch) \
            + gemm((RH - 2 * i - 2) * (RW - 2 * i - 2), ch, 9 * ch)
    return math.ceil(H / th) * math.ceil(W / tw) * w


@functools.cache
def choose_tile(H, W, n, cin, ch, cout, dtype):
    """(th, tw, ring): the plan K3 runs the layer with.

    bf16: the output tile whose plan fits in :data:`SMEM_LIMIT` and needs
    the least work (:func:`_work`), larger tiles first on a tie, with the
    wide ring where any tile fits with it and the compact ring otherwise;
    where no tile fits (the region of a single output pixel, (2n + 1)^2
    pixels of a and t, is already too large, as for dark4 of YOLOX-l and
    dark3 and dark4 of YOLOX-x), (H, W, :data:`STAGED`): the staged route,
    whose shared memory does not depend on the layer. f32: the staged
    route."""
    if dtype == torch.bfloat16:
        for ring, (bm, _) in enumerate(_RINGS):
            best = None
            for th in range(1, H + 1):
                for tw in range(1, W + 1):
                    if smem_bytes(th, tw, n, ch, ring) > SMEM_LIMIT:
                        break
                    key = (_work(th, tw, H, W, n, cin, ch, cout, bm),
                           -th * tw)
                    if best is None or key < best[0]:
                        best = (key, (th, tw, ring))
            if best is not None:
                return best[1]
    return H, W, STAGED


def route(dtype, cin, ch, cout) -> str:
    """The C entry point that runs a CSPLayer in ``dtype`` on the card's
    tensor cores (the staged route's carries ``_staged`` after it, and is
    f32's only one): bf16 needs channel counts that are multiples of 8, f32
    (3xTF32) multiples of 4 (one 16-byte piece). Raises for what neither
    takes; never picks another type's kernel or the plain layer."""
    if dtype not in _MULT:
        raise TypeError(f"K3 takes f32 or bf16, not {dtype}")
    mult = _MULT[dtype]
    if cin % mult or ch % mult or cout % mult:
        raise ValueError(f"K3's {str(dtype)[6:]} kernel needs channel counts "
                         f"that are multiples of {mult}; got cin={cin}, "
                         f"ch={ch}, cout={cout}")
    return "tl_csp_bf16_mma" if dtype == torch.bfloat16 else "tl_csp_f32"


@functools.cache
def _lib(symbol):
    from tracklab_torch.kernels._build import load

    fn = getattr(load("csp"), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 8
                   if symbol.endswith("_staged") else
                   [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_csplayer(layer, x: torch.Tensor) -> torch.Tensor:
    """Run ``layer`` (a dense ``models.yolox.CSPLayer``) on ``x`` (B, C, H,
    W). CPU tensors take the plain layer; CUDA tensors launch K3 in the
    layer's dtype (:func:`route`) with :func:`choose_tile`'s plan and get
    an NCHW view of an NHWC (channels-last) result."""
    if not x.is_cuda:
        return layer.forward_plain(x)
    if layer.depthwise:
        raise ValueError("K3 takes dense CSPLayers only")
    dtype = layer.dtype
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    B, cin, H, W = x.shape
    n, ch = len(layer.m), layer.conv1.conv.weight.shape[0]
    cout = layer.conv3.conv.weight.shape[0]
    if layer.conv1.conv.weight.shape[1] != cin:
        raise ValueError(f"x has {cin} channels, the layer takes "
                         f"{layer.conv1.conv.weight.shape[1]}")
    symbol = route(dtype, cin, ch, cout)
    th, tw, ring = choose_tile(H, W, n, cin, ch, cout, dtype)
    p = pack_csplayer(layer, dtype)
    xh = x.to(dtype).permute(0, 2, 3, 1).contiguous()
    out = torch.empty((B, H, W, cout), dtype=dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = [xh.data_ptr(), out.data_ptr()] + [
        p[k].data_ptr() for k in ("wm", "bm", "ws", "bs", "w1", "b1", "w3",
                                  "b3", "wf", "bf")]
    shape = [B, H, W, cin, ch, cout, n, int(layer.shortcut)]
    with torch.cuda.device(x.device):
        if ring == STAGED:
            scratch = torch.empty((3, B, H, W, ch), dtype=dtype,
                                  device=x.device)
            err = _lib(symbol + "_staged")(*args, scratch.data_ptr(),
                                           *shape, stream)
        else:
            err = _lib(symbol)(*args, *shape, th, tw, ring, stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err}")
    fused_csplayer.launches += 1
    return out.permute(0, 3, 1, 2)


fused_csplayer.launches = 0
