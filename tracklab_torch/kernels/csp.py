"""K3: the fused CSPLayer kernel (``csrc/csp.cu``), its weight packing,
its tile planner and its dispatch.

Replaces the Pallas TPU kernel ``tracklab_tpu/ops/csp_pallas.py``
(``_make_kernel`` behind ``fused_csplayer``). The CUDA kernels run one CTA
per (frame, spatial tile) with an n-pixel halo and keep the layer's
intermediates in shared memory; they are bound by operations (~600 FLOP/B
at YOLOX-s 640). bf16 runs on the tensor cores (``mma.sync`` with
``ldmatrix`` and a ``cp.async`` ring), f32 on CUDA cores; see the source
note in ``csrc/csp.cu``.

A layer whose haloed region exceeds shared memory at every tile takes the
staged route (:data:`STAGED`): its intermediates in device memory and its
2n + 3 stages run as GEMMs over the whole batch, so K3 takes every dense
layer the JAX kernel takes.

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
# the tensor-core kernel's two cp.async rings (csrc/csp.cu: Wide, Compact):
# (CTA tile rows, ring bytes); each slot holds a rows x KX chunk of x and a
# 64 x KX chunk of weights, rows padded by 8 elements
_RINGS = ((256, 3 * (256 + 64) * (32 + 8) * 2),    # KX 32, three slots
          (64, 2 * (64 + 64) * (16 + 8) * 2))      # KX 16, two slots
_MMA_BN = 64          # CTA tile channels of both rings
STAGED = 2            # the plan's ring for the staged route (no tile)
# the CUDA-core kernel's work item: 8 pixels x 4 channels
_FMA_TILE = (8, 4)
_ITEM = {torch.float32: 4, torch.bfloat16: 2}


def fold_convbn(m):
    """A ConvBnAct (``.conv.weight`` OIHW, ``.bn``) -> (W OIHW f32, b f32)
    with BN folded: silu(bn(conv(x))) == silu(conv(x; W) + b) exactly in
    real arithmetic."""
    bn = m.bn
    scale = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    return (m.conv.weight * scale[:, None, None, None],
            bn.bias - bn.running_mean * scale)


def pack_csplayer(layer, dtype) -> dict:
    """Fold a CSPLayer's weights and lay them out for the kernel of
    ``dtype``, in ``dtype``; biases f32. bf16 (tensor cores) takes them
    K-contiguous, [out, in] (the col-major B operand): ``wm``/``ws`` (ch,
    cin), ``w1`` (n, ch, ch), ``w3`` (n, 9, ch, ch) with tap dy * 3 + dx,
    ``wf`` (cout, 2 ch) with columns [main; short]. f32 (CUDA cores) takes
    each transposed, [in, out], read as 4-wide vectors of output channels."""
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
        t = t if dtype == torch.bfloat16 else t.transpose(-1, -2)
        return t.to(dtype).contiguous()

    f32 = lambda t: t.float().contiguous()             # noqa: E731
    return dict(wm=cast(wm), bm=f32(bm), ws=cast(ws), bs=f32(bs),
                w1=cast(torch.stack(w1)), b1=f32(torch.stack(b1)),
                w3=cast(torch.stack(w3)), b3=f32(torch.stack(b3)),
                wf=cast(wf), bf=f32(bf))


def smem_bytes(th, tw, n, ch, dtype, ring=0) -> int:
    """Shared memory one CTA of the kernel for ``dtype`` asks for with
    th x tw output tiles: the two haloed (th + 2n) x (tw + 2n) x ch buffers
    (a and t), in bf16 with 8 elements of row padding and cp.async ring
    ``ring`` (0 wide, 1 compact; f32 has none). ``csrc/csp.cu`` computes
    the same sum and refuses a launch over :data:`SMEM_LIMIT`."""
    region = (th + 2 * n) * (tw + 2 * n)
    if dtype == torch.bfloat16:
        return 2 * region * (ch + 8) * 2 + _RINGS[ring][1]
    return 2 * region * ch * _ITEM[dtype]


def _work(th, tw, H, W, n, cin, ch, cout, tile):
    """The kernel's work for one frame with th x tw tiles, counted in its
    own units: each stage's GEMM rounded up to whole (rows x channels)
    tiles, times K. It counts the halo's recomputation and ragged tiles."""
    bm, bn = tile

    def gemm(pix, N, K):
        return math.ceil(pix / bm) * math.ceil(N / bn) * K

    RH, RW = th + 2 * n, tw + 2 * n
    w = gemm(RH * RW, ch, cin) + gemm(th * tw, ch, cin) \
        + gemm(th * tw, cout, 2 * ch)
    for i in range(n):
        w += gemm((RH - 2 * i) * (RW - 2 * i), ch, ch) \
            + gemm((RH - 2 * i - 2) * (RW - 2 * i - 2), ch, 9 * ch)
    return math.ceil(H / th) * math.ceil(W / tw) * w


@functools.cache
def choose_tile(H, W, n, cin, ch, cout, dtype):
    """(th, tw, ring): the output tile whose plan fits in
    :data:`SMEM_LIMIT` and needs the least work (:func:`_work`), larger
    tiles first on a tie, with bf16's wide ring where any tile fits with it
    and its compact ring otherwise (ring 0 for f32). Where no tile fits
    (the region of a single output pixel, (2n + 1)^2 pixels of a and t, is
    already too large, as for dark4 of YOLOX-l and dark3 and dark4 of
    YOLOX-x in bf16), (H, W, :data:`STAGED`): the staged route, whose
    shared memory does not depend on the layer."""
    rings = range(len(_RINGS)) if dtype == torch.bfloat16 else (0,)
    for ring in rings:
        tile = ((_RINGS[ring][0], _MMA_BN) if dtype == torch.bfloat16
                else _FMA_TILE)
        best = None
        for th in range(1, H + 1):
            for tw in range(1, W + 1):
                if smem_bytes(th, tw, n, ch, dtype, ring) > SMEM_LIMIT:
                    break
                key = (_work(th, tw, H, W, n, cin, ch, cout, tile), -th * tw)
                if best is None or key < best[0]:
                    best = (key, (th, tw, ring))
        if best is not None:
            return best[1]
    return H, W, STAGED


def route(dtype, cin, ch, cout) -> str:
    """The C entry point that runs a CSPLayer in ``dtype`` on the card:
    bf16 runs on the tensor cores and needs channel counts that are
    multiples of 8, f32 runs on CUDA cores and needs multiples of 4.
    Raises for what neither takes; never picks another type's kernel or
    the plain layer."""
    if dtype == torch.bfloat16:
        if cin % 8 or ch % 8 or cout % 8:
            raise ValueError("K3's bf16 kernel needs channel counts that are "
                             f"multiples of 8; got cin={cin}, ch={ch}, "
                             f"cout={cout}")
        return "tl_csp_bf16_mma"
    if dtype == torch.float32:
        if cin % 4 or ch % 4 or cout % 4:
            raise ValueError("K3's f32 kernel needs channel counts that are "
                             f"multiples of 4; got cin={cin}, ch={ch}, "
                             f"cout={cout}")
        return "tl_csp_f32"
    raise TypeError(f"K3 takes f32 or bf16, not {dtype}")


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
