"""K4: the ViT attention kernel (``csrc/vit_attention.cu``) and its plain
version.

Replaces the Pallas TPU kernel ``tracklab_tpu/ops/vit_attention_pallas.py``
(``_kernel`` behind ``vit_attention``): ``softmax(q k^T * Dh^-1/2) v`` per
batch element and head, scores and softmax in f32, the probabilities
rounded to the input dtype before the product with v, an optional static
count ``n_valid`` of real keys. The CUDA kernel runs one CTA per (batch
element, head) with one warp per query row and follows the JAX kernel's
order of operations; see the source note in ``csrc/vit_attention.cu``.

:func:`vit_attention` is the wrapper: for CPU tensors it runs
:func:`vit_attention_plain`, for CUDA tensors it launches the kernel (or
raises). Its ``launches`` attribute counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["vit_attention", "vit_attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def vit_attention_plain(q, k, v, n_valid: int | None = None):
    """``softmax(q k^T * Dh^-1/2) v`` on (B, N, H, Dh) tensors in the JAX
    kernel's order of operations: scores in f32 times Dh^-1/2, keys at or
    past ``n_valid`` get ``finfo(f32).min``, row max, ``e = exp(s - m)``,
    ``p = e / sum(e)``, p rounded to the input dtype, ``p . v`` in f32, the
    result cast to the input dtype."""
    B, N, H, Dh = q.shape
    qt, kt, vt = (a.permute(0, 2, 1, 3).float() for a in (q, k, v))
    s = torch.matmul(qt, kt.transpose(-1, -2)) * Dh ** -0.5
    if n_valid is not None and n_valid < N:
        col = torch.arange(N, device=q.device)
        s = torch.where(col < n_valid, s, torch.finfo(torch.float32).min)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    y = torch.matmul(p.to(q.dtype).float(), vt)
    return y.to(q.dtype).permute(0, 2, 1, 3)


@functools.cache
def _lib():
    from tracklab_torch.kernels._build import load

    lib = load("vit_attention")
    fn = lib.tl_vit_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.tl_vit_attention_max_tokens.restype = ctypes.c_int
    lib.tl_vit_attention_max_head_dim.restype = ctypes.c_int
    return lib


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_valid: int | None = None) -> torch.Tensor:
    """Multi-head attention on (B, N, H, Dh) tensors; returns a contiguous
    (B, N, H, Dh) tensor in the input dtype.

    CPU tensors run :func:`vit_attention_plain`. CUDA tensors launch the
    kernel, which takes f32 or bf16, N <= 256 and Dh <= 128, and views
    whose last axis is contiguous (the q, k and v slices of one packed qkv
    tensor are read in place)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k, v must share one (B, N, H, Dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, N, H, Dh = q.shape
    if n_valid is not None and not 1 <= n_valid:
        raise ValueError(f"n_valid must be >= 1, got {n_valid}")
    if not q.is_cuda:
        return vit_attention_plain(q, k, v, n_valid)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K4 takes f32 or bf16 q, k, v, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must share one device")
    lib = _lib()
    if N > lib.tl_vit_attention_max_tokens():
        raise ValueError(f"K4 supports N <= "
                         f"{lib.tl_vit_attention_max_tokens()} tokens, "
                         f"got {N}")
    if Dh > lib.tl_vit_attention_max_head_dim():
        raise ValueError(f"K4 supports Dh <= "
                         f"{lib.tl_vit_attention_max_head_dim()}, got {Dh}")
    q, k, v = (a if a.stride(3) == 1 else a.contiguous() for a in (q, k, v))
    out = torch.empty((B, N, H, Dh), dtype=q.dtype, device=q.device)
    strides = [s for a in (q, k, v) for s in a.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.tl_vit_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), B, N, H, Dh, *strides,
                                   N if n_valid is None else n_valid,
                                   _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {err} (B={B}, "
                           f"N={N}, H={H}, Dh={Dh}, {q.dtype})")
    vit_attention.launches += 1
    return out


vit_attention.launches = 0
