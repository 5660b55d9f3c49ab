"""K4: the ViT attention kernel (``csrc/vit_attention.cu``) and its plain
version.

Replaces the Pallas TPU kernel ``tracklab_tpu/ops/vit_attention_pallas.py``
(``_kernel`` behind ``vit_attention``): ``softmax(q k^T * Dh^-1/2) v`` per
batch element and head, scores and softmax in f32, the probabilities
rounded to the input dtype before the product with v, an optional static
count ``n_valid`` of real keys. The CUDA kernels run one CTA per (batch
element, head) and follow the JAX kernel's order of operations: bf16 on the
tensor cores (``mma.sync`` with ``ldmatrix`` and ``cp.async``), f32 on CUDA
cores; see the source note in ``csrc/vit_attention.cu``.

:func:`vit_attention` is the wrapper: for CPU tensors it runs
:func:`vit_attention_plain`, for CUDA tensors it launches the kernel that
:func:`route` names (or raises). Its ``launches`` attribute counts kernel
launches.

A second mode, the compute-dtype softmax (``softmax="compute"``), is the
JAX model's ``naive``, ``einsum`` and ``einsumT`` lowerings: logits and
softmax rounded to the input dtype at every step, masked keys at
``finfo(dtype).min``; its plain version is
:func:`vit_attention_compute_plain`. In f32 the two modes are one function,
and both run the f32 kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["vit_attention", "vit_attention_plain",
           "vit_attention_compute_plain", "route", "MAX_TOKENS",
           "MAX_HEAD_DIM", "SOFTMAX_MODES"]

MAX_TOKENS = 256      # keys and queries one CTA takes
MAX_HEAD_DIM = 128
SOFTMAX_MODES = ("f32", "compute")


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


def vit_attention_compute_plain(q, k, v, n_valid: int | None = None):
    """The compute-dtype softmax, the JAX ``naive``/``einsum``/``einsumT``
    lowerings: the logits ``q k^T`` (accumulated in f32, rounded to the
    input dtype), times Dh^-1/2, keys at or past ``n_valid`` at
    ``finfo(dtype).min``, row max, ``e = exp(s - m)``, the row sum and
    ``p = e / sum``, each a tensor of the input dtype, then ``p . v``.
    (B, N, H, Dh) -> (B, N, H, Dh)."""
    N, Dh = q.shape[1], q.shape[3]
    qt, kt, vt = (a.permute(0, 2, 1, 3) for a in (q, k, v))
    s = torch.matmul(qt, kt.transpose(-1, -2)) * Dh ** -0.5
    if n_valid is not None and n_valid < N:
        col = torch.arange(N, device=q.device)
        s = torch.where(col < n_valid, s, torch.finfo(s.dtype).min)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.matmul(p, vt).permute(0, 2, 1, 3)


def route(dtype, N: int, Dh: int, softmax: str = "f32") -> str:
    """The C entry point that takes (B, N, H, Dh) attention in ``dtype`` on
    the card with the ``softmax`` mode: bf16 runs on the tensor cores and
    needs ``Dh % 16 == 0``, f32 runs on CUDA cores (where both modes are
    the same function). Raises for what neither takes; never picks another
    type's kernel or the plain version."""
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got "
                         f"{softmax!r}")
    if N > MAX_TOKENS:
        raise ValueError(f"K4 supports N <= {MAX_TOKENS} tokens, got {N}")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"K4 supports Dh <= {MAX_HEAD_DIM}, got {Dh}")
    if dtype == torch.bfloat16:
        if Dh % 16:
            raise ValueError(f"K4's bf16 kernel needs Dh % 16 == 0, got {Dh}")
        return ("tl_vit_attention_bf16_mma_cd" if softmax == "compute"
                else "tl_vit_attention_bf16_mma")
    if dtype == torch.float32:
        return "tl_vit_attention_f32"
    raise TypeError(f"K4 takes f32 or bf16 q, k, v, got {dtype}")


@functools.cache
def _lib(symbol):
    from tracklab_torch.kernels._build import load

    fn = getattr(load("vit_attention"), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _aligned(a: torch.Tensor) -> bool:
    """The last axis is contiguous and, in bf16, every row starts on 16
    bytes, as the tensor-core kernel's 16-byte copies need."""
    if a.stride(3) != 1:
        return False
    return a.dtype != torch.bfloat16 or (
        a.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in a.stride()[:3]))


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_valid: int | None = None,
                  softmax: str = "f32") -> torch.Tensor:
    """Multi-head attention on (B, N, H, Dh) tensors; returns a contiguous
    (B, N, H, Dh) tensor in the input dtype. ``softmax``: "f32" (the Pallas
    kernel's) or "compute" (the input dtype's, see the module note).

    CPU tensors run :func:`vit_attention_plain` or
    :func:`vit_attention_compute_plain`. CUDA tensors launch the kernel
    :func:`route` names: f32 or bf16, N <= 256, Dh <= 128 and, in
    bf16, Dh % 16 == 0. Views whose rows start on 16 bytes (the q, k and v
    slices of one packed qkv tensor) are read in place."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k, v must share one (B, N, H, Dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, N, H, Dh = q.shape
    if n_valid is not None and not 1 <= n_valid:
        raise ValueError(f"n_valid must be >= 1, got {n_valid}")
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got "
                         f"{softmax!r}")
    if not q.is_cuda:
        plain = (vit_attention_compute_plain if softmax == "compute"
                 else vit_attention_plain)
        return plain(q, k, v, n_valid)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must share one device")
    fn = _lib(route(q.dtype, N, Dh, softmax))
    q, k, v = (a if _aligned(a) else a.contiguous() for a in (q, k, v))
    out = torch.empty((B, N, H, Dh), dtype=q.dtype, device=q.device)
    strides = [s for a in (q, k, v) for s in a.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 N, H, Dh, *strides, N if n_valid is None else n_valid,
                 stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {err} (B={B}, "
                           f"N={N}, H={H}, Dh={Dh}, {q.dtype})")
    vit_attention.launches += 1
    return out


vit_attention.launches = 0
