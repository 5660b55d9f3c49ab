"""Post-training int8 quantization of the detectors' convolutions
(counterpart of tracklab_tpu.models.quantize).

The scheme is the JAX package's, symmetric with zero-point 0 (zero padding
stays exact):

* weights: one scale per output channel, ``wscale = max(absmax / 127,
  1e-12)``, quantized on the fly from the float weights at every forward
  (``round(w / wscale)``), so checkpoints keep their float layout;
* activations: one scalar scale per convolution input, calibrated: a
  ``quant="calib"`` model records each dense convolution input's absmax
  in that module's ``absmax`` buffer (reduced with max over the forward's
  calls), :func:`calibrate_int8` max-reduces it over the calibration
  batches and returns ``ascale = max(absmax, 1e-6) / 127`` per module, and
  :func:`load_quant_state_dict` writes it into the ``ascale`` buffers (1.0
  at construction) of a ``quant="int8"`` model;
* the product: the input's codes ``clip(round(x / ascale), -127, 127)``
  times the weight codes, s8 x s8 -> s32, dequantized as ``acc * (ascale *
  wscale)`` into f32 before BatchNorm and SiLU, which stay in f32.

Grouped and depthwise convolutions, the heads' 1x1 prediction convolutions
and YOLO11's attention stage stay float in every mode, as in the JAX
package, and so does every convolution in ``train()`` mode. Both buffers
are non-persistent: a model's ``state_dict`` is the same in every mode.

The s8 x s8 -> s32 product (:func:`int8_conv_accumulators`): on a CUDA
tensor ``torch._int_mm`` over an int8 im2col (``as_strided`` windows of the
zero-padded NHWC codes; K and N zero-padded to multiples of 8, rows to more
than 16, which leaves the sums exact); on a CPU tensor its plain version
(:func:`int8_conv_accumulators_plain`), an f64 convolution of the codes,
exact because every sum stays below 2**53 (127**2 * 9 * 1024 ~ 1.5e8).
The JAX package computes this product in XLA
(``lax.conv_general_dilated(..., preferred_element_type=int32)``), outside
any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["QUANT_MODES", "quantize_input", "quantize_weight",
           "int8_conv_accumulators", "int8_conv_accumulators_plain",
           "quant_conv_int8", "record_absmax", "calibrate_int8",
           "load_quant_state_dict", "quant_modules", "quant_error_report",
           "check_mode"]

QUANT_MODES = (None, "calib", "int8")


def check_mode(quant):
    if quant not in QUANT_MODES:
        raise ValueError(f"quant={quant!r}: expected one of {QUANT_MODES}")
    return quant


def quantize_input(x, ascale):
    """Activation codes: ``clip(round(x / ascale), -127, 127)`` as int8
    (the JAX op order: a divide, then round half to even)."""
    return torch.clamp(torch.round(x.float() / ascale), -127.0,
                       127.0).to(torch.int8)


def quantize_weight(weight):
    """OIHW float weights -> (int8 codes, per-output-channel f32 scale)."""
    w = weight.float()
    wscale = torch.clamp(w.abs().amax(dim=(1, 2, 3)) / 127.0, min=1e-12)
    return torch.round(w / wscale.view(-1, 1, 1, 1)).to(torch.int8), wscale


def int8_conv_accumulators_plain(xq, wq, stride, padding):
    """The plain version: NCHW int8 codes conv OIHW int8 codes -> (B, O,
    Ho, Wo) int32, as an f64 convolution (exact: every sum < 2**53; the
    rounding before the cast only guards against a convolution algorithm
    that is not a plain sum, such as an FFT)."""
    return torch.round(F.conv2d(xq.double(), wq.double(), None, stride,
                                padding)).to(torch.int32)


def _ceil(n, m):
    return -(-n // m) * m


def _int_mm_conv(xq, wq, stride, padding):
    """``torch._int_mm`` over an int8 im2col: the rows are the output
    pixels (B, Ho, Wo), the columns the window (kh, kw, C), both zero-padded
    to ``_int_mm``'s shape rules. Returns an NCHW view of (B, Ho, Wo, O)
    int32 (channels-last memory)."""
    B, C, H, W = xq.shape
    O, _, kh, kw = wq.shape
    s, p = stride, padding
    Ho, Wo = (H + 2 * p - kh) // s + 1, (W + 2 * p - kw) // s + 1
    M, K = B * Ho * Wo, kh * kw * C
    Mp, Kp, Np = max(M, 32), _ceil(K, 8), _ceil(O, 8)
    x = xq.permute(0, 2, 3, 1).contiguous()                  # NHWC codes
    if p:
        xp = x.new_zeros((B, H + 2 * p, W + 2 * p, C))
        xp[:, p:p + H, p:p + W] = x
        x = xp
    sB, sH, sW, _ = x.stride()
    win = x.as_strided((B, Ho, Wo, kh, kw, C),
                       (sB, s * sH, s * sW, sH, sW, 1))
    if (Mp, Kp) == (M, K) and (kh, kw, s) == (1, 1, 1):
        cols = x.reshape(M, K)
    else:
        cols = x.new_empty((Mp, Kp))
        cols[:M, :K].view(B, Ho, Wo, kh, kw, C).copy_(win)
        if Kp > K:
            cols[:, K:].zero_()
        if Mp > M:
            cols[M:].zero_()
    w2 = wq.permute(0, 2, 3, 1).reshape(O, K)
    if (Np, Kp) != (O, K):
        w2 = F.pad(w2, (0, Kp - K, 0, Np - O))
    acc = torch._int_mm(cols, w2.t())
    return acc[:M, :O].reshape(B, Ho, Wo, O).permute(0, 3, 1, 2)


def int8_conv_accumulators(xq, wq, stride, padding):
    """s8 x s8 -> s32 convolution of NCHW int8 codes with OIHW int8 codes:
    (B, O, Ho, Wo) int32. On a CUDA tensor ``torch._int_mm`` over an int8
    im2col (its launches counted); on a CPU tensor the plain version."""
    if not xq.is_cuda:
        return int8_conv_accumulators_plain(xq, wq, stride, padding)
    int8_conv_accumulators.launches += 1
    return _int_mm_conv(xq, wq, stride, padding)


int8_conv_accumulators.launches = 0


def quant_conv_int8(x, weight, ascale, stride, padding):
    """s8 x s8 -> s32 convolution with on-the-fly weight quantization.

    ``x``: (B, C, H, W) activations in any float dtype; ``weight``: (O, C,
    kh, kw) float weights; ``ascale``: the scalar input scale. Returns the
    f32 dequantized output (before BatchNorm)."""
    wq, wscale = quantize_weight(weight)
    acc = int8_conv_accumulators(quantize_input(x, ascale), wq, stride,
                                 padding)
    return acc.float() * (ascale * wscale).view(1, -1, 1, 1)


def record_absmax(module, x):
    """Max-reduce the absmax of a convolution input into ``module.absmax``
    (a calib-mode module) and count the call."""
    module.absmax.copy_(torch.maximum(module.absmax,
                                      x.detach().float().abs().amax()))
    module.calib_calls += 1


def quant_modules(model, mode):
    """(name, module) of every convolution of ``model`` in quant ``mode``."""
    return [(n, m) for n, m in model.named_modules()
            if getattr(m, "quant", None) == mode
            and hasattr(m, "calib_calls" if mode == "calib" else "ascale")]


@torch.no_grad()
def calibrate_int8(model_calib, batches):
    """Run calibration batches through a ``quant="calib"`` model and return
    the ``ascale`` state, ``{"<module>.ascale": f32 scalar}``, that
    :func:`load_quant_state_dict` loads into the ``quant="int8"`` model.

    ``batches``: image tensors shaped like the model's input. absmax is
    max-reduced over every batch; ``ascale = max(absmax, 1e-6) / 127``,
    computed in f64 and rounded to f32 as the JAX package does. Raises
    ValueError when no convolution input was seen."""
    mods = quant_modules(model_calib, "calib")
    for _, m in mods:
        m.absmax.zero_()
        m.calib_calls = 0
    for batch in batches:
        model_calib(batch)
    seen = [(n, m) for n, m in mods if m.calib_calls]
    if not seen:
        raise ValueError("calibration saw no conv inputs — was the model "
                         "built with quant='calib'?")
    return {f"{n}.ascale": (torch.clamp(m.absmax.double(), min=1e-6)
                            / 127.0).float()
            for n, m in seen}


@torch.no_grad()
def load_quant_state_dict(model, scales):
    """Write ``{"<module>.ascale": scale}`` into the ``ascale`` buffers of
    a ``quant="int8"`` model and return it; raises on a missing or unused
    scale."""
    mods = dict(quant_modules(model, "int8"))
    names = {f"{n}.ascale" for n in mods}
    missing = sorted(names - set(scales))
    unused = sorted(set(scales) - names)
    if missing or unused:
        raise ValueError(f"int8 scales do not fit the model: missing "
                         f"{missing[:10]}, unused {unused[:10]}")
    for n, m in mods.items():
        m.ascale.copy_(torch.as_tensor(scales[f"{n}.ascale"],
                                       dtype=torch.float32))
    return model


@torch.no_grad()
def quant_error_report(model_f32, model_int8, batch):
    """Relative error of the int8 model's decoded predictions against the
    float model's on one batch: median and p99 of ``|a - b| / max(|a|,
    1e-3)`` and the largest ``|a - b|``."""
    a = model_f32.predict(batch).cpu().numpy()
    b = model_int8.predict(batch).cpu().numpy()
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-3)
    return {"median_rel": float(np.median(rel)),
            "p99_rel": float(np.quantile(rel, 0.99)),
            "max_abs": float(np.abs(a - b).max())}
