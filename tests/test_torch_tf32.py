"""The 3xTF32 arithmetic of K3's and K4's f32 kernels, emulated in torch on
the CPU (torch and numpy only).

On the card both f32 kernels run on the tensor cores: each operand x is
split with ``cvt.rna.tf32.f32`` into hi = tf32(x) and lo = tf32(x - hi)
(10 mantissa bits, to nearest, ties away from zero), and each product of a
k step (8 terms) is added to the f32 accumulator as three ``mma.sync``
m16n8k8 products, lo hi, hi lo, then hi hi. Here the products of a k step
are summed exactly (float64: a TF32 x TF32 product has 22 significant
bits) and rounded once as they are added to the f32 accumulator, which is
as fine as the tensor core's own sum or finer.

Tolerances are the card's checks: K4 f32 1e-5 abs of its plain version at
unit scale (chip_smoke phase k4); with inputs x4 even the plain f32
version sits ~1e-4 from float64, and the emulation must be no farther from
float64 than it (x1.5); K3 f32 rel 1e-4 of the plain layer. One TF32
product (1xTF32) keeps ~3 decimal digits and misses 1e-5: the reason for
three products.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tracklab_torch.kernels import csp as K3
from tracklab_torch.kernels.vit_attention import vit_attention_plain
from tracklab_torch.models.yolox import CSPLayer

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

# K4_SHAPES of chip_smoke.py with the batch and heads cut (N, Dh, n_valid)
K4_CASES = [((1, 193, 3, 64), None), ((1, 256, 2, 64), 193),
            ((2, 37, 3, 64), None), ((1, 193, 3, 64), 100)]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32``: the 13 low
    mantissa bits dropped, the magnitude rounded half away from zero."""
    bits = x.float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_tf32(a, b, products=3):
    """a @ b (f32, batched) as the kernels take it: K in steps of 8, each
    step's products (3xTF32: lo hi, hi lo, hi hi; 1xTF32: hi hi) summed
    exactly and added to an f32 accumulator in that order."""
    ah, al = split(a)
    bh, bl = split(b)
    pairs = ([(al, bh), (ah, bl), (ah, bh)] if products == 3
             else [(ah, bh)])
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            step = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            acc = (acc.double() + step).float()
    return acc


def attention_tf32(q, k, v, n_valid=None, products=3):
    """K4's f32 kernel emulated on (B, N, H, Dh): S = q k^T and E V through
    :func:`mm_tf32`, keys at or past n_valid carrying no weight, the row
    max and sum in f32, one division by the sum at the end."""
    B, N, H, Dh = q.shape
    nk = N if n_valid is None else min(N, n_valid)
    qt, kt, vt = (a.permute(0, 2, 1, 3) for a in (q, k, v))
    s = mm_tf32(qt, kt[:, :, :nk].transpose(-1, -2), products) * Dh ** -0.5
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = mm_tf32(e, vt[:, :, :nk], products) / e.sum(dim=-1, keepdim=True)
    return o.permute(0, 2, 1, 3)


def attention_f64(q, k, v):
    """softmax(q k^T * Dh^-1/2) v on (B, N, H, Dh) in float64 throughout."""
    qt, kt, vt = (a.permute(0, 2, 1, 3).double() for a in (q, k, v))
    s = qt @ kt.transpose(-1, -2) * q.shape[3] ** -0.5
    return (torch.softmax(s, dim=-1) @ vt).permute(0, 2, 1, 3)


def _qkv(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             * np.float32(scale)) for _ in range(3)]


def test_rounding_is_cvt_rna():
    """Ties round away from zero, below-half drops, above-half rounds up;
    hi + lo holds x to 2^-22 of it."""
    one = 1.0
    x = torch.tensor([one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -12,
                      one + 3 * 2 ** -12, 0.0], dtype=torch.float32)
    want = torch.tensor([one + 2 ** -10, -(one + 2 ** -10), one,
                         one + 2 ** -10, 0.0], dtype=torch.float32)
    got = tf32_rna(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32))
    hi, lo = split(r)
    assert ((hi.double() + lo.double() - r.double()).abs()
            <= r.double().abs() * 2.0 ** -22).all()


@pytest.mark.parametrize("shape,n_valid", K4_CASES)
def test_k4_3xtf32_within_plain_tolerance(shape, n_valid):
    q, k, v = _qkv(shape, seed=shape[1] + (n_valid or 0))
    got = attention_tf32(q, k, v, n_valid)
    want = vit_attention_plain(q, k, v, n_valid)
    assert (got - want).abs().max().item() <= 1e-5


def test_k4_3xtf32_at_large_logits_tracks_f32():
    """Inputs x4 (logits ~16x larger): the emulation is no farther from
    float64 than the plain f32 version (x1.5)."""
    q, k, v = _qkv((1, 193, 3, 64), seed=11, scale=4.0)
    truth = attention_f64(q, k, v)
    emu = (attention_tf32(q, k, v).double() - truth).abs().max().item()
    plain = (vit_attention_plain(q, k, v).double()
             - truth).abs().max().item()
    assert emu <= 1.5 * plain, (emu, plain)


def test_k4_one_tf32_product_misses_f32_tolerance():
    q, k, v = _qkv(K4_CASES[0][0], seed=5)
    want = vit_attention_plain(q, k, v)
    one = (attention_tf32(q, k, v, products=1) - want).abs().max().item()
    three = (attention_tf32(q, k, v) - want).abs().max().item()
    assert one > 1e-5 and three <= 1e-5, (one, three)


def _seeded_layer(cin, cout, n, seed):
    """A CSPLayer at gain-1.5 weights and positive BN statistics (the
    regime of trained checkpoints), as chip_smoke's f32 checks draw it."""
    layer = CSPLayer(cin, cout, n, True).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in layer.state_dict().values():
            if t.dim() == 4:
                t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(
                    np.float32)) * (1.5 / t[0].numel() ** 0.5))
            elif t.dtype == torch.float32:
                t.copy_(torch.from_numpy(np.abs(rng.standard_normal(
                    t.shape)).astype(np.float32)) * 0.3 + 0.5)
    return layer


def _layer_tf32(x, p, shortcut):
    """K3's f32 kernel emulated on NHWC x with pack_csplayer's [out, in]
    weights: every stage's GEMM through :func:`mm_tf32` (the 3x3's nine
    taps as K segments), bias, SiLU and the residual in f32."""
    B, H, W, cin = x.shape
    mm = lambda a, w: mm_tf32(a, w.t())      # noqa: E731
    xm = x.reshape(B * H * W, cin)
    a = F.silu(mm(xm, p["wm"]) + p["bm"])
    s = F.silu(mm(xm, p["ws"]) + p["bs"])
    ch = a.shape[-1]
    for i in range(p["w1"].shape[0]):
        t = F.silu(mm(a, p["w1"][i]) + p["b1"][i])
        tp = F.pad(t.reshape(B, H, W, ch), (0, 0, 1, 1, 1, 1))
        taps = torch.cat([tp[:, dy:dy + H, dx:dx + W].reshape(-1, ch)
                          for dy in range(3) for dx in range(3)], -1)
        w9 = p["w3"][i].permute(1, 0, 2).reshape(ch, 9 * ch)
        y = F.silu(mm(taps, w9) + p["b3"][i])
        a = y + a if shortcut else y
    out = F.silu(mm(torch.cat([a, s], -1), p["wf"]) + p["bf"])
    return out.reshape(B, H, W, -1)


def test_k3_stage_gemm_3xtf32():
    """One stage GEMM (a 3x3 bottleneck conv over its nine taps) and the
    whole layer in 3xTF32 within rel 1e-4 of the plain layer."""
    layer = _seeded_layer(32, 32, 2, seed=3)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 8, 12, 32)).astype(
        np.float32))
    p = K3.pack_csplayer(layer, torch.float32)
    with torch.no_grad():
        xt = x.permute(0, 3, 1, 2)
        conv = layer.m[0].conv2
        w3, b3 = K3.fold_convbn(conv)
        want = F.silu(F.conv2d(xt[:, :16], w3, b3, padding=1)).permute(
            0, 2, 3, 1).reshape(-1, 16)
        tp = F.pad(x[..., :16], (0, 0, 1, 1, 1, 1))
        taps = torch.cat([tp[:, dy:dy + 8, dx:dx + 12].reshape(-1, 16)
                          for dy in range(3) for dx in range(3)], -1)
        w9 = p["w3"][0].permute(1, 0, 2).reshape(16, 144)
        got = F.silu(mm_tf32(taps, w9.t()) + p["b3"][0])
        rel = lambda g, w: ((g - w).abs() / w.abs().clamp(min=1.0)).max()  # noqa
        assert rel(got, want).item() <= 1e-4
        full = _layer_tf32(x, p, True)
        plain = layer.forward_plain(xt).permute(0, 2, 3, 1)
        assert rel(full, plain).item() <= 1e-4
