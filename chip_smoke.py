"""Drive tracklab_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  0. report whether pandas and yaml import, and their versions (no branch
     depends on it);
  1. build the CUDA kernels from tracklab_torch/csrc (one nvcc per source,
     all started together), and check with cuobjdump -sass that the bf16
     kernels (csp_mma_kernel, vit_attention_mma_kernel) run on the tensor
     cores: each lists HMMA instructions; and that every JV warp kernel
     (jv, jv_rect) lists REDUX (the argmin's redux.sync) and no BAR.SYNC;
  2. K1 (square JV assignment) against its plain version: identical col2row
     on random and tie-heavy costs, at S = 1, on a forced-matching square
     at S = 128, on -0.0 beside +0.0 and on rows all equal, and a batched
     launch with mixed k_eff/active; then timed at S = 64 (a
     forced-matching square and random costs), with ns per path step;
  3. K2 (batched rectangular JV assignment) against its plain version:
     identical col2row on random problems at (8, 64, 128) and at V = 5
     over (4, 9), (8, 16), (16, 16), (13, 40), on tie-heavy costs, on a
     batch with mixed active flags, at C = 33 (ragged lane runs), at
     C = 256 in shared memory (128 rows) and from device memory (256
     rows), on -0.0 beside +0.0 and on rows all equal; then timed on random
     (8, 64, 128) costs, with ns per step of the longest problem (phase 8
     times it on the path's own problems);
  4. K3 (fused CSPLayer) against the plain layer at the seven YOLOX-s 640
     shapes and at two YOLOX-tiny 416 layers whose sizes do not divide into
     whole tiles (dark3 52x52, dark5 13x13), batch 8: f32 rel <= 1e-4 (TF32
     off); bf16 rel <= 3e-2 and no farther from f32 than the plain bf16
     layer (x1.5), with the planner's tile, with bf16's compact ring and
     with the staged route (f32 too); the planner's shared memory equal to
     the kernel's; at two layers only the compact ring fits (YOLOX-l dark3,
     YOLOX-x dark5 at 640) and three no tile fits (YOLOX-l dark4, YOLOX-x
     dark3 and dark4), batch 2, bf16 no farther from f32 than the plain
     bf16 layer and f32 (the staged route) rel <= 1e-4, each timed by the
     planner's route, the staged route and plain; then the seven YOLOX-s
     layers timed at batch 128, also with the largest tile that fits
     instead of the planner's;
  5. OC-SORT on the card (through K1) against OC-SORT on the CPU on a
     200-frame, 20-object stream, id for id;
  6. multi-video trackers at 128 tracks / 64 dets: OC-SORT over V = 8
     60-frame streams in both batched modes, and ByteTrack in batched mode,
     each equal to the 8 single-video runs on the card id for id (boxes
     within 1e-4); one ByteTrack stream equal to the CPU's;
  7. the main path: YOLOX-s 640 bf16 (seeded random weights) -> NMS ->
     OC-SORT over 4 chunks of 128 quasi-static uint8 frames, with the
     kernels' launch counters read around it and 0 host syncs per frame
     required (the ORU replay runs as a kernel); 32 tracker steps profiled,
     with K1's own device time and launches on the path read from the
     profile; then an untimed pass over the first chunk that records the
     path's K1 and ORU replay inputs: the share of launches that solve,
     their path steps, the last 48 solving launches checked against the
     plain version and timed (ns per step);
  8. the multi-video path: 8 videos x 128 frames -> YOLOX-s 640 bf16 -> NMS
     (~20 detections per frame, 64 slots, min_confidence 0.4 as a mask) ->
     OC-SORT with batched=True stepping the 8 videos at once (K2), with
     the launch counters read around it, 0 host syncs per step required
     and 16 tracker steps profiled; then an untimed pass that records the
     ORU replay's inputs and trips per step and K2's last inputs, on which
     K2 is checked against its plain version and timed (ns per step of
     each launch's longest problem).

Phases 9-11 and 14 run before 7 and 8; 12, 13, 15, 17 and 16 after them:
  9. K4 (ViT attention) against its plain version at (384, 193, 12, 64),
     (8, 256, 12, 64) with n_valid 193, (5, 37, 3, 64) and (2, 193, 12, 64)
     with n_valid 100, in f32 (1e-5 abs) and bf16
     (2e-2 of the output's scale, and no farther from the f32 plain result
     than the plain bf16 version, x1.5), on q, k, v views of one packed
     qkv tensor, in both softmax modes (f32, and the compute dtype's
     against vit_attention_compute_plain); then timed in bf16 at B = 384
     in both modes beside the plain version and SDPA (a yardstick only:
     the port never calls it);
 10. the ViT-B KPR (bf16, erfpoly GELU, seeded weights) at batch 64 once
     per attn_impl name, through K4 in that name's softmax mode and
     through the same mode's plain version on the card: embeddings within
     5e-2 of their scale, flipped binary visibility bits counted;
 11. BPBReID-StrongSORT (64 tracks, 32 dets, 6 x 512 part features) on the
     card against the CPU on one 40-frame synthetic stream (IoU and OKS
     motion, and the bot_sort strategy), and V = 8
     streams over the video axis in both batched modes (K1, then K2)
     against 8 single-video runs on the card, id for id;
 12. the parts path: 8 chunks of 16 quasi-static uint8 640 frames ->
     YOLOX-s bf16 -> NMS (~20 detections per frame, 32 slots) -> device
     crops -> KPR ViT-B bf16 part features over every slot ->
     BPBReID-StrongSORT (min_confidence 0.4), with the launch counters read
     around it and 0 host syncs required in one warmed chunk; then the
     first chunk split into detector, KPR (at full width and with the
     buckets 24, 32, which read the live count on the host; K4 and the top
     kernels within it, from the profiler) and 16 profiled tracker steps,
     and K4 checked and timed on the path's own layer-0 q, k, v;
 13. the ORU replay kernel against its plain version on the main path's
     and the multi-video path's recorded replay inputs (x within rtol 1e-5
     and atol 1e-4, P within rtol 1e-4 and atol 1e-3: cuBLAS sums the
     plain version's small products in its own order), timed on the
     multi-video inputs;
 14. YOLOX-l and YOLOX-x at 640, batch 2, bf16 (seeded weights): K3 runs
     every dense layer of 80x80 or less (its launches counted, each layer
     printed with its route: wide or compact ring, or staged), each model
     held against its own plain forward and both against the f32 plain
     forward;
 15. the ReID path: 8 chunks of 16 quasi-static uint8 640 frames ->
     YOLOX-s bf16 -> NMS (~20 detections per frame, 32 slots) -> device
     crops -> OSNet x1_0 f32 at 256 x 128 over every slot -> StrongSORT
     (strong_sort.yaml: 128 tracks, nn_budget 100, 512-d, max_age 40,
     min_confidence 0.4), with the launch counters read around it and 0
     host syncs required in one warmed chunk (OSNet also timed with the
     buckets 8, 16, 32 on the first chunk); the tracker stage
     rerun with the plain JV solvers (on host copies of their inputs) on
     its first 32 recorded frames, id for id; the detector rerun with the plain CSPLayers, its detections
     matched by IoU and compared; the first chunk split into detector,
     OSNet and 16 profiled tracker steps; then the tracker stage alone
     over V = 4 videos (32 frames each) with batched=True (K2, its
     launches reported apart from the path's) against 4 single-video runs
     in that mode, id for id, K2 identical to its plain version on the
     last 8 of the stage's inputs, and the stage's first 16 frames with
     the plain rectangular solver id for id (the default mode, K1,
     compared: NaN gating costs of free slots empty its appearance stage,
     a reference fault kept for parity, so the two modes part, in the JAX
     package as here);
 16. the ORU-NKF replay kernel (Deep-OC-SORT's "new KF") against its plain
     version on seeded random (8, 128) slots with gaps 1-50 and mixed need
     and on phase 17's recorded replay inputs (x within rtol 1e-5 / atol
     1e-4, P within rtol 1e-4 / atol 1e-3, slots that do not replay
     unchanged), timed on the random slots beside its bound and the plain
     loop, with ptxas's register and spill count;
 17. the camera-motion ReID path: 8 chunks of 16 uint8 640 frames cut from
     one seeded smooth texture panning by (+2, -1) px per frame -> LK
     camera warps on the card (gmc_warps, levels 3, iters 10, batched over
     each chunk's frame pairs) -> YOLOX-s bf16 -> NMS (~20 detections per
     frame, 64 slots) -> device crops -> OSNet x1_0 f32 at 256 x 128 over
     all 1024 crops of a chunk -> Deep-OC-SORT (deep_oc_sort.yaml), then
     BoT-SORT (bot_sort.yaml), min_confidence 0.4 as a mask: 0 host syncs
     in one warmed chunk of LK and each tracker's path; the warps within
     0.25 px of the pan and 0.01 of the identity, two pairs within 1e-3 of
     the LK on the CPU; launches of K1, K2, K3 and ORU-NKF counted around
     each run; 16 tracker steps profiled; the first 32 frames of each
     tracker stage equal to the stage on the CPU and to the stage with the
     plain JV solvers (on host copies of their inputs) and the plain
     ORU-NKF, id for id; the stage over V =
     4 videos x 32 frames in both batched modes equal to its own
     single-video runs, and K2 identical to its plain version on the last
     8 of its batched inputs.

The last three lines are the card's name and power limit, a JSON line with
each kernel's check and times (K1-K4, the ORU replay and ORU-NKF), and
{"ok": true, "device": ...}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import warnings
from functools import partial

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK = {"bf16": 989e12, "f32": 67e12}


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def bound_ms(nbytes, ops, peak):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / peak * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def check_sass(torch):
    """Every bf16 kernel (``*_mma_kernel``) of csp and vit_attention lists
    HMMA (tensor-core) instructions in its SASS; every JV kernel of jv and
    jv_rect (one warp per problem) lists REDUX (the argmin's redux.sync)
    and no BAR.SYNC (no block barrier anywhere, so none in the step
    loop). Returns the counts."""
    from pathlib import Path

    from tracklab_torch.kernels import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")

    def functions(name):
        sass = subprocess.run([str(tool), "-sass", str(_build.library(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        return [(f.split(None, 1)[0], f)
                for f in sass.split("Function : ")[1:]]

    counts = {}
    for name in ("csp", "vit_attention"):
        for fname, f in functions(name):
            if "mma_kernel" in fname:
                counts[fname] = f.count("HMMA")
        check(any(name in f for f in counts),
              f"{name}: no mma kernel in the SASS")
    log(f"SASS: HMMA count per bf16 kernel {counts}")
    for fname, c in counts.items():
        check(c > 0, f"{fname}: no HMMA in its SASS")
    jv_counts = {}
    for name in ("jv", "jv_rect"):
        funcs = [(n, f) for n, f in functions(name) if "warp_kernel" in n]
        check(funcs, f"{name}: no warp kernel in the SASS")
        for fname, f in funcs:
            jv_counts[fname] = dict(REDUX=f.count("REDUX"),
                                    BAR_SYNC=f.count("BAR.SYNC"))
    log(f"SASS: REDUX and BAR.SYNC per JV kernel {jv_counts}")
    for fname, c in jv_counts.items():
        check(c["REDUX"] > 0, f"{fname}: no REDUX in its SASS")
        check(c["BAR_SYNC"] == 0, f"{fname}: {c['BAR_SYNC']} BAR.SYNC")
    return counts, jv_counts


# ---------------------------------------------------------------- phase 2: K1
def phase_k1(torch, dev):
    from tracklab_torch.kernels import jv
    from tracklab_torch.ops.assignment import _forced_prep

    g = torch.Generator(device="cpu").manual_seed(0)
    cases = [(f"random K={k}", torch.randn(k, k, generator=g))
             for k in (32, 64, 128) for _ in range(2)]
    tie = torch.zeros(64, 64)
    tie[:5, :4] = -2.0
    cases += [("tie blocks K=64", tie),
              ("integer ties K=48", torch.randint(0, 3, (48, 48),
                                                  generator=g).float())]
    # the warp kernel's edge cases: one column per lane run (S = 1), full
    # runs of 4 (S = 128, a forced-matching square with its ties), ragged
    # runs with -0.0 beside +0.0, and rows all equal (drawn from their own
    # generator, so the older cases keep their draws)
    g2 = torch.Generator(device="cpu").manual_seed(10)
    sq128, _ = _forced_prep(-torch.rand(1, 96, 128, generator=g2),
                            torch.rand(1, 96, generator=g2) < 0.8,
                            torch.rand(1, 128, generator=g2) < 0.7)
    cases += [("S=1", torch.randn(1, 1, generator=g2)),
              ("forced square S=128", sq128[0]),
              ("signed zeros K=40", _signed_zeros(torch, g2, 40, 40)),
              ("all-equal rows K=64",
               torch.randn(1, 64, generator=g2).expand(64, 64).contiguous())]
    one = lambda k: torch.tensor([k], dtype=torch.int32, device=dev)  # noqa
    on = torch.ones(1, dtype=torch.bool, device=dev)
    for name, c in cases:
        got = jv.solve_square_batched(c.to(dev)[None], one(c.shape[0]), on)[0]
        want = jv._solve_square_plain(c)
        check(torch.equal(got.cpu(), want), f"K1 {name}: col2row differs")
    log(f"K1: {len(cases)} problems identical to the plain version")

    S = 64
    c = torch.randn(6, S, S, generator=g).to(dev)
    k_eff = torch.tensor([64, 32, 17, 64, 1, 40], dtype=torch.int32,
                         device=dev)
    act = torch.tensor([1, 1, 1, 0, 1, 1], dtype=torch.bool, device=dev)
    got = jv.solve_square_batched(c, k_eff, act)
    want = jv.solve_square_batched_plain(c, k_eff.cpu(), act.cpu()).to(dev)
    check(torch.equal(got, want), "K1 batched mixed k_eff/active differs")
    log("K1: batched launch with mixed k_eff/active identical")

    # a main-path problem: 32 detection rows x 64 track columns,
    # forced-matching square (matching_forced's full branch)
    cost = -torch.rand(32, 64, generator=g)
    rm = torch.rand(32, generator=g) < 0.75
    cm = torch.rand(64, generator=g) < 0.65
    sq, _ = _forced_prep(cost[None], rm[None], cm[None])
    sq = sq[0].to(dev)
    stats = {}
    want = jv._solve_square_plain(sq, stats)
    kk = one(S)
    got = jv.solve_square_batched(sq[None], kk, on)[0]
    check(torch.equal(got, want), "K1 main-path problem differs")
    ms = cuda_ms(lambda: jv.solve_square_batched(sq[None], kk, on), 200)
    plain_ms = cuda_ms(lambda: jv._solve_square_plain(sq), 2, warmup=1)
    # each shortest-path step: ~6 f32 ops per column (2 sub, cmp, select,
    # argmin, dual update)
    ops = stats["steps"] * 6 * S
    b_ms, b_by = bound_ms(S * S * 4 + S * 4 + 5, ops, PEAK["f32"])
    rnd = torch.randn(S, S, generator=g)
    r_stats = {}
    jv._solve_square_plain(rnd, r_stats)
    rnd = rnd.to(dev)[None]
    r_ms = cuda_ms(lambda: jv.solve_square_batched(rnd, kk, on), 200)
    log(f"K1 timing at S=64: forced-matching square {ms:.4f} ms, "
        f"{stats['steps']} path steps, {ms * 1e6 / stats['steps']:.1f} ns "
        f"per step; random costs {r_ms:.4f} ms, {r_stats['steps']} path "
        f"steps, {r_ms * 1e6 / r_stats['steps']:.1f} ns per step; plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by})")
    return dict(name="K1 jv_solve_batched", route="cuda",
                source="tracklab_torch/csrc/jv.cu",
                replaces="tracklab_tpu/ops/assignment_pallas.py:146",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), dict(
                    forced_s64=dict(ms=ms, steps=stats["steps"],
                                    ns_per_step=ms * 1e6 / stats["steps"]),
                    random_s64=dict(ms=r_ms, steps=r_stats["steps"],
                                    ns_per_step=r_ms * 1e6
                                    / r_stats["steps"]))


def _plain_on_host(solver):
    """A plain JV solver run on host copies of its tensor arguments, its
    col2row moved back to the arguments' device: the same plain code on
    the same values (compares and f32 adds, so the device does not change
    the result), without the host sync that each path step of a plain
    solve costs on the card (~1 s per solving call at 128 tracks). For the
    tracker-stage reruns that swap the plain solvers in for K1 and K2."""
    def run(cost, *rest):
        out = solver(cost.cpu(), *(None if a is None else a.cpu()
                                   for a in rest))
        return out.to(cost.device)

    return run


def _signed_zeros(torch, g, R, C):
    """An (R, C) cost of -1, -0.0, +0.0 and 1 with -0.0 and +0.0 in every
    row: their ties must break to the lowest column, as f32 compares them."""
    c = torch.randint(-1, 2, (R, C), generator=g).float()
    c = torch.where((c == 0) & (torch.rand(R, C, generator=g) < 0.5), -0.0,
                    c)
    c[:, 0], c[:, 1] = -0.0, 0.0
    return c


# ---------------------------------------------------------------- phase 3: K2
def phase_k2(torch, dev):
    from tracklab_torch.kernels.jv_rect import (solve_rect_batched,
                                                solve_rect_batched_plain)

    g = torch.Generator(device="cpu").manual_seed(2)
    cases = [("random (8, 64, 128)", torch.randn(8, 64, 128, generator=g),
              None)]
    cases += [(f"random (5, {r}, {c})", torch.randn(5, r, c, generator=g),
               None) for r, c in ((4, 9), (8, 16), (16, 16), (13, 40))]
    tie = torch.zeros(2, 6, 20)
    tie[0, :4, :3] = -2.0          # absorbing block with ties
    tie[1] = 1.0                   # fully degenerate
    cases.append(("tie-heavy (2, 6, 20)", tie, None))
    cases.append(("mixed active (6, 64, 128)",
                  torch.randn(6, 64, 128, generator=g),
                  torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.bool)))
    # the warp kernel's edge cases (the plain version on the CPU): ragged
    # runs (C = 33), full runs of 8 in shared memory (128 x 256) and from
    # device memory (256 x 256, above the shared-memory cap), -0.0 beside
    # +0.0, rows all equal
    row = torch.randn(2, 1, 40, generator=g)
    cases += [("ragged C=33 (4, 20, 33)", torch.randn(4, 20, 33, generator=g),
               None),
              ("C=256 in shared memory (2, 128, 256)",
               torch.randn(2, 128, 256, generator=g), None),
              ("C=256 from device memory (2, 256, 256)",
               torch.randn(2, 256, 256, generator=g), None),
              ("signed zeros (3, 17, 33)",
               torch.stack([_signed_zeros(torch, g, 17, 33)
                            for _ in range(3)]), None),
              ("all-equal rows (2, 8, 40)",
               row.expand(2, 8, 40).contiguous(), None)]
    for name, c, act in cases:
        got = solve_rect_batched(c.to(dev), None if act is None
                                 else act.to(dev))
        want = solve_rect_batched_plain(c, act)
        check(torch.equal(got.cpu(), want), f"K2 {name}: col2row differs")
    log(f"K2: {len(cases)} batches identical to the plain version")

    c = cases[0][1].to(dev)
    V, R, C = c.shape
    per = _steps_per_problem(torch, c)
    ms = cuda_ms(lambda: solve_rect_batched(c), 200)
    plain_ms = cuda_ms(lambda: solve_rect_batched_plain(c), 1, warmup=1)
    # each shortest-path step: ~6 f32 ops per column (2 sub, cmp, select,
    # argmin, dual update)
    ops = sum(per) * 6 * C
    b_ms, b_by = bound_ms(V * R * C * 4 + V * C * 4, ops, PEAK["f32"])
    log(f"K2 timing at (8, 64, 128): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by}), {sum(per)} path "
        f"steps, {max(per)} in the longest problem: "
        f"{ms * 1e6 / max(per):.1f} ns per step")
    return dict(name="K2 jv_rect_solve_batched", route="cuda",
                source="tracklab_torch/csrc/jv_rect.cu",
                replaces="tracklab_tpu/ops/assignment_pallas.py:302",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                steps=sum(per), longest_problem_steps=max(per),
                ns_per_step=ms * 1e6 / max(per))


def _steps_per_problem(torch, cost, active=None):
    """Path steps of each active problem of a (V, R, C) K2 input, from the
    plain version on the CPU. The problems of a launch run side by side,
    one warp each, so the longest one sets the launch's chain of steps."""
    from tracklab_torch.kernels.jv_rect import _solve_rect_plain

    cost = cost.cpu()
    act = [True] * cost.shape[0] if active is None else active.tolist()
    out = []
    for b, a in enumerate(act):
        if a:
            stats = {}
            _solve_rect_plain(cost[b], stats)
            out.append(stats["steps"])
    return out


# ---------------------------------------------------------------- phase 4: K3
# (name, H=W, cin, cout, n, shortcut) of YOLOX-s at 640x640
CSP_SHAPES = [("dark3__1", 80, 128, 128, 3, True),
              ("dark4__1", 40, 256, 256, 3, True),
              ("dark5__2", 20, 512, 512, 1, False),
              ("C3_p4", 40, 512, 256, 1, False),
              ("C3_p3", 80, 256, 128, 1, False),
              ("C3_n3", 40, 256, 256, 1, False),
              ("C3_n4", 20, 512, 512, 1, False)]
# two YOLOX-tiny 416 layers: ragged tiles, ch = 48 (a K tail of 48 in a
# 64-wide chunk, a partial 64-channel block) and ch = 192
CSP_RAGGED = [("tiny416 dark3__1", 52, 96, 96, 3, True),
              ("tiny416 dark5__2", 13, 384, 384, 1, False)]
# two layers only bf16's compact ring fits (in f32 no tile fits: the staged
# route): YOLOX-l dark3 at 640 (ch 128, n 9) and YOLOX-x dark5 at 640 (ch
# 640, n 4), checked at batch 2
CSP_COMPACT = [("l640 dark3__1", 80, 256, 256, 9, True),
               ("x640 dark5__2", 20, 1280, 1280, 4, False)]
# the three layers no tile fits in either type (the staged route): YOLOX-l
# dark4 (ch 256, n 9), YOLOX-x dark3 (ch 160, n 12) and dark4 (ch 320, n 12)
# at 640, checked at batch 2
CSP_STAGED = [("l640 dark4__1", 40, 512, 512, 9, True),
              ("x640 dark3__1", 80, 320, 320, 12, True),
              ("x640 dark4__1", 40, 640, 640, 12, True)]


def _seeded_csp(torch, cin, cout, n, shortcut, dtype, dev, seed, realistic):
    """A CSPLayer with seeded weights. ``realistic``: gain-1.5 convs and
    positive random BN statistics (the regime of trained checkpoints);
    otherwise the main path's initialisation (YOLOX.randomize_: lecun-normal
    convs, identity BN)."""
    from tracklab_torch.models.yolox import CSPLayer

    layer = CSPLayer(cin, cout, n, shortcut, dtype=dtype).eval()
    g = torch.Generator().manual_seed(seed)
    gain = 1.5 if realistic else 1.0
    with torch.no_grad():
        for name, t in layer.state_dict().items():
            if t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=g)
                        * (gain / math.sqrt(t[0].numel())))
            elif realistic:
                t.copy_(torch.randn(t.shape, generator=g).abs() * 0.3 + 0.5)
            elif name.endswith(("running_var", "bn.weight")):
                t.fill_(1.0)
            else:
                t.zero_()
    return layer.to(dev)


def _plain_f64(torch, layer, x):
    """``layer``'s plain form in f64 throughout (convs, unfolded BN, SiLU,
    residuals): the truth the deep layers' f32 results are held to."""
    import torch.nn.functional as F

    from tracklab_torch.models.yolox import BN_EPS

    def cba(m, x):
        y = F.conv2d(x, m.conv.weight.double(), None, m.conv.stride,
                     m.conv.padding, groups=m.conv.groups)
        bn, sh = m.bn, (1, -1, 1, 1)
        mul = (torch.rsqrt(bn.running_var.double() + BN_EPS)
               * bn.weight.double())
        return F.silu((y - bn.running_mean.double().view(sh)) * mul.view(sh)
                      + bn.bias.double().view(sh))

    x = x.double()
    a = cba(layer.conv1, x)
    for blk in layer.m:
        y = cba(blk.conv2, cba(blk.conv1, a))
        a = y + a if blk.use_add else y
    return cba(layer.conv3, torch.cat([a, cba(layer.conv2, x)], dim=1))


def _rel(got, want):
    return ((got.float() - want.float()).abs()
            / want.float().abs().clamp(min=1.0)).max().item()


def _largest_tile(H, W, n, ch, dtype, ring):
    """The output tile with the most pixels (squarest on a tie) that fits
    with ``ring``: the simpler rule that choose_tile's cost model is timed
    against."""
    from tracklab_torch.kernels.csp import SMEM_LIMIT, smem_bytes

    best = None
    for th in range(1, H + 1):
        for tw in range(1, W + 1):
            if smem_bytes(th, tw, n, ch, dtype, ring) > SMEM_LIMIT:
                break
            key = (th * tw, -abs(th - tw))
            if best is None or key > best[0]:
                best = (key, (th, tw, ring))
    return best[1]


def phase_k3(torch, dev, time_batch):
    """f32: realistic weights, rel <= 1e-4 against the plain layer; at the
    CSP_COMPACT and CSP_STAGED layers (n = 9 and 12) f32 rounding compounds
    through the chain (BN folded in the kernel, not in the plain layer), so
    there the kernel is held to the f64 plain layer, no farther from it than
    the plain f32 layer is (x1.5). bf16:
    the main path's weights, rel <= 3e-2 against the plain bf16 layer, and
    no farther from the f32 plain layer than the plain bf16 layer is (x1.5).
    bf16 rounding compounds through the bottleneck chain, so how far two
    bf16 orders of rounding drift apart depends on the weights' gain and on
    the depth: the CSP_COMPACT and CSP_STAGED layers (n = 9 and 12, ch up
    to 640) are held to the f32 comparison only, and the compact ring (with
    the largest tile it fits) and the staged route to both checks at the
    nine other shapes, the staged route in f32 too."""
    import ctypes

    from tracklab_torch.kernels import _build
    from tracklab_torch.kernels import csp as k3_mod
    from tracklab_torch.kernels.csp import (STAGED, choose_tile,
                                            fused_csplayer, smem_bytes)

    def with_plan(plan, fn):
        """fn() with fused_csplayer held to ``plan`` (th, tw, ring)."""
        k3_mod.choose_tile = lambda *a: plan
        try:
            return fn()
        finally:
            k3_mod.choose_tile = choose_tile

    cu_smem = _build.load("csp").tl_csp_smem_bytes
    cu_smem.argtypes = [ctypes.c_int] * 6
    cu_smem.restype = ctypes.c_longlong
    worst = {"f32": 0.0, "bf16": 0.0}
    max_abs = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, bytes=0, flops=0)
    rule_ms = {"cost model": [0.0, 0.0], "largest tile": [0.0, 0.0]}
    deep_ms = {}
    n_fit = len(CSP_SHAPES + CSP_RAGGED)
    for i, (name, hw, cin, cout, n, sc) in enumerate(
            CSP_SHAPES + CSP_RAGGED + CSP_COMPACT + CSP_STAGED):
        for th, tw, ring in ((5, 7, 0), (5, 7, 1)):
            check(cu_smem(th, tw, n, cout // 2, 1, ring)
                  == smem_bytes(th, tw, n, cout // 2, torch.bfloat16, ring)
                  and cu_smem(th, tw, n, cout // 2, 0, 0)
                  == smem_bytes(th, tw, n, cout // 2, torch.float32),
                  f"K3 {name}: the kernel's shared memory differs from the "
                  "planner's")
        plans = {str(dt)[6:]: choose_tile(hw, hw, n, cin, cout // 2, cout, dt)
                 for dt in (torch.bfloat16, torch.float32)}
        staged = (hw, hw, STAGED)
        g = torch.Generator().manual_seed(100 + i)
        x = torch.randn(8 if i < n_fit else 2, cin, hw, hw, generator=g).to(
            dev).contiguous(memory_format=torch.channels_last)
        mk = partial(_seeded_csp, torch, cin, cout, n, sc, dev=dev, seed=i)
        l32 = mk(torch.float32, realistic=True)
        m32 = mk(torch.float32, realistic=False)
        m16 = mk(torch.bfloat16, realistic=False)
        with torch.no_grad():
            want32 = l32.forward_plain(x)
            got32 = fused_csplayer(l32, x)
            r32 = _rel(got32, want32)
            f32_note = f"f32 rel {r32:.3e} (tol 1e-4)"
            if i >= n_fit:
                want64 = _plain_f64(torch, l32, x)
                k64, p64 = _rel(got32, want64), _rel(want32, want64)
                f32_note = (f"f32 rel {r32:.3e}; to f64: kernel {k64:.3e}, "
                            f"plain f32 {p64:.3e} (tol x1.5)")
                del want64
            if i < n_fit:   # the staged route forced where a tile fits
                r32s = with_plan(staged, lambda: _rel(fused_csplayer(l32, x),
                                                      want32))
                f32_note += f", staged route {r32s:.3e}"
                r32 = max(r32, r32s)
            x16 = x.to(torch.bfloat16)
            got16, want16 = fused_csplayer(m16, x16), m16.forward_plain(x16)
            truth = m32.forward_plain(x)
            outs = {plans["bfloat16"]: got16}
            if i < n_fit:
                small = _largest_tile(hw, hw, n, cout // 2, torch.bfloat16, 1)
                for plan in (small, staged):
                    outs[plan] = with_plan(plan,
                                           lambda: fused_csplayer(m16, x16))
        torch.cuda.synchronize()
        check(r32 <= 1e-4 if i < n_fit else k64 <= 1.5 * p64,
              f"K3 {name} f32: {f32_note}")
        worst["f32"] = max(worst["f32"], r32)
        p_truth = _rel(want16, truth)
        for plan, got in outs.items():
            check(got.shape == want16.shape == truth.shape,
                  f"K3 {name}: shape")
            r16, k_truth = _rel(got, want16), _rel(got, truth)
            err = (got.float() - want16.float()).abs()
            log(f"K3 {name} plans {plans if got is got16 else plan}: "
                f"{f32_note}; bf16 rel {r16:.3e} "
                f"(tol {'3e-2' if i < n_fit else 'none'}), max abs "
                f"{err.max().item():.3e}, mean abs {err.mean().item():.3e}; "
                f"vs f32: kernel {k_truth:.3e}, plain bf16 {p_truth:.3e}")
            check(i >= n_fit or r16 <= 3e-2,
                  f"K3 {name} {plan} bf16: rel {r16} > 3e-2")
            check(k_truth <= 1.5 * p_truth, f"K3 {name} {plan} bf16: "
                  f"{k_truth} from f32, plain bf16 {p_truth}")
            worst["bf16"] = max(worst["bf16"], r16)
            max_abs = max(max_abs, err.max().item())
        if i >= n_fit:   # the planner's route, the staged one and plain
            with torch.no_grad():
                k_ms = cuda_ms(lambda: fused_csplayer(m16, x16), 2, warmup=1)
                s_ms = with_plan(staged, lambda: cuda_ms(
                    lambda: fused_csplayer(m16, x16), 2, warmup=1))
                p_ms = cuda_ms(lambda: m16.forward_plain(x16), 2, warmup=1)
            route = ("staged" if plans["bfloat16"][2] == STAGED
                     else "compact ring")
            deep_ms[name] = dict(plan=route, ms=k_ms, staged_ms=s_ms,
                                 plain_ms=p_ms)
            log(f"K3 {name} bf16 batch 2: planner's route ({route}) "
                f"{k_ms:.3f} ms, staged route {s_ms:.3f} ms, plain "
                f"{p_ms:.3f} ms")
        if i >= len(CSP_SHAPES):
            continue

        # time at the main path's batch
        xb = torch.randn(time_batch, cin, hw, hw, generator=g).to(
            dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            k_ms = cuda_ms(lambda: fused_csplayer(m16, xb), 3)
            p_ms = cuda_ms(lambda: m16.forward_plain(xb), 3)
        ch = cout // 2
        flops = 2 * hw * hw * ch * (2 * cin + 10 * n * ch + 2 * cout)
        tot["ms"] += k_ms
        tot["plain_ms"] += p_ms
        tot["flops"] += flops * time_batch
        tot["bytes"] += time_batch * hw * hw * (cin + cout) * 2
        log(f"K3 {name} bf16 batch {time_batch}: kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.3f} ms, "
            f"{flops * time_batch / k_ms / 1e9:.1f} TFLOP/s")
        # the planner's cost model against the largest tile that fits, timed
        # cost, largest, largest, cost
        big = _largest_tile(hw, hw, n, ch, torch.bfloat16, 0)
        order = [("cost model", plans["bfloat16"]), ("largest tile", big)]
        with torch.no_grad():
            for j, (rule, plan) in enumerate(order + order[::-1]):
                rule_ms[rule][j // 2] += with_plan(plan, lambda: cuda_ms(
                    lambda: fused_csplayer(m16, xb), 3))
        log(f"K3 {name} tiles: cost model {plans['bfloat16']}, largest "
            f"{big}")
    log(f"K3 tile rule, seven layers bf16 batch {time_batch} (two passes, "
        f"ms): {rule_ms}")
    b_ms, b_by = bound_ms(tot["bytes"], tot["flops"], PEAK["bf16"])
    log(f"K3 all seven layers, bf16 batch {time_batch}: kernel "
        f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); worst rel f32 {worst['f32']:.3e}, "
        f"bf16 {worst['bf16']:.3e}")
    return dict(name="K3 csp_fused", route="cuda",
                source="tracklab_torch/csrc/csp.cu",
                replaces="tracklab_tpu/ops/csp_pallas.py:130",
                max_abs_err=max_abs, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                yolox_l_x_layers_batch2=deep_ms)


# ----------------------------------------------------------- phase 5: tracker
def synth_stream(seed, n_frames=200, n_obj=20, drop=0.15, fp_rate=0.5,
                 img=(1920, 1080)):
    """Linear-motion objects with noisy detections, dropouts and false
    positives; per frame an (N, 7) array [ltrb, conf, cls, ref]."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([100, 100], [img[0] - 300, img[1] - 300], (n_obj, 2))
    vel = rng.uniform(-8, 8, (n_obj, 2))
    size = rng.uniform(40, 160, (n_obj, 2))
    frames, ref = [], 0
    for _ in range(n_frames):
        rows = []
        pos = pos + vel
        for k in range(n_obj):
            if rng.uniform() < drop:
                continue
            c = pos[k] + rng.normal(0, 2, 2)
            s = size[k] * rng.uniform(0.95, 1.05, 2)
            rows.append([c[0], c[1], c[0] + s[0], c[1] + s[1],
                         rng.uniform(0.2, 1.0), 1.0, ref])
            ref += 1
        for _ in range(rng.poisson(fp_rate)):
            c = rng.uniform([0, 0], [img[0] - 200, img[1] - 200])
            s = rng.uniform(30, 120, 2)
            rows.append([c[0], c[1], c[0] + s[0], c[1] + s[1],
                         rng.uniform(0.15, 0.9), 1.0, ref])
            ref += 1
        frames.append(np.array(rows, np.float64).reshape(-1, 7))
    return frames


def phase_tracker(torch, dev):
    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.trackers.common import Detections, pad_detections
    from tracklab_torch.trackers.ocsort import OCSortConfig, ocsort_scan

    cfg = OCSortConfig(max_tracks=64, max_dets=32, det_thresh=0.45,
                       max_age=12, min_hits=2, iou_threshold=0.25)
    frames = synth_stream(0)
    per = [pad_detections(f[:, :4], f[:, 4], f[:, 5], f[:, 6].astype(int),
                          capacity=32, device="cpu") for f in frames]
    dets = Detections(*(torch.stack(x) for x in zip(*per)))
    before = solve_square_batched.launches
    t0 = time.perf_counter()
    _, out_g = ocsort_scan(cfg, Detections(*(x.to(dev) for x in dets)))
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, out_c = ocsort_scan(cfg, dets)
    t_cpu = time.perf_counter() - t0
    check(solve_square_batched.launches > before, "tracker never ran K1")
    check(torch.equal(out_g.valid.cpu(), out_c.valid),
          "tracker valid differs between cuda and cpu")
    v = out_c.valid
    check(torch.equal(out_g.track_id.cpu()[v], out_c.track_id[v]),
          "tracker ids differ between cuda and cpu")
    d = (out_g.ltrb.cpu()[v] - out_c.ltrb[v]).abs().max().item()
    check(d < 1e-3, f"tracker boxes differ by {d}")
    log(f"tracker: {len(frames)} frames, {int(v.sum())} emitted boxes, ids "
        f"identical cuda vs cpu (max box diff {d:.2e}); "
        f"{solve_square_batched.launches - before} K1 launches; "
        f"{t_gpu / len(frames) * 1e3:.2f} ms/frame on cuda, "
        f"{t_cpu / len(frames) * 1e3:.2f} ms/frame on cpu")


def _pad_videos(torch, streams, capacity, dev):
    """Per-video padded detections stacked to (V, F, D) on ``dev``."""
    from tracklab_torch.trackers.common import Detections, pad_detections

    vids = []
    for frames in streams:
        per = [pad_detections(f[:, :4], f[:, 4], f[:, 5],
                              f[:, 6].astype(int), capacity=capacity,
                              device="cpu") for f in frames]
        vids.append(Detections(*(torch.stack(x) for x in zip(*per))))
    return Detections(*(torch.stack(x).to(dev) for x in zip(*vids)))


def _same_tracks(torch, got, want, what):
    """valid and track ids equal, boxes within 1e-4; returns the largest
    box difference."""
    got = type(got)(*(None if x is None else x.cpu() for x in got))
    want = type(want)(*(None if x is None else x.cpu() for x in want))
    check(torch.equal(got.valid, want.valid), f"{what}: valid differs")
    v = want.valid
    check(torch.equal(got.track_id[v], want.track_id[v]),
          f"{what}: track ids differ")
    d = (got.ltrb[v] - want.ltrb[v]).abs().max().item() if v.any() else 0.0
    check(d <= 1e-4, f"{what}: boxes differ by {d}")
    return d


# ------------------------------------------------ phase 6: batched trackers
def phase_batched_trackers(torch, dev, n_videos=8, n_frames=60):
    """OC-SORT (both modes) and ByteTrack (batched) over a video axis on the
    card against each stream run alone through the single-video tracker on
    the card; one ByteTrack stream against the CPU."""
    from dataclasses import replace

    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.kernels.jv_rect import solve_rect_batched
    from tracklab_torch.trackers.bytetrack import (ByteTrackConfig,
                                                   bytetrack_scan,
                                                   bytetrack_scan_videos)
    from tracklab_torch.trackers.common import Detections
    from tracklab_torch.trackers.ocsort import (OCSortConfig, ocsort_scan,
                                                ocsort_scan_videos)

    streams = [synth_stream(10 + v, n_frames=n_frames, n_obj=20)
               for v in range(n_videos)]
    dets = _pad_videos(torch, streams, 64, dev)
    one = [Detections(*(x[v] for x in dets)) for v in range(n_videos)]
    runs = [("OC-SORT", OCSortConfig(max_tracks=128, max_dets=64),
             ocsort_scan, ocsort_scan_videos),
            ("ByteTrack", ByteTrackConfig(max_tracks=128, max_dets=64),
             bytetrack_scan, bytetrack_scan_videos)]
    for name, cfg, scan, scan_videos in runs:
        t0 = time.perf_counter()
        singles = [scan(cfg, d)[1] for d in one]
        torch.cuda.synchronize()
        log(f"{name} single video, default mode: "
            f"{(time.perf_counter() - t0) / n_videos / n_frames * 1e3:.2f} "
            "ms per frame step")
        modes = (True, False) if name == "OC-SORT" else (True,)
        for batched in modes:
            k1, k2 = solve_square_batched.launches, solve_rect_batched.launches
            t0 = time.perf_counter()
            _, out = scan_videos(replace(cfg, batched=batched), dets)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            k1 = solve_square_batched.launches - k1
            k2 = solve_rect_batched.launches - k2
            check(k2 > 0 if batched else k1 > 0,
                  f"{name} batched={batched}: no solve launched")
            d = max(_same_tracks(torch, type(out)(*(x[v] for x in out)),
                                 singles[v],
                                 f"{name} batched={batched} video {v}")
                    for v in range(n_videos))
            n_box = int(out.valid.sum())
            log(f"{name} batched={batched} over V={n_videos}: {n_box} boxes "
                f"equal {n_videos} single-video runs id for id (max box "
                f"diff {d:.2e}); K1 {k1}, K2 {k2} launches; "
                f"{dt / n_frames * 1e3:.2f} ms per frame step")
    cpu = bytetrack_scan(runs[1][1], Detections(*(x.cpu() for x in one[0])))
    _same_tracks(torch, singles[0], cpu[1], "ByteTrack cuda vs cpu")
    log("ByteTrack video 0: cuda equals cpu id for id")


# -------------------------------------------------------- phase 7: main path
def profile_window(torch, fn, n_frames, kernel=None):
    """Run ``fn`` under torch.profiler: host ms, device-busy ms (sum of
    kernel times) and kernel launches, each per frame, and the device's
    idle share of the window; with ``kernel``, also the device ms and
    launches per frame of the kernels whose name contains it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    out = dict(host_ms_per_frame=wall_ms / n_frames,
               device_ms_per_frame=busy_us / 1e3 / n_frames,
               launches_per_frame=launches / n_frames,
               device_idle_share=1.0 - busy_us / 1e3 / wall_ms,
               top_kernels_ms_per_frame=[
                   (e.key[:72], e.self_device_time_total / 1e3 / n_frames)
                   for e in kernels[:4]])
    if kernel is not None:
        mine = [e for e in kernels if kernel in e.key]
        n = sum(e.count for e in mine)
        us = sum(e.self_device_time_total for e in mine)
        out[kernel] = dict(ms_per_frame=us / 1e3 / n_frames,
                           launches_per_frame=n / n_frames,
                           ms_per_launch=us / 1e3 / n if n else 0.0)
    return out


def phase_main(torch, dev, n_chunks=4, chunk=128, size=640, oru=None):
    from tracklab_torch.engine.fused import (fused_detect_track,
                                             make_yolox_detect_fn)
    from tracklab_torch.kernels.csp import fused_csplayer
    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.kernels.oru_replay import oru_replay
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.trackers.common import Detections
    from tracklab_torch.trackers.ocsort import (OCSortConfig, ocsort_init,
                                                ocsort_step)

    cfg = OCSortConfig(max_tracks=64, max_dets=32, min_hits=1)
    model = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                  device=dev).randomize_(0)
    F = n_chunks * chunk
    g = torch.Generator(device=dev).manual_seed(1)
    base = torch.randint(0, 235, (1, size, size, 3), generator=g,
                         device=dev, dtype=torch.uint8)
    noise = torch.randint(0, 20, (F, size, size, 3), generator=g,
                          device=dev, dtype=torch.uint8)
    video = base + noise
    del noise

    # calibrate the score threshold to ~20 detections on frame 0
    cal = make_yolox_detect_fn(model, conf_threshold=0.3, max_dets=32,
                               compute_dtype=torch.bfloat16)(video[:chunk])
    s = cal.conf[0][cal.valid[0]].sort(descending=True).values.cpu().numpy()
    conf = float(round((s[19] + s[20]) / 2, 6)) if s.size >= 21 else 0.3
    log(f"main path: calibrated conf {conf} ({s.size} NMS survivors on "
        "frame 0 at 0.3)")
    detect = make_yolox_detect_fn(model, conf_threshold=conf, max_dets=32,
                                  compute_dtype=torch.bfloat16)
    step = partial(ocsort_step, cfg)

    # warm-up on one chunk, counting host syncs
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fused_detect_track(detect, step, ocsort_init(cfg, device=dev),
                           video[:chunk], chunk, return_detections=False)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    syncs_per_frame = syncs / chunk

    solve_square_batched.launches = 0
    fused_csplayer.launches = 0
    oru_replay.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, out = fused_detect_track(detect, step, ocsort_init(cfg, device=dev),
                                   video, chunk, return_detections=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"K1": solve_square_batched.launches,
                "K3": fused_csplayer.launches, "ORU": oru_replay.launches}
    fps = F / dt
    per_frame = out.valid.sum(1).float().mean().item()
    log(f"main path: {F} frames in {dt:.3f} s = {fps:.2f} frames/s, "
        f"{per_frame:.2f} tracks/frame, launches {launches}, "
        f"{syncs_per_frame:.3f} host syncs/frame (warm-up chunk)")
    check(launches["K3"] == 7 * n_chunks,
          f"K3 launches {launches['K3']} != 7 per chunk")
    check(launches["K1"] > 0, "K1 never launched on the main path")
    check(launches["ORU"] == F, f"ORU replay launches {launches['ORU']} != "
          "one per frame")
    check(syncs == 0, f"main path: {syncs} host syncs in the warm-up chunk")
    check(out.valid.any().item(), "tracker emitted no tracks")
    check(torch.isfinite(out.ltrb[out.valid]).all().item(),
          "non-finite track boxes")
    check(out.valid.shape == (F, cfg.max_tracks), "output shape")

    # where the time goes: the detector on one chunk, then 32 tracker steps
    # on its detections under the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = detect(video[:chunk])
    torch.cuda.synchronize()
    det_ms = (time.perf_counter() - t0) * 1e3
    frames = [Detections(*(x[f] for x in dets)) for f in range(min(32, chunk))]
    init = ocsort_init(cfg, device=dev)

    def track():
        st = init
        for d in frames:
            st, _ = step(st, d)

    track()
    k1 = solve_square_batched.launches
    trk = profile_window(torch, track, len(frames), kernel="jv_warp")
    k1 = (solve_square_batched.launches - k1) / len(frames)
    mine = trk["jv_warp"]
    check(mine["launches_per_frame"] == k1,
          f"profiled K1 launches {mine['launches_per_frame']} per frame != "
          f"the wrapper's {k1}")
    log(f"main path split: detector {det_ms:.1f} ms per chunk of {chunk} "
        f"({det_ms / chunk:.3f} ms/frame); tracker {trk}; K1 on the path: "
        f"{mine['ms_per_launch']:.4f} ms per launch, "
        f"{mine['launches_per_frame']:.2f} launches and "
        f"{mine['ms_per_frame']:.4f} ms per frame")
    k1_path = _k1_on_path(torch, step, init,
                          [Detections(*(x[f] for x in dets))
                           for f in range(chunk)], oru=oru)
    return launches, dict(fps=fps, syncs_per_frame=syncs_per_frame,
                          tracks_per_frame=per_frame,
                          detector_ms_per_frame=det_ms / chunk,
                          tracker=trk, k1_path=k1_path)


def _keep_oru(store, args, n_keep=32):
    """Keep a copy of one ORU replay call's inputs in ``store`` when a slot
    replays (the last ``n_keep``), or in ``store["idle"]`` (the last 4)."""
    ins = tuple(t.clone() for t in args)
    key = "replay" if bool(ins[5].any()) else "idle"
    store.setdefault(key, []).append(ins)
    del store[key][:-(n_keep if key == "replay" else 4)]


def _k1_on_path(torch, step, init, frames, n_keep=48, oru=None):
    """A second, untimed pass of the main path's tracker over ``frames``
    that records every K1 input (cost, k_eff, active). Reports the share
    of launches that solve (a problem active with k_eff > 0; the others
    leave at once behind the fast paths) and their mean path steps, checks
    the last ``n_keep`` solving launches and ten that do not solve against
    the plain version, and times the kept solving launches. ``oru``, a
    dict, receives the pass's ORU replay inputs (:func:`_keep_oru`)."""
    import tracklab_torch.ops.assignment as A
    from tracklab_torch.kernels.jv import (_solve_square_plain,
                                           solve_square_batched)
    from tracklab_torch.ops.kalman import XYSRFilter

    inputs = []
    replay = XYSRFilter.oru_replay_batch

    def record_k1(cost, k_eff, active):
        inputs.append((cost.clone(), k_eff.clone(), active.clone()))
        return solve_square_batched(cost, k_eff, active)

    def record_oru(*args):
        if oru is not None:
            _keep_oru(oru, args)
        return replay(*args)

    A.solve_square_batched = record_k1
    XYSRFilter.oru_replay_batch = staticmethod(record_oru)
    try:
        st = init
        for d in frames:
            st, _ = step(st, d)
    finally:
        A.solve_square_batched = solve_square_batched
        XYSRFilter.oru_replay_batch = staticmethod(replay)
    torch.cuda.synchronize()
    solves = [bool((a & (k > 0)).any()) for _, k, a in inputs]
    solving = [x for x, s in zip(inputs, solves) if s]
    idle = [x for x, s in zip(inputs, solves) if not s][-10:]
    kept = solving[-n_keep:]
    steps = []
    for c, k, a in kept + idle:
        want = torch.full((c.shape[0], c.shape[1]), -1, dtype=torch.int32)
        stats = {}
        for b, (kb, ab) in enumerate(zip(k.tolist(), a.tolist())):
            if ab and kb > 0:
                want[b, :kb] = _solve_square_plain(c[b, :kb, :kb].cpu(),
                                                   stats)
        check(torch.equal(solve_square_batched(c, k, a).cpu(), want),
              "K1 differs from its plain version on a main-path input")
        steps.append(stats.get("steps", 0))
    n_steps = sum(steps[:len(kept)])

    def run_kept():
        for c, k, a in kept:
            solve_square_batched(c, k, a)

    ms = cuda_ms(run_kept, 20) / max(len(kept), 1)
    out = dict(launches=len(inputs), solving_share=len(solving)
               / max(len(inputs), 1),
               steps_per_solving_launch=n_steps / max(len(kept), 1),
               ms_per_solving_launch=ms,
               ns_per_step=ms * len(kept) * 1e6 / max(n_steps, 1),
               shape=list(inputs[-1][0].shape) if inputs else None)
    log(f"K1 on the main path's own inputs ({len(frames)} tracker steps): "
        f"{len(inputs)} launches, {len(solving)} solve "
        f"({out['solving_share']:.3f}); the last {len(kept)} solving and "
        f"{len(idle)} idle launches identical to the plain version; "
        f"{out['steps_per_solving_launch']:.1f} path steps and "
        f"{ms:.4f} ms per solving launch, {out['ns_per_step']:.1f} ns per "
        f"step")
    return out


# ---------------------------------------------------- phase 8: multi-video
def phase_videos(torch, dev, n_videos=8, n_frames=128, size=640,
                 max_dets=64, min_confidence=0.4, oru=None):
    """The multi-video path: V videos of uint8 frames -> YOLOX-s 640 bf16
    -> NMS -> per-video padded Detections (V, F, D) -> OC-SORT with
    ``batched=True`` stepping all V videos at once (one K2 launch per
    association stage)."""
    from tracklab_torch.engine.fused import make_yolox_detect_fn
    from tracklab_torch.kernels.csp import fused_csplayer
    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.kernels.jv_rect import solve_rect_batched
    from tracklab_torch.kernels.oru_replay import oru_replay
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.trackers.common import Detections, repeat_state
    from tracklab_torch.trackers.ocsort import (OCSortConfig, ocsort_init,
                                                ocsort_scan_videos,
                                                ocsort_step)

    cfg = OCSortConfig(batched=True, max_tracks=128, max_dets=max_dets)
    model = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                  device=dev).randomize_(0)
    videos = []
    for v in range(n_videos):
        g = torch.Generator(device=dev).manual_seed(100 + v)
        base = torch.randint(0, 235, (1, size, size, 3), generator=g,
                             device=dev, dtype=torch.uint8)
        videos.append(base + torch.randint(0, 20, (n_frames, size, size, 3),
                                           generator=g, device=dev,
                                           dtype=torch.uint8))

    cal = make_yolox_detect_fn(model, conf_threshold=0.3, max_dets=max_dets,
                               compute_dtype=torch.bfloat16)(videos[0])
    s = cal.conf[0][cal.valid[0]].sort(descending=True).values.cpu().numpy()
    conf = float(round((s[19] + s[20]) / 2, 6)) if s.size >= 21 else 0.3
    detect = make_yolox_detect_fn(model, conf_threshold=conf,
                                  max_dets=max_dets,
                                  compute_dtype=torch.bfloat16)
    log(f"multi-video: calibrated conf {conf} ({s.size} NMS survivors on "
        "frame 0 at 0.3)")

    def detect_all():
        per = [detect(video) for video in videos]      # one chunk each
        d = Detections(*(torch.stack(x) for x in zip(*per)))
        # the tracker wrapper's min_confidence pre-filter, as a mask
        return d._replace(valid=d.valid & (d.conf > min_confidence))

    # warm-up on 16 frames, counting host syncs per frame step
    n_prof = min(16, n_frames)
    warm = Detections(*(x[:, :n_prof] for x in detect_all()))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ocsort_scan_videos(cfg, warm)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught) / n_prof

    solve_square_batched.launches = 0
    solve_rect_batched.launches = 0
    fused_csplayer.launches = 0
    oru_replay.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = detect_all()
    torch.cuda.synchronize()
    t_det = time.perf_counter() - t0
    _, out = ocsort_scan_videos(cfg, dets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": solve_square_batched.launches,
                "K2": solve_rect_batched.launches,
                "K3": fused_csplayer.launches, "ORU": oru_replay.launches}
    F = n_frames
    fps = n_videos * F / wall
    trk_ms = (wall - t_det) / F * 1e3
    per_frame = out.valid.sum(-1).float().mean().item()
    log(f"multi-video: {n_videos} videos x {F} frames in {wall:.3f} s = "
        f"{fps:.2f} frames/s; detector {t_det * 1e3:.1f} ms; tracker "
        f"{trk_ms:.2f} ms per frame step ({n_videos} videos); launches "
        f"{launches} ({launches['K2'] / F:.2f} K2 per step); {syncs:.3f} "
        f"host syncs per step; {per_frame:.2f} tracks per frame")
    check(launches["K2"] > 0, "K2 never launched on the multi-video path")
    check(launches["ORU"] == F, f"ORU replay launches {launches['ORU']} != "
          "one per step")
    check(syncs == 0, f"multi-video path: {syncs} host syncs per step")
    check(launches["K3"] == 7 * n_videos,
          f"K3 launches {launches['K3']} != 7 per video chunk")
    check(out.valid.shape == (n_videos, F, cfg.max_tracks), "output shape")
    check(out.valid.any().item(), "tracker emitted no tracks")
    check(torch.isfinite(out.ltrb[out.valid]).all().item(),
          "non-finite track boxes")

    # device idle share of 16 tracker steps under the profiler
    frames = [Detections(*(x[:, f] for x in dets)) for f in range(n_prof)]
    init = repeat_state(ocsort_init(cfg, device=dev), n_videos)

    def track():
        st = init
        for d in frames:
            st, _ = ocsort_step(cfg, st, d)

    track()
    trk = profile_window(torch, track, len(frames))
    log(f"multi-video tracker steps (V={n_videos}): {trk}")
    k2, trips, k2_steps = _k2_on_path(torch, cfg, dets, oru=oru)
    return launches, k2, dict(fps=fps, videos=n_videos, frames_per_video=F,
                          k2_path=k2_steps,
                          detector_ms_per_video_chunk=t_det * 1e3
                          / n_videos,
                          tracker_ms_per_step=trk_ms,
                          k2_launches_per_step=launches["K2"] / F,
                          syncs_per_step=syncs,
                          tracks_per_frame=per_frame, tracker=trk,
                          oru_replay_trips_per_step=dict(
                              mean=sum(trips) / len(trips), max=max(trips)))


def _k2_on_path(torch, cfg, dets, n_keep=8, oru=None):
    """A second, untimed pass of the multi-video tracker that records the
    ORU replay's trip count per step (its largest gap) and inputs (into the
    dict ``oru``, :func:`_keep_oru`) and keeps the last ``n_keep`` K2
    inputs; K2 is then checked against its plain version and timed on
    those inputs, the problems the path gives it."""
    import tracklab_torch.ops.assignment as A
    from tracklab_torch.kernels.jv_rect import (solve_rect_batched,
                                                solve_rect_batched_plain)
    from tracklab_torch.ops.kalman import XYSRFilter
    from tracklab_torch.trackers.ocsort import ocsort_scan_videos

    replay = XYSRFilter.oru_replay_batch
    trips, inputs = [], []

    def record_replay(x, P, z_prev, z_new, gap, need):
        trips.append(int(torch.where(need, gap, 0).max()))
        if oru is not None:
            _keep_oru(oru, (x, P, z_prev, z_new, gap, need))
        return replay(x, P, z_prev, z_new, gap, need)

    def record_k2(cost, active=None):
        inputs.append((cost, active))
        del inputs[:-n_keep]
        return solve_rect_batched(cost, active)

    XYSRFilter.oru_replay_batch = staticmethod(record_replay)
    A.solve_rect_batched = record_k2
    try:
        ocsort_scan_videos(cfg, dets)
    finally:
        XYSRFilter.oru_replay_batch = staticmethod(replay)
        A.solve_rect_batched = solve_rect_batched
    torch.cuda.synchronize()
    for c, a in inputs:
        check(torch.equal(solve_rect_batched(c, a),
                          solve_rect_batched_plain(c, a)),
              "K2 differs from its plain version on a path input")

    def run_all():
        for c, a in inputs:
            solve_rect_batched(c, a)

    ms = cuda_ms(run_all, 20) / len(inputs)
    t_plain = 0.0
    for c, a in inputs[-2:]:          # the last step's two stages
        t_plain += cuda_ms(lambda: solve_rect_batched_plain(c, a), 1,
                           warmup=0)
    per = [_steps_per_problem(torch, c, a) for c, a in inputs]
    steps = sum(map(sum, per)) / len(inputs)
    longest = sum(max(s, default=0) for s in per) / len(inputs)
    V, R, C = inputs[-1][0].shape
    b_ms, b_by = bound_ms(V * R * C * 4 + V * C * 4, steps * 6 * C,
                          PEAK["f32"])
    log(f"K2 on the multi-video path's own problems ({len(inputs)} launches "
        f"of {(V, R, C)}, identical to the plain version): kernel {ms:.4f} ms"
        f" per launch, plain {t_plain / 2:.3f} ms, bound {b_ms:.6f} ms "
        f"({b_by}), {steps:.1f} path steps per launch, {longest:.1f} in its "
        f"longest problem: {ms * 1e6 / longest:.1f} ns per step; ORU replay "
        f"trips per step: mean {sum(trips) / len(trips):.2f}, max "
        f"{max(trips)}")
    return dict(name="K2 jv_rect_solve_batched", route="cuda",
                source="tracklab_torch/csrc/jv_rect.cu",
                replaces="tracklab_tpu/ops/assignment_pallas.py:302",
                max_abs_err=0.0, ms=ms, plain_ms=t_plain / 2, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), trips, dict(
                    steps_per_launch=steps,
                    longest_problem_steps_per_launch=longest,
                    ns_per_step=ms * 1e6 / longest)


# ---------------------------------------------------------------- phase 9: K4
K4_SHAPES = [((384, 193, 12, 64), None), ((8, 256, 12, 64), 193),
             ((5, 37, 3, 64), None), ((2, 193, 12, 64), 100)]


def _packed_qkv(torch, shape, dtype, dev, seed):
    """q, k, v as the (B, N, H, Dh) views of one packed (B, N, 3, H, Dh)
    tensor, as the ViT's qkv projection gives them."""
    B, N, H, Dh = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn((B, N, 3, H, Dh), generator=g).to(dev, dtype)
    return qkv.unbind(2)


def _check_k4(torch, q, k, v, n_valid, what, softmax="f32"):
    """K4 in the ``softmax`` mode against that mode's plain version on the
    same inputs: f32 within 1e-5 abs; bf16 within 2e-2 of the output's
    scale and no farther from the f32 plain result than the plain bf16
    version is (x1.5). Returns the largest absolute difference from the
    plain version."""
    from tracklab_torch.kernels.vit_attention import (
        vit_attention, vit_attention_compute_plain, vit_attention_plain)

    plain = (vit_attention_compute_plain if softmax == "compute"
             else vit_attention_plain)
    got = vit_attention(q, k, v, n_valid, softmax=softmax)
    want = plain(q, k, v, n_valid)
    what = f"{what} softmax={softmax}"
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"K4 {what}: shape or dtype")
    err = (got.float() - want.float()).abs().max().item()
    if q.dtype == torch.float32:
        log(f"K4 {what} f32: max abs err {err:.3e} (tol 1e-5)")
        check(err <= 1e-5, f"K4 {what} f32: max abs err {err} > 1e-5")
        return err
    scale = want.float().abs().max().item()
    truth = vit_attention_plain(q.float(), k.float(), v.float(), n_valid)
    k_truth = (got.float() - truth).abs().max().item()
    p_truth = (want.float() - truth).abs().max().item()
    log(f"K4 {what} bf16: max abs err {err:.3e} = {err / scale:.3e} of "
        f"the output's scale (tol 2e-2); vs f32: kernel {k_truth:.3e}, "
        f"plain bf16 {p_truth:.3e}")
    check(err <= 2e-2 * scale, f"K4 {what} bf16: err {err} > 2e-2 * {scale}")
    check(k_truth <= 1.5 * p_truth,
          f"K4 {what} bf16: {k_truth} from f32, plain bf16 {p_truth}")
    return err


def _k4_bound(torch, q):
    B, N, H, Dh = q.shape
    return bound_ms(4 * B * N * H * Dh * q.element_size(),
                    4 * B * H * N * N * Dh, PEAK["bf16"])


def phase_k4(torch, dev):
    from tracklab_torch.kernels.vit_attention import (vit_attention,
                                                      vit_attention_plain)

    from tracklab_torch.kernels.vit_attention import (
        vit_attention_compute_plain)

    max_abs = 0.0
    for i, (shape, n_valid) in enumerate(K4_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _packed_qkv(torch, shape, dtype, dev, seed=40 + i)
            for softmax in ("f32", "compute"):
                err = _check_k4(torch, q, k, v, n_valid,
                                f"{shape} n_valid={n_valid}", softmax)
                if dtype == torch.bfloat16:
                    max_abs = max(max_abs, err)
    q, k, v = _packed_qkv(torch, K4_SHAPES[0][0], torch.bfloat16, dev, 40)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    with torch.no_grad():
        ms = cuda_ms(lambda: vit_attention(q, k, v), 20)
        cd_ms = cuda_ms(lambda: vit_attention(q, k, v, softmax="compute"),
                        20)
        plain_ms = cuda_ms(lambda: vit_attention_plain(q, k, v), 5)
        cd_plain_ms = cuda_ms(lambda: vit_attention_compute_plain(q, k, v),
                              5)
        lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt), 20)
    b_ms, b_by = _k4_bound(torch, q)
    log(f"K4 timing at {tuple(q.shape)} bf16: kernel {ms:.4f} ms (f32 "
        f"softmax), {cd_ms:.4f} ms (compute-dtype softmax); plain "
        f"{plain_ms:.4f} / {cd_plain_ms:.4f} ms, SDPA (yardstick) "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="K4 vit_attention", route="cuda",
                source="tracklab_torch/csrc/vit_attention.cu",
                replaces="tracklab_tpu/ops/vit_attention_pallas.py:91",
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                compute_softmax=dict(ms=cd_ms, plain_ms=cd_plain_ms))


# ------------------------------------------------------ phase 10: KPR model
def _plain_attention():
    """K4's plain version by softmax mode, with the wrapper's signature."""
    from tracklab_torch.kernels.vit_attention import (
        vit_attention_compute_plain, vit_attention_plain)

    def attention(q, k, v, n_valid=None, softmax="f32"):
        plain = (vit_attention_compute_plain if softmax == "compute"
                 else vit_attention_plain)
        return plain(q, k, v, n_valid)

    return attention


def phase_kpr(torch, dev, batch=64):
    """The ViT-B KPR (bf16, erfpoly GELU, seeded weights) at batch 64 on the
    card once per attn_impl name, through K4 in the name's softmax mode and
    through that mode's plain version (the CPU form, on the card):
    embeddings within 5e-2 of their scale (bf16 rounding compounds over 12
    layers), and the flipped binary visibility bits counted."""
    import tracklab_torch.models.kpr as kpr_mod
    from tracklab_torch.kernels.vit_attention import vit_attention
    from tracklab_torch.models.kpr import (ATTN_IMPLS, KPR,
                                           extract_test_embeddings)

    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn((batch, 384, 128, 3), generator=g).to(dev, torch.bfloat16)
    prompts = torch.zeros((batch, 384, 128, 7), dtype=torch.bfloat16,
                          device=dev)
    stats = {}
    for impl in ATTN_IMPLS:
        model = KPR(dtype=torch.bfloat16, gelu="erfpoly", attn_impl=impl,
                    device=dev).randomize_(3)
        before = vit_attention.launches
        out_k = model(x, prompts)
        check(vit_attention.launches - before == 12,
              f"KPR {impl} did not launch K4 once per layer")
        kpr_mod.vit_attention = _plain_attention()
        try:
            out_p = model(x, prompts)
        finally:
            kpr_mod.vit_attention = vit_attention
        torch.cuda.synchronize()
        (ek, vk), (ep, vp) = (extract_test_embeddings(o)
                              for o in (out_k, out_p))
        check(ek.shape == (batch, 6, 512) and torch.isfinite(ek.float())
              .all().item(), f"KPR {impl} embeddings: shape or non-finite")
        scale = ep.float().abs().max().item()
        err = (ek.float() - ep.float()).abs().max().item()
        flips = int((vk != vp).sum())
        mode = model.backbone.blocks[0].attn.softmax
        log(f"KPR ViT-B bf16 attn_impl={impl} ({mode} softmax) at batch "
            f"{batch}: embeddings K4 vs plain max abs {err:.3e} = "
            f"{err / scale:.3e} of scale (tol 5e-2); {flips} of "
            f"{vk.numel()} binary visibility bits flipped; visible share "
            f"{vk.float().mean().item():.3f}")
        check(err <= 5e-2 * scale, f"KPR {impl} embeddings differ by {err} "
              f"(scale {scale})")
        stats[impl] = dict(softmax=mode, max_abs=err, scale=scale,
                           flipped_visibility=flips,
                           visibility_bits=vk.numel())
        del model, out_k, out_p
    return stats


# ------------------------------------------------- phase 11: BPBReID tracker
def synth_parts_stream(seed, n_frames=40, n_obj=20, D=32, P=6, E=512,
                       K=17, img=(1920, 1080)):
    """Objects in linear motion with part features (a base per object plus
    noise), visibilities, keypoints and 15 % dropouts, as
    tests/test_bpbreid_oks.py builds them, in (F, D) padded numpy arrays."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n_obj, P, E))
    pos = rng.uniform([100, 100], [img[0] - 300, img[1] - 300], (n_obj, 2))
    vel = rng.uniform(-4, 4, (n_obj, 2))
    size = rng.uniform(40, 160, (n_obj, 2))
    ltrb = np.zeros((n_frames, D, 4), np.float32)
    conf = np.zeros((n_frames, D), np.float32)
    valid = np.zeros((n_frames, D), bool)
    feat = np.zeros((n_frames, D, P, E), np.float32)
    vis = np.zeros((n_frames, D, P), np.float32)
    kps = np.zeros((n_frames, D, K, 3), np.float32)
    for f in range(n_frames):
        pos = pos + vel
        slot = 0
        for k in range(n_obj):
            if rng.uniform() < 0.15 or slot == D:
                continue
            c = pos[k] + rng.normal(0, 2, 2)
            ltrb[f, slot] = [c[0], c[1], c[0] + size[k, 0],
                             c[1] + size[k, 1]]
            conf[f, slot] = rng.uniform(0.5, 1.0)
            valid[f, slot] = True
            feat[f, slot] = base[k] + rng.normal(0, 0.05, (P, E))
            vis[f, slot] = rng.uniform(size=P) < 0.8
            kps[f, slot, :, 0] = c[0] + np.linspace(5, size[k, 0] - 5, K)
            kps[f, slot, :, 1] = c[1] + np.linspace(10, size[k, 1] - 10, K)
            kps[f, slot, :, 2] = 1.0
            slot += 1
    return ltrb, conf, valid, feat, vis, kps


def _parts_inputs(torch, arrays, dev):
    from tracklab_torch.trackers.common import Detections

    ltrb, conf, valid, feat, vis, kps = (torch.from_numpy(a).to(dev)
                                         for a in arrays)
    lead = conf.shape
    D = lead[-1]
    dets = Detections(ltrb, conf, torch.ones_like(conf),
                      torch.arange(D, dtype=torch.int32,
                                   device=dev).expand(lead).contiguous(),
                      valid)
    return dets, feat, vis, kps


def phase_bpbreid(torch, dev, n_videos=8, n_frames=40):
    """BPBReID-StrongSORT (64 tracks, 32 dets, 6 parts x 512) on the card
    against the CPU for one stream, id for id, with IoU and OKS motion and
    the bot_sort strategy; then V = 8 streams over the video axis in both
    modes against 8 single-video runs on the card."""
    from dataclasses import replace

    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.kernels.jv_rect import solve_rect_batched
    from tracklab_torch.trackers.bpbreid_strongsort import (
        BPBReIDStrongSortConfig, bpbreid_scan, bpbreid_scan_videos)
    from tracklab_torch.trackers.common import Detections

    cfg = BPBReIDStrongSortConfig(n_parts=6, embed_dim=512, n_init=1,
                                  max_tracks=64, max_dets=32)
    streams = [synth_parts_stream(60 + v, n_frames) for v in range(n_videos)]
    one = [_parts_inputs(torch, s, dev) for s in streams]
    k1 = solve_square_batched.launches
    t0 = time.perf_counter()
    singles = [bpbreid_scan(cfg, *x)[1] for x in one]
    torch.cuda.synchronize()
    t_single = (time.perf_counter() - t0) / n_videos / n_frames
    k1 = solve_square_batched.launches - k1
    check(k1 > 0, "BPBReID never launched K1")
    log(f"BPBReID single video: {t_single * 1e3:.2f} ms per frame step on "
        f"cuda; {k1} K1 launches over {n_videos} x {n_frames} steps")
    cpu_in = _parts_inputs(torch, streams[0], "cpu")
    for kw in ({}, {"motion_criterium": "oks"},
               {"matching_strategy": "bot_sort"}):
        c = replace(cfg, **kw)
        got = singles[0] if not kw else bpbreid_scan(c, *one[0])[1]
        cpu = bpbreid_scan(c, *cpu_in)[1]
        d = _same_tracks(torch, got, cpu, f"BPBReID {kw} cuda vs cpu")
        log(f"BPBReID {kw or 'iou, strong_sort'} video 0: cuda equals cpu "
            f"id for id ({int(cpu.valid.sum())} boxes, max box diff "
            f"{d:.2e})")
    dets = Detections(*(torch.stack(x) for x in zip(*(o[0] for o in one))))
    feats = [torch.stack(x) for x in list(zip(*one))[1:]]
    for batched in (False, True):
        k2 = solve_rect_batched.launches
        t0 = time.perf_counter()
        _, out = bpbreid_scan_videos(replace(cfg, batched=batched), dets,
                                     *feats)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n_frames
        k2 = solve_rect_batched.launches - k2
        check(not batched or k2 > 0, "batched mode never ran K2")
        d = max(_same_tracks(torch, type(out)(*(None if x is None else x[v]
                                                for x in out)),
                             singles[v], f"BPBReID batched={batched} "
                             f"video {v}") for v in range(n_videos))
        log(f"BPBReID batched={batched} over V={n_videos}: "
            f"{int(out.valid.sum())} boxes equal {n_videos} single-video "
            f"runs id for id (max box diff {d:.2e}); {k2} K2 launches; "
            f"{dt * 1e3:.2f} ms per frame step")


def _embed_both_ways(torch, detect, embed, video, chunk, buckets, timed):
    """The live count of every chunk's detections and the bucket it would
    take; then the embed stage timed at full width and bucketed on the
    chunk with the fewest live slots (where the buckets save the most)."""
    from tracklab_torch.engine.fused import _bucketed_embed

    dets = [detect(video[b:b + chunk])
            for b in range(0, video.shape[0], chunk)]
    lives = [int(d.valid.sum(1).max()) for d in dets]
    i = min(range(len(lives)), key=lives.__getitem__)
    frames, d = video[i * chunk:(i + 1) * chunk], dets[i]
    embed(frames, d.ltrb)
    _, full_ms = timed(lambda: embed(frames, d.ltrb))
    _, bucket_ms = timed(lambda: _bucketed_embed(embed, frames, d.ltrb,
                                                 d.valid, buckets))
    return dict(live_per_chunk=lives,
                bucket_per_chunk=[next(b for b in buckets if b >= n)
                                  for n in lives],
                fewest_live_chunk=i, full_ms=full_ms, bucketed_ms=bucket_ms)


# -------------------------------------------------- phase 12: the parts path
def phase_parts(torch, dev, n_chunks=8, chunk=16, size=640):
    """uint8 frames -> YOLOX-s 640 bf16 -> NMS (~20 detections per frame,
    32 slots) -> device crops -> KPR ViT-B bf16 part features over every
    slot (full width: no host sync) -> BPBReID-StrongSORT (min_confidence
    0.4), as bench.py's detect_parts_track; KPR also timed with the buckets
    (24, 32), which read the live count on the host."""
    import tracklab_torch.models.kpr as kpr_mod
    from tracklab_torch.engine.fused import (_bucketed_embed,
                                             fused_detect_parts_track,
                                             make_kpr_embed_fn,
                                             make_yolox_detect_fn)
    from tracklab_torch.kernels.csp import fused_csplayer
    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.kernels.jv_rect import solve_rect_batched
    from tracklab_torch.kernels.vit_attention import vit_attention
    from tracklab_torch.models.kpr import KPR
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.trackers.bpbreid_strongsort import (
        BPBReIDStrongSortConfig, bpbreid_init, bpbreid_step)

    cfg = BPBReIDStrongSortConfig(motion_criterium="iou", n_parts=6,
                                  embed_dim=512, n_init=1, max_tracks=64,
                                  max_dets=32)
    det_model = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                      device=dev).randomize_(0)
    kpr = KPR(dtype=torch.bfloat16, gelu="erfpoly", device=dev).randomize_(3)
    F = n_chunks * chunk
    g = torch.Generator(device=dev).manual_seed(1)
    base = torch.randint(0, 235, (1, size, size, 3), generator=g,
                         device=dev, dtype=torch.uint8)
    video = base + torch.randint(0, 20, (F, size, size, 3), generator=g,
                                 device=dev, dtype=torch.uint8)

    cal = make_yolox_detect_fn(det_model, conf_threshold=0.3, max_dets=32,
                               compute_dtype=torch.bfloat16)(video[:chunk])
    s = cal.conf[0][cal.valid[0]].sort(descending=True).values.cpu().numpy()
    conf = float(round((s[19] + s[20]) / 2, 6)) if s.size >= 21 else 0.3
    log(f"parts path: calibrated conf {conf} ({s.size} NMS survivors on "
        "frame 0 at 0.3)")
    detect = make_yolox_detect_fn(det_model, conf_threshold=conf,
                                  max_dets=32, compute_dtype=torch.bfloat16)
    embed = make_kpr_embed_fn(kpr, crop_size=(384, 128), n_prompt_ch=7,
                              compute_dtype=torch.bfloat16)
    step = partial(bpbreid_step, cfg)
    run = partial(fused_detect_parts_track, detect, embed, chunk=chunk,
                  min_confidence=0.4, n_parts=6, embed_dim=512,
                  n_keypoints=17, return_detections=False)

    # warm-up on the first chunk, which records its tracker inputs, then
    # the second chunk with its host syncs counted
    inputs = []

    def rec_step(st, x):
        inputs.append(x)
        return step(st, x)

    run(step_fn=rec_step, init_state=bpbreid_init(cfg, device=dev),
        frames=video[:chunk])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(step_fn=step, init_state=bpbreid_init(cfg, device=dev),
            frames=video[chunk:2 * chunk])
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs_per_frame = sum("synchroniz" in str(w.message)
                          for w in caught) / chunk

    for fn in (solve_square_batched, solve_rect_batched, fused_csplayer,
               vit_attention):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, _, _, out = run(step_fn=step,
                          init_state=bpbreid_init(cfg, device=dev),
                          frames=video)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": solve_square_batched.launches,
                "K2": solve_rect_batched.launches,
                "K3": fused_csplayer.launches, "K4": vit_attention.launches}
    fps = F / wall
    per_frame = out.valid.sum(1).float().mean().item()
    log(f"parts path: {F} frames in {wall:.3f} s = {fps:.2f} frames/s, "
        f"{per_frame:.2f} tracks/frame, launches {launches}, "
        f"{syncs_per_frame:.3f} host syncs/frame (second chunk)")
    check(syncs_per_frame == 0,
          f"parts path: {syncs_per_frame} host syncs per frame")
    check(launches["K4"] == 12 * n_chunks,
          f"K4 launches {launches['K4']} != 12 per chunk")
    check(launches["K3"] == 7 * n_chunks,
          f"K3 launches {launches['K3']} != 7 per chunk")
    check(launches["K1"] > 0, "K1 never launched on the parts path")
    check(out.valid.shape == (F, cfg.max_tracks), "output shape")
    check(out.valid.any().item(), "tracker emitted no tracks")
    check(torch.isfinite(out.ltrb[out.valid]).all().item(),
          "non-finite track boxes")

    # where the time goes, on the first chunk: detector, KPR (K4 inside it
    # from the profiler), then the 16 recorded tracker steps
    frames = video[:chunk]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    dets, det_ms = timed(lambda: detect(frames))
    kpr_call = partial(embed, frames, dets.ltrb)
    _, kpr_ms = timed(kpr_call)
    _, kpr_bucket_ms = timed(partial(_bucketed_embed, embed, frames,
                                     dets.ltrb, dets.valid, (24, 32)))
    k4_ms, kpr_top = _kernel_ms_in(torch, kpr_call, "vit_attention")
    both = _embed_both_ways(torch, detect, embed, video, chunk, (24, 32),
                            timed)
    log(f"parts path KPR per chunk, full width against the buckets (24, "
        f"32): {both}")
    init = bpbreid_init(cfg, device=dev)

    def track():
        st = init
        for x in inputs:
            st, _ = step(st, x)

    track()
    _, trk_ms = timed(track)
    trk = profile_window(torch, track, len(inputs))
    log(f"parts path split (chunk of {chunk}): detector {det_ms:.1f} ms, "
        f"KPR {kpr_ms:.1f} ms at full width (K4 {k4_ms:.2f} ms of it; "
        f"{kpr_bucket_ms:.1f} ms with the buckets (24, 32), "
        f"{int(dets.valid.sum(1).max())} live slots), tracker "
        f"{trk_ms / len(inputs):.2f} ms per frame; KPR's top kernels "
        f"(ms per chunk) {kpr_top}; tracker under the profiler {trk}")

    # K4 on the path's own inputs: layer 0 of the first chunk
    path_qkv = []

    def record(q, k, v, n_valid=None, softmax="f32"):
        if not path_qkv:
            path_qkv.append((q.clone(), k.clone(), v.clone(), n_valid,
                             softmax))
        return vit_attention(q, k, v, n_valid, softmax=softmax)

    kpr_mod.vit_attention = record
    try:
        kpr_call()
    finally:
        kpr_mod.vit_attention = vit_attention
    q, k, v, n_valid, softmax = path_qkv[0]
    err = _check_k4(torch, q, k, v, n_valid, f"path layer 0 {tuple(q.shape)}",
                    softmax)
    with torch.no_grad():
        k4_path_ms = cuda_ms(lambda: vit_attention(q, k, v, n_valid,
                                                   softmax=softmax), 10)
    b_ms, b_by = _k4_bound(torch, q)
    log(f"K4 on the path's layer-0 inputs {tuple(q.shape)} ({softmax} "
        f"softmax): kernel {k4_path_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    return launches, dict(
        fps=fps, frames=F, chunk=chunk, syncs_per_frame=syncs_per_frame,
        tracks_per_frame=per_frame, detector_ms_per_chunk=det_ms,
        kpr_ms_per_chunk=kpr_ms, kpr_bucketed_ms_per_chunk=kpr_bucket_ms,
        live_slots_first_chunk=int(dets.valid.sum(1).max()),
        kpr_both_ways=both,
        k4_ms_per_chunk=k4_ms,
        kpr_top_kernels_ms_per_chunk=kpr_top,
        tracker_ms_per_frame=trk_ms / len(inputs), tracker=trk,
        k4_path=dict(shape=list(q.shape), softmax=softmax, ms=k4_path_ms,
                     bound_ms=b_ms, max_abs_err=err))


# ----------------------------------------------- phase 13: the ORU replay
def phase_oru(torch, recorded):
    """The ORU replay kernel against oru_replay_plain on each path's
    recorded replay inputs ({path: {"replay": [...], "idle": [...]}}): x
    within rtol 1e-5 and atol 1e-4, P within rtol 1e-4 and atol 1e-3 (the
    plain version's batched products sum in cuBLAS's order), the frozen
    state returned unchanged where no slot replays. Timed on the
    multi-video path's inputs that replay."""
    from tracklab_torch.kernels.oru_replay import oru_replay, oru_replay_plain

    max_abs, n_checked = 0.0, 0
    for path, store in recorded.items():
        for kind in ("replay", "idle"):
            for ins in store.get(kind, []):
                gx, gP = oru_replay(*ins)
                wx, wP = oru_replay_plain(*ins)
                torch.cuda.synchronize()
                torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-4)
                torch.testing.assert_close(gP, wP, rtol=1e-4, atol=1e-3)
                if kind == "idle":
                    check(torch.equal(gx, ins[0]) and torch.equal(gP, ins[1]),
                          f"ORU {path}: an idle launch changed the state")
                max_abs = max(max_abs, (gx - wx).abs().max().item())
                n_checked += 1
        log(f"ORU replay {path}: {len(store.get('replay', []))} launches "
            f"with a replay and {len(store.get('idle', []))} idle ones "
            "within tolerance of the plain version")
    timed = recorded["multi_video_path"].get("replay") or \
        recorded["main_path"].get("replay")
    check(timed, "no ORU replay input with a replay was recorded")
    ins = timed[-1]

    def run_all():
        for a in timed:
            oru_replay(*a)

    ms = cuda_ms(run_all, 20) / len(timed)
    plain_ms = cuda_ms(lambda: oru_replay_plain(*ins), 3, warmup=1)
    n = ins[5].numel()
    # each slot reads x, P, z_prev, z_new (64 f32), gap (i32) and need (u8)
    # and writes x and P (56 f32); the replay's ~1000 f32 operations per
    # step of each replaying slot's gap
    steps = int(torch.where(ins[5], ins[4], 0).sum())
    b_ms, b_by = bound_ms(n * (64 * 4 + 5 + 56 * 4), steps * 1000,
                          PEAK["f32"])
    trips = int(torch.where(ins[5], ins[4], 0).max())
    log(f"ORU replay: {n_checked} launches checked (max abs err x "
        f"{max_abs:.3e}); timed on {len(timed)} multi-video launches of "
        f"{tuple(ins[5].shape)} slots: kernel {ms:.4f} ms per launch, plain "
        f"{plain_ms:.4f} ms ({trips} trips, the largest gap), bound "
        f"{b_ms:.6f} ms ({b_by})")
    return dict(name="ORU oru_replay (port-only)", route="cuda",
                source="tracklab_torch/csrc/oru_replay.cu",
                replaces="tracklab_tpu/ops/kalman.py:242 (XYSRFilter."
                "oru_replay_batch, a lax.while_loop: no Pallas kernel)",
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# ------------------------------------------------ phase 14: YOLOX-l and -x
def _plain_csp():
    """A context in which every CSPLayer runs its unfused modules."""
    from contextlib import contextmanager

    from tracklab_torch.models.yolox import CSPLayer

    @contextmanager
    def ctx():
        fwd = CSPLayer.forward
        CSPLayer.forward = CSPLayer.forward_plain
        try:
            yield
        finally:
            CSPLayer.forward = fwd

    return ctx()


def phase_yolox_lx(torch, dev, batch=2, size=640):
    """YOLOX-l and YOLOX-x at 640 in bf16 with seeded weights: K3 takes
    every dense layer of at most CSP_MAX_PIXELS pixels (the JAX kernel's
    rule), by the planner's route; each model against its own plain forward
    (all layers unfused) and both against the f32 plain forward: the mean
    |diff| over the mean |f32| of the kernel's outputs no more than 1.5x
    the plain bf16 forward's."""
    from tracklab_torch.kernels.csp import choose_tile, fused_csplayer
    from tracklab_torch.models.yolox import CSP_MAX_PIXELS, YOLOX, CSPLayer

    def route(mod, H, W):
        if mod.depthwise or H * W > CSP_MAX_PIXELS:
            return None
        ring = choose_tile(H, W, len(mod.m), mod.conv1.conv.weight.shape[1],
                           mod.conv1.conv.weight.shape[0],
                           mod.conv3.conv.weight.shape[0], mod.dtype)[2]
        return ("wide ring", "compact ring", "staged")[ring]

    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(0, 256, (batch, size, size, 3), generator=g,
                      device=dev).float()
    flat = lambda outs: torch.cat([o.float().reshape(batch, -1)   # noqa
                                   for o in outs], dim=1)
    rel = lambda a, b: ((a - b).abs().mean() / b.abs().mean()).item()  # noqa
    stats = {}
    for variant in ("l", "x"):
        m16 = YOLOX(num_classes=1, variant=variant, dtype=torch.bfloat16,
                    device=dev).randomize_(0)
        routes = []
        hooks = [mod.register_forward_pre_hook(
            lambda mod, inp, name=name: routes.append(
                (name, tuple(inp[0].shape[2:]),
                 route(mod, *inp[0].shape[2:]))))
            for name, mod in m16.named_modules() if isinstance(mod, CSPLayer)]
        before = fused_csplayer.launches
        with torch.no_grad():
            got = flat(m16(x))
        torch.cuda.synchronize()
        launched = fused_csplayer.launches - before
        for h in hooks:
            h.remove()
        with torch.no_grad(), _plain_csp():
            want = flat(m16(x))
            m32 = YOLOX(num_classes=1, variant=variant, dtype=torch.float32,
                        device=dev).randomize_(0)
            truth = flat(m32(x))
        torch.cuda.synchronize()
        del m16, m32
        took = [f"{n} {hw[0]}x{hw[1]} {k}" for n, hw, k in routes if k]
        plain = [f"{n} {hw[0]}x{hw[1]}" for n, hw, k in routes if not k]
        n_staged = sum(k == "staged" for _, _, k in routes)
        check(launched == len(took), f"YOLOX-{variant}: {launched} K3 "
              f"launches for {len(took)} dense layers of <= 80x80")
        check(n_staged == {"l": 1, "x": 2}[variant],
              f"YOLOX-{variant}: {n_staged} layers by the staged route")
        check(bool(torch.isfinite(got).all()), f"YOLOX-{variant}: non-finite")
        k_pl, k_tr, p_tr = rel(got, want), rel(got, truth), rel(want, truth)
        log(f"YOLOX-{variant} 640 bf16 batch {batch}: K3 took {took}; the "
            f"unfused modules ran {plain} (over K3's 80x80 rule); outputs "
            f"vs its plain forward {k_pl:.3e} (mean |diff| / mean |plain|), vs f32: kernel "
            f"{k_tr:.3e}, plain bf16 {p_tr:.3e}")
        check(k_tr <= 1.5 * p_tr, f"YOLOX-{variant}: {k_tr} from f32, plain "
              f"bf16 {p_tr}")
        stats[variant] = dict(k3_layers=took, plain_layers=plain,
                              vs_plain=k_pl, vs_f32=k_tr,
                              plain_bf16_vs_f32=p_tr)
    return stats


# ---------------------------------------------------- phase 15: ReID path
def phase_reid(torch, dev, n_chunks=8, chunk=16, size=640, n_videos=4):
    """uint8 frames -> YOLOX-s 640 bf16 -> NMS (~20 detections per frame,
    32 slots) -> device crops -> OSNet x1_0 f32 at 256 x 128 over every
    slot (full width: no host sync) -> StrongSORT with strong_sort.yaml's
    values, the reference's BASELINE config-2 pipeline
    (fused_detect_reid_track); OSNet also timed with the buckets (8, 16,
    32), which read the live count on the host."""
    from dataclasses import replace

    import tracklab_torch.ops.assignment as A
    from tracklab_torch.engine.fused import (_bucketed_embed,
                                             fused_detect_reid_track,
                                             make_osnet_embed_fn,
                                             make_yolox_detect_fn)
    from tracklab_torch.kernels.csp import fused_csplayer
    from tracklab_torch.kernels.jv import (solve_square_batched,
                                           solve_square_batched_plain)
    from tracklab_torch.kernels.jv_rect import (solve_rect_batched,
                                                solve_rect_batched_plain)
    from tracklab_torch.kernels.oru_replay import oru_replay
    from tracklab_torch.models.osnet import OSNet
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.ops import boxes as B
    from tracklab_torch.trackers.common import Detections, stack_frames
    from tracklab_torch.trackers.strongsort import (StrongSortConfig,
                                                    strongsort_init,
                                                    strongsort_scan,
                                                    strongsort_scan_videos,
                                                    strongsort_step)

    # configs/modules/track/strong_sort.yaml, 32 detection slots
    cfg = StrongSortConfig(max_dist=0.1594374041012136,
                           max_iou_dist=0.5431835667667874, max_age=40,
                           n_init=3, nn_budget=100, mc_lambda=0.995,
                           ema_alpha=0.8962157769329083, embed_dim=512,
                           max_tracks=128, max_dets=32)
    det_model = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                      device=dev).randomize_(0)
    osnet = OSNet("x1_0", feat_dim=512, n_parts=6, dtype=torch.float32,
                  device=dev).randomize_(1)
    F = n_chunks * chunk
    g = torch.Generator(device=dev).manual_seed(1)
    base = torch.randint(0, 235, (1, size, size, 3), generator=g,
                         device=dev, dtype=torch.uint8)
    video = base + torch.randint(0, 20, (F, size, size, 3), generator=g,
                                 device=dev, dtype=torch.uint8)
    cal = make_yolox_detect_fn(det_model, conf_threshold=0.3, max_dets=32,
                               compute_dtype=torch.bfloat16)(video[:chunk])
    s = cal.conf[0][cal.valid[0]].sort(descending=True).values.cpu().numpy()
    conf = float(round((s[19] + s[20]) / 2, 6)) if s.size >= 21 else 0.3
    log(f"ReID path: calibrated conf {conf} ({s.size} NMS survivors on "
        "frame 0 at 0.3)")
    detect = make_yolox_detect_fn(det_model, conf_threshold=conf,
                                  max_dets=32, compute_dtype=torch.bfloat16)
    embed = make_osnet_embed_fn(osnet, crop_size=(256, 128),
                                compute_dtype=torch.float32)
    step = partial(strongsort_step, cfg)
    run = partial(fused_detect_reid_track, detect, embed, chunk=chunk,
                  min_confidence=0.4, embed_dim=512)

    # warm-up on the first chunk, then the second with its syncs counted
    run(step_fn=step, init_state=strongsort_init(cfg, device=dev),
        frames=video[:chunk], return_detections=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(step_fn=step, init_state=strongsort_init(cfg, device=dev),
            frames=video[chunk:2 * chunk], return_detections=False)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs_per_frame = sum("synchroniz" in str(w.message)
                          for w in caught) / chunk

    inputs = []

    def rec_step(st, x):
        inputs.append(x)
        return step(st, x)

    for fn in (solve_square_batched, solve_rect_batched, fused_csplayer,
               oru_replay):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, dets, reid, out = run(step_fn=rec_step,
                             init_state=strongsort_init(cfg, device=dev),
                             frames=video, return_embeddings=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": solve_square_batched.launches,
                "K2": solve_rect_batched.launches,
                "K3": fused_csplayer.launches, "ORU": oru_replay.launches}
    fps = F / wall
    per_frame = out.valid.sum(1).float().mean().item()
    log(f"ReID path: {F} frames in {wall:.3f} s = {fps:.2f} frames/s, "
        f"{per_frame:.2f} tracks/frame, launches {launches}, "
        f"{syncs_per_frame:.4f} host syncs/frame (second chunk)")
    check(launches["K3"] == 7 * n_chunks,
          f"K3 launches {launches['K3']} != 7 per chunk")
    check(launches["K1"] > 0, "K1 never launched on the ReID path")
    check(syncs_per_frame == 0,
          f"ReID path: {syncs_per_frame} host syncs per frame")
    check(out.valid.shape == (F, cfg.max_tracks), "output shape")
    check(out.valid.any().item(), "tracker emitted no tracks")
    check(torch.isfinite(out.ltrb[out.valid]).all().item(),
          "non-finite track boxes")
    check(reid["embeddings"].shape == (F, 32, 512) and
          bool(torch.isfinite(reid["embeddings"]).all()),
          "ReID embeddings: shape or non-finite")

    # the tracker stage again with the plain JV solvers, id for id, over the
    # first n_plain frames
    n_plain = 2 * chunk
    solves = {"K1": 0}
    plain_sq = _plain_on_host(solve_square_batched_plain)

    def plain_k1(cost, k_eff, active):
        solves["K1"] += 1
        return plain_sq(cost, k_eff, active)

    A.solve_square_batched, A.solve_rect_batched = (
        plain_k1, _plain_on_host(solve_rect_batched_plain))
    try:
        t0 = time.perf_counter()
        st, outs = strongsort_init(cfg, device=dev), []
        for x in inputs[:n_plain]:
            st, o = step(st, x)
            outs.append(o)
        plain_out = stack_frames(outs)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        A.solve_square_batched = solve_square_batched
        A.solve_rect_batched = solve_rect_batched
    head = type(out)(*(x[:n_plain] for x in out))
    d = _same_tracks(torch, head, plain_out, "ReID path vs plain JV solvers")
    log(f"ReID path tracker stage with the plain JV solvers over its first "
        f"{n_plain} frames ({solves['K1']} calls, {t_plain:.1f} s): "
        f"{int(head.valid.sum())} boxes equal id for id (max box diff "
        f"{d:.2e})")

    # the detector again with the plain CSPLayers: bf16 rounding moves
    # scores across the threshold and reorders slots, so each frame's
    # detections are matched by IoU and compared, not required equal
    with torch.no_grad(), _plain_csp():
        pd = [detect(video[b:b + chunk]) for b in range(0, F, chunk)]
    pd = Detections(*(torch.cat(f) for f in zip(*pd)))
    iou = B.iou_matrix(dets.ltrb, pd.ltrb)                 # (F, D, D)
    iou = torch.where(dets.valid[:, :, None] & pd.valid[:, None, :], iou,
                      torch.zeros_like(iou))
    best = iou.amax(dim=2)[dets.valid]
    det_cmp = dict(
        detections=int(dets.valid.sum()), plain_detections=int(
            pd.valid.sum()),
        frames_with_other_counts=int((dets.valid.sum(1)
                                      != pd.valid.sum(1)).sum()),
        unmatched_at_iou_0_9=int((best < 0.9).sum()),
        median_best_iou=best.median().item())
    log(f"ReID path detector with the plain CSPLayers: {det_cmp}")

    # where the time goes, on the first chunk
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    frames = video[:chunk]
    d0, det_ms = timed(lambda: detect(frames))
    _, osnet_ms = timed(lambda: embed(frames, d0.ltrb))
    _, osnet_bucket_ms = timed(lambda: _bucketed_embed(
        embed, frames, d0.ltrb, d0.valid, (8, 16, 32)))
    both = _embed_both_ways(torch, detect, embed, video, chunk, (8, 16, 32),
                            timed)
    log(f"ReID path OSNet per chunk, full width against the buckets (8, "
        f"16, 32): {both}")
    first = inputs[:chunk]
    init = strongsort_init(cfg, device=dev)

    def track():
        st = init
        for x in first:
            st, _ = step(st, x)

    track()
    _, trk_ms = timed(track)
    trk = profile_window(torch, track, len(first))
    log(f"ReID path split (chunk of {chunk}): detector {det_ms:.1f} ms, "
        f"OSNet {osnet_ms:.1f} ms at full width, {osnet_bucket_ms:.1f} ms "
        f"with the buckets (8, 16, 32) ({int(d0.valid.sum(1).max())} live "
        "slots), "
        f"tracker {trk_ms / len(first):.2f} ms per frame; tracker under the "
        f"profiler {trk}")

    # the tracker stage alone over V videos at once with batched=True (K2)
    # against each video run alone in the same mode. The default mode is
    # compared, not required equal: free slots (zero covariance) and padded
    # detections give NaN gating costs, and the default mode's one-hot
    # column permutation spreads a NaN over its whole row, which then goes
    # unmatched (the reference fault kept for parity, ROADMAP.md §3); the
    # rectangular batched mode does not, so the modes part, in the JAX
    # package as here
    Fv = F // n_videos
    vdets = Detections(*(torch.stack(f).reshape((n_videos, Fv)
                                                + f[0].shape)
                         for f in zip(*(x[0] for x in inputs))))
    vemb = torch.stack([x[1] for x in inputs]).reshape(
        (n_videos, Fv) + inputs[0][1].shape)
    vwarp = torch.stack([x[2] for x in inputs]).reshape(n_videos, Fv, 2, 3)
    bcfg = replace(cfg, batched=True)
    one = [(Detections(*(f[v] for f in vdets)), vemb[v], vwarp[v])
           for v in range(n_videos)]
    singles = [strongsort_scan(bcfg, *x)[1] for x in one]
    default = [strongsort_scan(cfg, *x)[1] for x in one]
    solve_rect_batched.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, vout = strongsort_scan_videos(bcfg, vdets, vemb, vwarp)
    torch.cuda.synchronize()
    v_ms = (time.perf_counter() - t0) / Fv * 1e3
    k2 = solve_rect_batched.launches
    check(k2 > 0, "batched StrongSORT never launched K2")
    dv = max(_same_tracks(torch, type(vout)(*(x[v] for x in vout)),
                          singles[v], f"StrongSORT batched video {v}")
             for v in range(n_videos))
    other = sum(int((a.valid != b.valid).sum()
                    + (a.track_id != b.track_id)[a.valid & b.valid].sum())
                for a, b in zip(singles, default))
    log(f"StrongSORT batched=True over V={n_videos} x {Fv} frames of the "
        f"path's own inputs: {int(vout.valid.sum())} boxes equal the "
        f"batched single-video runs id for id (max box diff {dv:.2e}); {k2} "
        f"K2 launches; {v_ms:.2f} ms per step for {n_videos} videos; the "
        f"default mode (K1) differs in {other} slot-frames")

    # K2 against its plain version on this stage's problems: the stage again
    # with K2's inputs recorded, the last n_keep checked; and the stage over
    # its first Fp frames with the plain solver in K2's place, id for id
    n_keep, Fp = 8, Fv // 2
    rect_in = []

    def record_k2(cost, active=None):
        rect_in.append((cost, active))
        del rect_in[:-n_keep]
        return solve_rect_batched(cost, active)

    A.solve_rect_batched = record_k2
    try:
        _, vrec = strongsort_scan_videos(bcfg, vdets, vemb, vwarp)
    finally:
        A.solve_rect_batched = solve_rect_batched
    torch.cuda.synchronize()
    _same_tracks(torch, vrec, vout, "batched StrongSORT rerun")
    for c, a in rect_in:
        check(torch.equal(solve_rect_batched(c, a),
                          solve_rect_batched_plain(c, a)),
              "K2 differs from its plain version on a batched StrongSORT "
              "input")
    A.solve_rect_batched = _plain_on_host(solve_rect_batched_plain)
    try:
        t0 = time.perf_counter()
        _, vplain = strongsort_scan_videos(
            bcfg, Detections(*(f[:, :Fp] for f in vdets)), vemb[:, :Fp],
            vwarp[:, :Fp])
        torch.cuda.synchronize()
        t_vplain = time.perf_counter() - t0
    finally:
        A.solve_rect_batched = solve_rect_batched
    _same_tracks(torch, type(vout)(*(x[:, :Fp] for x in vout)), vplain,
                 "batched StrongSORT vs the plain rectangular solver")
    log(f"batched StrongSORT: K2 identical to its plain version on the last "
        f"{len(rect_in)} of its inputs {tuple(rect_in[-1][0].shape)}; the "
        f"stage over the first {Fp} frames with the plain solver "
        f"({t_vplain:.1f} s) equal id for id")
    return launches, {"K2": k2}, dict(
        fps=fps, frames=F, chunk=chunk, syncs_per_frame=syncs_per_frame,
        tracks_per_frame=per_frame, detector_ms_per_chunk=det_ms,
        osnet_ms_per_chunk=osnet_ms,
        osnet_bucketed_ms_per_chunk=osnet_bucket_ms,
        live_slots_first_chunk=int(d0.valid.sum(1).max()),
        osnet_both_ways=both,
        tracker_ms_per_frame=trk_ms / len(first), tracker=trk,
        plain_detector=det_cmp, plain_jv_frames=n_plain,
        plain_jv_calls=solves["K1"],
        batched_videos=dict(videos=n_videos, frames=Fv,
                            ms_per_step=v_ms, k2_launches=k2,
                            default_mode_slot_frames_differing=other))


# ------------------------------------- phase 16: the ORU-NKF replay kernel
def _ptxas_usage(name, kernel):
    """Registers and spills of ``kernel`` in ``csrc/<name>.cu``, as
    ``nvcc -Xptxas -v`` reports them for the build's flags."""
    import tempfile
    from pathlib import Path

    from tracklab_torch.kernels import _build

    flags = [f for f in _build._FLAGS if f not in ("-shared",)]
    with tempfile.TemporaryDirectory(dir=_build._BUILD.parent) as tmp:
        res = subprocess.run(
            [_build.nvcc_path(), *flags, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / "o.o"), str(_build._CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=True)
    for part in res.stderr.split("Compiling entry function")[1:]:
        if kernel in part.split("\n", 1)[0]:
            lines = [ln.split(":", 1)[-1].strip()
                     for ln in part.splitlines()
                     if "registers" in ln or "spill" in ln]
            return "; ".join(lines)
    raise AssertionError(f"{kernel}: not in ptxas's report")


def _nkf_slots(torch, dev, shape, seed=0, max_gap=50):
    """Random ORU-NKF inputs over ``shape`` slots on ``dev``: states after
    birth and three filter steps, gaps 1..max_gap (some 0), need mixed."""
    from tracklab_torch.trackers.deepocsort import (_nkf_initiate,
                                                    _nkf_predict,
                                                    _nkf_update)

    g = torch.Generator(device="cpu").manual_seed(seed)

    def rand(*s):
        return torch.rand(shape + s, generator=g)

    z0 = torch.cat([rand(2) * 800 + 100, rand(2) * 180 + 20], dim=-1)
    x, P = _nkf_initiate(z0)
    no = torch.zeros(shape, dtype=torch.bool)
    for _ in range(3):
        x, P = _nkf_predict(x, P, no)
        x, P = _nkf_update(x, P, z0 + (rand(4) - 0.5) * 6)
    zp = z0 + (rand(4) - 0.5) * 10
    zn = z0 + (rand(4) - 0.5) * 60
    gap = torch.randint(1, max_gap + 1, shape, generator=g,
                        dtype=torch.int32)
    gap[..., :2] = torch.tensor([0, max_gap], dtype=torch.int32)
    need = rand() < 0.7
    return tuple(t.to(dev) for t in (x, P, zp, zn, gap, need))


def phase_oru_nkf(torch, dev, recorded):
    """The ORU-NKF kernel against oru_replay_nkf_plain on the card: seeded
    random (8, 128) slots with gaps 1..50 and mixed need, then the camera
    path's recorded Deep-OC-SORT replay inputs (``recorded``: {"replay":
    [...], "idle": [...]}); x within rtol 1e-5 / atol 1e-4, P within rtol
    1e-4 / atol 1e-3, the frozen state unchanged where a slot does not
    replay. Timed on the random (8, 128) slots, with its bound and the plain
    loop's time; ptxas's registers and spills for the kernel."""
    from tracklab_torch.kernels.oru_replay import (oru_replay_nkf,
                                                   oru_replay_nkf_plain)

    usage = _ptxas_usage("oru_replay", "oru_replay_nkf_kernel")
    log(f"ORU-NKF kernel, ptxas: {usage}")
    rand_in = _nkf_slots(torch, dev, (8, 128))
    cases = [("random (8, 128)", rand_in, False)]
    cases += [("path replay", ins, False) for ins in recorded.get("replay",
                                                                 [])]
    cases += [("path idle", ins, True) for ins in recorded.get("idle", [])]
    check(recorded.get("replay"), "no ORU-NKF path input with a replay")
    max_abs = 0.0
    for what, ins, idle in cases:
        gx, gP = oru_replay_nkf(*ins)
        wx, wP = oru_replay_nkf_plain(*ins)
        torch.cuda.synchronize()
        torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(gP, wP, rtol=1e-4, atol=1e-3)
        keep = ~(ins[5] & (ins[4] > 0))
        check(torch.equal(gx[keep], ins[0][keep])
              and torch.equal(gP[keep], ins[1][keep]),
              f"ORU-NKF {what}: a slot that does not replay changed")
        if idle:
            check(not bool(keep.logical_not().any()), "idle input replays")
        max_abs = max(max_abs, (gx - wx).abs().max().item())
    n_path = len(cases) - 1
    ms = cuda_ms(lambda: oru_replay_nkf(*rand_in), 50)
    plain_ms = cuda_ms(lambda: oru_replay_nkf_plain(*rand_in), 3, warmup=1)
    x, P, zp, zn, gap, need = rand_in
    n = need.numel()
    steps = int(torch.where(need, gap, 0).sum())
    trips = int(torch.where(need, gap, 0).max())
    # each slot reads x, P, z_prev, z_new (80 f32), gap (i32) and need (u8)
    # and writes x and P (72 f32); each step of a replaying slot's gap is
    # ~1100 multiply-adds (the update's K, A and P products) and ~100 other
    # operations: ~2300 f32 operations
    b_ms, b_by = bound_ms(n * (80 * 4 + 5 + 72 * 4), steps * 2300,
                          PEAK["f32"])
    log(f"ORU-NKF: the random (8, 128) slots and {n_path} path launches "
        f"within tolerance of the plain version (max abs err x "
        f"{max_abs:.3e}); kernel {ms:.4f} ms per launch on (8, 128) slots "
        f"({steps} replay steps, {trips} trips), plain {plain_ms:.3f} ms, "
        f"bound {b_ms:.6f} ms ({b_by})")
    return dict(name="ORU-NKF oru_replay_nkf (port-only)", route="cuda",
                source="tracklab_torch/csrc/oru_replay.cu",
                replaces="tracklab_tpu/trackers/deepocsort.py:117 "
                "(_nkf_oru_replay_batch, a lax.while_loop: no Pallas kernel)",
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), dict(
                    ptxas=usage, path_launches_checked=n_path,
                    random_steps=steps, random_trips=trips)


# ------------------------------------ phase 17: the camera-motion ReID path
# configs/modules/track/deep_oc_sort.yaml and bot_sort.yaml (min_confidence
# 0.4 is the fused path's mask)
DEEPOCSORT_YAML = dict(det_thresh=0.0, max_age=50, min_hits=1,
                       iou_threshold=0.22136877277096445, delta_t=1,
                       asso_func="giou", inertia=0.3941737016672115,
                       w_association_emb=0.75, alpha_fixed_emb=0.95,
                       aw_param=0.5, embedding_off=False, aw_off=False,
                       embed_dim=512, max_tracks=128, max_dets=64)
BOTSORT_YAML = dict(track_high_thresh=0.33824964456239337,
                    new_track_thresh=0.21144301345190655, track_buffer=60,
                    match_thresh=0.22734550911325851,
                    proximity_thresh=0.5945380911899254,
                    appearance_thresh=0.4818211117541298,
                    lambda_=0.9896143462366406, frame_rate=30, embed_dim=512,
                    max_tracks=128, max_dets=64)


def panning_video(torch, dev, n_frames, size, drift=(2, -1), seed=5):
    """``n_frames`` uint8 (size, size, 3) frames cut from one seeded smooth
    texture (uniform noise, Gaussian blur of sigma 3 px, stretched to
    0..255) whose content moves by ``drift`` (x, y) whole pixels per frame,
    so the camera warp from each frame to the next translates by
    ``drift``."""
    import torch.nn.functional as nnF

    dx, dy = drift
    H = size + abs(dy) * (n_frames - 1) + 32
    W = size + abs(dx) * (n_frames - 1) + 32
    g = torch.Generator(device=dev).manual_seed(seed)
    tex = torch.rand((3, 1, H, W), generator=g, device=dev)
    r = torch.arange(-12, 13, dtype=torch.float32, device=dev)
    k = torch.exp(-0.5 * (r / 3.0) ** 2)
    k = k / k.sum()
    tex = nnF.conv2d(tex, k.view(1, 1, 1, -1), padding=(0, 12))
    tex = nnF.conv2d(tex, k.view(1, 1, -1, 1), padding=(12, 0))[:, 0]
    tex = (tex - tex.amin()) / (tex.amax() - tex.amin()) * 255.0
    tex = tex.round().to(torch.uint8).permute(1, 2, 0)
    ox = 16 + max(dx, 0) * (n_frames - 1)
    oy = 16 + max(dy, 0) * (n_frames - 1)
    return torch.stack([tex[oy - dy * t:oy - dy * t + size,
                            ox - dx * t:ox - dx * t + size]
                        for t in range(n_frames)])


def _run_stage(step, init, inputs):
    """A tracker stage over recorded per-frame inputs; stacked outputs."""
    from tracklab_torch.trackers.common import stack_frames

    st, outs = init, []
    for x in inputs:
        st, o = step(st, x)
        outs.append(o)
    return stack_frames(outs)


def _inputs_to(inputs, dev):
    from tracklab_torch.trackers.common import Detections

    return [(Detections(*(t.to(dev) for t in d)), e.to(dev), w.to(dev))
            for d, e, w in inputs]


def phase_motion(torch, dev, n_chunks=8, chunk=16, size=640, n_videos=4,
                 drift=(2, -1), oru=None):
    """uint8 frames panning by ``drift`` px per frame -> on-card LK camera
    warps (gmc_warps, levels 3, iters 10, batched over each chunk's frame
    pairs) -> YOLOX-s 640 bf16 -> NMS (~20 detections per frame, 64 slots)
    -> device crops -> OSNet x1_0 f32 at 256 x 128 over every slot ->
    Deep-OC-SORT (deep_oc_sort.yaml) and, in a second run, BoT-SORT
    (bot_sort.yaml), min_confidence 0.4 as a mask, through
    fused_detect_reid_track. ``oru``, a dict, receives Deep-OC-SORT's
    ORU-NKF replay inputs (:func:`_keep_oru`)."""
    from dataclasses import replace

    import tracklab_torch.ops.assignment as A
    import tracklab_torch.trackers.deepocsort as DO
    from tracklab_torch.engine.fused import (fused_detect_reid_track,
                                             make_osnet_embed_fn,
                                             make_yolox_detect_fn)
    from tracklab_torch.kernels.csp import fused_csplayer
    from tracklab_torch.kernels.jv import (solve_square_batched,
                                           solve_square_batched_plain)
    from tracklab_torch.kernels.jv_rect import (solve_rect_batched,
                                                solve_rect_batched_plain)
    from tracklab_torch.kernels.oru_replay import (oru_replay_nkf,
                                                   oru_replay_nkf_plain)
    from tracklab_torch.models.osnet import OSNet
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.motion.lk import estimate_affine_lk, gmc_warps
    from tracklab_torch.trackers import botsort as BS
    from tracklab_torch.trackers.common import Detections

    F = n_chunks * chunk
    video = panning_video(torch, dev, F, size, drift)
    det_model = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                      device=dev).randomize_(0)
    osnet = OSNet("x1_0", feat_dim=512, n_parts=6, dtype=torch.float32,
                  device=dev).randomize_(1)
    cal = make_yolox_detect_fn(det_model, conf_threshold=0.3, max_dets=64,
                               compute_dtype=torch.bfloat16)(video[:chunk])
    s = cal.conf[0][cal.valid[0]].sort(descending=True).values.cpu().numpy()
    conf = float(round((s[19] + s[20]) / 2, 6)) if s.size >= 21 else 0.3
    log(f"camera path: calibrated conf {conf} ({s.size} NMS survivors on "
        "frame 0 at 0.3)")
    detect = make_yolox_detect_fn(det_model, conf_threshold=conf,
                                  max_dets=64, compute_dtype=torch.bfloat16)
    embed = make_osnet_embed_fn(osnet, crop_size=(256, 128),
                                compute_dtype=torch.float32)
    run = partial(fused_detect_reid_track, detect, embed, chunk=chunk,
                  min_confidence=0.4, embed_dim=512)
    trackers = {
        "deepocsort": (DO.DeepOCSortConfig(**DEEPOCSORT_YAML),
                       DO.deepocsort_init, DO.deepocsort_step,
                       DO.deepocsort_scan, DO.deepocsort_scan_videos),
        "botsort": (BS.BotSortConfig(**BOTSORT_YAML), BS.botsort_init,
                    BS.botsort_step, BS.botsort_scan,
                    BS.botsort_scan_videos)}

    def warps_of(sl):
        prev = None if sl.start == 0 else video[sl.start - 1]
        return gmc_warps(video[sl], 3, 10, prev=prev)

    # warm-up on the first chunk, then the second chunk (LK and the whole
    # path) with its host syncs counted, for each tracker
    c0, c1 = slice(0, chunk), slice(chunk, 2 * chunk)
    for cfg, init_fn, step_fn, _, _ in trackers.values():
        run(step_fn=partial(step_fn, cfg), init_state=init_fn(cfg, device=dev),
            frames=video[c0], warps=warps_of(c0), return_detections=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for cfg, init_fn, step_fn, _, _ in trackers.values():
            run(step_fn=partial(step_fn, cfg),
                init_state=init_fn(cfg, device=dev), frames=video[c1],
                warps=warps_of(c1), return_detections=False)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    check(syncs == 0, f"camera path: {syncs} host syncs in one chunk of "
          "LK and each tracker's path")

    # the camera warps of the whole video, chunk by chunk, against the pan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warps = torch.cat([warps_of(slice(b, b + chunk))
                       for b in range(0, F, chunk)])
    torch.cuda.synchronize()
    lk_ms = (time.perf_counter() - t0) * 1e3 / n_chunks
    check(warps.shape == (F, 2, 3), "warps shape")
    check(torch.equal(warps[0].cpu(), torch.eye(2, 3)), "warp 0 != identity")
    w = warps[1:].cpu()
    t_err = (w[:, :, 2] - torch.tensor(drift, dtype=torch.float32)).abs()
    l_err = (w[:, :, :2] - torch.eye(2)).abs()
    check(t_err.max().item() <= 0.25,
          f"LK translation {t_err.max().item():.4f} px off the drift")
    check(l_err.max().item() <= 0.01,
          f"LK linear part {l_err.max().item():.5f} off the identity")
    cpu_err = 0.0
    for t in (1, chunk):           # inside a chunk, and across chunks
        wc = estimate_affine_lk(video[t - 1].cpu(), video[t].cpu())
        cpu_err = max(cpu_err, (wc - warps[t].cpu()).abs().max().item())
    check(cpu_err <= 1e-3, f"LK on the card vs the CPU: {cpu_err}")
    log(f"camera path LK: {lk_ms:.2f} ms per chunk of {chunk} frame pairs; "
        f"translation within {t_err.max().item():.4f} px of the drift "
        f"{drift}, linear part within {l_err.max().item():.2e} of the "
        f"identity; two pairs within {cpu_err:.2e} of the LK on the CPU")

    # where the time goes outside the tracker, on the first chunk
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    d0, det_ms = timed(lambda: detect(video[:chunk]))
    _, osnet_ms = timed(lambda: embed(video[:chunk], d0.ltrb))
    stats = dict(frames=F, chunk=chunk, drift=list(drift),
                 syncs_per_chunk=syncs, lk_ms_per_chunk=lk_ms,
                 lk_translation_max_err_px=t_err.max().item(),
                 lk_linear_max_err=l_err.max().item(),
                 lk_cpu_max_abs_diff=cpu_err, detector_ms_per_chunk=det_ms,
                 osnet_ms_per_chunk=osnet_ms,
                 live_slots_first_chunk=int(d0.valid.sum(1).max()))
    all_launches = {}
    n_plain = 2 * chunk
    for name, (cfg, init_fn, step_fn, scan, scan_videos) in trackers.items():
        step = partial(step_fn, cfg)
        inputs = []

        def rec_step(st, x):
            inputs.append(x)
            return step(st, x)

        for fn in (solve_square_batched, solve_rect_batched, fused_csplayer,
                   oru_replay_nkf):
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, out = run(step_fn=rec_step,
                           init_state=init_fn(cfg, device=dev), frames=video,
                           warps=warps, return_detections=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": solve_square_batched.launches,
                    "K2": solve_rect_batched.launches,
                    "K3": fused_csplayer.launches,
                    "ORU-NKF": oru_replay_nkf.launches}
        fps = F / (wall + lk_ms * n_chunks / 1e3)
        per_frame = out.valid.sum(1).float().mean().item()
        log(f"camera path, {name}: {F} frames in {wall:.3f} s + LK "
            f"{lk_ms * n_chunks / 1e3:.3f} s = {fps:.2f} frames/s, "
            f"{per_frame:.2f} tracks/frame, launches {launches}")
        check(launches["K3"] == 7 * n_chunks,
              f"{name}: K3 launches {launches['K3']} != 7 per chunk")
        check(launches["K1"] > 0, f"{name}: K1 never launched")
        if name == "deepocsort":
            check(launches["ORU-NKF"] == F,
                  f"ORU-NKF launches {launches['ORU-NKF']} != one per frame")
        check(out.valid.shape == (F, cfg.max_tracks), "output shape")
        check(out.valid.any().item(), f"{name} emitted no tracks")
        check(torch.isfinite(out.ltrb[out.valid]).all().item(),
              f"{name}: non-finite track boxes")

        # 16 tracker steps under the profiler
        first = inputs[:chunk]
        init = init_fn(cfg, device=dev)
        _run_stage(step, init, first)
        _, trk_ms = timed(lambda: _run_stage(step, init, first))
        trk = profile_window(torch, lambda: _run_stage(step, init, first),
                             len(first))
        log(f"camera path, {name}: tracker {trk_ms / len(first):.2f} ms per "
            f"frame; under the profiler {trk}")

        # the first n_plain recorded frames: (a) the same stage on the CPU,
        # (b) on the card with the plain JV solvers (on host copies of their
        # inputs) and the plain ORU-NKF
        head = type(out)(*(x[:n_plain] for x in out))
        cpu_out = _run_stage(step, init_fn(cfg, device="cpu"),
                             _inputs_to(inputs[:n_plain], "cpu"))
        d_cpu = _same_tracks(torch, head, cpu_out,
                             f"camera path {name}: card vs CPU")
        A.solve_square_batched, A.solve_rect_batched = (
            _plain_on_host(solve_square_batched_plain),
            _plain_on_host(solve_rect_batched_plain))
        DO.oru_replay_nkf = oru_replay_nkf_plain
        try:
            t0 = time.perf_counter()
            plain_out = _run_stage(step, init_fn(cfg, device=dev),
                                   inputs[:n_plain])
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
        finally:
            A.solve_square_batched = solve_square_batched
            A.solve_rect_batched = solve_rect_batched
            DO.oru_replay_nkf = oru_replay_nkf
        d_plain = _same_tracks(torch, head, plain_out,
                               f"camera path {name}: plain kernels")
        log(f"camera path, {name}: the first {n_plain} frames equal the CPU "
            f"stage (max box diff {d_cpu:.2e}) and the stage with the plain "
            f"JV solvers and ORU-NKF ({t_plain:.1f} s; {d_plain:.2e}) id for "
            f"id, {int(head.valid.sum())} boxes")

        if name == "deepocsort" and oru is not None:
            def record_oru(*args):
                _keep_oru(oru, args)
                return oru_replay_nkf(*args)

            DO.oru_replay_nkf = record_oru
            try:
                rerun = _run_stage(step, init_fn(cfg, device=dev), inputs)
            finally:
                DO.oru_replay_nkf = oru_replay_nkf
            _same_tracks(torch, rerun, out, "Deep-OC-SORT rerun")

        # the tracker stage alone over V videos in both modes, each against
        # its own single-video runs in that mode; K2 against its plain
        # version on the batched stage's last inputs
        Fv = F // n_videos
        vdets = Detections(*(torch.stack(f).reshape((n_videos, Fv)
                                                    + f[0].shape)
                             for f in zip(*(x[0] for x in inputs))))
        vemb = torch.stack([x[1] for x in inputs]).reshape(
            (n_videos, Fv) + inputs[0][1].shape)
        vwarp = torch.stack([x[2] for x in inputs]).reshape(n_videos, Fv, 2,
                                                            3)
        modes = {}
        for batched in (False, True):
            mcfg = replace(cfg, batched=batched)
            singles = [scan(mcfg, Detections(*(f[v] for f in vdets)),
                            vemb[v], vwarp[v])[1] for v in range(n_videos)]
            rect_in = []

            def record_k2(cost, active=None):
                rect_in.append((cost, active))
                del rect_in[:-8]
                return solve_rect_batched(cost, active)

            k1, k2 = solve_square_batched.launches, solve_rect_batched.launches
            A.solve_rect_batched = record_k2
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, vout = scan_videos(mcfg, vdets, vemb, vwarp)
                torch.cuda.synchronize()
                v_ms = (time.perf_counter() - t0) / Fv * 1e3
            finally:
                A.solve_rect_batched = solve_rect_batched
            k1 = solve_square_batched.launches - k1
            k2 = solve_rect_batched.launches - k2
            check(k2 > 0 if batched else k1 > 0,
                  f"{name} batched={batched}: no solve launched")
            dv = max(_same_tracks(torch, type(vout)(*(x[v] for x in vout)),
                                  singles[v],
                                  f"{name} batched={batched} video {v}")
                     for v in range(n_videos))
            if batched:
                for c, a in rect_in:
                    check(torch.equal(solve_rect_batched(c, a),
                                      solve_rect_batched_plain(c, a)),
                          f"K2 differs from its plain version on a {name} "
                          "input")
            modes[f"batched={batched}"] = dict(ms_per_step=v_ms, k1=k1,
                                               k2=k2, boxes=int(
                                                   vout.valid.sum()))
            log(f"camera path, {name} batched={batched} over V={n_videos} x "
                f"{Fv} frames: {int(vout.valid.sum())} boxes equal the "
                f"single-video runs id for id (max box diff {dv:.2e}); K1 "
                f"{k1}, K2 {k2} launches"
                + (f", K2 identical to its plain version on the last "
                   f"{len(rect_in)} inputs" if batched else "")
                + f"; {v_ms:.2f} ms per step for {n_videos} videos")
        all_launches[name] = launches
        stats[name] = dict(fps=fps, tracks_per_frame=per_frame,
                           path_s=wall, tracker_ms_per_frame=trk_ms
                           / len(first), tracker=trk,
                           plain_frames=n_plain, plain_s=t_plain,
                           video_axis=modes)
    return all_launches, stats


def _kernel_ms_in(torch, fn, name, top=8):
    """Device time of the kernels whose name contains ``name`` during one
    call of ``fn``, and the ``top`` kernels by device time (name, ms), from
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    ms = sum(e.self_device_time_total for e in kernels if name in e.key)
    return ms / 1e3, [(e.key[:72], e.self_device_time_total / 1e3)
                      for e in kernels[:top]]



def _host_packages():
    """Whether pandas and yaml import here, with their versions."""
    out = {}
    for name in ("pandas", "yaml"):
        try:
            out[name] = __import__(name).__version__
        except ImportError as e:
            out[name] = f"not importable ({e})"
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from tracklab_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    log(f"host packages: {_host_packages()}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    check_sass(torch)

    k1, k1_steps = phase_k1(torch, dev)
    k2_random = phase_k2(torch, dev)
    k3 = phase_k3(torch, dev, time_batch=128)
    phase_tracker(torch, dev)
    phase_batched_trackers(torch, dev)
    k4 = phase_k4(torch, dev)
    kpr_stats = phase_kpr(torch, dev)
    phase_bpbreid(torch, dev)
    lx_stats = phase_yolox_lx(torch, dev)
    oru_in = {"main_path": {}, "multi_video_path": {}}
    launches, main_stats = phase_main(torch, dev, oru=oru_in["main_path"])
    v_launches, k2, videos_stats = phase_videos(
        torch, dev, oru=oru_in["multi_video_path"])
    p_launches, parts_stats = phase_parts(torch, dev)
    oru = phase_oru(torch, oru_in)
    r_launches, rb_launches, reid_stats = phase_reid(torch, dev)
    nkf_in = {}
    m_launches, motion_stats = phase_motion(torch, dev, oru=nkf_in)
    oru_nkf, motion_stats["oru_nkf"] = phase_oru_nkf(torch, dev, nkf_in)
    # each kernel's launches on the path that carries it: K1 and K3 on the
    # single-video main path, K2 on the multi-video path (timed there on the
    # path's own problems; the random-cost timing is kept beside it), K4 on
    # the parts path
    k1["launches"], k3["launches"] = launches["K1"], launches["K3"]
    k2["launches"] = v_launches["K2"]
    k4["launches"] = p_launches["K4"]
    oru["launches"] = launches["ORU"]
    oru_nkf["launches"] = m_launches["deepocsort"]["ORU-NKF"]
    videos_stats["k2_random_costs"] = {
        k: k2_random[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "steps", "longest_problem_steps",
                                  "ns_per_step")}
    main_stats["k1_s64"] = k1_steps

    print(json.dumps({"main_path": main_stats,
                      "multi_video_path": videos_stats,
                      "parts_path": parts_stats, "reid_path": reid_stats,
                      "camera_path": motion_stats,
                      "kpr_check": kpr_stats, "yolox_l_x": lx_stats,
                      "launches": {"main_path": launches,
                                   "multi_video_path": v_launches,
                                   "parts_path": p_launches,
                                   "reid_path": r_launches,
                                   "reid_batched_tracker": rb_launches,
                                   "camera_path": m_launches}}))
    print(smi)
    print(json.dumps({"kernels": [k1, k2, k3, k4, oru, oru_nkf]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
