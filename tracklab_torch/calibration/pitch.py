"""Soccer pitch geometry, FIFA-standard 105 x 68 m (counterpart of
tracklab_tpu.calibration.pitch, kept as the port's own copy).

Point-sampled pitch segments for calibration: each named segment
(touchlines, goal lines, penalty boxes, centre circle, ...) is a fixed-size
array of 3D points on the z = 0 plane, in pitch-centred coordinates (x
right, y down on the broadcast view).
"""
from __future__ import annotations

import numpy as np

__all__ = ["PITCH_LENGTH", "PITCH_WIDTH", "pitch_segments"]

PITCH_LENGTH = 105.0
PITCH_WIDTH = 68.0


def _line(p0, p1, n):
    t = np.linspace(0.0, 1.0, n)[:, None]
    return (1 - t) * np.asarray(p0, float)[None] \
        + t * np.asarray(p1, float)[None]


def _circle(center, radius, n, start=0.0, end=2 * np.pi):
    t = np.linspace(start, end, n)
    return np.stack([center[0] + radius * np.cos(t),
                     center[1] + radius * np.sin(t)], axis=1)


def pitch_segments(points_per_segment: int = 16) -> dict:
    """name -> (N, 3) z=0 world points."""
    L, W = PITCH_LENGTH / 2, PITCH_WIDTH / 2
    n = points_per_segment
    segs2d = {
        "side_line_top": _line((-L, -W), (L, -W), n),
        "side_line_bottom": _line((-L, W), (L, W), n),
        "goal_line_left": _line((-L, -W), (-L, W), n),
        "goal_line_right": _line((L, -W), (L, W), n),
        "middle_line": _line((0, -W), (0, W), n),
        "center_circle": _circle((0, 0), 9.15, n),
        "big_rect_left_main": _line((-L + 16.5, -20.16), (-L + 16.5,
                                                          20.16), n),
        "big_rect_left_top": _line((-L, -20.16), (-L + 16.5, -20.16), n),
        "big_rect_left_bottom": _line((-L, 20.16), (-L + 16.5, 20.16), n),
        "big_rect_right_main": _line((L - 16.5, -20.16), (L - 16.5,
                                                          20.16), n),
        "big_rect_right_top": _line((L, -20.16), (L - 16.5, -20.16), n),
        "big_rect_right_bottom": _line((L, 20.16), (L - 16.5, 20.16), n),
        "small_rect_left_main": _line((-L + 5.5, -9.16), (-L + 5.5,
                                                          9.16), n),
        "small_rect_left_top": _line((-L, -9.16), (-L + 5.5, -9.16), n),
        "small_rect_left_bottom": _line((-L, 9.16), (-L + 5.5, 9.16), n),
        "small_rect_right_main": _line((L - 5.5, -9.16), (L - 5.5,
                                                          9.16), n),
        "small_rect_right_top": _line((L, -9.16), (L - 5.5, -9.16), n),
        "small_rect_right_bottom": _line((L, 9.16), (L - 5.5, 9.16), n),
        "circle_left": _circle((-L + 11.0, 0), 9.15, n, -0.93, 0.93),
        "circle_right": _circle((L - 11.0, 0), 9.15, n,
                                np.pi - 0.93, np.pi + 0.93),
    }
    return {k: np.concatenate([v, np.zeros((len(v), 1))], axis=1)
            for k, v in segs2d.items()}
