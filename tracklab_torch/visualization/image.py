"""Image-level visualizers (counterpart of
tracklab_tpu.visualization.image)."""
from __future__ import annotations

from tracklab_torch.utils.cv2 import draw_text
from tracklab_torch.visualization.visualizer import ImageVisualizer

__all__ = ["FrameCounterVisualizer"]


class FrameCounterVisualizer(ImageVisualizer):
    def draw_frame(self, image, detections_pred, detections_gt,
                   image_metadata):
        frame = image_metadata.get("frame", "?")
        draw_text(image, f"frame {frame}", (12, 28), scale=0.8,
                  color=(255, 255, 255), bg_color=(0, 0, 0))
