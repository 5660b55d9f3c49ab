"""YOLOv8 / YOLO11 detector module (counterpart of
tracklab_tpu.wrappers.bbox_detector.yolov8_api): images -> bbox columns
through the port's YOLOv8 or YOLO11 and NMS on the card.

The pipeline surface is ``YOLOXDetector``'s; the models differ, and so does
the input scale: this family reads pixels divided by 255 (``_preproc``),
which the staged path and the fused engine's closure share through
``device_detect_fn``.

Weights: ``checkpoint_path`` names a ``torch.save``d state dict, either the
port's own (``models/convert.py:yolov8_from_flax`` or
``yolo11_from_flax`` writes one from the JAX package's tree) or an
ultralytics one, both loaded through ``convert_yolov8_torch``, which takes
the port's keys as they are and holds every tensor to the model. Without
one the weights are seeded random, with a warning.
"""
from __future__ import annotations

from tracklab_torch.wrappers.bbox_detector.yolox_api import (_NOT_PORTED,
                                                             YOLOXDetector)

__all__ = ["YOLOv8Detector"]


class YOLOv8Detector(YOLOXDetector):
    """``variant`` "n".."x" selects YOLOv8, "11n".."11x" YOLO11 (the family
    the reference's default config loads, yolo11m)."""

    def _make_model(self):
        if self.variant.startswith("11"):
            from tracklab_torch.models.yolo11 import YOLO11
            return YOLO11(num_classes=self.num_classes,
                          variant=self.variant[2:], device=self.device)
        from tracklab_torch.models.yolov8 import YOLOv8
        return YOLOv8(num_classes=self.num_classes, variant=self.variant,
                      device=self.device)

    def _load_state(self, model, state):
        from tracklab_torch.models.convert import convert_yolov8_torch
        convert_yolov8_torch(state, model)

    @staticmethod
    def _preproc(images):
        return images / 255.0

    def detection_loss_fn(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(
            "YOLOv8Detector.detection_loss_fn"))
