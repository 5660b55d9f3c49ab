"""RTMDet detector module (counterpart of
tracklab_tpu.wrappers.bbox_detector.rtmdet_api): the reference's rtmlib
RTMDet role, images -> bbox columns through the port's RTMDet
(``models/rtmdet.py``) and NMS on the card.

The pipeline surface is ``YOLOXDetector``'s (host letterbox, one batch
through the detector and NMS, host unletterbox); the model differs, and so
does the input scale: mmdet's data preprocessor subtracts a mean and divides
by a std per channel (RGB order here, as the loader decodes RGB), which the
staged path and the fused engine's closure share through
``device_detect_fn``.

Weights: ``checkpoint_path`` names a ``torch.save``d state dict, the
port's own (``models/convert.py:rtmdet_from_flax`` writes one from the JAX
package's tree) or an mmdet one, both loaded through
``convert_rtmdet_torch``. Without one the weights are seeded random, with a
warning.
"""
from __future__ import annotations

import torch

from tracklab_torch.wrappers.bbox_detector.yolox_api import (_NOT_PORTED,
                                                             YOLOXDetector)

__all__ = ["RTMDetDetector"]

# mmdet's data_preprocessor (not in the state dict), in RGB order
_MEAN = (123.675, 116.28, 103.53)
_STD = (58.395, 57.12, 57.375)


class RTMDetDetector(YOLOXDetector):
    """RTMDet-{nano..x}; rtmlib's default is nano at 320 x 320, persons."""

    # its training is not ported (ROADMAP item 6): main.py does not call it
    training_enabled = False

    def train(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("RTMDetDetector.train"))

    def __init__(self, variant: str = "nano", input_size=(320, 320),
                 **kwargs):
        kwargs.setdefault("min_confidence", 0.45)
        super().__init__(variant=variant, input_size=input_size, **kwargs)

    def _make_model(self):
        from tracklab_torch.models.rtmdet import RTMDet
        return RTMDet(num_classes=self.num_classes, variant=self.variant,
                      device=self.device)

    @property
    def _preproc(self):
        # the constants go to the card when the closure is built, not
        # inside the program that runs it
        mean = torch.tensor(_MEAN, device=self.device)
        std = torch.tensor(_STD, device=self.device)
        return lambda images: (images - mean) / std
