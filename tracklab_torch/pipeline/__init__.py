from tracklab_torch.pipeline.module import Module, Pipeline, Skip  # noqa
from tracklab_torch.pipeline.levels import (  # noqa
    ImageLevelModule, DetectionLevelModule, VideoLevelModule, Evaluator,
)
