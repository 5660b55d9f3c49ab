from tracklab_torch.wrappers.pose_estimator.topdown_api import (  # noqa
    TopDownPoseEstimator,
)
from tracklab_torch.wrappers.pose_estimator.bottomup_api import (  # noqa
    BottomUpPoseEstimator,
)
from tracklab_torch.wrappers.pose_estimator.batched_api import (  # noqa
    TopDownPoseBatched,
)
