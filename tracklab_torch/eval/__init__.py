from tracklab_torch.eval.metrics import (  # noqa
    hota_metrics, clear_metrics, identity_metrics, evaluate_sequence,
    combine_sequences,
)
from tracklab_torch.eval.evaluator import TrackEvalEvaluator  # noqa
from tracklab_torch.eval.pose_evaluator import (  # noqa
    PoseTrackEvaluator, PoseTrack21Evaluator, PoseTrack18Evaluator,
)
from tracklab_torch.eval.pose_metrics import (  # noqa
    make_pose_sequence_data, keypoint_map,
)
