from tracklab_torch.eval.metrics import (  # noqa
    hota_metrics, clear_metrics, identity_metrics, evaluate_sequence,
    combine_sequences,
)
from tracklab_torch.eval.evaluator import TrackEvalEvaluator  # noqa
