from tracklab_torch.wrappers.dataset.synthetic import (  # noqa
    SyntheticDataset, make_synthetic_set,
)
from tracklab_torch.wrappers.dataset.mot_like import (  # noqa
    MOT, MOT17, MOT20, DanceTrack, SportsMOT, Bee24,
)
from tracklab_torch.wrappers.dataset.external_video import (  # noqa
    ExternalVideo,
)
