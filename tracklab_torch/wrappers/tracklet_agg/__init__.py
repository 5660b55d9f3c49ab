from tracklab_torch.wrappers.tracklet_agg.majority_vote import (  # noqa
    MajorityVoteTracklet, select_highest_voted_att,
)
