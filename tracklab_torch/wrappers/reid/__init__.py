from tracklab_torch.wrappers.reid.osnet_api import OSNetReId  # noqa
from tracklab_torch.wrappers.reid.batched_api import OSNetReIdBatched  # noqa
from tracklab_torch.wrappers.reid.kpr_api import KPReId, KPReIdBatched  # noqa
