from tracklab_torch.wrappers.dataset.synthetic import (  # noqa
    SyntheticDataset, make_synthetic_set,
)
