from tracklab_torch.config.compose import (  # noqa
    compose, instantiate, load_yaml, OmegaDict,
)
