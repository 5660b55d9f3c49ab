from tracklab_torch.callbacks.callback import Callback  # noqa
from tracklab_torch.callbacks.progress import Progressbar  # noqa
from tracklab_torch.callbacks.timer import Timer  # noqa
