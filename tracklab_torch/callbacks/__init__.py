from tracklab_torch.callbacks.callback import Callback  # noqa
from tracklab_torch.callbacks.handle_regions import IgnoredRegions  # noqa
from tracklab_torch.callbacks.profiler import TorchProfiler  # noqa
from tracklab_torch.callbacks.progress import Progressbar  # noqa
from tracklab_torch.callbacks.timer import Timer  # noqa
