from tracklab_torch.wrappers.track.scan_tracker import (  # noqa
    OCSORT, ByteTrack, StrongSORT, BotSORT, DeepOCSORT, BPBReIDStrongSORT,
)
