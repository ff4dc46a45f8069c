"""Device-resident background plane: decay, link prediction, FastRP and
inference candidate generation as device jobs over per-etype delta
snapshots (counterpart of ``nornicdb_tpu/background``)."""

from nornicdb_tpu_torch.background.device_plane import (  # noqa: F401
    BackgroundDevicePlane,
    bg_device_mode,
)
