"""Dataset generation, loading, streaming and device-memory-aware
batching (counterpart: tdc_tpu/data)."""

from tdc_tpu_torch.data.batching import auto_batch_size, oom_adaptive
from tdc_tpu_torch.data.loader import (
    FEATURE_MAJOR_SUFFIX,
    NpzStream,
    crc_sidecar_path,
    load_points,
    load_points_feature_major,
    to_feature_major,
)
from tdc_tpu_torch.data.synthetic import make_blobs

__all__ = ["FEATURE_MAJOR_SUFFIX", "NpzStream", "auto_batch_size",
           "crc_sidecar_path",
           "load_points", "load_points_feature_major", "make_blobs",
           "oom_adaptive", "to_feature_major"]
