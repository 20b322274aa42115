"""Dataset generation and loading (counterpart: tdc_tpu/data)."""

from tdc_tpu_torch.data.loader import (
    FEATURE_MAJOR_SUFFIX,
    load_points,
    load_points_feature_major,
    to_feature_major,
)
from tdc_tpu_torch.data.synthetic import make_blobs

__all__ = ["FEATURE_MAJOR_SUFFIX", "load_points",
           "load_points_feature_major", "make_blobs", "to_feature_major"]
