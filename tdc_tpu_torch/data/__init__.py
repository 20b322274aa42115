"""Dataset generation and loading (counterpart: tdc_tpu/data)."""

from tdc_tpu_torch.data.loader import load_points
from tdc_tpu_torch.data.synthetic import make_blobs

__all__ = ["load_points", "make_blobs"]
