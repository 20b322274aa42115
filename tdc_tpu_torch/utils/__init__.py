"""Host-side utilities (counterpart: tdc_tpu/utils)."""
