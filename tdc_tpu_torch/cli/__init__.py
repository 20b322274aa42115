"""Command-line entry points (counterpart: tdc_tpu/cli)."""
