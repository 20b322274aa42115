"""Deterministic test harnesses (counterpart: tdc_tpu/testing): the fault
points and the flaky HTTP blob server, importable from the port's code
paths at no cost when inactive."""

from tdc_tpu_torch.testing.faults import fault_point, parse_faults, reset

__all__ = ["fault_point", "parse_faults", "reset"]
