"""Distance, assignment, seeding and the hand-written CUDA kernels
(counterpart: tdc_tpu/ops)."""
