"""The yardstick of the kernels: one file per port kernel, named as in
tpufhe_torch/kernels.py, with its names in the device trace (TRACE), the
program's wrapper that launches it (PATCH, module or module:class and the
attribute), the plain numbers of one launch read from that wrapper's
arguments (shape) and the bytes and int32 multiplies the launch needs
(cost), frozen from chip_smoke.py's bound arithmetic. peaks.py holds the
card's peaks and the multiply counts of the modular operations.
"""
