"""Encrypted inner products completed over the whole window, divided by
the window."""

from fhebench.metrics._stats import rate as read  # noqa: F401
