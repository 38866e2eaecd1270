"""One reader per metric, named by the metric's name before its first
dot: read(window, name) takes the number from the run's Window
(fhebench/trace.py), or returns None where the run holds nothing to read,
and the harness then leaves the metric out of the line."""
