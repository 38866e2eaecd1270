"""The device milliseconds of the expansion's `fold` stage: the K1 forward
and add that end the rotation, then the fold's subtractions, Shoup
products by the monomial, adds and cat. Its device interval (CUDA events
on the kernels' stream at the stage's ends), summed over the doublings
of one make_expand call, as the median over the window's calls. The
interval includes any time the device idles inside the stage, waiting
for the host. The three stages tile each doubling, so keyswitch +
switch_down + fold is the expansion's device interval."""

from fhebench.metrics._spans import stage_ms


def read(w, name):
    return stage_ms("expand", "fold")
