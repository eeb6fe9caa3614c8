"""The one place that picks the device backend of the decode graphs.

"gpu" builds the graphs with the Triton kernels of `ops/`; "cpu"
builds them from the plain XLA math, which is also the kernels'
reference. The answer is a static argument of every jitted graph, so a
graph compiles once per backend. Any other platform raises: there is no
silent fallback.
"""

from __future__ import annotations

import jax

BACKENDS = ("gpu", "cpu")


def backend(devices=None) -> str:
    """Backend for `devices` (all of one platform), or for the default
    device (`jax.default_device` if set, else jax.devices()[0])."""
    if devices is None:
        d = jax.config.jax_default_device or jax.devices()[0]
        platforms = {getattr(d, "platform", d)}
    else:
        platforms = {d.platform for d in devices}
    if len(platforms) != 1 or next(iter(platforms)) not in BACKENDS:
        raise ValueError(
            f"no decode backend for platform(s) {sorted(platforms)}; "
            f"expected one of {BACKENDS}")
    return platforms.pop()
