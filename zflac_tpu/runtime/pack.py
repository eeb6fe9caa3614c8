"""Single-buffer argument packing for the reconstruction dispatch.

Every host->device transfer pays a fixed per-transfer cost, so passing
the plan as ~15 separate arrays pays it ~15 times per decode. This
module packs every int32/uint32 plan array into ONE contiguous int32
buffer on the host (a memcpy) so the whole decode is one transfer + one
dispatch; the jitted wrapper slices the arrays back out with static
offsets (the spec -- a hashable tuple -- is part of the jit cache key,
and offsets are bucketed upstream so the cache is reused across calls).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class Packer:
    """Accumulates named int32/uint32 arrays; finish() emits one flat
    int32 buffer plus the static spec describing how to slice it."""

    def __init__(self):
        self._entries = []
        self._arrays = []
        self._off = 0

    def add(self, name: str, arr: np.ndarray):
        a = np.ascontiguousarray(arr)
        if a.dtype == np.uint32:
            tag = "u"
            a = a.view(np.int32)
        else:
            a = a.astype(np.int32, copy=False)
            tag = "i"
        self._entries.append((name, self._off, a.shape, tag))
        self._arrays.append(a.reshape(-1))
        self._off += a.size

    def finish(self):
        buf = np.empty(max(self._off, 1), np.int32)
        at = 0
        for a in self._arrays:
            buf[at:at + a.size] = a
            at += a.size
        return buf, tuple(self._entries)


def unpack(buf, spec):
    """Slice the packed device buffer back into named arrays (traced;
    offsets/shapes are compile-time constants)."""
    out = {}
    for name, off, shape, tag in spec:
        n = 1
        for s in shape:
            n *= s
        a = jax.lax.slice(buf, (off,), (off + n,)).reshape(shape)
        if tag == "u":
            a = jax.lax.bitcast_convert_type(a, jnp.uint32)
        out[name] = a
    return out
