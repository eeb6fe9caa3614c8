"""Varying-manual-axes plumbing for Pallas under shard_map.

A `pallas_call` inside `jax.shard_map` must declare how its outputs
vary across mesh axes (`check_vma`); an out_shape without `vma` raises
at trace time. Every kernel output here varies exactly like its inputs
(each device's block is computed from that device's shard — there are
no cross-device reads), so the out struct's vma is the union of the
input vmas. Outside shard_map the union is empty.
"""

from __future__ import annotations

import jax


def out_struct(shape, dtype, *args):
    """ShapeDtypeStruct whose vma is the union of the args' vmas."""
    vma = frozenset()
    for a in args:
        vma |= jax.typeof(a).vma
    return jax.ShapeDtypeStruct(shape, dtype, vma=vma)
