"""The GPU LPC kernels (ops/lpc_triton.py) in Pallas interpret mode
against their plain XLA references (`_lpc_scan`, `lpc2w_scan`,
`lpc2w33_scan`), over every history bucket, every kernel class, and
padded block sizes that are 128-multiples but not powers of two (FLAC
blocks 576/1152 pad to 640/1152) as well as the 4096 bench block."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zflac_tpu.ops.lpc2w import lpc2w33_scan, lpc2w_scan
from zflac_tpu.ops.lpc_triton import (lpc_triton, lpc_triton_wide,
                                      lpc_triton_wide33)
from zflac_tpu.runtime.reconstruct import lpc_scan_t
from zflac_tpu.testing import lpc_case


CLASSES = {
    "int32": (lpc_triton, lpc_scan_t, False, 1),
    "wide": (lpc_triton_wide, lpc2w_scan, True, 1),
    "wide33": (lpc_triton_wide33, lpc2w33_scan, True, 2),
}


@pytest.mark.parametrize("B", [640, 1152, 4096])
@pytest.mark.parametrize("hist", [8, 16, 32])
@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_lpc_triton_interpret_matches_scan(cls, hist, B):
    kernel, ref, wide, n_rows = CLASSES[cls]
    # 40 lanes: one full 32-lane block plus a padded one.
    rows, cf, shift, order = map(jnp.asarray,
                                 lpc_case(B + hist, B, 40, hist, wide))
    args = ((rows >> 31, rows) if n_rows == 2 else (rows,)) + (
        cf, shift, order)
    got = jax.jit(lambda *a: kernel(*a, hist=hist, interpret=True))(*args)
    want = jax.jit(lambda *a: ref(*a, hist=hist))(*args)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
