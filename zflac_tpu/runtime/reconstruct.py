"""Batched signal reconstruction: dense plan arrays in, PCM out.

All per-sample math of the decoder — predictor integration, wasted-bits
shifts, stereo decorrelation, container wrap — expressed as XLA-compiled
vector ops over [S, B] (subframes x samples) arrays, with no
data-dependent shapes:

  * fixed orders 0-4: k-fold masked cumsum seeded by the warm-up
    finite-difference triangle (linear; exact in wraparound int32 —
    SURVEY.md §7 fact 2; math of zflac.zig:481-490)
  * LPC orders 1-32: lax.scan over time with a rolling 32-slot history
    window batched over subframes (the nonlinear `>> shift` recurrence
    of zflac.zig:526-533/604-612; fact 3); on the GPU the int32 class
    runs the Triton kernel of ops/lpc_triton.py instead
  * decorrelation / wasted bits / container wrap: elementwise int ops
    (zflac.zig:553-578, 447, 493-497)

Subframes are routed to per-kind kernel classes via host-built gather
lists padded to bucket sizes (pad entries point out-of-bounds: gathers
clip harmlessly, scatters drop).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import format as fmt
from .scatter import scatter_rows

# Class order is part of the jit signature.
CLASS_NAMES = ("const", "verbatim", "fixed", "lpc", "lpc_wide")


def _fixed_integrate(rows, order, seeds):
    """k-fold seeded cumsum for fixed predictors, vectorized over rows
    with mixed orders 0-4. rows: [n, B] warmup-seeded; seeds: [n, 4]."""
    n, B = rows.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (n, B), 1)
    work = rows
    for j in range(3, -1, -1):
        active = (order > j)[:, None]
        m = jnp.where(col < j, jnp.zeros_like(work),
                      jnp.where(col == j, seeds[:, j:j + 1], work))
        c = jnp.cumsum(m, axis=1, dtype=work.dtype)
        work = jnp.where(active & (col >= j), c, work)
    return work


def _fixed_integrate_t(rows_t, order, seeds_t):
    """Time-major twin of _fixed_integrate (the pack2 v3 layout):
    rows_t [B, n] warmup-seeded, order [n], seeds_t [4, n]. Cumsums run
    along axis 0 (time)."""
    B, n = rows_t.shape
    row = jax.lax.broadcasted_iota(jnp.int32, (B, n), 0)
    work = rows_t
    for j in range(3, -1, -1):
        active = (order > j)[None, :]
        m = jnp.where(row < j, jnp.zeros_like(work),
                      jnp.where(row == j, seeds_t[j:j + 1, :], work))
        c = jnp.cumsum(m, axis=0, dtype=work.dtype)
        work = jnp.where(active & (row >= j), c, work)
    return work


def _lpc_scan(rows, coeffs_rev, shift, order):
    """Batched LPC recurrence: rows [n, B] (warmups at t < order,
    residuals after), coeffs_rev [n, 32] (slot 31-j multiplies s[t-1-j]),
    shift [n], order [n]. Returns the reconstructed signal [n, B]."""
    n, B = rows.shape
    dtype = rows.dtype
    coeffs = coeffs_rev.astype(dtype)
    shift = shift.astype(dtype)
    # Derived from rows (not a fresh constant) so that under shard_map the
    # carry inherits the 'dp' varying-axis type of the sharded inputs.
    window0 = jnp.tile(rows[:, :1] * 0, (1, 32))

    def step(window, xs):
        t, row_t = xs
        pred = jnp.sum(window * coeffs, axis=1, dtype=dtype)
        pred = jnp.right_shift(pred, shift)
        out = jnp.where(t >= order, row_t + pred, row_t)
        window = jnp.concatenate([window[:, 1:], out[:, None]], axis=1)
        return window, out

    ts = jnp.arange(B, dtype=jnp.int32)
    _, outs = jax.lax.scan(step, window0, (ts, rows.T))
    return outs.T


def lpc_scan_t(rows_t, cfwd_t, shift, order, *, hist: int):
    """_lpc_scan in the time-major form of the pack2 graph and the GPU
    kernels: rows_t [B, S], cfwd_t [hist, S] with row r = c_{r+1} (the
    coefficient of s[t-1-r], i.e. coeffs_rev slot 31-r), shift/order
    [1, S]. Returns [B, S]."""
    coeffs_rev = jnp.pad(cfwd_t[::-1].T, ((0, 0), (32 - hist, 0)))
    return _lpc_scan(rows_t.T, coeffs_rev, shift[0], order[0]).T


def _lpc_triton_rows(rows, coeffs_rev, shift, order):
    """_lpc_scan's arguments through the GPU kernel (int32 rows): the
    kernel is time-major with forward coefficients (row r = c_{r+1},
    the coefficient of s[t-1-r] = coeffs_rev slot 31-r)."""
    from ..ops.lpc_triton import lpc_triton
    out_t = lpc_triton(
        rows.T, coeffs_rev[:, ::-1].T.astype(jnp.int32),
        shift[None, :].astype(jnp.int32),
        order[None, :].astype(jnp.int32), hist=32)
    return out_t.T


def _reconstruct_core(rows, kind, order, wasted, shift, coeffs_rev,
                      fixed_seeds, class_idx, channel_code, *,
                      num_channels: int, container_bits: int,
                      do_decorrelate: bool, backend: str):
    """Shared reconstruction body: rows [S, B] -> PCM [F, B, C]."""
    S, B = rows.shape
    dtype = rows.dtype
    signal = jnp.zeros((S, B), dtype=dtype)

    idx = class_idx.get("const")
    if idx is not None:
        vals = jnp.broadcast_to(rows[idx, 0:1], (idx.shape[0], B))
        signal = scatter_rows(signal, idx, vals)

    idx = class_idx.get("verbatim")
    if idx is not None:
        signal = scatter_rows(signal, idx, rows[idx])

    idx = class_idx.get("fixed")
    if idx is not None:
        out = _fixed_integrate(rows[idx], order[idx], fixed_seeds[idx])
        signal = scatter_rows(signal, idx, out)

    idx = class_idx.get("lpc")
    if idx is not None:
        if backend == "gpu" and dtype == jnp.int32:
            out = _lpc_triton_rows(rows[idx], coeffs_rev[idx],
                                   shift[idx], order[idx])
        else:
            out = _lpc_scan(rows[idx], coeffs_rev[idx], shift[idx],
                            order[idx])
        signal = scatter_rows(signal, idx, out)

    idx = class_idx.get("lpc_wide")
    if idx is not None:
        # int32 stream whose LPC accumulator may exceed 32 bits: compute
        # this class in int64 (the reference's InterType widening,
        # zflac.zig:314-319).
        out = _lpc_scan(rows[idx].astype(jnp.int64),
                        coeffs_rev[idx], shift[idx], order[idx])
        signal = scatter_rows(signal, idx, out.astype(dtype))

    # Wasted-bits shift (zflac.zig:447,459,495-496,538-539).
    signal = jnp.left_shift(signal, wasted.astype(dtype)[:, None])

    # ---- stereo decorrelation (zflac.zig:553-578) ----
    F = S // num_channels
    frames = signal.reshape(F, num_channels, B)
    if do_decorrelate and num_channels == 2:
        mode = channel_code[:, None]
        c0, c1 = frames[:, 0], frames[:, 1]
        mid = (c0 << 1) | (c1 & 1)
        new0 = jnp.where(
            mode == fmt.CH_SIDE_RIGHT, c0 + c1,
            jnp.where(mode == fmt.CH_MID_SIDE, (mid + c1) >> 1, c0))
        new1 = jnp.where(
            mode == fmt.CH_LEFT_SIDE, c0 - c1,
            jnp.where(mode == fmt.CH_MID_SIDE, (mid - c1) >> 1, c1))
        frames = jnp.stack([new0, new1], axis=1)

    # [F, C, B] -> [F, B, C], container wrap (release-mode @intCast).
    pcm = frames.transpose(0, 2, 1)
    cdtype = {8: jnp.int8, 16: jnp.int16, 32: jnp.int32}[container_bits]
    return pcm.astype(cdtype)


@functools.partial(
    jax.jit,
    static_argnames=("num_channels", "container_bits", "do_decorrelate",
                     "backend"))
def reconstruct(rows, kind, order, wasted, shift, coeffs_rev, fixed_seeds,
                class_idx, channel_code, *, num_channels: int,
                container_bits: int, do_decorrelate: bool,
                backend: str):
    """Plan arrays -> container-width PCM [F, B, C] (pre-normalization).

    class_idx: dict name -> padded int32 gather lists (out-of-bounds
    entries are padding).
    """
    return _reconstruct_core(
        rows, kind, order, wasted, shift, coeffs_rev, fixed_seeds,
        class_idx, channel_code, num_channels=num_channels,
        container_bits=container_bits, do_decorrelate=do_decorrelate,
        backend=backend)


@functools.partial(
    jax.jit,
    static_argnames=("spec", "class_names", "num_channels",
                     "container_bits", "do_decorrelate", "backend"))
def reconstruct_packed(buf, *, spec, class_names, num_channels: int,
                       container_bits: int, do_decorrelate: bool,
                       backend: str):
    """Single-buffer variant of reconstruct(): `buf` is one int32 array
    holding every plan array (runtime/pack.py), so a decode is one
    transfer + one dispatch instead of ~15. `spec` (static) maps names
    to slices; `class_names` lists the kernel classes present."""
    from .pack import unpack
    a = unpack(buf, spec)
    class_idx = {n: a["ci_" + n] for n in class_names}
    return _reconstruct_core(
        a["rows"], a["kind"], a["order"], a["wasted"], a["shift"],
        a["coeffs"], a["seeds"], class_idx, a["channel_code"],
        num_channels=num_channels, container_bits=container_bits,
        do_decorrelate=do_decorrelate, backend=backend)
