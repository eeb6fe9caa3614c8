"""LPC recurrence kernels for the GPU (Pallas, Triton route).

The LPC time loop is inherently sequential: the `>> shift` inside the
recurrence is nonlinear (zflac.zig:526-533; SURVEY.md §7 fact 3), so
the only parallelism is across subframes. XLA's form (`lax.scan` over
Bp time steps) pays at least one kernel launch per step on the GPU.
These kernels instead give every subframe lane one thread and loop over
the whole time axis INSIDE the program:

  * grid: 1-D over blocks of LANES sorted subframe lanes; nothing
    carries between programs;
  * layout: pack2's time-major [Bp, S] rows, so each step's row load
    (LANES consecutive int32) is coalesced;
  * state: the *transposed direct form* — a pipeline P of `hist`
    partial predictions, P[r] = prediction for time t+r from samples
    < t. Per step: pred = P[0]; out = res + (pred >> shift) once
    t >= order; P'[r] = P[r+1] + out * c[r] (c[r] = c_{r+1}, the
    coefficient of s[t-1-r]). The loop-carried chain is ~5 ops instead
    of a hist-wide reduction. Triton cannot slice a register tensor,
    so P is a tuple of `hist` [LANES] vectors rotated at trace time;
  * the time loop is unrolled by UNROLL steps, with the next group's
    residual rows loaded one group ahead so load latency overlaps the
    recurrence.

int32 wraparound addition is associative, so the reordered
accumulation is bit-exact against the reference's index-order sum.
The wide variants carry P as hi/lo int32 pairs with the step math of
ops/lpc2w.py (64-bit accumulator for 17-32 bps streams, and 33-bit
samples for the side channel of 32-bit stereo).

References: `_lpc_scan` (runtime/reconstruct.py), `lpc2w_scan`,
`lpc2w33_scan` (ops/lpc2w.py). `interpret=True` runs the same kernel
bodies on the CPU (tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .lpc2w import (_i32, _u32, add64, mul64, mul64_33, wide33_out,
                    wide_out)
from .vma import out_struct

LANES = 32      # one warp: one thread per subframe lane
UNROLL = 8      # divides every Bp (a multiple of 128)


def _load_rows(ref, t, n):
    return tuple(ref[t + u, :] for u in range(n))


def _time_loop(B, first, body, state):
    """fori_loop over UNROLL-step groups; `body(t0, rows, state)`
    consumes the group's residual rows, which were loaded one group
    ahead (`first(t)` loads the rows of the group at t; the last
    prefetch re-reads the final group instead of running past B)."""
    def group(g, carry):
        state, rows = carry
        t0 = g * UNROLL
        nxt = first(jnp.minimum(t0 + UNROLL, B - UNROLL))
        return body(t0, rows, state), nxt

    return jax.lax.fori_loop(0, B // UNROLL, group, (state, first(0)))


def _lpc_kernel(rows_ref, cfwd_ref, shift_ref, order_ref, out_ref, *,
                hist: int):
    B = rows_ref.shape[0]
    cf = tuple(cfwd_ref[r, :] for r in range(hist))
    shift = shift_ref[0, :]
    order = order_ref[0, :]

    def body(t0, rows, P):
        for u in range(UNROLL):
            res = rows[u]
            out = jnp.where(t0 + u >= order, res + (P[0] >> shift), res)
            out_ref[t0 + u, :] = out
            P = tuple(P[r + 1] + out * cf[r] for r in range(hist - 1)) \
                + (out * cf[hist - 1],)
        return P

    zero = jnp.zeros_like(shift)
    _time_loop(B, lambda t: _load_rows(rows_ref, t, UNROLL), body,
               (zero,) * hist)


def _lpc_wide_kernel(rows_ref, cfwd_ref, shift_ref, order_ref, out_ref,
                     *, hist: int):
    B = rows_ref.shape[0]
    cf = tuple(cfwd_ref[r, :] for r in range(hist))
    shift_u = _u32(shift_ref[0, :])
    order = order_ref[0, :]

    def body(t0, rows, P):
        P_hi, P_lo = P
        for u in range(UNROLL):
            out = wide_out(P_hi[0], P_lo[0], rows[u], shift_u,
                           t0 + u < order)
            out_ref[t0 + u, :] = out
            v = [mul64(cf[r], out) for r in range(hist)]
            nxt = [add64(P_hi[r + 1], P_lo[r + 1], *v[r])
                   for r in range(hist - 1)] + [v[hist - 1]]
            P_hi = tuple(h for h, _ in nxt)
            P_lo = tuple(lo for _, lo in nxt)
        return P_hi, P_lo

    zero = jnp.zeros_like(order)
    _time_loop(B, lambda t: _load_rows(rows_ref, t, UNROLL), body,
               ((zero,) * hist, (_u32(zero),) * hist))


def _lpc_wide33_kernel(rows_hi_ref, rows_lo_ref, cfwd_ref, shift_ref,
                       order_ref, out_hi_ref, out_lo_ref, *, hist: int):
    B = rows_lo_ref.shape[0]
    cf = tuple(cfwd_ref[r, :] for r in range(hist))
    shift_i = shift_ref[0, :]
    shift_u = _u32(shift_i)
    order = order_ref[0, :]

    def first(t):
        return (_load_rows(rows_hi_ref, t, UNROLL),
                _load_rows(rows_lo_ref, t, UNROLL))

    def body(t0, rows, P):
        P_hi, P_lo = P
        rows_hi, rows_lo = rows
        for u in range(UNROLL):
            oh, ol = wide33_out(P_hi[0], P_lo[0], rows_hi[u],
                                _u32(rows_lo[u]), shift_u, shift_i,
                                t0 + u < order)
            out_hi_ref[t0 + u, :] = oh
            out_lo_ref[t0 + u, :] = _i32(ol)
            v = [mul64_33(cf[r], oh, ol) for r in range(hist)]
            nxt = [add64(P_hi[r + 1], P_lo[r + 1], *v[r])
                   for r in range(hist - 1)] + [v[hist - 1]]
            P_hi = tuple(h for h, _ in nxt)
            P_lo = tuple(lo for _, lo in nxt)
        return P_hi, P_lo

    zero = jnp.zeros_like(order)
    _time_loop(B, first, body, ((zero,) * hist, (_u32(zero),) * hist))


def _call(kernel, time_major, lane_rows, n_out, *, hist, interpret):
    """Run `kernel` over lane blocks. time_major: [B, S] arrays (rows);
    lane_rows: [r, S] per-lane parameters (cfwd, shift, order). S is
    padded to a multiple of LANES (zero lanes: order 0, no
    coefficients) and the padding sliced off the [B, S] outputs."""
    B, S = time_major[0].shape
    assert B % UNROLL == 0, B
    assert lane_rows[0].shape[0] == hist
    Sp = -(-S // LANES) * LANES
    args = [jnp.pad(a, ((0, 0), (0, Sp - S))) if Sp != S else a
            for a in (*time_major, *lane_rows)]
    tspec = pl.BlockSpec((B, LANES), lambda i: (0, i))
    lspec = [pl.BlockSpec((a.shape[0], LANES), lambda i: (0, i))
             for a in lane_rows]
    outs = pl.pallas_call(
        functools.partial(kernel, hist=hist),
        grid=(Sp // LANES,),
        in_specs=[tspec] * len(time_major) + lspec,
        out_specs=[tspec] * n_out,
        out_shape=[out_struct((B, Sp), jnp.int32, *args)] * n_out,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=1,
                                                 num_stages=1),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(*args)
    return [o[:, :S] if Sp != S else o for o in outs]


def lpc_triton(rows_t, cfwd_t, shift, order, *, hist: int,
               interpret: bool = False):
    """int32 recurrence (the reference's InterType for <= 16-bit
    streams): rows_t [B, S] int32 time-major (warm-ups at t < order,
    residuals after); cfwd_t [hist, S] with row r = c_{r+1}; shift /
    order [1, S]; every order <= hist. Returns the signal [B, S]."""
    return _call(_lpc_kernel, (rows_t,), (cfwd_t, shift, order), 1,
                 hist=hist, interpret=interpret)[0]


def lpc_triton_wide(rows_t, cfwd_t, shift, order, *, hist: int,
                    interpret: bool = False):
    """64-bit-accumulator twin of lpc_triton (17-32 bps streams); the
    kernel form of ops/lpc2w.lpc2w_scan, same arguments."""
    return _call(_lpc_wide_kernel, (rows_t,), (cfwd_t, shift, order), 1,
                 hist=hist, interpret=interpret)[0]


def lpc_triton_wide33(rows_hi_t, rows_lo_t, cfwd_t, shift, order, *,
                      hist: int, interpret: bool = False):
    """33-bit-sample twin (wide pack2 chunks); the kernel form of
    ops/lpc2w.lpc2w33_scan: returns (out_hi, out_lo) int32 [B, S]."""
    oh, ol = _call(_lpc_wide33_kernel, (rows_hi_t, rows_lo_t),
                   (cfwd_t, shift, order), 2, hist=hist,
                   interpret=interpret)
    return oh, ol
