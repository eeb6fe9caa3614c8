"""Wide LPC recurrence: 64-bit accumulator semantics on int32 pairs.

High-res streams (17-32 bps; container int32) need the reference's
64-bit LPC accumulator (InterType i64 for i24/i32 outputs,
zflac.zig:314-319,526-533): the `>> shift` must see the exact 64-bit
dot-product sum, not an int32-wrapped one. The recurrence runs in the
*transposed direct form* (ops/lpc_triton.py): a pipeline P[hist] of
partial predictions, P[r] = prediction for time t+r from samples < t,
carried as a dual-int32 (hi/lo) pair. Three 64-bit operations are
emulated:

  * accumulate  P += out * c   — the 32x16 split product
    c*out = c*(out & 0xFFFF) + (c*(out >> 16) << 16); both partials are
    exact in int32 (|c| < 2^15 coefficients), recombined with a
    carry-propagating hi/lo add;
  * pipeline add — hi/lo add with the carry computed bitwise
    (carry = MSB of (a&b | ((a|b) & ~(a+b))); no unsigned compares);
  * pred = acc >> shift — arithmetic 64-bit shift whose low 32 bits are
    a funnel shift of (hi, lo); the true prediction-plus-residual fits
    int32 (samples are <= 32 significant bits), so only the low word is
    needed.

Every shift amount stays in [0, 31], so the math is defined both in
XLA and in the Triton kernels, which share these helpers.

Exactness domain (matches what the C++ pack2 scan admits): every
subframe's true sample values fit int32 (sub_bps <= 32 — 32-bit
side-channel subframes are declined by the scan), residuals fit int32
(RFC 9639 guarantee; the scan patches the rare overflowing group), and
|coefficients| < 2^15 (4-bit precision field + 1 <= 15 bits signed).
Within that domain every product, the 64-bit accumulator (<= 52 bits),
and the shifted prediction are exact, so outputs are bit-identical to
the reference's i64 recurrence.

`lpc2w_scan` / `lpc2w33_scan` are the plain XLA forms (the CPU path and
the references of the kernels).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _u32(x):
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def _i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _carry(a_u, b_u, s_u):
    """Carry-out of the uint32 add s = a + b, as int32 0/1 (bitwise:
    no unsigned compares)."""
    return _i32(((a_u & b_u) | ((a_u | b_u) & ~s_u)) >> 31)


def add64(a_hi, a_lo, b_hi, b_lo):
    """(a + b) on (hi int32, lo uint32) pairs."""
    lo = a_lo + b_lo
    return a_hi + b_hi + _carry(a_lo, b_lo, lo), lo


def shr64_lo(hi, lo, shift_u):
    """Low word of the arithmetic shift (hi, lo) >> shift, shift in
    [0, 31]: (hi << 1) << (31 - s) == hi << (32 - s), defined at 0."""
    return (lo >> shift_u) | ((_u32(hi) << 1) << (jnp.uint32(31) - shift_u))


def mul64(c, out):
    """c * out as a (hi, lo) pair for int32 `out` and |c| < 2^15."""
    lo16 = out & 0xFFFF             # [0, 65535]
    hi16 = out >> 16                # arithmetic
    p1 = c * lo16                   # exact (<= 2^30)
    p2 = c * hi16                   # exact (<= 2^30)
    p1u = _u32(p1)
    p2lo = _u32(p2) << 16
    vlo = p1u + p2lo
    return (p1 >> 31) + (p2 >> 16) + _carry(p1u, p2lo, vlo), vlo


def mul64_33(c, out_hi, out_lo):
    """c * out for a 33-bit-capable (hi, lo) sample: the product splits
    three ways (lo16, mid16, hi) because out >> 16 no longer fits 16
    bits; |hi| <= 1 for admitted streams, so every partial is exact."""
    lo16 = _i32(out_lo) & 0xFFFF
    mid16 = _i32(out_lo >> jnp.uint32(16))
    p1 = c * lo16
    p2 = c * mid16
    p1u = _u32(p1)
    p2lo = _u32(p2) << 16
    vlo = p1u + p2lo
    vhi = (p1 >> 31) + (p2 >> 16) + _carry(p1u, p2lo, vlo) + c * out_hi
    return vhi, vlo


def wide_out(P_hi0, P_lo0, res, shift_u, warm):
    """One output sample of the wide recurrence from the pipeline head."""
    pred = _i32(shr64_lo(P_hi0, P_lo0, shift_u))
    return jnp.where(warm, res, res + pred)


def wide33_out(P_hi0, P_lo0, res_hi, res_lo, shift_u, shift_i, warm):
    """One (hi, lo) output sample of the 33-bit recurrence."""
    pred_lo = shr64_lo(P_hi0, P_lo0, shift_u)
    pred_hi = P_hi0 >> shift_i            # arithmetic
    sum_hi, sum_lo = add64(res_hi, res_lo, pred_hi, pred_lo)
    return (jnp.where(warm, res_hi, sum_hi),
            jnp.where(warm, res_lo, sum_lo))


def _roll_add(P_hi, P_lo, v_hi, v_lo):
    """Drop the consumed pipeline head and add this sample's
    contribution (array form: P [hist, L])."""
    Phs = jnp.concatenate([P_hi[1:], jnp.zeros_like(P_hi[:1])], axis=0)
    Pls = jnp.concatenate([P_lo[1:], jnp.zeros_like(P_lo[:1])], axis=0)
    return add64(Phs, Pls, v_hi, v_lo)


def lpc2w_scan(rows_t, cfwd_t, shift, order, *, hist: int = 32):
    """lax.scan form of the wide recurrence: rows_t [B, S] int32
    time-major (warm-ups at t < order, residuals after); cfwd_t
    [hist, S] with row r = c_{r+1} (the coefficient of s[t-1-r]);
    shift/order [1, S]. Returns the signal [B, S] int32. No int64."""
    shift_u = _u32(shift)
    # Derived from rows (not fresh constants) so that under shard_map
    # the carry inherits the varying-axis type of the sharded inputs.
    P_hi0 = jnp.tile(rows_t[:1] * 0, (hist, 1))
    P_lo0 = _u32(P_hi0)

    def step(carry, xs):
        P_hi, P_lo = carry
        t, res_row = xs
        out = wide_out(P_hi[0:1], P_lo[0:1], res_row[None, :], shift_u,
                       t < order)
        v_hi, v_lo = mul64(cfwd_t, out)
        return _roll_add(P_hi, P_lo, v_hi, v_lo), out[0]

    ts = jnp.arange(rows_t.shape[0], dtype=jnp.int32)
    _, outs = jax.lax.scan(step, (P_hi0, P_lo0), (ts, rows_t))
    return outs


def lpc2w33_scan(rows_hi_t, rows_lo_t, cfwd_t, shift, order, *,
                 hist: int = 32):
    """lax.scan form of the 33-bit-sample recurrence (wide pack2
    chunks: the side channel of a 32-bit stream exceeds int32, so the
    recurrence carries both words of every sample). Time-major (hi, lo)
    residual rows in, (out_hi, out_lo) int32 [B, S] out."""
    shift_u = _u32(shift)
    P_hi0 = jnp.tile(rows_lo_t[:1] * 0, (hist, 1))
    P_lo0 = _u32(P_hi0)

    def step(carry, xs):
        P_hi, P_lo = carry
        t, rh, rl = xs
        oh, ol = wide33_out(P_hi[0:1], P_lo[0:1], rh[None, :],
                            _u32(rl[None, :]), shift_u, shift, t < order)
        v_hi, v_lo = mul64_33(cfwd_t, oh, ol)
        return _roll_add(P_hi, P_lo, v_hi, v_lo), (oh[0], _i32(ol[0]))

    ts = jnp.arange(rows_lo_t.shape[0], dtype=jnp.int32)
    _, (outs_h, outs_l) = jax.lax.scan(
        step, (P_hi0, P_lo0), (ts, rows_hi_t, rows_lo_t))
    return outs_h, outs_l
