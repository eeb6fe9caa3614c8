"""Device-resident decode: the pack2 fast path.

`decode_to_device()` is the product surface: compressed FLAC bytes on
the host become PCM in device memory, ready for on-device
consumers (feature extraction, training input pipelines, on-device
playback buffers) with no decoded-PCM round trip through host RAM.
This is the decode analog of GPU-resident data loading.

Phases (SURVEY.md §7):
  1. C++ measure-only scan emits ONE packed int32 buffer per chunk
     (zfi_pack2_range: per-group bit windows, packed group metadata,
     plan arrays, patches, class gather lists) — no Python packing,
     no device-side gather;
  2. one H2D transfer + one jitted dispatch per chunk: the Rice
     unpack extracts residuals (ops/rice16.py), the order-bucketed LPC
     recurrence runs per class (ops/lpc_triton.py on the GPU, a
     lax.scan on the CPU; runtime/backend.py picks), fixed orders
     integrate as masked cumsums, then wasted-bits/decorrelation/
     container wrap.

Chunks share one static geometry (a union re-scan unifies the spec
when natural chunk geometries diverge), so the stream compiles once;
the scan parallelizes across anchor-split byte ranges and transfer /
compute overlap across chunks (dispatch is asynchronous).

Bit-exactness: every chunk's PCM equals the reference semantics
(differential tests vs the native engine and the oracle,
tests/test_device_decode.py). MD5 verification requires the decoded
bytes (host), so the device path verifies frame CRC-8/16 on the scan
when `check_crc=True` (stronger than the reference, which never checks
them — zflac.zig:408-410,550-551) and `DeviceDecoded.to_host()`
verifies the stream MD5 like the reference's decode (zflac.zig:267-280).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

import jax
import jax.numpy as jnp

from .. import format as fmt
from ..errors import InconsistentParameters, InvalidChecksum
from ..result import DecodedFLAC, container_dtype


def _sect(buf, off: int, n: int):
    return jax.lax.dynamic_slice_in_dim(buf, off, n)


def _patch_rows_layout(out, pidx, pval):
    """Scatter scan-recorded patch values into the Rice unpack's
    time-major output [(GPB+1)*G2, Ssort] (flat idx = pos * Ssort +
    sorted lane; sentinel = the first dead-row element). Indices are
    in-bounds by construction (pack2_helpers.inc emits them against
    the padded geometry); the min() guard keeps a corrupt buffer
    shift-safe."""
    nrows, Ssort = out.shape
    flat = out.reshape(-1)
    safe = jnp.minimum(pidx, jnp.int32(nrows * Ssort - 1))
    return flat.at[safe].set(
        pval, mode="promise_in_bounds").reshape(nrows, Ssort)


def _reconstruct_pack2_core(buf, *, spec, num_channels: int,
                            container_bits: int, do_decorrelate: bool,
                            backend: str):
    """One packed pack2 chunk -> container-width PCM [Fp, Bp, C].
    Not jitted: traced under reconstruct_pack2's jit or inside a
    shard_map body (parallel/shard.py).

    `spec` is Pack2Chunk.spec_key(): (Fp, Sp, Bp, GPB, W, NGp,
    n_patch_p, C, classes, offsets) — static, so each stream geometry
    compiles once and chunks reuse the executable.

    The buffer is CLASS-SORTED (pack2_helpers.inc): subframes of one
    kernel class occupy a contiguous 128-padded block of the sorted
    slot space, so every class reconstructs from a STATIC lane slice
    (no per-class gathers, no combine scatter) and ONE gather by the
    `inv` permutation restores stream order — per channel plane for
    stereo, fusing the wasted shift / decorrelation / interleave pack
    on the gathered planes.

    The data flow is TIME-MAJOR end to end: the C++ scan emits groups
    p-major, so the Rice unpack yields [(GPB+1)*G2, Ssort] (time on
    rows, sorted subframes on lanes); the warm splice, live mask, fixed
    cumsums, and the LPC reconstruction all consume that layout. The
    one full-data relayout is the stack transpose feeding the
    stream-order row gather.

    `backend` (runtime/backend.py) selects the GPU kernels ("gpu") or
    the plain XLA math ("cpu")."""
    from ..ops.rice16 import unpack16_rows_math
    (Fp, Sp, Bp, GPB, W, NGp, n_patch_p, C, classes, off_items) = spec
    off = dict(off_items)
    Ssort = sum(np_ for _, np_ in classes)

    win = jax.lax.bitcast_convert_type(
        _sect(buf, off["win"], W * NGp).reshape(W, NGp), jnp.uint32)
    meta = _sect(buf, off["meta"], NGp).reshape(1, NGp)
    order = _sect(buf, off["order"], Ssort)
    wasted = _sect(buf, off["wasted"], Sp)
    shift = _sect(buf, off["shift"], Ssort)
    cfwd_t = _sect(buf, off["cfwd"], Ssort * 32).reshape(32, Ssort)
    seeds_t = _sect(buf, off["seeds"], Ssort * 4).reshape(4, Ssort)
    warm_t = _sect(buf, off["warm"], Ssort * 32).reshape(32, Ssort)
    warmlen = _sect(buf, off["warmlen"], Ssort)
    bssub = _sect(buf, off["bssub"], Ssort)
    chcode = _sect(buf, off["chcode"], Fp)
    pidx = _sect(buf, off["pidx"], n_patch_p)
    pval = _sect(buf, off["pval"], n_patch_p)
    inv = _sect(buf, off["inv"], Sp)

    # ---- time-major residual rows from the bitstream windows ----
    out = unpack16_rows_math(win, meta, Ssort=Ssort)

    if "warm_hi" in off:
        # Wide chunk (a 33-bit side channel somewhere): 64-bit pair
        # reconstruction (runtime/wide.py).
        return _reconstruct_pack2_wide33(buf, out, spec=spec,
                                         backend=backend)
    # Patches apply on the unpack output: flat time-major indices whose
    # sentinel is the dead +1 p-row (discarded by the [:Bp] slice), so
    # the scatter is in-bounds by construction — no canvas copies.
    # Patches never target the warm region (all patch positions are
    # >= order), so the warm splice can come after. (Warm-ups do not
    # ride the patch list: ~8 patch rows per subframe would turn the
    # scatter into thousands of one-element updates.)
    out = _patch_rows_layout(out, pidx, pval)
    rows_t = out[:Bp]

    row = jax.lax.broadcasted_iota(jnp.int32, (Bp, Ssort), 0)
    warm_p = jnp.pad(warm_t, ((0, Bp - 32), (0, 0)))
    rows_t = jnp.where(row < warmlen[None, :], warm_p, rows_t)
    rows_t = jnp.where(row < bssub[None, :], rows_t, 0)

    # ---- per-class reconstruction on static lane slices ----
    from .reconstruct import _fixed_integrate_t, lpc_scan_t
    # High-res (container int32, 17-32 bps) needs the reference's
    # 64-bit LPC accumulator (InterType i64, zflac.zig:314-319): route
    # LPC classes through the hi/lo wide kernel. Everything else in the
    # chunk (fixed cumsums, wasted shift, decorrelation) is linear or
    # value-bounded, hence exact in int32 wraparound.
    wide = container_bits == 32
    hist_of = {"lpc8": 8, "lpc16": 16, "lpc32": 32}
    seg_out = []
    base = 0
    for name, np_ in classes:
        sl = slice(base, base + np_)
        base += np_
        rc = rows_t[:, sl]                       # [Bp, np_] time-major
        if name == "const":
            seg_out.append(jnp.broadcast_to(rc[0:1, :], (Bp, np_)))
            continue
        if name == "verbatim":
            seg_out.append(rc)
            continue
        if name == "fixed":
            seg_out.append(
                _fixed_integrate_t(rc, order[sl], seeds_t[:, sl]))
            continue
        hist = hist_of[name]
        if backend == "gpu":
            from ..ops.lpc_triton import lpc_triton, lpc_triton_wide
            lpc = lpc_triton_wide if wide else lpc_triton
        else:
            from ..ops.lpc2w import lpc2w_scan
            lpc = lpc2w_scan if wide else lpc_scan_t
        out_l = lpc(rc, cfwd_t[:hist, sl], shift[sl][None, :],
                    order[sl][None, :], hist=hist)
        seg_out.append(out_l)

    # Time-major stack + one dead zero lane; `inv` (stream -> sorted,
    # sentinel Ssort for padded stream slots) is in bounds by
    # construction. The transpose to [Ssort + 1, Bp] is the graph's
    # ONE full-data relayout, feeding the stream-order row gathers.
    stack_t = jnp.concatenate(
        seg_out + [jnp.zeros((Bp, 1), jnp.int32)], axis=1)
    stack = stack_t.T

    def decorrelate2(c0, c1):
        # Stereo decorrelation (zflac.zig:553-578) on channel planes.
        mode = chcode[:, None]
        mid = (c0 << 1) | (c1 & 1)
        new0 = jnp.where(
            mode == fmt.CH_SIDE_RIGHT, c0 + c1,
            jnp.where(mode == fmt.CH_MID_SIDE, (mid + c1) >> 1, c0))
        new1 = jnp.where(
            mode == fmt.CH_LEFT_SIDE, c0 - c1,
            jnp.where(mode == fmt.CH_MID_SIDE, (mid - c1) >> 1, c1))
        return new0, new1

    def pack2ch(c0, c1):
        # Stereo interleave without a transpose: the [F, C, B] ->
        # [F, B, C] relayout has minor dimension C=2, an interleaving
        # copy. Packing both container-width samples into one int32
        # lane and bitcasting to the narrower dtype appends the C axis
        # in memory order (little-endian low half = channel 0) as a
        # pure elementwise op.
        if container_bits == 16:
            packed = (c0 & 0xFFFF) | (c1 << 16)
            return jax.lax.bitcast_convert_type(packed, jnp.int16)
        packed = ((c0 & 0xFF) | (c1 << 8)).astype(jnp.int16)
        return jax.lax.bitcast_convert_type(packed, jnp.int8)

    cdtype = {8: jnp.int8, 16: jnp.int16, 32: jnp.int32}[container_bits]

    if num_channels == 2 and container_bits in (8, 16):
        # Stereo fast tail: gather each channel PLANE from the stack
        # (subframes are frame-major, channel-minor, so channel c's
        # rows sit at inv[c::2]) and fuse the wasted shift,
        # decorrelation, and interleave pack on the planes — the
        # [Sp, Bp] stream-order canvas is never materialized.
        c0 = stack[inv[0:Sp:2]] << wasted[0:Sp:2][:, None]
        c1 = stack[inv[1:Sp:2]] << wasted[1:Sp:2][:, None]
        if do_decorrelate:
            c0, c1 = decorrelate2(c0, c1)
        return pack2ch(c0, c1)

    signal = stack[inv]

    # Wasted-bits shift (zflac.zig:447,459,495-496,538-539).
    signal = jnp.left_shift(signal, wasted[:, None])

    frames = signal.reshape(Fp, num_channels, Bp)
    if do_decorrelate and num_channels == 2:
        new0, new1 = decorrelate2(frames[:, 0], frames[:, 1])
        frames = jnp.stack([new0, new1], axis=1)

    if num_channels == 2 and container_bits in (8, 16):
        return pack2ch(frames[:, 0], frames[:, 1])
    pcm = frames.transpose(0, 2, 1)
    return pcm.astype(cdtype)


def _reconstruct_pack2_wide33(buf, out, *, spec, backend: str):
    """Wide-chunk reconstruction: every value rides as an (hi: int32,
    lo: uint32-as-int32) pair so 33-bit side-channel samples
    (zflac.zig:314-319's i64 InterType) stay exact through the LPC
    recurrence, fixed cumsums, wasted shift, and mid-side rounding.
    Same class-sorted TIME-MAJOR v3 layout as the int32 path (static
    lane slices, one stack transpose + inv gather). Output:
    [Fp, Bp, 2] int32 (the 32-bit container)."""
    from .wide import (_i32, _u32, decorrelate2_wide,
                       fixed_integrate_wide_t, shl64)
    (Fp, Sp, Bp, GPB, W, NGp, n_patch_p, C, classes, off_items) = spec
    off = dict(off_items)
    Ssort = sum(np_ for _, np_ in classes)

    order = _sect(buf, off["order"], Ssort)
    wasted = _sect(buf, off["wasted"], Sp)
    shift = _sect(buf, off["shift"], Ssort)
    cfwd_t = _sect(buf, off["cfwd"], Ssort * 32).reshape(32, Ssort)
    seeds_lt = _sect(buf, off["seeds"], Ssort * 4).reshape(4, Ssort)
    seeds_ht = _sect(buf, off["seeds_hi"], Ssort * 4).reshape(4, Ssort)
    warm_lt = _sect(buf, off["warm"], Ssort * 32).reshape(32, Ssort)
    warm_ht = _sect(buf, off["warm_hi"], Ssort * 32).reshape(32, Ssort)
    warmlen = _sect(buf, off["warmlen"], Ssort)
    bssub = _sect(buf, off["bssub"], Ssort)
    chcode = _sect(buf, off["chcode"], Fp)
    pidx = _sect(buf, off["pidx"], n_patch_p)
    pval_l = _sect(buf, off["pval"], n_patch_p)
    pval_h = _sect(buf, off["pval_hi"], n_patch_p)
    inv = _sect(buf, off["inv"], Sp)

    out_h = out >> 31  # residuals are int32-exact: hi = sign
    out = _patch_rows_layout(out, pidx, pval_l)
    out_h = _patch_rows_layout(out_h, pidx, pval_h)
    rows_l = out[:Bp]
    rows_h = out_h[:Bp]

    row = jax.lax.broadcasted_iota(jnp.int32, (Bp, Ssort), 0)
    wpad_l = jnp.pad(warm_lt, ((0, Bp - 32), (0, 0)))
    wpad_h = jnp.pad(warm_ht, ((0, Bp - 32), (0, 0)))
    in_warm = row < warmlen[None, :]
    rows_l = jnp.where(in_warm, wpad_l, rows_l)
    rows_h = jnp.where(in_warm, wpad_h, rows_h)
    live = row < bssub[None, :]
    rows_l = jnp.where(live, rows_l, 0)
    rows_h = jnp.where(live, rows_h, 0)

    hist_of = {"lpc8": 8, "lpc16": 16, "lpc32": 32}
    seg_h = []
    seg_l = []
    base = 0
    for name, np_ in classes:
        sl = slice(base, base + np_)
        base += np_
        rc_h, rc_l = rows_h[:, sl], rows_l[:, sl]   # [Bp, np_]
        if name == "const":
            seg_h.append(jnp.broadcast_to(rc_h[0:1, :], (Bp, np_)))
            seg_l.append(jnp.broadcast_to(rc_l[0:1, :], (Bp, np_)))
            continue
        if name == "verbatim":
            seg_h.append(rc_h)
            seg_l.append(rc_l)
            continue
        if name == "fixed":
            oh, ol = fixed_integrate_wide_t(
                rc_h, _u32(rc_l), order[sl],
                seeds_ht[:, sl], _u32(seeds_lt[:, sl]))
            seg_h.append(oh)
            seg_l.append(_i32(ol))
            continue
        hist = hist_of[name]
        args = (rc_h, rc_l, cfwd_t[:hist, sl],
                shift[sl][None, :], order[sl][None, :])
        if backend == "gpu":
            from ..ops.lpc_triton import lpc_triton_wide33
            oh, ol = lpc_triton_wide33(*args, hist=hist)
        else:
            from ..ops.lpc2w import lpc2w33_scan
            oh, ol = lpc2w33_scan(*args, hist=hist)
        seg_h.append(oh)
        seg_l.append(ol)

    zlane = jnp.zeros((Bp, 1), jnp.int32)
    stack_h = jnp.concatenate(seg_h + [zlane], axis=1).T
    stack_l = jnp.concatenate(seg_l + [zlane], axis=1).T

    # 33-bit subframes only exist on decorrelated stereo frames, so
    # C == 2 always holds here; process per channel plane.
    h0, l0 = stack_h[inv[0:Sp:2]], _u32(stack_l[inv[0:Sp:2]])
    h1, l1 = stack_h[inv[1:Sp:2]], _u32(stack_l[inv[1:Sp:2]])
    h0, l0 = shl64(h0, l0, wasted[0:Sp:2][:, None])
    h1, l1 = shl64(h1, l1, wasted[1:Sp:2][:, None])
    new0, new1 = decorrelate2_wide(h0, l0, h1, l1, chcode[:, None])
    return jnp.stack([new0, new1], axis=1).transpose(0, 2, 1)


@functools.partial(
    jax.jit,
    static_argnames=("spec", "num_channels", "container_bits",
                     "do_decorrelate", "backend"))
def reconstruct_pack2(buf, *, spec, num_channels: int,
                      container_bits: int, do_decorrelate: bool,
                      backend: str):
    return _reconstruct_pack2_core(
        buf, spec=spec, num_channels=num_channels,
        container_bits=container_bits, do_decorrelate=do_decorrelate,
        backend=backend)


@dataclass
class DeviceDecoded:
    """Device-resident decode result: per-chunk PCM arrays in device
    memory.

    chunks[i] is [Fp, Bp, C] container-dtype; frame f of chunk i holds
    block_sizes[i][f] valid samples. Values are pre-normalization
    (the MD5 domain); `normalization_shift` applies on export."""
    channels: int
    sample_rate: int
    bits_per_sample: int
    total_samples: int
    chunks: list = field(default_factory=list)
    num_frames: list = field(default_factory=list)
    block_sizes: list = field(default_factory=list)
    md5: bytes = b""
    stats: dict = field(default_factory=dict)

    def block_until_ready(self):
        for c in self.chunks:
            c.block_until_ready()
        return self

    def interleaved_device(self, normalized: bool = True):
        """Assemble the decoded stream as ONE device-resident array
        [total_samples, C] (container dtype) — the consumer surface
        for on-device pipelines (feature extraction, training input):
        no decoded-PCM round trip through host RAM. Constant-blocksize
        streams (every frame but possibly the last full, i.e. the
        overwhelmingly common case) assemble with pure slices/reshapes
        and one device concat; ragged variable-blocking streams gather
        frame rows by a precomputed index (one gather). `normalized`
        applies the container-MSB shift (zflac.zig:287-306; leave
        False for the MD5/pre-normalization domain)."""
        C = self.channels
        parts = []
        for pcm_dev, F, bs in zip(self.chunks, self.num_frames,
                                  self.block_sizes):
            if F == 0:
                continue
            if np.all(bs == bs[0]):
                n = int(bs.sum())
                part = pcm_dev[:F, :bs[0], :].reshape(-1, C)[:n]
                parts.append(part)
            else:
                Bp = pcm_dev.shape[1]
                idx = np.concatenate(
                    [f * Bp + np.arange(b) for f, b in enumerate(bs)])
                parts.append(
                    pcm_dev.reshape(-1, C)[jnp.asarray(idx)])
        if parts:
            out = jnp.concatenate(parts, axis=0)
        else:
            dtype = container_dtype(self.bits_per_sample)
            out = jnp.zeros((0, C), dtype=dtype)
        shift = fmt.normalization_shift(self.bits_per_sample)
        if normalized and shift:
            out = out << shift
        return out

    def to_host(self, verify_md5: bool = True) -> DecodedFLAC:
        """Assemble interleaved host PCM (the reference's output
        contract, including MD5 verification and bit-depth
        normalization — zflac.zig:267-306)."""
        from .decode import verify_stream_md5
        C = self.channels
        dtype = container_dtype(self.bits_per_sample)
        out = np.empty(self.total_samples * C, dtype=dtype)
        at = 0
        for pcm_dev, F, bs in zip(self.chunks, self.num_frames,
                                  self.block_sizes):
            pcm = np.asarray(pcm_dev)[:F]
            if F and np.all(bs == bs[0]):
                part = pcm[:, :bs[0], :].reshape(-1)[:bs.sum() * C]
                out[at:at + len(part)] = part
                at += len(part)
            else:
                for f in range(F):
                    n = bs[f] * C
                    out[at:at + n] = pcm[f, :bs[f], :].reshape(-1)
                    at += n
        out = out[:at]
        if verify_md5 and self.md5:
            if not verify_stream_md5(out, self.bits_per_sample, self.md5):
                raise InvalidChecksum("stream MD5 mismatch")
        shift = fmt.normalization_shift(self.bits_per_sample)
        if shift:
            out = out << shift
        return DecodedFLAC(
            channels=C, sample_rate=self.sample_rate,
            bits_per_sample=self.bits_per_sample, interleaved=out,
            stats=dict(self.stats))


def _bucket_block(b: int) -> int:
    return max(128, -(-b // 128) * 128)


def _scan_pack2_chunks(data: bytes, pos: int, info, chunk_frames: int,
                       Bp: int, check_crc: bool, workers: int = 0):
    """Scan the stream into pack2 chunks, parallelized across
    anchor-split byte ranges (SURVEY.md §7 hard part 5: the serial
    host scan must not become the end-to-end bottleneck). Ranges are
    split at sync-scan anchors (CRC-validated frame starts, the same
    machinery as the native engine and the distributed path) and
    scanned concurrently — the ctypes call releases the GIL, so the
    C++ scans genuinely overlap. The chunk chain is verified (each
    range must start exactly where the previous landed); any anchor
    miss, mid-range decline, or chain break falls back to one serial
    scan, which is the single source of truth for correctness.

    Returns a list of (start_byte, Pack2Chunk), or None (decline)."""
    import os

    from ..index.native_indexer import find_anchor, pack2_range

    def seq(a, stop):
        out = []
        p = a
        force_w = 0
        while p < stop:
            ck = pack2_range(data, p, stop, info, check_crc=check_crc,
                             max_frames=chunk_frames,
                             force_fp=chunk_frames, force_bp=Bp,
                             force_w=force_w)
            if ck is None:
                return None
            if ck.F == 0:
                break
            force_w = ck.W
            out.append((p, ck))
            if ck.landed <= p:
                break
            p = ck.landed
        return out

    auto = workers <= 0
    if auto:
        workers = min(os.cpu_count() or 1, 8)
    span = len(data) - pos
    # Parallelism only pays when several chunk scans fit the span;
    # explicit workers (> 0) force the split path (tests).
    if workers < 2 or (auto and span < (1 << 20)):
        return seq(pos, len(data))
    bounds = [pos + span * k // workers for k in range(workers + 1)]
    anchors = [find_anchor(data, bounds[k], bounds[k + 1], info)
               for k in range(1, workers)]
    starts = sorted({pos} | {a for a in anchors if a >= 0})
    ranges = [(s, starts[i + 1] if i + 1 < len(starts) else len(data))
              for i, s in enumerate(starts)]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers) as ex:
        parts = list(ex.map(lambda r: seq(*r), ranges))
    if any(p is None for p in parts):
        return seq(pos, len(data))
    out = []
    expect = pos
    for (a, stop), part in zip(ranges, parts):
        if a != expect:                 # chain break: serial truth
            return seq(pos, len(data))
        out.extend(part)
        if part:
            expect = part[-1][1].landed
    return out


def decode_to_device(data: bytes, check_crc: bool = False,
                     chunk_frames: int = 0, scan_workers: int = 0):
    """Decode a stream to device-resident PCM (pack2 fast path).

    Returns a DeviceDecoded, or None when the fast path declines
    (exotic/mismatching streams; callers fall back to
    decode(engine="tpu") whose output they can device_put). The host
    scan parallelizes across anchor-split byte ranges
    (_scan_pack2_chunks; scan_workers=0 picks the core count) and
    dispatches are asynchronous, so scan and device compute overlap."""
    from ..bitio import BitReader
    from ..index.native_indexer import native_available, pack2_range
    from ..oracle import parse_metadata

    if not native_available():
        return None
    br = BitReader(data)
    info = parse_metadata(br)
    if info.bits_per_sample > 32:
        return None
    pos = br.pos // 8
    Bp = _bucket_block(max(info.max_block_size, 16))
    if chunk_frames <= 0:
        # Whole-stream single dispatch up to ~64 MiB of padded rows;
        # longer streams pipeline in fixed-size chunks. The frame
        # count comes from a probe scan when STREAMINFO declares no
        # total (previously total=0 degenerated to one dispatch per
        # frame), and nominal block size from the header floor.
        from ..parallel.shard import estimate_total_frames
        total_frames = estimate_total_frames(data, pos, info,
                                             check_crc=check_crc)
        if total_frames is None:
            return None
        chunk_frames = 1
        while chunk_frames < total_frames and \
                chunk_frames * info.channel_count * Bp < (1 << 24):
            chunk_frames *= 2

    from .backend import backend
    be = backend()
    chunks = _scan_pack2_chunks(data, pos, info, chunk_frames, Bp,
                                check_crc, workers=scan_workers)
    if chunks is None or not chunks:
        return None
    cks = [ck for _, ck in chunks]
    # One spec across all chunks (one compiled executable): if any
    # chunk's natural spec diverges, re-scan with the forced union
    # geometry (same parallel machinery via per-chunk ranges).
    spec0 = cks[0].spec_key()
    if any(ck.spec_key() != spec0 for ck in cks[1:]):
        from ..parallel.shard import class_caps
        cnp, pnp, wide_u = class_caps(cks)
        force_w = max(ck.W for ck in cks)
        cks = [pack2_range(data, a, ck.landed, info,
                           check_crc=check_crc, max_frames=chunk_frames,
                           force_fp=chunk_frames, force_bp=Bp,
                           force_w=force_w, force_class_np=cnp,
                           force_patch_np=pnp, force_wide=wide_u)
               for a, ck in chunks]
        if any(ck is None for ck in cks):
            return None

    dd = None
    for ck in cks:
        if dd is None:
            dd = DeviceDecoded(
                channels=ck.C, sample_rate=ck.sample_rate,
                bits_per_sample=ck.bits_per_sample,
                total_samples=0, md5=info.md5,
                stats={"engine": "pack2", "frames": 0})
        elif ck.sample_rate != dd.sample_rate or ck.C != dd.channels:
            raise InconsistentParameters(
                "stream parameters changed mid-stream")
        buf_dev = jax.device_put(ck.device_buf)
        pcm = reconstruct_pack2(
            buf_dev, spec=ck.spec_key(), num_channels=ck.C,
            container_bits=fmt.container_bits(ck.bits_per_sample),
            do_decorrelate=ck.do_decorrelate, backend=be)
        dd.chunks.append(pcm)
        dd.num_frames.append(ck.F)
        dd.block_sizes.append(ck.f_block_size)
        dd.total_samples += int(ck.f_block_size.sum())
        dd.stats["frames"] += ck.F
    if dd is None:
        return None
    dd.stats["chunks"] = len(dd.chunks)
    # Reference stop semantics (zflac.zig:343-350,394-402): decoding
    # stops at the first frame whose START reaches the STREAMINFO
    # total, so whole trailing frames are dropped; a frame that
    # CROSSES the total invalidates the declared total and everything
    # decoded is kept (the reference grows its buffer instead).
    if info.total_samples and dd.total_samples > info.total_samples:
        total, offset, valid = info.total_samples, 0, True
        cut = None  # (chunk_idx, frame_idx) of the first dropped frame
        for ci, bs_arr in enumerate(dd.block_sizes):
            for fi, b in enumerate(bs_arr):
                if valid and offset >= total:
                    cut = (ci, fi)
                    break
                if valid and offset + int(b) > total:
                    valid = False
                offset += int(b)
            if cut is not None:
                break
        if cut is not None:
            ci, fi = cut
            bs = dd.block_sizes[ci].copy()
            bs[fi:] = 0
            dd.block_sizes[ci] = bs
            dd.num_frames[ci] = fi
            del dd.chunks[ci + 1:]
            del dd.num_frames[ci + 1:]
            del dd.block_sizes[ci + 1:]
            dd.stats["frames"] = sum(dd.num_frames)
            dd.stats["chunks"] = len(dd.chunks)
            dd.total_samples = offset
    return dd
