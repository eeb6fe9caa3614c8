"""Production decode orchestrator: bytes -> host index -> batched
XLA reconstruction -> assembly -> MD5 -> DecodedFLAC.

Mirrors the reference's public entry point semantics
(zflac.zig:217-310) with the two-phase architecture of SURVEY.md §7.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .. import format as fmt
from ..errors import InvalidChecksum
from ..index import build_plan
from ..plan import StreamPlan
from ..result import DecodedFLAC, container_dtype
from .reconstruct import reconstruct
from ..utils.log import get_logger

_log_stream = get_logger("stream")
_log_frame = get_logger("frame")
_log_kernel = get_logger("kernel")


def _pad_pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _bucket_block(b: int) -> int:
    """Pad the sample axis to a lane-friendly size with few distinct
    buckets (recompile control)."""
    return max(128, -(-b // 128) * 128)


def _run_reconstruct(plan: StreamPlan, async_: bool = False):
    """Pad plan arrays to bucketed static shapes and run the jitted
    reconstruction. Returns host PCM [F, B, C] (container dtype), or
    (device array, F) when async_ (dispatch without blocking)."""
    F = plan.num_frames
    C = plan.channels
    S = plan.num_subframes
    B = plan.max_block
    Bp = _bucket_block(B)
    Fp = _pad_pow2(F)
    Sp = Fp * C

    rows = np.zeros((Sp, Bp), dtype=plan.rows.dtype)
    rows[:S, :B] = plan.rows

    def pad1(a, n, dtype=None):
        out = np.zeros(n, dtype=dtype or a.dtype)
        out[:len(a)] = a
        return out

    kind = pad1(plan.kind, Sp)
    order = pad1(plan.order, Sp)
    wasted = pad1(plan.wasted, Sp)
    shift = pad1(plan.shift, Sp)
    coeffs = np.zeros((Sp, 32), dtype=np.int32)
    coeffs[:S] = plan.coeffs_rev
    seeds = np.zeros((Sp, 4), dtype=plan.fixed_seeds.dtype)
    seeds[:S] = plan.fixed_seeds
    channel_code = pad1(plan.channel_code, Fp)

    # Any int64 use (wide rows or int64 streams) runs under scoped x64;
    # the GPU kernel serves the int32 LPC class (runtime/reconstruct.py).
    import jax

    from .backend import backend
    needs_x64 = rows.dtype == np.int64 or bool(np.any(plan.wide))

    # Gather lists per kernel class, padded to pow2 with OOB sentinels.
    class_idx = {}
    for name, idx in plan.classes().items():
        if len(idx) == 0:
            continue
        n = _pad_pow2(len(idx))
        padded = np.full(n, Sp, dtype=np.int32)  # OOB sentinel
        padded[:len(idx)] = idx
        class_idx[name] = padded

    def run():
        kw = dict(
            num_channels=C,
            container_bits=fmt.container_bits(plan.info.bits_per_sample),
            do_decorrelate=bool(
                np.any(plan.channel_code > fmt.CH_INDEPENDENT_MAX)),
            backend=backend(),
        )
        if not needs_x64:
            # One buffer, one transfer, one dispatch (runtime/pack.py).
            from .pack import Packer
            from .reconstruct import reconstruct_packed
            p = Packer()
            p.add("rows", rows)
            p.add("kind", kind)
            p.add("order", order)
            p.add("wasted", wasted)
            p.add("shift", shift)
            p.add("coeffs", coeffs)
            p.add("seeds", seeds)
            p.add("channel_code", channel_code)
            for name, idx in class_idx.items():
                p.add("ci_" + name, idx)
            buf, spec = p.finish()
            return reconstruct_packed(
                buf, spec=spec,
                class_names=tuple(sorted(class_idx)), **kw)
        return reconstruct(
            rows, kind, order, wasted, shift, coeffs, seeds, class_idx,
            channel_code, **kw)

    if needs_x64:
        with jax.enable_x64(True):
            pcm = run()
    else:
        pcm = run()
    if async_:
        return pcm, F  # device array (dispatch is asynchronous)
    return np.asarray(pcm)[:F]


def _assemble(plan: StreamPlan, pcm: np.ndarray) -> np.ndarray:
    """[F, B, C] frame-major PCM -> interleaved output, honoring
    per-frame block sizes."""
    F = plan.num_frames
    C = plan.channels
    bs = plan.block_size
    total = plan.total_samples
    if F == 0:
        return np.zeros(0, dtype=pcm.dtype if pcm.size else np.int16)
    if np.all(bs == bs[0]):
        flat = pcm[:, :bs[0], :].reshape(-1)
        return flat[:total * C]
    out = np.empty(total * C, dtype=pcm.dtype)
    for f in range(F):
        start = plan.pcm_start[f] * C
        out[start:start + bs[f] * C] = pcm[f, :bs[f], :].reshape(-1)
    return out


def _chunk_bytes_estimate(data: bytes, pos: int, info,
                          chunk_frames: int) -> int:
    """Bytes per pipeline chunk for ~chunk_frames frames. Does not
    trust STREAMINFO total_samples (legal streams may declare 0, which
    previously collapsed the estimate to one giant chunk and killed
    the host/device overlap): unknown totals use the probe-scan frame
    estimate (parallel/shard.estimate_total_frames)."""
    if info.total_samples:
        nominal = max(info.max_block_size, 1)
        total_frames = max(1, -(-info.total_samples // nominal))
    else:
        from ..parallel.shard import estimate_total_frames
        total_frames = estimate_total_frames(data, pos, info) or 1
    return max(1 << 16,
               (len(data) - pos) * chunk_frames // total_frames)


def decode_pipelined(data: bytes, chunk_frames: int = 64,
                     verify_md5: bool = True) -> DecodedFLAC:
    """Pipeline-parallel decode (the PP axis of SURVEY.md §2.3): the
    host indexes chunk i+1 while the accelerator reconstructs chunk i —
    jax dispatch is asynchronous, so each chunk's reconstruction is
    launched without blocking and collected in order afterwards. Chunks
    pad to the same bucketed shapes, so compilation is reused."""
    from ..bitio import BitReader
    from ..index.native_indexer import index_range, native_available
    from ..oracle import parse_metadata

    if not native_available():
        return decode(data, verify_md5=verify_md5, engine="tpu")

    br = BitReader(data)
    info = parse_metadata(br)
    pos = br.pos // 8
    chunk_bytes = _chunk_bytes_estimate(data, pos, info, chunk_frames)

    launched = []  # (plan, device_pcm, F)
    while pos < len(data):
        stop = min(pos + chunk_bytes, len(data))
        plan, landed = index_range(data, pos, stop, info)
        if plan.num_frames == 0:
            break
        dev, F = _run_reconstruct(plan, async_=True)  # non-blocking
        launched.append((plan, dev, F))
        if landed <= pos:
            break
        pos = landed

    if not launched:
        return decode(data, verify_md5=verify_md5, engine="tpu")

    C = launched[0][0].channels
    total = sum(p.total_samples for p, _, _ in launched)
    dtype = container_dtype(info.bits_per_sample)
    out = np.empty(total * C, dtype=dtype)
    at = 0
    for plan, dev, F in launched:
        pcm = np.asarray(dev)[:F]   # blocks; later chunks still running
        part = _assemble(plan, pcm)
        out[at:at + len(part)] = part
        at += len(part)

    if verify_md5:
        if not verify_stream_md5(out, info.bits_per_sample, info.md5):
            raise InvalidChecksum("stream MD5 mismatch")
    shift = fmt.normalization_shift(info.bits_per_sample)
    if shift:
        out = out << shift
    return DecodedFLAC(
        channels=C,
        sample_rate=launched[0][0].sample_rate,
        bits_per_sample=launched[0][0].bits_per_sample,
        interleaved=out,
        stats={"engine": "pipelined", "chunks": len(launched),
               "frames": sum(p.num_frames for p, _, _ in launched)},
    )


def stream_decode(data: bytes, chunk_frames: int = 64):
    """Streaming decode: yields interleaved PCM chunks (normalized
    container samples) as they are produced, overlapping host indexing
    with device compute like decode_pipelined. The playback-style
    consumer API (the reference's example app pumps samples from a
    callback, examples/example.zig)."""
    from ..bitio import BitReader
    from ..index.native_indexer import index_range, native_available
    from ..oracle import parse_metadata

    br = BitReader(data)
    info = parse_metadata(br)
    pos = br.pos // 8
    shift = fmt.normalization_shift(info.bits_per_sample)

    if not native_available():
        r = decode(data, verify_md5=False)
        yield r.interleaved
        return

    chunk_bytes = _chunk_bytes_estimate(data, pos, info, chunk_frames)

    pending = None  # (plan, device array, F)
    while pos < len(data):
        stop = min(pos + chunk_bytes, len(data))
        plan, landed = index_range(data, pos, stop, info)
        if plan.num_frames == 0:
            break
        launched = (plan, *_run_reconstruct(plan, async_=True))
        if pending is not None:
            p, dev, F = pending
            part = _assemble(p, np.asarray(dev)[:F])
            yield part << shift if shift else part
        pending = launched
        if landed <= pos:
            break
        pos = landed
    if pending is not None:
        p, dev, F = pending
        part = _assemble(p, np.asarray(dev)[:F])
        yield part << shift if shift else part


def verify_stream_md5(interleaved: np.ndarray, bps: int,
                      expected: bytes) -> bool:
    """MD5 over the smallest-whole-byte little-endian sample bytes
    (zflac.zig:267-277)."""
    nbytes = fmt.md5_bytes_per_sample(bps)
    if nbytes == 3:
        raw = interleaved.astype("<i4").tobytes()
        raw = b"".join(raw[i:i + 3] for i in range(0, len(raw), 4))
    else:
        raw = interleaved.astype(f"<i{nbytes}", copy=False).tobytes()
    return hashlib.md5(raw).digest() == expected


def _decode_native(data: bytes, check_crc: bool,
                   verify_md5: bool) -> DecodedFLAC:
    """Host-native engine: parallel sync-scan index + threaded C++
    reconstruction. Fastest path when the output destination is host
    RAM (phase 2 is memory-bound; a device round-trip costs more than
    the compute — see bench.py)."""
    from ..index.native_indexer import decode_native_parallel
    arr, meta = decode_native_parallel(data, check_crc=check_crc,
                                       compute_md5=verify_md5)
    si_bps = meta["si_bits_per_sample"]
    _log_stream.debug(
        "decode: %d bytes -> %d frames, engine=native (per-frame trace:"
        " ZFLAC_TPU_LOG reaches the C++ engine too)", len(data),
        meta["frames"])
    if verify_md5:
        # The digest is computed inline by the native decoder,
        # overlapped with the decode itself; fall back to the host hash
        # if it wasn't produced.
        if meta["computed_md5"] is not None:
            if meta["computed_md5"] != meta["md5"]:
                raise InvalidChecksum("stream MD5 mismatch")
        elif not verify_stream_md5(arr, si_bps, meta["md5"]):
            raise InvalidChecksum("stream MD5 mismatch")
    shift = fmt.normalization_shift(si_bps)
    if shift:
        # In place: the array exclusively owns the engine's buffer, and
        # a copying shift would add a full extra pass + allocation.
        if arr.flags.writeable:
            np.left_shift(arr, shift, out=arr)
        else:
            arr = arr << shift
    return DecodedFLAC(
        channels=meta["channels"] or meta.get("si_channels", 1),
        sample_rate=meta["sample_rate"],
        bits_per_sample=meta["bits_per_sample"] or si_bps,
        interleaved=arr,
        stats={"frames": meta["frames"], "engine": "native"},
    )


def decode(data: bytes, check_crc: bool = False, verify_md5: bool = True,
           prefer_native: bool = True, safe_lpc: bool = False,
           engine: str = "auto") -> DecodedFLAC:
    """Decode a stream.

    engine:
      "auto"   fastest correct path for host output: the native engine
               when available, else the XLA/Pallas engine.
      "tpu"    host index + batched XLA/Pallas reconstruction (use for
               device-resident output and sharded/long-stream decode).
      "native" parallel C++ index + threaded C++ reconstruction.
    safe_lpc: route int32-stream LPC subframes through the widened
    int64 accumulator class (hardening beyond the reference's always-i32
    InterType for <=16-bit streams, zflac.zig:314-319) at some cost
    (tpu engine only; the native engine always accumulates in 64-bit).

    Device-RESIDENT decode (compressed bytes -> PCM in device memory, Rice
    extraction on the accelerator) is the pack2 path:
    runtime.device.decode_to_device / parallel.shard for sharded
    meshes. The earlier per-generation knobs (device_unpack / skim)
    were superseded by pack2 on every axis and removed.
    """
    if engine not in ("auto", "tpu", "native"):
        # Unknown strings must not fall through to a default path: a
        # typo'd engine= would silently test the wrong engine.
        raise ValueError(
            f"unknown engine {engine!r}; expected 'auto', 'tpu', or "
            "'native' (the scalar oracle is zflac_tpu.decode_oracle)")
    if engine == "auto":
        from ..index.native_indexer import native_available
        engine = "native" if (native_available() and prefer_native
                              and not safe_lpc) else "tpu"
    if engine == "native":
        return _decode_native(data, check_crc, verify_md5)

    plan = build_plan(data, check_crc=check_crc,
                      prefer_native=prefer_native)
    if safe_lpc and plan.rows.dtype == np.int32:
        plan.wide = (plan.kind == 3)
    dtype = container_dtype(plan.info.bits_per_sample)

    if _log_stream.isEnabledFor(10):
        _log_stream.debug(
            "decode: %d bytes sr=%d ch=%d bps=%d frames=%d subframes=%d",
            len(data), plan.info.sample_rate, plan.info.channel_count,
            plan.info.bits_per_sample, plan.num_frames,
            plan.num_subframes)
    if _log_frame.isEnabledFor(10) and plan.num_frames:
        for f in range(plan.num_frames):
            _log_frame.debug("frame %d @%d bs=%d ch_code=%d", f,
                             plan.frame_byte_offset[f],
                             plan.block_size[f], plan.channel_code[f])

    if plan.num_frames == 0:
        interleaved = np.zeros(0, dtype=dtype)
        path = "empty"
    else:
        from ..utils.profiler import maybe_trace
        with maybe_trace("zflac_tpu.decode"):
            pcm = _run_reconstruct(plan)
            path = "rows"
            interleaved = _assemble(plan, pcm)
        _log_kernel.debug("reconstruct path=%s classes=%s", path,
                          {k: len(v) for k, v in plan.classes().items()
                           if len(v)})

    if verify_md5:
        if not verify_stream_md5(interleaved, plan.info.bits_per_sample,
                                 plan.info.md5):
            raise InvalidChecksum("stream MD5 mismatch")

    # Bit-depth normalization (zflac.zig:287-306); wraps in-container.
    shift = fmt.normalization_shift(plan.info.bits_per_sample)
    if shift:
        interleaved = interleaved << shift

    stats = dict(plan.stats)
    stats["engine"] = "xla"
    stats["path"] = path
    return DecodedFLAC(
        channels=plan.channels or plan.info.channel_count,
        sample_rate=plan.sample_rate or plan.info.sample_rate,
        bits_per_sample=plan.bits_per_sample
        or plan.info.bits_per_sample,
        interleaved=interleaved,
        stats=stats,
    )
