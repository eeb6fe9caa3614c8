"""Benchmark: end-to-end decode throughput of the host engine against
the measured single-threaded native CPU baseline, plus the
device-resident decode on the GPU.

Protocol (BASELINE.md): the reference publishes no absolute numbers and
its Zig toolchain is unavailable, so the CPU baseline is this repo's own
single-threaded C++ scalar decoder (zfi_decode_cpu — structurally the
reference's decode loop, compiled -O3 -march=native).

The headline `value`/`vs_baseline` is `zflac_tpu.decode(data)` with
engine="auto", which routes host-destined PCM to the multithreaded C++
engine whenever the native library exists (runtime/decode.py), against
the scalar host baseline. `device_*` times
`decode_to_device(data).block_until_ready()` — compressed bytes in host
RAM to PCM resident on the GPU (host scan, upload, device graph) — for
the 16-bit stream and a 24-bit stream. There is no CPU fallback: the
bench fails when JAX finds no GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"engine", ..., "device": {"platform", "kind", "count"}}.
"""

import json
import os
import sys
import time

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")
STREAM_SAMPLES = int(os.environ.get("BENCH_SAMPLES", 1 << 22))
BLOCK_SIZE = 4096
REPS = int(os.environ.get("BENCH_REPS", 9))


def get_stream(bps: int = 16, samples: int = STREAM_SAMPLES) -> bytes:
    """Benchmark stream (BASELINE.json config 2: full subframe mix,
    16-bit/44.1kHz stereo; bps=24 gives the 96 kHz hi-res twin),
    generated once and cached."""
    from zflac_tpu.testing import cached_stream
    if bps == 16:
        return cached_stream(CACHE, "correlated_stereo", samples, 2, 16,
                             44100, 7, block_size=BLOCK_SIZE)
    return cached_stream(CACHE, "tone_mix", samples, 2, bps, 96000, 8,
                         block_size=BLOCK_SIZE)


def best_time(fn, reps=REPS):
    """Best-of-N wall time. The bench host is a shared VM with heavy
    steal-time noise (same-binary runs vary +/-40%); the minimum is the
    stable estimator of machine capability, applied identically to the
    engine and the baseline so the ratio stays fair."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.min(times))


def best_times_aba(fn_a, fn_b, reps=REPS):
    """Best-of-N for two functions in A-B-A blocks: each side's minimum
    comes from consecutive (cache-warm) runs — interleaving every rep
    would make each side evict the other's working set — while the
    split A block straddles B in time so slow drift in host load hits
    both sides."""
    ta, tb = [], []
    first = (reps + 1) // 2
    for phase in ((fn_a, ta, first), (fn_b, tb, reps),
                  (fn_a, ta, reps - first)):
        fn, out, n = phase
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
    return float(np.min(ta)), float(np.min(tb))


def device_ms(data: bytes, reps: int = REPS) -> float:
    """Best-of-N wall ms of decode_to_device(data).block_until_ready()
    after a warm-up call (compile + validate against the native
    engine)."""
    import zflac_tpu

    dd = zflac_tpu.decode_to_device(data)
    if dd is None:
        raise RuntimeError("decode_to_device declined the bench stream")
    ref = zflac_tpu.decode(data, engine="native").interleaved
    if not np.array_equal(dd.to_host().interleaved, ref):
        raise RuntimeError("decode_to_device output differs from native")
    return best_time(
        lambda: zflac_tpu.decode_to_device(data).block_until_ready(),
        reps) * 1e3


def main():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    from zflac_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    data = get_stream()

    import zflac_tpu
    from zflac_tpu.index.native_indexer import (
        decode_cpu_native,
        native_available,
    )

    r = zflac_tpu.decode(data)  # warmup: compile + validate (MD5 on)
    total = r.num_samples * r.channels

    if native_available():
        # Baseline correctness cross-check, then timing. The baseline
        # includes the stream-MD5 verification the reference performs
        # as part of decode (zflac.zig:267-280), like the engine does.
        import hashlib

        def baseline():
            arr, meta = decode_cpu_native(data)
            assert hashlib.md5(arr.tobytes()).digest() == meta["md5"]
            return arr, meta

        base, meta = baseline()
        assert meta["frames"] == r.stats["frames"]
        t_engine, t_cpu = best_times_aba(
            lambda: zflac_tpu.decode(data), baseline)
        engine_msps = total / t_engine / 1e6
        cpu_msps = total / t_cpu / 1e6
        vs = engine_msps / cpu_msps
    else:
        t_engine = best_time(lambda: zflac_tpu.decode(data))
        engine_msps = total / t_engine / 1e6
        t_cpu = 0.0
        vs = 0.0

    dev16 = device_ms(data)
    data24 = get_stream(24, STREAM_SAMPLES // 2)
    dev24 = device_ms(data24)
    total24 = (STREAM_SAMPLES // 2) * 2
    # Absolute wall times ride in the artifact so a reader can separate
    # host drift (both absolutes move, ratio stable) from a real engine
    # regression (engine absolute moves).
    print(json.dumps({
        "metric": "decode_throughput",
        "value": round(engine_msps, 2),
        "unit": "Msamples/s",
        "vs_baseline": round(vs, 3),
        "engine": r.stats.get("engine", "unknown"),
        "engine_wall_ms": round(t_engine * 1e3, 2),
        "baseline_wall_ms": round(t_cpu * 1e3, 2),
        "bench_samples": int(total),
        "device_wall_ms": dev16,
        "device_msps": total / dev16 / 1e3,
        "device_wall_ms_24": dev24,
        "device_msps_24": total24 / dev24 / 1e3,
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
