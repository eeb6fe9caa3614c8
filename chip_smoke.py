"""Smoke test of the device decode on the GPU.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the sharded decode only

Run from the root of a checkout. One process holds the card(s); the
test streams are encoded from seeds by the in-repo encoder (in worker
processes that stay off JAX) and cached under `.bench_cache/`.

Phases (one GPU):
  1. device: a GPU, the card's name and power limit, the native scan;
  2. main path: the BASELINE.json config-2 stream (2^22 samples per
     channel, 16-bit/44.1 kHz stereo, block 4096) through
     decode_to_device, to_host() with MD5, and interleaved_device(),
     bit-exact against the native engine;
  3. format matrix at 2^20 samples per channel through the same entry
     point, bit-exact against the native engine;
  4. rows path: decode(engine="tpu") on a 16-bit and a 24-bit stream;
  5. kernels at real widths (Bp 4096, 2048 subframes): every GPU
     kernel against its plain XLA reference, exact equality; memory
     analysis of the config-2 graph and peak device memory.

With --four: decode_to_device_sharded of a 24-bit/96 kHz stereo stream
(2^22 samples per channel) over a flat ('dp',) mesh of four GPUs, at
least two rounds per card, bit-exact against the native engine.

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails. The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STREAM_DIR = os.path.join(HERE, ".bench_cache")

# name -> cached_stream arguments (signal, n, channels, bps, rate, seed)
# plus EncoderConfig fields.
CONFIG2 = ("correlated_stereo", 1 << 22, 2, 16, 44100, 7,
           dict(block_size=4096))
MATRIX = {
    "8-bit stereo": ("tone_mix", 1 << 20, 2, 8, 44100, 1,
                     dict(block_size=4096)),
    "16-bit mid-side": ("correlated_stereo", 1 << 20, 2, 16, 44100, 2,
                        dict(block_size=4096, stereo_mode="mid_side")),
    "fixed-only block 1152": ("correlated_stereo", 1 << 20, 2, 16, 44100,
                              3, dict(block_size=1152, max_lpc_order=0)),
    "24-bit/96 kHz stereo": ("tone_mix", 1 << 20, 2, 24, 96000, 4,
                             dict(block_size=4096)),
    "32-bit mid-side": ("correlated_stereo", 1 << 20, 2, 32, 48000, 5,
                        dict(block_size=4096, stereo_mode="mid_side")),
    "8-channel 16-bit": ("tone_mix", 1 << 20, 8, 16, 48000, 6,
                         dict(block_size=4096)),
    "escaped partitions": ("noise", 1 << 20, 2, 16, 44100, 7,
                           dict(block_size=4096, partition_order=2,
                                force_escape=True)),
}
ROWS = ("16-bit mid-side", "24-bit/96 kHz stereo")
SHARDED = ("tone_mix", 1 << 22, 2, 24, 96000, 8, dict(block_size=4096))
SHARDED_CHUNK_FRAMES = 128  # of 1024 frames: >= 2 rounds on 4 GPUs


def log(msg: str) -> None:
    print(msg, flush=True)


def _encode(spec) -> bytes:
    from zflac_tpu.testing import cached_stream
    *args, cfg = spec
    return cached_stream(STREAM_DIR, *args, **cfg)


def build_streams(specs: dict) -> dict:
    """name -> FLAC bytes; missing streams are encoded in parallel by
    worker processes that import the encoder only (no JAX)."""
    with ProcessPoolExecutor(
            max_workers=min(len(specs), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = {name: ex.submit(_encode, spec)
                for name, spec in specs.items()}
        return {name: f.result() for name, f in futs.items()}


def _same(got, want, what: str) -> None:
    got = np.asarray(got).reshape(-1)
    want = np.asarray(want).reshape(-1)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)[:5] if got.shape == want.shape \
            else "shape"
        raise AssertionError(f"{what}: mismatch (first at {bad})")


def phase_device():
    import jax

    devs = jax.devices()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"device: {devs[0].device_kind}, count {len(devs)}, "
        f"jax {jax.__version__}")
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    from zflac_tpu.index.native_indexer import native_available
    if not native_available():
        raise RuntimeError("native indexer did not build")
    log("native indexer: ok")


def _device_roundtrip(name: str, data: bytes, timed: bool = False):
    import zflac_tpu

    ref = zflac_tpu.decode(data, engine="native")
    t0 = time.perf_counter()
    dd = zflac_tpu.decode_to_device(data)
    if dd is None:
        raise AssertionError(f"{name}: decode_to_device declined")
    dd.block_until_ready()
    first = time.perf_counter() - t0
    host = dd.to_host()                      # verifies the stream MD5
    _same(host.interleaved, ref.interleaved, f"{name} to_host")
    _same(dd.interleaved_device(), ref.interleaved,
          f"{name} interleaved_device")
    msg = (f"{name}: {ref.num_samples} samples x {ref.channels} ch, "
           f"{len(data)} B, chunks {dd.stats['chunks']}, first call "
           f"{first:.3f} s")
    if timed:
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            zflac_tpu.decode_to_device(data).block_until_ready()
            times.append(time.perf_counter() - t0)
        msg += (f", warm median {np.median(times) * 1e3:.3f} ms "
                f"(min {min(times) * 1e3:.3f})")
    log(msg + ", MD5 ok, bit-exact vs native")
    return dd


def phase_main(streams):
    _device_roundtrip("config-2", streams["config-2"], timed=True)


def phase_matrix(streams):
    for name in MATRIX:
        _device_roundtrip(name, streams[name])


def phase_rows(streams):
    import zflac_tpu

    for name in ROWS:
        data = streams[name]
        got = zflac_tpu.decode(data, engine="tpu")
        ref = zflac_tpu.decode(data, engine="native")
        _same(got.interleaved, ref.interleaved, f"rows path {name}")
        log(f"rows path {name}: {got.stats['engine']}, MD5 ok, "
            f"bit-exact vs native")


def phase_kernels(streams):
    import jax
    import jax.numpy as jnp

    from zflac_tpu.bitio import BitReader
    from zflac_tpu.index.native_indexer import pack2_range
    from zflac_tpu.oracle import parse_metadata
    from zflac_tpu.ops.lpc2w import lpc2w33_scan, lpc2w_scan
    from zflac_tpu.ops.lpc_triton import (lpc_triton, lpc_triton_wide,
                                          lpc_triton_wide33)
    from zflac_tpu.runtime.device import _bucket_block, reconstruct_pack2
    from zflac_tpu.runtime.reconstruct import lpc_scan_t
    from zflac_tpu.testing import lpc_case

    B, S = 4096, 2048
    cases = [("int32", lpc_triton, lpc_scan_t, False),
             ("wide", lpc_triton_wide, lpc2w_scan, True),
             ("wide33", lpc_triton_wide33, lpc2w33_scan, True)]
    for name, kern, ref, wide in cases:
        for hist in (8, 16, 32):
            rows, *rest = map(jnp.asarray,
                              lpc_case(hist, B, S, hist, wide))
            args = ((rows >> 31, rows) if name == "wide33"
                    else (rows,)) + tuple(rest)
            runs = []
            for fn in (kern, ref):       # warm call, then one timed
                f = jax.jit(lambda *a, fn=fn, h=hist: fn(*a, hist=h))
                jax.block_until_ready(f(*args))
                t0 = time.perf_counter()
                out = jax.block_until_ready(f(*args))
                runs.append((out, (time.perf_counter() - t0) * 1e3))
            (got, t_kernel), (want, t_scan) = runs
            for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                _same(g, w, f"lpc {name} hist {hist}")
            log(f"kernel lpc {name} hist {hist} [{B} x {S}]: exact; "
                f"kernel {t_kernel:.3f} ms, XLA scan {t_scan:.3f} ms")

    data = streams["config-2"]
    br = BitReader(data)
    info = parse_metadata(br)
    Bp = _bucket_block(info.max_block_size)
    ck = pack2_range(data, br.pos // 8, len(data), info, max_frames=1024,
                     force_fp=1024, force_bp=Bp)
    compiled = reconstruct_pack2.lower(
        jax.ShapeDtypeStruct(ck.device_buf.shape, jnp.int32),
        spec=ck.spec_key(), num_channels=ck.C, container_bits=16,
        do_decorrelate=ck.do_decorrelate, backend="gpu").compile()
    log(f"reconstruct_pack2 config-2 memory_analysis: "
        f"{compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def phase_sharded(streams):
    import jax

    import zflac_tpu
    from zflac_tpu import format as fmt
    from zflac_tpu.parallel.shard import (decode_to_device_sharded,
                                          make_mesh, sharded_to_host)
    from zflac_tpu.runtime.decode import verify_stream_md5

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(devs)}")
    data = streams["sharded 24-bit"]
    mesh = make_mesh(devs[:4])
    t0 = time.perf_counter()
    r = decode_to_device_sharded(data, mesh,
                                 chunk_frames=SHARDED_CHUNK_FRAMES)
    if r is None:
        raise AssertionError("decode_to_device_sharded declined")
    pcm, meta = r
    jax.block_until_ready(pcm)
    first = time.perf_counter() - t0
    if meta["rounds"] < 2:
        raise AssertionError(f"{meta['rounds']} round(s), expected >= 2")
    host = sharded_to_host(pcm, meta)
    if not verify_stream_md5(host, meta["bits_per_sample"], meta["md5"]):
        raise AssertionError("sharded stream MD5 mismatch")
    ref = zflac_tpu.decode(data, engine="native").interleaved
    sh = fmt.normalization_shift(meta["bits_per_sample"])
    _same(host, ref >> sh if sh else ref, "sharded 24-bit")
    log(f"sharded 24-bit/96 kHz: {len(ref) // 2} samples x 2 ch over "
        f"{mesh.devices.size} devices, {len(meta['num_frames'])} chunks in "
        f"{meta['rounds']} rounds, first call {first:.3f} s, MD5 ok, "
        f"bit-exact vs native")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded decode over four GPUs")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform} devices",
              file=sys.stderr)
        return 1
    from zflac_tpu.utils.cache import enable_compile_cache
    log(f"compile cache: {enable_compile_cache()}")

    specs = ({"sharded 24-bit": SHARDED} if args.four
             else {"config-2": CONFIG2, **MATRIX})
    t0 = time.perf_counter()
    streams = build_streams(specs)
    log(f"streams ready in {time.perf_counter() - t0:.1f} s")

    phases = [("device", phase_device)]
    if args.four:
        phases.append(("sharded", phase_sharded))
    else:
        phases += [("main path", phase_main), ("format matrix", phase_matrix),
                   ("rows path", phase_rows), ("kernels", phase_kernels)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn() if fn is phase_device else fn(streams)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            log(f"phase {name}: FAILED")
            continue
        log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
