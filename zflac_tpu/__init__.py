"""zflac_tpu — a FLAC (RFC 9639) decode engine with a device-resident
GPU path.

Brand-new JAX/XLA/Pallas framework with the capabilities of the reference
Zig decoder (Senryoku/zflac): `decode(data) -> DecodedFLAC` plus the full
typed error set, scaled from one device to several by sharding frames
across a device mesh.

Architecture (two-phase, SURVEY.md §7):
  1. host frame indexer (C++ native, numpy fallback) walks the serial
     bitstream once and emits a *frame table* (plan arrays);
  2. residual unpack + fixed/LPC reconstruction + stereo decorrelation
     run as vectorized int kernels (XLA + Pallas/Triton) batched across all
     subframes of the stream, sharded over the mesh for long streams.
"""

from . import format  # noqa: F401
from .errors import (  # noqa: F401
    EndOfStream,
    FlacError,
    InconsistentParameters,
    InvalidChecksum,
    InvalidCodedNumber,
    InvalidFrameHeader,
    InvalidMetadataHeader,
    InvalidResidualCodingMethod,
    InvalidSignature,
    InvalidSubframeHeader,
    MissingStreaminfo,
    Unimplemented,
)
from .result import DecodedFLAC  # noqa: F401

__version__ = "0.1.0"


def decode(data, **kwargs):
    """Decode a FLAC stream (bytes or path) to PCM.

    Production path: host indexer + batched XLA/Pallas reconstruction.
    Mirrors the reference's single public entry point
    (/root/reference/src/zflac.zig:217)."""
    from .runtime.decode import decode as _decode
    if not isinstance(data, (bytes, bytearray, memoryview)):
        with open(data, "rb") as f:
            data = f.read()
    return _decode(bytes(data), **kwargs)


def decode_oracle(data, **kwargs):
    """Decode with the pure-Python scalar oracle (slow; testing)."""
    from .oracle import decode as _decode
    if not isinstance(data, (bytes, bytearray, memoryview)):
        with open(data, "rb") as f:
            data = f.read()
    return _decode(bytes(data), **kwargs)


def decode_range(data, start_sample, num_samples, **kwargs):
    """Partial decode of [start_sample, start_sample + num_samples)
    using the frame table as a seek table (runtime/seek.py)."""
    from .runtime.seek import decode_range as _dr
    if not isinstance(data, (bytes, bytearray, memoryview)):
        with open(data, "rb") as f:
            data = f.read()
    return _dr(bytes(data), start_sample, num_samples, **kwargs)


def decode_tolerant(data, **kwargs):
    """Error-recovering decode: resynchronize past corrupt regions via
    sync-scan anchors; gaps become silence at exact sample positions
    (runtime/seek.py)."""
    from .runtime.seek import decode_tolerant as _dt
    if not isinstance(data, (bytes, bytearray, memoryview)):
        with open(data, "rb") as f:
            data = f.read()
    return _dt(bytes(data), **kwargs)


def decode_pipelined(data, **kwargs):
    """Chunked decode overlapping host indexing with device compute
    (runtime/decode.py)."""
    from .runtime.decode import decode_pipelined as _dp
    if not isinstance(data, (bytes, bytearray, memoryview)):
        with open(data, "rb") as f:
            data = f.read()
    return _dp(bytes(data), **kwargs)


def decode_to_device(data, **kwargs):
    """Decode to device-resident PCM (the pack2 fast path: C++
    measure-only scan -> one packed buffer -> one dispatch per chunk;
    runtime/device.py). Returns a DeviceDecoded whose chunks live in
    device memory, or None when the fast path declines (fall back to
    decode(engine="tpu"))."""
    from .runtime.device import decode_to_device as _dd
    if not isinstance(data, (bytes, bytearray, memoryview)):
        with open(data, "rb") as f:
            data = f.read()
    return _dd(bytes(data), **kwargs)


def stream_decode(data, **kwargs):
    """Generator yielding PCM chunks as they decode (playback-style
    consumption; runtime/decode.py)."""
    from .runtime.decode import stream_decode as _sd
    if not isinstance(data, (bytes, bytearray, memoryview)):
        with open(data, "rb") as f:
            data = f.read()
    return _sd(bytes(data), **kwargs)


def probe(data):
    """Parse stream metadata (tags, seek table, pictures) without
    decoding audio (metadata.py)."""
    from .metadata import probe as _probe
    if not isinstance(data, (bytes, bytearray, memoryview)):
        with open(data, "rb") as f:
            data = f.read()
    return _probe(bytes(data))
