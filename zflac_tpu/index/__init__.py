"""Host frame indexer: the serial phase-1 pass that walks the FLAC
bitstream once and emits the dense decode plan (plan.StreamPlan) that the
batched device kernels consume.

Two implementations with identical semantics (differential-tested):
  * native C++ scanner (index/native/) — the production path
  * pure-Python walker (py_indexer.py) — fallback + executable spec
"""

from .py_indexer import build_plan as build_plan_py  # noqa: F401


def build_plan(data: bytes, check_crc: bool = False, prefer_native=True,
               emit_groups: bool = False):
    """Index a stream into a StreamPlan using the fastest available
    implementation. emit_groups records the Rice-group offset table for
    the group-table bit-unpack reference (native indexer only)."""
    if prefer_native:
        try:
            from .native_indexer import build_plan_native, native_available
            if native_available():
                return build_plan_native(data, check_crc=check_crc,
                                         emit_groups=emit_groups)
        except ImportError:
            pass
    return build_plan_py(data, check_crc=check_crc)
