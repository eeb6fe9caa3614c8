"""Optional jax.profiler tracing for the decode pipeline (the device
analog of the reference's scoped std.log tracing, SURVEY.md §5).

Set ZFLAC_TPU_PROFILE=/some/dir to capture a jax.profiler trace of
every decode()/decode_to_device() call region; view with
tensorboard/xprof. No-op (zero overhead beyond one env check at
import) when unset."""

from __future__ import annotations

import contextlib
import os

_PROFILE_DIR = os.environ.get("ZFLAC_TPU_PROFILE", "")


@contextlib.contextmanager
def maybe_trace(label: str):
    if not _PROFILE_DIR:
        yield
        return
    import jax

    with jax.profiler.trace(_PROFILE_DIR):
        with jax.profiler.TraceAnnotation(label):
            yield
