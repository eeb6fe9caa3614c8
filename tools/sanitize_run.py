"""Run the faulty/seek/fuzz surface against the SANITIZED native
engine (-O1 -fsanitize=address,undefined, no recover) — the
checked-arithmetic second CI pass mirroring the reference's debug test
run (/root/reference/.github/workflows/tests.yml runs the suite both
in debug, asserts live, and --release=fast).

ASan-instrumented shared objects can only be dlopen'd when the ASan
runtime is already in the process, so this wrapper re-executes python
with LD_PRELOAD=libasan.so and ZFLAC_TPU_SANITIZE set, then runs:
  * pytest tests/test_faulty.py tests/test_seek_tolerant.py
           tests/test_native.py (typed-error + differential surface)
  * tools/fuzz_native.py (byte-mutation fuzz over all native entries)

Usage: python tools/sanitize_run.py [--fuzz-iters N] [--skip-pytest]
Exit code 0 = everything survived with sanitizers armed.
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _preload() -> str:
    """libasan + libstdc++: the ASan runtime must come first in the
    process, and libstdc++ must already be resident when ASan's
    __cxa_throw interceptor initializes (the engine reports errors as
    C++ exceptions), else the interceptor check-fails on first throw."""
    libs = []
    for name in ("libasan.so", "libstdc++.so"):
        out = subprocess.run(["g++", f"-print-file-name={name}"],
                             capture_output=True, text=True, check=True)
        path = out.stdout.strip()
        if not os.path.isabs(path):
            raise RuntimeError(f"{name} not found")
        libs.append(path)
    return " ".join(libs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fuzz-iters", type=int, default=200)
    ap.add_argument("--skip-pytest", action="store_true")
    ap.add_argument("--sanitize", default="asan,ubsan")
    args = ap.parse_args()

    env = dict(os.environ)
    env["ZFLAC_TPU_SANITIZE"] = args.sanitize
    if "asan" in args.sanitize:
        env["LD_PRELOAD"] = _preload()
        # detect_leaks off: CPython's interned one-time allocations
        # drown the report; the engine's buffers are exercised and
        # freed thousands of times below, so use-after-free / OOB —
        # the classes that matter — stay armed.
        env["ASAN_OPTIONS"] = "detect_leaks=0:abort_on_error=1"
    env["UBSAN_OPTIONS"] = "print_stacktrace=1:halt_on_error=1"
    # The sanitized pass is host-only; keep JAX on the CPU.
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = REPO

    steps = []
    if not args.skip_pytest:
        steps.append([sys.executable, "-m", "pytest",
                      "tests/test_faulty.py", "tests/test_seek_tolerant.py",
                      "tests/test_native.py", "-q", "-p", "no:cacheprovider"])
    steps.append([sys.executable, "tools/fuzz_native.py",
                  "--iters", str(args.fuzz_iters)])

    for cmd in steps:
        print(f"[sanitize_run] {' '.join(cmd)}", flush=True)
        rc = subprocess.run(cmd, cwd=REPO, env=env).returncode
        if rc != 0:
            print(f"[sanitize_run] FAILED rc={rc}", flush=True)
            return rc
    print("[sanitize_run] all green with sanitizers armed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
