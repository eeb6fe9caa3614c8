"""Multi-process jax.distributed long-stream decode (SURVEY.md §4's
"CPU-simulated multi-host mode"): two REAL processes, each owning one
byte-range shard, exchanging boundary state and PCM through collectives
on the global mesh (Gloo between local CPU processes; ICI/DCN on a
pod). Asserts both processes produce the full stream bit-exactly."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import zflac_tpu
from zflac_tpu.encoder import EncoderConfig, encode
from zflac_tpu.index.native_indexer import native_available
from zflac_tpu.testing import correlated_stereo

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env(n_local_devices: int) -> dict:
    env = dict(os.environ)
    # The workers run on the virtual CPU device pool.
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_local_devices}")
    return env


@pytest.mark.parametrize("n_local", [2])
def test_two_process_longstream(tmp_path, n_local):
    pcm = correlated_stereo(120000, 16, seed=11)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=1024))
    stream = tmp_path / "stream.flac"
    stream.write_bytes(data)

    coordinator = f"127.0.0.1:{_free_port()}"
    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"out{pid}.npy"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "zflac_tpu.parallel.distributed",
             str(stream), str(out), coordinator, str(pid), "2"],
            env=_worker_env(n_local), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        out_bytes, _ = p.communicate(timeout=300)
        logs.append(out_bytes.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log

    ref = zflac_tpu.decode(data).interleaved
    for out, log in zip(outs, logs):
        got = np.load(out)
        np.testing.assert_array_equal(got, ref, err_msg=log)
    # both processes decoded a 2-shard stream
    assert "'shards': 2" in logs[0] and "'processes': 2" in logs[0]


def _run_pack2_distributed(tmp_path, data, nprocs, n_local):
    """Spawn nprocs REAL processes with n_local virtual devices each,
    decode via the pack2-distributed engine, and assert every process
    produces the full stream bit-exactly vs the in-process decode."""
    stream = tmp_path / "stream.flac"
    stream.write_bytes(data)

    coordinator = f"127.0.0.1:{_free_port()}"
    procs, outs = [], []
    for pid in range(nprocs):
        out = tmp_path / f"out{pid}.npy"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "zflac_tpu.parallel.distributed",
             str(stream), str(out), coordinator, str(pid),
             str(nprocs), "pack2"],
            env=_worker_env(n_local), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        out_bytes, _ = p.communicate(timeout=600)
        logs.append(out_bytes.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log

    ref = zflac_tpu.decode(data).interleaved
    for out, log in zip(outs, logs):
        got = np.load(out)
        np.testing.assert_array_equal(got, ref, err_msg=log)
    assert "'engine': 'pack2-distributed'" in logs[0], logs[0]
    assert f"'processes': {nprocs}" in logs[0]
    return logs


@pytest.mark.parametrize("nprocs", [2, 4])
def test_multi_process_pack2(tmp_path, nprocs):
    """The FLAGSHIP pack2 device path across real process boundaries:
    one packed chunk per global device, spec union exchanged between
    processes, shard_map + psum on the global mesh (P=2 and P=4)."""
    pcm = correlated_stereo(60000, 16, seed=12)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=1024))
    _run_pack2_distributed(tmp_path, data, nprocs, 1)


@pytest.mark.parametrize("n_local", [2, 4])
def test_multi_process_pack2_two_level_mesh(tmp_path, n_local):
    """The TWO-LEVEL ('hosts','chips') composition (SURVEY.md §2.3):
    P=2 real processes x L local devices each, so
    make_array_from_process_local_data assembles MULTIPLE local shards
    per process and the psum crosses both mesh levels (r4 verdict gap
    #2: this composition had zero executions)."""
    pcm = correlated_stereo(60000, 16, seed=14)
    data = encode(pcm, 44100, 16, EncoderConfig(block_size=1024))
    logs = _run_pack2_distributed(tmp_path, data, 2, n_local)
    # D = P*L byte-range shards were anchored.
    assert f"'shards': {2 * n_local}" in logs[0], logs[0]


@pytest.mark.parametrize("case", ["24bit", "32bit_mid_side", "8ch"])
def test_multi_process_pack2_formats(tmp_path, case):
    """Distributed format matrix beyond 16-bit stereo (r4 verdict gap
    #3): 24-bit (hi/lo wide LPC), 32-bit mid-side (33-bit side
    channels -> wide pair chunks; the spec-union exchange carries the
    wide flag across processes), and 8-channel surround."""
    from zflac_tpu.testing import tone_mix

    if case == "24bit":
        pcm = tone_mix(40000, 2, 24, seed=15)
        data = encode(pcm, 96000, 24, EncoderConfig(block_size=1024))
    elif case == "32bit_mid_side":
        pcm = correlated_stereo(30000, 32, seed=16)
        data = encode(pcm, 48000, 32,
                      EncoderConfig(block_size=1024,
                                    stereo_mode="mid_side"))
    else:
        pcm = tone_mix(20000, 8, 16, seed=17)
        data = encode(pcm, 48000, 16, EncoderConfig(block_size=1024))
    _run_pack2_distributed(tmp_path, data, 2, 1)
