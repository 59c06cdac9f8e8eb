"""The port's lazy library builds under concurrent first callers (the REST
server runs requests in threads): one build a process, and every caller,
waiting or not, gets the finished library."""

import ctypes
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

from aegis_tpu_torch import native
from aegis_tpu_torch.core import pyin_cuda

N_THREADS = 8


def _all_at_once(fn, n=N_THREADS):
    """fn() from n threads released together; returns their results."""
    barrier = threading.Barrier(n)
    got = [None] * n
    errors = []

    def run(i):
        try:
            barrier.wait(timeout=30)
            got[i] = fn()
        except BaseException as e:  # reported below, in the test's thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return got


def test_kernel_library_binds_once_under_concurrent_first_callers(
        monkeypatch):
    calls = {"build": 0, "bind": 0}
    count_lock = threading.Lock()
    bound = object()

    def slow_build():
        with count_lock:
            calls["build"] += 1
        time.sleep(0.2)
        return Path("libaegis_viterbi_fake.so")

    def bind(so_path):
        with count_lock:
            calls["bind"] += 1
        return bound

    monkeypatch.setattr(pyin_cuda, "_LIB", None)
    monkeypatch.setattr(pyin_cuda, "build", slow_build)
    monkeypatch.setattr(pyin_cuda, "_bind", bind)
    got = _all_at_once(pyin_cuda.library)
    assert calls == {"build": 1, "bind": 1}
    assert all(g is bound for g in got)


def test_kernel_build_compiles_once_into_a_temporary_file_of_its_own(
        monkeypatch, tmp_path):
    """Concurrent build() calls of one source run one compile; its
    temporary file names the process and the thread."""
    source = tmp_path / "viterbi.cu"
    source.write_text("// a source\n")
    outputs = []

    def fake_nvcc(cmd, **kw):
        out = Path(cmd[-1])
        outputs.append(out.name)
        time.sleep(0.2)
        out.write_bytes(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info : fake\n", "")

    monkeypatch.setattr(pyin_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(pyin_cuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(pyin_cuda.subprocess, "run", fake_nvcc)
    got = _all_at_once(lambda: pyin_cuda.build(source))
    assert len(outputs) == 1
    assert f".tmp{os.getpid()}." in outputs[0]
    assert len(set(got)) == 1 and got[0].exists()
    assert got[0].with_suffix(".ptxas.txt").read_text().startswith("ptxas")
    assert not list((tmp_path / "build").glob("*.tmp*"))


def test_native_library_is_never_none_while_it_builds(monkeypatch,
                                                      tmp_path):
    """No thread gets None from get_lib() while another one builds: all
    eight get the one library, from one compile."""
    real = native.get_lib()
    assert real is not None, "the native library does not build here"
    compiles = []

    def slow_compile(cmd, **kw):
        compiles.append(cmd[-1])
        time.sleep(0.3)
        with open(real._name, "rb") as src, open(cmd[-1], "wb") as dst:
            dst.write(src.read())
        return subprocess.CompletedProcess(cmd, 0, b"", b"")

    monkeypatch.setenv("AEGIS_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native.subprocess, "run", slow_compile)
    got = _all_at_once(native.get_lib)
    assert len(compiles) == 1
    assert f".tmp{os.getpid()}." in compiles[0]
    assert all(isinstance(g, ctypes.CDLL) for g in got)
    assert all(g is got[0] for g in got)
    assert got[0]._name.startswith(str(tmp_path))
