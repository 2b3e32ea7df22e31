"""The kernel library is built and loaded once per process, whichever
threads ask (the serving front launches kernels from a runner thread per
engine), and the wrappers' launch counts stay exact under threads.  The
compile step is stubbed: there is no nvcc here."""
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops  # noqa: E402

torch.set_num_threads(2)


def test_two_threads_compile_once(tmp_path, monkeypatch):
    calls = []

    def fake_compile(lib):
        calls.append(lib)
        time.sleep(0.2)                 # both threads arrive meanwhile
        lib.write_bytes(b"")
        return "ptxas info: stub"

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_BUILT", None)
    monkeypatch.setattr(build, "_compile", fake_compile)
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.build()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(calls) == 1 and len(got) == 2 and got[0] == got[1]
    assert got[0] == (str(calls[0]), "ptxas info: stub")
    assert build.build() is got[0]      # later calls reuse it


def test_two_threads_load_the_library_once(tmp_path, monkeypatch):
    loads = []

    def fake_load(path):
        loads.append(path)
        time.sleep(0.2)
        return object()

    monkeypatch.setattr(build, "_BUILT", (str(tmp_path / "lib.so"), ""))
    monkeypatch.setattr(build, "_LIBRARY", None)
    monkeypatch.setattr(build, "_load", fake_load)
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.library()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert loads == [str(tmp_path / "lib.so")] and got[0] is got[1]


def test_launch_counts_are_exact_under_threads(monkeypatch):
    # a launch happens on CUDA only; the CPU build of torch cannot ask
    # whether a stream is capturing
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)

    class Wrapper:
        launches = captured = 0
        route_launches = {"a": 0}

    w = Wrapper()

    def launch():
        for _ in range(20000):
            ops._launched(w, "a")

    threads = [threading.Thread(target=launch) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)        # switch threads as often as it can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert w.launches == 160000 and w.route_launches["a"] == 160000
    assert w.captured == 0
