"""On-demand traces in the port: utils/profiling.Profiler (torch.profiler)
and a chain node's POST /profile, mirroring the JAX package's
tests/test_faults.py::test_profile_endpoint_writes_trace: the trace name is
confined under the profile directory, a second start and a stop with none
running answer 409, the endpoint answers 403 unless the node was started
with --enable-profiling, and a trace file is written. Also the window form
and host_time_split, which reads a node's trace back into where its host
time went."""

import glob
import http.client
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.tools import run_node
from inferd_tpu_torch.utils import profiling

torch.set_num_threads(2)

PROMPT = [3, 7, 11, 19, 5]


@pytest.fixture(scope="module")
def node(tmp_path_factory):
    """A one-stage (whole-model) CPU node with --enable-profiling."""
    parts = str(tmp_path_factory.mktemp("parts1"))
    prof = str(tmp_path_factory.mktemp("profiles"))
    params = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    jstages.split_and_save(params, jcfg.TINY, jstages.Manifest.even_split("tiny", 1), parts)
    args = run_node.build_parser().parse_args(
        ["--parts", parts, "--stage", "0", "--port", "0", "--gossip-port", "0", "--device", "cpu", "--max-len", "64",
         "--enable-profiling", "--profile-dir", prof])
    n = run_node.make_node(args).start()
    yield n, prof
    n.stop()


def _post(n, path, body):
    conn = http.client.HTTPConnection(n.host, n.port, timeout=60)
    try:
        conn.request("POST", path, body=wire.pack(body) if not isinstance(body, bytes) else body)
        r = conn.getresponse()
        return r.status, wire.unpack(r.read())
    finally:
        conn.close()


def _forward(n, sid, tokens, start):
    status, body = _post(n, "/forward", {"session_id": sid, "stage": 0, "relay": False,
                                         "payload": {"tokens": [tokens], "start_pos": start,
                                                     "real_len": len(tokens)}})
    assert status == 200, body
    return int(np.argmax(np.asarray(body["result"]["logits"])[0]))


def _session(n, sid, steps=3):
    tok = _forward(n, sid, PROMPT, 0)
    for i in range(steps):
        tok = _forward(n, sid, [tok], len(PROMPT) + i)


def test_profile_endpoint_writes_trace(node):
    n, prof = node
    d = os.path.join(prof, "trace")
    status, r = _post(n, "/profile", {"action": "start", "name": "trace"})
    assert status == 200 and r["ok"] and r["dir"] == d
    assert _post(n, "/profile", {"action": "stop"})[0] == 200
    # the endpoint is not a write-anywhere primitive
    for evil in ("../evil", "/tmp/evil"):
        status, r = _post(n, "/profile", {"action": "start", "name": evil})
        assert status == 400 and "escapes profile dir" in r["error"]
    assert _post(n, "/profile", {"action": "start", "name": "trace"})[0] == 200
    status, r = _post(n, "/profile", {"action": "start"})  # double start
    assert status == 409 and "already running" in r["error"]
    _session(n, "p")  # some work to capture
    status, r = _post(n, "/profile", {"action": "stop"})
    assert status == 200 and r["ok"]
    files = glob.glob(os.path.join(d, "**", "*"), recursive=True)
    assert os.path.join(d, profiling.TRACE_FILE) in files
    status, r = _post(n, "/profile", {"action": "stop"})  # stop with none running
    assert status == 409 and "no profile" in r["error"]
    for bad in (b"\x00not-msgpack", {"nope": 1}, {"action": "rewind"},
                {"action": "window", "seconds": "soon"}):
        assert _post(n, "/profile", bad)[0] == 400, bad
    n.enable_profiling = False  # the gate: refused outright
    try:
        status, r = _post(n, "/profile", {"action": "start"})
        assert status == 403 and "profiling disabled" in r["error"]
    finally:
        n.enable_profiling = True


def test_profile_window_traces_requests_and_splits_host_time(node):
    """A window stops itself and writes the trace of the requests inside
    it; host_time_split finds each request, the layers, the wire and the
    results' read in it."""
    n, prof = node
    status, r = _post(n, "/profile", {"action": "window", "seconds": 1.5, "capture_id": "cap"})
    assert status == 200 and r["seconds"] == 1.5 and r["capture_id"] == "cap"
    assert r["dir"] == os.path.join(prof, "cap", f"{n.host}_{n.port}")
    _session(n, "w", steps=2)
    path = os.path.join(r["dir"], profiling.TRACE_FILE)
    deadline = time.monotonic() + 60
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert n.profiler.active_dir is None
    split = profiling.host_time_split(path)
    assert split["requests"] >= 3 and len(split["per_request"]) == split["requests"]
    assert sum(r["compute"] for r in split["per_request"]) >= 3
    for cat in ("http_ms", "wire_ms", "executor_ms", "layers_ms", "results_cpu_ms"):
        assert split[cat] > 0, (cat, split)
    assert 0 < split["layers_python_ms"] <= split["layers_ms"]
    assert split["window_waits_ms"] == 0 and split["device_kernels"] == 0  # no window, no card
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"http.request", "qwen3.layer", "wire.unpack"} <= names
    # a window's seconds are clamped to [0.1, 60]
    status, r = _post(n, "/profile", {"action": "window", "seconds": 1e6})
    assert status == 200 and r["seconds"] == 60.0
    assert _post(n, "/profile", {"action": "stop"})[0] == 200  # an explicit stop wins


def test_profiler_stop_never_wedges(tmp_path, monkeypatch):
    """A stop whose export raises still leaves the profiler free, and the
    spans stop recording."""
    p = profiling.Profiler(base_dir=str(tmp_path))
    d = p.start("a")
    assert profiling._TRACING == 1
    assert isinstance(profiling.span("x"), torch.profiler.record_function)

    def broken(_path):
        raise OSError("disk full")

    monkeypatch.setattr(p._prof, "export_chrome_trace", broken)
    with pytest.raises(OSError):
        p.stop()
    assert p.active_dir is None and profiling._TRACING == 0
    assert not isinstance(profiling.span("x"), torch.profiler.record_function)
    with pytest.raises(RuntimeError, match="no profile"):
        p.stop()
    assert p.start("b") == os.path.join(str(tmp_path), "b") != d
    p.stop()
    with pytest.raises(ValueError, match="escapes"):
        p.start(os.path.join("..", "b"))


def test_device_lock_is_held_for_the_trace(tmp_path):
    import threading

    lock = threading.Lock()
    p = profiling.Profiler(base_dir=str(tmp_path), device_lock=lock)
    p.start("x")
    assert not lock.acquire(blocking=False)
    p.stop()
    assert lock.acquire(blocking=False)
    lock.release()


def test_host_time_split_partitions_nested_labels():
    """Each label's time minus the labels nested in it: the categories
    partition the request; *_python_ms leave out every child event; the
    device's own timeline is not host time."""
    ev = [
        {"ph": "X", "name": "http.request", "ts": 0, "dur": 100, "tid": 1, "cat": "user_annotation"},
        {"ph": "X", "name": "wire.unpack", "ts": 1, "dur": 4, "tid": 1, "cat": "user_annotation"},
        {"ph": "X", "name": "executor.process", "ts": 10, "dur": 80, "tid": 1,
         "cat": "user_annotation"},
        {"ph": "X", "name": "qwen3.layer", "ts": 12, "dur": 30, "tid": 1, "cat": "user_annotation"},
        {"ph": "X", "name": "aten::mm", "ts": 13, "dur": 10, "tid": 1, "cat": "cpu_op"},
        {"ph": "X", "name": "kernel.flash_gqa", "ts": 25, "dur": 12, "tid": 1,
         "cat": "user_annotation"},
        {"ph": "X", "name": "cudaLaunchKernel", "ts": 30, "dur": 5, "tid": 1,
         "cat": "cuda_runtime"},
        {"ph": "X", "name": "results.cpu", "ts": 60, "dur": 20, "tid": 1, "cat": "user_annotation"},
        {"ph": "X", "name": "qwen3.layer", "ts": 12, "dur": 30, "tid": 7, "pid": 0,
         "cat": "gpu_user_annotation"},
        {"ph": "X", "name": "flash_split", "ts": 31, "dur": 3, "tid": 7, "pid": 0, "cat": "kernel"},
    ]
    s = profiling.host_time_split({"traceEvents": ev})
    assert s["requests"] == 1
    assert s["http_ms"] == pytest.approx((100 - 4 - 80) / 1e3)
    assert s["wire_ms"] == pytest.approx(4 / 1e3)
    assert s["executor_ms"] == pytest.approx((80 - 30 - 20) / 1e3)
    assert s["layers_ms"] == pytest.approx((30 - 12) / 1e3)
    assert s["layers_python_ms"] == pytest.approx((30 - 10 - 12) / 1e3)
    assert s["wrappers_ms"] == pytest.approx(12 / 1e3)
    assert s["wrappers_python_ms"] == pytest.approx(7 / 1e3)
    assert s["results_cpu_ms"] == pytest.approx(20 / 1e3)
    total = sum(s[k] for k in ("http_ms", "wire_ms", "executor_ms", "layers_ms", "wrappers_ms",
                               "results_cpu_ms", "window_waits_ms", "lock_waits_ms"))
    assert total == pytest.approx(100 / 1e3)
    assert s["device_kernels"] == 1 and s["device_kernel_ms"] == pytest.approx(3 / 1e3)
    (req,) = s["per_request"]
    assert req["compute"] and req["ms"] == pytest.approx(0.1)
    assert {k: v for k, v in req.items() if k.endswith("_ms")} == {
        k: v for k, v in s.items() if k.endswith("_ms") and not k.startswith("device")}
