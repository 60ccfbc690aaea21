"""The port's fleet simulator (inferd_tpu_torch.sim) against the reference's.

The simulator drives the port's control plane (SwarmDHT gossip over the
in-process transport, Balancer, PathFinder's long-lived D*-Lite planner,
AutoScaler, the retry budgets) on a virtual clock. Its traces hash every
decision, so replaying the reference's committed fixtures (tests/data/sim/,
read here, never written) to their pinned `trace.hash`, and equal trace lines
scenario for scenario, hold the port to the reference decision for decision.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from inferd_tpu.obs import canary as jcanary
from inferd_tpu.sim import scenario as jscenario
from inferd_tpu.sim import scenarios as jcatalog
from inferd_tpu_torch.obs import canary as tcanary
from inferd_tpu_torch.sim import __main__ as cli
from inferd_tpu_torch.sim import scenario as tscenario
from inferd_tpu_torch.sim import scenarios as tcatalog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_DATA = os.path.join(REPO, "tests", "data", "sim")
SLOW_FIXTURES = ("cache_affinity_1000.json", "churn_1000.json")
FAST_FIXTURES = tscenario.fixture_paths(SIM_DATA)
# every catalog scenario but the two 1000-node sweeps (those replay under `slow`)
SMALL_SCENARIOS = sorted(n for n in tcatalog.CATALOG if not n.endswith("_1000"))


def _ids(paths):
    return [os.path.basename(p) for p in paths]


def test_fixture_set_and_catalog_match_the_reference():
    assert _ids(FAST_FIXTURES) == _ids(jscenario.fixture_paths(SIM_DATA))
    assert len(FAST_FIXTURES) == 9
    assert sorted(_ids(tscenario.fixture_paths(SIM_DATA, include_slow=True))) == sorted(
        _ids(FAST_FIXTURES) + list(SLOW_FIXTURES))
    assert sorted(tcatalog.CATALOG) == sorted(jcatalog.CATALOG)
    assert len(tcatalog.CATALOG) == 13
    for name in tcatalog.CATALOG:
        assert tcatalog.scenario(name) == jcatalog.scenario(name)
    over = {"duration_s": 9.0, "workload": {"arrival_per_s": 0.5}}
    assert tcatalog.scenario("retry_storm", over) == jcatalog.scenario("retry_storm", over)


# -- (a) the committed fixtures replay to their pinned hashes ------------------------------


@pytest.mark.parametrize("path", FAST_FIXTURES, ids=_ids(FAST_FIXTURES))
def test_committed_fixture_replays_to_its_trace_hash(path):
    with open(path) as f:
        fx = json.load(f)
    assert "trace.hash" in fx["expect"] and fx["gates"]
    ok, failures, metrics = tscenario.check_fixture(path)
    assert ok, failures
    assert metrics["trace"]["hash"] == fx["expect"]["trace.hash"]
    assert metrics["trace"]["events"] == fx["expect"]["trace.events"]


# -- (b) equal trace lines and metrics, scenario for scenario ------------------------------


@pytest.mark.parametrize("name", SMALL_SCENARIOS)
def test_scenario_trace_and_metrics_equal_the_reference(name):
    want = jscenario.run_scenario(jcatalog.scenario(name), seed=3, capture_trace=True)
    got = tscenario.run_scenario(tcatalog.scenario(name), seed=3, capture_trace=True)
    want_lines, got_lines = want.pop("trace_lines"), got.pop("trace_lines")
    assert len(got_lines) == len(want_lines) > 0
    for i, (g, w) in enumerate(zip(got_lines, want_lines)):
        assert g == w, f"first differing trace line {i}"
    # finalize's metrics object key for key, values and key order both
    assert json.dumps(got) == json.dumps(want)


def test_outlier_ticks_trace_equal_the_reference():
    """No catalog scenario turns the outlier tick on: a degraded replica
    under `outlier_check_s` flags and clears through detect_outliers on
    both sides, the same."""
    over = {"outlier_check_s": 3.0, "duration_s": 40.0,
            "events": [{"t": 2.0, "op": "degrade", "node": "s1r001", "factor": 6.0}]}
    want = jscenario.run_scenario(jcatalog.scenario("zonal_failure", over), seed=2,
                                  capture_trace=True)
    got = tscenario.run_scenario(tcatalog.scenario("zonal_failure", over), seed=2,
                                 capture_trace=True)
    got_lines = got.pop("trace_lines")
    assert got_lines == want.pop("trace_lines")
    assert got == want
    assert any("replica.outlier" in ln for ln in got_lines)


@pytest.mark.parametrize("seed", range(8))
def test_detect_outliers_equals_the_reference(seed):
    g = np.random.default_rng(seed)
    stage = {}
    for i in range(int(g.integers(1, 9))):
        rec = {}
        if g.random() < 0.8:
            rec["hop_p99_ms"] = float(g.choice([10.0, 11.0, 12.5, 60.0, 300.0]))
        if g.random() < 0.5:
            rec["svc_p99_ms"] = int(g.integers(1, 90))
        if g.random() < 0.1:
            rec["hop_p99_ms"] = "bad"
        stage[f"n{i}"] = rec
    for kw in ({}, {"k": 2.0}, {"min_peers": 2}, {"fallback_field": ""}):
        assert tcanary.detect_outliers(stage, **kw) == jcanary.detect_outliers(stage, **kw)
    flagged = tcanary.detect_outliers(
        {"a": {"hop_p99_ms": 10.0}, "b": {"hop_p99_ms": 11.0}, "c": {"hop_p99_ms": 90.0}})
    assert list(flagged) == ["c"] and flagged["c"]["field"] == "hop_p99_ms"


# -- (c) determinism -----------------------------------------------------------------------


def test_same_seed_is_byte_identical_and_another_seed_diverges():
    cfg = tcatalog.scenario("retry_storm", {"duration_s": 20.0})
    a = tscenario.run_scenario(cfg, seed=11, capture_trace=True)
    b = tscenario.run_scenario(cfg, seed=11, capture_trace=True)
    assert "\n".join(a.pop("trace_lines")).encode() == "\n".join(b.pop("trace_lines")).encode()
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    c = tscenario.run_scenario(cfg, seed=12)
    assert c["trace"]["hash"] != a["trace"]["hash"]


@pytest.mark.parametrize("name", ["standby_failover", "autoscale_elastic"])
def test_the_simulator_reads_no_wall_clock_and_starts_no_thread_or_socket(monkeypatch, name):
    """Every seam takes the virtual clock: no call reaches the host's clocks,
    and a Thread.start or a socket would raise."""
    def refuse(*a, **kw):
        raise AssertionError("the simulator started a thread or opened a socket")

    monkeypatch.setattr(threading.Thread, "start", refuse)
    monkeypatch.setattr(socket, "socket", refuse)
    clocks = {time.time, time.monotonic, time.perf_counter, time.time_ns,
              time.monotonic_ns, time.perf_counter_ns}
    reads = []

    def watch(frame, event, arg):
        if event == "c_call" and arg in clocks:
            reads.append(f"{frame.f_code.co_filename}:{frame.f_lineno}")

    cfg = tcatalog.scenario(name, {"duration_s": 30.0})
    fleet = tscenario.Fleet(cfg, 5)
    sys.setprofile(watch)
    try:
        metrics = fleet.run()
    finally:
        sys.setprofile(None)
    assert not reads, reads[:5]
    assert metrics["sessions"]["arrived"] > 0 and metrics["net"]["delivered"] > 0
    now = fleet.loop.time
    for r in fleet.replicas.values():
        assert r.dht._clock == now and r.balancer._clock == now and r.dht._sock is None
        assert r.dht._thread is None and r.balancer._thread is None
    for router in fleet.routers:
        assert router.pf._clock == now and router.retry_budget._clock == now
    if name == "autoscale_elastic":
        assert fleet.controller._clock == now and metrics["autoscale"]


def test_the_simulator_imports_no_reference_msgpack_or_jax():
    code = (
        "import sys, inferd_tpu_torch.sim, inferd_tpu_torch.sim.__main__\n"
        "bad = sorted(m for m in sys.modules if m in ('inferd_tpu', 'msgpack', 'jax')\n"
        "             or m.startswith(('inferd_tpu.', 'msgpack.', 'jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]


# -- (d) the command line ------------------------------------------------------------------


def test_cli_list_names_the_catalog(capsys):
    assert cli.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == sorted(tcatalog.CATALOG)


def test_cli_run_prints_the_metrics_and_writes_the_trace(tmp_path, capsys):
    trace = tmp_path / "trace.log"
    assert cli.main(["run", "hysteresis", "--seed", "4", "--trace", str(trace)]) == 0
    out = json.loads(capsys.readouterr().out)
    want = jscenario.run_scenario(jcatalog.scenario("hysteresis"), seed=4, capture_trace=True)
    want_lines = want.pop("trace_lines")
    assert out == json.loads(json.dumps(want))
    assert trace.read_text() == "\n".join(want_lines) + "\n"
    # a fixture file runs its own scenario and overrides
    assert cli.main(["run", os.path.join(SIM_DATA, "drain_wave.json")]) == 0
    assert json.loads(capsys.readouterr().out)["scenario"] == "drain_wave"


def test_cli_check_passes_good_fixtures_and_fails_a_wrong_hash(tmp_path, capsys):
    good = tmp_path / "good"
    good.mkdir()
    for name in ("hysteresis.json", "drain_wave.json", "churn_1000.json"):
        shutil.copy(os.path.join(SIM_DATA, name), good / name)
    assert cli.main(["--check", str(good)]) == 0
    out = capsys.readouterr().out
    assert "PASS hysteresis.json" in out and "PASS drain_wave.json" in out
    assert "churn_1000" not in out and out.rstrip().endswith("sim check: PASS")
    bad = tmp_path / "bad"
    bad.mkdir()
    with open(os.path.join(SIM_DATA, "hysteresis.json")) as f:
        fx = json.load(f)
    fx["expect"]["trace.hash"] = "0" * 32
    (bad / "hysteresis.json").write_text(json.dumps(fx))
    assert cli.main(["--check", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "FAIL hysteresis.json" in out and "trace.hash" in out
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["--check", str(empty)]) == 1


def test_cli_regen_rewrites_only_the_copy_it_is_given(tmp_path, capsys):
    src = os.path.join(SIM_DATA, "standby_failover.json")
    with open(src) as f:
        before = f.read()
    fx = json.loads(before)
    pinned = dict(fx["expect"])
    fx["expect"] = {k: None for k in pinned}
    copy = tmp_path / "standby_failover.json"
    copy.write_text(json.dumps(fx))
    assert cli.main(["regen", str(copy)]) == 0
    assert json.loads(capsys.readouterr().out) == pinned
    regen = json.loads(copy.read_text())
    assert regen["expect"] == pinned and regen["gates"] == fx["gates"]
    with open(src) as f:
        assert f.read() == before


def test_new_fixture_authors_and_replays(tmp_path):
    path = str(tmp_path / "hyst.json")
    fx = tscenario.new_fixture(path, "hysteresis", 2, [["balance.migrations", ">=", 0]])
    assert set(fx["expect"]) == {"trace.hash", "trace.events", "sessions.arrived",
                                 "sessions.ok", "goodput_tokens", "balance.migrations"}
    ok, failures, _ = tscenario.check_fixture(path)
    assert ok, failures
    want = jscenario.run_scenario(jcatalog.scenario("hysteresis"), seed=2)
    assert fx["expect"]["trace.hash"] == want["trace"]["hash"]


def test_gates_and_expect_checks():
    m = {"a": {"b": [1, 2.5]}, "s": "x"}
    assert tscenario.metric_path(m, "a.b.1") == 2.5
    assert tscenario.metric_path(m, "a.c") is None and tscenario.metric_path(m, "a.b.9") is None
    assert tscenario.check_gates(m, [["a.b.0", ">=", 1], ["a.b.1", "<", 3]]) == []
    fails = tscenario.check_gates(m, [["a.b.0", ">", 1], ["s", "==", 1], ["a.b.0", "~", 1]])
    assert len(fails) == 3 and "missing" in fails[1] and "unknown op" in fails[2]
    assert tscenario.check_expect(m, {"a.b.1": 2.5 * (1 + 1e-12)}) == []
    assert tscenario.check_expect(m, {"a.b.1": 2.5 * (1 + 1e-6)}) != []
    assert tscenario.check_expect(m, {"s": "x", "a.b.0": 1}) == []


# -- (e) the 1000-node sweeps --------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW_FIXTURES)
def test_slow_fixture_replays_to_its_trace_hash(name):
    ok, failures, _ = tscenario.check_fixture(os.path.join(SIM_DATA, name))
    assert ok, failures
