"""Scenario running, gating, and committed-fixture checking (port of
inferd_tpu/sim/scenario.py).

A scenario is a plain config dict (sim.fleet.DEFAULTS schema, catalog in
sim.scenarios); running one yields a metrics object plus a blake2b hash
over the full event trace. A FIXTURE is a JSON file binding {scenario,
seed, gates, expect}; the reference's are committed under tests/data/sim/,
and the port replays them to the same trace hash:

  * `gates` are [path, op, value] bounds over the metrics — the scenario's
    acceptance contract (routing quality, convergence, goodput,
    incremental-replan fractions). They hold for ANY conforming change.
  * `expect` pins exact replay values (trace hash/event count, session
    counts) — the determinism contract. Same seed + same scenario + same
    control-plane decisions => byte-identical trace.

`python -m inferd_tpu_torch.sim --check tests/data/sim` replays every
non-slow fixture and enforces both blocks. `regen` rewrites a fixture's
`expect` in place: it is a tool for fixtures of one's own, never for the
reference's committed ones, which the port must match as they stand.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from inferd_tpu_torch.sim.fleet import Fleet

_OPS = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


def run_scenario(
    cfg: Dict[str, Any], seed: int = 0, capture_trace: bool = False
) -> Dict[str, Any]:
    """Run one scenario to completion; returns the metrics object (plus
    `trace_lines` when capture_trace — tests assert byte-identity on it)."""
    fleet = Fleet(cfg, seed)
    fleet.capture_trace = capture_trace
    metrics = fleet.run()
    if capture_trace:
        metrics["trace_lines"] = fleet.trace_lines
    return metrics


def metric_path(metrics: Dict[str, Any], path: str) -> Any:
    """Dotted lookup: "sessions.ok", "planner.replan_frac",
    "fleet.replicas_final.1" (list index), "balance.migrate_dst.2"."""
    cur: Any = metrics
    for part in path.split("."):
        if isinstance(cur, dict):
            if part not in cur:
                return None
            cur = cur[part]
        elif isinstance(cur, (list, tuple)):
            try:
                cur = cur[int(part)]
            except (ValueError, IndexError):
                return None
        else:
            return None
    return cur


def check_gates(
    metrics: Dict[str, Any], gates: Sequence[Sequence[Any]]
) -> List[str]:
    """Failures (empty = pass) for [path, op, value] bound triples. A
    missing metric FAILS its gate — a gate over a signal that stopped
    existing is a regression, not a skip."""
    failures: List[str] = []
    for gate in gates:
        path, op, want = gate[0], gate[1], gate[2]
        if op not in _OPS:
            failures.append(f"{path}: unknown op {op!r}")
            continue
        got = metric_path(metrics, path)
        if not isinstance(got, (int, float)) or isinstance(got, bool):
            failures.append(f"{path} {op} {want}: metric missing (got {got!r})")
            continue
        if not _OPS[op](got, want):
            failures.append(f"{path} {op} {want}: observed {got}")
    return failures


def _values_match(got: Any, want: Any, rel_tol: float = 1e-9) -> bool:
    if isinstance(want, float) or isinstance(got, float):
        if not isinstance(got, (int, float)) or not isinstance(want, (int, float)):
            return False
        return math.isclose(float(got), float(want), rel_tol=rel_tol, abs_tol=1e-12)
    return got == want


def check_expect(
    metrics: Dict[str, Any], expect: Dict[str, Any]
) -> List[str]:
    """Failures for the exact-replay block: {dotted path: value}."""
    failures: List[str] = []
    for path, want in sorted(expect.items()):
        got = metric_path(metrics, path)
        if not _values_match(got, want):
            failures.append(f"{path}: expected {want!r}, observed {got!r}")
    return failures


def load_fixture(path: str) -> Dict[str, Any]:
    with open(path) as f:
        fx = json.load(f)
    if not isinstance(fx, dict) or "scenario" not in fx:
        raise ValueError(f"{path}: fixture needs a 'scenario' key")
    return fx


def resolve_fixture_cfg(fx: Dict[str, Any]) -> Dict[str, Any]:
    """Fixture scenario = catalog name (plus optional overrides) or an
    inline config dict."""
    from inferd_tpu_torch.sim.scenarios import scenario as catalog_scenario

    sc = fx["scenario"]
    if isinstance(sc, str):
        return catalog_scenario(sc, fx.get("overrides") or {})
    if isinstance(sc, dict):
        cfg = dict(sc)
        for k, v in (fx.get("overrides") or {}).items():
            cfg[k] = v
        return cfg
    raise ValueError(f"bad fixture scenario: {sc!r}")


def check_fixture(path: str) -> Tuple[bool, List[str], Dict[str, Any]]:
    """Replay one fixture: (ok, failure messages, fresh metrics)."""
    fx = load_fixture(path)
    cfg = resolve_fixture_cfg(fx)
    metrics = run_scenario(cfg, seed=int(fx.get("seed", 0)))
    failures = check_gates(metrics, fx.get("gates") or [])
    failures += check_expect(metrics, fx.get("expect") or {})
    return not failures, failures, metrics


def fixture_paths(root: str, include_slow: bool = False) -> List[str]:
    """Committed fixture files under `root`, sorted; fixtures flagged
    `"slow": true` (the 1000-node sweeps) only with include_slow."""
    out = []
    for name in sorted(os.listdir(root)):
        if not name.endswith(".json"):
            continue
        full = os.path.join(root, name)
        try:
            fx = load_fixture(full)
        except (ValueError, OSError):
            out.append(full)  # let check_fixture surface the error
            continue
        if fx.get("slow") and not include_slow:
            continue
        out.append(full)
    return out


def check_dir(
    root: str, include_slow: bool = False, verbose: bool = True
) -> bool:
    """The `--check` entry: replay every (non-slow) fixture, print one
    verdict line each, return overall pass. Zero fixtures = fail (an
    empty directory must not read as a green check)."""
    paths = fixture_paths(root, include_slow)
    if not paths:
        print(f"sim check: no fixtures under {root}")
        return False
    ok_all = True
    for path in paths:
        try:
            ok, failures, metrics = check_fixture(path)
        except Exception as e:  # a broken fixture is a failure, not a crash
            ok, failures, metrics = False, [f"error: {e}"], {}
        ok_all &= ok
        if verbose:
            name = os.path.basename(path)
            gp = metrics.get("goodput_ratio")
            summary = (
                f"goodput={gp}" if gp is not None
                else f"events={metrics.get('trace', {}).get('events')}"
            )
            print(f"  {'PASS' if ok else 'FAIL'} {name} ({summary})")
            for msg in failures:
                print(f"       {msg}")
    return ok_all


def regen_fixture(path: str) -> Dict[str, Any]:
    """Re-run a fixture's scenario and rewrite its `expect` block in
    place (gates are authored, never regenerated). Only for fixtures of
    one's own: the reference's committed fixtures are what the port is
    held to."""
    fx = load_fixture(path)
    cfg = resolve_fixture_cfg(fx)
    metrics = run_scenario(cfg, seed=int(fx.get("seed", 0)))
    expect_keys = list(fx.get("expect") or _DEFAULT_EXPECT_KEYS)
    fx["expect"] = {}
    for key in sorted(expect_keys):
        val = metric_path(metrics, key)
        if val is not None:
            fx["expect"][key] = val
    with open(path, "w") as f:
        json.dump(fx, f, indent=1, sort_keys=True)
        f.write("\n")
    return fx


#: expect block for fresh fixtures: the determinism pins (trace identity)
#: plus the headline outcomes a silent behavior change would move.
_DEFAULT_EXPECT_KEYS = (
    "trace.hash",
    "trace.events",
    "sessions.arrived",
    "sessions.ok",
    "goodput_tokens",
    "balance.migrations",
)


def new_fixture(
    path: str,
    scenario_name: str,
    seed: int,
    gates: Sequence[Sequence[Any]],
    overrides: Optional[Dict[str, Any]] = None,
    slow: bool = False,
) -> Dict[str, Any]:
    """Author a fixture file: run the catalog scenario, pin the default
    expect keys, write JSON."""
    fx: Dict[str, Any] = {
        "scenario": scenario_name,
        "seed": int(seed),
        "gates": [list(g) for g in gates],
        "expect": {k: None for k in _DEFAULT_EXPECT_KEYS},
    }
    if overrides:
        fx["overrides"] = overrides
    if slow:
        fx["slow"] = True
    with open(path, "w") as f:
        json.dump(fx, f, indent=1, sort_keys=True)
        f.write("\n")
    return regen_fixture(path)
