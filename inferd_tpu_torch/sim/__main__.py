"""Fleet-simulator CLI (port of inferd_tpu/sim/__main__.py).

  python -m inferd_tpu_torch.sim --list
  python -m inferd_tpu_torch.sim run hot_stage_skew --seed 7 [--trace out.log]
  python -m inferd_tpu_torch.sim --check tests/data/sim [--all]
  python -m inferd_tpu_torch.sim regen my_fixtures/churn.json

`--check` replays every fixture under a directory (skipping `"slow": true`
sweeps unless --all) and exits nonzero on any gate or expect failure.
`regen` rewrites the `expect` block of the fixture it is given: point it at
fixtures of your own, never at tests/data/sim/, whose fixtures are the
reference's and hold the port to it. The simulator touches no device, so
it takes no --device.
"""

from __future__ import annotations

import argparse
import json
import sys

import inferd_tpu_torch.sim.scenario as scenariolib
import inferd_tpu_torch.sim.scenarios as cataloglib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m inferd_tpu_torch.sim", description=__doc__)
    ap.add_argument("command", nargs="?", default="",
                    help="run <name|file.json> | regen <fixture.json>")
    ap.add_argument("target", nargs="?", default="",
                    help="scenario name / fixture path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", default="",
                    help="replay committed fixtures under this directory")
    ap.add_argument("--all", action="store_true",
                    help="include slow fixtures (1000-node sweeps) in --check")
    ap.add_argument("--list", action="store_true", help="list catalog scenarios")
    ap.add_argument("--trace", default="",
                    help="write the full event trace to this file (run)")
    args = ap.parse_args(argv)

    if args.list or args.command == "list":
        for name in sorted(cataloglib.CATALOG):
            doc = (cataloglib.CATALOG[name].__doc__ or "").strip().split("\n")[0]
            print(f"{name:18} {doc}")
        return 0

    if args.check:
        ok = scenariolib.check_dir(args.check, include_slow=args.all)
        print("sim check:", "PASS" if ok else "FAIL")
        return 0 if ok else 1

    if args.command == "regen":
        if not args.target:
            ap.error("regen needs a fixture path")
        fx = scenariolib.regen_fixture(args.target)
        print(json.dumps(fx["expect"], indent=1, sort_keys=True))
        return 0

    if args.command == "run":
        if not args.target:
            ap.error("run needs a scenario name or config file")
        if args.target.endswith(".json"):
            with open(args.target) as f:
                obj = json.load(f)
            # accept either a bare scenario config or a fixture file
            cfg = (
                scenariolib.resolve_fixture_cfg(obj)
                if "scenario" in obj else obj
            )
        else:
            cfg = cataloglib.scenario(args.target)
        metrics = scenariolib.run_scenario(
            cfg, seed=args.seed, capture_trace=bool(args.trace)
        )
        trace_lines = metrics.pop("trace_lines", None)
        if args.trace and trace_lines is not None:
            with open(args.trace, "w") as f:
                f.write("\n".join(trace_lines) + "\n")
            print(f"trace: {len(trace_lines)} events -> {args.trace}",
                  file=sys.stderr)
        print(json.dumps(metrics, indent=1, sort_keys=True))
        return 0

    ap.error("nothing to do: use run/regen/--check/--list")
    return 2


if __name__ == "__main__":
    sys.exit(main())
