"""Wall time of each committed simulator fixture, replayed by the port's
simulator (inferd_tpu_torch.sim) and by the reference's (inferd_tpu.sim), on
this host's CPU: one JSON line per fixture and package, then a summary.

    JAX_PLATFORMS=cpu python tests/sim_wall_times.py [--all] [--only port|ref]

Both replay the same fixture to the same trace hash (the line says whether
each passed); the times are host wall clock, one run each, fixtures in turn,
and measure the CPU they ran on. `--all` adds the two slow 1000-node sweeps
(minutes each). Not a test: pytest does not collect it.
"""

import argparse
import json
import os
import platform
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_DATA = os.path.join(REPO, "tests", "data", "sim")


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.lower().startswith("model name"):
                    return ln.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true", help="include the slow 1000-node fixtures")
    ap.add_argument("--only", choices=("port", "ref"), default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from inferd_tpu.sim import scenario as ref
    from inferd_tpu_torch.sim import scenario as port

    pkgs = {"port": port, "ref": ref}
    if args.only:
        pkgs = {args.only: pkgs[args.only]}
    totals = dict.fromkeys(pkgs, 0.0)
    ok_all = True
    for path in port.fixture_paths(SIM_DATA, include_slow=args.all):
        for name, lib in pkgs.items():
            t0 = time.perf_counter()
            ok, failures, metrics = lib.check_fixture(path)
            wall = time.perf_counter() - t0
            totals[name] += wall
            ok_all &= ok
            print(json.dumps({"fixture": os.path.basename(path), "package": name, "ok": ok,
                              "wall_s": round(wall, 3),
                              "hash": metrics.get("trace", {}).get("hash"),
                              "failures": failures}), flush=True)
    print(json.dumps({"total_wall_s": {k: round(v, 3) for k, v in totals.items()},
                      "cpu": cpu_name(),
                      "cores": os.cpu_count(), "python": platform.python_version()}))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
