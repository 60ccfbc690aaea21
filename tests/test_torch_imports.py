"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, and no serving-path module needs aiohttp, msgpack, PyYAML,
ml_dtypes or safetensors (a machine with the card need not have them)."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "inferd_tpu_torch")

FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "aiohttp", "msgpack", "yaml", "ml_dtypes",
                   "safetensors")

# Runs in a fresh interpreter: the test process already imported jax (conftest).
_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

ROOTS = %r


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        # exact match on the JAX package: a bare prefix would block inferd_tpu_torch too
        if name == "inferd_tpu" or name.startswith("inferd_tpu."):
            raise ImportError("blocked: " + name)
        if name.split(".")[0] in ROOTS:
            raise ImportError("blocked: " + name)
        return None


sys.meta_path.insert(0, Blocker())
import inferd_tpu_torch

names = ["inferd_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(inferd_tpu_torch.__path__, "inferd_tpu_torch.")
]
for n in names:
    importlib.import_module(n)
leaked = sorted(
    m for m in sys.modules
    if m == "inferd_tpu" or m.startswith("inferd_tpu.") or m.split(".")[0] in ROOTS
)
assert not leaked, leaked
print("\n".join(names))
""" % (FORBIDDEN_ROOTS,)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def test_every_port_module_imports_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    names = set(r.stdout.split())
    want = {
        os.path.splitext(p)[0].replace(os.sep, ".")
        for p in _port_sources() if p.startswith("inferd_tpu_torch")
    }
    want = {n[: -len(".__init__")] if n.endswith(".__init__") else n for n in want}
    assert want <= names, sorted(want - names)
    # the overload plane's stdlib-only copies, named: a client imports them alone
    assert {"inferd_tpu_torch.utils.retry", "inferd_tpu_torch.utils.metrics",
            "inferd_tpu_torch.utils.chaos"} <= names
    # the wire's native codec loader and the deployment tools
    assert {"inferd_tpu_torch.native", "inferd_tpu_torch.tools.seed",
            "inferd_tpu_torch.tools.send"} <= names
    # the chain planner and the routed client
    assert {"inferd_tpu_torch.control.dstar", "inferd_tpu_torch.client.routed_client"} <= names
    # the fleet simulator: no reference sim, no msgpack package
    assert {"inferd_tpu_torch.sim", "inferd_tpu_torch.sim.core", "inferd_tpu_torch.sim.fleet",
            "inferd_tpu_torch.sim.scenario", "inferd_tpu_torch.sim.scenarios",
            "inferd_tpu_torch.sim.__main__"} <= names
    # the elasticity policies
    assert {"inferd_tpu_torch.control.balance", "inferd_tpu_torch.control.autoscale"} <= names


def _imports(tree):
    """(module name, enclosing function name or None) for every import."""
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            f = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            if isinstance(child, ast.Import):
                found.extend((a.name, func) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module and not child.level:
                found.append((child.module, func))
            visit(child, f)

    visit(tree, None)
    return found


@pytest.mark.parametrize("path", _port_sources())
def test_port_source_names_no_forbidden_module(path):
    """Static check, imports inside functions included: nothing of JAX or
    the JAX package anywhere, and none of the forbidden packages (the
    manifest YAML too is read and written by the port's own code)."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    for mod, _func in _imports(tree):
        root = mod.split(".")[0]
        assert not (mod == "inferd_tpu" or mod.startswith("inferd_tpu.")), (path, mod)
        assert root not in FORBIDDEN_ROOTS, (path, mod)
