"""Manifest deployment in the port without PyYAML: the port's YAML subset
(parallel/stages.yaml_load / yaml_dump) reads the repository's example
manifest into the JAX package's Manifest, writes the bytes PyYAML's
safe_dump writes, reads what PyYAML reads for the subset's forms, and
refuses everything else with an error naming the line; `run_node`'s
identity resolution (CLI > environment > manifest > default) gives node1
of examples/cluster.yaml stage 1, layers 10-19."""

import os

import pytest
import yaml

from inferd_tpu.parallel import stages as jstages
from inferd_tpu_torch.parallel import stages
from inferd_tpu_torch.tools import run_node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLUSTER = os.path.join(REPO, "examples", "cluster.yaml")


def _fields(m):
    return (m.model_name, m.num_stages, [tuple(vars(n).values()) for n in m.nodes])


def test_example_manifest_equals_reference():
    ours, theirs = stages.Manifest.from_yaml(CLUSTER), jstages.Manifest.from_yaml(CLUSTER)
    assert _fields(ours) == _fields(theirs)
    ours.validate()
    assert ours.to_yaml() == theirs.to_yaml()
    with open(CLUSTER) as f:
        assert _fields(stages.Manifest.from_yaml(f.read())) == _fields(theirs)
    assert ours.node("node3").stage == 2
    with pytest.raises(KeyError, match="node9"):
        ours.node("node9")


@pytest.mark.parametrize("model, n, replicas", [
    ("tiny", 1, None), ("tiny", 2, [1, 3]), ("qwen3-0.6b", 3, [2, 1, 2]),
    ("qwen3-0.6b", 4, None),
])
def test_to_yaml_bytes_equal_reference(model, n, replicas):
    ours = stages.Manifest.even_split(model, n, replicas)
    theirs = jstages.Manifest.even_split(model, n, replicas)
    assert ours.to_yaml() == theirs.to_yaml()
    assert _fields(stages.Manifest.from_yaml(ours.to_yaml())) == _fields(theirs)


@pytest.mark.parametrize("name", ["yes", "017", "1_000", "null", "-", "a:", "#x", "'q", "x'y",
                                  "---a", "2024-01-01", "0x1F", ".inf", "node-1.a/b", "~"])
def test_names_that_need_quotes_match_safe_dump(name):
    m = stages.Manifest("tiny", 1, [stages.NodeSpec(name, 0, 0, 1)])
    want = yaml.safe_dump({"model_name": "tiny", "stages_count": 1,
                           "nodes": [{"name": name, "stage": 0, "start_layer": 0,
                                      "end_layer": 1}]}, sort_keys=False)
    assert m.to_yaml() == want
    assert stages.Manifest.from_yaml(want).nodes[0].name == name


SUBSET = {
    "indented_sequence": "model_name: tiny\nstages_count: 2\nnodes:\n  - name: a\n"
                         "    stage: 0\n    start_layer: 0\n    end_layer: 0\n"
                         "  - name: b\n    stage: 1\n    start_layer: 1\n    end_layer: 1\n",
    "comments_and_marker": "---\n# a cluster\nmodel_name: tiny  # the preset\n\n"
                           "stages_count: 1\nnodes:\n- name: 'a # not a comment'\n"
                           "  stage: 0 # the first\n  start_layer: 0\n  end_layer: 1\n",
    "quoted": "\"model_name\": \"ti\\\"ny\"\n'stages_count': 1\nnodes:\n"
              "- 'name': 'it''s'\n  stage: +0\n  start_layer: 0\n  end_layer: 1\n",
    "nested_map": "a:\n  b: 1\n  c:\n    d: x\ne: -3\n",
}


@pytest.mark.parametrize("name", sorted(SUBSET))
def test_subset_reads_as_pyyaml_reads(name):
    assert stages.yaml_load(SUBSET[name]) == yaml.safe_load(SUBSET[name])


@pytest.mark.parametrize("text, line", [
    ("nodes: [a, b]\n", 1), ("a: &x 1\nb: *x\n", 1), ("a: 1\nb: *x\n", 2),
    ("a: !!str 1\n", 1), ("a: |\n  text\n", 1), ("a: >\n  text\n", 1),
    ("a:\n\tb: 1\n", 2), ("a: true\n", 1), ("a: 1.5\n", 1), ("a: ~\n", 1), ("a:\n", 1),
    ("a: 1\na: 2\n", 2), ("a: 'open\n", 1), ("- 1\n- 2\n", 1), ("a: {b: 1}\n", 1),
    ("a: 0x10\n", 1), ("a: b: c\n", 1), ("a: 1\n  b: 2\n", 2), ("  a: 1\n", 1),
    ("a: \"\\q\"\n", 1), ("? a\n: b\n", 1),
])
def test_unsupported_constructs_raise_naming_the_line(text, line):
    with pytest.raises(ValueError, match=f"line {line}"):
        stages.yaml_load(text)


def test_to_yaml_refuses_what_it_cannot_write_like_safe_dump():
    for name in ("a b", "ünï", "tab\t"):
        with pytest.raises(ValueError, match="printable ASCII"):
            stages.Manifest("tiny", 1, [stages.NodeSpec(name, 0, 0, 1)]).to_yaml()


def _resolve(argv, monkeypatch, env=None):
    monkeypatch.delenv("INITIAL_STAGE", raising=False)
    monkeypatch.delenv("NODE_NAME", raising=False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    return run_node.resolve_identity(run_node.build_parser().parse_args(argv))


def test_run_node_resolves_node1_of_the_example(monkeypatch):
    ident = _resolve(["--manifest", CLUSTER, "--name", "node1"], monkeypatch)
    assert ident.name == "node1" and ident.stage == 1
    spec = ident.stage_spec()
    assert (spec.stage, spec.num_stages, spec.start_layer, spec.end_layer) == (1, 3, 10, 19)


def test_run_node_identity_precedence(monkeypatch):
    # the name from the environment, the stage from the manifest
    assert _resolve(["--manifest", CLUSTER], monkeypatch, {"NODE_NAME": "node3"}).stage == 2
    # INITIAL_STAGE beats the manifest, --stage beats both
    assert _resolve(["--manifest", CLUSTER, "--name", "node1"], monkeypatch,
                    {"INITIAL_STAGE": "0"}).stage == 0
    assert _resolve(["--manifest", CLUSTER, "--name", "node1", "--stage", "2"], monkeypatch,
                    {"INITIAL_STAGE": "0"}).stage == 2
    # without a manifest: --stage, INITIAL_STAGE, else 0; no name means host:port
    assert _resolve([], monkeypatch) == (None, 0, None)
    assert _resolve([], monkeypatch, {"INITIAL_STAGE": "1"}).stage == 1
    with pytest.raises(ValueError, match="--name"):
        _resolve(["--manifest", CLUSTER], monkeypatch)
    with pytest.raises(KeyError, match="node7"):
        _resolve(["--manifest", CLUSTER, "--name", "node7"], monkeypatch)
    with pytest.raises(ValueError, match="outside"):
        _resolve(["--manifest", CLUSTER, "--name", "node1", "--stage", "3"], monkeypatch)
