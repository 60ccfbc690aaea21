"""Stage partitioning: layer-range manifests and per-stage param subsets
(port of inferd_tpu/parallel/stages.py).

A stage is a slice of the stacked layer params plus embed on the first
stage and final norm (+ embed for a tied head, or lm_head) on the last.
Stage checkpoints use the JAX package's file format (flax msgpack, written
here by parallel/flax_format.py), so one parts directory serves both.

Manifests are YAML, read and written without PyYAML by a parser of the
subset they use (`yaml_load`, `yaml_dump`): block maps, a block sequence of
maps (its dashes at the parent key's indent or deeper), plain,
single-quoted and double-quoted scalars, decimal ints, comments and a
leading `---`. Anything else (flow collections, anchors, aliases, tags,
block scalars, multi-line scalars, tabs, null, bool, float or non-decimal
int values, duplicate keys) raises a ValueError that names the line.
`yaml_dump` writes the bytes of `yaml.safe_dump(..., sort_keys=False)` for
maps, lists of maps, ints and strings of printable ASCII without
whitespace, and raises on other values.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from inferd_tpu_torch.config import ModelConfig, get_config
from inferd_tpu_torch.models import qwen3
from inferd_tpu_torch.parallel import flax_format

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One pipeline stage: a contiguous [start_layer, end_layer] (inclusive)
    slice of the decoder stack."""

    stage: int
    num_stages: int
    start_layer: int
    end_layer: int  # inclusive

    @property
    def is_first(self) -> bool:
        return self.stage == 0

    @property
    def is_last(self) -> bool:
        return self.stage == self.num_stages - 1

    @property
    def num_layers(self) -> int:
        return self.end_layer - self.start_layer + 1


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    name: str
    stage: int
    start_layer: int
    end_layer: int


@dataclasses.dataclass
class Manifest:
    """Cluster topology: model + stage table (replicas of a stage share its
    layer range)."""

    model_name: str
    num_stages: int
    nodes: List[NodeSpec]

    @property
    def config(self) -> ModelConfig:
        return get_config(self.model_name)

    def stage_spec(self, stage: int) -> StageSpec:
        for n in self.nodes:
            if n.stage == stage:
                return StageSpec(stage, self.num_stages, n.start_layer, n.end_layer)
        raise KeyError(f"no node serves stage {stage}")

    def stage_specs(self) -> List[StageSpec]:
        return [self.stage_spec(s) for s in range(self.num_stages)]

    def validate(self, cfg: Optional[ModelConfig] = None) -> None:
        cfg = cfg or self.config
        specs = self.stage_specs()
        if specs[0].start_layer != 0:
            raise ValueError("stage 0 must start at layer 0")
        if specs[-1].end_layer != cfg.num_layers - 1:
            raise ValueError(
                f"last stage must end at layer {cfg.num_layers - 1}, got {specs[-1].end_layer}"
            )
        for a, b in zip(specs, specs[1:]):
            if b.start_layer != a.end_layer + 1:
                raise ValueError(
                    f"stages {a.stage}->{b.stage} not contiguous: "
                    f"{a.end_layer} then {b.start_layer}"
                )
        for n in self.nodes:
            s = self.stage_spec(n.stage)
            if (n.start_layer, n.end_layer) != (s.start_layer, s.end_layer):
                raise ValueError(
                    f"node {n.name} layer range differs from its stage {n.stage} range"
                )

    def node(self, name: str) -> NodeSpec:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(f"no node named {name!r}")

    @staticmethod
    def from_yaml(path_or_text: str) -> "Manifest":
        """A manifest from a YAML file (or YAML text): the subset manifests
        use, read by the port's own parser (`yaml_load`)."""
        if os.path.exists(path_or_text):
            with open(path_or_text) as f:
                data = yaml_load(f.read())
        else:
            data = yaml_load(path_or_text)
        if not isinstance(data, dict) or not isinstance(data.get("nodes"), list):
            raise ValueError("a manifest is a map with a `nodes` sequence")
        try:
            nodes = [
                NodeSpec(
                    name=n["name"], stage=int(n["stage"]),
                    start_layer=int(n["start_layer"]), end_layer=int(n["end_layer"]),
                )
                for n in data["nodes"]
            ]
            return Manifest(
                model_name=data["model_name"], num_stages=int(data["stages_count"]),
                nodes=nodes,
            )
        except (KeyError, TypeError) as e:
            raise ValueError(f"manifest entry without {e}") from None

    def to_yaml(self) -> str:
        """The text `yaml.safe_dump(..., sort_keys=False)` writes for this
        manifest (`yaml_dump`)."""
        return yaml_dump({
            "model_name": self.model_name,
            "stages_count": self.num_stages,
            "nodes": [dataclasses.asdict(n) for n in self.nodes],
        })

    @staticmethod
    def even_split(
        model_name: str, num_stages: int, replicas: Optional[List[int]] = None,
        num_layers: int = 0,
    ) -> "Manifest":
        """Even layer split into num_stages; replicas[s] nodes per stage.
        `num_layers` splits the preset's first layers only (a depth cut)."""
        layers = num_layers or get_config(model_name).num_layers
        replicas = replicas or [1] * num_stages
        per = layers // num_stages
        extra = layers % num_stages
        nodes, start = [], 0
        for s in range(num_stages):
            end = start + per + (1 if s < extra else 0) - 1
            for r in range(replicas[s]):
                name = f"node{s}_{r}" if replicas[s] > 1 else f"node{s}"
                nodes.append(NodeSpec(name, s, start, end))
            start = end + 1
        return Manifest(model_name=model_name, num_stages=num_stages, nodes=nodes)


# -- the manifest YAML subset ------------------------------------------------------

# a plain scalar that YAML 1.1's implicit resolvers (PyYAML's) would read as
# something other than a string: null, bool, int, float, timestamp, merge,
# value, or the `!`/`&`/`*` indicators alone
_NOT_STR = re.compile(r"""^(?:~|null|Null|NULL|
    yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF|
    [-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+|
    [-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+|
    [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?|
    [-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)|
    [0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]|
    [0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[\ \t]+)[0-9][0-9]?:[0-9][0-9]:
    [0-9][0-9](?:\.[0-9]*)?(?:[\ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?|
    <<|=|!|&|\*)$""", re.X)
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_PLAIN_START_REFUSED = "[]{}&*!|>%@`,#"
_DQ_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t"}


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _yaml_error(no: int, what: str) -> ValueError:
    return ValueError(f"manifest YAML line {no}: {what} (outside the manifest subset)")


def _strip_comment(no: int, text: str) -> str:
    """`text` without its comment (a `#` at its start or after whitespace,
    outside quotes) and trailing whitespace."""
    quote = None
    i = 0
    while i < len(text):
        ch = text[i]
        if quote == "'":
            if ch == "'":
                if text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif ch in "'\"" and (i == 0 or text[:i].endswith(": ") or text[:i] == "- "):
            quote = ch  # a quote that opens a key or a value
        elif ch == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i].rstrip()
        i += 1
    if quote is not None:
        raise _yaml_error(no, "a quoted scalar that does not end on its line")
    return text.rstrip()


def _yaml_lines(text: str) -> List[_Line]:
    out = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise _yaml_error(no, "a tab in the indentation")
        text = _strip_comment(no, body)
        if text and not (text == "---" and not out):
            out.append(_Line(no, len(raw) - len(body), text))
    return out


def _scalar(no: int, text: str) -> Any:
    """One scalar: a quoted string, a decimal int, or a plain string."""
    if text[0] == "'":
        if len(text) < 2 or text[-1] != "'" or "'" in text[1:-1].replace("''", ""):
            raise _yaml_error(no, f"a malformed single-quoted scalar {text!r}")
        return text[1:-1].replace("''", "'")
    if text[0] == '"':
        if len(text) < 2 or text[-1] != '"':
            raise _yaml_error(no, f"a malformed double-quoted scalar {text!r}")
        out, i, body = [], 0, text[1:-1]
        while i < len(body):
            ch = body[i]
            if ch == "\\":
                esc = body[i + 1:i + 2]
                if esc not in _DQ_ESCAPES:
                    raise _yaml_error(no, f"the escape \\{esc}")
                out.append(_DQ_ESCAPES[esc])
                i += 2
                continue
            if ch == '"':
                raise _yaml_error(no, f"a malformed double-quoted scalar {text!r}")
            out.append(ch)
            i += 1
        return "".join(out)
    if text[0] in _PLAIN_START_REFUSED or text[:2] in ("- ", "? ") or text in ("-", "?"):
        raise _yaml_error(no, f"the value {text!r}")
    if ": " in text or text.endswith(":") or " #" in text:
        raise _yaml_error(no, f"the value {text!r}")
    if _DECIMAL.match(text):
        return int(text.replace("_", ""))
    if _NOT_STR.match(text):
        raise _yaml_error(no, f"the scalar {text!r}, which YAML reads as no string or int")
    return text


def _split_key(line: _Line) -> Tuple[Any, str]:
    """(key, the value text after it, maybe empty) of a `key: value` line."""
    text = line.text
    if text[0] in "'\"":
        close = text.index(text[0], 1) if text[0] in text[1:] else -1
        if close < 0 or text[close + 1:close + 2] != ":":
            raise _yaml_error(line.no, "a key that is not followed by ':'")
        key = _scalar(line.no, text[:close + 1])
        rest = text[close + 2:]
    else:
        at = text.find(": ")
        if at < 0 and text.endswith(":"):
            at = len(text) - 1
        if at <= 0:
            raise _yaml_error(line.no, f"{text!r} is no `key: value`")
        key = _scalar(line.no, text[:at])
        rest = text[at + 1:]
    if rest and not rest.startswith(" "):
        raise _yaml_error(line.no, "no space after the key's ':'")
    return key, rest.strip()


def _block(lines: List[_Line], i: int, indent: int) -> Tuple[Any, int]:
    """The block node whose lines start at lines[i], at `indent`."""
    if lines[i].text == "-" or lines[i].text.startswith("- "):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _mapping(lines: List[_Line], i: int, indent: int) -> Tuple[Dict[Any, Any], int]:
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i].indent == indent:
        line = lines[i]
        if line.text == "-" or line.text.startswith("- "):
            raise _yaml_error(line.no, "a sequence entry inside a map")
        key, rest = _split_key(line)
        if key in out:
            raise _yaml_error(line.no, f"the duplicate key {key!r}")
        i += 1
        if rest:
            out[key] = _scalar(line.no, rest)
            continue
        nested = i < len(lines) and (lines[i].indent > indent or (
            lines[i].indent == indent and lines[i].text.startswith("- ")))
        if not nested:
            raise _yaml_error(line.no, f"the key {key!r} without a value")
        out[key], i = _block(lines, i, lines[i].indent)
    if i < len(lines) and lines[i].indent > indent:
        raise _yaml_error(lines[i].no, "an indentation that matches no block")
    return out, i


def _sequence(lines: List[_Line], i: int, indent: int) -> Tuple[List[Any], int]:
    out: List[Any] = []
    while i < len(lines) and lines[i].indent == indent and (
            lines[i].text == "-" or lines[i].text.startswith("- ")):
        line = lines[i]
        body = line.text[1:].lstrip(" ")
        if not body:
            raise _yaml_error(line.no, "an empty sequence entry")
        if ": " not in body and not body.endswith(":"):
            raise _yaml_error(line.no, "a sequence entry that is not a map")
        # the entry's map starts on the dash's line, at its first key's column
        col = indent + len(line.text) - len(body)
        lines[i] = _Line(line.no, col, body)
        item, i = _mapping(lines, i, col)
        out.append(item)
    return out, i


def yaml_load(text: str) -> Any:
    """Read a manifest's YAML (the subset in the module docstring)."""
    lines = _yaml_lines(text)
    if not lines:
        raise ValueError("manifest YAML is empty")
    if lines[0].indent != 0:
        raise _yaml_error(lines[0].no, "an indented first line")
    value, i = _block(lines, 0, 0)
    if i < len(lines):
        raise _yaml_error(lines[i].no, "a line outside the document's block")
    return value


def _dump_scalar(value: Any) -> str:
    if type(value) is int:
        return str(value)
    if not isinstance(value, str):
        raise ValueError(f"yaml_dump writes ints and strings, not {type(value).__name__}")
    if not value or any(not "\x21" <= ch <= "\x7e" for ch in value):
        if not value:
            return "''"
        raise ValueError(f"yaml_dump writes strings of printable ASCII without "
                         f"whitespace, not {value!r}")
    # PyYAML's plain-scalar analysis for a block value without whitespace
    plain = not (value.startswith(("---", "...")) or value[0] in "#,[]{}&*!|>'\"%@`"
                 or value in ("?", "-") or value.endswith(":") or _NOT_STR.match(value))
    return value if plain else "'" + value.replace("'", "''") + "'"


def yaml_dump(data: Dict[str, Any]) -> str:
    """`yaml.safe_dump(data, sort_keys=False)` for a map of ints, strings
    and lists of such maps."""
    out: List[str] = []

    def mapping(d: Dict[str, Any], indent: str, first: Optional[str] = None) -> None:
        for j, (k, v) in enumerate(d.items()):
            lead = first if (j == 0 and first is not None) else indent
            key = _dump_scalar(k)
            if isinstance(v, list):
                if not v or not all(isinstance(x, dict) and x for x in v):
                    raise ValueError(f"yaml_dump writes non-empty lists of maps, not {v!r}")
                out.append(f"{lead}{key}:")
                for item in v:
                    mapping(item, indent + "  ", first=indent + "- ")
            elif isinstance(v, dict):
                raise ValueError("yaml_dump writes a map's maps only inside a list")
            else:
                out.append(f"{lead}{key}: {_dump_scalar(v)}")

    mapping(data, "")
    return "\n".join(out) + "\n"


def extract_stage_params(full: Params, cfg: ModelConfig, spec: StageSpec) -> Params:
    """The param subset a stage needs: its layer slice, plus embed on the
    first stage and final norm + head on the last (a tied head needs embed)."""
    out: Params = {
        "layers": qwen3.slice_layers(full["layers"], spec.start_layer, spec.end_layer + 1)
    }
    if spec.is_first:
        out["embed"] = full["embed"]
    if spec.is_last:
        out["final_norm"] = full["final_norm"]
        if cfg.tie_word_embeddings:
            out["embed"] = full["embed"]
        else:
            out["lm_head"] = full["lm_head"]
    return out


def _stage_tree(stage_params: Params, spec: StageSpec, model_name: str) -> Dict[str, Any]:
    meta = {
        "model_name": model_name,
        "stage": spec.stage,
        "num_stages": spec.num_stages,
        "start_layer": spec.start_layer,
        "end_layer": spec.end_layer,
    }
    return {"meta_json": json.dumps(meta), "params": stage_params}


def stage_checkpoint_pieces(stage_params: Params, spec: StageSpec, model_name: str) -> List[Any]:
    """One stage's params + metadata in the flax msgpack format, as the
    buffers save_stage_checkpoint writes one after another
    (flax_format.pieces)."""
    return flax_format.pieces(_stage_tree(stage_params, spec, model_name))


def save_stage_checkpoint(
    path: str, stage_params: Params, spec: StageSpec, model_name: str
) -> None:
    """Write one stage's params + metadata in the flax msgpack format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.writelines(stage_checkpoint_pieces(stage_params, spec, model_name))
    os.replace(tmp, path)


def load_stage_checkpoint(path: str, device=None) -> Tuple[Params, StageSpec, str]:
    """-> (stage params as torch tensors on `device`, spec, model name)."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    blob = flax_format.loads(data, device=device)
    meta = json.loads(blob["meta_json"])
    spec = StageSpec(
        stage=int(meta["stage"]),
        num_stages=int(meta["num_stages"]),
        start_layer=int(meta["start_layer"]),
        end_layer=int(meta["end_layer"]),
    )
    return blob["params"], spec, meta["model_name"]


def stage_checkpoint_path(parts_dir: str, stage: int) -> str:
    return os.path.join(parts_dir, f"stage_{stage:03d}.msgpack")


def split_and_save(
    full: Params, cfg: ModelConfig, manifest: Manifest, parts_dir: str
) -> List[str]:
    """Split full params into per-STAGE checkpoints (replicas share a
    file). Unlike the JAX package this writes no manifest.yaml: the stage
    files carry their own layer ranges, and YAML is not on the port's path."""
    manifest.validate(cfg)
    paths = []
    for spec in manifest.stage_specs():
        path = stage_checkpoint_path(parts_dir, spec.stage)
        save_stage_checkpoint(path, extract_stage_params(full, cfg, spec), spec, manifest.model_name)
        paths.append(path)
    return paths
