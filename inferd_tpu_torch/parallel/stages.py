"""Stage partitioning: layer-range manifests and per-stage param subsets
(port of inferd_tpu/parallel/stages.py).

A stage is a slice of the stacked layer params plus embed on the first
stage and final norm (+ embed for a tied head, or lm_head) on the last.
Stage checkpoints use the JAX package's file format (flax msgpack, written
here by parallel/flax_format.py), so one parts directory serves both.
"""

from __future__ import annotations

import dataclasses
import json
import os
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

    @staticmethod
    def from_yaml(path_or_text: str) -> "Manifest":
        import yaml  # manifest-driven deployment only; the serving path never reads YAML

        if os.path.exists(path_or_text):
            with open(path_or_text) as f:
                data = yaml.safe_load(f)
        else:
            data = yaml.safe_load(path_or_text)
        nodes = [
            NodeSpec(
                name=n["name"], stage=int(n["stage"]),
                start_layer=int(n["start_layer"]), end_layer=int(n["end_layer"]),
            )
            for n in data["nodes"]
        ]
        return Manifest(
            model_name=data["model_name"], num_stages=int(data["stages_count"]), nodes=nodes
        )

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(
            {
                "model_name": self.model_name,
                "stages_count": self.num_stages,
                "nodes": [dataclasses.asdict(n) for n in self.nodes],
            },
            sort_keys=False,
        )

    @staticmethod
    def even_split(
        model_name: str, num_stages: int, replicas: Optional[List[int]] = None
    ) -> "Manifest":
        """Even layer split into num_stages; replicas[s] nodes per stage."""
        cfg = get_config(model_name)
        replicas = replicas or [1] * num_stages
        per = cfg.num_layers // num_stages
        extra = cfg.num_layers % num_stages
        nodes, start = [], 0
        for s in range(num_stages):
            end = start + per + (1 if s < extra else 0) - 1
            for r in range(replicas[s]):
                name = f"node{s}_{r}" if replicas[s] > 1 else f"node{s}"
                nodes.append(NodeSpec(name, s, start, end))
            start = end + 1
        return Manifest(model_name=model_name, num_stages=num_stages, nodes=nodes)


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


def save_stage_checkpoint(
    path: str, stage_params: Params, spec: StageSpec, model_name: str
) -> None:
    """Write one stage's params + metadata in the flax msgpack format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {
        "model_name": model_name,
        "stage": spec.stage,
        "num_stages": spec.num_stages,
        "start_layer": spec.start_layer,
        "end_layer": spec.end_layer,
    }
    blob = flax_format.dumps({"meta_json": json.dumps(meta), "params": stage_params})
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
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
