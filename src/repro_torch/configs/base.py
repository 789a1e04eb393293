"""Config system: architecture configs and the input-shape cells
(counterpart of ``repro/configs/base.py``).

Every ported architecture has one module in this package exposing
``get_config() -> ArchConfig`` with the exact published hyper-parameters,
plus a reduced ``smoke_model`` of the same family for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


# The LM shape set (the same for every architecture).
SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                        # dense | moe | encdec | vlm | ssm | hybrid
    model: Any                         # full-size model config
    smoke_model: Any                   # reduced config, same family
    sub_quadratic: bool = False        # eligible for long_500k
    parallelism: str = "fsdp_tp"       # the reference's sharding policy
    microbatches: Mapping[str, int] = dataclasses.field(default_factory=dict)
    source: str = ""
    notes: str = ""

    def runnable_cells(self) -> list[ShapeCell]:
        cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
        if self.sub_quadratic:
            cells.append(SHAPES["long_500k"])
        return cells

    def skipped_cells(self) -> list[tuple[str, str]]:
        if self.sub_quadratic:
            return []
        return [("long_500k",
                 "full-attention arch: 500k dense decode is not "
                 "sub-quadratic; skipped per assignment rules")]

    def microbatch(self, shape_name: str) -> int:
        return self.microbatches.get(shape_name, 1)


def pad_to_multiple(x: int, m: int) -> int:
    return -(-x // m) * m
