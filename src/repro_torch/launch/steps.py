"""The serving part of ``repro/launch/steps.py``: the model of an
architecture, which ``launch/serve.py::Server`` serves.  The reference's
prefill and decode step builders wrap ``Model.prefill`` and
``Model.decode_step`` to be jitted; eager PyTorch calls them directly.

The reference's train step, its cell programs (``cell_program``,
``CellProgram``, ``input_specs``) and its sharding helpers are training
or JAX lowering machinery and are not here (ROADMAP.md section 1).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model_zoo


def build_model(arch: ArchConfig, *, smoke: bool = False) -> model_zoo.Model:
    """The full-size model of ``arch``, or its smoke model."""
    return model_zoo.build(arch.smoke_model if smoke else arch.model, arch.family)
