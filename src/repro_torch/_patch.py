"""Replacing a port function wherever a port module holds it, for the
analyses that count or charge its calls (``analysis.hotpath_audit``,
``analysis.mesh_audit``, ``roofline.op_cost``)."""
from __future__ import annotations

import contextlib
import sys


@contextlib.contextmanager
def patched_everywhere(replacements: dict):
    """Replace each function ``old`` by ``new`` (``{old: new}``) wherever a
    port module holds it as a module attribute; restored on exit."""
    done = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("repro_torch"):
            continue
        for attr, val in list(vars(mod).items()):
            try:
                new = replacements.get(val)
            except TypeError:           # an unhashable module attribute
                continue
            if new is not None:
                setattr(mod, attr, new)
                done.append((mod, attr, val))
    try:
        yield
    finally:
        for mod, attr, val in done:
            setattr(mod, attr, val)
