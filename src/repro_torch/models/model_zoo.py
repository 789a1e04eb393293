"""One model interface over the families (counterpart of
``repro/models/model_zoo.py``).

``build(config, family)`` returns a ``Model`` with the interface the
server and the tests use:

  * ``init(generator, device=None) -> params``
  * ``prefill(params, batch, max_len) -> (logits [B, V], cache)``
  * ``decode_step(params, token, cache) -> (logits [B, V], cache)``

``batch`` holds ``tokens`` [B, T] and, for the ``vlm`` family, M-RoPE
``positions`` [3, B, T].  The transformer family (``dense``, ``moe``,
``vlm``) is ported; ``encdec``, ``ssm`` and ``hybrid`` raise
``NotImplementedError`` (ROADMAP.md section 1).  The reference's loss and
its ``*_spec`` functions (abstract inputs for JAX's ahead-of-time
lowering) belong to training and to JAX and are not here.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.models import transformer

NOT_PORTED_FAMILIES = ("encdec", "ssm", "hybrid")


class Model(NamedTuple):
    family: str
    config: Any
    init: Callable
    prefill: Callable
    decode_step: Callable


def build(cfg: Any, family: str) -> Model:
    if family in ("dense", "moe", "vlm"):
        mcfg: transformer.TransformerConfig = cfg

        def init(generator, device=None):
            return transformer.init(mcfg, generator, device=device)

        def prefill(params, batch, max_len):
            return transformer.prefill(params, mcfg, batch["tokens"], max_len,
                                       positions=batch.get("positions"))

        def decode(params, token, cache):
            return transformer.decode_step(params, mcfg, token, cache)

        return Model(family=family, config=mcfg, init=init, prefill=prefill,
                     decode_step=decode)
    if family in NOT_PORTED_FAMILIES:
        raise NotImplementedError(f"the {family} family is not ported to PyTorch yet; "
                                  "see ROADMAP.md section 1")
    raise ValueError(f"unknown family {family!r}")
