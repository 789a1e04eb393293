"""One model interface over the families (counterpart of
``repro/models/model_zoo.py``).

``build(config, family)`` returns a ``Model`` with the interface the
server and the tests use:

  * ``init(generator, device=None) -> params``
  * ``forward(params, batch) -> hidden [B, T, D]`` after the final norm
    (``encdec``: ``encode`` of the frames, then ``decode_train``)
  * ``prefill(params, batch, max_len) -> (logits [B, V], cache)``
  * ``decode_step(params, token, cache) -> (logits [B, V], cache)``

``batch`` holds ``tokens`` [B, T]; for the ``vlm`` family also M-RoPE
``positions`` [3, B, T], and for ``encdec`` the encoder's ``frames``
[B, S, D].  The families: ``dense``, ``moe`` and ``vlm``
(``transformer``), ``encdec``, ``ssm`` (``ssm_lm``) and ``hybrid``.  The
reference's loss and its ``*_spec`` functions (abstract inputs for JAX's
ahead-of-time lowering) belong to training and to JAX and are not here.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.models import encdec, hybrid, ssm_lm, transformer


class Model(NamedTuple):
    family: str
    config: Any
    init: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable


def build(cfg: Any, family: str) -> Model:
    if family in ("dense", "moe", "vlm"):
        def forward(params, batch):
            return transformer.forward(params, cfg, batch["tokens"],
                                       positions=batch.get("positions"))[0]

        def prefill(params, batch, max_len):
            return transformer.prefill(params, cfg, batch["tokens"], max_len,
                                       positions=batch.get("positions"))
        module = transformer
    elif family == "encdec":
        def forward(params, batch):
            memory = encdec.encode(params, cfg, batch["frames"])
            return encdec.decode_train(params, cfg, batch["tokens"], memory)

        def prefill(params, batch, max_len):
            return encdec.prefill(params, cfg, batch["frames"], batch["tokens"], max_len)
        module = encdec
    elif family in ("ssm", "hybrid"):
        module = ssm_lm if family == "ssm" else hybrid

        def forward(params, batch):
            return module.forward(params, cfg, batch["tokens"])

        def prefill(params, batch, max_len):
            return module.prefill(params, cfg, batch["tokens"], max_len)
    else:
        raise ValueError(f"unknown family {family!r}")

    def init(generator, device=None):
        return module.init(cfg, generator, device=device)

    def decode(params, token, cache):
        return module.decode_step(params, cfg, token, cache)

    return Model(family=family, config=cfg, init=init, forward=forward, prefill=prefill,
                 decode_step=decode)
