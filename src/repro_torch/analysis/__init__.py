"""Analyses of the port (counterpart of ``repro/analysis``): the static
contract checker, ``python -m repro_torch.analysis.lint``, and its passes:
``ast_lint`` (PIPA), ``contracts`` (PIPK, the CUDA kernels),
``hotpath_audit`` (PIPJ), ``mesh_audit`` (PIPS) and ``memory_audit``
(PIPM, the card's allocator ledger).  No submodule is imported here, so
that ``python -m`` runs the CLI's module first."""
