"""Analyses of the port (counterpart of ``repro/analysis``): the bounded-
memory audit over the card's allocator ledger (``memory_audit``)."""
