"""Serving entry points of the port; module names follow ``repro.launch``."""
