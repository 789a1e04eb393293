"""Test harnesses of the port; module names follow ``repro.testing``."""
