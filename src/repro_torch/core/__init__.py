"""PiPNN's build and search in PyTorch; module names follow ``repro.core``."""
