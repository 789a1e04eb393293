"""Distribution primitives of the port; module names follow ``repro.distributed``."""
