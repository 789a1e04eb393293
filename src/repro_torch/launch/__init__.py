"""Entry points of the port beyond ``build`` and ``search``: serving
(``serve``, ``serve_loop``) and the distributed build (``build_index``);
module names follow ``repro.launch``."""
