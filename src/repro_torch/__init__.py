"""repro_torch: PiPNN's streaming build and its search over float32,
bfloat16 or int8 serving copies in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

This package is the port of the JAX package ``repro`` (which stays the
reference); its module names follow ``repro``'s.  It imports neither JAX
nor ``repro``.  Entry points (``build``, ``search``,
``ServingIndex.from_graph``) run on the card unless the caller passes
``device="cpu"``, and raise when no card is present.  Float32 matrix
products run at full precision ("highest", no TF32; see ``device``).
Importing the package compiles nothing: the kernels are built at first use.
"""
from repro_torch.core.pipnn import PiPNNIndex, PiPNNParams, build, search, serving_index
from repro_torch.core.serving import ServingIndex

__all__ = ["PiPNNIndex", "PiPNNParams", "ServingIndex", "build", "search",
           "serving_index"]
