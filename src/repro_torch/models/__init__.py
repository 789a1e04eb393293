"""The transformer family of the architecture zoo (counterpart of
``repro.models``): dense GQA transformers, MoE and the VLM backbone.  The
encoder-decoder, SSM and hybrid backbones are not ported yet (ROADMAP.md
section 1)."""
from repro_torch.models.model_zoo import Model, build
