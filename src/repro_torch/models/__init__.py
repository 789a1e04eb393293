"""The architecture zoo (counterpart of ``repro.models``): dense GQA
transformers, MoE and the VLM backbone (``transformer``), the SSM
(``ssm_lm`` over ``mamba2``), the Mamba2 + shared-attention hybrid
(``hybrid``) and the encoder-decoder (``encdec``)."""
from repro_torch.models.model_zoo import Model, build
