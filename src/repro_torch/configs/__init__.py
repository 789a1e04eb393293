"""Architecture configs of the LM families (counterpart of
``repro.configs``): the published hyper-parameters and a reduced smoke
model of each."""
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config
