"""Architecture + shape registry (``--arch <id>``): the architectures the
port serves and the four assigned input shapes."""
from repro_torch.configs.base import (ModelConfig, get_config, list_archs,
                                      register)
from repro_torch.configs.shapes import (DECODE_32K, LONG_500K, PREFILL_32K,
                                        SHAPES, TRAIN_4K, InputShape,
                                        shape_applicable)

__all__ = [
    "ModelConfig", "get_config", "list_archs", "register",
    "SHAPES", "InputShape", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
    "LONG_500K", "shape_applicable",
]
