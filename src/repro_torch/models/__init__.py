from repro_torch.models.config import ModelConfig, ShapeConfig, INPUT_SHAPES  # noqa
from repro_torch.models.model import (Transformer, init_params, forward,  # noqa
                                      decode_step)
from repro_torch.models.cache import init_cache  # noqa
