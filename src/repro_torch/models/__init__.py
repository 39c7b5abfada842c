from .config import (FrontendConfig, ModelConfig, MoEConfig, SSMConfig,
                     SubLayer, count_params)
