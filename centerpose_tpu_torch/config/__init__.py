from centerpose_tpu_torch.config.defaults import (
    Config,
    ModelConfig,
    LossConfig,
    DatasetConfig,
    TrainConfig,
    TestConfig,
    default_config,
    flagship_config,
    load_config,
    update_config,
)

__all__ = [
    "Config",
    "ModelConfig",
    "LossConfig",
    "DatasetConfig",
    "TrainConfig",
    "TestConfig",
    "default_config",
    "flagship_config",
    "load_config",
    "update_config",
]
