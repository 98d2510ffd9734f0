from repro_torch.configs.base import (
    AdversaryConfig, FLConfig, ModelConfig, PersonalizeConfig, ScenarioConfig,
)

__all__ = ["AdversaryConfig", "FLConfig", "ModelConfig", "PersonalizeConfig",
           "ScenarioConfig"]
