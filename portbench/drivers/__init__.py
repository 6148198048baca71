"""One module per kind of traffic mix, named by the mix's ``"driver"``."""


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file's sizes."""
    import dataclasses

    from subgc_tpu_torch.config import ModelConfig
    return ModelConfig(**{f.name: cfg[f.name]
                          for f in dataclasses.fields(ModelConfig)
                          if f.name in cfg})
