"""E2C-scheduled LM serving on the PyTorch port (counterpart of
``repro.serving``)."""
from repro_torch.serving.engine import (AppSpec, ServeConfig, ServingEngine,
                                        ServeReport)

__all__ = ["AppSpec", "ServeConfig", "ServingEngine", "ServeReport"]
