"""Model, forest and engine layer of the port (mirrors ``repro.core``)."""
from repro_torch.core.api import EngineFailure, Task, YdfError  # noqa: F401
