from repro_torch.serving.engine import Engine, Request  # noqa: F401
from repro_torch.serving.scheduler import Scheduler  # noqa: F401
