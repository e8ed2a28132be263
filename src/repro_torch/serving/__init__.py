"""Request-level continuous-batching serving: the port of ``repro/serving``."""

from repro_torch.serving.cache import SlotPool
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["ServeEngine", "Request", "Scheduler", "SlotPool"]
