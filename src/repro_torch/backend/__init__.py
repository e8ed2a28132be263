"""Device policy, Hopper probes and the emulated tensor-parallel ``World``."""

from repro_torch.backend.hw import HopperInfo, probe, require_hopper
from repro_torch.backend.mesh import World
from repro_torch.backend.target import resolve_device

__all__ = ["HopperInfo", "probe", "require_hopper", "World", "resolve_device"]
