"""Device policy, feature probes, Hopper probes, the launch surface and the
emulated tensor-parallel ``World`` — the port's counterpart of ``repro.backend``.

``features`` probes the installed PyTorch and toolchain once, at import
(``describe()`` reports them with the card's own properties); ``lowering``
names each of the reference's Pallas launch functions beside the port's
counterpart in ``kernels/build``.
"""

from repro_torch.backend.features import describe
from repro_torch.backend.hw import HopperInfo, probe, require_hopper
from repro_torch.backend.mesh import World
from repro_torch.backend.target import resolve_device

__all__ = ["describe", "HopperInfo", "probe", "require_hopper", "World", "resolve_device"]
