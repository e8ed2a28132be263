"""Hopper hardware probes — replace the JAX package's MXU/VMEM probes.

``repro/backend/hw.py`` reports the TPU's matrix-unit edge and VMEM budget.
On the card the numbers that shape a kernel are the SM count (how many
co-resident blocks a cooperative launch may hold), the shared memory a block
may use, and the compute capability (``sm_90a`` kernels need 9.0).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["HopperInfo", "probe", "require_hopper"]


@dataclasses.dataclass(frozen=True)
class HopperInfo:
    name: str
    sm_count: int
    smem_per_block_optin: int  # bytes a block may use as dynamic shared memory
    capability: tuple

    @property
    def is_hopper(self) -> bool:
        return self.capability == (9, 0)


def probe(device: torch.device) -> HopperInfo:
    """Read the card's properties (CUDA devices only)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"hardware probe needs a CUDA device, got {dev}")
    p = torch.cuda.get_device_properties(dev)
    optin = getattr(p, "shared_memory_per_block_optin", 0) or 0
    return HopperInfo(
        name=p.name,
        sm_count=p.multi_processor_count,
        smem_per_block_optin=int(optin),
        capability=(p.major, p.minor),
    )


def require_hopper(device: torch.device) -> HopperInfo:
    """Raise unless ``device`` is a compute-capability 9.0 card (the kernels'
    build target is ``sm_90a``)."""
    info = probe(device)
    if not info.is_hopper:
        raise RuntimeError(
            f"repro_torch kernels are built for sm_90a; {info.name} has compute "
            f"capability {info.capability[0]}.{info.capability[1]}"
        )
    return info
