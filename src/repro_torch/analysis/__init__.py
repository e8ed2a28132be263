"""Static analysis of the port's tile programs — no device required.

The port's counterpart of ``repro/analysis`` (it imports nothing of it).
Three passes over every plan the port can build:

  1. ``analysis.schedule`` — schedule legality of the baked tables (the JAX
     package's checks, names and counts);
  2. ``analysis.protocol`` — the fused kernels' flag protocol: every flag set
     once and awaited only after a smaller-numbered item sets it, slot tiles
     written once before any read, and G persistent blocks run to completion
     (``ag_gemm_wgmma_kernel`` / ``gemm_rs_wgmma_kernel``, and the float32
     route's grid);
  3. ``analysis.lint``     — layering rules over ``src/repro_torch``.

``verify_plan`` runs on every ``build_plan`` miss (``REPRO_VERIFY=0`` opts
out); ``check_candidate`` gates the tuner's candidates; ``verify_launch``
checks one launch at the grid the card gave it;
``python -m repro_torch.analysis.verify --all`` proves the shipped space.

Layering: this package stays importable from ``repro_torch.core.plan``; its
submodules import ``repro_torch.core`` and the kernels only inside functions.
"""

from repro_torch.analysis.errors import PlanVerificationError, VerificationReport
from repro_torch.analysis.ir import PlanTables
from repro_torch.analysis.verify import (
    check_a2a_candidate,
    check_candidate,
    check_quant,
    check_seq_candidate,
    verify_launch,
    verify_plan,
    verify_seq_plan,
    verify_seq_space,
    verify_seq_tables,
    verify_space,
    verify_tables,
)

__all__ = [
    "PlanVerificationError",
    "VerificationReport",
    "PlanTables",
    "check_a2a_candidate",
    "check_candidate",
    "check_quant",
    "check_seq_candidate",
    "verify_launch",
    "verify_plan",
    "verify_seq_plan",
    "verify_seq_space",
    "verify_seq_tables",
    "verify_space",
    "verify_tables",
]
