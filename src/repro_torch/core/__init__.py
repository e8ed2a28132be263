"""TileLink core for the port: schedules, channels, plans, executor, frontend."""

from repro_torch.core import schedules
from repro_torch.core.channels import ORDERS, BlockChannel, CommSpec, CompSpec, QuantSpec
from repro_torch.core.comp_tiles import DEFAULT_TILE, blocked_dot, largest_divisor, resolve_tile
from repro_torch.core.compiler import BACKENDS, KINDS, compile_overlap, unsupported_error
from repro_torch.core.mapping import cdiv, effective_channels
from repro_torch.core.plan import ChannelSchedule, TilePlan, build_plan, plan_cache_info

__all__ = [
    "schedules",
    "ORDERS",
    "BlockChannel",
    "CommSpec",
    "CompSpec",
    "QuantSpec",
    "DEFAULT_TILE",
    "blocked_dot",
    "largest_divisor",
    "resolve_tile",
    "BACKENDS",
    "KINDS",
    "compile_overlap",
    "unsupported_error",
    "cdiv",
    "effective_channels",
    "ChannelSchedule",
    "TilePlan",
    "build_plan",
    "plan_cache_info",
]
