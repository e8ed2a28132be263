"""TileLink core for the port: schedules, channels, plans, executor, frontend."""

from repro_torch.core import schedules
from repro_torch.core.channels import ORDERS, BlockChannel, CommSpec, CompSpec, QuantSpec
from repro_torch.core.comp_tiles import DEFAULT_TILE, blocked_dot, largest_divisor, resolve_tile
from repro_torch.core.compiler import BACKENDS, KINDS, SEQ_KINDS, SeamFallbackWarning, compile_overlap, unsupported_error
from repro_torch.core.mapping import (
    DynamicTileMapping,
    StaticTileMapping,
    build_moe_dynamic_mapping,
    cdiv,
    effective_channels,
)
from repro_torch.core.overlap import ag_attention_baseline, matmul_rs_ag, ring_attention
from repro_torch.core.quant import PackedWeight, WirePayload, pack_weight
from repro_torch.core.plan import ChannelSchedule, SeqPlan, TilePlan, build_plan, build_seq_plan, plan_cache_info

__all__ = [
    "schedules",
    "ORDERS",
    "BlockChannel",
    "CommSpec",
    "CompSpec",
    "QuantSpec",
    "PackedWeight",
    "WirePayload",
    "pack_weight",
    "DEFAULT_TILE",
    "blocked_dot",
    "largest_divisor",
    "resolve_tile",
    "BACKENDS",
    "KINDS",
    "SEQ_KINDS",
    "SeamFallbackWarning",
    "compile_overlap",
    "unsupported_error",
    "ring_attention",
    "ag_attention_baseline",
    "matmul_rs_ag",
    "StaticTileMapping",
    "DynamicTileMapping",
    "build_moe_dynamic_mapping",
    "cdiv",
    "effective_channels",
    "ChannelSchedule",
    "TilePlan",
    "SeqPlan",
    "build_plan",
    "build_seq_plan",
    "plan_cache_info",
]
