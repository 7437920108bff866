"""Mixture-of-Experts routing, dispatch/combine, and INT4 MoE layers.

Counterpart of the reference's MoE pipeline:

* top-k softmax router with renormalized gate weights
  (`benchmark/moe_grouped_gemm/routing.py:72-93`),
* sort-by-expert dispatch with inverse permutation
  (`routing.py:96-149`),
* weighted combine over the top-k expert outputs (`routing.py:152-189`),
* routing *simulators* (uniform / zipf-skewed / random logits) for
  benchmarking (`routing.py:54-69`),
* ``MoEINT4`` — the reference's single-projection fused MoE module
  (`python/moe_int4_module.py:83-146`), built on the **correct** grouped
  kernel (the reference CUDA kernel is broken for ffn>256 / multi-token
  groups, SURVEY.md §2.1),
* ``QuantizedMoE`` — dequant-then-matmul per-expert module
  (`benchmark/moe_grouped_gemm/moe_int4_module.py:84-125`) as the golden
  baseline.

Dispatch here is *dropless and statically shaped*: tokens are sorted by
expert and every group is padded to a ``tile_m`` boundary inside a buffer of
static size ``T*top_k + E*tile_m`` (each group wastes < tile_m rows). This is
what lets the data-dependent routing run under ``jit`` with no recompilation
per routing outcome — in place of the reference's host loop over
experts (SURVEY.md §7 "hard parts": ragged grouped GEMM without dynamic
shapes).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import jax
import jax.numpy as jnp

from ..ops.grouped_matmul import grouped_int4_matmul
from ..quant.core import QuantizedTensor, quantize, dequantize

__all__ = [
    "RoutingResult",
    "DispatchPlan",
    "topk_route",
    "simulate_router_logits",
    "make_dispatch_plan",
    "make_capacity_plan",
    "expert_load_stats",
    "dispatch",
    "combine",
    "MoEINT4",
    "QuantizedMoE",
]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RoutingResult:
    """Mirror of the reference RoutingResult (`routing.py:17-24`)."""

    expert_indices: jnp.ndarray   # [T, k] i32
    expert_weights: jnp.ndarray   # [T, k] f32, renormalized over k
    tokens_per_expert: jnp.ndarray  # [E] i32
    expert_token_offsets: jnp.ndarray  # [E+1] i32 (unpadded, cumulative)


def topk_route(logits: jnp.ndarray, top_k: int, num_experts: int) -> RoutingResult:
    """Softmax-of-logits top-k routing with renormalized weights
    (`routing.py:72-93`)."""
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    weights, indices = jax.lax.top_k(probs, top_k)
    weights = weights / jnp.sum(weights, axis=-1, keepdims=True)
    tokens_per_expert = jnp.bincount(
        indices.reshape(-1), length=num_experts
    ).astype(jnp.int32)
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(tokens_per_expert)]
    ).astype(jnp.int32)
    return RoutingResult(indices.astype(jnp.int32), weights, tokens_per_expert, offsets)


def simulate_router_logits(
    key: jax.Array,
    num_tokens: int,
    num_experts: int,
    distribution: Literal["uniform", "skewed", "random"] = "uniform",
) -> jnp.ndarray:
    """Benchmark logit generators mirroring the reference distributions
    (`routing.py:54-69`): uniform, zipf-skewed (expert i ∝ 1/(i+1)), random."""
    if distribution == "uniform":
        return jax.random.normal(key, (num_tokens, num_experts)) * 0.01
    if distribution == "skewed":
        bias = jnp.log(1.0 / (jnp.arange(num_experts) + 1.0))
        return bias[None, :] + jax.random.normal(key, (num_tokens, num_experts))
    if distribution == "random":
        return jax.random.normal(key, (num_tokens, num_experts)) * 10.0
    raise ValueError(f"unknown distribution {distribution!r}")


# ---------------------------------------------------------------------------
# Dispatch / combine (sort-by-expert, tile-aligned, dropless)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Static-shape routing plan feeding the grouped kernel.

    rows:            [T*k] i32 — destination row in the padded buffer for each
                     (token, k) pair, in flat token-major order.
    tile_group_ids:  [num_tiles] i32 — expert of each m-tile (each kernel
                     program reads its own entry).
    t_pad:           static padded buffer length (T*k + E*tile_m).
    tile_m:          static m-tile size.
    """

    rows: jnp.ndarray
    tile_group_ids: jnp.ndarray
    t_pad: int = dataclasses.field(metadata=dict(static=True))
    tile_m: int = dataclasses.field(metadata=dict(static=True))


def make_capacity_plan(
    routing: RoutingResult, num_experts: int, capacity: int, tile_m: int = 16
) -> DispatchPlan:
    """Capacity-mode plan: every expert owns a fixed [capacity] segment.

    Switch/GShard semantics — pairs beyond an expert's capacity are DROPPED
    (their rows point out of bounds; `dispatch` discards them and `combine`
    contributes zero). The payoff is a fully static [E, C, H] layout: the
    buffer reshapes to per-expert blocks, which is what the dense einsum
    ("bmm") baselines and prefill-regime execution want. Use
    :func:`make_dispatch_plan` for the dropless tile-packed layout instead.
    """
    if capacity % tile_m != 0:
        raise ValueError(f"capacity={capacity} must be a multiple of tile_m={tile_m}")
    flat_ids = routing.expert_indices.reshape(-1)  # [T*k]
    sort_idx = jnp.argsort(flat_ids, stable=True)
    ranks_sorted = (
        jnp.arange(flat_ids.shape[0], dtype=jnp.int32)
        - routing.expert_token_offsets[flat_ids[sort_idx]]
    )
    ranks = jnp.zeros_like(flat_ids).at[sort_idx].set(ranks_sorted)
    t_pad = num_experts * capacity
    # overflow pairs index out of bounds -> dropped by mode="drop" scatters
    rows = jnp.where(
        ranks < capacity, flat_ids * capacity + ranks, t_pad
    ).astype(jnp.int32)
    tile_group_ids = jnp.repeat(
        jnp.arange(num_experts, dtype=jnp.int32), capacity // tile_m
    )
    return DispatchPlan(rows, tile_group_ids, t_pad, tile_m)


def make_dispatch_plan(
    routing: RoutingResult, num_experts: int, tile_m: int = 64
) -> DispatchPlan:
    """Compute destination rows + tile->expert map for sorted dispatch.

    Equivalent role to the reference's `create_expert_inputs` argsort/gather
    (`routing.py:117-149`), extended with tile alignment so the grouped
    Pallas kernel sees every group starting on a tile boundary.
    """
    flat_ids = routing.expert_indices.reshape(-1)  # [T*k]
    tk = flat_ids.shape[0]
    # Upper bound on sum of per-group tile-padded sizes (< tile_m waste per
    # group), rounded to a whole number of tiles.
    t_pad = _cdiv(tk, tile_m) * tile_m + num_experts * tile_m
    num_tiles = t_pad // tile_m

    sizes = routing.tokens_per_expert  # [E]
    padded_sizes = _cdiv_j(sizes, tile_m) * tile_m
    padded_offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(padded_sizes)]
    ).astype(jnp.int32)

    # Rank of each (token, k) pair within its expert, in flat order: stable
    # argsort by expert id, then invert (`routing.py:137-143`).
    sort_idx = jnp.argsort(flat_ids, stable=True)
    ranks_sorted = (
        jnp.arange(tk, dtype=jnp.int32)
        - routing.expert_token_offsets[flat_ids[sort_idx]]
    )
    ranks = jnp.zeros((tk,), jnp.int32).at[sort_idx].set(ranks_sorted)
    rows = padded_offsets[flat_ids] + ranks

    # Expert of each m-tile: tile t belongs to expert e iff
    # padded_offsets[e] <= t*tile_m < padded_offsets[e+1]. Tiles beyond the
    # last group point at expert E-1 and carry only zero rows.
    tile_starts = jnp.arange(num_tiles, dtype=jnp.int32) * tile_m
    tile_group_ids = (
        jnp.searchsorted(padded_offsets[1:], tile_starts, side="right")
        .astype(jnp.int32)
        .clip(0, num_experts - 1)
    )
    return DispatchPlan(rows, tile_group_ids, t_pad, tile_m)


def _cdiv_j(a, b):
    return -(-a // b)


def expert_load_stats(routing: RoutingResult, capacity: int = 0) -> dict:
    """Router observability: per-expert load, imbalance, and (capacity mode)
    drop counts. The reference prints nothing structured about routing; this
    backs dashboards/benchmark output.

    Returns a dict of jnp values:
      load_fraction [E], max_over_mean imbalance (scalar),
      dropped (scalar; 0 unless capacity > 0).
    """
    tpe = routing.tokens_per_expert.astype(jnp.float32)
    total = jnp.maximum(jnp.sum(tpe), 1.0)
    load = tpe / total
    imbalance = jnp.max(tpe) / jnp.maximum(jnp.mean(tpe), 1e-9)
    dropped = (
        jnp.sum(jnp.maximum(routing.tokens_per_expert - capacity, 0))
        if capacity > 0
        else jnp.zeros((), jnp.int32)
    )
    return dict(load_fraction=load, imbalance=imbalance, dropped=dropped)


def dispatch(x: jnp.ndarray, routing: RoutingResult, plan: DispatchPlan) -> jnp.ndarray:
    """Scatter tokens into the sorted, tile-aligned buffer [T_pad, H].

    Each token appears once per selected expert (top-k replication), like the
    reference's flatten-then-gather (`routing.py:117-135`).
    """
    t, h = x.shape
    k = routing.expert_indices.shape[1]
    x_rep = jnp.repeat(x, k, axis=0)  # token-major [T*k, H]
    buf = jnp.zeros((plan.t_pad, h), x.dtype)
    # mode="drop": capacity-mode plans mark overflow pairs with
    # out-of-bounds rows (make_capacity_plan) — they are discarded here.
    return buf.at[plan.rows].set(x_rep, mode="drop")


def combine(
    expert_out: jnp.ndarray, routing: RoutingResult, plan: DispatchPlan
) -> jnp.ndarray:
    """Gather back to token order and weight-sum over top-k
    (`routing.py:174-189`)."""
    t, k = routing.expert_weights.shape
    # mode="fill": dropped pairs (out-of-bounds rows) contribute zero.
    per_pair = expert_out.at[plan.rows].get(mode="fill", fill_value=0)  # [T*k, N]
    per_pair = per_pair.reshape(t, k, -1)
    w = routing.expert_weights.astype(per_pair.dtype)[..., None]
    return jnp.sum(per_pair * w, axis=1)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MoEINT4:
    """Fused single-projection INT4 MoE (reference `MoEINT4`,
    `python/moe_int4_module.py:83-146`).

    Holds stacked per-expert INT4 weights [E, ffn, hidden] and applies the
    grouped kernel to pre-routed inputs. The reference takes
    (inputs, expert_ids, tokens_per_expert, input_offsets); here the same
    information arrives as the (x_sorted, tile_group_ids) pair produced by
    :func:`dispatch` / :func:`make_dispatch_plan`.
    """

    weight: QuantizedTensor  # [E, N, K]
    use_kernel: bool = dataclasses.field(metadata=dict(static=True), default=True)
    # Optional i8-resident copy for the XLA-turbo capacity path (see
    # ops/int8_xla.py); populated by MoEBlock/as_xla_turbo conversion.
    w8: "object" = None

    @classmethod
    def from_dense(
        cls,
        weights: jnp.ndarray,
        *,
        granularity: str = "per_row",
        group_size: int = 128,
        **kw,
    ) -> "MoEINT4":
        """Quantize stacked dense expert weights [E, N, K]
        (reference `from_weights`, `python/moe_int4_module.py:107-120`).

        per_group experts pack group-major (layout="planar_groups") when
        128 | group_size | K/2; the grouped kernel reads either layout."""
        layout = "planar"
        if granularity == "per_group":
            k_half = weights.shape[-1] // 2
            if group_size % 128 == 0 and k_half % group_size == 0:
                layout = "planar_groups"
        qt = quantize(
            weights, granularity=granularity, layout=layout,
            group_size=group_size,
        )
        return cls(weight=qt, **kw)

    @property
    def num_experts(self) -> int:
        return self.weight.shape[0]

    def __call__(self, x_sorted: jnp.ndarray, tile_group_ids: jnp.ndarray, **kw):
        w = self.weight
        if not self.use_kernel:
            # Golden path: per-tile dense dequant matmul.
            wd = dequantize(w, dtype=jnp.float32)  # [E, N, K]
            tile_m = x_sorted.shape[0] // tile_group_ids.shape[0]
            xt = x_sorted.reshape(tile_group_ids.shape[0], tile_m, -1)
            wt = wd[tile_group_ids]  # [num_tiles, N, K]
            out = jnp.einsum(
                "tmk,tnk->tmn", xt.astype(jnp.float32), wt,
                precision=jax.lax.Precision.HIGHEST,
            )
            return out.reshape(x_sorted.shape[0], -1).astype(x_sorted.dtype)
        return grouped_int4_matmul(x_sorted, tile_group_ids, w, **kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuantizedMoE:
    """Dequantize-then-matmul per-expert MoE — the golden baseline
    (reference `QuantizedMoE`, `benchmark/moe_grouped_gemm/moe_int4_module.py:
    84-125`, whose forward is explicitly dequant+matmul "could be fused").
    """

    weight: QuantizedTensor  # [E, N, K]

    @classmethod
    def from_dense(cls, weights: jnp.ndarray, **kw) -> "QuantizedMoE":
        return cls(weight=quantize(weights, layout="planar", **kw))

    def __call__(self, x: jnp.ndarray, routing: RoutingResult) -> jnp.ndarray:
        """Token-order input [T, K] -> combined output [T, N]."""
        w = dequantize(self.weight, dtype=jnp.float32)  # [E, N, K]
        we = w[routing.expert_indices]  # [T, k, N, K]
        y = jnp.einsum("tk,tenk->ten", x.astype(jnp.float32), we)
        return jnp.sum(
            y * routing.expert_weights[..., None], axis=1
        ).astype(x.dtype)

    def total_memory_bytes(self) -> int:
        """Reference memory accounting (`moe_int4_module.py:74-81,127-130`)."""
        return self.weight.nbytes
