"""Expert-parallel and tensor-parallel MoE/linear execution (shard_map).

The scale-out capability the reference only aspires to ("Multi-GPU MoE",
`README.md:115-118`; SURVEY.md §2.5). Design: experts sharded over a mesh `expert` axis with
token exchange over NVLink, TP-sharded linears over `model`, compiled by XLA —
no hand-written communication backend.

Two EP strategies, both jit/static-shape friendly:

* ``moe_ep_replicated`` — tokens replicated over the expert axis; each device
  runs the grouped INT4 kernel for *its local experts only* and the partial
  weighted outputs are ``psum``-combined. Dropless, no all_to_all, and for
  decode (few tokens, weight-streaming bound) near-optimal: the 1/D weight
  slice per device is exactly the bandwidth split that matters.

* ``moe_ep_a2a`` — tokens data-sharded; each device routes its local tokens,
  packs per-destination-device capacity buffers, exchanges them with
  ``all_to_all`` over the expert axis, runs its local grouped GEMM, and
  returns results with a second ``all_to_all``. Classic capacity-factor MoE
  (tokens beyond capacity drop — standard Switch/GShard semantics); use for
  large-batch prefill where duplicating tokens would swamp the interconnect.

Tensor parallelism: ``tp_int4_matmul`` runs the fused kernel on a
column-sharded QuantizedTensor under shard_map and all-gathers the output.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..layers.moe import (
    RoutingResult,
    combine,
    dispatch,
    make_dispatch_plan,
    topk_route,
)
from .. import platform
from ..ops.grouped_matmul import grouped_int4_matmul


def _grouped_local(xs, gids, qt_loc, tile_m, interpret):
    """Local grouped GEMM over this device's experts (per_row or per_group;
    the grouped INT4 matmul takes either)."""
    return grouped_int4_matmul(
        xs, gids, qt_loc, tile_m=tile_m, interpret=interpret
    )


from ..ops.int4_matmul import int4_matmul
from ..quant.core import QuantizedTensor

__all__ = [
    "moe_ep_replicated", "moe_ep_a2a", "moe_ep_a2a_dropless", "moe_ep_ring",
    "tp_int4_matmul",
]


def _qt_local(qt: QuantizedTensor, packed, scales, zps, num_local: int):
    """Rebuild a QuantizedTensor view for the local expert shard."""
    return QuantizedTensor(
        packed=packed, scales=scales, zero_points=zps,
        shape=(num_local,) + qt.shape[1:],
        granularity=qt.granularity, layout=qt.layout,
        block_k=qt.block_k, group_size=qt.group_size, bits=qt.bits,
    )


# ---------------------------------------------------------------------------
# EP strategy 1: replicated tokens, sharded experts, psum combine
# ---------------------------------------------------------------------------



def _local_contrib(xblk, eids, weights, lo, e_local, qt_loc, tile_m, interpret):
    """One device's dropless contribution for a token block.

    Foreign pairs (experts outside [lo, lo+e_local)) are remapped to local
    expert 0 with weight 0 — their rows flow through the kernel but
    contribute nothing after weighting. Shared by the psum-replicated and
    ring strategies.
    """
    local_ids = eids - lo
    mine = (local_ids >= 0) & (local_ids < e_local)
    local_ids = jnp.where(mine, local_ids, 0).astype(jnp.int32)
    w = jnp.where(mine, weights, 0.0)
    tpe = jnp.bincount(local_ids.reshape(-1), length=e_local).astype(jnp.int32)
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(tpe)]
    ).astype(jnp.int32)
    rt = RoutingResult(local_ids, w, tpe, offsets)
    plan = make_dispatch_plan(rt, e_local, tile_m=tile_m)
    xs = dispatch(xblk, rt, plan)
    y = _grouped_local(xs, plan.tile_group_ids, qt_loc, tile_m, interpret)
    return combine(y, rt, plan)  # [T_blk, N]


def moe_ep_replicated(
    x: jnp.ndarray,            # [T, H], replicated over the expert axis
    router_logits: jnp.ndarray,  # [T, E], replicated
    qt: QuantizedTensor,       # stacked [E, N, K], sharded over axis 0
    mesh: Mesh,
    *,
    top_k: int,
    axis: str = "expert",
    tile_m: int = 16,
    interpret: Optional[bool] = None,
) -> jnp.ndarray:
    """Dropless EP MoE: every device keeps all tokens, computes only its
    experts' contributions, and psums. Returns [T, N] replicated."""
    e = qt.shape[0]
    n_dev = mesh.shape[axis]
    e_local = e // n_dev
    if e_local * n_dev != e:
        raise ValueError(f"num_experts={e} not divisible by mesh axis {n_dev}")

    def body(xb, logits, packed, scales, zps):
        dev = jax.lax.axis_index(axis)
        lo = dev * e_local
        routing = topk_route(logits, top_k, e)
        qt_loc = _qt_local(qt, packed, scales, zps, e_local)
        part = _local_contrib(
            xb, routing.expert_indices, routing.expert_weights,
            lo, e_local, qt_loc, tile_m, interpret,
        )  # [T, N] partial
        return jax.lax.psum(part, axis)

    specs_in = (
        P(), P(),
        P(axis, None, None), P(axis, None), P(axis, None),
    )
    return shard_map(
        body, mesh=mesh, in_specs=specs_in, out_specs=P(), check_vma=False,
    )(x, router_logits, qt.packed, qt.scales, qt.zero_points)


# ---------------------------------------------------------------------------
# EP strategy 2: data-sharded tokens, all_to_all exchange, capacity buffers
# ---------------------------------------------------------------------------


def moe_ep_a2a(
    x: jnp.ndarray,             # [T, H], sharded over the expert axis (dim 0)
    router_logits: jnp.ndarray,  # [T, E], sharded likewise
    qt: QuantizedTensor,        # stacked [E, N, K], sharded over axis 0
    mesh: Mesh,
    *,
    top_k: int,
    axis: str = "expert",
    capacity_factor: float = 2.0,
    tile_m: int = 16,
    interpret: Optional[bool] = None,
) -> jnp.ndarray:
    """Capacity-factor EP MoE with all_to_all token exchange.

    Per device: route local tokens, pack a [n_dev, C, H] send buffer (C =
    static per-destination capacity), all_to_all over NVLink, grouped GEMM on
    local experts, all_to_all back, weighted combine. Tokens beyond capacity
    are dropped (Switch/GShard semantics). Returns [T, N] sharded like x.
    """
    e = qt.shape[0]
    n_dev = mesh.shape[axis]
    e_local = e // n_dev
    if e_local * n_dev != e:
        raise ValueError(f"num_experts={e} not divisible by mesh axis {n_dev}")

    def body(xb, logits, packed, scales, zps):
        t_loc, h = xb.shape
        cap = max(int(capacity_factor * t_loc * top_k / n_dev), tile_m)
        cap = -(-cap // tile_m) * tile_m  # tile-align

        routing = topk_route(logits, top_k, e)
        flat_ids = routing.expert_indices.reshape(-1)          # [T*k]
        dest_dev = flat_ids // e_local                          # [T*k]
        # slot of each pair within its destination buffer (rank among pairs
        # with the same destination, in flat order)
        onehot = jax.nn.one_hot(dest_dev, n_dev, dtype=jnp.int32)  # [T*k, D]
        rank = jnp.cumsum(onehot, axis=0) - onehot                 # exclusive
        slot = jnp.take_along_axis(rank, dest_dev[:, None], axis=1)[:, 0]
        keep = slot < cap

        # send buffers: tokens + their (local) expert id travel together
        xrep = jnp.repeat(xb, top_k, axis=0)                    # [T*k, H]
        send_x = jnp.zeros((n_dev, cap, h), xb.dtype)
        send_eid = jnp.full((n_dev, cap), -1, jnp.int32)
        # Dropped pairs index out of bounds (slot=cap) so mode="drop" discards
        # them instead of clobbering the last in-bounds slot.
        idx = (dest_dev, jnp.where(keep, slot, cap))
        send_x = send_x.at[idx[0], idx[1]].set(xrep, mode="drop")
        send_eid = send_eid.at[idx[0], idx[1]].set(
            (flat_ids % e_local).astype(jnp.int32), mode="drop"
        )

        # exchange over NVLink
        recv_x = jax.lax.all_to_all(send_x, axis, 0, 0, tiled=False)
        recv_eid = jax.lax.all_to_all(send_eid, axis, 0, 0, tiled=False)
        recv_x = recv_x.reshape(n_dev * cap, h)
        recv_eid = recv_eid.reshape(n_dev * cap)

        # local grouped GEMM over my experts: sort received rows by expert
        valid = recv_eid >= 0
        eid = jnp.where(valid, recv_eid, 0)
        tpe = jnp.bincount(
            jnp.where(valid, recv_eid, e_local), length=e_local + 1
        )[:e_local].astype(jnp.int32)
        offsets = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(tpe)]
        ).astype(jnp.int32)
        # Reuse the dispatch plan machinery with a synthetic top-1 routing of
        # the received rows; invalid rows route to expert 0 with zero data.
        rt = RoutingResult(
            expert_indices=jnp.where(valid, eid, 0)[:, None].astype(jnp.int32),
            expert_weights=jnp.ones((recv_x.shape[0], 1), jnp.float32),
            tokens_per_expert=jnp.bincount(
                jnp.where(valid, eid, 0).astype(jnp.int32), length=e_local
            ).astype(jnp.int32),
            expert_token_offsets=None,  # rebuilt below
        )
        tpe_all = rt.tokens_per_expert
        rt = RoutingResult(
            rt.expert_indices, rt.expert_weights, tpe_all,
            jnp.concatenate(
                [jnp.zeros((1,), jnp.int32), jnp.cumsum(tpe_all)]
            ).astype(jnp.int32),
        )
        plan = make_dispatch_plan(rt, e_local, tile_m=tile_m)
        xs = dispatch(jnp.where(valid[:, None], recv_x, 0.0), rt, plan)
        qt_loc = _qt_local(qt, packed, scales, zps, e_local)
        y = _grouped_local(xs, plan.tile_group_ids, qt_loc, tile_m, interpret)
        y_rows = y[plan.rows]  # back to recv order [n_dev*cap, N]
        y_rows = jnp.where(valid[:, None], y_rows, 0.0)

        # return trip
        y_send = y_rows.reshape(n_dev, cap, -1)
        y_recv = jax.lax.all_to_all(y_send, axis, 0, 0, tiled=False)
        # gather my pairs' results from [n_dev, cap, N] by (dest_dev, slot)
        per_pair = y_recv[dest_dev, jnp.clip(slot, 0, cap - 1)]
        per_pair = jnp.where(keep[:, None], per_pair, 0.0)
        per_pair = per_pair.reshape(t_loc, top_k, -1)
        w = routing.expert_weights.astype(per_pair.dtype)[..., None]
        return jnp.sum(per_pair * w, axis=1)

    specs_in = (
        P(axis, None), P(axis, None),
        P(axis, None, None), P(axis, None), P(axis, None),
    )
    return shard_map(
        body, mesh=mesh, in_specs=specs_in, out_specs=P(axis, None),
        check_vma=False,
    )(x, router_logits, qt.packed, qt.scales, qt.zero_points)


# ---------------------------------------------------------------------------
# EP strategy 3: DROPLESS all_to_all via the ragged collective
# ---------------------------------------------------------------------------


def _ragged_a2a(operand, output, in_off, send_sizes, out_off, recv_sizes,
                *, axis, emulate):
    """`jax.lax.ragged_all_to_all`, with a pure-collective emulation for
    backends that lack the HLO (XLA:CPU): all_gather everything, then each
    receiver masks/scatters the chunks addressed to it. Semantically
    identical; only the native path has ragged interconnect traffic."""
    if not emulate:
        return jax.lax.ragged_all_to_all(
            operand, output, in_off, send_sizes, out_off, recv_sizes,
            axis_name=axis,
        )
    me = jax.lax.axis_index(axis)
    n_dev = jax.lax.axis_size(axis)
    ops_all = jax.lax.all_gather(operand, axis)        # [D, P, ...]
    in_all = jax.lax.all_gather(in_off, axis)          # [D, D]
    send_all = jax.lax.all_gather(send_sizes, axis)    # [D, D]
    out_all = jax.lax.all_gather(out_off, axis)        # [D, D]
    p_max = operand.shape[0]
    r = output.shape[0]
    res = output
    for j in range(n_dev):
        size = send_all[j, me]
        src = in_all[j, me] + jnp.arange(p_max, dtype=jnp.int32)
        rows = ops_all[j][jnp.clip(src, 0, p_max - 1)]
        dst = out_all[j, me] + jnp.arange(p_max, dtype=jnp.int32)
        dst = jnp.where(jnp.arange(p_max) < size, dst, r)  # OOB -> dropped
        res = res.at[dst].set(rows, mode="drop")
    return res


def moe_ep_a2a_dropless(
    x: jnp.ndarray,             # [T, H], sharded over the expert axis (dim 0)
    router_logits: jnp.ndarray,  # [T, E], sharded likewise
    qt: QuantizedTensor,        # stacked [E, N, K], sharded over axis 0
    mesh: Mesh,
    *,
    top_k: int,
    axis: str = "expert",
    recv_rows: Optional[int] = None,
    tile_m: int = 16,
    interpret: Optional[bool] = None,
) -> jnp.ndarray:
    """Dropless EP MoE: sort-by-destination + ragged all_to_all exchange.

    The capacity path (:func:`moe_ep_a2a`) drops pairs beyond a
    static per-destination capacity; this strategy never drops. Per device:

      1. route local tokens, stable-sort the (token, k) pairs by destination
         device (expert // E_local) — contiguous per-destination chunks;
      2. all_gather the [D] per-destination count vector (D*D i32 — noise)
         and derive the ragged exchange offsets;
      3. `jax.lax.ragged_all_to_all` the token rows AND their local expert
         ids over NVLink — the collective moves only the REAL rows; the recv
         buffer is a static worst case (see below) but padding rows are
         never transmitted;
      4. local sort-by-expert -> grouped INT4 kernel -> un-sort;
      5. ragged all_to_all the results straight back into the sender's
         sorted pair order (exact [T*k, N] buffer, no padding), un-sort,
         weighted-combine.

    interconnect-bytes accounting (per device, H = hidden, N = out dim, P = T*top_k
    local pairs): forward moves exactly `sum(real pairs sent) * (H + 4)`
    bytes and the return `P * N` bytes — both scale with the ACTUAL routed
    load, unlike the capacity path whose static buffers always move
    `D * C * H`. The only worst-case cost is recv-buffer memory and grouped-GEMM
    grid size: `recv_rows` defaults to the dropless bound P * D (every
    global pair routed to one device); pass a smaller bound when the router
    is load-balanced and you can tolerate that bound being a hard guarantee
    you provide (rows beyond it would corrupt the exchange).

    Returns [T, N] sharded like x.
    """
    e = qt.shape[0]
    n_dev = mesh.shape[axis]
    e_local = e // n_dev
    if e_local * n_dev != e:
        raise ValueError(f"num_experts={e} not divisible by mesh axis {n_dev}")
    # XLA:CPU has no ragged all-to-all; there the semantically identical
    # all_gather emulation runs (tests, virtual CPU meshes)
    emulate = not platform.native_ragged_all_to_all()

    def body(xb, logits, packed, scales, zps):
        t_loc, h = xb.shape
        pairs = t_loc * top_k
        me = jax.lax.axis_index(axis)

        routing = topk_route(logits, top_k, e)
        flat_ids = routing.expert_indices.reshape(-1)          # [P]
        dest = (flat_ids // e_local).astype(jnp.int32)

        sort_idx = jnp.argsort(dest, stable=True)              # sorted by dest
        inv = jnp.zeros((pairs,), jnp.int32).at[sort_idx].set(
            jnp.arange(pairs, dtype=jnp.int32)
        )
        xrep = jnp.repeat(xb, top_k, axis=0)
        x_send = xrep[sort_idx]                                # [P, H]
        eid_send = (flat_ids % e_local).astype(jnp.int32)[sort_idx][:, None]

        counts = jnp.bincount(dest, length=n_dev).astype(jnp.int32)  # [D]
        excl = lambda c: jnp.concatenate(  # noqa: E731
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(c)[:-1]]
        ).astype(jnp.int32)
        in_off = excl(counts)
        # counts_all[j, i] = rows device j sends to device i
        counts_all = jax.lax.all_gather(counts, axis)          # [D, D]
        # my chunk lands on receiver i after all senders j < me
        out_off = jnp.cumsum(
            jnp.where(jnp.arange(n_dev)[:, None] < me, counts_all, 0), axis=0
        )[-1].astype(jnp.int32)                                # [D]
        recv_sizes = counts_all[:, me].astype(jnp.int32)       # [D]

        r = recv_rows or pairs * n_dev
        recv_x = _ragged_a2a(
            x_send, jnp.zeros((r, h), x_send.dtype),
            in_off, counts, out_off, recv_sizes, axis=axis, emulate=emulate,
        )
        recv_eid = _ragged_a2a(
            eid_send, jnp.full((r, 1), -1, jnp.int32),
            in_off, counts, out_off, recv_sizes, axis=axis, emulate=emulate,
        )[:, 0]

        # local grouped GEMM over my experts (same synthetic top-1 routing
        # device as the capacity path)
        valid = recv_eid >= 0
        eid = jnp.where(valid, recv_eid, 0)
        tpe = jnp.bincount(eid, length=e_local).astype(jnp.int32)
        # invalid rows are all zeros; they route to expert 0 and are sliced
        # off by the return exchange (only real rows are sent back)
        rt = RoutingResult(
            expert_indices=eid[:, None],
            expert_weights=jnp.ones((r, 1), jnp.float32),
            tokens_per_expert=tpe,
            expert_token_offsets=jnp.concatenate(
                [jnp.zeros((1,), jnp.int32), jnp.cumsum(tpe)]
            ).astype(jnp.int32),
        )
        plan = make_dispatch_plan(rt, e_local, tile_m=tile_m)
        xs = dispatch(jnp.where(valid[:, None], recv_x, 0.0), rt, plan)
        qt_loc = _qt_local(qt, packed, scales, zps, e_local)
        y = _grouped_local(xs, plan.tile_group_ids, qt_loc, tile_m, interpret)
        y_rows = y[plan.rows]                                  # recv order

        # return trip: my buffer is chunked by ORIGINAL sender (offsets =
        # exclusive cumsum of recv_sizes); each chunk goes back to its
        # sender and must land at that sender's in_off for me —
        # in_off_all[i, me] = sum_{d < me} counts_all[i, d].
        ret_in_off = excl(recv_sizes)
        in_off_all = jnp.cumsum(
            jnp.where(jnp.arange(n_dev)[None, :] < me, counts_all, 0), axis=1
        )[:, -1].astype(jnp.int32)                             # [D]
        y_back = _ragged_a2a(
            y_rows, jnp.zeros((pairs, y_rows.shape[1]), y_rows.dtype),
            ret_in_off, recv_sizes, in_off_all, counts, axis=axis,
            emulate=emulate,
        )
        per_pair = y_back[inv].reshape(t_loc, top_k, -1)
        w = routing.expert_weights.astype(per_pair.dtype)[..., None]
        return jnp.sum(per_pair * w, axis=1)

    specs_in = (
        P(axis, None), P(axis, None),
        P(axis, None, None), P(axis, None), P(axis, None),
    )
    return shard_map(
        body, mesh=mesh, in_specs=specs_in, out_specs=P(axis, None),
        check_vma=False,
    )(x, router_logits, qt.packed, qt.scales, qt.zero_points)


# ---------------------------------------------------------------------------
# EP strategy 4: ring rotation with communication/compute OVERLAP
# ---------------------------------------------------------------------------


def moe_ep_ring(
    x: jnp.ndarray,             # [T, H], sharded over the expert axis (dim 0)
    router_logits: jnp.ndarray,  # [T, E], sharded likewise
    qt: QuantizedTensor,        # stacked [E, N, K], sharded over axis 0
    mesh: Mesh,
    *,
    top_k: int,
    axis: str = "expert",
    tile_m: int = 16,
    interpret: Optional[bool] = None,
) -> jnp.ndarray:
    """Dropless EP MoE with a ring-pipelined exchange (comm/compute overlap).

    The aim is all-to-all dispatch overlapped with expert compute. A monolithic all_to_all is a barrier: nothing computes
    while it flies. This strategy decomposes the exchange into D ring steps
    (`ppermute` to the next device) and keeps compute inside the loop:

      step i:   contrib  = my_experts(visiting block)      (grouped GEMM)
                x_next   = ppermute(visiting block)        (NVLink)
                y_next   = ppermute(y_acc + contrib)       (NVLink)

    ``x_next``/routing forwarding carries NO data dependence on ``contrib``
    — XLA's latency-hiding scheduler is free to start the ppermute while the
    grouped GEMM runs, so the token-block transfer rides NVLink behind compute;
    only the (y_acc + contrib) return hop serializes. Every token block
    visits all D devices and arrives home after D steps carrying the full
    top-k sum — DROPLESS (per-device masked dispatch, no capacity buffers).

    interconnect bytes per device per layer: D * T_loc * (H*x_bytes + N*x_bytes + ~8)
    — more x-traffic than the ragged a2a (which moves each pair once), in
    exchange for overlap and zero routing-dependent buffer sizing. Prefer
    this strategy when expert compute per step >= the per-hop transfer time
    (large N/E_local), the a2a strategies otherwise.

    Returns [T, N] sharded like x.
    """
    e = qt.shape[0]
    n_dev = mesh.shape[axis]
    e_local = e // n_dev
    if e_local * n_dev != e:
        raise ValueError(f"num_experts={e} not divisible by mesh axis {n_dev}")
    n_out = qt.shape[1]
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    def body(xb, logits, packed, scales, zps):
        t_loc, h = xb.shape
        me = jax.lax.axis_index(axis)
        lo = me * e_local
        routing = topk_route(logits, top_k, e)
        qt_loc = _qt_local(qt, packed, scales, zps, e_local)

        def contrib(xblk, eidblk, wblk):
            return _local_contrib(
                xblk, eidblk, wblk, lo, e_local, qt_loc, tile_m, interpret
            )

        def step(_, carry):
            xblk, eidblk, wblk, yblk = carry
            c = contrib(xblk, eidblk, wblk)
            # x/routing forwarding is independent of `c` -> overlappable
            x_nxt = jax.lax.ppermute(xblk, axis, perm)
            e_nxt = jax.lax.ppermute(eidblk, axis, perm)
            w_nxt = jax.lax.ppermute(wblk, axis, perm)
            y_nxt = jax.lax.ppermute(yblk + c.astype(yblk.dtype), axis, perm)
            return (x_nxt, e_nxt, w_nxt, y_nxt)

        y0 = jnp.zeros((t_loc, n_out), jnp.float32)
        carry = (xb, routing.expert_indices, routing.expert_weights, y0)
        carry = jax.lax.fori_loop(0, n_dev, step, carry)
        # After D rotations the accumulator is home with every device's
        # expert contributions summed.
        return carry[3].astype(x.dtype)

    specs_in = (
        P(axis, None), P(axis, None),
        P(axis, None, None), P(axis, None), P(axis, None),
    )
    return shard_map(
        body, mesh=mesh, in_specs=specs_in, out_specs=P(axis, None),
        check_vma=False,
    )(x, router_logits, qt.packed, qt.scales, qt.zero_points)


# ---------------------------------------------------------------------------
# Tensor parallelism for the fused linear kernel
# ---------------------------------------------------------------------------


def tp_int4_matmul(
    x: jnp.ndarray,            # [..., K], replicated over `axis`
    qt: QuantizedTensor,       # [N, K], sharded over N on `axis`
    mesh: Mesh,
    *,
    axis: str = "model",
    gather_output: bool = True,
    interpret: Optional[bool] = None,
):
    """Column-parallel fused INT4 linear: each device computes its N-shard
    with the Pallas kernel; optionally all-gather to the full [.., N]."""
    n = qt.out_dim
    n_dev = mesh.shape[axis]
    if n % n_dev != 0:
        raise ValueError(f"N={n} not divisible by mesh axis {n_dev}")

    def body(xb, packed, scales, zps):
        qt_loc = QuantizedTensor(
            packed=packed, scales=scales, zero_points=zps,
            shape=(n // n_dev, qt.in_dim),
            granularity=qt.granularity, layout=qt.layout,
            block_k=qt.block_k, group_size=qt.group_size, bits=qt.bits,
        )
        y = int4_matmul(xb, qt_loc, interpret=interpret)
        if gather_output:
            y = jax.lax.all_gather(y, axis, axis=y.ndim - 1, tiled=True)
        return y

    out_spec = P() if gather_output else P(*([None] * (x.ndim - 1) + [axis]))
    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis), P(axis)),
        out_specs=out_spec, check_vma=False,
    )(x, qt.packed, qt.scales, qt.zero_points)
