"""Pipeline parallelism: a `stage` mesh axis + GPipe-style microbatch rotation.

The reference has no distributed support at all (SURVEY.md §2.5 — PP row:
absent). This module wires the JAX-native version: homogeneous stages stacked on the leading axis of a
params pytree, sharded over a mesh ``stage`` axis, executed under one
`shard_map` with a `ppermute` ring carrying activations downstream each step.

The schedule is inference GPipe: with S stages and M microbatches the loop
runs ``M + S - 1`` steps; stage s computes microbatch ``t - s`` at step t
(bubble steps compute-and-discard on zero/stale data — a static-shape
trade: every step is the same fully static program, no per-stage control flow).
Activations move stage→stage over NVLink as a point-to-point `ppermute`, which
XLA's latency-hiding scheduler can overlap with the next microbatch's
compute — the same overlap structure as `expert_parallel.moe_ep_ring`.

Constraints: all stages share one activation shape/dtype (true for
transformer trunks), and `num_layers % num_stages == 0` when stacking with
:func:`stack_stage_params`.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["stack_stage_params", "pipeline_stages"]


def stack_stage_params(per_stage_params: list) -> Any:
    """Stack S per-stage param pytrees on a new leading `stage` axis.

    The result's leaves are [S, ...] arrays suitable for `P('stage', ...)`
    sharding — each device of the stage axis holds exactly its own stage's
    parameters after placement.
    """
    return jax.tree.map(lambda *ls: jnp.stack(ls), *per_stage_params)


def pipeline_stages(
    stage_fn: Callable[[Any, jnp.ndarray], jnp.ndarray],
    params: Any,                 # leaves [S, ...], sharded P(axis, ...)
    x: jnp.ndarray,              # [M, mb, ...] microbatched input (replicated)
    mesh: Mesh,
    *,
    axis: str = "stage",
) -> jnp.ndarray:
    """Run ``stage_fn`` S times over ``x``'s microbatches, pipelined.

    ``stage_fn(stage_params, act) -> act`` is one stage's compute, with
    ``stage_params`` the params pytree minus the stacked leading dim. The
    composition ``stage_{S-1}(... stage_0(x))`` is returned, microbatch by
    microbatch, replicated across the stage axis.
    """
    n_stages = mesh.shape[axis]
    m = x.shape[0]

    def body(params_local, x_all):
        # params_local leaves are [1, ...] local shards; drop the stage dim.
        p_loc = jax.tree.map(lambda a: a[0], params_local)
        s = jax.lax.axis_index(axis)
        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

        def step(t, carry):
            act, y_acc = carry
            # stage 0 reads a fresh microbatch; later stages use the ring.
            mb_in = x_all[jnp.clip(t, 0, m - 1)]
            inp = jnp.where(s == 0, mb_in.astype(act.dtype), act)
            out = stage_fn(p_loc, inp)
            # the last stage finishes microbatch t-(S-1) at step t
            done = t - (n_stages - 1)
            valid = (s == n_stages - 1) & (done >= 0) & (done < m)
            idx = jnp.clip(done, 0, m - 1)
            y_acc = y_acc.at[idx].set(
                jnp.where(valid, out.astype(y_acc.dtype), y_acc[idx])
            )
            act_next = jax.lax.ppermute(out, axis, perm)
            return act_next, y_acc

        act0 = jnp.zeros_like(x_all[0])
        y0 = jnp.zeros((m,) + x_all.shape[1:], x_all.dtype)
        _, y = jax.lax.fori_loop(0, m + n_stages - 1, step, (act0, y0))
        # y is populated only on the last stage; broadcast it to every
        # stage so the caller sees a replicated result.
        return jax.lax.psum(
            jnp.where(s == n_stages - 1, y, jnp.zeros_like(y)), axis
        )

    pspec = jax.tree.map(
        lambda a: P(axis, *([None] * (a.ndim - 1))), params
    )
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(pspec, P()),
        out_specs=P(),
        check_vma=False,
    )(params, x)
