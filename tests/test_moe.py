"""MoE routing / dispatch / grouped-kernel tests.

Coverage the reference never had (SURVEY.md §4 gaps): the reference ships
ZERO tests for its MoE CUDA kernel, routing dispatch/combine, or the MoE
quantizer. Here every stage is validated against a dense golden reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fused4bit.layers.moe import (
    MoEINT4,
    QuantizedMoE,
    combine,
    dispatch,
    make_dispatch_plan,
    simulate_router_logits,
    topk_route,
)
from fused4bit.ops.grouped_matmul import grouped_int4_matmul
from fused4bit.quant import dequantize, quantize


def randw(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape), dtype=jnp.float32)


E, K, N, T, TOPK = 4, 128, 96, 33, 2
TILE_M = 8


class TestRouting:
    def test_topk_route_shapes_and_renorm(self, rng):
        logits = randw(rng, T, E)
        r = topk_route(logits, TOPK, E)
        assert r.expert_indices.shape == (T, TOPK)
        assert r.expert_weights.shape == (T, TOPK)
        np.testing.assert_allclose(
            np.asarray(jnp.sum(r.expert_weights, axis=-1)), 1.0, atol=1e-5
        )
        assert int(jnp.sum(r.tokens_per_expert)) == T * TOPK
        assert int(r.expert_token_offsets[-1]) == T * TOPK

    def test_topk_picks_argmax(self, rng):
        logits = jnp.asarray(np.eye(E)[np.arange(T) % E] * 10.0, jnp.float32)
        r = topk_route(logits, 1, E)
        np.testing.assert_array_equal(
            np.asarray(r.expert_indices[:, 0]), np.arange(T) % E
        )

    @pytest.mark.parametrize("dist", ["uniform", "skewed", "random"])
    def test_simulated_distributions(self, dist):
        key = jax.random.PRNGKey(0)
        logits = simulate_router_logits(key, 256, E, dist)
        r = topk_route(logits, TOPK, E)
        counts = np.asarray(r.tokens_per_expert)
        assert counts.sum() == 256 * TOPK
        if dist == "skewed":
            # Zipf bias: expert 0 should dominate expert E-1 (routing.py:57-62).
            assert counts[0] > counts[-1]


class TestDispatchCombine:
    def test_dispatch_rows_are_group_contiguous(self, rng):
        r = topk_route(randw(rng, T, E), TOPK, E)
        plan = make_dispatch_plan(r, E, tile_m=TILE_M)
        rows = np.asarray(plan.rows)
        ids = np.asarray(r.expert_indices.reshape(-1))
        # every destination row unique
        assert len(set(rows.tolist())) == len(rows)
        # rows of expert e all live in e's padded segment, tile-aligned start
        sizes = np.asarray(r.tokens_per_expert)
        padded = ((sizes + TILE_M - 1) // TILE_M) * TILE_M
        offs = np.concatenate([[0], np.cumsum(padded)])
        for e in range(E):
            rws = np.sort(rows[ids == e])
            if len(rws):
                assert rws[0] == offs[e]
                assert rws[-1] < offs[e] + sizes[e]
                assert (rws == np.arange(offs[e], offs[e] + len(rws))).all()

    def test_tile_group_ids(self, rng):
        r = topk_route(randw(rng, T, E), TOPK, E)
        plan = make_dispatch_plan(r, E, tile_m=TILE_M)
        gids = np.asarray(plan.tile_group_ids)
        sizes = np.asarray(r.tokens_per_expert)
        padded = ((sizes + TILE_M - 1) // TILE_M) * TILE_M
        want = np.concatenate(
            [np.full(p // TILE_M, e) for e, p in enumerate(padded)]
        )
        np.testing.assert_array_equal(gids[: len(want)], want)

    def test_dispatch_combine_identity(self, rng):
        """combine(dispatch(x)) with identity expert == x (weights sum to 1)."""
        x = randw(rng, T, K)
        r = topk_route(randw(rng, T, E), TOPK, E)
        plan = make_dispatch_plan(r, E, tile_m=TILE_M)
        buf = dispatch(x, r, plan)
        out = combine(buf, r, plan)
        np.testing.assert_allclose(np.asarray(out), np.asarray(x), atol=1e-5)

    def test_dispatch_pads_with_zeros(self, rng):
        x = randw(rng, T, K)
        r = topk_route(randw(rng, T, E), TOPK, E)
        plan = make_dispatch_plan(r, E, tile_m=TILE_M)
        buf = np.asarray(dispatch(x, r, plan))
        rows = set(np.asarray(plan.rows).tolist())
        for i in range(buf.shape[0]):
            if i not in rows:
                assert (buf[i] == 0).all()


class TestGroupedKernel:
    def _setup(self, rng, t=T, dist_seed=1):
        w = randw(rng, E, N, K)
        qt = quantize(w, layout="planar")
        x = randw(rng, t, K)
        logits = randw(rng, t, E)
        r = topk_route(logits, TOPK, E)
        plan = make_dispatch_plan(r, E, tile_m=TILE_M)
        xs = dispatch(x, r, plan)
        return w, qt, x, r, plan, xs

    def _golden(self, qt, xs, plan):
        w = dequantize(qt, dtype=jnp.float32)
        tile_m = plan.tile_m
        nt = plan.t_pad // tile_m
        xt = xs.reshape(nt, tile_m, -1).astype(jnp.float32)
        wt = w[plan.tile_group_ids]
        out = jnp.einsum("tmk,tnk->tmn", xt, wt, precision=jax.lax.Precision.HIGHEST)
        return out.reshape(plan.t_pad, -1)

    def test_grouped_matches_golden(self, rng):
        w, qt, x, r, plan, xs = self._setup(rng)
        got = grouped_int4_matmul(xs, plan.tile_group_ids, qt, tile_m=TILE_M)
        want = self._golden(qt, xs, plan)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-3)

    def test_end_to_end_vs_dense_moe(self, rng):
        """dispatch -> grouped INT4 GEMM -> combine == dense per-token MoE."""
        w, qt, x, r, plan, xs = self._setup(rng)
        y = grouped_int4_matmul(xs, plan.tile_group_ids, qt, tile_m=TILE_M)
        got = combine(y, r, plan)
        wd = dequantize(qt, dtype=jnp.float32)
        we = wd[r.expert_indices]
        want = jnp.sum(
            jnp.einsum("tk,tenk->ten", x.astype(jnp.float32), we)
            * r.expert_weights[..., None],
            axis=1,
        )
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-3)

    def test_skewed_routing(self, rng):
        """All tokens to one expert — the reference kernel's broken case."""
        w = randw(rng, E, N, K)
        qt = quantize(w, layout="planar")
        t = 24
        x = randw(rng, t, K)
        logits = jnp.zeros((t, E)).at[:, 1].set(100.0)
        r = topk_route(logits, 1, E)
        plan = make_dispatch_plan(r, E, tile_m=TILE_M)
        xs = dispatch(x, r, plan)
        y = grouped_int4_matmul(xs, plan.tile_group_ids, qt, tile_m=TILE_M)
        got = combine(y, r, plan)
        want = x.astype(jnp.float32) @ dequantize(qt, jnp.float32)[1].T
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-3)

    def test_moe_int4_module(self, rng):
        w, qt, x, r, plan, xs = self._setup(rng)
        mod = MoEINT4.from_dense(w)
        got = mod(xs, plan.tile_group_ids, tile_m=TILE_M)
        ref = MoEINT4(weight=mod.weight, use_kernel=False)
        want = ref(xs, plan.tile_group_ids)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-3)

    def test_quantized_moe_baseline(self, rng):
        w, qt, x, r, plan, xs = self._setup(rng)
        qm = QuantizedMoE.from_dense(w)
        out = qm(x, r)
        assert out.shape == (T, N)
        assert qm.total_memory_bytes() < w.size * 4 / 7  # >7x reduction

    def test_per_tensor_expert_quantization(self, rng):
        """Reference MoE quantizer granularity (`python/moe_int4_module.py:
        44-54`): one scalar scale/zp per expert."""
        w = randw(rng, E, N, K)
        qt = quantize(w, granularity="per_tensor", layout="planar")
        assert qt.scales.shape == (E,)
        err = jnp.max(jnp.abs(dequantize(qt) - w))
        assert float(err) < 0.8

    # The Triton-route grouped kernel in the Pallas interpreter: each program
    # reads its expert from a mixed tile->expert map (empty experts, several
    # tiles per expert, trailing padding tiles).
    GIDS = [0, 0, 0, 2, 3, 3, 3, 3]   # expert 1 empty, last tiles padding

    def _golden_tiles(self, xs, gids, qt, tile_m):
        wd = dequantize(qt, dtype=jnp.float32)
        xt = xs.reshape(len(gids), tile_m, -1).astype(jnp.float32)
        return jnp.einsum(
            "tmk,tnk->tmn", xt, wd[jnp.asarray(gids)],
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(xs.shape[0], -1)

    @pytest.mark.parametrize(
        "gran,layout,n,k",
        [
            ("per_row", "planar", 96, 256),
            ("per_group", "planar", 80, 512),
            ("per_group", "planar_groups", 48, 768),
        ],
    )
    def test_matches_golden(self, rng, gran, layout, n, k):
        kw = dict(group_size=128) if gran == "per_group" else {}
        qt = quantize(randw(rng, E, n, k), granularity=gran, layout=layout, **kw)
        gids = jnp.asarray(self.GIDS, jnp.int32)
        xs = randw(rng, len(self.GIDS) * 16, k)
        got = grouped_int4_matmul(xs, gids, qt, tile_m=16, interpret=True)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(self._golden_tiles(xs, self.GIDS, qt, 16)),
            atol=2e-3,
        )

    def test_rows_do_not_depend_on_the_experts_held(self, rng):
        """An expert's rows come out bit for bit the same whether the launch
        holds all 8 experts (one card) or 2 of them (one card of a 4-card
        expert-parallel mesh): the blocks, and so the order of the float32
        sums, do not follow the launch's tile count."""
        import dataclasses as dc

        e, n, k = 8, 64 * 100, 1024
        qt = quantize(randw(rng, e, n, k), layout="planar")
        xs = randw(rng, 9 * 16, k).astype(jnp.bfloat16)
        run = jax.jit(lambda a, g, q: grouped_int4_matmul(
            a, g, q, tile_m=16, out_dtype=jnp.float32, interpret=True))
        every = run(xs, jnp.asarray([0, 1, 2, 3, 4, 5, 6, 7, 7]), qt)
        two = dc.replace(qt, packed=qt.packed[2:4], scales=qt.scales[2:4],
                         zero_points=qt.zero_points[2:4], shape=(2, n, k))
        held = run(xs[32:80], jnp.asarray([0, 1, 1]), two)
        np.testing.assert_array_equal(np.asarray(held[:32]),
                                      np.asarray(every[32:64]))

    def test_plain_path_matches_golden(self, rng):
        from fused4bit.ops.grouped_matmul import grouped_int4_matmul_plain

        qt = quantize(randw(rng, E, 64, 256), layout="planar")
        gids = jnp.asarray(self.GIDS, jnp.int32)
        xs = randw(rng, len(self.GIDS) * 16, 256)
        got = grouped_int4_matmul_plain(xs, gids, qt, 16, jnp.float32)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(self._golden_tiles(xs, self.GIDS, qt, 16)),
            atol=1e-3,
        )

    def test_bf16_end_to_end_through_dispatch(self, rng):
        qt = quantize(randw(rng, E, N, K), layout="planar")
        x = randw(rng, T, K).astype(jnp.bfloat16)
        r = topk_route(randw(rng, T, E), TOPK, E)
        plan = make_dispatch_plan(r, E, tile_m=16)
        xs = dispatch(x, r, plan)
        got = grouped_int4_matmul(xs, plan.tile_group_ids, qt, tile_m=16,
                                  interpret=True)
        assert got.dtype == jnp.bfloat16
        want = self._golden_tiles(xs, np.asarray(plan.tile_group_ids), qt, 16)
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want), atol=0.1, rtol=0.02)

    def test_groups_straddling_halves_take_plain_path(self, rng):
        qt = quantize(randw(rng, E, 32, 192), granularity="per_group",
                      group_size=64, layout="planar")  # K/2 = 96, not 64 | 96
        gids = jnp.asarray(self.GIDS, jnp.int32)
        xs = randw(rng, len(self.GIDS) * 16, 192)
        got = MoEINT4(weight=qt)(xs, gids, tile_m=16, interpret=True)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(self._golden_tiles(xs, self.GIDS, qt, 16)),
            atol=1e-3,
        )


class TestCapacityPlan:
    def test_capacity_layout_is_per_expert_blocks(self, rng):
        from fused4bit.layers.moe import make_capacity_plan

        r = topk_route(randw(rng, T, E), TOPK, E)
        cap = 24
        plan = make_capacity_plan(r, E, capacity=cap, tile_m=8)
        assert plan.t_pad == E * cap
        rows = np.asarray(plan.rows)
        ids = np.asarray(r.expert_indices.reshape(-1))
        for p_, e_ in zip(rows, ids):
            if p_ < plan.t_pad:  # kept
                assert e_ * cap <= p_ < (e_ + 1) * cap

    def test_capacity_matches_dropless_with_ample_capacity(self, rng):
        from fused4bit.layers.moe import make_capacity_plan

        w = randw(rng, E, N, K)
        qt = quantize(w, layout="planar")
        x = randw(rng, T, K)
        r = topk_route(randw(rng, T, E), TOPK, E)

        plan_d = make_dispatch_plan(r, E, tile_m=TILE_M)
        y_d = combine(
            grouped_int4_matmul(dispatch(x, r, plan_d), plan_d.tile_group_ids,
                                qt, tile_m=TILE_M), r, plan_d)

        cap = size = 72  # > any group, multiple of tile_m
        from fused4bit.layers.moe import make_capacity_plan
        plan_c = make_capacity_plan(r, E, capacity=cap, tile_m=TILE_M)
        y_c = combine(
            grouped_int4_matmul(dispatch(x, r, plan_c), plan_c.tile_group_ids,
                                qt, tile_m=TILE_M), r, plan_c)
        np.testing.assert_allclose(np.asarray(y_c), np.asarray(y_d), atol=1e-3)

    def test_capacity_drops_overflow_gracefully(self, rng):
        from fused4bit.layers.moe import make_capacity_plan

        w = randw(rng, E, N, K)
        qt = quantize(w, layout="planar")
        x = randw(rng, T, K)
        logits = jnp.zeros((T, E)).at[:, 0].set(50.0)  # all to expert 0
        r = topk_route(logits, 1, E)
        plan = make_capacity_plan(r, E, capacity=8, tile_m=8)  # only 8 kept
        y = combine(
            grouped_int4_matmul(dispatch(x, r, plan), plan.tile_group_ids,
                                qt, tile_m=8), r, plan)
        arr = np.asarray(y)
        assert not np.any(np.isnan(arr))
        assert np.abs(arr[:8]).sum() > 0       # kept tokens computed
        assert np.abs(arr[8:]).sum() == 0      # dropped tokens -> zero


class TestObservability:
    def test_expert_load_stats(self, rng):
        from fused4bit.layers.moe import expert_load_stats

        r = topk_route(randw(rng, T, E), TOPK, E)
        stats = expert_load_stats(r)
        np.testing.assert_allclose(float(jnp.sum(stats["load_fraction"])), 1.0, atol=1e-6)
        assert float(stats["imbalance"]) >= 1.0
        assert int(stats["dropped"]) == 0

    def test_expert_load_stats_drops(self):
        from fused4bit.layers.moe import expert_load_stats

        logits = jnp.zeros((20, E)).at[:, 0].set(50.0)
        r = topk_route(logits, 1, E)
        stats = expert_load_stats(r, capacity=8)
        assert int(stats["dropped"]) == 12


class TestMultihost:
    def test_initialize_noop_single_process(self):
        from fused4bit.parallel.multihost import initialize, is_multihost

        assert initialize() is False
        assert is_multihost() is False


class TestGroupedPerGroup:
    def test_grouped_per_group_matches_golden(self, rng):
        E2, K2, N2 = 4, 512, 96  # K/2=256, groups of 128
        w = randw(rng, E2, N2, K2)
        qt = quantize(w, granularity="per_group", group_size=128, layout="planar")
        x = randw(rng, T, K2)
        r = topk_route(randw(rng, T, E2), TOPK, E2)
        plan = make_dispatch_plan(r, E2, tile_m=TILE_M)
        xs = dispatch(x, r, plan)
        got = grouped_int4_matmul(xs, plan.tile_group_ids, qt, tile_m=TILE_M,
                                  interpret=True)
        wd = dequantize(qt, dtype=jnp.float32)
        nt = plan.t_pad // TILE_M
        xt = xs.reshape(nt, TILE_M, -1).astype(jnp.float32)
        want = jnp.einsum("tmk,tnk->tmn", xt, wd[plan.tile_group_ids],
                          precision=jax.lax.Precision.HIGHEST).reshape(plan.t_pad, -1)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-3)

    def test_grouped_per_group_bp_matches_golden(self, rng):
        """Group-major per-group weights (layout="planar_groups"): same
        contract as the planar layout above. Covers an odd group count
        (gh=3) and a ragged last n-block."""
        for E2, K2, N2 in [(4, 512, 96), (3, 768, 320)]:
            w = randw(rng, E2, N2, K2)
            qt = quantize(w, granularity="per_group", group_size=128,
                          layout="planar_groups")
            x = randw(rng, T, K2)
            r = topk_route(randw(rng, T, E2), TOPK, E2)
            plan = make_dispatch_plan(r, E2, tile_m=TILE_M)
            xs = dispatch(x, r, plan)
            got = grouped_int4_matmul(
                xs, plan.tile_group_ids, qt, tile_m=TILE_M, interpret=True
            )
            wd = dequantize(qt, dtype=jnp.float32)
            nt = plan.t_pad // TILE_M
            xt = xs.reshape(nt, TILE_M, -1).astype(jnp.float32)
            want = jnp.einsum(
                "tmk,tnk->tmn", xt, wd[plan.tile_group_ids],
                precision=jax.lax.Precision.HIGHEST,
            ).reshape(plan.t_pad, -1)
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(want), atol=2e-3,
                err_msg=str((E2, K2, N2)),
            )

    def test_moe_module_dispatches_per_group(self, rng):
        E2, K2, N2 = 4, 512, 96
        w = randw(rng, E2, N2, K2)
        mod = MoEINT4.from_dense(w, granularity="per_group", group_size=128)
        # from_dense picks the group-major layout when 128 | gs | K/2
        assert mod.weight.layout == "planar_groups"
        x = randw(rng, T, K2)
        r = topk_route(randw(rng, T, E2), TOPK, E2)
        plan = make_dispatch_plan(r, E2, tile_m=TILE_M)
        xs = dispatch(x, r, plan)
        got = mod(xs, plan.tile_group_ids, tile_m=TILE_M)
        assert got.shape == (plan.t_pad, N2)
