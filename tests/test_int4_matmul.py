"""Fused kernel vs golden reference — the reference's correctness ladder level 3.

Mirrors `tests/test_correctness.py:189-253` (CUDA-vs-reference) with the same
tolerance ladder: atol 1e-3 for small/batched shapes, 1e-2 for large shapes
(f32 accumulation-order differences). Wrapper tests run the plain path on the
CPU; tests that pass ``interpret=True`` run the Triton-route Pallas kernel in
the interpreter.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fused4bit.layers.linear import QuantizedLinear
from fused4bit.ops.int4_matmul import int4_matmul
from fused4bit.quant import quantize, reference_linear_qt


def randw(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape), dtype=jnp.float32)


class TestInt4Matmul:
    def test_1d_input(self, rng):
        w = randw(rng, 128, 256)
        x = randw(rng, 256)
        qt = quantize(w)
        got = int4_matmul(x, qt)
        want = reference_linear_qt(x, qt)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-3)

    def test_batched(self, rng):
        w = randw(rng, 128, 512)
        x = randw(rng, 4, 512)
        qt = quantize(w)
        np.testing.assert_allclose(
            np.asarray(int4_matmul(x, qt)),
            np.asarray(reference_linear_qt(x, qt)),
            atol=1e-3,
        )

    def test_3d_input(self, rng):
        w = randw(rng, 64, 128)
        x = randw(rng, 2, 3, 128)
        qt = quantize(w)
        got = int4_matmul(x, qt)
        assert got.shape == (2, 3, 64)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(reference_linear_qt(x, qt)), atol=1e-3
        )

    @pytest.mark.parametrize("n,k", [(256, 1024), (384, 11008 // 8)])
    def test_shapes(self, rng, n, k):
        # 1376 = 11008/8: exercises the non-512 block_k path (choose_block_k).
        w = randw(rng, n, k)
        x = randw(rng, 8, k)
        qt = quantize(w)
        np.testing.assert_allclose(
            np.asarray(int4_matmul(x, qt)),
            np.asarray(reference_linear_qt(x, qt)),
            atol=1e-2,
        )

    def test_unaligned_n(self, rng):
        # N not a multiple of the tile: exercises the padding path.
        w = randw(rng, 100, 256)
        x = randw(rng, 3, 256)
        qt = quantize(w)
        got = int4_matmul(x, qt)
        assert got.shape == (3, 100)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(reference_linear_qt(x, qt)), atol=1e-3
        )

    def test_large_tolerance_ladder(self, rng):
        # Reference uses 4096x4096 at atol 1e-2 (:236-253); scaled down for CI
        # speed but still multi-k-tile.
        w = randw(rng, 512, 2048)
        x = randw(rng, 16, 2048)
        qt = quantize(w)
        np.testing.assert_allclose(
            np.asarray(int4_matmul(x, qt)),
            np.asarray(reference_linear_qt(x, qt)),
            atol=1e-2,
        )

    def test_no_nan(self, rng):
        w = jnp.ones((64, 128)) * 2.0  # constant rows
        x = randw(rng, 2, 128)
        qt = quantize(w)
        assert not bool(jnp.any(jnp.isnan(int4_matmul(x, qt))))

    def test_bf16_activations(self, rng):
        w = randw(rng, 128, 256)
        x = randw(rng, 4, 256).astype(jnp.bfloat16)
        qt = quantize(w)
        got = int4_matmul(x, qt)
        assert got.dtype == jnp.bfloat16
        want = reference_linear_qt(x.astype(jnp.float32), qt)
        # bf16 tolerance is looser
        np.testing.assert_allclose(
            np.asarray(got, dtype=np.float32), np.asarray(want), atol=0.15, rtol=0.05
        )


class TestQuantizedLinear:
    def test_from_dense_matches_reference(self, rng):
        w = randw(rng, 96, 128)
        layer = QuantizedLinear.from_dense(w)
        x = randw(rng, 5, 128)
        np.testing.assert_allclose(
            np.asarray(layer(x)),
            np.asarray(reference_linear_qt(x, layer.weight)),
            atol=1e-3,
        )

    def test_bias(self, rng):
        w = randw(rng, 32, 64)
        b = randw(rng, 32)
        layer = QuantizedLinear.from_dense(w, b)
        x = randw(rng, 2, 64)
        got = layer(x)
        want = reference_linear_qt(x, layer.weight) + b
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-3)

    def test_quality_vs_dense(self, rng):
        w = randw(rng, 256, 512)
        x = randw(rng, 512)
        layer = QuantizedLinear.from_dense(w)
        exact = x @ w.T
        approx = layer(x)
        cos = jnp.dot(exact, approx) / (
            jnp.linalg.norm(exact) * jnp.linalg.norm(approx)
        )
        assert float(cos) > 0.95

    def test_memory_reduction(self, rng):
        layer = QuantizedLinear.from_dense(randw(rng, 1024, 1024))
        dense_bytes = 1024 * 1024 * 4
        assert dense_bytes / layer.nbytes >= 7.5

    def test_per_group_falls_back_to_reference_path(self, rng):
        # use_kernel=False is the explicit dequantize-then-matmul path
        w = randw(rng, 64, 256)
        layer = QuantizedLinear.from_dense(
            w, granularity="per_group", group_size=64, use_kernel=False
        )
        x = randw(rng, 2, 256)
        np.testing.assert_allclose(
            np.asarray(layer(x)),
            np.asarray(reference_linear_qt(x, layer.weight)),
            atol=1e-5,
        )


class TestInt4MatmulPerGroup:
    """per_group granularity in the fused kernel (production INT4 standard)."""

    def test_matches_reference(self, rng):
        w = randw(rng, 128, 512)  # K/2=256, group_size=128 -> 2 groups/half
        qt = quantize(w, granularity="per_group", group_size=128, layout="planar")
        x = randw(rng, 8, 512)
        got = int4_matmul(x, qt, interpret=True)
        want = reference_linear_qt(x, qt)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-3)

    def test_matches_reference_many_groups(self, rng):
        """Multi-group and ODD group-count shapes."""
        for n, k in [(64, 1024), (96, 768)]:  # gh = 4 and gh = 3 per half
            w = randw(rng, n, k)
            qt = quantize(
                w, granularity="per_group", group_size=128, layout="planar"
            )
            x = randw(rng, 8, k)
            got = int4_matmul(x, qt, interpret=True)
            want = reference_linear_qt(x, qt)
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(want), atol=2e-3,
                err_msg=str((n, k)),
            )

    def test_better_than_per_row_on_outlier_rows(self, rng):
        """per_group must beat per_row when a row has a localized outlier."""
        w = np.asarray(rng.standard_normal((32, 512)), np.float32)
        w[:, :8] *= 50.0  # outlier columns blow up the per-row scale
        w = jnp.asarray(w)
        x = randw(rng, 4, 512)
        exact = np.asarray(x @ w.T)
        from fused4bit.ops.int4_matmul import int4_matmul

        qr = quantize(w, granularity="per_row", layout="planar")
        qg = quantize(w, granularity="per_group", group_size=128, layout="planar")
        err_row = np.max(np.abs(np.asarray(int4_matmul(x, qr)) - exact))
        err_grp = np.max(np.abs(np.asarray(int4_matmul(x, qg, interpret=True)) - exact))
        assert err_grp < err_row

    def test_quantized_linear_dispatches_to_group_kernel(self, rng):
        w = randw(rng, 64, 512)
        layer = QuantizedLinear.from_dense(w, granularity="per_group", group_size=128)
        x = randw(rng, 2, 512)
        np.testing.assert_allclose(
            np.asarray(layer(x)),
            np.asarray(reference_linear_qt(x, layer.weight)),
            atol=1e-3,
        )

    def test_bf16(self, rng):
        from fused4bit.quant.core import dequantize

        w = randw(rng, 128, 256)
        qt = quantize(w, granularity="per_group", group_size=128, layout="planar")
        x = randw(rng, 4, 256).astype(jnp.bfloat16)
        got = int4_matmul(x, qt, interpret=True)
        # bf16 compute rounds x only; the scale multiplies the float32
        # partial. Both the bf16-dequant product and the f32 golden bound it.
        want_bf16 = jnp.dot(
            x.astype(jnp.float32),
            dequantize(qt, dtype=jnp.bfloat16).astype(jnp.float32).T,
            precision=jax.lax.Precision.HIGHEST,
        )
        # atol covers the kernel's own bf16 dot rounding (the reference dot
        # here runs f32 HIGHEST); 0.12 is <1% of typical output magnitude
        np.testing.assert_allclose(
            np.asarray(got, np.float32), np.asarray(want_bf16),
            atol=0.12, rtol=0.02,
        )
        want = reference_linear_qt(x.astype(jnp.float32), qt)
        np.testing.assert_allclose(
            np.asarray(got, np.float32), np.asarray(want), atol=0.25, rtol=0.06
        )


class TestInt4MatmulPerGroupBP:
    """Per-group weights in the group-major layout (layout="planar_groups"):
    the kernel reads one group per K step, scales apply to each step's
    float32 partial."""

    def _check(self, rng, n, k, m, gs=128, atol=1e-3, dtype=jnp.float32):
        w = randw(rng, n, k)
        qt = quantize(w, granularity="per_group", group_size=gs,
                      layout="planar_groups")
        x = randw(rng, m, k).astype(dtype)
        got = int4_matmul(x, qt, interpret=True)
        want = reference_linear_qt(x.astype(jnp.float32), qt)
        np.testing.assert_allclose(
            np.asarray(got, np.float32), np.asarray(want), atol=atol,
            rtol=0.02 if dtype == jnp.bfloat16 else 0,
            err_msg=str((n, k, m, gs, dtype)),
        )

    def test_matches_reference(self, rng):
        self._check(rng, 128, 512, 8)

    def test_matches_reference_odd_group_count(self, rng):
        # gh = 3 per half (odd group counts need no padding)
        self._check(rng, 96, 768, 8)

    def test_matches_reference_multi_tile_and_row_pad(self, rng):
        # several n-blocks, a ragged last n-block and a ragged m-block
        self._check(rng, 320, 512, 20, atol=2e-3)

    def test_group_size_256(self, rng):
        self._check(rng, 64, 1024, 4, gs=256)

    def test_bf16(self, rng):
        # (q - zp) is exact in bf16 and partials accumulate in f32, so bf16
        # compute only rounds x
        self._check(rng, 128, 512, 8, dtype=jnp.bfloat16, atol=0.12)

    def test_planar_groups_is_default_for_per_group_layers(self, rng):
        w = randw(rng, 64, 512)
        layer = QuantizedLinear.from_dense(
            w, granularity="per_group", group_size=128
        )
        assert layer.weight.layout == "planar_groups"
        x = randw(rng, 2, 512)
        np.testing.assert_allclose(
            np.asarray(layer(x)),
            np.asarray(reference_linear_qt(x, layer.weight)),
            atol=1e-3,
        )

    def test_padded_rows_layer(self, rng):
        """pad_rows on the rank-3 planar_groups layout pads the N (middle)
        axis; outputs slice back to the logical out_features."""
        w = randw(rng, 100, 512)
        layer = QuantizedLinear.from_dense(
            w, granularity="per_group", group_size=128
        ).padded_for_kernel()
        x = randw(rng, 4, 512)
        y = layer(x)
        assert y.shape == (4, 100)
        np.testing.assert_allclose(
            np.asarray(y),
            np.asarray(
                reference_linear_qt(x, layer.weight)[..., :100]
            ),
            atol=1e-3,
        )


class TestPrefillDispatch:
    def test_prefill_path_matches_kernel(self, rng):
        w = randw(rng, 128, 256)
        qt = quantize(w)
        x = randw(rng, 600, 256)  # > default prefill_threshold
        via_prefill = int4_matmul(x, qt)
        via_kernel = int4_matmul(x, qt, prefill_threshold=10_000)
        np.testing.assert_allclose(
            np.asarray(via_prefill), np.asarray(via_kernel), atol=1e-2
        )
        np.testing.assert_allclose(
            np.asarray(via_prefill),
            np.asarray(reference_linear_qt(x, qt)),
            atol=1e-3,
        )


class TestInt4Kernel:
    """The Triton-route kernel in the Pallas interpreter against the golden:
    ragged M and N, several K steps, per_row and per_group layouts."""

    @pytest.mark.parametrize(
        "m,n,k,gran,layout,gs",
        [
            (1, 64, 128, "per_row", "planar", 0),
            (5, 100, 256, "per_row", "planar", 0),        # ragged n-block
            (17, 48, 1024, "per_row", "planar", 0),       # 64-row m-block, 2 K steps
            (8, 96, 512, "per_group", "planar", 128),
            (20, 80, 768, "per_group", "planar_groups", 128),   # gh = 3
            (3, 64, 1024, "per_group", "planar", 256),
        ],
    )
    def test_matches_golden(self, rng, m, n, k, gran, layout, gs):
        kw = dict(group_size=gs) if gs else {}
        qt = quantize(randw(rng, n, k), granularity=gran, layout=layout, **kw)
        x = randw(rng, m, k)
        got = int4_matmul(x, qt, interpret=True)
        assert got.shape == (m, n)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(reference_linear_qt(x, qt)), atol=2e-3
        )

    @pytest.mark.parametrize("gran", ["per_row", "per_group"])
    def test_split_k_matches_golden(self, rng, gran):
        import dataclasses as dc
        from fused4bit.ops.int4_matmul import int4_kernel_call

        qt = quantize(randw(rng, 48, 1024), granularity=gran, group_size=128)
        stacked = dc.replace(
            qt, packed=qt.packed[None], scales=qt.scales[None],
            zero_points=qt.zero_points[None], shape=(1,) + tuple(qt.shape))
        x = randw(rng, 5, 1024)
        got = int4_kernel_call(
            x, jnp.zeros((1,), jnp.int32), stacked, block_m=16, block_n=16,
            block_kh=64, k_splits=4, num_warps=4, num_stages=2,
            compute_dtype=jnp.float32, out_dtype=jnp.float32, interpret=True)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(reference_linear_qt(x, qt)), atol=2e-3
        )

    def test_rows_do_not_depend_on_the_batch(self, rng):
        """A row comes out bit for bit the same in a 64-row batch and in a
        256-row one (a one-slot prefill chunk and the whole batch's): the
        blocks, and so the order of the float32 sums, follow the weight and
        not the number of m-blocks."""
        qt = quantize(randw(rng, 128 * 70, 256))
        x = randw(rng, 256, 256).astype(jnp.bfloat16)
        mm = jax.jit(lambda a: int4_matmul(a, qt, interpret=True,
                                           out_dtype=jnp.float32))
        np.testing.assert_array_equal(np.asarray(mm(x[:64])),
                                      np.asarray(mm(x)[:64]))

    def test_bf16_matches_bf16_dequant_product(self, rng):
        from fused4bit.quant.core import dequantize

        qt = quantize(randw(rng, 64, 512))
        x = randw(rng, 8, 512).astype(jnp.bfloat16)
        got = int4_matmul(x, qt, interpret=True, out_dtype=jnp.float32)
        want = jnp.dot(
            x.astype(jnp.float32), dequantize(qt).T,
            precision=jax.lax.Precision.HIGHEST,
        )
        # exact integer (q - zp) times bf16 x, f32 sums: only the order of
        # the float32 additions differs
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-3)

    def test_plain_path_matches_golden(self, rng):
        from fused4bit.ops.int4_matmul import int4_matmul_plain

        for gran in ("per_row", "per_group"):
            qt = quantize(randw(rng, 96, 512), granularity=gran,
                          layout="planar_groups" if gran == "per_group" else "planar")
            x = randw(rng, 2, 3, 512)
            np.testing.assert_allclose(
                np.asarray(int4_matmul_plain(x, qt)),
                np.asarray(reference_linear_qt(x, qt)), atol=1e-3,
            )

    def test_kernel_blocks(self):
        from fused4bit.ops.int4_matmul import kernel_blocks

        few = kernel_blocks(16, 4096, 7168, 0)      # 14336 -> 4096 decode
        many = kernel_blocks(16, 32000, 2048, 0)    # LM head at decode
        # fewer output blocks -> the K range splits over more programs
        assert few["k_splits"] >= many["k_splits"] >= 1
        grouped = kernel_blocks(16, 4096, 7168, 128, grouped=True)
        assert 128 % grouped["block_kh"] == 0
        # a grouped launch has more m-blocks: it splits K less
        assert grouped["k_splits"] <= kernel_blocks(16, 4096, 7168, 128)["k_splits"]
        prefill = kernel_blocks(128, 14336, 2048, 0, grouped=True)
        assert prefill["k_splits"] == 1
        for b in (few, many, grouped, prefill):
            steps = (7168 if b is not many else 2048) // b["block_kh"]
            assert steps % b["k_splits"] == 0
            for key in ("block_n", "block_kh", "k_splits"):
                assert b[key] & (b[key] - 1) == 0   # Triton blocks: powers of 2

    def test_padded_layer_through_kernel(self, rng):
        from fused4bit.ops.int4_matmul import int4_matmul as mm

        layer = QuantizedLinear.from_dense(randw(rng, 100, 256)).padded_for_kernel()
        assert layer.weight.out_dim % 128 == 0 and layer.out_dim == 100
        x = randw(rng, 3, 256)
        got = mm(x, layer.weight, interpret=True)[..., :100]
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(layer(x)), atol=1e-3
        )

    @pytest.mark.parametrize(
        "gran,layout",
        [("per_tensor", "planar"), ("per_row", "interleaved"),
         ("per_row", "block_planar")],
    )
    def test_weights_the_kernel_does_not_take_run_plain(self, rng, gran, layout):
        from fused4bit.ops.int4_matmul import kernel_takes

        qt = quantize(randw(rng, 32, 128), granularity=gran, layout=layout)
        assert not kernel_takes(qt)
        layer = QuantizedLinear(weight=qt)
        x = randw(rng, 2, 128)
        for lin in (layer, dataclasses.replace(layer, use_kernel=False)):
            np.testing.assert_allclose(
                np.asarray(lin(x)), np.asarray(reference_linear_qt(x, qt)),
                atol=1e-3,
            )


@pytest.mark.gpu
def test_kernel_compiled_on_gpu(gpu, rng):
    """The compiled kernel on the card (chip_smoke.py phase 2 runs the same
    check at Mixtral widths)."""
    for gran, layout in (("per_row", "planar"), ("per_group", "planar_groups")):
        qt = quantize(randw(rng, 1024, 2048), granularity=gran, layout=layout)
        x = randw(rng, 8, 2048).astype(jnp.bfloat16)
        got = int4_matmul(x, qt, out_dtype=jnp.float32)
        want = reference_linear_qt(x.astype(jnp.float32), qt)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-3 * float(jnp.abs(want).max()))


def test_groups_straddling_halves_take_plain_path(rng):
    """K/2 = 96 is no multiple of group 64: no K step of the kernel could
    hold whole groups, so every mode takes the plain path."""
    qt = quantize(randw(rng, 40, 192), granularity="per_group", group_size=64)
    x = randw(rng, 3, 192)
    for interpret in (None, True):
        np.testing.assert_allclose(
            np.asarray(int4_matmul(x, qt, interpret=interpret)),
            np.asarray(reference_linear_qt(x, qt)), atol=1e-3,
        )
