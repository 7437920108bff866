"""Checkpoint conversion + flax compat tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fused4bit.models.config import flagship_model_config
from fused4bit.models.convert import convert_checkpoint, quantize_dense_2d
from fused4bit.quant import dequantize, quantize


def synthetic_checkpoint(cfg, rng):
    hidden = cfg.num_heads * cfg.head_dim
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    e, f = cfg.moe.num_experts, cfg.moe.ffn_dim
    p = {}
    p["embed.weight"] = rng.standard_normal((cfg.vocab_size, hidden)) * 0.02
    p["final_norm.weight"] = np.ones(hidden)
    p["lm_head.weight"] = rng.standard_normal((cfg.vocab_size, hidden)) * 0.02
    for L in range(cfg.num_layers):
        pre = f"layers.{L}"
        p[f"{pre}.attn_norm.weight"] = np.ones(hidden)
        p[f"{pre}.moe_norm.weight"] = np.ones(hidden)
        p[f"{pre}.attn.q_proj.weight"] = rng.standard_normal((nh * hd, hidden)) * 0.02
        p[f"{pre}.attn.k_proj.weight"] = rng.standard_normal((nkv * hd, hidden)) * 0.02
        p[f"{pre}.attn.v_proj.weight"] = rng.standard_normal((nkv * hd, hidden)) * 0.02
        p[f"{pre}.attn.o_proj.weight"] = rng.standard_normal((hidden, nh * hd)) * 0.02
        p[f"{pre}.moe.router.weight"] = rng.standard_normal((e, hidden)) * 0.02
        for E in range(e):
            p[f"{pre}.moe.experts.{E}.w1.weight"] = rng.standard_normal((f, hidden)) * 0.02
            p[f"{pre}.moe.experts.{E}.w3.weight"] = rng.standard_normal((f, hidden)) * 0.02
            p[f"{pre}.moe.experts.{E}.w2.weight"] = rng.standard_normal((hidden, f)) * 0.02
    return p


class TestConvert:
    def test_quantize_dense_2d_matches_jax_quantizer(self, rng):
        w = rng.standard_normal((64, 256)).astype(np.float32)
        qt_native = quantize_dense_2d(w)
        qt_jax = quantize(jnp.asarray(w), layout="planar")
        assert jnp.array_equal(qt_native.packed, qt_jax.packed)
        np.testing.assert_allclose(
            np.asarray(qt_native.scales), np.asarray(qt_jax.scales), rtol=1e-6
        )

    def test_convert_and_run(self, rng):
        cfg = flagship_model_config("tiny")
        params = synthetic_checkpoint(cfg, rng)
        model = convert_checkpoint(params, cfg)
        caches = model.init_cache(cfg, 1, 16)
        toks = jnp.asarray([[1, 2, 3]], jnp.int32)
        logits, _ = model(toks, caches, jnp.arange(3))
        assert logits.shape == (1, 3, cfg.vocab_size)
        assert not bool(jnp.any(jnp.isnan(logits)))

    def test_converted_weights_roundtrip(self, rng):
        cfg = flagship_model_config("tiny")
        params = synthetic_checkpoint(cfg, rng)
        model = convert_checkpoint(params, cfg)
        w0 = params["layers.0.moe.experts.0.w1.weight"].astype(np.float32)
        got = np.asarray(dequantize(model.blocks[0].moe.w_gate.weight))[0]
        assert np.max(np.abs(got - w0)) < 0.05  # scale ~0.02*range/15


class TestFlaxCompat:
    def test_quantized_dense(self, rng):
        import flax.linen as nn  # noqa: F401
        from fused4bit.layers.flax_compat import QuantizedDense

        m = QuantizedDense(features=64)
        x = jnp.asarray(rng.standard_normal((4, 128)), jnp.float32)
        variables = m.init(jax.random.PRNGKey(0), x)
        y = m.apply(variables, x)
        assert y.shape == (4, 64)
        assert "quantized" in variables
        qt = variables["quantized"]["weight"]
        assert qt.packed.dtype == jnp.uint8

    def test_quantized_dense_bias_and_quality(self, rng):
        from fused4bit.layers.flax_compat import QuantizedDense
        from fused4bit.quant import dequantize

        m = QuantizedDense(features=32, use_bias=True)
        x = jnp.asarray(rng.standard_normal((8, 64)), jnp.float32)
        variables = m.init(jax.random.PRNGKey(1), x)
        y = m.apply(variables, x)
        qt = variables["quantized"]["weight"]
        w = dequantize(qt)
        want = x @ w.T + variables["params"]["bias"]
        np.testing.assert_allclose(np.asarray(y), np.asarray(want), atol=1e-3)


class TestEndToEnd:
    def test_convert_shard_serve(self, rng):
        """Dense checkpoint -> INT4 model -> EP-sharded mesh -> engine output.

        The full production onboarding path in one test.
        """
        import jax
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from fused4bit.parallel.mesh import make_mesh
        from fused4bit.parallel.sharded_model import place_model
        from fused4bit.serving.engine import GenerationRequest, ServingEngine

        cfg = flagship_model_config("tiny")  # 4 experts
        params = synthetic_checkpoint(cfg, rng)
        model = convert_checkpoint(params, cfg)

        mesh = make_mesh(("data", "expert"), (2, 4))
        sm = place_model(model, mesh)
        eng = ServingEngine(sm, cfg, num_slots=2, max_seq=64,
                            prefill_bucket=8, mesh=mesh, interpret=True)
        eng.submit(GenerationRequest(uid=0, prompt=[1, 2, 3], max_new_tokens=4))
        eng.submit(GenerationRequest(uid=1, prompt=[4, 5], max_new_tokens=3))
        out = eng.run()
        assert len(out[0]) == 4 and len(out[1]) == 3

        # and the sharded engine agrees with the single-device engine
        eng2 = ServingEngine(model, cfg, num_slots=2, max_seq=64,
                             prefill_bucket=8)
        eng2.submit(GenerationRequest(uid=0, prompt=[1, 2, 3], max_new_tokens=1))
        first_single = eng2.run()[0][0]
        eng3 = ServingEngine(sm, cfg, num_slots=2, max_seq=64,
                             prefill_bucket=8, mesh=mesh, interpret=True)
        eng3.submit(GenerationRequest(uid=0, prompt=[1, 2, 3], max_new_tokens=1))
        assert eng3.run()[0][0] == first_single


class TestSafetensorsIO:
    """Native reader/writer vs the reference `safetensors` package."""

    def test_roundtrip_all_dtypes(self, rng, tmp_path):
        from fused4bit.models.safetensors_io import (
            load_safetensors, save_safetensors,
        )

        tensors = {
            "a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": (rng.standard_normal((3, 5)) * 10).astype(np.float16),
            "c": rng.integers(0, 255, (2, 7)).astype(np.uint8),
            "d": rng.integers(-9, 9, (6,)).astype(np.int32),
        }
        p = str(tmp_path / "t.safetensors")
        save_safetensors(p, tensors, metadata={"k": "v"})
        back = load_safetensors(p)
        assert set(back) == set(tensors)
        for k in tensors:
            np.testing.assert_array_equal(back[k], tensors[k])

    def test_cross_validated_against_reference_lib(self, rng, tmp_path):
        st = pytest.importorskip("safetensors.numpy")
        from fused4bit.models.safetensors_io import (
            load_safetensors, save_safetensors,
        )

        tensors = {"w": rng.standard_normal((16, 32)).astype(np.float32),
                   "s": rng.standard_normal((16,)).astype(np.float32)}
        ours = str(tmp_path / "ours.safetensors")
        save_safetensors(ours, tensors)
        # the reference lib must read our file bit-exactly
        theirs_read = st.load_file(ours)
        for k in tensors:
            np.testing.assert_array_equal(theirs_read[k], tensors[k])
        # and we must read the reference lib's file bit-exactly
        theirs = str(tmp_path / "theirs.safetensors")
        st.save_file(tensors, theirs)
        back = load_safetensors(theirs)
        for k in tensors:
            np.testing.assert_array_equal(back[k], tensors[k])

    def test_bf16_upcast(self, tmp_path):
        st = pytest.importorskip("safetensors.numpy")
        import jax
        from fused4bit.models.safetensors_io import load_safetensors

        vals = jnp.asarray([[1.5, -2.25, 3.0, 0.0078125] * 32], jnp.bfloat16)
        import ml_dtypes
        arr = np.asarray(vals).view(np.uint16)
        p = str(tmp_path / "bf.safetensors")
        # craft a BF16 file via the reference lib's bf16 support
        st.save_file({"x": np.asarray(vals)}, p)
        back = load_safetensors(p)
        np.testing.assert_array_equal(
            back["x"], np.asarray(vals, np.float32)
        )


class TestTrainedFixture:
    """Quality gates on genuinely trained weights (scripts/train_tiny.py)."""

    @pytest.fixture(scope="class")
    def fixture_path(self):
        import os
        p = os.path.join(os.path.dirname(__file__), "fixtures",
                         "tiny_trained.safetensors")
        if not os.path.exists(p):
            pytest.skip("trained fixture missing (run scripts/train_tiny.py)")
        return p

    def test_trained_model_beats_uniform_and_int4_tracks_bf16(self, fixture_path):
        import json
        import subprocess
        import sys as _sys
        import os
        import tempfile
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        # Write to a TEMP path: the default output is the COMMITTED artifact
        # and letting every suite run rewrite it silently churned the repo's
        # published numbers with doc-corpus drift + backend differences
        # (review finding).
        out = os.path.join(tempfile.mkdtemp(), "quality.json")
        env = dict(os.environ, QUALITY_EVAL_OUT=out)
        r = subprocess.run(
            [_sys.executable, os.path.join(repo, "benchmark", "run_quality_eval.py")],
            capture_output=True, text=True, timeout=1200, env=env,
        )
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        res = json.load(open(out))
        # trained model is a real LM: far below uniform-random NLL
        assert res["heldout_nll_bf16"] < 0.7 * res["uniform_random_nll"]
        # INT4 quality tracks bf16 on trained weights through the real
        # convert pipeline. Gates calibrated on the h=128 fixture (tiny
        # hidden dims take the largest relative INT4 noise — error averages
        # over only K=128 lanes): the reference ladder's cos>0.95
        # (tests/test_correctness.py:140-168) must hold on TRAINED weights,
        # greedy decisions must mostly agree, and the NLL cost must stay
        # well under the trained model's margin over random.
        q = res["int4_router_dense"]
        assert q["logit_cosine_sim"] > 0.95
        assert q["top1_agreement"] > 0.80
        assert q["nll_delta"] < 0.2

    @pytest.mark.slow
    def test_h256_fixture_tighter_gates(self):
        """The trained h=256 fixture (15-doc corpus, steps selected by
        held-out NLL) must clear TIGHTER gates than h128: quantization noise
        shrinks as hidden width grows (error averages over more lanes), and
        the committed artifact quality_trained_h256.json records nll_delta
        0.044 / cosine 0.991 / top-1 0.87. Gates leave ~2x margin for
        backend drift."""
        import json
        import subprocess
        import sys as _sys
        import os
        import tempfile
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        fx = os.path.join(repo, "tests", "fixtures",
                          "tiny_trained_h256_s1400.safetensors")
        if not os.path.exists(fx):
            pytest.skip("h256 fixture missing")
        out = os.path.join(tempfile.mkdtemp(), "quality_h256.json")
        env = dict(os.environ, QUALITY_EVAL_OUT=out, QUALITY_EVAL_FIXTURE=fx)
        r = subprocess.run(
            [_sys.executable, os.path.join(repo, "benchmark", "run_quality_eval.py")],
            capture_output=True, text=True, timeout=2400, env=env,
        )
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        res = json.load(open(out))
        assert res["heldout_nll_bf16"] < 0.5 * res["uniform_random_nll"]
        q = res["int4_router_dense"]
        assert q["logit_cosine_sim"] > 0.97
        assert q["top1_agreement"] > 0.82
        assert q["nll_delta"] < 0.1
        # per-group64 is the quality-path granularity: strictly better cosine
        pg = res["int4_per_group64"]
        assert pg["logit_cosine_sim"] >= q["logit_cosine_sim"] - 1e-3
