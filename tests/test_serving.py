"""Continuous-batching engine tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # run with: pytest -m slow (or -m "")

from fused4bit.models.config import flagship_model_config
from fused4bit.models.transformer import QuantizedTransformer
from fused4bit.serving.engine import GenerationRequest, Sampler, ServingEngine


@pytest.fixture(scope="module")
def setup():
    cfg = flagship_model_config("tiny")
    model = QuantizedTransformer.init(jax.random.PRNGKey(0), cfg)
    return cfg, model


def make_engine(cfg, model, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_bucket", 8)
    return ServingEngine(model, cfg, **kw)


class TestEngine:
    def test_single_request(self, setup):
        cfg, model = setup
        eng = make_engine(cfg, model)
        eng.submit(GenerationRequest(uid=1, prompt=[1, 2, 3], max_new_tokens=5))
        out = eng.run()
        assert set(out) == {1}
        assert len(out[1]) == 5

    def test_more_requests_than_slots(self, setup):
        cfg, model = setup
        eng = make_engine(cfg, model)
        for uid in range(5):
            eng.submit(GenerationRequest(uid=uid, prompt=[1 + uid, 2, 3],
                                         max_new_tokens=3 + uid))
        out = eng.run()
        assert set(out) == set(range(5))
        for uid in range(5):
            assert len(out[uid]) == 3 + uid

    def test_matches_plain_decode(self, setup):
        """Engine state handling == straightforward prefill+decode loop.

        Separately compiled programs on this backend differ by ~1 ULP
        (reduced default matmul precision), and greedy chains on random-weight
        near-flat logits amplify single-ULP flips — so the contract checked
        here is: identical first decode logits (to float tolerance) and the
        same first two greedy tokens, plus right-pad rewind correctness
        (bucket > len(prompt)).
        """
        cfg, model = setup
        prompt = [5, 7, 9, 11]
        # plain loop, step 1
        caches = model.init_cache(cfg, 1, max_seq=64)
        toks = jnp.asarray(prompt, jnp.int32)[None]
        logits, caches = model(toks, caches, jnp.arange(len(prompt)))
        first = int(jnp.argmax(logits[0, -1]))
        lg1, _ = model(
            jnp.asarray([[first]], jnp.int32), caches,
            jnp.asarray([[len(prompt)]]),
        )
        # engine (prompt shorter than bucket -> exercises right-pad rewind)
        eng = make_engine(cfg, model, num_slots=2, prefill_bucket=8)
        eng.submit(GenerationRequest(uid=0, prompt=prompt, max_new_tokens=2))
        out = eng.run()
        assert out[0][0] == first
        second_plain = np.asarray(lg1[0, 0], np.float32)
        # engine's second token must be the argmax of logits ~equal to plain's
        top2 = np.argsort(second_plain)[-2:]
        assert out[0][1] in top2  # 1-ULP compile nondeterminism tolerance

    def test_eos_stops_early(self, setup):
        cfg, model = setup
        eng = make_engine(cfg, model)
        # discover the first greedy token, then use it as "EOS"
        eng.submit(GenerationRequest(uid=0, prompt=[1, 2], max_new_tokens=8))
        first = eng.run()[0][0]
        eng2 = make_engine(cfg, model)
        eng2.submit(GenerationRequest(uid=1, prompt=[1, 2], max_new_tokens=8,
                                      eos_token=first))
        out = eng2.run()
        assert out[1][-1] == first
        assert len(out[1]) < 8

    def test_slot_reuse_isolation(self, setup):
        """A request that reuses a slot must not see the previous request's
        cache (reset_slot + overwrite semantics)."""
        cfg, model = setup
        prompt = [3, 4, 5]
        eng = make_engine(cfg, model, num_slots=1, prefill_bucket=8)
        eng.submit(GenerationRequest(uid=0, prompt=[9, 9, 9, 9, 9], max_new_tokens=6))
        eng.submit(GenerationRequest(uid=1, prompt=prompt, max_new_tokens=4))
        out = eng.run()
        # fresh engine, same prompt, same slot 0
        eng2 = make_engine(cfg, model, num_slots=1, prefill_bucket=8)
        eng2.submit(GenerationRequest(uid=2, prompt=prompt, max_new_tokens=4))
        out2 = eng2.run()
        assert out[1] == out2[2]

    def test_temperature_sampler_runs(self, setup):
        cfg, model = setup
        eng = make_engine(cfg, model, sampler=Sampler(temperature=1.0, top_k=8))
        eng.submit(GenerationRequest(uid=0, prompt=[1], max_new_tokens=4))
        out = eng.run()
        assert len(out[0]) == 4

    def test_logprobs_returned_and_consistent(self, setup):
        """Per-token logprobs: one per generated token, <= 0, and for a
        greedy sampler each equals the max log-softmax (the argmax token's
        probability) — checked against a fresh teacher-forced forward."""
        import jax.numpy as jnp
        import numpy as np

        cfg, model = setup
        from fused4bit.serving import generate

        prompt = [1, 2, 3]
        toks, lps = generate(
            model, cfg, [prompt], max_new_tokens=5, max_seq=64,
            prefill_bucket=8, decode_block=2, return_logprobs=True,
        )
        assert len(lps[0]) == len(toks[0]) == 5
        assert all(lp <= 0.0 for lp in lps[0])
        # teacher-force: logprob of token i under the model given prefix
        seq = prompt + toks[0]
        caches = model.init_cache(cfg, 1, 16)
        logits, _ = model(
            jnp.asarray([seq[:-1]], jnp.int32), caches,
            jnp.arange(len(seq) - 1, dtype=jnp.int32)[None],
        )
        lsm = jax.nn.log_softmax(logits[0].astype(jnp.float32), axis=-1)
        for i, (tok, lp) in enumerate(zip(toks[0], lps[0])):
            ref = float(lsm[len(prompt) - 1 + i, tok])
            assert abs(ref - lp) < 0.15, (i, tok, lp, ref)  # bf16 cross-program

    def test_on_token_streaming_callback(self, setup):
        """on_token fires once per generated token, in order, with the same
        (token, logprob) the engine records."""
        cfg, model = setup
        seen = []
        eng = make_engine(
            cfg, model, num_slots=2, prefill_bucket=8, decode_block=2,
            on_token=lambda uid, tok, lp: seen.append((uid, tok, lp)),
        )
        eng.submit(GenerationRequest(uid=0, prompt=[1, 2, 3], max_new_tokens=4))
        eng.submit(GenerationRequest(uid=1, prompt=[9], max_new_tokens=3))
        out = eng.run()
        for uid in (0, 1):
            stream = [(t, lp) for u, t, lp in seen if u == uid]
            assert [t for t, _ in stream] == out[uid]
            assert [lp for _, lp in stream] == eng.finished_logprobs[uid]

    def test_cancel_queued_and_active(self, setup):
        cfg, model = setup
        eng = make_engine(cfg, model, num_slots=1, prefill_bucket=8)
        eng.submit(GenerationRequest(uid=0, prompt=[1, 2], max_new_tokens=20))
        eng.submit(GenerationRequest(uid=1, prompt=[3, 4], max_new_tokens=20))
        eng.step()                      # uid 0 active, uid 1 queued
        assert eng.cancel(1) is True    # cancel from the queue
        assert eng.finished[1] == []
        assert eng.cancel(0) is True    # cancel the active request
        assert 0 in eng.finished and len(eng.finished[0]) >= 1
        assert eng.cancel(7) is False   # unknown uid
        out = eng.run()
        assert set(out) == {0, 1}

    def test_cancel_from_on_token_callback(self, setup):
        """Calling cancel() from inside on_token (streaming early-stop, the
        natural use) must not corrupt the step iteration: the cancel is
        deferred to the end of the step and every request still finishes."""
        cfg, model = setup
        eng = {}

        def cb(uid, tok, lp):
            if uid == 0 and len(eng["e"].generated.get(0, [])) >= 2:
                assert eng["e"].cancel(0) is True  # self-cancel mid-step
            if uid == 1:
                eng["e"].cancel(0)                 # cross-slot cancel too

        eng["e"] = make_engine(cfg, model, num_slots=2, prefill_bucket=8,
                               decode_block=2, on_token=cb)
        eng["e"].submit(GenerationRequest(uid=0, prompt=[1, 2], max_new_tokens=20))
        eng["e"].submit(GenerationRequest(uid=1, prompt=[5, 6], max_new_tokens=6))
        out = eng["e"].run()
        assert set(out) == {0, 1}
        assert len(out[1]) == 6            # the other request is unaffected
        assert 1 <= len(out[0]) < 20       # uid 0 stopped early, no crash

    def test_top_p_sampler_truncates_nucleus(self, setup):
        """top_p keeps the smallest prefix of the sorted distribution whose
        mass reaches p: with one dominant logit and p below its probability,
        sampling must always return it; p=1 must reach low-probability
        tokens eventually."""
        import numpy as np

        logits = jnp.array([[4.0, 1.0, 0.5, 0.2, -1.0]] * 2)
        keys = [jax.random.PRNGKey(i) for i in range(64)]
        tight = Sampler(temperature=1.0, top_p=0.5)  # p(top1) ~ 0.83 > 0.5
        toks = np.array([np.asarray(tight.sample(logits, k)) for k in keys])
        assert (toks == 0).all(), toks
        full = Sampler(temperature=1.0, top_p=1.0)
        toks = np.array([np.asarray(full.sample(logits, k)) for k in keys])
        assert (toks > 0).any()  # full distribution reaches other tokens

    def test_chunked_prefill_matches_plain(self, setup):
        """A prompt 3x the prefill bucket must NOT be truncated: the engine
        loops bucket-sized chunks through the compiled prefill program and the
        first generated token matches a plain full-prompt forward (round-1
        review: prompt[-bucket:] silently dropped the head)."""
        cfg, model = setup
        prompt = list(range(3, 3 + 20))  # 20 tokens, bucket 8 -> chunks 8/8/4
        caches = model.init_cache(cfg, 1, max_seq=64)
        logits, _ = model(
            jnp.asarray(prompt, jnp.int32)[None], caches,
            jnp.arange(len(prompt)),
        )
        plain = np.asarray(logits[0, -1], np.float32)
        eng = make_engine(cfg, model, num_slots=2, prefill_bucket=8)
        eng.submit(GenerationRequest(uid=0, prompt=prompt, max_new_tokens=2))
        out = eng.run()
        # 1-ULP compile nondeterminism tolerance (see test_matches_plain_decode)
        assert out[0][0] in np.argsort(plain)[-2:]

    def test_chunked_prefill_multiple_of_bucket(self, setup):
        """Exact-multiple prompt length (no ragged final chunk)."""
        cfg, model = setup
        prompt = list(range(2, 18))  # 16 tokens = 2 full buckets of 8
        caches = model.init_cache(cfg, 1, max_seq=64)
        logits, _ = model(
            jnp.asarray(prompt, jnp.int32)[None], caches,
            jnp.arange(len(prompt)),
        )
        plain = np.asarray(logits[0, -1], np.float32)
        eng = make_engine(cfg, model, num_slots=2, prefill_bucket=8)
        eng.submit(GenerationRequest(uid=0, prompt=prompt, max_new_tokens=1))
        out = eng.run()
        assert out[0][0] in np.argsort(plain)[-2:]

    def test_first_token_uses_sampler(self, setup):
        """Token 0 of every request must route through the configured Sampler
        (round-1 review: it was hardcoded argmax)."""

        class ConstSampler(Sampler):
            def sample(self, logits, key):
                return jnp.full((logits.shape[0],), 42, jnp.int32)

        cfg, model = setup
        eng = make_engine(cfg, model, sampler=ConstSampler())
        eng.submit(GenerationRequest(uid=0, prompt=[1, 2, 3], max_new_tokens=3))
        out = eng.run()
        assert out[0] == [42, 42, 42]

    def test_engine_runs_xla_turbo_model(self, setup):
        """The int8-resident execution mode serves end to end: first token
        agrees with the standard kernel model (same int4 weights)."""
        from fused4bit.models.transformer import as_xla_turbo

        cfg, model = setup
        prompt = [3, 5, 7, 9]
        eng = make_engine(cfg, model)
        eng.submit(GenerationRequest(uid=0, prompt=prompt, max_new_tokens=2))
        base = eng.run()[0]
        eng2 = make_engine(cfg, as_xla_turbo(model))
        eng2.submit(GenerationRequest(uid=0, prompt=prompt, max_new_tokens=2))
        out = eng2.run()[0]
        assert len(out) == 2
        # int8 activation quant can flip near-ties on random weights; demand
        # agreement on the first token only (deterministic greedy)
        assert out[0] == base[0]

    def test_decode_block_lengths_and_content(self, setup):
        """decode_block>1 fuses D steps into one dispatch; request accounting
        (token counts, first token) must match the single-step engine. Full
        greedy-chain equality is not required across separately compiled
        programs (~1 ULP divergence, see test_matches_plain_decode)."""
        cfg, model = setup
        prompts = {0: [1, 2, 3], 1: [9, 8], 2: [4]}
        eng1 = make_engine(cfg, model)
        engd = make_engine(cfg, model, decode_block=4)
        for uid, p in prompts.items():
            eng1.submit(GenerationRequest(uid=uid, prompt=p, max_new_tokens=6))
            engd.submit(GenerationRequest(uid=uid, prompt=p, max_new_tokens=6))
        out1, outd = eng1.run(), engd.run()
        assert set(outd) == set(out1)
        for uid in prompts:
            assert len(outd[uid]) == len(out1[uid]) == 6
            assert outd[uid][0] == out1[uid][0]  # prefill program is shared

    def test_u4_turbo_model_with_decode_block(self, setup):
        """as_u4_turbo engine (packed residency, regime dispatch) under
        decode_block>1: accounting + first token must match the plain-model
        single-step engine."""
        from fused4bit.models.transformer import as_u4_turbo

        cfg, model = setup
        eng1 = make_engine(cfg, model)
        engu = make_engine(cfg, as_u4_turbo(model), decode_block=3)
        for uid, p in {0: [1, 2, 3], 1: [9, 8]}.items():
            eng1.submit(GenerationRequest(uid=uid, prompt=p, max_new_tokens=5))
            engu.submit(GenerationRequest(uid=uid, prompt=p, max_new_tokens=5))
        out1, outu = eng1.run(), engu.run()
        assert set(outu) == set(out1)
        for uid in out1:
            assert len(outu[uid]) == len(out1[uid]) == 5

    def test_decode_block_eos_stops_early(self, setup):
        cfg, model = setup
        eng = make_engine(cfg, model, decode_block=4)
        eng.submit(GenerationRequest(uid=0, prompt=[1, 2], max_new_tokens=8))
        first_tokens = eng.run()[0]
        eos = first_tokens[1]  # second generated token (mid-block)
        eng2 = make_engine(cfg, model, decode_block=4)
        eng2.submit(GenerationRequest(uid=1, prompt=[1, 2], max_new_tokens=8,
                                      eos_token=eos))
        out = eng2.run()
        assert out[1][-1] == eos
        assert len(out[1]) < 8
        assert eos not in out[1][:-1]

    def test_decode_block_slot_reuse_isolation(self, setup):
        """Mid-block retirement + slot reuse: the next request in the same
        slot must see a clean cache (block path self-consistency)."""
        cfg, model = setup
        prompt = [3, 4, 5]
        eng = make_engine(cfg, model, num_slots=1, decode_block=3)
        eng.submit(GenerationRequest(uid=0, prompt=[9, 9, 9, 9], max_new_tokens=5))
        eng.submit(GenerationRequest(uid=1, prompt=prompt, max_new_tokens=4))
        out = eng.run()
        eng2 = make_engine(cfg, model, num_slots=1, decode_block=3)
        eng2.submit(GenerationRequest(uid=2, prompt=prompt, max_new_tokens=4))
        out2 = eng2.run()
        assert out[1] == out2[2]

    def test_overlong_prompt_raises(self, setup):
        cfg, model = setup
        eng = make_engine(cfg, model, max_seq=16, prefill_bucket=8)
        eng.submit(GenerationRequest(uid=0, prompt=[1] * 16, max_new_tokens=1))
        with pytest.raises(ValueError, match="prompt length"):
            eng.run()


class TestShardedEngine:
    """Continuous batching over a DPxEP mesh (multi-chip serving config)."""

    @pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
    def test_sharded_engine_runs_and_recycles_slots(self, setup):
        from fused4bit.parallel.mesh import make_mesh
        from fused4bit.parallel.sharded_model import place_model

        cfg, model = setup
        mesh = make_mesh(("data", "expert"), (2, 4))
        sm = place_model(model, mesh)
        eng = ServingEngine(
            sm, cfg, num_slots=2, max_seq=64, prefill_bucket=8,
            mesh=mesh, interpret=True,
        )
        for uid in range(3):
            eng.submit(GenerationRequest(uid=uid, prompt=[1 + uid, 2, 3],
                                         max_new_tokens=3))
        out = eng.run()
        assert set(out) == {0, 1, 2}
        assert all(len(v) == 3 for v in out.values())

    @pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
    def test_sharded_engine_first_token_matches_single_device(self, setup):
        from fused4bit.parallel.mesh import make_mesh
        from fused4bit.parallel.sharded_model import place_model

        cfg, model = setup
        prompt = [5, 7, 9]
        eng1 = ServingEngine(model, cfg, num_slots=2, max_seq=64,
                             prefill_bucket=4)
        eng1.submit(GenerationRequest(uid=0, prompt=prompt, max_new_tokens=1))
        first_single = eng1.run()[0][0]

        mesh = make_mesh(("data", "expert"), (2, 4))
        sm = place_model(model, mesh)
        eng2 = ServingEngine(sm, cfg, num_slots=2, max_seq=64,
                             prefill_bucket=4, mesh=mesh, interpret=True)
        eng2.submit(GenerationRequest(uid=0, prompt=prompt, max_new_tokens=1))
        first_sharded = eng2.run()[0][0]
        assert first_sharded == first_single

    @pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
    def test_sharded_chunked_prefill_matches_single_device(self, setup):
        """Prompt 3x the prefill bucket through the SHARDED engine: every
        chunk must append K/V at its own start_pos with correct RoPE phases
        (round-2 advisor high: _prefill_sharded_impl hardcoded the target
        row's start to 0, piling all chunks onto positions [0, bucket))."""
        from fused4bit.parallel.mesh import make_mesh
        from fused4bit.parallel.sharded_model import place_model

        cfg, model = setup
        prompt = list(range(3, 3 + 11))  # 11 tokens, bucket 4 -> chunks 4/4/3
        eng1 = ServingEngine(model, cfg, num_slots=2, max_seq=64,
                             prefill_bucket=4)
        eng1.submit(GenerationRequest(uid=0, prompt=prompt, max_new_tokens=1))
        first_single = eng1.run()[0][0]

        mesh = make_mesh(("data", "expert"), (2, 4))
        sm = place_model(model, mesh)
        eng2 = ServingEngine(sm, cfg, num_slots=2, max_seq=64,
                             prefill_bucket=4, mesh=mesh, interpret=True)
        eng2.submit(GenerationRequest(uid=0, prompt=prompt, max_new_tokens=1))
        first_sharded = eng2.run()[0][0]
        assert first_sharded == first_single

    def test_bucket_must_tile_max_seq(self, setup):
        """max_seq % prefill_bucket != 0 is rejected at construction: a padded
        final chunk could otherwise write past the cache and the clamped
        scale update would corrupt earlier positions (round-2 advisor)."""
        cfg, model = setup
        with pytest.raises(ValueError, match="multiple of prefill_bucket"):
            ServingEngine(model, cfg, num_slots=2, max_seq=60,
                          prefill_bucket=8)


class TestGenerateAPI:
    def test_one_call_generate(self, setup):
        """serving.generate: prompts in, per-prompt completions out, in
        order, honoring max_new_tokens."""
        from fused4bit.serving import generate

        cfg, model = setup
        outs = generate(
            model, cfg, [[1, 2, 3], [7, 8], [4]],
            max_new_tokens=4, max_seq=64, prefill_bucket=8, decode_block=2,
        )
        assert [len(o) for o in outs] == [4, 4, 4]

    def test_generate_empty(self, setup):
        from fused4bit.serving import generate

        cfg, model = setup
        assert generate(model, cfg, []) == []
