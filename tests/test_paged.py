"""Paged INT4 KV cache + paged attention + paged serving engine.

North-star serving capability with no reference analogue (the reference has
no KV cache at all — SURVEY.md §5 long-context row): a shared page pool with
per-slot page tables, attention gathering pages through the Pallas kernel's
scalar-prefetched BlockSpec index_map. Correctness strategy mirrors the
repo's ladder: paged ops must match the contiguous cache (bit-exact where
the tiling matches) and the dense golden within the bf16 compute budget.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fused4bit.layers.kv_cache import QuantizedKVCache
from fused4bit.layers.paged_kv import PagedKVCache
from fused4bit.ops.decode_attention import (
    int4_decode_attention,
    int4_prefill_attention,
)

B, HKV, HQ, D = 2, 2, 4, 128
PAGE, MAX_PAGES, NUM_PAGES = 16, 4, 16
S = PAGE * MAX_PAGES


def _mk_pair(t0=24, seed=0):
    """Contiguous + paged caches holding the SAME t0 positions; the paged
    one through a shuffled, non-identity page assignment."""
    rng = jax.random.PRNGKey(seed)
    cont = QuantizedKVCache.init(B, HKV, S, D)
    paged = PagedKVCache.init(
        B, HKV, D,
        num_pages=NUM_PAGES, page_size=PAGE, max_pages_per_slot=MAX_PAGES,
    )
    paged = paged.assign_pages(0, [5, 9, 2, 11])
    paged = paged.assign_pages(1, [7, 1, 14, 3])
    k = jax.random.normal(rng, (B, HKV, t0, D), jnp.float32)
    v = jax.random.normal(jax.random.split(rng)[0], (B, HKV, t0, D), jnp.float32)
    zero = jnp.zeros((B,), jnp.int32)
    cont = cont.append(k, v, start=zero)
    for c0 in range(0, t0, PAGE):  # page-aligned chunks (engine contract)
        chunk = slice(c0, min(c0 + PAGE, t0))
        paged = paged.append(k[:, :, chunk], v[:, :, chunk], start=zero + c0)
    return cont, paged


class TestPagedCache:
    def test_dequantize_matches_contiguous(self):
        """Same data through shuffled pages dequantizes bit-identically."""
        cont, paged = _mk_pair()
        kc, vc = cont.dequantize(jnp.float32)
        kp, vp = paged.dequantize(jnp.float32)
        t0 = int(cont.lengths[0])
        np.testing.assert_array_equal(
            np.asarray(kc[:, :, :t0]), np.asarray(kp[:, :, :t0])
        )
        np.testing.assert_array_equal(
            np.asarray(vc[:, :, :t0]), np.asarray(vp[:, :, :t0])
        )

    def test_decode_appends_odd_positions(self):
        """Single-step appends (odd/even parity, page-crossing lengths)
        stay bit-identical to the contiguous cache."""
        cont, paged = _mk_pair(t0=15)  # odd start for the first decode step
        for i in range(PAGE + 3):      # crosses a page boundary
            kn = jax.random.normal(jax.random.PRNGKey(100 + i), (B, HKV, 1, D))
            vn = jax.random.normal(jax.random.PRNGKey(200 + i), (B, HKV, 1, D))
            cont = cont.append(kn, vn)
            paged = paged.append(kn, vn)
        kc, _ = cont.dequantize(jnp.float32)
        kp, _ = paged.dequantize(jnp.float32)
        t = int(cont.lengths[0])
        np.testing.assert_array_equal(
            np.asarray(kc[:, :, :t]), np.asarray(kp[:, :, :t])
        )

    def test_page_zero_reserved_semantics(self):
        """Unused table entries point at page 0 and never alias live data."""
        _, paged = _mk_pair()
        assert int(paged.page_table[0, 0]) != 0  # live pages are not page 0
        fresh = paged.reset_slot(0)
        assert int(fresh.lengths[0]) == 0
        np.testing.assert_array_equal(
            np.asarray(fresh.page_table[0]), np.zeros(MAX_PAGES, np.int32)
        )

    def test_nbytes_and_geometry(self):
        _, paged = _mk_pair()
        assert paged.page_size == PAGE
        assert paged.max_seq == S
        assert paged.num_pages == NUM_PAGES
        # pool bytes ~= codes (2 pools at page/2) + 4 f32 affine planes
        expected = NUM_PAGES * HKV * (2 * (PAGE // 2) * D + 4 * PAGE * 4)
        assert paged.nbytes == expected


class TestPagedAttention:
    def test_decode_bit_equal_at_matching_tiling(self):
        """Page-table kernel == contiguous kernel when the contiguous tile
        equals the page size (identical accumulation order)."""
        cont, paged = _mk_pair()
        q = jax.random.normal(jax.random.PRNGKey(9), (B, HQ, D), jnp.float32)
        oc = int4_decode_attention(q, cont, block_s=PAGE, interpret=True)
        op = int4_decode_attention(q, paged, interpret=True)  # page_table
        np.testing.assert_array_equal(np.asarray(oc), np.asarray(op))

    def test_decode_vs_dense_golden(self):
        cont, paged = _mk_pair()
        q = jax.random.normal(jax.random.PRNGKey(9), (B, HQ, D), jnp.float32)
        op = int4_decode_attention(q, paged, interpret=True)
        kd, vd = cont.dequantize(jnp.float32)
        g = HQ // HKV
        kr, vr = jnp.repeat(kd, g, 1), jnp.repeat(vd, g, 1)
        s = jnp.einsum("bhd,bhsd->bhs", q * D ** -0.5, kr)
        mask = jnp.arange(S)[None, None] < cont.lengths[:, None, None]
        ref = jnp.einsum(
            "bhs,bhsd->bhd",
            jax.nn.softmax(jnp.where(mask, s, -1e30), -1), vr,
        )
        rel = float(jnp.linalg.norm(op - ref) / jnp.linalg.norm(ref))
        assert rel < 1e-2, rel  # kernel ladder tolerance

    def test_prefill_bit_equal_at_matching_tiling(self):
        cont, paged = _mk_pair()
        t = 8
        q = jax.random.normal(jax.random.PRNGKey(10), (B, HQ, t, D), jnp.float32)
        starts = cont.lengths - t
        o1 = int4_prefill_attention(q, cont, starts)
        o2 = int4_prefill_attention(q, paged, starts)
        np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))


class TestDecodeKernel:
    """The Triton-route decode kernel in the Pallas interpreter against the
    plain path, at several lengths per slot (tile and split boundaries)."""

    @pytest.mark.parametrize("lengths", [(1, 2), (17, 33), (48, 64), (63, 5)])
    @pytest.mark.parametrize("paged", [False, True])
    def test_matches_plain(self, lengths, paged):
        import dataclasses

        cont, pag = _mk_pair(t0=S)
        cache = pag if paged else cont
        cache = dataclasses.replace(cache, lengths=jnp.asarray(lengths, jnp.int32))
        q = jax.random.normal(jax.random.PRNGKey(11), (B, HQ, D), jnp.float32)
        got = int4_decode_attention(q, cache, interpret=True)
        want = int4_decode_attention(q, cache)     # plain on the CPU
        # the kernel rounds q, K/V and the softmax weights to bf16
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=3e-2, rtol=3e-2)

    def test_compiled_kernel_refuses_tiny_pages(self, monkeypatch):
        from fused4bit import platform

        _, pag = _mk_pair()
        monkeypatch.setattr(platform, "kernel_mode", lambda i=None: "compiled")
        q = jnp.zeros((B, HQ, D), jnp.float32)
        with pytest.raises(ValueError, match="power of two >= 32"):
            int4_decode_attention(q, pag)


class TestPagedModelAndEngine:
    @pytest.fixture(scope="class")
    def setup(self):
        from fused4bit.models.config import flagship_model_config
        from fused4bit.models.transformer import QuantizedTransformer

        cfg = flagship_model_config("tiny")
        model = QuantizedTransformer.init(jax.random.PRNGKey(0), cfg)
        return cfg, model

    def test_model_decode_paged_vs_contiguous(self, setup):
        """Full model: greedy logits through paged caches match contiguous
        caches within the cross-tiling rounding budget."""
        cfg, model = setup
        batch, max_seq, page = 2, 32, 16
        cont = model.init_cache(cfg, batch, max_seq)
        paged = model.init_paged_cache(
            cfg, batch, num_pages=2 * batch + 1, page_size=page,
            max_pages_per_slot=max_seq // page,
        )
        paged = tuple(
            c.assign_pages(0, [3, 1]).assign_pages(1, [4, 2]) for c in paged
        )
        toks = jnp.array([[5, 7, 2, 9], [1, 3, 3, 8]], jnp.int32)
        pos = jnp.broadcast_to(jnp.arange(4)[None], (batch, 4))
        lc, cont = model(toks, cont, pos)
        lp, paged = model(toks, paged, pos)
        del_rel = float(
            jnp.linalg.norm(lc - lp) / jnp.linalg.norm(lc)
        )
        assert del_rel < 2e-2, del_rel
        # one decode step each
        nxt = jnp.argmax(lc[:, -1], -1).astype(jnp.int32)[:, None]
        pos1 = jnp.full((batch, 1), 4, jnp.int32)
        lc1, _ = model(nxt, cont, pos1)
        lp1, _ = model(nxt, paged, pos1)
        assert float(jnp.linalg.norm(lc1 - lp1) / jnp.linalg.norm(lc1)) < 2e-2

    def test_engine_paged_matches_contiguous_greedy(self, setup):
        """End-to-end serving: the paged engine generates the same greedy
        tokens as the contiguous engine."""
        from fused4bit.serving.engine import GenerationRequest, ServingEngine

        cfg, model = setup
        kw = dict(num_slots=2, max_seq=64, prefill_bucket=8)
        reqs = [
            GenerationRequest(uid=0, prompt=[1, 2, 3], max_new_tokens=5),
            GenerationRequest(uid=1, prompt=[7, 8, 9, 4, 2], max_new_tokens=4),
            GenerationRequest(uid=2, prompt=[5], max_new_tokens=3),
        ]
        eng_c = ServingEngine(model, cfg, **kw)
        eng_p = ServingEngine(model, cfg, paged=True, page_size=16, **kw)
        for r in reqs:
            eng_c.submit(GenerationRequest(**vars(r)))
            eng_p.submit(GenerationRequest(**vars(r)))
        out_c = eng_c.run()
        out_p = eng_p.run()
        assert set(out_c) == set(out_p) == {0, 1, 2}
        for uid in out_c:
            assert len(out_c[uid]) == len(out_p[uid])
            # greedy chains may diverge after a near-tie (separately compiled
            # programs differ ~1 ULP; AGENTS.md); the first token must agree
            assert out_c[uid][0] == out_p[uid][0], (uid, out_c[uid], out_p[uid])

    def test_engine_page_pool_oversubscription(self, setup):
        """A pool smaller than num_slots*max_seq admits requests as pages
        free up — every request still completes (admission control)."""
        from fused4bit.serving.engine import GenerationRequest, ServingEngine

        cfg, model = setup
        # 5 pages of 16 = 80 positions for 2 slots x max_seq 64 (8 pages'
        # worth if contiguous): slot 2 must WAIT for slot 1's pages.
        eng = ServingEngine(
            model, cfg, num_slots=2, max_seq=64, prefill_bucket=8,
            paged=True, page_size=16, num_pages=6,
        )
        for uid in range(3):
            eng.submit(GenerationRequest(
                uid=uid, prompt=[1 + uid, 2, 3], max_new_tokens=30,
            ))
        out = eng.run()
        assert set(out) == {0, 1, 2}
        assert all(len(v) == 30 for v in out.values())
        # all pages returned
        assert sorted(eng._free_pages) == list(range(1, 6))

    def test_engine_request_too_big_for_pool(self, setup):
        from fused4bit.serving.engine import GenerationRequest, ServingEngine

        cfg, model = setup
        eng = ServingEngine(
            model, cfg, num_slots=2, max_seq=64, prefill_bucket=8,
            paged=True, page_size=16, num_pages=3,
        )
        eng.submit(GenerationRequest(uid=0, prompt=[1] * 40, max_new_tokens=8))
        with pytest.raises(ValueError, match="pages"):
            eng.run()

    def test_prefix_caching_shares_pages_and_matches(self, setup):
        """Requests sharing a full-page prompt prefix reuse the SAME
        physical pages (refcounted), skip re-prefilling them, and still
        generate the same tokens as an engine with prefix caching off."""
        from fused4bit.serving.engine import GenerationRequest, ServingEngine

        cfg, model = setup
        prefix = list(range(1, 17))            # exactly one 16-token page
        prompts = [prefix + [30], prefix + [40, 41], prefix + [50]]
        outs = {}
        for pc in (True, False):
            eng = ServingEngine(
                model, cfg, num_slots=3, max_seq=64, prefill_bucket=8,
                paged=True, page_size=16, prefix_caching=pc,
            )
            for uid, p in enumerate(prompts):
                eng.submit(GenerationRequest(uid=uid, prompt=p, max_new_tokens=4))
            outs[pc] = eng.run()
            if pc:
                stats = eng.prefix_stats
                assert stats["hits"] == 2, stats          # requests 2 and 3
                assert stats["shared_tokens"] == 32, stats
                # after the run: no slot holds pages, but the prefix entry
                # is RETAINED for future hits; retained + free = whole pool
                assert all(r == 0 for r in eng._page_refs)
                assert eng._prefix_entries
                retained = {p for ks in [eng._page_keys] for p in ks}
                assert len(retained) + len(eng._free_pages) == eng.num_pages - 1
        for uid in range(3):
            assert outs[True][uid][0] == outs[False][uid][0], (
                uid, outs[True][uid], outs[False][uid]
            )
            assert len(outs[True][uid]) == len(outs[False][uid])

    def test_prefix_pages_refcounted_across_retirement(self, setup):
        """A shared page frees only when the LAST holder retires; prefix
        entries die with it."""
        from fused4bit.serving.engine import GenerationRequest, ServingEngine

        cfg, model = setup
        eng = ServingEngine(
            model, cfg, num_slots=2, max_seq=64, prefill_bucket=8,
            paged=True, page_size=16,
        )
        prefix = list(range(2, 18))
        # long-runner holds the prefix while the short one comes and goes
        eng.submit(GenerationRequest(uid=0, prompt=prefix + [1], max_new_tokens=12))
        eng.submit(GenerationRequest(uid=1, prompt=prefix + [9], max_new_tokens=2))
        eng._admit()  # admits both (hit for uid=1) without decoding yet
        assert eng.prefix_stats["hits"] == 1
        shared = [p for p, r in enumerate(eng._page_refs) if r == 2]
        assert len(shared) == 1                 # the one prefix page
        while 1 in {r.uid for r in eng.active.values()}:
            eng.step()
        # uid=1 retired; the shared page must still be held by uid=0
        assert eng._page_refs[shared[0]] == 1
        assert eng._prefix_entries            # entry survives
        eng.run()
        # run done: page retained (refs 0, entry alive), NOT free
        assert eng._page_refs[shared[0]] == 0
        assert eng._prefix_entries
        assert shared[0] not in eng._free_pages
        # allocation pressure evicts the LRU entry and frees the page
        eng._evict_prefix_entries(len(eng._free_pages) + 1)
        assert eng._prefix_entries == {}
        assert shared[0] in eng._free_pages
        assert eng.prefix_stats["evictions"] >= 1

    def test_prefix_retention_hits_sequential_requests(self, setup):
        """The system-prompt scenario: requests arrive AFTER earlier holders
        retired — retained pages still hit; eviction reclaims them under
        pool pressure without breaking completions."""
        from fused4bit.serving.engine import GenerationRequest, ServingEngine

        cfg, model = setup
        sys_prompt = list(range(3, 19))  # one full 16-token page
        eng = ServingEngine(
            model, cfg, num_slots=1, max_seq=64, prefill_bucket=8,
            paged=True, page_size=16, num_pages=5,  # tight pool: 4 usable
        )
        outs = {}
        for uid in range(3):  # strictly sequential (1 slot)
            eng.submit(GenerationRequest(
                uid=uid, prompt=sys_prompt + [40 + uid], max_new_tokens=3,
            ))
            outs.update(eng.run())
        assert eng.prefix_stats["hits"] == 2      # uid 1 and 2 hit retention
        assert eng.prefix_stats["shared_tokens"] == 32
        assert len(outs) == 3 and all(len(v) == 3 for v in outs.values())
        # 4-usable-page pool: each request needs 2 pages (17+1+2 positions)
        # while 1 stays retained -> eviction pressure must have been survivable
        assert all(r == 0 for r in eng._page_refs)

    @staticmethod
    def _check_allocator(eng):
        """Global allocator invariants: a page is free XOR held XOR retained;
        refcounts equal the number of slot tables holding the page; no page
        is handed out twice."""
        held = {}
        for slot, pages in eng._slot_pages.items():
            assert len(set(pages)) == len(pages), f"dup pages in slot {slot}"
            for p in pages:
                held[p] = held.get(p, 0) + 1
        free = set(eng._free_pages)
        assert len(free) == len(eng._free_pages), "duplicate free pages"
        assert not (free & set(held)), f"page both free and held: {free & set(held)}"
        for p in range(1, eng.num_pages):
            assert eng._page_refs[p] == held.get(p, 0), (
                p, eng._page_refs[p], held.get(p, 0)
            )
            retained = bool(eng._page_keys.get(p)) and eng._page_refs[p] == 0
            if retained:
                assert p not in free, f"retained page {p} also free"
            if eng._page_refs[p] == 0 and not eng._page_keys.get(p):
                assert p in free, f"page {p} leaked (no refs, no entry, not free)"

    def test_eviction_never_reclaims_matched_prefix(self, setup):
        """Review regression: admission pressure that triggers LRU eviction
        while a prefix hit is in flight must never free the matched entry's
        pages (they'd be handed out as fresh pages and overwritten). The
        pinned pages survive; the allocator invariants hold after every
        step; the hit request generates the same first token as an
        uncached engine."""
        from fused4bit.serving.engine import GenerationRequest, ServingEngine

        cfg, model = setup
        mk = lambda pc: ServingEngine(  # noqa: E731
            model, cfg, num_slots=2, max_seq=64, prefill_bucket=8,
            paged=True, page_size=16, num_pages=6, prefix_caching=pc,
        )
        eng = mk(True)
        prefix32 = list(range(1, 33))          # two full pages
        # A: registers the 2-page prefix, retires -> pages retained
        eng.submit(GenerationRequest(uid=0, prompt=prefix32 + [40], max_new_tokens=2))
        while eng.active or eng.queue:
            eng.step()
            self._check_allocator(eng)
        # X: unrelated request holding pages
        eng.submit(GenerationRequest(uid=1, prompt=[50 + i for i in range(17)],
                                     max_new_tokens=12))
        eng._admit()
        self._check_allocator(eng)
        # B: hits A's prefix, needs fresh pages beyond what's free ->
        # eviction pressure with the matched entry's pages pinned
        eng.submit(GenerationRequest(uid=2, prompt=prefix32 + [41], max_new_tokens=8))
        while eng.active or eng.queue:
            eng.step()
            self._check_allocator(eng)
        out = dict(eng.finished)
        assert set(out) == {0, 1, 2}
        # same first token as an engine without prefix caching
        eng0 = mk(False)
        eng0.submit(GenerationRequest(uid=2, prompt=prefix32 + [41], max_new_tokens=8))
        out0 = eng0.run()
        assert out[2][0] == out0[2][0], (out[2], out0[2])

    def test_paged_decode_block_crosses_page_boundary(self, setup):
        """Fused decode_block steps that cross a page boundary mid-block
        write through the table correctly: output matches a decode_block=1
        paged engine and the contiguous engine (first token exact, same
        lengths)."""
        from fused4bit.serving.engine import GenerationRequest, ServingEngine

        cfg, model = setup
        prompt = list(range(1, 15))  # 14 tokens; page 16 -> decode crosses at 16
        outs = {}
        for name, kw in (
            ("blk4", dict(paged=True, page_size=16, decode_block=4)),
            ("blk1", dict(paged=True, page_size=16, decode_block=1)),
            ("cont", dict()),
        ):
            eng = ServingEngine(model, cfg, num_slots=2, max_seq=64,
                                prefill_bucket=8, **kw)
            eng.submit(GenerationRequest(uid=0, prompt=prompt, max_new_tokens=8))
            outs[name] = eng.run()[0]
        assert len(outs["blk4"]) == len(outs["blk1"]) == len(outs["cont"]) == 8
        # same compiled-program family for the two paged engines' prefill;
        # greedy chains may wobble at near-ties across program families, but
        # the first tokens must agree everywhere
        assert outs["blk4"][0] == outs["blk1"][0] == outs["cont"][0]
        assert outs["blk4"][:3] == outs["blk1"][:3]

    def test_top_p_zero_rejected(self, setup):
        from fused4bit.serving.engine import Sampler

        with pytest.raises(ValueError, match="top_p"):
            Sampler(temperature=1.0, top_p=0.0)

    def test_engine_invalid_page_config(self, setup):
        from fused4bit.serving.engine import ServingEngine

        cfg, model = setup
        with pytest.raises(ValueError, match="multiple of prefill_bucket"):
            ServingEngine(model, cfg, num_slots=2, max_seq=64,
                          prefill_bucket=12, paged=True, page_size=16)
        with pytest.raises(ValueError, match="multiple of page_size"):
            ServingEngine(model, cfg, num_slots=2, max_seq=72,
                          prefill_bucket=8, paged=True, page_size=16)
