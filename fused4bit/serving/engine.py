"""Continuous-batching decode engine.

The serving loop the reference aspires to ("Serving real traffic? → INT4",
`README.md:106-118`) but doesn't ship. Design:

* A fixed number of **batch slots** (static shapes; jit-compiled once).
* Each slot runs one request; per-slot KV lengths and positions advance
  independently (`QuantizedKVCache.lengths`).
* When a slot finishes (EOS or max tokens), the next queued request is
  **prefilled into that slot** while the other slots keep decoding — classic
  continuous batching, expressed with two compiled programs:
  `prefill(slot)` (prompt padded to a bucket length) and `decode_step()`
  (one token for every active slot).
* Sampling: greedy / temperature / top-k, compiled into the step.

Single-chip by design here; the parallel layer (EP/TP shard_map functions)
slots in underneath via the same model pytree.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["GenerationRequest", "Sampler", "ServingEngine"]


@dataclasses.dataclass
class GenerationRequest:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_token: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Compiled-in sampling config (greedy / temperature / top-k / top-p)."""

    temperature: float = 0.0       # 0 -> greedy
    top_k: int = 0                 # 0 -> full distribution
    top_p: float = 1.0             # 1 -> no nucleus truncation

    def __post_init__(self):
        # top_p == 0 would mask EVERY token (the exclusive-cumsum keep rule
        # `mass_before < p` fails even for the top-1) and degenerate to
        # uniform sampling over the whole vocabulary — refuse loudly.
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")

    def sample(self, logits: jnp.ndarray, key: jax.Array) -> jnp.ndarray:
        """logits [B, V] -> tokens [B]."""
        if self.temperature == 0.0:
            return jnp.argmax(logits, axis=-1).astype(jnp.int32)
        scaled = logits.astype(jnp.float32) / self.temperature
        if self.top_k > 0:
            vals, _ = jax.lax.top_k(scaled, self.top_k)
            cutoff = vals[:, -1][:, None]
            scaled = jnp.where(scaled < cutoff, -1e30, scaled)
        if self.top_p < 1.0:
            # Nucleus: keep the smallest prefix of the sorted distribution
            # whose mass reaches top_p. Static shapes: sort + exclusive
            # cumsum; a token stays if the mass STRICTLY BEFORE it is < p
            # (the top-1 token always stays).
            srt = jnp.sort(scaled, axis=-1)[:, ::-1]
            probs = jax.nn.softmax(srt, axis=-1)
            before = jnp.cumsum(probs, axis=-1) - probs
            kept = jnp.where(before < self.top_p, srt, jnp.inf)
            cutoff = jnp.min(kept, axis=-1, keepdims=True)  # worst kept logit
            scaled = jnp.where(scaled < cutoff, -1e30, scaled)
        return jax.random.categorical(key, scaled, axis=-1).astype(jnp.int32)


class ServingEngine:
    """Continuous-batching engine over a QuantizedTransformer."""

    def __init__(
        self,
        model,
        cfg,
        *,
        num_slots: int = 4,
        max_seq: int = 256,
        prefill_bucket: int = 32,
        sampler: Sampler = Sampler(),
        seed: int = 0,
        mesh=None,
        interpret=None,
        decode_block: int = 1,
        paged: bool = False,
        page_size: int = 128,  # compiled paged decode: a power of two >= 32
        num_pages: Optional[int] = None,
        prefix_caching: bool = True,
        on_token=None,
        draft_model=None,
        draft_cfg=None,
        spec_gamma: int = 4,
    ):
        """`mesh`: run every forward through the fully sharded model step
        (DP batch x EP experts, `parallel.sharded_model`). The model must
        already be placed with `place_model`, and num_slots must divide by
        the data-axis size.

        `decode_block`: number of decode steps fused into ONE compiled
        program (`lax.scan` over steps, sampling in-graph, per-slot
        early-inactive masks). Each host dispatch has a fixed cost whatever
        its work, so decoding D tokens per dispatch raises serving
        throughput until device time dominates — the serving analogue of the reference
        killing its per-expert `.item()` syncs
        (`csrc/moe_int4_kernel.cu:112-134`). Slots that
        finish (EOS / budget) mid-block idle until the block ends, so very
        large D trades tail latency."""
        self.model = model
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.prefill_bucket = prefill_bucket
        self.sampler = sampler
        self.mesh = mesh
        self.interpret = interpret
        # Chunked prefill pads the final chunk to a full bucket; if the bucket
        # grid didn't tile max_seq, that padded append could cross max_seq and
        # dynamic_update_slice's silent clamp would shear the packed codes from
        # their scales, corrupting earlier valid positions.
        if max_seq % prefill_bucket != 0:
            raise ValueError(
                f"max_seq ({max_seq}) must be a multiple of prefill_bucket "
                f"({prefill_bucket}) so chunked prefill never writes past the cache"
            )

        self.paged = paged
        if paged:
            # Paged KV (`layers.paged_kv`): slots borrow fixed-size pages
            # from a shared pool instead of owning max_seq positions each.
            # The pool can be sized BELOW num_slots*max_seq — admission then
            # waits for pages instead of refusing, which is the whole point.
            if mesh is not None:
                raise ValueError("paged KV is single-chip for now (no mesh)")
            if page_size % prefill_bucket != 0:
                raise ValueError(
                    f"page_size ({page_size}) must be a multiple of "
                    f"prefill_bucket ({prefill_bucket}) so every prefill "
                    "chunk lands inside one page"
                )
            if max_seq % page_size != 0:
                raise ValueError(
                    f"max_seq ({max_seq}) must be a multiple of page_size "
                    f"({page_size})"
                )
            max_pages = max_seq // page_size
            if num_pages is None:
                # contiguous-equivalent capacity; page 0 is the reserved
                # parked page (never allocated: unused table entries and
                # retired slots' masked writes all land there)
                num_pages = num_slots * max_pages + 1
            self.page_size = page_size
            self.num_pages = num_pages
            self._free_pages = list(range(num_pages - 1, 0, -1))  # pop -> 1..
            self._slot_pages: Dict[int, List[int]] = {}
            # Prefix caching: requests whose prompts share full-page token
            # prefixes point their tables at the SAME physical pages and skip
            # re-prefilling them (K/V for identical token prefixes is
            # identical — causal attention + deterministic quantization).
            # Lifecycle: per-page refcounts count the slots holding a page;
            # when the last holder retires, a page referenced by a prefix
            # entry is RETAINED (stale-free: nothing writes a table-less
            # page) so later requests with the same system prompt still hit.
            # Retained pages are reclaimed lazily — allocation pressure
            # evicts least-recently-used entries until enough pages free.
            # Only full PROMPT pages register, so decode-time writes never
            # touch shared pages.
            self.prefix_caching = prefix_caching
            self._page_refs = [0] * num_pages
            self._prefix_entries: Dict[tuple, tuple] = {}  # tokens -> page ids
            self._page_keys: Dict[int, set] = {}           # page -> entry keys
            self._entry_lru: Dict[tuple, None] = {}        # insertion = LRU
            self.prefix_stats = {
                "lookups": 0, "hits": 0, "shared_tokens": 0, "evictions": 0,
            }
            self.caches = model.init_paged_cache(
                cfg, num_slots, num_pages=num_pages, page_size=page_size,
                max_pages_per_slot=max_pages,
            )
        else:
            self.caches = model.init_cache(cfg, num_slots, max_seq)
        self.queue: Deque[GenerationRequest] = deque()
        self.active: Dict[int, GenerationRequest] = {}   # slot -> request
        self.generated: Dict[int, List[int]] = {}        # uid -> tokens
        self.finished: Dict[int, List[int]] = {}
        self.logprobs: Dict[int, List[float]] = {}       # uid -> per-token lp
        self.finished_logprobs: Dict[int, List[float]] = {}
        # streaming hook: called as on_token(uid, token_id, logprob) the
        # moment each token is APPENDED on the host (after the fused block
        # returns, so decode_block trades streaming granularity for speed)
        self.on_token = on_token

        # Speculative continuous batching: a draft model turns each decode
        # dispatch pair (draft-gamma scan + one verify forward) into
        # 1..gamma+1 tokens PER SLOT, with per-slot acceptance — rejected
        # positions disowned by per-row cache-length rollback exactly as in
        # serving.speculative. Greedy only (acceptance math is argmax
        # agreement); incompatible with decode_block>1 (speculation IS the
        # fused block), mesh, and paged KV (draft cache paging: future).
        self.draft_model = draft_model
        if draft_model is not None:
            from .speculative import SpeculativeDecoder, SpecStats

            if decode_block > 1:
                raise ValueError("draft_model replaces decode_block; use one")
            if mesh is not None or paged:
                raise ValueError(
                    "speculative serving is single-chip contiguous-cache for now"
                )
            if sampler.temperature != 0.0:
                raise ValueError(
                    "speculative serving is greedy-only (temperature=0)"
                )
            self.draft_cfg = draft_cfg or cfg
            self._spec = SpeculativeDecoder(
                model, draft_model, cfg, self.draft_cfg, gamma=spec_gamma,
            )
            self.spec_stats = SpecStats()
            self.draft_caches = draft_model.init_cache(
                self.draft_cfg, num_slots, max_seq
            )
        self._free = list(range(num_slots))
        self._cur = np.zeros((num_slots,), np.int32)     # last token per slot
        self._pos = np.zeros((num_slots,), np.int32)     # next position
        self._remaining = np.zeros((num_slots,), np.int32)
        self._key = jax.random.PRNGKey(seed)

        if decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, got {decode_block}")
        # token-0 logprob runs OUTSIDE the prefill program; jit it so each
        # admission pays one compiled dispatch, not an eager op chain
        self._logprob0 = jax.jit(self._logprob_of)
        # cancel() called from inside an on_token callback would mutate
        # self.active while the step loops iterate it (KeyError) — defer
        # such cancels to the end of the step
        self._stepping = False
        self._deferred_cancels: List[int] = []
        self.decode_block = decode_block
        self._decode = jax.jit(self._decode_impl)
        self._decode_blk = jax.jit(self._decode_block_impl)
        if mesh is None:
            self._prefill = jax.jit(self._prefill_impl)
        else:
            self._prefill = jax.jit(self._prefill_sharded_impl)

    def _forward(self, model, tokens, caches, positions):
        if self.mesh is None:
            return model(tokens, caches, positions)
        from ..parallel.sharded_model import sharded_decode_step

        return sharded_decode_step(
            model, self.mesh, tokens, caches, positions,
            interpret=self.interpret,
        )

    # -- compiled programs --------------------------------------------------

    @staticmethod
    def _logprob_of(logits, tokens):
        """log softmax of `logits` [B, V] gathered at `tokens` [B] -> [B]."""
        lsm = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return jnp.take_along_axis(lsm, tokens[:, None], axis=1)[:, 0]

    def _decode_impl(self, model, caches, cur, pos, key, active_mask):
        tokens = cur[:, None]
        logits, caches = self._forward(model, tokens, caches, pos[:, None])
        nxt = self.sampler.sample(logits[:, 0], key)
        # Inactive slots keep emitting token 0 at a parked position; their
        # cache writes land at their stale position and are masked by causal
        # attention for other slots (batch rows never interact).
        nxt = jnp.where(active_mask, nxt, 0)
        return nxt, self._logprob_of(logits[:, 0], nxt), caches

    def _decode_block_impl(
        self, model, caches, cur, pos, remaining, eos, key, active
    ):
        """`decode_block` decode steps in ONE compiled program.

        lax.scan over steps; sampling + EOS/budget retirement masks run
        in-graph. Returns the per-step tokens [D, B] and the was-active
        mask [D, B] so the host appends exactly the tokens each slot
        actually generated. Slots that retire mid-block keep running with
        a parked token (masked inactive) — their cache writes land at a
        stale position and never corrupt live rows (same invariant as
        `_decode_impl`).
        """

        def body(carry, _):
            caches, cur, pos, remaining, active, key = carry
            key, sub = jax.random.split(key)
            logits, caches = self._forward(model, cur[:, None], caches, pos[:, None])
            nxt = self.sampler.sample(logits[:, 0], sub)
            nxt = jnp.where(active, nxt, 0)
            lp = self._logprob_of(logits[:, 0], nxt)
            act_i = active.astype(jnp.int32)
            new_rem = remaining - act_i
            finished = active & ((nxt == eos) | (new_rem <= 0))
            out_tok, out_act = nxt, active
            cur = jnp.where(active, nxt, cur)
            pos = pos + act_i
            active = active & ~finished
            return (caches, cur, pos, new_rem, active, key), (out_tok, out_act, lp)

        (caches, cur, pos, remaining, active, _), (toks, acts, lps) = jax.lax.scan(
            body, (caches, cur, pos, remaining, active, key), None,
            length=self.decode_block,
        )
        return caches, cur, pos, remaining, active, toks, acts, lps

    def _prefill_impl(self, model, caches, prompt_row, slot, start_pos):
        """Prefill one slot with a [bucket]-padded prompt (batch of 1 lane).

        Runs the full batch through the model but only the target slot's
        row carries real tokens; other rows re-process a dummy row at
        position parked past their current content? — No: cheaper and safer
        is a dedicated batch-1 forward on a sliced cache; JAX slices and
        re-inserts the slot's cache rows.
        """
        # Cache-type-polymorphic slicing: the contiguous cache slices every
        # batch-major array; the paged cache slices its table/length rows and
        # SHARES the pools (the slot's pages are exclusively its own).
        sliced = tuple(c.slice_slot(slot) for c in caches)
        t = prompt_row.shape[0]
        positions = (start_pos + jnp.arange(t, dtype=jnp.int32))[None, :]
        logits, sliced = model(prompt_row[None, :], sliced, positions)
        caches = tuple(
            full.merge_slot(part, slot) for full, part in zip(caches, sliced)
        )
        # all positions' logits — the caller picks true_len-1 (the bucket tail
        # is right-padding junk)
        return logits[0], caches

    def _prefill_sharded_impl(self, model, caches, prompt_row, slot, start_pos):
        """Sharded prefill: run the FULL batch through the sharded step.

        Batch-dim slicing fights the data sharding, so instead every slot
        participates: the target row carries the padded prompt at positions
        [0, bucket); other rows process dummy zeros at their own current
        lengths. Afterwards every non-target row's length is rewound to its
        previous value — the garbage its dummy pass appended sits above its
        length and is overwritten by its next real decode step before being
        read (same invariant as the right-pad rewind).
        """
        t = prompt_row.shape[0]
        b = self.num_slots
        old_lengths = caches[0].lengths
        tokens = jnp.zeros((b, t), jnp.int32)
        tokens = jax.lax.dynamic_update_slice(tokens, prompt_row[None, :], (slot, 0))
        # Dummy rows write into the reserved tail scratch region
        # [max_seq - bucket, max_seq) — never into live history (active rows
        # are budget-capped below max_seq - bucket in mesh mode, see _admit).
        park = jnp.int32(self.max_seq - t)
        # The target row's chunk starts at start_pos (chunked prefill passes
        # c*bucket for chunk c) — hardcoding 0 here wrote every chunk's K/V at
        # positions [0, bucket) with wrong RoPE phases.
        row_starts = jnp.where(jnp.arange(b) == slot, start_pos, park)
        positions = row_starts[:, None] + jnp.arange(t, dtype=jnp.int32)[None, :]
        logits, caches = self._forward(model, tokens, caches, positions)
        # rewind every non-target row to its previous length
        caches = tuple(
            dataclasses.replace(
                c,
                lengths=jnp.where(
                    jnp.arange(b) == slot, c.lengths, old_lengths
                ),
            )
            for c in caches
        )
        return logits[slot], caches

    # -- public API ----------------------------------------------------------

    def submit(self, req: GenerationRequest) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        while self._free and self.queue:
            slot = self._free.pop()
            req = self.queue.popleft()
            prompt = np.asarray(req.prompt, np.int32)
            true_len = len(prompt)
            bucket = self.prefill_bucket
            reserved = self.prefill_bucket if self.mesh is not None else 0
            if self.draft_model is not None:
                # spec rounds write up to gamma+1 positions past `pos`; keep
                # the LOUD check and the decode budget consistent (a prompt
                # that passes validation but gets budget <= 0 would retire
                # with one token silently)
                reserved += self._spec.gamma + 1
            if true_len > self.max_seq - 1 - reserved:
                # Refusing loudly beats silent truncation (prompt[-bucket:]
                # generated from a corrupted head).
                raise ValueError(
                    f"prompt length {true_len} exceeds cache budget "
                    f"{self.max_seq - 1 - reserved} (max_seq={self.max_seq})"
                )
            shared_len = 0            # prompt tokens whose K/V is reused
            shared_pages: List[int] = []
            if self.paged:
                page = self.page_size
                hit_key = None
                digests: List[str] = []
                if self.prefix_caching:
                    # Chained per-page digests: O(prompt) total hashing and
                    # O(1)-size keys (a full-token-tuple key costs
                    # O(prompt^2/page) hashing and retains O(prompt) memory
                    # per entry). Lookup walks ascending and
                    # keeps the LONGEST hit, capped so >=1 tail token still
                    # runs through prefill (its logits produce token 0).
                    digests = self._prefix_digests(prompt, true_len // page)
                    n_look = min((true_len - 1) // page, len(digests))
                    if n_look > 0:
                        self.prefix_stats["lookups"] += 1
                    for i in range(n_look):
                        ent = self._prefix_entries.get(digests[i])
                        if ent is not None:
                            hit_key = digests[i]
                            shared_pages = list(ent)
                            shared_len = (i + 1) * page
                    # Pin the matched pages NOW (their allocation ref):
                    # eviction below must never free a page this admission is
                    # about to put in its table (the LRU loop could evict the matched entry itself and hand its
                    # pages back out as fresh ones).
                    for p in shared_pages:
                        self._page_refs[p] += 1
                # Allocate this request's page working set up front: enough
                # for the padded prefill AND the whole decode budget (so a
                # running slot never stalls mid-decode waiting for a page).
                num_chunks = max(1, -(-(true_len - shared_len) // bucket))
                planned = min(
                    req.max_new_tokens - 1, self.max_seq - true_len - 1
                )
                positions = max(
                    shared_len + num_chunks * bucket,
                    true_len + 1 + max(planned, 0),
                )
                pages_needed = -(-positions // page)
                if pages_needed > self.num_pages - 1:
                    raise ValueError(
                        f"request needs {pages_needed} pages; pool has "
                        f"{self.num_pages - 1} (num_pages-1; page 0 is "
                        "reserved) — grow num_pages or shrink the request"
                    )
                fresh_needed = pages_needed - len(shared_pages)
                if fresh_needed > len(self._free_pages):
                    # Reclaim retained prefix pages (LRU entries) first.
                    self._evict_prefix_entries(fresh_needed)
                if fresh_needed > len(self._free_pages):
                    # No room NOW: requeue at the front and wait for a
                    # retirement to free pages (this is the admission-control
                    # behavior paging buys; the contiguous engine would have
                    # needed the full max_seq reserved per slot up front).
                    for p in shared_pages:
                        self._release_page(p)  # undo the pin
                    self.queue.appendleft(req)
                    self._free.append(slot)
                    break
                fresh = [self._free_pages.pop() for _ in range(fresh_needed)]
                pages = shared_pages + fresh
                for p in fresh:
                    self._page_refs[p] = 1
                self._slot_pages[slot] = pages
                self.caches = tuple(
                    c.assign_pages(slot, pages) for c in self.caches
                )
                if self.prefix_caching:
                    if hit_key is not None:  # stats/LRU only on SUCCESS
                        self.prefix_stats["hits"] += 1
                        self.prefix_stats["shared_tokens"] += shared_len
                        self._entry_lru.pop(hit_key, None)
                        self._entry_lru[hit_key] = None
                    # Register every full PROMPT page of this request (decode
                    # writes start at true_len, beyond all of them); nested
                    # keys share page-list prefixes.
                    for n, key in enumerate(digests, start=1):
                        if key not in self._prefix_entries:
                            self._prefix_entries[key] = tuple(pages[:n])
                            self._entry_lru[key] = None
                            for p in pages[:n]:
                                self._page_keys.setdefault(p, set()).add(key)
            else:
                num_chunks = max(1, -(-true_len // bucket))
            # CHUNKED prefill: loop bucket-sized chunks through the one
            # compiled prefill program. Each chunk appends its K/V at
            # positions [start, start+bucket); the final chunk is RIGHT-padded
            # to the compile bucket — exactly correct because the junk sits at
            # positions > every real token (causal masking hides it during
            # prefill), the slot's length is rewound to true_len afterwards,
            # and each decode step overwrites junk at position p before the
            # same step's attention reads p.
            # With a prefix-cache hit the first shared_len tokens are already
            # in the slot's (shared) pages — prefill covers only the tail.
            tail = true_len - shared_len  # >= 1 (lookup keeps a tail token)
            last_start = (num_chunks - 1) * bucket
            rem = tail - last_start  # tokens in the final chunk (1..bucket)
            for c in range(num_chunks):
                start = shared_len + c * bucket
                chunk = prompt[start : min(start + bucket, true_len)]
                padded = np.pad(chunk, (0, bucket - len(chunk)))
                logits_all, self.caches = self._prefill(
                    self.model, self.caches, jnp.asarray(padded),
                    jnp.int32(slot), jnp.int32(start),
                )
                if self.draft_model is not None:
                    _, self.draft_caches = self._prefill(
                        self.draft_model, self.draft_caches,
                        jnp.asarray(padded), jnp.int32(slot),
                        jnp.int32(start),
                    )
            # rewind slot length to the real prompt length
            self.caches = tuple(
                dataclasses.replace(
                    c, lengths=c.lengths.at[slot].set(true_len)
                )
                for c in self.caches
            )
            if self.draft_model is not None:
                self.draft_caches = tuple(
                    dataclasses.replace(
                        c, lengths=c.lengths.at[slot].set(true_len)
                    )
                    for c in self.draft_caches
                )
            # First generated token goes through the configured sampler too
            # (a hardcoded argmax would bypass temperature sampling for
            # token 0 of every request).
            self._key, sub = jax.random.split(self._key)
            nxt = int(self.sampler.sample(logits_all[rem - 1][None, :], sub)[0])
            lp0 = float(self._logprob0(
                logits_all[rem - 1][None, :], jnp.asarray([nxt], jnp.int32)
            )[0])
            self.active[slot] = req
            self.generated[req.uid] = [nxt]
            self.logprobs[req.uid] = [lp0]
            if self.on_token is not None:
                self.on_token(req.uid, nxt, lp0)
            self._cur[slot] = nxt
            self._pos[slot] = true_len
            # Never let a slot write past max_seq: dynamic_update_slice would
            # silently clamp and corrupt the cache tail. Budget = positions
            # left after the prompt, minus 1 for the step in flight.
            reserved = self.prefill_bucket if self.mesh is not None else 0
            if self.draft_model is not None:
                # a spec round writes up to gamma+1 positions past `pos`
                reserved += self._spec.gamma + 1
            budget = self.max_seq - true_len - 1 - reserved
            self._remaining[slot] = min(req.max_new_tokens - 1, budget)
            if self._remaining[slot] <= 0 or nxt == req.eos_token:
                self._retire(slot)

    def _retire(self, slot: int) -> None:
        req = self.active.pop(slot)
        self.finished[req.uid] = self.generated.pop(req.uid)
        self.finished_logprobs[req.uid] = self.logprobs.pop(req.uid, [])
        self.caches = tuple(c.reset_slot(slot) for c in self.caches)
        if self.draft_model is not None:
            self.draft_caches = tuple(
                c.reset_slot(slot) for c in self.draft_caches
            )
            # park the retired slot at position 0: spec rounds write
            # [pos, pos+gamma+1) for EVERY row, and a stale pos near
            # max_seq would silently clamp (the junk at [0, gamma+2) is
            # overwritten by the slot's next prefill from position 0)
            self._pos[slot] = 0
            self._cur[slot] = 0
        if self.paged:
            for p in self._slot_pages.pop(slot, ()):
                self._page_refs[p] -= 1
                if self._page_refs[p] == 0 and not self._page_keys.get(p):
                    # no prefix entry references it -> truly free; pages
                    # under a prefix entry are RETAINED for future hits and
                    # reclaimed by _evict_prefix_entries under pressure
                    self._free_pages.append(p)
        self._free.append(slot)

    def _prefix_digests(self, prompt, n_pages: int) -> List[str]:
        """Chained SHA-256 over full prompt pages: digests[i] keys
        prompt[: (i+1)*page_size]. Cumulative updates make the whole list
        O(prompt) work; 256-bit keys make collisions (which would silently
        alias different prefixes) cryptographically negligible."""
        import hashlib

        h = hashlib.sha256()
        out = []
        for n in range(n_pages):
            h.update(
                np.ascontiguousarray(
                    prompt[n * self.page_size : (n + 1) * self.page_size],
                    np.int32,
                ).tobytes()
            )
            out.append(h.hexdigest())
        return out

    def _release_page(self, p: int) -> None:
        """Drop one reference; free the page when nothing holds OR retains
        it (an orphan pinned through its entry's eviction must not leak)."""
        self._page_refs[p] -= 1
        if self._page_refs[p] == 0 and not self._page_keys.get(p):
            self._free_pages.append(p)

    def _drop_prefix_entry(self, key) -> None:
        ent = self._prefix_entries.pop(key, None)
        self._entry_lru.pop(key, None)
        if not ent:
            return
        for p in ent:
            keys = self._page_keys.get(p)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._page_keys[p]
                    if self._page_refs[p] == 0:
                        self._free_pages.append(p)

    def _evict_prefix_entries(self, need: int) -> None:
        """Drop least-recently-used prefix entries until `need` pages are
        free, no entries remain, or nothing RECLAIMABLE remains (pages held
        or pinned by a slot — refs > 0 — survive their entries and free
        later through _retire; evicting past them would wipe the whole
        retained cache for zero freed pages)."""
        while need > len(self._free_pages) and self._entry_lru:
            if not any(
                self._page_refs[p] == 0 for p in self._page_keys
            ):
                return  # every retained page is ref-held; eviction is futile
            key = next(iter(self._entry_lru))
            self._drop_prefix_entry(key)
            self.prefix_stats["evictions"] += 1

    def step(self) -> int:
        """Admit queued requests, decode `decode_block` tokens for every
        active slot in one compiled dispatch; returns #active."""
        self._stepping = True
        try:
            return self._step_inner()
        finally:
            self._stepping = False
            self._flush_deferred_cancels()

    def _step_inner(self) -> int:
        self._admit()
        if not self.active:
            return 0
        if self.draft_model is not None:
            return self._step_spec()
        if self.decode_block > 1:
            return self._step_block()
        active_mask = np.zeros((self.num_slots,), bool)
        for s in self.active:
            active_mask[s] = True
        self._key, sub = jax.random.split(self._key)
        nxt, lps, self.caches = self._decode(
            self.model, self.caches,
            jnp.asarray(self._cur), jnp.asarray(self._pos),
            sub, jnp.asarray(active_mask),
        )
        nxt = np.asarray(nxt)
        lps = np.asarray(lps)
        self._pos += active_mask.astype(np.int32)
        for slot in list(self.active):
            tok = int(nxt[slot])
            req = self.active[slot]
            self.generated[req.uid].append(tok)
            self.logprobs[req.uid].append(float(lps[slot]))
            if self.on_token is not None:
                self.on_token(req.uid, tok, float(lps[slot]))
            self._cur[slot] = tok
            self._remaining[slot] -= 1
            if self._remaining[slot] <= 0 or tok == req.eos_token:
                self._retire(slot)
        return len(self.active)

    def _step_block(self) -> int:
        """One dispatch of the fused `decode_block`-step program."""
        d = self.decode_block
        active_mask = np.zeros((self.num_slots,), bool)
        eos = np.full((self.num_slots,), -1, np.int32)
        for s, req in self.active.items():
            active_mask[s] = True
            if req.eos_token is not None:
                eos[s] = req.eos_token
        self._key, sub = jax.random.split(self._key)
        (self.caches, cur, pos, remaining, active, toks, acts, lps) = self._decode_blk(
            self.model, self.caches,
            jnp.asarray(self._cur), jnp.asarray(self._pos),
            jnp.asarray(self._remaining), jnp.asarray(eos),
            sub, jnp.asarray(active_mask),
        )
        toks = np.asarray(toks)          # [D, B]
        acts = np.asarray(acts)          # [D, B] bool: was active at step d
        lps = np.asarray(lps)            # [D, B] f32
        # np.array (copy): np.asarray of a device array is READ-ONLY and
        # _admit mutates these in place
        self._cur = np.array(cur, np.int32)
        self._pos = np.array(pos, np.int32)
        self._remaining = np.array(remaining, np.int32)
        final_active = np.asarray(active)
        for slot in list(self.active):
            req = self.active[slot]
            gen = self.generated[req.uid]
            lpl = self.logprobs[req.uid]
            for step_d in range(d):
                if acts[step_d, slot]:
                    gen.append(int(toks[step_d, slot]))
                    lpl.append(float(lps[step_d, slot]))
                    if self.on_token is not None:
                        self.on_token(req.uid, int(toks[step_d, slot]),
                                      float(lps[step_d, slot]))
            if not final_active[slot]:
                self._retire(slot)
        return len(self.active)

    def _step_spec(self) -> int:
        """One speculative round for every active slot: draft gamma tokens
        (one scan dispatch on the draft), verify them in ONE target forward,
        append each slot's accepted prefix + correction/bonus token.

        Per-row positions/lengths keep slots with different acceptance
        counts independent; rejected K/V is disowned by rolling both models'
        cache lengths back to each row's `pos` at the top of the round (the
        same masked-junk invariant as serving.speculative). Inactive slots
        run parked at position 0 and their results are ignored.
        """
        active_mask = np.zeros((self.num_slots,), bool)
        for slot in self.active:
            active_mask[slot] = True
        pos_arr = np.where(active_mask, self._pos, 0).astype(np.int32)
        last = np.where(active_mask, self._cur, 0).astype(np.int32)
        lengths_now = jnp.asarray(pos_arr)
        self.draft_caches = tuple(
            dataclasses.replace(c, lengths=lengths_now)
            for c in self.draft_caches
        )
        self.caches = tuple(
            dataclasses.replace(c, lengths=lengths_now) for c in self.caches
        )
        self.draft_caches, d_toks = self._spec._draft_round(
            self.draft_model, self.draft_caches,
            jnp.asarray(last), jnp.asarray(pos_arr),
        )
        self.caches, n, emitted, lp_d, lp_e = self._spec._verify(
            self.model, self.caches, jnp.asarray(last), d_toks,
            jnp.asarray(pos_arr),
        )
        d_np = np.asarray(d_toks)
        n_np = np.asarray(n)
        e_np = np.asarray(emitted)
        lpd_np = np.asarray(lp_d)
        lpe_np = np.asarray(lp_e)
        g = self._spec.gamma
        self.spec_stats.rounds += 1
        for slot in list(self.active):
            req = self.active[slot]
            self.spec_stats.drafted += g
            self.spec_stats.accepted += int(n_np[slot])
            new = [int(x) for x in d_np[slot, : n_np[slot]]] + [int(e_np[slot])]
            lps = [float(x) for x in lpd_np[slot, : n_np[slot]]] + [
                float(lpe_np[slot])
            ]
            kept = 0
            done = False
            for tok, lp in zip(new, lps):
                self.generated[req.uid].append(tok)
                self.logprobs[req.uid].append(lp)
                if self.on_token is not None:
                    self.on_token(req.uid, tok, lp)
                kept += 1
                self._remaining[slot] -= 1
                if tok == req.eos_token or self._remaining[slot] <= 0:
                    done = True
                    break
            self._cur[slot] = self.generated[req.uid][-1]
            self._pos[slot] = pos_arr[slot] + kept
            if done:
                self._retire(slot)
        return len(self.active)

    def cancel(self, uid: int) -> bool:
        """Cancel a request by uid: removed from the queue, or retired
        mid-generation (its tokens so far land in `finished`). Returns
        whether anything was cancelled. Safe to call from an `on_token`
        callback: active-slot cancels arriving mid-step are deferred to the
        end of the step (retiring a slot while the step loop iterates it
        would corrupt the iteration)."""
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[i]
                self.finished[uid] = []
                self.finished_logprobs[uid] = []
                return True
        for slot, r in list(self.active.items()):
            if r.uid == uid:
                if self._stepping:
                    if uid not in self._deferred_cancels:
                        self._deferred_cancels.append(uid)
                else:
                    self._retire(slot)
                return True
        return False

    def _flush_deferred_cancels(self) -> None:
        for uid in self._deferred_cancels:
            for slot, r in list(self.active.items()):
                if r.uid == uid:
                    self._retire(slot)
        self._deferred_cancels.clear()

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drain the queue; returns {uid: generated tokens}."""
        for _ in range(max_steps):
            if not self.active and not self.queue:
                break
            self.step()
        return dict(self.finished)
