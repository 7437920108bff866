"""Speculative decoding: draft-gamma, verify-in-one-dispatch.

Decode latency at small batch is bound by streaming the target model's
weights once per token. Speculative decoding (Leviathan et al., 2023 —
greedy acceptance variant) breaks the one-token-per-stream bound: a cheap
draft model proposes ``gamma`` tokens autoregressively, then the TARGET
model scores all of them in ONE forward over gamma+1 positions (the same
parallel-attention path chunked prefill uses) and keeps the longest prefix
it agrees with, plus one correction/bonus token. Output is IDENTICAL to
target-only greedy decoding — acceptance only decides how many tokens each
weight stream yields (1..gamma+1).

Mapping onto JAX:

* The draft's gamma autoregressive steps run as ONE compiled dispatch
  (`lax.scan` over decode steps) — the same in-graph fusion as the serving
  engine's ``decode_block``.
* Verification is one batched (gamma+1)-token forward through the target —
  it takes the prefill attention path and the prefill-regime weight path.
* **Rollback is free.** Both caches are written optimistically for all
  gamma+1 positions; rejected positions are disowned by rolling the
  per-row ``lengths`` back (`QuantizedKVCache.lengths` masking — junk above
  a row's length is never read and is overwritten by the next round's
  writes before its attention reads it, the same invariant the serving
  engine's chunked prefill relies on).
* Per-row acceptance counts differ every round; per-row ``pos``/``lengths``
  keep rows independent — no re-batching, no padding churn.

The reference has no serving loop at all (SURVEY.md: "no serving"); this
is beyond-parity capability built on the INT4 cache design.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SpeculativeDecoder", "speculative_generate"]


@dataclasses.dataclass
class SpecStats:
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)


def _rollback(caches, lengths):
    return tuple(dataclasses.replace(c, lengths=lengths) for c in caches)


class SpeculativeDecoder:
    """Greedy speculative decoding over (target, draft) model pairs.

    Both models must share the vocabulary; the draft is typically a much
    smaller model (fewer layers/width) — every accepted draft token saves
    one full target weight stream.
    """

    def __init__(self, target, draft, cfg_target, cfg_draft, *, gamma: int = 4):
        if cfg_target.vocab_size != cfg_draft.vocab_size:
            raise ValueError("target and draft must share a vocabulary")
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        self.target = target
        self.draft = draft
        self.cfg_t = cfg_target
        self.cfg_d = cfg_draft
        self.gamma = gamma
        self._draft_round = jax.jit(self._draft_round_impl)
        self._verify = jax.jit(self._verify_impl)
        self._prefill = jax.jit(self._prefill_impl)

    # -- compiled programs ----------------------------------------------------

    def _draft_round_impl(self, draft, caches, last, pos):
        """gamma greedy draft steps in one dispatch. last/pos: [B].

        Runs gamma+1 steps: the extra step feeds d_gamma so its K/V lands in
        the draft cache — on FULL acceptance the next round's context
        includes d_gamma's position, which would otherwise hold junk the
        rollback wrongly vouches for (the d_{gamma+1} prediction itself is
        discarded). Rejected-case extra writes sit above the rolled-back
        length, the usual masked-junk invariant.
        """

        def body(carry, _):
            caches, tok, p = carry
            logits, caches = draft(tok[:, None], caches, p[:, None])
            nxt = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)
            return (caches, nxt, p + 1), nxt

        (caches, _, _), toks = jax.lax.scan(
            body, (caches, last, pos), None, length=self.gamma + 1
        )
        return caches, toks.T[:, : self.gamma]  # [B, gamma]

    def _verify_impl(self, target, caches, last, d_toks, pos):
        """One (gamma+1)-token target forward; greedy acceptance.

        Feeds [last, d_1..d_gamma] at positions [pos, pos+gamma]; logits at
        offset i predict the token for position pos+i+1. Returns
        (caches, n_accepted [B], emitted [B]) where emitted is the
        correction token (first disagreement) or the bonus token (all
        gamma accepted).
        """
        b, g = d_toks.shape
        tokens = jnp.concatenate([last[:, None], d_toks], axis=1)
        positions = pos[:, None] + jnp.arange(g + 1, dtype=jnp.int32)[None]
        logits, caches = target(tokens, caches, positions)
        preds = jnp.argmax(logits, -1).astype(jnp.int32)       # [B, g+1]
        match = preds[:, :g] == d_toks
        all_ok = jnp.all(match, axis=1)
        n = jnp.where(all_ok, g, jnp.argmin(match, axis=1))     # [B]
        emitted = jnp.take_along_axis(preds, n[:, None], axis=1)[:, 0]
        # per-candidate target logprobs: drafts d_{i+1} score at offset i;
        # the emitted correction/bonus scores at offset n
        lsm = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        lp_drafts = jnp.take_along_axis(
            lsm[:, :g], d_toks[:, :, None], axis=2
        )[..., 0]                                               # [B, g]
        lsm_at_n = jnp.take_along_axis(lsm, n[:, None, None], axis=1)[:, 0]
        lp_emitted = jnp.take_along_axis(
            lsm_at_n, emitted[:, None], axis=1
        )[:, 0]                                                 # [B]
        return caches, n, emitted, lp_drafts, lp_emitted

    def _prefill_impl(self, target, draft, caches_t, caches_d, tokens, lengths):
        """Right-padded batch prefill of both models; returns the first
        greedy token per row (from the row's LAST REAL position)."""
        b, t = tokens.shape
        positions = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[None], (b, t))
        logits, caches_t = target(tokens, caches_t, positions)
        _, caches_d = draft(tokens, caches_d, positions)
        last_logits = jnp.take_along_axis(
            logits, (lengths - 1)[:, None, None], axis=1
        )[:, 0]
        first = jnp.argmax(last_logits, -1).astype(jnp.int32)
        # disown the right-padding junk in both caches
        caches_t = _rollback(caches_t, lengths)
        caches_d = _rollback(caches_d, lengths)
        return caches_t, caches_d, first

    # -- host loop --------------------------------------------------------------

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        *,
        max_new_tokens: int = 32,
        eos_id: Optional[int] = None,
        max_seq: Optional[int] = None,
    ) -> List[List[int]]:
        """Greedy speculative generation; one token list per prompt.

        Semantics: identical to target-only greedy decoding (acceptance
        affects speed, never content — up to the platform's ~1 ULP
        cross-compilation wobble on near-tied logits). Stats land in
        ``self.stats`` (acceptance_rate is the tokens-per-weight-stream
        lever).
        """
        b = len(prompts)
        if b == 0:
            return []
        lens = np.array([len(p) for p in prompts], np.int32)
        if lens.min() < 1:
            raise ValueError("prompts must be non-empty")
        t_max = int(lens.max())
        g = self.gamma
        needed = t_max + max_new_tokens + g + 2
        if max_seq is None:
            max_seq = needed
        elif max_seq < needed:
            # A short cache would make append's dynamic_update_slice clamp
            # silently, shearing packed codes from their scales (the same
            # hole the serving engine refuses loudly) — refuse loudly too.
            raise ValueError(
                f"max_seq={max_seq} < prompt+max_new+gamma+2={needed}; "
                "speculative rounds write up to gamma+1 positions past the "
                "accepted length"
            )
        max_seq = ((max_seq + 1) // 2) * 2  # pair-packed caches need even

        caches_t = self.target.init_cache(self.cfg_t, b, max_seq)
        caches_d = self.draft.init_cache(self.cfg_d, b, max_seq)
        tokens = np.zeros((b, t_max), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, : lens[i]] = p

        caches_t, caches_d, first = self._prefill(
            self.target, self.draft, caches_t, caches_d,
            jnp.asarray(tokens), jnp.asarray(lens),
        )
        first = np.asarray(first)

        out: List[List[int]] = [[int(first[i])] for i in range(b)]
        done = np.array([
            out[i][0] == eos_id or max_new_tokens <= 1 for i in range(b)
        ])
        last = np.array(first, np.int32)
        pos = lens.copy()  # position of `last` (its K/V not yet written)
        self.stats = SpecStats()

        while not done.all():
            lengths_now = jnp.asarray(pos)  # valid K/V below `last`'s pos
            caches_d = _rollback(caches_d, lengths_now)
            caches_t = _rollback(caches_t, lengths_now)
            caches_d, d_toks = self._draft_round(
                self.draft, caches_d, jnp.asarray(last), jnp.asarray(pos)
            )
            caches_t, n, emitted, _, _ = self._verify(
                self.target, caches_t, jnp.asarray(last), d_toks,
                jnp.asarray(pos),
            )
            d_np = np.asarray(d_toks)
            n_np = np.asarray(n)
            e_np = np.asarray(emitted)
            self.stats.rounds += 1
            for i in range(b):
                if done[i]:
                    continue
                self.stats.drafted += g
                self.stats.accepted += int(n_np[i])
                new = [int(x) for x in d_np[i, : n_np[i]]] + [int(e_np[i])]
                for tok in new:
                    out[i].append(tok)
                    if tok == eos_id or len(out[i]) >= max_new_tokens:
                        done[i] = True
                        break
                # advance by the tokens actually KEPT (EOS truncation may
                # keep fewer than n+1); K/V through the kept prefix is valid
                last[i] = out[i][-1]
                pos[i] = lens[i] + len(out[i]) - 1
        return out


def speculative_generate(
    target, draft, cfg_target, cfg_draft, prompts,
    *, gamma: int = 4, max_new_tokens: int = 32, eos_id=None,
):
    """One-call greedy speculative decoding (see SpeculativeDecoder)."""
    dec = SpeculativeDecoder(target, draft, cfg_target, cfg_draft, gamma=gamma)
    out = dec.generate(
        prompts, max_new_tokens=max_new_tokens, eos_id=eos_id
    )
    return out, dec.stats
