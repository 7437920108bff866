"""Sequence (context) parallelism: ring attention over a mesh axis.

The long-context scale-out axis the reference has no analogue for (SURVEY.md
§2.5 absence inventory — single GPU, no distributed support): shard the
SEQUENCE dimension of Q/K/V over a mesh axis so a context too long for one
device's memory — or one device's attention FLOPs — spreads over the ring.

Design (blockwise/ring attention, the standard flash-attention-over-devices
construction): every device holds one contiguous [T/P] chunk of Q, K, V.
Each device keeps its Q chunk resident and walks the K/V ring: P steps, each
step combining the current K/V chunk into the flash online-softmax state
(m, l, acc) and rotating the chunk to the next device with ``ppermute``.
After P steps every Q row has seen every K/V position exactly once, at peak
memory O(T/P) per device, with each rotation's interconnect transfer overlappable
with the chunk's attention compute (same pattern as the ring-pipelined EP
strategy, ``expert_parallel.moe_ep_ring``).

Causality never moves data it can skip *numerically*: chunks fully in a Q
chunk's future contribute all-masked scores and drop out of the online
softmax via the masked-probability form (p = where(mask, exp(s - m), 0)) —
control flow stays static for XLA, and the masked chunks' dots are the
price of the uniform schedule (half the total work at P chunks, same as any
causal flash implementation without triangle scheduling).

GQA is supported the same way as the fused attention kernel
(`ops/decode_attention.py`): K/V arrive with ``Hkv`` heads and are repeated
to the query head count inside the shard_map body (a [B, Hkv, C, D] chunk is
small; the repeat never touches device-resident global arrays).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

__all__ = [
    "ring_attention", "ring_attention_quantized", "ulysses_attention",
    "sequence_sharded_attention",
]

_NEG = -1e30


def _pvary(x, axis):
    """Mark a replicated value device-varying for shard_map's axis types.

    ``jax.lax.pvary`` is deprecated in favor of ``pcast(..., to='varying')``;
    support both so the package tracks JAX without a version pin."""
    pcast = getattr(jax.lax, "pcast", None)
    if pcast is not None:
        return pcast(x, axis, to="varying")
    return jax.lax.pvary(x, axis)


def _flash_step(m, l, acc, qf, kr, vr, q_pos, k_pos, causal, lengths):
    """One online-softmax chunk update. qf pre-scaled f32; kr/vr f32 with
    query-head-count heads. Masked-probability form (see _ring_body)."""
    s = jnp.einsum("bhid,bhjd->bhij", qf, kr)                 # [B, Hq, C, C]
    mask = None
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]               # [C, C]
        mask = mask[None, None]
    if lengths is not None:
        lmask = (k_pos[None, :] < lengths[:, None])[:, None, None, :]
        mask = lmask if mask is None else (mask & lmask)
    if mask is not None:
        s = jnp.where(mask, s, _NEG)
    m_new = jnp.maximum(m, jnp.max(s, axis=-1, keepdims=True))
    prob = jnp.exp(s - m_new)
    if mask is not None:
        prob = jnp.where(mask, prob, 0.0)
    alpha = jnp.exp(m - m_new)
    l = alpha * l + jnp.sum(prob, axis=-1, keepdims=True)
    acc = alpha * acc + jnp.einsum("bhij,bhjd->bhid", prob, vr)
    return m_new, l, acc


def _ring_body(q, k, v, *, axis: str, causal: bool, scale: float):
    """shard_map body: local chunks [B, H(q/kv), C, D] -> [B, Hq, C, D]."""
    p_sz = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    b, hq, c, d = q.shape
    hkv = k.shape[1]
    rep = hq // hkv

    qf = q.astype(jnp.float32) * scale
    q_pos = idx * c + jnp.arange(c, dtype=jnp.int32)          # global rows

    # pvary: the state starts identical on every device but the scan body
    # makes it device-varying; shard_map's varying-axis type system needs
    # the carry marked varying up front.
    m0 = _pvary(jnp.full((b, hq, c, 1), _NEG, jnp.float32), axis)
    l0 = _pvary(jnp.zeros((b, hq, c, 1), jnp.float32), axis)
    a0 = _pvary(jnp.zeros((b, hq, c, d), jnp.float32), axis)
    perm = [(j, (j + 1) % p_sz) for j in range(p_sz)]

    def use(m, l, acc, k_cur, v_cur, p_i):
        src = (idx - p_i) % p_sz                              # chunk id held now
        k_pos = src * c + jnp.arange(c, dtype=jnp.int32)
        kr = jnp.repeat(k_cur, rep, axis=1).astype(jnp.float32)
        vr = jnp.repeat(v_cur, rep, axis=1).astype(jnp.float32)
        # masked-probability form inside _flash_step: rows whose every column
        # is masked keep m_new == -1e30; exp(s - m_new) would be exp(0) == 1
        # there, so the mask multiplies those probabilities back to zero.
        return _flash_step(m, l, acc, qf, kr, vr, q_pos, k_pos, causal, None)

    def step(carry, p_i):
        m, l, acc, k_cur, v_cur = carry
        m, l, acc = use(m, l, acc, k_cur, v_cur, p_i)
        # rotate AFTER use; XLA is free to overlap the transfer with the
        # next iteration's einsums (the chunk only blocks at its first use)
        k_nxt = jax.lax.ppermute(k_cur, axis, perm)
        v_nxt = jax.lax.ppermute(v_cur, axis, perm)
        return (m, l, acc, k_nxt, v_nxt), None

    # P-1 (use, rotate) steps in the scan, final chunk used OUTSIDE it — a
    # P-step scan would issue one extra rotation whose output is discarded
    # (real interconnect traffic: the permute feeds the carry, XLA cannot drop it).
    (m, l, acc, k_last, v_last), _ = jax.lax.scan(
        step, (m0, l0, a0, k, v), jnp.arange(p_sz - 1, dtype=jnp.int32)
    )
    m, l, acc = use(m, l, acc, k_last, v_last, p_sz - 1)
    out = acc / jnp.maximum(l, 1e-30)
    return out.astype(q.dtype)


def ring_attention(
    q: jnp.ndarray,   # [B, Hq, T, D]
    k: jnp.ndarray,   # [B, Hkv, T, D]
    v: jnp.ndarray,   # [B, Hkv, T, D]
    mesh: Mesh,
    *,
    axis: str = "seq",
    causal: bool = True,
) -> jnp.ndarray:
    """Causal attention with the sequence dim sharded over ``mesh[axis]``.

    Returns [B, Hq, T, D], sequence-sharded the same way. T must divide by
    the axis size. Peak per-device memory is O(B*H*(T/P)*D); total interconnect
    traffic per device is (P-1)/P of its K+V bytes, overlappable with
    compute.
    """
    t = q.shape[2]
    p_sz = mesh.shape[axis]
    if t % p_sz != 0:
        raise ValueError(f"T={t} must divide by {axis} size {p_sz}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"Hq={q.shape[1]} not a multiple of Hkv={k.shape[1]}")
    scale = q.shape[-1] ** -0.5
    body = functools.partial(_ring_body, axis=axis, causal=causal, scale=scale)
    spec = P(None, None, axis, None)
    fn = shard_map(
        body, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec
    )
    return fn(q, k, v)


def _ring_body_q(q, kp, ks, kz, vp, vs, vz, lengths, *, axis, causal, scale):
    """Quantized ring body: K/V chunks stay PACKED while rotating.

    kp/vp: [B, Hkv, C/2, D] u8 pair-packed (layers.kv_cache layout);
    ks/kz/vs/vz: [B, Hkv, C] f32 per-position affine params. Each hop moves
    ~C*D bytes of codes + 16*C of scales per head instead of 4*C*D of bf16
    — ~3.5x less interconnect traffic at D=128 — and dequantizes the chunk locally
    right before use (a chunk-sized elementwise op, off the critical DMA
    path).
    """
    from ..layers.kv_cache import _unpack_pairs

    p_sz = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    b, hq, c, d = q.shape
    hkv = kp.shape[1]
    rep = hq // hkv

    qf = q.astype(jnp.float32) * scale
    q_pos = idx * c + jnp.arange(c, dtype=jnp.int32)

    m0 = _pvary(jnp.full((b, hq, c, 1), _NEG, jnp.float32), axis)
    l0 = _pvary(jnp.zeros((b, hq, c, 1), jnp.float32), axis)
    a0 = _pvary(jnp.zeros((b, hq, c, d), jnp.float32), axis)
    perm = [(j, (j + 1) % p_sz) for j in range(p_sz)]

    def dq(p, s, z):
        codes = _unpack_pairs(p).astype(jnp.float32)          # [B,Hkv,C,D]
        return (codes - z[..., None]) * s[..., None]

    def use(m, l, acc, kv, p_i):
        kp_c, vp_c, sz4 = kv
        src = (idx - p_i) % p_sz
        k_pos = src * c + jnp.arange(c, dtype=jnp.int32)
        kr = jnp.repeat(dq(kp_c, sz4[0], sz4[1]), rep, axis=1)
        vr = jnp.repeat(dq(vp_c, sz4[2], sz4[3]), rep, axis=1)
        return _flash_step(
            m, l, acc, qf, kr, vr, q_pos, k_pos, causal, lengths
        )

    def step(carry, p_i):
        m, l, acc, kv = carry
        m, l, acc = use(m, l, acc, kv, p_i)
        kv_nxt = jax.tree.map(lambda a: jax.lax.ppermute(a, axis, perm), kv)
        return (m, l, acc, kv_nxt), None

    # The 4 per-position affine rows ride as ONE stacked [4, B, Hkv, C]
    # array: 3 ppermute launches per hop (k codes, v codes, scales) instead
    # of 6 — per-collective launch cost dominates for the small scale rows.
    # P-1 rotations; the final chunk is used outside the scan (see
    # _ring_body).
    sz4 = jnp.stack([ks, kz, vs, vz])
    (m, l, acc, kv_last), _ = jax.lax.scan(
        step, (m0, l0, a0, (kp, vp, sz4)),
        jnp.arange(p_sz - 1, dtype=jnp.int32),
    )
    m, l, acc = use(m, l, acc, kv_last, p_sz - 1)
    out = acc / jnp.maximum(l, 1e-30)
    return out.astype(q.dtype)


def ring_attention_quantized(
    q: jnp.ndarray,   # [B, Hq, T, D]
    cache,            # QuantizedKVCache with max_seq == T (prefill chunk set)
    mesh: Mesh,
    *,
    axis: str = "seq",
    causal: bool = True,
) -> jnp.ndarray:
    """Ring attention whose K/V ring carries the PACKED INT4 cache.

    Sequence parallelism composed with the INT4 KV cache: the rotating
    chunks are the cache's pair-packed u8 codes + per-position scales, so
    each interconnect hop moves ~3.5x fewer bytes than rotating bf16 K/V (the same
    argument the fused attention kernel makes for device memory, applied to the
    ring). Per-slot ``cache.lengths`` mask exactly like the fused kernel.
    T (= cache.max_seq) must divide by the axis size into EVEN chunks
    (pair packing).
    """
    t = q.shape[2]
    p_sz = mesh.shape[axis]
    if t != cache.max_seq:
        raise ValueError(f"T={t} must equal cache.max_seq={cache.max_seq}")
    if t % p_sz != 0 or (t // p_sz) % 2 != 0:
        raise ValueError(
            f"T={t} must split into even chunks over {axis} size {p_sz}"
        )
    if q.shape[1] % cache.k_packed.shape[1] != 0:
        raise ValueError("Hq must be a multiple of Hkv")
    scale = q.shape[-1] ** -0.5
    body = functools.partial(
        _ring_body_q, axis=axis, causal=causal, scale=scale
    )
    sp = P(None, None, axis, None)   # q and packed chunks (dim 2 = seq)
    sr = P(None, None, axis)         # scale rows
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(sp, sp, sr, sr, sp, sr, sr, P(None)),
        out_specs=sp,
    )
    return fn(
        q, cache.k_packed, cache.k_scale, cache.k_zp,
        cache.v_packed, cache.v_scale, cache.v_zp, cache.lengths,
    )


def _ulysses_body(q, k, v, *, axis: str, causal: bool, scale: float):
    """shard_map body: seq-sharded chunks -> head-sharded full attention.

    all_to_all trades the sequence sharding for a head sharding (each
    device receives the FULL sequence for Hq/P of the heads), runs plain
    causal attention locally, and trades back. Two collectives total vs the
    ring's P-1 rotations — the better trade when heads are plentiful and
    the context fits one device's memory for its head slice.
    """
    p_sz = jax.lax.axis_size(axis)
    # [B, H, C, D] -> [B, H/P, T, D]: split heads, gather sequence
    def fwd(a):
        return jax.lax.all_to_all(
            a, axis, split_axis=1, concat_axis=2, tiled=True
        )

    qh, kh, vh = fwd(q), fwd(k), fwd(v)
    rep = qh.shape[1] // kh.shape[1]
    kr = jnp.repeat(kh, rep, axis=1).astype(jnp.float32)
    vr = jnp.repeat(vh, rep, axis=1).astype(jnp.float32)
    t = qh.shape[2]
    s = jnp.einsum("bhid,bhjd->bhij", qh.astype(jnp.float32) * scale, kr)
    if causal:
        cm = jnp.arange(t)[None, :] <= jnp.arange(t)[:, None]
        s = jnp.where(cm[None, None], s, _NEG)
    out = jnp.einsum(
        "bhij,bhjd->bhid", jax.nn.softmax(s, axis=-1), vr
    ).astype(q.dtype)
    # [B, Hq/P, T, D] -> [B, Hq, C, D]: split sequence back, gather heads
    return jax.lax.all_to_all(
        out, axis, split_axis=2, concat_axis=1, tiled=True
    )


def ulysses_attention(
    q: jnp.ndarray,   # [B, Hq, T, D]
    k: jnp.ndarray,   # [B, Hkv, T, D]
    v: jnp.ndarray,   # [B, Hkv, T, D]
    mesh: Mesh,
    *,
    axis: str = "seq",
    causal: bool = True,
) -> jnp.ndarray:
    """Ulysses-style sequence parallelism: head-sharded full attention.

    The second standard SP strategy (SURVEY §2.5 names both): inputs and
    outputs are sequence-sharded exactly like :func:`ring_attention`, but
    internally one ``all_to_all`` re-shards over HEADS so each device runs
    plain full-context attention for Hq/P query heads, and a second
    ``all_to_all`` restores the sequence sharding. Requires Hq % P == 0 and
    Hkv % P == 0 (GQA grouping stays aligned because contiguous head
    blocks map to contiguous kv-head blocks). Prefer the ring when P
    exceeds the kv-head count or the full context doesn't fit per device.
    """
    t = q.shape[2]
    p_sz = mesh.shape[axis]
    if t % p_sz != 0:
        raise ValueError(f"T={t} must divide by {axis} size {p_sz}")
    if q.shape[1] % p_sz or k.shape[1] % p_sz:
        raise ValueError(
            f"Hq={q.shape[1]} and Hkv={k.shape[1]} must divide by "
            f"{axis} size {p_sz} (use ring_attention otherwise)"
        )
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"Hq={q.shape[1]} not a multiple of Hkv={k.shape[1]}")
    scale = q.shape[-1] ** -0.5
    body = functools.partial(
        _ulysses_body, axis=axis, causal=causal, scale=scale
    )
    spec = P(None, None, axis, None)
    fn = shard_map(
        body, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec
    )
    return fn(q, k, v)


def sequence_sharded_attention(
    q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray, mesh: Mesh, **kw
) -> jnp.ndarray:
    """Alias for :func:`ring_attention` (the sequence-parallel entry point)."""
    return ring_attention(q, k, v, mesh, **kw)
