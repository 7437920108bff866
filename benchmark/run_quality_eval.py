#!/usr/bin/env python
"""INT4-vs-bf16 quality on genuinely TRAINED weights (round-1 verdict #7).

Loads the trained tiny-model fixture (scripts/train_tiny.py — a byte-level
LM trained on the repo's documentation), converts it through the real
user pipeline (native safetensors reader -> native packer ->
QuantizedTransformer), and measures on held-out real text:

  * held-out NLL/byte for the bf16 dense model and the INT4 model,
  * greedy top-1 token agreement between the two,
  * mean cosine similarity of the logit vectors.

This upgrades the reference's random-weight quality ladder
(`tests/test_correctness.py:140-168`, cos > 0.95) to trained
weights through the full convert path. Writes
benchmark/results/quality_trained.json.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("QUALITY_EVAL_CPU", "1") == "1":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.environ.get(
    "QUALITY_EVAL_FIXTURE",
    os.path.join(REPO, "tests", "fixtures", "tiny_trained.safetensors"),
)


def load_fixture_model():
    from fused4bit.models.config import ModelConfig, MoEConfig
    from fused4bit.models.convert import convert_safetensors

    with open(FIXTURE.replace(".safetensors", ".json")) as f:
        meta = json.load(f)
    c = meta["config"]
    cfg = ModelConfig(
        name="tiny-trained",
        moe=MoEConfig("tiny-trained-moe", c["num_experts"],
                      c["num_heads"] * c["head_dim"], c["ffn_dim"], c["top_k"]),
        num_layers=c["num_layers"], num_heads=c["num_heads"],
        num_kv_heads=c["num_kv_heads"], head_dim=c["head_dim"],
        vocab_size=c["vocab_size"], max_seq_len=256,
    )
    return cfg, meta


def heldout_text(seq, rows):
    snap = FIXTURE.replace(".safetensors", ".corpus")
    if os.path.exists(snap):
        corpus = np.fromfile(snap, np.uint8)
    else:
        # docs evolve with the repo; without a snapshot the held-out tail is
        # real text but not byte-identical to the training-time split
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        from train_tiny import load_corpus
        corpus = load_corpus()
    held = corpus[int(len(corpus) * 0.9):]
    hb = held[: (len(held) // seq) * seq].reshape(-1, seq)
    return hb[:rows].astype(np.int32)


def eval_model(model, cfg, tokens):
    caches = model.init_cache(cfg, tokens.shape[0], tokens.shape[1])
    logits, _ = model(
        jnp.asarray(tokens[:, :-1]), caches, jnp.arange(tokens.shape[1] - 1)
    )
    logits = np.asarray(logits, np.float32)
    logp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    tgt = jnp.asarray(tokens[:, 1:])
    nll = -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
    return logits, float(jnp.mean(nll))


def main():
    if not os.path.exists(FIXTURE):
        print("fixture missing — run scripts/train_tiny.py first")
        return 1
    from fused4bit.models.dense_baseline import dense_from_quantized

    from fused4bit.models.convert import convert_checkpoint

    cfg, meta = load_fixture_model()
    tokens = heldout_text(seq=128, rows=16)

    # bf16 dense reference built from the SAME fixture weights (not from the
    # quantized model): the honest quality comparison
    from fused4bit.models.safetensors_io import load_safetensors
    raw = load_safetensors(FIXTURE)
    dense = _dense_from_params(raw, cfg)
    lg_d, nll_d = eval_model(dense, cfg, tokens)
    flat_d = lg_d.reshape(-1, lg_d.shape[-1])

    res = {
        "heldout_nll_bf16": round(nll_d, 4),
        "train_heldout_nll_at_export": meta["heldout_nll_per_byte"],
        "uniform_random_nll": round(float(np.log(cfg.vocab_size)), 4),
        "tokens_evaluated": int(tokens[:, 1:].size),
        "fixture": os.path.relpath(FIXTURE, REPO),
    }
    # Both mixed-precision policies: the default (router dense, bf16) and
    # everything-quantized (the round-1 behavior) — the delta IS the measured
    # justification for the policy.
    for label, kw in (
        ("int4_router_dense", dict(quantize_router=False)),
        ("int4_all_quantized", dict(quantize_router=True)),
        # finer granularity = the quality lever: per-group scales every 64
        # weights instead of per 128/256-wide rows
        ("int4_per_group64", dict(quantize_router=False,
                                  granularity="per_group", group_size=64)),
        # gs=128: the quality-AND-speed point (the batched-partials kernels
        # need group_size % 128 == 0; gs=64 runs the golden dequant path)
        ("int4_per_group128", dict(quantize_router=False,
                                   granularity="per_group", group_size=128)),
        ("int4_per_tensor", dict(quantize_router=False,
                                 granularity="per_tensor")),
        # activation-aware equalization (quant/equalize.py): calibration on
        # the training-corpus HEAD (disjoint from the held-out tail), scales
        # folded into RMSNorm weights, alpha grid-searched per site
        ("int4_awq", dict(quantize_router=False, awq_tokens="corpus_head")),
        ("int4_awq_per_group64", dict(quantize_router=False,
                                      granularity="per_group", group_size=64,
                                      awq_tokens="corpus_head")),
    ):
        if kw.get("awq_tokens") == "corpus_head":
            kw = dict(kw, awq_tokens=_calibration_tokens())
        model = convert_checkpoint(raw, cfg, **kw)
        lg_q, nll_q = eval_model(model, cfg, tokens)
        flat_q = lg_q.reshape(-1, lg_q.shape[-1])
        top1 = float((flat_q.argmax(-1) == flat_d.argmax(-1)).mean())
        cos = float(np.mean(
            np.sum(flat_q * flat_d, -1)
            / np.maximum(np.linalg.norm(flat_q, axis=-1)
                         * np.linalg.norm(flat_d, axis=-1), 1e-9)
        ))
        res[label] = {
            "heldout_nll": round(nll_q, 4),
            "nll_delta": round(nll_q - nll_d, 4),
            "top1_agreement": round(top1, 4),
            "logit_cosine_sim": round(cos, 4),
        }
    print(json.dumps(res, indent=2))
    out = os.environ.get(
        "QUALITY_EVAL_OUT",
        os.path.join(REPO, "benchmark", "results", "quality_trained.json"),
    )
    with open(out, "w") as f:
        json.dump(res, f, indent=2)
    print(f"wrote {out}")
    return 0


def _calibration_tokens(seq=128, rows=8):
    """Calibration sample from the training-corpus HEAD (the held-out tail
    used for eval starts at 90% — no leakage)."""
    snap = FIXTURE.replace(".safetensors", ".corpus")
    if os.path.exists(snap):
        corpus = np.fromfile(snap, np.uint8)
    else:
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        from train_tiny import load_corpus
        corpus = load_corpus()
    head = corpus[: int(len(corpus) * 0.9)]
    hb = head[: (len(head) // seq) * seq].reshape(-1, seq)
    step = max(1, hb.shape[0] // rows)
    return hb[::step][:rows].astype(np.int32)


def _dense_from_params(raw, cfg):
    """Build the dense bf16 twin straight from the checkpoint dict."""
    import dataclasses
    from fused4bit.models.dense_baseline import DenseBlock, DenseTransformer

    dt = jnp.bfloat16
    blocks = []
    e = cfg.moe.num_experts
    for i in range(cfg.num_layers):
        p = f"layers.{i}"
        g = lambda k: jnp.asarray(raw[f"{p}.{k}"], dt)  # noqa: E731
        blocks.append(DenseBlock(
            attn_norm=g("attn_norm.weight"),
            wq=g("attn.q_proj.weight"), wk=g("attn.k_proj.weight"),
            wv=g("attn.v_proj.weight"), wo=g("attn.o_proj.weight"),
            moe_norm=g("moe_norm.weight"),
            router=g("moe.router.weight"),
            w_gate=jnp.stack([g(f"moe.experts.{j}.w1.weight") for j in range(e)]),
            w_up=jnp.stack([g(f"moe.experts.{j}.w3.weight") for j in range(e)]),
            w_down=jnp.stack([g(f"moe.experts.{j}.w2.weight") for j in range(e)]),
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            top_k=cfg.moe.top_k, rms_eps=cfg.rms_eps,
        ))
    return DenseTransformer(
        embed=jnp.asarray(raw["embed.weight"], dt),
        blocks=tuple(blocks),
        final_norm=jnp.asarray(raw["final_norm.weight"], dt),
        lm_head=jnp.asarray(raw["lm_head.weight"], dt),
        rms_eps=cfg.rms_eps,
    )


if __name__ == "__main__":
    sys.exit(main())
