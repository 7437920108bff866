#!/usr/bin/env python
"""Train the tiny byte-level MoE decoder committed as a test fixture.

The round-1 verdict asked for quality evidence on GENUINELY TRAINED weights
(every tolerance-ladder number so far used random weights, same as the
reference's tests). This trains the dense twin of the tiny flagship
architecture as a byte-level language model on the repository's own
documentation (real English text, no network required), then exports the
dense weights as a .safetensors fixture through the native writer — the
exact artifact a user's converter run starts from.

Run from the repo root:  python scripts/train_tiny.py
Produces: tests/fixtures/tiny_trained.safetensors (+ .json metadata)
Eval: benchmark/run_quality_eval.py compares INT4 vs bf16 on held-out text.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# CPU by default (reproducible fixture, no accelerator needed). The h>=256
# quality fixtures train faster on an accelerator (TRAIN_TINY_BACKEND=gpu):
# the CPU takes about a minute per step at h=256.
if os.environ.get("TRAIN_TINY_BACKEND", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from fused4bit.models.config import ModelConfig, MoEConfig  # noqa: E402
from fused4bit.models.dense_baseline import dense_from_quantized  # noqa: E402
from fused4bit.models.safetensors_io import save_safetensors  # noqa: E402
from fused4bit.models.transformer import QuantizedTransformer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.environ.get(
    "TRAIN_TINY_OUT", os.path.join(REPO, "tests", "fixtures")
)

# byte-level LM; the default geometry keeps the committed fixture ~4 MB.
# TRAIN_TINY_HIDDEN=384 trains a larger variant (for the quality-vs-hidden-
# size evidence; not committed - reproducible from this script, seed 0).
_H = int(os.environ.get("TRAIN_TINY_HIDDEN", "128"))
TINY_TRAINED = ModelConfig(
    name="tiny-trained",
    moe=MoEConfig("tiny-trained-moe", num_experts=4, hidden_dim=_H,
                  ffn_dim=2 * _H, top_k=2),
    num_layers=2,
    num_heads=_H // 64,
    num_kv_heads=max(1, _H // 128),
    head_dim=64,
    vocab_size=256,
    max_seq_len=256,
)

SEQ, STEPS, LR = 128, int(os.environ.get("TRAIN_TINY_STEPS", "1000")), 3e-3
# The jitted train step's peak device memory is ~linear in hidden*batch
# (about 15 GB at h256/batch16); larger variants on smaller devices drop the
# batch instead.
BATCH = int(os.environ.get("TRAIN_TINY_BATCH", "16"))
FIXTURE_NAME = os.environ.get("TRAIN_TINY_NAME", "tiny_trained")


def load_corpus() -> np.ndarray:
    """Real English text: the repo's documentation, byte tokens.

    The committed fixtures' corpora are snapshotted next to them
    (`tests/fixtures/*.corpus`), so the documents read here only matter
    for a new fixture. The h>=256 fixtures trained on more text: an h256
    run on the small corpus overfit hard (train 0.31 vs held-out 2.04
    nll/byte at 1500 steps), so bigger models get more text and fewer
    steps (TRAIN_TINY_STEPS)."""
    paths = ["README.md", "AGENTS.md", "SURVEY.md", "benchmark/README.md",
             "PARITY.md", "docs/operations-guide.md", "docs/api-reference.md"]
    text = "\n\n".join(
        open(os.path.join(REPO, p), errors="ignore").read()
        for p in paths if os.path.exists(os.path.join(REPO, p))
    )
    return np.frombuffer(text.encode(), np.uint8)


def export_params(dense) -> dict:
    """DenseTransformer pytree -> the converter's flat HF-style dict."""
    out = {"embed.weight": dense.embed, "final_norm.weight": dense.final_norm,
           "lm_head.weight": dense.lm_head}
    for i, blk in enumerate(dense.blocks):
        p = f"layers.{i}"
        out[f"{p}.attn_norm.weight"] = blk.attn_norm
        out[f"{p}.moe_norm.weight"] = blk.moe_norm
        out[f"{p}.attn.q_proj.weight"] = blk.wq
        out[f"{p}.attn.k_proj.weight"] = blk.wk
        out[f"{p}.attn.v_proj.weight"] = blk.wv
        out[f"{p}.attn.o_proj.weight"] = blk.wo
        out[f"{p}.moe.router.weight"] = blk.router
        for e in range(blk.router.shape[0]):
            out[f"{p}.moe.experts.{e}.w1.weight"] = blk.w_gate[e]
            out[f"{p}.moe.experts.{e}.w3.weight"] = blk.w_up[e]
            out[f"{p}.moe.experts.{e}.w2.weight"] = blk.w_down[e]
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def main():
    cfg = TINY_TRAINED
    corpus = load_corpus()
    split = int(len(corpus) * 0.9)
    train, held = corpus[:split], corpus[split:]
    print(f"corpus: {len(corpus)} bytes ({split} train / {len(held)} held out)")

    seed_model = QuantizedTransformer.init(jax.random.PRNGKey(0), cfg)
    # dense_all: streamed-einsum MoE — the gather impl materializes
    # [T*k, ffn, H] weight copies per step and trains ~30x slower on CPU
    dense = dense_from_quantized(seed_model, dtype=jnp.float32,
                                 moe_impl="dense_all")

    def loss_fn(model, tokens):
        b, t = tokens.shape
        caches = model.init_cache(cfg, b, t, dtype=jnp.float32)
        logits, _ = model(tokens[:, :-1], caches, jnp.arange(t - 1))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        tgt = tokens[:, 1:]
        nll = -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
        return jnp.mean(nll)

    opt = optax.adamw(optax.cosine_decay_schedule(LR, STEPS), weight_decay=1e-4)
    opt_state = opt.init(dense)

    @jax.jit
    def step(model, opt_state, tokens):
        loss, grads = jax.value_and_grad(loss_fn)(model, tokens)
        updates, opt_state = opt.update(grads, opt_state, model)
        return optax.apply_updates(model, updates), opt_state, loss

    rng = np.random.default_rng(0)
    for it in range(STEPS):
        starts = rng.integers(0, len(train) - SEQ - 1, BATCH)
        batch = np.stack([train[s : s + SEQ] for s in starts]).astype(np.int32)
        dense, opt_state, loss = step(dense, opt_state, jnp.asarray(batch))
        if it % 100 == 0 or it == STEPS - 1:
            print(f"step {it:5d}  train nll/byte {float(loss):.3f}", flush=True)

    # held-out eval of the trained dense model
    hb = held[: (len(held) // SEQ) * SEQ].reshape(-1, SEQ).astype(np.int32)
    val = float(jax.jit(loss_fn)(dense, jnp.asarray(hb[:32])))
    print(f"held-out nll/byte {val:.3f} (uniform-random would be "
          f"{np.log(256):.3f})")

    os.makedirs(FIXTURE_DIR, exist_ok=True)
    out = os.path.join(FIXTURE_DIR, FIXTURE_NAME + ".safetensors")
    # snapshot the corpus: the docs evolve with the repo, and the eval's
    # train/held-out split must match what this model actually saw
    with open(out.replace(".safetensors", ".corpus"), "wb") as f:
        f.write(corpus.tobytes())
    save_safetensors(out, export_params(dense),
                     metadata={"heldout_nll": f"{val:.4f}"})
    with open(out.replace(".safetensors", ".json"), "w") as f:
        json.dump({
            "config": {
                "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
                "num_kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
                "vocab_size": cfg.vocab_size,
                "num_experts": cfg.moe.num_experts, "ffn_dim": cfg.moe.ffn_dim,
                "top_k": cfg.moe.top_k,
            },
            "train_steps": STEPS, "heldout_nll_per_byte": val,
            "corpus_bytes": int(len(corpus)),
        }, f, indent=2)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
