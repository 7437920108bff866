"""Model geometry configs + registry.

Mirrors the reference's config registry
(`benchmark/moe_grouped_gemm/config.py:34-176`): `MoEConfig`
dataclass, the real model geometries (Mixtral-8x7B, DeepSeek-V3, GLM-5,
Qwen3-235B, Debug-Tiny), a benchmark sweep list, and name lookup. Extended
with full transformer fields (layers/heads/vocab) so the same registry drives
the decode model, not just the MoE-layer benchmark.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

__all__ = [
    "MoEConfig",
    "ModelConfig",
    "BenchmarkConfig",
    "MIXTRAL_8x7B",
    "DEEPSEEK_V3",
    "GLM_5",
    "QWEN3_235B",
    "DEBUG_TINY",
    "ALL_CONFIGS",
    "MIXTRAL_BENCHMARK_CONFIGS",
    "get_config_by_name",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """MoE layer geometry (reference `config.py:34-63`)."""

    name: str
    num_experts: int
    hidden_dim: int
    ffn_dim: int
    top_k: int
    description: str = ""

    @property
    def total_expert_params(self) -> int:
        # Three projections per expert (gate/up/down, SwiGLU).
        return self.num_experts * 3 * self.hidden_dim * self.ffn_dim

    @property
    def active_expert_params(self) -> int:
        return self.top_k * 3 * self.hidden_dim * self.ffn_dim

    def memory_bytes(self, bits_per_weight: float = 4.0) -> int:
        return int(self.total_expert_params * bits_per_weight / 8)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full decoder geometry for the flagship model slice."""

    name: str
    moe: MoEConfig
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    vocab_size: int = 32000
    max_seq_len: int = 4096
    rope_theta: float = 1e6
    rms_eps: float = 1e-5


# Real geometries, matching reference `config.py:70-109`.
MIXTRAL_8x7B = MoEConfig(
    name="mixtral-8x7b",
    num_experts=8,
    hidden_dim=4096,
    ffn_dim=14336,
    top_k=2,
    description="Mixtral 8x7B MoE layer geometry",
)

DEEPSEEK_V3 = MoEConfig(
    name="deepseek-v3",
    num_experts=64,
    hidden_dim=4096,
    ffn_dim=11008,
    top_k=8,
    description="DeepSeek-V3-style fine-grained MoE",
)

GLM_5 = MoEConfig(
    name="glm-5",
    num_experts=128,
    hidden_dim=5120,
    ffn_dim=13696,
    top_k=8,
    description="GLM-5-style wide MoE",
)

QWEN3_235B = MoEConfig(
    name="qwen3-235b",
    num_experts=64,
    hidden_dim=4096,
    ffn_dim=11008,
    top_k=8,
    description="Qwen3-235B-style MoE",
)

DEBUG_TINY = MoEConfig(
    name="debug-tiny",
    num_experts=4,
    hidden_dim=512,
    ffn_dim=1024,
    top_k=2,
    description="Tiny geometry for tests/debugging",
)

ALL_CONFIGS: Dict[str, MoEConfig] = {
    c.name: c
    for c in (MIXTRAL_8x7B, DEEPSEEK_V3, GLM_5, QWEN3_235B, DEBUG_TINY)
}

# Short aliases accepted by the CLI (reference `config.py:162-176`).
_ALIASES = {
    "mixtral": "mixtral-8x7b",
    "deepseek": "deepseek-v3",
    "glm": "glm-5",
    "qwen": "qwen3-235b",
    "qwen3": "qwen3-235b",
    "debug": "debug-tiny",
    "tiny": "debug-tiny",
}


def get_config_by_name(name: str) -> MoEConfig:
    key = name.lower()
    key = _ALIASES.get(key, key)
    if key not in ALL_CONFIGS:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(ALL_CONFIGS)} "
            f"(aliases: {sorted(_ALIASES)})"
        )
    return ALL_CONFIGS[key]


@dataclasses.dataclass(frozen=True)
class BenchmarkConfig:
    """One benchmark point (reference `config.py:117-159`)."""

    moe: MoEConfig
    batch_size: int = 16
    seq_len: int = 512
    warmup_iters: int = 5
    bench_iters: int = 20
    distribution: str = "uniform"

    @property
    def num_tokens(self) -> int:
        return self.batch_size * self.seq_len


MIXTRAL_BENCHMARK_CONFIGS: List[BenchmarkConfig] = [
    BenchmarkConfig(moe=MIXTRAL_8x7B, batch_size=b) for b in (1, 8, 16, 32)
]


def flagship_model_config(scale: str = "tiny") -> ModelConfig:
    """Mixtral-geometry decode model at several scales.

    `tiny` keeps tests fast; `full` is the real Mixtral-8x7B geometry.
    """
    if scale == "full":
        return ModelConfig(name="mixtral-8x7b-int4", moe=MIXTRAL_8x7B)
    if scale == "small":
        return ModelConfig(
            name="mixtral-small-int4",
            moe=MoEConfig("mixtral-small", 8, 1024, 3584, 2),
            num_layers=4,
            num_heads=8,
            num_kv_heads=4,
            head_dim=128,
            vocab_size=8192,
            max_seq_len=1024,
        )
    if scale == "layer2":
        # 2 layers of the EXACT Mixtral-8x7B layer geometry (the reference's
        # flagship: 8 experts, 4096->14336, top-2 — README.md:24-34): a
        # cheap cut of "full" whose INT4 model (~0.6 GB) and bf16 twin
        # (~5.7 GB: 2.8 GB of expert stacks per layer) fit one device side
        # by side. The whole INT4 model (23.5 GB of experts) fits one 80 GB
        # H100; its bf16 twin (~90 GB) does not. vocab kept small so
        # embed/lm_head don't dominate.
        return ModelConfig(
            name="mixtral-layer2-int4",
            moe=MoEConfig("mixtral-layer2", 8, 4096, 14336, 2),
            num_layers=2,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            vocab_size=8192,
            max_seq_len=1024,
        )
    return ModelConfig(
        name="mixtral-tiny-int4",
        moe=DEBUG_TINY,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        vocab_size=512,
        max_seq_len=256,
    )
