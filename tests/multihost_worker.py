"""Worker process for the 2-process multi-host test (see test_multihost.py).

Each process contributes 4 virtual CPU devices; `jax.distributed.initialize`
joins them into one 8-device system. The worker then:

  1. builds a global mesh spanning both processes,
  2. runs the dropless EP MoE (`moe_ep_replicated`) with expert weights
     sharded across the process boundary,
  3. (phase "model") runs one `sharded_decode_step` of the tiny flagship
     model over a ('data','expert') = (2, 4) mesh — the batch axis is split
     across processes, experts across devices,

and checks both against locally computed single-process goldens (inputs are
seed-deterministic, so every process can compute the same golden). Prints
MULTIHOST_OK on success; any assertion kills the exit status.

Usage: python multihost_worker.py <coordinator> <num_procs> <proc_id> <phase>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# 8 global devices regardless of process count (2 procs x 4, 4 procs x 2):
# the mesh shapes below stay fixed while the process boundary moves.
_NUM_PROCS = int(sys.argv[2]) if len(sys.argv) > 2 else 2
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={8 // _NUM_PROCS}"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def globalize(a, mesh, spec):
    """Build a global array from identical per-process host data."""
    host = np.asarray(a)
    return jax.make_array_from_callback(
        host.shape, NamedSharding(mesh, spec), lambda idx: host[idx]
    )


def run_ep(mesh_devices):
    from jax.sharding import Mesh
    from fused4bit.layers.moe import simulate_router_logits, topk_route
    from fused4bit.parallel.expert_parallel import moe_ep_replicated
    from fused4bit.quant import QuantizedTensor, dequantize, quantize

    mesh = Mesh(mesh_devices.reshape(8), ("expert",))
    E, K, N, T, TOPK = 8, 128, 256, 17, 2
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((E, N, K)) * 0.05, jnp.float32)
    qt = quantize(w, layout="planar")
    x = jnp.asarray(rng.standard_normal((T, K)), jnp.float32)
    logits = simulate_router_logits(jax.random.PRNGKey(1), T, E, "skewed")

    qt_g = QuantizedTensor(
        packed=globalize(qt.packed, mesh, P("expert", None, None)),
        scales=globalize(qt.scales, mesh, P("expert", None)),
        zero_points=globalize(qt.zero_points, mesh, P("expert", None)),
        shape=qt.shape, granularity=qt.granularity, layout=qt.layout,
        block_k=qt.block_k, group_size=qt.group_size, bits=qt.bits,
    )
    x_g = globalize(x, mesh, P())
    logits_g = globalize(np.asarray(logits), mesh, P())

    out = moe_ep_replicated(
        x_g, logits_g, qt_g, mesh, top_k=TOPK, tile_m=8, interpret=True
    )
    got = np.asarray(out.addressable_data(0))

    # local golden: dense dequant MoE
    routing = topk_route(logits, TOPK, E)
    wd = dequantize(qt, dtype=jnp.float32)
    we = wd[routing.expert_indices]
    want = np.asarray(jnp.sum(
        jnp.einsum("tk,tenk->ten", x, we) * routing.expert_weights[..., None],
        axis=1,
    ))
    np.testing.assert_allclose(got, want, atol=1e-3)


def run_model(mesh_devices):
    from jax.sharding import Mesh
    from fused4bit.models.config import flagship_model_config
    from fused4bit.models.transformer import QuantizedTransformer
    from fused4bit.parallel.sharded_model import (
        model_pspecs, sharded_decode_step,
    )

    mesh = Mesh(mesh_devices.reshape(2, 4), ("data", "expert"))
    cfg = flagship_model_config("tiny")
    model = QuantizedTransformer.init(jax.random.PRNGKey(0), cfg)
    b, t, s = 2, 1, 8
    caches = model.init_cache(cfg, b, s)
    tokens = jnp.asarray([[3], [5]], jnp.int32)
    positions = jnp.zeros((b, t), jnp.int32)

    # local single-process golden
    want, _ = model(tokens, caches, positions)
    want = np.asarray(want, np.float32)

    specs = model_pspecs(model)
    model_g = jax.tree.map(
        lambda a, sp: globalize(a, mesh, sp), model, specs
    )
    cache_g = jax.tree.map(
        lambda a: globalize(a, mesh, P("data", *([None] * (a.ndim - 1)))),
        caches,
    )
    logits, _ = sharded_decode_step(
        model_g, mesh,
        globalize(tokens, mesh, P("data", None)),
        cache_g,
        globalize(positions, mesh, P("data", None)),
        interpret=True,
    )
    # logits are data-sharded over 2 mesh rows; num//2 processes share a row
    local = np.asarray(logits.addressable_data(0), np.float32)
    row = jax.process_index() // max(jax.process_count() // 2, 1)
    lo = row * (b // 2)
    np.testing.assert_allclose(
        local, want[lo : lo + b // 2], rtol=0.05, atol=0.05
    )


def main():
    coord, num, pid, phase = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    from fused4bit.parallel.multihost import initialize, is_multihost

    assert initialize(coord, num, pid)
    assert is_multihost(), "process_count must be > 1"
    assert jax.process_count() == num
    assert jax.device_count() == 8, jax.device_count()
    assert jax.local_device_count() == 8 // num

    devices = np.asarray(jax.devices())  # global, ordered by process
    if phase in ("ep", "all"):
        run_ep(devices)
    if phase in ("model", "all"):
        run_model(devices)
    print(f"MULTIHOST_OK p{pid}", flush=True)


if __name__ == "__main__":
    main()
