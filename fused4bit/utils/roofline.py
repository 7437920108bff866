"""Analytic roofline model for the fused INT4 kernels.

Port of the reference's performance-truth mechanism
(`benchmark/run_benchmark.py:205-242`): per-forward bytes moved, FLOPs,
arithmetic intensity, achieved vs peak bandwidth. Peaks come from one table
keyed by JAX's ``device_kind``; a device that is not in the table is an
error, never a default.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ChipSpec", "PEAKS", "chip_spec", "linear_roofline", "RooflineReport"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float          # device-memory bandwidth, GB/s
    bf16_tflops: float       # dense bf16 tensor-core peak, TFLOP/s
    source: str = ""


# Published peaks at the full 700 W power limit (dense, no sparsity). A card
# set to a lower limit cannot hold its top clock under load: report its
# power limit beside any share of these.
_H100_SXM = ChipSpec(
    name="NVIDIA H100 SXM", hbm_gbps=3350.0, bf16_tflops=989.0,
    source="NVIDIA H100 Tensor Core GPU data sheet (SXM)",
)
PEAKS = {"NVIDIA H100 80GB HBM3": _H100_SXM}


def chip_spec(device_kind: Optional[str] = None) -> ChipSpec:
    """Peak table entry for ``device_kind`` (default: JAX's first device)."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates for device kind {device_kind!r}; add them to "
            "fused4bit.utils.roofline.PEAKS with their source"
        ) from None


@dataclasses.dataclass
class RooflineReport:
    bytes_moved: int
    flops: int
    arithmetic_intensity: float
    ridge_intensity: float
    bound: str                      # "memory" | "compute"
    sol_latency_us: float           # speed-of-light latency
    achieved_gbps: Optional[float] = None
    achieved_tflops: Optional[float] = None
    pct_of_sol: Optional[float] = None

    def pretty(self) -> str:
        lines = [
            f"bytes/fwd          {self.bytes_moved/1e6:10.2f} MB",
            f"flops/fwd          {self.flops/1e9:10.2f} GFLOP",
            f"arith intensity    {self.arithmetic_intensity:10.2f} flop/byte"
            f" (ridge {self.ridge_intensity:.1f})  -> {self.bound}-bound",
            f"speed-of-light     {self.sol_latency_us:10.1f} us",
        ]
        if self.achieved_gbps is not None:
            lines.append(
                f"achieved           {self.achieved_gbps:10.1f} GB/s"
                f" ({self.pct_of_sol:.0f}% of SoL)"
            )
        if self.achieved_tflops is not None:
            lines.append(f"achieved           {self.achieved_tflops:10.2f} TFLOP/s")
        return "\n".join(lines)


def linear_roofline(
    batch: int,
    in_dim: int,
    out_dim: int,
    *,
    weight_bits: float = 4.0,
    act_bytes: int = 2,
    chip: Optional[ChipSpec] = None,
    measured_s: Optional[float] = None,
    measured_hbm_gbps: Optional[float] = None,
) -> RooflineReport:
    """Roofline for one quantized-linear forward.

    Bytes model extends the reference's (`run_benchmark.py:219-238`,
    bytes = 4*in + out*in/2 + 8*out for fp32/INT4) to arbitrary activation
    dtype and batch:
      read x [B,K], read packed [N, K*bits/8], read scales+zp [2N f32],
      write y [B,N].
    """
    chip = chip or chip_spec()
    w_bytes = int(out_dim * in_dim * weight_bits / 8) + 8 * out_dim
    bytes_moved = batch * in_dim * act_bytes + w_bytes + batch * out_dim * act_bytes
    flops = 2 * batch * in_dim * out_dim
    ai = flops / bytes_moved
    peak_bw = measured_hbm_gbps or chip.hbm_gbps
    ridge = chip.bf16_tflops * 1e12 / (peak_bw * 1e9)
    bound = "memory" if ai < ridge else "compute"
    sol = max(
        bytes_moved / (peak_bw * 1e9), flops / (chip.bf16_tflops * 1e12)
    )
    rep = RooflineReport(
        bytes_moved=bytes_moved,
        flops=flops,
        arithmetic_intensity=ai,
        ridge_intensity=ridge,
        bound=bound,
        sol_latency_us=sol * 1e6,
    )
    if measured_s:
        rep.achieved_gbps = bytes_moved / measured_s / 1e9
        rep.achieved_tflops = flops / measured_s / 1e12
        rep.pct_of_sol = 100.0 * sol / measured_s
    return rep
