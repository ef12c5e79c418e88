"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at
its 700 W limit) and the least time a piece of work can take on it."""

from __future__ import annotations

# FLOP/s by compute dtype; "float32" is outside the tensor cores (TF32 off)
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float, flops: float, dtype: str = "float32"):
    """(seconds, "bytes" or "operations"): the larger of bytes over the
    memory bandwidth and operations over the dtype's peak, and which it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
