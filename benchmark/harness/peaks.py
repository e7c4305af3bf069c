"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit) and the least time of a list of operations.

Frozen with the benchmark: a PR that changes a kernel does not change the
yardstick it is measured by.
"""

from __future__ import annotations

PEAK_OPS_PER_S = {
    "fp32": 67e12,      # fp32 outside the tensor cores (also fp64 tensor)
    "bf16": 989e12,     # bf16 / fp16 tensor cores
    "int8": 1979e12,
}
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def op(name: str, nbytes: float, **ops_by_precision) -> dict:
    """One operation: the bytes it must move (each input read once, each
    output written once) and its operations by precision."""
    for k in ops_by_precision:
        if k not in PEAK_OPS_PER_S:
            raise KeyError(f"no peak for precision {k!r}")
    return {"name": name, "bytes": float(nbytes),
            "ops": {k: float(v) for k, v in ops_by_precision.items()}}


def least_seconds(operation: dict) -> float:
    """The larger of its operations over the peak of their precision (the
    units of different precisions share the chip, so their times add) and
    its bytes over the memory bandwidth."""
    t_ops = sum(v / PEAK_OPS_PER_S[k] for k, v in operation["ops"].items())
    return max(t_ops, operation["bytes"] / PEAK_BYTES_PER_S)


def least_total(operations) -> float:
    return sum(least_seconds(o) for o in operations)
