"""The work of one training step of the exact LMC at the configuration's
shapes, from its mathematics: the bf16 kernel stack built once, the
``max_cg_iters`` PCG iterations whole (each one stack product with the
1 + s right-hand sides and one preconditioner apply), the backward's one
stack product with 1 + 2s right-hand sides and the lengthscale reduction
on the rank-(1 + 2s) cotangent, and the Nyström roots once a chunk of
``roots_every`` steps. Small host-sized pieces (the quadrature's (s, K, K)
eigh, AdamW on a few hundred numbers) are left out."""

from __future__ import annotations

from harness import work
from harness.peaks import least_total, op


def _scaled(o, f):
    return op(o["name"], o["bytes"] * f, **{k: v * f for k, v in
                                           o["ops"].items()})


def step_operations(cfg):
    n, d, t, q = cfg["n"], cfg["d"], cfg["T"], cfg["q"]
    mll = cfg["mll"]
    s, m, iters = mll["num_probes"], mll["precond_rank"], mll["max_cg_iters"]
    F32 = work.F32
    r = 1 + s                                        # CG right-hand sides
    pairs = q * work.tri(n)

    def minv(cols):
        # (M⁻¹V): two products with the (q, n, m) roots, the (qm)² capacitance
        return op("preconditioner apply", (2 * q * n * m + (q * m) ** 2) * F32,
                  fp32=4.0 * q * n * m * cols + 2.0 * (q * m) ** 2 * cols)

    ops = [work.kernel_eval("stack build", pairs, d, work.BF16, n)]
    ops += [work.stack_product("CG stack product", q, n, r, work.BF16, "bf16")
            for _ in range(iters)]
    ops += [minv(r) for _ in range(iters + 1)] + [minv(s)]
    ops.append(work.gemm("capacitance Gram", q * m, q * m, n))
    ops.append(work.cholesky("capacitance factor", q * m))
    ops.append(work.cholesky_inverse("capacitance inverse", q * m))
    ops.append(work.stack_product("backward stack product", q, n, 1 + 2 * s,
                                  work.BF16, "bf16"))
    ops.append(work.kernel_lengthscale_grad("lengthscale reduction", pairs, d,
                                            1 + 2 * s, q * n))
    per_chunk = 1.0 / cfg["roots_every"]
    roots = [work.kernel_eval("roots K(z, z)", q * work.tri(m), d, F32, m),
             work.kernel_eval("roots K(x, z)", q * n * m, d, F32, n + m),
             work.cholesky("roots factor", m, q),
             work.triangular_solve("roots solve", m, n, q)]
    ops += [_scaled(o, per_chunk) for o in roots]
    return ops


def least_step_seconds(cfg) -> float:
    return least_total(step_operations(cfg))
