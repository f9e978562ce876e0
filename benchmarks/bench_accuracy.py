"""Decompose the f32 GPR objective error vs the f64 oracle.

Before building a compensated mode, split the perf-mode objective's
error against the f64 oracle at the headline shape into its sources:

  obj32          device f32 objective (default path)
  obj_K32_f64    host f64 objective computed FROM the device's f32 Gram
                 → (obj_K32_f64 − obj_true)  = Gram-entry rounding error
                 → (obj32 − obj_K32_f64)     = factorization/solve/reduction
                                                error at fixed K
  logdet/quad    the same split per term.

Then measure candidate fixes on-device:
  * one f32 iterative-refinement step on α against K (two extra triangular
    solves + one N² matvec — O(N²), free next to the O(N³/3) Cholesky)
  * compensated (TwoSum cascade) logdet + quad reductions

Usage: python benchmarks/bench_accuracy.py [--n 10000]
Prints one JSON line with the decomposition.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def host_objective_f64(K, Y):
    """f64 oracle objective −log p(Y) given an explicit covariance K."""
    from scipy.linalg import cho_factor, solve_triangular

    K = np.asarray(K, np.float64)
    Y = np.asarray(Y, np.float64)
    L = np.linalg.cholesky(K)
    al = solve_triangular(L, Y, lower=True)
    N = K.shape[0]
    logdet2 = float(np.sum(np.log(np.diag(L))))
    quad = float(0.5 * np.sum(al**2))
    ll = -0.5 * N * np.log(2 * np.pi) - logdet2 - quad
    return -ll, logdet2, quad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000)
    args = ap.parse_args()
    N = args.n

    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    Y = (np.sin(12 * X) + 0.66 * np.cos(25 * X)
         + 0.1 * rng.randn(N, 1)).astype(np.float32)
    ls, noise = 0.1, 1.0

    # ---- true f64 oracle (X/ls etc. all f64; X's f32 values are exact
    # in f64, so this isolates computation error, not input quantization)
    Xd = X.astype(np.float64) / ls
    sq = (Xd**2).sum(1)[:, None] - 2 * Xd @ Xd.T + (Xd**2).sum(1)[None, :]
    K64 = np.exp(-0.5 * np.maximum(sq, 0)) + noise * np.eye(N)
    obj_true, logdet_true, quad_true = host_objective_f64(K64, Y)

    # ---- device f32 pieces
    Xj = jnp.asarray(X) / ls
    Yj = jnp.asarray(Y)

    @jax.jit
    def pieces(Xs, Y):
        xs = jnp.sum(jnp.square(Xs), axis=-1)
        d2 = jnp.maximum(
            xs[:, None]
            - 2.0 * jax.lax.dot_general(
                Xs, Xs, (((1,), (1,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST)
            + xs[None, :], 0.0)
        K = jnp.exp(-0.5 * d2) + noise * jnp.eye(N, dtype=Xs.dtype)
        L = jnp.linalg.cholesky(K)
        al = jax.scipy.linalg.solve_triangular(L, Y, lower=True)
        logdet2 = jnp.sum(jnp.log(jnp.diagonal(L)))
        quad = 0.5 * jnp.sum(jnp.square(al))

        # candidate 1: one IR step on x = K⁻¹ d against K itself
        x0 = jax.scipy.linalg.solve_triangular(L.T, al, lower=False)
        r = Y - jax.lax.dot_general(
            K, x0, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)
        dz = jax.scipy.linalg.solve_triangular(L, r, lower=True)
        dx = jax.scipy.linalg.solve_triangular(L.T, dz, lower=False)
        x1 = x0 + dx
        quad_ir = 0.5 * jnp.sum(Y * x1)

        # candidate 2: compensated (pairwise-exact cascade) reductions
        def comp_sum(v):
            s = jnp.zeros((), v.dtype)
            c = jnp.zeros((), v.dtype)

            def body(carry, vi):
                s, c = carry
                y = vi - c
                t = s + y
                c = (t - s) - y
                return (t, c), None

            (s, c), _ = jax.lax.scan(body, (s, c), v)
            return s - c

        logdet2_comp = comp_sum(jnp.log(jnp.diagonal(L)))
        quad_comp = 0.5 * comp_sum(jnp.square(al).ravel())
        return K, logdet2, quad, quad_ir, logdet2_comp, quad_comp

    K32, logdet32, quad32, quad_ir, logdet_comp, quad_comp = pieces(Xj, Yj)
    K32h = np.asarray(K32)
    obj_k32, logdet_k32, quad_k32 = host_objective_f64(K32h, Y)

    const = 0.5 * N * np.log(2 * np.pi)

    def obj(ld, q):
        return const + float(ld) + float(q)

    out = {
        "n": N,
        "obj_true": obj_true,
        "gram_err": obj_k32 - obj_true,
        "gram_max_abs_entry_err": float(np.max(np.abs(K32h - K64))),
        "fact_err_logdet": float(logdet32) - logdet_k32,
        "fact_err_quad": float(quad32) - quad_k32,
        "obj32": obj(logdet32, quad32),
        "rel_err_default": abs(obj(logdet32, quad32) - obj_true)
        / abs(obj_true),
        "rel_err_ir": abs(obj(logdet32, quad_ir) - obj_true) / abs(obj_true),
        "rel_err_comp": abs(obj(logdet_comp, quad_comp) - obj_true)
        / abs(obj_true),
        "rel_err_ir_vs_k32": abs(obj(logdet32, quad_ir) - obj_k32)
        / abs(obj_k32),
        "quad_ir_err_vs_k32": float(quad_ir) - quad_k32,
        "logdet_comp_err_vs_k32": float(logdet_comp) - logdet_k32,
    }
    for k, v in out.items():
        print(f"# {k}: {v}", flush=True)
    print(json.dumps({k: (float(v) if not isinstance(v, int) else v)
                      for k, v in out.items()}))


if __name__ == "__main__":
    main()
