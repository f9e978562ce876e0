"""Benchmark: exact-GPR marginal-likelihood evals/sec at N=10k (BASELINE #1).

Prints the headline JSON line LAST:
{"metric", "value", "unit", "vs_baseline", ...}. ``vs_baseline`` compares
against the reference math re-run as a numpy/scipy f64 oracle on CPU (the
reference publishes no numbers — BASELINE.md; order-of-magnitude only: the
oracle's rate depends on the host's load), i.e. value / oracle_evals_per_sec.

Driver metrics #2 and #3 (SVGP natgrad iters/s, NUTS ESS/s) are
re-measured on every run (a silent regression in either went unnoticed
for two rounds when they were only cited): each prints its
own JSON line first, and the values are duplicated as keys of the
headline line so a single-line consumer still sees all three.
``BENCH_SECONDARY=0`` skips them (fast headline-only run).

Runs on a GPU only: it prints the device (platform, ``device_kind``,
count, and the card's name and power limit) on an earlier line and exits
non-zero when JAX finds no GPU. f32 on the card; the parity story is
covered by the f64 CPU tests.
"""

import json
import os
import sys
import time

# Pin the oracle's BLAS thread count BEFORE numpy loads: the host CPU is
# shared and unpinned OpenBLAS/MKL threading made `vs_baseline` swing 4×
# between rounds for reasons unrelated to this project.
for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_v, "8")

import numpy as np  # noqa: E402


def oracle_eval_rate(X, Y, variance, lengthscale, noise, reps=2):
    """Reference-math (numpy/scipy f64) marginal-likelihood eval rate.

    min-of-``reps`` per-eval timing with BLAS threads pinned (above): the
    oracle shares the host with other processes, and a single-rep unpinned
    measurement drifted 5× between rounds;
    the pinned minimum is the stable statistic. The absolute oracle rate is
    also reported in the JSON line so the ratio can be audited.
    """
    from scipy.linalg import solve_triangular

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        Xs = X / lengthscale
        sq = (
            (Xs**2).sum(1)[:, None]
            - 2 * Xs @ Xs.T
            + (Xs**2).sum(1)[None, :]
        )
        K = variance * np.exp(-0.5 * np.maximum(sq, 0))
        K[np.diag_indices_from(K)] += noise
        L = np.linalg.cholesky(K)
        alpha = solve_triangular(L, Y, lower=True)
        _ = (
            -0.5 * X.shape[0] * np.log(2 * np.pi)
            - np.sum(np.log(np.diag(L)))
            - 0.5 * np.sum(alpha**2)
        )
        best = min(best, time.perf_counter() - t0)
    return 1.0 / best


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main():
    N = int(os.environ.get("BENCH_N", 10_000))
    import jax

    import gpflow_slim_tpu as gfs

    gfs.utils.enable_compile_cache()
    print(json.dumps({"device": gfs.utils.require_gpu()}), flush=True)

    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    Y = (np.sin(12 * X) + 0.66 * np.cos(25 * X)
         + 0.1 * rng.randn(N, 1)).astype(np.float32)

    model = gfs.models.GPR(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.1))

    @jax.jit
    def objective(m):
        return m.objective()

    # compile + warm up + correctness check vs the f64 oracle value.
    # The oracle is evaluated at the model's EFFECTIVE hyperparameters
    # (the f32 positive-transform round-trip of 0.1/1.0/1.0, pulled to
    # f64) — comparing at exactly-0.1 instead conflated ~1e-7 parameter
    # quantization, amplified by the objective's hyperparameter
    # sensitivity, into a ~2.5e-5 "accuracy gap" (rounds 1-3). With the
    # oracle at the same point, the measured f32 COMPUTATION error at
    # N=10k is ~6.5e-7 relative (decomposition:
    # benchmarks/bench_accuracy.py).
    import jax.numpy as _jnp

    val = float(objective(model).block_until_ready())
    if os.environ.get("BENCH_CHECK", "1") == "1":
        from scipy.linalg import solve_triangular as _st

        ls_eff = float(np.float64(np.asarray(
            _jnp.squeeze(model.kern.lengthscales.value))))
        var_eff = float(np.float64(np.asarray(
            _jnp.squeeze(model.kern.variance.value))))
        noise_eff = float(np.float64(np.asarray(
            _jnp.squeeze(model.likelihood.variance.value))))
        Xd = X.astype(np.float64) / ls_eff
        sq = (
            (Xd**2).sum(1)[:, None] - 2 * Xd @ Xd.T + (Xd**2).sum(1)[None, :]
        )
        Kd = var_eff * np.exp(-0.5 * np.maximum(sq, 0)) + noise_eff * np.eye(N)
        Ld = np.linalg.cholesky(Kd)
        al = _st(Ld, Y.astype(np.float64), lower=True)
        oracle_val = -float(
            -0.5 * N * np.log(2 * np.pi)
            - np.log(np.diag(Ld)).sum()
            - 0.5 * (al**2).sum()
        )
        rel = abs(val - oracle_val) / abs(oracle_val)
        print(
            f"# f64-oracle check (effective hypers ls={ls_eff:.9g}): "
            f"device={val:.4f} oracle={oracle_val:.4f} rel={rel:.2e}",
            file=sys.stderr,
        )
        if rel > 1e-5:
            print("# WARNING objective computation error beyond 1e-5",
                  file=sys.stderr)

    # time R evals in ONE on-device lax.scan: each iteration perturbs a
    # hyperparameter (defeats any caching) and the scan keeps the loop on
    # the device, so dispatch latency is amortized out — this
    # measures device throughput, the number that matters for training
    # loops (which are themselves scans).
    import jax.numpy as jnp

    reps = int(os.environ.get("BENCH_REPS", 30))

    def make_many_evals(m):
        leaves, treedef = jax.tree_util.tree_flatten(m)

        @jax.jit
        def many_evals(leaves, seed):
            def body(carry, i):
                pert = [
                    l + seed * 1e-7 + 1e-6 * (i + 1) if l.ndim == 0 else l
                    for l in leaves
                ]
                mm = jax.tree_util.tree_unflatten(treedef, pert)
                return carry + mm.objective(), None

            total, _ = jax.lax.scan(
                body, jnp.zeros((), jnp.float32), jnp.arange(reps)
            )
            return total

        return leaves, many_evals

    # fresh seed per timed call (defeats result memoization); min-of-3
    leaves, many_evals = make_many_evals(model)
    many_evals(leaves, jnp.float32(0.0)).block_until_ready()  # compile
    elapsed = min(
        _timed(
            lambda: many_evals(
                leaves, jnp.float32(17.0 + 7 * t)).block_until_ready()
        )
        for t in range(3)
    )
    evals_per_sec = reps / elapsed

    base = oracle_eval_rate(
        X.astype(np.float64), Y.astype(np.float64), 1.0, 0.1, 1.0,
        reps=3 if N >= 10_000 else 5,
    )

    # driver metrics #2/#3, re-measured every round (their own JSON lines
    # print first; headline line stays LAST for single-line consumers).
    # A secondary-bench flake must not lose the headline metric.
    extra = {}
    if os.environ.get("BENCH_SECONDARY", "1") == "1":
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "benchmarks"))
        import bench_svgp_nuts

        try:
            ng = bench_svgp_nuts.bench_svgp_natgrad(
                steps=int(os.environ.get("BENCH_NATGRAD_STEPS", 200)))
            extra["svgp_natgrad_iters_per_sec"] = ng["value"]
        except Exception as e:  # pragma: no cover - env flake path
            print(f"# natgrad bench failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
        try:
            # convergence-grade draw count: 256 draws measures R̂≈1.04,
            # 1024 reaches R̂≤1.01 (round-4 table in BASELINE.md) — the
            # ESS/s metric is only meaningful on a converged sampler
            os.environ.setdefault("BENCH_NUTS_SAMPLES", "1024")
            nu = bench_svgp_nuts.bench_nuts()
            extra["nuts_ess_per_sec"] = nu["value"]
            extra["nuts_min_ess"] = nu["min_ess"]
            extra["nuts_rhat_max"] = nu["rhat_max"]
        except Exception as e:  # pragma: no cover - env flake path
            print(f"# nuts bench failed: {type(e).__name__}: {e}",
                  file=sys.stderr)

    print(json.dumps({
        "metric": f"gpr_marglik_evals_per_sec_n{N}",
        "value": round(evals_per_sec, 3),
        "unit": "evals/s",
        "vs_baseline": round(evals_per_sec / base, 2),
        "oracle_evals_per_sec": round(base, 4),
        **extra,
    }))


if __name__ == "__main__":
    main()
