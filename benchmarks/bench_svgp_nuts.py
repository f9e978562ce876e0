"""Secondary benchmarks (BASELINE metrics #2/#3): SVGP iters/sec and NUTS
ESS/sec on the default backend. Not the driver's bench.py entry — run
manually; results tracked in BASELINE.md.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_svgp(N=100_000, M=256, B=1024, steps=20):
    import jax

    import gpflow_slim_tpu as gfs

    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    Y = (np.sin(10 * X) > 0).astype(np.float32)
    Z = np.linspace(0, 1, M, dtype=np.float32)[:, None]
    m = gfs.models.SVGP(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.2),
                        likelihood=gfs.likelihoods.Bernoulli(), Z=Z)

    import optax

    from gpflow_slim_tpu.parallel.dp import make_svgp_step

    step_fn, (leaves, opt_state, treedef) = make_svgp_step(
        m, optax.adam(1e-2), batch_size=B
    )

    @jax.jit
    def run(leaves, opt_state, key):
        def body(carry, k):
            leaves, opt_state = carry
            leaves, opt_state, loss = step_fn(leaves, opt_state, k)
            return (leaves, opt_state), loss

        keys = jax.random.split(key, steps)
        (leaves, opt_state), losses = jax.lax.scan(
            body, (leaves, opt_state), keys
        )
        return leaves, opt_state, losses

    # compile with one key, time with a DIFFERENT key and force with
    # device_get
    leaves, opt_state2, losses = run(leaves, opt_state, jax.random.PRNGKey(0))
    float(losses[-1])
    t0 = time.perf_counter()
    _, _, losses = run(leaves, opt_state, jax.random.PRNGKey(1))
    float(losses[-1])
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": f"svgp_iters_per_sec_N{N}_M{M}_B{B}",
        "value": round(steps / dt, 2), "unit": "iters/s",
    }))


def bench_sgpr(N=10_000, M=100, reps=30):
    """BASELINE config #2: SGPR (Titsias collapsed bound), N=10k, M=100
    inducing, composite Matérn32 + Periodic kernel. Scan-amortized
    objective evals/s on the default backend."""
    import time as _t

    import jax
    import jax.numpy as jnp

    import gpflow_slim_tpu as gfs

    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    Y = (np.sin(12 * X) + 0.3 * np.sin(40 * X)
         + 0.1 * rng.randn(N, 1)).astype(np.float32)
    kern = (gfs.kernels.Matern32(1, lengthscales=0.2)
            + gfs.kernels.Periodic(1, period=0.16, lengthscales=0.5))
    m = gfs.models.SGPR(X, Y, kern=kern,
                        Z=np.linspace(0, 1, M, None)[:, None]
                        .astype(np.float32))
    leaves, treedef = jax.tree_util.tree_flatten(m)

    @jax.jit
    def many(leaves, seed):
        def body(carry, i):
            pert = [
                l + seed * 1e-7 + 1e-6 * (i + 1) if l.ndim == 0 else l
                for l in leaves
            ]
            mm = jax.tree_util.tree_unflatten(treedef, pert)
            return carry + mm.objective(), None

        total, _ = jax.lax.scan(
            body, jnp.zeros((), jnp.float32), jnp.arange(reps))
        return total

    float(many(leaves, jnp.float32(0.0)))
    best = float("inf")
    for t in range(3):
        t0 = _t.perf_counter()
        float(many(leaves, jnp.float32(17.0 + 7 * t)))
        best = min(best, _t.perf_counter() - t0)
    out = {
        "metric": f"sgpr_elbo_evals_per_sec_N{N}_M{M}",
        "value": round(reps / best, 1), "unit": "evals/s",
    }
    print(json.dumps(out), flush=True)
    return out


def bench_svgp_natgrad(N=100_000, M=256, B=1024, steps=20):
    """BASELINE config #3's stated optimizer: natgrad(q) + Adam(hypers)."""
    import jax

    import gpflow_slim_tpu as gfs

    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    Y = (np.sin(10 * X) > 0).astype(np.float32)
    Z = np.linspace(0, 1, M, dtype=np.float32)[:, None]
    m = gfs.models.SVGP(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.2),
                        likelihood=gfs.likelihoods.Bernoulli(), Z=Z)

    import time as _t

    # compile+warm with one key, time with another (memoization defense)
    m1, losses = gfs.training.fit_svgp_natgrad(
        m, steps, jax.random.PRNGKey(0), gamma=0.1, batch_size=B)
    float(losses[-1])
    t0 = _t.perf_counter()
    _, losses = gfs.training.fit_svgp_natgrad(
        m, steps, jax.random.PRNGKey(1), gamma=0.1, batch_size=B)
    float(losses[-1])
    dt = _t.perf_counter() - t0
    out = {
        "metric": f"svgp_natgrad_iters_per_sec_N{N}_M{M}_B{B}",
        "value": round(steps / dt, 2), "unit": "iters/s",
    }
    print(json.dumps(out), flush=True)
    return out


def bench_nuts(N=1000, chains=8, samples=None, warmup=None):
    # convergence-grade defaults: the Stan-style windowed warmup
    # (mcmc.nuts.warmup_schedule) needs ≥ init+window+term ≈ 150 draws to
    # complete a full fast/slow-doubling/fast cycle; 300 gives two slow
    # doublings. 256 retained draws × 8 chains puts min-ESS well past 100
    # so the ESS/s metric is measured on a CONVERGED sampler (R̂ ≤ 1.01).
    samples = samples or int(os.environ.get("BENCH_NUTS_SAMPLES", 256))
    warmup = warmup or int(os.environ.get("BENCH_NUTS_WARMUP", 300))
    import jax
    import jax.numpy as jnp

    import gpflow_slim_tpu as gfs

    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    Y = (np.sin(6 * X) + 0.2 * rng.randn(N, 1)).astype(np.float32)
    k = gfs.kernels.RBF(1, lengthscales=0.3)
    k.variance = gfs.params.Param(
        1.0, transform=gfs.transforms.positive(),
        prior=gfs.priors.LogNormal(0.0, 1.0), name="v", dtype=jnp.float32)
    k.lengthscales = gfs.params.Param(
        0.3, transform=gfs.transforms.positive(),
        prior=gfs.priors.LogNormal(-1.0, 1.0), name="l", dtype=jnp.float32)
    m = gfs.models.GPR(X, Y, kern=k)
    m.likelihood.variance = gfs.params.Param(
        0.05, transform=gfs.transforms.positive(),
        prior=gfs.priors.LogNormal(-2.0, 1.0), name="n", dtype=jnp.float32)

    lp, x0, _ = gfs.mcmc.model_logprob(m)
    x0s = jnp.tile(x0, (chains, 1))

    # everything window-chunked: warmup AND sampling run as short device
    # programs, the Stan phases driven from the host via
    # nuts_warmup_window, chunked to ≤ `chunk` transitions per program,
    # with the (da, welford, inv_mass) state riding along (progress is
    # printed between windows)
    window = int(os.environ.get("BENCH_NUTS_WINDOW", 32))
    chunk = int(os.environ.get("BENCH_NUTS_CHUNK", 50))

    warm_win = jax.jit(jax.vmap(
        lambda z, k, da, w, im: gfs.mcmc.nuts_warmup_window(
            lp, z, k, da, w, im, max_depth=8, adapt_axis="c"),
        axis_name="c",
    ))
    slow_close = jax.jit(jax.vmap(
        lambda da, w: gfs.mcmc.nuts_slow_window_close(da, w, "c"),
        axis_name="c",
    ))
    sample_w = jax.jit(jax.vmap(
        lambda x, k, eps, im: gfs.mcmc.nuts(
            lp, x, k, window, num_warmup=0, step_size=eps, inv_mass=im,
            max_depth=8),
    ))

    da1, w1, im1 = gfs.mcmc.nuts_warmup_init(x0, step_size=0.1)
    bc = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (chains,) + jnp.shape(x)), t)
    z, da, im = x0s, bc(da1), bc(im1)
    kidx = 0
    for phase, span in gfs.mcmc.warmup_schedule(warmup):
        w = bc(w1)
        done = 0
        while done < span:
            n = min(chunk, span - done)
            keys = jax.random.split(
                jax.random.PRNGKey(1000 + kidx), chains * n
            ).reshape(chains, n, -1)
            kidx += 1
            z, da, w, im = warm_win(z, keys, da, w, im)
            jax.block_until_ready(z)
            done += n
            print(f"# warmup {phase} {done}/{span}", file=sys.stderr)
        if phase == "slow":
            da, im = slow_close(da, w)
    eps = jnp.exp(da.log_step_avg)
    im = jnp.asarray(im)
    print("# warmup done; compiling sampling window", file=sys.stderr)
    # compile the sampling window
    sw, _ = sample_w(z, jax.random.split(jax.random.PRNGKey(9), chains),
                     eps, im)
    float(jnp.sum(sw))
    print("# sampling window compiled", file=sys.stderr)

    n_windows = max(1, samples // window)
    chunks = []
    t0 = time.perf_counter()
    for w in range(n_windows):
        keys = jax.random.split(jax.random.PRNGKey(100 + w), chains)
        sw, _ = sample_w(z, keys, eps, im)
        z = sw[:, -1, :]
        chunks.append(np.asarray(sw))
    dt = time.perf_counter() - t0
    s = np.concatenate(chunks, axis=1)  # (chains, samples, dim)
    ess = gfs.mcmc.effective_sample_size(np.asarray(s))
    out = {
        "metric": f"nuts_ess_per_sec_gpr_n{N}_c{chains}",
        "value": round(float(np.min(ess)) / dt, 3), "unit": "ESS/s",
        "total_time_s": round(dt, 1),
        "min_ess": round(float(np.min(ess)), 1),
        "rhat_max": round(float(np.max(
            gfs.mcmc.potential_scale_reduction(np.asarray(s)))), 4),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    which = os.environ.get("BENCH_WHICH", "all")
    if which in ("svgp", "both", "all"):
        bench_svgp()
    if which in ("sgpr", "all"):
        bench_sgpr()
    if which in ("natgrad", "all"):
        bench_svgp_natgrad(steps=int(os.environ.get("BENCH_NATGRAD_STEPS",
                                                    200)))
    if which in ("nuts", "both", "all"):
        bench_nuts()
