"""Scaling-efficiency harness: distributed GPR + NUTS chains vs mesh size.

Rehearses the north-star ">80% multi-host efficiency" measurement
(BASELINE.json) without pod hardware: runs the SAME sharded programs the
pod would run at mesh sizes 1/2/4/8 and reports throughput + efficiency.

Two regimes, auto-detected:

  * real multi-device backend (each mesh device is its own chip):
    strong-scaling efficiency = rate_P / (P · rate_1) — the north-star
    number.
  * virtual CPU mesh (``--xla_force_host_platform_device_count``): all
    "devices" share the host's cores, so ideal strong scaling keeps the
    rate FLAT; what the rehearsal measures is partitioning + collective
    OVERHEAD: eff_virtual = rate_P / rate_1. On real chips the same
    harness yields the real number.

Measurements:

  1. Distributed exact-GPR loss+grad (1-D ring Gram + sharded blocked
     Cholesky, ``make_distributed_gpr_loss``) at fixed global N — strong
     scaling.
  2. NUTS chains (``sample_chains`` over a ``chains`` mesh axis, shared
     adaptation via pmean) with chains ∝ devices — weak scaling (ideal:
     flat wall-clock as chains grow with P).

Usage:  python benchmarks/bench_scaling.py [--devices 1,2,4,8] [--n 4096]
        [--chains-per-dev 2] [--samples 64] [--skip-nuts]
Prints one JSON line per (bench, P) plus a summary table to stderr.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_ap = argparse.ArgumentParser()
_ap.add_argument("--devices", default="1,2,4,8")
_ap.add_argument("--n", type=int, default=4096)
_ap.add_argument("--block-size", type=int, default=256)
_ap.add_argument("--chains-per-dev", type=int, default=2)
_ap.add_argument("--fixed-chains", type=int, default=None,
                 help="keep the TOTAL chain count fixed across mesh sizes "
                      "(measures the chains-axis sharding overhead at "
                      "constant statistical work) instead of chains ∝ P")
_ap.add_argument("--samples", type=int, default=64)
_ap.add_argument("--warmup", type=int, default=64)
_ap.add_argument("--reps", type=int, default=3)
_ap.add_argument("--skip-nuts", action="store_true")
_ap.add_argument("--skip-gpr", action="store_true")
_ap.add_argument("--grid", default=None, metavar="PRxPC",
                 help="also bench the comm-optimal 2-D grid GPR loss "
                      "(make_grid_gpr_loss) on a PRxPC mesh, e.g. 2x4 — "
                      "plus a 1-device reference for overhead-efficiency")
_ap.add_argument("--cyclic", action="store_true",
                 help="also bench the explicit-collective 1-D cyclic "
                      "Cholesky factorization, lookahead on vs off, at "
                      "each mesh size")
_ap.add_argument("--real", action="store_true",
                 help="use the real accelerator devices. Default is the "
                      "virtual CPU mesh, which measures partitioning and "
                      "collective overhead only")
args = _ap.parse_args()

sizes = sorted({int(s) for s in args.devices.split(",")})
max_dev = sizes[-1]
if args.grid:
    _pr, _pc = (int(s) for s in args.grid.lower().split("x"))
    max_dev = max(max_dev, _pr * _pc)

# the virtual-device flag must land before the backend client exists
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={max_dev}"
)

import jax  # noqa: E402

if not args.real:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import gpflow_slim_tpu as gfs  # noqa: E402
from gpflow_slim_tpu import parallel  # noqa: E402

VIRTUAL = jax.default_backend() == "cpu"


def _mesh(P, axis):
    return Mesh(np.array(jax.devices()[:P]), (axis,))


def _timed_min(fn, reps):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_gpr(sizes):
    """Strong scaling: fixed global N, distributed loss+grad evals/s."""
    N = args.n
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    Y = (np.sin(12 * X) + 0.1 * rng.randn(N, 1)).astype(np.float32)
    rows = []
    for P_ in sizes:
        mesh = _mesh(P_, "rows")
        model = gfs.models.GPR(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.2))
        loss_fn = parallel.make_distributed_gpr_loss(
            model, mesh, block_size=args.block_size)
        vg = jax.jit(jax.value_and_grad(loss_fn))
        v, g = vg(model)
        jax.block_until_ready((v, g))  # compile + warm

        def run():
            jax.block_until_ready(vg(model))

        dt = _timed_min(run, args.reps)
        rows.append((P_, 1.0 / dt))
        print(json.dumps({
            "bench": "dist_gpr_loss_grad", "devices": P_, "n": N,
            "evals_per_sec": round(1.0 / dt, 4), "sec": round(dt, 4),
            "virtual_mesh": VIRTUAL,
        }))
    return rows


def bench_grid(spec):
    """2-D grid GPR loss+grad (comm-optimal row/col-scoped exchange) vs a
    1-device run of the same program — overhead-efficiency on the virtual
    mesh, strong-scaling efficiency on real devices."""
    Pr, Pc = (int(s) for s in spec.lower().split("x"))
    N = args.n
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    Y = (np.sin(12 * X) + 0.1 * rng.randn(N, 1)).astype(np.float32)
    rows = []
    combos = [(1, 1)]
    if (Pr, Pc) != (1, 1):
        combos.append((Pr, Pc))
    for pr, pc in combos:
        P_ = pr * pc
        mesh = Mesh(
            np.array(jax.devices()[:P_]).reshape(pr, pc), ("rows", "cols"))
        model = gfs.models.GPR(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.2))
        loss_fn = parallel.make_grid_gpr_loss(
            model, mesh, block_size=args.block_size)
        vg = jax.jit(jax.value_and_grad(loss_fn))
        jax.block_until_ready(vg(model))  # compile + warm

        def run():
            jax.block_until_ready(vg(model))

        dt = _timed_min(run, args.reps)
        rows.append((P_, 1.0 / dt))
        print(json.dumps({
            "bench": "grid_gpr_loss_grad", "devices": P_,
            "grid": f"{pr}x{pc}", "n": N,
            "evals_per_sec": round(1.0 / dt, 4), "sec": round(dt, 4),
            "virtual_mesh": VIRTUAL,
        }))
    return rows


def bench_cyclic(sizes):
    """Explicit-collective 1-D cyclic Cholesky factor-only, lookahead A/B."""
    N = args.n
    rng = np.random.RandomState(3)
    A = rng.randn(N, N).astype(np.float32)
    K = jnp.asarray(A @ A.T + N * np.eye(N, dtype=np.float32))
    rows = []
    for P_ in sizes:
        mesh = _mesh(P_, "rows")
        for look in (True, False):
            fn = jax.jit(lambda K, look=look, mesh=mesh:
                         parallel.cyclic_cholesky(
                             K, mesh, "rows", block_size=args.block_size,
                             lookahead=look))
            jax.block_until_ready(fn(K))

            def run():
                jax.block_until_ready(fn(K))

            dt = _timed_min(run, args.reps)
            if look:
                rows.append((P_, 1.0 / dt))
            print(json.dumps({
                "bench": "cyclic_cholesky", "devices": P_, "n": N,
                "lookahead": look, "factor_per_sec": round(1.0 / dt, 4),
                "sec": round(dt, 4), "virtual_mesh": VIRTUAL,
            }))
    return rows


def bench_nuts(sizes):
    """Weak scaling: chains ∝ devices, shared adaptation across the mesh."""
    rng = np.random.RandomState(1)
    N = 256
    X = rng.uniform(0, 1, (N, 1))
    Y = np.sin(12 * X) + 0.1 * rng.randn(N, 1)
    dt_f = gfs.config.default_float()
    X, Y = jnp.asarray(X, dt_f), jnp.asarray(Y, dt_f)

    def make_model():
        # the REAL hyperposterior shape (BASELINE config #4): LogNormal
        # priors on all three hypers — without them the posterior is
        # improper-ish and 512 draws measure mixing failure (R̂ 1.2,
        # observed 2026-08-21), not sampler throughput
        k = gfs.kernels.RBF(1, lengthscales=0.3)
        k.variance = gfs.params.Param(
            1.0, transform=gfs.transforms.positive(),
            prior=gfs.priors.LogNormal(0.0, 1.0), name="v", dtype=dt_f)
        k.lengthscales = gfs.params.Param(
            0.3, transform=gfs.transforms.positive(),
            prior=gfs.priors.LogNormal(-1.0, 1.0), name="l", dtype=dt_f)
        m = gfs.models.GPR(np.asarray(X), np.asarray(Y), kern=k)
        m.likelihood.variance = gfs.params.Param(
            0.05, transform=gfs.transforms.positive(),
            prior=gfs.priors.LogNormal(-2.0, 1.0), name="n", dtype=dt_f)
        return m

    def logprob(z):
        m = make_model()
        leaves, td = jax.tree_util.tree_flatten(m)
        # overwrite the 3 scalar hypers (unconstrained) with z
        zi = iter(range(len(z)))
        leaves = [z[next(zi)] if l.ndim == 0 else l for l in leaves]
        return -jax.tree_util.tree_unflatten(td, leaves).objective()

    dim = 3
    rows = []
    for P_ in sizes:
        C = args.fixed_chains or (args.chains_per_dev * P_)
        if C % P_ != 0:
            continue
        x0s = 0.1 * jax.random.normal(
            jax.random.PRNGKey(0), (C, dim), dtype=dt_f)
        mesh = _mesh(P_, "chains") if P_ > 1 else None

        samples_box = {}

        def run():
            s, info = parallel.sample_chains(
                logprob, x0s, jax.random.PRNGKey(2), args.samples,
                sampler="nuts", mesh=mesh, num_warmup=args.warmup,
                max_depth=6,
            )
            jax.block_until_ready(s)
            samples_box["s"] = s

        run()  # compile
        dt = _timed_min(run, max(1, args.reps - 1))
        draws_ps = C * args.samples / dt
        s = np.asarray(samples_box["s"])
        ess = gfs.mcmc.effective_sample_size(s)
        rhat = gfs.mcmc.potential_scale_reduction(s)
        rows.append((P_, draws_ps))
        print(json.dumps({
            "bench": "nuts_chains", "devices": P_, "chains": C,
            "draws_per_sec": round(draws_ps, 2), "sec": round(dt, 3),
            "min_ess_per_sec": round(float(np.min(ess)) / dt, 3),
            "min_ess": round(float(np.min(ess)), 1),
            "rhat_max": round(float(np.max(rhat)), 4),
            "virtual_mesh": VIRTUAL,
        }))
    return rows


def summarize(name, rows, weak=False):
    if not rows:
        return
    p1, r1 = rows[0]
    print(f"\n# {name} ({'virtual CPU mesh — overhead rehearsal' if VIRTUAL else 'real devices'})",
          file=sys.stderr)
    hdr = "devices  rate       speedup  " + (
        "eff(weak)" if weak else ("overhead-eff" if VIRTUAL else "eff(strong)"))
    print("# " + hdr, file=sys.stderr)
    for P_, r in rows:
        su = r / r1
        if weak:
            # ideal weak scaling: rate ∝ P (real) / flat total rate (virtual)
            eff = su / (P_ / p1) if not VIRTUAL else su
        else:
            eff = su / (P_ / p1) if not VIRTUAL else su
        print(f"# {P_:7d}  {r:9.3f}  {su:6.2f}x  {eff:8.1%}", file=sys.stderr)


if __name__ == "__main__":
    if not args.skip_gpr:
        summarize("distributed GPR loss+grad (strong scaling)",
                  bench_gpr(sizes))
    if args.grid:
        summarize("2-D grid GPR loss+grad (strong scaling)",
                  bench_grid(args.grid))
    if args.cyclic:
        summarize("1-D cyclic Cholesky factor, lookahead (strong scaling)",
                  bench_cyclic(sizes))
    if not args.skip_nuts:
        summarize("NUTS chains (weak scaling)", bench_nuts(sizes), weak=True)
