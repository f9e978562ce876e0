"""End-to-end smoke run of the main path on one GPU.

    python chip_smoke.py               # one GPU: device, gpr, sgpr, svgp, nuts
    python chip_smoke.py --four-cards  # gfs.parallel on four GPUs vs one card

Each phase drives the public ``gfs.models`` / ``gfs.training`` /
``gfs.mcmc`` / ``gfs.parallel`` entry points at full width on seeded data
and prints one JSON line: sizes, dtype, the default matmul precision, each
error beside its tolerance, compile seconds and ``peak_bytes_in_use``.
f32 results are compared with the same model cast to f64 and evaluated on
the card (which runs f64 natively), or with a numpy f64 oracle.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
A failed check raises, so the script exits non-zero without that line; so
does a run in which JAX finds no GPU. All phases run in this one process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


class SmokeFailure(AssertionError):
    """A phase's check failed."""


def _rel(a, b):
    """Norm-wise relative error of ``a`` against the reference ``b``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _x64(dtype):
    """Context in which models are built and run in ``dtype``."""
    return jax.enable_x64(np.dtype(dtype) == np.float64)


class _Phase:
    """Collects one phase's checks; prints its JSON line when it ends,
    failed or not (a failure is named in the line and then re-raised)."""

    def __init__(self, name, dtype, **sizes):
        self.line = {
            "phase": name,
            "sizes": sizes,
            "dtype": np.dtype(dtype).name,
            "matmul_precision": str(jax.config.jax_default_matmul_precision),
            "checks": {},
            "compile_s": 0.0,
        }

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        stats = jax.devices()[0].memory_stats() or {}
        self.line["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
        if exc_type is not None:
            self.line["failed"] = f"{exc_type.__name__}: {exc}"
        print(json.dumps(self.line), flush=True)
        return False

    def compile(self, fn, *args):
        """AOT-compile ``jax.jit(fn)`` for ``args``, counting the time.

        Compiled over the flat leaf list: a Module's tree structure depends
        on its leaves' types, so it does not survive AOT's argument specs.
        """
        treedef = jax.tree_util.tree_structure(args)
        t0 = time.perf_counter()
        compiled = jax.jit(
            lambda leaves: fn(*jax.tree_util.tree_unflatten(treedef, leaves))
        ).lower(jax.tree_util.tree_leaves(args)).compile()
        self.line["compile_s"] += time.perf_counter() - t0
        return lambda *a: compiled(jax.tree_util.tree_leaves(a))

    def timed(self, name, fn, *args):
        """Run ``fn(*args)`` to completion; record its wall seconds."""
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        self.line.setdefault("seconds", {})[name] = time.perf_counter() - t0
        return out

    def check(self, name, err, tol):
        err = float(err)
        self.line["checks"][name] = {"err": err, "tol": tol}
        if not err <= tol:  # NaN fails too
            raise SmokeFailure(
                f"{self.line['phase']}/{name}: error {err!r} > {tol!r}")

    def require(self, name, ok, **values):
        self.line["checks"][name] = {"ok": bool(ok), **values}
        if not ok:
            raise SmokeFailure(f"{self.line['phase']}/{name}: {values}")


def _f64(dtype):
    """Context for the f64 reference of a ``dtype`` model: x64 on, and the
    jitter that model runs with (``config.default_jitter`` is dtype-aware),
    so that the two differ in arithmetic only."""
    from gpflow_slim_tpu import config

    with _x64(dtype):
        jitter = config.default_jitter()
    stack = contextlib.ExitStack()
    stack.enter_context(config.temp_settings(jitter=jitter))
    stack.enter_context(jax.enable_x64(True))
    return stack


def _to_f64(tree):
    """The same pytree in f64: each Param keeps its constrained value (the
    f32 model's effective hyperparameter), floating arrays are cast."""
    from gpflow_slim_tpu.params import Param

    def leaf(x):
        if isinstance(x, Param):
            value = np.asarray(jax.device_get(x.value), np.float64)
            return Param(value, transform=x.transform, prior=x.prior,
                         trainable=x.trainable, name=x.name,
                         dtype=np.float64)
        x = np.asarray(jax.device_get(x))
        return x.astype(np.float64) if x.dtype.kind == "f" else x

    with jax.enable_x64(True):
        return jax.tree_util.tree_map(
            leaf, tree, is_leaf=lambda x: isinstance(x, Param))


def _check_grads(ph, tag, g, g_ref, tol):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g),
                            jax.tree_util.tree_leaves(g_ref)):
        ph.check(f"{tag}/grad{jax.tree_util.keystr(path)}", _rel(a, b), tol)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def device_phase():
    """Fail unless JAX runs on a GPU; print what it runs on."""
    import gpflow_slim_tpu as gfs

    info = gfs.utils.require_gpu()
    cache = gfs.utils.enable_compile_cache()
    print(json.dumps({"phase": "device", **info, "jax": jax.__version__,
                      "compile_cache": cache}), flush=True)
    print(info["nvidia_smi"], flush=True)
    return info


def _numpy_gpr_objective(X, Y, variance, lengthscales, noise):
    """Reference −log p(Y) of an RBF GPR, numpy/scipy in f64."""
    from scipy.linalg import solve_triangular

    Xs = np.asarray(X, np.float64) / lengthscales
    Y = np.asarray(Y, np.float64)
    sq = (Xs**2).sum(1)[:, None] - 2 * Xs @ Xs.T + (Xs**2).sum(1)[None, :]
    K = variance * np.exp(-0.5 * np.maximum(sq, 0.0))
    K[np.diag_indices_from(K)] += noise
    L = np.linalg.cholesky(K)
    a = solve_triangular(L, Y, lower=True)
    n, p = Y.shape
    return (0.5 * n * p * np.log(2 * np.pi) + p * np.log(np.diag(L)).sum()
            + 0.5 * (a**2).sum())


def _gpr_models(n, dtype):
    """The headline GPR (``__graft_entry__``'s flagship: D=1, RBF ℓ=0.1)
    and an ARD RBF GPR at D=8 (kin40k's width), on seeded data."""
    import gpflow_slim_tpu as gfs
    from __graft_entry__ import entry

    step, (headline,) = entry(n, dtype)
    rng = np.random.RandomState(1)
    X = rng.uniform(0, 1, (n, 8))
    w = rng.randn(8, 1)
    Y = np.sin(3 * X @ w) + 0.1 * rng.randn(n, 1)
    ard = gfs.models.GPR(X.astype(dtype), Y.astype(dtype),
                         kern=gfs.kernels.RBF(8, lengthscales=0.5, ARD=True))
    return step, {"d1": headline, "d8": ard}


def gpr_phase(n=10_000, n_test=1_000, steps=20, dtype=np.float32):
    """Exact GPR: objective vs numpy f64, value-and-grad and prediction vs
    f64 on the card, and Adam steps through ``gfs.training.fit``."""
    import gpflow_slim_tpu as gfs

    with _Phase("gpr", dtype, n=n, d=[1, 8], n_test=n_test,
                adam_steps=steps) as ph:
        with _x64(dtype):
            step, models = _gpr_models(n, dtype)
        Xt = np.random.RandomState(2).uniform(0, 1, (n_test, 8))
        for tag, m in models.items():
            xt = Xt[:, : m.X.shape[1]]
            with _x64(dtype):
                obj = float(ph.compile(lambda mm: mm.objective(), m)(m))
                vg = ph.compile(step, m)
                val, grads = ph.timed(f"{tag}/value_and_grad", vg, m)
                fitted, losses = gfs.training.fit(
                    m, num_steps=steps, learning_rate=0.01)
                mean = ph.compile(lambda mm, x: mm.predict_y(x)[0],
                                  fitted, xt)(fitted, xt)
                hyp = [np.float64(np.asarray(p)) for p in (
                    m.kern.variance.value, m.kern.lengthscales.value,
                    m.likelihood.variance.value)]
            ph.check(f"{tag}/objective_vs_numpy_f64",
                     _rel(obj, _numpy_gpr_objective(m.X, m.Y, *hyp)), 1e-5)
            m64, fitted64 = _to_f64(m), _to_f64(fitted)
            with _f64(dtype):
                val64, grads64 = jax.jit(step)(m64)
                mean64 = jax.jit(lambda mm, x: mm.predict_y(x)[0])(
                    fitted64, xt)
            ph.check(f"{tag}/value_vs_f64", _rel(val, val64), 1e-5)
            _check_grads(ph, tag, grads, grads64, 1e-3)
            losses = np.asarray(losses)
            ph.require(f"{tag}/adam", bool(np.isfinite(losses).all()
                                           and losses[-1] < losses[0]),
                       first=float(losses[0]), last=float(losses[-1]))
            ph.check(f"{tag}/predict_y_max_abs_vs_f64",
                     np.max(np.abs(np.asarray(mean, np.float64)
                                   - np.asarray(mean64))), 1e-3)


def sgpr_phase(n=10_000, m=100, dtype=np.float32):
    """Titsias SGPR, Matérn32 + Periodic: objective vs f64 on the card (the
    (M, N)-wide ``solve_lower`` of the bound)."""
    import gpflow_slim_tpu as gfs

    with _Phase("sgpr", dtype, n=n, m=m) as ph:
        rng = np.random.RandomState(0)
        X = rng.uniform(0, 1, (n, 1))
        Y = np.sin(12 * X) + 0.3 * np.sin(40 * X) + 0.1 * rng.randn(n, 1)
        Z = np.linspace(0, 1, m)[:, None]
        with _x64(dtype):
            kern = (gfs.kernels.Matern32(1, lengthscales=0.2)
                    + gfs.kernels.Periodic(1, period=0.16, lengthscales=0.5))
            model = gfs.models.SGPR(X.astype(dtype), Y.astype(dtype),
                                    kern=kern, Z=Z.astype(dtype))
            obj = ph.timed("objective", ph.compile(
                lambda mm: mm.objective(), model), model)
        with _f64(dtype):
            obj64 = jax.jit(lambda mm: mm.objective())(_to_f64(model))
        ph.check("objective_vs_f64", _rel(obj, obj64), 1e-4)


def svgp_phase(n=100_000, m=256, batch=1024, steps=50, dtype=np.float32):
    """SVGP, Bernoulli, natural gradients: the ELBO improves over ``steps``
    natgrad+Adam steps; the non-whitened KL (``batched_solve_lower``)
    matches f64 on the card."""
    import gpflow_slim_tpu as gfs

    with _Phase("svgp", dtype, n=n, m=m, batch=batch, steps=steps) as ph:
        rng = np.random.RandomState(0)
        X = rng.uniform(0, 1, (n, 1))
        Y = (np.sin(10 * X) > 0).astype(np.float64)
        Z = np.linspace(0, 1, m)[:, None]

        def build(whiten):
            return gfs.models.SVGP(
                X.astype(dtype), Y.astype(dtype),
                kern=gfs.kernels.RBF(1, lengthscales=0.2),
                likelihood=gfs.likelihoods.Bernoulli(), Z=Z.astype(dtype),
                whiten=whiten)

        with _x64(dtype):
            model = build(True)
            elbo = ph.compile(lambda mm: mm.build_likelihood(), model)
            elbo0 = float(elbo(model))
            t0 = time.perf_counter()
            fitted, losses = gfs.training.fit_svgp_natgrad(
                model, steps, jax.random.PRNGKey(0), gamma=0.1,
                batch_size=batch)
            losses = np.asarray(losses)
            ph.line["seconds"] = {"fit_svgp_natgrad_with_compile":
                                  time.perf_counter() - t0}
            elbo1 = float(elbo(fitted))
            # the fitted q in the non-whitened form (q_mu = L m, q_sqrt =
            # L S with L = chol(Kuu) in f64): the same posterior, whose KL
            # against Kuu runs the batched (P, M, M) solve
            kl_model = _unwhitened(build(False), fitted)
            kl = ph.compile(lambda mm: mm.prior_kl(), kl_model)(kl_model)
        with _f64(dtype):
            kl64 = jax.jit(lambda mm: mm.prior_kl())(_to_f64(kl_model))
        ph.require("elbo_improves", bool(
            np.isfinite(losses).all() and np.isfinite(elbo1)
            and elbo1 > elbo0), elbo_before=elbo0, elbo_after=elbo1)
        # Kuu (M=256 points on [0, 1], ℓ=0.2, the f32 jitter floor 1e-4)
        # has a condition number near 1e6, so f32 without TF32 (the CPU)
        # already lands ~6e-4 from f64 here; TF32 products would be ~1e3
        # times worse. Hence 1e-2, not the 1e-4 of the other checks.
        ph.check("kl_vs_f64", _rel(kl, kl64), 1e-2)


def _unwhitened(target, whitened):
    """``target`` (a ``whiten=False`` SVGP) holding ``whitened``'s kernel,
    inducing points and q: the same posterior in the other coordinates."""
    import gpflow_slim_tpu as gfs

    target.kern, target.feature = whitened.kern, whitened.feature

    dtype = whitened.q_mu.value.dtype
    with _f64(dtype):
        Kuu = gfs.features.Kuu(_to_f64(whitened.feature),
                               _to_f64(whitened.kern),
                               jitter=gfs.config.default_jitter())
        L = np.linalg.cholesky(np.asarray(Kuu))
    q_mu = L @ np.asarray(whitened.q_mu.value, np.float64)
    q_sqrt = L @ np.asarray(whitened.q_sqrt_array(), np.float64)
    target.q_mu = gfs.params.Param(q_mu, name="q_mu", dtype=dtype)
    target.q_sqrt = gfs.params.Param(
        q_sqrt, transform=target.q_sqrt.transform, name="q_sqrt",
        dtype=dtype)
    return target


def _nuts_gpr(n, dtype):
    """GPR with LogNormal hyperpriors: the hyperposterior NUTS samples."""
    import gpflow_slim_tpu as gfs

    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (n, 1)).astype(dtype)
    Y = (np.sin(6 * X) + 0.2 * rng.randn(n, 1)).astype(dtype)
    pos = gfs.transforms.positive
    k = gfs.kernels.RBF(1, lengthscales=0.3)
    k.variance = gfs.params.Param(1.0, transform=pos(),
                                  prior=gfs.priors.LogNormal(0.0, 1.0),
                                  name="v", dtype=dtype)
    k.lengthscales = gfs.params.Param(0.3, transform=pos(),
                                      prior=gfs.priors.LogNormal(-1.0, 1.0),
                                      name="l", dtype=dtype)
    m = gfs.models.GPR(X, Y, kern=k)
    m.likelihood.variance = gfs.params.Param(
        0.05, transform=pos(), prior=gfs.priors.LogNormal(-2.0, 1.0),
        name="n", dtype=dtype)
    return m


def nuts_phase(n=1_000, chains=8, warmup=64, samples=64, dtype=np.float32):
    """NUTS over the GPR hyperposterior, chains vmapped with shared
    adaptation: finite draws, mean acceptance in (0.3, 1)."""
    import gpflow_slim_tpu as gfs

    with _Phase("nuts", dtype, n=n, chains=chains, warmup=warmup,
                samples=samples) as ph:
        with _x64(dtype):
            lp, x0, _ = gfs.mcmc.model_logprob(_nuts_gpr(n, dtype))

            def run(x0s, keys):
                return jax.vmap(
                    lambda x, k: gfs.mcmc.nuts(
                        lp, x, k, samples, num_warmup=warmup, max_depth=8,
                        adapt_axis="chains"),
                    axis_name="chains")(x0s, keys)

            x0s = jnp.tile(x0, (chains, 1))
            keys = jax.random.split(jax.random.PRNGKey(0), chains)
            draws, info = ph.timed("sample", ph.compile(run, x0s, keys),
                                   x0s, keys)
        draws = np.asarray(draws)
        accept = float(np.mean(np.asarray(info["accept_prob"])))
        ph.require("draws_finite", bool(np.isfinite(draws).all()),
                   shape=list(draws.shape))
        ph.require("mean_accept_in_(0.3,1)", 0.3 < accept < 1.0,
                   value=accept)


# ---------------------------------------------------------------------------
# several cards
# ---------------------------------------------------------------------------

def multi_card_phases(devices, n=16_384, block_size=256, svgp_n=100_000,
                      svgp_m=256, batch=1024, nuts_n=1_000, dtype=np.float32,
                      cg_iters=100, num_probes=16, slq_steps=25):
    """``gfs.parallel`` over ``devices``, each path against the one-card
    value of the same model in this process: losses to 1e-4 relative,
    hyperparameter gradients to 1e-3 (the data-parallel SVGP gradient
    against f64, see there), NUTS draws finite. The matrix-free
    CG loss is compared with one-card GPRCG (same probes) to 1e-4, and
    with the exact objective to its SLQ estimator tolerance: 1e-2 at 16
    probes, scaled by sqrt(16 / num_probes)."""
    import gpflow_slim_tpu as gfs
    from gpflow_slim_tpu import parallel
    from __graft_entry__ import _flagship_model

    p = len(devices)
    names = sorted({d.device_kind for d in devices})
    mesh = parallel.make_mesh({"data": p}, devices=devices)
    value_and_grad = lambda f: jax.value_and_grad(f)  # noqa: E731
    objective = lambda mm: mm.objective()  # noqa: E731

    def hyper(g):
        return {"kern": g.kern, "likelihood": g.likelihood}

    def compare(ph, fn, ref_fn, model, loss_tol=1e-4):
        out = ph.timed("distributed", ph.compile(fn, model), model)
        ref = ph.timed("one_card", ph.compile(ref_fn, model), model)
        (v, g), (v_ref, g_ref) = out, ref
        ph.check("loss_vs_one_card", _rel(v, v_ref), loss_tol)
        _check_grads(ph, "hyper", hyper(g), hyper(g_ref), 1e-3)
        return float(v_ref)

    with _x64(dtype):
        m = _flagship_model(n, dtype)

        with _Phase("dist_gpr", dtype, n=n, block_size=block_size,
                    cards=p, device_kind=names) as ph:
            loss_fn = parallel.make_distributed_gpr_loss(
                m, mesh, axis="data", block_size=block_size)
            exact = compare(ph, value_and_grad(loss_fn),
                            value_and_grad(objective), m)

        with _Phase("cyclic_cholesky", dtype, n=n, block_size=block_size,
                    cards=p, device_kind=names) as ph:
            def cyclic_objective(mm):
                noise = jnp.squeeze(mm.likelihood.variance.value)
                K = mm.kern.K(mm.X) + noise * jnp.eye(n, dtype=mm.X.dtype)
                L = parallel.cyclic_cholesky(K, mesh, "data",
                                             block_size=block_size)
                half_logdet = jnp.sum(jnp.log(jnp.diagonal(L)))
                a = jax.scipy.linalg.solve_triangular(L, mm.Y, lower=True)
                return (0.5 * n * jnp.log(2 * jnp.pi) + half_logdet
                        + 0.5 * jnp.sum(a * a))

            v = ph.timed("distributed", ph.compile(cyclic_objective, m), m)
            ph.check("loss_vs_one_card", _rel(v, exact), 1e-4)

        grid = [p // 2, 2] if p % 2 == 0 else [p, 1]
        with _Phase("grid_gpr", dtype, n=n, block_size=block_size, cards=p,
                    grid=grid, device_kind=names) as ph:
            mesh2d = parallel.make_mesh(dict(zip(("rows", "cols"), grid)),
                                        devices=devices)
            grid_loss = parallel.make_grid_gpr_loss(
                m, mesh2d, ("rows", "cols"), block_size=block_size)
            compare(ph, value_and_grad(grid_loss),
                    value_and_grad(objective), m)

        with _Phase("dist_cg", dtype, n=n, cards=p, cg_iters=cg_iters,
                    num_probes=num_probes, slq_steps=slq_steps,
                    device_kind=names) as ph:
            m_cg = gfs.models.GPRCG(
                m.X, m.Y, kern=gfs.kernels.RBF(1, lengthscales=0.1),
                cg_iters=cg_iters, num_probes=num_probes,
                slq_steps=slq_steps)
            cg_loss = parallel.make_distributed_cg_loss(
                m_cg, mesh, axis="data", num_probes=num_probes,
                cg_iters=cg_iters, slq_steps=slq_steps)
            v_cg = compare(ph, value_and_grad(cg_loss),
                           value_and_grad(objective), m_cg)
            # the SLQ logdet's standard error falls as 1/sqrt(probes)
            ph.check("loss_vs_exact_objective", _rel(v_cg, exact),
                     1e-2 * np.sqrt(16 / num_probes))

        with _Phase("dp_svgp", dtype, n=svgp_n, m=svgp_m, batch=batch,
                    cards=p, device_kind=names) as ph:
            rng = np.random.RandomState(0)
            X = rng.uniform(0, 1, (svgp_n, 1)).astype(dtype)
            Y = (np.sin(10 * X) > 0).astype(dtype)
            svgp = gfs.models.SVGP(
                X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.2),
                likelihood=gfs.likelihoods.Bernoulli(),
                Z=np.linspace(0, 1, svgp_m, dtype=dtype)[:, None])
            # a fitted q: at the q=N(0, I) start the exact Z and ℓ
            # gradients of the whitened bound vanish
            svgp, _ = gfs.training.fit_svgp_natgrad(
                svgp, 20, jax.random.PRNGKey(0), gamma=0.1,
                batch_size=batch)

            def dp(mm, xb, yb):
                return parallel.dp_value_and_grad(mm, xb, yb, mesh, "data")

            def one(mm, xb, yb):
                return jax.value_and_grad(
                    lambda q: -(q.build_likelihood_batch(xb, yb)
                                + q.log_prior()))(mm)

            Xb, Yb = jnp.asarray(X[:batch]), jnp.asarray(Y[:batch])
            out = ph.timed("distributed", ph.compile(dp, svgp, Xb, Yb),
                           svgp, Xb, Yb)
            ref = ph.timed("one_card", ph.compile(one, svgp, Xb, Yb),
                           svgp, Xb, Yb)
            with _f64(dtype):
                _, g64 = jax.jit(one)(_to_f64(svgp), *_to_f64((Xb, Yb)))
            ph.check("loss_vs_one_card", _rel(out[0], ref[0]), 1e-4)
            # Kuu's condition number (~1e6 at M=256, ℓ=0.2) puts the f32
            # Z and ℓ gradients percents from f64 on one card already, and
            # summation order alone moves them by as much: so the
            # distributed gradient must be no further from f64 than three
            # times the one-card gradient is (or 1e-3, if that is more)
            for (path, a), b, c in zip(
                    jax.tree_util.tree_leaves_with_path(out[1]),
                    jax.tree_util.tree_leaves(ref[1]),
                    jax.tree_util.tree_leaves(g64)):
                ph.check(f"grad{jax.tree_util.keystr(path)}_vs_f64",
                         _rel(a, c), max(1e-3, 3 * _rel(b, c)))

        with _Phase("sample_chains", dtype, n=nuts_n, chains=p, warmup=32,
                    samples=32, cards=p, device_kind=names) as ph:
            lp, x0, _ = gfs.mcmc.model_logprob(_nuts_gpr(nuts_n, dtype))
            t0 = time.perf_counter()
            draws, _ = parallel.sample_chains(
                lp, jnp.tile(x0, (p, 1)), jax.random.PRNGKey(0),
                num_samples=32, sampler="nuts", mesh=mesh, axis="data",
                num_warmup=32, max_depth=8)
            draws = np.asarray(draws)
            ph.line["seconds"] = {"with_compile": time.perf_counter() - t0}
            ph.require("draws_finite", bool(np.isfinite(draws).all()),
                       shape=list(draws.shape))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the gfs.parallel paths on four GPUs, "
                         "each against the one-card value")
    args = ap.parse_args(argv)
    info = device_phase()
    if args.four_cards:
        devices = jax.devices()
        if len(devices) < 4:
            raise SmokeFailure(f"--four-cards needs 4 GPUs, found "
                               f"{len(devices)}")
        multi_card_phases(devices[:4])
        count = 4
    else:
        gpr_phase()
        sgpr_phase()
        svgp_phase()
        nuts_phase()
        count = info["count"]
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": count}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
