"""MCMC statistical tests: known posteriors within MC error (SURVEY §4),
plus GP hyperparameter sampling end-to-end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gpflow_slim_tpu as gfs
from gpflow_slim_tpu import mcmc


def gauss_logprob(mu, var):
    mu = jnp.asarray(mu)
    var = jnp.asarray(var)

    def lp(x):
        return jnp.sum(-0.5 * jnp.square(x - mu) / var - 0.5 * jnp.log(var))

    return lp


def test_hmc_standard_normal_moments():
    lp = gauss_logprob(jnp.array([1.0, -2.0]), jnp.array([1.0, 0.25]))
    samples, info = jax.jit(
        lambda k: mcmc.hmc(lp, jnp.zeros(2), k, num_samples=4000,
                           epsilon=0.3, lmin=5, lmax=15, burn=500)
    )(jax.random.PRNGKey(0))
    s = np.asarray(samples)
    assert float(info["accept_rate"]) > 0.6
    np.testing.assert_allclose(s.mean(0), [1.0, -2.0], atol=0.12)
    np.testing.assert_allclose(s.var(0), [1.0, 0.25], rtol=0.25)


def test_hmc_step_size_adaptation():
    lp = gauss_logprob(0.0, 1.0)
    _, info = jax.jit(
        lambda k: mcmc.hmc(lp, jnp.zeros(1), k, num_samples=500,
                           epsilon=1e-4, burn=800, adapt_step_size=True)
    )(jax.random.PRNGKey(1))
    # dual averaging should raise the tiny step size drastically
    assert float(info["epsilon"]) > 0.01
    assert 0.4 < float(info["accept_rate"]) <= 1.0


def test_nuts_correlated_gaussian():
    # 3-D correlated Gaussian; NUTS with warmup must recover moments
    rng = np.random.RandomState(0)
    A = rng.randn(3, 3)
    cov = A @ A.T + 3 * np.eye(3)
    prec = jnp.asarray(np.linalg.inv(cov))
    mu = jnp.asarray([0.5, -1.0, 2.0])

    def lp(x):
        d = x - mu
        return -0.5 * d @ prec @ d

    samples, info = jax.jit(
        lambda k: mcmc.nuts(lp, jnp.zeros(3), k, num_samples=3000,
                            num_warmup=800)
    )(jax.random.PRNGKey(2))
    s = np.asarray(samples)
    assert not np.asarray(info["diverging"]).any()
    np.testing.assert_allclose(s.mean(0), np.asarray(mu), atol=0.15)
    np.testing.assert_allclose(s.var(0), np.diag(cov), rtol=0.3)
    # mass adaptation should be in the posterior-variance ballpark
    np.testing.assert_allclose(
        np.asarray(info["inv_mass"]), np.diag(cov), rtol=0.8
    )


def test_nuts_funnel_samples_without_nan():
    # Neal's funnel is the classic NUTS stress test
    def lp(x):
        v = x[0]
        theta = x[1:]
        lp_v = -0.5 * (v / 3.0) ** 2
        lp_t = jnp.sum(-0.5 * jnp.square(theta) / jnp.exp(v) - 0.5 * v)
        return lp_v + lp_t

    # single funnel chains are seed-lottery (diagonal-mass NUTS is known to
    # stick in the neck); pool 4 chains for a stable statistical check
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    samples, info = jax.jit(
        jax.vmap(
            lambda k: mcmc.nuts(lp, jnp.zeros(4), k, num_samples=1500,
                                num_warmup=800, max_depth=8)
        )
    )(keys)
    s = np.asarray(samples).reshape(-1, 4)
    assert np.isfinite(s).all()
    # The funnel defeats ANY diagonal-metric sampler (Stan reports
    # divergences and a biased v-marginal here too): adaptation estimates
    # huge θ variances from mouth samples, making neck steps too coarse.
    # This is a smoke test of exploration, not unbiasedness: v must spread
    # (true marginal N(0,9)) and the chain must actually enter the neck.
    assert abs(s[:, 0].mean()) < 2.5
    assert s[:, 0].std() > 1.5
    assert np.quantile(s[:, 0], 0.1) < -1.0  # neck penetration


def test_vmapped_chains_and_diagnostics():
    lp = gauss_logprob(jnp.array([0.0]), jnp.array([2.0]))
    n_chains = 4
    keys = jax.random.split(jax.random.PRNGKey(4), n_chains)
    x0 = jnp.zeros((n_chains, 1))
    samples, info = jax.jit(
        jax.vmap(lambda x, k: mcmc.nuts(lp, x, k, num_samples=1000,
                                        num_warmup=400))
    )(x0, keys)
    s = np.asarray(samples)  # (C, N, 1)
    rhat = mcmc.potential_scale_reduction(s)
    ess = mcmc.effective_sample_size(s)
    assert rhat[0] < 1.05
    assert ess[0] > 400
    np.testing.assert_allclose(s.reshape(-1).var(), 2.0, rtol=0.25)


def test_gpr_hyperparameter_posterior_nuts():
    # BASELINE config #4 (scaled down): NUTS over GPR kernel hyperparams
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (40, 1))
    Y = np.sin(6 * X) + 0.2 * rng.randn(40, 1)
    k = gfs.kernels.RBF(1, lengthscales=0.3)
    k.variance = gfs.params.Param(
        1.0, transform=gfs.transforms.positive(),
        prior=gfs.priors.LogNormal(0.0, 1.0), name="variance")
    k.lengthscales = gfs.params.Param(
        0.3, transform=gfs.transforms.positive(),
        prior=gfs.priors.LogNormal(-1.0, 1.0), name="lengthscales")
    m = gfs.models.GPR(X, Y, kern=k)
    m.likelihood.variance = gfs.params.Param(
        0.05, transform=gfs.transforms.positive(),
        prior=gfs.priors.LogNormal(-2.0, 1.0), name="noise")

    lp, x0, unpack = mcmc.model_logprob(m)
    samples, info = jax.jit(
        lambda key: mcmc.nuts(lp, x0, key, num_samples=400, num_warmup=300)
    )(jax.random.PRNGKey(5))
    s = np.asarray(samples)
    assert np.isfinite(s).all()
    assert not np.asarray(info["diverging"]).any()
    # constrained noise posterior should concentrate near the true 0.04
    noise_samples = np.asarray(
        jax.vmap(lambda v: unpack(v).likelihood.variance.value)(samples)
    )
    med = np.median(noise_samples)
    assert 0.01 < med < 0.15


def test_gpmc_binary_classification_smoke():
    # non-conjugate GPMC + Bernoulli, HMC over latents+hypers
    rng = np.random.RandomState(1)
    X = rng.uniform(-1, 1, (25, 1))
    Y = (np.sin(3 * X) > 0).astype(float)
    m = gfs.models.GPMC(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.5),
                        likelihood=gfs.likelihoods.Bernoulli())
    lp, x0, unpack = mcmc.model_logprob(m)
    samples, info = jax.jit(
        lambda key: mcmc.hmc(lp, x0, key, num_samples=300, epsilon=0.03,
                             lmin=5, lmax=15, burn=200)
    )(jax.random.PRNGKey(6))
    assert np.isfinite(np.asarray(samples)).all()
    assert float(info["accept_rate"]) > 0.3
    # posterior predictive at train points should correlate with labels
    m_post = unpack(jnp.asarray(np.asarray(samples)[-1]))
    pf, _ = m_post.predict_f(X)
    corr = np.corrcoef(np.asarray(pf)[:, 0], 2 * Y[:, 0] - 1)[0, 1]
    assert corr > 0.5


def test_hmc_and_nuts_agree_on_gpr_hyperposterior():
    # the reference's sampler is leapfrog HMC; our HMC matches its
    # semantics, so HMC↔NUTS agreement on the same GP hyperposterior is the
    # "posterior moments within MC error" parity check (SURVEY §6)
    rng = np.random.RandomState(2)
    X = rng.uniform(0, 1, (30, 1))
    Y = np.sin(5 * X) + 0.15 * rng.randn(30, 1)
    k = gfs.kernels.RBF(1, lengthscales=0.3)
    k.variance = gfs.params.Param(
        1.0, transform=gfs.transforms.positive(),
        prior=gfs.priors.LogNormal(0.0, 1.0), name="v")
    k.lengthscales = gfs.params.Param(
        0.3, transform=gfs.transforms.positive(),
        prior=gfs.priors.LogNormal(-1.0, 0.7), name="l")
    m = gfs.models.GPR(X, Y, kern=k)
    m.likelihood.variance = gfs.params.Param(
        0.05, transform=gfs.transforms.positive(),
        prior=gfs.priors.LogNormal(-2.5, 0.7), name="n")
    lp, x0, unpack = mcmc.model_logprob(m)

    s_nuts, _ = jax.jit(
        lambda key: mcmc.nuts(lp, x0, key, num_samples=1500, num_warmup=500)
    )(jax.random.PRNGKey(0))
    s_hmc, info = jax.jit(
        lambda key: mcmc.hmc(lp, x0, key, num_samples=3000, epsilon=0.05,
                             lmin=10, lmax=25, burn=500,
                             adapt_step_size=True)
    )(jax.random.PRNGKey(1))
    assert float(info["accept_rate"]) > 0.5

    a, b = np.asarray(s_nuts), np.asarray(s_hmc)
    ess_a = gfs.mcmc.effective_sample_size(a[None])
    ess_b = gfs.mcmc.effective_sample_size(b[None])
    # compare unconstrained means within combined MC error (3 sigma)
    for d in range(a.shape[1]):
        se = np.sqrt(a[:, d].var() / max(ess_a[d], 4)
                     + b[:, d].var() / max(ess_b[d], 4))
        assert abs(a[:, d].mean() - b[:, d].mean()) < 4 * se + 0.05, (
            d, a[:, d].mean(), b[:, d].mean(), se)


def test_nuts_checkpoint_resume_bit_identical(tmp_path):
    """The documented MCMC recovery story: persist (position, step_size,
    inv_mass) with utils.checkpoint, reload, and continue sampling —
    bit-identical to continuing without the save/load round trip."""
    import jax
    import jax.numpy as jnp

    from gpflow_slim_tpu.utils import load_checkpoint, save_checkpoint

    rng2 = np.random.RandomState(0)
    X = rng2.uniform(0, 1, (40, 1))
    Y = np.sin(6 * X) + 0.1 * rng2.randn(40, 1)
    m = gfs.models.GPR(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.3))
    lp, x0, _ = gfs.mcmc.model_logprob(m)

    # warmup once
    s0, info0 = gfs.mcmc.nuts(lp, x0, jax.random.PRNGKey(0), 4,
                              num_warmup=32, max_depth=6)
    state = {
        "z": s0[-1],
        "step_size": info0["step_size"],
        "inv_mass": info0["inv_mass"],
    }

    # save + reload through the checkpoint layer
    path = save_checkpoint(str(tmp_path / "mcmc"), state, step=1)
    restored = load_checkpoint(path, state)

    def continue_sampling(st):
        return gfs.mcmc.nuts(
            lp, st["z"], jax.random.PRNGKey(7), 8, num_warmup=0,
            step_size=st["step_size"], inv_mass=st["inv_mass"],
            max_depth=6,
        )[0]

    a = np.asarray(continue_sampling(state))
    b = np.asarray(continue_sampling(restored))
    np.testing.assert_array_equal(a, b)
    assert np.all(np.isfinite(a))


def test_windowed_warmup_chunking_bit_identical():
    # nuts_warmup_window carries the full (da, welford, inv_mass) state,
    # so splitting a window's key sequence into chunks must be EXACTLY
    # the same computation as one call over all keys — this is what lets
    # the benchmark drive convergence-grade warmups as short device
    # programs (the remote worker kills monolithic ones)
    import jax
    import jax.numpy as jnp

    def lp(x):
        return -0.5 * jnp.sum(x**2) - 0.1 * x[0] * x[1]

    x0 = jnp.asarray([0.3, -0.2])
    da0, w0, im0 = gfs.mcmc.nuts_warmup_init(x0, step_size=0.2)
    keys = jax.random.split(jax.random.PRNGKey(3), 12)

    z_a, da_a, w_a, im_a = gfs.mcmc.nuts_warmup_window(
        lp, x0, keys, da0, w0, im0, max_depth=6)

    z_b, da_b, w_b, im_b = x0, da0, w0, im0
    for lo, hi in ((0, 5), (5, 9), (9, 12)):
        z_b, da_b, w_b, im_b = gfs.mcmc.nuts_warmup_window(
            lp, z_b, keys[lo:hi], da_b, w_b, im_b, max_depth=6)

    np.testing.assert_array_equal(np.asarray(z_a), np.asarray(z_b))
    np.testing.assert_array_equal(
        np.asarray(w_a.m2), np.asarray(w_b.m2))
    np.testing.assert_array_equal(
        np.asarray(da_a.log_step), np.asarray(da_b.log_step))

    # closing a slow window produces a usable metric + restarted da
    da_c, im_c = gfs.mcmc.nuts_slow_window_close(da_a, w_a)
    assert np.all(np.isfinite(np.asarray(im_c))) and im_c.shape == (2,)
    assert np.isfinite(float(da_c.log_step))


def test_nan_logprob_treated_as_divergence():
    # An f32 posterior can return NaN logp/grad at extreme proposals
    # (non-PD Cholesky). `delta < -MAX` is False for NaN, so without the
    # NaN-robust guard the leaf leaked NaN into sum_accept -> dual
    # averaging -> step size for the rest of warmup (observed in f32:
    # eps=NaN, frozen chains, R-hat ~ 1e6). NaN must be flagged as a
    # divergence and excluded from the adaptation statistics.
    import jax
    import jax.numpy as jnp

    def lp(x):
        # standard normal inside |x0| < 2, NaN outside — a jump of ~2
        # sigma regions, reachable by warmup's early large step sizes
        ok = jnp.abs(x[0]) < 2.0
        base = -0.5 * jnp.sum(x**2)
        return jnp.where(ok, base, jnp.nan)

    x0 = jnp.zeros((2,), jnp.float32)
    da0, w0, im0 = gfs.mcmc.nuts_warmup_init(x0, step_size=1.5)
    keys = jax.random.split(jax.random.PRNGKey(0), 60)
    z, da, w, im = gfs.mcmc.nuts_warmup_window(
        lp, x0, keys, da0, w0, im0, max_depth=6)
    assert np.isfinite(float(da.log_step)), "NaN leaked into dual averaging"
    assert np.isfinite(float(da.log_step_avg))
    assert np.all(np.isfinite(np.asarray(z)))

    # sampling with a fixed step size across the NaN wall: proposals into
    # the wall are divergences, retained samples stay finite and inside
    samples, info = gfs.mcmc.nuts(
        lp, x0, jax.random.PRNGKey(1), 64, num_warmup=0,
        step_size=0.5, max_depth=6)
    s = np.asarray(samples)
    assert np.all(np.isfinite(s))
    assert np.all(np.abs(s[:, 0]) < 2.0)

    # HMC: the accept statistic must also stay finite through NaN walls
    samples_h, info_h = gfs.mcmc.hmc(
        lp, x0, jax.random.PRNGKey(2), 32, burn=20,
        epsilon=0.5, lmin=2, lmax=5, adapt_step_size=True)
    assert np.all(np.isfinite(np.asarray(samples_h)))
    assert np.isfinite(float(np.asarray(info_h["accept_rate"])))
