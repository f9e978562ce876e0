"""gpflow_slim_tpu — a Gaussian-process inference engine in JAX.

A from-scratch JAX/XLA redesign with the capabilities of
ssydasheng/GPflow-Slim (see SURVEY.md): kernels, exact GPR, sparse
SGPR/FITC, SVGP with natural gradients, VGP, GPMC/SGPMC, HMC/NUTS — models
are pytrees, methods are pure functions, and everything composes with
jit / grad / vmap / shard_map.

Canonical usage (compare SURVEY §1's reference program)::

    import gpflow_slim_tpu as gfs
    kernel = gfs.kernels.RBF(1)
    m = gfs.models.GPR(X, Y, kern=kernel)
    m, losses = gfs.training.fit(m, num_steps=1000, learning_rate=1e-2)
    mean, var = m.predict_y(Xnew)
"""

from . import (
    conditionals,
    config,
    densities,
    features,
    io,
    kernels,
    kullback_leiblers,
    likelihoods,
    mcmc,
    mean_functions,
    models,
    ops,
    parallel,
    params,
    priors,
    quadrature,
    training,
    transforms,
    utils,
)
from .config import enable_x64, settings, temp_settings
from .params import Module, Param

__version__ = "0.1.0"
