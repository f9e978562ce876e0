"""Exact GPR on a 1-D sinusoid — the canonical reference program
(SURVEY §1), rebuilt on this package's API.

Run: python examples/01_gpr_regression.py
"""

import numpy as np

import os

FAST = os.environ.get("GFS_EXAMPLE_FAST") == "1"  # tiny sizes for tests/test_examples.py smoke runs

import gpflow_slim_tpu as gfs

rng = np.random.RandomState(42)
X = rng.uniform(0, 1, (200, 1))
Y = np.sin(12 * X) + 0.66 * np.cos(25 * X) + rng.randn(200, 1) * 0.1

kernel = gfs.kernels.RBF(1, lengthscales=0.1) + gfs.kernels.White(1, variance=1e-4)
m = gfs.models.GPR(X, Y, kern=kernel)
print("initial -log p(Y):", float(m.objective()))

m, losses = gfs.training.fit(m, num_steps=10 if FAST else 1000, learning_rate=0.05)
print("final   -log p(Y):", float(m.objective()))

Xt = np.linspace(0, 1, 100)[:, None]
mean, var = m.predict_y(Xt)
truth = np.sin(12 * Xt) + 0.66 * np.cos(25 * Xt)
rmse = float(np.sqrt(np.mean((np.asarray(mean) - truth) ** 2)))
print(f"posterior-mean RMSE vs noiseless truth: {rmse:.4f}")
