"""XLA's own time on the GPU for the dense linear algebra of the hot path.

Times, at the shapes the exact-GP and SVGP steps use:

  * potrf + thin solve, N=10,000 f32 (the GPR objective's core);
  * the stationary (RBF) Gram, N=10,000, D=1 and D=8;
  * a wide TRSM, L 256×256 and B 256×1024 (the SVGP conditional's solve);
  * the batched (1, 256, 256) solve of the non-whitened Gaussian KL;

and the steps they sit in: the GPR objective and its value-and-grad at
N=10,000 (D=1 and D=8) and one SVGP natural-gradient step (N=100,000,
M=256, B=1,024). Each operation is warmed up, then run ``--reps`` times
back to back (``REPS``); its device time is the busy time of the GPU
planes of a ``jax.profiler`` trace divided by ``REPS``, and its host time
is the wall time to ``block_until_ready`` divided by ``REPS``. The roofline
share is the larger of flops over the f32 peak and bytes over the memory
bandwidth, divided by the device time.

    python benchmarks/bench_xla_linalg.py

Prints one JSON line per operation, then a summary line. GPU only.
"""

import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 20

# Published dense peaks without tensor cores (NVIDIA H100 data sheet, SXM
# part, at its 700 W limit), keyed by ``device_kind``.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "bytes": 3.35e12},
}


def _busy_ns(trace_dir):
    """Union of event intervals on the trace's GPU planes, in ns."""
    from jax.profiler import ProfileData

    (path,) = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                        recursive=True)
    spans = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            spans += [(e.start_ns, e.end_ns) for e in line.events]
    if not spans:
        raise RuntimeError("the trace holds no GPU events")
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def measure(fn, args, reps):
    """(host seconds, device seconds) per call of the jitted ``fn``."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    host = (time.perf_counter() - t0) / reps
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                out = fn(*args)
            jax.block_until_ready(out)
        device = _busy_ns(d) * 1e-9 / reps
    return host, device


def main(N=10_000):
    import jax
    import jax.numpy as jnp

    import gpflow_slim_tpu as gfs
    from __graft_entry__ import _flagship_model
    from gpflow_slim_tpu.ops import linalg

    gfs.utils.enable_compile_cache()
    info = gfs.utils.require_gpu()
    print(json.dumps({"device": info}), flush=True)
    peak = PEAKS[info["kind"]]

    M, B = 256, 1024
    rng = np.random.RandomState(0)
    f32 = jnp.float32
    gpr1 = _flagship_model(N)
    X8 = rng.uniform(0, 1, (N, 8)).astype(np.float32)
    gpr8 = gfs.models.GPR(
        X8, np.sin(X8.sum(1, keepdims=True)),
        kern=gfs.kernels.RBF(8, lengthscales=0.5, ARD=True))
    K = jax.jit(lambda m: m.kern.K(m.X) + jnp.eye(N, dtype=f32))(gpr1)
    L256 = jnp.asarray(np.tril(rng.randn(M, M)) / np.sqrt(M) + 2 * np.eye(M),
                       f32)
    Bwide = jnp.asarray(rng.randn(M, B), f32)
    Bsq = jnp.asarray(rng.randn(1, M, M), f32)

    results = {}

    def op(name, fn, fargs, flops=None, nbytes=None):
        host, dev = measure(jax.jit(fn), fargs, REPS)
        row = {"op": name, "host_s": host, "device_s": dev}
        if flops is not None:
            t_min = max(flops / peak["f32_flops"], nbytes / peak["bytes"])
            row.update(flops=flops, bytes=nbytes,
                       bound="compute" if flops / peak["f32_flops"]
                       >= nbytes / peak["bytes"] else "memory",
                       roofline_share=t_min / dev)
        results[name] = row
        print(json.dumps(row), flush=True)

    op(f"potrf_thin_solve_n{N}", lambda K, y: linalg.chol_logdet_quad(K, y),
       (K, gpr1.Y), flops=N**3 / 3 + N**2, nbytes=4 * 3 * N**2)
    for tag, m in (("d1", gpr1), ("d8", gpr8)):
        D = m.X.shape[1]
        op(f"gram_rbf_n{N}_{tag}", lambda mm: mm.kern.K(mm.X), (m,),
           flops=2 * N**2 * D + 8 * N**2, nbytes=4 * (N**2 + 2 * N * D))
        op(f"gpr_objective_n{N}_{tag}", lambda mm: mm.objective(), (m,))
        op(f"gpr_value_and_grad_n{N}_{tag}",
           jax.value_and_grad(lambda mm: mm.objective()), (m,))
    op("trsm_wide_256x1024", linalg.solve_lower, (L256, Bwide),
       flops=M**2 * B, nbytes=4 * (M**2 + 2 * M * B))
    op("trsm_batched_1x256x256", linalg.batched_solve_lower,
       (L256[None], Bsq), flops=M**3, nbytes=4 * 3 * M**2)

    # one SVGP natgrad step: a scan of `steps`, timed after its compile
    Xs = rng.uniform(0, 1, (100_000, 1)).astype(np.float32)
    svgp = gfs.models.SVGP(
        Xs, (np.sin(10 * Xs) > 0).astype(np.float32),
        kern=gfs.kernels.RBF(1, lengthscales=0.2),
        likelihood=gfs.likelihoods.Bernoulli(),
        Z=np.linspace(0, 1, M, dtype=np.float32)[:, None])
    steps = 50
    key = jax.random.PRNGKey(0)
    fit = lambda m: gfs.training.fit_svgp_natgrad(  # noqa: E731
        m, steps, key, gamma=0.1, batch_size=B)[1]
    jax.block_until_ready(fit(svgp))
    t0 = time.perf_counter()
    jax.block_until_ready(fit(svgp))
    results["svgp_natgrad_step"] = {
        "op": "svgp_natgrad_step", "host_s": (time.perf_counter() - t0)
        / steps}
    print(json.dumps(results["svgp_natgrad_step"]), flush=True)

    def share(part, whole):
        return results[part]["device_s"] / results[whole]["device_s"]

    svgp_step = results["svgp_natgrad_step"]["host_s"]
    print(json.dumps({"summary": {
        "potrf_thin_solve_share_of_gpr_objective_d1":
            share(f"potrf_thin_solve_n{N}", f"gpr_objective_n{N}_d1"),
        "gram_share_of_gpr_objective_d1":
            share(f"gram_rbf_n{N}_d1", f"gpr_objective_n{N}_d1"),
        "gram_share_of_gpr_objective_d8":
            share(f"gram_rbf_n{N}_d8", f"gpr_objective_n{N}_d8"),
        "trsm_wide_share_of_svgp_step":
            results["trsm_wide_256x1024"]["device_s"] / svgp_step,
        "trsm_batched_share_of_svgp_step":
            results["trsm_batched_1x256x256"]["device_s"] / svgp_step,
    }}), flush=True)


if __name__ == "__main__":
    main()
