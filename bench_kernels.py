"""Per-kernel roofline benchmark (BASELINE: "measure vertical-stencil and
tridiagonal kernels at speed-of-light per chip").

Measures achievable device-memory bandwidth with a copy kernel, then times
the hot kernels standalone on the GPU and reports each one's effective
bandwidth and fraction of speed-of-light (minimum bytes / achieved copy
bandwidth). Prints one JSON line per kernel. Needs a GPU:

    python bench_kernels.py
"""
from __future__ import annotations

import json
import time

import numpy as np

NZ, CELLS = 30, 56951
ITERS = 300


def timeit(fn, arg, iters=ITERS):
    import jax

    @jax.jit
    def many(v):
        def body(s, _):
            return fn(s), None

        s, _ = jax.lax.scan(body, v, None, length=iters)
        return s

    jax.block_until_ready(many(arg))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(many(arg))
        times.append((time.perf_counter() - t0) / iters)
    return float(np.median(times))


def report(name, t_s, bytes_moved, bw_peak):
    bw = bytes_moved / t_s
    print(json.dumps({
        "kernel": name, "time_us": round(t_s * 1e6, 1),
        "effective_GBps": round(bw / 1e9, 1),
        "pct_speed_of_light": round(100.0 * bw / bw_peak, 1) if bw_peak else None,
        "min_bytes_MB": round(bytes_moved / 1e6, 2),
    }))
    return bw


def main():
    import jax
    import jax.numpy as jnp

    from terrarium_tpu.utils.compile_cache import configure_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench_kernels.py needs a GPU")
    configure_compile_cache()
    from terrarium_tpu.ops.tridiag import tridiag_solve, tridiag_solve_pcr
    from terrarium_tpu.ops.vertical_ops import (cummin_z, cumsum_z, div_faces,
                                                grad_faces, interp_faces_mid)

    rng = np.random.default_rng(0)
    F = jnp.float32
    big = jnp.asarray(rng.normal(size=(8 * NZ, CELLS)), F)  # ~55 MB
    x = jnp.asarray(rng.normal(size=(NZ, CELLS)), F)
    sat = jnp.asarray(rng.uniform(0.0, 1.2, (NZ, CELLS)), F)
    dzc = jnp.asarray(np.exp(rng.uniform(-2, 0, (NZ, 1))), F)
    dzf = jnp.asarray(np.exp(rng.uniform(-2, 0, (NZ + 1, 1))), F)

    fsz = 4  # f32

    # 1. achievable device-memory bandwidth: copy-scale (read + write)
    t = timeit(lambda v: v * 1.0000001 + 1e-12, big)
    bw_peak = report("copy_scale", t, 2 * big.size * fsz, None)
    print(json.dumps({"copy_GBps": round(bw_peak / 1e9, 1)}))

    # 2. heat-conduction vertical stencil: q = -kappa_f * dT/dz; dU/dt = -div q
    #    minimum traffic: read T, read kappa, write dUdt  (3 arrays)
    kappa = jnp.asarray(rng.uniform(0.5, 3.0, (NZ, CELLS)), F)

    def heat_stencil(T):
        kf = interp_faces_mid(kappa)
        q = -kf * grad_faces(T, dzf)
        return T + 1e-9 * div_faces(q, dzc)  # feedback keeps the loop live

    t = timeit(heat_stencil, x)
    report("heat_vertical_stencil", t, 3 * x.size * fsz, bw_peak)

    # 3. Richards vertical stencil: Darcy flux with flow-direction-min K
    #    minimum traffic: read psi, read K faces, write dtheta (3 arrays)
    from terrarium_tpu.ops.vertical_ops import shift_z

    Kf = jnp.asarray(rng.uniform(1e-7, 1e-5, (NZ + 1, CELLS)), F)

    def richards_stencil(psi):
        grad = grad_faces(psi, dzf)
        K_eff = jnp.where(grad < 0.0,
                          jnp.minimum(shift_z(Kf, 1, jnp.inf), Kf),
                          jnp.minimum(Kf, shift_z(Kf, -1, jnp.inf)))
        q = -K_eff * grad
        return psi + 1e-3 * div_faces(q, dzc)

    t = timeit(richards_stencil, x)
    report("richards_vertical_stencil", t, 3 * x.size * fsz, bw_peak)

    # 4. saturation adjustment (closure hot path): read sat, write sat (2).
    #    All three production lowerings (hydrology.ADJUST_IMPL).
    from terrarium_tpu.processes.soil import hydrology as H

    class _G:  # minimal grid facade for adjust_saturation_profile
        dz = dzc
        z_faces = jnp.concatenate([jnp.zeros((1, 1), F),
                                   jnp.cumsum(dzc, axis=0)], axis=0)

    class _S(dict):
        def __contains__(self, k):
            return False

        @property
        def saturation_water_ice(self):
            return self["sat"]

        def update(self, updates):
            return self["sat_setter"](updates["saturation_water_ice"])

    hyd = H.SoilHydrology()

    def make_adjust(impl):
        def adjust(s):
            H.ADJUST_IMPL = impl
            st = _S(sat=s, sat_setter=lambda v: v)
            return hyd.adjust_saturation_profile(st, _G) * 0.999 + 1e-4
        return adjust

    for impl in ("twopass", "telescoped", "fused"):
        t = timeit(make_adjust(impl), sat)
        report(f"saturation_adjustment_{impl}", t, 2 * sat.size * fsz, bw_peak)
    H.ADJUST_IMPL = "fused"

    # 5. batched tridiagonal solve: read a,b,c,d write x (5 arrays)
    a = jnp.asarray(rng.uniform(-1, 0, (NZ, CELLS)), F)
    c = jnp.asarray(rng.uniform(-1, 0, (NZ, CELLS)), F)
    b = jnp.asarray(2.5 + rng.uniform(0, 1, (NZ, CELLS)), F)

    for name, solver in (("tridiag_thomas_scan", tridiag_solve),
                         ("tridiag_pcr", tridiag_solve_pcr)):
        t = timeit(lambda d, s=solver: s(a, b, c, d) * 0.999 + 1e-6, x)
        report(name, t, 5 * x.size * fsz, bw_peak)


if __name__ == "__main__":
    main()
