"""Smoke test of the main simulation path on NVIDIA GPUs.

Drives the system through the entry points a user calls —
``tt.initialize`` / ``Simulation.run`` and
``timesteppers.autodiff.make_rollout_fn`` — at the N145 protocol's full width:
56,951 columns, the land-cell count of the ERA5-land N145 mask, as a
``ColumnGrid`` (the column physics is laterally independent, and the mask
itself is not in the repository). Each phase checks finiteness and compares
with the same program run on the CPU backend of this process, or with the
stored float64 goldens.

Comparisons with the CPU are made twice (see `compare_columns`): along
the whole trajectory, and step by step ("replay": one GPU step and one CPU
step from the same CPU state at points along the CPU trajectory). Both
allow ``F32_RTOL`` of each field's scale plus ``ENVELOPE`` times the CPU's
own response to a one-ulp perturbation of the same input, measured in the
same run: the coupled land configuration is chaotic at dt=600 s (a one-ulp
change of the initial saturation changes the CPU's own end state by O(1)),
and its trajectories cannot agree more closely than that on any backend.

    python chip_smoke.py               # phases 1-7 on one card
    python chip_smoke.py --four-cards  # the cells-sharded path on four cards

Every phase prints one JSON line with its name, wall time and numbers. A
failed phase makes the script exit nonzero without the final line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
There is no CPU fallback: without a GPU the script exits nonzero at once.

Run it as the only process on its cards: a JAX process reserves most of a
card's memory when it first uses it. The compile cache follows
``terrarium_tpu.utils.compile_cache`` (``JAX_COMPILATION_CACHE_DIR`` when set,
else ``<checkout>/.jax_cache``).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN_DIR = ROOT / "tests" / "goldens"

#: ERA5-land N145 land cells (the bench.py protocol's width).
N145_CELLS = 56951
#: The reference sweep's top size: unmasked Full Gaussian grid, nlat_half=512
#: (1,024 rings x 2,048 longitudes).
SWEEP_TOP_CELLS = 2 * 512 * 4 * 512
#: Float32 comparisons: |gpu - cpu| <= F32_RTOL * max |cpu| per field (plus
#: the envelope below). XLA's CPU and GPU float32 exp/log/pow differ by a few
#: ulps (eps = 1.2e-7); in a contracting trajectory such per-step
#: differences accumulate at most linearly over <= 1,440 steps (<= 1.7e-4 of
#: scale), so the bound leaves a margin of about 6. Separately compiled
#: programs on one kind of card (sharded vs single) differ the same way.
F32_RTOL = 1e-3
#: Where the dynamics amplify rounding, the allowance grows by ENVELOPE times
#: the CPU's own deviation after a one-ulp perturbation of every prognostic
#: input: the backends differ by a few ulps per operation, not by one.
ENVELOPE = 8
#: States along the CPU trajectory at which one step is replayed on both.
REPLAY_POINTS = 4
#: Ring-halo diffusion, float64: the same gathered values and association;
#: only multiply-add contraction may differ (about 1 ulp of 1e-16).
RING_RTOL = 1e-12
F32_MATMULS = ("float32 dots (vertical_ops.cumsum_z, _shift_min_stage_dot) "
               "request Precision.HIGHEST: no TF32")
#: Set before JAX starts, for the CPU reference: XLA's CPU fusion emitters
#: miscompile parts of the coupled LandModel step in jaxlib 0.9.0 (see
#: tests/conftest.py). The GPU ignores CPU flags.
CPU_XLA_FLAG = "--xla_cpu_use_fusion_emitters=false"


def _import_package():
    """``import terrarium_tpu`` from this checkout, and only from it."""
    import terrarium_tpu as tt

    if pathlib.Path(tt.__file__).resolve().parent.parent != ROOT:
        raise ImportError(f"terrarium_tpu imported from {tt.__file__}, "
                          f"not from the checkout at {ROOT}")
    return tt


# -- comparison -------------------------------------------------------------
def compare_columns(got, ref, ref_pert=None, names=None):
    """Column-by-column comparison of a state with its reference.

    ``ref_pert`` is the reference computed from the same input perturbed by
    one ulp (None: no envelope). A column of a field is bad when its largest
    deviation exceeds ``F32_RTOL * max |ref| + ENVELOPE * e``, with ``e`` the
    field's largest deviation of ``ref_pert`` from ``ref`` (per field, not
    per column: where the dynamics are chaotic, which columns a perturbation
    moves most is itself a matter of rounding). Returns
    ``{name: {max_abs, max_rel, envelope_rel, bad_columns, worst_column}}``
    (``*_rel`` relative to ``max |ref|``); raises ``AssertionError`` on a
    bad column or a non-finite value."""
    names = sorted(ref.prognostic) if names is None else names
    out, failed = {}, []
    for name in names:
        a = np.asarray(got[name], np.float64)
        b = np.asarray(ref[name], np.float64)
        if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b))):
            failed.append(f"{name}: non-finite")
            continue
        cells = a.shape[-1]
        col = np.abs(a - b).reshape(-1, cells).max(axis=0)
        env = 0.0 if ref_pert is None else float(
            np.abs(np.asarray(ref_pert[name], np.float64) - b).max())
        scale = float(np.max(np.abs(b))) or 1.0
        bad = int(np.sum(col > F32_RTOL * scale + ENVELOPE * env))
        out[name] = {"max_abs": float(col.max()),
                     "max_rel": float(col.max() / scale),
                     "envelope_rel": env / scale,
                     "bad_columns": bad,
                     "worst_column": int(np.argmax(col))}
        if bad:
            failed.append(f"{name}: {bad} columns beyond tolerance")
    if failed:
        raise AssertionError("; ".join(failed) + f" | {out}")
    return out


def one_ulp_up(state):
    """``state`` with every floating prognostic leaf moved up by one ulp."""
    prog = {k: np.asarray(v) for k, v in state.prognostic.items()}
    return state.update({k: np.nextafter(v, np.inf).astype(v.dtype)
                         for k, v in prog.items()
                         if np.issubdtype(v.dtype, np.floating)})


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def _on_cpu(sim):
    """Move ``sim``'s state and sources to the CPU device."""
    import jax

    cpu = _cpu()
    sim.state = jax.device_put(sim.state, cpu)
    sim.input_sources = jax.device_put(sim.input_sources, cpu)
    return sim


def compare_with_cpu(build, steps, dt, names=None, points=REPLAY_POINTS):
    """Run ``build()`` for ``steps`` through ``Simulation.run`` on the GPU and
    on the CPU, the latter also from a one-ulp-perturbed start; replay one
    step on both devices at ``points`` states along the CPU trajectory; and
    compare (`compare_columns`). Returns ``(gpu_sim, gpu_wall_s, record)``.

    Everything on the CPU runs under ``jit`` (the rollouts, the auxiliary
    refresh and the replayed steps): `vertical_ops.pad_z` picks its lowering
    from the default backend, so in a GPU process the CPU device gets the
    `lax.pad` form, whose eager thunk corrupts the CPU heap."""
    import jax

    gpu, cpu = jax.devices()[0], _cpu()
    sim, ref, pert = build(), _on_cpu(build()), _on_cpu(build())
    pert.state = jax.device_put(one_ulp_up(pert.state), cpu)
    model, ts, ctx = ref.model, ref.timestepper, ref.ctx
    step = jax.jit(lambda s, srcs: ts.step(model, s, ctx, srcs, dt))
    src_gpu = jax.device_put(ref.input_sources, gpu)
    # all three runs advance in the same chunks, so that they run the same
    # executables (rollouts of different lengths differ by rounding)
    replay, done, wall = {}, 0, 0.0
    for k in range(points):
        n = steps * (k + 1) // points - done
        _, t = _timed(lambda: sim.run(steps=n, dt=dt).state)
        wall += t
        with jax.default_device(cpu):
            s = ref.state
            g = step(jax.device_put(s, gpu), src_gpu)
            c = step(s, ref.input_sources)
            cp = step(jax.device_put(one_ulp_up(s), cpu), ref.input_sources)
            try:
                replay[done] = compare_columns(g, c, cp, names)
            except AssertionError as e:
                raise AssertionError(f"replayed step {done}: {e}") from None
            ref.run(steps=n, dt=dt)
            pert.run(steps=n, dt=dt)
            jax.block_until_ready((ref.state, pert.state))
        done += n
    trajectory = compare_columns(sim.state, ref.state, pert.state, names)
    worst = {name: {key: max(r[name][key] for r in replay.values())
                    for key in ("max_rel", "envelope_rel")}
             for name in trajectory}
    return sim, wall, {"rtol": F32_RTOL, "envelope_factor": ENVELOPE,
                       "trajectory_vs_cpu": trajectory,
                       "replay_steps": sorted(replay),
                       "replay_worst_vs_cpu": worst}


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


# -- model builders ---------------------------------------------------------
def heat_richards_sim(tt, cells, stepper=None, nz=30):
    """The bench.py protocol: SoilModel with heat + Richards (van Genuchten
    alpha=2, n=2), Nz=30 ExponentialSpacing, float32, diurnal surface
    temperature; the initial state varies by column."""
    import jax.numpy as jnp

    grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz),
                            nf=np.float32)
    hydrology = tt.SoilHydrology(
        vertical_flow=tt.RichardsEq(),
        hydraulic_properties=tt.ConstantSoilHydraulics(
            swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
            unsat_hydraulic_cond=tt.UnsatKVanGenuchten()))
    model = tt.SoilModel(grid=grid,
                         soil=tt.SoilEnergyWaterCarbon(hydrology=hydrology))
    return tt.initialize(
        model, stepper if stepper is not None else tt.ForwardEuler(dt=60.0),
        initializers={
            "temperature": lambda x, z: 2.0 * np.sin(2 * np.pi * x) - 0.05 * z,
            "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.6 - 0.05 * z),
        },
        boundary_conditions=tt.PrescribedSurfaceTemperature(
            lambda t: 5.0 * jnp.sin(2 * jnp.pi * t / 86400.0)))


def land_coupled_sim(tt, cells, nz=20, hours=25):
    """LandModel in the fully consistent vegetated composition
    (tests/test_parity_robustness.py `_consistent_vegetated`) under hourly,
    column-varying air temperature and shortwave forcing."""
    grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz),
                            nf=np.float32)
    soil = tt.SoilEnergyWaterCarbon(
        strat=tt.HomogeneousStratigraphy(texture=tt.SoilTexture.preset("loam")),
        hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq()))
    model = tt.LandModel(
        grid=grid, soil=soil,
        vegetation=tt.VegetationCarbon.consistent_units(),
        atmosphere=tt.PrescribedAtmosphere(
            aerodynamics=tt.MoninObukhovAerodynamics()),
        surface_energy_balance=tt.SurfaceEnergyBalance.consistent(),
        surface_hydrology=tt.SurfaceHydrology(
            evapotranspiration=tt.PALADYNCanopyEvapotranspiration
            .consistent_units(ground_resistance=tt.SoilMoistureResistanceFactor()),
            surface_runoff=tt.DirectSurfaceRunoff.consistent()))
    times = np.arange(hours) * 3600.0
    day = times[:, None] / 86400.0
    x = (np.arange(cells) + 0.5) / cells
    ta = 10.0 + 8.0 * np.sin(2 * np.pi * x)[None, :] \
        + 6.0 * np.sin(2 * np.pi * (day - 0.3))
    sw = 600.0 * np.maximum(0.0, np.sin(2 * np.pi * (day - 0.25))) \
        * (0.5 + 0.5 * x)[None, :]
    forcing = tt.TimeSeriesInputSource(
        times=times, series={"air_temperature": ta.astype(np.float32),
                             "surface_shortwave_down": sw.astype(np.float32)})
    static = tt.FieldInputSource(fields={"surface_longwave_down": 320.0,
                                         "windspeed": 2.0, "rainfall": 1e-7})
    return tt.initialize(
        model, tt.ForwardEuler(dt=600.0),
        initializers={"temperature": 2.0, "saturation_water_ice": 0.5,
                      "carbon_vegetation": 2.0,
                      "vegetation_area_fraction": 0.5},
        input_sources=(forcing, static))


# -- phases -----------------------------------------------------------------
def phase_device(tt, want_count=1):
    """Refuse anything but GPUs; report the device, the card's power limit,
    JAX version, XLA flags and compile cache."""
    import jax

    from terrarium_tpu.utils.compile_cache import configure_compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devs[0].platform!r} (no CPU fallback)")
    if len(devs) < want_count:
        raise SystemExit(f"chip_smoke: needs {want_count} GPUs, found "
                         f"{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    return {"device_kind": devs[0].device_kind, "count": len(devs),
            "nvidia_smi": smi.splitlines(), "jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "compile_cache": configure_compile_cache()}


def phase_n145_heat_richards(tt, cells=N145_CELLS, steps=1440):
    """One simulated day of the bench.py protocol (ForwardEuler, dt=60 s),
    compared with the CPU; compile and run times."""
    dt = 60.0
    sim, first_s, rec = compare_with_cpu(
        lambda: heat_richards_sim(tt, cells), steps, dt,
        names=["internal_energy", "saturation_water_ice", "temperature"])
    # steady-state rollout time: a chunk executable compiled by the runs above
    chunk = steps // REPLAY_POINTS
    roll = sim._rollout_fn(chunk)
    _, run_s = _timed(lambda: roll(sim.state, dt))
    return {"cells": cells, "steps": steps, **rec,
            "compile_and_run_s": first_s, "timed_steps": chunk,
            "run_s": run_s, "us_per_step": 1e6 * run_s / chunk,
            "cells_steps_per_s": cells * chunk / run_s,
            "f32_matmuls": F32_MATMULS}


def phase_goldens_f64(tt, names=None):
    """The five stored float64 goldens on this device, at the test
    tolerances: each step of each golden trajectory is replayed on the GPU
    from the CPU's state and must match the CPU's step (the gate); the
    whole trajectory run on the GPU is compared with the stored golden and
    reported. A trajectory that passes a saturation switch (``sat < 1`` in
    the water table and the infiltration) on a value within ulps of 1 takes
    the other branch on the other backend, so its end state can differ by
    far more than the tolerance without any step being wrong."""
    import jax

    from terrarium_tpu.diagnostics.golden_cases import (ATOL, CASES, RTOL,
                                                         run_case)

    gpu, cpu = jax.devices()[0], _cpu()

    def worst_ratio(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float((np.abs(a - b) / (ATOL + RTOL * np.abs(b))).max())

    out = {}
    with jax.enable_x64(True):
        for name in (names or CASES):
            build, steps, dt, fields = CASES[name]
            got = run_case(name)
            golden = np.load(GOLDEN_DIR / f"{name}.npz")
            trajectory = max(worst_ratio(got[f], golden[f]) for f in fields)
            sim = _on_cpu(build())
            model, ts, ctx = sim.model, sim.timestepper, sim.ctx
            step = jax.jit(lambda s, srcs: ts.step(model, s, ctx, srcs, dt))
            src_gpu = jax.device_put(sim.input_sources, gpu)
            s, replay = sim.state, (0.0, None)
            with jax.default_device(cpu):
                for k in range(steps):
                    g = step(jax.device_put(s, gpu), src_gpu)
                    s = step(s, sim.input_sources)
                    for f in sorted(s.prognostic):
                        r = worst_ratio(g.prognostic[f], s.prognostic[f])
                        if r > replay[0]:
                            replay = (r, [k, f])
            out[name] = {"replay_worst_error_over_tolerance": replay[0],
                         "replay_worst_at": replay[1],
                         "trajectory_worst_error_over_tolerance": trajectory}
            if replay[0] > 1.0:
                raise AssertionError(f"{name}: replayed step {replay[1]} "
                                     f"beyond the golden tolerance | {out}")
    return {"rtol": RTOL, "atol": ATOL, "cases": out}


def phase_land_coupled_n145(tt, cells=N145_CELLS, steps=144):
    """Coupled vegetated LandModel (Nz=20), 144 steps at dt=600 under hourly
    forcing, compared with the CPU."""
    dt = 600.0
    _, wall, rec = compare_with_cpu(lambda: land_coupled_sim(tt, cells),
                                    steps, dt)
    return {"cells": cells, "steps": steps, "compile_and_run_s": wall, **rec}


def phase_implicit_n145(tt, cells=N145_CELLS, steps=96):
    """ImplicitEuler (dt=900 s, default PCR solves) on heat + Richards,
    compared with the CPU."""
    dt = 900.0
    sim, wall, rec = compare_with_cpu(
        lambda: heat_richards_sim(tt, cells, stepper=tt.ImplicitEuler(dt=dt)),
        steps, dt,
        names=["internal_energy", "saturation_water_ice", "temperature"])
    return {"cells": cells, "steps": steps, "solver": sim.timestepper.solver,
            "compile_and_run_s": wall, **rec}


def phase_grad_n145_heat(tt, cells=N145_CELLS, steps=60):
    """value_and_grad of the mean final soil temperature w.r.t. the mineral
    thermal conductivity through a per-step remat rollout (BASELINE #5)."""
    import jax
    import jax.numpy as jnp

    from terrarium_tpu.timesteppers.autodiff import make_rollout_fn

    grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=20),
                            nf=np.float32)

    def mean_final_temperature(k_mineral):
        tp = tt.SoilThermalProperties(
            conductivities=tt.SoilThermalConductivities(mineral=k_mineral))
        soil = tt.SoilEnergyWaterCarbon(
            energy=tt.SoilEnergyBalance(thermal_properties=tp))
        sim = tt.initialize(
            tt.SoilModel(grid=grid, soil=soil), tt.ForwardEuler(),
            initializers={"temperature": -1.0, "saturation_water_ice": 0.8},
            boundary_conditions=tt.PrescribedSurfaceTemperature(4.0))
        roll = make_rollout_fn(sim.model, sim.timestepper, sim.ctx, (),
                               steps=steps, remat=True)
        return jnp.mean(roll(sim.state, 300.0).temperature)

    (v, g), wall = _timed(
        lambda: jax.jit(jax.value_and_grad(mean_final_temperature))(3.8))
    # the CPU reference is one jitted computation (see compare_with_cpu)
    with jax.default_device(_cpu()):
        v_c, g_c = jax.jit(jax.value_and_grad(mean_final_temperature))(3.8)
    v, g, v_c, g_c = (float(u) for u in (v, g, v_c, g_c))
    rel_v = abs(v - v_c) / abs(v_c)
    rel_g = abs(g - g_c) / abs(g_c)
    if not (np.isfinite(g) and rel_v <= F32_RTOL and rel_g <= F32_RTOL):
        raise AssertionError(f"gradient mismatch: gpu ({v}, {g}) vs cpu "
                             f"({v_c}, {g_c})")
    return {"cells": cells, "steps": steps, "value": v, "grad": g,
            "value_cpu": v_c, "grad_cpu": g_c, "rel_dev_value": rel_v,
            "rel_dev_grad": rel_g, "rtol": F32_RTOL,
            "compile_and_run_s": wall}


def phase_sweep_top(tt, cells=SWEEP_TOP_CELLS, steps=60):
    """Heat + Richards over the reference sweep's top size (2,097,152
    columns), 60 steps: finite, and the device's peak memory."""
    import jax

    sim = heat_richards_sim(tt, cells)
    _, wall = _timed(lambda: sim.run(steps=steps, dt=60.0).state)
    for name in ("internal_energy", "saturation_water_ice", "temperature"):
        if not np.all(np.isfinite(np.asarray(sim.state[name]))):
            raise AssertionError(f"{name} not finite")
    stats = jax.devices()[0].memory_stats() or {}
    return {"cells": cells, "steps": steps, "compile_and_run_s": wall,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


PHASES = {
    "n145_heat_richards": phase_n145_heat_richards,
    "goldens_f64": phase_goldens_f64,
    "land_coupled_n145": phase_land_coupled_n145,
    "implicit_n145": phase_implicit_n145,
    "grad_n145_heat": phase_grad_n145_heat,
    "sweep_top": phase_sweep_top,
}


# -- four cards -------------------------------------------------------------
def phase_four_cards(tt, cells=N145_CELLS + 1, steps=1440, nlat_half=145,
                     n_cards=4):
    """The phase-2 model sharded over ``n_cards`` (cells padded to divide),
    against the same model on one card; then ring-halo lateral diffusion on
    an all-land Full Gaussian ``ColumnRingGrid`` under ``jax.shard_map``."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from terrarium_tpu.parallel.halo import lateral_diffusion_forcing_ring
    from terrarium_tpu.parallel.sharding import cell_mesh, shard_state
    from terrarium_tpu.timesteppers.integrator import _split_sources

    devs = jax.devices()[:n_cards]
    mesh = cell_mesh(devs)
    dt = 60.0

    ref = heat_richards_sim(tt, cells)
    ref.state = jax.device_put(ref.state, devs[0])
    _, single_s = _timed(lambda: ref.run(steps=steps, dt=dt).state)

    sim = heat_richards_sim(tt, cells)
    sim.state = shard_state(sim.state, mesh)
    _, sharded_s = _timed(lambda: sim.run(steps=steps, dt=dt).state)
    dev = compare_columns(sim.state, ref.state,
                          names=["internal_energy", "saturation_water_ice",
                                 "temperature"])
    spec = NamedSharding(mesh, P(None, "cells"))
    for name in ("internal_energy", "saturation_water_ice"):
        sh = sim.state.prognostic[name].sharding
        if not sh.is_equivalent_to(spec, ndim=2):
            raise AssertionError(f"{name} left the cells sharding: {sh}")
    roll = sim._rollout_fn(steps)
    hlo = roll._jit.lower(sim.state, dt, _split_sources(sim.input_sources)[0],
                          n=steps).compile().as_text()
    found = [op for op in ("all-gather", "all-reduce", "all-to-all",
                           "reduce-scatter", "collective-permute")
             if op in hlo]
    if found:
        raise AssertionError(f"collectives in the sharded rollout: {found}")

    # ring-halo diffusion (float64): one ppermute per side per step
    with jax.enable_x64(True):
        ring = tt.full_gaussian_grid(nlat_half)
        grid = tt.ColumnRingGrid.create(
            ring, np.ones(ring.shape, bool),
            spacing=tt.ExponentialSpacing(N=6), nf=np.float64,
            pad_multiple=n_cards)
        fn_ref = lateral_diffusion_forcing_ring(1.0e8, 1.0e5, grid)
        fn_sh = lateral_diffusion_forcing_ring(
            1.0e8, 1.0e5, grid, axis_name="cells", n_shards=n_cards)
        x = np.random.default_rng(3).normal(0, 5, (grid.nz, grid.cells))

        def state_of(v):
            return {"internal_energy": v}

        t_ref = np.asarray(jax.jit(lambda v: fn_ref(state_of(v), grid))(
            jax.device_put(x, devs[0])))
        sharded = jax.jit(jax.shard_map(
            lambda v: fn_sh(state_of(v), grid), mesh=mesh,
            in_specs=P(None, "cells"), out_specs=P(None, "cells")))
        xs = jax.device_put(x, spec)
        t_sh = np.asarray(sharded(xs))
        ring_hlo = sharded.lower(xs).compile().as_text()
    scale = float(np.abs(t_ref).max())
    ring_dev = float(np.abs(t_sh - t_ref).max()) / scale
    sums = {k: abs(float(t.sum())) / float(np.abs(t).sum())
            for k, t in (("single", t_ref), ("sharded", t_sh))}
    if ring_dev > RING_RTOL:
        raise AssertionError(f"ring halo: sharded deviates by {ring_dev}")
    if max(sums.values()) > 1e-9:
        raise AssertionError(f"ring diffusion does not conserve: {sums}")
    if "collective-permute" not in ring_hlo or "all-gather" in ring_hlo:
        raise AssertionError("ring halo HLO: expected collective-permute "
                             "and no all-gather")
    return {"cells": cells, "steps": steps, "cards": len(devs),
            "rtol": F32_RTOL, "deviation_vs_single": dev,
            "single_card_s": single_s, "sharded_s": sharded_s,
            "ring": {"cells": grid.cells, "rel_dev": ring_dev,
                     "rtol": RING_RTOL, "relative_global_sum": sums}}


def _run_phase(name, fn, *args):
    t0 = time.perf_counter()
    try:
        rec = fn(*args)
    except Exception as e:
        print(json.dumps({"phase": name, "ok": False,
                          "wall_s": time.perf_counter() - t0,
                          "error": f"{type(e).__name__}: {e}"[:4000]}),
              flush=True)
        traceback.print_exc()
        return False
    print(json.dumps({"phase": name, "ok": True,
                      "wall_s": time.perf_counter() - t0, **rec}),
          flush=True)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the cells-sharded path on four cards")
    args = ap.parse_args(argv)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_cpu_use_fusion_emitters" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} {CPU_XLA_FLAG}".strip()
    tt = _import_package()
    n_cards = 4 if args.four_cards else 1
    t0 = time.perf_counter()
    device = phase_device(tt, want_count=n_cards)
    print(json.dumps({"phase": "device", "ok": True,
                      "wall_s": time.perf_counter() - t0, **device}),
          flush=True)
    if args.four_cards:
        ok = _run_phase("four_cards", phase_four_cards, tt)
    else:
        ok = all([_run_phase(name, fn, tt) for name, fn in PHASES.items()])
    if not ok:
        return 1
    import jax

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
