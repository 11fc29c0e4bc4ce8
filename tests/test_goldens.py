"""Golden regression tests.

The cases live in `terrarium_tpu.diagnostics.golden_cases` (shared with
``chip_smoke.py``, which checks the same goldens on the GPU). Goldens are
stored in ``tests/goldens/`` and regenerated by running this file as a
script (``python tests/test_goldens.py``) after an intentional change.
"""
import pathlib

import numpy as np
import pytest

from terrarium_tpu.diagnostics.golden_cases import ATOL, CASES, RTOL, run_case

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"


def _golden_path(name):
    return GOLDEN_DIR / f"{name}.npz"


def _check(name):
    result = run_case(name)
    path = _golden_path(name)
    assert path.exists(), (
        f"golden {path} missing — generate with `python tests/test_goldens.py`")
    golden = np.load(path)
    for f, arr in result.items():
        np.testing.assert_allclose(
            arr, golden[f], rtol=RTOL, atol=ATOL,
            err_msg=f"{name}:{f} diverged from golden trajectory")


def test_golden_soil_heat_richards():
    _check("soil_heat_richards")


@pytest.mark.slow
def test_golden_heun_forced():
    _check("heun_forced")


@pytest.mark.slow
def test_heun_forced_lean_scan_equals_stepwise():
    """The Heun golden runs through the lean closure-rotated scan; the same
    trajectory stepped one `timestep()` at a time (no scan, full carry)
    must match to f64 machine epsilon — locking Heun x time-varying-forcing
    x lean-rollout equivalence. (Not bitwise: the scanned body and the
    stepwise executable are separate XLA compilations with different
    FMA-contraction choices; measured max rel diff ~6e-16.)"""
    build = CASES["heun_forced"][0]
    sim = build()
    sim.run(steps=12, dt=300.0)
    ref = build()
    for _ in range(12):
        ref.timestep(300.0, finalize=False)
    ref.compute_auxiliary()
    for f in ("internal_energy", "saturation_water_ice", "temperature",
              "pressure_head"):
        np.testing.assert_allclose(np.asarray(sim.state[f]),
                                   np.asarray(ref.state[f]),
                                   rtol=1e-14, atol=1e-14, err_msg=f)


def test_golden_land_model():
    _check("land_model")


def test_golden_land_snow():
    _check("land_snow")


def test_golden_implicit_freeze():
    _check("implicit_freeze")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    GOLDEN_DIR.mkdir(exist_ok=True)
    for name in CASES:
        np.savez(_golden_path(name), **run_case(name))
        print("wrote", _golden_path(name))
