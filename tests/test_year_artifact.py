"""Regression locks on the 1-simulated-year protocol record.

The year itself runs on the GPU (`experiments/run_year.py`), which writes
the physics record ``tests/goldens/year_protocol.json`` (protocol, end-state
ranges, checksums, exact budgets — no timings) and the decimated end-state
goldens. CI locks the committed record: finiteness and budget-closure
claims, physical end-state ranges, and the goldens' consistency with the
recorded metadata — for the soil year AND the coupled LandModel year, plus
the exact-budget closure claims (sampling-independent per-step
accumulation; the deficit_pool corrected year must close water).
"""
import json
import pathlib

import numpy as np
import pytest

GOLDENS = pathlib.Path(__file__).parent / "goldens"
YEAR = GOLDENS / "year_protocol.json"
GOLDEN = GOLDENS / "year_n145_endstate.npz"
GOLDEN_COUPLED = GOLDENS / "year_coupled_endstate.npz"
TIMING_KEYS = ("wall_s", "sypd", "sypd_instrumented", "cells_steps_per_s_M",
               "rollout_path")


def _year():
    return json.loads(YEAR.read_text())


def test_year_artifact_claims():
    data = _year()
    assert data["finite"] is True
    assert data["steps"] == 365 * 24 * 60 and data["dt"] == 60.0
    # a full year of explicit stepping stayed physical
    t_lo, t_hi = data["end_T_range"]
    assert -80.0 < t_lo < t_hi < 80.0
    s_lo, s_hi = data["end_sat_range"]
    assert 0.0 <= s_lo <= s_hi <= 1.0 + 1e-5
    assert data["coupled"]["finite"] is True


def test_year_exact_budget_claims():
    data = _year()
    eb = data["exact_budget"]
    # energy closes in both modes; parity water shows the quantified clamp
    # creation; the corrected mode closes water
    for mode in ("parity", "deficit_pool"):
        assert eb[mode]["energy"]["inventory_relative_residual"] < 1e-2
    assert eb["parity"]["water"]["residual"] > 0.0  # clamp creates water
    assert (eb["deficit_pool"]["water"]["inventory_relative_residual"]
            < 1e-3), eb["deficit_pool"]["water"]
    # the correction removed >= 95% of the parity-mode creation (r5: 1.016%
    # -> 0.031% of inventory; the standing debt may be fully repaid from
    # spill by year end, so only non-negativity is asserted on the pool)
    assert (eb["deficit_pool"]["water"]["inventory_relative_residual"]
            < 0.05 * eb["parity"]["water"]["inventory_relative_residual"])
    assert eb["deficit_pool"]["deficit_total_m"] >= 0.0


def test_year_coupled_fused_claims():
    """The coupled-year claims; the record holds physics only (no timing
    or rollout-path field)."""
    data = _year()
    c = data["coupled"]
    assert c["finite"] is True

    def keys(d):
        return [k for k, v in d.items()] + [
            kk for v in d.values() if isinstance(v, dict) for kk in keys(v)]

    assert not set(keys(data)) & set(TIMING_KEYS)
    assert c["sat_range"][1] < 1.01  # one-step overshoot bound
    assert -90.0 < c["skin_range"][0] <= c["skin_range"][1] < 90.0
    # 30-day exact budget of the consistent() composition: ENERGY closes
    # (1.5e-5 measured r5). The water residual is the documented
    # reference-parity infiltration quirk: a water Flux BC on saturation
    # enters the soil unscaled by porosity (`abstract_timestepper.jl:70-72`
    # vs `soil_hydrology.jl:222-237`), so pool->soil transfers lose
    # (1-porosity) of each infiltrated meter in inventory terms — the
    # exact instrument measures ~ half the rainfall column, reported
    # honestly (diagnostics/budget.py module docstring).
    b30 = c["exact_budget_30d"]
    assert abs(b30["energy"]["inventory_relative_residual"]) < 1e-2
    assert b30["water"]["residual"] != 0.0  # the quirk is visible, not hidden


@pytest.mark.skipif(not GOLDEN.exists(), reason="year golden not yet produced")
def test_year_golden_consistent_with_artifact():
    data = _year()
    g = np.load(GOLDEN)
    U = g["internal_energy"]
    sat = g["saturation_water_ice"]
    assert U.shape[0] == 30  # Nz of the protocol
    assert int(g["meta_cells"]) == data["cells"]
    assert U.shape[1] == -(-data["cells"] // 64)
    assert np.all(np.isfinite(U)) and np.all(np.isfinite(sat))
    assert np.all((sat >= 0.0) & (sat <= 1.0 + 1e-5))


@pytest.mark.skipif(not GOLDEN_COUPLED.exists(),
                    reason="coupled golden not yet produced")
def test_year_coupled_golden_consistent():
    data = _year()
    g = np.load(GOLDEN_COUPLED)
    U = g["internal_energy"]
    sat = g["saturation_water_ice"]
    skin = g["skin_temperature"]
    assert U.shape[0] == 20  # coupled-year Nz
    assert int(g["meta_cells"]) == data["coupled"].get("cells",
                                                       int(g["meta_cells"]))
    assert np.all(np.isfinite(U)) and np.all(np.isfinite(sat))
    assert np.all(np.isfinite(skin))
    assert np.all((sat >= 0.0) & (sat <= 1.01))
