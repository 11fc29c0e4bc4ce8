"""`chip_smoke.py`'s own logic, on the CPU at tiny widths.

The script itself refuses to run without a GPU; here each phase function
runs on the CPU backend (its "CPU reference" is then the same backend, so
the comparisons must come out exact), the comparison helper must flag a
perturbed column, and the script must exit nonzero without its final
``ok`` line where there is no GPU or no package beside it.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

TINY = {
    "n145_heat_richards": dict(cells=8, steps=6),
    "goldens_f64": dict(names=("soil_heat_richards", "implicit_freeze")),
    "land_coupled_n145": dict(cells=8, steps=6),
    "implicit_n145": dict(cells=8, steps=4),
    "grad_n145_heat": dict(cells=8, steps=4),
    "sweep_top": dict(cells=16, steps=4),
}


@pytest.fixture(scope="module")
def tt():
    return cs._import_package()


@pytest.mark.parametrize("name", sorted(TINY))
def test_phase_runs_at_tiny_width(tt, name):
    rec = cs.PHASES[name](tt, **TINY[name])
    json.dumps(rec)  # every phase record is one JSON line
    for dev in rec.get("trajectory_vs_cpu", {}).values():
        assert dev["max_abs"] == 0.0 and dev["bad_columns"] == 0
    for dev in rec.get("replay_worst_vs_cpu", {}).values():
        assert dev["max_rel"] == 0.0
    for case in rec.get("cases", {}).values():
        assert case["replay_worst_error_over_tolerance"] == 0.0
        assert case["trajectory_worst_error_over_tolerance"] <= 1.0


def test_four_cards_path_on_cpu_mesh(tt):
    rec = cs.phase_four_cards(tt, cells=16, steps=4, nlat_half=4)
    assert rec["cards"] == 4
    for dev in rec["deviation_vs_single"].values():
        assert dev["bad_columns"] == 0
    assert rec["ring"]["rel_dev"] <= cs.RING_RTOL


def test_compare_columns_flags_a_deviating_column(tt):
    sim = cs.heat_richards_sim(tt, 8, nz=6)
    ref = sim.state
    u = np.array(ref.prognostic["internal_energy"])
    u[2, 5] *= 1.0 + 10 * cs.F32_RTOL
    got = ref.update(internal_energy=u)
    with pytest.raises(AssertionError, match="internal_energy: 1 columns"):
        cs.compare_columns(got, ref, names=["internal_energy"])
    out = cs.compare_columns(ref, ref)
    assert all(v["max_abs"] == 0.0 for v in out.values())


def test_envelope_widens_the_tolerance_where_the_cpu_itself_moves(tt):
    """A field whose CPU result moves under a one-ulp input perturbation may
    deviate by ENVELOPE times that much; a field that does not move may
    not."""
    ref = cs.heat_richards_sim(tt, 8, nz=6).state
    u = np.array(ref.prognostic["internal_energy"])
    s = np.array(ref.prognostic["saturation_water_ice"])
    moved = ref.update(internal_energy=u + 1e-3 * np.abs(u).max())
    got = ref.update(internal_energy=u + 4e-3 * np.abs(u).max(),
                     saturation_water_ice=s)
    out = cs.compare_columns(got, ref, moved, names=["internal_energy"])
    assert out["internal_energy"]["bad_columns"] == 0
    got = got.update(saturation_water_ice=s + 4e-3 * np.abs(s).max())
    with pytest.raises(AssertionError, match="saturation_water_ice: 8 col"):
        cs.compare_columns(got, ref, moved)


def test_one_ulp_up_moves_every_prognostic_by_one_ulp(tt):
    state = cs.heat_richards_sim(tt, 8, nz=6).state
    up = cs.one_ulp_up(state)
    for name, v in state.prognostic.items():
        v = np.asarray(v)
        np.testing.assert_array_equal(np.asarray(up.prognostic[name]),
                                      np.nextafter(v, np.inf).astype(v.dtype))


def _run(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})


def _has_ok_line(stdout):
    return any('"ok": true' in line and '"device"' in line
               for line in stdout.splitlines())


def test_script_refuses_cpu(tmp_path):
    out = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr + out.stdout
    assert not _has_ok_line(out.stdout)


def test_script_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert not _has_ok_line(out.stdout)


def test_import_without_h5py(tmp_path):
    out = _run(["-c", "import sys; sys.modules['h5py'] = None; "
                      "import terrarium_tpu; print('imported')"], ROOT)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout
