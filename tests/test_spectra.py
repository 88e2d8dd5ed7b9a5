"""Energy-spectrum gates: discrete Parseval, single-mode shell placement,
Taylor-Green mode concentration, and the end-to-end spectra script on a
real run with Reynolds statistics.

New capability — the reference has no spectral analysis (SURVEY §5)."""
import numpy as np
import pytest

from tpulbm.utils.analysis import energy_spectrum, turbulent_kinetic_energy


def test_parseval_random_2d():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(2, 48, 80))
    k, E = energy_spectrum(u)
    ke = 0.5 * np.mean(np.sum(u * u, axis=0))
    np.testing.assert_allclose(E.sum(), ke, rtol=1e-12)
    assert k[0] == 0.0 and np.all(np.diff(k) > 0)


def test_parseval_random_3d():
    rng = np.random.default_rng(1)
    u = rng.normal(size=(3, 16, 24, 32))
    k, E = energy_spectrum(u)
    ke = 0.5 * np.mean(np.sum(u * u, axis=0))
    np.testing.assert_allclose(E.sum(), ke, rtol=1e-12)


def test_single_mode_lands_in_its_shell():
    """u = sin(2π m x / n) x̂ puts ALL energy in shell m (cubic box)."""
    n, m = 64, 5
    x = np.arange(n)
    ux = np.sin(2 * np.pi * m * x / n)[None, :].repeat(n, axis=0)
    u = np.stack([ux, np.zeros_like(ux)])
    k, E = energy_spectrum(u)
    kappa0 = 2 * np.pi / n
    assert np.argmax(E) == m
    np.testing.assert_allclose(k[m], m * kappa0)
    np.testing.assert_allclose(E[m], E.sum(), rtol=1e-12)


def test_taylor_green_concentrates_at_mode_root2():
    """The TG vortex (one period per axis) lives on modes (±1, ±1):
    |κ| = √2·κ0 → shell round(√2) = 1 on a square box."""
    from tpulbm.config import SimulationParams
    from tpulbm.models.periodic2d import taylor_green_fields
    params = SimulationParams(nx=64, ny=64, tau=0.8, problem="taylor-green",
                              inlet_velocity=0.04)
    _rho, u = taylor_green_fields(params)
    k, E = energy_spectrum(u)
    assert E[1] / E.sum() > 0.999999


def test_shape_validation():
    with pytest.raises(ValueError, match="spatial"):
        energy_spectrum(np.zeros((3, 8, 8)))   # D=3 but 2 spatial axes


def test_tke_from_stats_mapping():
    z = {"re_uxux": np.full((4, 4), 2.0), "re_uyuy": np.full((4, 4), 4.0)}
    tke = turbulent_kinetic_energy(z)
    np.testing.assert_allclose(tke, 3.0)
    with pytest.raises(KeyError):
        turbulent_kinetic_energy({"mean_rho": np.ones((4, 4))})


def test_spectra_script_end_to_end(tmp_path):
    """Run a short Taylor-Green box with stats, then the script: the
    spectrum of the decaying vortex must stay concentrated at shell 1 and
    spectrum.csv must be written."""
    from tpulbm.config import SimulationParams
    from tpulbm.runner import Runner
    import scripts.spectra as spectra

    params = SimulationParams(nx=64, ny=64, tau=0.8, problem="taylor-green",
                              inlet_velocity=0.04, num_timesteps=100,
                              output_frequency=25, output_dir=str(tmp_path), enable_vtk=False, stats_from=0)
    result = Runner(params, verbose=False).run()
    assert result.success

    spectra.main(["--dir", str(tmp_path), "--no-plot"])
    data = np.genfromtxt(tmp_path / "spectrum.csv", delimiter=",",
                         names=True)
    E = data["E"]
    assert E[1] / E.sum() > 0.99
    # and the mean-field variant runs off the stats artifact
    spectra.main(["--dir", str(tmp_path), "--mean", "--no-plot"])


def test_scalar_spectrum_parseval_and_mode():
    """E_T(k): mean removed (shell 0 exactly zero), sum = half the scalar
    variance, and a pure stripe lands in its own shell."""
    from tpulbm.utils.analysis import scalar_spectrum
    ny, nx = 32, 64
    x = np.arange(nx)[None, :]
    T = 0.3 + 0.5 * np.sin(2.0 * np.pi * 3.0 * x / nx) * np.ones((ny, 1))
    k, E = scalar_spectrum(T)
    assert E[0] < 1e-30            # mean removed (roundoff only)
    np.testing.assert_allclose(E.sum(), 0.5 * np.mean((T - T.mean()) ** 2),
                               rtol=1e-12)
    assert int(np.argmax(E)) == 3
    assert E[3] / E.sum() > 0.999


def test_scalar_spectrum_script_mode(tmp_path):
    """scripts/spectra.py --scalar works off a temperature_field.csv."""
    import scripts.spectra as spectra
    ny, nx = 16, 32
    y = np.arange(ny)[:, None]
    T = 0.5 + 0.25 * np.cos(2.0 * np.pi * 2.0 * y / ny) * np.ones((1, nx))
    with open(tmp_path / "temperature_field.csv", "w") as fh:
        fh.write("x,y,temperature\n")
        for yy in range(ny):
            fh.writelines(f"{xx},{yy},{T[yy, xx]:.8f}\n"
                          for xx in range(nx))
    spectra.main(["--dir", str(tmp_path), "--scalar", "--no-plot"])
    d = np.genfromtxt(tmp_path / "scalar_spectrum.csv", delimiter=",",
                      names=True)
    # stripe mode 2 of ny=16 against kappa0 = 2*pi/nx(=32): shell 4
    assert int(np.argmax(d["E_T"])) == 4
