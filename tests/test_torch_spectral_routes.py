"""Spectral flux output on the routes through the adding sweeps, against
the JAX package (CPU, f64).

* One step per case, port against ``__graft_entry__._build`` with the same
  overrides on the meridian columns ``torch_steps.COLUMNS`` at 137 levels,
  every field within 1e-9 W m-2 (measured ~2e-11):
  - Cloudless with flux profiles per g-point;
  - Homogeneous (LW aerosol scattering on, so LW runs the unfused McICA
    route through scat_sweeps) per g-point;
  - the unfused McICA LW route (the flagship with LW aerosol scattering
    on) per band with TOA fluxes, and per g-point;
  - Tripleclouds with two regions (both solvers' scan forms) per band with
    TOA fluxes, and per g-point.
  The port runs the sweeps' plain versions with their per-g planes; the
  JAX package takes its scan path.
* The committed references of ``cloudless_rrtmg_spectral`` and
  ``homogeneous_rrtmg_spectral`` (``tests/data/torch_{cloudless,
  homogeneous}_spectral_meridian32.npz``, which chip_smoke.py holds the
  GPU to) against the port's f64 step on all 32 columns.
"""

import os

import numpy as np
import pytest
import torch

from ecrad_torch import flagship
from tests.torch_steps import (ATOL_DIMLESS, DIMLESS, FLAGSHIP_FIELDS,
                               PROFILE_FIELDS, TOA_FIELDS, assert_fluxes,
                               jax_step, port_step)

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
ATOL = 1e-9
BANDS = dict(do_save_spectral_flux=True, do_toa_spectral_flux=True)
GPOINTS = dict(do_save_gpoint_flux=True)
UNFUSED_MCICA = dict(do_lw_aerosol_scattering=True)
TC2 = dict(sw_solver="TRIPLECLOUDS", lw_solver="TRIPLECLOUDS", nregions=2)
# case -> (Config fields over the flagship's, spectral width (SW, LW))
CASES = {
    "cloudless_gpoints": (dict(sw_solver="CLOUDLESS", lw_solver="CLOUDLESS",
                               **GPOINTS), (112, 140)),
    "homogeneous_gpoints": (dict(sw_solver="HOMOGENEOUS",
                                 lw_solver="HOMOGENEOUS", **UNFUSED_MCICA,
                                 **GPOINTS), (112, 140)),
    "mcica_unfused_bands": (dict(**UNFUSED_MCICA, **BANDS), (14, 16)),
    "mcica_unfused_gpoints": (dict(**UNFUSED_MCICA, **GPOINTS), (112, 140)),
    "tripleclouds_scan_bands": (dict(**TC2, **BANDS), (14, 16)),
    "tripleclouds_scan_gpoints": (dict(**TC2, **GPOINTS), (112, 140)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_route_matches_jax(case):
    over, (nsw, nlw) = CASES[case]
    ref, got = jax_step(over), port_step(over)
    for k in PROFILE_FIELDS:
        width = nsw if k.startswith("sw") else nlw
        assert got[k].shape == (4, 138, width), k
        assert np.abs(ref[k]).max() > 1.0, k
    fields = FLAGSHIP_FIELDS + PROFILE_FIELDS + (
        TOA_FIELDS if "do_toa_spectral_flux" in over else ())
    assert_fluxes(got, ref, fields, atol=ATOL)


@pytest.mark.parametrize("config_name, fname", [
    ("cloudless_rrtmg_spectral", "torch_cloudless_spectral_meridian32.npz"),
    ("homogeneous_rrtmg_spectral",
     "torch_homogeneous_spectral_meridian32.npz")])
def test_reference_file_matches_port(config_name, fname):
    step, args = flagship.build(ncol=32, dtype=torch.float64, device="cpu",
                                config_name=config_name)
    got = step(*args).fields()
    assert set(got) == set(FLAGSHIP_FIELDS + PROFILE_FIELDS + TOA_FIELDS)
    with np.load(os.path.join(DATA, fname)) as z:
        cols = list(z["profile_columns"])
        assert {k[4:] for k in z.files if k.startswith("f64/")} == set(got)
        for k, v in got.items():
            r = z[f"f64/{k}"]
            if v.dim() == 3:
                assert r.shape[0] == len(cols)
                v = v[cols]
            atol = ATOL_DIMLESS if k in DIMLESS else ATOL
            np.testing.assert_allclose(v.numpy(), r, rtol=0, atol=atol,
                                       err_msg=k)
            assert z[f"f32/{k}"].dtype == np.float32, k
        assert not [k for k in z.files if k.startswith("f32_sample/")]
