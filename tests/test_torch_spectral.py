"""The port's spectral flux outputs against the JAX package (CPU, f64).

* One step per configuration, port against ``__graft_entry__._build`` with
  the same overrides, on the meridian columns ``torch_steps.COLUMNS`` at
  137 levels (SPARTACUS on a window of 12 levels): every field, the
  spectral ones included, in the JAX package's band or g order, within
  1e-7 W m-2 (measured ~1e-10):
  - the flagship with flux profiles and TOA fluxes per band;
  - the flagship with flux profiles per g-point;
  - ``tripleclouds_rrtmg`` with profiles per band;
  - ``tripleclouds_ecckd`` with profiles per g-point;
  - ``spartacus_3d`` with profiles per g-point, which would catch a
    second application of the SPARTACUS g permutation.
  The port runs the fused McICA and Tripleclouds kernels' plain versions
  with their per-g planes, and the SPARTACUS profiles; the JAX package
  takes its scan path.
* The committed references of the two spectral configurations
  (``tests/data/torch_{mcica_spectral,tripleclouds_ecckd_gpoint}_
  meridian32.npz``, which chip_smoke.py holds the GPU to) against the
  port's f64 step on all 32 columns.
"""

import os

import numpy as np
import pytest
import torch

from ecrad_torch import flagship
from tests.torch_steps import (ATOL_DIMLESS, ATOL_FLUX, DIMLESS,
                               FLAGSHIP_FIELDS, PROFILE_FIELDS, TOA_FIELDS,
                               assert_fluxes, jax_step, port_step)

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
TC = dict(sw_solver="TRIPLECLOUDS", lw_solver="TRIPLECLOUDS")
ECCKD = dict(gas_model_sw="ECCKD", gas_model_lw="ECCKD",
             use_general_cloud_optics=True,
             do_nearest_spectral_lw_emiss=False, use_aerosols=False,
             n_aerosol_types=0, i_aerosol_type_map=())
BANDS = dict(do_save_spectral_flux=True)
GPOINTS = dict(do_save_gpoint_flux=True)
# case -> (Config fields over the flagship's, window of layers, fields,
# width of the spectral axis (SW, LW))
CASES = {
    "mcica_rrtmg_bands": (dict(do_toa_spectral_flux=True, **BANDS), None,
                          FLAGSHIP_FIELDS + PROFILE_FIELDS + TOA_FIELDS,
                          (14, 16)),
    "mcica_rrtmg_gpoints": (GPOINTS, None, FLAGSHIP_FIELDS + PROFILE_FIELDS,
                            (112, 140)),
    "tripleclouds_rrtmg_bands": (dict(**TC, **BANDS), None,
                                 FLAGSHIP_FIELDS + PROFILE_FIELDS, (14, 16)),
    "tripleclouds_ecckd_gpoints": (dict(**TC, **ECCKD, **GPOINTS), None,
                                   FLAGSHIP_FIELDS + PROFILE_FIELDS,
                                   (32, 32)),
    "spartacus_3d_gpoints": (dict(sw_solver="SPARTACUS",
                                  lw_solver="SPARTACUS", do_3d_effects=True,
                                  do_sw_delta_scaling_with_gases=False,
                                  **GPOINTS),
                             slice(88, 100), FLAGSHIP_FIELDS + PROFILE_FIELDS,
                             (112, 140)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spectral_step_matches_jax(case):
    over, levels, fields, (nsw, nlw) = CASES[case]
    ref = jax_step(over, levels=levels)
    got = port_step(over, levels=levels)
    for k in PROFILE_FIELDS:
        nlev = 137 if levels is None else levels.stop - levels.start
        width = nsw if k.startswith("sw") else nlw
        assert got[k].shape == (4, nlev + 1, width), k
        assert np.abs(ref[k]).max() > 1.0, k
    assert_fluxes(got, ref, fields)


@pytest.mark.parametrize("config_name", ["mcica_rrtmg_spectral",
                                         "tripleclouds_ecckd_gpoint"])
def test_reference_file_matches_port(config_name):
    fname = {"mcica_rrtmg_spectral": "torch_mcica_spectral_meridian32.npz",
             "tripleclouds_ecckd_gpoint":
                 "torch_tripleclouds_ecckd_gpoint_meridian32.npz"}
    step, args = flagship.build(ncol=32, dtype=torch.float64, device="cpu",
                                config_name=config_name)
    got = step(*args).fields()
    with np.load(os.path.join(DATA, fname[config_name])) as z:
        cols = list(z["profile_columns"])
        assert {k[4:] for k in z.files if k.startswith("f64/")} == set(got)
        for k, v in got.items():
            r = z[f"f64/{k}"]
            if v.dim() == 3:
                assert k in PROFILE_FIELDS and r.shape[0] == len(cols)
                v = v[cols]
            atol = ATOL_DIMLESS if k in DIMLESS else ATOL_FLUX
            np.testing.assert_allclose(v.numpy(), r, rtol=0, atol=atol,
                                       err_msg=k)
            assert z[f"f32/{k}"].dtype == np.float32, k
        sample = [k for k in z.files if k.startswith("f32_sample/")]
        assert len(sample) == (4 if config_name.startswith("mcica") else 0)
