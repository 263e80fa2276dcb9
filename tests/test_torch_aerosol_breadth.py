"""The port's aerosol input forms against the JAX package's, on the same
inputs (CPU, f64).

* Name-based type selection: ``resolve_aerosol_type_names`` on the bundled
  general file, with bins, optical models, preferred models, ambiguous and
  unknown names, equals the JAX package's (maps and warnings); a
  configuration given the flagship's types by name sets up the same map
  and tables as the flagship given its map, in both packages.
* The legacy band-wise aerosol file, on a small NetCDF3 file the test
  writes (14 SW / 16 LW bands, 14 hydrophobic and 5 hydrophilic types, 4
  RH bins, the IFS description variables): its tables and a step against
  the JAX package's on RRTMG bands and, per g-point, on ecCKD; the default
  file name reaches it as the override does, names included.
* Directly specified band-wise optics (seeded od / ssa / g), with and
  without LW optics: a step against the JAX package's.
* ``do_sw=False`` and ``do_lw=False`` with aerosols: the band set that runs
  equals the same fields of the run with both band sets on (the JAX
  package raises on this input, so it cannot be compared with it).

Steps run on four meridian columns (night and day) x 137 levels, within
1e-7 W m-2 (1e-10 for the dimensionless fields).
"""

import dataclasses
import io

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from ecrad_tpu import config as jconfig
from ecrad_tpu.data import DATA_DIR
from ecrad_tpu.interface import setup_radiation as jax_setup
from ecrad_tpu.optics import aerosol_description as jdesc
from ecrad_torch import config as tconfig
from ecrad_torch import flagship, pipeline
from ecrad_torch.interface import _to_tensors, setup_radiation
from ecrad_torch.optics import aerosol as taerosol
from ecrad_torch.optics import aerosol_description as tdesc
from ecrad_torch.optics import rrtmg_data
from tests.torch_steps import (COLUMNS, assert_fluxes, enums, jax_step,
                               port_args, port_step)

torch.set_num_threads(2)

GENERAL_FILE = f"{DATA_DIR}/{taerosol.GENERAL_AEROSOL_FILE}"
FLAGSHIP_MAP = (-1, -2, -3, 7, 8, 9, -4, 10, 11, 11, -5, 14)
# the flagship's types by name: sea salt bins, Woodward dust bins, OPAC
# organics (hydrophilic and hydrophobic), OPAC black carbon twice, GACP
# sulphate (hydrophilic and hydrophobic)
FLAGSHIP_NAMES = ("SS,bin=1,philic", "SS,bin=2,philic", "SS,bin=3,philic",
                  "DD,bin=1", "DD,bin=2", "DD,bin=3", "OM,philic",
                  "OM,phobic", "BC,model=OPAC", "BC,model=OPAC",
                  "SU,model=GACP,philic", "SU")
FLAGSHIP_PREFERRED = ("DD:Woodward2001", "OM:OPAC")


# --- name-based selection -------------------------------------------------

NAMES = ("DD,bin=2", "DD,bin=2,model=Fouquart1987", "DD", "DD,bin=7",
         "SS,bin=1,philic", "SS,hydrophilic", "OM", "OM,philic",
         "BC", "SU,philic", "SU,model=GACP-NewPSD,philic", "NI,bin=2,philic",
         "XX", "", "DD,bin=1,model=Nobody")
PREFERRED = {"none": (), "flagship": FLAGSHIP_PREFERRED,
             "prefix": ("SU:GACP", "BC:Bond")}


@pytest.mark.parametrize("preferred", list(PREFERRED))
def test_name_resolution_matches_jax(preferred):
    got = tdesc.resolve_aerosol_type_names(NAMES, GENERAL_FILE,
                                           PREFERRED[preferred])
    ref = jdesc.resolve_aerosol_type_names(NAMES, GENERAL_FILE,
                                           PREFERRED[preferred])
    assert got == ref
    assert got[NAMES.index("XX")] == 0 and got[NAMES.index("")] == 0
    assert got[NAMES.index("DD,bin=1,model=Nobody")] == 0


def test_name_errors_match_jax():
    for mod in (tdesc, jdesc):
        with pytest.raises(ValueError, match="bad aerosol type name"):
            mod.resolve_aerosol_type_names(("DD,size=2",), GENERAL_FILE)
        with pytest.raises(ValueError, match="not found"):
            mod.resolve_aerosol_type_names(("DD",), GENERAL_FILE,
                                           ("DD:Nobody",))


# get_index arguments: ambiguous ones warn
LOOKUPS = [("SU", True, None, None), ("DD", False, 2, None),
           ("DD", False, 2, "Woodward2001"), ("BC", False, None, None),
           ("SS", True, 3, None), ("NI", True, 0, None),
           ("OM", False, None, "Brown2018"), ("XX", False, None, None)]


@pytest.mark.parametrize("preferred", list(PREFERRED))
def test_description_matches_jax(preferred):
    """The metadata read from the NetCDF char arrays, the preferred-model
    marks, and each lookup's index and warning equal the JAX package's."""
    descs = []
    for mod in (tdesc, jdesc):
        d = mod.AerosolOpticsDescription.read(GENERAL_FILE)
        for spec in PREFERRED[preferred]:
            d.preferred_optical_model(*spec.split(":"))
        descs.append(d)
    got, ref = descs
    ref_fields = dataclasses.asdict(ref)
    ref_fields.pop("iverbose")          # the port keeps no verbosity knob
    assert dataclasses.asdict(got) == ref_fields
    assert got.code_phobic[10] == "BC" and got.model_philic[4] == "GACP"
    warned = 0
    for code, philic, bin_, model in LOOKUPS:
        outs = [io.StringIO(), io.StringIO()]
        idx = [d.get_index(code, philic, bin=bin_, optical_model=model,
                           out=o) for d, o in zip(descs, outs)]
        assert idx[0] == idx[1], (code, philic, bin_, model)
        assert outs[0].getvalue() == outs[1].getvalue()
        warned += "unambiguously" in outs[0].getvalue()
    assert warned >= 1          # "SU" hydrophilic: three GACP variants


def _jax_config(port_config):
    """The JAX Config with the same fields as a port Config."""
    kw = {}
    for f in dataclasses.fields(jconfig.Config):
        v = getattr(port_config, f.name)
        if hasattr(v, "name") and hasattr(v, "value"):
            v = getattr(type(getattr(jconfig.Config(), f.name)), v.name)
        kw[f.name] = v
    return jconfig.Config(**kw)


def _same_aerosol_tables(port_tables, jax_tables):
    got = port_tables.aerosol
    ref = _to_tensors(jax_tables.aerosol, "cpu", torch.float64)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if torch.is_tensor(v):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("config_name", ["mcica_rrtmg", "ecckd_mcica"])
def test_setup_with_names_equals_setup_with_map(config_name):
    base = flagship.flagship_config("float64", config_name).replace(
        use_aerosols=True, n_aerosol_types=12,
        i_aerosol_type_map=FLAGSHIP_MAP)
    named = base.replace(n_aerosol_types=0, i_aerosol_type_map=(),
                         aerosol_type_name=FLAGSHIP_NAMES,
                         aerosol_preferred_optical_model=FLAGSHIP_PREFERRED)
    cfg_map, tab_map = setup_radiation(base, "cpu", torch.float64,
                                       data_dir=DATA_DIR)
    cfg, tab = setup_radiation(named, "cpu", torch.float64, data_dir=DATA_DIR)
    assert cfg.i_aerosol_type_map == FLAGSHIP_MAP
    assert cfg.n_aerosol_types == 12
    for k, v in tab_map.aerosol.items():
        assert (torch.equal(tab.aerosol[k], v) if torch.is_tensor(v)
                else tab.aerosol[k] == v), k
    jcfg, jtab = jax_setup(_jax_config(named), data_dir=DATA_DIR)
    assert jcfg.i_aerosol_type_map == FLAGSHIP_MAP
    _same_aerosol_tables(tab, jtab)


# --- steps ------------------------------------------------------------------

# --- the legacy band-wise file ---------------------------------------------

NRH = 4
PHOBIC = [("DD", 1, "Dubovik2002"), ("DD", 2, "Dubovik2002"),
          ("DD", 3, "Dubovik2002"), ("DD", 1, "Fouquart1987"),
          ("DD", 2, "Fouquart1987"), ("DD", 3, "Fouquart1987"),
          ("DD", 1, "Woodward2001"), ("DD", 2, "Woodward2001"),
          ("DD", 3, "Woodward2001"), ("OM", 0, "OPAC"), ("BC", 0, "OPAC"),
          ("BC", 0, "Bond2006"), ("BC", 0, "Stier2007"), ("SU", 0, "GACP")]
PHILIC = [("SS", 1, "OPAC"), ("SS", 2, "OPAC"), ("SS", 3, "OPAC"),
          ("OM", 0, "OPAC"), ("SU", 0, "GACP")]


def _chars(strings, n):
    out = np.full((len(strings), n), b" ", dtype="S1")
    for i, s in enumerate(strings):
        out[i, :len(s)] = [c.encode() for c in s]
    return out


def write_legacy_file(path, seed=11):
    """A band-wise aerosol optics file as the IFS's legacy one lays it out
    (mass extinction, ssa, asymmetry per SW and LW band, hydrophobic
    (type, band), hydrophilic (type, RH bin, band); band bounds in cm-1;
    the description variables), with seeded properties."""
    rng = np.random.default_rng(seed)
    nb = {"sw": 14, "lw": 16}
    with netcdf_file(path, "w") as f:
        f.createDimension("hydrophobic", len(PHOBIC))
        f.createDimension("hydrophilic", len(PHILIC))
        f.createDimension("relative_humidity", NRH)
        f.createDimension("band_sw", nb["sw"])
        f.createDimension("band_lw", nb["lw"])
        f.createDimension("code_length", 2)
        f.createDimension("model_length", 20)

        def put(name, dims, data, typ="d"):
            f.createVariable(name, typ, dims)[:] = data

        for band in ("sw", "lw"):
            for kind, n, rh in (("hydrophobic", len(PHOBIC), ()),
                                ("hydrophilic", len(PHILIC),
                                 ("relative_humidity",))):
                shape = (n,) + ((NRH,) if rh else ()) + (nb[band],)
                dims = (kind,) + rh + (f"band_{band}",)
                put(f"mass_ext_{band}_{kind}", dims,
                    10.0 ** rng.uniform(1.0, 4.0, shape))
                put(f"ssa_{band}_{kind}", dims,
                    rng.uniform(0.05 if band == "lw" else 0.5, 1.0, shape))
                put(f"asymmetry_{band}_{kind}", dims,
                    rng.uniform(0.0, 0.85, shape))
        put("relative_humidity1", ("relative_humidity",),
            [0.0, 0.4, 0.7, 0.9])
        put("wavenumber1_sw", ("band_sw",), rrtmg_data.SW_WAVENUM1)
        put("wavenumber2_sw", ("band_sw",), rrtmg_data.SW_WAVENUM2)
        put("wavenumber1_lw", ("band_lw",), rrtmg_data.LW_WAVENUM1)
        put("wavenumber2_lw", ("band_lw",), rrtmg_data.LW_WAVENUM2)
        for kind, types in (("hydrophobic", PHOBIC), ("hydrophilic", PHILIC)):
            put(f"code_{kind}", (kind, "code_length"),
                _chars([t[0] for t in types], 2), "c")
            put(f"bin_{kind}", (kind,), [t[1] for t in types], "i")
            put(f"optical_model_{kind}", (kind, "model_length"),
                _chars([t[2] for t in types], 20), "c")


@pytest.fixture(scope="module")
def legacy_dir(tmp_path_factory):
    """A directory holding the legacy file under the default name."""
    d = tmp_path_factory.mktemp("legacy")
    write_legacy_file(str(d / taerosol.LEGACY_AEROSOL_FILE))
    return d


LEGACY = {
    "rrtmg": {},
    "ecckd": dict(gas_model_sw="ECCKD", gas_model_lw="ECCKD",
                  use_general_cloud_optics=True,
                  do_nearest_spectral_lw_emiss=False),
}


@pytest.mark.parametrize("gas", list(LEGACY))
def test_legacy_step_matches_jax(legacy_dir, gas):
    over = dict(LEGACY[gas], aerosol_optics_override_file_name=str(
        legacy_dir / taerosol.LEGACY_AEROSOL_FILE))
    got = port_step(over)
    assert_fluxes(got, jax_step(over))
    # the aerosols moved the clear-sky fluxes
    base = port_step(dict(LEGACY[gas], use_aerosols=False))
    assert np.abs(got["sw_dn_clear"] - base["sw_dn_clear"]).max() > 0.1


@pytest.mark.parametrize("gas", list(LEGACY))
def test_legacy_tables_match_jax(legacy_dir, gas):
    """The tables of the default legacy name (data_dir the file's
    directory), of the override, and the JAX package's, all equal; on RRTMG
    per band (14 / 16), on ecCKD per g-point (32); the types chosen by name
    against the legacy file's description give the flagship's map."""
    over = enums(tconfig, LEGACY[gas])
    base = flagship.flagship_config("float64").replace(**over)
    override = base.replace(aerosol_optics_override_file_name=str(
        legacy_dir / taerosol.LEGACY_AEROSOL_FILE))
    default = base.replace(use_general_aerosol_optics=False,
                           n_aerosol_types=0, i_aerosol_type_map=(),
                           aerosol_type_name=FLAGSHIP_NAMES,
                           aerosol_preferred_optical_model=FLAGSHIP_PREFERRED)
    _, tab = setup_radiation(override, "cpu", torch.float64,
                             data_dir=DATA_DIR)
    cfg_d, tab_d = setup_radiation(default, "cpu", torch.float64,
                                   data_dir=str(legacy_dir))
    assert cfg_d.i_aerosol_type_map == FLAGSHIP_MAP
    for k, v in tab.aerosol.items():
        assert (torch.equal(tab_d.aerosol[k], v) if torch.is_tensor(v)
                else tab_d.aerosol[k] == v), k
    _, jtab = jax_setup(_jax_config(default), data_dir=str(legacy_dir))
    _same_aerosol_tables(tab_d, jtab)
    nb = (32, 32) if gas == "ecckd" else (14, 16)
    assert tab.aerosol["mass_ext_sw_phobic"].shape == (nb[0], len(PHOBIC))
    assert tab.aerosol["g_lw_philic"].shape == (nb[1], len(PHILIC), NRH)


def test_legacy_band_count_checked(tmp_path):
    """A band-wise file whose SW bands do not match RRTMG's is refused, as
    in the JAX package."""
    path = tmp_path / "legacy.nc"
    write_legacy_file(str(path))
    config = flagship.flagship_config("float64").replace(
        aerosol_optics_override_file_name=str(path))
    with pytest.raises(ValueError, match="number of shortwave bands"):
        taerosol.setup_aerosol_optics(config, DATA_DIR, [1.0] * 13,
                                      [2.0] * 13, [1.0] * 16, [2.0] * 16)


# --- directly specified optics -------------------------------------------------

def _direct(with_lw, seed=3):
    """Seeded band-wise od / ssa / g of (4 columns, 137 levels, bands)."""
    rng = np.random.default_rng(seed)
    out = {}
    for band, nb in [("sw", 14)] + ([("lw", 16)] if with_lw else []):
        shape = (len(COLUMNS), 137, nb)
        out[f"od_{band}"] = rng.uniform(0.0, 0.02, shape) \
            * (rng.uniform(size=shape) > 0.1)
        out[f"ssa_{band}"] = rng.uniform(0.3, 1.0, shape)
        out[f"g_{band}"] = rng.uniform(0.0, 0.8, shape)
    return out


@pytest.mark.parametrize("with_lw", [True, False])
def test_direct_optics_step_matches_jax(with_lw):
    aerosol = _direct(with_lw)
    assert_fluxes(port_step({}, aerosol), jax_step({}, aerosol))


def test_direct_optics_without_lw_leave_lw_as_no_aerosol():
    """Absent LW optics are zeros: the LW fluxes equal those of a run with
    SW aerosol optics only, and the SW ones move."""
    step, kw = port_args()
    cfg = step.config
    plain = pipeline.radiation_step(
        cfg.replace(use_aerosols=False), step.tables,
        solar_irradiance=step.solar, **kw).fields()
    kw["aerosol"] = {k: torch.as_tensor(v) for k, v in _direct(False).items()}
    direct = pipeline.radiation_step(cfg, step.tables,
                                     solar_irradiance=step.solar,
                                     **kw).fields()
    for k, v in plain.items():
        if k.startswith("lw"):
            assert torch.equal(direct[k], v), k
    assert float((direct["sw_dn_clear"] - plain["sw_dn_clear"]).abs().max()) \
        > 0.1


# --- one band set off ---------------------------------------------------------

@pytest.mark.parametrize("off", ["do_sw", "do_lw"])
def test_band_set_off_with_aerosols(off):
    """The flagship (general aerosols) with one band set off runs, and the
    band set that runs gives the same fields as with both on."""
    step, args = flagship.build(ncol=6, dtype=torch.float64, device="cpu")
    kw = dict(zip(flagship.ARG_ORDER, args))
    assert step.config.use_aerosols and step.tables.aerosol is not None
    both = step(*args).fields()
    config, tables = setup_radiation(
        flagship.flagship_config("float64").replace(**{off: False}), "cpu",
        torch.float64, data_dir=DATA_DIR)
    got = pipeline.radiation_step(config, tables, solar_irradiance=step.solar,
                                  **kw).fields()
    runs = "lw" if off == "do_sw" else "sw"
    assert got and all(k.startswith(runs) or k == f"cloud_cover_{runs}"
                       for k in got)
    assert {k for k in both if k.startswith(runs)} <= set(got)
    for k, v in got.items():
        assert torch.equal(v, both[k]), k
