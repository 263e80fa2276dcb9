"""IFS-style offline driver CLI, the reference's `bin/ecrad_ifs` (port of
``ecrad_tpu/ifs/driver.py``).

Reference: driver/ecrad_ifs_driver.F90:45-530: read the same namelist and
offline input NetCDF as the main driver, but exercise the IFS-facing
SETUP_RADIATION_SCHEME / RADIATION_SCHEME entry points (which derive
effective radii, cloud overlap and cloud geometry from IFS
parameterizations instead of taking them from the input file), then
write **net fluxes only** with save_net_fluxes.

Usage (mirrors the reference CLI):

    python -m ecrad_torch.ifs.driver config.nam input.nc output.nc \
        [--dtype float32|float64] [--bitidentity] [--nproma N] \
        [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given.  --bitidentity pins
effective radii, overlap parameter, fractional std and the McICA
od-scaling samples to the offline driver's values (reference
BITIDENTITY_TESTING, Makefile:66-69 + driver/ecrad_ifs_driver.F90:445-452),
so that the offline and IFS paths produce matching net fluxes (the
cross-driver consistency contract of test/ifs/Makefile:37-48).  Without
it the McICA sample comes from the device generator.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ecrad_torch import constants, profiling
from ecrad_torch.containers import Flux, to_numpy

# the IFS fields taken from the input's gas block
GAS_FIELDS = (("q", "h2o"), ("co2", "co2"), ("ch4", "ch4"), ("n2o", "n2o"),
              ("no2", "no2"), ("cfc11", "cfc11"), ("cfc12", "cfc12"),
              ("hcfc22", "hcfc22"), ("ccl4", "ccl4"), ("o3", "o3"))


def _host_outputs(out: dict) -> dict:
    """radiation_scheme's outputs as numpy arrays, "_flux" as a Flux of
    numpy arrays."""
    from ecrad_torch.io.output import host_flux
    host = {k: to_numpy(v) for k, v in out.items() if k != "_flux"}
    host["_flux"] = host_flux(out["_flux"])
    return host


def run_ifs(config_path: str, input_path: str, output_path: str = None,
            dtype: str = "float64", bitidentity: bool = False,
            nproma: int = None, device="cuda"):
    """Run the IFS-path radiation scheme on an offline input file.

    nproma: NPROMA block size: routes through the ZRGP-style blocked path
    (ecrad_torch.ifs.blocking; the reference's ecrad_ifs_blocked binary,
    driver/ecrad_ifs_driver_blocked.F90).

    Returns the radiation_scheme output dict (net fluxes + diagnostics,
    and "_flux"), as numpy arrays on the host."""
    from ecrad_torch.config import Config
    from ecrad_torch.driver import (exact_sample, resolve_data_dir,
                                    resolve_device)
    from ecrad_torch.ifs.scheme import (radiation_scheme,
                                        setup_radiation_scheme)
    from ecrad_torch.io.input import DriverConfig, read_input
    from ecrad_torch.io.netcdf import NcFile
    from ecrad_torch.io.output import save_net_fluxes

    device = resolve_device(device)
    dt = torch.float64 if dtype == "float64" else torch.float32
    config = Config.from_namelist(config_path)
    driver_config = DriverConfig.from_namelist(config_path)
    config = resolve_data_dir(config, config_path)

    with profiling.hook("ifs:setup_radiation_scheme"):
        scheme = setup_radiation_scheme(config, device, dt)
    with profiling.hook("ecrad_ifs_driver:read_input"):
        inp = read_input(input_path, driver_config)
    ncol, nlev = inp.gas_mmr.shape[:2]

    # latitude/longitude for overlap decorrelation & ice effective
    # radius (ecrad_ifs_driver.F90:259-276)
    with NcFile(input_path) as f:
        sin_lat = (np.sin(np.deg2rad(f.get("lat"))) if f.exists("lat")
                   else np.zeros(ncol))
        lon = (np.deg2rad(f.get("lon")) if f.exists("lon")
               else np.zeros(ncol))

    phl = inp.thermodynamics.pressure_hl
    thl = inp.thermodynamics.temperature_hl
    g = inp.gas_mmr
    gi = constants.GAS_INDEX
    zeros = np.zeros((ncol, nlev))
    # host arrays first: the blocked path packs them, the unblocked one
    # copies them to the device
    host = dict(
        mu0=inp.cos_sza, skin_temperature=inp.skin_temperature,
        albedo_diffuse=inp.sw_albedo, albedo_direct=inp.sw_albedo_direct,
        spectral_emissivity=inp.lw_emissivity,
        sin_lat=sin_lat, lon=lon, land_frac=np.zeros(ncol),
        pressure_fl=0.5 * (phl[:, :-1] + phl[:, 1:]),
        temperature_fl=0.5 * (thl[:, :-1] + thl[:, 1:]),
        pressure_hl=phl, temperature_hl=thl,
        cloud_frac=inp.cloud_fraction,
        q_liquid=inp.cloud_mixing_ratio[:, :, 0],
        q_ice=inp.cloud_mixing_ratio[:, :, 1],
        q_rain=zeros, q_snow=zeros, iseed=np.asarray(inp.iseed, np.int64),
        **{arg: g[:, :, gi[name]] for arg, name in GAS_FIELDS})
    if scheme.config.use_aerosols and inp.aerosol_mmr is not None:
        host["aerosol_mmr"] = inp.aerosol_mmr
    if bitidentity:
        # pin the IFS-derived fields to the offline driver's inputs
        host.update(re_liq=inp.cloud_effective_radius[:, :, 0],
                    re_ice=inp.cloud_effective_radius[:, :, 1],
                    cloud_overlap=inp.overlap_param,
                    fractional_std=inp.fractional_std)
        if scheme.config.do_clouds:
            host.update({f"cloud_extra/{k}": v for k, v in
                         exact_sample(scheme.config, inp).items()})

    def scheme_call(arrays):
        """radiation_scheme on host arrays, copied to the device."""
        kw = {}
        for k, v in arrays.items():
            v = np.asarray(v)
            kw[k] = torch.as_tensor(v).to(
                device=device,
                dtype=torch.int64 if k == "iseed" else dt)
        extra = {k.split("/", 1)[1]: kw.pop(k) for k in list(kw)
                 if k.startswith("cloud_extra/")}
        return radiation_scheme(
            scheme, solar_irradiance=float(inp.solar_irradiance),
            cloud_extra=extra or None, **kw)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with profiling.hook("ecrad_ifs_driver:radiation_scheme"):
        out = _run_scheme(scheme_call, host, ncol, nproma)
    print(f"ecrad_torch ifs: {ncol} columns x {nlev} levels in "
          f"{time.perf_counter() - t0:.3f}s"
          + (f" (nproma={nproma})" if nproma else ""))

    if output_path:
        with profiling.hook("ecrad_ifs_driver:save_net_fluxes"):
            save_net_fluxes(
                output_path, scheme.config, out["_flux"], phl,
                experiment_name=driver_config.experiment_name,
                double_precision=driver_config.do_write_double_precision)
    if profiling.enabled():
        profiling.print_profile()
    return out


def _run_scheme(scheme_call, host: dict, ncol: int, nproma):
    """scheme_call over all columns, or block by block (nproma); returns
    the outputs on the host."""
    if nproma is not None and nproma < ncol:
        # ZRGP-style blocked execution (ifs/blocking.py; reference
        # driver/ifs_blocking.F90 + ecrad_ifs_driver_blocked.F90)
        from ecrad_torch.ifs import blocking
        zrgp, table, scalars = blocking.copy_inputs_to_blocked(
            host, ncol, nproma)
        blocks = [_host_outputs(scheme_call(blocking.block_kwargs(
            zrgp[jb], table, scalars))) for jb in range(zrgp.shape[0])]
        out = blocking.copy_fluxes_from_blocked(blocks, ncol)
        out["_flux"] = Flux(**{
            name: np.concatenate([b["_flux"].fields()[name]
                                  for b in blocks], axis=0)[:ncol]
            for name in blocks[0]["_flux"].fields()})
        return out
    return _host_outputs(scheme_call(host))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ecrad_ifs",
        description="IFS-path offline driver (reference bin/ecrad_ifs)")
    ap.add_argument("config")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--dtype", default="float64",
                    choices=["float32", "float64"])
    ap.add_argument("--bitidentity", action="store_true",
                    help="pin effective radii/overlap/McICA samples to "
                         "the offline driver's values")
    ap.add_argument("--nproma", type=int, default=None,
                    help="NPROMA block size: run the ZRGP-style blocked "
                         "path (reference bin/ecrad_ifs_blocked)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    args = ap.parse_args(argv)
    run_ifs(args.config, args.input, args.output, dtype=args.dtype,
            bitidentity=args.bitidentity, nproma=args.nproma,
            device=args.device)


if __name__ == "__main__":
    sys.exit(main())
