"""Offline driver CLI (port of ``ecrad_tpu/driver.py``), the reference's
contract:

    python -m ecrad_torch.driver config.nam input.nc output.nc \
        [--dtype float32|float64] [--nrepeat N] [--generator exact|device] \
        [--device cuda|cpu]

Reference: driver/ecrad_driver.F90:28-431 (namelist -> setup -> read
input -> radiation over all columns -> save_fluxes).

Runs on the card unless ``--device cpu`` is given; without a CUDA device
it raises and names the flag.  The McICA sample comes from the bit-exact
host generator by default (the reference's lagged-Fibonacci stream,
``solvers/cloud_generator_exact``, native C++/OpenMP), copied to the
device once in the dtype of the run; ``--generator device`` draws it on
the device inside the step instead (``pipeline.add_cloud_sample``: the
threefry draws, the overlap scan and the PDF sampling in one kernel,
``generator_scan.cu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ecrad_torch import pipeline, profiling
from ecrad_torch.config import Config, Solver
from ecrad_torch.data import find_data_file
from ecrad_torch.interface import (crop_cloud_fraction, pdf_file_name,
                                   radiation, setup_radiation)

# The Flux fields flipped back to the file's surface-first order for a
# surface-first input (radiation_interface.F90 radiation_reverse)
FLIPPED_FIELDS = ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dn_direct",
                  "lw_up_clear", "lw_dn_clear", "sw_up_clear",
                  "sw_dn_clear", "sw_dn_direct_clear", "lw_derivatives")


def resolve_device(device) -> torch.device:
    """The run's device; a CUDA device that is absent raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (device="
                           "\"cpu\") to run on the CPU")
    return device


def exact_sample(config: Config, inp) -> dict:
    """The McICA sample of the bit-exact host generator for the McICA
    band sets (numpy float64): od_scaling_sw/_lw (ncol, nlev, ng) and
    total_cloud_cover_sw/_lw (ncol,), the LW seeds offset by
    pipeline.LW_SEED_OFFSET as the device generator's are."""
    from ecrad_torch.io.netcdf import NcFile
    from ecrad_torch.solvers import cloud_generator_exact as cge

    frac = np.asarray(inp.cloud_fraction)
    total_water = inp.cloud_mixing_ratio.sum(axis=-1)
    frac = np.where(
        (frac >= config.cloud_fraction_threshold)
        & (total_water >= config.cloud_mixing_ratio_threshold), frac, 0.0)
    with NcFile(find_data_file(config.directory_name,
                               pdf_file_name(config))) as f:
        sampler = cge.PdfSampler(f.get("fsd"), f.get("x").T)
    out = {}
    for band, ng, seed_offset in (
            ("sw", config.n_g_sw, 0),
            ("lw", config.n_g_lw, pipeline.LW_SEED_OFFSET)):
        if getattr(config, f"{band}_solver") != Solver.MCICA:
            continue
        od_s, tcc = cge.cloud_generator_all_columns(
            ng, int(config.overlap_scheme), inp.iseed + seed_offset,
            config.cloud_fraction_threshold, frac, inp.overlap_param,
            config.cloud_inhom_decorr_scaling, inp.fractional_std,
            sampler, config.use_beta_overlap)
        out[f"od_scaling_{band}"] = od_s
        out[f"total_cloud_cover_{band}"] = tcc
    return out


def build_cloud_inputs(config: Config, inp, generator="exact",
                       device="cpu", dtype=torch.float64) -> dict:
    """Cloud dict for radiation() as tensors on ``device`` (the fields
    in ``dtype``, iseed int64), with the host McICA sample if a solver
    is McICA and ``generator`` is "exact"; with "device" the sample is
    drawn in the step (``add_device_sample``)."""
    def dev(x):
        return torch.as_tensor(np.asarray(x)).to(device=device,
                                                 dtype=dtype)

    cloud = {
        "fraction": dev(inp.cloud_fraction),
        "q_liq": dev(inp.cloud_mixing_ratio[:, :, 0]),
        "q_ice": dev(inp.cloud_mixing_ratio[:, :, 1]),
        "re_liq": dev(inp.cloud_effective_radius[:, :, 0]),
        "re_ice": dev(inp.cloud_effective_radius[:, :, 1]),
        "overlap_param": dev(inp.overlap_param),
        "fractional_std": dev(inp.fractional_std),
        "iseed": torch.as_tensor(np.asarray(inp.iseed, np.int64),
                                 device=device),
    }
    if inp.inv_cloud_effective_size is not None:
        cloud["inv_cloud_effective_size"] = dev(inp.inv_cloud_effective_size)
        if inp.inv_inhom_effective_size is not None:
            cloud["inv_inhom_effective_size"] = dev(
                inp.inv_inhom_effective_size)
    if generator == "exact" \
            and Solver.MCICA in (config.sw_solver, config.lw_solver):
        with profiling.hook("ecrad_driver:cloud_generator_exact"):
            sample = exact_sample(config, inp)
        with profiling.hook("ecrad_driver:copy_to_device"):
            cloud.update({k: dev(v) for k, v in sample.items()})
    return cloud


def add_device_sample(config: Config, tables, cloud: dict) -> dict:
    """The cloud dict with the device generator's McICA sample
    (pipeline.add_cloud_sample on the cropped cloud fraction, as the JAX
    driver draws it)."""
    sample = pipeline.add_cloud_sample(
        config, tables, dict(cloud, fraction=crop_cloud_fraction(config,
                                                                 cloud)))
    return {**sample, "fraction": cloud["fraction"]}


def resolve_data_dir(config: Config, config_path: str) -> Config:
    """The reference resolves a relative directory_name against the CWD,
    and its namelists carry paths like "../../data" meant for runs from
    test/ifs/.  Accept both: if the path does not resolve from here,
    retry relative to the namelist's own directory."""
    ddir = config.directory_name
    if ddir and not os.path.isabs(ddir) and not os.path.isdir(ddir):
        cand = os.path.normpath(
            os.path.join(os.path.dirname(os.path.abspath(config_path)),
                         ddir))
        if os.path.isdir(cand):
            config = config.replace(directory_name=cand)
    return config


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(config_path: str, input_path: str, output_path: str,
        dtype: str = "float64", nrepeat: int = None,
        generator: str = "exact", device="cuda"):
    """The offline driver: returns the Flux as written (numpy arrays,
    in the file's level order).  The debug dumps go to the working
    directory, as the reference writes them."""
    from ecrad_torch.check import check_fluxes, check_inputs
    from ecrad_torch.io.input import DriverConfig, read_input
    from ecrad_torch.io.output import (host_flux, save_fluxes,
                                       save_net_fluxes)

    device = resolve_device(device)
    dt = torch.float64 if dtype == "float64" else torch.float32
    config = Config.from_namelist(config_path)
    driver_config = DriverConfig.from_namelist(config_path)
    config = resolve_data_dir(config, config_path)
    if nrepeat is None:
        nrepeat = driver_config.nrepeat

    if driver_config.iverbose >= 2:
        print("-------------------- OFFLINE ECRAD_TORCH RADIATION SCHEME "
              "--------------------")
        print(f"Floating-point precision: "
              f"{'double' if dtype == 'float64' else 'single'}")

    with profiling.hook("radiation_interface:setup_radiation"):
        config, tables = setup_radiation(config, device, dt)

    if driver_config.iverbose >= 2:
        # resolved-config dump (radiation_config.F90:1411-1612)
        from ecrad_torch.config import describe_config
        print(describe_config(config))

    # setup-optics diagnostic dumps (ecrad_driver.F90:224-230)
    if driver_config.do_save_aerosol_optics and tables.aerosol:
        from ecrad_torch.io.save_optics import save_aerosol_optics
        save_aerosol_optics("aerosol_optics.nc", tables.aerosol,
                            hdf5=driver_config.do_write_hdf5)
    if driver_config.do_save_cloud_optics \
            and config.use_general_cloud_optics and tables.cloud:
        from ecrad_torch.io.save_optics import save_general_cloud_optics
        save_general_cloud_optics("hydrometeor_optics", tables.cloud,
                                  hdf5=driver_config.do_write_hdf5)
    with profiling.hook("ecrad_driver:read_input"):
        inp = read_input(input_path, driver_config)

    # bounds validation (driver/ecrad_driver.F90:314-323)
    with profiling.hook("ecrad_driver:check_inputs"):
        any_bad, inp = check_inputs(
            inp, do_fix=driver_config.do_correct_unphysical_inputs)
    if any_bad and not driver_config.do_correct_unphysical_inputs:
        raise ValueError(
            "input fields out of physical bounds; set "
            "do_correct_unphysical_inputs=true to clamp them")

    def to_dev(x):
        return (torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)
                if x is not None else None)

    cloud = None
    if config.do_clouds:
        with profiling.hook("ecrad_driver:build_cloud_inputs"):
            cloud = build_cloud_inputs(config, inp, generator, device, dt)
    use_device_gen = cloud is not None and generator == "device"

    aerosol = None
    with profiling.hook("ecrad_driver:copy_to_device"):
        if config.use_aerosols and inp.aerosol_mmr is not None:
            aerosol = {"mixing_ratio": to_dev(inp.aerosol_mmr)}
        kwargs = dict(
            pressure_hl=to_dev(inp.thermodynamics.pressure_hl),
            temperature_hl=to_dev(inp.thermodynamics.temperature_hl),
            gas_mmr=to_dev(inp.gas_mmr),
            cos_sza=to_dev(inp.cos_sza),
            skin_temperature=to_dev(inp.skin_temperature),
            sw_albedo=to_dev(inp.sw_albedo),
            sw_albedo_direct=to_dev(inp.sw_albedo_direct),
            lw_emissivity=to_dev(inp.lw_emissivity),
            aerosol=aerosol)
    solar = float(inp.solar_irradiance)

    def step():
        cl = cloud
        if use_device_gen:
            cl = add_device_sample(config, tables, cl)
        return radiation(
            config, tables, solar_irradiance=solar, cloud=cl,
            spectral_solar_cycle_multiplier=float(
                inp.spectral_solar_cycle_multiplier), **kwargs)

    _sync(device)
    t0 = time.perf_counter()
    with profiling.hook("ecrad_driver:radiation[first_call+compile]"):
        flux = step()
        _sync(device)
    t_first = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(max(0, nrepeat - 1)):
        with profiling.hook("ecrad_driver:radiation"):
            flux = step()
            _sync(device)
    t_rest = time.perf_counter() - t0

    ncol = inp.ncol
    print(f"ecrad_torch: {ncol} columns x {inp.nlev} levels; "
          f"first call (incl. compile) {t_first:.3f}s"
          + (f"; {nrepeat-1} repeats {t_rest:.3f}s "
             f"({ncol*(nrepeat-1)/max(t_rest,1e-9):.0f} cols/s)"
             if nrepeat > 1 else ""))

    out_phl = inp.thermodynamics.pressure_hl
    if inp.flipped:
        # flip output profiles back to the file's surface-first order
        # (radiation_interface.F90 radiation_reverse)
        flux = dataclasses.replace(flux, **{
            f: getattr(flux, f).flip(1) for f in FLIPPED_FIELDS
            if getattr(flux, f) is not None})
        out_phl = out_phl[:, ::-1]

    with profiling.hook("ecrad_driver:copy_to_host"):
        flux = host_flux(flux)
    # Post-run output validation (ecrad_driver.F90:395
    # flux%out_of_physical_bounds / heating_rate_out_of_physical_bounds,
    # radiation_flux.F90:117): warns on stderr; the run completes, as in
    # the reference.
    check_fluxes(flux, out_phl)

    with profiling.hook("ecrad_driver:save_fluxes"):
        save = (save_net_fluxes if driver_config.do_save_net_fluxes
                else save_fluxes)
        save(output_path, config, flux, out_phl,
             experiment_name=driver_config.experiment_name,
             double_precision=driver_config.do_write_double_precision,
             hdf5=driver_config.do_write_hdf5)

    # shortwave spectral diagnostics (ecrad_driver.F90:213-219,410-419)
    if len(driver_config.sw_diag_wavelength_bound) >= 2 and config.do_sw:
        from ecrad_torch.io.output import save_sw_diagnostics
        from ecrad_torch.optics.spectral import get_sw_mapping
        mapping = get_sw_mapping(
            tables.specdef_sw, driver_config.sw_diag_wavelength_bound,
            use_bands=not config.do_cloud_aerosol_per_sw_g_point)
        save_sw_diagnostics(
            driver_config.sw_diag_file_name, config,
            driver_config.sw_diag_wavelength_bound, mapping, flux,
            experiment_name=driver_config.experiment_name,
            double_precision=driver_config.do_write_double_precision)

    # debug dumps (ecrad_driver.F90 do_save_inputs;
    # radiation_interface do_save_radiative_properties)
    if driver_config.do_save_inputs:
        from ecrad_torch.io.save_extras import save_inputs
        save_inputs("inputs.nc", config, inp)
    if config.do_save_radiative_properties:
        from ecrad_torch.interface import compute_radiative_properties
        from ecrad_torch.io.save_extras import save_radiative_properties
        props = compute_radiative_properties(
            config, tables,
            cloud=({k: v for k, v in cloud.items() if k != "iseed"}
                   if cloud else None),
            solar_irradiance=solar, **kwargs)
        save_radiative_properties("radiative_properties.nc", config,
                                  props)
    if profiling.enabled():
        profiling.print_profile()
    return flux


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ecrad_torch",
        description="ecRad-equivalent offline radiation driver "
                    "(PyTorch/CUDA)")
    ap.add_argument("config")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--dtype", default="float64",
                    choices=["float32", "float64"])
    ap.add_argument("--nrepeat", type=int, default=None)
    ap.add_argument("--generator", default="exact",
                    choices=["exact", "device"],
                    help="McICA cloud generator: the bit-exact host "
                         "generator, or the counter-based device one")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    args = ap.parse_args(argv)
    run(args.config, args.input, args.output, dtype=args.dtype,
        nrepeat=args.nrepeat, generator=args.generator, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
