"""Where the time of one step of the PyTorch port goes, on a GPU.

    python3 tools/profile_torch_step.py [ncol] [float32|float64] \
        [mcica_rrtmg|tripleclouds_rrtmg|cloudless_rrtmg|homogeneous_rrtmg|
         spartacus_3d|tripleclouds_ecckd|ecckd_mcica|tripleclouds_baran2016|
         ... any name of ecrad_torch.flagship.CONFIGS]

Builds the step of a named configuration (ecrad_torch.flagship, default
the McICA flagship) at ncol columns (default 2048, the bench block) on the
first CUDA device, warms up, then:

* times the stages of one step with host clocks around synchronised
  calls: cloud generator (both samples; nothing for the other
  configurations), and inside it, per band set, the overlap cumulators,
  the draw build of the scan kernel (the threefry draws and the level scan
  in one launch) and the PDF-sampler epilogue; optical properties, for
  Tripleclouds the region and overlap preparation of one solver, LW
  solver, SW solver, and the whole step; for SPARTACUS also, inside each
  solver, the region preparation, the layer matrices, the sweeps (kernel
  launch and wait) and the rest (argument assembly, for LW the derivative
  loop), each synchronised;
* the peak device memory of one step;
* traces one step with torch.profiler and prints the 25 ops with the
  most device time, and device-busy time against the step's wall time.

Prints the card's name and power limit first.  Needs a CUDA device.
"""

import functools
import subprocess
import sys
import time

import torch

sys.path.insert(0, __import__("os").path.dirname(
    __import__("os").path.dirname(__import__("os").path.abspath(__file__))))

from ecrad_torch import flagship, pipeline  # noqa: E402
from ecrad_torch.interface import (  # noqa: E402
    _optical_properties, homogeneous_sample, spartacus_lw_inputs,
    spartacus_sw_inputs, spectral_matrix)
from ecrad_torch.config import Solver  # noqa: E402
from ecrad_torch.solvers import (  # noqa: E402
    cloud_generator, cloudless, cuda_generator, cuda_spartacus, mcica,
    spartacus, tripleclouds)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# the SPARTACUS solvers' inner stages: (module, function name, stage)
SPARTACUS_STAGES = (
    (spartacus, "_prep", "prep"),
    (spartacus, "_sw_layer_mats", "layer matrices"),
    (spartacus, "_lw_layer_mats", "layer matrices"),
    (cuda_spartacus, "sw_sweeps", "sweeps"),
    (cuda_spartacus, "lw_sweeps", "sweeps"))


def time_inner_stages(record):
    """Replace the SPARTACUS inner stages by synchronised timers that add
    their seconds to record[stage]; returns a function that restores
    them."""
    saved = [(module, name, getattr(module, name))
             for module, name, _ in SPARTACUS_STAGES]
    for (module, name, fn), (_, _, stage) in zip(saved, SPARTACUS_STAGES):
        # wraps() copies the launch counter that a kernel wrapper updates
        @functools.wraps(fn)
        def wrapped(*a, fn=fn, stage=stage):
            out, t = timed(lambda: fn(*a))
            record[stage] = record.get(stage, 0.0) + t
            return out
        setattr(module, name, wrapped)
    return lambda: [setattr(m, n, fn) for m, n, fn in saved]


def generator_stages(cfg, tab, cloud):
    """{band set: {stage: seconds}} inside the McICA generator, each stage
    synchronised: the cumulators (scan_scalars), the draw build (draws and
    scan in one kernel) and the sampler (sample_od_scaling)."""
    out = {}
    frac, op = cloud["fraction"], cloud["overlap_param"]
    fsd = cloud["fractional_std"]
    for band, ng, offset in (("sw", cfg.n_g_sw, 0),
                             ("lw", cfg.n_g_lw, pipeline.LW_SEED_OFFSET)):
        if getattr(cfg, f"{band}_solver") != Solver.MCICA:
            continue
        iseed = cloud["iseed"] + offset
        t = {}
        (scalars, exp_exp, tcc), t["cumulators"] = timed(
            lambda: cloud_generator.scan_scalars(cfg, frac, op))
        cdf, t["draws + scan (one kernel)"] = timed(
            lambda: cuda_generator.generator_draw_scan(
                iseed, scalars, tcc, ng, exp_exp))
        _, t["sampler"] = timed(lambda: cloud_generator.sample_od_scaling(
            cfg, tab.pdf_sampler, frac, fsd, cdf, tcc))
        out[band] = t
    return out


def solver_stages(cfg, tab, op, cloud, kw):
    """{stage: thunk} for the solvers of the configuration (with the
    spectral projection of its spectral flux output, but for SPARTACUS)."""
    go, cl = op["go"], op["cl"]
    cos_sza = kw["cos_sza"]
    lw_emission = go.lw_emission * (1.0 - op["lw_albedo_g"])
    spec_lw, spec_sw = (spectral_matrix(
        cfg, getattr(tab, f"band_from_g_{b}"), getattr(cfg, f"n_bands_{b}"),
        go.planck_hl.dtype) for b in ("lw", "sw"))
    if cfg.sw_solver == Solver.SPARTACUS:
        levels = (kw["pressure_hl"], kw["temperature_hl"])
        lw = spartacus_lw_inputs(cfg, tab, op, cloud, *levels)[1]
        sw = spartacus_sw_inputs(cfg, tab, op, cloud, *levels, cos_sza)[1]
        return {"lw solver": lambda: spartacus.solver_spartacus_lw(*lw),
                "sw solver": lambda: spartacus.solver_spartacus_sw(*sw)}
    if cfg.sw_solver == Solver.TRIPLECLOUDS:
        return {
            "region prep": lambda: tripleclouds.fused_prep(
                cfg, op["frac"], cloud["fractional_std"],
                cloud["overlap_param"]),
            "lw solver": lambda: tripleclouds.solver_tripleclouds_lw(
                cfg, op["od_lw"], op["ssa_lw"], op["g_lw_arr"], cl["od_lw"],
                cl["ssa_lw"], cl["g_lw"], tab.band_from_g_lw, op["frac"],
                cloud["fractional_std"], cloud["overlap_param"],
                go.planck_hl, lw_emission, op["lw_albedo_g"],
                spec_matrix=spec_lw),
            "sw solver": lambda: tripleclouds.solver_tripleclouds_sw(
                cfg, op["od_sw"], op["ssa_sw"], op["g_sw_arr"], cl["od_sw"],
                cl["ssa_sw"], cl["g_sw"], tab.band_from_g_sw, op["frac"],
                cloud["fractional_std"], cloud["overlap_param"],
                go.incoming_sw, cos_sza, op["sw_albedo_diffuse_g"],
                op["sw_albedo_direct_g"], spec_matrix=spec_sw)}
    if cfg.sw_solver == Solver.CLOUDLESS:
        return {
            "lw solver": lambda: cloudless.solver_cloudless_lw(
                op["od_lw"], op["ssa_lw"], op["g_lw_arr"], go.planck_hl,
                lw_emission, op["lw_albedo_g"],
                do_lw_aerosol_scattering=cfg.do_lw_aerosol_scattering,
                do_lw_derivatives=cfg.do_lw_derivatives,
                spec_matrix=spec_lw),
            "sw solver": lambda: cloudless.solver_cloudless_sw(
                op["od_sw"], op["ssa_sw"], op["g_sw_arr"], go.incoming_sw,
                cos_sza, op["sw_albedo_diffuse_g"], op["sw_albedo_direct_g"],
                do_sw_delta_scaling_with_gases=(
                    cfg.do_sw_delta_scaling_with_gases),
                spec_matrix=spec_sw)}
    if cfg.sw_solver == Solver.HOMOGENEOUS:
        cloud = dict(cloud)
        for band in ("lw", "sw"):
            cloud[f"od_scaling_{band}"], cloud[f"total_cloud_cover_{band}"] \
                = homogeneous_sample(cfg, op["frac"], op[f"od_{band}"])
    return {
        "lw solver": lambda: mcica.solver_mcica_lw(
            op["od_lw"], op["ssa_lw"], op["g_lw_arr"], cl["od_lw"],
            cl["ssa_lw"], cl["g_lw"], tab.band_from_g_lw,
            cloud["od_scaling_lw"], cloud["total_cloud_cover_lw"],
            op["frac"], go.planck_hl, lw_emission, op["lw_albedo_g"],
            cloud_fraction_threshold=cfg.cloud_fraction_threshold,
            do_lw_cloud_scattering=cfg.do_lw_cloud_scattering,
            do_lw_aerosol_scattering=cfg.do_lw_aerosol_scattering,
            do_lw_derivatives=cfg.do_lw_derivatives, spec_matrix=spec_lw),
        "sw solver": lambda: mcica.solver_mcica_sw(
            op["od_sw"], op["ssa_sw"], op["g_sw_arr"], cl["od_sw"],
            cl["ssa_sw"], cl["g_sw"], tab.band_from_g_sw,
            cloud["od_scaling_sw"], cloud["total_cloud_cover_sw"],
            op["frac"], go.incoming_sw, cos_sza, op["sw_albedo_diffuse_g"],
            op["sw_albedo_direct_g"],
            cloud_fraction_threshold=cfg.cloud_fraction_threshold,
            do_sw_delta_scaling_with_gases=(
                cfg.do_sw_delta_scaling_with_gases),
            spec_matrix=spec_sw)}


def main(ncol=2048, dtype_name="float32", config_name="mcica_rrtmg"):
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dtype = torch.float32 if dtype_name == "float32" else torch.float64
    step, args = flagship.build(ncol=ncol, dtype=dtype, device="cuda",
                                config_name=config_name)
    cfg, tab = step.config, step.tables
    kw = dict(zip(flagship.ARG_ORDER, args))
    for _ in range(2):
        step(*args)

    cloud, t_gen = timed(lambda: pipeline.add_cloud_sample(
        cfg, tab, kw["cloud"]))
    rest = {k: v for k, v in kw.items() if k != "cloud"}
    op, t_op = timed(lambda: _optical_properties(
        cfg, tab, solar_irradiance=step.solar, cloud=cloud, **rest))
    stages = {name: timed(fn)[1] for name, fn in solver_stages(
        cfg, tab, op, cloud, kw).items()}
    torch.cuda.reset_peak_memory_stats()
    _, t_step = timed(lambda: step(*args))
    peak = torch.cuda.max_memory_allocated()
    print(f"{config_name} ncol={ncol} {dtype_name}: step "
          f"{t_step * 1e3:.1f} ms; generator {t_gen * 1e3:.1f}, optics "
          f"{t_op * 1e3:.1f}, " + ", ".join(
              f"{k} {v * 1e3:.1f}" for k, v in stages.items()) + " ms; "
          f"peak device memory {peak / 1e9:.2f} GB")
    for band, t in generator_stages(cfg, tab, kw["cloud"]).items():
        print(f"  generator {band} {sum(t.values()) * 1e3:.1f} ms: "
              + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in t.items())
              + " ms")
    if cfg.sw_solver == Solver.SPARTACUS:
        for name, fn in solver_stages(cfg, tab, op, cloud, kw).items():
            record = {}
            restore = time_inner_stages(record)
            try:
                _, t = timed(fn)
            finally:
                restore()
            record["rest"] = t - sum(record.values())
            print(f"  {name} {t * 1e3:.1f} ms: " + ", ".join(
                f"{k} {v * 1e3:.1f}" for k, v in record.items()) + " ms")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, t_prof = timed(lambda: step(*args))
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profiled step {t_prof * 1e3:.1f} ms wall, device busy "
          f"{device_us / 1e3:.1f} ms ({100 * device_us / 1e6 / t_prof:.1f}%)")
    print(events.table(sort_by="self_device_time_total", row_limit=25,
                       max_name_column_width=60))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2048,
         sys.argv[2] if len(sys.argv) > 2 else "float32",
         sys.argv[3] if len(sys.argv) > 3 else "mcica_rrtmg")
