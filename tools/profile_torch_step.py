"""Where the time of one step of the PyTorch port goes, on a GPU.

    python3 tools/profile_torch_step.py [ncol] [float32|float64] \
        [mcica_rrtmg|tripleclouds_rrtmg]

Builds the step of a named configuration (ecrad_torch.flagship, default
the McICA flagship) at ncol columns (default 2048, the bench block) on the
first CUDA device, warms up, then:

* times the stages of one step with host clocks around synchronised
  calls: cloud generator (both samples; nothing for Tripleclouds), optical
  properties, for Tripleclouds the region and overlap preparation of one
  solver, LW solver, SW solver, and the whole step;
* traces one step with torch.profiler and prints the 25 ops with the
  most device time, and device-busy time against the step's wall time.

Prints the card's name and power limit first.  Needs a CUDA device.
"""

import subprocess
import sys
import time

import torch

sys.path.insert(0, __import__("os").path.dirname(
    __import__("os").path.dirname(__import__("os").path.abspath(__file__))))

from ecrad_torch import flagship, pipeline  # noqa: E402
from ecrad_torch.interface import _optical_properties  # noqa: E402
from ecrad_torch.config import Solver  # noqa: E402
from ecrad_torch.solvers import mcica, tripleclouds  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def solver_stages(cfg, tab, op, cloud, cos_sza):
    """{stage: thunk} for the solvers of the configuration."""
    go, cl = op["go"], op["cl"]
    lw_emission = go.lw_emission * (1.0 - op["lw_albedo_g"])
    if cfg.sw_solver == Solver.TRIPLECLOUDS:
        return {
            "region prep": lambda: tripleclouds.fused_prep(
                cfg, op["frac"], cloud["fractional_std"],
                cloud["overlap_param"]),
            "lw solver": lambda: tripleclouds.solver_tripleclouds_lw(
                cfg, op["od_lw"], op["ssa_lw"], op["g_lw_arr"], cl["od_lw"],
                cl["ssa_lw"], cl["g_lw"], tab.band_from_g_lw, op["frac"],
                cloud["fractional_std"], cloud["overlap_param"],
                go.planck_hl, lw_emission, op["lw_albedo_g"]),
            "sw solver": lambda: tripleclouds.solver_tripleclouds_sw(
                cfg, op["od_sw"], op["ssa_sw"], op["g_sw_arr"], cl["od_sw"],
                cl["ssa_sw"], cl["g_sw"], tab.band_from_g_sw, op["frac"],
                cloud["fractional_std"], cloud["overlap_param"],
                go.incoming_sw, cos_sza, op["sw_albedo_diffuse_g"],
                op["sw_albedo_direct_g"])}
    return {
        "lw solver": lambda: mcica.solver_mcica_lw(
            op["od_lw"], op["ssa_lw"], op["g_lw_arr"], cl["od_lw"],
            cl["ssa_lw"], cl["g_lw"], tab.band_from_g_lw,
            cloud["od_scaling_lw"], cloud["total_cloud_cover_lw"],
            op["frac"], go.planck_hl, lw_emission, op["lw_albedo_g"],
            do_lw_derivatives=True),
        "sw solver": lambda: mcica.solver_mcica_sw(
            op["od_sw"], op["ssa_sw"], op["g_sw_arr"], cl["od_sw"],
            cl["ssa_sw"], cl["g_sw"], tab.band_from_g_sw,
            cloud["od_scaling_sw"], cloud["total_cloud_cover_sw"],
            op["frac"], go.incoming_sw, cos_sza, op["sw_albedo_diffuse_g"],
            op["sw_albedo_direct_g"])}


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
        cfg, tab, op, cloud, kw["cos_sza"]).items()}
    _, t_step = timed(lambda: step(*args))
    print(f"{config_name} ncol={ncol} {dtype_name}: step "
          f"{t_step * 1e3:.1f} ms; generator {t_gen * 1e3:.1f}, optics "
          f"{t_op * 1e3:.1f}, " + ", ".join(
              f"{k} {v * 1e3:.1f}" for k, v in stages.items()) + " ms")

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
