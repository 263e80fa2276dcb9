"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU and check
it.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure raises and
the script exits non-zero:

1. device    - a CUDA device must be present; prints the card's name and
               power limit (nvidia-smi), torch and CUDA versions.
2. build     - builds the CUDA kernels of ecrad_torch/csrc from this
               checkout.
3. kernels   - each kernel (generator_scan, lw_fused, sw_fused of the
               McICA path; tripleclouds_lw, tripleclouds_sw of the
               Tripleclouds path) against its plain torch version on the
               card, on the inputs the main path builds for a random
               atmospheric state (numpy seed) at 137 levels and 2048 and
               2049 columns, in float64 and rounded to float32; kernel and
               plain median times.
4. slice_f64 - the flagship (McICA) step (ecrad_torch.flagship) on the
               32-column meridian slice in float64 against the JAX package's
               float64 fluxes (tests/data/torch_flagship_meridian32.npz).
5. slice_f32 - (a) interface.radiation in float32 fed the JAX float32
               stochastic sample, against the JAX float32 fluxes;
               (b) the McICA main path at full size: radiation_blocked over
               6144 columns in blocks of 2048, float32, timed.
6. slice_tc_f64, slice_tc_f32 - the tripleclouds_rrtmg step on the 32
               meridian columns in float64 and float32 against the JAX
               package's fluxes (tests/data/torch_tripleclouds_meridian32
               .npz); the path is deterministic, so no sample is fed.
7. slice_tc_full - the Tripleclouds main path at full size, as 5(b).
The kernels' launch counters are reset just before each main path (5b, 7)
and read just after it.

Then one JSON line with the per-kernel results, the nvidia-smi line, and
as the last line {"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from ecrad_torch import constants, flagship, kernels, pipeline
from ecrad_torch.config import Solver
from ecrad_torch.interface import _optical_properties, radiation
from ecrad_torch.solvers import cloud_generator, cuda_generator, cuda_mcica
from ecrad_torch.solvers import cuda_tripleclouds, mcica, tripleclouds

HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(HERE, "tests", "data",
                         "torch_flagship_meridian32.npz")
REFERENCE_TC = os.path.join(HERE, "tests", "data",
                            "torch_tripleclouds_meridian32.npz")
NLEV = 137
SHAPES = (2048, 2049)         # the bench block, and a ragged column count
FULL_NCOL, FULL_BLOCK = 6144, 2048
DEV = torch.device("cuda")

# Kernel vs plain version on the same inputs: the generator scan is pure
# selection, so exact; the sweeps sum over g in another order (block tree
# vs torch.sum) and the kernels contract multiply-adds into FMAs, so f64
# agrees to roundoff: rtol 1e-10 (with a floor of 1e-10 of the output's
# largest value, for entries that are zero to roundoff).  In f32 the SW
# sweeps themselves carry a few 1e-4 of relative rounding error against
# f64, so two f32 evaluations in another order differ by as much.  The f32
# inputs are the f64 ones rounded, and each output passes if the kernel
# agrees with the plain f32 version within 1e-3 (W m-2 for fluxes) or 1e-4
# of the output's largest value, or else is no further from the plain f64
# result than F32_VS_F64 times the plain f32 version is.
F64_RTOL = 1e-10
F32_RTOL, F32_ATOL = 1e-4, 1e-3
F32_VS_F64 = 2.0
# The f64 slice against the JAX f64 reference (same algorithm, f64
# roundoff, measured ~1e-10 on the CPU): 1e-6 W m-2; derivatives and
# cloud cover are dimensionless: 1e-10.
SLICE_F64_ATOL, SLICE_F64_ATOL_DIMLESS = 1e-6, 1e-10
# The f32 slice against the JAX f32 run: ecRad's single-precision bar of
# 0.5 W m-2 for LW and SW fluxes (tests/test_tpu_smoke.py); the
# dimensionless fields to 1e-4.
SLICE_F32_ATOL, SLICE_F32_ATOL_DIMLESS = 0.5, 1e-4
DIMLESS = ("lw_derivatives", "cloud_cover_lw", "cloud_cover_sw")

KERNELS = {
    "generator_scan": dict(
        wrapper=cuda_generator.generator_scan,
        plain=cuda_generator.generator_scan_plain,
        source="ecrad_torch/csrc/generator_scan.cu",
        replaces="ecrad_tpu/solvers/pallas_generator.py:98"),
    "lw_fused": dict(
        wrapper=cuda_mcica.lw_fused, plain=cuda_mcica.lw_fused_plain,
        source="ecrad_torch/csrc/lw_fused.cu",
        replaces="ecrad_tpu/solvers/pallas_mcica.py:271"),
    "sw_fused": dict(
        wrapper=cuda_mcica.sw_fused, plain=cuda_mcica.sw_fused_plain,
        source="ecrad_torch/csrc/sw_fused.cu",
        replaces="ecrad_tpu/solvers/pallas_mcica.py:546"),
    "tripleclouds_lw": dict(
        wrapper=cuda_tripleclouds.lw_fused,
        plain=cuda_tripleclouds.lw_fused_plain,
        source="ecrad_torch/csrc/tripleclouds_lw.cu",
        replaces="ecrad_tpu/solvers/pallas_tripleclouds.py:303"),
    "tripleclouds_sw": dict(
        wrapper=cuda_tripleclouds.sw_fused,
        plain=cuda_tripleclouds.sw_fused_plain,
        source="ecrad_torch/csrc/tripleclouds_sw.cu",
        replaces="ecrad_tpu/solvers/pallas_tripleclouds.py:625"),
}
MCICA_KERNELS = ("generator_scan", "lw_fused", "sw_fused")
TC_KERNELS = ("tripleclouds_lw", "tripleclouds_sw")


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def reset_counts():
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def counts():
    return {n: k["wrapper"].launches for n, k in KERNELS.items()}


def expect_counts(got, what, **nonzero):
    """Fail unless the launch counts are `nonzero` and 0 elsewhere."""
    want = {n: nonzero.get(n, 0) for n in KERNELS}
    if got != want:
        raise AssertionError(f"{what}: launch counts {got}, expected {want}")


def median_ms(fn, reps=5):
    """Median of reps timed calls (CUDA events), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --- inputs -----------------------------------------------------------------

def kernel_inputs(ncol, dtype, seed):
    """Each kernel's inputs as the main path builds them, for the meridian
    slice tiled to ncol columns with a random state per column from a
    numpy seed: solar zenith (night included), skin temperature,
    humidity scaling, cloud-fraction scaling and generator seeds.
    Returns {kernel: [argument tuples]}: the McICA kernels' and, from the
    same optical properties, the Tripleclouds kernels'."""
    rng = np.random.default_rng(seed)
    step, args = flagship.build(ncol=ncol, dtype=dtype, device=DEV)
    config, tables = step.config, step.tables
    kw = dict(zip(flagship.ARG_ORDER, args))
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=DEV)
    kw["cos_sza"] = t(rng.uniform(-0.2, 1.0, ncol))
    kw["skin_temperature"] = kw["skin_temperature"] \
        + t(rng.normal(0.0, 3.0, ncol))
    gas = kw["gas_mmr"].clone()
    gas[..., constants.GAS_INDEX["h2o"]] *= t(rng.lognormal(0.0, 0.3,
                                                            (ncol, 1)))
    kw["gas_mmr"] = gas
    cloud = dict(kw.pop("cloud"))
    cloud["fraction"] = cloud["fraction"] * t(rng.uniform(0.5, 1.0,
                                                          (ncol, 1)))
    cloud["iseed"] = torch.as_tensor(rng.integers(1, 2**31 - 1, ncol),
                                     device=DEV)
    gen = [cloud_generator.scan_inputs(config, cloud["iseed"],
                                       cloud["fraction"],
                                       cloud["overlap_param"], ng)[:6]
           for ng in (config.n_g_lw, config.n_g_sw)]
    gen.append(gen[0][:5] + (True,))              # the exp-exp variant
    cloud = pipeline.add_cloud_sample(config, tables, cloud)
    op = _optical_properties(config, tables, solar_irradiance=step.solar,
                             cloud=cloud, **kw)
    cl, go, thr = op["cl"], op["go"], config.cloud_fraction_threshold
    lw = mcica.lw_fused_args(
        op["od_lw"], cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
        tables.band_from_g_lw, cloud["od_scaling_lw"], op["frac"],
        go.planck_hl, go.lw_emission * (1.0 - op["lw_albedo_g"]),
        op["lw_albedo_g"], thr, config.do_lw_derivatives)
    sw = mcica.sw_fused_args(
        op["od_sw"], op["ssa_sw"], op["g_sw_arr"], cl["od_sw"],
        cl["ssa_sw"], cl["g_sw"], tables.band_from_g_sw,
        cloud["od_scaling_sw"], op["frac"], go.incoming_sw, kw["cos_sza"],
        op["sw_albedo_diffuse_g"], op["sw_albedo_direct_g"], thr,
        config.do_sw_delta_scaling_with_gases)
    tc = config.replace(sw_solver=Solver.TRIPLECLOUDS,
                        lw_solver=Solver.TRIPLECLOUDS)
    tc_lw, _ = tripleclouds.lw_fused_args(
        tc, op["od_lw"], cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
        tables.band_from_g_lw, op["frac"], cloud["fractional_std"],
        cloud["overlap_param"], go.planck_hl,
        go.lw_emission * (1.0 - op["lw_albedo_g"]), op["lw_albedo_g"])
    tc_sw, _ = tripleclouds.sw_fused_args(
        tc, op["od_sw"], op["ssa_sw"], op["g_sw_arr"], cl["od_sw"],
        cl["ssa_sw"], cl["g_sw"], tables.band_from_g_sw, op["frac"],
        cloud["fractional_std"], cloud["overlap_param"], go.incoming_sw,
        kw["cos_sza"], op["sw_albedo_diffuse_g"], op["sw_albedo_direct_g"])
    return {"generator_scan": gen, "lw_fused": [lw], "sw_fused": [sw],
            "tripleclouds_lw": [tc_lw], "tripleclouds_sw": [tc_sw]}


# --- phases -----------------------------------------------------------------

def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase("device", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, gpu=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count())
    return smi


def build_phase():
    info = kernels.build()
    kernels.library()
    regs = [line.strip() for line in info["log"].splitlines()
            if "entry function" in line or "registers" in line]
    phase("build", seconds=info["seconds"], library=info["path"],
          ptxas_registers=regs)


def _outputs(x):
    return x if isinstance(x, dict) else {"out": x}


def _compare_f64(got, ref):
    """Max abs error of the f64 kernel against the f64 plain version."""
    got, ref = _outputs(got), _outputs(ref)
    if set(got) != set(ref):
        raise AssertionError(f"output keys differ: {set(got) ^ set(ref)}")
    worst = 0.0
    for k in ref:
        a, b = got[k], ref[k]
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        if not bool((err <= F64_RTOL * (b.abs() + b.abs().max())).all()):
            raise AssertionError(f"{k}: f64 kernel differs from plain by "
                                 f"{float(err.max())}")
    return worst


def _compare_f32(got, ref, ref64):
    """Max abs error of the f32 kernel against the f32 plain version, and
    the errors of both against the f64 plain result."""
    got, ref, ref64 = _outputs(got), _outputs(ref), _outputs(ref64)
    if set(got) != set(ref):
        raise AssertionError(f"output keys differ: {set(got) ^ set(ref)}")
    worst = {"vs_plain": 0.0, "kernel_vs_f64": 0.0, "plain_vs_f64": 0.0}
    for k in ref:
        a, b, c = got[k].double(), ref[k].double(), ref64[k]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{k}: non-finite kernel output")
        err = float((a - b).abs().max())
        err_k = float((a - c).abs().max())
        err_p = float((b - c).abs().max())
        for name, v in zip(list(worst), (err, err_k, err_p)):
            worst[name] = max(worst[name], v)
        if err > max(F32_ATOL, F32_RTOL * float(b.abs().max())) \
                and err_k > F32_VS_F64 * err_p:
            raise AssertionError(
                f"{k}: f32 kernel differs from plain by {err}, and from "
                f"f64 by {err_k} (plain f32 from f64: {err_p})")
    return worst


def _f32(args):
    return tuple(a.float() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def kernels_phase(smi):
    results = {name: {"max_abs_err": {}, "ms": None, "plain_ms": None}
               for name in KERNELS}
    for ncol in SHAPES:
        inputs = kernel_inputs(ncol, torch.float64, seed=ncol)
        for name, k in KERNELS.items():
            res = results[name]["max_abs_err"]
            for args in inputs[name]:
                ref64 = k["plain"](*args)
                err64 = _compare_f64(k["wrapper"](*args), ref64)
                args32 = _f32(args)
                got32, ref32 = k["wrapper"](*args32), k["plain"](*args32)
                torch.cuda.synchronize()
                if name == "generator_scan" and (
                        err64 != 0.0 or not torch.equal(got32, ref32)):
                    raise AssertionError("generator_scan is not exact")
                err32 = _compare_f32(got32, ref32, ref64)
                for key, v in ((f"float64/{ncol}", err64),
                               *((f"float32/{ncol}/{n}", e)
                                 for n, e in err32.items())):
                    res[key] = max(res.get(key, 0.0), v)
            if ncol == SHAPES[0]:
                args = _f32(inputs[name][0])
                results[name]["ms"] = median_ms(lambda: k["wrapper"](*args))
                results[name]["plain_ms"] = median_ms(
                    lambda: k["plain"](*args))
        del inputs
    for name, res in results.items():
        phase("kernels", kernel=name, max_abs_err=res["max_abs_err"],
              ms_f32_2048=res["ms"], plain_ms_f32_2048=res["plain_ms"],
              card=smi)
    return results


def _check_slice(flux, ref, prefix, atol, atol_dimless):
    worst = {}
    fields = flux.fields()
    want = {k[len(prefix):] for k in ref if k.startswith(prefix)}
    if set(fields) != want:
        raise AssertionError(f"flux fields differ: {set(fields) ^ want}")
    for name, v in fields.items():
        r = ref[prefix + name]
        err = float(np.abs(v.double().cpu().numpy() - r).max())
        worst[name] = err
        bar = atol_dimless if name in DIMLESS else atol
        if not err <= bar:
            raise AssertionError(f"{prefix}{name}: max abs error {err} > {bar}")
    return worst


def slice_f64_phase(ref):
    step, args = flagship.build(ncol=32, dtype=torch.float64, device=DEV)
    reset_counts()
    flux = step(*args)
    torch.cuda.synchronize()
    n = counts()
    expect_counts(n, "one f64 step", generator_scan=2, lw_fused=1,
                  sw_fused=1)
    worst = _check_slice(flux, ref, "f64/", SLICE_F64_ATOL,
                         SLICE_F64_ATOL_DIMLESS)
    phase("slice_f64", max_abs_err=worst, launches=n)


def slice_f32_phase(ref, smi):
    # (a) radiation() fed the JAX float32 stochastic sample
    step, args = flagship.build(ncol=32, dtype=torch.float32, device=DEV)
    kw = dict(zip(flagship.ARG_ORDER, args))
    cloud = dict(kw.pop("cloud"))
    for k in ("od_scaling_sw", "od_scaling_lw", "total_cloud_cover_sw",
              "total_cloud_cover_lw"):
        cloud[k] = torch.as_tensor(ref["f32_sample/" + k], device=DEV)
    flux = radiation(step.config, step.tables, solar_irradiance=step.solar,
                     cloud=cloud, **kw)
    torch.cuda.synchronize()
    worst = _check_slice(flux, ref, "f32/", SLICE_F32_ATOL,
                         SLICE_F32_ATOL_DIMLESS)
    phase("slice_f32_vs_jax", max_abs_err=worst)

    # (b) the main path at full size
    step, args = flagship.build(ncol=FULL_NCOL, dtype=torch.float32,
                                device=DEV, block_size=FULL_BLOCK)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    flux = step(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    main_counts = counts()
    nblocks = FULL_NCOL // FULL_BLOCK
    expect_counts(main_counts, "McICA main path",
                  generator_scan=2 * nblocks, lw_fused=nblocks,
                  sw_fused=nblocks)
    steps = check_and_time(step, args, flux)
    step_s = statistics.median(steps)
    phase("slice_f32_full", ncol=FULL_NCOL, block=FULL_BLOCK,
          first_step_s=first_s, step_s=step_s, step_s_all=steps,
          cols_per_s=FULL_NCOL / step_s, launches=main_counts, card=smi)
    return main_counts


def check_and_time(step, args, flux):
    """Check a full-size main-path result (shape, finite, sw_up within the
    incoming flux) and time three more steps; returns their seconds."""
    for name, v in flux.fields().items():
        if v.shape[0] != FULL_NCOL or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name}: bad shape or non-finite values")
    incoming = flux.sw_dn[:, :1]
    if not bool((flux.sw_up <= incoming + 1e-3).all()):
        raise AssertionError("sw_up exceeds the incoming flux")
    steps = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    return steps


def slice_tc_phases(ref, smi):
    """The Tripleclouds path: f64 and f32 slices against JAX, then its
    main path at full size."""
    for dtype, prefix, atol, atol_dimless, name in (
            (torch.float64, "f64/", SLICE_F64_ATOL, SLICE_F64_ATOL_DIMLESS,
             "slice_tc_f64"),
            (torch.float32, "f32/", SLICE_F32_ATOL, SLICE_F32_ATOL_DIMLESS,
             "slice_tc_f32")):
        step, args = flagship.build(ncol=32, dtype=dtype, device=DEV,
                                    config_name="tripleclouds_rrtmg")
        reset_counts()
        flux = step(*args)
        torch.cuda.synchronize()
        n = counts()
        expect_counts(n, f"one {name} step", tripleclouds_lw=1,
                      tripleclouds_sw=1)
        worst = _check_slice(flux, ref, prefix, atol, atol_dimless)
        phase(name, max_abs_err=worst, launches=n)

    step, args = flagship.build(ncol=FULL_NCOL, dtype=torch.float32,
                                device=DEV, block_size=FULL_BLOCK,
                                config_name="tripleclouds_rrtmg")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    flux = step(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    main_counts = counts()
    nblocks = FULL_NCOL // FULL_BLOCK
    expect_counts(main_counts, "Tripleclouds main path",
                  tripleclouds_lw=nblocks, tripleclouds_sw=nblocks)
    steps = check_and_time(step, args, flux)
    step_s = statistics.median(steps)
    phase("slice_tc_full", ncol=FULL_NCOL, block=FULL_BLOCK,
          first_step_s=first_s, step_s=step_s, step_s_all=steps,
          cols_per_s=FULL_NCOL / step_s, launches=main_counts, card=smi)
    return main_counts


def main():
    smi = device_phase()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    results = kernels_phase(smi)
    with np.load(REFERENCE) as z:
        ref = {k: z[k] for k in z.files}
    slice_f64_phase(ref)
    mcica_counts = slice_f32_phase(ref, smi)
    with np.load(REFERENCE_TC) as z:
        ref_tc = {k: z[k] for k in z.files}
    tc_counts = slice_tc_phases(ref_tc, smi)
    # each kernel's launches in the main path that runs it
    main_counts = {n: (tc_counts if n in TC_KERNELS else mcica_counts)[n]
                   for n in KERNELS}
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": main_counts[n],
         "max_abs_err": max(
             results[n]["max_abs_err"][f"float32/{c}/vs_plain"]
             for c in SHAPES),
         "ms": results[n]["ms"], "plain_ms": results[n]["plain_ms"]}
        for n, k in KERNELS.items()]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
