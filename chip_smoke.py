"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU and check
it.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure raises and
the script exits non-zero:

1. device    - a CUDA device must be present; prints the card's name and
               power limit (nvidia-smi), torch and CUDA versions, and the
               maximum SM clock (nvidia-smi) that sets the integer
               issue rate of the bounds.
2. build     - builds the CUDA kernels of ecrad_torch/csrc from this
               checkout.
3. kernels   - each kernel (generator_draw_sample, lw_fused, sw_fused
               of the McICA path; tripleclouds_lw,
               tripleclouds_sw of the Tripleclouds path; lw_noscat_sweeps,
               scat_sweeps, sw_sweeps, the adding sweeps of the Cloudless
               and Homogeneous paths;
               rrtmg_lw_taumol, rrtmg_sw_taumol, the RRTMG gas optics of
               every RRTMG path (f64 held to 1e-12 of the plain version);
               spartacus_sw, spartacus_lw of the SPARTACUS path, in
               Explicit entrapment without LW multilayer effects as the
               path runs them, and again in Maximum and Edge-only
               entrapment with them; sw_fused and tripleclouds_sw also
               with delta-Eddington scaling of the gases, lw_fused and
               tripleclouds_lw also without derivatives; scat_sweeps
               and sw_sweeps also on the total scene's coefficients, as
               the unfused McICA path builds them) against its
               plain torch version on the card, on the inputs the main
               path builds for a random atmospheric state (numpy seed) at
               137 levels and 2048 and 2049 columns, and for lw_fused,
               sw_fused, tripleclouds_lw, tripleclouds_sw, spartacus_sw,
               spartacus_lw and the total scene's scat_sweeps and
               sw_sweeps also on the same state with every layer
               cloudy, in float64 and rounded to float32 (a second
               float32 launch must equal the first bit for bit); and the
               five kernels of the ecCKD paths (generator_draw_sample,
               lw_fused, sw_fused, tripleclouds_lw, tripleclouds_sw) also
               on the
               ecckd_mcica state (32 g-points, per-g-point cloud optics:
               32 bands, band_of_g the identity; one warp per block), and
               spartacus_sw and spartacus_lw on the spartacus_ecckd state
               as its path runs them (32 g-points); and
               the six kernels of the monochromatic paths
               (generator_draw_sample, lw_fused, sw_fused and the three
               adding sweeps) at one g-point (mono_inputs: monochromatic optics
               on the McICA solvers; one live lane per block); kernel and
               plain median times (the kernel's on each input set TIMED
               names), and the least time the card could take for the
               same work.  The seven kernels that write per-g planes for
               spectral flux output (PLANES: lw_fused, sw_fused,
               tripleclouds_lw, tripleclouds_sw and the three adding
               sweeps) are checked
               again on every input set with their planes against the
               plain versions' (the same bars), their broadband outputs
               with planes against those without, bit for bit, and a
               second float32 launch with planes against the first; they
               are timed with planes too, beside a bound that counts the
               planes' bytes.  The generator kernel
               (generator_draw_sample: cuda_generator.generator_draw_scan,
               which draws its threefry sample, scans the levels and
               writes od_scaling through the Chebyshev sampler) is held
               to its plain version at ng 140, 112, 32 and 1, in the
               three overlap schemes, on the meridian file's seeds, those
               + 997 (the LW stream), and seeds 0 and at or above 2^31,
               and on a set whose fractional standard deviation spans the
               fit's axis and beyond (fsd_spread), zero exactly where the
               plain version is, and also at 8192 columns (SAMPLED_NCOL)
               at ng 140, 112 and 32.  The generator's cumulator
               (generator_cumulate: the overlap cumulator and the packed
               scalars, one launch a band set) is held to its plain
               version in Exponential-Random and Maximum-Random overlap
               and at decorrelation scalings whose exponents take x * x,
               sqrt and pow, at 2048, 2049 and 8192 columns: float32 bit
               for bit, float64 within 1e-13; it is timed with
               its plain version at 2048 and 8192 columns.  The
               SPARTACUS layer matrices (spartacus_sw_mats,
               spartacus_lw_mats: cuda_spartacus.sw_layer_mats and
               lw_layer_mats, a build and a refine pass from the band
               set's raw optics, which also write the clear-sky planes,
               one launch set a band set) are held to their plain
               versions on the spartacus_3d state at RRTMG widths (also
               with the mask of use_expm_everywhere, "everywhere"), on the
               spartacus_ecckd state at 2048 and 2049 columns and at 8192
               (SAMPLED_NCOL, "ecckd_8192"), in a group of inputs of their
               own, in float32 equal in value (the kernels' clamps may
               keep a -0 where torch's give +0), and timed with their
               plain versions on each set.
4. slice_f64 - the flagship (McICA) step (ecrad_torch.flagship) on the
               32-column meridian slice in float64 against the JAX package's
               float64 fluxes (tests/data/torch_flagship_meridian32.npz);
               its launch counts, the generator's among them.
5. slice_f32 - (a) interface.radiation in float32 fed the JAX float32
               stochastic sample, against the JAX float32 fluxes;
               (b) the McICA main path at full size: radiation_blocked over
               6144 columns in blocks of 2048, float32, timed.
6. slice_tc_f64, slice_tc_f32, slice_tc_full - the tripleclouds_rrtmg step
               on the 32 meridian columns in float64 and float32 against
               the JAX package's fluxes (tests/data/torch_tripleclouds_
               meridian32.npz; the path is deterministic, so no sample is
               fed), then its main path at full size, as 5(b).
7. slice_cl_* - the same three for cloudless_rrtmg
               (tests/data/torch_cloudless_meridian32.npz).
8. slice_hom_* - the same three for homogeneous_rrtmg
               (tests/data/torch_homogeneous_meridian32.npz).
9. slice_sp_*  - the same three for spartacus_3d
               (tests/data/torch_spartacus_meridian32.npz).
10. slice_tc_ecckd_*, slice_ecckd_* - the same three for
               tripleclouds_ecckd and ecckd_mcica (tests/data/torch_
               {tripleclouds_ecckd,ecckd_mcica}_meridian32.npz; ecCKD gas
               optics, general cloud optics); the float32 McICA slice is
               fed the JAX float32 stochastic sample, as 5(a).
11. slice_tc_baran_* - the same three for tripleclouds_baran2016
               (tests/data/torch_tripleclouds_baran2016_meridian32.npz;
               Tripleclouds with Slingo liquid and Baran2016 ice).
12. slice_spec_*, slice_tc_gpt_* - the same three for the spectral flux
               outputs: mcica_rrtmg_spectral (flux profiles and TOA fluxes
               per band; the float32 slice fed the JAX float32 sample) and
               tripleclouds_ecckd_gpoint (flux profiles per g-point)
               (tests/data/torch_{mcica_spectral,tripleclouds_ecckd_gpoint}
               _meridian32.npz, whose spectral profiles hold the columns
               profile_columns), every per-band and per-g field held to
               the same bars as the broadband ones.
    slice_cl_spec_*, slice_hom_spec_*, slice_mono_* - the same three for
               cloudless_rrtmg_spectral and homogeneous_rrtmg_spectral
               (flux profiles and TOA fluxes per band through the adding
               sweeps' planes) and monochromatic_homogeneous (every kernel
               of its path at one g-point)
               (tests/data/torch_{cloudless_spectral,homogeneous_spectral,
               monochromatic}_meridian32.npz).
    slice_sp_ecckd_* - the same three for spartacus_ecckd (SPARTACUS with
               3D effects on ecCKD at 32 g-points, general cloud optics;
               tests/data/torch_spartacus_ecckd_meridian32.npz), the
               float32 slice held to the float64 fluxes as spartacus_3d's.
13. slice_sp_gpt_f64 - a 32-column float64 spartacus_3d step with flux
               profiles per g-point: its broadband fields against
               tests/data/torch_spartacus_meridian32.npz, and its g-point
               profiles summed over g against its broadband fluxes.
14. driver_f64, driver_f32 - the offline driver (ecrad_torch.driver.run,
               the host generator) on the 32 meridian columns with the
               namelist flagship.namelist_text writes: McICA in float64
               and float32, Tripleclouds in float64, every variable of
               the output file against the JAX driver's
               (tests/data/torch_driver_meridian32.npz).
15. driver_f32_full - the offline driver in float32 at 6144 columns (the
               meridian file tiled, written by io/save_extras.save_inputs),
               nrepeat 3, with the host and with the device generator:
               cols/s, stage times (profiling hooks), peak device memory;
               every tiled copy of a column against the first; then
               python -m ecrad_torch.evaluate.compare_output on the host
               generator's float32 file against a float64 run's, with
               heating rates, at --threshold-lw 0.5 --threshold-sw 0.5
               (ecRad's evaluation layer, without JAX).
16. ifs_f64, ifs_f32_full - the IFS driver (ecrad_torch.ifs.driver.run_ifs)
               on the 32 columns in float64, with --bitidentity and
               without (device generator), against the JAX IFS driver's
               outputs (tests/data/torch_ifs_meridian32.npz), and with
               --nproma 8 against the unblocked run; then at 6144 columns
               in float32 with --nproma 2048: cols/s, peak memory.
17. sharded    - pipeline.radiation_sharded of the flagship at 6144 columns
               in float32 over pipeline.make_mesh() (the one card, blocks
               of 2048) and over (cuda:0,) * 3 (three slabs of 2048),
               each equal to radiation_blocked's fluxes bit for bit.
18. distributed - two ranks (tests/torch_dist_worker.py) spawned on the
               one card, joined with gloo (ecrad_torch.distributed), each
               reading its slab of the 6144-column file the script wrote;
               their fluxes concatenated equal one process's
               radiation_sharded over two slabs, bit for bit.
The full phases from 6 on also report the peak device memory of the run.
The kernels' launch counters are reset just before each main path (5b,
the *_full phases, sharded) and read just after it.

Then one JSON line with the per-kernel results, the nvidia-smi line, and
as the last line {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import functools
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from ecrad_torch import constants, driver, flagship, kernels, pipeline
from ecrad_torch import profiling
from ecrad_torch.config import Entrapment, Overlap, Solver
from ecrad_torch.containers import Flux
from ecrad_torch.interface import (_optical_properties, radiation,
                                   setup_radiation, spartacus_lw_inputs,
                                   spartacus_sw_inputs)
from ecrad_torch.optics import cuda_rrtmg, rrtmg
from ecrad_torch.optics.rrtmg_prepare import GasColumns
from ecrad_torch.solvers import cloud_generator, cuda_adding, cuda_generator
from ecrad_torch.solvers import cuda_mcica, cuda_spartacus, cuda_tripleclouds
from ecrad_torch.solvers import mcica, spartacus, tripleclouds, two_stream
from ecrad_torch.data import DATA_DIR, MERIDIAN_INPUT
from ecrad_torch.ifs.driver import run_ifs
from ecrad_torch.io.input import DriverConfig, read_input
from ecrad_torch.io.save_extras import save_inputs

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")
REFERENCE = os.path.join(DATA, "torch_flagship_meridian32.npz")
# the configurations after the flagship: (phase tag, reference file)
SLICES = {"tripleclouds_rrtmg": ("tc", "torch_tripleclouds_meridian32.npz"),
          "cloudless_rrtmg": ("cl", "torch_cloudless_meridian32.npz"),
          "homogeneous_rrtmg": ("hom", "torch_homogeneous_meridian32.npz"),
          "spartacus_3d": ("sp", "torch_spartacus_meridian32.npz"),
          "tripleclouds_ecckd": ("tc_ecckd",
                                 "torch_tripleclouds_ecckd_meridian32.npz"),
          "ecckd_mcica": ("ecckd", "torch_ecckd_mcica_meridian32.npz"),
          "tripleclouds_baran2016": (
              "tc_baran", "torch_tripleclouds_baran2016_meridian32.npz"),
          "mcica_rrtmg_spectral": ("spec",
                                   "torch_mcica_spectral_meridian32.npz"),
          "tripleclouds_ecckd_gpoint": (
              "tc_gpt", "torch_tripleclouds_ecckd_gpoint_meridian32.npz"),
          "cloudless_rrtmg_spectral": (
              "cl_spec", "torch_cloudless_spectral_meridian32.npz"),
          "homogeneous_rrtmg_spectral": (
              "hom_spec", "torch_homogeneous_spectral_meridian32.npz"),
          "monochromatic_homogeneous": (
              "mono", "torch_monochromatic_meridian32.npz"),
          "spartacus_ecckd": ("sp_ecckd",
                              "torch_spartacus_ecckd_meridian32.npz")}
# the JAX float32 stochastic sample of a McICA reference file
SAMPLE_KEYS = ("od_scaling_sw", "od_scaling_lw", "total_cloud_cover_sw",
               "total_cloud_cover_lw")
NLEV = 137
SHAPES = (2048, 2049)         # the bench block, and a ragged column count
SAMPLED_NCOL = 8192           # the slab cells' block (generator_draw_sample)
FULL_NCOL, FULL_BLOCK = 6144, 2048
DEV = torch.device("cuda")

# Kernel vs plain version on the same inputs: the generator's draws and scan
# are pure selection, so its zero pattern is exact, and its sampler rounds
# through another libm; the sweeps sum over g in another order (block tree vs
# torch.sum) and the kernels contract multiply-adds into FMAs (all but
# sw_fused, whose coefficients need the plain version's rounding:
# kernels.SOURCE_FLAGS), so f64 agrees to roundoff: rtol 1e-10 (with a floor of
# 1e-10 of the output's largest value, for entries that are zero to roundoff).
# In f32 the SW sweeps themselves carry a few 1e-4 of relative rounding error
# against f64, so two f32 evaluations in another order differ by as much.  The
# f32 inputs are the f64 ones rounded, and each output passes if the kernel
# agrees with the plain f32 version within 1e-3 (W m-2 for fluxes) or 1e-4 of
# the output's largest value, or else is no further from the plain f64 result
# than F32_VS_F64 times the plain f32 version is.
F64_RTOL = 1e-10
# ... and 1e-12 for the RRTMG gas optics, whose sums of table rows carry no
# recurrence
F64_RTOL_OF = {"rrtmg_lw_taumol": 1e-12, "rrtmg_sw_taumol": 1e-12,
               # ... and 1e-13 for the generator's cumulator, which rounds
               # op for op as its plain version (kernels.SOURCE_FLAGS); its
               # float32 outputs must equal the plain version's bit for bit
               # (check_kernel)
               "generator_cumulate": 1e-13}
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
# ... except where the JAX float32 run (on the CPU, as the reference file
# holds it) is itself further than that from the JAX float64 one: in
# spartacus_3d by 8 W m-2 in lw_dn, in spartacus_ecckd by 3.0e4 W m-2 in
# lw_up (the 6x6 LW exponential's sources in single precision, which the
# port computes in float64).  There the float32 slice is held to the
# float64 fluxes at the same bar, and its distance to the JAX float32
# fluxes is only reported.
F32_HELD_TO = {"spartacus_3d": "f64/", "spartacus_ecckd": "f64/"}
DIMLESS = ("lw_derivatives", "cloud_cover_lw", "cloud_cover_sw")
# The drivers' output files against the JAX drivers': float64 within 1e-6
# W m-2 and 1e-9 for the dimensionless fields (DRIVER_DIMLESS), float32
# within ecRad's 0.5 W m-2 (1e-4 dimensionless, as the slices); blocked
# IFS runs against the unblocked one within 1e-9; the tiled copies of a
# column in the full runs against the first within 1e-3 W m-2
DRIVER_F64_ATOL, DRIVER_F64_ATOL_DIMLESS = 1e-6, 1e-9
DRIVER_DIMLESS = ("lw_derivative", "cloud_cover_lw", "cloud_cover_sw",
                  "emissivity_out")
NPROMA_ATOL = 1e-9
TILE_ATOL = 1e-3
DRIVER_NREPEAT = 3
# the driver stages read from the profiling hooks
DRIVER_STAGES = ("ecrad_driver:read_input", "ecrad_driver:check_inputs",
                 "ecrad_driver:cloud_generator_exact",
                 "ecrad_driver:copy_to_device",
                 "ecrad_driver:radiation[first_call+compile]",
                 "ecrad_driver:radiation", "ecrad_driver:copy_to_host",
                 "ecrad_driver:save_fluxes")
# The g-point profiles of the SPARTACUS step summed over g against its
# broadband fluxes (the same fluxes summed in another order): W m-2
GPOINT_SUM_ATOL = 1e-9

KERNELS = {
    "generator_draw_sample": dict(
        wrapper=cuda_generator.generator_draw_scan,
        plain=cuda_generator.generator_draw_scan_plain,
        source="ecrad_torch/csrc/generator_scan.cu",
        replaces="ecrad_tpu/solvers/pallas_generator.py:98, the draw at "
                 "ecrad_tpu/solvers/cloud_generator.py:451 and its sampling "
                 "epilogue"),
    "generator_cumulate": dict(
        wrapper=cuda_generator.generator_cumulate,
        plain=cuda_generator.generator_cumulate_plain,
        source="ecrad_torch/csrc/generator_cumulate.cu",
        replaces="no TPU kernel (XLA runs ecrad_tpu/solvers/"
                 "cloud_generator.py:26 cum_cloud_cover_exp_ran_jnp)"),
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
    "lw_noscat_sweeps": dict(
        wrapper=cuda_adding.lw_noscat_sweeps,
        plain=cuda_adding.lw_noscat_sweeps_plain,
        source="ecrad_torch/csrc/adding_sweeps.cu",
        replaces="ecrad_tpu/solvers/pallas_adding.py:85"),
    "scat_sweeps": dict(
        wrapper=cuda_adding.scat_sweeps, plain=cuda_adding.scat_sweeps_plain,
        source="ecrad_torch/csrc/adding_sweeps.cu",
        replaces="ecrad_tpu/solvers/pallas_adding.py:187"),
    "sw_sweeps": dict(
        wrapper=cuda_adding.sw_sweeps, plain=cuda_adding.sw_sweeps_plain,
        source="ecrad_torch/csrc/adding_sweeps.cu",
        replaces="ecrad_tpu/solvers/pallas_adding.py:314"),
    "spartacus_sw": dict(
        wrapper=cuda_spartacus.sw_sweeps,
        plain=cuda_spartacus.sw_sweeps_plain,
        source="ecrad_torch/csrc/spartacus_sw.cu",
        replaces="ecrad_tpu/solvers/pallas_spartacus.py:179"),
    "spartacus_lw": dict(
        wrapper=cuda_spartacus.lw_sweeps,
        plain=cuda_spartacus.lw_sweeps_plain,
        source="ecrad_torch/csrc/spartacus_lw.cu",
        replaces="ecrad_tpu/solvers/pallas_spartacus.py:346"),
    "spartacus_sw_mats": dict(
        wrapper=cuda_spartacus.sw_layer_mats,
        plain=spartacus._sw_layer_mats,
        source="ecrad_torch/csrc/spartacus_layer_mats.cu",
        replaces="no TPU kernel (XLA builds ecrad_tpu/solvers/spartacus.py's "
                 "SW layer matrices)"),
    "spartacus_lw_mats": dict(
        wrapper=cuda_spartacus.lw_layer_mats,
        plain=spartacus._lw_layer_mats,
        source="ecrad_torch/csrc/spartacus_layer_mats.cu",
        replaces="no TPU kernel (XLA builds ecrad_tpu/solvers/spartacus.py's "
                 "LW layer matrices)"),
    "rrtmg_lw_taumol": dict(
        wrapper=cuda_rrtmg.lw_taumol, plain=cuda_rrtmg.lw_taumol_plain,
        source="ecrad_torch/csrc/rrtmg_gas.cu",
        replaces="no TPU kernel (XLA runs ecrad_tpu/optics/rrtmg_lw.py)"),
    "rrtmg_sw_taumol": dict(
        wrapper=cuda_rrtmg.sw_taumol, plain=cuda_rrtmg.sw_taumol_plain,
        source="ecrad_torch/csrc/rrtmg_gas.cu",
        replaces="no TPU kernel (XLA runs ecrad_tpu/optics/rrtmg_sw.py)"),
}
# The RRTMG gas optics: one launch of each kernel a block on every path with
# RRTMG gas optics, none on the ecCKD and monochromatic ones
RRTMG = dict(rrtmg_lw_taumol=1, rrtmg_sw_taumol=1)
# The McICA generator on the card: two launches of each of its kernels a
# block, one a band set
GENERATOR = dict(generator_draw_sample=2, generator_cumulate=2)
# SPARTACUS: the two sweeps a block, and one launch set of the layer
# matrices' kernels (build and refine passes) a band set
SPARTACUS = dict(spartacus_sw=1, spartacus_lw=1, spartacus_sw_mats=1,
                 spartacus_lw_mats=1)
LAYER_MATS = ("spartacus_sw_mats", "spartacus_lw_mats")
# Each main path's launches per 2048-column block (all others 0); a
# kernel's reported launches are those read in the first path listed here
# that names it.
MAIN_PATHS = {
    "mcica_rrtmg": dict(**GENERATOR, lw_fused=1, sw_fused=1, **RRTMG),
    "tripleclouds_rrtmg": dict(tripleclouds_lw=1, tripleclouds_sw=1,
                               **RRTMG),
    "cloudless_rrtmg": dict(lw_noscat_sweeps=1, sw_sweeps=1, **RRTMG),
    "homogeneous_rrtmg": dict(scat_sweeps=2, sw_fused=1, **RRTMG),
    "spartacus_3d": dict(**SPARTACUS, **RRTMG),
    "tripleclouds_ecckd": dict(tripleclouds_lw=1, tripleclouds_sw=1),
    "ecckd_mcica": dict(**GENERATOR, lw_fused=1, sw_fused=1),
    "tripleclouds_baran2016": dict(tripleclouds_lw=1, tripleclouds_sw=1,
                                   **RRTMG),
    "mcica_rrtmg_spectral": dict(**GENERATOR, lw_fused=1,
                                 sw_fused=1, **RRTMG),
    "tripleclouds_ecckd_gpoint": dict(tripleclouds_lw=1, tripleclouds_sw=1),
    "cloudless_rrtmg_spectral": dict(lw_noscat_sweeps=1, sw_sweeps=1,
                                     **RRTMG),
    "homogeneous_rrtmg_spectral": dict(scat_sweeps=2, sw_fused=1, **RRTMG),
    "monochromatic_homogeneous": dict(lw_fused=1, sw_fused=1),
    "spartacus_ecckd": dict(**SPARTACUS),
}
# The kernels that write per-g planes on request (planes=True)
PLANES = ("lw_fused", "sw_fused", "tripleclouds_lw", "tripleclouds_sw",
          "lw_noscat_sweeps", "scat_sweeps", "sw_sweeps")

# The least time of a kernel's work on one H100 SXM (NVIDIA's published
# peaks, dense, at 700 W): each input read once and each output
# written once at 3.35 TB/s, or its operations at 67 TFLOP/s (float32
# outside the tensor cores), whichever is longer.
PEAK_BYTES_S, PEAK_F32_OPS_S = 3.35e12, 67e12
# The integer issue rate: an SM of compute capability 9.0 issues one warp
# instruction per clock in each of its 4 partitions, 128 thread
# instructions per clock whatever pipe runs them, times the SMs torch
# reports (132 on an H100 SXM) and the maximum SM clock nvidia-smi reports
# (clocks.max.sm, 1980 MHz there): 132 x 128 x 1.98e9 = 33.5e12
# instructions per second.  (The integer ALU pipe has 64 lanes per SM, the
# CUDA C++ Programming Guide's throughput table; but adds also run on the
# FMA pipe as IMAD.IADD and rotates as IMAD.SHL with IMAD.HI, so only the
# xors are tied to it: 20 of a hash's 70 instructions at half the rate,
# which never takes longer than the 70 at the issue rate.)
ISSUE_PER_SM_CLOCK = 128


@functools.lru_cache(maxsize=None)
def sm_clock_mhz():
    """The card's maximum SM clock, as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


def issue_per_s():
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ISSUE_PER_SM_CLOCK * sm_clock_mhz() * 1e6


# Operations per (column, layer, g-point), counted from the plain
# versions' arithmetic done once (each add, multiply, divide, comparison,
# select, exp and sqrt one operation), and the extra per cloudy (column,
# layer, g-point).  Two-stream coefficients: LW no-scattering 15,
# lw_ref_trans 43, LW cloud merge 11, sw_ref_trans 105, SW merge 16,
# delta-Eddington 9.  Sweeps: an affine step with its broadband sum 3, the
# Moebius up step 12, the adding down step with its two sums 12, the SW
# direct step 2 and its two sources 3; a 3x3 region mix 5 per region.
OPS = {
    # the scan, and the exact "- 1" of each of the three draws, 23; and
    # the sampling epilogue per cloudy element (counted as every
    # element of a cloudy layer): ndtri's central branch ~31 (a tail's ~45
    # with two logs and a sqrt), the clamps and t 7, the fsd interpolation
    # of 15 coefficients ~56, the Clenshaw sum 46, exp and the masks 4
    "generator_draw_sample": lambda args, f: 23 + 160 * f(args[1][..., 0]),
    # per (column, level): the pair cover 8, the clear-sky product with its
    # clamp, division and select 6, the cover and overhang 2, the
    # inhomogeneity overlap 4 and the cloud flag 1
    "generator_cumulate": lambda args, f: 21,
    # clear 15 + sweeps 3+3+12+12 + derivatives 4; cloudy: merge + ref_trans
    "lw_fused": lambda args, f: 49 + 54 * f(args[5]),
    # clear ref_trans 105 + two scenes' SW sweeps 2 x 29; cloudy: merge +
    # ref_trans; delta-Eddington on both scenes
    "sw_fused": lambda args, f: (163 + 121 * f(args[7])
                                 + (9 * (1 + f(args[7])) if args[-1] else 0)),
    # clear 15 + clear sweeps 6 + region 0 up/down 24 + derivatives 4 +
    # ... the other two regions' sweeps 48; cloudy: two merges and
    # ref_trans 108, up/down/derivative mixes 66
    "tripleclouds_lw": lambda args, f: 97 + 174 * (1 - f(args[5])),
    # clear ref_trans 105 + clear and region 0 sweeps 2 x 26; cloudy: two
    # merges and ref_trans 242, the other regions' sweeps 52, mixes 60
    "tripleclouds_sw": lambda args, f: (157 + 354 * (1 - f(args[7]))
                                        + (18 * (1 - f(args[7]))
                                           if args[-1] else 0)),
    "lw_noscat_sweeps": lambda args, f: 6,
    "scat_sweeps": lambda args, f: 24,
    "sw_sweeps": lambda args, f: 29,
    # the SPARTACUS 3x3 region adding: about 700 (SW: matrix products, a
    # 3x3 LU and solves, the overlap and entrapment mixes, the clear-sky
    # sweeps) and 400 (LW) operations, which even five times over stay
    # below the bytes of the 50 (SW) and 24 (LW) layer planes
    "spartacus_sw": lambda args, f: 700,
    "spartacus_lw": lambda args, f: 400,
    # the layer matrices: every element computes region 0's sw_ref_trans
    # (105) or lw_ref_trans with the unscaled Planck terms (45) for the
    # clear-sky planes; an element not refined also region 0's LW sources
    # with the scaled ones (15), and in a cloudy layer two region merges
    # (12 each) and the other two regions' coefficients; a refined one the
    # merges, the LW side emissivity (15) and the refinement, counted from
    # csrc/spartacus_layer_mats.cu without its squarings (747 operations
    # each in SW, 396 in LW), which depend on each element's norm: SW
    # ~5,300 (four 9x9 block-triangular products 2,988, the Pade sums 756,
    # the blockwise solve 1,000, the rest ~550), LW ~3,250 float64
    # operations (four 6x6 products 1,584, two 6x6 LUs and eight solves
    # 790, the rest ~880), counted twice: the card's float64 rate is half
    # its float32 rate
    "spartacus_sw_mats": lambda args, f: (
        105 + (1.0 - f(args[12])) * 2 * (105 + 12) * (1 - f(args[13]))
        + (2 * 12 + 5300) * f(args[12])),
    "spartacus_lw_mats": lambda args, f: (
        45 + (1.0 - f(args[15])) * (15 + 2 * (45 + 12) * (1 - f(args[12])))
        + (2 * 12 + 15 + 2 * 3250) * f(args[15])),
    # a multiply-add per term of the (row, band): ~16 (LW: od and Planck
    # fraction) and ~10 (SW: od and Rayleigh) on the meridian state, and
    # the clamp and the Planck product or the ssa division
    "rrtmg_lw_taumol": lambda args, f: 35,
    "rrtmg_sw_taumol": lambda args, f: 23,
}
# Integer instructions of the generator's draws, at the least: a
# Threefry-2x32 hash of 20 rounds (csrc/generator_scan.cu threefry2x32)
# takes 3 a round (an add, a rotate, an xor: no instruction does two of
# them) and 7 adds that inject the key (x1's first and four middle
# injections, both words' last; x0's middle ones fold into the next
# round's three-input add), 67; a draw adds 3 for the mantissa, 70.  The
# work is 3 draws per (column, layer, g-point), the trigger's per
# (column, g-point) and the 4 key splits per column.
HASH_INSTR, DRAW_INSTR = 20 * 3 + 7, 20 * 3 + 7 + 3
INT_OPS = {
    "generator_draw_sample": lambda ncol, nlev, ng: (
        ncol * ng * (nlev * 3 + 1) * DRAW_INSTR + ncol * 4 * HASH_INSTR),
}


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def reset_counts():
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    for name in LAYER_MATS:
        KERNELS[name]["wrapper"].refined = 0


def refined_shares(config, ncol):
    """{kernel: share} of the (column, layer, g-point) elements of ncol
    columns given the 3D exponential since the counters' reset, read from
    the layer-matrix wrappers' running totals (a host read)."""
    ng = {"spartacus_sw_mats": config.n_g_sw,
          "spartacus_lw_mats": config.n_g_lw}
    return {name: int(KERNELS[name]["wrapper"].refined)
            / (ncol * NLEV * ng[name]) for name in LAYER_MATS}


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

def random_state(ncol, dtype, seed, config_name="mcica_rrtmg",
                 min_cloud=0.0):
    """A configuration's step for the meridian slice tiled to ncol columns,
    with a random state per column from a numpy seed: solar zenith (night
    included), skin temperature, humidity scaling, cloud-fraction scaling
    (the fraction raised to min_cloud everywhere, and then the liquid water
    to 1e-6 kg/kg: 0.2 makes every layer cloudy) and generator seeds.
    Returns (step, inputs without the cloud, cloud)."""
    rng = np.random.default_rng(seed)
    step, args = flagship.build(ncol=ncol, dtype=dtype, device=DEV,
                                config_name=config_name)
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
    cloud["fraction"] = torch.clamp(
        cloud["fraction"] * t(rng.uniform(0.5, 1.0, (ncol, 1))),
        min=min_cloud)
    if min_cloud > 0.0:   # condensate too, or the optics clear the layer
        cloud["q_liq"] = torch.clamp(cloud["q_liq"], min=1e-6)
    cloud["iseed"] = torch.as_tensor(rng.integers(1, 2**31 - 1, ncol),
                                     device=DEV)
    return step, kw, cloud


@contextlib.contextmanager
def layer_mats_args():
    """Record the arguments of the cuda_spartacus.sw_layer_mats and
    lw_layer_mats calls made inside: {"spartacus_sw_mats": arguments,
    "spartacus_lw_mats": arguments}, the last call's of each.  Their
    launches inside are counted on the spies (a wrapper counts through its
    module's name), not on the wrappers."""
    seen, real = {}, {}
    for name in LAYER_MATS:
        fn = KERNELS[name]["wrapper"]
        real[fn.__name__] = fn

        def spy(*args, _name=name, _fn=fn):
            seen[_name] = args
            return _fn(*args)
        spy.launches = spy.refined = 0
        setattr(cuda_spartacus, fn.__name__, spy)
    try:
        yield seen
    finally:
        for attr, fn in real.items():
            setattr(cuda_spartacus, attr, fn)


def sweep_args_inputs(ncol, dtype, seed, min_cloud=0.0,
                      config_name="spartacus_3d"):
    """The arguments of spartacus.sw_sweep_args and lw_sweep_args, {"sw":
    arguments, "lw": arguments}, as the path of config_name (spartacus_3d
    or spartacus_ecckd) builds them for the random state of
    random_state."""
    step, kw, cloud = random_state(ncol, dtype, seed, config_name,
                                   min_cloud)
    config, tables = step.config, step.tables
    op = _optical_properties(config, tables, solar_irradiance=step.solar,
                             cloud=cloud, **kw)
    levels = (kw["pressure_hl"], kw["temperature_hl"])
    return {"sw": spartacus_sw_inputs(config, tables, op, cloud, *levels,
                                      kw["cos_sza"])[1],
            "lw": spartacus_lw_inputs(config, tables, op, cloud, *levels)[1]}


def spartacus_inputs(ncol, dtype, seed, min_cloud=0.0,
                     config_name="spartacus_3d"):
    """The SPARTACUS sweeps' inputs as the path of config_name
    (spartacus_3d or spartacus_ecckd) builds them for the random state of
    random_state: [SW in Explicit (the path's), Maximum and Edge-only
    entrapment], [LW without (the path's) and with multilayer effects],
    each (label, arguments); and the layer matrices' arguments,
    {"spartacus_sw_mats": arguments, "spartacus_lw_mats": arguments}."""
    inputs = sweep_args_inputs(ncol, dtype, seed, min_cloud, config_name)
    with layer_mats_args() as mats:
        sw_opts, sw, _ = spartacus.sw_sweep_args(*inputs["sw"])
        lw_opts, lw, _ = spartacus.lw_sweep_args(*inputs["lw"])
    if sw_opts.mode != Entrapment.EXPLICIT or lw_opts.multilayer:
        raise AssertionError(f"{config_name} runs {sw_opts}, {lw_opts}")
    return ([(m.name.lower(), (sw_opts._replace(mode=m), *sw))
             for m in (Entrapment.EXPLICIT, Entrapment.MAXIMUM,
                       Entrapment.EDGE_ONLY)],
            [("meridian", (lw_opts, *lw)),
             ("multilayer", (lw_opts._replace(multilayer=True), *lw))],
            mats)


def everywhere(config, name, args):
    """A layer-matrix kernel's arguments with the use_expm mask of
    use_expm_everywhere (the ng3D prefix in every layer, clear ones too;
    on the gas's optical depth, the first argument)."""
    i = 12 if name == "spartacus_sw_mats" else 15
    use = spartacus._use_expm_mask(config.replace(use_expm_everywhere=True),
                                   args[0], None)
    return args[:i] + (use,) + args[i + 1:]


def layer_mats_inputs(ncol, dtype, seed):
    """{kernel: [(label, arguments)]} of the two layer-matrix kernels, a
    group of their own (their outputs at RRTMG widths are gigabytes): as
    the spartacus_3d path builds them for the random state of random_state
    ("meridian", the main path's; "everywhere" with use_expm_everywhere's
    mask), and on spartacus_ecckd at 32 g-points ("ecckd").  Not on the
    all-cloudy state: there the float32 SW exponential of the top layers
    (od ~1e-8, the largest transfer rates) overflows in the plain build,
    and so, bit for bit, in the kernel."""
    config = flagship.flagship_config("float64", "spartacus_3d")
    mats = spartacus_inputs(ncol, dtype, seed)[2]
    ecckd = spartacus_inputs(ncol, dtype, seed,
                             config_name="spartacus_ecckd")[2]
    return {name: [("meridian", mats[name]),
                   ("everywhere", everywhere(config, name, mats[name])),
                   ("ecckd", ecckd[name])]
            for name in LAYER_MATS}


def layer_mats_slab_inputs(ncol, dtype, seed):
    """{kernel: [(label, arguments)]} of the two layer-matrix kernels on
    spartacus_ecckd at ncol columns (labels ecckd_<ncol>)."""
    mats = spartacus_inputs(ncol, dtype, seed,
                            config_name="spartacus_ecckd")[2]
    return {name: [(f"ecckd_{ncol}", mats[name])] for name in LAYER_MATS}


def seed_sets(ncol):
    """The seeds of the generator's input sets, (ncol,) on the card: the
    meridian file's (tiled), the same + 997 (the LW stream,
    pipeline.LW_SEED_OFFSET), and "edge": 0, from 2^31 up and from
    2^32 - 1 down, in turns with the meridian file's."""
    inp = read_input(MERIDIAN_INPUT, DriverConfig(**flagship.DRIVER_SETTINGS))
    real = np.resize(inp.iseed.astype(np.int64), ncol)
    edge = real.copy()
    edge[0::4] = 0
    edge[1::4] = 2**31 + np.arange(edge[1::4].size)
    edge[2::4] = 2**32 - 1 - np.arange(edge[2::4].size)
    return {k: torch.as_tensor(v, device=DEV) for k, v in (
        ("meridian", real), ("meridian_lw", real + pipeline.LW_SEED_OFFSET),
        ("edge", edge))}


def generator_inputs(config, tables, cloud, sets):
    """[(label, arguments)] of the generator kernel for the cloud of
    random_state, one per (label, overlap scheme, seed_sets key, ng) of
    sets, the scalars from the main path's route (scan_scalars: on the
    card the cumulator kernel, generator_cumulate, but for Exp-Exp), each
    with the sampler's inputs (fractional standard deviation,
    Chebyshev fit, cloud-fraction threshold), and the first again as
    "fsd_spread", its fractional standard deviation scaled over the
    levels from 0 to 4.5 (the fit's axis ends at 4), so that the
    interpolation and its clamps are taken."""
    seeds = seed_sets(cloud["fraction"].shape[0])
    fsd = cloud["fractional_std"]
    fit = tables.pdf_sampler["cheb_fit"]
    thr = config.cloud_fraction_threshold
    out = []
    for label, overlap, seed, ng in sets:
        scalars, exp_exp, tcc = cloud_generator.scan_scalars(
            config.replace(overlap_scheme=overlap), cloud["fraction"],
            cloud["overlap_param"])
        out.append((label, (seeds[seed], scalars, tcc, ng, exp_exp, fsd,
                            fit, thr)))
    spread = fsd * torch.linspace(0.0, 4.5, fsd.shape[1], dtype=fsd.dtype,
                                  device=fsd.device)
    return out + [("fsd_spread", out[0][1][:5] + (spread, fit, thr))]


def cumulate_inputs(config, cloud, suffix=""):
    """[(label, arguments)] of the generator's cumulator for the cloud of
    random_state: Exponential-Random and Maximum-Random overlap at the
    configuration's decorrelation scaling (0.5: the exponent 2, x * x), and
    Exponential-Random at 2.0 (the exponent 0.5, sqrt) and 0.8 (1.25,
    pow)."""
    frac, op = cloud["fraction"], cloud["overlap_param"]
    thr = config.cloud_fraction_threshold
    decorr = config.cloud_inhom_decorr_scaling
    return [(label + suffix, (frac, op, max_ran, d, thr))
            for label, max_ran, d in (("exp_ran", False, decorr),
                                      ("max_ran", True, decorr),
                                      ("decorr_sqrt", False, 2.0),
                                      ("decorr_pow", False, 0.8))]


def sample_inputs(ncol, dtype, seed):
    """{"generator_draw_sample": [(label, arguments)]} at the main paths'
    widths for the random state of random_state: the LW stream at 140
    g-points and the SW one at 112 on mcica_rrtmg, and the LW one at 32 on
    ecckd_mcica; and {"generator_cumulate": ...}, cumulate_inputs on the
    mcica_rrtmg state (labels ending in _<ncol>)."""
    out, cumulate = [], []
    for config_name, sets in (
            ("mcica_rrtmg", (("lw", "meridian_lw", "n_g_lw"),
                             ("sw", "meridian", "n_g_sw"))),
            ("ecckd_mcica", (("ecckd", "meridian_lw", "n_g_lw"),))):
        step, _, cloud = random_state(ncol, dtype, seed, config_name)
        config = step.config
        out += generator_inputs(config, step.tables, cloud, [
            (label, config.overlap_scheme, seed_set, getattr(config, ng))
            for label, seed_set, ng in sets])[:len(sets)]
        if config_name == "mcica_rrtmg":
            cumulate = cumulate_inputs(config, cloud, f"_{ncol}")
    return {"generator_draw_sample": out, "generator_cumulate": cumulate}


def rrtmg_inputs(step, kw):
    """The arguments of the two RRTMG gas optics kernels for a state of
    random_state, as rrtmg.gas_optics passes them: (LW, SW)."""
    config, tables = step.config, step.tables.gas["rrtmg"]
    gas = {name: kw["gas_mmr"][:, :, i]
           for name, i in constants.GAS_INDEX.items()}
    cols = rrtmg.gas_columns(tables, kw["pressure_hl"], kw["temperature_hl"],
                             gas)
    return ((tables, cols, kw["temperature_hl"], kw["skin_temperature"],
             config.min_gas_od_lw),
            (tables, cols, config.min_gas_od_sw))


def fused_inputs(step, kw, cloud, op):
    """The arguments of the fused McICA and Tripleclouds kernels for a
    McICA step's state (with its cloud sample) and optical properties."""
    config, tables = step.config, step.tables
    cl, go, thr = op["cl"], op["go"], config.cloud_fraction_threshold
    emission = go.lw_emission * (1.0 - op["lw_albedo_g"])
    tc = config.replace(sw_solver=Solver.TRIPLECLOUDS,
                        lw_solver=Solver.TRIPLECLOUDS)
    return {
        "lw_fused": mcica.lw_fused_args(
            op["od_lw"], cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
            tables.band_from_g_lw, cloud["od_scaling_lw"], op["frac"],
            go.planck_hl, emission, op["lw_albedo_g"], thr,
            config.do_lw_derivatives),
        "sw_fused": mcica.sw_fused_args(
            op["od_sw"], op["ssa_sw"], op["g_sw_arr"], cl["od_sw"],
            cl["ssa_sw"], cl["g_sw"], tables.band_from_g_sw,
            cloud["od_scaling_sw"], op["frac"], go.incoming_sw,
            kw["cos_sza"], op["sw_albedo_diffuse_g"],
            op["sw_albedo_direct_g"], thr,
            config.do_sw_delta_scaling_with_gases),
        "tripleclouds_lw": tripleclouds.lw_fused_args(
            tc, op["od_lw"], cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
            tables.band_from_g_lw, op["frac"], cloud["fractional_std"],
            cloud["overlap_param"], go.planck_hl, emission,
            op["lw_albedo_g"])[0],
        "tripleclouds_sw": tripleclouds.sw_fused_args(
            tc, op["od_sw"], op["ssa_sw"], op["g_sw_arr"], cl["od_sw"],
            cl["ssa_sw"], cl["g_sw"], tables.band_from_g_sw, op["frac"],
            cloud["fractional_std"], cloud["overlap_param"],
            go.incoming_sw, kw["cos_sza"], op["sw_albedo_diffuse_g"],
            op["sw_albedo_direct_g"])[0]}


def total_scene_inputs(step, kw, cloud, op):
    """The scat_sweeps and sw_sweeps arguments of the total scene as the
    unfused McICA path builds them (mcica.solver_mcica_lw with LW aerosol
    scattering on, as the Homogeneous path runs it, and solver_mcica_sw)
    for a McICA step's state (with its cloud sample) and optical
    properties: the merged cloud's coefficients in cloudy layers, the
    clear sky's elsewhere."""
    config, tables = step.config, step.tables
    cl, go = op["cl"], op["go"]
    mask = (op["frac"] >= config.cloud_fraction_threshold)[..., None]
    bl, bs = tables.band_from_g_lw, tables.band_from_g_sw
    pick = lambda total, clear: tuple(  # noqa: E731
        torch.where(mask, t, c).contiguous() for t, c in zip(total, clear))
    ptop, pbot = go.planck_hl[:, :-1], go.planck_hl[:, 1:]
    od, ssa, g = op["od_lw"], op["ssa_lw"], op["g_lw_arr"]
    merged = cuda_mcica.merge_cloud_lw(
        od, cloud["od_scaling_lw"] * cl["od_lw"][..., bl], mask,
        ssa_cloud_g=cl["ssa_lw"][..., bl], g_cloud_g=cl["g_lw"][..., bl],
        ssa_clear=ssa, g_clear=g, do_cloud_scattering=True,
        do_aerosol_scattering=True)
    emission = go.lw_emission * (1.0 - op["lw_albedo_g"])
    scat = pick(two_stream.lw_ref_trans(*merged, ptop, pbot),
                two_stream.lw_ref_trans(od, ssa, g, ptop, pbot)) \
        + (op["lw_albedo_g"].contiguous(), emission.contiguous())
    mu0 = torch.clamp(kw["cos_sza"], min=1.0e-10)[:, None, None]
    clear = (op["od_sw"], op["ssa_sw"], op["g_sw_arr"])
    total = cuda_mcica.merge_cloud_sw(
        *clear, cloud["od_scaling_sw"] * cl["od_sw"][..., bs],
        cl["ssa_sw"][..., bs], cl["g_sw"][..., bs], mask)
    if config.do_sw_delta_scaling_with_gases:
        clear = two_stream.delta_eddington(*clear)
        total = two_stream.delta_eddington(*total)
    sw = pick(two_stream.sw_ref_trans(mu0, *total),
              two_stream.sw_ref_trans(mu0, *clear)) \
        + (go.incoming_sw.contiguous(),
           op["sw_albedo_diffuse_g"].contiguous(),
           (op["sw_albedo_direct_g"] * mu0[:, :, 0]).contiguous())
    return {"scat_sweeps": scat, "sw_sweeps": sw}


def clear_sky_inputs(kw, op):
    """The lw_noscat_sweeps, scat_sweeps and sw_sweeps arguments on the
    clear-sky two-stream coefficients of a step's optical properties, as
    the Cloudless path (and the clear scene of the unfused McICA path)
    builds them."""
    go = op["go"]
    c = lambda xs: tuple(x.contiguous() for x in xs)  # noqa: E731
    ptop, pbot = go.planck_hl[:, :-1], go.planck_hl[:, 1:]
    emission = go.lw_emission * (1.0 - op["lw_albedo_g"])
    mu0 = torch.clamp(kw["cos_sza"], min=1.0e-10)[:, None]
    noscat = c(two_stream.lw_no_scattering_trans(op["od_lw"], ptop, pbot)
               + (emission, op["lw_albedo_g"]))
    scat = c(two_stream.lw_ref_trans(op["od_lw"], op["ssa_lw"], op["g_lw_arr"],
                                     ptop, pbot)
             + (op["lw_albedo_g"], emission))
    sw_clear = c(two_stream.sw_ref_trans(mu0[:, :, None], op["od_sw"],
                                         op["ssa_sw"], op["g_sw_arr"])
                 + (go.incoming_sw, op["sw_albedo_diffuse_g"],
                    op["sw_albedo_direct_g"] * mu0))
    return noscat, scat, sw_clear


def solver_inputs(ncol, dtype, seed, min_cloud=0.0):
    """The lw_fused, sw_fused, tripleclouds_lw, tripleclouds_sw,
    spartacus_sw (Explicit entrapment) and spartacus_lw (without multilayer
    effects: the spartacus_3d path's) arguments, and the total scene's
    scat_sweeps and sw_sweeps arguments (total_scene_inputs), for the random
    state of random_state; with min_cloud 0.2 every layer is cloudy
    ("all_cloudy"), which is checked."""
    step, kw, cloud = random_state(ncol, dtype, seed, min_cloud=min_cloud)
    cloud = pipeline.add_cloud_sample(step.config, step.tables, cloud)
    op = _optical_properties(step.config, step.tables,
                             solar_irradiance=step.solar, cloud=cloud, **kw)
    fused = fused_inputs(step, kw, cloud, op)
    out = {name: fused[name] for name in ("lw_fused", "sw_fused",
                                          "tripleclouds_lw",
                                          "tripleclouds_sw")}
    out.update(total_scene_inputs(step, kw, cloud, op))
    sp_sw, sp_lw, _ = spartacus_inputs(ncol, dtype, seed, min_cloud)
    out["spartacus_sw"], out["spartacus_lw"] = sp_sw[0][1], sp_lw[0][1]
    if min_cloud > 0.0 and (
            not bool(out["lw_fused"][5].all())
            or not bool(out["sw_fused"][7].all())
            or bool(out["tripleclouds_lw"][5].any())
            or bool(out["tripleclouds_sw"][7].any())
            or bool((out["spartacus_sw"][11][..., 0] != 0).any())
            or bool((out["spartacus_lw"][10][..., 0] != 0).any())):
        raise AssertionError("the all-cloudy inputs have clear layers")
    return out


def all_cloudy_inputs(ncol, dtype, seed):
    """{kernel: [("all_cloudy", arguments)]} for the kernels of
    solver_inputs, with every layer cloudy."""
    return {name: [("all_cloudy", args)]
            for name, args in solver_inputs(ncol, dtype, seed, 0.2).items()}


def ecckd_inputs(ncol, dtype, seed):
    """{kernel: [("ecckd", arguments)]} for the kernels of the ecCKD paths
    at their widths, from the random state of random_state on the
    ecckd_mcica configuration: the generator (generator_inputs, also in
    Exponential overlap on edge seeds) at 32 g-points, and the
    fused McICA and Tripleclouds kernels' arguments (fused_inputs) with
    32 g-points and per-g-point cloud optics (32 bands, band_of_g the
    identity), which is checked; and on spartacus_ecckd the SPARTACUS
    sweeps' arguments as its path builds them (spartacus_inputs: SW in
    Explicit entrapment, LW without multilayer effects) at 32 g-points."""
    step, kw, cloud = random_state(ncol, dtype, seed, "ecckd_mcica")
    config, tables = step.config, step.tables
    gen = generator_inputs(config, tables, cloud, (
        ("ecckd", Overlap.EXPONENTIAL_RANDOM, "meridian_lw", config.n_g_lw),
        ("ecckd_exp_exp_edge_seeds", Overlap.EXPONENTIAL, "edge",
         config.n_g_lw)))
    cloud = pipeline.add_cloud_sample(config, tables, cloud)
    op = _optical_properties(config, tables, solar_irradiance=step.solar,
                             cloud=cloud, **kw)
    out = fused_inputs(step, kw, cloud, op)
    for bfg in (tables.band_from_g_lw, tables.band_from_g_sw):
        if not torch.equal(bfg.cpu(), torch.arange(32)) \
                or op["cl"]["od_sw"].shape[-1] != 32:
            raise AssertionError("ecckd_mcica is not at 32 g-points and "
                                 "bands")
    sp_sw, sp_lw, _ = spartacus_inputs(ncol, dtype, seed,
                                       config_name="spartacus_ecckd")
    out["spartacus_sw"], out["spartacus_lw"] = sp_sw[0][1], sp_lw[0][1]
    for name in ("spartacus_sw", "spartacus_lw"):   # (opts, mats (.., ng))
        if out[name][1].shape[-1] != 32:
            raise AssertionError(f"spartacus_ecckd's {name} is not at 32 "
                                 f"g-points")
    return {"generator_draw_sample": gen,
            **{name: [("ecckd", args)] for name, args in out.items()}}


def mono_inputs(ncol, dtype, seed):
    """{kernel: [("ng1", arguments)]} for the six kernels of the
    monochromatic paths at one g-point and one band, from the random state
    of random_state on monochromatic_homogeneous with McICA solvers (its
    own setup, so that the PDF table loads): the generator
    (generator_inputs, also in Maximum-Random overlap on edge seeds) at
    ng = 1, the
    fused McICA kernels' arguments (fused_inputs) and the adding sweeps'
    on the clear sky (clear_sky_inputs), scat_sweeps and sw_sweeps also on
    the total scene (total_scene_inputs, "ng1_total_scene"); the width is
    checked."""
    step, kw, cloud = random_state(ncol, dtype, seed,
                                   "monochromatic_homogeneous")
    config, tables = setup_radiation(
        flagship.flagship_config(step.config.dtype_name,
                                 "monochromatic_homogeneous").replace(
            sw_solver=Solver.MCICA, lw_solver=Solver.MCICA),
        DEV, dtype, data_dir=DATA_DIR)
    step = types.SimpleNamespace(config=config, tables=tables,
                                 solar=step.solar)
    gen = generator_inputs(config, tables, cloud, (
        ("ng1", Overlap.EXPONENTIAL_RANDOM, "meridian", 1),
        ("ng1_max_ran_edge_seeds", Overlap.MAXIMUM_RANDOM, "edge", 1)))
    cloud = pipeline.add_cloud_sample(config, tables, cloud)
    op = _optical_properties(config, tables, solar_irradiance=step.solar,
                             cloud=cloud, **kw)
    fused = fused_inputs(step, kw, cloud, op)
    noscat, scat, sw_clear = clear_sky_inputs(kw, op)
    total = total_scene_inputs(step, kw, cloud, op)
    if config.n_g_sw != 1 or config.n_g_lw != 1 \
            or fused["lw_fused"][0].shape[-1] != 1 \
            or op["cl"]["od_sw"].shape[-1] != 1:
        raise AssertionError("the monochromatic inputs are not at one "
                             "g-point and one band")
    return {"generator_draw_sample": gen,
            "lw_fused": [("ng1", fused["lw_fused"])],
            "sw_fused": [("ng1", fused["sw_fused"])],
            "lw_noscat_sweeps": [("ng1", noscat)],
            "scat_sweeps": [("ng1", scat),
                            ("ng1_total_scene", total["scat_sweeps"])],
            "sw_sweeps": [("ng1", sw_clear),
                          ("ng1_total_scene", total["sw_sweeps"])]}


def kernel_inputs(ncol, dtype, seed):
    """Each kernel's inputs as the main path builds them, for the random
    state of random_state.  Returns {kernel: [(label, arguments)]}, the
    main path's first: the McICA kernels' (the generator on the LW
    stream's seeds at 140 g-points, then the SW stream's at 112 and the
    other overlap schemes and seeds; lw_fused also without
    derivatives, sw_fused also with delta-Eddington scaling of the gases)
    and, from the same optical properties, the Tripleclouds kernels'
    (tripleclouds_sw also with delta-Eddington scaling of the gases,
    tripleclouds_lw also without derivatives) and the adding sweeps' (on
    the clear-sky two-stream coefficients, as the Cloudless path builds
    them; scat_sweeps and sw_sweeps also on the total scene's,
    total_scene_inputs); the SPARTACUS sweeps' from spartacus_inputs;
    the RRTMG gas optics' from rrtmg_inputs."""
    step, kw, cloud = random_state(ncol, dtype, seed)
    config, tables = step.config, step.tables
    gen = generator_inputs(config, tables, cloud, (
        ("lw", Overlap.EXPONENTIAL_RANDOM, "meridian_lw", config.n_g_lw),
        ("sw", Overlap.EXPONENTIAL_RANDOM, "meridian", config.n_g_sw),
        ("exp_exp", Overlap.EXPONENTIAL, "meridian_lw", config.n_g_lw),
        ("max_ran", Overlap.MAXIMUM_RANDOM, "meridian", config.n_g_sw),
        ("edge_seeds", Overlap.EXPONENTIAL_RANDOM, "edge", config.n_g_lw)))
    cloud = pipeline.add_cloud_sample(config, tables, cloud)
    op = _optical_properties(config, tables, solar_irradiance=step.solar,
                             cloud=cloud, **kw)
    fused = fused_inputs(step, kw, cloud, op)
    sw, tc_lw, tc_sw = (fused[k] for k in ("sw_fused", "tripleclouds_lw",
                                           "tripleclouds_sw"))
    noscat, scat, sw_clear = clear_sky_inputs(kw, op)
    total = total_scene_inputs(step, kw, cloud, op)
    sp_sw, sp_lw, _ = spartacus_inputs(ncol, dtype, seed)
    rrtmg_lw, rrtmg_sw = rrtmg_inputs(step, kw)
    one = lambda args: [("meridian", args)]  # noqa: E731
    return {"generator_draw_sample": gen,
            "generator_cumulate": cumulate_inputs(config, cloud),
            "lw_fused": [("meridian", fused["lw_fused"]),
                         ("no_derivatives",
                          fused["lw_fused"][:-1] + (False,))],
            "sw_fused": [("meridian", sw), ("delta_gases", sw[:-1] + (True,))],
            "tripleclouds_lw": [("meridian", tc_lw),
                                ("no_derivatives", tc_lw[:-1] + (False,))],
            "tripleclouds_sw": [("meridian", tc_sw),
                                ("delta_gases", tc_sw[:-1] + (True,))],
            "lw_noscat_sweeps": one(noscat),
            "scat_sweeps": [("meridian", scat),
                            ("total_scene", total["scat_sweeps"])],
            "sw_sweeps": [("meridian", sw_clear),
                          ("total_scene", total["sw_sweeps"])],
            "spartacus_sw": sp_sw,
            "spartacus_lw": sp_lw,
            "rrtmg_lw_taumol": one(rrtmg_lw),
            "rrtmg_sw_taumol": one(rrtmg_sw)}


# --- phases -----------------------------------------------------------------

def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase("device", nvidia_smi=smi, clocks_max_sm_mhz=sm_clock_mhz(),
          issue_per_s=issue_per_s(), torch=torch.__version__,
          cuda=torch.version.cuda, gpu=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count())
    return smi


def build_phase():
    info = kernels.build()
    kernels.library()
    regs = [line.strip() for line in info["log"].splitlines()
            if "entry function" in line or "registers" in line
            or "spill" in line]
    phase("build", seconds=info["seconds"], library=info["path"],
          ptxas_registers=regs)


def _outputs(x, key="out"):
    """A kernel's outputs as {name: tensor}; nested tuples are flattened
    with their positions as names."""
    if isinstance(x, dict):
        return x
    if isinstance(x, (tuple, list)):
        out = {}
        for i, v in enumerate(x):
            out.update(_outputs(v, f"{key}[{i}]"))
        return out
    return {key: x}


def _compare_f64(got, ref, what="", rtol=F64_RTOL):
    """Max abs error of the f64 kernel against the f64 plain version."""
    got, ref = _outputs(got), _outputs(ref)
    if set(got) != set(ref):
        raise AssertionError(f"output keys differ: {set(got) ^ set(ref)}")
    worst = 0.0
    for k in ref:
        a, b = got[k], ref[k]
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        if not bool((err <= rtol * (b.abs() + b.abs().max())).all()):
            raise AssertionError(f"{what} {k}: f64 kernel differs from plain "
                                 f"by {float(err.max())}")
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
    return tuple(_f32_one(a) for a in args)


def _f32_one(a):
    """One argument rounded to float32: a float tensor, the tensors of a
    tuple, of the RRTMG gas columns and of a table dict; the rest as is."""
    if torch.is_tensor(a) and a.is_floating_point():
        return a.float()
    if isinstance(a, GasColumns):
        return GasColumns(*_f32(tuple(a)))
    if isinstance(a, dict):
        return {k: _f32_one(v) for k, v in a.items()}
    if isinstance(a, tuple) and not hasattr(a, "_fields"):
        return _f32(a)
    return a


def bound(name, args, out):
    """The least time (ms) the card could take for a kernel's work on
    these inputs, and which side bounds it: the bytes it must move (every
    input and output tensor once; for the SPARTACUS sweeps only the
    layer-matrix entries clear layers use, cuda_spartacus.sw_needed_bytes
    and lw_needed_bytes; for the RRTMG gas optics the fields, tables and
    outputs of rrtmg_needed_bytes) over the memory rate, or the
    operations (OPS, with
    the cloudy fraction of these inputs) over the float32 rate or the
    integer instructions (INT_OPS) over the issue rate, whichever is
    longer: each is a floor on its own.  bytes_all_tensors
    counts every byte of every tensor."""
    every = sum(t.numel() * t.element_size()
                for t in (*_outputs(args).values(), *_outputs(out).values())
                if torch.is_tensor(t))
    nbytes = every
    if name == "spartacus_sw":
        nbytes = cuda_spartacus.sw_needed_bytes(*args)
    elif name == "spartacus_lw":
        nbytes = cuda_spartacus.lw_needed_bytes(*args)
    elif name.startswith("rrtmg"):        # (tables, cols, ...)
        nbytes = rrtmg_needed_bytes(args, out)
    if name in LAYER_MATS:                # (od (ncol, nlev, ng), ...)
        ncol, nlev, ng = args[0].shape
    elif name.startswith("spartacus"):    # (opts, (nlev, 9, ncol, ng), ...)
        nlev, _, ncol, ng = args[1].shape
    elif name.startswith("rrtmg"):
        (ncol, nlev), ng = args[1].colh2o.shape, out[0].shape[-1]
    elif name.startswith("generator_draw"):   # (iseed, scalars, tcc, ng, ...)
        (ncol, nlev), ng = args[1].shape[:2], args[3]
    elif name == "generator_cumulate":        # (frac, overlap_param, ...)
        (ncol, nlev), ng = args[0].shape, 1
    else:
        ncol, nlev, ng = args[0].shape
    ops = OPS[name](args, lambda m: float(m.float().mean())) * ncol * nlev * ng
    int_ops = INT_OPS[name](ncol, nlev, ng) if name in INT_OPS else 0
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = max(ops / PEAK_F32_OPS_S, int_ops / issue_per_s())
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, bytes_all_tensors=every,
                bound_ms_all_tensors=1e3 * max(every / PEAK_BYTES_S, t_ops),
                operations=ops, int_operations=int_ops)


def rrtmg_needed_bytes(args, out):
    """The bytes an RRTMG gas optics kernel must move: the gas columns'
    fields it reads, the temperatures (LW), its band set's packed tables
    once, and its outputs."""
    tables, cols = args[:2]
    band_set = "lw" if len(args) == 5 else "sw"
    fields = [getattr(cols, f) for f in cuda_rrtmg.FLOAT_FIELDS
              + cuda_rrtmg.INT_FIELDS + ("tropo",)]
    tensors = fields + [tables[f"kernel:{band_set}"],
                        *(a for a in args[2:4] if band_set == "lw"), *out]
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


# Input sets timed besides the main path's (the first of kernel_inputs)
TIMED = {"generator_draw_sample": ("sw", "ecckd", "ng1"),
         "generator_cumulate": ("max_ran", "decorr_sqrt", "decorr_pow",
                                f"exp_ran_{SAMPLED_NCOL}",
                                f"max_ran_{SAMPLED_NCOL}"),
         "spartacus_sw": ("all_cloudy", "ecckd"),
         "spartacus_lw": ("multilayer", "all_cloudy", "ecckd"),
         **{name: ("everywhere", "ecckd", f"ecckd_{SAMPLED_NCOL}")
            for name in LAYER_MATS},
         "tripleclouds_sw": ("all_cloudy", "ecckd"),
         "lw_fused": ("no_derivatives", "all_cloudy", "ecckd", "ng1"),
         "sw_fused": ("delta_gases", "all_cloudy", "ecckd", "ng1"),
         "tripleclouds_lw": ("no_derivatives", "all_cloudy", "ecckd"),
         "lw_noscat_sweeps": ("ng1",),
         "scat_sweeps": ("total_scene", "all_cloudy", "ng1"),
         "sw_sweeps": ("total_scene", "all_cloudy", "ng1")}


def check_kernel(name, inputs, ncol, err, checked):
    """Hold a kernel against its plain version on each input set, in
    float64 and rounded to float32, and a second float32 launch against
    the first bit for bit (every kernel sums in a fixed order); the worst
    errors go into err (by dtype, shape and comparison)."""
    k = KERNELS[name]
    for label, args in inputs:
        ref64 = k["plain"](*args)
        got64 = k["wrapper"](*args)
        err64 = _compare_f64(got64, ref64, f"{name}/{label}/{ncol}",
                             F64_RTOL_OF.get(name, F64_RTOL))
        if name in LAYER_MATS:      # gigabytes, and not read again
            del got64
        args32 = _f32(args)
        got32, ref32 = k["wrapper"](*args32), k["plain"](*args32)
        _same_launches(got32, k["wrapper"](*args32), f"{name}/{label}/{ncol}")
        if name == "generator_draw_sample" and not (
                torch.equal(got64 != 0.0, ref64 != 0.0)
                and torch.equal(got32 != 0.0, ref32 != 0.0)):
            raise AssertionError(f"{name}/{label}/{ncol}: zero elsewhere "
                                 f"than its plain version")
        if name == "generator_cumulate" and not all(
                torch.equal(v, _outputs(ref32)[n])
                for n, v in _outputs(got32).items()):
            raise AssertionError(f"{name}/{label}/{ncol}: float32 outputs "
                                 f"differ from its plain version's")
        # equal values (a zero's sign aside: the layer-matrix kernels'
        # clamps keep a -0 that torch's clamp makes +0)
        if name in LAYER_MATS and not all(
                torch.equal(v, _outputs(ref32)[n])
                for n, v in _outputs(got32).items()):
            raise AssertionError(f"{name}/{label}/{ncol}: float32 outputs "
                                 f"differ from its plain version's")
        err32 = _compare_f32(got32, ref32, ref64)
        for key, v in ((f"float64/{ncol}", err64),
                       *((f"float32/{ncol}/{n}", e)
                         for n, e in err32.items())):
            err[key] = max(err.get(key, 0.0), v)
        if name in PLANES:
            del ref64, ref32
            check_planes(name, label, args, args32, ncol, err, got64, got32)
        checked.add(label)


def _same_launches(first, again, what):
    """Two launches on the same inputs must give the same outputs, bit for
    bit (every kernel sums in a fixed order)."""
    again = _outputs(again)
    torch.cuda.synchronize()
    if not all(torch.equal(v, again[n]) for n, v in _outputs(first).items()):
        raise AssertionError(f"{what}: two launches on the same inputs "
                             f"differ")


def check_planes(name, label, args, args32, ncol, err, bb64, bb32):
    """A PLANES kernel with its per-g planes: every output against the
    plain version's with planes, in float64 and float32 (the bars of
    check_kernel); its broadband outputs against those without planes
    (bb64, bb32), bit for bit; a second float32 launch against the first.
    The worst errors go into err under planes/..."""
    k = KERNELS[name]
    what = f"{name}/{label}/{ncol}/planes"
    got64 = k["wrapper"](*args, planes=True)
    for n, v in bb64.items():
        if not torch.equal(v, got64[n]):
            raise AssertionError(f"{what}: float64 {n} differs from the "
                                 f"launch without planes")
    ref64 = k["plain"](*args, planes=True)
    err64 = _compare_f64(got64, ref64, what)
    del got64
    got32 = k["wrapper"](*args32, planes=True)
    for n, v in bb32.items():
        if not torch.equal(v, got32[n]):
            raise AssertionError(f"{what}: float32 {n} differs from the "
                                 f"launch without planes")
    _same_launches(got32, k["wrapper"](*args32, planes=True), what)
    err32 = _compare_f32(got32, k["plain"](*args32, planes=True), ref64)
    for key, v in ((f"planes/float64/{ncol}", err64),
                   *((f"planes/float32/{ncol}/{n}", e)
                     for n, e in err32.items())):
        err[key] = max(err.get(key, 0.0), v)


def time_kernel(name, inputs, res, main):
    """A kernel's f32 times, each with its bound, into res["variants"]: on
    the main path's inputs (the first set, when main), which also give
    res its ms, bound and plain version's time, and on the sets TIMED
    names."""
    k = KERNELS[name]
    for i, (label, args) in enumerate(inputs):
        if not (main and i == 0) and label not in TIMED.get(name, ()):
            continue
        a = _f32(args)
        times = dict(ms=median_ms(lambda: k["wrapper"](*a)),
                     **bound(name, a, k["wrapper"](*a)))
        if name in ("generator_cumulate", *LAYER_MATS):
            # their plain versions on each set
            times["plain_ms"] = median_ms(lambda: k["plain"](*a))
        if name in PLANES:
            with_planes = bound(name, a, k["wrapper"](*a, planes=True))
            times.update(
                ms_planes=median_ms(lambda: k["wrapper"](*a, planes=True)),
                **{f"{n}_planes": v for n, v in with_planes.items()})
        res["variants"][label] = times
        if main and i == 0:
            res.update(times, plain_ms=median_ms(lambda: k["plain"](*a)))


def kernels_phase(smi):
    """Check each kernel on its input sets at each of SHAPES, and time it
    at the first; the all-cloudy, ecCKD and one-g-point sets are built
    once the main path's are freed, which keeps the float64 inputs within
    the card's memory (each group's peak device memory is reported)."""
    results = {name: {"max_abs_err": {}, "checked": set(), "variants": {}}
               for name in KERNELS}
    for ncol in SHAPES:
        for make in (kernel_inputs, all_cloudy_inputs, ecckd_inputs,
                     mono_inputs, layer_mats_inputs):
            torch.cuda.reset_peak_memory_stats()
            inputs = make(ncol, torch.float64, seed=ncol)
            for name, sets in inputs.items():
                res = results[name]
                check_kernel(name, sets, ncol, res["max_abs_err"],
                             res["checked"])
                if ncol == SHAPES[0]:
                    time_kernel(name, sets, res, main=make in (
                        kernel_inputs, layer_mats_inputs))
            del inputs
            torch.cuda.empty_cache()
            phase("kernel_inputs", ncol=ncol, inputs=make.__name__,
                  peak_memory_bytes=torch.cuda.max_memory_allocated())
    # the generator's two kernels also at the slab cells' block of 8192
    # columns, the cumulator timed there too
    torch.cuda.reset_peak_memory_stats()
    for name, sets in sample_inputs(SAMPLED_NCOL, torch.float64,
                                    seed=SAMPLED_NCOL).items():
        res = results[name]
        check_kernel(name, sets, SAMPLED_NCOL, res["max_abs_err"],
                     res["checked"])
        if name == "generator_cumulate":
            time_kernel(name, sets, res, main=False)
    torch.cuda.empty_cache()
    phase("kernel_inputs", ncol=SAMPLED_NCOL, inputs=sample_inputs.__name__,
          peak_memory_bytes=torch.cuda.max_memory_allocated())
    # the layer matrices at the SPARTACUS cell's block of 8192 columns
    torch.cuda.reset_peak_memory_stats()
    for name, sets in layer_mats_slab_inputs(SAMPLED_NCOL, torch.float64,
                                             seed=SAMPLED_NCOL).items():
        res = results[name]
        check_kernel(name, sets, SAMPLED_NCOL, res["max_abs_err"],
                     res["checked"])
        time_kernel(name, sets, res, main=False)
        del sets
        torch.cuda.empty_cache()
    phase("kernel_inputs", ncol=SAMPLED_NCOL,
          inputs=layer_mats_slab_inputs.__name__,
          peak_memory_bytes=torch.cuda.max_memory_allocated())
    for name, res in results.items():
        phase("kernels", kernel=name, max_abs_err=res["max_abs_err"],
              checked=sorted(res["checked"]),
              ms_f32_2048=res["ms"], plain_ms_f32_2048=res["plain_ms"],
              bound_ms=res["bound_ms"], bound_by=res["bound_by"],
              bytes=res["bytes"], operations=res["operations"],
              int_operations=res["int_operations"],
              bound_ms_all_tensors=res["bound_ms_all_tensors"],
              ms_planes_f32_2048=res.get("ms_planes"),
              bound_ms_planes=res.get("bound_ms_planes"),
              variants_f32_2048=res["variants"], card=smi)
    return results


def _check_slice(flux, ref, prefix, atol, atol_dimless):
    """Every field of a Flux against a reference file's, within atol
    (atol_dimless for DIMLESS); the spectral profiles (ncol, nlev+1,
    nspec) on the reference's profile_columns only."""
    worst = {}
    fields = flux.fields()
    want = {k[len(prefix):] for k in ref if k.startswith(prefix)}
    if set(fields) != want:
        raise AssertionError(f"flux fields differ: {set(fields) ^ want}")
    for name, v in fields.items():
        r = ref[prefix + name]
        if v.dim() == 3:
            v = v[torch.as_tensor(ref["profile_columns"], device=v.device)]
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
    expect_counts(n, "one f64 step", **MAIN_PATHS["mcica_rrtmg"])
    worst = _check_slice(flux, ref, "f64/", SLICE_F64_ATOL,
                         SLICE_F64_ATOL_DIMLESS)
    phase("slice_f64", max_abs_err=worst, launches=n)


def fed_sample_step(step, args, ref):
    """interface.radiation on a McICA step's inputs fed the reference's
    JAX float32 stochastic sample (the step without its generator)."""
    kw = dict(zip(flagship.ARG_ORDER, args))
    cloud = dict(kw.pop("cloud"))
    for k in SAMPLE_KEYS:
        cloud[k] = torch.as_tensor(ref["f32_sample/" + k], device=DEV)
    return radiation(step.config, step.tables, solar_irradiance=step.solar,
                     cloud=cloud, **kw)


def slice_f32_phase(ref, smi):
    # (a) radiation() fed the JAX float32 stochastic sample
    step, args = flagship.build(ncol=32, dtype=torch.float32, device=DEV)
    flux = fed_sample_step(step, args, ref)
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
    expect_counts(main_counts, "McICA main path",
                  **per_block("mcica_rrtmg", FULL_NCOL // FULL_BLOCK))
    steps = check_and_time(step, args, flux)
    step_s = statistics.median(steps)
    phase("slice_f32_full", ncol=FULL_NCOL, block=FULL_BLOCK,
          first_step_s=first_s, step_s=step_s, step_s_all=steps,
          cols_per_s=FULL_NCOL / step_s, launches=main_counts, card=smi)
    return main_counts


# Configurations whose SW scattering is nearly conservative
# (monochromatic optics: gas and cloud single-scattering albedo 0.999999),
# where light trapped between a cloud and the surface lifts the up flux
# below the cloud above the incoming flux (the JAX package's too); there
# the up flux is held to the incoming one at TOA only.
NEAR_CONSERVATIVE = ("monochromatic_homogeneous",)


def check_and_time(step, args, flux, config_name="mcica_rrtmg"):
    """Check a full-size main-path result (shape, finite, sw_up within the
    incoming flux, and within the down flux at every level: the net down
    flux is what the layers below absorb) and time three more steps;
    returns their seconds."""
    for name, v in flux.fields().items():
        if v.shape[0] != FULL_NCOL or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name}: bad shape or non-finite values")
    incoming = flux.sw_dn[:, :1]
    up = flux.sw_up[:, :1] if config_name in NEAR_CONSERVATIVE \
        else flux.sw_up
    if not bool((up <= incoming + 1e-3).all()):
        raise AssertionError("sw_up exceeds the incoming flux")
    if not bool((flux.sw_up <= flux.sw_dn + 1e-3).all()):
        raise AssertionError("sw_up exceeds sw_dn")
    steps = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    return steps


def per_block(config_name, nblocks=1):
    return {k: n * nblocks for k, n in MAIN_PATHS[config_name].items()}


def slice_phases(config_name, ref, smi):
    """A configuration of SLICES: f64 and f32 slices against JAX (the f32
    one fed the JAX float32 stochastic sample where the reference holds
    one, so without the generator's launches), then its main path at full
    size; returns the main path's launch counts."""
    tag = SLICES[config_name][0]
    for dtype, prefix, atol, atol_dimless in (
            (torch.float64, "f64/", SLICE_F64_ATOL, SLICE_F64_ATOL_DIMLESS),
            (torch.float32, "f32/", SLICE_F32_ATOL, SLICE_F32_ATOL_DIMLESS)):
        name = f"slice_{tag}_{prefix[:3]}"
        step, args = flagship.build(ncol=32, dtype=dtype, device=DEV,
                                    config_name=config_name)
        want = per_block(config_name)
        fed = dtype == torch.float32 and f"f32_sample/{SAMPLE_KEYS[0]}" in ref
        reset_counts()
        flux = fed_sample_step(step, args, ref) if fed else step(*args)
        torch.cuda.synchronize()
        n = counts()
        if fed:
            for k in GENERATOR:
                want.pop(k)
        expect_counts(n, f"one {name} step", **want)
        held_to = prefix
        if dtype == torch.float32:
            held_to = F32_HELD_TO.get(config_name, prefix)
        worst = _check_slice(flux, ref, held_to, atol, atol_dimless)
        extra = {}
        if held_to != prefix:           # reported, not checked
            extra["held_to"] = held_to
            extra["max_abs_err_vs_" + prefix[:3]] = _check_slice(
                flux, ref, prefix, float("inf"), float("inf"))
        phase(name, max_abs_err=worst, launches=n, fed_jax_sample=fed,
              **extra)

    step, args = flagship.build(ncol=FULL_NCOL, dtype=torch.float32,
                                device=DEV, block_size=FULL_BLOCK,
                                config_name=config_name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    flux = step(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    main_counts = counts()
    peak = torch.cuda.max_memory_allocated()
    expect_counts(main_counts, f"{config_name} main path",
                  **per_block(config_name, FULL_NCOL // FULL_BLOCK))
    extra = {}
    if main_counts["spartacus_sw_mats"]:
        # the share of elements refined in one step at full size
        extra["refined_share"] = refined_shares(step.config, FULL_NCOL)
    steps = check_and_time(step, args, flux, config_name)
    step_s = statistics.median(steps)
    phase(f"slice_{tag}_full", ncol=FULL_NCOL, block=FULL_BLOCK,
          first_step_s=first_s, step_s=step_s, step_s_all=steps,
          cols_per_s=FULL_NCOL / step_s, launches=main_counts,
          peak_memory_bytes=peak, card=smi, **extra)
    return main_counts


def spartacus_gpoint_phase(ref):
    """spartacus_3d in float64 on the 32 meridian columns with flux
    profiles per g-point: the broadband fields against the JAX float64
    fluxes, and the g-point profiles summed over g against them."""
    step, args = flagship.build(ncol=32, dtype=torch.float64, device=DEV,
                                config_name="spartacus_3d")
    config = step.config.replace(do_save_gpoint_flux=True)
    reset_counts()
    flux = pipeline.radiation_step(config, step.tables,
                                   solar_irradiance=step.solar,
                                   **dict(zip(flagship.ARG_ORDER, args)))
    torch.cuda.synchronize()
    n = counts()
    expect_counts(n, "one spartacus_3d g-point step",
                  **per_block("spartacus_3d"))
    fields = flux.fields()
    gpoint = {k: fields.pop(k) for k in list(fields) if k.endswith("_band")
              and fields[k].dim() == 3}
    worst = _check_slice(Flux(**fields), ref, "f64/", SLICE_F64_ATOL,
                         SLICE_F64_ATOL_DIMLESS)
    sums = {}
    for k, v in gpoint.items():
        if v.shape[-1] != config.n_g_lw and v.shape[-1] != config.n_g_sw:
            raise AssertionError(f"{k}: {v.shape[-1]} g-points")
        sums[k] = float((v.sum(-1) - fields[k[:-len("_band")]]).abs().max())
        if not sums[k] <= GPOINT_SUM_ATOL:
            raise AssertionError(f"{k} summed over g differs from the "
                                 f"broadband flux by {sums[k]}")
    if len(gpoint) != 10:
        raise AssertionError(f"g-point profiles {sorted(gpoint)}")
    phase("slice_sp_gpt_f64", max_abs_err=worst, gpoint_sum_err=sums,
          launches=n)


# --- the command-line entry points -------------------------------------------

def write_namelist(tmp, config_name):
    path = os.path.join(tmp, f"{config_name}.nam")
    with open(path, "w") as f:
        f.write(flagship.namelist_text(config_name, DATA_DIR, iverbose=1,
                                       do_write_double_precision=True))
    return path


def read_nc(path):
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: np.array(v.data) for k, v in f.variables.items()}


def _check_outputs(got, ref, prefix, atol, atol_dimless):
    """Every output (a file's variables, or run_ifs's) against a reference
    file's; returns the worst errors by name."""
    want = {k[len(prefix):] for k in ref if k.startswith(prefix)}
    if set(got) != want:
        raise AssertionError(f"{prefix}: outputs differ: {set(got) ^ want}")
    worst = {}
    for name, v in got.items():
        worst[name] = float(np.abs(np.asarray(v, np.float64)
                                   - ref[prefix + name]).max())
        bar = atol_dimless if name in DRIVER_DIMLESS else atol
        if not worst[name] <= bar:
            raise AssertionError(f"{prefix}{name}: max abs error "
                                 f"{worst[name]} > {bar}")
    return worst


def driver_phases(tmp, ref):
    """driver_f64 and driver_f32: the offline driver on the 32 meridian
    columns against the JAX driver's output files."""
    runs = (("driver_f64", "mcica_rrtmg", "float64", DRIVER_F64_ATOL,
             DRIVER_F64_ATOL_DIMLESS),
            ("driver_f32", "mcica_rrtmg", "float32", SLICE_F32_ATOL,
             SLICE_F32_ATOL_DIMLESS),
            ("driver_f32", "tripleclouds_rrtmg", "float64", DRIVER_F64_ATOL,
             DRIVER_F64_ATOL_DIMLESS))
    for name, config_name, dtype, atol, atol_dimless in runs:
        out = os.path.join(tmp, f"{config_name}_{dtype}.nc")
        nam = write_namelist(tmp, config_name)
        reset_counts()
        driver.run(nam, MERIDIAN_INPUT, out, dtype=dtype, generator="exact",
                   device=DEV)
        torch.cuda.synchronize()
        n = counts()
        want = per_block(config_name)
        for k in GENERATOR:
            want.pop(k, None)
        expect_counts(n, f"{name} {config_name}", **want)
        tag = "f64" if dtype == "float64" else "f32"
        worst = _check_outputs(read_nc(out), ref, f"{config_name}/{tag}/",
                               atol, atol_dimless)
        phase(name, configuration=config_name, dtype=dtype,
              max_abs_err=worst, launches=n)


def full_input(tmp, ncol):
    """The meridian file tiled to ncol columns, written by save_inputs
    (with lat/lon, which the IFS driver reads)."""
    from ecrad_torch.io.netcdf import NcFile
    inp = read_input(MERIDIAN_INPUT, DriverConfig(**flagship.DRIVER_SETTINGS))
    with NcFile(MERIDIAN_INPUT) as f:
        lat, lon = f.get("lat"), f.get("lon")
    reps = -(-ncol // inp.ncol)

    def tile(x):
        return None if x is None else np.concatenate([x] * reps)[:ncol]

    tiled = dataclasses.replace(inp, **{
        k: tile(getattr(inp, k)) for k in (
            "gas_mmr", "cloud_mixing_ratio", "cloud_effective_radius",
            "cloud_fraction", "fractional_std", "overlap_param",
            "inv_cloud_effective_size", "inv_inhom_effective_size",
            "aerosol_mmr", "cos_sza", "skin_temperature", "sw_albedo",
            "sw_albedo_direct", "lw_emissivity", "iseed")},
        thermodynamics=dataclasses.replace(
            inp.thermodynamics,
            pressure_hl=tile(inp.thermodynamics.pressure_hl),
            temperature_hl=tile(inp.thermodynamics.temperature_hl)))
    path = os.path.join(tmp, f"meridian_{ncol}.nc")
    save_inputs(path, flagship.flagship_config("float32"), tiled,
                lat=tile(lat), lon=tile(lon))
    return path


def _check_tiles(fields, ncol, what):
    """Every tiled copy of the 32 meridian columns against the first:
    the same seeds give the same sample, so the same fluxes."""
    worst = 0.0
    for name, v in fields.items():
        v = np.asarray(v, np.float64)
        if v.shape[0] != ncol or not np.isfinite(v).all():
            raise AssertionError(f"{what} {name}: bad shape or non-finite")
        tiles = v[:ncol - ncol % 32].reshape((-1, 32) + v.shape[1:])
        worst = max(worst, float(np.abs(tiles - tiles[:1]).max()))
    if not worst <= TILE_ATOL:
        raise AssertionError(f"{what}: tiled copies differ by {worst}")
    return worst


def driver_full_phase(tmp, path, smi):
    """driver_f32_full: the offline driver at full size with each
    generator; then ecRad's evaluation tool (python -m
    ecrad_torch.evaluate.compare_output, which runs without JAX) on the
    host generator's float32 output against a float64 run, at the
    single-precision bar."""
    nam = write_namelist(tmp, "mcica_rrtmg")
    for generator in ("exact", "device"):
        out = os.path.join(tmp, f"full_{generator}.nc")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiling.enable()
        profiling.reset()
        reset_counts()
        t0 = time.perf_counter()
        flux = driver.run(nam, path, out, dtype="float32",
                          nrepeat=DRIVER_NREPEAT, generator=generator,
                          device=DEV)
        run_s = time.perf_counter() - t0
        n = counts()
        prof = profiling.get_profile()
        profiling.enable(False)
        peak = torch.cuda.max_memory_allocated()
        want = per_block("mcica_rrtmg", DRIVER_NREPEAT)
        if generator == "exact":
            for k in GENERATOR:
                want.pop(k)
        expect_counts(n, f"driver {generator} at {FULL_NCOL} columns",
                      **want)
        worst = _check_tiles(flux.fields(), FULL_NCOL, f"driver {generator}")
        repeats_s = prof["ecrad_driver:radiation"][1]
        stages = {k: prof[k][1] for k in DRIVER_STAGES if k in prof}
        setup_s = prof["radiation_interface:setup_radiation"][1]
        # one pass: the run without its setup and its repeats
        pass_s = run_s - setup_s - repeats_s
        phase("driver_f32_full", generator=generator, ncol=FULL_NCOL,
              nrepeat=DRIVER_NREPEAT,
              cols_per_s_repeats=FULL_NCOL * (DRIVER_NREPEAT - 1)
              / repeats_s,
              pass_s=pass_s, cols_per_s_pass=FULL_NCOL / pass_s,
              setup_s=setup_s, stages_s=stages, tile_max_abs_err=worst,
              launches=n, peak_memory_bytes=peak, card=smi)
    out64 = os.path.join(tmp, "full_f64.nc")
    driver.run(nam, path, out64, dtype="float64", generator="exact",
               device=DEV)
    cmd = [sys.executable, "-m", "ecrad_torch.evaluate.compare_output",
           os.path.join(tmp, "full_exact.nc"), out64, "--input", path,
           "--threshold-lw", str(SLICE_F32_ATOL),
           "--threshold-sw", str(SLICE_F32_ATOL)]
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"compare_output exited {r.returncode}:\n"
                             f"{r.stdout[-4000:]}{r.stderr[-4000:]}")
    phase("driver_f32_full", evaluation=" ".join(cmd[1:]),
          returncode=r.returncode, report=r.stdout.splitlines())


def ifs_f64_phase(tmp, ref):
    """ifs_f64: the IFS driver on the 32 meridian columns, with and
    without --bitidentity, against the JAX IFS driver, and blocked."""
    nam = write_namelist(tmp, "mcica_rrtmg")
    results = {}
    for mode in ("bitidentity", "device"):
        reset_counts()
        out = run_ifs(nam, MERIDIAN_INPUT, None, dtype="float64",
                      bitidentity=mode == "bitidentity", device=DEV)
        n = counts()
        want = per_block("mcica_rrtmg")
        if mode == "bitidentity":
            for k in GENERATOR:
                want.pop(k)
        expect_counts(n, f"ifs {mode}", **want)
        results[mode] = out
        worst = _check_outputs({k: v for k, v in out.items()
                                if k != "_flux"}, ref, f"{mode}/",
                               DRIVER_F64_ATOL, DRIVER_F64_ATOL_DIMLESS)
        phase("ifs_f64", mode=mode, max_abs_err=worst, launches=n)
    reset_counts()
    blocked = run_ifs(nam, MERIDIAN_INPUT, None, dtype="float64", nproma=8,
                      device=DEV)
    n = counts()
    expect_counts(n, "ifs nproma 8", **per_block("mcica_rrtmg", 4))
    diff = {k: float(np.abs(v - results["device"][k]).max())
            for k, v in blocked.items() if k != "_flux"}
    if not max(diff.values()) <= NPROMA_ATOL:
        raise AssertionError(f"ifs nproma 8 against unblocked: {diff}")
    phase("ifs_f64", mode="device", nproma=8,
          max_abs_err_vs_unblocked=max(diff.values()), launches=n)


def ifs_full_phase(tmp, path, smi):
    """ifs_f32_full: the IFS driver at full size in blocks of 2048, run
    twice (the second timed)."""
    nam = write_namelist(tmp, "mcica_rrtmg")
    for run in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiling.enable()
        profiling.reset()
        reset_counts()
        out = run_ifs(nam, path, None, dtype="float32", nproma=FULL_BLOCK,
                      device=DEV)
        n = counts()
        prof = profiling.get_profile()
        profiling.enable(False)
    peak = torch.cuda.max_memory_allocated()
    expect_counts(n, f"ifs at {FULL_NCOL} columns",
                  **per_block("mcica_rrtmg", FULL_NCOL // FULL_BLOCK))
    worst = _check_tiles({k: v for k, v in out.items() if k != "_flux"},
                         FULL_NCOL, "ifs")
    scheme_s = prof["ecrad_ifs_driver:radiation_scheme"][1]
    phase("ifs_f32_full", ncol=FULL_NCOL, nproma=FULL_BLOCK,
          scheme_s=scheme_s, cols_per_s=FULL_NCOL / scheme_s,
          stages_s={k: v[1] for k, v in prof.items()},
          tile_max_abs_err=worst, launches=n, peak_memory_bytes=peak,
          card=smi)


def _equal_fluxes(got, ref, what):
    """Two sets of fields (tensors or arrays, by name) equal bit for bit."""
    if set(got) != set(ref):
        raise AssertionError(f"{what}: fields differ: {set(got) ^ set(ref)}")
    differ = [k for k in ref if not np.array_equal(
        np.asarray(torch.as_tensor(got[k]).cpu()),
        np.asarray(torch.as_tensor(ref[k]).cpu()))]
    if differ:
        raise AssertionError(f"{what}: not bit-equal in {differ}")


def sharded_phase(smi):
    """sharded: radiation_sharded of the flagship at full size over the
    card's mesh (blocks of 2048) and over three slabs of the one card,
    each against radiation_blocked, bit for bit (the same column blocks),
    timed."""
    step, args = flagship.build(ncol=FULL_NCOL, dtype=torch.float32,
                                device=DEV, block_size=FULL_BLOCK)
    kw = dict(zip(flagship.ARG_ORDER, args))
    ref = step(*args).fields()
    torch.cuda.synchronize()
    for label, mesh, block in (
            ("make_mesh", pipeline.make_mesh(), FULL_BLOCK),
            ("cuda0x3", (torch.device("cuda", 0),) * 3, None)):
        reset_counts()
        t0 = time.perf_counter()
        flux = pipeline.radiation_sharded(
            step.config, step.tables, mesh, solar_irradiance=step.solar,
            block_size=block, **kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        n = counts()
        expect_counts(n, f"sharded {label}",
                      **per_block("mcica_rrtmg", FULL_NCOL // FULL_BLOCK))
        _equal_fluxes(flux.fields(), ref, f"sharded {label}")
        phase("sharded", mesh=[str(d) for d in mesh], block=block,
              ncol=FULL_NCOL, equal_to_blocked=True, run_s=run_s,
              cols_per_s=FULL_NCOL / run_s, launches=n, card=smi)


def distributed_phase(tmp, path, smi, world=2):
    """distributed: two ranks on the one card (gloo), each reading its
    slab of the file at path, against one process's radiation_sharded
    over two slabs with the same column blocks, bit for bit."""
    from ecrad_torch.io.input import DriverConfig as DC
    worker = os.path.join(HERE, "tests", "torch_dist_worker.py")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(world), str(port), path, tmp,
         "local", "float32", str(FULL_BLOCK)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    run_s = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} failed:\n{out[-4000:]}")
    shards = [dict(np.load(os.path.join(tmp, f"shard{r}.npz")))
              for r in range(world)]
    if [int(s.pop("start")) for s in shards] != [0, FULL_NCOL // world] \
            or int(shards[-1].pop("stop")) != FULL_NCOL:
        raise AssertionError("the ranks' slabs do not tile the columns")
    shards[0].pop("stop")
    got = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    config, tables = setup_radiation(flagship.flagship_config("float32"),
                                     DEV, torch.float32, data_dir=DATA_DIR)
    inp = read_input(path, DC(**flagship.DRIVER_SETTINGS))
    kw = dict(zip(flagship.ARG_ORDER,
                  flagship.inputs_from(inp, torch.float32, DEV)))
    ref = pipeline.radiation_sharded(
        config, tables, (DEV,) * world, block_size=FULL_BLOCK,
        solar_irradiance=float(inp.solar_irradiance), **kw).fields()
    _equal_fluxes(got, ref, "distributed")
    phase("distributed", ranks=world, backend="gloo", ncol=FULL_NCOL,
          block=FULL_BLOCK, equal_to_one_process=True, run_s=run_s,
          outputs=[o.strip().splitlines()[-1] for o in outs], card=smi)


def entry_point_phases(smi):
    """The phases of the two command-line entry points (14-16) and the
    distributed run (18), which reads the full-size file they write."""
    with tempfile.TemporaryDirectory() as tmp:
        with np.load(os.path.join(DATA, "torch_driver_meridian32.npz")) as z:
            ref = {k: z[k] for k in z.files}
        driver_phases(tmp, ref)
        path = full_input(tmp, FULL_NCOL)
        driver_full_phase(tmp, path, smi)
        with np.load(os.path.join(DATA, "torch_ifs_meridian32.npz")) as z:
            ref = {k: z[k] for k in z.files}
        ifs_f64_phase(tmp, ref)
        ifs_full_phase(tmp, path, smi)
        distributed_phase(tmp, path, smi)


def main():
    smi = device_phase()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    results = kernels_phase(smi)
    with np.load(REFERENCE) as z:
        ref = {k: z[k] for k in z.files}
    slice_f64_phase(ref)
    path_counts = {"mcica_rrtmg": slice_f32_phase(ref, smi)}
    for config_name, (_, fname) in SLICES.items():
        with np.load(os.path.join(DATA, fname)) as z:
            ref = {k: z[k] for k in z.files}
        path_counts[config_name] = slice_phases(config_name, ref, smi)
        if config_name == "spartacus_3d":
            spartacus_gpoint_phase(ref)
    sharded_phase(smi)
    entry_point_phases(smi)
    # each kernel's launches in the first main path that names it
    launches = {}
    for config_name, path in MAIN_PATHS.items():
        for n in path:
            launches.setdefault(n, path_counts[config_name][n])
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": launches[n],
         "max_abs_err": max(
             results[n]["max_abs_err"][f"float32/{c}/vs_plain"]
             for c in SHAPES),
         "ms": results[n]["ms"], "plain_ms": results[n]["plain_ms"],
         "bound_ms": results[n]["bound_ms"],
         "bound_by": results[n]["bound_by"],
         # no single PyTorch call computes these level recurrences
         "library_ms": None,
         # with the per-g planes of spectral flux output (PLANES only)
         "ms_planes": results[n].get("ms_planes"),
         "bound_ms_planes": results[n].get("bound_ms_planes")}
        for n, k in KERNELS.items()]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
