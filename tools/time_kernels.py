"""Time the port's kernels on chip_smoke.py's inputs, f32, 2048 columns,
median of 5 CUDA-event timings each, and those of other checkouts on the
same inputs in turns, on one NVIDIA GPU.

    python3 tools/time_kernels.py [--other DIR ...] [--rounds N]
        [--kernels NAME ...] [--planes] [--steps [--configs NAME ...]]
        [--stages]

Times each kernel (or those --kernels names) on every input set of
chip_smoke.kernel_inputs ("meridian": the bundled slice tiled, a random
state from a numpy seed; a kernel's first set is the main path's, the
others are its variants: spartacus_sw in Maximum and Edge-only
entrapment, spartacus_lw with multilayer effects, the fused McICA and
Tripleclouds kernels with delta-scaled gases or without derivatives,
scat_sweeps and sw_sweeps on the total scene) and of
chip_smoke.all_cloudy_inputs (the same state with every layer cloudy,
"all_cloudy"), chip_smoke.ecckd_inputs (the five kernels of the ecCKD
paths at 32 g-points on the ecckd_mcica state, "ecckd") and
chip_smoke.layer_mats_inputs (the SPARTACUS layer matrices on the
spartacus_3d and spartacus_ecckd states, "layer_mats").  A case is named
"<kernel>[_<set>]/<state>".  Each checkout (this one, then each DIR, e.g.
an older commit unpacked with `git archive`, or a copy with a kernel's
variant edited in) runs in a process of its own that imports that
checkout's `ecrad_torch` and builds its kernels; the inputs come from
this checkout's chip_smoke.py either way.  A round runs the checkouts in
order, the next round in reverse order; in the first, each one's
kernels are also held against their plain versions in float64 (rtol
1e-10, as chip_smoke.py; a disagreement is reported in the run's line),
the registers and spills ptxas reports for the kernels are printed, and
each checkout saves its float32 outputs of every case under
build/time_kernels/ of this checkout; the summary line then says, per
case and per other checkout, whether its outputs equal this checkout's
bit for bit ("equal") or by how much they differ at most (outputs over
64 MiB, the SPARTACUS layer matrices', are saved as a digest of their
bits: "equal" or "differ").  With
--planes, only the kernels that write per-g planes (chip_smoke.PLANES:
the four fused McICA and Tripleclouds kernels and the three adding
sweeps) run, with their planes (planes=True; every checkout must have
them).  With
--steps, each run times the main paths' steps instead (chip_smoke.py's
full size: 6144 columns in blocks of 2048, f32, the median of three steps
after one, host clock around a synchronised step, and the peak device
memory of those steps) of the configurations named by --configs (by
default all fourteen; an older checkout may lack the later ones).  With
--stages, each run times the SPARTACUS sweep arguments instead
(spartacus.sw_sweep_args and lw_sweep_args, whose signatures every
checkout since the SPARTACUS kernels shares: the region set-up, the layer
matrices, the clear-sky planes, the per-level inputs) on
chip_smoke.sweep_args_inputs, float32, for spartacus_3d (RRTMG's widths)
and spartacus_ecckd at 2048 and 8192 columns (cases
"<band>_sweep_args/<configuration>_<ncol>"), each also split by stage
(STAGES: the device time between CUDA events around each call the
checkout's sweep_args makes of those functions, 0 for those it does not
call, the rest "other"; the median of 5 calls), and saves a digest of
every output in the first round, so that the summary says whether the
sweep arguments equal this checkout's bit for bit.  Prints one
JSON line per run and a summary line
{"card": ..., "median_ms": {checkout: {case: ms}}, "f32_outputs_vs_this":
{checkout: {case: "equal" or max_abs_diff}}}.
"""

import argparse
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NCOL = 2048
STEP_CONFIGS = ("mcica_rrtmg", "tripleclouds_rrtmg", "homogeneous_rrtmg",
                "spartacus_3d", "cloudless_rrtmg", "tripleclouds_ecckd",
                "ecckd_mcica", "tripleclouds_baran2016",
                "mcica_rrtmg_spectral", "tripleclouds_ecckd_gpoint",
                "cloudless_rrtmg_spectral", "homogeneous_rrtmg_spectral",
                "monochromatic_homogeneous", "spartacus_ecckd")


def time_steps(chip_smoke, configs):
    """{"step/<configuration>": ms} of one full-size main-path step, and
    {"peak/<configuration>": bytes} of the device memory its steps held
    at most."""
    import torch

    from ecrad_torch import flagship

    out, peak = {}, {}
    for config_name in configs:
        step, args = flagship.build(
            ncol=chip_smoke.FULL_NCOL, dtype=torch.float32, device="cuda",
            block_size=chip_smoke.FULL_BLOCK, config_name=config_name)
        step(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        out[f"step/{config_name}"] = statistics.median(times)
        peak[f"peak/{config_name}"] = torch.cuda.max_memory_allocated()
        del step, args
        torch.cuda.empty_cache()
    return out, peak


# The stages of the SPARTACUS sweep arguments that --stages times apart:
# (module under ecrad_torch.solvers, function), none calling another
STAGES = (("spartacus", "_prep"), ("spartacus", "_region_optics"),
          ("spartacus", "_use_expm_mask"), ("spartacus", "_transfer_rates"),
          ("cuda_spartacus", "sw_layer_mats"),
          ("cuda_spartacus", "lw_layer_mats"),
          ("two_stream", "sw_ref_trans"), ("two_stream", "lw_ref_trans"),
          ("spartacus", "_lev"))
STAGE_NCOLS = (2048, 8192)


def _split_call(fn, args):
    """One call of fn(*args) with CUDA events around it and around each
    call it makes of a STAGES function: {stage: ms, "total": ms}, device
    time between the events, summed over calls; "other", the total less
    the stages."""
    import importlib

    import torch

    marks = {f"{m}.{f}": [] for m, f in STAGES}
    real = {}

    def timed(key, f):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = f(*a, **kw)
            end.record()
            marks[key].append((start, end))
            return out
        call.__dict__.update(f.__dict__)       # a wrapper's counters
        return call

    for m, f in STAGES:
        mod = importlib.import_module(f"ecrad_torch.solvers.{m}")
        if hasattr(mod, f):
            real[(mod, f)] = getattr(mod, f)
            setattr(mod, f, timed(f"{m}.{f}", real[(mod, f)]))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        fn(*args)
        end.record()
    finally:
        for (mod, f), g in real.items():
            setattr(mod, f, g)
    torch.cuda.synchronize()
    out = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in marks.items()}
    out["total"] = start.elapsed_time(end)
    out["other"] = out["total"] - sum(out[f"{m}.{f}"] for m, f in STAGES)
    return out


def time_stages(chip_smoke, save):
    """{case: ms} of the SPARTACUS sweep arguments (--stages), {case:
    {stage: ms}} of their split, and with save each case's outputs saved
    there."""
    import torch

    from ecrad_torch.solvers import spartacus

    cases, split = {}, {}
    for ncol in STAGE_NCOLS:
        for config_name in ("spartacus_3d", "spartacus_ecckd"):
            inputs = chip_smoke.sweep_args_inputs(
                ncol, torch.float32, ncol, config_name=config_name)
            for band, args in inputs.items():
                fn = getattr(spartacus, f"{band}_sweep_args")
                key = f"{band}_sweep_args/{config_name}_{ncol}"
                cases[key] = chip_smoke.median_ms(lambda: fn(*args))
                calls = [_split_call(fn, args) for _ in range(5)]
                split[key] = {k: statistics.median(c[k] for c in calls)
                              for k in calls[0]}
                if save:
                    torch.save({n: saved(v) for n, v in chip_smoke._outputs(
                        fn(*args)[1]).items()}, case_file(save, key))
            del inputs
            torch.cuda.empty_cache()
    return cases, split


def case_file(save, case):
    return os.path.join(save, case.replace("/", "__") + ".pt")


# Outputs above this many bytes are saved as a digest of their bits, not
# whole: the SPARTACUS layer matrices' are gigabytes a case at RRTMG widths,
# and a card machine's disk holds some tens of gigabytes all told
SAVE_WHOLE_BYTES = 1 << 26


def saved(x):
    """A float32 output as saved: whole (on the host), or above
    SAVE_WHOLE_BYTES its shape and two sums of its bit patterns, the second
    weighted by position."""
    import torch

    if x.numel() * x.element_size() <= SAVE_WHOLE_BYTES:
        return x.cpu()
    # in chunks of 2^26 entries (int64 sums wrap the same either way)
    flat = x.contiguous().view(torch.int32).flatten()
    total = weighted = 0
    for s in range(0, flat.numel(), 1 << 26):
        bits = flat[s:s + (1 << 26)].to(torch.int64)
        w = torch.arange(s, s + bits.numel(), device=bits.device) % 65521 + 1
        total += int(bits.sum())
        weighted += int((bits * w).sum())
    wrap = lambda v: (v + 2**63) % 2**64 - 2**63  # noqa: E731
    return {"shape": tuple(x.shape), "digest": (wrap(total), wrap(weighted))}


def _sampler_args(f):
    """f, or where f takes the generator's sampler inputs as one argument
    ``sample`` (generator_draw_scan in checkouts that also kept the CDF
    build), f taking them as the three last arguments, as chip_smoke.py
    passes them."""
    import inspect

    if "sample" not in inspect.signature(f).parameters:
        return f
    return lambda *a, **kw: f(*a[:5], sample=a[5:], **kw)


def worker(check, configs, names, save, planes=False, stages=False):
    """Time this process's ecrad_torch (the first on sys.path) on the
    inputs of chip_smoke.py from ROOT, the kernels names lists (all when
    empty; with planes, those of chip_smoke.PLANES, with their per-g
    planes); with check, first hold each kernel against its plain version
    in float64 (chip_smoke._compare_f64), and save each case's float32
    outputs into the directory save; with configs, time those
    configurations' main-path steps instead; with stages, the SPARTACUS
    sweep arguments (time_stages)."""
    import importlib.util

    import torch

    # this checkout's chip_smoke.py, whichever ecrad_torch it imports
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from ecrad_torch import kernels

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: time_kernels needs an NVIDIA GPU")
    log = kernels.build()["log"]
    kernels.library()
    if configs:
        ms, peak = time_steps(chip_smoke, configs)
        print(json.dumps({"ecrad_torch": os.path.dirname(
            os.path.dirname(os.path.abspath(kernels.__file__))),
            "ms": ms, "peak_memory_bytes": peak}), flush=True)
        return
    if stages:
        ms, split = time_stages(chip_smoke, save if check else None)
        print(json.dumps({"ecrad_torch": os.path.dirname(
            os.path.dirname(os.path.abspath(kernels.__file__))),
            "ms": ms, "stages_ms": split}), flush=True)
        return
    regs = [line.strip() for line in log.splitlines()
            if "entry function" in line or "registers" in line
            or "spill" in line]
    k = chip_smoke.KERNELS
    cases, f64_err = {}, {}
    for state, make in (("meridian", chip_smoke.kernel_inputs),
                        ("all_cloudy", chip_smoke.all_cloudy_inputs),
                        ("ecckd", chip_smoke.ecckd_inputs),
                        ("layer_mats", chip_smoke.layer_mats_inputs)):
        inputs = make(NCOL, torch.float64, NCOL)
        for name, sets in inputs.items():
            if (names and name not in names) or (
                    planes and name not in chip_smoke.PLANES):
                continue
            kw = dict(planes=True) if planes else {}
            fn = functools.partial(_sampler_args(k[name]["wrapper"]), **kw)
            plain = functools.partial(_sampler_args(k[name]["plain"]), **kw)
            for i, (label, args) in enumerate(sets):
                case = name if i == 0 else f"{name}_{label}"
                key = f"{case}/{state}"
                if check:     # the kernel against its plain version, in f64
                    try:
                        f64_err[key] = chip_smoke._compare_f64(
                            fn(*args), plain(*args))
                    except AssertionError as e:
                        f64_err[key] = f"FAILS: {e}"
                a = chip_smoke._f32(args)
                cases[key] = chip_smoke.median_ms(lambda: fn(*a))
                if check:
                    torch.save({n: saved(v) for n, v in
                                chip_smoke._outputs(fn(*a)).items()},
                               case_file(save, key))
                del a
        del inputs
        torch.cuda.empty_cache()
    print(json.dumps({"ecrad_torch": os.path.dirname(
        os.path.dirname(os.path.abspath(kernels.__file__))),
        "ms": cases, "max_abs_err_f64": f64_err,
        "ptxas": regs if check else []}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", action="append", default=[],
                        help="another checkout to time beside this one")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--kernels", nargs="+", default=[],
                        help="the kernels to time (default: all)")
    parser.add_argument("--planes", action="store_true",
                        help="time the kernels that write per-g planes, "
                        "with them")
    parser.add_argument("--steps", action="store_true",
                        help="time the main paths' steps, not the kernels")
    parser.add_argument("--configs", nargs="+", default=list(STEP_CONFIGS),
                        help="the configurations --steps times")
    parser.add_argument("--stages", action="store_true",
                        help="time the SPARTACUS sweep arguments by stage, "
                        "not the kernels")
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--check", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--save", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        worker(args.check, args.configs if args.steps else (), args.kernels,
               args.save, args.planes, args.stages)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # (label, checkout)
    runs = [(".", ROOT)]
    runs += [(os.path.relpath(os.path.abspath(d), ROOT), os.path.abspath(d))
             for d in args.other]
    times = {label: [] for label, _ in runs}
    split = {label: [] for label, _ in runs}
    saved = os.path.join(ROOT, "build", "time_kernels")
    shutil.rmtree(saved, ignore_errors=True)
    save = {label: os.path.join(saved, str(i))
            for i, (label, _) in enumerate(runs)}
    for d in save.values():
        os.makedirs(d)
    for r in range(args.rounds):
        for label, tree in runs if r % 2 == 0 else runs[::-1]:
            env = dict(os.environ, PYTHONPATH=tree)
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 *(["--check", "--save", save[label]] if r == 0 else []),
                 *(["--kernels", *args.kernels] if args.kernels else []),
                 *(["--planes"] if args.planes else []),
                 *(["--steps", "--configs", *args.configs]
                   if args.steps else []),
                 *(["--stages"] if args.stages else [])],
                env=env, capture_output=True, text=True, cwd=tree)
            if out.returncode != 0:
                raise RuntimeError(f"{label}: worker failed:\n{out.stderr}")
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(line, run=label, round=r)), flush=True)
            times[label].append(line["ms"])
            split[label].append(line.get("stages_ms", {}))
    print(json.dumps({"card": smi, "median_ms": {
        label: {case: statistics.median(run[case] for run in rs)
                for case in rs[0]} for label, rs in times.items()},
        "median_stages_ms": {
            label: {case: {k: statistics.median(run[case][k] for run in rs)
                           for k in rs[0][case]} for case in rs[0]}
            for label, rs in split.items()},
        "f32_outputs_vs_this": {
            label: compare_outputs(save["."], save[label], times["."][0])
            for label, _ in runs[1:]} if not args.steps else {}}))


def compare_outputs(this, other, cases):
    """{case: "equal" when the float32 outputs saved under other equal
    those under this bit for bit, else their largest absolute difference
    ("missing" when other saved no such case, "names differ" when its
    outputs have other names, "differ" where outputs saved as digests
    differ)."""
    import torch

    res = {}
    for case in cases:
        path = case_file(other, case)
        if not os.path.exists(path):
            res[case] = "missing"
            continue
        a, b = torch.load(case_file(this, case)), torch.load(path)
        if set(a) != set(b):
            res[case] = "names differ"
        elif any(isinstance(a[n], dict) for n in a):
            res[case] = "equal" if all(
                isinstance(b[n], dict) and a[n] == b[n]
                if isinstance(a[n], dict) else torch.equal(a[n], b[n])
                for n in a) else "differ"
        elif all(torch.equal(a[n], b[n]) for n in a):
            res[case] = "equal"
        else:
            res[case] = max(float((a[n].double() - b[n].double()).abs().max())
                            for n in a)
    return res


if __name__ == "__main__":
    main()
