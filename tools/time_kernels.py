"""Time the SW sweep kernels of the port on chip_smoke.py's inputs, f32,
2048 columns, median of 5 CUDA-event timings each, and those of other
checkouts on the same inputs in turns, on one NVIDIA GPU.

    python3 tools/time_kernels.py [--other DIR ...] [--rounds N]

Times `spartacus_sw` (Explicit entrapment, the spartacus_3d path's, and
Maximum entrapment) and the Tripleclouds `sw_fused` on the main path's
inputs ("meridian": the bundled slice tiled, a random state from a numpy
seed) and on the same state with every layer cloudy ("all_cloudy").  Each
checkout (this one, then each DIR, e.g. an older commit unpacked with
`git archive`) runs in a process of its own that imports that checkout's
`ecrad_torch` and builds its kernels; the inputs come from this
checkout's chip_smoke.py either way.  A round runs the checkouts in
order, the next round in reverse order; in the first, each checkout's
kernels are also held against their plain versions in float64 (rtol
1e-10, as chip_smoke.py), and a kernel that disagrees stops the run.
Prints one JSON line per run and a summary line
{"card": ..., "median_ms": {checkout: {case: ms}}}.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NCOL = 2048


def worker(check):
    """Time this process's ecrad_torch (the first on sys.path) on the
    inputs of chip_smoke.py from ROOT; with check, first hold each kernel
    against its plain version in float64 (chip_smoke._compare_f64)."""
    import importlib.util

    import torch

    # this checkout's chip_smoke.py, whichever ecrad_torch it imports
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from ecrad_torch import kernels
    from ecrad_torch.config import Entrapment
    from ecrad_torch.solvers import cuda_spartacus, cuda_tripleclouds

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: time_kernels needs an NVIDIA GPU")
    kernels.library()
    sp_fns = (cuda_spartacus.sw_sweeps, cuda_spartacus.sw_sweeps_plain)
    tc_fns = (cuda_tripleclouds.sw_fused, cuda_tripleclouds.sw_fused_plain)
    cases, f64_err = {}, {}
    for label, min_cloud in (("meridian", 0.0), ("all_cloudy", 0.2)):
        inputs = chip_smoke.sw_inputs(NCOL, torch.float64, NCOL, min_cloud)
        sp, tc = inputs["spartacus_sw"], inputs["tripleclouds_sw"]
        del inputs
        spm = (sp[0]._replace(mode=Entrapment.MAXIMUM),) + sp[1:]
        for case, (fn, plain), args in (
                ("spartacus_sw", sp_fns, sp),
                ("spartacus_sw_maximum", sp_fns, spm),
                ("tripleclouds_sw", tc_fns, tc)):
            key = f"{case}/{label}"
            if check:     # the kernel against its plain version, in f64
                f64_err[key] = chip_smoke._compare_f64(fn(*args),
                                                       plain(*args))
            a = chip_smoke._f32(args)
            cases[key] = chip_smoke.median_ms(lambda: fn(*a))
            del a
        del sp, spm, tc
        torch.cuda.empty_cache()
    print(json.dumps({"ecrad_torch": os.path.dirname(
        os.path.dirname(os.path.abspath(kernels.__file__))),
        "ms": cases, "max_abs_err_f64": f64_err}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", action="append", default=[],
                        help="another checkout to time beside this one")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--check", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        worker(args.check)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    trees = [ROOT] + [os.path.abspath(d) for d in args.other]
    runs = {t: [] for t in trees}
    for r in range(args.rounds):
        for tree in trees if r % 2 == 0 else trees[::-1]:
            env = dict(os.environ, PYTHONPATH=tree)
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 *(["--check"] if r == 0 else [])],
                env=env, capture_output=True, text=True, cwd=tree)
            if out.returncode != 0:
                raise RuntimeError(f"{tree}: worker failed:\n{out.stderr}")
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(line, round=r)), flush=True)
            runs[tree].append(line["ms"])
    print(json.dumps({"card": smi, "median_ms": {
        os.path.relpath(t, ROOT): {
            case: statistics.median(run[case] for run in rs)
            for case in rs[0]} for t, rs in runs.items()}}))


if __name__ == "__main__":
    main()
