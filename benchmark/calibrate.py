"""The readings the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds N \
        [--control-seeds M] [--first-seed S]

For each of N seeds: the pool the run would make, ``check_calls`` calls
through the program at the cell's size, and the numbers of ``check.gaps``
on the columns a run would check (the lower readings).  For the first M
of them the control in the program's place: the plain reference computed
in bfloat16, the precision below the configuration's float32, and, beside
it, in float32 with TF32 matrix products (its numbers are reported, not
used).  One JSON line per reading, with the largest gap of every field
beside the numbers, then a summary line with the largest lower and the
smallest upper reading of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402


def readings(cell, seeds, control_seeds, device):
    """Yield one dict per reading: kind ("program", "bf16", "tf32"), seed
    and the numbers."""
    import torch

    from benchmark import check, inputs, program
    from benchmark.reference import step as reference_step
    t, cfg = cell.traffic, cell.config
    dtype = getattr(torch, cfg["dtype"])
    device = torch.device(device)
    prog = program.build(cell.config_path, device, dtype)
    profiles = inputs.read_profiles(driver=cfg.get("driver"))
    solar = profiles["solar_irradiance"]
    on_device = inputs.profiles_on(profiles, device, dtype)
    ref = reference_step.setup(cell.config_path, device, torch.float64,
                               dtype)
    controls = {"bf16": reference_step.setup(
        cell.config_path, device, torch.bfloat16, torch.bfloat16)}
    if device.type == "cuda":
        controls["tf32"] = reference_step.setup(
            cell.config_path, device, torch.float32, torch.float32)
    for n, seed in enumerate(seeds):
        pool = inputs.make_pool(on_device, seed, t["pool_calls"], t["ncol"],
                                run.mix_value(t, "sun"))
        ncalls = t["check_calls"]
        columns = run.check_columns(cell, seed, ncalls)
        for i, cols in enumerate(columns):
            call = pool[i % len(pool)]
            fields = program.call(prog, call, t["block"], solar).fields()
            got = {k: v[cols.to(v.device)] for k, v in fields.items()}
            del fields
            want = run.reference_fields(ref, call, cols, solar)
            yield dict(kind="program", seed=seed, call=i,
                       **check.gaps(got, want),
                       fields=check.field_gaps(got, want))
            if n >= control_seeds:
                continue
            for kind, c in controls.items():
                tf32 = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = kind == "tf32"
                try:
                    low = run.reference_fields(c, call, cols, solar)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                yield dict(kind=kind, seed=seed, call=i,
                           **check.gaps(low, want),
                           fields=check.field_gaps(low, want))


def summary(rows) -> dict:
    from benchmark import check
    out = {}
    for kind in sorted({r["kind"] for r in rows}):
        mine = [r for r in rows if r["kind"] == kind]
        pick = max if kind == "program" else min
        out[kind] = {k: pick(r[k] for r in mine) for k in check.NUMBERS}
        out[kind]["seeds"] = len({r["seed"] for r in mine})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    rows = []
    for r in readings(cell, seeds, args.control_seeds, args.device):
        rows.append(r)
        print(json.dumps(r), flush=True)
    print(json.dumps({"workload": args.workload, **summary(rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
