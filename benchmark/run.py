"""Run one cell of the benchmark of ``ecrad_torch`` once, on one H100.

    python3 benchmark/run.py --workload <config>.<mix> --seed <n> \
        --seconds <s> --trace <0|1>

Set-up builds the port's Config and tables from the cell's configuration
file (``configs/<config>.json``), makes a pool of distinct calls on the
device from the seed (``traffic/<mix>.json``, ``inputs.py``) and warms the
cell's one block shape.  The window then drives
``pipeline.radiation_blocked`` in a closed loop, each call synchronised
before the next starts, for ``--seconds``.  Once it has closed, columns
of calls drawn from the window are held against the plain reference
(``reference/``), which decides ``correct``.

``--trace 0`` reports the cell's end-to-end metrics and wraps nothing.
``--trace 1`` runs ``trace_calls`` calls under torch.profiler with the
three layers' entry points in ranges (``program.spans``) and reports the
per-layer metrics.  Each metric is read by ``metrics/<name>.py``; the
cells, configurations, mixes and metrics are those ``BENCHMARK.json``
names.  The last line of standard output is the result, a JSON object.
"""

from __future__ import annotations

import time

_IMPORTED = time.time()

import argparse  # noqa: E402
import glob  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Top-level module names that may not be loaded in the process that
# prints the result (compared whole: the port's name starts with the JAX
# package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ecrad_tpu")
REFERENCE_BLOCK = 2048          # columns per block of the reference
# The keys every traffic mix has: the window is a closed loop, so a mix
# states no arrivals (an open loop would need a driver of its own)
TRAFFIC_KEYS = ("why", "ncol", "block", "pool_calls", "check_calls",
                "check_columns", "trace_calls")
# The optional keys of a mix and the values each may take, the first what
# its absence means: ``sun``, where the columns' sun is drawn
# (``inputs.make_pool``)
TRAFFIC_OPTIONAL = {"sun": ("any", "day")}
WARM_CALLS = 2


def process_start() -> float:
    """The time (seconds since the epoch) this process started, from
    /proc; the time this module was first run where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - age
    except (OSError, ValueError, IndexError):
        return _IMPORTED


# --- the cell, from BENCHMARK.json and the files it names ---------------

def _load_module(path: str):
    name = "bench_" + os.path.splitext(os.path.basename(path))[0].replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def mix_value(traffic: dict, key: str):
    """A mix's value of an optional key, or what its absence means."""
    return traffic.get(key, TRAFFIC_OPTIONAL[key][0])


def load_cell(name: str, root: str = ROOT) -> types.SimpleNamespace:
    """The cell ``name`` of ``root``/BENCHMARK.json: its configuration file
    (path and contents), its traffic mix (``benchmark/traffic/<mix>.json``)
    and the end-to-end and per-layer metrics it reports, each with its
    reader (``benchmark/metrics/<name>.py``)."""
    here = os.path.join(root, "benchmark")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    w = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    config_path = os.path.join(root, config["file"])
    with open(config_path) as f:
        config_file = json.load(f)
    traffic_path = os.path.join(here, "traffic", w["traffic"] + ".json")
    with open(traffic_path) as f:
        traffic = json.load(f)
    if not set(TRAFFIC_KEYS) <= set(traffic) <= {*TRAFFIC_KEYS,
                                                  *TRAFFIC_OPTIONAL}:
        raise SystemExit(f"{traffic_path}: keys {sorted(traffic)}; a mix "
                         f"has exactly {sorted(TRAFFIC_KEYS)}, and may have "
                         f"{sorted(TRAFFIC_OPTIONAL)}")
    for key, values in TRAFFIC_OPTIONAL.items():
        if mix_value(traffic, key) not in values:
            raise SystemExit(f"{traffic_path}: {key} {traffic[key]!r}; one "
                             f"of {list(values)}")

    def readers(group):
        return {m["name"]: (m, _load_module(
            os.path.join(here, "metrics", m["name"] + ".py")))
            for m in bench[group] if _applies(m, name)}

    return types.SimpleNamespace(
        name=name, chips=w["chips"], config_path=config_path,
        config=config_file, traffic=traffic,
        end_to_end=readers("end_to_end"), per_layer=readers("per_layer"))


def work_modules() -> dict:
    """{kernel: module} of every work count under ``work/``."""
    return {os.path.splitext(os.path.basename(p))[0]: _load_module(p)
            for p in sorted(glob.glob(os.path.join(HERE, "work", "*.py")))
            if not p.endswith("__init__.py")}


# --- the card --------------------------------------------------------------

def smi(query: str):
    """nvidia-smi's reading of ``query`` for the first card, or None."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    res = subprocess.run([exe, f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        return None
    return res.stdout.strip().splitlines()[0].strip()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# --- one run ---------------------------------------------------------------

def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mem(device, what):
    import torch
    if device.type != "cuda":
        return 0
    return getattr(torch.cuda, what)(device)


def check_columns(cell, seed: int, ncalls: int) -> list:
    """The columns checked of each of ``ncalls`` calls, drawn from the
    seed: sorted index tensors of ``check_columns`` each."""
    import torch
    t = cell.traffic
    gen = torch.Generator()
    gen.manual_seed(int(seed) + 1)
    return [torch.randperm(t["ncol"], generator=gen)[:t["check_columns"]]
            .sort().values for _ in range(ncalls)]


def reference_fields(ref, call: dict, cols, solar) -> dict:
    """The reference's fields at the columns ``cols`` of a call, computed
    in blocks of REFERENCE_BLOCK columns."""
    import torch

    from benchmark import inputs
    from benchmark.reference import step as reference_step
    parts = []
    for lo in range(0, cols.numel(), REFERENCE_BLOCK):
        parts.append(reference_step.fluxes(
            ref, inputs.columns(call, cols[lo:lo + REFERENCE_BLOCK]), solar))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def check_calls(cell, ref, pool, kept, seed, solar) -> list:
    """Hold the kept calls' outputs against the reference: for each, the
    numbers of ``check.gaps`` on its columns of ``check_columns``."""
    from benchmark import check
    readings = []
    for cols, (_, pool_index, outputs) in zip(
            check_columns(cell, seed, len(kept)), kept):
        got = {k: v[cols.to(v.device)] for k, v in outputs.items()}
        readings.append(check.gaps(
            got, reference_fields(ref, pool[pool_index], cols, solar)))
    return readings


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             started: float) -> dict:
    """Set up, run the window (or the traced stretch), check and read the
    metrics of one run on ``device``; returns the result object."""
    import torch

    from benchmark import check, inputs, program, trace
    from benchmark.reference import step as reference_step
    t, cfg = cell.traffic, cell.config
    dtype = getattr(torch, cfg["dtype"])
    device = torch.device(device)

    stages = [("imports", time.time())]
    prog = program.build(cell.config_path, device, dtype)
    stages.append(("tables", time.time()))
    profiles = inputs.read_profiles(driver=cfg.get("driver"))
    solar = profiles["solar_irradiance"]
    pool = inputs.make_pool(inputs.profiles_on(profiles, device, dtype),
                            seed, t["pool_calls"], t["ncol"],
                            mix_value(t, "sun"))
    _sync(device)
    stages.append(("inputs", time.time()))
    for i in range(WARM_CALLS):
        program.call(prog, pool[i % len(pool)], t["block"], solar)
    _sync(device)
    stages.append(("warm calls", time.time()))
    setup_peak = _mem(device, "max_memory_allocated")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    base = _mem(device, "memory_allocated")
    reservoir = check.Reservoir(t["check_calls"], seed)
    calls = []
    setup_s = time.time() - started

    def one(i):
        k = i % len(pool)
        start = time.perf_counter()
        flux = program.call(prog, pool[k], t["block"], solar)
        _sync(device)
        calls.append((start, time.perf_counter()))
        reservoir.offer(k, flux)

    result = {}
    if not traced:
        window_start = time.perf_counter()
        deadline = window_start + seconds
        i = 0
        # at least the calls the check draws from, however short the window
        while len(calls) < t["check_calls"] or calls[-1][1] < deadline:
            one(i)
            i += 1
    else:
        def stretch():
            with program.spans():
                for i in range(t["trace_calls"]):
                    with torch.profiler.record_function(program.CALL):
                        one(i)
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            trace.record(stretch, path)
            tr = trace.load(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        lost = trace.lost_kernels(tr)
        if lost:
            print(f"the trace lost {lost} of {len(tr.kernels) + lost} "
                  f"kernels", file=sys.stderr)
    step_peak = _mem(device, "max_memory_allocated") - base
    memory_peak = max(setup_peak, _mem(device, "max_memory_allocated"))
    kept = [(n, k, dict(flux.fields())) for n, k, flux in reservoir.kept]
    reservoir.kept = []
    shapes = (block_shapes(cell, prog.config, pool, len(calls))
              if traced else None)

    # the reference, once the window has closed, its peak is read and the
    # program's state is freed
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_step.setup(cell.config_path, device, torch.float64,
                               dtype)
    readings = check_calls(cell, ref, pool, kept, seed, solar)
    del kept, pool, ref
    limits = cfg["limits"]
    numbers = check.worst(readings)
    failed = sum(not check.verdict(r, limits) for r in readings)

    run = types.SimpleNamespace(calls=calls, ncol=t["ncol"],
                                setup_s=setup_s, step_peak_bytes=step_peak)
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else device.type),
        "count": 1, "memory_peak_bytes": int(memory_peak)}
    if not traced:
        run.window_start = window_start
        metrics = cell.end_to_end
    else:
        lo, hi = trace.window(tr, program.CALL)
        run.trace, run.lo, run.hi = tr, lo, hi
        run.kcol = len(calls) * t["ncol"] / 1000.0
        run.block_shapes = shapes
        run.work = work_modules()
        run.issue_rate = issue_rate(device)
        metrics = cell.per_layer
        device_info.update(busy_s=trace.busy_us(tr, lo, hi) * 1e-6,
                           window_s=(hi - lo) * 1e-6)
        result["breakdown"] = {
            "device_ops": trace.top_device_ops(tr, lo, hi),
            "idle_gaps": trace.idle_gaps(tr, lo, hi, tid=trace.thread_of(
                tr, program.CALL))}
    values = {}
    for name, (meta, reader) in metrics.items():
        value = reader.read(run)
        if value is not None:
            values[name] = {"value": value, "unit": meta["unit"]}
    out = {"correct": check.verdict(numbers, limits),
           "attempted": len(calls), "failed": failed, "metrics": values,
           "device": device_info}
    out.update(result)
    marks = [started] + [at for _, at in stages]
    out["setup_stages_s"] = {name: marks[i + 1] - marks[i]
                             for i, (name, _) in enumerate(stages)}
    out["checked"] = check.report(numbers, limits)
    return out


def block_shapes(cell, config, pool, ncalls: int) -> list:
    """The shape of each block of the first ``ncalls`` calls, in launch
    order, for the kernels' work counts: columns, levels, g-points and
    bands of each band set, the bytes of a float, whether the solvers
    write per-g flux planes (spectral flux output per band or per
    g-point), and the block's share of cloudy (column, layer) pairs (its
    padding repeats the last column)."""
    import torch

    from benchmark import inputs
    t, cfg = cell.traffic, cell.config
    thr = (cfg["config"]["cloud_fraction_threshold"],
           cfg["config"]["cloud_mixing_ratio_threshold"])
    itemsize = torch.empty((), dtype=getattr(torch, cfg["dtype"])
                           ).element_size()
    planes = bool(cfg["config"]["do_save_spectral_flux"]
                  or cfg["config"]["do_save_gpoint_flux"])
    shapes = []
    for i in range(ncalls):
        call = pool[i % len(pool)]
        for lo in range(0, t["ncol"], t["block"]):
            cols = torch.arange(lo, lo + t["block"]).clamp(max=t["ncol"] - 1)
            shapes.append(dict(
                ncol=t["block"], nlev=cfg["nlev"], ng_sw=config.n_g_sw,
                ng_lw=config.n_g_lw, nband_sw=config.n_bands_sw,
                nband_lw=config.n_bands_lw, itemsize=itemsize,
                planes=planes,
                cloudy=inputs.cloudy_fraction(inputs.columns(call, cols),
                                              *thr)))
    return shapes


def issue_rate(device):
    """The card's integer issue rate (instructions per second), or None
    off the card."""
    import torch

    from benchmark import peaks
    clock = smi("clocks.max.sm")
    if device.type != "cuda" or clock is None:
        return None
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return peaks.issue_per_s(sms, float(clock))


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" present", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", started)
    found = forbidden_modules()
    if found:
        print(f"modules that may not be loaded: {found}", file=sys.stderr)
        return 3
    limit = smi("power.limit")
    print(f"card: {out['device']['kind']}, power limit {limit} W",
          file=sys.stderr)
    for name, v in out["checked"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
