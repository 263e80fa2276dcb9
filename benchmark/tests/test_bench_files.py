"""Every configuration, traffic mix and metric that BENCHMARK.json names is
found by name, and a new one is found by adding files and entries only."""

import json
import os
import re
import shutil

import pytest

from benchmark import run

ROOT = run.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = run.load_cell(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.config["name"] == w["config"]
    assert set(c.traffic) == set(run.TRAFFIC_KEYS)
    assert c.traffic["check_columns"] <= c.traffic["ncol"]
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer
    for meta, reader in (*c.end_to_end.values(), *c.per_layer.values()):
        assert callable(reader.read), meta["name"]
    assert set(c.config["limits"]) == set(
        __import__("benchmark.check").check.NUMBERS)


def test_every_metric_has_a_reader():
    names = {m["name"] for g in ("end_to_end", "per_layer") for m in BENCH[g]}
    have = {os.path.splitext(p)[0] for p in os.listdir(
        os.path.join(ROOT, "benchmark", "metrics")) if p.endswith(".py")}
    assert names <= have


def test_every_config_file_holds_its_reduced_keys():
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg["config"])
        assert cfg["reduced"] == c["reduced"]


def test_work_counts_found_by_name():
    work = run.work_modules()
    assert {"generator_draw_scan", "lw_fused", "sw_fused", "rrtmg_lw_taumol",
            "rrtmg_sw_taumol", "spartacus_lw", "spartacus_sw"} <= set(work)
    for name, module in work.items():
        assert name.endswith(module.KERNEL.removesuffix("_kernel")), name


def test_new_files_found_by_name(tmp_path):
    """A configuration, a mix, a cell and a metric added as files and
    entries, in a copy of the benchmark, are found with no code change."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests",
                                                  "reference"))
    bench = json.loads(json.dumps(BENCH))
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "mcica_rrtmg.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "mcica_rrtmg_copy"
    (root / "benchmark" / "configs" / "mcica_rrtmg_copy.json").write_text(
        json.dumps(cfg))
    (root / "benchmark" / "traffic" / "rank1k.json").write_text(json.dumps(
        dict(why="1,024 columns a call", ncol=1024, block=1024, pool_calls=4, check_calls=2,
             check_columns=1024, trace_calls=4)))
    (root / "benchmark" / "metrics" / "calls_done.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    bench["configs"].append(dict(
        name="mcica_rrtmg_copy", source="https://example.org/x",
        file="benchmark/configs/mcica_rrtmg_copy.json", reduced=[],
        why="a copy"))
    bench["workloads"].append(dict(
        name="mcica_rrtmg_copy.rank1k", config="mcica_rrtmg_copy",
        traffic="rank1k", chips=1, why="a new cell"))
    bench["per_layer"].append(dict(
        name="calls_done", unit="calls", better="higher",
        source="host_clock", layer="device", moves="cols_per_s",
        workloads=["mcica_rrtmg_copy.rank1k"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = run.load_cell("mcica_rrtmg_copy.rank1k", root=str(root))
    assert c.traffic["ncol"] == 1024
    assert c.config["name"] == "mcica_rrtmg_copy"
    assert "calls_done" in c.per_layer
    reader = c.per_layer["calls_done"][1]
    assert reader.read(type("R", (), {"calls": [1, 2]})) == 2.0
    other = run.load_cell("mcica_rrtmg.rank2k", root=str(root))
    assert "calls_done" not in other.per_layer


@pytest.mark.parametrize("change", ["unknown", "missing"])
def test_a_mix_with_other_keys_is_refused(tmp_path, change):
    """A mix that states what the harness does not do (an open loop), or
    leaves out a size, stops the run before set-up."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "benchmark", "traffic"),
                    root / "benchmark" / "traffic")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    (root / "benchmark" / "configs").mkdir()
    for c in BENCH["configs"]:
        shutil.copy(os.path.join(ROOT, c["file"]), root / c["file"])
    path = root / "benchmark" / "traffic" / "rank2k.json"
    mix = json.loads(path.read_text())
    if change == "unknown":
        mix["loop"] = "open"
    else:
        del mix["trace_calls"]
    path.write_text(json.dumps(mix))
    with pytest.raises(SystemExit, match="a mix has exactly"):
        run.load_cell(next(c for c in CELLS if c.endswith(".rank2k")),
                      root=str(root))


@pytest.mark.parametrize("sun", ["day", "any", "night"])
def test_a_mix_may_state_its_sun(tmp_path, sun):
    """A mix may add ``sun``, "day" or "any"; another value stops the run
    before set-up, and a mix without it draws as "any"."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests",
                                                  "reference"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    path = root / "benchmark" / "traffic" / "rank2k.json"
    mix = json.loads(path.read_text())
    assert run.mix_value(mix, "sun") == "any"
    mix["sun"] = sun
    path.write_text(json.dumps(mix))
    cell = next(c for c in CELLS if c.endswith(".rank2k"))
    if sun == "night":
        with pytest.raises(SystemExit, match="sun 'night'; one of"):
            run.load_cell(cell, root=str(root))
    else:
        c = run.load_cell(cell, root=str(root))
        assert run.mix_value(c.traffic, "sun") == sun


def test_every_mix_has_the_keys_the_readme_names():
    """Each mix file has the keys every mix has, and of the optional ones
    only those the README's table of files names, with a value it
    names; allday16k puts every column in daylight."""
    with open(os.path.join(ROOT, "benchmark", "README.md")) as f:
        row = next(line for line in f if line.startswith("| a traffic mix"))
    named = set(re.findall(r"`([a-z_]+)`", row))
    assert set(run.TRAFFIC_KEYS) | set(run.TRAFFIC_OPTIONAL) <= named
    for values in run.TRAFFIC_OPTIONAL.values():
        assert set(values) <= named
    mixes = {}
    for p in sorted(os.listdir(os.path.join(ROOT, "benchmark", "traffic"))):
        with open(os.path.join(ROOT, "benchmark", "traffic", p)) as f:
            mixes[p.removesuffix(".json")] = json.load(f)
    for name, mix in mixes.items():
        assert set(run.TRAFFIC_KEYS) <= set(mix), name
        assert set(mix) <= set(run.TRAFFIC_KEYS) | set(run.TRAFFIC_OPTIONAL)
    assert mixes["allday16k"]["sun"] == "day"
    assert {k: mixes["allday16k"][k] for k in run.TRAFFIC_KEYS[1:]} == dict(
        ncol=16384, block=8192, pool_calls=3, check_calls=2,
        check_columns=2048, trace_calls=3)
