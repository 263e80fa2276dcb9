"""Column parallelism of the port over devices and processes, and its
debug matrix printer (CPU, f64).

* pipeline.radiation_sharded of the flagship over 1 and 8 CPU "devices"
  (pipeline.make_mesh with named devices), at 16 columns and at 13, which
  do not divide: every field equal bit for bit to radiation_blocked with
  the slabs' column blocks, and within 1e-10 W m-2 of one radiation_step
  over all columns (1e-13 dimensionless).  One device is radiation_step
  itself, bit for bit.  Not bit for bit across other block shapes: torch's
  CPU elementwise kernels round a tensor's vectorised body and its scalar
  tail differently (exp, pow), so a column's last bits depend on where it
  falls in its tensor; on the card each kernel and elementwise launch
  treats every element alike, and chip_smoke.py holds the sharded run to
  radiation_blocked over equal blocks bit for bit.
* shard_inputs pads by repeating the last column and puts each slab on
  its device; make_mesh raises without a card unless devices are named.
* distributed.column_slab tiles the columns over the ranks; a rank reads
  only its slab (read_input_distributed); two processes joined with gloo
  (tests/torch_dist_worker.py) give, concatenated, the fluxes of one
  process's radiation_sharded over two CPU devices bit for bit (one CPU
  thread everywhere, so that both order each slab's work alike), and a
  single process initialises nothing.
* utils.print_matrix prints what the JAX package's prints.
"""

import io
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from ecrad_tpu import utils as jutils
from ecrad_torch import distributed, flagship, pipeline, utils
from ecrad_torch.data import DATA_DIR, MERIDIAN_INPUT
from ecrad_torch.interface import setup_radiation
from ecrad_torch.io.input import DriverConfig, read_input

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ATOL, ATOL_DIMLESS = 1e-10, 1e-13
DIMLESS = ("lw_derivatives", "cloud_cover_lw", "cloud_cover_sw")


@pytest.fixture(scope="module")
def built():
    torch.set_num_threads(1)
    step, args = flagship.build(ncol=16, dtype=torch.float64, device="cpu")
    return step, dict(zip(flagship.ARG_ORDER, args))


def _cut(kw, ncol):
    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        return x[:ncol] if torch.is_tensor(x) and x.dim() else x
    return cut(kw)


def _assert_equal(got, ref):
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert torch.equal(got[k], r), k


@pytest.mark.parametrize("ncol", [16, 13])
@pytest.mark.parametrize("n_dev", [1, 8])
def test_sharded_equals_blocked_and_step(built, n_dev, ncol):
    step, kw = built
    kw = _cut(kw, ncol)
    torch.set_num_threads(1)
    mesh = pipeline.make_mesh(devices=[CPU] * n_dev)
    run = dict(solar_irradiance=step.solar, **kw)
    got = pipeline.radiation_sharded(step.config, step.tables, mesh,
                                     **run).fields()
    one = pipeline.radiation_step(step.config, step.tables, **run).fields()
    per = -(-ncol // n_dev)
    blocked = pipeline.radiation_blocked(step.config, step.tables,
                                         block_size=per, **run).fields()
    _assert_equal(got, blocked)
    if n_dev == 1:
        _assert_equal(got, one)
    for k, r in one.items():
        assert got[k].shape[0] == ncol, k
        atol = ATOL_DIMLESS if k in DIMLESS else ATOL
        torch.testing.assert_close(got[k], r, rtol=0, atol=atol, msg=k)


def test_sharded_with_blocks(built):
    step, kw = built
    torch.set_num_threads(1)
    mesh = pipeline.make_mesh(devices=[CPU] * 2)
    run = dict(solar_irradiance=step.solar, **kw)
    got = pipeline.radiation_sharded(step.config, step.tables, mesh,
                                     block_size=3, **run).fields()
    # each slab of 8 in blocks of 3: blocks [0, 3), [3, 6), [6, 8) + a pad
    ref = {k: torch.cat([pipeline.radiation_blocked(
        step.config, step.tables, block_size=3, solar_irradiance=step.solar,
        **{n: (v[i:i + 8] if torch.is_tensor(v) else
               {c: w[i:i + 8] for c, w in v.items()})
           for n, v in kw.items()}).fields()[k] for i in (0, 8)])
        for k in got}
    _assert_equal(got, ref)


def test_shard_inputs_pads_and_places():
    tree = {"a": torch.arange(5.0), "b": {"c": torch.arange(10.0).view(5, 2)},
            "scalar": torch.tensor(3.0), "n": None}
    slabs = pipeline.shard_inputs([CPU] * 3, tree, 5)
    assert [s["a"].tolist() for s in slabs] == [[0, 1], [2, 3], [4, 4]]
    assert slabs[2]["b"]["c"].tolist() == [[8, 9], [8, 9]]
    assert all(s["scalar"].item() == 3.0 and s["n"] is None for s in slabs)


def test_make_mesh():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipeline.make_mesh()
    assert pipeline.make_mesh(devices=["cpu"] * 8) == (CPU,) * 8
    assert pipeline.make_mesh(3, devices=["cpu"] * 8) == (CPU,) * 3
    with pytest.raises(ValueError):
        pipeline.make_mesh(9, devices=["cpu"] * 8)


@pytest.mark.parametrize("ncol, world", [(32, 2), (30, 4), (7, 3)])
def test_column_slab_tiles_the_columns(monkeypatch, ncol, world):
    slabs = []
    for rank in range(world):
        monkeypatch.setattr(distributed, "_world", lambda r=rank: (world, r))
        slabs.append(distributed.column_slab(ncol))
    per = -(-ncol // world)
    assert all(padded == per * world for _, _, padded in slabs)
    assert slabs[0][0] == 0 and slabs[-1][1] == ncol
    for (_, stop, _), (start, _, _) in zip(slabs, slabs[1:]):
        assert stop == start
    assert all(stop - start <= per for start, stop, _ in slabs)


def test_single_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert distributed.column_slab(30) == (0, 30, 30)
    inp, (start, stop, ncol) = distributed.read_input_distributed(
        MERIDIAN_INPUT)
    full = read_input(MERIDIAN_INPUT)
    assert (start, stop, ncol) == (0, 32, 32)
    np.testing.assert_array_equal(inp.gas_mmr, full.gas_mmr)
    part = read_input(MERIDIAN_INPUT, col_range=(8, 20))
    np.testing.assert_array_equal(part.iseed, full.iseed[8:20])
    np.testing.assert_array_equal(part.thermodynamics.pressure_hl,
                                  full.thermodynamics.pressure_hl[8:20])


def test_make_global_inputs_pads_the_slab(monkeypatch):
    monkeypatch.setattr(distributed, "_world", lambda: (4, 3))
    tree = {"x": torch.arange(6.0).view(3, 2), "c": {"y": torch.ones(3)},
            "s": 1.5}
    out, padded = distributed.make_global_inputs(tree, 3, 15, "cpu")
    assert padded == 16
    assert out["x"].tolist() == [[0, 1], [2, 3], [4, 5], [4, 5]]
    assert out["c"]["y"].shape == (4,) and out["s"] == 1.5


def _without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    return {"x": torch.arange(6.0).view(3, 2)}


@pytest.mark.parametrize("call", [
    lambda tree: distributed.global_mesh(),
    lambda tree: distributed.local_device(),
    lambda tree: distributed.make_global_inputs(tree, 3, 3)],
    ids=["global_mesh", "local_device", "make_global_inputs"])
def test_no_cpu_fallback_without_a_card(monkeypatch, call):
    """Without a card the process-parallel path raises unless the CPU is
    named: it does not carry on on the CPU."""
    tree = _without_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(tree)


def test_named_cpu_without_a_card(monkeypatch):
    tree = _without_card(monkeypatch)
    out, padded = distributed.make_global_inputs(tree, 3, 3, device="cpu")
    assert padded == 3 and out["x"].device.type == "cpu"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_run():
    """Two gloo ranks on the CPU, each reading its slab of the meridian
    file, against one process's radiation_sharded over two slabs."""
    world, port = 2, _free_port()
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_dist_worker.py"),
             str(r), str(world), str(port), MERIDIAN_INPUT, out, "cpu",
             "float64", "0"], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
        shards = [dict(np.load(os.path.join(out, f"shard{r}.npz")))
                  for r in range(world)]
    assert [(int(s.pop("start")), int(s.pop("stop"))) for s in shards] \
        == [(0, 16), (16, 32)]
    got = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}

    torch.set_num_threads(1)
    config, tables = setup_radiation(flagship.flagship_config("float64"),
                                     "cpu", torch.float64, data_dir=DATA_DIR)
    inp = read_input(MERIDIAN_INPUT, DriverConfig(**flagship.DRIVER_SETTINGS))
    kw = dict(zip(flagship.ARG_ORDER,
                  flagship.inputs_from(inp, torch.float64, "cpu")))
    ref = pipeline.radiation_sharded(
        config, tables, [CPU] * world,
        solar_irradiance=float(inp.solar_irradiance), **kw).fields()
    assert set(got) == set(ref)
    for k, r in ref.items():
        np.testing.assert_array_equal(got[k], r.numpy(), err_msg=k)


@pytest.mark.parametrize("shape", [(5,), (3, 4), (6, 2, 2), (2, 3, 3)])
def test_print_matrix_matches_jax(shape):
    x = np.random.default_rng(7).normal(size=shape) * 1e3
    outs = []
    for fn, arg in ((jutils.print_matrix, x),
                    (utils.print_matrix, torch.as_tensor(x)),
                    (utils.print_matrix, x)):
        buf = io.StringIO()
        fn(arg, "gamma", file=buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == outs[2]
    assert outs[0].startswith("gamma")
