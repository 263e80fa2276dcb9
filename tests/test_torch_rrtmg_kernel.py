"""The RRTMG gas optics kernels (ecrad_torch/csrc/rrtmg_gas.cu) on the CPU:
the packed tables they read against what the plain band functions read,
their wrappers (cuda_rrtmg.lw_taumol, sw_taumol), and the kernel source
itself compiled with g++ through a thread-per-CUDA-thread stand-in for the
CUDA runtime (tests/cuda_cpu/cuda_runtime.h), against the plain versions
in float64 and float32.  The build with nvcc and the runs on the card are
chip_smoke.py's."""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from ecrad_torch import kernels
from ecrad_torch.interface import _to_tensors
from ecrad_torch.optics import cuda_rrtmg, rrtmg, rrtmg_lw, rrtmg_sw
from ecrad_torch.optics.rrtmg_prepare import GasColumns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "ecrad_torch", "csrc", "rrtmg_gas.cu")
BANDS = [("lw", b) for b in cuda_rrtmg.LW_BANDS] + [
    ("sw", b) for b in cuda_rrtmg.SW_BANDS]


def random_state(ncol, nlev, dtype, seed=0):
    """Half-level pressure (a few Pa to ~1000 hPa) and temperature, the
    gases' mass mixing ratios, skin temperature: a random atmosphere that
    spans both RRTMG atmospheres and every eta regime."""
    rng = np.random.default_rng(seed)
    top, sfc = rng.uniform(1, 20, ncol), rng.uniform(8e4, 1.05e5, ncol)
    x = np.linspace(0.0, 1.0, nlev + 1) ** 0.7
    p = np.exp(np.log(top)[:, None] + np.log(sfc / top)[:, None] * x)
    t = rng.uniform(180.0, 310.0, (ncol, nlev + 1))
    col = lambda lo, hi: rng.uniform(lo, hi, (ncol, 1))  # noqa: E731
    gas = {"h2o": 10 ** rng.uniform(-6, -1.8, (ncol, nlev)),
           "o3": 10 ** rng.uniform(-8, -5, (ncol, nlev)),
           "co2": 6e-4 * col(0.5, 3.0), "ch4": 1e-6 * col(0.5, 2.0),
           "n2o": 4.7e-7 * col(0.5, 2.0), "cfc11": 1e-9, "cfc12": 2e-9,
           "hcfc22": 5e-10, "ccl4": 4e-10}
    as_t = lambda a: torch.as_tensor(  # noqa: E731
        np.array(np.broadcast_to(a, (ncol, nlev))), dtype=dtype)
    return (torch.as_tensor(p, dtype=dtype), torch.as_tensor(t, dtype=dtype),
            {k: as_t(v) for k, v in gas.items()},
            torch.as_tensor(rng.uniform(200.0, 320.0, ncol), dtype=dtype))


@pytest.fixture(scope="module")
def tables():
    return _to_tensors(rrtmg.setup_tables(), "cpu", torch.float64)


@pytest.fixture(scope="module")
def state(tables):
    p, t, gas, skin = random_state(3, 20, torch.float64)
    return rrtmg.gas_columns(tables, p, t, gas), t, skin


# --- the packed tables -------------------------------------------------------

def slot_view(tables, band_set, name):
    """The packed buffer's entries of one slot (a flat tensor)."""
    slots = cuda_rrtmg.LW_SLOTS if band_set == "lw" else cuda_rrtmg.SW_SLOTS
    i = [s[0] for s in slots].index(name)
    layout = tables[f"kernel:{band_set}_layout"]
    return tables[f"kernel:{band_set}"][layout[i]:layout[i + 1]]


class _Reads(dict):
    """A band's table dict that records the keys read."""

    def __init__(self, d):
        super().__init__(d)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _run_band(tables, cols, band_set, b):
    """Run the plain band function on a recording copy of its tables:
    (keys read, chi_mls ratios formed, per-g vectors made)."""
    ratios, vectors, chi = [], [], []
    if band_set == "lw":
        lw_tables = {k[3:]: v for k, v in tables.items()
                     if k.startswith("lw:")}
        tb = rrtmg_lw._Band(lw_tables, cols, b,
                            tables["chi_mls"].numpy())
        fn = rrtmg_lw._BAND_FNS[b - 1]

        def chi_const(species, jp):
            chi.append(rrtmg_lw._Band.chi_const(tb, species, jp))
            return chi[-1]
        tb.chi_const = chi_const
    else:
        sw_tables = {k[3:]: v for k, v in tables.items()
                     if k.startswith("sw:")}
        tb = rrtmg_sw._SwBand(sw_tables, cols, b)
        fn = rrtmg_sw._SW_BAND_FNS[b]
    tb.t = _Reads(tb.t)
    gvec = tb.gvec

    def recording_gvec(vec):
        if not torch.is_tensor(vec):
            vectors.append(np.asarray(vec, dtype=np.float64))
        return gvec(vec)
    tb.gvec = recording_gvec
    fn(tb)
    ratios = [a / b for a, b in zip(chi[0::2], chi[1::2])]
    return tb.t.read, ratios, vectors


@pytest.mark.parametrize("band_set,b", BANDS,
                         ids=[f"{s}{b}" for s, b in BANDS])
def test_pack_holds_what_the_band_reads(tables, state, band_set, b):
    """Each band's slots hold exactly the tables its plain band function
    reads, row for row as the kernel addresses them (g-points last), the
    chi_mls ratios it forms, in its order, and the per-g vectors it
    makes."""
    cols = state[0]
    read, ratios, vectors = _run_band(tables, cols, band_set, b)
    bands = cuda_rrtmg.LW_BANDS if band_set == "lw" else cuda_rrtmg.SW_BANDS
    slots = [(n, src) for n, bb, src in (
        cuda_rrtmg.LW_SLOTS if band_set == "lw" else cuda_rrtmg.SW_SLOTS)
        if bb == b]
    assert len(slots) == len(bands[b])
    keys = {src if isinstance(src, str) else src[1] for _, src in slots
            if isinstance(src, str) or src[0] in ("fill", "scalar")}
    assert keys == read
    ng = np.bincount(tables[f"{band_set}_band_from_g"].numpy())[
        b - (1 if band_set == "lw" else 16)]
    got_ratios, got_vectors = [], []
    for name, src in slots:
        got = slot_view(tables, band_set, name).numpy()
        if isinstance(src, str):
            table = tables[f"{band_set}:{b}/{src}"]
            if not torch.is_tensor(table):                  # a scalar
                assert got.tolist() == [table], name
                continue
            table = table.numpy()
            if src in ("fracrefa", "fracrefb", "sfluxref", "rayla") \
                    and table.ndim == 2:
                table = table.T                          # (g, eta) in torch
            np.testing.assert_array_equal(got.reshape(-1, ng),
                                          table.reshape(-1, ng), name)
        elif src[0] == "fill":
            assert got.tolist() == [tables[f"{band_set}:{b}/{src[1]}"]] * ng
            got_vectors.append(got)
        elif src[0] == "scalar":
            assert got.tolist() == [tables[f"{band_set}:{b}/{src[1]}"]
                                    * src[2]], name
        elif src[0] == "ratio":
            got_ratios.append(float(got[0]))
        else:
            got_vectors.append(got)
    assert got_ratios == ratios
    assert len(got_vectors) == len(vectors)
    for got, want in zip(got_vectors, vectors):
        np.testing.assert_array_equal(got, want)


def test_pack_shared_slots_and_layout(tables):
    """The slots all bands share, and the layout: slots end to end, the
    bands' g-points in order, 140 LW and 112 SW."""
    view = lambda s, n: slot_view(tables, s, n)  # noqa: E731
    assert torch.equal(view("lw", "L_CHI_MLS"), tables["chi_mls"].ravel())
    assert torch.equal(view("lw", "L_TOTPLNK"), tables["totplnk"].ravel())
    assert torch.equal(view("lw", "L_PLANCK_SCALE"),
                       cuda_rrtmg.FLUXFAC * tables["delwave"])
    assert torch.equal(view("sw", "S_ONES"), torch.ones(12,
                                                        dtype=torch.float64))
    for band_set, slots, nband, ng in (("lw", cuda_rrtmg.LW_SLOTS, 16, 140),
                                       ("sw", cuda_rrtmg.SW_SLOTS, 14, 112)):
        layout = tables[f"kernel:{band_set}_layout"]
        off, gstart = layout[:len(slots) + 1], layout[len(slots) + 1:]
        assert off[0] == 0 and all(a < b for a, b in zip(off, off[1:]))
        assert off[-1] == tables[f"kernel:{band_set}"].numel()
        counts = np.bincount(tables[f"{band_set}_band_from_g"].numpy())
        assert list(gstart) == [0, *np.cumsum(counts)]
        assert len(gstart) == nband + 1 and gstart[-1] == ng


def _enum(source, name):
    body = re.search(r"enum " + name + r" \{(.*?)\};", source, re.S).group(1)
    return [w.strip() for w in body.split(",") if w.strip()]


def test_kernel_enums_match_the_python_lists():
    """The kernel's slot and field enums name the packed slots and the
    GasColumns fields in the order the wrappers pass them."""
    source = open(SOURCE).read()
    assert _enum(source, "LwSlot") == [
        s[0] for s in cuda_rrtmg.LW_SLOTS] + ["kNLwSlot"]
    assert _enum(source, "SwSlot") == [
        s[0] for s in cuda_rrtmg.SW_SLOTS] + ["kNSwSlot"]
    assert _enum(source, "FField") == [
        "F_" + f.upper() for f in cuda_rrtmg.FLOAT_FIELDS] + ["kNFField"]
    assert _enum(source, "IField") == [
        "I_" + f.upper() for f in cuda_rrtmg.INT_FIELDS] + [
        "I_TROPO", "kNIField"]
    assert set(cuda_rrtmg.FLOAT_FIELDS + cuda_rrtmg.INT_FIELDS) | {
        "tropo", "chi_jp1"} == set(GasColumns._fields)


def test_pack_checks_the_shapes_the_kernel_takes(tables):
    """A table of another shape than the kernel hard-codes, or g-points out
    of band order, are refused at set-up."""
    host = {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in tables.items()}
    bad = dict(host, **{"lw:3/ka": host["lw:3/ka"][:, :, :8]})
    with pytest.raises(ValueError, match="lw:3/ka"):
        cuda_rrtmg.pack_tables(bad)
    bad = dict(host, sw_band_from_g=host["sw_band_from_g"][::-1])
    with pytest.raises(ValueError, match="band order"):
        cuda_rrtmg.pack_tables(bad)


# --- the wrappers ------------------------------------------------------------

def _calls(tables, cols, t, skin):
    return {"lw": (cuda_rrtmg.lw_taumol, cuda_rrtmg.lw_taumol_plain,
                   (tables, cols, t, skin, 1e-15)),
            "sw": (cuda_rrtmg.sw_taumol, cuda_rrtmg.sw_taumol_plain,
                   (tables, cols, 0.0))}


@pytest.mark.parametrize("band_set", ["lw", "sw"])
def test_wrapper_runs_the_plain_version_on_the_cpu(tables, state, band_set):
    wrapper, plain, args = _calls(tables, *state)[band_set]
    before = wrapper.launches
    got, want = wrapper(*args), plain(*args)
    assert wrapper.launches == before
    assert len(got) == 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _meta(x):
    if torch.is_tensor(x):
        return x.to("meta")
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    return x


# What a launch refuses: (case, the arguments changed, the message)
def _bad(case, tables, cols, t, skin):
    if case == "dtype":
        cols = cols._replace(**{f: getattr(cols, f).half()
                                for f in cuda_rrtmg.FLOAT_FIELDS})
    elif case == "shape":
        cols = cols._replace(fac00=cols.fac00[:, :-1])
    elif case == "layout":
        cols = cols._replace(fac10=cols.fac10.t().contiguous().t())
    elif case == "index":
        cols = cols._replace(jp=cols.jp.int())
    elif case == "tables":
        tables = {k: v for k, v in tables.items()
                  if not k.startswith("kernel:")}
    return tables, cols, t, skin


BAD = {"device": "unsupported device", "dtype": "unsupported dtype",
       "shape": "fac00 has shape", "layout": "fac10 is not contiguous",
       "index": "jp must be torch.int64",
       "tables": "no packed kernel buffers"}


@pytest.mark.parametrize("band_set", ["lw", "sw"])
@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_raises_off_the_cpu(tables, state, band_set, case):
    """Tensors on a device other than the CPU go to the kernel: what it
    does not take raises (the device last), with no fallback to the plain
    version and no launch."""
    cols, t, skin = state
    meta = (_meta(tables), GasColumns(*(c.to("meta") for c in cols)),
            t.to("meta"), skin.to("meta"))
    wrapper, _, args = _calls(*_bad(case, *meta))[band_set]
    before = wrapper.launches
    with pytest.raises(ValueError, match=BAD[case]):
        wrapper(*args)
    assert wrapper.launches == before


def test_lw_wrapper_checks_the_temperatures(tables, state):
    cols, t, skin = state
    with pytest.raises(ValueError, match="temperature_hl has shape"):
        cuda_rrtmg.lw_taumol(_meta(tables), GasColumns(
            *(c.to("meta") for c in cols)), t[:, 1:].to("meta"),
            skin.to("meta"), 1e-15)


# --- the kernel source, run on the CPU ---------------------------------------

@pytest.fixture(scope="module")
def cpu_kernels(tmp_path_factory):
    """rrtmg_gas.cu built with g++: each launch ``k<<<blocks, threads, ...>>>
    (args)`` becomes a loop over blocks, each block one std::thread per
    CUDA thread with a barrier for __syncthreads."""
    tmp = tmp_path_factory.mktemp("rrtmg_cpu")
    src = re.sub(r"(\w+<\w+>)\s*<<<\s*([^,]+),\s*([^,]+),[^>]*>>>\(\s*",
                 r"shim_launch(\1, \2, \3, ", open(SOURCE).read())
    cc, lib = tmp / "rrtmg_gas.cc", tmp / "librrtmg_gas_cpu.so"
    cc.write_text(src)
    res = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-I", os.path.join(REPO, "tests", "cuda_cpu"), "-o", str(lib),
         str(cc)],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(lib))
    for name in ("ecrad_rrtmg_lw_taumol", "ecrad_rrtmg_sw_taumol"):
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = kernels._SIGNATURES[name]
            fn.restype = ctypes.c_int
    return lib


def _cpu_launch(lib, band_set, tables, cols, t, skin, min_od):
    """The wrapper's launch, on CPU tensors."""
    ncol, nlev = cols.colh2o.shape
    dtype = cols.colh2o.dtype
    fields = [getattr(cols, f) for f in cuda_rrtmg.FLOAT_FIELDS
              + cuda_rrtmg.INT_FIELDS] + [cols.tropo]
    e = lambda *shape: torch.full(shape, float("nan"),  # noqa: E731
                                  dtype=dtype)
    pack = tables[f"kernel:{band_set}"]
    layout = tables[f"kernel:{band_set}_layout"]
    if band_set == "lw":
        out = (e(ncol, nlev, 140), e(ncol, nlev + 1, 140), e(ncol, 140))
        ptrs = fields + [t, skin, pack, *out]
    else:
        out = (e(ncol, nlev, 112), e(ncol, nlev, 112), e(ncol, 112))
        ptrs = fields + [pack, *out]
    fn = getattr(lib, f"ecrad_rrtmg_{band_set}_taumol"
                 + ("_f32" if dtype == torch.float32 else "_f64"))
    code = fn(kernels.pointer_array(ptrs),
              cuda_rrtmg._layout_array(layout), ncol, nlev, min_od, None)
    assert code == 0
    return out


SHAPES = [(3, 30), (2, 137), (5, 7), (1, 2)]


@pytest.mark.parametrize("band_set", ["lw", "sw"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{c}x{n}" for c, n in SHAPES])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_source_matches_plain(cpu_kernels, band_set, shape, dtype):
    """The kernels' own code against the plain versions: float64 within
    1e-12 of each value (with a floor of 1e-12 of the largest), float32
    within 1e-5 relative (od, Planck and ssa) of the plain float32 result;
    every output written, ragged row counts included."""
    tables = _to_tensors(rrtmg.setup_tables(), "cpu", dtype)
    p, t, gas, skin = random_state(*shape, dtype, seed=sum(shape))
    cols = rrtmg.gas_columns(tables, p, t, gas)
    min_od = 1e-15 if band_set == "lw" else 0.0
    got = _cpu_launch(cpu_kernels, band_set, tables, cols, t, skin, min_od)
    want = (cuda_rrtmg.lw_taumol_plain(tables, cols, t, skin, min_od)
            if band_set == "lw"
            else cuda_rrtmg.sw_taumol_plain(tables, cols, min_od))
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    for name, a, b in zip(("od", "second", "third"), got, want):
        assert bool(torch.isfinite(a).all()), name
        err = (a.double() - b.double()).abs()
        b = b.double().abs()
        assert bool((err <= rtol * (b + b.max())).all()), (
            name, float((err / (b + 1e-300)).max()))
