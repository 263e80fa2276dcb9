"""The port's evaluation layer (ecrad_torch.evaluate.compare_output and
plot_input) against the JAX package's tools (tools/compare_output.py,
tools/plot_input.py) on the same files: output files the port's offline
driver writes on a 4-column cut of the meridian file (McICA in float64 and
float32, Tripleclouds, McICA with net fluxes), the cut as input.

* The rows' statistics within 1e-12 relative, the same missing-field
  lists and heating rates, the same report text and the same threshold
  exit codes, passing and failing.
* The figures' data path without drawing: every array and title handed
  to a stand-in for matplotlib equal; real figures where matplotlib is
  installed, and a clear error where it is not.
* The tools run where jax, flax and ecrad_tpu cannot be imported, and as
  ``python -m``.
"""

import importlib.util
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from ecrad_torch import driver
from ecrad_torch.evaluate import compare_output, plot_input
from tests.torch_files import write_meridian_cut, write_namelist

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the statistics of the same numbers computed the same way
RTOL = 1e-12


def _tool(name):
    """A script of tools/ as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        f"tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL_CO, TOOL_PI = _tool("compare_output"), _tool("plot_input")

# output file -> (configuration, dtype, &radiation_driver entries)
OUTPUTS = {"mcica_f64": ("mcica_rrtmg", "float64", {}),
           "mcica_f32": ("mcica_rrtmg", "float32", {}),
           "tripleclouds_f64": ("tripleclouds_rrtmg", "float64", {}),
           "net_fluxes": ("mcica_rrtmg", "float64",
                          dict(do_save_net_fluxes=True))}
# (output, reference, input file or None)
PAIRS = [("mcica_f32", "mcica_f64", None),
         ("tripleclouds_f64", "mcica_f64", "cut"),
         ("net_fluxes", "mcica_f64", "cut"),
         ("mcica_f64", "net_fluxes", "flipped"),
         ("mcica_f64", "mcica_f64", "cut")]
# (output, reference, LW bound, SW bound, exit code): ecRad's
# double-precision thresholds (0.001 / 0.1 W m-2), its single-precision bar
# (0.5), one bound only; the net-flux file shares with the plain one only
# fields of equal values
THRESHOLDS = [("mcica_f32", "mcica_f64", 0.5, 0.5, 0),
              ("tripleclouds_f64", "mcica_f64", 0.001, 0.1, 1),
              ("mcica_f64", "mcica_f64", 0.001, 0.1, 0),
              ("mcica_f32", "mcica_f64", 1e-9, None, 1),
              ("mcica_f32", "mcica_f64", None, 1e-9, 1),
              ("net_fluxes", "mcica_f64", 1e-9, 1e-9, 0)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: path} of the cut inputs and of the OUTPUTS."""
    d = tmp_path_factory.mktemp("evaluate")
    paths = write_meridian_cut(d)
    for name, (config_name, dtype, extra) in OUTPUTS.items():
        nam = write_namelist(str(d / f"{name}.nam"), config_name, **extra)
        paths[name] = str(d / f"{name}.nc")
        driver.main([nam, paths["cut"], paths[name], "--dtype", dtype,
                     "--device", "cpu"])
    return paths


def _args(files, a, b, inp):
    return (files[a], files[b], None if inp is None else files[inp])


def _same_rows(got, ref):
    assert list(got) == list(ref)
    for name, s in ref.items():
        g = got[name]
        assert set(g) == set(s), name
        assert g["worst_index"] == s["worst_index"], name
        for k in ("max_abs", "mean_abs", "rms", "ref_at_worst"):
            np.testing.assert_allclose(g[k], s[k], rtol=RTOL, atol=0,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("a,b,inp", PAIRS,
                         ids=[f"{a}-{b}-{i}" for a, b, i in PAIRS])
def test_compare_matches_tool(files, a, b, inp):
    got = compare_output.compare(*_args(files, a, b, inp))
    ref = TOOL_CO.compare(*_args(files, a, b, inp))
    _same_rows(got[0], ref[0])
    assert got[1:] == ref[1:]                 # the missing-field lists
    # the net-flux file holds net fluxes in place of up and down ones, so
    # no heating rates
    assert any(n.startswith("heating_rate") for n in got[0]) \
        == (inp is not None and "net_fluxes" not in (a, b))
    if "net_fluxes" in (a, b):
        assert got[1] and got[2]
    if a == b:
        assert all(s["max_abs"] == 0.0 for s in got[0].values())


@pytest.mark.parametrize("a,b,lw,sw,code", THRESHOLDS,
                         ids=[f"{a}-{b}-{lw}-{sw}" for a, b, lw, sw, _
                              in THRESHOLDS])
def test_report_and_exit_code_match_tool(files, capsys, a, b, lw, sw,
                                         code):
    argv = [files[a], files[b], "--input", files["cut"]]
    argv += ["--threshold-lw", str(lw)] if lw is not None else []
    argv += ["--threshold-sw", str(sw)] if sw is not None else []
    rc = compare_output.main(argv)
    got = capsys.readouterr().out
    ref_rc = TOOL_CO.main(argv)
    assert got == capsys.readouterr().out
    assert rc == ref_rc == code
    assert rc == int("FAIL" in got)
    assert ("heating_rate_lw [K/day]" in got) == ("net_fluxes" not in a)


def test_heating_rate_matches_tool(files):
    rng = np.random.default_rng(5)
    phl = np.sort(rng.uniform(1.0, 1.0e5, (3, 11)), axis=1)
    dn, up = rng.uniform(0.0, 400.0, (2, 3, 11))
    np.testing.assert_allclose(compare_output.heating_rate(dn, up, phl),
                               TOOL_CO.heating_rate(dn, up, phl),
                               rtol=RTOL, atol=0)


# --- figures ---------------------------------------------------------------

class _Recorder:
    """Stands in for matplotlib's pyplot, figures and axes: logs every
    call with its arguments and returns another recorder (subplots: a
    figure and an array of axes; yaxis_inverted: False)."""

    def __init__(self, log):
        self._log = log

    def __getattr__(self, attr):
        def call(*args, **kwargs):
            self._log.append((attr, args, kwargs))
            if attr == "yaxis_inverted":
                return False
            if attr == "subplots":
                axes = np.empty(args[:2], object)
                for i in np.ndindex(axes.shape):
                    axes[i] = _Recorder(self._log)
                return _Recorder(self._log), (
                    axes.squeeze() if kwargs.get("squeeze", True) else axes)
            return _Recorder(self._log)
        return call


# the calls that carry what a figure shows
DRAWN = ("plot", "pcolormesh", "set_title", "suptitle", "set_xlabel",
         "set_ylabel", "savefig")


def _drawn(monkeypatch, fn, *args, **kwargs):
    """The DRAWN calls that fn makes of a stand-in matplotlib."""
    log = []
    fake = types.ModuleType("matplotlib")
    fake.use = lambda backend: None
    fake.pyplot = _Recorder(log)
    monkeypatch.setitem(sys.modules, "matplotlib", fake)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", fake.pyplot)
    fn(*args, **kwargs)
    return [c for c in log if c[0] in DRAWN]


def _same_drawing(got, ref):
    assert [c[0] for c in got] == [c[0] for c in ref]
    assert len(got) > 6
    for (name, args, kw), (_, rargs, rkw) in zip(got, ref):
        assert len(args) == len(rargs) and sorted(kw) == sorted(rkw), name
        for x, y in zip((*args, *(kw[k] for k in sorted(kw))),
                        (*rargs, *(rkw[k] for k in sorted(rkw)))):
            if isinstance(y, str):
                assert x == y, name
            else:
                np.testing.assert_allclose(np.asarray(x, np.float64),
                                           np.asarray(y, np.float64),
                                           rtol=RTOL, atol=0, err_msg=name)


@pytest.mark.parametrize("column", [None, 2], ids=["sections", "column"])
def test_plot_input_data_path_matches_tool(files, monkeypatch, tmp_path,
                                           column):
    out = str(tmp_path / "inp.png")
    got = _drawn(monkeypatch, plot_input.plot_input, files["cut"], out,
                 column)
    ref = _drawn(monkeypatch, TOOL_PI.plot_input, files["cut"], out, column)
    _same_drawing(got, ref)
    assert ("pcolormesh" in [c[0] for c in got]) == (column is None)


@pytest.mark.parametrize("fn,column", [("plot_profiles", None),
                                       ("plot_profiles", 1),
                                       ("plot_scalars", None)])
def test_compare_figures_data_path_matches_tool(files, monkeypatch,
                                                tmp_path, fn, column):
    args = (files["tripleclouds_f64"], files["mcica_f64"], files["cut"],
            str(tmp_path / "rep"))
    kw = {} if fn == "plot_scalars" else dict(column=column)
    got = _drawn(monkeypatch, getattr(compare_output, fn), *args, **kw)
    ref = _drawn(monkeypatch, getattr(TOOL_CO, fn), *args, **kw)
    _same_drawing(got, ref)


def test_figures_written(files, tmp_path):
    pytest.importorskip("matplotlib")
    prefix = str(tmp_path / "rep")
    assert compare_output.main([files["tripleclouds_f64"],
                                files["mcica_f64"], "--input", files["cut"],
                                "--plot", prefix]) == 0
    out = str(tmp_path / "inp.png")
    assert plot_input.main([files["cut"], "--out", out]) == 0
    for f in (prefix + "_profile.png", prefix + "_scalar.png", out):
        assert os.path.getsize(f) > 10000, f


def test_figure_without_matplotlib_raises(files, monkeypatch, tmp_path):
    """A figure asked for without matplotlib raises a clear error; the
    tabulated report is printed first."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        compare_output.main([files["mcica_f32"], files["mcica_f64"],
                             "--plot", str(tmp_path / "rep")])
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        plot_input.main([files["cut"], "--out", str(tmp_path / "i.png")])
    assert compare_output.main([files["mcica_f32"], files["mcica_f64"],
                                "--threshold-lw", "0.5"]) == 0


_PROBE = r"""
import sys
for name in ("jax", "jaxlib", "flax", "ecrad_tpu"):
    sys.modules[name] = None               # import raises ImportError
sys.path.insert(0, {repo!r})
from ecrad_torch.evaluate import compare_output, plot_input
rc = compare_output.main([{a!r}, {b!r}, "--input", {inp!r},
                          "--threshold-lw", "0.5", "--threshold-sw", "0.5"])
print("RC", rc)
print("NCOL", plot_input.input_fields({inp!r})[0].ncol)
"""


def test_runs_without_jax(files):
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(
            repo=REPO, a=files["mcica_f32"], b=files["mcica_f64"],
            inp=files["cut"])],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "RC 0" in out.stdout and "NCOL 4" in out.stdout
    assert "heating_rate_sw [K/day]" in out.stdout


def test_command_line(files, tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "ecrad_torch.evaluate.compare_output",
         files["mcica_f32"], files["mcica_f64"], "--threshold-lw", "1e-9"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 1, r.stderr[-800:]
    assert "FAIL flux_up_lw" in r.stdout or "FAIL flux_dn_lw" in r.stdout
