"""A run with the timed path broken underneath comes out not correct: it
skips the look for a card and drives the rest of a run on the CPU at a
small size, with ``program.call`` replaced by a broken one: a call that
hands back the previous call's fluxes (its state unchanged), one that
computes half the columns and repeats them over the rest, one that
alters one column's answer where it is produced, where the cell
saves flux profiles per band, one that alters one band of one column's
per-band profile, and, where the cell runs SPARTACUS, one whose solvers
leave out the 3D effects (``do_3d_effects`` off, the 1D Tripleclouds-like
solution).  The sound run comes out correct.  (One card, no exchange
between cards to leave out.)"""

import time

import pytest
import torch

from benchmark import program, run
from bench_small import SMALL


def _cell(name):
    cell = run.load_cell(name)
    cell.traffic.update(SMALL)
    return cell


def _stale(call):
    last = []

    def broken(prog, inputs, block, solar):
        flux = call(prog, inputs, block, solar)
        out = last[0] if last else flux
        last[:] = [flux]
        return out
    return broken


def _half(call):
    def broken(prog, inputs, block, solar):
        ncol = inputs["pressure_hl"].shape[0]
        half = torch.arange(ncol) % (ncol // 2)
        part = {k: v[half] if torch.is_tensor(v) else
                {kk: vv[half] for kk, vv in v.items()}
                for k, v in inputs.items()}
        flux = call(prog, {k: (v[: ncol // 2] if torch.is_tensor(v) else
                               {kk: vv[: ncol // 2] for kk, vv in v.items()})
                           for k, v in part.items()}, block, solar)
        return type(flux)(**{k: v[half] for k, v in flux.fields().items()})
    return broken


def _altered(call):
    def broken(prog, inputs, block, solar):
        flux = call(prog, inputs, block, solar)
        fields = dict(flux.fields())
        lw_up = fields["lw_up"].clone()
        lw_up[3, 40] += 1.0              # one column, one level, 1 W m-2
        fields["lw_up"] = lw_up
        return type(flux)(**fields)
    return broken


def _band_altered(call):
    def broken(prog, inputs, block, solar):
        flux = call(prog, inputs, block, solar)
        fields = dict(flux.fields())
        band = fields["sw_dn_direct_band"].clone()
        band[3, 40, 9] += 1.0        # one column, level and band, 1 W m-2
        fields["sw_dn_direct_band"] = band
        return type(flux)(**fields)
    return broken


def _no_3d(call):
    def broken(prog, inputs, block, solar):
        flat = prog._replace(config=prog.config.replace(do_3d_effects=False))
        return call(flat, inputs, block, solar)
    return broken


FAULTS = {"sound": None, "stale": _stale, "half": _half,
          "altered": _altered}
CASES = [(name, fault) for name in ("mcica_rrtmg.rank2k",
                                    "ecckd_mcica.slab16k",
                                    "mcica_rrtmg_spectral.slab16k",
                                    "spartacus_ecckd.slab16k")
         for fault in FAULTS]
CASES.append(("mcica_rrtmg_spectral.slab16k", "band_altered"))
CASES.append(("spartacus_ecckd.slab16k", "no_3d"))
FAULTS["band_altered"] = _band_altered
FAULTS["no_3d"] = _no_3d


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f}" for n, f in CASES])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault = FAULTS[fault]
    if fault is not None:
        monkeypatch.setattr(program, "call", fault(program.call))
    out = run.run_cell(_cell(name), 2**31 + 17, 0.5, False, "cpu",
                       time.time())
    assert out["correct"] is (fault is None), out["checked"]
    assert out["attempted"] >= SMALL["check_calls"]
    assert list(out)[-1] == "checked"


def test_traced_run_reports_per_layer_metrics():
    cell = _cell("ecckd_mcica.rank2k")
    out = run.run_cell(cell, 2**31 + 23, 0.5, True, "cpu", time.time())
    assert out["correct"] is True
    assert set(out["metrics"]) <= set(cell.per_layer)
    assert out["metrics"]["generator_host_ms_per_kcol"]["value"] > 0
    assert out["attempted"] == SMALL["trace_calls"]
    assert out["device"]["window_s"] > 0
    assert "breakdown" in out


def test_traced_spartacus_run_reads_its_solvers():
    """A SPARTACUS cell's traced run reads the solvers' layer through the
    wraps of its route, and no metric of the McICA generator."""
    cell = _cell("spartacus_ecckd.slab16k")
    out = run.run_cell(cell, 2**31 + 29, 0.5, True, "cpu", time.time())
    assert out["correct"] is True
    assert not any(k.startswith(("generator", "cumulator", "sampler"))
                   for k in cell.per_layer)
    for k in ("solvers_dev_ms_per_kcol", "solvers_host_ms_per_kcol",
              "host_wait_ms_per_kcol"):
        assert k in out["metrics"], k
    assert out["metrics"]["solvers_host_ms_per_kcol"]["value"] > 0
