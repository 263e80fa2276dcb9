"""Compare two ecRad-style output files (the reference's
practical/compare_output.py, compare_output_profile.py and
compare_output_scalar.py; the JAX package's tools/compare_output.py), on
ecrad_torch.io.netcdf:

  # tabulated per-variable difference statistics
  python -m ecrad_torch.evaluate.compare_output out.nc reference.nc

  # with heating-rate differences (the input file gives the pressure)
  python -m ecrad_torch.evaluate.compare_output out.nc reference.nc \
      --input in.nc

  # flux / heating-rate profile and scalar figures (needs matplotlib)
  python -m ecrad_torch.evaluate.compare_output out.nc reference.nc \
      --input in.nc --plot diff_report [--column N]

  # threshold mode: exit 1 if any LW / SW flux differs beyond its bound
  # (ecRad's validation thresholds, test/ifs/CMakeLists.txt:15-21)
  python -m ecrad_torch.evaluate.compare_output out.nc reference.nc \
      --threshold-lw 0.001 --threshold-sw 0.1
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ecrad_torch.evaluate import column_coordinate, pyplot
from ecrad_torch.io.netcdf import NcFile

# heating rates in K/day from the net-flux divergence
# (radiation_constants.F90, the ecradplot convention)
ACCEL_GRAVITY = 9.80665
CP_DRY = 1004.0
SECONDS_PER_DAY = 86400.0

LW_VARS = ("flux_up_lw", "flux_dn_lw", "flux_up_lw_clear",
           "flux_dn_lw_clear", "flux_net_lw", "flux_net_lw_clear",
           "lw_derivative")
SW_VARS = ("flux_up_sw", "flux_dn_sw", "flux_dn_direct_sw",
           "flux_up_sw_clear", "flux_dn_sw_clear",
           "flux_dn_direct_sw_clear", "flux_net_sw",
           "flux_net_sw_clear")


def heating_rate(flux_dn, flux_up, pressure_hl):
    """K/day from the net-flux divergence, -(g / cp) dF_net/dp * 86400,
    net flux positive downward (the ecradplot convention)."""
    net = flux_dn - flux_up
    dp = pressure_hl[:, 1:] - pressure_hl[:, :-1]
    return (SECONDS_PER_DAY * ACCEL_GRAVITY / CP_DRY
            * np.diff(net, axis=1) / dp)


def _read_all(path):
    """Every variable of a file, numbers as float64."""
    with NcFile(path) as f:
        return {name: f.get(name, np.float64) for name in f.variables()}


def _pressure_top_first(input_path):
    """pressure_hl of an input file, its levels from the top down."""
    with NcFile(input_path) as f:
        phl = f.get("pressure_hl", np.float64)
    return phl[:, ::-1] if phl[0, 0] > phl[0, -1] else phl


def _stats(a, b):
    d = a - b
    ad = np.abs(d)
    i = np.unravel_index(np.argmax(ad), ad.shape)
    return dict(max_abs=float(ad.max()),
                mean_abs=float(ad.mean()),
                rms=float(np.sqrt(np.mean(d * d))),
                worst_index=tuple(int(x) for x in i),
                ref_at_worst=float(b[i]))


def compare(path_a, path_b, input_path=None):
    """(rows, only in b, only in a): difference statistics by variable
    for the numeric variables of the same shape in both files, and the
    heating rates' when the input file (its pressure_hl) is given."""
    A, B = _read_all(path_a), _read_all(path_b)
    rows = {}
    for name in sorted(set(A) & set(B)):
        a, b = A[name], B[name]
        if a.shape != b.shape or not np.issubdtype(a.dtype, np.number):
            continue
        rows[name] = _stats(a, b)
    missing_a = sorted(set(B) - set(A))
    missing_b = sorted(set(A) - set(B))

    if input_path is not None:
        phl = _pressure_top_first(input_path)
        for band in ("lw", "sw"):
            up, dn = f"flux_up_{band}", f"flux_dn_{band}"
            if up in A and up in B and dn in A and dn in B \
                    and A[up].shape[1] == phl.shape[1]:
                rows[f"heating_rate_{band} [K/day]"] = _stats(
                    heating_rate(A[dn], A[up], phl),
                    heating_rate(B[dn], B[up], phl))
    return rows, missing_a, missing_b


def print_report(rows, missing_a, missing_b, name_a, name_b, file=None):
    file = file or sys.stdout
    w = max([len(k) for k in rows] + [12])
    print(f"Comparison: {name_a}  vs  {name_b}", file=file)
    print(f"{'variable':<{w}}  {'max|diff|':>12} {'mean|diff|':>12} "
          f"{'rms':>12}  worst @ index (ref value)", file=file)
    for name, s in rows.items():
        print(f"{name:<{w}}  {s['max_abs']:>12.6g} "
              f"{s['mean_abs']:>12.6g} {s['rms']:>12.6g}  "
              f"{s['worst_index']} ({s['ref_at_worst']:.6g})",
              file=file)
    if missing_a:
        print(f"only in {name_b}: {', '.join(missing_a)}", file=file)
    if missing_b:
        print(f"only in {name_a}: {', '.join(missing_b)}", file=file)


def check_thresholds(rows, threshold_lw, threshold_sw):
    """ecRad's pass/fail: {variable: (max abs difference, bound)} for
    each LW or SW flux beyond its bound (test/ifs/CMakeLists.txt:15-21);
    heating rates are not held to a bound."""
    bad = {}
    for name, s in rows.items():
        thr = None
        if threshold_lw is not None and name in LW_VARS:
            thr = threshold_lw
        if threshold_sw is not None and name in SW_VARS:
            thr = threshold_sw
        if thr is not None and s["max_abs"] > thr:
            bad[name] = (s["max_abs"], thr)
    return bad


# --- figures (matplotlib) ---------------------------------------------


def plot_profiles(path_a, path_b, input_path, prefix, label_a=None,
                  label_b=None, column=None):
    """All-column mean (or one column's) flux and heating-rate profiles
    with difference panels (compare_output_profile.py); returns the file
    written, PREFIX_profile.png."""
    plt = pyplot()
    A, B = _read_all(path_a), _read_all(path_b)
    phl = _pressure_top_first(input_path)
    label_a = label_a or os.path.basename(path_a)
    label_b = label_b or os.path.basename(path_b)

    sel = (lambda x: x[column:column + 1]) if column is not None \
        else (lambda x: x)
    p_hl = np.mean(sel(phl), axis=0) / 100.0          # hPa
    p_fl = 0.5 * (p_hl[:-1] + p_hl[1:])

    fig, axes = plt.subplots(2, 4, figsize=(16, 9), sharey=True)
    panels = [("flux_dn_lw", "LW down [W m-2]"),
              ("flux_up_lw", "LW up [W m-2]"),
              ("flux_dn_sw", "SW down [W m-2]"),
              ("flux_up_sw", "SW up [W m-2]")]
    for ax, (var, title) in zip(axes[0], panels):
        if var not in A or var not in B:
            ax.set_visible(False)
            continue
        ax.plot(np.mean(sel(B[var]), 0), p_hl, "k-", lw=2, label=label_b)
        ax.plot(np.mean(sel(A[var]), 0), p_hl, "C3--", lw=2, label=label_a)
        ax.set_title(title)
        ax.grid(alpha=0.3)
    axes[0, 0].set_ylabel("pressure [hPa]")
    axes[0, 0].legend(fontsize=8)

    # difference panels and heating rates
    for ax, (var, title) in zip(axes[1][:2], panels[:2]):
        if var in A and var in B:
            ax.plot(np.mean(sel(A[var]) - sel(B[var]), 0), p_hl, "C0-")
            ax.set_title(f"Δ {title}")
            ax.grid(alpha=0.3)
    for ax, band in zip(axes[1][2:], ("lw", "sw")):
        up, dn = f"flux_up_{band}", f"flux_dn_{band}"
        if up in A and dn in A and up in B and dn in B:
            hr_a = np.mean(sel(heating_rate(A[dn], A[up], phl)), 0)
            hr_b = np.mean(sel(heating_rate(B[dn], B[up], phl)), 0)
            ax.plot(hr_b, p_fl, "k-", lw=2, label=label_b)
            ax.plot(hr_a, p_fl, "C3--", lw=2, label=label_a)
            ax.set_title(f"{band.upper()} heating rate [K/day]")
            ax.grid(alpha=0.3)
    axes[1, 0].set_ylabel("pressure [hPa]")
    for ax in axes.ravel():
        if not ax.yaxis_inverted():
            ax.invert_yaxis()
    fig.suptitle(f"{label_a} vs {label_b}"
                 + (f" (column {column})" if column is not None
                    else " (all-column mean)"))
    fig.tight_layout()
    out = f"{prefix}_profile.png"
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out


def plot_scalars(path_a, path_b, input_path, prefix, label_a=None,
                 label_b=None):
    """TOA and surface fluxes and the cloud radiative effect along the
    columns (compare_output_scalar.py); returns the file written,
    PREFIX_scalar.png."""
    plt = pyplot()
    A, B = _read_all(path_a), _read_all(path_b)
    label_a = label_a or os.path.basename(path_a)
    label_b = label_b or os.path.basename(path_b)
    x, xlabel = column_coordinate(input_path,
                                  next(iter(A.values())).shape[0])

    def toa(v):
        return v[:, 0]

    def surf(v):
        return v[:, -1]

    rowspecs = []
    if "flux_up_lw" in A:
        rowspecs += [("OLR (TOA LW up)", lambda D: toa(D["flux_up_lw"])),
                     ("Surface LW down", lambda D: surf(D["flux_dn_lw"]))]
        if "flux_up_lw_clear" in A:
            rowspecs.append(("LW CRE (TOA)",
                             lambda D: toa(D["flux_up_lw_clear"])
                             - toa(D["flux_up_lw"])))
    if "flux_up_sw" in A:
        rowspecs += [("TOA SW up", lambda D: toa(D["flux_up_sw"])),
                     ("Surface SW down", lambda D: surf(D["flux_dn_sw"]))]
        if "flux_up_sw_clear" in A:
            rowspecs.append(("SW CRE (TOA)",
                             lambda D: toa(D["flux_up_sw_clear"])
                             - toa(D["flux_up_sw"])))

    n = len(rowspecs)
    fig, axes = plt.subplots(n, 2, figsize=(13, 2.3 * n), sharex=True,
                             squeeze=False)
    for (title, fn), (axv, axd) in zip(rowspecs, axes):
        va, vb = fn(A), fn(B)
        axv.plot(x, vb, "k-", lw=1.5, label=label_b)
        axv.plot(x, va, "C3--", lw=1.5, label=label_a)
        axv.set_title(title + " [W m-2]", fontsize=9, loc="left")
        axv.grid(alpha=0.3)
        axd.plot(x, va - vb, "C0-", lw=1.0)
        axd.set_title(f"Δ {title}", fontsize=9, loc="left")
        axd.grid(alpha=0.3)
    axes[0, 0].legend(fontsize=8)
    for ax in axes[-1]:
        ax.set_xlabel(xlabel)
    fig.suptitle(f"{label_a} vs {label_b}")
    fig.tight_layout()
    out = f"{prefix}_scalar.png"
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Compare two ecRad-style output files.")
    ap.add_argument("output", help="output file to evaluate")
    ap.add_argument("reference", help="reference output file")
    ap.add_argument("--input", default=None,
                    help="matching input file (pressure grid for heating "
                    "rates and figures)")
    ap.add_argument("--plot", metavar="PREFIX", default=None,
                    help="write PREFIX_profile.png (needs --input) and "
                    "PREFIX_scalar.png; needs matplotlib")
    ap.add_argument("--column", type=int, default=None,
                    help="plot one column instead of the mean")
    ap.add_argument("--threshold-lw", type=float, default=None)
    ap.add_argument("--threshold-sw", type=float, default=None)
    args = ap.parse_args(argv)

    rows, miss_a, miss_b = compare(args.output, args.reference, args.input)
    print_report(rows, miss_a, miss_b, os.path.basename(args.output),
                 os.path.basename(args.reference))

    if args.plot:
        if args.input:
            print("wrote", plot_profiles(args.output, args.reference,
                                         args.input, args.plot,
                                         column=args.column))
        print("wrote", plot_scalars(args.output, args.reference, args.input,
                                    args.plot))

    bad = check_thresholds(rows, args.threshold_lw, args.threshold_sw)
    for name, (got, thr) in bad.items():
        print(f"FAIL {name}: max|diff| {got:.6g} > {thr:g}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
