"""Draw an ecRad-style input file (the reference's practical/plot_input.py
and plot_input_profile.py; the JAX package's tools/plot_input.py): cloud,
thermodynamic and gas fields as column x pressure cross-sections, or as
profiles of one column, on ecrad_torch.io.input.read_input (needs
matplotlib):

  python -m ecrad_torch.evaluate.plot_input input.nc --out input_report.png
  python -m ecrad_torch.evaluate.plot_input input.nc --column 42 \
      --out col42.png
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ecrad_torch.evaluate import column_coordinate, pyplot
from ecrad_torch.io.input import DriverConfig, read_input


def input_fields(path):
    """What the figure shows, without drawing: (inp, full-level pressure
    in hPa (ncol, nlev), column coordinate and its label, [(title,
    (ncol, nlev) field, colour map)])."""
    inp = read_input(path, DriverConfig())
    phl = np.asarray(inp.thermodynamics.pressure_hl) / 100.0   # hPa
    p_fl = 0.5 * (phl[:, :-1] + phl[:, 1:])
    x, xlabel = column_coordinate(path, inp.ncol)
    thl = np.asarray(inp.thermodynamics.temperature_hl)
    fields = [
        ("cloud fraction", inp.cloud_fraction, "Blues"),
        ("q_liquid [g/kg]", 1e3 * inp.cloud_mixing_ratio[..., 0], "viridis"),
        ("q_ice [g/kg]", 1e3 * inp.cloud_mixing_ratio[..., 1], "viridis"),
        ("temperature [K]", 0.5 * (thl[:, :-1] + thl[:, 1:]), "RdYlBu_r"),
        ("specific humidity [g/kg]", 1e3 * inp.gas_mmr[:, :, 0], "viridis"),
        ("ozone [mg/kg]", 1e6 * inp.gas_mmr[:, :, 2], "viridis"),
    ]
    return inp, p_fl, (x, xlabel), fields


def plot_input(path, out, column=None):
    """Draw the input file at path into out (cross-sections, or the
    profiles of one column); returns out."""
    plt = pyplot()
    inp, p_fl, (x, xlabel), fields = input_fields(path)
    if column is not None:
        fig, axes = plt.subplots(1, len(fields),
                                 figsize=(3 * len(fields), 5), sharey=True)
        for ax, (title, v, _) in zip(axes, fields):
            ax.plot(v[column], p_fl[column], "C0-")
            ax.set_title(title, fontsize=9)
            ax.grid(alpha=0.3)
            if not ax.yaxis_inverted():
                ax.invert_yaxis()
        axes[0].set_ylabel("pressure [hPa]")
        fig.suptitle(f"{os.path.basename(path)} — column {column}")
    else:
        fig, axes = plt.subplots(3, 2, figsize=(13, 11), sharex=True)
        for ax, (title, v, cmap) in zip(axes.ravel(), fields):
            pm = ax.pcolormesh(x, p_fl.mean(0), v.T, cmap=cmap,
                               shading="auto")
            fig.colorbar(pm, ax=ax, pad=0.01)
            ax.set_title(title, fontsize=10, loc="left")
            if not ax.yaxis_inverted():
                ax.invert_yaxis()
            ax.set_ylabel("pressure [hPa]")
        for ax in axes[-1]:
            ax.set_xlabel(xlabel)
        fig.suptitle(
            f"{os.path.basename(path)} — ncol={inp.ncol} "
            f"nlev={inp.nlev}  cos_sza [{inp.cos_sza.min():.2f}, "
            f"{inp.cos_sza.max():.2f}]  solar {inp.solar_irradiance:.0f}"
            " W m-2")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Draw an ecRad-style input file.")
    ap.add_argument("input")
    ap.add_argument("--out", default=None,
                    help="the figure (default: <input name>_input.png)")
    ap.add_argument("--column", type=int, default=None,
                    help="profiles of one column instead of sections")
    args = ap.parse_args(argv)
    out = args.out or (os.path.splitext(
        os.path.basename(args.input))[0] + "_input.png")
    print("wrote", plot_input(args.input, out, args.column))
    return 0


if __name__ == "__main__":
    sys.exit(main())
