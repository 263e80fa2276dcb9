"""Write the JAX references that the PyTorch port is held to on the GPU.

For each configuration, runs the JAX step (``__graft_entry__._build(
ncol=32)`` -> ``pipeline.radiation_step``) on the CPU twice, each in its
own process:

* float64 with ``jax_enable_x64`` on;
* float32 with ``jax_enable_x64`` off (under x64 the float64 tables would
  promote the float32 inputs, so this is the genuine single-precision
  path), also keeping the float32 stochastic cloud sample
  (``od_scaling_sw/lw``, ``total_cloud_cover_sw/lw``) where the
  configuration draws one.

and writes, compressed, ``f64/<field>`` and ``f32/<field>`` for every Flux
field, the f32 sample under ``f32_sample/<key>``, and ``commit``, the git
commit of the tree:

* the flagship (McICA) to ``tests/data/torch_flagship_meridian32.npz``;
* ``tripleclouds_rrtmg`` (the flagship with Tripleclouds SW and LW
  solvers, ``tools/bench_matrix.py`` CONFIGS) to
  ``tests/data/torch_tripleclouds_meridian32.npz``;
* ``cloudless_rrtmg`` (Cloudless SW and LW) to
  ``tests/data/torch_cloudless_meridian32.npz``;
* ``homogeneous_rrtmg`` (Homogeneous SW and LW, LW aerosol scattering on)
  to ``tests/data/torch_homogeneous_meridian32.npz``;
* ``spartacus_3d`` (SPARTACUS SW and LW with 3D effects and no SW delta
  scaling with gases, ``tools/bench_matrix.py`` CONFIGS) to
  ``tests/data/torch_spartacus_meridian32.npz``;
* ``tripleclouds_ecckd`` (Tripleclouds SW and LW on ecCKD gas optics with
  general cloud optics, no aerosols, ``tools/bench_matrix.py`` CONFIGS) to
  ``tests/data/torch_tripleclouds_ecckd_meridian32.npz``;
* ``ecckd_mcica`` (the same on McICA, with its float32 sample) to
  ``tests/data/torch_ecckd_mcica_meridian32.npz``;
* ``spartacus_ecckd`` (``spartacus_3d``'s solvers on the ecCKD optics of
  ``tripleclouds_ecckd``) to
  ``tests/data/torch_spartacus_ecckd_meridian32.npz``;
* ``tripleclouds_baran2016`` (Tripleclouds SW and LW with Slingo liquid and
  Baran2016 ice, the flagship's aerosols) to
  ``tests/data/torch_tripleclouds_baran2016_meridian32.npz``;
* ``mcica_rrtmg_spectral`` (the flagship with flux profiles and TOA fluxes
  per band, with its float32 sample) to
  ``tests/data/torch_mcica_spectral_meridian32.npz``;
* ``tripleclouds_ecckd_gpoint`` (``tripleclouds_ecckd`` with flux profiles
  per g-point) to
  ``tests/data/torch_tripleclouds_ecckd_gpoint_meridian32.npz``;
* ``cloudless_rrtmg_spectral`` and ``homogeneous_rrtmg_spectral``
  (``cloudless_rrtmg`` and ``homogeneous_rrtmg`` with flux profiles and TOA
  fluxes per band) to ``tests/data/torch_cloudless_spectral_meridian32.npz``
  and ``tests/data/torch_homogeneous_spectral_meridian32.npz``;
* ``monochromatic_homogeneous`` (monochromatic optics, Homogeneous SW and
  LW, no aerosols) to ``tests/data/torch_monochromatic_meridian32.npz``.

The spectral flux profiles ``(32, nlev+1, nspec)`` are kept for the
columns ``PROFILE_COLUMNS`` only (stored as ``profile_columns``), so that
each file stays small; every other field is kept for all 32 columns.

The two command-line entry points have references of their own, each
run on the 32 meridian columns with the namelist that
``ecrad_torch.flagship.namelist_text`` writes for the configuration
(double-precision output, the flagship's cloud separation scales):

* ``driver``: the offline driver (``ecrad_tpu.driver.run``, host
  generator) of ``mcica_rrtmg`` and ``tripleclouds_rrtmg``, float64 and
  float32, every variable of its output file as
  ``<configuration>/<f64|f32>/<variable>``, to
  ``tests/data/torch_driver_meridian32.npz``;
* ``ifs``: the IFS driver (``ecrad_tpu.ifs.driver.run_ifs``) of
  ``mcica_rrtmg`` in float64, with ``--bitidentity`` and without (the
  device generator), every output but ``_flux`` as
  ``<bitidentity|device>/<output>``, to
  ``tests/data/torch_ifs_meridian32.npz``.

``tools/bench_matrix.py`` names only the McICA, Tripleclouds and
SPARTACUS solvers, so the solvers are given here by the name of the JAX
package's ``Solver`` member, and so are the cloud optics models (its
``LiquidModel`` and ``IceModel``).

    python tools/make_torch_reference.py [configuration|driver|ifs ...]

writes every file, or only those named.
"""

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
# the ecCKD configurations' overrides (tools/bench_matrix.py CONFIGS)
ECCKD = dict(gas_model_sw_name="ECCKD", gas_model_lw_name="ECCKD",
             use_general_cloud_optics=True,
             do_nearest_spectral_lw_emiss=False, use_aerosols=False,
             n_aerosol_types=0, i_aerosol_type_map=())
# the SPARTACUS configurations' solvers (tools/bench_matrix.py CONFIGS)
SPARTACUS = dict(sw_solver_name="SPARTACUS", lw_solver_name="SPARTACUS",
                 do_3d_effects=True, do_sw_delta_scaling_with_gases=False)
# configuration -> (nam_overrides, output file)
OUTPUTS = {
    "mcica_rrtmg": ({}, "torch_flagship_meridian32.npz"),
    "tripleclouds_rrtmg": (dict(sw_solver_name="Tripleclouds",
                                lw_solver_name="Tripleclouds"),
                           "torch_tripleclouds_meridian32.npz"),
    "cloudless_rrtmg": (dict(sw_solver="CLOUDLESS", lw_solver="CLOUDLESS"),
                        "torch_cloudless_meridian32.npz"),
    "homogeneous_rrtmg": (dict(sw_solver="HOMOGENEOUS",
                               lw_solver="HOMOGENEOUS",
                               do_lw_aerosol_scattering=True),
                          "torch_homogeneous_meridian32.npz"),
    "spartacus_3d": (SPARTACUS, "torch_spartacus_meridian32.npz"),
    "tripleclouds_ecckd": (dict(sw_solver_name="Tripleclouds",
                                lw_solver_name="Tripleclouds", **ECCKD),
                           "torch_tripleclouds_ecckd_meridian32.npz"),
    "ecckd_mcica": (ECCKD, "torch_ecckd_mcica_meridian32.npz"),
    "spartacus_ecckd": (dict(**SPARTACUS, **ECCKD),
                        "torch_spartacus_ecckd_meridian32.npz"),
    "tripleclouds_baran2016": (dict(sw_solver_name="Tripleclouds",
                                    lw_solver_name="Tripleclouds",
                                    liquid_model="SLINGO",
                                    ice_model="BARAN2016"),
                               "torch_tripleclouds_baran2016_meridian32.npz"),
    "mcica_rrtmg_spectral": (dict(do_save_spectral_flux=True,
                                  do_toa_spectral_flux=True),
                             "torch_mcica_spectral_meridian32.npz"),
    "tripleclouds_ecckd_gpoint": (
        dict(sw_solver_name="Tripleclouds", lw_solver_name="Tripleclouds",
             do_save_gpoint_flux=True, **ECCKD),
        "torch_tripleclouds_ecckd_gpoint_meridian32.npz"),
    "cloudless_rrtmg_spectral": (
        dict(sw_solver="CLOUDLESS", lw_solver="CLOUDLESS",
             do_save_spectral_flux=True, do_toa_spectral_flux=True),
        "torch_cloudless_spectral_meridian32.npz"),
    "homogeneous_rrtmg_spectral": (
        dict(sw_solver="HOMOGENEOUS", lw_solver="HOMOGENEOUS",
             do_lw_aerosol_scattering=True, do_save_spectral_flux=True,
             do_toa_spectral_flux=True),
        "torch_homogeneous_spectral_meridian32.npz"),
    "monochromatic_homogeneous": (
        dict(gas_model_sw="MONOCHROMATIC", gas_model_lw="MONOCHROMATIC",
             sw_solver="HOMOGENEOUS", lw_solver="HOMOGENEOUS",
             mono_lw_total_od=1.0, mono_sw_total_od=0.2, use_aerosols=False,
             n_aerosol_types=0, i_aerosol_type_map=()),
        "torch_monochromatic_meridian32.npz"),
}
# the columns whose spectral flux profiles a reference file keeps (night,
# low, high and setting sun)
PROFILE_COLUMNS = (2, 9, 17, 26)
# Config fields given by the name of a member of the JAX package's enum
ENUM_FIELDS = {"sw_solver": "Solver", "lw_solver": "Solver",
               "gas_model_sw": "GasModel", "gas_model_lw": "GasModel",
               "liquid_model": "LiquidModel", "ice_model": "IceModel"}
NCOL = 32
SAMPLE_KEYS = ("od_scaling_sw", "od_scaling_lw", "total_cloud_cover_sw",
               "total_cloud_cover_lw")


def run_jax(dtype: str, config_name: str) -> dict:
    """A configuration's step in this process (x64 set from ``dtype``);
    returns {"<field>": array} plus, for float32 with a McICA solver,
    {"sample/<key>": array}."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64")
    import numpy as np

    sys.path.insert(0, REPO)
    import __graft_entry__
    from ecrad_tpu import config as jconfig
    from ecrad_tpu import pipeline
    from tools.bench_matrix import _resolve

    over = {k: getattr(jconfig, ENUM_FIELDS[k])[v] if k in ENUM_FIELDS
            else v for k, v in OUTPUTS[config_name][0].items()}
    step, args = __graft_entry__._build(
        ncol=NCOL, dtype=dtype, nam_overrides=_resolve(over))
    flux = jax.jit(step)(*args)
    out = {k: np.asarray(getattr(flux, k))
           for k in flux.__dataclass_fields__ if getattr(flux, k) is not None}
    # spectral profiles: (ncol, nlev+1, nspec)
    out = {k: v[list(PROFILE_COLUMNS)] if v.ndim == 3 else v
           for k, v in out.items()}
    if dtype == "float32":
        cloud = dict(zip(
            ["pressure_hl", "temperature_hl", "gas_mmr", "cos_sza",
             "skin_temperature", "sw_albedo", "sw_albedo_direct",
             "lw_emissivity", "cloud", "aerosol"], args))["cloud"]
        sample = jax.jit(lambda c: pipeline.add_cloud_sample(
            step.config, step.tables, c))(cloud)
        out.update({f"sample/{k}": np.asarray(sample[k])
                    for k in SAMPLE_KEYS if k in sample})
    return out


# entry point -> (runs: (name, dtype), output file)
ENTRY_POINTS = {
    "driver": ((("mcica_rrtmg", "float64"), ("mcica_rrtmg", "float32"),
                ("tripleclouds_rrtmg", "float64"),
                ("tripleclouds_rrtmg", "float32")),
               "torch_driver_meridian32.npz"),
    "ifs": ((("bitidentity", "float64"), ("device", "float64")),
            "torch_ifs_meridian32.npz"),
}


def write_namelist(path: str, config_name: str) -> None:
    """The drivers' namelist of a configuration (ecrad_torch.flagship)."""
    sys.path.insert(0, REPO)
    from ecrad_torch.data import DATA_DIR
    from ecrad_torch.flagship import namelist_text
    with open(path, "w") as f:
        f.write(namelist_text(config_name, DATA_DIR, iverbose=1,
                              do_write_double_precision=True))


def run_jax_entry(entry: str, name: str, dtype: str) -> dict:
    """One run of a JAX entry point (ENTRY_POINTS) in this process on the
    meridian file; returns {"<variable or output>": array}."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64")
    import numpy as np
    from scipy.io import netcdf_file

    sys.path.insert(0, REPO)
    from ecrad_tpu.data import MERIDIAN_INPUT
    with tempfile.TemporaryDirectory() as tmp:
        nam = os.path.join(tmp, "config.nam")
        out = os.path.join(tmp, "out.nc")
        if entry == "driver":
            from ecrad_tpu.driver import run
            write_namelist(nam, name)
            run(nam, MERIDIAN_INPUT, out, dtype=dtype)
            with netcdf_file(out, "r", mmap=False) as f:
                return {k: np.array(v.data) for k, v in f.variables.items()}
        from ecrad_tpu.ifs.driver import run_ifs
        write_namelist(nam, "mcica_rrtmg")
        res = run_ifs(nam, MERIDIAN_INPUT, None, dtype=dtype,
                      bitidentity=name == "bitidentity")
        return {k: np.asarray(v) for k, v in res.items() if k != "_flux"}


def write_entry(entry: str) -> None:
    import numpy as np

    runs, fname = ENTRY_POINTS[entry]
    out_path = os.path.join(DATA, fname)
    data = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, dtype in runs:
            part = os.path.join(tmp, f"{name}_{dtype}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--entry-worker", entry, name, dtype, part],
                           check=True)
            prefix = (f"{name}/{'f64' if dtype == 'float64' else 'f32'}/"
                      if entry == "driver" else f"{name}/")
            with np.load(part) as z:
                data.update({prefix + k: z[k] for k in z.files})
    commit = subprocess.run(["git", "-C", REPO, "rev-parse", "HEAD"],
                            capture_output=True, text=True).stdout.strip()
    data["commit"] = np.asarray(commit)
    np.savez_compressed(out_path, **data)
    print(f"wrote {out_path} ({os.path.getsize(out_path)} bytes, "
          f"commit {commit})")


def write(config_name: str) -> None:
    import numpy as np

    out_path = os.path.join(DATA, OUTPUTS[config_name][1])
    data = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float64", "float32"):
            part = os.path.join(tmp, f"{dtype}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", dtype, config_name, part],
                           check=True)
            tag = "f64" if dtype == "float64" else "f32"
            with np.load(part) as z:
                for k in z.files:
                    key = (f"f32_sample/{k[7:]}" if k.startswith("sample/")
                           else f"{tag}/{k}")
                    data[key] = z[k]
    commit = subprocess.run(["git", "-C", REPO, "rev-parse", "HEAD"],
                            capture_output=True, text=True).stdout.strip()
    data["commit"] = np.asarray(commit)
    if any(v.ndim == 3 for k, v in data.items() if k.startswith("f64/")):
        data["profile_columns"] = np.asarray(PROFILE_COLUMNS)
    np.savez_compressed(out_path, **data)
    print(f"wrote {out_path} ({os.path.getsize(out_path)} bytes, "
          f"commit {commit})")


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        import numpy as np
        np.savez(sys.argv[4], **run_jax(sys.argv[2], sys.argv[3]))
    elif len(sys.argv) == 6 and sys.argv[1] == "--entry-worker":
        import numpy as np
        np.savez(sys.argv[5], **run_jax_entry(*sys.argv[2:5]))
    else:
        for name in sys.argv[1:] or (*OUTPUTS, *ENTRY_POINTS):
            if name in ENTRY_POINTS:
                write_entry(name)
            else:
                write(name)
