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
  ``tests/data/torch_tripleclouds_meridian32.npz``.

    python tools/make_torch_reference.py
"""

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
# configuration -> (nam_overrides, output file)
OUTPUTS = {
    "mcica_rrtmg": ({}, "torch_flagship_meridian32.npz"),
    "tripleclouds_rrtmg": (dict(sw_solver_name="Tripleclouds",
                                lw_solver_name="Tripleclouds"),
                           "torch_tripleclouds_meridian32.npz"),
}
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
    from ecrad_tpu import pipeline
    from tools.bench_matrix import _resolve

    step, args = __graft_entry__._build(
        ncol=NCOL, dtype=dtype,
        nam_overrides=_resolve(OUTPUTS[config_name][0]))
    flux = jax.jit(step)(*args)
    out = {k: np.asarray(getattr(flux, k))
           for k in flux.__dataclass_fields__ if getattr(flux, k) is not None}
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
    np.savez_compressed(out_path, **data)
    print(f"wrote {out_path} ({os.path.getsize(out_path)} bytes, "
          f"commit {commit})")


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        import numpy as np
        np.savez(sys.argv[4], **run_jax(sys.argv[2], sys.argv[3]))
    else:
        for name in OUTPUTS:
            write(name)
