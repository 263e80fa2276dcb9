"""The port's bit-exact host McICA generator (native C++/OpenMP and numpy
forms, ecrad_torch/solvers/cloud_generator_exact.py, ecrad_torch/native)
against the JAX package's numpy form on the 32 meridian columns: equal
bit for bit for every overlap scheme, beta overlap and both PDF shapes.
The native library is built into build/ecrad_torch/, never beside its
source, and a failed build raises."""

import os

import numpy as np
import pytest

from ecrad_tpu.solvers import cloud_generator_exact as jcge
from ecrad_torch import native
from ecrad_torch.data import DATA_DIR, MERIDIAN_INPUT
from ecrad_torch.io.input import read_input
from ecrad_torch.kernels import BUILD_DIR
from ecrad_torch.solvers import cloud_generator_exact as pcge

# case -> (overlap scheme, PDF file, beta overlap, ng)
CASES = {
    "max_ran": (0, "mcica_gamma.nc", False, 112),
    "exp_ran": (1, "mcica_gamma.nc", False, 140),
    "exp_exp": (2, "mcica_gamma.nc", False, 112),
    "exp_ran_lognormal": (1, "mcica_lognormal.nc", False, 112),
    "exp_ran_beta": (1, "mcica_gamma.nc", True, 140),
    "exp_exp_beta": (2, "mcica_lognormal.nc", True, 32),
}


@pytest.fixture(scope="module")
def meridian():
    inp = read_input(MERIDIAN_INPUT)
    total_water = inp.cloud_mixing_ratio.sum(axis=-1)
    frac = np.where((inp.cloud_fraction >= 1e-6) & (total_water >= 1e-9),
                    inp.cloud_fraction, 0.0)
    return inp, frac


@pytest.mark.parametrize("case", list(CASES))
def test_bit_equal_to_jax(meridian, case):
    inp, frac = meridian
    scheme, pdf_file, beta, ng = CASES[case]
    path = os.path.join(DATA_DIR, pdf_file)
    kw = dict(ng=ng, i_overlap_scheme=scheme, iseed=inp.iseed + 997,
              frac_threshold=1e-6, frac=frac,
              overlap_param=inp.overlap_param, decorrelation_scaling=0.5,
              fractional_std=inp.fractional_std, use_beta_overlap=beta)
    od_j, cc_j = jcge.cloud_generator_all_columns(
        pdf_sampler=jcge.PdfSampler.from_file(path), allow_native=False,
        **kw)
    sampler = pcge.PdfSampler.from_file(path)
    od_n, cc_n = pcge.cloud_generator_all_columns(pdf_sampler=sampler, **kw)
    od_p, cc_p = pcge.cloud_generator_all_columns(
        pdf_sampler=sampler, allow_native=False, **kw)
    assert od_n.shape == (32, inp.nlev, ng)
    assert (cc_j > 0).sum() > 10 and (od_j > 0).any()
    for od, cc in ((od_n, cc_n), (od_p, cc_p)):
        assert np.array_equal(od, od_j)
        assert np.array_equal(cc, cc_j)


def test_native_rejects_bad_shapes(meridian):
    inp, frac = meridian
    sampler = pcge.PdfSampler.from_file(os.path.join(DATA_DIR,
                                                     "mcica_gamma.nc"))
    with pytest.raises(ValueError):
        native.cloud_generator_all_columns(
            16, 1, inp.iseed, 1e-6, frac, inp.overlap_param[:, :-1], 0.5,
            inp.fractional_std, sampler)


def test_library_built_outside_the_source_tree():
    path = native.build()
    assert os.path.dirname(path) == BUILD_DIR
    src_dir = os.path.dirname(native.SOURCE)
    assert not [f for f in os.listdir(src_dir)
                if f.endswith((".so", ".o", ".tmp"))]


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
