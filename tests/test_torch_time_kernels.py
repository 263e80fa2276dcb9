"""tools/time_kernels.py's comparison of the float32 outputs two checkouts
saved for the same cases (CPU; the timing itself needs the card)."""

import pytest
import torch

from tools.time_kernels import case_file, compare_outputs

CASE = "lw_noscat_sweeps/meridian"


def _save(root, outputs):
    root.mkdir(exist_ok=True)
    torch.save(outputs, case_file(str(root), CASE))


def _outputs():
    g = torch.Generator().manual_seed(0)
    out = {"dn_bb": torch.rand(4, 3, generator=g),
           "fup_toa": torch.rand(4, 5, generator=g)}
    out["fup_toa"][2, 1] = 0.5
    return out


@pytest.mark.parametrize("other,want", [
    ("same", "equal"),
    ("moved", 2.0 ** -20),
    ("absent", "missing"),
    ("renamed", "names differ"),
])
def test_compare_outputs(tmp_path, other, want):
    this = _outputs()
    _save(tmp_path / "this", this)
    if other == "same":
        _save(tmp_path / "other", {k: v.clone() for k, v in this.items()})
    elif other == "moved":
        moved = {k: v.clone() for k, v in this.items()}
        moved["fup_toa"][2, 1] += 2.0 ** -20      # 0.5 + 2^-20, exact
        _save(tmp_path / "other", moved)
    elif other == "renamed":
        _save(tmp_path / "other", {"up_bb": this["dn_bb"]})
    else:
        (tmp_path / "other").mkdir()
    got = compare_outputs(str(tmp_path / "this"), str(tmp_path / "other"),
                          [CASE])
    assert got == {CASE: want}
