"""The bfloat16 control comes out not correct: the program's own bfloat16
Krylov basis (for the MG cell the coarse Lanczos's basis_dtype) and the
loops of the reference in the program's place in bfloat16, at a tiny size,
against the limits of the configuration (portbench.readings runs the same,
and the TF32 control, which the CPU cannot run, at the cell's own size on
the card)."""

import pytest
from conftest import tiny_cell

from portbench import check, readings

CELLS = ["wilson32-defl.flagship", "wilson32-mg.flagship"]


def _judged(cell, got):
    limits = cell.config["limits"]
    out = {n: {"value": got[n], "limit": limits[n]}
           for n in check.PER_CONFIGURATION}
    out["unconverged"] = {"value": int(not got["converged"]),
                          "limit": limits["unconverged"]}
    return out


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_the_program_passes(name, cpu_only):
    cell = tiny_cell(name)
    sound = readings.readings(cell, 2 ** 33 + 1, [0], None, "cpu")[0]
    control = readings.readings(cell, 2 ** 33 + 1, [0], "bf16", "cpu")[0]
    assert check.passed(_judged(cell, sound))
    assert not check.passed(_judged(cell, control))
    # the refine hands back orthonormal vectors from a bf16 basis too, so
    # orth is not the control's to catch (test_portbench_faults holds it)
    for n in ("eig_resid", "loop_rel"):
        assert control[n] > 10 * sound[n], (n, sound, control)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_fails_on_the_card(name):
    """The TF32 control (the program with TF32 in its float32 GEMMs) at a
    tiny size on the card: not correct."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA device")
    cell = tiny_cell(name)
    control = readings.readings(cell, 2 ** 33 + 1, [0], "tf32", "cuda")[0]
    assert not check.passed(_judged(cell, control)), control
