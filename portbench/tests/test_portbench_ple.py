"""``ple.train`` at its CPU scale: the program passes; a step that leaves
the state unchanged fails, and so does a program that moves the last CGC
level's shared gate, which feeds nothing (its leaves get a gradient
through a term of value 0, so every probability and loss stays the same
bit for bit)."""

import pytest

from portbench import run
from portbench.reference.dims import dims
from portbench.reference.model import family
from portbench.tests.test_portbench_cells import _state_unchanged, run_tiny

CELL = "ple.train"


def _last_shared_gate_moved(monkeypatch):
    from mmlrec_tpu_torch.models.ple import PLE

    forward = PLE.forward

    def moved(self, *args, return_intermediates=False, **kwargs):
        probs, inter = forward(self, *args, return_intermediates=True, **kwargs)
        lane = inter[f"ple_output_{self.mc.num_levels - 1}"][:, -1].sum(-1, keepdim=True)
        probs = probs + (lane - lane.detach())
        return (probs, inter) if return_intermediates else probs

    monkeypatch.setattr(PLE, "forward", moved)


def test_the_last_shared_gate_is_still_in_the_reference():
    _, spec, _, _, _ = run.cell_files(run.benchmark(), CELL)
    d = dims(spec)
    shapes = family(d.model_name).param_shapes(d)
    last = d.model_config["num_levels"] - 1
    still = {k for k in shapes if k.startswith((f"shared_gate_dnn_{last}.",
                                                f"shared_gate_final_{last}."))}
    assert still == {f"shared_gate_dnn_{last}.dense_0.kernel",
                     f"shared_gate_dnn_{last}.dense_0.bias", f"shared_gate_final_{last}.kernel"}


@pytest.mark.parametrize("fault,number", [(_state_unchanged, "change_norm_gap"),
                                          (_last_shared_gate_moved, "grad_norm_gap")],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_ple_is_not_correct(fault, number, monkeypatch):
    fault(monkeypatch)
    r = run_tiny(CELL)
    assert not r["correct"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"], r["checks"]
