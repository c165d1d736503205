"""PLE's ``mmlrec.model.cgc`` span (``models/ple.py``): a forward under the
profiler records one range a CGC level; with no profiler running it opens
none; both give the same probabilities, bit for bit.  On the CPU, no JAX."""

import torch

from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.utils.seeding import make_generator

LEVELS = 2


def _ple():
    cfg = tsyn.make_config(model_name="ple", n_sparse=3, n_dense=0, vocab=50, hidden=(16, 8),
                           tower=(8,), gate=(8,), specific_expert_num=2, shared_expert_num=1,
                           num_levels=LEVELS)
    layout, x, _, _ = tsyn.make_data(cfg, n=32, seed=0, vocab=50)
    model = get_model("ple", layout, cfg, generator=make_generator(0), device="cpu").eval()
    ids = torch.stack([torch.as_tensor(x[s.feature.name], dtype=torch.int32)
                       for s in layout.sparse_slots], dim=1)
    return model, ids, torch.zeros((ids.shape[0], 0))


def test_a_traced_forward_holds_one_cgc_range_a_level_and_an_untraced_one_none(monkeypatch):
    model, ids, dense = _ple()
    with torch.no_grad(), torch.autograd.profiler.profile(use_kineto=True) as prof:
        traced = model(ids, dense)
    names = [e.name for e in prof.function_events]
    assert names.count("mmlrec.model.cgc") == LEVELS

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was opened with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with torch.no_grad():
        plain = model(ids, dense)
    assert torch.equal(traced, plain)
