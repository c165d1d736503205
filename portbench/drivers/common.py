"""What both drivers share: the configuration as the program reads it,
the weights the benchmark draws, handing them to the program, and reading
the program's training state back in its checkpoint layout.

The weights are drawn here from the run's seed, on the run's device, one
call per parameter and the table in fixed chunks of rows (so that a chunk
can be drawn again later with the same bits, without the whole table
twice in memory).  The program receives them by parameter name; the
reference receives the same tensors.
"""

from __future__ import annotations

import copy
import gc
import math
from typing import Dict, Iterator, List, Tuple

import torch

from ..reference.dims import Dims
from ..reference.model import TABLE, family
from ..traffic.gen import generator

#: rows of the logical table drawn per call
TABLE_CHUNK_ROWS = 1 << 22
#: the table's draw scale (a trained model's embeddings are O(1))
TABLE_STD = 0.5


def experiment_config(spec: Dict):
    """The configuration file's ``experiment`` as the program's CLI reads a
    config file."""
    from mmlrec_tpu_torch.config import ExperimentConfig

    return ExperimentConfig.from_dict(copy.deepcopy(spec["experiment"]))


def layout(d: Dims):
    """The program's feature layout of the configuration: the sparse columns
    (the scene last), each with its assumed vocabulary, then the dense
    ones."""
    from mmlrec_tpu_torch.features import DenseFeat, FeatureLayout, SparseFeat

    return FeatureLayout([SparseFeat(c, v, d.emb) for c, v in zip(d.sparse, d.vocabs)]
                         + [DenseFeat(c, 1) for c in d.dense])


def draw_dense(d: Dims, seed: int, device) -> Dict[str, torch.Tensor]:
    """The dense parameters, by the program's names, at the magnitudes of a
    trained model: He-normal DNN kernels, final layers normal(0, 1/fan_in),
    biases normal(0, 0.05), the heads' bias 0.  A served score then spreads
    over (0, 1), and a training step starts where a deployment's continued
    training does, every leaf's gradient well above round-off (from the
    reference MMLRec's initial scale of 1e-4 the table's gradient is under
    a thousandth of the median leaf's, and its change would go unchecked)."""
    shapes = family(d.model_name).param_shapes(d)
    gen = generator(seed, "weights", device)
    out = {}
    for name, shape in shapes.items():
        if name == "out.bias":
            out[name] = torch.zeros(shape, device=device)
            continue
        if name.endswith("kernel"):
            std = math.sqrt((2.0 if ".dense_" in name else 1.0) / shape[-2])
        else:
            std = 0.05
        out[name] = std * torch.randn(shape, generator=gen, device=device)
    return out


def table_chunks(d: Dims, seed: int, device) -> Iterator[Tuple[int, torch.Tensor]]:
    """(first logical row, rows [n, emb]) of the logical table, chunk by
    chunk: normal(0, ``TABLE_STD``), the same bits every time it is drawn."""
    gen = generator(seed, "table", device)
    total = d.logical_rows
    for start in range(0, total, TABLE_CHUNK_ROWS):
        n = min(TABLE_CHUNK_ROWS, total - start)
        yield start, TABLE_STD * torch.randn((n, d.emb), generator=gen, device=device)


def table_rows(d: Dims, seed: int, device, rows: torch.Tensor) -> torch.Tensor:
    """The drawn table's logical ``rows`` (int64, on ``device``)."""
    out = torch.empty((rows.numel(), d.emb), device=device)
    for start, chunk in table_chunks(d, seed, device):
        sel = (rows >= start) & (rows < start + chunk.shape[0])
        out[sel] = chunk[rows[sel] - start]
    return out


def table_plane(model) -> torch.Tensor:
    """The program's table parameter without its moment half: the top half
    of a stacked ``[2Vp, W]`` container (its documented layout), else the
    ``[Vp, W]`` table; logical row r is row r of ``.view(-1, emb)``."""
    fused = model.embeddings.fused
    t = fused.table.detach()
    if fused.dual_container:
        return t[: fused.phys_rows]
    return t


def load_into(model, d: Dims, dense: Dict[str, torch.Tensor], seed: int) -> None:
    """Copy the drawn weights into the program's model, checking that its
    parameters are the family's, by name and shape, and that its fused
    table lays the features out as the benchmark does."""
    named = dict(model.named_parameters())
    want = set(dense) | {TABLE}
    if set(named) != want:
        raise ValueError(f"the program's parameters {sorted(set(named) ^ want)} differ from "
                         f"the {d.model_name} family's")
    offsets = model.embeddings.fused.offsets.tolist()
    if offsets != d.offsets or model.embeddings.fused.dim != d.emb:
        raise ValueError(f"the program's fused table {offsets} / dim "
                         f"{model.embeddings.fused.dim} is not the benchmark's layout")
    with torch.no_grad():
        for name, value in dense.items():
            if tuple(named[name].shape) != tuple(value.shape):
                raise ValueError(f"{name}: the program has {tuple(named[name].shape)}, the "
                                 f"family {tuple(value.shape)}")
            named[name].copy_(value)
        flat = table_plane(model).view(-1, d.emb)
        flat.zero_()
        for start, chunk in table_chunks(d, seed, flat.device):
            flat[start:start + chunk.shape[0]] = chunk


def untouched_changed(model, d: Dims, seed: int, touched: torch.Tensor) -> int:
    """Entries of the program's table outside the logical rows ``touched``
    (its pad rows included) that differ from what was handed to it."""
    flat = table_plane(model).view(-1, d.emb)
    keep = torch.ones(flat.shape[0], dtype=torch.bool, device=flat.device)
    keep[touched] = False
    bad = int((flat[d.logical_rows:] != 0).sum())
    for start, chunk in table_chunks(d, seed, flat.device):
        end = start + chunk.shape[0]
        diff = (flat[start:end] != chunk) & keep[start:end, None]
        bad += int(diff.sum())
    return bad


def program_state(trainer, d: Dims, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The program's state in its checkpoint layout: each dense parameter,
    its Adam first moment, and the table's logical ``rows`` with their
    first moment (as float32), by name (the table as ``TABLE`` and
    ``TABLE + ".mu"``)."""
    from mmlrec_tpu_torch.train.checkpointing import state_to_split_layout

    params = {k: v.detach() for k, v in trainer.model.named_parameters()}
    split = state_to_split_layout(trainer, {"params": params, "table_opt": trainer.table_opt})
    out = {k: v.clone() for k, v in split["params"].items() if k != TABLE}
    out.update({f"{k}.mu": v.detach().clone() for k, v in trainer.opt_state.mu.items()})
    out[TABLE] = split["params"][TABLE].reshape(-1, d.emb)[rows].float()
    out[TABLE + ".mu"] = split["table_opt"].mu.reshape(-1, d.emb)[rows].float()
    return out


def fused_ids(x: Dict, d: Dims, lo: int, hi: int) -> torch.Tensor:
    """Logical table rows [hi - lo, n_sparse] (int64) of rows [lo, hi) of
    the column dict ``x``."""
    cols = [torch.from_numpy(x[c][lo:hi]).long() + off for c, off in zip(d.sparse, d.offsets)]
    return torch.stack(cols, dim=1)


def dense_block(x: Dict, d: Dims, lo: int, hi: int) -> torch.Tensor:
    if not d.dense:
        return torch.zeros((hi - lo, 0))
    return torch.stack([torch.from_numpy(x[c][lo:hi]) for c in d.dense], dim=1).float()


def settle() -> None:
    """Before a window: collect, then move every object set-up made into
    the collector's permanent generation, so that no collection in the
    window walks the harness's own data (the rows, the requests)."""
    gc.collect()
    gc.freeze()


def device_info(device, chips: int) -> Dict:
    """What the result's ``device`` holds; a run on the CPU (the tests'
    rehearsal) measures no device number and says so."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def free(device) -> None:
    """Return what the freed program held to the device."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def column_slice(x: Dict, lo: int, hi: int) -> Dict:
    return {k: v[lo:hi] for k, v in x.items()}


def unique_rows(parts: List[torch.Tensor]) -> torch.Tensor:
    return torch.unique(torch.cat([p.reshape(-1) for p in parts]))
