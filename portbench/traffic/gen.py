"""The one traffic generator: every mix under ``portbench/mixes/`` is a set
of parameters for it.

The draws copy ``chip_smoke.py::_recipe_data``: per sparse feature Zipf(a)
ids (numpy's rejection sampler: ``X = floor(U^(-1/(a-1)))`` accepted with
probability ``T / b`` against its envelope) taken modulo the feature's own
vocabulary, or
uniform ids; dense values U(0, 1) or N(0, 1); labels Bernoulli(p).  They
run on the device the run uses, from generators seeded by ``(seed,
stream)``, in a few large calls: a million rows of Zipf ids take a few
milliseconds on the card, where numpy takes seconds.  The same seed gives
the same rows on the same device.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

#: numpy's Zipf sampler rejects draws above this (LONG_MAX)
_ZIPF_CAP = float(2**63 - 1)
_STREAMS = {"train": 1, "val": 2, "pool": 3, "weights": 4, "table": 5, "order": 6}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of a run's seed."""
    return (int(seed) * 1_000_003 + _STREAMS[stream] * 7_919) % (2**63 - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def zipf(shape: Tuple[int, ...], a: float, gen: torch.Generator) -> torch.Tensor:
    """int64 Zipf(a) draws (support 1, 2, ...) of ``shape``, by numpy's
    rejection sampler on ``gen``'s device, in float64."""
    n = math.prod(shape)
    am1 = a - 1.0
    b = 2.0 ** am1
    out: List[torch.Tensor] = []
    have = 0
    while have < n:
        m = int((n - have) * 1.25) + 1024
        u = 1.0 - torch.rand(m, generator=gen, device=gen.device, dtype=torch.float64)
        v = torch.rand(m, generator=gen, device=gen.device, dtype=torch.float64)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        keep = (x >= 1.0) & (x <= _ZIPF_CAP) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        got = x[keep]
        out.append(got)
        have += got.numel()
    return torch.cat(out)[:n].reshape(shape)


def ids(kind: Dict, n: int, vocabs: Sequence[int], gen: torch.Generator) -> torch.Tensor:
    """[features, n] int32 ids, feature i's in [0, vocabs[i]).  Features
    that share one vocabulary take it in one draw."""
    features = len(vocabs)
    shared = len(set(vocabs)) == 1
    if kind["kind"] == "zipf":
        x = zipf((features, n), float(kind["a"]), gen)
        mod = float(vocabs[0]) if shared else torch.tensor(
            vocabs, dtype=torch.float64, device=gen.device)[:, None]
        return torch.remainder(x - 1.0, mod).to(torch.int32)
    if kind["kind"] == "uniform":
        if shared:
            return torch.randint(0, vocabs[0], (features, n), generator=gen, device=gen.device,
                                 dtype=torch.int32)
        return torch.stack([torch.randint(0, v, (n,), generator=gen, device=gen.device,
                                          dtype=torch.int32) for v in vocabs])
    raise ValueError(f"unknown id distribution {kind['kind']!r}")


def sparse_columns(exp: Dict) -> Tuple[List[str], Optional[str]]:
    """(the sparse feature columns in layout order, the scene column or
    None): the config's feature columns, then the scene feature, which the
    reference's data loader appends when it is not among them."""
    dc = exp["data_config"]
    cols = list(dc["feature_columns"])
    scene = dc.get("scene_feature") or None
    if exp["model_config"]["task_name"] == "mtl":
        scene = None
    if scene and scene not in cols:
        cols.append(scene)
    return cols, scene


def rows(exp: Dict, vocab: Union[int, Sequence[int]], mix: Dict, n: int, seed: int,
         stream: str, device) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """``n`` rows of the config's schema: ({column: contiguous numpy
    array}, labels [n, label columns] float32, or None for a mix without
    labels).  ``vocab``: the ids of every sparse slot, or each slot's in
    the order of ``sparse_columns`` (the scene's values come from the
    config's ``mask_values``)."""
    dc = exp["data_config"]
    gen = generator(seed, stream, device)
    cols, scene = sparse_columns(exp)
    vocabs = [vocab] * len(cols) if isinstance(vocab, int) else list(vocab)
    plain = [(c, v) for c, v in zip(cols, vocabs) if c != scene]
    x: Dict[str, np.ndarray] = {}
    drawn = ids(mix["ids"], n, [v for _, v in plain], gen).cpu().numpy()
    for i, (c, _) in enumerate(plain):
        x[c] = drawn[i]
    if scene:
        codes = torch.randint(0, int(dc["num_domains"]), (n,), generator=gen, device=device)
        values = np.asarray(dc["mask_values"], dtype=np.int32)
        x[scene] = values[codes.cpu().numpy()]
    dense = list(dc["dense_columns"])
    if dense:
        if mix["dense"] == "uniform":
            d = torch.rand((len(dense), n), generator=gen, device=device)
        else:
            d = torch.randn((len(dense), n), generator=gen, device=device)
        d = d.cpu().numpy()
        for i, c in enumerate(dense):
            x[c] = d[i]
    if "labels" not in mix:
        return x, None
    labels = list(dc["label_columns"])
    p = float(mix["labels"]["p"])
    distinct = list(dict.fromkeys(labels))
    if mix["labels"].get("shared"):
        one = (torch.rand(n, generator=gen, device=device) < p).float().cpu().numpy()
        y = np.stack([one] * len(labels), axis=1)
    else:
        draws = (torch.rand((len(distinct), n), generator=gen, device=device) < p)
        draws = draws.float().cpu().numpy()
        y = np.stack([draws[distinct.index(c)] for c in labels], axis=1)
    return x, np.ascontiguousarray(y, dtype=np.float32)


def request_sizes(spec: Dict, seed: int) -> np.ndarray:
    """The closed loop's request sizes: ``sizes`` quantiles of a log-normal
    of the given median and sigma, clipped to [min, max], in an order drawn
    from ``seed``.  Every seed sends the same set of sizes, so the tail of
    the latencies reads the same work."""
    s = int(spec["sizes"])
    nd = statistics.NormalDist()
    mu, sigma = math.log(float(spec["median_rows"])), float(spec["sigma"])
    q = np.array([math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / s)) for i in range(s)])
    sizes = np.clip(np.rint(q), int(spec["min_rows"]), int(spec["max_rows"])).astype(np.int64)
    order = np.random.default_rng(stream_seed(seed, "order")).permutation(s)
    return sizes[order]


def request_offsets(sizes: np.ndarray, pool: int, seed: int) -> np.ndarray:
    """Where each request's rows start in the pool, drawn from ``seed``."""
    rng = np.random.default_rng(stream_seed(seed, "pool"))
    return (rng.random(len(sizes)) * (pool - sizes + 1)).astype(np.int64)
