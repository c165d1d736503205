"""The port stands alone: it imports neither JAX nor the JAX package (nor
pandas or scikit-learn, which the machine with the card lacks), a CPU
tensor never reaches a CUDA kernel, and the default device is the card."""

import ast
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mmlrec_tpu_torch.ops import kernels as K

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mmlrec_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mmlrec_tpu", "sklearn", "pandas")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mmlrec_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'mmlrec_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert "mmlrec_tpu_torch.serving" in out and "mmlrec_tpu_torch.convert" in out
    for m in ("train.trainer", "train.sparse_embedding", "train.losses", "train.optimizers",
              "train.metrics", "ops.row_gather", "ops.row_scatter", "ops.cuda_build",
              "ops.kernels", "ops.embedding", "ops.layers", "tools.profile_step",
              "tools.tune_kernels", "models.mlp", "models.sharedbottom", "models.esmm",
              "models.hmoe", "models.cross_stitch", "models.aitm", "models.ple", "models.snr",
              "models.star", "models.apg", "models.pepnet", "ops.domain_norm", "main",
              "native", "data", "train.checkpointing", "train.device_metrics",
              "train.staging", "train.graphs", "utils.results", "utils.seeding",
              "train.pcgrad", "train.gradnorm", "train.cagrad", "train.cka",
              "train.multi_seed", "train.sweep", "tools.probe_rows", "tools.timing"):
        assert f"mmlrec_tpu_torch.{m}" in out
    on_disk = {".".join(f.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
               for f in PORT.rglob("*.py")}
    assert on_disk <= set(out), sorted(on_disk - set(out))  # every file of the port was imported
    assert [m for m in out if _forbidden(m)] == []


def test_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{f.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_ctypes_signatures_match_the_c_sources():
    """Every exported launcher's ctypes argument list has one entry per C
    parameter, pointers as pointers, the stream included.  An argument
    beyond the list would go through ctypes' default conversion, which cuts
    a Python int to 32 bits: a stream handle above 4 GB then crashes the
    launch (the row kernels' lists once ended before the stream)."""
    from mmlrec_tpu_torch.ops import row_gather
    from mmlrec_tpu_torch.tools import probe_rows

    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_uint: "unsigned",
             ctypes.c_longlong: "long long"}
    seen = 0
    for library in (K.LIBRARY, row_gather.LIBRARY, probe_rows.LIBRARY):
        source = library.source.read_text()
        for name, argtypes in library.signatures.items():
            found = re.search(r"\bint " + name + r"\(([^)]*)\)", source)
            assert found, f"{name} is not exported by {library.source.name}"
            params = [" ".join(p.split()) for p in found.group(1).split(",")]
            want = ["pointer" if "*" in p else p.replace("const ", "").rsplit(" ", 1)[0]
                    for p in params]
            assert [kinds[t] for t in argtypes] == want, (name, params)
            assert params[-1] == "void* stream"
            seen += 1
    assert seen == 14


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA path")

    monkeypatch.setattr(K, "_lib", no_kernel)
    monkeypatch.setattr(K, "_launch", no_kernel)
    K.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    table, dense = torch.randn(16, 4, generator=g), torch.randn(5, 2, generator=g)
    ids = torch.randint(0, 16, (5, 3), generator=g, dtype=torch.int32)
    assert K.embed_concat(table, ids, dense).shape == (5, 14)
    assert K.gated_expert_mix(torch.randn(5, 2, 4), torch.randn(5, 4, 8)).shape == (5, 2, 8)
    assert K.multihead_score(torch.randn(5, 2, 8), torch.randn(2, 8), torch.zeros(2)).shape == (5, 2)
    t = table.clone().requires_grad_(True)  # differentiable: still the plain version
    K.embed_concat(t, ids, dense).sum().backward()
    assert t.grad is not None and K.backward_counts["embed_concat"] == 1
    assert K.launch_counts == {k: 0 for k in K.launch_counts}


def test_default_device_is_the_card(monkeypatch, tmp_path):
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.serving import ServingBundle, save_serving_bundle
    from mmlrec_tpu_torch.synthetic import make_config, make_data

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_config(emb=4, n_sparse=3, n_dense=2, hidden=(8,), tower=(4,), gate=(4,))
    layout, *_ = make_data(cfg, n=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("mmoe", layout, cfg)
    for name in ("snr_trans", "mssm", "star", "apg", "pepnet"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model(name, layout, make_config(model_name=name, emb=4, n_sparse=3, n_dense=2,
                                                hidden=(8,), tower=(4,)))
    save_serving_bundle(get_model("mmoe", layout, cfg, device="cpu"), str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingBundle.load(str(tmp_path))
    assert ServingBundle.load(str(tmp_path), device="cpu").device.type == "cpu"
    from mmlrec_tpu_torch.train import Trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_model("mmoe", layout, cfg, device="cpu"))  # and with it fit / evaluate


def test_kernel_source_builds_for_hopper():
    """The build flags target sm_90a and the library is keyed by the source."""
    flags = " ".join(K.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    path = K.library_path()
    assert path.parent == ROOT / "build" / "torch_kernels"
    assert path == K.library_path() and path.suffix == ".so"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert os.path.exists(ROOT / "mmlrec_tpu_torch" / "csrc" / "recsys_kernels.cu")


def test_row_kernel_source_builds_for_hopper():
    """The row kernels are a second library of the same build: keyed by
    their own source, next to the forward kernels."""
    from mmlrec_tpu_torch.ops import row_gather

    path = row_gather.LIBRARY.path()
    assert path.parent == K.library_path().parent and path != K.library_path()
    assert path.name.startswith("librow_kernels_") and path.suffix == ".so"
    assert row_gather.LIBRARY.source == ROOT / "mmlrec_tpu_torch" / "csrc" / "row_kernels.cu"
    assert set(row_gather.LIBRARY.signatures) == {
        "mmlrec_rows_gather", "mmlrec_rows_write", "mmlrec_row_gather_staged",
        "mmlrec_rows_write_pipelined", "mmlrec_rows_update"}
    source = row_gather.LIBRARY.source.read_text()
    for kernel in ("rows_gather_kernel", "rows_write_kernel", "row_gather_staged_kernel",
                   "rows_write_pipelined_kernel", "rows_update_kernel"):  # one __global__ each
        assert len(re.findall(r"\n" + kernel + r"\(", source)) == 1
        assert source.count(kernel + "<<<") == 1


def test_probe_kernel_source_builds_for_hopper():
    """The probe kernels are a third library of the same build, keyed by
    their own source: one __global__ function and one launch a kernel."""
    from mmlrec_tpu_torch.ops import cuda_build, row_gather
    from mmlrec_tpu_torch.tools import probe_rows

    path = probe_rows.LIBRARY.path()
    assert path.parent == K.library_path().parent
    assert path not in (K.library_path(), row_gather.LIBRARY.path())
    assert path.name.startswith("libprobe_kernels_") and path.suffix == ".so"
    assert probe_rows.LIBRARY.source == ROOT / "mmlrec_tpu_torch" / "csrc" / "probe_kernels.cu"
    names = ("rows_write", "pairs_write", "rows_gather", "pairs_gather", "window_add")
    assert set(probe_rows.LIBRARY.signatures) == {f"mmlrec_probe_{n}" for n in names}
    source = probe_rows.LIBRARY.source.read_text()
    assert len(re.findall(r"\n__global__ ", source)) == len(names)
    for n in names:
        kernel = f"probe_{n}_kernel"
        assert len(re.findall(r"\n" + kernel + r"\(", source)) == 1
        assert source.count(kernel + "<<<") == 1
        assert cuda_build.launch_counts[f"probe_{n}"] >= 0  # counted by its wrapper


def _c_type(decl: str) -> str:
    """The type of a C declaration ``type name``, without ``const`` and with
    its stars attached: ``const int32_t *kinds`` -> ``int32_t*``."""
    return re.sub(r"\s*\*\s*", "* ", " ".join(decl.replace("const ", "").split())).rsplit(" ", 1)[0]


def test_native_ctypes_signatures_match_the_c_source():
    """The host loaders declare each function of native/step_metadata.cpp
    and native/fast_csv.cpp they call with its C return type and one ctypes
    entry per C parameter: int64_t as c_int64, int32_t as c_int32, char* as
    c_char_p, void* as c_void_p, pointers as pointers of their type; and
    every ``fc_*`` function of the CSV loader is declared."""
    from mmlrec_tpu_torch import native

    kinds = {None: "void", ctypes.c_void_p: "void*", ctypes.c_char_p: "char*",
             ctypes.c_int64: "int64_t", ctypes.c_int32: "int32_t",
             ctypes.POINTER(ctypes.c_int64): "int64_t*", ctypes.POINTER(ctypes.c_int32): "int32_t*",
             ctypes.POINTER(ctypes.c_float): "float*", ctypes.POINTER(ctypes.c_double): "double*"}
    declared = {}  # name -> (return type, parameter types), per source
    for source in (native.SOURCE, native.CSV_SOURCE):
        for ret, name, params in re.findall(r"\n((?:const )?\w+[ *]+)(\w+)\(([^)]*)\)",
                                            source.read_text()):
            declared[source, name] = (_c_type(ret + name), [_c_type(p) for p in params.split(",")])
    assert {"sm_fill", "sm_counts"} <= set(native.SIGNATURES)
    assert {n for s, n in declared if s == native.CSV_SOURCE and n.startswith("fc_")} == {
        n for n in native.SIGNATURES if n.startswith("fc_")} == {
        "fc_load", "fc_error", "fc_rows", "fc_train_rows", "fc_vocab", "fc_read_floats",
        "fc_read_codes", "fc_free"}
    for name, (restype, argtypes) in native.SIGNATURES.items():
        ret, params = declared[native.EXPORTED_BY[name], name]
        assert (kinds[restype], [kinds[t] for t in argtypes]) == (ret, params), name


def test_ctrdataset_runs_without_pandas_or_sklearn(tmp_path, monkeypatch):
    """The machine with the card has neither pandas nor scikit-learn: both
    backends, the fixups and the auto rule read CSV pairs with the two
    modules unimportable."""
    from _torch_data_common import raw_config, write_pair
    from mmlrec_tpu_torch import native
    from mmlrec_tpu_torch.config import ExperimentConfig
    from mmlrec_tpu_torch.data import ctrdataset

    monkeypatch.setitem(sys.modules, "pandas", None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    rng = np.random.default_rng(0)
    header = ["user_active_degree", "onehot_a", "n", "scene", "label"]

    def rows(n):
        return [[rng.choice(["0", "low", "high"]), rng.choice(["1.0", "", "2.5"]),
                 "%.6g" % rng.normal(), rng.integers(0, 2), rng.integers(0, 2)] for _ in range(n)]
    backends = ["pandas"]
    try:
        native.get_csv_lib()
        backends.append("native")
    except native.NativeUnavailable:
        pass
    for prefix in ("plain_", "kuairec_"):
        train = rows(50)
        tr, te = write_pair(tmp_path, prefix, header, train, rows(20))
        cfg = ExperimentConfig.from_dict(raw_config(tr, te, header, header[:2], ["n"]))
        for backend in backends + ["auto"]:
            ds = ctrdataset(cfg, backend=backend)
            fixups = prefix == "kuairec_" and backend != "native"  # the active-degree filter
            assert len(ds.y_train) == (sum(r[0] != "0" for r in train) if fixups else 50)
            assert ds.y_test.shape == (20, 2) and len(ds.test_input["n"]) == 20


def test_new_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """The CLI, checkpoint loading and set_seed's generator run on the card
    unless asked for the CPU, and raise without one."""
    from mmlrec_tpu_torch.main import main
    from mmlrec_tpu_torch.train import checkpointing
    from mmlrec_tpu_torch.utils import set_seed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = str(ROOT / "configs" / "example_synthetic_msl.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", config, "--seed", "0", "--synthetic"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", config, "--seed", "0"])  # the CSV path: raised before any file is read
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpointing.load_tensors(str(tmp_path), checkpointing.VARIABLES_FILE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        set_seed(0)
    assert set_seed(0, "cpu").device.type == "cpu"
    from mmlrec_tpu_torch.tools import probe_rows

    for command in probe_rows.COMMANDS:  # the probe tool: --device cpu runs its plain versions
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe_rows.main([command])
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.synthetic import make_config, make_data
    from mmlrec_tpu_torch.train.multi_seed import SeedSuiteTrainer
    from mmlrec_tpu_torch.train.sweep import GridSweepTrainer

    cfg = make_config(emb=4, n_sparse=3, n_dense=2, hidden=(8,), tower=(4,), gate=(4,))
    layout, *_ = make_data(cfg, n=8)
    for suite, kw in ((SeedSuiteTrainer, {}), (GridSweepTrainer, dict(lrs=[1e-3]))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            suite(get_model("mmoe", layout, cfg, device="cpu"), **kw)
    assert main.__module__ == "mmlrec_tpu_torch.main"
    # the CSV pipeline is host code: numpy arrays, no device to default
    import inspect

    from mmlrec_tpu_torch import native
    from mmlrec_tpu_torch.data import ctrdataset

    for fn in (ctrdataset, native.load_csv_columns):
        assert "device" not in inspect.signature(fn).parameters
