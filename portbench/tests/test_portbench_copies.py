"""The benchmark's copies against what they were copied from: the data
generators to the bit, the operation counts at the cells' shapes, and the
imports (nothing of JAX or the JAX package anywhere under portbench/, nothing
of the program under portbench/reference/)."""

import ast
import os
import zlib

import numpy as np
import pytest

from portbench import counts, data
from portbench.driver import HERE, load


def test_bench_cosines_is_chip_smokes_draw():
    import chip_smoke
    X, y, Z, _, _ = chip_smoke.make_data("boston", seed=173)
    cfg = load("configs", "sgpr-hmc-boston")
    X2, y2, Z2 = data.bench_cosines(cfg["N"], cfg["D"], cfg["data_seed"], cfg["prop"], cfg["M"])
    for a, b in ((X, X2), (y, y2), (Z, Z2)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert X2.shape == (cfg["n_train"], cfg["D"])


def test_synthetic_regression_is_synthetic_large():
    from ggp_tpu_torch.experiments.regression import run_data
    from ggp_tpu_torch.utils.datasets import SyntheticLarge
    cfg = load("configs", "sgpr-hmc-elevator")
    assert cfg["data_seed"] == zlib.crc32(SyntheticLarge.name.encode()) % 2 ** 31
    ds, Z = run_data("synthetic-large", 0, cfg["prop"], cfg["M"], 45)
    X, y = data.synthetic_regression(cfg["N"], cfg["D"], cfg["data_seed"], cfg["split_seed"],
                                     cfg["noise"], cfg["prop"])
    assert np.array_equal(X, ds.X_train) and np.array_equal(y, ds.Y_train)
    assert np.array_equal(data.z_rows(X, cfg["M"], 45), Z)
    assert X.shape == (cfg["n_train"], cfg["D"])


@pytest.mark.parametrize("shape", [(404, 100, 13), (13279, 100, 18)])
@pytest.mark.parametrize("want_z", [False, True])
def test_bound_ops_is_chip_smokes(shape, want_z):
    import chip_smoke
    assert counts.bound_ops(*shape, want_z=want_z) == chip_smoke.bound_ops(*shape, want_z=want_z)
    assert counts.PEAK_F32_OPS == chip_smoke.PEAK_F32_OPS


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_nothing_imports_jax_or_the_jax_package():
    bad = {(p, m) for p in _sources() for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "ggp_tpu")}
    assert not bad


def test_reference_imports_nothing_of_the_program():
    bad = {(p, m) for p in _sources("reference") for m in _imports(p)
           if m.split(".")[0] not in ("torch", "math", "contextlib", "__future__", "numpy")}
    assert not bad


def test_forbidden_names_compare_whole_top_level_names():
    from portbench.run import FORBIDDEN
    assert "ggp_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "ggp_tpu.ops".split(".")[0] in FORBIDDEN
