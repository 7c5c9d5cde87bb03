"""The port stands alone: no module of it, and not ``chip_smoke.py``, imports
or loads by path anything of the JAX package (``unopticalflow_tpu``), of JAX
itself (``jax``, ``jaxlib``, ``flax``, ``optax``, and ``msgpack``: the
port reads flax's ``.ckpt`` with its own codec), of the repo's root
``benchmarks/`` (the JAX probes), nor a root module of the repo
(``serve.py``, ``train.py``, ... import the JAX package), and importing every
module of the port loads neither JAX nor any file under
``unopticalflow_tpu/``.  Nor does the port import opencv, h5py, matplotlib
or PIL, which the card's machine lacks: not at module level, not inside a
function (a source scan), and not at import (every module imports with the
four blocked and loads none of them).  The one exception is
``eval_odom.KittiEvalOdom.plot_path``'s matplotlib, which a later slice
replaces."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "unopticalflow_tpu"
JAX_LIBS = {"jax", "jaxlib", "flax", "optax", "msgpack"}
# top-level names whose files the port must not load by path either
PATH_ROOTS = (JAX_PKG, "benchmarks")
ROOT_MODULES = {os.path.splitext(os.path.basename(p))[0]
                for p in glob.glob(os.path.join(REPO, "*.py"))} - {"chip_smoke"}
SOURCES = sorted(glob.glob(os.path.join(REPO, "unopticalflow_tpu_torch", "**", "*.py"),
                           recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in PATH_ROOTS or top in JAX_LIBS or top in ROOT_MODULES


def _violations(path: str) -> list[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [f"{node.lineno}: import {a.name}" for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(f"{node.lineno}: from {node.module} import ...")
        elif isinstance(node, ast.Call):
            # importlib.import_module("..."), __import__("..."), and loading a
            # file of the JAX package or the root benchmarks/ by its path
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__", "spec_from_file_location"):
                for arg in node.args:
                    if isinstance(arg, ast.Constant) and isinstance(arg.value, str) and (
                            _forbidden(arg.value)
                            or any(f"{root}/" in arg.value for root in PATH_ROOTS)):
                        bad.append(f"{node.lineno}: {name}({arg.value!r})")
            roots = [a.value for a in node.args
                     if isinstance(a, ast.Constant) and a.value in PATH_ROOTS]
            if name == "join" and roots:
                bad.append(f"{node.lineno}: a path into {roots[0]}/")
    return bad


def test_the_scan_catches_each_kind_of_import(tmp_path):
    src = tmp_path / "x.py"
    src.write_text(
        "import unopticalflow_tpu\n"
        "import unopticalflow_tpu.ops as o\n"
        "from unopticalflow_tpu.utils.config import Config\n"
        "from serve import make_handler\n"
        "import importlib\n"
        "importlib.import_module('unopticalflow_tpu.data')\n"
        "import os\n"
        "p = os.path.join('r', 'unopticalflow_tpu', 'data', 'datasets.py')\n"
        "import unopticalflow_tpu_torch.ops\n"
        "from unopticalflow_tpu_torch.utils import convert\n"
        "import jax\n"
        "import jax.numpy as jnp\n"
        "from jax.experimental import pallas as pl\n"
        "import jaxlib\n"
        "import flax.linen as nn\n"
        "from optax import adam\n"
        "from benchmarks import gather_probe\n"
        "import benchmarks.pallas_gather_probe\n"
        "importlib.import_module('jax.numpy')\n"
        "q = os.path.join('r', 'benchmarks', 'gather_probe.py')\n"
        "from unopticalflow_tpu_torch.benchmarks import gather_probe\n"
        "from . import time_ms\n"
        "import msgpack\n"
    )
    assert sorted(int(v.split(":")[0]) for v in _violations(str(src))) == [
        1, 2, 3, 4, 6, 8, *range(11, 21), 23]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_of_the_port_imports_the_jax_package(path):
    assert _violations(path) == []


def test_importing_every_module_loads_nothing_of_the_jax_package():
    code = f"""
import importlib, json, os, pkgutil, sys
sys.path.insert(0, {REPO!r})
import unopticalflow_tpu_torch
names = [m.name for m in pkgutil.walk_packages(unopticalflow_tpu_torch.__path__,
                                               "unopticalflow_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import unopticalflow_tpu_torch.data, chip_smoke
jax_dir = os.path.realpath(os.path.join({REPO!r}, {JAX_PKG!r})) + os.sep
named = sorted(m for m in sys.modules if m == {JAX_PKG!r} or m.startswith({JAX_PKG!r} + "."))
by_path = sorted(m for m, mod in list(sys.modules.items())
                 if os.path.realpath(getattr(mod, "__file__", None) or "").startswith(jax_dir))
print(json.dumps({{"names": names, "named": named, "by_path": by_path,
                  "jax": sorted(m for m in sys.modules
                                if m.split(".")[0] in {sorted(JAX_LIBS)!r})}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"unopticalflow_tpu_torch.test", "unopticalflow_tpu_torch.evaluation.evaluate_flow",
            "unopticalflow_tpu_torch.ops.regularizer_cuda",
            "unopticalflow_tpu_torch.ops.gather_cuda",
            "unopticalflow_tpu_torch.benchmarks.gather_probe",
            "unopticalflow_tpu_torch.benchmarks.block_gather_probe",
            "unopticalflow_tpu_torch.benchmarks.sanity_train",
            "unopticalflow_tpu_torch.benchmarks.synthetic_epe",
            "unopticalflow_tpu_torch.data.datasets",
            "unopticalflow_tpu_torch.data.undistort",
            "unopticalflow_tpu_torch.ops.geometry",
            "unopticalflow_tpu_torch.models.pose_net",
            "unopticalflow_tpu_torch.models.flowpose_model",
            "unopticalflow_tpu_torch.evaluation.eval_odom"} <= set(got["names"])
    assert got["named"] == [] and got["by_path"] == [] and got["jax"] == []


HOST_LIBS = {"cv2", "h5py", "matplotlib", "PIL"}
# the one import of the four that the port still makes: eval_odom's plot
HOST_LIB_ALLOWED = {("unopticalflow_tpu_torch/evaluation/eval_odom.py", "matplotlib")}


def _host_lib_imports(path: str) -> list[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                names = [a.value for a in node.args
                         if isinstance(a, ast.Constant) and isinstance(a.value, str)]
        for n in names:
            top = n.split(".")[0]
            if top in HOST_LIBS and (os.path.relpath(path, REPO), top) not in HOST_LIB_ALLOWED:
                found.append(f"{node.lineno}: {n}")
    return found


def test_the_host_library_scan_catches_imports_inside_functions(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("def f():\n    import cv2\n    from h5py import File\n"
                   "    import matplotlib.pyplot as plt\n    from PIL import Image\n"
                   "    importlib.import_module('cv2')\n    import numpy\n")
    assert [v.split(":")[0] for v in _host_lib_imports(str(src))] == ["2", "3", "4", "5", "6"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_of_the_port_imports_opencv_h5py_matplotlib_or_pil(path):
    assert _host_lib_imports(path) == []


def test_every_module_imports_with_the_host_libraries_blocked():
    code = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {REPO!r})
for m in {sorted(HOST_LIBS)!r}:
    sys.modules[m] = None
import unopticalflow_tpu_torch
names = [m.name for m in pkgutil.walk_packages(unopticalflow_tpu_torch.__path__,
                                               "unopticalflow_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m, mod in sys.modules.items()
                if m.split(".")[0] in {sorted(HOST_LIBS)!r} and mod is not None)
print(json.dumps({{"names": names, "loaded": loaded}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"unopticalflow_tpu_torch.utils.hdf5", "unopticalflow_tpu_torch.utils.profiler",
            "unopticalflow_tpu_torch.evaluation.depth_harness",
            "unopticalflow_tpu_torch.evaluation.evaluate_depth",
            "unopticalflow_tpu_torch.evaluation.evaluate_mask"} <= set(got["names"])
    assert got["loaded"] == []
