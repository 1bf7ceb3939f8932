"""plslam_torch and chip_smoke.py stand alone: no JAX, no JAX package.

Every module of the port is imported in a fresh interpreter with ``jax``
blocked (``sys.modules["jax"] = None`` makes any import of it fail), and
the sources are searched for imports of jax or any mention of the JAX
package's name. Importing a module builds no kernel and needs no GPU. The
card's host has no OpenCV and no matplotlib: they are blocked in that
interpreter too, and no source imports them at module level (the TUM
reader and the viewer import them inside their functions).
"""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

import plslam_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(plslam_torch.__file__)
JAX_PKG = "plslam_" + "tpu"  # spelled in two parts so this file can be searched too


def _modules():
    names = ["plslam_torch"]
    for info in pkgutil.walk_packages([PKG], prefix="plslam_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert len(mods) >= 18
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            f"sys.modules['{JAX_PKG}'] = None\n"
            "sys.modules['cv2'] = None\n"
            "sys.modules['matplotlib'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            f" or m.startswith('{JAX_PKG}')]\n"
            "assert all(sys.modules[m] is None for m in bad), bad\n"
            "import plslam_torch.ops.cuda_build as cb\n"
            "assert not cb._loaded\n"
            "print('ok')\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_loop_closing_modules_are_covered():
    """The loop-closing slice's modules are among those imported above and
    searched below."""
    mods = set(_modules())
    for name in ("geometry.sim3", "optim.pose_graph", "optim.ba_cg", "models.loop_closing",
                 "models.async_mapping"):
        assert "plslam_torch." + name in mods
        assert os.path.join(PKG, *name.split(".")) + ".py" in set(_sources())


SYSTEM_SLICE = ("models.system", "models.pointcloud", "utils.tracing", "utils.tum_io",
                "utils.evaluate", "utils.checkpoint", "utils.gctune", "utils.viewer",
                "utils.run_tum")


@pytest.mark.parametrize("name", SYSTEM_SLICE)
def test_system_slice_modules_are_covered(name):
    """The System slice's modules are among those imported above and
    searched below, and import OpenCV and matplotlib only inside functions."""
    assert "plslam_torch." + name in set(_modules())
    path = os.path.join(PKG, *name.split(".")) + ".py"
    assert path in set(_sources())
    assert not re.search(r"^(import|from)\s+(cv2|matplotlib)\b", open(path).read(), re.M)


PARALLEL_SLICE = ("parallel", "parallel.multiseq")


@pytest.mark.parametrize("name", PARALLEL_SLICE)
def test_parallel_slice_modules_are_covered(name):
    """The batched multi-sequence slice's modules are among those imported
    above and searched below."""
    assert "plslam_torch." + name in set(_modules())
    path = os.path.join(PKG, *name.split("."))
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) else path + ".py"
    assert path in set(_sources())


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu")):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_do_not_name_jax(path):
    text = open(path).read()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(r"\bjax\b", text), "mentions jax"
    assert JAX_PKG not in text
