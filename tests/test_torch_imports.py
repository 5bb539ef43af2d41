"""The PyTorch port imports torch, never jax, and nothing of the JAX package.

``mageslam_tpu_torch`` keeps its own copy of what it needs from the JAX
package ``mageslam_tpu`` (the settings classes, ``config.py``), because the
GPU host that runs the port has neither JAX nor that package's
dependencies.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "mageslam_tpu_torch"


CONSOLE = ROOT / "examples" / "console_torch.py"
# the port's bench, example and measuring tools, which run on the card's
# host too
PROGRAMS = [ROOT / "bench_torch.py",
            ROOT / "examples" / "run_synthetic_torch.py",
            *(ROOT / "tools" / f"{name}.py" for name in (
                "make_dataset_torch", "profile_torch_engine",
                "profile_torch_frontend", "bench_torch_matching",
                "bench_torch_scaling", "probe_torch_long_init"))]


def test_import_leaves_jax_unloaded():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    for m in ("fuser.imu", "device", "io.datasets", "io.native_loader",
              "io.serialization", "io.synthetic", "runtime.slam",
              "tracking.keyframe_decision", "io.recording", "utils.xray",
              "utils.tracing", "runtime.skeleton_key",
              "mapstore.denoising", "parallel.distributed_ba",
              "parallel.trajectory_sharding", "parallel.fleet",
              "parallel.multiprocess", "io.real_texture"):
        assert f"mageslam_tpu_torch.{m}" in modules
    # the console and those programs too, as a script would load them
    # the console's --host-engine flag picks the host engine's class
    programs = [str(p) for p in PROGRAMS]
    code = ("import sys, importlib, runpy; import mageslam_tpu_torch; "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            f"[runpy.run_path(p, run_name='program') for p in {programs!r}]; "
            f"c = runpy.run_path({str(CONSOLE)!r}, run_name='console'); "
            "assert c['parse_args'](['--host-engine']).host_engine; "
            "assert not c['parse_args']([]).host_engine; "
            "print('jax' in sys.modules or 'mageslam_tpu' in sys.modules)")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_package_sources_import_no_jax():
    # the package, and what runs on a GPU host that has no JAX
    files = sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
        CONSOLE, *PROGRAMS]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "mageslam_tpu"), (
                path, mod)


# the tools that write the port's goldens and diagnose its parity run the
# JAX package by design, as do the parity tests (tests/test_torch_*.py)
# that read their constants; they import it inside their functions
JAX_TOOLS = sorted((ROOT / "tools").glob("make_torch_*_fixture.py")) + [
    ROOT / "tools" / "diagnose_torch_init_rate.py"]


def _top_level_imports(path: Path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_fixture_tools_import_jax_only_when_run():
    names = {p.name for p in JAX_TOOLS}
    assert {"make_torch_long_fixture.py", "make_torch_init_fixture.py",
            "make_torch_ring_fixture.py"} <= names
    for path in JAX_TOOLS:
        assert any(m.split(".")[0] in ("jax", "mageslam_tpu")
                   for m in _imports(path)), path
        for mod in _top_level_imports(path):
            assert mod.split(".")[0] not in ("jax", "mageslam_tpu"), (
                path, mod)


def test_mapstore_leaves_the_engine_unloaded():
    # a map-store leaf asks where to run without loading the runtime above
    code = ("import sys; "
            "import mageslam_tpu_torch.mapstore.volume_of_interest; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('mageslam_tpu_torch.runtime.')))")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['mageslam_tpu_torch.runtime.devices']"
