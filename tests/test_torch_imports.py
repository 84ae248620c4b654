"""Importing spada_tpu_torch loads no JAX and nothing of the JAX package
``spada_tpu``, and no kernel is built at import.

The test process has JAX and ``spada_tpu`` loaded already (conftest), so the
check runs in a fresh interpreter; a scan of the sources finds an import of
``spada_tpu`` that the modules' import alone would not reach.
"""

import glob
import os
import pkgutil
import re
import subprocess
import sys

import spada_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    names = [m.name for m in pkgutil.walk_packages(
        spada_tpu_torch.__path__, prefix="spada_tpu_torch.")]
    # __main__ runs the CLI when imported
    return sorted(n for n in names if not n.endswith("__main__"))


def test_package_modules_listed():
    mods = _modules()
    for name in ("spada_tpu_torch.ops.engine", "spada_tpu_torch.ops.spgemm",
                 "spada_tpu_torch.ops.element_stream",
                 "spada_tpu_torch.plan.execute", "spada_tpu_torch.cli",
                 "spada_tpu_torch.convert", "spada_tpu_torch.utils.timing",
                 # the host copies
                 "spada_tpu_torch.config", "spada_tpu_torch.sparse.csr",
                 "spada_tpu_torch.sparse.bsr", "spada_tpu_torch.native",
                 "spada_tpu_torch.io.mtx", "spada_tpu_torch.io.workloads",
                 "spada_tpu_torch.models.nn_workloads",
                 "spada_tpu_torch.models.traffic",
                 "spada_tpu_torch.models.sparse_nn",
                 "spada_tpu_torch.plan.groups", "spada_tpu_torch.plan.topo",
                 "spada_tpu_torch.plan.policy",
                 "spada_tpu_torch.plan.estimator",
                 "spada_tpu_torch.plan.densify",
                 "spada_tpu_torch.plan.planner",
                 "spada_tpu_torch.ops.panelplan",
                 "spada_tpu_torch.parallel",
                 "spada_tpu_torch.parallel.partition",
                 "spada_tpu_torch.parallel.scaling",
                 "spada_tpu_torch.parallel.mesh",
                 "spada_tpu_torch.parallel.spgemm",
                 "spada_tpu_torch.parallel.halo",
                 "spada_tpu_torch.parallel.element_dp",
                 "spada_tpu_torch.utils.trace",
                 "spada_tpu_torch.utils.metrics",
                 # the probe tools
                 "spada_tpu_torch.tools.tile_probe",
                 "spada_tpu_torch.tools.probe_kernel",
                 "spada_tpu_torch.tools.probe_manual",
                 "spada_tpu_torch.tools.probe_panel3d",
                 "spada_tpu_torch.tools.probe_pallas_stream",
                 # the planner's calibration and evaluation tools
                 "spada_tpu_torch.tools.harness",
                 "spada_tpu_torch.tools.probe_item_overhead",
                 "spada_tpu_torch.tools.probe_dispatch_crossover",
                 "spada_tpu_torch.tools.eval_adaptive",
                 "spada_tpu_torch.tools.bench_value_refresh"):
        assert name in mods


def test_no_jax_and_no_build_on_import():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from spada_tpu_torch import _build\n"
        "assert _build._lib is None, 'kernel library loaded at import'\n"
        "assert 'triton' not in sys.modules\n"
        "ref = sorted(m for m in sys.modules\n"
        "             if m == 'spada_tpu' or m.startswith('spada_tpu.'))\n"
        "assert not ref, f'modules of spada_tpu loaded: {ref}'\n"
        "print('jax' in sys.modules, 'jaxlib' in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False False"


# ``import spada_tpu``, ``import spada_tpu.x``, ``from spada_tpu import``,
# ``from spada_tpu.x import`` -- not ``spada_tpu_torch``
_REF_IMPORT = re.compile(
    r"^\s*(import\s+spada_tpu(\.|\s|,|$)|from\s+spada_tpu(\.|\s))", re.M)
_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib)(\.|\s|,|$)",
                         re.M)


def test_sources_import_no_reference_and_no_jax():
    files = sorted(glob.glob(os.path.join(ROOT, "spada_tpu_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 30
    for path in files:
        with open(path) as f:
            src = f.read()
        rel = os.path.relpath(path, ROOT)
        assert not _REF_IMPORT.search(src), f"{rel} imports spada_tpu"
        assert not _JAX_IMPORT.search(src), f"{rel} imports JAX"


def test_source_scan_sees_reference_imports():
    for line in ("import spada_tpu", "from spada_tpu.config import X",
                 "    from spada_tpu import native",
                 "import spada_tpu.ops.engine as E"):
        assert _REF_IMPORT.search(line), line
    for line in ("import spada_tpu_torch", "from spada_tpu_torch.io import x",
                 "from spada_tpu_torch import cli", "# spada_tpu.plan"):
        assert not _REF_IMPORT.search(line), line
    assert _JAX_IMPORT.search("import jax.numpy as jnp")
    assert not _JAX_IMPORT.search("import jaxtyping")
