"""The port stands alone: no module of ``repro_torch`` imports JAX or the
JAX reference package ``repro``."""
import ast
import os
import pkgutil
import subprocess
import sys

import repro_torch

SRC = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
PKG = os.path.join(SRC, "repro_torch")


def _modules() -> list[str]:
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG], prefix="repro_torch.")]


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    for name in ("repro_torch.fft.plan", "repro_torch.core.dvfs",
                 "repro_torch.fft.plan_nd", "repro_torch.fft.multidim",
                 "repro_torch.fft.convolve", "repro_torch.search.fdas",
                 "repro_torch.search.templates", "repro_torch.search.sift",
                 "repro_torch.search.pipeline", "repro_torch.fft.pipeline",
                 "repro_torch.data.synthetic", "repro_torch.core.realtime",
                 "repro_torch.core.scheduler",
                 "repro_torch.kernels.dedisp.ops",
                 "repro_torch.kernels.dedisp.dedisp_kernel",
                 "repro_torch.kernels.harmonic_sum.ops",
                 "repro_torch.kernels.harmonic_sum.harmonic_sum_kernel",
                 "repro_torch.kernels.spectrum.ops",
                 "repro_torch.kernels.spectrum.spectrum_kernel",
                 "repro_torch.core.calibration", "repro_torch.power",
                 "repro_torch.power.sampler", "repro_torch.power.watchdog",
                 "repro_torch.power.telemetry", "repro_torch.power.governor",
                 "repro_torch.power.site", "repro_torch.power.nvml",
                 "repro_torch.tune.cache", "repro_torch.tune.timing",
                 "repro_torch.tune.tuner", "repro_torch.obs.trace",
                 "repro_torch.obs.log", "repro_torch.obs.drift",
                 "repro_torch.data.arrivals", "repro_torch.runtime.fault",
                 "repro_torch.runtime.checkpoint",
                 "repro_torch.runtime.faults",
                 "repro_torch.runtime.journal", "repro_torch.serving.slo",
                 "repro_torch.serving.recovery"):
        assert name in mods, name
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_names(path: str) -> list[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_no_source_file_names_jax_or_repro_in_an_import():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
             for f in fs if f.endswith(".py")]
    assert len(files) > 10
    offending = [
        (os.path.relpath(path, SRC), name)
        for path in files for name in _imported_names(path)
        if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not offending, offending
