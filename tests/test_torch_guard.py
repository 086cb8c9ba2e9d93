"""The port stands alone: no module of ``repro_torch`` imports JAX, the
JAX reference package ``repro`` or ``ml_dtypes`` (which the card's
machine lacks; ``models.convert`` imports it inside the one function that
hands bf16 arrays back to the reference); nor do the port's examples and
``chip_smoke.py``."""
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
                 "repro_torch.serving.recovery",
                 "repro_torch.fft.distributed",
                 "repro_torch.runtime.elastic", "repro_torch.configs",
                 "repro_torch.configs.fft_bench", "repro_torch.configs.base",
                 "repro_torch.configs.qwen2_0_5b",
                 "repro_torch.configs.codeqwen1_5_7b",
                 "repro_torch.configs.qwen1_5_4b",
                 "repro_torch.configs.gemma3_12b",
                 "repro_torch.configs.musicgen_medium",
                 "repro_torch.configs.dbrx_132b",
                 "repro_torch.configs.deepseek_v2_lite_16b",
                 "repro_torch.configs.mamba2_370m",
                 "repro_torch.configs.pixtral_12b",
                 "repro_torch.configs.zamba2_1_2b", "repro_torch.models",
                 "repro_torch.models.common", "repro_torch.models.attention",
                 "repro_torch.models.mla", "repro_torch.models.moe",
                 "repro_torch.models.transformer",
                 "repro_torch.models.mamba2", "repro_torch.models.zamba2",
                 "repro_torch.models.api", "repro_torch.models.convert",
                 "repro_torch.launch", "repro_torch.launch.serve",
                 "repro_torch.optim", "repro_torch.optim.adamw",
                 "repro_torch.optim.schedule", "repro_torch.train",
                 "repro_torch.train.step", "repro_torch.train.sharded",
                 "repro_torch.launch.train",
                 "repro_torch.data", "repro_torch.launch.mesh",
                 "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                 "repro_torch.launch.fft_dryrun", "repro_torch.analysis",
                 "repro_torch.analysis.cost",
                 "repro_torch.analysis.roofline"):
        assert name in mods, name
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                    'ml_dtypes'))\n"
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


def test_the_examples_and_the_chip_check_name_no_jax_or_repro():
    """``examples/torch/*.py`` and ``chip_smoke.py`` run on the card's
    machine, which has no JAX."""
    root = os.path.dirname(SRC)
    examples = os.path.join(root, "examples", "torch")
    files = [os.path.join(examples, f) for f in sorted(os.listdir(examples))
             if f.endswith(".py")] + [os.path.join(root, "chip_smoke.py")]
    assert len(files) == 6
    offending = [
        (os.path.relpath(path, root), name)
        for path in files for name in _imported_names(path)
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not offending, offending


def test_only_the_reference_hand_back_names_ml_dtypes():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
             for f in fs if f.endswith(".py")]
    naming = sorted(os.path.relpath(path, PKG) for path in files
                    if "ml_dtypes" in _imported_names(path))
    assert naming == [os.path.join("models", "convert.py")], naming
