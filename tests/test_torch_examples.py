"""The port's five examples (``examples/torch/*.py``), each ``main`` run in
process with ``--device cpu`` at its own sizes (``train_lm`` at ``--steps
2``).  The quickstart's V100 sweep and mean-optimal lines equal those that
``repro.core`` gives for the same lengths (both packages price in numpy);
the pulsar pipeline finds the injected pulsar's bin and the FDAS stage
its drift.  No reference example runs here: the reference's quickstart
alone takes about a minute."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from _model_parity import one_torch_thread  # noqa: F401
from repro.core import TESLA_V100 as REF_V100
from repro.core import FFTCase as RefCase
from repro.core import fft_workload as ref_workload
from repro.core import mean_optimal as ref_mean_optimal
from repro.core import sweep as ref_sweep

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "torch")


def example(name: str):
    """The example module ``examples/torch/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prices_the_v100_as_the_reference_does(capsys):
    mod = example("quickstart")
    got = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    want = [ref_sweep(ref_workload(RefCase(n=2**logn), REF_V100), REF_V100)
            for logn in mod.LOG_LENGTHS]
    lines = [f"  N=2^{logn:<3} optimal={res.optimal.f:7.1f} MHz "
             f"({100*res.optimal_frequency_frac:5.1f}% of boost)  "
             f"power cut {100*res.power_reduction:4.1f}%  "
             f"slowdown {100*res.slowdown:5.2f}%  "
             f"I_ef {res.i_ef_boost:.2f}"
             for logn, res in zip(mod.LOG_LENGTHS, want)]
    assert [line for line in out if line in lines] == lines
    for a, b in zip(got["sweeps"], want):
        assert (a.optimal.f, a.power_reduction, a.slowdown) == (
            b.optimal.f, b.power_reduction, b.slowdown)
    mo = ref_mean_optimal(want, REF_V100)
    assert (got["mean_optimal"].f_mean, got["mean_optimal"].loss_pp) == (
        mo.f_mean, mo.loss_pp)
    assert (f"  mean optimal clock = {mo.f_mean:.0f} MHz (paper: 945 MHz); "
            f"using it loses {mo.loss_pp:.1f} pp of I_ef") in out
    # each length's batch through the port's plans matched torch.fft
    errors = [float(line.split("max error ")[1].split()[0])
              for line in out if "against torch.fft" in line]
    assert len(errors) == len(mod.LOG_LENGTHS) and max(errors) < 1e-5
    assert got["decode"].power_reduction > 0


def test_serve_fft_serves_both_waves_on_the_cpu(capsys):
    svc = example("serve_fft").main(["--device", "cpu"])
    rep = svc.report()
    assert (rep.n_requests, rep.n_transforms) == (7, 17)
    assert rep.cache.hits >= 1
    assert svc.device_spec.name == "h100-sxm"
    assert "=== service report ===" in capsys.readouterr().out


def test_serve_lm_generates_tokens():
    tokens = example("serve_lm").main(["--device", "cpu"])
    assert np.asarray(tokens).shape == (4, 16)


def test_train_lm_trains_two_steps():
    log = example("train_lm").main(["--steps", "2", "--device", "cpu"])
    assert [m["step"] for m in log] == [0, 1]
    assert all(np.isfinite(float(m["loss"])) for m in log)


def test_pulsar_pipeline_finds_the_injected_pulsar(capsys):
    got = example("pulsar_pipeline").main(["--device", "cpu"])
    assert got["peak_bin"] == 96
    # every series' strongest FDAS candidate: the injected drift and bin
    assert all(rows and rows[0][:2] == (4.0, 700) for rows in got["fdas"])
    assert "composite I_ef" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["quickstart", "serve_fft", "serve_lm",
                                  "train_lm", "pulsar_pipeline"])
def test_an_example_raises_without_a_card_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example(name).main([])
