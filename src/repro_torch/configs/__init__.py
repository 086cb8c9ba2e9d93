"""The port's configs (the counterpart of ``repro.configs``).  Only the
paper's own FFT workload so far; the model configs and the ``--arch``
registry come with the model zoo."""
from repro_torch.configs.fft_bench import CONFIG, FFTBenchConfig

__all__ = ["CONFIG", "FFTBenchConfig"]
