"""The paper's DVFS energy model, as numpy copies of ``repro.core``.

Layers:
  hardware     device specs + DVFS frequency/voltage tables (paper Tables 1-2)
               and the H100 SXM record of the card the port runs on
  power_model  P(f) = static(V) + dynamic(f, V) + memory
  perf_model   t(f) with the paper's three regimes (Fig. 6)
  energy       Eqs. (3)-(7): energy, GFLOPS/W, I_ef, sampled-trace energy
  workloads    the FFT plan model (1-D and N-D), the overlap-save /
               FDAS model, the four-stage pulsar-search model and the
               roofline profile of a model step
  dvfs         optimal & mean-optimal frequency search (Table 3)
  scheduler    per-stage clock plans (DVFSScheduler) and the runtime
               clock lock around dispatches (Sec. 5.3)
  realtime     the real-time margin S = t_acquire / t_process (Sec. 2.3)
  calibration  paper-faithful V100/Jetson reproduction
"""
from repro_torch.core.calibration import (CalibrationSummary, calibrate,
                                          full_report, supported_precisions)
from repro_torch.core.dvfs import (MeanOptimal, SweepResult,
                                   energy_per_transform, mean_optimal, sweep)
from repro_torch.core.energy import (OperatingPoint, efficiency_increase,
                                     energy_from_trace, evaluate, fft_flops,
                                     ffts_per_batch)
from repro_torch.core.hardware import (DEVICES, H100_SXM, JETSON_NANO,
                                       TESLA_V100, TITAN_V, DeviceSpec,
                                       get_device)
from repro_torch.core.perf_model import WorkloadProfile, absolute_profile
from repro_torch.core.power_model import PowerModel
from repro_torch.core.realtime import (CostModel, RealTimeBudget,
                                       devices_required, extra_hardware)
from repro_torch.core.scheduler import (DVFSScheduler, PipelineReport,
                                        Stage, StageReport,
                                        predicted_pipeline_i_ef)
from repro_torch.core.workloads import (ConvCase, FFTCase, PulsarCase,
                                        conv_workload, fdas_total_profile,
                                        fdas_workload, fft_workload,
                                        merge_profiles, paper_lengths,
                                        pulsar_search_total_profile,
                                        pulsar_search_workload,
                                        roofline_workload)

__all__ = [k for k in dir() if not k.startswith("_")]
