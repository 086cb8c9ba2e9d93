#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. build every CUDA kernel of the port from ``src/repro_torch/csrc``
     (the seven libraries ``fft_c2c``, ``fft_real``, ``transpose``,
     ``dedisp``, ``harmonic_sum``, ``spectrum`` and ``sift``, one ``nvcc``
     each, in parallel) and check that no instance of the register-pass kernels
     (``fft_c2c``, ``fft_c2c_t``, ``fft_c2c_axis1``, ``fft_r2c``,
     ``fft_c2r``, ``fft_r2c_t``) or of the staged ``dedisperse``,
     ``harmonic_sum_plane`` and ``harmonic_sum`` kernels spills registers
     or keeps a stack frame (each staged instance's registers, stack and
     spills printed);
  2. print the card's name and power limit (``nvidia-smi``);
  3. hold each kernel (the C2C variants: fft_c2c, fft_c2c_t with and
     without twiddle, fft_c2c_axis1 with and without twiddle, forward and
     inverse; fft_r2c, fft_c2r; fft_r2c_split and fft_c2r_merge, the long
     real plans' Hermitian split and merge, at B = 1, 3 and 476, N/2 =
     2**14 and 2**19, rows 16-byte aligned and not; fft_r2c_t, transpose
     and fft_c2c_mul; dedisperse, harmonic_sum_plane, harmonic_sum and
     power_spectrum_stats; sift_select, the sift's pool, exactly torch.topk
     of the plane at or above its floor and the count over the threshold,
     with ties, an all-equal plane, rows at an odd offset and buffers small
     enough to force its refinements) against its plain torch version on
     the card,
     at small, ragged shapes and at the shapes the main paths give it —
     fft_c2c, fft_r2c and fft_c2r at every pow2 length (2..8192,
     4..16384), both radix sets, forward and inverse, two tiles; fft_r2c_t
     at every C (4..16384) on ragged row counts with each cluster size;
     fft_c2c_t and fft_c2c_axis1 at every pow2 length on 37 and 4097
     rows or columns, both radix sets, with and without the twiddle,
     forward and inverse, with each cluster size —
     and time the kernel, the plain version and, where one call computes
     the same function, that PyTorch call (else the nearest torch
     composition); fft_c2c, fft_r2c and fft_c2r over a sweep of 2 GB
     batches, with the blocks one SM holds; the host time of one fft_c2c and fft_r2c call, broken down (the
     Python wrapper, the kernel function, the ctypes call, the C entry)
     beside torch.fft's; fft_r2c_t at the rfft2 pass (16, 4096, 8192),
     fft_c2c_t and fft_c2c_axis1 at (16, 4096, 4096) and (238, 1024, 1024)
     with 1, 4 and 8 rows or columns a cluster; dedisperse,
     harmonic_sum_plane and harmonic_sum bit-identical to their plain
     versions at their tile edges (random tables with delays up to N - 1,
     tables mixing staged and wide channels, the pulsar plan's table; H in
     {1, 2, 8, 32, 64}), power_spectrum_stats within KERNEL_RTOL at B = 1,
     odd N, many short rows and the demo's shape, with the same bits from
     two calls; then a sweep of their tiles (dedisperse's channels a
     stage and the plane's bins a block at the pulsar search's shapes, the
     ladder's bins a block and the spectrum's segments a row at the
     demo's), each with the blocks one SM holds;
  4. drive the main path — ``plan_for_length(n)(x)`` on a 2 GB batch
     (``FFTCase(n).n_fft`` transforms) for n = 1024, 8192, 2**20 and
     19321 = 139**2, then ``plan_for_length(n, "r2c")`` and ``"c2r"`` on
     2 GB real batches for n = 1024, 16384 and 2**20, then the N-D plan
     graphs ``fft2``/``rfft2``/``fftn`` on 2 GB batches — with every
     launch count set to 0 just before each run and read just after;
     check the ledger and the launch counts, compare with ``torch.fft``,
     time it, and price it with the DVFS model;
  5. run ``fdas_search`` on 4 series of 2**22 points with the 85-template
     bank (counts set to 0 just before, read just after): recover the
     injected accelerated tone, hold one row's power plane against a
     direct ``torch.fft`` oracle, check the ledger, and time its stages;
  6. serve two waves of C2C, R2C, rank-2, FDAS and pulsar-search
     requests through ``repro_torch.serving.FFTService`` on the card
     (counts set to 0 before the phase and read after); check every
     result against its own reference, the receipts (the pulsar ones'
     per-stage shares and real-time margin) and the plan/sweep cache;
  7. run ``pulsar_search`` on 2 filterbanks of 1024 channels x 2**17
     samples with 128 DM trials, the 85-template bank and 8 harmonics
     (counts set to 0 just before, read just after): recover the two
     injected pulsars at their exact (DM trial, template, bin) cells, no
     candidate on the control filterbank; check the ledger, hold
     dedisperse and the harmonic-sum plane against their oracles, time
     the search and its stages, and print the measured real-time margin
     beside the V100 model's;
  8. run the Sec. 5.3 demo ``fft.pipeline.pulsar_pipeline`` (C2C and
     R2C) at the reference's Table 4 shape (32 x 2**20, 32 harmonics),
     with its measured FFT share of device time beside the model's; then
     ``power_spectrum_stats_kernel`` and ``harmonic_sum_kernel`` on the
     same spectrum (counts set to 0 just before, read just after), held
     against the demo's plain stages and the zero-padded oracle;
  9. run the paper's experiment on the card (after every other phase, so
     that a clock lock disturbs none): print the supported clock grid
     (NVML), the default application clock and the board power at rest;
     run the main path's C2C 1024 and 8192 and R2C 16384 plans on 2 GB
     batches (counts set to 0 just before, read just after), each back to
     back for 2 s of device time, at 7 clocks of the grid from f_max down
     to about 0.45 f_max and the H100_SXM model's optimum for each case —
     or, where the driver denies the lock (``clock_lock: denied``), at the
     default clocks — under the board's energy counter, with board power
     and the SM clock sampled every 10 ms on a host thread; print, per
     case and clock, the observed SM clock, ms a batch, W, J/transform
     from the counter and from the samples and GFLOPS/W beside the
     H100_SXM model's, and where clocks were locked the measured optimum
     against boost; check the results against ``torch.fft``, that no
     sample failed, that the counter rose and that a locked clock held;
 10. run the autotuner (``repro_torch.tune``) on the card: tune C2C 1024,
     8192 and 2**20, R2C 1024 and 16384 and C2R 16384 at phase 9's 2 GB
     batches (``objective="energy"``, the H100_SXM model) into a cache
     file in a fresh temporary directory; print each key's candidates,
     its survivors with their times (``time_fn``: CUDA events, min of 3
     after 1 warm-up) and launch geometry, the chosen config and its
     speedup over the heuristic; hold every survivor against
     ``torch.fft``, check that no key regresses the heuristic, tune each
     key TUNE_REPEATS more times into fresh caches (how often the choice
     repeats, and the speedups' range), check that a
     fresh load of the saved cache replays every key with 0 measurements
     and the same config, and that ``plan_for_length`` under the tuned
     context launches the chosen per_block with the heuristic's launch
     count (counts set to 0 just before, read just after); print the
     common config and its regret, tune the FDAS segment and run phase 5's
     search under it (the tone still at its cell); where a tuned config
     differs from the heuristic (three keys at most), measure both in
     J/transform with phase 9's energy counter at the default clocks;
 11. the robust service (``FFTService`` with ``slo=``, ``fault_plan=``,
     ``telemetry=``, ``tracer=`` and ``journal=``): (a) phase 6's wave 0
     at full width on two worker slots of the card, with the C2C stream
     two full 2 GB batches submitted last, under a pinned KILL_DEVICE
     (the first C2C batch, retried on the other slot), FAIL_CLOCK_LOCK
     (an R2C batch, rung 1), FAIL_PLAN_BUILD (a rank-2 batch, rung 1) and
     STALL_WORKER (the FDAS batch, redistributed), and an SLO that sends
     the second C2C batch to rung 2, which on the card runs the boost
     heuristic plan's kernels (counts set to 0 just before, read just
     after): every result held to phase 6's tolerance and cells, each
     receipt's rung, retries and reason, kernel launches and ledger
     records on every batch; each batch's service and execute time beside
     its rung, its modelled energy and the NVML energy counter's joules
     over the batch (``NvmlEnergySampler``), the watchdog labels and
     drift; (d) the
     tracer's spans, the flight-recorder snapshot of the injected kill,
     ``metrics_text()`` against ``BENCH_obs.json``'s series, and one
     chaos wave drained with and without a tracer; (b) the reference's
     chaos stream (``benchmarks/run.py``) of 8192 requests on four slots
     of the card twice and its first 1024 on the card and on four CPU
     slots: equal digests, every request receipted, availability 1.0,
     every fault kind the run reached fired, kernels launched on the
     card; (c) crash recovery at the reference harness's rate, period and
     deadline: 16384 requests of the stream in Poisson waves through a
     journal, two
     CRASH_PROCESS arrivals and a KILL_HOST (2 hosts x 2 slots), a
     snapshot after each wave, ``FFTService.recover`` after each crash:
     no lost or duplicated receipt, the journal exactly-once, every
     replayed receipt equal to the live one; the journal's records/s and
     the time to recover;
 12. the distributed FFT on meshes of slots of the card
     (``repro_torch.fft.distributed``; counts set to 0 just before each
     run, read just after): the pencil C2C and R2C at the ``fft_bench``
     config's widths (4096 x 8192 = 2**25 points, batch 8: the config's 64
     cut to the paper's 2 GB batch) on D = 1 and D = 4 slots of cuda:0,
     within PLAN_RTOL of ``torch.fft``, each shard launching
     ``fft_c2c_axis1`` and ``fft_c2c``, the mesh's byte counter equal to
     what the collectives move (and, for C2C, to the reference's
     ``pencil_collective_bytes``), timed beside the 1-D plan at 2**25 and
     ``torch.fft``, with its device time by kernel and in copies and the
     collectives timed alone; ``batch_parallel_fft`` on 4 slots against
     the unsharded plan (C2C 1024 on 244141 rows, R2C 16384 on 30517,
     ``fft2`` (16, 4096, 4096), ``rfft2`` (16, 4096, 8192)); and
     ``FFTService(mesh=...)`` on 4 slots serving phase 6's 16 C2C (4096,
     4096) requests and its (2, 2**22) one, in turns with the unsharded
     service: the same receipts' rungs, clocks and modelled energy,
     results within PLAN_RTOL of ``torch.fft``;
 13. the model zoo on the card (``repro_torch.models``,
     ``repro_torch.launch.serve``; no kernel of the port lies on this
     path, and its launch counts, set to 0 just before and read just
     after, stay 0): qwen2-0.5b served through ``serve.main`` at full
     width and depth in bf16 (batch 8, prompt 512, gen 32,
     ``--dvfs-report``), with prefill and decode times, tokens/s, the
     device idle share and device operations of each, decode's weight
     and KV bytes a step against 3.35 TB/s, prefill's FLOP/s against the
     bf16 peak, J/token of each from the energy counter (phase 9's
     runs), the DVFS model's regime and optimal clock beside them, and
     bf16 against float32 on the same weights; every one of the ten
     architectures at full width in bf16 (depths cut as ZOO_DEPTH says):
     prefill (2, 256) and 4 decode steps, finite, each cache tree equal
     to ``cache_shapes``; decode = forward for five of them, in float32
     and bf16; each family in float32 on the card and on the CPU with
     the same carried weights;
 14. training on the card (``repro_torch.train``, ``repro_torch.optim``,
     ``repro_torch.launch.train``; no kernel of the port lies on this
     path, and its launch counts, set to 0 just before and read just
     after, stay 0): qwen2-0.5b trained through ``launch.train.main`` at
     full width and depth in bf16 (batch 8, seq 128, 30 steps, lr 1e-2,
     a checkpoint every 10 steps, ``--dvfs-report``), its loss falling and
     every loss and grad norm finite, with the step time (the driver's
     synchronised walls; chained), tokens/s, the idle share and device
     operations of one profiled step, peak memory, FLOP/s
     (``FlopCounterMode``) against the bf16 peak, J/step from the energy
     counter and the time to save a checkpoint; ``FaultTolerantDriver``
     with injected failures on the card (each step once, replayed losses
     equal to an uninterrupted run's); mamba2-370m at full width in bf16,
     three steps with finite gradients and the largest masked ``_segsum``
     difference (whether the reference would overflow there); reduced
     qwen2 (3 steps), dbrx and mamba2 (1 step) in float32, card = CPU;
     ``microbatches=2`` against 1 on the card;
 15. the dry run against the card (``repro_torch.launch.dryrun``,
     ``launch.fft_dryrun``, ``analysis``): (a) on the host, qwen2-0.5b
     ``train_4k`` and ``decode_32k`` and the ``fft_bench`` pencil on the
     (32, 8) and (2, 32, 8) meta meshes, each artifact's FLOPs, bytes,
     collectives by kind and axis, fits flag and time, its roofline row
     and DVFS plan on the roofline's H100 record; (b) one data replica's
     share of qwen2-0.5b ``train_4k`` on the (32, 8) mesh (8 x 4096
     tokens) as a bf16 train step on the card: ``FlopCounterMode``'s count
     on the card equal to the dry run's meta count, the step's median
     time and the bf16 peak share of its model FLOPs, the card's peak
     memory beside the dry run's argument bytes on a 1x1 mesh; (c) the
     pencil on 8 ``model`` slots of the card at batch 8 (counts set to 0
     just before, read just after): within PLAN_RTOL of ``torch.fft``,
     each shard launching ``fft_c2c_axis1`` and ``fft_c2c``, the mesh's
     collective bytes equal to the fft dry run's at the same batch;
 16. the sharded train step (``repro_torch.train.sharded``) on data meshes
     of slots of the card: (a) qwen2-0.5b at full width and depth in bf16
     through ``launch.train.main --mesh 4x1`` at phase 14's batch (8 x
     128, 2 x 128 a replica): the step's median, idle share, device
     operations, peak memory and J/step from the energy counter beside
     phase 14's 1x1 numbers, and the mesh's ``--dvfs-report`` lines; (b)
     qwen2-0.5b at full width in float32 (TF32 off), two steps of 8 x 128
     on 4x1 against 1x1 from the same state: loss, grad norm, moments and
     parameters within the CPU tests' tolerances, the largest differences
     printed; (c) the mesh's collective record of one (a) step against
     ``analysis.cost.collective_accounting`` with the executor's stated
     departures (``train.sharded.accounted_record``);
     (d) mamba2-370m at full width in float32, two steps of 2 x 256 on
     2x1 against 1x1, the first-step moments printed; (b) and (d) also
     run the first step in float64, D x 1 held against 1x1; (e) the
     five examples (``examples/torch``) with
     their default arguments on the card, ``train_lm``'s loss falling;
     the launches of (e) counted (set to 0 just before each example, read
     just after), (a)-(d) launching none.  On one card the collectives
     are HBM-to-HBM copies;
 17. tensor and expert parallelism (``train.sharded`` with a ``model``
     axis) on slots of the card (counts set to 0 before, read after, stay
     0): (a) qwen2-0.5b at full width and depth in bf16 through
     ``launch.train.main --mesh 2x2`` at phase 14's 8 x 128 (4 x 128 a
     replica, 2 model slots each), 8 steps: the step's median, idle
     share, device operations, peak memory and J/step beside phase 16's
     4x1 and phase 14's 1x1, and the per-axis ``--dvfs-report`` lines;
     (b) qwen2-0.5b at full width in float32 (TF32 off) on 1x2 and 2x2
     against 1x1 from one state, two steps of 8 x 128, within the CPU
     tests' tolerances, the first step also in float64; (c)
     deepseek-v2-lite-16b at full width cut in depth to its dense layer
     and one MoE layer, 2 x 128 tokens (one group of 256 over the two
     replicas), its first step in float64 on 2x1 and 2x2 held within
     1e-12 of a leaf's largest |value| against 1x1 with one microbatch
     (the sharded step routes the whole batch's groups, as the
     reference's does), the peak memory, and in float32 its differences
     and the (token, k) routes that differ from 1x1's, printed; (d) the
     record of one (a) step equal to ``train.sharded.accounted_record``;
 18. tensor parallelism of the SSM and hybrid families on slots of the
     card (counts set to 0 before, read after, stay 0): (a) mamba2-370m
     at full width and depth in bf16 through ``launch.train.main --mesh
     2x2`` at phase 14's mamba2 batch (4 x 512, two 256-token chunks), 8
     steps: the step's median, idle share, device operations, peak
     memory and J/step beside a 1x1 run of the same batch, and the
     per-axis ``--dvfs-report`` lines; (b) mamba2-370m at full width and
     depth, its first step in float64 on 1x2 and 2x2 held within 1e-12 of
     a leaf's largest |value| against 1x1, its float32 differences
     printed; (c) zamba2-1.2b at full width cut in depth to its 2 head
     layers and one site of 6, the same, and the peak memory; (d) the
     records of one (a) step and of (c)'s float32 steps equal to
     ``train.sharded.accounted_record``;
 19. print the ``kernels`` JSON line, then the final ``{"ok": true, ...}``.

Exits non-zero without printing a result when no CUDA device is present.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT,
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import ARCHS as ZOO_ARCHS  # noqa: E402
from repro_torch.configs import CONFIG as FFT_BENCH  # noqa: E402
from repro_torch.core import (H100_SXM, TESLA_V100, FFTCase,  # noqa: E402
                              energy_from_trace, energy_per_transform,
                              fft_flops, fft_workload, sweep)
from repro_torch.data.arrivals import arrival_times, wave_slices  # noqa: E402
from repro_torch.data.synthetic import FilterbankSpec, InjectedPulsar  # noqa: E402
from repro_torch.fft import multidim  # noqa: E402
from repro_torch.fft import pipeline as demo  # noqa: E402
from repro_torch.fft.convolve import (device_filter_spectra,  # noqa: E402
                                      select_nfft)
from repro_torch.fft.distributed import (Mesh,  # noqa: E402
                                         assemble_rfft_pencil,
                                         batch_parallel_fft, make_mesh,
                                         pencil_collective_bytes,
                                         pencil_exchange_bytes, pencil_fft,
                                         shard, untranspose_ref)
from repro_torch.fft.plan import (fft_mul, plan_for_length,  # noqa: E402
                                  plan_with_config, pow2_fft)
from repro_torch.fft.plan_nd import plan_nd  # noqa: E402
from repro_torch.fft.radix import (DEFAULT_RADICES,  # noqa: E402
                                   mixed_radix_flop_count, r2c_flop_count)
from repro_torch.kernels.common import build_all  # noqa: E402
from repro_torch.kernels.dedisp import dedisp_kernel as D  # noqa: E402
from repro_torch.kernels.dedisp import dedisperse_kernel, dedisperse_ref  # noqa: E402
from repro_torch.kernels.fft import fft_kernel as K  # noqa: E402
from repro_torch.kernels.fft import ops  # noqa: E402
from repro_torch.kernels.harmonic_sum import (harmonic_sum_kernel,  # noqa: E402
                                              harmonic_sum_plane,
                                              harmonic_sum_plane_ref,
                                              harmonic_sum_ref)
from repro_torch.kernels.harmonic_sum.ops import K as H  # noqa: E402
from repro_torch.kernels.spectrum import power_spectrum_stats_kernel  # noqa: E402
from repro_torch.kernels.spectrum import spectrum_kernel as S  # noqa: E402
from repro_torch.kernels.sift import sift_kernel as T  # noqa: E402
from repro_torch.kernels.fft.ref import fft_ref, irfft_ref, rfft_ref  # noqa: E402
from repro_torch.analysis.roofline import (dvfs_plan,  # noqa: E402
                                           model_flops_for,
                                           roofline_from_artifact)
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, fft_dryrun  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import (build_model,  # noqa: E402
                                params_from_reference,
                                params_to_reference)
from repro_torch.models.api import language_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.obs.ledger import LaunchLedger  # noqa: E402
from repro_torch.obs.metrics import latency_summary  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.power import FleetTelemetry, nvml  # noqa: E402
from repro_torch.power.nvml import NvmlEnergySampler  # noqa: E402
from repro_torch.models import mamba2 as mamba2_impl  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.fault import FaultTolerantDriver  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens  # noqa: E402
from repro_torch.train.step import (TrainState,  # noqa: E402
                                    init_train_state, make_train_step,
                                    map_state)
from repro_torch.train.sharded import (accounted_record,  # noqa: E402
                                       gather_state, make_sharded_train_step,
                                       shard_state)
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models import moe as moe_impl  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.runtime.faults import (CRASH_PROCESS,  # noqa: E402
                                        FAIL_CLOCK_LOCK, FAIL_PLAN_BUILD,
                                        FAULT_KINDS, KILL_DEVICE,
                                        STALL_WORKER, FaultEvent, FaultPlan,
                                        HostTopology)
from repro_torch.runtime.journal import RequestJournal, read_journal  # noqa: E402
from repro_torch.search import (DispersionPlan, TemplateBank,  # noqa: E402
                                extract_candidates, fdas_conv_plan,
                                fdas_search, matched_filter_plane,
                                plan_pulsar_stages, power_plane,
                                pulsar_search, serving_candidates,
                                serving_sifted, sift_candidates)
from repro_torch.serving import (KIND_FDAS, KIND_PULSAR, SLO,  # noqa: E402
                                 AdmissionController, FFTRequest,
                                 FFTService, ReplayResult, SLOPolicy,
                                 coalesce, rung_name)
from repro_torch.tune import (TuningCache, TuningContext,  # noqa: E402
                              common_config, get_tuning_context,
                              install_common_default, set_tuning_context,
                              tune_length, tune_segment, use_tuning)
from repro_torch.tune.tuner import _fft_operand, plan_launches  # noqa: E402

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and float32
#: FLOP/s outside the tensor cores (an FMA counts two).  A plain float32
#: add, multiply or compare is one operation a lane a clock: 132 SMs x 128
#: lanes x 1.98 GHz (Hopper has no packed float32 add).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP32_ADDS = 33.5e12

#: Clock cycles of the spin kernel that opens each profile (about 50 ms at
#: the H100's 1.98 GHz boost clock).
SPIN_CYCLES = 100_000_000
#: Kernel vs its plain version on the same inputs: both run the same f32
#: schedule; they differ only by FMA contraction and rounding order.
KERNEL_RTOL = 1e-5
#: Plan vs torch.fft.fft (cuFFT): pow2 plans, and Bluestein with its f32
#: chirp and filter spectrum.
PLAN_RTOL = {"stockham": 2e-5, "four-step": 2e-5, "bluestein": 1e-4}

MAIN_LENGTHS = (1024, 8192, 2**20, 19321)
EXPECTED_LEDGER = {
    1024: {"fft-c2c": 1},
    8192: {"fft-c2c": 1},
    2**20: {"fft-c2c-axis1": 1, "fft-c2c-t": 1},
    19321: {"fft-c2c-axis1": 2, "fft-c2c-t": 2},
}
REAL_LENGTHS = (1024, 16384, 2**20)
FOUR_STEP = {"fft-c2c-axis1": 1, "fft-c2c-t": 1}
#: At 2**20 the packed 2**19-point transform runs the four-step pair (the
#: c2r inverse on its inverse passes) and the split or merge kernel.
REAL_EXPECTED = {
    ("r2c", 1024): {"fft-r2c": 1}, ("r2c", 16384): {"fft-r2c": 1},
    ("r2c", 2**20): {**FOUR_STEP, "fft-r2c-split": 1},
    ("c2r", 1024): {"fft-c2r": 1}, ("c2r", 16384): {"fft-c2r": 1},
    ("c2r", 2**20): {**FOUR_STEP, "fft-c2r-merge": 1},
}
#: N-D plans at 2 GB a batch: (label, function, input shape, complex input,
#: ledger counts, rtol against torch.fft).  The last is the paper's
#: Bluestein length on the last axis of a 2-D transform.
ND_CASES = (
    ("fft2 (16, 4096, 4096)", "fft2", (16, 4096, 4096), True,
     {"fft-c2c-t": 2}, 2e-5),
    ("rfft2 (16, 4096, 8192)", "rfft2", (16, 4096, 8192), False,
     {"fft-r2c-t": 1, "fft-c2c-t": 1}, 2e-5),
    ("fftn (2, 512, 512, 512)", "fftn", (2, 512, 512, 512), True,
     {"fft-c2c-t": 3}, 2e-5),
    ("fft2 (13, 1024, 19321)", "fft2", (13, 1024, 19321), True,
     {"fft-c2c-axis1": 2, "fft-c2c-t": 3, "transpose": 1}, 1e-4),
)
#: FDAS phase: 4 series of 2**22 points, the linear bank over z in
#: [-42, 42] (85 templates of 100 taps), one tone injected in row 0 as
#: benchmarks/run.py injects it at n = 8192 (amplitude 0.25 in noise of
#: 0.5), its start bin scaled to n, its drift (6 bins) kept in the bank.
FDAS_ROWS = 4
FDAS_N = 2**22
FDAS_ZMAX = 42
FDAS_K0 = 1200 * FDAS_N // 8192
FDAS_Z = 6.0
FDAS_RTOL = 1e-4
FDAS_LEDGER = {"fft-c2c-axis1": 1, "fft-c2c-t": 1, "fft-r2c-split": 1,
               "fft-c2c-mul": 1, "fft-c2c": 1}
LEDGER_TO_KERNEL = {"fft-c2c": "fft_c2c", "fft-c2c-t": "fft_c2c_t",
                    "fft-c2c-axis1": "fft_c2c_axis1", "fft-r2c": "fft_r2c",
                    "fft-c2r": "fft_c2r", "fft-r2c-t": "fft_r2c_t",
                    "fft-r2c-split": "fft_r2c_split",
                    "fft-c2r-merge": "fft_c2r_merge",
                    "transpose": "transpose", "fft-c2c-mul": "fft_c2c_mul",
                    "dedisperse": "dedisperse",
                    "harmonic-sum-plane": "harmonic_sum_plane",
                    "harmonic-sum": "harmonic_sum",
                    "power-spectrum-stats": "power_spectrum_stats",
                    "sift-select": "sift_select"}
#: The CUDA kernels' names; each is the prefix of its __global__ function
#: (``<name>_kernel``, ``<name>_regs_kernel<P, F>`` for the register-pass
#: kernels), which names it in profiler traces; no symbol is a substring
#: of another's (phase 1 checks).
KERNELS = ("fft_c2c", "fft_c2c_t", "fft_c2c_axis1", "fft_r2c", "fft_c2r",
           "fft_r2c_split", "fft_c2r_merge", "fft_r2c_t", "transpose", "fft_c2c_mul", "dedisperse",
           "harmonic_sum_plane", "harmonic_sum", "power_spectrum_stats",
           "sift_select")
#: Kernels run as several __global__ functions, named by the prefix they
#: share (sift_first_kernel, sift_scan_kernel, sift_refine_kernel,
#: sift_compact_kernel).
SYMBOL_PREFIXES = {"sift_select": "sift_"}
#: The staged kernels and their compiled instances, by library:
#: dedisperse_kernel (one), harmonic_sum_plane_kernel<bins a thread> and
#: harmonic_sum_kernel<bins a thread> (the ladder on the same body).
STAGED_KERNELS = (("dedisp", "dedisperse_kernel", 1),
                  ("harmonic_sum", "harmonic_sum_plane_kernel",
                   len(H.PLANE_BINS)),
                  ("harmonic_sum", "harmonic_sum_kernel", len(H.PLANE_BINS)))
#: Their tile sweeps: dedisperse's channels a stage (a run-time argument)
#: and harmonic_sum_plane's bins a block at the pulsar search's shapes,
#: the ladder's bins a block at the demo's.
DEDISP_SWEEP = (8, 16, 32)
PLANE_SWEEP = H.PLANE_BINS
#: power_spectrum_stats's segments a row swept at the demo's shape (a
#: run-time argument; the wrapper's own count is timed beside them), and
#: the shapes of its check: B = 1, one bin, odd N, many short rows.
SPECTRUM_SWEEP = (1, 8, 16, 24, 50, 99, 198, 396)
SPECTRUM_SHAPES = ((1, 1), (7, 1025), (1000, 64), (3, 2**20), (1, 2**20),
                   (3, 1025), (4096, 1025), (32, 2**20))
#: The register-pass kernels (csrc/stockham_regs.cuh) and their symbols.
PASS_KERNELS = {"fft_c2c": "fft_c2c_regs_kernel",
                "fft_c2c_t": "fft_c2c_t_regs_kernel",
                "fft_c2c_axis1": "fft_c2c_axis1_regs_kernel",
                "fft_r2c": "fft_r2c_regs_kernel",
                "fft_c2r": "fft_c2r_regs_kernel",
                "fft_r2c_t": "fft_r2c_t_regs_kernel"}
#: Phase 3 holds them against their plain versions at every pow2 length,
#: both radix sets, forward and inverse (C2C), and times 2 GB batches.
PASS_C2C_LENGTHS = tuple(2**k for k in range(1, 14))
PASS_R2C_LENGTHS = tuple(2**k for k in range(2, 15))
PASS_RADICES = ((4, 2), (8, 4, 2))
PASS_BATCH = 37                  # ragged against every block size
SWEEP_C2C = (256, 1024, 2048, 4096, 8192)
SWEEP_R2C = (1024, 4096, 16384)
#: The host-time breakdown: (kernel, length) at 2 GB batches, and the
#: calls timed of each step.
HOST_GAP_CASES = (("fft_c2c", 1024), ("fft_c2c", 8192), ("fft_r2c", 1024),
                  ("fft_r2c", 16384))
HOST_GAP_CALLS = 30
#: fft_r2c_t: the ragged row counts of its every-length check, and the
#: rfft2 pass where its cluster size is swept.
R2C_T_RAGGED_ROWS = (7, 13, 4097)
R2C_T_SHAPE = (16, 4096, 8192)
#: fft_c2c_t and fft_c2c_axis1: the ragged row or column counts of their
#: every-length check, and the passes where their cluster size is swept:
#: the fft2 pass, the rfft2 second pass (4097 rows: runs not aligned to
#: 32-byte sectors), the 2**20 four-step pass.
C2C_STRIDED_COUNTS = (37, 4097)
C2C_SWEEP = (("fft_c2c_t", (16, 4096, 4096)), ("fft_c2c_t", (16, 4097, 4096)),
             ("fft_c2c_t", (FFTCase(2**20).n_fft, 1024, 1024)),
             ("fft_c2c_axis1", (16, 4096, 4096)),
             ("fft_c2c_axis1", (FFTCase(2**20).n_fft, 1024, 1024)))
#: The modules whose ``LAUNCHES`` count the kernels' launches.
COUNTERS = (K, D, H, S, T)
SOURCES = {
    "fft_c2c": "src/repro_torch/csrc/fft_c2c.cu",
    "fft_c2c_t": "src/repro_torch/csrc/fft_c2c.cu",
    "fft_c2c_axis1": "src/repro_torch/csrc/fft_c2c.cu",
    "fft_r2c": "src/repro_torch/csrc/fft_real.cu",
    "fft_c2r": "src/repro_torch/csrc/fft_real.cu",
    "fft_r2c_split": "src/repro_torch/csrc/fft_real.cu",
    "fft_c2r_merge": "src/repro_torch/csrc/fft_real.cu",
    "fft_r2c_t": "src/repro_torch/csrc/fft_real.cu",
    "transpose": "src/repro_torch/csrc/transpose.cu",
    "fft_c2c_mul": "src/repro_torch/csrc/fft_c2c.cu",
    "dedisperse": "src/repro_torch/csrc/dedisp.cu",
    "harmonic_sum_plane": "src/repro_torch/csrc/harmonic_sum.cu",
    "harmonic_sum": "src/repro_torch/csrc/harmonic_sum.cu",
    "power_spectrum_stats": "src/repro_torch/csrc/spectrum.cu",
    "sift_select": "src/repro_torch/csrc/sift.cu",
}
REPLACES = {
    "fft_c2c": "src/repro/kernels/fft/fft_kernel.py:360",
    "fft_c2c_t": "src/repro/kernels/fft/fft_kernel.py:413",
    "fft_c2c_axis1": "src/repro/kernels/fft/fft_kernel.py:515",
    "fft_r2c": "src/repro/kernels/fft/fft_kernel.py:386",
    "fft_c2r": "src/repro/kernels/fft/fft_kernel.py:606",
    # No Pallas kernel: the reference splits and merges in jnp ops.
    "fft_r2c_split": "none: jnp ops (src/repro/fft/stockham.py:109)",
    "fft_c2r_merge": "none: jnp ops (src/repro/fft/stockham.py:118)",
    "fft_r2c_t": "src/repro/kernels/fft/fft_kernel.py:547",
    "transpose": "src/repro/kernels/fft/fft_kernel.py:577",
    "fft_c2c_mul": "src/repro/kernels/fft/fft_kernel.py:243",
    "dedisperse": "src/repro/kernels/dedisp/dedisp_kernel.py:57",
    "harmonic_sum_plane":
        "src/repro/kernels/harmonic_sum/harmonic_sum_kernel.py:84",
    "harmonic_sum":
        "src/repro/kernels/harmonic_sum/harmonic_sum_kernel.py:108",
    "power_spectrum_stats": "src/repro/kernels/spectrum/spectrum_kernel.py:32",
    # No Pallas kernel: the reference pools with one lax.top_k.
    "sift_select": "none: lax.top_k (src/repro/search/sift.py:97)",
}
#: The split and merge kernels: rows and half lengths N/2 of their check
#: (2**14 is the shortest half length on the long route), and the shape
#: where they are timed, the 2**20 real plans' 2 GB batch.
HERMITIAN_ROWS = (1, 3)
HERMITIAN_HALVES = (2**14, 2**19)
HERMITIAN_SHAPE = (FFTCase(2**20, transform="r2c").n_fft, 2**19)
#: Serving phase: each wave submits 16 requests per stream, (4096, 4096)
#: complex64 and (8192, 4096) float32, about 2.1 GB of each, just over the
#: 2 GB batch budget, so each stream coalesces into two batches.  Request i
#: is one seeded payload rolled by i rows, so that every request's result
#: differs and a result handed to the wrong request fails its check.  Each
#: wave also submits SERVE_2D rank-2 requests of (8, 2048, 2048) complex64
#: (rolled the same way; 2.1 GB, two batches) and SERVE_FDAS FDAS requests
#: of one 2**20-point series each (85 templates), each with its own tone.
#: Wave 0 adds one 1-D request of 2**22 points, the 2-D key's total, which
#: must be a cache entry of its own.
SERVE_REQUESTS = 16
SERVE_2D = 8
SERVE_FDAS = 4
SERVE_FDAS_N = 2**20
SERVE_WAVES = 2
SEED = 0
#: Pulsar phase: 2 filterbanks of 1024 channels x 2**17 samples (the
#: FilterbankSpec default band, 1300-1500 MHz, and sampling, 64 us: 8.389 s
#: of sky each), 128 DM trials (largest delay 508 samples), the 85-template
#: bank, 8 harmonics, and the reference's threshold (25), pool (64) and
#: max_candidates (16).  Filterbank 0 carries two pulsars of amplitude
#: 0.002 a channel in unit noise (the reference benchmark's normalised
#: power: 0.12 at 16 x 2048); filterbank 1 is the no-signal control.
PULSAR_SPEC = FilterbankSpec(nchan=1024, ntime=2**17)
PULSAR_TRIALS = 128
PULSAR_HARMONICS = 8
PULSAR_AMP = 0.002
#: (DM trial, drift z in bins, start bin): templates 48 and 30 of the bank.
PULSARS = ((37, 6.0, 20000), (90, -12.0, 41000))
PULSAR_CELLS = {(37, 48, 20000), (90, 30, 41000)}
#: The pulsar stages that are one kernel launch each.
ONE_KERNEL_STAGE = {"dedisperse": "dedisp",
                    "harmonic_sum_plane": "harmonic sum"}
#: Noise draws of the small-geometry recovery count in phase 7.
RIDGE_SEEDS = 64
PULSAR_LEDGER = {"dedisperse": 1, "fft-c2c-axis1": 1, "fft-c2c-t": 1,
                 "fft-r2c-split": 1, "fft-c2c-mul": 1, "fft-c2c": 1,
                 "harmonic-sum-plane": 1, "sift-select": 1}
#: The Sec. 5.3 demo at the reference's Table 4 shape (benchmarks/run.py).
DEMO_SHAPE = demo.PipelineShape(batch=32, n=2**20, n_harmonics=32)
#: Phase 9, the paper's experiment on the card: the main path's cases
#: (transform, n), each on a 2 GB batch of FFTCase(n).n_fft transforms.
ENERGY_CASES = (("c2c", 1024), ("c2c", 8192), ("r2c", 16384))
#: Clocks phase 9 locks where the driver allows it: this many on the card's
#: grid from f_max down to about ENERGY_LOW_FRAC of it, plus each case's
#: optimum on the H100_SXM model.
ENERGY_CLOCKS = 7
ENERGY_LOW_FRAC = 0.45
#: Device time of one measurement, after ENERGY_WARM_S of the same runs
#: (the board's power reading is a windowed average that must settle).
ENERGY_RUN_S = 2.0
ENERGY_WARM_S = 1.0
#: Idle seconds before the board power at rest is read.  With the
#: process's CUDA context up the card keeps its SM clock at f_max while
#: idle (32 s measured), so this reads the idle power at f_max.
ENERGY_SETTLE_S = 5.0
#: Power, clock and counter sampling period (the paper's Fig. 19: 10 ms).
SAMPLE_S = 0.01
#: Phase 10: the keys the autotuner tunes on the card (each at phase 9's
#: 2 GB batch), the tolerance every survivor is held to against torch.fft
#: (the pow2 plans'), and the most keys whose tuned and heuristic configs
#: are priced in J/transform by the energy counter.
TUNE_KEYS = (("c2c", 1024), ("c2c", 8192), ("c2c", 2**20), ("r2c", 1024),
             ("r2c", 16384), ("c2r", 16384))
TUNE_RTOL = PLAN_RTOL["stockham"]
TUNE_ENERGY_KEYS = 3
#: Times phase 10 tunes each key again, into fresh caches, to show how
#: often the tuner's choice repeats.
TUNE_REPEATS = 5
#: Phase 12, the distributed FFT: the pencil at the fft_bench config's
#: widths (n1 x n2 = 4096 x 8192, 2**25 points) on meshes of D slots of
#: cuda:0.  The config's pencil_batch (64) is 17 GB a complex64 copy, and
#: the pencil holds about four copies at D = 4: cut to the paper's 2 GB
#: batch (Sec. 4), 8 transforms.
PENCIL_N1 = FFT_BENCH.pencil_n1
PENCIL_N2 = FFT_BENCH.pencil_n2
PENCIL_BATCH = 8
PENCIL_MESHES = (1, 4)
#: Slots of cuda:0 on the data axis of the batch-parallel and serving runs.
MESH_SLOTS = 4
#: Profiled runs of each pencil; its breakdown is the most complete one.
PROFILE_TRIES = 3
#: Batch-parallel runs at phase 4's 2 GB batches: (label, shape, kind, each
#: shard's launches).  C2C has one row more than phase 4's, so that the
#: padding runs; R2C's 30517 rows are ragged over 4; the rank-3 batches
#: run the N-D plan graph.
BATCH_PARALLEL = (
    ("c2c 1024", (FFTCase(1024).n_fft + 1, 1024), "c2c", {"fft_c2c": 1}),
    ("r2c 16384", (FFTCase(16384, transform="r2c").n_fft, 16384), "r2c",
     {"fft_r2c": 1}),
    ("fft2 (16, 4096, 4096)", (16, 4096, 4096), "c2c", {"fft_c2c_t": 2}),
    ("rfft2 (16, 4096, 8192)", (16, 4096, 8192), "r2c",
     {"fft_r2c_t": 1, "fft_c2c_t": 1}),
)
#: Phase 13, the model zoo on the card (no kernel of the port on its
#: path).  The served cell: (arch, batch, prompt length, tokens generated),
#: bf16 at full width and depth, through ``repro_torch.launch.serve``.
ZOO_SERVE = ("qwen2-0.5b", 8, 512, 32)
#: NVIDIA's published dense bf16 tensor-core rate of the H100 SXM.
BF16_FLOPS = 989e12
#: Every architecture at full width, bf16: prefill ZOO_BATCH x ZOO_PROMPT,
#: then ZOO_DECODE_STEPS decode steps.  Depth: None is the config's; the
#: others are cut (dbrx at 2 layers holds about 15 GB of bf16 weights):
#: deepseek 1 dense + 2 MoE layers, gemma3 one 5:1 group of 6.
ZOO_BATCH, ZOO_PROMPT, ZOO_DECODE_STEPS = 2, 256, 4
ZOO_DEPTH = {"qwen2-0.5b": None, "codeqwen1.5-7b": 2, "qwen1.5-4b": 2,
             "gemma3-12b": 6, "musicgen-medium": None, "dbrx-132b": 2,
             "deepseek-v2-lite-16b": 3, "mamba2-370m": None,
             "pixtral-12b": 2, "zamba2-1.2b": None}
#: Decode = forward: prefill ZOO_DEC_SEQ - 1 tokens, grow the cache by one
#: slot, decode the last token, and hold it against ``forward`` at that
#: position, in float32 (TF32 off) within the reference test's 2e-2 of
#: max |logit| (tests/test_models_smoke.py), and in bf16 within the larger
#: of 2e-2 and bf16 forward's own distance from float32 forward on the same
#: weights there: the deep SSMs' bf16 arithmetic amplifies rounding (their
#: bf16 forward lies 0.17-0.22 of max |logit| from their float32 forward
#: on the card), so two bf16 paths cannot agree within 2e-2.  deepseek
#: runs at a capacity factor that drops no token: under capacity
#: ``forward`` may drop the last token's (token, expert) pairs, which a
#: one-token decode group keeps (its config's factor is printed beside).
ZOO_CONSISTENCY = ("qwen2-0.5b", "mamba2-370m", "zamba2-1.2b",
                   "deepseek-v2-lite-16b", "gemma3-12b")
ZOO_DEC_SEQ = 64
ZOO_DEC_RTOL = 2e-2
#: Card = CPU: each family at full width and its smallest valid layout
#: (layers; zamba2's 6 are one site), float32 with TF32 off, batch 1,
#: prompt 32, the same carried weights on cuda:0 and on the CPU.
ZOO_CPU = {"qwen2-0.5b": 2, "gemma3-12b": 6, "musicgen-medium": 2,
           "pixtral-12b": 2, "deepseek-v2-lite-16b": 2, "mamba2-370m": 2,
           "zamba2-1.2b": 6}
ZOO_CPU_PROMPT = 32
ZOO_CPU_RTOL = 1e-4
#: Phase 14, training on the card (no kernel of the port on its path):
#: qwen2-0.5b at full width and depth in bf16 through
#: ``repro_torch.launch.train`` (the cosine schedule's warm-up is 100
#: steps, so the lr runs from 0 at step 0 to 2.9e-3 at step 29).
TRAIN_ARGS = ["--arch", "qwen2-0.5b", "--batch", "8", "--seq", "128",
              "--steps", "30", "--lr", "1e-2", "--ckpt-every", "10"]
#: Steps timed back to back, and the steps each mean of the loss check
#: takes at either end of the run.
TRAIN_CHAINED = 20
TRAIN_ENDS = 5
#: The restart check: a reduced qwen2 (float32) for TRAIN_RESTART_STEPS,
#: failing at the steps given, checkpointed every 5, against an
#: uninterrupted run; replayed losses within the reference test's 1e-4.
TRAIN_RESTART_STEPS = 20
TRAIN_FAIL_AT = {7: 0, 13: 1}
TRAIN_RESTART_RTOL = 1e-4
#: Phase 15, the dry run against the card: the cells run on the host (on
#: both production meshes), the architecture whose step runs on the card
#: at one data replica's share of ``train_4k``, the timed steps, and the
#: pencil's model slots and batch.
DRY_CELLS = ("train_4k", "decode_32k")
DRY_ARCH = "qwen2-0.5b"
DRY_STEPS = 3
DRY_TOP = 6
DRY_PENCIL_SLOTS = 8
DRY_PENCIL_BATCH = 8
#: mamba2-370m at full width in bf16: TRAIN_SSM_STEPS steps on (batch,
#: seq) batches long enough for two of its 256-token chunks.
TRAIN_SSM = (4, 512)
TRAIN_SSM_STEPS = 3
#: Card = CPU in float32 (TF32 off): steps of each reduced model, held
#: within TRAIN_CPU_RTOL of the largest |value|; ``microbatches=2`` against
#: 1 on the card within the reference test's tolerance.
TRAIN_CPU = {"qwen2-0.5b": 3, "dbrx-132b": 1, "mamba2-370m": 1}
TRAIN_CPU_RTOL = 1e-5
TRAIN_MB_RTOL, TRAIN_MB_ATOL = 2e-2, 2e-3
#: Phase 14's 1x1 numbers, which phase 16 prints beside its 4x1 ones.
PHASE14: dict[str, float] = {}
#: Phase 16, the sharded step on slots of the card: qwen2-0.5b bf16
#: through ``launch.train`` on 4x1 at phase 14's batch (SHARD_STEPS
#: driver steps, SHARD_CHAINED timed back to back); the float32 equality
#: cases (part, arch, data slots, batch, seq, whether the first step's
#: moments are held against the plain 1x1 step), two steps each, held
#: within the CPU tests' tolerances (``tests/_model_parity.py``: the loss
#: 1e-5 relative, the first step's moments and the grad norm 1e-4 of the
#: largest |value|, the parameters and moments after two steps rtol 2e-2,
#: atol 2e-3); the five examples of (e).  mamba2-370m's float32
#: first-step moments against plain 1x1 are printed, and its first step
#: is held in float64 instead (``_shard_equal``).
SHARD_MESH = "4x1"
SHARD_STEPS = 8
SHARD_CHAINED = 5
SHARD_ENERGY_STEPS = 4
SHARD_EQUAL = (("b", "qwen2-0.5b", 4, 8, 128, True),
               ("d", "mamba2-370m", 2, 2, 256, False))
SHARD_LOSS_RTOL = 1e-5
SHARD_RTOL = 1e-4
SHARD_STEP_RTOL, SHARD_STEP_ATOL = 2e-2, 2e-3
EXAMPLES = ("quickstart", "serve_fft", "serve_lm", "train_lm",
            "pulsar_pipeline")
#: Phase 16's 4x1 numbers, which phase 17 prints beside its 2x2 ones.
PHASE16: dict[str, float] = {}
#: Phase 17, tensor and expert parallelism on slots of the card:
#: qwen2-0.5b bf16 through ``launch.train`` on TP_MESH at phase 14's
#: batch (TP_STEPS driver steps, SHARD_CHAINED timed back to back); the
#: float32 equality meshes of qwen2-0.5b at 8 x 128 (two steps each,
#: the first also in float64, within the CPU tests' tolerances, SHARD_*);
#: deepseek-v2-lite-16b at full width cut in depth to TP_MOE_LAYERS (its
#: one dense layer and one MoE layer: 1.085e9 parameters, 8.7 GB a copy in
#: float64) on TP_MOE_MESHES at TP_MOE_BATCH x TP_MOE_SEQ tokens, one
#: group of 256 that spans the two data replicas, its first step in
#: float64 held within F64_RTOL of a leaf's largest |value| against 1x1,
#: its float32 differences and differing (token, k) routes printed.
TP_MESH = "2x2"
TP_STEPS = 8
TP_EQUAL = ((1, 2), (2, 2))
TP_MOE = "deepseek-v2-lite-16b"
TP_MOE_LAYERS = 2
TP_MOE_MESHES = ((2, 1), (2, 2))
TP_MOE_BATCH, TP_MOE_SEQ = 2, 128
F64_RTOL = 1e-12
#: Phase 18, tensor parallelism of the SSM and hybrid families on slots of
#: the card: mamba2-370m bf16 through ``launch.train`` on TP_MESH at
#: TRAIN_SSM (TP_STEPS driver steps) beside 1x1 at the same batch
#: (SSM_ONE_STEPS); mamba2-370m at full width and depth and zamba2-1.2b at
#: full width cut to SSM_HYBRID_LAYERS (its 2 head layers and one site of
#: 6), their first steps in float64 on SSM_MESHES held within F64_RTOL
#: against 1x1 at SSM_BATCH x SSM_SEQ, the float32 differences printed,
#: zamba2's float32 records held against ``accounted_record``.
SSM_ONE_STEPS = 4
SSM_MESHES = ((1, 2), (2, 2))
SSM_HYBRID_LAYERS = 8
SSM_BATCH, SSM_SEQ = 2, 256


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for module in COUNTERS:
        module.reset_launches()


def launch_counts() -> dict[str, int]:
    """Every kernel's launches since the last :func:`reset_launches`."""
    return {k: v for module in COUNTERS for k, v in module.LAUNCHES.items()}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, max |a - b| / max |b|)."""
    diff = (a - b).abs().max().item()
    return diff, diff / max(b.abs().max().item(), 1e-30)


def median_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` runs, each timed with CUDA events, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def queued_ms(fn, reps: int = 10) -> float:
    """Mean time of ``reps`` runs launched back to back between one pair
    of CUDA events, after one warm-up run: the host enqueues the next run
    while the card executes, so its own time per run drops out once a run
    takes longer than the host needs to launch it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def randn(gen: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.randn(*shape, dtype=torch.complex64, device="cuda",
                       generator=gen)


def bound(nbytes: float, flops: float, adds: float = 0.0
          ) -> tuple[float, str]:
    """Least time [ms] the card could take, and what bounds it: ``flops``
    at the FMA rate (FP32_FLOPS), ``adds`` (plain float32 adds, multiplies
    and compares) at FP32_ADDS."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / FP32_FLOPS + adds / FP32_ADDS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_breakdown(fn, copies: bool = False) -> dict[str, float]:
    """Device time [ms] of one profiled run of ``fn``, by kernel: the
    port's kernels by name, every other (torch) kernel summed — with
    ``copies``, the copy kernels and device-to-device copies apart.

    Late in a long run the profiler can lose the kernels that start in the
    first milliseconds of a session (a fresh process records them), so a
    spin kernel first keeps the card busy for about 50 ms; it is left out
    of the sums."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.events():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or "spin_kernel" in ev.name):
            continue
        name = next((k for k in KERNELS if _symbol(k) in ev.name), None)
        if name is None:
            name = ("copies" if copies and "copy" in ev.name.lower()
                    else "torch (other kernels)")
        out[name] = out.get(name, 0.0) + ev.device_time / 1e3
    return out


def device_ms(fn, kernel: str, calls: int = 10) -> float:
    """Device time [ms] of ``kernel`` a call, over ``calls`` calls of ``fn``
    in one profiled run (after one warm-up call)."""
    fn()
    return device_breakdown(
        lambda: [fn() for _ in range(calls)])[kernel] / calls


def _symbol(kernel: str) -> str:
    """The __global__ function name of ``kernel`` (the prefix of its
    functions' names where it runs as several)."""
    return SYMBOL_PREFIXES.get(kernel) or PASS_KERNELS.get(
        kernel, f"{kernel}_kernel")


def phase1_build() -> None:
    t0 = time.perf_counter()
    libs = build_all()
    dt = time.perf_counter() - t0
    print(f"phase 1: built {len(libs)} kernel libraries in {dt:.2f} s")
    for stem, path in libs.items():
        log = path.with_suffix(".so.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {stem}: {line.strip()}")
    symbols = [_symbol(k) for k in KERNELS]
    check(not any(a != b and a in b for a in symbols for b in symbols),
          f"a kernel symbol is a substring of another's: {symbols}")
    spills: dict[str, int] = {}
    for stem in ("fft_c2c", "fft_real"):
        spills.update(_pass_kernel_spills(libs[stem].with_suffix(".so.log")))
    check(not any(spills.values()),
          f"register-pass kernels spill: "
          f"{ {k: v for k, v in spills.items() if v} }")
    for kernel, sym in PASS_KERNELS.items():
        found = sum(sym + "I" in name for name in spills)
        check(found == len(K.PASS_SHAPES), f"{found} instances of {sym} in "
              f"the ptxas logs, not {len(K.PASS_SHAPES)}")
        print(f"  {kernel}: {found} instances (points, family) "
              f"{sorted(K.PASS_SHAPES)}, none spills")
    for stem, sym, count in STAGED_KERNELS:
        log = libs[stem].with_suffix(".so.log")
        staged = _pass_kernel_spills(log, (sym,))
        regs, stack = _registers(log)
        for name, spilled in sorted(staged.items()):
            print(f"  {name}: {regs.get(name)} registers, {stack.get(name)} "
                  f"bytes stack frame, {spilled} bytes spill stores")
        check(len(staged) == count, f"{len(staged)} instances of {sym} in "
              f"the ptxas log, not {count}")
        check(not any(staged.values()), f"{sym} spills: "
              f"{ {k: v for k, v in staged.items() if v} }")
        check(not any(stack.get(name) for name in staged), f"{sym} keeps a "
              f"stack frame (local memory): {stack}")


def _pass_kernel_spills(log, symbols=PASS_KERNELS.values()
                        ) -> dict[str, int]:
    """Spill-store bytes of each instance of the kernels ``symbols`` (the
    register-pass kernels by default) in an ``nvcc -Xptxas -v`` log, by
    mangled name."""
    out: dict[str, int] = {}
    name = None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif (name and "spill stores" in line
              and any(sym in name for sym in symbols)):
            out[name] = int(line.split("bytes spill stores")[0]
                            .split(",")[-1])
    return out


def _registers(log) -> tuple[dict[str, int], dict[str, int]]:
    """Registers and stack-frame bytes of each kernel in an ``nvcc -Xptxas
    -v`` log, by mangled name."""
    regs: dict[str, int] = {}
    stack: dict[str, int] = {}
    name = None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "Used" in line and "registers" in line:
            regs[name] = int(line.split("Used")[1].split("registers")[0])
        elif name and "bytes stack frame" in line and name not in stack:
            stack[name] = int(line.split("bytes stack frame")[0].split()[-1])
    return regs, stack


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase2_card() -> str:
    line = _card()
    print(line)
    return line


#: Each kernel's wrapper (what the plans call) and its plain version.
FNS = {"fft_c2c": (ops.fft_kernel_c2c, K.fft_c2c_plain),
       "fft_c2c_t": (ops.fft_kernel_c2c_t, K.fft_c2c_t_plain),
       "fft_c2c_axis1": (ops.fft_kernel_c2c_axis1, K.fft_c2c_axis1_plain)}


# Each variant: (kernel name, kernel wrapper, plain fn, input shape for a
# transform length n, twiddle shape or None).
def _variants(n: int, b: int, other: int):
    return [
        ("fft_c2c", *FNS["fft_c2c"], (b, n), None),
        ("fft_c2c_t", *FNS["fft_c2c_t"], (b, other, n), None),
        ("fft_c2c_t", *FNS["fft_c2c_t"], (b, other, n), (other, n)),
        ("fft_c2c_axis1", *FNS["fft_c2c_axis1"], (b, n, other), None),
        ("fft_c2c_axis1", *FNS["fft_c2c_axis1"], (b, n, other), (other, n)),
    ]


def _call(fn, x, tw, inverse):
    if tw is None:
        return fn(x, inverse=inverse)
    return fn(x, twiddle=tw, inverse=inverse)


def phase3_kernels(gen: torch.Generator) -> dict[str, dict]:
    """Kernel vs plain on the card; returns per-kernel measurements at
    the main path's shapes."""
    worst = 0.0
    checked = 0
    # Small and medium shapes: ragged batches and block edges.
    for n in (64, 1024, 8192):
        for name, fn, plain, shape, tw_shape in _variants(n, 1001 if n < 8192
                                                          else 37, 37):
            if name != "fft_c2c":
                shape = (3,) + shape[1:]
            x = randn(gen, *shape)
            tw = randn(gen, *tw_shape) if tw_shape else None
            for inverse in (False, True):
                _, rel = rel_err(_call(fn, x, tw, inverse),
                                 _call(plain, x, tw, inverse))
                check(rel <= KERNEL_RTOL,
                      f"{name} n={n} shape={shape} twiddle={tw_shape} "
                      f"inverse={inverse}: rel err {rel:.3e}")
                worst = max(worst, rel)
                checked += 1
    for name, fn, plain, shape, tw_shape in _variants(1024, 4, 1024)[1:]:
        x = randn(gen, *shape)
        tw = randn(gen, *tw_shape) if tw_shape else None
        for inverse in (False, True):
            _, rel = rel_err(_call(fn, x, tw, inverse),
                             _call(plain, x, tw, inverse))
            check(rel <= KERNEL_RTOL, f"{name} {shape}: rel err {rel:.3e}")
            worst = max(worst, rel)
            checked += 1
    torch.cuda.synchronize()
    print(f"phase 3: {checked} kernel-vs-plain checks, max relative error "
          f"{worst:.3e} (limit {KERNEL_RTOL})")

    # fft_c2c at every length, then the 2 GB sweep, 1024 its headline in
    # the kernels line.  Then the other kernels at the main path's shapes,
    # forward, as the plans launch them; the first row of each kernel is
    # its headline.
    results: dict[str, dict] = {}
    phase3_pass_lengths(gen, "fft_c2c")
    for n in SWEEP_C2C:
        row = _pass_sweep_row(gen, "fft_c2c", n)
        if n == 1024:
            results["fft_c2c"] = row
    phase3_c2c_strided_lengths(gen)
    main_shapes = [
        ("fft_c2c_axis1", (FFTCase(2**20).n_fft, 1024, 1024), (1024, 1024)),
        ("fft_c2c_t", (FFTCase(2**20).n_fft, 1024, 1024), None),
        ("fft_c2c_axis1", (FFTCase(19321).n_fft, 256, 256), (256, 256)),
        ("fft_c2c_t", (FFTCase(19321).n_fft, 256, 256), None),
        # The N-D plans' passes: fft2 (16, 4096, 4096), rfft2 (16, 4096,
        # 8192)'s second pass on its 4097 bin rows, fftn (2, 512, 512, 512).
        ("fft_c2c_t", (16, 4096, 4096), None),
        ("fft_c2c_t", (16, 4097, 4096), None),
        ("fft_c2c_t", (1024, 512, 512), None),
        # The variants no plan launches, at the 2**20 pass shape.
        ("fft_c2c_axis1", (FFTCase(2**20).n_fft, 1024, 1024), None),
        ("fft_c2c_t", (FFTCase(2**20).n_fft, 1024, 1024), (1024, 1024)),
    ]
    for name, shape, tw_shape in main_shapes:
        fn, plain = FNS[name]
        x = randn(gen, *shape)
        tw = randn(gen, *tw_shape) if tw_shape else None
        # One torch.fft call computes the same function for every kernel
        # without twiddle: fft_c2c_t's row FFT written as (B, C, R) is the
        # FFT along dim -2 of the transposed view.  With a twiddle it is
        # the FFT part alone, timed as a yardstick.
        if name == "fft_c2c_t":
            lib = lambda: torch.fft.fft(x.transpose(1, 2), dim=-2)  # noqa: E731
            lib_call = "torch.fft.fft(x.transpose(1, 2), dim=-2)"
        else:
            lib = lambda: torch.fft.fft(x, dim=-2)  # noqa: E731
            lib_call = "torch.fft.fft(x, dim=-2)"
        y = _call(fn, x, tw, False)
        y_plain = _call(plain, x, tw, False)
        abs_err, rel = rel_err(y, y_plain)
        check(rel <= KERNEL_RTOL, f"{name} {shape}: rel err {rel:.3e}")
        lib_contiguous = True
        if tw is None:
            # The library call must compute the kernel's function.
            y_lib = lib()
            _, lib_rel = rel_err(y_lib, y)
            check(tuple(y_lib.shape) == tuple(y.shape)
                  and lib_rel <= PLAN_RTOL["stockham"],
                  f"{name} {shape}: {lib_call} differs, rel {lib_rel:.3e}")
            lib_contiguous = y_lib.is_contiguous()
            lib_call += (f" (rel diff {lib_rel:.3e}, output contiguous "
                         f"{lib_contiguous})")
            del y_lib
        del y, y_plain
        ms = median_ms(lambda: _call(fn, x, tw, False))
        queued = queued_ms(lambda: _call(fn, x, tw, False))
        plain_ms = median_ms(lambda: _call(plain, x, tw, False), reps=3)
        n = shape[1] if name == "fft_c2c_axis1" else shape[-1]
        transforms = x.numel() // n
        nbytes = 16 * x.numel()                   # read x, write y
        flops = mixed_radix_flop_count(n, batch=transforms)
        nbytes += 8 * (n - 1)                     # the compact twiddle table
        if tw is not None:
            nbytes += 8 * tw.numel()              # the four-step twiddle
            flops += 6 * x.numel()
        bound_ms, bound_by = bound(nbytes, flops)
        fft_ms = median_ms(lib)
        library_ms = fft_ms if tw is None else None
        lib_note = (lib_call + _contiguous_note(lib, lib_contiguous)
                    if tw is None else
                    f"no single call; {lib_call} alone (no twiddle) "
                    f"{fft_ms:.4f} ms")
        row = {"name": name, "shape": list(shape),
               "twiddle": tw is not None, "max_abs_err": abs_err,
               "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
        count = shape[2] if name == "fft_c2c_axis1" else shape[1]
        launch = K.pass_launch(n, count, DEFAULT_RADICES, buffer=True)
        g = K.c2c_cluster(launch.per_block, count)
        print(f"  {name} {tuple(shape)} twiddle={tw is not None}: "
              f"{launch.per_block} transforms a block, clusters of {g} "
              f"({K.active_clusters(launch, g, name)} at once); "
              f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), back to back "
              f"{queued:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"library {library_ms if library_ms is None else round(library_ms, 4)}"
              f" ms [{lib_note}], max abs err {abs_err:.3e} "
              f"(rel {rel:.3e})")
        results.setdefault(name, row)
        del x, tw
        torch.cuda.empty_cache()
    return results


def phase3_c2c_strided_lengths(gen: torch.Generator) -> None:
    """fft_c2c_t and fft_c2c_axis1 against their plain versions at every
    pow2 length (2..8192) on C2C_STRIDED_COUNTS rows or columns (ragged
    against every tile), both radix sets, with and without the twiddle,
    forward and inverse, with the default and one-line blocks and every
    cluster size the planner chooses for them (one block's lines, 4 and 8
    lines a cluster)."""
    worst, checked, sizes = 0.0, 0, set()
    for n in PASS_C2C_LENGTHS:
        for count in C2C_STRIDED_COUNTS:
            x, tw = randn(gen, 2, count, n), randn(gen, count, n)
            xa = x.transpose(1, 2).contiguous()
            for radices in PASS_RADICES:
                for twiddle in (None, tw):
                    for inverse in (False, True):
                        kw = dict(inverse=inverse, radices=radices)
                        cases = (("fft_c2c_t", K.fft_c2c_t, x,
                                  K.fft_c2c_t_plain(x, twiddle, **kw)),
                                 ("fft_c2c_axis1", K.fft_c2c_axis1, xa,
                                  K.fft_c2c_axis1_plain(xa, twiddle, **kw)))
                        for tile_b in (None, 1):
                            pb = K.pass_launch(n, count, radices, tile_b,
                                               buffer=True).per_block
                            for g in {K.c2c_cluster(pb, count, lines)
                                      for lines in (pb, 4, 8)}:
                                for name, fn, inp, want in cases:
                                    _, rel = rel_err(fn(
                                        inp, twiddle, per_block=pb,
                                        cluster=g, **kw), want)
                                    check(rel <= KERNEL_RTOL,
                                          f"{name} n={n} count={count} "
                                          f"radices={radices} twiddle="
                                          f"{twiddle is not None} inverse="
                                          f"{inverse} per_block={pb} "
                                          f"cluster={g}: rel err {rel:.3e}")
                                    worst = max(worst, rel)
                                    checked += 1
                                    sizes.add(g)
                        del cases
            del x, tw, xa
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"phase 3: fft_c2c_t and fft_c2c_axis1 at every pow2 length "
          f"{PASS_C2C_LENGTHS[0]}..{PASS_C2C_LENGTHS[-1]} on "
          f"{C2C_STRIDED_COUNTS} rows or columns: {checked} kernel-vs-plain "
          f"checks (radices {PASS_RADICES}, twiddle or not, forward and "
          f"inverse, clusters of {sorted(sizes)} blocks), max relative "
          f"error {worst:.3e} (limit {KERNEL_RTOL})")


def phase3_real_kernels(gen: torch.Generator,
                        results: dict[str, dict]) -> None:
    """fft_r2c and fft_c2r against their plain versions on the card (both
    radix sets, ragged batches), then each at every length and swept over
    2 GB batches; adds one row per kernel to ``results``."""
    worst = 0.0
    checked = 0
    for n in (8, 64, 1024, 16384):
        b = 1001 if n < 16384 else 37
        for radices in ((4, 2), (8, 4, 2)):
            x = torch.randn(b, n, device="cuda", generator=gen)
            spec = randn(gen, b, n // 2 + 1)       # any input: same merge
            for name, out, plain in (
                    ("fft_r2c", ops.fft_kernel_r2c(x, radices=radices),
                     K.fft_r2c_plain(x, radices=radices)),
                    ("fft_c2r", ops.fft_kernel_c2r(spec, radices=radices),
                     K.fft_c2r_plain(spec, radices=radices))):
                _, rel = rel_err(out, plain)
                check(rel <= KERNEL_RTOL, f"{name} n={n} batch={b} "
                      f"radices={radices}: rel err {rel:.3e}")
                worst = max(worst, rel)
                checked += 1
    torch.cuda.synchronize()
    print(f"phase 3: {checked} real-kernel-vs-plain checks, max relative "
          f"error {worst:.3e} (limit {KERNEL_RTOL})")

    # fft_r2c and fft_c2r at every length, then the 2 GB sweep
    # (FFTCase(n, transform="r2c").n_fft rows), 1024 the headline of each.
    for name in ("fft_r2c", "fft_c2r"):
        phase3_pass_lengths(gen, name)
        for n in SWEEP_R2C:
            row = _pass_sweep_row(gen, name, n)
            if n == 1024:
                results[name] = row


def phase3_hermitian_kernels(gen: torch.Generator,
                             results: dict[str, dict]) -> None:
    """fft_r2c_split and fft_c2r_merge against their plain versions on the
    card: B in HERMITIAN_ROWS and at HERMITIAN_SHAPE, each half length,
    rows at an odd element offset (not 16-byte aligned: the spans' scalar
    edges) and not; then each timed at HERMITIAN_SHAPE beside its plain
    version and a copy of the same bytes; adds one row per kernel to
    ``results``."""
    cases = (("fft_r2c_split", 0, ops.fft_kernel_r2c_split,
              K.fft_r2c_split_plain),
             ("fft_c2r_merge", 1, ops.fft_kernel_c2r_merge,
              K.fft_c2r_merge_plain))
    worst, checked = 0.0, 0
    for name, extra, fn, plain in cases:
        for m in HERMITIAN_HALVES:
            rows = HERMITIAN_ROWS + ((HERMITIAN_SHAPE[0],)
                                     if m == HERMITIAN_SHAPE[1] else ())
            for b in rows:
                for offset in (0, 1):
                    w = m + extra
                    x = randn(gen, b * w + offset)[offset:].view(b, w)
                    check(x.data_ptr() % 16 == 8 * offset,
                          f"{name}: offset {offset} rows are aligned "
                          f"{x.data_ptr() % 16}")
                    _, rel = rel_err(fn(x, 2 * m), plain(x, 2 * m))
                    check(rel <= KERNEL_RTOL, f"{name} b={b} N/2={m} "
                          f"offset={offset}: rel err {rel:.3e}")
                    worst = max(worst, rel)
                    checked += 1
                    del x
                    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"phase 3: {checked} split/merge-kernel-vs-plain checks, max "
          f"relative error {worst:.3e} (limit {KERNEL_RTOL})")
    b, m = HERMITIAN_SHAPE
    for name, extra, fn, plain in cases:
        x = randn(gen, b, m + extra)
        # Read m (split) or m+1 (merge) bins a row, write the other, and
        # the split table once (it stays in L2); 16 float operations a
        # bin in split_of / merge_of.
        nbytes = 8 * b * (2 * m + 1) + 8 * (m + 1)
        results[name] = _timed_row(
            name, (b, m + extra), lambda: fn(x, 2 * m),
            lambda: plain(x, 2 * m), lambda: x.clone(), None,
            "x.clone() (the same bytes copied)", nbytes,
            16.0 * b * (m + 1), _close)
        del x
        torch.cuda.empty_cache()


def phase3_pass_lengths(gen: torch.Generator, name: str) -> None:
    """The register-pass kernel ``name`` (fft_c2c, fft_r2c or fft_c2r)
    against its plain version at every pow2 length, both radix sets,
    forward and inverse (C2C), on a ragged batch, with the default
    transforms per block and with tile_b = 3 (1 where three do not fit a
    block).  The C2R input is any complex tensor (kernel and plain
    version run the same merge)."""
    worst, checked = 0.0, 0
    lengths = PASS_C2C_LENGTHS if name == "fft_c2c" else PASS_R2C_LENGTHS
    for n in lengths:
        m = n if name == "fft_c2c" else n // 2
        fits3 = 3 * m // K.pass_points(m) <= K.PASS_THREADS
        for radices in PASS_RADICES:
            if name == "fft_c2c":
                x = randn(gen, PASS_BATCH, n)
                cases = [(inv, lambda tb, inv=inv: ops.fft_kernel_c2c(
                    x, inverse=inv, radices=radices, tile_b=tb),
                    K.fft_c2c_plain(x, inverse=inv, radices=radices))
                    for inv in (False, True)]
            elif name == "fft_r2c":
                x = torch.randn(PASS_BATCH, n, device="cuda", generator=gen)
                cases = [(False, lambda tb: ops.fft_kernel_r2c(
                    x, radices=radices, tile_b=tb),
                    K.fft_r2c_plain(x, radices=radices))]
            else:
                x = randn(gen, PASS_BATCH, n // 2 + 1)
                cases = [(True, lambda tb: ops.fft_kernel_c2r(
                    x, radices=radices, tile_b=tb),
                    K.fft_c2r_plain(x, radices=radices))]
            for inverse, fn, want in cases:
                for tile_b in (None, 3 if fits3 else 1):
                    _, rel = rel_err(fn(tile_b), want)
                    check(rel <= KERNEL_RTOL,
                          f"{name} n={n} radices={radices} inverse="
                          f"{inverse} tile_b={tile_b}: rel err {rel:.3e}")
                    worst = max(worst, rel)
                    checked += 1
    torch.cuda.synchronize()
    print(f"phase 3: {name} at every pow2 length {lengths[0]}..{lengths[-1]}"
          f": {checked} kernel-vs-plain checks (radices {PASS_RADICES}, "
          f"batch {PASS_BATCH}, tile_b default and 3), max relative error "
          f"{worst:.3e} (limit {KERNEL_RTOL})")


def _pass_sweep_row(gen: torch.Generator, name: str, n: int) -> dict:
    """One row of the 2 GB length sweep of a register-pass kernel: the
    kernel against its plain version, then ms, GB/s, bound, plain ms,
    library ms and the blocks one SM holds (cudaOccupancy...)."""
    if name == "fft_c2c":
        b = FFTCase(n).n_fft
        x = randn(gen, b, n)
        fn, plain = ops.fft_kernel_c2c, K.fft_c2c_plain
        lib, lib_call = (lambda: torch.fft.fft(x)), "torch.fft.fft(x)"
        m, split = n, False
        # Read x, write y (16 bytes a point), the compact twiddle table.
        nbytes = 16 * b * n + 8 * (n - 1)
        flops = mixed_radix_flop_count(n, batch=b)
    else:
        b = FFTCase(n, transform=name[4:]).n_fft
        m, split = n // 2, True
        if name == "fft_r2c":
            x = torch.randn(b, n, device="cuda", generator=gen)
            fn, plain = ops.fft_kernel_r2c, K.fft_r2c_plain
            lib, lib_call = (lambda: torch.fft.rfft(x)), "torch.fft.rfft(x)"
        else:
            # A true half-spectrum: torch.fft.irfft drops the imaginary
            # parts of bins 0 and N/2, the merge reads them.
            x = torch.fft.rfft(torch.randn(b, n, device="cuda",
                                           generator=gen))
            fn, plain = ops.fft_kernel_c2r, K.fft_c2r_plain
            lib = lambda: torch.fft.irfft(x, n=n)  # noqa: E731
            lib_call = f"torch.fft.irfft(x, n={n})"
        # Read or write the reals (4 bytes each) and the N/2+1 bins (8
        # bytes each), the compact table of N/2 and the split table.
        nbytes = 4 * b * n + 8 * b * (m + 1) + 8 * (m - 1) + 8 * (m + 1)
        flops = r2c_flop_count(n, DEFAULT_RADICES, batch=b)
    launch = K.pass_launch(m, b, DEFAULT_RADICES, split=split)
    resident = K.resident_blocks(name, launch)
    row = _timed_row(name, tuple(x.shape), lambda: fn(x), lambda: plain(x),
                     lib, lib_call, None, nbytes, flops, _close)
    row["resident_blocks"] = resident
    queued, lib_queued = queued_ms(lambda: fn(x)), queued_ms(lib)
    print(f"    {name} n={n}: {launch.points} points a thread, "
          f"{launch.per_block} transforms a block, "
          f"{launch.threads} threads and {launch.shared_bytes} shared bytes "
          f"a block, {launch.blocks} blocks, passes {launch.passes}, "
          f"{resident} blocks resident per SM (planner's estimate "
          f"{launch.resident_blocks}); single {row['ms']:.4f} ms, 10 runs "
          f"back to back {queued:.4f} ms a run ({nbytes / queued / 1e6:.1f} "
          f"GB/s), bound {row['bound_ms']:.4f} ms, library single "
          f"{row['library_ms']:.4f} ms, back to back {lib_queued:.4f} ms")
    del x
    torch.cuda.empty_cache()
    return row


def _timed_row(name: str, shape, fn, plain, lib, lib_call: str | None,
               yardstick: str | None, nbytes: float, flops: float,
               compare) -> dict:
    """Check ``fn`` against ``plain`` (and the library call against the
    kernel with ``compare``), time all three, print and return the row."""
    y = fn()
    y_plain = plain()
    abs_err, rel = rel_err(y, y_plain)
    check(compare(y, y_plain, rel, KERNEL_RTOL),
          f"{name} {shape}: kernel vs plain rel err {rel:.3e}")
    del y_plain
    torch.cuda.empty_cache()
    note, lib_contiguous = "", True
    if lib_call is not None:
        y_lib = lib()
        _, lib_rel = rel_err(y_lib, y)
        check(tuple(y_lib.shape) == tuple(y.shape)
              and compare(y_lib, y, lib_rel, PLAN_RTOL["stockham"]),
              f"{name} {shape}: {lib_call} differs, rel {lib_rel:.3e}")
        lib_contiguous = y_lib.is_contiguous()
        note = (f"{lib_call} (rel diff {lib_rel:.3e}, output contiguous "
                f"{lib_contiguous})")
        del y_lib
    del y
    torch.cuda.empty_cache()
    ms = median_ms(fn)
    plain_ms = median_ms(plain, reps=3)
    lib_ms = median_ms(lib)
    library_ms = lib_ms if lib_call is not None else None
    if lib_call is None:
        note = f"no single call; {yardstick} alone {lib_ms:.4f} ms"
    else:
        note += _contiguous_note(lib, lib_contiguous)
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"  {name} {tuple(shape)}: {ms:.4f} ms ({nbytes / ms / 1e6:.1f} "
          f"GB/s), bound {bound_ms:.4f} ms ({bound_by}), plain "
          f"{plain_ms:.4f} ms, library "
          f"{library_ms if library_ms is None else round(library_ms, 4)} ms "
          f"[{note}], max abs err {abs_err:.3e} (rel {rel:.3e})")
    return {"name": name, "shape": list(shape), "twiddle": False,
            "max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _contiguous_note(lib, contiguous: bool) -> str:
    """The library call timed again with ``.contiguous()`` when it
    returns a strided view: the kernel writes the packed layout, which the
    view leaves unwritten, so only this time covers the same store."""
    if contiguous:
        return ""
    ms = median_ms(lambda: lib().contiguous())
    return f"; with .contiguous() {ms:.4f} ms"


def _close(a, b, rel, rtol) -> bool:
    return rel <= rtol


def _equal(a, b, rel, rtol) -> bool:
    return bool(torch.equal(a, b))


def phase3_nd_kernels(gen: torch.Generator, results: dict[str, dict]) -> None:
    """fft_r2c_t, transpose and fft_c2c_mul against their plain versions
    (ragged shapes, every element width, a bank larger than shared
    memory), then timed at the main path's shapes; adds one row per
    kernel to ``results``."""
    checked = 0
    worst = 0.0
    for c, rows in ((4, 1001), (64, 1001), (1024, 37), (8192, 13),
                    (16384, 5)):
        for radices in ((4, 2), (8, 4, 2)):
            x = torch.randn(3, rows, c, device="cuda", generator=gen)
            _, rel = rel_err(ops.fft_kernel_r2c_t(x, radices=radices),
                             K.fft_r2c_t_plain(x, radices=radices))
            check(rel <= KERNEL_RTOL, f"fft_r2c_t c={c} rows={rows} "
                  f"radices={radices}: rel err {rel:.3e}")
            worst = max(worst, rel)
            checked += 1
    for dtype in (torch.float32, torch.complex64, torch.complex128):
        for shape in ((3, 37, 45), (2, 1, 100), (2, 100, 1), (1, 1000, 33)):
            x = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
            check(torch.equal(ops.transpose_kernel(x), K.transpose_plain(x)),
                  f"transpose {shape} {dtype}: not exact")
            checked += 1
    for n, t, rows in ((2048, 85, 37), (64, 1, 1001), (8192, 9, 5)):
        x, bank = randn(gen, rows, n), randn(gen, t, n)
        for inverse in (False, True):
            _, rel = rel_err(ops.fft_kernel_c2c_mul(x, bank, inverse=inverse),
                             K.fft_c2c_mul_plain(x, bank, inverse=inverse))
            check(rel <= KERNEL_RTOL, f"fft_c2c_mul n={n} T={t} rows={rows} "
                  f"inverse={inverse}: rel err {rel:.3e}")
            worst = max(worst, rel)
            checked += 1
    torch.cuda.synchronize()
    print(f"phase 3: {checked} N-D/FDAS kernel-vs-plain checks, max relative "
          f"error {worst:.3e} (limit {KERNEL_RTOL}; transposes exact)")

    phase3_r2c_t_lengths(gen)
    # fft_r2c_t at the first pass of rfft2 (16, 4096, 8192): read the
    # reals, write the transposed bins, the compact table and split table.
    b, r, c = R2C_T_SHAPE
    m = c // 2
    x = torch.randn(b, r, c, device="cuda", generator=gen)
    row = _timed_row(
        "fft_r2c_t", (b, r, c), lambda: ops.fft_kernel_r2c_t(x),
        lambda: K.fft_r2c_t_plain(x),
        lambda: torch.fft.rfft(x.transpose(1, 2), dim=-2),
        "torch.fft.rfft(x.transpose(1, 2), dim=-2)", None,
        4 * b * r * c + 8 * b * (m + 1) * r + 8 * (m - 1) + 8 * (m + 1),
        r2c_flop_count(c, DEFAULT_RADICES, batch=b * r), _close)
    launch = K.pass_launch(m, r, DEFAULT_RADICES, split=True)
    g = K.r2c_t_cluster(launch.per_block, r)
    row["resident_blocks"] = K.resident_blocks("fft_r2c_t", launch)
    row["active_clusters"] = K.active_clusters(launch, g)
    yardstick = lambda: torch.fft.rfft(x).transpose(1, 2).contiguous()  # noqa: E731
    print(f"    fft_r2c_t {(b, r, c)}: {launch.points} points a thread, "
          f"{launch.threads} threads and {launch.shared_bytes} shared bytes "
          f"a block, clusters of {g} blocks ({K.R2C_T_ROWS} rows), "
          f"{row['resident_blocks']} blocks resident per SM, "
          f"{row['active_clusters']} clusters at once; 10 runs back to "
          f"back {queued_ms(lambda: ops.fft_kernel_r2c_t(x)):.4f} ms a run; "
          f"yardstick torch.fft.rfft(x).transpose(1, 2).contiguous() "
          f"{median_ms(yardstick):.4f} ms, back to back "
          f"{queued_ms(yardstick):.4f} ms")
    results["fft_r2c_t"] = row
    del x
    torch.cuda.empty_cache()
    # transpose at the Bluestein fft2's transpose node (13, 1024, 19321).
    x = randn(gen, 13, 1024, 19321)
    results["transpose"] = _timed_row(
        "transpose", tuple(x.shape), lambda: ops.transpose_kernel(x),
        lambda: K.transpose_plain(x),
        lambda: x.transpose(-1, -2).contiguous(),
        "x.transpose(-1, -2).contiguous()", None, 2 * 8 * x.numel(), 0.0,
        _equal)
    del x
    torch.cuda.empty_cache()
    # fft_c2c_mul at the FDAS forward pass: 4 rows x 1077 segments of 2048
    # points against the 85-template bank.
    n, t = 2048, 2 * FDAS_ZMAX + 1
    x, bank = randn(gen, FDAS_ROWS * 1077, n), randn(gen, t, n)
    twr, _ = K.stage_tables(n, DEFAULT_RADICES, x.device)
    rows = x.shape[0]
    results["fft_c2c_mul"] = _timed_row(
        "fft_c2c_mul", (rows, t, n), lambda: ops.fft_kernel_c2c_mul(x, bank),
        lambda: K.fft_c2c_mul_plain(x, bank), lambda: torch.fft.fft(x),
        None, "torch.fft.fft(x) (the FFT, no multiply)",
        8 * n * (rows + t + rows * t) + twr.numel() * 8,
        mixed_radix_flop_count(n, batch=rows) + 6 * rows * t * n, _close)
    del x, bank
    torch.cuda.empty_cache()


def phase3_r2c_t_lengths(gen: torch.Generator) -> None:
    """fft_r2c_t against its plain version at every pow2 C (4..16384) on
    ragged row counts, with the default and one-row blocks and every
    cluster size the planner chooses for them (one block's rows, 4 and 8
    rows a cluster)."""
    worst, checked, sizes = 0.0, 0, set()
    for c in PASS_R2C_LENGTHS:
        for rows in R2C_T_RAGGED_ROWS:
            x = torch.randn(2, rows, c, device="cuda", generator=gen)
            want = K.fft_r2c_t_plain(x)
            for tile_b in (None, 1):
                launch = K.pass_launch(c // 2, rows, override=tile_b,
                                       split=True)
                for g in {K.r2c_t_cluster(launch.per_block, rows, cr)
                          for cr in (launch.per_block, 4, 8)}:
                    _, rel = rel_err(K.fft_r2c_t(x, per_block=launch.per_block,
                                                 cluster=g), want)
                    check(rel <= KERNEL_RTOL, f"fft_r2c_t c={c} rows={rows} "
                          f"per_block={launch.per_block} cluster={g}: rel "
                          f"err {rel:.3e}")
                    worst = max(worst, rel)
                    checked += 1
                    sizes.add(g)
            del x, want
    torch.cuda.synchronize()
    print(f"phase 3: fft_r2c_t at every pow2 C {PASS_R2C_LENGTHS[0]}.."
          f"{PASS_R2C_LENGTHS[-1]}, rows {R2C_T_RAGGED_ROWS}: {checked} "
          f"kernel-vs-plain checks (clusters of {sorted(sizes)} blocks), "
          f"max relative error {worst:.3e} (limit {KERNEL_RTOL})")


def _filterbanks(gen: torch.Generator, plan: DispersionPlan,
                 pulsars_of_row, spec: FilterbankSpec | None = None,
                 amp: float | None = None) -> torch.Tensor:
    """(rows, C, N) float32 filterbanks on the card: unit noise from
    ``gen``, and in row i the pulsars ``pulsars_of_row[i]`` of amplitude
    ``amp``, injected as ``data.synthetic.synthetic_filterbank`` injects
    them (the plan's rounded delays, the same chirp); PULSAR_SPEC and
    PULSAR_AMP by default."""
    spec = spec or PULSAR_SPEC
    amp = PULSAR_AMP if amp is None else amp
    rows = len(pulsars_of_row)
    fb = torch.randn(rows, spec.nchan, spec.ntime, device="cuda",
                     generator=gen)
    t = torch.arange(spec.ntime, device="cuda", dtype=torch.float64)
    for row, pulsars in enumerate(pulsars_of_row):
        for trial, z, k0 in pulsars:
            pulsar = InjectedPulsar(dm=plan.dms[trial], k0=k0, z=z,
                                    amp=amp)
            delays = torch.from_numpy(spec.delay_samples(pulsar.dm)).to(
                "cuda", torch.float64)[:, None]
            s = (t - delays) / spec.ntime
            fb[row] += (pulsar.amp * torch.cos(
                2 * np.pi * (pulsar.k0 * s + 0.5 * pulsar.z * s * s)
                + pulsar.phase)).float()
            del s
    return fb


def _cells(c, row: int) -> set:
    """The (DM trial, template, bin) cells of one row's candidates."""
    return {(int(d), int(t), int(b)) for d, t, b in zip(
        c.dm[row].tolist(), c.template[row].tolist(), c.bin[row].tolist())
        if d >= 0}


def _clear_rungs(ladder: torch.Tensor, margin: float) -> torch.Tensor:
    """Bins whose best normalised rung leads the runner-up by more than
    ``margin`` (two closer rungs may tie either way in float32)."""
    hs = 2.0 ** torch.arange(ladder.shape[-2], device=ladder.device)
    z = (ladder - hs[:, None]) / torch.sqrt(hs)[:, None]
    if z.shape[-2] == 1:
        return torch.ones(z.shape[:-2] + z.shape[-1:], dtype=torch.bool,
                          device=z.device)
    top = z.topk(2, dim=-2).values
    return top[..., 0, :] - top[..., 1, :] > margin


def _same_rungs(lev, want_lev, ladder) -> bool:
    clear = _clear_rungs(ladder, 1e-5)
    return bool(torch.equal(lev[clear], want_lev[clear]))


def _harmonic_adds(rows: int, n: int, n_harmonics: int) -> int:
    """The additions the ladder makes: P[j * k] for j * k < n, j >= 2."""
    return rows * sum(-(-n // j) for j in range(2, n_harmonics + 1))


def _tables(pulsar_table: np.ndarray):
    """(batch, samples, (D, C) delay table) of dedisperse's tile-edge
    checks: random tables with a delay of N - 1 in every channel of the
    last trial (N and D one below, at and above the wrapper's tile of 128,
    channels no multiple of a stage's), a table mixing staged and wide
    channels, and the pulsar plan's table on a short and a ragged N."""
    cases = []
    for batch, nchan, n, ndm in ((1, 1, 1, 1), (3, 5, 1025, 9),
                                 (2, 64, 4096, 17), (1, 1024, 2048, 8),
                                 (2, 17, 127, 127), (1, 33, 129, 129),
                                 (3, 16, 4099, 130)):
        delays = np.random.default_rng(n).integers(0, n, size=(ndm, nchan))
        delays[-1] = n - 1
        cases.append((batch, n, delays))
    rng = np.random.default_rng(1)
    mixed = np.minimum(rng.integers(0, 5, size=(70, 37)).cumsum(axis=0)
                       + rng.integers(0, 1400, size=37), 2998)
    mixed[:, 1::2] = rng.integers(0, 2999, size=(70, 18))
    cases.append((2, 2999, mixed))
    cases += [(2, 1024, pulsar_table), (1, 2**15 + 77, pulsar_table)]
    return cases


def _pulsar_row(name: str, shape, fn, plain, compare, nbytes: float,
                flops: float, composition=None, composition_call=None,
                adds: float = 0.0, device: bool = False) -> dict:
    """Check ``fn`` against ``plain`` with ``compare`` (-> (max abs err,
    ok)), then time both and the nearest torch composition; print and
    return the row (no single PyTorch call computes these functions).
    ``device``: also print the kernel's time launched back to back
    (``queued_ms``) and its device time a call (``device_ms``), beside the
    single call's, which counts the wrapper's host work at small sizes."""
    got = fn()
    want = plain()
    abs_err, ok = compare(got, want)
    check(ok, f"{name} {tuple(shape)}: kernel vs plain differ "
          f"(max abs err {abs_err:.3e})")
    del got, want
    torch.cuda.empty_cache()
    ms = median_ms(fn)
    plain_ms = median_ms(plain, reps=3)
    torch.cuda.empty_cache()
    note = "none"
    if composition is not None:
        note = (f"none; the nearest torch composition, {composition_call}, "
                f"{median_ms(composition, reps=5):.4f} ms")
        torch.cuda.empty_cache()
    if device:
        note += (f"; back to back {queued_ms(fn):.4f} ms, device time "
                 f"{device_ms(fn, name):.4f} ms")
    bound_ms, bound_by = bound(nbytes, flops, adds)
    print(f"  {name} {tuple(shape)}: {ms:.4f} ms ({nbytes / ms / 1e6:.1f} "
          f"GB/s), bound {bound_ms:.4f} ms ({bound_by}; {nbytes:.0f} bytes, "
          f"{flops:.0f} FMA-rate operations, {adds:.0f} adds), plain "
          f"{plain_ms:.4f} ms, library [{note}], max abs err {abs_err:.3e}")
    return {"name": name, "shape": list(shape), "twiddle": False,
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _same(got, want):
    """(max abs err, bit-identical) of a tensor or a tuple of tensors."""
    got, want = ((got, want) if isinstance(got, tuple)
                 else ((got,), (want,)))
    diff = max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))
    return diff, all(torch.equal(g, w) for g, w in zip(got, want))


def phase3_pulsar_kernels(gen: torch.Generator,
                          results: dict[str, dict]) -> None:
    """dedisperse, harmonic_sum_plane and harmonic_sum bit-identical to
    their plain versions at their tile edges (every dedisperse stage size;
    the plane and the ladder at H in {1, 2, 8, 32, 64} and at every swept
    tile), power_spectrum_stats within KERNEL_RTOL at SPECTRUM_SHAPES and
    bit-identical from one call to the next; then each timed at the
    shapes the pulsar search and the demo give it; adds one row per
    kernel to ``results``."""
    plan = DispersionPlan.from_spec(PULSAR_SPEC, n_trials=PULSAR_TRIALS)
    checked, worst = 0, 0.0
    for batch, n, delays in _tables(plan.delay_array()):
        fb = torch.randn(batch, delays.shape[1], n, device="cuda",
                         generator=gen)
        table = torch.from_numpy(delays.astype(np.int32)).cuda()
        want = D.dedisperse_plain(fb, table)
        runs = [("wrapper", lambda: dedisperse_kernel(fb, delays))]
        runs += [(f"{c} channels a stage",
                  lambda c=c: D.dedisperse(fb, table, chunk=c))
                 for c in DEDISP_SWEEP[:-1]]
        for label, fn in runs:
            diff, same = _same(fn(), want)
            check(same, f"dedisperse {tuple(fb.shape)} x {delays.shape[0]} "
                  f"trials ({label}): differs from plain by {diff:.3e}")
            checked += 1
    for rows, n in ((3, 1025), (37, 4096), (5, 65537), (2, 2047),
                    (2, 2049)):
        p = 3.0 * torch.rand(rows, n, device="cuda", generator=gen)
        for h in (1, 2, 8, 32, 64):
            diff, same = _same(harmonic_sum_plane(p, h),
                               H.harmonic_sum_plane_plain(p, h))
            check(same, f"harmonic_sum_plane ({rows}, {n}) H={h}: differs "
                  f"from plain by {diff:.3e}")
            diff, same = _same(harmonic_sum_kernel(p, h),
                               H.harmonic_sum_plain(p, h))
            check(same, f"harmonic_sum ({rows}, {n}) H={h}: differs from "
                  f"plain by {diff:.3e}")
            checked += 2
        if n == 65537:
            want = H.harmonic_sum_plane_plain(p, 8)
            ladder = H.harmonic_sum_plain(p, 32)
            for bins in PLANE_SWEEP:
                diff, same = _same(H.harmonic_sum_plane(p, 8, bins), want)
                check(same, f"harmonic_sum_plane ({rows}, {n}) at {bins} "
                      f"bins a block: differs from plain by {diff:.3e}")
                diff, same = _same(H.harmonic_sum(p, 32, bins), ladder)
                check(same, f"harmonic_sum ({rows}, {n}) H=32 at {bins} "
                      f"bins a block: differs from plain by {diff:.3e}")
                checked += 2
    for rows, n in SPECTRUM_SHAPES:
        x = randn(gen, rows, n)
        got = power_spectrum_stats_kernel(x)
        wp, wmean, wvar = S.power_spectrum_stats_plain(x)
        rels = [rel_err(got[0], wp)[1], rel_err(got[1], wmean)[1],
                rel_err(got[2], torch.sqrt(torch.clamp_min(wvar, 0.0)))[1]]
        check(max(rels) <= KERNEL_RTOL,
              f"power_spectrum_stats ({rows}, {n}): rel errs {rels}")
        again = power_spectrum_stats_kernel(x)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"power_spectrum_stats ({rows}, {n}): two calls differ")
        worst, checked = max(worst, *rels), checked + 2
        del x, got, again, wp
    torch.cuda.synchronize()
    print(f"phase 3: {checked} pulsar-kernel-vs-plain checks; dedisperse, "
          f"harmonic_sum_plane and harmonic_sum bit-identical, "
          f"power_spectrum_stats's max relative error {worst:.3e} (limit "
          f"{KERNEL_RTOL}) and the same bits from two calls")

    # dedisperse at the pulsar phase's shape, with its plan's table: D C N
    # adds a filterbank, less the terms past N (zero).
    spec = PULSAR_SPEC
    b, c, n, d = 2, spec.nchan, spec.ntime, plan.n_trials
    fb = torch.randn(b, c, n, device="cuda", generator=gen)
    table = torch.from_numpy(plan.delay_array().astype(np.int32)).cuda()
    adds = b * int((n - plan.delay_array()).sum())
    results["dedisperse"] = _pulsar_row(
        "dedisperse", (b, c, n, d), lambda: dedisperse_kernel(fb, plan.delays),
        lambda: D.dedisperse_plain(fb, table), _same, 4 * b * n * (c + d), 0,
        adds=adds)
    del fb
    torch.cuda.empty_cache()
    # harmonic_sum_plane at the pulsar phase's power plane: 2 x 128 x 85
    # rows of 65537 bins.  Its adds, and per rung a subtract, a multiply and
    # a compare, are plain float32 operations.
    rows, n, h = 2 * d * (2 * FDAS_ZMAX + 1), n // 2 + 1, PULSAR_HARMONICS
    p = torch.empty(rows, n, device="cuda").exponential_(generator=gen)
    levels = H.levels(h)
    results["harmonic_sum_plane"] = _pulsar_row(
        "harmonic_sum_plane", (rows, n), lambda: harmonic_sum_plane(p, h),
        lambda: H.harmonic_sum_plane_plain(p, h), _same, 12 * rows * n, 0,
        adds=_harmonic_adds(rows, n, h) + rows * n * (1 + 3 * (levels - 1)))
    del p
    torch.cuda.empty_cache()

    # harmonic_sum and power_spectrum_stats at the demo's shape.
    b, n, h = DEMO_SHAPE.batch, DEMO_SHAPE.n, DEMO_SHAPE.n_harmonics
    p = torch.empty(b, n, device="cuda").exponential_(generator=gen)
    levels = H.levels(h)
    results["harmonic_sum"] = _pulsar_row(
        "harmonic_sum", (b, n), lambda: harmonic_sum_kernel(p, h),
        lambda: H.harmonic_sum_plain(p, h), _same,
        4 * b * n * (1 + levels), 0, lambda: harmonic_sum_ref(p, h),
        "the gather ladder of harmonic_sum_ref",
        adds=_harmonic_adds(b, n, h), device=True)
    del p
    x = randn(gen, b, n)

    def composition():
        q = x.real ** 2 + x.imag ** 2
        q /= n
        return torch.var_mean(q, -1, correction=0)

    def stats_close(got, want):
        diffs = [rel_err(got[0], want[0]), rel_err(got[1], want[1]),
                 rel_err(got[2], torch.sqrt(torch.clamp_min(want[2], 0.0)))]
        return (max(d[0] for d in diffs),
                max(d[1] for d in diffs) <= KERNEL_RTOL)
    results["power_spectrum_stats"] = _pulsar_row(
        "power_spectrum_stats", (b, n), lambda: power_spectrum_stats_kernel(x),
        lambda: S.power_spectrum_stats_plain(x), stats_close,
        12 * b * n + 8 * b, 8 * b * n, composition,
        "p = x.real**2 + x.imag**2; p /= n; torch.var_mean(p, -1, "
        "correction=0)", device=True)
    del x
    torch.cuda.empty_cache()


#: sift_select at pulsar.accel's sub-block: 4 trials x 85 templates x
#: (2**22 + 1) bins, the pool of 16384 and the threshold of 30.92.
SIFT_CELLS = 4 * 85 * (2**22 + 1)
SIFT_POOL = 16384
SIFT_THRESHOLD = 30.92


def _sift_check(stat, level, pool, floor=None, threshold=None,
                small: bool = False) -> list[int]:
    """sift_select's pool against torch.topk of the plane at or above the
    floor, exactly, its indices and levels naming those cells, its padding
    marked (index -1), and its count against the plain count; returns the
    counters of row 0.  ``small``: a buffer of 4 pools a row
    (``T.CAPACITY`` set to 1 for the call), which the refinements need."""
    capacity = T.CAPACITY
    T.CAPACITY = 1 if small else capacity
    try:
        got = T.select(stat, level, pool, floor, threshold)
    finally:
        T.CAPACITY = capacity
    want = stat if floor is None else torch.where(
        stat >= floor[:, None], stat, -torch.inf)
    vals = torch.topk(want, min(pool, stat.shape[1])).values
    real = got.vals > -torch.inf
    named = torch.gather(stat, 1, got.idx.clamp(0, stat.shape[1] - 1))
    lev = torch.gather(level, 1, got.idx.clamp(0, stat.shape[1] - 1))
    ok = (torch.equal(got.vals, vals)
          and torch.equal(named[real], got.vals[real])
          and torch.equal(lev[real], got.level[real])
          and bool((got.idx[~real] == -1).all())
          and all(len(set(got.idx[r][real[r]].tolist())) == int(real[r].sum())
                  for r in range(stat.shape[0])))
    if threshold is not None:
        ok = ok and torch.equal(got.over, T.count_over(stat, threshold))
    check(ok, f"sift_select {tuple(stat.shape)} pool {pool} floor "
          f"{floor is not None} small {small}: differs from torch.topk")
    return got.counts[0].tolist()


def phase3_sift_select(gen: torch.Generator,
                       results: dict[str, dict]) -> None:
    """sift_select exactly torch.topk of the plane at or above its floor,
    and its count over the threshold exactly the plain count: noise at
    B = 1 and 2, rows at an odd offset, ties at the pool's boundary that
    overflow the buffer, an all-equal plane, a floor that lets too many
    cells through (each refinement engaged, by its counter), a pool larger
    than the row; then timed at pulsar.accel's sub-block, without a floor
    (two reads) and with one (one read), beside torch.topk alone and the
    plain version (torch.topk and the count); adds its row to
    ``results``."""
    cases = 0
    for rows in (1, 2):
        m = 2**21 + 3
        buf = torch.randn(rows * m + 1, device="cuda", generator=gen)
        for offset in (0, 1):
            stat = buf[offset:offset + rows * m].view(rows, m)
            level = torch.randint(0, 4, (rows, m), device="cuda",
                                  dtype=torch.int32, generator=gen)
            _sift_check(stat, level, 1000, threshold=3.0)
            floor = torch.topk(stat, 600).values[:, -1].contiguous()
            check(_sift_check(stat, level, 1000, floor, 3.0)[1:] == [0, 1],
                  "sift_select: a floor with room in the buffer read the "
                  "plane more than once")
            cases += 2
    stat = torch.round(torch.randn(2, 2**20, device="cuda", generator=gen))
    level = torch.zeros(stat.shape, device="cuda", dtype=torch.int32)
    pool = int((stat > 2.0).sum(-1).max()) + 7
    check(_sift_check(stat, level, pool, None, 1.0, True)[1:] == [2, 4],
          "sift_select: ties past the buffer did not take both refinements")
    stat = torch.full((1, 2**20 + 5), 1.25, device="cuda")
    level = torch.zeros(stat.shape, device="cuda", dtype=torch.int32)
    check(_sift_check(stat, level, 500, stat[:, 0].contiguous(), 1.25,
                      True) == [500, 2, 4],
          "sift_select: an all-equal plane")
    stat = 1 + torch.randn(2, 2**21, device="cuda", generator=gen) * 1e-3
    level = torch.zeros(stat.shape, device="cuda", dtype=torch.int32)
    counts = _sift_check(stat, level, 100, torch.full((2,), 0.5,
                                                      device="cuda"), 1.002,
                         True)
    check(counts[1] >= 1, f"sift_select: an overflowing floor took no "
          f"refinement ({counts})")
    stat = torch.randn(2, 5000, device="cuda", generator=gen)
    level = torch.zeros(stat.shape, device="cuda", dtype=torch.int32)
    _sift_check(stat, level, 8000, None, 1.0, True)
    cases += 4
    del buf, stat, level
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"phase 3: {cases} sift_select checks, each exactly torch.topk "
          f"and the plain count")

    # At pulsar.accel's sub-block: the statistic's lowest rung under the
    # null, P - 1 with P exponential; the floor of a second plane's pool.
    m, pool, thr = SIFT_CELLS, SIFT_POOL, SIFT_THRESHOLD
    stat = torch.empty(1, m, device="cuda").exponential_(generator=gen) - 1
    level = torch.randint(0, 4, (1, m), device="cuda", dtype=torch.int32,
                          generator=gen)
    other = torch.empty(1, m, device="cuda").exponential_(generator=gen) - 1
    floor = torch.topk(other, pool).values[:, -1].contiguous()
    del other
    torch.cuda.empty_cache()

    def same(got, want):
        return 0.0, bool(torch.equal(got.vals, want.vals)
                         and torch.equal(got.over, want.over))
    # One read of the plane bounds it (the second read, of a block's first
    # sub-block, is counted in the time, not in the bound).
    results["sift_select"] = _pulsar_row(
        "sift_select", (1, m), lambda: T.select(stat, level, pool, None, thr),
        lambda: T.select_plain(stat, level, pool, thr), same, 4 * m, 0,
        lambda: torch.topk(stat, pool), f"torch.topk(stat, {pool}) alone",
        adds=2 * m, device=True)
    floored = median_ms(lambda: T.select(stat, level, pool, floor, thr))
    counts = _sift_check(stat, level, pool, floor, thr)
    print(f"  sift_select (1, {m}) with the floor of a full pool: "
          f"{floored:.4f} ms, counters (kept, refinements, reads) {counts}")
    del stat, level
    torch.cuda.empty_cache()

def phase3_pulsar_tiles(gen: torch.Generator) -> None:
    """The staged kernels' tiles: dedisperse over DEDISP_SWEEP on 2
    filterbanks of 1024 x 2**17 with the plan's table, harmonic_sum_plane
    over PLANE_SWEEP on its (21760, 65537) plane at H = 8, harmonic_sum
    over PLANE_SWEEP at the demo's (32, 2**20), H = 32; each tile checked
    bit-identical to the wrapper's or the plain version and timed (median
    of 5; the ladder also by its device time), with the blocks one SM
    holds.  Then power_spectrum_stats over SPECTRUM_SWEEP segments a row
    at the demo's shape, each within KERNEL_RTOL and timed by its device
    time and back to back (its single call is mostly host time)."""
    plan = DispersionPlan.from_spec(PULSAR_SPEC, n_trials=PULSAR_TRIALS)
    b, c, n = 2, PULSAR_SPEC.nchan, PULSAR_SPEC.ntime
    fb = torch.randn(b, c, n, device="cuda", generator=gen)
    table = torch.from_numpy(plan.delay_array().astype(np.int32)).cuda()
    want = D.dedisperse(fb, table)
    span_cap = D.staged_table(table).span_cap
    times, best = [], None
    for chunk in DEDISP_SWEEP:
        fn = lambda: D.dedisperse(fb, table, chunk)  # noqa: E731
        check(torch.equal(fn(), want), f"dedisperse at {chunk} channels a "
              f"stage differs from the wrapper's {D.CHUNK}")
        ms = median_ms(fn, reps=5)
        times.append(f"({chunk} channels) {ms:.4f} ms "
                     f"[{D.blocks_per_sm(span_cap, chunk)} an SM]")
        if best is None or ms < best[1]:
            best = (chunk, ms)
    print(f"  dedisperse {(b, c, n, plan.n_trials)} tiles (128 samples, 64 "
          f"trials a block): " + "; ".join(times) + f"; fastest {best[0]} "
          f"channels (the wrapper's {D.CHUNK})")
    del fb, want
    torch.cuda.empty_cache()
    rows, n = 2 * plan.n_trials * (2 * FDAS_ZMAX + 1), n // 2 + 1
    p = torch.empty(rows, n, device="cuda").exponential_(generator=gen)
    h = PULSAR_HARMONICS
    want = H.harmonic_sum_plane(p, h)
    times, best = [], None
    for bins in PLANE_SWEEP:
        fn = lambda: H.harmonic_sum_plane(p, h, bins)  # noqa: E731
        check(_same(fn(), want)[1], f"harmonic_sum_plane at {bins} bins a "
              f"block differs from the wrapper's {H.plane_bins(h)}")
        ms = median_ms(fn, reps=5)
        times.append(f"({bins} bins) {ms:.4f} ms "
                     f"[{H.blocks_per_sm(bins, h)} an SM]")
        if best is None or ms < best[1]:
            best = (bins, ms)
    print(f"  harmonic_sum_plane {(rows, n)} H={h} tiles: "
          + "; ".join(times) + f"; fastest {best[0]} bins (the wrapper's "
          f"{H.plane_bins(h)})")
    del p, want
    torch.cuda.empty_cache()
    b, n, h = DEMO_SHAPE.batch, DEMO_SHAPE.n, DEMO_SHAPE.n_harmonics
    p = torch.empty(b, n, device="cuda").exponential_(generator=gen)
    want = H.harmonic_sum_plain(p, h)
    times, best = [], None
    for bins in PLANE_SWEEP:
        fn = lambda: H.harmonic_sum(p, h, bins)  # noqa: E731
        diff, same = _same(fn(), want)
        check(same, f"harmonic_sum at {bins} bins a block differs from "
              f"plain by {diff:.3e}")
        ms = median_ms(fn, reps=5)
        dev = device_ms(fn, "harmonic_sum")
        times.append(f"({bins} bins) {ms:.4f} ms, device {dev:.4f} ms "
                     f"[{H.blocks_per_sm(bins, h, plane=False)} an SM]")
        if best is None or ms < best[1]:
            best = (bins, ms)
    print(f"  harmonic_sum {(b, n)} H={h} tiles: " + "; ".join(times)
          + f"; fastest {best[0]} bins (the wrapper's {H.LADDER_BINS})")
    del p, want
    torch.cuda.empty_cache()
    x = randn(gen, b, n)
    want = S.power_spectrum_stats_plain(x)
    wave = S._wave(x.device.index)
    times, best = [], None
    for count in (*SPECTRUM_SWEEP, None):
        fn = lambda: S.power_spectrum_stats(x, count)  # noqa: E731
        rels = [rel_err(g, w)[1] for g, w in zip(fn(), want)]
        check(max(rels) <= KERNEL_RTOL, f"power_spectrum_stats at {count} "
              f"segments a row: rel errs {rels}")
        ms = device_ms(fn, "power_spectrum_stats")
        segs, seg = S.segments(b, n, wave, count)
        label = "the wrapper's" if count is None else "asked"
        times.append(f"({segs} segments of {seg} bins, {label}) device "
                     f"{ms:.4f} ms, back to back {queued_ms(fn):.4f} ms")
        if best is None or ms < best[1]:
            best = (segs, ms)
    print(f"  power_spectrum_stats {(b, n)} segments a row ({wave} blocks "
          f"a wave): " + "; ".join(times) + f"; fastest {best[0]}")
    del x, want
    torch.cuda.empty_cache()


def phase3_rows_per_block(gen: torch.Generator) -> None:
    """The clustered kernels' cluster size.  fft_c2c_t and fft_c2c_axis1
    at C2C_SWEEP (one row or column a block at 4096; four a block, and one
    a block, at 1024), fft_r2c_t at the rfft2 pass (one row a block at C =
    8192), each timed with clusters that move 1 (one block's), 4 and 8
    rows or columns together; the fastest is reported beside the
    planner's choice (C2C_CLUSTER_LINES, C2C_UNALIGNED_LINES, R2C_T_ROWS).
    Each variant is checked against the first."""
    for name, shape in C2C_SWEEP:
        fn = K.fft_c2c_t if name == "fft_c2c_t" else K.fft_c2c_axis1
        x = randn(gen, *shape)
        n, count = ((shape[1], shape[2]) if name == "fft_c2c_axis1"
                    else (shape[2], shape[1]))
        default = K.pass_launch(n, count, DEFAULT_RADICES, buffer=True)
        for tile_b in ((None,) if default.per_block == 1 else (None, 1)):
            launch = K.pass_launch(n, count, DEFAULT_RADICES, tile_b,
                                   buffer=True)
            pb = launch.per_block
            y1 = fn(x, per_block=pb, cluster=1)
            times, best = [], None
            for g in sorted({K.c2c_cluster(pb, count, lines)
                             for lines in (pb, 4, 8)}):
                launch_g = lambda: fn(x, per_block=pb,  # noqa: E731
                                      cluster=g)
                _, rel = rel_err(launch_g(), y1)
                check(rel <= KERNEL_RTOL, f"{name} {shape} clusters of "
                      f"{g}: rel err {rel:.3e}")
                ms, queued = median_ms(launch_g), queued_ms(launch_g)
                times.append(f"{pb * g} lines (G = {g}, "
                             f"{K.active_clusters(launch, g, name)} "
                             f"clusters at once) {ms:.4f} ms, back to "
                             f"back {queued:.4f} ms")
                if best is None or ms < best[1]:
                    best = (pb * g, ms)
            print(f"  {name} {shape} lines a cluster, {pb} a block: "
                  + "; ".join(times) + f"; fastest {best[0]} lines "
                  f"(the planner's {pb * K.c2c_cluster(pb, count)}: "
                  f"C2C_CLUSTER_LINES = {K.C2C_CLUSTER_LINES}, "
                  f"C2C_UNALIGNED_LINES = {K.C2C_UNALIGNED_LINES})")
            del y1
        del x
        torch.cuda.empty_cache()

    b, r, c = R2C_T_SHAPE
    x = torch.randn(b, r, c, device="cuda", generator=gen)
    launch = K.pass_launch(c // 2, r, DEFAULT_RADICES, split=True)
    per_block = launch.per_block
    y1 = K.fft_r2c_t(x, per_block=per_block, cluster=1)
    times, best = [], None
    for cluster_rows in (per_block, 4, 8):
        g = K.r2c_t_cluster(per_block, r, cluster_rows)
        launch_g = lambda: K.fft_r2c_t(x, per_block=per_block,  # noqa: E731
                                       cluster=g)
        _, rel = rel_err(launch_g(), y1)
        check(rel <= KERNEL_RTOL, f"fft_r2c_t {R2C_T_SHAPE} clusters of {g}: "
              f"rel err {rel:.3e}")
        ms, queued = median_ms(launch_g), queued_ms(launch_g)
        times.append(f"{per_block * g} rows (G = {g}, "
                     f"{K.active_clusters(launch, g)} clusters at once) "
                     f"{ms:.4f} ms, back to back {queued:.4f} ms")
        if best is None or ms < best[1]:
            best = (per_block * g, ms)
    print(f"  fft_r2c_t {R2C_T_SHAPE} rows a cluster, {per_block} a block: "
          + "; ".join(times) + f"; fastest {best[0]} rows (planner's "
          f"R2C_T_ROWS = {K.R2C_T_ROWS})")
    del x, y1
    torch.cuda.empty_cache()


def _pass_input(gen: torch.Generator, name: str, n: int):
    """A 2 GB batch of length ``n`` for fft_c2c or fft_r2c (the 1-D plans'
    ``FFTCase`` batches), its wrapper with tile_b = K, its torch.fft call
    and the half length of its passes."""
    if name == "fft_c2c":
        x = randn(gen, FFTCase(n).n_fft, n)
        return (x, lambda k=None: ops.fft_kernel_c2c(x, tile_b=k),
                lambda: torch.fft.fft(x), n)
    x = torch.randn(FFTCase(n, transform="r2c").n_fft, n, device="cuda",
                    generator=gen)
    return (x, lambda k=None: ops.fft_kernel_r2c(x, tile_b=k),
            lambda: torch.fft.rfft(x), n // 2)


def _host_us(fn, calls: int = HOST_GAP_CALLS) -> float:
    """Median host time [us] of one call of ``fn``, each call timed with
    ``time.perf_counter`` while a spin kernel keeps the card busy: every
    launch queues behind it, so no call waits for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def _single_host(fn, reps: int = 10,
                 empty_cache: bool = False) -> tuple[float, float]:
    """Median time [ms] of one run of ``fn`` between CUDA events on an
    idle card, as ``median_ms`` times it, and the median host time [us]
    of the timed call; with ``empty_cache`` the allocator's pool is
    emptied first, as the sweep rows and phase 4 do before they time."""
    if empty_cache:
        torch.cuda.empty_cache()
    fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), statistics.median(host) * 1e6


def _spun_ms(fn, reps: int = 10) -> float:
    """Median time of one run of ``fn`` between CUDA events recorded
    behind a spin of about 1 ms: the host enqueues the run while the card
    spins, so the time is the card's alone, as a single launch's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES // 50)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase3_host_gap(gen: torch.Generator) -> None:
    """The host time of one fft_c2c and fft_r2c call at 1024 and 8192 /
    16384 on 2 GB batches, broken down: the wrapper the plans call
    (ops), the kernel function (fft_kernel), the ctypes call of the C
    entry on its cached plan (C entry and launch), a ctypes call of an
    empty C function of the same signature, and what each call did
    before plans were cached: plan the launch in C (make_reg_plan and
    cudaFuncSetAttribute), enter torch.cuda.device; beside them the
    stream lookup, the output's allocation and torch.fft's call.  Then
    the single launch (CUDA events around one call on an idle card, with
    the call's host time; again right after the allocator's pool was
    emptied), one launch whose host work hides behind a spin, and back
    to back."""
    for name, n in HOST_GAP_CASES:
        x, fn, lib_fn, m = _pass_input(gen, name, n)
        b = x.shape[0]
        dev = x.device
        launch = K.pass_launch(m, b, DEFAULT_RADICES,
                               split=name != "fft_c2c")
        kernel_fn = (K.fft_c2c if name == "fft_c2c" else K.fft_r2c)
        lib = K._library() if name == "fft_c2c" else K._real_library()
        plan = K._plan(name, n, b, DEFAULT_RADICES, launch.per_block, False,
                       dev)
        run = getattr(lib, f"repro_{name}_run")
        y = kernel_fn(x, per_block=launch.per_block)
        stream = K._stream(dev)
        args = (plan.address, x.data_ptr(), y.data_ptr(), b, stream)
        make = getattr(lib, f"repro_{name}_plan")
        buf = ctypes.create_string_buffer(lib.repro_pass_plan_bytes())
        table = K.pass_table(m, DEFAULT_RADICES)
        dr, di = K._dft8(False)
        tw = K.compact_twiddles(m, DEFAULT_RADICES, dev)
        head = (buf, n, launch.points, launch.per_block, table.ctypes.data,
                len(table))
        tail = ((0, dr.ctypes.data, di.ctypes.data, tw.data_ptr())
                if name == "fft_c2c" else
                (dr.ctypes.data, di.ctypes.data, tw.data_ptr(),
                 plan.keep[-1].data_ptr()))

        def device_context():
            with torch.cuda.device(dev):
                pass

        steps = {
            "wrapper (ops)": fn,
            "kernel function": lambda: kernel_fn(
                x, per_block=launch.per_block),
            "ctypes + C entry + launch": lambda: run(*args),
            "ctypes, empty C function": lambda: lib.repro_pass_noop(*args),
            "plan in C per call (as every call did)":
                lambda: make(*head, *tail),
            "torch.cuda.device context (as every call did)": device_context,
            "stream lookup, raw (the calls')": lambda: K._stream(dev),
            "stream lookup, torch.cuda.current_stream (as every call did)":
                lambda: torch.cuda.current_stream(dev).cuda_stream,
            "output allocation": lambda: torch.empty_like(y),
            "library (torch.fft)": lib_fn,
        }
        us = {step: _host_us(f) for step, f in steps.items()}
        ops_us = us["wrapper (ops)"] - us["kernel function"]
        python_us = us["kernel function"] - us["ctypes + C entry + launch"]
        entry_us = (us["ctypes + C entry + launch"]
                    - us["ctypes, empty C function"])
        single, single_host = _single_host(fn)
        cold, cold_host = _single_host(fn, empty_cache=True)
        spun, queued = _spun_ms(fn), queued_ms(fn)
        print(f"  host time of one {name} call, n={n}, batch {b} (median of "
              f"{HOST_GAP_CALLS}, card busy): "
              + ", ".join(f"{k} {v:.1f} us" for k, v in us.items())
              + f"; so ops layer {ops_us:.1f} us, kernel function's Python "
              f"{python_us:.1f} us, C entry and launch {entry_us:.1f}"
              f" us; single launch {single:.4f} ms (its call's host time "
              f"{single_host:.1f} us), right after empty_cache() {cold:.4f} "
              f"ms ({cold_host:.1f} us), behind a spin {spun:.4f} ms, back to "
              f"back {queued:.4f} ms (single / back to back "
              f"{single / queued:.4f})")
        del x, y
        torch.cuda.empty_cache()


def _drive(label: str, plan, x: torch.Tensor, expected: dict[str, int],
           ref_fn, lib_fn, nbytes: int, case: FFTCase, rtol: float,
           launches: dict[str, int]) -> torch.Tensor:
    """One main-path run of ``plan`` on ``x`` with every launch count set
    to 0 just before it and read just after; checks the ledger, the
    counts and the result against ``ref_fn``; times the plan and
    ``lib_fn``; prices ``case`` on the V100 model.  Adds the run's
    launches to ``launches`` and returns the plan's output."""
    ledger = LaunchLedger()
    reset_launches()
    with ledger.capture():
        y = plan(x)
    torch.cuda.synchronize()
    run = launch_counts()
    counts = ledger.counts()
    check(counts == expected, f"{label}: ledger {counts} != {expected}")
    for ledger_name, count in counts.items():
        kernel = LEDGER_TO_KERNEL[ledger_name]
        check(run[kernel] == count,
              f"{label}: {kernel} launched {run[kernel]} times, the "
              f"ledger says {count}")
    for kernel, count in run.items():
        launches[kernel] += count
    values = torch.view_as_real(y) if y.is_complex() else y
    check(bool(torch.isfinite(values).all()), f"{label}: bad output")
    ref = ref_fn(x)
    check(tuple(y.shape) == tuple(ref.shape),
          f"{label}: shape {tuple(y.shape)} != {tuple(ref.shape)}")
    abs_err, rel = rel_err(y, ref)
    del ref
    torch.cuda.empty_cache()
    check(rel <= rtol, f"{label}: plan vs torch.fft rel err {rel:.3e}")
    ms = median_ms(lambda: plan(x))
    library_ms = median_ms(lib_fn)
    res = sweep(fft_workload(case, TESLA_V100), TESLA_V100)
    print(f"phase 4: {label} {plan.algorithm} passes={plan.passes} "
          f"batch={x.shape[0]} ledger={counts} "
          f"launches={ {k: v for k, v in run.items() if v} } "
          f"kernel_ms={ms:.4f} GB/s={nbytes / ms / 1e6:.1f} "
          f"bound_ms={ledger.total_bytes() / HBM_BYTES_PER_S * 1e3:.4f} "
          f"(ledger bytes {ledger.total_bytes()}; function bytes "
          f"{nbytes}: {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms) "
          f"library_ms={library_ms:.4f} max_abs_err={abs_err:.3e} "
          f"rel={rel:.3e} | V100 model of {case.name}: optimal "
          f"{res.optimal.f:.1f} MHz, {res.optimal.energy:.4f} J vs boost "
          f"{res.boost.energy:.4f} J, I_ef {res.i_ef_boost:.4f}")
    split = device_breakdown(lambda: plan(x))
    busy = sum(split.values())
    print(f"  {label} device time by kernel (ms, one profiled run): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
          + f"; busy {busy:.4f} of {ms:.4f} ms timed "
          f"(idle share {max(0.0, 1 - busy / ms):.3f})")
    return y


def phase4_main_path(gen: torch.Generator) -> dict[str, int]:
    """Drive plan_for_length(n)(x) at 2 GB batches, then the real plans at
    2 GB real batches; returns the launches of each kernel summed over the
    main-path runs."""
    launches = {name: 0 for name in launch_counts()}
    for n in MAIN_LENGTHS:
        case = FFTCase(n)
        plan = plan_for_length(n)
        x = randn(gen, case.n_fft, n)
        y = _drive(f"n={n}", plan, x, EXPECTED_LEDGER[n], fft_ref,
                   lambda: torch.fft.fft(x), 16 * x.numel(), case,
                   PLAN_RTOL[plan.algorithm], launches)
        del x, y
        torch.cuda.empty_cache()
    for n in REAL_LENGTHS:
        batch = FFTCase(n, transform="r2c").n_fft
        m = n // 2
        nbytes = 4 * batch * n + 8 * batch * (m + 1)
        x = torch.randn(batch, n, device="cuda", generator=gen)
        r2c, c2r = plan_for_length(n, "r2c"), plan_for_length(n, "c2r")
        spec = _drive(f"r2c n={n}", r2c, x, REAL_EXPECTED["r2c", n],
                      rfft_ref, lambda: torch.fft.rfft(x), nbytes,
                      FFTCase(n, transform="r2c"),
                      PLAN_RTOL[r2c.algorithm], launches)
        # spec is the rfft of a real signal: a true half-spectrum.
        back = _drive(f"c2r n={n}", c2r, spec, REAL_EXPECTED["c2r", n],
                      irfft_ref, lambda: torch.fft.irfft(spec, n=n),
                      nbytes, FFTCase(n, transform="c2r"),
                      PLAN_RTOL[c2r.algorithm], launches)
        _, rel = rel_err(back, x)
        check(rel <= PLAN_RTOL["stockham"],
              f"n={n}: c2r(r2c(x)) vs x rel err {rel:.3e}")
        print(f"  n={n}: c2r(r2c(x)) vs x rel err {rel:.3e}")
        del x, spec, back
        torch.cuda.empty_cache()
    for label, fn_name, shape, is_complex, expected, rtol in ND_CASES:
        kind = "c2c" if is_complex else "r2c"
        dims = tuple(range(1, len(shape)))
        user_fn = getattr(multidim, fn_name)
        # The entry point a user calls (multidim.fft2/rfft2/fftn), with the
        # plan graph it builds for its accounting.
        plan = dataclasses.replace(
            plan_nd(shape[1:], kind),
            fn=lambda v, _fn=user_fn, _dims=dims: _fn(v, axes=_dims))
        if is_complex:
            x = randn(gen, *shape)
            ref_fn = (lambda v, _d=dims: torch.fft.fftn(v, dim=_d))
            nbytes = 16 * x.numel()
        else:
            x = torch.randn(*shape, device="cuda", generator=gen)
            ref_fn = (lambda v, _d=dims: torch.fft.rfftn(v, dim=_d))
            nbytes = 4 * x.numel() + 8 * (x.numel() // shape[-1]) * (
                shape[-1] // 2 + 1)
        y = _drive(label, plan, x, expected, ref_fn, lambda: ref_fn(x),
                   nbytes, FFTCase(shape=shape[1:], transform=kind), rtol,
                   launches)
        print(f"  {label}: nodes {[nd.op for nd in plan.nodes]}, passes "
              f"{plan.passes} (per-axis chain {plan.chain_passes})")
        del x, y
        torch.cuda.empty_cache()
    return launches


def _fdas_series(gen: torch.Generator) -> torch.Tensor:
    """FDAS_ROWS noise series on the card, the accelerated tone in row 0."""
    x = 0.5 * torch.randn(FDAS_ROWS, FDAS_N, device="cuda", generator=gen)
    s = torch.arange(FDAS_N, device="cuda", dtype=torch.float64) / FDAS_N
    x[0] += (0.25 * torch.cos(2 * np.pi * (FDAS_K0 * s
                                           + 0.5 * FDAS_Z * s * s))).float()
    return x


def _fdas_oracle_plane(spec: torch.Tensor, bank: TemplateBank
                       ) -> torch.Tensor:
    """The matched-filter plane of one (1, nbins) spectrum by a direct
    pad-to-full-length torch.fft convolution (the reference's test
    oracle)."""
    nbins = spec.shape[-1]
    taps = torch.from_numpy(bank.time_domain()).to(spec.device,
                                                   torch.complex64)
    m = 1 << (nbins + bank.taps - 2).bit_length()
    full = torch.fft.ifft(torch.fft.fft(spec, m) * torch.fft.fft(taps, m))
    return full[:, bank.offset:bank.offset + nbins]


def _fdas_stages(x: torch.Tensor, bank: TemplateBank) -> tuple:
    """fdas_search's steps one by one, each timed with CUDA events: returns
    (stage name -> ms, power plane).  The same calls as fdas_search and
    overlap_save_conv, in the same order."""
    plan = fdas_conv_plan(x.shape[-1], bank)
    taps, nfft, step, nseg = bank.taps, plan.nfft, plan.step, plan.n_segments
    names = ("r2c", "forward+multiply", "inverse", "trim", "power", "top-k")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    ev[0].record()
    xm = x - x.mean(dim=-1, keepdim=True)
    spectrum = plan_for_length(x.shape[-1], "r2c")(xm)
    ev[1].record()
    nbins = spectrum.shape[-1]
    spectra = device_filter_spectra(bank.key, bank.time_domain(), nfft,
                                    x.device)
    total = (nseg - 1) * step + nfft
    xp = torch.nn.functional.pad(spectrum,
                                 (taps - 1, total - (taps - 1) - nbins))
    prod = fft_mul(xp.unfold(-1, nfft, step), spectra)
    ev[2].record()
    y = pow2_fft(prod, inverse=True)
    ev[3].record()
    del prod
    valid = y[..., taps - 1:].movedim(-3, -2)
    mf = valid.reshape(*valid.shape[:-2], nseg * step)[
        ..., bank.offset:bank.offset + nbins]
    ev[4].record()
    del y
    sigma2 = (spectrum.real ** 2 + spectrum.imag ** 2).mean(
        dim=-1, keepdim=True)[..., None]
    power = power_plane(mf, sigma2)
    ev[5].record()
    extract_candidates(power)
    ev[6].record()
    ev[6].synchronize()
    return ({name: ev[i].elapsed_time(ev[i + 1])
             for i, name in enumerate(names)}, power)


def _fdas_tone(label: str, res, bank: TemplateBank) -> tuple[int, int]:
    """Check that the power plane is finite and of the search's shape and
    that the injected tone is its peak and the top candidate of row 0, at
    its (template, bin) cell; returns that cell."""
    nbins = FDAS_N // 2 + 1
    check(tuple(res.power.shape) == (FDAS_ROWS, bank.n_templates, nbins)
          and bool(torch.isfinite(res.power).all()),
          f"{label}: bad power plane")
    t_hit, b_hit = divmod(int(res.power[0].argmax()), nbins)
    t_want = int(np.argmin(np.abs(np.array(bank.drifts) - FDAS_Z)))
    top = (int(res.candidates.template[0, 0]), int(res.candidates.bin[0, 0]))
    check(t_hit == t_want and abs(b_hit - FDAS_K0) <= 1 and top == (t_hit,
                                                                    b_hit),
          f"{label}: tone found at (template {t_hit}, bin {b_hit}), top "
          f"candidate {top}; injected at (template {t_want}, bin {FDAS_K0})")
    return t_hit, b_hit


def phase5_fdas(gen: torch.Generator) -> dict[str, int]:
    """fdas_search on FDAS_ROWS series of FDAS_N points with the linear
    85-template bank; returns the run's launches."""
    bank = TemplateBank.linear(zmax=FDAS_ZMAX)
    plan = fdas_conv_plan(FDAS_N, bank)
    check((bank.n_templates, bank.taps) == (85, 100)
          and (plan.nfft, plan.step, plan.n_segments) == (2048, 1949, 1077),
          f"FDAS plan {plan}")
    x = _fdas_series(gen)
    ledger = LaunchLedger()
    reset_launches()
    with ledger.capture():
        res = fdas_search(x, bank)
    torch.cuda.synchronize()
    run = launch_counts()
    counts = ledger.counts()
    check(counts == FDAS_LEDGER, f"fdas: ledger {counts} != {FDAS_LEDGER}")
    for ledger_name, count in counts.items():
        kernel = LEDGER_TO_KERNEL[ledger_name]
        check(run[kernel] == count, f"fdas: {kernel} launched {run[kernel]} "
              f"times, the ledger says {count}")
    (inverse,) = [r for r in ledger.records if r.kernel == "fft-c2c"]
    planes = FDAS_ROWS * plan.n_segments * bank.n_templates
    check(inverse.shape == (planes, plan.nfft),
          f"fdas: inverse launch {inverse.shape}, want ({planes}, "
          f"{plan.nfft}): one launch for all T planes")
    t_hit, b_hit = _fdas_tone("fdas", res, bank)
    power0 = res.power[0]
    # One row's plane against the direct oracle, both from torch.fft's
    # spectrum of the row; then the served power plane end to end.
    xm = x[:1] - x[:1].mean(dim=-1, keepdim=True)
    spec = torch.fft.rfft(xm)
    want = _fdas_oracle_plane(spec, bank)
    _, plane_rel = rel_err(matched_filter_plane(spec, bank)[0], want)
    check(plane_rel <= FDAS_RTOL,
          f"fdas: plane vs direct oracle rel err {plane_rel:.3e}")
    sigma2 = (spec.abs() ** 2).mean()
    _, power_rel = rel_err(power0, want.abs() ** 2 / sigma2)
    check(power_rel <= FDAS_RTOL,
          f"fdas: power plane vs direct oracle rel err {power_rel:.3e}")
    del want, spec
    torch.cuda.empty_cache()
    ms = median_ms(lambda: fdas_search(x, bank), reps=5)
    stage_runs = []
    for _ in range(3):
        stages, power = _fdas_stages(x, bank)
        stage_runs.append(stages)
    _, stage_rel = rel_err(power, res.power)
    check(stage_rel <= 1e-6, f"fdas: staged run differs, rel {stage_rel:.3e}")
    del power
    torch.cuda.empty_cache()
    stages = {k: statistics.median(r[k] for r in stage_runs)
              for k in stage_runs[0]}
    split = device_breakdown(lambda: fdas_search(x, bank))
    busy = sum(split.values())
    print(f"phase 5: fdas {FDAS_ROWS} x {FDAS_N} points, "
          f"{bank.n_templates} templates of {bank.taps} taps, nfft "
          f"{plan.nfft}, step {plan.step}, {plan.n_segments} segments; "
          f"ledger {counts}, inverse launch shape {inverse.shape}; tone at "
          f"(template {t_hit}, bin {b_hit}), power {float(power0.max()):.1f};"
          f" plane vs oracle rel {plane_rel:.3e}, power rel "
          f"{power_rel:.3e}; search {ms:.4f} ms (median of 5)")
    print("  fdas stages (ms, median of 3 staged runs): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f}")
    print("  fdas device time by kernel (ms, one profiled run): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
          + f"; busy {busy:.4f} of {ms:.4f} ms timed "
          f"(idle share {max(0.0, 1 - busy / ms):.3f})")
    del x, res
    torch.cuda.empty_cache()
    return run


def phase6_serving(gen: torch.Generator) -> dict[str, int]:
    """Serve SERVE_WAVES waves of C2C, R2C, rank-2, FDAS and pulsar
    requests through FFTService(TESLA_V100) on cuda:0; returns the phase's
    launches."""
    rng = np.random.default_rng(SEED)
    xc = rng.standard_normal((4096, 8192), dtype=np.float32).view(
        np.complex64)                               # (4096, 4096) complex64
    xr = rng.standard_normal((8192, 4096), dtype=np.float32)
    x2 = rng.standard_normal((8, 2048, 4096), dtype=np.float32).view(
        np.complex64)                               # (8, 2048, 2048)
    x1 = rng.standard_normal((2, 2 * 2048 * 2048), dtype=np.float32).view(
        np.complex64)                               # (2, 2**22): 1-D
    s = np.arange(SERVE_FDAS_N) / SERVE_FDAS_N
    # FDAS request i: its own tone (start bin, drift in the bank) in noise.
    tones = [(50000 + 40000 * i, float(4 * i - 6)) for i in range(SERVE_FDAS)]
    xf = [(0.25 * np.cos(2 * np.pi * (k0 * s + 0.5 * z * s * s))
           + 0.5 * rng.standard_normal(SERVE_FDAS_N)).astype(
               np.float32)[None] for k0, z in tones]
    device = torch.device("cuda", 0)
    bank = TemplateBank.linear(zmax=FDAS_ZMAX)
    # Pulsar request i: one (1024, 2**17) filterbank carrying pulsar i.
    dplan = DispersionPlan.from_spec(PULSAR_SPEC, n_trials=PULSAR_TRIALS)
    fbs = _filterbanks(gen, dplan, [(pulsar,) for pulsar in PULSARS])
    xp = [fb.cpu().numpy() for fb in fbs]
    pulsar_refs = [serving_sifted(pulsar_search(
        fb[None], dplan, bank, n_harmonics=PULSAR_HARMONICS)) for fb in fbs]
    del fbs
    pulsar_cells = [{tuple(int(v) for v in row[:3])
                     for row in ref[0].tolist() if row[0] >= 0}
                    for ref in pulsar_refs]
    # Each direct search finds its own pulsar, so the two results differ.
    check(all(cell in cells for cell, cells in zip(
        sorted(PULSAR_CELLS), pulsar_cells))
          and pulsar_cells[0] != pulsar_cells[1],
          f"serving: direct pulsar searches found {pulsar_cells}")
    stage_plan = plan_pulsar_stages(PULSAR_SPEC, dplan, bank,
                                    PULSAR_HARMONICS, TESLA_V100)
    refs = {"c2c": torch.fft.fft(torch.from_numpy(xc).to(device)),
            "r2c": torch.fft.rfft(torch.from_numpy(xr).to(device)),
            "2d": torch.fft.fft2(torch.from_numpy(x2).to(device))}
    fdas_refs = [serving_candidates(fdas_search(
        torch.from_numpy(x).to(device), bank)) for x in xf]
    four_step = ["fft-c2c-axis1", "fft-c2c-t"]
    expected_kernels = {"c2c": ["fft-c2c"], "r2c": ["fft-r2c"],
                        "2d": ["fft-c2c-t", "fft-c2c-t"], "1d": four_step,
                        "fdas": four_step + ["fft-r2c-split", "fft-c2c-mul",
                                             "fft-c2c"],
                        "pulsar": ["dedisperse", *four_step, "fft-r2c-split",
                                   "fft-c2c-mul", "fft-c2c",
                                   "harmonic-sum-plane", "sift-select"]}
    execute_s: list[tuple[str, float]] = []

    def stream_of(key) -> str:
        if key.kind in (KIND_FDAS, KIND_PULSAR):
            return key.kind
        if key.shape:
            return "2d"
        return key.transform if key.n == 4096 else "1d"

    svc = FFTService(TESLA_V100, devices=[device])
    build = svc.cache._build

    def timed_build(key):
        """The cache entry, its function timed to the end of its device
        work, by stream."""
        entry = build(key)

        def fn(x, _fn=entry.fn, _stream=stream_of(key)):
            t0 = time.perf_counter()
            y = _fn(x)
            torch.cuda.synchronize(device)
            execute_s.append((_stream, time.perf_counter() - t0))
            return y
        entry.fn = fn
        return entry

    svc.cache._build = timed_build
    stack_s: list[float] = []
    stack = svc._stack

    def timed_stack(batch, device):
        t0 = time.perf_counter()
        x = stack(batch, device)
        stack_s.append(time.perf_counter() - t0)
        return x

    svc._stack = timed_stack
    reset_launches()
    for wave in range(SERVE_WAVES):
        hits, misses = svc.cache.stats.hits, svc.cache.stats.misses
        del execute_s[:], stack_s[:]
        reqs = [(svc.submit(np.roll(xc, i, axis=0)), "c2c", i)
                for i in range(SERVE_REQUESTS)]
        reqs += [(svc.submit(np.roll(xr, i, axis=0), transform="r2c"), "r2c",
                  i) for i in range(SERVE_REQUESTS)]
        reqs += [(svc.submit(np.roll(x2, i, axis=0), ndim=2), "2d", i)
                 for i in range(SERVE_2D)]
        reqs += [(svc.submit(x, kind=KIND_FDAS, templates=bank.n_templates),
                  "fdas", i) for i, x in enumerate(xf)]
        reqs += [(svc.submit(x, kind=KIND_PULSAR, dm_trials=PULSAR_TRIALS,
                             templates=bank.n_templates,
                             n_harmonics=PULSAR_HARMONICS), "pulsar", i)
                 for i, x in enumerate(xp)]
        if wave == 0:
            reqs.append((svc.submit(x1), "1d", 0))
        t0 = time.perf_counter()
        receipts = svc.drain()
        wall = time.perf_counter() - t0
        check(len(receipts) == len(reqs), f"wave {wave}: "
              f"{len(receipts)} receipts for {len(reqs)} requests")
        worst = 0.0
        for (req, kind, i), r in zip(reqs, receipts):
            check(r.request is req, f"wave {wave}: receipts out of order")
            if kind == "pulsar":
                # Its own direct search: the same candidate cells, and the
                # same statistics to rounding; the stage plan's shares.
                got, want = r.result[0], pulsar_refs[i][0]
                cells = {tuple(int(v) for v in row[:3])
                         for row in got.tolist() if row[0] >= 0}
                _, rel = rel_err(got[:, 4].sort().values,
                                 want[:, 4].sort().values)
                check(tuple(r.result.shape) == (1, 16, 5)
                      and cells == pulsar_cells[i] and rel <= 1e-4,
                      f"wave {wave} pulsar {i}: cells {cells} != "
                      f"{pulsar_cells[i]} or statistics rel {rel:.3e}")
                share = 1 / stage_plan.case.n_rows
                check([(s.name, s.clock_mhz) for s in r.stages]
                      == [(s.name, s.f) for s in stage_plan.report.stages]
                      and all(abs(s.energy_j - m.energy * share)
                              <= 1e-12 * m.energy
                              for s, m in zip(r.stages,
                                              stage_plan.report.stages))
                      and r.realtime_margin == stage_plan.realtime_margin,
                      f"wave {wave} pulsar {i}: stages {r.stages}, margin "
                      f"{r.realtime_margin}")
            elif kind == "fdas":
                # Its own unserved search: the same top cell, and the same
                # candidate powers (rows batched together differ from a
                # row alone by rounding only).
                want = fdas_refs[i][0]
                got = r.result[0]
                check(tuple(r.result.shape) == (1, 16, 3)
                      and torch.equal(got[0, :2], want[0, :2]),
                      f"wave {wave} fdas {i}: top cell {got[0, :2].tolist()}"
                      f" != {want[0, :2].tolist()}")
                _, rel = rel_err(got[:, 2].sort().values,
                                 want[:, 2].sort().values)
                check(rel <= 1e-4, f"wave {wave} fdas {i}: candidate powers "
                      f"rel {rel:.3e}")
            else:
                ref = (torch.fft.fft(torch.from_numpy(x1).to(device))
                       if kind == "1d" else torch.roll(refs[kind], i, 0))
                _, rel = rel_err(r.result, ref)
                check(rel <= PLAN_RTOL["stockham"],
                      f"wave {wave} {kind}: result vs torch.fft rel "
                      f"{rel:.3e}")
                del ref
            worst = max(worst, rel)
            check(r.clock_mhz <= TESLA_V100.f_max
                  and r.energy_j <= r.boost_energy_j,
                  f"wave {wave} {kind}: clock {r.clock_mhz} MHz, energy "
                  f"{r.energy_j} J vs boost {r.boost_energy_j} J")
            check([rec.kernel for rec in r.launches]
                  == expected_kernels[kind],
                  f"wave {wave} {kind}: launches "
                  f"{[rec.kernel for rec in r.launches]}")
        batches = len({r.batch_id for r in receipts})
        stats = svc.cache.stats
        if wave == 0:
            check((stats.misses, stats.plan_builds, stats.sweeps)
                  == (6, 6, 6) and len(svc.cache) == 6,
                  f"wave 0: cache {stats}, {len(svc.cache)} entries")
            key2d = reqs[2 * SERVE_REQUESTS][0].shape_key(TESLA_V100.name)
            key1d = reqs[-1][0].shape_key(TESLA_V100.name)
            e2d, e1d = svc.cache.peek(key2d), svc.cache.peek(key1d)
            check(key2d.n == key1d.n and key2d != key1d
                  and e2d is not None and e1d is not None and e2d is not e1d
                  and e2d.plan.algorithm == "plan-graph"
                  and e1d.plan.algorithm == "four-step",
                  f"wave 0: the 2-D and 1-D keys of {key2d.n} points are "
                  f"not distinct entries")
        else:
            check(stats.misses == misses and stats.hits - hits == batches,
                  f"wave {wave}: {batches} lookups, cache {stats}")
        lat = latency_summary(r.latency for r in receipts)
        transforms = sum(r.request.batch for r in receipts)
        energy = sum(r.energy_j for r in receipts)
        boost = sum(r.boost_energy_j for r in receipts)
        execute = sum(dt for _, dt in execute_s)
        print(f"phase 6: wave {wave}: {len(receipts)} requests, {batches} "
              f"batches, {transforms} transforms; drain {wall * 1e3:.1f} "
              f"ms = stack and copy to the card {sum(stack_s) * 1e3:.1f} "
              f"ms + execute {execute * 1e3:.1f} ms + the rest "
              f"{(wall - execute - sum(stack_s)) * 1e3:.1f} ms; "
              f"{transforms / wall:.1f} transforms/s; latency p50 "
              f"{lat.p50 * 1e3:.1f} ms p99 {lat.p99 * 1e3:.1f} ms; V100 "
              f"model {energy / transforms:.4e} J/transform, I_ef "
              f"{boost / energy:.4f}; max rel err {worst:.3e}; cache "
              f"{stats}")
        for kind in ("c2c", "r2c", "2d", "fdas", "pulsar", "1d"):
            mine = [r for (_, k, _), r in zip(reqs, receipts) if k == kind]
            if not mine:
                continue
            kl = latency_summary(r.latency for r in mine)
            service = {r.batch_id: r.service_latency for r in mine}
            execute = sum(dt for k, dt in execute_s if k == kind)
            print(f"  wave {wave} {kind}: {len(mine)} requests in "
                  f"{len(service)} batches, service (stack, copy, execute) "
                  f"{sum(service.values()) * 1e3:.1f} ms, execute "
                  f"{execute * 1e3:.1f} ms, latency p50 {kl.p50 * 1e3:.1f} ms")
    launches = launch_counts()
    check(all(launches[k] > 0 for k in ("fft_c2c", "fft_r2c", "fft_c2c_t",
                                        "fft_c2c_mul", "dedisperse",
                                        "harmonic_sum_plane")),
          f"serving launched {launches}")
    pulsar_batches = {r.batch_id for (_, k, _), r in zip(reqs, receipts)
                      if k == "pulsar"}
    check(len(pulsar_batches) == 1, f"serving: the {len(xp)} pulsar "
          f"requests of a wave ran in {len(pulsar_batches)} batches")
    rep = svc.report()
    print(f"phase 6: report: {rep.n_requests} requests, {rep.n_batches} "
          f"batches, {rep.clock_locks} clock locks, "
          f"{rep.throughput_tps:.1f} transforms/s over execution, "
          f"J/transform {rep.joules_per_transform:.4e}, I_ef "
          f"{rep.i_ef:.4f}; launches {launches}")
    SERVE_DATA.update(xc=xc, xr=xr, x2=x2, x1=x1, xf=xf, xp=xp, bank=bank,
                      pulsar_refs=pulsar_refs, pulsar_cells=pulsar_cells,
                      fdas_refs=fdas_refs)
    del svc, refs
    torch.cuda.empty_cache()
    return launches


def _pulsar_stages(fb: torch.Tensor, plan: DispersionPlan,
                   bank: TemplateBank) -> tuple:
    """pulsar_search's steps one by one, each timed with CUDA events:
    returns (stage name -> ms, statistic).  The same calls as
    pulsar_search, in the same order."""
    names = ("dedisp", "mean+r2c", "matched filter", "power",
             "harmonic sum", "sift")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    ev[0].record()
    series = dedisperse_kernel(fb, plan.delays)
    ev[1].record()
    x = series - series.mean(dim=-1, keepdim=True)
    del series
    spectrum = plan_for_length(x.shape[-1], "r2c")(x)
    del x
    sigma2 = (spectrum.real ** 2 + spectrum.imag ** 2).mean(
        dim=-1, keepdim=True)[..., None]
    ev[2].record()
    mf = matched_filter_plane(spectrum, bank)
    ev[3].record()
    power = power_plane(mf, sigma2)
    del mf
    ev[4].record()
    stat, level = harmonic_sum_plane(power, PULSAR_HARMONICS)
    ev[5].record()
    del power
    sift_candidates(stat, level, max_harmonic=PULSAR_HARMONICS)
    ev[6].record()
    ev[6].synchronize()
    return ({name: ev[i].elapsed_time(ev[i + 1])
             for i, name in enumerate(names)}, stat)


def _small_recovery(bank: TemplateBank) -> str:
    """Exact recovery over RIDGE_SEEDS noise draws at the reference test's
    geometry (16 channels x 2048 samples, 8 DM trials) with ``bank``, at
    the pulsar phase's normalised power (C a^2 N / 4): how often the
    candidates are exactly the two injected cells, and where the others
    lie, as (trial, template, bin) offsets from the nearest injected
    cell."""
    spec = FilterbankSpec(nchan=16, ntime=2048)
    plan = DispersionPlan.from_spec(spec, n_trials=8)
    power = PULSAR_SPEC.nchan * PULSAR_AMP ** 2 * PULSAR_SPEC.ntime / 4
    amp = float(np.sqrt(4 * power / (spec.nchan * spec.ntime)))
    pulsars = ((3, 6.0, 300), (6, -12.0, 611))
    drifts = np.array(bank.drifts)
    want = {(d, int(np.argmin(np.abs(drifts - z))), k) for d, z, k in pulsars}
    exact, offsets = 0, []
    for seed in range(RIDGE_SEEDS):
        gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
        fb = _filterbanks(gen, plan, (pulsars,), spec, amp)
        found = _cells(pulsar_search(fb, plan, bank).candidates, 0)
        exact += found == want
        for cell in found - want:
            near = min(want, key=lambda w: (abs(w[0] - cell[0]),
                                            abs(w[2] - cell[2])))
            offsets.append(tuple(a - b for a, b in zip(cell, near)))
    return (f"{exact} of {RIDGE_SEEDS} draws exact at amplitude {amp:.4f} "
            f"(normalised power {power:.1f}); extra cells at offsets "
            f"{sorted(offsets)}")


def phase7_pulsar(gen: torch.Generator) -> dict[str, int]:
    """pulsar_search on 2 filterbanks of 1024 x 2**17 samples, 128 DM
    trials, 85 templates, 8 harmonics; returns the run's launches."""
    spec = PULSAR_SPEC
    plan = DispersionPlan.from_spec(spec, n_trials=PULSAR_TRIALS)
    bank = TemplateBank.linear(zmax=FDAS_ZMAX)
    drifts = np.array(bank.drifts)
    want = {(trial, int(np.argmin(np.abs(drifts - z))), k0)
            for trial, z, k0 in PULSARS}
    check(want == PULSAR_CELLS and bank.n_templates == 85
          and plan.max_delay < spec.ntime,
          f"pulsar geometry: cells {want}, {bank.n_templates} templates, "
          f"largest delay {plan.max_delay}")
    fb = _filterbanks(gen, plan, (PULSARS, ()))
    ledger = LaunchLedger()
    reset_launches()
    with ledger.capture():
        res = pulsar_search(fb, plan, bank, n_harmonics=PULSAR_HARMONICS)
    torch.cuda.synchronize()
    run = launch_counts()
    counts = ledger.counts()
    check(counts == PULSAR_LEDGER,
          f"pulsar: ledger {counts} != {PULSAR_LEDGER}")
    for ledger_name, count in counts.items():
        kernel = LEDGER_TO_KERNEL[ledger_name]
        check(run[kernel] == count, f"pulsar: {kernel} launched "
              f"{run[kernel]} times, the ledger says {count}")
    nbins = spec.ntime // 2 + 1
    shape = (2, plan.n_trials, bank.n_templates, nbins)
    check(tuple(res.stat.shape) == shape == tuple(res.level.shape)
          and bool(torch.isfinite(res.stat).all())
          and bool(torch.isfinite(res.power).all()),
          f"pulsar: bad statistic volume {tuple(res.stat.shape)}")
    found = [_cells(res.candidates, row) for row in (0, 1)]
    check(found[0] == want and not found[1],
          f"pulsar: candidates {found[0]} (want {want}) and {found[1]} on "
          f"the control")
    snr = sorted(round(float(v), 2) for v in res.candidates.snr[0] if v > 0)
    # dedisperse against the gather oracle on 4 DM rows.
    dm_rows = [0, PULSARS[0][0], PULSARS[1][0], plan.n_trials - 1]
    series = dedisperse_kernel(fb, plan.delays)
    _, dd_rel = rel_err(series[:, dm_rows],
                        dedisperse_ref(fb, plan.delay_array()[dm_rows]))
    check(dd_rel <= KERNEL_RTOL, f"pulsar: dedisperse vs dedisperse_ref "
          f"rel err {dd_rel:.3e}")
    del series
    torch.cuda.empty_cache()
    # The statistic and rung against the plane oracle on 64 plane rows,
    # the injected ones among them.
    flat = res.power.reshape(-1, nbins)
    picks = torch.linspace(0, flat.shape[0] - 1, 62).long().tolist()
    picks += [(trial * bank.n_templates + t) for trial, t, _ in want]
    ref_stat, ref_lev = harmonic_sum_plane_ref(flat[picks], PULSAR_HARMONICS)
    _, hs_rel = rel_err(res.stat.reshape(-1, nbins)[picks], ref_stat)
    ladder = harmonic_sum_ref(flat[picks], PULSAR_HARMONICS)
    check(hs_rel <= KERNEL_RTOL and _same_rungs(
        res.level.reshape(-1, nbins)[picks], ref_lev, ladder),
        f"pulsar: plane vs harmonic_sum_plane_ref rel err {hs_rel:.3e} or "
        f"rungs differ")
    del flat, ladder, res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(lambda: pulsar_search(fb, plan, bank,
                                         n_harmonics=PULSAR_HARMONICS),
                   reps=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stage_runs = []
    for _ in range(3):
        stages, stat = _pulsar_stages(fb, plan, bank)
        stage_runs.append(stages)
    del stat
    torch.cuda.empty_cache()
    stages = {k: statistics.median(r[k] for r in stage_runs)
              for k in stage_runs[0]}
    split = device_breakdown(lambda: pulsar_search(
        fb, plan, bank, n_harmonics=PULSAR_HARMONICS))
    missed = sorted(set(LEDGER_TO_KERNEL[k] for k in counts) - set(split))
    # Late in this long process the profiler can record no event of a
    # kernel that a fresh process records (dedisperse here): the CUDA-event
    # time of its one-kernel stage stands in, labelled.
    for kernel in missed:
        if kernel in ONE_KERNEL_STAGE:
            split[f"{kernel} (staged event time)"] = stages[
                ONE_KERNEL_STAGE[kernel]]
    busy = sum(split.values())
    model = plan_pulsar_stages(spec, plan, bank, PULSAR_HARMONICS,
                               TESLA_V100)
    margin = 2 * spec.t_acquire / (ms / 1e3)
    print(f"phase 7: pulsar search, 2 filterbanks of {spec.nchan} x "
          f"{spec.ntime} samples ({spec.t_acquire:.4f} s each), "
          f"{plan.n_trials} DM trials (largest delay {plan.max_delay}), "
          f"{bank.n_templates} templates, {PULSAR_HARMONICS} harmonics; "
          f"ledger {counts}; candidates {sorted(found[0])} (snr {snr}), "
          f"control {sorted(found[1])}; dedisperse vs oracle rel "
          f"{dd_rel:.3e}, plane vs oracle rel {hs_rel:.3e}; search "
          f"{ms:.4f} ms (median of 5), peak memory {peak_gb:.2f} GB")
    print("  pulsar stages (ms, median of 3 staged runs): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f}")
    print("  pulsar device time by kernel (ms, one profiled run): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
          + f"; busy {busy:.4f} of {ms:.4f} ms timed "
          f"(idle share {max(0.0, 1 - busy / ms):.3f}); launched kernels "
          f"the profiler did not record: {missed or 'none'}")
    print(f"  real-time margin S = 2 x {spec.t_acquire:.4f} s / "
          f"{ms / 1e3:.6f} s = {margin:.1f} measured; V100 model "
          f"{model.realtime_margin:.1f} at its per-stage locks "
          f"{model.locked} (modelled batch of {model.case.n_rows} "
          f"filterbanks, I_ef {model.report.i_ef:.4f})")
    del fb
    torch.cuda.empty_cache()
    print(f"  sift at 16 x 2048, 8 trials, {bank.n_templates} templates: "
          f"{_small_recovery(bank)}")
    return run


def phase8_demo(gen: torch.Generator) -> dict[str, int]:
    """The Sec. 5.3 demo at (32, 2**20) with 32 harmonics, C2C and R2C;
    then the spectrum-stats and harmonic-ladder kernels on its spectrum.
    Returns the launches of the kernels' run."""
    shape = DEMO_SHAPE
    b, n, h = shape.batch, shape.n, shape.n_harmonics
    x = randn(gen, b, n)
    for real_input in (False, True):
        kind = "r2c" if real_input else "c2c"
        inp = x.real.contiguous() if real_input else x
        fft = plan_nd((n,), kind)
        y = demo.pulsar_pipeline(inp, h, real_input)
        ref_spec = (torch.fft.rfft(inp) if real_input else torch.fft.fft(inp))
        p = demo.power_spectrum(ref_spec, n)
        ref = demo.candidate_snr(demo.harmonic_sum(p, h),
                                 *demo.spectrum_stats(p))
        del ref_spec, p
        bins = n // 2 + 1 if real_input else n
        _, rel = rel_err(y, ref)
        check(tuple(y.shape) == (b, H.levels(h), bins)
              and bool(torch.isfinite(y).all()) and rel <= 1e-4,
              f"demo {kind}: shape {tuple(y.shape)}, rel err vs the "
              f"torch.fft spectrum {rel:.3e}")
        del y, ref
        torch.cuda.empty_cache()
        ms = median_ms(lambda: demo.pulsar_pipeline(inp, h, real_input),
                       reps=5)
        fft_ms = median_ms(lambda: fft(inp), reps=5)
        total = sum(device_breakdown(
            lambda: demo.pulsar_pipeline(inp, h, real_input)).values())
        fft_busy = sum(device_breakdown(lambda: fft(inp)).values())
        model = demo.fft_time_share(
            dataclasses.replace(shape, real_input=real_input), TESLA_V100)
        print(f"phase 8: demo {kind} {tuple(inp.shape)}, {h} harmonics: "
              f"pipeline {ms:.4f} ms, FFT alone {fft_ms:.4f} ms (share "
              f"of the timed pipeline {fft_ms / ms:.3f}); FFT share of "
              f"device time {fft_busy / total:.3f} ({fft_busy:.4f} of "
              f"{total:.4f} ms) vs the V100 model's {model:.3f}; rel err vs "
              f"a torch.fft spectrum {rel:.3e}")
        del inp
        torch.cuda.empty_cache()
    spec = plan_nd((n,), "c2c")(x)
    del x
    reset_launches()
    p, mean, std = power_spectrum_stats_kernel(spec)
    ladder = harmonic_sum_kernel(p, h)
    torch.cuda.synchronize()
    run = launch_counts()
    check({k: v for k, v in run.items() if v}
          == {"power_spectrum_stats": 1, "harmonic_sum": 1},
          f"demo kernels launched {run}")
    p_demo = demo.power_spectrum(spec, n)
    mean_demo, std_demo = demo.spectrum_stats(p_demo)
    rels = [rel_err(p, p_demo)[1], rel_err(mean, mean_demo[..., 0])[1],
            rel_err(std, std_demo[..., 0])[1]]
    check(max(rels) <= KERNEL_RTOL, f"demo: power_spectrum_stats vs the "
          f"demo's stages rel errs {rels}")
    del spec, p_demo
    _, ladder_rel = rel_err(ladder, harmonic_sum_ref(p, h))
    k = n // h
    _, clamp_rel = rel_err(ladder[..., :k], demo.harmonic_sum(p, h)[..., :k])
    check(ladder_rel <= KERNEL_RTOL and clamp_rel <= KERNEL_RTOL,
          f"demo: harmonic_sum vs the zero-padded oracle rel "
          f"{ladder_rel:.3e}, vs the demo's clamped ladder below n/H rel "
          f"{clamp_rel:.3e}")
    print(f"phase 8: power_spectrum_stats and harmonic_sum on the demo's "
          f"({b}, {n}) spectrum: launches {run}; vs the demo's stages rel "
          f"{max(rels):.3e}; ladder vs the zero-padded oracle rel "
          f"{ladder_rel:.3e}, vs the demo's clamped ladder on k < n/{h} "
          f"rel {clamp_rel:.3e}")
    del p, ladder
    torch.cuda.empty_cache()
    return run


def _grid_clocks(grid: list[int]) -> list[int]:
    """ENERGY_CLOCKS clocks of the card's grid (descending) from f_max down
    to about ENERGY_LOW_FRAC of it."""
    want = np.linspace(grid[0], ENERGY_LOW_FRAC * grid[0], ENERGY_CLOCKS)
    return sorted({min(grid, key=lambda g: abs(g - w)) for w in want},
                  reverse=True)


def _rest_power(handle) -> tuple[float, float, int]:
    """Board power at rest, ENERGY_SETTLE_S after the card's last work (the
    power reading is a windowed average): the mean of 1 s of SAMPLE_S
    samples and the energy counter's rise over its steps in that second
    over their time; with the SM clock then."""
    torch.cuda.synchronize()
    time.sleep(ENERGY_SETTLE_S)
    sm = nvml.sm_clock(handle)
    with nvml.PowerTrace(handle, SAMPLE_S) as trace:
        t0 = time.perf_counter()
        time.sleep(1.0)
        t1 = time.perf_counter()
    check(trace.failed_reads == 0 and bool(trace.power_w),
          f"phase 9: {trace.failed_reads} failed reads at rest")
    ticks = trace.ticks(t0, t1)
    check(len(ticks) >= 2, f"phase 9: the energy counter stepped "
          f"{len(ticks)} times in 1 s at rest")
    (ta, ea), (tb, eb) = ticks[0], ticks[-1]
    return (statistics.fmean(trace.power_w), (eb - ea) / 1e3 / (tb - ta),
            sm)


def _energy_run(handle, plan, x: torch.Tensor) -> dict:
    """``plan(x)`` back to back for ENERGY_WARM_S, then for at least
    ENERGY_RUN_S of device time, with board power, SM clock and the energy
    counter sampled every SAMPLE_S on a host thread.

    The counter steps about every 100 ms, so the runs' mean power is its
    rise between its first and last step inside their device time, over
    the time between those steps, and their energy that power times their
    device time.  The trace's energy is Eq. (3) on the power samples over
    the same device time."""
    est = queued_ms(lambda: plan(x), reps=5)
    warm = math.ceil(ENERGY_WARM_S * 1e3 / est)
    runs = math.ceil(ENERGY_RUN_S * 1e3 / est)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with nvml.PowerTrace(handle, SAMPLE_S) as trace:
        e_before = nvml.energy_mj(handle)
        for _ in range(warm):
            plan(x)
        start.record()
        # At least ``runs``, and on until ENERGY_RUN_S of host time: a run
        # the host paces (a model's decode step) can take less than ``est``
        # once warm, and then its device span follows the host's.
        t_runs, done = time.perf_counter(), 0
        while done < runs or time.perf_counter() - t_runs < ENERGY_RUN_S:
            plan(x)
            done += 1
        runs = done
        stop.record()
        stop.synchronize()
        t_end = time.perf_counter()
        e_after = nvml.energy_mj(handle)
        time.sleep(2 * SAMPLE_S)
    device_s = start.elapsed_time(stop) / 1e3
    t_start = t_end - device_s
    check(e_after > e_before, f"phase 9: the energy counter did not rise "
          f"({e_before} -> {e_after} mJ)")
    check(trace.failed_reads == 0, f"phase 9: {trace.failed_reads} of "
          f"{len(trace.t)} samples failed (NaN power or no counter)")
    ticks = trace.ticks(t_start, t_end)
    check(len(ticks) >= 2, f"phase 9: the energy counter stepped "
          f"{len(ticks)} times in {device_s:.3f} s of runs")
    (ta, ea), (tb, eb) = ticks[0], ticks[-1]
    watts = (eb - ea) / 1e3 / (tb - ta)
    power, dts, sm = trace.window(t_start, t_end)
    trace_j = energy_from_trace(power, dts)
    return {"runs": runs, "ms": device_s * 1e3 / runs, "device_s": device_s,
            "counter_w": watts, "counter_j": watts * device_s,
            "counter_de_j": (eb - ea) / 1e3, "counter_span_s": tb - ta,
            "counter_steps": len(ticks), "trace_j": trace_j,
            "trace_w": trace_j / device_s, "samples": len(power),
            "sm_mhz": statistics.median(sm), "sm_range": (min(sm), max(sm))}


def phase9_energy(gen: torch.Generator) -> dict[str, int]:
    """The paper's experiment on the card: the main path's C2C 1024 and
    8192 and R2C 16384 plans on 2 GB batches, each run back to back under
    the board's energy counter at each clock the driver lets the script
    lock (the H100 model's optimum for each case among them), else at the
    default clocks; J/transform from the counter and from the sampled
    power, beside the H100_SXM model's.  Returns the launches of the
    runs."""
    handle = nvml.device_handle(torch.cuda.current_device())
    grids = nvml.supported_clocks(handle)
    for mem, graphics in grids.items():
        print(f"phase 9: supported clocks at memory {mem} MHz: "
              f"{len(graphics)} graphics clocks {graphics}")
    grid = grids[max(grids)]
    step = min(a - b for a, b in zip(grid, grid[1:]))
    print(f"phase 9: default application clock {nvml.default_clock(handle)} "
          f"MHz; SM clock after phase 8 {nvml.sm_clock(handle)} MHz")
    rest_w, rest_counter_w, rest_sm = _rest_power(handle)
    print(f"phase 9: board power at rest {rest_w:.4f} W (mean of 1 s of "
          f"{SAMPLE_S * 1e3:.0f} ms samples, {ENERGY_SETTLE_S:.0f} s idle, "
          f"SM clock {rest_sm} MHz); energy counter over the same second "
          f"{rest_counter_w:.4f} W")
    cases = []
    for kind, n in ENERGY_CASES:
        case = FFTCase(n, transform=kind)
        plan = plan_for_length(n, kind)
        if kind == "c2c":
            x = randn(gen, case.n_fft, n)
            ref = fft_ref(x)
        else:
            x = torch.randn(case.n_fft, n, device="cuda", generator=gen)
            ref = rfft_ref(x)
        prof = fft_workload(case, H100_SXM)
        if kind == "c2c":
            check(prof.flops == fft_flops(n, n_fft=case.n_fft),
                  f"phase 9: model FLOPs of {case.name} != fft_flops")
        res = sweep(prof, H100_SXM)
        cases.append((kind, n, case, plan, x, ref, prof, res))
    locker = nvml.NvmlClockLocker(handle)
    try:
        with locker.locked(grid[0]):
            pass
        clocks = sorted(set(_grid_clocks(grid))
                        | {int(c[7].optimal.f) for c in cases}, reverse=True)
    except nvml.ClockLockDenied as e:
        print(f"clock_lock: denied ({e})")
        clocks = [None]
    rows: dict[tuple, dict] = {}
    reset_launches()
    for f in clocks:
        lock = contextlib.nullcontext() if f is None else locker.locked(f)
        with lock:
            for kind, n, case, plan, x, ref, prof, res in cases:
                label = f"{kind} n={n}"
                row = _energy_run(handle, plan, x)
                rows[label, f] = row
                _, rel = rel_err(plan(x), ref)
                check(rel <= PLAN_RTOL[plan.algorithm],
                      f"phase 9: {label} at {f or 'default'} MHz: plan vs "
                      f"torch.fft rel err {rel:.3e}")
                if f is not None:
                    check(abs(row["sm_mhz"] - f) <= step,
                          f"phase 9: {label} locked at {f} MHz ran at "
                          f"{row['sm_mhz']} MHz")
                transforms = row["runs"] * case.n_fft
                model = res.at(row["sm_mhz"])
                best = energy_per_transform(res, case.n_fft)
                print(f"phase 9: {label} clock requested "
                      f"{f or 'default'} observed {row['sm_mhz']:.0f} MHz "
                      f"(median of {row['samples']} samples, "
                      f"{row['sm_range'][0]}..{row['sm_range'][1]}): "
                      f"{row['ms']:.4f} ms a batch of {case.n_fft} over "
                      f"{row['runs']} runs ({row['device_s']:.3f} s); "
                      f"counter {row['counter_w']:.2f} W ("
                      f"{row['counter_de_j']:.3f} J over "
                      f"{row['counter_span_s']:.3f} s, "
                      f"{row['counter_steps']} steps), "
                      f"{row['counter_j'] / transforms:.4e} J/transform; "
                      f"trace {row['trace_w']:.2f} W, "
                      f"{row['trace_j'] / transforms:.4e} J/transform; "
                      f"{prof.flops * row['runs'] / row['counter_j'] / 1e9:.3f}"
                      f" GFLOPS/W; rel err {rel:.3e} | H100_SXM model at "
                      f"{model.f:.0f} MHz: {model.time * 1e3:.4f} ms, "
                      f"{model.power:.2f} W, "
                      f"{model.energy / case.n_fft:.4e} J/transform, "
                      f"{model.gflops_per_watt:.3f} GFLOPS/W; model optimum "
                      f"{best['optimal_mhz']:.0f} MHz "
                      f"{best['optimal_j']:.4e} J/transform (boost "
                      f"{best['boost_j']:.4e}), slowdown "
                      f"{res.slowdown:.4f}, power cut "
                      f"{res.power_reduction:.4f}")
    torch.cuda.synchronize()
    run = launch_counts()
    check(run["fft_c2c"] > 0 and run["fft_r2c"] > 0,
          f"phase 9: launches {run}")
    if clocks != [None]:
        for kind, n, case, *_ in cases:
            label = f"{kind} n={n}"
            per = {f: rows[label, f] for f in clocks}
            f_opt = min(per, key=lambda f: per[f]["counter_j"])
            opt, boost = per[f_opt], per[clocks[0]]
            print(f"phase 9: {label} measured optimum {f_opt} MHz against "
                  f"boost {clocks[0]} MHz: time "
                  f"{opt['ms'] / boost['ms'] - 1:+.4f}, power cut "
                  f"{1 - opt['counter_w'] / boost['counter_w']:.4f}, "
                  f"J/transform {opt['counter_j'] / boost['counter_j']:.4f}"
                  f" of boost's")
    del cases
    torch.cuda.empty_cache()
    print(f"phase 9: launches {({k: v for k, v in run.items() if v})}")
    return run


def _tuned_check(kind: str, n: int, batch: int, res) -> None:
    """Hold every survivor the tuner timed against ``torch.fft`` on the
    tuner's own operand, and print each one's time and launches."""
    x = _fft_operand(n, kind, batch, torch.device("cuda"))
    ref = {"c2c": fft_ref, "r2c": rfft_ref, "c2r": irfft_ref}[kind](x)
    for cfg, wall in zip(res.survivors, res.walls):
        with use_tuning(None):
            y = plan_with_config(n, kind, cfg)(x)
        abs_err, rel = rel_err(y, ref)
        del y
        check(rel <= TUNE_RTOL, f"phase 10: {kind} n={n} survivor {cfg} vs "
              f"torch.fft rel err {rel:.3e} > {TUNE_RTOL}")
        launches = []
        for name, l in plan_launches(n, kind, batch, cfg):
            card = (f" (card {K.resident_blocks(name, l)})"
                    if name in ("fft_c2c", "fft_r2c", "fft_c2r") else "")
            launches.append(f"{name} points {l.points} per_block "
                            f"{l.per_block} threads {l.threads} "
                            f"resident_blocks {l.resident_blocks}{card}")
        launches = "; ".join(launches)
        print(f"  {kind} n={n} survivor tile_b={cfg.tile_b} radices="
              f"{cfg.radices} split={cfg.split}: {wall * 1e3:.4f} ms "
              f"(time_fn, CUDA events, min of 3 after 1 warm-up); "
              f"max_abs_err {abs_err:.3e} rel {rel:.3e}; {launches}")
    del x, ref
    torch.cuda.empty_cache()


def _routed(kind: str, n: int, batch: int, cfg) -> dict[str, int]:
    """``plan_for_length(n, kind)`` under the active tuning context, with
    every count set to 0 just before and read just after: the ledger's
    tiles must be the chosen config's per_block, its launch count the
    heuristic plan's, its output within TUNE_RTOL of ``torch.fft``.
    Returns the run's launches."""
    x = _fft_operand(n, kind, batch, torch.device("cuda"))
    reset_launches()
    plan_with_config(n, kind)(x)
    torch.cuda.synchronize()
    heuristic = sum(launch_counts().values())
    plan = plan_for_length(n, kind)
    ledger = LaunchLedger()
    reset_launches()
    with ledger.capture():
        y = plan(x)
    torch.cuda.synchronize()
    run = launch_counts()
    tiles = [r.tile[0] for r in ledger.records]
    want = [l.per_block for _, l in plan_launches(n, kind, batch, cfg)]
    check(tiles == want, f"phase 10: {kind} n={n} routed tiles {tiles}, "
          f"the chosen config {cfg} launches {want}")
    check(sum(run.values()) == heuristic,
          f"phase 10: {kind} n={n} routed launches {run}, heuristic "
          f"{heuristic}")
    _, rel = rel_err(y, {"c2c": fft_ref, "r2c": rfft_ref,
                         "c2r": irfft_ref}[kind](x))
    check(rel <= TUNE_RTOL, f"phase 10: {kind} n={n} routed plan rel err "
          f"{rel:.3e}")
    print(f"  {kind} n={n} routed: ledger tiles {tiles} (chosen per_block "
          f"{want}), launches {({k: v for k, v in run.items() if v})} = "
          f"heuristic's {heuristic}, rel err {rel:.3e}")
    del x, y
    torch.cuda.empty_cache()
    return run


def phase10_tune(gen: torch.Generator) -> dict[str, int]:
    """The autotuner on the card: tune TUNE_KEYS at phase 9's 2 GB batches
    into a cache file in a fresh temporary directory (no user cache is
    read or written), check every survivor, the never-regress rule, the
    zero-measurement replay and the routed plans; print the common config
    and the tuned FDAS segment, run phase 5's search under it; measure
    J/transform of tuned against heuristic where they differ.  Returns the
    launches of the routed plans and the FDAS run."""
    t0 = time.perf_counter()
    launches = {name: 0 for name in launch_counts()}
    cuda = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tune-") as tmp:
        path = os.path.join(tmp, "tune.json")
        cache = TuningCache()
        tuned = {}
        for kind, n in TUNE_KEYS:
            batch = FFTCase(n, transform=kind).n_fft
            res = tune_length(n, kind, objective="energy", cache=cache,
                              model_device=H100_SXM, batch=batch, save=False,
                              device=cuda)
            tuned[kind, n] = (batch, res)
            print(f"phase 10: {kind} n={n} batch {batch}: "
                  f"{res.record.candidates} candidates, "
                  f"{len(res.survivors)} survivors, {res.measurements} "
                  f"timed calls; chosen tile_b={res.config.tile_b} radices="
                  f"{res.config.radices} split={res.config.split} "
                  f"({res.config.source}), {res.record.measured_s * 1e3:.4f}"
                  f" ms against the heuristic's "
                  f"{res.record.heuristic_s * 1e3:.4f}, speedup_vs_heuristic "
                  f"{res.speedup_vs_heuristic:.4f}")
            _tuned_check(kind, n, batch, res)
            check(res.speedup_vs_heuristic >= 1.0,
                  f"phase 10: {kind} n={n} speedup "
                  f"{res.speedup_vs_heuristic} < 1")
        for (kind, n), (batch, res) in tuned.items():
            picks: dict[str, int] = {}
            speedups = []
            for _ in range(TUNE_REPEATS):
                again = tune_length(n, kind, objective="energy",
                                    cache=TuningCache(),
                                    model_device=H100_SXM, batch=batch,
                                    save=False, device=cuda)
                cfg = again.config
                label = (f"tile_b={cfg.tile_b} radices={cfg.radices} "
                         f"split={cfg.split}")
                picks[label] = picks.get(label, 0) + 1
                speedups.append(again.speedup_vs_heuristic)
            print(f"phase 10: {kind} n={n} tuned {TUNE_REPEATS} more times "
                  f"into fresh caches: chosen {picks}; speedup_vs_heuristic "
                  f"{min(speedups):.4f}..{max(speedups):.4f}")
        check(cache.save(path) == path, "phase 10: cache not saved")
        replay = TuningCache.load(path=path)
        for (kind, n), (batch, res) in tuned.items():
            again = tune_length(n, kind, cache=replay, model_device=H100_SXM,
                                batch=batch, save=False, device=cuda)
            check(again.replayed and again.measurements == 0
                  and again.config == res.config,
                  f"phase 10: {kind} n={n} replay {again}")
        print(f"phase 10: replay of {len(tuned)} keys from {len(replay)} "
              f"records of the saved cache: 0 measurements, the same configs")
        with use_tuning(TuningContext(replay)):
            for (kind, n), (batch, res) in tuned.items():
                for kernel, count in _routed(kind, n, batch,
                                             res.config).items():
                    launches[kernel] += count
        common, regret = common_config(replay, model_device=H100_SXM)
        prev = get_tuning_context()
        try:
            ctx = install_common_default(replay, model_device=H100_SXM)
            check(get_tuning_context() is ctx and ctx.common == common,
                  "phase 10: common default not installed")
        finally:
            set_tuning_context(prev)
        print(f"phase 10: common config tile_b={common.tile_b} radices="
              f"{common.radices} ({common.source}), mean regret {regret:.6f}"
              f" (H100_SXM model, {len(tuned)} keys)")
        bank = TemplateBank.linear(zmax=FDAS_ZMAX)
        seg_key = (FDAS_N // 2 + 1, bank.taps, bank.n_templates)
        seg = tune_segment(*seg_key, cache=replay, model_device=H100_SXM,
                           save=False)
        chosen = seg.config.segment
        print(f"phase 10: tuned segment for {seg_key}: nfft {chosen} "
              f"(model {seg.record.score:.6e} J/row) against select_nfft's "
              f"{select_nfft(bank.taps, *seg_key[::2])} "
              f"({seg.record.heuristic_score:.6e}); "
              f"{seg.record.candidates} candidates")
        x = _fdas_series(gen)
        with use_tuning(TuningContext(replay)):
            check(fdas_conv_plan(FDAS_N, bank).nfft == chosen,
                  "phase 10: FDAS plan ignores the tuned segment")
            reset_launches()
            res = fdas_search(x, bank)
            torch.cuda.synchronize()
        for kernel, count in launch_counts().items():
            launches[kernel] += count
        t_hit, b_hit = _fdas_tone("phase 10: fdas", res, bank)
        print(f"phase 10: fdas under the tuned segment {chosen}: tone at "
              f"(template {t_hit}, bin {b_hit})")
        del x, res
        torch.cuda.empty_cache()
    differ = [(kind, n, batch, res) for (kind, n), (batch, res)
              in tuned.items() if not res.config.is_heuristic]
    handle = nvml.device_handle(torch.cuda.current_device())
    for kind, n, batch, res in differ[:TUNE_ENERGY_KEYS]:
        x = _fft_operand(n, kind, batch, cuda)
        rows = {label: _energy_run(handle, plan_with_config(n, kind, cfg), x)
                for label, cfg in (("tuned", res.config), ("heuristic", None))}
        print(f"phase 10: {kind} n={n} J/transform at the default clocks "
              f"(energy counter, {batch} a batch): " + "; ".join(
                  f"{label} {r['counter_j'] / (r['runs'] * batch):.4e} "
                  f"({r['ms']:.4f} ms a batch, {r['counter_w']:.2f} W, SM "
                  f"{r['sm_mhz']:.0f} MHz)" for label, r in rows.items())
              + f" | {_card()}")
        del x
        torch.cuda.empty_cache()
    if not differ:
        print("phase 10: every key kept the heuristic config; no energy run")
    print(f"phase 10: wall time {time.perf_counter() - t0:.2f} s")
    return launches


#: Phase 11, the robust service.  (a) phase 6's wave 0 at full width on
#: ROBUST_SLOTS worker slots of one card under four pinned faults and an
#: SLO that sends the last C2C batch to rung 2 (on the card, the rung-1
#: plan's kernels at boost): the C2C
#: stream is two full 2 GB batches (ROBUST_C2C_BATCHES), submitted last so
#: that only the second crosses the admission threshold; ROBUST_STALL_S is
#: the stall pinned on the FDAS batch.
ROBUST_SLOTS = 2
ROBUST_C2C_BATCHES = 2
ROBUST_STALL_S = 0.05
#: (b) the reference's chaos stream (benchmarks/run.py): CHAOS_REQUESTS in
#: waves of CHAOS_WAVE on CHAOS_SLOTS worker slots of one card, twice, and
#: its first CHAOS_CPU_REQUESTS on as many CPU slots.  The admission
#: controller reads SLO deadlines against modelled seconds, never a clock,
#: so the reference harness's deadlines (``_run_chaos`` 7e-6 s,
#: ``_run_recovery`` 6e-5 s, set on its TPU_V5E model of REF_HBM_BANDWIDTH)
#: are scaled by the two models' HBM bandwidths to give the H100_SXM model
#: the same pressure; one more run prints the mix at the unscaled 7e-6 s.
CHAOS_REQUESTS = 8192
CHAOS_WAVE = 512
CHAOS_SLOTS = 4
CHAOS_CPU_REQUESTS = 1024
REF_HBM_BANDWIDTH = 819e9
REF_CHAOS_DEADLINE_S = 7e-6
CHAOS_DEADLINE_S = REF_CHAOS_DEADLINE_S * REF_HBM_BANDWIDTH \
    / H100_SXM.hbm_bandwidth
#: (c) crash recovery at the reference harness's arrival rate and wave
#: period (``_run_recovery``) and its deadline, scaled as above:
#: RECOVERY_REQUESTS of the chaos stream in Poisson arrival waves (one
#: drain every RECOVERY_PERIOD_S of arrival time), two CRASH_PROCESS
#: arrivals, one KILL_HOST on a batch the run reaches, 2 simulated hosts
#: of 2 worker slots, a snapshot after every wave.  16384 requests make
#: five waves at that period, so that a snapshot falls between the two
#: crashes.
RECOVERY_REQUESTS = 16384
RECOVERY_RATE_HZ = 1e5
RECOVERY_PERIOD_S = 4e-2
RECOVERY_DEADLINE_S = 6e-5 * REF_HBM_BANDWIDTH / H100_SXM.hbm_bandwidth
RECOVERY_CRASHES = 2
RECOVERY_HOST_KILL_BATCHES = (10,)
#: (d) drains of one chaos wave timed with and without the tracer.
TRACE_REPS = 3
#: The receipt fields a replayed receipt must carry bit for bit.
RECEIPT_FIELDS = ("status", "reason", "rung", "retries", "batch_id",
                  "worker", "clock_mhz", "modelled_time_s", "energy_j",
                  "boost_energy_j", "measured_energy_j", "realtime_margin")
#: Phase 6 keeps its payloads, references and candidate cells here for
#: phase 11.
SERVE_DATA: dict = {}


def _chaos_pool(seed: int) -> dict:
    """The reference chaos harness's payload pool (benchmarks/run.py): one
    array per distinct request shape, resubmitted, never mutated."""
    rng = np.random.default_rng(seed)

    def cplx(shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    def real(shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "fft": {(n, b): cplx((b, n))
                for n in (256, 512, 1024) for b in (1, 2, 3, 4)},
        "r2c": {b: real((b, 512)) for b in (1, 2)},
        "fft2": cplx((2, 64, 64)),
        "fdas": real((1, 1024)),
        "pulsar": real((4, 256)),
    }


def _chaos_payload(i: int, pool: dict):
    """Payload and submit kwargs of request ``i`` of the mixed stream (a
    pure function of (i, pool), as recovery needs)."""
    if i % 997 == 111:
        return pool["pulsar"], {"kind": "pulsar", "dm_trials": 4,
                                "templates": 3, "n_harmonics": 4}
    if i % 211 == 23:
        return pool["fdas"], {"kind": "fdas", "templates": 3}
    if i % 53 == 17:
        return pool["fft2"], {"ndim": 2}
    if i % 7 == 3:
        return pool["r2c"][1 + i % 2], {"transform": "r2c"}
    return pool["fft"][((256, 512, 1024)[i % 3], 1 + i % 4)], {}


def _digest(rows) -> str:
    """blake2b over (kind, outcome, rung, reason) in submission order."""
    h = hashlib.blake2b(digest_size=16)
    for t in rows:
        h.update(f"{t[0]}:{t[1]}:{t[2]}:{t[3]}".encode() if t is not None
                 else b"MISSING")
    return h.hexdigest()


def _by_rung(receipts) -> dict:
    """Served requests, transforms and J/transform (modelled, measured)
    by rung name."""
    out: dict = {}
    for r in receipts:
        if r.status != "served":
            continue
        g = out.setdefault(rung_name(r.rung), {"n": 0, "transforms": 0,
                                               "j": 0.0, "measured_j": 0.0})
        g["n"] += 1
        g["transforms"] += r.request.batch
        g["j"] += r.energy_j
        g["measured_j"] += r.measured_energy_j or 0.0
    return {k: {"n": g["n"], "j_per_transform": g["j"] / g["transforms"],
                "measured_j_per_transform": g["measured_j"] / g["transforms"]}
            for k, g in sorted(out.items())}


def _chaos_service(devices, plan, seed: int = 0,
                   deadline_s: float = CHAOS_DEADLINE_S) -> FFTService:
    return FFTService(
        H100_SXM, devices=devices, keep_results=False,
        slo=SLOPolicy(default=SLO(deadline_s=deadline_s)),
        fault_plan=plan, drain_deadline_s=300.0,
        telemetry=FleetTelemetry.for_serving(H100_SXM, seed=seed,
                                             fault_plan=plan))


def _chaos_run(n: int, devices, *, seed: int = 0,
               deadline_s: float = CHAOS_DEADLINE_S) -> dict:
    """One open-loop chaos run of the reference harness on ``devices``."""
    pool = _chaos_pool(seed)
    plan = FaultPlan.generate(
        seed, n_batches=max(2 * 8 * (n // CHAOS_WAVE + 1), 16),
        stall_duration_s=0.02)
    scheduled = list(plan.events)
    svc = _chaos_service(devices, plan, seed, deadline_s)
    submitted = []
    t0 = time.perf_counter()
    for start in range(0, n, CHAOS_WAVE):
        for i in range(start, min(start + CHAOS_WAVE, n)):
            x, kw = _chaos_payload(i, pool)
            submitted.append(svc.submit(x, **kw))
        svc.drain()
    wall = time.perf_counter() - t0
    receipts = [svc.receipt(r) for r in submitted]
    shed = [r for r in receipts if r is not None and r.status == "shed"]
    reached = {ev.kind for ev in scheduled
               if ev.batch_id is not None and ev.batch_id < svc._next_batch_id}
    return {
        "wall_s": wall, "requests_per_s": n / wall,
        "missing": sum(r is None for r in receipts),
        "digest": _digest(None if r is None else (q.kind, r.outcome, r.rung,
                                                  r.reason)
                          for q, r in zip(submitted, receipts)),
        "outcomes": dict(collections.Counter(
            r.outcome for r in receipts if r is not None)),
        "shed_by_reason": dict(collections.Counter(r.reason for r in shed)),
        "fired": {k: plan.fired_count(k) for k in FAULT_KINDS
                  if plan.fired_count(k)},
        "unfired": sorted(k for k in reached if not plan.fired_count(k)),
        "availability": svc.report().availability,
        "by_rung": _by_rung(r for r in receipts if r is not None),
        "batches": svc._next_batch_id,
    }


def _robust_requests(n_c2c: int):
    """Phase 6's wave 0, the C2C stream last: (stream, index, payload,
    submit kwargs) in submission order."""
    d = SERVE_DATA
    out = [("r2c", i, np.roll(d["xr"], i, axis=0), {"transform": "r2c"})
           for i in range(SERVE_REQUESTS)]
    out += [("2d", i, np.roll(d["x2"], i, axis=0), {"ndim": 2})
            for i in range(SERVE_2D)]
    out += [("fdas", i, x, {"kind": KIND_FDAS,
                            "templates": d["bank"].n_templates})
            for i, x in enumerate(d["xf"])]
    out += [("pulsar", i, x, {"kind": KIND_PULSAR, "dm_trials": PULSAR_TRIALS,
                              "templates": d["bank"].n_templates,
                              "n_harmonics": PULSAR_HARMONICS})
            for i, x in enumerate(d["xp"])]
    out.append(("1d", 0, d["x1"], {}))
    out += [("c2c", i, np.roll(d["xc"], i, axis=0), {}) for i in range(n_c2c)]
    return out


def _robust_plan(device: torch.device):
    """The submission list, its batches (as the service will coalesce
    them), the pinned FaultPlan and the SLO that puts the last C2C batch,
    and only it, above the hard-degrade threshold (rung 2)."""
    batch_bytes = FFTService(H100_SXM, devices=[device]).batch_bytes
    probe = [FFTRequest(x=SERVE_DATA["xc"])]
    per_batch = coalesce(probe * 64, device_name=H100_SXM.name,
                         batch_bytes=batch_bytes)[0].requests
    reqs = _robust_requests(ROBUST_C2C_BATCHES * len(per_batch))
    requests = [FFTRequest(x=x, **kw) for _, _, x, kw in reqs]
    batches = coalesce(requests, device_name=H100_SXM.name,
                       batch_bytes=batch_bytes)
    index = {id(r): k for k, r in enumerate(requests)}
    stream_of = {b.batch_id: reqs[index[id(b.requests[0])]][0]
                 for b in batches}
    first = {}
    for b in batches:
        first.setdefault(stream_of[b.batch_id], []).append(b)
    c2c_a, c2c_b = first["c2c"]
    # Cold admission estimates (the service's cache is empty when its
    # controller runs): the threshold sits between the last request of
    # the first C2C batch and the first of the second.
    est = np.cumsum([r.bytes * AdmissionController.COLD_PASSES
                     / H100_SXM.hbm_bandwidth for r in requests])
    k0 = index[id(c2c_b.requests[0])]
    policy = SLOPolicy(default=SLO(deadline_s=(est[k0 - 1] + est[k0]) / 2,
                                   degrade_at=1.0, degrade_hard_at=1.0,
                                   shed_at=None))
    plan = FaultPlan([
        FaultEvent(KILL_DEVICE, batch_id=c2c_a.batch_id),
        FaultEvent(FAIL_CLOCK_LOCK, batch_id=first["r2c"][0].batch_id),
        FaultEvent(FAIL_PLAN_BUILD, batch_id=first["2d"][0].batch_id),
        FaultEvent(STALL_WORKER, batch_id=first["fdas"][0].batch_id,
                   duration=ROBUST_STALL_S)])
    expected = {b.batch_id: (0, 0, None) for b in batches}
    expected[c2c_a.batch_id] = (0, 1, None)
    expected[c2c_b.batch_id] = (2, 0, "admission:backlog-hard")
    expected[first["r2c"][0].batch_id] = (1, 0, "fault:clock-lock-failed")
    expected[first["2d"][0].batch_id] = (1, 0, "fault:plan-build-failed")
    return reqs, stream_of, policy, plan, expected


def _robust_check(kind: str, i: int, r, refs: dict, device) -> float:
    """Hold one served result against its reference (phase 6's checks);
    returns its relative error (0 for the candidate streams)."""
    d = SERVE_DATA
    if kind == "pulsar":
        got = r.result[0]
        cells = {tuple(int(v) for v in row[:3])
                 for row in got.tolist() if row[0] >= 0}
        _, rel = rel_err(got[:, 4].sort().values,
                         d["pulsar_refs"][i][0][:, 4].sort().values)
        check(cells == d["pulsar_cells"][i] and rel <= 1e-4,
              f"phase 11: pulsar {i}: cells {cells} != phase 6's "
              f"{d['pulsar_cells'][i]} or statistics rel {rel:.3e}")
        return 0.0
    if kind == "fdas":
        want, got = d["fdas_refs"][i][0], r.result[0]
        _, rel = rel_err(got[:, 2].sort().values, want[:, 2].sort().values)
        check(torch.equal(got[0, :2], want[0, :2]) and rel <= 1e-4,
              f"phase 11: fdas {i}: top cell {got[0, :2].tolist()} != "
              f"{want[0, :2].tolist()} or powers rel {rel:.3e}")
        return 0.0
    ref = refs["1d"] if kind == "1d" else torch.roll(refs[kind], i, 0)
    _, rel = rel_err(r.result, ref)
    check(rel <= PLAN_RTOL["stockham"], f"phase 11: {kind} {i} at rung "
          f"{r.rung}: result vs torch.fft rel {rel:.3e}")
    return rel


def _robust_wave(device: torch.device) -> tuple[FFTService, Tracer]:
    """Part (a): phase 6's wave 0 under the pinned faults on two worker
    slots of ``device``; returns the service and its tracer."""
    reqs, stream_of, policy, plan, expected = _robust_plan(device)
    handle = nvml.device_handle(device.index or 0)
    # Each batch's power is the energy counter's mean over the batch: the
    # wrapper below opens the window at the counter's step before the
    # batch, the service's one telemetry read per batch closes it at the
    # step after.
    sampler = NvmlEnergySampler({w: handle for w in range(ROBUST_SLOTS)})
    telemetry = FleetTelemetry(H100_SXM, sampler)
    tracer = Tracer()
    svc = FFTService(H100_SXM, devices=[device] * ROBUST_SLOTS, slo=policy,
                     fault_plan=plan, tracer=tracer, telemetry=telemetry)
    per_batch: dict[int, tuple[dict, int]] = {}
    window: dict[int, tuple[float, float]] = {}
    execute = svc._execute_batch

    def counted(batch, worker, dev):
        """The batch's own kernel launches, ledger records and energy
        window (its last attempt's, for a batch killed and retried)."""
        before, mark = launch_counts(), len(svc.ledger.records)
        sampler.mark(worker)
        sampler.last.pop(worker, None)
        try:
            execute(batch, worker, dev)
            window[batch.batch_id] = sampler.last.get(
                worker, (math.nan, math.nan))
        finally:
            after = launch_counts()
            per_batch[batch.batch_id] = (
                {k: after[k] - before[k] for k in after
                 if after[k] != before[k]},
                len(svc.ledger.records) - mark)

    svc._execute_batch = counted
    print(f"phase 11: (a) phase 6's wave 0 on {ROBUST_SLOTS} worker slots "
          f"of one card ({device}, the same card twice): {len(reqs)} "
          f"requests, {len(set(stream_of))} batches; faults "
          + ", ".join(f"{ev.kind} on batch {ev.batch_id}"
                      for ev in plan.events)
          + f"; SLO deadline {policy.default.deadline_s:.6e} s (modelled) "
          "puts the last C2C batch at rung 2, on the card the boost "
          "heuristic plan's kernels")
    submitted = [(svc.submit(x, **kw), kind, i) for kind, i, x, kw in reqs]
    t0 = time.perf_counter()
    receipts = svc.drain()
    wall = time.perf_counter() - t0
    check(len(receipts) == len(reqs) and all(
        r.request is q for (q, _, _), r in zip(submitted, receipts)),
          f"phase 11: {len(receipts)} receipts for {len(reqs)} requests")
    def on_card(name):
        return torch.from_numpy(SERVE_DATA[name]).to(device)

    refs = {"c2c": torch.fft.fft(on_card("xc")),
            "r2c": torch.fft.rfft(on_card("xr")),
            "2d": torch.fft.fft2(on_card("x2")),
            "1d": torch.fft.fft(on_card("x1"))}
    worst: dict[int, float] = {}
    for (req, kind, i), r in zip(submitted, receipts):
        check(r.status == "served" and (r.rung, r.retries, r.reason)
              == expected[r.batch_id],
              f"phase 11: {kind} {i} on batch {r.batch_id}: (rung, "
              f"retries, reason) ({r.rung}, {r.retries}, {r.reason!r}) "
              f"!= {expected[r.batch_id]}")
        rel = _robust_check(kind, i, r, refs, device)
        worst[r.batch_id] = max(worst.get(r.batch_id, 0.0), rel)
    del refs
    check(plan.pending() == 0 and svc.stalls_honoured == 1
          and svc.redistributions >= 2,
          f"phase 11: {plan.pending()} faults pending, "
          f"{svc.stalls_honoured} stalls, {svc.redistributions} "
          "redistributions")
    for bid, (launches, records) in sorted(per_batch.items()):
        check(bool(launches) and records > 0,
              f"phase 11: batch {bid} at rung {expected[bid][0]} launched "
              f"{launches}, {records} ledger records")
    by_batch: dict[int, list] = {}
    for r in receipts:
        by_batch.setdefault(r.batch_id, []).append(r)
    # The execute span (the plan and the wait for the card, without the
    # stack and copy) of each batch's last attempt.
    execute_s = {s.attrs["batch_id"]: s.duration for s in tracer.spans
                 if s.name == "execute"}
    for bid, rs in sorted(by_batch.items()):
        r0 = rs[0]
        rows = sum(r.request.batch for r in rs)
        gb = sum(r.request.bytes for r in rs) / 1e9
        launches, records = per_batch[bid]
        measured = sum(r.measured_energy_j for r in rs)
        dt, joules = window[bid]
        print(f"phase 11: (a) batch {bid} {stream_of[bid]}: {len(rs)} "
              f"requests, {rows} rows, {gb:.3f} GB; rung {r0.rung} "
              f"({r0.rung_name}), retries {r0.retries}, reason "
              f"{r0.reason!r}, worker {r0.worker}; service "
              f"{r0.service_latency * 1e3:.3f} ms "
              f"({gb / r0.service_latency:.1f} GB/s), of it execute "
              f"{execute_s[bid] * 1e3:.3f} ms; launches {launches or 'none'}"
              f", {records} ledger records; H100 model "
              f"{sum(r.energy_j for r in rs):.6e} J; "
              f"NVML energy counter over the batch (from the counter's step"
              f" before it to the one after) {joules:.6e} J in "
              f"{dt * 1e3:.3f} ms ({joules / dt:.2f} W), receipts (that mean"
              f" power x modelled time) {measured:.6e} J; max rel err "
              f"{worst[bid]:.3e}")
    rung_rate = {}
    for bid, rs in by_batch.items():
        if stream_of[bid] == "c2c":
            gb = sum(r.request.bytes for r in rs) / 1e9
            rung_rate[rs[0].rung] = (rs[0].service_latency / gb,
                                     execute_s[bid] / gb)
    (s0, e0), (s2, e2) = rung_rate[0], rung_rate[2]
    print(f"phase 11: (a) C2C (4096, 4096) ms per GB, service (execute): "
          f"rung 0 (tuned plan, after one retry) {s0 * 1e3:.3f} "
          f"({e0 * 1e3:.3f}), rung 2 (boost heuristic plan) {s2 * 1e3:.3f} "
          f"({e2 * 1e3:.3f}): {s2 / s0:.2f}x ({e2 / e0:.2f}x) | {_card()}")
    rep = svc.report()
    print(f"phase 11: (a) drain {wall:.3f} s; report: {rep.n_requests} served,"
          f" {rep.degraded} degraded, {rep.retried} retried, "
          f"{rep.redistributions} redistributions, {rep.breaker_opens} "
          f"breaker opens, availability {rep.availability}; watchdog labels "
          f"{rep.telemetry['labels']}; drift {svc.drift.summary()}")
    svc._execute_batch = execute
    return svc, tracer


def _observability(svc: FFTService, tracer: Tracer, device) -> None:
    """Part (d): span counts, flight-recorder snapshots, metrics series,
    and the drain time of one chaos wave with and without a tracer."""
    spans = collections.Counter(s.name for s in tracer.spans)
    snaps = [(s.error_type, s.message) for s in tracer.flight.snapshots]
    check(any(t == "DeviceLostError" for t, _ in snaps),
          f"phase 11: the injected kill took no flight-recorder snapshot: "
          f"{snaps}")
    text = svc.metrics_text()
    names = {line.split("{")[0].split(" ")[0]
             for line in text.splitlines() if line and line[0] != "#"}
    with open(os.path.join(ROOT, "BENCH_obs.json")) as f:
        want = set(json.load(f)["metrics_series"])
    check(want <= names, f"phase 11: metrics_text() lacks {want - names}")
    print(f"phase 11: (d) spans {dict(spans)}; flight-recorder snapshots "
          f"{snaps}; metrics_text() {len(names)} series, every one of "
          f"BENCH_obs.json's {len(want)} among them")
    pool = _chaos_pool(0)
    wave = [_chaos_payload(i, pool) for i in range(CHAOS_WAVE)]
    times: dict[str, list[float]] = {"tracer": [], "none": []}
    services = {mode: FFTService(H100_SXM, devices=[device] * CHAOS_SLOTS,
                                 keep_results=False,
                                 tracer=Tracer() if mode == "tracer" else None)
                for mode in times}
    for rep in range(TRACE_REPS + 1):
        for mode, s in services.items():
            for x, kw in wave:
                s.submit(x, **kw)
            t0 = time.perf_counter()
            s.drain()
            if rep:                               # the first drain warms
                times[mode].append(time.perf_counter() - t0)
    on, off = (statistics.median(times[m]) for m in ("tracer", "none"))
    print(f"phase 11: (d) one chaos wave ({CHAOS_WAVE} requests) drains in "
          f"{on * 1e3:.3f} ms with the tracer, {off * 1e3:.3f} ms without "
          f"(median of {TRACE_REPS}): {(on / off - 1) * 100:+.2f} % | "
          f"{_card()}")


def _recovery_run(device: torch.device, *, seed: int = 0) -> dict:
    """Part (c): benchmarks/run.py's crash-and-recover harness on worker
    slots of ``device``, with a journal in a fresh temporary directory."""
    pool = _chaos_pool(seed)
    n = RECOVERY_REQUESTS
    waves = list(wave_slices(arrival_times(n, seed=seed + 1,
                                           rate_hz=RECOVERY_RATE_HZ),
                             RECOVERY_PERIOD_S))
    topology = HostTopology(CHAOS_SLOTS, devices_per_host=2)
    crash_arrivals = tuple(n * (k + 1) // (RECOVERY_CRASHES + 1)
                           for k in range(RECOVERY_CRASHES))
    jdir = tempfile.mkdtemp(prefix="chip-smoke-journal-")
    append_s = [0.0]
    recover_s: list[float] = []

    def make_plan():
        return FaultPlan.generate(
            seed, n_batches=max(16 * (len(waves) + 1), 64),
            stall_duration_s=0.02, crash_arrivals=crash_arrivals,
            host_kill_batches=RECOVERY_HOST_KILL_BATCHES)

    def timed(journal):
        append = journal.append

        def fn(rtype, data):
            t0 = time.perf_counter()
            seq = append(rtype, data)
            append_s[0] += time.perf_counter() - t0
            return seq
        journal.append = fn
        return journal

    def build(plan, recover_from=None):
        kw = dict(device_spec=H100_SXM, devices=[device] * CHAOS_SLOTS,
                  keep_results=False,
                  slo=SLOPolicy(default=SLO(deadline_s=RECOVERY_DEADLINE_S)),
                  fault_plan=plan, drain_deadline_s=300.0,
                  telemetry=FleetTelemetry.for_serving(
                      H100_SXM, seed=seed, fault_plan=plan),
                  topology=topology)
        if recover_from is None:
            return FFTService(journal=timed(RequestJournal(jdir)), **kw)
        t0 = time.perf_counter()
        svc = FFTService.recover(
            recover_from, payload_fn=lambda ref, meta: _chaos_payload(
                ref, pool)[0], **kw)
        recover_s.append(time.perf_counter() - t0)
        timed(svc.journal)
        return svc

    outcomes: dict[int, tuple] = {}
    live: dict[int, tuple] = {}
    counters = collections.Counter()
    fired = collections.Counter()

    def collect(receipts):
        for r in receipts:
            ref = r.request.payload_ref
            t = (r.request.kind, r.outcome, r.rung, r.reason)
            fields = tuple(getattr(r, f) for f in RECEIPT_FIELDS)
            if r.recovered:
                if ref not in outcomes:
                    outcomes[ref] = t
                    counters["recovered_only"] += 1
                elif live.get(ref) == fields and outcomes[ref] == t:
                    counters["replays_verified"] += 1
                else:
                    counters["replay_mismatches"] += 1
            elif ref in outcomes:
                counters["duplicates"] += 1
            else:
                outcomes[ref] = t
                live[ref] = fields

    def absorb(svc, plan):
        for ev in plan.fired:
            fired[ev.kind] += 1
        counters["host_kills"] += svc.host_kills

    plan = make_plan()
    svc = build(plan)
    crashes = snapshots = 0
    t0 = time.perf_counter()
    for start, stop in waves:
        for i in range(start, stop):
            if plan.take(CRASH_PROCESS, arrival=i) is not None:
                absorb(svc, plan)
                svc.journal.crash()
                crashes += 1
                plan = make_plan()
                svc = build(plan, recover_from=jdir)
                plan.drop_consumed(batch_before=svc._next_batch_id,
                                   arrival_before=i + 1)
                collect(svc.recovered_receipts)
            x, kw = _chaos_payload(i, pool)
            svc.submit(x, payload_ref=i, **kw)
        collect(svc.drain())
        svc.snapshot()
        snapshots += 1
    collect(svc.drain())
    wall = time.perf_counter() - t0
    absorb(svc, plan)
    svc.journal.close()
    audit = ReplayResult(retain=0)
    _, stats = read_journal(jdir, sink=audit.feed)
    shutil.rmtree(jdir, ignore_errors=True)
    return {"waves": len(waves), "crashes": crashes,
            "snapshots": snapshots, "wall_s": wall,
            "lost": n - len(outcomes), "duplicates": counters["duplicates"]
            + audit.duplicate_terminals,
            "replays_verified": counters["replays_verified"],
            "replay_mismatches": counters["replay_mismatches"],
            "recovered_only": counters["recovered_only"],
            "host_kills": counters["host_kills"], "fired": dict(fired),
            "records": stats.records, "invalid": stats.invalid,
            "admits": audit.admits_total, "terminals": audit.terminals_total,
            "open_admits": len(audit.open_admits),
            "incarnations": audit.incarnations,
            "append_s": append_s[0], "recover_s": recover_s,
            "outcomes": dict(collections.Counter(t[1] for t in
                                                 outcomes.values())),
            "rungs": dict(collections.Counter(
                rung_name(t[2]) for t in outcomes.values()
                if t[1] != "shed"))}


def phase11_robust(gen: torch.Generator) -> dict[str, int]:
    """The robust service on the card: (a) phase 6's wave 0 under pinned
    faults and admission pressure, (b) the reference's chaos stream, (c)
    crash recovery from the journal, (d) observability; returns the
    launches of (a), the phase's main path."""
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    reset_launches()
    svc, tracer = _robust_wave(device)
    torch.cuda.synchronize()
    launches = launch_counts()
    print("phase 11: (a) launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    _observability(svc, tracer, device)
    del svc, tracer
    torch.cuda.empty_cache()
    slots = [device] * CHAOS_SLOTS
    reset_launches()
    runs = [_chaos_run(CHAOS_REQUESTS, slots) for _ in range(2)]
    torch.cuda.synchronize()
    chaos_launches = {k: v for k, v in launch_counts().items() if v}
    print(f"phase 11: (b) launches of the two card runs {chaos_launches}")
    check(chaos_launches.get("fft_c2c", 0) > 0,
          f"phase 11: the chaos runs launched {chaos_launches}")
    for k, run in enumerate(runs):
        print(f"phase 11: (b) chaos run {k}: {CHAOS_REQUESTS} requests in "
              f"waves of {CHAOS_WAVE} on {CHAOS_SLOTS} slots of {device}: "
              f"{run['wall_s']:.3f} s, {run['requests_per_s']:.1f} "
              f"requests/s, {run['batches']} batches; outcomes "
              f"{run['outcomes']}; sheds {run['shed_by_reason']}; faults "
              f"fired {run['fired']}; availability {run['availability']}; "
              f"by rung {run['by_rung']}; digest {run['digest']} | {_card()}")
        check(run["missing"] == 0 and run["availability"] == 1.0
              and not run["unfired"],
              f"phase 11: chaos run {k}: {run['missing']} missing, "
              f"availability {run['availability']}, unfired {run['unfired']}")
    unscaled = _chaos_run(CHAOS_REQUESTS, slots,
                          deadline_s=REF_CHAOS_DEADLINE_S)
    print(f"phase 11: (b) deadline {CHAOS_DEADLINE_S:.6e} s (the reference's "
          f"{REF_CHAOS_DEADLINE_S} s x {REF_HBM_BANDWIDTH:.3e} / "
          f"{H100_SXM.hbm_bandwidth:.3e} B/s); at the unscaled "
          f"{REF_CHAOS_DEADLINE_S} s: outcomes {unscaled['outcomes']}, sheds "
          f"{unscaled['shed_by_reason']}, served by rung "
          f"{ {k: v['n'] for k, v in unscaled['by_rung'].items()} }")
    check(runs[0]["digest"] == runs[1]["digest"],
          f"phase 11: chaos digests differ: {runs[0]['digest']} "
          f"{runs[1]['digest']}")
    card = _chaos_run(CHAOS_CPU_REQUESTS, slots)
    cpu = _chaos_run(CHAOS_CPU_REQUESTS, [torch.device("cpu")] * CHAOS_SLOTS)
    print(f"phase 11: (b) first {CHAOS_CPU_REQUESTS} requests: card digest "
          f"{card['digest']} ({card['wall_s']:.3f} s), CPU digest "
          f"{cpu['digest']} ({cpu['wall_s']:.3f} s)")
    check(card["digest"] == cpu["digest"] and card["missing"] == cpu[
        "missing"] == 0, "phase 11: card and CPU chaos digests differ")
    rec = _recovery_run(device)
    print(f"phase 11: (c) recovery: {RECOVERY_REQUESTS} requests in "
          f"{rec['waves']} arrival waves, {rec['crashes']} crashes, "
          f"{rec['host_kills']} host kill, {rec['snapshots']} snapshots; "
          f"lost {rec['lost']}, duplicated {rec['duplicates']}, replays "
          f"verified {rec['replays_verified']} (mismatched "
          f"{rec['replay_mismatches']}, recovered only "
          f"{rec['recovered_only']}); journal {rec['records']} records "
          f"({rec['admits']} admits, {rec['terminals']} terminals, "
          f"{rec['open_admits']} open, {rec['incarnations']} incarnations); "
          f"faults fired {rec['fired']}; outcomes {rec['outcomes']}, served "
          f"by rung {rec['rungs']}; deadline {RECOVERY_DEADLINE_S:.6e} s, "
          f"period {RECOVERY_PERIOD_S} s")
    print(f"phase 11: (c) journal {rec['records'] / rec['wall_s']:.1f} "
          f"records/s over the run ({rec['wall_s']:.3f} s), "
          f"{rec['records'] / rec['append_s']:.1f} records/s inside append; "
          "time to recover (replay + warm cache rebuild) "
          + ", ".join(f"{s * 1e3:.3f} ms" for s in rec["recover_s"])
          + f" | {_card()}")
    check(rec["crashes"] == RECOVERY_CRASHES and rec["host_kills"] == 1
          and rec["lost"] == 0 and rec["duplicates"] == 0
          and rec["replay_mismatches"] == 0 and rec["replays_verified"] > 0
          and rec["invalid"] == 0 and rec["open_admits"] == 0
          and rec["admits"] == rec["terminals"] == RECOVERY_REQUESTS,
          f"phase 11: recovery {rec}")
    print(f"phase 11: wall time {time.perf_counter() - t0:.2f} s")
    return launches


def _collectives_ms(mesh, kind: str, gen: torch.Generator) -> float:
    """Device time [ms] of the pencil's collectives alone on ``mesh``, on
    shards of the pencil's shapes: the two all_to_alls (median of 10 runs
    each), and for R2C the split's two ppermutes."""
    d = mesh.size
    n2 = PENCIL_N2 // 2 if kind == "r2c" else PENCIL_N2
    s = [randn(gen, PENCIL_BATCH, PENCIL_N1 // d, n2) for _ in range(d)]
    t = mesh.all_to_all(s, -1, -2)
    ms = (median_ms(lambda: mesh.all_to_all(s, -1, -2))
          + median_ms(lambda: mesh.all_to_all(t, -2, -1)))
    del t
    if kind == "r2c":
        rev = [(q, d - 1 - q) for q in range(d)]
        roll = [(q, (q + 1) % d) for q in range(d)]
        ms += (median_ms(lambda: mesh.ppermute(s, rev))
               + median_ms(lambda: mesh.ppermute(
                   [v[..., -1:, :] for v in s], roll)))
    del s
    mesh.reset_collective_bytes()
    torch.cuda.empty_cache()
    return ms


def _pencil(gen: torch.Generator, kind: str, card: str) -> dict[str, int]:
    """The pencil of one kind on D = 1 and D = 4 slots of cuda:0 beside
    the 1-D plan at 2**25 and torch.fft; returns its launches."""
    n1, n2, b = PENCIL_N1, PENCIL_N2, PENCIL_BATCH
    n = n1 * n2
    device = torch.device("cuda", 0)
    if kind == "c2c":
        x = randn(gen, b, n1, n2)
        lib, natural = torch.fft.fft, untranspose_ref
        nbytes = 16 * x.numel()
    else:
        x = torch.randn(b, n1, n2, device=device, generator=gen)
        lib, natural = torch.fft.rfft, assemble_rfft_pencil
        nbytes = 4 * x.numel() + 8 * b * (n // 2 + 1)
    flat = x.reshape(b, n)
    ref = lib(flat)
    plan = plan_for_length(n, kind)
    _, rel = rel_err(plan(flat), ref)
    check(rel <= PLAN_RTOL[plan.algorithm],
          f"phase 12: the 1-D {kind} plan at 2**25 rel err {rel:.3e}")
    plan_ms = median_ms(lambda: plan(flat))
    lib_ms = median_ms(lambda: lib(flat))
    torch.cuda.empty_cache()
    print(f"phase 12: {kind} 2**25 x {b}: 1-D plan ({plan.algorithm}) "
          f"{plan_ms:.4f} ms, torch.fft {lib_ms:.4f} ms, function bytes "
          f"{nbytes} ({nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms at HBM rate) "
          f"| {card}")
    launches = {name: 0 for name in launch_counts()}
    first_ms = None
    for d in PENCIL_MESHES:
        mesh = make_mesh((d,), ("model",), devices=[device] * d)
        xs = shard(x, mesh, "model", 1)
        reset_launches()
        mesh.reset_collective_bytes()
        y = pencil_fft(xs, mesh, n1=n1, n2=n2, kind=kind)
        torch.cuda.synchronize()
        run = {k: v for k, v in launch_counts().items() if v}
        moved = mesh.collective_bytes
        check(run == {"fft_c2c_axis1": d, "fft_c2c": d},
              f"phase 12: pencil {kind} D={d} launched {run}")
        for k, v in run.items():
            launches[k] += v
        got = natural(y.gather(), n1, n2)
        del y
        check(bool(torch.isfinite(torch.view_as_real(got)).all()),
              f"phase 12: pencil {kind} D={d}: bad output")
        abs_err, rel = rel_err(got, ref)
        del got
        torch.cuda.empty_cache()
        check(rel <= PLAN_RTOL["four-step"],
              f"phase 12: pencil {kind} D={d} vs torch.fft rel {rel:.3e}")
        exchange = pencil_exchange_bytes(b, n1, n2, d, kind=kind)
        model = pencil_collective_bytes(b, n1, n2, d, kind=kind)
        check(moved == exchange,
              f"phase 12: pencil {kind} D={d} moved {moved} bytes a shard, "
              f"its collectives move {exchange}")
        check(kind == "r2c" or moved == model,
              f"phase 12: pencil {kind} D={d} moved {moved} bytes a shard, "
              f"the reference's model says {model}")

        def run_pencil():
            return pencil_fft(xs, mesh, n1=n1, n2=n2, kind=kind)
        ms = median_ms(run_pencil)
        first_ms = first_ms or ms
        # The most complete of PROFILE_TRIES captures: late in this long
        # run a capture can miss a window's first kernels (a fresh
        # process records them all).
        split = max((device_breakdown(run_pencil, copies=True)
                     for _ in range(PROFILE_TRIES)),
                    key=lambda t: sum(t.values()))
        busy = sum(split.values())
        coll = _collectives_ms(mesh, kind, gen) if d > 1 else 0.0
        print(f"phase 12: pencil {kind} D={d} ({b}, {n1}, {n2}) on {d} "
              f"slots of {device}: {ms:.4f} ms (median of 10), "
              f"{ms / plan_ms:.3f}x the 1-D plan, {ms / lib_ms:.3f}x "
              f"torch.fft, {ms / first_ms:.3f}x D=1; launches {run}; "
              f"max_abs_err {abs_err:.3e} rel {rel:.3e}; collective bytes "
              f"a shard {moved:.1f} (the collectives' own count "
              f"{exchange:.1f}; the reference's pencil_collective_bytes "
              f"{model:.1f}); collectives alone {coll:.4f} ms | {card}")
        print(f"  pencil {kind} D={d} device time (ms, the most complete "
              f"of {PROFILE_TRIES} profiled runs): "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
              + f"; busy {busy:.4f} of {ms:.4f} ms (idle share "
              f"{max(0.0, 1 - busy / ms):.3f})")
        del xs, mesh
        torch.cuda.empty_cache()
    del x, flat, ref
    torch.cuda.empty_cache()
    return launches


def _batch_parallel(gen: torch.Generator, card: str) -> dict[str, int]:
    """batch_parallel_fft on MESH_SLOTS slots of cuda:0 against the
    unsharded plan; returns its launches."""
    device = torch.device("cuda", 0)
    mesh = make_mesh((MESH_SLOTS,), ("data",),
                     devices=[device] * MESH_SLOTS)
    launches = {name: 0 for name in launch_counts()}
    for label, shape, kind, per_shard in BATCH_PARALLEL:
        dims = tuple(range(1, len(shape)))
        if kind == "c2c":
            x = randn(gen, *shape)
            ref = torch.fft.fftn(x, dim=dims)
        else:
            x = torch.randn(*shape, device=device, generator=gen)
            ref = torch.fft.rfftn(x, dim=dims)
        plan = (plan_nd(shape[1:], kind) if len(shape) > 2
                else plan_for_length(shape[-1], kind))
        reset_launches()
        y = batch_parallel_fft(x, mesh, kind=kind)
        torch.cuda.synchronize()
        run = {k: v for k, v in launch_counts().items() if v}
        want = {k: v * MESH_SLOTS for k, v in per_shard.items()}
        check(run == want, f"phase 12: batch-parallel {label} launched "
              f"{run}, expected {want}")
        for k, v in run.items():
            launches[k] += v
        check(tuple(y.shape) == tuple(ref.shape),
              f"phase 12: batch-parallel {label} shape {tuple(y.shape)}")
        abs_err, rel = rel_err(y, ref)
        del y
        _, rel_plain = rel_err(plan(x), ref)
        del ref
        torch.cuda.empty_cache()
        check(rel <= PLAN_RTOL["stockham"] and rel_plain
              <= PLAN_RTOL["stockham"], f"phase 12: batch-parallel {label}"
              f" rel {rel:.3e}, unsharded {rel_plain:.3e}")
        sharded_ms = median_ms(lambda: batch_parallel_fft(x, mesh, kind=kind))
        plain_ms = median_ms(lambda: plan(x))
        print(f"phase 12: batch-parallel {label} {tuple(shape)} on "
              f"{MESH_SLOTS} slots of {device}: {sharded_ms:.4f} ms against "
              f"the unsharded plan's {plain_ms:.4f} ms "
              f"({sharded_ms / plain_ms:.3f}x); launches {run}; "
              f"max_abs_err {abs_err:.3e} rel {rel:.3e} (unsharded "
              f"{rel_plain:.3e}) | {card}")
        del x
        torch.cuda.empty_cache()
    return launches


def _sharded_service(card: str) -> dict[str, int]:
    """Phase 6's 16 C2C (4096, 4096) requests and its (2, 2**22) one,
    served by FFTService(mesh=<MESH_SLOTS slots of cuda:0>) and by the
    unsharded service on cuda:0; returns the sharded run's launches."""
    device = torch.device("cuda", 0)
    xc, x1 = SERVE_DATA["xc"], SERVE_DATA["x1"]
    ref_c2c = torch.fft.fft(torch.from_numpy(xc).to(device))
    ref_1d = torch.fft.fft(torch.from_numpy(x1).to(device))
    mesh = make_mesh((MESH_SLOTS,), ("data",),
                     devices=[device] * MESH_SLOTS)

    def serve(svc: FFTService) -> tuple[list, float, float]:
        reqs = [svc.submit(np.roll(xc, i, axis=0))
                for i in range(SERVE_REQUESTS)]
        reqs.append(svc.submit(x1))
        t0 = time.perf_counter()
        receipts = svc.drain()
        wall = time.perf_counter() - t0
        check(len(receipts) == len(reqs)
              and all(r.request is q for r, q in zip(receipts, reqs)),
              f"phase 12: {len(receipts)} receipts for {len(reqs)} requests")
        worst = 0.0
        for i, r in enumerate(receipts):
            ref = torch.roll(ref_c2c, i, 0) if i < SERVE_REQUESTS else ref_1d
            _, rel = rel_err(r.result, ref)
            del ref
            check(r.status == "served" and rel <= PLAN_RTOL["stockham"],
                  f"phase 12: request {i} {r.status}, rel {rel:.3e}")
            worst = max(worst, rel)
        return receipts, wall, worst

    # In turns (unsharded, sharded, sharded, unsharded): the drains are
    # host-bound, and the host's copies vary run to run.
    runs = []
    launches = None
    for label in ("unsharded", "sharded", "sharded", "unsharded"):
        if label == "sharded":
            svc = FFTService(TESLA_V100, mesh=mesh)
        else:
            svc = FFTService(TESLA_V100, devices=[device])
        if label == "sharded" and launches is None:
            reset_launches()
            runs.append((label, *serve(svc)))
            torch.cuda.synchronize()
            launches = launch_counts()
        else:
            runs.append((label, *serve(svc)))
        del svc
    run = {k: v for k, v in launches.items() if v}
    check(run.get("fft_c2c", 0) > 0 and run.get("fft_c2c_axis1", 0) > 0,
          f"phase 12: the sharded service launched {run}")
    same = ("batch_id", "rung", "clock_mhz", "modelled_time_s", "energy_j",
            "boost_energy_j")
    first = runs[0][1]
    for label, rs, _, _ in runs[1:]:
        for i, (a, b) in enumerate(zip(rs, first)):
            check(all(getattr(a, f) == getattr(b, f) for f in same),
                  f"phase 12: request {i}: {label} "
                  f"{[getattr(a, f) for f in same]} != unsharded "
                  f"{[getattr(b, f) for f in same]}")
    for label, rs, w, err in runs:
        service = {r.batch_id: r.service_latency for r in rs}
        print(f"phase 12: service {label}: {len(rs)} requests in "
              f"{len(service)} batches, drain {w * 1e3:.1f} ms, service "
              f"(stack, copy, execute) "
              + ", ".join(f"{v * 1e3:.1f}" for v in service.values())
              + f" ms; V100 model {sum(r.energy_j for r in rs):.6e} J; "
              f"max rel err {err:.3e} | {card}")
    print(f"phase 12: service launches (first sharded run) {run}; rungs "
          f"{sorted({r.rung for r in first})}, clocks "
          f"{sorted({r.clock_mhz for r in first})} MHz, equal in every run")
    del ref_c2c, ref_1d, runs, first
    torch.cuda.empty_cache()
    return launches


def phase12_distributed(gen: torch.Generator) -> dict[str, int]:
    """The distributed FFT on slots of the card: the pencil, the
    batch-parallel FFT and the sharded service; returns their launches."""
    t0 = time.perf_counter()
    card = _card()
    launches = {name: 0 for name in launch_counts()}
    for part in (lambda: _pencil(gen, "c2c", card),
                 lambda: _pencil(gen, "r2c", card),
                 lambda: _batch_parallel(gen, card),
                 lambda: _sharded_service(card)):
        for kernel, count in part().items():
            launches[kernel] += count
    print(f"phase 12: launches "
          f"{ {k: v for k, v in launches.items() if v} }; wall time "
          f"{time.perf_counter() - t0:.2f} s")
    return launches


def _zoo_cfg(name: str, n_layers: int | None = None, dtype: str = "bfloat16"):
    """``name``'s full-width config at ``n_layers`` (None: its own)."""
    cfg = ZOO_ARCHS[name]
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                               dtype=dtype)


def _zoo_input(cfg, batch: int, seq: int, gen: torch.Generator
               ) -> torch.Tensor:
    if cfg.input_mode == "embeds":
        return torch.randn((batch, seq, cfg.d_model), device="cuda",
                           generator=gen)
    return torch.randint(0, cfg.vocab, (batch, seq), device="cuda",
                         generator=gen)


def _zoo_next(cfg, logits: torch.Tensor, gen: torch.Generator
              ) -> torch.Tensor:
    """The next decode input: the greedy token, or for an embeds-input
    model (its vision frontend is a stub) a fresh embedding."""
    if cfg.input_mode == "embeds":
        return _zoo_input(cfg, logits.shape[0], 1, gen)
    return logits[:, -1, :].argmax(-1)[:, None]


def _specs(tree) -> object:
    """(shape, dtype) of each leaf: tensors or ``cache_shapes`` specs."""
    return tree_map(lambda t: (tuple(t.shape), t.dtype), tree)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _prefill_flops(cfg, params, batch: int, seq: int) -> float:
    """FLOPs of one dense-transformer prefill: 2 per multiply-add of every
    layer weight a token, the chunked attention's full S x S scores and
    PV products (it computes the masked half too), and the last
    position's unembed."""
    layer_params = sum(t.numel() for t in tree_leaves(params["layers"]))
    hd = cfg.resolved_head_dim
    attn = 4.0 * batch * seq * seq * cfg.n_heads * hd * cfg.n_layers
    return (2.0 * batch * seq * layer_params + attn
            + 2.0 * batch * cfg.d_model * cfg.vocab)


def _zoo_serve(card: str, gen: torch.Generator) -> None:
    """qwen2-0.5b served through ``launch.serve`` at full width and depth:
    prefill and decode times, idle share, bytes and FLOP/s against the
    card's peaks, J/token from the energy counter, the DVFS report."""
    name, batch, prompt_len, n_gen = ZOO_SERVE
    argv = ["--arch", name, "--batch", str(batch), "--prompt-len",
            str(prompt_len), "--gen", str(n_gen), "--dvfs-report"]
    t0 = time.perf_counter()
    out = serve.main(argv)
    wall = time.perf_counter() - t0
    check(out.shape == (batch, n_gen), f"phase 13: served {out.shape}")
    check(bool(((out >= 0) & (out < ZOO_ARCHS[name].vocab)).all()),
          "phase 13: served tokens out of the vocabulary")
    print(f"phase 13: serve {' '.join(argv)}: {out.shape} tokens in "
          f"{wall:.3f} s (init and first calls included) on {card}")
    # The same weights and prompt as main's (its seeds), timed by phase.
    cfg = ZOO_ARCHS[name]
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompt = serve.seeded_prompt(cfg, batch, prompt_len, "cuda")
    t0 = time.perf_counter()
    again = serve.generate(model, params, prompt, n_gen)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(np.array_equal(again.cpu().numpy(), out),
          "phase 13: generate() and serve.main() served other tokens")
    logits, cache = model.prefill(params, prompt)
    cache = serve.grow_cache(model, cache, batch, prompt_len, n_gen)
    tok = logits[:, -1, :].argmax(-1)[:, None]
    pre_ms = median_ms(lambda: model.prefill(params, prompt), reps=5)
    dec_ms = median_ms(lambda: model.decode(params, cache, tok), reps=10)

    def chain():
        c, t = cache, tok
        for _ in range(n_gen - 1):
            lg, c = model.decode(params, c, t)
            t = lg[:, -1, :].argmax(-1)[:, None]
    chain_ms = median_ms(chain, reps=3) / (n_gen - 1)
    pre_split = device_breakdown(lambda: model.prefill(params, prompt))
    dec_split = device_breakdown(lambda: model.decode(params, cache, tok))
    pre_busy = sum(pre_split.values())
    dec_busy = sum(dec_split.values())
    weights = _nbytes(params.tree())
    kv = _nbytes(cache)
    dec_bytes = weights + kv
    flops = _prefill_flops(cfg, params, batch, prompt_len)
    print(f"phase 13: {name} bf16 prefill ({batch}, {prompt_len}): "
          f"{pre_ms:.4f} ms, {batch * prompt_len / pre_ms * 1e3:.1f} "
          f"tokens/s; {flops:.4e} FLOP, {flops / pre_ms / 1e9:.2f} TFLOP/s "
          f"= {flops / pre_ms * 1e3 / BF16_FLOPS:.4f} of the bf16 peak "
          f"(bound {flops / BF16_FLOPS * 1e3:.4f} ms); device busy "
          f"{pre_busy:.4f} ms (idle share "
          f"{max(0.0, 1 - pre_busy / pre_ms):.3f}), "
          f"{_device_ops(lambda: model.prefill(params, prompt))} device "
          f"operations")
    print(f"phase 13: {name} bf16 decode step (batch {batch}, cache "
          f"{prompt_len + n_gen}): {dec_ms:.4f} ms one step, "
          f"{chain_ms:.4f} ms a step over {n_gen - 1} chained steps, "
          f"{batch / chain_ms * 1e3:.1f} tokens/s; reads weights {weights} B "
          f"+ KV cache {kv} B = {dec_bytes / dec_ms / 1e9:.2f} GB/s = "
          f"{dec_bytes / dec_ms * 1e3 / HBM_BYTES_PER_S:.4f} of 3.35 TB/s "
          f"(bound {dec_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); device busy "
          f"{dec_busy:.4f} ms of {dec_ms:.4f} (idle share "
          f"{max(0.0, 1 - dec_busy / dec_ms):.3f}), "
          f"{_device_ops(lambda: model.decode(params, cache, tok))} device "
          f"operations")
    print(f"phase 13: {name} generate() {batch} x {n_gen} tokens after a "
          f"{prompt_len}-token prompt: {gen_s * 1e3:.3f} ms wall")
    handle = nvml.device_handle(torch.cuda.current_device())
    energy = {}
    for phase, fn, arg, tokens in (
            ("prefill", lambda p: model.prefill(params, p), prompt,
             batch * prompt_len),
            ("decode", lambda t: model.decode(params, cache, t), tok,
             batch)):
        row = _energy_run(handle, fn, arg)
        energy[phase] = row
        print(f"phase 13: {name} {phase} energy: {row['runs']} runs back "
              f"to back, {row['ms']:.4f} ms each ({row['device_s']:.3f} s), "
              f"counter {row['counter_w']:.2f} W, "
              f"{row['counter_j'] / (row['runs'] * tokens):.4e} J/token; "
              f"trace {row['trace_w']:.2f} W; SM clock "
              f"{row['sm_mhz']:.0f} MHz ({row['sm_range'][0]}.."
              f"{row['sm_range'][1]})")
    phases, rep = serve.dvfs_report(name, batch, prompt_len, n_gen)
    for prof, res in phases:
        row = energy[prof.name]
        print(f"phase 13: {name} {prof.name} DVFS model (H100 SXM, bf16 "
              f"peak): regime {prof.regime(serve.H100_SXM_BF16)!r}, optimal "
              f"{res.optimal.f:.0f} MHz, power cut "
              f"{res.power_reduction:.4f}, slowdown {res.slowdown:.4f}, "
              f"modelled {res.boost.time * 1e3:.4f} ms at boost | measured "
              f"{row['ms']:.4f} ms at {row['sm_mhz']:.0f} MHz, "
              f"{row['counter_w']:.2f} W")
    print(f"phase 13: DVFS model serve pipeline I_ef {rep.i_ef:.4f}, "
          f"slowdown {rep.slowdown:.4f}")
    _zoo_bf16_vs_f32(name, model, params, gen)


def _zoo_bf16_vs_f32(name: str, model, params, gen: torch.Generator) -> None:
    """The same weights in bf16 and in float32 (TF32 off): the greedy
    tokens' agreement and the largest logit gap over a forward."""
    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    p32 = language_model(tree_map(lambda t: t.float(), params.tree()), cfg32)
    inp = _zoo_input(model.cfg, ZOO_BATCH, ZOO_PROMPT, gen)
    with _no_tf32():
        l16, _ = model.forward(params, inp)
        l32, _ = build_model(cfg32).forward(p32, inp)
    check(bool(torch.isfinite(l16).all() and torch.isfinite(l32).all()),
          "phase 13: bf16 or f32 logits not finite")
    agree = (l16.argmax(-1) == l32.argmax(-1)).float().mean().item()
    gap = (l16 - l32).abs().max().item()
    print(f"phase 13: {name} bf16 against f32 (full depth, "
          f"({ZOO_BATCH}, {ZOO_PROMPT}) tokens): greedy tokens agree at "
          f"{agree:.4f} of positions; largest logit gap {gap:.4f} "
          f"({gap / l32.abs().max().item():.4e} of max |logit| "
          f"{l32.abs().max().item():.4f})")
    del p32, l16, l32
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _no_tf32():
    """Float32 matmuls and convolutions at full float32 precision."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _no_drop(cfg):
    """``cfg`` with a MoE capacity factor at which no expert overflows."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=2.0 * cfg.moe.n_experts / cfg.moe.top_k))


def _decode_vs_forward(model, params, inp: torch.Tensor
                       ) -> tuple[float, torch.Tensor]:
    """max |decode - forward| at the last position of ``inp`` over max
    |forward| there, and forward's logits there."""
    full, _ = model.forward(params, inp)
    _, cache = model.prefill(params, inp[:, :-1])
    cache = serve.grow_cache(model, cache, 1, inp.shape[1] - 1, 1)
    dec, _ = model.decode(params, cache, inp[:, -1:])
    want = full[0, -1]
    return ((dec[0, 0] - want).abs().max() / want.abs().max()).item(), want


def _consistency(name: str, model, params, gen: torch.Generator) -> str:
    """Decode = forward at position ZOO_DEC_SEQ - 1 in bf16, and in float32
    (TF32 off) on the same weights, beside bf16 forward against float32
    forward there."""
    cfg = _no_drop(model.cfg)
    inp = _zoo_input(cfg, 1, ZOO_DEC_SEQ, gen)
    err16, fwd16 = _decode_vs_forward(build_model(cfg), params, inp)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = language_model(tree_map(lambda t: t.float(), params.tree()), cfg32)
    with _no_tf32():
        err32, fwd32 = _decode_vs_forward(build_model(cfg32), p32, inp)
    del p32
    torch.cuda.empty_cache()
    gap = ((fwd16 - fwd32).abs().max() / fwd32.abs().max()).item()
    check(err32 <= ZOO_DEC_RTOL, f"phase 13: {name} float32 decode vs "
          f"forward {err32:.4e} of max |logit| > {ZOO_DEC_RTOL}")
    bound16 = max(ZOO_DEC_RTOL, gap)
    check(err16 <= bound16, f"phase 13: {name} bf16 decode vs forward "
          f"{err16:.4e} of max |logit| > {bound16:.4e}")
    line = (f"; decode = forward at position {ZOO_DEC_SEQ - 1}: bf16 "
            f"{err16:.4e} (held to {bound16:.4e}), float32 {err32:.4e} "
            f"(held to {ZOO_DEC_RTOL}) of max |logit|; bf16 forward against "
            f"float32 {gap:.4e}")
    if model.cfg.moe is not None:
        err, _ = _decode_vs_forward(model, params, inp)
        line += (f" at no drop; at the config's capacity factor, bf16 "
                 f"{err:.4e}")
    return line


def _device_ops(fn) -> int:
    """Device operations (kernels, copies, sets) of one run of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.device_type == torch.autograd.DeviceType.CUDA
               for ev in prof.events())


def _busy_wall_ops(fn) -> tuple[float, float, int]:
    """One profiled run of ``fn``: the device's busy ms (its kernels,
    copies and sets summed), the run's own wall ms (CUDA events around
    it) and its device operations, so that the three describe one run.
    A spin kernel first, finished before the run starts, keeps the
    profiler's first milliseconds (see :func:`device_breakdown`)."""
    from torch.profiler import ProfilerActivity, profile
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and "spin_kernel" not in ev.name]
    return (sum(ev.device_time for ev in evs) / 1e3,
            start.elapsed_time(end), len(evs))


def _zoo_arch(name: str, gen: torch.Generator) -> None:
    """One architecture at full width, bf16: prefill, ZOO_DECODE_STEPS
    decode steps, the cache trees against ``cache_shapes``; decode =
    forward for the ZOO_CONSISTENCY ones."""
    cfg = _zoo_cfg(name, ZOO_DEPTH[name])
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = _nbytes(params.tree())
    inp = _zoo_input(cfg, ZOO_BATCH, ZOO_PROMPT, gen)
    logits, cache = model.prefill(params, inp)
    check(tuple(logits.shape) == (ZOO_BATCH, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"phase 13: {name} prefill logits {tuple(logits.shape)} not finite")
    check(_specs(cache) == _specs(model.cache_shapes(ZOO_BATCH, ZOO_PROMPT)),
          f"phase 13: {name} prefill cache != cache_shapes")
    total = ZOO_PROMPT + ZOO_DECODE_STEPS
    cache = serve.grow_cache(model, cache, ZOO_BATCH, ZOO_PROMPT,
                             ZOO_DECODE_STEPS)
    want = _specs(model.cache_shapes(ZOO_BATCH, total))
    check(_specs(cache) == want, f"phase 13: {name} grown cache != "
          f"cache_shapes({ZOO_BATCH}, {total})")
    pre_ms = median_ms(lambda: model.prefill(params, inp), reps=3)
    tok = _zoo_next(cfg, logits, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ZOO_DECODE_STEPS):
        logits, cache = model.decode(params, cache, tok)
        check(tuple(logits.shape) == (ZOO_BATCH, 1, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"phase 13: {name} decode logits not finite")
        check(_specs(cache) == want,
              f"phase 13: {name} decode cache != cache_shapes")
        tok = _zoo_next(cfg, logits, gen)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3 / ZOO_DECODE_STEPS
    depth = ("full depth" if ZOO_DEPTH[name] is None
             else f"cut to {cfg.n_layers} of "
                  f"{ZOO_ARCHS[name].n_layers} layers")
    line = (f"phase 13: {name} bf16 at full width, {depth}: weights "
            f"{weights / 1e9:.3f} GB (init {init_s:.2f} s); prefill "
            f"({ZOO_BATCH}, {ZOO_PROMPT}) {pre_ms:.4f} ms; "
            f"{ZOO_DECODE_STEPS} decode steps {dec_ms:.4f} ms a step "
            f"(host clock); caches equal cache_shapes")
    if name in ZOO_CONSISTENCY:
        line += _consistency(name, model, params, gen)
    print(line)
    del params, cache, logits
    torch.cuda.empty_cache()


def _zoo_card_vs_cpu(name: str, n_layers: int, gen: torch.Generator
                     ) -> None:
    """The same float32 weights (drawn on the card, carried to the CPU
    through ``models.convert``) on cuda:0 and on the CPU, TF32 off."""
    cfg = _zoo_cfg(name, n_layers, "float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    cpu = params_from_reference(params_to_reference(params), cfg, "cpu")
    inp = _zoo_input(cfg, 1, ZOO_CPU_PROMPT, gen)
    with _no_tf32():
        on_card, _ = model.forward(params, inp)
    t0 = time.perf_counter()
    on_cpu, _ = model.forward(cpu, inp.cpu())
    cpu_s = time.perf_counter() - t0
    abs_err, rel = rel_err(on_card.cpu(), on_cpu)
    check(rel <= ZOO_CPU_RTOL, f"phase 13: {name} card vs CPU {rel:.3e}")
    print(f"phase 13: {name} float32 {cfg.n_layers} layers, card = CPU: "
          f"logits (1, {ZOO_CPU_PROMPT}, {cfg.vocab}) max |diff| "
          f"{abs_err:.3e} = {rel:.3e} of max |logit| (CPU forward "
          f"{cpu_s:.2f} s)")
    del params, cpu, on_card, on_cpu
    torch.cuda.empty_cache()


def phase13_zoo(gen: torch.Generator) -> dict[str, int]:
    """The model zoo on the card: qwen2-0.5b served through
    ``launch.serve``; the ten architectures at full width; decode =
    forward; card = CPU; bf16 against f32.  No kernel of the port lies on
    this path: its launch counts, set to 0 just before and read just
    after, stay 0."""
    t0 = time.perf_counter()
    card = _card()
    reset_launches()
    with torch.inference_mode():
        _zoo_serve(card, gen)
        for name in ZOO_DEPTH:
            _zoo_arch(name, gen)
        for name, n_layers in ZOO_CPU.items():
            _zoo_card_vs_cpu(name, n_layers, gen)
    torch.cuda.synchronize()
    run = launch_counts()
    print(f"phase 13: launches of the port's kernels "
          f"{ {k: v for k, v in run.items() if v} }; wall time "
          f"{time.perf_counter() - t0:.2f} s")
    return run


def _train_batches(cfg, batch: int, seq: int, n: int, device="cuda"
                   ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``launch.train``'s batches 0..n-1 (``SyntheticTokens``, seed 0)."""
    ds = SyntheticTokens(cfg.vocab, seq, batch)
    out = []
    for i in range(n):
        b = torch.from_numpy(ds.batch(i)).to(device=device, dtype=torch.long)
        out.append((b[:, :-1], b[:, 1:]))
    return out


def _train_full(card: str) -> None:
    """qwen2-0.5b trained through ``launch.train.main`` at full width and
    depth in bf16: the loss falls, every loss and grad norm is finite; the
    step's time (the driver's wall, synchronised each step; chained),
    tokens/s, idle share and device operations of one profiled step, peak
    memory, FLOP/s against the bf16 peak, J/step from the energy counter
    and the time to save a checkpoint."""
    ckpt_dir = tempfile.mkdtemp(prefix="phase14-")
    try:
        log: list = []
        t0 = time.perf_counter()
        state = train_launch.main(TRAIN_ARGS + ["--ckpt-dir", ckpt_dir,
                                                "--dvfs-report"], log=log)
        wall = time.perf_counter() - t0
        losses = [float(m["loss"]) for m in log]
        norms = [float(m["grad_norm"]) for m in log]
        lrs = [float(m["lr"]) for m in log]
        check(len(log) == 30 and all(map(math.isfinite, losses + norms)),
              f"phase 14: losses {losses} grad norms {norms}")
        first = statistics.fmean(losses[:TRAIN_ENDS])
        last = statistics.fmean(losses[-TRAIN_ENDS:])
        check(last < first, f"phase 14: the loss did not fall: mean of the "
              f"first {TRAIN_ENDS} {first:.4f}, of the last {last:.4f}")
        check(lrs[0] == 0.0 and abs(lrs[-1] - 2.9e-3) < 1e-9,
              f"phase 14: lr {lrs[0]} at step 0, {lrs[-1]} at step 29")
        steps_ms = [m["wall"] * 1e3 for m in log]
        print(f"phase 14: train {' '.join(TRAIN_ARGS)} on {card}: 30 steps "
              f"in {wall:.3f} s (init, first steps and 4 checkpoints "
              f"included); loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean "
              f"of the first {TRAIN_ENDS} {first:.4f}, of the last "
              f"{last:.4f}); grad norm {norms[0]:.4f} -> {norms[-1]:.4f}; "
              f"lr {lrs[0]:.2e} -> {lrs[-1]:.2e}")
        print(f"phase 14: losses {[round(x, 4) for x in losses]}")
        print(f"phase 14: step walls (ms, synchronised) "
              f"{[round(x, 3) for x in steps_ms]}")

        cfg = ZOO_ARCHS["qwen2-0.5b"]
        model = build_model(cfg)
        batch, seq = 8, 128
        step = make_train_step(model, peak_lr=1e-2)
        batches = _train_batches(cfg, batch, seq, TRAIN_CHAINED)
        x, y = batches[0]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        chained = state
        for bx, by in batches:
            chained, metrics = step(chained, bx, by)
        stop.record()
        stop.synchronize()
        chain_ms = start.elapsed_time(stop) / TRAIN_CHAINED
        host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_CHAINED
        check(math.isfinite(float(metrics["loss"])),
              "phase 14: chained steps gave a non-finite loss")
        del chained, metrics
        med = statistics.median(steps_ms[-TRAIN_CHAINED:])
        tokens = batch * seq
        split = device_breakdown(lambda: step(state, x, y))
        busy = sum(split.values())
        ops = _device_ops(lambda: step(state, x, y))
        one_busy, one_wall, one_ops = _busy_wall_ops(
            lambda: step(state, x, y))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step(state, x, y)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        state_b = train_launch.state_bytes(state)
        flops = train_launch.step_flops(step, state, x, y)
        print(f"phase 14: qwen2-0.5b bf16 train step (batch {batch}, seq "
              f"{seq}, {tokens} tokens): {med:.4f} ms median of the last "
              f"{TRAIN_CHAINED} driver walls, {chain_ms:.4f} ms a step over "
              f"{TRAIN_CHAINED} chained steps (host {host_ms:.4f} ms), "
              f"{tokens / chain_ms * 1e3:.1f} tokens/s; device busy "
              f"{busy:.4f} ms of one profiled step (idle share "
              f"{max(0.0, 1 - busy / chain_ms):.3f} of the chained step), "
              f"{ops} device operations")
        print(f"phase 14: one profiled step timed by CUDA events around "
              f"it: busy {one_busy:.4f} of {one_wall:.4f} ms, idle share "
              f"{1 - one_busy / one_wall:.4f}, {one_ops} device operations")
        print(f"phase 14: qwen2-0.5b train step memory: state {state_b} B "
              f"({state_b / 1e9:.3f} GB), allocated before a step "
              f"{before / 1e9:.3f} GB, peak {peak / 1e9:.3f} GB "
              f"(max_memory_allocated)")
        print(f"phase 14: qwen2-0.5b train step {flops:.4e} FLOP "
              f"(FlopCounterMode), {flops / chain_ms / 1e9:.2f} TFLOP/s = "
              f"{flops / chain_ms * 1e3 / BF16_FLOPS:.4f} of the bf16 peak "
              f"(bound {flops / BF16_FLOPS * 1e3:.4f} ms); state read and "
              f"written once {2 * state_b / HBM_BYTES_PER_S * 1e3:.4f} ms "
              f"at 3.35 TB/s")
        handle = nvml.device_handle(torch.cuda.current_device())
        row = _energy_run(handle, lambda inp: step(state, inp, y), x)
        print(f"phase 14: qwen2-0.5b train step energy: {row['runs']} steps "
              f"back to back, {row['ms']:.4f} ms each ({row['device_s']:.3f}"
              f" s), counter {row['counter_w']:.2f} W, "
              f"{row['counter_j'] / row['runs']:.4f} J/step, "
              f"{row['counter_j'] / (row['runs'] * tokens):.4e} J/token; "
              f"trace {row['trace_w']:.2f} W; SM clock {row['sm_mhz']:.0f} "
              f"MHz ({row['sm_range'][0]}..{row['sm_range'][1]})")
        PHASE14.update(step_ms=med, chain_ms=chain_ms, busy_ms=one_busy,
                       wall_ms=one_wall, ops=one_ops, peak=peak,
                       j_step=row["counter_j"] / row["runs"])
        save_dir = os.path.join(ckpt_dir, "timed")
        t0 = time.perf_counter()
        CheckpointManager(save_dir).save(30, state)
        save_s = time.perf_counter() - t0
        n_files = len(os.listdir(os.path.join(save_dir, "step_00000030")))
        print(f"phase 14: checkpoint save of the train state: {save_s:.3f} "
              f"s for {state_b / 1e9:.3f} GB in {n_files} files "
              f"({state_b / save_s / 1e9:.3f} GB/s)")
        del state
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()


def _train_restart() -> None:
    """``FaultTolerantDriver`` on the card with injected failures (reduced
    qwen2, float32): each step appears once, and the replayed losses
    equal the uninterrupted run's."""
    cfg = ZOO_ARCHS["qwen2-0.5b"].reduced()
    model = build_model(cfg)
    step = make_train_step(model)
    batches = _train_batches(cfg, 4, 16, TRAIN_RESTART_STEPS)
    logs = []
    with tempfile.TemporaryDirectory(prefix="phase14-") as tmp:
        for label, fail_at in (("failing", dict(TRAIN_FAIL_AT)),
                               ("uninterrupted", None)):
            state = init_train_state(
                model, torch.Generator(device="cuda").manual_seed(SEED))
            driver = FaultTolerantDriver(
                step, state, lambda i: batches[i],
                CheckpointManager(os.path.join(tmp, label)), ckpt_every=5,
                fail_at=fail_at)
            final, log, restarts = driver.run(TRAIN_RESTART_STEPS)
            logs.append((log, restarts, int(final.step)))
    (log1, restarts, final_step), (log2, _, _) = logs
    check([m["step"] for m in log1] == list(range(TRAIN_RESTART_STEPS))
          and restarts == len(TRAIN_FAIL_AT)
          and final_step == TRAIN_RESTART_STEPS,
          f"phase 14: restart steps {[m['step'] for m in log1]}, "
          f"{restarts} restarts, final step {final_step}")
    l1 = np.array([float(m["loss"]) for m in log1])
    l2 = np.array([float(m["loss"]) for m in log2])
    rel = float(np.abs(l1 - l2).max() / np.abs(l2).max())
    check(rel <= TRAIN_RESTART_RTOL, f"phase 14: replayed losses differ "
          f"from the uninterrupted run's by {rel:.3e}")
    print(f"phase 14: restart on the card (reduced qwen2, failures at "
          f"steps {sorted(TRAIN_FAIL_AT)}): {restarts} restarts, every step "
          f"once; replayed losses against the uninterrupted run's: max "
          f"|diff| {np.abs(l1 - l2).max():.3e} ({int((l1 == l2).sum())} of "
          f"{len(l1)} equal bits)")


def _train_ssm() -> None:
    """mamba2-370m at full width in bf16: TRAIN_SSM_STEPS steps with
    finite losses and gradients (a NaN or inf gradient anywhere makes the
    global norm non-finite); the largest masked difference ``_segsum``
    sees in the first step says whether the reference, which runs ``exp``
    before the mask, would overflow there (above log(float32 max) ~ 88.7)
    and give NaN gradients."""
    cfg = ZOO_ARCHS["mamba2-370m"]
    model = build_model(cfg)
    state = init_train_state(model,
                             torch.Generator(device="cuda").manual_seed(SEED))
    step = make_train_step(model)
    batch, seq = TRAIN_SSM
    batches = _train_batches(cfg, batch, seq, TRAIN_SSM_STEPS)
    seen: list[float] = []
    segsum = mamba2_impl._segsum

    def spy(dacum):
        diff = dacum[..., :, None] - dacum[..., None, :]
        q = dacum.shape[-1]
        upper = torch.ones(q, q, dtype=torch.bool, device=dacum.device).triu(1)
        seen.append(float(diff.detach().masked_select(upper).max()))
        return segsum(dacum)

    rows = []
    for i, (x, y) in enumerate(batches):
        mamba2_impl._segsum = spy if i == 0 else segsum
        try:
            state, metrics = step(state, x, y)
        finally:
            mamba2_impl._segsum = segsum
        rows.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    check(all(math.isfinite(v) for row in rows for v in row),
          f"phase 14: mamba2-370m (loss, grad norm) {rows}")
    top = max(seen)
    limit = math.log(torch.finfo(torch.float32).max)
    print(f"phase 14: mamba2-370m bf16 at full width, batch {batch}, seq "
          f"{seq} (chunk {cfg.ssm.chunk}): {TRAIN_SSM_STEPS} steps, (loss, "
          f"grad norm) {[(round(a, 4), round(b, 4)) for a, b in rows]}, "
          f"every gradient finite; the largest masked _segsum difference "
          f"in step 0 is {top:.4f} (exp overflows float32 above {limit:.4f}:"
          f" the reference's gradient {'would be NaN' if top > limit else 'stays finite'}"
          f" here)")
    del state
    torch.cuda.empty_cache()


def _train_card_vs_cpu() -> None:
    """Reduced float32 models trained on the card (TF32 off) and on the
    CPU from one initial state on the same batches: loss, grad norm,
    parameters and moments within TRAIN_CPU_RTOL; then ``microbatches=2``
    against 1 on the card."""
    for name, n_steps in TRAIN_CPU.items():
        cfg = ZOO_ARCHS[name].reduced()
        model = build_model(cfg)
        cpu = init_train_state(model, torch.Generator().manual_seed(SEED),
                               "cpu")
        card = map_state(lambda t: tree_map(lambda a: a.to("cuda"), t), cpu)
        step = make_train_step(model)
        batches = _train_batches(cfg, 2, 16, n_steps, "cpu")
        worst = 0.0
        with _no_tf32():
            for x, y in batches:
                card, mc = step(card, x.cuda(), y.cuda())
                cpu, mh = step(cpu, x, y)
                for key in ("loss", "grad_norm"):
                    worst = max(worst, rel_err(mc[key].cpu()[None],
                                               mh[key][None])[1])
        # Parameters against the tree's largest |value|: Adam scales each
        # element's step to about lr whatever its gradient, so where the
        # gradient is 0 in exact arithmetic (a key bias: softmax ignores a
        # shift common to every key) rounding noise alone sets the sign of
        # a step the size of lr, on each device its own.
        trees = {}
        for part in ("params", "m", "v"):
            got, want = ((st.params if part == "params"
                          else getattr(st.opt, part)) for st in (card, cpu))
            top = max(b.abs().max().item() for b in tree_leaves(want))
            diff = max((a.cpu() - b).abs().max().item()
                       for a, b in zip(tree_leaves(got), tree_leaves(want)))
            trees[part] = diff / top
        check(max(worst, *trees.values()) <= TRAIN_CPU_RTOL,
              f"phase 14: {name} card vs CPU: metrics {worst:.3e}, trees "
              f"{trees}")
        print(f"phase 14: {name} reduced float32, train steps {n_steps}, "
              f"card = CPU: loss and grad norm each step within "
              f"{worst:.3e}; parameters, m and v within "
              f"{trees['params']:.3e}, {trees['m']:.3e}, {trees['v']:.3e} "
              f"of each tree's largest |value|")
    cfg = ZOO_ARCHS["qwen2-0.5b"].reduced()
    model = build_model(cfg)
    start = init_train_state(model,
                             torch.Generator(device="cuda").manual_seed(SEED))
    (x, y), = _train_batches(cfg, 4, 16, 1)
    with _no_tf32():
        one, m1 = make_train_step(model)(start, x, y)
        two, m2 = make_train_step(model, microbatches=2)(start, x, y)
    worst = max(float((a - b).abs().max() - TRAIN_MB_ATOL
                      - TRAIN_MB_RTOL * b.abs().max())
                for a, b in zip(tree_leaves(two.opt.m), tree_leaves(one.opt.m)))
    loss_rel = abs(float(m2["loss"]) - float(m1["loss"])) / float(m1["loss"])
    check(worst <= 0 and loss_rel <= 1e-3, f"phase 14: microbatches=2 vs 1:"
          f" loss {loss_rel:.3e}, moments over tolerance by {worst:.3e}")
    print(f"phase 14: microbatches=2 against 1 on the card (reduced qwen2, "
          f"batch 4): loss rel {loss_rel:.3e}, first moments within "
          f"rtol={TRAIN_MB_RTOL}, atol={TRAIN_MB_ATOL}")


def phase14_train(gen: torch.Generator) -> dict[str, int]:
    """Training on the card: qwen2-0.5b through ``launch.train`` at full
    width and depth in bf16; restart with injected failures; mamba2-370m
    at full width; card = CPU.  No kernel of the port lies on this path:
    its launch counts, set to 0 just before and read just after, stay 0.
    (``gen`` is unused: every draw here comes from a seeded generator of
    its own, as ``launch.train`` draws.)"""
    t0 = time.perf_counter()
    card = _card()
    reset_launches()
    _train_full(card)
    _train_restart()
    _train_ssm()
    _train_card_vs_cpu()
    torch.cuda.synchronize()
    run = launch_counts()
    check(not any(run.values()), f"phase 14: the port's kernels launched "
          f"{run}")
    print(f"phase 14: launches of the port's kernels "
          f"{ {k: v for k, v in run.items() if v} }; wall time "
          f"{time.perf_counter() - t0:.2f} s")
    return run


def _dry_line(art: dict, path: str) -> None:
    """An artifact's counts, roofline row and DVFS plan, printed."""
    t = roofline_from_artifact(path)
    plan = dvfs_plan(t)
    mem = art["memory"]
    print(f"phase 15: dry run {art['arch']} {art['shape']} {art['mesh']} "
          f"({art['chips']} chips, step batch {art['step_batch']}): "
          f"{art['flops_per_device']:.6e} FLOP, "
          f"{art['hbm_bytes_per_device']:.6e} HBM bytes, "
          f"{art['collective_bytes_per_device']:.6e} collective bytes a "
          f"device {art['collective_breakdown']} by axis "
          f"{art['collective_by_axis']}; args {mem['argument_bytes']} B, "
          f"fits_80gb {mem['fits_80gb']}; counted in {art['lower_s']} s")
    print(f"phase 15: roofline {t.row()}; dvfs on {t.device.name}: optimal "
          f"{plan.optimal.f:.0f} MHz, power cut "
          f"{100 * plan.power_reduction:.1f}%, slowdown "
          f"{100 * plan.slowdown:.2f}%")


def _dry_host(out: str) -> dict:
    """(a): the dry run of DRY_ARCH's cells and of the pencil on both
    production meshes, on the host."""
    arts = {}
    for shape in DRY_CELLS:
        for mp in (False, True):
            path = dryrun.run_one(DRY_ARCH, shape, mp, out)
            with open(path) as f:
                art = json.load(f)
            arts[shape, mp] = art
            _dry_line(art, path)
            ratio = art["flops_per_device"] * art["chips"] / art["model_flops"]
            check(art["memory"]["fits_80gb"] and (
                art["kind"] != "train" or 0.9 <= ratio <= 6),
                f"phase 15: {shape} {art['mesh']}: fits "
                f"{art['memory']['fits_80gb']}, FLOPs / model FLOPs {ratio}")
            check(not mp or art["kind"] != "train"
                  or art["collective_by_axis"]["pod"] > 0,
                  f"phase 15: {shape} {art['mesh']}: no pod-axis bytes")
    for mp in (False, True):
        art = fft_dryrun.lower_pencil(multi_pod=mp)
        path = os.path.join(out, f"fft-pencil__{art['mesh']}.json")
        with open(path, "w") as f:
            json.dump(art, f)
        _dry_line(art, path)
    return arts


def _dry_card(card: str, art: dict) -> None:
    """(b): one data replica's share of DRY_ARCH's train_4k on the card,
    in bf16, against the dry run's meta count."""
    cfg = ZOO_ARCHS[DRY_ARCH]
    batch, seq = art["step_batch"], dryrun.get_shape("train_4k").seq_len
    one = Mesh([torch.device("meta")] * 1, (1, 1), ("data", "model"))
    shape = ShapeSpec("train_4k", seq, batch, "train")
    solo = dryrun.lower_cell(DRY_ARCH, shape, mesh=one)
    check(solo["step_flops"] == art["step_flops"],
          f"phase 15: the 1x1 meta count {solo['step_flops']} differs from "
          f"the 32x8 one {art['step_flops']}")
    model = build_model(cfg)
    state = init_train_state(
        model, torch.Generator(device="cuda").manual_seed(SEED))
    (x, y), = _train_batches(cfg, batch, seq, 1)
    step = make_train_step(model)
    torch.cuda.synchronize()
    flops = train_launch.step_flops(step, state, x, y)
    check(flops == art["step_flops"],
          f"phase 15: FlopCounterMode on the card counts {flops} FLOP, the "
          f"dry run's meta step {art['step_flops']}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _, metrics = step(state, x, y)
    loss = float(metrics["loss"])
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(loss), f"phase 15: the step's loss is {loss}")
    del metrics
    ms = median_ms(lambda: step(state, x, y), reps=DRY_STEPS)
    top, busy, wall = _top_ops(lambda: step(state, x, y))
    useful = model_flops_for(cfg, shape)
    print(f"phase 15: {DRY_ARCH} train_4k, one data replica's share of the "
          f"32x8 mesh ({batch} x {seq} tokens) in bf16 on {card}: "
          f"FlopCounterMode {flops:.6e} FLOP on the card = the dry run's "
          f"meta count {art['step_flops']:.6e}; loss {loss:.4f}; "
          f"{ms:.3f} ms a step (median of {DRY_STEPS}, CUDA events), "
          f"counted FLOPs at {flops / ms / 1e9:.2f} TFLOP/s, model FLOPs "
          f"(6ND) {useful:.6e} = {useful / ms * 1e3 / BF16_FLOPS:.4f} of "
          f"the bf16 peak")
    print(f"phase 15: {DRY_ARCH} train step device time (one profiled "
          f"step, CUDA events around it): busy {busy:.3f} of {wall:.3f} ms "
          f"(idle share {1 - busy / wall:.4f}, not clipped); the ops whose "
          f"kernels take the most: "
          + "; ".join(f"{name} {t:.3f} ms ({n} calls)"
                      for name, t, n in top))
    print(f"phase 15: {DRY_ARCH} train step memory on the card: allocated "
          f"before {before} B, peak {peak} B (max_memory_allocated); the "
          f"dry run's argument bytes on a 1x1 mesh "
          f"{solo['memory']['argument_bytes']} B; peak / arguments "
          f"{peak / solo['memory']['argument_bytes']:.4f}")
    del state
    torch.cuda.empty_cache()


def _top_ops(fn, n: int = DRY_TOP) -> tuple[list, float, float]:
    """The ``n`` aten ops whose kernels take the most device time in one
    profiled run of ``fn`` ((op, ms, calls)), the device's busy ms in that
    run (every CUDA kernel's time summed) and the run's own wall ms (CUDA
    events around it), so that busy and wall describe one run."""
    from torch.profiler import ProfilerActivity, profile
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    busy = sum(ev.device_time for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    ops = sorted((ev for ev in prof.key_averages()
                  if ev.key.startswith("aten::")
                  and ev.self_device_time_total > 0),
                 key=lambda ev: -ev.self_device_time_total)[:n]
    return ([(ev.key, ev.self_device_time_total / 1e3, ev.count)
             for ev in ops], busy, start.elapsed_time(end))


def _dry_pencil(card: str, gen: torch.Generator) -> dict[str, int]:
    """(c): the pencil on DRY_PENCIL_SLOTS model slots of the card at
    DRY_PENCIL_BATCH against torch.fft and the fft dry run's bytes;
    returns its launches."""
    n1, n2, b = PENCIL_N1, PENCIL_N2, DRY_PENCIL_BATCH
    d = DRY_PENCIL_SLOTS
    replicas = 32                            # the (32, 8) mesh's data axis
    want = fft_dryrun.lower_pencil(multi_pod=False, batch=b * replicas)
    mesh = make_mesh((d,), ("model",), devices=[torch.device("cuda", 0)] * d)
    x = randn(gen, b, n1, n2)
    xs = shard(x, mesh, "model", 1)
    reset_launches()
    mesh.reset_collective_bytes()
    y = pencil_fft(xs, mesh, n1=n1, n2=n2)
    torch.cuda.synchronize()
    run = launch_counts()
    moved = mesh.collective_bytes
    check({k: v for k, v in run.items() if v}
          == {"fft_c2c_axis1": d, "fft_c2c": d},
          f"phase 15: the pencil launched {run}")
    got = untranspose_ref(y.gather(), n1, n2)
    del y, xs
    ref = torch.fft.fft(x.reshape(b, n1 * n2))
    abs_err, rel = rel_err(got, ref)
    del got, ref, x
    torch.cuda.empty_cache()
    check(rel <= PLAN_RTOL["four-step"],
          f"phase 15: the pencil vs torch.fft rel {rel:.3e}")
    check(moved == want["collective_bytes_per_device"],
          f"phase 15: the pencil moved {moved} bytes a shard, the fft dry "
          f"run counts {want['collective_bytes_per_device']}")
    print(f"phase 15: pencil c2c ({b}, {n1}, {n2}) on {d} model slots of "
          f"cuda:0: launches { {k: v for k, v in run.items() if v} }; "
          f"max_abs_err {abs_err:.3e} rel {rel:.3e}; collective bytes a "
          f"shard {moved:.1f} = the fft dry run's at batch {b} a replica "
          f"{want['collective_bytes_per_device']:.1f} | {card}")
    return run


def phase15_dryrun(gen: torch.Generator) -> dict[str, int]:
    """The dry run against the card: (a) on the host, (b) the train
    step's FLOPs and memory, (c) the pencil's bytes; returns (c)'s
    launches."""
    t0 = time.perf_counter()
    card = _card()
    out = tempfile.mkdtemp(prefix="phase15-")
    try:
        arts = _dry_host(out)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    _dry_card(card, arts["train_4k", False])
    run = _dry_pencil(card, gen)
    print(f"phase 15: wall time {time.perf_counter() - t0:.2f} s")
    return run


def _mesh_run(card: str, phase: int, mesh_text: str, steps: int,
              arch: str = "qwen2-0.5b", batch: int = 8, seq: int = 128
              ) -> dict[str, float]:
    """``arch`` bf16 through ``launch.train.main --mesh mesh_text`` at
    ``batch`` x ``seq`` (phase 14's 8 x 128 for qwen2-0.5b): the driver's
    steps, then the step (sharded, or the unsharded one on 1x1) timed
    chained, profiled (busy, device operations), its peak memory and
    J/step; on a mesh, one step's collective record held against
    ``train.sharded.accounted_record``.  Returns the numbers."""
    ckpt_dir = tempfile.mkdtemp(prefix=f"phase{phase}-")
    d, m = train_launch.parse_mesh(mesh_text)
    try:
        log: list = []
        t0 = time.perf_counter()
        state = train_launch.main(
            ["--arch", arch, "--batch", str(batch), "--seq",
             str(seq), "--steps", str(steps), "--lr", "1e-2",
             "--ckpt-every", str(10 * steps), "--mesh", mesh_text,
             "--ckpt-dir", ckpt_dir, "--dvfs-report"], log=log)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = [float(x["loss"]) for x in log]
    norms = [float(x["grad_norm"]) for x in log]
    check(len(log) == steps and all(map(math.isfinite, losses + norms)),
          f"phase {phase}: (a) losses {losses} grad norms {norms}")
    walls = [x["wall"] * 1e3 for x in log]
    med = statistics.median(walls[2:])
    print(f"phase {phase}: (a) launch.train --mesh {mesh_text} {arch} "
          f"bf16 (batch {batch} x {seq}, {batch // d} x {seq} a replica, "
          f"{m} model slots a replica) on {card}: {steps} steps in "
          f"{wall:.3f} s (init, state placement and the final checkpoint "
          f"included); losses {[round(x, 4) for x in losses]}; step walls "
          f"(ms, synchronised) {[round(x, 3) for x in walls]}")

    cfg = ZOO_ARCHS[arch]
    model = build_model(cfg)
    mesh = None
    if (d, m) == (1, 1):
        sharded, step = state, make_train_step(model, peak_lr=1e-2)
    else:
        device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh((d, m), ("data", "model"),
                         devices=train_launch.mesh_slots(d * m, device))
        sharded = shard_state(state, model, mesh)
        step = make_sharded_train_step(model, mesh, peak_lr=1e-2)
    batches = _train_batches(cfg, batch, seq, SHARD_CHAINED)
    x, y = batches[0]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    chained = sharded
    for bx, by in batches:
        chained, metrics = step(chained, bx, by)
    stop.record()
    stop.synchronize()
    chain_ms = start.elapsed_time(stop) / SHARD_CHAINED
    check(math.isfinite(float(metrics["loss"])),
          f"phase {phase}: (a) chained steps gave a non-finite loss")
    del chained, metrics
    busy, one_wall, ops = _busy_wall_ops(lambda: step(sharded, x, y))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step(sharded, x, y)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    if mesh is not None:
        mesh.reset_collective_record()
        step(sharded, x, y)
        torch.cuda.synchronize()
        got = mesh.collective_totals()
        want = accounted_record(model, state, mesh, batch // d * seq)
        part = "(c)" if phase == 16 else "(d)"
        check(got == want, f"phase {phase}: {part} record {got} != "
              f"accounting by the formula {want}")
        print(f"phase {phase}: {part} one {mesh_text} step's collective "
              f"record = the accounting (tokens {batch // d * seq} a "
              f"replica) by train.sharded.accounted_record's formulas: by "
              f"kind {got[0]}, by axis {got[1]}")

    # The step takes over a second, so the energy counter's rise over
    # SHARD_ENERGY_STEPS synchronised steps after a warm one (its ~100 ms
    # steps are a few per cent of that span).
    handle = nvml.device_handle(torch.cuda.current_device())
    step(sharded, x, y)
    torch.cuda.synchronize()
    e0, t_e = nvml.energy_mj(handle), time.perf_counter()
    for _ in range(SHARD_ENERGY_STEPS):
        step(sharded, x, y)
    torch.cuda.synchronize()
    e1, t_e = nvml.energy_mj(handle), time.perf_counter() - t_e
    del sharded, state
    torch.cuda.empty_cache()
    return {"step_ms": med, "chain_ms": chain_ms, "busy_ms": busy,
            "wall_ms": one_wall, "ops": ops, "peak": peak, "before": before,
            "j_step": (e1 - e0) / 1e3 / SHARD_ENERGY_STEPS,
            "watts": (e1 - e0) / 1e3 / t_e, "t_e": t_e}


def _beside(run: dict[str, float], label: str, other: dict[str, float]
            ) -> str:
    """``run``'s step numbers beside ``other``'s (``label``)."""
    return (f"{label}: driver wall {other['step_ms']:.4f} "
            f"(x{run['step_ms'] / other['step_ms']:.3f}), chained "
            f"{other['chain_ms']:.4f} "
            f"(x{run['chain_ms'] / other['chain_ms']:.3f}), busy {other['busy_ms']:.4f} of {other['wall_ms']:.4f}, idle "
            f"share {1 - other['busy_ms'] / other['wall_ms']:.4f}, "
            f"{other['ops']} device operations "
            f"(x{run['ops'] / other['ops']:.3f}), peak "
            f"{other['peak'] / 1e9:.3f} GB, {other['j_step']:.4f} J/step "
            f"(x{run['j_step'] / other['j_step']:.3f})")


def _run_line(run: dict[str, float]) -> str:
    return (f"median driver wall {run['step_ms']:.4f} ms; chained "
            f"{run['chain_ms']:.4f} ms; one profiled step timed by CUDA "
            f"events around it: busy {run['busy_ms']:.4f} of "
            f"{run['wall_ms']:.4f} ms, idle share "
            f"{1 - run['busy_ms'] / run['wall_ms']:.4f}, {run['ops']} device "
            f"operations; peak memory {run['peak'] / 1e9:.3f} GB, "
            f"{run['before'] / 1e9:.3f} GB allocated before the step; "
            f"{run['j_step']:.4f} J/step by the energy counter over "
            f"{SHARD_ENERGY_STEPS} steps in {run['t_e']:.3f} s, "
            f"{run['watts']:.2f} W")


def _shard_cost(card: str) -> None:
    """(a) qwen2-0.5b bf16 through ``launch.train.main --mesh 4x1``: the
    driver's steps, then the sharded step timed chained, profiled (busy,
    device operations), its peak memory and J/step, beside phase 14's
    1x1 numbers; (c) one step's collective record against the
    accounting."""
    run = _mesh_run(card, 16, SHARD_MESH, SHARD_STEPS)
    PHASE16.update(run)
    d = int(SHARD_MESH.split("x")[0])
    print(f"phase 16: (a) qwen2-0.5b bf16 step on {SHARD_MESH} ({d} slots of "
          f"the card; the collectives are copies within the card): "
          f"{_run_line(run)}; against "
          f"{_beside(run, '1x1 (phase 14)', PHASE14)}")


def _worst(got, want) -> tuple[float, float, str]:
    """(the largest over the leaves of max |got - want| over the leaf's
    largest |want| (0 where both are 0), the largest of |got - want| -
    atol - rtol |want| at the step tolerance, the path of the leaf with
    the first)."""
    rel, over, where = 0.0, -math.inf, ""
    for (path, a), b in zip(tree_items(got), tree_leaves(want)):
        diff = (a.double() - b.double()).abs()
        top = b.double().abs()
        err = (float(diff.max() / top.max()) if top.max() > 0
               else math.inf if diff.max() > 0 else 0.0)
        if err > rel:
            rel, where = err, path
        over = max(over, float((diff - SHARD_STEP_ATOL
                                - SHARD_STEP_RTOL * top).max()))
    return rel, over, where


def _compare(got, want, m_got, m_want, first: bool, moments: bool = True
             ) -> tuple[bool, str]:
    """Two train states and their metrics after one step (``first``) or
    two, within SHARD_*'s tolerances: (held, a line of the largest
    differences).  Without ``moments`` the first step's moments are
    printed and not held."""
    loss = abs(float(m_got["loss"]) - float(m_want["loss"])) / abs(
        float(m_want["loss"]))
    norm = abs(float(m_got["grad_norm"]) - float(m_want["grad_norm"])) / abs(
        float(m_want["grad_norm"]))
    trees = {"params": _worst(got.params, want.params),
             "m": _worst(got.opt.m, want.opt.m),
             "v": _worst(got.opt.v, want.opt.v)}
    if first:
        held = trees["params"][0] == 0 and (
            not moments or (trees["m"][0] <= SHARD_RTOL
                            and trees["v"][0] <= SHARD_RTOL))
    else:
        held = all(t[1] <= 0 for t in trees.values())
    held = held and loss <= SHARD_LOSS_RTOL and norm <= SHARD_RTOL
    (rp, op, _), (rm, om, wm), (rv, ov, wv) = (trees[k] for k in
                                               ("params", "m", "v"))
    return held, (f"loss rel {loss:.3e}, grad norm rel {norm:.3e}, params / "
                  f"m / v within {rp:.3e} / {rm:.3e} ({wm}) / {rv:.3e} "
                  f"({wv}) of a leaf's largest |value|, margins to the step "
                  f"tolerance {-op:.3e} / {-om:.3e} / {-ov:.3e}")


class _Float64(torch.overrides.TorchFunctionMode):
    """Float32 code run in float64: a float32 dtype argument becomes
    float64 and ``.float()`` ``.double()``; a call that still makes a
    float32, bfloat16 or float16 tensor raises."""

    LOW = (torch.float32, torch.bfloat16, torch.float16)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        wide = lambda a: torch.float64 if a is torch.float32 else a
        if func is torch.Tensor.float:
            func = torch.Tensor.double
        out = func(*map(wide, args),
                   **{k: wide(v) for k, v in (kwargs or {}).items()})
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.dtype in self.LOW:
                raise RuntimeError(f"float64 run: {func} made {t.dtype}")
        return out


@contextlib.contextmanager
def _float64():
    """The port's float32 model and train steps computed in float64:
    :class:`_Float64`, float64 the default dtype, and ``remat`` a plain
    call (a mode does not reach a checkpoint's recompute in the backward;
    the values are the same either way)."""
    old, ckpt = torch.get_default_dtype(), model_common.checkpoint
    torch.set_default_dtype(torch.float64)
    model_common.checkpoint = lambda fn, *args, **kw: fn(*args)
    try:
        with _Float64():
            yield
    finally:
        torch.set_default_dtype(old)
        model_common.checkpoint = ckpt


def _shard_equal(part: str, name: str, d: int, batch: int, seq: int,
                 plain_moments: bool, m: int = 1, phase: int = 16) -> None:
    """(``part``) ``name`` at full width in float32 (TF32 off), two steps
    on a (d, m) mesh of slots of the card from one state and two batches,
    held against the unsharded step with ``microbatches=d``, whose float32
    gradient sum over the row groups is the replicas' (``make_train_step``'s
    arithmetic), within every SHARD_* tolerance; and against the plain
    unsharded step within them.  The first step again in float64
    (:func:`_float64`): the (d, 1) step against the plain one held within
    every first-step tolerance, and each float32 first step against the
    float64 one.  Without ``plain_moments`` the float32 first step's
    moments against plain 1x1 and against float64 are printed, not held:
    mamba2-370m's plain float32 step is itself 3e-4 of a leaf's largest
    |value| from the float64 one (``A_log``, ``conv_w``), so no split of
    its sums holds 1e-4.  The unsharded step with ``microbatches=d``
    against the plain one is printed."""
    cfg = _zoo_cfg(name, dtype="float32")
    model = build_model(cfg)
    state = init_train_state(
        model, torch.Generator(device="cuda").manual_seed(SEED))
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh((d, m), ("data", "model"),
                     devices=train_launch.mesh_slots(d * m, device))
    shape = f"{d}x{m}"
    one_step = make_train_step(model)
    split_step = make_train_step(model, microbatches=d)
    step = make_sharded_train_step(model, mesh)
    batches = _train_batches(cfg, batch, seq, 2)
    x, y = batches[0]
    with _float64():
        wide = map_state(lambda t: tree_map(
            lambda a: a.double() if a.is_floating_point() else a, t), state)
        ref, m_ref = one_step(wide, x, y)
        wide_d, m_wide_d = step(shard_state(wide, model, mesh), x, y)
        wide_d = gather_state(wide_d)
    del wide
    one, split, sharded = state, state, shard_state(state, model, mesh)
    del state
    lines = []

    def hold(label: str, args, first: bool, moments: bool | None) -> None:
        held, text = _compare(*args, first, bool(moments))
        check(held or moments is None,
              f"phase {phase}: ({part}) {name} step {label}: {text}")
        lines.append(f"step {label}: {text}")
    hold(f"0 {shape} = 1x1, both in float64", (wide_d, ref, m_wide_d, m_ref),
         True, True)
    del wide_d
    with _no_tf32():
        for i, (x, y) in enumerate(batches):
            one, m1 = one_step(one, x, y)
            split, ms = split_step(split, x, y)
            sharded, md = step(sharded, x, y)
            got = gather_state(sharded)
            hold(f"{i} {shape} = 1x1 microbatches={d}", (got, split, md, ms),
                 i == 0, True)
            hold(f"{i} {shape} = 1x1", (got, one, md, m1), i == 0,
                 plain_moments or i > 0)
            hold(f"{i} 1x1 microbatches={d} = 1x1", (split, one, ms, m1),
                 i == 0, None)
            if i == 0:
                hold(f"0 {shape} = 1x1 float64", (got, ref, md, m_ref), True,
                     plain_moments)
                hold("0 1x1 = 1x1 float64", (one, ref, m1, m_ref), True,
                     plain_moments)
                del ref
            del got
    print(f"phase {phase}: ({part}) {name} float32 at full width on {shape}, "
          f"2 steps of {batch} x {seq}, and its first step in float64; each "
          f"line held but those printed only (microbatches={d} against 1x1"
          + ("" if plain_moments else ", the float32 first step's moments "
             "against plain 1x1 and float64") + "):")
    for line in lines:
        print(f"phase {phase}: ({part})   {line}")
    del one, split, sharded
    torch.cuda.empty_cache()


def _example(name: str):
    """The example module ``examples/torch/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}",
        os.path.join(ROOT, "examples", "torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_examples() -> dict[str, int]:
    """(e) The five examples with their default arguments on the card,
    each with its launch counts set to 0 just before and read just
    after; returns their sum."""
    total: collections.Counter = collections.Counter()
    for name in EXAMPLES:
        reset_launches()
        t0 = time.perf_counter()
        out = _example(name).main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = launch_counts()
        total.update(run)
        if name == "quickstart":
            check(len(out["sweeps"]) == 6 and run["fft_c2c"] > 0,
                  f"phase 16: (e) quickstart launches {run}")
            note = f"mean optimal {out['mean_optimal'].f_mean:.0f} MHz"
        elif name == "serve_fft":
            rep = out.report()
            check((rep.n_requests, rep.n_transforms) == (7, 17),
                  f"phase 16: (e) serve_fft served {rep.n_requests} "
                  f"requests, {rep.n_transforms} transforms")
            note = (f"{rep.n_batches} batches, "
                    f"{rep.joules_per_transform * 1e6:.2f} uJ/transform "
                    f"(H100 model)")
        elif name == "serve_lm":
            check(tuple(np.asarray(out).shape) == (4, 16),
                  f"phase 16: (e) serve_lm tokens {np.asarray(out).shape}")
            note = "tokens (4, 16)"
        elif name == "train_lm":
            losses = [float(m["loss"]) for m in out]
            first = statistics.fmean(losses[:TRAIN_ENDS])
            last = statistics.fmean(losses[-TRAIN_ENDS:])
            check(last < first and all(map(math.isfinite, losses)),
                  f"phase 16: (e) train_lm loss {first:.4f} -> {last:.4f}")
            note = (f"{len(losses)} steps, mean loss of the first "
                    f"{TRAIN_ENDS} {first:.4f}, of the last {last:.4f}")
        else:
            check(out["peak_bin"] == 96
                  and all(rows and rows[0][:2] == (4.0, 700)
                          for rows in out["fdas"]),
                  f"phase 16: (e) pulsar_pipeline {out}")
            note = "pulsar at bin 96, FDAS drift +4 at bin 700"
        print(f"phase 16: (e) example {name}: {wall:.2f} s, {note}, "
              f"launches { {k: v for k, v in run.items() if v} }")
    shutil.rmtree(os.path.join(tempfile.gettempdir(),
                               "repro_torch_example_ckpt"),
                  ignore_errors=True)
    return dict(total)


def phase16_sharded(gen: torch.Generator) -> dict[str, int]:
    """The sharded train step on data meshes of slots of the card, then
    the five examples; returns the examples' launches (the train steps
    launch none of the port's kernels: their counts, set to 0 before and
    read after, stay 0).  (``gen`` is unused: every draw comes from a
    seeded generator of its own.)"""
    t0 = time.perf_counter()
    card = _card()
    reset_launches()
    _shard_cost(card)
    for case in SHARD_EQUAL:
        _shard_equal(*case)
    torch.cuda.synchronize()
    run = launch_counts()
    check(not any(run.values()), f"phase 16: the port's kernels launched "
          f"{run} in the train steps")
    launches = _run_examples()
    print(f"phase 16: wall time {time.perf_counter() - t0:.2f} s")
    return launches


def _tp_cost(card: str) -> None:
    """(a) qwen2-0.5b bf16 through ``launch.train.main --mesh 2x2``,
    beside phase 16's 4x1 and phase 14's 1x1; (d) one step's record
    against the accounting."""
    run = _mesh_run(card, 17, TP_MESH, TP_STEPS)
    print(f"phase 17: (a) qwen2-0.5b bf16 step on {TP_MESH} (4 slots of the "
          f"card, 2 model slots a replica, 7 query heads and 1 key/value "
          f"head a slot; the collectives are copies within the card): "
          f"{_run_line(run)}; against "
          f"{_beside(run, '4x1 (phase 16)', PHASE16)}; against "
          f"{_beside(run, '1x1 (phase 14)', PHASE14)}")


def _to_host(state: TrainState) -> TrainState:
    """A (gathered) train state's moments on the host, its parameters and
    counters left out (the first step leaves the parameters as they
    were)."""
    host = lambda t: tree_map(lambda a: a.detach().cpu(), t)
    return TrainState(params=None, opt=AdamWState(
        step=state.opt.step, m=host(state.opt.m), v=host(state.opt.v)),
        step=state.step)


def _worst_host(got: TrainState, want: TrainState) -> tuple[float, str]:
    """The largest over the moments' leaves of max |got - want| over the
    leaf's largest |want|, and its path; ``got`` a state, sharded or not,
    gathered a leaf at a time, ``want`` moments on the host, brought to
    ``got``'s device a leaf at a time."""
    worst, where = 0.0, ""
    for part in ("m", "v"):
        mine = dict(tree_items(getattr(got.opt, part)))
        for path, b in tree_items(getattr(want.opt, part)):
            leaf = mine[path]
            a = (leaf if isinstance(leaf, torch.Tensor) else leaf.gather()
                 ).detach().double()
            b = b.to(a.device).double()
            top = float(b.abs().max())
            diff = float((a - b).abs().max())
            err = diff / top if top else (math.inf if diff else 0.0)
            if err > worst:
                worst, where = err, f"{part}/{path}"
    return worst, where


class _Routes:
    """Records the top-k experts of every ``models.moe._dispatch`` call
    (its valid tokens') while active."""

    def __init__(self):
        self.calls: list[torch.Tensor] = []
        self.real = moe_impl._dispatch

    def __enter__(self):
        def spy(params, tg, cfg, *, valid=None, **kw):
            out = self.real(params, tg, cfg, valid=valid, **kw)
            topi = out[2]
            if valid is not None:
                topi = topi[valid.to(topi.device)]
            self.calls.append(topi.reshape(-1, topi.shape[-1]).sort(-1)[0]
                              .cpu())
            return out
        moe_impl._dispatch = spy
        return self

    def __exit__(self, *exc):
        moe_impl._dispatch = self.real


def _first_steps(phase: int, part: str, cfg, batch: int, seq: int,
                 shapes, note: str, record: bool = False) -> None:
    """(``part``) ``cfg`` (float32, at full width) at ``batch`` x ``seq``
    tokens: its first step in float64 on each mesh of ``shapes`` held
    against 1x1 (one microbatch: the sharded step routes an MoE model's
    whole batch's groups, as the reference's does) within F64_RTOL of a
    leaf's largest |value|, the loss and grad norm relative, the
    parameters unchanged; the float64 steps' peak memory; then in float32
    (TF32 off) each mesh's moments against 1x1 and against float64, an
    MoE model's (token, k) routes that differ from 1x1's, printed, and
    with ``record`` each float32 step's collective record held against
    ``train.sharded.accounted_record``."""
    model = build_model(cfg)
    moe = cfg.moe is not None
    spy = _Routes if moe else contextlib.nullcontext
    state = init_train_state(
        model, torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    x, y = _train_batches(cfg, batch, seq, 1)[0]
    device = torch.device("cuda", torch.cuda.current_device())
    meshes = {f"{d}x{m}": make_mesh((d, m), ("data", "model"),
                                    devices=train_launch.mesh_slots(d * m,
                                                                    device))
              for d, m in shapes}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lines = []
    with _float64():
        wide = map_state(lambda t: tree_map(
            lambda a: a.double() if a.is_floating_point() else a, t), state)
        del state
        ref, m_ref = make_train_step(model)(wide, x, y)
        ref = _to_host(ref)
        torch.cuda.empty_cache()
        for shape, mesh in meshes.items():
            got, m_got = make_sharded_train_step(model, mesh)(
                shard_state(wide, model, mesh), x, y)
            params_same = all(
                torch.equal(g.gather(), w)
                for g, w in zip(tree_leaves(got.params),
                                tree_leaves(wide.params)))
            err, where = _worst_host(got, ref)
            loss = abs(float(m_got["loss"]) - float(m_ref["loss"])) / abs(
                float(m_ref["loss"]))
            norm = abs(float(m_got["grad_norm"]) - float(m_ref["grad_norm"])
                       ) / float(m_ref["grad_norm"])
            text = (f"step 0 {shape} = 1x1 in float64: loss rel {loss:.3e}, "
                    f"grad norm rel {norm:.3e}, m / v within {err:.3e} of a "
                    f"leaf's largest |value| ({where}), parameters "
                    f"{'unchanged' if params_same else 'CHANGED'}")
            check(params_same and max(err, loss, norm) <= F64_RTOL,
                  f"phase {phase}: ({part}) {cfg.name} {text}")
            lines.append(text)
            del got
            torch.cuda.empty_cache()
        del wide
    peak64 = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    # The float32 state again from its seed (float64 held the card).
    state = init_train_state(
        model, torch.Generator(device="cuda").manual_seed(SEED))
    with _no_tf32():
        with spy() as routes:
            one, m_one = make_train_step(model)(state, x, y)
        want = routes.calls[0] if moe else None
        one = _to_host(one)
        for shape, mesh in meshes.items():
            mesh.reset_collective_record()
            with spy() as routes:
                got, m_got = make_sharded_train_step(model, mesh)(
                    shard_state(state, model, mesh), x, y)
            d, m = mesh.shape["data"], mesh.shape["model"]
            err, where = _worst_host(got, one)
            err64, where64 = _worst_host(got, ref)
            loss = abs(float(m_got["loss"]) - float(m_one["loss"])) / abs(
                float(m_one["loss"]))
            text = (f"step 0 {shape} float32 (printed): loss rel {loss:.3e} "
                    f"against 1x1, m / v within {err:.3e} ({where}) of "
                    f"1x1's, {err64:.3e} ({where64}) of float64's")
            if moe:
                mine = torch.cat([routes.calls[r * m] for r in range(d)])
                text += (f"; {int((mine != want).sum())} of {want.numel()} "
                         f"(token, k) routes differ from 1x1's")
            if record:
                rec = mesh.collective_totals()
                acc = accounted_record(model, state, mesh, batch // d * seq)
                check(rec == acc, f"phase {phase}: (d) {cfg.name} {shape} "
                      f"record {rec} != accounting by the formula {acc}")
                text += (f"; (d) its collective record = "
                         f"train.sharded.accounted_record: by kind {rec[0]}, "
                         f"by axis {rec[1]}")
            lines.append(text)
            del got
            torch.cuda.empty_cache()
        err, where = _worst_host(one, ref)
        lines.append(f"step 0 1x1 float32 against float64 (printed): m / v "
                     f"within {err:.3e} ({where})")
    if moe:
        note += (f", MoE groups of "
                 f"{moe_impl._group_size(batch * seq, cfg.moe)}")
    print(f"phase {phase}: ({part}) {cfg.name} at full width {note}: "
          f"{n_params} parameters, {batch} x {seq} tokens "
          f"({batch * seq // 2} a data replica of 2); peak memory of the "
          f"float64 steps {peak64 / 1e9:.3f} GB | {_card()}:")
    for line in lines:
        print(f"phase {phase}: ({part})   {line}")
    del state, one
    torch.cuda.empty_cache()


def phase17_tp(gen: torch.Generator) -> dict[str, int]:
    """Tensor and expert parallelism (``train.sharded`` with a model axis)
    on slots of the card; returns no launches (the train steps launch
    none of the port's kernels: their counts, set to 0 before and read
    after, stay 0).  (``gen`` is unused: every draw comes from a seeded
    generator of its own.)"""
    t0 = time.perf_counter()
    card = _card()
    reset_launches()
    _tp_cost(card)
    for d, m in TP_EQUAL:
        _shard_equal("b", "qwen2-0.5b", d, 8, 128, True, m=m, phase=17)
    _first_steps(17, "c", _zoo_cfg(TP_MOE, TP_MOE_LAYERS, "float32"),
                 TP_MOE_BATCH, TP_MOE_SEQ, TP_MOE_MESHES,
                 f"cut to {TP_MOE_LAYERS} layers (1 dense, 1 MoE)")
    torch.cuda.synchronize()
    run = launch_counts()
    check(not any(run.values()), f"phase 17: the port's kernels launched "
          f"{run} in the train steps")
    print(f"phase 17: wall time {time.perf_counter() - t0:.2f} s")
    return {}


def phase18_tp_ssm(gen: torch.Generator) -> dict[str, int]:
    """Tensor parallelism of the SSM and hybrid families (``train.sharded``
    with a ``model`` axis) on slots of the card; returns no launches (the
    train steps launch none of the port's kernels: their counts, set to 0
    before and read after, stay 0).  (``gen`` is unused: every draw comes
    from a seeded generator of its own.)"""
    t0 = time.perf_counter()
    card = _card()
    reset_launches()
    run = _mesh_run(card, 18, TP_MESH, TP_STEPS, "mamba2-370m", *TRAIN_SSM)
    one = _mesh_run(card, 18, "1x1", SSM_ONE_STEPS, "mamba2-370m",
                    *TRAIN_SSM)
    heads = ZOO_ARCHS["mamba2-370m"].ssm.expand * ZOO_ARCHS[
        "mamba2-370m"].d_model // ZOO_ARCHS["mamba2-370m"].ssm.head_dim
    print(f"phase 18: (a) mamba2-370m bf16 step on {TP_MESH} (4 slots of "
          f"the card, 2 model slots a replica, {heads // 2} of its {heads} "
          f"SSM heads a slot; the collectives are copies within the card): "
          f"{_run_line(run)}; against "
          f"{_beside(run, '1x1 (the same batch)', one)} | {card}")
    _first_steps(18, "b", _zoo_cfg("mamba2-370m", dtype="float32"),
                 SSM_BATCH, SSM_SEQ, SSM_MESHES, "and depth")
    _first_steps(18, "c", _zoo_cfg("zamba2-1.2b", SSM_HYBRID_LAYERS,
                                   "float32"),
                 SSM_BATCH, SSM_SEQ, SSM_MESHES,
                 f"cut to {SSM_HYBRID_LAYERS} layers (2 head layers, one "
                 f"site of 6 and the shared block)", record=True)
    torch.cuda.synchronize()
    launched = launch_counts()
    check(not any(launched.values()), f"phase 18: the port's kernels "
          f"launched {launched} in the train steps")
    print(f"phase 18: wall time {time.perf_counter() - t0:.2f} s | {card}")
    return {}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase1_build()
    phase2_card()
    measured = phase3_kernels(gen)
    phase3_real_kernels(gen, measured)
    phase3_hermitian_kernels(gen, measured)
    phase3_nd_kernels(gen, measured)
    phase3_pulsar_kernels(gen, measured)
    phase3_sift_select(gen, measured)
    phase3_pulsar_tiles(gen)
    phase3_rows_per_block(gen)
    phase3_host_gap(gen)
    launches = phase4_main_path(gen)
    for phase in (phase5_fdas, phase6_serving, phase7_pulsar, phase8_demo,
                  phase9_energy, phase10_tune, phase11_robust,
                  phase12_distributed, phase13_zoo, phase14_train,
                  phase15_dryrun, phase16_sharded, phase17_tp,
                  phase18_tp_ssm):
        for kernel, count in phase(gen).items():
            launches[kernel] += count
    for kernel, count in launches.items():
        check(count > 0, f"{kernel} was never launched on a main path")
    kernels = []
    for name in KERNELS:
        row = measured[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "twiddle": row["twiddle"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
