"""The blocked pulsar search (``repro_torch.search.pipeline.PulsarSearch``)
against the plain float64 search (``repro_torch.search.reference``) and
against the one-block search, on the CPU at a small grid: 32 channels x
2^13 samples, 24 DM trials in dedispersion blocks of 8 and sub-blocks of
2, the linear bank of drift 4 (9 templates of 32 taps), 4 harmonics, and
seeded noise with four injected pulsars, one of them on the first trial
of a block (trial 8).

* planes within the float32 tolerances below, the harmonic level equal
  wherever the winning rung clears the runner-up;
* the blocked planes and candidates bit-identical to the one-block
  search's (every step computes a trial's row alone);
* the candidates the reference's: each pulsar at its (trial, template,
  bin), nothing else;
* the sift's threshold from a false-alarm rate: it follows ln(cells), and
  at a rate of 0.01 noise passes nowhere on this grid;
* the plan's delay table the reference's cold-plasma table, here and at
  the benchmark's pointing; the sift of a pool of thousands of cells the
  reference's.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import (FilterbankSpec, InjectedPulsar,
                                        synthetic_filterbank)
from repro_torch.search import (DispersionPlan, PulsarSearch, TemplateBank,
                                pulsar_search, sift_threshold)
from repro_torch.search import reference

SPEC = FilterbankSpec(nchan=32, ntime=2**13)
PLAN = DispersionPlan.from_spec(SPEC, n_trials=24)
BANK = TemplateBank.linear(4)
H = 4
BLOCKS = dict(dedisp_block=8, fdas_block=2)
#: (trial, bin, drift): drifts -4..4 are templates 0..8.  The bins sit
#: near N/8, where a DM step's 0-4 samples of delay across the band
#: decohere the neighbouring trials.
PULSARS = ((3, 1100, 2.0), (8, 1500, -3.0), (13, 900, 0.0), (21, 1300, 4.0))
WANT = {(d, int(z) + 4, k) for d, k, z in PULSARS}
#: Power and statistic against float64: float32 rounds each of the ~10
#: steps (shift-and-sum over 32 channels, the R2C, the overlap-save
#: forward, multiply and inverse, |y|^2, the ladder) to ~6e-8 relative;
#: the errors grow with the value, so the bound is relative to the
#: plane's largest value (570-614 at a pulsar's cell), 2.4x the largest
#: relative error over seeds 5-9 (4.19e-7).
RTOL = 1e-6


def filterbank(seed: int, pulsars=PULSARS) -> torch.Tensor:
    return torch.from_numpy(synthetic_filterbank(
        SPEC, tuple(InjectedPulsar(dm=PLAN.dms[d], k0=k, z=z, amp=0.1)
                    for d, k, z in pulsars), seed=seed))


def rungs(power: torch.Tensor) -> torch.Tensor:
    """(rungs, ..., N): (S_h - h) / sqrt(h) of each rung h = 1, 2, 4."""
    n = power.shape[-1]
    k = torch.arange(n)
    out, total = [], torch.zeros_like(power)
    for j in range(1, H + 1):
        total[..., j * k < n] += power[..., (j * k)[j * k < n]]
        if j & (j - 1) == 0:
            out.append((total - j) / math.sqrt(j))
    return torch.stack(out)


def cells(c, row=0, level=False) -> set:
    return {(int(c.dm[row, i]), int(c.template[row, i]), int(c.bin[row, i]))
            + ((int(c.level[row, i]),) if level else ())
            for i in range(c.dm.shape[-1]) if int(c.dm[row, i]) >= 0}


@pytest.fixture(scope="module", params=[5, 6])
def searched(request):
    """(filterbank, one-block search, blocked search, reference) of one
    seed."""
    fb = filterbank(request.param)
    one = pulsar_search(fb, PLAN, BANK, n_harmonics=H)
    blocked = pulsar_search(fb, PLAN, BANK, n_harmonics=H, **BLOCKS)
    ref = reference.search(fb[None], torch.as_tensor(np.asarray(PLAN.delays)),
                           BANK.drifts, BANK.taps, n_harmonics=H)
    return fb, one, blocked, ref


def test_blocked_planes_match_the_reference(searched):
    _, _, res, (power, stat, level, _) = searched
    power, stat = power[0], stat[0]
    assert res.power.shape == (1, 24, BANK.n_templates, SPEC.ntime // 2 + 1)
    assert (res.power[0].double() - power).abs().max() <= \
        RTOL * power.abs().max()
    assert (res.stat[0].double() - stat).abs().max() <= \
        RTOL * stat.abs().max()
    # A rung that leads by less than the statistic's rounding may fall
    # either way in float32.
    z = rungs(power)
    assert torch.allclose(z.max(dim=0).values, stat, rtol=0, atol=1e-12)
    runner_up = z.sort(dim=0).values[-2]
    clear = (stat - runner_up) > RTOL * stat.abs().max()
    assert clear.double().mean() > 0.99
    assert torch.equal(res.level[0][clear], level[0][clear])


def test_blocked_search_is_the_one_block_search(searched):
    _, one, blocked, _ = searched
    for a, b in zip(one[:3] + (one.sigma2,), blocked[:3] + (blocked.sigma2,)):
        assert torch.equal(a, b)
    for a, b in zip(one.candidates, blocked.candidates):
        assert torch.equal(a, b)


def test_candidates_are_the_references_and_the_pulsars(searched):
    _, _, res, (*_, ref_cands) = searched
    assert cells(res.candidates) == WANT
    assert cells(res.candidates, level=True) == \
        {c[:4] for c in ref_cands[0]}
    got = sorted(float(v) for v in res.candidates.snr[0] if v > 0)
    want = sorted(c[4] for c in ref_cands[0])
    assert np.allclose(got, want, rtol=RTOL)


def test_block_keeps_only_the_asked_trials(searched):
    fb, one, _, _ = searched
    search = PulsarSearch(PLAN, BANK, n_harmonics=H, **BLOCKS)
    block = search.block(fb[None], 1, keep={7, 8, 11, 20})
    assert block.trials == range(8, 16) and block.kept == [8, 11]
    for got, full in zip((block.power, block.stat, block.level), one[:3]):
        assert torch.equal(got, full[:, [8, 11]])
    assert torch.equal(block.sigma2, one.sigma2[:, 8:16])
    nothing = search.block(fb[None], 2, keep={3})
    assert nothing.kept == [] and nothing.power is None
    kept = search(fb, keep=[21, 3])
    assert torch.equal(kept.stat, one.stat[:, [3, 21]])
    assert cells(kept.candidates) == WANT


def test_block_sends_the_kept_planes_to_out(searched):
    """With ``out``, the kept trials' planes land in the caller's tensors
    and the result holds none."""
    fb, one, _, _ = searched
    search = PulsarSearch(PLAN, BANK, n_harmonics=H, **BLOCKS)
    plane = (1, BANK.n_templates, SPEC.ntime // 2 + 1)
    out = {t: [torch.full(plane, -1.0), torch.full(plane, -1.0),
               torch.full(plane, -1, dtype=torch.int32)] for t in (9, 14)}
    res = search.block(fb[None], 1, keep={9, 14, 20}, out=out)
    assert res.kept == [9, 14] and res.power is None and res.level is None
    for t, planes in out.items():
        for got, full in zip(planes, one[:3]):
            assert torch.equal(got, full[:, t])


def test_a_block_counts_the_cells_over_its_threshold(searched):
    fb, one, _, _ = searched
    search = PulsarSearch(PLAN, BANK, n_harmonics=H, threshold=40.0,
                          **BLOCKS)
    for index in range(search.n_blocks):
        res = search.block(fb[None], index)
        want = (one.stat[:, res.trials] >= 40.0).sum()
        assert res.over.tolist() == [int(want)]


def test_the_count_over_the_threshold_in_template_chunks(searched,
                                                         monkeypatch):
    """Counted four templates' cells at a time (a sub-block's 2 x 9
    template rows in chunks of 4, 4, 4, 4 and a ragged 2 here), the cells
    over the threshold are all counted once."""
    from repro_torch.kernels.sift import sift_kernel
    fb, one, _, _ = searched
    monkeypatch.setattr(sift_kernel, "COUNT_CELLS", 4 * 4097)
    search = PulsarSearch(PLAN, BANK, n_harmonics=H, threshold=12.0,
                          **BLOCKS)
    res = search.block(fb[None], 2)
    assert res.over.tolist() == [int((one.stat[:, 16:24] >= 12.0).sum())]


def test_guards():
    with pytest.raises(ValueError, match="block sizes"):
        PulsarSearch(PLAN, BANK, dedisp_block=0)
    with pytest.raises(ValueError, match="false_alarms"):
        sift_threshold(1e6, 0.0)
    with pytest.raises(ValueError, match="power of two"):
        sift_threshold(1e6, 1.0, n_harmonics=3)


@pytest.mark.parametrize("h", [1, 2, 8])
def test_threshold_follows_the_volume(h):
    """The h = 1 rung dominates: ln(cells / false alarms) - 1, within
    1e-2 from 1e6 cells up, rising by ln 10 a decade of cells."""
    for cells_ in (1e6, 1e9, 7.3e11):
        x = sift_threshold(cells_, 0.01, h)
        assert abs(x - (math.log(cells_ / 0.01) - 1)) < 1e-2
        assert sift_threshold(10 * cells_, 0.01, h) - x == \
            pytest.approx(math.log(10), abs=1e-2)
    # The pointing of the benchmark's configuration.
    assert sift_threshold(85 * (2**22 + 1) * 2048, 0.01, 8) == \
        pytest.approx(30.92, abs=0.01)


def test_threshold_passes_no_noise_at_its_rate():
    """No cell of a noise-only grid reaches the threshold of 0.01 false
    alarms over its cells, and the threshold of one alarm a cell's worth
    of cells (rate cells / 20) is passed by about that many."""
    fb = filterbank(7, pulsars=())
    volume = 24 * BANK.n_templates * (SPEC.ntime // 2 + 1)
    strict = sift_threshold(volume, 0.01, H)
    res = pulsar_search(fb, PLAN, BANK, n_harmonics=H, threshold=strict,
                        **BLOCKS)
    assert float(res.stat.max()) < strict
    assert bool((res.candidates.dm == -1).all())
    loose = sift_threshold(volume, volume / 20, H)
    passed = int((res.stat >= loose).sum())
    # The union bound over correlated cells overcounts: fewer pass.
    assert 0 < passed <= volume / 20


@pytest.mark.parametrize("geometry", ["tests", "pointing"])
def test_delay_table_is_the_references(geometry):
    """The plan's integer delays are those the reference computes from
    the band alone, at this file's grid and at the benchmark's pointing
    (1024 channels, 2048 trials)."""
    if geometry == "tests":
        spec, trials = SPEC, 24
    else:
        cfg = json.loads((Path(__file__).parents[1] / "bench" / "configs"
                          / "htru_medlat_search.json").read_text())
        a = cfg["assumed"]
        spec = FilterbankSpec(nchan=cfg["nchan"], ntime=cfg["ntime"],
                              f_lo=a["f_lo_mhz"], f_hi=a["f_hi_mhz"],
                              tsamp=cfg["tsamp_s"])
        trials = a["dm_trials"]
    plan = DispersionPlan.from_spec(spec, n_trials=trials)
    dms, delays = reference.delay_table(spec.f_lo, spec.f_hi, spec.nchan,
                                        spec.tsamp, trials, 4.0)
    assert torch.equal(torch.from_numpy(plan.delay_array()), delays)
    assert np.allclose(plan.dms, dms.numpy(), rtol=1e-12, atol=0)
    assert int(delays[:, 0].abs().max()) == 0 and int(delays[-1, -1]) > 0


def test_sift_of_a_large_pool_is_the_references():
    """A pool of 1500 cells (more than one chunk of the sift's pairwise
    step) over 40 trials, with clusters, ties and harmonics, gives the
    reference's candidates."""
    from repro_torch.search.sift import CandidatePool, sift_pool
    g = torch.Generator().manual_seed(4)
    t, nb, d = 9, 4097, 40
    idx = torch.randperm(d * t * nb, generator=g)[:1500]
    # Half the cells clustered on a few bins and their multiples.
    near = torch.randint(0, 6, (750,), generator=g) * 97 + \
        torch.randint(-1, 2, (750,), generator=g)
    idx[:750] = idx[:750] - idx[:750] % nb + near.abs() % nb
    idx = torch.unique(idx)
    vals = torch.round(torch.rand(idx.shape, generator=g) * 400) / 4
    order = torch.argsort(-vals, stable=True)
    vals, idx = vals[order], idx[order]
    level = torch.randint(0, 3, idx.shape, generator=g, dtype=torch.int32)
    got = sift_pool(CandidatePool(vals[None], idx[None], level[None]),
                    (t, nb), (1,), threshold=20.0, max_candidates=400,
                    max_harmonic=8)
    want = reference.sift_cells(
        list(zip(vals.tolist(), idx.tolist(), level.tolist())), (t, nb),
        threshold=20.0, max_candidates=400, max_harmonic=8)
    assert len(want) > 50
    assert cells(got, level=True) == {c[:4] for c in want}
