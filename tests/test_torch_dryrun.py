"""The two dry-run drivers on a machine with no GPU: ``launch.dryrun``'s
artifact for qwen2-0.5b ``train_4k`` on both production meshes (the
reference's own checks of its artifact, ``tests/test_dryrun_integration.py``,
with 80 GB cards), its ``--opt`` handling, and ``launch.fft_dryrun``'s
pencil bytes against ``pencil_exchange_bytes`` and the reference's
analytic model."""
import json

import pytest

from repro.fft.distributed import pencil_collective_bytes as ref_pencil_bytes
from repro_torch.analysis.roofline import dvfs_plan, roofline_from_artifact
from repro_torch.configs import CONFIG, ShapeSpec
from repro_torch.fft.distributed import pencil_exchange_bytes
from repro_torch.launch import dryrun, fft_dryrun

KEYS = {"arch", "shape", "mesh", "chips", "kind", "flops_per_device",
        "hbm_bytes_per_device", "collective_bytes_per_device",
        "collective_breakdown", "model_flops", "memory", "lower_s",
        "collective_by_axis"}
MEMORY = {"argument_bytes", "output_bytes", "scan_carry_estimate",
          "fits_80gb"}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dryrun_main_writes_the_train_4k_artifact(tmp_path, multi_pod):
    argv = ["--arch", "qwen2-0.5b", "--shape", "train_4k",
            "--out", str(tmp_path)] + (["--multi-pod"] if multi_pod else [])
    assert dryrun.main(argv) == 0
    mesh = "2x32x8" if multi_pod else "32x8"
    path = tmp_path / f"qwen2-0.5b__train_4k__{mesh}.json"
    art = json.loads(path.read_text())
    assert KEYS <= set(art) and MEMORY <= set(art["memory"])
    assert art["mesh"] == mesh and art["chips"] == (512 if multi_pod
                                                    else 256)
    assert art["memory"]["fits_80gb"]
    # the reference's own check: counted FLOPs within [0.9, 6] of 6ND
    ratio = art["flops_per_device"] * art["chips"] / art["model_flops"]
    assert 0.9 <= ratio <= 6
    assert art["step_batch"] == (4 if multi_pod else 8)
    by_axis = art["collective_by_axis"]
    assert sum(by_axis.values()) == pytest.approx(
        art["collective_bytes_per_device"])
    assert sum(art["collective_breakdown"].values()) == pytest.approx(
        art["collective_bytes_per_device"])
    assert by_axis["data"] > 0 and by_axis["model"] > 0
    if multi_pod:       # the gradient all-reduce crosses the pods
        assert by_axis["pod"] > 0
    t = roofline_from_artifact(str(path))
    assert t.collective_s > 0 and t.compute_s > 0
    assert dvfs_plan(t).optimal.f > 0


def test_serve_tp_only_drops_the_weight_gathers(tmp_path):
    """decode_32k with the weights TP-only: no all-gather over data (the
    weights are replicated there), more argument bytes a device; an option
    without effect in one process is recorded as such."""
    base = dryrun.lower_cell("qwen2-0.5b", "decode_32k", multi_pod=False)
    opt = dryrun.lower_cell("qwen2-0.5b", "decode_32k", multi_pod=False,
                            opts=("serve_tp_only", "moe_seq_combine"))
    assert base["collective_breakdown"]["all-gather"] > 0
    assert "all-gather" not in opt["collective_breakdown"]
    assert opt["collective_by_axis"]["data"] == 0
    assert (opt["memory"]["argument_bytes"]
            > base["memory"]["argument_bytes"])
    assert opt["flops_per_device"] == base["flops_per_device"]
    assert opt["opts_without_effect"] == ["moe_seq_combine"]
    with pytest.raises(ValueError, match="unknown --opt"):
        dryrun.lower_cell("qwen2-0.5b", "decode_32k", multi_pod=False,
                          opts=("fast",))


def test_an_undivided_batch_runs_whole_on_every_replica():
    """mamba2-370m long_500k (batch 1) on both meshes: the batch does not
    split over the batch axes, so each data replica runs the whole step;
    its counts are shared by the replica's 8 ``model`` devices alone, and
    the TP all-reduces carry the replica's one token (hand-worked: the
    48 out_proj products and the vocab-sharded embedding lookup, one
    1024-wide bf16 row each)."""
    one, two = (dryrun.lower_cell("mamba2-370m", "long_500k", multi_pod=mp)
                for mp in (False, True))
    for art in (one, two):
        assert art["step_batch"] == 1
        assert art["flops_per_device"] * 8 == art["step_flops"]
        assert art["hbm_bytes_per_device"] == two["hbm_bytes_per_device"]
        assert art["collective_by_axis"]["model"] == (48 + 1) * 1 * 1024 * 2
    assert one["flops_per_device"] == two["flops_per_device"]


def test_a_batch_axis_moved_to_the_sequence_splits_the_step():
    """A prefill of 32 sequences of 1024 tokens: on 32x8 each data replica
    takes one sequence; on 2x32x8 the batch takes only ``pod`` and
    ``fix_sharding`` moves ``data`` to the sequence, so a replica runs 16
    sequences and its 8 devices do a 32nd of that: half the 32x8 work a
    device, and TP all-reduces of half the tokens (512 against 1024)."""
    shape = ShapeSpec("prefill_1k", 1024, 32, "prefill")
    one, two = (dryrun.lower_cell("qwen2-0.5b", shape, multi_pod=mp)
                for mp in (False, True))
    assert (one["step_batch"], two["step_batch"]) == (1, 16)
    assert two["flops_per_device"] * 2 == one["flops_per_device"]
    assert two["flops_per_device"] * 8 * 32 == two["step_flops"]
    assert (two["collective_by_axis"]["model"] * 2
            == one["collective_by_axis"]["model"])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_fft_dryrun_bytes_equal_the_pencils_exchange(tmp_path, multi_pod):
    argv = ["--out", str(tmp_path)] + (["--multi-pod"] if multi_pod else [])
    assert fft_dryrun.main(argv) == 0
    (path,) = tmp_path.glob("fft-pencil__*.json")
    art = json.loads(path.read_text())
    n1, n2, b = CONFIG.pencil_n1, CONFIG.pencil_n2, CONFIG.pencil_batch
    local = b // (64 if multi_pod else 32)
    assert art["step_batch"] == local
    want = pencil_exchange_bytes(local, n1, n2, 8)
    assert art["collective_bytes_per_device"] == want
    assert art["collective_bytes_analytic"] == ref_pencil_bytes(
        local, n1, n2, 8) == want
    # one fft_c2c_axis1 and one fft_c2c a shard, 16 bytes a point each
    assert art["launches"] == {"fft-c2c": 8, "fft-c2c-axis1": 8}
    assert art["hbm_bytes_per_device"] == 2 * 16 * local * n1 * n2 / 8
    assert art["flops_per_device"] * art["chips"] == art["model_flops"]
    assert roofline_from_artifact(str(path)).bound == "collective"
