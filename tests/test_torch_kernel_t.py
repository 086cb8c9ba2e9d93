"""``repro_torch.kernels.fft.ops.fft_kernel_c2c_t`` (the ``fft_c2c_t``
kernel's plain version on the CPU) against the reference's Pallas kernels
``fft_t_pallas`` / ``fft_t_twiddle_pallas`` in interpret mode, and the
CUDA kernel's grid emulated against the plain version.

Tolerance as for the c2c kernel: max |a-b| <= 1e-5 * max |ref|; the
emulation bit for bit."""
import numpy as np
import pytest
import torch

from test_torch_kernel_passes import (LENGTHS, RADIX_SETS, emulate_c2c_t,
                                      one_thread, strided_geometries)
from test_torch_parity import (PortLedger, assert_close,
                               assert_same_launches, rand_complex, run_both)
from repro.kernels.fft import ops as ref_ops
from repro_torch.kernels.fft import fft_kernel as K
from repro_torch.kernels.fft import ops as port_ops

RTOL = 1e-5
#: Lengths of this file; test_torch_kernel_t_long.py runs the long ones.
SHORT = (2, 8, 64)
LONG = (1024, 8192)
ROWS = 7                       # ragged against every block size
#: Rows of the emulation: ragged against every tile and cluster.
STRIDED_COUNT = 37
#: Lengths of the emulation here; test_torch_kernel_t_long.py runs the
#: longest.
EMULATED = LENGTHS[:-2]
EMULATED_LONG = LENGTHS[-2:]

CASES = [((4, 2), True), ((2,), True), ((8, 4, 2), True), ((4, 2), False)]


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("radices,with_twiddle", CASES)
@pytest.mark.parametrize("n", SHORT)
def test_fft_kernel_c2c_t_matches_reference(n, radices, with_twiddle,
                                            inverse):
    x = rand_complex(n, (2, ROWS, n))
    tw = rand_complex(n + 1, (ROWS, n)) if with_twiddle else None
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_ops.fft_kernel_c2c_t(x, twiddle=tw, inverse=inverse,
                                         radices=radices),
        lambda: port_ops.fft_kernel_c2c_t(torch.from_numpy(x), twiddle=tw,
                                          inverse=inverse, radices=radices))
    assert tuple(port.shape) == (2, n, ROWS) and port.is_contiguous()
    assert_close(port, ref, RTOL)
    assert_same_launches(ref_rec, port_rec)


def test_fft_kernel_c2c_t_refuses_a_misshapen_twiddle():
    x = torch.zeros(2, 4, 8, dtype=torch.complex64)
    with pytest.raises(ValueError, match="twiddle"):
        port_ops.fft_kernel_c2c_t(x, twiddle=np.ones((8, 4), np.complex64))


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("with_twiddle", (False, True))
@pytest.mark.parametrize("radices", RADIX_SETS)
@pytest.mark.parametrize("n", EMULATED)
def test_emulated_c2c_t_is_the_plain_version_bit_for_bit(n, radices,
                                                         with_twiddle,
                                                         inverse):
    """fft_c2c_t_regs_kernel's grid emulated (test_torch_kernel_passes):
    the passes, 1/n and the twiddle in registers, the cluster store
    transposed, on 37 rows (ragged against every tile), with the planner's
    geometry and with one-row blocks in clusters of 8 where that differs;
    every output element written once, equal to fft_c2c_t_plain."""
    x = torch.from_numpy(rand_complex(n, (2, STRIDED_COUNT, n)))
    tw = (torch.from_numpy(rand_complex(n + 1, (STRIDED_COUNT, n)))
          if with_twiddle else None)
    want = K.fft_c2c_t_plain(x, tw, inverse=inverse, radices=radices)
    with one_thread():
        for tile_b, lines in strided_geometries(n, STRIDED_COUNT):
            got = emulate_c2c_t(x, tw, inverse, radices, tile_b, lines)
            assert torch.equal(got, want)


def test_fft_kernel_c2c_t_records_its_clustered_grid():
    """The ledger's grid counts every block of the clusters, masked ones
    included; its tile is (rows a block, C) from pass_launch."""
    x = torch.from_numpy(rand_complex(0, (3, 37, 4096)))
    ledger = PortLedger()
    with ledger.capture():
        port_ops.fft_kernel_c2c_t(x[:1, :12])
        port_ops.fft_kernel_c2c_t(x[..., :64], tile_b=1)
        port_ops.fft_kernel_c2c_t(x[..., :64])
    big, small, default = ledger.records
    # 12 lines fill whole sectors: clusters of 4; 37 do not: clusters of 8.
    assert K.c2c_cluster(1, 12) == K.C2C_CLUSTER_LINES == 4
    assert K.c2c_cluster(1, 37) == K.C2C_UNALIGNED_LINES == 8
    assert big.grid == (3 * 4,) and big.tile == (1, 4096)
    assert small.grid == (3 * 5 * 8,) and small.tile == (1, 64)
    assert default.grid == (3,) and default.tile == (37, 64)
    with pytest.raises(ValueError, match=">= 1"):
        port_ops.fft_kernel_c2c_t(x[:, :4, :8], tile_b=0)
