"""Parity helpers between the JAX reference (``repro``) and the PyTorch
port (``repro_torch``) — one numpy input through both packages — and the
port's ledger semantics."""
import jax
import numpy as np
import torch

# The reference's plans bind their kernel hooks when ``repro.fft.plan`` is
# imported, and bind none if ``repro.kernels.fft.ops`` was imported first
# (an import cycle); importing the plans here keeps the kernel tests,
# which import this module first, from turning them off.
import repro.fft.plan  # noqa: F401
import repro.obs.ledger as ref_ledger_mod
import repro_torch.obs.ledger as port_ledger_mod
from repro.obs.ledger import LaunchLedger as RefLedger
from repro_torch.obs.ledger import LaunchLedger as PortLedger


def rand_complex(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def assert_close(port, ref, rtol: float) -> None:
    """max |port - ref| <= rtol * max |ref|."""
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    scale = np.abs(ref).max()
    assert err <= rtol * scale, f"max err {err:.3e} > {rtol} * {scale:.3e}"


def run_both(ref_fn, port_fn):
    """Run both sides under their launch ledgers; returns
    (ref output, port output, ref records, port records).

    The reference records launches only while ``jax.jit`` traces, and its
    jit caches are process-wide, so they are cleared first: the records
    then do not depend on which tests ran earlier in the process."""
    jax.clear_caches()
    ref_ledger, port_ledger = RefLedger(), PortLedger()
    with ref_ledger.capture():
        ref = np.asarray(ref_fn())
    with port_ledger.capture():
        port = port_fn()
    return ref, port, ref_ledger.records, port_ledger.records


def fresh_signatures() -> None:
    """Start both packages' process-wide launch signatures from none.

    The reference records a launch only while ``jax.jit`` traces, so its
    jit caches are cleared too: a function that an earlier test traced
    would otherwise run from the cache and record nothing."""
    jax.clear_caches()
    ref_ledger_mod._SIGNATURES.clear()
    port_ledger_mod._SIGNATURES.clear()


def assert_same_launches(ref_records, port_records) -> None:
    """Same kernels, logical shapes and bytes moved, in the same order
    (grid/tile differ by design: VMEM tiles vs CUDA blocks)."""
    def key(r):
        return (r.kernel, r.shape, r.bytes_moved)
    assert [key(r) for r in port_records] == [key(r) for r in ref_records]


def test_port_ledger_records_every_call():
    """The port runs eagerly: each wrapper call records one launch, where
    the reference records only while ``jax.jit`` traces."""
    from repro_torch.kernels.fft import ops
    x = torch.from_numpy(rand_complex(0, (2, 64)))
    ledger = PortLedger()
    with ledger.capture(key="c2c-64"):
        ops.fft_kernel_c2c(x)
        ops.fft_kernel_c2c(x)
    assert ledger.counts() == {"fft-c2c": 2}
    rec = ledger.records[0]
    assert rec.shape == (2, 64) and rec.bytes_moved == 16 * 2 * 64
    assert rec.grid == (1,) and rec.tile == (2, 64)
    assert ledger.signature("c2c-64") == ledger.records
    assert len(ledger.digest()) == 32
