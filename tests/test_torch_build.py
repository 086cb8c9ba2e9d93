"""The build cache of the port's CUDA kernels (``repro_torch.kernels.common``):
a library's name carries a hash of its source, of every shared header under
``csrc/`` and of the flags, so that editing any of them builds a new
library instead of loading a stale one.  Nothing is compiled here."""
import pytest

from repro_torch.kernels import common


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text('#include "shared.cuh"\n')
    (src / "shared.cuh").write_text("// shared device code\n")
    monkeypatch.setattr(common, "CSRC_DIR", src)
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "_build")
    return src


def test_editing_a_header_renames_the_library(csrc):
    source = csrc / "kern.cu"
    before = common._library_path(source)
    assert before.parent == common.BUILD_DIR
    assert before.name.startswith("libkern-") and before.suffix == ".so"
    assert common._library_path(source) == before          # stable
    header = csrc / "shared.cuh"
    data = bytearray(header.read_bytes())
    data[3] ^= 1                                           # one byte
    header.write_bytes(bytes(data))
    assert common._library_path(source) != before


def test_source_flags_and_new_headers_rename_the_library(csrc, monkeypatch):
    source = csrc / "kern.cu"
    names = {common._library_path(source)}
    (csrc / "other.cuh").write_text("// a second header\n")
    names.add(common._library_path(source))
    source.write_text('#include "shared.cuh"\n// edited\n')
    names.add(common._library_path(source))
    monkeypatch.setattr(common, "NVCC_FLAGS", common.NVCC_FLAGS + ("-G",))
    names.add(common._library_path(source))
    assert len(names) == 4


def test_the_port_ships_its_shared_header():
    """Both kernel sources include the shared headers (the register passes,
    which include the shared-memory stages), so they are part of every
    library's name."""
    headers = sorted(p.name for p in common.CSRC_DIR.glob("*.cuh"))
    assert headers == ["stockham.cuh", "stockham_regs.cuh"]
    regs = (common.CSRC_DIR / "stockham_regs.cuh").read_text()
    assert '#include "stockham.cuh"' in regs
    for stem in ("fft_c2c", "fft_real"):
        text = (common.CSRC_DIR / f"{stem}.cu").read_text()
        assert '#include "stockham_regs.cuh"' in text
