"""The ctypes bindings of the kernel libraries against their C sources.

``fft_kernel`` declares the argument types of every C entry it calls
(``_library``, ``_real_library``, ``_transpose_library``), as do
``dedisp_kernel``, ``harmonic_sum_kernel``, ``spectrum_kernel`` and
``sift_kernel`` (``_library``).  A declaration
that drifts from the C signature passes garbage to the card, and shows
only there; here each declared entry is held against the ``extern "C"``
definition in ``src/repro_torch/csrc``, argument by argument, with the
libraries replaced by a recorder (nothing is built).
"""
import ctypes
import pathlib
import re

import pytest

from repro_torch.kernels.dedisp import dedisp_kernel as D
from repro_torch.kernels.fft import fft_kernel as K
from repro_torch.kernels.harmonic_sum.ops import K as H
from repro_torch.kernels.sift import sift_kernel as T
from repro_torch.kernels.spectrum import spectrum_kernel as S

CSRC = pathlib.Path(K.__file__).resolve().parents[2] / "csrc"

#: The library stem each loader builds, with the sources that define its
#: entries (the headers it includes define some).
LIBRARIES = {
    "_library": ("fft_c2c", ("fft_c2c.cu", "stockham.cuh",
                             "stockham_regs.cuh")),
    "_real_library": ("fft_real", ("fft_real.cu", "stockham.cuh",
                                   "stockham_regs.cuh")),
    "_transpose_library": ("transpose", ("transpose.cu", "stockham.cuh")),
    "dedisp._library": ("dedisp", ("dedisp.cu",)),
    "harmonic_sum._library": ("harmonic_sum", ("harmonic_sum.cu",)),
    "spectrum._library": ("spectrum", ("spectrum.cu",)),
    "sift._library": ("sift", ("sift.cu",)),
}
#: The module of each loader.
MODULES = {"dedisp._library": D, "harmonic_sum._library": H,
           "spectrum._library": S, "sift._library": T}


#: The definition of an exported entry: its name and parameter list.
_DEFINITION = (r'^(?:extern "C" )?(?:int|const char\*) (repro_\w+)'
               r'\(([^)]*)\)\s*\{')


def _c_entries(files) -> dict[str, list[str]]:
    """``repro_*`` functions defined in ``files``: name -> parameter types,
    each reduced to ``ptr``, ``long long``, ``int`` or ``float``."""
    found = {}
    for f in files:
        text = (CSRC / f).read_text()
        for name, params in re.findall(_DEFINITION, text, re.M):
            kinds = []
            for p in filter(None, (q.strip() for q in params.split(","))):
                if "*" in p:
                    kinds.append("ptr")
                elif p.startswith("long long"):
                    kinds.append("long long")
                else:
                    kinds.append(p.split()[-2] if len(p.split()) > 1
                                 else p.split()[0])
            found[name] = kinds
    return found


class _Recorder:
    """Stands in for a loaded library: records what is declared."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type("Fn", (), {})())


_KIND = {ctypes.c_void_p: "ptr", ctypes.c_longlong: "long long",
         ctypes.c_int: "int", ctypes.c_float: "float"}


@pytest.mark.parametrize("loader", sorted(LIBRARIES))
def test_declared_entries_match_the_c_signatures(loader, monkeypatch):
    stem, files = LIBRARIES[loader]
    module = MODULES.get(loader, K)
    rec = _Recorder()
    monkeypatch.setattr(module, "load_library",
                        lambda s: rec if s == stem else None)
    fn = getattr(module, loader.rpartition(".")[2])
    fn.cache_clear()
    try:
        assert fn() is rec
    finally:
        fn.cache_clear()
    entries = _c_entries(files)
    assert rec.fns, f"{loader} declares nothing"
    for name, decl in rec.fns.items():
        assert name in entries, f"{name}: no extern C definition in {files}"
        got = [_KIND[t] for t in decl.argtypes]
        assert got == entries[name], f"{name}: declared {got}, C {entries[name]}"
        assert decl.restype in (ctypes.c_int, ctypes.c_char_p)


def test_every_planned_entry_is_declared(monkeypatch):
    """The planned launches of fft_c2c and fft_r2c: plan, run, the plan's
    size and the empty entry of the same signature, in both libraries."""
    for loader in ("_library", "_real_library"):
        stem, _ = LIBRARIES[loader]
        rec = _Recorder()
        monkeypatch.setattr(K, "load_library", lambda s, r=rec: r)
        fn = getattr(K, loader)
        fn.cache_clear()
        try:
            fn()
        finally:
            fn.cache_clear()
        name = "c2c" if stem == "fft_c2c" else "r2c"
        assert {f"repro_fft_{name}_plan", f"repro_fft_{name}_run",
                "repro_pass_plan_bytes", "repro_pass_noop"} <= set(rec.fns)
        run = rec.fns[f"repro_fft_{name}_run"].argtypes
        assert rec.fns["repro_pass_noop"].argtypes == run
