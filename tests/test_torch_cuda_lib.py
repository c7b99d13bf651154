"""The C interface of the port's kernel libraries, read from the sources
on the CPU: `cuda_lib._SIGNATURES` lists every `extern "C"` entry point
of `tpulc_torch/csrc/*.cu` and no other, each with the entry's argument
count and kinds (pointer or int), and no source holds a compile-time
switch that would give a library other entry points than those.  A
ctypes signature that drifts from its C entry passes the wrong
arguments without an error."""

import glob
import os
import re

import pytest

from tpulc_torch import cuda_lib

CSRC = os.path.join(os.path.dirname(cuda_lib.__file__), "csrc")
_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(tplc_\w+)\s*\(([^)]*)\)')


def _sources(pattern: str) -> dict[str, str]:
    out = {}
    for path in sorted(glob.glob(os.path.join(CSRC, pattern))):
        with open(path) as f:
            out[os.path.basename(path)] = f.read()
    return out


def _entries() -> dict[str, list[str]]:
    """Entry point name -> its parameter declarations, from every .cu."""
    found = {}
    for name, text in _sources("*.cu").items():
        for fn, params in _ENTRY.findall(text):
            assert fn not in found, f"{fn} defined twice ({name})"
            decls = [p.strip() for p in params.split(",")]
            found[fn] = [] if decls in ([""], ["void"]) else decls
    return found


ENTRIES = _entries()


def test_every_c_entry_has_a_signature():
    assert ENTRIES, "no extern \"C\" entry points found"
    assert sorted(ENTRIES) == sorted(cuda_lib._SIGNATURES)


@pytest.mark.parametrize("name", sorted(cuda_lib._SIGNATURES))
def test_signature_matches_its_c_entry(name):
    decls = ENTRIES.get(name)
    assert decls is not None, f"{name} has no extern \"C\" definition"
    sig = cuda_lib._SIGNATURES[name]
    assert len(decls) == len(sig)
    for decl, kind in zip(decls, sig):
        m = re.fullmatch(r"(const\s+)?(int|void)\s*(\*?)\s*\w+", decl)
        assert m and (m.group(2) == "int" or m.group(3)), decl
        want = "pointer" if m.group(3) else "int"
        got = "pointer" if kind is cuda_lib._P else "int"
        assert got == want, f"{name}: {decl!r} is a {want}"


@pytest.mark.parametrize("pattern", ["*.cu", "*.cuh"])
def test_no_compile_time_switches(pattern):
    for name, text in _sources(pattern).items():
        assert not re.search(r"^\s*#\s*if(n?def)?\b.*\bTPLC_", text,
                             re.M), name
