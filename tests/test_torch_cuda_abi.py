"""The C interface of the port's kernels against its ctypes declarations.

Every ``extern "C" int bpt_*(...)`` in ``broadphase_tpu_torch/csrc/*.cu``
must have an entry in ``ops/_cuda._SIGNATURES`` with the same parameters,
kind for kind (``void*`` -> ``p``, ``long long`` -> ``i``, the trailing
stream included), and every entry there must name such a function.  A
mismatch would pass pointers and sizes into the wrong parameters, which
only a run on the card could show.
"""

import re

import pytest

from broadphase_tpu_torch.ops import _cuda

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(bpt_\w+)\s*\(([^)]*)\)')


def _kind(param: str) -> str:
    decl = " ".join(param.split())
    if "*" in decl:
        return "p"
    if re.fullmatch(r"(const )?long long \w+", decl):
        return "i"
    raise AssertionError(f"parameter {param!r} is neither a pointer nor "
                         "long long")


def _entry_points():
    found = {}
    for src in sorted(_cuda.SRC_DIR.glob("*.cu")):
        for name, params in _ENTRY.findall(src.read_text()):
            assert name not in found, f"{name} defined twice"
            found[name] = (src.name, "".join(
                _kind(p) for p in params.split(",") if p.strip()))
    return found


def test_every_entry_point_is_declared_and_every_declaration_defined():
    defined = set(_entry_points())
    assert defined == set(_cuda._SIGNATURES), (
        f"defined only in csrc: {sorted(defined - set(_cuda._SIGNATURES))}; "
        f"declared only in _SIGNATURES: "
        f"{sorted(set(_cuda._SIGNATURES) - defined)}")


@pytest.mark.parametrize("name", sorted(_cuda._SIGNATURES))
def test_signature_matches_the_c_definition(name):
    src, kinds = _entry_points()[name]
    assert kinds == _cuda._SIGNATURES[name], (
        f"{name} in {src} takes {kinds!r}, _SIGNATURES says "
        f"{_cuda._SIGNATURES[name]!r}")
    assert kinds.endswith("p"), f"{name}: the stream must come last"

