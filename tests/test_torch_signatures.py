"""The ctypes argument lists of the library's C entry points
(kernels/_build.py SIGNATURES) against their declarations in csrc/*.cu, on
the CPU: a pointer (and the stream) is c_void_p, an int c_int, a float
c_float, in the declared order, and every ``extern "C"`` entry point that
returns a cudaError_t has its line. A mismatch would pass garbage to a
kernel on the card, which no CPU test runs."""

import ctypes
import re

import pytest

from cfd_tpu_torch.kernels._build import CSRC, SIGNATURES

KINDS = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


def declarations() -> dict[str, list]:
    """name -> the ctypes kind of each parameter of every ``extern "C" int``
    function in csrc/*.cu."""
    out = {}
    for f in sorted(CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*\{', f.read_text(), re.S):
            kinds = []
            for param in (p.strip() for p in m.group(2).split(",")):
                if "*" in param:
                    kinds.append(KINDS["ptr"])
                elif param.startswith(("int ", "float ")):
                    kinds.append(KINDS[param.split()[0]])
                else:
                    raise AssertionError(f"{m.group(1)}: unexpected parameter {param!r}")
            out[m.group(1)] = kinds
    return out


DECLS = declarations()


def test_every_entry_point_has_a_signature():
    assert set(DECLS) == set(SIGNATURES)


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_signature_matches_the_declaration(name):
    assert SIGNATURES[name] == DECLS[name]
