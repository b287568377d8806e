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


def parameter_names(name: str) -> list[str]:
    """The parameter names of ``extern "C" int name(...)`` in csrc/*.cu."""
    for f in sorted(CSRC.glob("*.cu")):
        m = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', f.read_text(), re.S)
        if m:
            return [p.strip().split()[-1].lstrip("*") for p in m.group(1).split(",")]
    raise AssertionError(f"{name} not declared")


@pytest.mark.parametrize("name", ["cfd_quad_pre_smooth_restrict", "cfd_quad_post_prolong_smooth",
                                  "cfd_step_pre_smooth_restrict", "cfd_step_post_prolong_smooth"])
def test_finest_level_entry_points_take_the_tile_plan(name):
    # both flavors' pre and post kernels end in the pairs, a block's
    # row_base and halo, the tile plan and the stream; the post kernels
    # take the running max's accumulator right after res
    names = parameter_names(name)
    assert names[-5:] == ["n_pairs", "row_base", "halo", "plan", "stream"]
    if "post" in name:
        assert names[names.index("res") + 1] == "acc"
