"""The C interface of the port's CUDA sources against ``_cuda.SIGNATURES``.

Nothing here compiles CUDA (there is no ``nvcc`` on the CPU machines), so
this is the CPU side's only check that the ``ctypes`` declarations match
what ``loans_tpu_torch/ops/csrc/*.cu`` defines: a pointer passed where the
library takes an int, or an argument too few, would only show on the card.
Each ``extern "C"`` definition of a library's source and of the headers it
includes is parsed, and its entry points, argument counts, and pointer or
int kinds must be those that ``SIGNATURES`` (and ``_COMMON``) declare.
"""

import ctypes
import re

import pytest

from loans_tpu_torch.ops import _cuda

DEFINITION = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{')
INCLUDE = re.compile(r'#include\s+"([^"]+)"')


def _kind(c_type: str):
    """The ctypes type that stands for a C parameter or return type."""
    c_type = " ".join(c_type.split())
    if c_type == "const char*" or c_type == "const char *":
        return ctypes.c_char_p
    if "*" in c_type:
        return ctypes.c_void_p
    if c_type == "int":
        return ctypes.c_int
    raise AssertionError(f"no ctypes kind for the C type {c_type!r}")


def _definitions(library: str) -> dict:
    """name -> (argtypes, restype) of every extern "C" definition in
    ``csrc/<library>.cu`` and the local headers it includes."""
    source = (_cuda.CSRC_DIR / f"{library}.cu").read_text()
    texts = [source] + [(_cuda.CSRC_DIR / h).read_text() for h in INCLUDE.findall(source)]
    found = {}
    for text in texts:
        for ret, name, params in DEFINITION.findall(text):
            args = [p.strip() for p in params.split(",") if p.strip()]
            # drop each parameter's name: the type is what precedes it
            types = [re.sub(r"\b\w+$", "", a).strip() for a in args]
            found[name] = ([_kind(t) for t in types], _kind(ret))
    return found


def _declared(library: str) -> dict:
    return {**_cuda._COMMON, **_cuda.SIGNATURES[library]}


@pytest.mark.parametrize("library", sorted(_cuda.SIGNATURES))
def test_sources_define_the_declared_entry_points(library):
    assert sorted(_definitions(library)) == sorted(_declared(library))


@pytest.mark.parametrize("library,entry", [
    (library, entry) for library in sorted(_cuda.SIGNATURES) for entry in sorted(_declared(library))
])
def test_entry_point_arguments_match(library, entry):
    argtypes, restype = _definitions(library)[entry]
    want_args, want_ret = _declared(library)[entry]
    assert len(argtypes) == len(want_args), (entry, argtypes, want_args)
    assert argtypes == list(want_args), entry
    assert restype is want_ret, entry


def test_fwd_takes_no_scratch():
    """The forward kernels build their tables inside the one launch:
    images, theta and out are their only pointers besides the stream."""
    for library in _cuda.SIGNATURES:
        argtypes, _ = _definitions(library)[f"{library}_fwd"]
        assert argtypes.count(ctypes.c_void_p) == 4, library
        assert argtypes[:3] == [ctypes.c_void_p] * 3 and argtypes[-1] is ctypes.c_void_p, library


def test_bwd_theta_takes_no_scratch():
    """The d theta kernels reduce inside one launch: images, theta, g and
    d theta are their only pointers besides the stream."""
    for library in _cuda.SIGNATURES:
        argtypes, _ = _definitions(library)[f"{library}_bwd_theta"]
        assert argtypes.count(ctypes.c_void_p) == 5, library
