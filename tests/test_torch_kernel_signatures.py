"""The ctypes signatures of the port's kernel libraries against their C prototypes.

Each wrapper module declares, for every function it calls in a
``csrc/<name>.cu`` library, the ctypes types of its arguments
(``_build.load`` sets them as ``argtypes``).  ctypes cannot see the C side:
an argument left out or of the wrong width shifts every later one, which
shows only on the card, as a wrong result or a crash.  So each declaration
is held here, on the CPU, to the prototype in the source's ``extern "C"``
block: the same number of arguments, each of the same kind and width.
"""

import ctypes
import os
import re

import pytest

from gs_deformable_tpu_torch import _build
from gs_deformable_tpu_torch.ops.kernels import (composite, ordered_fill, screen_space,
                                                 tile_cull, trunk)

LIBRARIES = [("ordered_fill", ordered_fill._SIGNATURES),
             ("composite_fwd", composite._SIGNATURES),
             ("composite_bwd", composite._BWD_SIGNATURES),
             ("trunk", trunk._SIGNATURES),
             ("tile_cull", tile_cull._SIGNATURES),
             ("screen_space", screen_space._SIGNATURES)]

C_KINDS = {"const void*": "pointer", "void*": "pointer", "int*": "pointer",
           "long long": "int64", "int": "int32", "unsigned": "uint32", "float": "float32"}


def ctypes_kind(t) -> str:
    if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer):
        return "pointer"
    if t is ctypes.c_float:
        return "float32"
    if t in (ctypes.c_uint, ctypes.c_uint32):
        return "uint32"
    return {4: "int32", 8: "int64"}[ctypes.sizeof(t)]


def prototypes(name: str) -> dict:
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        src = f.read()
    block = src[src.index('extern "C" {'):]
    out = {}
    for fn, args in re.findall(r"^int (\w+)\(([^)]*)\)", block, flags=re.M):
        kinds = []
        for arg in args.split(","):
            ctype = " ".join(arg.split()).rsplit(" ", 1)[0]
            kinds.append(C_KINDS[ctype])
        out[fn] = kinds
    return out


@pytest.mark.parametrize("name,signatures", LIBRARIES, ids=[n for n, _ in LIBRARIES])
def test_ctypes_signatures_match_the_c_prototypes(name, signatures):
    protos = prototypes(name)
    assert signatures and set(signatures) <= set(protos), (set(signatures), set(protos))
    for fn, argtypes in signatures.items():
        assert [ctypes_kind(t) for t in argtypes] == protos[fn], fn
