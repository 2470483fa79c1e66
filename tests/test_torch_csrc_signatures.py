"""The ctypes argument types that `ops/_build.py` declares for each CUDA
kernel library match the `extern "C"` entry point in its source.

The libraries are built and called only on a card; a mismatch there
would pass pointers as ints or shift every later argument. This test
reads each source's entry point on the CPU: its name, and for every
parameter whether it is a pointer, an int or a float, in order."""

import os
import re

import ctypes
import pytest

from ome_tpu_torch.ops import _build


def _entry_params(source: str, symbol: str):
    text = open(os.path.join(_build._CSRC, source)).read()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, f"{symbol} not found in {source}"
    kinds = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        elif param.startswith("float "):
            kinds.append(ctypes.c_float)
        elif param.startswith("int "):
            kinds.append(ctypes.c_int)
        else:
            raise AssertionError(f"{symbol}: unexpected parameter {param!r}")
    return kinds


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_declared_argtypes_match_the_entry_point(name):
    symbol, argtypes = _build._SIGNATURES[name]
    assert _entry_params(_build.SOURCES[name], symbol) == list(argtypes)
