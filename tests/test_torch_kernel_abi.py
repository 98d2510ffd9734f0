"""The port's C interfaces against their ctypes bindings, on the CPU.

Each CUDA kernel is bound with ``ctypes`` (``kernels/<name>/kernel.py``)
to an ``extern "C"`` entry point of ``csrc/<name>.cu``. ctypes trusts the
``argtypes`` it is given: a pointer declared ``c_int`` is cut to 32 bits,
a missing argument shifts every later one, and either shows only as
corruption on the card. So each entry point's C signature is parsed here
and held against the binding's ``argtypes``, which the loader sets on a
stand-in library (nothing is built or loaded). The library's path must
also follow the shared ``csrc/*.cuh`` headers, or an edited header would
reuse a stale build. The flash backward's scratch, which the wrapper sizes
and the kernels index, must match the C interface's sizes.
"""
import ctypes
import importlib
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build

# entry point -> (binding module, its loader, the library it loads)
ENTRY_POINTS = {
    "fused_sgd_lanes": ("fused_sgd", "_fn", "fused_sgd"),
    "fused_sgd_lanes_bf16": ("fused_sgd", "_fn_bf16", "fused_sgd"),
    "flash_attention_fwd": ("flash_attention", "_fwd", "flash_attention"),
    "flash_attention_bwd": ("flash_attention", "_bwd", "flash_attention_bwd"),
    "decode_attention_fwd": ("decode_attention", "_fn", "decode_attention"),
    "ssd_scan_fwd": ("ssd_scan", "_fn", "ssd_scan"),
}
_EXTERN = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', re.S)


def c_signatures() -> dict:
    """{entry point: (return type, [parameter kind, ...])} of every
    ``extern "C"`` function in ``csrc/*.cu``."""
    out = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        for ret, name, params in _EXTERN.findall(src.read_text()):
            out[name] = (ret, [c_kind(p) for p in params.split(",")])
    return out


def c_kind(param: str) -> str:
    """'ptr', 'i32', 'i64' or 'f32' of one C parameter declaration."""
    decl = " ".join(param.split())
    if "*" in decl:
        return "ptr"
    ctype = " ".join(w for w in decl.split()[:-1] if w != "const")
    kinds = {"int": "i32", "float": "f32", "long long": "i64",
             "int64_t": "i64"}
    assert ctype in kinds, f"no ctypes counterpart known for {decl!r}"
    return kinds[ctype]


def ctypes_kind(t) -> str:
    """The same kind of one ctypes argtype."""
    if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer):
        return "ptr"
    if t is ctypes.c_float:
        return "f32"
    if t is ctypes.c_int:
        return "i32"
    if t in (ctypes.c_longlong, ctypes.c_int64):
        return "i64"
    return repr(t)


class _Stub:
    """Stands in for a loaded library: each attribute is a fresh object on
    which the loader sets ``argtypes`` and ``restype``."""

    def __init__(self):
        self.symbols = {}

    def __getattr__(self, name):
        return self.symbols.setdefault(name, type(name, (), {})())


def test_every_entry_point_is_bound():
    assert sorted(c_signatures()) == sorted(ENTRY_POINTS)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_c_signature_matches_the_ctypes_binding(monkeypatch, entry):
    module, loader, library = ENTRY_POINTS[entry]
    mod = importlib.import_module(f"repro_torch.kernels.{module}.kernel")
    stubs = {}
    monkeypatch.setattr(mod, "load",
                        lambda name: stubs.setdefault(name, _Stub()))
    fn = getattr(mod, loader).__wrapped__()    # past functools.cache
    assert fn is stubs[library].symbols[entry]
    ret, params = c_signatures()[entry]
    assert ret == "int" and fn.restype is ctypes.c_int
    got = [ctypes_kind(t) for t in fn.argtypes]
    assert got == params, (entry, got, params)


def test_library_path_follows_the_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    first = build.library_path("k")
    assert build.library_path("k") == first        # unchanged: reused
    header.write_text("// two\n")
    second = build.library_path("k")
    assert second != first                          # an edited header
    (tmp_path / "other.cuh").write_text("// new\n")
    assert build.library_path("k") != second        # a new header
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, second)
    assert build.library_path("k").parent == build.BUILD_DIR


def test_backward_scratch_matches_the_c_interface():
    """``delta`` is (B, H, S) floats for float32 and 2 B H S_pad for
    bfloat16, S_pad S rounded up to the .cu's ``kRowPad``; ``partial``,
    2 B T H hd floats, only for bfloat16 with H > KV."""
    from repro_torch.kernels.flash_attention.ops import (
        BWD_ROW_PAD, FlashAttentionBwd,
    )

    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    assert re.search(r"constexpr int kRowPad = (\d+);", src).group(1) == (
        str(BWD_ROW_PAD))
    bf16 = dict(dtype=torch.bfloat16)
    q, k = torch.empty(2, 300, 8, 64, **bf16), torch.empty(2, 300, 2, 64, **bf16)
    delta, partial = FlashAttentionBwd.scratch(q, k)
    assert delta.dtype == partial.dtype == torch.float32
    assert delta.shape == (2, 2, 8, 3 * BWD_ROW_PAD)
    assert partial.shape == (2, 2, 300, 8, 64)
    assert FlashAttentionBwd.scratch(q, torch.empty(2, 300, 8, 64,
                                                    **bf16))[1] is None
    delta, partial = FlashAttentionBwd.scratch(q.float(), k.float())
    assert delta.shape == (2, 8, 300) and partial is None
