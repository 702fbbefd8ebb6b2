"""The ctypes bindings of the hand-written kernels against their C entries,
and K1b's pass-1 split planner (``flash_attention_bwd.plan``), on the CPU.

Each ``bind`` in ``src/repro_torch/kernels/*.py`` types one ``extern "C"``
entry of ``csrc/*.cu``: a wrong count or type of argument is no error
ctypes reports, only a fault on the card, so each argtypes list is held
here against the entry's parameters parsed from the source.
"""
import ctypes
import importlib
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import flash_attention_bwd as fab

KERNELS = Path(fab.__file__).resolve().parent
MODULES = sorted(p.stem for p in KERNELS.glob("*.py")
                 if "def bind(" in p.read_text())
# the ctypes type a C parameter is passed as (every pointer as c_void_p)
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float, "double": ctypes.c_double}


def _entries() -> dict:
    """name -> [ctypes type of each parameter] of every ``extern "C"``
    entry in ``csrc/*.cu``."""
    out = {}
    for src in sorted((KERNELS / "csrc").glob("*.cu")):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                             src.read_text()):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            out[m.group(1)] = [
                ctypes.c_void_p if "*" in p
                else C_TYPES[re.sub(r"\s*\w+$", "", p)] for p in params]
    return out


class _Lib:
    """Stands in for a loaded library: records the entry ``bind`` asks
    for and lets it set argtypes and restype."""

    def __init__(self):
        self.asked = []

    def __getattr__(self, name):
        fn = type("Entry", (), {})()
        self.asked.append(name)
        object.__setattr__(self, name, fn)
        return fn


def test_every_binding_module_is_checked():
    assert {"flash_attention", "flash_attention_bwd", "rwkv6_scan",
            "rwkv6_scan_bwd", "rmsnorm", "rmsnorm_bwd", "find_alloc",
            "commit_scan"} <= set(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_bind_types_every_parameter_of_its_c_entry(module):
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    lib = _Lib()
    fn = mod.bind(lib)
    assert len(lib.asked) == 1
    want = _entries()[lib.asked[0]]
    assert len(fn.argtypes) == len(want), (module, len(fn.argtypes),
                                           len(want))
    assert list(fn.argtypes) == want
    assert fn.restype is ctypes.c_int


# (B, Hq, Hkv, S, D): every config's attention at batch 4 in the smoke
# (``chip_smoke.MODEL_ATTENTION``) and the llama3.2-1b train shape
SHAPES = [(4, 32, 8, 1024, 64), (4, 64, 4, 1024, 64), (4, 48, 8, 1024, 128),
          (4, 48, 1, 1024, 128), (4, 40, 8, 1024, 128), (4, 25, 5, 1024, 64),
          (4, 16, 8, 1280, 128), (4, 6, 6, 448, 64), (1, 8, 1, 128, 128),
          (2, 4, 2, 100, 32), (1, 32, 8, 1000, 64)]


@pytest.mark.parametrize("shape", SHAPES)
def test_split_gives_each_q_head_to_exactly_one_split(shape):
    B, Hq, Hkv, S, D = shape
    p = fab.plan(B, Hq, Hkv, S, D, torch.bfloat16)
    G = Hq // Hkv
    groups = fab.split_heads(G, p.splits)
    assert len(groups) == p.splits and all(len(g) for g in groups)
    assert sorted(h for g in groups for h in g) == list(range(G))
    assert p.form == "wgmma" and p.rows % fab.KEY_TILE == 0
    assert p.rows - fab.KEY_TILE < S <= p.rows


@pytest.mark.parametrize("shape", SHAPES)
def test_no_split_for_float32(shape):
    p = fab.plan(*shape, torch.float32)
    assert (p.form, p.splits, p.rows) == ("f32", 1, shape[3])


def test_plan_is_a_function_of_the_shape():
    for shape in SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            assert fab.plan(*shape, dt) == fab.plan(*shape, dt)
    assert fab.FORMS == {torch.bfloat16: "wgmma", torch.float32: "f32"}


def test_granite_is_split_and_llama_only_under_a_grid_of_132():
    granite = fab.plan(4, 48, 1, 1024, 128, torch.bfloat16)
    assert granite.splits > 1
    assert 1024 // 128 * 1 * 4 * granite.splits >= fab.SMS
    for B in (1, 2, 4, 8):
        for S in (256, 512, 1024, 2048):
            p = fab.plan(B, 32, 8, S, 64, torch.bfloat16)
            blocks = -(-S // 128) * 8 * B
            assert (p.splits > 1) == (blocks < fab.SMS), (B, S, p)
