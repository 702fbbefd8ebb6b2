"""K3b's launch planner (``rmsnorm_bwd.plan``), a pure function of the
shape, the dtypes, the rows' alignment and the SM count, on the CPU.

The register form (``csrc/rmsnorm_bwd.cu``) takes rows of exactly 1, 2 or
4 16-byte vectors a thread of a 256-thread block, a scale of x's dtype
and 16-byte aligned rows; everything else goes to the general form.  Each
block walks a contiguous run of rows and writes one row of dscale's
partials, so the plan must cover every row exactly once.
"""
import pytest
import torch

from repro_torch.kernels import rmsnorm_bwd as rmb

BF16, F32 = torch.bfloat16, torch.float32
# (rows, D, dtype, scale dtype, aligned) -> the form: the smoke's K3b
# cases (llama3.2-1b's 2048, rwkv6-7b's 4096, hymba's ragged 1600)
FORMS = [((4096, 2048, BF16, BF16, True), "regs"),
         ((4096, 4096, BF16, BF16, True), "regs"),
         ((4096, 2048, F32, F32, True), "regs"),
         ((4096, 4096, F32, F32, True), "regs"),
         ((1000, 1600, BF16, F32, True), "general"),
         ((1000, 1600, F32, F32, True), "general"),
         ((4097, 2048, BF16, BF16, True), "regs"),
         ((4096, 2048, BF16, F32, True), "general"),
         ((4096, 2048, BF16, BF16, False), "general"),
         ((1000, 2048, F32, F32, True), "regs"),
         ((8, 8192, F32, F32, True), "general")]


@pytest.mark.parametrize("args,form", FORMS)
def test_form_of_each_shape(args, form):
    assert rmb.plan(*args).form == form


@pytest.mark.parametrize("rows", [1, 2, 131, 132, 263, 1000, 4096, 4097,
                                  100_000])
@pytest.mark.parametrize("D,dtype", [(2048, BF16), (4096, BF16),
                                     (4096, F32), (1600, BF16)])
def test_blocks_cover_every_row_once(rows, D, dtype):
    p = rmb.plan(rows, D, dtype, dtype, True, 132)
    assert p.rows_per_block >= 1 and p.blocks >= 1
    assert p.blocks * p.rows_per_block >= rows
    assert (p.blocks - 1) * p.rows_per_block < rows


def test_one_wave_of_resident_blocks():
    """At the main shapes the blocks fit the card in one wave: 4, 2 and
    1 blocks an SM for 1, 2 and 4 vectors a thread, 2 for the general
    form."""
    for D, dtype, per_sm in [(2048, BF16, 4), (4096, BF16, 2),
                             (2048, F32, 2), (4096, F32, 1),
                             (1600, BF16, 2)]:
        for sms in (108, 132):
            p = rmb.plan(4096, D, dtype, dtype, True, sms)
            assert p.blocks <= per_sm * sms
            assert p.rows_per_block == -(-4096 // (per_sm * sms))


def test_plan_is_a_function_of_its_arguments():
    for args, _ in FORMS:
        assert rmb.plan(*args) == rmb.plan(*args)
        assert rmb.plan(*args, sms=132) == rmb.plan(*args)
    assert rmb.plan(0, 2048, BF16, BF16).blocks == 0
