"""K4's launch plan (``repro_torch.kernels.opope_grouped._plan``) on the CPU.

The plan picks the route (``"sm90"``: TMA + wgmma over rank-3 per-group
tensor maps; ``"tile"``: the 64x64 tile body) from the operands alone, and
on the sm90 route the tile configuration. The kernel runs only on the card
(``tests/test_torch_gpu.py``); what is checked here is what the wrapper
hands it: deepseek-moe-16b's expert GEMMs take the sm90 route at every
capacity its paths give them, fp32 and operands TMA cannot describe take
the tile route, K is never split, M above 64 takes the 128-row tile, the
plan is a pure function of its arguments, and the CPU wrapper runs the
plain version without counting a route.
"""

import importlib

import pytest
import torch

from repro_torch.configs import get_config

k4 = importlib.import_module("repro_torch.kernels.opope_grouped")

ALIGNED = 1 << 20  # a 16-byte-aligned base address


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Keep this file's CPU share small beside the suite's wall-clock tests.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _expert_shapes():
    """(K, N) of deepseek-moe-16b's three expert GEMMs: w_up, w_gate, w_down."""
    m = get_config("deepseek-moe-16b").moe
    d = get_config("deepseek-moe-16b").d_model
    return [(d, m.d_ff_expert), (d, m.d_ff_expert), (m.d_ff_expert, d)]


EXPERT_SHAPES = sorted(set(_expert_shapes()))


def test_expert_shapes_are_the_models():
    assert EXPERT_SHAPES == [(1408, 2048), (2048, 1408)]


@pytest.mark.parametrize("m", [1, 30, 60])
@pytest.mark.parametrize("k,n", EXPERT_SHAPES, ids=lambda v: str(v))
def test_expert_shapes_take_the_sm90_route(k, n, m):
    plan = k4._plan(m, n, k, torch.bfloat16, ALIGNED, ALIGNED)
    assert plan.route == "sm90"
    # Two blocks an SM, each with a 4-stage ring (K1's one block keeps 8).
    assert (plan.config, plan.bm, plan.bn, plan.bk, plan.stages) == (0, 64, 128, 64, 4)
    assert plan.m_tiles == 1 and plan.n_tiles == -(-n // 128)
    # G x N tiles fill the card on their own: K is never split.
    assert plan.splits == 1 and plan.k_bounds == (0, k)
    assert 64 * plan.tiles >= 704


@pytest.mark.parametrize("m,bm,stages", [(64, 64, 4), (65, 128, 5), (512, 128, 5)])
def test_m_above_64_takes_the_128_row_tile(m, bm, stages):
    plan = k4._plan(m, 1408, 2048, torch.bfloat16, ALIGNED, ALIGNED)
    assert plan.route == "sm90" and (plan.bm, plan.stages) == (bm, stages)
    assert plan.m_tiles == -(-m // bm) and plan.splits == 1


@pytest.mark.parametrize("m,k,n", [(1, 2048, 1408), (60, 1408, 2048), (5, 40, 24), (1, 8, 8)])
def test_fp32_takes_the_tile_route(m, k, n):
    plan = k4._plan(m, n, k, torch.float32, ALIGNED, ALIGNED)
    assert plan.route == "tile" and plan.splits == 1
    assert (plan.bm, plan.bn, plan.bk) == (64, 64, 32)
    assert plan.k_bounds == (0, k)


@pytest.mark.parametrize("m,k,n,a_ptr,b_ptr", [
    (5, 300, 200, ALIGNED, ALIGNED),        # A's row of 600 bytes
    (1, 2048, 100, ALIGNED, ALIGNED),       # B's row of 200 bytes
    (1, 2048, 1408, ALIGNED + 8, ALIGNED),  # A's base 8 bytes off
    (1, 2048, 1408, ALIGNED, ALIGNED + 2),  # B's base 2 bytes off
    (1, 0, 64, ALIGNED, ALIGNED),           # no K: nothing for TMA to load
], ids=["a_stride", "b_stride", "a_base", "b_base", "k0"])
def test_operands_tma_cannot_describe_take_the_tile_route(m, k, n, a_ptr, b_ptr):
    assert k4._plan(m, n, k, torch.bfloat16, a_ptr, b_ptr).route == "tile"
    # The same shape with aligned bases and 8-element rows goes to sm90.
    if k % 8 == 0 and n % 8 == 0 and k > 0:
        assert k4._plan(m, n, k, torch.bfloat16, ALIGNED, ALIGNED).route == "sm90"


def test_plan_is_a_pure_function_of_its_arguments():
    args = [(1, 1408, 2048, torch.bfloat16, ALIGNED, ALIGNED),
            (60, 2048, 1408, torch.bfloat16, ALIGNED, ALIGNED),
            (130, 200, 300, torch.bfloat16, ALIGNED, ALIGNED),
            (5, 24, 40, torch.float32, ALIGNED, ALIGNED)]
    first = [k4._plan(*a) for a in args]
    again = [k4._plan(*a) for a in reversed(args)][::-1]
    assert first == again
    assert len({hash(p) for p in first}) == len(first)
    # Only alignment of the bases matters, not their values.
    assert k4._plan(1, 1408, 2048, torch.bfloat16, 16, 32) == first[0]


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_route():
    before = (k4.opope_gemm_grouped.launches, dict(k4.opope_gemm_grouped.launches_by_route))
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((3, 4, 64), generator=gen).bfloat16()
    b = torch.randn((3, 64, 128), generator=gen).bfloat16()
    got = k4.opope_gemm_grouped(a, b)
    assert (k4.opope_gemm_grouped.launches, k4.opope_gemm_grouped.launches_by_route) == before
    assert torch.equal(got, k4.opope_gemm_grouped_plain(a, b))
    torch.testing.assert_close(got.float(), torch.bmm(a.float(), b.float()).bfloat16().float())


def test_launching_path_refuses_cpu_tensors():
    a = torch.randn(2, 4, 64)
    b = torch.randn(2, 64, 128)
    with pytest.raises(ValueError, match="cuda"):
        k4._run(a, b, None, None, (), ())
