"""K3's launch plan (``repro_torch.kernels.opope_attention._plan``) on the CPU.

The plan picks the route (``"sm90"``: TMA ring + wgmma, 128-row tiles;
``"tile"``: mma.sync on 64-row tiles, fp32 on CUDA cores) from the operands
alone, and on the sm90 route the rank-4 TMA tensor maps the wrapper hands
the kernel. The kernel runs only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 9); what is checked here is the arithmetic around
it: the main-path shapes of phase 9 take the sm90 route, fp32, head dims 16
and 32, causal S > T, misaligned bases or strides and stride-0 heads take
the tile route, the maps address every element of contiguous tensors and of
``[B, S, H, D]`` views as the tensors do, and the plan is a pure, cached
function of its arguments.
"""

import importlib

import pytest
import torch

from repro_torch.configs import get_config, shape_by_name

k3 = importlib.import_module("repro_torch.kernels.opope_attention")

ALIGNED = 1 << 20  # a 16-byte-aligned base address
BF16 = torch.bfloat16


def _bhsd_view_strides(b, n, h, d):
    """Element strides of ``x.transpose(1, 2)`` for a contiguous [B, N, H, D]
    tensor x: the [B, H, N, D] view the model's attention hands over."""
    return (n * h * d, d, h * d, 1)


def _contiguous_strides(b, h, n, d):
    return (h * n * d, n * d, d, 1)


def _plan(q_shape, t, dtype=BF16, causal=True, strides=None, ptrs=(ALIGNED,) * 3):
    b, h, s, d = q_shape
    if strides is None:
        strides = (_bhsd_view_strides(b, s, h, d),) + (_bhsd_view_strides(b, t, h, d),) * 2
    return k3._plan(q_shape, t, dtype, causal, strides, ptrs)


CFG = get_config("chatglm3-6b")
H, D = CFG.n_heads, CFG.head_dim_
# Phase 9's rows (chip_smoke.py): (B, S, T, causal), q and the expanded k, v
# as [B, H, N, D] views of [B, N, H, D] tensors.
MAIN_ROWS = {"prefill": (4, 2048, 2048, True), "continuation": (4, 512, 2048, True),
             "decode": (4, 1, 2048, True), "non-causal": (4, 2048, 2048, False),
             "prefill_32k": (1, 32768, 32768, True)}


def test_main_rows_are_chatglm3_attention_width():
    assert (H, D) == (32, 128)
    assert shape_by_name("prefill_32k").seq_len == MAIN_ROWS["prefill_32k"][1]


@pytest.mark.parametrize("row", sorted(MAIN_ROWS))
def test_main_path_rows_take_the_sm90_route(row):
    b, s, t, causal = MAIN_ROWS[row]
    plan = _plan((b, H, s, D), t, causal=causal)
    assert plan.route == "sm90" and len(plan.maps) == 3
    # The same rows on contiguous [B, H, N, D] tensors plan alike.
    strides = (_contiguous_strides(b, H, s, D),) + (_contiguous_strides(b, H, t, D),) * 2
    assert _plan((b, H, s, D), t, causal=causal, strides=strides).route == "sm90"


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,t,causal", [(1, 1, True), (127, 129, True), (300, 300, True),
                                        (129, 1000, False), (300, 1, False), (1, 300, True)])
def test_bf16_head_dims_64_and_128_take_the_sm90_route(s, t, causal, d):
    assert _plan((2, 3, s, d), t, causal=causal).route == "sm90"


@pytest.mark.parametrize("q_shape,t,dtype,causal", [
    ((4, 32, 2048, 128), 2048, torch.float32, True),  # fp32: wgmma would run it as TF32
    ((1, 1, 96, 128), 128, torch.float32, False),
    ((2, 3, 64, 32), 64, BF16, True),                 # head dim 32
    ((2, 4, 96, 16), 64, BF16, True),                 # head dim 16
    ((1, 1, 96, 64), 64, BF16, True),                 # causal S > T: rows without a key
    ((2, 2, 200, 128), 70, BF16, True),
], ids=["fp32", "fp32_noncausal", "d32", "d16", "causal_s_gt_t", "causal_s_gt_t_d128"])
def test_what_the_sm90_route_does_not_take_goes_to_tile(q_shape, t, dtype, causal):
    plan = _plan(q_shape, t, dtype=dtype, causal=causal)
    assert plan.route == "tile" and plan.maps is None


def test_causal_s_greater_than_t_is_tile_only_when_causal():
    assert _plan((1, 1, 96, 64), 64, causal=False).route == "sm90"


@pytest.mark.parametrize("case", ["q_base", "k_base", "v_base", "row_stride", "d_stride",
                                  "head_stride_0", "batch_stride_0", "row_stride_0"])
def test_operands_tma_cannot_describe_go_to_tile(case):
    b, h, s, t, d = 2, 4, 100, 160, 64
    q = _contiguous_strides(b, h, s, d)
    kv = _contiguous_strides(b, h, t, d)
    strides, ptrs = [q, kv, kv], [ALIGNED] * 3
    if case.endswith("_base"):
        ptrs["qkv".index(case[0])] = ALIGNED + 8
    elif case == "row_stride":     # rows of 68 elements: 136 bytes, not a multiple of 16
        strides[1] = (h * t * 68, t * 68, 68, 1)
    elif case == "d_stride":       # D not contiguous
        strides[2] = (h * t * d, t * d, 1, t)
    elif case == "head_stride_0":  # KV heads widened by expand
        strides[1] = strides[2] = (t * d, 0, d, 1)
    elif case == "batch_stride_0":
        strides[0] = (0, s * d, d, 1)
    elif case == "row_stride_0":
        strides[2] = (h * d, d, 0, 1)
    assert _plan((b, h, s, d), t, strides=strides, ptrs=ptrs).route == "tile"
    # The same shape with contiguous operands on aligned bases goes to sm90.
    assert _plan((b, h, s, d), t, strides=[q, kv, kv]).route == "sm90"


def test_size_one_dims_take_any_stride():
    """A dim of size 1 is never stepped along: its stride (0, or one TMA
    could not take) does not keep an operand off the sm90 route, and the
    map gets the contiguous stride in its place."""
    b, h, s, t, d = 1, 1, 1, 300, 128
    odd = (3, 0, 5, 1)  # batch, head and row strides of size-1 dims
    kv = _contiguous_strides(b, h, t, d)
    plan = _plan((b, h, s, d), t, strides=[odd, kv, kv])
    assert plan.route == "sm90"
    assert plan.maps[0] == ((d, s, h, b), (2 * d, 2 * d, 2 * d))


def test_tensor_maps_of_contiguous_and_bshd_operands():
    b, h, s, t, d = 4, 32, 512, 2048, 128
    contiguous = _plan((b, h, s, d), t, strides=[_contiguous_strides(b, h, s, d)]
                       + [_contiguous_strides(b, h, t, d)] * 2)
    assert contiguous.maps == (((d, s, h, b), (2 * d, 2 * s * d, 2 * h * s * d)),
                               ((d, t, h, b), (2 * d, 2 * t * d, 2 * h * t * d)),
                               ((d, t, h, b), (2 * d, 2 * t * d, 2 * h * t * d)))
    bshd = _plan((b, h, s, d), t)
    assert bshd.maps == (((d, s, h, b), (2 * h * d, 2 * d, 2 * s * h * d)),
                         ((d, t, h, b), (2 * h * d, 2 * d, 2 * t * h * d)),
                         ((d, t, h, b), (2 * h * d, 2 * d, 2 * t * h * d)))


@pytest.mark.parametrize("layout", ["bhsd", "bshd", "sliced_heads", "decode_row"])
def test_tensor_map_addresses_every_element_as_the_tensor_does(layout):
    """Byte offset of element (b, h, n, d) through the map's dims and
    strides equals the tensor's own, for every element: a map that reads
    the next head's rows, or past the tensor, would not."""
    if layout == "bhsd":
        x = torch.empty((2, 3, 5, 64), dtype=BF16)
    elif layout == "bshd":
        x = torch.empty((2, 5, 3, 64), dtype=BF16).transpose(1, 2)
    elif layout == "sliced_heads":  # every other head of a [B, S, 6, D] tensor
        x = torch.empty((2, 5, 6, 128), dtype=BF16).transpose(1, 2)[:, ::2]
    else:
        x = torch.empty((4, 1, 3, 128), dtype=BF16).transpose(1, 2)
    (dd, n, h, b), (s_n, s_h, s_b) = k3._tma_map(x.shape, x.stride(), x.element_size())
    assert (b, h, n, dd) == tuple(x.shape)
    base = x.data_ptr()
    for ib in range(b):
        for ih in range(h):
            for i_n in range(n):
                for id_ in (0, dd // 2, dd - 1):
                    want = x[ib, ih, i_n, id_:].data_ptr() - base
                    assert ib * s_b + ih * s_h + i_n * s_n + 2 * id_ == want


def test_plan_is_a_pure_cached_function_of_its_arguments():
    args = [((4, 32, 2048, 128), 2048, BF16, True), ((4, 32, 1, 128), 2048, BF16, True),
            ((2, 3, 64, 32), 64, BF16, True), ((1, 1, 96, 128), 128, torch.float32, False)]
    first = [_plan(*a) for a in args]
    info = k3._plan_aligned.cache_info()
    again = [_plan(*a) for a in reversed(args)][::-1]
    assert first == again
    assert k3._plan_aligned.cache_info().hits >= info.hits + len(args)
    assert [p.route for p in first] == ["sm90", "sm90", "tile", "tile"]
    # Only the bases' alignment enters, not their values.
    assert _plan(*args[0], ptrs=(16, 32, 4096)) == first[0]
    assert _plan(*args[0], ptrs=(16, 32, 4098)).route == "tile"


def test_wrapper_on_cpu_counts_no_route():
    before = (k3.opope_attention.launches, dict(k3.opope_attention.launches_by_route))
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, n, 64), generator=gen).to(BF16) for n in (5, 7, 7))
    got = k3.opope_attention_bhsd(q, k, v)
    assert (k3.opope_attention.launches, k3.opope_attention.launches_by_route) == before
    assert torch.equal(got, k3.opope_attention_plain(q, k, v))


@pytest.mark.parametrize("route", [None, "sm90", "tile"])
def test_launching_path_refuses_cpu_tensors(route):
    x = torch.ones((1, 1, 8, 64), dtype=BF16)
    with pytest.raises(ValueError, match="cuda"):
        k3._launch(x, x, x, True, 128, 128, route=route)
