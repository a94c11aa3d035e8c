"""Kernels K18-K20 (``csrc/glcm.cu``, ``crop_summary.cu``, ``crop_histogram.cu``)
against their plain versions on the card, on every input their plain
versions take: more than 256 grey levels on int32 crops, a crop past 11.9M
pixel pairs an offset whose moments pass int64 in the centred products, a
cell past 2^32 counts (sum c^2 past 2^64), more than 1024 quantiles, more than 1023 bins by ``jnp.histogram``'s rule and
a histogram past shared memory by the batched rule; and on each route of
each kernel. This file imports no JAX: it is the one to run where there is a
card. K20's uint8 entry is held to the plain version of the same crops
as float32 on each of its routes. Every comparison is bitwise (the values are integers, so the double
sums of the mean and std are exact).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from squidpy_torch.ops import features as F

OFFSETS = [(0, 1), (1, 1), (1, 0), (1, -1)]


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _same(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got.to(torch.float64).nan_to_num(123.0), want.to(torch.float64).nan_to_num(123.0))


def _glcm(imgs, channels, offsets, levels, symmetric=False, ignore=None, counts=False):
    if counts:
        n, h, w, _ = imgs.shape
        planes = imgs.permute(0, 3, 1, 2)[:, channels].reshape(-1, h, w)
        want = F._glcm_counts_plain(planes, offsets, levels)
    else:
        want = F._glcm_props_batched_plain(imgs, channels, offsets, levels, symmetric, ignore)
    _same(F._glcm_k18(imgs, channels, offsets, levels, symmetric, ignore, counts), want)


def _tissue(n: int, side: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    base = rng.integers(60, 240, (n, 1, 1, 3))
    return torch.from_numpy(np.clip(base + rng.normal(0, 8, (n, side, side, 3)), 0, 255).astype(np.uint8)).cuda()


@pytest.mark.cuda
def test_k18_past_256_levels_on_card(cuda_card):
    lv = torch.from_numpy(np.random.default_rng(1).integers(-3, 300, (16, 48, 48, 1)).astype(np.int32)).cuda()
    assert F.k18_route(48, 48, OFFSETS, False, 300, torch.int32) == "global"
    _glcm(lv, [0], OFFSETS, 300)
    _glcm(lv, [0], OFFSETS, 300, counts=True)
    _glcm(lv, [0], OFFSETS[:1], 300, symmetric=True, ignore=299)
    _glcm(lv.to(torch.int64), [0], OFFSETS[:2], 300)


@pytest.mark.cuda
def test_k18_bright_4000_crop_on_card(cuda_card):
    """15,996,000 pairs an offset (past 11.9M), S sum i^2 past 2^63."""
    rng = np.random.default_rng(2)
    bright = torch.from_numpy(np.clip(rng.normal(250, 4, (1, 4000, 4000, 1)), 0, 255).astype(np.uint8)).cuda()
    bright[0, :2000, :2000] = 255
    assert F.k18_route(4000, 4000, OFFSETS, False, 256) == "global"
    _glcm(bright, [0], OFFSETS, 256)


@pytest.mark.cuda
def test_k18_past_2_32_counts_a_cell_on_card(cuda_card):
    """A crop of 65,600^2 pixels, nearly all 0: 4.3e9 pairs an offset, most on
    cell (0, 0), which passes uint32 (the 64-bit counters), and with
    ``symmetric`` on 46,400^2 (cell (0, 0) counting 2 a pair past 2^32; sum
    c^2 past 2^64, the 128-bit sums)."""
    side = 65_600
    img = torch.zeros((1, side, side, 1), dtype=torch.uint8, device="cuda")
    img[0, ::1000] = 255
    img[0, 7::997, ::3] = 90
    _glcm(img, [0], [(0, 1)], 256, counts=True)
    sub = img[:, :46_400, :46_400].contiguous()
    del img
    _glcm(sub, [0], [(0, 1)], 256, symmetric=True)


@pytest.mark.cuda
def test_k18_routes_on_card(cuda_card):
    crops = _tissue(300, 89, 3)
    _glcm(crops, [0, 1, 2], OFFSETS, 256)  # shared, four pairs a thread
    _glcm(crops[-7:], [2, 0], OFFSETS, 256)
    _glcm(crops, [1], OFFSETS, 256, symmetric=True)  # shared, a pair a thread
    _glcm(crops[:16], [1], OFFSETS, 256, counts=True)
    q = torch.from_numpy(np.random.default_rng(4).integers(0, 33, (200, 24, 24, 1)).astype(np.uint8)).cuda()
    _glcm(q, [0], [(0, 1)], 33, symmetric=True, ignore=32)
    _glcm(_tissue(8, 300, 5), [0, 1, 2], OFFSETS, 256)  # global


def _summary(x, quantiles, rule=0):
    table = F.quantile_table(tuple(quantiles), x.shape[1], rule)
    got = torch.cat([t.reshape(-1) for t in F._summary_k19(x, table, rule)])
    _same(got, torch.cat([t.reshape(-1) for t in F._summary_plain(x, table, rule)]))


@pytest.mark.cuda
def test_k19_past_1024_quantiles_on_card(cuda_card):
    x = _tissue(50, 89, 6).reshape(50, -1, 3).to(torch.float32).contiguous()
    _summary(x, np.linspace(0.0, 1.0, 1500))
    _summary(x[:1, :, :1].contiguous(), np.linspace(0.0, 1.0, 1500), rule=1)


@pytest.mark.cuda
def test_k19_routes_on_card(cuda_card):
    x = _tissue(200, 89, 7).reshape(200, -1, 3).to(torch.float32).contiguous()
    _summary(x, (0.9, 0.5, 0.1))
    _summary(x[:1, :, :1].contiguous(), (0.9, 0.5, 0.1), rule=1)
    rng = np.random.default_rng(8)
    _summary(torch.from_numpy(rng.normal(0, 50, (4, 400 * 400, 1)).astype(np.float32)).cuda(), (0.9, 0.5, 0.1))
    large = _tissue(1, 300, 10)[..., :1].reshape(1, -1, 1).to(torch.float32).contiguous()
    assert F._k19_layout(1, large.shape[1], 6, *F._device_info(large.device))[0] == "split"
    _summary(large, (0.9, 0.5, 0.1), rule=1)  # one crop past the shared keys, over several blocks
    special = large.clone()
    special[0, ::5, 0] = float("nan")
    special[0, ::7, 0] = -0.0
    _summary(special, (0.9, 0.5, 0.1), rule=1)


def _hist(x, bins, v_range, rule, entry=None, **layout):
    n, p, c = x.shape
    lo = torch.full((n,), 0.0 if v_range is None else float(v_range[0]), device="cuda")
    hi = torch.full((n,), 0.0 if v_range is None else float(v_range[1]), device="cuda")
    chosen = F._k20_layout(n, p, c, bins, rule, x.dtype == torch.uint8, *F._device_info(x.device))
    if entry is not None:
        assert chosen.entry == entry, chosen
    for key, value in layout.items():
        assert getattr(chosen, key) == value, chosen
    _same(F._histogram_k20(x, bins, rule, lo, hi, v_range is None),
          F._histogram_plain(x.to(torch.float32), bins, rule, lo, hi, v_range is None))


@pytest.mark.cuda
def test_k20_past_shared_memory_on_card(cuda_card):
    x = _tissue(40, 89, 9).reshape(40, -1, 3).to(torch.float32).contiguous()
    _hist(x[:1, :, :1].contiguous(), 2000, (40.0, 250.0), 1, edges_shared=False)
    _hist(x[:1, :, :1].contiguous(), 1023, (40.0, 250.0), 1, edges_shared=True)
    _hist(x, 30_000, None, 0, hist_shared=False)
    _hist(x, 30_000, (10.0, 200.0), 0)
    _hist(x, 10, None, 0)
    big = _tissue(6, 177, 10).reshape(6, -1, 3).to(torch.float32).contiguous()
    _hist(big, 10, None, 0, "float32")  # 376 KB a crop
    _hist(x[1:], 10, (60.0, 200.5), 0)  # a crop start off 16 bytes
    wide = _tissue(4, 160, 13)[:, :120].reshape(4, -1, 3).to(torch.float32).contiguous()
    assert wide.shape[1] == 19_200
    _hist(wide, 10, None, 0, "float32")  # 230 KB a crop, each crop's own range
    _hist(x[:2, :, :1].repeat(1, 1, 3).contiguous(), 13_653, None, 0, hist_shared=True)  # the shared histogram's edge


@pytest.mark.cuda
def test_k20_uint8_entry_on_card(cuda_card):
    """The uint8 entry on its routes (fused; the value table and the fold
    kernel, split over blocks or at the channels past the fold's shared
    words; the float32 entry past one block's counters), bitwise the plain
    version of the float32 crops."""
    x = _tissue(600, 89, 11).reshape(600, -1, 3)
    for v_range, rule, bins in ((None, 0, 10), ((50.0, 200.0), 0, 10), ((50.5, 200.25), 0, 7), ((90.0, 90.0), 0, 5),
                                (None, 0, 256), (None, 0, 300), (None, 0, 30_000), ((10.0, 250.0), 0, 30_000)):
        _hist(x, bins, v_range, rule, "uint8")
    one = x[:1, :, :1].contiguous()
    for bins, v_range in ((10, (40.0, 250.0)), (2000, (40.0, 250.0)), (2000, (-3.0, 300.0)), (1, (100.0, 100.0)),
                          (30_000, (0.0, 255.0))):
        _hist(one, bins, v_range, 1, "uint8")
    flat = torch.full((50, 89 * 89, 3), 137, dtype=torch.uint8, device="cuda")
    flat[::7, ::13, 1] = 138  # nearly constant crops
    _hist(flat, 10, None, 0)
    _hist(x[1:], 10, None, 0)  # a crop start off 16 bytes
    slide = torch.from_numpy(np.random.default_rng(12).integers(0, 256, (1, 3000 * 3000, 1), dtype=np.uint8)).cuda()
    layout = F._k20_layout(1, slide.shape[1], 1, 10, 1, True, *F._device_info(slide.device))
    assert layout.splits > 1 and not layout.fused
    _hist(slide, 10, (20.0, 230.0), 1)  # split over blocks, then the fold kernel
    _hist(slide, 10, None, 0)
    for c in (1, 2, 4, 7):
        _hist(torch.from_numpy(np.random.default_rng(c).integers(0, 256, (30, 999, c), dtype=np.uint8)).cuda(), 10,
              None, 0, "uint8")
    smem = F._device_info(x.device)[0]
    fused_most = (smem // 4 - F.K20_FOLD_WORDS) // (F.K20_CHANNEL_WORDS + 10)
    most = smem // 4 // F.K20_CHANNEL_WORDS
    rng = np.random.default_rng(5)
    for c, entry, fused in ((109, "uint8", True), (fused_most, "uint8", True), (fused_most + 1, "uint8", False),
                            (most, "uint8", False), (most + 1, "float32", False)):
        crops = torch.from_numpy(rng.integers(0, 256, (140, 99, c), dtype=np.uint8)).cuda()  # more crops than SMs
        _hist(crops, 10, None, 0, entry, fused=fused)  # at each edge of shared memory
    many = torch.from_numpy(rng.integers(0, 256, (4, 99, 500), dtype=np.uint8)).cuda()
    _hist(many, 10, None, 0, "float32")  # no block's 500 x 256 counters fit: the float32 entry
