"""The layout plan of the sample-loop kernel (K1) and its argmax merge rule,
on the CPU.

``k1_plan`` mirrors csrc/wavernn_sample.cu ``make_layout`` term for term;
the kernel's own layout functions are compared with it by the wrapper on the
card.  Here: every output column has one owner, the default widths fit one
block's shared memory, oversized widths raise, and the kernel's two-level
argmax (first maximum per block, then a merge of the per-block partials)
equals ``torch.argmax``."""

import math

import pytest
import torch

from tacotronv2_wavernn_chinese_tpu_torch.ops import wavernn_kernel as WK

LAYERS = {"I": "H", "gru1": "H", "gru2": "H", "fc1": "FC", "fc2": "FC", "fc3": "NC"}
INT_MAX = 2**31 - 1


@pytest.mark.parametrize("n_sm", [132, 114, 8])
@pytest.mark.parametrize("widths", [(512, 512, 1024), (64, 64, 256), (96, 160, 512)])
def test_every_column_has_one_owner(widths, n_sm):
    H, FC, NC = widths
    plan = WK.k1_plan(H, FC, NC, n_sm, 16)
    assert plan.blocks <= n_sm
    for layer, dim in LAYERS.items():
        width = getattr(plan, dim)
        ranges = plan.ranges(layer)
        assert len(ranges) == plan.blocks
        owners = [k for k, r in enumerate(ranges) for _ in r]
        assert [c for r in ranges for c in r] == list(range(width)), layer
        assert owners == sorted(owners)  # ascending blocks own ascending columns
        assert max(len(r) for r in ranges) == {"H": plan.units, "FC": plan.fc_cols, "NC": plan.logits}[dim]


def test_default_widths_fit_at_the_chosen_fold_tile():
    plan = WK.choose_k1_plan(512, 512, 1024, 132)
    assert (plan.blocks, plan.units, plan.fc_cols, plan.logits) == (128, 4, 4, 8)
    assert plan.fold_tile == 16
    assert plan.smem_bytes <= WK.SMEM_LIMIT == 232448
    # the weight slices alone: ~33,900 floats (136 KB) per block
    weights = 4 * 112 + 512 + 6 * 4 * 512 + 3 * 4 * 544 + 3 * 4 * 512 + 4 * 544 + 4 * 544 + 8 * 512
    assert weights == 34368 and plan.smem_bytes > 4 * weights


def test_fewer_sms_take_a_smaller_fold_tile():
    plan = WK.choose_k1_plan(512, 512, 1024, 114)
    assert (plan.blocks, plan.units, plan.fold_tile) == (103, 5, 8)
    assert plan.smem_bytes <= WK.SMEM_LIMIT < WK.k1_plan(512, 512, 1024, 114, 16).smem_bytes


@pytest.mark.parametrize("args", [(4096, 512, 1024, 132), (512, 512, 1024, 8), (512, 4096, 1024, 132)])
def test_a_layout_that_does_not_fit_raises(args):
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue item 4"):
        WK.choose_k1_plan(*args)


def test_scratch_holds_every_exchange_buffer():
    plan = WK.choose_k1_plan(512, 512, 1024, 132)
    B = 16
    # h1, h2 double-buffered; x1, x2, xt_cond; y1, y2; (value, index) partials
    assert plan.scratch_floats(B) == 2 * 2 * B * 512 + 3 * B * 512 + 2 * B * 512 + 2 * B * plan.blocks


# ---------------------------------------------------------------------------
# the argmax rule, mirrored from the kernel
# ---------------------------------------------------------------------------


def _block_partials(logits: list[float], plan) -> list[tuple[float, int]]:
    """Phase 5: each block's first maximum over its ascending logits
    (strict >, from (-inf, INT_MAX)), as the kernel writes it."""
    out = []
    for cols in plan.ranges("fc3"):
        bv, bi = -math.inf, INT_MAX
        for n in cols:
            if logits[n] > bv:
                bv, bi = logits[n], n
        out.append((bv, bi))
    return out


def _merge(partials: list[tuple[float, int]], start: int) -> int:
    """Phase 1: the partials merged from block ``start`` on (each block
    starts at its own offset), under v > bv || (v == bv && i < bi)."""
    bv, bi = -math.inf, INT_MAX
    G = len(partials)
    for j in range(G):
        v, i = partials[(j + start) % G]
        if v > bv or (v == bv and i < bi):
            bv, bi = v, i
    return 0 if bi == INT_MAX else bi


def _cases(NC: int, plan) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    rows = [torch.randn(NC, generator=g) for _ in range(4)]
    per = plan.logits
    tie = torch.randn(NC, generator=g)
    tie[per - 1] = tie[per] = tie[3 * per] = 9.0  # equal maxima across two block boundaries
    rows.append(tie)
    inner = torch.randn(NC, generator=g)
    inner[2 * per + 1] = inner[2 * per + 3] = 7.0  # inside one block
    rows.append(inner)
    rows.append(torch.full((NC,), 5.0))  # every column tied
    rows.append(torch.full((NC,), float("nan")))  # all NaN: label 0
    rows.append(torch.full((NC,), float("-inf")))
    spikes = torch.randn(NC, generator=g)
    spikes[NC - 1] = float("inf")  # the last column of the last block
    rows.append(spikes)
    return torch.stack(rows)


@pytest.mark.parametrize("n_sm", [132, 114, 8])
def test_block_partials_merge_to_torch_argmax(n_sm):
    NC = 1024
    plan = WK.k1_plan(512, 512, NC, n_sm, 16)
    logits = _cases(NC, plan)
    want = torch.argmax(logits, dim=-1).tolist()
    for row, w in zip(logits.tolist(), want):
        partials = _block_partials(row, plan)
        for start in (0, 1, plan.blocks // 2, plan.blocks - 1):
            assert _merge(partials, start) == w
