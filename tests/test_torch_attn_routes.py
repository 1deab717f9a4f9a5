"""Which kernel #4's wrapper runs (``kernels/flash_attention.forward_route``)
and how the split-key kernel cuts the keys (``split_plan``), on the CPU:
both are pure functions of the call's shapes and, for the plan, of the
kernel's blocks the card holds at once, so they are checked here without
a card; likewise which calls the backward kernel takes
(``backward_supported``) and which model's training the refusal of the
others names (``ops._training_wait``).  The kernels themselves are held
to the plain version on the card (``tests/test_torch_cuda_kernels.py``)."""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import flash_attention as tfa

# the split-key kernel's blocks an H100 holds at once (132 SMs): 6 an SM
# of the one-query instance, 2 of the 2- and 4-query ones (registers)
H100_RESIDENT = 132 * 6
H100_RESIDENT_4Q = 132 * 2

# (B, H, T): whisper-tiny's decode step (8 x 6 pairs over 1500 frames) and
# past the card (40 x 6 = 240 pairs), one key, ranges ragged against the
# 32-key groups and the 128-key ranges, GQA-sized and wide batches, and
# keys past a long context
PLAN_CASES = [(8, 6, 1500), (40, 6, 1500), (1, 1, 1), (2, 4, 127),
              (1, 6, 128), (2, 4, 129), (2, 4, 257), (1, 1, 4096),
              (64, 32, 1500), (1, 16, 100_000), (3, 5, 31), (1, 2, 33)]


def _ranges(T, splits, chunk):
    return [(j * chunk, min(T, (j + 1) * chunk)) for j in range(splits)]


@pytest.mark.parametrize("resident", [H100_RESIDENT, H100_RESIDENT_4Q, 1])
@pytest.mark.parametrize("B,H,T", PLAN_CASES)
def test_split_plan_covers_the_keys(B, H, T, resident):
    """At least one range, none empty, the ranges cover [0, T) exactly
    and in order, in whole 32-key groups (but the last), and the same plan
    every time."""
    splits, chunk = tfa.split_plan(B, H, 1, T, resident)
    assert (splits, chunk) == tfa.split_plan(B, H, 1, T, resident)
    assert splits >= 1 and chunk >= 1
    ranges = _ranges(T, splits, chunk)
    assert all(lo < hi for lo, hi in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == T
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if splits > 1:
        assert chunk % tfa.SPLIT_GROUP == 0
    # a range a SPLIT_KEYS keys where the card holds the blocks at once,
    # else no more blocks than it holds
    if B * H * -(-T // tfa.SPLIT_KEYS) <= resident:
        assert splits == -(-T // tfa.SPLIT_KEYS)
        assert chunk <= tfa.SPLIT_KEYS
    else:
        assert splits == 1 or B * H * splits <= resident


@pytest.mark.parametrize("B,H,S,T", [(32, 6, 448, 1500), (32, 6, 448, 448),
                                     (4, 16, 8192, 8192), (8, 6, 5, 1500),
                                     (1, 1, 17, 3)])
def test_split_plan_one_split_at_prefill_shapes(B, H, S, T):
    """Past the cut-off (whisper's prefill, the serving prefill, five
    queries) the plan is one range of all T keys, and the wrapper
    does not take the split-key route."""
    assert S > tfa.SPLIT_MAX_QUERIES
    assert tfa.split_plan(B, H, S, T, H100_RESIDENT) == (1, T)
    assert tfa.forward_route(torch.bfloat16, 64, 64, S, False,
                             0) == "tma_wgmma"


def test_split_plan_at_whisper_decode():
    """whisper-tiny's decode step on an H100: 12 ranges of 128 keys, so
    48 pairs become 576 blocks (the wrapper's docstring)."""
    assert tfa.split_plan(8, 6, 1, 1500, H100_RESIDENT) == (12, 128)


@pytest.mark.parametrize("dtype,D,Dv,S,causal,window,want", [
    (torch.bfloat16, 64, 64, 1, False, 0, "split_keys"),
    (torch.bfloat16, 64, 64, 4, False, 0, "split_keys"),
    (torch.bfloat16, 64, 64, 5, False, 0, "tma_wgmma"),
    (torch.bfloat16, 64, 64, 1, True, 0, "tma_wgmma"),
    (torch.bfloat16, 64, 64, 1, False, 16, "tma_wgmma"),
    (torch.bfloat16, 64, 64, 448, False, 0, "tma_wgmma"),
    (torch.bfloat16, 64, 64, 448, True, 0, "tma_wgmma"),
    (torch.bfloat16, 128, 128, 1, False, 0, "tma_wgmma"),
    (torch.bfloat16, 192, 128, 4096, True, 0, "tma_wgmma"),
    (torch.bfloat16, 80, 80, 1, False, 0, "tma_wgmma"),
    (torch.bfloat16, 96, 96, 70, False, 0, "tma_wgmma"),
    (torch.bfloat16, 32, 32, 1, False, 0, "mma_sync"),
    (torch.bfloat16, 32, 32, 300, True, 5000, "mma_sync"),
    (torch.float32, 64, 64, 1, False, 0, "fma"),
    (torch.float32, 128, 128, 4096, True, 0, "fma")])
def test_forward_route(dtype, D, Dv, S, causal, window, want):
    """bf16 (64, 64) takes the split-key kernel at up to
    ``SPLIT_MAX_QUERIES`` non-causal, windowless queries and the TMA +
    wgmma kernel otherwise, as do 80 to 192; D = 32 stays on mma.sync;
    fp32 runs on the FMA units."""
    assert tfa.forward_route(dtype, D, Dv, S, causal, window) == want


# (dtype, D, Dv, T) of q (1, 64, 4, D), k (1, T, 2, D), v (1, T, 2, Dv):
# the backward kernel takes bf16 self-attention (T == S) at one head dim
# in (64, 80, 96, 128), and T != S at 64 (whisper's cross-attention);
# fp32, D = 32, MLA's (192, 128), (192, 192) and T != S at 80 are refused
BWD_CASES = [(torch.bfloat16, 64, 64, 64, True),
             (torch.bfloat16, 80, 80, 64, True),
             (torch.bfloat16, 96, 96, 64, True),
             (torch.bfloat16, 128, 128, 64, True),
             (torch.float32, 80, 80, 64, False),
             (torch.float32, 96, 96, 64, False),
             (torch.float32, 128, 128, 64, False),
             (torch.bfloat16, 32, 32, 64, False),
             (torch.bfloat16, 192, 128, 64, False),
             (torch.bfloat16, 192, 192, 64, False),
             (torch.bfloat16, 64, 64, 100, True),
             (torch.bfloat16, 80, 80, 100, False)]


def _qkv(dtype, D, Dv, T):
    return (torch.zeros(1, 64, 4, D, dtype=dtype),
            torch.zeros(1, T, 2, D, dtype=dtype),
            torch.zeros(1, T, 2, Dv, dtype=dtype))


@pytest.mark.parametrize("dtype,D,Dv,T,want", BWD_CASES)
def test_backward_supported(dtype, D, Dv, T, want):
    q, _, v = _qkv(dtype, D, Dv, T)
    assert tfa.backward_supported(q, v) is want
    assert (want and D in tfa.BWD_HEAD_DIMS) or not want


@pytest.mark.parametrize("dtype,D,Dv,T,who", [
    (torch.bfloat16, 64, 64, 100, None), (torch.bfloat16, 80, 80, 100, None),
    (torch.bfloat16, 192, 128, 64, "deepseek-v2-lite"),
    (torch.bfloat16, 192, 192, 64, "nemotron-4-340b"),
    (torch.float32, 80, 80, 64, None), (torch.float32, 96, 96, 64, None),
    (torch.bfloat16, 32, 32, 64, None)])
def test_training_wait_names_item_11c(dtype, D, Dv, T, who):
    """The tail of ``ops.flash_attention``'s refusal under grad on the card:
    deepseek-v2-lite's (MLA) and nemotron-4-340b's (192, 192) training
    under ROADMAP item 11c; nothing for fp32, D = 32 or keys of their own
    length at 80, which no model trains on the card, and no longer
    zamba2, phi-3-vision (80 and 96 have a backward kernel) or whisper
    (its cross-attention's T != S at 64 has one)."""
    from repro_torch.kernels import ops
    q, _, v = _qkv(dtype, D, Dv, T)
    tail = ops._training_wait(q, v)
    if who is None:
        assert tail == ""
    else:
        assert f"item 11c: {who} training" in tail
        assert "the model zoo" in tail
    for other in ("zamba2", "phi-3", "whisper"):
        assert other not in tail
