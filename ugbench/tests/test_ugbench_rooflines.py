import pytest

from ugbench import peaks, registry


def test_k1_counts_bytes_and_a_fast_dct():
    k1 = registry.roofline("k1")
    w, h, coded = 1920, 1080, 400_000
    nbytes = w * h * 2 + coded
    blocks = 2 * w * h // 64
    assert blocks == 64_800
    assert k1.FLOP_PER_BLOCK == 587
    assert k1.min_seconds(w, h, coded) == pytest.approx(max(nbytes / peaks.HBM_BYTES,
                                                            blocks * 587 / peaks.FP32_FLOPS))
    # bound by bytes at these sizes, and well under the dense 8,192 FLOP a block
    assert nbytes / peaks.HBM_BYTES > blocks * 587 / peaks.FP32_FLOPS
    assert k1.min_seconds(3840, 2160, coded) > k1.min_seconds(w, h, coded)


def test_k2_counts_each_byte_once():
    k2 = registry.roofline("k2")
    assert k2.min_seconds(282, 26, 1000, 100) == pytest.approx(4 * (282 * 100 + 26 * 100 + 1000 + 27)
                                                            / peaks.HBM_BYTES)
    # the peel's check matrix: the left part, the diagonal and the staircase
    assert k2.peel_launch(1600, 256, 26, 1280) == pytest.approx(k2.min_seconds(282, 26, 1280 + 26 + 25, 400))
