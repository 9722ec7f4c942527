"""Work counts from shapes (``work.py``)."""

import pytest

from gpubench import work


def test_invert_flops_is_2n3_times_batch():
    assert work.invert_flops(8192) == 2.0 * 8192 ** 3
    assert work.invert_flops(512, 512) == 512 * 2.0 * 512 ** 3


@pytest.mark.parametrize("n, m, nr", [(8192, 384, 22), (16384, 128, 128),
                                      (6000, 300, 20), (512, 128, 4),
                                      (100, 384, 1)])
def test_num_blocks(n, m, nr):
    assert work.num_blocks(n, m) == nr


def test_probe_terms_divisible_counts_nr_minus_t_blocks():
    terms = list(work.probe_terms(16384, 128, 1, "float32"))
    assert len(terms) == 128
    for t, (flops, nbytes) in enumerate(terms):
        nc = 128 - t
        assert flops == 2.0 * 128 ** 3 * nc
        assert nbytes == 2.0 * nc * 128 * 128 * 4


def test_probe_terms_ragged_last_block_8192_m384():
    terms = list(work.probe_terms(8192, 384, 1, "float64"))
    assert len(terms) == 22
    # 8192 = 21·384 + 128: steps 0..20 probe the 21 − t full blocks, the
    # last step the one 128×128 block.
    for t in range(21):
        assert terms[t][0] == 2.0 * 384 ** 3 * (21 - t)
        assert terms[t][1] == 2.0 * (21 - t) * 384 * 384 * 8
    assert terms[21] == (2.0 * 128 ** 3, 2.0 * 128 * 128 * 8)
    total_blocks = sum(21 - t for t in range(21))
    assert total_blocks == 231


def test_probe_terms_scale_with_batch():
    one = list(work.probe_terms(512, 128, 1, "float64"))
    many = list(work.probe_terms(512, 128, 512, "float64"))
    assert [(f * 512, b * 512) for f, b in one] == many


def test_probe_bound_takes_the_larger_term_each_step():
    # fp64 at m = 128: 16 flops a byte, under the balance of 20 (bytes).
    s, which = work.probe_bound_s(512, 128, 512, "float64", 67e12, 3.35e12)
    blocks = 512 * (4 + 3 + 2 + 1)
    assert which == "bytes"
    assert s == pytest.approx(2.0 * blocks * 128 * 128 * 8 / 3.35e12)
    s, which = work.probe_bound_s(8192, 384, 1, "float64", 67e12, 3.35e12)
    assert which == "flops"
    # The last, 128×128 step is bound by its bytes.
    last = max(2.0 * 128 ** 3 / 67e12, 2.0 * 128 * 128 * 8 / 3.35e12)
    assert last == 2.0 * 128 * 128 * 8 / 3.35e12
    assert s == pytest.approx(231 * 2.0 * 384 ** 3 / 67e12 + last)


def test_gemm_bound():
    s, which = work.gemm_bound_s(16384, 1, "float32", 67e12, 3.35e12)
    assert which == "flops"
    assert s == pytest.approx(2.0 * 16384 ** 3 / 67e12)
    s, which = work.gemm_bound_s(64, 1, "float64", 67e12, 3.35e12)
    assert which == "bytes"
    assert s == pytest.approx(2.0 * 64 ** 2 * 8 / 3.35e12)


def test_peaks_table():
    h100 = work.peaks("NVIDIA H100 80GB HBM3")
    assert h100["flops"] == {"float64": 67e12, "float32": 67e12}
    assert h100["bytes_per_s"] == 3.35e12
    assert work.peaks("cpu") is None
