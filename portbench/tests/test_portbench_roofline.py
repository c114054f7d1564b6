"""Each kernel's operation and byte counts against hand-computed shapes."""

import pytest

from portbench.roofline import PEAKS, bound_s, k1_cqt, k2_hashprint, k4_pass1
from portbench.harness import load_json

P = load_json("configs", "ingest240.json")["hpfw"]
C = load_json("configs", "catalog100k.json")["hpfw"]
S240 = 240 * 22050


def test_k1_at_240_s():
    f = 1 + (S240 - 8192) // 512
    assert f == 10320
    assert k1_cqt.ops(P, S240) == 2 * 10320 * 8192 * 242
    assert k1_cqt.nbytes(P, S240) == 4 * (S240 + 8192 * 242 + 10320 * 121)
    # 40.9 GFLOP over 989 TFLOP/s: the operations bound it.
    assert k1_cqt.bound(P, S240) == pytest.approx(2 * 10320 * 8192 * 242 / 989e12)
    assert k1_cqt.bound(P, S240) * 1e3 == pytest.approx(0.0414, abs=1e-4)


def test_k2_at_240_s():
    assert k2_hashprint.ops(P, S240) == 2 * (10320 - 19) * 2420 * 64
    assert k2_hashprint.nbytes(P, S240) == 4 * (10320 * 121 + 2420 * 64 + 2 * 10285)
    assert k2_hashprint.bound(P, S240) == pytest.approx(2 * 10301 * 2420 * 64 / 989e12)


def test_k4_pass1_at_batch16():
    s = k4_pass1.shape(C, 430, 16, 100_000, 2583)
    # lanes 16 x 2 phases; (430 - 8) // 16 = 26 windows; 32 channels;
    # 161 - 26 + 1 = 136 offsets.
    assert s == {"lanes": 32, "nc": 26, "c": 32, "n_off": 136, "lc": 161, "rows": 100_000}
    assert k4_pass1.ops(s) == 2 * 32 * 26 * 32 * 136 * 100_000
    # 161 windows pad to 164 (x 32 = 5248 bytes), then 5376 features, 2688 bytes a row.
    assert k4_pass1.nbytes(s) == 100_000 * 2688 + 32 * 26 * 32 + 8 * 32 * 100_000
    assert k4_pass1.bound(s) == pytest.approx(k4_pass1.ops(s) / 1979e12)
    assert k4_pass1.bound(s) * 1e3 == pytest.approx(0.366, abs=0.001)


def test_k4_rows_pad_to_whole_tiles():
    assert k4_pass1.shape(C, 430, 1, 13, 2583)["rows"] == 16


def test_bound_takes_the_larger():
    assert bound_s(0, 3.35e12, "int8_ops_per_s") == pytest.approx(1.0)
    assert bound_s(1979e12, 0, "int8_ops_per_s") == pytest.approx(1.0)
    assert PEAKS["bf16_flops_per_s"] == 989e12
