"""K4's pass 1 over nibble-packed rows (csrc/coarse.cu, coarse_kernel<.., true>):
lanes = queries x pass-1 phases, each of nc windows of C1 channels, against
every row at every visited offset: 2 lanes nc C1 n_off rows int8 operations,
against the int8 dense peak. Bytes: the packed rows as stored (their windows
padded to whole 128-byte rows, then to 256 features, two a byte), the lanes,
and the (lanes, rows) best and first offsets."""

import math

from . import bound_s

PATTERN = r"\bcoarse_kernel<\d+, true>"


def shape(p: dict, n_prints: int, queries: int, rows: int, l_prints: int) -> dict:
    stride, p1 = p["db_downsample"], p["coarse_prefilter_phases"]
    c1 = p["coarse_prefilter_channels"] or p["coarse_channels"]
    nc = (n_prints - (stride - stride // p1)) // stride
    lc = l_prints // stride
    return {"lanes": queries * p1, "nc": nc, "c": c1, "n_off": lc - nc + 1, "lc": lc,
            "rows": -(-rows // 8) * 8}


def ops(s: dict) -> float:
    return 2.0 * s["lanes"] * s["nc"] * s["c"] * s["n_off"] * s["rows"]


def nbytes(s: dict) -> float:
    unit = 128 // math.gcd(s["c"], 128)
    width = -(-s["lc"] // unit) * unit * s["c"]
    row = -(-width // 256) * 256 // 2
    return s["rows"] * row + s["lanes"] * s["nc"] * s["c"] + 8.0 * s["lanes"] * s["rows"]


def bound(s: dict) -> float:
    return bound_s(ops(s), nbytes(s), "int8_ops_per_s")
