"""The share of the traced window's pass-1 launches (K4 over the nibble-packed
catalog, coarse_kernel<.., true>) that ran the short packed body,
coarse_kernel<8, true>: 64 lanes a block, for queries of up to 16 coarse
windows such as the pool's 128-print rings. None without a pass-1 launch."""

from portbench.roofline import k4_pass1

SHORT = r"\bcoarse_kernel<8, true>"


def read(run):
    t = run.trace
    if t is None:
        return None
    launches = len(t.kernels_named(k4_pass1.PATTERN))
    return len(t.kernels_named(SHORT)) / launches if launches else None
