"""The inputs are a function of the seed: the same seed gives the same
inputs, another seed others."""

import numpy as np
import torch

from portbench import catalog, synth
from portbench.traffic import batch, stream
from portbench_tiny import tiny_run


def test_generators_deterministic():
    def draw(seed):
        g = synth.generator(seed, 1, "cpu")
        p = synth.score_params(g, 3, "cpu")
        x = synth.render(p, torch.tensor([0.0, 1.0, 2.5]), 4000, sr=22050, duration_s=12.0,
                         fmin=130.8)
        return (p, x, synth.random_prints(g, (2, 5, 2), "cpu"),
                synth.flip_masks(g, 2, 5, 0.15, "cpu"), synth.filters(g, 40, 8, "cpu"))
    a, b, c = draw(2 ** 31 + 5), draw(2 ** 31 + 5), draw(7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_excerpt_is_the_track():
    g = synth.generator(3, 1, "cpu")
    p = synth.score_params(g, 2, "cpu")
    whole = synth.render(p, torch.zeros(2), 22050 * 3, sr=22050, duration_s=12.0, fmin=130.8)
    part = synth.render(p, torch.full((2,), 1.5), 22050, sr=22050, duration_s=12.0, fmin=130.8)
    assert torch.allclose(whole[:, int(1.5 * 22050):int(2.5 * 22050)], part, atol=1e-5)


def test_filters_signs_fixed():
    f = synth.filters(synth.generator(1, 1, "cpu"), 50, 8, "cpu")
    assert (f[f.abs().argmax(dim=0), torch.arange(8)] > 0).all()


def test_flip_rate():
    m = synth.flip_masks(synth.generator(1, 1, "cpu"), 4, 200, 0.15, "cpu")
    bits = np.unpackbits(m.numpy().view(np.uint8)).mean()
    assert abs(bits - 0.15) < 0.02


def test_cell_inputs_deterministic_by_seed():
    r1, r2, r3 = (tiny_run("catalog100k.batch16", seed=s) for s in (11, 11, 12))
    c1, c2, c3 = (catalog.build(r) for r in (r1, r2, r3))
    assert np.array_equal(c1["prints"], c2["prints"]) and np.array_equal(c1["rows"], c2["rows"])
    assert not np.array_equal(c1["prints"], c3["prints"])
    assert np.array_equal(batch.queries(r1, c1), batch.queries(r2, c2))
    planted = c1["rows"]
    assert (c1["lengths"][planted] < 516).all() and (np.delete(c1["lengths"], planted) == 516).all()
    l1 = tiny_run("catalog100k.live_renditions", seed=11)
    l2 = tiny_run("catalog100k.live_renditions", seed=11)
    q1, q2 = catalog.live_queries(l1, c1), catalog.live_queries(l2, c2)
    assert all(np.array_equal(a, b) for a, b in zip(q1, q2))
    assert q1[2].sum() == 2                      # a quarter of the pool of 8
    s1, s2 = (stream.inputs(tiny_run("ingest240.stream", seed=11)) for _ in range(2))
    assert all(np.array_equal(a, b) for a, b in zip(s1[1], s2[1]))
