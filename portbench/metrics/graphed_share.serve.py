"""The share of the two-stage dispatches that replayed a CUDA graph: the
match.dispatch spans (TwoStageDB.dispatch_batch) whose graphed is true, over
those inside the serve.dispatch spans, on the same thread, of the batches
that hold the window's requests."""

from collections import defaultdict

from portbench.metrics import _spans


def read(run):
    w = _spans.live(run)
    if w is None:
        return None
    batches = defaultdict(list)
    for b in w.batch_spans("serve.dispatch"):
        batches[b.thread].append((b.t0, b.t1))
    mine = [s for s in w.by["match.dispatch"]
            if any(t0 <= s.t0 and s.t1 <= t1 for t0, t1 in batches[s.thread])]
    return sum(bool(s.attrs.get("graphed")) for s in mine) / len(mine) if mine else None
