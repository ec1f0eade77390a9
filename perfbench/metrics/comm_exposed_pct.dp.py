"""``comm_exposed_pct.dp`` (%): the share of rank 0's traced span in which
an NCCL kernel runs on its card and no other operation does: the
collectives (the gradient all-reduce, VTC's and VTM's gathers) that nothing
hides. None where the trace holds no NCCL kernel. Layer: collectives
(``parallel/collectives.py``, ``train/step.py``'s reduce)."""

from perfbench.lib.trace import _union


def _is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def _minus(a, b):
    """The measure of the union ``a`` less the union ``b`` (both sorted,
    disjoint intervals)."""
    total, j = 0.0, 0
    for lo, hi in a:
        cur = lo
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > cur:
                total += b[k][0] - cur
            cur = max(cur, b[k][1])
            k += 1
        total += max(0.0, hi - cur)
    return total


def read(run, info):
    if run is None or run.window_s <= 0.0:
        return None
    nccl = _union([(a, b) for n, a, b in run.kernels if _is_nccl(n)])
    if not nccl:
        return None
    other = _union([(a, b) for n, a, b in run.kernels if not _is_nccl(n)])
    return 100.0 * _minus(nccl, other) * 1e-6 / run.window_s
