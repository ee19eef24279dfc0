"""The host's time a request, from the call of the forward to the return of
``torch.autograd.grad``, before the synchronise (the benchmark's own span):
the median over the traced requests, in ms."""

import statistics


def read(run):
    spans = run.facts.get("enqueue_s")
    if not spans:
        return None
    return 1e3 * statistics.median(spans)
