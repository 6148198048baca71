"""The share of the test runner's host work that the card spent busy, in
percent: the time in the program's ``subgc.test.stack`` and
``subgc.test.captions`` spans (stacking a dispatch's inputs, writing its
captions) that overlaps the device's operations (``Trace.merged``), over
the time in those spans.  Serial dispatches leave the card idle through
both; a pipelined runner does them while the card decodes.  None where the
traced window holds neither span."""
from portbench.metrics import program

HOST = ("subgc.test.stack", "subgc.test.captions")


def read(layers):
    sp = program.spans(layers)
    if not sp:
        return None
    host = program.union([(s, e) for name, s, e in sp if name in HOST])
    total = sum(e - s for s, e in host)
    if total <= 0:
        return None
    return 100.0 * program.overlap(host, layers["trace"].merged) / total
