"""Model step: the program's ``decode_attention`` device spans of the
window (one a layer a decode step: the cache write, its fp32 upcast, both
products, the softmax and the layer's projections), summed, over the
window's ``decode_step`` device spans: a decode step's attention time on
the device's clock."""

from perfbench.harness.stats import spans


def read(run):
    steps, found = spans(run, "decode_step"), spans(run, "decode_attention")
    if not steps or not found:
        return None
    return sum(s[2] - s[1] for s in found) * 1e3 / len(steps)
