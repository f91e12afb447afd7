"""The card's time a step inside the expert layers (ms): from the step
trace's marks of each expert layer (``models.deepseek``: ``moe_fwd_start``
and ``moe_fwd_end`` around its forward, ``moe_bwd_start`` and
``moe_bwd_end`` around its backward, the layer's index as the leaf), the
card's clock between each pair, summed over the layers and both passes;
the mean over the step trace's steps (``steps.recorded``). What the card
spends between a pair's marks, waiting for the host included, counts.
None where the program's step trace has no such marks."""

import statistics

from portbench.steps import recorded

PAIRS = (("moe_fwd_start", "moe_fwd_end"), ("moe_bwd_start", "moe_bwd_end"))


def step_ms(record):
    """The record's card ms inside the expert layers; None unless every
    layer that marked has all four marks once."""
    at = {}
    for m in record["marks"]:
        if m.name.startswith("moe_"):
            if (m.name, m.leaf) in at:
                return None
            at[(m.name, m.leaf)] = m.card_ms
    layers = {leaf for _, leaf in at}
    if not layers or len(at) != 4 * len(layers):
        return None
    return sum(at[(b, leaf)] - at[(a, leaf)]
               for leaf in layers for a, b in PAIRS)


def read(rec):
    out = recorded(rec)
    got = [v for v in map(step_ms, out["records"] if out else ())
           if v is not None]
    return statistics.fmean(got) if got else None
