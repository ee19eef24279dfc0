"""Device seconds a step in the fused Gram VJPs (``ops/fused_gram.py``
``_FusedGram.backward``: K2, and K1 where the vector's cotangent is
needed): the ``gram.vjp`` spans, over the traced steps."""

from portbench import spans


def read(run):
    return spans.per_step(run, ("gram.vjp",), "device_s")
