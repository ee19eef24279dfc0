"""What may not be loaded in a benchmark process: JAX and the JAX package.

Module names are compared by their top-level name (the part before the first
dot), whole: ``lanczos_adjoints_tpu_torch`` is not ``lanczos_adjoints_tpu``.
"""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "lanczos_adjoints_tpu")


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))
