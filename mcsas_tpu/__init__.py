# -*- coding: utf-8 -*-
"""mcsas_tpu — Monte Carlo size-distribution retrieval for small-angle
scattering on a GPU: a ground-up JAX/XLA rebuild of the capabilities of
BAMresearch/McSAS (form-free particle size distributions via accept/reject
MC over analytical form-factor models).

Quick start::

    import mcsas_tpu as mt
    result = mt.fit("mydata.csv", model="Sphere")
    mt.OutputFiles(result).write_all(plot=True)
"""

__version__ = "0.1.0"


def _setup():
    """x64 is enabled package-wide: host-side analysis runs float64 like
    the reference, while the device hot loop requests float32
    explicitly.  Compiled programs persist across processes in JAX's
    compilation cache: where ``JAX_COMPILATION_CACHE_DIR`` is set JAX
    uses it as is, otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache``."""
    import os
    import jax
    jax.config.update("jax_enable_x64", True)
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", default_cache_dir())


def default_cache_dir() -> str:
    """The compile cache's path when ``JAX_COMPILATION_CACHE_DIR`` is
    unset: ``.jax_cache`` beside the package directory."""
    import os
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")


_setup()

from .config import McSASConfig                      # noqa: E402
from .data import (DataConfig, GaussianSmearing, SASData,  # noqa: E402
                   TrapezoidSmearing, from_raw, load)
from .models import (REGISTRY, get_model,  # noqa: E402
                     load_model_dir, load_model_file)
from .post.histogram import HistogramSpec            # noqa: E402
from .api import (McSASResult, OutputFiles, fit,     # noqa: E402
                  run_files)

__all__ = [
    "__version__", "McSASConfig", "DataConfig", "SASData",
    "TrapezoidSmearing", "GaussianSmearing", "from_raw", "load",
    "REGISTRY", "get_model", "load_model_file", "load_model_dir",
    "HistogramSpec",
    "McSASResult", "OutputFiles", "fit", "run_files",
]
