"""gmix_tpu: a context-mixing lossless codec in JAX.

Brand-new implementation of the byronknoll/gmix architecture - a ~120-model
context-mixing ensemble fused by a 3-layer gated linear network driving a
binary arithmetic coder, learning online during compression - restructured
for an accelerator: batched independent streams, byte-level scans over a
shared bit sub-step body, gathered/scattered arena rows, and data-parallel
stream sharding across device meshes.

See SURVEY.md for the reference structural analysis this is built against.
"""
import os as _os

import jax as _jax

# Persistent XLA compilation cache. Where JAX_COMPILATION_CACHE_DIR is set,
# JAX reads it itself and nothing is set here; otherwise the cache lives at a
# fixed path inside the checkout (the path is part of the cache key, so it
# must not move between runs). Importing the package opens no device.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

from .config import (  # noqa: F401
    EnsembleSpec,
    LstmSpec,
    best_spec,
    reference_spec,
    scale_tables,
    tiny_spec,
)
from .core.codec import (  # noqa: F401
    Predictor,
    compress_bytes,
    decompress_bytes,
    entropy_bits,
    generate_bytes,
)

__version__ = "0.1.0"
