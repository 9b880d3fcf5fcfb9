"""minnow_c_tpu: an accelerator framework for error-bounded lossy
compression of cosmological N-body particle snapshots.

A from-scratch JAX/XLA re-design with the capabilities of the
reference C library (phil-mansfield/minnow_c): error-bounded quantization of
float32/uint64 particle fields to integer bin indices, reversible transforms
(delta coding, byte transpose, variable-width bitpacking), an LZ4
block-format entropy backend, and a checksummed, versioned, little-endian
segment format -- with data-parallel scale-out over device meshes.

Layer map (mirrors SURVEY.md section 1):
  L1  ops/        -- jittable kernels (minmax, periodic, bin index, bitpack,
                     transpose, delta), native entropy/checksum, RNG
  L2  quant/      -- per-field-type quantization engine (the lossy stage)
  L3  algos/      -- versioned algorithm registry + frozen codec modules
  L4  segment/    -- segment API, wire format, stream reader/writer
  L5  parallel/   -- client-scale helpers: sharded multi-block compression
"""

import jax as _jax

# The codec manipulates 64-bit particle IDs and bit-exact integers; 64-bit
# types must be real (not silently truncated to 32).
_jax.config.update("jax_enable_x64", True)

from . import semver, types  # noqa: E402
from . import algos, quant, segment  # noqa: E402
from .segment.api import (  # noqa: E402
    compress_segment,
    decompress_segment,
    transcode_segment,
)
from .types import (  # noqa: E402
    AlgoCode,
    CField,
    CSeg,
    Field,
    FieldCode,
    FieldHeader,
    FloatAccuracy,
    IDAccuracy,
    IntAccuracy,
    PositionAccuracy,
    QField,
    QSeg,
    Seg,
    VelocityAccuracy,
)

__version__ = "0.1.0"
