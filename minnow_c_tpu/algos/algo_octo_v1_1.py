"""Octo v1.1 -- Morton hierarchical codec on the v1.1 chunked layout,
frozen.

Wire evolution over Octo v1.0 (minor bump, header_format.tex:266-276):
the Morton cell stream -- the codec's dominant plane -- switches from
the Coil v1.0 chunk layout to the Coil v1.1 one (parametric chunk size
+ column-major chunk bodies, ``algos/algo_coil_v1_1.py``).  The
within-cell offset planes (packed raw per dim) are unchanged.

Block layout and metadata are identical to v1.0 (``meta | morton |
loX | loY | loZ``); only the morton plane's payload follows the v1.1
chunked format.  Streams stamped 1.0.x keep decoding through the
frozen algo_octo_v1_0 module.

This module is FROZEN at v1.1.
"""

from __future__ import annotations

from .. import semver
from ..types import AlgoCode
from . import registry
from .algo_coil_v1_1 import CoilV1_1
from .algo_octo_v1_0 import OctoV1_0

VERSION = semver.pack(1, 1, 0)


class OctoV1_1(OctoV1_0):
    algo_code = int(AlgoCode.OCTO)
    version = VERSION

    # OctoV1_0 pins its Morton plane to CoilV1_0's chunk layout by
    # calling CoilV1_0._encode_plane explicitly; route through the
    # v1.1 plane codec instead.  MRO gives OctoV1_1 -> OctoV1_0 ->
    # CoilV1_0 -> TrimV1_0; the v1.1 plane methods are standalone
    # (CoilV1_1 derives from TrimV1_0 directly), so delegate by
    # explicit unbound calls exactly as v1.0 did.

    def _encode_plane(self, bins, depth: int):
        return CoilV1_1._encode_plane(self, bins, depth)

    def _decode_plane(self, words, width: int, n: int):
        return CoilV1_1._decode_plane(self, words, width, n)


registry.register(OctoV1_1())
