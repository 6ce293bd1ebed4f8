"""GF(2) LDPC encoding: host factorization + batched native/device encode."""

from .gf2 import gf2_factorize_packed, is_full_diag_triangular
from .encoder import LDPCEncoder

__all__ = ["gf2_factorize_packed", "is_full_diag_triangular", "LDPCEncoder"]
