"""Device code: ``torch.linalg`` factorizations with host rank rules, and
the hand-written CUDA kernels (:mod:`.zipper`, :mod:`.evaluate`) with
their plain PyTorch versions.

Importing this package builds nothing: the CUDA library is compiled on
the first launch (:mod:`._build`).
"""

from tensor_networks_tpu_torch.kernels.linalg import (
    TruncSVD,
    delta_svd,
    eps_to_rank,
    gram_eig_and_svd,
    svd_full,
    qr_reduced,
    qr_reduced_padded,
)

__all__ = [
    "TruncSVD",
    "delta_svd",
    "eps_to_rank",
    "gram_eig_and_svd",
    "svd_full",
    "qr_reduced",
    "qr_reduced_padded",
]
