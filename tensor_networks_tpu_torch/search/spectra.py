"""Bipartition spectra: the data the program synthesizer reasons over.

For every free-index bipartition of the dense target, the singular-value
tail mass determines which bond ranks are reachable within the error
budget.  :class:`SplitSpectra` computes these spectra — grouped by
matricized shape and batched through one vmapped device SVD per group —
and subsamples the feasible truncation points into bins so the downstream
rank solver sees a handful of candidates per edge instead of hundreds.

Functionally equivalent to the preprocessing in the reference's
``pytens/search/constraint.py`` (abstract/preprocess, Gurobi-era), with
the device batching and the bin walk vectorized our way.

Counterpart of ``tensor_networks_tpu/search/spectra.py``.  The spectra
are grouped by the EXACT oriented shape of their matricizations (m <=
n) and each group is one batched singular-value call on the target's
device (:func:`group_svals`), with one read of the group's spectra.
The JAX package zero-pads every matricization to one pow2 bucket so that
one TPU executable serves all shapes: at d=8, n=6 that bucket is 127 x
2048 x 524288 entries (~545 GB in float32) for ~213 M entries of real
data.  Its host branch for small targets was TPU routing; neither is
carried over.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensor_networks_tpu_torch.kernels import svd_full
from tensor_networks_tpu_torch.search.actions import OSplit
from tensor_networks_tpu_torch.search.batched import _orientation, _stack_group
from tensor_networks_tpu_torch.search.configuration import SearchConfig
from tensor_networks_tpu_torch.search.mdp import SearchState
from tensor_networks_tpu_torch.tensor import Tensor
from tensor_networks_tpu_torch.types import Index


def group_svals(stack: torch.Tensor) -> torch.Tensor:
    """Singular values of a (k, m, n) batch, m <= n, in descending order.

    Below float64 they are the square roots of the eigenvalues of the
    Gram ``A A^T`` formed and factorized in float64: a value's error is
    at most the square root of the Gram's float64 rounding, so even the
    smallest values keep about half of float64's digits, more than
    float32 holds.  A float64 batch goes through ``svdvals``, with
    cuSOLVER's ``gesvd`` on the card.  On an H100 at the d=8, n=6
    target's groups (``tools/search_spectra_probe.py``): the f64 Gram
    took 0.3-14.7 ms a float32 matrix within 1.4e-12 of LAPACK in f64,
    where the default driver (``gesvdj``) took 2-84 ms and was off by up
    to 1.9e-4; in float64 ``gesvd`` took 1.6-98 ms within 1e-14, the
    default up to 140 ms within 4e-13.
    """
    if stack.dtype != torch.float64:
        a = stack.double()
        return torch.linalg.eigvalsh(a @ a.mT).flip(-1).clamp_min(0.0).sqrt()
    return torch.linalg.svdvals(stack, driver="gesvd" if stack.is_cuda else None)


def bin_spectrum(
    spectrum: np.ndarray, delta: float, bin_frac: float
) -> Tuple[List[float], List[int]]:
    """Subsample feasible truncation points of one spectrum.

    Walks the squared tail sums that fit within ``delta**2`` and keeps at
    most one candidate per ``bin_frac * delta**2`` window of error mass
    (the deepest cut inside each window).  The drop-one candidate is
    always offered, even if infeasible — the solver rejects it by budget.

    Returns ``(errors, kept_sizes)`` aligned pairwise.
    """
    budget = delta * delta
    window = bin_frac * budget
    tails = np.cumsum(spectrum[::-1] ** 2)
    feasible = tails[tails <= budget]

    errors: List[float] = [float(spectrum[-1]) ** 2]
    drops: List[int] = [1]
    top = window
    pend_err = 0.0
    pend_n = 0
    for t in feasible[1:]:
        if t >= top:
            top += window
            if pend_n:
                errors.append(pend_err)
                drops.append(pend_n)
            pend_err, pend_n = float(t), 1
        else:
            pend_err, pend_n = float(t), pend_n + 1
    if pend_n:
        errors.append(pend_err)
        drops.append(pend_n)

    kept = len(spectrum) - np.cumsum(drops)
    return errors, [int(k) for k in kept]


def _matricize(target: Tensor, comb: Sequence[Index]) -> torch.Tensor:
    """Permute ``comb`` axes to the front and flatten to a matrix."""
    free = target.indices
    rest = [i for i in free if i not in comb]
    axes = [free.index(i) for i in (*comb, *rest)]
    rows = math.prod(i.size for i in comb)
    return target.value.permute(axes).reshape(rows, -1)


class SplitSpectra:
    """Binned truncation candidates for every candidate OSplit."""

    def __init__(self, config: SearchConfig):
        self.config = config
        self.delta = 0.0
        self.free_indices: List[Index] = []
        self._cands: Dict[OSplit, Tuple[List[float], List[int]]] = {}
        self._spill: Dict[OSplit, str] = {}
        self.temp_files: List[str] = []

    # -- keyed access ---------------------------------------------------------

    def _resolve(self, split: OSplit) -> OSplit:
        """Bipartitions are stored under one of their two halves; the
        complement names the same cut (identical spectrum)."""
        if split in self._cands or split in self._spill:
            return split
        other = OSplit(
            [i for i in self.free_indices if i not in split.indices]
        )
        return other

    def candidates(self, split: OSplit) -> Tuple[List[float], List[int]]:
        """(error sums, kept sizes) for one bipartition."""
        return self._cands[self._resolve(split)]

    def svd_file(self, split: OSplit) -> Optional[str]:
        """Path of the spilled (U, s, V) for one bipartition, if any."""
        return self._spill.get(self._resolve(split))

    # -- construction -----------------------------------------------------------

    def build(
        self,
        target: Tensor,
        combs: Optional[Sequence[Sequence[Index]]] = None,
        spill_uv: bool = False,
    ) -> "SplitSpectra":
        """Compute (or reload) the spectra.

        ``combs`` restricts to the given bipartitions (replay path);
        ``spill_uv`` additionally saves full (U, s, V) factors to npz for
        later data replay, computing them one by one on the host.
        Otherwise singular values are computed in exact-shape batches on
        the target's device.
        """
        self.free_indices = list(target.indices)
        self.delta = self.config.engine.eps * float(
            torch.linalg.vector_norm(target.value)
        )

        if combs is not None:
            for comb in combs:
                self._one_host_svd(target, comb, spill_uv=False)
            return self

        cache_probe = os.path.join(self.config.output.output_dir, "0.npz")
        use_cache = not spill_uv and not (
            self.config.preprocess.force_recompute
            or not os.path.exists(cache_probe)
        )
        if spill_uv or use_cache:
            for comb in SearchState.all_index_combs(target.indices):
                self._one_host_svd(target, comb, spill_uv=spill_uv)
        else:
            self._batched_device_svals(target)
        return self

    def _one_host_svd(
        self, target: Tensor, comb: Sequence[Index], spill_uv: bool
    ) -> None:
        """One bipartition on the target's device, optionally spilling
        factors (as NumPy copies, the JAX package's file format)."""
        split = OSplit(comb)
        out_dir = self.config.output.output_dir
        path = os.path.join(out_dir, f"{len(self._spill)}.npz")

        if spill_uv:
            u, s, vt = (
                m.cpu().numpy() for m in svd_full(_matricize(target, comb))
            )
            os.makedirs(out_dir, exist_ok=True)
            np.savez(path, u=u, s=s, v=vt)
            self._spill[split] = path
            self.temp_files.append(path)
            return

        if not self.config.preprocess.force_recompute and os.path.exists(
            path
        ):
            s = np.load(path)["s"]
            self._spill[split] = path
        else:
            mat = _matricize(target, comb)
            if mat.shape[0] > mat.shape[1]:
                mat = mat.T
            s = group_svals(mat[None])[0].cpu().numpy()
        self._cands[split] = bin_spectrum(
            s, self.delta, self.config.synthesizer.bin_size
        )

    def _batched_device_svals(self, target: Tensor) -> None:
        """All bipartition spectra, one batched call per exact oriented
        shape; each group's spectra are read to the host once.

        Singular values are transpose-invariant, so every matricization
        is oriented short-side-first; at uniform mode sizes the k-way and
        (d-k)-way bipartitions then share a group.
        """
        val = target.value
        groups: Dict[Tuple[int, int], List] = {}
        for comb in SearchState.all_index_combs(target.indices):
            axes = tuple(target.indices.index(i) for i in comb)
            perm, _, mn = _orientation(val.shape, axes)
            groups.setdefault(mn, []).append((comb, perm))
        for mn, members in groups.items():
            svals = group_svals(_stack_group(val, [p for _, p in members], mn))
            for (comb, _), s in zip(members, svals.cpu().numpy()):
                self._cands[OSplit(comb)] = bin_spectrum(
                    s, self.delta, self.config.synthesizer.bin_size
                )
