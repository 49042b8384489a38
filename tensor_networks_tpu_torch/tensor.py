"""The local tensor: a ``torch.Tensor`` plus an ordered list of named
indices.

Counterpart of ``tensor_networks_tpu/tensor.py``.  Per-node operations
(contract, SVD/QR splits, Hadamard products, block-diagonal embeddings)
run where the value lives; operations are keyed by index *identity*,
never by position conventions shared between networks.

Parity reference: ``pytens/algs.py:46-344`` (Tensor and its methods).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensor_networks_tpu_torch.kernels import delta_svd, qr_reduced
from tensor_networks_tpu_torch.planner import contract_values
from tensor_networks_tpu_torch.types import Index, IntOrStr, resolve_device


@dataclass
class Tensor:
    """An n-dimensional array with one named :class:`Index` per axis."""

    value: torch.Tensor
    indices: List[Index]

    def __deepcopy__(self, memo) -> "Tensor":
        """Deep copies share the value buffer.

        Every operation in the package rebinds ``value`` rather than
        writing into it, so structural copies never copy array data.
        """
        return Tensor(self.value, list(self.indices))

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        """Plain-dict form; the value is materialized as a NumPy array."""
        return {
            "value": np.ascontiguousarray(self.value.detach().cpu().numpy()),
            "indices": [index.to_dict() for index in self.indices],
        }

    @classmethod
    def from_dict(
        cls, data_dict: dict, device=None, dtype=None
    ) -> "Tensor":
        """Rebuild from :meth:`to_dict` output, placing the value on
        ``device`` (default: the card) as ``dtype``."""
        indices = [Index.from_dict(d) for d in data_dict["indices"]]
        # a copy: the network must not alias the caller's (possibly
        # read-only) array
        value = torch.tensor(
            np.asarray(data_dict["value"]),
            device=resolve_device(device),
            dtype=dtype,
        )
        return cls(value=value, indices=indices)

    # -- metadata updates ----------------------------------------------------

    def update_val_size(self, value) -> "Tensor":
        """Replace the value in place; index sizes follow the new shape.

        A non-tensor value is converted onto the current value's device.
        """
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(value, device=self.value.device)
        if value.ndim != len(self.indices):
            raise ValueError(f"{tuple(value.shape)}, {self.indices}")
        self.value = value
        for ii, index in enumerate(self.indices):
            self.indices[ii] = index.with_new_size(value.shape[ii])
        return self

    def rename_indices(self, rename_map: Dict[IntOrStr, IntOrStr]) -> "Tensor":
        """Rename indices in place by name."""
        for ii, index in enumerate(self.indices):
            if index.name in rename_map:
                self.indices[ii] = index.with_new_name(rename_map[index.name])
        return self

    def permute(self, target_order: Optional[Sequence[int]]) -> "Tensor":
        """A new tensor with axes permuted by position."""
        if not target_order:
            return self
        value = self.value.permute(tuple(target_order))
        indices = [self.indices[i] for i in target_order]
        return Tensor(value, indices)

    # -- pairwise algebra ------------------------------------------------------

    def contract(self, other: "Tensor") -> "Tensor":
        """Contract over all indices shared (by identity) with ``other``.

        Output indices: self-only indices (in self order) followed by
        other-only indices (in other order).
        """
        out_indices = [i for i in self.indices if i not in other.indices]
        out_indices += [i for i in other.indices if i not in self.indices]
        out = contract_values(
            [self.indices, other.indices],
            [self.value, other.value],
            out_indices,
        )
        return Tensor(out, out_indices)

    def mult(self, other: "Tensor", indices_common: Sequence[Index]) -> "Tensor":
        """Hadamard on common indices, tensor (Kronecker) product on the
        rest; positionally-aligned axes are merged pairwise.

        Used by tree-aligned elementwise multiplication: result rank on a
        merged axis is the product of the two input sizes.
        """
        assert len(self.indices) == len(other.indices)
        lhs_ids: List[int] = []
        rhs_ids: List[int] = []
        out_ids: List[int] = []
        new_indices: List[Index] = []
        new_shape: List[int] = []
        counter = 0
        for ind_a, ind_b in zip(self.indices, other.indices):
            if ind_a in indices_common:
                assert ind_a.size == ind_b.size
                lhs_ids.append(counter)
                rhs_ids.append(counter)
                out_ids.append(counter)
                counter += 1
                new_indices.append(ind_a)
                new_shape.append(ind_a.size)
            else:
                lhs_ids.append(counter)
                out_ids.append(counter)
                counter += 1
                rhs_ids.append(counter)
                out_ids.append(counter)
                counter += 1
                merged = ind_a.size * ind_b.size
                new_indices.append(Index(f"{ind_a.name}", merged))
                new_shape.append(merged)

        dtype = torch.promote_types(self.value.dtype, other.value.dtype)
        out = torch.einsum(
            self.value.to(dtype), lhs_ids, other.value.to(dtype), rhs_ids,
            out_ids,
        ).reshape(new_shape)
        return Tensor(out, new_indices)

    def block_diagonal(
        self, other: "Tensor", free_inds: Sequence[Index]
    ) -> "Tensor":
        """Embed the two tensors block-diagonally along all non-free axes.

        The TT/tree addition kernel: free axes stay shared, every bond axis
        becomes the direct sum of the two inputs' bonds.
        """
        shape: List[int] = []
        offsets: List[int] = []  # start of other's block per axis
        for i, ind in enumerate(self.indices):
            if ind in free_inds:
                assert ind.size == other.indices[i].size
                shape.append(ind.size)
                offsets.append(0)
            else:
                shape.append(ind.size + other.indices[i].size)
                offsets.append(ind.size)

        big = torch.zeros(
            shape,
            dtype=torch.promote_types(self.value.dtype, other.value.dtype),
            device=self.value.device,
        )
        slc_self = tuple(
            slice(None) if ind in free_inds else slice(0, ind.size)
            for ind in self.indices
        )
        slc_other = tuple(
            slice(None)
            if ind in free_inds
            else slice(off, off + oth.size)
            for ind, off, oth in zip(self.indices, offsets, other.indices)
        )
        big[slc_self] = self.value
        big[slc_other] = other.value
        new_indices = [
            Index(ind.name, big.shape[i]) for i, ind in enumerate(self.indices)
        ]
        return Tensor(big, new_indices)

    # -- factorizations ---------------------------------------------------------

    def _split_permute(
        self, lefts: Sequence[int]
    ) -> Tuple[torch.Tensor, List[int], List[int], int, int]:
        rights = [i for i in range(len(self.indices)) if i not in lefts]
        value = self.value.permute(tuple(list(lefts) + rights))
        left_sz = int(np.prod([self.indices[i].size for i in lefts]))
        right_sz = int(np.prod([self.indices[j].size for j in rights]))
        return value.reshape(left_sz, right_sz), list(lefts), rights, left_sz, right_sz

    def svd(
        self, lefts: Sequence[int], delta: float = 1e-5
    ) -> Tuple[List["Tensor"], float]:
        """Delta-truncated SVD split by axis positions.

        Returns ``[U, S, V]`` tensors joined by fresh ``r_split_l`` /
        ``r_split_r`` bond indices, plus the unused error budget.
        """
        mat, lefts, rights, _, _ = self._split_permute(lefts)
        result = delta_svd(mat, delta)
        rank = result.u.shape[1]

        u_val = result.u.reshape(
            [self.indices[i].size for i in lefts] + [rank]
        )
        u_indices = [self.indices[i] for i in lefts]
        u_indices.append(Index("r_split_l", rank))

        s_indices = [Index("r_split_l", rank), Index("r_split_r", rank)]
        s_tensor = Tensor(torch.diag(result.s), s_indices)

        v_val = result.v.reshape(
            [rank] + [self.indices[j].size for j in rights]
        )
        v_indices = [Index("r_split_r", rank)] + [
            self.indices[j] for j in rights
        ]
        return (
            [Tensor(u_val, u_indices), s_tensor, Tensor(v_val, v_indices)],
            result.remaining_delta,
        )

    def qr(self, lefts: Sequence[int]) -> Tuple["Tensor", "Tensor"]:
        """QR split by axis positions, joined by a fresh ``r_split`` bond."""
        mat, lefts, rights, _, _ = self._split_permute(lefts)
        q, r = qr_reduced(mat)
        rank = q.shape[1]

        q_val = q.reshape([self.indices[i].size for i in lefts] + [rank])
        q_indices = [self.indices[i] for i in lefts]
        q_indices.append(Index("r_split", rank))

        r_val = r.reshape([rank] + [self.indices[j].size for j in rights])
        r_indices = [Index("r_split", rank)] + [
            self.indices[j] for j in rights
        ]
        return Tensor(q_val, q_indices), Tensor(r_val, r_indices)
