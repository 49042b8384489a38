"""Ahead-of-time export of a network's point evaluator as a serving artifact.

Counterpart of ``tensor_networks_tpu/export.py``, with ``torch.export``
in place of ``jax.export``: the batched point evaluator of a network
(:meth:`TensorNetwork.evaluator`) is traced once into an
``ExportedProgram`` that any process with ``torch`` can load and run, at
any batch size, without the library.

* **One artifact for every batch size.**  The batch is
  ``torch.export.Dim("b", min=1)``.  The evaluator builds its contraction
  plan when it is made, from a placeholder batch of 2, and the traced
  function runs only the plan's steps, which read no shape: the
  planner's cache key, which turns every shape into a Python ``int``,
  is never reached while tracing, so nothing fixes the batch to the
  example's size.  Requests are still padded to powers of two
  (``bucket_batches``, persisted) as in the JAX package.
* **Weights are inputs.**  The node values are arguments of the
  program, not constants in it, so :meth:`ExportedEvaluator.update_values`
  swaps in refreshed values of the same structure.
* **No device in the program.**  The graph holds aten ops only and no
  tensor constants, so it runs wherever its values and points live: on
  each device type of ``platforms``.
* Out-of-range multi-indices clamp to each index's range, as on every
  evaluation route of the port.

``save`` writes one ``.npz``: the ``torch.export.save`` bytes, the node
values and a JSON manifest; :func:`load` restores an evaluator from it.
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from tensor_networks_tpu_torch.network import TensorNetwork
from tensor_networks_tpu_torch.types import Index, resolve_device

__all__ = ["ExportedEvaluator", "export_evaluator", "load"]

_FORMAT = "tnt-torch-exported-evaluator-v1"
_PLAN_BATCH = 2  # the placeholder batch of the plan and of the trace


class _Evaluate(torch.nn.Module):
    """The traced function: ``(cols (B, k), values) -> (B,)``."""

    def __init__(self, run):
        super().__init__()
        self._run = run

    def forward(self, cols, values):
        return self._run(values, cols)


class ExportedEvaluator:
    """A traced, batch-polymorphic point evaluator of one topology.

    ``ev(points)`` evaluates the network at an ``(N, k)`` integer
    multi-index array (columns ordered like the exported indices) and
    returns an ``(N,)`` NumPy array, for any ``N``, without tracing
    again.  ``bucket_batches`` (default True) pads each request to the
    next power of two.  Construct via :func:`export_evaluator` or
    :func:`load`.
    """

    def __init__(
        self,
        program: torch.export.ExportedProgram,
        values: Sequence[torch.Tensor],
        index_names: Sequence[str],
        index_sizes: Sequence[int],
        bucket_batches: bool = True,
        platforms: Sequence[str] = ("cpu", "cuda"),
    ):
        self._program = program
        self._module = program.module()
        self._values = [v.detach() for v in values]
        self.index_names = list(index_names)
        self.index_sizes = [int(s) for s in index_sizes]
        self.bucket_batches = bucket_batches
        self._platforms = list(platforms)

    # -- serving ------------------------------------------------------------------------------

    def __call__(self, points: np.ndarray) -> np.ndarray:
        pts = np.asarray(points)
        if pts.ndim != 2 or pts.shape[1] != len(self.index_names):
            raise ValueError(
                f"points must be (N, {len(self.index_names)}) for indices "
                f"{self.index_names}, got {pts.shape}"
            )
        device = self._values[0].device
        if device.type not in self._platforms:
            raise ValueError(
                f"values live on {device.type}, not one of the exported "
                f"platforms {self._platforms}"
            )
        npts = pts.shape[0]
        if npts == 0:
            return torch.empty((0,), dtype=self._values[0].dtype).numpy()
        if self.bucket_batches:
            m = 1 << (npts - 1).bit_length()
            if m > npts:
                pts = np.concatenate([pts, np.repeat(pts[-1:], m - npts, axis=0)])
        cols = torch.as_tensor(pts.astype(np.int64), device=device)
        return self._module(cols, self._values).cpu().numpy()[:npts]

    @property
    def platforms(self) -> List[str]:
        return list(self._platforms)

    def update_values(
        self, source: Union[TensorNetwork, Sequence[np.ndarray]]
    ) -> None:
        """Swap in refreshed node values of the SAME structure: a network
        of identical topology (node order and shapes) or a value list.
        The program is untouched (the serving-side weight refresh)."""
        if isinstance(source, TensorNetwork):
            vals = [source.node_tensor(n).value for n in source.network.nodes]
        else:
            vals = list(source)
        if len(vals) != len(self._values):
            raise ValueError(
                f"expected {len(self._values)} node values, got {len(vals)}"
            )
        new = []
        for old, v in zip(self._values, vals):
            t = torch.as_tensor(v, dtype=old.dtype, device=old.device).detach()
            if t.shape != old.shape:
                raise ValueError(
                    f"node value shape {tuple(t.shape)} != exported {tuple(old.shape)}"
                )
            new.append(t)
        self._values = new

    # -- persistence --------------------------------------------------------------------------

    def save(self, path: str) -> str:
        """Write the artifact (program + values + manifest) as one .npz.

        Returns the path written: ``np.savez`` appends ``.npz`` to a path
        without it, so ``save`` and ``load`` both normalize to that name.
        """
        if not path.endswith(".npz"):
            path = path + ".npz"
        blob = io.BytesIO()
        torch.export.save(self._program, blob)
        meta = {
            "format": _FORMAT,
            "index_names": self.index_names,
            "index_sizes": self.index_sizes,
            "platforms": self.platforms,
            "n_values": len(self._values),
            "bucket_batches": bool(self.bucket_batches),
        }
        arrays = {
            f"value_{i}": v.cpu().numpy() for i, v in enumerate(self._values)
        }
        np.savez(
            path,
            artifact=np.frombuffer(blob.getvalue(), dtype=np.uint8),
            manifest=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
            **arrays,
        )
        return path


def load(path: str, device=None) -> ExportedEvaluator:
    """Restore an :class:`ExportedEvaluator` written by ``save``, its
    values on ``device`` (default: the card).  Any other file, a JAX
    package artifact included, raises ``ValueError``."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"  # as save's extension normalization
    device = resolve_device(device)
    with np.load(path) as data:
        meta = json.loads(bytes(data["manifest"].tobytes()).decode("utf-8"))
        if meta.get("format") != _FORMAT:
            raise ValueError(f"not a tnt torch exported evaluator: {path}")
        program = torch.export.load(io.BytesIO(data["artifact"].tobytes()))
        values = [
            torch.as_tensor(data[f"value_{i}"], device=device)
            for i in range(meta["n_values"])
        ]
    return ExportedEvaluator(
        program,
        values,
        meta["index_names"],
        meta["index_sizes"],
        bucket_batches=bool(meta.get("bucket_batches", True)),
        platforms=meta["platforms"],
    )


def export_evaluator(
    net: TensorNetwork,
    indices: Optional[Sequence[Index]] = None,
    dtype=None,
    platforms: Sequence[str] = ("cpu", "cuda"),
) -> ExportedEvaluator:
    """Trace ``net``'s batched evaluator into a portable artifact.

    ``indices`` fixes the column order of the query array (default: the
    network's free indices).  ``dtype`` casts the node values at export
    time.  The values stay where the network's live.  The evaluator's
    ``export_seconds`` holds the time of the plan and of the trace.
    """
    if indices is None:
        indices = net.free_indices()
    indices = list(indices)
    free = set(net.free_indices())
    missing = [i for i in indices if i not in free]
    if missing or len(set(indices)) != len(indices) or len(indices) != len(free):
        raise ValueError(
            f"indices must be exactly the free indices of the network; "
            f"got {[i.name for i in indices]} vs "
            f"{sorted(i.name for i in free)}"
        )

    t0 = time.perf_counter()
    run, values = net.evaluator(indices, _PLAN_BATCH)
    t1 = time.perf_counter()
    values = [v.detach() if dtype is None else v.detach().to(dtype) for v in values]
    cols = torch.zeros((_PLAN_BATCH, len(indices)), dtype=torch.int64,
                       device=values[0].device)
    program = torch.export.export(
        _Evaluate(run),
        (cols, values),
        dynamic_shapes={"cols": {0: torch.export.Dim("b", min=1)},
                        "values": [None] * len(values)},
        strict=False,
    )
    program.example_inputs = None  # the artifact keeps no copy of the values
    t2 = time.perf_counter()
    ev = ExportedEvaluator(
        program,
        values,
        [i.name for i in indices],
        [i.size for i in indices],
        platforms=platforms,
    )
    ev.export_seconds = {"plan": t1 - t0, "trace": t2 - t1}
    return ev
