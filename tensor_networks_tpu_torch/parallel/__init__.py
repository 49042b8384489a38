"""Multi-device execution on ``torch.distributed``: meshes, mode-sharded
kernels, the sharded training step, checkpoints and train-sharded sweeps.

Counterpart of ``tensor_networks_tpu/parallel`` (its ``mesh``,
``sharded``, ``training``, ``checkpoint`` and ``sweeps`` modules, with
their public names).  One process per device: every rank calls the same
function on its own shard, and the sums and hops that XLA places from
the JAX package's shardings are NCCL (or gloo) collectives here.  Start
the ranks with ``torchrun --nproc-per-node N``, or initialize a one-rank
group on one card; :mod:`.mesh` says how.
"""

from tensor_networks_tpu_torch.parallel.mesh import (
    default_mesh,
    make_hybrid_mesh,
    make_mesh,
)
from tensor_networks_tpu_torch.parallel.sharded import (
    shard_tt_params,
    tt_evaluate_batched,
    tt_inner_mode_sharded,
)
from tensor_networks_tpu_torch.parallel.sweeps import (
    place_train_sharded,
    tt_gram_round_sharded,
    tt_inner_train_sharded,
    tt_prefix_round_sharded,
    tt_right_orth_sharded,
)
from tensor_networks_tpu_torch.parallel.training import (
    TTParams,
    init_tt_params,
    make_train_step,
)

__all__ = [
    "make_mesh",
    "make_hybrid_mesh",
    "default_mesh",
    "tt_inner_mode_sharded",
    "shard_tt_params",
    "tt_evaluate_batched",
    "TTParams",
    "make_train_step",
    "init_tt_params",
    "tt_right_orth_sharded",
    "tt_gram_round_sharded",
    "tt_prefix_round_sharded",
    "tt_inner_train_sharded",
    "place_train_sharded",
]
