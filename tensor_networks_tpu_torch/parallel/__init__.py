"""Multi-device execution on ``torch.distributed``: meshes, mode-sharded
kernels, the sharded training step, checkpoints, train-sharded sweeps
and the train-sharded solvers (ALS, DMRG, time integration).

Counterpart of ``tensor_networks_tpu/parallel`` (its ``mesh``,
``sharded``, ``training``, ``checkpoint``, ``sweeps``, ``als``, ``eigen``
and ``evolve`` modules, with their public names).  One process per device: every rank calls the same
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
from tensor_networks_tpu_torch.parallel.evolve import (
    add_sharded,
    evolve_tdvp2_sharded,
    evolve_tdvp_sharded,
    evolve_theta_sharded,
    place_tdvp_sharded,
    tdvp_step_sharded,
    ttop_apply_sharded,
)
from tensor_networks_tpu_torch.parallel.als import (
    als_solve_adaptive_sharded,
    als_solve_sharded,
    als_sweep_sharded,
    place_als_sharded,
)
from tensor_networks_tpu_torch.parallel.eigen import (
    als_eigsh_adaptive_sharded,
    als_eigsh_k_sharded,
    als_eigsh_sharded,
    place_eigsh_sharded,
)

__all__ = [
    "add_sharded",
    "als_eigsh_adaptive_sharded",
    "als_eigsh_k_sharded",
    "als_eigsh_sharded",
    "als_solve_adaptive_sharded",
    "als_solve_sharded",
    "als_sweep_sharded",
    "place_als_sharded",
    "place_eigsh_sharded",
    "evolve_tdvp2_sharded",
    "evolve_tdvp_sharded",
    "evolve_theta_sharded",
    "ttop_apply_sharded",
    "place_tdvp_sharded",
    "tdvp_step_sharded",
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
