"""Data x tensor x pipeline parallel training over ``torch.distributed``
(the port of the JAX package's ``parallel/``): one process per rank, one
process group per mesh axis (:mod:`.mesh`), Megatron's tensor-parallel
collectives (:mod:`.collectives`), the sharding rules (:mod:`.sharding`),
the GPipe schedule (:mod:`.pipeline`) and the train/eval steps
(:mod:`.api`); the train CLI runs them on a mesh (``train.py``
``--mesh-*``). Sequence parallelism (ring attention, Ulysses) and elastic
re-meshing are not ported yet.

:mod:`.pipeline` and :mod:`.api` import the model, which imports
:mod:`.collectives`, so they load on first use of their names here.
"""

from .mesh import AXES, Mesh, from_rank0, make_mesh, mesh_layout, spawn
from .sharding import (REPLICATED_PARTIAL_SUM_BIASES, TP_RULES,
                       assemble_state_dict, gather_state_dict,
                       gather_to_rank0, scatter_from_rank0,
                       pspec_for_path, shard_state_dict,
                       validate_mesh_for_config, validate_tp_divisibility)

_LAZY = {
    "pipeline": ("BLOCKS_KEY", "PipelineViT", "dropout_seeds",
                 "make_pipeline_apply", "stack_block_params",
                 "unstack_block_params", "validate_pipeline"),
    "api": ("make_parallel_eval_step", "make_parallel_train_step",
            "shard_batch", "shard_train_state"),
}


def __getattr__(name):
    import importlib

    for module, names in _LAZY.items():
        if name in names:
            return getattr(importlib.import_module(f".{module}", __name__),
                           name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
