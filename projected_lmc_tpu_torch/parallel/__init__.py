"""Multi-rank execution of the port on ``torch.distributed`` (port of
``projected_lmc_tpu/parallel``): the ('data', 'latent') mesh, the sharding
rules and report, sharded training steps, and the process group."""

from . import distributed
from .distributed import initialize, is_coordinator, make_global_mesh
from .mesh import (Mesh, make_mesh, model_shardings, replicate, shard_model,
                   sharding_report)
from .sharded import dryrun_step, sharded_fit_step

__all__ = ["Mesh", "distributed", "dryrun_step", "initialize",
           "is_coordinator", "make_global_mesh", "make_mesh",
           "model_shardings", "replicate", "shard_model", "sharded_fit_step",
           "sharding_report"]
