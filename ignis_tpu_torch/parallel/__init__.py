"""Training and sharding on the port: the differentiable-rendering loss
and train step, and the film's lanes sharded over devices or processes
(mesh.py; distributed.py on torch.distributed)."""
from .mesh import (RayMesh, loss_fn, make_mesh, render_iteration_sharded,
                   render_iteration_sharded_compact, train_step,
                   train_step_sharded)

__all__ = ["RayMesh", "loss_fn", "make_mesh", "render_iteration_sharded",
           "render_iteration_sharded_compact", "train_step",
           "train_step_sharded"]
