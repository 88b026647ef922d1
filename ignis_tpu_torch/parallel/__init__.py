"""Training on the port: the differentiable-rendering loss and train step
(mesh.py; one device)."""
from .mesh import loss_fn, train_step

__all__ = ["loss_fn", "train_step"]
