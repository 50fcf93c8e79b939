"""Differentiable rendering: parameter traversal, optimizers, the
gradient renders and the silhouette boundary terms of the vertex rows
(`ad/projective.py`): the JAX package's `ad`."""
from .largesteps import LargeSteps
from .optimizers import SGD, Adam
from .params import SceneParameters, traverse
from .render import (render_differentiable, render_forward, render_grad,
                     render_loss_grad)

__all__ = [
    "SceneParameters", "traverse", "SGD", "Adam", "LargeSteps",
    "render_differentiable", "render_forward", "render_grad",
    "render_loss_grad",
]
