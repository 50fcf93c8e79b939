"""Differentiable rendering: parameter traversal, optimizers and the
gradient renders (the JAX package's `ad`, without the silhouette boundary
terms of `ad/projective.py`)."""
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
