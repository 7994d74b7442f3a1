"""The single and double cart-pole of the reference (frozen copies of the
port's ``models/``)."""

from .base import DOUBLE_CARTPOLE, SINGLE_CARTPOLE, CartPoleModel, get_model

__all__ = ["CartPoleModel", "SINGLE_CARTPOLE", "DOUBLE_CARTPOLE",
           "get_model"]
