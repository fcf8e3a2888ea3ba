"""Simulator pieces of the port: the service model the engine charges
swap IO with (the discrete-event simulator is ROADMAP Queue A 9)."""

from .service_model import NodeSpec, ScaledServiceModel, ServiceModel

__all__ = ["NodeSpec", "ScaledServiceModel", "ServiceModel"]
