"""Photon transport: sourcing, population control, flight, tracking."""
