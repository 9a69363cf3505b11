"""Serving layer of the port: the engine and the on-device sampler."""
