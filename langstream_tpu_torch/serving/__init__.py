"""Serving layer of the port: the engine, its sampler and deadlines, and
the embedding engine."""
