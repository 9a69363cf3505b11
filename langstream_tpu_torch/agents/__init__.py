"""The port's model-service provider: completions and embeddings for the
platform's AI agents, served by the port's engines."""
