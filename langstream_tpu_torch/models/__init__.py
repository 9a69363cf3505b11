"""Model layer of the port: Llama math, the Mixtral family's routed FFN,
weight and KV quantization, the paged KV pool, and the carrier of
parameters from the JAX package."""
