"""PyTorch/CUDA port of the langstream-tpu serving path, for one NVIDIA H100.

The JAX package ``langstream_tpu`` is the reference: module layout and
function names mirror it so each counterpart is easy to find. This package
imports ``torch`` and never ``jax`` or anything of ``langstream_tpu``.

Layers (entry point down to the kernels):

- :mod:`langstream_tpu_torch.agents` — ``TorchServiceProvider``: the
  completions and embeddings services the platform's AI agents call
  (``serve_torch.py`` at the repository root registers it).
- :mod:`langstream_tpu_torch.serving` — ``TorchServingEngine``: submit-time
  checks, warmup, FIFO admission, batched prefill, K-step decode chunks
  (light and heavy regimes), one packed device-to-host fetch per chunk;
  ``EmbeddingEngine`` for the encoder.
- :mod:`langstream_tpu_torch.models` — Llama math (dense and paged) with
  its FFN hook, the Mixtral family's top-2 routed FFN, int8 weights, int8
  KV rows, the paged pool and its host-side block manager, the BERT-class
  encoder and the HF checkpoint loaders.
- :mod:`langstream_tpu_torch.ops` — the hand-written Hopper kernels (CUDA
  C++ under ``ops/csrc``) beside their plain PyTorch versions.

Entry points run on the card unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper takes its plain version.
"""
